"""Decision explainability plane: structured "why" for every verdict.

Copy of `karpenter_tpu/explain/__init__.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The flight recorder (karpenter_tpu_torch/tracing) answers *when* and the
telemetry plane (metrics/slo, metrics/sentinel) answers *how fast*;
this plane answers *why*: why a pod stayed unschedulable (the
elimination funnel over the instance-type catalog, the relaxation
steps burned, the admission cutoff that shed it), why a disruption
candidate was kept (`kept:<reason>` — same-type guard, budgets, PDBs,
the priority veto, the LP weak-duality certificate with its numbers),
and what the device LP's duals said about the tick (top-k binding
groups, reservation cap duals — the dual as an economic explanation).

Design rules, inherited from the flight recorder:

- **Decisions are never changed, only accounted.** Every note sits
  behind the existing seams; the recording sites read state the
  decision path already computed (the encoder's masks, the pruner's
  certificate, the validator's verdicts).
- **Determinism**: a record carries only decision provenance —
  counts, reasons, prices, dual values — that replays identically
  under the same KARPENTER_FAULTS schedule. `structure()` strips the
  (run-random) trace id, so chaos suites assert byte-identical
  explain payloads across replays — the `tracing.structure()`
  contract extended to explanations.
- **Healthy-path cost**: with no record open (or KARPENTER_EXPLAIN=0)
  every note is one global read and a return; the operator opens one
  record per tick, keyed by the tick's trace id so explanations join
  the flight recorder.
- **Bounded**: a ring of KARPENTER_EXPLAIN_RING finished tick records
  (default 64), with per-tick entry caps (KARPENTER_EXPLAIN_MAX_PODS
  / _MAX_NODES) so a million-pod outage cannot eat the heap; drops
  are counted, never silent.

Surfaces: `/debug/explain?pod=<key>|node=<name>|tick=<trace_id>` on
the observability server, `readyz()["explain"]`, the top-3 exclusion
reasons folded into unschedulable-pod corev1 Events, per-arm bench
`explain_summary` blocks, and `tools/explain.py`.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import Optional

ENV_ENABLED = "KARPENTER_EXPLAIN"
ENV_RING = "KARPENTER_EXPLAIN_RING"
ENV_MAX_PODS = "KARPENTER_EXPLAIN_MAX_PODS"
ENV_MAX_NODES = "KARPENTER_EXPLAIN_MAX_NODES"
DEFAULT_RING = 64
DEFAULT_MAX_ENTRIES = 4096
# per-tick cap on LP dual summaries (probe ladders can stage many)
MAX_LP_SUMMARIES = 32

# -- verdict taxonomy ---------------------------------------------------------
#
# Disruption verdicts: `consolidated` / `interrupted` for candidates a
# command acted on, `kept:<reason>` for everything scanned and left
# alone. Every `kept:` code below must have a row in README's verdict
# taxonomy table (tests/test_explain_docs.py, the test_fault_docs
# pattern).

VERDICT_CONSOLIDATED = "consolidated"
VERDICT_INTERRUPTED = "interrupted"

KEPT_NOT_CONSOLIDATABLE = "kept:not-consolidatable"
KEPT_DO_NOT_DISRUPT = "kept:do-not-disrupt"
KEPT_PDB_BLOCKED = "kept:pdb-blocked"
KEPT_NOMINATED = "kept:nominated"
KEPT_INTERRUPTED = "kept:interrupted"
KEPT_UNPRICED = "kept:unpriced"
KEPT_BUDGET = "kept:budget"
KEPT_SAME_TYPE = "kept:same-type-guard"
KEPT_PRIORITY_VETO = "kept:priority-veto"
KEPT_LP_PRUNE = "kept:lp-prune"
KEPT_NOT_CHEAPER = "kept:not-cheaper"
KEPT_SPOT_GATED = "kept:spot-to-spot-gated"
KEPT_NEEDS_MULTIPLE = "kept:needs-multiple-nodes"
KEPT_SIMULATION = "kept:simulation-failed"
KEPT_VALIDATION = "kept:validation-failed"


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") != "0"


def _env_int(key: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(key, str(default))))
    except ValueError:
        return default


def ring_size() -> int:
    return _env_int(ENV_RING, DEFAULT_RING)


class TickRecord:
    """One tick's decision provenance: per-pod scheduling verdicts,
    per-node disruption verdicts, per-solve LP dual summaries."""

    __slots__ = ("trace_id", "pods", "nodes", "lp", "truncated",
                 "_max_pods", "_max_nodes")

    def __init__(self, trace_id: str = ""):
        self.trace_id = trace_id
        self.pods: dict[str, dict] = {}
        self.nodes: dict[str, dict] = {}
        self.lp: list[dict] = []
        self.truncated = {"pods": 0, "nodes": 0, "lp": 0}
        self._max_pods = _env_int(ENV_MAX_PODS, DEFAULT_MAX_ENTRIES)
        self._max_nodes = _env_int(ENV_MAX_NODES, DEFAULT_MAX_ENTRIES)

    def _pod(self, key: str) -> Optional[dict]:
        rec = self.pods.get(key)
        if rec is None:
            if len(self.pods) >= self._max_pods:
                self.truncated["pods"] += 1
                return None
            rec = self.pods[key] = {}
        return rec

    def finish(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "pods": self.pods,
            "nodes": self.nodes,
            "lp": self.lp,
            "truncated": dict(self.truncated),
        }


# -- module state -------------------------------------------------------------

_lock = threading.Lock()
_ring: "deque[dict]" = deque(maxlen=DEFAULT_RING)
_active: Optional[TickRecord] = None


def _resize_ring() -> None:
    global _ring
    size = ring_size()
    if _ring.maxlen != size:
        with _lock:
            if _ring.maxlen != size:
                _ring = deque(_ring, maxlen=size)


def active() -> Optional[TickRecord]:
    """The open tick record, or None (kill switch off / outside a
    tick) — THE fast-path check every recording site makes first."""
    return _active


@contextmanager
def tick(trace_id: str = ""):
    """Open one tick's record (the operator's per-tick call). On exit
    the finished record lands in the ring and its verdicts tally into
    karpenter_explain_verdicts_total. No-op when KARPENTER_EXPLAIN=0;
    a nested open (a bench harness around an operator) degrades to the
    already-open record so the tick keeps one ring entry."""
    global _active
    if not enabled():
        yield None
        return
    if _active is not None:
        yield _active
        return
    record = TickRecord(trace_id)
    _active = record
    try:
        yield record
    finally:
        if _active is record:
            _active = None
        _finish(record)


def _finish(record: TickRecord) -> None:
    from karpenter_tpu_torch.metrics.store import (
        EXPLAIN_TRUNCATED,
        EXPLAIN_VERDICTS,
    )

    for rec in record.nodes.values():
        verdict = rec.get("verdict")
        if verdict:
            EXPLAIN_VERDICTS.inc({"verdict": verdict})
    dropped = sum(record.truncated.values())
    if dropped:
        EXPLAIN_TRUNCATED.inc(value=float(dropped))
    _resize_ring()
    with _lock:
        _ring.append(record.finish())


# -- recording ----------------------------------------------------------------


def note_pod(key: str, **fields) -> None:
    """Merge provenance fields into one pod's verdict (error, reason
    code, shed cutoff, preemption victims, ...)."""
    record = _active
    if record is None:
        return
    rec = record._pod(key)
    if rec is not None:
        rec.update(fields)


def note_funnel(key: str, funnel: dict) -> None:
    """Attach the elimination funnel (explain/funnel.py) to a pod."""
    record = _active
    if record is None:
        return
    rec = record._pod(key)
    if rec is not None:
        rec["funnel"] = funnel


def note_relax(key: str, step: str) -> None:
    """One relaxation-ladder rung tried for a pod, in order."""
    record = _active
    if record is None:
        return
    rec = record._pod(key)
    if rec is not None:
        rec.setdefault("relaxed", []).append(step)


def note_candidate(name: str, verdict: str, weak: bool = False,
                   **fields) -> None:
    """One disruption candidate's verdict. `weak` notes never
    overwrite an existing verdict (a generic `kept:simulation-failed`
    must not stomp the specific priority-veto recorded moments
    earlier); strong notes do — a candidate probed and kept several
    times this tick ends on the LAST (most decisive) verdict, and a
    decided command's `consolidated` wins over any earlier keep."""
    record = _active
    if record is None:
        return
    existing = record.nodes.get(name)
    if existing is None:
        if len(record.nodes) >= record._max_nodes:
            record.truncated["nodes"] += 1
            return
    elif weak and existing.get("verdict"):
        return
    record.nodes[name] = {"verdict": verdict, **fields}


def note_lp(summary: dict) -> None:
    """One device-LP dual summary (lp_device.dual_summary)."""
    record = _active
    if record is None:
        return
    if len(record.lp) >= MAX_LP_SUMMARIES:
        record.truncated["lp"] += 1
        return
    record.lp.append(summary)


# -- queries ------------------------------------------------------------------


def records() -> list[dict]:
    """Finished tick records, oldest first, plus a snapshot of the
    open record (newest) so /debug/explain sees the current tick."""
    with _lock:
        out = list(_ring)
    record = _active
    if record is not None:
        out.append(record.finish())
    return out


def find_tick(trace_id: str) -> Optional[dict]:
    for rec in reversed(records()):
        if rec["trace_id"] == trace_id:
            return rec
    return None


def find_pod(key: str) -> Optional[dict]:
    """Newest explanation recorded for one pod, wrapped with the tick
    trace id it belongs to."""
    for rec in reversed(records()):
        hit = rec["pods"].get(key)
        if hit is not None:
            return {"trace_id": rec["trace_id"], "pod": key, **hit}
    return None


def find_node(name: str) -> Optional[dict]:
    """Newest disruption verdict recorded for one node."""
    for rec in reversed(records()):
        hit = rec["nodes"].get(name)
        if hit is not None:
            return {"trace_id": rec["trace_id"], "node": name, **hit}
    return None


def clear() -> None:
    with _lock:
        _ring.clear()


# -- digests ------------------------------------------------------------------


def digest() -> dict:
    """The readyz()["explain"] block: the last finished record's entry
    counts and verdict histogram."""
    with _lock:
        last = _ring[-1] if _ring else None
    if last is None:
        return {"ticks": 0}
    verdicts: dict[str, int] = {}
    for rec in last["nodes"].values():
        v = rec.get("verdict", "")
        if v:
            verdicts[v] = verdicts.get(v, 0) + 1
    with _lock:
        ticks = len(_ring)
    return {
        "ticks": ticks,
        "trace_id": last["trace_id"],
        "pods": len(last["pods"]),
        "nodes": len(last["nodes"]),
        "lp_solves": len(last["lp"]),
        "verdicts": dict(sorted(verdicts.items())),
        "truncated": dict(last["truncated"]),
    }


def summarize_ring() -> dict:
    """The per-arm bench `explain_summary` block: verdict histogram
    (node verdicts + pod reason codes) and funnel depth p50 over every
    record currently in the ring. Always well-formed — an arm that
    recorded nothing reports zeros and a null p50."""
    recs = records()
    verdicts: dict[str, int] = {}
    pod_codes: dict[str, int] = {}
    depths: list[int] = []
    pods = nodes = 0
    for rec in recs:
        pods += len(rec["pods"])
        nodes += len(rec["nodes"])
        for p in rec["pods"].values():
            code = p.get("code", "")
            if code:
                pod_codes[code] = pod_codes.get(code, 0) + 1
            funnel = p.get("funnel")
            if funnel:
                depths.append(len(funnel.get("stages", [])))
        for n in rec["nodes"].values():
            v = n.get("verdict", "")
            if v:
                verdicts[v] = verdicts.get(v, 0) + 1
    depths.sort()
    return {
        "ticks": len(recs),
        "pods_recorded": pods,
        "nodes_recorded": nodes,
        "verdicts": dict(sorted(verdicts.items())),
        "pod_codes": dict(sorted(pod_codes.items())),
        "funnel_depth_p50": (
            depths[len(depths) // 2] if depths else None
        ),
    }


def verdict_distance(observed: dict, expected: dict) -> float:
    """Normalized L1 (total-variation) distance between two verdict
    histograms, on [0, 1]: 0.0 means identical SHARES (counts may
    scale — a 2x-longer soak with the same decision mix is distance
    0), 1.0 means disjoint support. The soak judge scores
    a run's summarize_ring() histogram against the scenario's
    declared expectation envelope with this — unexplained-verdict
    DRIFT gates on shape, never on raw volume."""
    tot_obs = float(sum(observed.values())) if observed else 0.0
    tot_exp = float(sum(expected.values())) if expected else 0.0
    if tot_obs <= 0.0 and tot_exp <= 0.0:
        return 0.0
    if tot_obs <= 0.0 or tot_exp <= 0.0:
        return 1.0
    keys = set(observed) | set(expected)
    return round(0.5 * sum(
        abs(observed.get(k, 0) / tot_obs - expected.get(k, 0) / tot_exp)
        for k in keys
    ), 6)


def structure(record: dict) -> str:
    """The deterministic skeleton of one record: everything but the
    run-random trace id, as canonical JSON — what chaos suites compare
    byte-for-byte across byte-identical fault replays (the
    tracing.structure() contract; every recorded field is decision
    provenance, so nothing else needs stripping)."""
    body = {k: v for k, v in record.items() if k != "trace_id"}
    return json.dumps(body, sort_keys=True)


def render_json(pod: str = "", node: str = "", trace_id: str = "") -> tuple[int, str]:
    """The /debug/explain body: (HTTP status, JSON). One selector at a
    time; no selector returns the digest plus the ring's tick ids."""
    if pod:
        found = find_pod(pod)
        if found is None:
            return 404, json.dumps({"error": f"no explanation for pod {pod!r}"})
        return 200, json.dumps(found)
    if node:
        found = find_node(node)
        if found is None:
            return 404, json.dumps(
                {"error": f"no explanation for node {node!r}"}
            )
        return 200, json.dumps(found)
    if trace_id:
        found = find_tick(trace_id)
        if found is None:
            return 404, json.dumps({"error": f"no record for tick {trace_id!r}"})
        return 200, json.dumps(found)
    return 200, json.dumps({
        "digest": digest(),
        "ticks": [r["trace_id"] for r in records()],
    })
