"""Retained fleet snapshots: the disruption engine's O(dirty) seam.

Copy of `karpenter_tpu/state/retained.py`, whole, with its imports
pointed into `karpenter_tpu_torch`.

Every disruption scan used to rebuild fleet state from the store —
`cluster.deep_copy_nodes()` copied every StateNode, and each
simulation's Scheduler re-derived every node's `ExistingNodeInput`
(label parsing, daemon-reserve computation) from scratch, per probe,
per method, per poll. CvxCluster's lesson (PAPERS.md) applies here
exactly as it does to the provisioning tick: never re-derive what
didn't change.

`RetainedFleetSeam` retains, per stable node, BOTH halves of a
scheduling snapshot:

- a **shallow-copied StateNode row** (the same object
  `deep_copy_nodes` would produce), refreshed only when the kube
  watch stream marks the node dirty (a Pod event dirties its bound
  node; a NodeClaim event dirties claim + node keys; a DaemonSet
  event or a 410-driven relist invalidates everything). Rows share
  `node`/`node_claim` object references with live state exactly as a
  fresh copy does, and per serve the STATE-PLANE volatile scalars
  (`marked_for_deletion`, `nominated_until`) are re-synced — those
  are mutated by controllers directly, with no watch event to catch.
- a **retained `ExistingNodeInput`** built by the same
  `NodeInputBuilder` the Scheduler uses — handed to simulation
  Schedulers via their `existing_input_cache` seam so an unchanged
  node's input is a dict lookup instead of a rebuild.

Mutation discipline: a simulation's Scheduler commits pods onto the
served rows (`_commit_existing` mutates `pod_usage`/`pod_keys`).
Callers report those rows back through `note_mutated()` — the keys of
`results.existing_assignments` — and the seam re-copies exactly those
from live state before the next serve. Rows a simulation only READ
stay retained. (The batched probe solver never mutates its snapshot —
lanes are evaluated against encoded arrays — so a whole probe ladder
costs zero re-copies.)

Volatile nodes (unlaunched claims, unregistered nodes, empty keys)
are never retained: they are few, transition-heavy, and their inputs
depend on the per-call catalog.

Decision identity is oracle-enforced: on a cadence
(`KARPENTER_DISRUPTION_SNAPSHOT_AUDIT`, default every 16 serves) a
serve is compared field-for-field against the from-scratch build; any
mismatch invalidates the retained state, counts
`karpenter_disruption_snapshot_total{outcome="divergence"}`, and the
fresh build is served. `KARPENTER_DISRUPTION_SNAPSHOT=0` disables
retention entirely (every serve is the from-scratch build).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.kube.dirty import DirtyTracker
from karpenter_tpu_torch.metrics.store import DISRUPTION_SNAPSHOT
from karpenter_tpu_torch.provisioning.scheduler import _state_node_key
from karpenter_tpu_torch.state.cluster import StateNode

log = logging.getLogger("karpenter.state.retained")

ENV_ENABLE = "KARPENTER_DISRUPTION_SNAPSHOT"
ENV_AUDIT = "KARPENTER_DISRUPTION_SNAPSHOT_AUDIT"


def retained_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1").lower() not in (
        "0", "false", "off"
    )


def _claim_keys(event: str, claim) -> list[str]:
    keys = [claim.metadata.name]
    if claim.status.node_name:
        keys.append(claim.status.node_name)
    return keys


def _pod_node_keys(event: str, pod) -> list[str]:
    return [pod.spec.node_name] if pod.spec.node_name else []


class RetainedFleetSeam:
    def __init__(
        self,
        kube,
        cluster,
        pools_fn: Optional[Callable] = None,
        options=None,
    ):
        self.kube = kube
        self.cluster = cluster
        # zero-arg catalog source (Provisioner.ready_pools_with_types)
        # — consulted only when the input builder must be (re)built
        self.pools_fn = pools_fn
        self.options = options
        # audit cadence is a LIVE knob: re-read
        # from the env per serve unless a test pins an override
        self._audit_every_override: Optional[int] = None
        self._tracker = DirtyTracker(kube)
        self._tracker.watch("Node")
        self._tracker.watch("NodeClaim", key=_claim_keys)
        self._tracker.watch("Pod", key=_pod_node_keys)
        self._tracker.watch("DaemonSet", key=lambda e, o: ["*"])
        # PodDisruptionBudget movement invalidates the engine's cached
        # per-pod eviction verdicts (consumed via pdb_epoch below)
        self._tracker.watch("PodDisruptionBudget", key=lambda e, o: ["*"])
        self._rows: dict[str, StateNode] = {}
        self._inputs: dict = {}                # key -> ExistingNodeInput
        self._ver: dict[str, int] = {}         # watch-dirt generation
        self._built: dict[str, int] = {}       # version a row was built at
        self._epoch = 0                        # bumped on rebuild-all
        self.pdb_epoch = 0
        self._builder = None
        self._serves = 0
        self.hits = 0
        self.rebuilds = 0
        self.audits = 0
        self.divergences = 0

    # -- knobs ----------------------------------------------------------------

    @property
    def audit_every(self) -> int:
        """Serves between identity audits — KARPENTER_DISRUPTION_
        SNAPSHOT_AUDIT read per access (a deploy retuning the cadence
        must not need a restart), unless explicitly assigned."""
        if self._audit_every_override is not None:
            return self._audit_every_override
        from karpenter_tpu_torch.solver.incremental import _env_float

        return int(_env_float(ENV_AUDIT, 16))

    @audit_every.setter
    def audit_every(self, value: Optional[int]) -> None:
        self._audit_every_override = None if value is None else int(value)

    # -- dirt -----------------------------------------------------------------

    def sync(self) -> None:
        """Drain watch dirt into per-key versions. Cheap; callers
        (the engine's candidate-core cache and fleet_snapshot) share
        one tracker through this method."""
        # node-keyed kinds first, through the SCOPED continuity latch:
        # a shard's lost stream dirties only that shard's rows (None
        # means the client can't scope it — whole-cache bust)
        shards = self._tracker.relisted_shards("Node", "NodeClaim", "Pod")
        if shards is None:
            self.invalidate()
        elif shards:
            self.invalidate_shards(shards)
        # fleet-wide kinds keep the merged (whole-cache) contract
        if self._tracker.relisted("DaemonSet", "PodDisruptionBudget"):
            self.invalidate()
        if self._tracker.drain("PodDisruptionBudget"):
            self.pdb_epoch += 1
        if self._tracker.drain("DaemonSet"):
            # every node's daemon reserve (and the builder's pinned
            # daemonset list) just moved
            self._epoch += 1
            self._inputs.clear()
            self._rows.clear()
            self._built.clear()
            self._builder = None
        for key in (
            self._tracker.drain("Node")
            | self._tracker.drain("NodeClaim")
            | self._tracker.drain("Pod")
        ):
            self._ver[key] = self._ver.get(key, 0) + 1

    def invalidate(self) -> None:
        self._rows.clear()
        self._inputs.clear()
        self._built.clear()
        self._ver.clear()
        self._epoch += 1
        self.pdb_epoch += 1
        self._builder = None
        self._tracker.clear()

    def invalidate_shards(self, shards: set[int]) -> None:
        """Shard-scoped bust: drop retained rows/inputs
        only for keys routed to the relisted shards, leaving every
        other shard's rows warm. Version bumps cover the union of row
        and version keys in the affected shards (the engine's
        candidate-core cache stamps entries with `node_version`, which
        can outlive a pruned row). `pdb_epoch` is bumped conservatively
        — the relist's diff events can't prove no PDB-relevant pod
        churn hid in the stale window — but the build epoch and the
        input builder survive, which is the whole point."""
        from karpenter_tpu_torch.metrics.store import STATE_SHARD_INVALIDATIONS
        from karpenter_tpu_torch.state.shards import shard_of

        for key in [
            k for k in set(self._rows) | set(self._ver)
            if shard_of(k) in shards
        ]:
            self._rows.pop(key, None)
            self._inputs.pop(key, None)
            self._built.pop(key, None)
            self._ver[key] = self._ver.get(key, 0) + 1
        self.pdb_epoch += 1
        STATE_SHARD_INVALIDATIONS.inc({"layer": "disruption_snapshot"})

    def note_mutated(self, keys: Iterable[str]) -> None:
        """A simulation committed pods onto these served rows; re-copy
        them from live state before the next serve."""
        for key in keys:
            self._ver[key] = self._ver.get(key, 0) + 1

    def node_version(self, key: str) -> tuple:
        """(epoch, watch generation) for one node — what the engine's
        candidate-core cache stamps its entries with."""
        return (self._epoch, self._ver.get(key, 0))

    # -- input building -------------------------------------------------------

    def _get_builder(self):
        if self._builder is None and self.pools_fn is not None:
            from karpenter_tpu_torch.provisioning.scheduler import (
                NodeInputBuilder,
            )

            self._builder = NodeInputBuilder(
                self.pools_fn(),
                self.cluster.daemonsets(),
                self.options.ignore_dra_requests
                if self.options is not None else True,
            )
        return self._builder

    # -- serving --------------------------------------------------------------

    def fleet_snapshot(self) -> tuple[list[StateNode], dict]:
        """(snapshot rows in cluster order, retained-input cache).
        The rows are what `deep_copy_nodes()` would return; the input
        dict feeds `Scheduler(existing_input_cache=...)`. Retention is
        per stable node; volatile nodes get fresh copies and no cache
        entry."""
        if not retained_enabled():
            return self.cluster.deep_copy_nodes(), {}
        self.sync()
        self._serves += 1
        builder = self._get_builder()
        out: list[StateNode] = []
        inputs: dict = {}
        seen: set[str] = set()
        serve_hits = serve_rebuilds = 0
        # the whole walk runs under the cluster lock, exactly as
        # deep_copy_nodes holds it for its copy loop: informer threads
        # mutate pod_keys/pod_usage in place on the real stack, and an
        # unlocked shallow_copy would tear (or crash on) a row
        with self.cluster._lock:
            for n in self.cluster.nodes():
                key = _state_node_key(n)
                volatile = (
                    not key or n.node is None or not n.registered()
                )
                if volatile:
                    if key:
                        self._rows.pop(key, None)
                        self._inputs.pop(key, None)
                        self._built.pop(key, None)
                    out.append(n.shallow_copy())
                    continue
                seen.add(key)
                ver = self._ver.get(key, 0)
                row = self._rows.get(key)
                if (
                    row is None
                    or self._built.get(key) != ver
                    # an object-identity swap without a watch event (a
                    # resync replacing the mirror entry) must not
                    # serve a stale pair
                    or row.node is not n.node
                    or row.node_claim is not n.node_claim
                ):
                    row = n.shallow_copy()
                    self._rows[key] = row
                    self._built[key] = ver
                    if builder is not None and not n.deleting():
                        builder.invalidate(key)
                        self._inputs[key] = builder.existing_input(n)
                    else:
                        self._inputs.pop(key, None)
                    serve_rebuilds += 1
                else:
                    # state-plane scalars are mutated directly by
                    # controllers (taint marks, nomination windows)
                    # with no watch event — re-sync per serve
                    row.marked_for_deletion = n.marked_for_deletion
                    row.nominated_until = n.nominated_until
                    serve_hits += 1
                out.append(row)
                inp = self._inputs.get(key)
                if inp is not None and not n.deleting():
                    inputs[key] = inp
        for key in [k for k in self._rows if k not in seen]:
            self._rows.pop(key, None)
            self._inputs.pop(key, None)
            self._built.pop(key, None)
        # metric increments batched per SERVE (a per-row inc was
        # measurable against the very scan wall this seam shrinks)
        self.hits += serve_hits
        self.rebuilds += serve_rebuilds
        if serve_hits:
            DISRUPTION_SNAPSHOT.inc(
                {"outcome": "hit"}, value=float(serve_hits)
            )
        if serve_rebuilds:
            DISRUPTION_SNAPSHOT.inc(
                {"outcome": "rebuild"}, value=float(serve_rebuilds)
            )
        if self.audit_every > 0 and self._serves % self.audit_every == 0:
            fresh = self._audit(out, inputs)
            if fresh is not None:
                return fresh
        return out, inputs

    # -- oracle ---------------------------------------------------------------

    @staticmethod
    def _row_fp(row: StateNode) -> tuple:
        return (
            id(row.node),
            id(row.node_claim),
            row.marked_for_deletion,
            round(row.nominated_until, 6),
            tuple(sorted(row.pod_keys)),
            tuple(sorted(
                (k, round(v, 6)) for k, v in row.pod_usage.items()
            )),
            tuple(sorted(
                (k, round(v, 6)) for k, v in row.daemon_usage.items()
            )),
        )

    @staticmethod
    def _input_fp(inp) -> tuple:
        return (
            inp.name,
            inp.pool_name,
            inp.pod_count,
            tuple(inp.taints),
            inp.requirements.signature(),
            tuple(sorted(
                (k, round(v, 6)) for k, v in inp.available.items()
            )),
        )

    def _audit(self, served: list[StateNode], served_inputs: dict):
        """From-scratch build vs the retained serve. Returns the fresh
        (rows, inputs) on divergence — the caller serves those — or
        None when identity held."""
        from karpenter_tpu_torch.provisioning.scheduler import (
            NodeInputBuilder,
            _state_node_key,
        )

        self.audits += 1
        DISRUPTION_SNAPSHOT.inc({"outcome": "audit"})
        fresh_builder = None
        if self.pools_fn is not None:
            fresh_builder = NodeInputBuilder(
                self.pools_fn(),
                self.cluster.daemonsets(),
                self.options.ignore_dra_requests
                if self.options is not None else True,
            )
        fresh_inputs: dict = {}
        # locked like the serve: the fresh copies and input rebuilds
        # must read a consistent mirror
        with self.cluster._lock:
            fresh_rows = self.cluster.deep_copy_nodes()
            ok = len(fresh_rows) == len(served)
            if ok:
                for fresh_n, got in zip(fresh_rows, served):
                    if self._row_fp(fresh_n) != self._row_fp(got):
                        ok = False
                        break
            if ok and fresh_builder is not None:
                for key in served_inputs:
                    node = self.cluster.node_for_key(key)
                    if node is None:
                        ok = False
                        break
                    want = fresh_builder.existing_input(node)
                    if self._input_fp(want) != self._input_fp(
                        served_inputs[key]
                    ):
                        ok = False
                        break
                    fresh_inputs[key] = want
        if ok:
            return None
        self.divergences += 1
        DISRUPTION_SNAPSHOT.inc({"outcome": "divergence"})
        log.error(
            "retained disruption snapshot diverged from the "
            "from-scratch build; invalidating retained rows and "
            "serving the fresh snapshot"
        )
        self.invalidate()
        return fresh_rows, {}

    # -- observability --------------------------------------------------------

    def status(self) -> dict:
        total = self.hits + self.rebuilds
        return {
            "enabled": retained_enabled(),
            "retained_rows": len(self._rows),
            "serves": self._serves,
            "row_hits": self.hits,
            "row_rebuilds": self.rebuilds,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "audits": self.audits,
            "divergences": self.divergences,
        }
