"""Flight recorder: end-to-end tick tracing with decision provenance.

Copy of `karpenter_tpu/tracing/__init__.py`, whole. In this package the
spans open today are those of the resilience ladder (`solver.rung`,
`solver/resilience.py`), the fault injector's `fault` events
(`solver/faults.py`) and the consolidation probe dispatch
(`disruption.probe_batch`, `solver/consolidation_batch.py`); the
operator's per-tick root and the rest of the tree below come with the
modules that open them. The description below is the JAX package's.

The reference exposes pprof behind --enable-profiling and per-
controller tracing via controller-runtime; the operator profiler here
gives flat label->histogram latencies, but neither can answer the
question an operator actually asks when a fleet looks wrong: *which*
tick, *which* solve path, and *which* fault window produced this
NodeClaim. This module is the answer — structured spans over the whole
decision path:

    tick
    ├─ provision
    │  ├─ intake                 (pod counts, surge bursts)
    │  ├─ route                  (incremental vs full + reason)
    │  ├─ scheduler.solve
    │  │  ├─ solve.encode
    │  │  └─ solver.rung         (one per resilience-ladder attempt)
    │  │     ├─ solve.transfer / solve.compile / solve.execute
    │  │     ├─ solve.rpc        (trace id rides the service codec)
    │  │     └─ solve.decode
    │  ├─ admission              (priority shed counts)
    │  └─ create                 (claims written; provenance stamped)
    ├─ preemption / bind / interruption
    ├─ disruption.<method> / disruption.probe_batch
    ├─ disruption.validation / disruption.commit
    ├─ termination
    └─ kube.<write-verb>         (status + retry counts)

Design rules:

- **Determinism**: durations live in span start/end fields; `attrs`
  and `events` carry only decision provenance (counts, reasons,
  statuses, fault kinds) that replays identically under the same
  KARPENTER_FAULTS schedule. `structure()` strips ids and timings, so
  chaos suites assert byte-identical span TREES across replays — the
  decision-identity contract extended to the observability layer.
- **Healthy-path cost**: `span()` is a no-op (one global read) when no
  trace is open; the operator opens one root per tick. Tracing is on
  by default and disabled with KARPENTER_TRACE=0.
- **Cross-process**: the solver-service codec carries the trace id as
  an optional header field (old peers ignore it); the server `adopt()`s
  it so its ring entries resolve to the same id. Fault-injector replay
  log entries carry the trace id of the tick they fired in, launched
  NodeClaims carry it in the `karpenter.sh/provenance` annotation, and
  recorder events carry it too — any node on the fleet resolves back
  to the exact tick trace and fault window that produced it via
  /debug/traces.

The ring (`KARPENTER_TRACE_RING`, default 64 ticks) serves as JSON and
as Chrome-trace/Perfetto format from /debug/traces on the
observability server, is summarized in readyz()["last_tick_trace"],
and lands per bench arm as a p50/p99 per-span breakdown.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterable, Optional

# the annotation launched NodeClaims (and recorder events) carry so a
# live object resolves back to the tick trace that produced it
PROVENANCE_ANNOTATION = "karpenter.sh/provenance"

ENV_ENABLED = "KARPENTER_TRACE"
ENV_RING = "KARPENTER_TRACE_RING"
DEFAULT_RING = 64

# attr keys every span may carry; everything in attrs/events MUST be
# deterministic under fault replay (see module docstring)


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t0", "t1", "attrs", "events")

    def __init__(self, trace_id: str, span_id: int, parent_id: int,
                 name: str, t0: float):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.attrs: dict = {}
        self.events: list = []

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def add_event(self, name: str, **attrs) -> None:
        self.events.append((name, attrs))


class _NullSpan:
    """The no-trace fast path: annotate/add_event are no-ops."""

    __slots__ = ()

    def annotate(self, **attrs) -> None:
        pass

    def add_event(self, name: str, **attrs) -> None:
        pass


_NULL = _NullSpan()


class Trace:
    """One open trace (a tick, or an adopted remote hop). Spans append
    under a lock — solver worker/watchdog threads record into the same
    trace the tick opened."""

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 clock=None):
        self.name = name
        self.trace_id = trace_id or secrets.token_hex(8)
        self.clock = clock if clock is not None else time.perf_counter
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._next_id = 1
        self.root = Span(self.trace_id, 0, -1, name, self.clock())
        self.spans: list[Span] = [self.root]

    def new_span(self, name: str, parent: Span,
                 t0: Optional[float] = None) -> Span:
        with self._lock:
            span = Span(self.trace_id, self._next_id, parent.span_id,
                        name, self.clock() if t0 is None else t0)
            self._next_id += 1
            self.spans.append(span)
        return span

    def finish(self) -> dict:
        self.root.t1 = self.clock()
        base = self.root.t0
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "started_at": self.started_at,
            "duration_s": round(self.root.t1 - base, 9),
            "spans": [
                {
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "name": s.name,
                    "t0_s": round(s.t0 - base, 9),
                    "t1_s": round(s.t1 - base, 9),
                    "attrs": dict(s.attrs),
                    "events": [
                        {"name": n, **a} for n, a in s.events
                    ],
                }
                for s in self.spans
            ],
        }


# -- module state -------------------------------------------------------------

_local = threading.local()
_ring_lock = threading.Lock()
_ring: "deque[dict]" = deque(maxlen=DEFAULT_RING)
# the process-globally active trace (the operator's open tick): threads
# with no thread-local trace of their own (resilience watchdogs, solver
# executors) attach their spans here
_active: Optional[Trace] = None


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") != "0"


def ring_size() -> int:
    try:
        return max(1, int(os.environ.get(ENV_RING, str(DEFAULT_RING))))
    except ValueError:
        return DEFAULT_RING


def _resize_ring() -> None:
    global _ring
    size = ring_size()
    if _ring.maxlen != size:
        with _ring_lock:
            if _ring.maxlen != size:
                _ring = deque(_ring, maxlen=size)


def _current_trace() -> Optional[Trace]:
    trace = getattr(_local, "trace", None)
    return trace if trace is not None else _active


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Span:
    """The innermost open span on this thread (the active trace's root
    for threads with no local stack), or a no-op stand-in."""
    trace = _current_trace()
    if trace is None:
        return _NULL
    stack = _stack()
    # a stale stack from a previous trace must not parent new spans
    while stack and stack[-1].trace_id != trace.trace_id:
        stack.pop()
    return stack[-1] if stack else trace.root


def current_trace_id() -> str:
    trace = _current_trace()
    return trace.trace_id if trace is not None else ""


def annotate(**attrs) -> None:
    current().annotate(**attrs)


def add_event(name: str, **attrs) -> None:
    current().add_event(name, **attrs)


@contextmanager
def trace(name: str, clock=None, trace_id: Optional[str] = None,
          _global: bool = True):
    """Open a root trace (the operator's per-tick call). On exit the
    finished trace lands in the ring. No-op when KARPENTER_TRACE=0 or
    a trace is already open on this thread/process (nested opens — a
    bench harness around an operator — degrade to a plain span)."""
    global _active
    if not enabled():
        yield _NULL
        return
    # a nested global open degrades to a span (a bench harness around
    # an operator must not steal the tick's ring entry); an adopted
    # (non-global) hop always records its OWN segment — it stacks over
    # whatever trace this thread had open, so an in-process solver
    # service never folds into the operator's tick
    if _global and _current_trace() is not None:
        with span(name) as inner:
            yield inner
        return
    prev_trace = getattr(_local, "trace", None)
    # restore the ORIGINAL stack object, never a copy: spans open
    # around this trace captured that list at entry and pop it in
    # their exit handlers — restoring a copy would strand their
    # entries and mis-parent every later span under a closed one
    prev_stack = getattr(_local, "stack", None)
    t = Trace(name, trace_id=trace_id, clock=clock)
    _local.trace = t
    _local.stack = []
    if _global:
        _active = t
    try:
        yield t.root
    finally:
        _local.trace = prev_trace
        _local.stack = prev_stack if prev_stack is not None else []
        if _global and _active is t:
            _active = None
        _resize_ring()
        with _ring_lock:
            _ring.append(t.finish())


@contextmanager
def adopt(trace_id: str, name: str, clock=None):
    """The server side of a cross-process hop: record this thread's
    spans under the CALLER's trace id, as a separate ring entry —
    /debug/traces?trace_id= then returns both segments. Thread-local
    only: an in-process solver service must not capture the operator's
    globally-open tick."""
    with trace(name, clock=clock, trace_id=trace_id or None,
               _global=False) as root:
        yield root


@contextmanager
def span(name: str, **attrs):
    """One instrumented region. No active trace -> no-op (one global
    read). Spans created on threads without local context parent to
    the active trace's root."""
    trace_ = _current_trace()
    if trace_ is None:
        yield _NULL
        return
    parent = current()
    s = trace_.new_span(name, parent if isinstance(parent, Span)
                        else trace_.root)
    if attrs:
        s.attrs.update(attrs)
    stack = _stack()
    stack.append(s)
    try:
        yield s
    finally:
        s.t1 = trace_.clock()
        if stack and stack[-1] is s:
            stack.pop()


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """A completed span from timestamps already taken (the solver's
    per-phase perf_counter pairs) — no extra clock reads, no nesting
    push/pop; parents to the innermost open span on this thread."""
    trace_ = _current_trace()
    if trace_ is None:
        return
    parent = current()
    s = trace_.new_span(name, parent if isinstance(parent, Span)
                        else trace_.root, t0=t0)
    s.t1 = t1
    if attrs:
        s.attrs.update(attrs)


# -- ring access --------------------------------------------------------------

def traces() -> list[dict]:
    """Ring contents, oldest first."""
    with _ring_lock:
        return list(_ring)


def find(trace_id: str) -> list[dict]:
    """Every ring segment recorded under `trace_id` (the tick trace
    plus any adopted remote hops)."""
    return [t for t in traces() if t["trace_id"] == trace_id]


def last_trace() -> Optional[dict]:
    with _ring_lock:
        return _ring[-1] if _ring else None


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def summarize(trace_dict: Optional[dict]) -> Optional[dict]:
    """The readyz()["last_tick_trace"] digest: id, duration, span
    count, and the slowest spans."""
    if trace_dict is None:
        return None
    spans = trace_dict["spans"]
    slowest = sorted(
        ((s["name"], round(s["t1_s"] - s["t0_s"], 6)) for s in spans[1:]),
        key=lambda t: -t[1],
    )[:5]
    return {
        "trace_id": trace_dict["trace_id"],
        "name": trace_dict["name"],
        "started_at": trace_dict["started_at"],
        "duration_s": trace_dict["duration_s"],
        "span_count": len(spans),
        "slowest": slowest,
    }


# attrs excluded from structure(): coupled to wall-clock progress of
# background threads (the warm pool races its compiles against early
# ticks), so they legitimately differ across byte-identical replays.
# The "tm_" prefix marks device-telemetry attrs (solver/telemetry.py)
# wholesale — compiled-analysis availability tracks the background
# capture worker, and live memory_stats are timing-coupled by nature.
_NONSTRUCTURAL_ATTRS = frozenset({"warm_hit"})
_NONSTRUCTURAL_ATTR_PREFIX = "tm_"

# events excluded from structure(): the regression sentinel flags
# timing anomalies (metrics/sentinel.py), which machine load can trip
# in only one of two byte-identical fault replays
_NONSTRUCTURAL_EVENTS = frozenset({"sentinel_anomaly"})


def structure(trace_dict: dict) -> list:
    """The deterministic skeleton of a trace: nested
    (name, attrs, events, children) with ids, timings, and the few
    background-thread-coupled attrs stripped — what chaos suites
    compare across byte-identical fault replays."""
    children: dict[int, list[dict]] = {}
    for s in trace_dict["spans"]:
        children.setdefault(s["parent_id"], []).append(s)

    def node(s: dict) -> list:
        return [
            s["name"],
            tuple(sorted(
                (k, v) for k, v in s["attrs"].items()
                if k not in _NONSTRUCTURAL_ATTRS
                and not k.startswith(_NONSTRUCTURAL_ATTR_PREFIX)
            )),
            tuple(
                tuple(sorted(e.items())) for e in s["events"]
                if e.get("name") not in _NONSTRUCTURAL_EVENTS
            ),
            [node(c) for c in children.get(s["span_id"], [])],
        ]

    roots = children.get(-1, [])
    return [node(r) for r in roots]


def span_stats(trace_dicts: Iterable[dict]) -> dict[str, dict]:
    """Per-span-name latency breakdown over a set of traces: count,
    total, p50/p99/max — the per-arm digest bench artifacts carry."""
    samples: dict[str, list[float]] = {}
    for t in trace_dicts:
        for s in t["spans"]:
            samples.setdefault(s["name"], []).append(s["t1_s"] - s["t0_s"])
    out = {}
    for name, vals in sorted(samples.items()):
        vals.sort()
        n = len(vals)
        out[name] = {
            "count": n,
            "total_s": round(sum(vals), 6),
            "p50_s": round(vals[n // 2], 6),
            "p99_s": round(vals[min(n - 1, (99 * n) // 100)], 6),
            "max_s": round(vals[-1], 6),
        }
    return out


def to_chrome(trace_dicts: Iterable[dict]) -> dict:
    """Chrome-trace/Perfetto JSON ("X" complete events, µs): load the
    /debug/traces?format=perfetto payload straight into ui.perfetto.dev
    or chrome://tracing."""
    events = []
    for idx, t in enumerate(trace_dicts):
        base_us = t["started_at"] * 1e6
        for s in t["spans"]:
            events.append({
                "name": s["name"],
                "cat": t["name"],
                "ph": "X",
                "ts": base_us + s["t0_s"] * 1e6,
                "dur": max(0.0, (s["t1_s"] - s["t0_s"]) * 1e6),
                "pid": 1,
                "tid": idx + 1,
                "args": {
                    "trace_id": t["trace_id"],
                    "span_id": s["span_id"],
                    **s["attrs"],
                    **(
                        {"events": s["events"]} if s["events"] else {}
                    ),
                },
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_json(trace_id: Optional[str] = None) -> str:
    """The /debug/traces body: the whole ring, or one trace's
    segments."""
    if trace_id:
        return json.dumps({"traces": find(trace_id)})
    return json.dumps({"traces": traces()})
