"""Deduplicated event recorder, flushed to the API substrate.

Copy of `karpenter_tpu/events/recorder.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/events/recorder.go:47-120: events identical in
(kind, object, reason, message) within a 10s TTL are dropped; a simple
per-reason token bucket guards against floods. With a `kube` sink the
recorder also publishes real corev1 Event objects (recorder.go:52-72
goes through record.EventRecorder to the API server — that is what
`kubectl describe` shows an operator debugging a live cluster):
fresh events are created, deduped repeats bump the existing Event's
count/lastTimestamp, rate-limited floods never reach the server.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

_seq = itertools.count(1)


@dataclass(frozen=True)
class Event:
    kind: str          # object kind
    name: str          # object name
    type: str          # Normal | Warning
    reason: str
    message: str
    namespace: str = ""  # empty for cluster-scoped objects


@dataclass
class RecordedEvent:
    event: Event
    timestamp: float
    count: int = 1
    # flight-recorder provenance: the tick trace open when the event
    # was first published ("" outside any trace). Lives here — NOT on
    # the frozen Event — so dedupe identity ignores it: the same event
    # republished from a later tick still dedupes.
    trace_id: str = ""


class EventRecorder:
    DEDUPE_TTL = 10.0
    RATE_LIMIT_PER_REASON = 10  # events per TTL window
    MAX_EVENTS = 1000           # ring buffer: long-running loops must not leak

    def __init__(self, kube=None) -> None:
        from collections import deque

        self.kube = kube  # optional API sink for corev1 Events
        self.events: "deque[RecordedEvent]" = deque(maxlen=self.MAX_EVENTS)
        self._last_seen: dict[Event, float] = {}
        self._reason_counts: dict[str, list[float]] = {}
        self._posted: dict[Event, object] = {}  # event -> KubeEvent CR
        self._last_flush: dict[Event, float] = {}  # bump-PUT throttle
        # sink-side retention for the SIMULATION store only: a real
        # apiserver expires Events (~1h TTL); the in-memory store has
        # no TTL, so the recorder deletes its oldest posts beyond
        # MAX_EVENTS to keep long sims from leaking
        self._sink_fifo: "deque" = deque()

    def publish(self, event: Event, now: Optional[float] = None,
                sticky: bool = False) -> bool:
        """`sticky` makes the frozen-key dedupe window SLIDING: a
        duplicate republished within the TTL refreshes the window, so
        a condition that persists tick after tick (an unschedulable
        pod) bumps the one posted Event's count forever instead of
        reposting an identical message every DEDUPE_TTL — persistence
        stays visible through counters, not apiserver spam."""
        now = time.time() if now is None else now
        # prune the dedupe cache so distinct one-off events can't grow
        # it without bound
        if len(self._last_seen) > 4 * self.MAX_EVENTS:
            self._last_seen = {
                e: t for e, t in self._last_seen.items()
                if now - t < self.DEDUPE_TTL
            }
            self._posted = {
                e: o for e, o in self._posted.items() if e in self._last_seen
            }
        last = self._last_seen.get(event)
        if last is not None and now - last < self.DEDUPE_TTL:
            if sticky:
                self._last_seen[event] = now
            for rec in reversed(self.events):
                if rec.event == event:
                    rec.count += 1
                    break
            self._bump_posted(event, now)
            return False
        window = [t for t in self._reason_counts.get(event.reason, []) if now - t < self.DEDUPE_TTL]
        if len(window) >= self.RATE_LIMIT_PER_REASON:
            self._reason_counts[event.reason] = window
            return False
        window.append(now)
        self._reason_counts[event.reason] = window
        self._last_seen[event] = now
        from karpenter_tpu_torch import tracing

        self.events.append(RecordedEvent(
            event=event, timestamp=now,
            trace_id=tracing.current_trace_id(),
        ))
        self._post(event, now)
        return True

    # -- corev1 Event sink ----------------------------------------------

    def _post(self, event: Event, now: float) -> None:
        if self.kube is None:
            return
        from karpenter_tpu_torch import tracing
        from karpenter_tpu_torch.kube.objects import KubeEvent, ObjectMeta

        # corev1 Events carry the provenance annotation too: kubectl
        # describe on a disrupted node leads straight to the tick trace
        trace_id = tracing.current_trace_id()
        obj = KubeEvent(
            metadata=ObjectMeta(
                # the real recorder's unique-name convention:
                # <object>.<time-based suffix> (UnixNano upstream) —
                # time-seeded so a restarted operator never regenerates
                # a name that still exists server-side (Events live ~1h;
                # a collision 409s and the event would be lost). _seq
                # disambiguates same-microsecond publishes in sims.
                name=f"{event.name}.{int(now * 1e6):x}{next(_seq):04x}",
                namespace=event.namespace or "default",
                annotations=(
                    {tracing.PROVENANCE_ANNOTATION: trace_id}
                    if trace_id else {}
                ),
            ),
            involved_kind=event.kind,
            involved_name=event.name,
            involved_namespace=event.namespace,
            type=event.type,
            reason=event.reason,
            message=event.message,
            count=1,
            first_timestamp=now,
            last_timestamp=now,
        )
        try:
            self.kube.create(obj)
        except Exception:
            return  # event loss is tolerable; controllers never block on it
        self._posted[event] = obj
        self._last_flush[event] = now
        if getattr(self.kube, "simulates_workload_controllers", False):
            self._sink_fifo.append(obj)
            while len(self._sink_fifo) > self.MAX_EVENTS:
                old = self._sink_fifo.popleft()
                try:
                    self.kube.delete(old)
                except Exception:
                    pass

    def _bump_posted(self, event: Event, now: float) -> None:
        obj = self._posted.get(event)
        if obj is None or self.kube is None:
            return
        obj.count += 1
        obj.last_timestamp = now
        # throttle the write: a pod stuck behind a PDB republishes every
        # reconcile, and a synchronous PUT per tick per stuck object
        # would put apiserver round-trips on the hot path (the reference
        # posts through an async broadcaster). The local count keeps
        # accumulating; at most one flush per second carries it up.
        if now - self._last_flush.get(event, 0.0) < 1.0:
            return
        self._last_flush[event] = now
        try:
            self.kube.update(obj)
        except Exception:
            self._posted.pop(event, None)  # deleted/expired server-side

    def for_reason(self, reason: str) -> list[RecordedEvent]:
        return [r for r in self.events if r.event.reason == reason]
