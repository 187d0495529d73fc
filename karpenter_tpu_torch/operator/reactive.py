"""Reactive placement plane: the debounce window between
the watch stream and the micro-solve.

Copy of `karpenter_tpu/operator/reactive.py`.

The operator's periodic reconcile loop makes arrival→bind latency a
function of the tick cadence: a pod created right after a tick waits a
full interval before the solver even sees it. This plane turns the
per-shard watch pump into the scheduling trigger. Pod-arrival events
(and capacity-freeing deletes) land here via `note_arrival` /
`note_capacity_freed`; a debounced batch (idle `KARPENTER_MICRO_DEBOUNCE_MS`,
bounded by `KARPENTER_MICRO_MAX_WAIT_MS` and `KARPENTER_MICRO_BATCH_MAX`)
fires `Operator.micro_step` into the incremental tick's O(dirty) path.

Determinism contract (the chaos suite's debounce-determinism test):
every decision here is a pure function of the operator-supplied clock
(`observe_now`) and the event sequence — no wall-clock reads, so batch
boundaries replay identically under the injectable clock. The
`threading.Event` wake exists only so the live `run()` loop can sleep
between events instead of polling; it carries no state the batch logic
depends on.

The plane also owns the arrival-stamp ledger that makes
`pod_to_bind_latency` an honest arrival→bind SLI: `_stamps` remembers
when each pending pod was first seen (preferring a numeric
`metadata.creation_timestamp` when the creator set one), the binding
queue subtracts it at bind time, and a TTL prune on full ticks bounds
the ledger by the pending backlog, never the fleet.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

PodKey = str  # "namespace/name" — the kube objects' own `.key` shape

ENV_ENABLE = "KARPENTER_REACTIVE"
ENV_DEBOUNCE_MS = "KARPENTER_MICRO_DEBOUNCE_MS"
ENV_MAX_WAIT_MS = "KARPENTER_MICRO_MAX_WAIT_MS"
ENV_BATCH_MAX = "KARPENTER_MICRO_BATCH_MAX"
ENV_STAMP_TTL_S = "KARPENTER_MICRO_STAMP_TTL_S"
# seconds between full audit/repack ticks when the reactive plane owns
# the loop; unset/0 keeps the legacy every-tick cadence
ENV_FULL_TICK_EVERY = "KARPENTER_FULL_TICK_EVERY"


def reactive_enabled() -> bool:
    """KARPENTER_REACTIVE gate, default ON (like the incremental tick:
    the reactive plane is the default path, the knob is the kill
    switch). Read per call so tests/bench can flip it live."""
    return os.environ.get(ENV_ENABLE, "1").lower() not in (
        "0", "false", "off"
    )


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ReactivePlane:
    """Debounced arrival batching with an injectable clock."""

    def __init__(self) -> None:
        # pending micro batch: insertion-ordered key -> RECEIPT time on
        # the plane clock (when the watch event reached us — the
        # debounce window's timeline; the arrival-stamp LEDGER below
        # keeps the creation-time stamps the latency SLI is measured
        # from, which may lie arbitrarily far in the past and must
        # never drive the window, or every batch would fire instantly)
        self._arrivals: dict[PodKey, float] = {}
        # persistent arrival ledger for arrival→bind measurement;
        # consumed at plan-enqueue time, TTL-pruned on full ticks
        self._stamps: dict[PodKey, float] = {}
        self._window_start: Optional[float] = None
        self._last_event: Optional[float] = None
        self._capacity_freed = False
        self._now: Optional[float] = None
        # live-loop wake: set on any event and on bind-plan enqueue so
        # run() drains immediately instead of sleeping the interval out
        self.wake = threading.Event()

    # -- knobs (re-read per call; satellite-1 discipline) --------------

    def debounce_s(self) -> float:
        return max(0.0, _env_float(ENV_DEBOUNCE_MS, 50.0)) / 1000.0

    def max_wait_s(self) -> float:
        return max(0.0, _env_float(ENV_MAX_WAIT_MS, 500.0)) / 1000.0

    def batch_max(self) -> int:
        return max(1, int(_env_float(ENV_BATCH_MAX, 256.0)))

    def stamp_ttl_s(self) -> float:
        return max(0.0, _env_float(ENV_STAMP_TTL_S, 900.0))

    # -- clock ---------------------------------------------------------

    def observe_now(self, now: float) -> None:
        """Advance the plane's clock (monotone; the operator calls this
        at the top of every step/micro_step with its injectable now)."""
        if self._now is None or now > self._now:
            self._now = now

    def clamp_stamp(self, ts) -> Optional[float]:
        """Arrival stamp for an event whose object carries a creation
        timestamp: prefer it when it lives on the same timeline as the
        plane clock (honest queue-time before the operator even saw
        the pod), fall back to `now` when it is absent, in the future,
        or from a different time domain entirely (a wall-clock stamp
        under a simulated clock would poison the latency SLI)."""
        now = self._now
        if now is None:
            return None
        if isinstance(ts, (int, float)) and (
            0.0 <= now - float(ts) <= self.stamp_ttl_s()
        ):
            return float(ts)
        return now

    # -- event intake --------------------------------------------------

    def note_arrival(self, key: PodKey, stamp: Optional[float] = None) -> bool:
        """An unbound pod appeared on the watch stream. Returns True if
        the pending batch changed. Before the first observe_now there
        is no timeline to stamp against (startup replay) — the arrival
        is ignored and the periodic path owns the pod."""
        if stamp is None:
            stamp = self._now
        if stamp is None:
            return False
        # earliest sighting wins: a MODIFIED after ADDED must not reset
        # the arrival stamp the bind latency is measured from
        if key not in self._stamps or stamp < self._stamps[key]:
            self._stamps[key] = stamp
        if not reactive_enabled():
            return False
        # the debounce window runs on RECEIPT time: a pod created long
        # before the operator saw it (startup backlog, relist replay)
        # still gets a full idle window to coalesce with its neighbors
        seen = self._now if self._now is not None else stamp
        if key not in self._arrivals:
            self._arrivals[key] = seen
        if self._window_start is None:
            self._window_start = seen
        self._last_event = seen
        self.wake.set()
        return True

    def note_capacity_freed(self, now: Optional[float] = None) -> None:
        """A bound pod vanished / a claim registered: capacity changed.
        Wakes the live loop and flags the operator to re-arm the full
        batcher so deferred demand retries against the freed room."""
        if now is not None:
            self.observe_now(now)
        if not reactive_enabled():
            return
        self._capacity_freed = True
        self.wake.set()

    def take_capacity_freed(self) -> bool:
        freed, self._capacity_freed = self._capacity_freed, False
        return freed

    # -- batch boundary ------------------------------------------------

    def pending(self) -> int:
        return len(self._arrivals)

    def ready(self, now: float) -> bool:
        """Deterministic batch boundary: fire on debounce-idle, on the
        max-wait bound, or when the batch hits the size cap."""
        if not self._arrivals:
            return False
        if len(self._arrivals) >= self.batch_max():
            return True
        # boundary tests MUST be the exact expressions next_deadline
        # hands back (`anchor + knob`, never `now - anchor >= knob`):
        # float rounding can make anchor+knob == now while now-anchor
        # < knob, and a loop sleeping until next_deadline would then
        # wake to a not-ready plane forever
        if self._last_event is not None and (
            now >= self._last_event + self.debounce_s()
        ):
            return True
        return self._window_start is not None and (
            now >= self._window_start + self.max_wait_s()
        )

    def next_deadline(self, now: float) -> Optional[float]:
        """Earliest future time `ready` could flip true — the live
        loop's sleep bound. None when nothing is pending."""
        if not self._arrivals:
            return None
        if self.ready(now):
            return now
        candidates = []
        if self._last_event is not None:
            candidates.append(self._last_event + self.debounce_s())
        if self._window_start is not None:
            candidates.append(self._window_start + self.max_wait_s())
        return min(candidates) if candidates else None

    def take_batch(self, now: float) -> dict:
        """Pop up to batch_max arrivals (FIFO). Leftovers keep their
        window so an oversized burst drains in consecutive firings.
        `debounce_latency` is the window wait — now minus the oldest
        RECEIPT in the batch, pure plane-clock (the chaos suite
        replays it byte-identically); arrival->bind latency is the
        stamp ledger's job, not this one's."""
        cap = self.batch_max()
        keys = list(self._arrivals.keys())[:cap]
        batch = {k: self._arrivals.pop(k) for k in keys}
        if self._arrivals:
            # re-anchor the window on the oldest leftover's receipt:
            # the next firing is due immediately (max-wait math, not a
            # reset)
            self._window_start = min(self._arrivals.values())
        else:
            self._window_start = None
            self._last_event = None
        latency = 0.0
        if batch:
            latency = max(0.0, now - min(batch.values()))
        return {"keys": keys, "stamps": batch, "debounce_latency": latency}

    def discard(self, key: PodKey) -> None:
        """A pending arrival became moot (bound/deleted before firing)."""
        self._arrivals.pop(key, None)
        if not self._arrivals:
            self._window_start = None
            self._last_event = None

    # -- arrival-stamp ledger ------------------------------------------

    def consume_stamps(self, keys) -> dict[PodKey, float]:
        """Pop arrival stamps for pods a bind plan now covers; the
        binding queue measures arrival→bind from these."""
        out = {}
        for key in keys:
            stamp = self._stamps.pop(key, None)
            if stamp is not None:
                out[key] = stamp
        return out

    def forget(self, key: PodKey) -> None:
        self._stamps.pop(key, None)
        self.discard(key)

    def status(self) -> dict:
        """readyz()["reactive"] digest."""
        return {
            "enabled": reactive_enabled(),
            "pending_batch": len(self._arrivals),
            "stamps": len(self._stamps),
            "capacity_freed": self._capacity_freed,
        }

    def prune(self, now: float) -> int:
        """Drop stamps older than the TTL (pods that shed and never
        bound). Called from full ticks: O(pending backlog)."""
        ttl = self.stamp_ttl_s()
        if ttl <= 0:
            return 0
        stale = [k for k, s in self._stamps.items() if now - s > ttl]
        for key in stale:
            self._stamps.pop(key, None)
            self.discard(key)
        return len(stale)
