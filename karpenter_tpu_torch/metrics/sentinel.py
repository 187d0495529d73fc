"""In-process regression sentinel.

Copy of `karpenter_tpu/metrics/sentinel.py`.

"Did the last change make things slower?" is answered today by a human
re-running bench. The sentinel answers it continuously: rolling
baselines over the per-phase solver durations and the tick wall, with
anomalies flagged the moment a signal departs its own recent history —
as span events on the open trace and as
`karpenter_sentinel_anomaly_total{signal}`, never by blocking a tick.

Baseline model: EWMA of the signal plus an EWMA of the absolute
deviation (a MAD estimate) — both sample-count-driven, with no
wall-clock dependence anywhere, so the baselines replay identically
for an identical sample sequence. A sample is anomalous when its
deviation from the EWMA exceeds max(K x MAD, floor) after the warmup
count; the floor keeps microsecond-scale phases (steady-state encode)
from paging on scheduler jitter. Anomalous samples still update the
baselines (a real regression becomes the new normal within ~1/alpha
samples — the counter records the transition, which is the signal).

The span events the sentinel emits are timing-coupled by definition,
so `tracing.structure()` strips them (the `sentinel_anomaly` event
name is nonstructural) — byte-identical fault replays stay
byte-identical even when machine load trips the sentinel in only one
of the two runs.

Knobs (read per observation — cheap, and chaos suites flip them live):

| env | default | effect |
| --- | --- | --- |
| KARPENTER_SENTINEL | 1 | 0 disables observation entirely |
| KARPENTER_SENTINEL_WARMUP | 16 | samples before a signal can flag |
| KARPENTER_SENTINEL_K | 8.0 | anomaly threshold, in MAD multiples |
| KARPENTER_SENTINEL_ALPHA | 0.05 | EWMA smoothing factor |
| KARPENTER_SENTINEL_FLOOR_MS | 5.0 | absolute deviation floor |
"""

from __future__ import annotations

import os
import threading
from typing import Optional


def enabled() -> bool:
    return os.environ.get("KARPENTER_SENTINEL", "1").strip().lower() not in (
        "0", "off", "false", "no",
    )


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class _Baseline:
    __slots__ = ("n", "ewma", "mad", "anomalies", "last_value",
                 "last_deviation")

    def __init__(self) -> None:
        self.n = 0
        self.ewma = 0.0
        self.mad = 0.0
        self.anomalies = 0
        self.last_value = 0.0
        self.last_deviation = 0.0


class Sentinel:
    """Rolling EWMA+MAD baselines keyed by signal name. observe() is
    O(1), lock-bounded, and exception-free — the telemetry plane must
    never take the hot path down."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._baselines: dict[str, _Baseline] = {}

    def observe(self, signal: str, value: float) -> bool:
        """Feed one sample; returns True when it was flagged anomalous
        (after warmup). Baselines update on every sample either way."""
        if not enabled():
            return False
        try:
            value = float(value)
            if value != value or value in (float("inf"), float("-inf")):
                # a non-finite sample must neither poison the EWMA nor
                # land NaN on the baseline gauges (a NaN gauge breaks
                # any consumer doing integer formatting)
                return False
            return self._observe(signal, value)
        except Exception:  # pragma: no cover - defensive by contract
            return False

    def _observe(self, signal: str, value: float) -> bool:
        warmup = _env_int("KARPENTER_SENTINEL_WARMUP", 16)
        k = _env_float("KARPENTER_SENTINEL_K", 8.0)
        alpha = _env_float("KARPENTER_SENTINEL_ALPHA", 0.05)
        floor = _env_float("KARPENTER_SENTINEL_FLOOR_MS", 5.0) / 1000.0
        with self._lock:
            base = self._baselines.get(signal)
            if base is None:
                base = self._baselines[signal] = _Baseline()
            if base.n == 0:
                deviation = 0.0
                anomaly = False
                base.ewma = value
            else:
                deviation = abs(value - base.ewma)
                anomaly = (
                    base.n >= warmup
                    and deviation > max(k * base.mad, floor)
                )
                base.ewma += alpha * (value - base.ewma)
            base.mad += alpha * (deviation - base.mad)
            base.n += 1
            base.last_value = value
            base.last_deviation = deviation
            if anomaly:
                base.anomalies += 1
            ewma, mad = base.ewma, base.mad
        from karpenter_tpu_torch.metrics.store import (
            SENTINEL_ANOMALIES,
            SENTINEL_BASELINE,
        )

        SENTINEL_BASELINE.set(round(ewma, 9),
                              {"signal": signal, "stat": "ewma"})
        SENTINEL_BASELINE.set(round(mad, 9),
                              {"signal": signal, "stat": "mad"})
        if anomaly:
            SENTINEL_ANOMALIES.inc({"signal": signal})
            from karpenter_tpu_torch import tracing

            # nonstructural by name (tracing._NONSTRUCTURAL_EVENTS):
            # the payload is timing-coupled, so replays may disagree
            tracing.add_event(
                "sentinel_anomaly",
                signal=signal,
                value_ms=round(value * 1000.0, 3),
                baseline_ms=round(ewma * 1000.0, 3),
                mad_ms=round(mad * 1000.0, 3),
            )
        return anomaly

    def summary(self) -> dict:
        """Per-signal baseline digest (bench's sentinel_summary)."""
        with self._lock:
            return {
                name: {
                    "samples": b.n,
                    "ewma_ms": round(b.ewma * 1000.0, 3),
                    "mad_ms": round(b.mad * 1000.0, 3),
                    "last_ms": round(b.last_value * 1000.0, 3),
                    "anomalies": b.anomalies,
                }
                for name, b in sorted(self._baselines.items())
            }

    def anomaly_total(self) -> int:
        with self._lock:
            return sum(b.anomalies for b in self._baselines.values())

    def snapshot(self) -> dict:
        """Checkpoint view of every baseline:
        summary() plus per-signal warmup state and the anomaly total —
        the block readyz()[\"sentinel\"] mirrors, and what
        reset_baselines() hands back as the phase checkpoint."""
        warmup = _env_int("KARPENTER_SENTINEL_WARMUP", 16)
        with self._lock:
            return {
                "signals": {
                    name: {
                        "samples": b.n,
                        "ewma_ms": round(b.ewma * 1000.0, 3),
                        "mad_ms": round(b.mad * 1000.0, 3),
                        "last_ms": round(b.last_value * 1000.0, 3),
                        "anomalies": b.anomalies,
                        "warmed": b.n >= warmup,
                    }
                    for name, b in sorted(self._baselines.items())
                },
                "anomaly_total": sum(
                    b.anomalies for b in self._baselines.values()
                ),
            }

    def reset_baselines(self, signals=None) -> dict:
        """Drop baselines so the named signals (all, when None)
        re-enter warmup deterministically — the soak harness's
        phase-boundary seam: a regime change (diurnal wave -> surge
        storm) is a NEW normal, and carrying the old baseline across
        it would page on the phase transition itself. Returns the
        pre-reset snapshot() (the phase checkpoint); the in-object
        anomaly counts reset with their baselines, while
        karpenter_sentinel_anomaly_total keeps the whole-process
        history."""
        checkpoint = self.snapshot()
        with self._lock:
            if signals is None:
                self._baselines.clear()
            else:
                for name in signals:
                    self._baselines.pop(name, None)
        return checkpoint

    def reset(self) -> None:
        with self._lock:
            self._baselines.clear()


# the process-wide sentinel: solver phase sites have no operator
# handle, so observation routes through this singleton
_shared = Sentinel()


def shared() -> Sentinel:
    return _shared


def observe(signal: str, value: float) -> bool:
    return _shared.observe(signal, value)


def observe_phase(phase: str, seconds: float) -> bool:
    """The solver phase hook — called next to every
    SOLVER_PHASE_DURATION.observe site."""
    return _shared.observe("solve." + phase, seconds)


def summary() -> dict:
    return _shared.summary()


def anomaly_total() -> int:
    return _shared.anomaly_total()


def snapshot() -> dict:
    return _shared.snapshot()


def reset_baselines(signals=None) -> dict:
    return _shared.reset_baselines(signals)


def reset() -> None:
    _shared.reset()
