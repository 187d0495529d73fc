"""Metrics registry: counters and gauges.

Trimmed copy of `karpenter_tpu/metrics/store.py`: the `Counter`,
`Gauge` and `Registry` classes, the process-wide `REGISTRY`, and the
series the resilience ladder (`solver/resilience.py`), the fault
injector (`solver/faults.py`) and the device LP's degradation
(`solver/lp_device.py`) write, each with the JAX package's metric name
and help text. Values live in-process and can be scraped or dumped.
"""

from __future__ import annotations

import threading
from typing import Optional

LabelPairs = tuple[tuple[str, str], ...]


def _labels(labels: Optional[dict[str, str]]) -> LabelPairs:
    return tuple(sorted((labels or {}).items()))


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[LabelPairs, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Optional[dict[str, str]] = None, value: float = 1.0) -> None:
        key = _labels(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._values.get(_labels(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def samples(self) -> list[tuple[LabelPairs, float]]:
        with self._lock:
            return list(self._values.items())


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[LabelPairs, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_labels(labels)] = value

    def delete(self, labels: Optional[dict[str, str]] = None) -> None:
        with self._lock:
            self._values.pop(_labels(labels), None)

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._values.get(_labels(labels), 0.0)

    def series(self) -> dict[LabelPairs, float]:
        return dict(self._values)

    def samples(self) -> list[tuple[LabelPairs, float]]:
        with self._lock:
            return list(self._values.items())


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help))

    def _get(self, name, factory):
        metric = self._metrics.get(name)
        if metric is None:
            metric = factory()
            self._metrics[name] = metric
        return metric

    def dump(self) -> dict[str, dict]:
        out = {}
        for name, metric in self._metrics.items():
            if isinstance(metric, Counter):
                out[name] = {"type": "counter", "total": metric.total()}
            elif isinstance(metric, Gauge):
                out[name] = {"type": "gauge", "series": len(metric.series())}
        return out

    def collect(self) -> list[tuple[str, object]]:
        """Stable-order (name, metric) pairs for exposition."""
        return sorted(self._metrics.items())


# The process-wide registry.
REGISTRY = Registry()

SOLVER_LP_SOLVES = REGISTRY.counter(
    "karpenter_solver_lp_total",
    "Device LP solves, by outcome (converged / maxiter: ascent hit the "
    "iteration cap still improving / cache_hit: certified duals reused "
    "/ degraded: solve failed and the unguided path served)")
# resilience layer (solver/resilience.py): breaker state machine,
# degradation ladder routing, watchdog deadline misses, hedge
# outcomes, and the chaos injector's fired faults
SOLVER_BREAKER_STATE = REGISTRY.gauge(
    "karpenter_solver_breaker_state",
    "Per-backend solver circuit breaker state "
    "(0 closed / 1 half-open / 2 open)")
SOLVER_BREAKER_TRANSITIONS = REGISTRY.counter(
    "karpenter_solver_breaker_transitions_total",
    "Solver circuit breaker transitions, by backend and target state")
SOLVER_LADDER = REGISTRY.counter(
    "karpenter_solver_ladder_total",
    "Degradation-ladder rung attempts, by rung "
    "(remote/sharded/device/host) and outcome (ok, skipped_open, "
    "skipped_deadline, or the classified failure)")
SOLVER_DEADLINE_EXCEEDED = REGISTRY.counter(
    "karpenter_solver_deadline_exceeded_total",
    "Watchdog deadline misses, by phase (compile/execute/total)")
SOLVER_HEDGE = REGISTRY.counter(
    "karpenter_solver_hedge_total",
    "FFD hedge activity: fired (timer elapsed mid-solve), win "
    "(hedged result served the decision), loss (device finished first)")
SOLVER_FAULTS_INJECTED = REGISTRY.counter(
    "karpenter_solver_faults_injected_total",
    "Faults fired by the deterministic injector, by site and kind")
FAULTS_REJECTED = REGISTRY.counter(
    "karpenter_faults_rejected_total",
    "Malformed KARPENTER_FAULTS entries dropped at parse — nonzero "
    "means a chaos knob is typo'd and injecting nothing")
