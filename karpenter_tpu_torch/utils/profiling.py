"""Wall-clock profiler — the pprof-harness analogue.

Copy of `karpenter_tpu/utils/profiling.py`.

The reference mounts net/http/pprof behind --enable-profiling
(operator.go:183-199) and its benchmark harness emits cpu/heap
profiles (scheduling_benchmark_test.go:114-160). This package's hot path
is a set of CUDA kernels (timed with CUDA events when needed), so
the operator-level equivalent is a label -> latency-histogram tracer:
cheap enough to leave on, queryable like a /debug/pprof summary, and
driving the per-controller step timings the operator exposes.

Backed by the ONE histogram implementation (metrics/store.Histogram) —
each Profiler keeps a private instance for its report(), and every
observation is mirrored into the shared registry series
`karpenter_operator_step_duration_seconds{step=...}`, so per-
controller step latencies land on /metrics, not just in report().
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from karpenter_tpu_torch.metrics.store import REGISTRY, Histogram

# fixed latency bucket edges (seconds); overflow rides the histogram's
# implicit +Inf (total - sum(buckets)) — a span slower than the
# largest edge must never masquerade as <= that edge
BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0)
_BUCKET_LABELS = tuple(f"le_{b}" for b in BUCKETS) + ("le_inf",)

# the registry-exported view: one series per (profiler step label),
# scraped from /metrics like every other karpenter_* histogram
STEP_DURATION = REGISTRY.histogram(
    "karpenter_operator_step_duration_seconds",
    "Per-controller step wall clock from the operator profiler, by "
    "step label (the /debug/profile report's backing series)",
    buckets=BUCKETS)


class Profiler:
    """Label -> wall-clock histogram with nesting support."""

    def __init__(self, enabled: bool = True, clock=None):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter
        # private store.Histogram: report() must describe THIS
        # profiler's spans, while the shared registry series (also
        # observed below) aggregates across the process
        self._hist = Histogram("profiler", buckets=BUCKETS)
        self._max: dict[str, float] = {}

    @contextmanager
    def span(self, label: str):
        if not self.enabled:
            yield
            return
        start = self.clock()
        try:
            yield
        finally:
            self.record(label, self.clock() - start)

    def record(self, label: str, seconds: float) -> None:
        if not self.enabled:
            return
        labels = {"step": label}
        self._hist.observe(seconds, labels)
        STEP_DURATION.observe(seconds, labels)
        if seconds > self._max.get(label, 0.0):
            self._max[label] = seconds

    def report(self) -> dict[str, dict]:
        """The /debug/pprof-style summary: per label, call count, mean,
        max and bucketed latency counts."""
        out: dict[str, dict] = {}
        for pairs, counts, total_s, count in self._hist.samples():
            label = dict(pairs)["step"]
            buckets = list(counts) + [count - sum(counts)]
            out[label] = {
                "count": count,
                "mean_s": round(total_s / count, 6) if count else 0.0,
                "total_s": round(total_s, 6),
                "max_s": round(self._max.get(label, 0.0), 6),
                "buckets": dict(zip(_BUCKET_LABELS, buckets)),
            }
        return dict(sorted(out.items()))

    def reset(self) -> None:
        self._hist = Histogram("profiler", buckets=BUCKETS)
        self._max.clear()
