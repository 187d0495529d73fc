"""Prometheus text exposition (format version 0.0.4) for the in-process
registry.

Copy of `karpenter_tpu/metrics/exposition.py`.

Counterpart of the metrics endpoint controller-runtime mounts for the
reference (pkg/operator/operator.go:183-222): the same `karpenter_*`
series the in-process stores publish, rendered in the text format any
Prometheus scraper consumes. Histograms are exposed with cumulative
`_bucket{le=...}` series plus `_sum`/`_count`, counters as `_total`-
named totals (names already carry the suffix), gauges as-is.
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.store import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    REGISTRY,
)


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _fmt_labels(pairs, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if value != value:  # NaN: the text format spells it literally —
        return "NaN"    # one poisoned series must not kill the scrape
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


def render(registry: Registry = REGISTRY) -> str:
    """The whole registry in Prometheus text format."""
    lines: list[str] = []
    for name, metric in registry.collect():
        if isinstance(metric, Counter):
            lines.append(f"# HELP {name} {_escape(metric.help)}")
            lines.append(f"# TYPE {name} counter")
            samples = metric.samples()
            if not samples:
                lines.append(f"{name} 0")
            for pairs, value in samples:
                lines.append(f"{name}{_fmt_labels(pairs)} {_fmt_value(value)}")
        elif isinstance(metric, Gauge):
            lines.append(f"# HELP {name} {_escape(metric.help)}")
            lines.append(f"# TYPE {name} gauge")
            for pairs, value in metric.samples():
                lines.append(f"{name}{_fmt_labels(pairs)} {_fmt_value(value)}")
        elif isinstance(metric, Histogram):
            lines.append(f"# HELP {name} {_escape(metric.help)}")
            lines.append(f"# TYPE {name} histogram")
            for pairs, counts, total_sum, total in metric.samples():
                cumulative = 0
                for bound, count in zip(metric.buckets, counts):
                    cumulative += count
                    le = 'le="' + _fmt_value(bound) + '"'
                    lines.append(
                        f"{name}_bucket{_fmt_labels(pairs, le)} {cumulative}"
                    )
                # +Inf bucket carries observations above the largest
                # bound too (observe() tallies them only in the total)
                le_inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_fmt_labels(pairs, le_inf)} {total}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(pairs)} {_fmt_value(total_sum)}"
                )
                lines.append(f"{name}_count{_fmt_labels(pairs)} {total}")
    return "\n".join(lines) + "\n"
