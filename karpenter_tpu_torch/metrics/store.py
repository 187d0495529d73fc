"""Metrics registry: counters, gauges, histograms, and a diff-publishing
gauge store.

Copy of `karpenter_tpu/metrics/store.py`. The device telemetry series
(`karpenter_device_*`) keep their names; on the card they carry what
`solver/telemetry.py` reads there (the kernels' launch bytes and
shared memory, the CUDA allocator's stats).

Counterpart of pkg/metrics (metrics.go core series names, store.go:33-110
`Store` that re-publishes per-object gauge sets and deletes stale ones).
Backend-agnostic: values live in-process and can be scraped/dumped; the
series names mirror the reference's `karpenter_*` namespace so
dashboards translate 1:1.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Iterable, Optional

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


class Histogram:
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 300)

    def __init__(self, name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = sorted(buckets)
        self._counts: dict[LabelPairs, list[int]] = {}
        self._sums: dict[LabelPairs, float] = {}
        self._totals: dict[LabelPairs, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        key = _labels(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = bisect.bisect_left(self.buckets, value)
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[dict[str, str]] = None) -> int:
        return self._totals.get(_labels(labels), 0)

    def sum(self, labels: Optional[dict[str, str]] = None) -> float:
        return self._sums.get(_labels(labels), 0.0)

    def samples(self) -> list[tuple[LabelPairs, list[int], float, int]]:
        """(labels, per-bucket counts, sum, total) per series."""
        with self._lock:
            return [
                (key, list(counts), self._sums.get(key, 0.0),
                 self._totals.get(key, 0))
                for key, counts in self._counts.items()
            ]


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, **kw))

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
            elif isinstance(metric, Histogram):
                out[name] = {"type": "histogram"}
        return out

    def collect(self) -> list[tuple[str, object]]:
        """Stable-order (name, metric) pairs for exposition."""
        return sorted(self._metrics.items())


# The process-wide registry and the reference's core series
# (pkg/metrics/metrics.go:32).
REGISTRY = Registry()

NODECLAIMS_CREATED = REGISTRY.counter(
    "karpenter_nodeclaims_created_total", "NodeClaims created, by nodepool")
NODECLAIMS_TERMINATED = REGISTRY.counter(
    "karpenter_nodeclaims_terminated_total", "NodeClaims terminated, by nodepool")
NODECLAIMS_DISRUPTED = REGISTRY.counter(
    "karpenter_nodeclaims_disrupted_total", "NodeClaims disrupted, by reason")
PODS_SCHEDULING_DURATION = REGISTRY.histogram(
    "karpenter_pods_scheduling_duration_seconds",
    "Time from pod first seen to scheduling decision")
PODS_STARTUP_DURATION = REGISTRY.histogram(
    "karpenter_pods_startup_duration_seconds",
    "Time from pod first seen to bound")
SCHEDULING_DURATION = REGISTRY.histogram(
    "karpenter_provisioner_scheduling_duration_seconds",
    "Solve wall clock")
DISRUPTION_EVALUATION_DURATION = REGISTRY.histogram(
    "karpenter_disruption_evaluation_duration_seconds",
    "Disruption method evaluation wall clock")

# scheduler subsystem (provisioning/scheduling/metrics.go:33-95)
SCHEDULER_SCHEDULING_DURATION = REGISTRY.histogram(
    "karpenter_scheduler_scheduling_duration_seconds",
    "Duration of scheduling simulations (provisioning and disruption)")
SCHEDULER_QUEUE_DEPTH = REGISTRY.gauge(
    "karpenter_scheduler_queue_depth",
    "Pods currently waiting to be scheduled in an active solve")
SCHEDULER_UNFINISHED_WORK = REGISTRY.gauge(
    "karpenter_scheduler_unfinished_work_seconds",
    "Seconds of in-progress solve work not yet observed by the "
    "duration histogram")
SCHEDULER_IGNORED_PODS = REGISTRY.gauge(
    "karpenter_scheduler_ignored_pods_count",
    "Pods ignored during scheduling (foreign scheduler, invalid PVCs)")
SCHEDULER_UNSCHEDULABLE_PODS = REGISTRY.gauge(
    "karpenter_scheduler_unschedulable_pods_count",
    "Pods the last solve could not place")

# solver hot-path phase breakdown (the per-phase view the BASELINE
# "<1s p99" target is judged against: where a slow solve actually
# spent its wall clock). Buckets extend below the default histogram's
# 5ms floor — steady-state encode/dispatch phases run sub-millisecond.
SOLVER_PHASE_DURATION = REGISTRY.histogram(
    "karpenter_solver_phase_duration_seconds",
    "Solver wall clock by phase (encode/compile/transfer/execute/"
    "decode), per solve",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1, 2.5, 5, 10, 30, 120))
SOLVER_ENCODE_CACHE = REGISTRY.counter(
    "karpenter_solver_encode_cache_total",
    "Encoder compat-row cache lookups, by outcome (hit/miss/bust)")
SOLVER_INCREMENTAL_TICKS = REGISTRY.counter(
    "karpenter_solver_incremental_ticks_total",
    "Warm-start pipeline ticks, by mode (incremental/full) and reason")
SOLVER_INCREMENTAL_DUAL = REGISTRY.counter(
    "karpenter_solver_incremental_dual_total",
    "Dual-guided residual repack activity, by outcome (rank_win: the "
    "reduced-cost-ordered repack beat the unguided pack and was "
    "kept; rank_loss: the unguided pack stayed; floor_skip: a drift "
    "backstop re-solve skipped because weak duality proved the "
    "retained fleet already prices within epsilon of the LP floor)")
# incremental live tick (provisioning/incremental_tick.py): the
# provisioner's retained-state reconcile path and its self-audit
INCREMENTAL_TICK = REGISTRY.counter(
    "karpenter_incremental_tick_total",
    "Provisioner live reconcile ticks, by path (incremental: served "
    "from retained state; full_backstop: routed to the full Scheduler "
    "with the ineligibility reason; quarantined: retained state "
    "distrusted, full-solve decision served)")
INCREMENTAL_DIVERGENCE = REGISTRY.counter(
    "karpenter_incremental_oracle_divergence_total",
    "Incremental-vs-full decision divergences caught by the shadow "
    "oracle audit — every one quarantines the retained state; a "
    "nonzero rate means the dirty-set plumbing is missing changes")
INCREMENTAL_AUDITS = REGISTRY.counter(
    "karpenter_incremental_audit_total",
    "Shadow full-solve oracle audits of the incremental live tick, by "
    "verdict (ok/divergence) and trigger (cadence/fault/recovery/"
    "probation)")
INCREMENTAL_FINGERPRINT_AGE = REGISTRY.gauge(
    "karpenter_incremental_fingerprint_age_ticks",
    "Incremental ticks served since the retained fleet state was last "
    "rebuilt from scratch — the staleness horizon the oracle audit "
    "bounds")
# reactive placement (operator/reactive.py + Operator.micro_step): the
# event-driven sub-tick arrival→bind path
MICRO_SOLVE = REGISTRY.counter(
    "karpenter_micro_solve_total",
    "Event-driven micro-solves, by outcome (served: bind plans "
    "enqueued from the O(dirty) incremental path; deferred: the "
    "envelope routed the batch to the next full tick; empty: the "
    "debounced batch resolved to nothing live to place)")
MICRO_BATCH_SIZE = REGISTRY.histogram(
    "karpenter_micro_batch_size",
    "Pod arrivals per debounced micro-solve batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
MICRO_DEBOUNCE_LATENCY = REGISTRY.histogram(
    "karpenter_micro_debounce_latency_seconds",
    "Oldest-arrival age when a debounced micro batch fires — the "
    "queueing delay the debounce window itself adds to arrival→bind",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5))
DISRUPTION_SCAN_SKIPPED = REGISTRY.counter(
    "karpenter_disruption_scan_skipped_total",
    "Disruption reconcile rounds skipped because nothing went dirty "
    "since the last empty-handed scan (the watch-driven O(changes) "
    "gate; a periodic forced scan bounds staleness)")
DISRUPTION_SNAPSHOT = REGISTRY.counter(
    "karpenter_disruption_snapshot_total",
    "Retained disruption snapshot rows, by outcome (hit: row served "
    "from the retained fleet seam; rebuild: row re-derived for a "
    "dirty/volatile node; audit: from-scratch identity audits of a "
    "retained scan; divergence: audit mismatches — each one "
    "invalidates the retained rows and serves the fresh build)")
SOLVER_DEVICE_STEPS = REGISTRY.histogram(
    "karpenter_solver_device_steps",
    "Outer-loop device steps per packing solve, by path "
    "(sequential: one step per padded pod group; wavefront: one step "
    "per committed round) — sum/count gives steps-per-solve",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096))
SOLVER_WAVEFRONT_WIDTH = REGISTRY.histogram(
    "karpenter_solver_wavefront_width",
    "Pod groups committed per wavefront round (width 1 = the round "
    "degenerated to a sequential step)",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128))
SOLVER_WARM_COMPILES = REGISTRY.counter(
    "karpenter_solver_warm_compiles_total",
    "Kernel shape buckets AOT-compiled by the warm pool, by outcome")
SOLVER_SHARDS = REGISTRY.gauge(
    "karpenter_solver_shards",
    "Shard count the last device solve actually ran with (1 = "
    "unsharded) — makes the silent KARPENTER_SOLVER_SHARDS "
    "fallback-to-unsharded observable instead of log-only")
SOLVER_STREAM_BLOCKS = REGISTRY.counter(
    "karpenter_solver_stream_blocks_total",
    "Per-shard column blocks shipped by the streaming staging path "
    "(solver/stream.py) — zero on a sharded fleet means every solve "
    "is still paying full-materialization host peaks")
# device LP relaxation (solver/lp_device.py): the dual solve whose
# certificates guide the cost pack, the trim pass, and probe pruning
SOLVER_LP_DURATION = REGISTRY.histogram(
    "karpenter_solver_lp_duration_seconds",
    "Device LP dual-ascent wall clock per (non-cached) solve — the "
    "guidance cost the gap_vs_lp reduction is bought with",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1, 2.5, 5, 10))
SOLVER_LP_ITERATIONS = REGISTRY.histogram(
    "karpenter_solver_lp_iterations",
    "Projected-supergradient iterations per device LP solve "
    "(KARPENTER_LP_ITERS)",
    buckets=(8, 16, 32, 64, 128, 192, 256, 384, 512, 1024))
SOLVER_LP_SOLVES = REGISTRY.counter(
    "karpenter_solver_lp_total",
    "Device LP solves, by outcome (converged / maxiter: ascent hit the "
    "iteration cap still improving / cache_hit: certified duals reused "
    "/ degraded: solve failed and the unguided path served)")
SOLVER_PROBE_PRUNED = REGISTRY.counter(
    "karpenter_solver_probe_pruned_total",
    "Consolidation probes skipped because the dual certificate proved "
    "the candidates cannot be replaced strictly cheaper "
    "(decision-identical to probing: the simulation could only have "
    "returned no command)")
SOLVER_PROBE_BATCH = REGISTRY.counter(
    "karpenter_solver_probe_batch_total",
    "Batched consolidation probe activity: device dispatches (batch), "
    "lanes evaluated (lane), node-axis regrow retries (capped_retry), "
    "and lanes handed back to the sequential path (fallback_lane)")
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
# scenario flywheel: trace-driven chaos soak + judge
SCENARIO_EVENTS = REGISTRY.counter(
    "karpenter_scenario_events_total",
    "Workload events the scenario flywheel's composed schedule applied "
    "against the soak cluster, by layer and kind (create / delete)")
SOAK_VERDICT = REGISTRY.gauge(
    "karpenter_soak_verdict",
    "Last scenario-flywheel soak judge verdict, by scenario (1 pass / "
    "0 fail — a fail names the losing observability plane in the "
    "verdict artifact)")
# spot capacity tier (cloudprovider spot offerings, disruption/
# interruption.py, scheduler spot budget)
SPOT_INTERRUPTIONS = REGISTRY.counter(
    "karpenter_spot_interruptions_total",
    "Spot instances that received an interruption notice, by provider")
INTERRUPTION_COMMANDS = REGISTRY.counter(
    "karpenter_interruption_commands_total",
    "Drain-after-replace commands started for interrupted nodes, by "
    "nodepool")
SPOT_BUDGET_PINNED = REGISTRY.counter(
    "karpenter_spot_budget_pinned_total",
    "Planned nodes pinned off spot (onto their cheapest non-spot "
    "offering) by the per-pool spot budget (max-spot-fraction cap or "
    "min-on-demand floor), by nodepool and cause")
# control-plane fault tolerance (kube/retry.py, operator recovery):
# the kube-API analogue of the solver breaker metrics above
KUBE_RETRIES = REGISTRY.counter(
    "karpenter_kube_retries_total",
    "Kube API requests retried by the conflict/throttle-aware write "
    "wrapper, by verb and response status (409/429/5xx)")
KUBE_RELIST = REGISTRY.counter(
    "karpenter_kube_relist_total",
    "Informer relists after a watch fell off the server's event "
    "horizon (410 Gone), by kind")
# sharded state plane (state/shards.py): per-shard stream continuity
# and scoped invalidation accounting
STATE_SHARDS = REGISTRY.gauge(
    "karpenter_state_shards",
    "Configured state-plane shard count (KARPENTER_STATE_SHARDS) — "
    "the hash-partition width shared by the watch pump's logical "
    "streams, the retained-state invalidation domains, and the "
    "bind/evict queues")
STATE_SHARD_RELIST = REGISTRY.counter(
    "karpenter_state_shard_relist_total",
    "Shard-scoped informer relists (a 410 on one shard's logical "
    "stream re-LISTed only that shard's keys, leaving other shards' "
    "retained rows warm), by kind and shard")
STATE_SHARD_INVALIDATIONS = REGISTRY.counter(
    "karpenter_state_shard_invalidations_total",
    "Shard-scoped retained-state invalidations (rows dropped for the "
    "relisted shards only instead of a whole-cache bust), by layer "
    "(disruption_snapshot / incremental)")
STATE_SHARD_QUEUE_PENDING = REGISTRY.gauge(
    "karpenter_state_shard_queue_pending",
    "Items pending in a sharded operator queue, by queue (bind / "
    "evict) and shard")
OPERATOR_RECOVERY = REGISTRY.counter(
    "karpenter_operator_recovery_total",
    "Crash-recovery actions taken at operator boot, by action "
    "(readopted_claim / requeued_pod / reaped_leak)")
BINDING_RETRY = REGISTRY.counter(
    "karpenter_binding_retry_total",
    "Pod bindings re-enqueued after a retryable API failure "
    "(409/429/5xx), by status")
# priority-aware overload protection (provisioning/priority.py,
# provisioning/preemption.py, state/nodepoolhealth.py)
PRIORITY_SHED = REGISTRY.counter(
    "karpenter_priority_shed_total",
    "Pods shed by priority admission under overload — the lowest-"
    "priority tail of the admission order when demand exceeds pool "
    "limits or catalog capacity; shed pods retry next round")
PREEMPTION_EVICTIONS = REGISTRY.counter(
    "karpenter_preemption_evictions_total",
    "Victim pods evicted by the preemption controller so a pending "
    "higher-priority pod can land, by nodepool")
PREEMPTION_NOMINATIONS = REGISTRY.counter(
    "karpenter_preemption_nominations_total",
    "Pending higher-priority pods that nominated a victim node "
    "(status.nominatedNodeName stamped, victims evicted, binding "
    "queued)")
NODEPOOL_REGISTRATION_HEALTHY = REGISTRY.gauge(
    "karpenter_nodepool_registration_healthy",
    "Per-nodepool launch/registration health from the ring-buffer "
    "tracker (1 healthy / 0 degraded — the NodeRegistrationHealthy "
    "condition's signal, surfaced for operators)")
# operator tick liveness: the wedge-detection signals —
# healthz() reports unhealthy when the last tick's age exceeds
# KARPENTER_TICK_STALL_MULTIPLE x the tick interval
OPERATOR_LAST_TICK = REGISTRY.gauge(
    "karpenter_operator_last_tick_timestamp_seconds",
    "Wall-clock timestamp of the last completed operator tick — a "
    "stalled series means the reconcile loop is wedged (healthz "
    "reports unhealthy past the configured staleness multiple)")
OPERATOR_TICK_DURATION = REGISTRY.histogram(
    "karpenter_operator_tick_duration_seconds",
    "Operator tick wall clock (Operator.step), end to end across "
    "every controller",
    buckets=(0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30,
             60, 300))
DISRUPTION_PROBE_STARVATION = REGISTRY.counter(
    "karpenter_disruption_probe_starvation_total",
    "Consolidation probes attempted vs still remaining when a method's "
    "wall-clock budget expired, by method — a growing 'remaining' "
    "series means the disruption budget is starving the scan")
# device telemetry plane (solver/telemetry.py): per kernel bucket what
# the card states of it, live allocator stats, staging attribution
DEVICE_COMPILED_MEMORY = REGISTRY.gauge(
    "karpenter_device_compiled_memory_bytes",
    "What one launch of a solver kernel bucket commits on the card, by "
    "kernel, padded shape bucket, shard count, and component (argument/"
    "output bytes, dynamic_smem/global_scratch of its tables)")
DEVICE_COMPILED_COST = REGISTRY.gauge(
    "karpenter_device_compiled_cost",
    "XLA cost_analysis of a compiled solver program (flops / "
    "bytes_accessed); the CUDA kernels state neither, so this package "
    "publishes no series")
DEVICE_MEMORY = REGISTRY.gauge(
    "karpenter_device_memory_bytes",
    "Live per-device allocator stats from torch.cuda.memory_stats(), "
    "by device and stat (bytes_in_use/peak_bytes_in_use/bytes_limit/"
    "largest_alloc_size); the CPU publishes no series")
DEVICE_STAGING = REGISTRY.gauge(
    "karpenter_device_staging_bytes",
    "Host->device staging bytes of the most recent streamed solve, by "
    "stat (peak_block: largest single host transient; full: what one "
    "full-materialization copy would have allocated) — unified with "
    "stream.py's per-solve stats")
# SLO engine (metrics/slo.py): declarative SLIs over tick signals,
# multi-window burn-rate alerting
SLO_BURN_RATE = REGISTRY.gauge(
    "karpenter_slo_burn_rate",
    "Error-budget burn rate per SLO and window (short/long): "
    "bad_fraction / (1 - objective) over the window's ticks — 1.0 "
    "consumes the budget exactly at the sustainable rate")
SLO_OK = REGISTRY.gauge(
    "karpenter_slo_ok",
    "1 while the SLO's multiwindow verdict is ok, 0 while it is "
    "warn/page (both windows burning past the threshold)")
SLO_BUDGET_REMAINING = REGISTRY.gauge(
    "karpenter_slo_error_budget_remaining",
    "1 - long-window burn rate per SLO, floored at 0 — the fraction "
    "of the error budget left at the current long-window burn")
SLO_ALERTS = REGISTRY.counter(
    "karpenter_slo_alerts_total",
    "SLO alert-state transitions into warn/page, by slo and severity "
    "— transition-counted, so byte-identical replays count identically")
# regression sentinel (metrics/sentinel.py): EWMA+MAD baselines over
# per-phase solver durations and the tick wall
SENTINEL_ANOMALIES = REGISTRY.counter(
    "karpenter_sentinel_anomaly_total",
    "Samples the regression sentinel flagged as anomalous against the "
    "signal's own EWMA+MAD baseline (after warmup), by signal — a "
    "burst on one solve phase means the last change made that phase "
    "slower before any human reran bench")
SENTINEL_BASELINE = REGISTRY.gauge(
    "karpenter_sentinel_baseline",
    "The sentinel's rolling baseline per signal and stat (ewma / mad, "
    "in the signal's own units) — what the anomaly threshold is "
    "currently judged against")
# decision explainability plane (karpenter_tpu_torch/explain): structured
# "why" records per tick — verdicts tally once at record finish, so
# a candidate re-probed many times in one tick counts once
EXPLAIN_VERDICTS = REGISTRY.counter(
    "karpenter_explain_verdicts_total",
    "Disruption-candidate verdicts recorded by the explainability "
    "plane, by verdict (consolidated / interrupted / kept:<reason> — "
    "see README's verdict taxonomy table), tallied once per tick at "
    "record finish")
EXPLAIN_TRUNCATED = REGISTRY.counter(
    "karpenter_explain_truncated_total",
    "Explain entries dropped past the per-tick caps "
    "(KARPENTER_EXPLAIN_MAX_PODS / _MAX_NODES) — a bounded plane "
    "never drops silently")
POD_UNSCHEDULABLE_TICKS = REGISTRY.counter(
    "karpenter_pod_unschedulable_ticks",
    "Ticks a pod stayed unschedulable, by structured reason code "
    "(scheduler.reason_code) — the persistence signal the deduped "
    "FailedScheduling corev1 Event no longer repeats tick after tick")


class Store:
    """Diff-publishing gauge set per object (store.go:33-110): Update
    replaces the object's series, ReplaceAll drops stale objects."""

    def __init__(self, gauge: Gauge):
        self.gauge = gauge
        self._published: dict[str, list[dict[str, str]]] = {}

    def update(self, key: str, series: list[tuple[dict[str, str], float]]) -> None:
        for labels in self._published.get(key, []):
            self.gauge.delete(labels)
        out = []
        for labels, value in series:
            self.gauge.set(value, labels)
            out.append(labels)
        self._published[key] = out

    def delete(self, key: str) -> None:
        for labels in self._published.pop(key, []):
            self.gauge.delete(labels)

    def replace_all(self, series_by_key: dict[str, list[tuple[dict[str, str], float]]]) -> None:
        self.prune(set(series_by_key))
        for key, series in series_by_key.items():
            self.update(key, series)

    def prune(self, live_keys: set[str]) -> None:
        """Drop series for objects no longer live (the ReplaceAll
        half-step for controllers that Update incrementally)."""
        for stale in set(self._published) - live_keys:
            self.delete(stale)
