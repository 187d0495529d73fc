"""Operator options and feature gates.

Copy of `karpenter_tpu/operator/options.py`, whole (the rest of the
operator is not ported yet). The solver fields keep the JAX package's
names. The disruption engine reads the feature gates, the minValues
policy and the DRA flag.

Counterpart of pkg/operator/options/options.go:67-203: one flat config
struct (flags/env in the reference; kwargs here) plus feature gates
parsed from a comma string ("SpotToSpotConsolidation=true,...").
Defaults mirror the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FeatureGates:
    node_repair: bool = False
    reserved_capacity: bool = True
    spot_to_spot_consolidation: bool = False
    node_overlay: bool = False
    static_capacity: bool = False

    @classmethod
    def parse(cls, gates: str) -> "FeatureGates":
        out = cls()
        mapping = {
            "NodeRepair": "node_repair",
            "ReservedCapacity": "reserved_capacity",
            "SpotToSpotConsolidation": "spot_to_spot_consolidation",
            "NodeOverlay": "node_overlay",
            "StaticCapacity": "static_capacity",
        }
        for part in gates.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, value = part.partition("=")
            attr = mapping.get(name.strip())
            if attr is not None:
                setattr(out, attr, value.strip().lower() in ("true", "1", ""))
        return out


@dataclass
class Options:
    batch_idle_duration: float = 1.0       # options.go:126
    batch_max_duration: float = 10.0       # options.go:127
    preference_policy: str = "Respect"     # Respect | Ignore
    min_values_policy: str = "Strict"      # Strict | BestEffort
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    metrics_port: int = 8080
    health_probe_port: int = 8081
    # bind-all default so external scrapers / kubelet probes reach the
    # endpoints in a pod (the reference's metrics server behavior);
    # tests override to loopback or pass port=0
    metrics_bind_host: str = "0.0.0.0"
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    log_level: str = "info"
    cluster_name: str = ""
    disruption_poll_seconds: float = 10.0  # disruption/controller.go:69
    metrics_interval_seconds: float = 10.0  # object-gauge republish cadence
    # watch-driven controllers run O(changes) per tick; a periodic full
    # resync (the informer-resync analogue) backstops any in-place
    # mutation that escaped the event fabric
    full_resync_seconds: float = 30.0
    enable_profiling: bool = False         # operator.go:183-199 pprof gate
    # Pods consuming DRA ResourceClaims are rejected with a permanent
    # scheduling error while set (options.go:130 ignore-dra-requests;
    # default true upstream until formal DRA support lands)
    ignore_dra_requests: bool = True
    # the compile warm pool at operator startup (the JAX package's
    # solver/warm_pool.py; here building the kernel libraries ahead of
    # the first solve, ROADMAP item 7). Off by default.
    solver_warm_pool: bool = False
    # Solver resilience layer (solver/resilience.py). The env knobs
    # (KARPENTER_SOLVE_DEADLINE_MS etc.) stay authoritative — these
    # options export into the environment at operator startup when the
    # env doesn't already set them, so embedders configure resilience
    # the same way they configure everything else. 0 disables.
    solve_deadline_ms: int = 0      # hard per-solve wall budget
    compile_deadline_ms: int = 0    # separate budget for a kernel's build
    solve_hedge_ms: int = 0         # fire the host FFD hedge after this
    solver_faults: str = ""         # KARPENTER_FAULTS spec (chaos/bench)


DEFAULT_OPTIONS = Options()
