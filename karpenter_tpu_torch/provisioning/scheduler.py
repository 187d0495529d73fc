"""Scheduling orchestration: pods + cluster snapshot -> node plans.

Copy of `karpenter_tpu/provisioning/scheduler.py`, whole, with its
imports pointed into `karpenter_tpu_torch`. The one addition is the
device: `Scheduler(..., device=None)` hands every packing solve to
`solve_encoded(enc, device=...)`; `None` means the card, and without a
CUDA device the constructor raises as `solver.solve` does.

Counterpart of provisioning/scheduling/scheduler.go. The flow
(NewScheduler provisioner.go:235-301 + Solve scheduler.go:377):

1. ready NodePools ordered by weight; instance types per pool
2. existing + in-flight nodes from the state snapshot (existing first,
   in-flight sorted fewest-pods-first — scheduler.go:552 comment)
3. daemonset overhead per pool template (scheduler.go:772-803)
4. fast path: pods free of topology constraints go through the batched
   device solver in one shot (solver.solve)
5. slow path: topology-constrained pods run per-pod against the same
   dense encoding with Topology domain filtering, with the preference
   relaxation ladder (preferences.go:38-141) applied on failure
6. results: NodeClaimPlans (pool + price-ordered instance types,
   truncated to MAX_INSTANCE_TYPES honoring minValues), existing-node
   assignments, per-pod errors
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    CAPACITY_TYPE_SPOT,
    HOSTNAME_LABEL,
    NODEPOOL_LABEL,
    RESERVATION_ID_LABEL,
    SPOT_MAX_FRACTION_ANNOTATION,
    SPOT_MIN_ON_DEMAND_ANNOTATION,
    TOPOLOGY_ZONE_LABEL,
    WELL_KNOWN_LABELS,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    order_by_price,
    satisfies_min_values,
    truncate,
)
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics.store import (
    SCHEDULER_QUEUE_DEPTH,
    SCHEDULER_SCHEDULING_DURATION,
    SCHEDULER_UNFINISHED_WORK,
    SCHEDULER_UNSCHEDULABLE_PODS,
)
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage, pod_host_ports
from karpenter_tpu_torch.scheduling.volumeusage import VolumeUsage, pod_volume_drivers
from karpenter_tpu_torch.provisioning import volume_topology
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.taints import tolerates_pod
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch.solver import topo_batch
from karpenter_tpu_torch.solver.encode import (
    ExistingNodeInput,
    PodGroup,
    encode,
    group_pods,
)
from karpenter_tpu_torch.solver.solver import (
    NodePlan,
    Solution,
    _check_supported,
    resolve_device,
    solve_encoded,
)
from karpenter_tpu_torch.state.cluster import StateNode
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.provisioning.preferences import relax

log = logging.getLogger("karpenter.scheduler")

# scheduler knob (nodeclaimtemplate.go:41)
MAX_INSTANCE_TYPES = 600

# Solve wall-clock bound (provisioner.go:365-368): one minute, after
# which the round returns best-effort partial results and unplaced pods
# report a timeout error
SOLVE_TIMEOUT_SECONDS = 60.0

TIMEOUT_ERROR = "scheduling timed out; will retry next round"

# the batched fast path's capacity failure — the CANONICAL string:
# priority admission, the disruption priority veto, preemption, and
# the incremental tick's audit all match on it exactly, so every
# producer and consumer must import THIS constant
NO_CAPACITY_ERROR = "no compatible instance types or nodes"

# DRA pods are rejected permanently (no relaxation retry) while the
# ignore-dra-requests flag is on — scheduler.go:489-491, 448-452
DRA_ERROR = (
    "pod has Dynamic Resource Allocation requirements that are not yet "
    "supported"
)

# the relaxation ladder's terminal failure on the per-pod topology
# path — single-sourced like NO_CAPACITY_ERROR/LIMITS_ERROR: the exact string is the contract; consumers that need a
# machine-readable class go through reason_code() below
TOPOLOGY_INCOMPATIBLE_ERROR = (
    "incompatible with topology constraints or no capacity"
)

# minValues rejects are parametric ("minValues requirement not met:
# <detail>"); this prefix is their stable, matchable head
MIN_VALUES_ERROR_PREFIX = "minValues requirement not met"


def reason_code(error: str) -> str:
    """Structured reason code for one scheduler error string — the
    label the unschedulable-ticks counter and the explain plane carry
    so dashboards never regex free-form prose. Exact-string consumers
    (priority shedding, preemption, the disruption veto) keep matching
    the canonical constants; this is the classification layer on top."""
    if error == NO_CAPACITY_ERROR:
        return "no_capacity"
    if error == TOPOLOGY_INCOMPATIBLE_ERROR:
        return "topology_or_capacity"
    if error == TIMEOUT_ERROR:
        return "timeout"
    if error == DRA_ERROR:
        return "dra_unsupported"
    if error.startswith(MIN_VALUES_ERROR_PREFIX):
        return "min_values"
    # late imports: provisioning.priority imports THIS module for the
    # canonical capacity string, so its constants resolve lazily here
    from karpenter_tpu_torch.provisioning.priority import (
        LIMITS_ERROR,
        PRIORITY_SHED_ERROR,
    )

    if error == LIMITS_ERROR:
        return "limits"
    if error == PRIORITY_SHED_ERROR:
        return "priority_shed"
    return "other"


@dataclass
class SchedulerResults:
    new_node_plans: list[NodePlan]
    existing_assignments: dict[str, list[Pod]]      # state-node name -> pods
    errors: dict[str, str] = field(default_factory=dict)  # pod key -> reason
    # resilience ladder rungs (other than the primary) that served any
    # kernel call of this solve — empty on a healthy tick
    degraded_rungs: list[str] = field(default_factory=list)

    @property
    def scheduled_count(self) -> int:
        return sum(len(n.pods) for n in self.new_node_plans) + sum(
            len(p) for p in self.existing_assignments.values()
        )


def _state_node_key(node: StateNode) -> str:
    """Stable key for an existing-node assignment: the node name, or
    the claim name while the node has not materialized (an in-flight
    claim has no Node object yet; an empty key would collide every
    in-flight assignment onto one entry)."""
    if node.name:
        return node.name
    if node.node_claim is not None:
        return node.node_claim.metadata.name
    return ""


def _pool_requirements(pool: NodePool) -> Requirements:
    """The pool template's requirement set, minValues included."""
    from karpenter_tpu_torch.solver.encode import pool_template_requirements

    return pool_template_requirements(pool, with_labels=False)


def _strip_offerings(it: InstanceType, drop) -> InstanceType:
    """Instance type without the offerings `drop` matches (unchanged
    instance returned when nothing matched)."""
    kept = [o for o in it.offerings if not drop(o)]
    if len(kept) == len(it.offerings):
        return it
    from karpenter_tpu_torch.cloudprovider.types import Offerings

    return InstanceType(
        name=it.name,
        requirements=it.requirements,
        offerings=Offerings(kept),
        capacity=it.capacity,
        overhead=it.overhead,
    )


def _strip_reserved(it: InstanceType) -> InstanceType:
    """Instance type without its reserved-capacity offerings."""
    return _strip_offerings(it, lambda o: o.is_reserved())


def _strip_spot(it: InstanceType) -> InstanceType:
    """Instance type without its spot offerings (a pool whose spot
    budget is zero never encodes a spot column at all)."""
    return _strip_offerings(it, lambda o: o.is_spot())


# -- spot availability targets ------------------------------------------------
#
# Spot capacity is interruptible; a pool that lets EVERY node resolve
# to spot trades its whole availability on the interruption regime.
# Two per-pool knobs bound the exposure (KubePACS availability targets,
# PAPERS.md): a max fraction of the pool's nodes that may be spot, and
# an absolute floor of on-demand nodes. Fleet-wide env defaults; pool
# annotations override.

SPOT_MAX_FRACTION_ENV = "KARPENTER_SPOT_MAX_FRACTION"
SPOT_MIN_ON_DEMAND_ENV = "KARPENTER_SPOT_MIN_ON_DEMAND"


def pool_spot_budget(pool: NodePool) -> tuple[float, int]:
    """(max spot fraction in [0, 1], min non-spot node floor >= 0)
    for one pool — annotation over env default over (1.0, 0). The
    floor counts every non-interruptible node (on-demand AND
    reserved): it bounds exposure to the interruption regime, not the
    billing model."""

    def _knob(ann_key, env_key, default, cast, lo):
        # a malformed annotation falls back to the FLEET default (the
        # env knob), not straight to unbounded — a typo'd per-pool
        # override must not widen the pool's exposure past what the
        # operator configured fleet-wide
        for source, raw in (
            (ann_key, pool.metadata.annotations.get(ann_key)),
            (env_key, os.environ.get(env_key, "")),
        ):
            if not raw:
                continue
            try:
                return max(lo, cast(raw))
            except (TypeError, ValueError):
                log.warning("bad spot budget knob %s=%r; ignoring",
                            source, raw)
        return default

    frac = _knob(SPOT_MAX_FRACTION_ANNOTATION, SPOT_MAX_FRACTION_ENV,
                 1.0, float, 0.0)
    floor = _knob(SPOT_MIN_ON_DEMAND_ANNOTATION, SPOT_MIN_ON_DEMAND_ENV,
                  0, int, 0)
    return (min(frac, 1.0), floor)


def note_unschedulable_explanations(
    pods: Sequence[Pod],
    results: "SchedulerResults",
    pools_with_types,
    existing_inputs: Sequence[ExistingNodeInput],
    daemon_overhead: Optional[dict] = None,
    reserved_in_use: Optional[dict[str, int]] = None,
) -> None:
    """Record a verdict for every unschedulable pod — the error, its
    structured reason code, and (for capacity-class failures) the
    elimination funnel. Module-level: the full Scheduler and the
    incremental live tick explain through the same function, so the
    two paths' accounts cannot drift. Runs AFTER the solve, only over
    the failed set, with the funnel memoized per scheduling signature
    so a thousand identical starved pods pay one catalog walk."""
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.explain import funnel as funnel_mod

    if explain.active() is None or not results.errors:
        return
    by_key = {p.key: p for p in pods}
    funnel_cache: dict[tuple, dict] = {}
    for key, error in sorted(results.errors.items()):
        code = reason_code(error)
        explain.note_pod(key, verdict="unschedulable", error=error,
                         code=code)
        if code not in ("no_capacity", "topology_or_capacity"):
            continue
        pod = by_key.get(key)
        if pod is None:
            continue
        sig = (
            Requirements.from_pod(pod).signature(),
            tuple(sorted(pod.spec.tolerations, key=repr)),
            tuple(sorted(resutil.pod_requests(pod).items())),
        )
        funnel = funnel_cache.get(sig)
        if funnel is None:
            funnel = funnel_mod.compute(
                pod, pools_with_types, existing_inputs,
                daemon_overhead, reserved_in_use,
            )
            funnel_cache[sig] = funnel
        explain.note_funnel(key, funnel)


class NodeInputBuilder:
    """Shared builder of solver inputs from cluster state: existing/
    in-flight node inputs and daemonset overhead/reservations.

    Extracted from Scheduler so the provisioner's incremental live
    tick (provisioning/incremental_tick.py) derives its RETAINED
    per-node inputs through the exact same code path the full
    Scheduler uses per round — the two paths cannot drift, which is
    what makes the incremental-vs-full oracle audit a meaningful
    equality check instead of a tolerance band."""

    def __init__(
        self,
        pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
        daemonsets: Sequence = (),
        ignore_dra_requests: bool = True,
    ):
        self.pools_with_types = list(pools_with_types)
        self.daemonsets = list(daemonsets)
        self.ignore_dra_requests = ignore_dra_requests
        # per-node daemon reservation, memoized: invariant within a
        # scheduling round, but existing_input re-runs per committed
        # pod on the slow path. The live tick invalidates per key when
        # a node's watch events mark it dirty.
        self._daemon_reserve_cache: dict[str, dict[str, float]] = {}

    def invalidate(self, key: str) -> None:
        """Drop one node's memoized daemon reservation (the node's
        taints/labels/daemon pods changed)."""
        self._daemon_reserve_cache.pop(key, None)

    def existing_input(self, node: StateNode) -> ExistingNodeInput:
        reqs = Requirements.from_labels(node.labels())
        if node.node_claim is not None and not node.registered():
            for spec in node.node_claim.spec.requirements:
                reqs.add(Requirement(spec.key, spec.operator, spec.values,
                                     spec.min_values))
        available = resutil.positive(node.available())
        claim = node.node_claim
        if (
            node.node is None
            and claim is not None
            and not claim.status.allocatable
        ):
            # no REAL allocatable yet = the provider hasn't launched
            # (creation stamps only the plan's expected capacity); a
            # launched-but-full node has allocatable set and correctly
            # reports empty `available` above.
            # A claim created but not yet LAUNCHED has no
            # status.capacity: model it from its admissible instance
            # types like the reference's in-flight NodeClaim scheduling
            # nodes (scheduler.go builds them from instanceTypeOptions)
            # — otherwise pods freed by a disruption command can't land
            # on the command's own replacement and the provisioner buys
            # duplicate capacity (suite_test.go:454). The MINIMUM
            # allocatable across admissible types is conservative:
            # whatever type the launch resolves can hold what we place.
            # (Gated on the claim being truly unlaunched — a launched,
            # full node legitimately has empty `available`.)
            available = resutil.positive(
                resutil.subtract(
                    self._min_admissible_allocatable(node, reqs), node.used()
                )
            )
        reserve = self.daemon_reserve(node)
        if reserve:
            available = resutil.positive(
                resutil.subtract(available, reserve)
            )
        return ExistingNodeInput(
            name=_state_node_key(node),
            requirements=reqs,
            taints=tuple(node.taints()),
            available=available,
            pool_name=node.nodepool_name(),
            pod_count=len(node.pod_keys),
        )

    def _min_admissible_allocatable(
        self, node: StateNode, reqs: Requirements
    ) -> ResourceList:
        """Component-wise minimum allocatable over the pool's instance
        types compatible with `reqs` (the caller's labels+claim
        requirements) — the floor of what the launch can
        materialize."""
        floor: ResourceList = {}
        for pool, types in self.pools_with_types:
            if pool.metadata.name != node.nodepool_name():
                continue
            for it in types:
                if it.requirements.intersects(reqs) is not None:
                    continue
                alloc = it.allocatable
                if not floor:
                    floor = dict(alloc)
                else:
                    floor = {
                        k: min(v, alloc.get(k, 0.0))
                        for k, v in floor.items()
                    }
        return floor

    def _daemon_expected(
        self, node_reqs: Requirements, taints: list
    ) -> dict[str, float]:
        """Total requests of daemonsets whose pods can land on a node
        with these taints/labels (isDaemonPodCompatibleWithNode,
        scheduler.go:708-717) — the one filter shared by new-node
        overhead budgeting and existing-node reservation."""
        from karpenter_tpu_torch.utils.pod import has_dra_requirements

        expected: dict[str, float] = {}
        for ds in self.daemonsets:
            pod = Pod(spec=ds.spec.template.spec)
            pod.metadata.labels = dict(ds.spec.template.metadata.labels)
            # a DRA daemon pod can never be scheduled by us, so its
            # requests must not inflate any budget
            # (shouldSkipDaemonPod, scheduler.go:702-705)
            if self.ignore_dra_requests and has_dra_requirements(pod):
                continue
            if tolerates_pod(taints, pod) is not None:
                continue
            if not self._daemon_compatible(node_reqs, pod):
                continue
            expected = resutil.merge(expected, resutil.pod_requests(pod))
        return expected

    def _daemon_compatible(self, node_reqs: Requirements, pod: Pod) -> bool:
        """Daemon-pod schedulability against a node/template: required
        node-affinity terms are ORed — ANY matching term admits the
        pod (the kube-scheduler semantic the reference's per-term check
        follows) — and hostname affinity is dropped first: a daemonset
        pinned to an EXISTING node's hostname says nothing about new
        capacity (suite_test.go "remove daemonset node hostname
        affinity when considering daemonset schedulability")."""
        base = Requirements.from_labels(dict(pod.spec.node_selector))
        if pod.spec.injected_requirements:
            base.add(*pod.spec.injected_requirements)
        aff = pod.spec.affinity
        terms = ()
        if aff is not None and aff.node_affinity is not None:
            terms = aff.node_affinity.required or ()
        if not terms:
            return node_reqs.is_compatible(
                base, allow_undefined=WELL_KNOWN_LABELS
            )
        for term in terms:
            reqs = Requirements(r.copy() for r in base)
            reqs.add(*(
                r
                for r in Requirements.from_node_selector_requirements(
                    term.match_expressions
                ).values()
                if r.key != HOSTNAME_LABEL
            ))
            if node_reqs.is_compatible(
                reqs, allow_undefined=WELL_KNOWN_LABELS
            ):
                return True
        return False

    def daemon_reserve(self, node: StateNode) -> dict[str, float]:
        """Capacity still owed to daemonsets on this node: the
        requests of every daemonset whose pods CAN land here, minus
        daemon pods already bound, floored at zero (unexpected daemon
        pods must not push the reservation negative) —
        existingnode.go:41-52, scheduler.go isDaemonPodCompatibleWithNode.
        """
        if not self.daemonsets or not node.managed():
            return {}
        cache_key = _state_node_key(node)
        cached = self._daemon_reserve_cache.get(cache_key)
        if cached is not None:
            return cached
        expected = self._daemon_expected(
            Requirements.from_labels(node.labels()), list(node.taints())
        )
        # net of daemon pods already bound to the node — cluster state
        # tracks these (terminal pods excluded) so the reservation is
        # not re-derived from the raw pod list
        reserve = (
            resutil.positive(resutil.subtract(expected, node.daemon_usage))
            if expected
            else {}
        )
        self._daemon_reserve_cache[cache_key] = reserve
        return reserve

    def daemon_overhead(self) -> dict[str, dict[str, float]]:
        """Per-pool daemonset resource overhead (scheduler.go:772-803):
        sum requests of daemon pods whose scheduling terms admit the
        pool template. Uses the same full-compatibility filter
        (undefined-key rules included) as the existing-node
        reservation, via _daemon_expected."""
        from karpenter_tpu_torch.solver.encode import pool_template_requirements

        out: dict[str, dict[str, float]] = {}
        for pool, types in self.pools_with_types:
            total = self._daemon_expected(
                pool_template_requirements(pool, with_pool_pin=True),
                list(pool.spec.template.spec.taints),
            )
            if total:
                out[pool.metadata.name] = total
        return out


def plan_domains(plan: NodePlan) -> dict[str, str]:
    """Representative domains for a planned node. Module-level: the
    full Scheduler and the incremental live tick derive a planned
    node's topology contribution through the same function."""
    out: dict[str, str] = {}
    if plan.offerings:
        out[TOPOLOGY_ZONE_LABEL] = plan.offerings[0].zone
        out[CAPACITY_TYPE_LABEL] = plan.offerings[0].capacity_type
    out[HOSTNAME_LABEL] = f"planned-{id(plan)}"
    out[NODEPOOL_LABEL] = plan.pool.metadata.name
    return out


def plan_pseudo_input(
    plan: NodePlan, daemon_overhead: dict
) -> Optional[ExistingNodeInput]:
    """An open plan as a pseudo-existing node for the lowered topology
    solve — the in-flight NodeClaim model (scheduling/nodeclaim.go:
    114-167): remaining capacity is the cheapest instance-type option
    that still holds the plan's current pods. Module-level so the
    incremental live tick's topology phase builds the exact same
    pseudo rows the full Scheduler does."""
    used = resutil.merge(
        daemon_overhead.get(plan.pool.metadata.name, {}),
        resutil.requests_for_pods(plan.pods),
    )
    for it in plan.instance_types:  # price-ordered
        if resutil.fits(used, it.allocatable):
            avail = resutil.positive(resutil.subtract(it.allocatable, used))
            break
    else:
        return None
    labels = plan_domains(plan)
    reqs = Requirements.from_labels(labels)
    for key, value in plan.pool.spec.template.labels.items():
        reqs.add(Requirement(key, IN, [value]))
    # permanent taints only: startupTaints clear before pods run, so
    # they never gate placement onto the planned node (same rule as
    # build_configs / statenode.go:322-326)
    taints = tuple(plan.pool.spec.template.spec.taints)
    return ExistingNodeInput(
        name=f"planned-{id(plan)}",
        requirements=reqs,
        taints=taints,
        available=avail,
        pool_name=plan.pool.metadata.name,
        pod_count=len(plan.pods),
    )


def finalize_plan(plan: NodePlan) -> None:
    """Price-order and truncate instance types, honoring the pool's
    minValues floors (results.TruncateInstanceTypes,
    provisioner.go:374; types.go:322-334). Module-level: the full
    Scheduler and the incremental live tick finalize through the same
    function."""
    pool_reqs = _pool_requirements(plan.pool)
    try:
        plan.instance_types = truncate(
            plan.instance_types, pool_reqs, MAX_INSTANCE_TYPES
        )
    except ValueError:
        # truncation cannot keep the minValues floor —
        # _enforce_min_values decides reject (Strict) vs relax
        plan.instance_types = truncate(
            plan.instance_types, Requirements(), MAX_INSTANCE_TYPES
        )


class Scheduler:
    def __init__(
        self,
        pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
        state_nodes: Sequence[StateNode] = (),
        daemonsets: Sequence = (),
        cluster_pods: Sequence[Pod] = (),
        honor_preferences: bool = True,
        allow_reserved: bool = True,
        min_values_policy: str = "Strict",
        kube=None,
        clock=None,
        solve_timeout: float = SOLVE_TIMEOUT_SECONDS,
        ignore_dra_requests: bool = True,
        metrics_controller: str = "provisioner",
        objective: str = "ffd",
        compat_cache=None,
        existing_input_cache: Optional[dict[str, ExistingNodeInput]] = None,
        device=None,
    ):
        # the device every packing solve of this scheduler runs on:
        # None is the card (raising without one), as in solver.solve;
        # the host backend runs no device
        self.device = (
            resolve_device(device)
            if _check_supported(objective, None) == "device" else None
        )
        # "cost" engages the LP planner on the batched fast path (the
        # global-repack consolidation re-solve); topology/per-pod paths
        # always pack FFD — their constraints aren't in the LP
        self.objective = objective
        # incremental.EncodedCache shared across rounds by the owning
        # provisioner: steady-state rounds re-encode only the group
        # signatures that actually changed (dirty rows)
        self.compat_cache = compat_cache
        self.min_values_policy = min_values_policy
        self.ignore_dra_requests = ignore_dra_requests
        self.metrics_controller = metrics_controller
        self._solve_start = 0.0
        self._last_progress_publish = 0.0
        self.kube = kube
        import time as _time

        self.clock = clock if clock is not None else _time.monotonic
        self.solve_timeout = solve_timeout
        self._deadline: Optional[float] = None
        if not allow_reserved:
            # ReservedCapacity gate off: reserved offerings never enter
            # the solve (options.go feature gates)
            pools_with_types = [
                (pool, [_strip_reserved(it) for it in types])
                for pool, types in pools_with_types
            ]
        # a zero spot budget is enforced INSIDE the encoded offering
        # matrices: the pool's spot offerings never become config
        # columns, so neither pack_split nor the per-pod path can pick
        # one (fractional budgets pin plans post-solve instead — the
        # node count a fraction applies to is unknown until decode)
        pools_with_types = [
            (
                pool,
                [_strip_spot(it) for it in types]
                if pool_spot_budget(pool)[0] <= 0.0 else types,
            )
            for pool, types in pools_with_types
        ]
        # weight order (provisioner.go:241-262)
        self.pools_with_types = sorted(
            pools_with_types, key=lambda pt: (-pt[0].spec.weight, pt[0].metadata.name)
        )
        if self.min_values_policy != "BestEffort":
            # Strict: a pool whose full catalog cannot satisfy its own
            # minValues can never launch a valid claim — drop it up
            # front so pods fall through to the next weighted pool
            # (upstream filters minValues-incompatible options per
            # nodepool during scheduling, types.go:284-318)
            kept = []
            for pool, types in self.pools_with_types:
                pool_reqs = _pool_requirements(pool)
                if pool_reqs.has_min_values():
                    # count only types the pool's own requirements admit
                    # — raw-catalog counting would let an unsatisfiable
                    # pool survive on incompatible types
                    compatible = [
                        it for it in types
                        if pool_reqs.intersects(it.requirements) is None
                    ]
                    _, err = satisfies_min_values(compatible, pool_reqs)
                    if err is not None:
                        continue
                kept.append((pool, types))
            self.pools_with_types = kept
        self.honor_preferences = honor_preferences
        self.daemonsets = list(daemonsets)
        self.cluster_pods = list(cluster_pods)

        # existing-node input + daemon machinery shared with the
        # incremental live tick (see NodeInputBuilder)
        self.input_builder = NodeInputBuilder(
            self.pools_with_types, self.daemonsets, self.ignore_dra_requests
        )

        # existing first, then in-flight fewest-pods-first (scheduler.go:552)
        live = [n for n in state_nodes if not n.deleting() and n.initialized()]
        inflight = [n for n in state_nodes if not n.deleting() and not n.initialized()]
        inflight.sort(key=lambda n: (len(n.pod_keys), n.name))
        self.state_nodes = live + inflight
        # `existing_input_cache` (state/retained.RetainedFleetSeam):
        # retained, dirty-tracked ExistingNodeInput rows keyed by
        # _state_node_key — a cached row is exactly what
        # _existing_input would build (the seam only retains rows for
        # stable launched nodes and rebuilds on watch dirt), so a hit
        # skips the per-node label/reserve derivation. Commits during
        # the solve refresh the LOCAL list only; the shared cache dict
        # is never mutated here.
        if existing_input_cache:
            self.existing_inputs = [
                existing_input_cache.get(_state_node_key(n))
                or self._existing_input(n)
                for n in self.state_nodes
            ]
        else:
            self.existing_inputs = [
                self._existing_input(n) for n in self.state_nodes
            ]

        # live reservation usage: nodes (incl. deleting — the instance
        # is held until gone) already launched against a reservation id
        # reduce how many more the solver may open
        # (scheduling/reservationmanager.go:28-110)
        self.reserved_in_use: dict[str, int] = {}
        for node in state_nodes:
            rid = node.labels().get(RESERVATION_ID_LABEL, "")
            if not rid and node.node_claim is not None:
                # a pinned claim that hasn't launched yet carries the
                # reservation only in its spec requirements — it must
                # still consume budget or back-to-back solves
                # overcommit the reservation
                for spec in node.node_claim.spec.requirements:
                    if spec.key == RESERVATION_ID_LABEL and spec.values:
                        rid = spec.values[0]
                        break
            if rid:
                self.reserved_in_use[rid] = self.reserved_in_use.get(rid, 0) + 1

        # total instances per reservation id (for per-pod path budget
        # checks; the batched path enforces the same budget in-kernel)
        self._rsv_capacity: dict[str, int] = {}
        for _, types in self.pools_with_types:
            for it in types:
                for o in it.offerings:
                    if o.is_reserved():
                        self._rsv_capacity[o.reservation_id] = max(
                            self._rsv_capacity.get(o.reservation_id, 0),
                            o.reservation_capacity,
                        )

        self.daemon_overhead = self.input_builder.daemon_overhead()
        self.topology = self._build_topology()

        # per-node host-port reservations from live pods
        # (hostportusage.go; consumed by the per-pod path)
        self._host_ports: dict[str, HostPortUsage] = {}
        for pod in self.cluster_pods:
            if pod.spec.node_name and pod_host_ports(pod):
                self._host_ports.setdefault(
                    pod.spec.node_name, HostPortUsage()
                ).add(pod)

        # per-node CSI volume-limit accounting (volumeusage.go;
        # existingnode.go:29-140): limits come from CSINode objects,
        # usage is seeded from live pods' PVC volumes
        self._volume_usage: dict[str, VolumeUsage] = {}
        if self.kube is not None:
            for csi in self.kube.csi_nodes():
                if csi.volume_limits:
                    self._volume_usage[csi.metadata.name] = VolumeUsage(
                        limits=csi.volume_limits
                    )
            if self._volume_usage:
                for pod in self.cluster_pods:
                    usage = self._volume_usage.get(pod.spec.node_name)
                    if usage is not None and pod.spec.volumes:
                        usage.add(pod, self.kube)

    # -- construction helpers -------------------------------------------------

    def _existing_input(self, node: StateNode) -> ExistingNodeInput:
        return self.input_builder.existing_input(node)

    def _note_gap(self, solution: Solution) -> None:
        """Feed the SLO engine's optimality SLI (metrics/slo.py) from
        the PROVISIONING fleet solve only: disruption simulations'
        candidate-subset solves carry gaps vs their own restricted LP
        estimates (routinely large on tiny sub-problems) that say
        nothing about fleet optimality, so they must not note."""
        if self.metrics_controller != "provisioner":
            return
        lp = solution.lp
        est = lp.get("estimate") if lp else None
        if est:
            from karpenter_tpu_torch.metrics import slo

            slo.note("gap_vs_lp", solution.total_price / est - 1.0)

    # -- decision explainability (karpenter_tpu_torch/explain) ----------------------

    def _explaining(self) -> bool:
        """True only for the LIVE provisioning solve with an explain
        record open: disruption simulations solve restricted
        sub-problems whose 'errors' are probe verdicts, not scheduling
        verdicts — they must not pollute pod explanations (the same
        controller gate the SLO optimality feed uses)."""
        if self.metrics_controller != "provisioner":
            return False
        from karpenter_tpu_torch import explain

        return explain.active() is not None

    def _note_relax(self, pod: Pod, step: str) -> None:
        if self._explaining():
            from karpenter_tpu_torch import explain

            explain.note_relax(pod.key, step)

    def _note_explanations(
        self, pods: Sequence[Pod], results: SchedulerResults
    ) -> None:
        if not results.errors or not self._explaining():
            return
        note_unschedulable_explanations(
            pods, results, self.pools_with_types, self.existing_inputs,
            self.daemon_overhead, self.reserved_in_use,
        )

    def _accept_solution(
        self, solution: Solution, open_plans: list, results: SchedulerResults,
        round_in_use: dict[str, int],
    ) -> None:
        """Fold a batched Solution into the round's results: accept
        new plans and commit existing-node assignments (keyed via
        _state_node_key so in-flight nodes key by claim name)."""
        self._accept_plans(
            solution.new_nodes, open_plans, results, round_in_use
        )
        for a in solution.existing:
            node = self.state_nodes[a.existing_index]
            results.existing_assignments.setdefault(
                _state_node_key(node), []
            ).extend(a.pods)
            for p in a.pods:
                self._commit_existing(a.existing_index, p)

    def _build_topology(self) -> Topology:
        # Domain discovery honors the POOL's own requirements
        # (topology.go:105-146): a pool restricted to two zones
        # contributes only those two as spread domains — otherwise the
        # skew floor counts zones no node could ever open in and
        # DoNotSchedule wedges.
        from karpenter_tpu_torch.solver.encode import pool_template_requirements

        domains: dict[str, set[str]] = {}
        # per-domain taint provenance: one taint tuple per SOURCE
        # (pool template or live node) contributing the domain —
        # consumed by nodeTaintsPolicy=Honor spread constraints
        domain_taints: dict[str, dict[str, list]] = {}

        def record(key: str, value: str, taints) -> None:
            domains.setdefault(key, set()).add(value)
            domain_taints.setdefault(key, {}).setdefault(value, []).append(
                tuple(taints)
            )

        for pool, types in self.pools_with_types:
            pool_reqs = pool_template_requirements(pool)
            pool_taints = tuple(pool.spec.template.spec.taints)
            for it in types:
                for key in (TOPOLOGY_ZONE_LABEL, CAPACITY_TYPE_LABEL):
                    req = it.requirements.get(key)
                    if req.operator() == IN:
                        gate = pool_reqs.get(key)
                        for v in req.values:
                            if gate.has(v):
                                record(key, v, pool_taints)
        pod_domains: dict[str, dict[str, str]] = {}
        for node in self.state_nodes:
            labels = node.labels()
            node_taints = tuple(node.taints())
            for key, value in labels.items():
                record(key, value, node_taints)
            if node.name:
                record(HOSTNAME_LABEL, node.name, node_taints)
            for pod_key in node.pod_keys:
                mapping = {k: v for k, v in labels.items()}
                mapping[HOSTNAME_LABEL] = node.name
                pod_domains[pod_key] = mapping
        scheduled = [p for p in self.cluster_pods if p.spec.node_name]
        return Topology(domains=domains, cluster_pods=scheduled, pending_pods=[],
                        pod_domains=pod_domains,
                        honor_schedule_anyway=self.honor_preferences,
                        domain_taints=domain_taints)

    # -- solve ----------------------------------------------------------------

    def _timed_out(self) -> bool:
        if self._deadline is None:
            return False
        now = self.clock()
        # progress gauge for the in-flight solve (unfinished_work_
        # seconds), published at most once a second — this predicate
        # runs once per pod on the slow path and must stay a cheap
        # comparison
        if now - self._last_progress_publish >= 1.0:
            self._last_progress_publish = now
            self._publish_progress(now=now)
        return now > self._deadline

    def solve(self, pods: Sequence[Pod]) -> SchedulerResults:
        # scheduler-subsystem metrics wrap the whole solve, labeled by
        # controller so disruption SIMULATIONS never stomp the
        # provisioner's series (provisioning/scheduling/metrics.go:33-95
        # uses the same ControllerLabel disambiguation)
        labels = {"controller": self.metrics_controller}
        self._solve_start = self.clock()
        self._last_progress_publish = self._solve_start
        SCHEDULER_UNFINISHED_WORK.set(0.0, labels)
        results: Optional[SchedulerResults] = None
        from karpenter_tpu_torch import tracing
        from karpenter_tpu_torch.solver import resilience

        resilience.pop_degraded()  # scope the report to THIS solve
        try:
            with tracing.span(
                "scheduler.solve",
                controller=self.metrics_controller, pods=len(pods),
            ) as tsp:
                results = self._solve(pods)
                tsp.annotate(errors=len(results.errors))
            self._note_explanations(pods, results)
            return results
        finally:
            degraded = resilience.pop_degraded()
            if degraded:
                # the tick still decided — but through fallback rungs;
                # say so once per solve, not once per kernel call
                log.warning(
                    "%s solve served degraded via rung(s) %s "
                    "(see karpenter_solver_ladder_total)",
                    self.metrics_controller, sorted(set(degraded)),
                )
                if results is not None:
                    results.degraded_rungs = sorted(set(degraded))
            SCHEDULER_QUEUE_DEPTH.set(0.0, labels)
            SCHEDULER_UNFINISHED_WORK.set(0.0, labels)
            SCHEDULER_SCHEDULING_DURATION.observe(
                self.clock() - self._solve_start, labels
            )
            if results is not None:
                SCHEDULER_UNSCHEDULABLE_PODS.set(
                    float(len(results.errors)), labels
                )
            else:
                # the solve died: drop the series rather than leave a
                # count from a different run next to a fresh duration
                SCHEDULER_UNSCHEDULABLE_PODS.delete(labels)

    def _solve(self, pods: Sequence[Pod]) -> SchedulerResults:
        # best-effort wall-clock bound for the whole round
        # (provisioner.go:365-368); work completed before the deadline
        # is kept, pods not yet placed report TIMEOUT_ERROR
        self._deadline = self.clock() + self.solve_timeout
        if self.kube is not None:
            # PriorityClass resolution at every solve entry (the
            # volume-topology pattern): provisioning and disruption
            # simulations group pods by the same resolved priorities
            # no matter which caller stamped the pods last
            from karpenter_tpu_torch.scheduling.priority import (
                resolve_pod_priorities,
            )

            resolve_pod_priorities(list(pods), self.kube)
        dra_rejected: list[Pod] = []
        if self.ignore_dra_requests:
            # DRA gate (scheduler.go:489-491): device allocation can't
            # be simulated, so these pods get a permanent error up
            # front — they never enter the solve and never relax
            from karpenter_tpu_torch.utils.pod import has_dra_requirements

            kept = []
            for pod in pods:
                (dra_rejected if has_dra_requirements(pod) else kept).append(pod)
            pods = kept
        if self.kube is not None:
            # PVC zonal requirements re-derived HERE, at every solve
            # entry (provisioning and disruption simulation alike), so
            # results never depend on which caller stamped the shared
            # pod object last (volumetopology.go:51-160)
            for pod in pods:
                if pod.spec.volumes or pod.spec.injected_requirements:
                    volume_topology.inject(pod, self.kube)
        topology_full = Topology(
            domains=self.topology.domains,
            cluster_pods=[p for p in self.cluster_pods if p.spec.node_name],
            pending_pods=list(pods),
            pod_domains=self._pod_domains(),
            honor_schedule_anyway=self.honor_preferences,
            domain_taints=self.topology.domain_taints,
        )
        simple: list[Pod] = []
        complex_: list[Pod] = []
        volume_limited: list[Pod] = []
        limited_drivers = {
            d for usage in self._volume_usage.values() for d in usage.limits
        }
        for pod in pods:
            # CSI attach limits are per unique volume per node — only
            # the per-pod path tracks them (the reference enforces
            # them on existing nodes only, existingnode.go:29-140);
            # route per-pod only when the pod's drivers are actually
            # limited somewhere
            if (
                limited_drivers
                and pod.spec.volumes
                and limited_drivers & pod_volume_drivers(pod, self.kube).keys()
            ):
                volume_limited.append(pod)
            elif topology_full.has_constraints(pod) or pod_host_ports(pod):
                complex_.append(pod)
            else:
                simple.append(pod)

        results = SchedulerResults(new_node_plans=[], existing_assignments={})
        for pod in dra_rejected:
            results.errors[pod.key] = DRA_ERROR
        # queue depth counts pods actually entering the solve (gated
        # pods never wait); drained at phase boundaries
        self._publish_progress(
            len(simple) + len(complex_) + len(volume_limited)
        )

        # reservation budget for THIS round: live usage plus every plan
        # opened during the round, batched or per-pod, so later
        # placements (retries, complex pods) never re-grant budget a
        # sibling plan already consumed (reservationmanager.go debits
        # across all in-flight nodeclaims of one scheduling run)
        round_in_use: dict[str, int] = dict(self.reserved_in_use)

        # fast path: one batched solve on device
        open_plans: list[NodePlan] = []
        if simple:
            solution = self._batched_solve(simple, reserved_in_use=round_in_use)
            self._note_gap(solution)
            self._accept_solution(solution, open_plans, results, round_in_use)

            # k-way-evicted pods are schedulable alone: re-solve them
            # in BATCHES (same-group pods stay co-placed) until none
            # remain — every pass admits at least its first group, so
            # the loop shrinks; kernel-infeasible stragglers fall
            # through to the relaxation ladder below
            evicted_keys = {p.key for p in solution.evicted}
            evicted = list(solution.evicted)
            still_failed: list[Pod] = []
            rounds = 0
            while evicted and rounds < 16 and not self._timed_out():
                retry = self._batched_solve(
                    evicted, reserved_in_use=round_in_use
                )
                self._accept_solution(
                    retry, open_plans, results, round_in_use
                )
                re_evicted = {p.key for p in retry.evicted}
                still_failed.extend(
                    p for p in retry.unschedulable
                    if p.key not in re_evicted
                )
                evicted = list(retry.evicted)
                rounds += 1
            still_failed.extend(evicted)  # bound hit / timed out

            pending = [
                p for p in solution.unschedulable
                if p.key not in evicted_keys
            ] + still_failed
            # the fast path drained: what's left is the retry backlog
            # plus the slower paths
            self._publish_progress(
                len(pending) + len(complex_) + len(volume_limited)
            )
            for pod in pending:
                retried = False
                if self._timed_out():
                    results.errors[pod.key] = TIMEOUT_ERROR
                    continue
                if self.honor_preferences:
                    relaxed = relax(pod)
                    if relaxed:
                        self._note_relax(pod, relaxed)
                        retry = self._batched_solve(
                            [pod], required_only=True,
                            reserved_in_use=round_in_use,
                        )
                        if not retry.unschedulable:
                            self._accept_solution(
                                retry, open_plans, results, round_in_use
                            )
                            retried = True
                            if self._explaining():
                                from karpenter_tpu_torch import explain

                                explain.note_pod(
                                    pod.key, verdict="scheduled-after-relax",
                                    relax_unlocked=relaxed,
                                )
                if not retried:
                    results.errors[pod.key] = NO_CAPACITY_ERROR
            for plan in open_plans:
                for pod in plan.pods:
                    topology_full.register(
                        pod, self._plan_domains(plan),
                        source_taints=tuple(plan.pool.spec.template.spec.taints),
                    )

        # topology path: lower spread/affinity/ports to solver-native
        # form (domain pins + per-node caps + group conflicts) and run
        # ONE batched device solve; only what the lowering cannot
        # express falls back to the per-pod loop (solver/topo_batch.py)
        deferred: list[Pod] = []
        if complex_ and self._timed_out():
            for pod in complex_:
                results.errors[pod.key] = TIMEOUT_ERROR
            complex_ = []
        if complex_:
            # open fast-path plans join the solve as pseudo-existing
            # nodes (in-flight NodeClaim model) so constrained pods can
            # share them instead of opening fresh capacity
            plan_refs: list[NodePlan] = []
            plan_inputs: list[ExistingNodeInput] = []
            for plan in open_plans:
                inp = self._plan_input(plan)
                if inp is not None:
                    plan_refs.append(plan)
                    plan_inputs.append(inp)
            existing_all = list(self.existing_inputs) + plan_inputs
            tb = topo_batch.prepare(
                complex_, topology_full, existing_all, self._host_ports
            )
            results.errors.update(tb.errors)
            deferred = list(tb.fallback)
            if tb.groups:
                enc = encode(
                    tb.groups,
                    self.pools_with_types,
                    existing_all,
                    self.daemon_overhead,
                    reserved_in_use=round_in_use,
                    group_cap=tb.group_cap,
                    conflict=tb.conflict,
                    existing_quota=tb.existing_quota,
                    compat_cache=self.compat_cache,
                )
                solution = solve_encoded(enc, device=self.device)
                n_before = len(open_plans)
                self._accept_plans(
                    solution.new_nodes, open_plans, results, round_in_use
                )
                E = len(self.existing_inputs)
                for a in solution.existing:
                    inp = existing_all[a.existing_index]
                    if a.existing_index >= E:
                        # pods joined an open fast-path plan: narrow its
                        # options to types that hold the enlarged pod
                        # set and admit the new pods' requirements (the
                        # in-flight NodeClaim re-filter,
                        # nodeclaim.go:373-447)
                        plan = plan_refs[a.existing_index - E]
                        used = resutil.merge(
                            self.daemon_overhead.get(plan.pool.metadata.name, {}),
                            resutil.requests_for_pods(plan.pods + a.pods),
                        )
                        joined_reqs = [Requirements.from_pod(p) for p in a.pods]
                        fitting = [
                            it for it in plan.instance_types
                            if resutil.fits(used, it.allocatable)
                            and all(
                                it.requirements.intersects(r) is None
                                for r in joined_reqs
                            )
                        ]
                        if not fitting:
                            deferred.extend(a.pods)
                            continue
                        plan.instance_types = fitting
                        plan.offerings = [
                            o for o in plan.offerings
                            if any(it.offerings and o in it.offerings for it in fitting)
                        ] or plan.offerings
                        plan.pods.extend(a.pods)
                        domains = self._plan_domains(plan)
                        for p in a.pods:
                            self._register_topo_pod(
                                p, domains, inp.name, tb, topology_full
                            )
                        continue
                    node = self.state_nodes[a.existing_index]
                    results.existing_assignments.setdefault(
                        inp.name, []
                    ).extend(a.pods)
                    labels = dict(node.labels())
                    labels[HOSTNAME_LABEL] = inp.name
                    for p in a.pods:
                        self._commit_existing(a.existing_index, p)
                        self._register_topo_pod(p, labels, inp.name, tb, topology_full)
                for plan in open_plans[n_before:]:
                    domains = self._plan_domains(plan)
                    for p in plan.pods:
                        self._register_topo_pod(
                            p, domains, f"planned-{id(plan)}", tb, topology_full
                        )
                deferred.extend(solution.unschedulable)

        # slow path: per-pod with topology + volume-limit filtering
        deferred.extend(volume_limited)
        self._publish_progress(len(deferred))
        if deferred:
            self._solve_complex(
                deferred, open_plans, topology_full, results, round_in_use
            )

        for plan in open_plans:
            self._finalize_plan(plan)
            if not self._enforce_min_values(plan, results):
                continue
            results.new_node_plans.append(plan)
        self._enforce_spot_budget(results.new_node_plans)
        return results

    def _enforce_spot_budget(self, plans: list[NodePlan]) -> None:
        """Per-pool spot availability targets over the WHOLE round's
        plans plus the live fleet: with a max-spot-fraction cap or a
        min-on-demand floor configured, plans that would resolve to a
        spot launch (their cheapest surviving offering is spot) are
        pinned off spot — spot offerings dropped, so the claim's
        capacity-type requirement and the provider's launch resolve to
        the cheapest surviving non-spot offering (on-demand, or
        reserved where one applies) — until the targets hold. Plans whose pods REQUIRE spot (no
        on-demand offering survived the solve) can never be pinned;
        they consume the budget first and any residual violation is
        logged. Later-opened plans pin first (deterministic, and the
        earlier plans carry the round's first-placed pods)."""
        from karpenter_tpu_torch.metrics.store import SPOT_BUDGET_PINNED

        by_pool: dict[str, list[NodePlan]] = {}
        for plan in plans:
            by_pool.setdefault(plan.pool.metadata.name, []).append(plan)
        for pool_name, pool_plans in by_pool.items():
            frac, od_floor = pool_spot_budget(pool_plans[0].pool)
            if frac >= 1.0 and od_floor <= 0:
                continue
            existing_spot = existing_other = 0
            for node in self.state_nodes:
                if node.nodepool_name() != pool_name or node.deleting():
                    continue
                ct = node.labels().get(CAPACITY_TYPE_LABEL, "")
                if ct == CAPACITY_TYPE_SPOT:
                    existing_spot += 1
                elif ct:
                    existing_other += 1

            def _resolves_spot(plan: NodePlan) -> bool:
                if not plan.offerings:
                    return False
                cheapest = min(plan.offerings, key=lambda o: o.price)
                return cheapest.capacity_type == CAPACITY_TYPE_SPOT

            spot_plans = [p for p in pool_plans if _resolves_spot(p)]
            total = existing_spot + existing_other + len(pool_plans)
            n_spot = existing_spot + len(spot_plans)
            n_od = total - n_spot
            need, cause = 0, ""
            # epsilon before truncating: 0.7 * 10 is 6.999999999999999
            # in binary floats, and a bare int() would pin one plan
            # that is legitimately within budget
            spot_cap = int(frac * total + 1e-9)
            if frac < 1.0 and n_spot > spot_cap:
                need, cause = n_spot - spot_cap, "max-spot-fraction"
            if od_floor > 0 and n_od < min(od_floor, total):
                if min(od_floor, total) - n_od > need:
                    need, cause = (
                        min(od_floor, total) - n_od, "min-on-demand-floor"
                    )
            if need <= 0:
                continue
            for plan in reversed(spot_plans):
                if need <= 0:
                    break
                od = [o for o in plan.offerings if not o.is_spot()]
                if not od:
                    continue  # pods demand spot; budget can't touch it
                plan.offerings = od
                kept_types = [
                    it for it in plan.instance_types
                    if any(o in it.offerings for o in od)
                ]
                if kept_types:
                    plan.instance_types = kept_types
                plan.price = min(o.price for o in plan.offerings)
                need -= 1
                SPOT_BUDGET_PINNED.inc(
                    {"nodepool": pool_name, "cause": cause}
                )
            if need > 0:
                if spot_plans:
                    log.warning(
                        "spot budget for pool %s unsatisfiable: %d "
                        "planned spot nodes have no on-demand offering "
                        "(pods pin capacity-type=spot)", pool_name, need,
                    )
                else:
                    # nothing in this round to pin: the EXISTING fleet
                    # already exceeds the budget (e.g. the knob was
                    # tightened); attrition/consolidation retires the
                    # excess, provisioning cannot
                    log.warning(
                        "spot budget for pool %s: existing fleet is %d "
                        "node(s) over budget; new plans already comply",
                        pool_name, need,
                    )

    def _enforce_min_values(self, plan: NodePlan, results: SchedulerResults) -> bool:
        """minValues flexibility floor per planned node
        (types.go:284-318; relaxation annotation scheduler.go:649-658).
        The floors are checked against the TIGHTENED requirement set —
        pool requirements intersected with the scheduled pods' own —
        exactly as the reference filters with nodeClaimRequirements
        (nodeclaim.go:146,425-433): a pod selector can shrink a pool's
        In set below its floor even when the raw pool requirements
        remain satisfiable.
        Strict: such a plan is rejected and its pods report the reason.
        BestEffort: the plan survives, marked relaxed so serialization
        lowers the floors to the satisfiable count and the claim gets
        the min-values-relaxed annotation."""
        pool_reqs = _pool_requirements(plan.pool)
        if not pool_reqs.has_min_values():
            return True
        tightened = Requirements(r.copy() for r in pool_reqs)
        for pod in plan.pods:
            tightened.add(*Requirements.from_pod(pod, required_only=True))
        _, err = satisfies_min_values(plan.instance_types, tightened)
        if err is None:
            return True
        if self.min_values_policy == "BestEffort":
            plan.min_values_relaxed = True
            return True
        for pod in plan.pods:
            results.errors[pod.key] = f"{MIN_VALUES_ERROR_PREFIX}: {err}"
        return False

    def _pod_domains(self) -> dict[str, dict[str, str]]:
        out: dict[str, dict[str, str]] = {}
        for node in self.state_nodes:
            labels = node.labels()
            for pod_key in node.pod_keys:
                mapping = dict(labels)
                mapping[HOSTNAME_LABEL] = node.name
                out[pod_key] = mapping
        return out

    def _publish_progress(
        self, queue_depth: Optional[int] = None,
        now: Optional[float] = None,
    ) -> None:
        """Publish the in-flight solve's progress gauges. Called at
        phase boundaries (device solves are single blocking calls, so
        their interior cannot be sampled without a watcher thread —
        the gauges reflect the last boundary). `now` lets callers that
        already read the clock avoid a second read (stepping fake
        clocks would otherwise advance per publish)."""
        labels = {"controller": self.metrics_controller}
        SCHEDULER_UNFINISHED_WORK.set(
            (self.clock() if now is None else now) - self._solve_start,
            labels,
        )
        if queue_depth is not None:
            SCHEDULER_QUEUE_DEPTH.set(float(queue_depth), labels)

    def _batched_solve(
        self,
        pods: Sequence[Pod],
        required_only: bool = False,
        reserved_in_use: Optional[dict[str, int]] = None,
    ) -> Solution:
        self._publish_progress()
        groups = group_pods(pods, required_only=required_only)
        enc = encode(
            groups,
            self.pools_with_types,
            self.existing_inputs,
            self.daemon_overhead,
            reserved_in_use=(
                reserved_in_use if reserved_in_use is not None
                else self.reserved_in_use
            ),
            compat_cache=self.compat_cache,
        )
        return solve_encoded(
            enc, objective=self.objective, device=self.device
        )

    def _rsv_remaining(self, rid: str, round_in_use: dict[str, int]) -> int:
        """Instances left on a reservation after live nodes AND plans
        opened earlier in this scheduling round (reservationmanager.go
        debits across all in-flight nodeclaims of a run)."""
        return self._rsv_capacity.get(rid, 0) - round_in_use.get(rid, 0)

    @staticmethod
    def _debit_reservations(plans: Sequence[NodePlan], round_in_use: dict[str, int]) -> None:
        for plan in plans:
            if plan.reservation_id:
                round_in_use[plan.reservation_id] = (
                    round_in_use.get(plan.reservation_id, 0) + 1
                )

    def _accept_plans(
        self,
        new_nodes: Sequence[NodePlan],
        open_plans: list[NodePlan],
        results: SchedulerResults,
        round_in_use: dict[str, int],
    ) -> None:
        """Admit a batched solution's planned nodes into the round:
        Strict minValues rejects a plan BEFORE its pods enter the
        topology tracker (phantom pods would skew spread/anti-affinity
        for the rest of the round), and survivors debit the round's
        reservation budget exactly once."""
        kept = [
            plan for plan in new_nodes if self._enforce_min_values(plan, results)
        ]
        self._debit_reservations(kept, round_in_use)
        open_plans.extend(kept)

    def _commit_existing(self, idx: int, pod: Pod) -> None:
        node = self.state_nodes[idx]
        usage = resutil.pod_requests(pod)
        node.pod_usage = resutil.merge(node.pod_usage, usage)
        node.pod_keys.add(pod.key)
        # refresh solver input for subsequent passes
        self.existing_inputs[idx] = self._existing_input(node)

    def _register_topo_pod(
        self, pod: Pod, base_domains: dict[str, str], host_port_key: str,
        tb, topology: Topology,
    ) -> None:
        """Commit one lowered-solve placement into the round's topology
        tracker and host-port ledger (assignment domains override the
        node's representative ones)."""
        chosen = dict(base_domains)
        chosen.update(tb.assignments.get(pod.key, {}))
        topology.register(pod, chosen)
        if pod_host_ports(pod):
            self._host_ports.setdefault(host_port_key, HostPortUsage()).add(pod)

    def _plan_input(self, plan: NodePlan) -> Optional[ExistingNodeInput]:
        return plan_pseudo_input(plan, self.daemon_overhead)

    def _plan_domains(self, plan: NodePlan) -> dict[str, str]:
        return plan_domains(plan)

    # -- slow path ------------------------------------------------------------

    def _solve_complex(
        self,
        pods: Sequence[Pod],
        open_plans: list[NodePlan],
        topology: Topology,
        results: SchedulerResults,
        round_in_use: dict[str, int],
    ) -> None:
        """Per-pod scheduling with topology domain filtering.

        Pods in FFD order; each pod tries existing nodes, open plans,
        then a new node, honoring the Topology's allowed domains. On
        failure the preference ladder relaxes the pod and retries
        (scheduler.go:456 + preferences.go).
        """
        ordered = sorted(
            pods,
            key=lambda p: -(
                resutil.pod_requests(p).get("cpu", 0.0)
                + resutil.pod_requests(p).get("memory", 0.0) / 2**32
            ),
        )
        for pod in ordered:
            if self._timed_out():
                results.errors[pod.key] = TIMEOUT_ERROR
                continue
            last_step: Optional[str] = None
            for _ in range(8):  # relaxation ladder bound
                if self._try_place(pod, open_plans, topology, results, round_in_use):
                    if last_step is not None and self._explaining():
                        # the ladder unlocked this placement: say
                        # which rung did it
                        from karpenter_tpu_torch import explain

                        explain.note_pod(
                            pod.key, verdict="scheduled-after-relax",
                            relax_unlocked=last_step,
                        )
                    break
                topology.invalidate(pod.key)  # relax() mutates the pod
                step = relax(pod) if self.honor_preferences else None
                if not step:
                    results.errors[pod.key] = TOPOLOGY_INCOMPATIBLE_ERROR
                    break
                last_step = step
                self._note_relax(pod, step)

    def _try_place(
        self,
        pod: Pod,
        open_plans: list[NodePlan],
        topology: Topology,
        results: SchedulerResults,
        round_in_use: dict[str, int],
    ) -> bool:
        pod_reqs = Requirements.from_pod(pod)
        requests = resutil.pod_requests(pod)

        # 1) existing nodes
        for idx, node in enumerate(self.state_nodes):
            inp = self.existing_inputs[idx]
            if node.deleting():
                continue
            if tolerates_pod(list(inp.taints), pod) is not None:
                continue
            if not inp.requirements.is_compatible(
                pod_reqs, allow_undefined=WELL_KNOWN_LABELS
            ):
                continue
            if not resutil.fits(requests, inp.available):
                continue
            if pod_host_ports(pod):
                # keyed by inp.name: an in-flight node has no Node yet,
                # so node.name is "" and unnamed nodes would share (and
                # falsely conflict in) one bucket
                usage = self._host_ports.setdefault(inp.name, HostPortUsage())
                if usage.conflict(pod) is not None:
                    continue
            if pod.spec.volumes:
                # CSI attach limits on the existing node
                # (existingnode.go:29-140, volumeusage.go)
                vusage = self._volume_usage.get(inp.name)
                if vusage is not None and vusage.exceeds_limits(pod, self.kube):
                    continue
            labels = node.labels()
            candidate = {k: {v} for k, v in labels.items()}
            candidate[HOSTNAME_LABEL] = {inp.name}
            allowed = topology.allowed_domains_for_pod(pod, candidate)
            if allowed is None:
                continue
            self._commit_existing(idx, pod)
            if pod_host_ports(pod):
                self._host_ports[inp.name].add(pod)
            if pod.spec.volumes and inp.name in self._volume_usage:
                self._volume_usage[inp.name].add(pod, self.kube)
            results.existing_assignments.setdefault(inp.name, []).append(pod)
            topology.register(pod, {k: next(iter(v)) for k, v in allowed.items() if v})
            return True

        # 2) open planned nodes
        for plan in open_plans:
            if pod_host_ports(pod):
                # port check first: _plan_can_add narrows the plan's
                # type options as a side effect of admission
                usage = self._host_ports.setdefault(
                    f"planned-{id(plan)}", HostPortUsage()
                )
                if usage.conflict(pod) is not None:
                    continue
            if not self._plan_can_add(plan, pod, pod_reqs, requests, topology):
                continue
            if pod_host_ports(pod):
                self._host_ports[f"planned-{id(plan)}"].add(pod)
            plan.pods.append(pod)
            topology.register(
                pod, self._plan_domains(plan),
                source_taints=tuple(plan.pool.spec.template.spec.taints),
            )
            return True

        # 3) new node — permanent template taints only; startupTaints
        # clear before pods run (same rule as build_configs)
        for pool, types in self.pools_with_types:
            taints = tuple(pool.spec.template.spec.taints)
            if tolerates_pod(list(taints), pod) is not None:
                continue
            # the pool's OWN template requirements (labels included)
            # filter which types and offerings may launch under it —
            # exactly as build_configs does for the batched path;
            # without it this path can plan a node in a zone the pool
            # forbids
            from karpenter_tpu_torch.solver.encode import pool_template_requirements

            pool_reqs = pool_template_requirements(pool)
            fitting = []
            for it in types:
                if it.requirements.intersects(pod_reqs) is not None:
                    continue
                if pool_reqs.intersects(it.requirements) is not None:
                    continue
                overhead = self.daemon_overhead.get(pool.metadata.name, {})
                need = resutil.merge(requests, overhead)
                if not resutil.fits(need, it.allocatable):
                    continue
                offerings = [
                    o
                    for o in it.offerings.available().compatible(pod_reqs)
                    if pool_reqs.intersects(o.requirements) is None
                ]
                if not offerings:
                    continue
                fitting.append((it, offerings))
            if not fitting:
                continue
            zones = {o.zone for _, offs in fitting for o in offs}
            candidate = {
                TOPOLOGY_ZONE_LABEL: zones,
                CAPACITY_TYPE_LABEL: {
                    o.capacity_type for _, offs in fitting for o in offs
                },
                HOSTNAME_LABEL: {f"planned-new-{id(pod)}"},
                NODEPOOL_LABEL: {pool.metadata.name},
            }
            for key, value in pool.spec.template.labels.items():
                candidate.setdefault(key, {value})
            allowed = topology.allowed_domains_for_pod(pod, candidate)
            if allowed is None:
                continue
            allowed_zones = allowed.get(TOPOLOGY_ZONE_LABEL, zones)
            allowed_cts = allowed.get(
                CAPACITY_TYPE_LABEL, candidate[CAPACITY_TYPE_LABEL]
            )
            chosen_types = []
            chosen_offerings = []
            for it, offs in fitting:
                offs2 = [
                    o for o in offs
                    if o.zone in allowed_zones and o.capacity_type in allowed_cts
                    # a reserved offering only stays on the menu while
                    # its reservation has budget left this round —
                    # otherwise N per-pod plans could each pin the
                    # near-free reservation past its instance count
                    and (
                        not o.is_reserved()
                        or self._rsv_remaining(o.reservation_id, round_in_use) > 0
                    )
                ]
                if offs2:
                    chosen_types.append(it)
                    chosen_offerings.extend(offs2)
            if not chosen_types:
                continue
            if self.min_values_policy != "BestEffort":
                # Strict minValues checked at creation: a failing plan
                # would otherwise be rejected after its pod already
                # registered into the topology tracker
                pool_reqs = _pool_requirements(pool)
                if pool_reqs.has_min_values():
                    _, mv_err = satisfies_min_values(chosen_types, pool_reqs)
                    if mv_err is not None:
                        continue
            chosen_offerings.sort(key=lambda o: o.price)
            plan = NodePlan(
                pool=pool,
                instance_types=order_by_price(chosen_types, pod_reqs),
                offerings=chosen_offerings,
                pods=[pod],
                price=chosen_offerings[0].price,
            )
            if chosen_offerings[0].is_reserved():
                plan.reservation_id = chosen_offerings[0].reservation_id
                self._debit_reservations([plan], round_in_use)
            open_plans.append(plan)
            if pod_host_ports(pod):
                usage = HostPortUsage()
                usage.add(pod)
                self._host_ports[f"planned-{id(plan)}"] = usage
            topology.register(
                pod, self._plan_domains(plan),
                source_taints=tuple(plan.pool.spec.template.spec.taints),
            )
            return True
        return False

    def _plan_can_add(self, plan: NodePlan, pod: Pod, pod_reqs: Requirements,
                      requests, topology: Topology) -> bool:
        # permanent template taints only (startupTaints never gate
        # placement; see build_configs)
        taints = tuple(plan.pool.spec.template.spec.taints)
        if tolerates_pod(list(taints), pod) is not None:
            return False
        overhead = self.daemon_overhead.get(plan.pool.metadata.name, {})
        used = resutil.merge(
            overhead, resutil.requests_for_pods(plan.pods), requests
        )
        remaining_types = [
            it
            for it in plan.instance_types
            if it.requirements.intersects(pod_reqs) is None
            and resutil.fits(used, it.allocatable)
        ]
        if not remaining_types:
            return False
        candidate = {k: {v} for k, v in self._plan_domains(plan).items()}
        allowed = topology.allowed_domains_for_pod(pod, candidate)
        if allowed is None:
            return False
        plan.instance_types = remaining_types
        names = {it.name for it in remaining_types}
        plan.offerings = [
            o for o in plan.offerings if any(
                it.offerings and o in it.offerings for it in remaining_types
            )
        ] or plan.offerings
        return True

    # -- finalize -------------------------------------------------------------

    def _finalize_plan(self, plan: NodePlan) -> None:
        finalize_plan(plan)
