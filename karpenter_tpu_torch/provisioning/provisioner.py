"""Provisioner: pending pods -> NodeClaims.

Copy of `karpenter_tpu/provisioning/provisioner.py`, with its imports
pointed into `karpenter_tpu_torch`. The one addition is the device:
`Provisioner(..., device=None)` hands its device to every Scheduler it
builds and to its incremental tick
(`provisioning/incremental_tick.py`), the default reconcile path
(KARPENTER_INCREMENTAL=0 is its kill switch); `None` means the card,
and without a CUDA device the constructor raises as `solver.solve`
does.

Counterpart of pkg/controllers/provisioning/provisioner.go: batch
pending pods (batcher), gate on state sync, snapshot the cluster,
build a Scheduler, solve, then create NodeClaims (parallel in the
reference; sequential here — creation is in-memory) while enforcing
NodePool limits, and nominate target nodes for pods placed on
existing capacity.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import (
    DO_NOT_DISRUPT_ANNOTATION,
    NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION,
    NODEPOOL_LABEL,
    TERMINATION_FINALIZER,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    NodeClaim,
    NodeClaimSpec,
    RequirementSpec,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool, nodepool_owner_ref, order_by_weight
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, min_values_coverage
from karpenter_tpu_torch.provisioning import volume_topology
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics.store import NODECLAIMS_CREATED
from karpenter_tpu_torch.kube.objects import ObjectMeta, Pod
from karpenter_tpu_torch.provisioning.scheduler import Scheduler, SchedulerResults
from karpenter_tpu_torch.apis.v1.labels import is_restricted_label
from karpenter_tpu_torch.metrics.store import SCHEDULER_IGNORED_PODS
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.solver.solver import NodePlan, _backend, resolve_device
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.resources import ResourceList

log = logging.getLogger("karpenter.provisioner")

_claim_counter = itertools.count(1)

# Runtime default for NodeClaim terminationGracePeriod when the pool
# template leaves it unset — providers set this once at startup
# (nodeclaimtemplate.go:34-37,119). Seconds; None = no default.
DEFAULT_TERMINATION_GRACE_PERIOD: Optional[float] = None

# demand_surge burst pods (solver/faults.py `provision_intake` site):
# the label chaos suites use to find and retire a storm's pods, and the
# priorities the seeded low/high mix resolves to
SURGE_LABEL = "karpenter.sh/demand-surge"
SURGE_HIGH_PRIORITY = 100
SURGE_LOW_PRIORITY = -100


def _specs_from_requirement(req: Requirement, relaxed: bool) -> list[RequirementSpec]:
    """Serialize one algebraic Requirement back into claim spec
    entries via Requirement.spec_entries(). A BestEffort-relaxed plan
    drops a minValues floor ONLY where the surviving value set no
    longer satisfies it (the min-values-relaxed annotation records
    why); only an In value set can fall below its floor (complement
    sets allow unboundedly many values)."""
    specs: list[RequirementSpec] = []
    for op, values, min_values in req.spec_entries():
        if (
            relaxed and min_values is not None and op == IN
            and len(values) < min_values
        ):
            min_values = None
        specs.append(
            RequirementSpec(key=req.key, operator=op, values=values,
                            min_values=min_values)
        )
    return specs


@dataclass
class Batcher:
    """Debounce window for pod arrival (batcher.go:33-92): wait for
    `idle_seconds` of quiet or `max_seconds` total."""

    idle_seconds: float = 1.0
    max_seconds: float = 10.0
    _last_trigger: float = 0.0
    _window_start: float = 0.0
    _pending: bool = False

    def trigger(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if not self._pending:
            self._window_start = now
            self._pending = True
        self._last_trigger = now

    def ready(self, now: Optional[float] = None) -> bool:
        if not self._pending:
            return False
        now = time.time() if now is None else now
        return (
            now - self._last_trigger >= self.idle_seconds
            or now - self._window_start >= self.max_seconds
        )

    def reset(self) -> None:
        self._pending = False


class Provisioner:
    def __init__(
        self,
        kube: KubeClient,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        options=None,
        clock=None,
        recorder=None,
        device=None,
    ):
        # the device of every Scheduler this provisioner builds: None
        # is the card (raising without one), as in solver.solve
        self.device = (
            resolve_device(device) if _backend() != "host" else None
        )
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.options = options
        self.clock = clock if clock is not None else time.monotonic
        self.recorder = recorder
        self.batcher = Batcher()
        # Encoder compat-row/config cache shared across rounds
        # (solver/incremental.EncodedCache): steady-state rounds with
        # repeating pod shapes skip the G x C requirement rebuild. It
        # self-invalidates on catalog fingerprint changes; the
        # NodePool dirty tracker busts it eagerly too (belt and
        # braces for in-place template mutations the fingerprint
        # would only catch through pool.hash()).
        from karpenter_tpu_torch.kube.dirty import DirtyTracker
        from karpenter_tpu_torch.solver.incremental import EncodedCache

        self.encode_cache = EncodedCache()
        self._catalog_dirty = DirtyTracker(kube).watch("NodePool")
        # Incremental live tick (the default reconcile path): retained
        # per-node solver inputs synced O(dirty) from the watch stream,
        # with a shadow full-solve oracle audit and quarantine-on-
        # divergence. Ineligible ticks (topology, volumes, minValues,
        # spot budgets, reservations, churn blow-outs) fall through to
        # the unchanged full Scheduler below. KARPENTER_INCREMENTAL=0
        # disables it entirely.
        from karpenter_tpu_torch.provisioning.incremental_tick import (
            IncrementalTickScheduler,
        )

        self.incremental = IncrementalTickScheduler(
            kube, cluster, self.encode_cache,
            make_scheduler=self._make_scheduler,
            options=options, clock=self.clock,
            # the admission loop's limit simulation: a mixed-priority
            # incremental tick whose plans would blow a pool limit
            # must fall back to the full path (where the shed/cutoff
            # machinery wraps the results)
            plans_over_limits=self._plans_over_limits,
            device=self.device,
        )

    # -- pod intake (provisioner.go:172-195, utils/node) ----------------------

    def get_pending_pods(self) -> list[Pod]:
        out = []
        ignored = 0
        for pod in self.kube.pods():
            if pod.is_terminal() or pod.is_terminating():
                continue
            if pod.spec.node_name:
                continue
            if pod.owner_kind() == "DaemonSet":
                continue
            if pod.spec.scheduler_name and pod.spec.scheduler_name not in (
                "default-scheduler",
                "karpenter",
            ):
                ignored += 1
                continue
            if pod.spec.volumes:
                # kube-scheduler-rejected PVC states filter at intake
                # (provisioner.go:509 ValidatePersistentVolumeClaims)
                reason = volume_topology.validate_pvcs(pod, self.kube)
                if reason is not None:
                    log.debug(
                        "pod %s not provisionable: %s", pod.key, reason
                    )
                    ignored += 1
                    continue
            out.append(pod)
        SCHEDULER_IGNORED_PODS.set(float(ignored))
        return out

    def reschedulable_pods_from_deleting_nodes(self) -> list[Pod]:
        """Pods on draining nodes are included in the solve so
        replacement capacity exists before eviction
        (provisioner.go:324-333)."""
        out = []
        for node in self.cluster.nodes():
            if not node.deleting():
                continue
            for pod_key in node.pod_keys:
                pod = self.kube.get_pod(*pod_key.split("/", 1))
                if pod is None or pod.is_terminal() or pod.is_terminating():
                    continue
                if pod.owner_kind() == "DaemonSet":
                    continue
                if pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION) == "true":
                    continue
                out.append(pod)
        return out

    # -- schedule (provisioner.go:303-400) ------------------------------------

    def ready_pools_with_types(self) -> list[tuple[NodePool, list]]:
        pools = []
        for pool in order_by_weight(self.kube.node_pools()):
            if pool.metadata.deletion_timestamp is not None:
                continue
            if pool.is_static():
                continue
            if pool.status_conditions.is_false("NodeClassReady"):
                continue
            try:
                types = self.cloud_provider.get_instance_types(pool)
            except Exception as err:  # provider hiccups skip the pool
                log.warning("skipping pool %s: %s", pool.metadata.name, err)
                continue
            if types:
                pools.append((pool, types))
        return pools

    def _make_scheduler(self, pools, metrics_controller: str = "provisioner"
                        ) -> Scheduler:
        """The full-path Scheduler construction — one seam shared by
        the live reconcile fallback and the incremental tick's shadow
        oracle audit, so the audit compares against exactly what the
        fallback would have decided."""
        return Scheduler(
            pools_with_types=pools,
            state_nodes=self.cluster.deep_copy_nodes(),
            daemonsets=self.cluster.daemonsets(),
            cluster_pods=self.kube.pods(),
            kube=self.kube,
            allow_reserved=(
                self.options.feature_gates.reserved_capacity
                if self.options is not None else True
            ),
            min_values_policy=(
                self.options.min_values_policy
                if self.options is not None else "Strict"
            ),
            ignore_dra_requests=(
                self.options.ignore_dra_requests
                if self.options is not None else True
            ),
            clock=self.clock,
            compat_cache=self.encode_cache,
            metrics_controller=metrics_controller,
            device=self.device,
        )

    def schedule(self, extra_pods: Sequence[Pod] = ()) -> SchedulerResults:
        from karpenter_tpu_torch import tracing

        with tracing.span("intake") as sp:
            pods = list(extra_pods) or (
                self.get_pending_pods()
                + self.reschedulable_pods_from_deleting_nodes()
            )
            if not extra_pods:
                # live intake only: a scripted solve must never absorb a
                # chaos burst meant for the reconcile loop
                pods = self._consume_demand_surge(pods)
            # admission-plugin analogue: resolve PriorityClass values
            # onto spec.priority before anything groups the pods
            from karpenter_tpu_torch.scheduling.priority import (
                resolve_pod_priorities,
            )

            resolve_pod_priorities(pods, self.kube)
            sp.annotate(pods=len(pods))
        if self._catalog_dirty.drain("NodePool"):
            self.encode_cache.invalidate()
        pools = self.ready_pools_with_types()
        # the incremental live tick is the default path; it returns
        # None for ticks outside its envelope (explicit extra_pods are
        # a caller-scripted solve, not the live reconcile). A
        # mixed-priority tick that hits a capacity failure — the only
        # case the admission loop below would act on — falls back to
        # the full path inside the tick (reason "priority"), so an
        # incremental serve never needs the shed/cutoff machinery.
        # The route span carries the decision + reason — the
        # incremental tick annotates it from its gates.
        if not extra_pods:
            with tracing.span("route"):
                results = self.incremental.tick(pods, pools)
                if results is not None:
                    self.cluster.mark_pod_scheduling_decisions(pods)
                    return results
        results = self._make_scheduler(pools).solve(pods)
        with tracing.span("admission"):
            results = self._enforce_priority_admission(pods, pools, results)
        self.cluster.mark_pod_scheduling_decisions(pods)
        return results

    # -- priority admission -----------------------------------------

    def _consume_demand_surge(self, pods: list[Pod]) -> list[Pod]:
        """The `provision_intake` fault site: a firing `demand_surge`
        rule is consumed here as a deterministic burst of pending pods
        — created in the store (a workload controller scaled out
        mid-tick) and joined to this round's solve."""
        from karpenter_tpu_torch.solver import faults as _faults

        try:
            _faults.fire("provision_intake")
        except _faults.DemandSurgeError as err:
            burst = self._synthesize_surge(err)
            log.warning(
                "fault injected: %s (%d surge pods join this round)",
                err, len(burst),
            )
            pods = pods + burst
        except _faults.FaultError as err:
            # a mis-kinded chaos spec aimed at this site must not take
            # the reconcile loop down — consume and warn, exactly as
            # the providers do at cloud_interrupt
            log.warning(
                "ignoring non-surge fault at provision_intake: %s", err
            )
        return pods

    def _synthesize_surge(self, err) -> list[Pod]:
        """Deterministic burst pods for one DemandSurgeError: names
        `surge-<seq>-<i>`, priority low (-100) or high (100) decided by
        the seeded hash — a pure function of (seed, seq), so the same
        schedule injects byte-identical demand across runs. Bare pods
        (no owner): an evicted or shed surge pod never rebirths, so the
        storm is occurrence-bounded by construction."""
        from karpenter_tpu_torch.kube.objects import Container, PodSpec
        from karpenter_tpu_torch.solver.faults import _hash01

        out: list[Pod] = []
        for i in range(err.count):
            name = f"surge-{err.seq}-{i}"
            existing = self.kube.get_pod("default", name)
            if existing is not None:
                out.append(existing)
                continue
            high = _hash01(err.seed, f"surge-{err.seq}", i + 1) < 0.5
            pod = Pod(
                metadata=ObjectMeta(
                    name=name,
                    labels={SURGE_LABEL: str(err.seq)},
                ),
                spec=PodSpec(
                    containers=[Container(
                        requests={"cpu": 0.5, "memory": float(2**30)}
                    )],
                    priority=SURGE_HIGH_PRIORITY if high
                    else SURGE_LOW_PRIORITY,
                ),
            )
            self.kube.create(pod)
            out.append(pod)
        return out

    def _plans_over_limits(self, plans: Sequence[NodePlan]) -> list[NodePlan]:
        """Plans `create_node_claims` would reject for NodePool limits,
        simulated WITHOUT mutation against the same usage snapshot and
        in the same order the real create walks — so the admission loop
        can fold limit truncation into the priority cutoff before any
        claim exists."""
        usage_by_pool = self.cluster.nodepool_resources()
        over: list[NodePlan] = []
        for plan in plans:
            pool = plan.pool
            if not pool.spec.limits:
                continue
            usage = usage_by_pool.get(pool.metadata.name, {})
            fitting = [
                it for it in plan.instance_types
                if all(
                    usage.get(key, 0.0) + it.capacity.get(key, 0.0) <= limit
                    for key, limit in pool.spec.limits.items()
                )
            ]
            if not fitting:
                over.append(plan)
                continue
            # create also rejects when the surviving types leave the
            # plan's OFFERING set empty (a spot-budget pin can strip
            # every offering of the limit-fitting types) — a plan this
            # sim passes but create would kill breaks the tail contract
            if plan.offerings and not any(
                o in it.offerings for it in fitting for o in plan.offerings
            ):
                over.append(plan)
                continue
            usage_by_pool[pool.metadata.name] = resutil.merge(
                usage, fitting[0].capacity
            )
        return over

    def _enforce_priority_admission(
        self, pods: Sequence[Pod], pools, results: SchedulerResults,
    ) -> SchedulerResults:
        """The overload degradation contract (provisioning/priority.py):
        when capacity (catalog or pool limits) truncates the solve, the
        unscheduled set must be exactly the lowest-priority tail of the
        admission order. Iterates cutoff-and-re-solve until the
        admitted prefix is clean; the cutoff strictly decreases, so the
        loop terminates. No-op on uniform-priority rounds."""
        from karpenter_tpu_torch.provisioning import priority as padm
        from karpenter_tpu_torch.provisioning.scheduler import NodeInputBuilder

        return padm.enforce_admission(
            list(pods), pools, results,
            solve_fn=lambda keep: self._make_scheduler(pools).solve(keep),
            plans_over_limits=self._plans_over_limits,
            daemon_overhead=lambda: NodeInputBuilder(
                pools, self.cluster.daemonsets()
            ).daemon_overhead(),
        )

    # -- create (provisioner.go:407-459) --------------------------------------

    def create_node_claims(self, results: SchedulerResults,
                           now: Optional[float] = None) -> list[NodeClaim]:
        from karpenter_tpu_torch import tracing

        with tracing.span("create") as sp:
            created = self._create_node_claims(results, now)
            sp.annotate(claims=len(created),
                        limit_rejected=len(results.new_node_plans)
                        - len(created))
        return created

    def _create_node_claims(self, results: SchedulerResults,
                            now: Optional[float] = None) -> list[NodeClaim]:
        from karpenter_tpu_torch import tracing

        # decision provenance: the launched claim carries the trace id
        # of the tick that produced it, so any node on the fleet
        # resolves back to the exact span tree (and fault window) via
        # /debug/traces?trace_id=<annotation>
        provenance = tracing.current_trace_id()
        created = []
        # one usage snapshot per round (an O(nodes) scan under the
        # cluster lock — not per plan), advanced in-loop with each
        # created claim's expected capacity so the plans of one call
        # cannot jointly blow a pool limit
        usage_by_pool = self.cluster.nodepool_resources()
        for plan in results.new_node_plans:
            claim = self._claim_from_plan(plan, usage_by_pool)
            if claim is None:
                from karpenter_tpu_torch import explain
                from karpenter_tpu_torch.provisioning.priority import (
                    LIMITS_ERROR,
                )

                for pod in plan.pods:
                    results.errors[pod.key] = LIMITS_ERROR
                    if explain.active() is not None:
                        explain.note_pod(
                            pod.key, verdict="unschedulable",
                            error=LIMITS_ERROR, code="limits",
                            pool=plan.pool.metadata.name,
                        )
                continue
            if claim.status.capacity:
                pool_name = plan.pool.metadata.name
                usage_by_pool[pool_name] = resutil.merge(
                    usage_by_pool.get(pool_name, {}), claim.status.capacity
                )
            if now is not None:
                # stamp the driving clock: liveness deadlines compare
                # claim age against the same `now` the controllers run
                # on, so a simulated-future round must not create
                # claims that look 15 minutes old already
                claim.metadata.creation_timestamp = now
            if provenance:
                claim.metadata.annotations[
                    tracing.PROVENANCE_ANNOTATION
                ] = provenance
            self.kube.create(claim)
            plan.claim_name = claim.metadata.name
            # sync-write into state so back-to-back solves see it
            # (provisioner.go:448-453)
            self.cluster.update_node_claim(claim)
            created.append(claim)
            # capacity type from the plan's resolved (cheapest) offering
            # — the launch target; the claim's own label lands only at
            # registration
            NODECLAIMS_CREATED.inc({
                "nodepool": plan.pool.metadata.name,
                "capacity_type": (
                    plan.offerings[0].capacity_type if plan.offerings else ""
                ),
            })
        # nominate existing nodes receiving pods (provisioner.go:399);
        # node_for_key also resolves claim-name keys so in-flight
        # nodes that just received assignments get their nomination
        # window too (disruption must not treat them as empty)
        for node_name in results.existing_assignments:
            state = self.cluster.node_for_key(node_name)
            if state is not None:
                state.nominate()
        return created

    def _claim_from_plan(
        self, plan: NodePlan,
        usage_by_pool: Optional[dict[str, ResourceList]] = None,
    ) -> Optional[NodeClaim]:
        pool = plan.pool
        # limits check (reference checks at create: nodepool.go Limits).
        # The claim keeps instance-type flexibility, so the LAUNCH may
        # resolve onto any admitted type: drop the types that would
        # breach the remaining limit headroom — then whichever type the
        # provider picks, the pool stays within its limits.
        if pool.spec.limits:
            if usage_by_pool is not None:
                usage = usage_by_pool.get(pool.metadata.name, {})
            else:
                usage = self.cluster.nodepool_resources().get(
                    pool.metadata.name, {}
                )
            fitting = [
                it for it in plan.instance_types
                if all(
                    usage.get(key, 0.0) + it.capacity.get(key, 0.0) <= limit
                    for key, limit in pool.spec.limits.items()
                )
            ]
            if not fitting:
                return None
            plan.instance_types = fitting
            plan.offerings = [
                o for o in plan.offerings
                if any(o in it.offerings for it in fitting)
            ]
            if not plan.offerings:
                return None

        requirements = [
            RequirementSpec(key=spec.key, operator=spec.operator,
                            values=tuple(spec.values), min_values=spec.min_values)
            for spec in pool.spec.template.spec.requirements
        ]
        for key, value in pool.spec.template.labels.items():
            requirements.append(RequirementSpec(key=key, operator=IN, values=(value,)))
        # tighten to the solved instance-type set
        type_names = tuple(it.name for it in plan.instance_types)
        requirements.append(
            RequirementSpec(key="node.kubernetes.io/instance-type", operator=IN,
                            values=type_names)
        )
        zones = tuple(sorted({o.zone for o in plan.offerings}))
        if zones:
            requirements.append(
                RequirementSpec(key="topology.kubernetes.io/zone", operator=IN,
                                values=zones)
            )
        captypes = tuple(sorted({o.capacity_type for o in plan.offerings}))
        if captypes:
            requirements.append(
                RequirementSpec(key="karpenter.sh/capacity-type", operator=IN,
                                values=captypes)
            )
        # a reservation-pinned plan carries its reservation id so the
        # provider launches into the reserved capacity
        # (FinalizeScheduling, scheduling/nodeclaim.go:252)
        rids = tuple(sorted({
            o.reservation_id for o in plan.offerings if o.reservation_id
        }))
        if rids:
            requirements.append(
                RequirementSpec(key="karpenter.sh/reservation-id", operator=IN,
                                values=rids)
            )

        # tighten with the scheduled pods' own requirements: the
        # reference's in-flight NodeClaim accumulates every added
        # pod's requirement set (nodeclaim.go:114-167 Add), so a claim
        # serving tier=gold pods pins the tier label even when the
        # template admits several values
        combined = Requirements(
            Requirement(r.key, r.operator, list(r.values), r.min_values)
            for r in requirements
        )
        for pod in plan.pods:
            combined.add(
                *(
                    r
                    for r in Requirements.from_pod(pod, required_only=True)
                    # keys the claim may not carry as requirements
                    # (karpenter.sh/nodepool rides the label; fully
                    # restricted domains are admission-rejected)
                    if r.key != NODEPOOL_LABEL
                    and is_restricted_label(r.key) is None
                )
            )
        if plan.min_values_relaxed:
            # BestEffort relaxation lowers an unsatisfiable floor to
            # the count of values the launchable instance types still
            # cover — the reference writes the satisfiable count back
            # onto the requirement (nodeclaim.go:147-150) rather than
            # dropping the floor outright
            coverage = min_values_coverage(plan.instance_types, combined)
            for req in combined:
                if (
                    req.min_values is not None
                    and coverage.get(req.key, 0) < req.min_values
                ):
                    req.min_values = coverage[req.key] or None
        requirements = []
        for req in combined:
            requirements.extend(
                _specs_from_requirement(req, plan.min_values_relaxed)
            )

        name = f"{pool.metadata.name}-{next(_claim_counter):05d}"
        claim = NodeClaim(
            metadata=ObjectMeta(
                name=name,
                namespace="",
                labels={NODEPOOL_LABEL: pool.metadata.name,
                        **pool.spec.template.labels},
                annotations=dict(pool.spec.template.annotations),
                finalizers=[TERMINATION_FINALIZER],
                owner_references=[nodepool_owner_ref(pool)],
            ),
            spec=NodeClaimSpec(
                requirements=requirements,
                resources=resutil.requests_for_pods(plan.pods),
                taints=list(pool.spec.template.spec.taints),
                startup_taints=list(pool.spec.template.spec.startup_taints),
                node_class_ref=pool.spec.template.spec.node_class_ref,
                expire_after=pool.spec.template.spec.expire_after,
                termination_grace_period=(
                    pool.spec.template.spec.termination_grace_period
                    if pool.spec.template.spec.termination_grace_period is not None
                    else DEFAULT_TERMINATION_GRACE_PERIOD
                ),
            ),
        )
        # expected capacity from the plan's primary (cheapest) type: an
        # unlaunched claim must still count against pool limits in
        # cluster state (StateNode.capacity falls back to this; the
        # provider's ACTUAL launch overwrites it, launch.go analogue) —
        # otherwise back-to-back rounds before a lifecycle tick see
        # zero committed capacity and jointly blow the limit
        if plan.instance_types:
            claim.status.capacity = dict(plan.instance_types[0].capacity)
        claim.metadata.annotations["karpenter.sh/nodepool-hash"] = pool.hash()
        if plan.min_values_relaxed:
            claim.metadata.annotations[
                NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION
            ] = "true"
        claim.metadata.annotations["karpenter.sh/nodepool-hash-version"] = "v3"
        return claim

    # -- reconcile loop (provisioner.go:119-145) ------------------------------

    def reconcile(self, now: Optional[float] = None) -> SchedulerResults:
        if not self.cluster.synced():
            return SchedulerResults(new_node_plans=[], existing_assignments={})
        # advance the provider's time-varying spot price curve before
        # the catalog is read: launch decisions see current spot market
        # prices, and a moved curve busts the encoder cache through the
        # catalog fingerprint exactly like an overlay price change
        reprice = getattr(self.cloud_provider, "reprice", None)
        if reprice is not None and now is not None:
            reprice(now)
        results = self.schedule()
        # crash window: the solver decided but nothing is written yet —
        # a restart must re-solve to the same decision from the API
        from karpenter_tpu_torch.solver import faults as _faults

        _faults.fire("crash_claims")
        self.create_node_claims(results, now=now)
        self._record_events(results, now=now)
        self.batcher.reset()
        return results

    def micro_solve(
        self, pods: Sequence[Pod], now: Optional[float] = None,
    ) -> Optional[SchedulerResults]:
        """Event-driven micro provisioning round: a debounced arrival
        batch rides the incremental tick's O(dirty) path against
        retained inputs. Intake is the batch the reactive plane
        resolved — never a store walk. Returns None when the
        incremental envelope DEFERRED the batch to the next full tick
        (ineligible shape, cold cache, churn, quarantine, priority
        shedding); the operator re-arms the batcher in that case."""
        from karpenter_tpu_torch import tracing

        if not pods or not self.cluster.synced():
            return None
        reprice = getattr(self.cloud_provider, "reprice", None)
        if reprice is not None and now is not None:
            reprice(now)
        pods = list(pods)
        from karpenter_tpu_torch.scheduling.priority import (
            resolve_pod_priorities,
        )

        resolve_pod_priorities(pods, self.kube)
        if self._catalog_dirty.drain("NodePool"):
            self.encode_cache.invalidate()
        pools = self.ready_pools_with_types()
        # reduced-cost ordering from the retained dual certificate —
        # applied BEFORE tick() so the shadow audit sees the same order
        pods = self.incremental.micro_order(pods)
        with tracing.span("route"):
            results = self.incremental.tick(pods, pools, micro=True)
        if results is None:
            return None
        # same crash window as reconcile(): decided, nothing written —
        # the chaos suite kills the operator mid-micro-solve here
        from karpenter_tpu_torch.solver import faults as _faults

        _faults.fire("crash_claims")
        self.create_node_claims(results, now=now)
        self._record_events(results, now=now)
        self.cluster.mark_pod_scheduling_decisions(pods)
        return results

    def _record_events(self, results: SchedulerResults,
                       now: Optional[float] = None) -> None:
        """Pod-facing scheduling events (scheduling/events.go:46-68:
        Nominated on placement, FailedScheduling with the reason on
        the unschedulable remainder)."""
        if self.recorder is None:
            return
        from karpenter_tpu_torch.events.recorder import Event

        for target, pods in results.existing_assignments.items():
            # the assignment key is a node name OR an in-flight claim
            # name (scheduler._state_node_key) — say which, so kubectl
            # readers don't grep for a Node that doesn't exist yet
            noun = "node" if self.kube.get_node(target) else "nodeclaim"
            for pod in pods:
                self.recorder.publish(Event(
                    kind="Pod", name=pod.metadata.name,
                    namespace=pod.metadata.namespace, type="Normal",
                    reason="Nominated",
                    message=f"Pod should schedule on {noun} {target}",
                ), now=now)
        for plan in results.new_node_plans:
            if not plan.claim_name:
                continue  # limits rejected the claim; errors carry it
            for pod in plan.pods:
                self.recorder.publish(Event(
                    kind="Pod", name=pod.metadata.name,
                    namespace=pod.metadata.namespace, type="Normal",
                    reason="Nominated",
                    message="Pod should schedule on nodeclaim "
                            f"{plan.claim_name}",
                ), now=now)
        if results.errors:
            from karpenter_tpu_torch import explain
            from karpenter_tpu_torch.explain import funnel as funnel_mod
            from karpenter_tpu_torch.metrics.store import POD_UNSCHEDULABLE_TICKS
            from karpenter_tpu_torch.provisioning.scheduler import reason_code

            for key, reason in results.errors.items():
                pod = self.kube.get_pod(*key.split("/", 1))
                if pod is None:
                    continue
                # persistence stays visible through the counter even
                # while the (sticky-deduped) Event below never reposts
                POD_UNSCHEDULABLE_TICKS.inc({"reason": reason_code(reason)})
                message = f"Failed to schedule pod: {reason}"
                exclusions = funnel_mod.top_exclusions(explain.find_pod(key))
                if exclusions:
                    message += " (" + "; ".join(exclusions) + ")"
                # sticky: an identical message republished tick after
                # tick refreshes the recorder's frozen-key dedupe
                # window instead of reposting every DEDUPE_TTL
                self.recorder.publish(Event(
                    kind="Pod", name=pod.metadata.name,
                    namespace=pod.metadata.namespace, type="Warning",
                    reason="FailedScheduling",
                    message=message,
                ), now=now, sticky=True)
