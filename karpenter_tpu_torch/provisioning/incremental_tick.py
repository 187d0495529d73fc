"""Incremental live tick: the provisioner's retained-state reconcile.

Copy of `karpenter_tpu/provisioning/incremental_tick.py`, whole, with
its imports pointed into `karpenter_tpu_torch`. The one addition is the
device: `IncrementalTickScheduler(..., device=None)` takes the device
of the Provisioner that builds it and hands it to every
`solve_encoded` (B3 or B1, then B2) and `build_dual_floor` (B5) it
runs; `None` means the card, and without a CUDA device the constructor
raises as `solver.solve` does. The operator's `readyz()` is not ported:
`status()` is what it would surface.

The full reconcile path pays O(fleet) per tick — a deep-copied cluster
snapshot, a fresh `ExistingNodeInput` per node, a topology rebuild
over every bound pod, and an encode whose pseudo-config axis spans
the whole fleet. This module makes the incremental structure THE
operator tick:

- **Retained state**: one `ExistingNodeInput` per live/in-flight node,
  built by the SAME `NodeInputBuilder` the full Scheduler uses, kept
  across rounds and refreshed only for keys the kube watch stream
  marked dirty (`DirtyTracker` with mapped keys: a Pod event dirties
  the node it is bound to; a NodeClaim event dirties both its claim
  key and its node). Alongside each input row the tick retains the
  node's TOPOLOGY-DOMAIN columns (labels, taints, hostname) and its
  RESERVATION column (the reservation id the node consumes) —
  refreshed by the same dirty marks, so topology-spread and
  reservation-holding ticks ride the O(dirty) path too. A
  410-driven relist marks EVERYTHING dirty — the diff events of a
  relist cannot prove nothing else changed while the watch was stale,
  so lost continuity always costs one full rebuild, never a silent
  stale row.

- **Eligibility envelope**: the fast path
  expresses topology-spread constraints (lowered through the same
  `solver/topo_batch` machinery the full Scheduler uses, against a
  Topology built from the retained domain columns), reservation
  budgets (the retained reservation ledger feeds the encode exactly
  as `Scheduler.reserved_in_use` does), and priority-bearing ticks
  (priority-major grouping is inherited from `group_pods`; a
  mixed-priority tick that hits a capacity failure — the only case
  the admission/shed machinery acts on — hands the whole tick to the
  full path, reason `priority`). Strict gates still route anything
  the batched path cannot express (pod affinity/anti-affinity, host
  ports, volumes, DRA, minValues pools, non-default spot budgets) to
  the unchanged full Scheduler; a churn threshold
  (`KARPENTER_INCR_CHURN_MAX`) does the same when the dirty fraction
  says incrementality has nothing left to save. Per-reason fallback
  counts are retained and surfaced in `status()["fallbacks"]` so
  envelope regressions are visible at a glance.

- **Oracle audit**: on a sampled cadence (`KARPENTER_INCR_AUDIT_EVERY`)
  — and ALWAYS after fault-injector activity, crash recovery, the
  first tick that exercises a newly-widened envelope shape
  (`envelope` trigger), or while on post-quarantine probation — the
  tick also runs the full Scheduler as a shadow and fingerprints both
  decision sets. Divergence quarantines the retained state (cleared,
  encoder cache busted, divergence recorded for replay) and serves
  the full-solve decision; the next tick rebuilds from scratch and
  must pass a probation audit before the cache is trusted again. The
  `incremental_poison` degradation rung (solver/resilience.py)
  records every quarantined serve, so a poisoned cache degrades to a
  full solve — never to a wrong fleet.

- **Chaos**: `cache_poison@incremental` (solver/faults.py) corrupts
  one retained capacity row deterministically; `operator_crash` fires
  at `crash_incr_solve` (dirty sets drained, solve not yet run) and
  `crash_incr_commit` (solved, plans not yet written) so the
  restart-chaos suite can kill the operator inside the incremental
  tick and assert the rebuilt cache converges.

Decision identity is the design invariant: on eligible ticks the
encode inputs (same builder, same ordering — live nodes in cluster
order, in-flight fewest-pods-first — same catalog sort, same residual
prune that provably preserves first-feasible order, same topology
lowering fed from the retained domain columns) match the full
Scheduler's, so the audit asserts equality, not a tolerance band.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    HOSTNAME_LABEL,
    RESERVATION_ID_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.kube.dirty import DirtyTracker
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics.store import (
    INCREMENTAL_AUDITS,
    INCREMENTAL_DIVERGENCE,
    INCREMENTAL_FINGERPRINT_AGE,
    INCREMENTAL_TICK,
    SCHEDULER_QUEUE_DEPTH,
    SCHEDULER_SCHEDULING_DURATION,
    SCHEDULER_UNSCHEDULABLE_PODS,
    STATE_SHARD_INVALIDATIONS,
)
from karpenter_tpu_torch.state.shards import shard_of
from karpenter_tpu_torch.provisioning.preferences import relax, relaxable
from karpenter_tpu_torch.provisioning.scheduler import (
    NO_CAPACITY_ERROR,
    SOLVE_TIMEOUT_SECONDS,
    NodeInputBuilder,
    SchedulerResults,
    _pool_requirements,
    _state_node_key,
    finalize_plan,
    plan_domains,
    plan_pseudo_input,
    pool_spot_budget,
)
from karpenter_tpu_torch.scheduling.hostports import pod_host_ports
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.solver import faults, topo_batch
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.incremental import (
    _env_float,
    _env_on,
    catalog_fingerprint,
)
from karpenter_tpu_torch.solver.solver import _backend, resolve_device, solve_encoded
from karpenter_tpu_torch.utils import resources as resutil

log = logging.getLogger("karpenter.incremental")

ENV_ENABLE = "KARPENTER_INCREMENTAL"
ENV_AUDIT_EVERY = "KARPENTER_INCR_AUDIT_EVERY"
ENV_CHURN_MAX = "KARPENTER_INCR_CHURN_MAX"
# micro-solve dual certificate: opt-in reduced-cost batch
# ordering, plus an optional certified-spend defer gate (0 = off)
ENV_MICRO_DUAL = "KARPENTER_MICRO_DUAL"
ENV_MICRO_SPEND_MAX = "KARPENTER_MICRO_DUAL_SPEND_MAX"

MAX_DIVERGENCE_RECORDS = 16
RETRY_ROUNDS = 16  # k-way-evicted re-solve bound, mirrors Scheduler._solve


class _EnvelopeEscape(Exception):
    """An admission-loop re-solve left the incremental envelope
    (timeout, topology fallback): the whole tick must hand over."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def incremental_enabled() -> bool:
    """KARPENTER_INCREMENTAL gate, default ON (the live tick is the
    default path; the env knob is the operator's kill switch)."""
    return os.environ.get(ENV_ENABLE, "1").lower() not in (
        "0", "false", "off"
    )


def _pod_node_keys(event: str, pod) -> list[str]:
    """A Pod event dirties the node the pod is (or was) bound to —
    its usage row changed. Unbound pods touch no retained row."""
    return [pod.spec.node_name] if pod.spec.node_name else []


def _claim_keys(event: str, claim) -> list[str]:
    """A NodeClaim event dirties its claim key (the in-flight state
    key) AND its node's key once one materialized — registration moves
    the state key from claim name to node name, and both entries must
    refresh across that transition."""
    keys = [claim.metadata.name]
    if claim.status.node_name:
        keys.append(claim.status.node_name)
    return keys


@dataclass
class _NodeMeta:
    """The retained non-capacity columns of one node: what the full
    Scheduler re-derives per round for topology-domain discovery,
    pod-domain mapping and the reservation ledger. Rebuilt exactly
    when the node's `ExistingNodeInput` row rebuilds (same dirty
    marks), so the two retained views cannot drift from each other."""

    name: str                     # node name ("" while claim-keyed)
    labels: dict[str, str]
    taints: tuple
    rid: str                      # reservation id consumed, "" if none
    node: object                  # the LIVE StateNode (pod_keys source)


def decision_fingerprint(results: SchedulerResults) -> tuple:
    """Name-insensitive identity of one scheduling decision: what the
    oracle audit diffs between the incremental and full paths. New
    plans are identified by (pool, resolved launch target, price, pod
    set); existing assignments by (state key, pod set); failures by
    (pod key, reason)."""
    new = []
    for plan in results.new_node_plans:
        it, off = plan.primary()
        new.append((
            plan.pool.metadata.name if plan.pool is not None else "",
            it.name if it is not None else "",
            (off.zone, off.capacity_type) if off is not None else ("", ""),
            round(float(plan.price), 6),
            tuple(sorted(p.key for p in plan.pods)),
        ))
    existing = sorted(
        (key, tuple(sorted(p.key for p in pods)))
        for key, pods in results.existing_assignments.items()
    )
    return (
        tuple(sorted(new)),
        tuple(existing),
        tuple(sorted(results.errors.items())),
    )


class IncrementalTickScheduler:
    """The provisioner's retained-state solve seam (see module doc).

    `tick(pods, pools_with_types)` returns SchedulerResults when the
    incremental path served (or the quarantine path served the
    full-solve decision), or None when the caller must route through
    the full Scheduler (ineligible tick / churn blow-out)."""

    def __init__(
        self,
        kube,
        cluster,
        compat_cache,
        make_scheduler: Callable,
        options=None,
        clock=None,
        plans_over_limits: Optional[Callable] = None,
        device=None,
    ):
        # the device of every solve and device LP of the tick (the
        # Provisioner's): None is the card (raising without one), as in
        # solver.solve; the host backend runs no device
        self.device = (
            resolve_device(device) if _backend() != "host" else None
        )
        self.kube = kube
        self.cluster = cluster
        self.cache = compat_cache
        # factory(pools_with_types, metrics_controller) -> Scheduler —
        # the provisioner's own full-path construction, reused verbatim
        # for the shadow oracle so the audit compares against exactly
        # what the fallback path would have decided
        self._make_scheduler = make_scheduler
        # Provisioner._plans_over_limits: the admission loop's limit
        # simulation, consumed by the in-envelope shed/cutoff loop
        # (priority.enforce_admission over the incremental core).
        self._plans_over_limits = plans_over_limits
        self.options = options
        self.clock = clock if clock is not None else time.monotonic
        self.churn_max = _env_float(ENV_CHURN_MAX, 0.25)
        # KARPENTER_INCR_AUDIT_EVERY is re-read per access, so a
        # running scheduler can be retuned; assignment still pins it.
        self._audit_every_override: Optional[int] = None
        self._tracker = DirtyTracker(kube)
        self._tracker.watch("Node")
        self._tracker.watch("NodeClaim", key=_claim_keys)
        self._tracker.watch("Pod", key=_pod_node_keys)
        # any DaemonSet change invalidates every node's daemon reserve
        # and the per-pool overhead: one sentinel key = rebuild all
        self._tracker.watch("DaemonSet", key=lambda e, o: ["*"])
        # retained state
        self._inputs: dict = {}            # state key -> ExistingNodeInput
        self._meta: dict[str, _NodeMeta] = {}   # state key -> _NodeMeta
        self._order: list[str] = []        # Scheduler's existing-node order
        self._builder: Optional[NodeInputBuilder] = None
        self._builder_fp: Optional[tuple] = None
        self._daemon_overhead: dict = {}
        self._rsv_in_use: dict[str, int] = {}   # Scheduler.reserved_in_use
        self._has_reserved = False
        # audit / quarantine state
        self._ticks = 0
        self._since_audit = 0
        self._age = 0                      # ticks since last full rebuild
        self._quarantined = False
        self._warm_pending = False   # cold bail taken; next tick warms
        self._force_audit: Optional[str] = None   # pending trigger
        self._last_fault_len = 0
        self._last_audit: dict = {}
        self.divergences: list[dict] = []
        self._counts = {"incremental": 0, "full_backstop": 0,
                        "quarantined": 0, "micro": 0}
        # micro-solve plane: defer rollup + the retained
        # dual certificate the micro batch ordering/defer gate spends
        self._micro_defers: dict[str, int] = {}
        self._micro_active = False
        self._dual = None
        self._dual_stale = True
        # per-reason full-path fallback rollup: status()["fallbacks"]
        # surfaces it so envelope regressions show up at a glance
        self._fallbacks: dict[str, int] = {}
        # which widened-envelope shapes this cache generation has
        # served — the FIRST tick of each shape forces an audit
        self._envelope_seen: set[str] = set()

    # -- knobs ----------------------------------------------------------------

    @property
    def audit_every(self) -> int:
        """Audit cadence, live from the environment on every read so
        bench arms and operators can retune a running scheduler; an
        explicit assignment (tests pinning the cadence) overrides the
        env until reassigned."""
        if self._audit_every_override is not None:
            return self._audit_every_override
        return int(_env_float(ENV_AUDIT_EVERY, 16))

    @audit_every.setter
    def audit_every(self, value) -> None:
        self._audit_every_override = None if value is None else int(value)

    # -- external triggers ----------------------------------------------------

    def on_recover(self) -> None:
        """Crash-recovery hook (Operator._recover): a predecessor's
        retained state died with it, and whatever THIS process has
        accumulated before recovery ran cannot be vouched for either.
        Rebuild from scratch and audit the first incremental tick."""
        self._invalidate(trigger="recovery")

    def _invalidate(self, trigger: str) -> None:
        self._inputs.clear()
        self._meta.clear()
        self._order = []
        if self._builder is not None:
            self._builder = None
            self._builder_fp = None
        self._tracker.clear()
        self._force_audit = trigger
        self._age = 0
        self._envelope_seen.clear()
        self._dual = None
        self._dual_stale = True

    # -- tick -----------------------------------------------------------------

    def _note_fallback(self, reason: str) -> None:
        tracing.annotate(path="full_backstop", reason=reason)
        INCREMENTAL_TICK.inc({"path": "full_backstop", "reason": reason})
        self._counts["full_backstop"] += 1
        self._fallbacks[reason] = self._fallbacks.get(reason, 0) + 1

    def _note_defer(self, reason: str) -> None:
        """Micro-solve defer: the envelope routed a
        debounced arrival batch to the NEXT FULL TICK — nothing solves
        now, the operator re-arms the batcher. Kept distinct from
        fallbacks so readyz separates 'the micro path punted' from
        'the periodic tick left the envelope'."""
        tracing.annotate(path="micro_defer", reason=reason)
        INCREMENTAL_TICK.inc({"path": "micro_defer", "reason": reason})
        self._micro_defers[reason] = self._micro_defers.get(reason, 0) + 1

    def tick(
        self, pods: Sequence[Pod], pools_with_types, micro: bool = False,
    ) -> Optional[SchedulerResults]:
        """One reconcile solve. `micro=True` is the event-driven
        sub-tick path: same retained inputs, same audits,
        but every condition the full-path Scheduler would have to
        finish (ineligible shapes, cold cache, churn blow-out,
        mixed-priority shedding, quarantine) DEFERS to the next full
        tick instead of falling through to a full solve — the micro
        path must never pay O(fleet)."""
        self._micro_active = micro
        if not incremental_enabled():
            if micro:
                self._note_defer("disabled")
            else:
                tracing.annotate(path="full", reason="disabled")
            return None
        if micro and self._quarantined:
            # quarantine falls back to PURE periodic ticks: probation
            # audits belong to the full cadence, not the arrival path
            self._note_defer("quarantined")
            return None
        t0 = self.clock()
        self._ticks += 1
        # fault-injector activity since the last tick distrusts the
        # retained state enough to force an audit: injected kube
        # faults (conflicts, stale lists, watch drops) are exactly the
        # conditions under which dirty-set plumbing can miss a change
        inj = faults.get()
        fault_len = len(inj.snapshot_log()) if inj is not None else 0
        if fault_len != self._last_fault_len:
            self._last_fault_len = fault_len
            if self._force_audit is None:
                self._force_audit = "fault"

        reason = self._ineligible(pods, pools_with_types)
        if reason is not None:
            if micro:
                self._note_defer(reason)
            else:
                self._note_fallback(reason)
            return None

        pools = self._sorted_pools(pools_with_types)
        cold = not self._inputs
        if micro and cold:
            # a cold cache has nothing retained to solve against; the
            # next full tick owns the one-time O(fleet) warm-up — the
            # micro path never pays it (and must not flip the
            # _warm_pending latch the full path's cold bail owns)
            self._note_defer("cold")
            return None
        if (
            cold
            and not self._warm_pending
            # a quarantined (probation) or forced-audit tick must
            # rebuild AND audit now — deferring a tick would leave an
            # unaudited window after recovery/divergence
            and not self._quarantined
            and self._force_audit is None
            and any(not sn.deleting() for sn in self.cluster.nodes())
        ):
            # Cold cache against a live fleet: building every retained
            # input AND paying the full Scheduler's own per-node build
            # in one tick would double the first tick's cost — bail to
            # the full path untouched (<5% cold overhead is a
            # perf-floor guarantee) and warm on the NEXT tick, whose
            # sync is the one-time O(fleet) rebuild.
            self._warm_pending = True
            self._note_fallback("cold")
            return None
        self._warm_pending = False
        # the FIRST tick exercising a newly-widened envelope shape
        # (topology spread / reservations / priority) since the cache
        # was (re)built earns a forced audit: the equality claim for
        # the new machinery is proven live before it is trusted
        shape = set()
        if any(p.spec.topology_spread_constraints for p in pods):
            shape.add("topology")
        if self._has_reserved:
            shape.add("reserved")
        if any(p.spec.priority for p in pods):
            shape.add("priority")
        if any(relaxable(p) for p in pods):
            shape.add("relax")
        if shape - self._envelope_seen:
            self._envelope_seen |= shape
            if self._force_audit is None and not self._quarantined:
                self._force_audit = "envelope"
        churn = self._sync(pools)
        # the poison site fires AFTER sync so a corrupted row is not
        # immediately rebuilt away — the audit must catch it instead
        self._consume_poison()
        # crash window: dirty sets drained (their marks are GONE from
        # the tracker), solve not yet run — a restart must rebuild the
        # cache from the API, not resurrect the drained delta
        faults.fire("crash_incr_solve")
        if pods and not cold and churn > self.churn_max and (
            not self._quarantined
        ):
            if micro:
                self._note_defer("churn")
            else:
                self._note_fallback("churn")
            return None
        if micro and self._dual is not None:
            spend_max = _env_float(ENV_MICRO_SPEND_MAX, 0.0)
            if spend_max > 0:
                try:
                    bound = self._dual.bound_for(group_pods(list(pods)))
                except Exception:
                    bound = 0.0
                if bound > spend_max:
                    # weak duality certifies the batch buys at least
                    # `bound` of fresh capacity — non-trivial spend is
                    # the full tick's call (its repack/consolidation
                    # machinery sees the whole fleet picture)
                    self._note_defer("dual_spend")
                    return None

        from karpenter_tpu_torch.solver import resilience

        # pre-relax preference state, per relaxable pod: relax()
        # REPLACES spec.affinity / the spread-constraint list (never
        # mutates them in place), so holding the old references is a
        # faithful snapshot. The audit restores these before its
        # shadow solve — the oracle must replay the same ladder from
        # the same base, not solve already-relaxed pods.
        prefs = {
            p.key: (p.spec.affinity,
                    tuple(p.spec.topology_spread_constraints))
            for p in pods if relaxable(p)
        }
        resilience.pop_degraded()  # scope the report to THIS solve
        results, fallback = self._solve(pods, pools, micro=micro)
        degraded = resilience.pop_degraded()
        if results is not None and degraded:
            log.warning(
                "incremental solve served degraded via rung(s) %s",
                sorted(set(degraded)),
            )
            results.degraded_rungs = sorted(set(degraded))
        if results is None:
            # the solve left pods only the full path's machinery (the
            # relaxation ladder, the per-pod topology path, priority
            # admission) can finish: hand the whole tick over
            if micro:
                self._note_defer(fallback)
            else:
                self._note_fallback(fallback)
            return None

        self._since_audit += 1
        audit_trigger = self._audit_trigger(pods)
        if audit_trigger is not None:
            ok, shadow = self._audit(pods, pools_with_types, results,
                                     audit_trigger, prefs)
            if not ok:
                # serve the full-solve decision; retained state is
                # already quarantined by _audit. The tick degraded
                # through the ladder's incremental_poison rung — make
                # that visible the same way backend degradations are.
                shadow.degraded_rungs = sorted(
                    set(shadow.degraded_rungs) | {"incremental_poison"}
                )
                faults.fire("crash_incr_commit")
                self._note_explanations(pods, shadow, pools_with_types)
                self._publish_solver_metrics(shadow, t0)
                tracing.annotate(path="quarantined",
                                 reason=audit_trigger)
                INCREMENTAL_TICK.inc({"path": "quarantined",
                                      "reason": audit_trigger})
                self._counts["quarantined"] += 1
                return shadow
            if self._quarantined:
                log.info("incremental cache leaves quarantine: "
                         "probation audit passed")
                self._quarantined = False

        self._age += 1
        INCREMENTAL_FINGERPRINT_AGE.set(float(self._age))
        # crash window: solved, plans not yet handed back for
        # NodeClaim writes
        faults.fire("crash_incr_commit")
        self._note_explanations(pods, results, pools_with_types)
        self._publish_solver_metrics(results, t0)
        path = "micro" if micro else "incremental"
        reason = "audited" if audit_trigger is not None else "steady"
        tracing.annotate(path=path, reason=reason)
        INCREMENTAL_TICK.inc({"path": path, "reason": reason})
        self._counts[path] += 1
        return results

    def _note_explanations(self, pods, results: SchedulerResults,
                           pools_with_types) -> None:
        """Explain-plane parity with the full path: a pod
        left unschedulable by the LIVE serve — incremental fast path
        or the quarantine tick's shadow decision — gets the same
        verdict + elimination funnel the full Scheduler would record,
        through the same module-level seam."""
        if not results.errors:
            return
        from karpenter_tpu_torch.provisioning.priority import PRIORITY_SHED_ERROR
        from karpenter_tpu_torch.provisioning.scheduler import (
            note_unschedulable_explanations,
        )

        # shed pods already carry the richer "shed" verdict from the
        # in-envelope admission loop (stamped after the last re-solve,
        # matching the full path's note ordering) — renoting them here
        # would overwrite it with a generic "unschedulable"
        noted = results
        if any(e == PRIORITY_SHED_ERROR for e in results.errors.values()):
            noted = replace(
                results,
                errors={k: e for k, e in results.errors.items()
                        if e != PRIORITY_SHED_ERROR},
            )
        note_unschedulable_explanations(
            pods, noted, self._sorted_pools(pools_with_types),
            list(self._inputs.values()), self._daemon_overhead,
        )

    def _publish_solver_metrics(self, results: SchedulerResults,
                                t0: float) -> None:
        """Scheduler-subsystem series parity: dashboards watching
        controller="provisioner" must keep reading the live solve no
        matter which path served it."""
        labels = {"controller": "provisioner"}
        SCHEDULER_SCHEDULING_DURATION.observe(self.clock() - t0, labels)
        SCHEDULER_QUEUE_DEPTH.set(0.0, labels)
        SCHEDULER_UNSCHEDULABLE_PODS.set(float(len(results.errors)), labels)

    # -- eligibility ----------------------------------------------------------

    def _ineligible(self, pods, pools_with_types) -> Optional[str]:
        """First reason this tick cannot ride the retained-state fast
        path, or None. Every gate here names machinery only the full
        Scheduler implements — the audit's equality claim holds only
        inside this envelope. Topology SPREAD constraints,
        reservation-holding catalogs and priority-bearing pods are
        expressible (pod affinity / anti-affinity, host ports, volumes,
        DRA, minValues and non-default spot budgets route full)."""
        from karpenter_tpu_torch.utils.pod import has_dra_requirements

        for pod in pods:
            spec = pod.spec
            if spec.volumes or spec.injected_requirements:
                return "volumes"
            if pod_host_ports(pod):
                return "host_ports"
            aff = spec.affinity
            if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
                return "topology"
            if has_dra_requirements(pod):
                return "dra"
        if self.cluster.pods_with_anti_affinity():
            # live pods with required anti-affinity repel matching new
            # pods — only the Topology tracker models that
            return "anti_affinity"
        has_reserved = False
        for pool, types in pools_with_types:
            if _pool_requirements(pool).has_min_values():
                return "min_values"
            if pool_spot_budget(pool) != (1.0, 0):
                return "spot_budget"
            if not has_reserved:
                has_reserved = any(
                    o.is_reserved() for it in types for o in it.offerings
                )
        if has_reserved and not self._allow_reserved():
            # the ReservedCapacity gate strips reserved offerings from
            # the catalog — a per-round InstanceType rebuild the
            # retained fingerprints cannot cache; route full (rare
            # configuration, not worth fast-pathing)
            return "reserved"
        self._has_reserved = has_reserved
        return None

    def _allow_reserved(self) -> bool:
        if self.options is None:
            return True
        return bool(self.options.feature_gates.reserved_capacity)

    @staticmethod
    def _sorted_pools(pools_with_types):
        # weight order, exactly as Scheduler.__init__ sorts
        return sorted(
            pools_with_types,
            key=lambda pt: (-pt[0].spec.weight, pt[0].metadata.name),
        )

    # -- retained-state sync --------------------------------------------------

    def _node_meta(self, sn) -> _NodeMeta:
        labels = dict(sn.labels())
        # rid is extracted UNCONDITIONALLY (two cheap reads): metas
        # survive catalog changes, so a meta rebuilt while the catalog
        # was temporarily reservation-free (an ICE window) must not
        # undercount the ledger once the reservation returns
        rid = _node_reservation_id(sn, labels)
        return _NodeMeta(
            name=sn.name,
            labels=labels,
            taints=tuple(sn.taints()),
            rid=rid,
            node=sn,
        )

    def _sync(self, pools) -> float:
        """Refresh the retained inputs from cluster state, O(dirty).
        Returns the churn fraction (rebuilt rows / fleet)."""
        # node-keyed kinds ride the SCOPED continuity latch: a 410 on
        # one shard's logical stream dirties only the retained keys
        # routed to that shard (None = unscoped relist: everything).
        # DaemonSet relists stay whole-cache — daemon reserves are
        # fleet-wide.
        shards = self._tracker.relisted_shards("Node", "NodeClaim", "Pod")
        rebuild_all = shards is None or self._tracker.relisted("DaemonSet")
        if self._tracker.drain("DaemonSet"):
            rebuild_all = True
        dirty = (
            self._tracker.drain("Node")
            | self._tracker.drain("NodeClaim")
            | self._tracker.drain("Pod")
        )
        if shards and not rebuild_all:
            dirty |= {k for k in self._inputs if shard_of(k) in shards}
            STATE_SHARD_INVALIDATIONS.inc({"layer": "incremental"})
        fp = catalog_fingerprint(pools)
        if rebuild_all or fp != self._builder_fp or self._builder is None:
            # catalog moved (price flip, pool edit, type rebuild): the
            # builder pins the types it resolves min-admissible
            # allocatable from, and the per-pool daemon overhead hangs
            # off the pool templates — rebuild both. Retained NODE
            # inputs survive: they derive from node labels/usage, not
            # prices. rebuild_all (DaemonSet churn or a relist) must
            # ALSO rebuild the builder: it pins the daemonset list it
            # computes per-node reserves and per-pool overhead from,
            # and the catalog fingerprint cannot see daemonsets move.
            daemonsets = self.cluster.daemonsets()
            self._builder = NodeInputBuilder(
                pools, daemonsets,
                self.options.ignore_dra_requests
                if self.options is not None else True,
            )
            self._builder_fp = fp
            self._daemon_overhead = self._builder.daemon_overhead()
            # a catalog move invalidates the dual certificate: its
            # duals were Farley-scaled against the OLD prices
            self._dual = None
            self._dual_stale = True
        if rebuild_all:
            self._inputs.clear()
            self._meta.clear()
            self._age = 0

        rebuilt = 0
        live: list[str] = []
        inflight: list[tuple[tuple, str]] = []
        seen: set[str] = set()
        deleting_rids: list[str] = []
        for sn in self.cluster.nodes():
            if sn.deleting():
                # a deleting node holds its reservation instance until
                # it is gone (reservationmanager.go) — the ledger must
                # count it even though no retained row exists for it
                if self._has_reserved:
                    rid = _node_reservation_id(sn, sn.labels())
                    if rid:
                        deleting_rids.append(rid)
                continue
            key = _state_node_key(sn)
            if not key:
                continue
            seen.add(key)
            # in-flight/unlaunched entries are few and transition-heavy
            # (claim -> node identity, registration filling status):
            # rebuild them every tick instead of chasing edge cases.
            # Their rebuilds do NOT count toward churn — a scale-up
            # burst with many in-flight claims is exactly when the
            # incremental path saves the most, and counting the
            # always-rebuilt volatile rows would wedge it on the
            # churn backstop for the whole materialization window.
            volatile = sn.node is None or not sn.registered()
            if key not in self._inputs or key in dirty or volatile:
                self._builder.invalidate(key)
                self._inputs[key] = self._builder.existing_input(sn)
                self._meta[key] = self._node_meta(sn)
                if not volatile:
                    rebuilt += 1
            if sn.initialized():
                live.append(key)
            else:
                inflight.append(((len(sn.pod_keys), sn.name), key))
        for key in [k for k in self._inputs if k not in seen]:
            del self._inputs[key]
            self._meta.pop(key, None)
            self._builder.invalidate(key)
        inflight.sort()
        self._order = live + [key for _, key in inflight]
        # the reservation ledger, exactly as Scheduler.__init__ builds
        # it: live usage (every node holding a reservation id, incl.
        # deleting ones) bounds how many more instances a round may
        # open. Retained rids for live rows; deleting rows scanned
        # fresh above (few). Reservation-free catalogs skip all of it.
        if self._has_reserved:
            rsv: dict[str, int] = {}
            for meta in self._meta.values():
                if meta.rid:
                    rsv[meta.rid] = rsv.get(meta.rid, 0) + 1
            for rid in deleting_rids:
                rsv[rid] = rsv.get(rid, 0) + 1
            self._rsv_in_use = rsv
        else:
            self._rsv_in_use = {}
        return rebuilt / max(1, len(self._inputs))

    def _consume_poison(self) -> None:
        try:
            faults.fire("incremental")
        except faults.CachePoisonError as err:
            if not self._inputs:
                log.warning("cache_poison fired on an empty retained "
                            "state; nothing to corrupt (%s)", err)
                return
            victim = min(self._inputs)
            inp = self._inputs[victim]
            # phantom capacity: the corrupted row looks roomy, so the
            # incremental solve places pods the full solve would buy a
            # node for — a real stale-cache failure mode, deterministic
            self._inputs[victim] = replace(
                inp,
                available=resutil.merge(
                    inp.available, {"cpu": 1024.0, "memory": 2.0**42}
                ),
            )
            log.warning("fault injected: %s (corrupted retained row %s)",
                        err, victim)
            if self._force_audit is None:
                self._force_audit = "fault"

    # -- solve ----------------------------------------------------------------

    def _solve(
        self, pods: Sequence[Pod], pools, micro: bool = False,
    ) -> tuple[Optional[SchedulerResults], str]:
        """One incremental solve: the batched core, then — exactly
        when the full path's admission loop would act — the shared
        priority shed/cutoff loop re-solving the admitted prefix
        through the same core. Returns (results, "") or (None,
        reason) when only the full path's machinery can finish."""
        results, reason = self._solve_core(pods, pools)
        if results is None:
            return None, reason
        if self._priority_overloaded(pods, results):
            if micro:
                # a mixed-priority capacity failure is the shed loop's
                # case; shedding belongs to the full tick —
                # a micro batch must never half-shed the backlog
                return None, "priority"
            return self._enforce_admission(pods, pools, results)
        return results, ""

    def _enforce_admission(
        self, pods, pools, results,
    ) -> tuple[Optional[SchedulerResults], str]:
        """Provisioner._enforce_priority_admission's shed/cutoff loop
        (provisioning/priority.py), in-envelope: the admitted prefix
        re-solves through the incremental core instead of a fresh full
        Scheduler. A re-solve that escapes the envelope mid-loop
        (timeout, topology lowering fallback) hands the WHOLE tick to
        the full path — a half-shed decision must never serve."""
        from karpenter_tpu_torch.provisioning import priority as padm

        # first shed on this cache generation earns a forced audit,
        # like every other newly-widened envelope shape
        if "shed" not in self._envelope_seen:
            self._envelope_seen.add("shed")
            if self._force_audit is None and not self._quarantined:
                self._force_audit = "envelope"

        def solve_fn(keep):
            res, reason = self._solve_core(keep, pools)
            if res is None:
                raise _EnvelopeEscape(reason)
            return res

        try:
            results = padm.enforce_admission(
                list(pods), pools, results, solve_fn,
                plans_over_limits=self._plans_over_limits,
                daemon_overhead=lambda: self._daemon_overhead,
            )
        except _EnvelopeEscape as esc:
            return None, esc.reason
        return results, ""

    def _solve_core(
        self, pods: Sequence[Pod], pools,
    ) -> tuple[Optional[SchedulerResults], str]:
        """The batched fast path against the retained inputs —
        mirroring Scheduler._solve's structure: the simple pods ride
        one batched solve (+ eviction retries + per-pod relaxation),
        topology-spread pods ride the lowered topo_batch solve against
        a Topology built from the retained domain columns, and the
        round's reservation ledger is debited across both phases.
        Returns (results, "") or (None, reason) when only the full
        path's machinery can finish the tick."""
        results = SchedulerResults(new_node_plans=[],
                                   existing_assignments={})
        if not pods:
            return results, ""
        work = dict(self._inputs)   # per-tick view; commits copy-on-write
        open_plans: list = []
        # same wall budget the full Scheduler's _solve enforces; a
        # blown budget hands the WHOLE tick to the full path, which
        # owns the TIMEOUT_ERROR semantics (stamping partial timeouts
        # here would make the audit's fingerprint comparison racy)
        deadline = self.clock() + SOLVE_TIMEOUT_SECONDS
        # reservation budget for THIS round: live usage plus every
        # plan opened during the round (Scheduler's round_in_use)
        round_in_use: dict[str, int] = dict(self._rsv_in_use)

        # split exactly as Scheduler._solve routes: topology-spread
        # pods run the lowered batch; everything else is the fast
        # path. (Pod affinity/anti-affinity, volumes, host ports and
        # DRA made the whole tick ineligible already.)
        simple = [p for p in pods
                  if not p.spec.topology_spread_constraints]
        complex_ = [p for p in pods if p.spec.topology_spread_constraints]

        ok, reason = self._solve_simple(
            simple, pools, work, open_plans, results, round_in_use,
            deadline,
        )
        if not ok:
            return None, reason
        if complex_:
            topology = self._build_topology(pods, pools)
            # fast-path plans' pods enter the topology tracker before
            # the lowered solve, exactly as Scheduler._solve registers
            # its open plans after the fast path drains
            for plan in open_plans:
                for pod in plan.pods:
                    topology.register(
                        pod, plan_domains(plan),
                        source_taints=tuple(
                            plan.pool.spec.template.spec.taints),
                    )
            ok, reason = self._solve_topology(
                complex_, pools, topology, work, open_plans, results,
                round_in_use, deadline,
            )
            if not ok:
                return None, reason

        for plan in open_plans:
            finalize_plan(plan)
            results.new_node_plans.append(plan)
        return results, ""

    def _solve_simple(
        self, place, pools, work, open_plans, results, round_in_use,
        deadline,
    ) -> tuple[bool, str]:
        place = list(place)
        still_failed: list[Pod] = []
        for _ in range(1 + RETRY_ROUNDS):
            if not place:
                break
            if self.clock() > deadline:
                return False, "timeout"
            groups = group_pods(place)
            chosen = self._pruned_keys(groups, work)
            enc = encode(
                groups, pools,
                [work[k] for k in chosen],
                self._daemon_overhead,
                reserved_in_use=round_in_use,
                compat_cache=self.cache,
            )
            if (
                self._dual_stale
                and not self._micro_active
                and _env_on(ENV_MICRO_DUAL, "0")
            ):
                # refresh the micro path's dual certificate from a
                # FULL tick's encode (never a micro batch: its demand
                # axis is a sliver of the backlog) — opt-in, degrades
                # to None and the micro path runs arrival-ordered
                from karpenter_tpu_torch.solver.incremental import (
                    build_dual_floor,
                )

                self._dual = build_dual_floor(enc, device=self.device)
                self._dual_stale = False
            sol = solve_encoded(enc, device=self.device)
            self._commit_existing(sol, chosen, work, results)
            open_plans.extend(sol.new_nodes)
            _debit_reservations(sol.new_nodes, round_in_use)
            evicted_keys = {p.key for p in sol.evicted}
            still_failed.extend(
                p for p in sol.unschedulable if p.key not in evicted_keys
            )
            # k-way-evicted pods are schedulable alone: retry them
            # against the committed state (mirrors Scheduler._solve)
            place = list(sol.evicted)
        still_failed.extend(place)  # retry bound hit

        for pod in still_failed:
            # Scheduler._solve's relaxation block, in-envelope: one
            # rung stripped, one solo required-only retry
            # against the committed round state. The incremental path
            # serves only the live provisioner tick, which always
            # honors preferences, so the mutation-then-retry sequence
            # is byte-identical to what the full path would run — the
            # audit restores pre-relax preferences before its shadow
            # solve so the oracle replays the same ladder steps.
            if self.clock() > deadline:
                return False, "timeout"
            retried = False
            relaxed = relax(pod)
            if relaxed:
                self._note_relax(pod, relaxed)
                groups = group_pods([pod], required_only=True)
                chosen = self._pruned_keys(groups, work)
                enc = encode(
                    groups, pools,
                    [work[k] for k in chosen],
                    self._daemon_overhead,
                    reserved_in_use=round_in_use,
                    compat_cache=self.cache,
                )
                retry = solve_encoded(enc, device=self.device)
                if not retry.unschedulable:
                    self._commit_existing(retry, chosen, work, results)
                    open_plans.extend(retry.new_nodes)
                    _debit_reservations(retry.new_nodes, round_in_use)
                    retried = True
                    if self._explaining():
                        from karpenter_tpu_torch import explain

                        explain.note_pod(
                            pod.key, verdict="scheduled-after-relax",
                            relax_unlocked=relaxed,
                        )
            if not retried:
                results.errors[pod.key] = NO_CAPACITY_ERROR
        return True, ""

    def _explaining(self) -> bool:
        """The incremental tick serves only the LIVE provisioning
        solve, so unlike Scheduler._explaining there is no controller
        gate — an open explain record is the whole condition."""
        from karpenter_tpu_torch import explain

        return explain.active() is not None

    def _note_relax(self, pod: Pod, step: str) -> None:
        if self._explaining():
            from karpenter_tpu_torch import explain

            explain.note_relax(pod.key, step)

    def _commit_existing(self, sol, chosen, work, results) -> None:
        for a in sol.existing:
            key = chosen[a.existing_index]
            results.existing_assignments.setdefault(key, []).extend(
                a.pods
            )
            inp = work[key]
            usage = resutil.requests_for_pods(a.pods)
            work[key] = replace(
                inp,
                available=resutil.positive(
                    resutil.subtract(inp.available, usage)
                ),
                pod_count=inp.pod_count + len(a.pods),
            )
            # the committed row is provisional until the pods bind;
            # rebuild it from cluster truth next tick
            self._tracker.mark("Node", key)

    # -- topology phase --------------------------------------------

    def _build_topology(self, pods, pools) -> Topology:
        """The Topology the full Scheduler would build, derived from
        the RETAINED domain columns instead of a per-round walk that
        re-parses every node's labels: pool/type domains (O(catalog),
        both paths pay it), per-node domain + taint provenance from
        `_NodeMeta` (maintained O(dirty)), and pod->domain mappings
        read through the retained labels. Only ticks that actually
        carry topology constraints build one."""
        from karpenter_tpu_torch.scheduling.requirement import IN
        from karpenter_tpu_torch.solver.encode import pool_template_requirements

        domains: dict[str, set] = {}
        domain_taints: dict[str, dict[str, list]] = {}

        def record(key: str, value: str, taints) -> None:
            domains.setdefault(key, set()).add(value)
            domain_taints.setdefault(key, {}).setdefault(value, []).append(
                tuple(taints)
            )

        for pool, types in pools:
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
        for key in self._order:
            meta = self._meta.get(key)
            if meta is None:
                continue
            for lk, lv in meta.labels.items():
                record(lk, lv, meta.taints)
            if meta.name:
                record(HOSTNAME_LABEL, meta.name, meta.taints)
            mapping = dict(meta.labels)
            mapping[HOSTNAME_LABEL] = meta.name
            for pod_key in meta.node.pod_keys:
                pod_domains[pod_key] = mapping
        scheduled = [p for p in self.kube.pods() if p.spec.node_name]
        return Topology(
            domains=domains,
            cluster_pods=scheduled,
            pending_pods=list(pods),
            pod_domains=pod_domains,
            honor_schedule_anyway=True,
            domain_taints=domain_taints,
        )

    def _solve_topology(
        self, complex_, pools, topology, work, open_plans, results,
        round_in_use, deadline,
    ) -> tuple[bool, str]:
        """Scheduler._solve's lowered-topology block against the
        retained rows. Anything the lowering cannot express (per-pod
        fallback, deferred pods, plan joins with no fitting type)
        hands the whole tick to the full path — the per-pod topology
        loop and its relaxation ladder live only there."""
        if self.clock() > deadline:
            return False, "timeout"
        plan_refs = []
        plan_inputs = []
        for plan in open_plans:
            inp = plan_pseudo_input(plan, self._daemon_overhead)
            if inp is not None:
                plan_refs.append(plan)
                plan_inputs.append(inp)
        row_keys = [k for k in self._order if k in work]
        existing_rows = [work[k] for k in row_keys]
        existing_all = existing_rows + plan_inputs
        tb = topo_batch.prepare(complex_, topology, existing_all, {})
        results.errors.update(tb.errors)
        if tb.fallback:
            return False, "topology"
        if not tb.groups:
            return True, ""
        enc = encode(
            tb.groups, pools, existing_all, self._daemon_overhead,
            reserved_in_use=round_in_use,
            group_cap=tb.group_cap,
            conflict=tb.conflict,
            existing_quota=tb.existing_quota,
            compat_cache=self.cache,
        )
        sol = solve_encoded(enc, device=self.device)
        n_before = len(open_plans)
        open_plans.extend(sol.new_nodes)
        _debit_reservations(sol.new_nodes, round_in_use)
        E = len(existing_rows)
        deferred: list[Pod] = []
        for a in sol.existing:
            if a.existing_index >= E:
                # pods joined an open fast-path plan: narrow its
                # options to types that hold the enlarged pod set and
                # admit the new pods' requirements (the in-flight
                # NodeClaim re-filter, nodeclaim.go:373-447)
                plan = plan_refs[a.existing_index - E]
                used = resutil.merge(
                    self._daemon_overhead.get(plan.pool.metadata.name, {}),
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
                    if any(it.offerings and o in it.offerings
                           for it in fitting)
                ] or plan.offerings
                plan.pods.extend(a.pods)
                domains = plan_domains(plan)
                for p in a.pods:
                    chosen = dict(domains)
                    chosen.update(tb.assignments.get(p.key, {}))
                    topology.register(p, chosen)
                continue
            key = row_keys[a.existing_index]
            results.existing_assignments.setdefault(key, []).extend(
                a.pods
            )
            inp = work[key]
            usage = resutil.requests_for_pods(a.pods)
            work[key] = replace(
                inp,
                available=resutil.positive(
                    resutil.subtract(inp.available, usage)
                ),
                pod_count=inp.pod_count + len(a.pods),
            )
            self._tracker.mark("Node", key)
            meta = self._meta.get(key)
            labels = dict(meta.labels) if meta is not None else {}
            labels[HOSTNAME_LABEL] = key
            for p in a.pods:
                chosen = dict(labels)
                chosen.update(tb.assignments.get(p.key, {}))
                topology.register(p, chosen)
        for plan in open_plans[n_before:]:
            domains = plan_domains(plan)
            for p in plan.pods:
                chosen = dict(domains)
                chosen.update(tb.assignments.get(p.key, {}))
                topology.register(p, chosen)
        deferred.extend(sol.unschedulable)
        if deferred:
            return False, "topology"
        return True, ""

    # -- micro-batch ordering --------------------------------------

    def micro_order(self, pods: Sequence[Pod]) -> list[Pod]:
        """`_DualFloor` reduced-cost ordering for a debounced micro
        batch: cheapest certified placements first, so a truncated
        batch spends its window on the pods the duals price as easy
        wins. The operator applies this BEFORE handing the batch to
        tick(), so the shadow audit sees the identical pod order and
        the equality claim is untouched. Without a certificate
        (KARPENTER_MICRO_DUAL off, or no full solve yet) arrival
        order stands; ties keep arrival order (stable sort)."""
        pods = list(pods)
        dual = self._dual
        if dual is None or len(pods) < 2:
            return pods
        try:
            price: dict[str, float] = {}
            for g in group_pods(pods):
                sig = (
                    g.requirements.signature(),
                    g.tolerations,
                    tuple(sorted(g.resources.items())),
                )
                lam = dual.lam_by_sig.get(sig, 0.0)
                for p in g.pods:
                    price[p.key] = lam
            return sorted(pods, key=lambda p: price.get(p.key, 0.0))
        except Exception:
            return pods

    # -- priority overload gate ------------------------------------

    def _priority_overloaded(self, pods, results) -> bool:
        """True exactly when the full path's priority admission loop
        would act: mixed priorities AND a capacity-class failure (the
        solve's own no-capacity error, or a plan NodePool limits
        would reject at create). Healthy mixed-priority ticks (the
        common case) pay one scan and serve incrementally."""
        from karpenter_tpu_torch.provisioning.priority import mixed_priorities

        if not mixed_priorities(list(pods)):
            return False
        if any(
            err == NO_CAPACITY_ERROR for err in results.errors.values()
        ):
            return True
        if (
            self._plans_over_limits is not None
            and any(p.pool.spec.limits for p in results.new_node_plans)
        ):
            return bool(self._plans_over_limits(results.new_node_plans))
        return False

    def _pruned_keys(self, groups, work: dict) -> list[str]:
        """Residual prune (exact, from IncrementalPipeline): a node
        below the componentwise MINIMUM request over keys EVERY group
        demands can hold none of them, and nodes only fill during a
        solve — dropping it preserves first-feasible order while
        shrinking the bound axis to nodes with real headroom. Survivors
        keep `self._order` — the Scheduler's existing-node axis order
        (live nodes in cluster order, in-flight fewest-pods-first) —
        so placements stay byte-identical with the full path's."""
        min_req: dict[str, float] = {}
        req_counts: dict[str, int] = {}
        for g in groups:
            for k, v in g.resources.items():
                if v <= 0:
                    continue
                req_counts[k] = req_counts.get(k, 0) + 1
                have = min_req.get(k)
                min_req[k] = v if have is None else min(have, v)
        min_req = {
            k: v for k, v in min_req.items()
            if req_counts[k] == len(groups)
        }
        out = []
        for key in self._order:
            inp = work.get(key)
            if inp is None:
                continue
            # float32-scale margin: the prune runs in float64 host
            # arithmetic while the kernel judges fits in float32 — a
            # boundary-exact fill (4x0.8 on a 4.0 node leaves
            # 0.7999999999999994) reads as "full" here but as exactly
            # 0.8f on device. Prune only nodes the kernel could never
            # accept; a kept-but-infeasible row is a no-op column.
            if any(
                inp.available.get(k, 0.0) < v * (1.0 - 1e-6)
                for k, v in min_req.items()
            ):
                continue
            out.append(key)
        return out

    # -- oracle audit ---------------------------------------------------------

    def _audit_trigger(self, pods) -> Optional[str]:
        if not pods:
            return None   # empty decisions compare trivially equal
        if self._quarantined:
            return "probation"
        if self._force_audit is not None:
            trigger = self._force_audit
            self._force_audit = None
            return trigger
        if self.audit_every > 0 and self._since_audit >= self.audit_every:
            return "cadence"
        return None

    def _audit(
        self, pods, pools_with_types, results: SchedulerResults,
        trigger: str, prefs: Optional[dict] = None,
    ) -> tuple[bool, SchedulerResults]:
        """Shadow full solve + decision fingerprint diff. On
        divergence: quarantine the retained state, record the episode
        for replay, and hand back the shadow decision."""
        from karpenter_tpu_torch.provisioning import priority as padm

        self._since_audit = 0
        # undo the live solve's relaxation mutations: the shadow must
        # climb the same ladder from the same pre-tick base (it then
        # deterministically re-applies the identical rungs, so the
        # pods end the audit in the same state the live solve left)
        if prefs:
            for pod in pods:
                saved = prefs.get(pod.key)
                if saved is not None:
                    pod.spec.affinity = saved[0]
                    pod.spec.topology_spread_constraints = list(saved[1])

        def shadow_solve(keep):
            return self._make_scheduler(
                pools_with_types, "incremental_audit"
            ).solve(list(keep))

        shadow = shadow_solve(pods)
        # the full path wraps its solve in the admission loop; the
        # shadow must too, or an in-envelope shed tick would diff
        # against an unshed oracle. note=False: the live serve already
        # counted the shed metrics/explanations.
        shadow = padm.enforce_admission(
            list(pods), pools_with_types, shadow, shadow_solve,
            plans_over_limits=self._plans_over_limits,
            daemon_overhead=lambda: self._daemon_overhead,
            note=False,
        )
        want = decision_fingerprint(shadow)
        got = decision_fingerprint(results)
        ok = want == got
        self._last_audit = {
            "verdict": "ok" if ok else "divergence",
            "trigger": trigger,
            "tick": self._ticks,
        }
        INCREMENTAL_AUDITS.inc(
            {"verdict": self._last_audit["verdict"], "trigger": trigger}
        )
        if ok:
            return True, shadow
        INCREMENTAL_DIVERGENCE.inc()
        inj = faults.get()
        record = {
            "tick": self._ticks,
            "trigger": trigger,
            "incremental": got,
            "full": want,
            # the fired-fault log up to the divergence: replaying the
            # same spec + seed + workload reproduces this episode
            # byte-identically (FaultInjector.snapshot_log)
            "fault_log": inj.snapshot_log() if inj is not None else [],
        }
        self.divergences.append(record)
        del self.divergences[:-MAX_DIVERGENCE_RECORDS]
        log.error(
            "incremental oracle audit diverged (trigger=%s); "
            "quarantining retained state and serving the full-solve "
            "decision", trigger,
        )
        from karpenter_tpu_torch.solver import resilience

        resilience.note_incremental_poison()
        self._quarantined = True
        self._invalidate(trigger="quarantine")
        # probation (the _quarantined gate) owns the follow-up audits;
        # leaving the force flag set would fire one extra shadow solve
        # AFTER probation clears, with a trigger label outside the
        # metric's documented set
        self._force_audit = None
        self.cache.invalidate()
        return False, shadow

    # -- observability --------------------------------------------------------

    def state_fingerprint(self) -> str:
        """Stable hash of the retained inputs — readyz surfaces it so
        two replicas (or a pre/post-restart pair) can be compared."""
        import hashlib

        rows = sorted(
            (
                key,
                inp.pool_name,
                inp.pod_count,
                tuple(sorted(
                    (k, round(v, 6)) for k, v in inp.available.items()
                )),
            )
            for key, inp in self._inputs.items()
        )
        return hashlib.sha256(repr(rows).encode()).hexdigest()

    def status(self) -> dict:
        return {
            "enabled": incremental_enabled(),
            "quarantined": self._quarantined,
            "retained_nodes": len(self._inputs),
            "fingerprint": self.state_fingerprint(),
            "fingerprint_age_ticks": self._age,
            "last_audit": dict(self._last_audit),
            "divergences": len(self.divergences),
            "ticks": dict(self._counts),
            # per-reason full-path fallback rollup (the
            # karpenter_incremental_tick_total{path="full_backstop",
            # reason} series as a readyz digest)
            "fallbacks": dict(self._fallbacks),
            # event-driven micro-solve rollup: served count
            # rides ticks["micro"]; defers are per-reason, mirroring
            # karpenter_incremental_tick_total{path="micro_defer"}
            "micro": {
                "served": self._counts["micro"],
                "deferred": dict(self._micro_defers),
                "dual_certificate": self._dual is not None,
            },
        }


def _node_reservation_id(sn, labels: dict[str, str]) -> str:
    """The reservation a node consumes — its label once launched, or
    the pinned claim requirement before launch (exactly the two reads
    Scheduler.__init__'s ledger loop does)."""
    rid = labels.get(RESERVATION_ID_LABEL, "")
    if not rid and sn.node_claim is not None:
        for spec in sn.node_claim.spec.requirements:
            if spec.key == RESERVATION_ID_LABEL and spec.values:
                rid = spec.values[0]
                break
    return rid


def _debit_reservations(plans, round_in_use: dict[str, int]) -> None:
    """Scheduler._debit_reservations, for the incremental round's
    ledger: each plan opened against a reservation consumes one
    instance for the remainder of the tick."""
    for plan in plans:
        rid = getattr(plan, "reservation_id", "")
        if rid:
            round_in_use[rid] = round_in_use.get(rid, 0) + 1
