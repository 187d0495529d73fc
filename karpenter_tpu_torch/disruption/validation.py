"""Disruption command validation.

Copy of `karpenter_tpu/disruption/validation.py`, whole, with its
imports pointed into `karpenter_tpu_torch`.

Counterpart of pkg/controllers/disruption/validation.go:52-316: a
command is computed against a snapshot, and cluster state moves on
while replacements launch. Before the orchestration queue executes the
candidate deletions it re-verifies, against *current* state:

- every candidate's claim still exists, nothing re-armed
  do-not-disrupt (node or pods), and no candidate was nominated for a
  pod during validation (validation.go:242-246),
- no freshly-arrived pod on a candidate is PDB-blocked,
- per-pool budgets still admit the deletions (candidates' own
  marked-for-deletion state is excluded from the deleting count so the
  command doesn't collide with itself),
- for consolidation commands, the ECONOMICS still hold: each launched
  replacement is priced at its ACTUAL materialized offering (the node
  exists by validation time; not the plan's optimistic minimum), the
  offering must still exist in the current catalog, and the total must
  stay strictly below the candidates' current (re-priced) cost — the
  reference gets this via re-running computeConsolidation's price
  filter after the TTL (validation.go:256-316); here prices are
  re-resolved directly,
- for consolidation commands older than the TTL, the scheduling
  simulation is RE-RUN against current state (validateCommand,
  validation.go:262-310) using the candidates' LIVE pod sets (pods
  that bound after compute time included, since-gone pods excluded —
  the reference rebuilds candidates the same way): every candidate pod
  must still be reschedulable, and because the launched replacements
  already count as existing capacity, NO new node may be needed for
  them — needing one means the cluster changed underneath the
  decision.

Raises ValidationError -> the queue rolls the command back (un-taints
candidates and deletes replacement claims that never took load — the
reference launches replacements only after validation, so execution-
time validation must clean up what early launch created). Transient
infrastructure failures (catalog fetch blips) raise ValidationRetry
instead: the queue keeps the command and re-validates next cycle,
bounded by its retry deadline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, TYPE_CHECKING

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    DO_NOT_DISRUPT_ANNOTATION,
    INSTANCE_TYPE_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodepool import (
    REASON_DRIFTED,
    REASON_INTERRUPTED,
    REASON_UNDERUTILIZED,
)
from karpenter_tpu_torch.utils.pdb import PdbLimits

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.disruption.engine import Command, DisruptionEngine
    from karpenter_tpu_torch.kube.objects import Pod

# The reference re-validates after this TTL (validation.go consolidationTTL);
# in the tick-driven runtime validation happens at execution time, which is
# at least one queue cycle after computation. Commands validated within the
# TTL skip the (expensive) re-simulation but never the price re-check.
VALIDATION_TTL_SECONDS = 15.0


class ValidationError(Exception):
    """The command is stale; roll it back."""


class ValidationRetry(Exception):
    """Validation could not complete (transient failure); try again."""


class Validator:
    def __init__(self, engine: "DisruptionEngine"):
        self.engine = engine

    def validate_for_execution(self, command: "Command",
                               now: Optional[float] = None) -> None:
        """Raises ValidationError (roll back) / ValidationRetry
        (defer). An invalid verdict is a DECISION about the command's
        candidates — the explain plane records it on each of them
        (`kept:validation-failed`, carrying the validator's own
        message) before the queue rolls the command back."""
        try:
            self._validate_for_execution(command, now)
        except ValidationError as err:
            from karpenter_tpu_torch import explain

            for candidate in command.candidates:
                explain.note_candidate(
                    candidate.state_node.name, explain.KEPT_VALIDATION,
                    reason=str(err), command=command.reason,
                )
            raise

    def _validate_for_execution(self, command: "Command",
                                now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        kube = self.engine.kube
        if command.reason == REASON_INTERRUPTED:
            # forced reclaim: the cloud takes the capacity whether the
            # drain happens or not, so graceful pod-block rules
            # (do-not-disrupt, PDBs, nominations) and disruption
            # budgets never veto — a planned drain strictly dominates
            # the forced one. Only existence is checked: a vanished
            # claim means there is nothing left to drain.
            for candidate in command.candidates:
                claim = candidate.state_node.node_claim
                if claim is None or kube.get_node_claim(
                    claim.metadata.name
                ) is None:
                    raise ValidationError(
                        f"interrupted candidate "
                        f"{candidate.state_node.name} claim vanished"
                    )
            return
        pdb = PdbLimits(kube)
        # Execution-time revalidation applies the GRACEFUL pod-block
        # rules, and the reference runs it for CONSOLIDATION commands
        # only (queue.go validation; validation.go:224-225 hardcodes
        # GracefulDisruptionClass). A drift candidate whose claim
        # carries a TerminationGracePeriod was admitted as EVENTUAL —
        # re-judging it gracefully would invalidate it the moment a
        # do-not-disrupt pod exists, which is exactly the case TGP is
        # for. The gate is PER CANDIDATE (the reference's
        # eventualDisruptionCandidate is evaluated per NodeClaim,
        # types.go): a command mixing TGP and non-TGP candidates keeps
        # graceful re-checks on the non-TGP ones only.
        def _eventual(candidate) -> bool:
            claim = candidate.state_node.node_claim
            return (
                command.reason == REASON_DRIFTED
                and claim is not None
                and claim.spec.termination_grace_period is not None
            )
        # live (current) reschedulable pods per candidate, rebuilt from
        # state the way the reference's validateCandidates re-runs
        # GetCandidates: pods that bound after compute time are counted,
        # since-terminated pods are not
        live_pods: dict[str, list["Pod"]] = {}
        for candidate in command.candidates:
            eventual = _eventual(candidate)
            node = candidate.state_node
            claim = node.node_claim
            if claim is None or kube.get_node_claim(claim.metadata.name) is None:
                raise ValidationError(
                    f"candidate {node.name} claim vanished"
                )
            if node.annotations().get(DO_NOT_DISRUPT_ANNOTATION) == "true":
                raise ValidationError(f"candidate {node.name} re-armed do-not-disrupt")
            live = self.engine.cluster.node_for_name(node.name)
            if live is not None and live.nominated(now):
                # a pod was nominated onto the candidate while the
                # command was in flight (validation.go:242-246)
                raise ValidationError(
                    f"candidate {node.name} was nominated during validation"
                )
            pod_keys = live.pod_keys if live is not None else node.pod_keys
            live_pods[node.name] = []
            for pod_key in pod_keys:
                pod = kube.get_pod(*pod_key.split("/", 1))
                if pod is None or pod.is_terminal() or pod.is_terminating():
                    continue
                # blocking checks BEFORE the daemonset skip, mirroring
                # _build_candidate: a daemonset pod freshly armed with
                # do-not-disrupt (or a PDB dropping to zero) must fail
                # revalidation just like it would fail admission
                if (
                    pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION)
                    == "true"
                    and not eventual
                ):
                    raise ValidationError(
                        f"pod {pod_key} on candidate {node.name} is do-not-disrupt"
                    )
                if pdb.can_evict(pod) is not None and not eventual:
                    raise ValidationError(
                        f"pod {pod_key} on candidate {node.name} is PDB-blocked"
                    )
                if pod.owner_kind() == "DaemonSet":
                    continue
                live_pods[node.name].append(pod)
        # budgets against current state, excluding this command's own marks
        needed: dict[str, int] = {}
        for candidate in command.candidates:
            pool = candidate.node_pool.metadata.name
            needed[pool] = needed.get(pool, 0) + 1
        # the same accounting as admission (engine.budget_mapping —
        # uninitialized/terminating excluded from the total, NotReady +
        # deleting consume), with this command's own candidates carved
        # out so it can't collide with its own marks
        candidate_node_names = frozenset(
            c.state_node.name for c in command.candidates
        )
        budgets = self.engine.budget_mapping(
            command.reason, now, exclude_names=candidate_node_names
        )
        for pool_name, count in needed.items():
            if kube.get_node_pool(pool_name) is None:
                raise ValidationError(f"nodepool {pool_name} vanished")
            if budgets.get(pool_name, 0) < count:
                raise ValidationError(f"budget for nodepool {pool_name} closed")
        if command.reason == REASON_UNDERUTILIZED:
            self._validate_economics(command)
            if command.started_at and now - command.started_at >= VALIDATION_TTL_SECONDS:
                self._validate_resimulation(command, live_pods)

    # -- consolidation economics re-check ----------------------------------

    def _fresh_catalog(self, cache: dict, pool_name: str,
                       available_only: bool = False) -> dict:
        """(instance-type, zone, capacity-type) -> current price, from a
        fresh provider fetch. With available_only, offerings absent from
        the result have vanished FOR NEW LAUNCHES (sold out / retired)
        since the command was computed — availability gates
        launchability, never the price of a node that already exists.
        A fetch failure is transient -> ValidationRetry, not rollback."""
        key = (pool_name, available_only)
        if key not in cache:
            try:
                cache[key] = self.engine.offering_price_index(
                    pool_name, available_only=available_only
                )
            except Exception as err:
                raise ValidationRetry(
                    f"catalog re-fetch failed for pool {pool_name}: {err}"
                )
        return cache[key]

    def _replacement_price(self, cache: dict, plan) -> float:
        """Current price of one replacement plan. By validation time the
        plan's claim has materialized into a node with concrete
        instance-type/zone/capacity-type labels — price THAT offering
        (an optimistic min over surviving fallbacks would mask an
        expensive actual launch). The running node's offering may have
        gone unavailable for NEW launches without affecting it, so the
        lookup uses the full catalog; an offering gone entirely keeps
        the plan's computed price (same tolerance the candidate side
        gets). Falls back to the cheapest surviving LAUNCHABLE planned
        offering only while the node's labels are unknown."""
        state_node = self.engine.cluster.node_for_key(plan.claim_name)
        if state_node is not None:
            labels = state_node.labels()
            key = (
                labels.get(INSTANCE_TYPE_LABEL, ""),
                labels.get(TOPOLOGY_ZONE_LABEL, ""),
                labels.get(CAPACITY_TYPE_LABEL, ""),
            )
            if all(key):
                prices = self._fresh_catalog(cache, plan.pool.metadata.name)
                cur = prices.get(key)
                return plan.price if cur is None else cur
        prices = self._fresh_catalog(
            cache, plan.pool.metadata.name, available_only=True
        )
        surviving = []
        for it in plan.instance_types:
            for off in it.offerings:
                if off not in plan.offerings:
                    continue
                cur = prices.get((it.name, off.zone, off.capacity_type))
                if cur is not None:
                    surviving.append(cur)
        if not surviving:
            raise ValidationError(
                "replacement offerings vanished for a planned node"
            )
        return min(surviving)

    def _validate_economics(self, command: "Command") -> None:
        """Replacements at their current (actual-launch) prices must
        stay STRICTLY below the candidates' current price — prices move
        between compute and execute (validation.go:297-310 guards the
        same regression through the instance-type subset check;
        re-pricing directly is exact)."""
        results = command.results
        if results is None or not results.new_node_plans:
            return
        cache: dict = {}
        retired = 0.0
        for c in command.candidates:
            prices = self._fresh_catalog(cache, c.node_pool.metadata.name)
            cur = prices.get((c.instance_type_name, c.zone, c.capacity_type))
            # a candidate whose own offering vanished keeps its computed
            # price: deleting it can only get MORE attractive
            retired += c.price if cur is None else cur
        new_total = sum(
            self._replacement_price(cache, plan)
            for plan in results.new_node_plans
        )
        if new_total >= retired:
            raise ValidationError(
                f"replacement no longer cheaper "
                f"({new_total:.4f}/hr >= {retired:.4f}/hr)"
            )

    def _validate_resimulation(
        self, command: "Command", live_pods: dict[str, list["Pod"]]
    ) -> None:
        """Past the TTL, re-run the scheduling simulation against
        current state (validateCommand, validation.go:262-310) with the
        candidates' LIVE pod sets, solving those pods ALONE (pending
        pods excluded — an unrelated pending pod forcing a new node,
        onto which the packer opportunistically tops off a candidate
        pod, must not read as the command going stale). The command's
        replacements are already live capacity by the time the queue
        validates, so every candidate pod should land on them (or other
        existing room): a NEW node needed means the cluster changed
        underneath the decision."""
        fresh = [
            dataclasses.replace(
                c, reschedulable_pods=live_pods.get(c.state_node.name, [])
            )
            for c in command.candidates
        ]
        # unrelated capacity still materializing (routine during any
        # provisioning) aborts the simulation via the uninitialized-node
        # guard — a TRANSIENT condition, so defer rather than roll back
        # a still-valid command and destroy its replacements
        if self.engine.has_uninitialized_capacity(
            exclude_names={c.state_node.name for c in fresh}
        ):
            raise ValidationRetry(
                "cluster has uninitialized capacity; deferring re-simulation"
            )
        results, all_ok = self.engine.simulate_scheduling(
            fresh, include_pending=False
        )
        if not all_ok:
            raise ValidationError(
                "re-simulation: candidate pods no longer reschedulable"
            )
        if results.new_node_plans:
            raise ValidationError(
                f"re-simulation produced new results "
                f"({len(results.new_node_plans)} new nodes needed for "
                f"candidate pods)"
            )
