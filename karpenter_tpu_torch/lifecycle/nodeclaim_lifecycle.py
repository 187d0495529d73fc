"""NodeClaim lifecycle: launch -> registration -> initialization -> liveness.

Copy of `karpenter_tpu/lifecycle/nodeclaim_lifecycle.py`.

Counterpart of pkg/controllers/nodeclaim/lifecycle (controller.go:119-183
and launch/registration/initialization/liveness sub-reconcilers), plus
the finalize path (controller.go:184-273) that tears the instance down
when a claim is deleted.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    NODE_INITIALIZED_LABEL,
    NODE_REGISTERED_LABEL,
    NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION,
    NODEPOOL_LABEL,
    TERMINATION_FINALIZER,
    UNREGISTERED_TAINT_KEY,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_INITIALIZED,
    COND_INSTANCE_TERMINATING,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
)
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
)
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics.store import NODECLAIMS_TERMINATED
from karpenter_tpu_torch.kube.objects import Node, OwnerReference
from karpenter_tpu_torch.scheduling.taints import is_ephemeral
from karpenter_tpu_torch.state.nodepoolhealth import HealthTracker
from karpenter_tpu_torch.utils.duration import parse_duration
from karpenter_tpu_torch.utils.resources import fits

log = logging.getLogger("karpenter.lifecycle")

LAUNCH_TIMEOUT_SECONDS = 5 * 60       # liveness.go:51
REGISTRATION_TIMEOUT_SECONDS = 15 * 60  # liveness.go:56
# transient launch failures retry with capped, full-jittered
# exponential backoff: a provider outage fails every in-flight claim
# at once, and tick-paced un-jittered retries would re-hammer the
# provider API with the whole cohort in lockstep each reconcile
LAUNCH_BACKOFF_BASE_SECONDS = 1.0
LAUNCH_BACKOFF_MAX_SECONDS = 30.0
# how often reconcile_dirty re-queues every deleting claim (wedge
# recovery bound; event-tracked claims progress every pass regardless)
DELETING_SWEEP_SECONDS = 30.0


class NodeClaimLifecycle:
    def __init__(
        self,
        kube: KubeClient,
        cloud_provider: CloudProvider,
        health: Optional[HealthTracker] = None,
    ):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.cloud_provider = cloud_provider
        self.health = health or HealthTracker()
        self.dirty = DirtyTracker(kube).watch("NodeClaim", "Node")
        # claims mid-flight (not yet Initialized, or deleting): these
        # progress on liveness clocks and cloud ticks that emit no
        # object event, so they stay on the every-tick path until they
        # settle — in steady state the set is empty
        self._active: set[str] = set()
        self._last_deleting_sweep = 0.0
        # claim key -> (consecutive launch failures, next attempt at)
        self._launch_retry: dict[str, tuple[int, float]] = {}

    # -- entry ----------------------------------------------------------------

    def reconcile(self, claim: NodeClaim, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        before = self._signature(claim)
        if claim.metadata.deletion_timestamp is not None:
            self._finalize(claim, now)
        else:
            self._launch(claim, now)
            if claim.status_conditions.is_true(COND_LAUNCHED):
                self._register(claim, now)
            if claim.status_conditions.is_true(COND_REGISTERED):
                self._initialize(claim, now)
            self._liveness(claim, now)
        if self._signature(claim) != before:
            # conditions were set in place; announce so watch-driven
            # consumers (conditions, hygiene, metrics) see the change
            self.kube.touch(claim)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        for claim in list(self.kube.node_claims()):
            self.reconcile(claim, now)

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """O(changes + in-flight): dirty claims (object events, incl.
        node events mapped back via nodeName) plus the active set of
        claims still progressing through launch/register/initialize or
        finalize."""
        now = time.time() if now is None else now
        keys = self.dirty.drain("NodeClaim")
        # Periodic deleting-claim sweep (controller-runtime requeues
        # deleting objects until their finalizer clears): the finalize
        # chain needs multiple passes, and an event race that drops a
        # claim from the active set mid-chain would otherwise wedge it
        # deleting forever with its instance still running (found by
        # the round-5 randomized soak). Periodic, not per-pass, so the
        # steady state stays O(changes + in-flight).
        if now - self._last_deleting_sweep >= DELETING_SWEEP_SECONDS:
            self._last_deleting_sweep = now
            keys |= {
                c.key for c in self.kube.node_claims()
                if c.metadata.deletion_timestamp is not None
            }
        node_keys = self.dirty.drain("Node")
        if node_keys:
            # one pid->claim index per pass, not a claim scan per node
            # (mass registration would otherwise cost
            # O(dirty_nodes x claims))
            by_pid = {
                c.status.provider_id: c.key
                for c in self.kube.node_claims()
                if c.status.provider_id
            }
            for node_key in node_keys:
                node = self.kube.get_node(node_key)
                if node is None:
                    continue
                hit = by_pid.get(node.spec.provider_id)
                if hit is not None:
                    keys.add(hit)
        keys |= self._active
        for key in keys:
            claim = self.kube.get_node_claim(key)
            if claim is None:
                self._active.discard(key)
                self._launch_retry.pop(key, None)
                continue
            self.reconcile(claim, now)
            settled = (
                claim.metadata.deletion_timestamp is None
                and claim.status_conditions.is_true(COND_INITIALIZED)
            )
            live = self.kube.get_node_claim(key) is not None
            if settled or not live:
                self._active.discard(key)
            else:
                self._active.add(key)

    def adopt_in_flight(self) -> int:
        """Crash recovery (Operator._recover): re-enter every claim
        still progressing — not yet Initialized, or mid-deletion —
        into the active set, so a restarted operator advances them on
        its own clocks instead of waiting for watch traffic the old
        process already consumed. Idempotent; returns how many claims
        are in flight."""
        adopted = 0
        for claim in self.kube.node_claims():
            settled = (
                claim.metadata.deletion_timestamp is None
                and claim.status_conditions.is_true(COND_INITIALIZED)
            )
            if not settled:
                self._active.add(claim.key)
                adopted += 1
        return adopted

    def _signature(self, claim: NodeClaim) -> tuple:
        return (
            claim.status.provider_id,
            claim.status.node_name,
            tuple(
                (c.type, c.status)
                for c in claim.status_conditions.conditions
            ),
            len(claim.metadata.finalizers),
        )

    # -- launch (launch.go:45-125) --------------------------------------------

    def _launch(self, claim: NodeClaim, now: float) -> None:
        if claim.status.provider_id:
            claim.status_conditions.set_true(COND_LAUNCHED, now=now)
            self._launch_retry.pop(claim.key, None)
            return
        retry = self._launch_retry.get(claim.key)
        if retry is not None and now < retry[1]:
            return  # still backing off from the last transient failure
        try:
            launched = self.cloud_provider.create(claim)
        except (InsufficientCapacityError, NodeClassNotReadyError) as err:
            # ICE: delete the claim so pods reschedule elsewhere
            log.info("launch failed for %s: %s; deleting claim", claim.metadata.name, err)
            self.health.record(claim.metadata.labels.get(NODEPOOL_LABEL, ""), False)
            self._launch_retry.pop(claim.key, None)
            self._delete_claim(claim, now)
            return
        except Exception as err:
            from karpenter_tpu_torch.utils.backoff import (
                capped_exponential,
                jitter,
            )

            n = retry[0] + 1 if retry is not None else 1
            window = capped_exponential(
                n, LAUNCH_BACKOFF_BASE_SECONDS, LAUNCH_BACKOFF_MAX_SECONDS
            )
            self._launch_retry[claim.key] = (n, now + window * jitter())
            claim.status_conditions.set_false(COND_LAUNCHED, "LaunchFailed", str(err), now=now)
            self.kube.update(claim)
            return
        # crash window: the cloud instance EXISTS but the claim does
        # not record it yet — a restarted operator re-launches (one
        # live instance per claim) and GC reaps the unrecorded orphan
        from karpenter_tpu_torch.solver import faults as _faults

        _faults.fire("crash_launch")
        self._launch_retry.pop(claim.key, None)
        claim.status.provider_id = launched.status.provider_id
        claim.status.image_id = launched.status.image_id
        claim.status.capacity = launched.status.capacity
        claim.status.allocatable = launched.status.allocatable
        claim.metadata.labels = launched.metadata.labels
        # single-valued requirements resolve to labels on the launched
        # claim (launch.go:131), so registration later stamps them onto
        # the node — e.g. a custom tier the scheduler pinned
        for spec in claim.spec.requirements:
            if spec.operator == "In" and len(spec.values) == 1:
                claim.metadata.labels.setdefault(spec.key, spec.values[0])
        claim.status_conditions.set_true(COND_LAUNCHED, now=now)
        self.kube.update(claim)

    # -- registration (registration.go:50-130) --------------------------------

    def _register(self, claim: NodeClaim, now: float) -> None:
        if claim.status_conditions.is_true(COND_REGISTERED) and claim.status.node_name:
            return
        node = self._node_for(claim)
        if node is None:
            return
        # sync labels/annotations; drop the unregistered taint
        node.metadata.labels.update(claim.metadata.labels)
        node.metadata.labels[NODE_REGISTERED_LABEL] = "true"
        node.metadata.annotations.update(claim.metadata.annotations)
        node.spec.taints = [
            t for t in node.spec.taints if t.key != UNREGISTERED_TAINT_KEY
        ]
        if TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(TERMINATION_FINALIZER)
        # the claim owns its Node (registration.go adds the controller
        # reference so a deleted claim cascades to the node object)
        if not any(
            r.kind == "NodeClaim" and r.name == claim.metadata.name
            for r in node.metadata.owner_references
        ):
            node.metadata.owner_references.append(OwnerReference(
                kind="NodeClaim", name=claim.metadata.name,
                uid=claim.metadata.uid, controller=True,
                api_version="karpenter.sh/v1",
            ))
        self.kube.update(node)
        claim.status.node_name = node.metadata.name
        claim.status_conditions.set_true(COND_REGISTERED, now=now)
        self.kube.update(claim)
        self.health.record(claim.metadata.labels.get(NODEPOOL_LABEL, ""), True)

    # -- initialization (initialization.go:46-134) -----------------------------

    def _initialize(self, claim: NodeClaim, now: float) -> None:
        if claim.status_conditions.is_true(COND_INITIALIZED):
            return
        node = self._node_for(claim)
        if node is None or not node.is_ready():
            return
        # startup taints must be gone
        startup_keys = {(t.key, t.effect) for t in claim.spec.startup_taints}
        for taint in node.spec.taints:
            if (taint.key, taint.effect) in startup_keys:
                return
            if is_ephemeral(taint):
                return
        # requested extended resources must be registered
        if not fits(claim.spec.resources, node.status.allocatable):
            return
        node.metadata.labels[NODE_INITIALIZED_LABEL] = "true"
        self.kube.update(node)
        claim.status_conditions.set_true(COND_INITIALIZED, now=now)
        self.kube.update(claim)

    # -- liveness (liveness.go:51-124) -----------------------------------------

    def _liveness(self, claim: NodeClaim, now: float) -> None:
        age = now - claim.metadata.creation_timestamp
        if not claim.status_conditions.is_true(COND_LAUNCHED):
            if age > LAUNCH_TIMEOUT_SECONDS:
                log.info("launch timeout for %s; deleting", claim.metadata.name)
                self.health.record(claim.metadata.labels.get(NODEPOOL_LABEL, ""), False)
                self._delete_claim(claim, now)
            return
        if not claim.status_conditions.is_true(COND_REGISTERED):
            if age > REGISTRATION_TIMEOUT_SECONDS:
                log.info("registration timeout for %s; deleting", claim.metadata.name)
                self.health.record(claim.metadata.labels.get(NODEPOOL_LABEL, ""), False)
                self._delete_claim(claim, now)

    # -- finalize (controller.go:184-273) --------------------------------------

    def _finalize(self, claim: NodeClaim, now: float) -> None:
        if TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return
        # annotate the termination deadline from terminationGracePeriod
        tgp = parse_duration(claim.spec.termination_grace_period)
        if tgp is not None and (
            NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION not in claim.metadata.annotations
        ):
            claim.metadata.annotations[
                NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION
            ] = str(claim.metadata.deletion_timestamp + tgp)
            self.kube.update(claim)
        # delete node objects first; wait until they are gone
        nodes = [n for n in self.kube.nodes()
                 if n.spec.provider_id == claim.status.provider_id]
        if nodes:
            for node in nodes:
                if node.metadata.deletion_timestamp is None:
                    self.kube.delete(node, now=now)
            return
        if claim.status.provider_id:
            # await instance termination (controller.go:269-290): issue
            # the provider delete, mark InstanceTerminating, and hold
            # the finalizer until the provider reports the instance
            # GONE (NotFound) — dropping it on the first delete call
            # would let the claim vanish while the instance still runs,
            # leaking it to the garbage collector
            instance_gone = False
            try:
                self.cloud_provider.delete(claim)
            except NodeClaimNotFoundError:
                instance_gone = True
            claim.status_conditions.set_true(COND_INSTANCE_TERMINATING, now=now)
            if not instance_gone:
                return  # requeued; next pass re-checks the provider
        else:
            claim.status_conditions.set_true(COND_INSTANCE_TERMINATING, now=now)
        self.kube.remove_finalizer(claim, TERMINATION_FINALIZER)
        NODECLAIMS_TERMINATED.inc({
            "nodepool": claim.metadata.labels.get(NODEPOOL_LABEL, "")
        })

    # -- helpers ---------------------------------------------------------------

    def _node_for(self, claim: NodeClaim) -> Optional[Node]:
        for node in self.kube.nodes():
            if node.spec.provider_id == claim.status.provider_id:
                return node
        return None

    def _delete_claim(self, claim: NodeClaim, now: float) -> None:
        self.kube.delete(claim, now=now)
        # finalize immediately: nothing to tear down pre-launch
        self._finalize(claim, now)
