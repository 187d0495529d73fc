"""NodeClaim disruption-condition controllers.

Copy of `karpenter_tpu/disruption/conditions.py`, whole, with its
imports pointed into `karpenter_tpu_torch`.

Counterpart of pkg/controllers/nodeclaim/disruption (1,323 LoC) and
nodeclaim/expiration: maintain the conditions the disruption engine
consumes —

- Consolidatable: consolidateAfter elapsed since the last pod event
  (consolidation.go:38); cleared while pods churn.
- Drifted: provider IsDrifted, or the NodePool template hash changed
  (static drift), or the claim no longer satisfies the pool's
  requirements (dynamic drift) (drift.go:50-185).
- Expiration: claims older than expireAfter are force-deleted
  (expiration/controller.go:57-100).
"""

from __future__ import annotations

import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    NODEPOOL_HASH_ANNOTATION,
    NODEPOOL_HASH_VERSION_ANNOTATION,
    NODEPOOL_HASH_VERSION,
    NODEPOOL_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    NodeClaim,
)
from karpenter_tpu_torch.apis.v1.nodepool import (
    CONSOLIDATION_WHEN_EMPTY,
    NodePool,
)
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.scheduling.requirement import Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils.duration import parse_duration


class DisruptionConditionsController:
    # provider-side drift (image/nodeclass rollouts) leaves no event in
    # our objects, so a periodic full sweep covers it — the analogue of
    # the reference controller's requeue interval
    DRIFT_SWEEP_SECONDS = 60.0

    def __init__(self, kube: KubeClient, cluster: Cluster, cloud: CloudProvider):
        import heapq as _heapq

        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.dirty = DirtyTracker(kube).watch("NodeClaim", "NodePool")
        self._heapq = _heapq
        # consolidatable flips by TIME, not by event: [(flip_time, key)]
        # with a scheduled-time guard so repeated reconciles of a claim
        # can't grow the heap unboundedly within one window
        self._recheck: list[tuple[float, str]] = []
        self._recheck_at: dict[str, float] = {}
        self._last_sweep = 0.0

    def reconcile(self, claim: NodeClaim, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        pool = self.kube.get_node_pool(claim.metadata.labels.get(NODEPOOL_LABEL, ""))
        if pool is None:
            return
        self._consolidatable(claim, pool, now)
        self._drifted(claim, pool, now)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        for claim in list(self.kube.node_claims()):
            self.reconcile(claim, now=now)

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """O(changes) tick: dirty claims, claims whose consolidatable
        window just elapsed, every claim of a pool whose spec changed,
        and a periodic full sweep for provider-side drift."""
        now = time.time() if now is None else now
        if now - self._last_sweep >= self.DRIFT_SWEEP_SECONDS:
            self._last_sweep = now
            self.dirty.drain("NodeClaim")
            self.dirty.drain("NodePool")
            self.reconcile_all(now=now)
            return
        keys = self.dirty.drain("NodeClaim")
        for pool_key in self.dirty.drain("NodePool"):
            pool = self.kube.get_node_pool(pool_key)
            name = pool.metadata.name if pool is not None else pool_key
            keys.update(
                c.key for c in self.kube.node_claims()
                if c.metadata.labels.get(NODEPOOL_LABEL) == name
            )
        while self._recheck and self._recheck[0][0] <= now:
            due, key = self._heapq.heappop(self._recheck)
            if self._recheck_at.get(key) == due:
                del self._recheck_at[key]
            keys.add(key)
        for key in keys:
            claim = self.kube.get_node_claim(key)
            if claim is not None:
                self.reconcile(claim, now=now)

    # -- Consolidatable (nodeclaim/disruption/consolidation.go:38) -------------

    def _consolidatable(self, claim: NodeClaim, pool: NodePool, now: float) -> None:
        consolidate_after = parse_duration(pool.spec.disruption.consolidate_after)
        if consolidate_after is None:  # "Never"
            claim.status_conditions.clear(COND_CONSOLIDATABLE)
            return
        last_event = claim.status.last_pod_event_time or claim.metadata.creation_timestamp
        if now - last_event >= consolidate_after:
            claim.status_conditions.set_true(COND_CONSOLIDATABLE, now=now)
        else:
            claim.status_conditions.clear(COND_CONSOLIDATABLE)
            # not yet: wake up exactly when the window elapses (skip
            # the push when that exact wake-up is already scheduled)
            flip_at = last_event + consolidate_after
            if self._recheck_at.get(claim.key) != flip_at:
                self._recheck_at[claim.key] = flip_at
                self._heapq.heappush(self._recheck, (flip_at, claim.key))

    # -- Drifted (nodeclaim/disruption/drift.go:50-185) ------------------------

    def _drifted(self, claim: NodeClaim, pool: NodePool, now: float) -> None:
        if not claim.status_conditions.is_true("Launched"):
            return
        reason = self._drift_reason(claim, pool)
        if reason:
            claim.status_conditions.set_true(COND_DRIFTED, reason=reason, now=now)
        else:
            claim.status_conditions.clear(COND_DRIFTED)

    def _drift_reason(self, claim: NodeClaim, pool: NodePool) -> str:
        # provider-side drift (image/nodeclass changes)
        provider_reason = self.cloud.is_drifted(claim)
        if provider_reason:
            return provider_reason
        # static drift: template hash comparison at matching hash version
        claim_version = claim.metadata.annotations.get(NODEPOOL_HASH_VERSION_ANNOTATION)
        claim_hash = claim.metadata.annotations.get(NODEPOOL_HASH_ANNOTATION)
        if claim_version == NODEPOOL_HASH_VERSION and claim_hash:
            if claim_hash != pool.hash():
                return "NodePoolDrifted"
        # dynamic drift: claim labels must still satisfy pool requirements
        from karpenter_tpu_torch.solver.encode import pool_template_requirements

        pool_reqs = pool_template_requirements(pool)
        claim_reqs = Requirements.from_labels(claim.metadata.labels)
        if claim_reqs.intersects(pool_reqs) is not None:
            return "RequirementsDrifted"
        return ""


class ExpirationController:
    """Force-deletes claims past expireAfter
    (nodeclaim/expiration/controller.go:57-100)."""

    def __init__(self, kube: KubeClient):
        import heapq as _heapq

        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self._heapq = _heapq
        self.dirty = DirtyTracker(kube).watch("NodeClaim")
        self._due: list[tuple[float, str]] = []
        self._due_at: dict[str, float] = {}

    def _expire_if_due(self, claim: NodeClaim, now: float,
                       expired: list[NodeClaim]) -> None:
        lifetime = parse_duration(claim.spec.expire_after)
        if lifetime is None:
            return
        expire_at = claim.metadata.creation_timestamp + lifetime
        if now >= expire_at:
            if claim.metadata.deletion_timestamp is None:
                self.kube.delete(claim, now=now)
                expired.append(claim)
        elif self._due_at.get(claim.key) != expire_at:
            # deadline is fixed at creation; every later touch of the
            # claim would otherwise push a duplicate heap entry that
            # only drains at expiry
            self._due_at[claim.key] = expire_at
            self._heapq.heappush(self._due, (expire_at, claim.key))

    def reconcile_all(self, now: Optional[float] = None) -> list[NodeClaim]:
        now = time.time() if now is None else now
        expired: list[NodeClaim] = []
        for claim in list(self.kube.node_claims()):
            lifetime = parse_duration(claim.spec.expire_after)
            if lifetime is None:
                continue
            if now - claim.metadata.creation_timestamp >= lifetime:
                if claim.metadata.deletion_timestamp is None:
                    self.kube.delete(claim, now=now)
                    expired.append(claim)
        return expired

    def reconcile_dirty(self, now: Optional[float] = None) -> list[NodeClaim]:
        """O(changes): expiry deadlines live in a heap keyed at claim
        creation; a tick only pops what's due plus new/changed claims."""
        now = time.time() if now is None else now
        expired: list[NodeClaim] = []
        for key in self.dirty.drain("NodeClaim"):
            claim = self.kube.get_node_claim(key)
            if claim is not None:
                self._expire_if_due(claim, now, expired)
        while self._due and self._due[0][0] <= now:
            due, key = self._heapq.heappop(self._due)
            if self._due_at.get(key) == due:
                del self._due_at[key]
            claim = self.kube.get_node_claim(key)
            if claim is not None:
                self._expire_if_due(claim, now, expired)
        return expired


class PodEventsController:
    """Stamps status.last_pod_event_time on bind/terminal/terminating
    (nodeclaim/podevents/controller.go:63-110, 5s dedupe)."""

    DEDUPE_SECONDS = 5.0

    def __init__(self, kube: KubeClient, cluster: Cluster):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.cluster = cluster
        self.dirty = DirtyTracker(kube).watch("Pod")

    def reconcile_all(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        claims_by_node = {
            c.status.node_name: c for c in self.kube.node_claims() if c.status.node_name
        }
        touched: set[str] = set()
        for pod in self.kube.pods():
            self._stamp(pod, claims_by_node.get(pod.spec.node_name), touched, now)

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """O(changed pods): a pod event is the ONLY thing that can move
        a claim's lastPodEventTime (podevents/controller.go watches
        pods, nothing else)."""
        now = time.time() if now is None else now
        keys = self.dirty.drain("Pod")
        if not keys:
            return
        touched: set[str] = set()
        for key in keys:
            pod = self.kube.get("Pod", key)
            if pod is None or not pod.spec.node_name:
                continue
            state = self.cluster.node_for_name(pod.spec.node_name)
            claim = state.node_claim if state is not None else None
            self._stamp(pod, claim, touched, now)

    def _stamp(self, pod, claim, touched: set[str], now: float) -> None:
        if claim is None or not pod.spec.node_name:
            return
        if claim.metadata.name in touched:
            return
        state = self.cluster.node_for_name(pod.spec.node_name)
        if state is None:
            return
        last = claim.status.last_pod_event_time or 0.0
        times = self.cluster.pod_times(pod.key)
        event_time = max(times.bound, times.first_seen)
        if pod.is_terminal() or pod.is_terminating():
            event_time = now
        if event_time and event_time - last >= self.DEDUPE_SECONDS:
            claim.status.last_pod_event_time = event_time
            touched.add(claim.metadata.name)
            # announce the in-place stamp so the conditions controller
            # re-evaluates Consolidatable for this claim
            self.kube.touch(claim)
