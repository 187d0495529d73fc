"""Hygiene controllers: consistency, hydration, nodepool status.

Copy of `karpenter_tpu/lifecycle/hygiene.py`.

- ConsistencyController (consistency/controller.go:79-150 +
  nodeshape.go:35): verifies a registered node's real capacity is
  within 10% of what the claim requested; emits an event and sets
  ConsistentStateFound.
- HydrationController (nodeclaim/hydration, node/hydration): back-fills
  nodepool-hash annotations on objects created before the annotation
  existed (upgrade path).
- NodePoolStatusController folds the reference's nodepool/{counter,
  readiness, registrationhealth, validation, hash} controllers: tallies
  owned resources into status, mirrors NodeClassReady, sets
  NodeRegistrationHealthy from the health tracker, validates the spec,
  and propagates template-hash changes to claims.
"""

from __future__ import annotations

import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    NODEPOOL_HASH_ANNOTATION,
    NODEPOOL_HASH_VERSION,
    NODEPOOL_HASH_VERSION_ANNOTATION,
    NODEPOOL_LABEL,
    is_restricted_label,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_CONSISTENT_STATE_FOUND,
    COND_REGISTERED,
)
from karpenter_tpu_torch.apis.v1.nodepool import (
    COND_NODE_CLASS_READY,
    COND_NODE_REGISTRATION_HEALTHY,
    COND_VALIDATION_SUCCEEDED,
)
from karpenter_tpu_torch.events.recorder import Event, EventRecorder
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.nodepoolhealth import HealthTracker
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.duration import CronSchedule, parse_duration

SHAPE_TOLERANCE = 0.10  # nodeshape.go:35


class ConsistencyController:
    def __init__(self, kube: KubeClient, recorder: Optional[EventRecorder] = None):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.recorder = recorder or EventRecorder()
        self.dirty = DirtyTracker(kube).watch("NodeClaim", "Node")

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """O(changes): the shape invariant can only break when the
        claim or its node changed."""
        now = time.time() if now is None else now
        claim_keys = self.dirty.drain("NodeClaim")
        node_keys = self.dirty.drain("Node")
        if not claim_keys and not node_keys:
            return
        pids = set()
        for key in node_keys:
            node = self.kube.get_node(key)
            if node is not None:
                pids.add(node.spec.provider_id)
        claims = [
            c for c in self.kube.node_claims()
            if c.key in claim_keys or c.status.provider_id in pids
        ]
        self._check(claims, now)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._check(list(self.kube.node_claims()), now)

    def _check(self, claims, now: float) -> None:
        nodes_by_pid = {n.spec.provider_id: n for n in self.kube.nodes()}
        for claim in claims:
            if not claim.status_conditions.is_true(COND_REGISTERED):
                continue
            node = nodes_by_pid.get(claim.status.provider_id)
            if node is None:
                # a Registered claim with no live node is the crash-
                # recovery window (node deleted by another actor, or an
                # operator died between two registration writes):
                # surface it on the condition so readiness dashboards
                # see the inconsistency while GC converges it
                if claim.metadata.deletion_timestamp is None:
                    claim.status_conditions.set_false(
                        COND_CONSISTENT_STATE_FOUND, "NodeMissing", now=now
                    )
                continue
            consistent = True
            for key, expected in claim.status.capacity.items():
                actual = node.status.capacity.get(key, 0.0)
                if expected > 0 and actual < expected * (1 - SHAPE_TOLERANCE):
                    consistent = False
                    self.recorder.publish(
                        Event(
                            kind="NodeClaim", name=claim.metadata.name,
                            type="Warning", reason="FailedConsistencyCheck",
                            message=f"node {node.metadata.name} {key} "
                                    f"{actual} < expected {expected}",
                        ),
                        now=now,
                    )
            if consistent:
                claim.status_conditions.set_true(COND_CONSISTENT_STATE_FOUND, now=now)
            else:
                claim.status_conditions.set_false(
                    COND_CONSISTENT_STATE_FOUND, "ConsistencyCheckFailed", now=now
                )


class HydrationController:
    def __init__(self, kube: KubeClient):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.dirty = DirtyTracker(kube).watch("NodeClaim", "Node")

    def _hydrate(self, obj, pools) -> int:
        pool = pools.get(obj.metadata.labels.get(NODEPOOL_LABEL, ""))
        if pool is None:
            return 0
        if NODEPOOL_HASH_VERSION_ANNOTATION not in obj.metadata.annotations:
            obj.metadata.annotations[NODEPOOL_HASH_VERSION_ANNOTATION] = (
                NODEPOOL_HASH_VERSION
            )
            obj.metadata.annotations[NODEPOOL_HASH_ANNOTATION] = pool.hash()
            return 1
        return 0

    def reconcile_all(self) -> int:
        hydrated = 0
        pools = {p.metadata.name: p for p in self.kube.node_pools()}
        for obj in list(self.kube.node_claims()) + list(self.kube.nodes()):
            hydrated += self._hydrate(obj, pools)
        return hydrated

    def reconcile_dirty(self) -> int:
        """O(changes): hydration is a one-shot upgrade backfill — only
        objects that just appeared or changed can need it."""
        keys = self.dirty.drain("NodeClaim") | {
            ("Node", k) for k in self.dirty.drain("Node")
        }
        if not keys:
            return 0
        pools = {p.metadata.name: p for p in self.kube.node_pools()}
        hydrated = 0
        for key in keys:
            if isinstance(key, tuple):
                obj = self.kube.get_node(key[1])
            else:
                obj = self.kube.get_node_claim(key)
            if obj is not None:
                hydrated += self._hydrate(obj, pools)
        return hydrated


class NodePoolStatusController:
    def __init__(self, kube: KubeClient, cluster: Cluster,
                 health: Optional[HealthTracker] = None,
                 nodeclass_ready: bool = True):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.cluster = cluster
        self.health = health or HealthTracker()
        self.nodeclass_ready = nodeclass_ready
        self.dirty = DirtyTracker(kube).watch("NodeClaim", "Node")
        self._pool_hashes: dict[str, str] = {}

    def reconcile_all(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for pool in self.kube.node_pools():
            self._counter(pool)
            self._readiness(pool, now)
            self._registration_health(pool, now)
            self._validate(pool, now)
            self._hash_propagation(pool)

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """Per-pool condition upkeep stays (pools are few and the work
        is O(1) per pool); the O(cluster) parts — node-capacity
        aggregation and hash propagation over owned claims — run only
        when node/claim events or a pool-hash change demand it."""
        now = time.time() if now is None else now
        nodes_changed = bool(self.dirty.drain("Node"))
        claim_keys = self.dirty.drain("NodeClaim")
        for pool in self.kube.node_pools():
            if nodes_changed or claim_keys:
                self._counter(pool)
            self._readiness(pool, now)
            self._registration_health(pool, now)
            self._validate(pool, now)
            current = pool.hash()
            if self._pool_hashes.get(pool.metadata.name) != current:
                # template changed: every owned claim needs the stamp
                self._pool_hashes[pool.metadata.name] = current
                self._hash_propagation(pool)
            elif claim_keys:
                for key in claim_keys:
                    claim = self.kube.get_node_claim(key)
                    if (
                        claim is not None
                        and claim.metadata.labels.get(NODEPOOL_LABEL)
                        == pool.metadata.name
                    ):
                        self._stamp_claim(claim, current)

    def _counter(self, pool) -> None:
        """nodepool/counter: aggregate owned capacity into status."""
        total: dict[str, float] = {}
        count = 0
        for node in self.cluster.nodes():
            if node.nodepool_name() != pool.metadata.name or node.deleting():
                continue
            total = resutil.merge(total, node.capacity())
            count += 1
        pool.status.resources = total
        pool.status.nodes = count

    def _readiness(self, pool, now: float) -> None:
        if self.nodeclass_ready:
            pool.status_conditions.set_true(COND_NODE_CLASS_READY, now=now)
        else:
            pool.status_conditions.set_false(
                COND_NODE_CLASS_READY, "NodeClassNotReady", now=now
            )

    def _registration_health(self, pool, now: float) -> None:
        if self.health.healthy(pool.metadata.name):
            pool.status_conditions.set_true(COND_NODE_REGISTRATION_HEALTHY, now=now)
        else:
            pool.status_conditions.set_false(
                COND_NODE_REGISTRATION_HEALTHY, "RegistrationFailuresExceeded", now=now
            )

    def _validate(self, pool, now: float) -> None:
        """Runtime validation (nodepool/validation + CEL-rule analog)."""
        errors = []
        for key in pool.spec.template.labels:
            err = is_restricted_label(key)
            if err:
                errors.append(err)
        for budget in pool.spec.disruption.budgets:
            if budget.schedule is not None:
                try:
                    CronSchedule.parse(budget.schedule)
                except ValueError as err:
                    errors.append(str(err))
            if not budget.nodes.endswith("%"):
                try:
                    int(budget.nodes)
                except ValueError:
                    errors.append(f"invalid budget nodes {budget.nodes!r}")
        try:
            parse_duration(pool.spec.disruption.consolidate_after)
        except ValueError as err:
            errors.append(str(err))
        if errors:
            pool.status_conditions.set_false(
                COND_VALIDATION_SUCCEEDED, "ValidationFailed", "; ".join(errors), now=now
            )
        else:
            pool.status_conditions.set_true(COND_VALIDATION_SUCCEEDED, now=now)

    def _hash_propagation(self, pool) -> None:
        """nodepool/hash: stamp current template hash onto owned claims
        at matching hash version (drift detection input)."""
        current = pool.hash()
        for claim in self.kube.node_claims():
            if claim.metadata.labels.get(NODEPOOL_LABEL) != pool.metadata.name:
                continue
            self._stamp_claim(claim, current)

    def _stamp_claim(self, claim, current: str) -> None:
        version = claim.metadata.annotations.get(NODEPOOL_HASH_VERSION_ANNOTATION)
        if version != NODEPOOL_HASH_VERSION:
            claim.metadata.annotations[NODEPOOL_HASH_VERSION_ANNOTATION] = (
                NODEPOOL_HASH_VERSION
            )
            claim.metadata.annotations[NODEPOOL_HASH_ANNOTATION] = current
