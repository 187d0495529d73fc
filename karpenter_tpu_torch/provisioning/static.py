"""Static-capacity pools: replica-count maintenance.

Copy of `karpenter_tpu/provisioning/static.py`.

Counterpart of pkg/controllers/static/{provisioning,deprovisioning}
(753 + 911 LoC) and the StaticDrift method (staticdrift.go:50-116):
NodePools with spec.replicas set hold exactly that many nodes built
from the template, independent of pod demand. Scale-up launches claims
from the template; scale-down picks the lowest-disruption-cost nodes;
drifted static nodes are rolled one at a time, replacement first.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    NODEPOOL_HASH_ANNOTATION,
    NODEPOOL_HASH_VERSION,
    NODEPOOL_HASH_VERSION_ANNOTATION,
    NODEPOOL_LABEL,
    TERMINATION_FINALIZER,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_DRIFTED,
    COND_INITIALIZED,
    NodeClaim,
    NodeClaimSpec,
    RequirementSpec,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool, nodepool_owner_ref
from karpenter_tpu_torch.disruption.engine import pod_disruption_cost
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.kube.objects import ObjectMeta
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.scheduling.requirement import IN
from karpenter_tpu_torch.state.cluster import Cluster

log = logging.getLogger("karpenter.static")

_counter = itertools.count(1)


class StaticCapacityController:
    def __init__(self, kube: KubeClient, cluster: Cluster,
                 options: Optional[Options] = None):
        self.kube = kube
        self.cluster = cluster
        self.options = options or Options()

    def reconcile_all(self, now: Optional[float] = None) -> None:
        if not self.options.feature_gates.static_capacity:
            return
        now = time.time() if now is None else now
        for pool in self.kube.node_pools():
            if not pool.is_static() or pool.metadata.deletion_timestamp is not None:
                continue
            self._reconcile_pool(pool, now)

    def _pool_claims(self, pool: NodePool) -> list[NodeClaim]:
        return [
            c for c in self.kube.node_claims()
            if c.metadata.labels.get(NODEPOOL_LABEL) == pool.metadata.name
        ]

    def _reconcile_pool(self, pool: NodePool, now: float) -> None:
        claims = self._pool_claims(pool)
        active = [c for c in claims if c.metadata.deletion_timestamp is None]
        target = pool.spec.replicas or 0
        if len(active) < target:
            # reserve before launching (statenodepool.go
            # ReserveNodeCount): under informer lag a second reconcile
            # sees stale counts; the reservation is what prevents it
            # from overshooting the replica target
            granted = self.cluster.reserve_node_count(
                pool.metadata.name, target - len(active), target
            )
            launched = 0
            try:
                for _ in range(granted):
                    self._launch(pool)
                    launched += 1
            except Exception:
                # every unlaunched slot goes back, not just the one
                # that failed — leaked reservations would wedge the
                # pool below its replica target forever
                self.cluster.release_node_reservation(
                    pool.metadata.name, granted - launched
                )
                raise
        elif len(active) > target:
            self._scale_down(pool, active, len(active) - target, now)
        else:
            self._roll_drifted(pool, active, now)

    def _next_claim_name(self, pool: NodePool) -> str:
        """Collision-proof claim name: the module counter restarts on
        checkpoint resume (KubeClient.load), so skip names the durable
        store already holds."""
        while True:
            name = f"{pool.metadata.name}-static-{next(_counter):05d}"
            if self.kube.get_node_claim(name) is None:
                return name

    def _launch(self, pool: NodePool) -> NodeClaim:
        requirements = [
            RequirementSpec(key=r.key, operator=r.operator, values=tuple(r.values),
                            min_values=r.min_values)
            for r in pool.spec.template.spec.requirements
        ]
        for key, value in pool.spec.template.labels.items():
            requirements.append(RequirementSpec(key=key, operator=IN, values=(value,)))
        claim = NodeClaim(
            metadata=ObjectMeta(
                name=self._next_claim_name(pool),
                namespace="",
                labels={NODEPOOL_LABEL: pool.metadata.name,
                        **pool.spec.template.labels},
                annotations={
                    NODEPOOL_HASH_ANNOTATION: pool.hash(),
                    NODEPOOL_HASH_VERSION_ANNOTATION: NODEPOOL_HASH_VERSION,
                },
                finalizers=[TERMINATION_FINALIZER],
                owner_references=[nodepool_owner_ref(pool)],
            ),
            spec=NodeClaimSpec(
                requirements=requirements,
                taints=list(pool.spec.template.spec.taints),
                startup_taints=list(pool.spec.template.spec.startup_taints),
                node_class_ref=pool.spec.template.spec.node_class_ref,
                expire_after=pool.spec.template.spec.expire_after,
                termination_grace_period=pool.spec.template.spec.termination_grace_period,
            ),
        )
        self.kube.create(claim)
        log.info("static pool %s: launched %s", pool.metadata.name, claim.metadata.name)
        return claim

    def _scale_down(self, pool: NodePool, active: list[NodeClaim], count: int,
                    now: float) -> None:
        """Deprovision the cheapest-to-disrupt nodes, drifted claims
        first (static/deprovisioning/controller.go:75-200). When the
        surplus exists because a drift roll is in flight, wait for the
        replacement to initialize before removing anything."""
        if any(
            not c.status_conditions.is_true(COND_INITIALIZED) for c in active
        ) and any(c.status_conditions.is_true(COND_DRIFTED) for c in active):
            return
        def cost(claim: NodeClaim) -> tuple:
            state = None
            for node in self.cluster.nodes():
                if node.node_claim is claim or (
                    node.node_claim is not None
                    and node.node_claim.metadata.name == claim.metadata.name
                ):
                    state = node
                    break
            drifted = claim.status_conditions.is_true(COND_DRIFTED)
            if state is None:
                return (not drifted, 0.0)
            total = 0.0
            for pod_key in state.pod_keys:
                pod = self.kube.get_pod(*pod_key.split("/", 1))
                if pod is not None and pod.owner_kind() != "DaemonSet":
                    total += pod_disruption_cost(pod)
            return (not drifted, total)

        for claim in sorted(active, key=cost)[:count]:
            self.kube.delete(claim, now=now)
            log.info("static pool %s: scaled down %s", pool.metadata.name,
                     claim.metadata.name)

    def _roll_drifted(self, pool: NodePool, active: list[NodeClaim], now: float) -> None:
        """StaticDrift: replace drifted nodes one at a time, replacement
        first (staticdrift.go:50-116)."""
        drifted = [c for c in active if c.status_conditions.is_true(COND_DRIFTED)]
        if not drifted:
            return
        # budget check: one roll at a time within allowed disruptions
        allowed = pool.must_get_allowed_disruptions(
            now, len(active), "Drifted"
        )
        if allowed <= 0:
            return
        # a pending replacement (uninitialized fresh claim) means a roll
        # is already in flight; wait for it
        initializing = [
            c for c in active
            if not c.status_conditions.is_true(COND_INITIALIZED)
        ]
        if initializing:
            return
        # replacement-first: launch the surplus claim now; once it
        # initializes, _scale_down removes the drifted claim (drifted
        # claims sort first) — staticdrift.go:50-116 ordering
        replacement = self._launch(pool)
        log.info("static pool %s: rolling drifted %s -> %s", pool.metadata.name,
                 drifted[0].metadata.name, replacement.metadata.name)
