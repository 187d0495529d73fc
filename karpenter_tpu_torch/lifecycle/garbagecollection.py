"""Garbage collection + node health (repair) controllers.

Copy of `karpenter_tpu/lifecycle/garbagecollection.py`.

GC (nodeclaim/garbagecollection/controller.go:60-118): periodically
lists the cloud provider and deletes instances with no matching claim,
plus claims whose registered node vanished.

Health (node/health/controller.go:56-200): feature-gated auto-repair —
nodes matching a provider RepairPolicy condition beyond its toleration
are force-deleted, unless >20% of the cluster is unhealthy (circuit
breaker). Repair bypasses the termination grace period.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import NODEPOOL_LABEL
from karpenter_tpu_torch.apis.v1.nodeclaim import COND_REGISTERED
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics.store import OPERATOR_RECOVERY
from karpenter_tpu_torch.operator.options import Options

log = logging.getLogger("karpenter.gc")

GC_INTERVAL_SECONDS = 2 * 60
UNHEALTHY_CLUSTER_THRESHOLD = 0.2  # health circuit breaker


class GarbageCollectionController:
    def __init__(self, kube: KubeClient, cloud: CloudProvider):
        self.kube = kube
        self.cloud = cloud

    def reconcile(self, now: Optional[float] = None) -> dict[str, int]:
        now = time.time() if now is None else now
        stats = {"leaked_instances": 0, "orphaned_claims": 0,
                 "orphaned_nodes": 0}
        claims = {c.status.provider_id: c for c in self.kube.node_claims()
                  if c.status.provider_id}
        # leaked cloud instances with no claim — including the
        # double-launch window: a crash between the provider create and
        # the claim's status write leaves a running instance no claim
        # records; the restarted operator re-launches, and this pass
        # reaps the unrecorded twin
        for remote in self.cloud.list():
            pid = remote.status.provider_id
            if pid and pid not in claims:
                try:
                    self.cloud.delete(remote)
                    stats["leaked_instances"] += 1
                    OPERATOR_RECOVERY.inc({"action": "reaped_leak"})
                    log.info("gc: deleted leaked instance %s", pid)
                except NodeClaimNotFoundError:
                    pass
        # claims whose node disappeared after registration
        node_pids = {n.spec.provider_id for n in self.kube.nodes()}
        for claim in self.kube.node_claims():
            if claim.metadata.deletion_timestamp is not None:
                continue
            if not claim.status_conditions.is_true(COND_REGISTERED):
                continue
            if claim.status.provider_id not in node_pids:
                self.kube.delete(claim, now=now)
                stats["orphaned_claims"] += 1
                log.info("gc: deleted orphaned claim %s", claim.metadata.name)
        # karpenter-managed Node objects whose backing instance AND
        # claim are both gone (the node a reaped leaked instance had
        # already materialized): nothing else deletes these — the claim
        # cascade never knew them. Instance liveness is checked AFTER
        # the leak pass so a just-reaped twin's node goes too.
        live_pids = {
            i.status.provider_id for i in self.cloud.list()
            if i.status.provider_id
        }
        for node in self.kube.nodes():
            if NODEPOOL_LABEL not in node.metadata.labels:
                continue  # bring-your-own nodes are never GC'd
            pid = node.spec.provider_id
            if pid and pid not in live_pids and pid not in claims:
                self.kube.delete(node, now=now)
                stats["orphaned_nodes"] += 1
                log.info("gc: deleted orphaned node %s", node.metadata.name)
        return stats


class NodeHealthController:
    def __init__(self, kube: KubeClient, cloud: CloudProvider,
                 options: Optional[Options] = None):
        self.kube = kube
        self.cloud = cloud
        self.options = options or Options()

    def reconcile(self, now: Optional[float] = None) -> list[str]:
        """Returns names of nodes sent for repair."""
        if not self.options.feature_gates.node_repair:
            return []
        now = time.time() if now is None else now
        policies = self.cloud.repair_policies()
        if not policies:
            return []
        nodes = self.kube.nodes()
        if not nodes:
            return []
        unhealthy = []
        for node in nodes:
            for policy in policies:
                cond = node.condition(policy.condition_type)
                if cond is None or cond.status != policy.condition_status:
                    continue
                if now - cond.last_transition_time >= policy.toleration_duration:
                    unhealthy.append(node)
                    break
        # circuit breaker: abstain when >20% of the cluster is unhealthy
        if len(unhealthy) / len(nodes) > UNHEALTHY_CLUSTER_THRESHOLD and len(nodes) > 1:
            log.warning("node repair: %d/%d nodes unhealthy; circuit breaker open",
                        len(unhealthy), len(nodes))
            return []
        repaired = []
        for node in unhealthy:
            claim = next(
                (c for c in self.kube.node_claims()
                 if c.status.provider_id == node.spec.provider_id), None
            )
            if claim is not None and claim.metadata.deletion_timestamp is None:
                # repair bypasses TGP: drop the annotation path entirely
                self.kube.delete(claim, now=now)
                repaired.append(node.metadata.name)
                log.info("node repair: deleting unhealthy node %s", node.metadata.name)
        return repaired
