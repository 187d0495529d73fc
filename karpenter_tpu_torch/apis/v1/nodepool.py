"""NodePool API type: declarative pool of nodes.

Copy of `karpenter_tpu/apis/v1/nodepool.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/apis/v1/nodepool.go: template for NodeClaims,
disruption policy (consolidation policy/after, cron-scheduled budgets),
resource limits, weight priority, and alpha `replicas` (static pools).
Includes the spec hash used for drift detection
(nodepool.go:297-305, NodePoolHashVersion "v3").
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.v1.condition import ConditionSet
from karpenter_tpu_torch.apis.v1.nodeclaim import NodeClaimSpec, RequirementSpec
from karpenter_tpu_torch.kube.objects import ObjectMeta
from karpenter_tpu_torch.utils.duration import CronSchedule, parse_duration
from karpenter_tpu_torch.utils.resources import ResourceList

CONSOLIDATION_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"

REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"
# spot interruption notice (KubePACS-style forced reclaim): the cloud
# takes the capacity whether or not the controller acts, so commands
# with this reason bypass graceful pod-block rules and budgets
REASON_INTERRUPTED = "Interrupted"

COND_VALIDATION_SUCCEEDED = "ValidationSucceeded"
COND_NODE_CLASS_READY = "NodeClassReady"
COND_NODE_REGISTRATION_HEALTHY = "NodeRegistrationHealthy"


@dataclass
class Budget:
    """Disruption budget window (nodepool.go:100-117).

    nodes: int-string or percentage ("10%"); schedule: cron (UTC);
    duration: window length; reasons: which disruption reasons it caps
    (None = all).
    """

    nodes: str = "10%"
    schedule: Optional[str] = None
    duration: Optional[str] = None
    reasons: Optional[list[str]] = None

    def is_active(self, now: float) -> bool:
        """Reference Budget.IsActive: walk back `duration` and see if
        the schedule fired within the window."""
        if self.schedule is None and self.duration is None:
            return True
        cron = CronSchedule.parse(self.schedule or "* * * * *")
        duration = parse_duration(self.duration) or 0.0
        last = cron.last_fire_before(now)
        return last is not None and last >= _floor_minute(now - duration)

    def allowed_disruptions(self, now: float, num_nodes: int) -> int:
        """MaxInt when inactive; else scaled value, percentages round up
        (matching PDB MaxUnavailable semantics — nodepool.go:345-367)."""
        if not self.is_active(now):
            return 2**31 - 1
        if self.nodes.endswith("%"):
            pct = int(self.nodes[:-1])
            return math.ceil(pct * num_nodes / 100.0)
        return int(self.nodes)


def _floor_minute(ts: float) -> float:
    return float(int(ts // 60) * 60)


@dataclass
class Disruption:
    consolidate_after: Optional[str] = "0s"  # duration | "Never"
    consolidation_policy: str = CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: list[Budget] = field(default_factory=list)


@dataclass
class NodeClaimTemplate:
    """spec.template: metadata + NodeClaimSpec minus status-ish fields."""

    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: ResourceList = field(default_factory=dict)
    weight: int = 0          # higher = tried first
    replicas: Optional[int] = None  # set -> static pool (alpha)


@dataclass
class NodePoolStatus:
    resources: ResourceList = field(default_factory=dict)
    nodes: int = 0


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)
    status_conditions: ConditionSet = field(default_factory=lambda: ConditionSet(
        root_types=[COND_VALIDATION_SUCCEEDED, COND_NODE_CLASS_READY]))

    kind = "NodePool"

    @property
    def key(self) -> str:
        return self.metadata.name

    def is_static(self) -> bool:
        return self.spec.replicas is not None

    def hash(self) -> str:
        """Static-field template hash for drift detection.

        Mirrors NodePool.Hash() (nodepool.go:297-305): covers the
        template's labels/annotations/taints/startup taints and
        behavior fields, excluding requirements and nodeClassRef
        (which drift via requirement-compat / nodeclass hash checks).
        """
        spec = self.spec.template.spec
        payload = {
            "labels": sorted(self.spec.template.labels.items()),
            "annotations": sorted(self.spec.template.annotations.items()),
            "taints": [(t.key, t.value, t.effect) for t in spec.taints],
            "startup_taints": [(t.key, t.value, t.effect) for t in spec.startup_taints],
            "expire_after": spec.expire_after,
            "termination_grace_period": spec.termination_grace_period,
        }
        digest = hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()
        return digest[:16]

    def allowed_disruptions(self, now: float, num_nodes: int, reason: str) -> int:
        """Min over budgets matching `reason` (nodepool.go:318-340)."""
        allowed = 2**31 - 1
        for budget in self.spec.disruption.budgets:
            if budget.reasons is None or reason in budget.reasons:
                allowed = min(allowed, budget.allowed_disruptions(now, num_nodes))
        return allowed

    def must_get_allowed_disruptions(self, now: float, num_nodes: int, reason: str) -> int:
        try:
            return self.allowed_disruptions(now, num_nodes, reason)
        except Exception:
            return 0  # fail closed on misconfigured budgets


def template_requirements(pool: NodePool) -> list[RequirementSpec]:
    """Template requirements plus single-value label requirements."""
    out = list(pool.spec.template.spec.requirements)
    for key, value in pool.spec.template.labels.items():
        out.append(RequirementSpec(key=key, operator="In", values=(value,)))
    return out


def nodepool_owner_ref(pool: "NodePool"):
    """The controller reference a NodePool stamps on objects it owns
    (claims; nodepool.go sets it so deleting the pool cascades)."""
    from karpenter_tpu_torch.kube.objects import OwnerReference

    return OwnerReference(
        kind="NodePool", name=pool.metadata.name, uid=pool.metadata.uid,
        controller=True, api_version="karpenter.sh/v1",
    )


def order_by_weight(pools: list[NodePool]) -> list[NodePool]:
    """Descending weight, then name for determinism (utils/nodepool)."""
    return sorted(pools, key=lambda p: (-p.spec.weight, p.metadata.name))
