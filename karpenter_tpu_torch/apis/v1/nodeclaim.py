"""NodeClaim API type: one requested machine.

Copy of `karpenter_tpu/apis/v1/nodeclaim.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/apis/v1/nodeclaim.go + nodeclaim_status.go. The
spec is immutable after creation (the reference enforces this with CEL;
here the in-memory API server rejects spec updates). Requirements carry
optional minValues flexibility floors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.v1.condition import ConditionSet
from karpenter_tpu_torch.kube.objects import ObjectMeta, Taint
from karpenter_tpu_torch.utils.resources import ResourceList

# Condition types (reference nodeclaim_status.go:26-35)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_CONSOLIDATABLE = "Consolidatable"
COND_DRIFTED = "Drifted"
COND_DRAINED = "Drained"
COND_VOLUMES_DETACHED = "VolumesDetached"
COND_INSTANCE_TERMINATING = "InstanceTerminating"
COND_CONSISTENT_STATE_FOUND = "ConsistentStateFound"
COND_DISRUPTION_REASON = "DisruptionReason"
# spot capacity holding a cloud interruption notice (set by the
# interruption controller the tick the provider reports the notice)
COND_INTERRUPTED = "Interrupted"
COND_NODE_CLASS_READY = "NodeClassReady"

LIFECYCLE_ROOT_CONDITIONS = [COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED]


@dataclass(frozen=True)
class NodeClassRef:
    group: str = ""
    kind: str = ""
    name: str = ""


@dataclass(frozen=True)
class RequirementSpec:
    """NodeSelectorRequirementWithMinValues (nodeclaim.go:81-89)."""

    key: str
    operator: str
    values: tuple[str, ...] = ()
    min_values: Optional[int] = None


@dataclass
class NodeClaimSpec:
    requirements: list[RequirementSpec] = field(default_factory=list)
    resources: ResourceList = field(default_factory=dict)  # resource requests
    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    node_class_ref: Optional[NodeClassRef] = None
    expire_after: Optional[str] = None              # duration string | "Never"
    termination_grace_period: Optional[str] = None  # duration string


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    image_id: str = ""
    node_name: str = ""
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    last_pod_event_time: Optional[float] = None


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)
    status_conditions: ConditionSet = field(default_factory=lambda: ConditionSet(
        root_types=list(LIFECYCLE_ROOT_CONDITIONS)))

    kind = "NodeClaim"

    @property
    def key(self) -> str:
        return self.metadata.name
