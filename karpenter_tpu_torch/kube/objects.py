"""Lightweight Kubernetes-shaped object model.

Copy of `karpenter_tpu/kube/objects.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The reference runs against a real API server (controller-runtime +
envtest). This build has no kube cluster in the loop, so the framework
defines its own typed object model carrying exactly the fields the
scheduling/disruption engines consume, plus an in-memory API server
(`karpenter_tpu_torch.kube.client`) with watch/patch/finalizer semantics the
controllers are written against. Field names follow the k8s API
(snake_cased) so a thin adapter can map to real CRs later.

Covers: Pod (affinity/anti-affinity, topology spread, tolerations,
host ports, PVCs, overhead), Node, DaemonSet, PDB, PVC/StorageClass,
PriorityClass.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.utils.resources import ResourceList

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter):08d}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list["OwnerReference"] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 0


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = False
    # required on the wire: a real apiserver 422s ownerReferences
    # missing apiVersion
    api_version: str = "apps/v1"


# ---------------------------------------------------------------- taints


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute

    def matches(self, other: "Taint") -> bool:
        return self.key == other.key and self.value == other.value and self.effect == other.effect


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Mirrors corev1.Toleration.ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


# ---------------------------------------------------------------- selectors


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: match_labels AND match_expressions."""

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[LabelSelectorRequirement, ...] = ()

    @staticmethod
    def of(labels: dict[str, str] | None = None,
           expressions: list[LabelSelectorRequirement] | None = None) -> "LabelSelector":
        return LabelSelector(
            match_labels=tuple(sorted((labels or {}).items())),
            match_expressions=tuple(expressions or ()),
        )

    def matches(self, labels: dict[str, str]) -> bool:
        for key, value in self.match_labels:
            if labels.get(key) != value:
                return False
        for expr in self.match_expressions:
            has = expr.key in labels
            if expr.operator == "In":
                if not has or labels[expr.key] not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if has and labels[expr.key] in expr.values:
                    return False
            elif expr.operator == "Exists":
                if not has:
                    return False
            elif expr.operator == "DoesNotExist":
                if has:
                    return False
        return True


# ---------------------------------------------------------------- affinity


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: tuple[NodeSelectorTerm, ...] = ()   # OR of terms
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: LabelSelector = field(default_factory=LabelSelector)
    topology_key: str = ""
    namespaces: tuple[str, ...] = ()  # empty -> pod's own namespace


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: LabelSelector = field(default_factory=LabelSelector)
    min_domains: Optional[int] = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"   # Honor | Ignore


# ---------------------------------------------------------------- pod


@dataclass
class Container:
    name: str = "main"
    requests: ResourceList = field(default_factory=dict)
    ports: list[int] = field(default_factory=list)  # host ports only
    host_ip: str = ""
    # Dynamic Resource Allocation: names of pod-level resourceClaims
    # this container consumes (corev1 Container.Resources.Claims)
    resource_claims: list[str] = field(default_factory=list)
    # init containers with restartPolicy=Always are native sidecars:
    # their requests persist for the pod's lifetime
    restart_policy: Optional[str] = None


@dataclass
class PodVolume:
    name: str = ""
    pvc_name: Optional[str] = None  # persistentVolumeClaim.claimName
    ephemeral: bool = False         # generic ephemeral volume -> PVC "<pod>-<vol>"


@dataclass
class PodSpec:
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: ResourceList = field(default_factory=dict)
    # pod-level resource requests (PodLevelResources feature): when
    # set, these replace container aggregation for scheduling
    resources: ResourceList = field(default_factory=dict)
    volumes: list[PodVolume] = field(default_factory=list)
    node_name: str = ""
    priority: int = 0
    priority_class_name: str = ""
    scheduler_name: str = "default-scheduler"
    termination_grace_period_seconds: Optional[int] = 30
    restart_policy: str = "Always"
    # transient, re-derived each scheduling round: zonal requirements
    # injected from the pod's PVCs (volumetopology.go:51-160); consumed
    # by Requirements.from_pod, never part of the API object proper
    injected_requirements: list = field(default_factory=list)


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    conditions: list[PodCondition] = field(default_factory=list)
    start_time: Optional[float] = None
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def is_terminal(self) -> bool:
        return self.status.phase in ("Succeeded", "Failed")

    def is_terminating(self) -> bool:
        return self.metadata.deletion_timestamp is not None

    def is_scheduled(self) -> bool:
        return bool(self.spec.node_name)

    def owner_kind(self) -> str:
        for ref in self.metadata.owner_references:
            if ref.controller:
                return ref.kind
        return ""


# ---------------------------------------------------------------- node


@dataclass
class NodeSpec:
    taints: list[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""


@dataclass
class NodeCondition:
    type: str
    status: str
    reason: str = ""
    last_transition_time: float = 0.0


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    @property
    def key(self) -> str:
        return self.metadata.name

    def condition(self, ctype: str) -> Optional[NodeCondition]:
        for cond in self.status.conditions:
            if cond.type == ctype:
                return cond
        return None

    def is_ready(self) -> bool:
        cond = self.condition("Ready")
        return cond is not None and cond.status == "True"


# ---------------------------------------------------------------- priority


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass, trimmed to the fields the
    admission-time priority resolution consumes
    (scheduling/priority.py): a named integer priority, the
    cluster-wide default flag, and the preemption policy gate the
    provisioner's preemption controller honors."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    # PreemptLowerPriority | Never — pods of a Never class still sort
    # above lower priorities but never nominate victims
    preemption_policy: str = "PreemptLowerPriority"

    kind = "PriorityClass"

    @property
    def key(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------- workloads


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class DaemonSetSpec:
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)

    kind = "DaemonSet"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class PodDisruptionBudgetSpec:
    selector: LabelSelector = field(default_factory=LabelSelector)
    min_available: Optional[int | str] = None    # int or percentage "50%"
    max_unavailable: Optional[int | str] = None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)

    kind = "PodDisruptionBudget"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------- storage


@dataclass
class PersistentVolumeClaimSpec:
    storage_class_name: Optional[str] = None
    volume_name: str = ""  # bound PV name


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    # claim phase; "Lost" marks a claim bound to a vanished volume
    # (kube-scheduler rejects such pods, volumetopology.go:178-181)
    phase: str = ""

    kind = "PersistentVolumeClaim"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    zones: Optional[list[str]] = None  # allowedTopologies zones, None = any
    # "Immediate" claims must already be bound before scheduling;
    # "WaitForFirstConsumer" claims bind after placement. Default
    # mirrors the API server's defaulting of an unset field.
    volume_binding_mode: str = "Immediate"

    kind = "StorageClass"

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    zones: Optional[list[str]] = None  # nodeAffinity-derived zone restriction
    attached_node: str = ""            # for volume-detachment tracking

    kind = "PersistentVolume"

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class CSINode:
    """Per-node CSI driver attach limits (the reference reads these
    from CSINode.spec.drivers[].allocatable.count, volumeusage.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_limits: dict[str, int] = field(default_factory=dict)  # driver -> max

    kind = "CSINode"

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class KubeEvent:
    """corev1.Event, trimmed to what the recorder emits
    (pkg/events/recorder.go:52-72 publishes through
    record.EventRecorder; operators debug real clusters by reading
    these off `kubectl describe`)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_name: str = ""
    involved_namespace: str = ""
    type: str = "Normal"      # Normal | Warning
    reason: str = ""
    message: str = ""
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    source_component: str = "karpenter"

    kind = "Event"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"
