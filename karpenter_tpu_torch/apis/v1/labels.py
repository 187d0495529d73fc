"""Well-known labels, annotations, taints and restricted-label rules.

Copy of `karpenter_tpu/apis/v1/labels.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of the reference's pkg/apis/v1/labels.go:42-150 and
pkg/apis/v1/taints.go:27-41 — the shared vocabulary the scheduler's
set algebra operates over.
"""

from __future__ import annotations

from karpenter_tpu_torch.kube.objects import Taint

GROUP = "karpenter.sh"
COMPATIBILITY_GROUP = "compatibility.karpenter.sh"

# Kubernetes well-known node labels
TOPOLOGY_ZONE_LABEL = "topology.kubernetes.io/zone"
TOPOLOGY_REGION_LABEL = "topology.kubernetes.io/region"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"
HOSTNAME_LABEL = "kubernetes.io/hostname"
WINDOWS_BUILD_LABEL = "node.kubernetes.io/windows-build"

# Capacity types / architectures
ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# Karpenter-specific labels
NODEPOOL_LABEL = f"{GROUP}/nodepool"
NODE_INITIALIZED_LABEL = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL = f"{GROUP}/registered"
DO_NOT_SYNC_TAINTS_LABEL = f"{GROUP}/do-not-sync-taints"
CAPACITY_TYPE_LABEL = f"{GROUP}/capacity-type"
RESERVATION_ID_LABEL = f"{GROUP}/reservation-id"

# Per-NodePool spot availability targets (annotations so no schema
# migration is needed; the env knobs KARPENTER_SPOT_MAX_FRACTION /
# KARPENTER_SPOT_MIN_ON_DEMAND give the fleet-wide defaults).
SPOT_MAX_FRACTION_ANNOTATION = f"{GROUP}/spot-max-fraction"
SPOT_MIN_ON_DEMAND_ANNOTATION = f"{GROUP}/spot-min-on-demand"

# Annotations
DO_NOT_DISRUPT_ANNOTATION = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION = f"{GROUP}/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION = f"{GROUP}/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION = f"{GROUP}/nodeclaim-min-values-relaxed"
NODEPOOL_HASH_VERSION = "v3"

# Finalizers
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Taints applied by the framework (reference taints.go:27-41)
DISRUPTED_TAINT_KEY = f"{GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"
DISRUPTED_NO_SCHEDULE_TAINT = Taint(key=DISRUPTED_TAINT_KEY, effect="NoSchedule")
UNREGISTERED_NO_EXECUTE_TAINT = Taint(key=UNREGISTERED_TAINT_KEY, effect="NoExecute")

RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})
LABEL_DOMAIN_EXCEPTIONS = frozenset({
    "kops.k8s.io",
    "node.kubernetes.io",
    "node-restriction.kubernetes.io",
})

WELL_KNOWN_LABELS = frozenset({
    NODEPOOL_LABEL,
    TOPOLOGY_ZONE_LABEL,
    TOPOLOGY_REGION_LABEL,
    INSTANCE_TYPE_LABEL,
    ARCH_LABEL,
    OS_LABEL,
    CAPACITY_TYPE_LABEL,
    WINDOWS_BUILD_LABEL,
})

WELL_KNOWN_VALUES_FOR_REQUIREMENTS: dict[str, frozenset[str]] = {
    CAPACITY_TYPE_LABEL: frozenset(
        {CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT, CAPACITY_TYPE_RESERVED}
    ),
}

WELL_KNOWN_LABELS_FOR_OFFERINGS = frozenset({TOPOLOGY_ZONE_LABEL, CAPACITY_TYPE_LABEL})

RESTRICTED_LABELS = frozenset({HOSTNAME_LABEL})

# Aliased -> canonical label translation (labels.go NormalizedLabels)
NORMALIZED_LABELS: dict[str, str] = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE_LABEL,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION_LABEL,
    "beta.kubernetes.io/arch": ARCH_LABEL,
    "beta.kubernetes.io/os": OS_LABEL,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE_LABEL,
}


def label_domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_node_label(key: str) -> bool:
    """True if the framework must not inject this label onto nodes."""
    if key in RESTRICTED_LABELS:
        return True
    domain = label_domain(key)
    if not domain:
        return False
    if domain in LABEL_DOMAIN_EXCEPTIONS or any(
        domain.endswith("." + exc) for exc in LABEL_DOMAIN_EXCEPTIONS
    ):
        return False
    if key in WELL_KNOWN_LABELS:
        return False
    return domain in RESTRICTED_LABEL_DOMAINS or any(
        domain.endswith("." + rd) for rd in RESTRICTED_LABEL_DOMAINS
    )


def is_restricted_label(key: str) -> str | None:
    """Returns an error string if a user-supplied label key is restricted."""
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return (
            f"label {key} is restricted; specify a well known label "
            f"or a custom label that does not use a restricted domain"
        )
    return None


def has_known_values(key: str, values: list[str]) -> str | None:
    """Error if a well-known requirement carries only unknown values."""
    known = WELL_KNOWN_VALUES_FOR_REQUIREMENTS.get(key)
    if known is None:
        return None
    if not any(v in known for v in values):
        return f"invalid values {values} for key {key}, expected one of {sorted(known)}"
    return None
