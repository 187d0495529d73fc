"""Well-known labels.

Copy of `karpenter_tpu/apis/v1/labels.py`, trimmed to the vocabulary
the requirement algebra, the catalog and the encode read.
"""

from __future__ import annotations

GROUP = "karpenter.sh"

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
CAPACITY_TYPE_LABEL = f"{GROUP}/capacity-type"
RESERVATION_ID_LABEL = f"{GROUP}/reservation-id"

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

# Aliased -> canonical label translation (labels.go NormalizedLabels)
NORMALIZED_LABELS: dict[str, str] = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE_LABEL,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION_LABEL,
    "beta.kubernetes.io/arch": ARCH_LABEL,
    "beta.kubernetes.io/os": OS_LABEL,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE_LABEL,
}

