"""Pod scheduling predicates.

Copy of `karpenter_tpu/utils/pod.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/utils/pod/scheduling.go (the slice the rest of the
repo doesn't already cover inline): Dynamic Resource Allocation
detection, pod/scheduling.go:211-224.
"""

from __future__ import annotations

from karpenter_tpu_torch.kube.objects import Pod


def has_dra_requirements(pod: Pod) -> bool:
    """True if any container (init or main) consumes a ResourceClaim.

    Karpenter cannot simulate DRA device allocation, so such pods are
    gated out of scheduling with a permanent error while the
    ignore-dra-requests flag is on (scheduler.go:484-491).
    """
    return any(
        c.resource_claims
        for c in list(pod.spec.init_containers) + list(pod.spec.containers)
    )
