"""PVC-driven zonal requirements + CSI volume-limit context.

Copy of `karpenter_tpu/provisioning/volume_topology.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of provisioning/scheduling/volumetopology.go:51-160: a pod
referencing a BOUND PVC must schedule into the persistent volume's
zone; a pod with an unbound PVC whose StorageClass restricts
allowedTopologies must schedule into one of those zones. The derived
requirement is stored on `pod.spec.injected_requirements` (transient,
re-derived every round) where `Requirements.from_pod` picks it up for
both the batched solver encoding and the per-pod path.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from karpenter_tpu_torch.apis.v1.labels import TOPOLOGY_ZONE_LABEL
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.kube.client import KubeClient


# CSI provisioners the installed providers cannot serve; providers
# populate this (scheduling.UnsupportedProvisioners in the reference,
# empty by default)
UNSUPPORTED_PROVISIONERS: set[str] = set()


def _pvc_name_for(pod: Pod, vol) -> "str | None":
    """The claim a pod volume references, or None for claimless kinds
    (emptyDir/hostPath/NFS). Generic ephemeral volumes resolve to
    their '<pod>-<volume>' claim — the single naming contract shared
    by intake validation and zone injection."""
    if vol.ephemeral:
        return f"{pod.metadata.name}-{vol.name}"
    return vol.pvc_name or None


def _owned_by(pvc, pod: Pod) -> bool:
    # kind+name+UID, as kube-scheduler's ephemeral.VolumeIsForPod
    # checks: a stale claim left by a deleted same-name pod must not
    # pass as the recreated pod's own
    return any(
        ref.kind == "Pod"
        and ref.name == pod.metadata.name
        and ref.uid == pod.metadata.uid
        for ref in pvc.metadata.owner_references
    )


def validate_pvcs(pod: Pod, kube: "KubeClient") -> "str | None":
    """Why this pod cannot be provisioned w.r.t. its PVCs, or None.

    Mirrors ValidatePersistentVolumeClaims
    (volumetopology.go:160-215): the cases kube-scheduler itself
    rejects — deleting or Lost claims, bound claims whose volume is
    gone, unbound claims with no / unknown / Immediate-mode /
    unsupported-provisioner storage class. Such pods are filtered at
    intake rather than churning the scheduler every round.
    """
    for vol in pod.spec.volumes:
        pvc_name = _pvc_name_for(pod, vol)
        if pvc_name is None:
            continue  # emptyDir/hostPath/NFS-style volumes: no claim
        pvc = kube.get_pvc(pod.metadata.namespace, pvc_name)
        if pvc is None:
            if vol.ephemeral:
                continue  # created after scheduling; nothing to check
            return f"persistentvolumeclaim {pvc_name} not found"
        if vol.ephemeral and not _owned_by(pvc, pod):
            # an existing claim under the ephemeral name that the pod
            # does not own is rejected by kube-scheduler forever
            # (volumeutil.GetPersistentVolumeClaim ownership check)
            return (
                f"persistentvolumeclaim {pvc_name} exists but is not "
                "owned by the pod"
            )
        if pvc.metadata.deletion_timestamp is not None:
            return f"persistentvolumeclaim {pvc_name} is being deleted"
        if pvc.phase == "Lost":
            return (
                f"persistentvolumeclaim {pvc_name} bound to "
                "non-existent persistentvolume"
            )
        if pvc.spec.volume_name:
            if kube.get_pv(pvc.spec.volume_name) is None:
                return (
                    f"persistentvolume {pvc.spec.volume_name} not found"
                )
            continue
        sc_name = pvc.spec.storage_class_name
        if not sc_name:
            return f"unbound persistentvolumeclaim {pvc_name} must define a storage class"
        sc = kube.get_storage_class(sc_name)
        if sc is None:
            return f"storage class {sc_name} not found"
        if sc.volume_binding_mode == "Immediate":
            return (
                f"persistentvolumeclaim {pvc_name} with immediate "
                "volume binding mode must be bound"
            )
        if sc.provisioner in UNSUPPORTED_PROVISIONERS:
            return f"provisioner {sc.provisioner} is not supported"
    return None


def inject(pod: Pod, kube: "KubeClient") -> None:
    """Re-derive the pod's PVC zonal requirements for this round."""
    reqs: list[Requirement] = []
    for vol in pod.spec.volumes:
        pvc_name = _pvc_name_for(pod, vol)
        if pvc_name is None:
            continue
        pvc = kube.get_pvc(pod.metadata.namespace, pvc_name)
        if pvc is None:
            continue
        zones = None
        if pvc.spec.volume_name:
            pv = kube.get_pv(pvc.spec.volume_name)
            if pv is not None and pv.zones:
                zones = pv.zones
        elif pvc.spec.storage_class_name:
            sc = kube.get_storage_class(pvc.spec.storage_class_name)
            if sc is not None and sc.zones:
                zones = sc.zones
        if zones:
            reqs.append(Requirement(TOPOLOGY_ZONE_LABEL, IN, list(zones)))
    pod.spec.injected_requirements = reqs
