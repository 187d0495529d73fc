"""Per-node CSI volume-limit accounting.

Copy of `karpenter_tpu/scheduling/volumeusage.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/scheduling/volumeusage.go: each node supports a
bounded number of attached volumes per CSI driver; pods referencing
PVCs consume slots keyed by the storage class' provisioner. Volume
counting is by unique volume (a PVC shared by two pods counts once).
"""

from __future__ import annotations

from typing import Optional, TYPE_CHECKING

from karpenter_tpu_torch.kube.objects import Pod

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.kube.client import KubeClient


def pod_volume_drivers(pod: Pod, kube: "Optional[KubeClient]") -> dict[str, set[str]]:
    """driver -> unique volume ids consumed by this pod."""
    out: dict[str, set[str]] = {}
    if kube is None:
        return out
    for vol in pod.spec.volumes:
        pvc_name = vol.pvc_name
        if vol.ephemeral:
            pvc_name = f"{pod.metadata.name}-{vol.name}"
        if not pvc_name:
            continue
        pvc = kube.get_pvc(pod.metadata.namespace, pvc_name)
        if pvc is None:
            continue
        sc_name = pvc.spec.storage_class_name
        driver = "kubernetes.io/no-provisioner"
        if sc_name:
            sc = kube.get_storage_class(sc_name)
            if sc is not None:
                driver = sc.provisioner
        volume_id = pvc.spec.volume_name or f"pvc:{pvc.key}"
        out.setdefault(driver, set()).add(volume_id)
    return out


class VolumeUsage:
    """Tracks attached volumes per driver on one node."""

    def __init__(self, limits: Optional[dict[str, int]] = None):
        self._volumes: dict[str, set[str]] = {}
        self.limits = dict(limits or {})

    def exceeds_limits(self, pod: Pod, kube: "Optional[KubeClient]") -> Optional[str]:
        for driver, vols in pod_volume_drivers(pod, kube).items():
            limit = self.limits.get(driver)
            if limit is None:
                continue
            combined = self._volumes.get(driver, set()) | vols
            if len(combined) > limit:
                return f"would exceed volume limit for CSI driver {driver} ({limit})"
        return None

    def add(self, pod: Pod, kube: "Optional[KubeClient]") -> None:
        for driver, vols in pod_volume_drivers(pod, kube).items():
            self._volumes.setdefault(driver, set()).update(vols)

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage(self.limits)
        out._volumes = {k: set(v) for k, v in self._volumes.items()}
        return out
