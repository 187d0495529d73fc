"""Per-node host-port conflict tracking.

Copy of `karpenter_tpu/scheduling/hostports.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/scheduling/hostportusage.go: pods requesting host
ports conflict when (hostIP, port, protocol) overlap on one node
(0.0.0.0 conflicts with everything).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.kube.objects import Pod


@dataclass(frozen=True)
class HostPort:
    ip: str
    port: int

    def conflicts(self, other: "HostPort") -> bool:
        if self.port != other.port:
            return False
        return self.ip == other.ip or self.ip == "0.0.0.0" or other.ip == "0.0.0.0"


def pod_host_ports(pod: Pod) -> list[HostPort]:
    out = []
    for container in list(pod.spec.containers) + list(pod.spec.init_containers):
        for port in container.ports:
            out.append(HostPort(ip=container.host_ip or "0.0.0.0", port=port))
    return out


class HostPortUsage:
    """Tracks host ports reserved on one (planned or real) node."""

    def __init__(self) -> None:
        self._reserved: dict[str, list[HostPort]] = {}  # pod key -> ports

    def conflict(self, pod: Pod) -> Optional[str]:
        wanted = pod_host_ports(pod)
        for ports in self._reserved.values():
            for existing in ports:
                for want in wanted:
                    if want.conflicts(existing):
                        return f"host port {want.port} conflicts with existing pod"
        return None

    def add(self, pod: Pod) -> None:
        self._reserved[pod.key] = pod_host_ports(pod)

    def remove(self, pod_key: str) -> None:
        self._reserved.pop(pod_key, None)

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out._reserved = {k: list(v) for k, v in self._reserved.items()}
        return out
