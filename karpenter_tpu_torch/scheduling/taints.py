"""Taint toleration checking and merging.

Copy of `karpenter_tpu/scheduling/taints.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/scheduling/taints.go: `tolerates` returns the first
untolerated taint (None = all tolerated); `merge` unions by
(key, effect) match; `KNOWN_EPHEMERAL_TAINTS` are ignored on
uninitialized managed nodes.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import UNREGISTERED_NO_EXECUTE_TAINT
from karpenter_tpu_torch.kube.objects import Pod, Taint, Toleration

# Taints expected on a node while it's initializing; ignored for
# scheduling against uninitialized managed nodes (taints.go:36-43).
KNOWN_EPHEMERAL_TAINTS: tuple[Taint, ...] = (
    Taint(key="node.kubernetes.io/not-ready", effect="NoSchedule"),
    Taint(key="node.kubernetes.io/not-ready", effect="NoExecute"),
    Taint(key="node.kubernetes.io/unreachable", effect="NoSchedule"),
    Taint(key="node.cloudprovider.kubernetes.io/uninitialized", value="true", effect="NoSchedule"),
    UNREGISTERED_NO_EXECUTE_TAINT,
)


def tolerates(taints: Sequence[Taint], tolerations: Sequence[Toleration]) -> Optional[str]:
    """None if every taint is tolerated, else a message naming the first offender.

    PreferNoSchedule taints never block scheduling (k8s semantics; the
    preference ladder separately *tries* to avoid them).
    """
    for taint in taints:
        if taint.effect == "PreferNoSchedule":
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return f"did not tolerate taint {taint.key}={taint.value}:{taint.effect}"
    return None


def tolerates_pod(taints: Sequence[Taint], pod: Pod) -> Optional[str]:
    return tolerates(taints, pod.spec.tolerations)


def merge(taints: Sequence[Taint], with_taints: Iterable[Taint]) -> list[Taint]:
    """Union keeping the receiver's taints on (key, effect) conflicts."""
    out = list(taints)
    for taint in with_taints:
        if not any(t.key == taint.key and t.effect == taint.effect for t in out):
            out.append(taint)
    return out


def is_ephemeral(taint: Taint) -> bool:
    return any(
        taint.key == known.key and taint.effect == known.effect
        for known in KNOWN_EPHEMERAL_TAINTS
    )


def filter_ephemeral(taints: Sequence[Taint]) -> list[Taint]:
    return [t for t in taints if not is_ephemeral(t)]
