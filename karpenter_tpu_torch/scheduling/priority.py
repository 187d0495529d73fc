"""Pod priority resolution from PriorityClass objects.

Copy of `karpenter_tpu/scheduling/priority.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

On a real cluster the priority admission plugin stamps
`pod.spec.priority` from `priorityClassName` at create time
(kube-apiserver, plugin/pkg/admission/priority). This substrate has no
admission chain, so the provisioner resolves priorities at intake —
and the Scheduler re-resolves at every solve entry (the
volume-topology pattern) so disruption simulations and scripted solves
see the same numbers no matter which caller stamped last.

Rules, mirroring the admission plugin:

- an already-stamped nonzero `spec.priority` wins (the pod was
  admitted with it; re-resolution must not flip it);
- `priorityClassName` resolves to that class's value; a dangling name
  is logged and left at 0 (admission would have rejected the pod —
  here it must not take the tick down);
- with no class name, the cluster's global-default class applies
  (highest value wins if several are marked default — k8s admission
  forbids that state, this substrate just needs a deterministic pick);
- otherwise 0.

The two built-in system classes are known without cluster objects.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Sequence

from karpenter_tpu_torch.kube.objects import Pod, PriorityClass

log = logging.getLogger("karpenter.priority")

# built-in classes every cluster has (k8s bootstraps them)
SYSTEM_CLASSES = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}

PREEMPT_LOWER_PRIORITY = "PreemptLowerPriority"
PREEMPT_NEVER = "Never"


def class_map(classes: Iterable[PriorityClass]) -> dict[str, PriorityClass]:
    return {c.metadata.name: c for c in classes}


def default_class(
    classes: Iterable[PriorityClass],
) -> Optional[PriorityClass]:
    """The cluster's global-default class; ties (an invalid state a
    real apiserver rejects) break on (value, name) for determinism."""
    defaults = [c for c in classes if c.global_default]
    if not defaults:
        return None
    return max(defaults, key=lambda c: (c.value, c.metadata.name))


def resolve_priority(
    pod: Pod, classes: dict[str, PriorityClass],
    default: Optional[PriorityClass] = None,
) -> int:
    """The priority this pod schedules at (does not mutate the pod)."""
    if pod.spec.priority:
        return pod.spec.priority
    name = pod.spec.priority_class_name
    if name:
        if name in SYSTEM_CLASSES:
            return SYSTEM_CLASSES[name]
        cls = classes.get(name)
        if cls is None:
            log.warning(
                "pod %s references unknown PriorityClass %r; "
                "scheduling at priority 0", pod.key, name,
            )
            return 0
        return cls.value
    return default.value if default is not None else 0


def resolve_pod_priorities(pods: Sequence[Pod], kube) -> None:
    """Stamp `spec.priority` in place for every pod whose class name
    (or the cluster default) resolves — the admission-plugin analogue,
    run at provisioner intake and at every Scheduler solve entry. The
    stamp is idempotent: a nonzero priority is never overwritten."""
    if kube is None or not pods:
        return
    classes = class_map(kube.list("PriorityClass"))
    if not classes and not any(
        p.spec.priority_class_name for p in pods
    ):
        return
    default = default_class(classes.values())
    for pod in pods:
        if pod.spec.priority:
            continue
        value = resolve_priority(pod, classes, default)
        if value:
            pod.spec.priority = value


def preemption_allowed(
    pod: Pod, classes: dict[str, PriorityClass]
) -> bool:
    """Whether this pod's class permits nominating victims
    (preemptionPolicy: Never pods queue above lower priorities but
    never evict them)."""
    name = pod.spec.priority_class_name
    if not name or name in SYSTEM_CLASSES:
        return True
    cls = classes.get(name)
    return cls is None or cls.preemption_policy != PREEMPT_NEVER
