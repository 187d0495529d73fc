"""Preference relaxation ladder.

Copy of `karpenter_tpu/provisioning/preferences.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of provisioning/scheduling/preferences.go:38-141. When a
pod cannot schedule, its soft constraints are peeled off one rung at a
time (mutating the in-memory pod only):

  1. drop preferred node-affinity terms
  2. drop one required node-affinity term (they are ORed; the scheduler
     only considers the first, so removing it surfaces the next) — the
     FINAL term is never relaxed (preferences.go:70-76)
  3. drop ScheduleAnyway topology-spread constraints
  4. drop preferred pod affinity, then preferred anti-affinity

The reference's terminal rung (tolerate PreferNoSchedule taints,
preferences.go:129-141) has no analogue here because this build's
`tolerates` never blocks on PreferNoSchedule in the first place
(scheduling/taints.py) — same outcome, no relaxation round needed.

Returns the NAME of the rung relaxed (truthy — callers retry), or
None when the ladder is exhausted. The rung name is what the
explainability plane (karpenter_tpu_torch/explain) records per retry, so an
operator can see exactly which preference steps a pod burned before
it scheduled (or didn't).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from karpenter_tpu_torch.kube.objects import Affinity, NodeAffinity, Pod, PodAffinity

_RELAXED_MARK = "karpenter.sh/relaxed"

# ladder rung names, in relaxation order — the structured step codes
# the explain plane records
RELAX_PREFERRED_NODE_AFFINITY = "preferred-node-affinity"
RELAX_REQUIRED_NODE_AFFINITY_TERM = "required-node-affinity-term"
RELAX_SCHEDULE_ANYWAY_SPREAD = "schedule-anyway-spread"
RELAX_PREFERRED_POD_AFFINITY = "preferred-pod-affinity"
RELAX_PREFERRED_POD_ANTI_AFFINITY = "preferred-pod-anti-affinity"


def relax(pod: Pod) -> Optional[str]:
    aff = pod.spec.affinity
    # 1. preferred node affinity
    if aff and aff.node_affinity and aff.node_affinity.preferred:
        pod.spec.affinity = replace(
            aff, node_affinity=replace(aff.node_affinity, preferred=())
        )
        return RELAX_PREFERRED_NODE_AFFINITY
    # 2. required node affinity terms (drop the first OR-term)
    if aff and aff.node_affinity and len(aff.node_affinity.required) > 1:
        pod.spec.affinity = replace(
            aff,
            node_affinity=replace(aff.node_affinity, required=aff.node_affinity.required[1:]),
        )
        return RELAX_REQUIRED_NODE_AFFINITY_TERM
    # 3. ScheduleAnyway spread constraints
    soft_tsc = [
        t for t in pod.spec.topology_spread_constraints
        if t.when_unsatisfiable == "ScheduleAnyway"
    ]
    if soft_tsc:
        pod.spec.topology_spread_constraints = [
            t for t in pod.spec.topology_spread_constraints
            if t.when_unsatisfiable != "ScheduleAnyway"
        ]
        return RELAX_SCHEDULE_ANYWAY_SPREAD
    # 4. preferred pod affinity / anti-affinity
    if aff and aff.pod_affinity and aff.pod_affinity.preferred:
        pod.spec.affinity = replace(
            aff, pod_affinity=replace(aff.pod_affinity, preferred=())
        )
        return RELAX_PREFERRED_POD_AFFINITY
    if aff and aff.pod_anti_affinity and aff.pod_anti_affinity.preferred:
        pod.spec.affinity = replace(
            aff, pod_anti_affinity=replace(aff.pod_anti_affinity, preferred=())
        )
        return RELAX_PREFERRED_POD_ANTI_AFFINITY
    return None


def relaxable(pod: Pod) -> bool:
    """True when relax() would strip something — WITHOUT mutating the
    pod. Retained-state fast paths (the incremental live tick, the
    batched probe solver) use this to decide whether an unscheduled
    pod must route to the full Scheduler's relaxation ladder; calling
    relax() to find out would mutate the pod the full path is about to
    re-solve."""
    aff = pod.spec.affinity
    if aff and aff.node_affinity:
        if aff.node_affinity.preferred:
            return True
        if len(aff.node_affinity.required) > 1:
            return True
    if any(
        t.when_unsatisfiable == "ScheduleAnyway"
        for t in pod.spec.topology_spread_constraints
    ):
        return True
    if aff:
        if aff.pod_affinity and aff.pod_affinity.preferred:
            return True
        if aff.pod_anti_affinity and aff.pod_anti_affinity.preferred:
            return True
    return False
