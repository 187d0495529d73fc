"""Priority-ordered admission: overload degrades by policy, not luck.

Copy of `karpenter_tpu/provisioning/priority.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Under overload (demand > NodePool limits or catalog capacity) the
solver's unscheduled set used to be an accident of encode order — FFD
fills whatever fits, so WHICH pods starve depended on shapes, not
importance. "Priority Matters" (PAPERS.md) frames the right contract:
with PriorityClass semantics resolved, the unscheduled set must be
exactly the lowest-priority tail of the admission order, ties broken
by the solver's own deterministic pod order (group_pods' priority-major
FFD sort — the pod order the encode already commits to).

The contract is enforced by `Provisioner._enforce_priority_admission`
(a host-side wrapper around the unchanged solve): when a solve leaves
CAPACITY-class failures among pods that are placeable in principle,
the admission cutoff moves to the highest-priority such failure and
everything at or past the cutoff is shed with `PRIORITY_SHED_ERROR`
while the admitted prefix re-solves clean. Pods that could never
schedule (no compatible launchable config, or too big for any machine)
are OUTSIDE the contract: they keep their own errors and never drag
the tail down with them.

Engages only when the round's pods span MORE THAN ONE priority —
uniform-priority rounds (every pod 0, the default) are byte-identical
to the pre-priority behavior.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.utils import resources as resutil

log = logging.getLogger("karpenter.priority")

# capacity-class failure strings: truncation the admission contract
# covers. Everything else (DRA, timeouts, topology infeasibility,
# minValues policy rejects) is a permanent/transient error in its own
# right — shedding the tail below such a pod would turn one wedged pod
# into a cluster-wide outage. NO_CAPACITY_ERROR is canonical in
# scheduler.py (its producer); LIMITS_ERROR is canonical HERE and
# produced by Provisioner.create_node_claims — both matched by exact
# string equality, so producers and consumers import, never respell.
from karpenter_tpu_torch.provisioning.scheduler import NO_CAPACITY_ERROR  # noqa: E402,F401

LIMITS_ERROR = "nodepool limits exceeded"

PRIORITY_SHED_ERROR = (
    "insufficient capacity; shed by priority admission (lower-priority "
    "tail, will retry next round)"
)

# capacity-class errors preemption may act on for a pending pod
CAPACITY_ERRORS = (NO_CAPACITY_ERROR, LIMITS_ERROR, PRIORITY_SHED_ERROR)


def mixed_priorities(pods: Sequence[Pod]) -> bool:
    """True when the pod set spans more than one resolved priority —
    the only case in which there IS a priority order to honor."""
    seen: Optional[int] = None
    for pod in pods:
        p = pod.spec.priority
        if seen is None:
            seen = p
        elif p != seen:
            return True
    return False


def admission_order(pods: Sequence[Pod]) -> list[Pod]:
    """The admission order the contract is defined over: groups sorted
    priority-major by group_pods (ties broken by the existing
    deterministic FFD order), flattened group-major with pods in
    arrival order within a group — exactly the pod order the encode's
    decode tables commit to."""
    from karpenter_tpu_torch.solver.encode import group_pods

    return [p for g in group_pods(pods) for p in g.pods]


def enforce_admission(
    pods: Sequence[Pod],
    pools,
    results,
    solve_fn,
    plans_over_limits=None,
    daemon_overhead=None,
    note: bool = True,
):
    """The overload degradation contract, shared by every solve path:
    when capacity (catalog or pool limits) truncates the solve, the
    unscheduled set must be exactly the lowest-priority tail of the
    admission order. Iterates cutoff-and-re-solve until the admitted
    prefix is clean; the cutoff strictly decreases, so the loop
    terminates. No-op on uniform-priority rounds.

    - `solve_fn(keep)` re-solves the admitted prefix (the full path
      passes a fresh Scheduler solve; the incremental tick its own
      retained-state core — an escape there aborts the loop by
      raising through this frame).
    - `plans_over_limits(plans)` simulates NodePool limit rejection
      (Provisioner._plans_over_limits); None skips limit folding.
    - `daemon_overhead()` lazily supplies the per-pool overhead the
      placeability check charges (built only on the first failure).
    - `note=False` suppresses metrics/explain/tracing — the oracle
      audit's shadow run must not double-count the live decision."""
    pods = list(pods)
    if not mixed_priorities(pods):
        return results
    # order/placeable are built lazily on the FIRST capacity failure:
    # the healthy mixed-priority round pays only the mixed scan above
    # and the caller's limit simulation
    order: Optional[list] = None
    pos: dict = {}
    placeable: set = set()
    cut = 0
    for _ in range(16):
        raw_failed = [
            key for key, error in results.errors.items()
            if error == NO_CAPACITY_ERROR
        ]
        if plans_over_limits is not None:
            for plan in plans_over_limits(results.new_node_plans):
                raw_failed.extend(p.key for p in plan.pods)
        if order is None:
            if not raw_failed:
                return results
            order = admission_order(pods)
            pos = {p.key: i for i, p in enumerate(order)}
            cut = len(order)
            placeable = placeable_keys(
                pods, pools,
                daemon_overhead() if daemon_overhead is not None else None,
            )
        failed = [
            k for k in raw_failed
            if k in placeable and pos.get(k, cut) < cut
        ]
        if not failed:
            break
        cut = min(pos[k] for k in failed)
        # re-solve the admitted prefix; unplaceable pods rejoin so
        # their permanent errors keep reporting
        keep = order[:cut] + [
            p for p in order[cut:] if p.key not in placeable
        ]
        results = solve_fn(keep)
    else:
        if note:
            log.warning(
                "priority admission did not converge in 16 rounds; "
                "serving the last solve's results"
            )
    if order is None or cut >= len(order):
        return results
    shed = [p for p in order[cut:] if p.key in placeable]
    for pod in shed:
        results.errors[pod.key] = PRIORITY_SHED_ERROR
    if shed and note:
        from karpenter_tpu_torch import explain, tracing
        from karpenter_tpu_torch.metrics.store import PRIORITY_SHED

        tracing.annotate(shed=len(shed),
                         cutoff_priority=order[cut].spec.priority)
        if explain.active() is not None:
            # the admission cutoff is the explanation: the pod was
            # placeable, but everything at or past this priority was
            # shed so the higher-priority prefix stays clean
            cutoff = int(order[cut].spec.priority)
            for pod in shed:
                explain.note_pod(
                    pod.key, verdict="shed", code="priority_shed",
                    cutoff_priority=cutoff,
                    pod_priority=int(pod.spec.priority),
                )
        PRIORITY_SHED.inc(value=float(len(shed)))
        log.warning(
            "priority admission: demand exceeds capacity; shed %d "
            "pod(s) at or below priority %d (cutoff honors the "
            "deterministic admission order)",
            len(shed), order[cut].spec.priority,
        )
    return results


def placeable_keys(
    pods: Sequence[Pod],
    pools_with_types,
    daemon_overhead: Optional[dict[str, dict[str, float]]] = None,
) -> set[str]:
    """Keys of pods that are placeable in principle: compatible with at
    least one launchable config (requirements AND taints) whose
    allocatable holds the pod's requests plus the pool's daemon
    overhead. Only these participate in the tail contract — a pod no
    catalog machine could ever hold is not 'capacity-truncated', it is
    unschedulable, and must not shed the tail below it."""
    from karpenter_tpu_torch.solver.encode import (
        _full_compat,
        group_pods,
        launch_configs,
    )

    groups = group_pods(pods)
    configs = launch_configs(pools_with_types)
    if not configs or not groups:
        return set()
    compat = _full_compat(groups, configs)
    overhead = daemon_overhead or {}
    out: set[str] = set()
    for gi, group in enumerate(groups):
        for ci in np.flatnonzero(compat[gi]):
            cfg = configs[ci]
            need = resutil.merge(
                group.resources,
                overhead.get(cfg.pool.metadata.name, {}),
            )
            if resutil.fits(need, cfg.instance_type.allocatable):
                out.update(p.key for p in group.pods)
                break
    return out
