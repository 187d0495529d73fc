"""Elimination funnel: which constraint killed which instance types.

Copy of `karpenter_tpu/explain/funnel.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

An unschedulable pod's flat `NO_CAPACITY_ERROR` hides a staged story
the encoder already told in masks: the catalog shrank through
requirements, then taints, then resource axes, then offering budgets —
and whatever survived was eliminated by the kernel (existing capacity
committed, pool limits, placement conflicts). This module replays that
attrition as explicit stages with surviving-type counts:

    948/1000 types survived requirements -> 12 survived taints
        -> 0 fit memory

The funnel is computed LAZILY, only for pods the solve actually failed
(never on the healthy path), from the same primitives the encode uses
(`encode.requirement_compat` — the G x C vocab-mask compat the solver
ships to the device — plus the taint/fit checks), so the explanation
can never drift from what the solver saw. Counts are over distinct
instance-type names (what an operator recognizes), not raw config
columns.
"""

from __future__ import annotations

from typing import Optional, Sequence

from karpenter_tpu_torch.utils import resources as resutil

# stage names, in funnel order; `kernel` is the terminal stage for
# pods every host-side filter admitted but the solve still rejected
STAGE_CATALOG = "catalog"
STAGE_REQUIREMENTS = "requirements"
STAGE_TAINTS = "taints"
STAGE_RESOURCES = "resources"
STAGE_BUDGETS = "offering-budgets"
STAGE_KERNEL = "kernel"


def _type_count(configs) -> int:
    return len({c.instance_type.name for c in configs})


def compute(
    pod,
    pools_with_types,
    existing_inputs: Sequence = (),
    daemon_overhead: Optional[dict] = None,
    reserved_in_use: Optional[dict[str, int]] = None,
) -> dict:
    """The elimination funnel for one pod against one catalog. Pure
    function of its inputs (deterministic under fault replay); called
    only for solve failures, so its O(catalog) scans are off the
    healthy path."""
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    from karpenter_tpu_torch.scheduling.taints import tolerates
    from karpenter_tpu_torch.solver.encode import (
        group_pods,
        launch_configs,
        requirement_compat,
    )

    overhead = daemon_overhead or {}
    in_use = reserved_in_use or {}
    configs = launch_configs(pools_with_types)
    group = group_pods([pod])[0]
    stages: list[dict] = [
        {"stage": STAGE_CATALOG, "survivors": _type_count(configs)}
    ]
    funnel = {"types_total": _type_count(configs), "stages": stages}

    def _push(stage: str, survivors, eliminated_by: Optional[str]) -> bool:
        """Append one stage; returns False (stop) when the funnel hit
        zero — `eliminated_by` names the constraint that emptied it."""
        entry: dict = {"stage": stage, "survivors": _type_count(survivors)}
        if not survivors and eliminated_by:
            entry["eliminated_by"] = eliminated_by
        stages.append(entry)
        return bool(survivors)

    # requirements: the SAME vocab-mask compat the encode ships
    compat = requirement_compat([group], configs)
    req_surv = [c for ci, c in enumerate(configs) if compat[0, ci]]
    if not req_surv:
        # name the keys no config can satisfy alone (each checked via
        # the same compat machinery, one single-key pseudo-group each;
        # _compat_matrix reads only group.requirements, so one reused
        # group with the field swapped per key suffices)
        from dataclasses import replace as _replace

        blocking = []
        for key in sorted(group.requirements.keys()):
            single = Requirements([group.requirements.get(key).copy()])
            row = requirement_compat(
                [_replace(group, requirements=single)], configs
            )
            if not row.any():
                blocking.append(key)
        _push(
            STAGE_REQUIREMENTS, req_surv,
            "requirement " + ", ".join(blocking) if blocking
            else "pod requirements",
        )
        return funnel
    _push(STAGE_REQUIREMENTS, req_surv, None)

    # taints / tolerations
    taint_surv, offenders = [], {}
    for cfg in req_surv:
        err = tolerates(cfg.taints, list(group.tolerations))
        if err is None:
            taint_surv.append(cfg)
        else:
            offenders[err] = offenders.get(err, 0) + 1
    if not _push(
        STAGE_TAINTS, taint_surv,
        max(sorted(offenders), key=lambda k: offenders[k])
        if offenders else "taints",
    ):
        return funnel

    # resource axes: requests + the pool's daemon overhead must fit
    # the type's allocatable; the axis failing on the most survivors
    # names the bottleneck ("0 fit memory")
    fit_surv, axis_fails = [], {}
    for cfg in taint_surv:
        need = resutil.merge(
            group.resources, overhead.get(cfg.pool.metadata.name, {})
        )
        alloc = cfg.instance_type.allocatable
        bad = [k for k, v in need.items() if v > alloc.get(k, 0.0)]
        if bad:
            for k in bad:
                axis_fails[k] = axis_fails.get(k, 0) + 1
        else:
            fit_surv.append(cfg)
    if not _push(
        STAGE_RESOURCES, fit_surv,
        max(sorted(axis_fails), key=lambda k: axis_fails[k])
        if axis_fails else "resources",
    ):
        return funnel

    # offering budgets: a reserved offering only launches while its
    # reservation has instances left (spot-stripped pools never reach
    # here — their spot columns were removed before the catalog)
    budget_surv = [
        cfg for cfg in fit_surv
        if not cfg.offering.is_reserved()
        or cfg.offering.reservation_capacity
        - in_use.get(cfg.offering.reservation_id, 0) > 0
    ]
    if not _push(
        STAGE_BUDGETS, budget_surv, "reservation budget exhausted"
    ):
        return funnel

    # whatever survived every host-side filter was eliminated by the
    # kernel itself: capacity already committed this round, pool
    # limits, topology/placement conflicts, or existing-node quotas
    stages.append({
        "stage": STAGE_KERNEL, "survivors": 0,
        "eliminated_by": "kernel no-capacity (capacity committed, "
                         "pool limits, or placement conflicts)",
    })
    funnel["existing_compatible"] = _existing_compatible(
        group, existing_inputs
    )
    return funnel


def _existing_compatible(group, existing_inputs: Sequence) -> int:
    """How many existing/in-flight nodes could host the pod on
    requirements+taints+remaining room — context for the kernel stage
    ('12 existing nodes were compatible but full' reads differently
    from '0 were')."""
    from karpenter_tpu_torch.apis.v1.labels import WELL_KNOWN_LABELS
    from karpenter_tpu_torch.scheduling.taints import tolerates

    n = 0
    for inp in existing_inputs:
        if tolerates(inp.taints, list(group.tolerations)) is not None:
            continue
        if not inp.requirements.is_compatible(
            group.requirements, allow_undefined=WELL_KNOWN_LABELS
        ):
            continue
        if resutil.fits(group.resources, inp.available):
            n += 1
    return n


def top_exclusions(pod_record: Optional[dict], k: int = 3) -> list[str]:
    """The top-k exclusion reasons for one pod record, largest
    type-drop first — the strings folded into the unschedulable-pod
    corev1 Event message."""
    if not pod_record:
        return []
    funnel = pod_record.get("funnel")
    if not funnel:
        code = pod_record.get("code")
        return [code] if code else []
    stages = funnel.get("stages", [])
    drops = []
    prev = None
    for entry in stages:
        survivors = entry["survivors"]
        if prev is not None and survivors < prev["survivors"]:
            label = f"{entry['stage']} eliminated " \
                    f"{prev['survivors'] - survivors}/{prev['survivors']} types"
            by = entry.get("eliminated_by")
            if by:
                label += f" ({by})"
            drops.append((prev["survivors"] - survivors, label))
        prev = entry
    drops.sort(key=lambda t: -t[0])
    return [label for _, label in drops[:k]]


def render(pod_record: dict) -> str:
    """One pod's funnel as the human-readable arrow chain the README
    documents: '948/1000 types survived requirements -> ...'."""
    funnel = pod_record.get("funnel")
    lines = []
    if funnel:
        total = funnel.get("types_total", 0)
        parts = []
        for entry in funnel.get("stages", []):
            if entry["stage"] == STAGE_CATALOG:
                continue
            label = f"{entry['survivors']}/{total} survived {entry['stage']}"
            by = entry.get("eliminated_by")
            if by:
                label += f" [{by}]"
            parts.append(label)
        lines.append(" -> ".join(parts))
        if "existing_compatible" in funnel:
            lines.append(
                f"existing nodes compatible but unavailable: "
                f"{funnel['existing_compatible']}"
            )
    for step in pod_record.get("relaxed", []):
        lines.append(f"relaxed: {step}")
    if pod_record.get("error"):
        lines.append(f"error: {pod_record['error']}")
    return "\n".join(lines) if lines else "(no funnel recorded)"
