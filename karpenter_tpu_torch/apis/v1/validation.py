"""Admission-time spec validation — the CEL analogue.

Copy of `karpenter_tpu/apis/v1/validation.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The reference embeds its invariants as CEL rules in kubebuilder
markers (nodepool.go:39-41, nodeclaim.go:38-40,145,197-205) plus the
post-codegen patch scripts (hack/validation/{requirements,labels,
taint}.sh); the API server rejects bad specs before any controller
sees them. Here the in-memory client plays the API server, so the same
rules run as plain functions at create/update time and raise
InvalidError on violation.

Implemented rule set (reference source for each):
- requirements: valid operator; In needs values; Gt/Lt need exactly one
  non-negative integer; minValues in [1, 50] and <= len(values) for In;
  <= 100 requirements; restricted label keys rejected
  (nodeclaim.go:38-41,85-86; hack/validation/requirements.sh)
- template labels: restricted domains rejected
  (hack/validation/labels.sh)
- taints: non-empty key, valid effect (hack/validation/taint.sh)
- durations: expireAfter / consolidateAfter are "<n>(s|m|h)..." or
  "Never"; terminationGracePeriod never "Never" (nodeclaim.go:63,72)
- budgets: nodes is int or percentage; schedule only with duration;
  <= 50 budgets (nodepool.go:99-129)
- weight in [0, 10000] (nodepool.go:60-61 scaled; 0 = unset here)
- static pools: only limits.nodes; no weight; replicas >= 0; and the
  static/dynamic mode is immutable on update (nodepool.go:39-41)
- NodeClaim spec immutability lives in the client (nodeclaim.go:145)
"""

from __future__ import annotations

import re
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    NODEPOOL_LABEL,
    RESERVATION_ID_LABEL,
    is_restricted_label,
)

# keys the framework itself stamps onto claims (FinalizeScheduling adds
# the reservation-id pin, scheduling/nodeclaim.go:252); the reference
# admits them via its feature-gated WellKnownLabels extension
_SYSTEM_REQUIREMENT_KEYS = frozenset({RESERVATION_ID_LABEL})

VALID_OPERATORS = frozenset({"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"})
VALID_TAINT_EFFECTS = frozenset({"NoSchedule", "PreferNoSchedule", "NoExecute"})
VALID_CONSOLIDATION_POLICIES = frozenset(
    {"WhenEmpty", "WhenEmptyOrUnderutilized"}  # nodepool.go:92
)
VALID_BUDGET_REASONS = frozenset(
    {"Underutilized", "Empty", "Drifted"}  # nodepool.go:152
)
_DURATION_RE = re.compile(r"^([0-9]+(s|m|h))+$")
_BUDGET_NODES_RE = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")
# budget window length: hours/minutes only (nodepool.go:138)
_BUDGET_DURATION_RE = re.compile(r"^((([0-9]+(h|m))|([0-9]+h[0-9]+m))(0s)?)$")
# budget schedule: @-macros or 5-field cron (nodepool.go:129; the
# alternation is parenthesized as a whole so BOTH branches anchor)
_BUDGET_SCHEDULE_RE = re.compile(
    r"^(@(annually|yearly|monthly|weekly|daily|midnight|hourly)"
    r"|(.+\s){4}.+)$"
)
# label / taint qualified-name syntax (hack/validation/{labels,taint,
# requirements}.sh: key <= 316 chars with optional DNS-subdomain
# prefix; values <= 63 chars of [A-Za-z0-9-_.] with alnum ends)
_QUALIFIED_KEY_RE = re.compile(
    r"^([a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*(\/))?"
    r"([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$"
)
_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
MAX_REQUIREMENTS = 100
MAX_BUDGETS = 50
MAX_KEY_LENGTH = 316
MAX_VALUE_LENGTH = 63
MAX_TEMPLATE_LABELS = 100
MAX_WEIGHT = 100  # nodepool.go:60-61


def _validate_qualified_key(key: str, where: str) -> list[str]:
    errs = []
    if not key or len(key) > MAX_KEY_LENGTH:
        errs.append(f"{where}: key must be 1-{MAX_KEY_LENGTH} characters")
    elif not _QUALIFIED_KEY_RE.match(key):
        errs.append(f"{where}: key must be a qualified name")
    return errs


def _validate_label_value(value: str, where: str) -> list[str]:
    errs = []
    if len(value) > MAX_VALUE_LENGTH:
        errs.append(f"{where}: value must be at most {MAX_VALUE_LENGTH} characters")
    elif not _LABEL_VALUE_RE.match(value):
        errs.append(f"{where}: invalid label value syntax")
    return errs


class ValidationError(ValueError):
    """A spec the admission layer must reject."""


def _validate_duration(raw, field: str, allow_never: bool) -> Optional[str]:
    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return None  # already-parsed seconds (internal callers)
    if raw == "Never":
        return None if allow_never else f"{field}: 'Never' is not allowed"
    if not _DURATION_RE.match(str(raw)):
        return f"{field}: invalid duration {raw!r}"
    return None


def validate_requirements(requirements, field: str) -> list[str]:
    errs: list[str] = []
    if len(requirements) > MAX_REQUIREMENTS:
        errs.append(f"{field}: more than {MAX_REQUIREMENTS} requirements")
    for spec in requirements:
        where = f"{field}[{spec.key}]"
        errs += _validate_qualified_key(spec.key, where)
        for value in spec.values:
            # Gt/Lt operands are integers, exempt from label-value
            # syntax (they pass it anyway); In/NotIn values are labels
            errs += _validate_label_value(str(value), where)
        if spec.key == NODEPOOL_LABEL:
            # well-known on nodes, but user specs may not constrain it
            # (hack/validation/labels.sh: 'karpenter.sh/nodepool' is
            # restricted — the system stamps it)
            errs.append(f"{where}: label {NODEPOOL_LABEL} is restricted")
        elif spec.key not in _SYSTEM_REQUIREMENT_KEYS:
            restricted = is_restricted_label(spec.key)
            if restricted:
                errs.append(f"{where}: {restricted}")
        if spec.operator not in VALID_OPERATORS:
            errs.append(f"{where}: unknown operator {spec.operator!r}")
            continue
        if spec.operator == "In" and not spec.values:
            errs.append(f"{where}: operator 'In' must have a value defined")
        if spec.operator in ("Gt", "Lt"):
            ok = len(spec.values) == 1
            if ok:
                try:
                    ok = int(spec.values[0]) >= 0
                except ValueError:
                    ok = False
            if not ok:
                errs.append(
                    f"{where}: operator '{spec.operator}' must have a "
                    "single positive integer value"
                )
        if spec.operator in ("Exists", "DoesNotExist") and spec.values:
            errs.append(
                f"{where}: operator '{spec.operator}' must not define values"
            )
        if spec.min_values is not None:
            if not 1 <= spec.min_values <= 50:
                errs.append(f"{where}: minValues must be in [1, 50]")
            elif spec.operator == "In" and len(spec.values) < spec.min_values:
                errs.append(
                    f"{where}: 'minValues' must have at least that many "
                    "values in 'values'"
                )
    return errs


def _validate_taints(taints, field: str) -> list[str]:
    errs = []
    for taint in taints:
        if not taint.key:
            errs.append(f"{field}: taint key must not be empty")
        else:
            errs += _validate_qualified_key(taint.key, f"{field}[{taint.key}]")
        if taint.value:
            errs += _validate_label_value(
                taint.value, f"{field}[{taint.key}].value"
            )
        if taint.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"{field}: invalid taint effect {taint.effect!r}")
    return errs


def _validate_template(template) -> list[str]:
    errs = validate_requirements(
        template.spec.requirements, "spec.template.spec.requirements"
    )
    if len(template.labels) > MAX_TEMPLATE_LABELS:
        errs.append(
            f"spec.template.labels: more than {MAX_TEMPLATE_LABELS} labels"
        )
    for key, value in template.labels.items():
        restricted = is_restricted_label(key)
        if restricted:
            errs.append(f"spec.template.labels[{key}]: {restricted}")
        errs += _validate_qualified_key(key, f"spec.template.labels[{key}]")
        errs += _validate_label_value(
            str(value), f"spec.template.labels[{key}]"
        )
    errs += _validate_taints(template.spec.taints, "spec.template.spec.taints")
    errs += _validate_taints(
        template.spec.startup_taints, "spec.template.spec.startupTaints"
    )
    err = _validate_duration(
        template.spec.expire_after, "spec.template.spec.expireAfter",
        allow_never=True,
    )
    if err:
        errs.append(err)
    err = _validate_duration(
        template.spec.termination_grace_period,
        "spec.template.spec.terminationGracePeriod", allow_never=False,
    )
    if err:
        errs.append(err)
    return errs


def validate_node_pool(pool, old=None) -> None:
    """Admission check; raises ValidationError with every violation.
    `old` enables update-only (transition) rules."""
    errs = _validate_template(pool.spec.template)
    disruption = pool.spec.disruption
    err = _validate_duration(
        disruption.consolidate_after, "spec.disruption.consolidateAfter",
        allow_never=True,
    )
    if err:
        errs.append(err)
    if disruption.consolidation_policy not in VALID_CONSOLIDATION_POLICIES:
        errs.append(
            "spec.disruption.consolidationPolicy: must be one of "
            f"{sorted(VALID_CONSOLIDATION_POLICIES)}"
        )
    if len(disruption.budgets) > MAX_BUDGETS:
        errs.append(f"spec.disruption.budgets: more than {MAX_BUDGETS} budgets")
    for i, budget in enumerate(disruption.budgets):
        where = f"spec.disruption.budgets[{i}]"
        if not _BUDGET_NODES_RE.match(str(budget.nodes)):
            errs.append(f"{where}.nodes: must be an integer or percentage")
        if (budget.schedule is None) != (budget.duration is None):
            errs.append(f"{where}: 'schedule' must be set with 'duration'")
        if budget.schedule is not None and not _BUDGET_SCHEDULE_RE.match(
            str(budget.schedule)
        ):
            errs.append(f"{where}.schedule: invalid cron schedule")
        if budget.duration is not None and not isinstance(
            budget.duration, (int, float)
        ) and not _BUDGET_DURATION_RE.match(str(budget.duration)):
            errs.append(
                f"{where}.duration: must be hours/minutes (e.g. 30m, 1h30m)"
            )
        if budget.reasons is not None:
            for reason in budget.reasons:
                if reason not in VALID_BUDGET_REASONS:
                    errs.append(
                        f"{where}.reasons: {reason!r} not in "
                        f"{sorted(VALID_BUDGET_REASONS)}"
                    )
    # reference weight is 1-100, nil = unset; 0 plays nil here. The cap
    # RATCHETS: it binds on create and on writes that change weight, so
    # an object stored under an older, wider rule stays updatable as
    # long as the weight itself is untouched
    weight_changed = old is None or old.spec.weight != pool.spec.weight
    if weight_changed and not 0 <= pool.spec.weight <= MAX_WEIGHT:
        errs.append(f"spec.weight: must be in [1, {MAX_WEIGHT}] (0 = unset)")
    for key, value in pool.spec.limits.items():
        if value < 0:
            errs.append(f"spec.limits[{key}]: must be non-negative")
    if pool.is_static():
        if pool.spec.replicas < 0:
            errs.append("spec.replicas: must be non-negative")
        if pool.spec.weight:
            errs.append("'weight' is not supported on static NodePools")
        if pool.spec.limits and set(pool.spec.limits) != {"nodes"}:
            errs.append("only 'limits.nodes' is supported on static NodePools")
    if old is not None:
        if (old.spec.replicas is None) != (pool.spec.replicas is None):
            errs.append(
                "Cannot transition NodePool between static (replicas set) "
                "and dynamic (replicas unset) provisioning modes"
            )
        # nodeClassRef group/kind immutability (nodepool.go:204-205)
        old_ref = old.spec.template.spec.node_class_ref
        new_ref = pool.spec.template.spec.node_class_ref
        if old_ref is not None and new_ref is not None:
            if getattr(old_ref, "group", "") != getattr(new_ref, "group", ""):
                errs.append("nodeClassRef.group is immutable")
            if getattr(old_ref, "kind", "") != getattr(new_ref, "kind", ""):
                errs.append("nodeClassRef.kind is immutable")
    if errs:
        raise ValidationError("; ".join(errs))


def validate_node_claim(claim) -> None:
    """Admission check for NodeClaim create (spec immutability on
    update is enforced by the client, nodeclaim.go:145)."""
    errs = validate_requirements(claim.spec.requirements, "spec.requirements")
    errs += _validate_taints(claim.spec.taints, "spec.taints")
    errs += _validate_taints(claim.spec.startup_taints, "spec.startupTaints")
    err = _validate_duration(claim.spec.expire_after, "spec.expireAfter",
                             allow_never=True)
    if err:
        errs.append(err)
    err = _validate_duration(
        claim.spec.termination_grace_period, "spec.terminationGracePeriod",
        allow_never=False,
    )
    if err:
        errs.append(err)
    ref = claim.spec.node_class_ref
    if ref is not None:
        for attr in ("group", "kind", "name"):
            if not getattr(ref, attr, ""):
                errs.append(f"spec.nodeClassRef.{attr}: may not be empty")
    if errs:
        raise ValidationError("; ".join(errs))
