"""Single-key requirement as a value set with operator semantics.

Copy of `karpenter_tpu/scheduling/requirement.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Behavioral counterpart of the reference's pkg/scheduling/requirement.go
(Requirement: complement representation, Gt/Lt bounds, minValues,
Intersection/HasIntersection/Has). This representation is also what the
TPU solver encodes into dense masks (see karpenter_tpu_torch.solver.encode):
a Requirement over a finite vocabulary is exactly a boolean row.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

from karpenter_tpu_torch.apis.v1.labels import NORMALIZED_LABELS

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_MAXLEN = 2**63 - 1


class Requirement:
    """One label-key constraint.

    Internally either an allowlist (complement=False: value must be in
    `values`) or a denylist (complement=True: value must not be in
    `values`), with optional integer bounds greater_than/less_than and
    an optional minValues flexibility floor.
    """

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        operator: str,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ):
        self.key = NORMALIZED_LABELS.get(key, key)
        self.min_values = min_values
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator == IN:
            self.complement = False
            self.values = frozenset(values)
        elif operator == NOT_IN:
            self.complement = True
            self.values = frozenset(values)
        elif operator == EXISTS:
            self.complement = True
            self.values = frozenset()
        elif operator == DOES_NOT_EXIST:
            self.complement = False
            self.values = frozenset()
        elif operator == GT:
            self.complement = True
            self.values = frozenset()
            self.greater_than = int(values[0])
        elif operator == LT:
            self.complement = True
            self.values = frozenset()
            self.less_than = int(values[0])
        else:
            raise ValueError(f"unknown operator {operator!r}")

    # -- construction helpers -------------------------------------------------

    @classmethod
    def _raw(
        cls,
        key: str,
        complement: bool,
        values: frozenset[str],
        greater_than: Optional[int],
        less_than: Optional[int],
        min_values: Optional[int],
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        r.min_values = min_values
        return r

    # -- predicates -----------------------------------------------------------

    def operator(self) -> str:
        if self.complement:
            return NOT_IN if self.values else EXISTS
        return IN if self.values else DOES_NOT_EXIST

    def __len__(self) -> int:
        if self.complement:
            return _MAXLEN - len(self.values)
        return len(self.values)

    def has(self, value: str) -> bool:
        """True if the requirement allows `value`."""
        in_set = value in self.values
        ok = not in_set if self.complement else in_set
        return ok and _within(value, self.greater_than, self.less_than)

    def value_list(self) -> list[str]:
        return sorted(self.values)

    def spec_entries(self) -> list[tuple[str, tuple[str, ...], Optional[int]]]:
        """Serialize to (operator, values, minValues) claim-spec
        entries whose conjunction denotes exactly this requirement.
        Gt/Lt bounds live outside the value set (complement
        representation), so they emit as their own entries — a
        flattening to operator()/value_list() alone would collapse a
        bare bound into Exists and lose it (the claim-tightening path
        in nodeclaim.go keeps Gt/Lt as separate NodeSelectorRequirement
        entries for the same reason)."""
        entries: list[tuple[str, tuple[str, ...], Optional[int]]] = []
        if self.greater_than is not None:
            entries.append((GT, (str(self.greater_than),), None))
        if self.less_than is not None:
            entries.append((LT, (str(self.less_than),), None))
        op = self.operator()
        if entries and op == EXISTS and not self.values:
            # the bounds already imply existence; a minValues floor
            # must still ride one of the surviving entries
            if self.min_values is not None:
                last_op, last_values, _ = entries[-1]
                entries[-1] = (last_op, last_values, self.min_values)
            return entries
        entries.append((op, tuple(self.value_list()), self.min_values))
        return entries

    def any_value(self) -> str:
        """A representative allowed value (used to label nodes)."""
        if self.operator() == IN:
            return min(self.values)
        if self.operator() in (NOT_IN, EXISTS):
            lo = (self.greater_than + 1) if self.greater_than is not None else 0
            hi = self.less_than if self.less_than is not None else 2**31
            for _ in range(16):
                candidate = str(random.randrange(lo, hi))
                if candidate not in self.values:
                    return candidate
        return ""

    # -- set algebra ----------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """The requirement allowing exactly values allowed by both."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement:
            values = other.values - self.values
        elif other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = frozenset(v for v in values if _within(v, greater_than, less_than))
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than, min_values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Allocation-free check that `intersection` would be non-empty."""
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return False
        if self.complement and other.complement:
            return True
        if self.complement:
            return any(
                v not in self.values and _within(v, greater_than, less_than)
                for v in other.values
            )
        if other.complement:
            return any(
                v not in other.values and _within(v, greater_than, less_than)
                for v in self.values
            )
        return any(
            v in other.values and _within(v, greater_than, less_than) for v in self.values
        )

    # -- misc -----------------------------------------------------------------

    def copy(self) -> "Requirement":
        return Requirement._raw(
            self.key, self.complement, self.values, self.greater_than, self.less_than, self.min_values
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Requirement):
            return NotImplemented
        return (
            self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
        )

    def __hash__(self) -> int:
        return hash((self.key, self.complement, self.values, self.greater_than, self.less_than))

    def signature(self) -> tuple:
        """Lossless, hashable identity — unlike __repr__, which
        truncates long value lists for display and must never be used
        as a grouping key."""
        # None -> -1 so signatures stay totally ordered (sort keys);
        # legal Gt/Lt/minValues operands are non-negative
        return (
            self.key,
            self.complement,
            tuple(sorted(self.values)),
            -1 if self.greater_than is None else self.greater_than,
            -1 if self.less_than is None else self.less_than,
            -1 if self.min_values is None else self.min_values,
        )

    def __repr__(self) -> str:
        op = self.operator()
        if op in (EXISTS, DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            vals = self.value_list()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(vals) - 5} others"]
            s = f"{self.key} {op} {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    if greater_than is None and less_than is None:
        return True
    try:
        num = int(value)
    except ValueError:
        return False
    if greater_than is not None and greater_than >= num:
        return False
    if less_than is not None and less_than <= num:
        return False
    return True


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)
