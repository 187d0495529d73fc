"""Requirements: a keyed set of Requirement with intersection algebra.

Copy of `karpenter_tpu/scheduling/requirements.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Behavioral counterpart of pkg/scheduling/requirements.go: Add tightens
by intersection, Compatible enforces the custom-label "must be defined"
rule (well-known labels exempt), Intersects applies the
NotIn/DoesNotExist leniency. Pod conversion mirrors NewPodRequirements
(heaviest preferred term treated as required; first required term
selected — the relaxation ladder peels these off on failure).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from karpenter_tpu_torch.apis.v1.labels import WELL_KNOWN_LABELS, is_restricted_node_label
from karpenter_tpu_torch.kube.objects import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.scheduling.requirement import (
    DOES_NOT_EXIST,
    EXISTS,
    IN,
    NOT_IN,
    Requirement,
)


class IncompatibleError(Exception):
    """Raised/returned when two requirement sets cannot be satisfied."""


class Requirements:
    """Map key -> Requirement with set algebra. Mutable; Add intersects."""

    __slots__ = ("_reqs",)

    def __init__(self, requirements: Iterable[Requirement] = ()):
        self._reqs: dict[str, Requirement] = {}
        self.add(*requirements)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_node_selector_requirements(
        cls, reqs: Iterable[NodeSelectorRequirement]
    ) -> "Requirements":
        return cls(
            Requirement(r.key, r.operator, r.values) for r in reqs
        )

    @classmethod
    def from_labels(cls, labels: dict[str, str]) -> "Requirements":
        return cls(Requirement(k, IN, [v]) for k, v in labels.items())

    @classmethod
    def from_pod(cls, pod: Pod, required_only: bool = False) -> "Requirements":
        """Pod -> requirements (reference newPodRequirements).

        Preferred node-affinity terms: the single heaviest is treated as
        required (the scheduler's relaxation ladder removes it if
        unsatisfiable). Required terms are ORed in k8s; only the first
        is taken, relaxation removes terms one at a time.
        """
        reqs = cls.from_labels(dict(pod.spec.node_selector))
        if pod.spec.injected_requirements:
            # PVC-derived zonal requirements (volumetopology.go:51-160)
            reqs.add(*pod.spec.injected_requirements)
        affinity = pod.spec.affinity
        if affinity is None or affinity.node_affinity is None:
            return reqs
        node_affinity = affinity.node_affinity
        if not required_only and node_affinity.preferred:
            heaviest = max(node_affinity.preferred, key=lambda t: t.weight)
            reqs.add(
                *cls.from_node_selector_requirements(
                    heaviest.preference.match_expressions
                ).values()
            )
        if node_affinity.required:
            reqs.add(
                *cls.from_node_selector_requirements(
                    node_affinity.required[0].match_expressions
                ).values()
            )
        return reqs

    # -- container protocol ---------------------------------------------------

    def add(self, *requirements: Requirement) -> None:
        for req in requirements:
            existing = self._reqs.get(req.key)
            if existing is not None:
                req = req.intersection(existing)
            self._reqs[req.key] = req

    def get(self, key: str) -> Requirement:
        """Undefined keys behave as Exists (allow anything)."""
        req = self._reqs.get(key)
        if req is None:
            return Requirement(key, EXISTS)
        return req

    def has(self, key: str) -> bool:
        return key in self._reqs

    def keys(self) -> set[str]:
        return set(self._reqs)

    def values(self) -> list[Requirement]:
        return list(self._reqs.values())

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._reqs.values())

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, key: str) -> bool:
        return key in self._reqs

    def copy(self) -> "Requirements":
        out = Requirements()
        out._reqs = dict(self._reqs)
        return out

    # -- algebra --------------------------------------------------------------

    def compatible(
        self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()
    ) -> Optional[str]:
        """None if `incoming` can loosely be met, else an error string.

        Custom labels must be *defined* on the receiver to match
        (undefined -> reject unless operator is NotIn/DoesNotExist);
        labels in `allow_undefined` (typically WellKnownLabels) are
        allowed to be undefined.
        """
        for key in incoming.keys():
            if key in allow_undefined:
                continue
            op = incoming.get(key).operator()
            if self.has(key) or op in (NOT_IN, DOES_NOT_EXIST):
                continue
            return f'label "{key}" does not have known values'
        return self.intersects(incoming)

    def is_compatible(
        self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()
    ) -> bool:
        return self.compatible(incoming, allow_undefined) is None

    def intersects(self, incoming: "Requirements") -> Optional[str]:
        """None if all shared keys have overlapping values.

        When both sides are NotIn/DoesNotExist the empty intersection is
        forgiven (reference requirements.go:248-268).
        """
        small, large = (self, incoming) if len(self) <= len(incoming) else (incoming, self)
        for key in small.keys():
            if key not in large:
                continue
            existing = self.get(key)
            inc = incoming.get(key)
            if not existing.has_intersection(inc):
                if inc.operator() in (NOT_IN, DOES_NOT_EXIST) and existing.operator() in (
                    NOT_IN,
                    DOES_NOT_EXIST,
                ):
                    continue
                return f"key {key}, {inc!r} not in {existing!r}"
        return None

    def intersection(self, incoming: "Requirements") -> "Requirements":
        out = self.copy()
        out.add(*incoming.values())
        return out

    # -- projections ----------------------------------------------------------

    def labels(self) -> dict[str, str]:
        """Representative labels for a node satisfying these requirements."""
        out: dict[str, str] = {}
        for key, req in self._reqs.items():
            if is_restricted_node_label(key):
                continue
            value = req.any_value()
            if value:
                out[key] = value
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._reqs.values())

    def __repr__(self) -> str:
        return ", ".join(sorted(repr(r) for r in self._reqs.values()))

    def signature(self) -> tuple:
        """Lossless grouping key (repr truncates long value lists)."""
        return tuple(sorted(r.signature() for r in self._reqs.values()))


ALLOW_UNDEFINED_WELL_KNOWN = WELL_KNOWN_LABELS


def has_preferred_node_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return bool(aff and aff.node_affinity and aff.node_affinity.preferred)
