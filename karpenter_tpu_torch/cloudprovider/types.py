"""CloudProvider SPI and the InstanceType/Offering model.

Copy of `karpenter_tpu/cloudprovider/types.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/cloudprovider/types.go: the 9-method provider
interface (types.go:72-100), InstanceType with memoized Allocatable
(types.go:181-219), Offerings keyed by (capacity-type, zone
[, reservation-id]) with price/availability (types.go:355-417), list
operations (order-by-price, compatible, minValues satisfaction,
truncation), and the typed error taxonomy (types.go:477-586).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from functools import cached_property
from typing import Iterable, Optional, Sequence, TYPE_CHECKING

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    CAPACITY_TYPE_RESERVED,
    CAPACITY_TYPE_SPOT,
    INSTANCE_TYPE_LABEL,
    RESERVATION_ID_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.scheduling.requirement import DOES_NOT_EXIST, NOT_IN
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.resources import ResourceList

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.apis.v1.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool
    from karpenter_tpu_torch.kube.objects import Node


@dataclass
class Offering:
    """One purchasable variant of an instance type.

    Uniquely identified by capacity type + zone (+ reservation id for
    reserved capacity). `reservation_capacity` bounds concurrent use of
    a capacity reservation.
    """

    requirements: Requirements
    price: float
    available: bool = True
    reservation_capacity: int = 0

    @property
    def capacity_type(self) -> str:
        return self.requirements.get(CAPACITY_TYPE_LABEL).any_value()

    @property
    def zone(self) -> str:
        return self.requirements.get(TOPOLOGY_ZONE_LABEL).any_value()

    @property
    def reservation_id(self) -> str:
        if not self.requirements.has(RESERVATION_ID_LABEL):
            return ""
        return self.requirements.get(RESERVATION_ID_LABEL).any_value()

    def is_reserved(self) -> bool:
        return self.capacity_type == CAPACITY_TYPE_RESERVED

    def is_spot(self) -> bool:
        return self.capacity_type == CAPACITY_TYPE_SPOT


# -- interruption-adjusted pricing -------------------------------------------
#
# Spot capacity trades at a discount because it can be reclaimed; a
# decision layer that compares raw prices keeps churning workloads onto
# capacity about to be interrupted. KARPENTER_SPOT_PENALTY expresses
# the expected interruption cost as a price multiplier: the solver's
# encoded price matrices and consolidation's cheaper-than filter price
# spot offerings at price x (1 + penalty), while the raw price stays
# what the fleet actually pays (bench/validation economics).

SPOT_PENALTY_ENV = "KARPENTER_SPOT_PENALTY"

# parse memo keyed on the raw env value: effective_price sits in the
# encode hot loop (once per spot launch config), and re-floating the
# same string thousands of times per solve is pure waste
_penalty_memo: tuple[str, float] = ("", 0.0)


def interruption_penalty() -> float:
    """The configured spot interruption penalty (>= 0; 0 = raw
    prices). Read per call so chaos suites and the bench can flip it
    without rebuilding catalogs; the encoder cache folds the value
    into its catalog fingerprint."""
    global _penalty_memo
    raw = os.environ.get(SPOT_PENALTY_ENV, "")
    if raw == _penalty_memo[0]:
        return _penalty_memo[1]
    try:
        value = max(0.0, float(raw))
    except ValueError:
        value = 0.0
    _penalty_memo = (raw, value)
    return value


def effective_price(offering: "Offering") -> float:
    """The decision-layer price of an offering: raw for on-demand and
    reserved capacity, interruption-penalized for spot."""
    if offering.is_spot():
        return offering.price * (1.0 + interruption_penalty())
    return offering.price


class Offerings(list):
    """Decorated list of Offering (types.go:419-474)."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(
            o for o in self if reqs.intersects(o.requirements) is None
        )

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(reqs.intersects(o.requirements) is None for o in self)

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price, default=None)

    def most_expensive(self) -> Optional[Offering]:
        return max(self, key=lambda o: o.price, default=None)

    def worst_launch_price(self, reqs: Requirements) -> float:
        """Highest price a launch could resolve to given requirements
        (types.go:459-474): max over compatible available offerings."""
        compatible = self.available().compatible(reqs)
        worst = compatible.most_expensive()
        return worst.price if worst else math.inf


@dataclass
class InstanceTypeOverhead:
    kube_reserved: ResourceList = field(default_factory=dict)
    system_reserved: ResourceList = field(default_factory=dict)
    eviction_threshold: ResourceList = field(default_factory=dict)

    def total(self) -> ResourceList:
        return resutil.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    offerings: Offerings
    capacity: ResourceList
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)

    @cached_property
    def allocatable(self) -> ResourceList:
        """capacity - overhead, clamped at zero (types.go:181-219)."""
        return resutil.positive(resutil.subtract(self.capacity, self.overhead.total()))

    def __repr__(self) -> str:
        return f"InstanceType({self.name})"


def order_by_price(types: Sequence[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """Sort by cheapest compatible available offering (types.go:221-241)."""

    def price(it: InstanceType) -> float:
        cheapest = it.offerings.available().compatible(reqs).cheapest()
        return cheapest.price if cheapest else math.inf

    return sorted(types, key=lambda it: (price(it), it.name))


def named_by(types: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """`types` less those that `reqs`' instance-type requirement rules
    out: the one-key part of `Requirements.intersects` (the same test,
    the same forgiveness of two NotIn/DoesNotExist sides), run ahead of
    the whole test, so that a claim naming a few types of a large
    catalog skips the rest cheaply. Every type it drops fails
    `intersects` too: a provider's choice is unchanged."""
    if not reqs.has(INSTANCE_TYPE_LABEL):
        return list(types)
    inc = reqs.get(INSTANCE_TYPE_LABEL)
    forgiving = inc.operator() in (NOT_IN, DOES_NOT_EXIST)
    out = []
    for it in types:
        own = it.requirements.get(INSTANCE_TYPE_LABEL)
        if (not it.requirements.has(INSTANCE_TYPE_LABEL) or own.has_intersection(inc)
                or (forgiving and own.operator() in (NOT_IN, DOES_NOT_EXIST))):
            out.append(it)
    return out


def compatible(types: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    return [it for it in types if it.requirements.intersects(reqs) is None]


def min_values_coverage(
    types: Sequence[InstanceType], reqs: Requirements
) -> dict[str, int]:
    """Per floored key, the count of distinct allowed values covered
    across the instance types — the quantity SatisfiesMinValues
    compares floors against (types.go:284-318), and the count a
    BestEffort relaxation lowers an unsatisfiable floor to
    (nodeclaim.go:147-150)."""
    out: dict[str, int] = {}
    for req in reqs:
        if req.min_values is None:
            continue
        values: set[str] = set()
        for it in types:
            it_req = it.requirements.get(req.key)
            if it_req.operator() == "In":
                values.update(v for v in it_req.value_list() if req.has(v))
        out[req.key] = len(values)
    return out


def satisfies_min_values(
    types: Sequence[InstanceType], reqs: Requirements
) -> tuple[int, Optional[str]]:
    """Check minValues flexibility floors against an instance-type set.

    Returns (max satisfiable minValues count, error string or None) —
    mirrors InstanceTypes.SatisfiesMinValues (types.go:284-318): for
    each requirement with minValues, count distinct values covered
    across the instance types.
    """
    if not reqs.has_min_values():
        return (len(types), None)
    incompatible_key = ""
    max_satisfiable = len(types)
    coverage = min_values_coverage(types, reqs)
    for req in reqs:
        if req.min_values is None:
            continue
        covered = coverage.get(req.key, 0)
        if covered < req.min_values:
            incompatible_key = req.key
            max_satisfiable = min(max_satisfiable, covered)
    if incompatible_key:
        return (
            max_satisfiable,
            f"minValues requirement is not met for label {incompatible_key}",
        )
    return (len(types), None)


def truncate(
    types: Sequence[InstanceType], reqs: Requirements, max_items: int
) -> list[InstanceType]:
    """Truncate a price-ordered list to max_items, keeping minValues
    satisfiable (types.go:322-352)."""
    if len(types) <= max_items:
        return list(types)
    truncated = list(types[:max_items])
    if reqs.has_min_values():
        _, err = satisfies_min_values(truncated, reqs)
        if err is not None:
            raise ValueError(f"truncating instance types breaks minValues: {err}")
    return truncated


# ---------------------------------------------------------------- errors


class CloudProviderError(Exception):
    """Base for typed SPI errors."""


class NodeClaimNotFoundError(CloudProviderError):
    pass


class InsufficientCapacityError(CloudProviderError):
    """ICE — the offering cannot be fulfilled right now."""


class NodeClassNotReadyError(CloudProviderError):
    pass


class CreateError(CloudProviderError):
    def __init__(self, message: str, reason: str = "LaunchFailed"):
        super().__init__(message)
        self.reason = reason


@dataclass
class RepairPolicy:
    """Unhealthy-node condition the provider wants remediated
    (types.go RepairPolicy)."""

    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


class CloudProvider:
    """The 9-method SPI (types.go:72-100). Providers subclass this."""

    def create(self, node_claim: "NodeClaim") -> "NodeClaim":
        """Launch capacity for the claim; returns a claim whose status
        (provider_id, capacity, allocatable, labels) is populated."""
        raise NotImplementedError

    def delete(self, node_claim: "NodeClaim") -> None:
        raise NotImplementedError

    def get(self, provider_id: str) -> "NodeClaim":
        raise NotImplementedError

    def list(self) -> list["NodeClaim"]:
        raise NotImplementedError

    def get_instance_types(self, node_pool: "NodePool") -> list[InstanceType]:
        raise NotImplementedError

    def is_drifted(self, node_claim: "NodeClaim") -> str:
        """Non-empty drift reason if the claim no longer matches its
        nodeclass; empty string otherwise."""
        raise NotImplementedError

    def repair_policies(self) -> list[RepairPolicy]:
        return []

    def name(self) -> str:
        raise NotImplementedError

    def get_supported_node_classes(self) -> list[str]:
        return []
