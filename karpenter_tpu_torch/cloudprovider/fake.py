"""Fake cloud provider + synthetic instance-type generators.

Copy of `karpenter_tpu/cloudprovider/fake.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/cloudprovider/fake (cloudprovider.go, instancetype.go):
an in-memory provider with configurable instance types and error
injection, plus the `instance_types(n)` diverse-catalog generator and a
kwok-style catalog (144 types across 3 zones, spot + on-demand priced)
used by the benchmark harness.
"""

from __future__ import annotations

import itertools
import logging
import threading
import zlib
from typing import Callable, Optional

from karpenter_tpu_torch.apis.v1.labels import (
    ARCH_AMD64,
    ARCH_ARM64,
    ARCH_LABEL,
    CAPACITY_TYPE_LABEL,
    CAPACITY_TYPE_ON_DEMAND,
    CAPACITY_TYPE_RESERVED,
    CAPACITY_TYPE_SPOT,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    OS_LABEL,
    RESERVATION_ID_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_LAUNCHED,
    NodeClaim,
    NodeClaimStatus,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InstanceTypeOverhead,
    NodeClaimNotFoundError,
    Offering,
    Offerings,
    RepairPolicy,
)
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.utils.resources import CPU, MEMORY, PODS, ResourceList

# Extra well-known-ish labels used by the fake catalog (instancetype.go:33-38)
LABEL_INSTANCE_SIZE = "size"
LABEL_EXOTIC = "special"
LABEL_INTEGER = "integer"

GIB = 2**30
DEFAULT_ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def price_from_resources(resources: ResourceList) -> float:
    """Deterministic synthetic price (fake PriceFromResources)."""
    return resources.get(CPU, 0.0) * 0.025 + resources.get(MEMORY, 0.0) / GIB * 0.001


# base spot discount vs on-demand (kwok's spot pricing ratio)
SPOT_DISCOUNT = 0.4


def spot_price_at(on_demand_price: float, zone: str, now: float) -> float:
    """Deterministic time-varying spot price: the on-demand price at
    the base SPOT_DISCOUNT, wobbled per (zone, hour) by up to ±12.5% —
    a seeded stand-in for real spot market drift. Pure function of its
    inputs, so two runs over the same simulated hours see identical
    curves (replay-identical bench arms)."""
    hour = int(now // 3600.0)
    wobble = (
        (zlib.crc32(f"{zone}:{hour}".encode()) % 1001) / 1000.0 - 0.5
    ) * 0.25
    return round(on_demand_price * SPOT_DISCOUNT * (1.0 + wobble), 6)


def reprice_spot(types: list[InstanceType], now: float) -> int:
    """Re-point every spot offering's price at the deterministic
    curve for `now` (each zone's on-demand sibling is the reference
    price). In-place: the encoder cache's catalog fingerprint covers
    offering prices, so a reprice busts it exactly like an overlay
    price change would. Returns the number of offerings updated."""
    updated = 0
    for it in types:
        od_by_zone = {
            o.zone: o.price
            for o in it.offerings
            if o.capacity_type == CAPACITY_TYPE_ON_DEMAND
        }
        for o in it.offerings:
            if o.capacity_type != CAPACITY_TYPE_SPOT:
                continue
            base = od_by_zone.get(o.zone)
            if base is None:
                continue
            price = spot_price_at(base, o.zone, now)
            if price != o.price:
                o.price = price
                updated += 1
    return updated


def make_instance_type(
    name: str,
    cpu: float = 4,
    memory: float = 4 * GIB,
    pods: float = 110,
    arch: str = ARCH_AMD64,
    os: str = "linux",
    zones: tuple[str, ...] = DEFAULT_ZONES,
    capacity_types: tuple[str, ...] = (CAPACITY_TYPE_SPOT, CAPACITY_TYPE_ON_DEMAND),
    price: Optional[float] = None,
    extra_resources: Optional[ResourceList] = None,
    extra_labels: Optional[dict[str, str]] = None,
    offerings: Optional[Offerings] = None,
    reservations: Optional[list[tuple[str, str, int]]] = None,
) -> InstanceType:
    """`reservations`: list of (reservation_id, zone, instance_count) —
    each becomes a reserved-capacity offering priced at ~0 (already
    paid for), bounded by its instance count."""
    capacity: ResourceList = {CPU: cpu, MEMORY: memory, PODS: pods}
    if extra_resources:
        capacity.update(extra_resources)
    base_price = price if price is not None else price_from_resources(capacity)
    if offerings is None:
        offerings = Offerings()
        for ct in capacity_types:
            for zone in zones:
                # spot trades at a discount; mild per-zone variation
                # (stable hash: Python's hash() is salted per process)
                mult = 0.4 if ct == CAPACITY_TYPE_SPOT else 1.0
                zone_mult = 1.0 + 0.01 * (zlib.crc32(zone.encode()) % 7)
                offerings.append(
                    Offering(
                        requirements=Requirements.from_labels(
                            {CAPACITY_TYPE_LABEL: ct, TOPOLOGY_ZONE_LABEL: zone}
                        ),
                        price=round(base_price * mult * zone_mult, 6),
                        available=True,
                    )
                )
        for rid, zone, count in reservations or ():
            offerings.append(
                Offering(
                    requirements=Requirements.from_labels(
                        {
                            CAPACITY_TYPE_LABEL: CAPACITY_TYPE_RESERVED,
                            TOPOLOGY_ZONE_LABEL: zone,
                            RESERVATION_ID_LABEL: rid,
                        }
                    ),
                    # reserved capacity is prepaid: marginal launch
                    # price is ~nothing (cloudprovider/types.go
                    # AdjustedPrice treats reserved as ~free)
                    price=base_price * 1e-4,
                    available=True,
                    reservation_capacity=count,
                )
            )
    reqs = Requirements(
        [
            Requirement(INSTANCE_TYPE_LABEL, IN, [name]),
            Requirement(ARCH_LABEL, IN, [arch]),
            Requirement(OS_LABEL, IN, [os]),
            Requirement(
                TOPOLOGY_ZONE_LABEL, IN, sorted({o.zone for o in offerings if o.available})
            ),
            Requirement(
                CAPACITY_TYPE_LABEL,
                IN,
                sorted({o.capacity_type for o in offerings if o.available}),
            ),
            Requirement(LABEL_INSTANCE_SIZE, IN, [_size_name(cpu)]),
        ]
    )
    for key, value in (extra_labels or {}).items():
        reqs.add(Requirement(key, IN, [value]))
    overhead = InstanceTypeOverhead(
        kube_reserved={CPU: 0.1, MEMORY: 0.1 * GIB},
    )
    return InstanceType(
        name=name, requirements=reqs, offerings=offerings, capacity=capacity, overhead=overhead
    )


def _size_name(cpu: float) -> str:
    if cpu <= 2:
        return "small"
    if cpu <= 8:
        return "medium"
    if cpu <= 32:
        return "large"
    return "xlarge"


def instance_types(count: int) -> list[InstanceType]:
    """Diverse synthetic catalog (fake InstanceTypes(n)): cycles cpu,
    memory ratio, arch and os options deterministically."""
    cpus = [1, 2, 4, 8, 16, 32, 48, 64, 96]
    mem_ratios = [2, 4, 8]  # GiB per vCPU
    archs = [ARCH_AMD64, ARCH_ARM64]
    oses = ["linux", "windows"]
    out = []
    combos = itertools.cycle(itertools.product(cpus, mem_ratios, archs, oses))
    for i in range(count):
        cpu, ratio, arch, os = next(combos)
        name = f"{_size_name(cpu)}-{cpu}-{ratio}x-{arch}-{os}-{i}"
        out.append(
            make_instance_type(
                name,
                cpu=float(cpu),
                memory=float(cpu * ratio * GIB),
                pods=float(min(110, cpu * 16)),
                arch=arch,
                os=os,
            )
        )
    return out


def heterogeneous_instance_types(count: int) -> list[InstanceType]:
    """Family-priced catalog: $/vCPU depends on the memory ratio the
    way real cloud families do (compute-optimized cheapest per vCPU,
    memory-optimized cheapest per GiB), plus a premium on the largest
    sizes. Unlike `instance_types` (whose price is LINEAR in resources
    — the reference's fake PriceFromResources — making greedy FFD
    near-optimal by construction), this curve gives bin-packing choices
    real dollar consequences: matching cpu-heavy and memory-heavy pods
    to the right family, or sharing a node between complementary
    shapes, measurably beats first-fit."""
    family_rate = {2: 0.031, 4: 0.040, 8: 0.055}  # $/vCPU by GiB-per-vCPU
    cpus = [1, 2, 4, 8, 16, 32, 48, 64, 96]
    out = []
    combos = itertools.cycle(
        itertools.product(cpus, (2, 4, 8), (ARCH_AMD64, ARCH_ARM64))
    )
    for i in range(count):
        cpu, ratio, arch = next(combos)
        price = cpu * family_rate[ratio] * (1.08 if cpu >= 48 else 1.0)
        out.append(
            make_instance_type(
                f"f{ratio}x-{_size_name(cpu)}-{cpu}-{arch}-{i}",
                cpu=float(cpu),
                memory=float(cpu * ratio * GIB),
                pods=float(min(110, cpu * 16)),
                arch=arch,
                price=price,
            )
        )
    return out


def kwok_instance_types() -> list[InstanceType]:
    """144-type kwok-style catalog: cpu x memory-ratio grid, amd64+arm64,
    3 zones, spot + on-demand (kwok/cloudprovider/instance_types.json)."""
    out = []
    for cpu in (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256):
        for ratio in (2, 4, 8):
            for arch in (ARCH_AMD64, ARCH_ARM64):
                name = f"c-{cpu}x-{ratio}r-{arch}"
                out.append(
                    make_instance_type(
                        name,
                        cpu=float(cpu),
                        memory=float(cpu * ratio * GIB),
                        pods=float(min(110, max(8, cpu * 8))),
                        arch=arch,
                        os="linux",
                    )
                )
    return out


class FakeCloudProvider(CloudProvider):
    """In-memory provider with error injection (fake/cloudprovider.go)."""

    def __init__(self, types: Optional[list[InstanceType]] = None):
        self._lock = threading.RLock()
        self.types: list[InstanceType] = types if types is not None else instance_types(24)
        self.created: dict[str, NodeClaim] = {}  # provider_id -> claim copy
        self.create_calls: list[NodeClaim] = []
        self.delete_calls: list[NodeClaim] = []
        self.allowed_create_calls: int = 2**31
        self.next_create_error: Optional[Exception] = None
        self.instance_types_hook: Optional[
            Callable[[Optional[NodePool]], list[InstanceType]]
        ] = None
        self.drifted: str = ""
        self._repair_policies: list[RepairPolicy] = []
        self._counter = itertools.count(1)
        # provider ids of spot instances holding an interruption notice
        self.interrupted: set[str] = set()

    # -- SPI ------------------------------------------------------------------

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        with self._lock:
            self.create_calls.append(node_claim)
            if self.next_create_error is not None:
                err, self.next_create_error = self.next_create_error, None
                raise err
            if len(self.create_calls) > self.allowed_create_calls:
                raise Exception("create call limit exceeded")
            reqs = Requirements(
                Requirement(r.key, r.operator, r.values, r.min_values)
                for r in node_claim.spec.requirements
            )
            chosen = self._pick_instance_type(reqs, node_claim)
            offering = chosen.offerings.available().compatible(reqs).cheapest()
            provider_id = f"fake://{chosen.name}/{next(self._counter)}"
            labels = {
                INSTANCE_TYPE_LABEL: chosen.name,
                CAPACITY_TYPE_LABEL: offering.capacity_type,
                TOPOLOGY_ZONE_LABEL: offering.zone,
                ARCH_LABEL: chosen.requirements.get(ARCH_LABEL).any_value(),
                OS_LABEL: chosen.requirements.get(OS_LABEL).any_value(),
            }
            if offering.reservation_id:
                labels[RESERVATION_ID_LABEL] = offering.reservation_id
            if node_claim.metadata.labels.get(NODEPOOL_LABEL):
                labels[NODEPOOL_LABEL] = node_claim.metadata.labels[NODEPOOL_LABEL]
            out = NodeClaim(
                metadata=node_claim.metadata,
                spec=node_claim.spec,
                status=NodeClaimStatus(
                    provider_id=provider_id,
                    image_id="fake-image",
                    capacity=dict(chosen.capacity),
                    allocatable=dict(chosen.allocatable),
                ),
            )
            out.metadata.labels = {**node_claim.metadata.labels, **labels}
            out.status_conditions.set_true(COND_LAUNCHED)
            self.created[provider_id] = out
            return out

    def _pick_instance_type(self, reqs: Requirements, claim: NodeClaim) -> InstanceType:
        from karpenter_tpu_torch.cloudprovider.types import named_by, order_by_price
        from karpenter_tpu_torch.utils.resources import fits_declared

        compatible = [
            it
            for it in named_by(self.types, reqs)
            if it.requirements.intersects(reqs) is None
            and it.offerings.available().has_compatible(reqs)
            and fits_declared(claim.spec.resources, it.allocatable)
        ]
        if not compatible:
            raise Exception(f"no compatible instance type for {claim.metadata.name}")
        return order_by_price(compatible, reqs)[0]

    def delete(self, node_claim: NodeClaim) -> None:
        with self._lock:
            self.delete_calls.append(node_claim)
            if node_claim.status.provider_id not in self.created:
                raise NodeClaimNotFoundError(node_claim.status.provider_id)
            del self.created[node_claim.status.provider_id]
            self.interrupted.discard(node_claim.status.provider_id)

    def reprice(self, now: float) -> int:
        """Advance spot offering prices to the deterministic curve for
        `now` (see spot_price_at). Returns offerings changed — 0 within
        one price hour, so the encoder cache's catalog fingerprint only
        busts when the curve actually moved."""
        with self._lock:
            return reprice_spot(self.types, now)

    def poll_interruptions(self, now: Optional[float] = None) -> list[str]:
        """One `cloud_interrupt` fault check per live spot instance, in
        sorted provider-id order (occurrence numbers map to instances
        deterministically). A firing `spot_interruption` rule is
        CONSUMED here: the instance gets an interruption notice —
        exactly a cloud's rebalance/termination warning — surfaced
        through `self.interrupted` for the interruption controller's
        normal poll. Returns the newly noticed provider ids."""
        from karpenter_tpu_torch.metrics.store import SPOT_INTERRUPTIONS
        from karpenter_tpu_torch.solver import faults as _faults

        newly: list[str] = []
        with self._lock:
            for pid in sorted(self.created):
                if pid in self.interrupted:
                    continue
                claim = self.created[pid]
                if (
                    claim.metadata.labels.get(CAPACITY_TYPE_LABEL)
                    != CAPACITY_TYPE_SPOT
                ):
                    continue
                try:
                    _faults.fire("cloud_interrupt")
                except _faults.SpotInterruptionError:
                    self.interrupted.add(pid)
                    newly.append(pid)
                    SPOT_INTERRUPTIONS.inc({"provider": "fake"})
                except _faults.FaultError as err:
                    # a mis-kinded spec (e.g. device_lost@cloud_interrupt)
                    # is consumed, not propagated: a chaos knob must
                    # never take the operator tick down
                    logging.getLogger(__name__).warning(
                        "ignoring non-interruption fault at "
                        "cloud_interrupt: %r", err,
                    )
        return newly

    def get(self, provider_id: str) -> NodeClaim:
        with self._lock:
            claim = self.created.get(provider_id)
            if claim is None:
                raise NodeClaimNotFoundError(provider_id)
            return claim

    def list(self) -> list[NodeClaim]:
        with self._lock:
            return list(self.created.values())

    def get_instance_types(self, node_pool: Optional[NodePool]) -> list[InstanceType]:
        if self.instance_types_hook is not None:
            return self.instance_types_hook(node_pool)
        return list(self.types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def repair_policies(self) -> list[RepairPolicy]:
        return list(self._repair_policies)

    def name(self) -> str:
        return "fake"

    def get_supported_node_classes(self) -> list[str]:
        return ["TestNodeClass"]

    def reset(self) -> None:
        with self._lock:
            self.created.clear()
            self.create_calls.clear()
            self.delete_calls.clear()
            self.next_create_error = None
            self.allowed_create_calls = 2**31
