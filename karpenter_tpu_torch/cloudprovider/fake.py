"""Synthetic instance-type catalog.

Copy of the catalog half of `karpenter_tpu/cloudprovider/fake.py`: the
deterministic price model, `make_instance_type`, the diverse
`instance_types(n)` generator the benchmark problem is built on, and
the family-priced `heterogeneous_instance_types(n)` the cost objective
is tested on.
"""

from __future__ import annotations

import itertools
import zlib
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    ARCH_AMD64,
    ARCH_ARM64,
    ARCH_LABEL,
    CAPACITY_TYPE_LABEL,
    CAPACITY_TYPE_ON_DEMAND,
    CAPACITY_TYPE_RESERVED,
    CAPACITY_TYPE_SPOT,
    INSTANCE_TYPE_LABEL,
    OS_LABEL,
    RESERVATION_ID_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.utils.resources import CPU, MEMORY, PODS, ResourceList

LABEL_INSTANCE_SIZE = "size"

GIB = 2**30
DEFAULT_ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def price_from_resources(resources: ResourceList) -> float:
    """Deterministic synthetic price (fake PriceFromResources)."""
    return resources.get(CPU, 0.0) * 0.025 + resources.get(MEMORY, 0.0) / GIB * 0.001


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
                    # price is ~nothing
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
