"""The benchmark problem, built on this package's own types.

`build_problem` is a copy of `bench.py::build_problem`: a diverse pod
mix (balanced, cpu-bound and memory-bound services, a quarter pinned to
an architecture, some to a zone) against the synthetic
`instance_types(n)` catalog, optionally with capacity reservations on
~40 mid-size types. Same seed, same pods, same catalog as the JAX
package's benchmark.

`consolidation_fleet` is a copy of the set-up of `bench.py`'s
`scenario_consolidation` (consolidation_500): the FFD fleet of
`build_problem(21000, 200, seed=9)`, then a scale-down that removes 55%
of the pods, each node kept as an existing node with what stays on it.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    HOSTNAME_LABEL,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.fake import GIB, instance_types, make_instance_type
from karpenter_tpu_torch.kube.objects import Container, ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.solver.encode import ExistingNodeInput
from karpenter_tpu_torch.utils import resources as resutil


def build_problem(n_pods: int, n_types: int, seed: int = 42,
                  reservations: bool = False, zonal_frac: float = 0.15,
                  name_prefix: str = "pod-"):
    """Returns (pods, [(pool, types)]). `name_prefix` names the pods
    (`pod-<i>` as in the benchmark)."""
    rng = np.random.default_rng(seed)
    types = instance_types(n_types)
    if reservations:
        # reservations on mid-size shapes sized like a base-load
        # commitment: ~130% of demand, prepaid across 40 types
        per_type = max(4, int(n_pods * 1.7 * 1.3 / 16 / 40))
        reserved = []
        count = 0
        for it in types:
            cpu = it.capacity.get("cpu", 0)
            if 8 <= cpu <= 32 and count < 40:
                count += 1
                reserved.append(
                    make_instance_type(
                        it.name,
                        cpu=float(cpu),
                        memory=float(it.capacity.get("memory", 0)),
                        pods=float(it.capacity.get("pods", 110)),
                        arch=it.requirements.get("kubernetes.io/arch").any_value(),
                        os=it.requirements.get("kubernetes.io/os").any_value(),
                        reservations=[(f"rsv-{count}", "test-zone-1", per_type)],
                    )
                )
            else:
                reserved.append(it)
        types = reserved
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pods = []
    balanced = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0)]
    cpu_heavy = [(2.0, 0.5), (4.0, 1.0), (8.0, 2.0), (1.0, 0.25)]
    mem_heavy = [(0.25, 4.0), (0.5, 8.0), (1.0, 16.0), (0.5, 4.0), (2.0, 16.0)]
    shapes = balanced + cpu_heavy + mem_heavy
    weights = np.array([0.4 / 5] * 5 + [0.3 / 4] * 4 + [0.3 / 5] * 5)
    arch_options = ["amd64", "arm64"]
    zone_options = ["test-zone-1", "test-zone-2", "test-zone-3"]
    for i in range(n_pods):
        selector = {}
        if rng.random() < 0.25:
            selector["kubernetes.io/arch"] = str(rng.choice(arch_options))
        if rng.random() < zonal_frac:
            selector[TOPOLOGY_ZONE_LABEL] = str(rng.choice(zone_options))
        cpu, mem_gib = shapes[rng.choice(len(shapes), p=weights / weights.sum())]
        pods.append(
            Pod(
                metadata=ObjectMeta(name=f"{name_prefix}{i}"),
                spec=PodSpec(
                    containers=[
                        Container(
                            requests={
                                "cpu": float(cpu),
                                "memory": float(mem_gib * GIB),
                            }
                        )
                    ],
                    node_selector=selector,
                ),
            )
        )
    return pods, [(pool, types)]


def node_input(name, it, offering, pool, kept_pods) -> ExistingNodeInput:
    """A node of instance type `it` on `offering` in `pool`, holding
    `kept_pods`, as an existing node (the labels and the allocatable
    left over, as the benchmark builds them)."""
    used = resutil.requests_for_pods(kept_pods)
    labels = {
        NODEPOOL_LABEL: pool.metadata.name,
        INSTANCE_TYPE_LABEL: it.name,
        TOPOLOGY_ZONE_LABEL: offering.zone,
        CAPACITY_TYPE_LABEL: offering.capacity_type,
        HOSTNAME_LABEL: name,
    }
    avail = {
        k: max(0.0, v - used.get(k, 0.0)) for k, v in it.allocatable.items()
    }
    return ExistingNodeInput(
        name=name,
        requirements=Requirements.from_labels(labels),
        taints=(),
        available=avail,
        pool_name=pool.metadata.name,
        pod_count=len(kept_pods),
    )


def consolidation_fleet(n_pods: int = 21000, n_types: int = 200, seed: int = 9,
                        drop: float = 0.55, rng_seed: int = 7, device=None):
    """The benchmark's consolidation_500 fleet: the FFD solve of
    `build_problem(n_pods, n_types, seed)` on `device` (None: the card),
    then each pod leaves with probability `drop` (drawn from
    `default_rng(rng_seed)`). Returns (pools, nodes, prices, pods_on):
    node i as an `ExistingNodeInput` named `n-<i>`, its price and the
    pods left on it. The defaults are the benchmark's; tests shrink
    them."""
    from karpenter_tpu_torch.solver.solver import solve

    rng = np.random.default_rng(rng_seed)
    pods, pools = build_problem(n_pods, n_types, seed=seed)
    fleet = solve(pods, pools, objective="ffd", device=device)
    keep_mask = rng.random(len(pods)) >= drop
    keep = {p.metadata.name for p, k in zip(pods, keep_mask) if k}
    nodes, prices, pods_on = [], [], []
    for ni, plan in enumerate(fleet.new_nodes):
        kept = [p for p in plan.pods if p.metadata.name in keep]
        nodes.append(node_input(f"n-{ni}", plan.instance_types[0],
                                plan.offerings[0], plan.pool, kept))
        prices.append(plan.price)
        pods_on.append(kept)
    return pools, nodes, prices, pods_on
