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

`topology_pods` and `mixed_problem` are copies of the demand of
`bench.py`'s `scenario_topology` (zonal spread, hostname anti-affinity)
and `scenario_mixed` (a tainted pool beside the default one, on the
family-priced catalog).
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
from karpenter_tpu_torch.kube.objects import (
    Affinity,
    Container,
    LabelSelector,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodSpec,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
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


def topology_pods(n_pods: int, n_services: int) -> list[Pod]:
    """`bench.py::_topology_pods`: 1-cpu pods of `n_services` apps, each
    spread over zones with max skew 1, every tenth with hostname
    anti-affinity to its own app; owned by a ReplicaSet, as the JAX
    package's `testing.mk_pod` makes them."""
    pods = []
    for i in range(n_pods):
        name, app = f"t-{i}", f"svc-{i % n_services}"
        pod = Pod(
            metadata=ObjectMeta(
                name=name, labels={"app": app},
                owner_references=[OwnerReference(
                    kind="ReplicaSet", name=f"{name}-owner",
                    uid=f"uid-{name}-owner", controller=True)],
            ),
            spec=PodSpec(containers=[
                Container(requests={"cpu": 1.0, "memory": float(GIB)})
            ]),
        )
        pod.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1,
                topology_key=TOPOLOGY_ZONE_LABEL,
                when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector.of({"app": app}),
            )
        ]
        if i % 10 == 0:
            pod.spec.affinity = Affinity(
                pod_anti_affinity=PodAffinity(required=(
                    PodAffinityTerm(
                        topology_key=HOSTNAME_LABEL,
                        label_selector=LabelSelector.of({"app": app}),
                    ),
                ))
            )
        pods.append(pod)
    return pods


def mixed_problem(n_pods: int = 10_000, n_types: int = 400,
                  n_tainted_types: int = 60, seed: int = 42):
    """`bench.py::scenario_mixed`'s demand: `build_problem(n_pods,
    n_types)`'s pods on `heterogeneous_instance_types(n_types)`, beside a
    pool of weight 50 tainted dedicated=batch:NoSchedule over
    `heterogeneous_instance_types(n_tainted_types)`, every fifth pod
    tolerating it. Returns (pods, [(pool, types), (tainted, types)])."""
    from karpenter_tpu_torch.cloudprovider.fake import heterogeneous_instance_types

    pods, pools = build_problem(n_pods, n_types, seed=seed)
    tainted = NodePool(metadata=ObjectMeta(name="tainted"))
    tainted.spec.weight = 50
    tainted.spec.template.spec.taints = [
        Taint(key="dedicated", value="batch", effect="NoSchedule")
    ]
    for i, pod in enumerate(pods):
        if i % 5 == 0:
            pod.spec.tolerations = [
                Toleration(key="dedicated", operator="Equal", value="batch",
                           effect="NoSchedule")
            ]
    return pods, [(pools[0][0], heterogeneous_instance_types(n_types)),
                  (tainted, heterogeneous_instance_types(n_tainted_types))]


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


def build_scaled_demand(total_pods: int = 1_000_000, n_types: int = 100,
                        n_signatures: int = 400, seed: int = 13, types=None):
    """`bench.py`'s million_pod demand (`build_scaled_demand`,
    bench.py:250-330, defaults as bench.py:355-357 reads them): one
    representative pod per scheduling signature (shapes x arch/zone
    selectors), encoded once, with `Encoded.group_count` rescaled to a
    Pareto-weighted distribution summing to `total_pods`. The solve, and
    the node axis it opens, are the million-pod problem's; only a
    per-pod decode is out of scope. `types`: the catalog (default
    `instance_types(n_types)`, the benchmark's). Returns (enc, pools)."""
    from karpenter_tpu_torch.solver.encode import encode, group_pods

    rng = np.random.default_rng(seed)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    types = instance_types(n_types) if types is None else types
    reps = _signature_pods(rng, n_signatures)
    enc = encode(group_pods(reps), [(pool, types)])
    enc.group_count = _pareto_counts(rng, enc.compat.shape[0], total_pods)
    return enc, [(pool, types)]


def _signature_pods(rng, n_signatures: int) -> list:
    """The million_pod recipe's representative pods, one a signature:
    cpu and memory levels, a quarter pinned to an architecture, 30% to a
    zone (bench.py:250-300)."""
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    cpu_levels = [0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0]
    mem_levels = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0]
    reps = []
    for i in range(n_signatures):
        selector = {}
        if rng.random() < 0.25:
            selector["kubernetes.io/arch"] = str(rng.choice(["amd64", "arm64"]))
        if rng.random() < 0.3:
            selector[TOPOLOGY_ZONE_LABEL] = str(rng.choice(zones))
        reps.append(Pod(
            metadata=ObjectMeta(name=f"sig-{i}"),
            spec=PodSpec(
                containers=[Container(requests={
                    "cpu": float(rng.choice(cpu_levels)),
                    "memory": float(rng.choice(mem_levels)) * GIB,
                })],
                node_selector=selector,
            ),
        ))
    return reps


def _pareto_counts(rng, G: int, total_pods: int) -> np.ndarray:
    """Pareto weights over G groups (a heavy head of big deployments over
    a long tail), floored to pod counts and rebalanced to exactly
    `total_pods` without driving a group below 1."""
    if total_pods < G:
        raise ValueError(
            f"total_pods={total_pods} below the {G} encoded signatures "
            "— every group carries at least one pod")
    weights = rng.pareto(1.5, G) + 1.0
    counts = np.maximum(
        1, np.floor(weights / weights.sum() * total_pods)).astype(np.int64)
    excess = int(counts.sum() - total_pods)
    if excess > 0:
        for i in np.argsort(-counts):
            cut = min(excess, int(counts[i]) - 1)
            counts[i] -= cut
            excess -= cut
            if excess == 0:
                break
    else:
        counts[np.argmax(counts)] += -excess
    assert counts.sum() == total_pods
    assert counts.min() >= 1 and counts.max() < 2**31
    return counts.astype(np.int32)


# aws_catalog_50k's catalog: vCPU sizes and GiB-per-vCPU ratios of a
# cloud's general, compute and memory families (1,600 distinct shapes;
# the first 800 in `catalog_types` order span every size)
CATALOG_CPUS = (1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52,
                56, 60, 64, 72, 80, 88, 96, 104, 112, 120, 128, 144, 160, 176, 192, 208,
                224, 256, 288, 320, 384)
CATALOG_RATIOS = tuple(0.5 * (i + 1) for i in range(40))  # 0.5 .. 20 GiB a vCPU


def catalog_types(n_types: int = 800) -> list:
    """A synthetic cloud-sized catalog: `n_types` (at most 1,600)
    linux/amd64 instance types with distinct (cpu, memory) shapes from a
    grid of the 40 vCPU sizes `CATALOG_CPUS` by the 40 GiB-a-vCPU ratios
    `CATALOG_RATIOS`, at the default zones and capacity types, priced by
    `price_from_resources`. It is no published instance list: its size,
    not its shapes, is that of a whole EC2 catalog. Every
    type gives three configs (one a zone: spot and on-demand collapse
    when no pod pins the capacity type), so 800 types give 2,400
    configs. The ratios are taken even-indexed first, so that any prefix
    spreads over the whole range."""
    ratios = CATALOG_RATIOS[0::2] + CATALOG_RATIOS[1::2]
    shapes = [(c, r) for r in ratios for c in CATALOG_CPUS]
    if not 1 <= n_types <= len(shapes):
        raise ValueError(f"catalog_types: {n_types} types; the catalog has {len(shapes)}")
    out = []
    for i, (cpu, ratio) in enumerate(shapes[:n_types]):
        out.append(make_instance_type(
            f"c{cpu}-m{ratio:g}x-{i}", cpu=float(cpu), memory=float(cpu * ratio * GIB),
            pods=float(min(737, max(8, cpu * 8)))))
    return out


def aws_catalog_50k(n_types: int = 800, total_pods: int = 50_000, n_signatures: int = 2_000,
                    seed: int = 13):
    """aws_catalog_50k: `build_scaled_demand`'s recipe (2,000 signatures,
    Pareto counts summing to 50k pods) against `catalog_types(n_types)`,
    as pods a user would submit: each encoded group's representative pod
    repeated its count times (`<rep>-<i>`). The name says the scale it
    stands for (a whole AWS catalog's ~2,400 configs against 50k pods);
    the catalog itself is synthetic. Returns (pods, pools)."""
    from karpenter_tpu_torch.solver.encode import group_pods

    rng = np.random.default_rng(seed)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    groups = group_pods(_signature_pods(rng, n_signatures))
    counts = _pareto_counts(rng, len(groups), total_pods)
    pods = []
    for grp, n in zip(groups, counts):
        rep = grp.pods[0]
        for i in range(int(n)):
            pods.append(Pod(metadata=ObjectMeta(name=f"{rep.metadata.name}-{i}"), spec=rep.spec))
    return pods, [(pool, catalog_types(n_types))]
