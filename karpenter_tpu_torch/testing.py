"""Seeded kernel inputs for holding the CUDA kernels against their
plain versions.

`kernel_cases` builds padded `pack_split` inputs (numpy, as
`solver.pack.stage` produces them) that together cover both modes,
capacity reservations, bound rows with per-group quotas, group caps,
pairwise conflicts, negative and huge demand, and the node-axis cap.
`price_cases` builds inputs of the pricing kernel B4 (exact density
ties, exact fills, demand caps, the planner's padded shapes) and
`ascent_cases` inputs of the dual-ascent kernel B5 (staged from encodes
with and without reservations, on both catalogs).
`existing_from_solution` turns a solution's new nodes into existing
nodes for a follow-up request, which drives the bound block.
`root_node_mips` makes column generation's HiGHS MIPs deterministic
for comparisons between two runs.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.apis.v1.labels import (
    ARCH_LABEL,
    CAPACITY_TYPE_LABEL,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    OS_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.fake import heterogeneous_instance_types
from karpenter_tpu_torch.solver import lp_device, pack
from karpenter_tpu_torch.solver.encode import ExistingNodeInput, encode, group_pods
from karpenter_tpu_torch.utils.resources import merge, pod_requests, subtract
from karpenter_tpu_torch.workloads import build_problem


@dataclass
class KernelCase:
    name: str
    args: tuple          # positional pack_split inputs (numpy)
    kwargs: dict         # optional pack_split inputs (numpy or None)
    max_free: int
    mode: str


def existing_from_solution(solution, prefix: str = "node-",
                           keep: float = 1.0) -> list[ExistingNodeInput]:
    """Each new node of `solution` as an existing node: labelled with
    its primary instance type and offering, its allocatable less what
    the first `keep` share of its pods request (the rest have left)."""
    out = []
    for i, plan in enumerate(solution.new_nodes):
        it, off = plan.primary()
        labels = {
            INSTANCE_TYPE_LABEL: it.name,
            ARCH_LABEL: it.requirements.get(ARCH_LABEL).any_value(),
            OS_LABEL: it.requirements.get(OS_LABEL).any_value(),
            TOPOLOGY_ZONE_LABEL: off.zone,
            CAPACITY_TYPE_LABEL: off.capacity_type,
            NODEPOOL_LABEL: plan.pool.metadata.name,
        }
        stay = plan.pods[: int(round(len(plan.pods) * keep))]
        used = merge(*(pod_requests(p) for p in stay))
        out.append(ExistingNodeInput(
            name=f"{prefix}{i}",
            requirements=Requirements.from_labels(labels),
            taints=(),
            available=subtract(it.allocatable, used),
            pool_name=plan.pool.metadata.name,
            pod_count=len(stay),
        ))
    return out


def _case(name, enc, mode, quota=None, max_nodes=0, existing_mask=None,
          existing_used=None) -> KernelCase:
    C = enc.compat.shape[1]
    if existing_mask is None:
        existing_mask = np.zeros((enc.n_existing, C), bool)
        for ci, cfg in enumerate(enc.configs):
            if cfg.existing_index >= 0:
                existing_mask[cfg.existing_index, ci] = True
        existing_used = enc.existing_used
    n = max_nodes or pack.node_axis(enc, mode)
    staged = pack.stage(enc, existing_mask, existing_used, n, quota)
    return KernelCase(name, staged.args, staged.kwargs, staged.max_free, mode)


def kernel_cases(seed: int = 0, n_pods: int = 3000, n_types: int = 60) -> list[KernelCase]:
    """Seeded problems covering every branch of the packing kernel."""
    rng = np.random.default_rng(seed)
    pods, pools = build_problem(n_pods, n_types, seed=seed)
    enc = encode(group_pods(pods), pools)
    G = enc.compat.shape[0]
    cases = [_case(f"fresh-{m}", enc, m) for m in ("ffd", "cost")]

    rpods, rpools = build_problem(n_pods, n_types, seed=seed + 1, reservations=True)
    renc = encode(group_pods(rpods), rpools)
    cases += [_case(f"reservations-{m}", renc, m) for m in ("ffd", "cost")]

    # bound rows: half the first solve's nodes come back half-emptied
    # as existing nodes for new pods, with quotas, group caps and
    # conflicts
    from karpenter_tpu_torch.solver.solver import _build_solution_arrays

    first = pack.solve_packing(enc, device="cpu")
    sol = _build_solution_arrays(
        enc, np.flatnonzero(first.node_active[: first.node_count]),
        first.node_mask, first.assign, first.unschedulable,
    )
    existing = existing_from_solution(sol, keep=0.5)[: max(8, len(sol.new_nodes) // 2)]
    xpods, _ = build_problem(n_pods // 2, n_types, seed=seed + 2, name_prefix="x-")
    xgroups = group_pods(xpods)
    xG = len(xgroups)
    xenc = encode(xgroups, pools, existing,
                  daemon_overhead={"default": {"cpu": 0.1, "memory": 2.0**27}},
                  group_cap=rng.integers(1, 8, size=xG).astype(np.int32),
                  existing_quota=rng.integers(0, 6, size=(len(existing), xG)).astype(np.int32))
    xconflict = rng.random((xG, xG)) < 0.05
    xenc.conflict = xconflict | xconflict.T
    np.fill_diagonal(xenc.conflict, False)
    cases += [
        _case(f"bound-quota-cap-conflict-{m}", xenc, m, quota=xenc.existing_quota)
        for m in ("ffd", "cost")
    ]

    # pairwise conflicts, with group caps
    cenc = encode(group_pods(pods), pools)
    conflict = rng.random((G, G)) < 0.15
    conflict = conflict | conflict.T
    np.fill_diagonal(conflict, False)
    cenc.conflict = conflict
    cenc.group_cap = rng.integers(2, 12, size=G).astype(np.int32)
    cases += [_case(f"conflict-{m}", cenc, m) for m in ("ffd", "cost")]

    # negative and huge demand, and a node axis too small to hold it
    denc = encode(group_pods(pods), pools)
    counts = denc.group_count.astype(np.int64)
    counts[0] = -7
    counts[1] = 0
    counts[2] = 2**31 - 1 - int(np.clip(counts[3:], 0, None).sum()) - 1
    denc.group_count = counts.astype(np.int32)
    cases += [_case(f"demand-{m}", denc, m, max_nodes=256) for m in ("ffd", "cost")]
    return cases


def price_case(seed: int, G: int, C: int, R: int, ties: bool = False):
    """Inputs of B4 (lam, compat, group_req, eff_alloc, count) as numpy.
    With `ties`: duplicated groups (exact density ties), a config whose
    allocatable a group's request divides exactly (a fill to zero
    residual) and tight demand caps."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 2.0, G).astype(np.float32)
    lam[rng.random(G) < 0.2] = 0.0
    compat = rng.random((G, C)) < 0.6
    req = rng.choice([0.0, 0.25, 0.5, 1.0, 2.0, 4.0], size=(G, R)).astype(np.float32)
    alloc = rng.choice([0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0], size=(C, R)).astype(np.float32)
    count = rng.integers(0, 40, G).astype(np.int32)
    if ties:
        half = G // 2
        lam[half:2 * half] = lam[:half]
        req[half:2 * half] = req[:half]
        compat[half:2 * half] = compat[:half]
        req[0] = np.array([1.0] + [0.5] * (R - 1), np.float32)
        alloc[0] = np.array([8.0] + [4.0] * (R - 1), np.float32)
        compat[0, 0] = True
        lam[0] = 1.5
        count[:4] = np.array([3, 1, 0, 2], np.int32)
    return lam, compat, req, alloc, count


# (seed, G, C, R, ties): the planner's padded shapes (lp_plan._pad_to)
PRICE_CASES = (
    (0, 32, 32, 4, False),
    (1, 32, 40, 4, True),
    (2, 40, 50, 4, True),
    (3, 63, 79, 3, False),
    (4, 194, 243, 4, True),
    (5, 304, 124, 5, False),
)


def price_cases(seed: int = 0) -> list[tuple[str, tuple]]:
    """Seeded B4 inputs, named."""
    return [
        (f"price-G{G}-C{C}-R{R}{'-ties' if ties else ''}",
         price_case(seed + s, G, C, R, ties))
        for s, G, C, R, ties in PRICE_CASES
    ]


def ascent_cases(seed: int = 0) -> list[tuple[str, "lp_device.AscentInputs"]]:
    """Seeded B5 inputs (CPU tensors), staged and padded from encodes
    as `lp_device.solve` stages them."""
    out = []
    for name, n_pods, n_types, rsv, hetero in (
        ("linear", 600, 30, False, False),
        ("reservations", 1200, 60, True, False),
        ("hetero", 800, 40, False, True),
    ):
        pods, pools = build_problem(n_pods, n_types, seed=seed, reservations=rsv)
        if hetero:
            pools = [(pools[0][0], heterogeneous_instance_types(n_types))]
        enc = encode(group_pods(pods), pools)
        out.append((f"ascent-{name}", lp_device.ascent_inputs(lp_device._stage(enc))))
    return out


@contextlib.contextmanager
def root_node_mips():
    """Within the block, every `scipy.optimize.milp` call (the planner's
    integer covering and its knapsack bounds, in this package and in
    any other that imports milp at call time) stops after the root node
    instead of at its wall-clock limit: the incumbent a time limit
    leaves depends on the machine's load, so two runs of the same plan
    can round differently; a node limit is the same work every time."""
    import scipy.optimize as so

    real = so.milp

    def milp(*args, options=None, **kwargs):
        options = dict(options or {})
        if "time_limit" in options:
            options["time_limit"] = 1e4
            options["node_limit"] = 1
        return real(*args, options=options, **kwargs)

    so.milp = milp
    try:
        yield
    finally:
        so.milp = real
