"""Seeded kernel inputs for holding the CUDA kernels against their
plain versions.

`kernel_cases` builds padded `pack_split` inputs (numpy, as
`solver.pack.stage` produces them) that together cover both modes,
capacity reservations, bound rows with per-group quotas, group caps,
pairwise conflicts, negative and huge demand, and the node-axis cap.
`dense_cases` lays the same problems, and LP-planned rows with quotas,
out as inputs of the dense kernel B7 (`dense_case`: the bound block as
one-hot `existing_mask` rows), each with its B1 twin for the dense ≡
split oracle (`split_mismatch`).
`price_cases` builds inputs of the pricing kernel B4 (exact density
ties, exact fills, demand caps, the planner's padded shapes),
`ascent_cases` inputs of the dual-ascent kernel B5 (staged from encodes
with and without reservations, on both catalogs) and `ascent_edge_cases`
B5 inputs made directly (a shape over the shared-memory budget, column
maxima at 0 and tied groups, a config axis of 801, sums of at most 32
terms).
`split_case` cuts a kernel case's config axis into S shards' column
blocks (the inputs of the split kernels, B8), and `tie_case` builds
problems whose picks tie across every shard boundary.
`existing_from_solution` turns a solution's new nodes into existing
nodes for a follow-up request, which drives the bound block.
`root_node_mips` makes column generation's HiGHS MIPs deterministic
for comparisons between two runs.

For the consolidation probes: `lane_cases` builds seeded inputs of the
lane kernel B6 (padded lanes, a lane with every bound row dead, a lane
with no demand, reservations and conflicts); `consolidation_ladder` is
`bench.py`'s consolidation_500 convergence loop, arm (a) (one `solve()`
per probe) or arm (c) (every prefix a lane of one
`LaneSolver.solve_lazy`); `summarize` is the order-insensitive identity
of a probe's Solution; `Candidate` stands in for the disruption
engine's candidates where `ProbePruner` reads them.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

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
from karpenter_tpu_torch.workloads import build_problem, node_input


@dataclass
class KernelCase:
    name: str
    args: tuple          # positional pack_split inputs (numpy)
    kwargs: dict         # optional pack_split inputs (numpy or None)
    max_free: int
    mode: str
    staged: Optional[pack.Staged] = None  # what `pack.stage` returned


@dataclass
class DenseCase:
    """Inputs of the dense kernel B7 (`pack_dense.pack`) as numpy."""
    name: str
    args: tuple          # the nine positional inputs
    kwargs: dict         # quota, cfg_rsv, rsv_cap, group_cap, conflict
    max_nodes: int
    mode: str
    Ep: int              # pre-opened rows: the split problem's bound block
    split: KernelCase    # the same problem as B1's inputs


def dense_case(staged: pack.Staged, name: str, mode: str) -> DenseCase:
    """A staged B1 problem as B7's inputs, as the dense ≡ split oracle
    of tests/test_pack_split_equivalence.py builds them: the bound block's
    rows become one-hot `existing_mask` rows (dead rows empty), its
    quotas the first rows of a [N, Gp] int16 quota (32767, no cap,
    elsewhere), and `max_nodes` is the split axis, Ep + max_free."""
    (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
     _, _, bound_used, _, bound_live, cfg_price) = staged.args
    Ep, Cp = staged.Ep, compat.shape[1]
    existing_mask = np.zeros((Ep, Cp), bool)
    rows = np.flatnonzero(bound_live)
    existing_mask[rows, staged.bound_cfg[rows]] = True
    kw = dict(staged.kwargs)
    bound_quota = kw.pop("bound_quota")
    quota = None
    if bound_quota is not None:
        quota = np.full((staged.N, compat.shape[0]), np.int16(32767), np.int16)
        quota[:Ep] = bound_quota
    args = (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
            existing_mask, bound_used, cfg_price)
    split = KernelCase(name, staged.args, staged.kwargs, staged.max_free, mode, staged)
    return DenseCase(name, args, {"quota": quota, **kw}, staged.N, mode, Ep, split)


def split_mismatch(dense, split, existing_mask) -> Optional[str]:
    """The dense ≡ split oracle: B7's outputs `dense` (assign,
    node_mask, node_used, node_active, node_count, unsched) against B1's
    `split` (assign, free_mask, node_count, unsched) on one problem
    (`dense_case`, whose `existing_mask` is passed). Assignments, node
    counts and unschedulable tallies must be equal, the dense mask rows
    past the bound block equal the free rows, and the bound rows stay as
    they entered (one-hot, or empty when dead). Returns the name of the
    first output that differs, else None."""
    assign, node_mask, _, _, node_count, unsched = dense
    s_assign, s_free, s_count, s_unsched = split
    Ep = existing_mask.shape[0]
    for name, a, b in (("assign", assign, s_assign),
                       ("node_count", node_count, s_count),
                       ("unsched", unsched, s_unsched),
                       ("free rows", node_mask[Ep:], s_free),
                       ("bound rows", node_mask[:Ep], existing_mask)):
        if tuple(a.shape) != tuple(b.shape) or not bool((a == b).all()):
            return name
    return None


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
    return KernelCase(name, staged.args, staged.kwargs, staged.max_free, mode, staged)


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


def config_axis(case: KernelCase, C: int) -> KernelCase:
    """`case` with its config axis cut to, or padded to, C columns (the
    padding as staging pads: pseudo-configs of pool -1 that no group is
    compatible with). For holding the kernels at widths the staging
    never gives them: not a multiple of 32, or wider than a shard."""
    args = list(case.args)
    kwargs = dict(case.kwargs)
    Cp = args[0].shape[1]

    def fit(x, axis, fill):
        if C <= Cp:
            return np.ascontiguousarray(np.take(x, np.arange(C), axis=axis))
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, C - Cp)
        return np.pad(x, pad, constant_values=fill)

    args[0] = fit(args[0], 1, False)   # compat
    args[3] = fit(args[3], 0, 0.0)     # cfg_alloc
    args[4] = fit(args[4], 0, -1)      # cfg_pool
    args[11] = fit(args[11], 0, 0.0)   # cfg_price
    if kwargs.get("cfg_rsv") is not None:
        kwargs["cfg_rsv"] = fit(kwargs["cfg_rsv"], 0, -1)
    return KernelCase(f"{case.name}-C{C}", tuple(args), kwargs, case.max_free, case.mode)


def dense_cases(seed: int = 0, n_pods: int = 3000, n_types: int = 60,
                kernel: Optional[list[KernelCase]] = None) -> list[DenseCase]:
    """`kernel_cases` (or the given `kernel`, built with the same
    arguments) as B7's inputs (`dense_case`), plus LP-planned rows:
    pre-opened rows on launchable columns, reserved ones among them, at
    their pool's overhead, with per-group quotas, in both modes."""
    if kernel is None:
        kernel = kernel_cases(seed, n_pods, n_types)
    cases = [dense_case(kc.staged, kc.name, kc.mode) for kc in kernel]
    rng = np.random.default_rng(seed + 3)
    pods, pools = build_problem(n_pods, n_types, seed=seed + 1, reservations=True)
    enc = encode(group_pods(pods), pools)
    G, C = enc.compat.shape
    launchable = np.flatnonzero(enc.cfg_pool >= 0)
    capped = np.flatnonzero(enc.cfg_rsv >= 0)
    cols = rng.choice(launchable, size=12)
    n_capped = min(4, len(capped))
    cols[:n_capped] = rng.choice(capped, size=n_capped, replace=False)
    mask = np.zeros((len(cols), C), bool)
    mask[np.arange(len(cols)), cols] = True
    used = enc.pool_overhead[enc.cfg_pool[cols]].astype(np.float32)
    quota = rng.integers(0, 6, size=(len(cols), G)).astype(np.int32)
    for mode in ("ffd", "cost"):
        n = len(cols) + pack.node_axis(enc, mode)
        staged = pack.stage(enc, mask, used, n, quota)
        cases.append(dense_case(staged, f"planned-quota-{mode}", mode))
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


def ascent_cases(seed: int = 0, shards: int = 0) -> list[tuple[str, "lp_device.AscentInputs"]]:
    """Seeded B5 inputs (CPU tensors), staged and padded from encodes
    as `lp_device.solve` stages them (with `shards`, the config axis
    padded to a multiple of the shard count, as the split ascent
    stages it)."""
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
        out.append((f"ascent-{name}", lp_device.ascent_inputs(lp_device._stage(enc), shards)))
    return out


# (name, G, C, R, K, slotted configs, duplicated groups, zero-ratio
# groups): B5's inputs at shapes and values the staging rarely gives it
ASCENT_EDGE_CASES = (
    # its arrays over the shared-memory budget (the global path)
    ("global", 520, 1800, 6, 64, 40, 0, 0),
    # many columns whose maximum is a masked or a computed 0, and groups
    # tied on every resource
    ("mm-zero-ties", 124, 155, 4, 64, 12, 24, 40),
    # a config axis not a multiple of 32 and past 768
    ("odd-configs", 79, 801, 3, 1, 0, 6, 4),
    # sums of at most 32 terms, the bound at lam0 scalar
    ("small", 20, 24, 2, 3, 6, 4, 2),
)


def ascent_edge_case(seed: int, G: int, C: int, R: int, K: int, n_slotted: int,
                     n_dup: int, n_zero: int) -> "lp_device.AscentInputs":
    """Seeded B5 inputs (CPU tensors) made directly: a few compat column
    patterns (configs share columns), some of them only with groups whose
    ratio is 0 (count 0), `n_dup` groups copied from others (equal ratios:
    tied maxima), `n_slotted` configs in K reservation slots (at most one
    a config), prices with zeros, invalid resources."""
    import torch

    rng = np.random.default_rng(seed)
    lam0 = rng.uniform(0.05, 2.0, G).astype(np.float32)
    count = rng.integers(1, 40, G).astype(np.float32)
    req = (rng.uniform(0.25, 8.0, (G, R)) * (rng.random((G, R)) < 0.9)).astype(np.float32)
    for d in range(n_dup):
        src, dst = rng.choice(G, 2, replace=False)
        lam0[dst], req[dst], count[dst] = lam0[src], req[src], count[src]
    zero = rng.choice(G, n_zero, replace=False) if n_zero else np.zeros(0, np.int64)
    count[zero] = 0.0
    patterns = rng.random((max(3, C // 9), G)) < rng.uniform(0.05, 0.6, (max(3, C // 9), 1))
    if n_zero:
        # columns of zero-ratio groups only (mm a computed 0, tied) and of
        # no group (mm a masked 0)
        patterns[0] = False
        patterns[0, zero] = True
        patterns[1] = False
    compat = patterns[rng.integers(0, len(patterns), C)].T.copy()
    alloc = rng.uniform(1.0, 64.0, (C, R)).astype(np.float32)
    valid = rng.random((C, R)) < 0.92
    price = (rng.uniform(0.05, 3.0, C) * (rng.random(C) < 0.95)).astype(np.float32)
    slot = np.full(C, -1, np.int64)
    if K > 1 or n_slotted:
        chosen = rng.choice(C, min(n_slotted, C), replace=False)
        slot[chosen] = rng.integers(0, min(K, max(1, n_slotted // 2)), len(chosen))
    onehot = np.zeros((K, C), bool)
    for k in range(K):
        onehot[k] = slot == k
    budget = np.where(onehot.any(axis=1), rng.integers(1, 9, K), 0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, G).astype(np.float32)
    t = torch.from_numpy
    return lp_device.AscentInputs(
        lam0=t(lam0), count=t(count), count_w=t((count * w).astype(np.float32)),
        compat=t(compat), req=t(req), alloc=t(alloc), price=t(price), valid=t(valid),
        onehot=t(onehot), budget=t(budget), uncapped=t((slot < 0) & (price > 0)))


def ascent_edge_cases(seed: int = 0) -> list[tuple[str, "lp_device.AscentInputs"]]:
    """`ASCENT_EDGE_CASES` as named B5 inputs."""
    return [(f"ascent-{name}", ascent_edge_case(seed + i, *shape))
            for i, (name, *shape) in enumerate(ASCENT_EDGE_CASES)]


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


@contextlib.contextmanager
def one_core():
    """Within the block, every thread of this process (JAX's compile
    and run pools included), and the torch intra-op pool, use one core
    of those the process may use, picked by process id: heavy CPU
    comparisons then leave the other cores to processes running beside
    them. Linux only; elsewhere the block runs unpinned."""
    import os

    import torch

    threads = torch.get_num_threads()
    allowed = os.sched_getaffinity(0) if hasattr(os, "sched_getaffinity") else set()
    tasks = "/proc/self/task"

    def pin(cpus):
        for tid in os.listdir(tasks):
            try:
                os.sched_setaffinity(int(tid), cpus)
            except OSError:
                pass  # a thread that ended meanwhile

    pinned = len(allowed) > 1 and os.path.isdir(tasks)
    if pinned:
        pin({sorted(allowed)[os.getpid() % len(allowed)]})
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if pinned:
            pin(allowed)


# ---------------------------------------------------------------- probes


@dataclass
class LaneCase:
    """Inputs of B6 (`pack_split.pack_probe_lanes_flat`) as numpy:
    `args` positional (lane_counts [Lp, Gp] and lane_live [Lp, B] in the
    places of group_count and bound_live), `kwargs` cfg_rsv, rsv_cap and
    conflict (or None). `n_lanes` of the Lp lanes are real; the rest are
    padding, with no demand and no live rows."""

    name: str
    args: tuple
    kwargs: dict
    max_free: int
    n_lanes: int


def _lane_case(name, enc, rng, n_lanes: int) -> LaneCase:
    """Lanes over `enc`'s problem staged as `pack.stage` stages it:
    lane 0 has no demand, lane 1 every bound row dead, the others a
    random share of each group's pods and a random subset of the bound
    rows removed; then padding to `pack._lane_bucket`."""
    E = enc.n_existing
    C = enc.compat.shape[1]
    existing_mask = np.zeros((E, C), bool)
    for ci, cfg in enumerate(enc.configs):
        if cfg.existing_index >= 0:
            existing_mask[cfg.existing_index, ci] = True
    staged = pack.stage(enc, existing_mask, enc.existing_used,
                        pack.node_axis(enc, "ffd"))
    args = list(staged.args)
    counts, live = args[2], args[10]
    Lp = pack._lane_bucket(n_lanes)
    lane_counts = np.zeros((Lp, counts.shape[0]), np.int32)
    lane_live = np.zeros((Lp, live.shape[0]), bool)
    for lane in range(n_lanes):
        share = rng.uniform(0.0, 1.0, counts.shape[0])
        lane_counts[lane] = np.floor(counts * share).astype(np.int32)
        lane_live[lane] = live & (rng.random(live.shape[0]) >= 0.3)
    lane_counts[0] = 0
    lane_live[1] = False
    args[2], args[10] = lane_counts, lane_live
    kwargs = {k: staged.kwargs[k] for k in ("cfg_rsv", "rsv_cap", "conflict")}
    return LaneCase(name, tuple(args), kwargs, staged.max_free, n_lanes)


def lane_cases(seed: int = 0, n_pods: int = 3000, n_types: int = 60,
               n_lanes: int = 10) -> list[LaneCase]:
    """Seeded B6 inputs: new pods against the nodes of an earlier solve,
    half emptied (the bound block), without and with reservations and
    pairwise conflicts."""
    from karpenter_tpu_torch.solver.solver import _build_solution_arrays

    rng = np.random.default_rng(seed)
    cases = []
    for name, rsv in (("fleet", False), ("reservations-conflict", True)):
        pods, pools = build_problem(n_pods, n_types, seed=seed, reservations=rsv)
        enc = encode(group_pods(pods), pools)
        first = pack.solve_packing(enc, device="cpu")
        sol = _build_solution_arrays(
            enc, np.flatnonzero(first.node_active[: first.node_count]),
            first.node_mask, first.assign, first.unschedulable,
        )
        existing = existing_from_solution(sol, keep=0.5)
        xpods, _ = build_problem(n_pods // 3, n_types, seed=seed + 1,
                                 reservations=rsv, name_prefix="x-")
        xenc = encode(group_pods(xpods), pools, existing)
        if rsv:
            G = xenc.compat.shape[0]
            conflict = rng.random((G, G)) < 0.1
            conflict = conflict | conflict.T
            np.fill_diagonal(conflict, False)
            xenc.conflict = conflict
        cases.append(_lane_case(name, xenc, rng, n_lanes))
    return cases


def summarize(sol, inputs) -> tuple:
    """Order-insensitive identity of a probe's Solution against the
    existing-node list it indexes (a lane indexes the whole fleet, a
    sequential probe the retained nodes; names align them): per new
    node its pool, price, pods and instance types; per existing node
    its name and pods; the unschedulable pods."""
    plans = sorted(
        (
            plan.pool.metadata.name,
            round(float(plan.price), 6),
            tuple(sorted(p.key for p in plan.pods)),
            tuple(sorted(it.name for it in plan.instance_types)),
        )
        for plan in sol.new_nodes
    )
    existing = sorted(
        (inputs[a.existing_index].name, tuple(sorted(p.key for p in a.pods)))
        for a in sol.existing
        if a.pods
    )
    unsched = tuple(sorted(p.key for p in sol.unschedulable))
    return plans, existing, unsched


@dataclass
class NodeRef:
    name: str


@dataclass
class Candidate:
    """What `ProbePruner.cannot_pay` reads of a disruption candidate."""

    state_node: NodeRef
    price: float
    reschedulable_pods: list = field(default_factory=list)


@dataclass
class Ladder:
    """The outcome of `consolidation_ladder`."""

    decisions: list          # [(n_star, round(saving, 6))] per cycle
    price: float             # the final fleet's $/h
    nodes: int               # the final fleet's node count
    cycles: int
    lanes: int               # lanes shipped (arm (c))
    walls: list              # seconds per cycle
    begins: list             # time.perf_counter() at each cycle's start
    fresh: int               # the fresh-node counter at the end
    probes: dict             # (cycle, n) -> summarize() of each consulted prefix
    # arm (c): the first cycle's LaneSolver ("solver"), lane thunks
    # ("verdicts"), "candidates" and fleet ("nodes", "prices", "pods_on")
    first: Optional[dict] = None


def consolidation_ladder(pools, nodes, prices, pods_on, batched: bool,
                         device=None, cycles: int = 12,
                         fresh: int = 0) -> Ladder:
    """`bench.py`'s consolidation_500 convergence loop on a fleet from
    `workloads.consolidation_fleet`: at most `cycles` cycles of
    emptiness, then a binary search over the prefixes of the (at most
    100) candidates with the fewest pods, each prefix replaced by at
    most one new node and only when strictly cheaper, and the commit of
    the cycle's decision. Arm (a), `batched=False`, solves each probe
    with `solve()`; arm (c), `batched=True`, evaluates every prefix as a
    lane of one `LaneSolver.solve_lazy` a cycle, its shapes pinned to a
    warm staging of the first fleet (the benchmark warms the same
    way). New nodes are named from the counter `fresh` on; the benchmark
    runs arm (c) on from arm (a)'s `Ladder.fresh`. Arm (a) adds up the
    removed prices over the set of a prefix's candidates, arm (c) over
    the prefix in order, as the benchmark's two arms do."""
    from karpenter_tpu_torch.solver.consolidation_batch import LaneSolver, ProbeLane
    from karpenter_tpu_torch.solver.solver import solve

    nodes, prices = list(nodes), list(prices)
    pods_on = [list(ps) for ps in pods_on]
    prefix = "b" if batched else "r"
    out = Ladder(decisions=[], price=0.0, nodes=0, cycles=0, lanes=0,
                 walls=[], begins=[], fresh=fresh, probes={})

    def ladder_lanes(cands):
        return [
            ProbeLane(
                exclude_names=tuple(nodes[i].name for i in cands[:n]),
                pods=[p for i in cands[:n] for p in pods_on[i]],
            )
            for n in range(1, len(cands) + 1)
        ]

    shape_floors = None
    if batched:
        warm_candidates = sorted(
            range(len(nodes)), key=lambda i: (len(pods_on[i]), i))[:100]
        warm_solver = LaneSolver(pools, nodes, device=device)
        warm = warm_solver.solve_lazy(ladder_lanes(warm_candidates))
        for wi in {0, len(warm) // 3, (2 * len(warm)) // 3, len(warm) - 1}:
            warm[wi]()
        shape_floors = dict(warm_solver.last_shapes)

    while out.cycles < cycles:
        out.cycles += 1
        t0 = time.perf_counter()
        out.begins.append(t0)
        # emptiness
        occupied = [i for i, ps in enumerate(pods_on) if ps]
        nodes = [nodes[i] for i in occupied]
        prices = [prices[i] for i in occupied]
        pods_on = [pods_on[i] for i in occupied]
        candidates = sorted(
            range(len(nodes)), key=lambda i: (len(pods_on[i]), i)
        )[:100]
        if batched:
            lanes = ladder_lanes(candidates)
            solver = LaneSolver(pools, nodes, shape_floors=shape_floors,
                                device=device)
            verdicts = solver.solve_lazy(lanes)
            out.lanes += len(lanes)
            if out.first is None:
                out.first = {"solver": solver,
                             "verdicts": verdicts, "candidates": candidates,
                             "nodes": nodes, "prices": prices,
                             "pods_on": pods_on}

            def probe(n):
                return verdicts[n - 1](), nodes
        else:
            def probe(n):
                cand = set(candidates[:n])
                rest = [node for i, node in enumerate(nodes) if i not in cand]
                moved = [p for i in cand for p in pods_on[i]]
                return solve(moved, pools, existing=rest, objective="ffd",
                             device=device), rest

        def prefix_try(n):
            sol, inputs = probe(n)
            out.probes[(out.cycles, n)] = summarize(sol, inputs)
            if sol.unschedulable or len(sol.new_nodes) > 1:
                return None
            removed = sum(prices[i] for i in (candidates[:n] if batched
                                              else set(candidates[:n])))
            added = sum(x.price for x in sol.new_nodes)
            if removed <= added:
                return None
            return removed - added, sol

        lo, hi, best = 1, len(candidates), None
        while lo <= hi:
            mid = (lo + hi) // 2
            found = prefix_try(mid)
            if found is not None:
                best = (mid, found[0], found[1])
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            out.walls.append(time.perf_counter() - t0)
            break
        n_star, saving, sol = best
        out.decisions.append((n_star, round(saving, 6)))
        cand = set(candidates[:n_star])
        rest_index = [i for i in range(len(nodes)) if i not in cand]
        # a lane's assignments index the whole fleet, a sequential
        # probe's the retained nodes
        pos = ({full: j for j, full in enumerate(rest_index)} if batched
               else {j: j for j in range(len(rest_index))})
        new_nodes = [nodes[i] for i in rest_index]
        new_prices = [prices[i] for i in rest_index]
        new_pods_on = [list(pods_on[i]) for i in rest_index]
        for ea in sol.existing:
            j = pos[ea.existing_index]
            new_pods_on[j] = new_pods_on[j] + ea.pods
            used = merge(*(pod_requests(p) for p in ea.pods))
            node = new_nodes[j]
            new_nodes[j] = ExistingNodeInput(
                name=node.name,
                requirements=node.requirements,
                taints=node.taints,
                available={
                    k: max(0.0, v - used.get(k, 0.0))
                    for k, v in node.available.items()
                },
                pool_name=node.pool_name,
                pod_count=node.pod_count + len(ea.pods),
            )
        for plan in sol.new_nodes:
            out.fresh += 1
            new_nodes.append(node_input(f"{prefix}-{out.fresh}", plan.instance_types[0],
                                        plan.offerings[0], plan.pool, plan.pods))
            new_prices.append(plan.price)
            new_pods_on.append(list(plan.pods))
        nodes, prices, pods_on = new_nodes, new_prices, new_pods_on
        out.walls.append(time.perf_counter() - t0)
    out.price = float(sum(prices))
    out.nodes = len(nodes)
    return out


# ---------------------------------------------------------------- shards

def split_case(case: KernelCase, S: int) -> tuple[tuple, dict, tuple, dict]:
    """A kernel case as inputs of the split kernels: the config axis
    padded to `pack.config_width` (compat False, alloc 0, pool -1, price 0,
    reservation -1) and cut into S column blocks. Returns (split args,
    split kwargs, padded unsplit args, padded unsplit kwargs), numpy."""
    args = list(case.args)
    kw = dict(case.kwargs)
    Cp0 = args[0].shape[1]
    Cp = pack.config_width(Cp0, S)
    pad = Cp - Cp0
    rsv = kw.get("cfg_rsv")
    if rsv is None:
        rsv = np.full((Cp0,), -1, np.int32)
    if pad:
        args[0] = np.pad(args[0], ((0, 0), (0, pad)))
        args[3] = np.pad(args[3], ((0, pad), (0, 0)))
        args[4] = np.pad(args[4], (0, pad), constant_values=-1)
        args[11] = np.pad(args[11], (0, pad))
        rsv = np.pad(rsv, (0, pad), constant_values=-1)
    full_kw = dict(kw)
    if kw.get("cfg_rsv") is not None:
        full_kw["cfg_rsv"] = rsv
    split = list(args)
    for i, axis in pack._CONFIG_ARGS.items():
        split[i] = [np.ascontiguousarray(b) for b in np.split(args[i], S, axis=axis)]
    skw = dict(kw)
    skw["cfg_rsv"] = [np.ascontiguousarray(b) for b in np.split(rsv, S)]
    if skw.get("rsv_cap") is None:
        skw["rsv_cap"] = np.zeros((0,), np.float32)
    return tuple(split), skw, tuple(args), full_kw


def tie_case(seed: int, S: int, mode: str, G: int = 12, Cp: int = 96,
             B: int = 6, quota: bool = False) -> KernelCase:
    """A synthetic problem whose picks tie across every shard boundary
    of an S-way split of `Cp` columns (cost: twin columns of equal price
    per pod and different capacity, the cheapest there are; ffd: twin
    reserved columns of equal capacity in different reservation slots,
    cheaper than every uncapped column). Two resources, no pool
    overhead, a bound block of B rows."""
    rng = np.random.default_rng(seed)
    Cp = pack.config_width(Cp, S)
    Cs = Cp // S
    R = 2
    alloc = np.zeros((Cp, R), np.float32)
    alloc[:, 0] = rng.choice([4.0, 8.0, 16.0], size=Cp)
    alloc[:, 1] = 110.0
    pool = rng.integers(0, 2, size=Cp).astype(np.int32)
    price = (alloc[:, 0] * np.float32(0.1)
             * rng.uniform(1.0, 1.5, size=Cp).astype(np.float32)).astype(np.float32)
    rsv = np.full((Cp,), -1, np.int32)
    K = 0
    twins = []
    for s in range(1, S):
        b = s * Cs
        if b < 1 or b >= Cp:
            continue
        twins.append((b - 1, b))
    if mode == "cost":
        for a, b in twins:
            pool[b] = pool[a]
            alloc[b, 0] = 2 * alloc[a, 0]
            price[a] = np.float32(0.05) * alloc[a, 0]
            price[b] = np.float32(2) * price[a]
    else:
        for a, b in twins:
            pool[b] = pool[a]
            alloc[b] = alloc[a]
            price[a] = price[b] = np.float32(0.01)
            rsv[a], rsv[b] = K, K + 1
            K += 2
    req = np.zeros((G, R), np.float32)
    req[:, 0] = rng.choice([1.0, 2.0], size=G)
    req[:, 1] = 1.0
    count = rng.integers(1, 40, size=G).astype(np.int32)
    compat = rng.random((G, Cp)) < 0.6
    for a, b in twins:
        compat[:, a] = compat[:, b] = True
    overhead = np.zeros((3, R), np.float32)
    bound_cfg = rng.integers(0, Cp, size=B)
    bound_alloc = alloc[bound_cfg].copy()
    bound_used = np.zeros((B, R), np.float32)
    bound_used[:, 0] = np.minimum(rng.integers(0, 3, size=B), bound_alloc[:, 0])
    bound_live = rng.random(B) < 0.8
    bound_compat = (rng.random((G, B)) < 0.5) & bound_live[None, :]
    bound_slot = np.full((B,), K, np.int32)
    kwargs = {
        "bound_quota": (rng.integers(0, 5, size=(B, G)).astype(np.int16)
                        if quota else None),
        "cfg_rsv": rsv if K else None,
        "rsv_cap": np.full((K,), 2.0, np.float32) if K else None,
        "group_cap": None,
        "conflict": None,
    }
    args = (compat, req, count, alloc, pool, overhead, bound_compat,
            bound_alloc, bound_used, bound_slot, bound_live, price)
    return KernelCase(f"ties-S{S}-{mode}", args, kwargs, 48, mode)

