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
blocks (the inputs of the split kernels, B8), `tie_case` builds
problems whose picks tie across every shard boundary, and `fold_cases`
problems that reach the corners of the split open loop's one exchange
an open (several pools, a reserved column cheaper than every uncapped
one on one shard only, a chosen pool of zero open capacity).
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

For the consolidation engine: `disruption_env` gives an environment the
engine, its queue and the conditions controllers; `place`, `register`,
`terminate` stand in for the lifecycle and termination controllers;
`disruption_round(s)` run its rounds; `command_identity` and
`fleet_state` compare them across packages.

For the resilience ladder: `ladder_script` runs its fixed sequence of
solves, faults and seam checks through a `LadderPackage` (this
package's on a device; the tests subclass it for the JAX package), and
`ladder_mismatches` holds the result to the expected sequence; the CPU
tests and `chip_smoke.py` phase 12 run the same script.
"""

from __future__ import annotations

import contextlib
import itertools
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
from karpenter_tpu_torch.solver.resilience import STATE_CLOSED, STATE_OPEN
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


# the signed-zero problem's node axis
SIGNED_ZERO_ROWS = 16


def signed_zero_problem() -> tuple:
    """B7's nine positional inputs (numpy) for a problem whose usage pass
    shows: the JAX `pack` adds take * req to every row at every step, and
    on a row that takes nothing, used + 0 * req turns a -0.0 into +0.0
    when the request is positive. Three groups over 32 configs and two
    resources, one group without demand, positive and negative requests
    among them; four existing rows: row 0 holds a config no group is
    compatible with and uses -0.0 of both resources, row 1 a config the
    groups take (-0.0 of the second resource), row 2 no config (-0.0 of
    the first), row 3 a config at +0.0. Node axis: SIGNED_ZERO_ROWS."""
    G, C, R, E = 3, 32, 2, 4
    compat = np.ones((G, C), bool)
    compat[:, 0] = False
    group_req = np.array([[1.0, -0.5], [0.5, 0.25], [-0.25, -1.0]], np.float32)
    group_count = np.array([5, 0, 3], np.int32)
    cfg_alloc = np.full((C, R), 8.0, np.float32)
    cfg_pool = np.zeros((C,), np.int32)
    pool_overhead = np.zeros((1, R), np.float32)
    existing_mask = np.zeros((E, C), bool)
    existing_mask[0, 0] = existing_mask[1, 1] = existing_mask[3, 2] = True
    existing_used = np.array([[-0.0, -0.0], [2.0, -0.0], [-0.0, 1.0], [0.0, 0.0]],
                             np.float32)
    cfg_price = np.linspace(1, 2, C).astype(np.float32)
    return (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
            existing_mask, existing_used, cfg_price)


def price_case(seed: int, G: int, C: int, R: int, kind: str = "rand"):
    """Inputs of B4 (lam, compat, group_req, eff_alloc, count) as numpy.
    `kind` "ties": duplicated groups (exact density ties), a config whose
    allocatable a group's request divides exactly (a fill to zero
    residual) and tight demand caps; "negative-request": a few groups
    with a negative request (a residual that grows: B4's kernel takes
    every round's full argmax); "infinite-dual": group 0's dual +inf,
    compatible with every config, its one request tiny (every config
    takes it first; every value +inf; the full argmax too)."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 2.0, G).astype(np.float32)
    lam[rng.random(G) < 0.2] = 0.0
    compat = rng.random((G, C)) < 0.6
    req = rng.choice([0.0, 0.25, 0.5, 1.0, 2.0, 4.0], size=(G, R)).astype(np.float32)
    alloc = rng.choice([0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0], size=(C, R)).astype(np.float32)
    count = rng.integers(0, 40, G).astype(np.int32)
    if kind == "negative-request":
        neg = rng.choice(G, size=max(1, G // 10), replace=False)
        req[neg, rng.integers(0, R, len(neg))] = -1.0
    if kind == "infinite-dual":
        lam[0], compat[0], count[0] = np.inf, True, 5
        req[0] = 0.0
        req[0, 0] = 1e-30
    if kind == "ties":
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


# (seed, G, C, R, kind): the planner's padded shapes (lp_plan._pad_to)
PRICE_CASES = (
    (0, 32, 32, 4, "rand"),
    (1, 32, 40, 4, "ties"),
    (2, 40, 50, 4, "ties"),
    (3, 63, 79, 3, "rand"),
    (4, 194, 243, 4, "ties"),
    (5, 304, 124, 5, "rand"),
    (6, 40, 50, 4, "negative-request"),
    (7, 194, 243, 4, "infinite-dual"),
)


def price_cases(seed: int = 0) -> list[tuple[str, tuple]]:
    """Seeded B4 inputs, named."""
    return [
        (f"price-G{G}-C{C}-R{R}{'' if kind == 'rand' else '-' + kind}",
         price_case(seed + s, G, C, R, kind))
        for s, G, C, R, kind in PRICE_CASES
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


# B5's inputs past the 2048 layout (`lp_device.ascent_wide`), as
# ASCENT_EDGE_CASES: the padded config axis of the warm pool's two
# 4096-config buckets at their group axes, the padding buckets 2272 and
# 2840 (aws_catalog_50k's 2,400 configs), and padded group axes past 2048
# (2272, and 4438, where the bound's dot is XLA's scalar chain)
ASCENT_WIDE_CASES = (
    ("wide-c4438", 155, 4438, 4, 64, 40, 8, 6),
    ("wide-c4438-g243", 243, 4438, 4, 64, 40, 12, 8),
    ("wide-c2840", 155, 2840, 4, 64, 30, 8, 6),
    ("wide-c2272", 96, 2272, 3, 1, 0, 6, 4),
    ("wide-g2272", 2272, 96, 4, 64, 20, 40, 12),
    ("wide-g4438", 4438, 64, 4, 1, 0, 40, 12),
)


def ascent_wide_cases(seed: int = 0, names=None) -> list[tuple[str, "lp_device.AscentInputs"]]:
    """`ASCENT_WIDE_CASES` (or those of them named) as named B5 inputs."""
    return [(f"ascent-{name}", ascent_edge_case(seed + i, *shape))
            for i, (name, *shape) in enumerate(ASCENT_WIDE_CASES)
            if names is None or name in names]


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


def _synthetic(name: str, mode: str, alloc, pool, price, overhead, req, count, compat,
               rsv=None, rsv_cap=None, max_free: int = 48) -> KernelCase:
    """A kernel case from config-axis arrays and groups, no bound rows."""
    G, R = req.shape
    K = 0 if rsv_cap is None else rsv_cap.shape[0]
    kwargs = {"bound_quota": None, "cfg_rsv": rsv if K else None,
              "rsv_cap": rsv_cap if K else None, "group_cap": None, "conflict": None}
    args = (compat, req.astype(np.float32), count.astype(np.int32), alloc.astype(np.float32),
            pool.astype(np.int32), overhead.astype(np.float32), np.zeros((G, 0), bool),
            np.zeros((0, R), np.float32), np.zeros((0, R), np.float32),
            np.zeros((0,), np.int32), np.zeros((0,), bool), price.astype(np.float32))
    return KernelCase(name, args, kwargs, max_free, mode)


def fold_cases(seed: int, S: int) -> list[KernelCase]:
    """Problems that reach the corners of the split open loop's one
    exchange an open (`open_loop_split` in csrc/pack_common.cuh), for an
    S-way split:
      - three NodePools with different overheads and catalogs, built
        through the encode (both modes; ffd also with reservations), so
        that the lowest pool that can open moves from group to group;
      - ffd with reserved columns where the one reserved column cheaper
        than the least uncapped price lies on one shard only, and a
        reserved decoy with more capacity on another shard is cheaper
        than its own shard's uncapped columns but not than the least
        over every shard (a filter on a shard's own minimum takes it);
        reservations of two nodes, so that opens go on past them;
      - ties of equal keys across every shard boundary with the lower
        pool closed to the larger groups (their pool is the second);
      - a chosen pool whose fitting configs have zero open capacity
        (alloc and overhead 2^24 on a resource requested at 0.5: the
        fit test's f32 difference rounds up, the capacity's does not),
        in both modes, and in cost mode with live configs of that pool
        priced +inf (their keys above every zero key) at each shard's
        first column, so that the pick falls to the first column not
        live in the pool, past a shard's first column."""
    rng = np.random.default_rng(seed)
    cases = []
    # ---- three NodePools through the encode
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool
    from karpenter_tpu_torch.cloudprovider.fake import GIB
    from karpenter_tpu_torch.kube.objects import ObjectMeta

    for rsv in (False, True):
        pods, pools = build_problem(240, 60, seed=seed, reservations=rsv)
        types = list(pools[0][1])
        n = len(types)
        three = [(NodePool(metadata=ObjectMeta(name=name)), ts) for name, ts in (
            ("pool-a", types[: 2 * n // 3]), ("pool-b", types[n // 3:]), ("pool-c", types))]
        overhead = {"pool-a": {"cpu": 1.5, "memory": 2.0 * GIB}, "pool-b": {"cpu": 0.25},
                    "pool-c": {"memory": 0.5 * GIB}}
        enc = encode(group_pods(pods), three, daemon_overhead=overhead)
        modes = ("ffd",) if rsv else ("ffd", "cost")
        cases += [_case(f"three-pools{'-rsv' if rsv else ''}-{m}", enc, m) for m in modes]

    # ---- the reserved column cheaper than every uncapped one, on one shard
    Cp = pack.config_width(64, S)
    Cs = Cp // S
    R, G = 2, 6
    alloc = np.zeros((Cp, R), np.float32)
    alloc[:, 0] = rng.choice([4.0, 8.0], size=Cp)
    alloc[:, 1] = 64.0
    price = np.float32(2.0) + rng.uniform(0, 1, size=Cp).astype(np.float32)
    price[Cs // 2] = 1.0  # the least uncapped price, on shard 0
    rsv = np.full((Cp,), -1, np.int32)
    decoy, true = (S - 1) * Cs + 1, (S - 1) * Cs + 2
    if S > 2:
        decoy = Cs + 1
    rsv[decoy], rsv[true] = 0, 1
    price[decoy], alloc[decoy, 0] = 1.5, 16.0
    price[true], alloc[true, 0] = 0.5, 8.0
    if decoy // Cs == true // Cs:
        # at S = 2 both lie on the last shard: its own uncapped columns
        # stay above the decoy
        price[(S - 1) * Cs:] = np.maximum(price[(S - 1) * Cs:], np.float32(2.0))
        price[decoy], price[true] = 1.5, 0.5
    req = np.ones((G, R), np.float32)
    req[:, 0] = rng.choice([1.0, 2.0], size=G)
    cases.append(_synthetic(
        f"rsv-one-shard-S{S}-ffd", "ffd", alloc, np.zeros(Cp, np.int32), price,
        np.zeros((2, R), np.float32), req, rng.integers(8, 40, size=G),
        np.ones((G, Cp), bool), rsv=rsv, rsv_cap=np.full((2,), 2.0, np.float32)))

    # ---- ties across the boundaries, the lower pool closed to large groups
    for mode in ("cost", "ffd"):
        base = tie_case(seed + 1, S, mode)
        args = list(base.args)
        overhead = args[5].copy()
        overhead[0, 0] = 3.0  # pool 0 holds a group requesting 2 cpu only on 16-cpu configs
        args[5] = overhead
        args[1] = args[1].copy()
        args[1][::2, 0] = 2.0
        cases.append(KernelCase(f"ties-pool1-S{S}-{mode}", tuple(args), base.kwargs,
                                base.max_free, mode))

    # ---- a chosen pool whose fitting configs have zero open capacity
    Cp = pack.config_width(32, S)
    Cs = Cp // S
    alloc = np.zeros((Cp, R), np.float32)
    alloc[:, 0] = 8.0
    pool = np.where(np.arange(Cp) % 2 == 0, 0, 1).astype(np.int32)
    alloc[:, 1] = np.where(pool == 0, np.float32(2.0**24), np.float32(100.0))
    overhead = np.zeros((3, R), np.float32)
    overhead[0, 1] = 2.0**24
    price = (np.float32(1.0) + rng.uniform(0, 1, size=Cp)).astype(np.float32)
    G = 5
    req = np.zeros((G, R), np.float32)
    req[:, 0] = rng.choice([1.0, 2.0], size=G)
    req[:, 1] = 0.5
    count = rng.integers(2, 9, size=G)
    for mode in ("ffd", "cost"):
        cases.append(_synthetic(f"zero-open-S{S}-{mode}", mode, alloc, pool, price, overhead,
                                req, count, np.ones((G, Cp), bool), max_free=32))
    # live configs of pool 0 at each shard's first column, priced +inf
    alloc_inf = alloc.copy()
    price_inf = price.copy()
    firsts = np.arange(S) * Cs
    pool_inf = pool.copy()
    pool_inf[firsts] = 0
    alloc_inf[firsts, 1] = 2.0**24 + 64.0  # fits pool 0 with room to spare
    price_inf[firsts] = np.inf
    cases.append(_synthetic(f"zero-open-inf-S{S}-cost", "cost", alloc_inf, pool_inf, price_inf,
                            overhead, req, count, np.ones((G, Cp), bool), max_free=32))
    return cases



def pools_cases(seed: int, n_pools: int = 80, n_pods: int = 160, n_types: int = 24,
                per_pool: int = 3) -> list[KernelCase]:
    """Problems with `n_pools` NodePools (P1 = n_pools + 1 overhead rows,
    past the 63 pools the split kernels' open loop once took), built
    through the encode in both modes: pool p offers `per_pool` types of
    the catalog from type p on (wrapping), with a daemon overhead that
    grows with p, so that the lowest pool that can open a group moves
    across the whole pool axis as groups grow."""
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool
    from karpenter_tpu_torch.cloudprovider.fake import GIB
    from karpenter_tpu_torch.kube.objects import ObjectMeta

    pods, pools = build_problem(n_pods, n_types, seed=seed)
    types = list(pools[0][1])
    many = [(NodePool(metadata=ObjectMeta(name=f"pool-{p:03d}")),
             [types[(p + i) % len(types)] for i in range(per_pool)]) for p in range(n_pools)]
    overhead = {f"pool-{p:03d}": {"cpu": 0.05 * (p % 17), "memory": 0.125 * GIB * (p % 5)}
                for p in range(n_pools)}
    enc = encode(group_pods(pods), many, daemon_overhead=overhead)
    return [_case(f"pools{n_pools}-{m}", enc, m) for m in ("ffd", "cost")]


def lane_case(name: str, enc, seed: int, n_lanes: int) -> LaneCase:
    """Seeded B6 lanes over `enc`'s problem (`_lane_case`): the probe
    batch of a consolidation search on any problem, e.g. a cloud-sized
    catalog whose tables spill past the shared-memory budget."""
    return _lane_case(name, enc, np.random.default_rng(seed), n_lanes)


def cut_groups(case, G: int):
    """`case` (a KernelCase or LaneCase) with its group axis cut to the
    first G groups: the compat and request rows, the demand (every
    lane's), the bound rows' compatibility and quotas, the group caps and
    the conflicts. For timing a kernel on the largest shape whose tables
    still fit the shared-memory budget."""
    args = list(case.args)
    kw = dict(case.kwargs)
    args[0] = np.ascontiguousarray(args[0][:G])
    args[1] = np.ascontiguousarray(args[1][:G])
    args[2] = np.ascontiguousarray(args[2][..., :G])
    args[6] = np.ascontiguousarray(args[6][:G])
    if kw.get("bound_quota") is not None:
        kw["bound_quota"] = np.ascontiguousarray(kw["bound_quota"][:, :G])
    if kw.get("group_cap") is not None:
        kw["group_cap"] = np.ascontiguousarray(kw["group_cap"][:G])
    if kw.get("conflict") is not None:
        kw["conflict"] = np.ascontiguousarray(kw["conflict"][:G, :G])
    if isinstance(case, LaneCase):
        return LaneCase(f"{case.name}-G{G}", tuple(args), kw, case.max_free, case.n_lanes)
    return KernelCase(f"{case.name}-G{G}", tuple(args), kw, case.max_free, case.mode)


# ---------------------------------------------------------------- ladder

# every knob the resilience ladder, the fault injector and the device LP
# read; `ladder_script` unsets them all before it sets its own
LADDER_KNOBS = (
    "KARPENTER_FAULTS", "KARPENTER_FAULT_SEED", "KARPENTER_BREAKER_THRESHOLD",
    "KARPENTER_BREAKER_COOLDOWN_MS", "KARPENTER_BREAKER_MAX_COOLDOWN_MS",
    "KARPENTER_SOLVE_DEADLINE_MS", "KARPENTER_COMPILE_DEADLINE_MS",
    "KARPENTER_SOLVE_HEDGE_MS", "KARPENTER_SOLVER_SHARDS", "KARPENTER_SOLVE_LADDER",
    "KARPENTER_SOLVER_ENDPOINT", "KARPENTER_REWARM_ON_CLOSE", "KARPENTER_SOLVER_BACKEND",
    "KARPENTER_LP_GUIDE", "KARPENTER_LP_SHARDS",
)
# the injected stall of the deadline and hedge stages, and their budgets
LADDER_DELAY = "1s"
LADDER_DEADLINE_MS = 300
LADDER_COMPILE_DEADLINE_MS = 200
LADDER_HEDGE_MS = 50
# the lane sets of the probe stage: the fleet's first nodes removed
LADDER_LANES = ((0,), (0, 1), (0, 1, 2))


@contextlib.contextmanager
def scoped_env(values: dict):
    """Within the block, each `values` key is set (None: unset); every
    one is restored after."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pack_digest(res) -> str:
    """Identity of a PackResult's used rows (node count, assignment,
    masks, usage, live rows, unschedulable counts), dtype-normalized so
    the JAX package's results and this package's compare."""
    import hashlib

    n = int(res.node_count)
    h = hashlib.sha256(str(n).encode())
    for arr, dt in ((res.assign[:n], np.int32), (res.node_mask[:n], np.bool_),
                    (res.node_used[:n], np.float64), (res.node_active[:n], np.bool_),
                    (res.unschedulable, np.int32)):
        h.update(np.ascontiguousarray(np.asarray(arr), dtype=dt).tobytes())
    return h.hexdigest()


def ladder_fleet(pods, pools, device, keep: float = 0.5):
    """A fleet for the ladder's probe stage: the nodes of `pods`' FFD
    solve on `device` as existing nodes that kept the first `keep` share
    of their pods. Returns (pools, existing inputs, kept pods per node)."""
    from karpenter_tpu_torch.solver.solver import solve

    sol = solve(pods, pools, device=device)
    inputs = existing_from_solution(sol, keep=keep)
    pods_on = [plan.pods[: int(round(len(plan.pods) * keep))] for plan in sol.new_nodes]
    return pools, inputs, pods_on


class LadderPackage:
    """One package's side of `ladder_script`: its resilience, faults and
    metrics modules, the encoded problem and the fleet of the probe
    stage, and the calls whose signatures differ between the packages.
    This class is this package's side on `device`; a test subclasses it
    for the JAX package. `fleet` is (pools, existing inputs, kept pods
    per node), as `ladder_fleet` makes it."""

    def __init__(self, enc, fleet, device="cpu"):
        import torch

        from karpenter_tpu_torch.metrics import store
        from karpenter_tpu_torch.solver import consolidation_batch, faults, resilience
        from karpenter_tpu_torch.solver import solver as solver_mod

        self.enc, self.fleet = enc, fleet
        self.device = torch.device(device)
        self.resilience, self.faults, self.store = resilience, faults, store
        self.solver, self.lp_device, self.lanes = solver_mod, lp_device, consolidation_batch

    def solve(self):
        return self.resilience.shared().solve_packing(self.enc, mode="ffd", device=self.device)

    def solve_async(self):
        return self.resilience.shared().solve_packing_async(self.enc, mode="ffd",
                                                            device=self.device)

    def direct(self):
        return pack.solve_packing(self.enc, mode="ffd", device=self.device, shards=1)

    def host(self):
        return self.resilience.host_pack_result(self.enc)

    @contextlib.contextmanager
    def mesh(self, n: int):
        from karpenter_tpu_torch.utils.platform import force_virtual_mesh, virtual_mesh

        before = virtual_mesh()
        force_virtual_mesh(n)
        try:
            yield
        finally:
            force_virtual_mesh(before)

    def lane_solver(self):
        pools, inputs, pods_on = self.fleet
        lanes = [self.lanes.ProbeLane(exclude_names=tuple(inputs[i].name for i in s),
                                      pods=[p for i in s for p in pods_on[i]])
                 for s in LADDER_LANES]
        return self.lanes.LaneSolver(pools, inputs, device=self.device), lanes

    @contextlib.contextmanager
    def broken_lp(self):
        """The device LP's solve fails within the block: on the CPU its
        `solve` raises; on the card its kernel wrapper raises a lost
        device, after the LP has staged its inputs there."""
        name = "ascend" if self.device.type == "cuda" else "solve"
        real = getattr(self.lp_device, name)

        def lost(*args, **kwargs):
            raise self.faults.DeviceLostError(f"lp_device.{name}: injected lost device")

        setattr(self.lp_device, name, lost)
        try:
            yield
        finally:
            setattr(self.lp_device, name, real)

    def maybe_lp(self):
        return self.lp_device.maybe_solve(self.enc, device=self.device)

    def cost(self):
        from karpenter_tpu_torch.solver.solver import fingerprint

        return fingerprint(self.solver.solve_encoded(self.enc, objective="cost",
                                                     device=self.device))

    def cost_without_lp(self):
        """The cost solve when the device LP gives no duals: the path a
        degraded LP serves (KARPENTER_LP_GUIDE=0 differs: it also turns
        off the plan-guided trim)."""
        real = self.lp_device.maybe_solve
        self.lp_device.maybe_solve = lambda *a, **k: None
        try:
            return self.cost()
        finally:
            self.lp_device.maybe_solve = real

    def reset_caches(self):
        self.solver.reset_caches()


def _deltas(counter, before: dict) -> dict:
    out = {}
    for labels, value in counter.samples():
        d = value - before.get(labels, 0.0)
        if d:
            out[",".join(f"{k}={v}" for k, v in labels)] = int(d)
    return out


def ladder_script(pkg: LadderPackage, env: Optional[dict] = None,
                  cooldown_ms: Optional[int] = None) -> tuple[list, dict]:
    """The resilience ladder's fixed script, the same in the CPU tests
    (through both packages) and on the card. Returns (records, walls):
    per solve or seam check a record of deterministic fields (the rung
    that served it, `pop_degraded()`, the deltas of the ladder, hedge,
    deadline, breaker-transition and LP counters, the device breaker's
    state before and after, the fault log, the PackResult's digest and
    whether it equals the direct device solve and the host oracle's), and
    the host-clock walls, which are not.

    1. healthy: three solves, each served by the device rung.
    2. a lost device and the breaker (device_lost@solve:2-3, threshold
       2): device, host, host (the breaker opens), skipped_open then
       host, a sleep past the cooldown, half-open then device (closes),
       device. The cooldown is `cooldown_ms`, by default 200 ms or six
       host solves, whichever is longer, so the fourth solve finds the
       breaker still cooling down whatever the host oracle costs here.
    3. deadlines: an execute stall past KARPENTER_SOLVE_DEADLINE_MS
       (`deadline`), then a compile stall past
       KARPENTER_COMPILE_DEADLINE_MS (`compile_timeout`), each served by
       the host.
    4. the hedge: the execute stall with the hedge timer set; the hedge
       fires and its host answer is served (`win`). Up to three
       attempts: the timer thread can be scheduled late on a loaded
       host.
    5. sharded: KARPENTER_SOLVER_SHARDS=4 on a mesh of 4 and
       device_lost@solve:1: the sharded rung fails, the device rung
       serves, reported degraded.
    6. the probe path: device_lost@probe:1 on a LaneSolver dispatch
       raises DeviceLostError and charges the device breaker one
       failure; the next consult dispatches and decodes.
    7. the LP: with the LP's solve failing, `maybe_solve` is None and
       counts `degraded`, the cost solve equals the one without the LP,
       and `dual_certificate` does not run the LP again until the lane
       solver stages again (then, with the LP healthy, it certifies).
    8. the asynchronous seam (`solve_packing_async`, then `result()` on
       the calling thread): a healthy solve dispatched directly and
       served by the device rung at its guarded fetch; device_lost at
       the fetch's `execute` site, recorded at the fetch and served by
       the host; an execute stall past KARPENTER_SOLVE_DEADLINE_MS, the
       whole ladder on an executor worker, served by the host with the
       degradation report on the calling thread. Each record names the
       pending object's type.

    Abandoned watchdog attempts are drained at the end of each stage, so
    no stalled attempt fires a fault site under the next stage's spec."""
    res, flt, store = pkg.resilience, pkg.faults, pkg.store
    counters = {"ladder": store.SOLVER_LADDER, "hedge": store.SOLVER_HEDGE,
                "deadline": store.SOLVER_DEADLINE_EXCEEDED,
                "transitions": store.SOLVER_BREAKER_TRANSITIONS,
                "lp": store.SOLVER_LP_SOLVES}
    records: list[dict] = []
    walls: dict = {}

    def fresh():
        res._drain_watchdogs()
        res.reset()
        flt.reset()
        res.pop_degraded()

    def log():
        inj = flt.get()
        return [list(e) for e in inj.snapshot_log()] if inj is not None else []

    def state(name="device"):
        return res.shared().breaker(name).state

    def snap():
        return {k: dict(c.samples()) for k, c in counters.items()}

    def deltas(before):
        return {k: _deltas(c, before[k]) for k, c in counters.items()}

    def run(stage: str, step: int, asynchronous: bool = False) -> dict:
        before, br0 = snap(), state()
        t0 = time.perf_counter()
        pending = pkg.solve_async() if asynchronous else None
        out = pending.result() if asynchronous else pkg.solve()
        wall = time.perf_counter() - t0
        d = deltas(before)
        served = sorted(k.split("rung=")[1] for k, v in d["ladder"].items()
                        if k.startswith("outcome=ok,"))
        digest = pack_digest(out)
        rec = {"stage": stage, "step": step, "served": served,
               "degraded": res.pop_degraded(), **d, "breaker": [br0, state()],
               "faults": log(), "pack": digest,
               "equals": {"direct": digest == ref["direct"], "host": digest == ref["host"]}}
        if asynchronous:
            rec["pending"] = type(pending).__name__
        records.append(rec)
        walls[f"{stage}-{step}"] = wall
        return rec

    clean = {k: None for k in LADDER_KNOBS}
    with scoped_env({**clean, **(env or {})}):
        fresh()
        ref = {"direct": pack_digest(pkg.direct())}
        t0 = time.perf_counter()
        ref["host"] = pack_digest(pkg.host())
        walls["host_s"] = host_s = time.perf_counter() - t0
        cooldown = cooldown_ms or max(200, int(6000 * host_s) + 1)
        walls["cooldown_ms"] = cooldown

        # 1. healthy
        for i in range(3):
            run("healthy", i)

        # 2. a lost device and the breaker
        with scoped_env({"KARPENTER_FAULTS": "device_lost@solve:2-3",
                         "KARPENTER_BREAKER_THRESHOLD": "2",
                         "KARPENTER_BREAKER_COOLDOWN_MS": str(cooldown)}):
            fresh()
            for i in range(6):
                if i == 4:
                    t0 = time.perf_counter()
                    while res.shared().breaker("device").is_open():
                        time.sleep(0.005)
                    walls["breaker_sleep_s"] = time.perf_counter() - t0
                run("breaker", i)

        # 3. deadlines
        for stage, knobs in (
            ("deadline", {"KARPENTER_FAULTS": f"exec_delay@execute:1={LADDER_DELAY}",
                          "KARPENTER_SOLVE_DEADLINE_MS": str(LADDER_DEADLINE_MS)}),
            ("compile_deadline", {"KARPENTER_FAULTS": f"compile_delay@compile:1={LADDER_DELAY}",
                                  "KARPENTER_COMPILE_DEADLINE_MS": str(LADDER_COMPILE_DEADLINE_MS)}),
        ):
            with scoped_env(knobs):
                fresh()
                rec = run(stage, 0)
                res._drain_watchdogs()
                rec["faults"] = log()

        # 4. the hedge
        with scoped_env({"KARPENTER_FAULTS": f"exec_delay@execute:1={LADDER_DELAY}",
                         "KARPENTER_SOLVE_DEADLINE_MS": str(LADDER_DEADLINE_MS),
                         "KARPENTER_SOLVE_HEDGE_MS": str(LADDER_HEDGE_MS)}):
            for attempt in range(3):
                if attempt:
                    records.pop()
                fresh()
                rec = run("hedge", 0)
                res._drain_watchdogs()
                rec["faults"] = log()
                walls["hedge_attempts"] = attempt + 1
                if rec["hedge"].get("outcome=win") == 1:
                    break

        # 5. sharded
        with pkg.mesh(4), scoped_env({"KARPENTER_SOLVER_SHARDS": "4",
                                      "KARPENTER_FAULTS": "device_lost@solve:1"}):
            fresh()
            rec = run("sharded", 0)
            rec["breaker_sharded"] = state("sharded")

        # 6. the probe path
        with scoped_env({"KARPENTER_FAULTS": "device_lost@probe:1"}):
            fresh()
            ls, lanes = pkg.lane_solver()
            thunks = ls.solve_lazy(lanes)
            try:
                thunks[0]()
                raised = None
            except Exception as err:  # noqa: BLE001 — the record names it
                raised = type(err).__name__
            br = res.shared().breaker("device")
            rec = {"stage": "probe", "step": 0, "raised": raised,
                   "failures": br._failures, "breaker": br.state,
                   "faults": log()}
            sol = thunks[0]()
            rec["then"] = {"faults": log(), "decoded": sol is not None,
                           "failures": br._failures}
            records.append(rec)

        # 7. the LP
        fresh()
        pkg.reset_caches()
        lp = counters["lp"]
        deg = {"outcome": "degraded"}
        with root_node_mips():
            rec = {"stage": "lp", "step": 0}
            with pkg.broken_lp():
                before = lp.value(deg)
                rec["maybe_solve"] = pkg.maybe_lp() is not None
                rec["maybe_degraded"] = int(lp.value(deg) - before)
                before = lp.value(deg)
                cost = pkg.cost()
                rec["cost_degraded"] = int(lp.value(deg) - before)
                certs = []
                for _ in range(2):
                    before = lp.value(deg)
                    certs.append([ls.dual_certificate() is not None,
                                  int(lp.value(deg) - before)])
                rec["certificate"] = certs
            pkg.reset_caches()
            rec["cost_equals_without_lp"] = cost == pkg.cost_without_lp()
            ls.solve_lazy(lanes)
            rec["certificate_after_staging"] = ls.dual_certificate() is not None
            records.append(rec)

        # 8. the asynchronous seam
        for stage, knobs in (
            ("async", {}),
            ("async_fetch", {"KARPENTER_FAULTS": "device_lost@execute:1"}),
            ("async_deadline", {"KARPENTER_FAULTS": f"exec_delay@execute:1={LADDER_DELAY}",
                                "KARPENTER_SOLVE_DEADLINE_MS": str(LADDER_DEADLINE_MS)}),
        ):
            with scoped_env(knobs):
                fresh()
                rec = run(stage, 0, asynchronous=True)
                res._drain_watchdogs()
                rec["faults"] = log()
        fresh()
    return records, walls


def _ok(rung: str) -> str:
    return f"outcome=ok,rung={rung}"


def _fail(rung: str, outcome: str) -> str:
    return f"outcome={outcome},rung={rung}"



# per stage and step: (served rung, degraded report, ladder deltas,
# device breaker state after, the result it must equal)
LADDER_EXPECTED = {
    ("healthy", 0): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("healthy", 1): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("healthy", 2): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("breaker", 0): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("breaker", 1): (["host"], ["host"], {_fail("device", "device_lost"): 1, _ok("host"): 1},
                     STATE_CLOSED, "host"),
    ("breaker", 2): (["host"], ["host"], {_fail("device", "device_lost"): 1, _ok("host"): 1},
                     STATE_OPEN, "host"),
    ("breaker", 3): (["host"], ["host"], {_fail("device", "skipped_open"): 1, _ok("host"): 1},
                     STATE_OPEN, "host"),
    ("breaker", 4): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("breaker", 5): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("deadline", 0): (["host"], ["host"], {_fail("device", "deadline"): 1, _ok("host"): 1},
                      STATE_CLOSED, "host"),
    ("compile_deadline", 0): (["host"], ["host"],
                              {_fail("device", "compile_timeout"): 1, _ok("host"): 1},
                              STATE_CLOSED, "host"),
    ("hedge", 0): (["host"], ["host"], {_fail("device", "deadline"): 1, _ok("host"): 1},
                   STATE_CLOSED, "host"),
    ("sharded", 0): (["device"], ["device"],
                     {_fail("sharded", "device_lost"): 1, _ok("device"): 1}, STATE_CLOSED, "direct"),
    ("async", 0): (["device"], [], {_ok("device"): 1}, STATE_CLOSED, "direct"),
    ("async_fetch", 0): (["host"], ["host"], {_fail("device", "device_lost"): 1, _ok("host"): 1},
                         STATE_CLOSED, "host"),
    ("async_deadline", 0): (["host"], ["host"], {_fail("device", "deadline"): 1, _ok("host"): 1},
                            STATE_CLOSED, "host"),
}
LADDER_FAULTS = {
    "breaker": [["solve", 2, "device_lost"], ["solve", 3, "device_lost"]],
    "deadline": [["execute", 1, "exec_delay"]],
    "compile_deadline": [["compile", 1, "compile_delay"]],
    "hedge": [["execute", 1, "exec_delay"]],
    "sharded": [["solve", 1, "device_lost"]],
    "async_fetch": [["execute", 1, "device_lost"]],
    "async_deadline": [["execute", 1, "exec_delay"]],
}
# the pending object each asynchronous stage hands back
LADDER_PENDING = {"async": "_GuardedPending", "async_fetch": "_GuardedPending",
                  "async_deadline": "Future"}


def ladder_mismatches(records: list, walls: dict) -> list[str]:
    """What in `ladder_script`'s output differs from the script's
    expected sequence (its docstring); empty when all holds."""
    bad = []
    solves = {(r["stage"], r["step"]): r for r in records if "served" in r}
    if sorted(solves) != sorted(LADDER_EXPECTED):
        bad.append(f"stages run {sorted(solves)}")
    for key, (served, degraded, ladder, after, same) in LADDER_EXPECTED.items():
        r = solves.get(key)
        if r is None:
            continue
        got = (r["served"], r["degraded"], r["ladder"], r["breaker"][1], r["equals"][same])
        if got != (served, degraded, ladder, after, True):
            bad.append(f"{key}: served, degraded, ladder, breaker after, equal to {same} "
                       f"= {got}; expected {(served, degraded, ladder, after, True)}")
    for stage, want in LADDER_FAULTS.items():
        last = max((r for k, r in solves.items() if k[0] == stage), key=lambda r: r["step"],
                   default=None)
        if last is not None and last["faults"] != want:
            bad.append(f"{stage}: fault log {last['faults']}, expected {want}")
    br = [solves.get(("breaker", i), {}).get("breaker") for i in range(6)]
    if br[3] is not None and br[3][0] != STATE_OPEN:
        bad.append(f"breaker: the fourth solve found the breaker {br[3][0]}, not open")
    if br[4] is not None and (br[4][0] != STATE_OPEN or solves[("breaker", 4)]["transitions"] != {
            "backend=device,to=half_open": 1, "backend=device,to=closed": 1}):
        bad.append(f"breaker: the fifth solve did not half-open and close it: {br[4]}, "
                   f"{solves[('breaker', 4)]['transitions']}")
    for stage, phase in (("deadline", "execute"), ("compile_deadline", "compile"),
                         ("hedge", "execute"), ("async_deadline", "execute")):
        r = solves.get((stage, 0))
        if r is not None and r["deadline"] != {f"phase={phase}": 1}:
            bad.append(f"{stage}: deadline counts {r['deadline']}")
    for stage, kind in LADDER_PENDING.items():
        r = solves.get((stage, 0))
        if r is not None and r.get("pending") != kind:
            bad.append(f"{stage}: pending {r.get('pending')}, expected {kind}")
    r = solves.get(("hedge", 0))
    if r is not None and r["hedge"] != {"outcome=fired": 1, "outcome=win": 1}:
        bad.append(f"hedge: counts {r['hedge']} in {walls.get('hedge_attempts')} attempts")
    for stage in ("deadline", "hedge", "async_deadline"):
        wall = walls.get(f"{stage}-0")
        budget = LADDER_DEADLINE_MS / 1000 + 2 * walls.get("host_s", 0.0) + 0.5
        if wall is not None and wall >= budget:
            bad.append(f"{stage}: {wall:.3f}s, past the deadline plus two host solves "
                       f"({budget:.3f}s)")
    probe = next((r for r in records if r["stage"] == "probe"), None)
    want = {"raised": "DeviceLostError", "failures": 1, "breaker": STATE_CLOSED,
            "faults": [["probe", 1, "device_lost"]],
            "then": {"faults": [["probe", 1, "device_lost"]], "decoded": True, "failures": 1}}
    if probe is None or {k: probe.get(k) for k in want} != want:
        bad.append(f"probe: {probe}")
    lp = next((r for r in records if r["stage"] == "lp"), None)
    want = {"maybe_solve": False, "maybe_degraded": 1, "cost_degraded": 1,
            "certificate": [[False, 1], [False, 0]], "cost_equals_without_lp": True,
            "certificate_after_staging": True}
    if lp is None or {k: lp.get(k) for k in want} != want:
        bad.append(f"lp: {lp}")
    return bad


# -- provisioning rounds ------------------------------------------------------
#
# A `ProvisionCase` is one provisioning round as plain data (numbers,
# strings, tuples), made from a seed with numpy, so that this package
# and the JAX package can each build their own objects from it.
# `case_objects(case, api)` builds the objects with the constructors of
# the package `api` names (`package_api()` is this package's; a test
# passes the JAX package's modules under the same names);
# `provision_env(case, device)` builds this package's whole round: the
# in-memory API, the cluster mirror, the fake provider and the
# Provisioner. `decision_fingerprint`, `claim_contents` and
# `mirror_state` read a round's outcome by attribute only, so they
# read either package's objects.

GIB = 2**30
# the creation timestamps of every object a case builds: a decision
# must not depend on when the test ran
CASE_T0 = 1_700_000_000.0
ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


@dataclass
class ProvisionCase:
    """One provisioning round. Pods and nodes are dicts of plain
    values (see `case_objects` for the keys); `catalog` is
    ("diverse" | "hetero", n, stride): every stride-th type of
    `instance_types(n)` or `heterogeneous_instance_types(n)`, or
    ("custom", ((name, cpu, memory GiB, price), ...), 1);
    `reservations` are (type index, reservation id, zone, count)."""

    name: str
    pods: list = field(default_factory=list)
    pools: list = field(default_factory=list)
    catalog: tuple = ("diverse", 108, 3)
    reservations: tuple = ()
    nodes: list = field(default_factory=list)
    daemonsets: list = field(default_factory=list)
    priority_classes: tuple = ()
    volumes: tuple = ()                 # (pvc name, zones)
    min_values_policy: str = "Strict"
    extra_pods: list = field(default_factory=list)   # a second round's arrivals


def package_api():
    """This package's modules under the names `case_objects` and
    `build_env` read."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.apis.v1 import labels, nodeclaim, nodepool
    from karpenter_tpu_torch.cloudprovider import fake
    from karpenter_tpu_torch.disruption import conditions, engine, validation
    from karpenter_tpu_torch.events import recorder
    from karpenter_tpu_torch.kube import client, objects
    from karpenter_tpu_torch.metrics import store
    from karpenter_tpu_torch.operator import options
    from karpenter_tpu_torch.provisioning import provisioner
    from karpenter_tpu_torch.state import cluster, retained
    from karpenter_tpu_torch.utils import pdb

    return SimpleNamespace(
        labels=labels, nodeclaim=nodeclaim, nodepool=nodepool, fake=fake,
        objects=objects, client=client, cluster=cluster,
        provisioner=provisioner, store=store, engine=engine,
        conditions=conditions, validation=validation, recorder=recorder,
        options=options, pdb=pdb, retained=retained,
    )


def case_types(case: ProvisionCase, api) -> list:
    kind, n, stride = case.catalog
    if kind == "custom":
        # n: (name, cpu, memory GiB, price) per type
        types = [api.fake.make_instance_type(name, cpu=cpu, memory=mem * GIB,
                                             price=price)
                 for name, cpu, mem, price in n]
    else:
        gen = api.fake.instance_types if kind == "diverse" else \
            api.fake.heterogeneous_instance_types
        types = list(gen(n)[::stride])
    for ti, rid, zone, count in case.reservations:
        it = types[ti]
        types[ti] = api.fake.make_instance_type(
            it.name,
            cpu=float(it.capacity["cpu"]),
            memory=float(it.capacity["memory"]),
            pods=float(it.capacity["pods"]),
            arch=it.requirements.get(ARCH_LABEL).any_value(),
            os=it.requirements.get(OS_LABEL).any_value(),
            price=min(o.price for o in it.offerings
                      if o.capacity_type == "on-demand"),
            reservations=[(rid, zone, count)],
        )
    return types


def _selector(api, labels: dict):
    return api.objects.LabelSelector.of(dict(labels))


def case_pod(api, d: dict, ts: float):
    o = api.objects
    spec = o.PodSpec(
        containers=[o.Container(
            requests={"cpu": float(d.get("cpu", 1.0)),
                      "memory": float(d.get("mem", 1.0) * GIB)},
            ports=list(d.get("host_ports", ())),
            resource_claims=list(d.get("resource_claims", ())),
        )],
        node_selector=dict(d.get("node_selector", {})),
        tolerations=[
            o.Toleration(key=k, operator=op, value=v, effect=e)
            for k, op, v, e in d.get("tolerations", ())
        ],
        topology_spread_constraints=[
            o.TopologySpreadConstraint(
                max_skew=t[1], topology_key=t[0], when_unsatisfiable=t[2],
                label_selector=_selector(api, t[3]),
                min_domains=t[4] if len(t) > 4 else None,
            )
            for t in d.get("spread", ())
        ],
        priority=int(d.get("priority", 0)),
        priority_class_name=d.get("priority_class", ""),
        node_name=d.get("node_name", ""),
        volumes=[o.PodVolume(name="data", pvc_name=d["pvc"])] if d.get("pvc") else [],
    )
    node_aff = None
    if d.get("preferred_zones") or d.get("required_zones"):
        node_aff = o.NodeAffinity(
            required=(
                (o.NodeSelectorTerm(match_expressions=(
                    o.NodeSelectorRequirement(
                        TOPOLOGY_ZONE_LABEL, "In", tuple(d["required_zones"])),
                )),) if d.get("required_zones") else ()
            ),
            preferred=tuple(
                o.PreferredSchedulingTerm(
                    weight=w,
                    preference=o.NodeSelectorTerm(match_expressions=(
                        o.NodeSelectorRequirement(
                            TOPOLOGY_ZONE_LABEL, "In", (zone,)),
                    )),
                )
                for w, zone in d.get("preferred_zones", ())
            ),
        )
    anti = tuple(
        o.PodAffinityTerm(label_selector=_selector(api, sel), topology_key=key)
        for key, sel in d.get("anti", ())
    )
    aff = tuple(
        o.PodAffinityTerm(label_selector=_selector(api, sel), topology_key=key)
        for key, sel in d.get("affinity", ())
    )
    if node_aff is not None or anti or aff:
        spec.affinity = o.Affinity(
            node_affinity=node_aff,
            pod_affinity=o.PodAffinity(required=aff) if aff else None,
            pod_anti_affinity=o.PodAffinity(required=anti) if anti else None,
        )
    name = d["name"]
    refs = [o.OwnerReference(kind="ReplicaSet", name=f"{name}-owner",
                             uid=f"uid-{name}-owner", controller=True)]
    pod = o.Pod(
        metadata=o.ObjectMeta(
            name=name, uid=f"uid-{name}", labels=dict(d.get("labels", {})),
            owner_references=refs, creation_timestamp=ts,
        ),
        spec=spec,
    )
    if pod.spec.node_name:
        pod.status.phase = "Running"
    return pod


def case_pool(api, d: dict):
    o, np_, nc = api.objects, api.nodepool, api.nodeclaim
    pool = np_.NodePool(metadata=o.ObjectMeta(
        name=d["name"], namespace="", uid=f"uid-pool-{d['name']}",
        creation_timestamp=CASE_T0))
    pool.spec.weight = int(d.get("weight", 0))
    pool.spec.limits = dict(d.get("limits", {}))
    pool.spec.template.labels = dict(d.get("labels", {}))
    pool.spec.template.spec.taints = [
        o.Taint(key=k, value=v, effect=e) for k, v, e in d.get("taints", ())
    ]
    pool.spec.template.spec.requirements = [
        nc.RequirementSpec(key=k, operator=op, values=tuple(vals), min_values=mv)
        for k, op, vals, mv in d.get("requirements", ())
    ]
    return pool


def case_daemonset(api, d: dict, ts: float = CASE_T0):
    """A DaemonSet whose pod template is `case_pod`'s pod for `d`."""
    o = api.objects
    tmpl = case_pod(api, dict(d, name=f"{d['name']}-tmpl"), ts)
    return o.DaemonSet(
        metadata=o.ObjectMeta(name=d["name"], uid=f"uid-ds-{d['name']}",
                              creation_timestamp=ts),
        spec=o.DaemonSetSpec(
            selector=_selector(api, {"ds": d["name"]}),
            template=o.PodTemplateSpec(
                metadata=o.ObjectMeta(labels={"ds": d["name"]},
                                      creation_timestamp=ts),
                spec=tmpl.spec),
        ))


def case_objects(case: ProvisionCase, api) -> dict:
    """The objects of one case, built with `api`'s constructors, in
    the order `build_env` creates them: priority classes, storage
    (PVs, PVCs), pools, daemonsets, existing claims and nodes, their
    bound pods, then the pending pods. Every uid and creation timestamp
    is fixed by the case."""
    o, lb, nc = api.objects, api.labels, api.nodeclaim
    types = case_types(case, api)
    out = {"types": types, "first": [], "pending": [], "extra": []}
    first = out["first"]
    for name, value in case.priority_classes:
        first.append(o.PriorityClass(
            metadata=o.ObjectMeta(name=name, namespace="", uid=f"uid-pc-{name}",
                                  creation_timestamp=CASE_T0),
            value=int(value)))
    for name, zones in case.volumes:
        first.append(o.PersistentVolume(
            metadata=o.ObjectMeta(name=f"pv-{name}", namespace="",
                                  uid=f"uid-pv-{name}", creation_timestamp=CASE_T0),
            zones=list(zones)))
        pvc = o.PersistentVolumeClaim(metadata=o.ObjectMeta(
            name=name, uid=f"uid-pvc-{name}", creation_timestamp=CASE_T0))
        pvc.spec.volume_name = f"pv-{name}"
        pvc.phase = "Bound"
        first.append(pvc)
    for d in case.pools:
        first.append(case_pool(api, d))
    for d in case.daemonsets:
        first.append(case_daemonset(api, d))
    by_name = {it.name: it for it in types}
    for k, d in enumerate(case.nodes):
        it = types[d["type"]] if isinstance(d["type"], int) else by_name[d["type"]]
        labels = {
            lb.NODEPOOL_LABEL: d["pool"],
            INSTANCE_TYPE_LABEL: it.name,
            TOPOLOGY_ZONE_LABEL: d["zone"],
            CAPACITY_TYPE_LABEL: d.get("capacity_type", "on-demand"),
            ARCH_LABEL: it.requirements.get(ARCH_LABEL).any_value(),
            OS_LABEL: it.requirements.get(OS_LABEL).any_value(),
            lb.HOSTNAME_LABEL: d["name"],
        }
        pid = f"fake://{it.name}/existing-{k}"
        claim = nc.NodeClaim(
            metadata=o.ObjectMeta(name=f"existing-{k}", namespace="",
                                  uid=f"uid-claim-existing-{k}",
                                  labels={lb.NODEPOOL_LABEL: d["pool"]},
                                  creation_timestamp=CASE_T0),
        )
        if d.get("finalizer"):
            # deleted as a launched claim is: through its finalizer
            claim.metadata.finalizers = [lb.TERMINATION_FINALIZER]
        claim.status.provider_id = pid
        claim.status.node_name = d["name"]
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable)
        for cond in nc.LIFECYCLE_ROOT_CONDITIONS:
            claim.status_conditions.set_true(cond, now=CASE_T0)
        node = o.Node(
            metadata=o.ObjectMeta(name=d["name"], namespace="",
                                  uid=f"uid-node-{d['name']}", labels=labels,
                                  creation_timestamp=CASE_T0),
            spec=o.NodeSpec(provider_id=pid),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(it.allocatable)),
        )
        first.extend([claim, node])
        for i, pd in enumerate(d.get("pods", ())):
            first.append(case_pod(api, dict(pd, node_name=d["name"]),
                                      CASE_T0 + i))
    for i, d in enumerate(case.pods):
        out["pending"].append(case_pod(api, d, CASE_T0 + 1 + i))
    for i, d in enumerate(case.extra_pods):
        out["extra"].append(
            case_pod(api, d, CASE_T0 + 1 + len(case.pods) + i))
    return out


def _env(api, cloud, objects, options, t0: float, kube=None,
         **provisioner_kwargs):
    """`api`'s KubeClient (or `kube`), Cluster (informers attached) and
    Provisioner over `cloud`, with `objects` created in order and a
    clock that never moves, so the Scheduler's solve bound never fires."""
    from types import SimpleNamespace

    kube = kube if kube is not None else api.client.KubeClient()
    cluster = api.cluster.Cluster(kube)
    api.cluster.attach_informers(kube, cluster)
    for obj in objects:
        kube.create(obj)
    prov = api.provisioner.Provisioner(
        kube, cluster, cloud, options=options, clock=lambda: t0,
        **provisioner_kwargs,
    )
    return SimpleNamespace(kube=kube, cluster=cluster, cloud=cloud,
                           provisioner=prov, api=api)


def build_env(case: ProvisionCase, api, **provisioner_kwargs):
    """`api`'s in-memory API, cluster mirror, FakeCloudProvider and
    Provisioner for one case (`_env`), with the case's objects created,
    the pending pods included."""
    objs = case_objects(case, api)
    env = _env(api, api.fake.FakeCloudProvider(objs["types"]),
               objs["first"] + objs["pending"],
               api.options.Options(min_values_policy=case.min_values_policy), CASE_T0,
               **provisioner_kwargs)
    env.objects = objs
    return env


def provision_env(case: ProvisionCase, device, **provisioner_kwargs):
    """This package's round for `case` on `device` (see `build_env`)."""
    return build_env(case, package_api(), device=device, **provisioner_kwargs)


def pods_env(pods, pools_with_types, api=None, t0: float = CASE_T0,
             **provisioner_kwargs):
    """`api`'s (default this package's) in-memory API, cluster mirror,
    FakeCloudProvider (each pool served its own catalog) and Provisioner
    over `pools_with_types` (`_env`), with every pool created and then
    `pods` created pending at t0. This package's Provisioner takes
    `device=`."""
    api = api or package_api()
    catalogs = {pool.metadata.name: types for pool, types in pools_with_types}
    cloud = api.fake.FakeCloudProvider(pools_with_types[0][1])
    cloud.instance_types_hook = lambda pool: list(catalogs[pool.metadata.name])
    for pod in pods:
        pod.metadata.creation_timestamp = t0
    return _env(api, cloud, [pool for pool, _ in pools_with_types] + list(pods),
                api.options.Options(), t0, **provisioner_kwargs)


def launch(env, now: float) -> None:
    """What the lifecycle controller does between two provisioning
    rounds: every claim not yet launched (no provider id) is launched
    through `env.api`'s package's `NodeClaimLifecycle` (the provider's
    `create` resolves its type and offering and writes its provider id,
    capacity, allocatable and labels). No node registers here, so the
    claims stay in flight until `settle` registers them."""
    import importlib

    package = env.api.provisioner.__name__.split(".")[0]
    lifecycle = importlib.import_module(f"{package}.lifecycle.nodeclaim_lifecycle")
    controller = lifecycle.NodeClaimLifecycle(env.kube, env.cloud)
    for claim in list(env.kube.node_claims()):
        if not claim.status.provider_id and claim.metadata.deletion_timestamp is None:
            controller.reconcile(claim, now)


def reconcile_rounds(env, waves, t0: float = CASE_T0, on_round=None) -> dict:
    """`reconcile` at t0 + 5 over the pending pods, then, for each wave
    k of `waves` (lists of pods), the last round's claims launched
    through the lifecycle controller (`launch`, at t0 + 10k), the wave
    created at t0 + 10k and `reconcile` at t0 + 10k + 5: the pods of
    earlier rounds are still pending, and land again on the in-flight
    claims. Returns each round's results, the
    claims each created, and each round's name-insensitive fingerprint
    with in-flight claims named by creation order (`claim_names`).
    `on_round(results)` runs after each reconcile."""
    rounds, created, fps = [], [], []
    for k in range(len(waves) + 1):
        if k:
            launch(env, t0 + 10 * k)
        for pod in waves[k - 1] if k else ():
            pod.metadata.creation_timestamp = t0 + 10 * k
            env.kube.create(pod)
        results = env.provisioner.reconcile(now=t0 + 10 * k + 5)
        if on_round is not None:
            on_round(results)
        rounds.append(results)
        created.append([env.kube.get_node_claim(p.claim_name)
                        for p in results.new_node_plans if p.claim_name])
        names = claim_names([c for cs in created for c in cs])
        fps.append(decision_fingerprint(results, names))
    return {"results": rounds, "claims": created, "fingerprints": fps}


# -- event streams: rounds of a live cluster, for the incremental tick ------
#
# `run_stream` drives one environment (either package's, `build_env` /
# `pods_env`) through a list of `StreamRound`s: between two reconciles
# the last round's claims launch (`launch`) and, unless the
# round says otherwise, register as nodes with the round's pods bound to
# them (`settle`); then pods are deleted and created, a DaemonSet
# appears or a watch drops, as the round says. Everything is named by
# creation order or by the round, so the same stream decides alike in
# both packages.


@dataclass
class StreamRound:
    """What happens before one round's `reconcile`, in this order:
    `settle` registers the claims in flight as nodes and binds the last
    round's pods (else the last round's claims only launch, in flight);
    `relist` drops those kinds' watches (a 410: `RelistingKubeClient`);
    `daemonset` (`case_daemonset`'s dict) is created; `delete` of the
    bound pods are deleted (a share, or a count when >= 1), chosen by
    `pick` ("name": the first by name; "seeded": `seed`'s draw), and
    with `respawn` as many pods of their shapes are created; then the
    `add` pods (`case_pod` dicts) and the `pods` (pod objects of the
    environment's package) arrive. A `micro` round hands its arrivals
    to `Provisioner.micro_solve` instead of `reconcile` (its results
    are None when the tick defers the batch)."""

    settle: bool = True
    relist: tuple = ()
    daemonset: Optional[dict] = None
    delete: float = 0.0
    respawn: bool = False
    pick: str = "name"
    seed: int = 0
    add: list = field(default_factory=list)
    pods: list = field(default_factory=list)
    micro: bool = False


def relisting_client(api):
    """`api`'s in-memory KubeClient whose watches can drop:
    `drop_watch(*kinds)` is a 410 on those kinds' streams. Their relist
    generation advances (`relist_generation`, the signal
    `DirtyTracker.relisted` latches, which the incremental tick reads
    as "everything dirty"); no per-shard generations, so the relist is
    unscoped."""

    class RelistingKubeClient(api.client.KubeClient):
        def relist_generation(self, kind: str) -> int:
            return self.relists.get(kind, 0)

        def drop_watch(self, *kinds: str) -> None:
            for kind in kinds:
                self.relists[kind] = self.relists.get(kind, 0) + 1

    kube = RelistingKubeClient()
    kube.relists = {}
    return kube


def reset_counters(api) -> None:
    """Restart `api`'s process-wide claim-name and uid counters: the
    incremental tick's poison site corrupts the retained row with the
    least key, and the keys of claims in flight are claim names."""
    import itertools

    api.provisioner._claim_counter = itertools.count(1)
    api.objects._uid_counter = itertools.count(1)


def settle(env, plans: dict, results, t: float,
           names: Optional[dict] = None) -> None:
    """What the provider, the lifecycle controller and kube-scheduler
    write back after a round: every claim launched and not yet
    registered becomes a node (`node-<claim-i>`, `claim_names` order
    over `plans`: claim name -> the plan that made it; or, with
    `names`, the name it holds there, new claims numbered on in the
    order of `plans`, so that a deleted claim shifts no name), with the
    labels of its plan's cheapest option, the claim's taints and the
    lifecycle conditions; then `results`' pods bind: a new plan's to
    its claim's node, an existing assignment's to the node its key
    names (an in-flight claim's node once registered)."""
    api = env.api
    o, lb, nc = api.objects, api.labels, api.nodeclaim
    if names is None:
        names = claim_names([env.kube.get_node_claim(n) for n in plans
                             if env.kube.get_node_claim(n) is not None])
    else:
        for n in plans:
            names.setdefault(n, f"claim-{len(names)}")
    for claim in list(env.kube.node_claims()):
        name = claim.metadata.name
        if (claim.status.node_name or not claim.status.provider_id
                or name not in plans or claim.metadata.deletion_timestamp):
            continue
        it, off = plans[name].primary()
        node_name = f"node-{names[name]}"
        labels = dict(claim.metadata.labels)
        labels.update({
            INSTANCE_TYPE_LABEL: it.name,
            TOPOLOGY_ZONE_LABEL: off.zone,
            CAPACITY_TYPE_LABEL: off.capacity_type,
            ARCH_LABEL: it.requirements.get(ARCH_LABEL).any_value(),
            OS_LABEL: it.requirements.get(OS_LABEL).any_value(),
            lb.HOSTNAME_LABEL: node_name,
        })
        if off.reservation_id:
            labels[lb.RESERVATION_ID_LABEL] = off.reservation_id
        claim.status.node_name = node_name
        for cond in nc.LIFECYCLE_ROOT_CONDITIONS:
            claim.status_conditions.set_true(cond, now=t)
        env.kube.update(claim)
        env.kube.create(o.Node(
            metadata=o.ObjectMeta(name=node_name, namespace="",
                                  uid=f"uid-{node_name}", labels=labels,
                                  creation_timestamp=t),
            spec=o.NodeSpec(provider_id=claim.status.provider_id,
                            taints=list(claim.spec.taints)),
            status=o.NodeStatus(capacity=dict(claim.status.capacity),
                                allocatable=dict(claim.status.allocatable)),
        ))

    def bind(pods, target: str) -> None:
        for pod in pods:
            live = env.kube.get_pod(pod.metadata.namespace, pod.metadata.name)
            if live is not None and not live.spec.node_name:
                env.kube.bind_pod(live, target)

    for plan in results.new_node_plans:
        claim = env.kube.get_node_claim(plan.claim_name) if plan.claim_name else None
        if claim is not None and claim.status.node_name:
            bind(plan.pods, claim.status.node_name)
    for key, pods in results.existing_assignments.items():
        claim = env.kube.get_node_claim(key)
        target = claim.status.node_name if claim is not None else key
        if target and env.kube.get_node(target) is not None:
            bind(pods, target)


def _stream_deletions(env, rnd: StreamRound) -> list:
    bound = sorted((p for p in env.kube.pods() if p.spec.node_name),
                   key=lambda p: p.metadata.name)
    if not bound or not rnd.delete:
        return []
    n = int(rnd.delete) if rnd.delete >= 1 else max(1, int(len(bound) * rnd.delete))
    n = min(n, len(bound))
    if rnd.pick == "seeded":
        rng = np.random.default_rng(rnd.seed)
        return [bound[i] for i in sorted(rng.choice(len(bound), size=n, replace=False))]
    return bound[:n]


def _respawn(api, pod, name: str, t: float):
    """A pending pod of `pod`'s shape: its spec, unbound."""
    import copy

    o = api.objects
    spec = copy.deepcopy(pod.spec)
    spec.node_name = ""
    return o.Pod(metadata=o.ObjectMeta(
        name=name, uid=f"uid-{name}", labels=dict(pod.metadata.labels),
        owner_references=list(pod.metadata.owner_references),
        creation_timestamp=t), spec=spec)


def tick_routes(api, before: dict) -> list:
    """The (path, reason) pairs the incremental tick counted since the
    `INCREMENTAL_TICK` samples `before` (empty when the tick is off)."""
    now = dict(api.store.INCREMENTAL_TICK.samples())
    return sorted(
        (dict(k)["path"], dict(k)["reason"])
        for k, v in now.items() if v > before.get(k, 0.0)
    )


def run_stream(env, rounds, t0: float = CASE_T0, on_round=None,
               resume: Optional[dict] = None) -> dict:
    """Round k of `rounds` (`StreamRound`) at t0 + 10k: its events,
    then `reconcile(now=t0 + 10k + 5)`. Returns each round's results,
    its name-insensitive fingerprint (claims named by creation order,
    `claim_names`), its route (`tick_routes`), the claims it created,
    and what the stream deleted and created. `on_round(k, results)`
    runs after each reconcile. `resume` (an earlier return of this
    function on `env`) continues that stream: its rounds keep counting
    and its results are extended."""
    api = env.api
    out = resume if resume is not None else {
        "results": [], "fingerprints": [], "routes": [], "claims": [],
        "deleted": [], "respawned": [], "_plans": {}, "_created": []}
    plans, created = out["_plans"], out["_created"]
    start = len(out["results"])
    for k, rnd in enumerate(rounds, start):
        t = t0 + 10 * k
        prev = next((r for r in reversed(out["results"]) if r is not None), None)
        if prev is not None:
            launch(env, t)
            if rnd.settle:
                settle(env, plans, prev, t)
        if rnd.relist:
            env.kube.drop_watch(*rnd.relist)
        if rnd.daemonset is not None:
            env.kube.create(case_daemonset(api, rnd.daemonset, t))
        gone = _stream_deletions(env, rnd)
        for pod in gone:
            env.kube.delete(pod, now=t)
        born = [_respawn(api, pod, f"{pod.metadata.name}-r{k}", t)
                for pod in gone] if rnd.respawn else []
        arrivals = born + [case_pod(api, d, t + 1 + i) for i, d in enumerate(rnd.add)]
        for pod in rnd.pods:
            pod.metadata.creation_timestamp = t
        arrivals += list(rnd.pods)
        for pod in arrivals:
            env.kube.create(pod)
        before = dict(api.store.INCREMENTAL_TICK.samples())
        if rnd.micro:
            results = env.provisioner.micro_solve(arrivals, now=t + 5)
        else:
            results = env.provisioner.reconcile(now=t + 5)
        if on_round is not None:
            on_round(k, results)
        out["routes"].append(tick_routes(api, before))
        new = []
        for plan in results.new_node_plans if results is not None else ():
            if plan.claim_name:
                plans[plan.claim_name] = plan
                new.append(env.kube.get_node_claim(plan.claim_name))
        created.extend(new)
        out["results"].append(results)
        out["claims"].append(new)
        out["deleted"].append([p.key for p in gone])
        out["respawned"].append([p.key for p in born])
        out["fingerprints"].append(
            None if results is None
            else decision_fingerprint(results, claim_names(created)))
    return out


# -- disruption: the consolidation engine over a live cluster ----------------
#
# `disruption_env` adds the engine (`DisruptionEngine` with its
# `OrchestrationQueue`) and the conditions controllers to an environment
# of `_env`; `disruption_round` runs one cycle of them and
# `disruption_rounds` repeats it until a round decides nothing.
# Everything is named by creation order or by the case, so one stream
# decides alike in both packages; `command_identity` compares commands
# without names. A stream starts at DISRUPTION_T0.


# a disruption stream's start: pod bind times are wall clock, so every
# round's `now` must lie ahead of them; and the Provisioner reprices spot
# offerings on a curve of `now`, so one fixed start (2100-01-01 UTC)
# makes a stream decide alike from run to run, in both packages
DISRUPTION_T0 = 4_102_444_800.0


def disruption_env(env, options=None, seed: int = 0, **engine_kwargs):
    """Attach `env.api`'s disruption half to an environment of `_env`
    (`build_env`, `pods_env`): an `EventRecorder` (`recorder`), the
    conditions controllers (`conditions`, `expiration`, `pod_events`)
    and the `DisruptionEngine` (`disruption`, its queue
    `disruption.queue`) over the Provisioner's fixed clock, so that no
    method's deadline fires. `options`: the JAX package's test
    `Environment`'s (SpotToSpotConsolidation on) unless given. This
    package's engine takes `device=` (default: the Provisioner's)."""
    api = env.api
    if options is None:
        options = api.options.Options(feature_gates=api.options.FeatureGates(
            spot_to_spot_consolidation=True))
    env.options = options
    env.recorder = api.recorder.EventRecorder()
    env.conditions = api.conditions.DisruptionConditionsController(
        env.kube, env.cluster, env.cloud)
    env.expiration = api.conditions.ExpirationController(env.kube)
    env.pod_events = api.conditions.PodEventsController(env.kube, env.cluster)
    env.disruption = api.engine.DisruptionEngine(
        env.kube, env.cluster, env.cloud, env.provisioner, seed=seed,
        options=options, clock=env.provisioner.clock, recorder=env.recorder,
        **engine_kwargs)
    # claim name -> the plan that made it, and the claims' node names
    # (`settle(..., names=)`), over the whole stream
    env.plans, env.names = {}, {}
    return env


def place(env, now: float):
    """A provisioning round at `now` over the pending pods, its claims
    launched and registered as nodes and its pods bound (`settle` with
    the stream's stable names). Returns its results."""
    results = env.provisioner.reconcile(now=now)
    register(env, results, now)
    return results


def register(env, results, now: float) -> None:
    """`results`' claims launched through the lifecycle controller
    (`launch`) and registered as nodes, and its pods bound (`settle`)."""
    if results is None:
        return
    launch(env, now)
    for plan in results.new_node_plans:
        if plan.claim_name:
            env.plans[plan.claim_name] = plan
    settle(env, env.plans, results, now, names=env.names)


def _reborn(api, pod, now: float):
    """A controller-owned pod's successor after its eviction: its name,
    labels, annotations, owners and spec, unbound."""
    import copy

    o = api.objects
    spec = copy.deepcopy(pod.spec)
    spec.node_name = ""
    return o.Pod(metadata=o.ObjectMeta(
        name=pod.metadata.name, namespace=pod.metadata.namespace,
        uid=f"{pod.metadata.uid}+", labels=dict(pod.metadata.labels),
        annotations=dict(pod.metadata.annotations),
        owner_references=list(pod.metadata.owner_references),
        creation_timestamp=now), spec=spec)


def terminate(env, now: float) -> list:
    """What the termination controller writes back once the queue has
    deleted candidates' claims: for each claim with a deletion
    timestamp, in name order, its node's pods are evicted through
    `KubeClient.evict` (the store's PDB check binds: a blocked pod
    stays, and so do its node and claim), each evicted pod with a
    controller owner is reborn pending under its name (its workload's
    replica), then the node's daemonset and mirror pods and the node go
    and the claim's finalizers are removed. Returns the keys of the pods
    an eviction refused."""
    api = env.api
    kube = env.kube
    blocked = []
    claims = sorted((c for c in kube.node_claims()
                     if c.metadata.deletion_timestamp is not None),
                    key=lambda c: c.metadata.name)
    for claim in claims:
        node = kube.get_node(claim.status.node_name) if claim.status.node_name else None
        held = []
        for pod in sorted(kube.pods_on_node(node.metadata.name) if node else (),
                          key=lambda p: p.key):
            owner = pod.owner_kind()
            if pod.is_terminal() or owner in ("DaemonSet", "Node"):
                continue
            try:
                kube.evict(pod, now=now)
            except api.client.EvictionBlockedError:
                held.append(pod.key)
                continue
            if owner and kube.get_pod(pod.metadata.namespace, pod.metadata.name) is None:
                kube.create(_reborn(api, pod, now))
        if held:
            blocked += held
            continue
        if node is not None:
            for pod in list(kube.pods_on_node(node.metadata.name)):
                kube.delete(pod, now=now)
            for fin in list(node.metadata.finalizers):
                kube.remove_finalizer(node, fin)
            kube.delete(node, now=now)
        for fin in list(claim.metadata.finalizers):
            kube.remove_finalizer(claim, fin)
    return blocked


def disruption_round(env, now: float) -> dict:
    """One disruption cycle at `now`: the pod-events and conditions
    controllers, `DisruptionEngine.reconcile`, the command's
    replacements launched and registered (`register`), the queue's
    `reconcile` at now + 20 (past the validation TTL, so a consolidation
    command is simulated again), `terminate`, and a provisioning round
    at now + 25 that places the pods the drain displaced (`place`).
    Returns the command, its name-insensitive identity
    (`command_identity`), the pods an eviction refused, the queue's
    commands still in flight and the placement's results."""
    env.pod_events.reconcile_all(now=now)
    env.conditions.reconcile_all(now=now)
    command = env.disruption.reconcile(now=now)
    ident = command_identity(command)
    if command is not None:
        register(env, command.results, now)
    env.disruption.queue.reconcile(now=now + 20)
    blocked = terminate(env, now + 20)
    placed = place(env, now + 25) if env.provisioner.get_pending_pods() else None
    return {"command": command, "identity": ident, "blocked": blocked,
            "active": len(env.disruption.queue.active), "placed": placed}


def disruption_rounds(env, t0: float, max_rounds: int = 12,
                      on_round=None) -> list:
    """`disruption_round` at t0 + 100k, k = 0, 1, ..., until a round
    decides nothing, a round repeats the last round's command and
    leaves the fleet as it found it (the command rolled back and will
    be decided again: a fixed point, `stalled`), or `max_rounds` have
    run. Returns the rounds' `disruption_round` dicts, each with the
    fleet after it (`fleet_state`) and `stalled`. `on_round(k, round)`
    runs after each."""
    out = []
    before = fleet_state(env)
    for k in range(max_rounds):
        rnd = disruption_round(env, t0 + 100 * k)
        rnd["fleet"] = fleet_state(env)
        rnd["stalled"] = bool(
            out and rnd["command"] is not None
            and rnd["identity"] == out[-1]["identity"]
            and rnd["fleet"] == before)
        out.append(rnd)
        before = rnd["fleet"]
        if on_round is not None:
            on_round(k, rnd)
        if rnd["command"] is None or rnd["stalled"]:
            break
    return out


def command_identity(cmd) -> Optional[tuple]:
    """A command without names (as the JAX package's oracle tests
    compare them): its reason, its candidates' node names, and per
    replacement plan its pool, price to 1e-6, pod keys and type
    names."""
    if cmd is None:
        return None
    plans = []
    if cmd.results is not None:
        plans = sorted(
            (plan.pool.metadata.name, round(float(plan.price), 6),
             tuple(sorted(p.key for p in plan.pods)),
             tuple(sorted(it.name for it in plan.instance_types)))
            for plan in cmd.results.new_node_plans)
    return (cmd.reason, tuple(sorted(c.state_node.name for c in cmd.candidates)),
            tuple(plans))


def fleet_state(env) -> tuple:
    """The fleet as plain values: per node (name order) its instance
    type, zone, capacity type and bound pods; the pending pods; the
    fleet's price an hour (each node's offering in the Provisioner's
    catalog)."""
    prices = {}
    for pool, types in env.provisioner.ready_pools_with_types():
        for it in types:
            for off in it.offerings:
                prices[(pool.metadata.name, it.name, off.zone, off.capacity_type)] = off.price
    nodes, total = [], 0.0
    for node in sorted(env.kube.nodes(), key=lambda n: n.metadata.name):
        lb = node.metadata.labels
        key = (lb.get(NODEPOOL_LABEL, ""), lb.get(INSTANCE_TYPE_LABEL, ""),
               lb.get(TOPOLOGY_ZONE_LABEL, ""), lb.get(CAPACITY_TYPE_LABEL, ""))
        total += prices.get(key, 0.0)
        nodes.append(key[1:] + (tuple(sorted(
            p.key for p in env.kube.pods_on_node(node.metadata.name))),))
    pending = tuple(sorted(p.key for p in env.kube.pods() if not p.spec.node_name))
    return tuple(nodes), pending, round(total, 6)


def decision_fingerprint(results, names: Optional[dict] = None) -> tuple:
    """Name-insensitive identity of one scheduling decision (the JAX
    package's `incremental_tick.decision_fingerprint`): new plans by
    (pool, launch target, price, pod set), existing assignments by
    (state key, pod set), failures by (pod key, reason). `names` maps
    the state keys of in-flight claims (process-wide counter names) to
    names fixed by their creation order (`claim_names`)."""
    names = names or {}
    new = []
    for plan in results.new_node_plans:
        it, off = plan.primary()
        new.append((
            plan.pool.metadata.name if plan.pool is not None else "",
            it.name if it is not None else "",
            (off.zone, off.capacity_type) if off is not None else ("", ""),
            round(float(plan.price), 6),
            tuple(sorted(p.key for p in plan.pods)),
        ))
    existing = sorted(
        (names.get(key, key), tuple(sorted(p.key for p in pods)))
        for key, pods in results.existing_assignments.items()
    )
    return (
        tuple(sorted(new)),
        tuple(existing),
        tuple(sorted(results.errors.items())),
    )


def claim_names(claims) -> dict:
    """Claim name -> `claim-<i>`, i its place in creation order."""
    return {c.metadata.name: f"claim-{i}" for i, c in enumerate(claims)}


def claim_contents(claims) -> list:
    """The created claims without their names: pool, requirement
    specs, labels, taints, requested resources, expected capacity and
    annotations, in creation order."""
    out = []
    for c in claims:
        out.append((
            c.metadata.labels.get(NODEPOOL_LABEL, ""),
            tuple((r.key, r.operator, tuple(r.values), r.min_values)
                  for r in c.spec.requirements),
            tuple(sorted(c.metadata.labels.items())),
            tuple((t.key, t.value, t.effect) for t in c.spec.taints),
            tuple(sorted(c.spec.resources.items())),
            tuple(sorted(c.status.capacity.items())),
            tuple(sorted(c.metadata.annotations.items())),
        ))
    return out


def mirror_state(cluster, names: Optional[dict] = None) -> list:
    """The cluster mirror as plain values, in its own order: per
    state node its name (claim names mapped through `names`), claim,
    provider id, lifecycle flags, pods, usage and available capacity;
    then the per-pool resources."""
    names = names or {}
    nodes = []
    for n in cluster.nodes():
        claim = n.node_claim.metadata.name if n.node_claim is not None else ""
        nodes.append((
            n.name, names.get(claim, claim),
            n.provider_id, n.initialized(), n.registered(), n.deleting(),
            tuple(sorted(n.pod_keys)),
            tuple(sorted(n.pod_usage.items())),
            tuple(sorted(n.daemon_usage.items())),
            tuple(sorted(n.available().items())),
        ))
    pools = sorted(
        (k, tuple(sorted(v.items())))
        for k, v in cluster.nodepool_resources().items()
    )
    return [nodes, pools, cluster.synced()]


def _pod(name, cpu=1.0, mem=1.0, **kw) -> dict:
    return dict(name=name, cpu=cpu, mem=mem, **kw)


def provision_cases(seed: int = 0) -> list[ProvisionCase]:
    """The seeded rounds the tests hold both packages' Provisioners
    and Schedulers to: plain (with existing nodes, bound pods and a
    daemonset), a tainted pool with tolerations, node selectors, zonal
    spread with hostname anti-affinity, host ports, a PVC zone,
    minValues Strict and BestEffort, a reserved offering, mixed
    priorities that hit a pool limit, and a preferred affinity that
    must relax. Each has a second round's arrivals in `extra_pods`."""
    rng = np.random.default_rng(seed)
    shapes = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0),
              (1.0, 0.5), (0.5, 4.0)]

    def shaped(prefix, n, **kw):
        out = []
        for i in range(n):
            cpu, mem = shapes[int(rng.integers(len(shapes)))]
            out.append(_pod(f"{prefix}{i}", cpu, mem, **kw))
        return out

    default = dict(name="default")
    cases = []

    plain = ProvisionCase(
        "plain", pods=shaped("p-", 60), pools=[default],
        nodes=[
            dict(name="node-a", type=20, pool="default", zone="test-zone-1",
                 pods=shaped("bound-a-", 3)),
            dict(name="node-b", type=26, pool="default", zone="test-zone-2",
                 capacity_type="spot", pods=shaped("bound-b-", 2)),
        ],
        daemonsets=[dict(name="logger", cpu=0.1, mem=0.125)],
        extra_pods=shaped("q-", 20),
    )
    cases.append(plain)

    tainted = dict(name="tainted", weight=50,
                   taints=[("dedicated", "batch", "NoSchedule")])
    tol = [("dedicated", "Equal", "batch", "NoSchedule")]
    pods = shaped("t-", 50)
    for i, d in enumerate(pods):
        if i % 5 == 0:
            d["tolerations"] = tol
    cases.append(ProvisionCase(
        "tainted-pool", pods=pods, pools=[default, tainted],
        extra_pods=shaped("u-", 10, tolerations=tol)))

    pods = shaped("s-", 50)
    for i, d in enumerate(pods):
        sel = {}
        if i % 3 == 0:
            sel["kubernetes.io/arch"] = ("amd64", "arm64")[int(rng.integers(2))]
        if i % 4 == 0:
            sel[TOPOLOGY_ZONE_LABEL] = ZONES[int(rng.integers(3))]
        if i % 7 == 0:
            sel["kubernetes.io/os"] = "linux"
        d["node_selector"] = sel
    cases.append(ProvisionCase(
        "node-selectors", pods=pods, pools=[default],
        extra_pods=shaped("sx-", 10, node_selector={TOPOLOGY_ZONE_LABEL: "test-zone-3"})))

    pods = []
    for i in range(60):
        app = f"svc-{i % 4}"
        d = _pod(f"z-{i}", 1.0, 2.0, labels={"app": app},
                 spread=[(TOPOLOGY_ZONE_LABEL, 1, "DoNotSchedule", {"app": app})])
        if i % 10 == 0:
            d["anti"] = [("kubernetes.io/hostname", {"app": app})]
        pods.append(d)
    pods += shaped("zp-", 20)
    cases.append(ProvisionCase(
        "spread-anti", pods=pods, pools=[default],
        nodes=[dict(name="node-z", type=24, pool="default", zone="test-zone-2",
                    pods=[_pod("zb-0", 1.0, 2.0, labels={"app": "svc-0"})])],
        extra_pods=[_pod(f"zx-{i}", 1.0, 2.0, labels={"app": "svc-1"},
                         spread=[(TOPOLOGY_ZONE_LABEL, 1, "DoNotSchedule",
                                  {"app": "svc-1"})]) for i in range(9)]))

    pods = shaped("h-", 30)
    for i in range(12):
        pods.append(_pod(f"hp-{i}", 0.5, 1.0, host_ports=[8080 + (i % 2)]))
    cases.append(ProvisionCase(
        "host-ports", pods=pods, pools=[default],
        extra_pods=[_pod(f"hq-{i}", 0.5, 1.0, host_ports=[8080]) for i in range(4)]))

    pods = shaped("v-", 20)
    for i in range(6):
        pods.append(_pod(f"vp-{i}", 1.0, 2.0, pvc=f"claim-{i % 2}"))
    cases.append(ProvisionCase(
        "pvc-zone", pods=pods, pools=[default],
        volumes=(("claim-0", ("test-zone-2",)), ("claim-1", ("test-zone-3",))),
        extra_pods=[_pod("vx-0", 1.0, 2.0, pvc="claim-1")]))

    mv_pool = dict(name="default", requirements=[
        (INSTANCE_TYPE_LABEL, "Exists", (), 3)])
    mv_pods = shaped("m-", 30) + [_pod("m-big-0", 40.0, 60.0),
                                  _pod("m-big-1", 90.0, 300.0)]
    for policy in ("Strict", "BestEffort"):
        cases.append(ProvisionCase(
            f"min-values-{policy.lower()}", pods=[dict(d) for d in mv_pods],
            pools=[mv_pool], min_values_policy=policy,
            extra_pods=[_pod("mx-big", 60.0, 400.0)] + shaped("mx-", 5)))

    pods = shaped("r-", 40)
    cases.append(ProvisionCase(
        "reserved", pods=pods, pools=[default],
        reservations=((14, "rsv-1", "test-zone-1", 2), (15, "rsv-2", "test-zone-2", 1)),
        extra_pods=shaped("rx-", 15)))

    pods = []
    for i in range(40):
        pc = ("critical", "", "batch")[i % 3]
        pods.append(_pod(f"pr-{i}", 1.0, 1.0, priority_class=pc))
    cases.append(ProvisionCase(
        "priority-limit", pods=pods,
        pools=[dict(name="default", limits={"cpu": 24.0},
                    requirements=[("size", "In", ("medium",), None)])],
        priority_classes=(("critical", 1000), ("batch", -10)),
        extra_pods=[_pod(f"prx-{i}", 1.0, 1.0, priority_class="critical")
                    for i in range(4)]))

    pods = shaped("a-", 20)
    for i in range(8):
        pods.append(_pod(f"ap-{i}", 1.0, 2.0, required_zones=("test-zone-1", "test-zone-2"),
                         preferred_zones=[(50, "test-zone-3")]))
    cases.append(ProvisionCase(
        "preferred-relax", pods=pods, pools=[default],
        extra_pods=[_pod("ax-0", 1.0, 2.0, preferred_zones=[(10, "test-zone-9")])]))
    return cases


# -- the test Environment: in-memory API, kwok cloud, every controller -------
#
# The JAX package's `testing.Environment` (`karpenter_tpu/testing.py`),
# with `device=` passed to its Provisioner and DisruptionEngine (None:
# the card, raising without one). `mk_pod` and `mk_nodepool` name their
# objects from one process-wide counter, as there.

_name_counter = itertools.count(1)


def mk_pod(
    name: Optional[str] = None,
    cpu: float = 1.0,
    memory: float = 2**30,
    labels: Optional[dict] = None,
    node_selector: Optional[dict] = None,
    owner: Optional[str] = "ReplicaSet",
    **spec_kwargs,
):
    """A pending pod requesting `cpu` and `memory`, owned by a
    controller of kind `owner` (drain rebirth only applies to
    controller-owned pods); owner=None makes a bare pod, which eviction
    terminates for good."""
    from karpenter_tpu_torch.kube.objects import (
        Container,
        ObjectMeta,
        OwnerReference,
        Pod,
        PodSpec,
    )

    name = name or f"pod-{next(_name_counter):05d}"
    refs = []
    if owner:
        refs = [OwnerReference(kind=owner, name=f"{name}-owner",
                               uid=f"uid-{name}-owner", controller=True)]
    return Pod(
        metadata=ObjectMeta(
            name=name, labels=labels or {}, owner_references=refs
        ),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": memory})],
            node_selector=node_selector or {},
            **spec_kwargs,
        ),
    )


def mk_nodepool(name: Optional[str] = None, **kwargs):
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool, NodePoolSpec
    from karpenter_tpu_torch.kube.objects import ObjectMeta

    return NodePool(
        metadata=ObjectMeta(name=name or f"pool-{next(_name_counter):05d}", namespace=""),
        spec=NodePoolSpec(**kwargs),
    )


@dataclass
class Environment:
    """One test cluster: in-memory API, cluster mirror, the kwok cloud
    provider and the controllers (lifecycle, termination, disruption
    conditions and engine, interruption, static capacity), on one
    simulated clock. `device` is the device of every solve (None: the
    card, raising without one; the tests pass "cpu"). `clock` is the
    deadline clock of the Provisioner (its solve bound) and of the
    disruption engine (its methods' time budgets); None leaves their
    monotonic default, as in the JAX package, and a fixed clock keeps
    every deadline from firing, so that a slow run decides as a fast
    one."""

    types: Optional[list] = None
    registration_delay: float = 0.0
    options: Optional[object] = None  # operator Options; the default
                                      # enables SpotToSpotConsolidation
    device: object = None
    clock: Optional[object] = None

    def __post_init__(self) -> None:
        from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
        from karpenter_tpu_torch.disruption.conditions import (
            DisruptionConditionsController,
            ExpirationController,
            PodEventsController,
        )
        from karpenter_tpu_torch.disruption.engine import DisruptionEngine
        from karpenter_tpu_torch.disruption.interruption import InterruptionController
        from karpenter_tpu_torch.events.recorder import EventRecorder
        from karpenter_tpu_torch.kube.client import KubeClient
        from karpenter_tpu_torch.lifecycle.nodeclaim_lifecycle import NodeClaimLifecycle
        from karpenter_tpu_torch.lifecycle.termination import TerminationController
        from karpenter_tpu_torch.operator.options import FeatureGates, Options
        from karpenter_tpu_torch.provisioning.provisioner import Provisioner
        from karpenter_tpu_torch.provisioning.static import StaticCapacityController
        from karpenter_tpu_torch.state.cluster import Cluster, attach_informers

        self.kube = KubeClient()
        self.cluster = Cluster(self.kube)
        attach_informers(self.kube, self.cluster)
        # one simulated clock for the whole environment: every explicit
        # `now=` advances it, and the cloud's instance timestamps use it
        # too, so that registration delays compare like with like
        self._sim_now: Optional[float] = None
        self.cloud = KwokCloudProvider(
            self.kube, types=self.types,
            registration_delay=self.registration_delay,
            clock=self._clock,
        )
        self.recorder = EventRecorder(kube=self.kube)
        self.provisioner = Provisioner(self.kube, self.cluster, self.cloud,
                                       recorder=self.recorder, device=self.device,
                                       clock=self.clock)
        self.lifecycle = NodeClaimLifecycle(self.kube, self.cloud)
        self.termination = TerminationController(self.kube, self.cluster,
                                                 recorder=self.recorder)
        self.conditions = DisruptionConditionsController(
            self.kube, self.cluster, self.cloud
        )
        self.expiration = ExpirationController(self.kube)
        self.pod_events = PodEventsController(self.kube, self.cluster)
        if self.options is None:
            self.options = Options(
                feature_gates=FeatureGates(spot_to_spot_consolidation=True)
            )
        self.disruption = DisruptionEngine(
            self.kube, self.cluster, self.cloud, self.provisioner,
            options=self.options, recorder=self.recorder, clock=self.clock,
        )
        self.interruption = InterruptionController(
            self.kube, self.cluster, self.cloud, self.disruption,
            recorder=self.recorder,
        )
        self.static = StaticCapacityController(
            self.kube, self.cluster, self.options
        )

    def _clock(self) -> float:
        return self._sim_now if self._sim_now is not None else time.time()

    def _advance(self, now: Optional[float]) -> None:
        if now is not None:
            self._sim_now = (
                now if self._sim_now is None else max(self._sim_now, now)
            )

    def reconcile_disruption(self, now: Optional[float] = None):
        """One disruption cycle: refresh conditions, run the engine,
        progress the orchestration queue and termination."""
        self._advance(now)
        self.pod_events.reconcile_all(now=now)
        self.conditions.reconcile_all(now=now)
        command = self.disruption.reconcile(now=now)
        self.lifecycle.reconcile_all(now=now)
        self.cloud.tick(now=now)
        self.lifecycle.reconcile_all(now=now)
        self.disruption.queue.reconcile(now=now)
        self.reconcile_termination(now=now)
        # evicted workload pods come back pending; rebind them
        if self.provisioner.get_pending_pods():
            self.provision(now=now)
        return command

    def reconcile_interruption(self, now: Optional[float] = None):
        """One spot-interruption cycle: poll the provider for notices,
        start drain-after-replace commands, progress the queue and
        termination, and rebind displaced and pending pods."""
        self._advance(now)
        commands = self.interruption.reconcile(now=now)
        for command in commands:
            if command.results is not None:
                self.bind_results(command.results)
        self.lifecycle.reconcile_all(now=now)
        self.cloud.tick(now=now)
        self.lifecycle.reconcile_all(now=now)
        self.disruption.queue.reconcile(now=now)
        self.reconcile_termination(now=now)
        if self.provisioner.get_pending_pods():
            self.provision(now=now)
        return commands

    def all_pods_bound(self) -> bool:
        return all(
            p.spec.node_name for p in self.kube.pods() if not p.is_terminal()
        )

    def reconcile_termination(self, now: Optional[float] = None, rounds: int = 4) -> None:
        """Drive claim finalize -> node drain -> instance delete to
        quiescence (each controller pass handles one stage)."""
        self._advance(now)
        for _ in range(rounds):
            self.lifecycle.reconcile_all(now=now)
            self.termination.reconcile_all(now=now)

    def provision(self, *pods, bind: bool = True, now: Optional[float] = None):
        """Create `pods`, run a provisioning round, launch its claims
        through the lifecycle controller, tick the simulated cloud,
        register and initialize nodes, and bind pods to their planned
        nodes."""
        self._advance(now)
        for pod in pods:
            if self.kube.get_pod(pod.metadata.namespace, pod.metadata.name) is None:
                self.kube.create(pod)
        results = self.provisioner.reconcile(now=now)
        self.lifecycle.reconcile_all(now=now)
        self.cloud.tick(now=now)
        self.lifecycle.reconcile_all(now=now)
        if bind:
            self.bind_results(results)
        return results

    def bind_results(self, results) -> None:
        """What kube-scheduler does after a round: pods bind to their
        target nodes."""
        for plan in results.new_node_plans:
            if not plan.claim_name:
                continue
            claim = self.kube.get_node_claim(plan.claim_name)
            if claim is None or not claim.status.node_name:
                continue
            for pod in plan.pods:
                live = self.kube.get_pod(pod.metadata.namespace, pod.metadata.name)
                if live is not None and not live.spec.node_name:
                    self.kube.bind_pod(live, claim.status.node_name)
        for node_name, pods in results.existing_assignments.items():
            state = self.cluster.node_for_name(node_name)
            target = state.name if state is not None else ""
            if not target:
                # an in-flight assignment is keyed by claim name: bind
                # to its node once registered, else leave the pods
                # pending for the next round (a dead claim's key never
                # pins pods to a name that will not materialize)
                claim = self.kube.get_node_claim(node_name)
                target = claim.status.node_name if claim is not None else ""
                if not target and claim is None:
                    if any(
                        n.metadata.name == node_name
                        for n in self.kube.nodes()
                    ):
                        target = node_name
                if not target:
                    continue
            for pod in pods:
                live = self.kube.get_pod(pod.metadata.namespace, pod.metadata.name)
                if live is not None and not live.spec.node_name:
                    self.kube.bind_pod(live, target)

    def initialized_nodes(self) -> list:
        return [
            n for n in self.kube.nodes()
            if n.metadata.labels.get("karpenter.sh/initialized") == "true"
        ]


# -- an Environment stream: provision, disruption, termination, interruption
#
# `environment_stream` drives either package's `Environment` through the
# same steps and reads each by attribute only, without names: the kwok
# provider names instances from a process-wide counter, so the two
# packages (and two processes) are held by `environment_fleet` and
# `environment_command`, never by node or claim names.

# the stream's clock: pods bind on the wall clock, so every step lies
# ahead of it, at one fixed start (see DISRUPTION_T0)
ENV_T0 = DISRUPTION_T0


def environment_fleet(env) -> tuple:
    """The cluster without names: per node (sorted) its instance type,
    zone, capacity type and bound pods; the pending pods; the claims;
    the provider's instances."""
    nodes = sorted(
        (n.metadata.labels.get(INSTANCE_TYPE_LABEL, ""),
         n.metadata.labels.get(TOPOLOGY_ZONE_LABEL, ""),
         n.metadata.labels.get(CAPACITY_TYPE_LABEL, ""),
         tuple(sorted(p.key for p in env.kube.pods_on_node(n.metadata.name))))
        for n in env.kube.nodes())
    pending = tuple(sorted(p.key for p in env.kube.pods()
                           if not p.spec.node_name and not p.is_terminal()))
    return tuple(nodes), pending, len(env.kube.node_claims()), len(env.cloud.list())


def environment_command(cmd) -> Optional[tuple]:
    """A command without names: its reason, each candidate's instance
    type, capacity type, zone and pods, and its replacement plans
    (`command_identity`'s)."""
    if cmd is None:
        return None
    cands = sorted((c.instance_type_name, c.capacity_type, c.zone,
                    tuple(sorted(p.key for p in c.reschedulable_pods)))
                   for c in cmd.candidates)
    return (cmd.reason, tuple(cands), command_identity(cmd)[2])


def environment_stream(env, pods, faults, t0: float = ENV_T0, drop: float = 0.3,
                       seed: int = 0, max_rounds: int = 6, interrupts: int = 3,
                       interrupt_rounds: int = 3, on_step=None) -> list[dict]:
    """`env` (either package's `Environment`, a node pool created)
    through four steps, each a list of records {"step", "decision",
    "fleet"} (`environment_fleet` after it):
    1. "provision": `pods` provisioned at t0 (claims launched through
       the lifecycle controller and the kwok provider, nodes
       registered, pods bound); the decision is the round's
       `decision_fingerprint`, claims named by creation order;
    2. "disruption": `drop` of the bound pods deleted (a draw of
       `seed`), then `reconcile_disruption` at t0 + 100k, k = 1, 2, ...
       until a round decides nothing, repeats the last round's command
       on an unchanged fleet (a stall: ROADMAP C6), or `max_rounds` ran;
       each decision `environment_command`; then "probes": the probe
       methods (multi-node and single-node consolidation) asked of the
       fleet that is left, their decisions (not executed);
    3. "termination": `reconcile_termination`;
    4. "interruption": the first `interrupts` interruption checks fire
       (`spot_interruption@cloud_interrupt:1-n` through `faults`, the
       env's package's fault module), then `interrupt_rounds` rounds of
       `reconcile_interruption`; each decision the started commands'.
    `on_step(record)` runs after each record."""
    out: list[dict] = []

    def note(step: str, decision) -> None:
        rec = {"step": step, "decision": decision, "fleet": environment_fleet(env)}
        out.append(rec)
        if on_step is not None:
            on_step(rec)

    results = env.provision(*pods, now=t0)
    claims = [env.kube.get_node_claim(p.claim_name) for p in results.new_node_plans
              if p.claim_name]
    note("provision", decision_fingerprint(results, claim_names([c for c in claims if c])))
    bound = sorted((p for p in env.kube.pods() if p.spec.node_name), key=lambda p: p.key)
    n = int(len(bound) * drop)
    rng = np.random.default_rng(seed)
    for i in sorted(rng.choice(len(bound), size=n, replace=False)):
        env.kube.delete(bound[int(i)], now=t0 + 50)
    last, before = None, environment_fleet(env)
    for k in range(1, max_rounds + 1):
        ident = environment_command(env.reconcile_disruption(now=t0 + 100 * k))
        note("disruption", ident)
        fleet = out[-1]["fleet"]
        if ident is None or (ident == last and fleet == before):
            break
        last, before = ident, fleet
    t = t0 + 100 * (max_rounds + 1)
    env.pod_events.reconcile_all(now=t)
    env.conditions.reconcile_all(now=t)
    note("probes", [environment_command(getattr(env.disruption, method)(t))
                    for method in ("multi_node_consolidation", "single_node_consolidation")])
    env.reconcile_termination(now=t)
    note("termination", None)
    try:
        with scoped_env({"KARPENTER_FAULTS": f"spot_interruption@cloud_interrupt:1-{interrupts}",
                         "KARPENTER_FAULT_SEED": None}):
            faults.reset()
            for k in range(1, interrupt_rounds + 1):
                cmds = env.reconcile_interruption(now=t + 100 * k)
                note("interruption", [environment_command(c) for c in cmds])
    finally:
        faults.reset()
    return out


# -- live-churn harness ------------------------------------------------------
#
# Copies of `karpenter_tpu/testing.py`'s churn fixture (a settled Operator
# over a FULL fleet of 4x 0.9-cpu pods per 4-cpu node, allocatable 3.9
# after kube-reserved, so a fifth pod can never fit) with `device=`: the
# device of every solve of the Environment and the Operator.

def build_churn_operator(n_pods: int, device=None):
    """Provision `n_pods` steady pods, settle a real Operator over the
    fleet, and return (env, operator, synthetic_now) ready for
    `churn_tick_walls`."""
    import time

    from karpenter_tpu_torch.cloudprovider.fake import GIB, make_instance_type
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import Options

    types = [make_instance_type("c4", cpu=4, memory=16 * GIB, price=1.0)]
    env = Environment(types=types, device=device)
    pool = mk_nodepool("churn")
    pool.spec.disruption.consolidate_after = "Never"
    env.kube.create(pool)
    env.provision(
        *[mk_pod(name=f"s-{i}", cpu=0.9, memory=2 * GIB)
          for i in range(n_pods)]
    )
    op = Operator(kube=env.kube, cloud_provider=env.cloud,
                  options=Options(), device=device)
    now = time.time()
    for i in range(3):   # settle: recovery, cache warmup, residual dirt
        op.step(now=now + i * 2.0)
    return env, op, now + 10.0


def churn_tick_walls(env, op, now: float, ticks: int, churn_pods: int):
    """Per-tick wall of the operator step that runs the churn solve.
    Returns (p50_wall_seconds, now)."""
    walls, now = churn_tick_wall_series(env, op, now, ticks, churn_pods)
    return sorted(walls)[len(walls) // 2], now


def churn_tick_wall_series(env, op, now: float, ticks: int,
                           churn_pods: int):
    """Per-tick wall series of the operator step that runs the churn
    solve: each tick deletes `churn_pods` bound pods, creates as many
    same-shape ones, and measures the step where the batcher fires.
    Returns (walls, now)."""
    import time

    from karpenter_tpu_torch.cloudprovider.fake import GIB

    walls = []
    counter = 0
    for t in range(ticks):
        bound = sorted(
            (p for p in env.kube.pods() if p.spec.node_name),
            key=lambda p: p.metadata.name,
        )
        for pod in bound[:churn_pods]:
            env.kube.delete(pod)
        for _ in range(churn_pods):
            counter += 1
            env.kube.create(mk_pod(name=f"churn-{t}-{counter}", cpu=0.9,
                                   memory=2 * GIB))
        # the batcher keys off wall-clock event arrival while the
        # harness ticks synthetic time already offset past the idle
        # window, so the FIRST step after churn runs the solve
        now += 2.0
        t0 = time.perf_counter()
        op.step(now=now)
        walls.append(time.perf_counter() - t0)
        now += 2.0
        op.step(now=now)   # bind/settle
    return walls, now


# -- the operator's main path ------------------------------------------------

OPERATOR_COUNTERS = ("DISRUPTION_SCAN_SKIPPED", "PREEMPTION_NOMINATIONS",
                     "PREEMPTION_EVICTIONS", "PRIORITY_SHED", "MICRO_SOLVE")
OPERATOR_STEPS = ("provision", "micro", "preempt", "disrupt")


def operator_api():
    """This package's modules under the names `operator_run` reads (a
    test builds the JAX package's under the same names)."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.apis.v1 import labels
    from karpenter_tpu_torch.cloudprovider import kwok
    from karpenter_tpu_torch.kube import client, objects
    from karpenter_tpu_torch.metrics import store
    from karpenter_tpu_torch.operator import operator, options

    return SimpleNamespace(labels=labels, kwok=kwok, client=client, objects=objects,
                           store=store, operator=operator, options=options)


def operator_record(api, op, step: str, counters0: dict, extra=None) -> dict:
    """One step of `operator_run` without names: the fleet (per node its
    instance type, zone, capacity type and bound pods), the pending pods,
    the nominated ones, the claims and the provider's instances, the
    counts of `readyz()` that do not read a clock (recovery, the
    incremental tick, the reactive plane, the retained disruption seam,
    the explain digest), and the growth of OPERATOR_COUNTERS since the
    run began."""
    kube = op.kube
    L = api.labels
    nodes = sorted(
        (n.metadata.labels.get(L.INSTANCE_TYPE_LABEL, ""),
         n.metadata.labels.get(L.TOPOLOGY_ZONE_LABEL, ""),
         n.metadata.labels.get(L.CAPACITY_TYPE_LABEL, ""),
         tuple(sorted(p.key for p in kube.pods_on_node(n.metadata.name))))
        for n in kube.nodes())
    live = [p for p in kube.pods() if not p.is_terminal()]
    pending = sorted(p.key for p in live if not p.spec.node_name)
    nominated = sorted(p.key for p in live
                       if not p.spec.node_name and p.status.nominated_node_name)
    ready = op.readyz()
    inc = ready["incremental"]
    seam = ready["disruption_snapshot"]
    counts = {
        "ok": ready["ok"], "checks": ready["checks"], "recovery": ready["recovery"],
        "incremental": {k: inc[k] for k in ("enabled", "quarantined", "retained_nodes",
                                            "divergences", "ticks", "fallbacks", "micro")},
        "reactive": ready["reactive"],
        "disruption_snapshot": {k: seam[k] for k in ("enabled", "retained_rows", "serves",
                                                     "row_hits", "row_rebuilds", "audits",
                                                     "divergences")},
        "explain": {k: ready["explain"][k] for k in ("pods", "nodes", "verdicts")},
    }
    grown = {name: getattr(api.store, name).total() - counters0[name]
             for name in OPERATOR_COUNTERS}
    return {"step": step, "nodes": nodes, "pending": pending, "nominated": nominated,
            "claims": len(kube.node_claims()), "instances": len(op.cloud_provider.list()),
            "ready": counts, "counters": grown, "extra": extra}


def operator_run(api, device, types, pool, waves, micro_pods, high_pods,
                 drop: float = 0.0, empty: int = 0,
                 policy: str = "WhenEmptyOrUnderutilized",
                 t0: float = DISRUPTION_T0, ticks: int = 4,
                 micro_steps: int = 5, scans: int = 6, seed: int = 0,
                 force_seconds: float = 100000.0, clock=None, on_step=None) -> list[dict]:
    """The operator's main path on `api`'s package, step by step with
    explicit clocks from `t0` (every record `operator_record`), `pool`
    never consolidated before step 4:
    1. "provision": each wave of `waves` created, then `ticks` operator
       steps 2 s apart (provisioning ticks, the claims launched through
       the lifecycle and the kwok provider over `types`, the binding
       queue's drain);
    2. "micro": `micro_pods` created, then `micro_steps` micro steps
       60 ms apart with the reactive plane on (each record's extra is
       the step's digest), then one step;
    3. "preempt": `pool`'s cpu limit set to the fleet's capacity, a
       PriorityClass "critical" (1000) created and `high_pods` given it,
       each pod's cpu request set just past the most free cpu of any node
       (so that it fits a node only once a victim leaves), then `ticks` +
       2 steps: they nominate lower-priority victims
       (PREEMPTION_NOMINATIONS);
    4. "disrupt": `drop` of the bound pods of priority below 1000 deleted
       (a draw of `seed`), every pod of the first `empty` nodes (in the
       order of their instance types and pods) and every pod still
       pending (the preemption wave retired), `pool` consolidated
       after 0s under `policy`, then `scans` steps each past the
       disruption poll: the engine's command (`environment_command`) is each
       record's extra; a scan that found nothing and saw no watch
       traffic since skips the next (DISRUPTION_SCAN_SKIPPED), the
       forced scan's period KARPENTER_INCR_DISRUPTION_FORCE_SECONDS set
       to `force_seconds` for the run.
    `device` is the Operator's (None: the JAX package's, which has
    none). `clock`, when given, is the deadline clock of the Operator's
    Provisioner, its incremental tick and its disruption engine (a fixed
    clock keeps every solve bound and method budget from firing, so that
    a slow run decides as a fast one). `on_step(record, wall)` runs after
    each step."""
    import time as _time

    t = t0
    kube = api.client.KubeClient()
    # the instances' timestamps and every object's creation and deletion
    # on the run's clock: a run decides alike whatever the wall clock
    cloud = api.kwok.KwokCloudProvider(kube, types=types, clock=lambda: t)
    kw = {} if device is None else {"device": device}
    op = api.operator.Operator(kube=kube, cloud_provider=cloud,
                               options=api.options.Options(), **kw)
    if clock is not None:
        op.provisioner.clock = op.provisioner.incremental.clock = clock
        op.disruption.clock = clock
    commands: list = []
    real_reconcile = op.disruption.reconcile

    def reconcile(now=None):
        cmd = real_reconcile(now=now)
        commands.append(environment_command(cmd))
        return cmd

    op.disruption.reconcile = reconcile
    counters0 = {name: getattr(api.store, name).total() for name in OPERATOR_COUNTERS}
    pool.spec.disruption.consolidate_after = "Never"

    def create(obj) -> None:
        obj.metadata.creation_timestamp = t
        kube.create(obj)

    create(pool)
    out: list[dict] = []

    def note(step: str, wall: float, extra=None) -> None:
        rec = operator_record(api, op, step, counters0, extra)
        out.append(rec)
        if on_step is not None:
            on_step(rec, wall)

    def step(kind: str, extra_of=None) -> None:
        nonlocal t
        t += 2.0
        w0 = _time.perf_counter()
        op.step(now=t)
        wall = _time.perf_counter() - w0
        note(kind, wall, extra_of() if extra_of else None)

    for wave in waves:
        for pod in wave:
            create(pod)
        for _ in range(ticks):
            step("provision")
    for pod in micro_pods:
        create(pod)
    for _ in range(micro_steps):
        t += 0.06
        w0 = _time.perf_counter()
        digest = op.micro_step(now=t)
        note("micro", _time.perf_counter() - w0, digest)
    step("micro")
    live = kube.get_node_pool(pool.metadata.name)
    live.spec.limits = {"cpu": sum(float(n.status.capacity.get("cpu", 0.0))
                                   for n in kube.nodes())}
    kube.update(live)
    create(api.objects.PriorityClass(
        metadata=api.objects.ObjectMeta(name="critical", namespace=""), value=1000))
    free, used = max(
        (float(n.status.allocatable.get("cpu", 0.0)) - u, u)
        for n in kube.nodes()
        for u in [sum(float(c.requests.get("cpu", 0.0))
                      for p in kube.pods_on_node(n.metadata.name)
                      for c in p.spec.containers)])
    for pod in high_pods:
        pod.spec.priority_class_name = "critical"
        pod.spec.containers[0].requests["cpu"] = round(free + min(0.5, used), 3)
        create(pod)
    for _ in range(ticks + 2):
        step("preempt")
    bound = sorted((p for p in kube.pods()
                    if p.spec.node_name and (p.spec.priority or 0) < 1000),
                   key=lambda p: p.key)
    rng = np.random.default_rng(seed)
    doomed = {bound[int(i)].key
              for i in rng.choice(len(bound), size=int(len(bound) * drop), replace=False)}
    by_node = sorted(
        (n.metadata.labels.get(api.labels.INSTANCE_TYPE_LABEL, ""),
         tuple(sorted(p.key for p in kube.pods_on_node(n.metadata.name))))
        for n in kube.nodes())
    doomed |= {key for _, keys in by_node[:empty] for key in keys}
    for pod in kube.pods():
        if pod.key in doomed or not pod.spec.node_name:
            kube.delete(pod, now=t)
    live = kube.get_node_pool(pool.metadata.name)
    live.spec.disruption.consolidate_after = "0s"
    live.spec.disruption.consolidation_policy = policy
    kube.update(live)
    poll = op.options.disruption_poll_seconds
    with scoped_env({"KARPENTER_INCR_DISRUPTION_FORCE_SECONDS": str(force_seconds)}):
        for _ in range(scans):
            t += poll
            n0 = len(commands)
            step("disrupt", lambda: commands[n0:])
    return out


# -- the real-client stack ---------------------------------------------------


def client_api():
    """`operator_api()` with the real-client modules `client_run` reads."""
    from karpenter_tpu_torch.kube import real
    from karpenter_tpu_torch.solver import faults

    api = operator_api()
    api.real, api.faults = real, faults
    return api


def client_fleet(api, op, cloud) -> tuple:
    """The converged state without names (tests/test_restart_chaos.py's
    fingerprint): per node its instance type and bound pods, sorted; the
    no-leak invariants that fail: wedged-deleting claims, claims not
    launched, instances that are not the claims' (a leak or a double
    launch), nodes that are not the claims', a mirror not synced, claims
    never paired with a node; and the pods left pending."""
    kube = op.kube
    claims = kube.node_claims()
    pids = sorted(c.status.provider_id for c in claims if c.status.provider_id)
    nodes = kube.nodes()
    live = [p for p in kube.pods() if p.metadata.deletion_timestamp is None]
    broken = [name for name, bad in (
        ("wedged_claim", any(c.metadata.deletion_timestamp is not None for c in claims)),
        ("unlaunched_claim", len(pids) != len(claims)),
        ("instances", sorted(i.status.provider_id for i in cloud.list()) != pids),
        ("nodes", sorted(n.spec.provider_id for n in nodes) != pids),
        ("mirror", not op.cluster.synced()),
        ("unpaired_claim", op.cluster.unpaired_claim_names() != []),
    ) if bad]
    parts = sorted(
        (n.metadata.labels.get(api.labels.INSTANCE_TYPE_LABEL, ""),
         tuple(sorted(p.metadata.name for p in kube.pods_on_node(n.metadata.name))))
        for n in nodes)
    return parts, broken, sorted(p.metadata.name for p in live if not p.spec.node_name)


def client_run(api, device, types, pool, pods, faults_spec: Optional[str] = None,
               ticks: int = 14, tail: int = 8, t0: float = DISRUPTION_T0) -> dict:
    """`pods` through the real-client stack of `api`'s package:
    `RealKubeClient(InMemoryApiServer())` under an Operator (`device`:
    the port's; None for the JAX package's), a second client as the user
    creating `pool` and the pods, then `ticks` steps 2 s apart, and past
    the garbage collector's interval (130 s later) `tail` more, under
    KARPENTER_FAULTS=`faults_spec` (with the kube retry and relist
    delays at their test settings). An OperatorCrashError rebuilds the
    client and the Operator against the same server, the cloud's client
    pointed at the new one (the restart recipe). Returns {"fleet",
    "broken", "pending" (`client_fleet`), "crashes", "recovery" (the
    growth of OPERATOR_RECOVERY by action), "retries" (of KUBE_RETRIES),
    "fault_log", "server", "op"}."""
    kw = {} if device is None else {"device": device}
    store = api.store
    actions = ("readopted_claim", "requeued_pod", "reaped_leak")
    rec0 = {a: store.OPERATOR_RECOVERY.value({"action": a}) for a in actions}
    retries0 = store.KUBE_RETRIES.total()
    env = {"KARPENTER_FAULTS": faults_spec, "KARPENTER_FAULT_SEED": None,
           "KARPENTER_KUBE_RETRY_BASE_MS": "1", "KARPENTER_KUBE_RELIST_MIN_MS": "0"}
    with scoped_env(env):
        api.faults.reset()
        server = api.real.InMemoryApiServer()
        kube = api.real.RealKubeClient(server)
        cloud = api.kwok.KwokCloudProvider(kube, types=types)
        op = api.operator.Operator(kube=kube, cloud_provider=cloud, **kw)
        user = api.real.RealKubeClient(server)
        user.create(pool)
        for pod in pods:
            user.create(pod)
        crashes = 0
        now = t0
        for k in range(ticks + tail):
            now += 2.0 + (130.0 if k == ticks else 0.0)
            try:
                op.step(now=now)
            except api.faults.OperatorCrashError:
                crashes += 1
                kube = api.real.RealKubeClient(server)
                cloud.kube = kube
                op = api.operator.Operator(kube=kube, cloud_provider=cloud, **kw)
        fault_log = api.faults.get().snapshot_log() if api.faults.get() is not None else []
        api.faults.reset()
    parts, broken, pending = client_fleet(api, op, cloud)
    user.close()
    return {"fleet": parts, "broken": broken, "pending": pending, "crashes": crashes,
            "recovery": {a: store.OPERATOR_RECOVERY.value({"action": a}) - rec0[a]
                         for a in actions},
            "retries": store.KUBE_RETRIES.total() - retries0,
            "fault_log": fault_log, "server": server, "op": op}

