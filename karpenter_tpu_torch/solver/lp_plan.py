"""Column-generation fleet planner for the cost objective.

Copy of `karpenter_tpu/solver/lp_plan.py`: the Gilmore-Gomory
cutting-stock master over integral per-node patterns,

    min  sum_p price[cfg(p)] * x[p]
    s.t. sum_p pattern[p][g] * x[p] >= count[g]      for every group g
         sum_{p: cfg(p)=c} x[p] <= cap[c]            for capped configs
         x >= 0,

solved on the host with scipy (HiGHS), with columns priced by a greedy
multi-dimensional knapsack over every launchable config at once: the
kernel B4 (`price_kernel`, `csrc/lp_price.cu` on the card, its plain
version `price_kernel_ref` on the CPU). Rounding turns the LP solution
into planned nodes (one config column and a per-group quota each);
the packer pre-opens them and its fresh-node path takes the spill.

`lower_bound` is proven-valid (the better of the linear resource bound
and Farley's bound, master value over the worst over-pricing ratio
from a true per-config upper bound on the knapsack value);
`objective_estimate` is the master's value.

Where the JAX package pins its pricing kernel to the host CPU (a fetch
over its remote accelerator link cost ~70 ms), this port runs B4 on
the solve's device: on a local GPU a fetch is one device-to-host copy.
Each plan records its B4 calls and their wall time in `debug`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.solver.encode import Encoded

log = logging.getLogger("karpenter.lp_plan")

# Column-generation budget: the loop runs until pricing finds nothing
# (convergence), the objective plateaus (stall), or _TIME_BUDGET_S
# elapses. Each round prices _PRICE_PASSES fills per config, masking
# the previous pass's dominant group.
_MAX_ITERS = 96
_MAX_NEW_PER_ITER = 384
_PRICE_PASSES = 3
_TIME_BUDGET_S = 8.0
_PRICE_EPS = 1e-6
# past _MAX_POOL columns the master is purged down to _PURGE_KEEP
# (basic columns always survive, the rest ranked by reduced cost)
_MAX_POOL = 3072
_PURGE_KEEP = 1536

# problem fingerprint -> converged pattern set (column-generation warm
# start), a small LRU; entry: {"basis", "plan", "est", "farley"}
_WARM_ENTRIES = 8
_warm_patterns: dict[tuple, dict] = {}
_warm_lock = threading.Lock()

# kernel launches of B4 (plain-version calls never count)
LAUNCHES = {"lp_price": 0}


def reset() -> None:
    """Test hook: drop the warm-pattern cache."""
    with _warm_lock:
        _warm_patterns.clear()


@dataclass
class FleetPlan:
    """Planned fresh nodes + per-node group quotas for the packer."""

    planned_cols: np.ndarray   # [Np] int32 config column per planned node
    planned_quota: np.ndarray  # [Np, G] int32 max pods of group g per node
    lower_bound: float         # proven-valid: max(linear bound, Farley)
    objective_estimate: float  # master LP value (estimate, heuristic pricing)
    debug: dict | None = None  # diagnostics
    # master-LP demand duals at the final solve ([G], >= 0)
    duals: np.ndarray | None = None
    # provenance per planned node: SRC_LP (floor of the LP x / integer
    # covering) vs SRC_REMAINDER (the greedy whole-pattern remainder)
    planned_src: np.ndarray | None = None  # [Np] int8


SRC_LP = 0
SRC_REMAINDER = 1


def plan_from_arrays(d: dict) -> FleetPlan:
    """A `FleetPlan` from the numpy fields of another run's plan (for
    example the JAX package's), so a solve can be fed the same plan."""
    return FleetPlan(
        planned_cols=np.asarray(d["planned_cols"], np.int32),
        planned_quota=np.asarray(d["planned_quota"], np.int32),
        lower_bound=float(d["lower_bound"]),
        objective_estimate=float(d["objective_estimate"]),
        debug=dict(d.get("debug") or {}),
        duals=(None if d.get("duals") is None
               else np.asarray(d["duals"], np.float64)),
        planned_src=(None if d.get("planned_src") is None
                     else np.asarray(d["planned_src"], np.int8)),
    )


def priority_weights(group_priority, n_groups: int) -> np.ndarray:
    """Per-group demand weights from resolved PriorityClass values,
    shared by the device ascent's objective and the host pricing
    (KARPENTER_LP_PRIORITY_WEIGHT; uniform priorities weigh exactly
    1.0)."""
    w = np.ones(n_groups, np.float64)
    if group_priority is None or not np.any(group_priority != 0):
        return w
    try:
        pw = float(os.environ.get("KARPENTER_LP_PRIORITY_WEIGHT", "")
                   or 0.25)
    except ValueError:
        pw = 0.25
    scale = float(np.max(np.abs(group_priority)))
    if scale > 0 and pw > 0:
        w = np.clip(
            1.0 + pw * np.asarray(group_priority, np.float64) / scale,
            0.05, None,
        )
    return w


def _pad_to(n: int, base: int = 32) -> int:
    """1.25x-spaced shape buckets (the JAX package's, so both pad alike)."""
    out = base
    while out < n:
        out = (out * 5 + 3) // 4
    return out


# ---------------------------------------------------------------- B4


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) rounded once to float32, for float32 a, b, c whose
    product a*b is exact in float64 (a an integer below 2^24): the sum
    in float64 with its rounding error (TwoSum), rounded to float32,
    and a float64 result that lands exactly between two float32
    neighbours resolved toward the error. A sum that is +-inf or NaN
    (c infinite, a product of 0 and inf) is that value, as IEEE's fma
    gives it."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    toward = torch.where(s > r.double(), torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    other = torch.nextafter(r, toward)
    mid = ((r.double() + other.double()) * 0.5 == s) & (err != 0) & torch.isfinite(s)
    pick = torch.where(err > 0, torch.maximum(r, other), torch.minimum(r, other))
    return torch.where(mid, pick, r)


def _window_sums(x: torch.Tensor) -> torch.Tensor:
    """One level of the row sum: the row zero-padded to a multiple of
    32 (half the padding in front, the odd element behind), each window
    of 32 summed in order from 0."""
    n = x.shape[-1]
    nwin = -(-n // 32)
    pad = nwin * 32 - n
    front = pad // 2
    t = torch.cat([x.new_zeros(*x.shape[:-1], front), x,
                   x.new_zeros(*x.shape[:-1], pad - front)], dim=-1)
    t = t.reshape(*x.shape[:-1], nwin, 32)
    s = torch.zeros_like(t[..., 0])
    for i in range(32):
        s = s + t[..., i]
    return s


def row_value(q: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """value[c] = sum_g q[c, g] * lam[g] in float32, in the order the
    JAX package's XLA program sums it on the CPU: up to 32 groups, one
    multiply-add chain in group order (fused, rounded once per step);
    beyond, the products rounded, summed in windows of 32 (`_window_sums`)
    and the window sums reduced the same way until at most 32 are left,
    then in order. The CUDA kernel sums in the same order, so the two
    and the JAX kernel agree bit for bit."""
    G = q.shape[-1]
    qf = q.to(torch.float32)
    if G <= 32:
        s = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        for g in range(G):
            s = _fma_f32(qf[..., g], lam[g], s)
        return s
    x = qf * lam
    while x.shape[-1] > 32:
        x = _window_sums(x)
    s = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        s = s + x[..., i]
    return s


def price_kernel_ref(lam, compat, group_req, eff_alloc, count):
    """Plain version of B4 (`_price_kernel`, lp_plan.py:150 of the JAX
    package): per config c, the greedy fill q[c] of the multi-dim
    knapsack, repeatedly bulk-adding the highest-density group that
    still fits the residual capacity (lowest index on a tie), capped at
    the group's demand, for at most G rounds. Returns q [C, G] int32
    and value [C] = `row_value(q, lam)` float32.

    lam [G] f32, compat [G, C] bool, group_req [G, R] f32,
    eff_alloc [C, R] f32, count [G] int32; all on one device."""
    C, R = eff_alloc.shape
    G = lam.shape[0]
    dev = lam.device
    f32 = torch.float32
    req = group_req
    safe_alloc = torch.clamp_min(eff_alloc, 1e-9)
    reqpos = req > 0
    frac = torch.where(
        reqpos[None, :, :], req[None, :, :] / safe_alloc[:, None, :],
        torch.zeros((), dtype=f32, device=dev),
    ).amax(dim=2)                                         # [C, G]
    density = torch.where(
        (lam[None, :] > 0) & compat.T & (frac > 0), lam[None, :] / frac,
        torch.full((), -1.0, dtype=f32, device=dev),
    )
    safe_req = torch.clamp_min(req, 1e-9)
    no_req = torch.full((), 2.0e9, dtype=f32, device=dev)
    minus_one = torch.full((), -1.0, dtype=f32, device=dev)
    rows = torch.arange(C, device=dev)
    resid = eff_alloc.clone()
    q = torch.zeros((C, G), dtype=torch.int32, device=dev)
    active = torch.ones((C,), dtype=torch.bool, device=dev)
    rounds = 0
    # the JAX while_loop's cond only ends the loop early: each config's
    # fill is independent of the others'
    while rounds < G and bool(active.any()):
        k = torch.where(
            reqpos[None, :, :],
            torch.floor((resid[:, None, :] + 1e-4) / safe_req[None, :, :]),
            no_req,
        ).amin(dim=2)                                     # [C, G]
        k = torch.minimum(k, (count[None, :] - q).to(f32))
        cand = torch.where(k >= 1, density, minus_one)
        best = cand.argmax(dim=1)
        best_val = cand[rows, best]
        active = active & (best_val > 0)
        take = torch.where(active, k[rows, best], torch.zeros((), dtype=f32, device=dev))
        q[rows, best] += take.to(torch.int32)
        resid = resid - take[:, None] * req[best]
        rounds += 1
    return q, row_value(q, lam)


def _price_kernel_cuda(lam, compat, group_req, eff_alloc, count):
    from karpenter_tpu_torch import cuda_build
    from karpenter_tpu_torch.solver.pack_split import _check, _ptr, _raise_on, _stream

    C, R = eff_alloc.shape
    G = lam.shape[0]
    _check(lam, "lam", torch.float32, (G,))
    _check(compat, "compat", torch.bool, (G, C))
    _check(group_req, "group_req", torch.float32, (G, R))
    _check(eff_alloc, "eff_alloc", torch.float32, (C, R))
    _check(count, "count", torch.int32, (G,))
    if R > 16:
        raise ValueError(f"lp_price: {R} resources exceed the kernel's 16")
    q = torch.empty((C, G), dtype=torch.int32, device=lam.device)
    value = torch.empty((C,), dtype=torch.float32, device=lam.device)
    lib = cuda_build.library("lp_price")
    err = lib.lp_price_launch(
        *(_ptr(t) for t in (lam, compat, group_req, eff_alloc, count, q, value)),
        G, C, R, _stream(),
    )
    _raise_on(err, "lp_price")
    LAUNCHES["lp_price"] += 1
    return q, value


def price_kernel(lam, compat, group_req, eff_alloc, count):
    """B4. Arguments and outputs as `price_kernel_ref`. CUDA tensors
    launch the kernel (`csrc/lp_price.cu`, one block per config); CPU
    tensors run the plain version; any other device raises."""
    if lam.is_cuda:
        return _price_kernel_cuda(lam, compat, group_req, eff_alloc, count)
    if lam.device.type == "cpu":
        return price_kernel_ref(lam, compat, group_req, eff_alloc, count)
    raise ValueError(f"lp_price: no kernel for device {lam.device}")


def _price_patterns(
    lam: np.ndarray,          # [G] duals
    compat: np.ndarray,       # [G, C] bool
    group_req: np.ndarray,    # [G, R]
    eff_alloc: np.ndarray,    # [C, R]
    prices: np.ndarray,       # [C]
    count: np.ndarray,        # [G]
    device: torch.device,
    stats: dict | None = None,
) -> list[tuple[int, np.ndarray]]:
    """Pricing with shape-bucketed padding on `device`; returns configs
    whose greedy fill beats their price (negative reduced cost),
    best-first. `stats` accumulates B4's calls and wall seconds."""
    G, C = compat.shape
    R = group_req.shape[1]
    Gp, Cp = _pad_to(G), _pad_to(C)
    lam_p = np.zeros(Gp, np.float32)
    lam_p[:G] = lam
    compat_p = np.zeros((Gp, Cp), bool)
    compat_p[:G, :C] = compat
    req_p = np.zeros((Gp, R), np.float32)
    req_p[:G] = group_req
    alloc_p = np.zeros((Cp, R), np.float32)
    alloc_p[:C] = eff_alloc
    count_p = np.zeros(Gp, np.int32)
    count_p[:G] = count

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out: list[tuple[int, np.ndarray]] = []
    reduced: list[float] = []
    lam_t, req_t, alloc_t, count_t = put(lam_p), put(req_p), put(alloc_p), put(count_p)
    for _ in range(_PRICE_PASSES):
        t0 = time.perf_counter()
        q, value = price_kernel(lam_t, put(compat_p), req_t, alloc_t, count_t)
        q_np = q.cpu().numpy()[:C, :G]
        value_np = value.cpu().numpy()[:C]
        if stats is not None:
            stats["price_calls"] = stats.get("price_calls", 0) + 1
            stats["price_wall_s"] = stats.get("price_wall_s", 0.0) + (
                time.perf_counter() - t0)
        hits = np.flatnonzero(value_np > prices + _PRICE_EPS)
        for c in hits:
            out.append((int(c), q_np[c].astype(np.int64)))
            reduced.append(float(prices[c] - value_np[c]))
        if not hits.size:
            break
        # diversify: mask each config's dominant group so the next
        # pass must build a structurally different fill
        weight = lam_p[None, :G] * q_np
        dominant = weight.argmax(axis=1)
        compat_p = compat_p.copy()
        compat_p[dominant[hits], hits] = False
    order = np.argsort(np.asarray(reduced)) if reduced else []
    return [out[i] for i in order]


# ---------------------------------------------------------------- host LP


def _initial_patterns(
    compat: np.ndarray,       # [G, C]
    group_req: np.ndarray,    # [G, R]
    eff_alloc: np.ndarray,    # [C, R]
    prices: np.ndarray,       # [C]
    count: np.ndarray,        # [G]
):
    """Per group: its densest single-group fill on the config with the
    best price-per-pod (guarantees master-LP feasibility)."""
    G, C = compat.shape
    safe = np.where(group_req > 0, group_req, 1.0)          # [G, R]
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.floor(
            (eff_alloc[None, :, :] + 1e-4) / safe[:, None, :]
        )                                                   # [G, C, R]
    k = np.where(group_req[:, None, :] > 0, k, np.inf).min(axis=2)
    k = np.minimum(k, count[:, None].astype(np.float64))
    k = np.where(compat, k, 0.0)                            # [G, C]
    ok = k >= 1
    plannable = ok.any(axis=1)
    ppp = np.where(ok, prices[None, :] / np.maximum(k, 1.0), np.inf)
    best = ppp.argmin(axis=1)                               # [G]
    patterns: list[tuple[int, np.ndarray]] = []
    for g in np.flatnonzero(plannable):
        q = np.zeros(G, np.int64)
        q[g] = int(k[g, best[g]])
        patterns.append((int(best[g]), q))
    # per-group value estimate = its best achievable price-per-pod;
    # seeds dense mixed fills before the first master solve
    value_est = np.where(plannable, np.take_along_axis(
        ppp, best[:, None], 1
    )[:, 0], 0.0)
    value_est = np.where(np.isfinite(value_est), value_est, 0.0)
    return patterns, plannable, value_est


def _knapsack_value_ub(
    lam: np.ndarray,          # [G] demand duals (>= 0)
    compat: np.ndarray,       # [G, C] bool
    group_req: np.ndarray,    # [G, R]
    eff_alloc: np.ndarray,    # [C, R]
    count: np.ndarray,        # [G]
) -> tuple[np.ndarray, np.ndarray]:
    """Per-config upper bound on the exact pricing-knapsack value (the
    fractional relaxation, one tiny HiGHS LP per distinct config), plus
    its fractional argmax q_star."""
    from scipy.optimize import linprog as _linprog

    G, C = compat.shape
    lam = np.clip(lam, 0.0, None)
    ub = np.zeros(C, np.float64)
    q_star = np.zeros((C, G), np.float64)
    active = (lam > 0) & (count > 0)
    a_ub = group_req.T  # [R, G]
    keys: dict[bytes, tuple[float, np.ndarray]] = {}
    for c in range(C):
        usable = compat[:, c] & active
        if not usable.any():
            continue
        key = usable.tobytes() + eff_alloc[c].tobytes()
        hit = keys.get(key)
        if hit is None:
            bounds = [
                (0.0, float(count[g]) if usable[g] else 0.0)
                for g in range(G)
            ]
            r = _linprog(
                -lam,
                A_ub=a_ub,
                b_ub=np.clip(eff_alloc[c], 0.0, None),
                bounds=bounds,
                method="highs",
            )
            hit = (
                (float(-r.fun), np.asarray(r.x))
                if r.success
                else (float("inf"), np.zeros(G))
            )
            keys[key] = hit
        ub[c] = hit[0]
        q_star[c] = hit[1]
    return ub, q_star


def _knapsack_value_int_ub(
    lam: np.ndarray,
    compat: np.ndarray,
    group_req: np.ndarray,
    eff_alloc: np.ndarray,
    count: np.ndarray,
    cfgs: np.ndarray,
) -> dict[int, float]:
    """Valid upper bound on the integral pricing-knapsack value for the
    given configs, from the HiGHS MIP's dual bound."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    G = compat.shape[0]
    lam = np.clip(lam, 0.0, None)
    out: dict[int, float] = {}
    keys: dict[bytes, float] = {}
    for c in cfgs:
        usable = compat[:, int(c)] & (lam > 0) & (count > 0)
        key = usable.tobytes() + eff_alloc[int(c)].tobytes()
        hit = keys.get(key)
        if hit is None:
            ub = np.where(usable, count, 0).astype(np.float64)
            r = milp(
                c=-lam,
                constraints=LinearConstraint(
                    group_req.T, -np.inf,
                    np.clip(eff_alloc[int(c)], 0.0, None),
                ),
                integrality=np.ones(G),
                bounds=Bounds(np.zeros(G), ub),
                options={"time_limit": 0.08, "disp": False},
            )
            bound = getattr(r, "mip_dual_bound", None)
            hit = float(-bound) if bound is not None else float("inf")
            keys[key] = hit
        out[int(c)] = hit
    return out


def _pattern_matrix(
    patterns, count, col_rsv, rsv_cap, capped_slots, cap_row, G, sparse,
):
    """Constraint assembly shared by the master LP and the integer
    covering: demand rows (>= count, as <= with negated coefficients)
    plus one cap row per reservation with columns in play."""
    P = len(patterns)
    a_rows = np.concatenate([np.flatnonzero(q) for _, q in patterns])
    a_cols = np.concatenate(
        [np.full(int((q > 0).sum()), p) for p, (_, q) in enumerate(patterns)]
    )
    a_vals = np.concatenate([q[q > 0] for _, q in patterns]).astype(np.float64)
    blocks = [sparse.csr_matrix((-a_vals, (a_rows, a_cols)), shape=(G, P))]
    b_ub = [-count.astype(np.float64)]
    if len(capped_slots):
        cap_cols = np.array(
            [cap_row.get(int(col_rsv[c]), -1) for c, _ in patterns],
            dtype=np.int64,
        )
        hit = np.flatnonzero(cap_cols >= 0)
        blocks.append(
            sparse.csr_matrix(
                (np.ones(len(hit)), (cap_cols[hit], hit)),
                shape=(len(capped_slots), P),
            )
        )
        b_ub.append(rsv_cap[capped_slots])
    return sparse.vstack(blocks, format="csr"), np.concatenate(b_ub)


def _solve_master(
    patterns, prices, count, col_rsv, rsv_cap, capped_slots, cap_row,
    G, sparse, linprog,
):
    """One restricted-master solve over the shared constraint matrix."""
    a_ub, b_ub = _pattern_matrix(
        patterns, count, col_rsv, rsv_cap, capped_slots, cap_row, G, sparse
    )
    return linprog(
        prices[[c for c, _ in patterns]],
        A_ub=a_ub,
        b_ub=b_ub,
        bounds=(0, None),
        method="highs",
    )


def _combined_lower_bound(
    enc: Encoded, plannable: np.ndarray | None, farley: float
) -> float:
    """The certified bound: the linear bound, and Farley's when no
    existing node can absorb demand for free."""
    lower = linear_lower_bound(enc, plannable)
    if enc.n_existing == 0 and np.isfinite(farley):
        lower = max(lower, farley)
    return lower


def linear_lower_bound(
    enc: Encoded, plannable: np.ndarray | None = None
) -> float:
    """Valid fleet-cost lower bound for the launchable share of the
    demand: per resource, demand (less what existing nodes could
    absorb) times the best price per unit over launchable configs; the
    max over resources."""
    launch = enc.cfg_pool >= 0
    if not launch.any():
        return 0.0
    alloc = enc.cfg_alloc[launch]
    price = enc.cfg_price[launch]
    counts = enc.group_count.astype(np.float32)
    if plannable is not None:
        counts = np.where(plannable, counts, 0.0)
    demand = (enc.group_req * counts[:, None]).sum(axis=0)
    if enc.n_existing:
        existing = ~(enc.cfg_pool >= 0)
        demand = np.clip(demand - enc.cfg_alloc[existing].sum(axis=0), 0.0, None)
    bound = 0.0
    for r in range(alloc.shape[1]):
        cap = alloc[:, r]
        usable = cap > 0
        if not usable.any() or demand[r] <= 0:
            continue
        best = float((price[usable] / cap[usable]).min())
        bound = max(bound, best * float(demand[r]))
    return bound


def plan(enc: Encoded, max_planned: int = 8192,
         device: torch.device | str = "cuda") -> FleetPlan | None:
    """Column generation + rounding, pricing with B4 on `device`.
    Returns None when planning does not apply (no groups, no launchable
    column, an unsuccessful master LP, or too many planned nodes); the
    caller then packs without a plan. Errors of B4 propagate.

    `debug["stop"]` says how column generation ended: "converged"
    (pricing found nothing), "stall" (the objective plateaued),
    "time_budget" or "max_iters"."""
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except ImportError:
        return None

    device = torch.device(device)
    G = enc.compat.shape[0]
    cols = np.flatnonzero(enc.cfg_pool >= 0)
    if G == 0 or len(cols) == 0:
        return None

    eff_alloc = enc.cfg_alloc[cols] - enc.pool_overhead[enc.cfg_pool[cols]]
    usable = (eff_alloc > 0).any(axis=1)
    cols = cols[usable]
    eff_alloc = np.clip(eff_alloc[usable], 0.0, None)
    C = len(cols)
    if C == 0:
        return None
    compat = enc.compat[:, cols]          # [G, C]
    prices = enc.cfg_price[cols]          # [C]
    col_rsv = (
        enc.cfg_rsv[cols]
        if enc.cfg_rsv is not None
        else np.full((C,), -1, np.int32)
    )                                     # [C] reservation slot, -1 none
    rsv_cap = (
        enc.rsv_cap.astype(np.float64)
        if enc.rsv_cap is not None
        else np.zeros((0,), np.float64)
    )
    count = enc.group_count.astype(np.int64)
    # pattern discovery prices against priority-weighted duals; the
    # master, the Farley scaling and the bound stay dollar-priced
    prio_w = priority_weights(enc.group_priority, G)
    stats: dict = {"price_calls": 0, "price_wall_s": 0.0}

    patterns: list[tuple[int, np.ndarray]] = []
    seen: set[bytes] = set()

    def add_pattern(c: int, q: np.ndarray) -> bool:
        key = c.to_bytes(4, "little") + q.tobytes()
        if key in seen or q.sum() == 0:
            return False
        seen.add(key)
        patterns.append((c, q.astype(np.int64)))
        return True

    # warm start, keyed by a digest of every input the patterns depend on
    digest = hashlib.blake2b(digest_size=16)
    for buf in (
        enc.group_count, enc.group_req, prices, eff_alloc,
        np.ascontiguousarray(compat), cols, col_rsv, rsv_cap, prio_w,
    ):
        digest.update(np.ascontiguousarray(buf).tobytes())
    fingerprint = (G, C, digest.digest())
    with _warm_lock:
        warm = _warm_patterns.get(fingerprint)
    if warm is not None:
        for c, q in warm["basis"]:
            add_pattern(c, np.asarray(q))

    init, plannable, value_est = _initial_patterns(
        compat, enc.group_req, eff_alloc, prices, count
    )
    for c, q in init:
        add_pattern(c, q)
    if warm is None:
        # cold start: seed dense mixed fills by pricing against the
        # per-group value estimates with the acceptance bar removed
        for c, q in _price_patterns(
            value_est, compat, enc.group_req, eff_alloc,
            np.full(len(prices), -1.0), count, device, stats,
        )[: 2 * _MAX_NEW_PER_ITER]:
            add_pattern(c, q)
    if (col_rsv >= 0).any():
        # uncapped fallbacks keep every group coverable
        uncapped = col_rsv < 0
        if uncapped.any():
            fb_prices = np.where(uncapped, prices, np.inf).astype(prices.dtype)
            fallback, _, _ = _initial_patterns(
                compat & uncapped[None, :], enc.group_req, eff_alloc,
                fb_prices, count,
            )
            for c, q in fallback:
                add_pattern(c, q)
    if not patterns:
        return None
    count = np.where(plannable, count, 0)

    capped_slots = np.unique(col_rsv[col_rsv >= 0])
    cap_row = {int(s): i for i, s in enumerate(capped_slots)}

    res = None
    converged = False
    stop = "max_iters"
    prev_obj = None
    stall = 0
    final_lam = None
    final_mu = None
    iters = 0
    t_start = time.perf_counter()
    for _ in range(_MAX_ITERS):
        if time.perf_counter() - t_start > _TIME_BUDGET_S:
            stop = "time_budget"
            break
        iters += 1
        if len(patterns) > _MAX_POOL and res is not None and final_lam is not None:
            # purge at loop top so the final master's res.x aligns
            # with `patterns`
            prev_p = len(res.x)
            rank_val = np.array([
                prices[c] - float(final_lam @ q) for c, q in patterns[:prev_p]
            ])
            keep_idx = set(np.flatnonzero(res.x[:prev_p] > 1e-9).tolist())
            keep_idx.update(range(prev_p, len(patterns)))
            for j in np.argsort(rank_val):
                if len(keep_idx) >= _PURGE_KEEP:
                    break
                keep_idx.add(int(j))
            patterns = [patterns[j] for j in sorted(keep_idx)]
            seen = {
                c.to_bytes(4, "little") + q.tobytes() for c, q in patterns
            }
        res = _solve_master(
            patterns, prices, count, col_rsv, rsv_cap, capped_slots,
            cap_row, G, sparse, linprog,
        )
        if res is None or not res.success:
            return None
        lam = -np.asarray(res.ineqlin.marginals)[:G]
        lam = np.clip(lam, 0.0, None)
        final_lam = lam
        # capped configs price against (reduced price + cap dual)
        eff_prices = prices.copy()
        if len(capped_slots):
            mu = np.clip(np.asarray(res.ineqlin.marginals)[G:], None, 0.0)
            final_mu = mu
            for ci in np.flatnonzero(col_rsv >= 0):
                eff_prices[ci] -= mu[cap_row[int(col_rsv[ci])]]
        new = _price_patterns(
            lam * prio_w, compat, enc.group_req, eff_alloc, eff_prices,
            count, device, stats,
        )
        added = 0
        for c, q in new[:_MAX_NEW_PER_ITER]:
            added += add_pattern(c, q)
        if added == 0:
            converged = True
            stop = "converged"
            break
        # objective plateau (0.1% warm, 0.02% cold)
        stall_tol = (1e-3 if warm is not None else 2e-4) * max(
            1.0, abs(res.fun)
        )
        if prev_obj is not None and prev_obj - res.fun <= stall_tol:
            stall += 1
            if stall >= 3:
                stop = "stall"
                break
        else:
            stall = 0
        prev_obj = res.fun

    if res is None:
        return None
    x = res.x

    # steady state: the master landed where the cached converged run
    # was, so the cached rounded plan is still the answer
    if (
        warm is not None
        and warm.get("plan") is not None
        and res.fun >= warm["est"] - 1e-3 * max(1.0, abs(warm["est"]))
    ):
        cached = warm["plan"]
        with _warm_lock:
            _warm_patterns.pop(fingerprint, None)
            _warm_patterns[fingerprint] = warm  # refresh LRU position
        return FleetPlan(
            planned_cols=cached.planned_cols,
            planned_quota=cached.planned_quota,
            lower_bound=_combined_lower_bound(
                enc, plannable, warm.get("farley", 0.0)
            ),
            objective_estimate=float(res.fun),
            duals=cached.duals,
            planned_src=cached.planned_src,
            debug=dict(
                cached.debug or {},
                iters=iters,
                stop=stop,
                plan_wall_s=time.perf_counter() - t_start,
                cached_round=True,
                **stats,
            ),
        )

    # exact-pricing refinement (cold calls only): inject the floors of
    # the worst offenders' fractional fills and re-solve, driving the
    # over-pricing ratio theta toward 1
    farley_theta = None
    if final_lam is not None and warm is None:
        rounds = 0
        while True:
            value_ub, q_star = _knapsack_value_ub(
                final_lam, compat, enc.group_req, eff_alloc, count
            )
            mu_c = np.zeros(C, np.float64)
            if len(capped_slots) and final_mu is not None:
                for ci in np.flatnonzero(col_rsv >= 0):
                    mu_c[ci] = -final_mu[cap_row[int(col_rsv[ci])]]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratios = (value_ub - mu_c) / np.maximum(prices, 1e-12)
            farley_theta = max(
                1.0, float(np.nanmax(ratios)) if len(ratios) else 1.0
            )
            if (
                farley_theta <= 1.02
                or rounds >= 3
                or time.perf_counter() - t_start > _TIME_BUDGET_S + 4.0
            ):
                break
            added = 0
            for c in np.argsort(-ratios)[:128]:
                if ratios[c] <= 1.0 + 1e-6:
                    break
                # clip before flooring: HiGHS may return components a
                # hair below zero
                q = np.floor(
                    np.clip(q_star[c], 0.0, None) + 1e-9
                ).astype(np.int64)
                added += add_pattern(int(c), q)
            if not added:
                break
            res2 = _solve_master(
                patterns, prices, count, col_rsv, rsv_cap, capped_slots,
                cap_row, G, sparse, linprog,
            )
            if res2 is None or not res2.success:
                break
            res = res2
            x = res.x
            final_lam = np.clip(
                -np.asarray(res.ineqlin.marginals)[:G], 0.0, None
            )
            if len(capped_slots):
                final_mu = np.clip(
                    np.asarray(res.ineqlin.marginals)[G:], None, 0.0
                )
            rounds += 1
        if farley_theta is not None and farley_theta > 1.02:
            # re-bound the configs that set theta with the integral
            # knapsack's dual bound
            top = np.argsort(-ratios)[:32]
            int_ub = _knapsack_value_int_ub(
                final_lam, compat, enc.group_req, eff_alloc, count, top
            )
            tightened = ratios.copy()
            for c, v in int_ub.items():
                if np.isfinite(v):
                    tightened[c] = (v - mu_c[c]) / max(prices[c], 1e-12)
            farley_theta = max(1.0, float(np.nanmax(tightened)))

    # integer covering over the converged pattern set (HiGHS MIP under a
    # time cap); on a timeout or failure the floor-and-greedy rounding
    # below still produces a plan from the LP x
    try:
        from scipy.optimize import Bounds, LinearConstraint, milp
    except ImportError:
        milp = None
    cover = None  # the integer covering's HiGHS status, for diagnosis
    if milp is not None:
        try:
            rc = np.array([
                prices[c] - float(final_lam @ q) for c, q in patterns
            ]) if final_lam is not None else np.zeros(len(patterns))
            # pricing may have appended columns after the last master
            # solve: extend the LP x with zeros
            x_lp = np.zeros(len(patterns))
            x_lp[: len(x)] = x
            pick = set(np.flatnonzero(x_lp > 1e-9).tolist())
            for j in np.argsort(rc):
                if len(pick) >= 384:
                    break
                pick.add(int(j))
            sel = sorted(pick)
            sub = [patterns[j] for j in sel]
            P = len(sub)
            a_ub_m, b_ub_m = _pattern_matrix(
                sub, count, col_rsv, rsv_cap, capped_slots, cap_row, G, sparse
            )
            col_ub = np.ceil(x_lp[sel] + 1e-9) + 5.0
            mip = milp(
                c=prices[[c for c, _ in sub]],
                constraints=LinearConstraint(a_ub_m, -np.inf, b_ub_m),
                integrality=np.ones(P),
                bounds=Bounds(0.0, col_ub),
                options={"time_limit": 1.5, "mip_rel_gap": 0.004,
                         "disp": False},
            )
            # any incumbent is a full covering; accept one near the LP
            # value
            cover = {"status": int(mip.status), "accepted": False}
            if (
                mip.x is not None
                and mip.status in (0, 1, 3)
                and mip.fun <= res.fun * 1.25 + 1e-6
            ):
                x = np.zeros(len(patterns))
                x[sel] = np.round(mip.x)
                cover["accepted"] = True
        except Exception as err:
            # the rounding below is always a valid plan: a HiGHS
            # failure lowers the plan's quality, it does not fail it
            log.warning("integer covering failed (%s); falling back "
                        "to floor-and-greedy rounding", err)

    # round down: each floor(x_p) copy of pattern p is one planned node;
    # the remainder is covered greedily with whole patterns while a
    # pattern still fills at least half a node
    shortfall = count.astype(np.float64).copy()
    planned_cols: list[int] = []
    quota_rows: list[np.ndarray] = []
    src_rows: list[int] = []
    used_per_rsv = np.zeros(len(rsv_cap), np.float64)

    def emit(p: int, copies: int, src: int = SRC_LP) -> int:
        c, q = patterns[p]
        slot = int(col_rsv[c])
        if slot >= 0:
            copies = int(min(copies, max(rsv_cap[slot] - used_per_rsv[slot], 0)))
            used_per_rsv[slot] += copies
        for _ in range(copies):
            planned_cols.append(int(cols[c]))
            quota_rows.append(q)
            src_rows.append(src)
        return copies

    for p in np.flatnonzero(np.floor(x + 1e-9) > 0):
        copies = emit(int(p), int(np.floor(x[p] + 1e-9)))
        shortfall -= copies * patterns[p][1]
    shortfall = np.clip(shortfall, 0.0, None)

    pattern_mat = np.stack([q for _, q in patterns])  # [P, G]
    pattern_cost = prices[[c for c, _ in patterns]]
    for _ in range(2 * len(patterns)):
        if shortfall.sum() < 1:
            break
        covered = np.minimum(pattern_mat, shortfall[None, :]).sum(axis=1)
        score = np.where(covered > 0, pattern_cost / np.maximum(covered, 1e-9), np.inf)
        p = int(np.argmin(score))
        if not np.isfinite(score[p]):
            break
        fill_frac = covered[p] / max(pattern_mat[p].sum(), 1)
        if fill_frac < 0.5:
            break  # node would be under half-used: cheaper as spill
        if emit(p, 1, src=SRC_REMAINDER) == 0:
            pattern_cost = pattern_cost.copy()
            pattern_cost[p] = np.inf  # cap exhausted; try next pattern
            continue
        shortfall = np.clip(shortfall - pattern_mat[p], 0.0, None)

    if not planned_cols or len(planned_cols) > max_planned:
        return None
    # store only the basic columns (plus any priced after the last
    # master solve) for the warm start
    basis = [
        patterns[j] for j in range(len(patterns))
        if j >= len(res.x) or res.x[j] > 1e-9
    ] or patterns

    farley = 0.0
    if farley_theta is not None and np.isfinite(farley_theta):
        farley = float(res.fun) / farley_theta
    elif warm is not None:
        farley = warm.get("farley", 0.0)
    out = FleetPlan(
        planned_cols=np.asarray(planned_cols, dtype=np.int32),
        planned_quota=np.stack(quota_rows).astype(np.int32),
        lower_bound=_combined_lower_bound(enc, plannable, farley),
        objective_estimate=float(res.fun),
        duals=(
            np.asarray(final_lam, np.float64)
            if final_lam is not None else None
        ),
        planned_src=np.asarray(src_rows, dtype=np.int8),
        debug={
            "cols": cols,
            "patterns": len(patterns),
            "converged": converged,
            "stop": stop,
            "cover": cover,
            "iters": iters,
            "plan_wall_s": time.perf_counter() - t_start,
            **stats,
        },
    )
    with _warm_lock:
        _warm_patterns.pop(fingerprint, None)  # re-insert as newest
        while len(_warm_patterns) >= _WARM_ENTRIES:
            _warm_patterns.pop(next(iter(_warm_patterns)))  # evict oldest
        _warm_patterns[fingerprint] = {
            "basis": [(c, q.copy()) for c, q in basis],
            "plan": out,
            "est": float(res.fun),
            "farley": farley,
        }
    return out
