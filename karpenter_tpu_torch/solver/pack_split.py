"""The packing kernels of the provisioning solve, with their plain
PyTorch versions.

B1 `pack_split` replaces `karpenter_tpu/solver/pack.py::pack_split`
(with its `capacity` and `_prefix_take`): the serial first-fit-
decreasing walk over pod groups, with the node axis split into a bound
block (existing and planned nodes, one config each) and a fresh block
(nodes the solve opens, each with a config mask). B3
`pack_split_wavefront` replaces the JAX `pack_split_wavefront`: the same
function in rounds that plan several groups against one state and
commit the prefix of plans that commute. B2 `pack_flat_words`
replaces the epilogue of `pack_split_flat`: it bit-packs the fresh
masks 32 columns to a word and lays every output out in one 32-bit
buffer, in the order the host decode reads it.

B6 replaces the JAX `pack_probe_lanes_flat`: the consolidation probe
batch, B1 (`pack_probe_lanes`) or B3 (`pack_probe_lanes_wavefront`)
over a lane axis of candidate subsets that share one problem and
differ in their demand and retained bound rows, then B2 over the lanes
(`pack_flat_lanes`), one flat row per lane. `pack_probe_lanes_flat`
composes them as the JAX function does.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it launches its hand-written kernel
(`karpenter_tpu_torch/csrc/*.cu`) or raises; there is no fallback.
`LAUNCHES` counts kernel launches per wrapper.

The plain versions follow the JAX body step by step, with Python
loops over groups (B3: over rounds and lanes), in float32 and in the
same order of operations, so their outputs are byte-identical to the
JAX kernel's and to the CUDA kernel's. Every pick is an
index-tie-broken arg-reduction.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

BIG = 3.4e38
INT_BIG = 2**31 - 1
# per-node capacity ceiling: fits int32 exactly; every capacity is
# clipped here before the float-to-int cast
CAP_MAX = 2.0e9
# the CUDA kernels keep a group's request vector in shared memory
MAX_RESOURCES = 16

# int32 scalars per lane of the wavefront kernel's plan (LaneField in
# csrc/pack_wavefront.cu)
WAVEFRONT_LANE_FIELDS = 8
# shared memory a block may have on an H100 (sm_90), the part of it the
# packing kernels keep for their static shared variables (ptxas reports
# under 1 KB), and the dynamic budget that leaves
SMEM_LIMIT = 232_448
STATIC_SMEM = 8_192
SMEM_BUDGET = SMEM_LIMIT - STATIC_SMEM

# kernel launches per wrapper (plain-version calls never count)
LAUNCHES = {"pack_split": 0, "pack_split_wavefront": 0, "pack_split_flat": 0,
            "pack_probe_lanes": 0, "pack_probe_lanes_wavefront": 0,
            "pack_probe_lanes_flat": 0}

# wrapper -> the dynamic shared memory a block of its last launch took
DYNAMIC_SMEM: dict[str, int] = {}

# cluster width W -> the active-cluster count the card reported at the
# last B6 wavefront launch (cudaOccupancyMaxActiveClusters)
ACTIVE_CLUSTERS: dict[int, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the phases that block 0 of a phase-clock build times, slot by slot
# (PhaseClock in csrc/pack_common.cuh; the last slot counts the group
# steps with demand, the rounds, or B5's iterations)
PHASES = {
    "pack_split": ("init", "step start", "sweep", "prefix scan",
                   "takes and apply", "bulk open"),
    "pack_wavefront": ("init", "candidate pick", "plan: sweep", "plan: prefix scan",
                       "plan: takes", "plan: open", "plan: tail", "barrier 1 wait",
                       "conflicts", "barrier 2 wait", "accept", "commit",
                       "barrier 3 wait"),
    "lp_ascend": ("init", "step: norm, update, ratio", "fwd: max and ties",
                  "fwd: vh0, z", "fwd: theta, excess, mu, dot, dtheta_a",
                  "fwd: mu ties, bound", "keep best", "sg: dexcess, dtheta_b terms",
                  "sg: dtheta_b, dvh, qx, d ratio's terms", "sg: d ratio, grad, lam max"),
}
_CLOCK_SLOTS = 32
# per-thread spreads of the packing kernels (PhaseClock::spread):
# (largest, sum over the block's threads) slot pairs, summed over steps
# or rounds
SPREADS = {"sweep cycles": (16, 17), "candidate configs": (18, 19),
           "exact capacities": (20, 21), "apply cycles": (22, 23),
           "rows applied": (24, 25)}
# B5's slot of the block barriers its iterations took (`bar` in
# csrc/lp_ascend.cu), and the regions inside its phases that its clock
# build times on the thread that runs each (`Region`), from slot 16
BARRIER_SLOT = 30
REGIONS = {"lp_ascend": ("column maxima", "vh0, z", "excess, mu, theta ties",
                         "dtheta_a", "the bound's dot", "mu . budget", "mu ties",
                         "dtheta_b", "dvh, qx, d ratio's terms", "d ratio rows", "grad",
                         "norm", "update, ratio", "zeroing")}
REGION_SLOT = 16
# libraries whose phase-clock builds are swapped in (`phase_clocks`)
_clocked: set[str] = set()


def _align16(n: int) -> int:
    return (n + 15) & ~15


def words_of(n: int) -> int:
    return (n + 31) // 32


def words_pad(C: int) -> int:
    """Words of a fresh row's config bits in the kernels' scratch: 32
    columns a word, padded to a multiple of 4 (16-byte loads)."""
    return (words_of(C) + 3) & ~3


def table_smem_bytes(C: int, R: int, P1: int, K: int, G: int) -> int:
    """The tables a packing block copies into its dynamic shared memory
    (`table_layout` in csrc/pack_common.cuh, each segment on 16 bytes):
    cfg_alloc and pool_overhead, cfg_price, cfg_pool, cfg_rsv, rsv_cap,
    the reservation use and a group's spend, kopen, fits, the capped
    columns as bits, and the G groups' demand, request and compat bits.
    A B1, B6 sequential or B7 block takes these; B3's takes more
    (`wavefront_smem_bytes`)."""
    nw = words_pad(C)
    return (_align16(4 * C * R) + _align16(4 * P1 * R) + 3 * _align16(4 * C)
            + _align16(4 * K) + 2 * _align16(4 * (K + 1)) + _align16(4 * C)
            + _align16(C) + 4 * nw + _align16(4 * G) + _align16(4 * G * R) + 4 * G * nw)


def wavefront_smem_bytes(C: int, R: int, P1: int, K: int, W: int, G: int, N: int) -> int:
    """Dynamic shared memory of a B3 or B6 wavefront block: the tables,
    then the lanes' scalars and conflict words, the committed groups'
    bits, the conflict pass's offsets, the lane's conflict words, the
    acceptance scan's verdicts and offsets, and the lane's filled rows
    as bits over the N rows (`wave_layout` in csrc/pack_wavefront.cu)."""
    return (table_smem_bytes(C, R, P1, K, G) + _align16(4 * W * WAVEFRONT_LANE_FIELDS)
            + _align16(4 * W * words_of(W)) + _align16(4 * words_of(G))
            + _align16(4 * (W + 1)) + _align16(4 * words_of(W)) + 2 * _align16(4 * W)
            + _align16(4 * words_of(N)))


def check_smem(what: str, nbytes: int, shape: str) -> int:
    """`nbytes` of dynamic shared memory for a launch of `what`, or a
    ValueError naming them when a block cannot have that many."""
    if nbytes > SMEM_BUDGET:
        raise ValueError(
            f"{what}: {shape} needs {nbytes} bytes of dynamic shared memory a block; "
            f"the card allows {SMEM_LIMIT} a block, {STATIC_SMEM} of them kept for the "
            f"kernels' static shared memory")
    return nbytes


def _lib(name: str):
    from karpenter_tpu_torch import cuda_build

    return cuda_build.library(f"{name}_clocks" if name in _clocked else name)


@contextlib.contextmanager
def phase_clocks(name: str):
    """Within the block, the kernels of library `name` ("pack_split":
    B1 and B6 sequential; "pack_wavefront": B3 and B6 wavefront;
    "lp_ascend": B5 and split B5) launch from its phase-clock build.
    Yields `take()`, which synchronizes and returns {phase: cycles}
    summed since the last take, with "count" the steps (B1), rounds (B3)
    or iterations (B5), "spreads" the packing kernels' per-thread
    spreads, "barriers" B5's block barriers and "regions" the cycles of
    the regions inside its phases, and clears the clocks."""
    if name not in PHASES:
        raise ValueError(f"phase_clocks: no phase-clock build of {name!r}")

    def take() -> dict:
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * _CLOCK_SLOTS)()
        _raise_on(_lib(name).phase_clocks_take(buf), f"{name} phase clocks")
        out = dict(zip(PHASES[name], buf))
        out["count"] = buf[_CLOCK_SLOTS - 1]
        if name == "lp_ascend":
            out["barriers"] = buf[BARRIER_SLOT]
            out["regions"] = {k: buf[REGION_SLOT + i] for i, k in enumerate(REGIONS[name])}
        else:
            out["spreads"] = {k: (buf[hi], buf[total]) for k, (hi, total) in SPREADS.items()}
        return out

    _clocked.add(name)
    try:
        take()
        yield take
    finally:
        _clocked.discard(name)


# ---------------------------------------------------------------- plain


def _caps(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """min_r floor((alloc - used + 1e-4) / req) over the requested
    resources, clipped to [0, CAP_MAX], as int32 (`capacity` in the
    JAX kernel). Unrequested resources never bind."""
    pos = req > 0
    safe_req = torch.where(pos, req, torch.ones_like(req))
    k = torch.floor((alloc - used + 1e-4) / safe_req)
    k = torch.where(pos, k, torch.full_like(k, BIG)).amin(dim=-1)
    return k.clamp(0.0, CAP_MAX).to(torch.int32)


def _prefix_take_ref(k: torch.Tensor, remaining: int) -> torch.Tensor:
    """take_i = clip(remaining - sum_{j<i} k_j, 0, k_i) for k >= 0.

    The JAX kernel saturates a uint32 scan at `remaining`; for
    non-negative capacities min(a + b, r) chained is min(prefix, r),
    so an exact int64 prefix clamped at r gives the same takes."""
    rem = max(int(remaining), 0)
    kc = torch.clamp(k.to(torch.int64), max=rem)
    prefix = (torch.cumsum(kc, 0) - kc).clamp(max=rem)
    return torch.minimum(rem - prefix, kc).to(torch.int32)


class _Problem:
    """The inputs of one plain-version run, with what both plain
    versions derive from them once (reservation slots, the extended
    reservation caps, the starting reservation use)."""

    def __init__(self, compat, group_req, group_count, cfg_alloc, cfg_pool,
                 pool_overhead, bound_compat, bound_alloc, bound_used0,
                 bound_slot, bound_live, cfg_price, max_free, mode,
                 bound_quota, cfg_rsv, rsv_cap, group_cap, conflict):
        dev = compat.device
        f32, i32 = torch.float32, torch.int32
        self.dev = dev
        self.compat, self.group_req, self.cfg_alloc = compat, group_req, cfg_alloc
        self.cfg_pool, self.pool_overhead, self.cfg_price = cfg_pool, pool_overhead, cfg_price
        self.bound_compat, self.bound_alloc = bound_compat, bound_alloc
        self.bound_used0, self.bound_live = bound_used0, bound_live
        self.group_cap, self.conflict, self.mode = group_cap, conflict, mode
        self.bound_quota = None if bound_quota is None else bound_quota.to(i32)
        self.G, self.C = compat.shape
        self.R = group_req.shape[1]
        self.B = bound_alloc.shape[0]
        self.F = int(max_free)
        self.N = self.B + self.F
        self.counts = group_count.tolist()
        self.big = torch.tensor(BIG, dtype=f32, device=dev)
        self.cap_max = torch.tensor(CAP_MAX, dtype=f32, device=dev)
        if cfg_rsv is None:
            cfg_rsv = torch.full((self.C,), -1, dtype=i32, device=dev)
        if rsv_cap is None:
            rsv_cap = torch.zeros((0,), dtype=f32, device=dev)
        self.K = K = rsv_cap.shape[0]
        self.capped = cfg_rsv >= 0
        self.rsv_cap_ext = torch.cat([rsv_cap.to(f32), self.big[None]])
        self.cfg_slot = torch.where(
            self.capped, cfg_rsv, torch.full_like(cfg_rsv, K)).long()
        # bound rows on capped columns consumed their reservation budget
        # when they were opened or planned
        self.rsv_used0 = torch.zeros((K + 1,), dtype=f32, device=dev)
        self.rsv_used0.index_add_(
            0, bound_slot.long(), ((bound_live & (bound_slot < K)).to(f32)))
        # pool_overhead[cfg_pool] with -1 (pseudo-config) reading the
        # last row, as JAX's negative indexing does
        self.oh_cfg = pool_overhead[cfg_pool.long()]


def _row_caps(p: _Problem, g, req, row, free_mask, free_used, bound_used, assign):
    """Capacity of every row for group g on the current state, after the
    quota, group-cap and conflict clamps (the bound and fresh blocks of
    the JAX body). Returns (k [B+F] int32, okf [F, C], kmat [F, C])."""
    B = p.B
    blocked = None
    if p.conflict is not None:
        blocked = ((assign > 0) & p.conflict[g][None, :]).any(dim=1)

    # ---- bound rows: one config each
    kb = _caps(p.bound_alloc, bound_used, req)
    ok_b = p.bound_compat[g] & p.bound_live & (kb >= 1)
    kb = kb * ok_b
    if p.bound_quota is not None:
        kb = torch.minimum(kb, p.bound_quota[:, g])
    if p.group_cap is not None:
        kb = torch.minimum(kb, (p.group_cap[g] - assign[:B, g]).clamp(min=0))
    if blocked is not None:
        kb = torch.where(blocked[:B], torch.zeros_like(kb), kb)

    # ---- fresh rows: multi-config masks, [F, C, R]
    kmat = _caps(p.cfg_alloc[None, :, :], free_used[:, None, :], req)
    okf = free_mask & row[None, :] & (kmat >= 1)
    pinned = free_mask & p.capped[None, :]
    is_pinned = pinned.any(dim=1)
    pin_ok = (okf & pinned).any(dim=1)
    okf = okf & torch.where(is_pinned, pin_ok, torch.ones_like(pin_ok))[:, None]
    kmat = kmat * okf
    kf = torch.where(is_pinned, (kmat * pinned).amax(dim=1), kmat.amax(dim=1))
    if p.group_cap is not None:
        kf = torch.minimum(kf, (p.group_cap[g] - assign[B:, g]).clamp(min=0))
    if blocked is not None:
        kf = torch.where(blocked[B:], torch.zeros_like(kf), kf)
    return torch.cat([kb, kf]), okf, kmat


def _fits_fresh(p: _Problem, req, row):
    """Configs a fresh node of their pool can hold one pod of the group
    on, after the pool's overhead."""
    return (row & (p.oh_cfg <= p.cfg_alloc - req[None, :]).all(dim=-1)
            & (p.cfg_pool >= 0))


def _open_pick(p: _Problem, g, req, fresh_ok):
    """One bulk open's choice: the lowest pool among the configs that
    can open, then the column c* (ffd: most capacity, a reserved column
    cheaper than every uncapped one first; cost: least price per pod).
    Returns (mask, overhead, kfo, c_star, m_star)."""
    chosen_pool = int(torch.where(
        fresh_ok, p.cfg_pool, torch.full_like(p.cfg_pool, INT_BIG)).min())
    mask = fresh_ok & (p.cfg_pool == chosen_pool)
    overhead = p.pool_overhead[chosen_pool]
    kfo = _caps(p.cfg_alloc, overhead[None, :], req) * mask
    if p.mode == "cost":
        ppp = torch.where(
            kfo >= 1, p.cfg_price / kfo.clamp(min=1).to(torch.float32), p.big)
        c_star = int(torch.argmin(ppp))
    else:
        kf_ok = kfo >= 1
        min_uncapped = torch.where(kf_ok & ~p.capped, p.cfg_price, p.big).min()
        res_mask = kf_ok & p.capped & (p.cfg_price < min_uncapped)
        if bool(res_mask.any()):
            c_star = int(torch.argmax(
                torch.where(res_mask, kfo, torch.full_like(kfo, -1))))
        else:
            c_star = int(torch.argmax(kfo))
    m_star = max(int(kfo[c_star]), 1)
    if p.group_cap is not None:
        m_star = min(max(int(p.group_cap[g]), 1), m_star)
    return mask, overhead, kfo, c_star, m_star


def _open_mask(p: _Problem, mask, kfo, c_star: int, fill: int):
    """The config mask of a node opened with `fill` pods: the pool's
    uncapped columns that hold the fill, plus c* itself when capped."""
    out = mask & ~p.capped & (kfo >= fill)
    if bool(p.capped[c_star]):
        out[c_star] = True
    return out


def pack_split_ref(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", bound_quota=None,
    cfg_rsv=None, rsv_cap=None, group_cap=None, conflict=None,
    on_group=None,
):
    """Plain version of B1 (same arguments and outputs as the JAX
    `pack_split`): returns (assign [B+F, G] int32, free_mask [F, C]
    bool, node_count int32 scalar, unsched [G] int32).

    `on_group(g, free_mask, node_count)`, when given, is called at the
    start of each group with demand, on the state that group starts
    from; it must not modify it (it is for counting a run's work)."""
    p = _Problem(compat, group_req, group_count, cfg_alloc, cfg_pool,
                 pool_overhead, bound_compat, bound_alloc, bound_used0,
                 bound_slot, bound_live, cfg_price, max_free, mode,
                 bound_quota, cfg_rsv, rsv_cap, group_cap, conflict)
    dev = p.dev
    f32, i32 = torch.float32, torch.int32
    G, C, R, B, F, N = p.G, p.C, p.R, p.B, p.F, p.N
    free_mask = torch.zeros((F, C), dtype=torch.bool, device=dev)
    free_used = torch.zeros((F, R), dtype=f32, device=dev)
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    rsv_used = p.rsv_used0.clone()
    bound_used = bound_used0.clone()
    rsv_cap_ext, cfg_slot = p.rsv_cap_ext, p.cfg_slot
    node_count = B

    for g in range(G):
        remaining = int(p.counts[g])
        if remaining <= 0:
            # no demand: every take is 0 and no node opens, so the
            # group leaves the state exactly as it found it
            continue
        if on_group is not None:
            on_group(g, free_mask, node_count)
        req = group_req[g]
        row = compat[g]
        k, okf, kmat = _row_caps(p, g, req, row, free_mask, free_used,
                                 bound_used, assign)

        # ---- unified prefix fill: bound rows precede fresh rows
        take = _prefix_take_ref(k, remaining)
        take_b = take[:B]
        take_f = take[B:]
        touched_f = take_f > 0
        free_mask = torch.where(
            touched_f[:, None], okf & (kmat >= take_f[:, None]), free_mask
        )
        bound_used = bound_used + take_b[:, None].to(f32) * req[None, :]
        free_used = free_used + take_f[:, None].to(f32) * req[None, :]
        assign[:, g] += take
        remaining -= int(take.sum())

        # ---- bulk open on the fresh axis
        if remaining > 0:
            fits_fresh = _fits_fresh(p, req, row)
            while True:
                fresh_ok = fits_fresh & (rsv_used[cfg_slot] < rsv_cap_ext[cfg_slot])
                if not (remaining > 0 and node_count < N
                        and bool(fresh_ok.any())):
                    break
                mask, overhead, kfo, c_star, m_star = _open_pick(p, g, req, fresh_ok)
                slot = int(cfg_slot[c_star])
                cap_left = torch.minimum(rsv_cap_ext[slot] - rsv_used[slot], p.cap_max)
                q = min((remaining - 1) // m_star + 1, N - node_count)
                q = min(q, int(cap_left.clamp(min=0.0).to(i32)))
                q = max(q, 1)
                rem_last = min(max(remaining - (q - 1) * m_star, 1), m_star)
                lo = node_count - B
                last = lo + q - 1
                free_mask[lo:last] = _open_mask(p, mask, kfo, c_star, m_star)
                free_mask[last] = _open_mask(p, mask, kfo, c_star, rem_last)
                m_f = torch.tensor(float(m_star), dtype=f32, device=dev)
                r_f = torch.tensor(float(rem_last), dtype=f32, device=dev)
                free_used[lo:last] = overhead + m_f * req
                free_used[last] = overhead + r_f * req
                assign[B + lo:B + last, g] += m_star
                assign[B + last, g] += rem_last
                node_count += q
                remaining -= (q - 1) * m_star + rem_last
                rsv_used[slot] += torch.tensor(float(q), dtype=f32, device=dev)
        unsched[g] += max(remaining, 0)

    return (assign, free_mask,
            torch.tensor(node_count, dtype=i32, device=dev), unsched)


class _Plan:
    """One wavefront lane's plan: what group g would do on the round's
    pre-round state, with its opens slot-relative."""
    __slots__ = ("g", "take", "okf", "kmat", "touched", "dep", "row",
                 "spill", "opens", "n_open", "spend", "capped_spend",
                 "clamped", "unsched_add", "open_union", "offset")


def _plan_lane(p: _Problem, g, free_mask, free_used, bound_used, assign,
               rsv_used, node_count) -> _Plan:
    """`plan_one` of the JAX wavefront kernel: the sequential body's
    capacity, fill and open arithmetic on the pre-round state, with the
    opens kept as (q, fill, rem_last, full mask, last mask, full used,
    last used) runs at slot-relative positions, the reservation use of
    the lane in `spend`, and whether the node axis ever bound an open
    (`clamped`)."""
    f32, i32 = torch.float32, torch.int32
    dev, N, K = p.dev, p.N, p.K
    req = p.group_req[g]
    row = p.compat[g]
    remaining = int(p.counts[g])
    k, okf, kmat = _row_caps(p, g, req, row, free_mask, free_used, bound_used, assign)
    take = _prefix_take_ref(k, remaining)
    rem = remaining - int(take.sum())
    spill = rem > 0

    # ---- fresh-open plan, slot-relative
    fits_fresh = _fits_fresh(p, req, row)
    spend = torch.zeros((K + 1,), dtype=f32, device=dev)

    def can_open():
        return fits_fresh & ((rsv_used + spend)[p.cfg_slot] < p.rsv_cap_ext[p.cfg_slot])

    opens = []
    n_open = 0
    clamped = False
    open_union = torch.zeros((p.C,), dtype=torch.bool, device=dev)
    while True:
        fresh_ok = can_open()
        if not (rem > 0 and bool(fresh_ok.any()) and node_count + n_open < N):
            break
        rsv_now = rsv_used + spend
        mask, overhead, kfo, c_star, m_star = _open_pick(p, g, req, fresh_ok)
        slot = int(p.cfg_slot[c_star])
        cap_left = torch.minimum(p.rsv_cap_ext[slot] - rsv_now[slot], p.cap_max)
        axis_left = N - (node_count + n_open)
        # the min() terms commute: split off the axis to see whether it
        # was ever the binding constraint (a clamped plan cannot survive
        # an index shift)
        q_noaxis = min((rem - 1) // m_star + 1, int(cap_left.clamp(min=0.0).to(i32)))
        q = max(min(q_noaxis, axis_left), 1)
        clamped = clamped or max(q_noaxis, 1) > axis_left
        rem_last = min(max(rem - (q - 1) * m_star, 1), m_star)
        full = _open_mask(p, mask, kfo, c_star, m_star)
        last = _open_mask(p, mask, kfo, c_star, rem_last)
        m_f = torch.tensor(float(m_star), dtype=f32, device=dev)
        r_f = torch.tensor(float(rem_last), dtype=f32, device=dev)
        opens.append((q, m_star, rem_last, full, last,
                      overhead + m_f * req, overhead + r_f * req))
        open_union |= last
        if q > 1:
            open_union |= full
        n_open += q
        rem -= (q - 1) * m_star + rem_last
        spend[slot] += torch.tensor(float(q), dtype=f32, device=dev)
    # leaving the loop with demand left and a willing config means the
    # node axis was full: that decision too read node_count
    clamped = clamped or (rem > 0 and bool(can_open().any()))

    pl = _Plan()
    touched = take > 0
    hit = torch.nonzero(touched)
    last_row = int(hit[-1]) if hit.numel() else -1
    node_idx = torch.arange(N, device=dev)
    pl.g, pl.take, pl.okf, pl.kmat, pl.touched, pl.row = g, take, okf, kmat, touched, row
    pl.dep = (k > 0) & (spill | (node_idx <= last_row))
    pl.spill, pl.opens, pl.n_open, pl.spend = spill, opens, n_open, spend
    pl.capped_spend = bool((spend[:K] > 0).any()) if K else False
    pl.clamped, pl.unsched_add, pl.open_union = clamped, max(rem, 0), open_union
    return pl


def pack_split_wavefront_ref(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", width: int = 8,
    bound_quota=None, cfg_rsv=None, rsv_cap=None, group_cap=None,
    conflict=None,
):
    """Plain version of B3 (arguments and outputs as the JAX
    `pack_split_wavefront`): B1's function in rounds. Each round plans
    the next `width` uncommitted groups against the same pre-round
    state, accepts the longest prefix of plans that commute with the
    accepted ones before them, and commits those. Returns (assign,
    free_mask, node_count, unsched, steps int32 scalar, widths [G]
    int32), the first four equal to `pack_split_ref`'s.

    The lanes are planned in order and the acceptance scan stops at the
    first rejection; a lane's acceptance reads only the plans before
    it, so the lanes after a rejection, which the JAX kernel plans and
    discards, are not planned here."""
    p = _Problem(compat, group_req, group_count, cfg_alloc, cfg_pool,
                 pool_overhead, bound_compat, bound_alloc, bound_used0,
                 bound_slot, bound_live, cfg_price, max_free, mode,
                 bound_quota, cfg_rsv, rsv_cap, group_cap, conflict)
    dev = p.dev
    f32, i32 = torch.float32, torch.int32
    G, C, R, B, F, N, W = p.G, p.C, p.R, p.B, p.F, p.N, int(width)
    free_mask = torch.zeros((F, C), dtype=torch.bool, device=dev)
    free_used = torch.zeros((F, R), dtype=f32, device=dev)
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    rsv_used = p.rsv_used0.clone()
    bound_used = bound_used0.clone()
    node_count = B
    done = [c <= 0 for c in p.counts]
    steps = 0
    widths = [0] * G

    while not all(done) and steps < G:
        # ---- candidates: the first W uncommitted groups, index order
        cand = [g for g in range(G) if not done[g]][:W]
        # ---- plan and accept, lane by lane
        accepted: list[_Plan] = []
        acc_touched = torch.zeros((N,), dtype=torch.bool, device=dev)
        acc_open = torch.zeros((C,), dtype=torch.bool, device=dev)
        acc_capped = False
        shift = 0
        for g in cand:
            pl = _plan_lane(p, g, free_mask, free_used, bound_used, assign,
                            rsv_used, node_count)
            indep = not bool((acc_touched & pl.dep).any()) and not bool(
                (pl.row & acc_open).any())
            spill_ok = not pl.spill or (not acc_capped and (
                shift == 0
                or (not pl.clamped and node_count + shift + pl.n_open <= N)))
            if not (indep and spill_ok):
                break
            pl.offset = node_count + shift
            acc_touched |= pl.touched
            acc_open |= pl.open_union
            acc_capped = acc_capped or pl.capped_spend
            shift += pl.n_open
            accepted.append(pl)

        # ---- commit: accepted plans write pairwise-disjoint rows, so
        # applying them one after another equals the JAX kernel's
        # single scatter bit for bit
        spend = torch.zeros((p.K + 1,), dtype=f32, device=dev)
        for pl in accepted:
            g = pl.g
            req = group_req[g]
            take_b, take_f = pl.take[:B], pl.take[B:]
            free_mask = torch.where(
                (take_f > 0)[:, None], pl.okf & (pl.kmat >= take_f[:, None]),
                free_mask)
            bound_used = bound_used + take_b[:, None].to(f32) * req[None, :]
            free_used = free_used + take_f[:, None].to(f32) * req[None, :]
            assign[:, g] += pl.take
            lo = pl.offset - B
            for q, m_star, rem_last, full, last, used_full, used_last in pl.opens:
                end = lo + q - 1
                free_mask[lo:end] |= full
                free_mask[end] |= last
                free_used[lo:end] += used_full
                free_used[end] += used_last
                assign[B + lo:B + end, g] += m_star
                assign[B + end, g] += rem_last
                lo += q
            spend = spend + pl.spend
            unsched[g] += pl.unsched_add
            done[g] = True
        node_count += shift
        rsv_used = rsv_used + spend
        widths[steps] = len(accepted)
        steps += 1

    return (assign, free_mask, torch.tensor(node_count, dtype=i32, device=dev),
            unsched, torch.tensor(steps, dtype=i32, device=dev),
            torch.tensor(widths, dtype=i32, device=dev))


def pack_flat_words_ref(assign, free_mask, node_count, unsched,
                        widths=None, steps=None):
    """Plain version of B2: one int32 buffer holding the uint32 words
    [assign (row-major), free_mask bit-packed (bit i of word w is
    column 32w+i), node_count, unsched], then, for a wavefront solve,
    [widths, steps]. Read it as uint32."""
    F, Cp = free_mask.shape
    W = Cp // 32
    shifts = torch.arange(32, dtype=torch.int64, device=free_mask.device)
    words = (free_mask.reshape(F, W, 32).to(torch.int64) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    parts = [
        assign.reshape(-1).to(torch.int32),
        words.reshape(-1),
        node_count.reshape(1).to(torch.int32),
        unsched.reshape(-1).to(torch.int32),
    ]
    if widths is not None:
        parts += [widths.reshape(-1).to(torch.int32), steps.reshape(1).to(torch.int32)]
    return torch.cat(parts)


def pack_split_flat_ref(*args, max_free: int, mode: str = "ffd", **kw):
    """Plain version of the JAX `pack_split_flat` (sequential route)."""
    return pack_flat_words_ref(
        *pack_split_ref(*args, max_free=max_free, mode=mode, **kw)
    )


def _over_lanes(plain, args, kw):
    """`plain` (B1's or B3's plain version) on each lane of B6's
    positional inputs `args`: lane l's demand `args[2][l]` and live
    rows `args[10][l]` in the places of group_count and bound_live. The
    outputs are stacked on a leading lane axis."""
    counts, live = args[2], args[10]
    outs = []
    for lane in range(counts.shape[0]):
        alone = list(args)
        alone[2], alone[10] = counts[lane], live[lane]
        outs.append(plain(*alone, **kw))
    return tuple(torch.stack(x) for x in zip(*outs))


def pack_probe_lanes_ref(*args, max_free: int, mode: str = "ffd", **kw):
    """Plain version of B6's sequential program: `pack_split_ref` on
    each lane. Positional arguments as `pack_split_ref`'s with
    lane_counts [L, G] and lane_live [L, B] in the places of
    group_count and bound_live; keywords cfg_rsv, rsv_cap, conflict."""
    return _over_lanes(pack_split_ref, args, dict(max_free=max_free, mode=mode, **kw))


def pack_probe_lanes_wavefront_ref(*args, max_free: int, mode: str = "ffd",
                                   width: int = 16, **kw):
    """Plain version of B6's wavefront program: `pack_split_wavefront_ref`
    on each lane (arguments as `pack_probe_lanes_ref`'s). Each lane's
    `steps` is its own round count."""
    return _over_lanes(pack_split_wavefront_ref, args,
                       dict(max_free=max_free, mode=mode, width=width, **kw))


def pack_flat_lanes_ref(assign, free_mask, node_count, unsched, widths=None,
                        steps=None):
    """Plain version of B6's lane epilogue: `pack_flat_words_ref` per
    lane, stacked into [L, row]."""
    return torch.stack([
        pack_flat_words_ref(
            assign[lane], free_mask[lane], node_count[lane], unsched[lane],
            None if widths is None else widths[lane],
            None if steps is None else steps[lane])
        for lane in range(assign.shape[0])
    ])


def pack_probe_lanes_flat_ref(*args, max_free: int, mode: str = "ffd",
                              wavefront: int = 0, **kw):
    """Plain version of the JAX `pack_probe_lanes_flat`: [L, row] int32,
    to be read as uint32, each row `pack_split_flat`'s layout for its
    lane (with the wavefront stats appended when `wavefront > 1`)."""
    if wavefront > 1:
        (assign, free_mask, node_count, unsched, steps,
         widths) = pack_probe_lanes_wavefront_ref(
            *args, max_free=max_free, mode=mode, width=wavefront, **kw)
        return pack_flat_lanes_ref(assign, free_mask, node_count, unsched,
                                   widths, steps)
    return pack_flat_lanes_ref(
        *pack_probe_lanes_ref(*args, max_free=max_free, mode=mode, **kw))


# ---------------------------------------------------------------- CUDA


def _check(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _kernel_inputs(what, mode, compat, group_req, group_count, cfg_alloc,
                  cfg_pool, pool_overhead, bound_compat, bound_alloc,
                  bound_used0, bound_slot, bound_live, cfg_price, bound_quota,
                  cfg_rsv, rsv_cap, group_cap, conflict):
    """Check the packing kernels' inputs (CUDA, contiguous, of the
    dtypes and shapes the kernels read) and return (cfg_rsv, rsv_cap)
    with their defaults filled in."""
    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    P1 = pool_overhead.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"{what}: {R} resources exceed the kernel's {MAX_RESOURCES}")
    if mode not in ("ffd", "cost"):
        raise ValueError(f"{what}: unknown mode {mode!r}")
    if cfg_rsv is None:
        cfg_rsv = torch.full((C,), -1, dtype=torch.int32, device=dev)
    if rsv_cap is None:
        rsv_cap = torch.zeros((0,), dtype=torch.float32, device=dev)
    K = rsv_cap.shape[0]
    _check(compat, "compat", torch.bool, (G, C))
    _check(group_req, "group_req", torch.float32, (G, R))
    _check(group_count, "group_count", torch.int32, (G,))
    _check(cfg_alloc, "cfg_alloc", torch.float32, (C, R))
    _check(cfg_pool, "cfg_pool", torch.int32, (C,))
    _check(pool_overhead, "pool_overhead", torch.float32, (P1, R))
    _check(bound_compat, "bound_compat", torch.bool, (G, B))
    _check(bound_alloc, "bound_alloc", torch.float32, (B, R))
    _check(bound_used0, "bound_used0", torch.float32, (B, R))
    _check(bound_slot, "bound_slot", torch.int32, (B,))
    _check(bound_live, "bound_live", torch.bool, (B,))
    _check(cfg_price, "cfg_price", torch.float32, (C,))
    _check(cfg_rsv, "cfg_rsv", torch.int32, (C,))
    _check(rsv_cap, "rsv_cap", torch.float32, (K,))
    if bound_quota is not None:
        _check(bound_quota, "bound_quota", torch.int16, (B, G))
    if group_cap is not None:
        _check(group_cap, "group_cap", torch.int32, (G,))
    if conflict is not None:
        _check(conflict, "conflict", torch.bool, (G, G))
    return cfg_rsv, rsv_cap


def _pack_split_cuda(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", bound_quota=None,
    cfg_rsv=None, rsv_cap=None, group_cap=None, conflict=None,
):
    # B1 is B6 sequential's kernel with one lane
    outs = _launch_pack_split(
        "pack_split", compat, group_req, group_count[None], cfg_alloc, cfg_pool,
        pool_overhead, bound_compat, bound_alloc, bound_used0, bound_slot,
        bound_live[None], cfg_price, max_free, mode, cfg_rsv, rsv_cap, conflict,
        bound_quota, group_cap)
    LAUNCHES["pack_split"] += 1
    return tuple(t[0] for t in outs)


def _pack_split_wavefront_cuda(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", width: int = 8,
    bound_quota=None, cfg_rsv=None, rsv_cap=None, group_cap=None,
    conflict=None,
):
    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    F = int(max_free)
    N = B + F
    W = int(width)
    P1 = pool_overhead.shape[0]
    if W < 1:
        raise ValueError(f"pack_split_wavefront: width {W} < 1")
    cfg_rsv, rsv_cap = _kernel_inputs(
        "pack_split_wavefront", mode, compat, group_req, group_count,
        cfg_alloc, cfg_pool, pool_overhead, bound_compat, bound_alloc,
        bound_used0, bound_slot, bound_live, cfg_price, bound_quota, cfg_rsv,
        rsv_cap, group_cap, conflict)
    K = rsv_cap.shape[0]

    i32 = torch.int32
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    free_mask = torch.zeros((F, C), dtype=torch.bool, device=dev)
    node_count = torch.zeros((), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    steps = torch.zeros((), dtype=i32, device=dev)
    widths = torch.zeros((G,), dtype=i32, device=dev)
    smem = check_smem("pack_split_wavefront", wavefront_smem_bytes(C, R, P1, K, W, G, N),
                      f"C={C} R={R} P1={P1} K={K} W={W} G={G} N={N}")
    scratch = wavefront_scratch((), W, G, C, R, B, F, K, dev)
    lib = _lib("pack_wavefront")
    err = lib.pack_wavefront_launch(
        _ptr(compat), _ptr(group_req), _ptr(group_count), _ptr(cfg_alloc),
        _ptr(cfg_pool), _ptr(pool_overhead), _ptr(bound_compat),
        _ptr(bound_alloc), _ptr(bound_used0), _ptr(bound_slot),
        _ptr(bound_live), _ptr(cfg_price), _ptr(bound_quota), _ptr(cfg_rsv),
        _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict),
        _ptr(assign), _ptr(free_mask), _ptr(node_count), _ptr(unsched),
        _ptr(steps), _ptr(widths), *[_ptr(t) for t in scratch],
        G, C, R, B, F, K, P1, 1 if mode == "cost" else 0, W, smem, _stream(),
    )
    DYNAMIC_SMEM["pack_split_wavefront"] = smem
    _raise_on(err, f"pack_split_wavefront (cooperative grid of {W} blocks, {smem} bytes of "
                   "shared memory a block)")
    LAUNCHES["pack_split_wavefront"] += 1
    return assign, free_mask, node_count, unsched, steps, widths


def wavefront_scratch(lead: tuple, W: int, G: int, C: int, R: int, B: int, F: int,
                      K: int, dev) -> list:
    """The wavefront kernel's scratch, each array with the leading axes
    `lead` (a lane or shard axis): the shared state (usage, the fresh
    rows' config bits), then each plan lane's row capacities and takes
    and its filled rows as bits, its reservation use, its slot-relative
    opened rows (bits, usage, fills) and their config union, its
    scalars, and its conflict words."""
    i32, f32 = torch.int32, torch.float32
    N, nw = B + F, words_pad(C)
    shapes = [
        ((F, R), f32), ((B, R), f32), ((F, nw), i32),        # free_used, bound_used, free_bits
        ((W, N), i32), ((W, N), i32), ((W, words_of(N)), i32),  # kcap, take, touched
        ((W, K + 1), f32),                                    # spend
        ((W, F, nw), i32), ((W, F, R), f32), ((W, F), i32),  # o_bits, o_used, o_fill
        ((W, nw), i32),                                       # o_union
        ((W, WAVEFRONT_LANE_FIELDS), i32), ((W, words_of(W)), i32),  # lane, conf
    ]
    return [torch.empty(lead + shape, dtype=dt, device=dev) for shape, dt in shapes]


def _pack_flat_words_cuda(assign, free_mask, node_count, unsched,
                          widths=None, steps=None):
    # B2 is the lane epilogue with one lane
    lane = [None if t is None else t[None] for t in
            (assign, free_mask, node_count, unsched, widths, steps)]
    out = _launch_pack_flat("pack_flat_words", *lane)
    LAUNCHES["pack_split_flat"] += 1
    return out[0]


def _lane_inputs(what, mode, compat, group_req, lane_counts, cfg_alloc,
                 cfg_pool, pool_overhead, bound_compat, bound_alloc,
                 bound_used0, bound_slot, lane_live, cfg_price, cfg_rsv,
                 rsv_cap, conflict, bound_quota=None, group_cap=None):
    """`_kernel_inputs` for the lane kernels: the per-lane demand
    [L, G] and live rows [L, B], the shared inputs as B1 takes them.
    Returns (L, cfg_rsv, rsv_cap)."""
    G = compat.shape[0]
    B = bound_alloc.shape[0]
    L = lane_counts.shape[0] if lane_counts.dim() == 2 else 0
    if L < 1:
        raise ValueError(f"{what}: lane_counts must be [L, G] with L >= 1, "
                         f"got {tuple(lane_counts.shape)}")
    _check(lane_counts, "lane_counts", torch.int32, (L, G))
    _check(lane_live, "lane_live", torch.bool, (L, B))
    # one lane's rows stand in for B1's group_count and bound_live
    cfg_rsv, rsv_cap = _kernel_inputs(
        what, mode, compat, group_req, lane_counts[0], cfg_alloc, cfg_pool,
        pool_overhead, bound_compat, bound_alloc, bound_used0, bound_slot,
        lane_live[0], cfg_price, bound_quota, cfg_rsv, rsv_cap, group_cap,
        conflict)
    return L, cfg_rsv, rsv_cap


def _launch_pack_split(
    what, compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
    max_free, mode, cfg_rsv, rsv_cap, conflict, bound_quota=None,
    group_cap=None,
):
    """Launch pack_split.cu's kernel over L lanes, a block each, and
    return its outputs with a leading lane axis."""
    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    F = int(max_free)
    P1 = pool_overhead.shape[0]
    L, cfg_rsv, rsv_cap = _lane_inputs(
        what, mode, compat, group_req, lane_counts, cfg_alloc, cfg_pool,
        pool_overhead, bound_compat, bound_alloc, bound_used0, bound_slot,
        lane_live, cfg_price, cfg_rsv, rsv_cap, conflict, bound_quota,
        group_cap)
    K = rsv_cap.shape[0]

    i32, f32 = torch.int32, torch.float32
    assign = torch.zeros((L, B + F, G), dtype=i32, device=dev)
    free_mask = torch.zeros((L, F, C), dtype=torch.bool, device=dev)
    node_count = torch.zeros((L,), dtype=i32, device=dev)
    unsched = torch.zeros((L, G), dtype=i32, device=dev)
    smem = check_smem(what, table_smem_bytes(C, R, P1, K, G),
                      f"C={C} R={R} P1={P1} K={K} G={G}")
    # scratch, one slice per lane: per-row usage, the fresh rows' config
    # bits, per-row capacity (then take)
    scratch = [
        torch.empty((L, F, R), dtype=f32, device=dev),        # free_used
        torch.empty((L, B, R), dtype=f32, device=dev),        # bound_used
        torch.empty((L, F, words_pad(C)), dtype=i32, device=dev),  # free_bits
        torch.empty((L, B + F), dtype=i32, device=dev),       # kcap
    ]
    lib = _lib("pack_split")
    err = lib.pack_split_launch(
        _ptr(compat), _ptr(group_req), _ptr(lane_counts), _ptr(cfg_alloc),
        _ptr(cfg_pool), _ptr(pool_overhead), _ptr(bound_compat),
        _ptr(bound_alloc), _ptr(bound_used0), _ptr(bound_slot),
        _ptr(lane_live), _ptr(cfg_price), _ptr(bound_quota), _ptr(cfg_rsv),
        _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict),
        _ptr(assign), _ptr(free_mask), _ptr(node_count), _ptr(unsched),
        *[_ptr(t) for t in scratch],
        G, C, R, B, F, K, P1, 1 if mode == "cost" else 0, L, smem, _stream(),
    )
    _raise_on(err, f"{what} ({L} blocks, one a lane, {smem} bytes of shared memory)")
    DYNAMIC_SMEM[what] = smem
    return assign, free_mask, node_count, unsched


def _pack_probe_lanes_cuda(
    compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
    max_free: int, mode: str = "ffd", cfg_rsv=None, rsv_cap=None,
    conflict=None,
):
    outs = _launch_pack_split(
        "pack_probe_lanes", compat, group_req, lane_counts, cfg_alloc, cfg_pool,
        pool_overhead, bound_compat, bound_alloc, bound_used0, bound_slot,
        lane_live, cfg_price, max_free, mode, cfg_rsv, rsv_cap, conflict)
    LAUNCHES["pack_probe_lanes"] += 1
    return outs


def _pack_probe_lanes_wavefront_cuda(
    compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
    max_free: int, mode: str = "ffd", width: int = 16, cfg_rsv=None,
    rsv_cap=None, conflict=None,
):
    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    F = int(max_free)
    N = B + F
    W = int(width)
    P1 = pool_overhead.shape[0]
    if W < 1:
        raise ValueError(f"pack_probe_lanes_wavefront: width {W} < 1")
    L, cfg_rsv, rsv_cap = _lane_inputs(
        "pack_probe_lanes_wavefront", mode, compat, group_req, lane_counts,
        cfg_alloc, cfg_pool, pool_overhead, bound_compat, bound_alloc,
        bound_used0, bound_slot, lane_live, cfg_price, cfg_rsv, rsv_cap,
        conflict)
    K = rsv_cap.shape[0]

    i32 = torch.int32
    assign = torch.zeros((L, N, G), dtype=i32, device=dev)
    free_mask = torch.zeros((L, F, C), dtype=torch.bool, device=dev)
    node_count = torch.zeros((L,), dtype=i32, device=dev)
    unsched = torch.zeros((L, G), dtype=i32, device=dev)
    steps = torch.zeros((L,), dtype=i32, device=dev)
    widths = torch.zeros((L, G), dtype=i32, device=dev)
    smem = check_smem("pack_probe_lanes_wavefront",
                      wavefront_smem_bytes(C, R, P1, K, W, G, N),
                      f"C={C} R={R} P1={P1} K={K} W={W} G={G} N={N}")
    # B3's state and plan scratch, one slice per lane
    scratch = wavefront_scratch((L,), W, G, C, R, B, F, K, dev)
    clusters = ctypes.c_int(0)
    lib = _lib("pack_wavefront")
    err = lib.pack_probe_wavefront_launch(
        _ptr(compat), _ptr(group_req), _ptr(lane_counts), _ptr(cfg_alloc),
        _ptr(cfg_pool), _ptr(pool_overhead), _ptr(bound_compat),
        _ptr(bound_alloc), _ptr(bound_used0), _ptr(bound_slot),
        _ptr(lane_live), _ptr(cfg_price), _ptr(cfg_rsv), _ptr(rsv_cap),
        _ptr(conflict), _ptr(assign), _ptr(free_mask), _ptr(node_count),
        _ptr(unsched), _ptr(steps), _ptr(widths), *[_ptr(t) for t in scratch],
        G, C, R, B, F, K, P1, 1 if mode == "cost" else 0, W, L, smem,
        ctypes.byref(clusters), _stream(),
    )
    ACTIVE_CLUSTERS[W] = clusters.value
    DYNAMIC_SMEM["pack_probe_lanes_wavefront"] = smem
    _raise_on(err, f"pack_probe_lanes_wavefront ({L} clusters of {W} blocks; "
                   f"the card holds {clusters.value} such clusters at once)")
    LAUNCHES["pack_probe_lanes_wavefront"] += 1
    return assign, free_mask, node_count, unsched, steps, widths


def _launch_pack_flat(what, assign, free_mask, node_count, unsched,
                      widths=None, steps=None):
    """Launch pack_flat.cu's kernel over L lanes: inputs with a leading
    lane axis, output [L, row]."""
    from karpenter_tpu_torch import cuda_build

    L, N, G = assign.shape
    F, C = free_mask.shape[1:]
    if C % 32:
        raise ValueError(f"{what}: {C} mask columns are not a multiple of 32")
    if (widths is None) != (steps is None):
        raise ValueError(f"{what}: widths and steps come together")
    _check(assign, "assign", torch.int32, (L, N, G))
    _check(free_mask, "free_mask", torch.bool, (L, F, C))
    _check(node_count, "node_count", torch.int32, (L,))
    _check(unsched, "unsched", torch.int32, (L, G))
    if widths is not None:
        _check(widths, "widths", torch.int32, (L, G))
        _check(steps, "steps", torch.int32, (L,))
    if free_mask.data_ptr() % 16:
        raise ValueError(f"{what}: free_mask must be 16-byte aligned")
    n_row = N * G + F * (C // 32) + 1 + G + (0 if widths is None else G + 1)
    out = torch.empty((L, n_row), dtype=torch.int32, device=assign.device)
    lib = cuda_build.library("pack_flat")
    err = lib.pack_flat_launch(
        _ptr(assign), _ptr(free_mask), _ptr(node_count), _ptr(unsched),
        _ptr(widths), _ptr(steps), _ptr(out), N, G, F, C, L, _stream(),
    )
    _raise_on(err, what)
    return out


def _pack_flat_lanes_cuda(assign, free_mask, node_count, unsched,
                          widths=None, steps=None):
    out = _launch_pack_flat("pack_flat_lanes", assign, free_mask, node_count,
                            unsched, widths, steps)
    LAUNCHES["pack_probe_lanes_flat"] += 1
    return out


# ---------------------------------------------------------------- wrappers


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU
    tensors only); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def pack_split(*args, max_free: int, mode: str = "ffd", **kw):
    """B1. Arguments and outputs as `pack_split_ref`; CUDA tensors run
    the kernel (one launch for the whole group loop)."""
    if _route(args[0], "pack_split"):
        return _pack_split_cuda(*args, max_free=max_free, mode=mode, **kw)
    return pack_split_ref(*args, max_free=max_free, mode=mode, **kw)


def pack_split_wavefront(*args, max_free: int, mode: str = "ffd",
                         width: int = 8, **kw):
    """B3. Arguments and outputs as `pack_split_wavefront_ref`; CUDA
    tensors run the kernel (one cooperative launch of `width` blocks
    for all rounds; raises if the card cannot hold them at once)."""
    if _route(args[0], "pack_split_wavefront"):
        return _pack_split_wavefront_cuda(
            *args, max_free=max_free, mode=mode, width=width, **kw)
    return pack_split_wavefront_ref(
        *args, max_free=max_free, mode=mode, width=width, **kw)


def pack_flat_words(assign, free_mask, node_count, unsched, widths=None,
                    steps=None):
    """B2. Outputs as `pack_flat_words_ref`; CUDA tensors run the
    kernel."""
    if _route(assign, "pack_split_flat"):
        return _pack_flat_words_cuda(assign, free_mask, node_count, unsched,
                                     widths, steps)
    return pack_flat_words_ref(assign, free_mask, node_count, unsched,
                               widths, steps)


def pack_split_flat(*args, max_free: int, mode: str = "ffd",
                    wavefront: int = 0, **kw):
    """The JAX package's `pack_split_flat`, as one int32 buffer to be
    read as uint32: B1 then B2, or with `wavefront > 1` B3 at that
    width then B2 with B3's widths and round count appended."""
    if wavefront > 1:
        (assign, free_mask, node_count, unsched, steps,
         widths) = pack_split_wavefront(
            *args, max_free=max_free, mode=mode, width=wavefront, **kw)
        return pack_flat_words(assign, free_mask, node_count, unsched,
                               widths, steps)
    return pack_flat_words(*pack_split(*args, max_free=max_free, mode=mode, **kw))


def pack_probe_lanes(*args, max_free: int, mode: str = "ffd", **kw):
    """B6, sequential program. Arguments and outputs as
    `pack_probe_lanes_ref`; CUDA tensors run the kernel (one launch,
    one block a lane)."""
    if _route(args[0], "pack_probe_lanes"):
        return _pack_probe_lanes_cuda(*args, max_free=max_free, mode=mode, **kw)
    return pack_probe_lanes_ref(*args, max_free=max_free, mode=mode, **kw)


def pack_probe_lanes_wavefront(*args, max_free: int, mode: str = "ffd",
                               width: int = 16, **kw):
    """B6, wavefront program. Arguments and outputs as
    `pack_probe_lanes_wavefront_ref`; CUDA tensors run the kernel (one
    launch, one cluster of `width` blocks a lane; raises if the card
    can hold no such cluster)."""
    if _route(args[0], "pack_probe_lanes_wavefront"):
        return _pack_probe_lanes_wavefront_cuda(
            *args, max_free=max_free, mode=mode, width=width, **kw)
    return pack_probe_lanes_wavefront_ref(
        *args, max_free=max_free, mode=mode, width=width, **kw)


def pack_flat_lanes(assign, free_mask, node_count, unsched, widths=None,
                    steps=None):
    """B6's lane epilogue. Outputs as `pack_flat_lanes_ref`; CUDA
    tensors run the kernel."""
    if _route(assign, "pack_flat_lanes"):
        return _pack_flat_lanes_cuda(assign, free_mask, node_count, unsched,
                                     widths, steps)
    return pack_flat_lanes_ref(assign, free_mask, node_count, unsched,
                               widths, steps)


def pack_probe_lanes_flat(*args, max_free: int, mode: str = "ffd",
                          wavefront: int = 0, **kw):
    """The JAX package's `pack_probe_lanes_flat`, as one [L, row] int32
    buffer to be read as uint32: B6's sequential program then the lane
    epilogue, or with `wavefront > 1` the wavefront program at that
    width then the epilogue with each lane's widths and round count.
    Positional arguments as `pack_split`'s, with `lane_counts` [L, G]
    and `lane_live` [L, B] in place of group_count and bound_live;
    keywords cfg_rsv, rsv_cap and conflict."""
    if wavefront > 1:
        (assign, free_mask, node_count, unsched, steps,
         widths) = pack_probe_lanes_wavefront(
            *args, max_free=max_free, mode=mode, width=wavefront, **kw)
        return pack_flat_lanes(assign, free_mask, node_count, unsched,
                               widths, steps)
    return pack_flat_lanes(
        *pack_probe_lanes(*args, max_free=max_free, mode=mode, **kw))
