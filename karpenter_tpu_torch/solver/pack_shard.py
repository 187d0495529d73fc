"""The packing kernels with the config axis split over S shards (B8):
B1, B3 and B2 over per-shard column blocks, with their plain versions.

Replaces the `shards > 1` staging of `karpenter_tpu/solver/pack.py::
_run_pack` (:1817-1893), where GSPMD partitions the jitted B1/B3 over a
mesh by config column and turns every reduction over configs into a
cross-device collective. Here each shard s holds the columns
[s * Cs, (s + 1) * Cs) of the config-axis inputs (compat [G, Cs],
cfg_alloc [Cs, R], cfg_pool, cfg_price and cfg_rsv [Cs]) and of the
fresh rows' masks [F, Cs], each its own allocation; the bound block,
the demand, the quotas, group_cap, conflict and rsv_cap are
replicated.

The plain versions (`*_sharded_ref`) are a second code path, not a call
to the unsharded ones: every reduction over configs is taken on each
shard's block, then the partials are combined in shard order — maxima
and ORs as they are, arg-reductions as (value, global column) pairs
under the lowest-index rule, global column = shard offset + local
column. Their results equal the unsharded solve's, which is what the
JAX package proves of its sharded solve; a wrong shard offset shows as
soon as a tie crosses a shard boundary.

The wrappers take the plain version for CPU tensors only. For CUDA
tensors they launch the split kernels (`csrc/pack_split.cu`,
`csrc/pack_wavefront.cu`, `csrc/pack_flat.cu` through
`csrc/shard_xchg.cuh`): one cooperative launch of S blocks (B3: S x W),
block s running the unsplit kernel's code on its column block with its
own replica of the replicated state (node usage, assignment, node
count, reservation use, done flags, unschedulable counts), the shards
exchanging only their partial reductions. Outputs carry a leading
replica axis of S (assign [S, N, G], node_count [S], unsched [S, G],
and for B3 steps [S], widths [S, G]); the masks come back per shard.
The plain versions return S copies of their one result.
`LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_tpu_torch.solver.pack_split import (
    BIG, CAP_MAX, DYNAMIC_SMEM, INT_BIG, _caps, _check, _kernel_inputs,
    _prefix_take_ref, _ptr, _raise_on, _route, _stream, check_smem, table_smem_bytes,
    wavefront_scratch, wavefront_smem_bytes, words_pad,
)

# kernel launches per wrapper (plain-version calls never count)
LAUNCHES = {"pack_split_sharded": 0, "pack_split_wavefront_sharded": 0,
            "pack_flat_words_sharded": 0}

def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------- plain


class _Shards:
    """The inputs of one plain split run: per-shard config-axis blocks,
    the replicated rest, and what every step derives from them once."""

    def __init__(self, compat, group_req, group_count, cfg_alloc, cfg_pool,
                 pool_overhead, bound_compat, bound_alloc, bound_used0,
                 bound_slot, bound_live, cfg_price, max_free, mode,
                 bound_quota, cfg_rsv, rsv_cap, group_cap, conflict):
        self.S = S = len(compat)
        if not (len(cfg_alloc) == len(cfg_pool) == len(cfg_price) == S):
            raise ValueError("every config-axis input needs one block a shard")
        dev = compat[0].device
        f32, i32 = torch.float32, torch.int32
        self.dev, self.mode = dev, mode
        self.compat, self.cfg_alloc, self.cfg_pool = compat, cfg_alloc, cfg_pool
        self.cfg_price, self.group_req = cfg_price, group_req
        self.pool_overhead = pool_overhead
        self.bound_compat, self.bound_alloc = bound_compat, bound_alloc
        self.bound_used0, self.bound_live = bound_used0, bound_live
        self.group_cap, self.conflict = group_cap, conflict
        self.bound_quota = None if bound_quota is None else bound_quota.to(i32)
        self.G = compat[0].shape[0]
        self.Cs = compat[0].shape[1]
        self.R = group_req.shape[1]
        self.B = bound_alloc.shape[0]
        self.F = int(max_free)
        self.N = self.B + self.F
        self.counts = group_count.tolist()
        self.big = torch.tensor(BIG, dtype=f32, device=dev)
        self.cap_max = torch.tensor(CAP_MAX, dtype=f32, device=dev)
        if rsv_cap is None:
            rsv_cap = torch.zeros((0,), dtype=f32, device=dev)
        if cfg_rsv is None:
            cfg_rsv = [torch.full((self.Cs,), -1, dtype=i32, device=dev)
                       for _ in range(S)]
        self.K = K = rsv_cap.shape[0]
        self.rsv_cap_ext = torch.cat([rsv_cap.to(f32), self.big[None]])
        self.capped = [r >= 0 for r in cfg_rsv]
        self.cfg_slot = [torch.where(r >= 0, r, torch.full_like(r, K)).long()
                         for r in cfg_rsv]
        self.rsv_used0 = torch.zeros((K + 1,), dtype=f32, device=dev)
        self.rsv_used0.index_add_(
            0, bound_slot.long(), (bound_live & (bound_slot < K)).to(f32))
        self.oh_cfg = [pool_overhead[p.long()] for p in cfg_pool]
        # global column of each shard's first column
        self.c0 = [s * self.Cs for s in range(S)]


def _arg_pick(parts, better):
    """Combine per-shard (value, global column) picks in shard order
    under the lowest-index rule: a pick replaces the running one when
    its value is `better`, or equal at a lower global column."""
    best = None
    for val, col in parts:
        if best is None or better(val, best[0]) or (val == best[0] and col < best[1]):
            best = (val, col)
    return best


def _row_caps_sharded(p: _Shards, g, req, free_mask, free_used, bound_used, assign):
    """`_row_caps` with the fresh rows' config reductions per shard:
    each shard's partial (any pinned config, any pinned config that
    holds a pod, the largest capacity over the ok configs and over the
    ok pinned ones) combined over shards. Returns (k [B+F], okf per
    shard, kmat per shard)."""
    B = p.B
    blocked = None
    if p.conflict is not None:
        blocked = ((assign > 0) & p.conflict[g][None, :]).any(dim=1)
    kb = _caps(p.bound_alloc, bound_used, req)
    ok_b = p.bound_compat[g] & p.bound_live & (kb >= 1)
    kb = kb * ok_b
    if p.bound_quota is not None:
        kb = torch.minimum(kb, p.bound_quota[:, g])
    if p.group_cap is not None:
        kb = torch.minimum(kb, (p.group_cap[g] - assign[:B, g]).clamp(min=0))
    if blocked is not None:
        kb = torch.where(blocked[:B], torch.zeros_like(kb), kb)

    okf, kmat, pinned = [], [], []
    any_pin = pin_ok = None
    max_ok = max_pin = None
    for s in range(p.S):
        km = _caps(p.cfg_alloc[s][None, :, :], free_used[:, None, :], req)
        ok = free_mask[s] & p.compat[s][g][None, :] & (km >= 1)
        pn = free_mask[s] & p.capped[s][None, :]
        part = ((pn.any(dim=1), (ok & pn).any(dim=1),
                 (km * ok).amax(dim=1), (km * (ok & pn)).amax(dim=1)))
        if s == 0:
            any_pin, pin_ok, max_ok, max_pin = part
        else:
            any_pin, pin_ok = any_pin | part[0], pin_ok | part[1]
            max_ok = torch.maximum(max_ok, part[2])
            max_pin = torch.maximum(max_pin, part[3])
        okf.append(ok)
        kmat.append(km)
        pinned.append(pn)
    keep = torch.where(any_pin, pin_ok, torch.ones_like(pin_ok))[:, None]
    okf = [ok & keep for ok in okf]
    kmat = [km * ok for km, ok in zip(kmat, okf)]
    kf = torch.where(any_pin, max_pin, max_ok)
    if p.group_cap is not None:
        kf = torch.minimum(kf, (p.group_cap[g] - assign[B:, g]).clamp(min=0))
    if blocked is not None:
        kf = torch.where(blocked[B:], torch.zeros_like(kf), kf)
    return torch.cat([kb, kf]), okf, kmat


def _fits_fresh_sharded(p: _Shards, req, g):
    return [p.compat[s][g] & (p.oh_cfg[s] <= p.cfg_alloc[s] - req[None, :]).all(dim=-1)
            & (p.cfg_pool[s] >= 0) for s in range(p.S)]


def _open_pick_sharded(p: _Shards, g, req, fresh_ok):
    """`_open_pick` over shards: the lowest pool (a min over each
    shard's), then c* from each shard's (value, global column) pick,
    combined under the lowest-index rule. Returns (mask per shard,
    overhead, kfo per shard, c_star global, m_star, c_star's shard)."""
    pools = [int(torch.where(ok, p.cfg_pool[s],
                             torch.full_like(p.cfg_pool[s], INT_BIG)).min())
             for s, ok in enumerate(fresh_ok)]
    chosen_pool = min(pools)
    mask = [ok & (p.cfg_pool[s] == chosen_pool) for s, ok in enumerate(fresh_ok)]
    overhead = p.pool_overhead[chosen_pool]
    kfo = [_caps(p.cfg_alloc[s], overhead[None, :], req) * mask[s] for s in range(p.S)]
    if p.mode == "cost":
        parts = []
        for s in range(p.S):
            ppp = torch.where(kfo[s] >= 1,
                              p.cfg_price[s] / kfo[s].clamp(min=1).to(torch.float32),
                              p.big)
            j = int(torch.argmin(ppp))
            parts.append((float(ppp[j]), p.c0[s] + j))
        _, c_star = _arg_pick(parts, lambda a, b: a < b)
    else:
        min_uncapped = min(
            float(torch.where((kfo[s] >= 1) & ~p.capped[s], p.cfg_price[s], p.big).min())
            for s in range(p.S))
        res = [(kfo[s] >= 1) & p.capped[s] & (p.cfg_price[s] < min_uncapped)
               for s in range(p.S)]
        if any(bool(r.any()) for r in res):
            parts = []
            for s in range(p.S):
                v = torch.where(res[s], kfo[s], torch.full_like(kfo[s], -1))
                j = int(torch.argmax(v))
                parts.append((int(v[j]), p.c0[s] + j))
        else:
            parts = []
            for s in range(p.S):
                j = int(torch.argmax(kfo[s]))
                parts.append((int(kfo[s][j]), p.c0[s] + j))
        _, c_star = _arg_pick(parts, lambda a, b: a > b)
    owner = c_star // p.Cs
    m_star = max(int(kfo[owner][c_star - p.c0[owner]]), 1)
    if p.group_cap is not None:
        m_star = min(max(int(p.group_cap[g]), 1), m_star)
    return mask, overhead, kfo, c_star, m_star, owner


def _open_mask_sharded(p: _Shards, mask, kfo, c_star: int, owner: int, fill: int):
    """Per-shard config masks of a node opened with `fill` pods."""
    out = [mask[s] & ~p.capped[s] & (kfo[s] >= fill) for s in range(p.S)]
    if bool(p.capped[owner][c_star - p.c0[owner]]):
        out[owner] = out[owner].clone()
        out[owner][c_star - p.c0[owner]] = True
    return out


def _replicas(S, *outs):
    """S copies of each output on a leading replica axis."""
    return tuple(torch.stack([o] * S) for o in outs)


def pack_split_sharded_ref(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", bound_quota=None,
    cfg_rsv=None, rsv_cap=None, group_cap=None, conflict=None,
):
    """Plain version of split B1. Arguments as `pack_split_ref`'s with
    per-shard lists for compat, cfg_alloc, cfg_pool, cfg_price and
    cfg_rsv. Returns (assign [S, B+F, G], free_mask list of [F, Cs],
    node_count [S], unsched [S, G])."""
    p = _Shards(compat, group_req, group_count, cfg_alloc, cfg_pool,
                pool_overhead, bound_compat, bound_alloc, bound_used0,
                bound_slot, bound_live, cfg_price, max_free, mode,
                bound_quota, cfg_rsv, rsv_cap, group_cap, conflict)
    dev, S = p.dev, p.S
    f32, i32 = torch.float32, torch.int32
    G, R, B, F, N = p.G, p.R, p.B, p.F, p.N
    free_mask = [torch.zeros((F, p.Cs), dtype=torch.bool, device=dev) for _ in range(S)]
    free_used = torch.zeros((F, R), dtype=f32, device=dev)
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    rsv_used = p.rsv_used0.clone()
    bound_used = bound_used0.clone()
    node_count = B
    for g in range(G):
        remaining = int(p.counts[g])
        if remaining <= 0:
            continue
        req = group_req[g]
        k, okf, kmat = _row_caps_sharded(p, g, req, free_mask, free_used,
                                         bound_used, assign)
        take = _prefix_take_ref(k, remaining)
        take_b, take_f = take[:B], take[B:]
        touched = (take_f > 0)[:, None]
        free_mask = [torch.where(touched, okf[s] & (kmat[s] >= take_f[:, None]), free_mask[s])
                     for s in range(S)]
        bound_used = bound_used + take_b[:, None].to(f32) * req[None, :]
        free_used = free_used + take_f[:, None].to(f32) * req[None, :]
        assign[:, g] += take
        remaining -= int(take.sum())
        if remaining > 0:
            fits = _fits_fresh_sharded(p, req, g)
            while True:
                fresh_ok = [fits[s] & (rsv_used[p.cfg_slot[s]] < p.rsv_cap_ext[p.cfg_slot[s]])
                            for s in range(S)]
                if not (remaining > 0 and node_count < N
                        and any(bool(ok.any()) for ok in fresh_ok)):
                    break
                mask, overhead, kfo, c_star, m_star, owner = _open_pick_sharded(
                    p, g, req, fresh_ok)
                slot = int(p.cfg_slot[owner][c_star - p.c0[owner]])
                cap_left = torch.minimum(p.rsv_cap_ext[slot] - rsv_used[slot], p.cap_max)
                q = min((remaining - 1) // m_star + 1, N - node_count)
                q = min(q, int(cap_left.clamp(min=0.0).to(i32)))
                q = max(q, 1)
                rem_last = min(max(remaining - (q - 1) * m_star, 1), m_star)
                lo = node_count - B
                last = lo + q - 1
                full_m = _open_mask_sharded(p, mask, kfo, c_star, owner, m_star)
                last_m = _open_mask_sharded(p, mask, kfo, c_star, owner, rem_last)
                for s in range(S):
                    free_mask[s][lo:last] = full_m[s]
                    free_mask[s][last] = last_m[s]
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
    assign, nc, unsched = _replicas(
        S, assign, torch.tensor(node_count, dtype=i32, device=dev), unsched)
    return assign, free_mask, nc, unsched


class _PlanS:
    __slots__ = ("g", "take", "okf", "kmat", "touched", "dep", "row",
                 "spill", "opens", "n_open", "spend", "capped_spend",
                 "clamped", "unsched_add", "open_union", "offset")


def _plan_lane_sharded(p: _Shards, g, free_mask, free_used, bound_used, assign,
                       rsv_used, node_count) -> _PlanS:
    """`_plan_lane` (the JAX wavefront kernel's `plan_one`) on the
    shards: the capacities, fill and opens with per-shard masks."""
    f32, i32 = torch.float32, torch.int32
    dev, N, K, S = p.dev, p.N, p.K, p.S
    req = p.group_req[g]
    remaining = int(p.counts[g])
    k, okf, kmat = _row_caps_sharded(p, g, req, free_mask, free_used, bound_used, assign)
    take = _prefix_take_ref(k, remaining)
    rem = remaining - int(take.sum())
    spill = rem > 0
    fits = _fits_fresh_sharded(p, req, g)
    spend = torch.zeros((K + 1,), dtype=f32, device=dev)

    def can_open():
        now = rsv_used + spend
        return [fits[s] & (now[p.cfg_slot[s]] < p.rsv_cap_ext[p.cfg_slot[s]])
                for s in range(S)]

    opens = []
    n_open = 0
    clamped = False
    open_union = [torch.zeros((p.Cs,), dtype=torch.bool, device=dev) for _ in range(S)]
    while True:
        fresh_ok = can_open()
        if not (rem > 0 and any(bool(ok.any()) for ok in fresh_ok)
                and node_count + n_open < N):
            break
        rsv_now = rsv_used + spend
        mask, overhead, kfo, c_star, m_star, owner = _open_pick_sharded(p, g, req, fresh_ok)
        slot = int(p.cfg_slot[owner][c_star - p.c0[owner]])
        cap_left = torch.minimum(p.rsv_cap_ext[slot] - rsv_now[slot], p.cap_max)
        axis_left = N - (node_count + n_open)
        q_noaxis = min((rem - 1) // m_star + 1, int(cap_left.clamp(min=0.0).to(i32)))
        q = max(min(q_noaxis, axis_left), 1)
        clamped = clamped or max(q_noaxis, 1) > axis_left
        rem_last = min(max(rem - (q - 1) * m_star, 1), m_star)
        full = _open_mask_sharded(p, mask, kfo, c_star, owner, m_star)
        last = _open_mask_sharded(p, mask, kfo, c_star, owner, rem_last)
        m_f = torch.tensor(float(m_star), dtype=f32, device=dev)
        r_f = torch.tensor(float(rem_last), dtype=f32, device=dev)
        opens.append((q, m_star, rem_last, full, last,
                      overhead + m_f * req, overhead + r_f * req))
        for s in range(S):
            open_union[s] = open_union[s] | last[s]
            if q > 1:
                open_union[s] = open_union[s] | full[s]
        n_open += q
        rem -= (q - 1) * m_star + rem_last
        spend[slot] += torch.tensor(float(q), dtype=f32, device=dev)
    clamped = clamped or (rem > 0 and any(bool(ok.any()) for ok in can_open()))

    pl = _PlanS()
    touched = take > 0
    hit = torch.nonzero(touched)
    last_row = int(hit[-1]) if hit.numel() else -1
    node_idx = torch.arange(N, device=dev)
    pl.g, pl.take, pl.okf, pl.kmat, pl.touched = g, take, okf, kmat, touched
    pl.row = [p.compat[s][g] for s in range(S)]
    pl.dep = (k > 0) & (spill | (node_idx <= last_row))
    pl.spill, pl.opens, pl.n_open, pl.spend = spill, opens, n_open, spend
    pl.capped_spend = bool((spend[:K] > 0).any()) if K else False
    pl.clamped, pl.unsched_add, pl.open_union = clamped, max(rem, 0), open_union
    return pl


def pack_split_wavefront_sharded_ref(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", width: int = 8,
    bound_quota=None, cfg_rsv=None, rsv_cap=None, group_cap=None,
    conflict=None,
):
    """Plain version of split B3 (arguments as
    `pack_split_sharded_ref`'s, plus the width). Returns (assign,
    free_mask list, node_count, unsched, steps [S], widths [S, G]). The
    conflict test's "opens a row with a config j could use" is an OR
    over each shard's columns."""
    p = _Shards(compat, group_req, group_count, cfg_alloc, cfg_pool,
                pool_overhead, bound_compat, bound_alloc, bound_used0,
                bound_slot, bound_live, cfg_price, max_free, mode,
                bound_quota, cfg_rsv, rsv_cap, group_cap, conflict)
    dev, S = p.dev, p.S
    f32, i32 = torch.float32, torch.int32
    G, R, B, F, N, W = p.G, p.R, p.B, p.F, p.N, int(width)
    free_mask = [torch.zeros((F, p.Cs), dtype=torch.bool, device=dev) for _ in range(S)]
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
        cand = [g for g in range(G) if not done[g]][:W]
        accepted: list[_PlanS] = []
        acc_touched = torch.zeros((N,), dtype=torch.bool, device=dev)
        acc_open = [torch.zeros((p.Cs,), dtype=torch.bool, device=dev) for _ in range(S)]
        acc_capped = False
        shift = 0
        for g in cand:
            pl = _plan_lane_sharded(p, g, free_mask, free_used, bound_used, assign,
                                    rsv_used, node_count)
            meets = False
            for s in range(S):
                meets = meets or bool((pl.row[s] & acc_open[s]).any())
            indep = not bool((acc_touched & pl.dep).any()) and not meets
            spill_ok = not pl.spill or (not acc_capped and (
                shift == 0
                or (not pl.clamped and node_count + shift + pl.n_open <= N)))
            if not (indep and spill_ok):
                break
            pl.offset = node_count + shift
            acc_touched |= pl.touched
            acc_open = [a | u for a, u in zip(acc_open, pl.open_union)]
            acc_capped = acc_capped or pl.capped_spend
            shift += pl.n_open
            accepted.append(pl)
        spend = torch.zeros((p.K + 1,), dtype=f32, device=dev)
        for pl in accepted:
            g = pl.g
            req = group_req[g]
            take_b, take_f = pl.take[:B], pl.take[B:]
            touched = (take_f > 0)[:, None]
            free_mask = [torch.where(touched, pl.okf[s] & (pl.kmat[s] >= take_f[:, None]),
                                     free_mask[s]) for s in range(S)]
            bound_used = bound_used + take_b[:, None].to(f32) * req[None, :]
            free_used = free_used + take_f[:, None].to(f32) * req[None, :]
            assign[:, g] += pl.take
            lo = pl.offset - B
            for q, m_star, rem_last, full, last, used_full, used_last in pl.opens:
                end = lo + q - 1
                for s in range(S):
                    free_mask[s][lo:end] |= full[s]
                    free_mask[s][end] |= last[s]
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
    assign, nc, unsched, st, wd = _replicas(
        S, assign, torch.tensor(node_count, dtype=i32, device=dev), unsched,
        torch.tensor(steps, dtype=i32, device=dev),
        torch.tensor(widths, dtype=i32, device=dev))
    return assign, free_mask, nc, unsched, st, wd


def pack_flat_words_sharded_ref(assign, free_mask, node_count, unsched,
                                widths=None, steps=None):
    """Plain version of split B2: `pack_flat_words`'s buffer from
    replica 0 of the replicated outputs and the per-shard masks. Bit i
    of mask word w of row f is global column 32w + i, read from the
    shard that owns it (mask words may straddle shards)."""
    F = free_mask[0].shape[0]
    Cs = free_mask[0].shape[1]
    Cp = Cs * len(free_mask)
    if Cp % 32:
        raise ValueError(f"pack_flat_words_sharded: {Cp} columns are not a multiple of 32")
    cols = torch.arange(Cp, device=assign.device)
    owner, local = cols // Cs, cols % Cs
    full = torch.zeros((F, Cp), dtype=torch.int64, device=assign.device)
    for s, m in enumerate(free_mask):
        sel = owner == s
        full[:, sel] = m[:, local[sel]].to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=assign.device)
    words = (full.reshape(F, Cp // 32, 32) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    parts = [assign[0].reshape(-1).to(torch.int32), words.reshape(-1),
             node_count[0].reshape(1).to(torch.int32), unsched[0].reshape(-1).to(torch.int32)]
    if widths is not None:
        parts += [widths[0].reshape(-1).to(torch.int32), steps[0].reshape(1).to(torch.int32)]
    return torch.cat(parts)


# ---------------------------------------------------------------- CUDA


def _table(tensors, dev) -> torch.Tensor:
    """A device array of the per-shard data pointers (int64)."""
    return torch.tensor([t.data_ptr() for t in tensors], dtype=torch.int64,
                        device=dev)


def _shard_inputs(what, mode, compat, group_req, group_count, cfg_alloc,
                  cfg_pool, pool_overhead, bound_compat, bound_alloc,
                  bound_used0, bound_slot, bound_live, cfg_price, bound_quota,
                  cfg_rsv, rsv_cap, group_cap, conflict):
    """Check every shard's block as the unsplit kernel would (all on one
    device, of one width) and return (S, Cs, cfg_rsv list, rsv_cap)."""
    S = len(compat)
    if S < 2:
        raise ValueError(f"{what}: a split needs at least 2 shards, got {S}")
    dev = compat[0].device
    Cs = compat[0].shape[1]
    if cfg_rsv is None:
        cfg_rsv = [torch.full((Cs,), -1, dtype=torch.int32, device=dev) for _ in range(S)]
    for s in range(S):
        if compat[s].device != dev:
            raise ValueError(f"{what}: shard {s} lies on {compat[s].device}, shard 0 on "
                             f"{dev}; the launch over several cards is not built yet "
                             "(ROADMAP item 10)")
        _, rsv_cap_s = _kernel_inputs(
            what, mode, compat[s], group_req, group_count, cfg_alloc[s], cfg_pool[s],
            pool_overhead, bound_compat, bound_alloc, bound_used0, bound_slot,
            bound_live, cfg_price[s], bound_quota, cfg_rsv[s], rsv_cap, group_cap,
            conflict)
    return S, Cs, cfg_rsv, rsv_cap_s


def _xchg_scratch(groups: int, S: int, words: int, dev):
    """The exchange's slots ([groups, 2, S, words] 64-bit words, double-
    buffered by parity) and its arrival counters (zeroed)."""
    slots = torch.empty((groups, 2, S, max(words, 4)), dtype=torch.int64, device=dev)
    arrive = torch.zeros((groups,), dtype=torch.int32, device=dev)
    return slots, arrive


def _pack_split_sharded_cuda(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", bound_quota=None,
    cfg_rsv=None, rsv_cap=None, group_cap=None, conflict=None,
):
    from karpenter_tpu_torch import cuda_build

    S, Cs, cfg_rsv, rsv_cap = _shard_inputs(
        "pack_split_sharded", mode, compat, group_req, group_count, cfg_alloc,
        cfg_pool, pool_overhead, bound_compat, bound_alloc, bound_used0,
        bound_slot, bound_live, cfg_price, bound_quota, cfg_rsv, rsv_cap,
        group_cap, conflict)
    dev = compat[0].device
    G = compat[0].shape[0]
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    F = int(max_free)
    N = B + F
    K = rsv_cap.shape[0]
    P1 = pool_overhead.shape[0]
    i32, f32 = torch.int32, torch.float32
    assign = torch.zeros((S, N, G), dtype=i32, device=dev)
    free_mask = [torch.zeros((F, Cs), dtype=torch.bool, device=dev) for _ in range(S)]
    node_count = torch.zeros((S,), dtype=i32, device=dev)
    unsched = torch.zeros((S, G), dtype=i32, device=dev)
    smem = check_smem("pack_split_sharded", table_smem_bytes(Cs, R, P1, K, G),
                      f"Cs={Cs} R={R} P1={P1} K={K} G={G}")
    # each replica's state (its columns' bits too), on a leading shard axis
    scratch = [
        torch.empty((S, F, R), dtype=f32, device=dev),        # free_used
        torch.empty((S, B, R), dtype=f32, device=dev),        # bound_used
        torch.empty((S, F, words_pad(Cs)), dtype=i32, device=dev),  # free_bits
        torch.empty((S, N), dtype=i32, device=dev),           # kcap
    ]
    slots, arrive = _xchg_scratch(1, S, F, dev)
    tables = [_table(x, dev) for x in (compat, cfg_alloc, cfg_pool, cfg_price,
                                         cfg_rsv, free_mask)]
    lib = cuda_build.library("pack_split")
    err = lib.pack_split_sharded_launch(
        *[_ptr(t) for t in tables],
        _ptr(group_req), _ptr(group_count), _ptr(pool_overhead), _ptr(bound_compat),
        _ptr(bound_alloc), _ptr(bound_used0), _ptr(bound_slot), _ptr(bound_live),
        _ptr(bound_quota), _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict),
        _ptr(assign), _ptr(node_count), _ptr(unsched), *[_ptr(t) for t in scratch],
        _ptr(slots), _ptr(arrive),
        G, Cs, R, B, F, K, P1, 1 if mode == "cost" else 0, S, slots.shape[-1], smem,
        _stream(),
    )
    _raise_on(err, f"pack_split_sharded (cooperative grid of {S} blocks, {smem} bytes of "
                   "shared memory a block)")
    DYNAMIC_SMEM["pack_split_sharded"] = smem
    LAUNCHES["pack_split_sharded"] += 1
    return assign, free_mask, node_count, unsched


def _pack_split_wavefront_sharded_cuda(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
    cfg_price, max_free: int, mode: str = "ffd", width: int = 8,
    bound_quota=None, cfg_rsv=None, rsv_cap=None, group_cap=None,
    conflict=None,
):
    from karpenter_tpu_torch import cuda_build

    S, Cs, cfg_rsv, rsv_cap = _shard_inputs(
        "pack_split_wavefront_sharded", mode, compat, group_req, group_count,
        cfg_alloc, cfg_pool, pool_overhead, bound_compat, bound_alloc,
        bound_used0, bound_slot, bound_live, cfg_price, bound_quota, cfg_rsv,
        rsv_cap, group_cap, conflict)
    W = int(width)
    if W < 1:
        raise ValueError(f"pack_split_wavefront_sharded: width {W} < 1")
    dev = compat[0].device
    G = compat[0].shape[0]
    R = group_req.shape[1]
    B = bound_alloc.shape[0]
    F = int(max_free)
    N = B + F
    K = rsv_cap.shape[0]
    P1 = pool_overhead.shape[0]
    i32 = torch.int32
    assign = torch.zeros((S, N, G), dtype=i32, device=dev)
    free_mask = [torch.zeros((F, Cs), dtype=torch.bool, device=dev) for _ in range(S)]
    node_count = torch.zeros((S,), dtype=i32, device=dev)
    unsched = torch.zeros((S, G), dtype=i32, device=dev)
    steps = torch.zeros((S,), dtype=i32, device=dev)
    widths = torch.zeros((S, G), dtype=i32, device=dev)
    smem = check_smem("pack_split_wavefront_sharded",
                      wavefront_smem_bytes(Cs, R, P1, K, W, G, N),
                      f"Cs={Cs} R={R} P1={P1} K={K} W={W} G={G} N={N}")
    # each replica's state and plan scratch (its columns' bits too), on a
    # leading shard axis
    scratch = wavefront_scratch((S,), W, G, Cs, R, B, F, K, dev)
    # one exchange group per plan lane: the S blocks planning it
    slots, arrive = _xchg_scratch(W, S, max(F, W), dev)
    tables = [_table(x, dev) for x in (compat, cfg_alloc, cfg_pool, cfg_price,
                                         cfg_rsv, free_mask)]
    per_sm = ctypes.c_int(0)
    sms = ctypes.c_int(0)
    lib = cuda_build.library("pack_wavefront")
    err = lib.pack_wavefront_sharded_launch(
        *[_ptr(t) for t in tables],
        _ptr(group_req), _ptr(group_count), _ptr(pool_overhead), _ptr(bound_compat),
        _ptr(bound_alloc), _ptr(bound_used0), _ptr(bound_slot), _ptr(bound_live),
        _ptr(bound_quota), _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict),
        _ptr(assign), _ptr(node_count), _ptr(unsched), _ptr(steps), _ptr(widths),
        *[_ptr(t) for t in scratch], _ptr(slots), _ptr(arrive),
        G, Cs, R, B, F, K, P1, 1 if mode == "cost" else 0, W, S, slots.shape[-1], smem,
        ctypes.byref(per_sm), ctypes.byref(sms), _stream(),
    )
    DYNAMIC_SMEM["pack_split_wavefront_sharded"] = smem
    if per_sm.value * sms.value < S * W:
        raise RuntimeError(
            f"pack_split_wavefront_sharded: {S} shards x {W} lanes need {S * W} "
            f"co-resident blocks of 1024 threads; the card holds {per_sm.value} a "
            f"multiprocessor x {sms.value} multiprocessors = {per_sm.value * sms.value}")
    _raise_on(err, f"pack_split_wavefront_sharded (cooperative grid of {S} x {W} blocks)")
    LAUNCHES["pack_split_wavefront_sharded"] += 1
    return assign, free_mask, node_count, unsched, steps, widths


def _pack_flat_words_sharded_cuda(assign, free_mask, node_count, unsched,
                                  widths=None, steps=None):
    from karpenter_tpu_torch import cuda_build

    S, N, G = assign.shape
    F, Cs = free_mask[0].shape
    Cp = Cs * len(free_mask)
    if len(free_mask) != S:
        raise ValueError(f"pack_flat_words_sharded: {len(free_mask)} masks for {S} replicas")
    if Cp % 32:
        raise ValueError(f"pack_flat_words_sharded: {Cp} columns are not a multiple of 32")
    if (widths is None) != (steps is None):
        raise ValueError("pack_flat_words_sharded: widths and steps come together")
    _check(assign, "assign", torch.int32, (S, N, G))
    for s, m in enumerate(free_mask):
        _check(m, f"free_mask[{s}]", torch.bool, (F, Cs))
    _check(node_count, "node_count", torch.int32, (S,))
    _check(unsched, "unsched", torch.int32, (S, G))
    if widths is not None:
        _check(widths, "widths", torch.int32, (S, G))
        _check(steps, "steps", torch.int32, (S,))
    n_row = N * G + F * (Cp // 32) + 1 + G + (0 if widths is None else G + 1)
    dev = assign.device
    out = torch.empty((n_row,), dtype=torch.int32, device=dev)
    table = _table(free_mask, dev)
    lib = cuda_build.library("pack_flat")
    err = lib.pack_flat_sharded_launch(
        _ptr(assign), _ptr(table), _ptr(node_count), _ptr(unsched), _ptr(widths),
        _ptr(steps), _ptr(out), N, G, F, Cs, S, _stream(),
    )
    _raise_on(err, "pack_flat_words_sharded")
    LAUNCHES["pack_flat_words_sharded"] += 1
    return out


# ---------------------------------------------------------------- wrappers


def pack_split_sharded(*args, max_free: int, mode: str = "ffd", **kw):
    """Split B1. Arguments and outputs as `pack_split_sharded_ref`'s;
    CUDA tensors run one cooperative launch of S blocks."""
    if _route(args[0][0], "pack_split_sharded"):
        return _pack_split_sharded_cuda(*args, max_free=max_free, mode=mode, **kw)
    return pack_split_sharded_ref(*args, max_free=max_free, mode=mode, **kw)


def pack_split_wavefront_sharded(*args, max_free: int, mode: str = "ffd",
                                 width: int = 8, **kw):
    """Split B3. Arguments and outputs as
    `pack_split_wavefront_sharded_ref`'s; CUDA tensors run one
    cooperative launch of S x width blocks (raises, with the numbers,
    when the card cannot hold them at once)."""
    if _route(args[0][0], "pack_split_wavefront_sharded"):
        return _pack_split_wavefront_sharded_cuda(
            *args, max_free=max_free, mode=mode, width=width, **kw)
    return pack_split_wavefront_sharded_ref(
        *args, max_free=max_free, mode=mode, width=width, **kw)


def pack_flat_words_sharded(assign, free_mask, node_count, unsched, widths=None,
                            steps=None):
    """Split B2. Output as `pack_flat_words_sharded_ref`'s."""
    if _route(assign, "pack_flat_words_sharded"):
        return _pack_flat_words_sharded_cuda(assign, free_mask, node_count, unsched,
                                             widths, steps)
    return pack_flat_words_sharded_ref(assign, free_mask, node_count, unsched,
                                       widths, steps)


def pack_split_flat_sharded(*args, max_free: int, mode: str = "ffd",
                            wavefront: int = 0, **kw):
    """`pack_split_flat` with the config axis split: split B1 (or, with
    `wavefront > 1`, split B3 at that width) then split B2; the flat
    buffer is the unsharded one, read as uint32."""
    if wavefront > 1:
        (assign, free_mask, node_count, unsched, steps,
         widths) = pack_split_wavefront_sharded(
            *args, max_free=max_free, mode=mode, width=wavefront, **kw)
        return pack_flat_words_sharded(assign, free_mask, node_count, unsched,
                                       widths, steps)
    return pack_flat_words_sharded(
        *pack_split_sharded(*args, max_free=max_free, mode=mode, **kw))
