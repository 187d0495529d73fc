"""B7, the dense packing kernel, with its plain PyTorch version.

`pack` replaces `karpenter_tpu/solver/pack.py::pack`: the serial
first-fit-decreasing walk over pod groups on ONE node axis of
`max_nodes` rows, each row a config mask. Existing (or LP-planned)
nodes enter as the first E rows of `existing_mask`; rows pre-opened on
a capped config debit their reservation up front. Per group: the
[N, C] capacity, the pinned-row admission, the quota / group-cap /
conflict clamps, the prefix fill over every feasible row in index
order, then the bulk open of fresh rows config by config while the
reservation budgets allow. `pack_flat` replaces the JAX `pack_flat`:
`pack`'s outputs in one 32-bit buffer, B2's layout with every row's
mask bit-packed (`pack_split.pack_flat_words_ref` with the whole node
axis as its mask rows).

B1 (`pack_split`) computes the same function with the one-hot rows
split out into a per-row block; on such inputs the two agree (the
dense ≡ split oracle of tests/test_pack_split_equivalence.py).

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it launches the hand-written kernel
(`karpenter_tpu_torch/csrc/pack_dense.cu`: B1's group step on the one
node axis) or raises; there is no fallback. `pack_flat` is one launch:
it allocates the flat buffer zeroed and the kernel writes its regions in
place (the assignment, the node count and the unschedulable tallies as
its outputs, each row's mask words at the end). `LAUNCHES` counts
kernel launches per wrapper. B7 runs one block, of 256 threads for a
short node axis and 1024 for a long one (`block_threads`);
`forced_threads` launches it at any of `BLOCK_SIZES`, for timing.

The plain version follows the JAX body step by step, in float32 and in
the same order of operations, so its outputs are byte-identical to the
JAX kernel's and to the CUDA kernel's; every pick is an
index-tie-broken arg-reduction.
"""

from __future__ import annotations

import contextlib

import torch

from karpenter_tpu_torch.solver.pack_split import (
    DYNAMIC_SMEM,
    MAX_RESOURCES,
    _caps,
    _check,
    _fits_fresh,
    _lib,
    _open_mask,
    _open_pick,
    _prefix_take_ref,
    _Problem,
    _budget,
    _ptr,
    _raise_on,
    _route,
    _stream,
    _zeroed,
    flat_layout,
    pack_flat_words_ref,
    placement_args,
    placement_text,
    table_placement,
    words_pad,
)

# kernel launches per wrapper (plain-version calls never count): B7
# launched by `pack` counts under "pack", by `pack_flat` (one launch,
# in place) under "pack_flat"; a launch whose tables spill past the
# shared-memory budget also counts under "pack_global"
LAUNCHES = {"pack": 0, "pack_global": 0, "pack_flat": 0}

# B7's block sizes (`pack_dense_launch`): 256 threads run the chunked
# step (`sweep_take_chunked`), 1024 B1's (`sweep_take`). A node
# axis of at most SMALL_ROWS rows (`entry()`'s 128) takes 256, a longer
# one 1024: on an NVIDIA H100 at 700 W each size is the faster on its
# own side (PERF.md §6).
BLOCK_SIZES = (256, 1024)
SMALL_ROWS = 256
_threads: list = [None]  # forced_threads' size, else None (the rule)


def block_threads(N: int) -> int:
    """The block size of a B7 launch on N rows."""
    return _threads[0] or (256 if N <= SMALL_ROWS else 1024)


@contextlib.contextmanager
def forced_threads(n: int):
    """Within the block, B7 launches at `n` threads (one of
    `BLOCK_SIZES`) whatever the node axis: to time the sizes on one
    problem."""
    if n not in BLOCK_SIZES:
        raise ValueError(f"pack: no B7 instantiation at {n} threads")
    old = _threads[0]
    _threads[0] = int(n)
    try:
        yield
    finally:
        _threads[0] = old


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------- plain


def _problem(compat, group_req, group_count, cfg_alloc, cfg_pool,
             pool_overhead, cfg_price, max_nodes, mode, cfg_rsv, rsv_cap,
             group_cap, conflict) -> _Problem:
    """B1's problem with an empty bound block: what the open picks read
    (pools, overheads, prices, reservation slots and caps)."""
    dev = compat.device
    G = compat.shape[0]
    R = group_req.shape[1]
    f32 = torch.float32
    return _Problem(
        compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
        torch.zeros((G, 0), dtype=torch.bool, device=dev),
        torch.zeros((0, R), dtype=f32, device=dev),
        torch.zeros((0, R), dtype=f32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.bool, device=dev),
        cfg_price, max_nodes, mode, None, cfg_rsv, rsv_cap, group_cap,
        conflict)


def pack_ref(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    existing_mask, existing_used, cfg_price, *, max_nodes: int,
    mode: str = "ffd", quota=None, cfg_rsv=None, rsv_cap=None,
    group_cap=None, conflict=None, on_group=None,
):
    """Plain version of B7 (same arguments and outputs as the JAX
    `pack`): returns (assign [N, G] int32, node_mask [N, C] bool,
    node_used [N, R] float32, node_active [N] bool, node_count int32
    scalar, unsched [G] int32), N = max_nodes.

    `on_group(g, node_mask, node_count)`, when given, is called at the
    start of each group with demand, on the state that group starts
    from; it must not modify it (it is for counting a run's work)."""
    N = int(max_nodes)
    E = existing_mask.shape[0]
    if N < E:
        raise ValueError(f"pack: max_nodes {N} < {E} existing rows")
    p = _problem(compat, group_req, group_count, cfg_alloc, cfg_pool,
                 pool_overhead, cfg_price, N, mode, cfg_rsv, rsv_cap,
                 group_cap, conflict)
    dev = p.dev
    f32, i32 = torch.float32, torch.int32
    G, C, R = p.G, p.C, p.R
    if quota is not None:
        quota = quota.to(i32)  # shipped int16, compared int32
    node_mask = torch.zeros((N, C), dtype=torch.bool, device=dev)
    node_mask[:E] = existing_mask
    node_used = torch.zeros((N, R), dtype=f32, device=dev)
    node_used[:E] = existing_used
    node_active = torch.zeros((N,), dtype=torch.bool, device=dev)
    node_active[:E] = existing_mask.any(dim=1)
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    capped, cfg_slot, rsv_cap_ext = p.capped, p.cfg_slot, p.rsv_cap_ext
    # rows pre-opened on a capped config consume that reservation's
    # budget up front
    rsv_used = torch.zeros((p.K + 1,), dtype=f32, device=dev)
    rsv_used.index_add_(0, cfg_slot, existing_mask.to(f32).sum(dim=0) * capped)
    no_take = torch.zeros((N, 1), dtype=f32, device=dev)
    node_count = E

    for g in range(G):
        remaining = int(p.counts[g])
        req = group_req[g]
        if remaining <= 0:
            # every take is 0 and no node opens; only the usage update
            # (used + 0 * req) of the JAX body touches the state
            node_used = node_used + no_take * req[None, :]
            continue
        if on_group is not None:
            on_group(g, node_mask, node_count)
        row = compat[g]

        # [N, C] capacity; feasibility is kmat >= 1 on the row's mask
        kmat = _caps(cfg_alloc[None, :, :], node_used[:, None, :], req)
        ok = node_mask & row[None, :] & (kmat >= 1)
        # a row pinned to a capped column admits only groups that
        # column holds, and only up to that column's capacity
        pinned = node_mask & capped[None, :]
        is_pinned = pinned.any(dim=1)
        pin_ok = (ok & pinned).any(dim=1)
        ok = ok & torch.where(is_pinned, pin_ok, torch.ones_like(pin_ok))[:, None]
        kmat = kmat * ok
        k = torch.where(is_pinned, (kmat * pinned).amax(dim=1), kmat.amax(dim=1))
        if quota is not None:
            k = torch.minimum(k, quota[:, g])
        if group_cap is not None:
            k = torch.minimum(k, (group_cap[g] - assign[:, g]).clamp(min=0))
        if conflict is not None:
            blocked = ((assign > 0) & conflict[g][None, :]).any(dim=1)
            k = torch.where(blocked, torch.zeros_like(k), k)

        take = _prefix_take_ref(k, remaining)
        touched = take > 0
        node_mask = torch.where(
            touched[:, None], ok & (kmat >= take[:, None]), node_mask)
        node_used = node_used + take[:, None].to(f32) * req[None, :]
        assign[:, g] += take
        remaining -= int(take.sum())

        # bulk open, config by config, while reservation budgets allow
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
                lo = node_count
                last = lo + q - 1
                node_mask[lo:last] = _open_mask(p, mask, kfo, c_star, m_star)
                node_mask[last] = _open_mask(p, mask, kfo, c_star, rem_last)
                m_f = torch.tensor(float(m_star), dtype=f32, device=dev)
                r_f = torch.tensor(float(rem_last), dtype=f32, device=dev)
                node_used[lo:last] = overhead + m_f * req
                node_used[last] = overhead + r_f * req
                node_active[lo:last + 1] = True
                assign[lo:last, g] += m_star
                assign[last, g] += rem_last
                node_count += q
                remaining -= (q - 1) * m_star + rem_last
                rsv_used[slot] += torch.tensor(float(q), dtype=f32, device=dev)
        unsched[g] += max(remaining, 0)

    return (assign, node_mask, node_used, node_active,
            torch.tensor(node_count, dtype=i32, device=dev), unsched)


def pack_flat_ref(*args, max_nodes: int, mode: str = "ffd", **kw):
    """Plain version of the JAX `pack_flat`: one int32 buffer (read it
    as uint32) of [assign (row-major), node_mask bit-packed 32 columns
    to a word, node_count, unsched]."""
    _flat_columns(args[0].shape[1])
    assign, node_mask, _, _, node_count, unsched = pack_ref(
        *args, max_nodes=max_nodes, mode=mode, **kw)
    return pack_flat_words_ref(assign, node_mask, node_count, unsched)


def _flat_columns(C: int) -> None:
    if C % 32:
        raise ValueError(f"pack_flat: {C} configs are not a multiple of 32 "
                         "(the mask packs 32 columns to a word)")


# ---------------------------------------------------------------- CUDA


def _pack_cuda(
    compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
    existing_mask, existing_used, cfg_price, *, max_nodes: int,
    mode: str = "ffd", quota=None, cfg_rsv=None, rsv_cap=None,
    group_cap=None, conflict=None, flat: bool = False,
):
    """One launch of B7. Returns `pack`'s six outputs, or with `flat`
    `pack_flat`'s buffer, which the kernel writes in place."""
    what = "pack_flat" if flat else "pack"
    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    E = existing_mask.shape[0]
    N = int(max_nodes)
    P1 = pool_overhead.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"{what}: {R} resources exceed the kernel's {MAX_RESOURCES}")
    if mode not in ("ffd", "cost"):
        raise ValueError(f"{what}: unknown mode {mode!r}")
    if N < E:
        raise ValueError(f"{what}: max_nodes {N} < {E} existing rows")
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
    _check(existing_mask, "existing_mask", torch.bool, (E, C))
    _check(existing_used, "existing_used", torch.float32, (E, R))
    _check(cfg_price, "cfg_price", torch.float32, (C,))
    _check(cfg_rsv, "cfg_rsv", torch.int32, (C,))
    _check(rsv_cap, "rsv_cap", torch.float32, (K,))
    if quota is not None:
        _check(quota, "quota", torch.int16, (N, G))
    if group_cap is not None:
        _check(group_cap, "group_cap", torch.int32, (G,))
    if conflict is not None:
        _check(conflict, "conflict", torch.bool, (G, G))

    i32, f32 = torch.int32, torch.float32
    # scratch: the rows' mask words (on 16 bytes), their usage (pack's
    # node_used output), their capacities then takes, and the existing
    # rows' one config; the kernel writes all of it
    nw = words_pad(C)
    scratch = torch.empty((N * (nw + R + 1) + E,), dtype=i32, device=dev)
    free_bits = scratch[:N * nw]
    node_used = scratch[N * nw:N * (nw + R)].view(f32).view(N, R)
    kcap, row_cfg = scratch[N * (nw + R):N * (nw + R + 1)], scratch[N * (nw + R + 1):]
    if flat:
        # pack_flat's buffer: assign, the mask words (C / 32 a row), the
        # node count and the unschedulable tallies, zeroed in one fill
        lay = flat_layout(1, N, G, N, C, False)
        buf = torch.zeros((lay["row"],), dtype=i32, device=dev)
        base = buf.data_ptr()
        outs = [base, 0, node_used.data_ptr(), 0, base + 4 * lay["count"],
                base + 4 * lay["unsched"], free_bits.data_ptr(), kcap.data_ptr(),
                row_cfg.data_ptr(), base + 4 * lay["words"]]
    else:
        assign, node_mask, node_active, node_count, unsched = _zeroed(dev, (
            ((N, G), i32), ((N, C), torch.bool), ((N,), torch.bool), ((), i32), ((G,), i32)))
        outs = [t.data_ptr() for t in (assign, node_mask, node_used, node_active, node_count,
                                       unsched, free_bits, kcap, row_cfg)] + [0]
    lay_t = table_placement(C, R, P1, K, G, budget=_budget[0])
    offsets, tables, per = placement_args(lay_t, 1, dev)
    threads = block_threads(N)
    err = _lib("pack_dense").pack_dense_launch(
        _ptr(compat), _ptr(group_req), _ptr(group_count), _ptr(cfg_alloc),
        _ptr(cfg_pool), _ptr(pool_overhead), _ptr(existing_mask),
        _ptr(existing_used), _ptr(cfg_price), _ptr(quota), _ptr(cfg_rsv),
        _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict), *outs,
        G, C, R, E, N, K, P1, 1 if mode == "cost" else 0, lay_t["smem"], threads, offsets,
        _ptr(tables), per, _stream(),
    )
    _raise_on(err, f"{what} (one block of {threads} threads, G={G} C={C} R={R} E={E} N={N}, "
                   f"{placement_text(lay_t)})")
    DYNAMIC_SMEM["pack"] = placement_text(lay_t)
    LAUNCHES[what] += 1
    if lay_t["spilled"]:
        LAUNCHES["pack_global"] += 1
    if flat:
        return buf
    return assign, node_mask, node_used, node_active, node_count, unsched


def barrier_probe(n: int, threads: int) -> None:
    """Launch one block of `threads` (one of `BLOCK_SIZES`) that takes
    `n` block barriers in a row and does nothing else: `chip_smoke.py`
    times it for the cost of one barrier (the floor of B7's chain of
    steps). Not counted: it is no part of a solve."""
    sink = torch.empty((1,), dtype=torch.int32, device="cuda")
    _raise_on(_lib("pack_dense").pack_dense_barrier_probe_launch(
        int(n), int(threads), _ptr(sink), _stream()), "pack_dense_barrier_probe")


# ---------------------------------------------------------------- wrappers


def pack(*args, max_nodes: int, mode: str = "ffd", **kw):
    """B7. Arguments and outputs as `pack_ref` (the JAX `pack`'s);
    CUDA tensors run the kernel (one launch for the whole group loop)."""
    if _route(args[0], "pack"):
        return _pack_cuda(*args, max_nodes=max_nodes, mode=mode, **kw)
    return pack_ref(*args, max_nodes=max_nodes, mode=mode, **kw)


def pack_flat(*args, max_nodes: int, mode: str = "ffd", **kw):
    """The JAX `pack_flat`, as one int32 buffer to be read as uint32
    (`pack_flat_ref`'s layout). CUDA tensors run B7 once, writing the
    buffer in place. The config axis must be a multiple of 32."""
    _flat_columns(args[0].shape[1])
    if _route(args[0], "pack_flat"):
        return _pack_cuda(*args, max_nodes=max_nodes, mode=mode, flat=True, **kw)
    return pack_flat_ref(*args, max_nodes=max_nodes, mode=mode, **kw)
