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
(`karpenter_tpu_torch/csrc/pack_dense.cu`; `pack_flat`'s epilogue is a
second launch, of B2's `csrc/pack_flat.cu`) or raises; there is no
fallback. `LAUNCHES` counts kernel launches per wrapper.

The plain version follows the JAX body step by step, in float32 and in
the same order of operations, so its outputs are byte-identical to the
JAX kernel's and to the CUDA kernel's; every pick is an
index-tie-broken arg-reduction.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.solver.pack_split import (
    DYNAMIC_SMEM,
    MAX_RESOURCES,
    _caps,
    _check,
    _fits_fresh,
    _launch_pack_flat,
    _open_mask,
    _open_pick,
    _prefix_take_ref,
    _Problem,
    _ptr,
    _raise_on,
    _route,
    _stream,
    check_smem,
    pack_flat_words_ref,
    table_smem_bytes,
)

# kernel launches per wrapper (plain-version calls never count); a
# `pack_flat` call launches B7 (counted under "pack") and its epilogue
LAUNCHES = {"pack": 0, "pack_flat": 0}


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
    group_cap=None, conflict=None,
):
    from karpenter_tpu_torch import cuda_build

    dev = compat.device
    G, C = compat.shape
    R = group_req.shape[1]
    E = existing_mask.shape[0]
    N = int(max_nodes)
    P1 = pool_overhead.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"pack: {R} resources exceed the kernel's {MAX_RESOURCES}")
    if mode not in ("ffd", "cost"):
        raise ValueError(f"pack: unknown mode {mode!r}")
    if N < E:
        raise ValueError(f"pack: max_nodes {N} < {E} existing rows")
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
    assign = torch.zeros((N, G), dtype=i32, device=dev)
    node_mask = torch.zeros((N, C), dtype=torch.bool, device=dev)
    node_used = torch.zeros((N, R), dtype=f32, device=dev)
    node_active = torch.zeros((N,), dtype=torch.bool, device=dev)
    node_count = torch.zeros((), dtype=i32, device=dev)
    unsched = torch.zeros((G,), dtype=i32, device=dev)
    smem = check_smem("pack", table_smem_bytes(C, R, P1, K, G),
                      f"C={C} R={R} P1={P1} K={K} G={G}")
    # scratch: per-row capacity and take (the config tables live in the
    # block's shared memory)
    scratch = [
        torch.empty((N,), dtype=i32, device=dev),           # kcap
        torch.empty((N,), dtype=i32, device=dev),           # take
    ]
    lib = cuda_build.library("pack_dense")
    err = lib.pack_dense_launch(
        _ptr(compat), _ptr(group_req), _ptr(group_count), _ptr(cfg_alloc),
        _ptr(cfg_pool), _ptr(pool_overhead), _ptr(existing_mask),
        _ptr(existing_used), _ptr(cfg_price), _ptr(quota), _ptr(cfg_rsv),
        _ptr(rsv_cap), _ptr(group_cap), _ptr(conflict),
        _ptr(assign), _ptr(node_mask), _ptr(node_used), _ptr(node_active),
        _ptr(node_count), _ptr(unsched), *[_ptr(t) for t in scratch],
        G, C, R, E, N, K, P1, 1 if mode == "cost" else 0, smem, _stream(),
    )
    _raise_on(err, f"pack (one block, {smem} bytes of shared memory)")
    DYNAMIC_SMEM["pack"] = smem
    LAUNCHES["pack"] += 1
    return assign, node_mask, node_used, node_active, node_count, unsched


# ---------------------------------------------------------------- wrappers


def pack(*args, max_nodes: int, mode: str = "ffd", **kw):
    """B7. Arguments and outputs as `pack_ref` (the JAX `pack`'s);
    CUDA tensors run the kernel (one launch for the whole group loop)."""
    if _route(args[0], "pack"):
        return _pack_cuda(*args, max_nodes=max_nodes, mode=mode, **kw)
    return pack_ref(*args, max_nodes=max_nodes, mode=mode, **kw)


def pack_flat(*args, max_nodes: int, mode: str = "ffd", **kw):
    """The JAX `pack_flat`, as one int32 buffer to be read as uint32:
    B7, then its epilogue (`flat_words`). The config axis must be a
    multiple of 32."""
    _flat_columns(args[0].shape[1])
    assign, node_mask, _, _, node_count, unsched = pack(
        *args, max_nodes=max_nodes, mode=mode, **kw)
    return flat_words(assign, node_mask, node_count, unsched)


def flat_words(assign, node_mask, node_count, unsched):
    """`pack_flat`'s epilogue on B7's outputs: B2's layout with every
    row of the node axis a mask row. CUDA tensors run B2's kernel
    (`csrc/pack_flat.cu`), counted here under "pack_flat"."""
    if not _route(assign, "pack_flat"):
        return pack_flat_words_ref(assign, node_mask, node_count, unsched)
    out = _launch_pack_flat("pack_flat", assign[None], node_mask[None],
                            node_count[None], unsched[None])
    LAUNCHES["pack_flat"] += 1
    return out[0]
