"""The config-level LP relaxation of the packing problem, solved on the
card by dual ascent, and the duals it yields for the cost race.

Copy of `karpenter_tpu/solver/lp_device.py` (the parts the cost
objective runs): maximize

    bound(lam) = lam'.count - sum_k rsv_cap[k] * mu_k(lam')

where lam' = lam / theta(lam), theta(lam) = max over uncapped configs
of Vhat_c(lam)/price_c, Vhat_c = min over valid r of
(max_g lam_g/req[g,r]) * alloc[c,r], and mu_k buys back the reserved
configs' excess. The ascent is the kernel B5 (`ascend`,
`csrc/lp_ascend.cu` on the card, its plain version `ascend_ref` on the
CPU): all iterations in one launch. The supergradient is written out by
hand with JAX's tie rules (`_supergradient`). The certificate (bound,
scaled duals, cap duals) is recomputed on the host in float64 from the
best iterate, so its validity never rests on the card's arithmetic.

`DualCertificate` turns the duals into the weak-duality bound the
consolidation probes' pruner asks (`consolidation_batch.ProbePruner`).

Knobs: KARPENTER_LP_GUIDE (default on; 0 disables guidance, trim,
the rank arm and pruning), KARPENTER_LP_ITERS (ascent iterations,
default 192), KARPENTER_LP_PRUNE_MARGIN (the pruner's margin, 0.05),
KARPENTER_LP_RANK_BETA (reduced-cost penalty weight, default 1.0),
KARPENTER_LP_PRIORITY_WEIGHT (priority fold strength, default 0.25),
KARPENTER_LP_SHARDS (the split ascent's shard count, default 0: B8's
split B5, `ascend_sharded`, when that many devices are visible).

`maybe_solve` degrades a failure of the solve to the unguided path,
as the JAX package's does: it returns None and counts
karpenter_solver_lp_total{outcome="degraded"}, so a failing LP never
blocks a solve and never fails without a count (the packing solves
underneath ride the resilience ladder). On a CUDA device it degrades
only what the ladder degrades there (`resilience.may_degrade`: an
injected fault, a deadline); a kernel that fails to build or launch,
and any other error on the card, reach the caller. `solve` itself lets
every error through. A solve under an open explain record notes its
`dual_summary` there, as the JAX package's does.
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
from karpenter_tpu_torch.metrics.store import SOLVER_LP_SOLVES
from karpenter_tpu_torch.solver.lp_plan import _fma_f32, _pad_to, priority_weights
# one copy of the env parsing, the resilience module's (as in the JAX
# package)
from karpenter_tpu_torch.solver.resilience import _env_int, may_degrade

log = logging.getLogger("karpenter.solver.lp")

_EPS = 1e-12

# kernel launches of B5 and split B5 (plain-version calls never count);
# the "_global" counts are the launches among them whose arrays did not
# all fit in shared memory (`ascent_layout`), the "_wide" counts those
# that ran the wide layout (`ascent_wide`)
LAUNCHES = {"lp_ascend": 0, "lp_ascend_global": 0, "lp_ascend_sharded": 0,
            "lp_ascend_sharded_global": 0, "lp_ascend_wide": 0,
            "lp_ascend_sharded_wide": 0}
# wrapper -> the placement of its last launch: shared-memory bytes,
# global-scratch bytes, and the arrays placed in global memory
ASCENT_SMEM: dict[str, str] = {}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled() -> bool:
    return os.environ.get("KARPENTER_LP_GUIDE", "1").strip().lower() not in (
        "0", "off", "false", "no",
    )


def iters() -> int:
    return max(8, _env_int("KARPENTER_LP_ITERS", 192))


def rank_beta() -> float:
    return max(0.0, _env_float("KARPENTER_LP_RANK_BETA", 1.0))


def prune_margin() -> float:
    """Safety margin of the consolidation pruner
    (KARPENTER_LP_PRUNE_MARGIN, default 0.05)."""
    return max(0.0, _env_float("KARPENTER_LP_PRUNE_MARGIN", 0.05))


def _cap_rows(k: int) -> int:
    """Reservation-slot row bucket of the ascent's onehot/budget inputs:
    1 for cap-free problems, else 64/512/... (the JAX package's
    buckets: padded rows count in the max reductions' ties, so the
    port pads alike)."""
    if k <= 0:
        return 1
    out = 64
    while out < k:
        out *= 8
    return out


@dataclass
class DeviceLP:
    """One certified dual solve of the packing relaxation."""

    lam: np.ndarray          # [G] float64 Farley-scaled demand duals
    mu: np.ndarray           # [K] float64 reservation-cap duals (>= 0)
    lower_bound: float       # float64-certified: lam.count - cap.mu
    theta: float             # the Farley scaling actually applied
    vhat: np.ndarray         # [C] float64 per-config value upper bound
    lam_guide: np.ndarray    # [G] float64 priority-weighted guidance duals
    iterations: int
    converged: bool
    wall_s: float
    cache_hit: bool = False


def device_lp_from_arrays(d: dict) -> DeviceLP:
    """A `DeviceLP` from the numpy fields of another run's solve (for
    example the JAX package's), so a race can be fed the same duals."""
    return DeviceLP(
        lam=np.asarray(d["lam"], np.float64),
        mu=np.asarray(d["mu"], np.float64),
        lower_bound=float(d["lower_bound"]),
        theta=float(d["theta"]),
        vhat=np.asarray(d["vhat"], np.float64),
        lam_guide=np.asarray(d["lam_guide"], np.float64),
        iterations=int(d["iterations"]),
        converged=bool(d["converged"]),
        wall_s=float(d.get("wall_s", 0.0)),
        cache_hit=bool(d.get("cache_hit", False)),
    )


# fingerprint -> DeviceLP (LRU, oldest evicted)
_cache: dict[bytes, DeviceLP] = {}
_cache_lock = threading.Lock()
_CACHE_ENTRIES = 16


def _fingerprint(enc: Encoded) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for buf in (
        enc.group_count, enc.group_req, enc.cfg_price, enc.cfg_alloc,
        np.ascontiguousarray(enc.compat), enc.cfg_pool, enc.pool_overhead,
    ):
        h.update(np.ascontiguousarray(buf).tobytes())
    for opt in (enc.cfg_rsv, enc.rsv_cap, enc.group_priority):
        h.update(
            b"\x00" if opt is None else np.ascontiguousarray(opt).tobytes()
        )
    h.update(
        f"{iters()}|{_env_float('KARPENTER_LP_PRIORITY_WEIGHT', 0.25)}"
        .encode()
    )
    return h.digest()


# ---------------------------------------------------------------- B5


def window_pad(n: int) -> tuple[int, int]:
    """XLA's CPU split of a sum over more than 32 elements: the axis is
    zero-padded to a multiple of 32, `front` zeros before it and the
    rest after, and each window of 32 is summed in order (reduce-window
    of size and stride 32); the window sums are then reduced the same
    way. Returns (windows, front)."""
    nwin = -(-n // 32)
    pad = nwin * 32 - n
    return nwin, pad // 2


def xla_sum(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Sum over the last axis in the order the JAX package's XLA program
    sums it on the CPU (float32): up to 32 elements, in index order from
    +0; beyond, in windows of 32 (`window_pad`) whose sums are reduced
    the same way. With `y`, the sum of the products x * y: up to 32
    elements the product is fused into the running sum (one multiply-
    add rounded once per step, as LLVM contracts it); beyond, each
    product is rounded before the windows sum it. The CUDA kernel sums
    in the same order, so the two are bit-identical."""
    n = x.shape[-1]
    if y is not None:
        x, y = torch.broadcast_tensors(x, y)
        if n <= 32:
            return fma_chain(x, y)
        x = x * y
    while x.shape[-1] > 32:
        nwin, front = window_pad(x.shape[-1])
        back = nwin * 32 - x.shape[-1] - front
        x = torch.cat([x.new_zeros(*x.shape[:-1], front), x,
                       x.new_zeros(*x.shape[:-1], back)], dim=-1)
        x = x.reshape(*x.shape[:-1], nwin, 32)
        w = torch.zeros_like(x[..., 0])
        for i in range(32):
            w = w + x[..., i]
        x = w
    s = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        s = s + x[..., i]
    return s


# XLA's CPU code for the bound's dot `lam_s @ count_w` (read from the
# machine code of the JAX package's `_ascend` at every n from 32 to 330
# and at the padding buckets up to 2048; x86-64 with FMA and 256-bit
# vectors). The dot outside the loop (the bound at lam0) and the one
# fused into the loop body differ in two limits: the one outside stays
# scalar below 50 terms, and LLVM unrolls its vector loop fully up to
# 14 iterations where the loop body's stops at 7. From 4096 terms on
# XLA emits both dots as a kernel of their own
# (`dot_general.*_elemental_kernel_module`): one scalar multiply-add
# chain in order (vfmadd231ss; bisected on the bound at lam0 and after
# one step, 4095 vectorized and 4096 scalar, and read at 4096).
DOT_SCALAR_BELOW = {True: 50, False: 0}
DOT_UNROLL_MAX = {True: 14, False: 7}
DOT_SCALAR_FROM = 4096


def _bit_floor(x: int) -> int:
    x = max(1, min(x, 4))
    return 1 << (x.bit_length() - 1)


def dot_plan(n: int, initial: bool) -> dict:
    """The shape of XLA's CPU code for a dot of n float32 terms
    (`xla_dot`): `scalar` (one multiply-add chain in order), or a vector
    loop of 8 lanes interleaved `ic` times (`ic` as LLVM picks it for a
    known trip count: the largest power of two up to 4 with at least one
    vector iteration, halved unless that leaves the same remainder)
    running `iters` iterations, `unrolled` fully or not; then an
    epilogue loop of `evf` lanes (8, 4 or 2: the fewest vector plus
    scalar iterations, ties to the narrower) running `eiters`
    iterations, and the last terms one by one."""
    if n < DOT_SCALAR_BELOW[initial] or n >= DOT_SCALAR_FROM:
        return dict(scalar=True)
    big, small = _bit_floor(n // 8), _bit_floor(n // 16)
    ic = big if n % (8 * big) == n % (8 * small) else small
    iters = n // (8 * ic)
    rem = n - iters * 8 * ic
    evf, eiters = 0, 0
    best = None
    for vf in (8, 4, 2):
        if rem >= vf:
            cost = rem // vf + rem % vf
            if best is None or cost <= best:
                best, evf, eiters = cost, vf, rem // vf
    return dict(scalar=False, ic=ic, iters=iters, unrolled=iters <= DOT_UNROLL_MAX[initial],
                evf=evf, eiters=eiters)


def dot_lane_order(ic: int, iters: int, unrolled: bool) -> list[list[int]]:
    """The chains of one lane of the vector loop, as 8-term chunk
    indices (chunk c holds terms 8c .. 8c + 7; lane j takes term 8c + j).
    Unrolled, LLVM's reassociation makes one chain: the first
    interleave part over the iterations in order, each later part over
    iterations 1, 0, 2, 3, ... Not unrolled, one chain a part, each over
    the iterations in order, added part by part."""
    if unrolled:
        seq = []
        for u in range(ic):
            its = list(range(iters)) if u == 0 or iters < 2 else [1, 0, *range(2, iters)]
            seq += [it * ic + u for it in its]
        return [seq]
    return [[it * ic + u for it in range(iters)] for u in range(ic)]


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The lanes of `v` added in halves (i and i + h, h = len / 2, ...)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[:h] + v[h:]
    return v[0]


def xla_dot(a: torch.Tensor, b: torch.Tensor, initial: bool = False) -> torch.Tensor:
    """a @ b over the last axis (1-D) as the JAX package's program takes
    `lam_s @ count_w` on the CPU (`dot_plan`, `dot_lane_order`):
    `initial` is the bound at lam0, outside the loop. Every product is
    fused into its add (a multiply-add); a vector lane other than lane 0
    starts from -0.0 (its first term is the rounded product), lane 0
    from +0.0; the lanes are added in halves; the epilogue's lane 0
    starts from the vector loop's sum. Bit for bit XLA's where the plan
    was read (32 <= n <= 2048, and the scalar chain from 4096; the
    buckets between, 2272 to 3550, were held through the whole ascent;
    see ROADMAP C2)."""
    n = a.shape[-1]
    p = dot_plan(n, initial)
    if p["scalar"]:
        return fma_chain(a, b)
    f32, dev = torch.float32, a.device
    ic, iters = p["ic"], p["iters"]
    start = torch.full((8,), -0.0, dtype=f32, device=dev)
    start[0] = 0.0
    parts = []
    for k, chain in enumerate(dot_lane_order(ic, iters, p["unrolled"])):
        acc = start if k == 0 else torch.full((8,), -0.0, dtype=f32, device=dev)
        for c in chain:
            acc = _fma_f32(a[8 * c:8 * c + 8], b[8 * c:8 * c + 8], acc)
        parts.append(acc)
    lanes = parts[0]
    for part in parts[1:]:
        lanes = lanes + part
    s = _tree(lanes)
    pos = iters * 8 * ic
    if p["evf"]:
        vf = p["evf"]
        acc = torch.full((vf,), -0.0, dtype=f32, device=dev)
        acc[0] = s
        for _ in range(p["eiters"]):
            acc = _fma_f32(a[pos:pos + vf], b[pos:pos + vf], acc)
            pos += vf
        s = _tree(acc)
    for i in range(pos, n):
        s = _fma_f32(a[i], b[i], s)
    return s


def fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last axis as one multiply-add chain in index
    order from +0: how XLA takes `mu @ cap_budget` on the CPU (the dot
    of a max reduction, which LLVM does not vectorize)."""
    s = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for i in range(a.shape[-1]):
        s = _fma_f32(a[..., i], b[..., i], s)
    return s


# The arrays of a B5 block (`Arr` in csrc/lp_ascend.cu, in its order of
# priority): name -> the dimensions whose product, times 4 bytes, is its
# size. "nwc" is the windows of a sum over the C configs, "gw" the 32-bit
# words of a column over the G groups, "tw" the words of a column
# maximum's tie record (1 in the 2048 layout, 2 in the wide one).
ASCENT_ARRAYS = (
    ("lam", "G"), ("ratio", "GR"), ("mm", "CR"), ("tinfo", ("C", "R", "tw")), ("qx", "CR"),
    ("uidx", "C"), ("cflag", "C"), ("alloc", "CR"), ("price", "C"), ("vh0", "C"),
    ("z", "C"), ("excess", "C"), ("dx", "C"), ("tb", "C"), ("ty", "C"),
    ("grad", "G"), ("dratio", "GR"), ("req", "GR"), ("cnt", "G"), ("cw", "G"),
    ("best", "G"), ("ncomp", "C"), ("mu", "K"), ("nm", "K"), ("ksize", "K"),
    ("budget", "K"), ("tbmask", ("nwc",)), ("ulist", "C"), ("colbits", ("C", "gw")),
    ("masks", ("G", "R", "nwc")),
)


# The wide layout's own arrays (`ExtArr` in csrc/lp_ascend.cu), placed
# after a block's: each block's maxima and tie counts of mu, its window
# sums of dtheta_b and of every d ratio row ("nwc": its windows), four
# scalar words, each window's block and place there ("nwa": the windows
# of the whole config axis), the sums of the windows of windows of its d
# ratio rows ("GS": its most groups, ceil(G / S); "W2": the windows of
# windows, at most 32); then the cluster's distinct columns: a hash of each
# of its own, its first in the cluster and then where its maxima are, a
# first's number, and the columns it takes (bits, compatible groups,
# maxima, tie records; at most its configs' count).
ASCENT_CLUSTER_ARRAYS = (
    ("mul", "K"), ("nml", "K"), ("wtb", ("nwc",)), ("ws", ("G", "R", "nwc")), ("scal", "8"),
    ("wmap", ("nwa",)), ("part", ("GS", "R", "W2")), ("uhash", "C"), ("urep", "C"),
    ("ugidx", "C"), ("obits", ("C", "gw")), ("onc", "C"), ("omm", "CR"), ("oti", ("C", "R", "tw")),
)


def _ascent_array_bytes(dims, G: int, C: int, R: int, K: int, wide: bool | None = None,
                        nwc: int | None = None, nwa: int = 0, gs: int = 0) -> int:
    nw2 = 1 if nwa <= 32 else min(32, window_pad(nwa)[0])
    size = {"G": G, "C": C, "R": R, "K": K, "8": 8, "GS": gs, "W2": nw2,
            "nwc": nwc if nwc is not None else (-(-C // 32) if C > 32 else 1),
            "nwa": nwa,
            "gw": -(-G // 32),
            "tw": 2 if (ascent_wide(G, C) if wide is None else wide) else 1}
    n = 4
    for d in dims:
        n *= size[d]
    return n


# B5's 2048 layout takes padded group and config axes up to
# ASCENT_NARROW_AXIS (`kMaxAxis` in csrc/lp_ascend.cu); past them the
# wide layout (32-bit tie records, window sums a window at a time, up to
# three levels of windows) up to ASCENT_MAX_AXIS (`kMaxWideAxis`), its
# arrays indexed in 32 bits
ASCENT_NARROW_AXIS = 2048
ASCENT_MAX_AXIS = 1 << 20
ASCENT_MAX_SLOTS = 32767


# the wide layout's most blocks a cluster (the H100's largest cluster, a
# non-portable size)
ASCENT_MAX_CLUSTER = 16


def ascent_wide(G: int, C: int) -> bool:
    """Whether B5 runs its wide layout on `G` groups and `C` configs."""
    return G > ASCENT_NARROW_AXIS or C > ASCENT_NARROW_AXIS


def ascent_cluster(G: int, C: int) -> int:
    """The blocks of the wide layout's cluster on `G` groups and `C`
    configs (0 for the 2048 layout): one a window of the config axis's
    ordered sums, up to `ASCENT_MAX_CLUSTER`."""
    if not ascent_wide(G, C):
        return 0
    return min(ASCENT_MAX_CLUSTER, window_pad(C)[0] if C > 32 else 1)


def cluster_ranges(C: int, S: int) -> list[tuple[int, int, int, int]]:
    """The (first config, end, first window, end) of each block of a
    cluster of S over C configs (`cluster_range` in csrc/lp_ascend.cu):
    the windows of the ordered sums split evenly, each block's configs
    those of its windows after XLA's front padding."""
    nw, front = window_pad(C) if C > 32 else (1, 0)
    out = []
    for b in range(S):
        w0, w1 = b * nw // S, (b + 1) * nw // S
        c1 = C if b == S - 1 else min(C, 32 * w1 - front)
        out.append((max(0, 32 * w0 - front), c1, w0, w1))
    return out


def ascent_layout(G: int, C: int, R: int, K: int, cluster: int = 0) -> dict:
    """Where a B5 block keeps each of its arrays (`Layout` in
    csrc/lp_ascend.cu): in order of priority, each (on 16 bytes) in the
    block's dynamic shared memory while the budget
    (`pack_split.SMEM_BUDGET`) holds it, else in global scratch. With
    `cluster` (the wide layout's blocks), a block's arrays at the most
    configs and windows a block of the cluster takes, then the cluster's
    own (`ASCENT_CLUSTER_ARRAYS`). Returns {"offsets": [one per array:
    the shared-memory byte offset, or ~ the scratch byte offset],
    "smem": bytes, "scratch": bytes, "global": [the arrays placed in
    global memory]}."""
    from karpenter_tpu_torch.solver.pack_split import SMEM_BUDGET, _align16

    arrays, wide, nwc, Cb, nwa = ASCENT_ARRAYS, None, None, C, 0
    if cluster:
        ranges = cluster_ranges(C, cluster)
        Cb = max(c1 - c0 for c0, c1, _, _ in ranges)
        nwc = max(w1 - w0 for _, _, w0, w1 in ranges)
        arrays, wide = ASCENT_ARRAYS + ASCENT_CLUSTER_ARRAYS, True
        nwa = window_pad(C)[0] if C > 32 else 1
    offsets, smem, scratch, spilled = [], 0, 0, []
    for name, size in arrays:
        n = _align16(_ascent_array_bytes(size, G, Cb, R, K, wide, nwc, nwa,
                                         -(-G // cluster) if cluster else 0))
        if smem + n <= SMEM_BUDGET:
            offsets.append(smem)
            smem += n
        else:
            offsets.append(~scratch)
            scratch += n
            spilled.append(name)
    return {"offsets": offsets, "smem": smem, "scratch": scratch, "global": spilled}


class AscentInputs:
    """The padded float32 inputs of B5, as tensors on one device:
    lam0, count, count_w [Gp]; compat [Gp, Cp] bool; req [Gp, R];
    alloc [Cp, R]; price [Cp]; valid [Cp, R] bool; onehot [Kp, Cp]
    bool; budget [Kp]; uncapped [Cp] bool."""

    NAMES = ("lam0", "count", "count_w", "compat", "req", "alloc", "price",
             "valid", "onehot", "budget", "uncapped")

    def __init__(self, **tensors):
        for name in self.NAMES:
            setattr(self, name, tensors[name])

    def tensors(self) -> list:
        return [getattr(self, n) for n in self.NAMES]

    def to(self, device) -> "AscentInputs":
        return AscentInputs(**{n: getattr(self, n).to(device) for n in self.NAMES})


class _Consts:
    def __init__(self, dev):
        f32 = torch.float32
        self.zero = torch.zeros((), dtype=f32, device=dev)
        self.one = torch.ones((), dtype=f32, device=dev)
        self.half = torch.full((), 0.5, dtype=f32, device=dev)
        self.inf = torch.full((), float("inf"), dtype=f32, device=dev)
        self.eps = torch.full((), _EPS, dtype=f32, device=dev)
        self.tiny = torch.full((), 1e-9, dtype=f32, device=dev)


def _forward(a: AscentInputs, lam, k: _Consts, initial: bool = False):
    """bound_w(lam) and the intermediates its supergradient reads, in
    the JAX order of operations (lp_device.py:214-237); `initial`: the
    bound at lam0, whose dot XLA compiles apart from the loop's."""
    req = a.req
    rmask = (req > 0) & (a.count > 0)[:, None]
    safe_req = torch.where(req > 0, req, k.one)
    ratio = torch.where(rmask, lam[:, None] / safe_req, k.zero)          # [G, R]
    X = torch.where(a.compat[:, :, None], ratio[:, None, :], k.zero)   # [G, C, R]
    mm = X.amax(dim=0)                                                  # [C, R]
    v = torch.where(a.valid, mm * a.alloc, k.inf)
    vh0 = v.amin(dim=1)                                                 # [C]
    finite = torch.isfinite(vh0)
    vh = torch.where(finite, vh0, k.zero)
    zsel = a.uncapped & (a.price > 0)
    pden = torch.where(a.price > k.eps, a.price, k.eps)
    z = torch.where(zsel, vh / pden, k.zero)
    theta0 = z.amax()
    theta = torch.where(theta0 > k.eps, theta0, k.eps)
    lam_s = lam / theta
    xe = vh / theta - a.price
    excess = torch.where(xe > 0, xe, k.zero)
    M = torch.where(a.onehot, excess[None, :], k.zero)                  # [K, C]
    mu = M.amax(dim=1)
    b = xla_dot(lam_s, a.count_w, initial) - fma_chain(mu, a.budget)
    return dict(safe_req=safe_req, rmask=rmask, ratio=ratio, X=X, mm=mm, v=v,
                vh0=vh0, finite=finite, vh=vh, zsel=zsel, pden=pden, z=z,
                theta0=theta0, theta=theta, xe=xe, M=M, mu=mu, b=b)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the kernel's __fsqrt_rn).
    torch.sqrt on the CPU can miss the correctly rounded result by an
    ulp, in float32 and float64 alike, so the float64 root rounded to
    float32 is corrected once against the exact squares of the two
    midpoints next to it (25-bit midpoints square exactly in float64;
    no float32 x is such a square, so there are no ties)."""
    inf = torch.full_like(x, float("inf"))
    r = torch.sqrt(x.double()).float()
    up, dn = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    xd = x.double()
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + dn.double()) * 0.5
    return torch.where(hi * hi < xd, up,
                       torch.where((lo > 0) & (lo * lo > xd), dn, r))


def _tie_weight(x, ans, k: _Consts):
    """JAX's cotangent share of `x` in maximum(x, c) = ans: 1 where x
    alone attains the max, 0.5 at an exact tie with the constant, 0
    below it (`_balanced_eq`)."""
    return torch.where(x > ans, k.one, torch.where(x == ans, k.half, k.zero))


def _supergradient(a: AscentInputs, lam, f: dict, k: _Consts):
    """d bound_w / d lam, written out with JAX's tie rules: a max or
    min reduction splits its cotangent evenly over every element equal
    to the result (padding and masked zeros included), maximum and clip
    give each side half at an exact tie, and where(isfinite(vh), vh, 0)
    passes the cotangent only where vh is finite. The sums over an axis
    are taken in XLA's order (`xla_sum`), with XLA's association of the
    products it sums (dtheta's: (count_w * inv_t2) * lam)."""
    theta = f["theta"]
    inv_t2 = k.one / (theta * theta)
    dlam_a = a.count_w / theta
    dtheta_a = -xla_sum(a.count_w * inv_t2, lam)
    # mu = max_c where(onehot, excess, 0); d mu = -budget
    dmu = -a.budget
    indM = (f["M"] == f["mu"][:, None]).to(torch.float32)
    nM = indM.sum(dim=1)
    dM = indM * (dmu / nM)[:, None]
    # the where's cotangent, summed over slots: a config has at most one
    # slot, so its share is that slot's entry (+0 without one)
    slot = a.onehot.to(torch.uint8).argmax(dim=0)
    cols = torch.arange(a.onehot.shape[1], device=dM.device)
    dexcess = torch.where(a.onehot.any(dim=0), dM[slot, cols], k.zero)
    dx = dexcess * torch.where(f["xe"] > 0, k.one,
                               torch.where(f["xe"] == 0, k.half, k.zero))
    dvh_a = dx / theta
    dtheta_b = -xla_sum(dx * inv_t2, f["vh"])
    dtheta = dtheta_a + dtheta_b
    dtheta0 = dtheta * _tie_weight(f["theta0"], k.eps, k)
    indz = (f["z"] == f["theta0"]).to(torch.float32)
    dz = indz * (dtheta0 / indz.sum())
    dvh_b = torch.where(f["zsel"], dz / f["pden"], k.zero)
    dvh = dvh_a + dvh_b
    dvh0 = torch.where(f["finite"], dvh, k.zero)
    indv = (f["v"] == f["vh0"][:, None]).to(torch.float32)
    dv = indv * (dvh0 / indv.sum(dim=1))[:, None]
    dmm = torch.where(a.valid, dv * a.alloc, k.zero)                    # [C, R]
    indX = (f["X"] == f["mm"][None, :, :]).to(torch.float32)           # [G, C, R]
    dX = indX * (dmm / indX.sum(dim=0))[None, :, :]
    dXc = torch.where(a.compat[:, :, None], dX, k.zero)
    dratio = xla_sum(dXc.permute(0, 2, 1))                             # [G, R]
    dlam_b = xla_sum(torch.where(f["rmask"], dratio / f["safe_req"], k.zero))
    return dlam_a + dlam_b


def ascend_ref(a: AscentInputs, n_iters: int):
    """Plain version of B5 (`_ascend`, lp_device.py:202 of the JAX
    package): projected supergradient ascent on the priority-weighted
    dual bound, keeping the best iterate. Returns (best [] f32,
    best_lam [Gp] f32, last_up [] int32: the last iteration that
    improved, -1 if none)."""
    dev = a.lam0.device
    k = _Consts(dev)
    lam = a.lam0
    f = _forward(a, lam, k, initial=True)
    best, best_lam = f["b"], lam
    last_up = torch.full((), -1, dtype=torch.int32, device=dev)
    for t in range(n_iters):
        g = _supergradient(a, lam, f, k)
        nrm = _sqrt_rn(xla_sum(g, g))
        gn = g / torch.where(nrm > k.eps, nrm, k.eps)
        t_f = torch.full((), float(t), dtype=torch.float32, device=dev)
        eta = k.half / _sqrt_rn(k.one + t_f)
        lmax = lam.amax()
        scale = torch.where(lmax > k.tiny, lmax, k.tiny)
        y = _fma_f32(eta * gn, scale.expand_as(gn), lam)
        lam = torch.where(y > 0, y, k.zero)
        f = _forward(a, lam, k)
        better = f["b"] > best
        best = torch.where(better, f["b"], best)
        best_lam = torch.where(better, lam, best_lam)
        last_up = torch.where(better, torch.full_like(last_up, t), last_up)
    return best, best_lam, last_up


def _one_slot(onehot: torch.Tensor, what: str) -> None:
    """The kernels keep one slot index a config, as `_supergradient`
    reads the cap duals: refuse a config in more than one slot."""
    if onehot.numel() and int(onehot.sum(dim=0).max()) > 1:
        raise ValueError(f"{what}: a config belongs to more than one reservation slot")


def _layout_args(G: int, C: int, R: int, K: int, dev, copies: int = 1, cluster: int = 0):
    """The layout of a launch as its C arguments: the offsets (a ctypes
    array), the shared-memory bytes, the scratch tensor (`copies` blocks'
    worth) and a block's scratch bytes."""
    import ctypes

    lay = ascent_layout(G, C, R, K, cluster)
    offsets = (ctypes.c_longlong * len(lay["offsets"]))(*lay["offsets"])
    scratch = torch.empty((max(16, copies * lay["scratch"]),), dtype=torch.uint8, device=dev)
    return lay, offsets, scratch


def ascent_refusal(Gp: int, Cp: int, R: int = 1, Kp: int = 1) -> str | None:
    """Why B5 refuses padded axes of `Gp` groups, `Cp` configs, `R`
    resources and `Kp` reservation slots (None when it takes them): more
    than 16 resources (ROADMAP C4), more than `ASCENT_MAX_SLOTS` slots, or
    an axis past the wide layout's three window levels or its 32-bit
    indices (arrays of gigabytes before that). The plain version has no
    limit."""
    if R > 16:
        return f"lp_ascend: {R} resources exceed the kernel's 16 (ROADMAP C4)"
    if Kp > ASCENT_MAX_SLOTS:
        return f"lp_ascend: Kp={Kp} reservation slots exceed the kernel's {ASCENT_MAX_SLOTS}"
    if (Gp > ASCENT_MAX_AXIS or Cp > ASCENT_MAX_AXIS
            or Gp * R * (-(-Cp // 32)) > 2 ** 31 - 1 or Cp * (-(-Gp // 32)) > 2 ** 31 - 1):
        return (f"lp_ascend: Gp={Gp} groups and Cp={Cp} configs exceed the wide layout's "
                f"{ASCENT_MAX_AXIS} or its 32-bit indices")
    return None


def _ascend_cuda(a: AscentInputs, n_iters: int):
    import ctypes

    from karpenter_tpu_torch.solver.pack_split import _check, _lib, _ptr, _raise_on, _stream

    Gp, Cp = a.compat.shape
    R = a.req.shape[1]
    Kp = a.onehot.shape[0]
    f32, b8 = torch.float32, torch.bool
    shapes = dict(lam0=(f32, (Gp,)), count=(f32, (Gp,)), count_w=(f32, (Gp,)),
                  compat=(b8, (Gp, Cp)), req=(f32, (Gp, R)), alloc=(f32, (Cp, R)),
                  price=(f32, (Cp,)), valid=(b8, (Cp, R)), onehot=(b8, (Kp, Cp)),
                  budget=(f32, (Kp,)), uncapped=(b8, (Cp,)))
    for name, (dtype, shape) in shapes.items():
        _check(getattr(a, name), name, dtype, shape)
    refusal = ascent_refusal(Gp, Cp, R, Kp)
    if refusal:
        raise ValueError(refusal)
    _one_slot(a.onehot, "lp_ascend")
    dev = a.lam0.device
    best = torch.empty((), dtype=f32, device=dev)
    best_lam = torch.empty((Gp,), dtype=f32, device=dev)
    last_up = torch.empty((), dtype=torch.int32, device=dev)
    S = ascent_cluster(Gp, Cp)
    lay, offsets, scratch = _layout_args(Gp, Cp, R, Kp, dev, max(S, 1), S)
    lib = _lib("lp_ascend")
    at_once = ctypes.c_int(0)
    err = lib.lp_ascend_launch(
        *(_ptr(t) for t in (*a.tensors(), best, best_lam, last_up)), offsets, lay["smem"],
        _ptr(scratch), lay["scratch"], Gp, Cp, R, Kp, int(n_iters), S, ctypes.byref(at_once),
        _stream(),
    )
    _raise_on(err, f"lp_ascend (Gp={Gp} Cp={Cp} R={R} Kp={Kp}, {lay['smem']} B of shared "
                   f"memory" + (f" a block, one cluster of {S} blocks; the card holds "
                                f"{at_once.value} such clusters at once" if S else "") + ")")
    LAUNCHES["lp_ascend"] += 1
    if lay["global"]:
        LAUNCHES["lp_ascend_global"] += 1
    if ascent_wide(Gp, Cp):
        LAUNCHES["lp_ascend_wide"] += 1
    ASCENT_SMEM["lp_ascend"] = _placement(lay) + (f", a cluster of {S} blocks" if S else "")
    return best, best_lam, last_up


def _placement(lay: dict) -> str:
    where = f"global: {', '.join(lay['global'])}" if lay["global"] else "all in shared memory"
    return f"{lay['smem']} B shared, {lay['scratch']} B global scratch ({where})"


def barrier_probe(n: int) -> None:
    """Launch one block of B5's width that takes `n` block barriers in a
    row and does nothing else: `chip_smoke.py` times it for the cost of
    one barrier (the floor of the ascent's chain). Not counted: it is no
    part of a solve."""
    from karpenter_tpu_torch.solver.pack_split import _lib, _ptr, _raise_on, _stream

    sink = torch.empty((1,), dtype=torch.int32, device="cuda")
    _raise_on(_lib("lp_ascend").lp_barrier_probe_launch(int(n), _ptr(sink), _stream()),
              "lp_barrier_probe")


def cluster_barrier_probe(n: int, S: int) -> None:
    """Launch one cluster of `S` blocks of B5's width that takes `n`
    cluster barriers in a row and does nothing else: `chip_smoke.py`
    times it for the cost of one (the floor of the wide layout's chain of
    cluster barriers). Not counted."""
    from karpenter_tpu_torch.solver.pack_split import _lib, _ptr, _raise_on, _stream

    sink = torch.empty((1,), dtype=torch.int32, device="cuda")
    _raise_on(_lib("lp_ascend").lp_cluster_barrier_probe_launch(int(n), int(S), _ptr(sink),
                                                                _stream()),
              f"lp_cluster_barrier_probe (a cluster of {S})")


def ascend(a: AscentInputs, n_iters: int):
    """B5. Arguments and outputs as `ascend_ref`. CUDA tensors launch
    the kernel (one block for all iterations; past 2048 padded groups or
    configs one cluster of `ascent_cluster` blocks); CPU tensors run the
    plain version; any other device raises."""
    if a.lam0.is_cuda:
        return _ascend_cuda(a, n_iters)
    if a.lam0.device.type == "cpu":
        return ascend_ref(a, n_iters)
    raise ValueError(f"lp_ascend: no kernel for device {a.lam0.device}")


# ---------------------------------------------------------------- split B5


class ShardedAscentInputs:
    """B5's inputs with the config axis split over S shards: lam0,
    count, count_w [Gp], req [Gp, R] and budget [Kp] replicated; compat
    [Gp, Cs], alloc and valid [Cs, R], price and uncapped [Cs] and
    onehot [Kp, Cs] as lists of per-shard blocks (the JAX package's
    specs at lp_device.py:443-447)."""

    REPLICATED = ("lam0", "count", "count_w", "req", "budget")
    SPLIT = {"compat": 1, "alloc": 0, "price": 0, "valid": 0, "onehot": 1, "uncapped": 0}

    def __init__(self, **tensors):
        for name in self.REPLICATED + tuple(self.SPLIT):
            setattr(self, name, tensors[name])

    @property
    def shards(self) -> int:
        return len(self.compat)

    @classmethod
    def split(cls, a: AscentInputs, shards: int, devices=None) -> "ShardedAscentInputs":
        """`a` cut into `shards` column blocks (Cp must divide), each its
        own allocation, on `devices` (one per shard; default: a's)."""
        devices = devices or [a.lam0.device] * shards
        out = {n: getattr(a, n).to(devices[0]) for n in cls.REPLICATED}
        for n, axis in cls.SPLIT.items():
            t = getattr(a, n)
            if t.shape[axis] % shards:
                raise ValueError(f"{n}: {t.shape[axis]} configs do not split {shards} ways")
            out[n] = [b.contiguous().to(d, copy=True)
                      for b, d in zip(torch.chunk(t, shards, dim=axis), devices)]
        return cls(**out)


def _forward_sharded(a: ShardedAscentInputs, lam, k: _Consts, initial: bool = False):
    """`_forward` with every reduction over configs taken per shard and
    combined: theta's and mu's maxima over the shards' maxima."""
    S = a.shards
    req = a.req
    rmask = (req > 0) & (a.count > 0)[:, None]
    safe_req = torch.where(req > 0, req, k.one)
    ratio = torch.where(rmask, lam[:, None] / safe_req, k.zero)
    sh = []
    for s in range(S):
        X = torch.where(a.compat[s][:, :, None], ratio[:, None, :], k.zero)
        mm = X.amax(dim=0)
        v = torch.where(a.valid[s], mm * a.alloc[s], k.inf)
        vh0 = v.amin(dim=1)
        finite = torch.isfinite(vh0)
        vh = torch.where(finite, vh0, k.zero)
        zsel = a.uncapped[s] & (a.price[s] > 0)
        pden = torch.where(a.price[s] > k.eps, a.price[s], k.eps)
        z = torch.where(zsel, vh / pden, k.zero)
        sh.append(dict(X=X, mm=mm, v=v, vh0=vh0, finite=finite, vh=vh, zsel=zsel,
                       pden=pden, z=z))
    theta0 = sh[0]["z"].amax()
    for d in sh[1:]:
        theta0 = torch.maximum(theta0, d["z"].amax())
    theta = torch.where(theta0 > k.eps, theta0, k.eps)
    lam_s = lam / theta
    mu = None
    for s, d in enumerate(sh):
        xe = d["vh"] / theta - a.price[s]
        d["xe"] = xe
        excess = torch.where(xe > 0, xe, k.zero)
        d["M"] = torch.where(a.onehot[s], excess[None, :], k.zero)
        m = d["M"].amax(dim=1)
        mu = m if mu is None else torch.maximum(mu, m)
    b = xla_dot(lam_s, a.count_w, initial) - fma_chain(mu, a.budget)
    return dict(sh=sh, safe_req=safe_req, rmask=rmask, ratio=ratio, theta0=theta0,
                theta=theta, mu=mu, b=b)


def _supergradient_sharded(a: ShardedAscentInputs, lam, f: dict, k: _Consts):
    """`_supergradient` over the shards: tie counts over configs summed
    over the shards, and each sum over configs (dtheta's and d ratio's)
    taken in XLA's order on each shard's columns, the partials then
    added in shard order."""
    S = a.shards
    theta = f["theta"]
    inv_t2 = k.one / (theta * theta)
    dlam_a = a.count_w / theta
    dtheta_a = -xla_sum(a.count_w * inv_t2, lam)
    dmu = -a.budget
    nM = sum((d["M"] == f["mu"][:, None]).to(torch.float32).sum(dim=1) for d in f["sh"])
    dtheta_b = None
    for s, d in enumerate(f["sh"]):
        indM = (d["M"] == f["mu"][:, None]).to(torch.float32)
        dM = indM * (dmu / nM)[:, None]
        slot = a.onehot[s].to(torch.uint8).argmax(dim=0)
        cols = torch.arange(a.onehot[s].shape[1], device=dM.device)
        dexcess = torch.where(a.onehot[s].any(dim=0), dM[slot, cols], k.zero)
        d["dx"] = dexcess * torch.where(d["xe"] > 0, k.one,
                                        torch.where(d["xe"] == 0, k.half, k.zero))
        part = xla_sum(d["dx"] * inv_t2, d["vh"])
        dtheta_b = part if dtheta_b is None else dtheta_b + part
    dtheta = dtheta_a + -dtheta_b
    dtheta0 = dtheta * _tie_weight(f["theta0"], k.eps, k)
    nz = sum((d["z"] == f["theta0"]).to(torch.float32).sum() for d in f["sh"])
    dratio = None
    for s, d in enumerate(f["sh"]):
        indz = (d["z"] == f["theta0"]).to(torch.float32)
        dz = indz * (dtheta0 / nz)
        dvh_b = torch.where(d["zsel"], dz / d["pden"], k.zero)
        dvh = d["dx"] / theta + dvh_b
        dvh0 = torch.where(d["finite"], dvh, k.zero)
        indv = (d["v"] == d["vh0"][:, None]).to(torch.float32)
        dv = indv * (dvh0 / indv.sum(dim=1))[:, None]
        dmm = torch.where(a.valid[s], dv * a.alloc[s], k.zero)
        indX = (d["X"] == d["mm"][None, :, :]).to(torch.float32)
        dX = indX * (dmm / indX.sum(dim=0))[None, :, :]
        dXc = torch.where(a.compat[s][:, :, None], dX, k.zero)
        part = xla_sum(dXc.permute(0, 2, 1))
        dratio = part if dratio is None else dratio + part
    dlam_b = xla_sum(torch.where(f["rmask"], dratio / f["safe_req"], k.zero))
    return dlam_a + dlam_b


def ascend_sharded_ref(a: ShardedAscentInputs, n_iters: int):
    """Plain version of split B5: `ascend_ref` with the config axis split
    over `a.shards` shards (`_forward_sharded`, `_supergradient_sharded`).
    Returns (best [S], best_lam [S, Gp], last_up [S]): S copies of one
    result, as the kernel's replicas."""
    dev = a.lam0.device
    k = _Consts(dev)
    lam = a.lam0
    f = _forward_sharded(a, lam, k, initial=True)
    best, best_lam = f["b"], lam
    last_up = torch.full((), -1, dtype=torch.int32, device=dev)
    for t in range(n_iters):
        g = _supergradient_sharded(a, lam, f, k)
        nrm = _sqrt_rn(xla_sum(g, g))
        gn = g / torch.where(nrm > k.eps, nrm, k.eps)
        t_f = torch.full((), float(t), dtype=torch.float32, device=dev)
        eta = k.half / _sqrt_rn(k.one + t_f)
        lmax = lam.amax()
        scale = torch.where(lmax > k.tiny, lmax, k.tiny)
        y = _fma_f32(eta * gn, scale.expand_as(gn), lam)
        lam = torch.where(y > 0, y, k.zero)
        f = _forward_sharded(a, lam, k)
        better = f["b"] > best
        best = torch.where(better, f["b"], best)
        best_lam = torch.where(better, lam, best_lam)
        last_up = torch.where(better, torch.full_like(last_up, t), last_up)
    S = a.shards
    return best.expand(S).clone(), best_lam.expand(S, -1).clone(), last_up.expand(S).clone()


def _ascend_sharded_cuda(a: ShardedAscentInputs, n_iters: int):
    from karpenter_tpu_torch.solver.pack_split import _check, _lib, _ptr, _raise_on, _stream
    from karpenter_tpu_torch.solver.pack_shard import _table, _xchg_scratch

    S = a.shards
    Gp, Cs = a.compat[0].shape
    R = a.req.shape[1]
    Kp = a.onehot[0].shape[0]
    f32, b8 = torch.float32, torch.bool
    dev = a.lam0.device
    for name, shape, dtype in (("lam0", (Gp,), f32), ("count", (Gp,), f32),
                               ("count_w", (Gp,), f32), ("req", (Gp, R), f32),
                               ("budget", (Kp,), f32)):
        _check(getattr(a, name), name, dtype, shape)
    for s in range(S):
        for name, shape, dtype in (("compat", (Gp, Cs), b8), ("alloc", (Cs, R), f32),
                                   ("price", (Cs,), f32), ("valid", (Cs, R), b8),
                                   ("onehot", (Kp, Cs), b8), ("uncapped", (Cs,), b8)):
            t = getattr(a, name)[s]
            if t.device != dev:
                raise ValueError(f"lp_ascend_sharded: shard {s} lies on {t.device}; the "
                                 "launch over several cards is ROADMAP item 10")
            _check(t, f"{name}[{s}]", dtype, shape)
        _one_slot(a.onehot[s], f"lp_ascend_sharded shard {s}")
    refusal = ascent_refusal(Gp, Cs, R, Kp)
    if refusal:
        raise ValueError(refusal.replace("lp_ascend", "lp_ascend_sharded", 1))
    best = torch.empty((S,), dtype=f32, device=dev)
    best_lam = torch.empty((S, Gp), dtype=f32, device=dev)
    last_up = torch.empty((S,), dtype=torch.int32, device=dev)
    lay, offsets, scratch = _layout_args(Gp, Cs, R, Kp, dev, copies=S)
    slots = _xchg_scratch(1, S, max(Kp, Gp * R), dev)
    tables = [_table(getattr(a, n), dev) for n in ("compat", "alloc", "price", "valid",
                                                     "onehot", "uncapped")]
    lib = _lib("lp_ascend")
    err = lib.lp_ascend_sharded_launch(
        *[_ptr(t) for t in tables],
        *[_ptr(getattr(a, n)) for n in ("lam0", "count", "count_w", "req", "budget")],
        _ptr(best), _ptr(best_lam), _ptr(last_up), offsets, lay["smem"], _ptr(scratch),
        lay["scratch"], _ptr(slots), Gp, Cs, R, Kp, int(n_iters), S,
        slots.shape[-1], _stream(),
    )
    _raise_on(err, f"lp_ascend_sharded (cooperative grid of {S} blocks, {lay['smem']} B "
                   f"of shared memory each)")
    LAUNCHES["lp_ascend_sharded"] += 1
    if lay["global"]:
        LAUNCHES["lp_ascend_sharded_global"] += 1
    if ascent_wide(Gp, Cs):
        LAUNCHES["lp_ascend_sharded_wide"] += 1
    ASCENT_SMEM["lp_ascend_sharded"] = _placement(lay)
    return best, best_lam, last_up


def ascend_sharded(a: ShardedAscentInputs, n_iters: int):
    """Split B5. Arguments and outputs as `ascend_sharded_ref`'s; CUDA
    tensors run one cooperative launch of S blocks."""
    if a.lam0.is_cuda:
        return _ascend_sharded_cuda(a, n_iters)
    if a.lam0.device.type == "cpu":
        return ascend_sharded_ref(a, n_iters)
    raise ValueError(f"lp_ascend_sharded: no kernel for device {a.lam0.device}")


# ---------------------------------------------------------------- host


def _certify(lam, count, compat, req, alloc, price, valid_r, cap_slot,
             cap_budget):
    """Host float64 re-derivation of (theta, lam', mu, bound) from a
    candidate lam: valid by construction, whatever the ascent did."""
    lam = np.clip(np.asarray(lam, np.float64), 0.0, None)
    live = count > 0
    safe_req = np.where(req > 0, req, 1.0)
    ratio = np.where((req > 0) & live[:, None], lam[:, None] / safe_req, 0.0)
    mm = np.max(
        np.where(compat[:, :, None], ratio[:, None, :], 0.0), axis=0
    )
    with np.errstate(invalid="ignore"):
        v = np.where(valid_r, mm * alloc, np.inf)
    vh = np.min(v, axis=1)
    vh = np.where(np.isfinite(vh), vh, 0.0)
    uncapped = cap_slot < 0
    theta = float(
        np.max(
            np.where(uncapped & (price > 0), vh / np.maximum(price, _EPS),
                     0.0),
            initial=0.0,
        )
    )
    theta = max(theta, _EPS)
    lam_s = lam / theta
    vh_s = vh / theta
    K = len(cap_budget)
    mu = np.zeros(K, np.float64)
    if K:
        excess = np.clip(vh_s - price, 0.0, None)
        for k in range(K):
            sel = cap_slot == k
            if sel.any():
                mu[k] = float(excess[sel].max())
    bound = float(lam_s @ count - mu @ cap_budget)
    return lam_s, mu, vh_s, theta, max(bound, 0.0)


def _stage(enc: Encoded):
    """Launch-masked staging for the ascent, plus the float64 host
    copies the certificate is computed from."""
    G, C = enc.compat.shape
    R = enc.group_req.shape[1]
    launch = enc.cfg_pool >= 0
    eff = enc.cfg_alloc - enc.pool_overhead[np.maximum(enc.cfg_pool, 0)]
    eff = np.where(launch[:, None], np.clip(eff, 0.0, None), 0.0)
    price = np.where(launch, enc.cfg_price, 0.0).astype(np.float64)
    compat = enc.compat & launch[None, :]
    cap_slot = (
        enc.cfg_rsv.astype(np.int64)
        if enc.cfg_rsv is not None
        else np.full(C, -1, np.int64)
    )
    cap_slot = np.where(launch, cap_slot, -1)
    cap_budget = (
        enc.rsv_cap.astype(np.float64)
        if enc.rsv_cap is not None
        else np.zeros(0, np.float64)
    )
    # groups no launchable machine holds one pod of are left out of the
    # priced demand (their duals would grow without bound)
    safe = np.where(enc.group_req > 0, enc.group_req, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.floor((eff[None, :, :] + 1e-4) / safe[:, None, :])
    k = np.where(enc.group_req[:, None, :] > 0, k, np.inf).min(axis=2)
    k = np.where(compat, k, 0.0)
    plannable = np.asarray(k >= 1).any(axis=1)
    count = np.where(plannable, enc.group_count, 0).astype(np.float64)
    live = count > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        ppp = np.where(k >= 1, price[None, :] / np.maximum(k, 1.0), np.inf)
    ppp = ppp.min(axis=1)
    lam0 = np.where(np.isfinite(ppp) & live, ppp, 0.0)
    # r is valid for c when every live compatible group consumes it
    reqpos = enc.group_req > 0
    bad = (compat & live[:, None])[:, :, None] & ~reqpos[:, None, :]
    valid_r = ~bad.any(axis=0)
    w = priority_weights(enc.group_priority, G)
    return dict(
        G=G, C=C, R=R, count=count, count_w=count * w, compat=compat,
        req=enc.group_req.astype(np.float64), alloc=eff.astype(np.float64),
        price=price, valid_r=valid_r, cap_slot=cap_slot,
        cap_budget=cap_budget, lam0=lam0, weights=w,
    )


def ascent_inputs(st: dict, shards: int = 0) -> AscentInputs:
    """Pad `_stage`'s output as the JAX package pads it (`_pad_to` for
    groups and configs, `_cap_rows` for reservation slots: padded zeros
    count in the ties of the max reductions) into CPU tensors. With
    `shards > 1` the config axis pads on to a multiple of the shard
    count, as the JAX package's split ascent pads it."""
    G, C, R = st["G"], st["C"], st["R"]
    Gp, Cp = _pad_to(G), _pad_to(C)
    if shards > 1:
        Cp = -(-Cp // shards) * shards
    K = len(st["cap_budget"])
    Kp = _cap_rows(K)

    def vec(n, src, dtype=np.float32):
        out = np.zeros(n, dtype)
        out[: len(src)] = src
        return out

    compat_p = np.zeros((Gp, Cp), bool)
    compat_p[:G, :C] = st["compat"]
    req_p = np.zeros((Gp, R), np.float32)
    req_p[:G] = st["req"]
    alloc_p = np.zeros((Cp, R), np.float32)
    alloc_p[:C] = st["alloc"]
    valid_p = np.zeros((Cp, R), bool)
    valid_p[:C] = st["valid_r"]
    price_p = vec(Cp, st["price"])
    slot_p = np.full(Cp, -1, np.int64)
    slot_p[:C] = st["cap_slot"]
    onehot = np.zeros((Kp, Cp), bool)
    for ki in range(K):
        onehot[ki] = slot_p == ki
    t = torch.from_numpy
    return AscentInputs(
        lam0=t(vec(Gp, st["lam0"])), count=t(vec(Gp, st["count"])),
        count_w=t(vec(Gp, st["count_w"])), compat=t(compat_p), req=t(req_p),
        alloc=t(alloc_p), price=t(price_p), valid=t(valid_p), onehot=t(onehot),
        budget=t(vec(Kp, st["cap_budget"])),
        uncapped=t((slot_p < 0) & (price_p > 0)),
    )


def lp_shards() -> int:
    """KARPENTER_LP_SHARDS: the shard count of the ascent (0: unsplit)."""
    return max(0, _env_int("KARPENTER_LP_SHARDS", 0))


def solve(enc: Encoded, device: torch.device | str = "cuda", shards: int = 0) -> DeviceLP:
    """Run (or reuse) the dual ascent for this encode on `device`.
    Raises on failure.

    `shards` (default KARPENTER_LP_SHARDS) splits the ascent's config
    axis, padded to a multiple of the shard count (lp_device.py:430-452
    of the JAX package), over that many shards, but only when that many
    devices are visible (`pack.visible_devices`, which counts the shard
    slots of `force_virtual_mesh`): the JAX package runs the split
    ascent only under the same condition (lp_device.py:441) and the
    unsplit one otherwise."""
    fp = _fingerprint(enc)
    with _cache_lock:
        hit = _cache.get(fp)
    if hit is not None:
        return hit

    t0 = time.perf_counter()
    st = _stage(enc)
    G = st["G"]
    n_iters = iters()
    shards = shards or lp_shards()
    dev = torch.device(device)
    split = False
    if shards > 1:
        from karpenter_tpu_torch.solver.pack import _mesh, visible_devices

        split = shards <= visible_devices(1, dev)
    if split:
        mesh = _mesh(shards, str(dev))
        inputs = ShardedAscentInputs.split(
            ascent_inputs(st, shards), shards, list(mesh.devices))
        _, best_lam, last_up = ascend_sharded(inputs, n_iters)
        best_lam, last_up = best_lam[0], last_up[0]
    else:
        inputs = ascent_inputs(st).to(dev)
        _, best_lam, last_up = ascend(inputs, n_iters)
    lam_raw = best_lam.cpu().numpy().astype(np.float64)[:G]
    converged = int(last_up) < (n_iters * 3) // 4
    lam_s, mu, vh_s, theta, bound = _certify(
        lam_raw, st["count"], st["compat"], st["req"], st["alloc"],
        st["price"], st["valid_r"], st["cap_slot"], st["cap_budget"],
    )
    out = DeviceLP(
        lam=lam_s,
        mu=mu,
        lower_bound=bound,
        theta=theta,
        vhat=vh_s,
        lam_guide=lam_s * st["weights"],
        iterations=n_iters,
        converged=converged,
        wall_s=time.perf_counter() - t0,
        cache_hit=False,
    )
    with _cache_lock:
        _cache.pop(fp, None)
        while len(_cache) >= _CACHE_ENTRIES:
            _cache.pop(next(iter(_cache)))
        _cache[fp] = out
    return out


def maybe_solve(enc: Encoded, device: torch.device | str = "cuda", shards: int = 0):
    """The degrading entry: None when guidance is disabled, the problem
    is degenerate (no groups, no launchable column), or the solve failed
    in a way `resilience.may_degrade` lets through (counted as
    karpenter_solver_lp_total{outcome="degraded"} and logged); callers
    then run the unguided path. Other failures are raised."""
    if not enabled():
        return None
    if enc.compat.shape[0] == 0 or not (enc.cfg_pool >= 0).any():
        return None
    try:
        dlp = solve(enc, device=device, shards=shards)
    except Exception as err:
        if not may_degrade(err, device):
            raise
        SOLVER_LP_SOLVES.inc({"outcome": "degraded"})
        log.warning("device LP degraded to unguided path: %s", err)
        return None
    # decision explainability (karpenter_tpu_torch/explain): the duals ARE
    # the economic reading of the tick — attach a per-solve summary to
    # the open record (no record open / kill switch -> one global read)
    from karpenter_tpu_torch import explain

    if explain.active() is not None:
        explain.note_lp(dual_summary(enc, dlp))
    return dlp


def dual_summary(enc: Encoded, dlp: DeviceLP, k: int = 3) -> dict:
    """The per-solve dual digest the explain plane records: the top-k
    binding demand groups (their scaled dual prices — what one more
    pod of that shape would cost the fleet), the reservation-cap duals
    (what one more reserved instance would be worth), and the
    certified bound. Values are the float64 host-certified duals,
    rounded for stable replay comparison."""
    lam = dlp.lam
    order = [
        int(gi) for gi in np.argsort(-lam, kind="stable")[:k]
        if lam[gi] > 0
    ]
    return {
        "bound": round(float(dlp.lower_bound), 6),
        "binding_groups": [
            {
                "group": gi,
                "dual": round(float(lam[gi]), 6),
                "pods": int(enc.group_count[gi]),
                "priority": (
                    int(enc.group_priority[gi])
                    if enc.group_priority is not None else 0
                ),
            }
            for gi in order
        ],
        "reservation_cap_duals": [
            round(float(m), 6) for m in dlp.mu.tolist()
        ],
        "iterations": int(dlp.iterations),
        "converged": bool(dlp.converged),
        # NOTE: cache_hit/wall_s deliberately absent — both track
        # process history (the LRU, machine speed), not the decision,
        # and would break the replay byte-identity contract
    }


def rank_prices(enc: Encoded, dlp: DeviceLP,
                beta: float | None = None) -> np.ndarray:
    """Dual-adjusted reduced-cost ranking of the launchable configs as
    the packer's price input: configs priced above their dual value
    are penalized by the gap; decode still prices from enc.cfg_price."""
    beta = rank_beta() if beta is None else beta
    launch = enc.cfg_pool >= 0
    price = enc.cfg_price.astype(np.float64)
    vh = dlp.vhat
    # priority fold: value configs by the guidance duals' scale
    if len(dlp.lam) and np.max(dlp.lam) > 0:
        scale = np.max(dlp.lam_guide) / np.max(dlp.lam)
        if scale != 1.0:
            vh = vh * max(scale, _EPS)
    rc = np.clip(price - vh, 0.0, None)
    out = np.where(launch, price + beta * rc, price)
    return out.astype(np.float32)


class DualCertificate:
    """Weak-duality bound for consolidation probe pruning (the JAX
    package's `DualCertificate`, in float64 numpy in its order of
    operations).

    Built from one encode of the probe problem (the LaneSolver's union
    encode): `lam` is dual-feasible for every uncapped launchable
    config, `mu` and the cap budgets buy back reserved configs' excess,
    and `absorb[e]` bounds from above the dual value that existing node
    e's free capacity could host. For a candidate set S with pod demand
    d:

        launch_cost(any repack of d without S)
            >= lam.d - sum_{e not in S} absorb[e] - cap.mu

    so when that bound meets the candidates' current price (plus the
    margin), no strictly cheaper replacement exists."""

    def __init__(self, enc: Encoded, dlp: DeviceLP):
        self.lam = dlp.lam
        self.cap_term = float(
            dlp.mu @ (enc.rsv_cap.astype(np.float64)
                      if enc.rsv_cap is not None and enc.rsv_cap.size
                      else np.zeros(0))
        ) if len(dlp.mu) else 0.0
        live = enc.group_count > 0
        req = enc.group_req.astype(np.float64)
        safe_req = np.where(req > 0, req, 1.0)
        ratio = np.where(
            (req > 0) & live[:, None], self.lam[:, None] / safe_req, 0.0
        )
        # per existing column, the LP's closed-form value bound over the
        # node's remaining allocatable, as one [G, E, R] computation
        self.absorb: dict[int, float] = {}
        ex_cols = np.array(
            [ci for ci in np.flatnonzero(enc.cfg_pool < 0)
             if enc.configs[ci].existing_index >= 0],
            dtype=np.int64,
        )
        total = 0.0
        if ex_cols.size:
            ex_idx = np.array(
                [enc.configs[ci].existing_index for ci in ex_cols]
            )
            compat_e = enc.compat[:, ex_cols] & live[:, None]   # [G, E]
            alloc_e = np.clip(
                enc.cfg_alloc[ex_cols].astype(np.float64), 0.0, None
            )                                                   # [E, R]
            reqpos = req > 0                                    # [G, R]
            # an exhausted axis every candidate pod needs bounds the
            # node's absorbable value at exactly 0
            bad = np.einsum(
                "ge,gr->er", compat_e, (~reqpos).astype(np.float64)
            ) > 0                                               # [E, R]
            mm = np.max(
                np.where(compat_e[:, :, None], ratio[:, None, :], 0.0),
                axis=0,
            )                                                   # [E, R]
            with np.errstate(invalid="ignore"):
                v = np.where(~bad, mm * alloc_e, np.inf)
            vals = np.min(v, axis=1)
            vals = np.where(np.isfinite(vals), np.clip(vals, 0.0, None), 0.0)
            any_compat = compat_e.any(axis=0)
            vals = np.where(any_compat, vals, 0.0)
            for ei, val in zip(ex_idx.tolist(), vals.tolist()):
                self.absorb[ei] = val
            total = float(vals.sum())
        self.absorb_total = total

    def floor(self, demand: np.ndarray, candidate_rows: list[int]) -> float:
        """The weak-duality lower bound on any repack of `demand` [G]
        without the candidate rows (their existing_index): lam.d minus
        the rest of the fleet's absorbable value minus the cap term."""
        absorb_rest = self.absorb_total - sum(
            self.absorb.get(r, 0.0) for r in set(candidate_rows)
        )
        return (
            float(self.lam @ demand.astype(np.float64))
            - max(absorb_rest, 0.0)
            - self.cap_term
        )

    def cannot_pay(self, demand: np.ndarray, candidate_rows: list[int],
                   current_price: float, margin: float | None = None,
                   floor: float | None = None) -> bool:
        """The prune predicate: no repack of `demand` without the
        candidates can cost less than `current_price` by the margin.
        A caller that also reports the floor passes it back in."""
        margin = prune_margin() if margin is None else margin
        if floor is None:
            floor = self.floor(demand, candidate_rows)
        return floor >= current_price * (1.0 + margin) + 1e-9


def warm(shapes, device=None) -> int:
    """Launch B5 once for each (G, C, R) shape bucket and each
    reservation-row variant a real solve can take (1 row, and the first
    bucket of `_cap_rows`), on zero inputs at the padded shape, on
    `device` (None: the card): the warm pool's canary, so that the
    first guided solve of a warmed bucket pays no build or module load.
    Returns the number of launches; a failure is raised to the warm
    pool, which counts it."""
    from karpenter_tpu_torch.solver import telemetry
    from karpenter_tpu_torch.solver.solver import resolve_device

    dev = resolve_device(device)
    n = 0
    n_iters = iters()
    for G, C, R in shapes:
        Gp, Cp = _pad_to(G), _pad_to(C)
        for Kp in (1, _cap_rows(1)):
            telemetry.request_lp_capture(Gp, Cp, R, Kp, n_iters)
            zeros = AscentInputs(
                lam0=torch.zeros(Gp), count=torch.zeros(Gp), count_w=torch.zeros(Gp),
                compat=torch.zeros((Gp, Cp), dtype=torch.bool),
                req=torch.zeros((Gp, R)), alloc=torch.zeros((Cp, R)),
                price=torch.zeros(Cp), valid=torch.zeros((Cp, R), dtype=torch.bool),
                onehot=torch.zeros((Kp, Cp), dtype=torch.bool), budget=torch.zeros(Kp),
                uncapped=torch.zeros(Cp, dtype=torch.bool),
            ).to(dev)
            out = ascend(zeros, n_iters)
            (out[0] if isinstance(out, (tuple, list)) else out).cpu()
            n += 1
    return n


def reset() -> None:
    """Test hook: drop the dual-solve cache."""
    with _cache_lock:
        _cache.clear()
