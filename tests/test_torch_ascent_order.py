"""The summation, tie-count and layout rules of B5's CUDA kernel
(`csrc/lp_ascend.cu`), mirrored in plain Python and held bit for bit
against the plain version's (`lp_device.xla_sum`, `_forward`,
`_supergradient`). No JAX; one torch thread; a few seconds.

- The kernel's ordered sums: a lane a (row, window), the window walking
  only the terms that are not exactly +-0 (a set bit of the window's
  mask), the window sums added in XLA's order. Equal to `xla_sum` with
  and without a second factor at n = 1, 31, 32, 33, 243, 768, 1024,
  2048, on data with many exact zeros, -0.0, ties, a NaN and an inf
  term, and products of 0 and inf.
- The column maxima over groups and their tie counts, taken once a
  distinct compat column from bit words, with the masked zeros entered
  as the count of incompatible rows; mu's and theta's tie counts; equal
  to the dense counts of `_forward` (columns whose maximum is a masked
  or a computed 0, padded groups).
- d ratio by scatter: the tied groups of each column maximum set bits of
  per-(group, resource) window masks, and each row walks its bits;
  equal to the dense `xla_sum` over the configs, non-finite quotients
  included.
- The byte reckoning of a block (`lp_device.ascent_layout`): shared
  memory for reserved_50k's LP, the consolidation certificate's shape
  and the split shards; the global-memory path, without raising, at the
  largest shape the kernel admits.
- The plan of XLA's vector code for the bound's dot (`dot_plan`), as
  read from the JAX package's machine code at the padding buckets.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import lp_device
from karpenter_tpu_torch.solver.lp_plan import _fma_f32
from karpenter_tpu_torch.solver.pack_split import SMEM_BUDGET
from karpenter_tpu_torch.testing import ascent_cases, ascent_edge_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(v) -> np.float32:
    return np.float32(v)


def _fma(a, b, c) -> np.float32:
    return np.float32(_fma_f32(torch.tensor(a), torch.tensor(b), torch.tensor(c)))


def _win(n: int) -> tuple[int, int]:
    return lp_device.window_pad(n) if n > 32 else (1, 0)


def _win_total(sums: list) -> np.float32:
    """The window sums added as the kernel's `win_total` adds them."""
    n = len(sums)
    tot = _f32(0.0)
    if n <= 32:
        for v in sums:
            tot = _f32(tot + v)
        return tot
    nw2, front2 = _win(n)
    for W in range(nw2):
        s = _f32(0.0)
        for i in range(32):
            p = W * 32 + i - front2
            if 0 <= p < n:
                s = _f32(s + sums[p])
        tot = _f32(tot + s)
    return tot


def mirror_sum(x: np.ndarray, y: np.ndarray | None = None) -> np.float32:
    """The kernel's ordered sum of x (or of x * y): each window's mask
    holds the terms that are not exactly +-0 (up to 32 terms with y: the
    pairs whose multiply-add could change the sum), a lane walks its
    window's set bits in order from +0, the window sums are added in
    XLA's order."""
    n = len(x)
    if n <= 32:
        s = _f32(0.0)
        for i in range(n):
            if y is None:
                if x[i] != 0 or np.isnan(x[i]):
                    s = _f32(s + x[i])
            elif not ((x[i] == 0 or y[i] == 0) and np.isfinite(x[i]) and np.isfinite(y[i])):
                s = _fma(x[i], y[i], s)
        return s
    with np.errstate(invalid="ignore"):
        terms = x if y is None else (x * y).astype(np.float32)
    nw, front = _win(n)
    sums = []
    for w in range(nw):
        mask = [i for i in range(32) if 0 <= w * 32 + i - front < n
                and not (terms[w * 32 + i - front] == 0)]
        s = _f32(0.0)
        for i in mask:
            s = _f32(s + terms[w * 32 + i - front])
        sums.append(s)
    return _win_total(sums)


def _same(a, b) -> bool:
    a, b = np.float32(a), np.float32(b)
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return a.view(np.int32) == b.view(np.int32)


def _terms(rng, n: int, kind: str) -> np.ndarray:
    x = rng.normal(0, 1, n).astype(np.float32) * np.float32(2.0) ** rng.integers(-8, 8, n)
    x[rng.random(n) < 0.6] = 0.0
    x[rng.random(n) < 0.1] = -0.0
    if n > 4:
        x[rng.integers(0, n, max(1, n // 8))] = x[0]  # ties
    if kind == "nan":
        x[rng.integers(0, n)] = np.nan
    elif kind == "inf":
        x[rng.integers(0, n)] = np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["finite", "nan", "inf"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 243, 768, 1024, 2048])
def test_masked_window_sums_equal_xla_sum(n, kind):
    rng = np.random.default_rng(n * 7 + len(kind))
    x = _terms(rng, n, kind)
    want = lp_device.xla_sum(torch.from_numpy(x))
    assert _same(mirror_sum(x), want)
    y = _terms(rng, n, "finite")
    if kind == "inf":
        y[np.flatnonzero(~np.isfinite(x))] = 0.0  # 0 * inf: a NaN term, kept
    want = lp_device.xla_sum(torch.from_numpy(x), torch.from_numpy(y))
    assert _same(mirror_sum(x, y), want)


# ---------------------------------------------------------------- ties


def _colbits(compat: np.ndarray) -> np.ndarray:
    """[C, Gw] words: bit g % 32 of word g // 32 of column c."""
    G, C = compat.shape
    gw = -(-G // 32)
    out = np.zeros((C, gw), np.uint32)
    for g in range(G):
        out[:, g // 32] |= compat[g].astype(np.uint32) << np.uint32(g % 32)
    return out


def mirror_column_maxima(compat: np.ndarray, ratio: np.ndarray):
    """The kernel's column maxima: for each distinct column (the first
    config with those bits), over its compatible groups' bits, the
    maximum, its compatible ties and the first tied group; the masked
    zeros enter as the incompatible rows' count. Returns mm [C, R],
    ties [C, R], first [C, R] (-1 without a compatible tie)."""
    G, C = compat.shape
    R = ratio.shape[1]
    bits = _colbits(compat)
    rep = {}
    mm = np.zeros((C, R), np.float32)
    ties = np.zeros((C, R), np.int64)
    first = np.full((C, R), -1, np.int64)
    for c in range(C):
        key = bits[c].tobytes()
        if key in rep:
            o = rep[key]
            mm[c], ties[c], first[c] = mm[o], ties[o], first[o]
            continue
        rep[key] = c
        groups = [32 * w + b for w in range(bits.shape[1]) for b in range(32)
                  if (int(bits[c, w]) >> b) & 1]
        nnc = G - len(groups)
        for r in range(R):
            m, n, f = -np.inf, 0, -1
            for g in groups:
                v = ratio[g, r]
                if v > m:
                    m, n, f = v, 1, g
                elif v == m:
                    n += 1
            top = max(m, 0.0) if nnc > 0 else m
            cties = n if m == top else 0
            mm[c, r] = top
            ties[c, r] = cties + (nnc if top == 0 else 0)
            first[c, r] = f if cties else -1
    return mm, ties, first


def _edge_and_staged():
    return ascent_edge_cases(0)[1:] + ascent_cases(0)[1:2]


@pytest.mark.parametrize("index", range(4))
def test_tie_counts_from_bit_words_equal_dense_counts(index):
    name, a = _edge_and_staged()[index]
    k = lp_device._Consts(torch.device("cpu"))
    f = lp_device._forward(a, a.lam0, k, initial=True)
    compat = a.compat.numpy()
    mm, ties, first = mirror_column_maxima(compat, f["ratio"].numpy())
    assert (mm.view(np.int32) == f["mm"].numpy().view(np.int32)).all(), name
    ind = (f["X"] == f["mm"][None]).numpy()
    assert (ties == ind.sum(axis=0)).all(), name
    tied = ind & compat[:, :, None]
    want_first = np.where(tied.any(axis=0), tied.argmax(axis=0), -1)
    assert (first == want_first).all(), name
    # mu's ties: the slot's tied configs, plus the masked zeros when mu is 0
    M, mu = f["M"].numpy(), f["mu"].numpy()
    onehot = a.onehot.numpy()
    excess = np.where(f["xe"].numpy() > 0, f["xe"].numpy(), 0).astype(np.float32)
    C = compat.shape[1]
    for kk in range(onehot.shape[0]):
        in_slot = onehot[kk]
        n = int((excess[in_slot] == mu[kk]).sum()) + (C - int(in_slot.sum()) if mu[kk] == 0 else 0)
        assert n == int((M[kk] == mu[kk]).sum()), (name, kk)
    # theta's ties, by ballot over the configs
    z, theta0 = f["z"].numpy(), f["theta0"].numpy()
    assert int((z == theta0).sum()) == int((f["z"] == f["theta0"]).sum())
    assert (mm == 0).any() or name != "ascent-mm-zero-ties"


def mirror_dratio(compat, ratio, mm, q):
    """d ratio by the kernel's scatter: every (config, resource) whose
    quotient q is not +-0 sets, for each tied compatible group (every
    compatible group when q is NaN or inf), the config's bit in the
    group's (resource, window) mask; each row then walks its windows'
    bits in order, a term 1*q where tied and 0*q elsewhere, and adds the
    window sums in XLA's order."""
    G, C = compat.shape
    R = ratio.shape[1]
    nw, front = _win(C)
    masks = np.zeros((G, R, nw), np.uint64)
    for c in range(C):
        pos = c + front
        for r in range(R):
            qv = q[c, r]
            if qv == 0:
                continue
            for g in range(G):
                if compat[g, c] and (not np.isfinite(qv) or ratio[g, r] == mm[c, r]):
                    masks[g, r, pos // 32] |= np.uint64(1 << (pos % 32))
    out = np.zeros((G, R), np.float32)
    for g in range(G):
        for r in range(R):
            sums = []
            for w in range(nw):
                s = _f32(0.0)
                for i in range(32):
                    if (int(masks[g, r, w]) >> i) & 1:
                        c = w * 32 + i - front
                        with np.errstate(invalid="ignore"):
                            term = _f32(_f32(1.0 if ratio[g, r] == mm[c, r] else 0.0) * q[c, r])
                        s = _f32(s + term)
                sums.append(s)
            out[g, r] = _win_total(sums)
    return out


@pytest.mark.parametrize("index", range(4))
def test_dratio_by_scatter_equals_dense_sum(index):
    name, a = _edge_and_staged()[index]
    if a.compat.shape[1] > 300:
        a = lp_device.AscentInputs(**{
            n: (getattr(a, n)[:, :300] if n in ("compat", "onehot") else
                getattr(a, n)[:300] if n in ("alloc", "price", "valid", "uncapped") else
                getattr(a, n)) for n in lp_device.AscentInputs.NAMES})
    rng = np.random.default_rng(index)
    k = lp_device._Consts(torch.device("cpu"))
    f = lp_device._forward(a, a.lam0, k, initial=True)
    compat = a.compat.numpy()
    C, R = f["mm"].shape
    q = (rng.normal(0, 1, (C, R)) * (rng.random((C, R)) < 0.5)).astype(np.float32)
    q[rng.random((C, R)) < 0.05] = -0.0
    q[0, 0], q[1 % C, R - 1] = np.inf, np.nan
    indX = (f["X"] == f["mm"][None]).to(torch.float32)
    dX = indX * torch.from_numpy(q)[None]
    dXc = torch.where(a.compat[:, :, None], dX, k.zero)
    want = lp_device.xla_sum(dXc.permute(0, 2, 1)).numpy()
    got = mirror_dratio(compat, f["ratio"].numpy(), f["mm"].numpy(), q)
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), name


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("shape,smem", [
    ((194, 243, 4, 64), 72224),   # reserved_50k's LP
    ((20, 768, 4, 1), 95216),     # the consolidation union's certificate
    ((194, 61, 4, 64), 28912),    # a shard at S = 4
    ((194, 31, 4, 64), 21648),    # a shard at S = 8
    ((194, 122, 4, 64), 43376),   # a shard at S = 2
])
def test_layout_keeps_everything_in_shared_memory(shape, smem):
    lay = lp_device.ascent_layout(*shape)
    assert lay["global"] == [] and lay["scratch"] == 0
    assert lay["smem"] == smem <= SMEM_BUDGET
    assert all(o >= 0 and o % 16 == 0 for o in lay["offsets"])


def test_layout_over_budget_takes_global_memory():
    G = C = 2048
    lay = lp_device.ascent_layout(G, C, 16, 64)
    assert lay["smem"] <= SMEM_BUDGET and lay["scratch"] > 0
    assert {"masks", "colbits"} <= set(lay["global"])
    sizes = [-(-lp_device._ascent_array_bytes(s, G, C, 16, 64) // 16) * 16
             for _, s in lp_device.ASCENT_ARRAYS]
    spans = sorted((~o, ~o + n) for o, n in zip(lay["offsets"], sizes) if o < 0)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == lay["scratch"]


def test_array_bytes_follow_the_kernel():
    G, C, R, K = 194, 243, 4, 64
    b = {name: lp_device._ascent_array_bytes(s, G, C, R, K)
         for name, s in lp_device.ASCENT_ARRAYS}
    assert b["lam"] == 4 * G and b["ratio"] == 4 * G * R and b["mm"] == 4 * C * R
    assert b["colbits"] == 4 * C * 7 and b["masks"] == 4 * G * R * 8
    assert b["tbmask"] == 4 * 8 and b["mu"] == 4 * K
    assert lp_device._ascent_array_bytes(("nwc",), G, 24, R, K) == 4


# ---------------------------------------------------------------- dot plan


# (n, initial) -> (ic, iters, unrolled, epilogue lanes, epilogue
# iterations), or None for the scalar chain: read from the machine code
# of the JAX package's `_ascend` at the padding buckets (x86-64, FMA,
# 256-bit vectors)
DOT_PLANS = {
    (32, True): None, (32, False): (4, 1, True, 0, 0),
    (40, True): None, (40, False): (4, 1, True, 8, 1),
    (50, True): (2, 3, True, 2, 1), (63, False): (2, 3, True, 4, 3),
    (79, False): (4, 2, True, 4, 3), (99, True): (4, 3, True, 2, 1),
    (124, False): (4, 3, True, 4, 7), (155, True): (4, 4, True, 8, 3),
    (194, True): (4, 6, True, 2, 1), (194, False): (4, 6, True, 2, 1),
    (243, False): (4, 7, True, 8, 2), (304, True): (4, 9, True, 8, 2),
    (304, False): (4, 9, False, 8, 2), (475, True): (4, 14, True, 8, 3),
    (475, False): (4, 14, False, 8, 3), (594, True): (4, 18, False, 8, 2),
    (743, False): (4, 23, False, 2, 3), (929, True): (4, 29, False, 0, 0),
    (1162, False): (4, 36, False, 8, 1), (1453, True): (4, 45, False, 4, 3),
    (1817, False): (4, 56, False, 8, 3), (2048, True): (4, 64, False, 0, 0),
}


@pytest.mark.parametrize("key", sorted(DOT_PLANS))
def test_dot_plan_at_the_padding_buckets(key):
    n, initial = key
    p = lp_device.dot_plan(n, initial)
    want = DOT_PLANS[key]
    if want is None:
        assert p["scalar"]
        return
    assert not p["scalar"]
    assert (p["ic"], p["iters"], p["unrolled"], p["evf"], p["eiters"]) == want
    # every term is taken once: vector loop, epilogue, tail
    assert p["iters"] * 8 * p["ic"] + p["evf"] * p["eiters"] <= n


def test_dot_lane_order_takes_each_chunk_once():
    for ic, iters in ((4, 1), (2, 3), (4, 2), (4, 6), (4, 9)):
        for unrolled in (True, False):
            chains = lp_device.dot_lane_order(ic, iters, unrolled)
            flat = sorted(c for chain in chains for c in chain)
            assert flat == list(range(ic * iters))
    assert lp_device.dot_lane_order(4, 2, True) == [[0, 4, 5, 1, 6, 2, 7, 3]]


@pytest.mark.parametrize("a,b,c,want", [
    (2.0, 3.0, np.inf, np.inf), (1.0, 1.0, -np.inf, -np.inf), (0.0, np.inf, 1.0, np.nan),
    (3e38, 2.0, 0.0, np.inf), (-3e38, 2.0, 0.0, -np.inf), (2.0, 3.0, 1.0, 7.0),
    (-1.5838878e21, -1.5838878e21, 0.0, np.inf),
])
def test_plain_multiply_add_is_ieee_at_infinities(a, b, c, want):
    """`lp_plan._fma_f32`, the plain versions' multiply-add, gives what
    the kernels' __fmaf_rn gives where the sum overflows or an operand is
    infinite (a sum of squares past float32's range in B5's norm)."""
    got = _fma(np.float32(a), np.float32(b), np.float32(c))
    assert _same(got, np.float32(want))
