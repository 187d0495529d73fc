"""Where the packing kernels keep their tables: `pack_split.table_placement`.

B1, B3, B6, B7 and split B1 and B3 keep their config and group tables in
a block's dynamic shared memory while the card's budget holds them; past
it, a launch is spilled: its segments are walked in `KEEP_ORDER`, each
kept in shared memory while the budget holds it, the rest read in place
(read-only inputs) or placed in the block's global scratch slice
(mutable and derived state). The placement mirrors `Placement`,
`seg_bytes` and `check_placement` in `csrc/pack_common.cuh`; the spilled
kernels themselves run under `tests/cuda_emu/`
(`test_torch_spill_emu.py`) and on the card (`chip_smoke.py` phase 11).

Held here, with no card:
- at the main path's shapes the placement is the all-shared layout, segment
  by segment, and its bytes are `table_smem_bytes` (B1, B6 sequential,
  B7, split B1) and `wavefront_smem_bytes` (B3, B6 wavefront, split B3):
  a split kernel's pool entries are static arrays there;
- a split kernel of more than `X_POOLS` pools is placed, its pool
  segment sized by P1 and every segment in shared memory while it fits;
- at aws_catalog_50k's shapes (2,400 configs x 538 groups; Cs = 2,400 at
  S = 2) it spills the groups' compat bits first and keeps every config
  table in shared memory; at 7,200 configs config tables spill too;
- every wrapper passes its placement to its launch, with a scratch slice
  for every block of its grid, and counts a spilled launch under
  "<wrapper>_global", at those shapes and without raising.
Imports no JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import pack_dense, pack_shard
from karpenter_tpu_torch.solver import pack_split as k


def _align(n):
    return -(-n // 16) * 16


def _canonical(C, R, P1, K, G, pools=False, W=0, N=0):
    """A layout written out segment by segment: `table_layout`, a placed
    split kernel's pool segment (`pools`), `wave_layout`."""
    nw = k.words_pad(C)
    sizes = [_align(4 * C * R), _align(4 * P1 * R), _align(4 * C), _align(4 * C), _align(4 * C),
             _align(4 * K), _align(4 * (K + 1)), _align(4 * (K + 1)), _align(4 * C), _align(C),
             4 * nw, _align(4 * G), _align(4 * G * R), 4 * G * nw]
    sizes += [_align(8 * P1) + 2 * _align(4 * P1)] if pools else [0]
    if W:
        ww = -(-W // 32)
        sizes += [_align(4 * W * 8), _align(4 * W * ww), _align(4 * -(-G // 32)),
                  _align(4 * (W + 1)), _align(4 * ww), _align(4 * W), _align(4 * W),
                  _align(4 * -(-N // 32))]
    else:
        sizes += [0] * 8
    offsets = list(np.cumsum([0] + sizes[:-1]))
    return offsets, sum(sizes)


TODAY = [  # (C, R, P1, K, G, W, N): the main path's shapes (PERF.md §4)
    (224, 4, 2, 0, 194, 16, 1453),     # the first 50k x 500 request
    (256, 4, 3, 40, 194, 16, 5580),    # reserved_50k's cost arm, planned rows
    (768, 4, 2, 0, 20, 16, 693),       # consolidation_500's lane union
    (160, 4, 2, 0, 243, 16, 51_680),   # million_pod unsharded
    (20, 4, 2, 0, 243, 16, 51_680),    # million_pod at S = 8
    (1, 1, 1, 0, 1, 1, 32),
]


@pytest.mark.parametrize("C, R, P1, K, G, W, N", TODAY)
def test_placement_at_the_main_paths_shapes_is_the_all_shared_layout(C, R, P1, K, G, W, N):
    b1 = k.table_placement(C, R, P1, K, G)
    assert b1["offsets"] == _canonical(C, R, P1, K, G)[0]
    assert b1["smem"] == k.table_smem_bytes(C, R, P1, K, G) == _canonical(C, R, P1, K, G)[1]
    b3 = k.table_placement(C, R, P1, K, G, W=W, N=N)
    assert b3["offsets"] == _canonical(C, R, P1, K, G, W=W, N=N)[0]
    assert b3["smem"] == k.wavefront_smem_bytes(C, R, P1, K, W, G, N)
    # a split kernel's: the same layout (its pool entries static arrays)
    s1 = k.table_placement(C, R, P1, K, G, pools=True)
    assert s1["offsets"] == b1["offsets"] and s1["smem"] == b1["smem"]
    s3 = k.table_placement(C, R, P1, K, G, pools=True, W=W, N=N)
    assert s3["offsets"] == b3["offsets"] and s3["smem"] == b3["smem"]
    for lay in (b1, b3, s1, s3):
        assert not lay["spilled"] and lay["global"] == [] and lay["scratch"] == 0
        assert lay["smem"] <= k.SMEM_BUDGET


@pytest.mark.parametrize("P1, W", [(65, 0), (81, 0), (81, 16), (300, 16)])
def test_split_kernels_past_the_static_pools_are_placed_in_shared_memory(P1, W):
    # more than X_POOLS pools: the placed layout, its pool segment (sized
    # by P1) in shared memory with every other segment, none in global
    # memory, at the main path's first shape
    C, R, K, G, N = 224, 4, 0, 194, 1453
    assert k.table_placement(C, R, k.X_POOLS, K, G, pools=True, W=W, N=N)["spilled"] is False
    lay = k.table_placement(C, R, P1, K, G, pools=True, W=W, N=N)
    _check_placement(lay, C, R, P1, K, G, True, W, N)
    assert lay["spilled"] and lay["global"] == [] and lay["scratch"] == 0
    assert lay["smem"] == (k.wavefront_smem_bytes(C, R, P1, K, W, G, N) if W
                           else k.table_smem_bytes(C, R, P1, K, G)) + k.pool_smem_bytes(P1)
    assert "placed, all in shared memory" in k.placement_text(lay)
    # the unsplit kernels have no pool entries: all shared at any P1
    assert not k.table_placement(C, R, P1, K, G, W=W, N=N)["spilled"]


def _check_placement(lay, C, R, P1, K, G, pools=False, W=0, N=0, budget=k.SMEM_BUDGET):
    """What `check_placement` in csrc/pack_common.cuh checks, and more:
    the shared segments and the scratch ones do not overlap."""
    size = k.segment_bytes(C, R, P1, K, G, pools, W, N)
    assert lay["smem"] <= budget
    shared, scratch = [], []
    for name, off in zip(k.SEGMENTS, lay["offsets"]):
        n = size[name]
        if off >= 0:
            assert off % 16 == 0 and off + n <= lay["smem"], name
            shared.append((off, off + n))
        else:
            assert name not in k.PINNED_SEGMENTS or n == 0, name
            assert (name in lay["global"]) == (n > 0), name
            if name not in k.INPUT_SEGMENTS:
                assert ~off % 16 == 0 and ~off + n <= lay["scratch"], name
                scratch.append((~off, ~off + n))
    for spans in (shared, scratch):
        spans = sorted(s for s in spans if s[1] > s[0])
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


CONFIG_TABLES = ("alloc", "price", "pool", "rsv", "kopen", "fits", "capped")


@pytest.mark.parametrize("C, G, pools", [(2400, 538, False), (2848, 594, False),
                                         (2400, 538, True), (2784, 594, True)])
def test_placement_at_the_catalog_spills_the_groups_rows_first(C, G, pools):
    # aws_catalog_50k: 2,400 configs x 538 groups (staged: 2,848 x 594);
    # its split hold: 4,800 configs at S = 2, Cs = 2,400 (staged 2,784)
    R, P1, K = 4, 2, 0
    assert k.table_smem_bytes(C, R, P1, K, G) > k.SMEM_BUDGET
    for W, N in ((0, 0), (16, 9000)):
        lay = k.table_placement(C, R, P1, K, G, pools=pools, W=W, N=N)
        _check_placement(lay, C, R, P1, K, G, pools, W, N)
        assert lay["spilled"] and lay["global"] == ["gbits"]
        assert lay["scratch"] == 4 * G * k.words_pad(C)
        assert all(lay["offsets"][k.SEGMENTS.index(n)] >= 0 for n in CONFIG_TABLES)


def test_placement_at_the_catalogs_ceilings():
    # B1's table at 2,400 configs: 253,888 B at 538 groups, the ceiling
    # at 446; at 4,800 configs it is 103 groups
    assert k.table_smem_bytes(2400, 4, 2, 0, 538) == 253_888
    assert k.table_smem_bytes(2400, 4, 2, 0, 446) <= k.SMEM_BUDGET
    assert k.table_smem_bytes(2400, 4, 2, 0, 447) > k.SMEM_BUDGET
    assert k.table_smem_bytes(4800, 4, 2, 0, 103) <= k.SMEM_BUDGET
    assert k.table_smem_bytes(4800, 4, 2, 0, 104) > k.SMEM_BUDGET
    assert not k.table_placement(2400, 4, 2, 0, 446)["spilled"]
    assert k.table_placement(2400, 4, 2, 0, 447)["spilled"]


@pytest.mark.parametrize("pools, W", [(False, 0), (False, 16), (True, 0), (True, 16)])
def test_placement_at_7200_configs_spills_config_tables_too(pools, W):
    C, R, P1, K, G, N = 7200, 4, 2, 40, 538, 20_000
    lay = k.table_placement(C, R, P1, K, G, pools=pools, W=W, N=N)
    _check_placement(lay, C, R, P1, K, G, pools, W, N)
    spilled = set(lay["global"])
    assert "gbits" in spilled and "price" in spilled
    # the sweep's tables stay longest
    assert "alloc" not in spilled and "capped" not in spilled
    # the walk's invariant: a segment kept after one that spilled is
    # smaller than it (it fit in what the spilled one could not)
    size = k.segment_bytes(C, R, P1, K, G, pools, W, N)
    order = [n for n in k.KEEP_ORDER if size[n]]
    for i, x in enumerate(order):
        if x in spilled:
            assert all(size[y] < size[x] for y in order[i + 1:] if y not in spilled), x


def test_forced_budget_spills_a_shape_that_fits_and_restores():
    C, R, P1, K, G = 224, 4, 2, 0, 194
    assert not k.table_placement(C, R, P1, K, G)["spilled"]
    small = k.table_smem_bytes(C, R, P1, K, G) - 1
    lay = k.table_placement(C, R, P1, K, G, budget=small)
    _check_placement(lay, C, R, P1, K, G, budget=small)
    assert lay["global"] == ["gbits"]
    tiny = k.table_placement(C, R, P1, K, G, budget=0)
    _check_placement(tiny, C, R, P1, K, G, budget=0)
    assert tiny["smem"] == 0 and set(tiny["global"]) == {
        n for n, b in k.segment_bytes(C, R, P1, K, G).items() if b}
    with k.forced_budget(small):
        assert k._budget[0] == small
    assert k._budget[0] == k.SMEM_BUDGET


def test_round_bookkeeping_past_the_budget_raises_with_the_numbers():
    # B3's pinned bookkeeping stays in shared memory whatever the budget
    # (a forced budget of 0 keeps it there); alone past the card's budget
    # (the committed groups' bits of 10M groups) the placement raises
    lay = k.table_placement(224, 4, 2, 0, 194, W=256, N=1453, budget=0)
    size = k.segment_bytes(224, 4, 2, 0, 194, W=256, N=1453)
    assert lay["smem"] == sum(size[n] for n in k.PINNED_SEGMENTS)
    with pytest.raises(ValueError, match="round bookkeeping.*G=10000000 W=16"):
        k.table_placement(224, 4, 2, 0, 10_000_000, W=16, N=1453)


# ---------------------------------------------------------------- wrappers


class _FakeLib:
    """Stands in for a kernel library: records each launch's arguments
    and reports success, so that the wrappers' host side runs on the CPU."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            if name == "pack_probe_wavefront_launch":
                args[-2]._obj.value = 4  # lanes (blocks) the card holds at once
            if name == "pack_wavefront_sharded_launch":
                args[-3]._obj.value, args[-2]._obj.value = 1, 132
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(k, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(pack_shard, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(pack_dense, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(k, "_lib", lambda name: lib)
    monkeypatch.setattr(pack_shard, "_lib", lambda name: lib)
    monkeypatch.setattr(k, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(pack_shard, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(pack_dense, "_stream", lambda: ctypes.c_void_p(0))
    from karpenter_tpu_torch import cuda_build
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    return lib


def _inputs(C, G, R=4, B=3, P1=2, seed=0):
    """Zero-cost inputs of a packing launch at a catalog-sized shape
    (only the shapes matter to the host side)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    args = [t(rng.random((G, C)) < 0.5), torch.ones((G, R)), torch.ones((G,), dtype=torch.int32),
            torch.ones((C, R)), torch.zeros((C,), dtype=torch.int32), torch.zeros((P1, R)),
            torch.zeros((G, B), dtype=torch.bool), torch.ones((B, R)), torch.zeros((B, R)),
            torch.zeros((B,), dtype=torch.int32), torch.ones((B,), dtype=torch.bool),
            torch.ones((C,))]
    return args


def _launched(lib, name, n=1):
    calls = [a for c, a in lib.calls if c == name]
    assert len(calls) == n, [c for c, _ in lib.calls]
    return calls


def _placement_of(args, lay):
    """The (offsets, scratch pointer, block bytes) a launch passed."""
    i = next(j for j, a in enumerate(args) if isinstance(a, ctypes.Array))
    offsets, scratch, per = args[i], args[i + 1], args[i + 2]
    assert list(offsets) == lay["offsets"]
    return scratch, per


@pytest.mark.parametrize("spill", [False, True])
def test_unsplit_wrappers_pass_their_placement(fake_card, spill):
    # aws_catalog_50k's staged shape (Cp = 2,848, Gp = 594), or a shape
    # that fits; B1, B3 (W = 16), B6 both programs (2 lanes), B7
    C, G = (2848, 594) if spill else (224, 194)
    R, P1, K, F, W, L = 4, 2, 0, 40, 16, 2
    args = _inputs(C, G)
    B = args[7].shape[0]
    N = B + F
    k.reset_launch_counts()
    pack_dense.reset_launch_counts()
    k._pack_split_cuda(*args, max_free=F)
    k._pack_split_wavefront_cuda(*args, max_free=F, width=W)
    lanes = list(args)
    lanes[2] = args[2][None].repeat(L, 1)
    lanes[10] = args[10][None].repeat(L, 1)
    k._pack_probe_lanes_cuda(*lanes, max_free=F)
    k._pack_probe_lanes_wavefront_cuda(*lanes, max_free=F, width=W)
    emask = torch.zeros((B, C), dtype=torch.bool)
    dargs = args[:6] + [emask, args[8], args[11]]
    pack_dense._pack_cuda(*dargs, max_nodes=N)
    b1 = k.table_placement(C, R, P1, K, G)
    b3 = k.table_placement(C, R, P1, K, G, W=W, N=N)
    # B1 and B6 sequential share one launch, a block a lane
    for name, lay, n in (("pack_split_launch", b1, 2), ("pack_wavefront_launch", b3, 1),
                         ("pack_probe_wavefront_launch", b3, 1), ("pack_dense_launch", b1, 1)):
        for call in _launched(fake_card, name, n):
            assert lay["spilled"] == spill
            if spill:
                scratch, per = _placement_of(call, lay)
                assert per >= lay["scratch"] and scratch.value
            else:
                assert not any(isinstance(a, ctypes.Array) for a in call)
    for name in ("pack_split", "pack_split_wavefront", "pack_probe_lanes",
                 "pack_probe_lanes_wavefront"):
        assert k.LAUNCHES[name] == 1
        assert k.LAUNCHES[f"{name}_global"] == int(spill)
        assert ("global: gbits" in k.DYNAMIC_SMEM[name]) == spill
    assert pack_dense.LAUNCHES["pack"] == 1 and pack_dense.LAUNCHES["pack_global"] == int(spill)


@pytest.mark.parametrize("S, Cs, P1", [(2, 2784, 2), (4, 64, 81)])
def test_split_wrappers_pass_their_placement_and_take_any_pool_count(fake_card, S, Cs, P1):
    # the catalog's split hold (4,800 configs at S = 2: Cs = 2,784 staged,
    # spilled), and 80 node pools (P1 = 81) at a shape that fits (placed,
    # past the static pool entries: counted with the spilled launches)
    G, R, K, F, W = 594 if Cs > 1000 else 40, 4, 0, 40, 16
    args = _inputs(Cs * S, G, P1=P1)
    split = list(args)
    for i, axis in ((0, 1), (3, 0), (4, 0), (11, 0)):
        split[i] = [b.contiguous() for b in torch.chunk(args[i], S, dim=axis)]
    B = args[7].shape[0]
    N = B + F
    pack_shard.reset_launch_counts()
    pack_shard._pack_split_sharded_cuda(*split, max_free=F)
    pack_shard._pack_split_wavefront_sharded_cuda(*split, max_free=F, width=W)
    spill = Cs > 1000 or P1 > k.X_POOLS
    for name, lay, what in (
            ("pack_split_sharded_launch", k.table_placement(Cs, R, P1, K, G, pools=True),
             "pack_split_sharded"),
            ("pack_wavefront_sharded_launch",
             k.table_placement(Cs, R, P1, K, G, pools=True, W=W, N=N),
             "pack_split_wavefront_sharded")):
        call = _launched(fake_card, name)[0]
        assert lay["spilled"] == spill
        if spill:
            _placement_of(call, lay)
        # the exchange's slot words hold every pool's four entries
        words = call[35] if what == "pack_split_sharded" else call[49]
        assert call[32 if what == "pack_split_sharded" else 45] == P1 and words >= 4 * P1
        assert pack_shard.LAUNCHES[what] == 1
        assert pack_shard.LAUNCHES[f"{what}_global"] == int(spill)


@pytest.mark.parametrize("lanes", [1, 3])
def test_flat_routes_hand_the_kernels_their_regions(fake_card, lanes):
    # the in-place flat routes: the packing launch gets the regions of one
    # flat buffer as assign, free_mask, node_count and unsched (B3 also
    # steps and widths) and, over lanes, the row as their lane stride; B6
    # sequential takes `LANE_THREADS` threads a block, B1 1024; a buffer
    # of another layout is refused
    C, G, F, W = 224, 12, 40, 16
    args = _inputs(C, G)
    B = args[7].shape[0]
    N = B + F
    lane_args = list(args)
    lane_args[2] = args[2][None].repeat(lanes, 1)
    lane_args[10] = args[10][None].repeat(lanes, 1)
    runs = (("pack_split_launch", k._pack_split_cuda, args, False, 1),
            ("pack_wavefront_launch", k._pack_split_wavefront_cuda, args, True, 1),
            ("pack_split_launch", k._pack_probe_lanes_cuda, lane_args, False, lanes))
    for name, fn, a, stats, L in runs:
        fake_card.calls.clear()
        buf, lay = k.flat_buffer(L, N, G, F, C, stats, torch.device("cpu"))
        kw = {"width": W} if "wavefront" in name else {}
        assert fn(*a, max_free=F, flat=(buf, lay), **kw) is None
        call = _launched(fake_card, name)[0]
        base = buf.data_ptr()
        at = {key: base + 4 * lay[key] for key in ("masks", "count", "unsched", "steps",
                                                   "widths")}
        ptrs = call[17:23] if stats else call[17:21]
        want = [base, at["masks"], at["count"], at["unsched"]]
        if stats:
            want += [at["steps"], at["widths"]]
        assert list(ptrs) == want, name
        if name == "pack_split_launch":
            threads, row = call[35], call[36]
            assert threads == (1024 if fn is k._pack_split_cuda else k.LANE_THREADS)
            assert row == lay["row"]
        other = k.flat_layout(L, N, G, F, C, not stats)
        with pytest.raises(ValueError, match="flat buffer"):
            fn(*a, max_free=F, flat=(torch.zeros(other["total"], dtype=torch.int32), other),
               **kw)


@pytest.mark.parametrize("F", [40, 2000])
def test_b6_sequential_takes_its_block_size_at_any_rows(fake_card, F):
    # B6 sequential launches `LANE_THREADS` threads a block whether its
    # rows take one chunk or many (its sweep walks them), B1 1024
    C, G = 224, 12
    args = _inputs(C, G)
    lane_args = list(args)
    lane_args[2] = args[2][None].repeat(3, 1)
    lane_args[10] = args[10][None].repeat(3, 1)
    for fn, a, want in ((k._pack_split_cuda, args, 1024),
                        (k._pack_probe_lanes_cuda, lane_args, k.LANE_THREADS)):
        fake_card.calls.clear()
        fn(*a, max_free=F)
        call = _launched(fake_card, "pack_split_launch")[0]
        assert call[35] == want and call[36] == 0, fn.__name__
