"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere (the CUDA kernels have
no CPU mode). On a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest pins JAX to the CPU, and this
file imports no JAX.) Covers B1-B5 (B4 also in its layouts that read
the groups' tables in place, past its staged layout's ceiling; B5 also
at edge shapes, one on its global-memory path, its wide layout's
cluster on the wide cases, and its phase-clock build) and B6 (both lane
programs, the wavefront one at widths 8 and 16, the sequential one at each
block size it can take, and the lane epilogue), the flat routes in place
(B1, B3 and both B6 programs writing into the flat buffer's regions, the
mask epilogue), B7
(the dense kernel and its flat epilogue, held also to B1 on the same
problems, and the port's `graft_entry.entry()` on the card), the
consolidation ladder on the card against the CPU, and the packing
kernels' spilled layouts (B1, B3, B7 under a forced shared-memory
budget) and split B1 with 80 node pools, all shared and spilled. Tolerance:
byte-identical outputs — the kernels use the plain versions' f32
operation order and index tie-breaks.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels have no CPU mode")
    from karpenter_tpu_torch import cuda_build

    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc: the CUDA kernels cannot be built here")
    cuda_build.build_all()
    from karpenter_tpu_torch.solver import pack_split

    return pack_split


@pytest.fixture(scope="module")
def cases():
    from karpenter_tpu_torch.testing import kernel_cases

    return kernel_cases(1, n_pods=800, n_types=24)


def _cuda(case):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).cuda()

    return [put(a) for a in case.args], {k: put(v) for k, v in case.kwargs.items()}


@pytest.mark.parametrize("index", range(10))
def test_kernels_match_plain_versions(cuda_kernels, cases, index):
    case = cases[index]
    args, kw = _cuda(case)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.pack_split(*args, max_free=case.max_free, mode=case.mode, **kw)
    want = cuda_kernels.pack_split_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    flat = cuda_kernels.pack_flat_words(*got)
    assert torch.equal(flat, cuda_kernels.pack_flat_words_ref(*got)), case.name
    assert cuda_kernels.LAUNCHES["pack_split"] == before["pack_split"] + 1
    assert cuda_kernels.LAUNCHES["pack_split_flat"] == before["pack_split_flat"] + 1


@pytest.mark.parametrize("width", [1, 8, 16])
@pytest.mark.parametrize("index", range(10))
def test_wavefront_matches_plain_version_and_b1(cuda_kernels, cases, index, width):
    case = cases[index]
    args, kw = _cuda(case)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.pack_split_wavefront(
        *args, max_free=case.max_free, mode=case.mode, width=width, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["pack_split_wavefront"] == before["pack_split_wavefront"] + 1
    want = cuda_kernels.pack_split_wavefront_ref(
        *args, max_free=case.max_free, mode=case.mode, width=width, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    seq = cuda_kernels.pack_split(*args, max_free=case.max_free, mode=case.mode, **kw)
    for a, b in zip(got[:4], seq):
        assert torch.equal(a, b), case.name
    flat = cuda_kernels.pack_flat_words(*got[:4], got[5], got[4])
    assert torch.equal(flat, cuda_kernels.pack_flat_words_ref(*got[:4], got[5], got[4]))


@pytest.fixture(scope="module")
def odd_cases(cases):
    """Config axes the staging never gives the kernels: a width that is
    not a multiple of 32 (cut from a case with bound rows, quotas, caps
    and conflicts), and one wider than the consolidation union's 768
    (a reservations case padded with pseudo-configs)."""
    from karpenter_tpu_torch.testing import config_axis

    return [config_axis(cases[4], 200 if cases[4].args[0].shape[1] > 200 else 45),
            config_axis(cases[3], 800)]


@pytest.mark.parametrize("width", [1, 8, 16, 32])
@pytest.mark.parametrize("index", range(2))
def test_odd_config_axes_match_plain_versions_and_b1(cuda_kernels, odd_cases, index, width):
    k = cuda_kernels
    case = odd_cases[index]
    args, kw = _cuda(case)
    assert args[0].shape[1] % 32 != 0 or args[0].shape[1] >= 768
    seq = k.pack_split(*args, max_free=case.max_free, mode=case.mode, **kw)
    got = k.pack_split_wavefront(*args, max_free=case.max_free, mode=case.mode, width=width,
                                 **kw)
    torch.cuda.synchronize()
    want = k.pack_split_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    for a, b in zip(seq, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    want = k.pack_split_wavefront_ref(*args, max_free=case.max_free, mode=case.mode,
                                      width=width, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    for a, b in zip(got[:4], seq):
        assert torch.equal(a, b), case.name


def test_solve_on_card_matches_cpu(cuda_kernels, monkeypatch):
    from karpenter_tpu_torch.solver import pack
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.solver import fingerprint, solve
    from karpenter_tpu_torch.workloads import build_problem

    monkeypatch.delenv("KARPENTER_WAVEFRONT", raising=False)
    monkeypatch.delenv("KARPENTER_WAVEFRONT_WIDTH", raising=False)
    pods, pools = build_problem(1500, 40, seed=4)
    assert fingerprint(solve(pods, pools)) == fingerprint(solve(pods, pools, device="cpu"))
    # the card routes the wavefront kernel, as the JAX package does on
    # an accelerator: fewer rounds than padded groups
    enc = encode(group_pods(pods), pools)
    before = cuda_kernels.LAUNCHES["pack_split_wavefront"]
    res = pack.solve_packing(enc, device="cuda")
    assert cuda_kernels.LAUNCHES["pack_split_wavefront"] > before
    assert res.wavefront_widths is not None
    assert res.device_steps < pack._pad_axis(enc.compat.shape[0])


@pytest.fixture(scope="module")
def lp_kernels():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels have no CPU mode")
    from karpenter_tpu_torch import cuda_build

    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc: the CUDA kernels cannot be built here")
    cuda_build.build_all()
    from karpenter_tpu_torch.solver import lp_device, lp_plan

    return lp_plan, lp_device


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("index", range(8))
def test_price_kernel_matches_plain_version(lp_kernels, index):
    from karpenter_tpu_torch.testing import price_cases

    lp_plan, _ = lp_kernels
    name, case = price_cases(1)[index]
    xs = [torch.from_numpy(x).cuda() for x in case]
    before = lp_plan.LAUNCHES["lp_price"]
    q, v = lp_plan.price_kernel(*xs)
    torch.cuda.synchronize()
    assert lp_plan.LAUNCHES["lp_price"] == before + 1
    qr, vr = lp_plan.price_kernel_ref(*xs)
    assert _same_bits(q, qr) and _same_bits(v, vr), name


@pytest.mark.parametrize("G, layout", [(194, 1), (194, 2), (7_000, None), (20_000, None)])
def test_price_kernel_global_layouts_match_plain_version(lp_kernels, G, layout):
    # B4 with the groups' tables read in place: forced at a staged shape,
    # and past the staged layout's ceiling at the wrapper's choice (the
    # walk order kept at 7,000 groups, the full argmax at 20,000)
    from karpenter_tpu_torch.testing import price_case

    lp_plan, _ = lp_kernels
    xs = [torch.from_numpy(x).cuda() for x in price_case(9, G, 64, 4)]
    before = dict(lp_plan.LAUNCHES)
    q, v = lp_plan.price_kernel(*xs, layout=layout)
    torch.cuda.synchronize()
    assert lp_plan.LAUNCHES["lp_price_global"] == before["lp_price_global"] + 1
    qr, vr = lp_plan.price_kernel_ref(*xs)
    assert _same_bits(q, qr) and _same_bits(v, vr), (G, layout)


@pytest.mark.parametrize("n_iters", [8, 192])
@pytest.mark.parametrize("index", range(3))
def test_ascent_kernel_matches_plain_version(lp_kernels, index, n_iters):
    from karpenter_tpu_torch.testing import ascent_cases

    _, lp_device = lp_kernels
    name, inputs = ascent_cases(2)[index]
    a = inputs.to("cuda")
    before = lp_device.LAUNCHES["lp_ascend"]
    got = lp_device.ascend(a, n_iters)
    torch.cuda.synchronize()
    assert lp_device.LAUNCHES["lp_ascend"] == before + 1
    want = lp_device.ascend_ref(a, n_iters)
    for x, y in zip(got, want):
        assert _same_bits(x, y), name


@pytest.mark.parametrize("index", range(4))
def test_ascent_kernel_matches_plain_version_at_edge_shapes(lp_kernels, index):
    """B5 on `testing.ascent_edge_cases`: the shape whose arrays exceed the
    shared memory runs the same kernel with them in global memory (counted
    under "lp_ascend_global"), the others entirely in shared memory."""
    from karpenter_tpu_torch.testing import ascent_edge_cases

    _, lp_device = lp_kernels
    name, inputs = ascent_edge_cases(3)[index]
    a = inputs.to("cuda")
    n_iters = 8 if name == "ascent-global" else 64
    before = dict(lp_device.LAUNCHES)
    got = lp_device.ascend(a, n_iters)
    torch.cuda.synchronize()
    assert lp_device.LAUNCHES["lp_ascend"] == before["lp_ascend"] + 1
    on_global = lp_device.LAUNCHES["lp_ascend_global"] - before["lp_ascend_global"]
    assert on_global == (1 if name == "ascent-global" else 0), name
    want = lp_device.ascend_ref(a, n_iters)
    for x, y in zip(got, want):
        assert _same_bits(x, y), name


@pytest.mark.parametrize("index", range(6))
def test_ascent_wide_cluster_matches_plain_version(lp_kernels, index):
    """B5's wide layout on `testing.ascent_wide_cases`: one cluster of
    `lp_device.ascent_cluster` blocks (16 past 512 configs; the 64 and 96
    configs of the group-wide cases are 2 and 3 windows), a few
    iterations, and its phase-clock build, which counts its cluster
    barriers."""
    from karpenter_tpu_torch.solver import pack_split
    from karpenter_tpu_torch.testing import ascent_wide_cases

    _, lp_device = lp_kernels
    name, inputs = ascent_wide_cases(0)[index]
    a = inputs.to("cuda")
    n_iters = 3 if a.compat.shape[0] > 4000 else 8
    before = dict(lp_device.LAUNCHES)
    got = lp_device.ascend(a, n_iters)
    torch.cuda.synchronize()
    assert lp_device.LAUNCHES["lp_ascend_wide"] == before["lp_ascend_wide"] + 1
    want = lp_device.ascend_ref(a, n_iters)
    for x, y in zip(got, want):
        assert _same_bits(x, y), name
    with pack_split.phase_clocks("lp_ascend") as take:
        again = lp_device.ascend(a, n_iters)
        clk = take()
    for x, y in zip(again, want):
        assert _same_bits(x, y), name
    assert clk["count"] == n_iters and clk["cluster barriers"] >= 6 * n_iters, name


def test_ascent_phase_clocks_build(lp_kernels):
    """B5's phase-clock build (`lp_ascend_clocks`) gives the same result
    and counts its iterations, its phases' cycles and its barriers."""
    from karpenter_tpu_torch.solver import pack_split
    from karpenter_tpu_torch.testing import ascent_cases

    _, lp_device = lp_kernels
    _, inputs = ascent_cases(2)[1]
    a = inputs.to("cuda")
    want = lp_device.ascend(a, 16)
    with pack_split.phase_clocks("lp_ascend") as take:
        got = lp_device.ascend(a, 16)
        clk = take()
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert clk["count"] == 16 and clk["barriers"] > 16
    assert all(clk[p] > 0 for p in pack_split.PHASES["lp_ascend"])


def test_cost_solve_on_card_matches_cpu(lp_kernels):
    from karpenter_tpu_torch.solver.solver import fingerprint, reset_caches, solve
    from karpenter_tpu_torch.workloads import build_problem

    lp_plan, lp_device = lp_kernels
    pods, pools = build_problem(1500, 60, seed=3, reservations=True)
    reset_caches()
    before = (lp_plan.LAUNCHES["lp_price"], lp_device.LAUNCHES["lp_ascend"])
    card = solve(pods, pools, objective="cost")
    assert lp_plan.LAUNCHES["lp_price"] > before[0]
    assert lp_device.LAUNCHES["lp_ascend"] > before[1]
    reset_caches()
    cpu = solve(pods, pools, objective="cost", device="cpu")
    assert fingerprint(card) == fingerprint(cpu)
    assert card.lp["guided"] and card.lp["lower_bound"] <= card.total_price + 1e-6


@pytest.fixture(scope="module")
def probe_cases():
    from karpenter_tpu_torch.testing import lane_cases

    return lane_cases(1, n_pods=800, n_types=40)


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("index", range(2))
def test_probe_lane_kernels_match_plain_versions(cuda_kernels, probe_cases, index, mode):
    k = cuda_kernels
    case = probe_cases[index]
    args, kw = _cuda(case)
    before = dict(k.LAUNCHES)
    seq = k.pack_probe_lanes(*args, max_free=case.max_free, mode=mode, **kw)
    torch.cuda.synchronize()
    assert k.LAUNCHES["pack_probe_lanes"] == before["pack_probe_lanes"] + 1
    want = k.pack_probe_lanes_ref(*args, max_free=case.max_free, mode=mode, **kw)
    for a, b in zip(seq, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    flat = k.pack_flat_lanes(*seq)
    assert torch.equal(flat, k.pack_flat_lanes_ref(*seq)), case.name
    for width in (8, 16):
        wf = k.pack_probe_lanes_wavefront(
            *args, max_free=case.max_free, mode=mode, width=width, **kw)
        torch.cuda.synchronize()
        assert k.ACTIVE_LANES["pack_probe_lanes_wavefront"] >= 1
        want = k.pack_probe_lanes_wavefront_ref(
            *args, max_free=case.max_free, mode=mode, width=width, **kw)
        for a, b in zip(wf, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (case.name, width)
        for a, b in zip(wf[:4], seq):
            assert torch.equal(a, b), (case.name, width)
        flat = k.pack_flat_lanes(*wf[:4], wf[5], wf[4])
        assert torch.equal(flat, k.pack_flat_lanes_ref(*wf[:4], wf[5], wf[4]))
    assert k.LAUNCHES["pack_probe_lanes_wavefront"] == before["pack_probe_lanes_wavefront"] + 2
    assert k.LAUNCHES["pack_probe_lanes_flat"] == before["pack_probe_lanes_flat"] + 3


@pytest.mark.parametrize("index", range(2))
def test_b6_sequential_and_the_lane_flat_routes(cuda_kernels, probe_cases, index):
    # B6 sequential (its sweep walking chunks of its block's rows), and
    # the lane flat routes: the sequential program writing in place, then
    # the mask epilogue (counted on its own), and the wavefront program's
    # full copy: equal to the plain versions and the plain lane epilogue
    k = cuda_kernels
    case = probe_cases[index]
    args, kw = _cuda(case)
    mode = ("ffd", "cost")[index]
    before = dict(k.LAUNCHES)
    seq = k.pack_probe_lanes(*args, max_free=case.max_free, mode=mode, **kw)
    flat = k.pack_probe_lanes_flat(*args, max_free=case.max_free, mode=mode, **kw)
    torch.cuda.synchronize()
    assert k.LAUNCHES["pack_probe_lanes"] == before["pack_probe_lanes"] + 2
    assert k.LAUNCHES["pack_probe_lanes_flat_masks"] == before["pack_probe_lanes_flat_masks"] + 1
    assert k.LAUNCHES["pack_probe_lanes_flat"] == before["pack_probe_lanes_flat"]
    want = k.pack_probe_lanes_ref(*args, max_free=case.max_free, mode=mode, **kw)
    for a, b in zip(seq, want):
        assert a.dtype == b.dtype and torch.equal(a, b), case.name
    assert torch.equal(flat, k.pack_flat_lanes_ref(*want)), case.name
    wf = k.pack_probe_lanes_flat(*args, max_free=case.max_free, mode=mode, wavefront=16, **kw)
    plain = k.pack_probe_lanes_wavefront_ref(*args, max_free=case.max_free, mode=mode,
                                             width=16, **kw)
    assert torch.equal(wf, k.pack_flat_lanes_ref(*plain[:4], plain[5], plain[4]))
    assert k.LAUNCHES["pack_probe_lanes_flat"] == before["pack_probe_lanes_flat"] + 1


@pytest.mark.parametrize("wavefront", [0, 16])
@pytest.mark.parametrize("index", range(10))
def test_flat_route_in_place_matches_plain_version(cuda_kernels, cases, index, wavefront):
    # pack_split_flat: B1 or B3 writing into the buffer's regions, then
    # the mask epilogue, one launch of each counted
    k = cuda_kernels
    case = cases[index]
    args, kw = _cuda(case)
    before = dict(k.LAUNCHES)
    got = k.pack_split_flat(*args, max_free=case.max_free, mode=case.mode,
                            wavefront=wavefront, **kw)
    torch.cuda.synchronize()
    route = "pack_split_wavefront" if wavefront else "pack_split"
    assert k.LAUNCHES[route] == before[route] + 1
    assert k.LAUNCHES["pack_split_flat"] == before["pack_split_flat"] + 1
    if wavefront:
        o = k.pack_split_wavefront_ref(*args, max_free=case.max_free, mode=case.mode,
                                       width=wavefront, **kw)
        want = k.pack_flat_words_ref(*o[:4], o[5], o[4])
    else:
        want = k.pack_split_flat_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want), case.name


def test_consolidation_ladder_on_card_matches_cpu(cuda_kernels, monkeypatch):
    from karpenter_tpu_torch.testing import consolidation_ladder
    from karpenter_tpu_torch.workloads import consolidation_fleet

    monkeypatch.delenv("KARPENTER_WAVEFRONT", raising=False)
    monkeypatch.delenv("KARPENTER_PROBE_BATCH_WIDTH", raising=False)
    fleet = consolidation_fleet(1500, 30)
    before = cuda_kernels.LAUNCHES["pack_probe_lanes_wavefront"]
    card = consolidation_ladder(*fleet, batched=True)
    assert cuda_kernels.LAUNCHES["pack_probe_lanes_wavefront"] > before
    monkeypatch.setenv("KARPENTER_PROBE_BATCH_WIDTH", "8")
    cpu = consolidation_ladder(*consolidation_fleet(1500, 30, device="cpu"),
                               batched=True, device="cpu")
    assert card.decisions == cpu.decisions and card.probes == cpu.probes


@pytest.fixture(scope="module")
def dense_kernels(cuda_kernels):
    from karpenter_tpu_torch.solver import pack_dense
    from karpenter_tpu_torch.testing import dense_cases

    return pack_dense, dense_cases(1, n_pods=800, n_types=60)


def _cuda_dense(case):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).cuda()

    return [put(a) for a in case.args], {k: put(v) for k, v in case.kwargs.items()}


@pytest.mark.parametrize("index", range(12))
def test_dense_kernel_matches_plain_version_and_b1(dense_kernels, index):
    from karpenter_tpu_torch.testing import split_mismatch

    pd, cases = dense_kernels
    case = cases[index]
    args, kw = _cuda_dense(case)
    before = dict(pd.LAUNCHES)
    got = pd.pack(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    torch.cuda.synchronize()
    assert pd.LAUNCHES["pack"] == before["pack"] + 1
    want = pd.pack_ref(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    for a, b in zip(got, want):
        assert _same_bits(a, b), case.name
    flat = pd.pack_flat(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    torch.cuda.synchronize()
    assert pd.LAUNCHES["pack_flat"] == before["pack_flat"] + 1
    flat_ref = pd.pack_flat_ref(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    assert torch.equal(flat, flat_ref), case.name
    # the dense ≡ split oracle on the card: B1 on the same problem
    s_args, s_kw = _cuda(case.split)
    from karpenter_tpu_torch.solver import pack_split

    split = pack_split.pack_split(*s_args, max_free=case.split.max_free,
                                  mode=case.mode, **s_kw)
    assert split_mismatch(got, split, args[6]) is None, case.name


def test_entry_runs_the_dense_kernel_on_card(dense_kernels):
    from karpenter_tpu_torch.graft_entry import entry

    pd, _ = dense_kernels
    fn, args = entry()
    assert all(a.is_cuda for a in args)
    before = pd.LAUNCHES["pack"]
    got = fn(*args)
    torch.cuda.synchronize()
    assert pd.LAUNCHES["pack"] == before + 1
    cpu_fn, cpu_args = entry(device="cpu")
    for a, b in zip(got, cpu_fn(*cpu_args)):
        assert _same_bits(a.cpu(), b)


# ---------------------------------------------------------------- B8


@pytest.fixture(scope="module")
def shard_kernels(cuda_kernels):
    from karpenter_tpu_torch.solver import pack_shard

    return pack_shard


@pytest.fixture(scope="module")
def split_cases():
    from karpenter_tpu_torch.testing import kernel_cases

    return kernel_cases(1, n_pods=600, n_types=24)


def _cuda_split(case, S):
    from karpenter_tpu_torch.testing import split_case

    def put(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in x]
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    sa, skw, fa, fkw = split_case(case, S)
    return ([put(a) for a in sa], {k: put(v) for k, v in skw.items()},
            [put(a) for a in fa], {k: put(v) for k, v in fkw.items()})


def _replicas_equal(t):
    return all(torch.equal(t[0], t[s]) for s in range(1, t.shape[0]))


def _split_cases(split_cases, S):
    from karpenter_tpu_torch.testing import fold_cases, tie_case

    return [split_cases[i] for i in (0, 1, 2, 3, 4, 7)] + [
        tie_case(5, S, "cost"), tie_case(6, S, "ffd", quota=True)] + fold_cases(3, S)


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_split_b1_b2_match_plain_versions_and_b1(cuda_kernels, shard_kernels, split_cases, S):
    for case in _split_cases(split_cases, S):
        sa, skw, fa, fkw = _cuda_split(case, S)
        before = dict(shard_kernels.LAUNCHES)
        got = shard_kernels.pack_split_sharded(*sa, max_free=case.max_free, mode=case.mode, **skw)
        torch.cuda.synchronize()
        assert shard_kernels.LAUNCHES["pack_split_sharded"] == before["pack_split_sharded"] + 1
        want = shard_kernels.pack_split_sharded_ref(*sa, max_free=case.max_free, mode=case.mode, **skw)
        for i in (0, 2, 3):
            assert _replicas_equal(got[i]), (case.name, i)
            assert torch.equal(got[i], want[i]), (case.name, i)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), case.name
        flat = shard_kernels.pack_flat_words_sharded(*got)
        assert torch.equal(flat, shard_kernels.pack_flat_words_sharded_ref(*got)), case.name
        # the unsplit kernels on the same problem
        whole = cuda_kernels.pack_split(*fa, max_free=case.max_free, mode=case.mode, **fkw)
        assert torch.equal(flat, cuda_kernels.pack_flat_words(*whole)), case.name


@pytest.mark.parametrize("width", [1, 8, 16])
@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_split_b3_matches_plain_version_and_b3(cuda_kernels, shard_kernels, split_cases, S, width):
    for case in _split_cases(split_cases, S):
        sa, skw, fa, fkw = _cuda_split(case, S)
        got = shard_kernels.pack_split_wavefront_sharded(
            *sa, max_free=case.max_free, mode=case.mode, width=width, **skw)
        torch.cuda.synchronize()
        want = shard_kernels.pack_split_wavefront_sharded_ref(
            *sa, max_free=case.max_free, mode=case.mode, width=width, **skw)
        for i in (0, 2, 3, 4, 5):
            assert _replicas_equal(got[i]), (case.name, i)
            assert torch.equal(got[i], want[i]), (case.name, i)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), case.name
        flat = shard_kernels.pack_flat_words_sharded(got[0], got[1], got[2], got[3], got[5], got[4])
        whole = cuda_kernels.pack_split_wavefront(
            *fa, max_free=case.max_free, mode=case.mode, width=width, **fkw)
        assert torch.equal(flat, cuda_kernels.pack_flat_words(
            whole[0], whole[1], whole[2], whole[3], whole[5], whole[4])), case.name


@pytest.mark.parametrize("n_iters", [8, 192])
@pytest.mark.parametrize("S", [2, 4])
def test_split_ascent_matches_plain_version(lp_kernels, S, n_iters):
    from karpenter_tpu_torch.testing import ascent_cases

    _, lp_device = lp_kernels
    for name, inputs in ascent_cases(2, S):
        a = lp_device.ShardedAscentInputs.split(inputs, S, ["cuda"] * S)
        before = lp_device.LAUNCHES["lp_ascend_sharded"]
        got = lp_device.ascend_sharded(a, n_iters)
        torch.cuda.synchronize()
        assert lp_device.LAUNCHES["lp_ascend_sharded"] == before + 1
        want = lp_device.ascend_sharded_ref(a, n_iters)
        for x, y in zip(got, want):
            assert _replicas_equal(x), name
            assert _same_bits(x, y), name


def test_sharded_solves_on_card_match_unsharded(shard_kernels, lp_kernels):
    from karpenter_tpu_torch.solver import pack
    from karpenter_tpu_torch.solver.solver import fingerprint, reset_caches, solve
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh
    from karpenter_tpu_torch.workloads import build_problem

    pods, pools = build_problem(1500, 40, seed=4)
    force_virtual_mesh(8)
    try:
        want = fingerprint(solve(pods, pools))
        for S in (2, 3, 8):
            before = dict(shard_kernels.LAUNCHES)
            assert fingerprint(solve(pods, pools, shards=S)) == want, S
            assert shard_kernels.LAUNCHES["pack_split_wavefront_sharded"] > before[
                "pack_split_wavefront_sharded"]
        rpods, rpools = build_problem(1200, 60, seed=3, reservations=True)
        reset_caches()
        cost = fingerprint(solve(rpods, rpools, objective="cost"))
        reset_caches()
        assert fingerprint(solve(rpods, rpools, objective="cost", shards=4)) == cost
        assert pack.last_resolved_shards()["effective"] == 4
    finally:
        force_virtual_mesh(0)


# ---------------------------------------------------------------- spilled tables


@pytest.mark.parametrize("budget", [0, None])
@pytest.mark.parametrize("index", [0, 3, 4, 7])
def test_spilled_kernels_match_plain_versions(cuda_kernels, cases, index, budget):
    # B1, B3 (W = 8) and B7 with their tables spilled past a forced
    # budget (0: every table; None: the compat bits alone), counted as
    # spilled launches and byte-identical to the plain versions
    from karpenter_tpu_torch.solver import pack_dense
    from karpenter_tpu_torch.testing import dense_case

    case = cases[index]
    args, kw = _cuda(case)
    G, C = args[0].shape
    rc = kw.get("rsv_cap")
    size = cuda_kernels.segment_bytes(C, args[1].shape[1], args[5].shape[0],
                                      0 if rc is None else rc.shape[0], G)
    before = dict(cuda_kernels.LAUNCHES)
    with cuda_kernels.forced_budget(sum(size.values()) - 1 if budget is None else budget):
        got = cuda_kernels.pack_split(*args, max_free=case.max_free, mode=case.mode, **kw)
        wf = cuda_kernels.pack_split_wavefront(*args, max_free=case.max_free, mode=case.mode,
                                               width=8, **kw)
        dc = dense_case(case.staged, case.name, case.mode)
        dargs, dkw = _cuda(dc)
        dense = pack_dense.pack(*dargs, max_nodes=dc.max_nodes, mode=case.mode, **dkw)
    torch.cuda.synchronize()
    want = cuda_kernels.pack_split_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b), case.name
    for a, b in zip(wf, cuda_kernels.pack_split_wavefront_ref(
            *args, max_free=case.max_free, mode=case.mode, width=8, **kw)):
        assert torch.equal(a, b), case.name
    for a, b in zip(dense, pack_dense.pack_ref(*dargs, max_nodes=dc.max_nodes, mode=case.mode,
                                               **dkw)):
        assert torch.equal(a, b), case.name
    assert cuda_kernels.LAUNCHES["pack_split_global"] == before["pack_split_global"] + 1
    assert (cuda_kernels.LAUNCHES["pack_split_wavefront_global"]
            == before["pack_split_wavefront_global"] + 1)


@pytest.mark.parametrize("S", [2, 4])
def test_split_kernels_take_80_node_pools(cuda_kernels, shard_kernels, S):
    # P1 = 81: the split open loop's pool segment past the 64 entries of
    # the all-shared kernel's static arrays, placed with every segment in
    # shared memory and with every table spilled
    from karpenter_tpu_torch.testing import pools_cases, split_case

    for case in pools_cases(5, 80, n_pods=600, n_types=30):
        sa, skw, _, _ = split_case(case, S)

        def put(x):
            if x is None:
                return None
            if isinstance(x, list):
                return [torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in x]
            return torch.from_numpy(np.ascontiguousarray(x)).cuda()

        sa = [put(a) for a in sa]
        skw = {k: put(v) for k, v in skw.items()}
        want = shard_kernels.pack_split_sharded_ref(*sa, max_free=case.max_free,
                                                    mode=case.mode, **skw)
        for budget in (None, 0):
            if budget is None:
                got = shard_kernels.pack_split_sharded(*sa, max_free=case.max_free,
                                                       mode=case.mode, **skw)
            else:
                with cuda_kernels.forced_budget(budget):
                    got = shard_kernels.pack_split_sharded(*sa, max_free=case.max_free,
                                                           mode=case.mode, **skw)
            torch.cuda.synchronize()
            for i in (0, 2, 3):
                assert torch.equal(got[i], want[i]), (case.name, S, budget, i)
            assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
            flat = shard_kernels.pack_flat_words_sharded(*got)
            assert torch.equal(flat, shard_kernels.pack_flat_words_sharded_ref(*got))
