"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere (the CUDA kernels have
no CPU mode). On a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest pins JAX to the CPU, and this
file imports no JAX.) Covers B1-B5 and B6 (both lane programs, the
wavefront one at cluster widths 8 and 16, and the lane epilogue), and
the consolidation ladder on the card against the CPU. Tolerance:
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


@pytest.mark.parametrize("index", range(6))
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
        assert k.ACTIVE_CLUSTERS[width] >= 1
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
