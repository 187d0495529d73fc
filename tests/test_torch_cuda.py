"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere (the CUDA kernels have
no CPU mode). On a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest pins JAX to the CPU, and this
file imports no JAX.) Tolerance: byte-identical outputs — the kernels
use the plain versions' f32 operation order and index tie-breaks.
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
