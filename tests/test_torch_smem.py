"""The packing kernels' shared-memory budget, computed on the host.

B1, B3, B6 and B7 keep their config and group tables in dynamic shared
memory; the wrappers compute the bytes a block takes from the shapes
(`table_smem_bytes`, `wavefront_smem_bytes`, the mirror of
`table_layout` and `wave_layout` in the CUDA sources), set them on the
launch, and raise, naming the bytes, when a shape needs more than the
card allows. No card is needed here. Also the margin of the kernels'
exact capacity pre-test, and the config-axis resizing the card tests
hold the kernels on (`testing.config_axis`), through the plain
versions. Imports no JAX.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import pack_split as k
from karpenter_tpu_torch.solver.pack import config_width


def _align(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("C, words", [(1, 4), (31, 4), (32, 4), (33, 4), (128, 4),
                                      (129, 8), (224, 8), (768, 24), (769, 28)])
def test_words_pad(C, words):
    # 32 columns a word, padded to a multiple of 4 words (16-byte loads)
    assert k.words_of(C) == -(-C // 32)
    assert k.words_pad(C) == words


@pytest.mark.parametrize("C, R, P1, K, G", [(224, 4, 2, 0, 194), (256, 4, 3, 40, 194),
                                            (768, 4, 10, 0, 20), (28, 4, 2, 0, 243),
                                            (1472, 16, 7, 64, 79), (1, 1, 1, 0, 1)])
def test_table_bytes_segment_by_segment(C, R, P1, K, G):
    nw = k.words_pad(C)
    want = (_align(4 * C * R) + _align(4 * P1 * R) + 3 * _align(4 * C) + _align(4 * K)
            + 2 * _align(4 * (K + 1)) + _align(4 * C) + _align(C) + 4 * nw
            + _align(4 * G) + _align(4 * G * R) + 4 * G * nw)
    assert k.table_smem_bytes(C, R, P1, K, G) == want
    assert want % 16 == 0


def test_table_bytes_at_the_main_paths_shapes():
    # the first 50k x 500 request (Gp=194, Cp=224, R=4, two pools): the
    # config tables under 8 KB, the groups' tables 10 KB
    config = 7520 - 2 * 4 * 8 + 4 * 8
    groups = _align(4 * 194) + _align(4 * 194 * 4) + 4 * 194 * 8
    assert k.table_smem_bytes(224, 4, 2, 0, 194) == config + groups
    # the consolidation chunk's union (Gp=20, Cp=768): the config tables
    # under 25 KB, with the groups' under 28 KB
    assert k.table_smem_bytes(768, 4, 2, 0, 0) <= 25 * 1024
    assert k.table_smem_bytes(768, 4, 2, 0, 20) <= 28 * 1024
    # B3 adds its lanes' scalars and conflict words, the committed
    # groups' bits, offsets, verdicts and its filled rows' bits
    W, G, N = 16, 194, 1453
    extra = (_align(4 * W * k.WAVEFRONT_LANE_FIELDS) + _align(4 * W) + _align(4 * 7)
             + _align(4 * (W + 1)) + _align(4) + 2 * _align(4 * W) + _align(4 * 46))
    assert k.wavefront_smem_bytes(224, 4, 2, 0, W, G, N) == config + groups + extra


def test_wavefront_bytes_grow_with_width_groups_and_rows():
    base = k.wavefront_smem_bytes(224, 4, 2, 0, 1, 1, 32)
    assert k.wavefront_smem_bytes(224, 4, 2, 0, 256, 1, 32) > base
    assert k.wavefront_smem_bytes(224, 4, 2, 0, 1, 4096, 32) > base
    assert k.wavefront_smem_bytes(224, 4, 2, 0, 1, 1, 33_423) > base
    # million_pod's B3 (Cp=160, G=243, ~52k rows unsharded; Cs=20 at S=8)
    # and the widest lane count fit
    assert k.wavefront_smem_bytes(160, 4, 2, 0, 16, 243, 51_680) <= k.SMEM_BUDGET
    assert k.wavefront_smem_bytes(20, 4, 2, 0, 16, 243, 51_680) <= k.SMEM_BUDGET
    assert k.wavefront_smem_bytes(224, 4, 2, 0, 256, 1000, 5580) <= k.SMEM_BUDGET


def test_check_smem_passes_a_budget_that_fits():
    n = k.table_smem_bytes(768, 4, 10, 40, 194)
    assert k.check_smem("pack_split", n, "C=768") == n
    assert k.check_smem("pack_split", k.SMEM_BUDGET, "at the limit") == k.SMEM_BUDGET
    assert k.SMEM_BUDGET == 232_448 - k.STATIC_SMEM


def test_check_smem_raises_with_the_numbers():
    C = 8192
    n = k.table_smem_bytes(C, 4, 2, 0, 194)
    assert n > k.SMEM_BUDGET
    with pytest.raises(ValueError, match=rf"C={C}.*{n} bytes.*{k.SMEM_LIMIT} a block"):
        k.check_smem("pack_split", n, f"C={C} R=4 P1=2 K=0")


def test_over_budget_shape_raises_before_any_launch():
    # a CUDA-tensor launch checks the budget before it builds or loads
    # a library: the wrapper's helper raises with the bytes
    C, R = 12_000, 4
    with pytest.raises(ValueError, match="bytes of dynamic shared memory a block"):
        k.check_smem("pack_split_wavefront",
                     k.wavefront_smem_bytes(C, R, 2, 0, 16, 194, 1453), f"C={C} R={R}")


def test_config_width_keeps_the_flat_words_whole():
    # the staged config axis is a multiple of 32, so a row's words hold
    # no columns past C but the padding words'
    for C in (1, 31, 32, 33, 224, 768):
        Cp = config_width(C)
        assert Cp % 32 == 0 and Cp >= C
        assert k.words_pad(Cp) * 32 >= Cp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the plain versions' small tensor ops gain nothing from threads, and
    # the suite's workers share the cores with its wall-clock tests
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_case():
    from karpenter_tpu_torch.testing import kernel_cases

    return kernel_cases(3, n_pods=300, n_types=10)[4]  # bound rows, quotas, caps, conflicts


def _tensors(case):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    return [put(a) for a in case.args], {n: put(v) for n, v in case.kwargs.items()}


@pytest.mark.parametrize("extra", [-5, 0, 1, 100])
def test_config_axis_resizing_keeps_b3_equal_to_b1(small_case, extra):
    from karpenter_tpu_torch.testing import config_axis

    C = small_case.args[0].shape[1] + extra
    case = config_axis(small_case, C)
    args, kw = _tensors(case)
    assert args[0].shape[1] == C and args[3].shape[0] == C and args[11].shape == (C,)
    seq = k.pack_split_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    wf = k.pack_split_wavefront_ref(*args, max_free=case.max_free, mode=case.mode,
                                    width=32, **kw)
    for a, b in zip(seq, wf[:4]):
        assert torch.equal(a, b)
    if extra > 0:
        # padding columns are pseudo-configs: nothing lands on them
        assert not seq[1][:, C - extra:].any()
        base = k.pack_split_ref(*_tensors(small_case)[0], max_free=case.max_free,
                                mode=case.mode, **_tensors(small_case)[1])
        assert torch.equal(seq[0], base[0]) and int(seq[2]) == int(base[2])


def _lowest_approx(x: np.float32) -> np.float32:
    # the smallest quotient an approximate division within 2 ulp of the
    # rounded one can return
    lo = np.nextafter(x, np.float32(-np.inf), dtype=np.float32)
    return np.nextafter(lo, np.float32(-np.inf), dtype=np.float32)


def test_capacity_pretest_margin_is_sound():
    # csrc/pack_common.cuh `capacity_below`: a config is skipped when an
    # approximate quotient is below (M + 1)(1 - 2^-20); the exact floor of
    # the rounded quotient must then be at most M, for quotients just
    # under, at and just over every integer the kernels compare against
    rng = np.random.default_rng(7)
    one_less = np.float32(1.0 - 2.0 ** -20)
    assert float(one_less) == 1.0 - 2.0 ** -20
    checked = 0
    for M in list(range(0, 70)) + [1000, 65_535, 2 ** 20, 2 ** 22 - 1]:
        thr = np.float32(np.float32(M + 1) * one_less)
        q = rng.uniform(0.01, 64.0, size=400).astype(np.float32)
        for m in (M, M + 1, M + 2):
            # quotients within a few ulps of m, and a spread around it
            target = np.float32(m) * (1 + rng.uniform(-4e-7, 4e-7, size=q.size))
            target = np.concatenate([target, rng.uniform(m - 2, m + 2, size=q.size)])
            qq = np.concatenate([q, q])
            h = (target * qq).astype(np.float32)
            exact = np.floor(h / qq).astype(np.float64)          # floor(RN(h / q)) in f32
            approx = np.array([_lowest_approx(x) for x in (h / qq).astype(np.float32)])
            skipped = approx < thr
            assert (exact[skipped] <= M).all(), (M, m)
            checked += int(skipped.sum())
    assert checked > 10_000
