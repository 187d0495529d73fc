"""B5 past 2048 padded axes (ROADMAP C4): the plain version `ascend_ref`
held against the JAX package's `_ascend` on the CPU at padded widths of
2272, 2840 and 4438, and the wide layout's bytes and refusals.

(a) C2's method at wide axes: `ascend_ref` against the JAX program fed
    the port's step sizes (`test_torch_lp._jax_ascend_with_steps`):
    lambda, the last improving iteration, the float64 certificate and the
    best value bit for bit, on config axes of 2272, 2840 and 4438 (the
    warm pool's 4096-config buckets at both of their group axes,
    aws_catalog_50k's 2,400 configs padded) and group axes of 2272 and
    4438; against the JAX `_ascend` itself (its steps from the CPU's
    rsqrt estimate) within C2's 1e-6 bounds.
(b) The bound's dot past 2048 terms: XLA emits `lam_s @ count_w` as a
    scalar multiply-add chain in order from 4096 terms on
    (`lp_device.DOT_SCALAR_FROM`; its vector loop below), at lam0 and
    inside the loop alike; `xla_dot` equals the JAX program's bound at
    lam0 at 4095 and 4096 terms.
(c) `ascent_refusal` refuses only what the kernel cannot take (more than
    16 resources, more than 32,767 slots, axes past the wide layout's
    limits); `ascent_layout` doubles the tie records past 2048 and keeps
    the 2048 layout's bytes below.

Tolerances as `tests/test_torch_lp.py`: exact against the stepped
program; 1e-6 against the JAX `_ascend`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu_torch import testing as _testing
from karpenter_tpu_torch.solver import lp_device
from karpenter_tpu_torch.testing import ascent_edge_case, ascent_wide_cases

from test_torch_lp import _stepped_ascend, _ulps


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with _testing.one_core():
        yield


# (case, iterations): the warm bucket's 155 x 4438 at the ascent's 192
# iterations, the others at fewer (the plain versions on one core are
# the file's time)
C2_CASES = [("wide-c2272", 32), ("wide-c2840", 64), ("wide-c4438", 192),
            ("wide-c4438-g243", 48), ("wide-g2272", 48), ("wide-g4438", 16)]


@pytest.mark.parametrize("name,n_iters", C2_CASES)
def test_wide_ascent_plain_version_against_jax(name, n_iters, request):
    (case, a), = ascent_wide_cases(0, names=(name,))
    Gp, Cp = a.compat.shape
    assert lp_device.ascent_wide(Gp, Cp) and max(Gp, Cp) in (2272, 2840, 4438)
    args = [jnp.asarray(t.numpy()) for t in a.tensors()]
    best, lam, last = lp_device.ascend_ref(a, n_iters)
    sbest, slam, slast = _stepped_ascend(args, n_iters)
    slam = np.asarray(slam)
    np.testing.assert_array_equal(lam.numpy().view(np.int32), slam.view(np.int32))
    assert int(last) == int(slast)
    assert _ulps(float(best), float(sbest)) == 0

    jbest, jlam, _ = jlp_device._ascend(*args, n_iters=n_iters)
    assert float(best) == pytest.approx(float(jbest), rel=1e-6)
    jlam = np.asarray(jlam)
    scale = max(float(np.abs(jlam).max()), 1e-12)
    np.testing.assert_allclose(lam.numpy(), jlam, rtol=0, atol=1e-6 * scale)
    request.node.user_properties += [
        ("best_rel_gap", abs(float(best) - float(jbest)) / abs(float(jbest))),
        ("lam_bit_equal", f"{int((lam.numpy() == jlam).sum())}/{jlam.size}"),
    ]


@pytest.mark.parametrize("n", [2048, 2272, 4095, 4096, 4438, 8669])
def test_dot_plan_past_2048(n):
    for initial in (True, False):
        plan = lp_device.dot_plan(n, initial)
        assert plan["scalar"] == (n >= lp_device.DOT_SCALAR_FROM)


@pytest.mark.parametrize("G", [4095, 4096])
def test_bound_at_lam0_is_xlas_dot(G):
    """The JAX program's bound at lam0 (no iterations; no reservation
    slots, so the bound is the dot alone) equals the port's at the last
    vectorized width and the first scalar one."""
    for seed in range(3):
        a = ascent_edge_case(seed, G, 40, 4, 1, 0, 0, 0)
        best, _, _ = lp_device.ascend_ref(a, 0)
        jbest, _, _ = jlp_device._ascend(*[jnp.asarray(t.numpy()) for t in a.tensors()],
                                         n_iters=0)
        assert _ulps(float(best), float(jbest)) == 0


def test_refusal_names_only_what_the_kernel_cannot_take():
    assert lp_device.ascent_refusal(155, 4438) is None
    assert lp_device.ascent_refusal(243, 4438) is None
    assert lp_device.ascent_refusal(243, 2840) is None
    assert lp_device.ascent_refusal(594, 2840) is None      # aws_catalog_50k's LP
    assert lp_device.ascent_refusal(4438, 4438, 4, 64) is None
    assert "16" in lp_device.ascent_refusal(155, 256, 17, 64)
    assert "32767" in lp_device.ascent_refusal(155, 256, 4, 32768)
    assert lp_device.ascent_refusal(lp_device.ASCENT_MAX_AXIS + 1, 64) is not None
    assert lp_device.ascent_refusal(64, 70_000, 16, 64) is None
    assert lp_device.ascent_refusal(70_000, 70_000, 16, 64) is not None  # 32-bit indices


def test_wide_layout_bytes():
    narrow = lp_device.ascent_layout(2048, 2048, 4, 64)
    wide = lp_device.ascent_layout(155, 4438, 4, 64)
    names = [n for n, _ in lp_device.ASCENT_ARRAYS]
    assert not lp_device.ascent_wide(2048, 2048) and lp_device.ascent_wide(155, 4438)
    assert lp_device.ascent_wide(2049, 64)
    sizes = {n: lp_device._ascent_array_bytes(d, 155, 4438, 4, 64)
             for n, d in lp_device.ASCENT_ARRAYS}
    assert sizes["tinfo"] == 2 * sizes["mm"] == 8 * 4438 * 4
    assert lp_device._ascent_array_bytes(dict(lp_device.ASCENT_ARRAYS)["tinfo"],
                                         2048, 2048, 4, 64) == 4 * 2048 * 4
    total = sum(-(-s // 16) * 16 for s in sizes.values())
    assert wide["smem"] + wide["scratch"] == total and wide["global"]
    assert len(wide["offsets"]) == len(names) == len(narrow["offsets"])
