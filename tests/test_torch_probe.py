"""The port's consolidation probe kernel B6 against the JAX package's,
on CPU.

`pack_probe_lanes_flat_ref` (the plain PyTorch version of B6,
`karpenter_tpu_torch/solver/pack_split.py`) and the JAX
`pack_probe_lanes_flat` take the same numpy inputs, built by
`testing.lane_cases`: new pods against the half-emptied nodes of an
earlier solve (the bound block), with lanes that each keep a random
share of every group's pods and a random subset of the bound rows, a
lane with no demand, a lane with every bound row dead, and padded
lanes up to `_lane_bucket`; once without and once with reservations
(`cfg_rsv`/`rsv_cap`) and pairwise conflicts.

(a) the flat [Lp, row] buffers are byte-identical, in both modes, on
    the sequential route and the wavefront route at widths 8 and 16
    (the case without reservations and conflicts on two of these);
(b) each lane's row equals `pack_split_flat_ref` (or
    `pack_split_wavefront_ref` + `pack_flat_words_ref`) on that lane's
    demand and live rows alone, and padded lanes hold the rows of an
    empty problem;
(c) `probe_batch_width` and `_lane_bucket` resolve their knobs as the
    JAX package's do (auto asks the device: 1 on the CPU, 64 on cuda);
(d) the B6 wrappers take the plain versions for CPU tensors and count
    no launch.

Tolerance: exact equality (bytes); the plain versions use f32 in the
JAX order and index-tie-broken arg-reductions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_tpu.solver import pack as jpack
from karpenter_tpu_torch.solver import pack
from karpenter_tpu_torch.solver import pack_split as kernels
from karpenter_tpu_torch.testing import lane_cases, one_core

MODES = ("ffd", "cost")
WAVEFRONTS = (0, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """These comparisons compile many JAX programs and run the plain
    versions on small tensors: on one core, they leave the suite's
    other workers, some of which time milliseconds, their cores."""
    with one_core():
        yield


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in lane_cases(0, n_pods=400, n_types=40, n_lanes=6)}


def _torch(case):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    return [put(a) for a in case.args], {k: put(v) for k, v in case.kwargs.items()}


def _port_flat(case, mode, wavefront):
    args, kw = _torch(case)
    return kernels.pack_probe_lanes_flat_ref(
        *args, max_free=case.max_free, mode=mode, wavefront=wavefront, **kw
    ).numpy().view(np.uint32)


def test_cases_cover_what_the_kernel_branches_on(cases):
    fleet, rc = cases["fleet"], cases["reservations-conflict"]
    for case in (fleet, rc):
        counts, live = case.args[2], case.args[10]
        assert case.args[7].shape[0] > 0, "no bound block"
        assert counts.shape[0] == pack._lane_bucket(case.n_lanes) > case.n_lanes
        assert counts[0].sum() == 0 and live[0].any()       # no demand
        assert counts[1].sum() > 0 and not live[1].any()    # every bound row dead
        assert not counts[case.n_lanes:].any() and not live[case.n_lanes:].any()
    assert all(v is None for v in fleet.kwargs.values())
    assert rc.kwargs["rsv_cap"] is not None and rc.kwargs["rsv_cap"].size
    assert rc.kwargs["conflict"] is not None and rc.kwargs["conflict"].any()


# every mode and route on the case with reservations and conflicts; the
# case without them (its optional inputs None) on two of them, to keep
# the JAX compiles few
JAX_CASES = [("reservations-conflict", m, w) for m in MODES for w in WAVEFRONTS] + [
    ("fleet", "ffd", 0), ("fleet", "cost", 16)]


@pytest.mark.parametrize("name, mode, wavefront", JAX_CASES)
def test_flat_lanes_identical_to_jax(cases, name, mode, wavefront):
    case = cases[name]
    j_kw = {k: None if v is None else jnp.asarray(v) for k, v in case.kwargs.items()}
    want = np.asarray(jpack.pack_probe_lanes_flat(
        *[jnp.asarray(a) for a in case.args], max_free=case.max_free,
        mode=mode, wavefront=wavefront, **j_kw))
    got = _port_flat(case, mode, wavefront)
    assert want.dtype == np.uint32 and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("wavefront", [0, 16])
@pytest.mark.parametrize("name", ["fleet", "reservations-conflict"])
def test_each_lane_equals_its_solve_alone(cases, name, wavefront):
    case = cases[name]
    mode = "cost" if wavefront else "ffd"
    flat = _port_flat(case, mode, wavefront)
    args, kw = _torch(case)
    B = args[7].shape[0]
    for lane in range(flat.shape[0]):
        alone = list(args)
        alone[2], alone[10] = args[2][lane], args[10][lane]
        if wavefront:
            outs = kernels.pack_split_wavefront_ref(
                *alone, max_free=case.max_free, mode=mode, width=wavefront, **kw)
            row = kernels.pack_flat_words_ref(*outs[:4], outs[5], outs[4])
        else:
            row = kernels.pack_split_flat_ref(
                *alone, max_free=case.max_free, mode=mode, **kw)
        assert row.numpy().view(np.uint32).tobytes() == flat[lane].tobytes(), lane
    # padded lanes: nothing placed or opened, the node count at the
    # bound block, no rounds
    Gp = args[0].shape[0]
    N = B + case.max_free
    o1 = N * Gp + case.max_free * (args[0].shape[1] // 32)
    for lane in range(case.n_lanes, flat.shape[0]):
        assert not flat[lane, :o1].any()
        assert flat[lane, o1] == B
        assert not flat[lane, o1 + 1:].any()


def test_probe_knobs_resolve_like_jax(monkeypatch):
    for raw in ("", "8", "1", "0", "junk"):
        monkeypatch.setenv("KARPENTER_PROBE_BATCH_WIDTH", raw)
        assert pack.probe_batch_width("cpu") == jpack.probe_batch_width(), raw
    monkeypatch.delenv("KARPENTER_PROBE_BATCH_WIDTH")
    assert pack.probe_batch_width("cpu") == 1
    assert pack.probe_batch_width("cuda") == 64
    monkeypatch.setenv("KARPENTER_PROBE_BATCH_WIDTH", "8")
    assert pack.probe_batch_width("cuda") == 8
    for base in ("", "4", "16", "x"):
        monkeypatch.setenv("KARPENTER_PROBE_LANE_BUCKET", base)
        for n in (1, 7, 8, 9, 36, 64, 100):
            assert pack._lane_bucket(n) == jpack._lane_bucket(n), (base, n)


def test_wrappers_take_the_plain_versions_on_cpu(cases):
    case = cases["reservations-conflict"]
    args, kw = _torch(case)
    before = dict(kernels.LAUNCHES)
    seq = kernels.pack_probe_lanes(*args, max_free=case.max_free, mode="ffd", **kw)
    wf = kernels.pack_probe_lanes_wavefront(
        *args, max_free=case.max_free, mode="ffd", width=8, **kw)
    flat = kernels.pack_flat_lanes(*wf[:4], wf[5], wf[4])
    assert kernels.LAUNCHES == before
    for a, b in zip(seq, wf[:4]):
        assert torch.equal(a, b)
    assert flat.numpy().view(np.uint32).tobytes() == _port_flat(case, "ffd", 8).tobytes()
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.pack_probe_lanes_flat(*meta, max_free=case.max_free)
