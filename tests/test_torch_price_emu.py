"""B4's kernel (`karpenter_tpu_torch/csrc/lp_price.cu`) run on the CPU,
held bit for bit against its plain version `lp_plan.price_kernel_ref`.

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (a std::thread a CUDA thread, futex barriers for the
block's and the warps' barriers, per-warp buffers for shuffles, ballots
and the hardware warp reductions), the kernel's text unchanged but for
its dynamic shared memory, which the harness (`cuda_emu/price.inc`)
hands it. Its blocks run one after another.

Cases: seeded problems at G <= 32 (the value's one multiply-add chain)
and G > 32 (its windows, a lane a window), roomy configs that take some
of nearly every group (the value's terms mostly nonzero), tied
densities (duplicated groups, on one lane and across lanes), a zero density (a dual too small to divide), a config that
fills in one round, a negative request and an infinite dual (the full
argmax of every round, off the monotone path) and 1,040 groups (the
value's windows on two levels), in every layout (`lp_plan.PRICE_LAYOUTS`:
the groups' tables staged in shared memory, or read in place with and
without the walk order); and past the staged layout's ceiling (7,000
groups: the walk; 20,000: the full argmax), at `lp_plan.price_layout`'s
choice. No JAX; skips where g++ cannot build C++20.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import lp_plan

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


def _source() -> str:
    """lp_price.cu up to its launcher, its dynamic shared memory the
    harness's, then the harness."""
    src = (CSRC / "lp_price.cu").read_text()
    body = src[:src.index('extern "C" int lp_price_launch(')]
    decl = "extern __shared__ __align__(16) unsigned char smem[];"
    assert body.count(decl) == 1
    body = body.replace(decl, "unsigned char* smem = g_dsmem_price;")
    return ('#include "xchg_host.h"\n#define __shared__ static\n'
            "inline unsigned char* g_dsmem_price;\n" + body + (EMU / "price.inc").read_text())


@pytest.fixture(scope="module")
def price_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("price_emu")
    for f in ("cuda_emu.h", "xchg_host.h", "cuda_runtime.h", "cuda_pipeline.h"):
        shutil.copy(EMU / f, out / f)
    for f in ("shard_xchg.cuh", "pack_common.cuh"):
        shutil.copy(CSRC / f, out / f)
    (out / "price.cc").write_text(_source())
    exe = out / "price"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / "price.cc")], capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def _run(exe, tmp: Path, name, lam, compat, req, alloc, count, layout=None):
    G, C = compat.shape
    R = req.shape[1]
    if layout is None:
        layout = lp_plan.price_layout(G, R)
    path = tmp / f"{name}-{layout}.bin"
    path.write_bytes(
        struct.pack("4i", G, C, R, layout) + lam.astype(np.float32).tobytes()
        + np.ascontiguousarray(compat).astype(np.uint8).tobytes()
        + req.astype(np.float32).tobytes() + alloc.astype(np.float32).tobytes()
        + count.astype(np.int32).tobytes())
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = Path(str(path) + ".out").read_bytes()
    q = np.frombuffer(raw[:4 * C * G], np.int32).reshape(C, G)
    value = np.frombuffer(raw[4 * C * G:], np.float32)
    return q, value


def _edges(seed):
    """A seeded problem (G = 40, R = 3) with a zero density (a dual of
    one denormal over a fraction of 2), a config that fills in one round
    (config 1: only group 5 fits, and its allocatable is group 5's
    request), and the same problem with a negative request."""
    lam, compat, req, alloc, count = testing.price_case(seed, 40, 9, 3)
    lam[3] = np.float32(1.4e-45)
    req[3] = np.float32(2.0) * np.maximum(alloc.max(axis=0), 1.0)
    compat[3] = True
    compat[:, 1] = False
    compat[5, 1] = True
    lam[5], count[5] = 1.0, 3
    req[5] = np.array([1.0, 0.5, 0.25], np.float32)
    alloc[1] = req[5]
    neg = req.copy()
    neg[7, 0] = -1.0
    return [("edges", (lam, compat, req, alloc, count)),
            ("negative-request", (lam, compat, neg, alloc, count))]


def _many_fills(seed, G=100, C=6, R=4):
    """Roomy configs that take a little of nearly every group, so that
    the value sums many nonzero products (its windows' order shows), with
    groups g and g + 32 (one lane's) and g and g + 1 (two lanes') of equal
    density."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.1, 2.0, G).astype(np.float32)
    req = rng.choice([0.25, 0.5, 1.0, 2.0], size=(G, R)).astype(np.float32)
    for a, b in [(g, g + 32) for g in range(0, 12)] + [(g, g + 1) for g in range(50, 60, 2)]:
        lam[b], req[b] = lam[a], req[a]
    compat = rng.random((G, C)) < 0.9
    alloc = np.full((C, R), 160.0, np.float32)
    alloc[0] = 8.0  # a tight one, for the ties' order
    count = rng.integers(1, 6, G).astype(np.int32)
    return lam, compat, req, alloc, count


CASES = [
    ("G100-many-fills", lambda: _many_fills(3)),
    ("G20-R4", lambda: testing.price_case(0, 20, 9, 4)),
    ("G32-R5-ties", lambda: testing.price_case(1, 32, 6, 5, "ties")),
    ("G70-R4-ties", lambda: testing.price_case(2, 70, 9, 4, "ties")),
    ("G194-R4-ties", lambda: testing.price_case(4, 194, 7, 4, "ties")),
    ("G194-R4-infinite-dual", lambda: testing.price_case(7, 194, 7, 4, "infinite-dual")),
    ("G1040-R2", lambda: testing.price_case(5, 1040, 4, 2)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


def _hold(exe, tmp, name, case, layout=None):
    got_q, got_v = _run(exe, tmp, name, *case, layout=layout)
    want_q, want_v = lp_plan.price_kernel_ref(*[torch.from_numpy(np.ascontiguousarray(x))
                                                for x in case])
    assert (got_q == want_q.numpy()).all(), (name, layout)
    assert (got_v.view(np.int32) == want_v.numpy().view(np.int32)).all(), (name, layout)
    return want_q.numpy()


@pytest.mark.parametrize("name, make", CASES, ids=[c[0] for c in CASES])
def test_emulated_price_kernel_equals_plain_version(price_exe, tmp_path, name, make):
    q = _hold(price_exe, tmp_path, name, make())
    assert q.sum() > 0  # something is priced


@pytest.mark.parametrize("layout", [1, 2], ids=lambda i: lp_plan.PRICE_LAYOUTS[i])
def test_emulated_price_kernel_in_the_global_layouts(price_exe, tmp_path, layout):
    # the <false> instantiation at small shapes: the groups' tables read in
    # place, with the walk order and without it
    for name, make in CASES[:5]:
        _hold(price_exe, tmp_path, name, make(), layout)
    for name, case in _edges(11):
        _hold(price_exe, tmp_path, name, case, layout)


@pytest.mark.parametrize("G, layout", [(7_000, 1), (20_000, 2)])
def test_emulated_price_kernel_past_the_staged_ceiling(price_exe, tmp_path, G, layout):
    # past the staged layout's budget (R = 4: 6,428 groups) the wrapper
    # reads the groups' tables in place, keeping the walk order up to
    # 19,280 groups; the kernel takes as many groups as before its
    # redesign and more (8 bytes a group: 28,928, against 28,607)
    R = 4
    assert lp_plan.price_layout(6_428, R) == 0 and lp_plan.price_layout(6_429, R) == 1
    assert lp_plan.price_layout(19_280, R) == 1 and lp_plan.price_layout(19_281, R) == 2
    assert lp_plan.price_layout(G, R) == layout
    assert lp_plan.price_layout(28_928, R) == 2
    with pytest.raises(ValueError, match="G=28929 groups"):
        lp_plan.price_layout(28_929, R)
    q = _hold(price_exe, tmp_path, f"G{G}", testing.price_case(8, G, 3, R))
    assert q.sum() > 0


def test_emulated_price_kernel_edges(price_exe, tmp_path):
    for name, case in _edges(11):
        q = _hold(price_exe, tmp_path, name, case)
        lam, compat, req, alloc, count = case
        # config 1 fills in one round: group 5 alone, one pod
        assert q[1].tolist() == [1 if g == 5 else 0 for g in range(q.shape[1])], name
        # the zero-density group never wins
        assert not q[:, 3].any(), name
