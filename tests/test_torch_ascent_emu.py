"""B5's CUDA source (`karpenter_tpu_torch/csrc/lp_ascend.cu`) run on the
CPU, held bit for bit against its plain version.

The kernel's device code, at a block of 64 threads, is compiled as C++20
with g++ against a small emulation of the CUDA calls it makes (`tests/cuda_emu/`: a std::thread a
CUDA thread, a futex barrier for block and warp barriers, per-warp buffers
for shuffles and ballots, std::atomic_ref for the atomics, IEEE single
precision for the float intrinsics) and the split kernels' exchange
(`csrc/shard_xchg.cuh` unchanged, its named device functions defined
on the host by `tests/cuda_emu/xchg_host.h`). The emulated
kernel runs one block (or S blocks for split B5) on seeded inputs and
must give the plain version's best value, best duals and last improving
iteration bit for bit: `ascend_ref` (or `ascend_sharded_ref`, every
replica). Past 2048 padded groups or configs the kernel runs its wide
layout (32-bit tie records, window sums a window at a time, a third
level of windows): the warm buckets' and aws_catalog_50k's config axes,
group axes of 2272 and 4438, a config axis past 32 x 1024, and split B5
with a shard's block past 2048. What the card adds (timing, the real
memory model, the compiler's code) is `tests/test_torch_cuda.py`'s and
`chip_smoke.py`'s.
No JAX; skips where g++ cannot build C++20.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import lp_device
from karpenter_tpu_torch.testing import (
    ascent_cases,
    ascent_edge_case,
    ascent_edge_cases,
    ascent_wide_cases,
)

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


def _exchange_source() -> str:
    """csrc/shard_xchg.cuh as it is, after the prelude that defines its
    named device functions on the host (tests/cuda_emu/xchg_host.h)."""
    return ((EMU / "xchg_host.h").read_text() + "\n"
            + (CSRC / "shard_xchg.cuh").read_text())


def _kernel_source() -> str:
    """The device code of csrc/lp_ascend.cu (up to its kernels' entry
    points), each block's dynamic and static shared memory indexed by the
    block, and the harness that runs it."""
    src = (CSRC / "lp_ascend.cu").read_text()
    body = src[:src.index("__global__ void __launch_bounds__(kAscThreads, 1)\n    lp_ascend_kernel")]
    for old, new in (
        # two warps a block: the kernel's code is the same at any multiple
        # of 64 threads (its strided loops take more turns), and a block
        # of 512 std::threads would spend the suite's time in barriers
        ("constexpr int kAscThreads = 512;", "constexpr int kAscThreads = 64;"),
        ("extern __shared__ __align__(16) unsigned char dsmem[];",
         "unsigned char* dsmem = g_dsmem[blockIdx.x];"),
        ("  __shared__ Scalars s;", "  static Scalars s_[64];\n  Scalars& s = s_[blockIdx.x];"),
        ('#include "pack_common.cuh"', '#include "pack_common.cuh"\ninline unsigned char* g_dsmem[64];'),
    ):
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    # the harness runs the layout the launch functions pick: the wide one
    # past 2048 padded groups or configs (`is_wide`)
    harness = (EMU / "harness.inc").read_text()
    call = "ascend_body(args[sh], L, scratch[sh], x);"
    assert harness.count(call) == 2, call
    harness = harness.replace(call, "(is_wide(G, C) ? ascend_body<true>(args[sh], L, scratch[sh], x)"
                                    " : ascend_body<false>(args[sh], L, scratch[sh], x));")
    return body + "\n}  // namespace\n" + harness


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated kernel's executable, built once a module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("ascent_emu")
    for f in ("cuda_emu.h", "pack_common.cuh", "cooperative_groups.h"):
        shutil.copy(EMU / f, out / f)
    (out / "shard_xchg_emu.h").write_text(_exchange_source())
    (out / "lp_ascend_emu.cc").write_text(_kernel_source())
    exe = out / "lp_ascend_emu"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread",
         "-w", f"-I{out}", "-o", str(exe), str(out / "lp_ascend_emu.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def run_emulated(exe: Path, a, n_iters: int, shards: int = 1, cluster: int = 0):
    """(best [S], best_lam [S, Gp], last_up [S]) of the emulated kernel
    on `a` (AscentInputs, or ShardedAscentInputs with `shards` > 1); with
    `cluster` the wide layout's cluster of that many blocks on `a`
    (AscentInputs: best [1], best_lam [1, Gp], last_up [1])."""
    one = (lambda n: getattr(a, n)[0]) if shards > 1 else (lambda n: getattr(a, n))
    Gp, Cp = one("compat").shape
    R, Kp = a.req.shape[1], one("onehot").shape[0]
    lay = lp_device.ascent_layout(Gp, Cp, R, Kp, cluster)

    def put(buf, t):
        t = t.numpy()
        buf.append(np.ascontiguousarray(
            t.astype(np.uint8) if t.dtype == bool else t.astype(np.float32)).tobytes())

    buf = [struct.pack("7i", Gp, Cp, R, Kp, n_iters, cluster or shards, 1 if cluster else 0),
           struct.pack(f"{len(lay['offsets'])}q", *lay["offsets"]),
           struct.pack("2q", lay["smem"], lay["scratch"])]
    for n in ("lam0", "count", "count_w", "req", "budget"):
        put(buf, getattr(a, n))
    for sh in range(shards):
        for n in ("compat", "alloc", "price", "valid", "onehot", "uncapped"):
            put(buf, getattr(a, n)[sh] if shards > 1 else getattr(a, n))
    path = exe.parent / f"in-{Gp}-{Cp}-{n_iters}-{shards}-{cluster}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer((Path(str(path) + ".out")).read_bytes(), np.uint8)
    S = 1 if cluster else shards
    best = raw[:4 * S].view(np.float32)
    lam = raw[4 * S:4 * S + 4 * S * Gp].view(np.float32).reshape(S, Gp)
    last = raw[4 * S + 4 * S * Gp:].view(np.int32)
    return best, lam, last


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (case, iterations): the staged cases, and the edge cases (the shape over
# the shared-memory budget on its global-memory path; column maxima at
# 0 with tied groups; 801 configs; the small case past the iteration at
# which its norm overflows float32)
CASES = [("staged", i, 12) for i in range(3)] + [
    ("edge", 0, 4), ("edge", 1, 16), ("edge", 2, 8), ("edge", 3, 64)]


@pytest.mark.parametrize("kind,index,n_iters", CASES)
def test_emulated_ascent_equals_plain_version(emulated, kind, index, n_iters):
    name, a = (ascent_cases(0) if kind == "staged" else ascent_edge_cases(0))[index]
    best, lam, last = run_emulated(emulated, a, n_iters)
    want = lp_device.ascend_ref(a, n_iters)
    assert (_bits(best[0]) == _bits(want[0].numpy())).all(), name
    assert (_bits(lam[0]) == _bits(want[1].numpy())).all(), name
    assert int(last[0]) == int(want[2]), name


@pytest.mark.parametrize("S", [2, 4])
def test_emulated_split_ascent_equals_plain_version(emulated, S):
    name, inputs = ascent_cases(0, S)[1]
    a = lp_device.ShardedAscentInputs.split(inputs, S)
    best, lam, last = run_emulated(emulated, a, 8, S)
    want = lp_device.ascend_sharded_ref(a, 8)
    assert (_bits(best) == _bits(want[0].numpy())).all(), name
    assert (_bits(lam) == _bits(want[1].numpy())).all(), name
    assert (last == want[2].numpy()).all(), name


# the wide layout (a padded axis past 2048, `lp_device.ascent_wide`), a
# cluster of 2 and of 4 emulated blocks (`lp_ascend_cluster_kernel`; the
# card's has up to 16, `lp_device.ascent_cluster`): the warm buckets'
# config axis at both group axes, aws_catalog_50k's padded config axis,
# and padded group axes past 2048 (4438: the bound's dot one multiply-add
# chain; its 64 configs are two windows, so two blocks), a few iterations
# each
WIDE_CASES = [("wide-c4438", 4, 2), ("wide-c4438", 4, 4), ("wide-c4438-g243", 3, 2),
              ("wide-c4438-g243", 3, 4), ("wide-c2840", 4, 2), ("wide-c2840", 4, 4),
              ("wide-g2272", 4, 2), ("wide-g2272", 4, 3), ("wide-g4438", 3, 2)]


def _hold_cluster(exe, a, n_iters: int, blocks: int, tag):
    assert lp_device.ascent_wide(*a.compat.shape)
    assert 2 <= blocks <= lp_device.ascent_cluster(*a.compat.shape)
    best, lam, last = run_emulated(exe, a, n_iters, cluster=blocks)
    want = lp_device.ascend_ref(a, n_iters)
    assert (_bits(best[0]) == _bits(want[0].numpy())).all(), tag
    assert (_bits(lam[0]) == _bits(want[1].numpy())).all(), tag
    assert int(last[0]) == int(want[2]), tag


@pytest.mark.parametrize("name,n_iters,blocks", WIDE_CASES)
def test_emulated_wide_ascent_equals_plain_version(emulated, name, n_iters, blocks):
    (case, a), = ascent_wide_cases(0, names=(name,))
    _hold_cluster(emulated, a, n_iters, blocks, (case, blocks))


def test_emulated_three_window_levels(emulated):
    """A config axis past 32 x 1024 terms: the ordered sums over configs
    (dtheta's, each d ratio row) take a third level of windows, here over
    a cluster of 4 blocks."""
    a = ascent_edge_case(5, 12, 34000, 3, 64, 30, 2, 2)
    assert lp_device.window_pad(lp_device.window_pad(34000)[0])[0] > 32
    _hold_cluster(emulated, a, 3, 4, "34000 configs")


# the wide layout's block boundaries against XLA's windows: 2100 configs
# are 66 windows after 6 front zeros, grouped in level-2 windows after 15
# front windows (0-16, 17-48, 49-65); over 4 blocks (windows from 0, 16,
# 33, 49) the last block starts on a level-2 boundary and the second one
# window before one; over 2 blocks (from 33) inside a level-2 window.
# 2072 configs: 65 windows after 4 front zeros, level-2 windows 0-16,
# 17-48, 49-64 (15 front windows); over 4 blocks (0, 16, 32, 48) the
# boundaries fall one window before each level-2 boundary.
BOUNDARY_CASES = [(2100, 4), (2100, 2), (2072, 4)]


@pytest.mark.parametrize("C,blocks", BOUNDARY_CASES)
def test_emulated_cluster_split_on_window_boundaries(emulated, C, blocks):
    nw, front = lp_device.window_pad(C)
    nw2, front2 = lp_device.window_pad(nw)
    starts = [w0 for _, _, w0, _ in lp_device.cluster_ranges(C, blocks)]
    assert front > 0 and nw2 > 1
    if (C, blocks) == (2100, 4):
        assert starts == [0, 16, 33, 49] and (49 + front2) % 32 == 0
    a = ascent_edge_case(7, 12, C, 3, 4, 20, 2, 2)
    _hold_cluster(emulated, a, 4, blocks, (C, blocks))


def test_emulated_wide_split_ascent_equals_plain_version(emulated):
    """Split B5 with each shard's column block past 2048 (4438 configs
    over 2 shards: 2219 each) runs the wide body in every block."""
    (name, inputs), = ascent_wide_cases(0, names=("wide-c4438",))
    a = lp_device.ShardedAscentInputs.split(inputs, 2)
    assert lp_device.ascent_wide(*a.compat[0].shape)
    best, lam, last = run_emulated(emulated, a, 3, 2)
    want = lp_device.ascend_sharded_ref(a, 3)
    assert (_bits(best) == _bits(want[0].numpy())).all(), name
    assert (_bits(lam) == _bits(want[1].numpy())).all(), name
    assert (last == want[2].numpy()).all(), name
