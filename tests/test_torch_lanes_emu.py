"""B6's sequential program (`pack_split_kernel` in
`karpenter_tpu_torch/csrc/pack_split.cu`, B1's body over a lane axis at
a block size fit to the lanes) run on the CPU, held byte for byte
against its plain version `pack_split.pack_probe_lanes_ref`; and B6's
wavefront program (`lane_wavefront_body` in `csrc/pack_wavefront.cu`, a
block a lane, each round's plans in lane order up to the first rejected),
held byte for byte against `pack_split.pack_probe_lanes_wavefront_ref`,
the rounds and their widths included.

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (a std::thread a CUDA thread, a futex barrier for block
and warp barriers, per-warp buffers for shuffles and ballots), the
source unchanged up to its kernels; the harness (`cuda_emu/lanes_b6.inc`)
runs a block a lane, one process a block, at both of the kernel's block
sizes (`pack_split.LANE_THREADS`, 256, B6's; and 1024, B1's, on one
lane), all shared and spilled (the compat bits alone in global scratch,
and every segment there), on both of `testing.lane_cases`' cases at a
small size (the fleet; reservations with pairwise conflicts), in both
modes;
and in place, its outputs the regions of the flat routes' buffer
(`pack_split.flat_layout`, a lane's row its stride), equal to the plain
lane epilogue's rows. No JAX; skips where g++ cannot build C++20.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import pack_split

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


@pytest.fixture(scope="module")
def lanes_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("lanes_emu")
    for f in ("cuda_emu.h", "xchg_host.h", "cuda_runtime.h", "cuda_pipeline.h"):
        shutil.copy(EMU / f, out / f)
    for f in ("shard_xchg.cuh", "pack_common.cuh"):
        shutil.copy(CSRC / f, out / f)
    src = (CSRC / "pack_split.cu").read_text()
    body = src[:src.index("template <bool kSpilled, int kT>\n__global__")]
    (out / "lanes.cc").write_text('#include "xchg_host.h"\n#define __shared__ static\n' + body
                                  + "\n}  // namespace\n" + (EMU / "lanes_b6.inc").read_text())
    exe = out / "lanes"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / "lanes.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def wave_lanes_exe(tmp_path_factory):
    """The emulated B6 wavefront program: pack_wavefront.cu up to its
    kernels, kThreads rewritten to 64, the harness `cuda_emu/lanes_wave.inc`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("wave_lanes_emu")
    for f in ("cuda_emu.h", "xchg_host.h", "cuda_runtime.h", "cuda_pipeline.h",
              "cooperative_groups.h"):
        shutil.copy(EMU / f, out / f)
    shutil.copy(CSRC / "shard_xchg.cuh", out / "shard_xchg.cuh")
    common = (CSRC / "pack_common.cuh").read_text()
    old = "constexpr int kThreads = 1024;"
    assert common.count(old) == 1
    (out / "pack_common.cuh").write_text(common.replace(old, "constexpr int kThreads = 64;"))
    src = (CSRC / "pack_wavefront.cu").read_text()
    body = src[:src.index("struct GridBarrier {")]
    (out / "wave_lanes.cc").write_text('#include "xchg_host.h"\n#define __shared__ static\n'
                                       + body + "\n}  // namespace\n"
                                       + (EMU / "lanes_wave.inc").read_text())
    exe = out / "wave_lanes"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / "wave_lanes.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


# the lanes emulated: one whose bound rows are all dead, and a typical
# one (a padded lane, no demand and no live rows, is held on the card)
LANES = [1, 2]


def _lane_cases(n_pods):
    with testing.one_core():
        out = testing.lane_cases(0, n_pods=n_pods, n_types=16, n_lanes=3)
    for case in out:
        args = list(case.args)
        assert args[2][LANES].sum(axis=1).min() > 0 and not args[10][1].any()
        args[2], args[10] = args[2][LANES], args[10][LANES]
        case.args = tuple(args)
    return out


@pytest.fixture(scope="module")
def cases():
    return _lane_cases(300)  # 223 rows: one chunk at 256 threads


@pytest.fixture(scope="module")
def big():
    return _lane_cases(600)  # 437 rows: two chunks at 256 threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x, dt):
    return np.ascontiguousarray(np.asarray(x).astype(dt))


def run_lanes(exe: Path, case, mode: str, threads: int, tmp: Path, budget=None,
              in_place=False, lanes=None):
    """The emulated B6 sequential program on `case` at `threads` a
    block: (assign [L, N, G], free_mask [L, F, C], node_count [L],
    unsched [L, G]), or with `in_place` the flat buffer and its layout.
    `budget`: the spilled kernel's placement under that many bytes of
    shared memory (it must spill). `lanes`: the
    case's lanes to run (all of them when None)."""
    (compat, req, counts, alloc, pool, oh, bcompat, balloc, bused, bslot, live,
     price) = case.args
    if lanes is not None:
        counts, live = counts[lanes], live[lanes]
    kw = case.kwargs
    G, C = compat.shape
    R, L, B, P1 = req.shape[1], counts.shape[0], balloc.shape[0], oh.shape[0]
    F = case.max_free
    N = B + F
    cfg_rsv = kw.get("cfg_rsv")
    cfg_rsv = np.full((C,), -1, np.int32) if cfg_rsv is None else cfg_rsv
    rsv_cap = kw.get("rsv_cap")
    rsv_cap = np.zeros((0,), np.float32) if rsv_cap is None else rsv_cap
    conflict = kw.get("conflict")
    K = rsv_cap.shape[0]
    lay = pack_split.table_placement(C, R, P1, K, G, budget=budget)
    assert lay["spilled"] == (budget is not None), (case.name, budget)
    flat = pack_split.flat_layout(L, N, G, F, C, False)
    row, masks, total = (flat["row"], flat["masks"], flat["total"]) if in_place else (0, 0, 0)
    buf = [struct.pack("15i", G, C, R, B, F, K, P1, 1 if mode == "cost" else 0, L, threads,
                       conflict is not None, lay["spilled"], row, masks, total)]
    if lay["spilled"]:
        buf.append(struct.pack(f"={len(lay['offsets'])}i2q", *lay["offsets"],
                               lay["scratch"], lay["smem"]))
    for x, dt in ((compat, np.uint8), (req, np.float32), (counts, np.int32),
                  (alloc, np.float32), (pool, np.int32), (oh, np.float32),
                  (bcompat, np.uint8), (balloc, np.float32), (bused, np.float32),
                  (bslot, np.int32), (live, np.uint8), (price, np.float32),
                  (cfg_rsv, np.int32), (rsv_cap, np.float32)):
        buf.append(_np(x, dt).tobytes())
    if conflict is not None:
        buf.append(_np(conflict, np.uint8).tobytes())
    path = tmp / f"lanes-{case.name}-{mode}-{threads}-{budget}-{in_place}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint8)
    if in_place:
        return torch.from_numpy(raw.view(np.int32).copy()), flat
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = raw[o:o + n * np.dtype(dt).itemsize].view(dt).reshape(shape)
        o += n * np.dtype(dt).itemsize
        return v

    return (take(L * N * G, np.int32, (L, N, G)), take(L * F * C, np.uint8, (L, F, C)),
            take(L, np.int32, (L,)), take(L * G, np.int32, (L, G)))


def _plain(case, mode, lanes=None):
    t = torch.from_numpy
    args = [t(np.ascontiguousarray(a)) for a in case.args]
    if lanes is not None:
        args[2], args[10] = args[2][lanes], args[10][lanes]
    kw = {k: None if v is None else t(np.ascontiguousarray(v)) for k, v in case.kwargs.items()}
    return pack_split.pack_probe_lanes_ref(*args, max_free=case.max_free, mode=mode, **kw)


def _gbits_budget(case):
    """The budget under which the case's placement spills the compat
    bits alone."""
    compat, req, _, _, _, oh = case.args[:6]
    rsv_cap = case.kwargs.get("rsv_cap")
    K = 0 if rsv_cap is None else rsv_cap.shape[0]
    G, C = compat.shape
    return pack_split.table_placement(C, req.shape[1], oh.shape[0], K, G)["smem"] - 1


# (block size, rows, case, placement, mode): B6's 256 threads on rows
# that take two chunks (and one chunk, every segment spilled); B1's 1024
# on the typical lane alone (the emulation's cost grows with the threads)
RUNS = [
    (pack_split.LANE_THREADS, "two chunks", 0, "shared", "ffd"),
    (pack_split.LANE_THREADS, "two chunks", 1, "compat bits spilled", "cost"),
    (pack_split.LANE_THREADS, "two chunks", 1, "all spilled", "ffd"),
    (pack_split.LANE_THREADS, "one chunk", 0, "all spilled", "cost"),
    (1024, "one chunk", 0, "shared", "cost"),
    (1024, "one chunk", 1, "compat bits spilled", "ffd"),
]


@pytest.mark.parametrize("threads, rows, index, placement, mode", RUNS)
def test_emulated_b6_sequential_equals_plain_version(lanes_exe, cases, big, tmp_path, threads,
                                                     rows, index, placement, mode):
    case = (big if rows == "two chunks" else cases)[index]
    budget = {"shared": None, "all spilled": 0,
              "compat bits spilled": _gbits_budget(case)}[placement]
    lanes = [1] if threads == 1024 else None
    with testing.one_core():
        got = run_lanes(lanes_exe, case, mode, threads, tmp_path, budget, lanes=lanes)
        want = _plain(case, mode, lanes)
    tag = (case.name, mode, threads, placement)
    assert (got[0] == want[0].numpy()).all(), tag
    assert (got[1] == want[1].numpy().astype(np.uint8)).all(), tag
    assert (got[2] == want[2].numpy()).all(), tag
    assert (got[3] == want[3].numpy()).all(), tag


@pytest.mark.parametrize("index", [0, 1])
def test_emulated_b6_sequential_in_place_equals_plain_flat_rows(lanes_exe, cases, tmp_path,
                                                                index):
    # the flat route: the outputs written into each lane's row of one
    # buffer (lane stride `row`), then the plain mask epilogue, equal to
    # the plain lane epilogue on the plain outputs
    case = cases[index]
    mode = ("ffd", "cost")[index]
    threads = pack_split.LANE_THREADS
    with testing.one_core():
        buf, lay = run_lanes(lanes_exe, case, mode, threads, tmp_path, in_place=True)
        pack_split.pack_flat_masks_ref(buf, lay)
        want = pack_split.pack_flat_lanes_ref(*_plain(case, mode))
    got = pack_split.flat_views(buf, lay)[0]
    assert got.shape == want.shape and torch.equal(got, want), case.name


def run_wave_lanes(exe: Path, case, mode: str, width: int, tmp: Path, budget=None):
    """The emulated B6 wavefront program on `case` at `width`: (assign [L,
    N, G], free_mask [L, F, C], node_count [L], unsched [L, G], steps [L],
    widths [L, G]). `budget`: the spilled placement under that many bytes
    of shared memory (it must spill)."""
    (compat, req, counts, alloc, pool, oh, bcompat, balloc, bused, bslot, live,
     price) = case.args
    kw = case.kwargs
    G, C = compat.shape
    R, L, B, P1 = req.shape[1], counts.shape[0], balloc.shape[0], oh.shape[0]
    F = case.max_free
    N = B + F
    cfg_rsv = kw.get("cfg_rsv")
    cfg_rsv = np.full((C,), -1, np.int32) if cfg_rsv is None else cfg_rsv
    rsv_cap = kw.get("rsv_cap")
    rsv_cap = np.zeros((0,), np.float32) if rsv_cap is None else rsv_cap
    conflict = kw.get("conflict")
    K = rsv_cap.shape[0]
    lay = pack_split.table_placement(C, R, P1, K, G, W=width, N=N, budget=budget)
    assert lay["spilled"] == (budget is not None), (case.name, budget)
    buf = [struct.pack("12i", G, C, R, B, F, K, P1, 1 if mode == "cost" else 0, L, width,
                       conflict is not None, lay["spilled"])]
    if lay["spilled"]:
        buf.append(struct.pack(f"={len(lay['offsets'])}i2q", *lay["offsets"],
                               lay["scratch"], lay["smem"]))
    for x, dt in ((compat, np.uint8), (req, np.float32), (counts, np.int32),
                  (alloc, np.float32), (pool, np.int32), (oh, np.float32),
                  (bcompat, np.uint8), (balloc, np.float32), (bused, np.float32),
                  (bslot, np.int32), (live, np.uint8), (price, np.float32),
                  (cfg_rsv, np.int32), (rsv_cap, np.float32)):
        buf.append(_np(x, dt).tobytes())
    if conflict is not None:
        buf.append(_np(conflict, np.uint8).tobytes())
    path = tmp / f"wave-{case.name}-{mode}-{width}-{budget}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint8)
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = raw[o:o + n * np.dtype(dt).itemsize].view(dt).reshape(shape)
        o += n * np.dtype(dt).itemsize
        return v

    return (take(L * N * G, np.int32, (L, N, G)), take(L * F * C, np.uint8, (L, F, C)),
            take(L, np.int32, (L,)), take(L * G, np.int32, (L, G)), take(L, np.int32, (L,)),
            take(L * G, np.int32, (L, G)))


def _wave_budget(case, width: int, spill: str):
    """The budget under which the case's wavefront placement spills the
    compat bits alone ("compat bits") or every segment ("all")."""
    if spill == "all":
        return 0
    compat, req, _, _, _, oh = case.args[:6]
    rsv_cap = case.kwargs.get("rsv_cap")
    K = 0 if rsv_cap is None else rsv_cap.shape[0]
    G, C = compat.shape
    N = case.args[7].shape[0] + case.max_free
    return pack_split.table_placement(C, req.shape[1], oh.shape[0], K, G, W=width,
                                      N=N)["smem"] - 1


# (case, width, mode, placement): both cases at the card's width 16 (its
# lanes of different round counts), the reservation case with pairwise
# conflicts at 4, and spilled placements
WAVE_RUNS = [
    (0, 16, "ffd", None),
    (1, 16, "cost", None),
    (1, 4, "ffd", "compat bits"),
    (0, 8, "cost", "all"),
]


@pytest.mark.parametrize("index, width, mode, spill", WAVE_RUNS)
def test_emulated_b6_wavefront_equals_plain_version(wave_lanes_exe, cases, tmp_path, index,
                                                    width, mode, spill):
    case = cases[index]
    budget = None if spill is None else _wave_budget(case, width, spill)
    t = torch.from_numpy
    args = [t(np.ascontiguousarray(a)) for a in case.args]
    kw = {k: None if v is None else t(np.ascontiguousarray(v)) for k, v in case.kwargs.items()}
    with testing.one_core():
        got = run_wave_lanes(wave_lanes_exe, case, mode, width, tmp_path, budget)
        want = pack_split.pack_probe_lanes_wavefront_ref(
            *args, max_free=case.max_free, mode=mode, width=width, **kw)
    tag = (case.name, mode, width, spill)
    for g, w in zip(got, want):
        w = w.numpy()
        assert (g == (w.astype(np.uint8) if w.dtype == bool else w)).all(), tag
    if width == 16:
        # the lanes ran different numbers of rounds, more than one each
        assert len(set(got[4].tolist())) > 1 and got[4].min() > 1, (tag, got[4])
