"""Split B2's kernel (`pack_flat_sharded_kernel` in
`karpenter_tpu_torch/csrc/pack_flat.cu`) run on the CPU, held word for
word against its plain version `pack_shard.pack_flat_words_sharded_ref`;
and B2 over lanes (`pack_flat_kernel`, the full copy) and the flat
routes' mask epilogue (`pack_flat_masks_kernel`) at L = 1 and
L = 5, with and without the wavefront's stats, against
`pack_split.pack_flat_lanes_ref` (the epilogue on a buffer whose other
regions hold the outputs, as the packing kernels leave it).

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (a std::thread a CUDA thread, per-warp buffers for the
ballot), the kernel's text unchanged; the harness (`cuda_emu/flat.inc`)
runs a grid of 3 blocks of 64 threads, so that the grid-stride loop
takes several turns. Cases: S = 2, 3, 4 and 8 shards whose widths are not
multiples of 32 (mask words straddle shards), with and without the
wavefront's stats, random masks and replicated outputs. No JAX; skips
where g++ cannot build C++20.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import pack_shard, pack_split

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


def _build(tmp_path_factory, harness: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp(f"{harness}_emu")
    for f in ("cuda_emu.h", "cuda_runtime.h"):
        shutil.copy(EMU / f, out / f)
    src = (CSRC / "pack_flat.cu").read_text()
    body = src[:src.index("int launch(")]
    (out / "flat.cc").write_text('#include "cuda_emu.h"\n' + body + "\n}  // namespace\n"
                                 + (EMU / f"{harness}.inc").read_text())
    exe = out / "flat"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{out}", "-o", str(exe),
         str(out / "flat.cc")], capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def flat_exe(tmp_path_factory):
    return _build(tmp_path_factory, "flat")


@pytest.fixture(scope="module")
def lanes_exe(tmp_path_factory):
    return _build(tmp_path_factory, "flat_lanes")


def _case(seed, S, Cs, F=9, N=13, G=5, stats=True):
    rng = np.random.default_rng(seed)
    one = rng.integers(0, 50, size=(N, G)).astype(np.int32)
    assign = np.repeat(one[None], S, axis=0)
    masks = rng.random((S, F, Cs)) < 0.4
    node_count = np.full((S,), rng.integers(0, N), np.int32)
    unsched = np.repeat(rng.integers(0, 9, size=(1, G)).astype(np.int32), S, axis=0)
    widths = np.repeat(rng.integers(0, 4, size=(1, G)).astype(np.int32), S, axis=0)
    steps = np.full((S,), rng.integers(1, 30), np.int32)
    return assign, masks, node_count, unsched, (widths, steps) if stats else None


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


# (S, Cs): shard widths whose words straddle shards (Cs * S a multiple of 32)
SHAPES = [(2, 48), (3, 32), (4, 56), (8, 28), (8, 4)]


@pytest.mark.parametrize("S, Cs", SHAPES)
@pytest.mark.parametrize("stats", [True, False])
def test_emulated_split_b2_equals_plain_version(flat_exe, tmp_path, S, Cs, stats):
    assign, masks, node_count, unsched, st = _case(S * 100 + Cs, S, Cs, stats=stats)
    N, G = assign.shape[1:]
    F = masks.shape[1]
    path = tmp_path / "case.bin"
    parts = [struct.pack("6i", N, G, F, Cs, S, int(stats)), assign.tobytes(),
             masks.astype(np.uint8).tobytes(), node_count.tobytes(), unsched.tobytes()]
    if stats:
        parts += [st[0].tobytes(), st[1].tobytes()]
    path.write_bytes(b"".join(parts))
    subprocess.run([str(flat_exe), str(path), str(path) + ".out"], check=True, timeout=300)
    got = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.int32)
    t = torch.from_numpy
    want = pack_shard.pack_flat_words_sharded_ref(
        t(assign), [t(np.ascontiguousarray(m)) for m in masks], t(node_count), t(unsched),
        *((t(st[0]), t(st[1])) if stats else ()))
    assert got.shape == tuple(want.shape)
    assert (got == want.numpy()).all()


# ---------------------------------------------------------------- B2 over lanes

FLAT_MODES = {"full copy": 0, "mask words in place": 1}


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("mode", list(FLAT_MODES))
def test_emulated_lane_epilogue_equals_plain_version(lanes_exe, tmp_path, L, stats, mode):
    rng = np.random.default_rng(L * 10 + stats)
    N, G, F, C = 13, 5, 9, 96
    assign = rng.integers(0, 50, size=(L, N, G)).astype(np.int32)
    masks = rng.random((L, F, C)) < 0.4
    node_count = rng.integers(0, N, size=(L,)).astype(np.int32)
    unsched = rng.integers(0, 9, size=(L, G)).astype(np.int32)
    widths = rng.integers(0, 4, size=(L, G)).astype(np.int32)
    steps = rng.integers(1, 30, size=(L,)).astype(np.int32)
    path = tmp_path / "case.bin"
    parts = [struct.pack("7i", N, G, F, C, L, int(stats), FLAT_MODES[mode]), assign.tobytes(),
             masks.astype(np.uint8).tobytes(), node_count.tobytes(), unsched.tobytes()]
    if stats:
        parts += [widths.tobytes(), steps.tobytes()]
    path.write_bytes(b"".join(parts))
    subprocess.run([str(lanes_exe), str(path), str(path) + ".out"], check=True, timeout=300)
    got = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.int32)
    t = torch.from_numpy
    want = pack_split.pack_flat_lanes_ref(
        t(assign), t(masks), t(node_count), t(unsched),
        *((t(widths), t(steps)) if stats else ()))
    assert got.size == want.numel()
    assert (got.reshape(tuple(want.shape)) == want.numpy()).all()


# the full copy's grid (pack_flat.cu `flat_blocks` at this size): 65535
# blocks of 256 threads
STRIDE = 65535 * 256


@pytest.mark.parametrize("past", [0, 1])
def test_emulated_full_copy_at_the_32_bit_boundary(lanes_exe, tmp_path, past):
    # one lane of one group whose assignment and mask words fill the
    # output up to the 32-bit index limit of the grid-stride loop: its
    # largest index (the last word's plus the grid's stride) is 2^31 - 1,
    # the int kernel's last, or one past it, where the launcher takes the
    # 64-bit kernel; F C mask bytes past 2^31 in both (the last mask
    # word's byte offset). The arrays are mapped, not filled: the
    # emulation runs the threads of the last mask word, the last word and
    # the grid's last thread, and checks every word they wrote.
    C, G, F = 32, 1, 2**26 + 1
    total = 2**31 - STRIDE + past
    N = total - F - 1 - G
    assert F * C > 2**31 and total - 1 + STRIDE == 2**31 - 1 + past
    path = tmp_path / "boundary.bin"
    path.write_bytes(struct.pack("7i", N, G, F, C, 1, 0, 2))
    subprocess.run([str(lanes_exe), str(path), str(path) + ".out"], check=True, timeout=60)
    use_int, word, written, wrong = struct.unpack(
        "4q", Path(str(path) + ".out").read_bytes())
    pattern = sum(1 << b for b in range(0, 32, 3))
    assert use_int == (past == 0)
    assert word == pattern and written > 3 * (total // STRIDE) and wrong == 0
