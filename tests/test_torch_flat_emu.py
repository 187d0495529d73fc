"""Split B2's kernel (`pack_flat_sharded_kernel` in
`karpenter_tpu_torch/csrc/pack_flat.cu`) run on the CPU, held word for
word against its plain version `pack_shard.pack_flat_words_sharded_ref`.

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
from karpenter_tpu_torch.solver import pack_shard

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


@pytest.fixture(scope="module")
def flat_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("flat_emu")
    for f in ("cuda_emu.h", "cuda_runtime.h"):
        shutil.copy(EMU / f, out / f)
    src = (CSRC / "pack_flat.cu").read_text()
    body = src[:src.index("int launch(")]
    (out / "flat.cc").write_text('#include "cuda_emu.h"\n' + body + "\n}  // namespace\n"
                                 + (EMU / "flat.inc").read_text())
    exe = out / "flat"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{out}", "-o", str(exe),
         str(out / "flat.cc")], capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


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
