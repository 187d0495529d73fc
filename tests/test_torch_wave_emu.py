"""B3's body (`wavefront_body` in `karpenter_tpu_torch/csrc/pack_wavefront.cu`)
run on the CPU at width 1, held byte for byte against its plain version
`pack_split.pack_split_wavefront_ref`, with its tables all in shared
memory and spilled past a forced budget (`pack_split.table_placement`).

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (kThreads rewritten to 64, a std::thread a CUDA thread,
futex barriers for block and warp barriers); the harness
(`cuda_emu/wave_b3.inc`) runs one block, whose round barriers are the
block's own (the grid of one block). Cases: seeded kernel cases in both
modes (reservations, bound rows with quotas, group caps and conflicts),
each all shared and spilled (the compat bits alone, or every table). No
JAX; skips where g++ cannot build C++20.
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
def wave_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernels cannot be built")
    out = tmp_path_factory.mktemp("wave_emu")
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
    (out / "wave.cc").write_text('#include "xchg_host.h"\n#define __shared__ static\n' + body
                                 + "\n}  // namespace\n" + (EMU / "wave_b3.inc").read_text())
    exe = out / "wave"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / "wave.cc")], capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def _run(exe, case, tmp: Path, budget=None):
    args, kw = case.args, case.kwargs
    compat, req, count, alloc, pool, oh, bcompat, balloc, bused, bslot, blive, price = args
    G, C = compat.shape
    R = req.shape[1]
    B = balloc.shape[0]
    F = case.max_free
    rsv_cap = kw.get("rsv_cap")
    rsv_cap = np.zeros((0,), np.float32) if rsv_cap is None else rsv_cap
    cfg_rsv = kw.get("cfg_rsv")
    cfg_rsv = np.full((C,), -1, np.int32) if cfg_rsv is None else cfg_rsv
    K, P1 = rsv_cap.shape[0], oh.shape[0]
    quota, gcap, conflict = kw.get("bound_quota"), kw.get("group_cap"), kw.get("conflict")
    lay = None
    if budget is not None:
        lay = pack_split.table_placement(C, R, P1, K, G, W=1, N=B + F, budget=budget)
        assert lay["spilled"], (case.name, budget)
    buf = [struct.pack("12i", G, C, R, B, F, K, P1, 1 if case.mode == "cost" else 0,
                       quota is not None, gcap is not None, conflict is not None,
                       lay is not None)]
    if lay is not None:
        buf.append(struct.pack(f"={len(lay['offsets'])}i2q", *lay["offsets"], lay["scratch"],
                               lay["smem"]))

    def put(x, dt):
        buf.append(np.ascontiguousarray(np.asarray(x).astype(dt)).tobytes())

    put(req, np.float32), put(count, np.int32), put(oh, np.float32)
    put(bcompat, np.uint8), put(balloc, np.float32), put(bused, np.float32)
    put(bslot, np.int32), put(blive, np.uint8)
    if quota is not None:
        put(quota, np.int16)
    put(rsv_cap, np.float32)
    if gcap is not None:
        put(gcap, np.int32)
    if conflict is not None:
        put(conflict, np.uint8)
    put(compat, np.uint8), put(alloc, np.float32), put(pool, np.int32)
    put(price, np.float32), put(cfg_rsv, np.int32)
    path = tmp / f"b3-{case.name}-{budget}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint8)
    N = B + F
    sizes = [(N * G, np.int32), (1, np.int32), (G, np.int32), (1, np.int32), (G, np.int32),
             (F * C, np.uint8)]
    outs, o = [], 0
    for n, dt in sizes:
        nb = n * np.dtype(dt).itemsize
        outs.append(raw[o:o + nb].view(dt))
        o += nb
    assign, nc, unsched, steps, widths, mask = outs
    return assign.reshape(N, G), nc[0], unsched, steps[0], widths, mask.reshape(F, C)


def _full_budget(case):
    args = case.args
    G, C = args[0].shape
    rc = case.kwargs.get("rsv_cap")
    size = pack_split.segment_bytes(C, args[1].shape[1], args[5].shape[0],
                                    0 if rc is None else rc.shape[0], G, W=1,
                                    N=args[7].shape[0] + case.max_free)
    return sum(size.values()) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.mark.parametrize("which", [0, 3, 4, 7])
def test_emulated_b3_equals_plain_version(wave_exe, tmp_path, which):
    case = testing.kernel_cases(2, n_pods=300, n_types=16)[which]
    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
         for k, v in case.kwargs.items()}
    want = pack_split.pack_split_wavefront_ref(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in case.args],
        max_free=case.max_free, mode=case.mode, width=1, **t)
    for budget in (None, _full_budget(case), 0):
        assign, nc, unsched, steps, widths, mask = _run(wave_exe, case, tmp_path, budget)
        tag = (case.name, budget)
        assert (assign == want[0].numpy()).all(), tag
        assert (mask == want[1].numpy()).all(), tag
        assert nc == int(want[2]), tag
        assert (unsched == want[3].numpy()).all(), tag
        assert steps == int(want[4]), tag
        assert (widths == want[5].numpy()).all(), tag
