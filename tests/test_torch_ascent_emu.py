"""B5's CUDA source (`karpenter_tpu_torch/csrc/lp_ascend.cu`) run on the
CPU, held bit for bit against its plain version.

The kernel's device code, at a block of 64 threads, is compiled as C++20
with g++ against a small emulation of the CUDA calls it makes (`tests/cuda_emu/`: a std::thread a
CUDA thread, std::barrier for block and warp barriers, per-warp buffers
for shuffles and ballots, std::atomic_ref for the atomics, IEEE single
precision for the float intrinsics) and the split kernels' exchange
(`csrc/shard_xchg.cuh`, its device-only calls replaced). The emulated
kernel runs one block (or S blocks for split B5) on seeded inputs and
must give the plain version's best value, best duals and last improving
iteration bit for bit: `ascend_ref` (or `ascend_sharded_ref`, every
replica). What the card adds (timing, the real memory model, the
compiler's code) is `tests/test_torch_cuda.py`'s and `chip_smoke.py`'s.
No JAX; skips where g++ cannot build C++20.
"""

import re
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import lp_device
from karpenter_tpu_torch.testing import ascent_cases, ascent_edge_cases

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"


def _exchange_source() -> str:
    """csrc/shard_xchg.cuh with its device-only calls replaced: the
    scope as an enum, the atomic counter as std::atomic_ref, the global
    timer as the steady clock, the fences as sequentially consistent
    fences, and each block's shared variables indexed by the block."""
    src = (CSRC / "shard_xchg.cuh").read_text()
    src = src.replace(
        "#include <cuda/atomic>\n#include <cuda_runtime.h>\n#include <stdint.h>\n",
        '#include <chrono>\n#include "cuda_emu.h"\n'
        "namespace cuda {\n"
        "enum thread_scope { thread_scope_device, thread_scope_system };\n"
        "enum memory_order { memory_order_relaxed };\n"
        "template <class T, thread_scope S> struct atomic_ref {\n"
        "  std::atomic_ref<T> r;\n"
        "  atomic_ref(T& v) : r(v) {}\n"
        "  T fetch_add(T v, memory_order) { return r.fetch_add(v); }\n"
        "  T load(memory_order) const { return r.load(); }\n"
        "};\n"
        "}  // namespace cuda\n"
        "inline unsigned long long __ldcg(const unsigned long long* p) {\n"
        "  return std::atomic_ref<unsigned long long>(*const_cast<unsigned long long*>(p)).load();\n"
        "}\n")
    src = re.sub(r'unsigned long long t;\s*asm volatile\("mov\.u64 %0, %%globaltimer;" : "=l"\(t\)\);'
                 r"\s*return t;",
                 "return (unsigned long long)std::chrono::duration_cast<std::chrono::nanoseconds>("
                 "std::chrono::steady_clock::now().time_since_epoch()).count();", src)
    src = src.replace(
        "if constexpr (Scope == cuda::thread_scope_system) __threadfence_system();\n"
        "  else __threadfence();", "std::atomic_thread_fence(std::memory_order_seq_cst);")
    src = src.replace("__trap();", "abort();")
    src = src.replace("__shared__ unsigned long long s_out;",
                      "static unsigned long long s_out_[64];\n"
                      "  unsigned long long& s_out = s_out_[blockIdx.x];")
    src = src.replace("__shared__ unsigned long long s_k[n], s_p[n];",
                      "static unsigned long long s_k_[64][n], s_p_[64][n];\n"
                      "    auto& s_k = s_k_[blockIdx.x];\n    auto& s_p = s_p_[blockIdx.x];")
    return src


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
    return body + "\n}  // namespace\n" + (EMU / "harness.inc").read_text()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated kernel's executable, built once a module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("ascent_emu")
    for f in ("cuda_emu.h", "pack_common.cuh"):
        shutil.copy(EMU / f, out / f)
    (out / "shard_xchg_emu.h").write_text(_exchange_source())
    (out / "lp_ascend_emu.cc").write_text(_kernel_source())
    exe = out / "lp_ascend_emu"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread",
         "-w", "-o", str(exe), str(out / "lp_ascend_emu.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def run_emulated(exe: Path, a, n_iters: int, shards: int = 1):
    """(best [S], best_lam [S, Gp], last_up [S]) of the emulated kernel
    on `a` (AscentInputs, or ShardedAscentInputs with `shards` > 1)."""
    one = (lambda n: getattr(a, n)[0]) if shards > 1 else (lambda n: getattr(a, n))
    Gp, Cp = one("compat").shape
    R, Kp = a.req.shape[1], one("onehot").shape[0]
    lay = lp_device.ascent_layout(Gp, Cp, R, Kp)

    def put(buf, t):
        t = t.numpy()
        buf.append(np.ascontiguousarray(
            t.astype(np.uint8) if t.dtype == bool else t.astype(np.float32)).tobytes())

    buf = [struct.pack("6i", Gp, Cp, R, Kp, n_iters, shards),
           struct.pack(f"{len(lay['offsets'])}q", *lay["offsets"]),
           struct.pack("2q", lay["smem"], lay["scratch"])]
    for n in ("lam0", "count", "count_w", "req", "budget"):
        put(buf, getattr(a, n))
    for sh in range(shards):
        for n in ("compat", "alloc", "price", "valid", "onehot", "uncapped"):
            put(buf, getattr(a, n)[sh] if shards > 1 else getattr(a, n))
    path = exe.parent / f"in-{Gp}-{Cp}-{n_iters}-{shards}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer((Path(str(path) + ".out")).read_bytes(), np.uint8)
    S = shards
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
