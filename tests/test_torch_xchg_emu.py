"""The split kernels' exchange (`karpenter_tpu_torch/csrc/shard_xchg.cuh`)
and split B1 (`csrc/pack_split.cu` over `csrc/pack_common.cuh`) run on
the CPU, held against sequential references.

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (a std::thread a CUDA thread, a futex barrier for block
and warp barriers, per-warp buffers for shuffles and ballots), the
header unchanged: `tests/cuda_emu/xchg_host.h` defines its named device
functions (the flagged word's store and poll on std::atomic_ref, the
timer, the trap, a block's shared variables, the shard barrier's
release and acquire). Its reader aborts on a tag ahead of the one it
waits for, as the card's traps.

- The exchange: S in {2, 3, 4, 8} shards of two lanes each (blocks of
  64 threads, laid out as split B3's), one seeded script of 2,000
  exchanges of every kind with random yields between them: scalar max,
  shard-ordered float sum and int sum, a (key, payload) pick through a
  staged exchange, vectors (OR, shard-ordered sums), per-thread row
  partials, and split B3's per-shard barrier. Every block's result must
  equal a sequential numpy reference (floats bit for bit).
- Split B1 at S in {2, 3} (kThreads rewritten to 64, one process a
  block so that each block's __shared__ statics are its own): byte for
  byte against `pack_shard.pack_split_sharded_ref` on the fold's corner
  cases (`testing.fold_cases`), the boundary-tie cases and seeded kernel
  cases. Here the open loop's one exchange an open is first proven.

The emulation's memory model is x86's, stronger than the card's: the
card's weak ordering is held only by `chip_smoke.py` and
`tests/test_torch_cuda.py`. No JAX; skips where g++ cannot build C++20.
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

# the script: ops, the words of a block's data, and the kinds
OPS = 2000
D = 160
MAX_F32, SUM_F32, SUM_INT, KEY, VEC_OR, VEC_SUM, ROWS, BARRIER = range(8)
LANES = 2


def _build(out: Path, name: str, source: str) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernels cannot be built")
    for f in ("cuda_emu.h", "xchg_host.h", "cuda_runtime.h", "cuda_pipeline.h"):
        shutil.copy(EMU / f, out / f)
    shutil.copy(CSRC / "shard_xchg.cuh", out / "shard_xchg.cuh")
    (out / f"{name}.cc").write_text(source)
    exe = out / name
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / f"{name}.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def script_exe(tmp_path_factory):
    out = tmp_path_factory.mktemp("xchg_emu")
    return _build(out, "xchg_script", '#include "xchg_host.h"\n#include "shard_xchg.cuh"\n'
                  + (EMU / "xchg_script.inc").read_text())


def _script(seed: int, S: int):
    """The ops (kind, n) and every block's data [M, W, S, D]."""
    rng = np.random.default_rng(seed)
    kinds = np.concatenate([np.arange(8), rng.integers(0, 8, size=OPS - 8)])
    sizes = np.zeros(OPS, np.int64)
    data = rng.integers(0, 2**32, size=(OPS, LANES, S, D), dtype=np.uint64).astype(np.uint32)
    for m, k in enumerate(kinds):
        if k in (MAX_F32, SUM_F32):
            f = rng.normal(0, 100, size=(LANES, S)).astype(np.float32)
            f[rng.random((LANES, S)) < 0.1] = np.float32(0.1)  # ties
            data[m, :, :, 0] = f.view(np.uint32)
        elif k == KEY:
            data[m, :, :, 0] = rng.integers(0, 3, size=(LANES, S))  # tied values
            data[m, :, :, 1] = np.arange(S)[None, :] * 7 + rng.integers(0, 7, size=(LANES, S))
        elif k in (VEC_OR, VEC_SUM):
            sizes[m] = rng.integers(1, D + 1)
            if k == VEC_SUM:
                data[m] = rng.normal(0, 1, size=(LANES, S, D)).astype(np.float32).view(np.uint32)
        elif k == ROWS:
            sizes[m] = rng.integers(1, D // 2 + 1)
            data[m] >>= 1  # partials below 2^31
    return kinds, sizes, data


def _expected(kinds, sizes, data):
    """What every shard of each lane must return, [M, W, D] (the
    barrier's result is compared per shard, in the test)."""
    want = np.zeros(data.shape[:2] + data.shape[3:], np.uint32)
    S = data.shape[2]
    for m, k in enumerate(kinds):
        d = data[m]
        n = int(sizes[m])
        if k == MAX_F32:
            want[m, :, 0] = np.fmax.reduce(d[:, :, 0].view(np.float32), axis=1).view(np.uint32)
        elif k == SUM_F32:
            f = d[:, :, 0].view(np.float32)
            acc = f[:, 0].copy()
            for sh in range(1, S):
                acc = (acc + f[:, sh]).astype(np.float32)
            want[m, :, 0] = acc.view(np.uint32)
        elif k == SUM_INT:
            want[m, :, 0] = d[:, :, 0].astype(np.uint64).sum(axis=1).astype(np.uint32)
        elif k == KEY:
            keys = (d[:, :, 0].astype(np.uint64) << np.uint64(32)) | d[:, :, 1].astype(np.uint64)
            win = keys.argmin(axis=1)
            lanes = np.arange(d.shape[0])
            want[m, :, 0] = d[lanes, win, 0]
            want[m, :, 1] = d[lanes, win, 1]
            want[m, :, 2] = d[lanes, win, 2]
        elif k == VEC_OR:
            want[m, :, :n] = np.bitwise_or.reduce(d[:, :, :n], axis=1)
        elif k == VEC_SUM:
            f = d[:, :, :n].view(np.float32)
            acc = f[:, 0].copy()
            for sh in range(1, S):
                acc = (acc + f[:, sh]).astype(np.float32)
            want[m, :, :n] = acc.view(np.uint32)
        elif k == ROWS:
            want[m, :, :2 * n] = d[:, :, :2 * n].max(axis=1)
    return want


def _compare_width(k, n):
    return {MAX_F32: 1, SUM_F32: 1, SUM_INT: 1, KEY: 3, VEC_OR: n, VEC_SUM: n,
            ROWS: 2 * n, BARRIER: 1}[int(k)]


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_emulated_exchange_script_equals_sequential_reference(script_exe, tmp_path, S):
    kinds, sizes, data = _script(100 + S, S)
    path = tmp_path / f"script-{S}.bin"
    head = struct.pack("5i", S, LANES, OPS, D, 7 + S)
    ops = np.stack([kinds, sizes], axis=1).astype(np.int32).tobytes()
    path.write_bytes(head + ops + np.ascontiguousarray(data).tobytes())
    subprocess.run([str(script_exe), str(path), str(path) + ".out"], check=True, timeout=600)
    got = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint32).reshape(data.shape)
    want = _expected(kinds, sizes, data)
    for m, k in enumerate(kinds):
        w = _compare_width(k, int(sizes[m]))
        for lane in range(LANES):
            for sh in range(S):
                if k == BARRIER:
                    # the lanes of shard sh met: each saw every lane's value
                    exp = np.uint32(data[m, :, sh, 0].astype(np.uint64).sum() & 0xffffffff)
                    assert got[m, lane, sh, 0] == exp, (m, lane, sh)
                    continue
                assert (got[m, lane, sh, :w] == want[m, lane, :w]).all(), (m, int(k), lane, sh)


# ---------------------------------------------------------------- split B1

def _split_b1_source() -> str:
    """The device code of csrc/pack_split.cu up to its kernels, over
    pack_common.cuh at 64 threads a block, each block's __shared__
    variables as statics (one process a block), and the harness."""
    src = (CSRC / "pack_split.cu").read_text()
    body = src[:src.index("template <bool kSpilled, int kT>\n__global__")]
    return ('#include "xchg_host.h"\n#define __shared__ static\n' + body
            + "\n}  // namespace\n" + (EMU / "split_b1.inc").read_text())


@pytest.fixture(scope="module")
def split_b1_exe(tmp_path_factory):
    out = tmp_path_factory.mktemp("split_b1_emu")
    common = (CSRC / "pack_common.cuh").read_text()
    old = "constexpr int kThreads = 1024;"
    assert common.count(old) == 1
    # two warps a block: the kernel's code is the same at any multiple of
    # 32 threads (its strided loops take more turns)
    (out / "pack_common.cuh").write_text(common.replace(old, "constexpr int kThreads = 64;"))
    return _build(out, "split_b1", _split_b1_source())


def run_split_b1(exe: Path, case, S: int, tmp: Path, budget: int | None = None):
    """(assign [S, N, G], node_count [S], unsched [S, G], masks [S][F, Cs])
    of the emulated split B1 on `case` cut into S shards, on the layout
    `pack_split.table_placement` gives it (as the wrapper takes it); with
    `budget`, the spilled kernel's placement under that many bytes of
    shared memory (it must spill)."""
    sa, skw, _, _ = testing.split_case(case, S)
    compat, req, count, alloc, pool, oh, bcompat, balloc, bused, bslot, blive, price = sa
    G, Cs = compat[0].shape
    R = req.shape[1]
    B = balloc.shape[0]
    F = case.max_free
    rsv_cap = skw["rsv_cap"]
    K = rsv_cap.shape[0]
    P1 = oh.shape[0]
    quota, gcap, conflict = skw.get("bound_quota"), skw.get("group_cap"), skw.get("conflict")
    lay = pack_split.table_placement(Cs, R, P1, K, G, pools=True, budget=budget)
    assert lay["spilled"] or budget is None, (case.name, budget)
    if not lay["spilled"]:
        lay = None
    buf = [struct.pack("13i", G, Cs, R, B, F, K, P1, 1 if case.mode == "cost" else 0, S,
                       quota is not None, gcap is not None, conflict is not None,
                       lay is not None)]
    if lay is not None:
        buf.append(struct.pack(f"={len(lay['offsets'])}i2q", *lay["offsets"],
                               lay["scratch"], lay["smem"]))

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
    for s in range(S):
        put(compat[s], np.uint8), put(alloc[s], np.float32), put(pool[s], np.int32)
        put(price[s], np.float32), put(skw["cfg_rsv"][s], np.int32)
    path = tmp / f"b1-{case.name}-{S}-{budget}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint8)
    N = B + F
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = raw[o:o + n * np.dtype(dt).itemsize].view(dt).reshape(shape)
        o += n * np.dtype(dt).itemsize
        return v

    assign = take(S * N * G, np.int32, (S, N, G))
    node_count = take(S, np.int32, (S,))
    unsched = take(S * G, np.int32, (S, G))
    masks = [take(F * Cs, np.uint8, (F, Cs)).astype(bool) for _ in range(S)]
    return assign, node_count, unsched, masks


def _t(x):
    if x is None:
        return None
    if isinstance(x, list):
        return [torch.from_numpy(np.ascontiguousarray(b)) for b in x]
    return torch.from_numpy(np.ascontiguousarray(x))


def _b1_cases(S):
    kc = testing.kernel_cases(2, n_pods=300, n_types=16)
    return testing.fold_cases(3, S) + [
        testing.tie_case(11, S, "cost", G=8), testing.tie_case(12, S, "ffd", G=8, quota=True),
        kc[2], kc[5]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", [2, 3])
def test_emulated_split_b1_equals_plain_version(split_b1_exe, tmp_path, S):
    for case in _b1_cases(S):
        assign, node_count, unsched, masks = run_split_b1(split_b1_exe, case, S, tmp_path)
        sa, skw, _, _ = testing.split_case(case, S)
        want = pack_shard.pack_split_sharded_ref(
            *[_t(a) for a in sa], max_free=case.max_free, mode=case.mode,
            **{k: _t(v) for k, v in skw.items()})
        assert (assign == want[0].numpy()).all(), case.name
        assert (node_count == want[2].numpy()).all(), case.name
        assert (unsched == want[3].numpy()).all(), case.name
        for s in range(S):
            assert (masks[s] == want[1][s].numpy()).all(), (case.name, s)


# ---------------------------------------------------------------- split B1 spilled, many pools

def _hold_split_b1(exe, case, S, tmp, budget=None):
    assign, node_count, unsched, masks = run_split_b1(exe, case, S, tmp, budget)
    sa, skw, _, _ = testing.split_case(case, S)
    want = pack_shard.pack_split_sharded_ref(
        *[_t(a) for a in sa], max_free=case.max_free, mode=case.mode,
        **{k: _t(v) for k, v in skw.items()})
    tag = (case.name, S, budget)
    assert (assign == want[0].numpy()).all(), tag
    assert (node_count == want[2].numpy()).all(), tag
    assert (unsched == want[3].numpy()).all(), tag
    for s in range(S):
        assert (masks[s] == want[1][s].numpy()).all(), (tag, s)


def _gbits_budget(case, S):
    """The budget under which the case's placement spills the compat
    bits alone (the catalog's placement, at a small shape)."""
    sa, skw, _, _ = testing.split_case(case, S)
    G, Cs = sa[0][0].shape
    return pack_split.table_placement(Cs, sa[1].shape[1], sa[5].shape[0],
                                      skw["rsv_cap"].shape[0], G, pools=True)["smem"] - 1


@pytest.mark.parametrize("S", [2, 4])
def test_emulated_split_b1_spilled_equals_plain_version(split_b1_exe, tmp_path, S):
    # the spilled instantiation (`pack_split_body<true>`): the compat bits
    # alone in global scratch, and every segment there (budget 0: the
    # read-only tables read in place, the rest in each block's slice)
    kc = testing.kernel_cases(2, n_pods=300, n_types=16)
    cases = [testing.fold_cases(3, S)[1], testing.tie_case(11, S, "ffd", G=8, quota=True),
             kc[2], kc[5]]
    with testing.one_core():
        for i, case in enumerate(cases):
            budget = 0 if i % 2 else _gbits_budget(case, S)
            _hold_split_b1(split_b1_exe, case, S, tmp_path, budget)


@pytest.mark.parametrize("S", [2, 4])
def test_emulated_split_b1_with_80_node_pools(split_b1_exe, tmp_path, S):
    # P1 = 81 pool rows: the open loop's pool segment and the exchange's
    # 4 P1 slot words past the 64 pools of the all-shared kernel's static
    # arrays; placed with every segment in shared memory (ffd) and spilled
    # (cost)
    with testing.one_core():
        for case in testing.pools_cases(3):
            budget = 0 if case.mode == "cost" else None
            _hold_split_b1(split_b1_exe, case, S, tmp_path, budget)
