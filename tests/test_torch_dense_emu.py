"""The dense kernel B7 (`pack_dense_kernel` in
`karpenter_tpu_torch/csrc/pack_dense.cu`, B1's group step on one node
axis of mask rows) run on the CPU, held byte for byte against its plain
versions `pack_dense.pack_ref` and `pack_dense.pack_flat_ref`.

The device code compiles as C++20 with g++ against the emulation in
`tests/cuda_emu/` (a std::thread a CUDA thread, a futex barrier for block
and warp barriers, per-warp buffers for shuffles and ballots), the
source unchanged up to its kernels but for its `extern __shared__`
buffer, which the harness (`cuda_emu/dense_b7.inc`) hands over. One
block, at the block size the wrapper takes for the problem's node axis
(`pack_dense.block_threads`: 256 threads for a short one, 1024 for a
long one) and at the other, all shared and spilled (the compat bits
alone in global scratch, and every segment there), in both modes, on:
`graft_entry.entry()`'s problem; `testing.dense_cases`' LP-planned rows
with quotas and reserved (pinned) columns; bound rows with quotas,
group caps and conflicts; pairwise conflicts with group caps; a node
axis capped below need; and `testing.signed_zero_problem`, whose usage
pass shows (-0.0 usage on rows that take nothing). `pack_flat` in place
(the kernel writing the flat buffer's regions) on that one and on
negative, zero and 2^31-scale demand. No JAX; skips where g++ cannot
build C++20.
"""

import functools
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import graft_entry, testing
from karpenter_tpu_torch.solver import pack_dense, pack_split

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "karpenter_tpu_torch" / "csrc"
EMU = HERE / "cuda_emu"
OUTPUTS = ("assign", "node_mask", "node_used", "node_active", "node_count", "unsched")
SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
CAPPED_ROWS = 16


@pytest.fixture(scope="module")
def dense_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the emulated kernel cannot be built")
    out = tmp_path_factory.mktemp("dense_emu")
    for f in ("cuda_emu.h", "xchg_host.h", "cuda_runtime.h", "cuda_pipeline.h"):
        shutil.copy(EMU / f, out / f)
    for f in ("shard_xchg.cuh", "pack_common.cuh"):
        shutil.copy(CSRC / f, out / f)
    src = (CSRC / "pack_dense.cu").read_text()
    body = src[:src.index("// the instantiation of a launch")]
    assert body.count(SMEM_DECL) == 1
    body = body.replace(SMEM_DECL, "unsigned char* smem = g_dsmem;")
    (out / "dense.cc").write_text(
        '#include "xchg_host.h"\n#define __shared__ static\nstatic unsigned char* g_dsmem;\n'
        + body + "\n}  // namespace\n" + (EMU / "dense_b7.inc").read_text())
    exe = out / "dense"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-pthread", "-w",
         f"-I{out}", "-o", str(exe), str(out / "dense.cc")],
        capture_output=True, text=True)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"g++ cannot build C++20: {build.stderr[:200]}")
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    """The problems, as (nine positional numpy inputs, optional inputs,
    max_nodes), keyed by name; the staged ones at a small size."""
    with testing.one_core():
        kernel = testing.kernel_cases(0, n_pods=300, n_types=12)
        dense = testing.dense_cases(0, n_pods=300, n_types=12, kernel=kernel)
        _, e_args = graft_entry.entry(device="cpu")
    out = {c.name: (c.args, c.kwargs, c.max_nodes) for c in dense}  # names end in the mode
    # a node axis capped below need: the fresh problem on CAPPED_ROWS rows
    fresh = out["fresh-ffd"]
    out["capped-axis"] = (fresh[0], fresh[1], CAPPED_ROWS)
    out["entry"] = (tuple(a.numpy() for a in e_args), {}, graft_entry.MAX_NODES)
    out["signed-zero"] = (testing.signed_zero_problem(), {}, testing.SIGNED_ZERO_ROWS)
    return out


def _np(x, dt):
    return np.ascontiguousarray(np.asarray(x).astype(dt))


def run_dense(exe: Path, name: str, mode: str, threads: int, tmp: Path, budget=None,
              flat=False):
    """The emulated B7 on problem `name` at `threads`: pack's six outputs
    (numpy), or with `flat` pack_flat's buffer. `budget`: the spilled
    kernel's placement under that many bytes of shared memory (it must
    spill)."""
    args, kw, N = _cases()[name]
    compat, req, count, alloc, pool, oh, emask, eused, price = args
    G, C = compat.shape
    R, E, P1 = req.shape[1], emask.shape[0], oh.shape[0]
    cfg_rsv = kw.get("cfg_rsv")
    cfg_rsv = np.full((C,), -1, np.int32) if cfg_rsv is None else cfg_rsv
    rsv_cap = kw.get("rsv_cap")
    rsv_cap = np.zeros((0,), np.float32) if rsv_cap is None else rsv_cap
    quota, gcap, conflict = kw.get("quota"), kw.get("group_cap"), kw.get("conflict")
    K = rsv_cap.shape[0]
    lay = pack_split.table_placement(C, R, P1, K, G, budget=budget)
    assert lay["spilled"] == (budget is not None), (name, budget)
    buf = [struct.pack("14i", G, C, R, E, N, K, P1, 1 if mode == "cost" else 0, threads,
                       quota is not None, gcap is not None, conflict is not None,
                       lay["spilled"], flat)]
    if lay["spilled"]:
        buf.append(struct.pack(f"={len(lay['offsets'])}i2q", *lay["offsets"],
                               lay["scratch"], lay["smem"]))
    inputs = [(compat, np.uint8), (req, np.float32), (count, np.int32), (alloc, np.float32),
              (pool, np.int32), (oh, np.float32), (emask, np.uint8), (eused, np.float32),
              (price, np.float32)]
    inputs += [(quota, np.int16)] if quota is not None else []
    inputs += [(cfg_rsv, np.int32), (rsv_cap, np.float32)]
    inputs += [(gcap, np.int32)] if gcap is not None else []
    inputs += [(conflict, np.uint8)] if conflict is not None else []
    for x, dt in inputs:
        buf.append(_np(x, dt).tobytes())
    path = tmp / f"dense-{name}-{mode}-{threads}-{budget}-{flat}.bin"
    path.write_bytes(b"".join(buf))
    subprocess.run([str(exe), str(path), str(path) + ".out"], check=True, timeout=600)
    raw = np.frombuffer(Path(str(path) + ".out").read_bytes(), np.uint8)
    if flat:
        return raw.view(np.int32)
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = raw[o:o + n * np.dtype(dt).itemsize].view(dt).reshape(shape)
        o += n * np.dtype(dt).itemsize
        return v

    return (take(N * G, np.int32, (N, G)), take(N * C, np.uint8, (N, C)),
            take(N * R, np.float32, (N, R)), take(N, np.uint8, (N,)),
            take(1, np.int32, ()), take(G, np.int32, (G,)))


def _plain(name, mode, flat=False):
    args, kw, N = _cases()[name]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
           for k, v in kw.items()}
    fn = pack_dense.pack_flat_ref if flat else pack_dense.pack_ref
    return fn(*t, max_nodes=N, mode=mode, **tkw)


def _gbits_budget(name):
    """The budget under which the problem's placement spills the compat
    bits alone."""
    args, kw, _ = _cases()[name]
    compat, req, oh = args[0], args[1], args[5]
    rsv_cap = kw.get("rsv_cap")
    K = 0 if rsv_cap is None else rsv_cap.shape[0]
    G, C = compat.shape
    return pack_split.table_placement(C, req.shape[1], oh.shape[0], K, G)["smem"] - 1


# (problem, mode, block size: the one the wrapper takes for the problem's
# node axis, `pack_dense.block_threads`, or the other, placement)
RUNS = [
    ("entry", "ffd", "taken", "shared"),
    ("planned-quota-cost", "cost", "other", "shared"),
    ("planned-quota-ffd", "ffd", "other", "compat bits spilled"),
    ("bound-quota-cap-conflict-ffd", "ffd", "other", "all spilled"),
    ("conflict-ffd", "ffd", "taken", "shared"),
    ("capped-axis", "ffd", "taken", "shared"),
    ("signed-zero", "cost", "taken", "shared"),
]


def _threads(name, which):
    taken = pack_dense.block_threads(_cases()[name][2])
    return taken if which == "taken" else (1024 if taken == 256 else 256)


@pytest.mark.parametrize("name, mode, which, placement", RUNS)
def test_emulated_b7_equals_plain_version(dense_exe, tmp_path, name, mode, which, placement):
    threads = _threads(name, which)
    budget = {"shared": None, "all spilled": 0,
              "compat bits spilled": _gbits_budget(name)}[placement]
    with testing.one_core():
        got = run_dense(dense_exe, name, mode, threads, tmp_path, budget)
        want = _plain(name, mode)
    for label, a, b in zip(OUTPUTS, got, want):
        b = b.numpy()
        b = b.astype(np.uint8) if b.dtype == np.bool_ else b
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (name, mode, threads, label)
    if name == "capped-axis":
        # every row opened, pods left over
        assert int(got[4]) == CAPPED_ROWS and int(got[5].sum()) > 0
    if name == "signed-zero":
        # the usage pass turned every -0.0 of the rows that took nothing
        # into +0.0, as the JAX body's used + 0 * req does
        assert not np.signbit(got[2][[0, 2]]).any()


# negative, zero and 2^31-scale demand on a node axis too small for it;
# the signed-zero problem
@pytest.mark.parametrize("name, mode", [("demand-ffd", "ffd"), ("signed-zero", "cost")])
def test_emulated_b7_in_place_equals_plain_flat_buffer(dense_exe, tmp_path, name, mode):
    with testing.one_core():
        got = run_dense(dense_exe, name, mode, _threads(name, "taken"), tmp_path, flat=True)
        want = _plain(name, mode, flat=True)
    assert got.shape == tuple(want.shape) and got.tobytes() == want.numpy().tobytes(), name
