"""The port's streaming staging (`solver/stream.py`) against the JAX
package's, on the CPU.

The fill callbacks give the JAX module's blocks for the same index
tuples; `stage` gives, per shard, the values of the JAX `stage`'s
per-device blocks on the 8 virtual CPU devices tests/conftest.py pins;
`last_stats()` after a sharded solve equals the JAX module's after the
same solve; streaming and classic staging give identical solves, and
blocks that are each their own allocation.

Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.solver import stream as jstream
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu.solver.pack import solve_packing as jsolve_packing
from karpenter_tpu_torch.solver import pack, stream
from karpenter_tpu_torch.solver.encode import encoded_from_arrays
from karpenter_tpu_torch.utils.platform import force_virtual_mesh
from karpenter_tpu_torch import testing as _testing


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (the JAX package's wall-clock tests
    among them; see test_torch_provisioning.py)."""
    with _testing.one_core():
        yield

ARRAYS = ("compat", "group_req", "group_count", "cfg_alloc", "cfg_price",
          "cfg_pool", "pool_overhead", "existing_used", "cfg_rsv", "rsv_cap",
          "group_cap", "conflict", "existing_quota")


@pytest.fixture(autouse=True, scope="module")
def _mesh_and_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    force_virtual_mesh(8)
    yield
    force_virtual_mesh(0)
    torch.set_num_threads(n)


def _src(seed=0, G=37, C=70, R=4):
    rng = np.random.default_rng(seed)
    return (rng.random((G, C)) < 0.4, rng.random((C, R)).astype(np.float32),
            rng.integers(-1, 5, size=C).astype(np.int32))


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_fill_callbacks_equal_the_jax_module(S):
    compat, alloc, pool = _src(S)
    G, C = compat.shape
    Gp, Cp = 48, 96 * 8
    for idx in stream.shard_index((Gp, Cp), 1, S):
        np.testing.assert_array_equal(
            stream.col_fill_2d(compat, Gp, G, C, np.bool_)(idx),
            jstream.col_fill_2d(compat, Gp, G, C, np.bool_)(idx))
    for idx in stream.shard_index((Cp, 4), 0, S):
        np.testing.assert_array_equal(
            stream.row_fill_2d(alloc, 4, C, np.float32)(idx),
            jstream.row_fill_2d(alloc, 4, C, np.float32)(idx))
    for idx in stream.shard_index((Cp,), 0, S):
        np.testing.assert_array_equal(
            stream.vec_fill(pool, C, np.int32, pad_value=-1)(idx),
            jstream.vec_fill(pool, C, np.int32, pad_value=-1)(idx))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_stage_blocks_equal_the_jax_stage(S):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    compat, alloc, _ = _src(10 + S)
    G, C = compat.shape
    Gp, Cp = 48, 96
    mesh = Mesh(np.array(jax.devices()[:S]), ("cfg",))
    jst, st = jstream._Staging(), stream._Staging()
    theirs = jstream.stage(mesh, P(None, "cfg"), (Gp, Cp), np.bool_,
                           jstream.col_fill_2d(compat, Gp, G, C, np.bool_), jst)
    ours = stream.stage(["cpu"] * S, 1, (Gp, Cp), np.bool_,
                        stream.col_fill_2d(compat, Gp, G, C, np.bool_), st)
    by_col = sorted(theirs.addressable_shards, key=lambda sh: sh.index[1].start or 0)
    assert len(ours) == S == len(by_col)
    for blk, sh in zip(ours, by_col):
        np.testing.assert_array_equal(blk.numpy(), np.asarray(sh.data))
    assert vars(st) == vars(jst)
    # each block is its own allocation
    assert len({b.data_ptr() for b in ours}) == S


def _encs(n_pods, n_types, seed, reservations=False):
    pods, pools = bench.build_problem(n_pods, n_types, seed=seed, reservations=reservations)
    jenc = jencode(jgroup_pods(pods), pools)
    d = {k: (None if getattr(jenc, k) is None else np.asarray(getattr(jenc, k)))
         for k in ARRAYS}
    return encoded_from_arrays(d), jenc


def test_last_stats_equal_the_jax_module_for_the_same_solve():
    """One JAX sharded solve (on 4 of the 8 CPU devices), with
    reservations, so cfg_rsv is streamed with real slots."""
    enc, jenc = _encs(300, 20, seed=19, reservations=True)
    jstream.reset_stats()
    want = jsolve_packing(jenc, mode="ffd", shards=4)
    stream.reset_stats()
    got = pack.solve_packing(enc, mode="ffd", device="cpu", shards=4)
    assert stream.last_stats() == jstream.last_stats()
    assert stream.last_stats()["peak_block_bytes"] * 4 <= stream.last_stats()["full_bytes"]
    n = got.node_count
    assert n == want.node_count and np.array_equal(got.assign[:n], want.assign[:n])


@pytest.mark.parametrize("mode", ["ffd", "cost"])
def test_streaming_and_classic_staging_agree(monkeypatch, mode):
    enc, _ = _encs(400, 24, seed=29, reservations=True)
    monkeypatch.setenv("KARPENTER_STREAM_ENCODE", "1")
    assert stream.enabled()
    streamed = pack.solve_packing(enc, mode=mode, device="cpu", shards=4)
    monkeypatch.setenv("KARPENTER_STREAM_ENCODE", "off")
    assert not stream.enabled()
    classic = pack.solve_packing(enc, mode=mode, device="cpu", shards=4)
    n = streamed.node_count
    assert n == classic.node_count
    assert np.array_equal(streamed.assign[:n], classic.assign[:n])
    assert np.array_equal(streamed.node_mask[:n], classic.node_mask[:n])


def test_staged_blocks_equal_a_split_of_the_padded_matrices(monkeypatch):
    enc, _ = _encs(400, 30, seed=3, reservations=True)
    mesh = pack.Mesh(devices=(torch.device("cpu"),) * 4, virtual=True)
    staged = pack.stage(enc, np.zeros((0, enc.compat.shape[1]), bool),
                        enc.existing_used, 256, shards=4)
    s_args, s_kw = pack.to_mesh(staged, enc, mesh, stream=True)
    c_args, c_kw = pack.to_mesh(staged, enc, mesh, stream=False)
    for i in (0, 3, 4, 11):
        for a, b in zip(s_args[i], c_args[i]):
            assert torch.equal(a, b)
    for a, b in zip(s_kw["cfg_rsv"], c_kw["cfg_rsv"]):
        assert torch.equal(a, b)
