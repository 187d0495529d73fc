"""The port's split solve (B8) against the JAX package's solve, on the
CPU.

The cases of tests/test_sharded_solver.py, on the port: the config axis
split over a virtual mesh of S shard slots (`force_virtual_mesh(8)`,
the counterpart of the 8 virtual CPU devices tests/conftest.py pins for
the JAX package), the split kernels' plain versions doing the work.
Each is held with `same_solution` (used-row PackResult equality) to the
JAX package's UNSHARDED `solve_packing` on the same encode — whose own
tests hold it equal to its sharded solve — and two (one ffd, one cost)
to the JAX package's sharded solve directly. The facade and the
existing-node cases compare solution fingerprints with the JAX
`solve`. Sizes are test_sharded_solver.py's.

Also: too many shards raises; a mesh over several real cards raises
(the launch over cards is ROADMAP item 10); the
KARPENTER_SOLVER_SHARDS default, its fallback to the unsharded solve,
and the record of the last resolution; `graft_entry.dryrun_multichip`
on the CPU at 2000 pods x 60 types (its full 10k x 200 takes ~40 CPU
seconds here, which the card runs in chip_smoke.py).

Tolerance: exact equality throughout.
"""

import numpy as np
import pytest
import torch

import bench
from conftest import same_solution
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu.solver.pack import solve_packing as jsolve_packing
from karpenter_tpu.solver.solver import solve as jsolve
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import pack, stream
from karpenter_tpu_torch.solver.encode import encode, encoded_from_arrays, group_pods
from karpenter_tpu_torch.solver.solver import fingerprint, solve
from karpenter_tpu_torch.utils.platform import force_virtual_mesh, virtual_mesh
from karpenter_tpu_torch.workloads import build_problem

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


def _encs(n_pods, n_types, seed=3, hetero=False):
    """(the port's Encoded of the JAX encode's arrays, the JAX Encoded)."""
    pods, pools = bench.build_problem(n_pods, n_types, seed=seed)
    if hetero:
        from karpenter_tpu.cloudprovider.fake import heterogeneous_instance_types

        pools = [(pools[0][0], heterogeneous_instance_types(n_types))]
    jenc = jencode(jgroup_pods(pods), pools)
    d = {k: (None if getattr(jenc, k) is None else np.asarray(getattr(jenc, k)))
         for k in ARRAYS}
    return encoded_from_arrays(d), jenc


def _port(enc, mode, shards, plan=None):
    return pack.solve_packing(enc, mode=mode, plan=plan, device="cpu", shards=shards)


def test_sharded_matches_unsharded_at_scale():
    enc, jenc = _encs(5000, 200)
    assert same_solution(_port(enc, "ffd", 8), jsolve_packing(jenc, mode="ffd"))


def test_sharded_cost_mode_matches():
    enc, jenc = _encs(1200, 64, seed=11)
    assert same_solution(_port(enc, "cost", 8), jsolve_packing(jenc, mode="cost"))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_two_four_and_eight_way_shardings_match(S):
    enc, jenc = _encs(800, 48, seed=5)
    assert same_solution(_port(enc, "ffd", S), jsolve_packing(jenc, mode="ffd"))


def test_ffd_matches_the_jax_sharded_solve():
    enc, jenc = _encs(800, 48, seed=5)
    assert same_solution(_port(enc, "ffd", 4), jsolve_packing(jenc, mode="ffd", shards=4))


@pytest.mark.parametrize("S", [3, 5, 7])
def test_odd_shard_counts_match(S):
    enc, jenc = _encs(700, 40, seed=19)
    assert same_solution(_port(enc, "ffd", S), jsolve_packing(jenc, mode="ffd"))


@pytest.mark.parametrize("S", [3, 5])
def test_odd_shards_cost_mode_match(S):
    enc, jenc = _encs(600, 40, seed=29)
    assert same_solution(_port(enc, "cost", S), jsolve_packing(jenc, mode="cost"))


def test_cost_matches_the_jax_sharded_solve():
    enc, jenc = _encs(600, 40, seed=29)
    assert same_solution(_port(enc, "cost", 5),
                         jsolve_packing(jenc, mode="cost", shards=5))


def test_solve_facade_shards():
    pods, pools = build_problem(600, 32, seed=9)
    jpods, jpools = bench.build_problem(600, 32, seed=9)
    assert fingerprint(solve(pods, pools, device="cpu", shards=8)) == fingerprint(
        jsolve(jpods, jpools))


def _existing(pools, cls, reqs_cls, labels_mod):
    types = pools[0][1]
    out = []
    for i, it in enumerate(types[:6]):
        labels = {
            labels_mod.NODEPOOL_LABEL: pools[0][0].metadata.name,
            labels_mod.INSTANCE_TYPE_LABEL: it.name,
            labels_mod.TOPOLOGY_ZONE_LABEL: "test-zone-1",
            labels_mod.CAPACITY_TYPE_LABEL: "on-demand",
        }
        out.append(cls(name=f"live-{i}", requirements=reqs_cls.from_labels(labels),
                       taints=(), available=dict(it.allocatable),
                       pool_name=pools[0][0].metadata.name, pod_count=0))
    return out


def test_sharded_with_existing_nodes_matches():
    from karpenter_tpu.apis.v1 import labels as jlabels
    from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
    from karpenter_tpu.solver.encode import ExistingNodeInput as JExisting
    from karpenter_tpu_torch.apis.v1 import labels
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    from karpenter_tpu_torch.solver.encode import ExistingNodeInput

    pods, pools = build_problem(900, 48, seed=13)
    jpods, jpools = bench.build_problem(900, 48, seed=13)
    ours = solve(pods, pools, existing=_existing(pools, ExistingNodeInput, Requirements, labels),
                 device="cpu", shards=8)
    theirs = jsolve(jpods, jpools, existing=_existing(jpools, JExisting, JRequirements, jlabels))
    assert len(ours.existing) > 0
    assert fingerprint(ours) == fingerprint(theirs)


def test_sharded_lp_planned_cost_solve_matches():
    from karpenter_tpu.solver import lp_plan as jlp_plan

    enc, jenc = _encs(1500, 60, seed=21, hetero=True)
    with testing.root_node_mips():
        plan = jlp_plan.plan(jenc)
    assert plan is not None and len(plan.planned_cols) > 0
    assert same_solution(_port(enc, "cost", 8, plan=plan),
                         jsolve_packing(jenc, mode="cost", plan=plan))


def test_too_many_shards_raises():
    with pytest.raises(ValueError):
        pack._mesh(512, "cpu")
    enc, _ = _encs(300, 16)
    with pytest.raises(ValueError):
        _port(enc, "ffd", 16)


def test_a_mesh_over_several_real_cards_raises(monkeypatch):
    """Without a virtual mesh the visible devices are the real ones; a
    split over several real cards is the launch ROADMAP item 10 adds,
    and until then it raises instead of running on one card."""
    force_virtual_mesh(0)
    try:
        with pytest.raises(ValueError):
            pack._mesh(2, "cpu")
        monkeypatch.setattr(pack, "real_devices", lambda device=None: 4)
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            pack._mesh(4, "cuda")
    finally:
        force_virtual_mesh(8)


def test_env_default_and_its_fallback(monkeypatch, caplog):
    monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "4")
    assert pack.default_shards() == 4
    enc, jenc = _encs(400, 24, seed=7)
    want = jsolve_packing(jenc, mode="ffd")
    assert same_solution(_port(enc, "ffd", 0), want)
    assert pack.last_resolved_shards() == {"effective": 4, "devices": 8}
    # more than the visible shard slots: a warning and the unsharded solve
    monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "16")
    with caplog.at_level("WARNING", logger="karpenter.solver"):
        assert same_solution(_port(enc, "ffd", 0), want)
    assert "exceeds 8 visible devices" in caplog.text
    assert pack.last_resolved_shards()["effective"] == 1
    monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "bogus")
    assert pack.default_shards() == 0
    monkeypatch.delenv("KARPENTER_SOLVER_SHARDS")
    assert pack.default_shards() == 0


def test_classic_and_streamed_staging_agree(monkeypatch):
    enc, _ = _encs(600, 40, seed=29)
    stream.reset_stats()
    streamed = _port(enc, "ffd", 4)
    assert stream.last_stats()["blocks"] == 5 * 4
    monkeypatch.setenv("KARPENTER_STREAM_ENCODE", "0")
    stream.reset_stats()
    classic = _port(enc, "ffd", 4)
    assert stream.last_stats() == {}
    assert same_solution(streamed, classic)


def test_dryrun_multichip_on_the_cpu():
    from karpenter_tpu_torch.graft_entry import dryrun_multichip

    with testing.root_node_mips():
        out = dryrun_multichip(4, device="cpu", n_pods=2000, n_types=60)
    assert out["shards"] == 4 and out["unschedulable"] == 0 and out["planned_rows"] > 0
    # the caller's mesh (the module's 8 slots) is back
    assert virtual_mesh() == 8
