"""The port's encode and solve against the JAX package's, on CPU.

(b) `karpenter_tpu_torch.solver.encode.encode` on the port's
`workloads.build_problem` against `karpenter_tpu.solver.encode.encode`
on `bench.build_problem` at the same seed: every array equal.
(c) `solve(..., device="cpu")` (the plain versions of the kernels)
against the JAX `solve`: identical solution fingerprints — per new node
its pool, primary type and offering, price, sorted pod names and
reservation; per existing node its pods; the unschedulable names.

Tolerance: exact equality throughout.
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
from karpenter_tpu.solver.encode import (
    ExistingNodeInput as JExisting,
    encode as jencode,
    group_pods as jgroup_pods,
)
from karpenter_tpu.solver.solver import solve as jsolve
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.solver.encode import ExistingNodeInput, encode, group_pods
from karpenter_tpu_torch.solver.solver import fingerprint, solve
from karpenter_tpu_torch.workloads import build_problem
from karpenter_tpu_torch import testing as _testing


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (the JAX package's wall-clock tests
    among them; see test_torch_provisioning.py)."""
    with _testing.one_core():
        yield

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensors; one intra-op thread keeps
    them from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARRAYS = ("compat", "group_req", "group_count", "group_priority", "cfg_alloc",
          "cfg_price", "cfg_pool", "pool_overhead", "existing_used", "cfg_rsv",
          "rsv_cap", "loose_groups", "pool_min_values", "conflict",
          "group_cap", "existing_quota")


def _existing(n, seed, cls, reqs_cls):
    """n existing nodes: labelled like launched instances, with some
    of their allocatable already used."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cpu = float(rng.choice([4, 8, 16]))
        labels = {
            "kubernetes.io/arch": str(rng.choice(["amd64", "arm64"])),
            "topology.kubernetes.io/zone": str(rng.choice(
                ["test-zone-1", "test-zone-2", "test-zone-3"])),
            "karpenter.sh/nodepool": "default",
        }
        out.append(cls(
            name=f"node-{i}",
            requirements=reqs_cls.from_labels(labels),
            taints=(),
            available={"cpu": cpu * float(rng.uniform(0.2, 1.0)),
                       "memory": cpu * 2**31 * float(rng.uniform(0.2, 1.0)),
                       "pods": 50.0},
            pool_name="default",
        ))
    return out


def _both(n_pods, n_types, seed, reservations=False, n_existing=0):
    pods, pools = build_problem(n_pods, n_types, seed=seed,
                                reservations=reservations)
    jpods, jpools = bench.build_problem(n_pods, n_types, seed=seed,
                                        reservations=reservations)
    ex = _existing(n_existing, seed, ExistingNodeInput, Requirements)
    jex = _existing(n_existing, seed, JExisting, JRequirements)
    return (pods, pools, ex), (jpods, jpools, jex)


class TestEncode:
    @pytest.mark.parametrize("n_pods,n_types,seed,reservations,n_existing", [
        (800, 30, 42, False, 0),
        (1200, 50, 7, True, 0),
        (600, 25, 3, False, 12),
    ])
    def test_every_array_equal(self, n_pods, n_types, seed, reservations,
                               n_existing):
        (pods, pools, ex), (jpods, jpools, jex) = _both(
            n_pods, n_types, seed, reservations, n_existing)
        overhead = {"default": {"cpu": 0.1, "memory": 2**27}}
        enc = encode(group_pods(pods), pools, ex, overhead)
        jenc = jencode(jgroup_pods(jpods), jpools, jex, overhead)
        assert enc.resource_keys == jenc.resource_keys
        assert enc.n_existing == jenc.n_existing
        for name in ARRAYS:
            a, b = getattr(enc, name), getattr(jenc, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert [
            (c.existing_index,
             c.instance_type.name if c.instance_type else "",
             (c.offering.capacity_type, c.offering.zone) if c.offering else None)
            for c in enc.configs
        ] == [
            (c.existing_index,
             c.instance_type.name if c.instance_type else "",
             (c.offering.capacity_type, c.offering.zone) if c.offering else None)
            for c in jenc.configs
        ]
        assert [[p.metadata.name for p in g.pods] for g in enc.groups] == [
            [p.metadata.name for p in g.pods] for g in jenc.groups]


class TestSolve:
    @pytest.mark.parametrize("n_pods,n_types,seed,reservations,n_existing", [
        (300, 20, 1, False, 0),
        (2000, 50, 42, False, 0),
        (1000, 40, 5, False, 16),
        (1500, 40, 9, True, 0),
        (800, 30, 11, True, 8),
    ])
    def test_fingerprint_equal(self, n_pods, n_types, seed, reservations,
                               n_existing):
        (pods, pools, ex), (jpods, jpools, jex) = _both(
            n_pods, n_types, seed, reservations, n_existing)
        ours = solve(pods, pools, ex, device="cpu")
        theirs = jsolve(jpods, jpools, jex)
        assert fingerprint(ours) == fingerprint(theirs)
        assert len(ours.new_nodes) > 0
        placed = sum(len(n.pods) for n in ours.new_nodes) + sum(
            len(e.pods) for e in ours.existing)
        assert placed + len(ours.unschedulable) == n_pods
        if n_existing:
            assert ours.existing, "the bound block placed nothing"


class TestEntryPoint:
    def test_cost_objective_names_its_roadmap_item(self):
        # the cost objective (ROADMAP queue A item 4) is served now
        pods, pools = build_problem(10, 4, seed=0)
        cost = solve(pods, pools, objective="cost", device="cpu")
        ffd = solve(pods, pools, device="cpu")
        assert cost.lp is not None and "lower_bound" in cost.lp
        assert cost.total_price <= ffd.total_price + 1e-6
        assert len(cost.unschedulable) <= len(ffd.unschedulable)

    def test_host_backend_names_its_roadmap_item(self):
        # the host backend (ROADMAP queue A item 4) is served now: the
        # host FFD oracle, equal to the JAX package's host backend
        pods, pools = build_problem(10, 4, seed=0)
        jpods, jpools = bench.build_problem(10, 4, seed=0)
        host = solve(pods, pools, backend="host", device="cpu")
        assert fingerprint(host) == fingerprint(jsolve(jpods, jpools, backend="host"))
        placed = sum(len(n.pods) for n in host.new_nodes)
        assert placed + len(host.unschedulable) == 10
