"""The port's whole cost solve against the JAX package's, on the CPU,
on the fixtures of `tests/test_cost_objective.py`: the family-priced
catalog (2000 pods x 80 types) and `build_problem(1200, 60)` at seeds
1, 2 and 3 (the reservations fixture is in `tests/test_torch_cost.py`).

Each side runs its own column generation (the port's with the plain
version of B4) and its own dual ascent (the port's with the plain
version of B5). Tolerance: equal solution fingerprints, fleet prices
and host bounds; the device LP's bound within 1e-4 relative (float32
duals summed in another order than XLA's). Column generation's
wall-clock budget and its MIPs' time limits are replaced by fixed work
in both packages alike (see `tests/test_torch_cost.py`).
"""

import pytest
import torch

import bench
from karpenter_tpu.cloudprovider.fake import (
    heterogeneous_instance_types as jheterogeneous_instance_types,
)
from karpenter_tpu_torch.cloudprovider.fake import heterogeneous_instance_types
from karpenter_tpu_torch.workloads import build_problem

from test_torch_cost import assert_same_cost_solve, clean  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cost_solve_hetero_catalog(clean):  # noqa: F811
    pods, pools = build_problem(2000, 80, seed=5)
    jpods, jpools = bench.build_problem(2000, 80, seed=5)
    pools = [(pools[0][0], heterogeneous_instance_types(80))]
    jpools = [(jpools[0][0], jheterogeneous_instance_types(80))]
    ours = assert_same_cost_solve(pods, pools, jpods, jpools)
    assert ours.lp["guided"] and not ours.unschedulable


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cost_solve_linear_catalog(clean, seed):  # noqa: F811
    pods, pools = build_problem(1200, 60, seed=seed)
    jpods, jpools = bench.build_problem(1200, 60, seed=seed)
    assert_same_cost_solve(pods, pools, jpods, jpools)
