"""The host FFD oracle and the host backend against the JAX package's.

(a) `reference_ffd.solve_ffd_host` returns the same nodes (mask, used,
    assignment, quota) and the same unschedulable counts as the JAX
    package's on the same encoded problem: plain, with capacity
    reservations, with existing nodes carrying per-group quotas and
    group caps and conflicts, with conflicts and group caps alone, and
    with the demand edges of `tests/test_scale_dtypes.py` (a negative
    and a zero count).
(b) `resilience.host_pack_result` and `solve(..., backend="host")`
    give the same results in both packages, and equal each other, as
    `tests/test_resilience.py::TestHostOracleParity` holds in the JAX
    package; KARPENTER_SOLVER_BACKEND=host selects the same backend.

Inputs are made from a seed with numpy. Tolerance: exact equality.
"""

from dataclasses import replace

import numpy as np
import pytest

import bench
from karpenter_tpu.solver import resilience as jresilience
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu.solver.reference_ffd import solve_ffd_host as jsolve_ffd_host
from karpenter_tpu.solver.solver import _build_solution_arrays as jbuild
from karpenter_tpu.solver.solver import solve as jsolve
from karpenter_tpu_torch.solver import resilience
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.reference_ffd import solve_ffd_host
from karpenter_tpu_torch.solver.solver import (
    _build_solution_arrays,
    _decode_host,
    fingerprint,
    solve,
)
from karpenter_tpu_torch.testing import one_core
from karpenter_tpu_torch.workloads import build_problem
from test_torch_solve import _both

OVERHEAD = {"default": {"cpu": 0.1, "memory": 2**27}}


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """One core for these comparisons: the suite's other workers keep
    theirs."""
    with one_core():
        yield


def _encodes(kind: str, seed: int):
    """The same encoded problem in both packages: (port, jax)."""
    rng = np.random.default_rng(seed)
    if kind == "plain":
        (pods, pools, _), (jpods, jpools, _) = _both(240, 12, seed)
        return encode(group_pods(pods), pools), jencode(jgroup_pods(jpods), jpools)
    if kind == "reservations":
        (pods, pools, _), (jpods, jpools, _) = _both(240, 12, seed, reservations=True)
        return encode(group_pods(pods), pools), jencode(jgroup_pods(jpods), jpools)
    if kind == "existing-quota-cap-conflict":
        (pods, pools, ex), (jpods, jpools, jex) = _both(200, 12, seed, n_existing=10)
        groups, jgroups = group_pods(pods), jgroup_pods(jpods)
        G = len(groups)
        cap = rng.integers(1, 8, size=G).astype(np.int32)
        quota = rng.integers(0, 6, size=(len(ex), G)).astype(np.int32)
        conflict = rng.random((G, G)) < 0.08
        conflict = conflict | conflict.T
        np.fill_diagonal(conflict, False)
        kw = dict(group_cap=cap, conflict=conflict, existing_quota=quota)
        return (encode(groups, pools, ex, OVERHEAD, **kw),
                jencode(jgroups, jpools, jex, OVERHEAD, **kw))
    if kind == "conflict-cap":
        (pods, pools, _), (jpods, jpools, _) = _both(240, 12, seed)
        enc, jenc = encode(group_pods(pods), pools), jencode(jgroup_pods(jpods), jpools)
        G = enc.compat.shape[0]
        conflict = rng.random((G, G)) < 0.15
        conflict = conflict | conflict.T
        np.fill_diagonal(conflict, False)
        cap = rng.integers(2, 12, size=G).astype(np.int32)
        return (replace(enc, conflict=conflict, group_cap=cap),
                replace(jenc, conflict=conflict, group_cap=cap))
    if kind == "demand-edges":
        (pods, pools, _), (jpods, jpools, _) = _both(240, 12, seed)
        enc, jenc = encode(group_pods(pods), pools), jencode(jgroup_pods(jpods), jpools)
        counts = enc.group_count.copy()
        counts[0], counts[1] = -7, 0
        return replace(enc, group_count=counts), replace(jenc, group_count=counts.copy())
    raise ValueError(kind)


KINDS = ("plain", "reservations", "existing-quota-cap-conflict", "conflict-cap",
         "demand-edges")


def _nodes(nodes):
    return [(n.mask.tobytes(), np.asarray(n.used).dtype.str, np.asarray(n.used).tobytes(),
             sorted(n.assign.items()),
             None if n.quota is None else np.asarray(n.quota).tobytes())
            for n in nodes]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_ffd_host_equals_jax(kind, seed):
    enc, jenc = _encodes(kind, seed)
    nodes, unsched = solve_ffd_host(enc)
    jnodes, junsched = jsolve_ffd_host(jenc)
    assert nodes, "the oracle opened no node"
    assert _nodes(nodes) == _nodes(jnodes)
    assert unsched == junsched


def _pack_equal(a, b) -> bool:
    return (a.node_count == b.node_count
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("assign", "node_mask", "node_used", "node_active",
                              "unschedulable"))
            and all(getattr(a, f).dtype == getattr(b, f).dtype
                    for f in ("assign", "node_mask", "node_used", "node_active",
                              "unschedulable")))


@pytest.mark.parametrize("kind", KINDS)
def test_host_pack_result_equals_jax(kind):
    enc, jenc = _encodes(kind, 3)
    assert _pack_equal(resilience.host_pack_result(enc), jresilience.host_pack_result(jenc))


@pytest.mark.parametrize("kind", KINDS)
def test_host_pack_result_matches_backend_host_decode(kind):
    """The ladder's host rung and the host backend are one oracle, in
    both packages: the decoded host rung equals `_decode_host`, and the
    port's decode equals the JAX package's."""
    enc, jenc = _encodes(kind, 4)
    res = resilience.host_pack_result(enc)
    via_ladder = _build_solution_arrays(
        enc, np.flatnonzero(res.node_active[: res.node_count]), res.node_mask,
        res.assign, res.unschedulable)
    jres = jresilience.host_pack_result(jenc)
    jvia_ladder = jbuild(
        jenc, np.flatnonzero(jres.node_active[: jres.node_count]), jres.node_mask,
        jres.assign, jres.unschedulable)
    host = _decode_host(enc)
    assert fingerprint(via_ladder) == fingerprint(host)
    assert fingerprint(host) == fingerprint(jvia_ladder)


@pytest.mark.parametrize("n_pods,n_types,seed", [(150, 8, 2), (300, 16, 9)])
def test_backend_host_equals_jax(n_pods, n_types, seed, monkeypatch):
    pods, pools = build_problem(n_pods, n_types, seed=seed)
    jpods, jpools = bench.build_problem(n_pods, n_types, seed=seed)
    want = fingerprint(jsolve(jpods, jpools, backend="host"))
    # the host backend runs no device: device=None is not resolved
    assert fingerprint(solve(pods, pools, backend="host")) == want
    monkeypatch.setenv("KARPENTER_SOLVER_BACKEND", "host")
    assert fingerprint(solve(pods, pools)) == want
    # the cost objective on the host backend is the host oracle too
    assert fingerprint(solve(pods, pools, objective="cost")) == want


def test_unknown_backend_raises():
    pods, pools = build_problem(10, 4, seed=0)
    with pytest.raises(ValueError, match="unknown backend"):
        solve(pods, pools, backend="tpu", device="cpu")
