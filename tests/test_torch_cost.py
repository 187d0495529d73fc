"""The cost objective of the port against the JAX package's, on the CPU.

(a) The planned pack: `pack.solve_packing(enc, mode="cost", plan=...)`
    with the JAX package's plan carried across (`plan_from_arrays`)
    gives the same PackResult as the JAX `solve_packing(plan=...)`:
    assign, node masks, node count, usage, unschedulable; sequential
    and (forced) wavefront routes, with reservations and existing
    nodes, so the bound block holds existing and planned rows.
(b) The race: with the JAX plan and duals carried across
    (`plan_from_arrays`, `device_lp_from_arrays`), the port's
    `_decode_device(objective="cost")` gives the JAX package's solution
    fingerprint and `Solution.lp`, cold and on the warm (steady-state
    skip) path. That covers the winning arm, the merge and the trim.
(c) The whole cost solve with the port's own plan and duals, on the
    reservations fixture of `tests/test_cost_objective.py`: equal
    fingerprints, equal host bounds, the device bound within 1e-4
    relative (float32 duals; the plain B5 sums in another order than
    XLA). The other fixtures of that file are in
    `tests/test_torch_cost_solve.py`.
(d) No fallback: without CUDA, `device=None` raises; an error of B4 or
    B5 propagates out of `plan`, `maybe_solve` and `solve`.

Column generation stops on a wall-clock budget (`_TIME_BUDGET_S`) and
its HiGHS MIPs (the integer covering, the knapsack bounds) on
wall-clock limits, so on a loaded machine two runs of the same plan
can differ. These tests lift the budget and stop every MIP after its
root node instead (`testing.root_node_mips`), in both packages alike:
the same work every run, so any difference is the code's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import pack as jpack
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu_torch.metrics.store import SOLVER_LP_SOLVES
from karpenter_tpu_torch.solver import lp_device, lp_plan, pack, solver
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.solver import fingerprint
from karpenter_tpu_torch.testing import root_node_mips
from karpenter_tpu_torch.workloads import build_problem

from test_torch_solve import _existing
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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clear_caches():
    """Both packages' race floors, winning arms, plans, warm patterns
    and dual caches."""
    jsolver._ffd_floor.clear()
    jsolver._warm_arm.clear()
    jsolver._plan_cache.clear()
    jlp_plan._warm_patterns.clear()
    jlp_device.reset()
    solver.reset_caches()


@pytest.fixture
def clean(monkeypatch):
    clear_caches()
    monkeypatch.setattr(jlp_plan, "_TIME_BUDGET_S", 1e6)
    monkeypatch.setattr(lp_plan, "_TIME_BUDGET_S", 1e6)
    with root_node_mips():
        yield
    clear_caches()


def encodes(n_pods, n_types, seed, reservations=False, n_existing=0):
    pods, pools = build_problem(n_pods, n_types, seed=seed,
                                reservations=reservations)
    jpods, jpools = bench.build_problem(n_pods, n_types, seed=seed,
                                        reservations=reservations)
    from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
    from karpenter_tpu.solver.encode import ExistingNodeInput as JExisting
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    from karpenter_tpu_torch.solver.encode import ExistingNodeInput

    ex = _existing(n_existing, seed, ExistingNodeInput, Requirements)
    jex = _existing(n_existing, seed, JExisting, JRequirements)
    return encode(group_pods(pods), pools, ex), jencode(jgroup_pods(jpods), jpools, jex)


def carried_plan(jplan):
    return lp_plan.plan_from_arrays(dataclasses.asdict(jplan))


def carried_dlp(jdlp):
    return lp_device.device_lp_from_arrays(dataclasses.asdict(jdlp))


def assert_same_pack(res, jres):
    assert res.node_count == jres.node_count
    n = res.node_count
    np.testing.assert_array_equal(res.assign[:n], jres.assign[:n])
    np.testing.assert_array_equal(res.node_mask[:n], jres.node_mask[:n])
    np.testing.assert_array_equal(res.node_active[:n], jres.node_active[:n])
    np.testing.assert_array_equal(res.node_used[:n], jres.node_used[:n])
    np.testing.assert_array_equal(res.unschedulable, jres.unschedulable)


@pytest.mark.parametrize("route", ["sequential", "force"])
@pytest.mark.parametrize("reservations,n_existing", [(True, 0), (True, 10), (False, 6)])
def test_planned_pack_equals_jax(clean, monkeypatch, route, reservations, n_existing):
    monkeypatch.setenv("KARPENTER_WAVEFRONT", "0" if route == "sequential" else "force")
    enc, jenc = encodes(1000, 40, 7, reservations, n_existing)
    jplan = jlp_plan.plan(jenc)
    assert jplan is not None and len(jplan.planned_cols) > 0
    plan = carried_plan(jplan)
    jres = jpack.solve_packing(jenc, mode="cost", plan=jplan)
    res = pack.solve_packing(enc, mode="cost", plan=plan, device="cpu")
    assert_same_pack(res, jres)
    # the planned rows hold pods and sit after the existing rows
    E, Np = enc.n_existing, len(plan.planned_cols)
    assert res.assign[E:E + Np].sum() > 0
    if route == "force":
        assert res.wavefront_widths is not None
    if reservations:
        assert (enc.cfg_rsv[plan.planned_cols] >= 0).any()


@pytest.mark.parametrize("n_pods,n_types,seed,reservations", [
    (1200, 60, 2, False),
    (1500, 80, 3, True),
])
def test_race_with_carried_plan_and_duals(clean, monkeypatch, n_pods, n_types,
                                          seed, reservations):
    enc, jenc = encodes(n_pods, n_types, seed, reservations)
    jplan = jlp_plan.plan(jenc)
    jdlp = jlp_device.solve(jenc)
    assert jplan is not None and jdlp is not None
    plan, dlp = carried_plan(jplan), carried_dlp(jdlp)
    monkeypatch.setattr(jlp_plan, "plan", lambda e, **k: jplan)
    monkeypatch.setattr(jlp_device, "maybe_solve", lambda e, **k: jdlp)
    monkeypatch.setattr(lp_plan, "plan", lambda e, **k: plan)
    monkeypatch.setattr(lp_device, "maybe_solve", lambda e, **k: dlp)
    for _ in ("cold", "warm"):
        theirs = jsolver._decode_device(jenc, "cost")
        ours = solver._decode_device(enc, "cost", torch.device("cpu"))
        assert fingerprint(ours) == fingerprint(theirs)
        assert ours.lp == theirs.lp
    assert ours.lp["guided"]
    key = solver._race_fingerprint(enc)
    assert key == jsolver._race_fingerprint(jenc)
    assert solver._warm_arm[key] == jsolver._warm_arm[key]
    assert solver._ffd_floor[key] == jsolver._ffd_floor[key]


def assert_same_cost_solve(pods, pools, jpods, jpools):
    theirs = jsolver.solve(jpods, jpools, objective="cost")
    ours = solver.solve(pods, pools, objective="cost", device="cpu")
    assert fingerprint(ours) == fingerprint(theirs)
    assert ours.total_price == theirs.total_price
    for k in ("guided", "trim_saved", "lower_bound", "estimate",
              "device_iterations"):
        assert ours.lp[k] == theirs.lp[k], k
    assert ours.lp["device_bound"] == pytest.approx(theirs.lp["device_bound"], rel=1e-4)
    assert ours.lp["lower_bound"] <= ours.total_price + 1e-6
    return ours


def test_cost_solve_reserved_fixture(clean):
    pods, pools = build_problem(2000, 100, seed=3, reservations=True)
    jpods, jpools = bench.build_problem(2000, 100, seed=3, reservations=True)
    ours = assert_same_cost_solve(pods, pools, jpods, jpools)
    assert any(n.reservation_id for n in ours.new_nodes)


class TestNoFallback:
    def test_default_device_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid here")
        pods, pools = build_problem(20, 5, seed=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver.solve(pods, pools, objective="cost")

    def test_ascent_error_propagates(self, clean, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("lp_ascend: CUDA error 700 at launch")

        monkeypatch.setattr(lp_device, "ascend", broken)
        pods, pools = build_problem(60, 8, seed=0)
        enc = encode(group_pods(pods), pools)
        # the ascent's error reaches `solve`'s caller; `maybe_solve`
        # degrades it to the unguided path, as the JAX package's does
        # (ROADMAP C3, closed), and counts it, so it never passes silently
        with pytest.raises(RuntimeError, match="lp_ascend"):
            lp_device.solve(enc, device="cpu")
        before = SOLVER_LP_SOLVES.value({"outcome": "degraded"})
        assert lp_device.maybe_solve(enc, device="cpu") is None
        sol = solver.solve(pods, pools, objective="cost", device="cpu")
        assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before + 2
        assert sol.lp is not None and sol.lp["guided"] is False
        # on a CUDA device the ascent's error reaches `maybe_solve`'s
        # caller as well: there only an injected fault or a deadline
        # degrades (`resilience.may_degrade`)
        monkeypatch.setattr(lp_device, "solve", broken)
        with pytest.raises(RuntimeError, match="lp_ascend"):
            lp_device.maybe_solve(enc, device="cuda")
        assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before + 2

    def test_pricing_error_propagates(self, clean, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("lp_price: CUDA error 700 at launch")

        monkeypatch.setattr(lp_plan, "price_kernel", broken)
        monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
        pods, pools = build_problem(60, 8, seed=0)
        enc = encode(group_pods(pods), pools)
        with pytest.raises(RuntimeError, match="lp_price"):
            lp_plan.plan(enc, device="cpu")
        with pytest.raises(RuntimeError, match="lp_price"):
            solver.solve(pods, pools, objective="cost", device="cpu")

    def test_guidance_off_is_the_only_none(self, clean, monkeypatch):
        pods, pools = build_problem(60, 8, seed=0)
        enc = encode(group_pods(pods), pools)
        assert lp_device.maybe_solve(enc, device="cpu") is not None
        monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
        assert lp_device.maybe_solve(enc, device="cpu") is None
        sol = solver.solve(pods, pools, objective="cost", device="cpu")
        assert sol.lp is not None and sol.lp["guided"] is False
