"""The port's topology lowering and encoder cache against the JAX
package's.

(a) `topo_batch.prepare`'s lowered problem, array for array: every
    call a Scheduler's topology path makes is recorded in both
    packages (the scenarios of `test_torch_scheduler.py` and the
    provisioning cases with constrained pods), and the groups (pods,
    requirement signature, count), the domain pins (`assignments`),
    `group_cap`, `conflict`, `existing_quota`, the per-pod fallback and
    the errors are equal.
(b) `encode(..., compat_cache=EncodedCache())` equals `encode(...)`
    field for field, cold and warm (a second encode over the same
    catalog served from the cache, then one with new signatures), and
    equals the JAX package's encode with its own cache.
(c) `LaneSolver(..., compat_cache=)` gives the JAX package's lane
    solutions with its cache.
All comparisons are exact.
"""

import numpy as np
import pytest

from karpenter_tpu.solver import topo_batch as jtopo_batch
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import topo_batch

from test_torch_provisioning import CASES, jax_api
from test_torch_scheduler import SCENARIOS, case_decision, scenario_decision


@pytest.fixture(autouse=True)
def full_path(monkeypatch):
    monkeypatch.setenv("KARPENTER_INCREMENTAL", "0")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """These comparisons compile JAX programs and run the plain versions
    on small tensors: on one core they leave the suite's other workers,
    some of which time milliseconds, their cores (and torch's intra-op
    pool does not spin against them)."""
    with testing.one_core():
        yield


def _lowered(tb) -> dict:
    def arr(a):
        return None if a is None else (a.dtype.str, a.shape, a.tobytes())

    return {
        "groups": [
            (sorted(p.key for p in g.pods), g.requirements.signature(),
             g.count, tuple(sorted(g.resources.items())))
            for g in tb.groups
        ],
        "group_cap": arr(tb.group_cap),
        "conflict": arr(tb.conflict),
        "existing_quota": arr(tb.existing_quota),
        "assignments": sorted(
            (k, tuple(sorted(v.items()))) for k, v in tb.assignments.items()),
        "fallback": [p.key for p in tb.fallback],
        "errors": sorted(tb.errors.items()),
    }


def _record(monkeypatch, module) -> list:
    calls = []
    prepare = module.prepare

    def recording(*args, **kwargs):
        tb = prepare(*args, **kwargs)
        calls.append(_lowered(tb))
        return tb

    monkeypatch.setattr(module, "prepare", recording)
    return calls


TOPO_SCENARIOS = [n for n in SCENARIOS if n not in ("affinity-missing-target",)]
TOPO_CASES = ["spread-anti", "host-ports"]


@pytest.mark.parametrize("name", TOPO_SCENARIOS)
def test_lowered_arrays_equal_jax_on_scenarios(monkeypatch, name):
    port_calls = _record(monkeypatch, topo_batch)
    jax_calls = _record(monkeypatch, jtopo_batch)
    scenario_decision(name, testing.package_api(), device="cpu")
    scenario_decision(name, jax_api())
    assert port_calls and port_calls == jax_calls


@pytest.mark.parametrize("name", TOPO_CASES)
def test_lowered_arrays_equal_jax_on_cases(monkeypatch, name):
    case = next(c for c in CASES if c.name == name)
    port_calls = _record(monkeypatch, topo_batch)
    jax_calls = _record(monkeypatch, jtopo_batch)
    case_decision(case, testing.package_api(), device="cpu")
    case_decision(case, jax_api())
    assert port_calls and port_calls == jax_calls
    lowered = port_calls[0]
    assert lowered["groups"] and not lowered["fallback"]
    if name == "spread-anti":
        assert lowered["conflict"] is not None or lowered["group_cap"] is not None
        assert lowered["assignments"]


def test_lowering_covers_caps_conflicts_and_quotas(monkeypatch):
    """Across the scenarios the lowering emits every array kind."""
    calls = _record(monkeypatch, topo_batch)
    for name in TOPO_SCENARIOS:
        scenario_decision(name, testing.package_api(), device="cpu")
    case_decision(next(c for c in CASES if c.name == "spread-anti"),
                  testing.package_api(), device="cpu")
    for key in ("group_cap", "conflict", "existing_quota"):
        assert any(c[key] is not None for c in calls), key
    assert any(c["errors"] for c in calls)


# -- the encoder cache ---------------------------------------------------------


ENC_FIELDS = ("compat", "group_req", "group_count", "group_priority",
              "cfg_alloc", "cfg_price", "cfg_pool", "cfg_rsv", "rsv_cap",
              "pool_overhead", "existing_used", "group_cap", "conflict",
              "existing_quota", "loose_groups", "pool_min_values")


def _enc_identity(enc) -> dict:
    out = {"n_existing": enc.n_existing, "keys": list(enc.resource_keys),
           "groups": [sorted(p.key for p in g.pods) for g in enc.groups],
           "configs": [
               (c.instance_type.name if c.instance_type is not None else "",
                c.offering.zone if c.offering is not None else "",
                c.offering.capacity_type if c.offering is not None else "",
                c.offering.reservation_id if c.offering is not None else "",
                c.existing_index)
               for c in enc.configs],
           "alts": [[(round(p, 9), c.instance_type.name, c.offering.zone,
                      c.offering.capacity_type) for p, c in alts]
                    for alts in enc.cfg_alts]}
    for name in ENC_FIELDS:
        a = getattr(enc, name, None)
        out[name] = None if a is None else (
            np.asarray(a).dtype.str, np.asarray(a).shape, np.asarray(a).tobytes())
    return out


def _encode_rounds(api_encode, api_group, cache, pods, pools, existing, extra):
    """Three encodes through one cache: cold, warm (same demand), and
    with new signatures added."""
    out = []
    for batch in (pods, pods, pods + extra):
        out.append(_enc_identity(api_encode(
            api_group(batch), pools, existing, compat_cache=cache)))
    return out


@pytest.mark.parametrize("reservations,n_existing", [(False, 0), (True, 6), (False, 12)])
def test_encode_with_cache_equals_without_and_jax(reservations, n_existing):
    import bench
    from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
    from karpenter_tpu.solver.encode import ExistingNodeInput as JExisting
    from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup
    from karpenter_tpu.solver.incremental import EncodedCache as JEncodedCache
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    from karpenter_tpu_torch.solver.encode import ExistingNodeInput, encode, group_pods
    from karpenter_tpu_torch.solver.incremental import EncodedCache
    from karpenter_tpu_torch.workloads import build_problem

    from test_torch_solve import _existing

    pods, pools = build_problem(400, 40, seed=5, reservations=reservations)
    extra, _ = build_problem(60, 40, seed=6, zonal_frac=0.6, name_prefix="x-")
    jpods, jpools = bench.build_problem(400, 40, seed=5, reservations=reservations)
    jextra, _ = bench.build_problem(60, 40, seed=6, zonal_frac=0.6)
    for i, p in enumerate(jextra):
        p.metadata.name = f"x-{i}"
    ex = _existing(n_existing, 5, ExistingNodeInput, Requirements)
    jex = _existing(n_existing, 5, JExisting, JRequirements)

    cached = _encode_rounds(encode, group_pods, EncodedCache(), pods, pools, ex, extra)
    plain = _encode_rounds(encode, group_pods, None, pods, pools, ex, extra)
    ref = _encode_rounds(jencode, jgroup, JEncodedCache(), jpods, jpools, jex, jextra)
    assert cached == plain
    assert cached == ref


def test_lane_solver_with_cache_equals_jax():
    from karpenter_tpu.solver.consolidation_batch import LaneSolver as JLaneSolver
    from karpenter_tpu.solver.consolidation_batch import ProbeLane as JProbeLane
    from karpenter_tpu.solver.incremental import EncodedCache as JEncodedCache
    from karpenter_tpu_torch.solver.consolidation_batch import LaneSolver, ProbeLane
    from karpenter_tpu_torch.solver.incremental import EncodedCache
    from karpenter_tpu_torch.testing import summarize

    from test_consolidation_batch_oracle import summarize as jsummarize
    from test_torch_consolidation import _lane_sets, _lanes, build_fleet, jbuild_fleet

    pools, inputs, pods_on, _ = build_fleet(3)
    jpools, jinputs, jpods_on = jbuild_fleet(3)
    sets = _lane_sets(3, len(inputs), pods_on)
    cache, jcache = EncodedCache(), JEncodedCache()
    for _ in range(2):  # cold, then served from the cache
        port = LaneSolver(pools, inputs, compat_cache=cache, device="cpu")
        got = port.solve(_lanes(sets, inputs, pods_on, ProbeLane))
        jax_ = JLaneSolver(jpools, jinputs, compat_cache=jcache)
        want = jax_.solve(_lanes(sets, jinputs, jpods_on, JProbeLane))
        for g, w in zip(got, want):
            assert summarize(g, inputs) == jsummarize(w, jinputs)
        assert port.last_shapes == jax_.last_shapes
    assert cache._rows and cache._launch is not None
