"""The port's full Scheduler held against the JAX package's.

(a) Every `testing.ProvisionCase`: both packages' Provisioners build
    their Scheduler as a reconcile does (`_make_scheduler` over the
    ready pools and the mirror) and solve the pending pods; the
    name-insensitive decision fingerprints are equal. Two cases also
    run the cost objective (the planner's HiGHS MIPs stopped after
    their root node in both packages, `test_torch_cost.clean`).
(b) The topology scenarios of `tests/test_topology_oracle.py` and
    `tests/test_topo_batch.py` (zonal, hostname and capacity-type
    spread, ScheduleAnyway, minDomains, pod affinity and
    anti-affinity on hostname and zone, host ports beside plain pods),
    rebuilt from plain data in both packages and solved by a
    Scheduler built directly, with one fixed clock.
(c) `device=None` without CUDA raises (also in `test_torch_guard.py`).
All comparisons are exact.
"""

import pytest
import torch

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.testing import CASE_T0, case_pod, case_pool

from test_torch_cost import clean  # noqa: F401
from test_torch_provisioning import CASES, CASE_IDS, jax_api

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
CAPTYPE = "karpenter.sh/capacity-type"
GIB = 2**30


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


def case_decision(case, api, objective="ffd", **kw):
    env = testing.build_env(case, api, **kw)
    prov = env.provisioner
    sched = prov._make_scheduler(prov.ready_pools_with_types())
    sched.objective = objective
    results = sched.solve(prov.get_pending_pods())
    return testing.decision_fingerprint(results), results


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scheduler_on_cases_matches_jax(case):
    port, _ = case_decision(case, testing.package_api(), device="cpu")
    ref, _ = case_decision(case, jax_api())
    assert port == ref


@pytest.mark.parametrize("name", ["plain", "reserved"])
def test_cost_scheduler_matches_jax(clean, name):  # noqa: F811
    case = next(c for c in CASES if c.name == name)
    port, results = case_decision(case, testing.package_api(), "cost",
                                  device="cpu")
    ref, _ = case_decision(case, jax_api(), "cost")
    assert port == ref
    assert results.new_node_plans


# -- topology scenarios -------------------------------------------------------


def oracle_types(api):
    """`tests/test_topology_oracle.py`'s three types."""
    mk = api.fake.make_instance_type
    return [
        mk("c4", cpu=4, memory=16 * GIB, price=1.0),
        mk("c4-arm", cpu=4, memory=16 * GIB, price=0.9, arch="arm64"),
        mk("c16", cpu=16, memory=64 * GIB, price=4.0),
    ]


def spread(name, app, key=ZONE, skew=1, cpu=0.5, when="DoNotSchedule", **kw):
    return testing._pod(name, cpu, 1.0, labels={"app": app},
                        spread=[(key, skew, when, {"app": app})], **kw)


def affine(name, app, target, key, anti=False, cpu=0.5):
    term = [(key, {"app": target})]
    return testing._pod(name, cpu, 1.0, labels={"app": app},
                        **({"anti": term} if anti else {"affinity": term}))


def _bench_shape():
    pods = []
    for i in range(40):
        d = spread(f"b-{i}", f"svc-{i % 4}", cpu=1.0)
        if i % 10 == 0:
            d["anti"] = [(HOSTNAME, {"app": f"svc-{i % 4}"})]
        pods.append(d)
    return pods


# name -> (types, pools, pods); types "oracle" or ("diverse", n)
SCENARIOS = {
    "zonal-balance": ("oracle", [dict(name="p")],
                      [spread(f"z-{i}", "svc") for i in range(9)]),
    "zonal-pool-subset": ("oracle", [dict(name="p", requirements=[
        (ZONE, "In", ("test-zone-1", "test-zone-2"), None)])],
        [spread(f"zs-{i}", "svc") for i in range(8)]),
    "zonal-two-pools": ("oracle", [
        dict(name="a", requirements=[(ZONE, "In", ("test-zone-1",), None)]),
        dict(name="b", requirements=[(ZONE, "In", ("test-zone-2", "test-zone-3"), None)])],
        [spread(f"zp-{i}", "svc") for i in range(9)]),
    "zonal-skew-3": ("oracle", [dict(name="p")],
                     [spread(f"zk-{i}", "svc", skew=3, cpu=1.0) for i in range(14)]),
    "min-domains-unreachable": ("oracle", [dict(name="p")], [
        dict(spread(f"mu-{i}", "svc"), spread=[(ZONE, 1, "DoNotSchedule", {"app": "svc"}, 4)])
        for i in range(4)]),
    "min-domains-equal": ("oracle", [dict(name="p")], [
        dict(spread(f"me-{i}", "svc"), spread=[(ZONE, 1, "DoNotSchedule", {"app": "svc"}, 3)])
        for i in range(6)]),
    "hostname-spread": ("oracle", [dict(name="p")],
                        [spread(f"h-{i}", "svc", key=HOSTNAME) for i in range(6)]),
    "hostname-skew-2": ("oracle", [dict(name="p")],
                        [spread(f"h2-{i}", "svc", key=HOSTNAME, skew=2) for i in range(8)]),
    "two-deployments": ("oracle", [dict(name="p")],
                        [spread(f"d-{i}", f"svc-{i % 2}", key=HOSTNAME) for i in range(8)]),
    "capacity-type": ("oracle", [dict(name="p")],
                      [spread(f"c-{i}", "svc", key=CAPTYPE) for i in range(6)]),
    "schedule-anyway": ("oracle", [dict(name="p", requirements=[
        (ZONE, "In", ("test-zone-1",), None)])],
        [spread(f"sa-{i}", "svc", when="ScheduleAnyway") for i in range(6)]),
    "hostname-and-zone": ("oracle", [dict(name="p")], [
        dict(spread(f"hz-{i}", "svc"), spread=[
            (ZONE, 1, "DoNotSchedule", {"app": "svc"}),
            (HOSTNAME, 1, "DoNotSchedule", {"app": "svc"})]) for i in range(9)]),
    "node-selector-domains": ("oracle", [dict(name="p")], [
        spread(f"ns-{i}", "svc", node_selector={ZONE: "test-zone-2"}) for i in range(4)]),
    "required-zone-domains": ("oracle", [dict(name="p")], [
        spread(f"rz-{i}", "svc", required_zones=("test-zone-1", "test-zone-3"))
        for i in range(6)]),
    "affinity-hostname": ("oracle", [dict(name="p")],
                          [affine("target", "web", "web", HOSTNAME)]
                          + [affine(f"a-{i}", "web", "web", HOSTNAME) for i in range(3)]),
    "affinity-missing-target": ("oracle", [dict(name="p")],
                                [affine("lonely", "a", "nobody", HOSTNAME)]),
    "self-affinity-zone": ("oracle", [dict(name="p")],
                           [affine(f"sz-{i}", "db", "db", ZONE) for i in range(5)]),
    "anti-hostname": ("oracle", [dict(name="p")],
                      [affine(f"ah-{i}", "web", "web", HOSTNAME, anti=True) for i in range(4)]),
    "anti-zone-overflow": ("oracle", [dict(name="p")],
                           [affine(f"az-{i}", "web", "web", ZONE, anti=True) for i in range(5)]),
    "anti-cross-app": ("oracle", [dict(name="p")],
                       [affine(f"x-{i}", "front", "back", ZONE, anti=True) for i in range(2)]
                       + [testing._pod(f"back-{i}", 0.5, 1.0, labels={"app": "back"})
                          for i in range(2)]),
    "batch-bench-shape": (("diverse", 20), [dict(name="p")], _bench_shape()),
    "batch-host-ports": ("c8", [dict(name="p")],
                         [testing._pod("porty", 0.25, 1.0, host_ports=[443])]
                         + [testing._pod(f"plain-{i}", 0.25, 1.0) for i in range(3)]),
    "batch-zone-anti": (("diverse", 20), [dict(name="p")],
                        [affine(f"za-{i}", "solo", "solo", ZONE, anti=True, cpu=1.0)
                         for i in range(5)]),
}


def scenario_types(api, kind):
    if kind == "oracle":
        return oracle_types(api)
    if kind == "c8":
        return [api.fake.make_instance_type("c8", cpu=8, memory=32 * GIB, price=1.0)]
    return api.fake.instance_types(kind[1])


def scenario_decision(name, api, **kw):
    kind, pools, pods = SCENARIOS[name]
    from_api = api.provisioner.Scheduler
    types = scenario_types(api, kind)
    pools_with_types = [(case_pool(api, d), types) for d in pools]
    objs = [case_pod(api, d, CASE_T0 + i) for i, d in enumerate(pods)]
    sched = from_api(pools_with_types=pools_with_types,
                     clock=lambda: CASE_T0, **kw)
    results = sched.solve(objs)
    return testing.decision_fingerprint(results), results


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_topology_scenarios_match_jax(name):
    port, results = scenario_decision(name, testing.package_api(), device="cpu")
    ref, _ = scenario_decision(name, jax_api())
    assert port == ref
    assert results.new_node_plans or results.errors


def test_scheduler_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario_decision("zonal-balance", testing.package_api())
