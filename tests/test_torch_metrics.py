"""The port's metrics, held against the JAX package on the CPU.

(a) The regression sentinel (`metrics/sentinel.py`): the cases of
    tests/test_sentinel.py that need no Operator (warmup, steady and
    stepped signals, the deviation floor, the pinned EWMA and MAD
    arithmetic, the kill switch and bad input, the counter and the
    nonstructural span event of an anomaly, snapshot, checkpoint and
    reset), each run through both packages with equal results.
(b) The exposition (`metrics/exposition.py`): the same counter, gauge
    and histogram operations on a fresh registry of each package render
    the same text; NaN and infinities render as the text format spells
    them.
(c) The recording sites: one ffd solve, one cost solve and one probe
    pass (B6 at a lane width of 4) on the same problems in both
    packages move the count-valued series alike: the count of each
    phase label of `karpenter_solver_phase_duration_seconds`,
    `karpenter_solver_device_steps` (count and sum by path),
    `karpenter_solver_probe_batch_total` by outcome and
    `karpenter_solver_warm_compiles_total`; the solve phases feed the
    shared sentinel. Sums and buckets of time-valued series differ by
    nature and are not compared.
(d) The metrics controllers (`metrics/controllers.py`) over a
    provisioned `testing.Environment` in each package publish the same
    gauges, the state node-pool health tracker and the cloud provider's
    metrics decorator the same series.

Tolerance: exact equality.
"""

import pytest

import bench
from karpenter_tpu import tracing as jtracing
from karpenter_tpu.metrics import exposition as jexposition
from karpenter_tpu.metrics import sentinel as jsentinel
from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu_torch import testing, tracing
from karpenter_tpu_torch.metrics import exposition, sentinel, store
from karpenter_tpu_torch.solver import lp_device, lp_plan, solver
from karpenter_tpu_torch.workloads import build_problem

PKG = {
    "port": dict(sentinel=sentinel, store=store, tracing=tracing, exposition=exposition),
    "jax": dict(sentinel=jsentinel, store=jstore, tracing=jtracing, exposition=jexposition),
}
PHASES = ("encode", "transfer", "compile", "execute", "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("KARPENTER_SENTINEL", "KARPENTER_SENTINEL_WARMUP",
                 "KARPENTER_SENTINEL_K", "KARPENTER_SENTINEL_ALPHA",
                 "KARPENTER_SENTINEL_FLOOR_MS", "KARPENTER_PROBE_BATCH_WIDTH",
                 "KARPENTER_WAVEFRONT", "KARPENTER_FAULTS", "KARPENTER_INCREMENTAL"):
        monkeypatch.delenv(knob, raising=False)
    for p in PKG.values():
        p["sentinel"].reset()
        p["tracing"].clear()
    yield
    for p in PKG.values():
        p["sentinel"].reset()
        p["tracing"].clear()


def both(fn):
    """fn(package modules) in both packages; returns the two results."""
    return fn(PKG["port"]), fn(PKG["jax"])


# -- (a) the sentinel


def _warmup(m):
    s = m["sentinel"].Sentinel()
    out = [s.observe("sig", 0.01) for _ in range(9)]
    out += [s.observe("sig", 50.0), s.observe("sig", 100.0)]
    return out, s.snapshot()


def _steady(m):
    s = m["sentinel"].Sentinel()
    return [s.observe("sig", 0.050) for _ in range(200)], s.summary()


def _step(m):
    s = m["sentinel"].Sentinel()
    for _ in range(30):
        s.observe("sig", 0.050)
    first = s.observe("sig", 0.500)
    flags = sum(s.observe("sig", 0.500) for _ in range(60))
    return first, flags, s.observe("sig", 0.500), s.snapshot()


def _floor(m):
    s = m["sentinel"].Sentinel()
    for _ in range(50):
        s.observe("sig", 0.0001)
    return s.observe("sig", 0.004), s.observe("sig", 0.020), s.summary()


def _arithmetic(m):
    s = m["sentinel"].Sentinel()
    s.observe("sig", 1.0)
    s.observe("sig", 2.0)
    return s.summary()["sig"]


def _bad_input(m):
    s = m["sentinel"].Sentinel()
    out = [s.observe("sig", float("nan")), s.observe("sig", float("inf")),
           s.observe("sig", None)]
    return out, s.summary()


SENTINEL_CASES = {
    "warmup": ({"KARPENTER_SENTINEL_WARMUP": "10"}, _warmup),
    "steady": ({}, _steady),
    "step": ({"KARPENTER_SENTINEL_ALPHA": "0.2"}, _step),
    "floor": ({"KARPENTER_SENTINEL_FLOOR_MS": "5"}, _floor),
    "arithmetic": ({}, _arithmetic),
    "bad_input": ({}, _bad_input),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinel_baselines_equal_jax(monkeypatch, case):
    env, fn = SENTINEL_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, jax_ = both(fn)
    assert port == jax_
    if case == "warmup":
        assert port[0] == [False] * 10 + [True]
    elif case == "step":
        assert port[0] and not port[2] and port[1] < 60
    elif case == "floor":
        assert port[:2] == (False, True)
    elif case == "arithmetic":
        assert port["ewma_ms"] == pytest.approx(1050.0)
        assert port["mad_ms"] == pytest.approx(50.0) and port["samples"] == 2
    elif case == "bad_input":
        assert port == ([False] * 3, {})


def test_sentinel_kill_switch(monkeypatch):
    monkeypatch.setenv("KARPENTER_SENTINEL", "0")
    port, jax_ = both(lambda m: (m["sentinel"].Sentinel().observe("sig", 99.0),
                                 m["sentinel"].observe_phase("compile", 9.0)))
    assert port == jax_ == (False, False)


def test_anomaly_lands_on_counter_and_nonstructural_event(monkeypatch):
    monkeypatch.setenv("KARPENTER_SENTINEL_WARMUP", "5")

    def run(m):
        counter = m["store"].SENTINEL_ANOMALIES
        before = counter.value({"signal": "solve.compile"})
        with m["tracing"].trace("tick"):
            flags = [m["sentinel"].observe_phase("compile", 0.01) for _ in range(10)]
            flags.append(m["sentinel"].observe_phase("compile", 9.0))
        trace = m["tracing"].last_trace()
        events = [e for s in trace["spans"] for e in s["events"]
                  if e["name"] == "sentinel_anomaly"]
        with m["tracing"].trace("calm"):
            pass
        return (flags, counter.value({"signal": "solve.compile"}) - before,
                [(e["signal"], e["value_ms"]) for e in events],
                m["tracing"].structure(trace)[0][3] if m["tracing"].structure(trace) else None)

    port, jax_ = both(run)
    assert port == jax_
    assert port[0] == [False] * 10 + [True] and port[1] == 1
    assert port[2] == [("solve.compile", 9000.0)]


def test_anomaly_event_is_nonstructural():
    def run(m):
        t = m["tracing"]
        with t.trace("a"):
            with t.span("s"):
                t.add_event("sentinel_anomaly", signal="x", value_ms=1.0)
        with t.trace("b"):
            with t.span("s"):
                pass
        a, b = t.traces()
        return t.structure(a)[0][3] == t.structure(b)[0][3]

    assert both(run) == (True, True)


def _snapshots(m):
    s = m["sentinel"].Sentinel()
    for _ in range(10):
        s.observe("sig", 0.01)
    flagged = s.observe("sig", 9.0)
    snap = s.snapshot()
    checkpoint = s.reset_baselines()
    after = s.snapshot()
    rewarm = [s.observe("sig", 1.0) for _ in range(20)]
    for _ in range(3):
        s.observe("keep", 0.01)
        s.observe("drop", 0.01)
    s.reset_baselines(signals=["drop"])

    def run():
        s.reset_baselines()
        for i in range(30):
            s.observe("a", 0.01 + 0.001 * (i % 3))
            s.observe("b", 0.5)
        return s.snapshot()

    m["sentinel"].observe("modsig", 0.02)
    shared = m["sentinel"].snapshot()
    shared_checkpoint = m["sentinel"].reset_baselines()
    return (flagged, snap, checkpoint, after, rewarm, sorted(s.snapshot()["signals"]),
            run() == run(), "modsig" in shared["signals"],
            "modsig" in shared_checkpoint["signals"], m["sentinel"].snapshot())


def test_snapshot_and_reset_equal_jax(monkeypatch):
    monkeypatch.setenv("KARPENTER_SENTINEL_WARMUP", "5")
    port, jax_ = both(_snapshots)
    assert port == jax_
    flagged, snap, checkpoint, after, rewarm, kept, det, mod, modck, shared = port
    assert flagged and snap["signals"]["sig"]["samples"] == 11
    assert snap["signals"]["sig"]["warmed"] and snap["anomaly_total"] == 1
    assert checkpoint == snap and after["signals"] == {}
    assert rewarm == [False] * 20
    assert det and mod and modck and shared["signals"] == {}


# -- (b) the exposition


def _render(m):
    reg = m["store"].Registry()
    c = reg.counter("t_requests_total", 'requests "quoted"\nand escaped')
    c.inc()
    c.inc({"code": "200", "path": "/a\\b"}, value=3.0)
    reg.counter("t_idle_total", "never incremented")
    g = reg.gauge("t_level", "a gauge")
    g.set(2.5, {"zone": "z1"})
    g.set(7.0, {"zone": "z2"})
    g.set(1e20)
    reg.gauge("t_poison", "x").set(float("nan"))
    reg.gauge("t_neg", "x").set(float("-inf"))
    h = reg.histogram("t_latency_seconds", "a histogram", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v, {"phase": "encode"})
    h.observe(0.2)
    return m["exposition"].render(reg)


def test_render_equals_jax():
    port, jax_ = both(_render)
    assert port == jax_
    assert "t_poison NaN" in port and "t_neg -Inf" in port
    assert 't_latency_seconds_bucket{phase="encode",le="+Inf"} 5' in port
    assert "t_idle_total 0" in port


def test_registries_list_the_same_series():
    """Every series `metrics/store.py` defines, under the same name and
    type, in the same order (the exposition's order). Read from the
    module, not the registry, which also holds the series of whatever
    else the process imported."""
    def listing(m):
        st = m["store"]
        kinds = (st.Counter, st.Gauge, st.Histogram)
        return [(attr, metric.name, type(metric).__name__)
                for attr, metric in vars(st).items() if isinstance(metric, kinds)]

    port, jax_ = both(listing)
    assert port == jax_


# -- (c) the recording sites


def _counts(st) -> dict:
    """The count-valued series the solves move, as plain values."""
    out = {}
    for phase in PHASES:
        out[f"phase.{phase}"] = st.SOLVER_PHASE_DURATION.count({"phase": phase})
    for path in ("sequential", "wavefront"):
        out[f"steps.{path}.count"] = st.SOLVER_DEVICE_STEPS.count({"path": path})
        out[f"steps.{path}.sum"] = st.SOLVER_DEVICE_STEPS.sum({"path": path})
    for outcome in ("lane", "batch", "capped_retry", "fallback_lane"):
        out[f"probe.{outcome}"] = st.SOLVER_PROBE_BATCH.value({"outcome": outcome})
    for outcome in ("ok", "error"):
        out[f"warm.{outcome}"] = st.SOLVER_WARM_COMPILES.value({"outcome": outcome})
    out["stream_blocks"] = st.SOLVER_STREAM_BLOCKS.total()
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _clear_solver_caches():
    jsolver._ffd_floor.clear()
    jsolver._warm_arm.clear()
    jsolver._plan_cache.clear()
    jlp_plan._warm_patterns.clear()
    jlp_device.reset()
    solver.reset_caches()
    lp_device.reset()


@pytest.mark.parametrize("objective", ["ffd", "cost"])
def test_solve_counters_equal_jax(monkeypatch, objective):
    monkeypatch.setattr(jlp_plan, "_TIME_BUDGET_S", 1e6)
    monkeypatch.setattr(lp_plan, "_TIME_BUDGET_S", 1e6)
    _clear_solver_caches()
    pods, pools = build_problem(300, 12, seed=5)
    jpods, jpools = bench.build_problem(300, 12, seed=5)
    with testing.root_node_mips():
        before = _counts(store)
        got = solver.fingerprint(solver.solve(pods, pools, objective=objective, device="cpu"))
        port = _delta(before, _counts(store))
        before = _counts(jstore)
        want = solver.fingerprint(jsolver.solve(jpods, jpools, objective=objective))
        jax_ = _delta(before, _counts(jstore))
    _clear_solver_caches()
    assert got == want
    assert port == jax_
    assert all(port[f"phase.{p}"] >= 1 for p in PHASES), port
    assert port["steps.sequential.count"] + port["steps.wavefront.count"] >= 1
    assert {"solve." + p for p in PHASES} <= set(sentinel.summary())


def test_probe_pass_counters_equal_jax(monkeypatch):
    """A probe pass of the consolidation lane solver at a lane width of
    4 (B6 over the lane axis, two dispatches of the oracle fleet's
    lanes) moves SOLVER_PROBE_BATCH and SOLVER_DEVICE_STEPS alike."""
    from test_torch_consolidation import _lane_sets, _lanes, build_fleet
    from test_consolidation_batch_oracle import build_fleet as jbuild_fleet

    from karpenter_tpu.solver.consolidation_batch import LaneSolver as JLaneSolver
    from karpenter_tpu.solver.consolidation_batch import ProbeLane as JProbeLane
    from karpenter_tpu_torch.solver.consolidation_batch import (
        LaneSolver,
        ProbeLane,
        probe_counts,
    )

    monkeypatch.setenv("KARPENTER_PROBE_BATCH_WIDTH", "4")
    pools, inputs, pods_on, _ = build_fleet(3, n_pods=120, n_types=12)
    jpools, jinputs, jpods_on = jbuild_fleet(3, n_pods=120, n_types=12)
    sets = _lane_sets(3, len(inputs), pods_on)[:7]
    mark = probe_counts()
    before = _counts(store)
    LaneSolver(pools, inputs, device="cpu").solve(_lanes(sets, inputs, pods_on, ProbeLane))
    port = _delta(before, _counts(store))
    since = probe_counts(since=mark)
    before = _counts(jstore)
    JLaneSolver(jpools, jinputs).solve(_lanes(sets, jinputs, jpods_on, JProbeLane))
    jax_ = _delta(before, _counts(jstore))
    assert port == jax_
    assert port["probe.lane"] == len(sets) and port["probe.batch"] >= 2
    assert since["lane"] == port["probe.lane"] and since["batch"] == port["probe.batch"]


# -- (d) the metrics controllers, node-pool health, the provider decorator


def _controller_series(pkg: str):
    """Provision a small cluster through the package's Environment, run
    the metrics controllers, and read their gauges (names fixed by
    resetting the claim and uid counters first)."""
    if pkg == "port":
        from karpenter_tpu_torch import testing as t
        from karpenter_tpu_torch.cloudprovider import metrics as cpm
        from karpenter_tpu_torch.metrics import controllers as mc
        from karpenter_tpu_torch.state.nodepoolhealth import HealthTracker
        api = t.package_api()
        kw = {"device": "cpu"}
    else:
        from karpenter_tpu import testing as t
        from karpenter_tpu.cloudprovider import metrics as cpm
        from karpenter_tpu.metrics import controllers as mc
        from karpenter_tpu.state.nodepoolhealth import HealthTracker
        from types import SimpleNamespace

        from karpenter_tpu.kube import objects
        from karpenter_tpu.provisioning import provisioner
        api = SimpleNamespace(provisioner=provisioner, objects=objects)
        kw = {}
    testing.reset_counters(api)
    env = t.Environment(**kw)
    env.kube.create(t.mk_nodepool("general", limits={"cpu": 1000.0}))
    env.provision(*[t.mk_pod(name=f"m-{i}", cpu=0.5 + (i % 3)) for i in range(12)],
                  now=testing.CASE_T0)
    env.kube.create(t.mk_pod(name="m-pending", cpu=10_000.0))
    ctrls = [mc.PodMetricsController(env.kube, env.cluster),
             mc.NodeMetricsController(env.kube, env.cluster),
             mc.NodePoolMetricsController(env.kube, env.cluster),
             mc.StatusConditionMetricsController(env.kube, clock=lambda: testing.CASE_T0 + 60)]
    watched = (mc.PODS_STATE, mc.NODES_ALLOCATABLE, mc.NODES_TOTAL_POD_REQUESTS,
               mc.NODES_UTILIZATION, mc.NODEPOOL_USAGE, mc.NODEPOOL_LIMIT,
               mc.NODEPOOL_NODE_COUNT, mc.NODEPOOL_WEIGHT, mc.STATUS_CONDITION_COUNT)
    # the gauges are process-wide: read only this cluster's series
    saved = [g._values for g in watched]
    for g in watched:
        g._values = {}
    try:
        for c in ctrls:
            c.reconcile_all(now=testing.CASE_T0 + 60)
        gauges = {g.name: sorted(g.samples()) for g in watched}
    finally:
        for g, values in zip(watched, saved):
            g._values = values
    health = HealthTracker()
    for ok in (True, False, False, True):
        health.record("general", ok)
    wrapped = cpm.MetricsCloudProvider(env.cloud)
    wrapped.list()
    wrapped.get_instance_types(None)
    return gauges, health.snapshot(), health.healthy("general"), len(wrapped.list())


def test_controller_gauges_equal_jax():
    port, jax_ = _controller_series("port"), _controller_series("jax")
    assert port == jax_
    assert port[0]["karpenter_nodes_allocatable"], "no node was published"
