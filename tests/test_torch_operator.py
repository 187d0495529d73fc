"""The port's `Operator` (`karpenter_tpu_torch/operator/operator.py`)
held against the JAX package's on the CPU.

(a) `testing.operator_run` through both packages' Operators over the same
    seeded cluster (the in-memory store, the kwok provider): two waves
    of provisioning ticks with the binding queue's drain, micro steps
    with the reactive plane on, a wave of higher-priority pods that
    nominates preemption victims under a capped pool, then disruption
    scans, the skip gate among them. Every step's record
    (`operator_record`: the name-free fleet, pending and nominated pods,
    claims, instances, `readyz()`'s clock-free counts, the growth of the
    operator's counters, each micro step's digest and each scan's
    command) equal.
(b) `tests/test_priority_preemption.py`'s eight cases, each run through
    both packages with the reference's assertions, the name-free state
    after every step equal.
(c) Leader election: the lease's single leader and failover, and a
    standby Operator that provisions nothing, in both packages alike.
(d) `healthz()`/`readyz()`: ok on a fresh Operator, not ready while
    informers lag; the node-overlay feature gate (the overlay cloud
    provider refuses before the controller's first evaluation, then
    serves the overlay's price); the CRD schema artifacts equal the JAX
    package's and in sync with the port's validation constants; a
    checkpoint saved by the store resumed by a new Operator.
(e) The JAX package's disruption skip-gate test
    (`tests/test_incremental_tick.py::TestDisruptionSkipGate`) run on the
    port through `testing.build_churn_operator`, and on the JAX package
    beside it: the same counts.

Tolerance: exact equality.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import karpenter_tpu.testing as jtesting
from karpenter_tpu.apis.v1 import labels as jlabels
from karpenter_tpu.cloudprovider import fake as jfake, kwok as jkwok
from karpenter_tpu.kube import client as jclient, objects as jobjects
from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.operator import leader as jleader, operator as joperator
from karpenter_tpu.operator import options as joptions
from karpenter_tpu.provisioning import provisioner as jprovisioner
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.apis.v1 import labels
from karpenter_tpu_torch.cloudprovider import fake, kwok
from karpenter_tpu_torch.kube import client, objects
from karpenter_tpu_torch.metrics import store
from karpenter_tpu_torch.operator import leader, operator, options
from karpenter_tpu_torch.provisioning import provisioner
from karpenter_tpu_torch.solver import faults


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("KARPENTER_FAULTS", "KARPENTER_FAULT_SEED", "KARPENTER_REACTIVE",
                 "KARPENTER_INCREMENTAL", "KARPENTER_SOLVER_BACKEND",
                 "KARPENTER_INCR_DISRUPTION_FORCE_SECONDS"):
        monkeypatch.delenv(knob, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _api(name: str) -> SimpleNamespace:
    """Each package's modules under the names the helpers read; `kw` the
    Operator's extra arguments (the port's device)."""
    if name == "port":
        return SimpleNamespace(
            name=name, labels=labels, kwok=kwok, client=client, objects=objects,
            store=store, operator=operator, options=options, fake=fake,
            leader=leader, testing=testing, provisioner=provisioner, kw={"device": "cpu"})
    return SimpleNamespace(
        name=name, labels=jlabels, kwok=jkwok, client=jclient, objects=jobjects,
        store=jstore, operator=joperator, options=joptions, fake=jfake,
        leader=jleader, testing=jtesting, provisioner=jprovisioner, kw={})


PACKAGES = ("jax", "port")


# ---------------------------------------------------------------- (a)

def _operator_run(api, seed: int):
    """`operator_run` at a small size: a 3-type catalog, 48 + 32 pods of
    three shapes, 3 pods for the micro path, 5 higher-priority pods."""
    rng = np.random.default_rng(seed)
    shapes = [float(x) for x in rng.choice([0.5, 1.0, 1.5], 90)]
    G = api.fake.GIB
    types = [api.fake.make_instance_type(f"c{c}", cpu=c, memory=4 * c * G, price=0.1 * c)
             for c in (2, 4, 8)]
    it = iter(shapes)

    def pods(prefix, n):
        return [api.testing.mk_pod(name=f"{prefix}-{i}", cpu=next(it), memory=G)
                for i in range(n)]

    waves = [pods("a", 48), pods("b", 32)]
    micro, high = pods("m", 3), pods("h", 5)
    testing.reset_counters(api)  # claim names order the retained rows
    # seed 0 consolidates what a random 30% deletion leaves underused;
    # seed 1 only the three nodes it empties (WhenEmpty)
    disrupt = (dict(drop=0.3) if seed == 0
               else dict(empty=3, policy="WhenEmpty"))
    return testing.operator_run(api, api.kw.get("device"), types,
                                api.testing.mk_nodepool("default"), waves, micro, high,
                                seed=seed, scans=8, clock=lambda: testing.DISRUPTION_T0,
                                **disrupt)


@pytest.fixture(scope="module")
def operator_runs():
    """Both packages' runs at seeds 0 and 1, with the planners' MIPs
    stopped at the root node and their time budgets lifted (the global
    repack's cost solves plan the same work under any load)."""
    from karpenter_tpu.solver import lp_plan as jlp_plan
    from karpenter_tpu_torch.solver import lp_plan

    budgets = jlp_plan._TIME_BUDGET_S, lp_plan._TIME_BUDGET_S
    jlp_plan._TIME_BUDGET_S = lp_plan._TIME_BUDGET_S = 1e6
    out = {}
    try:
        with testing.root_node_mips():
            for seed in (0, 1):
                for name in PACKAGES:
                    jfaults.reset()
                    faults.reset()
                    out[name, seed] = _operator_run(_api(name), seed)
    finally:
        jlp_plan._TIME_BUDGET_S, lp_plan._TIME_BUDGET_S = budgets
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("step", testing.OPERATOR_STEPS)
def test_operator_run_equals_jax(operator_runs, seed, step):
    """Each step of one kind, in order, equal in both packages; and the
    kind did what it is there for (bound pods, a served micro batch,
    nominations, a scan's command and a skipped scan)."""
    ours = [r for r in operator_runs["port", seed] if r["step"] == step]
    theirs = [r for r in operator_runs["jax", seed] if r["step"] == step]
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (step, i)
    last = ours[-1]
    if step == "provision":
        assert last["nodes"] and not last["pending"]
    elif step == "micro":
        outcomes = [(r["extra"] or {}).get("outcome") for r in ours]
        assert "served" in outcomes and last["counters"]["MICRO_SOLVE"] >= 1
    elif step == "preempt":
        assert last["counters"]["PREEMPTION_NOMINATIONS"] >= 1
    else:
        commands = [c for r in ours for c in r["extra"]]
        assert any(c is not None for c in commands)
        assert last["counters"]["DISRUPTION_SCAN_SKIPPED"] >= 1


# ---------------------------------------------------------------- (b)

class Harness:
    """tests/test_priority_preemption.py's Harness over either package:
    an Operator over a one-node-capped pool; `states` keeps the
    name-free state after every step."""

    def __init__(self, api, cpu_limit=4.0):
        self.api = api
        self.kube = api.client.KubeClient()
        G = api.fake.GIB
        self.cloud = api.kwok.KwokCloudProvider(
            self.kube, types=[api.fake.make_instance_type("c4", cpu=4, memory=16 * G)])
        self.op = api.operator.Operator(self.kube, self.cloud, **api.kw)
        pool = api.testing.mk_nodepool("cap", limits={"cpu": cpu_limit})
        pool.spec.disruption.consolidate_after = "Never"
        self.kube.create(pool)
        self.now = testing.DISRUPTION_T0
        self.states: list = []

    def state(self):
        pods = sorted((p.metadata.name, bool(p.spec.node_name),
                       bool(p.status.nominated_node_name), p.is_terminating())
                      for p in self.kube.pods())
        return pods, len(self.kube.nodes()), len(self.kube.node_claims())

    def step(self):
        self.now += 2.0
        self.op.step(now=self.now)
        self.states.append(self.state())

    def drive(self, ticks=10):
        for _ in range(ticks):
            self.step()

    def fill_low(self, n=2, cpu=1.5, labels=None):
        for i in range(n):
            self.kube.create(self.api.testing.mk_pod(name=f"lo-{i}", cpu=cpu,
                                                     labels=labels or {}))
        self.drive(8)
        assert all(p.spec.node_name for p in self.kube.pods())

    def add_high(self, name="hi-0", cpu=1.5, priority=1000, owner=None):
        pod = self.api.testing.mk_pod(name=name, cpu=cpu, owner=owner)
        pod.spec.priority = priority
        self.kube.create(pod)
        return pod

    def pod(self, name):
        return self.kube.get_pod("default", name)


def _higher_priority_preempts_and_lands(h):
    h.fill_low()
    h.add_high()
    h.drive(14)
    assert h.pod("hi-0").spec.node_name
    lows = [h.pod(f"lo-{i}") for i in range(2)]
    assert len([p for p in lows if p is not None and not p.spec.node_name]) == 1
    return h.api.store.PREEMPTION_NOMINATIONS.total()


def _never_preempts_equal_or_higher(h):
    for i in range(2):
        pod = h.api.testing.mk_pod(name=f"lo-{i}", cpu=1.5)
        pod.spec.priority = 1000
        h.kube.create(pod)
    h.drive(8)
    h.add_high(priority=1000)
    h.drive(12)
    assert not h.pod("hi-0").spec.node_name
    assert all(h.pod(f"lo-{i}").spec.node_name for i in range(2))


def _pdb_blocks_preemption(h):
    o = h.api.objects
    h.kube.create(o.PodDisruptionBudget(
        metadata=o.ObjectMeta(name="protect"),
        spec=o.PodDisruptionBudgetSpec(selector=o.LabelSelector.of({"app": "guarded"}),
                                       max_unavailable=0)))
    h.fill_low(labels={"app": "guarded"})
    h.add_high()
    h.drive(12)
    assert not h.pod("hi-0").spec.node_name
    assert all(h.pod(f"lo-{i}").spec.node_name for i in range(2))


def _do_not_disrupt_blocks_preemption(h):
    for i in range(2):
        pod = h.api.testing.mk_pod(name=f"lo-{i}", cpu=1.5)
        pod.metadata.annotations[h.api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"
        h.kube.create(pod)
    h.drive(8)
    h.add_high()
    h.drive(12)
    assert not h.pod("hi-0").spec.node_name
    assert all(h.pod(f"lo-{i}").spec.node_name for i in range(2))


def _preemption_policy_never(h):
    o = h.api.objects
    h.kube.create(o.PriorityClass(metadata=o.ObjectMeta(name="polite", namespace=""),
                                  value=1000, preemption_policy="Never"))
    h.fill_low()
    pod = h.api.testing.mk_pod(name="hi-0", owner=None, cpu=1.5)
    pod.spec.priority_class_name = "polite"
    h.kube.create(pod)
    h.drive(12)
    assert not h.pod("hi-0").spec.node_name
    assert all(h.pod(f"lo-{i}").spec.node_name for i in range(2))


def _nominate_before_evict(h):
    h.fill_low()
    h.add_high()
    seen = False
    for _ in range(14):
        h.step()
        live = h.pod("hi-0")
        lows = [h.pod(f"lo-{i}") for i in range(2)]
        gone = any(p is None or p.is_terminating() or not p.spec.node_name for p in lows)
        if gone and live is not None:
            assert live.status.nominated_node_name or live.spec.node_name
            seen = True
    assert seen


def _min_victim_set(h):
    h.fill_low()
    h.add_high(cpu=1.0)
    h.drive(14)
    assert h.pod("hi-0").spec.node_name
    lows = [h.pod(f"lo-{i}") for i in range(2)]
    assert len([p for p in lows if p is not None and p.spec.node_name]) == 1


def _victims_lowest_priority_first(h):
    mid = h.api.testing.mk_pod(name="mid", cpu=1.5)
    mid.spec.priority = 500
    low = h.api.testing.mk_pod(name="low", cpu=1.5)
    low.spec.priority = 10
    h.kube.create(mid)
    h.kube.create(low)
    h.drive(8)
    h.add_high(cpu=1.0, priority=1000)
    h.drive(14)
    assert h.pod("hi-0").spec.node_name
    assert h.pod("mid").spec.node_name
    assert not h.pod("low").spec.node_name


PREEMPTION_CASES = {
    "higher_priority_preempts_and_lands": _higher_priority_preempts_and_lands,
    "never_preempts_equal_or_higher_priority": _never_preempts_equal_or_higher,
    "pdb_blocks_preemption": _pdb_blocks_preemption,
    "do_not_disrupt_blocks_preemption": _do_not_disrupt_blocks_preemption,
    "preemption_policy_never_queues_without_evicting": _preemption_policy_never,
    "nominate_before_evict": _nominate_before_evict,
    "min_victim_set": _min_victim_set,
    "victims_are_lowest_priority_first": _victims_lowest_priority_first,
}


@pytest.mark.parametrize("case", list(PREEMPTION_CASES))
def test_preemption_equals_jax(case):
    states, counts = {}, {}
    for name in PACKAGES:
        api = _api(name)
        before = (api.store.PREEMPTION_NOMINATIONS.total(),
                  api.store.PREEMPTION_EVICTIONS.total())
        h = Harness(api)
        PREEMPTION_CASES[case](h)
        states[name] = h.states
        counts[name] = (api.store.PREEMPTION_NOMINATIONS.total() - before[0],
                        api.store.PREEMPTION_EVICTIONS.total() - before[1])
    assert states["port"] == states["jax"]
    assert counts["port"] == counts["jax"]
    if case in ("higher_priority_preempts_and_lands", "min_victim_set"):
        assert counts["port"][0] >= 1


# ---------------------------------------------------------------- (c)

def _c4(api):
    return [api.fake.make_instance_type("c4", cpu=4, memory=16 * api.fake.GIB, price=1.0)]


def _lease_script(api):
    kube = api.client.KubeClient()
    a = api.leader.LeaderElector(kube, "op-a")
    b = api.leader.LeaderElector(kube, "op-b")
    t0 = 1000.0
    late = t0 + 6 + api.leader.LEASE_DURATION_SECONDS + 1
    return [a.try_acquire_or_renew(now=t0), b.try_acquire_or_renew(now=t0 + 1),
            a.try_acquire_or_renew(now=t0 + 5), b.try_acquire_or_renew(now=t0 + 6),
            b.try_acquire_or_renew(now=late), a.try_acquire_or_renew(now=late + 1),
            a.is_leader(), b.is_leader()]


def test_single_leader_and_failover_equals_jax():
    ours, theirs = _lease_script(_api("port")), _lease_script(_api("jax"))
    assert ours == theirs
    assert ours[:6] == [True, False, True, False, True, False]
    assert leader.LEASE_DURATION_SECONDS == jleader.LEASE_DURATION_SECONDS


def _standby(api):
    kube = api.client.KubeClient()
    cloud = api.kwok.KwokCloudProvider(kube, types=_c4(api))
    lead = api.operator.Operator(kube, cloud, identity="op-a", leader_election=True, **api.kw)
    standby = api.operator.Operator(kube, cloud, identity="op-b", leader_election=True,
                                    **api.kw)
    kube.create(api.testing.mk_nodepool("p"))
    kube.create(api.testing.mk_pod(name="w-0", cpu=1.0))
    now = testing.DISRUPTION_T0
    lead.step(now=now)
    trace = [len(kube.node_claims())]
    for i in range(10):
        standby.step(now=now + i)
        trace.append(len(kube.node_claims()))
    for i in range(6):
        lead.step(now=now + 2 * i)
        standby.step(now=now + 2 * i + 1)
        trace.append((len(kube.node_claims()), len(kube.nodes())))
    bound = all(p.spec.node_name for p in kube.pods())
    return trace, bound, lead.readyz()["checks"], standby.readyz()["checks"]


def test_standby_operator_does_not_provision_equals_jax():
    ours, theirs = _standby(_api("port")), _standby(_api("jax"))
    assert ours == theirs
    trace, bound, lead_checks, standby_checks = ours
    assert len(set(trace[:11])) == 1 and bound
    assert lead_checks["leader"] and not standby_checks["leader"]


# ---------------------------------------------------------------- (d)

def _probes(api):
    env = api.testing.Environment(types=_c4(api), **api.kw)
    op = api.operator.Operator(env.kube, env.cloud, **api.kw)
    health, ready = op.healthz(), op.readyz()
    kube = api.client.KubeClient(async_delivery=True)
    op2 = api.operator.Operator(kube, api.kwok.KwokCloudProvider(kube, types=_c4(api)),
                                **api.kw)
    kube.create(api.testing.mk_pod(cpu=1.0))
    lagging = op2.readyz()["ok"]
    kube.deliver()
    return (health["ok"], sorted(health["checks"]), ready["ok"], sorted(ready),
            ready["checks"], lagging, op2.readyz()["ok"])


def test_healthz_and_readyz_equal_jax():
    ours, theirs = _probes(_api("port")), _probes(_api("jax"))
    assert ours == theirs
    assert ours[0] and ours[2] and ours[4]["informers_synced"]
    assert ours[5] is False and ours[6] is True


def _overlay_gate(api):
    from importlib import import_module

    ov = import_module(f"{api.operator.__name__.rsplit('.', 2)[0]}.apis.v1alpha1.nodeoverlay")
    kube = api.client.KubeClient()
    cloud = api.kwok.KwokCloudProvider(kube, types=api.fake.instance_types(6))
    op = api.operator.Operator(
        kube=kube, cloud_provider=cloud,
        options=api.options.Options(feature_gates=api.options.FeatureGates(node_overlay=True)),
        **api.kw)
    kube.create(ov.NodeOverlay(spec=ov.NodeOverlaySpec(price="0.01")))
    with pytest.raises(ov.UnevaluatedNodePoolError):
        op.provider.get_instance_types(None)
    op.overlay_controller.reconcile()
    out = op.provider.get_instance_types(None)
    prices = sorted((it.name, o.price) for it in out for o in it.offerings)
    assert all(p == 0.01 for _, p in prices)
    # a pod provisions through the overlaid provider
    kube.create(api.testing.mk_nodepool("p"))
    kube.create(api.testing.mk_pod(name="w-0", cpu=1.0))
    now = testing.DISRUPTION_T0
    for i in range(8):
        op.step(now=now + 2 * i)
    fleet = sorted(n.metadata.labels.get(api.labels.INSTANCE_TYPE_LABEL, "")
                   for n in kube.nodes())
    return prices, fleet, all(p.spec.node_name for p in kube.pods())


def test_overlay_gate_equals_jax():
    ours, theirs = _overlay_gate(_api("port")), _overlay_gate(_api("jax"))
    assert ours == theirs


def test_crd_artifacts_equal_jax_and_in_sync():
    import os

    from karpenter_tpu.apis import crds as jcrds
    from karpenter_tpu_torch.apis import crds

    rendered = crds.render()
    assert rendered == jcrds.render()
    for name, content in rendered.items():
        with open(os.path.join(crds.ARTIFACT_DIR, name)) as fh:
            assert fh.read() == content, name


def _resume(api, tmp_path):
    env = api.testing.Environment(types=_c4(api), **api.kw)
    env.kube.create(api.testing.mk_nodepool("p"))
    env.provision(*[api.testing.mk_pod(name=f"w-{i}", cpu=1.0) for i in range(4)])
    path = str(tmp_path / f"{api.name}.ckpt")
    env.kube.save(path)
    kube2 = api.client.KubeClient.load(path)
    cloud2 = api.kwok.KwokCloudProvider(kube2, types=_c4(api))
    restored = cloud2.restore()
    op2 = api.operator.Operator(kube2, cloud2, **api.kw)
    synced = op2.cluster.synced()
    nodes_before = {n.metadata.name for n in kube2.nodes()}
    kube2.create(api.testing.mk_pod(name="late", cpu=0.5))
    now = testing.DISRUPTION_T0
    op2.provisioner.batcher.trigger(now=now)
    for i in range(4):
        op2.step(now=now + 2 + i)
    late = kube2.get_pod("default", "late")
    op2.gc.reconcile(now=now + 10)
    return (restored, synced, bool(late.spec.node_name),
            {n.metadata.name for n in kube2.nodes()} == nodes_before,
            len(kube2.node_claims()) == len(nodes_before), len(kube2.pods()))


def test_checkpoint_resume_equals_jax(tmp_path):
    ours, theirs = _resume(_api("port"), tmp_path), _resume(_api("jax"), tmp_path)
    assert ours == theirs and ours[0] and all(ours[1:5])


# ---------------------------------------------------------------- (e)

def _skip_gate(api, monkeypatch):
    monkeypatch.setenv("KARPENTER_INCR_DISRUPTION_FORCE_SECONDS", "100000")
    env, op, now = api.testing.build_churn_operator(8, **api.kw)
    skipped = api.store.DISRUPTION_SCAN_SKIPPED
    poll = op.options.disruption_poll_seconds
    op.step(now=now)
    op.step(now=now + poll + 1)
    base = skipped.total()
    out = []
    op.step(now=now + 2 * poll + 2)
    out.append(skipped.total() - base)
    op.step(now=now + 2 * poll + 3)
    out.append(skipped.total() - base)
    env.kube.create(api.testing.mk_pod(name="dirt-0", cpu=0.9))
    op.step(now=now + 3 * poll + 4)
    out.append(skipped.total() - base)
    return out


def test_disruption_skip_gate_on_the_port(monkeypatch):
    """The JAX test's assertions, on the port: the empty-handed scan is
    skipped once a poll slot, the same slot does not consult the gate
    again, and watch traffic re-arms the scan; the JAX package counts
    the same."""
    ours = _skip_gate(_api("port"), monkeypatch)
    assert ours == [1, 1, 1]
    assert ours == _skip_gate(_api("jax"), monkeypatch)


def test_churn_tick_walls_run_on_the_port():
    """`churn_tick_walls`, the perf floor's live-churn harness: churned
    pods land in their predecessors' slots on the port as in the JAX
    package (the same fleet after the ticks)."""
    fleets = []
    for api in (_api("port"), _api("jax")):
        env, op, now = api.testing.build_churn_operator(8, **api.kw)
        p50, _ = api.testing.churn_tick_walls(env, op, now, 2, 2)
        assert p50 > 0
        fleets.append((len(env.kube.nodes()),
                       sorted(p.metadata.name for p in env.kube.pods() if p.spec.node_name)))
    assert fleets[0] == fleets[1]
    assert len(fleets[0][1]) == 8
