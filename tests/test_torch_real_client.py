"""The port's real-client stack (`karpenter_tpu_torch/kube/`: `serialize`,
`retry`, `real`, `httpapi`) held against the JAX package's on the CPU.

(a) Every kind's CR: each CR the JAX package's server holds after an
    Operator ran (NodePool, NodeClaim, Pod, Node, Event, Lease) and after
    the JAX package's `to_cr` of a DaemonSet, a PodDisruptionBudget, a
    PersistentVolumeClaim, a PriorityClass and a NodeOverlay, read by the
    port's `from_cr` and written back by its `to_cr`, equals the JAX
    package's round trip of the same CR.
(b) `RetryPolicy` on scripted responses (409 with and without the
    conflict hook, 429 with Retry-After, a PDB's 429, 5xx, the budget):
    the same final responses, attempts, waits (one seeded RNG) and
    KUBE_RETRIES growth.
(c) Each kube fault site (`kube_conflict`, `kube_throttle`,
    `kube_write_partial` at kube_write, `kube_watch_drop` at kube_watch,
    `kube_stale_list` at kube_list) and restart chaos
    (`operator_crash@crash_launch:1` and the other crash sites of
    tests/test_restart_chaos.py) through `testing.client_run` on both
    packages: the same converged fleet as the calm run, no leak, the same
    fired-fault log, crashes, recovery actions and retries.
(d) Cross-package resume: a cluster the JAX package's Operator ran over
    its `InMemoryApiServer` (the server's CR dicts and resource version)
    loaded into the port's server; the port's Operator resumes it and
    decides, step for step, what the JAX package's Operator decides when
    it resumes the same store.
(e) The port's `HTTPTransport` against the JAX package's `HttpApiServer`
    on localhost (CRUD, a stale update's 409, the watch stream, an
    Operator provisioning over the wire), and the port's `HttpApiServer`
    serving the JAX package's transport.

Tolerance: exact equality.
"""

import copy
import itertools
import random
import time
from types import SimpleNamespace

import pytest

import karpenter_tpu.testing as jtesting
from karpenter_tpu.apis.v1 import labels as jlabels
from karpenter_tpu.apis.v1alpha1 import nodeoverlay as jnodeoverlay
from karpenter_tpu.cloudprovider import fake as jfake, kwok as jkwok
from karpenter_tpu.kube import client as jclient, httpapi as jhttpapi
from karpenter_tpu.kube import objects as jobjects, real as jreal, retry as jretry
from karpenter_tpu.kube import serialize as jserialize
from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.operator import leader as jleader, operator as joperator
from karpenter_tpu.operator import options as joptions
from karpenter_tpu.provisioning import provisioner as jprovisioner
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.apis.v1 import labels
from karpenter_tpu_torch.apis.v1alpha1 import nodeoverlay
from karpenter_tpu_torch.cloudprovider import fake, kwok
from karpenter_tpu_torch.kube import client, httpapi, objects, real, retry, serialize
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
                 "KARPENTER_INCREMENTAL", "KARPENTER_SOLVER_BACKEND"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KARPENTER_KUBE_RETRY_BASE_MS", "1")
    monkeypatch.setenv("KARPENTER_KUBE_RELIST_MIN_MS", "0")
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _api(name: str) -> SimpleNamespace:
    if name == "port":
        return SimpleNamespace(
            name=name, labels=labels, kwok=kwok, client=client, objects=objects,
            store=store, operator=operator, options=options, fake=fake, real=real,
            faults=faults, serialize=serialize, retry=retry, httpapi=httpapi,
            leader=leader, overlay=nodeoverlay, testing=testing, provisioner=provisioner,
            device="cpu")
    return SimpleNamespace(
        name=name, labels=jlabels, kwok=jkwok, client=jclient, objects=jobjects,
        store=jstore, operator=joperator, options=joptions, fake=jfake, real=jreal,
        faults=jfaults, serialize=jserialize, retry=jretry, httpapi=jhttpapi,
        leader=jleader, overlay=jnodeoverlay, testing=jtesting, provisioner=jprovisioner,
        device=None)


PACKAGES = ("jax", "port")


def _singleton(api):
    return [api.fake.make_instance_type("c2", cpu=2, memory=8 * api.fake.GIB, price=2.0)]


def _pool(api, consolidate="Never"):
    pool = api.testing.mk_nodepool("default")
    pool.spec.disruption.consolidate_after = consolidate
    return pool


def _pods(api, n=6, cpu=1.5):
    return [api.testing.mk_pod(name=f"w-{i}", cpu=cpu) for i in range(n)]


def _run(api, spec=None, **kw):
    return testing.client_run(api, api.device, _singleton(api), _pool(api), _pods(api),
                              faults_spec=spec, **kw)


@pytest.fixture(scope="module")
def calm():
    """The calm run of each package, and its fleet."""
    out = {}
    for name in PACKAGES:
        faults.reset()
        jfaults.reset()
        out[name] = _run(_api(name))
    return out


def test_calm_runs_equal(calm):
    assert calm["port"]["fleet"] == calm["jax"]["fleet"]
    assert len(calm["port"]["fleet"]) == 6 and not calm["port"]["broken"]
    assert not calm["jax"]["broken"] and not calm["port"]["pending"]


# ---------------------------------------------------------------- (a)

def _extras(api):
    """One object of each kind an Operator run does not write."""
    o, ov = api.objects, api.overlay
    sel = o.LabelSelector.of({"app": "web"})
    lease = api.leader.Lease(holder="op-a", renew_time=1234.5)
    out = [
        o.DaemonSet(metadata=o.ObjectMeta(name="ds", namespace="default"),
                    spec=o.DaemonSetSpec(selector=sel, template=o.PodTemplateSpec(
                        spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.1})])))),
        o.PodDisruptionBudget(metadata=o.ObjectMeta(name="pdb", namespace="default"),
                              spec=o.PodDisruptionBudgetSpec(selector=sel,
                                                             max_unavailable="50%")),
        o.PersistentVolumeClaim(metadata=o.ObjectMeta(name="pvc", namespace="default"),
                                spec=o.PersistentVolumeClaimSpec(storage_class_name="gp3")),
        o.PriorityClass(metadata=o.ObjectMeta(name="critical", namespace=""), value=1000,
                        preemption_policy="Never"),
        ov.NodeOverlay(metadata=o.ObjectMeta(name="cheap", namespace=""),
                       spec=ov.NodeOverlaySpec(price_adjustment="-10%", weight=3)),
        lease,
    ]
    for obj in out:  # not the packages' process-wide uid counters and clocks
        obj.metadata.uid = f"uid-{obj.kind}"
        obj.metadata.creation_timestamp = 1_700_000_000.0
    return out


@pytest.fixture(scope="module")
def jax_crs():
    """The CRs of the JAX package's server after an Operator ran (with an
    Event), and the JAX package's `to_cr` of the extras: kind -> CRs."""
    api = _api("jax")
    res = testing.client_run(api, None, _singleton(api), _pool(api), _pods(api, 3))
    out = {kind: [copy.deepcopy(cr) for cr in bucket.values()]
           for kind, bucket in res["server"]._store.items() if bucket}
    for obj in _extras(api):
        out.setdefault(obj.kind, []).append(jserialize.to_cr(obj))
    return out


def test_extras_write_the_same_json():
    """The port's `to_cr` of each extra equals the JAX package's."""
    for ours, theirs in zip(_extras(_api("port")), _extras(_api("jax"))):
        assert serialize.to_cr(ours) == jserialize.to_cr(theirs)


KINDS = sorted(jserialize.TO_CR)


def test_every_kind_is_serialized_by_both():
    assert sorted(serialize.TO_CR) == KINDS == sorted(serialize.FROM_CR)


@pytest.mark.parametrize("kind", KINDS)
def test_cr_round_trip_equals_jax(jax_crs, kind):
    crs = jax_crs.get(kind)
    assert crs, f"no {kind} in the JAX package's server"
    for cr in crs:
        theirs = jserialize.to_cr(jserialize.from_cr(copy.deepcopy(cr)))
        ours = serialize.to_cr(serialize.from_cr(copy.deepcopy(cr)))
        assert ours == theirs
        assert type(serialize.from_cr(cr)).__name__ == type(jserialize.from_cr(cr)).__name__


# ---------------------------------------------------------------- (b)

RETRY_SCRIPTS = {
    "conflict-hook": ([(409, {}), (409, {}), (200, {"ok": 1})], True),
    "conflict-terminal": ([(409, {"message": "exists"}), (200, {})], False),
    "throttle-retry-after": ([(429, {"details": {"retryAfterSeconds": 0.002}}),
                              (200, {"ok": 2})], False),
    "pdb-block": ([(429, {"details": {"causes": [{"reason": "DisruptionBudget"}]}}),
                   (200, {})], False),
    "server-errors": ([(500, {})] * 6, False),
    "unavailable-then-ok": ([(503, {}), (503, {}), (201, {"ok": 3})], False),
}


def _retry_script(api, script, hook):
    responses, seen, waits = list(script), [], []
    now = [0.0]

    def attempt():
        return responses.pop(0) if len(responses) > 1 else responses[0]

    def sleep(w):
        waits.append(w)
        now[0] += w

    before = api.store.KUBE_RETRIES.total()
    random.seed(7)
    out = api.retry.RetryPolicy.current().execute(
        "update", attempt, on_conflict=(lambda h: seen.append(h) or True) if hook else None,
        sleep=sleep, clock=lambda: now[0])
    return out, seen, waits, api.store.KUBE_RETRIES.total() - before


@pytest.mark.parametrize("name", list(RETRY_SCRIPTS))
def test_retry_policy_equals_jax(name):
    script, hook = RETRY_SCRIPTS[name]
    ours = _retry_script(_api("port"), script, hook)
    theirs = _retry_script(_api("jax"), script, hook)
    assert ours == theirs
    assert retry.RetryPolicy.current() == retry.RetryPolicy(
        **jretry.RetryPolicy.current().__dict__)


# ---------------------------------------------------------------- (c)

FAULT_SPECS = [
    "kube_conflict@kube_write:3",
    "kube_throttle@kube_write:2",
    "kube_write_partial@kube_write:4",
    "kube_watch_drop@kube_watch:1",
    "kube_stale_list@kube_list:2",
    "operator_crash@crash_launch:1",
    "operator_crash@crash_tick:2",
    "operator_crash@crash_bind:2",
    "operator_crash@crash_incr_commit:1",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_run_converges_like_jax(calm, spec):
    runs = {}
    for name in PACKAGES:
        faults.reset()
        jfaults.reset()
        runs[name] = _run(_api(name), spec)
    ours, theirs = runs["port"], runs["jax"]
    assert ours["fleet"] == calm["port"]["fleet"] == calm["jax"]["fleet"]
    assert not ours["broken"] and not theirs["broken"] and not ours["pending"]
    for key in ("fleet", "pending", "crashes", "recovery", "retries", "fault_log"):
        assert ours[key] == theirs[key], key
    assert ours["fault_log"], f"{spec} never fired"
    if spec.startswith("operator_crash"):
        assert ours["crashes"] >= 1
        assert "readopted_claims" in ours["op"].readyz()["recovery"]
    if spec == "operator_crash@crash_launch:1":
        assert ours["recovery"]["reaped_leak"] > 0


# ---------------------------------------------------------------- (d)

def _resume_steps(api, server, ticks=12):
    """An Operator of `api`'s package over `server` (a restart: fresh
    client, provider restored from the claims), a user deleting two pods
    and creating four, then `ticks` steps: each step's name-free state."""
    kw = {} if api.device is None else {"device": api.device}
    # both packages name their new claims alike, past the loaded ones
    api.provisioner._claim_counter = itertools.count(90_000)
    kube = api.real.RealKubeClient(server)
    cloud = api.kwok.KwokCloudProvider(kube, types=_singleton(api))
    restored = cloud.restore()
    op = api.operator.Operator(kube=kube, cloud_provider=cloud, **kw)
    user = api.real.RealKubeClient(server)
    user.deliver()
    for name in ("w-0", "w-1"):
        user.delete(user.get_pod("default", name))
    for i in range(4):
        user.create(api.testing.mk_pod(name=f"r-{i}", cpu=1.5))
    steps = []
    now = testing.DISRUPTION_T0 + 1000.0
    for _ in range(ticks):
        now += 2.0
        op.step(now=now)
        fleet, broken, pending = testing.client_fleet(api, op, cloud)
        steps.append((fleet, broken, pending, len(kube.node_claims()),
                       op.readyz()["recovery"]))
    user.close()
    return restored, steps


def test_port_resumes_a_cluster_the_jax_package_ran():
    api = _api("jax")
    res = testing.client_run(api, None, _singleton(api), _pool(api), _pods(api))
    jserver = res["server"]
    assert len(res["fleet"]) == 6 and not res["broken"]
    # the port's server loaded with the JAX server's CR dicts and version
    pserver = real.InMemoryApiServer()
    pserver._store = copy.deepcopy(jserver._store)
    pserver._rv = jserver._rv
    # the JAX package resumes a copy of the same store
    jcopy = jreal.InMemoryApiServer()
    jcopy._store = copy.deepcopy(jserver._store)
    jcopy._rv = jserver._rv
    ours = _resume_steps(_api("port"), pserver)
    theirs = _resume_steps(_api("jax"), jcopy)
    assert ours[0] == theirs[0] == 6
    assert ours[1] == theirs[1]
    fleet, broken, pending, claims, _ = ours[1][-1]
    assert not broken and not pending and len(fleet) == 8


# ---------------------------------------------------------------- (e)

def _wire(api_client, api_server):
    """CRUD, a stale update's 409 and the watch stream: a client of
    `api_client`'s package against `api_server`'s HttpApiServer."""
    server = api_server.real.InMemoryApiServer()
    srv = api_server.httpapi.HttpApiServer(server)
    try:
        def mk():
            return api_client.real.RealKubeClient(api_client.real.HTTPTransport(
                srv.base_url, timeout=5.0, watch_timeout_seconds=10.0))

        a, b = mk(), mk()
        try:
            a.create(api_client.testing.mk_nodepool("p"))
            a.create(api_client.testing.mk_pod(name="x", cpu=1.0))
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and b.get_pod("default", "x") is None:
                b.deliver()
                time.sleep(0.02)
            seen = b.get_pod("default", "x") is not None
            pod = a.get_pod("default", "x")
            stale = copy.deepcopy(pod)
            pod.metadata.labels["v"] = "1"
            a.update(pod)
            conflict = None
            try:
                a.update(stale)
            except api_client.client.ConflictError:
                conflict = "409"
            a.delete(a.get_pod("default", "x"))
            gone = a.get_pod("default", "x") is None
            kinds = sorted(server._store)
            return seen, conflict, gone, [k for k in kinds if server._store[k]]
        finally:
            a.close()
            b.close()
    finally:
        srv.close()


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_http_transport_across_packages(pair):
    got = _wire(_api(pair[0]), _api(pair[1]))
    want = _wire(_api("jax"), _api("jax"))
    assert got == want
    assert got[:3] == (True, "409", True)


def _over_http(api_client, api_server):
    """An Operator of `api_client`'s package provisioning four pods over
    HTTP against `api_server`'s HttpApiServer."""
    server = api_server.real.InMemoryApiServer()
    srv = api_server.httpapi.HttpApiServer(server)
    kw = {} if api_client.device is None else {"device": api_client.device}
    kube = api_client.real.RealKubeClient(api_client.real.HTTPTransport(
        srv.base_url, timeout=5.0, watch_timeout_seconds=10.0))
    try:
        cloud = api_client.kwok.KwokCloudProvider(kube, types=[
            api_client.fake.make_instance_type("c8", cpu=8, memory=32 * api_client.fake.GIB)])
        op = api_client.operator.Operator(kube=kube, cloud_provider=cloud, **kw)
        kube.create(api_client.testing.mk_nodepool("default"))
        for i in range(4):
            kube.create(api_client.testing.mk_pod(name=f"w-{i}", cpu=1.0))
        now = testing.DISRUPTION_T0
        for i in range(8):
            op.step(now=now + 2.0 * i)
            time.sleep(0.05)
        return (len(kube.nodes()), sum(1 for p in kube.pods() if p.spec.node_name),
                sorted(k for k, v in server._store.items() if v))
    finally:
        kube.close()
        srv.close()


def test_port_operator_over_the_jax_http_server():
    ours = _over_http(_api("port"), _api("jax"))
    assert ours == _over_http(_api("jax"), _api("jax"))
    assert ours[:2] == (1, 4)
