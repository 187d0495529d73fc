"""The node lifecycle on the port, held against the JAX package on the
CPU: the kwok provider, the lifecycle, termination, garbage-collection,
node-health and hygiene controllers, static capacity and the events and
status-condition metrics.

The cases of the JAX package's tests that need no Operator, no
`kube/real`, `kube/serialize` or `nodeoverlay` (each names the
reference test it ports): tests/test_lifecycle_deep.py (registration
sync, initialization gating, launch errors, liveness timeouts),
tests/test_node_repair_breaker.py (the repair circuit breaker's
boundary), tests/test_nodepool_health_surface.py (the
registration-health gauge and snapshot) and tests/test_controllers.py
(garbage collection, node health, static pools, node-pool status and
validation, event dedupe and gauge-store diffing, status-condition
metrics, the scheduler's series, events posted by a provision and
disruption cycle, deep garbage collection).

Each case runs its scenario through both packages (`_both`): once over
the port (`testing.Environment(device="cpu")`, its controllers, objects
and metrics) and once over the JAX package's, each package with its own
names (`PORT`, `JAX`). The reference test's assertions are checked on
each package's run, and the case returns what it observed (conditions,
labels, taints, owners, gauges, counter and histogram-count deltas,
events, controller stats and the fleet without names, `_fleet`), which
must be equal between the two. Claim, node and unnamed pods' names come
from process-wide counters, so no observation holds a name.

Tolerance: exact equality.
"""

import functools
import importlib
import time
from types import SimpleNamespace

import pytest

from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    INSTANCE_TYPE_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.solver import faults, lp_device, solver

# the names each case takes from its package, by module
NAMES = {
    "apis.v1.labels": ["CAPACITY_TYPE_LABEL", "NODE_INITIALIZED_LABEL",
                       "NODE_REGISTERED_LABEL", "UNREGISTERED_TAINT_KEY"],
    "apis.v1.nodeclaim": ["COND_INITIALIZED", "COND_LAUNCHED", "COND_REGISTERED",
                          "RequirementSpec"],
    "apis.v1.nodepool": ["Budget", "COND_NODE_REGISTRATION_HEALTHY",
                         "COND_VALIDATION_SUCCEEDED"],
    "cloudprovider.fake": ["GIB", "make_instance_type"],
    "cloudprovider.types": ["InsufficientCapacityError", "NodeClassNotReadyError",
                            "RepairPolicy"],
    "events.recorder": ["Event", "EventRecorder"],
    "kube.client": ["InvalidError", "KubeClient"],
    "kube.objects": ["NodeCondition", "Taint", "Toleration"],
    "lifecycle.garbagecollection": ["GarbageCollectionController", "NodeHealthController",
                                    "UNHEALTHY_CLUSTER_THRESHOLD"],
    "lifecycle.hygiene": ["NodePoolStatusController"],
    "lifecycle.nodeclaim_lifecycle": ["LAUNCH_TIMEOUT_SECONDS",
                                      "REGISTRATION_TIMEOUT_SECONDS"],
    "metrics.controllers": ["STATUS_CONDITION_COUNT", "STATUS_CONDITION_CURRENT_SECONDS",
                            "STATUS_CONDITION_TRANSITION_SECONDS",
                            "STATUS_CONDITION_TRANSITIONS",
                            "StatusConditionMetricsController", "TRANSITION_BUCKETS"],
    "metrics.store": ["Gauge", "NODEPOOL_REGISTRATION_HEALTHY", "SCHEDULER_IGNORED_PODS",
                      "SCHEDULER_QUEUE_DEPTH", "SCHEDULER_SCHEDULING_DURATION",
                      "SCHEDULER_UNSCHEDULABLE_PODS", "Store"],
    "operator.options": ["FeatureGates", "Options"],
    "provisioning.static": ["StaticCapacityController"],
    "state.nodepoolhealth": ["HealthTracker"],
}


def _package(root: str, device: dict) -> SimpleNamespace:
    """`root`'s names of `NAMES`, its `mk_pod` and `mk_nodepool`, and
    its `Environment` (the port's on `device`)."""
    names = {}
    for module, wanted in NAMES.items():
        mod = importlib.import_module(f"{root}.{module}")
        names.update({n: getattr(mod, n) for n in wanted})
    t = importlib.import_module(f"{root}.testing")
    return SimpleNamespace(root=root, Environment=functools.partial(t.Environment, **device),
                           mk_pod=t.mk_pod, mk_nodepool=t.mk_nodepool, **names)


PORT = _package("karpenter_tpu_torch", {"device": "cpu"})
JAX = _package("karpenter_tpu", {})


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


def _clear():
    jsolver._ffd_floor.clear()
    jsolver._warm_arm.clear()
    jsolver._plan_cache.clear()
    jlp_plan._warm_patterns.clear()
    jlp_device.reset()
    solver.reset_caches()
    lp_device.reset()
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True)
def _clean():
    _clear()
    yield
    _clear()


def _both(case, *args):
    """`case(package, *args)` over the port and over the JAX package;
    their observations must be equal. Returns the port's."""
    port = case(PORT, *args)
    _clear()
    jax_ = case(JAX, *args)
    assert port == jax_, f"port {port!r} != jax {jax_!r}"
    return port


def _fleet(env) -> tuple:
    """The cluster without names: per node (sorted) its instance type,
    zone, capacity type, bound pods, registered and initialized labels
    and taint keys; the pending pods; the claims (deleting ones apart);
    the provider's instances."""
    p_labels = (CAPACITY_TYPE_LABEL, INSTANCE_TYPE_LABEL, TOPOLOGY_ZONE_LABEL)
    nodes = sorted(
        (tuple(n.metadata.labels.get(k, "") for k in p_labels),
         len(env.kube.pods_on_node(n.metadata.name)),
         n.metadata.labels.get("karpenter.sh/registered", ""),
         n.metadata.labels.get("karpenter.sh/initialized", ""),
         tuple(sorted(t.key for t in n.spec.taints)))
        for n in env.kube.nodes())
    claims = env.kube.node_claims()
    pending = sum(1 for p in env.kube.pods() if not p.spec.node_name and not p.is_terminal())
    return (tuple(nodes), pending, len(claims),
            sum(1 for c in claims if c.metadata.deletion_timestamp is not None),
            len(env.cloud.list()))


def _conditions(p, claim) -> tuple:
    return tuple(claim.status_conditions.is_true(c)
                 for c in (p.COND_LAUNCHED, p.COND_REGISTERED, p.COND_INITIALIZED))


def _deleted(env, claims) -> list:
    """Per claim: gone, or deleting, or live."""
    out = []
    for claim in claims:
        live = env.kube.get_node_claim(claim.metadata.name)
        out.append("gone" if live is None
                   else "deleting" if live.metadata.deletion_timestamp is not None
                   else "live")
    return out


# -- the cases of tests/test_lifecycle_deep.py


def _env(p, **env_kwargs):
    env = p.Environment(
        types=[p.make_instance_type("c8", cpu=8, memory=32 * p.GIB)],
        **env_kwargs,
    )
    env.kube.create(p.mk_nodepool("default"))
    return env


class TestRegistrationSync:
    def test_registered_label_and_unregistered_taint(self):
        def case(p):
            env = _env(p)
            env.provision(p.mk_pod(cpu=1.0))
            node = env.kube.nodes()[0]
            assert node.metadata.labels.get(p.NODE_REGISTERED_LABEL) == "true"
            assert not any(
                t.key == p.UNREGISTERED_TAINT_KEY for t in node.spec.taints
            )
            return _fleet(env)

        _both(case)

    def test_claim_labels_annotations_sync_to_node(self):
        def case(p):
            env = p.Environment(types=[
                p.make_instance_type("c8", cpu=8, memory=32 * p.GIB),
            ])
            pool = p.mk_nodepool("default")
            pool.spec.template.labels["team"] = "ml"
            pool.spec.template.annotations["contact"] = "oncall"
            env.kube.create(pool)
            env.provision(p.mk_pod(cpu=1.0))
            node = env.kube.nodes()[0]
            assert node.metadata.labels.get("team") == "ml"
            assert node.metadata.annotations.get("contact") == "oncall"
            return (node.metadata.labels.get("team"),
                    node.metadata.annotations.get("contact"), _fleet(env))

        _both(case)

    def test_node_owned_by_claim(self):
        # registration.go adds the NodeClaim controller reference
        def case(p):
            env = _env(p)
            env.provision(p.mk_pod(cpu=1.0))
            node = env.kube.nodes()[0]
            claim = env.kube.node_claims()[0]
            owners = [r for r in node.metadata.owner_references
                      if r.kind == "NodeClaim"]
            assert owners and owners[0].name == claim.metadata.name
            assert owners[0].controller
            return [(r.kind, r.controller, r.api_version, r.name == claim.metadata.name,
                     r.uid == claim.metadata.uid) for r in owners]

        _both(case)

    def test_owner_reference_not_duplicated(self):
        def case(p):
            env = _env(p)
            env.provision(p.mk_pod(cpu=1.0))
            # re-running registration must not stack references
            env.lifecycle.reconcile_all()
            env.lifecycle.reconcile_all()
            node = env.kube.nodes()[0]
            owners = [r for r in node.metadata.owner_references
                      if r.kind == "NodeClaim"]
            assert len(owners) == 1
            return len(owners), _fleet(env)

        _both(case)

    def test_pool_taints_sync_to_node(self):
        def case(p):
            env = p.Environment(types=[
                p.make_instance_type("c8", cpu=8, memory=32 * p.GIB),
            ])
            pool = p.mk_nodepool("default")
            pool.spec.template.spec.taints = [
                p.Taint(key="dedicated", value="batch", effect="NoSchedule")
            ]
            env.kube.create(pool)
            pod = p.mk_pod(cpu=1.0)
            pod.spec.tolerations = [
                p.Toleration(key="dedicated", operator="Exists")
            ]
            env.provision(pod)
            node = env.kube.nodes()[0]
            assert any(t.key == "dedicated" for t in node.spec.taints)
            return sorted((t.key, t.value, t.effect) for t in node.spec.taints)

        _both(case)


class TestInitializationGating:
    @staticmethod
    def _stalled_claim(p, registration_delay=0.0, startup_taints=()):
        env = p.Environment(
            types=[p.make_instance_type("c8", cpu=8, memory=32 * p.GIB)],
            registration_delay=registration_delay,
        )
        pool = p.mk_nodepool("default")
        pool.spec.template.spec.startup_taints = list(startup_taints)
        env.kube.create(pool)
        return env

    def test_not_initialized_before_registered(self):
        def case(p):
            env = self._stalled_claim(p, registration_delay=3600.0)
            env.provision(p.mk_pod(cpu=1.0))
            claim = env.kube.node_claims()[0]
            assert claim.status_conditions.is_true(p.COND_LAUNCHED)
            assert not claim.status_conditions.is_true(p.COND_REGISTERED)
            assert not claim.status_conditions.is_true(p.COND_INITIALIZED)
            return _conditions(p, claim), _fleet(env)

        _both(case)

    def test_not_initialized_while_node_not_ready(self):
        def case(p):
            env = _env(p)
            env.provision(p.mk_pod(cpu=1.0))
            node = env.kube.nodes()[0]
            claim = env.kube.node_claims()[0]
            assert claim.status_conditions.is_true(p.COND_INITIALIZED)
            # a NEW claim whose node goes NotReady never initializes
            env.kube.create(p.mk_pod(name="more", cpu=7.5))
            env.provisioner.batcher.trigger()
            env.provisioner.reconcile()
            env.lifecycle.reconcile_all()
            env.cloud.tick()
            fresh = [n for n in env.kube.nodes()
                     if n.metadata.name != node.metadata.name]
            assert fresh, "setup: second node never provisioned"
            fresh[0].status.conditions[0].status = "False"
            env.lifecycle.reconcile_all()
            fresh_claim = [
                c for c in env.kube.node_claims()
                if c.status.node_name == fresh[0].metadata.name
            ][0]
            assert not fresh_claim.status_conditions.is_true(p.COND_INITIALIZED)
            return _conditions(p, claim), _conditions(p, fresh_claim), _fleet(env)

        _both(case)

    def test_not_initialized_until_startup_taints_removed(self):
        def case(p):
            env = self._stalled_claim(p, startup_taints=[
                p.Taint(key="cni.example.com/not-ready", value="",
                        effect="NoExecute"),
            ])
            env.provision(p.mk_pod(cpu=1.0))
            claim = env.kube.node_claims()[0]
            node = env.kube.nodes()[0]
            assert claim.status_conditions.is_true(p.COND_REGISTERED)
            assert not claim.status_conditions.is_true(p.COND_INITIALIZED)
            seen = [_conditions(p, claim), _fleet(env)]
            # the CNI daemon removes its taint: initialization completes
            node.spec.taints = [
                t for t in node.spec.taints
                if t.key != "cni.example.com/not-ready"
            ]
            env.kube.update(node)
            env.lifecycle.reconcile_all()
            assert claim.status_conditions.is_true(p.COND_INITIALIZED)
            assert node.metadata.labels.get(p.NODE_INITIALIZED_LABEL) == "true"
            return seen + [_conditions(p, claim), _fleet(env)]

        _both(case)

    def test_not_initialized_until_ephemeral_taints_removed(self):
        def case(p):
            env = _env(p)
            env.provision(p.mk_pod(cpu=1.0))
            node = env.kube.nodes()[0]
            # a fresh ephemeral taint (node.kubernetes.io/*) blocks a NEW
            # claim's initialization; simulate by un-initializing state
            claim = env.kube.node_claims()[0]
            claim.status_conditions.set_false(
                p.COND_INITIALIZED, "Test", "reset", now=time.time()
            )
            node.metadata.labels.pop(p.NODE_INITIALIZED_LABEL, None)
            node.spec.taints.append(
                p.Taint(key="node.kubernetes.io/not-ready", effect="NoExecute")
            )
            env.kube.update(node)
            env.lifecycle.reconcile_all()
            assert not claim.status_conditions.is_true(p.COND_INITIALIZED)
            seen = [_conditions(p, claim), _fleet(env)]
            node.spec.taints = [
                t for t in node.spec.taints
                if t.key != "node.kubernetes.io/not-ready"
            ]
            env.kube.update(node)
            env.lifecycle.reconcile_all()
            assert claim.status_conditions.is_true(p.COND_INITIALIZED)
            return seen + [_conditions(p, claim), _fleet(env)]

        _both(case)

    def test_not_initialized_until_extended_resources_registered(self):
        def case(p):
            env = p.Environment(types=[
                p.make_instance_type("gpu8", cpu=8, memory=32 * p.GIB,
                                     extra_resources={"example.com/gpu": 4.0}),
            ])
            env.kube.create(p.mk_nodepool("default"))
            env.provision(p.mk_pod(cpu=1.0))
            claim = env.kube.node_claims()[0]
            node = env.kube.get_node(claim.status.node_name)
            # simulate the device plugin not having advertised yet
            claim.status_conditions.set_false(
                p.COND_INITIALIZED, "Test", "reset", now=time.time()
            )
            node.metadata.labels.pop(p.NODE_INITIALIZED_LABEL, None)
            claim.spec.resources = {"example.com/gpu": 2.0}
            saved = node.status.allocatable.pop("example.com/gpu")
            env.kube.update(node)
            env.lifecycle.reconcile_all()
            assert not claim.status_conditions.is_true(p.COND_INITIALIZED)
            seen = [_conditions(p, claim), saved]
            node.status.allocatable["example.com/gpu"] = saved
            env.kube.update(node)
            env.lifecycle.reconcile_all()
            assert claim.status_conditions.is_true(p.COND_INITIALIZED)
            return seen + [_conditions(p, claim), _fleet(env)]

        _both(case)


class TestLaunchErrors:
    @staticmethod
    def _launch_failing(p, error) -> list:
        env = _env(p)
        env.cloud.next_create_error = error
        env.kube.create(p.mk_pod(name="w", cpu=1.0))
        env.provisioner.batcher.trigger()
        env.provisioner.reconcile()
        claims = env.kube.node_claims()
        assert claims, "setup: no claim was created"
        env.lifecycle.reconcile_all()
        # ICE is terminal for the claim (lifecycle deletes it; the pod
        # reschedules through a fresh solve)
        for claim in claims:
            live = env.kube.get_node_claim(claim.metadata.name)
            assert live is None or live.metadata.deletion_timestamp is not None
        return [len(claims), _deleted(env, claims), _fleet(env)]

    def test_insufficient_capacity_deletes_claim(self):
        _both(lambda p: self._launch_failing(p, p.InsufficientCapacityError("sold out")))

    def test_node_class_not_ready_deletes_claim(self):
        _both(lambda p: self._launch_failing(p, p.NodeClassNotReadyError("nodeclass gone")))


class TestLivenessTimeouts:
    def test_launch_timeout_deletes_after_window(self):
        def case(p):
            env = _env(p)
            env.cloud.next_create_error = RuntimeError("transient API error")
            env.kube.create(p.mk_pod(name="w", cpu=1.0))
            env.provisioner.batcher.trigger()
            now = time.time()
            env.provisioner.reconcile(now=now)
            claims = env.kube.node_claims()
            assert claims and not claims[0].status_conditions.is_true(
                p.COND_LAUNCHED
            )
            seen = [_conditions(p, claims[0])]
            # inside the window: kept (retried)
            env.cloud.next_create_error = RuntimeError("still failing")
            env.lifecycle.reconcile_all(now=now + p.LAUNCH_TIMEOUT_SECONDS - 10)
            assert env.kube.get_node_claim(claims[0].metadata.name) is not None
            seen.append(_deleted(env, claims))
            # past the window: deleted
            env.cloud.next_create_error = RuntimeError("still failing")
            env.lifecycle.reconcile_all(now=now + p.LAUNCH_TIMEOUT_SECONDS + 10)
            env.reconcile_termination(now=now + p.LAUNCH_TIMEOUT_SECONDS + 11)
            remaining = env.kube.get_node_claim(claims[0].metadata.name)
            assert remaining is None or remaining.metadata.deletion_timestamp
            return seen + [_deleted(env, claims), p.LAUNCH_TIMEOUT_SECONDS]

        _both(case)

    def test_registration_timeout_deletes_after_window(self):
        def case(p):
            env = p.Environment(
                types=[p.make_instance_type("c8", cpu=8, memory=32 * p.GIB)],
                registration_delay=10 * p.REGISTRATION_TIMEOUT_SECONDS,
            )
            env.kube.create(p.mk_nodepool("default"))
            env.kube.create(p.mk_pod(name="w", cpu=1.0))
            env.provisioner.batcher.trigger()
            now = time.time()
            env.provisioner.reconcile(now=now)
            env.lifecycle.reconcile_all(now=now)
            claim = env.kube.node_claims()[0]
            assert claim.status_conditions.is_true(p.COND_LAUNCHED)
            assert not claim.status_conditions.is_true(p.COND_REGISTERED)
            seen = [_conditions(p, claim)]
            env.lifecycle.reconcile_all(
                now=now + p.REGISTRATION_TIMEOUT_SECONDS - 10
            )
            assert claim.metadata.deletion_timestamp is None
            seen.append(_deleted(env, [claim]))
            env.lifecycle.reconcile_all(
                now=now + p.REGISTRATION_TIMEOUT_SECONDS + 10
            )
            assert claim.metadata.deletion_timestamp is not None
            return seen + [_deleted(env, [claim]), p.REGISTRATION_TIMEOUT_SECONDS]

        _both(case)


# -- the cases of tests/test_node_repair_breaker.py


def _policy(p):
    return p.RepairPolicy(
        condition_type="BadDevice", condition_status="True",
        toleration_duration=60.0,
    )


def _cluster(p, n_nodes: int):
    """n one-pod nodes with repair enabled."""
    env = p.Environment(
        types=[p.make_instance_type("c4", cpu=4, memory=16 * p.GIB)]
    )
    env.kube.create(p.mk_nodepool("default"))
    env.provision(
        *[p.mk_pod(name=f"p-{i}", cpu=2.0) for i in range(n_nodes)],
        now=0.0,
    )
    assert len(env.kube.nodes()) == n_nodes
    env.cloud._repair_policies = [_policy(p)]
    controller = p.NodeHealthController(
        env.kube, env.cloud,
        p.Options(feature_gates=p.FeatureGates(node_repair=True)),
    )
    return env, controller


def _mark_unhealthy(p, env, count: int, since: float = 0.0):
    nodes = sorted(env.kube.nodes(), key=lambda n: n.metadata.name)
    for node in nodes[:count]:
        node.status.conditions.append(p.NodeCondition(
            type="BadDevice", status="True",
            last_transition_time=since,
        ))
        env.kube.touch(node)


def _deleting(env) -> list:
    """Per claim, ordered by its node's bound pods: deleting or not."""
    return sorted(
        (tuple(sorted(pod.key for pod in env.kube.pods_on_node(c.status.node_name))),
         c.metadata.deletion_timestamp is not None)
        for c in env.kube.node_claims())


class TestRepairBreakerBoundary:
    def test_exactly_at_threshold_repairs(self):
        """1/5 unhealthy = 20% exactly: NOT strictly greater than the
        threshold, so the breaker stays closed and the node repairs."""
        def case(p):
            env, controller = _cluster(p, 5)
            _mark_unhealthy(p, env, 1)
            assert 1 / 5 == p.UNHEALTHY_CLUSTER_THRESHOLD
            repaired = controller.reconcile(now=100.0)
            assert len(repaired) == 1
            deleting = [
                c for c in env.kube.node_claims()
                if c.metadata.deletion_timestamp is not None
            ]
            assert len(deleting) == 1
            return len(repaired), _deleting(env)

        _both(case)

    def test_one_past_threshold_opens_breaker(self):
        """2/5 unhealthy = 40% > 20%: the breaker opens and NOTHING is
        touched — no claim gains a deletion timestamp, unhealthy nodes
        included."""
        def case(p):
            env, controller = _cluster(p, 5)
            _mark_unhealthy(p, env, 2)
            before = {
                c.metadata.name: c.metadata.deletion_timestamp
                for c in env.kube.node_claims()
            }
            repaired = controller.reconcile(now=100.0)
            assert repaired == []
            after = {
                c.metadata.name: c.metadata.deletion_timestamp
                for c in env.kube.node_claims()
            }
            assert after == before, "open breaker must leave nodes untouched"
            return len(repaired), _deleting(env)

        _both(case)

    def test_breaker_open_is_not_sticky(self):
        """The breaker is a per-reconcile verdict: once the unhealthy
        fraction drops back to the threshold, repairs resume."""
        def case(p):
            env, controller = _cluster(p, 5)
            _mark_unhealthy(p, env, 2)
            assert controller.reconcile(now=100.0) == []
            # one node recovers: its condition flips away from the policy
            nodes = sorted(env.kube.nodes(), key=lambda n: n.metadata.name)
            nodes[0].status.conditions = [
                c for c in nodes[0].status.conditions
                if c.type != "BadDevice"
            ]
            env.kube.touch(nodes[0])
            repaired = controller.reconcile(now=101.0)
            assert len(repaired) == 1
            return len(repaired), _deleting(env)

        _both(case)

    def test_singleton_cluster_repairs_despite_full_unhealthy(self):
        """len(nodes) > 1 gates the breaker: a 100%-unhealthy
        single-node cluster still repairs (abstaining forever would
        wedge it)."""
        def case(p):
            env, controller = _cluster(p, 1)
            _mark_unhealthy(p, env, 1)
            repaired = controller.reconcile(now=100.0)
            assert len(repaired) == 1
            return len(repaired), _deleting(env)

        _both(case)

    def test_toleration_duration_gates_eligibility(self):
        """A condition younger than the policy's toleration never
        counts as unhealthy — neither for repair nor for the breaker
        denominator."""
        def case(p):
            env, controller = _cluster(p, 5)
            _mark_unhealthy(p, env, 1, since=90.0)  # 10s old vs 60s toleration
            repaired = controller.reconcile(now=100.0)
            assert repaired == []
            return len(repaired), _deleting(env)

        _both(case)


# -- the cases of tests/test_nodepool_health_surface.py


class TestHealthGauge:
    def test_record_publishes_gauge(self):
        def case(p):
            gauge = p.NODEPOOL_REGISTRATION_HEALTHY
            tracker = p.HealthTracker()
            tracker.record("pool-g1", True)
            seen = [gauge.value({"nodepool": "pool-g1"})]
            assert seen[-1] == 1.0
            for _ in range(6):
                tracker.record("pool-g1", False)
            seen.append(gauge.value({"nodepool": "pool-g1"}))
            assert seen[-1] == 0.0
            tracker.reset("pool-g1")
            # series dropped, not frozen at the stale verdict
            kept = {"nodepool": "pool-g1"} in [dict(k) for k, _ in gauge.samples()]
            assert not kept
            return seen + [kept]

        _both(case)

    def test_snapshot_reports_degraded_pools(self):
        def case(p):
            tracker = p.HealthTracker()
            tracker.record("good", True)
            for _ in range(5):
                tracker.record("bad", False)
            snap = tracker.snapshot()
            assert snap["tracked_pools"] == 2
            assert list(snap["degraded"]) == ["bad"]
            assert snap["degraded"]["bad"]["recent_failures"] == 5
            assert snap["degraded"]["bad"]["window"] == 5
            return snap

        _both(case)


# -- the cases of tests/test_controllers.py


def types(p):
    return [
        p.make_instance_type("c2", cpu=2, memory=8 * p.GIB, price=2.0),
        p.make_instance_type("c8", cpu=8, memory=32 * p.GIB, price=8.0),
    ]


class TestGarbageCollection:
    def test_leaked_instance_deleted(self):
        def case(p):
            env = p.Environment(types=types(p))
            env.kube.create(p.mk_nodepool("default"))
            env.provision(p.mk_pod())
            # orphan the instance: remove the claim bypassing finalizers
            claim = env.kube.node_claims()[0]
            claim.metadata.finalizers.clear()
            env.kube.delete(claim)
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert stats["leaked_instances"] == 1
            assert not env.cloud.list()
            return stats, _fleet(env)

        _both(case)

    def test_orphaned_claim_deleted(self):
        def case(p):
            env = p.Environment(types=types(p))
            env.kube.create(p.mk_nodepool("default"))
            env.provision(p.mk_pod())
            node = env.kube.nodes()[0]
            node.metadata.finalizers.clear()
            env.kube.delete(node)  # node vanishes (e.g. manual kubectl delete)
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert stats["orphaned_claims"] == 1
            return stats, _fleet(env)

        _both(case)


class TestNodeHealth:
    @staticmethod
    def _env_with_unhealthy(p, n_nodes, n_unhealthy):
        env = p.Environment(types=types(p))
        env.kube.create(p.mk_nodepool("default"))
        for _ in range(n_nodes):
            env.provision(p.mk_pod(cpu=1.5, memory=6 * p.GIB))
        env.cloud._repair_policies = [
            p.RepairPolicy(condition_type="BadDisk", condition_status="True",
                           toleration_duration=60.0)
        ]
        now = time.time()
        for node in env.kube.nodes()[:n_unhealthy]:
            node.status.conditions.append(
                p.NodeCondition(type="BadDisk", status="True",
                                last_transition_time=now - 120)
            )
        return env, now

    def _repair(self, n_nodes, n_unhealthy, gate: bool) -> int:
        def case(p):
            env, now = self._env_with_unhealthy(p, n_nodes, n_unhealthy)
            options = (p.Options(feature_gates=p.FeatureGates(node_repair=True))
                       if gate else p.Options())
            ctrl = p.NodeHealthController(env.kube, env.cloud, options)
            return len(ctrl.reconcile(now=now)), _fleet(env)

        return _both(case)[0]

    def test_unhealthy_node_repaired(self):
        assert self._repair(6, 1, gate=True) == 1

    def test_circuit_breaker_at_20_percent(self):
        assert self._repair(6, 3, gate=True) == 0

    def test_gate_off_no_repair(self):
        assert self._repair(6, 1, gate=False) == 0


class TestStaticPools:
    @staticmethod
    def _static_env(p, replicas=3):
        env = p.Environment(types=types(p))
        pool = p.mk_nodepool("static")
        pool.spec.replicas = replicas
        env.kube.create(pool)
        op_options = p.Options(feature_gates=p.FeatureGates(static_capacity=True))
        ctrl = p.StaticCapacityController(env.kube, env.cluster, op_options)
        return env, ctrl

    def test_scale_up_to_replicas(self):
        def case(p):
            env, ctrl = self._static_env(p, 3)
            ctrl.reconcile_all()
            assert len(env.kube.node_claims()) == 3
            env.lifecycle.reconcile_all()
            env.cloud.tick()
            env.lifecycle.reconcile_all()
            assert len(env.kube.nodes()) == 3
            return _fleet(env)

        _both(case)

    def test_scale_down(self):
        def case(p):
            env, ctrl = self._static_env(p, 3)
            ctrl.reconcile_all()
            env.lifecycle.reconcile_all()
            env.cloud.tick()
            env.lifecycle.reconcile_all()
            pool = env.kube.get_node_pool("static")
            pool.spec.replicas = 1
            ctrl.reconcile_all()
            env.reconcile_termination()
            live = len([c for c in env.kube.node_claims()
                        if c.metadata.deletion_timestamp is None])
            assert live == 1
            return live, _fleet(env)

        _both(case)


class TestNodePoolStatus:
    def test_counter_and_conditions(self):
        def case(p):
            env = p.Environment(types=types(p))
            env.kube.create(p.mk_nodepool("default"))
            env.provision(p.mk_pod())
            ctrl = p.NodePoolStatusController(env.kube, env.cluster)
            ctrl.reconcile_all()
            pool = env.kube.get_node_pool("default")
            assert pool.status.nodes == 1
            assert pool.status.resources.get("cpu", 0) > 0
            assert pool.status_conditions.is_true(p.COND_VALIDATION_SUCCEEDED)
            assert pool.status_conditions.is_true(p.COND_NODE_REGISTRATION_HEALTHY)
            return (pool.status.nodes, sorted(pool.status.resources.items()),
                    pool.status_conditions.is_true(p.COND_VALIDATION_SUCCEEDED),
                    pool.status_conditions.is_true(p.COND_NODE_REGISTRATION_HEALTHY))

        _both(case)

    def test_validation_rejects_bad_budget(self):
        def case(p):
            env = p.Environment(types=types(p))
            pool = p.mk_nodepool("default")
            pool.spec.disruption.budgets = [p.Budget(nodes="nope")]
            # admission layer (the CEL analogue) rejects the create outright
            with pytest.raises(p.InvalidError) as rejected:
                env.kube.create(pool)
            # an object that slipped past admission (hydration/upgrade) is
            # still caught by the runtime validation condition
            pool.spec.disruption.budgets = []
            env.kube.create(pool)
            pool.spec.disruption.budgets = [p.Budget(nodes="nope")]  # in-place
            ctrl = p.NodePoolStatusController(env.kube, env.cluster)
            ctrl.reconcile_all()
            assert pool.status_conditions.is_false(p.COND_VALIDATION_SUCCEEDED)
            return (str(rejected.value),
                    pool.status_conditions.is_false(p.COND_VALIDATION_SUCCEEDED))

        _both(case)


class TestEventsAndMetrics:
    def test_event_dedupe(self):
        def case(p):
            recorder = p.EventRecorder()
            event = p.Event(kind="Pod", name="p", type="Normal", reason="R", message="m")
            now = 1000.0
            published = [recorder.publish(event, now=now),
                         recorder.publish(event, now=now + 1),
                         recorder.publish(event, now=now + 11)]
            assert published == [True, False, True]
            assert recorder.events[0].count == 2
            return published, [e.count for e in recorder.events]

        _both(case)

    def test_gauge_store_diffing(self):
        def case(p):
            gauge = p.Gauge("test")
            store = p.Store(gauge)
            store.update("obj1", [({"a": "1"}, 5.0)])
            seen = [gauge.value({"a": "1"})]
            assert seen[-1] == 5.0
            store.update("obj1", [({"a": "2"}, 7.0)])
            seen += [gauge.value({"a": "1"}), gauge.value({"a": "2"})]
            assert seen[1:] == [0.0, 7.0]
            store.replace_all({})
            seen.append(gauge.value({"a": "2"}))
            assert seen[-1] == 0.0
            return seen

        _both(case)


def _transition_case(p, cond: str):
    """tests/test_controllers.py's transition case on package `p`, with
    the condition type `cond`; counts and sums read against a base."""
    env = p.Environment(types=types(p))
    env.kube.create(p.mk_nodepool("p"))
    env.provision(p.mk_pod(cpu=1.0))
    ctrl = p.StatusConditionMetricsController(env.kube)
    now = time.time()
    ctrl.reconcile_all(now=now)
    claim = env.kube.node_claims()[0]
    labels = {"kind": "NodeClaim", "type": cond, "status": "False"}
    flipped = {"kind": "NodeClaim", "type": cond, "status": "True"}
    base_count = p.STATUS_CONDITION_TRANSITION_SECONDS.count(labels)
    claim.status_conditions.set_false(cond, reason="seed", now=now)
    ctrl.reconcile_all(now=now)
    # False for 3s, then flips True: histogram observes ~3s in the
    # PREVIOUS (False) state; counter counts the transition
    claim.status_conditions.set_true(cond, now=now + 3)
    before = p.STATUS_CONDITION_TRANSITIONS.value(flipped)
    base_sum = p.STATUS_CONDITION_TRANSITION_SECONDS.sum(labels)
    ctrl.reconcile_all(now=now + 3)
    transitions = p.STATUS_CONDITION_TRANSITIONS.value(flipped) - before
    observed_count = p.STATUS_CONDITION_TRANSITION_SECONDS.count(labels) - base_count
    assert transitions == 1
    assert observed_count == 1
    observed = p.STATUS_CONDITION_TRANSITION_SECONDS.sum(labels) - base_sum
    assert 2.5 <= observed <= 3.5
    # exponential buckets exactly as the reference's
    assert p.TRANSITION_BUCKETS[0] == 0.5
    assert p.TRANSITION_BUCKETS[-1] == 8192.0
    assert len(p.TRANSITION_BUCKETS) == 15
    return transitions, observed_count, tuple(p.TRANSITION_BUCKETS)


class TestStatusConditionMetrics:
    """The operatorpkg status.Controller analogue
    (controllers.go:113-131): per-kind condition-count gauges, a
    transitions counter, and exponential-bucket transition-latency
    histograms for NodeClaim / NodePool / Node."""

    def test_transition_counter_and_histogram(self):
        # a condition type no JAX test reads: the JAX package's
        # histogram is process-wide, and tests/test_controllers.py reads
        # the sum of its "TestCond" series as an absolute value
        _both(_transition_case, "PortTestCond")

    def test_port_case_leaves_the_jax_absolute_sum_alone(self):
        """The repair above, shown: the port's case, then the JAX
        test's own absolute assertion (tests/test_controllers.py, the
        "TestCond" sum in [2.5, 3.5]) on a fresh JAX Environment in the
        same process. The JAX package's series are saved first (the JAX
        test may have run earlier in this process) and restored after."""
        from karpenter_tpu.metrics import controllers as jmc

        hist = jmc.STATUS_CONDITION_TRANSITION_SECONDS
        series = {m: {a: dict(getattr(m, a)) for a in ("_values", "_counts", "_sums", "_totals")
                      if hasattr(m, a)}
                  for m in (hist, jmc.STATUS_CONDITION_TRANSITIONS, jmc.STATUS_CONDITION_COUNT,
                            jmc.STATUS_CONDITION_CURRENT_SECONDS)}
        labels = {"kind": "NodeClaim", "type": "TestCond", "status": "False"}
        try:
            for held in (hist._counts, hist._sums, hist._totals):
                held.pop(tuple(sorted(labels.items())), None)
            _both(_transition_case, "PortTestCond")
            _clear()
            env = JAX.Environment(types=types(JAX))
            env.kube.create(JAX.mk_nodepool("p"))
            env.provision(JAX.mk_pod(cpu=1.0))
            ctrl = JAX.StatusConditionMetricsController(env.kube)
            now = time.time()
            ctrl.reconcile_all(now=now)
            claim = env.kube.node_claims()[0]
            claim.status_conditions.set_false("TestCond", reason="seed", now=now)
            ctrl.reconcile_all(now=now)
            claim.status_conditions.set_true("TestCond", now=now + 3)
            ctrl.reconcile_all(now=now + 3)
            assert hist.count(labels) == 1
            assert 2.5 <= hist.sum(labels) <= 3.5
        finally:
            for metric, attrs in series.items():
                for attr, held in attrs.items():
                    setattr(metric, attr, held)

    def test_condition_count_gauge_tracks_all_kinds(self):
        def case(p):
            env = p.Environment(types=types(p))
            pool = p.mk_nodepool("p")
            env.kube.create(pool)
            env.provision(p.mk_pod(cpu=1.0))
            # nodepool conditions are produced by the status controller in
            # the full runtime; stamp one directly here
            pool.status_conditions.set_true(p.COND_VALIDATION_SUCCEEDED)
            ctrl = p.StatusConditionMetricsController(env.kube)
            ctrl.reconcile_all(now=time.time())
            series = p.STATUS_CONDITION_COUNT.series()
            kinds = {dict(k).get("kind") for k in series if series[k] > 0}
            assert {"NodeClaim", "NodePool", "Node"} <= kinds
            # each live series without its object's name
            return sorted((tuple(sorted((a, b) for a, b in dict(k).items() if a != "name")), v)
                          for k, v in series.items() if v > 0)

        _both(case)

    def test_vanished_object_drops_series(self):
        def case(p):
            env = p.Environment(types=types(p))
            env.kube.create(p.mk_nodepool("p"))
            pod = p.mk_pod(cpu=1.0)
            env.provision(pod)
            ctrl = p.StatusConditionMetricsController(env.kube)
            now = time.time()
            ctrl.reconcile_all(now=now)
            claim = env.kube.node_claims()[0]
            name = claim.metadata.name

            def held() -> list:
                return sorted(dict(k).get("type", "")
                              for k in p.STATUS_CONDITION_CURRENT_SECONDS.series()
                              if dict(k).get("name") == name
                              and dict(k).get("kind") == "NodeClaim")

            seen = [held()]
            assert seen[0]
            env.kube.delete(env.kube.get_pod("default", pod.metadata.name))
            env.kube.delete(claim)
            env.reconcile_termination(now=now + 60)
            ctrl.reconcile_all(now=now + 60)
            seen.append(held())
            assert not seen[-1]
            return seen, _fleet(env)

        _both(case)


class TestSchedulerMetrics:
    """Scheduler-subsystem series (provisioning/scheduling/metrics.go:
    33-95): duration histogram, queue depth, unschedulable and
    ignored pod gauges, all updated by a real solve."""

    def test_solve_updates_scheduler_series(self):
        def case(p):
            env = p.Environment(types=[p.make_instance_type("c4", cpu=4)])
            env.kube.create(p.mk_nodepool("p"))
            labels = {"controller": "provisioner"}
            before = p.SCHEDULER_SCHEDULING_DURATION.count(labels)
            foreign = p.mk_pod(name="foreign")
            foreign.spec.scheduler_name = "other-scheduler"
            env.provision(p.mk_pod(name="ok"), p.mk_pod(name="giant", cpu=999.0),
                          foreign)
            solves = p.SCHEDULER_SCHEDULING_DURATION.count(labels) - before
            assert solves > 0
            seen = (solves, p.SCHEDULER_QUEUE_DEPTH.value(labels),
                    p.SCHEDULER_UNSCHEDULABLE_PODS.value(labels),
                    p.SCHEDULER_IGNORED_PODS.value())
            assert seen[1] == 0.0  # solve finished
            assert seen[2] == 1.0  # the giant
            assert seen[3] == 1.0  # foreign scheduler
            return seen, _fleet(env)

        _both(case)


class TestKubeEvents:
    """corev1 Events reach the API substrate (events/recorder.go:52-72:
    the reference posts through record.EventRecorder; operators debug
    via kubectl describe). Dedupe bumps count on the SAME Event object
    instead of spamming new ones."""

    def test_provision_and_disruption_cycle_posts_events(self):
        def case(p):
            env = p.Environment(types=[
                p.make_instance_type("c2", cpu=2, memory=8 * p.GIB, price=2.0),
                p.make_instance_type("c8", cpu=8, memory=32 * p.GIB, price=5.0),
            ])
            pool = p.mk_nodepool("default")
            pool.spec.disruption.consolidate_after = "0s"
            # pin to on-demand: a spot-launched candidate would put
            # single-node consolidation behind the 15-type spot-to-spot
            # rule, which this 2-type catalog can't satisfy
            pool.spec.template.spec.requirements = [
                p.RequirementSpec(key=p.CAPACITY_TYPE_LABEL, operator="In",
                                  values=("on-demand",)),
            ]
            env.kube.create(pool)
            env.provision(*[p.mk_pod(cpu=0.5) for _ in range(4)])
            events = env.kube.list("Event")
            nominated = [e for e in events if e.reason == "Nominated"]
            assert len(nominated) == 4
            assert all(e.involved_kind == "Pod" for e in nominated)
            assert all(e.metadata.namespace == "default" for e in nominated)
            # unschedulable pod -> FailedScheduling Warning
            env.provision(p.mk_pod(name="huge", cpu=10000.0))
            failed = [e for e in env.kube.list("Event")
                      if e.reason == "FailedScheduling"]
            assert failed and failed[0].type == "Warning"
            assert failed[0].involved_name == "huge"
            seen = [len(nominated), [(e.type, e.involved_kind, e.involved_name)
                                     for e in failed], _fleet(env)]
            # consolidation cycle (most of the workload leaves -> the node
            # is underutilized) -> DisruptionTerminating on the candidates
            # and Evicted on the drained pods. The pending huge pod must go
            # first: unschedulable pods gate disruption.
            env.kube.delete(env.kube.get_pod("default", "huge"))
            for pod in [q for q in env.kube.pods() if q.spec.node_name][:3]:
                env.kube.delete(pod)
            now = time.time() + 120
            for i in range(12):
                env.reconcile_disruption(now=now + i * 11)
            reasons = {e.reason for e in env.kube.list("Event")}
            assert "DisruptionTerminating" in reasons
            assert "Evicted" in reasons
            return seen + [sorted(reasons), _fleet(env)]

        _both(case)

    def test_dedupe_bumps_count_on_posted_event(self):
        def case(p):
            kube = p.KubeClient()
            rec = p.EventRecorder(kube=kube)
            ev = p.Event(kind="Node", name="n-1", type="Normal",
                         reason="Waiting", message="same thing")
            assert rec.publish(ev, now=100.0)
            assert not rec.publish(ev, now=103.0)  # deduped
            assert not rec.publish(ev, now=106.0)
            posted = kube.list("Event")
            assert len(posted) == 1
            assert posted[0].count == 3
            assert posted[0].last_timestamp == 106.0
            assert posted[0].first_timestamp == 100.0
            seen = [(e.count, e.first_timestamp, e.last_timestamp) for e in posted]
            # past the TTL: a fresh Event object is posted
            assert rec.publish(ev, now=120.0)
            assert len(kube.list("Event")) == 2
            return seen, sorted((e.count, e.first_timestamp, e.last_timestamp)
                                for e in kube.list("Event"))

        _both(case)

    def test_rate_limited_events_never_reach_the_server(self):
        def case(p):
            kube = p.KubeClient()
            rec = p.EventRecorder(kube=kube)
            published = [rec.publish(p.Event(kind="Node", name=f"n-{i}", type="Warning",
                                             reason="Flood", message=f"m{i}"), now=50.0)
                         for i in range(25)]
            assert len(kube.list("Event")) == rec.RATE_LIMIT_PER_REASON
            return published, len(kube.list("Event"))

        _both(case)


class TestGarbageCollectionDeep:
    """nodeclaim/garbagecollection suite depth: instance-vs-claim-vs-
    node disagreement matrix (garbagecollection/controller.go:60-118)."""

    @staticmethod
    def _env(p):
        env = p.Environment(types=[
            p.make_instance_type("c8", cpu=8, memory=32 * p.GIB),
        ])
        env.kube.create(p.mk_nodepool("default"))
        env.provision(p.mk_pod(cpu=1.0))
        return env

    def test_claim_deleted_when_registered_node_vanishes(self):
        def case(p):
            env = self._env(p)
            node = env.kube.nodes()[0]
            claim = env.kube.node_claims()[0]
            # the node object disappears out from under a registered claim
            node.metadata.finalizers.clear()
            env.kube.delete(node)
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert stats["orphaned_claims"] == 1
            live = env.kube.get_node_claim(claim.metadata.name)
            assert live is None or live.metadata.deletion_timestamp is not None
            return stats, _deleted(env, [claim]), _fleet(env)

        _both(case)

    def test_unregistered_claim_not_garbage_collected(self):
        # GC only fires for REGISTERED claims whose node vanished; an
        # in-flight claim is the liveness controller's job
        def case(p):
            env = p.Environment(
                types=[p.make_instance_type("c8", cpu=8, memory=32 * p.GIB)],
                registration_delay=3600.0,
            )
            env.kube.create(p.mk_nodepool("default"))
            env.provision(p.mk_pod(cpu=1.0))
            claim = env.kube.node_claims()[0]
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert stats["orphaned_claims"] == 0
            assert env.kube.get_node_claim(claim.metadata.name) is not None
            return stats, _deleted(env, [claim]), _fleet(env)

        _both(case)

    def test_leaked_instance_with_no_claim_deleted(self):
        def case(p):
            env = self._env(p)
            # simulate a claim wiped without finalization (etcd loss):
            # the instance remains provider-side with no claim
            for c in list(env.kube.node_claims()):
                c.metadata.finalizers.clear()
                env.kube.delete(c)
            assert env.cloud.list()
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert not env.cloud.list()
            return stats, _fleet(env)

        _both(case)

    def test_instance_backing_live_claim_kept(self):
        def case(p):
            env = self._env(p)
            before = len(env.cloud.list())
            gc = p.GarbageCollectionController(env.kube, env.cloud)
            stats = gc.reconcile()
            assert stats["leaked_instances"] == 0
            assert len(env.cloud.list()) == before
            return stats, _fleet(env)

        _both(case)
