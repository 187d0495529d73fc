"""The port's provisioning path held against the JAX package's.

Each `testing.ProvisionCase` is built twice from the same plain data:
once with the port's constructors (`testing.provision_env`) and once
with the JAX package's (`testing.build_env(case, jax_api())`). Both
Provisioners run two `reconcile` rounds (the second after the case's
extra pods arrive, so pods land on the first round's in-flight
claims). Both packages' incremental tick is switched off
(KARPENTER_INCREMENTAL=0): these tests hold the full Scheduler path
(the tick, the default, is held in test_torch_incremental_tick.py).
Claim names come from each
package's process-wide counter, so decisions are compared
name-insensitively (`testing.decision_fingerprint`) with in-flight
claims named by creation order. Every comparison is exact.
"""

from types import SimpleNamespace

import pytest

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.testing import CASE_T0

CASES = testing.provision_cases(0)
CASE_IDS = [c.name for c in CASES]


def jax_api():
    """The JAX package's modules under `testing.package_api()`'s names."""
    from karpenter_tpu.apis.v1 import labels, nodeclaim, nodepool
    from karpenter_tpu.cloudprovider import fake
    from karpenter_tpu.kube import client, objects
    from karpenter_tpu.operator import options
    from karpenter_tpu.provisioning import provisioner
    from karpenter_tpu.state import cluster

    return SimpleNamespace(
        labels=labels, nodeclaim=nodeclaim, nodepool=nodepool, fake=fake,
        objects=objects, client=client, cluster=cluster,
        provisioner=provisioner, options=options,
    )


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


def _created(env, results) -> list:
    return [env.kube.get_node_claim(p.claim_name)
            for p in results.new_node_plans if p.claim_name]


def two_rounds(env, case) -> dict:
    """Round 1 over the case's pending pods, round 2 after its extra
    pods arrive; what each round decided and created, and the mirror
    after each."""
    out = {}
    r1 = env.provisioner.reconcile(now=CASE_T0 + 10)
    c1 = _created(env, r1)
    out["mirror1"] = testing.mirror_state(env.cluster, testing.claim_names(c1))
    for pod in env.objects["extra"]:
        env.kube.create(pod)
    r2 = env.provisioner.reconcile(now=CASE_T0 + 20)
    c2 = _created(env, r2)
    names = testing.claim_names(c1 + c2)
    out["round1"] = testing.decision_fingerprint(r1)
    out["round2"] = testing.decision_fingerprint(r2, names)
    out["claims1"] = testing.claim_contents(c1)
    out["claims2"] = testing.claim_contents(c2)
    out["mirror2"] = testing.mirror_state(env.cluster, names)
    out["counts"] = (len(c1), len(c2), len(r2.existing_assignments),
                     len(r1.errors), len(r2.errors))
    return out


def both(case):
    port = two_rounds(testing.provision_env(case, "cpu"), case)
    ref = two_rounds(testing.build_env(case, jax_api()), case)
    return port, ref


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_two_reconcile_rounds_match_jax(case):
    port, ref = both(case)
    for key in ("round1", "claims1", "mirror1", "round2", "claims2",
                "mirror2", "counts"):
        assert port[key] == ref[key], (case.name, key)
    n1, n2, n_existing, _, _ = port["counts"]
    assert n1 + n2 > 0 or case.name == "priority-limit"


def test_cases_reach_what_they_name():
    """The fixtures drive the features they are named for (on the
    port; the test above holds the JAX package to the same)."""
    by = {c.name: c for c in CASES}
    seen = {}
    for name in ("plain", "min-values-strict", "min-values-besteffort",
                 "priority-limit", "reserved", "spread-anti"):
        env = testing.provision_env(by[name], "cpu")
        r1 = env.provisioner.reconcile(now=CASE_T0 + 10)
        c1 = _created(env, r1)
        for pod in env.objects["extra"]:
            env.kube.create(pod)
        r2 = env.provisioner.reconcile(now=CASE_T0 + 20)
        seen[name] = (r1, r2, c1 + _created(env, r2))
    r1, r2, _ = seen["plain"]
    assert {"node-a", "node-b"} <= set(r1.existing_assignments)
    assert any(k.startswith("default-") for k in r2.existing_assignments)
    assert any(e.startswith("minValues")
               for e in seen["min-values-strict"][0].errors.values())
    claims = seen["min-values-besteffort"][2]
    assert any(c.metadata.annotations.get(
        "karpenter.sh/nodeclaim-min-values-relaxed") == "true" for c in claims)
    r1 = seen["priority-limit"][0]
    assert r1.errors and r1.new_node_plans
    claims = seen["reserved"][2]
    assert any(r.key == "karpenter.sh/reservation-id"
               for c in claims for r in c.spec.requirements)
    assert seen["spread-anti"][0].existing_assignments


def test_cluster_mirror_follows_the_same_event_stream():
    """Both mirrors through one stream: a round's claims, the
    provider's launches written back to the claims, their nodes
    registered, pods bound to new and existing nodes, a pod and a
    claim deleted."""
    case = CASES[0]
    states = []
    for api, env in ((testing.package_api(), testing.provision_env(case, "cpu")),
                     (jax_api(), testing.build_env(case, jax_api()))):
        o = api.objects
        r1 = env.provisioner.reconcile(now=CASE_T0 + 10)
        claims = _created(env, r1)
        names = testing.claim_names(claims)
        steps = [testing.mirror_state(env.cluster, names)]
        for claim in claims:
            launched = env.cloud.create(claim)
            claim.status.provider_id = launched.status.provider_id
            claim.status.capacity = dict(launched.status.capacity)
            claim.status.allocatable = dict(launched.status.allocatable)
            env.kube.update(claim)
        steps.append(testing.mirror_state(env.cluster, names))
        for claim in claims:
            node_name = f"n-{names[claim.metadata.name]}"
            claim.status.node_name = node_name
            env.kube.update(claim)
            env.kube.create(o.Node(
                metadata=o.ObjectMeta(
                    name=node_name, namespace="", uid=f"uid-{node_name}",
                    labels=dict(claim.metadata.labels),
                    creation_timestamp=CASE_T0 + 11),
                spec=o.NodeSpec(provider_id=claim.status.provider_id),
                status=o.NodeStatus(capacity=dict(claim.status.capacity),
                                    allocatable=dict(claim.status.allocatable)),
            ))
        steps.append(testing.mirror_state(env.cluster, names))
        for plan in r1.new_node_plans:
            for pod in plan.pods[:2]:
                env.kube.bind_pod(pod, f"n-{names[plan.claim_name]}")
        steps.append(testing.mirror_state(env.cluster, names))
        for key, pods in sorted(r1.existing_assignments.items()):
            for pod in pods[:1]:
                env.kube.bind_pod(pod, key)
        victim = env.kube.get_pod("default", "bound-a-0")
        env.kube.delete(victim, now=CASE_T0 + 30)
        steps.append(testing.mirror_state(env.cluster, names))
        env.kube.delete(claims[0], now=CASE_T0 + 40)
        steps.append(testing.mirror_state(env.cluster, names))
        states.append(steps)
    assert states[0] == states[1]
    # the stream moved the mirror: nodes registered, pods bound
    first, registered, bound = states[0][0], states[0][2], states[0][3]
    assert first != registered != bound
    assert any(row[0].startswith("n-claim-") and row[6] for row in bound[0])


def test_explain_record_of_an_unschedulable_round_matches_jax():
    """One round with an explain record open, where some pods can
    never schedule: the port's notes and funnels equal the JAX
    package's."""
    from karpenter_tpu import explain as jexplain
    from karpenter_tpu.events.recorder import EventRecorder as JRecorder
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.events.recorder import EventRecorder

    case = testing.ProvisionCase(
        "unschedulable",
        pods=[testing._pod(f"e-{i}", 1.0, 2.0) for i in range(8)]
        + [testing._pod("e-huge", 999.0, 1.0),
           testing._pod("e-label", 1.0, 1.0, node_selector={"custom": "x"}),
           testing._pod("e-zone", 1.0, 1.0,
                        node_selector={"topology.kubernetes.io/zone": "nowhere"})],
        pools=[dict(name="default"),
               dict(name="tainted", weight=10,
                    taints=[("dedicated", "gpu", "NoSchedule")])],
    )
    out = []
    for mod, env, rec in (
        (explain, testing.provision_env(case, "cpu"), EventRecorder),
        (jexplain, testing.build_env(case, jax_api()), JRecorder),
    ):
        mod.clear()
        env.provisioner.recorder = rec(kube=None)
        with mod.tick("t-explain"):
            results = env.provisioner.reconcile(now=CASE_T0 + 10)
        record = mod.find_tick("t-explain")
        pods = {k: mod.find_pod(k) for k in sorted(results.errors)}
        recorded = [e.event for e in env.provisioner.recorder.events]
        # Nominated messages name claims (process-wide counter names)
        events = ([(e.reason, e.message) for e in recorded
                   if e.reason != "Nominated"],
                  sorted(e.name for e in recorded if e.reason == "Nominated"))
        out.append((sorted(results.errors.items()), record["pods"], pods,
                    events))
        mod.clear()
    assert out[0] == out[1]
    errors, pods = out[0][0], out[0][2]
    assert {k for k, _ in errors} == {"default/e-huge", "default/e-label",
                                      "default/e-zone"}
    assert all(p is not None and p.get("funnel") for p in pods.values())


# -- the problems and the flow of chip_smoke.py's phase 13, cut to size ------


def _bench_rounds(api):
    """`build_problem`'s pods in two rounds (`testing.reconcile_rounds`:
    the first round's claims launched in flight, then more pods)."""
    import bench

    if api is None:
        from karpenter_tpu_torch.workloads import build_problem

        pods, pools = build_problem(400, 30, seed=42)
        extra, _ = build_problem(80, 30, seed=43, name_prefix="extra-")
        env = testing.pods_env(pods, pools, device="cpu")
    else:
        pods, pools = bench.build_problem(400, 30, seed=42)
        extra, _ = bench.build_problem(80, 30, seed=43)
        for i, pod in enumerate(extra):
            pod.metadata.name = f"extra-{i}"
        env = testing.pods_env(pods, pools, api=api)
    return testing.reconcile_rounds(env, [extra])


def _topology(api):
    from karpenter_tpu_torch import workloads

    if api is None:
        from karpenter_tpu_torch.apis.v1.nodepool import NodePool
        from karpenter_tpu_torch.cloudprovider.fake import instance_types
        from karpenter_tpu_torch.kube.objects import ObjectMeta
        from karpenter_tpu_torch.provisioning.scheduler import Scheduler

        pods, kw = workloads.topology_pods(120, 6), {"device": "cpu"}
    else:
        import bench
        from karpenter_tpu.apis.v1.nodepool import NodePool
        from karpenter_tpu.cloudprovider.fake import instance_types
        from karpenter_tpu.kube.objects import ObjectMeta
        from karpenter_tpu.provisioning.scheduler import Scheduler

        pods, kw = bench._topology_pods(120, 6), {}
    pool = NodePool(metadata=ObjectMeta(name="default"))
    sched = Scheduler(pools_with_types=[(pool, instance_types(30))],
                      clock=lambda: CASE_T0, **kw)
    return testing.decision_fingerprint(sched.solve(pods))


def _mixed(api):
    """`workloads.mixed_problem` against `bench.py::scenario_mixed`'s
    set-up, rebuilt with the JAX package's constructors."""
    if api is None:
        from karpenter_tpu_torch.workloads import mixed_problem

        pods, pools = mixed_problem(600, 60, 20)
        env = testing.pods_env(pods, pools, device="cpu")
    else:
        import bench
        from karpenter_tpu.apis.v1.nodepool import NodePool
        from karpenter_tpu.cloudprovider.fake import heterogeneous_instance_types
        from karpenter_tpu.kube.objects import ObjectMeta, Taint, Toleration

        pods, pools = bench.build_problem(600, 60)
        tainted = NodePool(metadata=ObjectMeta(name="tainted"))
        tainted.spec.weight = 50
        tainted.spec.template.spec.taints = [
            Taint(key="dedicated", value="batch", effect="NoSchedule")]
        for i, pod in enumerate(pods):
            if i % 5 == 0:
                pod.spec.tolerations = [Toleration(
                    key="dedicated", operator="Equal", value="batch",
                    effect="NoSchedule")]
        pools = [(pools[0][0], heterogeneous_instance_types(60)),
                 (tainted, heterogeneous_instance_types(20))]
        env = testing.pods_env(pods, pools, api=api)
    return testing.reconcile_rounds(env, [])


@pytest.mark.parametrize("problem", ["benchmark", "topology", "mixed"])
def test_smoke_problems_match_jax(problem):
    """Phase 13's three problems, cut to size, through both packages:
    the port's builders (`workloads.topology_pods`, `mixed_problem`)
    equal bench.py's, and the rounds decide alike."""
    if problem == "topology":
        port, ref = _topology(None), _topology(jax_api())
        assert port[0] and port == ref
        return
    run = _bench_rounds if problem == "benchmark" else _mixed
    port, ref = run(None), run(jax_api())
    assert port["fingerprints"] == ref["fingerprints"]
    assert [testing.claim_contents(c) for c in port["claims"]] == \
        [testing.claim_contents(c) for c in ref["claims"]]
    if problem == "benchmark":
        # the second round lands pods on the first round's claims
        assert port["results"][1].existing_assignments
    else:
        pools = {p.pool.metadata.name for p in port["results"][0].new_node_plans}
        assert pools == {"default", "tainted"}
