"""The consolidation engine, held against the JAX package.

Both packages provision one `ProvisionCase` into a fleet of small nodes
(`testing.place`: a Provisioner round, its claims launched and
registered, its pods bound), the same changes are made to both (a
seeded scale-down, emptied nodes, drifted claims, annotations, PDBs,
budgets), and then:

- each of the five methods (`emptiness`, `drift`,
  `global_repack_consolidation`, `multi_node_consolidation`,
  `single_node_consolidation`) must decide the same command
  (`testing.command_identity`: reason, candidates by node name, plans by
  pool, price, pods and types) and write the same explain verdicts;
- a whole `reconcile` + queue loop (`testing.disruption_rounds`: the
  replacements launched and registered, validation, the candidates
  terminated through `KubeClient.evict`, the displaced pods placed
  again) must run round for round as the JAX package's, to the same
  fleet;
- the candidate scan must keep the families of
  `tests/test_disruption_oracle.py` (do-not-disrupt pods and nodes,
  daemonset and mirror pods, terminal pods, PDB blocking, eviction cost,
  budget counts), and validation its rollbacks and retries.

Every comparison is exact. Both packages get one fixed clock (the
engine's deadlines never fire), one `now` per step, and the cost
objective's MIPs stop at the root node (`testing.root_node_mips`).
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import lp_device, lp_plan, solver

from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import solver as jsolver

T0 = testing.DISRUPTION_T0
SMALL = ("custom", (("c2", 2, 8, 2.0), ("c4", 4, 16, 3.0), ("c8", 8, 32, 5.0)), 1)
SHAPES = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (1.5, 2.0), (0.5, 4.0), (1.0, 0.5)]
METHODS = ["emptiness", "drift", "global_repack_consolidation",
           "multi_node_consolidation", "single_node_consolidation"]


def jax_api():
    from karpenter_tpu import explain
    from karpenter_tpu.apis.v1 import labels, nodeclaim, nodepool
    from karpenter_tpu.cloudprovider import fake
    from karpenter_tpu.disruption import conditions, engine, validation
    from karpenter_tpu.events import recorder
    from karpenter_tpu.kube import client, objects
    from karpenter_tpu.metrics import store
    from karpenter_tpu.operator import options
    from karpenter_tpu.provisioning import provisioner
    from karpenter_tpu.state import cluster, retained
    from karpenter_tpu.utils import pdb

    return SimpleNamespace(
        labels=labels, nodeclaim=nodeclaim, nodepool=nodepool, fake=fake,
        objects=objects, client=client, cluster=cluster,
        provisioner=provisioner, store=store, engine=engine,
        conditions=conditions, validation=validation, recorder=recorder,
        options=options, pdb=pdb, retained=retained, explain=explain,
    )


def port_api():
    from karpenter_tpu_torch import explain

    api = testing.package_api()
    api.explain = explain
    return api


PACKAGES = {"port": (port_api, {"device": "cpu"}), "jax": (jax_api, {})}


def clear_caches():
    jsolver._ffd_floor.clear()
    jsolver._warm_arm.clear()
    jsolver._plan_cache.clear()
    jlp_plan._warm_patterns.clear()
    jlp_device.reset()
    solver.reset_caches()
    lp_device.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("KARPENTER_BATCH_PROBES", "KARPENTER_LP_PRUNE", "KARPENTER_FAULTS",
                 "KARPENTER_DISRUPTION_SNAPSHOT", "KARPENTER_DISRUPTION_SNAPSHOT_AUDIT",
                 "KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_SPOT_PENALTY",
                 "KARPENTER_INCREMENTAL", "KARPENTER_SOLVER_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    clear_caches()
    monkeypatch.setattr(jlp_plan, "_TIME_BUDGET_S", 1e6)
    monkeypatch.setattr(lp_plan, "_TIME_BUDGET_S", 1e6)
    with testing.root_node_mips():
        yield monkeypatch
    clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (see test_torch_provisioning.py)."""
    with testing.one_core():
        yield


def fleet_case(seed: int, n_nodes: int = 24, n_pending: int = 40,
               catalog=SMALL, **kw) -> testing.ProvisionCase:
    """A seeded fleet of `n_nodes` nodes of 2, 4 and 8 cpu (claims with
    the termination finalizer), each bound to pods of six small shapes
    up to 50-90% of its cpu and memory, and `n_pending` pending pods
    that the first provisioning round places (on new 8-cpu nodes). A
    quarter of the pods are labelled `app` (for PDBs)."""
    rng = np.random.default_rng(seed)
    counter = iter(range(10**6))

    def pod(prefix):
        i = next(counter)
        cpu, mem = SHAPES[int(rng.integers(len(SHAPES)))]
        d = testing._pod(f"{prefix}-{i}", cpu, mem)
        if i % 4 == 0:
            d["labels"] = {"app": f"a-{i % 3}"}
        return d

    nodes = []
    for k in range(n_nodes):
        t = int(rng.choice(3, p=[0.4, 0.35, 0.25]))
        cap = (2.0, 4.0, 8.0)[t]
        fill = cap * float(rng.uniform(0.5, 0.9))
        pods, cpu, mem = [], 0.0, 0.0
        while True:
            d = pod(f"b{k}")
            if cpu + d["cpu"] > fill or mem + d["mem"] > 3.5 * cap:
                break
            pods.append(d)
            cpu, mem = cpu + d["cpu"], mem + d["mem"]
        nodes.append(dict(name=f"node-{k:02d}", type=t, pool="default",
                          zone=testing.ZONES[k % 3], pods=pods, finalizer=True))
    return testing.ProvisionCase(
        f"fleet-{seed}", pods=[pod("w") for _ in range(n_pending)],
        pools=[dict(name="default")], catalog=catalog, nodes=nodes, **kw)


def world(package: str, case, prep=None, seed: int = 0, options=None):
    """`package`'s fleet for `case`, provisioned and settled at T0, then
    `prep(env, api)` (changes made between T0 + 40 and T0 + 60)."""
    make, kwargs = PACKAGES[package]
    api = make()
    testing.reset_counters(api)
    env = testing.build_env(case, api, **kwargs)
    testing.disruption_env(env, options=options, seed=seed)
    testing.place(env, T0)
    if prep is not None:
        prep(env, api)
    return env, api


def scale_down(share: float = 0.5, seed: int = 5, empty: int = 0):
    """Delete a seeded `share` of the bound pods, and every pod of the
    first `empty` nodes by name."""
    def prep(env, api):
        nodes = sorted(n.metadata.name for n in env.kube.nodes())
        gone = set()
        for name in nodes[:empty]:
            gone |= {p.key for p in env.kube.pods_on_node(name)}
        bound = sorted((p for p in env.kube.pods() if p.spec.node_name),
                       key=lambda p: p.key)
        pick = np.random.default_rng(seed).choice(
            len(bound), size=int(len(bound) * share), replace=False)
        gone |= {bound[int(i)].key for i in pick}
        for key in sorted(gone):
            ns, name = key.split("/", 1)
            env.kube.delete(env.kube.get_pod(ns, name), now=T0 + 50)
    return prep


def drifted(every: int = 3):
    """Every `every`-th node's claim drifts (the provider reports it)."""
    def prep(env, api):
        names = sorted(n.metadata.name for n in env.kube.nodes())[::every]
        env.cloud.is_drifted = lambda claim: (
            "ImageDrift" if claim.status.node_name in names else "")
    return prep


def both(*preps):
    def prep(env, api):
        for p in preps:
            p(env, api)
    return prep


def candidates_of(env, reason: str, now: float) -> list:
    return [(c.state_node.name, c.instance_type_name, c.capacity_type, c.zone,
             round(c.price, 9), round(c.disruption_cost, 9),
             tuple(sorted(p.key for p in c.reschedulable_pods)))
            for c in env.disruption.get_candidates(reason, now)]


def decide(env, api, method: str, now: float) -> tuple:
    """The conditions controllers at `now`, then `method` under an open
    explain record: the command's identity and the verdicts."""
    env.pod_events.reconcile_all(now=now)
    env.conditions.reconcile_all(now=now)
    env.disruption._rng = random.Random(0)
    with api.explain.tick("t") as rec:
        cmd = getattr(env.disruption, method)(now)
        notes = dict(rec.nodes)
    return testing.command_identity(cmd), notes


# -- the five methods ---------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_method_command_matches_jax(method, seed):
    case = fleet_case(seed)
    prep = both(scale_down(0.5, seed=seed + 10, empty=2), drifted())
    got = decide(*world("port", case, prep), method, T0 + 100)
    want = decide(*world("jax", case, prep), method, T0 + 100)
    assert got == want
    assert got[0] is not None, f"{method} decided nothing: the fixture is vacuous"


def test_spot_to_spot_gate_matches_jax():
    """A spot fleet with SpotToSpotConsolidation off: the gate's
    verdicts (`kept:spot-to-spot-gated`) as the JAX package writes
    them."""
    spot = {"kubernetes.io/arch": "amd64", "karpenter.sh/capacity-type": "spot"}
    case = fleet_case(4, n_nodes=0, n_pending=60)
    for d in case.pods:
        d["node_selector"] = dict(spot)

    def options(api):
        return api.options.Options()

    got = world("port", case, scale_down(0.6, seed=4), options=options(port_api()))
    want = world("jax", case, scale_down(0.6, seed=4), options=options(jax_api()))
    for method in ("single_node_consolidation", "multi_node_consolidation"):
        a = decide(*got, method, T0 + 100)
        assert a == decide(*want, method, T0 + 100)
    assert any(v["verdict"] == "kept:spot-to-spot-gated" for v in a[1].values())


# -- the whole loop ------------------------------------------------------------


def loop(package: str, seed: int) -> list:
    env, api = world(package, fleet_case(seed, n_nodes=26, n_pending=60),
                     scale_down(0.55, seed=seed + 20), seed=seed)
    nodes = len(env.kube.nodes())
    rounds = testing.disruption_rounds(env, T0 + 100)
    return nodes, [(r["identity"], r["blocked"], r["active"], r["fleet"], r["stalled"],
                    testing.decision_fingerprint(r["placed"]) if r["placed"] else None)
                   for r in rounds]


@pytest.mark.parametrize("seed", [0, 3, 6])
def test_reconcile_loop_converges_like_jax(seed):
    """Round for round as the JAX package, to the same end: a round
    that decides nothing, or (seed 6, in both packages) a fixed point
    where the global repack's command fails its own re-simulation every
    round and rolls back (ROADMAP C6)."""
    nodes, got = loop("port", seed)
    _, want = loop("jax", seed)
    assert 20 <= nodes <= 40
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"round {k} diverged"
    decided = [r for r in got if r[0] is not None]
    assert decided and (got[-1][0] is None or got[-1][4])
    assert got[-1][3][2] < got[0][3][2] or got[-1][4]


# -- the candidate scan's families (tests/test_disruption_oracle.py) -----------


def _annotate_pod(env, api):
    pod = sorted((p for p in env.kube.pods() if p.spec.node_name), key=lambda p: p.key)[0]
    pod.metadata.annotations[api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"


def _annotate_terminal_pod(env, api):
    pods = sorted((p for p in env.kube.pods() if p.spec.node_name), key=lambda p: p.key)
    pods[0].metadata.annotations[api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"
    pods[0].status.phase = "Succeeded"
    pods[1].status.phase = "Failed"


def _bind_extra(env, api, owner: str, annotate: bool):
    o = api.objects
    node = sorted(n.metadata.name for n in env.kube.nodes())[1]
    pod = testing.case_pod(api, testing._pod(f"{owner.lower()}-pod", 0.1, 0.1), T0)
    pod.metadata.owner_references = [o.OwnerReference(
        kind=owner, name=f"{owner.lower()}-o", uid=f"uid-{owner.lower()}-o",
        controller=True)]
    if annotate:
        pod.metadata.annotations[api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"
    env.kube.create(pod)
    env.kube.bind_pod(pod, node)


def _annotate_node(env, api):
    node = sorted(env.kube.nodes(), key=lambda n: n.metadata.name)[2]
    node.metadata.annotations[api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"


def _pdb(max_unavailable, terminal: bool = False):
    def prep(env, api):
        o = api.objects
        env.kube.create(o.PodDisruptionBudget(
            metadata=o.ObjectMeta(name="pdb-a", uid="uid-pdb-a"),
            spec=o.PodDisruptionBudgetSpec(
                selector=o.LabelSelector.of({"app": "a-0"}),
                max_unavailable=max_unavailable)))
        if terminal:
            for p in env.kube.pods():
                if p.metadata.labels.get("app") == "a-0":
                    p.status.phase = "Succeeded"
    return prep


def _costs(env, api):
    pods = sorted((p for p in env.kube.pods() if p.spec.node_name), key=lambda p: p.key)
    for i, p in enumerate(pods):
        if i % 3 == 0:
            p.metadata.annotations["controller.kubernetes.io/pod-deletion-cost"] = \
                str((i * 7919) % 400_000_000 - 200_000_000)
        if i % 5 == 0:
            p.spec.priority = (i % 7) * 10_000_000 - 30_000_000
    pods[1].metadata.annotations["controller.kubernetes.io/pod-deletion-cost"] = "bad"


def _expire(env, api):
    for i, claim in enumerate(sorted(env.kube.node_claims(), key=lambda c: c.metadata.name)):
        claim.spec.expire_after = ("2h", "30m", None)[i % 3]


def _budget(env, api):
    pool = env.kube.get_node_pool("default")
    pool.spec.disruption.budgets = [
        api.nodepool.Budget(nodes="3"),
        api.nodepool.Budget(nodes="0", reasons=["Drifted"]),
    ]
    env.kube.update(pool)
    claim = sorted(env.kube.node_claims(), key=lambda c: c.metadata.name)[0]
    env.kube.delete(claim, now=T0 + 45)


def _nominate(env, api):
    for n in sorted(env.cluster.nodes(), key=lambda n: n.name)[:3]:
        n.nominate(now=T0 + 100)


FAMILIES = {
    "do-not-disrupt-pod": _annotate_pod,
    "do-not-disrupt-daemonset-pod": lambda e, a: _bind_extra(e, a, "DaemonSet", True),
    "daemonset-pod": lambda e, a: _bind_extra(e, a, "DaemonSet", False),
    "mirror-pod": lambda e, a: _bind_extra(e, a, "Node", True),
    "terminal-pods": _annotate_terminal_pod,
    "do-not-disrupt-node": _annotate_node,
    "blocking-pdb": _pdb(0),
    "pdb-percent": _pdb("34%"),
    "pdb-on-terminal-pods": _pdb(0, terminal=True),
    "eviction-cost": _costs,
    "expire-after": _expire,
    "budgets": _budget,
    "nominated": _nominate,
}


def scan(env, api, now: float) -> dict:
    env.pod_events.reconcile_all(now=now)
    env.conditions.reconcile_all(now=now)
    out = {}
    with api.explain.tick("t") as rec:
        for reason in ("Empty", "Underutilized", "Drifted"):
            out[reason] = candidates_of(env, reason, now)
            out[f"budget-{reason}"] = sorted(env.disruption.budget_mapping(reason, now).items())
        out["notes"] = dict(rec.nodes)
    out["costs"] = [(p.key, api.engine.pod_disruption_cost(p))
                    for p in sorted(env.kube.pods(), key=lambda p: p.key)]
    env.disruption._rng = random.Random(0)
    with api.explain.tick("r") as rec:
        out["command"] = testing.command_identity(env.disruption.reconcile(now=now))
        out["reconcile-notes"] = dict(rec.nodes)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_candidate_family_matches_jax(family):
    case = fleet_case(7, n_nodes=10, n_pending=20)
    prep = both(scale_down(0.3, seed=7), drifted(4), FAMILIES[family])
    got = scan(*world("port", case, prep), T0 + 100)
    want = scan(*world("jax", case, prep), T0 + 100)
    assert got == want
    assert got["Underutilized"]


# -- the queue: execution, validation, rollback --------------------------------


def observe(env) -> tuple:
    """The fleet, and per claim its deletion, condition and node taints."""
    claims = []
    for c in sorted(env.kube.node_claims(), key=lambda c: c.metadata.name):
        node = env.kube.get_node(c.status.node_name) if c.status.node_name else None
        claims.append((
            c.metadata.name, c.metadata.deletion_timestamp is not None,
            c.status_conditions.is_true("DisruptionReason"),
            tuple(sorted(t.key for t in node.spec.taints)) if node else (),
        ))
    marked = sorted(n.name for n in env.cluster.nodes() if n.marked_for_deletion)
    return testing.fleet_state(env), tuple(claims), tuple(marked)


def _late_pdb(env, api, cmd):
    o = api.objects
    pod = testing.case_pod(api, testing._pod("late", 0.1, 0.1, labels={"app": "late"}), T0)
    env.kube.create(pod)
    env.kube.bind_pod(pod, cmd.candidates[0].state_node.name)
    env.kube.create(o.PodDisruptionBudget(
        metadata=o.ObjectMeta(name="late", uid="uid-pdb-late"),
        spec=o.PodDisruptionBudgetSpec(selector=o.LabelSelector.of({"app": "late"}),
                                       max_unavailable=0)))


def _late_annotation(env, api, cmd):
    node = next(c.state_node for c in cmd.candidates if c.reschedulable_pods)
    key = sorted(node.pod_keys)[0]
    pod = env.kube.get_pod(*key.split("/", 1))
    pod.metadata.annotations[api.labels.DO_NOT_DISRUPT_ANNOTATION] = "true"


def _late_nomination(env, api, cmd):
    env.cluster.node_for_name(cmd.candidates[0].state_node.name).nominate(now=T0 + 200)


def _catalog_blip(failures: int):
    def change(env, api, cmd):
        real = env.cloud.get_instance_types
        left = [failures]

        def flaky(pool):
            if left[0] > 0:
                left[0] -= 1
                raise RuntimeError("catalog fetch failed")
            return real(pool)

        env.cloud.get_instance_types = flaky
    return change


def _reprice(env, api, cmd):
    # on-demand capacity is now free: retiring the candidates saves
    # nothing the (spot) replacement does not cost
    for it in env.cloud.get_instance_types(env.kube.get_node_pool("default")):
        for off in it.offerings:
            if off.capacity_type == "on-demand":
                off.price = 0.0


def _pending_capacity(env, api, cmd):
    # unrelated capacity starts materializing: the re-simulation defers
    pod = testing.case_pod(api, testing._pod("big", 7.0, 8.0), T0 + 150)
    env.kube.create(pod)
    env.provisioner.reconcile(now=T0 + 150)


# change -> (what changes after the command started, the queue's
# reconcile times after it: within the validation TTL or past it)
WITHIN, PAST = (5, 20, 700), (20, 40, 700)
CHANGES = {
    "none": (None, WITHIN),
    "none-resimulated": (None, PAST),
    "late-pdb": (_late_pdb, WITHIN),
    "late-do-not-disrupt": (_late_annotation, WITHIN),
    "late-nomination": (_late_nomination, WITHIN),
    "catalog-blip": (_catalog_blip(1), WITHIN),
    "catalog-down": (_catalog_blip(10**6), WITHIN),
    "repriced": (_reprice, WITHIN),
    "capacity-materializing": (_pending_capacity, PAST),
}


def queue_run(package: str, change, dts) -> list:
    """A multi-node command started as `reconcile` starts it, its
    replacements registered, `change` made, then the queue reconciled
    within the validation TTL, past it, and past the retry deadline,
    each followed by `terminate`."""
    env, api = world(package, fleet_case(8, n_nodes=12, n_pending=20),
                     scale_down(0.5, seed=8))
    out = []
    env.pod_events.reconcile_all(now=T0 + 100)
    env.conditions.reconcile_all(now=T0 + 100)
    cmd = env.disruption.multi_node_consolidation(T0 + 100)
    out.append(testing.command_identity(cmd))
    if cmd is None:
        return out
    env.disruption.queue.start_command(cmd, T0 + 100)
    testing.register(env, cmd.results, T0 + 100)
    if change is not None:
        change(env, api, cmd)
    for dt in dts:
        with api.explain.tick("q") as rec:
            env.disruption.queue.reconcile(now=T0 + 100 + dt)
            notes = dict(rec.nodes)
        out.append((dt, len(env.disruption.queue.active), observe(env), notes))
        out.append(testing.terminate(env, T0 + 100 + dt))
    return out


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_queue_and_validation_match_jax(change):
    got = queue_run("port", *CHANGES[change])
    want = queue_run("jax", *CHANGES[change])
    assert got == want
    assert got[0] is not None and got[0][0] == "Underutilized"


def test_leftover_taints_match_jax():
    """A stale disrupted taint and a wedged mark are cleared by the next
    reconcile, in both packages alike."""
    def prep(env, api):
        state = sorted(env.cluster.nodes(), key=lambda n: n.name)[0]
        state.marked_for_deletion = True
        node = env.kube.get_node(state.name)
        node.spec.taints.append(api.labels.DISRUPTED_NO_SCHEDULE_TAINT)
        env.kube.update(node)

    def run(package):
        env, api = world(package, fleet_case(9, n_nodes=6, n_pending=10), prep)
        env.disruption._untaint_leftovers()
        return observe(env)

    got = run("port")
    assert got == run("jax")
    assert not got[2]


def test_conditions_and_expiration_match_jax():
    """`disruption/conditions.py`'s O(changes) paths: pod events and the
    conditions controller's dirty ticks (Consolidatable flips on its
    timer, Drifted on the provider and on a pool change), and
    `ExpirationController` force-deleting claims past expireAfter, on
    both packages' fleets alike."""
    def run(package):
        env, api = world(package, fleet_case(12, n_nodes=8, n_pending=20),
                         both(scale_down(0.3, seed=12), drifted(3)))
        out = []
        for i, claim in enumerate(sorted(env.kube.node_claims(),
                                         key=lambda c: c.metadata.name)):
            claim.spec.expire_after = ("2h", "30m", None)[i % 3]
        pool = env.kube.get_node_pool("default")
        for k, dt in enumerate((0, 1000, 4000, 8000)):
            now = T0 + 60 + dt
            if k == 2:
                pool.spec.disruption.consolidate_after = "1h"
                env.kube.update(pool)
            env.pod_events.reconcile_dirty(now=now)
            env.conditions.reconcile_dirty(now=now)
            expired = env.expiration.reconcile_dirty(now=now) if k < 3 else \
                env.expiration.reconcile_all(now=now)
            out.append((
                dt, sorted(c.metadata.name for c in expired),
                sorted((c.metadata.name, c.status_conditions.is_true("Consolidatable"),
                        c.status_conditions.is_true("Drifted"),
                        c.metadata.deletion_timestamp is not None)
                       for c in env.kube.node_claims()),
                testing.terminate(env, now)))
        return out

    got = run("port")
    assert got == run("jax")
    assert any(step[1] for step in got), "no claim expired: the fixture is vacuous"
