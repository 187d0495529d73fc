"""The port's incremental live tick held against the JAX package's.

The tick (`provisioning/incremental_tick.py`) is the Provisioner's
default reconcile path in both packages. Each scenario is one event
stream (`testing.StreamRound`: rounds that add and delete pods, launch
and register claims, bind pods, create a DaemonSet or drop a watch)
built from the same plain data with each package's constructors and
driven through `testing.run_stream` (the port on device="cpu"). Both
packages' claim-name and uid counters restart before each run
(`testing.reset_counters`): the poison site corrupts the retained row
with the least key, and the keys of claims in flight are claim names.
Both Provisioners run on one fixed clock. Every comparison is exact:
each round's name-insensitive decision fingerprint, its route (the
(path, reason) the tick counted), the tick's `status()`, its
divergence records and the fault log.

The scenarios mirror the JAX package's suites
(`test_incremental_tick.py`, `test_incremental_envelope.py`) on this
harness; what reads the operator (`readyz()`) reads `status()` here,
and the disruption skip gate belongs to the consolidation engine
(ROADMAP item 1b).
"""

import itertools
from types import SimpleNamespace

import pytest

from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import faults
from karpenter_tpu_torch.testing import CASE_T0, StreamRound, _pod

ZONE = "topology.kubernetes.io/zone"
C4 = ("custom", (("c4", 4.0, 16.0, 1.0),), 1)


def jax_api():
    """The JAX package's modules under `testing.package_api()`'s names."""
    from karpenter_tpu.apis.v1 import labels, nodeclaim, nodepool
    from karpenter_tpu.cloudprovider import fake
    from karpenter_tpu.kube import client, objects
    from karpenter_tpu.metrics import store
    from karpenter_tpu.operator import options
    from karpenter_tpu.provisioning import provisioner
    from karpenter_tpu.state import cluster

    return SimpleNamespace(
        labels=labels, nodeclaim=nodeclaim, nodepool=nodepool, fake=fake,
        objects=objects, client=client, cluster=cluster,
        provisioner=provisioner, options=options, store=store,
    )


PACKAGES = {
    "port": (testing.package_api, faults, {"device": "cpu"}),
    "jax": (jax_api, jfaults, {}),
}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("KARPENTER_FAULTS", "KARPENTER_INCREMENTAL",
                 "KARPENTER_INCR_AUDIT_EVERY", "KARPENTER_INCR_CHURN_MAX",
                 "KARPENTER_MICRO_DUAL", "KARPENTER_STATE_SHARDS"):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    jfaults.reset()
    yield monkeypatch
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (see test_torch_provisioning.py)."""
    with testing.one_core():
        yield


def case(name, reserved=False, **kw):
    """A one-pool case over one c4 type (4 cpu, 16 GiB, $1), the JAX
    suites' catalog; `reserved` adds 2 reserved instances in zone 1."""
    kw.setdefault("pools", [dict(name="p")])
    return testing.ProvisionCase(
        name, catalog=C4,
        reservations=((0, "rsv-1", "test-zone-1", 2),) if reserved else (), **kw)


def fleet(env) -> list:
    """The converged fleet without names: per node its type, zone,
    capacity type and bound pod names."""
    return sorted(
        (n.metadata.labels.get("node.kubernetes.io/instance-type", ""),
         n.metadata.labels.get(ZONE, ""),
         n.metadata.labels.get("karpenter.sh/capacity-type", ""),
         tuple(sorted(p.metadata.name
                      for p in env.kube.pods_on_node(n.metadata.name))))
        for n in env.kube.nodes())


def drive(c, rounds, packages=("port", "jax"), audit_every=None,
          before_round=None) -> dict:
    """The stream through each package; what each run decided and
    recorded. `before_round(name, env, k)` runs before round k."""
    out = {}
    for name in packages:
        make_api, fmod, kw = PACKAGES[name]
        api = make_api()
        fmod.reset()
        testing.reset_counters(api)
        env = testing.build_env(c, api, kube=testing.relisting_client(api), **kw)
        tick = env.provisioner.incremental
        if audit_every is not None:
            tick.audit_every = audit_every
        if before_round is None:
            s = testing.run_stream(env, rounds)
        else:
            s = None
            for k, rnd in enumerate(rounds):
                before_round(name, env, k)
                s = testing.run_stream(env, [rnd], resume=s)
        inj = fmod.get()
        out[name] = SimpleNamespace(
            env=env, fingerprints=s["fingerprints"], routes=s["routes"],
            status=tick.status(), divergences=list(tick.divergences),
            fault_log=inj.snapshot_log() if inj is not None else [],
            fleet=fleet(env), results=s["results"])
    return out


def assert_same(got: dict) -> None:
    port, ref = got["port"], got["jax"]
    for k in range(len(ref.fingerprints)):
        assert port.routes[k] == ref.routes[k], ("route", k)
        assert port.fingerprints[k] == ref.fingerprints[k], ("decisions", k)
    assert port.status == ref.status
    assert port.divergences == ref.divergences
    assert port.fault_log == ref.fault_log
    assert port.fleet == ref.fleet


def serves(run, path="incremental") -> int:
    return sum(p == path for r in run.routes for p, _ in r)


def cpu_pods(prefix, cpus, **kw) -> list:
    return [_pod(f"{prefix}-{i}", cpu, 1.0, **kw) for i, cpu in enumerate(cpus)]


# -- test_incremental_tick.py -------------------------------------------------


class TestDefaultRouting:
    ROUNDS = [StreamRound(add=cpu_pods("a", [1.0] * 4)), StreamRound(),
              StreamRound(add=cpu_pods("b", [1.0] * 2)), StreamRound()]

    def test_incremental_is_the_default_live_tick(self):
        got = drive(case("default"), self.ROUNDS)
        assert_same(got)
        run = got["port"]
        assert serves(run) >= 1, run.routes
        assert run.status["enabled"] is True
        assert sum(len(pods) for *_, pods in run.fleet) == 6

    def test_env_kill_switch_routes_full_path(self, clean):
        on = drive(case("default"), self.ROUNDS)
        clean.setenv("KARPENTER_INCREMENTAL", "0")
        off = drive(case("default"), self.ROUNDS)
        assert_same(off)
        assert all(r == [] for r in off["port"].routes), off["port"].routes
        assert off["port"].status["enabled"] is False
        assert off["port"].status["ticks"] == {
            "incremental": 0, "full_backstop": 0, "quarantined": 0, "micro": 0}
        assert off["port"].fleet == on["port"].fleet
        assert off["port"].fingerprints == on["port"].fingerprints

    def test_incremental_and_full_paths_decide_identically(self, clean):
        """The headline identity: the same stream through the tick and
        through the full path, in both packages, lands the same fleet
        with the same decisions round by round."""
        rounds = [StreamRound(add=[_pod(f"w-{i}", 1.0 + (i % 3) * 0.5, 1.0)
                                   for i in range(9)]),
                  StreamRound(add=cpu_pods("x", [0.5] * 4)), StreamRound()]
        on = drive(case("identity"), rounds)
        clean.setenv("KARPENTER_INCREMENTAL", "0")
        off = drive(case("identity"), rounds)
        assert_same(on)
        assert_same(off)
        assert on["port"].fingerprints == off["port"].fingerprints
        assert on["port"].fleet == off["port"].fleet
        assert serves(on["port"]) >= 1

    @pytest.mark.parametrize("reason", ["topology", "host_ports", "volumes",
                                        "dra", "min_values"])
    def test_ineligible_tick_falls_back_with_reason(self, reason):
        """A pod (or a pool) only the full Scheduler can finish routes
        the whole tick to the full path, counted under its reason in
        the fallback rollup, in both packages alike."""
        pod = _pod(f"{reason}-0", 1.0, 1.0, labels={"app": "x"})
        kw = {}
        if reason == "topology":
            pod["anti"] = [("kubernetes.io/hostname", {"app": "x"})]
        elif reason == "host_ports":
            pod["host_ports"] = [8080]
        elif reason == "volumes":
            pod["pvc"] = "claim-0"
            kw["volumes"] = (("claim-0", ("test-zone-2",)),)
        elif reason == "dra":
            pod["resource_claims"] = ["gpu"]
        else:
            kw["pools"] = [dict(name="p", requirements=[
                ("node.kubernetes.io/instance-type", "Exists", (), 1)])]
        rounds = [StreamRound(add=cpu_pods("w", [1.0] * 3)), StreamRound(),
                  StreamRound(add=[pod]), StreamRound()]
        got = drive(case(reason, **kw), rounds)
        assert_same(got)
        run = got["port"]
        assert ("full_backstop", reason) in run.routes[2], run.routes
        assert run.status["fallbacks"].get(reason, 0) >= 1


CASES = testing.provision_cases(0)


@pytest.mark.parametrize("c", CASES, ids=[c.name for c in CASES])
def test_provision_cases_through_the_tick_match_jax(c):
    """`testing.provision_cases` (existing nodes and daemonsets, taints,
    selectors, spread with anti-affinity, host ports, PVC zones,
    minValues, reservations, priorities over a pool limit, preferences
    that relax) with the tick on: the first round, the claims launched,
    then the case's extra pods, then the claims registered and the pods
    bound. Each round's route and decisions equal the JAX package's."""
    extra = [dict(d) for d in c.extra_pods]
    c = testing.ProvisionCase(**{**c.__dict__, "extra_pods": []})
    rounds = [StreamRound(), StreamRound(settle=False, add=extra), StreamRound()]
    assert_same(drive(c, rounds))


class TestOracleAuditAndPoison:
    """Two waves; the second lands on the warm retained state, where a
    poisoned row has a real decision to corrupt: the c4 nodes are nearly
    full (3.5 of 4 cpu) and the new 1-cpu pods fit only on new capacity
    unless a phantom-capacity row lies about headroom."""

    ROUNDS = [StreamRound(add=cpu_pods("f", [3.5] * 3)), StreamRound(),
              StreamRound(add=cpu_pods("n", [1.0] * 2)), StreamRound()]

    def converge(self, clean, spec, rounds=None):
        if spec:
            clean.setenv("KARPENTER_FAULTS", spec)
        else:
            clean.delenv("KARPENTER_FAULTS", raising=False)
        got = drive(case("poison"), rounds or self.ROUNDS)
        clean.delenv("KARPENTER_FAULTS", raising=False)
        return got

    def test_cache_poison_never_changes_the_fleet(self, clean):
        calm = self.converge(clean, "")
        poisoned = self.converge(clean, "cache_poison@incremental:*")
        assert_same(poisoned)
        run = poisoned["port"]
        assert any(kind == "cache_poison" for _, _, kind in run.fault_log)
        assert run.fleet == calm["port"].fleet
        assert run.divergences, "the audit must catch the phantom row"
        assert run.status["quarantined"] or run.status["divergences"] > 0

    def test_poison_replay_is_byte_identical(self, clean):
        a = self.converge(clean, "cache_poison@incremental:*")
        b = self.converge(clean, "cache_poison@incremental:*")
        assert a["port"].fault_log and a["port"].fault_log == b["port"].fault_log
        assert a["port"].divergences == b["port"].divergences
        assert a["port"].divergences[-1]["fault_log"]
        assert a["port"].fault_log == a["jax"].fault_log

    def test_quarantine_recovers_after_probation_audit(self, clean):
        rounds = self.ROUNDS + [StreamRound(add=cpu_pods("post-q", [1.0])),
                                StreamRound()]
        got = self.converge(clean, "cache_poison@incremental:2", rounds)
        assert_same(got)
        st = got["port"].status
        assert not st["quarantined"], st
        assert st["last_audit"]["verdict"] == "ok"

    def test_divergence_recorded_and_rung_reported(self, clean):
        from karpenter_tpu.metrics.store import SOLVER_LADDER as JLADDER
        from karpenter_tpu_torch.metrics.store import SOLVER_LADDER

        rung = {"rung": "incremental_poison", "outcome": "quarantined"}
        before = (SOLVER_LADDER.value(rung), JLADDER.value(rung))
        got = self.converge(clean, "cache_poison@incremental:*")
        assert_same(got)
        rec = got["port"].divergences[-1]
        assert rec["incremental"] != rec["full"]
        assert any(kind == "cache_poison" for _, _, kind in rec["fault_log"])
        grew = (SOLVER_LADDER.value(rung) - before[0], JLADDER.value(rung) - before[1])
        assert grew[0] > 0 and grew[0] == grew[1]

    def test_recovery_forces_rebuild_and_audit(self):
        def recover(name, env, k):
            if k == 2:
                tick = env.provisioner.incremental
                assert tick._ticks > 0
                tick.on_recover()
                assert tick.status()["retained_nodes"] == 0
                assert tick._force_audit == "recovery"

        rounds = [StreamRound(add=cpu_pods("rc", [1.0])), StreamRound(),
                  StreamRound(add=cpu_pods("rd", [1.0])), StreamRound()]
        got = drive(case("recovery"), rounds, before_round=recover)
        assert_same(got)
        st = got["port"].status
        assert st["divergences"] == 0
        assert st["last_audit"] == {"verdict": "ok", "trigger": "recovery", "tick": 3}


class TestDirtyTrackerExtensions:
    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_mapped_keys(self, name):
        api = PACKAGES[name][0]()
        kube = api.client.KubeClient()
        from importlib import import_module

        dirty = import_module(api.client.__name__.rsplit(".", 1)[0] + ".dirty")
        tracker = dirty.DirtyTracker(kube).watch(
            "Pod", key=lambda e, p: [p.spec.node_name] if p.spec.node_name else [])
        tracker.drain("Pod")
        kube.create(testing.case_pod(api, _pod("m-0", 1.0), CASE_T0))
        assert tracker.drain("Pod") == set()  # unbound: no node dirtied
        kube.create(testing.case_pod(api, _pod("m-1", 1.0), CASE_T0))
        live = kube.get_pod("default", "m-1")
        live.spec.node_name = "node-a"
        kube.touch(live)
        assert "node-a" in tracker.drain("Pod")

    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_relisted_latch(self, name):
        from importlib import import_module

        api = PACKAGES[name][0]()
        dirty = import_module(api.client.__name__.rsplit(".", 1)[0] + ".dirty")
        kube = testing.relisting_client(api)
        tracker = dirty.DirtyTracker(kube).watch("Pod")
        assert tracker.relisted("Pod") is False
        kube.drop_watch("Pod")
        assert tracker.relisted("Pod") is True
        assert tracker.relisted("Pod") is False  # latched once
        assert tracker.relisted_shards("Pod") == set()
        kube.drop_watch("Pod")
        assert tracker.relisted_shards("Pod") is None  # unscoped: everything
        # the in-memory client has no relist machinery at all
        plain = dirty.DirtyTracker(api.client.KubeClient()).watch("Pod")
        assert plain.relisted("Pod") is False


def test_daemonset_created_after_warm_cache_rebuilds_builder(clean):
    """A DaemonSet created after the retained state warmed rebuilds the
    NodeInputBuilder: a stale builder would pack 3 x 1.3 cpu per fresh
    c4 where the full path, with its 1 cpu daemon reserve, fits 2."""
    rounds = [StreamRound(add=cpu_pods("d", [1.0] * 4)), StreamRound(),
              StreamRound(daemonset=dict(name="logging", cpu=1.0, mem=0.0),
                          add=cpu_pods("e", [1.3] * 6)), StreamRound()]
    on = drive(case("daemonset"), rounds)
    clean.setenv("KARPENTER_INCREMENTAL", "0")
    off = drive(case("daemonset"), rounds)
    assert_same(on)
    assert on["port"].fleet == off["port"].fleet
    assert on["port"].fingerprints == off["port"].fingerprints
    assert on["port"].status["divergences"] == 0


def test_watch_drop_relist_marks_everything_dirty(clean):
    """A 410 on the node-keyed streams loses continuity: the tick
    rebuilds every retained row (its churn gate then hands that round
    to the full path, as in the JAX package), and the fleet equals the
    run without the tick."""
    rounds = [StreamRound(add=cpu_pods("wd", [1.0] * 5)), StreamRound(),
              StreamRound(add=cpu_pods("we", [1.0] * 2)),
              StreamRound(relist=("Node", "NodeClaim", "Pod"),
                          add=cpu_pods("wf", [1.5] * 2)),
              StreamRound(add=cpu_pods("wg", [0.5])), StreamRound()]
    on = drive(case("watch-drop"), rounds)
    clean.setenv("KARPENTER_INCREMENTAL", "0")
    off = drive(case("watch-drop"), rounds)
    assert_same(on)
    run = on["port"]
    assert ("full_backstop", "churn") in run.routes[3], run.routes
    assert any(("incremental", "steady") in r for r in run.routes[4:]), run.routes
    assert run.fleet == off["port"].fleet
    assert run.fingerprints == off["port"].fingerprints
    assert run.status["divergences"] == 0


@pytest.mark.parametrize("churn", [0.01, 0.1])
def test_steady_churn_stream_matches_jax(clean, churn):
    """Phase 14's stream cut to CPU size: `build_problem`'s pods in a
    round, 1/5 more with the claims in flight, then steady rounds that
    delete a share of the bound pods (a seeded draw) and respawn their
    shapes. Both packages take the same route every round, and the tick
    decides as the full path. At 1% the steady rounds ride the tick
    here; at 10% the deletions dirty more than KARPENTER_INCR_CHURN_MAX
    (25%) of the retained rows and both packages hand the rounds to the
    full path (reason `churn`), as phase 14 sees at 1% of 50k pods
    (~41 pods a node)."""
    import bench
    from karpenter_tpu_torch.workloads import build_problem

    n, types = 600, 20

    def rounds(extra):
        return [StreamRound(), StreamRound(settle=False, pods=extra)] + [
            StreamRound(delete=churn, respawn=True, pick="seeded", seed=k)
            for k in range(4)]

    runs = {}
    for name, inc in (("port", "1"), ("jax", "1"), ("full", "0")):
        clean.setenv("KARPENTER_INCREMENTAL", inc)
        if name == "jax":
            api = jax_api()
            pods, pools = bench.build_problem(n, types, seed=42)
            extra, _ = bench.build_problem(n // 5, types, seed=43)
            for i, pod in enumerate(extra):
                pod.metadata.name = f"extra-{i}"
            kw = {"api": api}
        else:
            api = testing.package_api()
            pods, pools = build_problem(n, types, seed=42)
            extra, _ = build_problem(n // 5, types, seed=43, name_prefix="extra-")
            kw = {"device": "cpu"}
        testing.reset_counters(api)
        env = testing.pods_env(pods, pools, **kw)
        runs[name] = testing.run_stream(env, rounds(extra))
    assert runs["port"]["routes"] == runs["jax"]["routes"]
    assert runs["port"]["fingerprints"] == runs["jax"]["fingerprints"]
    assert runs["full"]["fingerprints"] == runs["port"]["fingerprints"]
    assert runs["port"]["deleted"] == runs["jax"]["deleted"]
    steady = [("incremental", "steady") in r for r in runs["port"]["routes"][2:]]
    if churn == 0.01:
        assert steady == [True] * 4, runs["port"]["routes"]
    else:
        # the first steady round is the tick's warm-up after its cold
        # bail (the one-time rebuild, which the churn gate does not
        # judge); the next ones churn
        assert steady == [True, False, False, False], runs["port"]["routes"]
        assert all(r == [("full_backstop", "churn")]
                   for r in runs["port"]["routes"][3:]), runs["port"]["routes"]


# -- test_incremental_envelope.py ---------------------------------------------


def spread_pod(name: str, cpu: float) -> dict:
    return _pod(name, cpu, 1.0, labels={"app": "spread"},
                spread=[(ZONE, 1, "DoNotSchedule", {"app": "spread"})])


def workload(tick: int, topology: bool, priorities: bool) -> list:
    pods = [_pod(f"t{tick}-plain-{i}", 0.8 + 0.2 * (i % 2), 1.0,
                 **({"priority": 100 if i % 2 == 0 else 0} if priorities else {}))
            for i in range(3)]
    if topology:
        pods += [spread_pod(f"t{tick}-spread-a", 0.7), spread_pod(f"t{tick}-spread-b", 0.7)]
    return pods


def churn_rounds(topology, priorities, ticks=4, final=True) -> list:
    """A wave, a warm round past the cold bail, then waves that each
    retire one bound pod (the first by name)."""
    rounds = [StreamRound(add=workload(0, topology, priorities)), StreamRound()]
    rounds += [StreamRound(delete=1, add=workload(t, topology, priorities))
               for t in range(1, ticks)]
    return rounds + ([StreamRound()] if final else [])


SHAPES = sorted(itertools.product((False, True), repeat=3), reverse=True)


class TestEnvelope:
    @pytest.mark.parametrize("topology,reserved,priorities", SHAPES, ids=str)
    def test_widened_shapes_ride_incremental_and_match_full(
            self, topology, reserved, priorities):
        """Every combination of topology spread, reservations and
        mixed priorities, churned over several ticks with the shadow
        audit forced every tick: the tick serves, every audit is clean,
        and both packages decide and route alike."""
        got = drive(case("envelope", reserved=reserved),
                    churn_rounds(topology, priorities), audit_every=1)
        assert_same(got)
        run = got["port"]
        assert serves(run) >= 1, run.status["fallbacks"]
        assert run.status["divergences"] == 0 and not run.status["quarantined"]

    def test_end_fleet_matches_full_path(self, clean):
        rounds = [StreamRound(add=workload(0, True, True)), StreamRound()] + [
            StreamRound(add=workload(t, True, True)) for t in (1, 2)] + [StreamRound()]
        on = drive(case("end-fleet", reserved=True), rounds)
        clean.setenv("KARPENTER_INCREMENTAL", "0")
        off = drive(case("end-fleet", reserved=True), rounds)
        assert_same(on)
        assert on["port"].fleet == off["port"].fleet
        assert on["port"].fingerprints == off["port"].fingerprints

    def test_boundary_exact_fill_churn_does_not_diverge(self, clean):
        """4 x 0.8 cpu leaves 0.7999999999999994 of a c4 in float64 and
        exactly 0.8 in the kernels' float32: the residual prune must
        keep that row, in both packages."""
        clean.setenv("KARPENTER_INCR_CHURN_MAX", "1.0")

        def wave(t):
            return [_pod(f"bf-{t}-{i}", 0.8, 1.0, priority=100 if i % 2 == 0 else 0)
                    for i in range(6)] + [spread_pod(f"bf-{t}-s", 0.7)]

        rounds = [StreamRound(add=wave(0)), StreamRound()] + [
            StreamRound(delete=2, add=wave(t)) for t in (1, 2, 3)] + [StreamRound()]
        got = drive(case("boundary", reserved=True), rounds, audit_every=1)
        assert_same(got)
        st = got["port"].status
        assert st["divergences"] == 0 and not st["quarantined"]
        assert serves(got["port"]) >= 1

    def test_first_envelope_tick_forces_audit(self, clean):
        clean.setenv("KARPENTER_INCR_AUDIT_EVERY", "0")
        rounds = [StreamRound(add=cpu_pods("warm", [1.0])), StreamRound(),
                  StreamRound(add=[spread_pod("first-topo", 0.5)]), StreamRound()]
        got = drive(case("first-envelope"), rounds)
        assert_same(got)
        st = got["port"].status
        assert st["last_audit"] == {"verdict": "ok", "trigger": "envelope", "tick": 3}
        assert ("incremental", "audited") in got["port"].routes[2]

    def test_poisoned_topology_tick_quarantines(self, clean):
        rounds = [StreamRound(add=cpu_pods("f", [3.5] * 3)), StreamRound(),
                  StreamRound(add=[spread_pod("sp-0", 1.0), spread_pod("sp-1", 1.0)]),
                  StreamRound()]
        calm = drive(case("poisoned-topology"), rounds)
        clean.setenv("KARPENTER_FAULTS", "cache_poison@incremental:*")
        got = drive(case("poisoned-topology"), rounds)
        assert_same(got)
        run = got["port"]
        assert run.fleet == calm["port"].fleet
        assert run.divergences
        assert ("quarantined", "fault") in run.routes[2], run.routes

    def test_priority_overload_sheds_in_envelope(self):
        """A mixed-priority tick that cannot place everything (a pool
        limit of 8 cpu: two c4 nodes) runs the shed/cutoff loop inside
        the envelope: the shed set is the lowest-priority tail, the
        tick serves incrementally, and the forced envelope audit agrees
        with the full path."""
        from karpenter_tpu_torch.provisioning.priority import PRIORITY_SHED_ERROR

        rounds = [StreamRound(add=cpu_pods("seed", [1.0])), StreamRound(),
                  StreamRound(add=[_pod(f"over-{i}", 3.5, 1.0,
                                        priority=100 if i < 2 else 0)
                                   for i in range(4)])]
        got = drive(case("shed", pools=[dict(name="p", limits={"cpu": 8.0})]), rounds)
        assert_same(got)
        run = got["port"]
        shed = {k for k, err in run.results[2].errors.items()
                if err == PRIORITY_SHED_ERROR}
        assert {"default/over-2", "default/over-3"} <= shed, run.results[2].errors
        assert "priority" not in run.status["fallbacks"]
        assert run.routes[2] == [("incremental", "audited")], run.routes
        assert run.status["divergences"] == 0


# -- the micro path (KARPENTER_MICRO_DUAL) ------------------------------------


def test_micro_path_with_its_dual_floor_matches_jax(clean):
    """Under KARPENTER_MICRO_DUAL=1 the first tick that rides the fast
    path refreshes the dual floor (B5: `build_dual_floor`, on the first
    wave's shapes); then a batch of arrivals of those shapes goes
    through `Provisioner.micro_solve`, ordered by the floor's duals
    (`micro_order`). The order, the route and the
    decisions equal the JAX package's exactly, and `lam_by_sig` is
    within 1e-6 of it (ROADMAP C2: the ascent's step size). The three
    shapes' duals differ by more than 0.05, far past that bound, so the
    order cannot turn on it."""
    clean.setenv("KARPENTER_MICRO_DUAL", "1")
    types = ("custom", (("c4", 4.0, 16.0, 1.0), ("c8", 8.0, 32.0, 2.1),
                        ("m4", 4.0, 32.0, 1.4)), 1)
    c = testing.ProvisionCase("micro", pools=[dict(name="p")], catalog=types)
    batch = cpu_pods("mb", [1.0, 2.0, 0.5] * 4)
    rounds = [StreamRound(add=cpu_pods("w", [1.0, 2.0, 0.5] * 2)), StreamRound(),
              StreamRound(add=[_pod("warm-0", 1.0, 6.0), _pod("warm-1", 2.0, 2.0),
                               _pod("warm-2", 0.5, 3.0)]),
              StreamRound(), StreamRound(settle=False, add=batch, micro=True)]
    orders, duals = {}, {}

    def record(name, env, k):
        tick = env.provisioner.incremental
        if k == 4:
            real = tick.micro_order
            tick.micro_order = lambda pods: orders.setdefault(name, real(pods))
            duals[name] = tick._dual

    got = drive(c, rounds, before_round=record)
    assert_same(got)
    run = got["port"]
    assert run.routes[4] == [("micro", "steady")], run.routes
    assert run.status["micro"]["dual_certificate"] is True
    assert [p.key for p in orders["port"]] == [p.key for p in orders["jax"]]
    assert [p.key for p in orders["port"]] != [f"default/mb-{i}" for i in range(12)]
    port = {repr(k): v for k, v in duals["port"].lam_by_sig.items()}
    ref = {repr(k): v for k, v in duals["jax"].lam_by_sig.items()}
    assert port.keys() == ref.keys() and len(port) >= 3
    for k in ref:
        assert abs(port[k] - ref[k]) <= 1e-6, (k, port[k], ref[k])
    lams = sorted(ref.values())
    assert min(b - a for a, b in zip(lams, lams[1:])) > 0.05, lams


def test_micro_solve_defers_like_jax(clean):
    """The micro path never pays O(fleet): a cold cache, an ineligible
    shape and the kill switch defer the batch (None, no claims), with
    the reason counted, in both packages alike."""
    rounds = [StreamRound(add=cpu_pods("c", [1.0]), micro=True),
              StreamRound(add=cpu_pods("w", [1.0] * 2)), StreamRound(),
              StreamRound(add=[_pod("hp", 1.0, 1.0, host_ports=[80])], micro=True),
              StreamRound()]
    got = drive(case("defer"), rounds)
    assert_same(got)
    run = got["port"]
    assert run.results[0] is None and run.results[3] is None
    assert run.routes[0] == [("micro_defer", "cold")]
    assert run.routes[3] == [("micro_defer", "host_ports")]
    assert run.status["micro"]["deferred"] == {"cold": 1, "host_ports": 1}
