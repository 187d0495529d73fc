"""The port's IncrementalPipeline and dual floor held against the JAX
package's, and the LP's explain summary (ROADMAP C5).

Each test builds the same pods and catalogs with each package's
constructors (`testing.case_pod`, `case_pool`) and runs the port's
pipeline on device="cpu" beside the JAX package's, tick by tick: every
TickResult (mode, reason, scheduled, unschedulable, fleet price, nodes,
churn, pods placed, drift) and the retained fleet's
`state_fingerprint` must be equal. The scenarios mirror the JAX
package's `test_incremental_solver.py` (its encoder-cache tests are
held in test_torch_topology.py; the phase exposition and the warm pool
belong to ROADMAP item 7).

The dual floor's duals come from B5 and differ from the JAX package's
by at most 1e-6 (ROADMAP C2): `lam_by_sig` is held within that bound,
and the decisions exactly, on fixtures whose margins exceed it. Cost
solves lift column generation's time budget and stop the planner's
MIPs at the root node in both packages (`testing.root_node_mips`), so
both do the same work on any machine.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu.apis.v1 import nodeclaim as jnodeclaim
from karpenter_tpu.apis.v1 import nodepool as jnodepool
from karpenter_tpu.cloudprovider import fake as jfake
from karpenter_tpu.kube import client as jclient
from karpenter_tpu.kube import objects as jobjects
from karpenter_tpu.solver import incremental as jincremental
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.apis.v1 import nodeclaim, nodepool
from karpenter_tpu_torch.cloudprovider import fake
from karpenter_tpu_torch.kube import client, objects
from karpenter_tpu_torch.solver import incremental, lp_plan, solver
from karpenter_tpu_torch.testing import CASE_T0, GIB, root_node_mips

SHAPES = [(0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (1.0, 0.5), (0.25, 2.0)]
ARCH = "kubernetes.io/arch"
ZONE = "topology.kubernetes.io/zone"


def api(name):
    """What the tests build each package's objects with."""
    if name == "port":
        return SimpleNamespace(objects=objects, fake=fake, client=client,
                               nodepool=nodepool, nodeclaim=nodeclaim,
                               incremental=incremental, solver=solver,
                               kw={"device": "cpu"})
    return SimpleNamespace(objects=jobjects, fake=jfake, client=jclient,
                           nodepool=jnodepool, nodeclaim=jnodeclaim,
                           incremental=jincremental, solver=jsolver, kw={})


BOTH = ("port", "jax")


def clear_caches():
    jsolver._ffd_floor.clear()
    jsolver._warm_arm.clear()
    jsolver._plan_cache.clear()
    jlp_plan._warm_patterns.clear()
    jlp_device.reset()
    solver.reset_caches()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("KARPENTER_INCR_DUAL_FLOOR", "KARPENTER_INCR_DUAL_RANK",
                 "KARPENTER_INCR_CHURN_MAX", "KARPENTER_INCR_FULL_EVERY",
                 "KARPENTER_INCR_DRIFT_EPS", "KARPENTER_INCR_DUAL_RANK_MIN"):
        monkeypatch.delenv(name, raising=False)
    clear_caches()
    monkeypatch.setattr(jlp_plan, "_TIME_BUDGET_S", 1e6)
    monkeypatch.setattr(lp_plan, "_TIME_BUDGET_S", 1e6)
    with root_node_mips():
        yield monkeypatch
    clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


def random_pod(name: str, i: int, rng) -> dict:
    """The JAX suite's `_pod`: a shape by index, a selector drawn."""
    cpu, mem = SHAPES[i % len(SHAPES)]
    selector = {}
    if rng.random() < 0.3:
        selector = {ARCH: "amd64"}
    elif rng.random() < 0.15:
        selector = {ZONE: "test-zone-1"}
    return dict(name=name, cpu=cpu, mem=mem, node_selector=selector)


def pods_of(a, dicts) -> list:
    return [testing.case_pod(a, d, CASE_T0) for d in dicts]


def pool_of(a, types, name="default"):
    return [(testing.case_pool(a, dict(name=name)), types)]


def c4(a, price=1.0):
    return a.fake.make_instance_type("c4", cpu=4, memory=16 * GIB, price=price)


def row(result, pipe) -> tuple:
    return (result.mode, result.reason, result.scheduled, result.unschedulable,
            result.fleet_price, result.nodes, result.churn, result.placed,
            result.drift, pipe.state_fingerprint())


def ticks(name, pods_per_tick, pools_per_tick, objective="ffd", deltas=None,
          **pipe_kw):
    """One package's pipeline over the ticks' pod dicts; the rows and
    the pipeline. A catalog function named again on a later tick gives
    the same catalog objects (a new function: a new catalog)."""
    a = api(name)
    pipe = a.incremental.IncrementalPipeline(**pipe_kw, **a.kw)
    rows, built, catalogs = [], {}, {}
    for t, (dicts, make) in enumerate(zip(pods_per_tick, pools_per_tick)):
        if make not in catalogs:
            catalogs[make] = make(a)
        pools = catalogs[make]
        pods = [built.get(d["name"]) or testing.case_pod(a, d, CASE_T0)
                for d in dicts]
        for p in pods:
            built.setdefault(p.metadata.name, p)
        delta = None
        if deltas is not None and deltas[t] is not None:
            added, removed = deltas[t]
            delta = ([p for p in pods if p.metadata.name in added],
                     [f"default/{n}" for n in removed])
        rows.append(row(pipe.solve_tick(pods, pools, objective=objective,
                                        delta=delta), pipe))
    return rows, pipe


def both(*args, **kw):
    got = {name: ticks(name, *args, **kw) for name in BOTH}
    assert got["port"][0] == got["jax"][0]
    return got["port"]


class TestIncrementalOracle:
    @pytest.mark.parametrize("seed", [7, 11, 23, 42])
    def test_incremental_matches_full_on_random_churn(self, seed):
        """Random creates, deletes and replacements over 12 ticks (the
        drift backstop every 4th): every tick equals the JAX package's,
        places as many pods as a full solve of the same population, and
        a checked tick prices within the drift epsilon of it."""
        import random

        rng = random.Random(seed)
        nrng = np.random.default_rng(seed)
        dicts = [random_pod(f"w-{i}", i, nrng) for i in range(300)]
        counter = 300
        per_tick = []
        for _ in range(12):
            for _ in range(rng.randrange(1, 12)):
                op = rng.random()
                if op < 0.45 or not dicts:
                    counter += 1
                    dicts.append(random_pod(f"w-{counter}", counter, nrng))
                elif op < 0.8:
                    dicts.pop(rng.randrange(len(dicts)))
                else:
                    # a replacement: a new object (new shape), same name
                    i = rng.randrange(len(dicts))
                    counter += 1
                    dicts[i] = random_pod(dicts[i]["name"], counter, nrng)
                    dicts[i]["_v"] = counter
            per_tick.append([dict(d) for d in dicts])

        def pools(a):
            return pool_of(a, a.fake.instance_types(30))

        got = {}
        for name in BOTH:
            a = api(name)
            pipe = a.incremental.IncrementalPipeline(
                full_every=4, drift_eps=0.01, repack_objective="ffd", **a.kw)
            catalog = pools(a)
            built, rows = {}, []
            for dicts_t in per_tick:
                pods = []
                for d in dicts_t:
                    key = (d["name"], d.get("_v"))
                    if key not in built:
                        built[key] = testing.case_pod(
                            a, {k: v for k, v in d.items() if k != "_v"}, CASE_T0)
                    pods.append(built[key])
                r = pipe.solve_tick(pods, catalog, objective="ffd")
                rows.append(row(r, pipe))
                if name == "port":
                    full = solver.solve(pods, catalog, objective="ffd", device="cpu")
                    assert r.unschedulable == len(full.unschedulable)
                    assert r.scheduled == len(pods) - len(full.unschedulable)
                    if r.reason in ("checked", "drift") and full.total_price > 0:
                        assert r.fleet_price <= float(full.total_price) * 1.01 + 1e-9
            got[name] = rows
        assert got["port"] == got["jax"]
        assert {r[1] for r in got["port"]} >= {"cold", "steady"}

    def test_cold_and_churn_blowout_run_full(self):
        nrng = np.random.default_rng(3)
        a = [random_pod(f"a-{i}", i, nrng) for i in range(100)]
        b = [random_pod(f"b-{i}", i, nrng) for i in range(40)]
        c1 = random_pod("c-1", 1, nrng)
        t0 = a
        t1 = a[:60] + b
        t2 = t1[1:] + [c1]
        rows, pipe = both([t0, t1, t2],
                          [lambda x: pool_of(x, x.fake.instance_types(20))] * 3,
                          churn_max=0.25, full_every=0)
        assert [r[:2] for r in rows] == [("full", "cold"), ("full", "churn"),
                                         ("incremental", "steady")]

    def test_catalog_change_forces_full(self):
        nrng = np.random.default_rng(3)
        dicts = [random_pod(f"a-{i}", i, nrng) for i in range(50)]
        rows, _ = both([dicts, dicts],
                       [lambda x: pool_of(x, x.fake.instance_types(20)),
                        lambda x: pool_of(x, x.fake.instance_types(22))],
                       full_every=0)
        assert [r[:2] for r in rows] == [("full", "cold"), ("full", "catalog")]

    def test_delta_api_matches_scan(self):
        """The trusted delta and the reconciliation scan land in the same
        state, in both packages."""
        nrng = np.random.default_rng(5)
        dicts = [random_pod(f"a-{i}", i, nrng) for i in range(120)]
        removed = [dicts[i]["name"] for i in (0, 5, 9)]
        born = [random_pod(f"n-{i}", i, nrng) for i in range(3)]
        later = [d for d in dicts if d["name"] not in removed] + born
        pools = [lambda x: pool_of(x, x.fake.instance_types(20))] * 2
        scan, _ = both([dicts, later], pools, full_every=0)
        delta, _ = both([dicts, later], pools, full_every=0,
                        deltas=[None, ({d["name"] for d in born}, removed)])
        assert scan[1][0] == delta[1][0] == "incremental"
        assert scan == delta

    def test_dirty_tracker_catches_inplace_mutation(self):
        """A kube-wired pipeline: a pod mutated in place (same object)
        is invisible to identity diffing; the Pod dirty tracker names it
        and the pipeline re-places it, in both packages alike."""
        got = {}
        for name in BOTH:
            a = api(name)
            kube = a.client.KubeClient()
            pools = pool_of(a, a.fake.instance_types(20))
            pipe = a.incremental.IncrementalPipeline(kube=kube, full_every=0, **a.kw)
            pods = pods_of(a, [dict(name=f"a-{i}", cpu=0.5) for i in range(30)])
            for p in pods:
                kube.create(p)
            kube.deliver()
            pipe._tracker.drain("Pod")  # the create replay
            rows = [row(pipe.solve_tick(pods, pools, objective="ffd"), pipe)]
            pods[3].spec.containers[0].requests["cpu"] = 1.0
            kube.touch(pods[3])
            kube.deliver()
            rows.append(row(pipe.solve_tick(pods, pools, objective="ffd"), pipe))
            node = pipe._where[pods[3].key]
            got[name] = (rows, pods[3].key in node.pods, node.used.get("cpu", 0.0))
        assert got["port"] == got["jax"]
        rows, on_node, cpu = got["port"]
        assert rows[1][0] == "incremental" and rows[1][7] >= 1
        assert on_node and cpu >= 1.0

    def test_heterogeneous_resource_churn_not_overpruned(self):
        """A CPU-only pod sharing a tick with an extended-resource pod
        must still see the GPU-less nodes (the residual prune keys only
        on resources every group requests)."""
        def pools(a):
            cpu_type = a.fake.make_instance_type("c4", cpu=4.0, memory=16 * GIB,
                                                 price=1.0)
            gpu_type = a.fake.make_instance_type("g4", cpu=4.0, memory=16 * GIB,
                                                 price=5.0)
            gpu_type.capacity["example.com/gpu"] = 2.0
            return pool_of(a, [cpu_type, gpu_type])

        got = {}
        for name in BOTH:
            a = api(name)
            catalog = pools(a)
            pipe = a.incremental.IncrementalPipeline(full_every=0, **a.kw)
            pods = pods_of(a, [dict(name=f"c-{i}", cpu=1.0) for i in range(24)])
            rows = [row(pipe.solve_tick(pods, catalog, objective="ffd"), pipe)]
            gpu = testing.case_pod(a, dict(name="gpu-1", cpu=1.0), CASE_T0)
            gpu.spec.containers[0].requests["example.com/gpu"] = 1.0
            pods = pods[:-1] + [testing.case_pod(a, dict(name="c-new", cpu=1.0),
                                                 CASE_T0), gpu]
            rows.append(row(pipe.solve_tick(pods, catalog, objective="ffd"), pipe))
            got[name] = rows
        assert got["port"] == got["jax"]
        r0, r1 = got["port"]
        assert r1[0] == "incremental" and r1[3] == 0
        assert r1[5] <= r0[5] + 1

    def test_unplaced_pods_retry_next_tick(self):
        """A pod no type can hold reports unschedulable every tick and
        schedules once the catalog can hold it."""
        def small(a):
            return [a.fake.make_instance_type("s1", cpu=1.0, memory=4 * GIB, price=1.0)]

        def big(a):
            return small(a) + [a.fake.make_instance_type("b16", cpu=16.0,
                                                         memory=64 * GIB, price=8.0)]

        base = [dict(name="big", cpu=8.0)] + [dict(name=f"s-{i}", cpu=0.5)
                                              for i in range(10)]
        more = base + [dict(name="s-10", cpu=0.5)]
        got = {}
        for name in BOTH:
            a = api(name)
            small_pools = pool_of(a, small(a))
            pipe = a.incremental.IncrementalPipeline(full_every=0, **a.kw)
            pods = pods_of(a, more)
            rows = [row(pipe.solve_tick(pods[:-1], small_pools, objective="ffd"), pipe),
                    row(pipe.solve_tick(pods, small_pools, objective="ffd"), pipe),
                    row(pipe.solve_tick(pods, pool_of(a, big(a)), objective="ffd"), pipe)]
            got[name] = rows
        assert got["port"] == got["jax"]
        assert [r[3] for r in got["port"]] == [1, 1, 0]
        assert got["port"][1][0] == "incremental"


class TestDualGuidedRepack:
    """The residual repack spends the cached dual floor: weak-duality
    skips of the drift backstop, the reduced-cost-ordered repack race;
    invalidated when the catalog moves, dropped on an external adopt."""

    @staticmethod
    def exact_fill(n_pods=12, prefix="df") -> list:
        # 3 x 1.3 cpu fill a c4's 3.9 allocatable exactly: the fleet
        # price sits on the LP floor
        return [dict(name=f"{prefix}-{i}", cpu=1.3, mem=2.0) for i in range(n_pods)]

    def test_floor_skips_drift_backstop(self):
        from karpenter_tpu.metrics.store import SOLVER_INCREMENTAL_DUAL as JDUAL
        from karpenter_tpu_torch.metrics.store import SOLVER_INCREMENTAL_DUAL

        skip = {"outcome": "floor_skip"}
        before = (SOLVER_INCREMENTAL_DUAL.value(skip), JDUAL.value(skip))
        dicts = self.exact_fill()
        rows, pipe = both([dicts, dicts], [lambda a: pool_of(a, [c4(a)], "p")] * 2,
                          objective="cost", full_every=2)
        assert rows[0][:2] == ("full", "cold") and rows[0][3] == 0
        assert rows[1][1] == "dual_floor", "an LP-optimal fleet skips the backstop"
        assert rows[1][8] is not None and rows[1][8] <= pipe.drift_eps + 1e-9
        grew = (SOLVER_INCREMENTAL_DUAL.value(skip) - before[0],
                JDUAL.value(skip) - before[1])
        assert grew == (1, 1)

    def test_floor_skip_is_decision_identical(self, clean):
        """The same churned workload with the floor skip on and off:
        every tick's retained fleet is the same, in both packages."""
        base = self.exact_fill()
        per_tick = [base[t:] + [dict(name=f"c{t}-{i}", cpu=1.3, mem=2.0)
                                for i in range(t)] for t in range(5)]
        pools = [lambda a: pool_of(a, [c4(a)], "p")] * 5
        fps = {}
        for on in ("1", "0"):
            clean.setenv("KARPENTER_INCR_DUAL_FLOOR", on)
            rows, _ = both(per_tick, pools, objective="cost", full_every=2)
            fps[on] = [r[9] for r in rows]
            reasons = [r[1] for r in rows]
            assert ("dual_floor" in reasons) == (on == "1"), reasons
        assert fps["1"] == fps["0"]

    def test_rank_race_never_worse(self, clean):
        """Churn that forces fresh opens on a heterogeneous catalog: the
        guided arm may win or lose the race, but the fleet is never
        worse than the unguided run's, and equals the JAX package's."""
        rng = np.random.default_rng(11)
        start = [random_pod(f"rr-{i}", i, rng) for i in range(24)]
        per_tick = [start]
        for t in range(3):
            per_tick.append(per_tick[-1][2:] + [
                dict(name=f"rg-{t}-{i}", cpu=2.0 + i, mem=4.0 + 2 * i) for i in range(3)])
        pools = [lambda a: pool_of(a, a.fake.heterogeneous_instance_types(12), "p")] * 4
        last = {}
        for on in ("1", "0"):
            clean.setenv("KARPENTER_INCR_DUAL_RANK", on)
            rows, _ = both(per_tick, pools, objective="cost", full_every=0)
            last[on] = rows[-1]
        assert last["1"][3] == last["0"][3]
        assert last["1"][4] <= last["0"][4] + 1e-6

    def test_catalog_move_invalidates_certificate(self):
        got = {}
        dicts = self.exact_fill(6)
        for name in BOTH:
            a = api(name)
            pipe = a.incremental.IncrementalPipeline(full_every=0, **a.kw)
            pods = pods_of(a, dicts)
            pipe.solve_tick(pods, pool_of(a, [c4(a)], "p"))
            old = pipe._dual
            assert old is not None
            res = pipe.solve_tick(pods, pool_of(a, [c4(a, price=2.0)], "p"))
            assert res.reason == "catalog" and pipe._dual is not old
            got[name] = (row(res, pipe), sorted(pipe._dual.lam_by_sig.values()))
        assert got["port"][0] == got["jax"][0]
        for p, j in zip(got["port"][1], got["jax"][1]):
            assert abs(p - j) <= 1e-6

    def test_external_adopt_drops_certificate(self):
        for name in BOTH:
            a = api(name)
            pipe = a.incremental.IncrementalPipeline(full_every=0, **a.kw)
            pods = pods_of(a, self.exact_fill(6))
            pools = pool_of(a, [c4(a)], "p")
            pipe.solve_tick(pods, pools)
            assert pipe._dual is not None
            sol = a.solver.solve(pods, pools, objective="cost", **a.kw)
            pipe.adopt(pods, sol, pools)
            assert pipe._dual is None, name

    def test_lam_by_sig_within_the_ascent_bound(self):
        """`build_dual_floor` on the same encode in both packages: the
        same signatures, duals within 1e-6 (ROADMAP C2), the same
        reservation-cap term and rank prices within the same bound, and
        a `bound_for` of the demand that agrees."""
        from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup
        from karpenter_tpu_torch.solver.encode import encode, group_pods

        got = {}
        for name, enc_fn, group_fn in (("port", encode, group_pods),
                                       ("jax", jencode, jgroup)):
            a = api(name)
            rng = np.random.default_rng(4)
            pods = pods_of(a, [random_pod(f"lb-{i}", i, rng) for i in range(60)])
            types = a.fake.heterogeneous_instance_types(12)
            rsv = a.fake.make_instance_type("r4", cpu=4, memory=16 * GIB, price=1.0,
                                            reservations=[("rsv-1", "test-zone-1", 2)])
            enc = enc_fn(group_fn(pods), pool_of(a, types + [rsv]))
            floor = a.incremental.build_dual_floor(enc, **a.kw)
            got[name] = (floor, floor.bound_for(group_fn(pods)))
        (port, pb), (ref, jb) = got["port"], got["jax"]
        lam = {repr(k): v for k, v in port.lam_by_sig.items()}
        jlam = {repr(k): v for k, v in ref.lam_by_sig.items()}
        assert lam.keys() == jlam.keys() and len(lam) >= 5
        assert max(abs(lam[k] - jlam[k]) for k in lam) <= 1e-6
        assert abs(port.cap_term - ref.cap_term) <= 1e-6
        assert port.n_launch == ref.n_launch
        assert np.max(np.abs(port.rank_launch - ref.rank_launch)) <= 1e-5
        assert abs(pb - jb) <= 1e-6 * max(1.0, len(lam))


def test_explain_record_of_a_guided_cost_round_matches_jax():
    """ROADMAP C5: a cost round under an open explain record (the
    pipeline's cold tick: the cost solve, whose race asks the device LP,
    and the dual floor's refresh) notes one LP summary a solve of the
    device LP, as the JAX package does; the records are equal."""
    from karpenter_tpu import explain as jexplain
    from karpenter_tpu_torch import explain

    records = {}
    for name, mod in (("port", explain), ("jax", jexplain)):
        a = api(name)
        mod.clear()
        pipe = a.incremental.IncrementalPipeline(full_every=0, **a.kw)
        pods = pods_of(a, TestDualGuidedRepack.exact_fill(9, "ex"))
        with mod.tick("t-c5"):
            pipe.solve_tick(pods, pool_of(a, [c4(a)], "p"), objective="cost")
        records[name] = mod.find_tick("t-c5")
        mod.clear()
    assert records["port"] == records["jax"]
    lp = records["port"]["lp"]
    assert len(lp) >= 1 and lp[0]["binding_groups"], lp
    assert lp[0]["bound"] > 0
