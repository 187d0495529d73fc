"""The port's consolidation probe path against the JAX package's, on
CPU.

(a) `LaneSolver(device="cpu")` against the JAX `LaneSolver` on the
    fleets of tests/test_consolidation_batch_oracle.py (seeds 3 and 11,
    both modes, its ten prefix lanes and four random lanes): the
    `summarize` tuple of every lane equal, on the batched route
    (KARPENTER_PROBE_BATCH_WIDTH=8 in both packages: B6 over the lane
    axis), the solo route (the width unset: 1 on the CPU in both) and
    the wavefront route (KARPENTER_WAVEFRONT=force with width 8);
    `last_shapes` equal, with and without `shape_floors`.
(b) `lp_device.DualCertificate` built from the JAX package's duals
    (carried through `device_lp_from_arrays`): `absorb`, `absorb_total`,
    `cap_term` and `floor` exactly equal. From the port's own duals
    (B5's plain version): `floor` within 1e-6 relative of the JAX
    package's, and `ProbePruner.cannot_pay` equal wherever the floor
    is more than 1e-6 relative away from the pruning threshold.
(c) weak duality: for every lane whose pods all found a place, the new
    nodes' price is at least the certificate's floor (less 1e-9 +
    1e-9 relative), so no pruned lane has a strictly cheaper solution.
(d) `workloads.consolidation_fleet` at a small size against
    `bench.py`'s consolidation_500 recipe built with the JAX modules:
    equal node inputs, prices and pods per node.
(e) `testing.consolidation_ladder` arms (a) and (c) at that size make
    identical decisions and reach the same fleet price, and both equal
    the JAX modules running the same loop.

Tolerance: exact equality unless stated above.
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.apis.v1.labels import (
    CAPACITY_TYPE_LABEL as J_CAPACITY_TYPE_LABEL,
    HOSTNAME_LABEL as J_HOSTNAME_LABEL,
    INSTANCE_TYPE_LABEL as J_INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL as J_NODEPOOL_LABEL,
    TOPOLOGY_ZONE_LABEL as J_TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver.consolidation_batch import (
    LaneSolver as JLaneSolver,
    ProbeLane as JProbeLane,
    ProbePruner as JProbePruner,
)
from karpenter_tpu.solver.encode import ExistingNodeInput as JExisting
from karpenter_tpu.solver.solver import solve as jsolve
from karpenter_tpu.utils import resources as jresutil
from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    HOSTNAME_LABEL,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.fake import GIB, instance_types
from karpenter_tpu_torch.kube.objects import Container, ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.solver import lp_device
from karpenter_tpu_torch.solver.consolidation_batch import (
    LaneSolver,
    ProbeLane,
    ProbePruner,
)
from karpenter_tpu_torch.solver.encode import ExistingNodeInput
from karpenter_tpu_torch.solver.solver import solve
from karpenter_tpu_torch.testing import (
    Candidate,
    NodeRef,
    consolidation_ladder,
    one_core,
    summarize,
)
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.workloads import consolidation_fleet
from test_consolidation_batch_oracle import (
    SHAPES,
    ZONES,
    build_fleet as jbuild_fleet,
    summarize as jsummarize,
)

# the small consolidation_500 fleet of (d) and (e)
SMALL = dict(n_pods=300, n_types=10)


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """These comparisons compile many JAX programs and run the plain
    versions on small tensors: on one core, they leave the suite's
    other workers, some of which time milliseconds, their cores."""
    with one_core():
        yield


@pytest.fixture(autouse=True)
def _lp_caches():
    jlp_device.reset()
    lp_device.reset()
    yield
    jlp_device.reset()
    lp_device.reset()


def build_fleet(seed: int, n_pods: int = 240, n_types: int = 24):
    """`build_fleet` of tests/test_consolidation_batch_oracle.py on the
    port's types and solve: (pools, existing inputs, kept pods per
    node, node prices)."""
    rng = np.random.default_rng(seed)
    pool = NodePool(metadata=ObjectMeta(name="default", namespace=""))
    types = instance_types(n_types)
    pods = []
    for i in range(n_pods):
        cpu, mem = SHAPES[int(rng.integers(len(SHAPES)))]
        selector = {}
        if rng.random() < 0.2:
            selector[TOPOLOGY_ZONE_LABEL] = ZONES[int(rng.integers(3))]
        if rng.random() < 0.15:
            selector["kubernetes.io/arch"] = "amd64"
        pods.append(Pod(
            metadata=ObjectMeta(name=f"o-{seed}-{i}"),
            spec=PodSpec(containers=[Container(requests={
                "cpu": cpu, "memory": mem * GIB})], node_selector=selector),
        ))
    fleet = solve(pods, [(pool, types)], objective="ffd", device="cpu")
    inputs, pods_on, prices = [], [], []
    for ni, plan in enumerate(fleet.new_nodes):
        kept = [p for p in plan.pods if rng.random() >= 0.5]
        it = plan.instance_types[0]
        off = plan.offerings[0]
        labels = {
            NODEPOOL_LABEL: pool.metadata.name,
            INSTANCE_TYPE_LABEL: it.name,
            TOPOLOGY_ZONE_LABEL: off.zone,
            CAPACITY_TYPE_LABEL: off.capacity_type,
            HOSTNAME_LABEL: f"n-{ni}",
        }
        used = resutil.requests_for_pods(kept)
        inputs.append(ExistingNodeInput(
            name=f"n-{ni}",
            requirements=Requirements.from_labels(labels),
            taints=(),
            available={k: max(0.0, v - used.get(k, 0.0))
                       for k, v in it.allocatable.items()},
            pool_name=pool.metadata.name,
            pod_count=len(kept),
        ))
        pods_on.append(kept)
        prices.append(plan.price)
    return [(pool, types)], inputs, pods_on, prices


def _lane_sets(seed, n_inputs, pods_on):
    """The oracle test's lanes: ten prefixes of the candidate order
    (fewest pods first), then four random subsets."""
    order = sorted(range(n_inputs), key=lambda i: (len(pods_on[i]), i))
    sets = [order[:n] for n in range(1, min(10, n_inputs) + 1)]
    rng = np.random.default_rng(seed + 99)
    for _ in range(4):
        k = int(rng.integers(1, min(8, n_inputs)))
        sets.append(sorted(rng.choice(n_inputs, size=k, replace=False).tolist()))
    return sets


@pytest.fixture(scope="module")
def fleets():
    out = {}
    for seed in (3, 11):
        port = build_fleet(seed)
        jax_ = jbuild_fleet(seed)
        sets = _lane_sets(seed, len(port[1]), port[2])
        out[seed] = (port, jax_, sets)
    return out


def _lanes(sets, inputs, pods_on, lane_cls):
    return [
        lane_cls(exclude_names=tuple(inputs[i].name for i in s),
                 pods=[p for i in s for p in pods_on[i]])
        for s in sets
    ]


ROUTES = {
    "batched": {"KARPENTER_PROBE_BATCH_WIDTH": "8"},
    "solo": {},
    "wavefront": {"KARPENTER_PROBE_BATCH_WIDTH": "8", "KARPENTER_WAVEFRONT": "force",
                  "KARPENTER_WAVEFRONT_WIDTH": "8"},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("seed", [3, 11])
def test_lane_solutions_equal_jax(fleets, monkeypatch, seed, mode, route):
    for knob in ("KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_WAVEFRONT",
                 "KARPENTER_WAVEFRONT_WIDTH"):
        monkeypatch.delenv(knob, raising=False)
    for knob, value in ROUTES[route].items():
        monkeypatch.setenv(knob, value)
    (pools, inputs, pods_on, _), (jpools, jinputs, jpods_on), sets = fleets[seed]
    assert [i.name for i in inputs] == [i.name for i in jinputs]
    assert [[p.key for p in ps] for ps in pods_on] == [[p.key for p in ps] for ps in jpods_on]
    port = LaneSolver(pools, inputs, device="cpu")
    got = port.solve(_lanes(sets, inputs, pods_on, ProbeLane), mode=mode)
    jax_ = JLaneSolver(jpools, jinputs)
    want = jax_.solve(_lanes(sets, jinputs, jpods_on, JProbeLane), mode=mode)
    assert len(got) == len(want) == len(sets)
    for s, g, w in zip(sets, got, want):
        assert summarize(g, inputs) == jsummarize(w, jinputs), (route, mode, s)
    assert port.last_shapes == jax_.last_shapes


def test_shape_floors_equal_jax(fleets):
    (pools, inputs, pods_on, _), (jpools, jinputs, jpods_on), sets = fleets[3]
    floors = {"G": 40, "C": 300, "E": 90, "F": 200}
    port = LaneSolver(pools, inputs, shape_floors=floors, device="cpu")
    jax_ = JLaneSolver(jpools, jinputs, shape_floors=floors)
    got = port.solve(_lanes(sets[-4:], inputs, pods_on, ProbeLane))
    want = jax_.solve(_lanes(sets[-4:], jinputs, jpods_on, JProbeLane))
    assert port.last_shapes == jax_.last_shapes
    assert port.last_shapes["C"] % 32 == 0 and port.last_shapes["F"] >= 200
    for g, w in zip(got, want):
        assert summarize(g, inputs) == jsummarize(w, jinputs)


def _stage_both(fleets, seed):
    (pools, inputs, pods_on, prices), (jpools, jinputs, jpods_on), _ = fleets[seed]
    order = sorted(range(len(inputs)), key=lambda i: (len(pods_on[i]), i))
    sets = [order[:n] for n in range(1, len(order) + 1)]
    port = LaneSolver(pools, inputs, device="cpu")
    thunks = port.solve_lazy(_lanes(sets, inputs, pods_on, ProbeLane))
    jax_ = JLaneSolver(jpools, jinputs)
    jax_.solve_lazy(_lanes(sets, jinputs, jpods_on, JProbeLane))
    return port, jax_, sets, thunks


def _demand(solver, s, pods_on):
    d = np.zeros(solver.last_enc.compat.shape[0], np.int64)
    for i in s:
        for p in pods_on[i]:
            d[solver.last_gi_by_key[p.key]] += 1
    return d


@pytest.mark.parametrize("seed", [3, 11])
def test_certificate_from_jax_duals_is_exact(fleets, seed):
    port, jax_, sets, _ = _stage_both(fleets, seed)
    jcert = jax_.dual_certificate()
    assert jcert is not None
    jdlp = jlp_device.maybe_solve(jax_.last_enc)
    cert = lp_device.DualCertificate(
        port.last_enc, lp_device.device_lp_from_arrays(vars(jdlp)))
    assert cert.absorb == jcert.absorb
    assert cert.absorb_total == jcert.absorb_total
    assert cert.cap_term == jcert.cap_term
    pods_on = fleets[seed][0][2]
    for s in sets:
        d = _demand(port, s, pods_on)
        np.testing.assert_array_equal(d, _demand(jax_, s, pods_on))
        assert cert.floor(d, s) == jcert.floor(d, s)


@pytest.mark.parametrize("seed", [3, 11])
def test_port_duals_floor_and_pruner_match_jax(fleets, seed):
    port, jax_, sets, _ = _stage_both(fleets, seed)
    (_, inputs, pods_on, prices), _, _ = fleets[seed]
    cert, jcert = port.dual_certificate(), jax_.dual_certificate()
    assert cert is not None and jcert is not None
    pruner, jpruner = ProbePruner(port), JProbePruner(jax_)
    margin = lp_device.prune_margin()
    compared = 0
    for s in sets:
        d = _demand(port, s, pods_on)
        f, jf = cert.floor(d, s), jcert.floor(d, s)
        assert abs(f - jf) <= 1e-6 * max(1.0, abs(jf)), s
        price = sum(prices[i] for i in s)
        cands = [Candidate(NodeRef(inputs[i].name), prices[i], pods_on[i]) for i in s]
        threshold = price * (1.0 + margin) + 1e-9
        if abs(jf - threshold) > 1e-6 * max(1.0, abs(threshold)):
            assert pruner.cannot_pay(cands) == jpruner.cannot_pay(cands), s
            compared += 1
    assert compared >= len(sets) - 1


@pytest.mark.parametrize("seed", [3, 11])
def test_no_lane_beats_the_floor(fleets, seed):
    port, _, sets, thunks = _stage_both(fleets, seed)
    (_, inputs, pods_on, prices), _, _ = fleets[seed]
    cert = port.dual_certificate()
    pruner = ProbePruner(port)
    feasible = 0
    for s, thunk in zip(sets, thunks):
        sol = thunk()
        floor = cert.floor(_demand(port, s, pods_on), s)
        if sol.unschedulable:
            continue
        feasible += 1
        added = sum(x.price for x in sol.new_nodes)
        assert added >= floor - 1e-9 - 1e-9 * abs(floor), (s, added, floor)
        cands = [Candidate(NodeRef(inputs[i].name), prices[i], pods_on[i]) for i in s]
        if pruner.cannot_pay(cands):
            assert added >= sum(prices[i] for i in s), s
    assert feasible > 0


# -- the consolidation_500 fleet and ladder ----------------------------------


def _jax_fleet(n_pods, n_types, seed=9, drop=0.55, rng_seed=7):
    """bench.py's consolidation_500 set-up (`scenario_consolidation`,
    up to `fleet_before`) on the JAX modules."""
    rng = np.random.default_rng(rng_seed)
    pods, pools = bench.build_problem(n_pods, n_types, seed=seed)
    fleet = jsolve(pods, pools, objective="ffd")
    keep_mask = rng.random(len(pods)) >= drop
    keep = {p.metadata.name for p, k in zip(pods, keep_mask) if k}
    nodes, prices, pods_on = [], [], []
    for ni, plan in enumerate(fleet.new_nodes):
        kept = [p for p in plan.pods if p.metadata.name in keep]
        nodes.append(_jax_node_input(f"n-{ni}", plan.instance_types[0],
                                     plan.offerings[0], plan.pool, kept))
        prices.append(plan.price)
        pods_on.append(kept)
    return pools, nodes, prices, pods_on


def _jax_node_input(name, it, offering, pool, kept_pods):
    used = jresutil.requests_for_pods(kept_pods)
    labels = {
        J_NODEPOOL_LABEL: pool.metadata.name,
        J_INSTANCE_TYPE_LABEL: it.name,
        J_TOPOLOGY_ZONE_LABEL: offering.zone,
        J_CAPACITY_TYPE_LABEL: offering.capacity_type,
        J_HOSTNAME_LABEL: name,
    }
    return JExisting(
        name=name,
        requirements=JRequirements.from_labels(labels),
        taints=(),
        available={k: max(0.0, v - used.get(k, 0.0)) for k, v in it.allocatable.items()},
        pool_name=pool.metadata.name,
        pod_count=len(kept_pods),
    )


def _jax_ladder(pools, nodes, prices, pods_on, batched, fresh=0):
    """The decisions, final price and fresh-node counter of bench.py's
    consolidation_500 loop, arm (a) or arm (c), on the JAX modules
    (`bench.py:1059-1275`; arm (c) goes on from arm (a)'s counter)."""
    nodes, prices = list(nodes), list(prices)
    pods_on = [list(ps) for ps in pods_on]
    decisions = []
    for _ in range(12):
        occupied = [i for i, ps in enumerate(pods_on) if ps]
        nodes = [nodes[i] for i in occupied]
        prices = [prices[i] for i in occupied]
        pods_on = [pods_on[i] for i in occupied]
        candidates = sorted(range(len(nodes)), key=lambda i: (len(pods_on[i]), i))[:100]
        if batched:
            verdicts = JLaneSolver(pools, nodes).solve_lazy([
                JProbeLane(exclude_names=tuple(nodes[i].name for i in candidates[:n]),
                           pods=[p for i in candidates[:n] for p in pods_on[i]])
                for n in range(1, len(candidates) + 1)])

        def prefix_try(n):
            if batched:
                sol = verdicts[n - 1]()
            else:
                cand = set(candidates[:n])
                rest = [node for i, node in enumerate(nodes) if i not in cand]
                moved = [p for i in cand for p in pods_on[i]]
                sol = jsolve(moved, pools, existing=rest, objective="ffd")
            if sol.unschedulable or len(sol.new_nodes) > 1:
                return None
            removed = sum(prices[i] for i in (candidates[:n] if batched
                                              else set(candidates[:n])))
            added = sum(x.price for x in sol.new_nodes)
            return None if removed <= added else (removed - added, sol)

        lo, hi, best = 1, len(candidates), None
        while lo <= hi:
            mid = (lo + hi) // 2
            found = prefix_try(mid)
            if found is not None:
                best = (mid, *found)
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            break
        n_star, saving, sol = best
        decisions.append((n_star, round(saving, 6)))
        cand = set(candidates[:n_star])
        rest_index = [i for i in range(len(nodes)) if i not in cand]
        pos = ({full: j for j, full in enumerate(rest_index)} if batched
               else {j: j for j in range(len(rest_index))})
        new_nodes = [nodes[i] for i in rest_index]
        new_prices = [prices[i] for i in rest_index]
        new_pods_on = [list(pods_on[i]) for i in rest_index]
        for ea in sol.existing:
            j = pos[ea.existing_index]
            new_pods_on[j] = new_pods_on[j] + ea.pods
            used = jresutil.requests_for_pods(ea.pods)
            node = new_nodes[j]
            new_nodes[j] = JExisting(
                name=node.name, requirements=node.requirements, taints=node.taints,
                available={k: max(0.0, v - used.get(k, 0.0))
                           for k, v in node.available.items()},
                pool_name=node.pool_name, pod_count=node.pod_count + len(ea.pods))
        for plan in sol.new_nodes:
            fresh += 1
            new_nodes.append(_jax_node_input(f"{'b' if batched else 'r'}-{fresh}",
                                             plan.instance_types[0], plan.offerings[0],
                                             plan.pool, plan.pods))
            new_prices.append(plan.price)
            new_pods_on.append(list(plan.pods))
        nodes, prices, pods_on = new_nodes, new_prices, new_pods_on
    return decisions, float(sum(prices)), fresh


@pytest.fixture(scope="module")
def small_fleets():
    return consolidation_fleet(**SMALL, device="cpu"), _jax_fleet(**SMALL)


def test_consolidation_fleet_equals_the_bench_recipe(small_fleets):
    (pools, nodes, prices, pods_on), (_, jnodes, jprices, jpods_on) = small_fleets
    assert len(nodes) == len(jnodes) > 30
    assert prices == jprices
    assert [[p.key for p in ps] for ps in pods_on] == [[p.key for p in ps] for ps in jpods_on]
    for a, b in zip(nodes, jnodes):
        assert (a.name, a.taints, a.available, a.pool_name, a.pod_count) == (
            b.name, b.taints, b.available, b.pool_name, b.pod_count)
        assert a.requirements.signature() == b.requirements.signature()
    assert sum(1 for ps in pods_on if not ps) < len(pods_on)


def test_ladder_arms_agree_with_each_other_and_jax(small_fleets, monkeypatch):
    monkeypatch.delenv("KARPENTER_PROBE_BATCH_WIDTH", raising=False)
    monkeypatch.delenv("KARPENTER_WAVEFRONT", raising=False)
    port_fleet, jax_fleet = small_fleets
    a = consolidation_ladder(*port_fleet, batched=False, device="cpu")
    c = consolidation_ladder(*port_fleet, batched=True, device="cpu", fresh=a.fresh)
    assert a.decisions and a.decisions == c.decisions
    eps = 1e-6 + 1e-4 * abs(a.price)
    assert abs(a.price - c.price) < eps
    assert c.lanes > 0 and len(c.walls) == c.cycles
    ja = _jax_ladder(*jax_fleet, batched=False)
    jc = _jax_ladder(*jax_fleet, batched=True, fresh=ja[2])
    assert ja[0] == jc[0] == a.decisions
    assert ja[2] == a.fresh and jc[2] == c.fresh
    assert abs(ja[1] - a.price) < eps and abs(jc[1] - c.price) < eps
