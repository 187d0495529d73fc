"""The JAX package's engine-level probe oracles, run on the port, and the
port's commands equal to the JAX package's in each case.

- batched ≡ sequential (`tests/test_consolidation_batch_oracle.py`):
  `multi_node_consolidation`, `single_node_consolidation` and `drift`
  decide the same command with KARPENTER_BATCH_PROBES on and off; here
  on the oracle's fixture (five one-pod 2-cpu nodes) and on a seeded
  fleet of 24 mixed nodes, with a lane chunk of one (the CPU default)
  and of 8 lanes (B6's plain version);
- pruning on ≡ off (`tests/test_lp_prune.py`): the dual certificate
  (B5's plain version) never changes a decision; on a fully packed
  spot fleet under KARPENTER_SPOT_PENALTY=0.5 it prunes every probe,
  KARPENTER_LP_PRUNE=0 leaves its counter alone, and a pruned probe
  never reaches `simulate_scheduling`.

Both packages' fleets come from one `ProvisionCase`; commands compare by
`testing.command_identity`, exactly.
"""

import random

import pytest

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.metrics.store import SOLVER_PROBE_BATCH, SOLVER_PROBE_PRUNED
from karpenter_tpu_torch.solver import consolidation_batch

from karpenter_tpu.metrics.store import SOLVER_PROBE_BATCH as J_PROBE_BATCH
from karpenter_tpu.metrics.store import SOLVER_PROBE_PRUNED as J_PROBE_PRUNED

from test_torch_disruption import (  # noqa: F401  (fixtures)
    T0,
    _one_core,
    clean,
    fleet_case,
    scale_down,
    world,
)

METHODS = ["multi_node_consolidation", "single_node_consolidation", "drift"]
MIXED = ("custom", (("c2", 2, 8, 2.0), ("c4", 4, 16, 3.0), ("c8", 8, 32, 5.0)), 1)
SPOT = ("custom", (("s2", 2, 8, 2.0), ("s8", 8, 32, 8.0)), 1)
PRUNED = {"port": SOLVER_PROBE_PRUNED, "jax": J_PROBE_PRUNED}
BATCH = {"port": SOLVER_PROBE_BATCH, "jax": J_PROBE_BATCH}


def mixed_case() -> testing.ProvisionCase:
    """The oracle suite's `_mixed_env`: five 2-cpu nodes, one 1-cpu pod
    each, on a catalog of 2, 4 and 8 cpu."""
    nodes = [dict(name=f"m-node-{i}", type=0, pool="default",
                  zone=testing.ZONES[i % 3], finalizer=True,
                  pods=[testing._pod(f"m-{i}", 1.0, 2.0)])
             for i in range(5)]
    return testing.ProvisionCase("mixed", pools=[dict(name="default")],
                                 catalog=MIXED, nodes=nodes)


def spot_case(api) -> testing.ProvisionCase:
    """`tests/test_lp_prune.py`'s `_spot_env`: five spot 2-cpu nodes,
    each filled by one pod of its whole allocatable cpu."""
    fill = api.fake.make_instance_type("s2", cpu=2, memory=8 * testing.GIB,
                                       price=2.0).allocatable["cpu"]
    sel = {"karpenter.sh/capacity-type": "spot"}
    nodes = [dict(name=f"sp-node-{i}", type=0, pool="default",
                  zone=testing.ZONES[i % 3], capacity_type="spot", finalizer=True,
                  pods=[testing._pod(f"sp-{i}", float(fill), 2.0, node_selector=sel)])
             for i in range(5)]
    return testing.ProvisionCase("spot", pools=[dict(name="default")],
                                 catalog=SPOT, nodes=nodes)


def fixture(name: str, package: str, method: str):
    if name == "mixed":
        env, api = world(package, mixed_case())
    else:
        env, api = world(package, fleet_case(11), scale_down(0.5, seed=12))
    now = T0 + 100
    env.pod_events.reconcile_all(now=now)
    env.conditions.reconcile_all(now=now)
    if method == "drift":
        for claim in env.kube.node_claims():
            claim.status_conditions.set_true(api.nodeclaim.COND_DRIFTED, now=now)
    return env, api, now


def run(env, now, method, monkeypatch, batch: str, prune: str = "1"):
    monkeypatch.setenv("KARPENTER_BATCH_PROBES", batch)
    monkeypatch.setenv("KARPENTER_LP_PRUNE", prune)
    env.disruption._rng = random.Random(0)  # the same rotation shuffle
    return testing.command_identity(getattr(env.disruption, method)(now))


@pytest.mark.parametrize("width", ["1", "8"])
@pytest.mark.parametrize("name", ["mixed", "fleet"])
@pytest.mark.parametrize("method", METHODS)
def test_batched_equals_sequential_and_jax(method, name, width, clean):
    clean.setenv("KARPENTER_PROBE_BATCH_WIDTH", width)
    out = {}
    for package in ("port", "jax"):
        env, api, now = fixture(name, package, method)
        sequential = run(env, now, method, clean, "0")
        fallbacks = BATCH[package].value({"outcome": "fallback_lane"})
        shipped = BATCH[package].value({"outcome": "lane"})
        batched = run(env, now, method, clean, "1")
        out[package] = (sequential, batched,
                        BATCH[package].value({"outcome": "fallback_lane"}) - fallbacks)
        if package == "port":
            lanes = BATCH[package].value({"outcome": "lane"}) - shipped
    assert out["port"][0] == out["port"][1], "batched probes changed the decision"
    assert out["port"] == out["jax"]
    assert lanes > 0, "the batch never ran: the fixture is vacuous"
    if method == "multi_node_consolidation":
        assert out["port"][1] is not None and len(out["port"][1][1]) >= 2


@pytest.mark.parametrize("method", METHODS)
def test_pruning_on_equals_off_and_jax(method, clean):
    out = {}
    for package in ("port", "jax"):
        env, api, now = fixture("mixed", package, method)
        unpruned = run(env, now, method, clean, "1", prune="0")
        clear()
        pruned = run(env, now, method, clean, "1", prune="1")
        out[package] = (unpruned, pruned)
    assert out["port"][0] == out["port"][1]
    assert out["port"] == out["jax"]
    if method == "multi_node_consolidation":
        assert out["port"][1] is not None and len(out["port"][1][1]) >= 2


def clear():
    from karpenter_tpu.solver import lp_device as jlp_device
    from karpenter_tpu_torch.solver import lp_device

    lp_device.reset()
    jlp_device.reset()


def spot_world(package: str, monkeypatch):
    monkeypatch.setenv("KARPENTER_SPOT_PENALTY", "0.5")
    from test_torch_disruption import PACKAGES

    env, api = world(package, spot_case(PACKAGES[package][0]()))
    now = T0 + 100
    env.pod_events.reconcile_all(now=now)
    env.conditions.reconcile_all(now=now)
    return env, api, now


@pytest.mark.parametrize("method", ["single_node_consolidation", "multi_node_consolidation"])
def test_pruning_fires_on_unpayable_spot_fleet(method, clean):
    out = {}
    for package in ("port", "jax"):
        env, api, now = spot_world(package, clean)
        unpruned = run(env, now, method, clean, "1", prune="0")
        clear()
        before = PRUNED[package].total()
        pruned = run(env, now, method, clean, "1", prune="1")
        out[package] = (unpruned, pruned, PRUNED[package].total() - before)
    assert out["port"] == out["jax"]
    unpruned, pruned, fired = out["port"]
    assert pruned == unpruned and pruned is None
    assert fired > 0, "the dual certificate never fired on an unpayable fleet"


def test_prune_kill_switch(clean):
    """KARPENTER_LP_PRUNE=0 leaves the counter untouched."""
    env, api, now = spot_world("port", clean)
    clean.setenv("KARPENTER_BATCH_PROBES", "1")
    clean.setenv("KARPENTER_LP_PRUNE", "0")
    before = SOLVER_PROBE_PRUNED.total()
    env.disruption.single_node_consolidation(now)
    assert SOLVER_PROBE_PRUNED.total() == before


@pytest.mark.parametrize("package", ["port", "jax"])
def test_pruned_probe_skips_the_simulation(package, clean):
    """A pruned `compute_consolidation` never reaches
    `simulate_scheduling`; the port prunes as many probes as the JAX
    package (held by the parametrization's two runs alike)."""
    env, api, now = spot_world(package, clean)
    clean.setenv("KARPENTER_BATCH_PROBES", "1")
    clean.setenv("KARPENTER_LP_PRUNE", "1")
    clear()
    calls = []
    orig = env.disruption.simulate_scheduling

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    clean.setattr(env.disruption, "simulate_scheduling", counting)
    before = PRUNED[package].total()
    env.disruption._rng = random.Random(0)
    env.disruption.single_node_consolidation(now)
    fired = PRUNED[package].total() - before
    assert fired == 5
    assert not calls, f"{len(calls)} simulations ran despite {fired} pruned probes"
