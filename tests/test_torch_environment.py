"""The port's `testing.Environment` (in-memory API, cluster mirror, kwok
provider and every controller on one simulated clock), held against
the JAX package's on the CPU.

(a) One stream through both packages at seeds 0-2
    (`testing.environment_stream`): a seeded burst of pods provisioned
    (claims launched through the lifecycle controller and the kwok
    provider, nodes registered and initialized, pods bound), 30% of the
    bound pods deleted and `reconcile_disruption` rounds to the end,
    `reconcile_termination`, then three spot interruptions and
    `reconcile_interruption` rounds: every step's name-insensitive
    decision and fleet equal.
(b) The Environment recipe of the verify skill, in both packages: a
    provision burst, capacity reuse by a second burst, a claim's
    deletion torn down (claims, nodes and the provider's instances all
    shrink), and unschedulable probes (a giant pod, an unknown custom
    label, a tainted pool) left pending with the same errors.
(c) The kwok provider's registration delay against the Environment's
    one clock: instances register only once the simulated `now` passes
    the delay, in both packages alike.
(d) The providers' choice of type: `types.named_by`, the instance-type
    key of `Requirements.intersects` run ahead of it, drops only types
    that `intersects` rejects, so the compatible types of a claim's
    requirements (In, NotIn, Exists, DoesNotExist on the instance type,
    with and without other keys) are the JAX package's.

Tolerance: exact equality.
"""

import numpy as np
import pytest

import karpenter_tpu.testing as jtesting
from karpenter_tpu.cloudprovider.fake import instance_types as jinstance_types
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.solver import faults, lp_device, lp_plan, solver

SHAPES = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0), (1.5, 2.0), (0.5, 4.0), (1.0, 0.5)]


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
def _clean(monkeypatch):
    for knob in ("KARPENTER_FAULTS", "KARPENTER_FAULT_SEED", "KARPENTER_BATCH_PROBES",
                 "KARPENTER_LP_PRUNE", "KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_INCREMENTAL",
                 "KARPENTER_SPOT_PENALTY", "KARPENTER_SOLVER_BACKEND"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jlp_plan, "_TIME_BUDGET_S", 1e6)
    monkeypatch.setattr(lp_plan, "_TIME_BUDGET_S", 1e6)
    _clear()
    with testing.root_node_mips():
        yield
    _clear()


PACKAGES = {
    "port": (testing, instance_types, faults, {"device": "cpu"}),
    "jax": (jtesting, jinstance_types, jfaults, {}),
}


def _pods(t, seed: int, n: int, prefix: str = "e"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cpu, mem = SHAPES[int(rng.integers(len(SHAPES)))]
        out.append(t.mk_pod(name=f"{prefix}{seed}-{i}", cpu=cpu, memory=mem * 2**30))
    return out


def _env(pkg: str, n_types: int = 20, **kw):
    t, types, _, dev = PACKAGES[pkg]
    env = t.Environment(types=types(n_types), **dev, **kw)
    env.kube.create(t.mk_nodepool("default"))
    return env


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_decides_like_jax(seed):
    out = {}
    for pkg in ("port", "jax"):
        t, _, flt, _ = PACKAGES[pkg]
        out[pkg] = testing.environment_stream(_env(pkg), _pods(t, seed, 60), flt, seed=seed)
        _clear()
    assert out["port"] == out["jax"]
    steps = [r["step"] for r in out["port"]]
    assert steps[0] == "provision" and "termination" in steps
    assert any(r["decision"] for r in out["port"] if r["step"] == "disruption")
    assert any(r["decision"] for r in out["port"] if r["step"] == "interruption")
    fleet = out["port"][-1]["fleet"]
    assert not fleet[1], "pods left pending at the end"
    assert fleet[2] == fleet[3] == len(fleet[0]), "claims, instances and nodes differ"


def _recipe(pkg: str) -> list:
    t, types, _, dev = PACKAGES[pkg]
    from importlib import import_module

    objects = import_module(f"{t.__name__.split('.')[0]}.kube.objects")
    env = t.Environment(**dev)  # the kwok catalog
    env.kube.create(t.mk_nodepool("general"))
    tainted = t.mk_nodepool("tainted")
    tainted.spec.template.spec.taints = [
        objects.Taint(key="dedicated", value="gpu", effect="NoSchedule")]
    env.kube.create(tainted)
    seen = []

    def look(label: str, results=None) -> None:
        seen.append((label, testing.environment_fleet(env),
                     None if results is None else sorted(results.errors.items())))

    first = env.provision(*[t.mk_pod(name=f"burst-{i}", cpu=1.0) for i in range(10)],
                          now=testing.ENV_T0)
    look("burst", first)
    again = env.provision(*[t.mk_pod(name=f"reuse-{i}", cpu=0.25) for i in range(6)],
                          now=testing.ENV_T0 + 10)
    look("reuse", again)
    claim = sorted(env.kube.node_claims(), key=lambda c: c.metadata.name)[0]
    env.kube.delete(claim, now=testing.ENV_T0 + 20)
    env.reconcile_termination(now=testing.ENV_T0 + 20)
    look("teardown")
    probes = [t.mk_pod(name="giant", cpu=10_000.0),
              t.mk_pod(name="custom", node_selector={"example.com/unknown": "x"}),
              t.mk_pod(name="untolerated", node_selector={"karpenter.sh/nodepool": "tainted"})]
    look("unschedulable", env.provision(*probes, now=testing.ENV_T0 + 30))
    return seen


def test_verify_recipe_equals_jax():
    port, jax_ = _recipe("port"), _recipe("jax")
    assert port == jax_
    burst, reuse, teardown, probes = port
    assert not burst[1][1] and burst[1][2] == len(burst[1][0]) >= 1
    assert teardown[1][2] == teardown[1][3] == len(teardown[1][0]) < reuse[1][2]
    assert {k for k, _ in probes[2]} == {"default/giant", "default/custom",
                                         "default/untolerated"}


def _registration(pkg: str) -> list:
    t, _, _, _ = PACKAGES[pkg]
    env = _env(pkg, n_types=6, registration_delay=30.0)
    env.provision(*_pods(t, 5, 8, "r"), now=testing.ENV_T0)
    out = [testing.environment_fleet(env)]
    for dt in (10.0, 29.0, 31.0):
        env.cloud.tick(now=testing.ENV_T0 + dt)
        env.lifecycle.reconcile_all(now=testing.ENV_T0 + dt)
        out.append((dt, len(env.kube.nodes()), len(env.initialized_nodes())))
    return out


def test_registration_delay_runs_on_the_environment_clock():
    port, jax_ = _registration("port"), _registration("jax")
    assert port == jax_
    assert port[1][1] == port[2][1] == 0 and port[3][1] >= 1


REQUIREMENT_CASES = [
    [],
    [("node.kubernetes.io/instance-type", "In", ("c-3", "c-7", "nope"))],
    [("node.kubernetes.io/instance-type", "NotIn", ("c-3", "c-7"))],
    [("node.kubernetes.io/instance-type", "Exists", ())],
    [("node.kubernetes.io/instance-type", "DoesNotExist", ())],
    [("node.kubernetes.io/instance-type", "In", ("c-1", "c-2", "c-5")),
     ("karpenter.sh/capacity-type", "In", ("on-demand",))],
    [("node.kubernetes.io/instance-type", "NotIn", ("c-1",)),
     ("kubernetes.io/arch", "In", ("arm64",))],
]


@pytest.mark.parametrize("case", range(len(REQUIREMENT_CASES)))
def test_named_by_keeps_the_compatible_types(case):
    from karpenter_tpu.cloudprovider import types as jtypes
    from karpenter_tpu.scheduling.requirement import Requirement as JRequirement
    from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
    from karpenter_tpu_torch.cloudprovider import types as ptypes
    from karpenter_tpu_torch.cloudprovider.fake import make_instance_type
    from karpenter_tpu.cloudprovider.fake import make_instance_type as jmake_instance_type
    from karpenter_tpu_torch.scheduling.requirement import Requirement
    from karpenter_tpu_torch.scheduling.requirements import Requirements

    spec = REQUIREMENT_CASES[case]
    catalog = [make_instance_type(f"c-{i}", cpu=2 + i, arch="arm64" if i % 3 else "amd64")
               for i in range(10)]
    jcatalog = [jmake_instance_type(f"c-{i}", cpu=2 + i, arch="arm64" if i % 3 else "amd64")
                for i in range(10)]
    reqs = Requirements(Requirement(k, op, list(v)) for k, op, v in spec)
    jreqs = JRequirements(JRequirement(k, op, list(v)) for k, op, v in spec)
    whole = [it.name for it in ptypes.compatible(catalog, reqs)]
    narrowed = [it.name for it in ptypes.compatible(ptypes.named_by(catalog, reqs), reqs)]
    assert narrowed == whole == [it.name for it in jtypes.compatible(jcatalog, jreqs)]
