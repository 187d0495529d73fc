"""Boundaries of the PyTorch/CUDA port.

(d) `solve()` with no device runs on the card, so on a host without
    CUDA it raises instead of moving to the CPU; so do
    `Scheduler(...).solve`, `Provisioner(...).reconcile` and
    `.micro_solve`, `IncrementalPipeline().solve_tick`,
    `build_dual_floor`, `DisruptionEngine(...).reconcile` and
    `BatchProbeSolver(...)`. On a (faked) CUDA device nothing on the
    disruption engine's path falls back on its own: a failure in the
    probe batch's set-up, its dispatch, a lane's decode, the pruner's
    certificate or an execution-time validation reaches the caller,
    while an injected fault degrades as in the JAX package (and off the
    card every failure degrades, as there). `KubeClient` raises
    `NotImplementedError` for nothing (`evict` is ported).
    So do `testing.Environment()`, `warm_pool.warm`, `start_background`,
    `rewarm_canary` and `lp_device.warm`, before any bucket, and the
    `Operator` and `scenarios.run_soak`. The binary `python -m karpenter_tpu_torch` without a card
    and without `--device cpu` exits non-zero; `--solver-endpoint`
    raises `NotImplementedError` naming ROADMAP item 8.
(e) importing `karpenter_tpu_torch` and one CPU solve load neither
    `jax` nor `karpenter_tpu` (checked in a fresh interpreter); nor do
    two provisioning rounds through the port's Provisioner, nor a
    disruption round (engine, queue, validation, eviction), nor an
    Environment stream with the warm pool and the exposition, nor the
    operator's main path and the real-client stack
    (`testing.operator_run`, `client_run`), nor the binary
    `python -m karpenter_tpu_torch --demo 5 --run-seconds 1 --device cpu`,
    nor a soak and a cold cost race through the asynchronous seam;
    importing `karpenter_tpu_torch.deploy` does not import `yaml`.
(f) no file of the port, and not `chip_smoke.py`, imports `jax` or
    `karpenter_tpu` (AST check).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch.solver.solver import solve
from karpenter_tpu_torch.workloads import build_problem

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "karpenter_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    pods, pools = build_problem(20, 5, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(pods, pools)


def test_scheduler_and_provisioner_default_device_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.provisioning.scheduler import Scheduler

    pods, pools = build_problem(20, 5, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(pools_with_types=pools).solve(pods)
    case = testing.provision_cases(0)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        testing.provision_env(case, None).provisioner.reconcile(
            now=testing.CASE_T0 + 10)


def test_incremental_entry_points_default_device_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.incremental import (
        IncrementalPipeline,
        build_dual_floor,
    )

    pods, pools = build_problem(20, 5, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalPipeline().solve_tick(pods, pools)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dual_floor(encode(group_pods(pods), pools))
    case = testing.provision_cases(0)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        testing.provision_env(case, None).provisioner.micro_solve(
            pods, now=testing.CASE_T0 + 10)


def test_provisioning_rounds_load_no_jax():
    code = (
        "import sys, json\n"
        "from karpenter_tpu_torch import testing\n"
        "case = testing.provision_cases(0)[3]\n"
        "env = testing.provision_env(case, 'cpu')\n"
        "r1 = env.provisioner.reconcile(now=testing.CASE_T0 + 10)\n"
        "for pod in env.objects['extra']:\n"
        "    env.kube.create(pod)\n"
        "r2 = env.provisioner.reconcile(now=testing.CASE_T0 + 20)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'claims': len(env.kube.node_claims())}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["claims"] > 0


def test_import_and_cpu_solve_load_no_jax():
    code = (
        "import sys, json\n"
        "import karpenter_tpu_torch\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "pods, pools = build_problem(200, 10, seed=1)\n"
        "sol = solve(pods, pools, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'nodes': len(sol.new_nodes)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["nodes"] > 0


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "karpenter_tpu", "bench"), (path, name)


def test_sharded_solve_loads_no_jax():
    """(e) for the split path: a virtual mesh, a split ffd solve with
    streamed staging, the split ascent and the dryrun's module load
    neither `jax` nor `karpenter_tpu`."""
    code = (
        "import os, sys, json\n"
        "os.environ['KARPENTER_LP_SHARDS'] = '2'\n"
        "from karpenter_tpu_torch.utils.platform import force_virtual_mesh\n"
        "from karpenter_tpu_torch import graft_entry\n"
        "from karpenter_tpu_torch.solver import stream\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "force_virtual_mesh(4)\n"
        "pods, pools = build_problem(200, 10, seed=1)\n"
        "sol = solve(pods, pools, device='cpu', shards=4)\n"
        "cost = solve(pods, pools, device='cpu', shards=2, objective='cost')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'nodes': len(sol.new_nodes),"
        " 'blocks': stream.last_stats().get('blocks', 0)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["nodes"] > 0 and report["blocks"] > 0


def test_disruption_entry_points_default_device_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver.consolidation_batch import BatchProbeSolver

    env = testing.provision_env(testing.provision_cases(0)[0], "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        testing.disruption_env(env, device=None).disruption.reconcile(
            now=testing.CASE_T0 + 10)
    api = testing.package_api()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchProbeSolver(
            pools_with_types=env.provisioner.ready_pools_with_types(),
            snapshot=env.cluster.deep_copy_nodes(), daemonsets=[],
            cluster_pods=[], pending_pods=[], options=api.options.Options(),
            kube=env.kube, clock=lambda: testing.CASE_T0)
    # an engine over a CUDA Provisioner inherits its device: the
    # Provisioner already refuses
    with pytest.raises(RuntimeError, match="no CUDA device"):
        testing.provision_env(testing.provision_cases(0)[0], None)


def test_kube_client_has_no_named_not_implemented():
    """`KubeClient.evict` was the last part of the client left to the
    consolidation engine's port; no method raises NotImplementedError."""
    from karpenter_tpu_torch.kube import client

    tree = ast.parse(Path(client.__file__).read_text())
    raised = [n for n in ast.walk(tree) if isinstance(n, ast.Raise) and n.exc is not None
              and "NotImplementedError" in ast.unparse(n.exc)]
    assert raised == []


def test_disruption_round_loads_no_jax():
    code = (
        "import sys, json\n"
        "from karpenter_tpu_torch import testing\n"
        "case = testing.ProvisionCase('d', pods=[testing._pod(f'w-{i}', 0.5, 1.0)"
        " for i in range(40)], pools=[dict(name='default')], catalog=('custom',"
        " (('c2', 2, 8, 2.0), ('c4', 4, 16, 3.0), ('c8', 8, 32, 5.0)), 1))\n"
        "env = testing.disruption_env(testing.provision_env(case, 'cpu'))\n"
        "t0 = testing.DISRUPTION_T0\n"
        "testing.place(env, t0)\n"
        "for p in sorted(env.kube.pods(), key=lambda p: p.key)[::2]:\n"
        "    env.kube.delete(p, now=t0 + 50)\n"
        "rounds = testing.disruption_rounds(env, t0 + 100, max_rounds=3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'decided': sum(r['command'] is not None"
        " for r in rounds)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["decided"] > 0


class TestEngineOnTheCard:
    """The engine's device named "cuda" with its solves served on the
    CPU (`pack.solve_packing` and the lane solver moved there), so no
    card is needed: each site's non-injected failure is raised on the
    card and degrades off it; an injected fault degrades on both."""

    SITES = ("setup", "prime", "decode", "prune")

    @staticmethod
    def _engine(monkeypatch, device):
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.solver import consolidation_batch, faults, pack, resilience

        faults.reset()
        resilience.reset()
        real_pack = pack.solve_packing
        monkeypatch.setattr(pack, "solve_packing",
                            lambda enc, **kw: real_pack(enc, **dict(kw, device="cpu")))
        real_init = consolidation_batch.LaneSolver.__init__

        def on_cpu(self, *a, **kw):
            real_init(self, *a, **dict(kw, device="cpu"))

        monkeypatch.setattr(consolidation_batch.LaneSolver, "__init__", on_cpu)
        nodes = [dict(name=f"m-node-{i}", type=0, pool="default", finalizer=True,
                      zone=testing.ZONES[i % 3], pods=[testing._pod(f"m-{i}", 1.0, 2.0)])
                 for i in range(5)]
        case = testing.ProvisionCase(
            "mixed", pools=[dict(name="default")], nodes=nodes,
            catalog=("custom", (("c2", 2, 8, 2.0), ("c4", 4, 16, 3.0),
                                ("c8", 8, 32, 5.0)), 1))
        testing.reset_counters(testing.package_api())
        env = testing.disruption_env(testing.provision_env(case, "cpu"), device=device)
        t0 = testing.DISRUPTION_T0
        env.pod_events.reconcile_all(now=t0)
        env.conditions.reconcile_all(now=t0)
        return env, t0

    @staticmethod
    def _break(monkeypatch, site, err):
        from karpenter_tpu_torch.solver import consolidation_batch as cb

        def raising(*a, **k):
            raise err

        target = {
            "setup": (cb, "BatchProbeSolver"),
            "prime": (cb.LaneSolver, "solve_lazy"),
            "decode": (cb.BatchProbeSolver, "_to_results"),
            "prune": (cb.ProbePruner, "cannot_pay"),
        }[site]
        monkeypatch.setattr(*target, raising)

    def _sequential(self, monkeypatch):
        from karpenter_tpu_torch import testing

        monkeypatch.setenv("KARPENTER_BATCH_PROBES", "0")
        env, t0 = self._engine(monkeypatch, "cpu")
        cmd = env.disruption.multi_node_consolidation(t0)
        monkeypatch.delenv("KARPENTER_BATCH_PROBES")
        return testing.command_identity(cmd)

    @pytest.mark.parametrize("site", SITES)
    def test_card_failure_reaches_the_caller(self, monkeypatch, site):
        env, t0 = self._engine(monkeypatch, "cuda")
        err = TypeError(f"a failure in {site}")
        self._break(monkeypatch, site, err)
        with pytest.raises(TypeError) as info:
            env.disruption.multi_node_consolidation(t0)
        assert info.value is err

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    @pytest.mark.parametrize("site", SITES)
    def test_injected_fault_degrades(self, monkeypatch, site, device):
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.solver import faults

        want = self._sequential(monkeypatch)
        env, t0 = self._engine(monkeypatch, device)
        self._break(monkeypatch, site, faults.DeviceLostError(f"injected at {site}"))
        got = testing.command_identity(env.disruption.multi_node_consolidation(t0))
        assert got == want and got is not None

    @pytest.mark.parametrize("site", SITES)
    def test_any_failure_degrades_off_the_card(self, monkeypatch, site):
        from karpenter_tpu_torch import testing

        want = self._sequential(monkeypatch)
        env, t0 = self._engine(monkeypatch, "cpu")
        self._break(monkeypatch, site, TypeError(f"a failure in {site}"))
        got = testing.command_identity(env.disruption.multi_node_consolidation(t0))
        assert got == want

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_injected_probe_fault_degrades(self, monkeypatch, device):
        """KARPENTER_FAULTS at the chunk dispatch (`probe`): the lane
        falls back to its sequential probe, as in the JAX package."""
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.solver import faults

        want = self._sequential(monkeypatch)
        env, t0 = self._engine(monkeypatch, device)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@probe:*")
        faults.reset()
        try:
            got = testing.command_identity(env.disruption.multi_node_consolidation(t0))
            fired = [e for e in faults.get().snapshot_log() if e[0] == "probe"]
        finally:
            monkeypatch.delenv("KARPENTER_FAULTS")
            faults.reset()
        assert fired, "the probe fault never fired"
        assert got == want and got is not None

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_validation_failure(self, monkeypatch, device):
        """A validation that fails for another reason than a verdict is
        raised on the card; off it the command rolls back (the JAX
        package's reading)."""
        from karpenter_tpu_torch.disruption.validation import Validator

        env, t0 = self._engine(monkeypatch, device)
        cmd = env.disruption.multi_node_consolidation(t0)
        env.disruption.queue.start_command(cmd, t0)
        from karpenter_tpu_torch import testing

        testing.register(env, cmd.results, t0)
        err = TypeError("a failure in validation")

        def raising(*a, **k):
            raise err

        monkeypatch.setattr(Validator, "_validate_for_execution", raising)
        if device == "cuda":
            with pytest.raises(TypeError):
                env.disruption.queue.reconcile(now=t0 + 20)
            assert len(env.disruption.queue.active) == 1
        else:
            env.disruption.queue.reconcile(now=t0 + 20)
            assert env.disruption.queue.active == []
            assert all(c.metadata.deletion_timestamp is None
                       for c in env.kube.node_claims()
                       if c.metadata.name.startswith("existing-"))


def test_environment_and_warm_pool_default_device_without_cuda_raise():
    """`Environment()` and the warm pool's entry points run on the card:
    without one they raise, before any bucket is launched or counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch.metrics.store import SOLVER_WARM_COMPILES
    from karpenter_tpu_torch.solver import lp_device, warm_pool
    from karpenter_tpu_torch.testing import Environment

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Environment()
    before = SOLVER_WARM_COMPILES.samples()
    for fn in (lambda: warm_pool.warm(shapes=[(16, 64, 0, 32)]),
               lambda: warm_pool.start_background(shapes=[(16, 64, 0, 32)]),
               warm_pool.rewarm_canary,
               lambda: lp_device.warm([(16, 64, 4)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert SOLVER_WARM_COMPILES.samples() == before


def test_environment_stream_loads_no_jax():
    """A whole Environment stream on the CPU (provision through the kwok
    provider and the lifecycle, disruption, termination, interruption)
    and the warm pool load neither `jax` nor `karpenter_tpu`."""
    code = (
        "import sys, json\n"
        "from karpenter_tpu_torch import testing\n"
        "from karpenter_tpu_torch.metrics import exposition\n"
        "from karpenter_tpu_torch.solver import faults, warm_pool\n"
        "from karpenter_tpu_torch.cloudprovider.fake import instance_types\n"
        "env = testing.Environment(types=instance_types(12), device='cpu')\n"
        "env.kube.create(testing.mk_nodepool('default'))\n"
        "pods = [testing.mk_pod(name=f'g-{i}', cpu=0.5) for i in range(20)]\n"
        "steps = testing.environment_stream(env, pods, faults)\n"
        "warm_pool.warm(shapes=[(16, 64, 0, 32)], probe_shapes=[], device='cpu')\n"
        "text = exposition.render()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'steps': len(steps),"
        " 'phases': text.count('karpenter_solver_phase_duration_seconds_count')}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["steps"] >= 4 and report["phases"] == 5


def test_operator_default_device_without_cuda_raises():
    """The Operator's controllers solve on the card: without one, building
    it raises (its Provisioner resolves the device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube.client import KubeClient
    from karpenter_tpu_torch.operator.operator import Operator

    kube = KubeClient()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Operator(kube=kube, cloud_provider=KwokCloudProvider(kube))
    Operator(kube=kube, cloud_provider=KwokCloudProvider(kube), device="cpu")


def test_solver_endpoint_is_named_not_implemented():
    from karpenter_tpu_torch.__main__ import main

    with pytest.raises(NotImplementedError, match="item 8"):
        main(["--solver-endpoint", "localhost:1", "--device", "cpu", "--run-seconds", "1"])


def _binary(args, env_extra=None, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "karpenter_tpu_torch", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_binary_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    out = _binary(["--demo", "2", "--run-seconds", "1", "--metrics-port", "0",
                   "--metrics-bind-host", "127.0.0.1"], {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_binary_loads_no_jax():
    """`python -m karpenter_tpu_torch --demo 5 --run-seconds 1 --device
    cpu`, run as the module's main in a fresh interpreter: it runs to its
    shutdown and loads neither `jax` nor `karpenter_tpu`."""
    code = (
        "import sys, json, runpy, logging\n"
        "sys.argv = ['karpenter_tpu_torch', '--demo', '5', '--run-seconds', '1',"
        " '--device', 'cpu', '--metrics-port', '0', '--metrics-bind-host', '127.0.0.1']\n"
        "try:\n"
        "    runpy.run_module('karpenter_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'rc': rc}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"bad": [], "rc": 0}
    assert "operator up" in out.stderr and "shutdown:" in out.stderr


def test_operator_and_real_client_load_no_jax():
    """The operator's main path (`testing.operator_run`) and the
    real-client stack with a crash and restart (`testing.client_run`) on
    the CPU load neither `jax` nor `karpenter_tpu`."""
    code = (
        "import sys, json\n"
        "from karpenter_tpu_torch import testing\n"
        "from karpenter_tpu_torch.cloudprovider.fake import GIB, make_instance_type\n"
        "types = [make_instance_type('c2', cpu=2, memory=8 * GIB, price=2.0)]\n"
        "pods = lambda p, n: [testing.mk_pod(name=f'{p}-{i}', cpu=1.5) for i in range(n)]\n"
        "recs = testing.operator_run(testing.operator_api(), 'cpu', types,"
        " testing.mk_nodepool('default'), [pods('a', 4)], pods('m', 1), pods('h', 1),"
        " ticks=2, micro_steps=2, scans=2)\n"
        "pool = testing.mk_nodepool('default')\n"
        "pool.spec.disruption.consolidate_after = 'Never'\n"
        "run = testing.client_run(testing.client_api(), 'cpu', types, pool, pods('w', 3),"
        " faults_spec='operator_crash@crash_launch:1')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'steps': len(recs), 'crashes': run['crashes'],"
        " 'nodes': len(run['fleet'])}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == [] and report["crashes"] == 1 and report["nodes"] == 3


def test_soak_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from karpenter_tpu_torch.scenarios import run_soak, smoke_spec

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_soak(smoke_spec(duration_s=40.0))


def test_soak_and_async_race_load_no_jax():
    """A soak (`run_soak(smoke_spec(), device="cpu")`) and a cold cost
    race through the asynchronous seam load neither `jax` nor
    `karpenter_tpu`; nor does importing `karpenter_tpu_torch.deploy`
    import `yaml`."""
    code = (
        "import sys, json\n"
        "import karpenter_tpu_torch.deploy\n"
        "no_yaml = 'yaml' not in sys.modules\n"
        "from karpenter_tpu_torch.scenarios import run_soak, smoke_spec\n"
        "report = run_soak(smoke_spec(duration_s=60.0), device='cpu')\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "pods, pools = build_problem(300, 12, seed=4)\n"
        "sol = solve(pods, pools, device='cpu', objective='cost')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'no_yaml': no_yaml, 'pass': report['pass'],"
        " 'lp': sol.lp is not None}))\n"
    )
    # one hash seed: a soak's verdict depends on it (ROADMAP C7)
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"bad": [], "no_yaml": True, "pass": True, "lp": True}
