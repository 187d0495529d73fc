"""The scenario-flywheel soak on the port, held against the JAX package
on the CPU.

The four cases of tests/test_soak_judge.py::TestSmokeSoak on the port
with `device="cpu"` (a calm replay passes and is byte-identical, the
verdict planes and gauge, the injected latency fault fails through the
SLO, the ambient environment restored), then `run_soak` of
`smoke_spec()`, calm and with the latency fault, and of the flywheel
at a 600 s horizon, in both packages in one process: equal
`report_digest`s, so equal schedules, planes, observations and fault
logs. Then `python -m karpenter_tpu_torch.scenarios` with its exit
codes.

A soak's verdict depends on the string-hash seed (ROADMAP C7: the
calm smoke trace fails its explain plane under PYTHONHASHSEED=13, in
both packages alike). So the cases that assert a verdict run in a
subprocess under PYTHONHASHSEED=0, as `chip_smoke.py` does; the
cases that compare the packages run in this process, whose seed both
share.

The JAX package's globals a soak touches and no soak restores (the
explain ring, the SLO's last digest, the series of the scheduler's
unschedulable gauge and of the soak verdict) are saved before each
test and restored after it.

Tolerance: exact equality (sha256 digests).
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from karpenter_tpu import explain as jexplain
from karpenter_tpu import scenarios as jscenarios
from karpenter_tpu.metrics import slo as jslo
from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.scenarios import flywheel_spec, run_soak, smoke_spec
from karpenter_tpu_torch.solver import faults

pytestmark = pytest.mark.soak_chaos

ROOT = Path(__file__).resolve().parent.parent
LAG = ("exec_delay@crash_tick:*=2s#lag",)


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.fixture(autouse=True)
def clean_soak_env(monkeypatch):
    """An ambient fault spec or reactive override must not leak into
    the soak; the JAX package's globals come back as they were."""
    for key in ("KARPENTER_FAULTS", "KARPENTER_FAULT_SEED", "KARPENTER_REACTIVE"):
        monkeypatch.delenv(key, raising=False)
    ring = collections.deque(jexplain._ring, maxlen=jexplain._ring.maxlen)
    last = jslo._last_digest
    series = {g: dict(g._values) for g in (jstore.SCHEDULER_UNSCHEDULABLE_PODS,
                                            jstore.SOAK_VERDICT)}
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    jexplain._ring = ring
    jslo._last_digest = last
    for gauge, values in series.items():
        gauge._values = values


def _lagged(spec, name="smoke_flywheel_injected"):
    return dataclasses.replace(spec, name=name, faults=LAG)


# -- tests/test_soak_judge.py::TestSmokeSoak on the port

# run in a subprocess under one hash seed: the soaks' reports as JSON
_PINNED = """
import dataclasses, json, os, sys
from karpenter_tpu_torch.metrics.store import SOAK_VERDICT
from karpenter_tpu_torch.scenarios import run_soak, smoke_spec
lag = dataclasses.replace(smoke_spec(), name="smoke_flywheel_injected", faults=(%r,))
os.environ["KARPENTER_FAULT_SEED"] = "999"
run_soak(smoke_spec(duration_s=40.0), device="cpu")
restored = (os.environ.get("KARPENTER_FAULT_SEED"), "KARPENTER_FAULTS" in os.environ)
out = {"first": run_soak(smoke_spec(), device="cpu"),
       "second": run_soak(smoke_spec(), device="cpu"),
       "lag": run_soak(lag, device="cpu"), "restored": restored}
out["verdict"] = SOAK_VERDICT.series().get((("scenario", "smoke_flywheel"),))
print(json.dumps(out))
""" % LAG


@pytest.fixture(scope="module")
def pinned():
    env = {k: v for k, v in os.environ.items()
           if k not in ("KARPENTER_FAULTS", "KARPENTER_FAULT_SEED", "KARPENTER_REACTIVE")}
    env.update(PYTHONPATH=str(ROOT), PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, "-c", _PINNED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class TestSmokeSoak:
    def test_calm_replay_passes_and_is_byte_identical(self, pinned):
        first, second = pinned["first"], pinned["second"]
        assert first["pass"], first["failures"]
        assert first["failures"] == []
        assert first["schedule_digest"] == second["schedule_digest"]
        assert first["report_digest"] == second["report_digest"]
        obs = first["observations"]
        assert obs["events_applied"]["create"] > 20
        assert obs["ticks"] > 20
        assert obs["fault_log_len"] > 0
        assert "spot_interruption" in obs["fault_kinds"]
        assert obs["leaks"] == []

    def test_calm_verdict_planes_and_gauge(self, pinned):
        report = pinned["first"]
        assert set(report["planes"]) == {"slo", "sentinel", "oracle", "explain", "leaks"}
        for name, plane in report["planes"].items():
            assert plane["pass"], (name, plane)
        assert report["planes"]["slo"]["budget_exhausted"] == []
        # the verdict gauge after the process's last smoke_flywheel soak
        assert pinned["verdict"] == 1.0

    def test_injected_latency_fault_fails_through_slo(self, pinned):
        report = pinned["lag"]
        assert not report["pass"]
        assert "slo" in report["failures"]
        slo = report["planes"]["slo"]
        assert "tick_latency" in slo["budget_exhausted"]
        assert slo["whole_run_burn"]["tick_latency"] >= 1.0
        assert slo["burn_minutes"]["tick_latency"] > 0.0

    def test_soak_restores_ambient_environment(self, pinned):
        assert pinned["restored"] == ["999", False]
        os.environ["KARPENTER_FAULT_SEED"] = "999"
        try:
            run_soak(smoke_spec(duration_s=40.0), device="cpu")
            assert os.environ["KARPENTER_FAULT_SEED"] == "999"
            assert "KARPENTER_FAULTS" not in os.environ
        finally:
            os.environ.pop("KARPENTER_FAULT_SEED", None)


# -- against the JAX package


def _pair(spec_fn):
    ours = run_soak(spec_fn(smoke_spec, flywheel_spec), device="cpu")
    theirs = jscenarios.run_soak(spec_fn(jscenarios.smoke_spec, jscenarios.flywheel_spec))
    return ours, theirs


@pytest.mark.parametrize("case", ["calm", "latency_fault", "flywheel_600"])
def test_report_digest_equals_jax(case):
    make = {
        "calm": lambda smoke, fly: smoke(),
        "latency_fault": lambda smoke, fly: _lagged(smoke()),
        "flywheel_600": lambda smoke, fly: fly(duration_s=600.0),
    }[case]
    ours, theirs = _pair(make)
    assert ours["report_digest"] == theirs["report_digest"]
    assert ours["failures"] == theirs["failures"]
    assert ours["fault_log"] == theirs["fault_log"]
    if case == "latency_fault":
        assert {"slo", "sentinel"} <= set(ours["failures"])


def test_operator_gets_the_device(monkeypatch):
    """Every Operator of a soak is built on the soak's device."""
    from karpenter_tpu_torch.operator import operator as op_mod

    seen = []
    real = op_mod.Operator.__init__

    def spy(self, *a, **k):
        seen.append(k.get("device"))
        real(self, *a, **k)

    monkeypatch.setattr(op_mod.Operator, "__init__", spy)
    run_soak(smoke_spec(duration_s=40.0), device="cpu")
    assert seen and all(str(d) == "cpu" for d in seen)


# -- python -m karpenter_tpu_torch.scenarios


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED="0", **(env_extra or {}))
    env.pop("KARPENTER_FAULTS", None)
    return subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.scenarios", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_passes_and_writes_the_report(tmp_path):
    out = tmp_path / "report.json"
    res = _cli("--spec", "smoke", "--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr
    report = json.loads(out.read_text())
    assert report["pass"] and report["scenario"] == "smoke_flywheel"
    assert f"digest={report['report_digest'][:16]} PASS" in res.stdout


def test_cli_fails_on_the_injected_fault():
    res = _cli("--spec", "smoke", "--device", "cpu", "--faults", LAG[0])
    assert res.returncode == 1, res.stderr
    assert "failing planes:" in res.stdout and "slo" in res.stdout


def test_cli_usage_and_missing_card_exit_2():
    assert _cli("--spec", "nonsense").returncode == 2
    res = _cli("--spec", "smoke", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2
    assert "no CUDA device" in res.stderr
