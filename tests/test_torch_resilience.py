"""The resilience ladder of the port against the JAX package's.

(a) The cases of `tests/test_resilience.py` (`TestClassification`,
    `TestCircuitBreaker`, `TestLadder`, `TestDeadlines`), less the
    asynchronous, remote and re-warm ones, on the port with
    `device="cpu"` (the kernels' plain versions).
(b) `classify` on torch's and the port's own errors: `KernelError` from
    the launch check, a failed or missing `nvcc`, a library that does
    not load, CUDA errors as torch raises them.
(c) What the port does not have raises a named NotImplementedError at
    the seam, before any rung runs: KARPENTER_SOLVER_ENDPOINT and a
    ladder naming `remote` (KARPENTER_REWARM_ON_CLOSE's gate is held in
    tests/test_torch_warm_pool.py).
(d) `testing.ladder_script` through both packages on the same encoded
    problem (`workloads.build_problem` against `bench.build_problem`):
    equal served rungs, counter deltas, breaker states, fault logs and
    PackResults, and the script's expected sequence in both.
(e) The seams of ROADMAP C3: `lp_device.maybe_solve` degrades, the
    lane solver remembers a degraded certificate, and the probe site
    charges the device breaker for a device failure only.
(f) A CPU solve served by the host rung on a watchdog thread loads
    neither `jax` nor `karpenter_tpu` (fresh interpreter).

Tolerance: exact equality. The stalls are 1.2 s, drained after each
test so that no abandoned attempt fires a fault site under the next
test's spec.
"""

import contextlib
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.solver import consolidation_batch as jcb
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import pack as jpack
from karpenter_tpu.solver import resilience as jresilience
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu_torch import cuda_build
from karpenter_tpu_torch.metrics.store import (
    SOLVER_BREAKER_STATE,
    SOLVER_DEADLINE_EXCEEDED,
    SOLVER_HEDGE,
    SOLVER_LADDER,
    SOLVER_LP_SOLVES,
)
from karpenter_tpu_torch.solver import consolidation_batch, faults, lp_device, pack, resilience
from karpenter_tpu_torch.solver import pack_split, stream
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.resilience import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    CircuitBreaker,
    classify,
    host_pack_result,
)
from karpenter_tpu_torch.solver.solver import fingerprint, solve
from karpenter_tpu_torch.testing import (
    LADDER_KNOBS,
    LADDER_LANES,
    LadderPackage,
    ladder_mismatches,
    ladder_script,
    one_core,
)
from karpenter_tpu_torch.utils.platform import force_virtual_mesh, virtual_mesh
from karpenter_tpu_torch.workloads import build_problem
from test_consolidation_batch_oracle import build_fleet as jbuild_fleet
from test_torch_consolidation import build_fleet

ROOT = Path(__file__).resolve().parent.parent
STALL = "1.2s"

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """The JAX compiles and plain versions of these tests run on one
    core, leaving the suite's other workers, some of which time
    milliseconds, their cores."""
    with one_core():
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every test starts from closed breakers, no faults, no ladder
    knobs and no leftover degradation notes, and leaves the process the
    same way, its abandoned watchdog attempts drained."""
    for knob in LADDER_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for mod in (resilience, jresilience):
        mod.reset()
    faults.reset()
    jfaults.reset()
    yield
    for mod in (resilience, jresilience):
        mod._drain_watchdogs()
        mod.reset()
    faults.reset()
    jfaults.reset()


@contextlib.contextmanager
def _mesh(n):
    before = virtual_mesh()
    force_virtual_mesh(n)
    try:
        yield
    finally:
        force_virtual_mesh(before)


def _enc(n_pods=200, n_types=10, seed=7):
    pods, pools = build_problem(n_pods, n_types, seed=seed)
    return encode(group_pods(pods), pools)


def _same_pack(a, b) -> bool:
    n = a.node_count
    return (
        n == b.node_count
        and np.array_equal(a.assign[:n], b.assign[:n])
        and np.array_equal(a.unschedulable, b.unschedulable)
    )


def _solve(enc, **kw):
    return resilience.shared().solve_packing(enc, mode="ffd", device="cpu", **kw)


def _direct(enc, **kw):
    return pack.solve_packing(enc, mode="ffd", device="cpu", **kw)


# -- (a), (b) classification


class TestClassification:
    def test_taxonomy(self):
        assert classify(faults.DeviceLostError("x")) == "device_lost"
        assert classify(faults.RpcDropError("x")) == "rpc_unavailable"
        assert classify(resilience.CompileDeadlineExceeded("x")) == "compile_timeout"
        assert classify(resilience.DeadlineExceeded("x")) == "deadline"
        assert classify(ConnectionRefusedError("x")) == "rpc_unavailable"
        assert classify(ValueError("x")) == "error"

    def test_taxonomy_equals_jax_on_shared_errors(self):
        errors = [
            (faults.DeviceLostError("x"), jfaults.DeviceLostError("x")),
            (faults.RpcDropError("x"), jfaults.RpcDropError("x")),
            (resilience.CompileDeadlineExceeded("x"), jresilience.CompileDeadlineExceeded("x")),
            (resilience.DeadlineExceeded("x"), jresilience.DeadlineExceeded("x")),
            (ConnectionRefusedError("x"),) * 2, (TimeoutError("x"),) * 2,
            (OSError("x"),) * 2, (ValueError("x"),) * 2, (KeyError("x"),) * 2,
            (RuntimeError("x"),) * 2,
        ]
        for ours, theirs in errors:
            assert classify(ours) == jresilience.classify(theirs), ours

    def test_torch_device_errors_are_device_lost(self):
        assert classify(torch.cuda.OutOfMemoryError("CUDA out of memory")) == "device_lost"
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None:
            assert classify(accel("CUDA error: an illegal memory access")) == "device_lost"
        assert classify(RuntimeError(
            "CUDA error: an illegal memory access was encountered")) == "device_lost"
        assert classify(RuntimeError("CUDA driver error: device not ready")) == "device_lost"
        # torch's other RuntimeErrors (a shape error) are not the card's
        assert classify(RuntimeError("shape '[2]' is invalid for input of size 3")) == "error"

    def test_launch_check_raises_kernel_error(self):
        pack_split._raise_on(0, "nothing")  # a zero code passes
        with pytest.raises(cuda_build.KernelError, match="CUDA error 719 at launch") as info:
            pack_split._raise_on(719, "pack_split (a launch)")
        assert isinstance(info.value, RuntimeError)
        assert classify(info.value) == "device_lost"

    def test_missing_nvcc_is_a_build_error(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.delenv("CUDA_PATH", raising=False)
        with pytest.raises(cuda_build.KernelError, match="nvcc not found") as info:
            cuda_build.nvcc_path()
        assert classify(info.value) == "device_lost"

    def test_failed_compile_is_a_build_error(self, monkeypatch, tmp_path):
        false = shutil.which("false")
        if false is None:
            pytest.skip("no `false` binary to stand in for a failing nvcc")
        monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
        monkeypatch.setattr(cuda_build, "nvcc_path", lambda: false)
        monkeypatch.setattr(cuda_build, "BUILD_INFO", {})
        monkeypatch.setattr(cuda_build, "_libs", {})
        with pytest.raises(cuda_build.KernelError, match="CUDA kernel build failed") as info:
            cuda_build.library("pack_flat")
        assert classify(info.value) == "device_lost"

    def test_library_that_does_not_load_is_a_build_error(self, monkeypatch, tmp_path):
        monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
        monkeypatch.setattr(cuda_build, "_libs", {})
        cuda_build._target("pack_flat").write_bytes(b"not a shared library")
        with pytest.raises(cuda_build.KernelError, match="does not load") as info:
            cuda_build.library("pack_flat")
        assert classify(info.value) == "device_lost"


# -- (a) breaker


class TestCircuitBreaker:
    def _breaker(self, **kw):
        kw.setdefault("threshold", 2)
        kw.setdefault("base_cooldown", 0.05)
        kw.setdefault("max_cooldown", 0.2)
        return CircuitBreaker("test", **kw)

    def test_opens_after_threshold_then_half_opens_then_closes(self):
        br = self._breaker()
        assert br.allow()
        br.record_failure("device_lost")
        assert br.state == STATE_CLOSED and br.allow()
        br.record_failure("device_lost")
        assert br.state == STATE_OPEN
        assert not br.allow()
        time.sleep(0.06)
        assert br.allow()
        assert br.state == STATE_HALF_OPEN
        assert not br.allow()
        br.record_success()
        assert br.state == STATE_CLOSED
        assert SOLVER_BREAKER_STATE.value({"backend": "test"}) == 0.0

    def test_half_open_failure_reopens_with_longer_cooldown(self):
        br = self._breaker(rng=random.Random(3))
        br.record_failure("deadline")
        br.record_failure("deadline")
        first_retry = br._retry_at
        time.sleep(0.06)
        assert br.allow()
        br.record_failure("deadline")
        assert br.state == STATE_OPEN
        assert br._retry_at > first_retry

    def test_success_in_closed_resets_failure_streak(self):
        br = self._breaker()
        br.record_failure("error")
        br.record_success()
        br.record_failure("error")
        assert br.state == STATE_CLOSED

    def test_close_gate_failure_keeps_breaker_open(self):
        verdicts = [False, True]
        br = self._breaker(close_gate=lambda: verdicts.pop(0))
        br.record_failure("device_lost")
        br.record_failure("device_lost")
        time.sleep(0.06)
        assert br.allow()
        br.record_success()
        assert br.state == STATE_OPEN
        time.sleep(0.25)
        assert br.allow()
        br.record_success()
        assert br.state == STATE_CLOSED

    def test_abandoned_half_open_probe_does_not_wedge(self):
        br = self._breaker()
        br.record_failure("deadline")
        br.record_failure("deadline")
        time.sleep(0.06)
        assert br.allow()
        time.sleep(0.06)
        assert br.allow()

    def test_cooldowns_equal_jax_under_one_seed(self):
        """The jittered exponential cooldowns (utils/backoff.py) draw
        the same windows from the same seed in both packages."""
        ours = CircuitBreaker("cd", threshold=1, base_cooldown=0.5, max_cooldown=4.0,
                              rng=random.Random(9))
        theirs = jresilience.CircuitBreaker("cd", threshold=1, base_cooldown=0.5,
                                            max_cooldown=4.0, rng=random.Random(9))
        got, want = [], []
        for cycles in range(1, 6):
            ours._open_cycles = theirs._open_cycles = cycles
            got.append(ours._cooldown())
            want.append(theirs._cooldown())
        assert got == want


# -- (a) ladder


class TestLadder:
    def test_healthy_path_serves_device_rung(self):
        enc = _enc()
        direct = _direct(enc)
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "ok"})
        out = _solve(enc)
        assert _same_pack(out, direct)
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "ok"}) == before + 1
        assert resilience.pop_degraded() == []

    def test_device_lost_degrades_to_host_oracle(self, monkeypatch):
        enc = _enc(seed=11)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
        out = _solve(enc)
        assert _same_pack(out, host_pack_result(enc))
        assert resilience.pop_degraded() == ["host"]

    def test_sharded_rung_serves_wavefront_and_streaming(self, monkeypatch):
        enc = _enc(seed=17)
        monkeypatch.setenv("KARPENTER_WAVEFRONT", "force")
        monkeypatch.setenv("KARPENTER_STREAM_ENCODE", "auto")
        direct = _direct(enc)
        with _mesh(8):
            monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "8")
            before = SOLVER_LADDER.value({"rung": "sharded", "outcome": "ok"})
            stream.reset_stats()
            out = _solve(enc)
        assert _same_pack(out, direct)
        assert SOLVER_LADDER.value({"rung": "sharded", "outcome": "ok"}) == before + 1
        assert stream.last_stats().get("blocks", 0) > 0
        assert resilience.pop_degraded() == []

    def test_sharded_rung_failure_degrades_to_single_device(self, monkeypatch):
        enc = _enc(seed=19)
        direct = _direct(enc)
        with _mesh(8):
            monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "8")
            monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1")
            before = SOLVER_LADDER.value({"rung": "device", "outcome": "ok"})
            out = _solve(enc)
        assert _same_pack(out, direct)
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "ok"}) == before + 1
        assert resilience.pop_degraded() == ["device"]

    def test_sharded_rung_without_a_mesh_degrades_to_device(self, monkeypatch):
        """KARPENTER_SOLVER_SHARDS past the visible devices: the sharded
        rung's explicit mesh cannot be met, the device rung serves and
        the degradation is reported, never dropped."""
        enc = _enc(seed=5)
        monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", "4")
        before = SOLVER_LADDER.value({"rung": "sharded", "outcome": "error"})
        out = _solve(enc)
        assert _same_pack(out, _direct(enc, shards=1))
        assert SOLVER_LADDER.value({"rung": "sharded", "outcome": "error"}) == before + 1
        assert resilience.pop_degraded() == ["device"]

    def test_breaker_opens_and_skips_then_recloses(self, monkeypatch):
        enc = _enc(seed=13)
        monkeypatch.setenv("KARPENTER_BREAKER_COOLDOWN_MS", "60000")
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
        rs = resilience.shared()
        _solve(enc)
        _solve(enc)
        assert rs.breaker("device").state == STATE_OPEN
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "skipped_open"})
        _solve(enc)
        assert SOLVER_LADDER.value(
            {"rung": "device", "outcome": "skipped_open"}) == before + 1
        monkeypatch.delenv("KARPENTER_FAULTS")
        faults.reset()
        rs.breaker("device")._retry_at = 0.0
        direct = _direct(enc)
        out = _solve(enc)
        assert _same_pack(out, direct)
        assert rs.breaker("device").state == STATE_CLOSED

    def test_explicit_ladder_order_override(self, monkeypatch):
        enc = _enc(seed=19)
        monkeypatch.setenv("KARPENTER_SOLVE_LADDER", "host")
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "ok"})
        out = _solve(enc)
        assert _same_pack(out, host_pack_result(enc))
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "ok"}) == before
        # host is the primary here: nothing is degraded
        assert resilience.pop_degraded() == []

    def test_width_refusal_charges_breaker_and_host_serves(self, monkeypatch):
        """A shape a kernel refuses (ROADMAP C4: R > 16 resources, a
        wavefront past 256 lanes) stays an error of its wrapper. Off the
        card the ladder serves it as the JAX package does: `error`, the
        device breaker charged, the host rung serving. On a CUDA device
        it reaches the caller (`TestOnTheCard`)."""
        enc = _enc(seed=23)

        def refuse(*a, **k):
            raise ValueError("pack_split: 17 resources exceed the kernel's 16")

        monkeypatch.setattr(pack, "solve_packing", refuse)
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "error"})
        out = _solve(enc)
        assert _same_pack(out, host_pack_result(enc))
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "error"}) == before + 1
        assert resilience.shared().breaker("device")._failures == 1
        assert resilience.pop_degraded() == ["host"]

    def test_solver_routes_every_pack_through_the_ladder(self, monkeypatch):
        """ffd and every arm of the cost race go through shared()."""
        pods, pools = build_problem(120, 8, seed=3)
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "ok"})
        solve(pods, pools, device="cpu")
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "ok"}) == before + 1
        calls = []

        def spy(name):
            real = getattr(resilience.ResilientSolver, name)

            def entry(self, enc, mode="ffd", **kw):
                calls.append(mode)
                return real(self, enc, mode=mode, **kw)
            return entry

        # the cold race dispatches its arms through the asynchronous seam
        for name in ("solve_packing", "solve_packing_async"):
            monkeypatch.setattr(resilience.ResilientSolver, name, spy(name))
        solve(pods, pools, device="cpu", objective="cost")
        assert "ffd" in calls and "cost" in calls


class TestOnTheCard:
    """On a CUDA device the ladder degrades only past an injected fault
    or a watchdog deadline (`resilience.may_degrade`); every other
    failure of a rung on the card is counted and raised, charges no
    breaker, and the host rung never runs. Driven here with the device
    named "cuda" and the pack replaced, so no card is needed."""

    CARD_ERRORS = {
        "launch": lambda: cuda_build.KernelError("pack_split: CUDA error 719 at launch"),
        "width": lambda: ValueError("pack_split: 17 resources exceed the kernel's 16"),
        "cuda": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
        "oom": lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"),
        "bug": lambda: TypeError("a wrapper bug"),
    }

    @staticmethod
    def _no_host(monkeypatch):
        def host(*a, **k):
            raise AssertionError("the host rung ran for a failure on the card")

        monkeypatch.setattr(resilience, "host_pack_result", host)

    @pytest.mark.parametrize("kind", sorted(CARD_ERRORS))
    @pytest.mark.parametrize("shards", ["", "4"])
    def test_card_failures_reach_the_caller(self, monkeypatch, kind, shards):
        enc = _enc(n_pods=40, seed=23)
        err = self.CARD_ERRORS[kind]()
        calls = []

        def failing(*a, **k):
            calls.append(k.get("shards"))
            raise err

        monkeypatch.setattr(pack, "solve_packing", failing)
        self._no_host(monkeypatch)
        if shards:
            monkeypatch.setenv("KARPENTER_SOLVER_SHARDS", shards)
        rung = "sharded" if shards else "device"
        reason = classify(err)
        before = SOLVER_LADDER.value({"rung": rung, "outcome": reason})
        with pytest.raises(type(err)) as info:
            resilience.shared().solve_packing(enc, mode="ffd", device="cuda")
        assert info.value is err
        # one attempt: neither the next device rung nor the host ran
        assert len(calls) == 1
        assert SOLVER_LADDER.value({"rung": rung, "outcome": reason}) == before + 1
        br = resilience.shared().breaker(rung)
        assert br._failures == 0 and br.state == STATE_CLOSED
        assert resilience.pop_degraded() == []

    def test_build_failure_through_solve_reaches_the_caller(self, monkeypatch, tmp_path):
        """`solve(device="cuda")` on a host whose kernels cannot be
        built: the build's KernelError reaches the caller."""
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.delenv("CUDA_PATH", raising=False)

        def building(*a, **k):
            cuda_build.nvcc_path()
            raise AssertionError("nvcc was found")

        monkeypatch.setattr(pack, "solve_packing", building)
        self._no_host(monkeypatch)
        pods, pools = build_problem(40, 4, seed=1)
        with pytest.raises(cuda_build.KernelError, match="nvcc not found"):
            solve(pods, pools, device="cuda")
        assert resilience.shared().breaker("device")._failures == 0
        assert resilience.pop_degraded() == []

    def test_injected_fault_and_deadline_still_degrade(self, monkeypatch):
        enc = _enc(n_pods=40, seed=29)
        host = host_pack_result(enc)
        release = threading.Event()

        def card(*a, **k):
            faults.fire("solve")
            release.wait(10.0)
            return host

        monkeypatch.setattr(pack, "solve_packing", card)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1")
        out = resilience.shared().solve_packing(enc, mode="ffd", device="cuda")
        assert _same_pack(out, host)
        assert resilience.pop_degraded() == ["host"]
        assert resilience.shared().breaker("device")._failures == 1
        # the second solve passes the fault site and hangs: the deadline
        # abandons it and the host serves
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "100")
        before = SOLVER_LADDER.value({"rung": "device", "outcome": "deadline"})
        try:
            out = resilience.shared().solve_packing(enc, mode="ffd", device="cuda")
        finally:
            release.set()
        assert _same_pack(out, host)
        assert resilience.pop_degraded() == ["host"]
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "deadline"}) == before + 1

    def test_may_degrade(self):
        card, cpu = torch.device("cuda"), torch.device("cpu")
        servable = [faults.DeviceLostError("x"), faults.RpcDropError("x"),
                    resilience.DeadlineExceeded("x"),
                    resilience.CompileDeadlineExceeded("x")]
        raised = [err() for err in self.CARD_ERRORS.values()]
        for err in servable:
            assert resilience.may_degrade(err, card) and resilience.may_degrade(err, cpu)
        for err in raised:
            assert not resilience.may_degrade(err, card) and not resilience.may_degrade(err, "cuda:0")
            assert resilience.may_degrade(err, cpu)

    def test_maybe_solve_raises_card_failures(self, monkeypatch):
        enc = _enc(seed=3)
        err = cuda_build.KernelError("lp_ascend: CUDA error 700 at launch")

        def broken(*a, **k):
            raise err

        monkeypatch.setattr(lp_device, "solve", broken)
        before = SOLVER_LP_SOLVES.value({"outcome": "degraded"})
        with pytest.raises(cuda_build.KernelError):
            lp_device.maybe_solve(enc, device="cuda")
        assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before

        def lost(*a, **k):
            raise faults.DeviceLostError("lp_device.solve: injected lost device")

        monkeypatch.setattr(lp_device, "solve", lost)
        assert lp_device.maybe_solve(enc, device="cuda") is None
        assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before + 1


class TestNotPorted:
    """What the port leaves to later items raises at the seam, names
    its item, and runs no rung."""

    @pytest.mark.parametrize("knob,value,item", [
        ("KARPENTER_SOLVER_ENDPOINT", "localhost:50051", "item 8"),
        ("KARPENTER_SOLVE_LADDER", "remote,device,host", "item 8"),
        ("KARPENTER_SOLVE_LADDER", "device,remote", "item 8"),
    ])
    def test_raises_named_not_implemented(self, monkeypatch, knob, value, item):
        enc = _enc(seed=29)
        monkeypatch.setenv(knob, value)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
        before = dict(SOLVER_LADDER.samples())
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            _solve(enc)
        assert dict(SOLVER_LADDER.samples()) == before
        assert faults.get().snapshot_log() == []
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            solve(*build_problem(20, 4, seed=1), device="cpu")


# -- (a) deadlines


class TestDeadlines:
    def test_compile_stall_times_out_and_degrades(self, monkeypatch):
        enc = _enc(seed=29)
        monkeypatch.setenv("KARPENTER_FAULTS", f"compile_delay={STALL}")
        monkeypatch.setenv("KARPENTER_COMPILE_DEADLINE_MS", "150")
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "400")
        before = SOLVER_DEADLINE_EXCEEDED.value({"phase": "compile"})
        t0 = time.monotonic()
        out = _solve(enc)
        wall = time.monotonic() - t0
        assert _same_pack(out, host_pack_result(enc))
        assert SOLVER_DEADLINE_EXCEEDED.value({"phase": "compile"}) == before + 1
        assert wall < 1.1, f"decision took {wall:.2f}s: the stalled launch was waited out"
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "compile_timeout"}) >= 1

    def test_execute_stall_times_out_within_deadline(self, monkeypatch):
        enc = _enc(seed=31)
        monkeypatch.setenv("KARPENTER_FAULTS", f"exec_delay={STALL}")
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "300")
        t0 = time.monotonic()
        out = _solve(enc)
        wall = time.monotonic() - t0
        assert _same_pack(out, host_pack_result(enc))
        assert wall < 1.1
        assert SOLVER_LADDER.value({"rung": "device", "outcome": "deadline"}) >= 1

    def test_hedge_precomputes_the_degraded_answer(self, monkeypatch):
        """The result must be right on every attempt; the timing-coupled
        win count must hold on one of three (the JAX test's rule)."""
        enc = _enc(seed=37)
        monkeypatch.setenv("KARPENTER_FAULTS", f"exec_delay={STALL}")
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "500")
        monkeypatch.setenv("KARPENTER_SOLVE_HEDGE_MS", "50")
        won = False
        for _ in range(3):
            resilience._drain_watchdogs()
            faults.reset()
            wins = SOLVER_HEDGE.value({"outcome": "win"})
            out = _solve(enc)
            assert _same_pack(out, host_pack_result(enc))
            if SOLVER_HEDGE.value({"outcome": "win"}) == wins + 1:
                won = True
                break
        assert won, "hedge never supplied the degraded answer in 3 attempts"

    def test_instant_failure_does_not_burn_compile_budget(self, monkeypatch):
        enc = _enc(seed=47)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
        monkeypatch.setenv("KARPENTER_COMPILE_DEADLINE_MS", "5000")
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "8000")
        t0 = time.monotonic()
        out = _solve(enc)
        wall = time.monotonic() - t0
        assert _same_pack(out, host_pack_result(enc))
        assert wall < 2.0, f"instant device failure took {wall:.2f}s"

    def test_degraded_report_survives_watchdog_thread(self, monkeypatch):
        """With a deadline set the attempt runs on a watchdog thread;
        the degradation note still lands on the calling thread (the
        synchronous form of the JAX package's executor test)."""
        enc = _enc(seed=53)
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "8000")
        resilience.pop_degraded()
        out = _solve(enc)
        assert _same_pack(out, host_pack_result(enc))
        assert "host" in resilience.pop_degraded()

    def test_healthy_solve_ignores_generous_deadline(self, monkeypatch):
        enc = _enc(seed=41)
        monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "60000")
        monkeypatch.setenv("KARPENTER_COMPILE_DEADLINE_MS", "60000")
        direct = _direct(enc)
        out = _solve(enc)
        assert _same_pack(out, direct)
        assert resilience.pop_degraded() == []


# -- (d) the ladder script through both packages


class JaxLadder(LadderPackage):
    """The JAX package's side of `ladder_script` (on its CPU devices)."""

    def __init__(self, enc, fleet):
        self.enc, self.fleet = enc, fleet
        self.device = torch.device("cpu")
        self.resilience, self.faults, self.store = jresilience, jfaults, jstore
        self.solver, self.lp_device, self.lanes = jsolver, jlp_device, jcb

    def solve(self):
        return self.resilience.shared().solve_packing(self.enc, mode="ffd")

    def solve_async(self):
        return self.resilience.shared().solve_packing_async(self.enc, mode="ffd")

    def direct(self):
        return jpack.solve_packing(self.enc, mode="ffd", shards=1)

    def mesh(self, n):
        # tests/conftest.py gives the JAX package 8 CPU devices
        return contextlib.nullcontext()

    def lane_solver(self):
        pools, inputs, pods_on = self.fleet
        lanes = [jcb.ProbeLane(exclude_names=tuple(inputs[i].name for i in s),
                               pods=[p for i in s for p in pods_on[i]])
                 for s in LADDER_LANES]
        return jcb.LaneSolver(pools, inputs), lanes

    def maybe_lp(self):
        return self.lp_device.maybe_solve(self.enc)

    def cost(self):
        return fingerprint(self.solver.solve_encoded(self.enc, objective="cost"))

    def reset_caches(self):
        for cache in (jsolver._ffd_floor, jsolver._warm_arm, jsolver._plan_cache):
            cache.clear()
        jlp_device.reset()
        jlp_plan._warm_patterns.clear()


@pytest.fixture(scope="module")
def ladder_runs():
    pods, pools = build_problem(200, 10, seed=7)
    jpods, jpools = bench.build_problem(200, 10, seed=7)
    enc = encode(group_pods(pods), pools)
    jenc = jencode(jgroup_pods(jpods), jpools)
    port = build_fleet(3)
    jax_ = jbuild_fleet(3)
    for mod in (resilience, jresilience):
        mod.reset()
    ours = ladder_script(LadderPackage(enc, port[:3], "cpu"))
    theirs = ladder_script(JaxLadder(jenc, jax_))
    return ours, theirs


def test_ladder_script_holds_its_sequence_on_the_port(ladder_runs):
    (records, walls), _ = ladder_runs
    assert ladder_mismatches(records, walls) == []


def test_ladder_script_holds_its_sequence_on_jax(ladder_runs):
    _, (records, walls) = ladder_runs
    assert ladder_mismatches(records, walls) == []


def test_ladder_script_equals_jax(ladder_runs):
    (ours, _), (theirs, _) = ladder_runs
    assert [r["stage"] for r in ours] == [r["stage"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert a == b, (a["stage"], a.get("step"))


# -- (e) the C3 seams


def test_maybe_solve_degrades_and_counts(monkeypatch):
    enc = _enc(seed=3)

    def broken(*a, **k):
        raise cuda_build.KernelError("lp_ascend: CUDA error 700 at launch")

    monkeypatch.setattr(lp_device, "solve", broken)
    before = SOLVER_LP_SOLVES.value({"outcome": "degraded"})
    assert lp_device.maybe_solve(enc, device="cpu") is None
    assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before + 1
    # disabled guidance and degenerate problems are not degradations
    monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
    assert lp_device.maybe_solve(enc, device="cpu") is None
    assert SOLVER_LP_SOLVES.value({"outcome": "degraded"}) == before + 1


def _lane_solver(seed=11):
    pools, inputs, pods_on, _ = build_fleet(seed)
    lanes = [consolidation_batch.ProbeLane(
        exclude_names=tuple(inputs[i].name for i in s),
        pods=[p for i in s for p in pods_on[i]]) for s in ((0,), (1,), (0, 1))]
    return consolidation_batch.LaneSolver(pools, inputs, device="cpu"), lanes


def test_dual_certificate_remembers_a_failed_build(monkeypatch):
    ls, lanes = _lane_solver()
    thunks = ls.solve_lazy(lanes)
    thunks[0]()
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise ValueError("certificate")

    monkeypatch.setattr(lp_device, "DualCertificate", broken)
    assert ls.dual_certificate() is None
    assert ls.dual_certificate() is None
    assert calls == [1]
    monkeypatch.undo()
    ls.solve_lazy(lanes)
    assert ls.dual_certificate() is not None


def test_probe_site_charges_breaker_for_device_failures_only(monkeypatch):
    ls, lanes = _lane_solver()
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@probe:1")
    thunks = ls.solve_lazy(lanes)
    with pytest.raises(faults.DeviceLostError):
        thunks[0]()
    br = resilience.shared().breaker("device")
    assert br._failures == 1 and br.state == STATE_CLOSED
    assert faults.get().snapshot_log() == [("probe", 1, "device_lost")]
    monkeypatch.delenv("KARPENTER_FAULTS")
    faults.reset()
    resilience.reset()

    def staging_bug(*a, **k):
        raise ValueError("a host-side staging error")

    monkeypatch.setattr(consolidation_batch.kernels, "pack_split_flat", staging_bug)
    monkeypatch.setattr(consolidation_batch.kernels, "pack_probe_lanes_flat", staging_bug)
    with pytest.raises(ValueError, match="staging"):
        ls.solve_lazy(lanes)[0]()
    assert resilience.shared().breaker("device")._failures == 0
    monkeypatch.undo()
    assert ls.solve_lazy(lanes)[0]() is not None


def test_probe_span_and_fault_event():
    from karpenter_tpu_torch import tracing

    ls, lanes = _lane_solver()
    with tracing.trace("tick"):
        ls.solve_lazy(lanes)[2]()
    spans = tracing.last_trace()["spans"]
    batches = [s for s in spans if s["name"] == "disruption.probe_batch"]
    assert batches and batches[0]["attrs"]["lanes"] >= 1


def test_rung_spans_name_each_attempt(monkeypatch):
    from karpenter_tpu_torch import tracing

    enc = _enc(seed=59)
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1")
    with tracing.trace("tick"):
        _solve(enc)
    spans = tracing.last_trace()["spans"]
    rungs = [(s["attrs"]["rung"], s["attrs"]["outcome"]) for s in spans
             if s["name"] == "solver.rung"]
    assert rungs == [("device", "device_lost"), ("host", "ok")]
    faults_seen = [e for s in spans for e in s["events"] if e["name"] == "fault"]
    assert faults_seen == [{"name": "fault", "kind": "device_lost", "site": "solve", "seq": 1}]


# -- (f) the guard, with the ladder's host rung on a watchdog thread


def test_host_rung_solve_loads_no_jax():
    code = (
        "import os, sys, json\n"
        "os.environ['KARPENTER_FAULTS'] = 'device_lost@solve:*'\n"
        "os.environ['KARPENTER_SOLVE_DEADLINE_MS'] = '8000'\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "from karpenter_tpu_torch.solver import resilience\n"
        "pods, pools = build_problem(100, 6, seed=1)\n"
        "sol = solve(pods, pools, device='cpu')\n"
        "host = solve(pods, pools, backend='host')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'degraded': resilience.pop_degraded(),"
        " 'nodes': len(sol.new_nodes), 'host_nodes': len(host.new_nodes)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["degraded"] == ["host"]
    assert report["nodes"] == report["host_nodes"] > 0
