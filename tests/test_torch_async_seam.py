"""The asynchronous seam of the port's ladder and the cost race's
overlap, held against the JAX package on the CPU.

(a) The asynchronous cases of tests/test_resilience.py through
    `ResilientSolver.solve_packing_async` on both packages: a fetch
    failure falls down the ladder, the hedge, the degradation report of
    a worker-thread ladder, and the deadline cases (compile and execute
    stalls, an instant failure that must not burn the compile budget, a
    generous deadline on a healthy solve). Each served result, counter
    delta, breaker state and fault log equal to the JAX package's.
(b) The port's own rules at the seam: on a CUDA device a fetch failure
    that is not an injected fault reaches the caller; a pending solve
    dropped unfetched records nothing on the breaker; the fetch holds
    the launch's inputs until it returns.
(c) The cost race in the JAX package's order: FFD dispatched, column
    generation, the cost and rank arms dispatched, then FFD, cost and
    rank fetched (the same sequence of dispatches, plans and fetches in
    both packages); cold and warm races equal to the JAX package's
    solution, `lp` summary and warm-arm record; faulted cold races whose
    fault log, ladder counts, breaker transitions and states and
    `pop_degraded()` equal the JAX package's.

Tolerance: exact equality. Stalls are drained after each test so that
no abandoned attempt fires a fault site under the next test's spec.
"""

import threading
import time
import weakref

import pytest
import torch

from karpenter_tpu.metrics import store as jstore
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver import pack as jpack
from karpenter_tpu.solver import resilience as jresilience
from karpenter_tpu.solver import solver as jsolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.metrics import store
from karpenter_tpu_torch.solver import faults, lp_device, lp_plan, pack, resilience, solver
from karpenter_tpu_torch.solver.solver import fingerprint
from karpenter_tpu_torch.testing import LADDER_KNOBS, pack_digest

from test_torch_cost import carried_dlp, carried_plan, clean, encodes  # noqa: F401

pytestmark = pytest.mark.chaos

COUNTERS = ("SOLVER_LADDER", "SOLVER_HEDGE", "SOLVER_DEADLINE_EXCEEDED",
            "SOLVER_BREAKER_TRANSITIONS")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
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


class Side:
    """One package's side: its resilience, faults and metrics, the
    encoded problem, and the calls whose signatures differ."""

    def __init__(self, root, enc):
        self.root, self.enc = root, enc
        if root == "port":
            self.res, self.flt, self.store, self.pack = resilience, faults, store, pack
        else:
            self.res, self.flt, self.store, self.pack = jresilience, jfaults, jstore, jpack

    def kw(self):
        return {"device": "cpu"} if self.root == "port" else {}

    def solve_async(self):
        return self.res.shared().solve_packing_async(self.enc, mode="ffd", **self.kw())

    def host(self):
        if self.root == "port":
            return self.res.host_pack_result(self.enc)
        return self.res.host_pack_result(self.enc, 0)

    def direct(self):
        return self.pack.solve_packing(self.enc, mode="ffd", **self.kw())

    def snap(self):
        return {n: dict(getattr(self.store, n).samples()) for n in COUNTERS}

    def deltas(self, before):
        out = {}
        for n in COUNTERS:
            d = {",".join(f"{k}={v}" for k, v in labels): int(value - before[n].get(labels, 0.0))
                 for labels, value in getattr(self.store, n).samples()
                 if value - before[n].get(labels, 0.0)}
            out[n] = d
        return out

    def log(self):
        inj = self.flt.get()
        return [list(e) for e in inj.snapshot_log()] if inj is not None else []


def _sides(seed, n_pods=200, n_types=10):
    enc, jenc = encodes(n_pods, n_types, seed)
    return Side("port", enc), Side("jax", jenc)


def _fresh(side):
    side.res._drain_watchdogs()
    side.res.reset()
    side.flt.reset()
    side.res.pop_degraded()


def _observe(side, run, refs: dict) -> dict:
    """Run `run(side)` (which returns a PackResult) from a clean
    ladder; the record of what the ladder did. `refs` are the host
    oracle's and the direct solve's digests, taken with no fault set."""
    _fresh(side)
    before = side.snap()
    t0 = time.monotonic()
    out = run(side)
    wall = time.monotonic() - t0
    side.res._drain_watchdogs()
    digest = pack_digest(out)
    return {"pack": digest, "host": digest == refs["host"], "direct": digest == refs["direct"],
            "degraded": side.res.pop_degraded(), "counts": side.deltas(before),
            "breaker": side.res.shared().breaker("device").state, "faults": side.log(),
            "wall": wall}


def _refs(side) -> dict:
    return {"host": pack_digest(side.host()), "direct": pack_digest(side.direct())}


def _both(seed, env, run, monkeypatch):
    port, jax_ = _sides(seed)
    refs = {side.root: _refs(side) for side in (port, jax_)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = _observe(port, run, refs["port"]), _observe(jax_, run, refs["jax"])
    walls = ours.pop("wall"), theirs.pop("wall")
    assert ours == theirs
    return ours, walls


def _fetch(side):
    return side.solve_async().result()


# -- (a) tests/test_resilience.py's asynchronous cases


def test_async_fetch_failure_falls_down_ladder(monkeypatch):
    """tests/test_resilience.py:415: the dispatch succeeds, the execute
    fetch loses the device, the host oracle serves."""
    rec, _ = _both(23, {"KARPENTER_FAULTS": "device_lost@execute:*"}, _fetch, monkeypatch)
    assert rec["host"] and rec["degraded"] == ["host"]
    assert rec["counts"]["SOLVER_LADDER"] == {"outcome=device_lost,rung=device": 1,
                                              "outcome=ok,rung=host": 1}
    assert rec["faults"] == [["execute", 1, "device_lost"]]


def test_async_healthy_solve_is_served_by_the_device_rung(monkeypatch):
    port, _ = _sides(5)
    pending = port.solve_async()
    assert type(pending).__name__ == "_GuardedPending"
    rec, _ = _both(5, {}, _fetch, monkeypatch)
    assert rec["direct"] and rec["degraded"] == []
    assert rec["counts"]["SOLVER_LADDER"] == {"outcome=ok,rung=device": 1}


def test_async_dispatch_failure_runs_the_rest_at_fetch(monkeypatch):
    """A failure at dispatch is recorded at once; the host runs at the
    fetch (`_LazyPending`)."""
    rec, _ = _both(9, {"KARPENTER_FAULTS": "device_lost@solve:1"}, _fetch, monkeypatch)
    assert rec["host"] and rec["degraded"] == ["host"]
    port, _ = _sides(9)
    _fresh(port)
    pending = port.solve_async()
    assert type(pending).__name__ == "_LazyPending"
    assert port.res.shared().breaker("device")._failures == 1
    assert pending.result() is pending.result()


def test_async_open_breaker_skips_to_host(monkeypatch):
    env = {"KARPENTER_FAULTS": "device_lost@solve:1-2", "KARPENTER_BREAKER_THRESHOLD": "2",
           "KARPENTER_BREAKER_COOLDOWN_MS": "60000"}

    def three(side):
        for _ in range(2):
            side.solve_async().result()
        return side.solve_async().result()

    rec, _ = _both(11, env, three, monkeypatch)
    assert rec["breaker"] == resilience.STATE_OPEN
    assert rec["counts"]["SOLVER_LADDER"]["outcome=skipped_open,rung=device"] == 1
    assert rec["degraded"] == ["host", "host", "host"]


def test_hedge_precomputes_the_degraded_answer(monkeypatch):
    """tests/test_resilience.py:459 through the asynchronous seam (a
    hedged solve runs its ladder on a worker): the result is the host's
    on every attempt; the hedge's win, which a late timer thread can
    miss on a loaded host, must show on one of three attempts."""
    env = {"KARPENTER_FAULTS": "exec_delay=1.2s", "KARPENTER_SOLVE_DEADLINE_MS": "500",
           "KARPENTER_SOLVE_HEDGE_MS": "50"}
    sides = _sides(37)
    hosts = [pack_digest(side.host()) for side in sides]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for side, host in zip(sides, hosts):
        won = False
        for _ in range(3):
            _fresh(side)
            wins = side.store.SOLVER_HEDGE.value({"outcome": "win"})
            out = side.solve_async().result()
            assert pack_digest(out) == host
            assert side.res.pop_degraded() == ["host"]
            side.res._drain_watchdogs()
            if side.store.SOLVER_HEDGE.value({"outcome": "win"}) == wins + 1:
                won = True
                break
        assert won, f"{side.root}: the hedge never supplied the answer in 3 attempts"


def test_compile_stall_times_out_and_degrades(monkeypatch):
    env = {"KARPENTER_FAULTS": "compile_delay=2s", "KARPENTER_COMPILE_DEADLINE_MS": "150",
           "KARPENTER_SOLVE_DEADLINE_MS": "400"}
    rec, walls = _both(29, env, _fetch, monkeypatch)
    assert rec["host"] and rec["degraded"] == ["host"]
    assert rec["counts"]["SOLVER_DEADLINE_EXCEEDED"] == {"phase=compile": 1}
    assert rec["counts"]["SOLVER_LADDER"]["outcome=compile_timeout,rung=device"] == 1
    assert walls[0] < 1.5, f"the watchdog waited out the stall: {walls[0]:.2f}s"


def test_execute_stall_times_out_within_deadline(monkeypatch):
    env = {"KARPENTER_FAULTS": "exec_delay=2s", "KARPENTER_SOLVE_DEADLINE_MS": "300"}
    rec, walls = _both(31, env, _fetch, monkeypatch)
    assert rec["host"] and rec["degraded"] == ["host"]
    assert rec["counts"]["SOLVER_LADDER"]["outcome=deadline,rung=device"] == 1
    assert walls[0] < 1.5


def test_instant_failure_does_not_burn_compile_budget(monkeypatch):
    env = {"KARPENTER_FAULTS": "device_lost@solve:*", "KARPENTER_COMPILE_DEADLINE_MS": "5000",
           "KARPENTER_SOLVE_DEADLINE_MS": "8000"}
    rec, walls = _both(47, env, _fetch, monkeypatch)
    assert rec["host"]
    assert walls[0] < 2.0, f"the compile budget was slept out: {walls[0]:.2f}s"


def test_degraded_report_survives_worker_thread_ladder(monkeypatch):
    """tests/test_resilience.py:518: with a deadline set the ladder runs
    on an executor worker; the report lands on the calling thread."""
    port, _ = _sides(53)
    host = pack_digest(port.host())
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:*")
    monkeypatch.setenv("KARPENTER_SOLVE_DEADLINE_MS", "8000")
    seen = []
    real = port.res.ResilientSolver._ladder

    def spy(self, *a, **k):
        seen.append(threading.current_thread().name)
        return real(self, *a, **k)

    monkeypatch.setattr(port.res.ResilientSolver, "_ladder", spy)
    out = port.solve_async().result()
    assert pack_digest(out) == host
    assert seen and seen[0].startswith("solver-resilient")
    assert "host" in port.res.pop_degraded()
    monkeypatch.undo()
    env = {"KARPENTER_FAULTS": "device_lost@solve:*", "KARPENTER_SOLVE_DEADLINE_MS": "8000"}
    rec, _ = _both(53, env, _fetch, monkeypatch)
    assert rec["degraded"] == ["host"]


def test_healthy_solve_ignores_generous_deadline(monkeypatch):
    rec, _ = _both(41, {"KARPENTER_SOLVE_DEADLINE_MS": "60000"}, _fetch, monkeypatch)
    assert rec["direct"] and rec["degraded"] == []


# -- (b) the port's rules at the seam


def test_card_fetch_failure_reaches_the_caller(monkeypatch):
    """On a CUDA device a fetch failure that is not an injected fault
    is counted and raised: no breaker charged, no host rung."""
    port, _ = _sides(13)

    def card(*a, **k):
        return pack.PendingPack(lambda: (_ for _ in ()).throw(
            ValueError("pack_split: 17 resources exceed the kernel's 16")))

    monkeypatch.setattr(pack, "solve_packing_async", card)
    before = port.snap()
    pending = resilience.shared().solve_packing_async(port.enc, mode="ffd", device="cuda")
    with pytest.raises(ValueError, match="17 resources"):
        pending.result()
    assert port.deltas(before)["SOLVER_LADDER"] == {"outcome=error,rung=device": 1}
    assert resilience.shared().breaker("device")._failures == 0
    assert resilience.pop_degraded() == []


def test_card_injected_fetch_fault_degrades(monkeypatch):
    port, _ = _sides(13)
    host = pack_digest(port.host())

    def card(*a, **k):
        def fetch():
            faults.fire("execute")
            raise AssertionError("the fault must fire first")
        return pack.PendingPack(fetch)

    monkeypatch.setattr(pack, "solve_packing_async", card)
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@execute:1")
    out = resilience.shared().solve_packing_async(port.enc, mode="ffd", device="cuda").result()
    assert pack_digest(out) == host
    assert resilience.pop_degraded() == ["host"]
    assert resilience.shared().breaker("device")._failures == 1


def test_card_dispatch_failure_reaches_the_caller(monkeypatch):
    port, _ = _sides(13)

    def card(*a, **k):
        raise ValueError("a width the kernels refuse")

    monkeypatch.setattr(pack, "solve_packing_async", card)
    with pytest.raises(ValueError, match="refuse"):
        resilience.shared().solve_packing_async(port.enc, mode="ffd", device="cuda")
    assert resilience.shared().breaker("device")._failures == 0


def test_dropped_pending_records_nothing(monkeypatch):
    """Neither the breaker nor the ladder's counts move for a pending
    solve that is never fetched; a half-open admission it held expires
    after the probe's time to live, and the next solve closes the
    breaker."""
    port, _ = _sides(17)
    # the cooldown's base is also the probe's time to live
    monkeypatch.setenv("KARPENTER_BREAKER_COOLDOWN_MS", "1500")
    br = resilience.shared().breaker("device")
    before = port.snap()
    pending = port.solve_async()
    del pending
    assert port.deltas(before)["SOLVER_LADDER"] == {}
    assert br._failures == 0 and br.state == resilience.STATE_CLOSED
    br.record_failure("device_lost")
    br.record_failure("device_lost")
    assert br.state == resilience.STATE_OPEN
    while br.is_open():
        time.sleep(0.01)
    dropped = port.solve_async()   # admitted as the half-open probe
    assert br.state == resilience.STATE_HALF_OPEN
    del dropped
    assert not br.allow()          # the probe is still out
    while time.monotonic() < br._retry_at:  # past the probe's time to live
        time.sleep(0.01)
    out = port.solve_async().result()
    assert pack_digest(out) == pack_digest(port.direct())
    assert br.state == resilience.STATE_CLOSED


def test_fetch_holds_the_launch_inputs(monkeypatch):
    """The pending solve keeps every tensor its launch reads until its
    fetch returns, then lets them go."""
    port, _ = _sides(19)
    held = []
    real = pack.to_device

    def spy(staged, device):
        args, kwargs = real(staged, device)
        held.append([a for a in args if isinstance(a, torch.Tensor)])
        return args, kwargs

    monkeypatch.setattr(pack, "to_device", spy)
    pending = pack.solve_packing_async(port.enc, mode="ffd", device="cpu")
    refs = [weakref.ref(t) for t in held[0]]
    held.clear()
    assert all(r() is not None for r in refs)
    pending.result()
    assert all(r() is None for r in refs)


def test_caller_stream_is_none_off_the_card():
    from karpenter_tpu_torch.utils.platform import caller_stream, on_stream

    assert caller_stream("cpu") is None and caller_stream(None) is None
    with on_stream(None):
        pass


# -- (c) the cost race


_CARRIED: dict = {}


def _carry(monkeypatch, seed, n_pods=1200, n_types=60):
    """Both packages' race over the same plan and duals (the JAX
    package's, carried to the port, made once a seed), so the arms
    differ in nothing but the packs."""
    if seed not in _CARRIED:
        enc, jenc = encodes(n_pods, n_types, seed)
        jplan = jlp_plan.plan(jenc)
        jdlp = jlp_device.solve(jenc)
        assert jplan is not None and jdlp is not None
        _CARRIED[seed] = enc, jenc, jplan, jdlp, carried_plan(jplan), carried_dlp(jdlp)
    enc, jenc, jplan, jdlp, plan, dlp = _CARRIED[seed]
    monkeypatch.setattr(jlp_plan, "plan", lambda e, **k: jplan)
    monkeypatch.setattr(jlp_device, "maybe_solve", lambda e, **k: jdlp)
    monkeypatch.setattr(lp_plan, "plan", lambda e, **k: plan)
    monkeypatch.setattr(lp_device, "maybe_solve", lambda e, **k: dlp)
    return enc, jenc


def _race_port(enc):
    return solver._decode_device(enc, "cost", torch.device("cpu"))


def _race_jax(jenc):
    return jsolver._decode_device(jenc, "cost")


def test_race_dispatches_in_the_jax_order(clean, monkeypatch):  # noqa: F811
    enc, jenc = _carry(monkeypatch, 2)
    orders = {}
    for name, pk, sv, race, e in (("port", pack, solver, _race_port, enc),
                                  ("jax", jpack, jsolver, _race_jax, jenc)):
        seen = []
        real_run, real_plan = pk._run_pack, sv._plan_for

        def run(*a, _real=real_run, _seen=seen, **k):
            mode = a[4] if len(a) > 4 else k.get("mode", "ffd")
            _seen.append(("dispatch", mode))
            fetch = _real(*a, **k)

            def traced():
                _seen.append(("fetch", mode))
                return fetch()
            return traced

        def plan_for(*a, _real=real_plan, _seen=seen, **k):
            _seen.append(("plan",))
            return _real(*a, **k)

        monkeypatch.setattr(pk, "_run_pack", run)
        monkeypatch.setattr(sv, "_plan_for", plan_for)
        race(e)
        orders[name] = seen
    assert orders["port"] == orders["jax"]
    assert orders["port"][:2] == [("dispatch", "ffd"), ("plan",)]
    fetches = [i for i, s in enumerate(orders["port"]) if s[0] == "fetch"]
    dispatches = [i for i, s in enumerate(orders["port"]) if s[0] == "dispatch"]
    assert len(dispatches) == 3 and max(dispatches) < min(fetches)
    assert [orders["port"][i][1] for i in fetches] == ["ffd", "cost", "cost"]


@pytest.mark.parametrize("seed", [1, 2])
def test_cold_and_warm_race_equal_jax(clean, monkeypatch, seed):  # noqa: F811
    enc, jenc = _carry(monkeypatch, seed)
    for _ in ("cold", "warm", "warm again"):
        theirs = _race_jax(jenc)
        ours = _race_port(enc)
        assert fingerprint(ours) == fingerprint(theirs)
        assert ours.lp == theirs.lp
        key = solver._race_fingerprint(enc)
        assert solver._warm_arm[key] == jsolver._warm_arm[key]
        assert solver._ffd_floor[key] == jsolver._ffd_floor[key]
    assert ours.lp["guided"]


FAULTED = [
    ("device_lost@execute:1", "1"),
    ("device_lost@execute:1", "2"),
    ("device_lost@execute:2-3", "2"),
    ("device_lost@solve:2", "1"),
    ("device_lost@compile:1,device_lost@execute:2", "2"),
]


@pytest.mark.parametrize("spec,threshold", FAULTED)
def test_faulted_cold_race_equals_jax(clean, monkeypatch, spec, threshold):  # noqa: F811
    """A cold cost race under a fault spec: the solution, the fault
    log, the ladder's and the breaker transitions' counts, each
    breaker's state and the degradation report equal the JAX
    package's. The breaker is recorded at each arm's fetch, after every
    arm was dispatched, as in the JAX package."""
    enc, jenc = _carry(monkeypatch, 2)
    monkeypatch.setenv("KARPENTER_FAULTS", spec)
    monkeypatch.setenv("KARPENTER_BREAKER_THRESHOLD", threshold)
    monkeypatch.setenv("KARPENTER_BREAKER_COOLDOWN_MS", "60000")
    recs = {}
    for side, race, e in ((Side("port", enc), _race_port, enc), (Side("jax", jenc), _race_jax, jenc)):
        _fresh(side)
        before = side.snap()
        sol = race(e)
        recs[side.root] = {
            "solution": fingerprint(sol),
            "lp": sol.lp, "faults": side.log(), "counts": side.deltas(before),
            "breakers": {n: side.res.shared().breaker(n).state for n in ("device",)},
            "degraded": side.res.pop_degraded()}
    assert recs["port"] == recs["jax"]
    assert recs["port"]["faults"], "the spec fired no fault"
