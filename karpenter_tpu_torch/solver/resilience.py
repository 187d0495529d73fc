"""Solver resilience layer: deadlines, circuit breakers, degradation
ladder, and an FFD hedge around every device-bound solve.

Copy of `karpenter_tpu/solver/resilience.py`. `ResilientSolver` wraps
the `solver._solve_packing` seam and its asynchronous twin
`solver._solve_packing_async`, so every packing solve (ffd, every arm
of the cost race, each split solve) returns a decision past the faults
the ladder exists for: degraded, perhaps, but never absent and never
late past the deadline.

1. **Deadline watchdog** (`KARPENTER_SOLVE_DEADLINE_MS`,
   `KARPENTER_COMPILE_DEADLINE_MS`): with a deadline set, each rung's
   attempt runs on a watchdog thread. The compile phase is budgeted
   separately: `pack._run_pack` signals `note_dispatched()` once the
   kernel launch returns, which is also after the kernel libraries have
   loaded or been built (`cuda_build`), so a hung build or launch is
   told apart from a slow execute and classified `compile_timeout`. A
   deadline miss abandons the attempt (the stuck thread keeps the
   device; the breaker keeps callers off it) and falls down the ladder.
   Unset (the default) the attempt runs inline: a try/except around the
   exact call that ran before, with no thread.

2. **Per-backend circuit breaker**: `closed -> open` after
   `KARPENTER_BREAKER_THRESHOLD` consecutive classified failures; while
   open, the rung is skipped outright. Cooldowns are jittered
   exponential (KARPENTER_BREAKER_COOLDOWN_MS base,
   KARPENTER_BREAKER_MAX_COOLDOWN_MS cap). After the cooldown one
   half-open probe is admitted; its success closes the breaker, its
   failure re-opens it with a doubled cooldown.

3. **Degradation ladder**: sharded device -> single device -> host FFD
   oracle (`reference_ffd`). `auto` derives the order from the
   environment (the sharded rung when a split solve is asked for);
   KARPENTER_SOLVE_LADDER="sharded,device,host" sets it explicitly. The
   host oracle is always last and cannot fail. The optional **hedge**
   (KARPENTER_SOLVE_HEDGE_MS) starts the host solve on a timer thread
   mid-attempt, so when a slow device misses the deadline the degraded
   answer is already computed.

Every rung other than the first that serves a solve is reported as
degraded: a `pop_degraded()` entry for the calling thread, a
karpenter_solver_ladder_total{rung, outcome="ok"} count and a
`solver.rung` span. Nothing falls back silently, and the card is never
replaced by the host when it is missing: `solver.resolve_device` raises
before the ladder runs.

On a CUDA device the ladder degrades only past the faults it exists
for (`may_degrade`): an injected fault (`faults.FaultError`) and a
watchdog deadline. Every other failure of a rung on the card (a kernel
that does not build or launch, a width the kernels refuse, a CUDA
error, a bug) is counted on the ladder and its span, charges no
breaker, and reaches the caller: the work never moves off the card
because the card's code failed. Off the card (`device="cpu"`, the
kernels' plain versions) every failure degrades, as in the JAX package.

KARPENTER_REWARM_ON_CLOSE=1 gates a device breaker's half-open ->
closed transition on `warm_pool.rewarm_canary` launched on the device of
the solve that succeeded, as in the JAX package; the canary's failure
keeps the breaker open, and on a CUDA device a failure that is not an
injected fault is raised (`may_degrade`).

**Asynchronous seam** (`solve_packing_async`, which the cost race
uses to overlap its host work with the kernels): on the healthy path,
a local device rung with a closed breaker and no deadline, hedge or
`remote` rung, the solve is dispatched directly
(`pack.solve_packing_async`) and only its fetch is guarded
(`_GuardedPending`): a failure at the `execute` site or in the copy is
recorded on the breaker at the fetch and falls down the rest of the
ladder, as in the JAX package. A failure at dispatch is recorded at
once and the rest of the ladder runs at the fetch (`_LazyPending`).
Anything else (deadlines, the hedge, an open breaker) runs the whole
ladder on a worker of a 4-thread executor; the caller thread's
degradation list is captured at dispatch, so the report lands on the
calling thread. Workers and watchdog threads launch on the stream of
the thread they work for (`utils.platform.caller_stream`), so the card
runs the solves in dispatch order. One difference from the JAX
package: at the fetch, as everywhere on the card, only a failure that
`may_degrade` lets through degrades; the JAX `_GuardedPending`
degrades on any exception.

What this package leaves out: the `remote` rung (the solver service; a
configured KARPENTER_SOLVER_ENDPOINT or a ladder naming `remote` raises
`NotImplementedError`).

Observability: karpenter_solver_breaker_state (0 closed / 1 half-open
/ 2 open), _breaker_transitions_total, _ladder_total{rung,outcome},
_deadline_exceeded_total{phase}, _hedge_total{outcome}.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.cuda_build import KernelError
from karpenter_tpu_torch.metrics.store import (
    SOLVER_BREAKER_STATE,
    SOLVER_BREAKER_TRANSITIONS,
    SOLVER_DEADLINE_EXCEEDED,
    SOLVER_HEDGE,
    SOLVER_LADDER,
)
from karpenter_tpu_torch.solver import faults
from karpenter_tpu_torch.utils.backoff import capped_exponential, jitter
from karpenter_tpu_torch.utils.platform import caller_stream, on_stream

log = logging.getLogger("karpenter.solver.resilience")

STATE_CLOSED = 0.0
STATE_HALF_OPEN = 1.0
STATE_OPEN = 2.0

RUNGS = ("remote", "sharded", "device", "host")

_REMOTE_MISSING = (
    "the remote rung needs the solver service (service/client.py), which "
    "karpenter_tpu_torch does not have yet (ROADMAP item 8); unset "
    "KARPENTER_SOLVER_ENDPOINT and leave `remote` out of KARPENTER_SOLVE_LADDER"
)


def _env_ms(name: str, default: float = 0.0) -> float:
    """Millisecond env knob -> seconds; 0/unset/malformed disables."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(0.0, float(raw) / 1000.0)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class DeadlineExceeded(TimeoutError):
    """The watchdog abandoned a rung attempt past its budget."""

    phase = "execute"


class CompileDeadlineExceeded(DeadlineExceeded):
    """The kernel launch (with the libraries' load or build) blew its
    own budget."""

    phase = "compile"


def _torch_device_errors() -> tuple:
    """The exception types torch raises for a failing card."""
    names = (
        getattr(torch.cuda, "OutOfMemoryError", None),
        getattr(torch, "AcceleratorError", None),
        getattr(torch.cuda, "CudaError", None),
    )
    return tuple(t for t in names if isinstance(t, type))


def may_degrade(err: BaseException, device) -> bool:
    """Whether a rung's failure may be served by the next rung (and
    charge a breaker). Off the card, always, as in the JAX package. On
    a CUDA device only an injected fault or a watchdog deadline: any
    other failure there is the card's code failing, and is raised."""
    if torch.device(device).type != "cuda":
        return True
    return isinstance(err, (faults.FaultError, DeadlineExceeded))


def classify(err: BaseException) -> str:
    """Failure taxonomy driving the breaker: which class of fault a
    rung failure belongs to. Anything unrecognized counts as plain
    `error` (the kernels' width refusals among them: ValueErrors); off
    the card it still degrades the solve (`may_degrade`)."""
    if isinstance(err, faults.RpcDropError):
        return "rpc_unavailable"
    if isinstance(err, faults.DeviceLostError):
        return "device_lost"
    if isinstance(err, CompileDeadlineExceeded):
        return "compile_timeout"
    if isinstance(err, DeadlineExceeded):
        return "deadline"
    # a launch that returned a CUDA error, or a kernel that did not
    # build: the counterpart of the JAX package's XLA runtime and
    # compile errors
    if isinstance(err, (KernelError, *_torch_device_errors())):
        return "device_lost"
    if isinstance(err, RuntimeError) and (
        "CUDA error" in str(err) or "CUDA driver error" in str(err)
    ):
        return "device_lost"
    tname = type(err).__name__
    module = type(err).__module__ or ""
    if tname in ("RpcError", "_InactiveRpcError", "_MultiThreadedRendezvous",
                 "FutureTimeoutError") or module.startswith("grpc"):
        return "rpc_unavailable"
    if isinstance(err, (ConnectionError, OSError, TimeoutError)):
        return "rpc_unavailable"
    return "error"


class CircuitBreaker:
    """Closed -> open -> half-open breaker with jittered exponential
    cooldowns and an optional gate on the close transition."""

    def __init__(
        self,
        name: str,
        threshold: Optional[int] = None,
        base_cooldown: Optional[float] = None,
        max_cooldown: Optional[float] = None,
        rng: Optional[random.Random] = None,
        close_gate: Optional[Callable[[], bool]] = None,
    ):
        self.name = name
        self._threshold = threshold
        self._base = base_cooldown
        self._max = max_cooldown
        self._rng = rng or random.Random()
        self.close_gate = close_gate
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._open_cycles = 0
        self._retry_at = 0.0
        self._publish(STATE_CLOSED, transition=False)

    # knobs read per call so tests (and live re-tuning) take effect
    # without rebuilding breakers
    def _threshold_now(self) -> int:
        if self._threshold is not None:
            return self._threshold
        return max(1, _env_int("KARPENTER_BREAKER_THRESHOLD", 2))

    def _cooldown(self) -> float:
        base = (
            self._base
            if self._base is not None
            else _env_ms("KARPENTER_BREAKER_COOLDOWN_MS", 5.0)
        ) or 5.0
        cap = (
            self._max
            if self._max is not None
            else _env_ms("KARPENTER_BREAKER_MAX_COOLDOWN_MS", 120.0)
        ) or 120.0
        # desynchronizing jitter: a fleet of control planes tripped by
        # the same outage must not re-probe in lockstep when it heals
        return capped_exponential(self._open_cycles, base, cap) * jitter(
            self._rng
        )

    def _publish(self, state: float, transition: bool = True) -> None:
        self._state = state
        SOLVER_BREAKER_STATE.set(state, {"backend": self.name})
        if transition:
            label = {STATE_CLOSED: "closed", STATE_HALF_OPEN: "half_open",
                     STATE_OPEN: "open"}[state]
            SOLVER_BREAKER_TRANSITIONS.inc(
                {"backend": self.name, "to": label})

    @property
    def state(self) -> float:
        return self._state

    def is_open(self, now: Optional[float] = None) -> bool:
        """Open AND still cooling down (a breaker past its cooldown is
        about to half-open, so callers planning work may try it)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._state == STATE_OPEN and now < self._retry_at

    def _probe_ttl(self) -> float:
        """How long a half-open probe may stay verdict-less before the
        breaker admits another (a probe abandoned by the deadline
        watchdog must not wedge the breaker half-open forever)."""
        base = (
            self._base
            if self._base is not None
            else _env_ms("KARPENTER_BREAKER_COOLDOWN_MS", 5.0)
        )
        return base or 5.0

    def allow(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN and now >= self._retry_at:
                # admit exactly one half-open probe; a concurrent
                # caller arriving before its verdict stays skipped
                self._publish(STATE_HALF_OPEN)
                self._retry_at = now + self._probe_ttl()
                log.info("breaker %s half-open: probing", self.name)
                return True
            if self._state == STATE_HALF_OPEN and now >= self._retry_at:
                # the admitted probe never reported (abandoned attempt)
                self._retry_at = now + self._probe_ttl()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == STATE_CLOSED:
                self._failures = 0
                return
            gate = self.close_gate
        # the gate runs OUTSIDE the lock: it can take seconds and
        # concurrent solves must keep flowing through their own rungs
        gate_ok = True
        if gate is not None:
            try:
                gate_ok = bool(gate())
            except Exception as err:
                # the card's code failing in the gate reaches the caller
                if not may_degrade(err, getattr(_tlocal, "device", "cpu")):
                    raise
                log.exception("breaker %s close gate crashed", self.name)
                gate_ok = False
        with self._lock:
            if not gate_ok:
                self._open_cycles += 1
                self._retry_at = time.monotonic() + self._cooldown()
                self._publish(STATE_OPEN)
                log.warning(
                    "breaker %s: half-open probe succeeded but the "
                    "close gate failed; staying open", self.name)
                return
            self._failures = 0
            self._open_cycles = 0
            self._publish(STATE_CLOSED)
            log.info("breaker %s closed", self.name)

    def record_failure(self, reason: str) -> None:
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._open_cycles += 1
            else:
                self._failures += 1
                if self._failures < self._threshold_now():
                    return
                self._open_cycles += 1
            cooldown = self._cooldown()
            self._retry_at = time.monotonic() + cooldown
            self._failures = 0
            self._publish(STATE_OPEN)
            log.warning(
                "breaker %s open (%s): cooling down %.2fs",
                self.name, reason, cooldown)

    def force_close(self) -> None:
        """Test/ops escape hatch: reset to closed immediately."""
        with self._lock:
            self._failures = 0
            self._open_cycles = 0
            self._retry_at = 0.0
            self._publish(STATE_CLOSED, transition=False)


# -- host FFD oracle as a PackResult ------------------------------------------


def host_pack_result(enc, mode: str = "ffd"):
    """The decision of last resort: the pure-Python FFD oracle
    (`reference_ffd.solve_ffd_host`) decoded into the same PackResult
    shape the kernels produce, so the ladder degrades without changing
    a single downstream decode path. `mode` is accepted for signature
    parity; the oracle always packs FFD, the floor the cost objective
    races against."""
    from karpenter_tpu_torch.solver.pack import PackResult
    from karpenter_tpu_torch.solver.reference_ffd import solve_ffd_host

    nodes, unsched = solve_ffd_host(enc)
    G, C = enc.compat.shape
    R = enc.group_req.shape[1]
    n = len(nodes)
    assign = np.zeros((n, G), np.int32)
    node_mask = np.zeros((n, C), bool)
    node_used = np.zeros((n, R), np.float64)
    for ni, node in enumerate(nodes):
        node_mask[ni] = node.mask
        node_used[ni] = node.used
        for gi, count in node.assign.items():
            assign[ni, gi] = count
    unsched_arr = np.zeros(G, np.int32)
    for gi, count in unsched.items():
        unsched_arr[gi] = count
    return PackResult(
        assign=assign,
        node_mask=node_mask,
        node_used=node_used,
        node_active=np.ones(n, bool),
        node_count=n,
        unschedulable=unsched_arr,
    )


# -- watchdog plumbing --------------------------------------------------------

_tlocal = threading.local()

# abandoned watchdog attempts still run their (possibly wedged) device
# call on daemon threads; at interpreter shutdown a daemon thread inside
# a CUDA call can die mid-call. The shutdown hook below, registered via
# threading's internal hooks (which run BEFORE daemon threads are
# killed), drains live attempts with a bounded join: injected-fault
# attempts (sleeps) finish quickly; a truly wedged device forfeits the
# budget and the process exits anyway.
_watchdog_threads: set = set()
_watchdog_lock = threading.Lock()


def _drain_watchdogs(budget: float = 10.0) -> None:
    deadline = time.monotonic() + budget
    with _watchdog_lock:
        live = list(_watchdog_threads)
    for thread in live:
        thread.join(max(0.0, deadline - time.monotonic()))


_register = getattr(threading, "_register_atexit", None)
if _register is not None:  # CPython 3.9+
    _register(_drain_watchdogs)
else:  # pragma: no cover - very old interpreters: bounded daemon risk
    import atexit

    atexit.register(_drain_watchdogs)


def note_dispatched() -> None:
    """Called by pack._run_pack the moment the kernel launch returns
    (the libraries loaded or built, the kernels queued). Lets the
    watchdog budget the compile phase separately from execute. No-op
    outside a watchdog attempt."""
    ctx = getattr(_tlocal, "attempt", None)
    if ctx is not None:
        ctx["dispatched"].set()


def _served_list() -> list:
    """The CALLER thread's degradation accumulator. Captured at the
    public solve entry points and passed through explicitly, so ladders
    running on watchdog or executor threads still report into the
    thread that will pop_degraded()."""
    stack = getattr(_tlocal, "served", None)
    if stack is None:
        stack = _tlocal.served = []
    return stack


def _note_rung(served: Optional[list], rung: str, degraded: bool) -> None:
    if degraded and served is not None:
        served.append(rung)


def pop_degraded() -> list[str]:
    """Rungs (other than the primary) that served this thread's solves
    since the last pop."""
    stack = getattr(_tlocal, "served", None)
    if not stack:
        return []
    out = list(stack)
    stack.clear()
    return out


def _ladder_count(rung: str, outcome: str) -> None:
    SOLVER_LADDER.inc({"rung": rung, "outcome": outcome})


class _LazyPending:
    """PendingPack-compatible wrapper over a deferred resilient solve."""

    def __init__(self, thunk):
        self._thunk = thunk
        self._result = None

    def result(self):
        if self._result is None:
            self._result = self._thunk()
        return self._result


class _GuardedPending:
    """A first-rung asynchronous dispatch whose fetch falls down the
    ladder. The breaker and the ladder's counts are recorded at the
    fetch, never at the dispatch, so a pending solve that is dropped
    unfetched records nothing (a half-open admission it held expires
    after the probe's time to live)."""

    def __init__(self, solver: "ResilientSolver", rung: str, pending, device,
                 ladder_tail: Callable):
        self._solver = solver
        self._rung = rung
        self._pending = pending
        self._device = device
        self._tail = ladder_tail
        self._result = None

    def result(self):
        if self._result is not None:
            return self._result
        br = self._solver.breaker(self._rung)
        with tracing.span("solver.rung", rung=self._rung) as rsp:
            try:
                out = self._pending.result()
            except Exception as err:
                reason = classify(err)
                _ladder_count(self._rung, reason)
                rsp.annotate(outcome=reason)
                if not may_degrade(err, self._device):
                    raise
                br.record_failure(reason)
                log.warning("solver rung %s failed at fetch (%s: %s); "
                            "degrading", self._rung, reason, err)
                out = self._tail()
            else:
                # the device the close gate's canary launches on
                _tlocal.device = self._device
                br.record_success()
                _ladder_count(self._rung, "ok")
                rsp.annotate(outcome="ok")
        self._pending = None
        self._result = out
        return out


def note_incremental_poison() -> None:
    """The degradation ladder's `incremental_poison` rung: the
    provisioner's incremental live tick caught (or was told about) a
    poisoned retained-state cache and degraded the tick to the full
    Scheduler's decision. Not a backend rung (no breaker, nothing to
    retry), but a degradation the fleet operator must see in the same
    ladder telemetry as device failures."""
    tracing.add_event("rung_degraded", rung="incremental_poison",
                      reason="quarantined")
    _ladder_count("incremental_poison", "quarantined")


class ResilientSolver:
    """The solve seam's resilience wrapper; one per process (shared())
    so breaker state survives across ticks and callers."""

    def __init__(self):
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_lock = threading.Lock()
        self._executor = None
        self._executor_lock = threading.Lock()

    # -- breakers ------------------------------------------------------------

    def breaker(self, name: str) -> CircuitBreaker:
        with self._breaker_lock:
            br = self._breakers.get(name)
            if br is None:
                gate = (
                    self._rewarm_gate
                    if name in ("device", "sharded") else None
                )
                br = CircuitBreaker(name, close_gate=gate)
                self._breakers[name] = br
            return br

    def _rewarm_gate(self) -> bool:
        """Close-transition gate of the device backends: with
        KARPENTER_REWARM_ON_CLOSE=1, a half-open success closes the
        breaker only after the warm pool's canary launched and read back
        on the device of that solve (the ladder notes it before
        `record_success`)."""
        if os.environ.get("KARPENTER_REWARM_ON_CLOSE", "").lower() not in (
            "1", "true", "on"
        ):
            return True
        from karpenter_tpu_torch.solver.warm_pool import rewarm_canary

        return rewarm_canary(getattr(_tlocal, "device", None))

    def reset(self) -> None:
        """Drop all breaker state (tests)."""
        with self._breaker_lock:
            self._breakers.clear()

    # -- ladder --------------------------------------------------------------

    def _rungs(self, shards: int) -> list[str]:
        spec = os.environ.get("KARPENTER_SOLVE_LADDER", "auto").strip()
        if self._endpoint():
            raise NotImplementedError(_REMOTE_MISSING)
        if spec and spec != "auto":
            names = [n.strip() for n in spec.split(",") if n.strip()]
            if "remote" in names:
                raise NotImplementedError(_REMOTE_MISSING)
            names = [n for n in names if n in RUNGS]
        else:
            names = []
            if self._effective_shards(shards) > 1:
                names.append("sharded")
            names.append("device")
        # host is the unconditional floor, always last
        names = [n for n in names if n != "host"] + ["host"]
        return names

    @staticmethod
    def _endpoint() -> Optional[str]:
        return os.environ.get("KARPENTER_SOLVER_ENDPOINT") or None

    @staticmethod
    def _effective_shards(shards: int) -> int:
        if shards > 1:
            return shards
        if shards == 0:
            from karpenter_tpu_torch.solver.pack import default_shards

            return default_shards()
        return 1

    def _rung_fn(self, name: str, enc, mode, plan, shards, device):
        from karpenter_tpu_torch.solver import pack

        if name == "sharded":
            eff = self._effective_shards(shards)
            return lambda: pack.solve_packing(
                enc, mode=mode, plan=plan, device=device, shards=eff)
        if name == "device":
            # shards=1 forces the unsharded program even when the env
            # asks for a mesh: this rung IS the single-device fallback
            eff = 1 if self._effective_shards(shards) > 1 else shards
            return lambda: pack.solve_packing(
                enc, mode=mode, plan=plan, device=device, shards=eff)
        if name == "host":
            return lambda: host_pack_result(enc, mode)
        raise LookupError(name)

    # -- attempts ------------------------------------------------------------

    def _attempt(self, name: str, fn: Callable, budget: Optional[float],
                 compile_budget: float, device=None):
        """One rung attempt. Without budgets: inline (no thread). With
        budgets: on a watchdog thread that launches on the caller's
        stream, compile and execute phases budgeted separately; a miss
        abandons the thread (daemon: the wedged device call cannot hold
        a pool slot hostage)."""
        if not budget and not compile_budget:
            return fn()
        stream = caller_stream(device)
        ctx = {
            "dispatched": threading.Event(),
            "done": threading.Event(),
            "result": None,
            "error": None,
        }

        def run():
            _tlocal.attempt = ctx
            try:
                with on_stream(stream):
                    ctx["result"] = fn()
            except BaseException as err:  # noqa: BLE001 — re-raised below
                ctx["error"] = err
            finally:
                _tlocal.attempt = None
                ctx["done"].set()
                # a failure BEFORE the kernel launch (dead device
                # raising instantly) must release the compile-budget
                # wait immediately, not let it sleep out the budget
                ctx["dispatched"].set()
                with _watchdog_lock:
                    _watchdog_threads.discard(threading.current_thread())

        thread = threading.Thread(
            target=run, name=f"solve-watchdog-{name}", daemon=True)
        with _watchdog_lock:
            _watchdog_threads.add(thread)
        start = time.monotonic()
        thread.start()
        if compile_budget and name in ("device", "sharded"):
            if not ctx["dispatched"].wait(compile_budget) and not ctx[
                "done"
            ].is_set():
                SOLVER_DEADLINE_EXCEEDED.inc({"phase": "compile"})
                raise CompileDeadlineExceeded(
                    f"{name}: kernel launch exceeded "
                    f"{compile_budget * 1000:.0f}ms compile budget")
        if budget:
            remaining = budget - (time.monotonic() - start)
            if not ctx["done"].wait(max(0.0, remaining)):
                SOLVER_DEADLINE_EXCEEDED.inc({"phase": "execute"})
                raise DeadlineExceeded(
                    f"{name}: solve exceeded {budget * 1000:.0f}ms budget")
        else:
            ctx["done"].wait()
        if ctx["error"] is not None:
            raise ctx["error"]
        return ctx["result"]

    # -- solve ---------------------------------------------------------------

    def solve_packing(self, enc, mode: str = "ffd", plan=None, shards: int = 0,
                      device: torch.device | str = "cuda"):
        """`pack.solve_packing` through the ladder. `device` is the
        device the device and sharded rungs run on; it is resolved by
        the caller (`solver.resolve_device`), never replaced here."""
        names = self._rungs(shards)
        return self._ladder(names, enc, mode, plan, shards, device,
                            served=_served_list())

    def _ladder(self, names: Sequence[str], enc, mode, plan, shards, device,
                served: Optional[list] = None, primary: Optional[str] = None):
        deadline = _env_ms("KARPENTER_SOLVE_DEADLINE_MS")
        compile_budget = _env_ms("KARPENTER_COMPILE_DEADLINE_MS")
        hedge_delay = _env_ms("KARPENTER_SOLVE_HEDGE_MS")
        t_end = time.monotonic() + deadline if deadline else None
        # `primary` survives ladder truncation: a tail ladder resumed
        # after an asynchronous fetch failure still reports host as
        # degraded relative to the original first rung
        primary = primary or names[0]

        hedge: Optional[dict] = None
        timer: Optional[threading.Timer] = None
        if hedge_delay and primary != "host" and len(names) > 1:
            hedge = {"fired": threading.Event(), "done": threading.Event(),
                     "result": None, "cancel": False}

            def hedge_run():
                if hedge["cancel"]:
                    return
                hedge["fired"].set()
                SOLVER_HEDGE.inc({"outcome": "fired"})
                try:
                    hedge["result"] = host_pack_result(enc, mode)
                except Exception:
                    log.exception("hedged host solve failed")
                finally:
                    hedge["done"].set()

            timer = threading.Timer(hedge_delay, hedge_run)
            timer.daemon = True
            timer.start()

        try:
            for name in names:
                if name == "host":
                    break
                br = self.breaker(name)
                if not br.allow():
                    _ladder_count(name, "skipped_open")
                    tracing.add_event("rung_skipped", rung=name,
                                      reason="breaker_open")
                    continue
                budget = None
                if t_end is not None:
                    budget = t_end - time.monotonic()
                    if budget <= 0:
                        # out of wall budget: the half-open admission
                        # above was consumed without a verdict; leave
                        # the breaker as-is and degrade straight down
                        SOLVER_DEADLINE_EXCEEDED.inc({"phase": "total"})
                        _ladder_count(name, "skipped_deadline")
                        tracing.add_event("rung_skipped", rung=name,
                                          reason="deadline")
                        break
                with tracing.span("solver.rung", rung=name) as rsp:
                    try:
                        fn = self._rung_fn(name, enc, mode, plan, shards, device)
                        result = self._attempt(
                            name, fn, budget, compile_budget, device)
                    except Exception as err:
                        reason = classify(err)
                        _ladder_count(name, reason)
                        rsp.annotate(outcome=reason)
                        if not may_degrade(err, device):
                            raise
                        br.record_failure(reason)
                        log.warning(
                            "solver rung %s failed (%s: %s); degrading",
                            name, reason, err)
                        continue
                    rsp.annotate(outcome="ok")
                # the device the close gate's canary launches on
                _tlocal.device = device
                br.record_success()
                _ladder_count(name, "ok")
                _note_rung(served, name, degraded=(name != primary))
                if hedge is not None and hedge["fired"].is_set():
                    SOLVER_HEDGE.inc({"outcome": "loss"})
                return result

            # every device rung failed, was skipped, or the deadline
            # ran out: the host oracle answers, via the hedge if it
            # already fired
            if hedge is not None:
                timer.cancel()
                if hedge["fired"].is_set():
                    hedge["done"].wait()
                    if hedge["result"] is not None:
                        SOLVER_HEDGE.inc({"outcome": "win"})
                        _ladder_count("host", "ok")
                        tracing.add_event("hedge_win", rung="host")
                        _note_rung(served, "host",
                                   degraded=(primary != "host"))
                        return hedge["result"]
            with tracing.span("solver.rung", rung="host") as rsp:
                result = host_pack_result(enc, mode)
                rsp.annotate(outcome="ok")
            _ladder_count("host", "ok")
            _note_rung(served, "host", degraded=(primary != "host"))
            return result
        finally:
            if timer is not None:
                timer.cancel()
            if hedge is not None:
                hedge["cancel"] = True


    def solve_packing_async(self, enc, mode: str = "ffd", plan=None,
                            shards: int = 0,
                            device: torch.device | str = "cuda"):
        """Asynchronous `solve_packing`: returns an object whose
        `result()` is the PackResult. On the healthy path (the first
        rung a local device rung with a closed breaker, no deadline and
        no hedge) the kernels are dispatched here, on the caller's
        stream, and only the fetch is guarded. Anything else (deadlines,
        the hedge, an open breaker) runs the whole ladder on an executor
        worker, launching on the caller's stream; the caller overlaps
        host work with it all the same."""
        names = self._rungs(shards)
        served = _served_list()  # the caller thread's report sink
        deadline_mode = (
            _env_ms("KARPENTER_SOLVE_DEADLINE_MS")
            or _env_ms("KARPENTER_COMPILE_DEADLINE_MS")
            or _env_ms("KARPENTER_SOLVE_HEDGE_MS")
        )
        first = names[0]
        if not deadline_mode and first in ("device", "sharded"):
            br = self.breaker(first)
            tail = names[1:]

            def rest():
                return self._ladder(tail, enc, mode, plan, shards, device,
                                    served=served, primary=first)

            if br.allow():
                from karpenter_tpu_torch.solver import pack

                eff = (
                    self._effective_shards(shards)
                    if first == "sharded"
                    else (1 if self._effective_shards(shards) > 1 else shards)
                )
                try:
                    pending = pack.solve_packing_async(
                        enc, mode=mode, plan=plan, device=device, shards=eff)
                except Exception as err:
                    reason = classify(err)
                    _ladder_count(first, reason)
                    if not may_degrade(err, device):
                        raise
                    br.record_failure(reason)
                    log.warning(
                        "solver rung %s failed at dispatch (%s: %s); "
                        "degrading", first, reason, err)
                    return _LazyPending(rest)
                return _GuardedPending(self, first, pending, device, rest)
            _ladder_count(first, "skipped_open")
            names = tail
            if names == ["host"]:
                return _LazyPending(rest)
        stream = caller_stream(device)

        def on_worker():
            with on_stream(stream):
                return self._ladder(names, enc, mode, plan, shards, device,
                                    served=served, primary=first)

        return self._get_executor().submit(on_worker)

    def _get_executor(self):
        with self._executor_lock:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor

                # the cost race's concurrent arms plus sibling solves
                self._executor = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="solver-resilient")
            return self._executor


# -- process-wide instance ----------------------------------------------------

_shared: Optional[ResilientSolver] = None
_shared_lock = threading.Lock()


def shared() -> ResilientSolver:
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = ResilientSolver()
    return _shared


def reset() -> None:
    """Tests: drop breaker state and thread-local degradation notes."""
    global _shared
    with _shared_lock:
        _shared = None
    if getattr(_tlocal, "served", None):
        _tlocal.served.clear()
