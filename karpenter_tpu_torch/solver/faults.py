"""Deterministic, spec-driven fault injector for the solver stack.

Copy of `karpenter_tpu/solver/faults.py`, whole: every kind and site
name (the kube and cloud sites too, so one spec parses the same in both
packages) and the crc32-seeded admission, so a spec and seed replay
byte for byte in both. This package instruments the solver sites
(`solve`, `compile`, `execute` in `pack._run_pack`, `probe` in the
consolidation chunk dispatch); the other sites come with the modules
that fire them.

The resilience layer (solver/resilience.py) only earns trust if its
failure paths can be driven on demand and REPLAYED exactly: a chaos
test that sometimes loses the device on the 3rd solve and sometimes on
the 4th proves nothing. This injector is therefore sequence-, not
time-based: every instrumented call site ("solve", "compile",
"execute", "probe", "warm", "rpc", "rpc_server") keeps a monotonically
increasing per-site counter, and a rule fires on exact occurrence
numbers of that counter. Two runs of the same workload under the same
spec produce byte-identical fault sequences (see `snapshot_log`).

Spec grammar (KARPENTER_FAULTS, comma-separated entries):

    entry  = kind [ "@" site ] [ ":" occ ] [ "=" param ] [ "#" seed ]
    kind   = device_lost | rpc_drop | compile_delay | exec_delay
           | kube_conflict | kube_throttle | kube_watch_drop
           | kube_stale_list | kube_write_partial | operator_crash
           | spot_interruption | cache_poison | demand_surge
    occ    = "*" | N | N "+" | N "-" M        (1-based, per site)
    param  = duration                         (delay / retry-after kinds)
           | rate                             (spot_interruption: 0 < r <= 1)
           | count                            (demand_surge: pods per burst)
    seed   = per-entry replay seed for rate-based admission and surge
             shapes; composed schedules (the scenario flywheel) layer
             independently-seeded storms into ONE spec this way.
             Entries without a "#seed" fall back to the injector-wide
             KARPENTER_FAULT_SEED.

Examples:
    device_lost@solve:3        third device solve raises DeviceLostError
    rpc_drop@probe:*           every batched-probe dispatch drops
    compile_delay=5s           every kernel dispatch sleeps 5s first
    rpc_drop@rpc:2-4           RPCs 2..4 drop, then the service heals
    kube_conflict@kube_write:2-4   writes 2..4 answer 409
    kube_throttle=250ms        every kube write 429s, Retry-After 250ms
    operator_crash@crash_bind:2    die just before the 2nd pod binding
    cache_poison@incremental:2     corrupt a retained capacity row at the
                                   2nd incremental live tick — the oracle
                                   audit must catch it and degrade to the
                                   full-solve decision
    spot_interruption@cloud_interrupt:3      3rd interruption check reclaims
    spot_interruption@cloud_interrupt:*=0.05 each check reclaims w.p. 5%,
                                             decided by a seeded hash of the
                                             check's sequence number — the
                                             deterministic stand-in for a
                                             5%/hr interruption regime when
                                             the provider polls hourly.
                                             KARPENTER_FAULT_SEED picks the
                                             schedule; same seed + same spec
                                             replay byte-identically.
    spot_interruption@cloud_interrupt:*=0.1#storm-a
                                             same, but the schedule is drawn
                                             from THIS entry's own seed — a
                                             composed spec can carry several
                                             independently-seeded storms
                                             without them aliasing each other
    demand_surge@provision_intake:2=500      the 2nd live provisioning intake
                                             absorbs a seeded burst of 500
                                             pending pods (mixed low/high
                                             PriorityClass values, shapes
                                             hashed from seed+occurrence) —
                                             the overload storm priority
                                             admission must degrade through

Default sites per kind: device_lost -> solve, rpc_drop -> rpc,
compile_delay -> compile, exec_delay -> execute, kube faults -> their
natural verb site, operator_crash -> crash_tick. Error kinds raise
their exception at the site; delay kinds sleep there (inflating the
phase the watchdog budgets). Instrumented sites:

    solve       pack._run_pack, once per kernel attempt
    compile     pack._run_pack, after staging, just before the kernel
                launch (which loads or builds the kernel libraries)
    execute     pack._run_pack, just before the one device-to-host copy
    probe       consolidation_batch chunk dispatch (batched ladder)
    warm        warm_pool per-bucket AOT compile
    rpc         service client, before sending the RPC
    rpc_server  service server, inside the Solve handler

Cloud sites (hooked into the kwok/fake providers):

    incremental      one incremental live tick of the provisioner's
                     retained-state scheduler (provisioning/
                     incremental_tick.py); a firing cache_poison rule
                     raises CachePoisonError, which the tick CONSUMES —
                     one retained capacity row is corrupted
                     deterministically (the first fleet key in sorted
                     order gains phantom capacity), so the oracle audit
                     has a real stale-cache divergence to catch

    provision_intake one live provisioning intake of the provisioner
                     (Provisioner.schedule, the non-scripted path); a
                     firing demand_surge rule raises DemandSurgeError,
                     which the provisioner CONSUMES — a deterministic
                     burst of pending pods (names/shapes/priorities
                     hashed from the fault seed and the site sequence
                     number) is created in the kube store and joins the
                     round's solve, modeling a workload controller
                     scaling out mid-tick

    cloud_interrupt  one interruption check of one live spot instance
                     (providers iterate spot instances in sorted
                     provider-id order, so occurrence numbers map to
                     instances deterministically); a firing
                     spot_interruption rule raises SpotInterruptionError,
                     which the provider CONSUMES — the instance gets an
                     interruption notice, exactly like a cloud's
                     rebalance/termination warning

Kube sites (hooked into HTTPTransport.request/watch_events and
InMemoryApiServer — the transport maps the raised fault to the HTTP
status a real API server would answer; see kube/real.py):

    kube_read   GET of a single object
    kube_list   collection GET (LIST)
    kube_write  POST/PUT/DELETE incl. the eviction/binding subresources
    kube_watch  one watch_events() drain (drop -> 410 Gone -> relist)

Operator crash points (Operator.step and the controllers it drives;
`operator_crash` raises OperatorCrashError there — the restart-chaos
harness treats it as process death and boots a fresh operator against
the surviving API server):

    crash_tick                 tick start, right after the informer pump
    crash_claims               solver decided, before NodeClaims are written
    crash_provision            claims written, before the binding plan is queued
    crash_bind                 before the Nth pod binding of the tick
    crash_launch               provider launch succeeded, before the claim
                               records its provider id (the double-launch window)
    crash_disruption           disruption command computed, before it starts
    crash_disruption_started   command started (taints + replacements),
                               before its binding plan is queued
    crash_incr_solve           incremental tick drained its dirty sets,
                               before the residual solve runs
    crash_incr_commit          incremental tick solved, before its plans
                               are handed back for NodeClaim writes
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Optional, Sequence

log = logging.getLogger("karpenter.solver.faults")

ENV_SPEC = "KARPENTER_FAULTS"
ENV_SEED = "KARPENTER_FAULT_SEED"

CRASH_SITES = (
    "crash_tick", "crash_claims", "crash_provision", "crash_bind",
    "crash_launch", "crash_disruption", "crash_disruption_started",
    "crash_incr_solve", "crash_incr_commit",
)

SITES = (
    "solve", "compile", "execute", "probe", "warm", "rpc", "rpc_server",
    "kube_read", "kube_list", "kube_write", "kube_watch",
    "cloud_interrupt", "incremental", "provision_intake",
) + CRASH_SITES

_DEFAULT_SITE = {
    "device_lost": "solve",
    "rpc_drop": "rpc",
    "compile_delay": "compile",
    "exec_delay": "execute",
    "kube_conflict": "kube_write",
    "kube_throttle": "kube_write",
    "kube_watch_drop": "kube_watch",
    "kube_stale_list": "kube_list",
    "kube_write_partial": "kube_write",
    "operator_crash": "crash_tick",
    "spot_interruption": "cloud_interrupt",
    "cache_poison": "incremental",
    "demand_surge": "provision_intake",
}

_ERROR_KINDS = (
    "device_lost", "rpc_drop", "kube_conflict", "kube_throttle",
    "kube_watch_drop", "kube_stale_list", "kube_write_partial",
    "operator_crash", "spot_interruption", "cache_poison",
    "demand_surge",
)


class FaultError(RuntimeError):
    """Base class for injected faults (classified by resilience)."""


class DeviceLostError(FaultError):
    """Injected stand-in for an XLA runtime / device-lost failure."""


class RpcDropError(FaultError):
    """Injected stand-in for an unreachable solver service."""


class KubeFaultError(FaultError):
    """Base class for kube-API faults: raised at the transport's fault
    site and CONSUMED there — the transport answers the HTTP status the
    fault models, so clients exercise their real status-code paths
    instead of a foreign exception type."""


class KubeConflictError(KubeFaultError):
    """Injected 409: the write raced another actor."""


class KubeThrottleError(KubeFaultError):
    """Injected 429: API-server client-side throttling. `retry_after`
    (the entry's =duration) rides in the Status body the way a real
    apiserver ships details.retryAfterSeconds."""

    def __init__(self, message: str, retry_after: float = 0.0):
        super().__init__(message)
        self.retry_after = retry_after


class WatchDropError(KubeFaultError):
    """Injected watch-stream drop: the transport surfaces 410 Gone so
    the informer must relist."""


class StaleListError(KubeFaultError):
    """Injected stale LIST: the transport re-serves its previous LIST
    response (an etcd follower lagging behind a quorum write)."""


class WritePartialError(KubeFaultError):
    """Injected write-partial: the write LANDS server-side but the
    response is lost (connection cut after commit) — the client sees a
    500 for a mutation that actually happened."""


class OperatorCrashError(FaultError):
    """Injected operator death at a crash point. Never caught inside
    the operator: it must unwind the whole tick, exactly like SIGKILL
    between two writes would."""


class CachePoisonError(FaultError):
    """Injected retained-state corruption. Raised at the incremental
    live tick's `incremental` site and CONSUMED there — the tick
    corrupts one retained capacity row deterministically, modeling the
    stale-cache failure the oracle audit exists to catch."""


class DemandSurgeError(FaultError):
    """Injected demand surge: a workload controller scaled out between
    two ticks. Raised at the provisioner's `provision_intake` site and
    CONSUMED there — a seeded burst of `count` pending pods (mixed
    low/high PriorityClass values, deterministic names
    `surge-<seq>-<i>`) is created and joins the round's solve. `seq`
    and `seed` make the burst a pure function of the schedule, so two
    runs of the same spec inject byte-identical demand."""

    def __init__(self, message: str, count: int = 0, seq: int = 0,
                 seed: str = "0"):
        super().__init__(message)
        self.count = count
        self.seq = seq
        self.seed = seed


class SpotInterruptionError(FaultError):
    """Injected spot-capacity interruption notice. Raised at the
    provider's `cloud_interrupt` check for one instance and CONSUMED
    there — the provider marks the instance interrupted so the
    interruption controller sees the notice through its normal poll,
    exactly like a cloud's rebalance/termination warning."""


@dataclass(frozen=True)
class FaultRule:
    kind: str
    site: str
    lo: int            # 1-based first occurrence; 0 == every occurrence
    hi: int            # last occurrence inclusive; -1 == open-ended
    delay: float = 0.0
    rate: float = 1.0  # <1.0: fire w.p. rate, seeded-hash-decided per seq
    count: int = 0     # demand_surge: pods per injected burst
    # per-entry replay seed (the "#seed" suffix); None falls back to
    # the injector-wide KARPENTER_FAULT_SEED — composed specs carry
    # one independently-seeded schedule per layer this way
    seed: Optional[str] = None

    def matches(self, seq: int) -> bool:
        if self.lo == 0:
            return True
        if seq < self.lo:
            return False
        return self.hi < 0 or seq <= self.hi


def _parse_duration(text: str) -> float:
    """Bare seconds, or a `ms`/`s`/`m`/`h` suffix. The `ms` check must
    precede `m` and `s` (both are suffixes of it)."""
    text = text.strip().lower()
    if text.endswith("ms"):
        return float(text[:-2]) / 1000.0
    if text.endswith("h"):
        return float(text[:-1]) * 3600.0
    if text.endswith("m"):
        return float(text[:-1]) * 60.0
    if text.endswith("s"):
        return float(text[:-1])
    return float(text)


def _hash01(seed: str, site: str, seq: int) -> float:
    """Deterministic uniform-ish [0, 1) from (seed, site, seq) — the
    replay clock for rate-based rules. Pure function of the per-site
    sequence number, so two runs of the same workload under the same
    seed reclaim the same occurrences."""
    return (zlib.crc32(f"{seed}:{site}:{seq}".encode()) & 0xFFFFFFFF) / 2.0**32


def parse(spec: str, rejected: Optional[list] = None) -> list[FaultRule]:
    """Parse a KARPENTER_FAULTS spec. Malformed entries are dropped
    with a warning — chaos knobs must never take the operator down —
    but never silently: each drop increments
    karpenter_faults_rejected_total and lands in `rejected` (surfaced
    through readyz() so a typo'd chaos knob is visible)."""
    rules: list[FaultRule] = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        try:
            # the "#seed" suffix splits off FIRST: params (durations,
            # rates, counts) never contain "#", and the seed must not
            # leak into the =param float parse
            entry, hash_sep, rule_seed = raw.partition("#")
            if hash_sep:
                rule_seed = rule_seed.strip()
                if not rule_seed or any(
                    c in rule_seed for c in "@:=#"
                ) or any(c.isspace() for c in rule_seed):
                    raise ValueError(f"bad per-entry seed {rule_seed!r}")
            else:
                rule_seed = None
            body, _, param = entry.partition("=")
            head, _, occ = body.partition(":")
            kind, _, site = head.partition("@")
            kind = kind.strip()
            site = site.strip() or _DEFAULT_SITE.get(kind, "solve")
            if kind not in _DEFAULT_SITE:
                raise ValueError(f"unknown kind {kind!r}")
            if site not in SITES:
                raise ValueError(f"unknown site {site!r}")
            occ = occ.strip()
            if not occ or occ == "*":
                lo, hi = 0, -1
            elif occ.endswith("+"):
                lo, hi = int(occ[:-1]), -1
            elif "-" in occ:
                a, b = occ.split("-", 1)
                lo, hi = int(a), int(b)
            else:
                lo = hi = int(occ)
            if (occ and occ != "*" and lo < 1) or (hi >= 0 and hi < lo):
                raise ValueError(f"bad occurrence range {occ!r}")
            rate = 1.0
            count = 0
            if kind == "spot_interruption":
                # the =param is a probability per occurrence, not a
                # duration (spec grammar: spot_interruption@...:occ=rate)
                rate = float(param) if param else 1.0
                if not 0.0 < rate <= 1.0:
                    raise ValueError(f"bad interruption rate {param!r}")
                delay = 0.0
            elif kind == "demand_surge":
                # the =param is the burst size in pods
                count = int(param) if param else 16
                if count < 1:
                    raise ValueError(f"bad surge count {param!r}")
                delay = 0.0
            else:
                delay = _parse_duration(param) if param else 0.0
            if kind.endswith("_delay") and delay <= 0.0:
                raise ValueError("delay kind needs a =duration")
            rules.append(FaultRule(kind, site, lo, hi, delay, rate,
                                   count, rule_seed))
        except (ValueError, IndexError) as err:
            log.warning("ignoring malformed fault entry %r: %s", raw, err)
            if rejected is not None:
                rejected.append(raw)
            from karpenter_tpu_torch.metrics.store import FAULTS_REJECTED

            FAULTS_REJECTED.inc()
    return rules


class FaultInjector:
    """Applies parsed rules against per-site sequence counters.

    Thread-safe; the counters (not wall time) are the replay clock, so
    concurrent call sites interleave but each site's own sequence —
    and therefore which of its calls fault — is deterministic."""

    def __init__(self, rules: Sequence[FaultRule], sleep=time.sleep,
                 seed: str = "0", rejected: Optional[list] = None):
        self.rules = list(rules)
        self._sleep = sleep
        self.seed = seed
        # malformed spec entries dropped at parse time (readyz surfaces
        # them so a typo'd chaos knob is visible, not silent)
        self.rejected: list[str] = list(rejected or [])
        self._seq: dict[str, int] = {}
        self._lock = threading.Lock()
        # (site, seq, kind, trace_id): the trace id of the tick the
        # fault fired in — the provenance column joining a replay log
        # entry to its /debug/traces span tree. snapshot_log() strips
        # it (trace ids are per-run; the replay-identity artifact must
        # stay byte-identical across runs of the same schedule).
        self.log: list[tuple[str, int, str, str]] = []

    def _admits(self, rule: FaultRule, site: str, seq: int) -> bool:
        if not rule.matches(seq):
            return False
        if rule.rate >= 1.0:
            return True
        # a rule carrying its own "#seed" replays from that seed; the
        # injector-wide seed covers the rest — two rate rules in one
        # composed spec draw from independent schedules
        seed = rule.seed if rule.seed is not None else self.seed
        return _hash01(seed, site, seq) < rule.rate

    def fire(self, site: str) -> None:
        """Advance `site`'s sequence counter and apply matching rules:
        delays sleep in the caller, then the first error kind raises."""
        from karpenter_tpu_torch import tracing

        trace_id = tracing.current_trace_id()
        with self._lock:
            seq = self._seq.get(site, 0) + 1
            self._seq[site] = seq
            hits = [r for r in self.rules
                    if r.site == site and self._admits(r, site, seq)]
            for rule in hits:
                self.log.append((site, seq, rule.kind, trace_id))
        if not hits:
            return
        from karpenter_tpu_torch.metrics.store import SOLVER_FAULTS_INJECTED

        error: Optional[FaultError] = None
        for rule in hits:
            # fault attribution on the span tree: the innermost open
            # span of the tick carries every fault fired under it
            tracing.add_event("fault", kind=rule.kind, site=site, seq=seq)
            SOLVER_FAULTS_INJECTED.inc({"site": site, "kind": rule.kind})
            if rule.kind.endswith("_delay"):
                log.warning("fault injected: %s@%s:%d sleeping %.3fs",
                            rule.kind, site, seq, rule.delay)
                self._sleep(rule.delay)
            elif error is None:
                error = self._make_error(rule, site, seq)
        if error is not None:
            log.warning("fault injected: %s", error)
            raise error

    def _make_error(self, rule: FaultRule, site: str, seq: int) -> FaultError:
        message = f"injected {rule.kind}@{site}:{seq}"
        if rule.kind == "kube_throttle":
            return KubeThrottleError(message, retry_after=rule.delay)
        if rule.kind == "demand_surge":
            return DemandSurgeError(
                message, count=rule.count, seq=seq,
                seed=rule.seed if rule.seed is not None else self.seed,
            )
        cls = {
            "device_lost": DeviceLostError,
            "rpc_drop": RpcDropError,
            "kube_conflict": KubeConflictError,
            "kube_watch_drop": WatchDropError,
            "kube_stale_list": StaleListError,
            "kube_write_partial": WritePartialError,
            "operator_crash": OperatorCrashError,
            "spot_interruption": SpotInterruptionError,
            "cache_poison": CachePoisonError,
        }.get(rule.kind, FaultError)
        return cls(message)

    def snapshot_log(self) -> list[tuple[str, int, str]]:
        """Copy of the fired-fault log: (site, per-site seq, kind) in
        firing order — the replay-identity artifact chaos tests diff.
        The per-run trace-id column is deliberately stripped here (two
        replays of one schedule must compare byte-identical); use
        snapshot_log_traced() for the provenance view."""
        with self._lock:
            return [(site, seq, kind) for site, seq, kind, _ in self.log]

    def snapshot_log_traced(self) -> list[tuple[str, int, str, str]]:
        """The provenance view of the replay log: (site, seq, kind,
        trace_id) — each fired fault joined to the tick trace it fired
        in ("" outside any trace), resolvable via /debug/traces."""
        with self._lock:
            return list(self.log)


# -- env-driven singleton -----------------------------------------------------

_active: Optional[FaultInjector] = None
_active_spec: Optional[str] = None
_active_lock = threading.Lock()


def get() -> Optional[FaultInjector]:
    """The active injector per KARPENTER_FAULTS (+ the seed), or None.
    A changed spec or seed builds a fresh injector with zeroed
    counters, so tests that re-point the env replay from occurrence
    1."""
    spec = os.environ.get(ENV_SPEC, "")
    global _active, _active_spec
    if not spec:
        if _active is not None:
            with _active_lock:
                _active, _active_spec = None, None
        return None
    seed = os.environ.get(ENV_SEED, "0")
    key = f"{seed}|{spec}"
    if key != _active_spec:
        with _active_lock:
            if key != _active_spec:
                rejected: list[str] = []
                _active = FaultInjector(
                    parse(spec, rejected=rejected), seed=seed,
                    rejected=rejected,
                )
                _active_spec = key
    return _active


def rejected_specs() -> list[str]:
    """Malformed entries the ACTIVE spec dropped at parse time — the
    operator surfaces these through readyz() so a typo'd chaos knob is
    observable without grepping logs."""
    injector = get()
    return list(injector.rejected) if injector is not None else []


def reset() -> None:
    """Zero the active injector's counters (fresh replay, same spec)."""
    global _active, _active_spec
    with _active_lock:
        _active, _active_spec = None, None


def snapshot_active():
    """Opaque (injector, key) state for scoped spec overrides: callers
    that temporarily re-point KARPENTER_FAULTS (bench arms) save the
    ambient injector here and `restore_active` it afterwards, so an
    externally-set schedule keeps its occurrence counters and replay
    log across the override instead of being reset to occurrence 1."""
    with _active_lock:
        return _active, _active_spec


def restore_active(state) -> None:
    """Reinstate a `snapshot_active` state (see there)."""
    global _active, _active_spec
    with _active_lock:
        _active, _active_spec = state


def fire(site: str) -> None:
    """Module-level hook the instrumented sites call. No-op (one dict
    lookup) when KARPENTER_FAULTS is unset."""
    injector = get()
    if injector is not None:
        injector.fire(site)
