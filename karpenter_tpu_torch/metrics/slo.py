"""SLO burn-rate engine over signals the system already emits.

Copy of `karpenter_tpu/metrics/slo.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

"Priority Matters" frames pod-packing quality as an SLO over sustained
operation, not a per-tick verdict — the question a fleet gets paged on
is "are we meeting the objective over time", which no per-tick metric
answers. This engine evaluates declarative SLIs per operator tick and
rolls them into multi-window burn rates:

- an **SLI** maps the tick's signal dict to (good_units, total_units)
  — e.g. tick latency under budget, zero unschedulable pods, zero
  oracle divergences, gap_vs_lp under the optimality target, zero
  priority sheds;
- the **burn rate** over a window of ticks is
  bad_fraction / (1 - objective): 1.0 means the error budget is being
  consumed exactly at the sustainable rate, N means N times too fast;
- an alert fires only when BOTH the short and the long window burn
  past the threshold (the multiwindow rule: the short window catches
  the onset, the long window suppresses blips), and the alert counter
  increments on state TRANSITIONS, so replays count identically.

Determinism contract: windows are measured in TICKS, never wall-clock;
the engine's only time source is the injectable `clock` (the tick-wall
SLI), and the digest carries no timestamps — a chaos suite replaying a
byte-identical fault schedule under the same injected clock asserts
byte-identical verdicts and burn windows (tests/test_slo.py).

Signals come from three places: the operator's own tick accounting
(tick wall, unschedulable-pod gauge, divergence/shed counter deltas),
and `note()` — a process-global buffer components deeper in the stack
(the solver's gap_vs_lp) drop values into mid-tick; the operator
drains it into the tick's signal dict, so the engine itself stays a
pure function of its inputs.

Exported: `karpenter_slo_burn_rate{slo,window}`,
`karpenter_slo_ok{slo}`, `karpenter_slo_error_budget_remaining{slo}`,
`karpenter_slo_alerts_total{slo,severity}`; `/debug/slo` serves
`report()` and `readyz()["slo"]` the `digest()`.

Knobs (all read per tick, so chaos suites can flip them live):

| env | default | effect |
| --- | --- | --- |
| KARPENTER_SLO | 1 | 0 disables evaluation entirely |
| KARPENTER_SLO_WINDOW_SHORT | 12 | short burn window, in ticks |
| KARPENTER_SLO_WINDOW_LONG | 72 | long burn window (and history), in ticks |
| KARPENTER_SLO_TICK_BUDGET_MS | 1000 | tick-latency SLI budget |
| KARPENTER_SLO_GAP_MAX | 0.05 | optimality SLI: max acceptable gap_vs_lp |
| KARPENTER_SLO_BIND_P99_S | 60 | pod_to_bind_latency SLI: p99 arrival->bind budget |
| KARPENTER_SLO_WARN_BURN | 2.0 | warn when both windows burn past this |
| KARPENTER_SLO_PAGE_BURN | 10.0 | page when both windows burn past this |
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

_SEVERITIES = ("ok", "warn", "page")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def enabled() -> bool:
    return os.environ.get("KARPENTER_SLO", "1").strip().lower() not in (
        "0", "off", "false", "no",
    )


@dataclass(frozen=True)
class SLI:
    """One declarative service-level indicator.

    `evaluate(signals)` returns (good_units, total_units) for the tick,
    or None when the tick carries no data for this SLI (e.g. no cost
    solve ran, so there is no gap) — data-free ticks don't consume or
    replenish the error budget."""

    name: str
    description: str
    objective: float                 # target good fraction (0, 1)
    evaluate: Callable[[dict], Optional[tuple[float, float]]]


def _tick_latency(signals: dict) -> Optional[tuple[float, float]]:
    wall = signals.get("tick_wall_s")
    if wall is None:
        return None
    budget = _env_float("KARPENTER_SLO_TICK_BUDGET_MS", 1000.0) / 1000.0
    return (1.0, 1.0) if wall <= budget else (0.0, 1.0)


def _schedulability(signals: dict) -> Optional[tuple[float, float]]:
    unsched = signals.get("unschedulable_pods")
    if unsched is None:
        return None
    return (1.0, 1.0) if unsched <= 0 else (0.0, 1.0)


def _solve_integrity(signals: dict) -> Optional[tuple[float, float]]:
    div = signals.get("oracle_divergences")
    if div is None:
        return None
    return (1.0, 1.0) if div <= 0 else (0.0, 1.0)


def _admission(signals: dict) -> Optional[tuple[float, float]]:
    shed = signals.get("priority_shed")
    if shed is None:
        return None
    return (1.0, 1.0) if shed <= 0 else (0.0, 1.0)


def _bind_latency(signals: dict) -> Optional[tuple[float, float]]:
    # p99 arrival->bind wall: with the reactive plane on, measured
    # from the WATCH-STREAM arrival stamp (the pod's first sighting),
    # so the SLI covers debounce + micro-solve + bind — the headline
    # number event-driven placement exists to shrink. Absent when the
    # tick bound nothing (data-free, not "good"). The tick's signal
    # dict also carries pod_to_bind_p50_s for dashboards/bench; the
    # objective gates on the tail
    p99 = signals.get("pod_to_bind_p99_s")
    if p99 is None:
        return None
    budget = _env_float("KARPENTER_SLO_BIND_P99_S", 60.0)
    return (1.0, 1.0) if p99 <= budget else (0.0, 1.0)


def _optimality(signals: dict) -> Optional[tuple[float, float]]:
    gap = signals.get("gap_vs_lp")
    if gap is None:
        return None
    return (
        (1.0, 1.0)
        if gap <= _env_float("KARPENTER_SLO_GAP_MAX", 0.05)
        else (0.0, 1.0)
    )


# pod_to_bind_latency leads: with reactive placement the
# arrival->bind tail is THE user-facing objective the control plane is
# shaped around — everything else guards how it is achieved
DEFAULT_SLIS: tuple[SLI, ...] = (
    SLI("pod_to_bind_latency",
        "p99 pod arrival->bind wall under KARPENTER_SLO_BIND_P99_S",
        0.99, _bind_latency),
    SLI("tick_latency",
        "operator tick wall under KARPENTER_SLO_TICK_BUDGET_MS",
        0.99, _tick_latency),
    SLI("schedulability",
        "no pod left unschedulable by the tick's solve",
        0.99, _schedulability),
    SLI("solve_integrity",
        "zero incremental-vs-full oracle divergences",
        0.999, _solve_integrity),
    SLI("admission",
        "zero pods shed by priority admission",
        0.95, _admission),
    SLI("optimality",
        "gap_vs_lp under KARPENTER_SLO_GAP_MAX on cost solves",
        0.90, _optimality),
)


# -- mid-tick signal buffer ---------------------------------------------------

_note_lock = threading.Lock()
_noted: dict = {}


def note(name: str, value: float) -> None:
    """Drop a signal for the CURRENT tick from anywhere in the stack
    (the solver notes gap_vs_lp here after a cost solve). The operator
    drains the buffer into observe_tick's signal dict; repeated notes
    within one tick keep the last value."""
    with _note_lock:
        _noted[name] = value


def take_noted() -> dict:
    with _note_lock:
        out = dict(_noted)
        _noted.clear()
        return out


# -- the engine ---------------------------------------------------------------

class SLOEngine:
    """Rolling tick-count SLO evaluation. One instance per operator;
    `observe_tick(signals)` is the only mutator and the whole state is
    a pure function of the observed signal sequence."""

    def __init__(self, slis: Optional[tuple[SLI, ...]] = None,
                 clock=None):
        self.slis = tuple(slis) if slis is not None else DEFAULT_SLIS
        # injectable time source for the tick-wall signal (the chaos
        # determinism contract: same clock + same signals => same
        # verdicts). perf_counter by default.
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self.ticks = 0
        long_w = self.window_long()
        self._history: dict[str, deque] = {
            s.name: deque(maxlen=long_w) for s in self.slis
        }
        self._state: dict[str, str] = {s.name: "ok" for s in self.slis}
        self._alerts: dict[str, dict[str, int]] = {
            s.name: {"warn": 0, "page": 0} for s in self.slis
        }
        # whole-run good/total units per SLI: unlike the
        # window deques these never roll off, so a long soak can
        # convert them into burn-minutes — total error budget consumed
        # over the trace, not just over the last long window
        self._cumulative: dict[str, list[float]] = {
            s.name: [0.0, 0.0] for s in self.slis
        }
        self.unscheduled_pod_ticks = 0.0

    @staticmethod
    def window_short() -> int:
        return max(1, _env_int("KARPENTER_SLO_WINDOW_SHORT", 12))

    @staticmethod
    def window_long() -> int:
        return max(2, _env_int("KARPENTER_SLO_WINDOW_LONG", 72))

    def _burn(self, name: str, objective: float, window: int) -> float:
        """bad_fraction / error_budget over the last `window` data
        ticks. 0.0 when the window holds no data."""
        entries = list(self._history[name])[-window:]
        total = sum(t for _, t in entries)
        if total <= 0:
            return 0.0
        bad = sum(t - g for g, t in entries)
        budget = max(1.0 - objective, 1e-9)
        return (bad / total) / budget

    def observe_tick(self, signals: dict) -> dict:
        """Evaluate every SLI against this tick's signals, update the
        gauges/alert counters, and return (and remember) the digest."""
        if not enabled():
            digest = {"enabled": False, "ticks": self.ticks}
            with self._lock:
                self._digest = digest
            _remember(digest)
            return digest
        from karpenter_tpu_torch.metrics.store import (
            SLO_ALERTS,
            SLO_BUDGET_REMAINING,
            SLO_BURN_RATE,
            SLO_OK,
        )

        short_w, long_w = self.window_short(), self.window_long()
        warn_at = _env_float("KARPENTER_SLO_WARN_BURN", 2.0)
        page_at = _env_float("KARPENTER_SLO_PAGE_BURN", 10.0)
        verdicts: dict[str, dict] = {}
        with self._lock:
            self.ticks += 1
            unsched = signals.get("unschedulable_pods")
            if unsched:
                self.unscheduled_pod_ticks += float(unsched)
            for sli in self.slis:
                history = self._history[sli.name]
                if history.maxlen != long_w:
                    self._history[sli.name] = history = deque(
                        history, maxlen=long_w
                    )
                try:
                    result = sli.evaluate(signals)
                except Exception:
                    result = None
                if result is not None:
                    good, total = result
                    history.append((float(good), float(total)))
                    cum = self._cumulative[sli.name]
                    cum[0] += float(good)
                    cum[1] += float(total)
                burn_short = self._burn(sli.name, sli.objective, short_w)
                burn_long = self._burn(sli.name, sli.objective, long_w)
                if burn_short >= page_at and burn_long >= page_at:
                    state = "page"
                elif burn_short >= warn_at and burn_long >= warn_at:
                    state = "warn"
                else:
                    state = "ok"
                prev = self._state[sli.name]
                if state != prev and state in ("warn", "page"):
                    self._alerts[sli.name][state] += 1
                    SLO_ALERTS.inc({"slo": sli.name, "severity": state})
                self._state[sli.name] = state
                labels = {"slo": sli.name}
                SLO_BURN_RATE.set(round(burn_short, 6),
                                  {**labels, "window": "short"})
                SLO_BURN_RATE.set(round(burn_long, 6),
                                  {**labels, "window": "long"})
                SLO_OK.set(1.0 if state == "ok" else 0.0, labels)
                SLO_BUDGET_REMAINING.set(
                    round(max(0.0, 1.0 - burn_long), 6), labels
                )
                verdicts[sli.name] = {
                    "state": state,
                    "burn_short": round(burn_short, 6),
                    "burn_long": round(burn_long, 6),
                    "data_ticks": len(history),
                }
            digest = {
                "enabled": True,
                "ticks": self.ticks,
                "windows": {"short": short_w, "long": long_w},
                "unscheduled_pod_ticks": round(
                    self.unscheduled_pod_ticks, 3
                ),
                "verdicts": verdicts,
                "worst": max(
                    (v["state"] for v in verdicts.values()),
                    key=_SEVERITIES.index,
                    default="ok",
                ),
            }
            self._digest = digest
        _remember(digest)
        return digest

    def cumulative(self) -> dict:
        """Whole-run per-SLI units: good/total/bad summed
        over EVERY data tick this engine ever observed — the
        window-free ledger the soak judge turns into burn-minutes
        (bad_units x tick_minutes / error_budget). Deterministic under
        the injected clock like everything else here."""
        with self._lock:
            return {
                name: {
                    "good_units": round(cum[0], 3),
                    "total_units": round(cum[1], 3),
                    "bad_units": round(cum[1] - cum[0], 3),
                }
                for name, cum in sorted(self._cumulative.items())
            }

    def digest(self) -> dict:
        """The readyz()["slo"] block: last observe_tick's digest, or a
        zero-tick placeholder before the first tick."""
        with self._lock:
            return dict(getattr(self, "_digest", None) or {
                "enabled": enabled(),
                "ticks": 0,
                "verdicts": {},
                "worst": "ok",
            })

    def report(self) -> dict:
        """The /debug/slo body: the digest plus per-SLI configuration
        and window contents — everything deterministic, no timestamps."""
        with self._lock:
            slis = {}
            for sli in self.slis:
                entries = list(self._history[sli.name])
                good = sum(g for g, _ in entries)
                total = sum(t for _, t in entries)
                slis[sli.name] = {
                    "description": sli.description,
                    "objective": sli.objective,
                    "data_ticks": len(entries),
                    "good_units": round(good, 3),
                    "total_units": round(total, 3),
                    "good_fraction": (
                        round(good / total, 6) if total > 0 else None
                    ),
                    "alerts": dict(self._alerts[sli.name]),
                    "state": self._state[sli.name],
                }
        out = self.digest()
        out["slis"] = slis
        out["cumulative"] = self.cumulative()
        out["thresholds"] = {
            "warn_burn": _env_float("KARPENTER_SLO_WARN_BURN", 2.0),
            "page_burn": _env_float("KARPENTER_SLO_PAGE_BURN", 10.0),
        }
        return out


# -- process-global last digest (bench's per-arm slo_summary) -----------------

_last_lock = threading.Lock()
_last_digest: Optional[dict] = None


def _remember(digest: dict) -> None:
    global _last_digest
    with _last_lock:
        _last_digest = digest


def last_digest() -> Optional[dict]:
    """Most recent digest ANY engine in the process produced — how
    bench arms that drive a live operator pick up their slo_summary
    (None for arms that never ticked an operator)."""
    with _last_lock:
        return dict(_last_digest) if _last_digest is not None else None


def reset_last_digest() -> None:
    global _last_digest
    with _last_lock:
        _last_digest = None
    with _note_lock:
        _noted.clear()
