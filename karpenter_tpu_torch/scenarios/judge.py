"""The soak judge: observability planes in, one verdict artifact out.

Copy of `karpenter_tpu/scenarios/judge.py`, reading this package's SLI
objectives and explain helpers and setting this package's
`karpenter_soak_verdict`.

No hand-pinned fleet walls here — the judge only asks the planes the
system already maintains, so every future change inherits the soak as
a regression oracle without re-pinning anything:

- **slo** — FAIL when any SLI consumed its whole-trace error budget
  (whole-run burn >= 1.0 over the cumulative good/total ledger, which
  survives operator reboots). burn-minutes per SLI quantify HOW MUCH
  budget went, for bench_compare trend gating.
- **sentinel** — FAIL on any anomaly transition of the soak-scoped
  baselines (virtual tick wall only: a calm trace is flat 0.0s, so
  any movement is injected, never machine jitter).
- **oracle** — FAIL on any incremental-vs-full divergence (audits are
  forced every solve for the soak's duration).
- **explain** — FAIL on verdicts outside the spec's expectation
  envelope (unexplained), or when the observed verdict histogram
  drifts past `max_distance` from the declared shares
  (explain.verdict_distance: shape, never volume).
- **leaks** — FAIL on any no-leak invariant violation at trace end
  (wedged claims, unlaunched claims, cloud/claim/node mismatches,
  stranded unbound pods).

The report is canonical-JSON digestible: `report_digest` is the
sha256 over everything above it, so the replay-identity acceptance —
same spec + seed, twice → byte-identical reports — is one string
compare. `karpenter_soak_verdict{scenario}` mirrors the pass/fail."""

from __future__ import annotations

import hashlib
import json

from karpenter_tpu_torch.scenarios.spec import ScenarioSpec, Schedule


def _judge_slo(spec: ScenarioSpec, obs: dict) -> dict:
    from karpenter_tpu_torch.metrics.slo import DEFAULT_SLIS

    objectives = {s.name: s.objective for s in DEFAULT_SLIS}
    tick_minutes = spec.tick_s / 60.0
    burn = {}
    burn_minutes = {}
    exhausted = []
    for name, cum in sorted(obs["slo"]["cumulative"].items()):
        budget = max(1.0 - objectives.get(name, 0.99), 1e-9)
        total = cum["total_units"]
        bad = cum["bad_units"]
        whole_run = (bad / total) / budget if total > 0 else 0.0
        burn[name] = round(whole_run, 3)
        # error-budget-weighted minutes of badness: one data tick fully
        # bad costs tick_minutes/budget (drain ticks are longer than
        # tick_s, so this is a trace-scale approximation, applied
        # identically to baseline and current)
        burn_minutes[name] = round(bad * tick_minutes / budget, 3)
        if whole_run >= 1.0:
            exhausted.append(name)
    return {
        "pass": not exhausted,
        "budget_exhausted": exhausted,
        "whole_run_burn": burn,
        "burn_minutes": burn_minutes,
        "max_burn": obs["slo"]["max_burn"],
        "alerts": obs["slo"]["alerts"],
    }


def _judge_sentinel(obs: dict) -> dict:
    total = obs["sentinel"]["anomaly_total"]
    return {
        "pass": total == 0,
        "anomaly_total": total,
        "checkpoints": obs["sentinel"]["checkpoints"],
    }


def _judge_oracle(obs: dict) -> dict:
    div = obs["oracle_divergences"]
    return {"pass": div == 0, "divergences": div}


def _judge_explain(spec: ScenarioSpec, obs: dict) -> dict:
    from karpenter_tpu_torch import explain

    env = spec.envelope
    observed = obs["explain"].get("verdicts", {})
    pod_codes = obs["explain"].get("pod_codes", {})
    if env is None:
        return {"pass": True, "enabled": False}
    unexplained = (
        sorted(v for v in observed if v not in env.allowed_verdicts)
        if env.allowed_verdicts else []
    )
    unexplained_codes = (
        sorted(c for c in pod_codes if c not in env.allowed_pod_codes)
        if env.allowed_pod_codes else []
    )
    distance = None
    if env.expected_verdicts:
        distance = explain.verdict_distance(
            observed, dict(env.expected_verdicts)
        )
    drifted = distance is not None and distance > env.max_distance
    return {
        "pass": not unexplained and not unexplained_codes and not drifted,
        "enabled": True,
        "unexplained_verdicts": unexplained,
        "unexplained_pod_codes": unexplained_codes,
        "verdict_histogram_distance": distance,
        "max_distance": env.max_distance,
        "observed_verdicts": dict(sorted(observed.items())),
    }


def _judge_leaks(obs: dict) -> dict:
    leaks = list(obs["leaks"])
    return {"pass": not leaks, "leaks": leaks}


def judge(spec: ScenarioSpec, schedule: Schedule, obs: dict) -> dict:
    """Render the verdict artifact from one soak run's observations
    (the dict soak.run_soak assembles). Sets
    karpenter_soak_verdict{scenario}."""
    from karpenter_tpu_torch.metrics.store import SOAK_VERDICT

    planes = {
        "slo": _judge_slo(spec, obs),
        "sentinel": _judge_sentinel(obs),
        "oracle": _judge_oracle(obs),
        "explain": _judge_explain(spec, obs),
        "leaks": _judge_leaks(obs),
    }
    failures = sorted(
        name for name, plane in planes.items() if not plane["pass"]
    )
    report = {
        "scenario": spec.name,
        "seed": spec.seed,
        "schedule_digest": schedule.digest(),
        "pass": not failures,
        "failures": failures,
        "planes": planes,
        "observations": {
            k: v for k, v in obs.items() if k != "fault_log"
        },
        "fault_log": [list(entry) for entry in obs.get("fault_log", [])],
    }
    report["report_digest"] = hashlib.sha256(
        json.dumps(report, sort_keys=True).encode()
    ).hexdigest()
    SOAK_VERDICT.set(1.0 if report["pass"] else 0.0,
                     {"scenario": spec.name})
    return report
