"""Long-horizon soak harness: replay a composed scenario schedule
against the full reactive Operator under accelerated injected time.

Copy of `karpenter_tpu/scenarios/soak.py` on this package's Operator,
with `device`: every Operator of a run (the first and each rebuilt one
after a crash) solves on it. All the globals it pins, clears and
restores are this package's: the fault injector (its `_sleep` replaced
by the virtual clock's), the environment, the explain ring, the SLO's
last digest and the `SCHEDULER_UNSCHEDULABLE_PODS` series.

Determinism is the whole point, so every time source is pinned:

- the trace clock starts at a fixed epoch (`_NOW0`) and advances by
  `spec.tick_s` per full tick, with micro-solve slots spaced evenly
  between ticks (the reactive-chaos Harness loop shape);
- the operator's SLO engine is rebuilt with a `VirtualClock` before
  the first step, so `tick_wall_s` is 0.0 on a calm trace and inflated
  ONLY by injected delay faults — which themselves advance the virtual
  clock instead of real-sleeping (the injector's `_sleep` is replaced);
- sentinel judging runs on a soak-scoped `Sentinel` instance fed the
  virtual tick wall per completed step (the process singleton keeps
  observing real wall from inside op.step — real machine jitter must
  never flip a soak verdict);
- arrival->bind latencies already ride the injected clock
  (bindqueue._record_latency under the operator-supplied now).

The harness mirrors the chaos suite's crash contract: an injected
`operator_crash` unwinds the tick, the operator reboots with fresh
memory against the surviving API server and cloud, and the dying SLO
engine's cumulative ledger is merged into the run's accumulator so
burn-minutes survive reboots.

At trace end the fault spec is retired (fault-quiet drain), surge pods
are deleted, the clock rides past the GC interval, and a fixed count
of drain ticks converges the fleet before the no-leak sweep — which
REPORTS leaks instead of asserting, so the judge can render them as a
failing plane."""

from __future__ import annotations

import os
from typing import Optional

from karpenter_tpu_torch.scenarios.spec import GIB, ScenarioSpec, Schedule, compose

# fixed trace epoch: every run of every spec starts its injected clock
# here, so absolute timestamps in artifacts are replay-identical too
_NOW0 = 1_600_000_000.0

# the soak's pinned environment: forced oracle audits (every
# incremental solve shadow-checked), open churn gate, instant kube
# retries/relists (virtual time never waits on real backoff), and both
# judged planes explicitly armed
_SOAK_ENV = {
    "KARPENTER_INCR_AUDIT_EVERY": "1",
    "KARPENTER_INCR_CHURN_MAX": "1.0",
    "KARPENTER_KUBE_RETRY_BASE_MS": "1",
    "KARPENTER_KUBE_RELIST_MIN_MS": "0",
    "KARPENTER_SLO": "1",
    "KARPENTER_SENTINEL": "1",
}


def _soak_kube(server):
    """The operator's client, with workload-controller simulation ON:
    the InMemoryApiServer substrate has no ReplicaSet controller
    behind it, so without this an interruption-drained pod dies for
    good and a storm silently depopulates the soak (the
    EvictionQueue's rebirth path — same-name successors — is gated on
    this flag)."""
    from karpenter_tpu_torch.kube.real import RealKubeClient

    client = RealKubeClient(server)
    client.simulates_workload_controllers = True
    return client


class VirtualClock:
    """The soak's injected time source: a callable (the SLOEngine
    clock protocol) whose `sleep` ADVANCES virtual time — installed as
    the fault injector's sleep so `*_delay` faults cost virtual tick
    wall, deterministically, instead of real-sleeping the test."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += max(0.0, float(seconds))


class _SoakRun:
    """One soak attempt's mutable state (split out of run_soak so the
    crash-reboot path stays readable)."""

    def __init__(self, spec: ScenarioSpec, vclock: VirtualClock, device=None):
        from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
        from karpenter_tpu_torch.kube.real import InMemoryApiServer, RealKubeClient
        from karpenter_tpu_torch.metrics.sentinel import Sentinel
        from karpenter_tpu_torch.testing import mk_nodepool

        self.spec = spec
        self.vclock = vclock
        self.device = device
        self.server = InMemoryApiServer()
        kube = _soak_kube(self.server)
        self.cloud = KwokCloudProvider(kube)
        self.user = RealKubeClient(self.server)
        self.op = self._make_operator(kube)
        self.sentinel = Sentinel()
        self.crashes = 0
        self.micro_crashes = 0
        self.micro_steps = 0
        self.ticks = 0
        self.slo_max: dict[str, dict[str, float]] = {}
        self.dead_cumulative: dict[str, dict[str, float]] = {}
        self.dead_alerts: dict[str, dict[str, int]] = {}
        if spec.pool_cpu_limit is not None:
            pool = mk_nodepool("default",
                               limits={"cpu": spec.pool_cpu_limit})
        else:
            pool = mk_nodepool("default")
        pool.spec.disruption.consolidate_after = spec.consolidate_after
        self.user.create(pool)

    def _make_operator(self, kube):
        from karpenter_tpu_torch.metrics.slo import SLOEngine
        from karpenter_tpu_torch.operator.operator import Operator

        op = Operator(kube=kube, cloud_provider=self.cloud, device=self.device)
        # rebuild the engine under the virtual clock BEFORE the first
        # step (the operator's documented determinism seam)
        op.slo = SLOEngine(clock=self.vclock)
        return op

    def _bury_engine(self) -> None:
        """Merge a dying operator's SLO ledger into the run
        accumulator before the reboot discards the engine."""
        report = self.op.slo.report()
        for name, cum in self.op.slo.cumulative().items():
            acc = self.dead_cumulative.setdefault(
                name, {"good_units": 0.0, "total_units": 0.0}
            )
            acc["good_units"] += cum["good_units"]
            acc["total_units"] += cum["total_units"]
        for name, sli in report.get("slis", {}).items():
            acc = self.dead_alerts.setdefault(name, {"warn": 0, "page": 0})
            for sev, n in sli.get("alerts", {}).items():
                acc[sev] = acc.get(sev, 0) + n

    def _restart(self) -> None:
        self._bury_engine()
        kube = _soak_kube(self.server)
        self.cloud.kube = kube
        self.op = self._make_operator(kube)

    def _after_step(self, virtual_wall: float) -> None:
        self.sentinel.observe("tick_wall", virtual_wall)
        digest = self.op.slo.digest()
        for name, v in digest.get("verdicts", {}).items():
            peak = self.slo_max.setdefault(
                name, {"burn_short": 0.0, "burn_long": 0.0}
            )
            peak["burn_short"] = max(peak["burn_short"], v["burn_short"])
            peak["burn_long"] = max(peak["burn_long"], v["burn_long"])

    def step(self, now: float) -> bool:
        """One full tick at trace offset `now`; returns False when the
        operator crashed (and was rebooted)."""
        from karpenter_tpu_torch.solver import faults

        w0 = self.vclock.t
        try:
            self.op.step(now=_NOW0 + now)
        except faults.OperatorCrashError:
            self.crashes += 1
            self._restart()
            return False
        self.ticks += 1
        self._after_step(self.vclock.t - w0)
        return True

    def micro(self, now: float) -> bool:
        from karpenter_tpu_torch.solver import faults

        try:
            self.op.micro_step(now=_NOW0 + now)
        except faults.OperatorCrashError:
            self.crashes += 1
            self.micro_crashes += 1
            self._restart()
            return False
        self.micro_steps += 1
        return True

    def merged_cumulative(self) -> dict:
        """The whole-run per-SLI ledger: the live engine's cumulative
        plus every buried (crashed) engine's."""
        merged: dict[str, dict[str, float]] = {}
        for name, cum in self.op.slo.cumulative().items():
            merged[name] = {
                "good_units": cum["good_units"],
                "total_units": cum["total_units"],
            }
        for name, acc in self.dead_cumulative.items():
            slot = merged.setdefault(
                name, {"good_units": 0.0, "total_units": 0.0}
            )
            slot["good_units"] += acc["good_units"]
            slot["total_units"] += acc["total_units"]
        return {
            name: {
                "good_units": round(v["good_units"], 3),
                "total_units": round(v["total_units"], 3),
                "bad_units": round(
                    v["total_units"] - v["good_units"], 3
                ),
            }
            for name, v in sorted(merged.items())
        }

    def merged_alerts(self) -> dict:
        merged: dict[str, dict[str, int]] = {}
        for name, sli in self.op.slo.report().get("slis", {}).items():
            merged[name] = dict(sli.get("alerts", {}))
        for name, acc in self.dead_alerts.items():
            slot = merged.setdefault(name, {"warn": 0, "page": 0})
            for sev, n in acc.items():
                slot[sev] = slot.get(sev, 0) + n
        return {name: merged[name] for name in sorted(merged)}

    def retire_surge(self) -> int:
        from karpenter_tpu_torch.provisioning.provisioner import SURGE_LABEL

        self.user.deliver()
        retired = 0
        for pod in list(self.user.pods()):
            if SURGE_LABEL in pod.metadata.labels:
                self.user.delete(pod)
                retired += 1
        return retired

    def leak_check(self) -> list[str]:
        """The reactive-chaos fingerprint invariants, REPORTED instead
        of asserted (the judge renders them as the `leaks` plane).
        Messages carry counts and schedule-stable pod names only —
        claim/instance names embed process-global counters and would
        break report byte-identity across back-to-back runs."""
        leaks: list[str] = []
        kube = self.op.kube
        claims = kube.node_claims()
        wedged = sum(
            1 for c in claims if c.metadata.deletion_timestamp is not None
        )
        if wedged:
            leaks.append(f"{wedged} wedged-deleting nodeclaim(s)")
        unlaunched = sum(1 for c in claims if not c.status.provider_id)
        if unlaunched:
            leaks.append(f"{unlaunched} nodeclaim(s) never launched")
        claim_pids = sorted(
            c.status.provider_id for c in claims if c.status.provider_id
        )
        inst_pids = sorted(i.status.provider_id for i in self.cloud.list())
        if inst_pids != claim_pids:
            leaks.append(
                "cloud/claim mismatch: "
                f"{len(inst_pids)} instances vs {len(claim_pids)} claims"
            )
        node_pids = sorted(n.spec.provider_id for n in kube.nodes())
        if node_pids != claim_pids:
            leaks.append(
                "node/claim mismatch: "
                f"{len(node_pids)} nodes vs {len(claim_pids)} claims"
            )
        stranded = sorted(
            p.metadata.name
            for p in kube.pods()
            if p.metadata.deletion_timestamp is None
            and not p.spec.node_name
        )
        if stranded:
            shown = ", ".join(stranded[:8])
            extra = f" (+{len(stranded) - 8} more)" if len(stranded) > 8 else ""
            leaks.append(
                f"{len(stranded)} stranded unbound pod(s): {shown}{extra}"
            )
        return leaks

    def fleet(self) -> dict:
        kube = self.op.kube
        live = [
            p for p in kube.pods()
            if p.metadata.deletion_timestamp is None
        ]
        return {
            "nodes": len(kube.nodes()),
            "node_claims": len(kube.node_claims()),
            "live_pods": len(live),
            "bound_pods": sum(1 for p in live if p.spec.node_name),
        }


def _apply_events(run: _SoakRun, schedule: Schedule, cursor: int,
                  until: float, applied: dict) -> int:
    """Deliver every schedule event with t <= until (the cursor is a
    monotonic index into the pre-sorted event tuple)."""
    from karpenter_tpu_torch.metrics.store import SCENARIO_EVENTS
    from karpenter_tpu_torch.testing import mk_pod

    events = schedule.events
    while cursor < len(events) and events[cursor].t <= until + 1e-9:
        ev = events[cursor]
        cursor += 1
        if ev.kind == "create":
            pod = mk_pod(name=ev.pod, cpu=ev.cpu,
                         memory=ev.memory_gib * GIB)
            pod.spec.priority = ev.priority
            pod.metadata.creation_timestamp = _NOW0 + ev.t
            run.user.create(pod)
        else:
            run.user.deliver()
            pod = run.user.get_pod("default", ev.pod)
            if pod is None or pod.metadata.deletion_timestamp is not None:
                applied["skipped_delete"] = applied.get(
                    "skipped_delete", 0
                ) + 1
                continue
            run.user.delete(pod)
        applied[ev.kind] = applied.get(ev.kind, 0) + 1
        SCENARIO_EVENTS.inc({"layer": ev.layer, "kind": ev.kind})
    return cursor


def run_soak(spec: ScenarioSpec,
             schedule: Optional[Schedule] = None, device=None) -> dict:
    """Replay `spec`'s composed schedule end to end and return the
    judge's verdict artifact (soak observations included). Pure
    function of (spec, seed): two calls return reports with the same
    report_digest, on either device. `device` is the Operator's (None:
    the card; raises without one)."""
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.metrics import slo as _slo
    from karpenter_tpu_torch.metrics.store import (
        INCREMENTAL_DIVERGENCE,
        SCHEDULER_UNSCHEDULABLE_PODS,
    )
    from karpenter_tpu_torch.scenarios.judge import judge
    from karpenter_tpu_torch.solver import faults

    schedule = schedule if schedule is not None else compose(spec)
    vclock = VirtualClock()

    env_keys = ["KARPENTER_FAULTS", "KARPENTER_FAULT_SEED",
                *sorted(_SOAK_ENV)]
    saved_env = {k: os.environ.get(k) for k in env_keys}
    saved_injector = faults.snapshot_active()
    try:
        for k, v in _SOAK_ENV.items():
            os.environ[k] = v
        if schedule.faults_spec:
            os.environ["KARPENTER_FAULTS"] = schedule.faults_spec
        else:
            os.environ.pop("KARPENTER_FAULTS", None)
        os.environ["KARPENTER_FAULT_SEED"] = str(spec.seed)
        faults.reset()
        inj = faults.get()
        if inj is not None:
            inj._sleep = vclock.sleep
        # process-global planes the judge reads: start them clean, and
        # drop the live-provisioning gauge series a previous run in
        # this process may have left behind (the first tick must read
        # an ABSENT series either way)
        explain.clear()
        _slo.reset_last_digest()
        SCHEDULER_UNSCHEDULABLE_PODS.delete({"controller": "provisioner"})
        divergences0 = INCREMENTAL_DIVERGENCE.total()

        run = _SoakRun(spec, vclock, device)
        applied: dict[str, int] = {}
        cursor = 0
        checkpoints: list[dict] = []
        buried_anomalies = 0
        phases = sorted(
            p for p in spec.phases if 0.0 < p < spec.duration_s
        )
        phase_i = 0
        now = 0.0
        n_ticks = int(spec.duration_s / spec.tick_s) + 1
        for _ in range(n_ticks):
            now += spec.tick_s
            while phase_i < len(phases) and phases[phase_i] <= now:
                # regime boundary: checkpoint + deterministic re-warmup
                checkpoint = run.sentinel.reset_baselines()
                buried_anomalies += checkpoint["anomaly_total"]
                checkpoints.append({
                    "at_s": phases[phase_i],
                    "anomaly_total": checkpoint["anomaly_total"],
                    "signals": sorted(checkpoint["signals"]),
                })
                phase_i += 1
            cursor = _apply_events(run, schedule, cursor, now, applied)
            if not run.step(now):
                continue
            for j in range(1, spec.micro_per_tick + 1):
                tm = now + spec.tick_s * j / (spec.micro_per_tick + 1)
                cursor = _apply_events(run, schedule, cursor, tm, applied)
                if not run.micro(tm):
                    break

        # trace over: capture the replay artifact, then drain
        # fault-quiet (the judge scores the trace, not the teardown)
        inj = faults.get()
        fault_log = inj.snapshot_log() if inj is not None else []
        os.environ.pop("KARPENTER_FAULTS", None)
        faults.reset()
        surge_retired = run.retire_surge()
        now += 130.0  # ride past the GC interval
        drain_ticks = max(4, int(spec.drain_s / 15.0))
        for _ in range(drain_ticks):
            now += 15.0
            run.step(now)

        final_sentinel = run.sentinel.snapshot()
        obs = {
            "schedule_digest": schedule.digest(),
            "events_applied": {k: applied.get(k, 0) for k in
                               ("create", "delete", "skipped_delete")},
            "layer_counts": schedule.counts,
            "ticks": run.ticks,
            "micro_steps": run.micro_steps,
            "crashes": run.crashes,
            "micro_crashes": run.micro_crashes,
            "surge_retired": surge_retired,
            "virtual_seconds": round(now, 3),
            "fault_log_len": len(fault_log),
            "fault_kinds": sorted({kind for _, _, kind in fault_log}),
            "slo": {
                "max_burn": {
                    name: dict(sorted(v.items()))
                    for name, v in sorted(run.slo_max.items())
                },
                "alerts": run.merged_alerts(),
                "cumulative": run.merged_cumulative(),
            },
            "sentinel": {
                "anomaly_total": (
                    buried_anomalies + final_sentinel["anomaly_total"]
                ),
                "checkpoints": checkpoints,
                "final": final_sentinel,
            },
            "oracle_divergences": int(
                INCREMENTAL_DIVERGENCE.total() - divergences0
            ),
            "explain": explain.summarize_ring(),
            "leaks": run.leak_check(),
            "fleet": run.fleet(),
        }
        obs["fault_log"] = fault_log
        return judge(spec, schedule, obs)
    finally:
        faults.restore_active(saved_injector)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
