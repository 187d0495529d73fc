"""Declarative scenario specs and their replay-identical compilation.

Copy of `karpenter_tpu/scenarios/spec.py` (dataclasses, `random` and
`hashlib` only): `compose()` gives the same schedule and digest as the
JAX package's.

A `ScenarioSpec` names a seed, a virtual trace horizon, and a tuple of
workload layers. Each layer compiles INDEPENDENTLY to a sorted event
list through a layer-scoped RNG seeded from `f"{spec.seed}:{layer
name}"` — a pure function of (spec, seed, the injected clock origin
0.0), with no wall-clock read anywhere — so `compose()` emits the same
byte-identical schedule on every call, on every machine. Layers that
model cloud weather (spot storms) contribute no pod events; they ride
along as `KARPENTER_FAULTS` entries carrying their own `#seed` suffix
(solver/faults.py), so several storms compose into one spec without
their rate schedules aliasing.

Pod shapes default to a small Pareto-weighted signature catalog — the
heavy-head/long-tail demand shape `bench.build_scaled_demand` scales
to millions of pods — drawn per layer from the layer's own RNG.

The schedule's `digest()` (sha256 over the canonical event JSON + the
composed fault spec + the seed) is the replay-identity artifact: two
runs of the same spec + seed must agree on it before their judge
reports are even worth diffing.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import dataclass, field
from typing import Optional

GIB = 2 ** 30

# the Pareto-weighted shape catalog layers draw from when they don't
# pin a cpu: a few signatures, heavy-head weighted (the
# build_scaled_demand convention at trace scale)
_CPU_LEVELS = (0.1, 0.25, 0.5, 1.0, 2.0)
_MEM_LEVELS_GIB = (0.25, 0.5, 1.0, 2.0)


@dataclass(frozen=True)
class Event:
    """One schedule entry: at virtual second `t` (from the injected
    clock origin), `kind` ("create" | "delete") pod `pod` for layer
    `layer`. Shape fields matter only for creates."""

    t: float
    layer: str
    kind: str
    pod: str
    cpu: float = 0.0
    memory_gib: float = 0.0
    priority: int = 0

    def sort_key(self):
        # deterministic total order: time, then layer, then kind
        # (deletes before creates at the same instant free capacity
        # first), then name
        return (round(self.t, 9), self.layer,
                0 if self.kind == "delete" else 1, self.pod)

    def canonical(self) -> dict:
        out = {"t": round(self.t, 6), "layer": self.layer,
               "kind": self.kind, "pod": self.pod}
        if self.kind == "create":
            out.update(cpu=round(self.cpu, 6),
                       memory_gib=round(self.memory_gib, 6),
                       priority=self.priority)
        return out


def _layer_rng(spec: "ScenarioSpec", name: str) -> random.Random:
    return random.Random(f"{spec.seed}:{name}")


def _catalog(rng: random.Random, n: int = 8):
    """Per-layer Pareto shape catalog: (shapes, weights)."""
    shapes = [(rng.choice(_CPU_LEVELS), rng.choice(_MEM_LEVELS_GIB))
              for _ in range(n)]
    weights = [rng.paretovariate(1.5) + 1.0 for _ in range(n)]
    return shapes, weights


def _draw(rng: random.Random, shapes, weights):
    return rng.choices(shapes, weights=weights, k=1)[0]


class _Layer:
    """Layer protocol: compile(spec) -> events, fault_entries(spec) ->
    KARPENTER_FAULTS entries (each already carrying its `#seed`)."""

    name: str

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        return []

    def fault_entries(self, spec: "ScenarioSpec") -> list[str]:
        return []

    def _seed_token(self, spec: "ScenarioSpec") -> str:
        return f"{spec.seed}-{self.name}"


@dataclass(frozen=True)
class DiurnalWave(_Layer):
    """Serving fleet tracking a sinusoidal demand wave: the pod count
    follows base*(1 + amplitude*sin(2*pi*t/period)), sampled every
    `sample_s`; scale-downs retire the NEWEST pods first so the wave's
    stable core never churns."""

    name: str = "diurnal"
    base_pods: int = 6
    amplitude: float = 0.5
    period_s: float = 120.0
    sample_s: float = 10.0
    cpu: Optional[float] = None        # None -> Pareto catalog shapes
    memory_gib: float = 1.0
    priority: int = 1000

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        rng = _layer_rng(spec, self.name)
        shapes, weights = _catalog(rng)
        events: list[Event] = []
        live: list[str] = []
        seq = 0
        t = 0.0
        while t <= spec.duration_s + 1e-9:
            phase = 2.0 * math.pi * t / self.period_s
            target = max(0, int(round(
                self.base_pods * (1.0 + self.amplitude * math.sin(phase))
            )))
            while len(live) < target:
                if self.cpu is None:
                    cpu, mem = _draw(rng, shapes, weights)
                else:
                    cpu, mem = self.cpu, self.memory_gib
                pod = f"{self.name}-{seq:04d}"
                seq += 1
                live.append(pod)
                events.append(Event(t, self.name, "create", pod,
                                    cpu, mem, self.priority))
            while len(live) > target:
                events.append(Event(t, self.name, "delete", live.pop()))
            t += self.sample_s
        return events


@dataclass(frozen=True)
class BatchTrain(_Layer):
    """Batch training jobs: every `every_s` a job of `pods_per_job`
    gang pods arrives, runs `duration_s`, and completes (deletes) —
    unless the trace ends first, in which case it runs to the end."""

    name: str = "batch"
    jobs: int = 3
    pods_per_job: int = 4
    every_s: float = 90.0
    duration_s: float = 60.0
    start_s: float = 20.0
    cpu: float = 1.0
    memory_gib: float = 2.0
    priority: int = 200

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        events: list[Event] = []
        for j in range(self.jobs):
            start = self.start_s + j * self.every_s
            if start > spec.duration_s:
                break
            end = start + self.duration_s
            for i in range(self.pods_per_job):
                pod = f"{self.name}-{j}-{i}"
                events.append(Event(start, self.name, "create", pod,
                                    self.cpu, self.memory_gib,
                                    self.priority))
                if end <= spec.duration_s:
                    events.append(Event(end, self.name, "delete", pod))
        return events


@dataclass(frozen=True)
class DemandSurgeBurst(_Layer):
    """A demand surge: `pods` arrive at once at `at_s` and (when
    `hold_s` > 0) retire together after the hold — the overload-storm
    shape priority admission and the reactive plane must absorb."""

    name: str = "surge"
    at_s: float = 60.0
    pods: int = 10
    hold_s: float = 60.0
    cpu: float = 0.25
    memory_gib: float = 0.5
    priority: int = 500

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        events: list[Event] = []
        if self.at_s > spec.duration_s:
            return events
        end = self.at_s + self.hold_s
        for i in range(self.pods):
            pod = f"{self.name}-{i:03d}"
            events.append(Event(self.at_s, self.name, "create", pod,
                                self.cpu, self.memory_gib,
                                self.priority))
            if self.hold_s > 0 and end <= spec.duration_s:
                events.append(Event(end, self.name, "delete", pod))
        return events


@dataclass(frozen=True)
class MixedTenancy(_Layer):
    """Mixed-priority serving+batch tenancy ("Priority Matters"): a
    stable high-priority serving set shares the fleet with a rotating
    low-priority batch population — every `rotate_every_s` the oldest
    batch pod completes and a fresh one arrives."""

    name: str = "tenancy"
    serving_pods: int = 4
    batch_pods: int = 4
    rotate_every_s: float = 30.0
    serving_cpu: float = 0.5
    batch_cpu: float = 0.5
    memory_gib: float = 1.0
    serving_priority: int = 1000
    batch_priority: int = 100

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        events: list[Event] = []
        for i in range(self.serving_pods):
            events.append(Event(0.0, self.name, "create",
                                f"{self.name}-serve-{i}",
                                self.serving_cpu, self.memory_gib,
                                self.serving_priority))
        live: list[str] = []
        seq = 0
        for i in range(self.batch_pods):
            pod = f"{self.name}-batch-{seq:04d}"
            seq += 1
            live.append(pod)
            events.append(Event(0.0, self.name, "create", pod,
                                self.batch_cpu, self.memory_gib,
                                self.batch_priority))
        t = self.rotate_every_s
        while t <= spec.duration_s + 1e-9 and live:
            events.append(Event(t, self.name, "delete", live.pop(0)))
            pod = f"{self.name}-batch-{seq:04d}"
            seq += 1
            live.append(pod)
            events.append(Event(t, self.name, "create", pod,
                                self.batch_cpu, self.memory_gib,
                                self.batch_priority))
            t += self.rotate_every_s
        return events


@dataclass(frozen=True)
class ExpiryChurn(_Layer):
    """Drift/expiry churn: a fixed population whose members each live
    roughly `lifetime_s` (jittered by the layer RNG), die, and are
    immediately replaced — the steady back-pressure that keeps
    consolidation, expiry, and the incremental plane honest."""

    name: str = "churn"
    pods: int = 4
    lifetime_s: float = 90.0
    jitter: float = 0.3
    cpu: float = 0.5
    memory_gib: float = 1.0
    priority: int = 800

    def compile(self, spec: "ScenarioSpec") -> list[Event]:
        rng = _layer_rng(spec, self.name)
        events: list[Event] = []
        for slot in range(self.pods):
            t = slot * self.lifetime_s / max(1, self.pods)
            gen = 0
            while t <= spec.duration_s + 1e-9:
                pod = f"{self.name}-{slot}-{gen}"
                events.append(Event(t, self.name, "create", pod,
                                    self.cpu, self.memory_gib,
                                    self.priority))
                life = self.lifetime_s * (
                    1.0 + self.jitter * (rng.random() * 2.0 - 1.0)
                )
                death = t + max(1.0, life)
                if death > spec.duration_s:
                    break  # the last generation runs to trace end
                events.append(Event(death, self.name, "delete", pod))
                t = death
                gen += 1
        return events


@dataclass(frozen=True)
class SpotStorm(_Layer):
    """Spot-interruption storm (the KubePACS regime): no pod events —
    the layer contributes a rate-based `spot_interruption` fault entry
    whose schedule draws from THIS layer's own `#seed`, so a composed
    spec can stack storms without them aliasing."""

    name: str = "spot_storm"
    rate: float = 0.03

    def fault_entries(self, spec: "ScenarioSpec") -> list[str]:
        return [
            f"spot_interruption@cloud_interrupt:*={self.rate}"
            f"#{self._seed_token(spec)}"
        ]


@dataclass(frozen=True)
class ExpectationEnvelope:
    """The spec's declared verdict expectations, judged against
    `explain.summarize_ring()` at trace end:

    - any observed node verdict outside `allowed_verdicts` (or pod
      code outside `allowed_pod_codes`) is an UNEXPLAINED verdict;
    - the normalized L1 distance between the observed node-verdict
      histogram and `expected_verdicts` (reference SHARES, not
      counts) past `max_distance` is verdict DRIFT.

    Empty tuples disable the respective check — but a spec that wants
    the judge's explain plane armed declares all three."""

    allowed_verdicts: tuple = ()
    allowed_pod_codes: tuple = ()
    expected_verdicts: tuple = ()   # ((verdict, share), ...)
    max_distance: float = 0.35


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    seed: int
    duration_s: float
    tick_s: float = 4.0
    micro_per_tick: int = 2
    drain_s: float = 120.0
    layers: tuple = ()
    faults: tuple = ()              # extra raw KARPENTER_FAULTS entries
    envelope: Optional[ExpectationEnvelope] = None
    phases: tuple = ()              # sentinel checkpoint offsets (s)
    pool_cpu_limit: Optional[float] = None
    consolidate_after: str = "30s"


@dataclass(frozen=True)
class Schedule:
    """compose()'s output: the merged, sorted, replay-identical event
    stream plus the composed fault spec that rides along with it."""

    spec: ScenarioSpec
    events: tuple
    faults_spec: str
    counts: dict = field(default_factory=dict)

    def canonical_events(self) -> list[dict]:
        return [e.canonical() for e in self.events]

    def digest(self) -> str:
        body = json.dumps({
            "seed": self.spec.seed,
            "events": self.canonical_events(),
            "faults": self.faults_spec,
        }, sort_keys=True)
        return hashlib.sha256(body.encode()).hexdigest()


def compose(spec: ScenarioSpec) -> Schedule:
    """Compile every layer and merge: the schedule is a pure function
    of (spec, seed) — byte-identical across runs and machines."""
    names = [layer.name for layer in spec.layers]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate layer names in {spec.name}: {names}")
    events: list[Event] = []
    counts: dict[str, dict[str, int]] = {}
    fault_entries: list[str] = list(spec.faults)
    for layer in spec.layers:
        layer_events = layer.compile(spec)
        events.extend(layer_events)
        per = counts.setdefault(layer.name, {"create": 0, "delete": 0})
        for e in layer_events:
            per[e.kind] = per.get(e.kind, 0) + 1
        fault_entries.extend(layer.fault_entries(spec))
    events.sort(key=Event.sort_key)
    return Schedule(
        spec=spec,
        events=tuple(events),
        faults_spec=",".join(fault_entries),
        counts=counts,
    )


# -- presets ------------------------------------------------------------------

_CALM_ENVELOPE = ExpectationEnvelope(
    # every verdict/code the explain taxonomy can emit on a healthy
    # composed trace (kept:* reasons, consolidation, interruptions):
    # anything OUTSIDE this set at trace end is an unexplained verdict
    allowed_verdicts=(
        "consolidated", "interrupted",
        "kept:not_consolidatable", "kept:replacement_would_cost_more",
        "kept:pdb_blocked", "kept:do_not_disrupt", "kept:budget",
        "kept:nominated", "kept:min_nodes", "kept:recently_nominated",
        "kept:not_empty", "kept:not_expired", "kept:not_drifted",
        "kept:candidate_filtered", "kept:no_capacity",
        "kept:probe_kept_node", "kept:validation",
    ),
    allowed_pod_codes=(),           # pod codes free-form (informational)
    # reference shares for a calm run (pinned from the smoke trace's
    # observed histogram): dominated by nominated-keep decisions, with
    # an interruption tail from the spot storm and room for a
    # consolidation tail at longer horizons. Judged by normalized-L1
    # SHAPE distance, so absolute counts — a longer soak — don't move
    # the needle
    expected_verdicts=(
        ("kept:nominated", 0.85),
        ("interrupted", 0.10),
        ("consolidated", 0.05),
    ),
    max_distance=0.35,
)


def smoke_spec(seed: int = 18, duration_s: float = 160.0) -> ScenarioSpec:
    """The tier-1 smoke trace: every layer kind composed over a small
    horizon — diurnal wave + batch train + surge + mixed tenancy +
    churn + spot storm — sized to soak in seconds under the
    accelerated injected clock."""
    return ScenarioSpec(
        name="smoke_flywheel",
        seed=seed,
        duration_s=duration_s,
        tick_s=4.0,
        micro_per_tick=2,
        drain_s=120.0,
        layers=(
            DiurnalWave(base_pods=5, amplitude=0.6, period_s=80.0,
                        sample_s=8.0, cpu=0.5, memory_gib=1.0),
            BatchTrain(jobs=2, pods_per_job=3, every_s=60.0,
                       duration_s=40.0, start_s=16.0, cpu=1.0),
            DemandSurgeBurst(at_s=72.0, pods=8, hold_s=48.0, cpu=0.25),
            MixedTenancy(serving_pods=3, batch_pods=3,
                         rotate_every_s=24.0),
            ExpiryChurn(pods=3, lifetime_s=64.0),
            SpotStorm(rate=0.03),
        ),
        envelope=_CALM_ENVELOPE,
        phases=(duration_s / 2.0,),
    )


def flywheel_spec(seed: int = 18,
                  duration_s: float = 14400.0) -> ScenarioSpec:
    """The full long-horizon trace (default four virtual hours): the
    same layer composition at fleet scale and diurnal period — the
    bench `soak_flywheel` arm and the `slow`-marked soak test replay
    this."""
    return ScenarioSpec(
        name="flywheel",
        seed=seed,
        duration_s=duration_s,
        tick_s=5.0,
        micro_per_tick=2,
        drain_s=300.0,
        layers=(
            DiurnalWave(base_pods=24, amplitude=0.5, period_s=3600.0,
                        sample_s=30.0),
            BatchTrain(jobs=max(2, int(duration_s // 900)),
                       pods_per_job=8, every_s=900.0, duration_s=600.0,
                       start_s=120.0, cpu=2.0, memory_gib=4.0),
            DemandSurgeBurst(at_s=duration_s * 0.4, pods=60,
                             hold_s=600.0, cpu=0.25),
            MixedTenancy(serving_pods=12, batch_pods=12,
                         rotate_every_s=120.0),
            ExpiryChurn(pods=10, lifetime_s=1200.0),
            SpotStorm(rate=0.02),
        ),
        envelope=_CALM_ENVELOPE,
        phases=(duration_s / 3.0, 2.0 * duration_s / 3.0),
    )
