"""The scenario compiler of the port, held against the JAX package's
on the CPU.

The cases of tests/test_scenarios.py on the port (every layer compiles
to a pure function of (spec, seed); `compose()` emits the same
byte-identical schedule on every call; the per-layer fault entries
carry their own `#seed` suffixes; the merge order is total, deletes
before creates at the same instant), then `compose()` of `smoke_spec`
and `flywheel_spec` over several seeds and horizons equal to the JAX
package's: the digest, the events, the counts and the composed fault
spec.

Tolerance: exact equality.
"""

import dataclasses

import pytest

from karpenter_tpu import scenarios as jscenarios
from karpenter_tpu_torch.scenarios import (
    BatchTrain,
    DemandSurgeBurst,
    DiurnalWave,
    ExpiryChurn,
    MixedTenancy,
    ScenarioSpec,
    SpotStorm,
    compose,
    flywheel_spec,
    smoke_spec,
)
from karpenter_tpu_torch.scenarios.spec import Event
from karpenter_tpu_torch.solver import faults


class TestComposeDeterminism:
    def test_same_spec_same_digest_byte_identical(self):
        a = compose(smoke_spec(seed=18))
        b = compose(smoke_spec(seed=18))
        assert a.digest() == b.digest()
        assert a.canonical_events() == b.canonical_events()
        assert a.faults_spec == b.faults_spec

    def test_different_seed_different_digest(self):
        assert (compose(smoke_spec(seed=18)).digest()
                != compose(smoke_spec(seed=19)).digest())

    def test_layer_compile_is_pure(self):
        """A layer's compile() alone is replay-identical — no global
        RNG state leaks between calls."""
        spec = smoke_spec()
        for layer in spec.layers:
            first = [e.canonical() for e in layer.compile(spec)]
            second = [e.canonical() for e in layer.compile(spec)]
            assert first == second, layer.name

    def test_flywheel_preset_composes(self):
        sched = compose(flywheel_spec(duration_s=3600.0))
        assert sched.events
        # every pod-emitting layer contributed
        assert set(sched.counts) >= {"diurnal", "batch", "surge",
                                     "tenancy", "churn"}

    def test_counts_match_events(self):
        sched = compose(smoke_spec())
        for layer, per in sched.counts.items():
            creates = sum(1 for e in sched.events
                          if e.layer == layer and e.kind == "create")
            deletes = sum(1 for e in sched.events
                          if e.layer == layer and e.kind == "delete")
            assert per.get("create", 0) == creates
            assert per.get("delete", 0) == deletes


class TestMergeOrder:
    def test_events_sorted_by_total_order(self):
        sched = compose(smoke_spec())
        keys = [e.sort_key() for e in sched.events]
        assert keys == sorted(keys)

    def test_delete_before_create_at_same_instant(self):
        """MixedTenancy rotates at fixed instants: the retiring batch
        pod's delete must land before the replacement's create so the
        rotation frees capacity first."""
        spec = ScenarioSpec(
            name="t", seed=1, duration_s=60.0,
            layers=(MixedTenancy(serving_pods=1, batch_pods=2,
                                 rotate_every_s=30.0),),
        )
        sched = compose(spec)
        at_30 = [e for e in sched.events if abs(e.t - 30.0) < 1e-9]
        assert [e.kind for e in at_30] == ["delete", "create"]

    def test_duplicate_layer_names_rejected(self):
        spec = ScenarioSpec(
            name="dup", seed=1, duration_s=10.0,
            layers=(DiurnalWave(), DiurnalWave()),
        )
        with pytest.raises(ValueError, match="duplicate layer names"):
            compose(spec)


class TestFaultComposition:
    def test_spot_storm_entry_carries_layer_seed(self):
        sched = compose(smoke_spec(seed=18))
        assert ("spot_interruption@cloud_interrupt:*=0.03#18-spot_storm"
                in sched.faults_spec.split(","))

    def test_composed_fault_spec_parses_cleanly(self):
        """Every entry a preset composes — including the `#seed`
        suffixes — must survive faults.parse() without rejection."""
        for spec in (smoke_spec(), flywheel_spec(duration_s=3600.0)):
            sched = compose(spec)
            rejected: list = []
            rules = faults.parse(sched.faults_spec, rejected=rejected)
            assert not rejected
            assert any(r.kind == "spot_interruption" for r in rules)
            assert all(r.seed is not None for r in rules
                       if r.kind == "spot_interruption")

    def test_extra_spec_faults_ride_along(self):
        spec = dataclasses.replace(
            smoke_spec(), faults=("exec_delay@crash_tick:*=2s#lag",),
        )
        sched = compose(spec)
        entries = sched.faults_spec.split(",")
        assert "exec_delay@crash_tick:*=2s#lag" in entries
        rejected = []
        faults.parse(sched.faults_spec, rejected=rejected)
        assert not rejected

    def test_stacked_storms_do_not_alias(self):
        """Two storms in one spec carry distinct per-layer seeds."""
        spec = ScenarioSpec(
            name="storms", seed=7, duration_s=30.0,
            layers=(SpotStorm(name="storm_a", rate=0.05),
                    SpotStorm(name="storm_b", rate=0.05)),
        )
        entries = compose(spec).faults_spec.split(",")
        assert entries[0].endswith("#7-storm_a")
        assert entries[1].endswith("#7-storm_b")


class TestLayerShapes:
    def test_diurnal_wave_retires_newest_first(self):
        spec = ScenarioSpec(
            name="w", seed=3, duration_s=120.0,
            layers=(DiurnalWave(base_pods=4, amplitude=1.0,
                                period_s=80.0, sample_s=10.0,
                                cpu=0.5),),
        )
        sched = compose(spec)
        deletes = [e for e in sched.events if e.kind == "delete"]
        assert deletes
        creates_before = {}
        for e in sched.events:
            if e.kind == "create":
                creates_before[e.pod] = e.t
        # every deleted pod was created strictly earlier
        assert all(creates_before[e.pod] < e.t for e in deletes)

    def test_batch_train_gang_arrives_and_completes_together(self):
        spec = ScenarioSpec(
            name="b", seed=1, duration_s=300.0,
            layers=(BatchTrain(jobs=2, pods_per_job=3, every_s=120.0,
                               duration_s=60.0, start_s=10.0),),
        )
        sched = compose(spec)
        job0 = [e for e in sched.events if e.pod.startswith("batch-0-")]
        assert {e.t for e in job0 if e.kind == "create"} == {10.0}
        assert {e.t for e in job0 if e.kind == "delete"} == {70.0}

    def test_batch_job_past_horizon_runs_to_trace_end(self):
        spec = ScenarioSpec(
            name="b", seed=1, duration_s=40.0,
            layers=(BatchTrain(jobs=1, pods_per_job=2, every_s=120.0,
                               duration_s=60.0, start_s=10.0),),
        )
        sched = compose(spec)
        assert not [e for e in sched.events if e.kind == "delete"]

    def test_surge_past_horizon_emits_nothing(self):
        spec = ScenarioSpec(
            name="s", seed=1, duration_s=30.0,
            layers=(DemandSurgeBurst(at_s=60.0, pods=5),),
        )
        assert not compose(spec).events

    def test_expiry_churn_death_births_successor(self):
        spec = ScenarioSpec(
            name="c", seed=5, duration_s=400.0,
            layers=(ExpiryChurn(pods=2, lifetime_s=90.0),),
        )
        sched = compose(spec)
        slot0 = [e for e in sched.events if e.pod.startswith("churn-0-")]
        by_gen = {}
        for e in slot0:
            gen = int(e.pod.rsplit("-", 1)[1])
            by_gen.setdefault(gen, {})[e.kind] = e.t
        for gen in range(max(by_gen) if by_gen else 0):
            assert by_gen[gen]["delete"] == by_gen[gen + 1]["create"]

    def test_canonical_delete_omits_shape_fields(self):
        ev = Event(1.0, "l", "delete", "p")
        assert set(ev.canonical()) == {"t", "layer", "kind", "pod"}
        ev = Event(1.0, "l", "create", "p", 0.5, 1.0, 100)
        assert ev.canonical()["cpu"] == 0.5


# -- the port against the JAX package


def _events(schedule) -> list:
    return [dataclasses.asdict(e) for e in schedule.events]


PRESETS = {"smoke_spec": (smoke_spec, jscenarios.smoke_spec, (40.0, 160.0)),
           "flywheel_spec": (flywheel_spec, jscenarios.flywheel_spec, (600.0, 3600.0))}


@pytest.mark.parametrize("seed", [0, 1, 7, 18, 42])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_compose_equals_jax(preset, seed):
    ours_fn, theirs_fn, durations = PRESETS[preset]
    for duration in durations:
        ours = compose(ours_fn(seed=seed, duration_s=duration))
        theirs = jscenarios.compose(theirs_fn(seed=seed, duration_s=duration))
        assert ours.digest() == theirs.digest()
        assert _events(ours) == _events(theirs)
        assert ours.counts == theirs.counts
        assert ours.faults_spec == theirs.faults_spec


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_specs_and_layers_equal_jax(preset):
    ours_fn, theirs_fn, _ = PRESETS[preset]
    spec, jspec = ours_fn(seed=5), theirs_fn(seed=5)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    for layer, jlayer in zip(spec.layers, jspec.layers):
        assert layer.name == jlayer.name
        assert ([dataclasses.asdict(e) for e in layer.compile(spec)]
                == [dataclasses.asdict(e) for e in jlayer.compile(jspec)])
        assert layer.fault_entries(spec) == jlayer.fault_entries(jspec)
