"""The fault injector against the JAX package's.

(a) `faults.parse` of every example of the JAX module's docstring, of
    malformed entries and of the per-entry seed grammar gives equal rules
    and equal rejections (and counts each rejection) in both packages.
(b) `snapshot_log()` over the same sequence of `fire` calls under the
    same spec and seed is equal in both packages, including rate rules
    admitted by the crc32-seeded hash.
(c) The cases of `tests/test_resilience.py::TestFaultSpec` and
    `TestFaultSeedGrammar`, on the port.

Tolerance: exact equality.
"""

import dataclasses

import pytest

from karpenter_tpu.metrics.store import FAULTS_REJECTED as JFAULTS_REJECTED
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu_torch.metrics.store import FAULTS_REJECTED
from karpenter_tpu_torch.solver import faults

# every example of the JAX module's docstring, then one spec per kind
DOC_EXAMPLES = (
    "device_lost@solve:3",
    "rpc_drop@probe:*",
    "compile_delay=5s",
    "rpc_drop@rpc:2-4",
    "kube_conflict@kube_write:2-4",
    "kube_throttle=250ms",
    "operator_crash@crash_bind:2",
    "cache_poison@incremental:2",
    "spot_interruption@cloud_interrupt:3",
    "spot_interruption@cloud_interrupt:*=0.05",
    "spot_interruption@cloud_interrupt:*=0.1#storm-a",
    "demand_surge@provision_intake:2=500",
    "device_lost@solve:3,rpc_drop@probe:*,compile_delay=5s",
    "rpc_drop:2-4,device_lost:5+,exec_delay=250ms",
    "kube_watch_drop,kube_stale_list:2,kube_write_partial@kube_write:1-3",
    "exec_delay@execute:1=1s,compile_delay@compile:2=0.5m,exec_delay=1h",
    "operator_crash@crash_incr_commit:1,operator_crash@crash_disruption_started:2+",
)
MALFORMED = (
    "nonsense@solve, device_lost@badsite, compile_delay, device_lost@solve:0-0, ,"
    "device_lost@solve:2",
    "device_lost@solve:3-1",
    "device_lost@solve:x",
    "exec_delay=fast",
    "spot_interruption@cloud_interrupt:*=1.5",
    "spot_interruption@cloud_interrupt:*=0",
    "demand_surge@provision_intake:1=0",
    "spot_interruption@cloud_interrupt:*=0.1#",
    "spot_interruption@cloud_interrupt:*=0.1#a#b",
    "spot_interruption@cloud_interrupt:*=0.1#a:b",
    "spot_interruption@cloud_interrupt:*=0.1#a=b",
    "spot_interruption@cloud_interrupt:*=0.1#a@b",
    "spot_interruption@cloud_interrupt:*=0.1#a b",
    "spot_interruption@cloud_interrupt:*=0.05#storm-a,compile_delay=5s#lag.1,"
    "demand_surge@provision_intake:2=100#burst_x,device_lost@solve:3#s",
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("KARPENTER_FAULTS", raising=False)
    monkeypatch.delenv("KARPENTER_FAULT_SEED", raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def test_names_equal_jax():
    assert faults.SITES == jfaults.SITES
    assert faults.CRASH_SITES == jfaults.CRASH_SITES
    assert faults._DEFAULT_SITE == jfaults._DEFAULT_SITE
    assert faults._ERROR_KINDS == jfaults._ERROR_KINDS


@pytest.mark.parametrize("spec", DOC_EXAMPLES + MALFORMED)
def test_parse_equals_jax(spec):
    rejected, jrejected = [], []
    before, jbefore = FAULTS_REJECTED.total(), JFAULTS_REJECTED.total()
    rules = faults.parse(spec, rejected=rejected)
    jrules = jfaults.parse(spec, rejected=jrejected)
    assert [dataclasses.astuple(r) for r in rules] == [dataclasses.astuple(r) for r in jrules]
    assert rejected == jrejected
    assert FAULTS_REJECTED.total() - before == len(rejected)
    assert JFAULTS_REJECTED.total() - jbefore == len(jrejected)


# (spec, seed, the sequence of sites fired)
SEQUENCES = (
    ("device_lost@solve:2,rpc_drop@rpc:1-2,compile_delay:3=10ms", "0",
     ("solve", "rpc", "compile", "solve", "rpc", "compile", "solve", "compile")),
    ("spot_interruption@cloud_interrupt:*=0.2", "7", ("cloud_interrupt",) * 120),
    ("spot_interruption@cloud_interrupt:*=0.2#aaa,spot_interruption@cloud_interrupt:*=0.3#bbb",
     "99", ("cloud_interrupt",) * 120),
    ("demand_surge@provision_intake:2-4=50#burst,device_lost@probe:*,exec_delay@execute:2+=1ms",
     "3", ("provision_intake", "probe", "execute") * 6),
    ("kube_conflict@kube_write:2-4,kube_throttle@kube_write:6=250ms,kube_watch_drop:1", "0",
     ("kube_write",) * 8 + ("kube_watch",) * 2),
)


def _fire_all(mod, spec, seed, sites):
    inj = mod.FaultInjector(mod.parse(spec), sleep=lambda _t: None, seed=seed)
    raised = []
    for site in sites:
        try:
            inj.fire(site)
        except mod.FaultError as err:
            raised.append((type(err).__name__, str(err), getattr(err, "count", None),
                           getattr(err, "seq", None), getattr(err, "seed", None),
                           getattr(err, "retry_after", None)))
    return inj.snapshot_log(), raised


@pytest.mark.parametrize("spec,seed,sites", SEQUENCES)
def test_snapshot_log_equals_jax(spec, seed, sites):
    got = _fire_all(faults, spec, seed, sites)
    want = _fire_all(jfaults, spec, seed, sites)
    assert got == want
    assert got[0], "the spec fired nothing"


def test_env_injector_replays_like_jax(monkeypatch):
    monkeypatch.setenv("KARPENTER_FAULTS", "spot_interruption@cloud_interrupt:*=0.25,"
                       "device_lost@solve:3")
    monkeypatch.setenv("KARPENTER_FAULT_SEED", "11")
    logs = []
    for mod in (faults, jfaults):
        mod.reset()
        for site in ("solve", "cloud_interrupt") * 20:
            try:
                mod.fire(site)
            except mod.FaultError:
                pass
        logs.append(mod.get().snapshot_log())
    assert logs[0] == logs[1] and logs[0]


# -- the cases of tests/test_resilience.py::TestFaultSpec, on the port


class TestFaultSpec:
    def test_parse_docstring_example(self):
        rules = faults.parse("device_lost@solve:3,rpc_drop@probe:*,compile_delay=5s")
        assert [(r.kind, r.site, r.lo, r.hi) for r in rules] == [
            ("device_lost", "solve", 3, 3),
            ("rpc_drop", "probe", 0, -1),
            ("compile_delay", "compile", 0, -1),
        ]
        assert rules[2].delay == 5.0

    def test_parse_ranges_defaults_durations(self):
        rules = faults.parse("rpc_drop:2-4,device_lost:5+,exec_delay=250ms")
        assert (rules[0].site, rules[0].lo, rules[0].hi) == ("rpc", 2, 4)
        assert (rules[1].lo, rules[1].hi) == (5, -1)
        assert rules[2].site == "execute" and rules[2].delay == 0.25

    def test_malformed_entries_dropped_not_fatal(self):
        rules = faults.parse(
            "nonsense@solve, device_lost@badsite, compile_delay, "
            "device_lost@solve:0-0, ,device_lost@solve:2"
        )
        assert [(r.kind, r.lo) for r in rules] == [("device_lost", 2)]

    def test_occurrence_matching_is_per_site(self):
        inj = faults.FaultInjector(faults.parse("device_lost@solve:2"))
        inj.fire("probe")
        inj.fire("solve")
        with pytest.raises(faults.DeviceLostError):
            inj.fire("solve")
        inj.fire("solve")

    def test_replay_is_byte_identical(self):
        spec = "device_lost@solve:2,rpc_drop@rpc:1-2,compile_delay:3=10ms"

        def run():
            return _fire_all(faults, spec, "0", ("solve", "rpc", "compile", "solve", "rpc",
                                                 "compile", "solve", "compile"))[0]

        first, second = run(), run()
        assert first == second and first

    def test_env_spec_change_resets_counters(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1")
        with pytest.raises(faults.DeviceLostError):
            faults.fire("solve")
        faults.fire("solve")
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1 ")
        with pytest.raises(faults.DeviceLostError):
            faults.fire("solve")

    def test_snapshot_active_restores_counters(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:2")
        faults.fire("solve")
        state = faults.snapshot_active()
        monkeypatch.setenv("KARPENTER_FAULTS", "rpc_drop@rpc:1")
        with pytest.raises(faults.RpcDropError):
            faults.fire("rpc")
        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:2")
        faults.restore_active(state)
        with pytest.raises(faults.DeviceLostError):
            faults.fire("solve")  # occurrence 2 of the restored injector
        assert faults.get().snapshot_log() == [("solve", 2, "device_lost")]

    def test_traced_log_carries_the_trace_id(self, monkeypatch):
        from karpenter_tpu_torch import tracing

        monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1")
        with tracing.trace("tick") as root:
            with pytest.raises(faults.DeviceLostError):
                faults.fire("solve")
        inj = faults.get()
        assert inj.snapshot_log() == [("solve", 1, "device_lost")]
        [(site, seq, kind, tid)] = inj.snapshot_log_traced()
        assert (site, seq, kind) == ("solve", 1, "device_lost") and tid
        spans = tracing.last_trace()["spans"]
        assert spans[0]["events"] == [{"name": "fault", "kind": "device_lost",
                                       "site": "solve", "seq": 1}]
        assert root is not None


class TestFaultSeedGrammar:
    def test_seed_suffix_parses_on_every_param_shape(self):
        rules = faults.parse(
            "spot_interruption@cloud_interrupt:*=0.05#storm-a,"
            "compile_delay=5s#lag.1,"
            "demand_surge@provision_intake:2=100#burst_x,"
            "device_lost@solve:3#s"
        )
        assert [r.seed for r in rules] == ["storm-a", "lag.1", "burst_x", "s"]
        assert rules[0].rate == 0.05 and rules[1].delay == 5.0
        assert rules[2].count == 100 and rules[3].lo == 3

    def test_per_entry_seed_overrides_injector_seed(self):
        def fired(spec, injector_seed):
            log, _ = _fire_all(faults, spec, injector_seed, ("cloud_interrupt",) * 200)
            return [seq for _, seq, _ in log]

        spec_a = "spot_interruption@cloud_interrupt:*=0.2#aaa"
        spec_b = "spot_interruption@cloud_interrupt:*=0.2#bbb"
        assert fired(spec_a, "7") != fired(spec_b, "7")
        assert fired(spec_a, "7") == fired(spec_a, "99")

    def test_env_seed_fallback_via_get(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_FAULTS",
                           "spot_interruption@cloud_interrupt:*=0.5#pinned")
        monkeypatch.setenv("KARPENTER_FAULT_SEED", "3")
        faults.reset()
        inj = faults.get()
        assert inj.seed == "3"
        assert inj.rules[0].seed == "pinned"
