"""The port's kernel warm pool (`solver/warm_pool.py`), held against the
JAX package's on the CPU.

- The shape parsers give what the JAX package's give on the same
  strings (defaults, R and P, malformed entries dropped), and
  `bucket_args` the same shapes and dtypes, argument for argument, as
  the JAX package's ShapeDtypeStructs (unsplit, and split over 4
  shards: each input's blocks joined along its split axis).
- `warm` at small shapes on the CPU (the plain versions run each
  canary) counts its buckets as the JAX package's `warm` counts its
  compiles (`{"ok", "error", "skipped"}`, the
  `karpenter_solver_warm_compiles_total` deltas) and warms the same
  padded signatures (`warmed`); the `warm` fault site fails the same
  buckets in both; a set stop event skips every bucket;
  `lp_device.warm` counts alike.
- The re-warm gate: with KARPENTER_REWARM_ON_CLOSE=1 a device breaker
  opened by injected faults closes on its half-open success only after
  `rewarm_canary` ran (one more `ok`), and stays open while the canary's
  `warm` fault fires (one `error`), breaker state for breaker state as
  in the JAX package.
- `start_background` starts a non-daemon thread carrying its stop
  event, which runs `warm` to its end on the given device.
"""

import threading

import pytest

import bench
from karpenter_tpu.metrics.store import SOLVER_WARM_COMPILES as J_WARM
from karpenter_tpu.solver import faults as jfaults
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import resilience as jresilience
from karpenter_tpu.solver import warm_pool as jwarm_pool
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.metrics.store import SOLVER_WARM_COMPILES
from karpenter_tpu_torch.solver import faults, lp_device, resilience, warm_pool
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.resilience import STATE_CLOSED, STATE_OPEN
from karpenter_tpu_torch.utils.platform import force_virtual_mesh
from karpenter_tpu_torch.workloads import build_problem

SHAPES = [(16, 64, 0, 32), (20, 96, 16, 40, 4, 2)]
PROBES = [(3, 16, 64, 8, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with testing.one_core():
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in testing.LADDER_KNOBS + (
            "KARPENTER_WARM_SHAPES", "KARPENTER_WARM_PROBE_SHAPES",
            "KARPENTER_WARM_SHARDS", "KARPENTER_BATCH_PROBES",
            "KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_WAVEFRONT"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (resilience, jresilience):
        mod.reset()
    faults.reset()
    jfaults.reset()
    warm_pool.reset()
    jwarm_pool.compiled_buckets.clear()
    yield
    for mod in (resilience, jresilience):
        mod.reset()
    faults.reset()
    jfaults.reset()
    warm_pool.reset()
    jwarm_pool.compiled_buckets.clear()


SPECS = [
    None, "", "16:256:0:64", "16:256:0:64:6:2; 8:32:4:16", "1:2:3", "a:b:c:d",
    "16:256:0:64;bad;32:64:0:8:5", "0:1:0:1", "1:2:3:4:5:6:7", ";;",
]
PROBE_SPECS = [None, "", "8:16:256:64:32", "8:16:256:64:32:6:3;x", "1:2:3:4",
               "4:8:64:0:16:4"]


@pytest.mark.parametrize("spec", SPECS)
def test_shapes_from_env_equal_jax(monkeypatch, spec):
    assert warm_pool.shapes_from_env(spec) == jwarm_pool.shapes_from_env(spec)
    if spec is not None:
        monkeypatch.setenv("KARPENTER_WARM_SHAPES", spec)
        assert warm_pool.shapes_from_env() == jwarm_pool.shapes_from_env()


@pytest.mark.parametrize("spec", PROBE_SPECS)
def test_probe_shapes_from_env_equal_jax(monkeypatch, spec):
    assert warm_pool.probe_shapes_from_env(spec) == jwarm_pool.probe_shapes_from_env(spec)
    if spec is not None:
        monkeypatch.setenv("KARPENTER_WARM_PROBE_SHAPES", spec)
        assert warm_pool.probe_shapes_from_env() == jwarm_pool.probe_shapes_from_env()


def test_constants_equal_jax():
    assert warm_pool.DEFAULT_SHAPES == jwarm_pool.DEFAULT_SHAPES
    assert warm_pool.DEFAULT_PROBE_SHAPES == jwarm_pool.DEFAULT_PROBE_SHAPES
    assert warm_pool.MODES == jwarm_pool.MODES


@pytest.mark.parametrize("raw", ["", "0", "1", "2", "4", "auto", "nine"])
def test_warm_shards_clamps_to_the_visible_slots(monkeypatch, raw):
    monkeypatch.setenv("KARPENTER_WARM_SHARDS", raw)
    force_virtual_mesh(4)
    try:
        got = warm_pool.warm_shards("cpu")
    finally:
        force_virtual_mesh(0)
    want = {"": 0, "0": 0, "1": 0, "2": 2, "4": 4, "auto": 4, "nine": 0}[raw]
    assert got == want
    # without the virtual mesh the CPU is one slot: no split variants
    assert warm_pool.warm_shards("cpu") == 0


def _shapes(args, kw, axes=None):
    """(shape, dtype name) of each input; a split input's blocks joined
    along its axis."""
    def one(i, x):
        if isinstance(x, list):
            axis = axes.get(i, 0)
            shape = list(x[0].shape)
            shape[axis] = sum(b.shape[axis] for b in x)
            return tuple(shape), str(x[0].dtype).replace("torch.", "")
        return tuple(x.shape), str(getattr(x.dtype, "name", x.dtype)).replace("torch.", "")

    return ([one(i, x) for i, x in enumerate(args)],
            {k: one(k, v) for k, v in sorted(kw.items())})


@pytest.mark.parametrize("flags", [
    dict(), dict(rsv_k=3), dict(group_cap=True, conflict=True, quota=True),
    dict(rsv_k=0, quota=True)])
@pytest.mark.parametrize("dims", [(16, 64, 0, 4, 1), (32, 96, 16, 5, 2)])
def test_bucket_args_shapes_equal_jax(dims, flags):
    Gp, Cp, Ep, R, P = dims
    args, kw = warm_pool.bucket_args(Gp, Cp, Ep, R, P, device="cpu", **flags)
    jargs, jkw = jwarm_pool.bucket_args(Gp, Cp, Ep, R, P, **flags)
    assert _shapes(args, kw) == _shapes(jargs, jkw)


def test_split_bucket_args_shapes_equal_jax():
    force_virtual_mesh(4)
    try:
        args, kw = warm_pool.bucket_args(16, 128, 16, 4, 1, shards=4, device="cpu")
    finally:
        force_virtual_mesh(0)
    jargs, jkw = jwarm_pool.bucket_args(16, 128, 16, 4, 1, shards=4)
    axes = {0: 1, 3: 0, 4: 0, 11: 0, "cfg_rsv": 0}
    assert isinstance(args[0], list) and len(args[0]) == 4
    assert _shapes(args, kw, axes) == _shapes(jargs, jkw)


def _warm_both(**kw):
    before = (SOLVER_WARM_COMPILES.samples(), J_WARM.samples())
    port = warm_pool.warm(device="cpu", **kw)
    jax_ = jwarm_pool.warm(**kw)

    def delta(after, before):
        b = dict(before)
        return {dict(k)["outcome"]: v - b.get(k, 0.0) for k, v in after if v != b.get(k, 0.0)}

    return (port, delta(SOLVER_WARM_COMPILES.samples(), before[0])), \
        (jax_, delta(J_WARM.samples(), before[1]))


def test_warm_counts_and_warmed_buckets_equal_jax(monkeypatch):
    # the dual-ascent buckets are held in test_lp_warm_counts_equal_jax
    monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
    port, jax_ = _warm_both(shapes=list(SHAPES), probe_shapes=list(PROBES))
    assert port == jax_
    assert port[0]["ok"] > 0 and port[0]["error"] == 0
    assert warm_pool.compiled_buckets == jwarm_pool.compiled_buckets
    for sig in jwarm_pool.compiled_buckets:
        assert warm_pool.warmed(*sig)
    # every canary launched its route's plain version and read it back
    kinds = {r["kernel"] for r in warm_pool.CANARIES.values()}
    assert kinds == {"pack", "probe_solo"}
    assert all(r["seconds"] > 0 for r in warm_pool.CANARIES.values())


def test_canary_records_stay_bounded_and_hold_no_tensor(monkeypatch):
    """A bucket launched again (a second `warm`, `rewarm_canary` on
    every breaker close) keeps one record of plain numbers: the records
    neither grow nor hold a tensor past its launch."""
    import torch

    monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
    smallest = [warm_pool.DEFAULT_SHAPES[0]]
    warm_pool.warm(shapes=smallest, modes=("ffd",), topo=False, probe_shapes=[],
                   device="cpu")
    keys = set(warm_pool.CANARIES)
    for _ in range(3):
        assert warm_pool.rewarm_canary(device="cpu")
    warm_pool.warm(shapes=smallest, modes=("ffd",), topo=False, probe_shapes=[],
                   device="cpu")
    assert set(warm_pool.CANARIES) == keys
    assert [r["runs"] for r in warm_pool.CANARIES.values()] == [5] * len(keys)

    def plain(x) -> bool:
        if isinstance(x, dict):
            return all(plain(v) for v in x.values())
        if isinstance(x, (tuple, list)):
            return all(plain(v) for v in x)
        return not isinstance(x, torch.Tensor) and not callable(x)

    assert all(plain(r) for r in warm_pool.CANARIES.values())


def test_warm_fault_fails_the_same_buckets(monkeypatch):
    monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@warm:2-3")
    faults.reset()
    jfaults.reset()
    port, jax_ = _warm_both(shapes=SHAPES[:1], probe_shapes=list(PROBES))
    assert port == jax_
    assert port[0]["error"] == 2
    assert warm_pool.compiled_buckets == jwarm_pool.compiled_buckets


def test_stop_event_skips_every_bucket():
    stop = threading.Event()
    stop.set()
    port, jax_ = _warm_both(shapes=list(SHAPES), probe_shapes=list(PROBES), stop=stop)
    assert port == jax_
    assert port[0]["ok"] == 0 and port[0]["skipped"] > 0
    assert not warm_pool.compiled_buckets


def test_lp_warm_counts_equal_jax():
    shapes = [(16, 64, 5)]
    assert lp_device.warm(shapes, device="cpu") == jlp_device.warm(shapes) == 2


def test_device_none_without_cuda_raises_before_any_bucket():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    before = SOLVER_WARM_COMPILES.samples()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_pool.warm(shapes=SHAPES[:1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_pool.start_background(shapes=SHAPES[:1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_pool.rewarm_canary()
    assert SOLVER_WARM_COMPILES.samples() == before
    assert not warm_pool.compiled_buckets


def _gate_script(pkg: str, monkeypatch) -> list:
    """A device breaker opened by two injected device faults, then two
    half-open probes: the first while the canary's `warm` fault fires
    (the gate keeps it open), the second with it gone (the gate closes
    it). Returns the breaker state and the warm-compile deltas after
    each step."""
    if pkg == "port":
        pods, pools = build_problem(120, 8, seed=3)
        enc = encode(group_pods(pods), pools)
        res, flt, counter = resilience, faults, SOLVER_WARM_COMPILES

        def solve():
            res.shared().solve_packing(enc, mode="ffd", device="cpu")
    else:
        pods, pools = bench.build_problem(120, 8, seed=3)
        enc = jencode(jgroup_pods(pods), pools)
        res, flt, counter = jresilience, jfaults, J_WARM

        def solve():
            res.shared().solve_packing(enc, mode="ffd")
    monkeypatch.setenv("KARPENTER_REWARM_ON_CLOSE", "1")
    monkeypatch.setenv("KARPENTER_BREAKER_COOLDOWN_MS", "60000")
    monkeypatch.setenv("KARPENTER_FAULTS", "device_lost@solve:1-2,device_lost@warm:1")
    flt.reset()
    res.reset()
    br = res.shared().breaker("device")
    out = []

    def note(step):
        out.append((step, br.state, counter.value({"outcome": "ok"}),
                    counter.value({"outcome": "error"})))

    note("start")
    solve()
    solve()
    note("opened")
    br._retry_at = 0.0
    solve()
    note("gate failed")
    br._retry_at = 0.0
    solve()
    note("gate passed")
    base = out[0]
    return [(s, st, ok - base[2], err - base[3]) for s, st, ok, err in out]


def test_rewarm_gate_closes_the_breaker_like_jax(monkeypatch):
    port = _gate_script("port", monkeypatch)
    jax_ = _gate_script("jax", monkeypatch)
    assert port == jax_
    assert port == [("start", STATE_CLOSED, 0, 0), ("opened", STATE_OPEN, 0, 0),
                    ("gate failed", STATE_OPEN, 0, 1), ("gate passed", STATE_CLOSED, 1, 1)]


def test_start_background_runs_a_non_daemon_thread(monkeypatch):
    monkeypatch.setenv("KARPENTER_LP_GUIDE", "0")
    monkeypatch.setenv("KARPENTER_WARM_SHAPES", "16:64:0:32")
    monkeypatch.setenv("KARPENTER_WARM_PROBE_SHAPES", "3:16:64:8:16")
    before = SOLVER_WARM_COMPILES.value({"outcome": "ok"})
    thread = warm_pool.start_background(device="cpu")
    assert not thread.daemon and thread.name == "solver-warm-pool"
    assert isinstance(thread.stop, threading.Event)
    thread.join(120)
    assert not thread.is_alive()
    assert SOLVER_WARM_COMPILES.value({"outcome": "ok"}) > before
    assert warm_pool.warmed(16, 96, 0, 32, "ffd")
    thread.stop.set()


def test_b5_axis_refusal_is_named():
    """B5's limits (`kMaxWideAxis`, `kMaxSlots` and the 16 resources of
    csrc/lp_ascend.cu): past 2048 padded axes the kernel runs its wide
    layout, so the warm pool's default dual-ascent buckets (padded to
    155 x 4438 and 243 x 4438) are refused nowhere; what the kernel
    cannot take is refused by name before a launch (ROADMAP C4)."""
    assert lp_device.ascent_refusal(2048, 2048) is None
    assert lp_device.ascent_refusal(155, 2048) is None
    assert lp_device.ascent_refusal(155, 4438) is None
    assert lp_device.ascent_refusal(243, 4438) is None
    assert lp_device.ascent_refusal(2049, 64) is None
    refusal = lp_device.ascent_refusal(155, 4438, 17, 64)
    assert refusal is not None and "16" in refusal and "C4" in refusal
    assert lp_device.ascent_refusal(lp_device.ASCENT_MAX_AXIS + 1, 64) is not None
    buckets = {(s[0], s[1]) for s in warm_pool.DEFAULT_SHAPES}
    assert all(lp_device.ascent_refusal(lp_device._pad_to(g), lp_device._pad_to(c)) is None
               for g, c in buckets)
