"""The port's wavefront kernel B3 and its routing against the JAX
package's, on CPU.

`pack_split_wavefront_ref` (the plain PyTorch version of B3,
`karpenter_tpu_torch/solver/pack_split.py`) runs on the same padded
inputs as the JAX `pack_split_wavefront`: the JAX package encodes the
problem, its arrays reach the port through `encoded_from_arrays`, the
port's `stage` pads them, and both kernels take those padded arrays.

(a) all six outputs (assign, free_mask, node_count, unsched, steps,
    widths) equal JAX's at widths 1, 8 and 16, on fixtures built like
    tests/test_wavefront_oracle.py (fresh-only in both modes,
    reservations, existing rows, group caps with conflicts) and on the
    small `testing.kernel_cases` that add bound rows with quotas, group
    caps and conflicts, and negative and huge demand on a node axis
    capped at 256 fresh rows (the fixtures without optional inputs are
    padded to one set of shapes, so the JAX kernel compiles once per
    mode and width for them);
(b) the flat buffer of `pack_split_flat(..., wavefront=16)` equals
    JAX's byte for byte;
(c) the first four outputs equal the port's own B1 plain version;
(d) `wavefront_width`/`wavefront_plan` resolve the knobs as JAX's do,
    with auto asking the solve's device (off for cpu, on for cuda);
(e) `solve(..., device="cpu")` with KARPENTER_WAVEFRONT=force gives the
    JAX solve's fingerprint with the knob forced and off, and
    `PackResult.device_steps` and the width histogram equal JAX's.

Tolerance: exact equality; every pick is an index-tie-broken
arg-reduction and the float math is f32 in the JAX order.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from karpenter_tpu.cloudprovider.fake import GIB, instance_types, make_instance_type
from karpenter_tpu.solver import pack as jpack
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu.solver.solver import solve as jsolve
from karpenter_tpu.testing import mk_nodepool, mk_pod
from karpenter_tpu_torch.solver import pack
from karpenter_tpu_torch.solver import pack_split as kernels
from karpenter_tpu_torch.solver.encode import encode, encoded_from_arrays, group_pods
from karpenter_tpu_torch.solver.solver import fingerprint, solve
from karpenter_tpu_torch.testing import kernel_cases
from karpenter_tpu_torch.workloads import build_problem

ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]
WIDTHS = (1, 8, 16)
OUTPUTS = ("assign", "free_mask", "node_count", "unsched", "steps", "widths")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensors; one intra-op thread keeps
    them from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- inputs


def _random_problem(seed, n_pods=300, n_types=20, reservations=False):
    """tests/test_wavefront_oracle.py's random problem, JAX-encoded."""
    rng = np.random.default_rng(seed)
    if reservations:
        types = []
        for i in range(n_types):
            cpu = float(rng.choice([2, 4, 8, 16]))
            rsv = (
                [(f"rsv-{i}", "test-zone-1", int(rng.integers(1, 4)))]
                if rng.random() < 0.3 else None
            )
            types.append(make_instance_type(
                f"t-{i}", cpu=cpu, memory=cpu * 4 * GIB,
                price=cpu * float(rng.uniform(0.8, 1.2)), reservations=rsv,
            ))
    else:
        types = instance_types(n_types)
    pool = mk_nodepool("default")
    pods = []
    for i in range(n_pods):
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0, 4.0]))
        mem = float(rng.choice([0.5, 1.0, 2.0, 8.0])) * GIB
        sel = {}
        if rng.random() < 0.3:
            sel["kubernetes.io/arch"] = "amd64"
        if rng.random() < 0.3:
            sel["topology.kubernetes.io/zone"] = str(rng.choice(ZONES))
        pods.append(mk_pod(name=f"p-{i}", cpu=cpu, memory=mem, node_selector=sel))
    return jencode(jgroup_pods(pods), [(pool, types)], [])


def _arrays(enc):
    names = ("compat", "group_req", "group_count", "cfg_alloc", "cfg_price",
             "cfg_pool", "pool_overhead", "existing_used", "cfg_rsv",
             "rsv_cap", "group_cap", "conflict", "existing_quota")
    return {k: (None if getattr(enc, k) is None else np.asarray(getattr(enc, k)))
            for k in names}


def _staged(enc, existing_mask=None, existing_used=None, N=256):
    """The JAX encode staged by the port, as (args, kwargs, max_free)
    numpy inputs of the kernels."""
    C = enc.compat.shape[1]
    R = enc.group_req.shape[1]
    if existing_mask is None:
        existing_mask = np.zeros((0, C), bool)
        existing_used = np.zeros((0, R), np.float32)
    staged = pack.stage(encoded_from_arrays(_arrays(enc)), existing_mask,
                        existing_used, N)
    return staged.args, staged.kwargs, staged.max_free


def _existing_rows(enc, seed, E=9):
    """Random one-hot bound rows at random fills (the oracle's)."""
    C = enc.compat.shape[1]
    R = enc.group_req.shape[1]
    rng = np.random.default_rng(seed + 100)
    mask = np.zeros((E, C), bool)
    used = np.zeros((E, R), np.float32)
    launchable = np.flatnonzero(enc.cfg_pool >= 0)
    for e in range(E):
        c = int(rng.choice(launchable))
        mask[e, c] = True
        used[e] = enc.cfg_alloc[c] * float(rng.uniform(0, 0.5))
    return mask, used


def _with_existing_rows(enc, seed):
    return _staged(enc, *_existing_rows(enc, seed))


def _caps_and_conflicts(seed):
    enc = _random_problem(seed, n_pods=200)
    G = enc.compat.shape[0]
    rng = np.random.default_rng(seed)
    enc.group_cap = rng.integers(1, 5, size=G).astype(np.int32)
    conflict = np.zeros((G, G), bool)
    for _ in range(12):
        a, b = rng.integers(0, G, size=2)
        conflict[a, b] = conflict[b, a] = True
    enc.conflict = conflict
    return _staged(enc)


# kernel_cases that cover what the oracle fixtures do not: bound rows
# with quotas (and caps and conflicts), negative and 2^31-scale demand
# on a node axis capped at 256 rows
KERNEL_CASES = ("bound-quota-cap-conflict-ffd", "bound-quota-cap-conflict-cost",
                "demand-ffd", "demand-cost")


@functools.lru_cache(maxsize=None)
def _small_kernel_cases():
    return {c.name: c for c in kernel_cases(2, n_pods=300, n_types=16)}


FIXTURES = {
    "fresh-0-ffd": lambda: (*_staged(_random_problem(0)), "ffd"),
    "fresh-0-cost": lambda: (*_staged(_random_problem(0)), "cost"),
    "fresh-1-ffd": lambda: (*_staged(_random_problem(1)), "ffd"),
    "reservations-5": lambda: (*_staged(_random_problem(5, reservations=True)), "ffd"),
    "existing-7": lambda: (*_with_existing_rows(_random_problem(7), 7), "ffd"),
    "caps-conflicts-11": lambda: (*_caps_and_conflicts(11), "ffd"),
    **{
        f"kc-{name}": (lambda name=name: (
            _small_kernel_cases()[name].args, _small_kernel_cases()[name].kwargs,
            _small_kernel_cases()[name].max_free, _small_kernel_cases()[name].mode))
        for name in KERNEL_CASES
    },
}


# the fixtures without optional inputs, padded to one set of shapes so
# that the JAX package compiles B3 once per mode and width for all of
# them (fresh-only, existing rows and the capped demand case)
SHARED_SHAPES = ("fresh-0-ffd", "fresh-0-cost", "fresh-1-ffd", "existing-7",
                 "kc-demand-ffd", "kc-demand-cost")


def _pad(inputs, Gp, Cp, B, F):
    """Staged inputs padded to Gp groups, Cp configs, B bound rows and
    F fresh rows. Inert: groups without demand, configs no group is
    compatible with and no pool launches, dead bound rows (slot K = 0,
    no reservations), fresh rows the solve does not reach unless its
    axis was full at F (the capped case keeps its F)."""
    args, kwargs, max_free, mode = inputs
    assert all(v is None for v in kwargs.values())

    def pad(x, shape, fill):
        out = np.full(shape, fill, x.dtype)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
     bound_compat, bound_alloc, bound_used0, bound_slot, bound_live,
     cfg_price) = args
    R = group_req.shape[1]
    args = (pad(compat, (Gp, Cp), False), pad(group_req, (Gp, R), 0),
            pad(group_count, (Gp,), 0), pad(cfg_alloc, (Cp, R), 0),
            pad(cfg_pool, (Cp,), -1), pool_overhead,
            pad(bound_compat, (Gp, B), False), pad(bound_alloc, (B, R), 0),
            pad(bound_used0, (B, R), 0), pad(bound_slot, (B,), 0),
            pad(bound_live, (B,), False), pad(cfg_price, (Cp,), 0))
    return args, kwargs, F, mode


@functools.lru_cache(maxsize=None)
def _shared_shapes():
    built = {name: FIXTURES[name]() for name in SHARED_SHAPES}
    Gp = max(x[0][0].shape[0] for x in built.values())
    Cp = max(x[0][0].shape[1] for x in built.values())
    B = max(x[0][7].shape[0] for x in built.values())
    F = max(x[2] for x in built.values())
    # every fixture keeps at least its own fresh rows
    assert all(x[0][7].shape[0] + x[2] <= B + F for x in built.values())
    return {name: _pad(x, Gp, Cp, B, F) for name, x in built.items()}


@functools.lru_cache(maxsize=None)
def _inputs(fixture):
    if fixture in SHARED_SHAPES:
        return _shared_shapes()[fixture]
    return FIXTURES[fixture]()


def _torch(args, kwargs):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    return [put(a) for a in args], {k: put(v) for k, v in kwargs.items()}


def _jax(args, kwargs):
    return ([jnp.asarray(a) for a in args],
            {k: (None if v is None else jnp.asarray(v)) for k, v in kwargs.items()})


@functools.lru_cache(maxsize=None)
def _port_wavefront(fixture, width):
    args, kwargs, max_free, mode = _inputs(fixture)
    t_args, t_kw = _torch(args, kwargs)
    return tuple(x.numpy() for x in kernels.pack_split_wavefront_ref(
        *t_args, max_free=max_free, mode=mode, width=width, **t_kw))


# ---------------------------------------------------------------- (a)-(c)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_plain_version_equals_jax(fixture, width):
    args, kwargs, max_free, mode = _inputs(fixture)
    j_args, j_kw = _jax(args, kwargs)
    theirs = [np.asarray(x) for x in jpack.pack_split_wavefront(
        *j_args, max_free=max_free, mode=mode, width=width, **j_kw)]
    ours = _port_wavefront(fixture, width)
    for name, a, b in zip(OUTPUTS, theirs, ours):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} at width {width}")
    steps = int(ours[4])
    # every group with demand commits in exactly one round, and a round
    # commits at least one
    assert int(ours[5][:steps].sum()) == int((np.asarray(args[2]) > 0).sum())
    assert (ours[5][:steps] >= 1).all() and (ours[5][steps:] == 0).all()
    if width == 1:
        assert steps == int((np.asarray(args[2]) > 0).sum())


@pytest.mark.parametrize("fixture", ["reservations-5",
                                     "kc-bound-quota-cap-conflict-ffd"])
def test_flat_buffer_equals_jax(fixture):
    args, kwargs, max_free, mode = _inputs(fixture)
    j_args, j_kw = _jax(args, kwargs)
    t_args, t_kw = _torch(args, kwargs)
    theirs = np.asarray(jpack.pack_split_flat(
        *j_args, max_free=max_free, mode=mode, wavefront=16, **j_kw))
    ours = kernels.pack_split_flat(
        *t_args, max_free=max_free, mode=mode, wavefront=16, **t_kw).numpy()
    assert theirs.dtype == np.uint32 and ours.dtype == np.int32
    assert theirs.tobytes() == ours.view(np.uint32).tobytes()
    # the wavefront stats follow every sequential field
    seq = kernels.pack_split_flat_ref(
        *t_args, max_free=max_free, mode=mode, **t_kw).numpy()
    G = args[0].shape[0]
    assert ours.shape[0] == seq.shape[0] + G + 1
    np.testing.assert_array_equal(ours[: seq.shape[0]], seq)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_plain_version_equals_sequential(fixture, width):
    args, kwargs, max_free, mode = _inputs(fixture)
    t_args, t_kw = _torch(args, kwargs)
    seq = [x.numpy() for x in kernels.pack_split_ref(
        *t_args, max_free=max_free, mode=mode, **t_kw)]
    for name, a, b in zip(OUTPUTS, seq, _port_wavefront(fixture, width)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} at width {width}")


def test_cpu_tensors_take_the_plain_version():
    args, kwargs, max_free, mode = _inputs("kc-demand-ffd")
    t_args, t_kw = _torch(args, kwargs)
    kernels.reset_launch_counts()
    got = kernels.pack_split_wavefront(*t_args, max_free=max_free, mode=mode,
                                       width=16, **t_kw)
    for a, b in zip(got, _port_wavefront("kc-demand-ffd", 16)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert set(kernels.LAUNCHES.values()) == {0}
    meta = [a.to("meta") for a in t_args]
    with pytest.raises(ValueError, match="no kernel"):
        kernels.pack_split_wavefront(*meta, max_free=max_free, width=16)


# ---------------------------------------------------------------- (d)


@pytest.mark.parametrize("knob,width_knob,n_groups", [
    ("0", None, 100),
    ("off", None, 100),
    ("force", None, 100),
    ("12", None, 100),
    ("force", "6", 100),
    ("force", None, 7),
    ("-3", None, 100),
    ("1", None, 100),
])
def test_knobs_resolve_as_in_jax(monkeypatch, knob, width_knob, n_groups):
    monkeypatch.setenv("KARPENTER_WAVEFRONT", knob)
    if width_knob is None:
        monkeypatch.delenv("KARPENTER_WAVEFRONT_WIDTH", raising=False)
    else:
        monkeypatch.setenv("KARPENTER_WAVEFRONT_WIDTH", width_knob)
    # the JAX package runs on its CPU backend here, as does device cpu
    assert pack.wavefront_plan(n_groups, torch.device("cpu")) == jpack.wavefront_plan(n_groups)
    assert pack.WAVEFRONT_MIN_GROUPS == jpack.WAVEFRONT_MIN_GROUPS


@pytest.mark.parametrize("device,expected", [("cpu", 0), ("cuda", 16)])
def test_auto_follows_the_solve_device(monkeypatch, device, expected):
    monkeypatch.delenv("KARPENTER_WAVEFRONT", raising=False)
    monkeypatch.delenv("KARPENTER_WAVEFRONT_WIDTH", raising=False)
    assert pack.wavefront_plan(100, torch.device(device)) == expected
    assert pack.wavefront_plan(pack.WAVEFRONT_MIN_GROUPS - 1, torch.device(device)) == 0
    monkeypatch.setenv("KARPENTER_WAVEFRONT_WIDTH", "6")
    assert pack.wavefront_plan(100, torch.device(device)) == (6 if expected else 0)


# ---------------------------------------------------------------- (e)


@pytest.mark.parametrize("seed,n_existing", [(8, 6)])
def test_forced_solve_equals_jax(monkeypatch, seed, n_existing):
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    from karpenter_tpu_torch.solver.encode import ExistingNodeInput
    from karpenter_tpu.scheduling.requirements import Requirements as JRequirements
    from karpenter_tpu.solver.encode import ExistingNodeInput as JExisting

    def existing(cls, reqs_cls):
        rng = np.random.default_rng(seed)
        return [cls(
            name=f"node-{i}",
            requirements=reqs_cls.from_labels({
                "kubernetes.io/arch": "amd64",
                "topology.kubernetes.io/zone": ZONES[i % 3],
                "karpenter.sh/nodepool": "default",
            }),
            taints=(),
            available={"cpu": float(rng.uniform(1, 8)),
                       "memory": float(rng.uniform(1, 16)) * GIB, "pods": 50.0},
            pool_name="default",
        ) for i in range(n_existing)]

    pods, pools = build_problem(300, 20, seed=seed)
    jpods, jpools = bench.build_problem(300, 20, seed=seed)
    ex = existing(ExistingNodeInput, Requirements)
    jex = existing(JExisting, JRequirements)

    monkeypatch.setenv("KARPENTER_WAVEFRONT", "force")
    ours = solve(pods, pools, ex, device="cpu")
    theirs_forced = jsolve(jpods, jpools, jex)
    monkeypatch.setenv("KARPENTER_WAVEFRONT", "0")
    theirs_off = jsolve(jpods, jpools, jex)
    assert fingerprint(ours) == fingerprint(theirs_forced) == fingerprint(theirs_off)

    monkeypatch.setenv("KARPENTER_WAVEFRONT", "force")
    enc = encode(group_pods(pods), pools, ex)
    assert enc.compat.shape[0] >= pack.WAVEFRONT_MIN_GROUPS
    res = pack.solve_packing(enc, device="cpu")
    jres = jpack.solve_packing(jencode(jgroup_pods(jpods), jpools, jex))
    assert res.wavefront_widths is not None
    assert res.device_steps == jres.device_steps
    assert res.device_steps < enc.compat.shape[0]
    np.testing.assert_array_equal(res.wavefront_widths, jres.wavefront_widths)
    np.testing.assert_array_equal(res.assign, jres.assign)
    assert res.node_count == jres.node_count


def test_sequential_route_reports_padded_steps(monkeypatch):
    monkeypatch.setenv("KARPENTER_WAVEFRONT", "0")
    pods, pools = build_problem(300, 20, seed=3)
    enc = encode(group_pods(pods), pools)
    res = pack.solve_packing(enc, device="cpu")
    assert res.wavefront_widths is None
    assert res.device_steps == pack._pad_axis(enc.compat.shape[0])
