"""The port's dense packing kernel B7 against the JAX package's, on CPU.

`pack_ref` and `pack_flat_ref` (the plain PyTorch versions of B7,
`karpenter_tpu_torch/solver/pack_dense.py`) run on the same numpy inputs
as the JAX `pack` and `pack_flat`: the JAX package encodes the problem
(tests/test_pack_split_equivalence.py's `_random_problem`), its arrays
reach the port through `encoded_from_arrays`, the port's `stage` pads
them and `testing.dense_case` lays the bound block out as one-hot
`existing_mask` rows (with quotas as the first rows of a [N, G] quota),
as that file's `_run_both` does. Fixtures: its fresh-only seeds 0-3,
reservation seeds 5-6 and existing-row seeds 7-8 in both modes, its
planned quota rows; group caps with conflicts; negative, zero and
2^31-scale demand (tests/test_scale_dtypes.py) on the staged problems
and on hand-built ones whose capacities are unbounded; a node axis
capped below need. For the comparison with the JAX package the staged
fixtures are padded, inertly, to one set of shapes with every optional
input present, so that the JAX package compiles `pack` and `pack_flat`
once per mode for all of them (the hand-built ones pass no optional
input). Then the port's own dense ≡ split oracle
(`pack_ref` against `pack_split_ref` on the staged problems) and the
port's `graft_entry.entry()` against `__graft_entry__.entry()`: the nine
argument arrays and all six outputs.

Tolerance: exact equality of every output's bytes; every pick is an
index-tie-broken arg-reduction and the float math is f32 in the JAX
order.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from karpenter_tpu.solver.pack import pack as jpack, pack_flat as jpack_flat
from karpenter_tpu_torch.graft_entry import entry
from karpenter_tpu_torch.solver import pack_dense, pack_split
from karpenter_tpu_torch.solver.encode import encoded_from_arrays
from karpenter_tpu_torch.solver.pack import stage
from karpenter_tpu_torch.testing import dense_case, split_mismatch
from test_pack_split_equivalence import _random_problem

OUTPUTS = ("assign", "node_mask", "node_used", "node_active", "node_count", "unsched")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensors; one intra-op thread keeps
    them from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- inputs


def _arrays(enc):
    """The JAX Encoded's array fields as numpy."""
    names = ("compat", "group_req", "group_count", "cfg_alloc", "cfg_price",
             "cfg_pool", "pool_overhead", "existing_used", "cfg_rsv",
             "rsv_cap", "group_cap", "conflict", "existing_quota")
    return {k: (None if getattr(enc, k) is None else np.asarray(getattr(enc, k)))
            for k in names}


def _staged(enc, mode, existing=None, max_nodes=256, quota=None):
    """The JAX encode staged by the port as a `testing.DenseCase`."""
    C = enc.compat.shape[1]
    R = enc.group_req.shape[1]
    mask, used = existing if existing is not None else (
        np.zeros((0, C), bool), np.zeros((0, R), np.float32))
    st = stage(encoded_from_arrays(_arrays(enc)), mask, used, max_nodes, quota)
    return dense_case(st, "", mode)


def _existing_rows(enc, seed, E=6):
    """test_pack_split_equivalence.py's one-hot rows at random fills."""
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


def _planned(mode):
    """test_pack_split_equivalence.py's planned slots with quotas."""
    enc = _random_problem(11)
    C = enc.compat.shape[1]
    R = enc.group_req.shape[1]
    G = enc.compat.shape[0]
    rng = np.random.default_rng(42)
    P = 8
    mask = np.zeros((P, C), bool)
    used = np.zeros((P, R), np.float32)
    launchable = np.flatnonzero(enc.cfg_pool >= 0)
    quota = np.zeros((P, G), np.int32)
    for p in range(P):
        c = int(rng.choice(launchable))
        mask[p, c] = True
        used[p] = enc.pool_overhead[enc.cfg_pool[c]]
        quota[p] = rng.integers(0, 5, size=G)
    return _staged(enc, mode, (mask, used), quota=quota)


def _caps_and_conflicts(seed, mode):
    """Per-node group caps (hostname spread) and pairwise conflicts
    (anti-affinity), with existing rows so their rows are clamped too."""
    enc = _random_problem(seed, reservations=seed % 2 == 1)
    G = enc.compat.shape[0]
    rng = np.random.default_rng(seed)
    enc.group_cap = rng.integers(1, 6, size=G).astype(np.int32)
    conflict = rng.random((G, G)) < 0.2
    conflict = conflict | conflict.T
    np.fill_diagonal(conflict, False)
    enc.conflict = conflict
    return _staged(enc, mode, _existing_rows(enc, seed))


def _demand(mode):
    """Negative, zero and 2^31-scale demand on a 256-row axis: the
    prefix fill saturates and the rest stays unschedulable."""
    enc = _random_problem(2)
    counts = np.asarray(enc.group_count).astype(np.int64)
    # the huge group is one with the smallest memory and cpu requests,
    # which the launchable configs hold
    req = np.asarray(enc.group_req)
    big, neg, zero = np.lexsort((req[:, 0], req[:, 1]))[:3]
    counts[neg] = -7
    counts[zero] = 0
    counts[big] = 0
    counts[big] = 2**31 - 1 - int(np.clip(counts, 0, None).sum()) - 1
    enc.group_count = counts.astype(np.int32)
    return _staged(enc, mode)


# the hand-built problems: one group, 32 configs, 2 resources, 4
# existing rows, 16 rows in all
RAW_E, RAW_N = 4, 16


def _zero_request(count):
    """A group requesting nothing: every open row's capacity is CAP_MAX
    (tests/test_scale_dtypes.py); four existing rows, no pool to open."""
    G, C, R, E = 1, 32, 2, RAW_E
    mask = np.zeros((E, C), bool)
    mask[np.arange(E), np.arange(E)] = True
    return (np.ones((G, C), bool), np.zeros((G, R), np.float32),
            np.array([count], np.int32), np.full((C, R), 8.0, np.float32),
            np.full((C,), -1, np.int32), np.zeros((1, R), np.float32),
            mask, np.zeros((E, R), np.float32), np.ones((C,), np.float32))


def _huge_fresh(count):
    """One group on the fresh axis only (the existing rows hold no
    config): opens stop at the node-axis cap and the rest reports
    unschedulable."""
    G, C, R, E = 1, 32, 2, RAW_E
    return (np.ones((G, C), bool), np.array([[1.0, 0.5]], np.float32),
            np.array([count], np.int32), np.full((C, R), 64.0, np.float32),
            np.zeros((C,), np.int32), np.zeros((1, R), np.float32),
            np.zeros((E, C), bool), np.zeros((E, R), np.float32),
            np.linspace(1, 2, C).astype(np.float32))


STAGED = {
    **{f"fresh-{s}-{m}": (lambda s=s, m=m: _staged(_random_problem(s), m))
       for s in (0, 1, 2, 3) for m in ("ffd", "cost")},
    **{f"reservations-{s}-{m}": (
        lambda s=s, m=m: _staged(_random_problem(s, reservations=True), m))
       for s in (5, 6) for m in ("ffd", "cost")},
    **{f"existing-{s}-{m}": (lambda s=s, m=m: _staged(
        _random_problem(s), m, _existing_rows(_random_problem(s), s)))
       for s in (7, 8) for m in ("ffd", "cost")},
    **{f"planned-quota-{m}": (lambda m=m: _planned(m)) for m in ("ffd", "cost")},
    **{f"caps-conflicts-{s}-{m}": (lambda s=s, m=m: _caps_and_conflicts(s, m))
       for s in (12, 13) for m in ("ffd", "cost")},
    **{f"demand-{m}": (lambda m=m: _demand(m)) for m in ("ffd", "cost")},
}

RAW = {
    **{f"zero-request-{n}-{m}": (lambda n=n, m=m: (*_zero_request(n), m))
       for n in (7, -5, 2**31 - 1) for m in ("ffd", "cost")},
    **{f"huge-fresh-{n}-{m}": (lambda n=n, m=m: (*_huge_fresh(n), m))
       for n in (2**31 - 1, 1_000_000, -3) for m in ("ffd", "cost")},
}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    """The staged fixture `name` as a `testing.DenseCase`."""
    return STAGED[name]()


@functools.lru_cache(maxsize=None)
def _staged_cases():
    """Every staged fixture padded to one set of shapes, with every
    optional input present, so that the JAX package compiles `pack` and
    `pack_flat` once per mode for all of them. The padding is inert:
    groups without demand, configs no group is compatible with and no
    pool launches, existing rows with no config, reservation slots no
    config draws on, quotas of 32767 (no cap; no row holds that many
    pods), group caps of 2^31 - 1 and no conflicts."""
    cases = {name: _fixture(name) for name in STAGED}
    Gp = max(c.args[0].shape[0] for c in cases.values())
    Cp = max(c.args[0].shape[1] for c in cases.values())
    E = max(c.Ep for c in cases.values())
    K = max(0 if c.kwargs["rsv_cap"] is None else c.kwargs["rsv_cap"].shape[0]
            for c in cases.values())
    N = max(c.max_nodes - c.Ep for c in cases.values()) + E

    def pad(x, shape, fill):
        out = np.full(shape, fill, x.dtype)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    out = {}
    for name, c in cases.items():
        (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         existing_mask, existing_used, cfg_price) = c.args
        R = group_req.shape[1]
        args = (pad(compat, (Gp, Cp), False), pad(group_req, (Gp, R), 0),
                pad(group_count, (Gp,), 0), pad(cfg_alloc, (Cp, R), 0),
                pad(cfg_pool, (Cp,), -1), pool_overhead,
                pad(existing_mask, (E, Cp), False),
                pad(existing_used, (E, R), 0), pad(cfg_price, (Cp,), 0))
        kw = c.kwargs
        quota = np.full((N, Gp), 32767, np.int16)
        if kw["quota"] is not None:
            quota[:c.Ep, :quota.shape[1]] = kw["quota"][:c.Ep]
        optional = {
            "quota": quota,
            "cfg_rsv": np.full((Cp,), -1, np.int32) if kw["cfg_rsv"] is None
            else pad(kw["cfg_rsv"], (Cp,), -1),
            "rsv_cap": np.zeros((K,), np.float32) if kw["rsv_cap"] is None
            else pad(kw["rsv_cap"], (K,), 0),
            "group_cap": np.full((Gp,), 2**31 - 1, np.int32) if kw["group_cap"] is None
            else pad(kw["group_cap"], (Gp,), 2**31 - 1),
            "conflict": np.zeros((Gp, Gp), bool) if kw["conflict"] is None
            else pad(kw["conflict"], (Gp, Gp), False),
        }
        out[name] = (args, optional, N, c.mode)
    return out


def _case(name):
    """(args, kwargs, max_nodes, mode) as numpy for fixture `name`."""
    if name in STAGED:
        return _staged_cases()[name]
    *args, mode = RAW[name]()
    return tuple(args), {}, RAW_N, mode


def _torch(args, kwargs):
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    return [put(a) for a in args], {k: put(v) for k, v in kwargs.items()}


def _jax(args, kwargs):
    return ([jnp.asarray(a) for a in args],
            {k: (None if v is None else jnp.asarray(v)) for k, v in kwargs.items()})


def _assert_same(ours, theirs):
    for name, a, b in zip(OUTPUTS, ours, theirs):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("name", [*STAGED, *RAW])
def test_plain_versions_equal_jax(name):
    args, kwargs, max_nodes, mode = _case(name)
    t_args, t_kw = _torch(args, kwargs)
    j_args, j_kw = _jax(args, kwargs)
    ours = pack_dense.pack_ref(*t_args, max_nodes=max_nodes, mode=mode, **t_kw)
    _assert_same(ours, jpack(*j_args, max_nodes=max_nodes, mode=mode, **j_kw))
    flat = pack_dense.pack_flat_ref(*t_args, max_nodes=max_nodes, mode=mode, **t_kw)
    j_flat = np.asarray(jpack_flat(*j_args, max_nodes=max_nodes, mode=mode, **j_kw))
    assert j_flat.dtype == np.uint32 and flat.dtype == torch.int32
    assert j_flat.tobytes() == flat.numpy().view(np.uint32).tobytes()
    if name.startswith(("demand-", "huge-fresh-2147483647", "huge-fresh-1000000")):
        # a node axis capped below need: every row opened, pods left over
        assert int(ours[4]) == max_nodes and int(ours[5].sum()) > 0
    if name.startswith("zero-request-7"):
        # first fit: all 7 pods on row 0, none fabricated
        assert int(ours[0][0, 0]) == 7 and int(ours[0][1:, 0].sum()) == 0


@pytest.mark.parametrize("name", list(STAGED))
def test_dense_equals_split(name):
    """The dense ≡ split oracle on the port's plain versions: B7 and B1
    on one problem place every pod alike, B7's rows past the bound
    block are B1's free rows and its bound rows stay one-hot."""
    c = _fixture(name)
    t_args, t_kw = _torch(c.args, c.kwargs)
    s_args, s_kw = _torch(c.split.args, c.split.kwargs)
    dense = pack_dense.pack_ref(*t_args, max_nodes=c.max_nodes, mode=c.mode, **t_kw)
    split = pack_split.pack_split_ref(*s_args, max_free=c.split.max_free,
                                      mode=c.mode, **s_kw)
    assert split_mismatch(dense, split, t_args[6]) is None


def test_entry_equals_graft_entry():
    """The port's entry() and the JAX package's: the same nine
    arguments (values and dtypes) and the same six outputs."""
    fn, args = entry(device="cpu")
    j_fn, j_args = __graft_entry__.entry()
    assert len(args) == len(j_args) == 9
    for a, b in zip(args, j_args):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes()
    assert fn.keywords == {"max_nodes": 128} == j_fn.keywords
    _assert_same(fn(*args), j_fn(*j_args))


def test_cpu_tensors_take_the_plain_version():
    args, kwargs, max_nodes, mode = _case("zero-request-7-ffd")
    t_args, _ = _torch(args, kwargs)
    pack_dense.reset_launch_counts()
    got = pack_dense.pack(*t_args, max_nodes=max_nodes, mode=mode)
    for a, b in zip(got, pack_dense.pack_ref(*t_args, max_nodes=max_nodes, mode=mode)):
        assert torch.equal(a, b)
    flat = pack_dense.pack_flat(*t_args, max_nodes=max_nodes, mode=mode)
    assert torch.equal(flat, pack_dense.pack_flat_ref(*t_args, max_nodes=max_nodes))
    assert set(pack_dense.LAUNCHES.values()) == {0}
    from karpenter_tpu_torch.solver import pack as port_pack

    assert port_pack.pack is pack_dense.pack and port_pack.pack_flat is pack_dense.pack_flat


def test_refusals():
    args, kwargs, max_nodes, mode = _case("zero-request-7-ffd")
    t_args, _ = _torch(args, kwargs)
    with pytest.raises(ValueError, match="no kernel"):
        pack_dense.pack(*[a.to("meta") for a in t_args], max_nodes=max_nodes)
    with pytest.raises(ValueError, match="existing rows"):
        pack_dense.pack_ref(*t_args, max_nodes=2)
    # the flat layout packs 32 configs to a word
    fn, e_args = entry(device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        pack_dense.pack_flat(*e_args, max_nodes=128)
