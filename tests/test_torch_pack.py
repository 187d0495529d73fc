"""The port's packing kernels against the JAX package's, on CPU.

`pack_split_ref` and `pack_split_flat_ref` (the plain PyTorch versions
of kernels B1 and B2, `karpenter_tpu_torch/solver/pack_split.py`) run
on the same padded inputs as the JAX `pack_split` and
`pack_split_flat`: the JAX package encodes the problem, its arrays
reach the port through `encoded_from_arrays`, the port's `stage` pads
them, and both kernels take those padded arrays. The tolerance is
exact equality: every kernel choice is an index-tie-broken
arg-reduction and the float math is f32 in the same order, so the
outputs must be byte-identical.

Fixtures follow tests/test_pack_split_equivalence.py (fresh-only seeds
in both modes, reservations, existing rows, planned quota rows) plus
group caps, conflicts, and the overflow cases of
tests/test_scale_dtypes.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_tpu.cloudprovider.fake import GIB, instance_types, make_instance_type
from karpenter_tpu.solver.encode import encode, group_pods
from karpenter_tpu.solver.pack import pack_split, pack_split_flat
from karpenter_tpu.testing import mk_nodepool, mk_pod
from karpenter_tpu_torch.solver import pack_split as kernels
from karpenter_tpu_torch.solver.encode import encoded_from_arrays
from karpenter_tpu_torch.solver.pack import stage
from karpenter_tpu_torch import testing as _testing


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (the JAX package's wall-clock tests
    among them; see test_torch_provisioning.py)."""
    with _testing.one_core():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensors; one intra-op thread keeps
    them from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _random_problem(seed, n_pods=300, n_types=20, reservations=False):
    rng = np.random.default_rng(seed)
    if reservations:
        types = []
        for i in range(n_types):
            cpu = float(rng.choice([2, 4, 8, 16]))
            rsv = (
                [(f"rsv-{i}", "test-zone-1", int(rng.integers(1, 4)))]
                if rng.random() < 0.3
                else None
            )
            types.append(
                make_instance_type(
                    f"t-{i}", cpu=cpu, memory=cpu * 4 * GIB,
                    price=cpu * float(rng.uniform(0.8, 1.2)),
                    reservations=rsv,
                )
            )
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
        pods.append(mk_pod(name=f"p-{i}", cpu=cpu, memory=mem,
                           node_selector=sel))
    return encode(group_pods(pods), [(pool, types)], [])


def _arrays(enc):
    """The JAX Encoded's array fields as numpy."""
    names = ("compat", "group_req", "group_count", "cfg_alloc", "cfg_price",
             "cfg_pool", "pool_overhead", "existing_used", "cfg_rsv",
             "rsv_cap", "group_cap", "conflict", "existing_quota")
    return {k: (None if getattr(enc, k) is None else np.asarray(getattr(enc, k)))
            for k in names}


def _run_both(enc, existing_mask, existing_used, max_nodes, mode, quota=None):
    port_enc = encoded_from_arrays(_arrays(enc))
    staged = stage(port_enc, existing_mask, existing_used, max_nodes, quota)
    kw = {k: v for k, v in staged.kwargs.items()}
    j_args = [jnp.asarray(a) for a in staged.args]
    j_kw = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in staged.args]
    t_kw = {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in kw.items()}

    j_out = [np.asarray(x) for x in pack_split(
        *j_args, max_free=staged.max_free, mode=mode, **j_kw)]
    t_out = [x.numpy() for x in kernels.pack_split_ref(
        *t_args, max_free=staged.max_free, mode=mode, **t_kw)]
    for name, a, b in zip(("assign", "free_mask", "node_count", "unsched"),
                          j_out, t_out):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)

    j_flat = np.asarray(pack_split_flat(
        *j_args, max_free=staged.max_free, mode=mode, **j_kw))
    t_flat = kernels.pack_split_flat_ref(
        *t_args, max_free=staged.max_free, mode=mode, **t_kw).numpy()
    assert j_flat.dtype == np.uint32 and t_flat.dtype == np.int32
    assert j_flat.tobytes() == t_flat.view(np.uint32).tobytes()
    return t_out


def _no_existing(enc):
    C = enc.compat.shape[1]
    R = enc.group_req.shape[1]
    return np.zeros((0, C), bool), np.zeros((0, R), np.float32)


def _existing_rows(enc, seed, E=6):
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


class TestSplitAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_fresh_only(self, seed, mode):
        enc = _random_problem(seed)
        _run_both(enc, *_no_existing(enc), 256, mode)

    @pytest.mark.parametrize("seed", [5, 6])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_with_reservations(self, seed, mode):
        enc = _random_problem(seed, reservations=True)
        _run_both(enc, *_no_existing(enc), 256, mode)

    @pytest.mark.parametrize("seed", [7, 8])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_with_existing_rows(self, seed, mode):
        enc = _random_problem(seed)
        _run_both(enc, *_existing_rows(enc, seed), 256, mode)

    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_planned_quota_rows(self, mode):
        """Planned slots with per-group quotas (the LP path shape)."""
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
        _run_both(enc, mask, used, 256, mode, quota=quota)

    @pytest.mark.parametrize("seed", [12, 13])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_group_cap_and_conflict(self, seed, mode):
        """Per-node group caps (hostname spread) and pairwise conflicts
        (anti-affinity), with existing rows so the bound-row clamps
        run too."""
        enc = _random_problem(seed, reservations=seed % 2 == 1)
        G = enc.compat.shape[0]
        rng = np.random.default_rng(seed)
        enc.group_cap = rng.integers(1, 6, size=G).astype(np.int32)
        conflict = rng.random((G, G)) < 0.2
        conflict = conflict | conflict.T
        np.fill_diagonal(conflict, False)
        enc.conflict = conflict
        _run_both(enc, *_existing_rows(enc, seed), 256, mode)

    def test_node_axis_cap_leaves_pods_unschedulable(self):
        enc = _random_problem(3)
        assign, _, node_count, unsched = _run_both(enc, *_no_existing(enc), 32, "ffd")
        assert int(node_count) == 32
        assert int(unsched.sum()) > 0


def _zero_req_inputs(count, B=4):
    """A group requesting nothing against B bound rows: every row's
    capacity is CAP_MAX (tests/test_scale_dtypes.py)."""
    G, C, R, F = 1, 32, 2, 16
    return (
        np.ones((G, C), bool), np.zeros((G, R), np.float32),
        np.array([count], np.int32), np.full((C, R), 8.0, np.float32),
        np.full((C,), -1, np.int32), np.zeros((1, R), np.float32),
        np.ones((G, B), bool), np.full((B, R), 8.0, np.float32),
        np.zeros((B, R), np.float32), np.zeros((B,), np.int32),
        np.ones((B,), bool), np.ones((C,), np.float32),
    ), F


def _huge_fresh_inputs(count):
    """One group of `count` pods on the fresh axis only: opens stop at
    the node-axis cap and the rest report unschedulable."""
    G, C, R, F = 1, 32, 2, 8
    alloc = np.full((C, R), 64.0, np.float32)
    return (
        np.ones((G, C), bool), np.array([[1.0, 0.5]], np.float32),
        np.array([count], np.int32), alloc,
        np.zeros((C,), np.int32), np.zeros((1, R), np.float32),
        np.zeros((G, 0), bool), np.zeros((0, R), np.float32),
        np.zeros((0, R), np.float32), np.zeros((0,), np.int32),
        np.zeros((0,), bool), np.linspace(1, 2, C).astype(np.float32),
    ), F


class TestOverflowCases:
    @pytest.mark.parametrize("builder,count", [
        (_zero_req_inputs, 7),
        (_zero_req_inputs, -5),
        (_zero_req_inputs, 2**31 - 1),
        (_huge_fresh_inputs, 2**31 - 1),
        (_huge_fresh_inputs, 1_000_000),
        (_huge_fresh_inputs, -3),
    ])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_flat_buffer_identical(self, builder, count, mode):
        args, F = builder(count)
        j = np.asarray(pack_split_flat(*[jnp.asarray(a) for a in args],
                                       max_free=F, mode=mode))
        t = kernels.pack_split_flat_ref(*[torch.from_numpy(a) for a in args],
                                        max_free=F, mode=mode).numpy()
        assert j.tobytes() == t.view(np.uint32).tobytes()

    def test_zero_request_group_fills_first_row_only(self):
        args, F = _zero_req_inputs(7)
        assign, _, _, unsched = kernels.pack_split_ref(
            *[torch.from_numpy(a) for a in args], max_free=F)
        assert int(assign[0, 0]) == 7
        assert int(assign[1:, 0].sum()) == 0
        assert int(unsched.sum()) == 0


def _naive_take(k, remaining):
    k64 = np.asarray(k, np.int64)
    prefix = np.cumsum(k64) - k64
    return np.clip(remaining - prefix, 0, k64)


class TestPrefixTake:
    @pytest.mark.parametrize("remaining", [0, 1, 37, 1_000, 2**31 - 1, -5])
    def test_matches_naive(self, remaining):
        rng = np.random.default_rng(remaining % 97)
        k = rng.integers(0, 500, size=200).astype(np.int32)
        k[::17] = int(kernels.CAP_MAX)
        got = kernels._prefix_take_ref(torch.from_numpy(k), remaining).numpy()
        np.testing.assert_array_equal(got, _naive_take(k, remaining))


class TestFlatWords:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bit_layout(self, seed):
        """Bit i of word w is column 32w+i; bit 31 set when column
        32w+31 is true; assign, node_count and unsched follow the JAX
        layout."""
        rng = np.random.default_rng(seed)
        N, G, F, C = 12, 5, 7, 64
        assign = rng.integers(0, 9, size=(N, G)).astype(np.int32)
        mask = rng.random((F, C)) < 0.5
        mask[:, 31] = True
        unsched = rng.integers(0, 3, size=G).astype(np.int32)
        out = kernels.pack_flat_words_ref(
            torch.from_numpy(assign), torch.from_numpy(mask),
            torch.tensor(9, dtype=torch.int32), torch.from_numpy(unsched),
        ).numpy().view(np.uint32)
        words = out[N * G: N * G + F * 2].reshape(F, 2)
        for f in range(F):
            for c in range(C):
                assert bool((words[f, c // 32] >> (c % 32)) & 1) == mask[f, c]
        np.testing.assert_array_equal(out[: N * G].reshape(N, G), assign)
        assert out[N * G + F * 2] == 9
        np.testing.assert_array_equal(out[N * G + F * 2 + 1:], unsched)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version(self):
        kernels.reset_launch_counts()
        args, F = _zero_req_inputs(7)
        flat = kernels.pack_split_flat(*[torch.from_numpy(a) for a in args],
                                       max_free=F)
        ref = kernels.pack_split_flat_ref(*[torch.from_numpy(a) for a in args],
                                          max_free=F)
        assert torch.equal(flat, ref)
        assert set(kernels.LAUNCHES.values()) == {0}

    def test_other_devices_raise(self):
        args, F = _zero_req_inputs(7)
        meta = [torch.from_numpy(a).to("meta") for a in args]
        with pytest.raises(ValueError, match="no kernel"):
            kernels.pack_split(*meta, max_free=F)
