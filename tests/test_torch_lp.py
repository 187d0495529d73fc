"""The cost objective's device programs, B4 and B5, against the JAX
package's, on the CPU.

B4 `lp_plan.price_kernel_ref` (the plain version of the pricing kernel)
against the JAX `_price_kernel` on seeded cases with exact density
ties, configs that fill to zero residual, demand caps and padded
shapes: q and value bit for bit equal (value is summed in the order
the JAX program sums it on the CPU), so the hits agree too.

B5 `lp_device._supergradient` (written out by hand) against
`jax.grad` of the JAX package's `bound_w` (lp_device.py:225, copied
below: it is local to `_ascend`), at random points and at constructed
ties: equal groups, all reservation excess zero, theta exactly at
_EPS and clamped to it, a zero-capacity valid axis. The whole ascent
`ascend_ref` against the JAX `_ascend` at 8 and 192 iterations on the
`test_lp_device.py` fixtures, and the float64 certificate from each;
split B5's `ascend_sharded_ref` against the JAX ascent on sharded
inputs; `solve` under KARPENTER_LP_SHARDS.

Tolerances: B4 exact. The supergradient: 1e-5 relative plus 1e-9
absolute (the two sum in different orders), and the same tie pattern
(which components are zero). The ascent, against the JAX program
with the port's step sizes: bit for bit, the best value included (the
bound's dot in the order of XLA's machine code); against the JAX `_ascend`
itself, whose step sizes come from the CPU's rsqrt estimate: the best
bound within 1e-6 relative, the duals within 1e-6 of the largest, the
certified bound within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import (
    heterogeneous_instance_types as jheterogeneous_instance_types,
    instance_types as jinstance_types,
)
from karpenter_tpu.solver import lp_device as jlp_device
from karpenter_tpu.solver import lp_plan as jlp_plan
from karpenter_tpu.solver.encode import encode as jencode, group_pods as jgroup_pods
from karpenter_tpu.testing import mk_nodepool, mk_pod
from karpenter_tpu_torch.cloudprovider.fake import (
    GIB,
    heterogeneous_instance_types,
)
from karpenter_tpu_torch.solver import lp_device, lp_plan
from karpenter_tpu_torch.testing import PRICE_CASES, price_case
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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- catalog


@pytest.mark.parametrize("count", [80, 400])
def test_heterogeneous_catalog_equals_the_jax_package(count):
    ours = heterogeneous_instance_types(count)
    theirs = jheterogeneous_instance_types(count)
    assert [it.name for it in ours] == [it.name for it in theirs]
    for a, b in zip(ours, theirs):
        assert a.capacity == b.capacity, a.name
        assert [(o.capacity_type, o.zone, o.price, o.available)
                for o in a.offerings] == [
            (o.capacity_type, o.zone, o.price, o.available)
            for o in b.offerings], a.name
        assert sorted(a.requirements.keys()) == sorted(b.requirements.keys())


# ---------------------------------------------------------------- B4


@pytest.mark.parametrize("case", PRICE_CASES, ids=lambda c: "G%d-C%d-R%d-%s" % c[1:])
def test_price_kernel_plain_equals_jax(case):
    lam, compat, req, alloc, count = price_case(*case)
    jq, jv = jlp_plan._price_kernel(*(jnp.asarray(x) for x in (lam, compat, req, alloc, count)))
    q, v = lp_plan.price_kernel(*(torch.from_numpy(x) for x in (lam, compat, req, alloc, count)))
    jq, jv = np.asarray(jq), np.asarray(jv)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))
    prices = np.random.default_rng(case[0]).uniform(0.0, 30.0, case[2]).astype(np.float32)
    assert np.array_equal(np.flatnonzero(v.numpy() > prices + 1e-6),
                          np.flatnonzero(jv > prices + 1e-6))
    assert q.sum() > 0
    if case[4] == "ties":
        # the exact-fill config took whole pods of group 0 (or a group
        # that ties it) and its residual reached zero on the cpu axis
        assert int(q[0].sum()) > 0
    if case[4] == "infinite-dual":
        # every config took group 0's whole demand, and is worth +inf
        assert (q[:, 0] == 5).all() and np.isposinf(v.numpy()).all()


@pytest.mark.parametrize("G", [32, 40, 194, 1100])
def test_row_value_sums_in_the_jax_order(G):
    rng = np.random.default_rng(G)
    q = rng.integers(0, 200, (57, G)).astype(np.int32)
    q[rng.random(q.shape) < 0.6] = 0
    lam = (rng.uniform(0, 3, G) * 10.0 ** rng.integers(-6, 3, G)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda q, l: (q.astype(jnp.float32) * l[None, :]).sum(axis=1))(q, lam))
    got = lp_plan.row_value(torch.from_numpy(q), torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------- B5


def _jax_bound_w(count, count_w, compat, req, alloc, price, valid_r,
                 cap_onehot, cap_budget, uncapped):
    """lp_device.py:214-237 of the JAX package, verbatim: bound_w is
    local to `_ascend`."""
    _EPS = jlp_device._EPS
    safe_req = jnp.where(req > 0, req, 1.0)
    live = count > 0

    def vhat_of(lam):
        ratio = jnp.where(
            (req > 0) & live[:, None], lam[:, None] / safe_req, 0.0
        )
        mm = jnp.max(
            jnp.where(compat[:, :, None], ratio[:, None, :], 0.0), axis=0
        )
        v = jnp.where(valid_r, mm * alloc, jnp.inf)
        vh = jnp.min(v, axis=1)
        return jnp.where(jnp.isfinite(vh), vh, 0.0)

    def bound_w(lam):
        vh = vhat_of(lam)
        theta = jnp.max(
            jnp.where(uncapped & (price > 0), vh / jnp.maximum(price, _EPS),
                      0.0)
        )
        theta = jnp.maximum(theta, _EPS)
        lam_s = lam / theta
        excess = jnp.clip(vh / theta - price, 0.0, None)
        mu = jnp.max(
            jnp.where(cap_onehot, excess[None, :], 0.0), axis=1
        )
        return lam_s @ count_w - mu @ cap_budget

    return bound_w


def _grads(inp: lp_device.AscentInputs, lam: np.ndarray):
    a = inp
    bound_w = _jax_bound_w(*(jnp.asarray(t.numpy()) for t in (
        a.count, a.count_w, a.compat, a.req, a.alloc, a.price, a.valid,
        a.onehot, a.budget, a.uncapped)))
    want = np.asarray(jax.grad(bound_w)(jnp.asarray(lam)))
    want_b = float(bound_w(jnp.asarray(lam)))
    k = lp_device._Consts(torch.device("cpu"))
    lam_t = torch.from_numpy(lam)
    f = lp_device._forward(a, lam_t, k)
    got = lp_device._supergradient(a, lam_t, f, k).numpy()
    return got, want, float(f["b"]), want_b


def _inputs(G, C, R, K, seed):
    """Random ascent inputs at padded-like shapes."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 20, G).astype(np.float32)
    count[rng.random(G) < 0.2] = 0
    t = torch.from_numpy
    compat = rng.random((G, C)) < 0.5
    slot = np.where(rng.random(C) < 0.3, rng.integers(0, max(K - 1, 1), C), -1)
    onehot = np.zeros((K, C), bool)
    for k in range(K):
        onehot[k] = slot == k
    price = rng.uniform(0.01, 2.0, C).astype(np.float32)
    price[slot >= 0] *= 1e-4
    price[-2:] = 0.0
    return lp_device.AscentInputs(
        lam0=t(rng.uniform(0.0, 1.0, G).astype(np.float32)),
        count=t(count), count_w=t(count * rng.choice([1.0, 0.75, 1.25], G).astype(np.float32)),
        compat=t(compat), req=t(rng.choice([0.0, 0.5, 1.0, 2.0], (G, R)).astype(np.float32)),
        alloc=t(rng.choice([0.0, 2.0, 4.0, 16.0], (C, R)).astype(np.float32)),
        price=t(price), valid=t(rng.random((C, R)) < 0.8),
        onehot=t(onehot), budget=t(rng.integers(0, 5, K).astype(np.float32)),
        uncapped=t((slot < 0) & (price > 0)),
    )


def _assert_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("seed", range(4))
def test_supergradient_equals_jax_grad_at_random_points(seed):
    inp = _inputs(40, 50, 4, 64, seed)
    lam = np.random.default_rng(100 + seed).uniform(0, 2, 40).astype(np.float32)
    got, want, b, want_b = _grads(inp, lam)
    _assert_grad(got, want)
    assert b == pytest.approx(want_b, rel=1e-6)


def _tie_inputs(kind):
    """Small problems whose supergradient sits on a tie."""
    G, C, R, K = 32, 32, 2, 64
    t = torch.from_numpy
    count = np.zeros(G, np.float32)
    count[:4] = [3, 3, 5, 2]
    req = np.zeros((G, R), np.float32)
    req[:4] = [[1, 1], [1, 1], [2, 1], [1, 2]]
    compat = np.zeros((G, C), bool)
    compat[:4, :4] = True
    # configs 4 and 5 hold one group each, so their value bounds move
    # apart from theta's
    compat[2, 4] = compat[1, 5] = True
    alloc = np.zeros((C, R), np.float32)
    alloc[:6] = [[4, 4], [8, 8], [4, 8], [8, 4], [2, 2], [16, 16]]
    price = np.zeros(C, np.float32)
    price[:6] = [0.2, 0.4, 0.3, 0.3, 0.1, 0.8]
    valid = np.zeros((C, R), bool)
    valid[:6] = True
    onehot = np.zeros((K, C), bool)
    budget = np.zeros(K, np.float32)
    lam = np.zeros(G, np.float32)
    lam[:4] = [0.09, 0.09, 0.08, 0.07]  # groups 0 and 1 are equal
    if kind == "excess-zero":
        # two reserved configs, priced below so that their excess
        # vh/theta - price is exactly zero
        onehot[0, 4] = onehot[1, 5] = True
        budget[:2] = [3, 2]
    elif kind == "theta-at-eps":
        # max_c vh/price is exactly _EPS: maximum(theta, _EPS) ties
        count[1:] = 0
        req[0] = [1, 0]
        compat[:] = False
        compat[0, 0] = True
        alloc[0] = [1, 0]
        valid[:] = False
        valid[0] = [True, False]
        price[:] = 0.0
        price[0] = 1.0
        lam[:] = 0.0
        lam[0] = np.float32(jlp_device._EPS)
    elif kind == "theta-clamped":
        lam[:] = 0.0
    elif kind == "zero-capacity-axis":
        # a valid axis with no capacity: vh = 0 on that config
        alloc[2] = [4, 0]
    uncapped = ~onehot.any(axis=0) & (price > 0)
    inp = lp_device.AscentInputs(
        lam0=t(lam.copy()), count=t(count), count_w=t(count.copy()),
        compat=t(compat), req=t(req), alloc=t(alloc), price=t(price),
        valid=t(valid), onehot=t(onehot), budget=t(budget),
        uncapped=t(uncapped))
    if kind == "excess-zero":
        f = lp_device._forward(inp, t(lam), lp_device._Consts(torch.device("cpu")))
        for c in (4, 5):
            price[c] = (f["vh"][c] / f["theta"]).item()
        inp.price = t(price)
        f = lp_device._forward(inp, t(lam), lp_device._Consts(torch.device("cpu")))
        assert (f["xe"][4:6] == 0).all() and (f["mu"][:2] == 0).all()
    return inp, lam


@pytest.mark.parametrize("kind", ["equal-groups", "excess-zero", "theta-at-eps",
                                  "theta-clamped", "zero-capacity-axis"])
def test_supergradient_equals_jax_grad_at_ties(kind):
    inp, lam = _tie_inputs(kind)
    got, want, b, want_b = _grads(inp, lam)
    _assert_grad(got, want)
    assert b == pytest.approx(want_b, rel=1e-6, abs=1e-12)
    if kind == "equal-groups":
        # groups 0 and 1 both attain the max on the shared configs
        f = lp_device._forward(inp, torch.from_numpy(lam),
                               lp_device._Consts(torch.device("cpu")))
        assert (f["X"][0, :4] == f["mm"][:4]).all()
        assert (f["X"][1, :4] == f["mm"][:4]).all()


def build_enc(seed: int, n_pods: int = 400, n_types: int = 24,
              hetero: bool = False, priorities: bool = False,
              reservations: bool = False):
    """`tests/test_lp_device.py::build_enc`, plus an option that puts
    capacity reservations on three types."""
    from karpenter_tpu.cloudprovider.fake import make_instance_type

    shapes = [(0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0), (2.0, 0.5),
              (0.25, 4.0), (1.0, 6.0)]
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    rng = np.random.default_rng(seed)
    pool = mk_nodepool("default")
    types = (jheterogeneous_instance_types(n_types) if hetero
             else jinstance_types(n_types))
    if reservations:
        for i in (3, 4, 9):
            it = types[i]
            types[i] = make_instance_type(
                it.name, cpu=it.capacity["cpu"], memory=it.capacity["memory"],
                pods=it.capacity["pods"],
                arch=it.requirements.get("kubernetes.io/arch").any_value(),
                os=it.requirements.get("kubernetes.io/os").any_value(),
                reservations=[(f"rsv-{i}", "test-zone-1", 3)])
    pods = []
    for i in range(n_pods):
        cpu, mem = shapes[int(rng.integers(len(shapes)))]
        selector = None
        if rng.random() < 0.2:
            selector = {"topology.kubernetes.io/zone": zones[int(rng.integers(3))]}
        pod = mk_pod(name=f"lp-{seed}-{i}", cpu=cpu, memory=mem * GIB,
                     node_selector=selector)
        if priorities:
            pod.spec.priority = int(rng.choice([0, 0, 100, -50]))
        pods.append(pod)
    return jencode(jgroup_pods(pods), [(pool, types)])


ASCENT_FIXTURES = [
    dict(seed=7), dict(seed=13, hetero=True), dict(seed=41, priorities=True),
    dict(seed=17, reservations=True),
]


def _jax_ascend_with_steps():
    """The JAX package's `_ascend`, from its own source, with one line
    changed: the step size `eta = 0.5 / jnp.sqrt(1.0 + t)` is read from
    a table argument. XLA on the CPU rewrites 0.5 / sqrt into 0.5 *
    rsqrt and computes rsqrt as the x86 estimate (`rsqrtss`) refined by
    two Newton steps, whose last bit depends on the CPU's estimate
    table: 49 of the first 200 steps differ by an ulp from the correctly
    rounded 0.5 / sqrt(1 + t) the port (and the CUDA kernel, with
    __fsqrt_rn and __fdiv_rn) takes. Fed the port's steps, the program
    is otherwise the JAX package's, reductions, fusions and all."""
    import functools
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(jlp_device._ascend.__wrapped__))
    src = src[src.index("def _ascend("):]
    for old, new in (("cap_onehot, cap_budget, uncapped, n_iters):",
                      "cap_onehot, cap_budget, uncapped, eta_tab, n_iters):"),
                     ("eta = 0.5 / jnp.sqrt(1.0 + t)", "eta = eta_tab[t]")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    ns = {"_EPS": jlp_device._EPS, "__import__": __import__}
    exec(src, ns)
    return jax.jit(ns["_ascend"], static_argnames=("n_iters",))


_STEPPED = {}


def _stepped_ascend(args, n_iters, mesh=None):
    """`_jax_ascend_with_steps` on `args`, the steps the port's
    (replicated on `mesh` when the args are sharded)."""
    if "fn" not in _STEPPED:
        _STEPPED["fn"] = _jax_ascend_with_steps()
    tab = (0.5 / lp_device._sqrt_rn(1.0 + torch.arange(n_iters, dtype=torch.float32))).numpy()
    tab = jnp.asarray(tab)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        tab = jax.device_put(tab, NamedSharding(mesh, P()))
    return _STEPPED["fn"](*args, tab, n_iters=n_iters)


def _ulps(a: float, b: float) -> int:
    """Distance in float32 ulps between two float32 values."""
    ia, ib = (int(np.array(x, np.float32).view(np.int32)) for x in (a, b))
    return abs(ia - ib)


def _certs(lam, jlam, st):
    args = (st["count"], st["compat"], st["req"], st["alloc"], st["price"],
            st["valid_r"], st["cap_slot"], st["cap_budget"])
    return (lp_device._certify(np.asarray(lam, np.float64)[: st["G"]], *args),
            jlp_device._certify(np.asarray(jlam, np.float64)[: st["G"]], *args))


@pytest.mark.parametrize("n_iters", [8, 192])
@pytest.mark.parametrize("fixture", ASCENT_FIXTURES, ids=lambda f: "-".join(
    f"{k}{v}" for k, v in f.items()))
def test_ascent_plain_version_against_jax(fixture, n_iters, request):
    """B5's plain version takes every sum in XLA's CPU order
    (`xla_sum`, `fma_chain`, `xla_dot`) and XLA's fused multiply-adds.
    Against the JAX program with the port's step sizes
    (`_jax_ascend_with_steps`): lambda, the last improving iteration,
    the float64 certificate and the best value bit for bit, at Gp = 32
    and at Gp = 79, where LLVM vectorizes the bound's dot
    `lam_s @ count_w` (`xla_dot` follows the order read from XLA's
    machine code: `dot_plan`, `dot_lane_order`). Against the JAX
    `_ascend` itself, whose steps come from the CPU's rsqrt estimate:
    the best value and the certificate within 1e-6 relative, lambda
    within 1e-6 of the largest (the gaps are recorded in the junit
    report)."""
    enc = build_enc(**fixture)
    st = lp_device._stage(enc)
    jst = jlp_device._stage(enc)
    for key in ("count", "count_w", "lam0", "price", "cap_budget"):
        np.testing.assert_array_equal(st[key], jst[key])
    inp = lp_device.ascent_inputs(st)
    args = [jnp.asarray(t.numpy()) for t in inp.tensors()]
    best, lam, last = lp_device.ascend(inp, n_iters)
    sbest, slam, slast = _stepped_ascend(args, n_iters)
    slam = np.asarray(slam)
    np.testing.assert_array_equal(lam.numpy().view(np.int32), slam.view(np.int32))
    assert int(last) == int(slast)
    cert, scert = _certs(lam.numpy(), slam, st)
    assert cert[4] == scert[4]
    assert _ulps(float(best), float(sbest)) == 0

    jbest, jlam, jlast = jlp_device._ascend(*args, n_iters=n_iters)
    assert float(best) == pytest.approx(float(jbest), rel=1e-6)
    jlam = np.asarray(jlam)
    scale = max(float(np.abs(jlam).max()), 1e-12)
    np.testing.assert_allclose(lam.numpy(), jlam, rtol=0, atol=1e-6 * scale)
    _, jcert = _certs(lam.numpy(), jlam, st)
    request.node.user_properties += [
        ("best_rel_gap", abs(float(best) - float(jbest)) / abs(float(jbest))),
        ("lam_gap_over_max", float(np.abs(lam.numpy() - jlam).max()) / scale),
        ("cert_rel_gap", abs(cert[4] - jcert[4]) / abs(jcert[4])),
        ("lam_bit_equal", f"{int((lam.numpy() == jlam).sum())}/{jlam.size}"),
        ("best_ulps_vs_stepped", _ulps(float(best), float(sbest))),
    ]
    assert cert[4] == pytest.approx(jcert[4], rel=1e-6)
    if fixture.get("reservations"):
        assert len(st["cap_budget"]) and inp.onehot.shape[0] == 64


@pytest.mark.parametrize("S", [2, 4])
def test_split_ascent_plain_version_against_jax(S):
    """`ascend_sharded_ref` (split B5: per-shard partial sums over
    configs added in shard order) against the JAX program on inputs
    sharded as lp_device.py:434-452 shards them over S of the 8 CPU
    devices, with the port's step sizes, on the reservation fixture (64
    cap rows, every reduction of the ascent in play): lambda, the last
    improving iteration, the certificate and the best value bit for bit
    at 192 iterations."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    enc = build_enc(**ASCENT_FIXTURES[3])
    st = lp_device._stage(enc)
    inp = lp_device.ascent_inputs(st, S)
    assert inp.compat.shape[1] % S == 0
    mesh = Mesh(np.array(jax.devices()[:S]), ("cfg",))
    spec = {3: P(None, "cfg"), 5: P("cfg", None), 6: P("cfg"),
            7: P("cfg", None), 8: P(None, "cfg"), 10: P("cfg")}
    args = [jax.device_put(jnp.asarray(t.numpy()), NamedSharding(mesh, spec.get(i, P())))
            for i, t in enumerate(inp.tensors())]
    sbest, slam, slast = _stepped_ascend(args, 192, mesh)
    best, lam, last = lp_device.ascend_sharded(
        lp_device.ShardedAscentInputs.split(inp, S), 192)
    assert best.shape == (S,) and lam.shape[0] == S
    slam = np.asarray(slam)
    np.testing.assert_array_equal(lam[0].numpy().view(np.int32), slam.view(np.int32))
    assert int(last[0]) == int(slast) and float(best[0]) == float(sbest)
    cert, scert = _certs(lam[0].numpy(), slam, st)
    assert cert[4] == scert[4]


def test_lp_shards_run_the_split_ascent(monkeypatch):
    """Under KARPENTER_LP_SHARDS=4 with 4 shard slots visible, `solve`
    takes the split ascent on a config axis padded to a multiple of 4;
    with fewer slots visible it takes the unsplit one (the JAX rule,
    lp_device.py:441). Its certificate agrees with the JAX package's
    split solve within the step sizes' gap."""
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh

    enc = build_enc(seed=17, reservations=True)
    calls = []
    real = lp_device.ascend_sharded

    def counted(a, n_iters):
        calls.append((a.shards, a.compat[0].shape[1] * a.shards))
        return real(a, n_iters)

    monkeypatch.setattr(lp_device, "ascend_sharded", counted)
    monkeypatch.setenv("KARPENTER_LP_SHARDS", "4")
    assert lp_device.lp_shards() == 4
    force_virtual_mesh(4)
    try:
        lp_device.reset()
        ours = lp_device.solve(enc, device="cpu")
    finally:
        force_virtual_mesh(0)
    assert calls and calls[0][0] == 4 and calls[0][1] % 4 == 0
    lp_device.reset()
    unsplit = lp_device.solve(enc, device="cpu")
    assert len(calls) == 1
    jlp_device.reset()
    theirs = jlp_device.solve(enc, shards=4)
    assert ours.lower_bound == pytest.approx(theirs.lower_bound, rel=1e-6)
    assert unsplit.lower_bound == pytest.approx(theirs.lower_bound, rel=1e-6)
    lp_device.reset()
    jlp_device.reset()
