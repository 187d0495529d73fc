"""The port's state-plane shards held against the JAX package's.

`state/shards.py` is a pure function of the key (crc32, never the
salted `hash()`), so the port's routes must equal the JAX package's for
every key, kind and shard count. `KubeClient.deliver(shard=)` drains
one shard's logical stream and leaves the others queued, in order; the
dirty sets a DirtyTracker sees must not depend on which shard drains
first, in either package.
"""

import zlib

import pytest

from karpenter_tpu.kube import client as jclient
from karpenter_tpu.kube import dirty as jdirty
from karpenter_tpu.kube import objects as jobjects
from karpenter_tpu.state import shards as jshards
from karpenter_tpu_torch.kube import client, dirty, objects
from karpenter_tpu_torch.state import shards

PACKAGES = {
    "port": (shards, client, dirty, objects),
    "jax": (jshards, jclient, jdirty, jobjects),
}
KEYS = ("node-1", "default/web-0", "zz", "", "default-00017",
        "node-claim-3", "ns/pod-with-a-much-longer-name-0042")
COUNTS = (1, 2, 3, 8, 13)


def _pod(o, name: str, node: str = ""):
    pod = o.Pod(metadata=o.ObjectMeta(name=name, uid=f"uid-{name}"),
                spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.5})]))
    pod.spec.node_name = node
    return pod


class TestRouting:
    @pytest.mark.parametrize("n", COUNTS)
    def test_shard_of_is_crc32_and_equals_jax(self, n):
        for key in KEYS:
            assert shards.shard_of(key, n) == jshards.shard_of(key, n)
            want = 0 if n <= 1 else zlib.crc32(key.encode()) % n
            assert shards.shard_of(key, n) == want

    def test_shard_count_env(self, monkeypatch):
        for raw, want in (("", shards.DEFAULT_SHARDS), ("3", 3), ("0", 1),
                          ("junk", shards.DEFAULT_SHARDS)):
            if raw:
                monkeypatch.setenv("KARPENTER_STATE_SHARDS", raw)
            else:
                monkeypatch.delenv("KARPENTER_STATE_SHARDS", raising=False)
            assert shards.shard_count() == jshards.shard_count() == want
        assert shards.SHARDED_KINDS == jshards.SHARDED_KINDS
        assert shards.ENV_SHARDS == jshards.ENV_SHARDS

    @pytest.mark.parametrize("n", COUNTS)
    def test_event_routes_equal_jax(self, n):
        """A bound pod routes by its node, an unbound one by its key, a
        claim by its node once registered, a node by its name: the same
        shard in both packages, and a bound pod shares its node's."""
        routes = {}
        for name, (sh, _, _, o) in PACKAGES.items():
            from importlib import import_module

            nc = import_module(
                ("karpenter_tpu_torch" if name == "port" else "karpenter_tpu")
                + ".apis.v1.nodeclaim")
            claim = nc.NodeClaim(metadata=o.ObjectMeta(name="default-00017",
                                                       namespace=""))
            node = o.Node(metadata=o.ObjectMeta(name="node-7", namespace=""))
            out = []
            for kind, obj in (("Pod", _pod(o, "w-0")),
                              ("Pod", _pod(o, "w-1", node="node-7")),
                              ("Node", node), ("NodeClaim", claim)):
                out.append((sh.route_key(kind, obj),
                            sh.shard_of_event(kind, obj, n)))
            claim.status.node_name = "node-7"
            out.append((sh.route_key("NodeClaim", claim),
                        sh.shard_of_event("NodeClaim", claim, n)))
            routes[name] = out
        assert routes["port"] == routes["jax"]
        assert routes["port"][1] == routes["port"][2] == routes["port"][4]
        assert routes["port"][0][0] == "default/w-0"


def _names_in_distinct_shards(n_shards: int) -> tuple[str, str]:
    if n_shards == 1:
        return "node-a", "node-b"
    for i in range(256):
        other = f"node-{i}"
        if shards.shard_of(other, n_shards) != shards.shard_of("node-a", n_shards):
            return "node-a", other
    raise AssertionError("crc32 cannot be this degenerate")


class TestCrossShardOrdering:
    @pytest.mark.parametrize("n_shards", [1, 2, 8])
    def test_order_across_shards_is_immaterial(self, monkeypatch, n_shards):
        """A pod event bound to one shard's node and a node event on
        another shard, delivered shard by shard in both orders: the
        same dirty set, in both packages."""
        monkeypatch.setenv("KARPENTER_STATE_SHARDS", str(n_shards))
        name_a, name_b = _names_in_distinct_shards(n_shards)
        shard_a = shards.shard_of(name_a, n_shards)
        shard_b = shards.shard_of(name_b, n_shards)

        def run(pkg, order):
            _, cl, dt, o = pkg
            kube = cl.KubeClient(async_delivery=True)
            tracker = dt.DirtyTracker(kube).watch("Pod", "Node")
            kube.create(_pod(o, "w-0", node=name_a))
            kube.create(o.Node(metadata=o.ObjectMeta(name=name_b)))
            delivered = [kube.deliver(shard=s) for s in order]
            delivered.append(kube.deliver())
            return tracker.drain("Pod") | tracker.drain("Node"), delivered

        got = {name: [run(pkg, (shard_a, shard_b)), run(pkg, (shard_b, shard_a))]
               for name, pkg in PACKAGES.items()}
        assert got["port"] == got["jax"]
        forward, backward = got["port"]
        assert forward[0] == backward[0]
        assert {"default/w-0", name_b} <= forward[0]

    @pytest.mark.parametrize("n_shards", [2, 8])
    def test_shard_scoped_delivery_holds_other_shards(self, monkeypatch, n_shards):
        """deliver(shard=s) drains only s's stream, up to `limit` events
        in order, and leaves the rest queued; the port's counts and
        dirty sets equal the JAX package's."""
        monkeypatch.setenv("KARPENTER_STATE_SHARDS", str(n_shards))
        name_a, name_b = _names_in_distinct_shards(n_shards)
        shard_a = shards.shard_of(name_a, n_shards)

        def run(pkg):
            _, cl, dt, o = pkg
            kube = cl.KubeClient(async_delivery=True)
            tracker = dt.DirtyTracker(kube).watch("Node", "Pod")
            kube.create(o.Node(metadata=o.ObjectMeta(name=name_a)))
            kube.create(o.Node(metadata=o.ObjectMeta(name=name_b)))
            for i in range(3):
                kube.create(_pod(o, f"p-{i}", node=name_a))
            steps = [kube.deliver(shard=shard_a, limit=2),
                     sorted(tracker.drain("Node") | tracker.drain("Pod")),
                     kube.pending_events(["Node"]), kube.pending_events(["Pod"]),
                     kube.deliver(shard=shard_a),
                     sorted(tracker.drain("Node") | tracker.drain("Pod")),
                     kube.pending_events(), kube.deliver(),
                     sorted(tracker.drain("Node") | tracker.drain("Pod"))]
            return steps

        port, ref = run(PACKAGES["port"]), run(PACKAGES["jax"])
        assert port == ref
        assert port[0] == 2 and port[1] == sorted([name_a, "default/p-0"])
        assert port[2] == 1 and port[6] == 1
        assert port[8] == [name_b]
