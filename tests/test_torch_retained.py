"""The retained fleet seam (`state/retained.py`), held against the JAX
package over one event stream.

`RetainedFleetSeam` serves the disruption engine's fleet snapshots
O(dirty): shallow-copied rows and `ExistingNodeInput`s per stable node,
refreshed by the watch stream's dirt. Over `testing.run_stream` rounds
(claims settling into nodes, seeded deletions and respawns, arrivals, a
DaemonSet, a dropped watch, a PDB) the port's seam must serve the JAX
package's rows and inputs, keep its dirt generations
(`node_version`, `pdb_epoch`) and report the same `status()`, with the
seam on and off (KARPENTER_DISRUPTION_SNAPSHOT=0) and with audits every
second serve; `note_mutated` and `invalidate_shards` act alike.
"""

from types import SimpleNamespace

import pytest

from karpenter_tpu_torch import testing


def jax_api():
    from karpenter_tpu.apis.v1 import labels, nodeclaim, nodepool
    from karpenter_tpu.cloudprovider import fake
    from karpenter_tpu.kube import client, objects
    from karpenter_tpu.metrics import store
    from karpenter_tpu.operator import options
    from karpenter_tpu.provisioning import provisioner
    from karpenter_tpu.state import cluster, retained, shards

    return SimpleNamespace(
        labels=labels, nodeclaim=nodeclaim, nodepool=nodepool, fake=fake,
        objects=objects, client=client, cluster=cluster,
        provisioner=provisioner, store=store, options=options,
        retained=retained, shards=shards,
    )


def port_api():
    from karpenter_tpu_torch.state import shards

    api = testing.package_api()
    api.shards = shards
    return api


PACKAGES = {"port": (port_api, {"device": "cpu"}), "jax": (jax_api, {})}
SMALL_TYPES = ("custom", (("c2", 2, 8, 2.0), ("c4", 4, 16, 3.0), ("c8", 8, 32, 5.0)), 1)


def fleet_case() -> testing.ProvisionCase:
    """`provision_cases`' plain round (existing nodes, bound pods, a
    daemonset) over a catalog of 2-8 cpu types, so that its pods open a
    fleet of small nodes."""
    plain = next(c for c in testing.provision_cases(0) if c.name == "plain")
    nodes = [dict(d, type=i + 1) for i, d in enumerate(plain.nodes)]
    return testing.ProvisionCase(
        "fleet", pods=[d for d in plain.pods if d["cpu"] <= 2.0],
        pools=plain.pools, catalog=SMALL_TYPES, nodes=nodes,
        daemonsets=plain.daemonsets)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("KARPENTER_DISRUPTION_SNAPSHOT", "KARPENTER_DISRUPTION_SNAPSHOT_AUDIT",
                 "KARPENTER_INCREMENTAL", "KARPENTER_STATE_SHARDS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """JAX compiles and the plain versions on one core, leaving the
    suite's other workers theirs (see test_torch_provisioning.py)."""
    with testing.one_core():
        yield


def _row(n) -> tuple:
    return (
        n.name,
        n.node.metadata.name if n.node is not None else "",
        n.node_claim.metadata.name if n.node_claim is not None else "",
        # nomination windows run on the wall clock: whether one is set
        n.marked_for_deletion, n.nominated_until > 0,
        tuple(sorted(n.pod_keys)),
        tuple(sorted((k, round(v, 6)) for k, v in n.pod_usage.items())),
        tuple(sorted((k, round(v, 6)) for k, v in n.daemon_usage.items())),
    )


def _input(key, inp) -> tuple:
    return (
        key, inp.name, inp.pool_name, inp.pod_count,
        tuple((t.key, t.value, t.effect) for t in inp.taints),
        repr(inp.requirements.signature()),
        tuple(sorted((k, round(v, 6)) for k, v in inp.available.items())),
    )


def serve(seam) -> tuple:
    rows, inputs = seam.fleet_snapshot()
    keys = sorted({r.name or (r.node_claim.metadata.name if r.node_claim else "")
                   for r in rows})
    return (
        [_row(r) for r in rows],
        sorted(_input(k, v) for k, v in inputs.items()),
        [(k, seam.node_version(k)) for k in keys],
        seam.pdb_epoch,
        seam.status(),
    )


def stream(package: str, retained: bool, monkeypatch) -> list:
    make, kwargs = PACKAGES[package]
    api = make()
    monkeypatch.setenv("KARPENTER_DISRUPTION_SNAPSHOT", "1" if retained else "0")
    monkeypatch.setenv("KARPENTER_DISRUPTION_SNAPSHOT_AUDIT", "2")
    testing.reset_counters(api)
    env = testing.build_env(fleet_case(), api, kube=testing.relisting_client(api),
                            **kwargs)
    seam = api.retained.RetainedFleetSeam(
        env.kube, env.cluster, pools_fn=env.provisioner.ready_pools_with_types,
        options=api.options.Options())
    served = []
    o = api.objects

    def on_round(k, results):
        served.append(serve(seam))
        served.append(serve(seam))  # nothing moved: every stable row a hit
        if k == 2:
            # a simulation committed pods onto two rows: re-copied
            keys = sorted(r.name for r in seam.fleet_snapshot()[0] if r.name)[:2]
            seam.note_mutated(keys)
            served.append(serve(seam))
        if k == 3:
            env.kube.create(o.PodDisruptionBudget(
                metadata=o.ObjectMeta(name="all", uid="uid-pdb-all"),
                spec=o.PodDisruptionBudgetSpec(
                    selector=o.LabelSelector.of({}), max_unavailable="50%")))
            served.append(serve(seam))
        if k == 4:
            names = sorted(r.name for r in seam.fleet_snapshot()[0] if r.name)
            seam.invalidate_shards({api.shards.shard_of(names[0])})
            served.append(serve(seam))

    rounds = [
        testing.StreamRound(settle=False),
        testing.StreamRound(),
        testing.StreamRound(delete=0.1, pick="seeded", seed=3),
        testing.StreamRound(add=[testing._pod(f"x-{i}", 0.5, 1.0) for i in range(12)]),
        testing.StreamRound(daemonset=dict(name="agent", cpu=0.05, mem=0.0625)),
        testing.StreamRound(relist=("Node",)),
        testing.StreamRound(delete=6, respawn=True, pick="seeded", seed=4),
        testing.StreamRound(),
    ]
    testing.run_stream(env, rounds, on_round=on_round)
    return served


@pytest.mark.parametrize("retained", [True, False], ids=["seam-on", "seam-off"])
def test_seam_serves_match_jax_over_a_stream(retained, clean):
    got = stream("port", retained, clean)
    want = stream("jax", retained, clean)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"serve {i} diverged"
    status = got[-1][-1]
    assert status["enabled"] is retained
    if retained:
        assert status["row_hits"] > 0 and status["audits"] > 0
        assert status["divergences"] == 0
    else:
        assert status["serves"] == 0 and status["retained_rows"] == 0


def test_seam_rows_equal_a_from_scratch_copy(clean):
    """Every retained serve equals `deep_copy_nodes()` row for row (what
    the seam's own audit holds) in the port itself."""
    api = port_api()
    testing.reset_counters(api)
    env = testing.build_env(fleet_case(), api, device="cpu")
    seam = api.retained.RetainedFleetSeam(
        env.kube, env.cluster, pools_fn=env.provisioner.ready_pools_with_types,
        options=api.options.Options())
    seen = []

    def on_round(k, results):
        for _ in range(2):
            rows, _ = seam.fleet_snapshot()
            fresh = env.cluster.deep_copy_nodes()
            seen.append(len(rows))
            assert [_row(r) for r in rows] == [_row(r) for r in fresh]

    testing.run_stream(env, [testing.StreamRound(settle=False), testing.StreamRound(),
                             testing.StreamRound(delete=0.2, pick="seeded", seed=1)],
                       on_round=on_round)
    assert seen[-1] > 5 and seam.status()["row_hits"] > 0
