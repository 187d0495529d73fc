"""PodDisruptionBudget limits and the eviction subresource, held against
the JAX package.

`karpenter_tpu_torch/utils/pdb.py` (`PdbLimits`, `_scaled`) and
`KubeClient.evict` must answer exactly as the JAX package's on the same
seeded world: integer and percent `minAvailable` / `maxUnavailable`,
unhealthy (unbound, terminating, terminal) pods, several PDBs selecting
one pod, mirror, daemonset, do-not-disrupt and disrupted-taint-tolerating
pods, and the API server's view (`server_side=True`). Evictions go
through the store's check: a blocked one raises `EvictionBlockedError`
naming the PDB, an allowed one is a graceful delete (finalizer semantics
included), and the budget shrinks as pods leave.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu_torch import testing


def jax_api():
    from karpenter_tpu.apis.v1 import labels
    from karpenter_tpu.kube import client, objects
    from karpenter_tpu.utils import pdb

    return SimpleNamespace(labels=labels, client=client, objects=objects, pdb=pdb)


def port_api():
    api = testing.package_api()
    return SimpleNamespace(labels=api.labels, client=api.client,
                           objects=api.objects, pdb=api.pdb)


APIS = {"port": port_api, "jax": jax_api}
BUDGETS = [("min", 1), ("min", 3), ("min", "50%"), ("min", "100%"),
           ("min", "34%"), ("max", 0), ("max", 1), ("max", "25%"),
           ("max", "60%"), ("none", None)]


def world(seed: int) -> dict:
    """Pods and PDBs as plain values, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(40):
        app = f"app-{int(rng.integers(4))}"
        kind = ("ReplicaSet", "ReplicaSet", "ReplicaSet", "DaemonSet", "Node",
                "")[int(rng.integers(6))]
        pods.append(dict(
            name=f"p-{i}", ns=("default", "batch")[int(rng.integers(2)) if i % 5 == 0 else 0],
            labels={"app": app, "tier": ("web", "db")[int(rng.integers(2))]},
            owner=kind,
            node=f"n-{int(rng.integers(5))}" if rng.random() < 0.8 else "",
            phase=("Running", "Running", "Running", "Succeeded", "Failed")[
                int(rng.integers(5))] if rng.random() < 0.2 else "Running",
            terminating=bool(rng.random() < 0.1),
            do_not_disrupt=bool(rng.random() < 0.1),
            tolerates=bool(rng.random() < 0.1),
            finalizer=bool(rng.random() < 0.2),
        ))
    pdbs = []
    for j in range(6):
        which, value = BUDGETS[int(rng.integers(len(BUDGETS)))]
        sel = {"app": f"app-{int(rng.integers(4))}"}
        if rng.random() < 0.3:
            sel["tier"] = "web"
        pdbs.append(dict(name=f"pdb-{j}", ns="default", selector=sel,
                         which=which, value=value))
    # a second budget over one app: its pods are refused outright
    pdbs.append(dict(name="pdb-overlap", ns="default", selector={"app": "app-0"},
                     which="max", value=5))
    return {"pods": pods, "pdbs": pdbs}


def build(api, w: dict):
    o, lb = api.objects, api.labels
    kube = api.client.KubeClient()
    for d in w["pods"]:
        refs = ([o.OwnerReference(kind=d["owner"], name=f"{d['name']}-o",
                                  uid=f"uid-{d['name']}-o", controller=True)]
                if d["owner"] else [])
        ann = {lb.DO_NOT_DISRUPT_ANNOTATION: "true"} if d["do_not_disrupt"] else {}
        tol = ([o.Toleration(key=lb.DISRUPTED_NO_SCHEDULE_TAINT.key,
                             operator="Exists")] if d["tolerates"] else [])
        pod = o.Pod(
            metadata=o.ObjectMeta(
                name=d["name"], namespace=d["ns"], uid=f"uid-{d['name']}",
                labels=dict(d["labels"]), annotations=ann,
                owner_references=refs, creation_timestamp=testing.CASE_T0,
                finalizers=["test/hold"] if d["finalizer"] else []),
            spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.5})],
                           node_name=d["node"], tolerations=tol))
        pod.status.phase = d["phase"]
        if d["terminating"]:
            pod.metadata.deletion_timestamp = testing.CASE_T0
        kube.create(pod)
    for d in w["pdbs"]:
        spec = o.PodDisruptionBudgetSpec(selector=o.LabelSelector.of(d["selector"]))
        if d["which"] == "min":
            spec.min_available = d["value"]
        elif d["which"] == "max":
            spec.max_unavailable = d["value"]
        kube.create(o.PodDisruptionBudget(
            metadata=o.ObjectMeta(name=d["name"], namespace=d["ns"],
                                  uid=f"uid-{d['name']}"),
            spec=spec))
    return kube


def verdicts(api, kube, memoize: bool = False) -> dict:
    limits = api.pdb.PdbLimits(kube, memoize_allowance=memoize)
    pods = sorted(kube.pods(), key=lambda p: p.key)
    return {
        "allowed": [(p.key, limits.disruptions_allowed(p))
                    for p in sorted(limits.pdbs, key=lambda p: p.key)],
        "matching": [(p.key, sorted(b.key for b in limits.matching(p))) for p in pods],
        "can_evict": [(p.key, limits.can_evict(p)) for p in pods],
        "server_side": [(p.key, limits.can_evict(p, server_side=True)) for p in pods],
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("memoize", [False, True])
def test_pdb_limits_match_jax(seed, memoize):
    w = world(seed)
    got = verdicts(port_api(), build(port_api(), w), memoize)
    want = verdicts(jax_api(), build(jax_api(), w), memoize)
    assert got == want
    # the seeded worlds reach both answers of every question
    assert any(v is None for _, v in got["can_evict"])
    assert any(v is not None for _, v in got["can_evict"])


@pytest.mark.parametrize("value,total,round_up", [
    (3, 10, True), ("3", 10, False), ("50%", 7, True), ("50%", 7, False),
    ("34%", 3, True), ("34%", 3, False), ("100%", 0, True), ("0%", 9, False),
])
def test_scaled_matches_jax(value, total, round_up):
    assert port_api().pdb._scaled(value, total, round_up) == \
        jax_api().pdb._scaled(value, total, round_up)


def evictions(api, w: dict, seed: int) -> list:
    """Every pod evicted in a seeded order: per attempt the pod, the
    refusal (the blocking PDB key) or the pod's state afterwards."""
    kube = build(api, w)
    order = np.random.default_rng(seed).permutation(len(w["pods"]))
    out = []
    for i in order:
        d = w["pods"][int(i)]
        pod = kube.get_pod(d["ns"], d["name"])
        if pod is None:
            continue
        try:
            kube.evict(pod, now=testing.CASE_T0 + 5)
        except api.client.EvictionBlockedError as err:
            out.append((pod.key, "blocked", err.pdb))
            continue
        live = kube.get_pod(d["ns"], d["name"])
        out.append((pod.key, "gone" if live is None else
                    f"terminating@{live.metadata.deletion_timestamp}"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evict_matches_jax(seed):
    w = world(seed)
    got = evictions(port_api(), w, seed)
    assert got == evictions(jax_api(), w, seed)
    kinds = {r[1].split("@")[0] for r in got}
    assert {"blocked", "gone", "terminating"} <= kinds


def test_evict_blocked_raises_and_allowed_deletes_gracefully():
    api = port_api()
    o = api.objects
    kube = api.client.KubeClient()
    for i in range(3):
        kube.create(o.Pod(
            metadata=o.ObjectMeta(name=f"w-{i}", uid=f"uid-w-{i}", labels={"app": "w"},
                                  finalizers=["test/hold"] if i == 0 else []),
            spec=o.PodSpec(node_name="n-0")))
    kube.create(o.PodDisruptionBudget(
        metadata=o.ObjectMeta(name="w", uid="uid-pdb-w"),
        spec=o.PodDisruptionBudgetSpec(selector=o.LabelSelector.of({"app": "w"}),
                                       min_available=2)))
    # one disruption allowed: the pod with a finalizer goes terminating
    kube.evict(kube.get_pod("default", "w-0"), now=7.0)
    held = kube.get_pod("default", "w-0")
    assert held is not None and held.metadata.deletion_timestamp == 7.0
    # it no longer counts as healthy: the budget is spent
    with pytest.raises(api.client.EvictionBlockedError) as err:
        kube.evict(kube.get_pod("default", "w-1"))
    assert err.value.pdb == "default/w"
    assert kube.get_pod("default", "w-1") is not None
    # the finalizer leaves: the pod goes, and the budget still holds
    kube.remove_finalizer(held, "test/hold")
    assert kube.get_pod("default", "w-0") is None
    with pytest.raises(api.client.EvictionBlockedError):
        kube.evict(kube.get_pod("default", "w-2"))
