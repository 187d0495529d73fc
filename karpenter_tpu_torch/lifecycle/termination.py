"""Node termination: taint -> drain -> volumes -> instance delete.

Copy of `karpenter_tpu/lifecycle/termination.py`.

Counterpart of pkg/controllers/node/termination (controller.go:91-190,
terminator/terminator.go, terminator/eviction.go): when a node carries
a deletion timestamp, taint it `disrupted:NoSchedule`, evict pods in
priority waves (non-critical non-daemon first, critical daemon last),
respect PDBs and the do-not-disrupt annotation (unless past the
nodeclaim's termination grace period), await volume detachment, then
remove the finalizer so the object — and through the nodeclaim
finalizer, the instance — goes away.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    DISRUPTED_NO_SCHEDULE_TAINT,
    DO_NOT_DISRUPT_ANNOTATION,
    NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION,
    TERMINATION_FINALIZER,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import COND_DRAINED, COND_VOLUMES_DETACHED
from karpenter_tpu_torch.kube.client import EvictionBlockedError, KubeClient
from karpenter_tpu_torch.kube.objects import Node, ObjectMeta, Pod


log = logging.getLogger("karpenter.termination")

CRITICAL_PRIORITY = 2_000_000_000  # system-cluster-critical threshold


# eviction retry limiter constants (terminator/eviction.go: the queue
# uses an item-exponential rate limiter, 100ms base / 10s cap, so a
# PDB-blocked pod is retried with backoff instead of hammered).
# Retries are jittered (full jitter above the base floor): a drain
# evicting dozens of pods behind one PDB blocks them all at the same
# instant, and un-jittered exponential backoff would re-hammer the
# eviction subresource with the whole cohort in lockstep forever.
EVICT_BACKOFF_BASE_SECONDS = 0.1
EVICT_BACKOFF_MAX_SECONDS = 10.0


def _jittered_backoff(attempts: int, rng=None) -> float:
    """Delay for the n-th consecutive 429 (1-based): the base floor
    plus full jitter up to the capped exponential. Attempt 1 is the
    deterministic base (an isolated 429 retries promptly); later
    attempts spread the cohort."""
    import random as _random

    from karpenter_tpu_torch.utils.backoff import capped_exponential

    cap = capped_exponential(
        attempts, EVICT_BACKOFF_BASE_SECONDS, EVICT_BACKOFF_MAX_SECONDS
    )
    r = (rng or _random).random()
    return EVICT_BACKOFF_BASE_SECONDS + r * (
        cap - EVICT_BACKOFF_BASE_SECONDS
    )


class EvictionQueue:
    """Per-pod eviction with PDB 429 backoff (terminator/eviction.go).

    Drain goes through the substrate's eviction subresource, so PDBs
    are enforced server-side; a 429 (EvictionBlockedError) records the
    pod with an exponential next-retry time and skips it until that
    elapses, mirroring the reference's rate-limited eviction workqueue.

    On the SIMULATION substrate only (no ReplicaSet controller or
    kube-scheduler behind the store), the queue additionally plays
    workload-owner: controller-owned non-daemon pods are resurrected
    as fresh pending pods, which the provisioner reschedules
    (typically onto replacement capacity the orchestration queue
    already launched). See _maybe_rebirth for the gating.
    """

    def __init__(self, kube: KubeClient, recorder=None, rng=None):
        self.kube = kube
        self.recorder = recorder
        self._rng = rng  # injectable for deterministic backoff tests
        self.blocked: dict[str, str] = {}  # pod key -> blocking pdb
        self._attempts: dict[str, int] = {}  # pod key -> 429 count
        self._retry_at: dict[str, float] = {}  # pod key -> next attempt
        # successors owed to finalizer-wedged pods: created the moment
        # the old pod finally leaves the store (prune), so a wedge
        # delays — never loses — the workload replica
        self._pending_rebirth: dict[str, Pod] = {}

    def evict(self, pod: Pod, now: Optional[float] = None, force: bool = False) -> bool:
        now = time.time() if now is None else now
        if not force:
            if now < self._retry_at.get(pod.key, 0.0):
                return False  # still backing off from the last 429
            try:
                # the eviction subresource: PDBs are enforced by the
                # API substrate, never re-checked client-side
                # (eviction.go:170-185)
                self.kube.evict(pod, now=now)
            except EvictionBlockedError as err:
                self.blocked[pod.key] = err.pdb
                n = self._attempts.get(pod.key, 0)
                self._attempts[pod.key] = n + 1
                self._retry_at[pod.key] = now + _jittered_backoff(
                    n + 1, rng=self._rng
                )
                return False
        else:
            # terminal bypass (stuck pods / past the grace deadline):
            # a direct delete, exactly the reference's forced path
            self.kube.delete(pod, now=now)
        self._forget(pod.key)
        self._record_evicted(pod, now)
        self._maybe_rebirth(pod)
        return True

    def _record_evicted(self, pod: Pod, now: float) -> None:
        if self.recorder is None:
            return
        from karpenter_tpu_torch.events.recorder import Event

        self.recorder.publish(Event(
            kind="Pod", name=pod.metadata.name,
            namespace=pod.metadata.namespace, type="Normal",
            reason="Evicted", message="Evicted pod from terminating node",
        ), now=now)  # terminator/events/events.go:37

    def _maybe_rebirth(self, pod: Pod) -> None:
        """Successor fabrication, STRICTLY gated to the simulation
        substrate: the in-memory store has no ReplicaSet controller or
        kube-scheduler behind it, so the queue plays workload-owner
        for controller-owned pods. On a real cluster
        (simulates_workload_controllers=False) the actual workload
        controller recreates replicas — creating pods there would
        duplicate them. Bare (ownerless) pods are never recreated:
        evicting one is terminal in a real cluster too.

        Rebirth waits until the old pod actually left the store: a pod
        wedged terminating (finalizers) still owns its name, and a
        real ReplicaSet would not have its successor admitted under a
        colliding identity either — the successor is OWED and created
        by prune() when the wedge finally clears. The debt is durable:
        the wedged pod is annotated so a restarted operator rebuilds
        the pending set from the store (restore())."""
        if not getattr(self.kube, "simulates_workload_controllers", False):
            return
        if pod.owner_kind() in ("", "DaemonSet", "Node"):
            return
        if self.kube.get_pod(
            pod.metadata.namespace, pod.metadata.name
        ) is None:
            self.kube.create(rebirth_pod(pod))
        else:
            if pod.metadata.annotations.get(REBIRTH_OWED_ANNOTATION) != "true":
                pod.metadata.annotations[REBIRTH_OWED_ANNOTATION] = "true"
                self.kube.touch(pod)
            self._pending_rebirth[pod.key] = rebirth_pod(pod)

    def _forget(self, pod_key: str) -> None:
        self.blocked.pop(pod_key, None)
        self._attempts.pop(pod_key, None)
        self._retry_at.pop(pod_key, None)

    def prune(self) -> None:
        """Drop bookkeeping for pods that no longer exist (the
        reference's queue removes items on pod deletion events), and
        deliver successors owed to since-cleared wedged pods.

        O(tracked), never O(fleet): liveness is answered per tracked
        key through the mirror's O(1) get_pod — the queue only ever
        holds pods of actively-draining nodes, so drain bookkeeping
        must not cost a 100k-pod set build per reconcile."""
        def gone(key: str) -> bool:
            ns, _, name = key.partition("/")
            return self.kube.get_pod(ns, name) is None

        for key in list(self.blocked.keys() | self._retry_at.keys()):
            if gone(key):
                self._forget(key)
        for key, successor in list(self._pending_rebirth.items()):
            if gone(key):
                del self._pending_rebirth[key]
                self.kube.create(successor)
        self._report_pending()

    def _report_pending(self) -> None:
        """Per-shard backlog gauge: a wedged drain shows up as ITS
        shard's backlog, not an anonymous total."""
        from karpenter_tpu_torch.metrics.store import STATE_SHARD_QUEUE_PENDING
        from karpenter_tpu_torch.state.shards import shard_count, shard_of

        shards = shard_count()
        counts = [0] * shards
        for key in self.blocked.keys() | self._retry_at.keys():
            counts[shard_of(key, shards)] += 1
        for s, n in enumerate(counts):
            STATE_SHARD_QUEUE_PENDING.set(
                float(n), {"queue": "evict", "shard": str(s)}
            )

    def restore(self) -> int:
        """Rebuild the owed-successor set from the store after a
        restart: any pod still wedged terminating with the rebirth-owed
        annotation re-enters _pending_rebirth (checkpoint/resume — the
        store is the durable record). Returns how many were owed."""
        n = 0
        if not getattr(self.kube, "simulates_workload_controllers", False):
            return 0  # real cluster: never fabricate pods (see above)
        for pod in self.kube.pods():
            if (
                pod.is_terminating()
                and pod.metadata.annotations.get(REBIRTH_OWED_ANNOTATION)
                == "true"
            ):
                self._pending_rebirth[pod.key] = rebirth_pod(pod)
                n += 1
        return n


def rebirth_pod(pod: Pod) -> Pod:
    """A controller-owned pod's successor: same spec, unbound, new uid."""
    import copy

    spec = copy.deepcopy(pod.spec)
    spec.node_name = ""
    annotations = dict(pod.metadata.annotations)
    annotations.pop(REBIRTH_OWED_ANNOTATION, None)
    return Pod(
        metadata=ObjectMeta(
            name=pod.metadata.name,
            namespace=pod.metadata.namespace,
            labels=dict(pod.metadata.labels),
            annotations=annotations,
            owner_references=list(pod.metadata.owner_references),
        ),
        spec=spec,
    )


def _critical(pod: Pod) -> bool:
    return (
        pod.spec.priority >= CRITICAL_PRIORITY
        or pod.spec.priority_class_name in ("system-cluster-critical", "system-node-critical")
    )


def _drain_waves(pods: list[Pod]) -> list[list[Pod]]:
    """Eviction order (terminator.go groupPodsByPriority, mirroring
    graceful node shutdown): non-critical non-daemon, non-critical
    daemon, critical non-daemon, critical daemon."""
    waves: list[list[Pod]] = [[], [], [], []]
    for pod in pods:
        daemon = pod.owner_kind() == "DaemonSet"
        crit = _critical(pod)
        idx = (2 if crit else 0) + (1 if daemon else 0)
        waves[idx].append(pod)
    return [w for w in waves if w]


REBIRTH_OWED_ANNOTATION = "karpenter.sh/rebirth-owed"


def _stuck_past_grace(pod: Pod, now: float) -> bool:
    """Terminating pod wedged past its grace period (nil grace = the
    k8s default 30s): bypassed by drain AND exempt from volume waits —
    it will die with the node, so neither it nor its volumes may hold
    the finalizer."""
    if not pod.is_terminating():
        return False
    grace = pod.spec.termination_grace_period_seconds
    grace = 30.0 if grace is None else grace
    return now >= (pod.metadata.deletion_timestamp or now) + grace


def _tolerates_disrupted(pod: Pod) -> bool:
    """Pods tolerating the karpenter.sh/disrupted:NoSchedule taint are
    NOT drained (IsDrainable, utils/pod): they opted to ride the node
    down, so they neither get evicted nor block drain completion."""
    from karpenter_tpu_torch.scheduling.taints import tolerates_pod

    return tolerates_pod([DISRUPTED_NO_SCHEDULE_TAINT], pod) is None


class TerminationController:
    def __init__(self, kube: KubeClient, cluster=None, recorder=None):
        from karpenter_tpu_torch.kube.dirty import DirtyTracker

        self.kube = kube
        self.cluster = cluster
        self.recorder = recorder
        self.queue = EvictionQueue(kube, recorder=recorder)
        self.queue.restore()  # owed rebirths survive operator restarts
        self.dirty = DirtyTracker(kube).watch("Node")
        # nodes mid-termination: drain retries and volume waits emit no
        # further node events, so they stay on the every-tick path
        # until their finalizer drops — empty in steady state
        self._terminating: set[str] = set()
        self._last_deleting_sweep = 0.0

    def reconcile(self, node: Node, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if node.metadata.deletion_timestamp is None:
            return
        if TERMINATION_FINALIZER not in node.metadata.finalizers:
            return

        # 1. taint so nothing new schedules (controller.go:91; terminator.go:55)
        if not any(t.key == DISRUPTED_NO_SCHEDULE_TAINT.key for t in node.spec.taints):
            node.spec.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
            self.kube.update(node)

        claim = self._claim_for(node)
        deadline = self._termination_deadline(claim)

        # 2. drain (terminator.go:96-180)
        remaining = self._drain(node, deadline, now)
        if remaining:
            # only THIS node's PDB-blocked pods justify the warning —
            # the queue is shared across every terminating node, and
            # pods merely riding out their grace period are fine
            this_blocked = [p for p in remaining
                            if p.key in self.queue.blocked]
            if self.recorder is not None and this_blocked:
                from karpenter_tpu_torch.events.recorder import Event

                self.recorder.publish(Event(
                    kind="Node", name=node.metadata.name, type="Warning",
                    reason="FailedDraining",
                    message=f"Failed to drain node, {len(remaining)} pods "
                            "are waiting to be evicted",
                ), now=now)  # terminator/events/events.go:57
            return  # wait for evictions / PDBs; retried next reconcile
        if claim is not None:
            claim.status_conditions.set_true(COND_DRAINED, now=now)

        # 3. volume detachment (controller.go:223-268)
        if not self._volumes_detached(node, now):
            if deadline is None or now < deadline:
                return
        if claim is not None:
            claim.status_conditions.set_true(COND_VOLUMES_DETACHED, now=now)
            self.kube.update(claim)

        # 4. done: pods that rode the node down (disrupted-taint
        # tolerators, stragglers) die with it — the kubelet/pod-GC
        # role in a real cluster; controller-owned ones are reborn
        # pending so the workload replica is recreated
        for pod in list(self.kube.pods_on_node(node.metadata.name)):
            if not pod.is_terminal():
                self.queue.evict(pod, now=now, force=True)
        # drop the finalizer; the nodeclaim finalizer performs the
        # instance delete once the node object is gone
        self.kube.remove_finalizer(node, TERMINATION_FINALIZER)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        for node in list(self.kube.nodes()):
            self.reconcile(node, now=now)
        self.queue.prune()

    def reconcile_dirty(self, now: Optional[float] = None) -> None:
        """O(terminating nodes): only nodes carrying a deletion
        timestamp ever need this controller, and they're tracked from
        node events; drain/volume retries keep them in the set until
        the finalizer drops."""
        now_mono = now if now is not None else time.time()
        for key in self.dirty.drain("Node"):
            node = self.kube.get_node(key)
            if node is not None and node.metadata.deletion_timestamp is not None:
                self._terminating.add(key)
        # periodic invariant sweep: every deleting node is tracked even
        # if its deletion event was consumed elsewhere (a full-resync
        # tick) — same wedge class as the lifecycle controller's
        # deleting-claim re-queue; periodic so steady state stays
        # O(terminating nodes)
        if now_mono - self._last_deleting_sweep >= 30.0:
            self._last_deleting_sweep = now_mono
            for node in self.kube.nodes():
                if node.metadata.deletion_timestamp is not None:
                    self._terminating.add(node.metadata.name)
        if not self._terminating:
            if self.queue._pending_rebirth:
                self.queue.prune()
            return
        for key in list(self._terminating):
            node = self.kube.get_node(key)
            if node is None or node.metadata.deletion_timestamp is None:
                self._terminating.discard(key)
                continue
            self.reconcile(node, now=now)
            if self.kube.get_node(key) is None:
                self._terminating.discard(key)
        # eviction bookkeeping only exists while something drains;
        # owed successors must be delivered the moment the wedge clears
        if self.queue.blocked or self.queue._retry_at or self.queue._pending_rebirth:
            self.queue.prune()

    # -- helpers ---------------------------------------------------------------

    def _claim_for(self, node: Node):
        # O(1) through the cluster's name/provider-id index; re-read
        # through the mirror so the caller mutates (and updates) the
        # live object, not the cluster's view of it
        if self.cluster is not None:
            sn = self.cluster.node_for_name(node.metadata.name)
            if sn is not None and sn.node_claim is not None:
                claim = self.kube.get_node_claim(
                    sn.node_claim.metadata.name
                )
                if claim is not None and (
                    claim.status.provider_id == node.spec.provider_id
                ):
                    return claim
        # cluster-less fallback (bare-constructed controllers in
        # tests), or the index hasn't absorbed the claim yet
        for claim in self.kube.node_claims():
            if claim.status.provider_id == node.spec.provider_id:
                return claim
        return None

    def _termination_deadline(self, claim) -> Optional[float]:
        if claim is None:
            return None
        raw = claim.metadata.annotations.get(
            NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION
        )
        return float(raw) if raw else None

    def _blocking_pods(self, node: Node, now: Optional[float] = None) -> list[Pod]:
        """Pods whose presence blocks drain completion: live, not
        riding the node down via a disrupted-taint toleration, and not
        STUCK terminating past their own grace period (terminator.go
        'bypass pods which are stuck terminating past their grace
        period' — a wedged finalizer must not hold the node hostage)."""
        now = time.time() if now is None else now
        out = []
        for p in self.kube.pods_on_node(node.metadata.name):
            if p.is_terminal() or _tolerates_disrupted(p):
                continue
            if _stuck_past_grace(p, now):
                continue  # wedged past grace: bypassed
            out.append(p)
        return out

    def _drain(self, node: Node, deadline: Optional[float], now: float) -> list[Pod]:
        """Evict one wave at a time; returns pods still on the node
        that block completion. Like the reference (terminator.go
        Drain), the first non-empty wave gates the rest — a
        do-not-disrupt pod in it stalls drain until the TGP deadline."""
        pods = self._blocking_pods(node, now)
        if deadline is not None:
            # ahead-of-deadline deletion (terminator.go:140-180): a pod
            # whose terminationGracePeriodSeconds would run PAST the
            # node's TGP deadline is deleted NOW — proactively, PDBs and
            # waves notwithstanding — so it gets as much of its grace as
            # the node has left (the remaining time is the clamped grace
            # the reference passes in DeleteOptions)
            expired = False
            for pod in pods:
                grace = pod.spec.termination_grace_period_seconds
                if grace is None or pod.is_terminating():
                    continue
                if now >= deadline - grace:
                    log.info(
                        "deleting pod %s ahead of node TGP deadline "
                        "(grace %ss clamped to %.0fs)",
                        pod.key, grace, max(0.0, deadline - now),
                    )
                    self.queue.evict(pod, now=now, force=True)
                    expired = True
            if expired:
                pods = self._blocking_pods(node, now)
        waves = _drain_waves([p for p in pods if not p.is_terminating()])
        if waves:
            force = deadline is not None and now >= deadline
            for pod in waves[0]:
                if (
                    pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION) == "true"
                    and not force
                ):
                    continue
                # TGP enforcement bypasses PDBs (terminator.go:140)
                self.queue.evict(pod, now=now, force=force)
        return self._blocking_pods(node, now)

    def _volumes_detached(self, node: Node, now: float) -> bool:
        """Only volumes of DRAINABLE pods gate termination
        (controller.go 'should only wait for volume attachments
        associated with drainable pods'): a volume still claimed by a
        pod that will die WITH the node — a disrupted-taint rider or a
        wedged pod the drain bypassed past its grace — can never detach
        first and must not wedge the finalizer."""
        attached = [
            pv for pv in self.kube.list("PersistentVolume")
            if pv.attached_node == node.metadata.name
        ]
        if not attached:
            return True
        riders = [
            p for p in self.kube.pods_on_node(node.metadata.name)
            if not p.is_terminal()
            and (_tolerates_disrupted(p) or _stuck_past_grace(p, now))
        ]
        from karpenter_tpu_torch.provisioning.volume_topology import _pvc_name_for

        rider_pv_names = set()
        for pod in riders:
            for volume in pod.spec.volumes:
                pvc_name = _pvc_name_for(pod, volume)
                if not pvc_name:
                    continue
                pvc = self.kube.get_pvc(pod.metadata.namespace, pvc_name)
                if pvc is not None and pvc.spec.volume_name:
                    rider_pv_names.add(pvc.spec.volume_name)
        return all(pv.metadata.name in rider_pv_names for pv in attached)
