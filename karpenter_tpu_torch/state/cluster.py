"""In-memory cluster state mirror.

Copy of `karpenter_tpu/state/cluster.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/controllers/state (cluster.go, statenode.go):
a thread-safe mirror of nodes + nodeclaims keyed by provider id,
pod -> node bindings with per-node resource usage, daemonset tracking,
nomination windows, consolidation timestamps and per-NodePool tallies.
Fed by watch events (see `informers.attach`), consumed by the
provisioner (snapshot via `deep_copy_nodes`) and the disruption engine.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

from karpenter_tpu_torch.apis.v1.labels import (
    DO_NOT_DISRUPT_ANNOTATION,
    NODEPOOL_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_INITIALIZED,
    COND_REGISTERED,
    NodeClaim,
)
from karpenter_tpu_torch.kube.objects import DaemonSet, Node, Pod, Taint
from karpenter_tpu_torch.kube.client import ADDED, DELETED, KubeClient, MODIFIED
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.taints import filter_ephemeral
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.resources import ResourceList

NOMINATION_WINDOW_SECONDS = 20.0

# the kinds whose watch streams feed the mirror — attach_informers
# registers handlers for exactly these, and synced() refuses while any
# of their events are undelivered; one constant so the two can't drift
INFORMER_KINDS = ("Node", "NodeClaim", "Pod", "DaemonSet")


class StateNode:
    """A Node + NodeClaim pair (statenode.go:119)."""

    def __init__(self, node: Optional[Node] = None, node_claim: Optional[NodeClaim] = None):
        self.node = node
        self.node_claim = node_claim
        self.marked_for_deletion = False
        self.nominated_until = 0.0
        self.pod_keys: set[str] = set()
        self.pod_usage: ResourceList = {}
        self.daemon_usage: ResourceList = {}

    # -- identity -------------------------------------------------------------

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id
        return ""

    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.metadata.name
        if self.node_claim is not None and self.node_claim.status.node_name:
            return self.node_claim.status.node_name
        return ""

    def managed(self) -> bool:
        return self.node_claim is not None or (
            self.node is not None and NODEPOOL_LABEL in self.node.metadata.labels
        )

    def nodepool_name(self) -> str:
        return self.labels().get(NODEPOOL_LABEL, "")

    # -- lifecycle ------------------------------------------------------------

    def registered(self) -> bool:
        return self.node_claim is not None and self.node_claim.status_conditions.is_true(
            COND_REGISTERED
        )

    def initialized(self) -> bool:
        if self.node_claim is None:
            return self.node is not None  # unmanaged nodes count as initialized
        return self.node_claim.status_conditions.is_true(COND_INITIALIZED)

    def deleting(self) -> bool:
        if self.marked_for_deletion:
            return True
        for obj in (self.node, self.node_claim):
            if obj is not None and obj.metadata.deletion_timestamp is not None:
                return True
        return False

    # -- shape ----------------------------------------------------------------

    def labels(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.labels)
        if self.node is not None:
            out.update(self.node.metadata.labels)
        return out

    def annotations(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.annotations)
        if self.node is not None:
            out.update(self.node.metadata.annotations)
        return out

    def taints(self) -> list[Taint]:
        """Node taints; while a managed node initializes, known
        ephemeral taints AND the claim's own startupTaints are ignored
        — both clear before pods run (statenode.go:315-328)."""
        source = self.node.spec.taints if self.node is not None else (
            list(self.node_claim.spec.taints) + list(self.node_claim.spec.startup_taints)
            if self.node_claim is not None
            else []
        )
        if not self.initialized() and self.managed():
            startup = (
                self.node_claim.spec.startup_taints
                if self.node_claim is not None
                else ()
            )
            return [
                t for t in filter_ephemeral(source)
                if not any(
                    t.key == s.key and t.effect == s.effect for s in startup
                )
            ]
        return list(source)

    def capacity(self) -> ResourceList:
        if self.node is not None and self.node.status.capacity:
            return self.node.status.capacity
        if self.node_claim is not None:
            return self.node_claim.status.capacity
        return {}

    def allocatable(self) -> ResourceList:
        if self.registered() or self.node_claim is None:
            if self.node is not None and self.node.status.allocatable:
                return self.node.status.allocatable
        if self.node_claim is not None:
            return self.node_claim.status.allocatable
        return {}

    def used(self) -> ResourceList:
        return resutil.merge(self.pod_usage, self.daemon_usage)

    def available(self) -> ResourceList:
        return resutil.subtract(self.allocatable(), self.used())

    def requirements(self) -> Requirements:
        return Requirements.from_labels(self.labels())

    # -- scheduling hooks -----------------------------------------------------

    def nominate(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self.nominated_until = now + NOMINATION_WINDOW_SECONDS

    def nominated(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return self.nominated_until > now

    # -- disruption validation (statenode.go:202-280) -------------------------

    def validate_node_disruptable(self) -> Optional[str]:
        if self.node is None or self.node_claim is None:
            return "node is not managed or not yet paired"
        if self.annotations().get(DO_NOT_DISRUPT_ANNOTATION) == "true":
            return "disruption is blocked through the do-not-disrupt annotation"
        if NODEPOOL_LABEL not in self.labels():
            return "node does not have the nodepool label"
        if not self.initialized():
            return "node is not initialized"
        return None

    def shallow_copy(self) -> "StateNode":
        out = StateNode(self.node, self.node_claim)
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        out.pod_keys = set(self.pod_keys)
        out.pod_usage = dict(self.pod_usage)
        out.daemon_usage = dict(self.daemon_usage)
        return out


@dataclass
class PodSchedulingTimes:
    first_seen: float = 0.0
    scheduling_decision: float = 0.0
    bound: float = 0.0


@dataclass
class NodePoolState:
    """Static-pool accounting (statenodepool.go:30-170): observed
    active/deleting claim counts plus in-flight launch reservations so
    concurrent (or informer-lagged) launch paths can't overshoot a
    static pool's replica count."""

    active: int = 0
    deleting: int = 0
    reserved: int = 0  # launches granted but not yet observed as claims


class Cluster:
    """The mirror (cluster.go:54-118)."""

    def __init__(self, kube: KubeClient):
        self.kube = kube
        self._lock = threading.RLock()
        self._by_provider: dict[str, StateNode] = {}
        self._by_name: dict[str, str] = {}          # node name -> provider id
        self._claim_keys: dict[str, str] = {}        # claim name -> provider id
        self._unpaired_claims: dict[str, StateNode] = {}
        self._bindings: dict[str, str] = {}          # pod key -> node name
        self._daemonsets: dict[str, DaemonSet] = {}
        self._antiaffinity_pods: dict[str, Pod] = {}
        self._unconsolidated_at: float = 0.0
        self._pod_times: dict[str, PodSchedulingTimes] = {}
        self._pool_state: dict[str, NodePoolState] = {}
        self._claim_pool: dict[str, tuple[str, bool]] = {}  # name -> (pool, deleting)

    # -- queries --------------------------------------------------------------

    def nodes(self) -> list[StateNode]:
        with self._lock:
            return list(self._by_provider.values()) + list(self._unpaired_claims.values())

    def node_for_name(self, name: str) -> Optional[StateNode]:
        with self._lock:
            pid = self._by_name.get(name)
            return self._by_provider.get(pid) if pid else None

    def node_for_key(self, name: str) -> Optional[StateNode]:
        """Resolve a node name OR an in-flight claim name — scheduling
        results key existing-node assignments by whichever the state
        node currently answers to (_state_node_key)."""
        with self._lock:
            pid = self._by_name.get(name) or self._claim_keys.get(name)
            if pid:
                return self._by_provider.get(pid)
            return self._unpaired_claims.get(name)

    def unpaired_claim_names(self) -> list[str]:
        """Names of claims tracked without a node yet (launched or
        launching capacity still materializing) — the in-flight set a
        crash-recovery pass re-adopts, and what restart-convergence
        tests assert drains to empty."""
        with self._lock:
            return sorted(self._unpaired_claims)

    def deep_copy_nodes(self) -> list[StateNode]:
        """Snapshot for a scheduling run (cluster.go:249)."""
        with self._lock:
            return [n.shallow_copy() for n in self.nodes()]

    def daemonsets(self) -> list[DaemonSet]:
        with self._lock:
            return list(self._daemonsets.values())

    def nodepool_resources(self) -> dict[str, ResourceList]:
        """Per-NodePool committed capacity (cluster.go:565)."""
        with self._lock:
            out: dict[str, ResourceList] = {}
            for node in self.nodes():
                pool = node.nodepool_name()
                if not pool or node.deleting():
                    continue
                out[pool] = resutil.merge(out.get(pool, {}), node.capacity())
            return out

    def nodepool_node_count(self, pool_name: str) -> int:
        with self._lock:
            return sum(
                1
                for n in self.nodes()
                if n.nodepool_name() == pool_name and not n.deleting()
            )

    # -- static-pool accounting (statenodepool.go:30-170) ----------------------

    def nodepool_state(self, pool_name: str) -> NodePoolState:
        with self._lock:
            return self._pool_state.setdefault(pool_name, NodePoolState())

    def reserve_node_count(self, pool_name: str, want: int, limit: int) -> int:
        """Grant up to `want` launch slots without exceeding `limit`
        total (active + deleting-excluded + already-reserved). The
        reservation holds until the claim is observed through the watch
        stream, so an informer-lagged second reconcile cannot
        double-launch (ReserveNodeCount semantics)."""
        with self._lock:
            state = self._pool_state.setdefault(pool_name, NodePoolState())
            granted = max(0, min(want, limit - state.active - state.reserved))
            state.reserved += granted
            return granted

    def release_node_reservation(self, pool_name: str, count: int = 1) -> None:
        with self._lock:
            state = self._pool_state.setdefault(pool_name, NodePoolState())
            state.reserved = max(0, state.reserved - count)

    def _track_claim(self, claim: NodeClaim) -> None:
        pool = claim.metadata.labels.get(NODEPOOL_LABEL, "")
        deleting = claim.metadata.deletion_timestamp is not None
        prev = self._claim_pool.get(claim.metadata.name)
        if prev == (pool, deleting):
            return
        if prev is not None:
            self._untrack_counts(*prev)
        self._claim_pool[claim.metadata.name] = (pool, deleting)
        if pool:
            state = self._pool_state.setdefault(pool, NodePoolState())
            if deleting:
                state.deleting += 1
            else:
                state.active += 1
                # a granted launch materialized: its reservation retires
                state.reserved = max(0, state.reserved - 1)

    def _untrack_counts(self, pool: str, deleting: bool) -> None:
        if not pool:
            return
        state = self._pool_state.setdefault(pool, NodePoolState())
        if deleting:
            state.deleting = max(0, state.deleting - 1)
        else:
            state.active = max(0, state.active - 1)

    def _untrack_claim(self, name: str) -> None:
        prev = self._claim_pool.pop(name, None)
        if prev is not None:
            self._untrack_counts(*prev)

    # -- consolidation timestamps (cluster.go:537-563) ------------------------

    def mark_unconsolidated(self, now: Optional[float] = None) -> None:
        with self._lock:
            self._unconsolidated_at = time.time() if now is None else now

    def consolidation_state(self) -> float:
        with self._lock:
            return self._unconsolidated_at

    # -- ingestion ------------------------------------------------------------

    def update_node(self, node: Node) -> None:
        with self._lock:
            pid = node.spec.provider_id
            if not pid:
                # a node we own must carry its providerID before it
                # enters state; an UNMANAGED (bring-your-own) node is
                # tracked under its name so its capacity is schedulable
                # (cluster.go:353-358)
                if node.metadata.labels.get(NODEPOOL_LABEL):
                    return
                pid = node.metadata.name
                if not pid:
                    return
            elif pid != node.metadata.name:
                # the node may have been ingested name-keyed before the
                # cloud controller stamped its providerID — MIGRATE the
                # entry (a delete-and-recreate would zero scheduling
                # state like nominated_until mid-window; a leftover
                # entry would double-count capacity forever)
                stale = self._by_provider.get(node.metadata.name)
                if (
                    stale is not None
                    and stale.node_claim is None
                    and self._by_name.get(node.metadata.name) == node.metadata.name
                ):
                    if pid not in self._by_provider:
                        self._by_provider[pid] = self._by_provider.pop(
                            node.metadata.name
                        )
                    else:
                        # a claim-paired entry already owns the real
                        # key; the name-keyed duplicate just goes
                        del self._by_provider[node.metadata.name]
            state = self._by_provider.get(pid)
            if state is None:
                claim_state = None
                for name, claim_pid in list(self._claim_keys.items()):
                    if claim_pid == pid:
                        claim_state = self._unpaired_claims.pop(name, None)
                if claim_state is not None:
                    state = claim_state
                else:
                    state = StateNode()
                self._by_provider[pid] = state
            state.node = node
            self._by_name[node.metadata.name] = pid
            self._recount_node_pods(state)
            self.mark_unconsolidated()

    def delete_node(self, node: Node) -> None:
        with self._lock:
            # resolve through the name index first: it tracks whatever
            # key the node currently lives under (its providerID, or
            # its name for BYO nodes, surviving providerID arrivals
            # and deletes whose cached object predates the stamp) —
            # a miss on any path would leak the entry's capacity
            pid = (
                self._by_name.get(node.metadata.name)
                or node.spec.provider_id
                or node.metadata.name
            )
            state = self._by_provider.get(pid)
            if state is None:
                return
            state.node = None
            self._by_name.pop(node.metadata.name, None)
            if state.node_claim is None:
                del self._by_provider[pid]
            self.mark_unconsolidated()

    def update_node_claim(self, claim: NodeClaim) -> None:
        with self._lock:
            self._track_claim(claim)
            pid = claim.status.provider_id
            old_pid = self._claim_keys.get(claim.metadata.name)
            if pid:
                self._claim_keys[claim.metadata.name] = pid
                state = self._by_provider.get(pid)
                if state is None:
                    state = self._unpaired_claims.pop(claim.metadata.name, None) or StateNode()
                    self._by_provider[pid] = state
                state.node_claim = claim
            else:
                state = self._unpaired_claims.get(claim.metadata.name)
                if state is None:
                    state = StateNode()
                    self._unpaired_claims[claim.metadata.name] = state
                state.node_claim = claim
            if old_pid and old_pid != pid:
                self._by_provider.pop(old_pid, None)
            self.mark_unconsolidated()

    def delete_node_claim(self, claim: NodeClaim) -> None:
        with self._lock:
            self._untrack_claim(claim.metadata.name)
            self._unpaired_claims.pop(claim.metadata.name, None)
            pid = self._claim_keys.pop(claim.metadata.name, None)
            if pid and pid in self._by_provider:
                state = self._by_provider[pid]
                state.node_claim = None
                if state.node is None:
                    del self._by_provider[pid]
            self.mark_unconsolidated()

    def update_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.key
            if pod.is_terminal() or pod.is_terminating():
                self._unbind(key)
            elif pod.spec.node_name:
                old_node = self._bindings.get(key)
                if old_node != pod.spec.node_name:
                    self._unbind(key)
                    state = self.node_for_name(pod.spec.node_name)
                    if state is not None:
                        state.pod_keys.add(key)
                        usage = resutil.pod_requests(pod)
                        if pod.owner_kind() == "DaemonSet":
                            state.daemon_usage = resutil.merge(state.daemon_usage, usage)
                        else:
                            state.pod_usage = resutil.merge(state.pod_usage, usage)
                    self._bindings[key] = pod.spec.node_name
                times = self._pod_times.setdefault(key, PodSchedulingTimes())
                if not times.bound:
                    times.bound = time.time()
            else:
                times = self._pod_times.setdefault(key, PodSchedulingTimes())
                if not times.first_seen:
                    times.first_seen = time.time()
            if _has_required_anti_affinity(pod):
                self._antiaffinity_pods[key] = pod
            self.mark_unconsolidated()

    def delete_pod(self, pod: Pod) -> None:
        with self._lock:
            self._unbind(pod.key, pod=pod)
            self._antiaffinity_pods.pop(pod.key, None)
            self._pod_times.pop(pod.key, None)
            self.mark_unconsolidated()

    def _unbind(self, pod_key: str, pod: Optional[Pod] = None) -> None:
        node_name = self._bindings.pop(pod_key, None)
        if node_name is None:
            return
        state = self.node_for_name(node_name)
        if state is not None and pod_key in state.pod_keys:
            state.pod_keys.discard(pod_key)
            if pod is None:
                # deleted pods are gone from the store; callers on the
                # delete path pass the object so usage is released
                pod = self.kube.get_pod(*pod_key.split("/", 1))
            if pod is not None:
                usage = resutil.pod_requests(pod)
                if pod.owner_kind() == "DaemonSet":
                    state.daemon_usage = resutil.positive(
                        resutil.subtract(state.daemon_usage, usage)
                    )
                else:
                    state.pod_usage = resutil.positive(
                        resutil.subtract(state.pod_usage, usage)
                    )

    def _recount_node_pods(self, state: StateNode) -> None:
        """Rebuild usage for a node from current bindings."""
        name = state.name
        if not name:
            return
        state.pod_keys.clear()
        state.pod_usage = {}
        state.daemon_usage = {}
        for pod in self.kube.pods_on_node(name):
            if pod.is_terminal():
                continue
            state.pod_keys.add(pod.key)
            usage = resutil.pod_requests(pod)
            if pod.owner_kind() == "DaemonSet":
                state.daemon_usage = resutil.merge(state.daemon_usage, usage)
            else:
                state.pod_usage = resutil.merge(state.pod_usage, usage)
            self._bindings[pod.key] = name

    def update_daemonset(self, ds: DaemonSet) -> None:
        with self._lock:
            self._daemonsets[ds.key] = ds

    def delete_daemonset(self, ds: DaemonSet) -> None:
        with self._lock:
            self._daemonsets.pop(ds.key, None)

    def pods_with_anti_affinity(self) -> list[Pod]:
        with self._lock:
            return list(self._antiaffinity_pods.values())

    def pod_times(self, pod_key: str) -> PodSchedulingTimes:
        with self._lock:
            return self._pod_times.setdefault(pod_key, PodSchedulingTimes())

    def mark_pod_scheduling_decisions(self, pods: Iterable[Pod], now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            for pod in pods:
                self._pod_times.setdefault(pod.key, PodSchedulingTimes()).scheduling_decision = now

    def synced(self) -> bool:
        """The informer/state sync barrier (cluster.go:118-213): the
        mirror is synced when the watch stream is fully delivered AND
        every Node/NodeClaim the store knows is tracked here. Under
        async delivery this goes False the moment a mutation is queued
        and stays False until the informer pump catches up — the gate
        every provisioning/disruption reconcile checks before solving
        against the mirror."""
        if self.kube.pending_events(INFORMER_KINDS):
            return False
        # store snapshots taken BEFORE the cluster lock: watch dispatch
        # holds the kube lock while calling into cluster handlers
        # (kube->cluster order), so taking cluster->kube here would be
        # a lock-order inversion that can deadlock embedders running
        # the operator loop and API writes on separate threads
        store_claims = self.kube.node_claims()
        store_nodes = self.kube.nodes()
        with self._lock:
            for claim in store_claims:
                pid = claim.status.provider_id
                if pid:
                    state = self._by_provider.get(pid)
                    if state is None or state.node_claim is None:
                        return False
                elif claim.metadata.name not in self._unpaired_claims:
                    return False
            for node in store_nodes:
                # providerID-less unmanaged nodes are tracked under
                # their name (update_node) — the barrier must hold for
                # them too or a solve runs blind to their capacity
                pid = node.spec.provider_id or (
                    ""
                    if node.metadata.labels.get(NODEPOOL_LABEL)
                    else node.metadata.name
                )
                if pid and pid not in self._by_provider:
                    return False
            return True


def _has_required_anti_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return bool(aff and aff.pod_anti_affinity and aff.pod_anti_affinity.required)


def attach_informers(kube: KubeClient, cluster: Cluster) -> None:
    """Wire watch streams into the mirror (state/informer/*.go)."""

    def on_node(event: str, obj) -> None:
        if event == DELETED:
            cluster.delete_node(obj)
        else:
            cluster.update_node(obj)

    def on_claim(event: str, obj) -> None:
        if event == DELETED:
            cluster.delete_node_claim(obj)
        else:
            cluster.update_node_claim(obj)

    def on_pod(event: str, obj) -> None:
        if event == DELETED:
            cluster.delete_pod(obj)
        else:
            cluster.update_pod(obj)

    def on_daemonset(event: str, obj) -> None:
        if event == DELETED:
            cluster.delete_daemonset(obj)
        else:
            cluster.update_daemonset(obj)

    handlers = {
        "Node": on_node,
        "NodeClaim": on_claim,
        "Pod": on_pod,
        "DaemonSet": on_daemonset,
    }
    assert set(handlers) == set(INFORMER_KINDS)
    for kind in INFORMER_KINDS:
        kube.watch(kind, handlers[kind])
