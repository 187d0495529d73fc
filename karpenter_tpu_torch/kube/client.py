"""In-memory Kubernetes-style API server.

Copy of `karpenter_tpu/kube/client.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The reference's fabric is the real API server (watches + optimistic
concurrency). This build substitutes a single-process store with the
same semantics the controllers rely on:

- create/get/list/update/delete by (kind, key)
- resource versions bumped on write; stale updates rejected
- finalizers: delete sets deletion_timestamp while finalizers remain;
  the object disappears when the last finalizer is removed
- watch: subscribers receive (event, obj) synchronously on mutation —
  the analogue of informer event handlers feeding state.Cluster
- async delivery mode: watch events queue instead of firing inline,
  modelling the informer-cache lag behind the real API server
  (cluster.go:118-213 exists because of exactly this); the operator
  pumps `deliver()` once per tick, and `Cluster.synced()` reports
  False while events are in flight
- immutable NodeClaim spec (the reference enforces via CEL)

Controllers are written against this client; swapping in a real
apiserver adapter later only replaces this module.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.apis.v1.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.kube.objects import (
    CSINode,
    DaemonSet,
    LabelSelector,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PriorityClass,
    StorageClass,
)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

WatchHandler = Callable[[str, object], None]


class ConflictError(Exception):
    pass


class NotFoundError(Exception):
    pass


class InvalidError(Exception):
    pass


class EvictionBlockedError(Exception):
    """The API substrate's 429: a PodDisruptionBudget blocks the
    eviction right now (terminator/eviction.go:170-185 retries these
    with backoff rather than falling through to delete)."""

    def __init__(self, pdb: str = ""):
        self.pdb = pdb
        super().__init__(
            "Cannot evict pod as it would violate the pod's disruption "
            f"budget: {pdb}"
        )


class KubeClient:
    # This store IS the simulated cluster: there is no ReplicaSet
    # controller or kube-scheduler behind it, so controllers that
    # emulate workload-owner behavior (eviction successor pods) are
    # entitled to do so. Real-cluster adapters set this False — there
    # the actual controllers own that behavior.
    simulates_workload_controllers = True

    def __init__(self, async_delivery: bool = False) -> None:
        self._lock = threading.RLock()
        self._store: dict[str, dict[str, object]] = {}
        self._watchers: dict[str, list[WatchHandler]] = {}
        self._rv = 0
        self.async_delivery = async_delivery
        self._pending_events: list[tuple[str, str, object]] = []
        # field-indexer analogue (operator.go:251-294 indexes
        # pod.spec.nodeName): node name -> pod keys, kept in lockstep
        # with writes so pods_on_node is O(pods-on-node) not O(pods)
        self._pods_by_node: dict[str, set[str]] = {}
        self._pod_node: dict[str, str] = {}
        # serializes deliver() so concurrent pumps can't interleave
        # event order; re-entrant pumps (a handler calling deliver)
        # no-op instead of delivering newer events ahead of the
        # in-flight batch
        self._deliver_lock = threading.RLock()
        self._delivering = False

    # -- core CRUD ------------------------------------------------------------

    def _bucket(self, kind: str) -> dict[str, object]:
        return self._store.setdefault(kind, {})

    def _admit(self, obj, old=None) -> None:
        """Admission-time validation — the CEL analogue the real API
        server runs before any write lands (apis/v1/validation.py)."""
        from karpenter_tpu_torch.apis.v1.validation import (
            ValidationError,
            validate_node_claim,
            validate_node_pool,
        )

        try:
            if isinstance(obj, NodePool):
                validate_node_pool(obj, old=old)
            elif isinstance(obj, NodeClaim) and old is None:
                validate_node_claim(obj)
        except ValidationError as err:
            raise InvalidError(str(err)) from None

    def _index_pod(self, obj, removed: bool = False) -> None:
        if not isinstance(obj, Pod):
            return
        old = self._pod_node.get(obj.key)
        new = "" if removed else obj.spec.node_name
        if old == new:
            return
        if old:
            self._pods_by_node.get(old, set()).discard(obj.key)
        if new:
            self._pods_by_node.setdefault(new, set()).add(obj.key)
            self._pod_node[obj.key] = new
        else:
            self._pod_node.pop(obj.key, None)

    def create(self, obj) -> object:
        with self._lock:
            self._admit(obj)
            bucket = self._bucket(obj.kind)
            if obj.key in bucket:
                raise ConflictError(f"{obj.kind} {obj.key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            obj.metadata.generation = 1
            bucket[obj.key] = obj
            self._index_pod(obj)
            self._notify(obj.kind, ADDED, obj)
            return obj

    def get(self, kind: str, key: str):
        with self._lock:
            obj = self._bucket(kind).get(key)
            return obj

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None) -> list:
        with self._lock:
            out = []
            for obj in self._bucket(kind).values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if selector is not None and not selector.matches(obj.metadata.labels):
                    continue
                out.append(obj)
            return out

    def update(self, obj, mutate=None) -> object:
        """Write an object back; bumps resource version.

        Optimistic concurrency (the API server's resourceVersion
        precondition): writing a DIFFERENT object instance whose
        resource version is older than the stored one is a conflict —
        the caller read stale state and must re-read and retry.
        In-place mutations of the canonical object (the common
        single-process controller pattern here) are never stale.
        NodeClaim specs are immutable (nodeclaim.go:145 CEL rule).

        `mutate` (optional) states the write as a FUNCTION of the
        object — the conflict-safe form mirrored by RealKubeClient's
        retry wrapper: applied before the write, and on a would-be
        conflict re-applied onto the CANONICAL stored object instead
        of failing (read-modify-write, never last-write-wins).
        """
        with self._lock:
            if mutate is not None:
                mutate(obj)
            bucket = self._bucket(obj.kind)
            existing = bucket.get(obj.key)
            if existing is None:
                raise NotFoundError(f"{obj.kind} {obj.key}")
            if (
                mutate is not None
                and existing is not obj
                and obj.metadata.resource_version
                < existing.metadata.resource_version
            ):
                mutate(existing)
                obj = existing
            if existing is not obj and (
                obj.metadata.resource_version < existing.metadata.resource_version
            ):
                raise ConflictError(
                    f"{obj.kind} {obj.key}: stale resourceVersion "
                    f"{obj.metadata.resource_version} < "
                    f"{existing.metadata.resource_version}"
                )
            if isinstance(obj, NodeClaim) and existing is not obj:
                if repr(existing.spec) != repr(obj.spec):
                    raise InvalidError("NodeClaim spec is immutable")
            self._admit(obj, old=existing)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            bucket[obj.key] = obj
            self._index_pod(obj)
            self._notify(obj.kind, MODIFIED, obj)
            return obj

    def delete(self, obj_or_kind, key: Optional[str] = None, now: Optional[float] = None):
        """Delete with finalizer semantics."""
        with self._lock:
            if isinstance(obj_or_kind, str):
                obj = self._bucket(obj_or_kind).get(key)
            else:
                obj = self._bucket(obj_or_kind.kind).get(obj_or_kind.key)
            if obj is None:
                return None
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = now if now is not None else time.time()
                    self._rv += 1
                    obj.metadata.resource_version = self._rv
                    self._notify(obj.kind, MODIFIED, obj)
                return obj
            del self._bucket(obj.kind)[obj.key]
            self._index_pod(obj, removed=True)
            self._notify(obj.kind, DELETED, obj)
            return None

    def evict(self, pod: Pod, now: Optional[float] = None) -> None:
        """policy/v1 Eviction analogue: the store (playing the API
        server) enforces PDBs SERVER-side and answers the eviction.go
        429 with EvictionBlockedError; an allowed eviction proceeds as
        a graceful delete (finalizer semantics included). Drains must
        call this, never delete() — on a real cluster only the
        eviction subresource consults PDBs."""
        from karpenter_tpu_torch.utils.pdb import PdbLimits

        # check + delete under one lock (RLock: the nested reads and
        # the delete re-enter safely) — the real API server evaluates
        # the budget atomically per eviction, so two racing evictions
        # can never both pass a disruptions_allowed=1 budget
        with self._lock:
            blocking = PdbLimits(self).can_evict(pod, server_side=True)
            if blocking is not None:
                raise EvictionBlockedError(blocking)
            self.delete(pod, now=now)

    def touch(self, obj) -> None:
        """Publish a MODIFIED event for an object mutated in place.

        Controllers that edit objects directly (conditions, timestamps,
        annotations) bypass update() and would otherwise be invisible
        to watch-driven consumers; touch restores the every-write-is-
        an-event property the reference gets from the API server."""
        with self._lock:
            if self._bucket(obj.kind).get(obj.key) is not obj:
                return  # deleted or replaced; nothing to announce
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._notify(obj.kind, MODIFIED, obj)

    def remove_finalizer(self, obj, finalizer: str) -> None:
        with self._lock:
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                bucket = self._bucket(obj.kind)
                if obj.key in bucket:
                    del bucket[obj.key]
                    self._index_pod(obj, removed=True)
                    self._notify(obj.kind, DELETED, obj)
            else:
                self.update(obj)

    # -- checkpoint / resume ---------------------------------------------------
    #
    # The reference's durable state IS the API server (SURVEY §5.4:
    # conditions, labels, finalizers, taints — the in-memory caches are
    # rebuilt from watches on restart). This store is that API server,
    # so persistence = serializing the store; a fresh operator attaches
    # informers, replays the LIST, and resumes exactly where the old
    # process stopped.

    def save(self, path: str) -> None:
        import pickle

        with self._lock:
            with open(path, "wb") as fh:
                pickle.dump(self._store, fh)

    @classmethod
    def load(cls, path: str, async_delivery: bool = False) -> "KubeClient":
        import pickle

        client = cls(async_delivery=async_delivery)
        with open(path, "rb") as fh:
            client._store = pickle.load(fh)
        client._rv = max(
            (
                obj.metadata.resource_version
                for bucket in client._store.values()
                for obj in bucket.values()
            ),
            default=0,
        )
        for pod in client._bucket("Pod").values():
            client._index_pod(pod)
        return client

    # -- watch ----------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler) -> None:
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            # replay current state (informer initial LIST)
            for obj in self._bucket(kind).values():
                handler(ADDED, obj)

    def _notify(self, kind: str, event: str, obj) -> None:
        if not self._watchers.get(kind):
            return
        if self.async_delivery:
            self._pending_events.append((kind, event, obj))
            return
        self._dispatch(kind, event, obj)

    def _dispatch(self, kind: str, event: str, obj) -> None:
        for handler in self._watchers.get(kind, []):
            handler(event, obj)

    def deliver(self, limit: Optional[int] = None,
                shard: Optional[int] = None) -> int:
        """Drain queued watch events to their handlers (the informer
        stream catching up with the API server). Returns the number
        delivered. `limit` delivers only the oldest N, letting tests
        hold the cache arbitrarily stale. `shard` delivers only the
        events routed to one state-plane shard (state/shards.py),
        leaving the rest queued — the per-shard logical stream the
        cross-shard ordering tests replay in both orders."""
        with self._deliver_lock:
            if self._delivering:
                return 0
            self._delivering = True
            try:
                with self._lock:
                    if shard is None:
                        n = len(self._pending_events) if limit is None \
                            else min(limit, len(self._pending_events))
                        batch = self._pending_events[:n]
                        del self._pending_events[:n]
                    else:
                        from karpenter_tpu_torch.state.shards import shard_of_event

                        batch, kept = [], []
                        for item in self._pending_events:
                            kind, _, obj = item
                            if shard_of_event(kind, obj) == shard and (
                                limit is None or len(batch) < limit
                            ):
                                batch.append(item)
                            else:
                                kept.append(item)
                        self._pending_events = kept
                for kind, event, obj in batch:
                    self._dispatch(kind, event, obj)
                return len(batch)
            finally:
                self._delivering = False

    def pending_events(self, kinds: Optional[Iterable[str]] = None) -> int:
        """Undelivered watch events, optionally filtered by kind."""
        with self._lock:
            if kinds is None:
                return len(self._pending_events)
            wanted = set(kinds)
            return sum(1 for k, _, _ in self._pending_events if k in wanted)

    # -- typed sugar ----------------------------------------------------------

    def pods(self, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None) -> list[Pod]:
        return self.list("Pod", namespace, selector)

    def nodes(self) -> list[Node]:
        return self.list("Node")

    def node_claims(self) -> list[NodeClaim]:
        return self.list("NodeClaim")

    def node_pools(self) -> list[NodePool]:
        return self.list("NodePool")

    def daemon_sets(self) -> list[DaemonSet]:
        return self.list("DaemonSet")

    def pdbs(self) -> list[PodDisruptionBudget]:
        return self.list("PodDisruptionBudget")

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        return self.get("Pod", f"{namespace}/{name}")

    def get_node(self, name: str) -> Optional[Node]:
        return self.get("Node", name)

    def get_node_claim(self, name: str) -> Optional[NodeClaim]:
        return self.get("NodeClaim", name)

    def get_node_pool(self, name: str) -> Optional[NodePool]:
        return self.get("NodePool", name)

    def get_pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.get("PersistentVolumeClaim", f"{namespace}/{name}")

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        return self.get("StorageClass", name)

    def get_pv(self, name: str) -> Optional[PersistentVolume]:
        return self.get("PersistentVolume", name)

    def get_csi_node(self, name: str) -> Optional[CSINode]:
        return self.get("CSINode", name)

    def csi_nodes(self) -> list[CSINode]:
        return self.list("CSINode")

    def priority_classes(self) -> list[PriorityClass]:
        return self.list("PriorityClass")

    def get_priority_class(self, name: str) -> Optional[PriorityClass]:
        return self.get("PriorityClass", name)

    def bind_pod(self, pod: Pod, node_name: str) -> None:
        """The scheduler binding: sets spec.node_name."""
        with self._lock:
            pod.spec.node_name = node_name
            self.update(pod)

    def pods_on_node(self, node_name: str) -> list[Pod]:
        with self._lock:
            keys = self._pods_by_node.get(node_name)
            if not keys:
                return []
            bucket = self._bucket("Pod")
            return [bucket[k] for k in keys if k in bucket]
