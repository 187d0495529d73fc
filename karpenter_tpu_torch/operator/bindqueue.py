"""Sharded pending-bind ledger: drain work is O(pending), never O(fleet).

Copy of `karpenter_tpu/operator/bindqueue.py`.

The operator owns pod binding (the kube-scheduler's job in a real
cluster): every solve/command produces SchedulerResults whose pods must
be bound once their target node materializes. The old implementation
kept a flat list of results and re-walked every pod of every held plan
each drain — including pods long since bound — and probed node
existence with a full `kube.nodes()` scan per unresolved claim name.
At 100k pods a handful of held command plans made every tick pay a
fleet-sized walk.

This queue keeps the exact hold/drop semantics of the flat list (same
branch structure, same deadline contract, same batcher requeues) but:

- each enqueued results carries a `done` set of pod keys whose binding
  reached a TERMINAL outcome (bound by us, or requeued through the
  batcher after the target claim died). Subsequent drains skip them, so
  a plan held for ONE slow pod re-examines one pod, not the plan.
- node existence is answered by the mirror's O(1) `get_node`, not a
  fleet scan.
- every successful bind records arrival->bind latency (enqueue stamp to
  bind), drained by the operator into the `pod_to_bind_latency` SLO.
- held pods are tallied per state-plane shard (shard of the target
  node/claim name) into karpenter_state_shard_queue_pending{queue=bind}
  so a wedged shard is visible as a shard, not an anonymous backlog.

The queue is list-compatible where tests and the operator relied on
list behavior: `append(results)` enqueues under the results' own
`bind_deadline` stamp, and truthiness/len reflect held items.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from karpenter_tpu_torch.metrics.store import STATE_SHARD_QUEUE_PENDING
from karpenter_tpu_torch.state.shards import shard_count, shard_of


class _Item:
    __slots__ = ("results", "enqueued_at", "done", "arrivals")

    def __init__(self, results, enqueued_at: float, arrivals=None):
        self.results = results
        self.enqueued_at = enqueued_at
        # pod keys whose binding reached a terminal outcome; never
        # re-examined on later drains
        self.done: set[str] = set()
        # pod key -> watch-stream arrival stamp: when the
        # reactive plane saw the pod first. Bind latency is measured
        # from here so the SLI covers the wait-for-solve, not just the
        # queue residency; pods without a stamp (command plans, pods
        # predating the plane's clock) fall back to enqueued_at. For
        # held replace-then-drain plans, drain() re-stamps pods still
        # bound to the node being drained — a migrating pod is serving,
        # not pending, until its rebirth.
        self.arrivals: dict[str, float] = arrivals or {}

    def latency_start(self, pod_key: str) -> float:
        return self.arrivals.get(pod_key, self.enqueued_at)

    @property
    def deadline(self) -> float:
        # the stamp lives on the results (crash recovery and tests
        # read/write it there); the item defers to it
        return getattr(self.results, "bind_deadline", float("inf"))


class BindingQueue:
    """Holds scheduling results whose pods await binding; drains in
    time proportional to the pods still pending."""

    def __init__(
        self,
        kube,
        cluster,
        bind_one: Callable[[object, str], bool],
        requeue: Callable[[float], None],
        on_enqueue: Optional[Callable[[], None]] = None,
    ):
        self.kube = kube
        self.cluster = cluster
        self._bind_one = bind_one
        self._requeue = requeue
        # wake-on-enqueue: the live loop drains a fresh plan
        # immediately instead of sleeping the tick interval out
        self._on_enqueue = on_enqueue
        self._shards = shard_count()
        self._items: list[_Item] = []
        # arrival->bind walls of binds since the last take_latencies()
        self._latencies: list[float] = []
        # full-run latency ledger (bench p50/p99; bounded)
        self.history: deque[float] = deque(maxlen=200_000)

    # -- list compatibility (operator internals + tests) ---------------

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def append(self, results) -> None:
        """Enqueue under the results' own bind_deadline stamp (set one
        via `enqueue` for the TTL contract)."""
        self._items.append(_Item(results, time.time()))

    # -- queue API -----------------------------------------------------

    def enqueue(self, results, now: float, ttl: float, arrivals=None) -> None:
        results.bind_deadline = now + ttl
        self._items.append(_Item(results, now, arrivals))
        if self._on_enqueue is not None:
            self._on_enqueue()

    def take_latencies(self) -> list[float]:
        out, self._latencies = self._latencies, []
        return out

    def planned_pod_keys(self) -> set[str]:
        """Pod keys a held plan already covers (O(pending)): the
        micro-solve path filters these so an arrival never gets two
        competing placements while its plan is materializing."""
        keys: set[str] = set()
        for item in self._items:
            results = item.results
            for plan in results.new_node_plans:
                for pod in plan.pods:
                    if pod.key not in item.done:
                        keys.add(pod.key)
            for pods in results.existing_assignments.values():
                for pod in pods:
                    if pod.key not in item.done:
                        keys.add(pod.key)
        return keys

    def _record_latency(self, now: float, item: _Item, pod_key: str) -> None:
        latency = max(0.0, now - item.latency_start(pod_key))
        self._latencies.append(latency)
        self.history.append(latency)

    def drain(self, now: float) -> tuple[int, int]:
        """One binding pass. Returns (bound, held_plans). Results are
        dropped once fully bound or once every pod found a different
        home; a plan whose pods are still materializing is HELD under
        its deadline."""
        bound = 0
        remaining: list[_Item] = []
        held_by_shard: dict[int, int] = {}

        def hold(target: str, n: int = 1) -> None:
            s = shard_of(target, self._shards) if target else 0
            held_by_shard[s] = held_by_shard.get(s, 0) + n

        for item in self._items:
            if now > item.deadline:
                continue  # stale plan: its pods re-solve via the batcher
            results = item.results
            done = item.done
            unbound = False
            for plan in results.new_node_plans:
                pods = [p for p in plan.pods if p.key not in done]
                if not pods:
                    continue
                claim = (
                    self.kube.get_node_claim(plan.claim_name)
                    if plan.claim_name else None
                )
                node_name = claim.status.node_name if claim is not None else ""
                claim_gone = claim is None or (
                    claim.metadata.deletion_timestamp is not None
                )
                target = node_name or plan.claim_name or ""
                for pod in pods:
                    live = self.kube.get_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                    if live is None or (
                        live.spec.node_name
                        and node_name
                        and live.spec.node_name != node_name
                    ):
                        # awaiting rebirth, or still bound to the node
                        # the command is draining: HOLD the plan until
                        # the pod comes free (deadline-bounded) — a
                        # plan dropped while its pods are still bound
                        # never fires at all (seed-11 oscillation).
                        # The pod is not pending here — it is still
                        # serving on the old node (or mid-rebirth), so
                        # the bind-latency clock must not run: advance
                        # its stamp to this sighting
                        item.arrivals[pod.key] = now
                        unbound = True
                        hold(target)
                        continue
                    if live.spec.node_name:
                        if not node_name and not claim_gone:
                            # still bound to the node being drained
                            # while the replacement claim has no
                            # status.node_name yet (created this tick,
                            # registers in a later lifecycle phase):
                            # HOLD the plan like the
                            # existing-assignments branch below —
                            # treating this as "already home" silently
                            # dropped pure-replace command plans before
                            # their claims ever registered (ADVICE r5).
                            # Still bound = not pending: keep the
                            # latency clock parked at this sighting
                            item.arrivals[pod.key] = now
                            unbound = True
                            hold(target)
                        continue  # already home (or nothing to wait on)
                    if node_name and not claim_gone:
                        if self._bind_one(live, node_name):
                            bound += 1
                            done.add(pod.key)
                            self._record_latency(now, item, pod.key)
                        else:
                            unbound = True
                            hold(target)
                    elif claim_gone:
                        # binding target never materializes (ICE /
                        # liveness timeout deleted the claim): re-queue
                        # the still-pending pod through the batcher —
                        # the controller analogue of the reference's
                        # pod-event-driven re-provisioning; simulated
                        # clock threaded through so batcher windows
                        # never mix wall and sim time
                        self._requeue(now)
                        done.add(pod.key)
                    else:
                        unbound = True  # node still materializing
                        hold(target)
            for node_name, pods in results.existing_assignments.items():
                pods = [p for p in pods if p.key not in done]
                if not pods:
                    continue
                # an in-flight assignment is keyed by CLAIM name; bind
                # only once the claim's node materialized — a bind to
                # the raw key would pin pods to a node that will never
                # exist under that name
                target = node_name
                if self.cluster.node_for_name(node_name) is None:
                    claim = self.kube.get_node_claim(node_name)
                    if claim is not None and (
                        claim.metadata.deletion_timestamp is None
                    ):
                        target = claim.status.node_name
                        if not target:
                            unbound = True
                            hold(node_name, len(pods))
                            continue
                    elif self.kube.get_node(node_name) is None:
                        # the claim died (ICE/liveness) before its node
                        # existed, or the node vanished: never bind to
                        # a name that will not materialize — re-queue
                        # the pods through the batcher instead
                        self._requeue(now)
                        done.update(p.key for p in pods)
                        continue
                for pod in pods:
                    live = self.kube.get_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                    if live is not None and not live.spec.node_name:
                        if self._bind_one(live, target):
                            bound += 1
                            done.add(pod.key)
                            self._record_latency(now, item, pod.key)
                        else:
                            unbound = True
                            hold(target)
                    elif live is None or live.spec.node_name != target:
                        # awaiting rebirth from the drain, or still
                        # bound to the node being drained: HOLD the
                        # plan (deadline-bounded) so the pod lands on
                        # the planned capacity, not a fresh solve.
                        # Not pending — park the latency clock here
                        item.arrivals[pod.key] = now
                        unbound = True
                        hold(target)
            if unbound:
                remaining.append(item)
        self._items = remaining
        for s in range(self._shards):
            STATE_SHARD_QUEUE_PENDING.set(
                float(held_by_shard.get(s, 0)),
                {"queue": "bind", "shard": str(s)},
            )
        return bound, len(remaining)
