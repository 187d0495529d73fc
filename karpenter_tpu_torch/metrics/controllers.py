"""Object-level metrics controllers.

Copy of `karpenter_tpu/metrics/controllers.py`.

Counterpart of the reference's gauge-republishing controllers
(`pkg/controllers/metrics/pod` 974 LoC, `/node`, `/nodepool`): each
reconcile pass re-publishes one gauge series per live object through a
diff-publishing `Store`, so deleted objects drop their series, and the
pod controller feeds the scheduling/startup latency histograms from the
cluster-state timestamps (metrics/pod/controller.go's
schedulingDuration/startupDuration from state timestamps).
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    INSTANCE_TYPE_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics.store import (
    PODS_SCHEDULING_DURATION,
    PODS_STARTUP_DURATION,
    REGISTRY,
    Store,
)
from karpenter_tpu_torch.state.cluster import Cluster

PODS_STATE = REGISTRY.gauge(
    "karpenter_pods_state", "One series per pod: phase/owner/node placement"
)
NODES_ALLOCATABLE = REGISTRY.gauge(
    "karpenter_nodes_allocatable", "Allocatable per node and resource type"
)
NODES_TOTAL_POD_REQUESTS = REGISTRY.gauge(
    "karpenter_nodes_total_pod_requests",
    "Sum of scheduled pod requests per node and resource type",
)
NODES_UTILIZATION = REGISTRY.gauge(
    "karpenter_nodes_allocatable_utilization_percent",
    "Requested share of allocatable per node and resource type",
)
NODEPOOL_USAGE = REGISTRY.gauge(
    "karpenter_nodepools_usage", "Resource usage per nodepool and resource type"
)
NODEPOOL_LIMIT = REGISTRY.gauge(
    "karpenter_nodepools_limit", "Configured limit per nodepool and resource type"
)
NODEPOOL_NODE_COUNT = REGISTRY.gauge(
    "karpenter_nodepools_node_count", "Nodes owned per nodepool"
)
NODEPOOL_WEIGHT = REGISTRY.gauge(
    "karpenter_nodepools_weight", "Priority weight per nodepool"
)


class PodMetricsController:
    """metrics/pod: per-pod state series + latency histograms.

    Histograms observe once per pod: scheduling duration when the
    scheduling decision lands, startup duration when the pod is bound
    (first_seen -> bound), both from `Cluster`'s PodSchedulingTimes.
    """

    def __init__(self, kube: KubeClient, cluster: Cluster):
        self.kube = kube
        self.cluster = cluster
        self.store = Store(PODS_STATE)
        self._observed_scheduling: set[str] = set()
        self._observed_startup: set[str] = set()

    def reconcile_all(self, now: Optional[float] = None) -> None:
        del now
        live: set[str] = set()
        for pod in self.kube.pods():
            key = pod.key
            live.add(key)
            labels = {
                "name": pod.metadata.name,
                "namespace": pod.metadata.namespace,
                "phase": pod.status.phase,
                "node": pod.spec.node_name or "",
            }
            self.store.update(key, [(labels, 1.0)])
            times = self.cluster.pod_times(key)
            if (
                times.scheduling_decision > 0
                and times.first_seen > 0
                and key not in self._observed_scheduling
            ):
                self._observed_scheduling.add(key)
                PODS_SCHEDULING_DURATION.observe(
                    max(0.0, times.scheduling_decision - times.first_seen)
                )
            if (
                times.bound > 0
                and times.first_seen > 0
                and key not in self._observed_startup
            ):
                self._observed_startup.add(key)
                PODS_STARTUP_DURATION.observe(
                    max(0.0, times.bound - times.first_seen)
                )
        self.store.prune(live)
        self._observed_scheduling &= live
        self._observed_startup &= live


class NodeMetricsController:
    """metrics/node: allocatable / requested / utilization per node."""

    def __init__(self, kube: KubeClient, cluster: Cluster):
        self.kube = kube
        self.cluster = cluster
        self.alloc = Store(NODES_ALLOCATABLE)
        self.requested = Store(NODES_TOTAL_POD_REQUESTS)
        self.util = Store(NODES_UTILIZATION)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        del now
        live: set[str] = set()
        for state in self.cluster.nodes():
            name = state.name
            if not name:
                continue
            live.add(name)
            labels = state.labels()
            base = {
                "node_name": name,
                "nodepool": state.nodepool_name(),
                "instance_type": labels.get(INSTANCE_TYPE_LABEL, ""),
                "capacity_type": labels.get(CAPACITY_TYPE_LABEL, ""),
                "zone": labels.get(TOPOLOGY_ZONE_LABEL, ""),
            }
            alloc = state.allocatable()
            used = state.used()
            self.alloc.update(
                name,
                [
                    ({**base, "resource_type": k}, float(v))
                    for k, v in alloc.items()
                ],
            )
            self.requested.update(
                name,
                [
                    ({**base, "resource_type": k}, float(v))
                    for k, v in used.items()
                ],
            )
            self.util.update(
                name,
                [
                    (
                        {**base, "resource_type": k},
                        100.0 * float(used.get(k, 0.0)) / float(v)
                    )
                    for k, v in alloc.items()
                    if v
                ],
            )
        for store in (self.alloc, self.requested, self.util):
            store.prune(live)


class NodePoolMetricsController:
    """metrics/nodepool: usage vs limits, node counts, weights."""

    def __init__(self, kube: KubeClient, cluster: Cluster):
        self.kube = kube
        self.cluster = cluster
        self.usage = Store(NODEPOOL_USAGE)
        self.limit = Store(NODEPOOL_LIMIT)
        self.count = Store(NODEPOOL_NODE_COUNT)
        self.weight = Store(NODEPOOL_WEIGHT)

    def reconcile_all(self, now: Optional[float] = None) -> None:
        del now
        live: set[str] = set()
        usage = self.cluster.nodepool_resources()
        for pool in self.kube.node_pools():
            name = pool.metadata.name
            live.add(name)
            base = {"nodepool": name}
            self.usage.update(
                name,
                [
                    ({**base, "resource_type": k}, float(v))
                    for k, v in usage.get(name, {}).items()
                ],
            )
            self.limit.update(
                name,
                [
                    ({**base, "resource_type": k}, float(v))
                    for k, v in (pool.spec.limits or {}).items()
                ],
            )
            self.count.update(
                name, [(base, float(self.cluster.nodepool_node_count(name)))]
            )
            self.weight.update(name, [(base, float(pool.spec.weight or 0))])
        for store in (self.usage, self.limit, self.count, self.weight):
            store.prune(live)


# Exponential histogram buckets 0.5 * 2^k, 15 buckets (0.5s .. 8192s) —
# the reference's transition histograms (controllers.go:113-131,
# prometheus.ExponentialBuckets(0.5, 2, 15))
TRANSITION_BUCKETS = tuple(0.5 * 2**k for k in range(15))

STATUS_CONDITION_COUNT = REGISTRY.gauge(
    "karpenter_status_condition_count",
    "Current condition count per kind, condition type and status",
)
STATUS_CONDITION_TRANSITIONS = REGISTRY.counter(
    "karpenter_status_condition_transitions_total",
    "Condition status transitions per kind, condition type and new status",
)
STATUS_CONDITION_TRANSITION_SECONDS = REGISTRY.histogram(
    "karpenter_status_condition_transition_seconds",
    "Time a condition spent in its previous status before transitioning",
    buckets=TRANSITION_BUCKETS,
)
STATUS_CONDITION_CURRENT_SECONDS = REGISTRY.gauge(
    "karpenter_status_condition_current_status_seconds",
    "Time the condition has spent in its current status",
)


class StatusConditionMetricsController:
    """Status-condition observability for NodeClaim, NodePool and Node
    (the operatorpkg status.Controller trio the reference registers at
    controllers.go:113-131): per-kind/type/status condition-count
    gauges, a transitions counter, and a transition-latency histogram
    with exponential buckets that observes how long each condition
    held its PREVIOUS status."""

    def __init__(self, kube: KubeClient, clock=None):
        import time as _time

        self.kube = kube
        self.clock = clock if clock is not None else _time.time
        self.store = Store(STATUS_CONDITION_COUNT)
        self.current = Store(STATUS_CONDITION_CURRENT_SECONDS)
        # (kind, object name) -> {condition type: (status, since)}
        self._seen: dict[tuple[str, str], dict[str, tuple[str, float]]] = {}

    def _object_conditions(self):
        for claim in self.kube.node_claims():
            yield ("NodeClaim", claim.metadata.name, [
                (c.type, c.status, c.last_transition_time)
                for c in claim.status_conditions.conditions
            ])
        for pool in self.kube.node_pools():
            yield ("NodePool", pool.metadata.name, [
                (c.type, c.status, c.last_transition_time)
                for c in pool.status_conditions.conditions
            ])
        for node in self.kube.nodes():
            yield ("Node", node.metadata.name, [
                (c.type, c.status, c.last_transition_time)
                for c in node.status.conditions
            ])

    def reconcile_all(self, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        live: set[str] = set()
        counts: dict[tuple[str, str, str], int] = {}
        for kind, name, conditions in self._object_conditions():
            obj_key = (kind, name)
            obj_id = f"{kind}/{name}"
            live.add(obj_id)
            prev = self._seen.setdefault(obj_key, {})
            # conditions REMOVED from the object (ConditionSet.clear —
            # the normal Consolidatable churn pattern) must leave the
            # tracking too: a later re-set is a fresh start, not a
            # continuation of the pre-clear status
            present = {ctype for ctype, _, _ in conditions}
            for stale in [t for t in prev if t not in present]:
                del prev[stale]
            current_rows = []
            for ctype, status, since in conditions:
                counts[(kind, ctype, status)] = (
                    counts.get((kind, ctype, status), 0) + 1
                )
                old = prev.get(ctype)
                if old is not None and old[0] != status:
                    STATUS_CONDITION_TRANSITIONS.inc(
                        {"kind": kind, "type": ctype, "status": status}
                    )
                    # the object's own lastTransitionTime bounds the
                    # previous status's duration exactly; the poll
                    # clock would inflate it by up to one reconcile
                    # interval
                    end = since if since > old[1] else now
                    STATUS_CONDITION_TRANSITION_SECONDS.observe(
                        max(0.0, end - old[1]),
                        {"kind": kind, "type": ctype, "status": old[0]},
                    )
                if old is None or old[0] != status:
                    prev[ctype] = (status, since if since > 0 else now)
                current_rows.append((
                    {"kind": kind, "type": ctype, "status": status,
                     "name": name},
                    max(0.0, now - prev[ctype][1]),
                ))
            # diff-published per object: a condition that flips status
            # drops its old-status series instead of exporting both
            self.current.update(obj_id, current_rows)
        # one diff-published series set for all condition counts
        self.store.update("all", [
            ({"kind": k, "type": t, "status": s}, float(v))
            for (k, t, s), v in counts.items()
        ])
        # drop tracking and current-status series for vanished objects
        self.current.prune(live)
        for key in [
            key for key in self._seen if f"{key[0]}/{key[1]}" not in live
        ]:
            del self._seen[key]
