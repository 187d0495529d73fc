"""Preemption-aware provisioning: higher priority nominates victims.

Copy of `karpenter_tpu/provisioning/preemption.py`.

Priority admission (provisioning/priority.py) decides WHO waits when
demand exceeds capacity at solve time. But a pending higher-priority
pod can also arrive AFTER lower-priority pods already bound — the
solve finds no launchable or existing capacity (pool limits, catalog
exhaustion) and the pod would wait behind workload it outranks. The
kube-scheduler answers this with preemption
(pkg/scheduler/framework/preemption); this controller is its analogue
on the provisioning side:

- **Who may preempt**: a pending pod with a capacity-class failure
  from the last solve, positive resolved priority, and a PriorityClass
  whose `preemptionPolicy` is not `Never`.
- **Who may be a victim**: a bound, evictable pod of STRICTLY lower
  priority — never equal or higher — that is not a daemon/mirror pod,
  not do-not-disrupt, and whose PodDisruptionBudgets allow the
  eviction (the whole victim SET is budgeted per PDB via
  `utils/pdb.py`, not just the first victim; the eviction subresource
  re-checks server-side).
- **Ordering** (the drain-after-replace discipline borrowed from
  disruption/interruption.py, transposed to pods): the landing is
  secured BEFORE anything is killed — the victim node is nominated
  (its state node's nomination window keeps consolidation off it, the
  preemptor's `status.nominatedNodeName` records the plan the way the
  kube-scheduler does), the preemptor's binding plan is handed to the
  operator's pending-binding queue, and only then are the victims
  evicted through the termination layer's EvictionQueue (PDB 429
  backoff and workload-owner rebirth semantics included). Displaced
  victims rebirth pending and re-enter the next solve, where priority
  admission sheds them if the overload persists — by policy, not by
  race.
- **Node choice** is deterministic: among feasible nodes the one with
  the smallest (highest victim priority, victim count, name) wins —
  evict the least important, fewest pods, stable tie-break.

Preemptors with machinery the fit check cannot model (topology
constraints, host ports, volumes, DRA) are skipped — the full
scheduler path owns those, and a wrong preemption is strictly worse
than a waiting pod.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import DO_NOT_DISRUPT_ANNOTATION
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics.store import (
    PREEMPTION_EVICTIONS,
    PREEMPTION_NOMINATIONS,
)
from karpenter_tpu_torch.provisioning.priority import CAPACITY_ERRORS
from karpenter_tpu_torch.provisioning.scheduler import SchedulerResults
from karpenter_tpu_torch.scheduling.priority import (
    class_map,
    default_class,
    preemption_allowed,
    resolve_pod_priorities,
    resolve_priority,
)
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.taints import tolerates_pod
from karpenter_tpu_torch.utils import resources as resutil
from karpenter_tpu_torch.utils.pdb import PdbLimits

log = logging.getLogger("karpenter.preemption")

# at most this many preemptors act per reconcile — each eviction churns
# the cluster, and the next solve re-ranks anyway
MAX_PREEMPTIONS_ENV = "KARPENTER_PREEMPTION_MAX"
DEFAULT_MAX_PREEMPTIONS = 16

WELL_KNOWN = None  # resolved lazily (import cycle hygiene)


def _well_known():
    global WELL_KNOWN
    if WELL_KNOWN is None:
        from karpenter_tpu_torch.apis.v1.labels import WELL_KNOWN_LABELS

        WELL_KNOWN = WELL_KNOWN_LABELS
    return WELL_KNOWN


class PreemptionController:
    def __init__(self, kube, cluster, provisioner, recorder=None):
        self.kube = kube
        self.cluster = cluster
        self.provisioner = provisioner
        self.recorder = recorder
        from karpenter_tpu_torch.lifecycle.termination import EvictionQueue

        # the termination layer's queue: PDB 429 backoff + simulation-
        # substrate rebirth, exactly as drains evict
        self.evictions = EvictionQueue(kube, recorder=recorder)
        # per-reconcile PriorityClass view for resolved comparisons
        self._classes: dict = {}
        self._default = None

    # -- one reconcile --------------------------------------------------------

    def reconcile(
        self, results: Optional[SchedulerResults],
        now: Optional[float] = None,
    ) -> list[SchedulerResults]:
        """Act on the round's capacity failures. Returns binding plans
        (preemptor -> nominated node) for the operator's pending-
        binding queue — the landing rides the same machinery every
        other placement does."""
        now = time.time() if now is None else now
        if results is None or not results.errors:
            return []
        preemptors = self._preemptors(results)
        if not preemptors:
            return []
        classes = class_map(self.kube.list("PriorityClass"))
        # victim comparisons must use RESOLVED priorities too: a bound
        # pod whose priority exists only through its priorityClassName
        # (stamped onto a different object copy, or never solved by us
        # at all) would otherwise read as 0 and be preemptable by a
        # lower-actual-priority pod
        self._classes = classes
        self._default = default_class(classes.values())
        budget = int(os.environ.get(
            MAX_PREEMPTIONS_ENV, str(DEFAULT_MAX_PREEMPTIONS)
        ))
        pdb = PdbLimits(self.kube)
        plans: list[SchedulerResults] = []
        for pod in preemptors:
            if budget <= 0:
                break
            if not preemption_allowed(pod, classes):
                continue
            choice = self._choose_victims(pod, pdb)
            if choice is None:
                continue
            node, victims = choice
            if not self._execute(pod, node, victims, now):
                continue
            budget -= 1
            binding = SchedulerResults(
                new_node_plans=[],
                existing_assignments={node.name: [pod]},
            )
            plans.append(binding)
        return plans

    # -- selection ------------------------------------------------------------

    def _preemptors(self, results: SchedulerResults) -> list[Pod]:
        """Capacity-failed pending pods with positive priority, highest
        first (deterministic tie-break on key)."""
        out = []
        for key, error in results.errors.items():
            if error not in CAPACITY_ERRORS:
                continue
            pod = self.kube.get_pod(*key.split("/", 1))
            if pod is None or pod.is_terminal() or pod.spec.node_name:
                continue
            spec = pod.spec
            if (
                spec.volumes or spec.topology_spread_constraints
                or spec.injected_requirements
            ):
                continue
            aff = spec.affinity
            if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
                continue
            from karpenter_tpu_torch.scheduling.hostports import pod_host_ports

            if pod_host_ports(pod):
                continue
            out.append(pod)
        resolve_pod_priorities(out, self.kube)
        out = [p for p in out if p.spec.priority > 0]
        out.sort(key=lambda p: (-p.spec.priority, p.key))
        return out

    def _priority(self, pod: Pod) -> int:
        """The pod's RESOLVED priority against this reconcile's class
        map (see reconcile); raw spec.priority when already stamped."""
        return resolve_priority(pod, self._classes, self._default)

    def _choose_victims(self, pod: Pod, pdb: PdbLimits):
        """The deterministic node + minimal victim set for one
        preemptor, or None when no node can be freed for it."""
        pod_reqs = Requirements.from_pod(pod, required_only=True)
        requests = resutil.pod_requests(pod)
        best = None
        best_score = None
        for node in sorted(self.cluster.nodes(), key=lambda n: n.name):
            if node.deleting() or node.node is None:
                continue
            if tolerates_pod(list(node.taints()), pod) is not None:
                continue
            node_reqs = Requirements.from_labels(node.labels())
            if not node_reqs.is_compatible(
                pod_reqs, allow_undefined=_well_known()
            ):
                continue
            victims = self._victims_on(node, pod, requests, pdb)
            if victims is None:
                continue
            score = (
                max(self._priority(v) for v in victims),
                len(victims),
                node.name,
            )
            if best_score is None or score < best_score:
                best, best_score = (node, victims), score
        return best

    def _victims_on(self, node, pod: Pod, requests, pdb: PdbLimits):
        """Minimal lower-priority victim set on one node that frees
        room for `pod`, lowest priorities evicted first; None when the
        node cannot be freed within the rules."""
        candidates = []
        for pod_key in node.pod_keys:
            victim = self.kube.get_pod(*pod_key.split("/", 1))
            if victim is None or victim.is_terminal() or victim.is_terminating():
                continue
            if victim.owner_kind() in ("DaemonSet", "Node"):
                continue
            # resolved comparison (see reconcile): a class-named bound
            # pod must rank at its class value, not the unstamped 0
            if resolve_priority(
                victim, self._classes, self._default
            ) >= pod.spec.priority:
                continue  # never equal or higher
            if (
                victim.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION)
                == "true"
            ):
                continue
            if pdb.can_evict(victim) is not None:
                continue
            candidates.append(victim)
        if not candidates:
            return None
        candidates.sort(key=lambda v: (self._priority(v), v.key))
        available = dict(node.available())
        chosen: list[Pod] = []
        per_pdb: dict[str, int] = {}
        for victim in candidates:
            if resutil.fits(requests, available):
                break
            # the whole victim set must stay within every selecting
            # PDB's remaining budget — can_evict above is per pod and
            # cannot see its siblings
            blocked = False
            for budget in pdb.matching(victim):
                used = per_pdb.get(budget.key, 0)
                if used + 1 > pdb.disruptions_allowed(budget):
                    blocked = True
                    break
            if blocked:
                continue
            for budget in pdb.matching(victim):
                per_pdb[budget.key] = per_pdb.get(budget.key, 0) + 1
            chosen.append(victim)
            available = resutil.merge(
                available, resutil.pod_requests(victim)
            )
        if not chosen or not resutil.fits(requests, available):
            return None
        return chosen

    # -- execution ------------------------------------------------------------

    def _execute(self, pod: Pod, node, victims: Sequence[Pod],
                 now: float) -> bool:
        """Nominate first, then evict — the landing is secured before
        anything is killed (the pod-level drain-after-replace)."""
        node.nominate(now=now)
        pod.status.nominated_node_name = node.name
        self.kube.touch(pod)
        PREEMPTION_NOMINATIONS.inc()
        from karpenter_tpu_torch import explain

        if explain.active() is not None:
            # the preemption verdict: who landed where, at what
            # priority cutoff, over which victim set — queryable at
            # /debug/explain?pod=<preemptor or victim>
            explain.note_pod(
                pod.key, verdict="preempted-onto", node=node.name,
                cutoff_priority=int(pod.spec.priority),
                victims=sorted(v.key for v in victims),
            )
            for victim in victims:
                explain.note_pod(
                    victim.key, verdict="preemption-victim",
                    preemptor=pod.key, node=node.name,
                    victim_priority=self._priority(victim),
                )
        self._record(pod, node, victims, now)
        evicted = 0
        for victim in victims:
            # EvictionQueue: the eviction subresource (server-side PDB
            # re-check), 429 backoff, and workload-owner rebirth on the
            # simulation substrate — exactly how drains evict
            if self.evictions.evict(victim, now=now):
                evicted += 1
                PREEMPTION_EVICTIONS.inc({
                    "nodepool": node.nodepool_name() or "",
                })
            else:
                log.warning(
                    "preemption: eviction of %s for %s blocked "
                    "(PDB raced the plan); will retry next round",
                    victim.key, pod.key,
                )
        log.info(
            "preemption: %s (priority %d) nominated node %s; evicted "
            "%d/%d lower-priority victim(s)",
            pod.key, pod.spec.priority, node.name, evicted, len(victims),
        )
        return evicted > 0

    def _record(self, pod: Pod, node, victims: Sequence[Pod],
                now: float) -> None:
        if self.recorder is None:
            return
        from karpenter_tpu_torch.events.recorder import Event

        self.recorder.publish(Event(
            kind="Pod", name=pod.metadata.name,
            namespace=pod.metadata.namespace, type="Normal",
            reason="Nominated",
            message=f"Pod should preempt onto node {node.name} "
                    f"({len(victims)} lower-priority victim(s))",
        ), now=now)
        for victim in victims:
            self.recorder.publish(Event(
                kind="Pod", name=victim.metadata.name,
                namespace=victim.metadata.namespace, type="Warning",
                reason="Preempted",
                message=f"Preempted by higher-priority pod {pod.key}",
            ), now=now)
