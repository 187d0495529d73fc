"""Spot interruption controller: notice -> replace -> drain.

Copy of `karpenter_tpu/disruption/interruption.py`.

KubePACS-style interruption handling (PAPERS.md): a cloud interruption
notice is an EVENTUAL eviction — the capacity disappears whether or not
the controller acts. Acting early turns a forced outage into a planned
replacement:

- the node is tainted the moment the notice lands (the orchestration
  queue applies the standard disrupted NoSchedule taint, so no new pod
  boards doomed capacity) and its claim gets the `Interrupted`
  condition (consolidation skips it; kubectl sees it);
- replacement capacity is provisioned BEFORE draining starts
  (drain-after-replace — never capacity-gap-first): the displaced pods
  are re-solved against the cluster minus the interrupted node, the
  resulting claims are created immediately, and the candidate's drain
  waits until every replacement reports Initialized;
- the displaced pods route through the normal provisioning tick: the
  command's scheduling results ride the operator's pending-binding
  queue, so evicted pods land on the pre-provisioned claims instead of
  triggering a fresh solve (and a duplicate launch).

The OrchestrationQueue's replace-then-delete machinery is reused
wholesale, so interruption replacement inherits its wait-for-
Initialized gating, rollback, and retry semantics. Unlike graceful
disruption, interruption bypasses do-not-disrupt/PDB blocks and
disruption budgets at validation time (disruption/validation.py): the
reclaim happens regardless, and a planned drain strictly dominates the
forced one.

Notices come from the provider's `poll_interruptions()` hook (kwok /
fake): one `cloud_interrupt` fault-injector check per live spot
instance in sorted provider-id order, so a seeded
`spot_interruption@cloud_interrupt:*=rate` schedule is replay-identical
(solver/faults.py).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    INSTANCE_TYPE_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import COND_INTERRUPTED
from karpenter_tpu_torch.apis.v1.nodepool import REASON_INTERRUPTED
from karpenter_tpu_torch.disruption.engine import (
    Candidate,
    Command,
    DisruptionEngine,
    pod_disruption_cost,
)
from karpenter_tpu_torch.metrics.store import INTERRUPTION_COMMANDS
from karpenter_tpu_torch.state.cluster import StateNode

log = logging.getLogger("karpenter.interruption")

# how long a displaced pod may stay un-landed before new waves stop
# waiting for it: on a real substrate the workload owner may simply
# never recreate an evicted pod, and that must not wedge interruption
# handling forever
DISPLACED_LANDING_TTL_SECONDS = 15 * 60.0


class InterruptionController:
    """Polls the provider for interruption notices and starts one
    drain-after-replace command per noticed node."""

    def __init__(self, kube, cluster, cloud, engine: DisruptionEngine,
                 recorder=None):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.engine = engine
        self.queue = engine.queue
        self.recorder = recorder
        # provider ids whose command has been started (pruned once the
        # provider's notice clears — i.e. the instance is gone)
        self._handled: set[str] = set()
        # pod key -> (origin node name, landing deadline) for pods
        # displaced by started commands: a new wave must not be
        # simulated while any of these is still in flight (see
        # reconcile), but a pod that never comes back (real substrate:
        # the workload owner may not recreate it) must not wedge
        # interruption handling forever — the deadline bounds the wait
        self._displaced: dict[str, tuple[str, float]] = {}
        # commands this controller started that are (or were) in the
        # orchestration queue, with the provider ids they satisfy —
        # settled each reconcile so a rollback re-arms its notices
        self._inflight: list[tuple[Command, list[str]]] = []

    # -- one reconcile ---------------------------------------------------------

    def reconcile(self, now: Optional[float] = None) -> list[Command]:
        """Advance the provider's interruption checks, then start ONE
        replacement command covering every un-handled notice whose node
        is replaceable right now (the rest retry next tick). Returns
        the commands started this call so the operator can route their
        placements through the binding queue.

        Notices are batched into a single command per reconcile, and no
        new command starts while a previous interruption command is
        still in flight OR a previous wave's displaced pods have not
        landed yet: two waves simulated against state where the other's
        displaced pods have not rebound yet would each see the same
        free capacity and jointly overcommit it (the sim cannot know
        capacity a sibling wave's pending rebinds already spoke for).
        One wave at a time keeps every sim truthful; a storm converges
        one replacement wave per landing."""
        now = time.time() if now is None else now
        poll = getattr(self.cloud, "poll_interruptions", None)
        if poll is None:
            return []
        poll(now)
        self._settle_inflight(now)
        notices = set(getattr(self.cloud, "interrupted", ()) or ())
        self._handled &= notices  # instance gone -> notice consumed
        pending = [p for p in sorted(notices) if p not in self._handled]
        if not pending:
            return []
        # surface every fresh notice on its claim immediately (even
        # while the command must wait): consolidation skips noticed
        # nodes from this moment, and kubectl sees the condition
        wave: list[tuple[str, StateNode]] = []
        for pid in pending:
            node = self._notice(pid, now)
            if node is not None:
                wave.append((pid, node))
        if not wave:
            return []
        if any(c.reason == REASON_INTERRUPTED for c in self.queue.active):
            return []  # previous wave still draining; see docstring
        if self._landing_in_flight(now):
            return []  # previous wave's pods still rebinding
        candidates: list[Candidate] = []
        pids: list[str] = []
        for pid, node in wave:
            pool = self.kube.get_node_pool(node.nodepool_name())
            if pool is None:
                self._handled.add(pid)
                continue
            candidates.append(self._candidate(node, pool))
            pids.append(pid)
        if not candidates:
            return []
        results = None
        if any(c.reschedulable_pods for c in candidates):
            # pre-provision replacement capacity, co-solved with the
            # pending pods exactly like a consolidation command (the
            # results ride the binding queue either way, and a split
            # solve would let the provisioner's own tick race this
            # wave onto the same free capacity); a sim abort (capacity
            # still materializing — routine mid-storm) retries next
            # tick with the notices already surfaced
            results, ok = self.engine.simulate_scheduling(candidates)
            if not ok and not self.engine.has_uninitialized_capacity():
                # an unrelated unschedulable pending pod must not wedge
                # the forced reclaim forever: solve the wave's own pods
                # alone
                results, ok = self.engine.simulate_scheduling(
                    candidates, include_pending=False
                )
            if not ok:
                log.info(
                    "interruption replacement wave (%d nodes) deferred "
                    "(cluster still materializing capacity)",
                    len(candidates),
                )
                return []
        command = Command(
            reason=REASON_INTERRUPTED, candidates=candidates,
            results=results,
        )
        self.queue.start_command(command, now)
        if command not in self.queue.active:
            # replacement creation failed and the queue rolled the
            # command back (e.g. nodepool limits): leave the notices
            # un-handled so the wave retries next tick
            log.warning(
                "interruption replacement wave (%d nodes) rolled back "
                "at start; retrying next tick", len(candidates),
            )
            return []
        self._inflight.append((command, pids))
        from karpenter_tpu_torch import explain

        for candidate in candidates:
            # terminal verdict: the cloud is reclaiming this node; the
            # wave's drain-after-replace owns it from here (overwrites
            # any weak keep a deferred earlier simulation recorded)
            explain.note_candidate(
                candidate.state_node.name, explain.VERDICT_INTERRUPTED,
                replacements=command.replacement_count,
            )
            INTERRUPTION_COMMANDS.inc(
                {"nodepool": candidate.node_pool.metadata.name}
            )
            for pod in candidate.reschedulable_pods:
                self._displaced[pod.key] = (
                    candidate.state_node.name,
                    now + DISPLACED_LANDING_TTL_SECONDS,
                )
        for pid in pids:
            self._handled.add(pid)
        log.info(
            "interruption: replacing %d node(s) (%d pods, %d replacement "
            "nodes) before drain", len(candidates),
            sum(len(c.reschedulable_pods) for c in candidates),
            command.replacement_count,
        )
        return [command]

    def _settle_inflight(self, now: float) -> None:
        """Resolve commands that have left the orchestration queue: a
        drained command's candidates are deleting (success — the
        notices stay handled until the instances vanish), a ROLLED BACK
        command's candidates are alive and untainted — its notices are
        re-armed so the wave retries, and its displaced-pod tracking is
        dropped (nothing was evicted)."""
        still: list[tuple[Command, list[str]]] = []
        for command, pids in self._inflight:
            if command in self.queue.active:
                still.append((command, pids))
                continue
            for candidate, pid in zip(command.candidates, pids):
                claim = candidate.state_node.node_claim
                live = (
                    self.kube.get_node_claim(claim.metadata.name)
                    if claim is not None else None
                )
                if live is not None and live.metadata.deletion_timestamp is None:
                    # rollback: the reclaim is still coming — retry
                    self._handled.discard(pid)
                    for pod in candidate.reschedulable_pods:
                        self._displaced.pop(pod.key, None)
        self._inflight = still

    def _landing_in_flight(self, now: float) -> bool:
        """True while a previous wave's displaced pods have not landed
        yet. Entries prune when the pod is gone/terminal, bound to a
        node other than its origin, or past its landing deadline."""
        still: dict[str, tuple[str, float]] = {}
        for key, (origin, deadline) in self._displaced.items():
            pod = self.kube.get_pod(*key.split("/", 1))
            if pod is None or pod.is_terminal():
                continue
            if pod.spec.node_name and pod.spec.node_name != origin:
                continue  # landed on its replacement capacity
            if now >= deadline:
                log.warning(
                    "displaced pod %s never landed within %ds; no "
                    "longer deferring interruption waves on it",
                    key, int(DISPLACED_LANDING_TTL_SECONDS),
                )
                continue
            still[key] = (origin, deadline)
        self._displaced = still
        return bool(still)

    def _notice(self, pid: str, now: float) -> Optional[StateNode]:
        """Stamp the Interrupted condition for one notice; returns the
        node when it is actionable this tick (registered, not already
        draining), else None (handled or retried later)."""
        node = self._node_for_pid(pid)
        if node is None:
            return None  # instance not registered yet; retry next tick
        claim = node.node_claim
        if claim is None or claim.metadata.deletion_timestamp is not None:
            self._handled.add(pid)
            return None
        if not claim.status_conditions.is_true(COND_INTERRUPTED):
            claim.status_conditions.set_true(
                COND_INTERRUPTED, reason="SpotInterruption", now=now,
            )
            self.kube.touch(claim)
            self._record(node, now)
        if node.deleting():
            # already being drained by another command (or its own
            # deletion): that command satisfies the notice
            self._handled.add(pid)
            return None
        return node

    # -- helpers ---------------------------------------------------------------

    def _node_for_pid(self, pid: str) -> Optional[StateNode]:
        for node in self.cluster.nodes():
            if node.provider_id == pid and node.node is not None:
                return node
        return None

    def _candidate(self, node: StateNode, pool) -> Candidate:
        """Candidate for a forced reclaim: every live non-daemon pod is
        reschedulable — do-not-disrupt and PDBs do not veto (the cloud
        evicts regardless; validation applies the same eventual
        rules)."""
        pods = []
        for pod_key in node.pod_keys:
            pod = self.kube.get_pod(*pod_key.split("/", 1))
            if pod is None or pod.is_terminal() or pod.is_terminating():
                continue
            if pod.owner_kind() == "DaemonSet":
                continue
            pods.append(pod)
        labels = node.labels()
        return Candidate(
            state_node=node,
            node_pool=pool,
            reschedulable_pods=pods,
            instance_type_name=labels.get(INSTANCE_TYPE_LABEL, ""),
            capacity_type=labels.get(CAPACITY_TYPE_LABEL, ""),
            zone=labels.get(TOPOLOGY_ZONE_LABEL, ""),
            price=0.0,  # interruption never price-compares
            disruption_cost=sum(pod_disruption_cost(p) for p in pods),
        )

    def _record(self, node: StateNode, now: float) -> None:
        if self.recorder is None:
            return
        from karpenter_tpu_torch.events.recorder import Event

        if node.node is not None:
            self.recorder.publish(Event(
                kind="Node", name=node.node.metadata.name, type="Warning",
                reason="SpotInterrupted",
                message="Cloud signaled a spot interruption notice; "
                        "replacing before drain",
            ), now=now)
