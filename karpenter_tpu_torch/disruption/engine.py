"""Disruption engine: emptiness / drift / consolidation.

Counterpart of pkg/controllers/disruption (13.5k LoC): a polling
controller that gathers disruptable candidates, applies cron-window
budgets, and tries each Method in order — Emptiness, Drift,
MultiNodeConsolidation, SingleNodeConsolidation — first success wins
(controller.go:98-176). Consolidation decisions re-run the provisioning
scheduler with candidates excluded (SimulateScheduling, helpers.go:52)
and compare replacement price against the candidates' current price,
including the spot-to-spot flexibility floor (consolidation.go:237-311).

The multi-node search keeps the reference's binary-search-over-prefix
shape (multinodeconsolidation.go:116-169); each probe is one batched
solver call, so a full search is O(log N) solver launches instead of
O(log N) sequential Go scheduling loops.

Copy of `karpenter_tpu/disruption/engine.py`, whole, with its imports
pointed into `karpenter_tpu_torch`. The one addition is the device:
`DisruptionEngine(..., device=...)` defaults to its Provisioner's;
`None` means the card and raises without a CUDA device. Every
Scheduler, `BatchProbeSolver` and `LaneSolver` the engine builds runs
on it. On a CUDA device nothing on the engine's path falls back on its
own: a failure in the probe batch's set-up, its dispatch or a lane's
decode, in the pruner's certificate, or in an execution-time
validation reaches the caller unless `resilience.may_degrade` admits
it (an injected fault, a deadline). Off the card each degrades as in
the JAX package.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from karpenter_tpu_torch.apis.v1.labels import (
    CAPACITY_TYPE_LABEL,
    CAPACITY_TYPE_SPOT,
    DISRUPTED_NO_SCHEDULE_TAINT,
    DO_NOT_DISRUPT_ANNOTATION,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    TOPOLOGY_ZONE_LABEL,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    COND_CONSOLIDATABLE,
    COND_DISRUPTION_REASON,
    COND_DRIFTED,
    NodeClaim,
)
from karpenter_tpu_torch.apis.v1.nodepool import (
    CONSOLIDATION_WHEN_EMPTY,
    REASON_DRIFTED,
    REASON_EMPTY,
    REASON_UNDERUTILIZED,
    NodePool,
)
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, effective_price
from karpenter_tpu_torch import explain
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics.store import (
    DISRUPTION_EVALUATION_DURATION,
    DISRUPTION_PROBE_STARVATION,
    DISRUPTION_SNAPSHOT,
    NODECLAIMS_DISRUPTED,
)
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.provisioning.scheduler import (
    Scheduler,
    SchedulerResults,
    _state_node_key,
)
from karpenter_tpu_torch.solver import resilience
from karpenter_tpu_torch.solver.solver import _backend, resolve_device
from karpenter_tpu_torch.state.cluster import Cluster, StateNode
from karpenter_tpu_torch.utils.pdb import PdbLimits

log = logging.getLogger("karpenter.disruption")

# consolidation constants (consolidation.go:46-49)
SPOT_TO_SPOT_MIN_TYPES = 15
MULTI_NODE_MAX_CANDIDATES = 100  # multinodeconsolidation.go:86
COMMAND_TIMEOUT_SECONDS = 10 * 60  # orchestration retry deadline (queue.go:86)
# method wall-clock bounds: the multi-node search keeps the last valid
# command when time runs out (multinodeconsolidation.go:35,116-169);
# single-node stops mid-scan (singlenodeconsolidation.go:34)
MULTI_NODE_TIMEOUT_SECONDS = 60.0
SINGLE_NODE_TIMEOUT_SECONDS = 3 * 60.0
# candidate cap for the one-shot global repack: bounds the cost solve
# the way the prefix search caps at 100 (multinodeconsolidation.go:86)
# while letting the batched objective see far more of the fleet
GLOBAL_REPACK_MAX_CANDIDATES = 500
# extra prefixes probed above the binary-search result (largest first):
# the amortized-merge payoff concentrates just above the failing
# midpoint, and an uncapped sweep would burn the whole timeout on O(N)
# device solves every round when no larger merge exists
MULTI_NODE_SWEEP_PROBES = 8
# the engine's default device: its Provisioner's
_PROVISIONER_DEVICE = object()


@dataclass
class Candidate:
    """One disruptable node (disruption/types.go:73-121)."""

    state_node: StateNode
    node_pool: NodePool
    reschedulable_pods: list[Pod]
    instance_type_name: str
    capacity_type: str
    zone: str
    price: float
    disruption_cost: float


@dataclass
class _CandidateCore:
    """Retained per-node candidate-scan material (see
    DisruptionEngine._candidate_core). PDB verdicts are deliberately
    NOT cached: disruptions_allowed derives from the whole selected
    pod population's live health, which pod events on OTHER nodes
    change without touching this node's dirt — the scan re-asks
    can_evict per pod against a per-scan allowance-memoized PdbLimits
    instead."""

    ver: tuple
    # [(pod, is_daemon)] over the node's bound pods, sorted by pod key
    pod_info: list
    labels: dict
    price_fp: object = None   # catalog fingerprint price resolved at
    price: Optional[float] = None


@dataclass
class Command:
    """A decided disruption (types.go:129)."""

    reason: str
    candidates: list[Candidate]
    results: Optional[SchedulerResults] = None  # replacement plans
    started_at: float = 0.0

    @property
    def replacement_count(self) -> int:
        return len(self.results.new_node_plans) if self.results else 0


def pod_disruption_cost(pod: Pod) -> float:
    """EvictionCost (utils/disruption/disruption.go): base 1.0, plus
    the pod-deletion-cost annotation scaled by 2^27 (min cost ~ -15
    pods, max ~ +17) and the scheduling priority scaled by 2^25,
    clamped to [-10, 10]."""
    cost = 1.0
    raw = pod.metadata.annotations.get(
        "controller.kubernetes.io/pod-deletion-cost"
    )
    if raw is not None:
        try:
            cost += float(raw) / 2.0**27
        except ValueError:
            log.warning("bad pod-deletion-cost %r on %s", raw, pod.key)
    if pod.spec.priority:
        cost += float(pod.spec.priority) / 2.0**25
    return max(-10.0, min(10.0, cost))


class DisruptionEngine:
    def __init__(
        self,
        kube: KubeClient,
        cluster: Cluster,
        cloud: CloudProvider,
        provisioner: Provisioner,
        queue: Optional["OrchestrationQueue"] = None,
        seed: int = 0,
        options=None,
        clock=None,
        recorder=None,
        device=_PROVISIONER_DEVICE,
    ):
        from karpenter_tpu_torch.operator.options import Options

        # the device of every solve the engine makes: its Provisioner's
        # unless the caller names one (None: the card, raising without
        # one); the host backend runs no device
        if _backend() == "host":
            self.device = None
        elif device is _PROVISIONER_DEVICE:
            self.device = resolve_device(provisioner.device)
        else:
            self.device = resolve_device(device)
        self.clock = clock if clock is not None else time.monotonic
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.provisioner = provisioner
        self.queue = queue or OrchestrationQueue(
            kube, cluster, provisioner, recorder=recorder
        )
        self.options = options or Options()
        self._rng = random.Random(seed)
        # per-round offering price index; reset by get_candidates
        self._price_index: dict[str, dict[tuple[str, str, str], float]] = {}
        # batched-probe state: a thread-local probe cache — the search
        # methods prime it, simulate_scheduling consults it
        self._probe_tls = threading.local()
        # the retained-inputs seam: every fleet snapshot a
        # scan or simulation consumes comes from here, O(dirty) —
        # candidate scans additionally retain per-node cores (pod
        # lists, PDB verdicts, labels, prices) stamped with the seam's
        # dirt generations
        from karpenter_tpu_torch.state.retained import RetainedFleetSeam

        self.fleet_seam = RetainedFleetSeam(
            kube, cluster,
            pools_fn=provisioner.ready_pools_with_types,
            options=self.options,
        )
        self._cand_cores: dict[str, "_CandidateCore"] = {}
        self._cand_scans = 0
        self._audit_scan = False
        self._retain_cores = True
        self._core_hits = self._core_rebuilds = 0
        from karpenter_tpu_torch.disruption.validation import Validator

        self.queue.validator = Validator(self)

    # -- batched probes (solver/consolidation_batch.py) ------------------------

    def _get_probe_cache(self) -> Optional[dict]:
        return getattr(self._probe_tls, "cache", None)

    def _set_probe_cache(self, value: Optional[dict]) -> None:
        self._probe_tls.cache = value

    def _get_probe_pruner(self):
        return getattr(self._probe_tls, "pruner", None)

    def _set_probe_pruner(self, value) -> None:
        self._probe_tls.pruner = value

    @staticmethod
    def probe_pruning_enabled() -> bool:
        return os.environ.get(
            "KARPENTER_LP_PRUNE", "1"
        ).lower() not in ("0", "false", "off")

    def batch_probes_enabled(self) -> bool:
        return os.environ.get(
            "KARPENTER_BATCH_PROBES", "1"
        ).lower() not in ("0", "false", "off")

    def _probe_solver(self):
        """A fresh shared-snapshot BatchProbeSolver per SEARCH METHOD
        (not per reconcile round): watch events land on the cluster
        mirror concurrently, so a snapshot shared across methods could
        serve drift-era verdicts to the single-node scan. One snapshot
        per ladder keeps freshness within the same window a sequential
        scan has, while still amortizing deep_copy_nodes()/Scheduler/
        encode across every probe of that ladder."""
        return self._build_probe_solver()

    def _build_probe_solver(self):
        if not self.batch_probes_enabled():
            return None
        # the sequential probe aborts per-call while capacity is still
        # materializing; skipping the batch reproduces that verdict
        # through the unchanged sequential path
        if self.has_uninitialized_capacity():
            return None
        # device breaker open: don't even pay the snapshot + Scheduler
        # + encode setup for a batch that would only re-fault — the
        # sequential probes' own solves ride the resilience ladder to
        # whichever rung still works (usable() re-checks post-build
        # for the race where the breaker opens during setup)
        if resilience.shared().breaker("device").is_open():
            log.warning(
                "device breaker open; skipping batched probe setup for "
                "this ladder")
            return None
        # the host backend: the batch would only answer unusable()
        if self.device is None:
            return None
        from karpenter_tpu_torch.solver.consolidation_batch import BatchProbeSolver

        try:
            # the retained seam serves the ladder's shared snapshot;
            # the batch never mutates its rows (lanes are evaluated
            # against encoded arrays), so a whole probe ladder costs
            # zero re-copies
            snapshot, input_cache = self.fleet_seam.fleet_snapshot()
            solver = BatchProbeSolver(
                pools_with_types=self.provisioner.ready_pools_with_types(),
                snapshot=snapshot,
                daemonsets=self.cluster.daemonsets(),
                cluster_pods=self.kube.pods(),
                pending_pods=self.provisioner.get_pending_pods(),
                options=self.options,
                kube=self.kube,
                clock=self.clock,
                compat_cache=self.provisioner.encode_cache,
                existing_input_cache=input_cache,
                device=self.device,
            )
        except Exception as err:
            if not self.may_degrade(err):
                raise
            log.exception("probe batch setup failed; probing sequentially")
            return None
        return solver if solver.usable() else None

    def may_degrade(self, err: BaseException) -> bool:
        """Whether a failure on the engine's path may fall back (to the
        sequential probe, to probing without pruning): always off the
        card; on a CUDA device only an injected fault or a deadline."""
        return self.device is None or resilience.may_degrade(err, self.device)

    def _probe_primer(self, lane_specs: list) -> "_ProbePrimer":
        return _ProbePrimer(self, lane_specs)

    # -- candidates (helpers.go:174-193) ---------------------------------------

    def get_candidates(self, reason: str, now: float) -> list[Candidate]:
        out = []
        # allowance memoized per SCAN: disruptions_allowed walks the
        # namespace's whole pod population per selecting PDB, and a
        # read-only scan over a fixed population sees one answer per
        # PDB — per-pod recomputation was the dominant scan cost
        pdb = PdbLimits(self.kube, memoize_allowance=True)
        # price lookups hit a per-round offering index instead of
        # re-fetching the full catalog per candidate (O(candidates ×
        # catalog) otherwise; the reference resolves prices from the
        # instance types already fetched for the scheduling run)
        self._price_index = {}
        protected = self.queue.protected_claim_names()
        # retained candidate cores: the per-node pod list,
        # PDB verdicts, labels and price survive across scans and
        # methods, refreshed only for keys the seam's watch dirt
        # names; every Nth scan is an identity audit against the
        # from-scratch derivation
        self.fleet_seam.sync()
        self._cand_scans += 1
        audit_every = self.fleet_seam.audit_every
        self._audit_scan = (
            audit_every > 0 and self._cand_scans % audit_every == 0
        )
        from karpenter_tpu_torch.state.retained import retained_enabled

        self._retain_cores = retained_enabled()
        self._core_hits = self._core_rebuilds = 0
        catalog_fp = self._candidate_catalog_fp()
        for node in self.cluster.nodes():
            candidate = self._build_candidate(node, reason, pdb, now,
                                              protected,
                                              catalog_fp=catalog_fp)
            if candidate is not None:
                out.append(candidate)
        self._audit_scan = False
        # metric increments batched per scan (a per-node inc was
        # measurable against the scan wall the cores exist to shrink)
        if self._core_hits:
            DISRUPTION_SNAPSHOT.inc(
                {"outcome": "hit"}, value=float(self._core_hits)
            )
            self.fleet_seam.hits += self._core_hits
        if self._core_rebuilds:
            DISRUPTION_SNAPSHOT.inc(
                {"outcome": "rebuild"}, value=float(self._core_rebuilds)
            )
            self.fleet_seam.rebuilds += self._core_rebuilds
        return out

    def _candidate_catalog_fp(self):
        """Cheap catalog identity stamping the cores' cached prices —
        a reprice/overlay/ICE flip re-resolves them, nothing else
        does. None (fetch hiccup) disables price caching this scan."""
        try:
            from karpenter_tpu_torch.solver.incremental import (
                catalog_fingerprint,
            )

            return catalog_fingerprint(
                self.provisioner.ready_pools_with_types()
            )
        except Exception:
            return None

    def _candidate_core(
        self, node: StateNode, pdb: PdbLimits, catalog_fp,
    ) -> "_CandidateCore":
        """The retained expensive half of one node's candidate scan:
        pod fetches, PDB matching, the label merge and the price
        lookup. Stamped with the seam's dirt generations; a stale (or
        audit-scan) core rebuilds from scratch, and an audit mismatch
        invalidates every core."""
        key = _state_node_key(node)
        ver = self.fleet_seam.node_version(key) + (
            self.fleet_seam.pdb_epoch,
        )
        core = self._cand_cores.get(key) if key else None
        retain = self._retain_cores and bool(key)
        if core is not None and core.ver == ver and not self._audit_scan:
            self._core_hits += 1
            return core
        fresh = _CandidateCore(ver=ver, pod_info=[],
                               labels=dict(node.labels()))
        for pod_key in sorted(node.pod_keys):
            pod = self.kube.get_pod(*pod_key.split("/", 1))
            if pod is None:
                continue
            fresh.pod_info.append((
                pod,
                pod.owner_kind() == "DaemonSet",
            ))
        if core is not None and core.ver == ver and self._audit_scan:
            # decision-identity oracle: the retained core must match
            # the from-scratch derivation field for field
            DISRUPTION_SNAPSHOT.inc({"outcome": "audit"})
            same = (
                core.labels == fresh.labels
                and len(core.pod_info) == len(fresh.pod_info)
                and all(
                    a[0] is b[0] and a[1] == b[1]
                    for a, b in zip(core.pod_info, fresh.pod_info)
                )
            )
            if not same:
                DISRUPTION_SNAPSHOT.inc({"outcome": "divergence"})
                log.error(
                    "retained candidate core for %s diverged from the "
                    "from-scratch scan; invalidating candidate cores",
                    key,
                )
                self._cand_cores.clear()
            else:
                fresh.price_fp = core.price_fp
                fresh.price = core.price
        else:
            self._core_rebuilds += 1
        if retain:
            self._cand_cores[key] = fresh
        return fresh

    def _build_candidate(
        self, node: StateNode, reason: str, pdb: PdbLimits, now: float,
        protected: frozenset = frozenset(),
        catalog_fp=None,
    ) -> Optional[Candidate]:
        # Every node the scan rejects for a POLICY reason gets a
        # structured verdict in the explain plane (`kept:<reason>`) —
        # the answer to "why is this node still here". Mechanical
        # skips (deleting, unmanaged, static pools, not-drifted in a
        # drift scan) stay silent: they are the normal state of most
        # of the fleet, not a decision worth a record.
        if node.deleting():
            return None
        if node.nominated(now):
            explain.note_candidate(node.name, explain.KEPT_NOMINATED)
            return None
        disruptable_err = node.validate_node_disruptable()
        if disruptable_err is not None:
            if "do-not-disrupt" in disruptable_err:
                explain.note_candidate(
                    node.name, explain.KEPT_DO_NOT_DISRUPT, source="node"
                )
            return None
        claim = node.node_claim
        if claim is None:
            return None
        if claim.metadata.name in protected:
            return None  # an in-flight command's replacement
        from karpenter_tpu_torch.apis.v1.nodeclaim import COND_INTERRUPTED

        if claim.status_conditions.is_true(COND_INTERRUPTED):
            # holding a cloud interruption notice: the interruption
            # controller owns this node's replacement — a concurrent
            # consolidation command would race the drain
            explain.note_candidate(node.name, explain.KEPT_INTERRUPTED)
            return None
        pool = self.kube.get_node_pool(node.nodepool_name())
        if pool is None or pool.is_static():
            return None
        # method eligibility via conditions
        if reason == REASON_EMPTY or reason == REASON_UNDERUTILIZED:
            if not claim.status_conditions.is_true(COND_CONSOLIDATABLE):
                explain.note_candidate(
                    node.name, explain.KEPT_NOT_CONSOLIDATABLE, weak=True
                )
                return None
            if (
                reason == REASON_UNDERUTILIZED
                and pool.spec.disruption.consolidation_policy == CONSOLIDATION_WHEN_EMPTY
            ):
                return None
        if reason == REASON_DRIFTED and not claim.status_conditions.is_true(COND_DRIFTED):
            return None
        # Drift is the EVENTUAL disruption class (drift.go:111): with a
        # TerminationGracePeriod on the claim, pod-block errors — the
        # do-not-disrupt annotation and zero-budget PDBs — do NOT
        # disqualify the candidate (types.go:115-121), because the
        # drain is bounded: termination force-completes at the TGP
        # deadline. Consolidation/emptiness are GRACEFUL and always
        # respect blocking pods.
        eventual = (
            reason == REASON_DRIFTED
            and claim.spec.termination_grace_period is not None
        )
        # pods must be evictable (ValidatePodsDisruptable
        # statenode.go:234): the do-not-disrupt check covers every
        # ACTIVE pod (mirror and daemonset pods may block with the
        # annotation too); the PDB check self-gates on evictability
        # (mirror pods bypass it, daemonset pods do not)
        core = self._candidate_core(node, pdb, catalog_fp)
        pods = []
        for pod, is_daemon in core.pod_info:
            # terminal-state, annotation and PDB-budget reads stay
            # LIVE per scan (the budget depends on OTHER nodes' pod
            # health; the allowance memo on `pdb` bounds its cost to
            # once per PDB per scan) — the store lookups and label
            # merges are what the core retains
            if pod.is_terminal() or pod.is_terminating():
                continue
            if (
                pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION)
                == "true"
                and not eventual
            ):
                explain.note_candidate(
                    node.name, explain.KEPT_DO_NOT_DISRUPT, pod=pod.key
                )
                return None
            if pdb.can_evict(pod) is not None and not eventual:
                explain.note_candidate(
                    node.name, explain.KEPT_PDB_BLOCKED, pod=pod.key
                )
                return None
            if is_daemon:
                continue
            pods.append(pod)
        labels = core.labels
        if catalog_fp is not None and core.price_fp == catalog_fp:
            price = core.price
        else:
            price = self._node_price(labels)
            if catalog_fp is not None:
                core.price_fp = catalog_fp
                core.price = price
        if price is None:
            if reason == REASON_UNDERUTILIZED:
                # unpriceable candidates are excluded from consolidation
                # rather than priced at 0, which would poison the
                # cheaper-than comparison (getCandidatePrices errors
                # skip the candidate)
                log.warning(
                    "no offering price for node %s; skipping candidate",
                    node.name,
                )
                explain.note_candidate(node.name, explain.KEPT_UNPRICED)
                return None
            # emptiness/drift never price-compare: a candidate with a
            # missing/unresolvable instance type is still disruptable
            # (types.go:107-108 resolves the type best-effort)
            price = 0.0
        lifetime_factor = 1.0
        from karpenter_tpu_torch.utils.duration import parse_duration

        lifetime = parse_duration(claim.spec.expire_after)
        if lifetime:
            remaining = max(0.0, 1.0 - (now - claim.metadata.creation_timestamp) / lifetime)
            lifetime_factor = remaining
        return Candidate(
            state_node=node,
            node_pool=pool,
            reschedulable_pods=pods,
            instance_type_name=labels.get(INSTANCE_TYPE_LABEL, ""),
            capacity_type=labels.get(CAPACITY_TYPE_LABEL, ""),
            zone=labels.get(TOPOLOGY_ZONE_LABEL, ""),
            price=price,
            disruption_cost=sum(pod_disruption_cost(p) for p in pods) * lifetime_factor,
        )

    def offering_price_index(
        self, pool_name: str, available_only: bool = False
    ) -> dict[tuple[str, str, str], float]:
        """(instance-type, zone, capacity-type) -> price for one pool's
        current catalog. Shared by candidate pricing and execution-time
        validation; fetch errors raise so callers decide whether the
        failure is skippable (candidate pricing) or retryable
        (validation)."""
        prices: dict[tuple[str, str, str], float] = {}
        pool = self.kube.get_node_pool(pool_name)
        if pool is None:
            return prices
        for it in self.cloud.get_instance_types(pool):
            for off in it.offerings:
                if available_only and not off.available:
                    continue
                prices[(it.name, off.zone, off.capacity_type)] = off.price
        return prices

    def _node_price(self, labels: dict[str, str]) -> Optional[float]:
        it_name = labels.get(INSTANCE_TYPE_LABEL, "")
        zone = labels.get(TOPOLOGY_ZONE_LABEL, "")
        captype = labels.get(CAPACITY_TYPE_LABEL, "")
        pool_name = labels.get(NODEPOOL_LABEL, "")
        index = self._price_index
        if pool_name not in index:
            try:
                index[pool_name] = self.offering_price_index(pool_name)
            except Exception as err:
                log.warning("price catalog fetch failed for pool %s: %s",
                            pool_name, err)
                index[pool_name] = {}
        return index[pool_name].get((it_name, zone, captype))

    # -- budgets (helpers.go:231-280) ------------------------------------------

    def budget_mapping(self, reason: str, now: float,
                       exclude_names: frozenset = frozenset()) -> dict[str, int]:
        """helpers.go BuildDisruptionBudgetMapping: the TOTAL counts
        only managed + initialized nodes whose claims are not
        InstanceTerminating (uninitialized replacements padding the
        percentage denominator would allow extra disruption of active
        nodes); NotReady and marked/deleting nodes then CONSUME
        allowance, floored at zero. `exclude_names` are nodes whose
        disruption is the QUESTION being asked (an in-flight command's
        own candidates at validation time): they count in the total
        but never as consumers, so a command can't collide with its
        own marks."""
        from karpenter_tpu_torch.apis.v1.nodeclaim import COND_INSTANCE_TERMINATING

        num: dict[str, int] = {}
        disrupting: dict[str, int] = {}
        for n in self.cluster.nodes():
            if not n.managed() or not n.initialized():
                continue
            claim = n.node_claim
            if claim is not None and claim.status_conditions.is_true(
                COND_INSTANCE_TERMINATING
            ):
                continue
            pool_name = n.nodepool_name()
            if not pool_name:
                continue
            num[pool_name] = num.get(pool_name, 0) + 1
            if n.name in exclude_names:
                continue
            not_ready = n.node is not None and not n.node.is_ready()
            if not_ready or n.deleting():
                disrupting[pool_name] = disrupting.get(pool_name, 0) + 1
        out = {}
        for pool in self.kube.node_pools():
            name = pool.metadata.name
            allowed = pool.must_get_allowed_disruptions(
                now, num.get(name, 0), reason
            )
            out[name] = max(0, allowed - disrupting.get(name, 0))
        return out

    def _budget_filter(
        self, candidates: list[Candidate], budgets: dict[str, int]
    ) -> list[Candidate]:
        taken: dict[str, int] = {}
        out = []
        for c in candidates:
            pool = c.node_pool.metadata.name
            if taken.get(pool, 0) < budgets.get(pool, 0):
                taken[pool] = taken.get(pool, 0) + 1
                out.append(c)
            else:
                explain.note_candidate(
                    c.state_node.name, explain.KEPT_BUDGET,
                    weak=True, pool=pool, allowed=budgets.get(pool, 0),
                )
        return out

    # -- simulation (helpers.go:52-143) ----------------------------------------

    def simulate_scheduling(
        self, candidates: Sequence[Candidate], objective: str = "ffd",
        include_pending: bool = True,
    ) -> tuple[SchedulerResults, bool]:
        """Re-run the scheduler with candidates removed. Returns
        (results, all_pods_scheduled). `include_pending=False` solves
        the candidates' pods alone — execution-time validation uses it
        so an unrelated pending pod forcing a new node can't be
        mistaken for the command going stale.

        The snapshot-once/probe-many path: while a search method has a
        primed probe cache active (multi-node's prefix ladder, the
        single-node rotation, drift's ranked scan — all evaluated as
        lanes of ONE batched device solve against ONE shared
        `deep_copy_nodes()` snapshot), a probe for a cached candidate
        subset is a dict lookup; only cache misses (lanes the batch
        could not reproduce exactly) pay the per-probe deep copy +
        Scheduler below."""
        cache = self._get_probe_cache()
        if cache is not None and objective == "ffd" and include_pending:
            thunk = cache.get(frozenset(c.state_node.name for c in candidates))
            # capacity that started materializing AFTER the batch's
            # snapshot must abort a cached probe exactly as the
            # sequential path's per-probe guard would — the check is a
            # cheap live-state scan, so cached verdicts keep the same
            # uninitialized-node semantics as fresh ones
            if thunk is not None and not self.has_uninitialized_capacity():
                # lazily decoded: the batch shipped every lane in one
                # device fetch, but per-lane decode runs only for the
                # subsets the search actually consults. A lane that
                # decodes to None needed sequential-only machinery —
                # fall through to the per-probe path below.
                hit = thunk()
                if hit is not None:
                    return hit
        deleting_names = {c.state_node.name for c in candidates}
        # the retained seam serves the snapshot rows + input cache; the
        # Scheduler below commits displaced pods onto the served rows,
        # so the touched keys are reported back (note_mutated) and
        # re-copied before the next serve
        rows, input_cache = self.fleet_seam.fleet_snapshot()
        snapshot = []
        for node in rows:
            if node.name in deleting_names:
                continue
            # uninitialized-node guard (helpers.go:122-141): abort while
            # other capacity is still materializing — its eventual pod
            # load is unknown, so a consolidation decision against it
            # would be built on sand
            if node.managed() and not node.initialized() and not node.deleting():
                return (
                    SchedulerResults(new_node_plans=[], existing_assignments={}),
                    False,
                )
            snapshot.append(node)
        results, all_ok = self._simulate_on_snapshot(
            candidates, snapshot, objective, include_pending,
            existing_input_cache=input_cache,
        )
        self.fleet_seam.note_mutated(results.existing_assignments.keys())
        return results, all_ok

    def has_uninitialized_capacity(
        self, exclude_names: Optional[set] = None
    ) -> bool:
        """True while any managed node outside `exclude_names` is still
        materializing — the condition under which the uninitialized-node
        guard aborts a simulation. Execution-time validation checks it
        FIRST so the transient abort maps to retry, not rollback."""
        exclude = exclude_names or set()
        return any(
            node.managed() and not node.initialized() and not node.deleting()
            for node in self.cluster.nodes()
            if node.name not in exclude
        )

    def _simulate_on_snapshot(
        self, candidates: Sequence[Candidate], snapshot: list,
        objective: str, include_pending: bool,
        existing_input_cache: Optional[dict] = None,
    ) -> tuple[SchedulerResults, bool]:
        pods = [p for c in candidates for p in c.reschedulable_pods]
        pending = self.provisioner.get_pending_pods() if include_pending else []
        scheduler = Scheduler(
            existing_input_cache=existing_input_cache,
            pools_with_types=self.provisioner.ready_pools_with_types(),
            state_nodes=snapshot,
            daemonsets=self.cluster.daemonsets(),
            cluster_pods=self.kube.pods(),
            allow_reserved=self.options.feature_gates.reserved_capacity,
            min_values_policy=self.options.min_values_policy,
            ignore_dra_requests=self.options.ignore_dra_requests,
            metrics_controller="disruption",
            kube=self.kube,
            clock=self.clock,
            objective=objective,
            # share the provisioner's encoder cache: simulation rounds
            # re-encode the same pod shapes against the same catalog,
            # so only genuinely new signatures pay compat evaluation
            compat_cache=self.provisioner.encode_cache,
            device=self.device,
        )
        results = scheduler.solve(pods + pending)
        scheduled_keys = {
            p.key for plan in results.new_node_plans for p in plan.pods
        } | {p.key for ps in results.existing_assignments.values() for p in ps}
        all_ok = all(p.key in scheduled_keys for p in pods)
        if all_ok and pods and pending:
            # priority-aware disruption: a command must not
            # retire capacity while a PENDING pod of strictly higher
            # priority than the pods it would displace is left
            # capacity-unschedulable by the very same simulation —
            # whether by catalog capacity (the solve's own error) or by
            # NodePool limits (enforced at claim creation; simulated
            # here the way the provisioner's admission loop does). The
            # cluster would be churning low-priority workload for
            # price while outranking demand starves. Uniform-priority
            # clusters (everything 0) are unaffected: 0 > 0 never
            # holds, and a pending pod at the candidates' own priority
            # was unschedulable with the candidates present too.
            from karpenter_tpu_torch.provisioning.priority import (
                NO_CAPACITY_ERROR,
            )

            floor = min(p.spec.priority for p in pods)
            pending_by_key = {p.key: p for p in pending}
            starved_keys = {
                key for key, error in results.errors.items()
                if error == NO_CAPACITY_ERROR
            }
            for plan in self.provisioner._plans_over_limits(
                results.new_node_plans
            ):
                starved_keys.update(p.key for p in plan.pods)
            for key in sorted(starved_keys):
                starved = pending_by_key.get(key)
                if starved is not None and starved.spec.priority > floor:
                    log.info(
                        "disruption simulation vetoed: pending pod %s "
                        "(priority %d) would stay unschedulable while "
                        "pods of priority %d are displaced",
                        key, starved.spec.priority, floor,
                    )
                    for c in candidates:
                        explain.note_candidate(
                            c.state_node.name, explain.KEPT_PRIORITY_VETO,
                            starved_pod=key,
                            starved_priority=int(starved.spec.priority),
                            displaced_priority=int(floor),
                        )
                    all_ok = False
                    break
        return results, all_ok

    # -- consolidation decision (consolidation.go:137-311) ---------------------

    def compute_consolidation(
        self, candidates: list[Candidate]
    ) -> Optional[Command]:
        # dual-based probe pruning: while a search ladder
        # has a primed dual certificate, a candidate set whose pods'
        # certified dual value exceeds its price — even after every
        # other node's free capacity and the reservation budget absorb
        # their share — cannot be replaced strictly cheaper, so the
        # probe could only return None. Skipping it is
        # decision-identical (weak duality, conservative margin) and
        # saves the simulation outright.
        pruner = self._get_probe_pruner()
        if pruner is not None and self.probe_pruning_enabled():
            try:
                pruned = pruner.cannot_pay(candidates)
            except Exception as err:
                if not self.may_degrade(err):
                    raise
                log.exception("probe pruning failed; probing")
                pruned = False
            if pruned:
                from karpenter_tpu_torch import tracing
                from karpenter_tpu_torch.metrics.store import SOLVER_PROBE_PRUNED

                SOLVER_PROBE_PRUNED.inc()
                tracing.add_event(
                    "probe_pruned", candidates=len(candidates)
                )
                # the certificate IS the explanation — "kept because
                # no replacement can beat $X/hr", with the weak-
                # duality numbers attached (λ'·d bound vs price)
                cert = getattr(pruner, "last", None) or {}
                for c in candidates:
                    explain.note_candidate(
                        c.state_node.name, explain.KEPT_LP_PRUNE, **cert
                    )
                return None
        results, all_ok = self.simulate_scheduling(candidates)
        if not all_ok:
            for c in candidates:
                explain.note_candidate(
                    c.state_node.name, explain.KEPT_SIMULATION, weak=True
                )
            return None
        if len(results.new_node_plans) > 1:
            for c in candidates:
                explain.note_candidate(
                    c.state_node.name, explain.KEPT_NEEDS_MULTIPLE,
                    weak=True, replacement_nodes=len(results.new_node_plans),
                )
            return None
        current_price = sum(c.price for c in candidates)
        if not results.new_node_plans:
            return Command(reason=REASON_EMPTY if not any(
                c.reschedulable_pods for c in candidates
            ) else REASON_UNDERUTILIZED, candidates=candidates, results=results)
        plan = results.new_node_plans[0]
        # replacement must be strictly cheaper: filter offerings by
        # price — spot offerings judged at their interruption-penalized
        # effective price (cloudprovider.types.effective_price), so
        # consolidation stops churning workloads onto capacity the
        # interruption regime is about to reclaim
        cheaper = [o for o in plan.offerings if effective_price(o) < current_price]
        if not cheaper:
            cheapest = (
                min(effective_price(o) for o in plan.offerings)
                if plan.offerings else None
            )
            for c in candidates:
                explain.note_candidate(
                    c.state_node.name, explain.KEPT_NOT_CHEAPER,
                    current_price=round(current_price, 6),
                    replacement_price=(
                        round(cheapest, 6) if cheapest is not None else None
                    ),
                )
            return None
        all_spot = all(c.capacity_type == CAPACITY_TYPE_SPOT for c in candidates)
        # the launch resolves to the cheapest surviving offering (raw
        # price — what the provider actually picks), so THAT offering's
        # capacity type is the replacement's: a ~free reserved offering
        # beating the spot candidates must route through the normal
        # path, not the spot-to-spot gate
        replacement_ct = min(cheaper, key=lambda o: o.price).capacity_type
        spot_replacement = replacement_ct == CAPACITY_TYPE_SPOT
        if all_spot and spot_replacement:
            # spot-to-spot (consolidation.go:233-311): gated; replacement
            # forced to spot; single-node additionally demands >=15
            # cheaper instance types and truncates the launch set to 15
            if not self.options.feature_gates.spot_to_spot_consolidation:
                self._note_spot_gated(candidates, "feature-gate-off")
                return None
            spot_offerings = [
                o for o in cheaper if o.capacity_type == CAPACITY_TYPE_SPOT
            ]
            type_names = []
            for o in spot_offerings:
                for it in plan.instance_types:
                    if o in it.offerings and it.name not in type_names:
                        type_names.append(it.name)
            if not type_names:
                self._note_spot_gated(candidates, "no-cheaper-spot-types")
                return None
            if len(candidates) == 1:
                if len(type_names) < SPOT_TO_SPOT_MIN_TYPES:
                    self._note_spot_gated(
                        candidates,
                        f"{len(type_names)}<{SPOT_TO_SPOT_MIN_TYPES}"
                        " flexible types",
                    )
                    return None
                type_names = type_names[:SPOT_TO_SPOT_MIN_TYPES]
            keep = set(type_names)
            plan.instance_types = [it for it in plan.instance_types if it.name in keep]
            plan.offerings = [
                o for o in spot_offerings
                if any(o in it.offerings for it in plan.instance_types)
            ]
        else:
            # the cheaper-than filter assumed the cheapest variant
            # launches, so when several capacity types remain and one
            # of them is spot, pin the replacement to the capacity type
            # the launch resolves to (consolidation.go:215-223 pins
            # OD -> [OD, spot] to spot; a cheaper reserved offering
            # pins to reserved the same way)
            captypes = {o.capacity_type for o in cheaper}
            if CAPACITY_TYPE_SPOT in captypes and len(captypes) > 1:
                cheaper = [
                    o for o in cheaper if o.capacity_type == replacement_ct
                ]
            plan.offerings = cheaper
            names = set()
            for o in cheaper:
                for it in plan.instance_types:
                    if o in it.offerings:
                        names.add(it.name)
            plan.instance_types = [it for it in plan.instance_types if it.name in names]
        if not plan.instance_types:
            for c in candidates:
                explain.note_candidate(
                    c.state_node.name, explain.KEPT_NOT_CHEAPER, weak=True
                )
            return None
        plan.price = min(o.price for o in plan.offerings)
        return Command(reason=REASON_UNDERUTILIZED, candidates=candidates, results=results)

    @staticmethod
    def _note_spot_gated(candidates: list[Candidate], why: str) -> None:
        for c in candidates:
            explain.note_candidate(
                c.state_node.name, explain.KEPT_SPOT_GATED, gate=why
            )

    # -- methods ---------------------------------------------------------------

    def emptiness(self, now: float) -> Optional[Command]:
        """Delete empty consolidatable nodes (emptiness.go:42-113)."""
        candidates = [
            c for c in self.get_candidates(REASON_EMPTY, now) if not c.reschedulable_pods
        ]
        if not candidates:
            return None
        budgets = self.budget_mapping(REASON_EMPTY, now)
        allowed = self._budget_filter(candidates, budgets)
        if not allowed:
            return None
        return Command(reason=REASON_EMPTY, candidates=allowed)

    def drift(self, now: float) -> Optional[Command]:
        """Replace drifted nodes (drift.go:55-115); one at a time. The
        ranked candidates are simulated as lanes of one batched probe
        solve; the scan below consults the primed verdicts in order."""
        candidates = self.get_candidates(REASON_DRIFTED, now)
        if not candidates:
            return None
        budgets = self.budget_mapping(REASON_DRIFTED, now)
        allowed = self._budget_filter(candidates, budgets)
        # empty drifted nodes first (no disruption at all)
        allowed.sort(key=lambda c: (len(c.reschedulable_pods), -c.disruption_cost))
        primer = self._probe_primer([[c] for c in allowed])
        self._set_probe_cache({})
        try:
            for candidate in allowed:
                primer.ensure([candidate])
                results, ok = self.simulate_scheduling([candidate])
                if ok:
                    return Command(reason=REASON_DRIFTED, candidates=[candidate],
                                   results=results)
            return None
        finally:
            self._set_probe_cache(None)
            self._set_probe_pruner(None)

    def global_repack_consolidation(self, now: float) -> Optional[Command]:
        """One cost-objective re-solve of the whole candidate set — the
        batched-device generalization of the reference's prefix binary
        search (multinodeconsolidation.go:116-169). Where the prefix
        search can only merge a disruption-cost-ordered prefix into a
        SINGLE replacement node, this method hands every budget-allowed
        candidate's workload to the LP cost objective at once and keeps
        the resulting multi-node plan when the replacement fleet is
        strictly cheaper than the candidates it retires. The command is
        re-validated against fresh state before execution like every
        other (validation.go:152-280)."""
        candidates = self.get_candidates(REASON_UNDERUTILIZED, now)
        if len(candidates) < 2:
            return None
        candidates.sort(key=lambda c: c.disruption_cost)
        budgets = self.budget_mapping(REASON_UNDERUTILIZED, now)
        candidates = self._budget_filter(candidates, budgets)
        candidates = candidates[:GLOBAL_REPACK_MAX_CANDIDATES]
        if len(candidates) < 2:
            return None
        results, all_ok = self.simulate_scheduling(candidates, objective="cost")
        if not all_ok:
            return None
        current_price = sum(c.price for c in candidates)
        all_spot = all(
            c.capacity_type == CAPACITY_TYPE_SPOT for c in candidates
        )
        for plan in results.new_node_plans:
            captypes = {o.capacity_type for o in plan.offerings}
            if CAPACITY_TYPE_SPOT in captypes:
                # the launch resolves to the cheapest surviving offering
                # (raw price — what the provider actually picks), so
                # THAT capacity type is the replacement's: a ~free
                # reserved offering beating the spot candidates routes
                # through the normal path, exactly as in the
                # single-node path above
                replacement_ct = min(
                    plan.offerings, key=lambda o: o.price
                ).capacity_type
                # spot-to-spot churn is gated (consolidation.go:233-311);
                # the >=2-candidate set is exempt from the 15-type floor
                # exactly as the reference's multi-node path is
                if (
                    all_spot
                    and replacement_ct == CAPACITY_TYPE_SPOT
                    and not self.options.feature_gates.spot_to_spot_consolidation
                ):
                    return None
                if len(captypes) > 1:
                    # the price estimate assumes the cheapest offering
                    # launches, so pin the plan to its capacity type
                    # (consolidation.go:215-223)
                    plan.offerings = [
                        o for o in plan.offerings
                        if o.capacity_type == replacement_ct
                    ]
                    names = {
                        it.name for it in plan.instance_types
                        if any(o in it.offerings for o in plan.offerings)
                    }
                    plan.instance_types = [
                        it for it in plan.instance_types if it.name in names
                    ]
                    if not plan.instance_types:
                        return None
            plan.price = min(o.price for o in plan.offerings)
        # decide on interruption-penalized prices (spot offerings carry
        # their expected reclaim cost) while plan.price stays the raw
        # launch price
        new_price = sum(
            min(effective_price(o) for o in p.offerings)
            for p in results.new_node_plans
        )
        if new_price >= current_price:
            return None
        # Price-prune each plan's fallback offerings the way
        # compute_consolidation prunes its single replacement's
        # (consolidation.go:190-214): a launch can land on any offering
        # the claim keeps, so distribute the saving slack across plans
        # and cap every plan's offerings below its share — then even if
        # EVERY plan falls back to its most expensive surviving
        # offering, the total stays strictly under the retired price.
        plans = results.new_node_plans
        if plans:
            share = (current_price - new_price) / len(plans)
            for plan in plans:
                # cap in the same effective-price domain the decision
                # used, so spot fallbacks keep their reclaim penalty
                cap = min(effective_price(o) for o in plan.offerings) + share
                plan.offerings = [
                    o for o in plan.offerings if effective_price(o) < cap
                ]
                names = {
                    it.name for it in plan.instance_types
                    if any(o in it.offerings for o in plan.offerings)
                }
                plan.instance_types = [
                    it for it in plan.instance_types if it.name in names
                ]
                if not plan.instance_types:
                    return None
        return Command(
            reason=REASON_UNDERUTILIZED, candidates=candidates, results=results
        )

    def multi_node_consolidation(self, now: float) -> Optional[Command]:
        """Binary search the largest prefix replaceable by <=1 node
        (multinodeconsolidation.go:51-225). The WHOLE prefix ladder is
        submitted up front as lanes of one batched device solve (one
        shared snapshot, one encode); the search below then consults
        the primed verdicts, so its control flow — full-prefix probe,
        binary search, non-monotone sweep, wall-clock bound — is
        unchanged while each probe costs a dict lookup instead of a
        snapshot + Scheduler + solve."""
        candidates = self.get_candidates(REASON_UNDERUTILIZED, now)
        candidates.sort(key=lambda c: c.disruption_cost)
        budgets = self.budget_mapping(REASON_UNDERUTILIZED, now)
        candidates = self._budget_filter(candidates, budgets)
        candidates = candidates[:MULTI_NODE_MAX_CANDIDATES]
        if len(candidates) < 2:
            return None
        # minimum prefix is 2: single-node consolidation handles the rest
        # (multinodeconsolidation.go:118-121)
        deadline = self.clock() + MULTI_NODE_TIMEOUT_SECONDS
        primer = self._probe_primer(
            [candidates[:n] for n in range(2, len(candidates) + 1)]
        )
        self._set_probe_cache({})
        try:
            primer.prime_all()
            best = self._multi_node_search(candidates, deadline)
        finally:
            self._set_probe_cache(None)
            self._set_probe_pruner(None)
        if best is not None and len(best.candidates) >= 2:
            if not self._same_type_guard(best):
                # N same-type nodes would churn into one node of their
                # own type with no launchable alternative — anti-churn
                names = {c.instance_type_name for c in best.candidates}
                for c in best.candidates:
                    explain.note_candidate(
                        c.state_node.name, explain.KEPT_SAME_TYPE,
                        instance_type=sorted(names)[0] if names else "",
                    )
                return None
            return best
        return None

    def _multi_node_search(self, candidates: list[Candidate],
                           deadline: float) -> Optional[Command]:
        # The valid-prefix set is NOT monotone: replacing 2 small nodes
        # can cost more than their price while replacing all 3 is
        # cheaper (the shared replacement amortizes). The reference's
        # binary search assumes monotonicity and misses such merges;
        # probe the FULL prefix first (the largest possible saving),
        # fall back to the reference-style binary search, and finish
        # with a descending sweep over prefixes neither covered — all
        # under the method's wall-clock bound.
        best = self.compute_consolidation(candidates)
        if best is not None:
            return best
        lo, hi = 2, len(candidates) - 1
        probed = set()
        timed_out = False
        while lo <= hi:
            if self.clock() > deadline:
                log.warning("multi-node consolidation timed out; "
                            "keeping best command so far")
                self._starved("multi_node_consolidation", len(probed) + 1,
                              hi - lo + 1)
                timed_out = True
                break
            mid = (lo + hi) // 2
            probed.add(mid)
            cmd = self.compute_consolidation(candidates[:mid])
            if cmd is not None:
                best = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        # descending sweep over every prefix LARGER than what the
        # binary search settled on: under non-monotonicity a bigger
        # (more saving) merge can hide above a failing midpoint
        best_n = len(best.candidates) if best is not None else 1
        if not timed_out:
            sweeps = 0
            for n in range(len(candidates) - 1, best_n, -1):
                if n in probed:
                    continue
                if sweeps >= MULTI_NODE_SWEEP_PROBES:
                    break
                if self.clock() > deadline:
                    log.warning("multi-node consolidation timed out "
                                "during prefix sweep; keeping best")
                    self._starved("multi_node_consolidation",
                                  len(probed) + 1 + sweeps,
                                  MULTI_NODE_SWEEP_PROBES - sweeps)
                    break
                sweeps += 1
                cmd = self.compute_consolidation(candidates[:n])
                if cmd is not None:
                    best = cmd
                    break
        return best

    def _same_type_guard(self, best: Command) -> bool:
        """Same-instance-type anti-churn (multinodeconsolidation.go:
        171-225): N nodes of one type must never churn into one node
        of that same type without savings. Judged over the FULL
        surviving option set, not just the first type: a plan whose
        first type differs but whose only launchable offerings belong
        to the candidates' own type would otherwise slip through.
        Mirroring the reference's filterOutSameOrInvalidType, the
        candidates' type is filtered OUT of the replacement options;
        the command survives only if a genuinely different type can
        still launch. Returns False to drop the command."""
        if not best.results or not best.results.new_node_plans:
            return True
        plan = best.results.new_node_plans[0]
        names = {c.instance_type_name for c in best.candidates}
        if len(names) != 1 or not plan.instance_types:
            return True
        keep = [it for it in plan.instance_types if it.name not in names]
        offerings = [
            o for o in plan.offerings
            if any(o in it.offerings for it in keep)
        ]
        if not keep or not offerings:
            return False
        plan.instance_types = keep
        plan.offerings = offerings
        plan.price = min(o.price for o in offerings)
        return True

    def _starved(self, method: str, attempted: int, remaining: int) -> None:
        DISRUPTION_PROBE_STARVATION.inc(
            {"method": method, "count": "attempted"}, value=float(attempted)
        )
        DISRUPTION_PROBE_STARVATION.inc(
            {"method": method, "count": "remaining"}, value=float(remaining)
        )

    def single_node_consolidation(self, now: float) -> Optional[Command]:
        """Try candidates one at a time, round-robining nodepools
        (singlenodeconsolidation.go:56-160). The rotation's visitation
        order is replayed up front so a full budget-allowed round of
        probes can be primed as lanes of one batched solve; the loop
        below then consults the primed verdicts in the same order."""
        candidates = self.get_candidates(REASON_UNDERUTILIZED, now)
        by_pool: dict[str, list[Candidate]] = {}
        for c in candidates:
            by_pool.setdefault(c.node_pool.metadata.name, []).append(c)
        budgets = self.budget_mapping(REASON_UNDERUTILIZED, now)
        for pool_candidates in by_pool.values():
            self._rng.shuffle(pool_candidates)
        # zero-budget pools can never be probed this call (budgets are
        # fixed for the round), so drop them from the rotation up front
        # instead of burning rotation turns popping candidates only to
        # skip them; with no budgeted pool at all, return immediately
        pools = sorted(p for p in by_pool if budgets.get(p, 0) > 0)
        if not pools:
            return None
        idx = 0
        remaining = {p: list(by_pool[p]) for p in pools}
        # materialize the rotation's pop order (a pure replay of the
        # loop below) so the primer batches probes in visitation order
        order: list[Candidate] = []
        sim = {p: list(remaining[p]) for p in pools}
        j = 0
        while any(sim.values()):
            pool = pools[j % len(pools)]
            j += 1
            if sim[pool]:
                order.append(sim[pool].pop())
        primer = self._probe_primer([[c] for c in order])
        self._set_probe_cache({})
        attempted = 0
        deadline = self.clock() + SINGLE_NODE_TIMEOUT_SECONDS
        try:
            while any(remaining.values()):
                if self.clock() > deadline:
                    left = sum(len(v) for v in remaining.values())
                    log.warning("single-node consolidation timed out after "
                                "%d candidates (%d unprobed)", idx, left)
                    # budget-starvation visibility: how far the scan got
                    # vs how much it silently dropped
                    self._starved("single_node_consolidation", attempted,
                                  left)
                    return None
                pool = pools[idx % len(pools)]
                idx += 1
                if not remaining[pool]:
                    continue
                candidate = remaining[pool].pop()
                primer.ensure([candidate])
                attempted += 1
                cmd = self.compute_consolidation([candidate])
                if cmd is not None:
                    return cmd
            return None
        finally:
            self._set_probe_cache(None)
            self._set_probe_pruner(None)

    # -- controller loop (controller.go:121-176) -------------------------------

    def reconcile(self, now: Optional[float] = None) -> Optional[Command]:
        from karpenter_tpu_torch import tracing

        now = time.time() if now is None else now
        if not self.cluster.synced():
            return None
        self._untaint_leftovers()
        for method in (
            self.emptiness,
            self.drift,
            self.global_repack_consolidation,
            self.multi_node_consolidation,
            self.single_node_consolidation,
        ):
            t0 = time.perf_counter()
            with tracing.span(f"disruption.{method.__name__}") as sp:
                command = method(now)
                sp.annotate(decided=command is not None)
            DISRUPTION_EVALUATION_DURATION.observe(
                time.perf_counter() - t0,
                {"method": method.__name__},
            )
            if command is not None:
                # the decided command's candidates get the terminal
                # verdict — overwriting any kept:<reason> an earlier
                # probe of the same ladder recorded for them
                for c in command.candidates:
                    explain.note_candidate(
                        c.state_node.name, explain.VERDICT_CONSOLIDATED,
                        reason=command.reason,
                        replacements=command.replacement_count,
                    )
                # crash window: the disruption decision exists only in
                # memory — a restart recomputes it from cluster state
                from karpenter_tpu_torch.solver import faults as _faults

                _faults.fire("crash_disruption")
                self.queue.start_command(command, now)
                return command
        return None


    def _untaint_leftovers(self) -> None:
        """Un-taint nodes left disrupted by a previous action that is
        no longer in flight — a crashed operator or a rolled-back
        command must not leave capacity unschedulable forever
        (controller.go:136-157)."""
        in_flight = {
            c.state_node.name
            for cmd in self.queue.active
            for c in cmd.candidates
        }
        for node in self.cluster.nodes():
            if node.name in in_flight or node.node is None:
                continue
            # only API-level deletion exempts a node; marked_for_deletion
            # alone is exactly the stale state this pass must recover (a
            # command that died before reaching the queue leaves the mark
            # AND the taint — skipping on it would wedge the node forever)
            if any(
                obj is not None and obj.metadata.deletion_timestamp is not None
                for obj in (node.node, node.node_claim)
            ):
                continue
            if any(
                t.key == DISRUPTED_NO_SCHEDULE_TAINT.key
                for t in node.node.spec.taints
            ):
                node.node.spec.taints = [
                    t for t in node.node.spec.taints
                    if t.key != DISRUPTED_NO_SCHEDULE_TAINT.key
                ]
                self.kube.update(node.node)
                if node.node_claim is not None:
                    node.node_claim.status_conditions.clear(
                        COND_DISRUPTION_REASON
                    )
                node.marked_for_deletion = False


class _ProbePrimer:
    """Feeds a search method's candidate subsets to the batched probe
    solver, filling the engine's probe cache with lazy verdicts. The
    whole spec list primes in ONE call — priming only stages the
    shared problem (one snapshot, one encode); device dispatch and
    decode happen lane by lane as the search consults its probes, so
    offering every subset up front costs nothing extra. Lanes the
    batch cannot reproduce exactly are simply left out of the cache
    (or decode to None later), and the caller's unchanged
    `compute_consolidation` / `simulate_scheduling` probe runs
    sequentially for exactly those.

    The BatchProbeSolver (and its deep-copied snapshot) is acquired
    lazily on the first ensure/prime_all — a search that never probes
    (no candidates, early return) never pays for it.
    """

    def __init__(self, engine: DisruptionEngine, lane_specs: list):
        self.engine = engine
        self.specs = list(lane_specs)
        self.primed = False
        self.dead = not self.specs or not engine.batch_probes_enabled()

    @staticmethod
    def _key(spec) -> frozenset:
        return frozenset(c.state_node.name for c in spec)

    def prime_all(self) -> None:
        if self.dead or self.primed:
            return
        self.primed = True
        solver = self.engine._probe_solver()
        if solver is None:
            self.dead = True
            return
        verdicts = solver.prime(self.specs)
        if verdicts is None:
            # the whole batch is outside the fast path (topology /
            # host-ports / volume limits): probe sequentially
            self.dead = True
            return
        # the staged union problem doubles as the dual-certificate
        # pruner's input; the search's finally clears it with the cache
        self.engine._set_probe_pruner(solver.pruner())
        cache = self.engine._get_probe_cache()
        if cache is None:
            return
        for spec, verdict in zip(self.specs, verdicts):
            if verdict is not None:
                cache[self._key(spec)] = verdict

    def ensure(self, spec) -> None:
        """Make sure `spec`'s lane has been offered to the batch before
        the caller probes it."""
        self.prime_all()


class OrchestrationQueue:
    """Executes commands: taint + mark + replace, then delete once
    replacements initialize (disruption/queue.go:94-370)."""

    def __init__(self, kube: KubeClient, cluster: Cluster, provisioner: Provisioner,
                 recorder=None):
        self.kube = kube
        self.cluster = cluster
        self.provisioner = provisioner
        self.recorder = recorder
        self.active: list[Command] = []
        self.validator = None  # set by DisruptionEngine

    def protected_claim_names(self) -> set[str]:
        """Replacement claims of in-flight commands: OFF LIMITS to the
        candidate scan. Without this, emptiness eats a replace
        command's still-empty replacement the moment its
        consolidatable TTL elapses, the command sees its replacement
        dying and rolls back, and the taint/launch/reap cycle livelocks
        forever (the reference nominates replacement nodes for the
        candidates' pods — disruption.go launchReplacementNodeClaims —
        which keeps them out of the candidate set the same way)."""
        return {
            plan.claim_name
            for command in self.active
            if command.results is not None
            for plan in command.results.new_node_plans
            if plan.claim_name
        }

    def _nominate_replacements(self, command: Command,
                               now: Optional[float] = None) -> None:
        """Refresh the nomination window on every replacement's state
        node while the command is in flight: the candidates' pods are
        already spoken for onto this capacity."""
        if command.results is None:
            return
        for plan in command.results.new_node_plans:
            if not plan.claim_name:
                continue
            state = self.cluster.node_for_key(plan.claim_name)
            if state is None:
                claim = self.kube.get_node_claim(plan.claim_name)
                if claim is not None and claim.status.node_name:
                    state = self.cluster.node_for_name(claim.status.node_name)
            if state is not None:
                state.nominate(now=now)

    def _record(self, command: Command, now: float) -> None:
        """DisruptionTerminating on every candidate (disruption/
        events/events.go:56-63 posts to both the Node and the
        NodeClaim)."""
        if self.recorder is None:
            return
        from karpenter_tpu_torch.events.recorder import Event

        for candidate in command.candidates:
            node = candidate.state_node
            message = f"Disrupting Node: {command.reason}"
            if node.node is not None:
                self.recorder.publish(Event(
                    kind="Node", name=node.node.metadata.name,
                    type="Normal", reason="DisruptionTerminating",
                    message=message,
                ), now=now)
            if node.node_claim is not None:
                self.recorder.publish(Event(
                    kind="NodeClaim", name=node.node_claim.metadata.name,
                    type="Normal", reason="DisruptionTerminating",
                    message=message,
                ), now=now)

    def start_command(self, command: Command, now: Optional[float] = None) -> None:
        from karpenter_tpu_torch import tracing

        with tracing.span(
            "disruption.start", reason=command.reason,
            candidates=len(command.candidates),
        ):
            self._start_command(command, now)

    def _start_command(self, command: Command,
                       now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        command.started_at = now
        self._record(command, now)
        for candidate in command.candidates:
            node = candidate.state_node
            if node.node is not None and not any(
                t.key == DISRUPTED_NO_SCHEDULE_TAINT.key for t in node.node.spec.taints
            ):
                node.node.spec.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
                self.kube.update(node.node)
            if node.node_claim is not None:
                node.node_claim.status_conditions.set_true(
                    COND_DISRUPTION_REASON, reason=command.reason, now=now
                )
            node.marked_for_deletion = True
        if command.results is not None:
            self.provisioner.create_node_claims(command.results, now=now)
            # a plan that produced no claim (e.g. nodepool limits) means
            # replacement capacity will never come: roll back now
            if any(not p.claim_name for p in command.results.new_node_plans):
                log.warning("replacement creation failed; rolling back %s command",
                            command.reason)
                self._rollback(command, now=now)
                return
            self._nominate_replacements(command, now=now)
        self.active.append(command)

    def reconcile(self, now: Optional[float] = None) -> None:
        """waitOrTerminate (queue.go:137-246): once all replacement
        claims are Initialized, re-validate (validation.go:152-280 —
        pods/budgets may have churned since the command was computed)
        and delete the candidates. Commands whose replacements die,
        that fail validation, or that exceed the retry deadline roll
        back — candidates are un-tainted and unmarked."""
        now = time.time() if now is None else now
        still_active = []
        for command in self.active:
            # keep the replacements' nomination windows fresh while
            # the command waits (registration may outlive one window)
            self._nominate_replacements(command, now=now)
            state = self._replacements_state(command)
            if state == "ready":
                from karpenter_tpu_torch import tracing

                with tracing.span(
                    "disruption.validation", reason=command.reason,
                ) as vsp:
                    verdict = self._validate(command, now)
                    vsp.annotate(verdict=verdict)
                if verdict == "retry":
                    # transient failure (e.g. catalog fetch blip): keep
                    # the command active; the COMMAND_TIMEOUT deadline
                    # bounds how long it can retry before rolling back
                    if now - command.started_at > COMMAND_TIMEOUT_SECONDS:
                        log.warning(
                            "disruption command %s rolled back: validation "
                            "still failing transiently after retry deadline",
                            command.reason,
                        )
                        self._rollback(command, now=now)
                    else:
                        still_active.append(command)
                    continue
                if verdict == "invalid":
                    self._rollback(command, now=now)
                    continue
                with tracing.span(
                    "disruption.commit", reason=command.reason,
                    candidates=len(command.candidates),
                ):
                    for candidate in command.candidates:
                        claim = candidate.state_node.node_claim
                        if claim is not None and (
                            claim.metadata.deletion_timestamp is None
                        ):
                            self.kube.delete(claim, now=now)
                            NODECLAIMS_DISRUPTED.inc({
                                "reason": command.reason,
                                "nodepool":
                                    candidate.node_pool.metadata.name,
                            })
            elif state == "failed" or now - command.started_at > COMMAND_TIMEOUT_SECONDS:
                log.warning("disruption command %s rolled back (%s)", command.reason,
                            state)
                self._rollback(command, now=now)
            else:
                still_active.append(command)
        self.active = still_active

    def _validate(self, command: Command, now: float) -> str:
        """'ok' | 'invalid' | 'retry'."""
        if self.validator is None:
            return "ok"
        from karpenter_tpu_torch.disruption.validation import ValidationRetry

        try:
            self.validator.validate_for_execution(command, now)
            return "ok"
        except ValidationRetry as err:
            log.warning("disruption command %s validation deferred: %s",
                        command.reason, err)
            return "retry"
        except Exception as err:
            from karpenter_tpu_torch.disruption.validation import (
                ValidationError,
            )

            # on the card a validation that fails for another reason
            # than a verdict is raised, not read as a stale command
            if not isinstance(err, ValidationError) and (
                not self.validator.engine.may_degrade(err)
            ):
                raise
            log.warning("disruption command %s failed validation: %s",
                        command.reason, err)
            return "invalid"

    def _replacements_state(self, command: Command) -> str:
        """ready | waiting | failed."""
        if command.results is None:
            return "ready"
        for plan in command.results.new_node_plans:
            if not plan.claim_name:
                return "failed"
            claim = self.kube.get_node_claim(plan.claim_name)
            if claim is None or claim.metadata.deletion_timestamp is not None:
                # launch failed and the lifecycle controller deleted it
                return "failed"
            if not claim.status_conditions.is_true("Initialized"):
                return "waiting"
        return "ready"

    def _rollback(self, command: Command, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for candidate in command.candidates:
            node = candidate.state_node
            node.marked_for_deletion = False
            if node.node is not None:
                node.node.spec.taints = [
                    t for t in node.node.spec.taints
                    if t.key != DISRUPTED_NO_SCHEDULE_TAINT.key
                ]
                self.kube.update(node.node)
            if node.node_claim is not None:
                node.node_claim.status_conditions.clear(COND_DISRUPTION_REASON)
        # Replacements launched eagerly at start_command (the reference
        # launches only after validation, queue.go:287): on rollback,
        # retire the ones that never took load so a stale decision does
        # not leave paid-for empty capacity waiting for emptiness to
        # collect it. Replacements that host non-daemon pods OR have
        # pending pods nominated onto them are kept — deleting those
        # would disrupt (or strand) workloads.
        if command.results is None:
            return
        for plan in command.results.new_node_plans:
            if not plan.claim_name:
                continue
            claim = self.kube.get_node_claim(plan.claim_name)
            if claim is None or claim.metadata.deletion_timestamp is not None:
                continue
            state_node = self.cluster.node_for_key(plan.claim_name)
            if state_node is None and claim.status.node_name:
                state_node = self.cluster.node_for_name(claim.status.node_name)
            hosts_load = False
            if state_node is not None:
                # the QUEUE's own in-flight protection nominated this
                # replacement (see _nominate_replacements) — that must
                # not read as "pending pods want it" at rollback, so
                # withdraw it before judging real load. (A concurrent
                # provisioner nomination is withdrawn too; its pods
                # re-solve through the batcher when the claim retires.)
                state_node.nominated_until = 0.0
                for pod_key in state_node.pod_keys:
                    pod = self.kube.get_pod(*pod_key.split("/", 1))
                    if pod is None or pod.is_terminal() or pod.is_terminating():
                        continue
                    if pod.owner_kind() == "DaemonSet":
                        continue
                    hosts_load = True
                    break
            if not hosts_load:
                self.kube.delete(claim, now=now)
