"""Topology tracking: spread constraints, pod (anti-)affinity.

Copy of `karpenter_tpu/scheduling/topology.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/controllers/provisioning/scheduling/topology.go +
topologygroup.go: TopologyGroups own domain-count maps; placement asks
each matching group which domains remain legal, and registration
increments the chosen domain. Includes the inverse anti-affinity scan
(topology.go:280-327): existing pods' required anti-affinity terms
block incoming pods that match their selectors.

Domains per topology key are discovered from NodePool requirements,
live nodes and planned nodes (topology.go:105-146). Hostname domains
are synthesized per (planned) node.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Optional

from karpenter_tpu_torch.apis.v1.labels import HOSTNAME_LABEL
from karpenter_tpu_torch.kube.objects import (
    LabelSelector,
    Pod,
    PodAffinityTerm,
    TopologySpreadConstraint,
)

TYPE_SPREAD = "spread"
TYPE_AFFINITY = "affinity"
TYPE_ANTI_AFFINITY = "anti-affinity"


@dataclass
class TopologyGroup:
    """One constraint shared by all pods carrying it
    (topologygroup.go:56-128)."""

    type: str
    key: str                       # topology key (zone, hostname, ...)
    selector: LabelSelector
    namespaces: frozenset[str]
    max_skew: int = 1
    min_domains: Optional[int] = None
    # node-inclusion policies (topologynodefilter.go): affinity Honor
    # (default) computes skew only over domains the pod can reach;
    # Ignore counts every domain. Taints Ignore (default) counts all;
    # Honor counts only domains reachable via tolerated taints.
    node_affinity_policy: str = "Honor"
    node_taints_policy: str = "Ignore"
    # owner tolerations backing the taints=Honor filter
    owner_tolerations: tuple = ()
    owners: set[str] = field(default_factory=set)   # pod keys owning it
    counts: dict[str, int] = field(default_factory=dict)  # domain -> matching pods
    # anti-affinity only: domains where an *owner* pod landed — future
    # selector-matching pods are excluded from these (inverse scan)
    owner_counts: dict[str, int] = field(default_factory=dict)

    def matches(self, namespace: str, labels: dict[str, str]) -> bool:
        return namespace in self.namespaces and self.selector.matches(labels)

    def register_domain(self, domain: str) -> None:
        self.counts.setdefault(domain, 0)

    def record(self, domain: str, delta: int = 1) -> None:
        self.counts[domain] = self.counts.get(domain, 0) + delta

    # -- legality -------------------------------------------------------------

    def allowed_domains(
        self,
        candidate_domains: Iterable[str],
        eligible: Optional[set[str]] = None,
        taint_eligible: Optional[set[str]] = None,
    ) -> set[str]:
        """Domains where one more matching pod keeps the constraint
        satisfied (nextDomainTopologySpread topologygroup.go:226-311).

        `eligible`: the domains the POD itself may reach (its node
        selector / required affinity) — per NodeAffinityPolicy=Honor the
        skew minimum is computed over these, never over domains the pod
        could not land in."""
        candidates = set(candidate_domains)
        if self.type == TYPE_SPREAD:
            if self.node_affinity_policy == "Ignore":
                # skew is computed over EVERY domain, including ones
                # the pod's own selector excludes (the caller still
                # restricts actual placement via the candidate set)
                eligible = None
            if taint_eligible is not None:
                # nodeTaintsPolicy=Honor: domains only reachable via
                # taints the owner does not tolerate neither count in
                # the skew minimum nor accept placement
                # (topologynodefilter.go Matches)
                eligible = (
                    taint_eligible if eligible is None
                    else eligible & taint_eligible
                )
            if eligible is not None:
                # a domain the pod's own required terms exclude is never
                # a legal placement, and never part of the skew minimum
                candidates &= eligible
                if not candidates:
                    return set()
            live = {d: c for d, c in self.counts.items()}
            for d in candidates:
                live.setdefault(d, 0)
            if eligible is not None:
                live = {d: c for d, c in live.items() if d in eligible}
            if not live:
                return candidates
            global_min = min(live.values())
            # min_domains: while fewer domains than minDomains have
            # pods and an empty domain exists anywhere, the next pod
            # must open one (nextDomainTopologySpread's minDomains
            # handling) — candidates without an empty domain are
            # rejected. Only when NO domain is empty anywhere does the
            # k8s fallback apply: global minimum treated as 0 for the
            # skew check.
            if self.min_domains is not None:
                nonzero = sum(1 for c in live.values() if c > 0)
                if nonzero < self.min_domains:
                    if any(c == 0 for c in live.values()):
                        return {d for d in candidates if live.get(d, 0) == 0}
                    return {
                        d for d in candidates
                        if live.get(d, 0) + 1 <= self.max_skew
                    }
            return {
                d for d in candidates if live.get(d, 0) + 1 - global_min <= self.max_skew
            }
        if self.type == TYPE_AFFINITY:
            occupied = {d for d, c in self.counts.items() if c > 0}
            if not occupied:
                # first matching pod anywhere is legal only if an owner
                # self-selects (topologygroup.go anyCompatiblePod logic
                # approximated: handled by caller via `self_selecting`)
                return set(candidates)
            return candidates & occupied
        # anti-affinity: only empty domains
        return {d for d in candidates if self.counts.get(d, 0) == 0}

    def has_occupied(self) -> bool:
        return any(c > 0 for c in self.counts.values())


def _spread_signature(pod: Pod, tsc: TopologySpreadConstraint) -> tuple:
    sig = (
        TYPE_SPREAD,
        tsc.topology_key,
        tsc.max_skew,
        tsc.min_domains,
        tsc.when_unsatisfiable,
        tsc.label_selector,
        pod.metadata.namespace,
        tsc.node_affinity_policy,
        tsc.node_taints_policy,
    )
    if tsc.node_taints_policy == "Honor":
        # the taint filter is built from the OWNER pod's tolerations
        # (MakeTopologyNodeFilter, topologynodefilter.go:38-65), so
        # pods with different toleration sets cannot share a group
        sig = sig + (tuple(pod.spec.tolerations),)
    return sig


def _term_signature(kind: str, pod: Pod, term: PodAffinityTerm) -> tuple:
    namespaces = term.namespaces or (pod.metadata.namespace,)
    return (kind, term.topology_key, term.label_selector, tuple(sorted(namespaces)))


class Topology:
    """Global tracker for one scheduling run (topology.go:47)."""

    def __init__(
        self,
        domains: dict[str, set[str]],
        cluster_pods: Iterable[Pod] = (),
        pending_pods: Iterable[Pod] = (),
        pod_domains: Optional[dict[str, dict[str, str]]] = None,
        honor_schedule_anyway: bool = True,
        domain_taints: Optional[dict[str, dict[str, list]]] = None,
    ):
        """
        domains: topology key -> known domain values.
        cluster_pods: already-scheduled pods (seed counts + inverse
          anti-affinity).
        pod_domains: pod key -> {topology key: domain} for scheduled
          pods (derived from their node's labels).
        honor_schedule_anyway: treat ScheduleAnyway spread constraints
          as required (relaxed later by the preference ladder).
        domain_taints: topology key -> domain -> list of taint tuples,
          one per SOURCE (pool template or live node) contributing the
          domain; consumed by nodeTaintsPolicy=Honor constraints. A
          domain absent from the map counts as reachable untainted.
        """
        self.domains = {k: set(v) for k, v in domains.items()}
        # dedupe provenance: scheduler.record() appends one entry per
        # (type, value) source; identical taint tuples collapse
        self.domain_taints = {
            key: {d: list(dict.fromkeys(srcs)) for d, srcs in per.items()}
            for key, per in (domain_taints or {}).items()
        }
        # taint-eligibility caching (hot per-candidate-node loop)
        self._domain_generation = 0
        self._taint_elig_cache: dict[int, tuple[int, set]] = {}
        self.honor_schedule_anyway = honor_schedule_anyway
        self._groups: dict[tuple, TopologyGroup] = {}
        # required-only requirement sets, parsed once per pod per round
        # (allowed_domains_for_pod runs once per candidate node in the
        # scheduler loop — reparsing there would be quadratic)
        self._pod_reqs_cache: dict[str, "Requirements"] = {}
        pod_domains = pod_domains or {}

        for pod in pending_pods:
            for group in self._groups_for_pod(pod, create=True):
                group.owners.add(pod.key)

        # Inverse anti-affinity (topology.go:280-327): scheduled pods
        # with required anti-affinity block future matching pods.
        for pod in cluster_pods:
            aff = pod.spec.affinity
            if aff and aff.pod_anti_affinity:
                for term in aff.pod_anti_affinity.required:
                    sig = _term_signature(TYPE_ANTI_AFFINITY, pod, term)
                    group = self._ensure(sig, TYPE_ANTI_AFFINITY, term.topology_key,
                                         term.label_selector,
                                         term.namespaces or (pod.metadata.namespace,))
                    domain = pod_domains.get(pod.key, {}).get(term.topology_key)
                    if domain is not None:
                        group.owner_counts[domain] = group.owner_counts.get(domain, 0) + 1

        # Seed counts from scheduled pods for every group.
        for pod in cluster_pods:
            domains_for_pod = pod_domains.get(pod.key, {})
            for group in self._groups.values():
                if group.matches(pod.metadata.namespace, pod.metadata.labels):
                    domain = domains_for_pod.get(group.key)
                    if domain is not None:
                        group.record(domain)

    # -- group construction ---------------------------------------------------

    def _ensure(self, sig: tuple, type_: str, key: str, selector: LabelSelector,
                namespaces: Iterable[str], max_skew: int = 1,
                min_domains: Optional[int] = None,
                node_affinity_policy: str = "Honor",
                node_taints_policy: str = "Ignore",
                owner_tolerations: tuple = ()) -> TopologyGroup:
        group = self._groups.get(sig)
        if group is None:
            group = TopologyGroup(
                type=type_,
                key=key,
                selector=selector,
                namespaces=frozenset(namespaces),
                max_skew=max_skew,
                min_domains=min_domains,
                node_affinity_policy=node_affinity_policy,
                node_taints_policy=node_taints_policy,
                owner_tolerations=owner_tolerations,
            )
            for domain in self.domains.get(key, ()):  # known domains
                group.register_domain(domain)
            self._groups[sig] = group
        return group

    def _taint_eligible_domains(self, group: TopologyGroup) -> set[str]:
        """Domains reachable through at least one source (pool or live
        node) whose taints the group's owner tolerates. A domain with
        no recorded taint provenance counts as reachable untainted.
        Approximation vs the reference's per-NODE filter: counts from
        pods already running behind intolerable taints still
        contribute to domain totals (we track counts per domain, not
        per node)."""
        from karpenter_tpu_torch.scheduling.taints import tolerates

        cached = self._taint_elig_cache.get(id(group))
        if cached is not None and cached[0] == self._domain_generation:
            return cached[1]
        provenance = self.domain_taints.get(group.key, {})
        out = set()
        for domain in self.domains.get(group.key, ()):
            sources = provenance.get(domain)
            if not sources:
                out.add(domain)
                continue
            if any(
                tolerates(list(src), list(group.owner_tolerations)) is None
                for src in sources
            ):
                out.add(domain)
        self._taint_elig_cache[id(group)] = (self._domain_generation, out)
        return out

    def _groups_for_pod(self, pod: Pod, create: bool = False) -> list[TopologyGroup]:
        out = []
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.when_unsatisfiable == "ScheduleAnyway" and not self.honor_schedule_anyway:
                continue
            sig = _spread_signature(pod, tsc)
            if create:
                out.append(
                    self._ensure(
                        sig, TYPE_SPREAD, tsc.topology_key,
                        tsc.label_selector, (pod.metadata.namespace,),
                        tsc.max_skew, tsc.min_domains,
                        node_affinity_policy=tsc.node_affinity_policy,
                        node_taints_policy=tsc.node_taints_policy,
                        owner_tolerations=tuple(pod.spec.tolerations),
                    )
                )
            elif sig in self._groups:
                out.append(self._groups[sig])
        aff = pod.spec.affinity
        if aff:
            if aff.pod_affinity:
                for term in aff.pod_affinity.required:
                    sig = _term_signature(TYPE_AFFINITY, pod, term)
                    if create:
                        out.append(self._ensure(sig, TYPE_AFFINITY, term.topology_key,
                                                term.label_selector,
                                                term.namespaces or (pod.metadata.namespace,)))
                    elif sig in self._groups:
                        out.append(self._groups[sig])
            if aff.pod_anti_affinity:
                for term in aff.pod_anti_affinity.required:
                    sig = _term_signature(TYPE_ANTI_AFFINITY, pod, term)
                    if create:
                        out.append(self._ensure(sig, TYPE_ANTI_AFFINITY, term.topology_key,
                                                term.label_selector,
                                                term.namespaces or (pod.metadata.namespace,)))
                    elif sig in self._groups:
                        out.append(self._groups[sig])
        return out

    def has_constraints(self, pod: Pod) -> bool:
        """True if this pod carries topology constraints or is blocked
        by any anti-affinity group."""
        if pod.spec.topology_spread_constraints:
            return True
        aff = pod.spec.affinity
        if aff and (aff.pod_affinity or aff.pod_anti_affinity):
            return True
        for group in self._groups.values():
            if group.type == TYPE_ANTI_AFFINITY and group.matches(
                pod.metadata.namespace, pod.metadata.labels
            ):
                return True
        return False

    def invalidate(self, pod_key: str) -> None:
        """Drop the cached requirement parse for a pod whose spec was
        mutated (the preference-relaxation ladder edits pods in place)."""
        self._pod_reqs_cache.pop(pod_key, None)

    def register_domain(self, key: str, domain: str) -> None:
        self.domains.setdefault(key, set()).add(domain)
        for group in self._groups.values():
            if group.key == key:
                group.register_domain(domain)

    # -- placement API --------------------------------------------------------

    def allowed_domains_for_pod(
        self, pod: Pod, candidate: dict[str, set[str]]
    ) -> Optional[dict[str, set[str]]]:
        """Intersect candidate domains per topology key with every
        constraint this pod participates in. None => no legal placement.

        `candidate`: topology key -> domains the target node could take.
        """
        result = {k: set(v) for k, v in candidate.items()}
        pod_reqs = self._pod_reqs_cache.get(pod.key)
        if pod_reqs is None:
            from karpenter_tpu_torch.scheduling.requirements import Requirements

            pod_reqs = Requirements.from_pod(pod, required_only=True)
            self._pod_reqs_cache[pod.key] = pod_reqs
        # Constraints the pod owns
        for group in self._groups_for_pod(pod):
            domains = result.get(group.key)
            if domains is None:
                # node has no value for this key -> illegal for spread
                # constraints that require the label
                return None
            gate = pod_reqs.get(group.key)
            eligible = {
                d for d in self.domains.get(group.key, ()) if gate.has(d)
            } or None
            taint_eligible = None
            if group.node_taints_policy == "Honor":
                taint_eligible = self._taint_eligible_domains(group)
            allowed = group.allowed_domains(
                domains, eligible=eligible, taint_eligible=taint_eligible
            )
            if group.type == TYPE_AFFINITY and not group.has_occupied():
                # first pod: legal only if the pod self-selects (it
                # will satisfy its own affinity) — else any domain is
                # dead (reference: anyCompatiblePod check)
                if not group.matches(pod.metadata.namespace, pod.metadata.labels):
                    return None
            if not allowed:
                return None
            result[group.key] = allowed
        # Inverse anti-affinity: this pod matches some group's selector,
        # so it must avoid domains where that group's owners landed.
        for group in self._groups.values():
            if group.type != TYPE_ANTI_AFFINITY:
                continue
            if not group.matches(pod.metadata.namespace, pod.metadata.labels):
                continue
            domains = result.get(group.key)
            if domains is None:
                continue
            allowed = {d for d in domains if group.owner_counts.get(d, 0) == 0}
            if not allowed:
                return None
            result[group.key] = allowed
        return result

    def register(
        self, pod: Pod, chosen: dict[str, str], source_taints: tuple = ()
    ) -> None:
        """Commit a placement: update counts on all matching groups.
        `source_taints`: the placed node's taints, recorded as the new
        domains' provenance so nodeTaintsPolicy=Honor constraints see
        planned tainted nodes correctly."""
        self._domain_generation += 1
        for key, domain in chosen.items():
            if domain not in self.domains.get(key, ()):
                self.domains.setdefault(key, set()).add(domain)
            srcs = self.domain_taints.setdefault(key, {}).setdefault(
                domain, []
            )
            if tuple(source_taints) not in srcs:
                srcs.append(tuple(source_taints))
        for group in self._groups.values():
            domain = chosen.get(group.key)
            if domain is None:
                continue
            if group.matches(pod.metadata.namespace, pod.metadata.labels):
                group.record(domain)
            if group.type == TYPE_ANTI_AFFINITY and pod.key in group.owners:
                group.owner_counts[domain] = group.owner_counts.get(domain, 0) + 1
            group.register_domain(domain)
