"""Lower topology constraints to solver-native form.

Copy of `karpenter_tpu/solver/topo_batch.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The reference schedules topology-constrained pods one at a time,
re-asking the Topology tracker which domains remain legal before every
placement (scheduler.go:434-647 + topologygroup.go:226-311). That
serial loop is exactly what a batched device solver cannot run — so
this module *lowers* the constraints instead, into three forms the
packing kernel understands:

1. **Domain pins** — zonal / capacity-type / custom-key topology
   spread, pod affinity and pod anti-affinity over node-level domains
   become per-pod domain assignments computed host-side (water-filling
   to the minimum-count domain always satisfies any maxSkew >= 1;
   affinity restricts to occupied domains; anti-affinity hands out
   distinct empty domains). The assignment becomes an ordinary
   requirement pin (e.g. zone IN [z]) on a pseudo pod-group, which the
   dense compat matmul already enforces against config columns.

2. **Per-node group caps** (`group_cap[G]`, `existing_quota[E, G]`) —
   hostname-keyed topology spread means "at most maxSkew matching pods
   per node"; existing nodes get the cap net of pods already there.

3. **Group conflicts** (`conflict[G, G]`) — hostname-keyed pod
   anti-affinity (owners exclude selector-matched pods from their node
   and vice versa, topology.go:280-327) and host-port collisions
   (hostportusage.go) become pairwise node-sharing exclusions the
   kernel enforces with one masked reduction over its live assignment
   state.

Anything the lowering cannot express routes to the per-pod fallback
path — correctness never depends on the lowering being complete.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis.v1.labels import HOSTNAME_LABEL
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.scheduling.hostports import pod_host_ports
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.topology import (
    TYPE_AFFINITY,
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
    Topology,
    TopologyGroup,
)
from karpenter_tpu_torch.solver.encode import ExistingNodeInput, PodGroup, group_pods
from karpenter_tpu_torch.utils import resources as resutil

INT_MAX = np.iinfo(np.int32).max


@dataclass
class TopoBatch:
    """A device-solvable lowering of topology-constrained pods."""

    groups: list[PodGroup]
    group_cap: Optional[np.ndarray]        # [G] int32
    conflict: Optional[np.ndarray]         # [G, G] bool
    existing_quota: Optional[np.ndarray]   # [E, G] int32
    # pod key -> {topology key: domain} chosen host-side; hostname
    # domains are decided by the packer and filled in at registration
    assignments: dict[str, dict[str, str]]
    fallback: list[Pod]
    errors: dict[str, str] = field(default_factory=dict)


@dataclass
class _Partition:
    """Pods sharing the same constraint-group sets."""

    owned: list[TopologyGroup]
    foreign_anti: list[TopologyGroup]
    ports: frozenset
    pods: list[Pod] = field(default_factory=list)


def prepare(
    pods: Sequence[Pod],
    topology: Topology,
    existing_inputs: Sequence[ExistingNodeInput],
    host_ports: dict[str, object],
) -> TopoBatch:
    """Partition constrained pods and lower each partition, or route it
    to `fallback` when the constraint mix is not expressible."""
    partitions: dict[tuple, _Partition] = {}
    policy_fallback: list[Pod] = []
    for pod in pods:
        owned = topology._groups_for_pod(pod)
        if any(
            g.node_affinity_policy != "Honor"
            or g.node_taints_policy != "Ignore"
            for g in owned
        ):
            # non-default node-inclusion policies change the skew
            # ACCOUNTING (not just placement), which the water-fill
            # lowering does not express — the per-pod path implements
            # them via TopologyGroup.allowed_domains
            policy_fallback.append(pod)
            continue
        owned_ids = frozenset(id(g) for g in owned)
        foreign = [
            g
            for g in topology._groups.values()
            if g.type == TYPE_ANTI_AFFINITY
            and id(g) not in owned_ids
            and g.matches(pod.metadata.namespace, pod.metadata.labels)
        ]
        ports = frozenset(pod_host_ports(pod))
        key = (owned_ids, frozenset(id(g) for g in foreign), ports)
        part = partitions.get(key)
        if part is None:
            part = _Partition(owned=owned, foreign_anti=foreign, ports=ports)
            partitions[key] = part
        part.pods.append(pod)

    batch = TopoBatch(
        groups=[], group_cap=None, conflict=None, existing_quota=None,
        assignments={}, fallback=list(policy_fallback),
    )
    # local overlays so one prepare() run sees its own earlier
    # assignments without mutating the Topology before the solve
    local_counts: dict[tuple[int, str], int] = {}
    local_owner: dict[tuple[int, str], int] = {}

    # encoded-group metadata accumulated across partitions
    caps: list[int] = []
    # topo-group id -> encoded group indices owning / matched-by it
    anti_owners: dict[int, list[int]] = {}
    anti_matched: dict[int, list[int]] = {}
    spread_members: dict[int, list[int]] = {}
    group_ports: list[frozenset] = []

    # partitions owning domain-level anti-affinity claim their domains
    # first so selector-matched partitions see them excluded
    ordered = sorted(
        partitions.values(),
        key=lambda p: (
            0 if any(
                g.type == TYPE_ANTI_AFFINITY and g.key != HOSTNAME_LABEL
                for g in p.owned
            ) else 1
        ),
    )
    for part in ordered:
        _lower_partition(
            part, topology, batch, caps, anti_owners, anti_matched,
            spread_members, group_ports, local_counts, local_owner,
        )

    G = len(batch.groups)
    if G == 0:
        return batch

    group_cap = np.asarray(caps, np.int32)
    conflict = np.zeros((G, G), bool)
    # hostname anti-affinity: owners x (matched + owners) exclude each
    # other from sharing a node, both directions
    for gid, owners in anti_owners.items():
        matched = set(anti_matched.get(gid, ())) | set(owners)
        for o in owners:
            for m in matched:
                conflict[o, m] = True
                conflict[m, o] = True
    # host-port collisions: groups whose port sets intersect
    for a in range(G):
        if not group_ports[a]:
            continue
        for b in range(a, G):
            if _ports_conflict(group_ports[a], group_ports[b]):
                conflict[a, b] = True
                conflict[b, a] = True
    # a self-conflicting group must cap at one pod per node (the
    # kernel's fresh-node bulk open relies on it)
    for g in range(G):
        if conflict[g, g]:
            group_cap[g] = 1

    batch.group_cap = group_cap
    batch.conflict = conflict if conflict.any() else None
    batch.existing_quota = _existing_quota(
        batch, existing_inputs, topology, host_ports, anti_owners, anti_matched,
        spread_members, group_ports,
    )
    # FFD order (matches group_pods sorting) with metadata permuted
    order = sorted(
        range(G),
        key=lambda g: (
            -(batch.groups[g].resources.get(resutil.CPU, 0.0)),
            -(batch.groups[g].resources.get(resutil.MEMORY, 0.0)),
            batch.groups[g].requirements.signature(),
        ),
    )
    perm = np.asarray(order)
    batch.groups = [batch.groups[g] for g in order]
    batch.group_cap = batch.group_cap[perm]
    if batch.conflict is not None:
        batch.conflict = batch.conflict[np.ix_(perm, perm)]
    if batch.existing_quota is not None:
        batch.existing_quota = batch.existing_quota[:, perm]
    return batch


def _ports_conflict(a: frozenset, b: frozenset) -> bool:
    """(hostIP, port) overlap semantics (hostportusage.go: wildcard
    0.0.0.0 conflicts with any IP on the same port)."""
    return any(p1.conflicts(p2) for p1 in a for p2 in b)


def _lower_partition(
    part: _Partition,
    topology: Topology,
    batch: TopoBatch,
    caps: list[int],
    anti_owners: dict[int, list[int]],
    anti_matched: dict[int, list[int]],
    spread_members: dict[int, list[int]],
    group_ports: list[frozenset],
    local_counts: dict[tuple[int, str], int],
    local_owner: dict[tuple[int, str], int],
) -> None:
    domain_spread: list[TopologyGroup] = []
    host_spread: list[TopologyGroup] = []
    domain_affinity: list[TopologyGroup] = []
    domain_anti: list[TopologyGroup] = []
    host_anti: list[TopologyGroup] = []
    for g in part.owned:
        if g.type == TYPE_SPREAD:
            (host_spread if g.key == HOSTNAME_LABEL else domain_spread).append(g)
        elif g.type == TYPE_AFFINITY:
            if g.key == HOSTNAME_LABEL:
                batch.fallback.extend(part.pods)  # co-locate on one node:
                return                            # inherently sequential
            domain_affinity.append(g)
        else:
            (host_anti if g.key == HOSTNAME_LABEL else domain_anti).append(g)
    # (foreign domain-level anti-affinity is handled below via
    # candidate-domain subtraction)
    # min_domains beyond the candidate set flips the reference into its
    # "global min = 0" fallback rule, which water-filling cannot honor
    for g in domain_spread:
        if g.min_domains is not None and g.min_domains > len(
            topology.domains.get(g.key, ())
        ):
            batch.fallback.extend(part.pods)
            return

    shape_groups = group_pods(part.pods)
    if host_spread and len(shape_groups) > 1:
        # per-node spread counts would span several encoded groups,
        # which the static cap cannot express
        batch.fallback.extend(part.pods)
        return

    # per-key candidate domains and count overlays
    keys = sorted(
        {g.key for g in domain_spread}
        | {g.key for g in domain_affinity}
        | {g.key for g in domain_anti}
        | {g.key for g in part.foreign_anti if g.key != HOSTNAME_LABEL}
    )
    candidates: dict[str, list[str]] = {}
    for key in keys:
        cand = set(topology.domains.get(key, ()))
        for g in part.foreign_anti:
            if g.key == key:
                cand -= {
                    d for d in cand
                    if g.owner_counts.get(d, 0) + local_owner.get((id(g), d), 0) > 0
                }
        for g in domain_anti:
            cand -= {
                d for d in cand
                if g.counts.get(d, 0) + local_counts.get((id(g), d), 0) > 0
                or g.owner_counts.get(d, 0) + local_owner.get((id(g), d), 0) > 0
            }
        for g in domain_affinity:
            occupied = {
                d for d in g.counts
                if g.counts.get(d, 0) + local_counts.get((id(g), d), 0) > 0
            }
            if occupied:
                cand &= occupied
            else:
                sample = part.pods[0]
                if not g.matches(sample.metadata.namespace, sample.metadata.labels):
                    # no occupied domain yet and the pods can't seed
                    # their own — the per-pod path runs AFTER this
                    # round's other placements register, so the target
                    # may appear; defer rather than error
                    batch.fallback.extend(part.pods)
                    return
                # self-seeding: the whole partition lands in one
                # deterministic domain
                if cand:
                    cand = {sorted(cand)[0]}
        if not cand:
            batch.fallback.extend(part.pods)
            return
        candidates[key] = sorted(cand)

    cap = min((g.max_skew for g in host_spread), default=INT_MAX)

    # per-pod domain choice, bucketed into pinned pseudo-groups
    for shape in shape_groups:
        # the shape's OWN requirements (node selector, required node
        # affinity) restrict which domains its pods may use — and per
        # NodeAffinityPolicy=Honor semantics the skew is computed over
        # exactly that eligible set (topologygroup.go:226-311), so the
        # water-fill below must never pin a pod to an unreachable
        # domain nor count one in the minimum
        shape_cand: dict[str, list[str]] = {}
        reachable = True
        for key in keys:
            gate = shape.requirements.get(key)
            allowed = [d for d in candidates[key] if gate.has(d)]
            if not allowed:
                reachable = False
                break
            shape_cand[key] = allowed
        if not reachable:
            batch.fallback.extend(shape.pods)
            continue
        buckets: dict[tuple, list[Pod]] = {}
        for pod in shape.pods:
            assignment: dict[str, str] = {}
            dead = False
            for key in keys:
                cand = shape_cand[key]
                anti = [g for g in domain_anti if g.key == key]
                if anti:
                    # distinct empty domain per pod
                    free = [
                        d for d in cand
                        if all(
                            g.counts.get(d, 0) + local_counts.get((id(g), d), 0) == 0
                            for g in anti
                        )
                    ]
                    if not free:
                        batch.errors[pod.key] = (
                            f"pod anti-affinity on {key}: no empty domain left"
                        )
                        dead = True
                        break
                    choice = free[0]
                else:
                    spreads = [g for g in domain_spread if g.key == key]
                    if spreads:
                        # water-fill: the minimum-count domain always
                        # keeps skew <= maxSkew
                        def load(d):
                            return sum(
                                g.counts.get(d, 0)
                                + local_counts.get((id(g), d), 0)
                                for g in spreads
                            )

                        choice = min(cand, key=lambda d: (load(d), d))
                    else:
                        choice = cand[0]
                assignment[key] = choice
                for g in part.owned:
                    if g.key == key:
                        local_counts[(id(g), choice)] = (
                            local_counts.get((id(g), choice), 0) + 1
                        )
                        if g.type == TYPE_ANTI_AFFINITY:
                            local_owner[(id(g), choice)] = (
                                local_owner.get((id(g), choice), 0) + 1
                            )
            if dead:
                continue
            batch.assignments[pod.key] = assignment
            buckets.setdefault(tuple(assignment[k] for k in keys), []).append(pod)

        for domains, bucket in buckets.items():
            reqs = Requirements(list(shape.requirements.values()))
            for key, domain in zip(keys, domains):
                reqs.add(Requirement(key, IN, [domain]))
            gi = len(batch.groups)
            batch.groups.append(
                PodGroup(
                    requirements=reqs,
                    tolerations=shape.tolerations,
                    resources=shape.resources,
                    pods=bucket,
                )
            )
            caps.append(1 if host_anti else cap)
            group_ports.append(part.ports)
            for g in host_anti:
                anti_owners.setdefault(id(g), []).append(gi)
            for g in host_spread:
                spread_members.setdefault(id(g), []).append(gi)
            for g in part.foreign_anti:
                if g.key == HOSTNAME_LABEL:
                    anti_matched.setdefault(id(g), []).append(gi)


def _existing_quota(
    batch: TopoBatch,
    existing_inputs: Sequence[ExistingNodeInput],
    topology: Topology,
    host_ports: dict[str, object],
    anti_owners: dict[int, list[int]],
    anti_matched: dict[int, list[int]],
    spread_members: dict[int, list[int]],
    group_ports: list[frozenset],
) -> Optional[np.ndarray]:
    """Per-existing-node remaining capacity for each encoded group:
    hostname spread counts, anti-affinity owners already on the node,
    and host ports in use."""
    E = len(existing_inputs)
    G = len(batch.groups)
    if E == 0:
        return None
    quota = np.full((E, G), INT_MAX, np.int32)
    by_id = {id(g): g for g in topology._groups.values()}

    # invert the topo-group -> encoded-group maps once: the scan below
    # is O(E x G); per-cell list-membership tests would make it
    # quadratic in the batch size
    owners_of: dict[int, list[TopologyGroup]] = {}
    for gid, members in anti_owners.items():
        for gi in members:
            owners_of.setdefault(gi, []).append(by_id[gid])
    matched_of: dict[int, list[TopologyGroup]] = {}
    for gid, members in anti_matched.items():
        for gi in members:
            matched_of.setdefault(gi, []).append(by_id[gid])

    for gi in range(G):
        cap = int(batch.group_cap[gi]) if batch.group_cap is not None else INT_MAX
        for ei, inp in enumerate(existing_inputs):
            remaining = cap
            name = inp.name
            # hostname spread/anti counts live in the topo groups keyed
            # by node name
            for g in owners_of.get(gi, ()):
                if g.counts.get(name, 0) > 0:
                    remaining = 0
            for g in matched_of.get(gi, ()):
                if g.owner_counts.get(name, 0) > 0:
                    remaining = 0
            if remaining and group_ports[gi]:
                usage = host_ports.get(name)
                if usage is not None and _ports_conflict(
                    group_ports[gi],
                    frozenset(
                        p for ports in usage._reserved.values() for p in ports
                    ),
                ):
                    remaining = 0
            quota[ei, gi] = remaining
    # hostname spread: cap net of matching pods already on each node,
    # applied to the encoded groups that OWN the constraint
    for gid, members in spread_members.items():
        g = by_id[gid]
        for gi in members:
            for ei, inp in enumerate(existing_inputs):
                have = g.counts.get(inp.name, 0)
                quota[ei, gi] = min(quota[ei, gi], max(0, g.max_skew - have))
    return quota
