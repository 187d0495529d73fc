"""Dense encoding of the scheduling problem for the GPU solver.

Copy of `karpenter_tpu/solver/encode.py` (numpy on the host), without
its tracing span and its phase metrics:

- A **config** is one launchable node variant: (NodePool, InstanceType,
  Offering). Its requirement set is the intersection of the pool
  template's requirements/labels, the instance type's requirements and
  the offering's zone/capacity-type pins. Existing and in-flight nodes
  are appended as one-hot *pseudo-configs* carrying their own labels
  and remaining allocatable, which unifies the scheduler's three scan
  tiers (existing -> in-flight -> new) into one node axis.

- Pods with identical (requirements, tolerations, resources) collapse
  into **groups**; grouped first-fit is equivalent to per-pod FFD for
  identical pods under the lowest-index tie-break.

- Per label key, pod-side allowed values and config-side values are
  boolean masks over a finite vocabulary, ANDed across keys, with the
  reference's undefined-key rules (requirements.go:175-191): undefined
  well-known keys match, undefined custom keys match only
  NotIn/DoesNotExist.

`encoded_from_arrays` builds the kernel-facing half of an `Encoded`
from plain arrays, so the same problem can be handed to this package
and to the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis.v1.labels import (
    NODEPOOL_LABEL,
    WELL_KNOWN_LABELS,
)
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    Offering,
    effective_price as _effective_price,
)
from karpenter_tpu_torch.kube.objects import Pod, Taint
from karpenter_tpu_torch.metrics import sentinel
from karpenter_tpu_torch.metrics.store import SOLVER_PHASE_DURATION
from karpenter_tpu_torch.scheduling.requirement import (
    DOES_NOT_EXIST,
    IN,
    NOT_IN,
    Requirement,
)
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.scheduling.taints import tolerates
from karpenter_tpu_torch.utils import resources as resutil

# Resource axis order: the well-known resources first, extended after.
BASE_RESOURCES = (resutil.CPU, resutil.MEMORY, resutil.PODS, resutil.EPHEMERAL_STORAGE)


@dataclass
class PodGroup:
    """Pods sharing requirements/tolerations/resources/priority."""

    requirements: Requirements
    tolerations: tuple
    resources: dict[str, float]
    pods: list[Pod] = field(default_factory=list)
    # resolved PriorityClass value shared by the group's pods: groups
    # order priority-major, so the encode's group axis IS the
    # degradation order priority admission truncates against
    priority: int = 0

    @property
    def count(self) -> int:
        return len(self.pods)


def group_pods(pods: Sequence[Pod], required_only: bool = False) -> list[PodGroup]:
    """Group pods by scheduling signature, sorted priority-descending,
    then CPU+memory descending within a priority band (the reference
    queue's FFD order, scheduling/queue.go:31-60). Pods of different
    priorities never share a group — a group's unplaced tail must be
    attributable to ONE priority for the admission contract to hold —
    and with uniform priority (every pod 0, the common case) the order
    is byte-identical to the pre-priority sort.

    Requirements/resource parsing is memoized on a cheap raw-spec key so
    a 50k-pod batch with a few hundred distinct shapes pays the parse
    cost once per shape, not once per pod.
    """
    groups: dict[tuple, PodGroup] = {}
    parsed: dict[tuple, tuple] = {}
    for pod in pods:
        spec = pod.spec
        # Cheap hashable key over the scheduling-relevant raw spec;
        # frozensets avoid per-pod sorts (Toleration is a frozen
        # dataclass, so the tuple hashes directly).
        raw = (
            frozenset(spec.node_selector.items()) if spec.node_selector else None,
            tuple(r.signature() for r in spec.injected_requirements)
            if spec.injected_requirements else None,
            repr(spec.affinity) if spec.affinity is not None else None,
            tuple(spec.tolerations) if spec.tolerations else None,
            tuple(
                frozenset(c.requests.items())
                for c in spec.containers
            ),
            tuple(
                (frozenset(c.requests.items()), c.restart_policy)
                for c in spec.init_containers
            ) if spec.init_containers else None,
            frozenset(spec.overhead.items()) if spec.overhead else None,
            frozenset(spec.resources.items()) if spec.resources else None,
            spec.priority,
        )
        hit = parsed.get(raw)
        if hit is None:
            reqs = Requirements.from_pod(pod, required_only=required_only)
            resources = resutil.pod_requests(pod)
            tols = tuple(sorted(pod.spec.tolerations, key=repr))
            signature = (
                reqs.signature(),
                tols,
                tuple(sorted(resources.items())),
                spec.priority,
            )
            hit = (signature, reqs, tols, resources, spec.priority)
            parsed[raw] = hit
        signature, reqs, tols, resources, priority = hit
        group = groups.get(signature)
        if group is None:
            group = PodGroup(requirements=reqs, tolerations=tols,
                             resources=resources, priority=priority)
            groups[signature] = group
        group.pods.append(pod)
    return sorted(
        groups.values(),
        key=lambda g: (
            -g.priority,
            -(g.resources.get(resutil.CPU, 0.0)),
            -(g.resources.get(resutil.MEMORY, 0.0)),
            g.requirements.signature(),
        ),
    )


@dataclass
class ConfigInfo:
    """Host-side identity of one config column."""

    pool: Optional[NodePool]          # None for pseudo-configs
    instance_type: Optional[InstanceType]
    offering: Optional[Offering]
    existing_index: int = -1          # >=0 for pseudo-configs
    requirements: Requirements = field(default_factory=Requirements)
    taints: tuple[Taint, ...] = ()


@dataclass
class ExistingNodeInput:
    """One existing or in-flight node offered to the solver."""

    name: str
    requirements: Requirements        # labels (+ claim requirements if in-flight)
    taints: tuple[Taint, ...]
    available: dict[str, float]       # allocatable minus current usage
    pool_name: str = ""
    pod_count: int = 0


@dataclass
class Encoded:
    """Arrays shipped to the device solver plus host decode tables."""

    resource_keys: list[str]
    groups: list[PodGroup]
    configs: list[ConfigInfo]
    n_existing: int                       # pseudo-config / reserved node slots
    group_req: np.ndarray                 # [G, R] float32
    group_count: np.ndarray               # [G] int32
    compat: np.ndarray                    # [G, C] bool
    cfg_alloc: np.ndarray                 # [C, R] float32
    cfg_price: np.ndarray                 # [C] float32
    cfg_pool: np.ndarray                  # [C] int32 (pool order index; -1 pseudo)
    pool_overhead: np.ndarray             # [P+1, R] float32 daemon overhead per pool
    existing_used: np.ndarray             # [E, R] float32 (all zeros: available baked in)
    # Capacity-reservation budgets are keyed by reservation id, not by
    # config column: several columns (zones, pools, dedupe survivors)
    # can draw on ONE reservation and must share its remaining budget
    # (ReservationManager semantics, scheduling/reservationmanager.go).
    cfg_rsv: np.ndarray = None            # [C] int32 reservation slot, -1 = none
    rsv_cap: np.ndarray = None            # [K] f32 remaining instances per slot
    # Topology constraints in solver-native form: per-node pod caps per
    # group (hostname spread) and pairwise node-sharing exclusions
    # (hostname anti-affinity, host-port collisions).
    group_cap: np.ndarray = None          # [G] int32 max pods of g per node
    conflict: np.ndarray = None           # [G, G] bool mutually exclusive groups
    existing_quota: np.ndarray = None     # [E, G] int32 remaining cap per
                                          # existing node (counts already there)
    loose_groups: np.ndarray = None       # [G] bool groups constraining a key
                                          # configs leave open (k-way check
                                          # at decode)
    pool_min_values: np.ndarray = None    # [P+1] bool pools with minValues
                                          # floors (host decode metadata)
    group_priority: np.ndarray = None     # [G] int32 resolved PriorityClass
                                          # value per group (groups order
                                          # priority-major)
    # After column dedupe, every member (price, ConfigInfo) each column
    # represents — identical (pool, allocatable, compat column) configs
    # collapse to one device column and re-expand at decode. Aligned
    # with `configs`; empty for pseudo-configs.
    cfg_alts: list = None                 # [C] list[(price, ConfigInfo)]


def pool_template_requirements(
    pool: NodePool, with_labels: bool = True, with_pool_pin: bool = False
) -> Requirements:
    """The pool template's requirement set (spec requirements incl.
    minValues, plus template labels as IN pins, plus — with
    `with_pool_pin` — the karpenter.sh/nodepool identity pin that
    NewNodeClaimTemplate adds). The single source for every consumer —
    config building, domain discovery, daemon-overhead gating,
    minValues enforcement — so the assembly can't drift between
    sites."""
    reqs = Requirements()
    for spec in pool.spec.template.spec.requirements:
        reqs.add(Requirement(spec.key, spec.operator, spec.values, spec.min_values))
    if with_labels:
        for key, value in pool.spec.template.labels.items():
            reqs.add(Requirement(key, IN, [value]))
    if with_pool_pin:
        reqs.add(Requirement(NODEPOOL_LABEL, IN, [pool.metadata.name]))
    return reqs


def _config_requirements(
    pool: NodePool, it: InstanceType, offering: Offering
) -> Requirements:
    reqs = pool_template_requirements(pool, with_pool_pin=True)
    reqs.add(*it.requirements.values())
    reqs.add(*offering.requirements.values())
    return reqs


def build_configs(
    pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
    existing: Sequence[ExistingNodeInput] = (),
) -> list[ConfigInfo]:
    """Enumerate launchable configs (pool order) and append
    pseudo-configs for existing nodes."""
    return launch_configs(pools_with_types) + pseudo_configs(existing)


def launch_configs(
    pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
) -> list[ConfigInfo]:
    """The launchable-config columns alone — a pure function of the
    catalog."""
    configs: list[ConfigInfo] = []
    for pool, types in pools_with_types:
        # only the template's permanent taints gate pod placement:
        # startupTaints clear before initialization, so pods are
        # assumed to schedule past them (the reference's
        # NodeClaimTemplate exposes only Taints to the scheduler;
        # statenode.go:322-326 ignores a claim's own startup taints
        # while it initializes)
        taints = tuple(pool.spec.template.spec.taints)
        # the pool template's own requirements filter which types and
        # offerings may launch under it (InstanceTypes.Compatible,
        # types.go:243; offering filtering nodeclaim.go:373-447). A
        # conflicting (pool, type/offering) pair must never become a
        # config: no pod references the conflicting key, so the compat
        # matrix would not catch it.
        pool_reqs = pool_template_requirements(pool)
        for it in types:
            if pool_reqs.intersects(it.requirements) is not None:
                continue
            for offering in it.offerings:
                if not offering.available:
                    continue
                if pool_reqs.intersects(offering.requirements) is not None:
                    continue
                configs.append(
                    ConfigInfo(
                        pool=pool,
                        instance_type=it,
                        offering=offering,
                        requirements=_config_requirements(pool, it, offering),
                        taints=taints,
                    )
                )
    return configs


def pseudo_configs(
    existing: Sequence[ExistingNodeInput] = (),
) -> list[ConfigInfo]:
    """One-hot pseudo-config columns for existing/in-flight nodes."""
    configs: list[ConfigInfo] = []
    for idx, node in enumerate(existing):
        configs.append(
            ConfigInfo(
                pool=None,
                instance_type=None,
                offering=None,
                existing_index=idx,
                requirements=node.requirements,
                taints=tuple(node.taints),
            )
        )
    return configs


def encode(
    groups: Sequence[PodGroup],
    pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
    existing: Sequence[ExistingNodeInput] = (),
    daemon_overhead: Optional[dict[str, dict[str, float]]] = None,
    reserved_in_use: Optional[dict[str, int]] = None,
    group_cap: Optional[np.ndarray] = None,
    conflict: Optional[np.ndarray] = None,
    existing_quota: Optional[np.ndarray] = None,
    compat_cache=None,
) -> Encoded:
    """Build the dense problem. `daemon_overhead` maps pool name ->
    resource list of daemonset pods that will land on new nodes
    (reference scheduler.go:772-803). `reserved_in_use` maps
    reservation id -> instances already consumed by live nodes; the
    remainder caps how many nodes the solver may open against that
    reservation (ReservationManager semantics,
    scheduling/reservationmanager.go:28-110).

    `compat_cache` (solver/incremental.EncodedCache) memoizes the
    launchable-column compat rows across solves keyed on group
    signature: a steady-state tick whose pod shapes mostly repeat pays
    the G x C requirement evaluation only for NEW signatures (dirty
    rows); pseudo-config columns for existing nodes are always computed
    fresh (their labels/usage change tick to tick)."""
    _t_encode = time.perf_counter()
    if compat_cache is not None:
        configs = compat_cache.configs(pools_with_types, existing)
    else:
        configs = build_configs(pools_with_types, existing)
    n_launch = len(configs) - len(existing)

    # Resource axis: union of base + whatever appears anywhere.
    keys: list[str] = list(BASE_RESOURCES)
    seen = set(keys)
    for group in groups:
        for key in group.resources:
            if key not in seen:
                seen.add(key)
                keys.append(key)
    R = len(keys)
    G = len(groups)
    C = len(configs)

    group_req = np.zeros((G, R), np.float32)
    group_count = np.zeros((G,), np.int32)
    group_priority = np.zeros((G,), np.int32)
    for gi, group in enumerate(groups):
        group_count[gi] = group.count
        group_priority[gi] = group.priority
        for ri, key in enumerate(keys):
            group_req[gi, ri] = group.resources.get(key, 0.0)

    cfg_alloc = np.zeros((C, R), np.float32)
    cfg_price = np.zeros((C,), np.float32)
    cfg_pool = np.full((C,), -1, np.int32)
    cfg_rsv = np.full((C,), -1, np.int32)
    rsv_slots: dict[str, int] = {}
    rsv_cap_list: list[float] = []
    in_use = reserved_in_use or {}
    pool_order = {pool.metadata.name: i for i, (pool, _) in enumerate(pools_with_types)}

    def _reserve(ci: int, rid: str) -> None:
        remaining = float(
            max(0, configs[ci].offering.reservation_capacity - in_use.get(rid, 0))
        )
        slot = rsv_slots.get(rid)
        if slot is None:
            slot = len(rsv_cap_list)
            rsv_slots[rid] = slot
            rsv_cap_list.append(remaining)
        else:
            rsv_cap_list[slot] = max(rsv_cap_list[slot], remaining)
        cfg_rsv[ci] = slot

    if compat_cache is not None:
        # launchable arrays are catalog-static per resource axis;
        # only existing-node rows and reservation budgets (round
        # usage) are per-call
        la, lpr, lpo, lrids, lstatics = compat_cache.launch_arrays(
            keys, configs, n_launch, pool_order
        )
        cfg_alloc[:n_launch] = la
        cfg_price[:n_launch] = lpr
        cfg_pool[:n_launch] = lpo
        for ci in range(n_launch, C):
            node = existing[configs[ci].existing_index]
            for ri, key in enumerate(keys):
                cfg_alloc[ci, ri] = node.available.get(key, 0.0)
        for ci, rid in lrids:
            _reserve(ci, rid)
    else:
        for ci, cfg in enumerate(configs):
            if cfg.existing_index >= 0:
                node = existing[cfg.existing_index]
                for ri, key in enumerate(keys):
                    cfg_alloc[ci, ri] = node.available.get(key, 0.0)
                cfg_price[ci] = 0.0
            else:
                for ri, key in enumerate(keys):
                    cfg_alloc[ci, ri] = cfg.instance_type.allocatable.get(key, 0.0)
                # spot offerings are priced at price x (1 + interruption
                # penalty): the packer's cost signal accounts for the
                # expected reclaim, while the raw price stays what the
                # fleet pays (cloudprovider.types.effective_price)
                cfg_price[ci] = _effective_price(cfg.offering)
                cfg_pool[ci] = pool_order[cfg.pool.metadata.name]
                rid = cfg.offering.reservation_id
                if rid:
                    _reserve(ci, rid)

    if compat_cache is not None:
        # catalog already synced by the configs() call above — compat
        # consults the row cache without re-fingerprinting
        compat = compat_cache.compat(groups, configs, n_launch)
    else:
        compat = _full_compat(groups, configs)

    # Mutual exclusion: two groups can each be compatible with a
    # config yet unable to SHARE one node — their requirements pin a
    # key the config leaves open to several values. The reference's
    # in-flight NodeClaim catches this by tightening its requirement
    # set per added pod (nodeclaim.go:114-167); here it becomes a
    # pairwise conflict row. Keys every config pins to ONE value
    # cannot cause it, so only groups constraining an open key enter
    # the quadratic check (almost always none).
    loose_groups = np.zeros((G,), bool)
    if configs and G > 0:
        # pinning is judged over ALL config columns, existing nodes
        # included: a BYO node missing a well-known label leaves that
        # key open even though every launch config pins it
        if compat_cache is not None:
            # launchable stats are catalog-static; fold in the
            # per-call existing configs only
            cached_ok, cached_have = compat_cache.pin_stats(
                configs, n_launch
            )
            pin_ok = dict(cached_ok)
            n_have = dict(cached_have)
            scan = configs[n_launch:]
        else:
            pin_ok = {}
            n_have = {}
            scan = configs
        for cfg in scan:
            for req in cfg.requirements:
                single = req.operator() == IN and len(req.values) == 1
                n_have[req.key] = n_have.get(req.key, 0) + 1
                pin_ok[req.key] = pin_ok.get(req.key, True) and single
        always_pinned = {
            k for k, ok in pin_ok.items()
            if ok and n_have[k] == len(configs)
        }
        cand = [
            gi for gi, g in enumerate(groups)
            if any(k not in always_pinned for k in g.requirements.keys())
        ]
        # groups constraining an open key need k-way re-validation at
        # decode: pairwise rows cannot see a three-way empty
        # intersection (e.g. In[g,s] / In[s,b] / In[g,b])
        loose_groups[cand] = True
        mutual = None
        for i, a in enumerate(cand):
            for b in cand[i + 1 :]:
                if (
                    groups[a].requirements.intersects(
                        groups[b].requirements
                    )
                    is not None
                ):
                    if mutual is None:
                        mutual = np.zeros((G, G), bool)
                    mutual[a, b] = mutual[b, a] = True
        if mutual is not None:
            conflict = mutual if conflict is None else (conflict | mutual)

    n_pools = len(pools_with_types)
    pool_overhead = np.zeros((n_pools + 1, R), np.float32)
    if daemon_overhead:
        for pname, overhead in daemon_overhead.items():
            if pname in pool_order:
                for ri, key in enumerate(keys):
                    pool_overhead[pool_order[pname], ri] = overhead.get(key, 0.0)
    pool_min_values = np.zeros(n_pools + 1, bool)
    for pool, _types in pools_with_types:
        if pool_template_requirements(pool).has_min_values():
            pool_min_values[pool_order[pool.metadata.name]] = True

    # Column dedupe: launchable configs with identical (pool,
    # reservation, allocatable, compat column) are indistinguishable to
    # the packer — e.g. the same instance type's spot/on-demand
    # offerings when no pod constrains capacity-type. Collapse them to
    # one column carrying the min price; decode re-expands members.
    keep: list[int] = []
    by_key: dict[tuple, int] = {}
    alts_by_ci: dict[int, list] = {}

    def _dedupe_one(ci: int, key: tuple) -> None:
        cfg = configs[ci]
        rep = by_key.get(key)
        if rep is None:
            by_key[key] = ci
            alts_by_ci[ci] = [(float(cfg_price[ci]), cfg)]
            keep.append(ci)
        else:
            alts_by_ci[rep].append((float(cfg_price[ci]), cfg))
            if cfg_price[ci] < cfg_price[rep]:
                cfg_price[rep] = cfg_price[ci]

    if compat_cache is not None:
        # cached path: (pool, reservation, alloc-bytes) prefixes come
        # from the catalog-static table; the per-solve compat columns
        # are bit-packed in one vectorized pass (packbits is injective
        # at fixed G, so key equality is exactly column equality)
        col_bytes = np.ascontiguousarray(
            np.packbits(compat[:, :n_launch], axis=0).T
        )
        for ci in range(n_launch):
            _dedupe_one(ci, lstatics[ci] + (col_bytes[ci].tobytes(),))
        keep.extend(range(n_launch, C))
    else:
        for ci, cfg in enumerate(configs):
            if cfg.existing_index >= 0:
                keep.append(ci)
                continue
            key = (
                int(cfg_pool[ci]),
                cfg.offering.reservation_id if cfg.offering is not None else "",
                cfg_alloc[ci].tobytes(),
                compat[:, ci].tobytes(),
            )
            _dedupe_one(ci, key)
    cfg_alts = [alts_by_ci.get(i, []) for i in keep]
    if len(keep) < len(configs):
        configs = [configs[i] for i in keep]
        compat = np.ascontiguousarray(compat[:, keep])
        cfg_alloc = np.ascontiguousarray(cfg_alloc[keep])
        cfg_price = np.ascontiguousarray(cfg_price[keep])
        cfg_pool = np.ascontiguousarray(cfg_pool[keep])
        cfg_rsv = np.ascontiguousarray(cfg_rsv[keep])

    _encode_wall = time.perf_counter() - _t_encode
    SOLVER_PHASE_DURATION.observe(_encode_wall, {"phase": "encode"})
    sentinel.observe_phase("encode", _encode_wall)
    return Encoded(
        resource_keys=keys,
        groups=list(groups),
        configs=configs,
        n_existing=len(existing),
        group_req=group_req,
        group_count=group_count,
        group_priority=group_priority,
        compat=compat,
        cfg_alloc=cfg_alloc,
        cfg_price=cfg_price,
        cfg_pool=cfg_pool,
        pool_overhead=pool_overhead,
        existing_used=np.zeros((len(existing), R), np.float32),
        cfg_rsv=cfg_rsv,
        rsv_cap=np.asarray(rsv_cap_list, np.float32),
        group_cap=group_cap,
        conflict=conflict,
        existing_quota=existing_quota,
        loose_groups=loose_groups,
        pool_min_values=pool_min_values,
        cfg_alts=cfg_alts,
    )


def requirement_compat(
    groups: Sequence[PodGroup], configs: Sequence[ConfigInfo]
) -> np.ndarray:
    """[G, C] requirement-only compatibility: the funnel stage the
    explain plane (explain/funnel.py) replays from the same vocab-mask
    machinery the encode uses. Taint tolerance is its own stage."""
    return _compat_matrix(groups, configs)


# the array fields a solve reads, in the order the JAX package names
# them on its Encoded; the optional ones may be absent or None
ENCODED_ARRAYS = (
    "compat", "group_req", "group_count", "cfg_alloc", "cfg_price",
    "cfg_pool", "pool_overhead", "existing_used",
)
ENCODED_OPTIONAL_ARRAYS = (
    "cfg_rsv", "rsv_cap", "group_cap", "conflict", "existing_quota",
)


def encoded_from_arrays(
    d: dict[str, np.ndarray], n_existing: int = 0,
    cfg_existing: Optional[np.ndarray] = None,
) -> Encoded:
    """An `Encoded` whose kernel inputs are the given arrays.

    `d` holds the array fields of an encode (`ENCODED_ARRAYS`, and any
    of `ENCODED_OPTIONAL_ARRAYS`), for example the fields of the JAX
    package's `Encoded` as numpy. `cfg_existing` [C] names the existing
    node each pseudo-config column stands for (-1 for a launchable
    column); without it no column is an existing node. The host decode
    tables (groups, config identities) are placeholders: the result
    feeds the packer, not `_build_solution_arrays`."""
    missing = [k for k in ENCODED_ARRAYS if k not in d]
    if missing:
        raise KeyError(f"encoded_from_arrays: missing arrays {missing}")
    compat = np.ascontiguousarray(d["compat"], dtype=bool)
    G, C = compat.shape
    group_req = np.ascontiguousarray(d["group_req"], dtype=np.float32)
    if cfg_existing is None:
        cfg_existing = np.full((C,), -1, np.int32)
    configs = [
        ConfigInfo(pool=None, instance_type=None, offering=None,
                   existing_index=int(e))
        for e in np.asarray(cfg_existing)
    ]
    opt = {
        k: (np.array(d[k]) if d.get(k) is not None else None)
        for k in ENCODED_OPTIONAL_ARRAYS
    }
    return Encoded(
        resource_keys=[f"r{i}" for i in range(group_req.shape[1])],
        groups=[PodGroup(Requirements(), (), {}) for _ in range(G)],
        configs=configs,
        n_existing=int(n_existing),
        group_req=group_req,
        group_count=np.array(d["group_count"]),
        compat=compat,
        cfg_alloc=np.ascontiguousarray(d["cfg_alloc"], dtype=np.float32),
        cfg_price=np.ascontiguousarray(d["cfg_price"], dtype=np.float32),
        cfg_pool=np.ascontiguousarray(d["cfg_pool"], dtype=np.int32),
        pool_overhead=np.ascontiguousarray(d["pool_overhead"], dtype=np.float32),
        existing_used=np.ascontiguousarray(d["existing_used"], dtype=np.float32),
        **opt,
    )


def _full_compat(
    groups: Sequence[PodGroup], configs: Sequence[ConfigInfo]
) -> np.ndarray:
    """[G, C] compat = requirement compatibility AND taint tolerance."""
    compat = _compat_matrix(groups, configs)
    for ci, cfg in enumerate(configs):
        if not cfg.taints:
            continue
        for gi, group in enumerate(groups):
            if tolerates(cfg.taints, list(group.tolerations)) is not None:
                compat[gi, ci] = False
    return compat


def _compat_matrix(groups: Sequence[PodGroup], configs: Sequence[ConfigInfo]) -> np.ndarray:
    """[G, C] requirement compatibility via per-key vocab masks.

    Semantics mirror Requirements.compatible(pod, AllowUndefinedWellKnown)
    evaluated config-side: every pod-constrained key must intersect the
    config's values; keys the config doesn't define pass when well-known
    or when the pod operator is NotIn/DoesNotExist.
    """
    G, C = len(groups), len(configs)
    compat = np.ones((G, C), dtype=bool)

    # Keys constrained by any pod group.
    pod_keys: set[str] = set()
    for group in groups:
        pod_keys.update(group.requirements.keys())

    for key in pod_keys:
        vocab: dict[str, int] = {}
        for cfg in configs:
            if cfg.requirements.has(key):
                for value in cfg.requirements.get(key).values:
                    vocab.setdefault(value, len(vocab))
        for group in groups:
            if group.requirements.has(key):
                for value in group.requirements.get(key).values:
                    vocab.setdefault(value, len(vocab))
        values = list(vocab)
        V = len(values)

        cfg_defined = np.zeros((C,), dtype=bool)
        cfg_mask = np.zeros((C, V + 1), dtype=bool)  # last col: "any other value"
        for ci, cfg in enumerate(configs):
            if not cfg.requirements.has(key):
                continue
            cfg_defined[ci] = True
            req = cfg.requirements.get(key)
            for vi, value in enumerate(values):
                cfg_mask[ci, vi] = req.has(value)
            # complement config reqs admit values outside the vocab too
            cfg_mask[ci, V] = req.complement

        for gi, group in enumerate(groups):
            if not group.requirements.has(key):
                continue
            req = group.requirements.get(key)
            pod_mask = np.zeros((V + 1,), dtype=bool)
            for vi, value in enumerate(values):
                pod_mask[vi] = req.has(value)
            pod_mask[V] = req.complement and (
                req.greater_than is None and req.less_than is None
            )
            op = req.operator()
            undefined_ok = key in WELL_KNOWN_LABELS or op in (NOT_IN, DOES_NOT_EXIST)
            key_compat = np.where(
                cfg_defined,
                (cfg_mask & pod_mask[None, :]).any(axis=1),
                undefined_ok,
            )
            compat[gi] &= key_compat
    return compat
