"""Incremental warm-start solve pipeline: dirty-set re-encoding and
residual repack.

Copy of `karpenter_tpu/solver/incremental.py`, whole, with its imports
pointed into `karpenter_tpu_torch`. The one addition is the device:
`IncrementalPipeline(..., device=None)` and `build_dual_floor(enc,
device=None)` hand it to every `solve_encoded`, `solve` and
`lp_device.maybe_solve` they run; `None` means the card, and without a
CUDA device they raise as `solver.solve` does.

1. **EncodedCache** (dirty-set re-encoding): the launchable half of
   the encoded problem — the ConfigInfo columns and the [G, C] compat
   rows — is a pure function of (catalog, group signature). Cache it
   across solves; a tick whose pod shapes mostly repeat recomputes
   compat only for NEW signatures, and config construction is skipped
   while the catalog fingerprint holds. Every cached row is exactly
   what a fresh encode would compute; the cache's own tables are
   lock-guarded.

2. **IncrementalPipeline** (warm-start residual repack): the previous
   solution IS the warm start. Each tick diffs the pod set against the
   retained assignment, frees capacity for deleted pods, and routes
   only displaced/new pods through the packing kernels (B1 or B3 by
   `pack.WAVEFRONT_MIN_GROUPS`, then B2) against the residual node
   capacities. Correctness backstops: a full re-solve when churn
   exceeds KARPENTER_INCR_CHURN_MAX, and a periodic full re-solve
   every KARPENTER_INCR_FULL_EVERY ticks that the incremental fleet
   must match within KARPENTER_INCR_DRIFT_EPS on price or be replaced
   by — skipped when the cached dual floor (`_DualFloor`, B5's duals)
   already certifies the retained fleet.

The pipeline is scoped to the batched fast path (selector/resource
demand, no topology constraints); constrained pods keep going through
the full Scheduler machinery. Encode calls sharing one cache must be
serialized.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis.v1.labels import HOSTNAME_LABEL
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics.store import (
    SOLVER_ENCODE_CACHE,
    SOLVER_INCREMENTAL_TICKS,
)
from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.solver.encode import (
    ConfigInfo,
    ExistingNodeInput,
    PodGroup,
    _config_requirements,
    _full_compat,
    launch_configs,
    pseudo_configs,
)
from karpenter_tpu_torch.utils import resources as resutil


def catalog_fingerprint(pools_with_types) -> tuple:
    """Cheap identity of the launchable catalog: everything
    build_configs reads that can change which config columns exist or
    what they require. Instance types are fingerprinted by object
    identity + name (providers rebuild the objects when a type
    changes; the cache pins the referenced catalog so ids cannot be
    recycled while cached); pools by their spec hash, which covers
    template requirements, labels and taints."""
    # zone/capacity-type/reservation-id are construction-time constants
    # of an Offering (and reading them walks requirement lookups), so
    # object identity covers them; price/availability ARE flipped in
    # place by providers (ICE marking, overlays) and read as plain
    # attributes into FLAT tuples (this runs twice per steady tick —
    # nested per-offering tuples measurably showed up in profiles).
    # The spot interruption penalty is part of the fingerprint: cached
    # cfg_price arrays bake it in, so a flipped penalty must bust them.
    from karpenter_tpu_torch.cloudprovider.types import interruption_penalty

    return (interruption_penalty(),) + tuple(
        (
            pool.metadata.name,
            pool.hash(),
            id(pool),
            tuple(id(it) for it in types),
            tuple(
                x for it in types for o in it.offerings
                for x in (o.price, o.available, o.reservation_capacity)
            ),
        )
        for pool, types in pools_with_types
    )


class EncodedCache:
    """Compat-row + config-column cache for encode() (dirty-set
    re-encoding). Rows are keyed by (group requirements signature,
    tolerations) under one catalog fingerprint; a catalog change busts
    everything. Bounded LRU-ish (insertion-order eviction)."""

    def __init__(self, max_rows: int = 4096):
        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._fp: Optional[tuple] = None
        self._pin = None                  # strong ref: keeps catalog ids valid
        self._launch: Optional[list[ConfigInfo]] = None
        self._rows: dict[tuple, np.ndarray] = {}
        # launchable cfg_alloc/price/pool arrays + reservation ids,
        # keyed by the resource-axis tuple (extended resources extend
        # the axis per demand mix)
        self._arrays: dict[tuple, tuple] = {}
        self._pin_stats: Optional[tuple[dict, dict]] = None

    # -- invalidation ---------------------------------------------------------

    def invalidate(self) -> None:
        """Explicit bust (relist / resync boundary / NodePool event)."""
        with self._lock:
            if self._rows or self._launch is not None:
                SOLVER_ENCODE_CACHE.inc({"outcome": "bust"})
            self._fp = None
            self._pin = None
            self._launch = None
            self._rows.clear()
            self._arrays.clear()
            self._pin_stats = None

    def _sync_catalog(self, pools_with_types) -> None:
        """Under lock: bust on catalog fingerprint change."""
        fp = catalog_fingerprint(pools_with_types)
        if fp != self._fp:
            if self._fp is not None:
                SOLVER_ENCODE_CACHE.inc({"outcome": "bust"})
            self._fp = fp
            self._pin = [(pool, tuple(types)) for pool, types in pools_with_types]
            self._launch = None
            self._rows.clear()
            self._arrays.clear()
            self._pin_stats = None

    # -- encode() hooks -------------------------------------------------------

    def configs(self, pools_with_types, existing=()) -> list[ConfigInfo]:
        """build_configs with the launchable prefix cached per catalog.
        The returned list is fresh; the launchable ConfigInfo objects
        are shared across calls and treated as IMMUTABLE by encode
        (per-encode dedupe membership lives on Encoded.cfg_alts)."""
        with self._lock:
            self._sync_catalog(pools_with_types)
            if self._launch is None:
                self._launch = launch_configs(pools_with_types)
            launch = self._launch
        return list(launch) + pseudo_configs(existing)

    def launch_arrays(
        self,
        resource_keys: Sequence[str],
        configs: Sequence[ConfigInfo],
        n_launch: int,
        pool_order: dict[str, int],
    ):
        """(cfg_alloc, cfg_price, cfg_pool, [(ci, reservation_id)])
        for the launchable prefix — pure functions of the catalog and
        the resource axis, cached per axis under the current catalog
        fingerprint (encode copies the arrays into its padded output,
        so the cached originals are never mutated). Reservation
        BUDGETS are not cached: remaining capacity depends on
        per-round usage and is recomputed by encode from the returned
        (ci, rid) list."""
        keys = tuple(resource_keys)
        with self._lock:
            hit = self._arrays.get(keys)
            if hit is not None:
                return hit
        R = len(keys)
        alloc = np.zeros((n_launch, R), np.float32)
        price = np.zeros((n_launch,), np.float32)
        pool = np.full((n_launch,), -1, np.int32)
        rids: list[tuple[int, str]] = []
        statics: list[tuple] = []
        from karpenter_tpu_torch.cloudprovider.types import effective_price

        for ci in range(n_launch):
            cfg = configs[ci]
            allocatable = cfg.instance_type.allocatable
            for ri, key in enumerate(keys):
                alloc[ci, ri] = allocatable.get(key, 0.0)
            # spot offerings enter the packing objective at their
            # interruption-penalized price (the penalty is part of the
            # catalog fingerprint, so a changed knob busts this cache)
            price[ci] = effective_price(cfg.offering)
            pool[ci] = pool_order[cfg.pool.metadata.name]
            rid = cfg.offering.reservation_id
            if rid:
                rids.append((ci, rid))
            # the catalog-static 3/4 of encode's dedupe key (the
            # fourth, the compat column, is per-solve)
            statics.append((int(pool[ci]), rid or "", alloc[ci].tobytes()))
        out = (alloc, price, pool, rids, statics)
        with self._lock:
            if len(self._arrays) > 8:  # distinct resource axes are few
                self._arrays.clear()
            self._arrays[keys] = out
        return out

    def pin_stats(self, configs: Sequence[ConfigInfo], n_launch: int):
        """(pin_ok, n_have) over the LAUNCHABLE configs for encode's
        always-pinned-key analysis — catalog-static; encode merges the
        per-call existing configs into copies."""
        with self._lock:
            if self._pin_stats is not None:
                return self._pin_stats
        pin_ok: dict[str, bool] = {}
        n_have: dict[str, int] = {}
        for ci in range(n_launch):
            for req in configs[ci].requirements:
                single = req.operator() == IN and len(req.values) == 1
                n_have[req.key] = n_have.get(req.key, 0) + 1
                pin_ok[req.key] = pin_ok.get(req.key, True) and single
        with self._lock:
            self._pin_stats = (pin_ok, n_have)
        return self._pin_stats

    def compat(
        self,
        groups: Sequence[PodGroup],
        configs: Sequence[ConfigInfo],
        n_launch: int,
        pools_with_types=None,
    ) -> np.ndarray:
        """[G, C] compat with the launchable columns served from cache
        per group signature; only signatures not seen under the current
        catalog (the dirty rows) pay the requirement/taint evaluation.
        Per-pair compat is independent of which other configs share the
        call, so splitting launchable/pseudo columns is exact."""
        G, C = len(groups), len(configs)
        if pools_with_types is not None:
            with self._lock:
                self._sync_catalog(pools_with_types)
        rows = np.empty((G, n_launch), dtype=bool)
        missing: list[tuple[int, tuple]] = []
        with self._lock:
            for gi, group in enumerate(groups):
                key = (group.requirements.signature(), group.tolerations)
                hit = self._rows.get(key)
                if hit is None or hit.shape[0] != n_launch:
                    missing.append((gi, key))
                else:
                    rows[gi] = hit
        hits = G - len(missing)
        if hits:
            SOLVER_ENCODE_CACHE.inc({"outcome": "hit"}, value=float(hits))
        if missing:
            SOLVER_ENCODE_CACHE.inc(
                {"outcome": "miss"}, value=float(len(missing))
            )
            fresh = _full_compat(
                [groups[gi] for gi, _ in missing], configs[:n_launch]
            )
            with self._lock:
                for row_i, (gi, key) in enumerate(missing):
                    rows[gi] = fresh[row_i]
                    self._rows[key] = fresh[row_i].copy()
                while len(self._rows) > self.max_rows:
                    self._rows.pop(next(iter(self._rows)))
        if n_launch < C:
            pseudo = _full_compat(groups, configs[n_launch:])
            return np.ascontiguousarray(
                np.concatenate([rows, pseudo], axis=1)
            )
        return rows


# -- residual repack ----------------------------------------------------------


@dataclass
class ResidualNode:
    """One node retained from the previous tick's solution, with its
    live load — the warm start the next tick packs against."""

    name: str
    pool: NodePool
    instance_type: InstanceType
    offering: Offering
    price: float
    requirements: Requirements
    taints: tuple
    used: dict[str, float]
    pods: dict[str, Pod] = field(default_factory=dict)

    def available(self) -> dict[str, float]:
        return resutil.positive(
            resutil.subtract(self.instance_type.allocatable, self.used)
        )


@dataclass
class TickResult:
    mode: str                  # "incremental" | "full"
    reason: str                # "steady" | "cold" | "churn" | "catalog"
                               # | "drift" | "checked" | "dual_floor"
                               # | "invalidate"
    scheduled: int
    unschedulable: int
    fleet_price: float
    nodes: int
    churn: float = 0.0
    placed: int = 0            # pods routed through the repack solve
    drift: Optional[float] = None  # backstop ticks: inc/full price - 1


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).lower() not in (
        "0", "false", "off"
    )


@dataclass
class _DualFloor:
    """The cached dual certificate the residual repack spends: built
    from the device LP of the last FULL solve's encode and
    valid for as long as the catalog fingerprint holds (prices,
    offerings and the reprice/penalty knobs are all inside the
    fingerprint, so a reprice busts it through the normal full-tick
    path).

    - `lam_by_sig`: Farley-scaled demand duals keyed by group
      signature (requirements signature, tolerations, resource
      vector) — demand-INDEPENDENT dual feasibility means they bound
      any later tick's demand: unknown signatures price at 0
      (conservative), so `bound_for` is a valid weak-duality lower
      bound on ANY fresh-fleet covering of the current pod set.
    - `rank_launch`: the dual-adjusted reduced-cost price ordering
      over the launchable config prefix (lp_device.rank_prices) — the
      repack feeds it to the kernel as its type-preference input via
      solve_encoded(price_hint=...); decode keeps true prices.
    """

    lam_by_sig: dict
    cap_term: float
    rank_launch: np.ndarray
    n_launch: int

    def bound_for(self, groups: Sequence[PodGroup]) -> float:
        total = 0.0
        for g in groups:
            sig = (
                g.requirements.signature(),
                g.tolerations,
                tuple(sorted(g.resources.items())),
            )
            lam = self.lam_by_sig.get(sig)
            if lam:
                total += lam * len(g.pods)
        return max(0.0, total - self.cap_term)


def build_dual_floor(enc, device=None) -> Optional[_DualFloor]:
    """Construct the dual certificate from one solve's encode (shared
    by the repack pipeline and the live tick's micro path). The device
    LP (B5) runs on `device`; None is the card, raising without one.
    Returns None when the device LP is unavailable or the derivation
    fails — callers run exactly the unguided path."""
    from karpenter_tpu_torch.solver import lp_device
    from karpenter_tpu_torch.solver.solver import resolve_device

    dlp = lp_device.maybe_solve(enc, device=resolve_device(device))
    if dlp is None:
        return None
    try:
        launch = enc.cfg_pool >= 0
        n_launch = int(launch.sum())
        # plannability mask, exactly as lp_device._stage derives
        # it: the ascent prices only groups some launchable
        # machine can hold one pod of — duals of excluded groups
        # never entered the Farley scaling, so they must not
        # enter the floor either
        req = enc.group_req.astype(np.float64)
        eff = np.clip(
            enc.cfg_alloc
            - enc.pool_overhead[np.maximum(enc.cfg_pool, 0)],
            0.0, None,
        )
        eff = np.where(launch[:, None], eff, 0.0)
        safe = np.where(req > 0, req, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.floor((eff[None, :, :] + 1e-4) / safe[:, None, :])
        k = np.where(req[:, None, :] > 0, k, np.inf).min(axis=2)
        k = np.where(enc.compat & launch[None, :], k, 0.0)
        plannable = np.asarray(k >= 1).any(axis=1)
        lam_by_sig: dict = {}
        for gi, g in enumerate(enc.groups):
            if not plannable[gi]:
                continue
            sig = (
                g.requirements.signature(),
                g.tolerations,
                tuple(sorted(g.resources.items())),
            )
            lam = float(dlp.lam[gi])
            prev = lam_by_sig.get(sig)
            # signature collisions keep the smaller dual: the
            # bound must stay valid for either group's demand
            lam_by_sig[sig] = lam if prev is None else min(prev, lam)
        cap_term = 0.0
        if enc.rsv_cap is not None and len(dlp.mu):
            cap_term = float(
                dlp.mu @ enc.rsv_cap.astype(np.float64)
            )
        return _DualFloor(
            lam_by_sig=lam_by_sig,
            cap_term=cap_term,
            rank_launch=lp_device.rank_prices(enc, dlp)[:n_launch],
            n_launch=n_launch,
        )
    except Exception:
        import logging

        logging.getLogger("karpenter.solver.incremental").exception(
            "dual certificate derivation failed; caller runs unguided"
        )
        return None


class IncrementalPipeline:
    """Tick-to-tick warm-start solver over one pod population.

    `solve_tick(pods, pools_with_types)` returns a TickResult. The
    first tick (and any tick after invalidate()/catalog change/churn
    blow-out) runs the normal full solve and adopts its fleet; steady
    ticks diff the pod set, free capacity for deletions, and repack
    only new/changed pods against the residual fleet.

    With a kube client, a DirtyTracker on Pods feeds the changed set so
    in-place mutations (which keep object identity) are still caught;
    without one, object identity is the change signal — callers that
    mutate pods in place must pass fresh objects or call mark_dirty().
    """

    def __init__(
        self,
        kube=None,
        churn_max: Optional[float] = None,
        full_every: Optional[int] = None,
        drift_eps: Optional[float] = None,
        daemon_overhead: Optional[dict[str, dict[str, float]]] = None,
        repack_objective: str = "ffd",
        device=None,
    ):
        # the device of every solve and device LP of the pipeline: None
        # is the card (raising without one), as in solver.solve; the
        # host backend runs no device
        from karpenter_tpu_torch.solver.solver import _backend, resolve_device

        self.device = (
            resolve_device(device) if _backend() != "host" else None
        )
        self.cache = EncodedCache()
        self.churn_max = (
            churn_max if churn_max is not None
            else _env_float("KARPENTER_INCR_CHURN_MAX", 0.25)
        )
        self.full_every = (
            full_every if full_every is not None
            else int(_env_float("KARPENTER_INCR_FULL_EVERY", 16))
        )
        self.drift_eps = (
            drift_eps if drift_eps is not None
            else _env_float("KARPENTER_INCR_DRIFT_EPS", 0.01)
        )
        self.daemon_overhead = daemon_overhead or {}
        self.repack_objective = repack_objective
        # dual certificate from the last full solve's encode
        # (KARPENTER_INCR_DUAL_RANK / KARPENTER_INCR_DUAL_FLOOR knobs)
        self._dual: Optional[_DualFloor] = None
        self._fleet: Optional[list[ResidualNode]] = None
        self._where: dict[str, ResidualNode] = {}
        self._pods: dict[str, Pod] = {}
        self._unplaced: set[str] = set()
        self._marked: set[str] = set()
        self._catalog_fp: Optional[tuple] = None
        self._seq = 0
        self._tick = 0
        self._tracker = None
        if kube is not None:
            from karpenter_tpu_torch.kube.dirty import DirtyTracker

            self._tracker = DirtyTracker(kube).watch("Pod")

    # -- state management -----------------------------------------------------

    def invalidate(self) -> None:
        """Full bust: relist/resync boundaries, or any time the caller
        can no longer vouch for the retained assignment."""
        self._fleet = None
        self._where = {}
        self._pods = {}
        self._unplaced = set()
        self._marked = set()
        self._catalog_fp = None
        self._dual = None
        self.cache.invalidate()
        if self._tracker is not None:
            # the next tick rebuilds from scratch anyway; stale dirty
            # keys must not force a second rebuild after it
            self._tracker.clear()

    def mark_dirty(self, *pod_keys: str) -> None:
        """Force pods into the next tick's changed set (the manual
        analogue of the kube-wired DirtyTracker for in-place
        mutations)."""
        self._marked.update(pod_keys)

    @property
    def fleet_price(self) -> float:
        return sum(n.price for n in self._fleet) if self._fleet else 0.0

    def _node_from_plan(self, plan) -> Optional[ResidualNode]:
        it, off = plan.primary()
        if plan.pool is None or it is None or off is None:
            return None
        self._seq += 1
        name = f"inc-{self._seq}"
        reqs = _config_requirements(plan.pool, it, off)
        reqs.add(Requirement(HOSTNAME_LABEL, IN, [name]))
        used = resutil.merge(
            self.daemon_overhead.get(plan.pool.metadata.name, {}),
            resutil.requests_for_pods(plan.pods),
        )
        node = ResidualNode(
            name=name,
            pool=plan.pool,
            instance_type=it,
            offering=off,
            price=float(plan.price),
            requirements=reqs,
            taints=tuple(plan.pool.spec.template.spec.taints),
            used=used,
        )
        for p in plan.pods:
            node.pods[p.key] = p
            self._where[p.key] = node
        return node

    def adopt(self, pods: Sequence[Pod], solution, pools_with_types,
              existing: Optional[Sequence[ResidualNode]] = None) -> None:
        """Replace the retained fleet with a full Solution's (the drift
        backstop's adoption path; also usable by an external backstop
        that computed the full solve itself).

        A solution computed against an EXISTING fleet (live nodes +
        in-flight claims) is adopted by passing `existing`: the
        ResidualNode list aligned index-for-index with the
        ExistingNodeInput order the solve was encoded with. Each
        existing assignment folds its pods (and their usage) into the
        matching residual node, and the retained fleet becomes
        existing + new — the extension past the original fresh-fleets
        guard that lets the pipeline model the live operator's fleet."""
        if solution.existing and existing is None:
            raise ValueError(
                "solution assigns pods to existing nodes; pass the "
                "ResidualNode list aligned with the solve's "
                "ExistingNodeInput order"
            )
        # an externally-computed adoption invalidates the cached dual
        # certificate (its catalog may differ); _full_tick re-derives
        # it right after from its own encode
        self._dual = None
        self._fleet = []
        self._where = {}
        self._pods = {p.key: p for p in pods}
        if existing is not None:
            for node in existing:
                self._fleet.append(node)
                for key, pod in node.pods.items():
                    self._where[key] = node
                    self._pods.setdefault(key, pod)
            for a in solution.existing:
                node = existing[a.existing_index]
                for p in a.pods:
                    node.pods[p.key] = p
                    self._where[p.key] = node
                node.used = resutil.merge(
                    node.used, resutil.requests_for_pods(a.pods)
                )
        for plan in solution.new_nodes:
            node = self._node_from_plan(plan)
            if node is not None:
                self._fleet.append(node)
        self._unplaced = {p.key for p in solution.unschedulable}
        self._catalog_fp = catalog_fingerprint(pools_with_types)

    def state_fingerprint(self) -> str:
        """Stable identity of the retained fleet: what a self-audit
        (or a restart-convergence test) compares before trusting the
        cache. Name-insensitive for NEW nodes (inc-N names are
        process-local) but exact on the capacity ledger."""
        import hashlib

        if self._fleet is None:
            return ""
        rows = sorted(
            (
                node.pool.metadata.name,
                node.instance_type.name if node.instance_type else "",
                round(node.price, 6),
                tuple(sorted(node.pods)),
                tuple(sorted((k, round(v, 6)) for k, v in node.used.items())),
            )
            for node in self._fleet
        )
        return hashlib.sha256(repr(rows).encode()).hexdigest()

    # -- solving --------------------------------------------------------------

    def solve_tick(
        self,
        pods: Sequence[Pod],
        pools_with_types,
        objective: str = "cost",
        delta: Optional[tuple[Sequence[Pod], Sequence[str]]] = None,
    ) -> TickResult:
        """One tick. `delta=(added_pods, removed_keys)` lets an
        event-driven caller (watch stream / dirty tracker) skip the
        O(pods) reconciliation scan — the delta is TRUSTED to be the
        exact diff against the previous tick's pod set; `pods` must
        still be the full population (the full-solve backstops need
        it). Without `delta`, the diff is derived by scanning `pods`
        against the retained assignment (object identity + any
        dirty-tracker/mark_dirty keys as the change signal)."""
        self._tick += 1
        dirty = self._marked
        self._marked = set()
        if self._tracker is not None:
            dirty = dirty | self._tracker.drain("Pod")

        if self._fleet is None:
            return self._full_tick(pods, pools_with_types, objective, "cold")
        if self._catalog_fp != catalog_fingerprint(pools_with_types):
            return self._full_tick(
                pods, pools_with_types, objective, "catalog"
            )

        if delta is not None:
            added_pods, removed_keys = delta
            removed = [k for k in removed_keys if k in self._pods]
            # a deleted pod's DELETED event also lands in the dirty
            # set — it must not resurrect as a changed pod
            removed_set = set(removed)
            changed_keys: list[str] = [
                k for k in dirty
                if k in self._pods and k not in removed_set
            ]
            place_new = list(added_pods)
            n_after = len(self._pods) - len(removed) + len(place_new)
        else:
            cur: dict[str, Pod] = {p.key: p for p in pods}
            removed = [k for k in self._pods if k not in cur]
            place_new = [p for k, p in cur.items() if k not in self._pods]
            changed_keys = [
                k for k, p in cur.items()
                if k in self._pods and (k in dirty or self._pods[k] is not p)
            ]
            # pods that silently vanished from `cur` while unplaced
            self._unplaced = {k for k in self._unplaced if k in cur}
            n_after = len(cur)

        churn = (
            len(removed) + len(place_new) + len(changed_keys)
        ) / max(1, n_after)
        if churn > self.churn_max:
            return self._full_tick(
                pods, pools_with_types, objective, "churn", churn=churn
            )

        if delta is not None:
            if changed_keys:
                # dirty keys need the CURRENT objects: watch streams
                # deliver fresh Pod objects on MODIFIED, so the stored
                # ones may carry the pre-mutation spec. The O(pods)
                # lookup build is paid only on ticks that actually saw
                # in-place mutations.
                current = {p.key: p for p in pods}
                changed_pods = [
                    current.get(k, self._pods[k]) for k in changed_keys
                ]
            else:
                changed_pods = []
        else:
            changed_pods = [cur[k] for k in changed_keys]
        result = self._incremental_tick(
            pools_with_types, removed, changed_keys, changed_pods,
            place_new, churn,
        )
        if self.full_every > 0 and self._tick % self.full_every == 0:
            return self._drift_backstop(pods, pools_with_types, objective,
                                        result)
        SOLVER_INCREMENTAL_TICKS.inc(
            {"mode": "incremental", "reason": result.reason}
        )
        return result

    def _full_tick(
        self, pods, pools_with_types, objective, reason, churn=0.0
    ) -> TickResult:
        from karpenter_tpu_torch.solver.encode import encode, group_pods
        from karpenter_tpu_torch.solver.solver import solve_encoded

        # encode here (instead of delegating to solve()) so the full
        # problem's Encoded is in hand: the dual certificate the
        # residual repack spends is derived from it, and under the
        # cost objective the LP was already solved for this very
        # fingerprint (maybe_solve is a cache hit)
        groups = group_pods(pods)
        enc = encode(
            groups, pools_with_types, (),
            self.daemon_overhead or None,
            compat_cache=self.cache,
        )
        sol = solve_encoded(enc, objective=objective, device=self.device)
        self.adopt(pods, sol, pools_with_types)
        self._refresh_dual(enc)
        SOLVER_INCREMENTAL_TICKS.inc({"mode": "full", "reason": reason})
        return TickResult(
            mode="full",
            reason=reason,
            scheduled=len(pods) - len(sol.unschedulable),
            unschedulable=len(sol.unschedulable),
            fleet_price=self.fleet_price,
            nodes=len(self._fleet),
            churn=churn,
            placed=len(pods),
        )

    def _refresh_dual(self, enc) -> None:
        """Rebuild the cached dual certificate from one full solve's
        encode (see _DualFloor). Degrades to None — the repack then
        runs exactly the unguided path."""
        self._dual = None
        if not (
            _env_on("KARPENTER_INCR_DUAL_RANK")
            or _env_on("KARPENTER_INCR_DUAL_FLOOR")
        ):
            return
        self._dual = build_dual_floor(enc, device=self.device)

    def _repack_solve(self, enc):
        """One residual repack solve, dual-rank-guided when the cached
        certificate applies: the unguided pack runs first; only when
        it OPENS fresh nodes (the one case ordering can matter — the
        steady churn tick that lands every pod in freed slots pays
        nothing) is the reduced-cost-ordered arm raced, and the
        cheaper fleet kept (ties keep unguided). Decode prices are
        the true catalog prices on both arms (price_hint contract)."""
        from karpenter_tpu_torch.metrics.store import SOLVER_INCREMENTAL_DUAL
        from karpenter_tpu_torch.solver.solver import solve_encoded

        sol = solve_encoded(enc, objective=self.repack_objective,
                            device=self.device)
        dual = self._dual
        if (
            dual is None
            or not sol.new_nodes
            or not _env_on("KARPENTER_INCR_DUAL_RANK")
            or self.repack_objective == "cost"  # has its own race
        ):
            return sol
        # race only when the repack's fresh-open SPEND is a real
        # fraction of the fleet (KARPENTER_INCR_DUAL_RANK_MIN,
        # default 2%): the steady churn tick that opens a node or two
        # has pennies of ordering headroom but would pay a second
        # kernel dispatch (and its fresh-axis regrow/compile churn)
        # every tick — the race engages on the scale-out bursts where
        # LP-efficient type selection actually moves the bill
        spend = sum(float(p.price) for p in sol.new_nodes)
        floor_frac = _env_float("KARPENTER_INCR_DUAL_RANK_MIN", 0.02)
        if spend < floor_frac * max(self.fleet_price, 1e-9):
            return sol
        launch = enc.cfg_pool >= 0
        if int(launch.sum()) != dual.n_launch:
            return sol
        hint = enc.cfg_price.astype(np.float32).copy()
        hint[: dual.n_launch] = dual.rank_launch
        guided = solve_encoded(
            enc, objective=self.repack_objective, device=self.device,
            price_hint=hint,
        )

        def key(s):
            return (
                len(s.unschedulable),
                round(sum(float(p.price) for p in s.new_nodes), 9),
                len(s.new_nodes),
            )

        if key(guided) < key(sol):
            SOLVER_INCREMENTAL_DUAL.inc({"outcome": "rank_win"})
            return guided
        SOLVER_INCREMENTAL_DUAL.inc({"outcome": "rank_loss"})
        return sol

    def _incremental_tick(
        self, pools_with_types, removed, changed_keys, changed_pods,
        place_new, churn,
    ) -> TickResult:
        from karpenter_tpu_torch.solver.encode import encode, group_pods

        # free capacity held by deleted/changed pods
        for key in list(removed) + list(changed_keys):
            node = self._where.pop(key, None)
            if node is not None:
                pod = node.pods.pop(key)
                node.used = resutil.positive(
                    resutil.subtract(node.used, resutil.pod_requests(pod))
                )
            else:
                self._unplaced.discard(key)
        for key in removed:
            self._pods.pop(key, None)
        # emptied nodes are released (their price comes off the fleet)
        if any(not n.pods for n in self._fleet):
            self._fleet = [n for n in self._fleet if n.pods]

        # place: new pods, changed pods (now freed), then the retry
        # backlog of previously-unplaced pods — de-duped by key
        retry = [
            self._pods[k] for k in sorted(self._unplaced)
            if k in self._pods
        ]
        seen: set[str] = set()
        place: list[Pod] = []
        for p in list(place_new) + list(changed_pods) + retry:
            if p.key not in seen:
                seen.add(p.key)
                place.append(p)
        for p in place_new:
            self._pods[p.key] = p
        for p in changed_pods:
            self._pods[p.key] = p

        placed_total = len(place)
        new_unplaced: set[str] = set()
        rounds = 0
        while place and rounds < 8:
            rounds += 1
            groups = group_pods(place)
            # Residual prune (exact): a node whose available capacity
            # is below the componentwise MINIMUM request over the
            # groups being placed can hold none of them now — and
            # nodes only get fuller during a solve, so its capacity
            # row would be zero at every step. Dropping it shrinks the
            # bound axis from the whole fleet to the nodes with real
            # headroom (most of a packed fleet is full) without
            # changing the FFD outcome: first-feasible order over the
            # survivors is first-feasible order over all. Only keys
            # EVERY group requests (>0) can prune — a group that
            # doesn't request a key imposes no floor on it, so its
            # componentwise minimum is 0 and the key must drop out
            # (e.g. a CPU-only pod must still see GPU-less nodes when
            # a GPU pod shares the tick).
            min_req: dict[str, float] = {}
            req_counts: dict[str, int] = {}
            for g in groups:
                for k, v in g.resources.items():
                    if v <= 0:
                        continue
                    req_counts[k] = req_counts.get(k, 0) + 1
                    have = min_req.get(k)
                    min_req[k] = v if have is None else min(have, v)
            min_req = {
                k: v for k, v in min_req.items()
                if req_counts[k] == len(groups)
            }
            inputs = []
            order: list[ResidualNode] = []
            for node in self._fleet:
                avail = node.available()
                # float32-scale margin, same as the live tick's prune:
                # a boundary-exact fill reads "full" in float64 but
                # exactly-fitting in the kernel's float32 — never drop
                # a node the kernel could still use
                if any(
                    avail.get(k, 0.0) < v * (1.0 - 1e-6)
                    for k, v in min_req.items()
                ):
                    continue
                inputs.append(
                    ExistingNodeInput(
                        name=node.name,
                        requirements=node.requirements,
                        taints=node.taints,
                        available=avail,
                        pool_name=node.pool.metadata.name,
                        pod_count=len(node.pods),
                    )
                )
                order.append(node)
            enc = encode(
                groups, pools_with_types, inputs,
                daemon_overhead=self.daemon_overhead or None,
                compat_cache=self.cache,
            )
            # rides the wavefront routing at the _solve_packing seam:
            # a churn-burst tick whose residual demand spans many group
            # signatures commits them in batched rounds, while the
            # typical small tick (few signatures) stays on the
            # sequential kernel via pack.WAVEFRONT_MIN_GROUPS.
            # Dual-rank-guided when fresh nodes open.
            sol = self._repack_solve(enc)
            for a in sol.existing:
                node = order[a.existing_index]
                for p in a.pods:
                    node.pods[p.key] = p
                    self._where[p.key] = node
                node.used = resutil.merge(
                    node.used, resutil.requests_for_pods(a.pods)
                )
            for plan in sol.new_nodes:
                node = self._node_from_plan(plan)
                if node is not None:
                    self._fleet.append(node)
            evicted_keys = {p.key for p in sol.evicted}
            new_unplaced.update(
                p.key for p in sol.unschedulable
                if p.key not in evicted_keys
            )
            # k-way-evicted pods are schedulable alone; retry them
            # against the now-updated residual fleet (bounded)
            place = list(sol.evicted)
        new_unplaced.update(p.key for p in place)  # retry bound hit
        self._unplaced = new_unplaced

        return TickResult(
            mode="incremental",
            reason="steady",
            scheduled=len(self._pods) - len(self._unplaced),
            unschedulable=len(self._unplaced),
            fleet_price=self.fleet_price,
            nodes=len(self._fleet),
            churn=churn,
            placed=placed_total,
        )

    def _drift_backstop(
        self, pods, pools_with_types, objective, result: TickResult
    ) -> TickResult:
        """Periodic correctness backstop: run the full solve and
        compare. The incremental fleet survives only while it prices
        within drift_eps of (or beats) the full re-solve AND places
        exactly as many pods; otherwise the full solution is adopted.

        Weak-duality short-circuit: with every pod placed
        and the retained fleet priced within drift_eps of the cached
        LP floor for the CURRENT demand, no full re-solve can beat it
        by more than epsilon — drift <= fleet/bound - 1 <= drift_eps
        and placed_fewer is impossible — so the backstop's adoption
        decision is already known and the O(pods) solve is skipped
        (decision-identical by construction; the floor is the
        float64-certified dual bound, conservative for new demand
        because unknown group signatures price at zero)."""
        from karpenter_tpu_torch.solver.encode import group_pods
        from karpenter_tpu_torch.solver.solver import solve

        if (
            self._dual is not None
            and not self._unplaced
            and _env_on("KARPENTER_INCR_DUAL_FLOOR")
            and result.unschedulable == 0
        ):
            bound = self._dual.bound_for(group_pods(pods))
            if bound > 0 and result.fleet_price <= bound * (
                1.0 + self.drift_eps
            ):
                from karpenter_tpu_torch.metrics.store import (
                    SOLVER_INCREMENTAL_DUAL,
                )

                SOLVER_INCREMENTAL_DUAL.inc({"outcome": "floor_skip"})
                SOLVER_INCREMENTAL_TICKS.inc(
                    {"mode": "incremental", "reason": "dual_floor"}
                )
                result.reason = "dual_floor"
                # upper bound on true drift (the full solve prices
                # somewhere in [bound, fleet_price])
                result.drift = (
                    result.fleet_price / bound - 1.0 if bound > 0 else 0.0
                )
                return result

        sol = solve(
            pods, pools_with_types,
            daemon_overhead=self.daemon_overhead or None,
            objective=objective, device=self.device,
            compat_cache=self.cache,
        )
        full_price = float(sol.total_price)
        drift = (
            (result.fleet_price - full_price) / full_price
            if full_price > 0 else 0.0
        )
        # Adoption must never trade placed pods away: the incremental
        # path retries k-way-evicted pods against the updated residual
        # fleet, so it can legitimately place MORE pods than the
        # single-shot full solve — keep that fleet regardless of
        # price. Adopt only when the full solve places at least as
        # many pods AND (the incremental fleet placed fewer, or its
        # price drifted past epsilon).
        placed_fewer = result.unschedulable > len(sol.unschedulable)
        placed_more = result.unschedulable < len(sol.unschedulable)
        if placed_fewer or (drift > self.drift_eps and not placed_more):
            self.adopt(pods, sol, pools_with_types)
            SOLVER_INCREMENTAL_TICKS.inc({"mode": "full", "reason": "drift"})
            return TickResult(
                mode="full",
                reason="drift",
                scheduled=len(pods) - len(sol.unschedulable),
                unschedulable=len(sol.unschedulable),
                fleet_price=self.fleet_price,
                nodes=len(self._fleet),
                churn=result.churn,
                placed=result.placed,
                drift=drift,
            )
        SOLVER_INCREMENTAL_TICKS.inc(
            {"mode": "incremental", "reason": "checked"}
        )
        result.reason = "checked"
        result.drift = drift
        return result
