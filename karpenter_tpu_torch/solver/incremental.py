"""Encoder cache shared across provisioning rounds.

Copy of the first part of `karpenter_tpu/solver/incremental.py`:
`catalog_fingerprint` and `EncodedCache`, which `encode(...,
compat_cache=)` reads, with its imports pointed into
`karpenter_tpu_torch`. The residual repack (`IncrementalPipeline`) and
the provisioner's incremental tick that drives it come with ROADMAP
item 5b.

A steady-state round whose pod shapes mostly repeat pays the G x C
requirement evaluation only for the group signatures it has not seen
under the current catalog; the launchable config columns and their
arrays are cached per catalog fingerprint. Every cached row is exactly
what a fresh encode would compute; the cache's own tables are
lock-guarded.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.metrics.store import SOLVER_ENCODE_CACHE
from karpenter_tpu_torch.scheduling.requirement import IN
from karpenter_tpu_torch.solver.encode import (
    ConfigInfo,
    PodGroup,
    _full_compat,
    launch_configs,
    pseudo_configs,
)


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
