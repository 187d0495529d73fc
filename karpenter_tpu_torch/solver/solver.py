"""Solver facade: pending pods -> per-node placements, on the GPU.

The `scheduling.Solver` seam of the JAX package
(`karpenter_tpu/solver/solver.py`): `solve()` takes pods, pools with
their instance types and existing nodes, encodes them on the host,
packs them with the CUDA kernels (`solver/pack_split.py`) and decodes
node plans. The first-fit-decreasing objective ("ffd") packs once; the
cost objective ("cost") races plain FFD against packs seeded with the
column-generation plan (`solver/lp_plan.py`, kernel B4) and, with dual
guidance, ranked by the device LP's duals (`solver/lp_device.py`,
kernel B5), then improves the cheapest fleet.

Every packing solve goes through the resilience ladder
(`solver/resilience.py`): the sharded and single-device kernels under
circuit breakers and the optional deadlines, then the host FFD oracle,
each degradation reported (`resilience.pop_degraded`, the ladder's
counters and spans). `backend="host"` (or KARPENTER_SOLVER_BACKEND=host)
asks for the host oracle alone.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, which runs the kernels' plain versions) or for the host
backend. With no CUDA device, `device=None` raises: there is no silent
CPU fallback, and the ladder's host rung never stands in for a missing
card.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics import sentinel
from karpenter_tpu_torch.metrics.store import SOLVER_PHASE_DURATION
from karpenter_tpu_torch.solver import lp_device, lp_plan, pack, resilience
from karpenter_tpu_torch.solver.encode import (
    Encoded,
    ExistingNodeInput,
    encode,
    group_pods,
)


class NodePlan:
    """One planned (new) node.

    `instance_types` (price-ordered options) and `offerings` (feasible,
    cheapest first) materialize lazily from the solver's config mask:
    a 50k-pod solve plans thousands of nodes but only the ones that
    become NodeClaims ever need their full option lists expanded."""

    def __init__(
        self,
        pool: NodePool,
        instance_types: Optional[list[InstanceType]] = None,
        offerings: Optional[list[Offering]] = None,
        pods: Optional[list[Pod]] = None,
        price: float = 0.0,
        claim_name: str = "",
        lazy=None,
        lazy_primary=None,
    ):
        self.pool = pool
        self._instance_types = instance_types
        self._offerings = offerings
        self._lazy = lazy
        self._lazy_primary = lazy_primary
        self.pods: list[Pod] = pods if pods is not None else []
        self.price = price
        # the NodeClaim created from this plan (provisioning/provisioner.py)
        self.claim_name = claim_name
        # set when the BestEffort minValues policy relaxed the floor
        # (scheduler.go:649-658 / min-values-relaxed annotation)
        self.min_values_relaxed = False
        # reservation id this node resolves onto (its cheapest feasible
        # offering is reserved)
        self.reservation_id = ""

    def _materialize(self) -> None:
        its, offs = self._lazy()
        if self._instance_types is None:
            self._instance_types = its
        if self._offerings is None:
            self._offerings = offs
        self._lazy = None

    @property
    def instance_types(self) -> list[InstanceType]:
        if self._instance_types is None and self._lazy is not None:
            self._materialize()
        return self._instance_types if self._instance_types is not None else []

    @instance_types.setter
    def instance_types(self, value: list[InstanceType]) -> None:
        self._instance_types = value

    @property
    def offerings(self) -> list[Offering]:
        if self._offerings is None and self._lazy is not None:
            self._materialize()
        return self._offerings if self._offerings is not None else []

    @offerings.setter
    def offerings(self, value: list[Offering]) -> None:
        self._offerings = value

    def primary(self) -> tuple[Optional[InstanceType], Optional[Offering]]:
        """The resolved (cheapest) launch option without materializing
        the full option lists."""
        if (
            self._lazy_primary is not None
            and self._instance_types is None
            and self._offerings is None
        ):
            return self._lazy_primary()
        its, offs = self.instance_types, self.offerings
        return (its[0] if its else None), (offs[0] if offs else None)


@dataclass
class ExistingAssignment:
    existing_index: int
    pods: list[Pod] = field(default_factory=list)


@dataclass
class Solution:
    new_nodes: list[NodePlan]
    existing: list[ExistingAssignment]
    unschedulable: list[Pod]
    # subset of `unschedulable` displaced by the decode-time k-way
    # requirement check (not kernel-infeasible)
    evicted: list[Pod] = field(default_factory=list)
    # cost-objective solves attach the planner's and the device LP's
    # bounds: {"guided", "trim_saved", "lower_bound", "estimate",
    # "device_bound", ...}
    lp: Optional[dict] = None

    @property
    def total_price(self) -> float:
        return sum(n.price for n in self.new_nodes)


def resolve_device(device=None) -> torch.device:
    """`None` means the card. With no CUDA device present that is an
    error, never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "karpenter_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def _backend() -> str:
    """KARPENTER_SOLVER_BACKEND as the JAX package reads it: `host`
    selects the host oracle; `jax`, `device` or unset mean the card."""
    return os.environ.get("KARPENTER_SOLVER_BACKEND", "jax")


def _check_supported(objective: str, backend: Optional[str]) -> str:
    """The backend the solve runs on, "host" or "device"."""
    if objective not in ("ffd", "cost"):
        raise ValueError(f"unknown objective {objective!r}")
    backend = backend or _backend()
    if backend not in ("host", "device", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    return "host" if backend == "host" else "device"


def solve(
    pods: Sequence[Pod],
    pools_with_types: Sequence[tuple[NodePool, Sequence[InstanceType]]],
    existing: Sequence[ExistingNodeInput] = (),
    daemon_overhead: Optional[dict[str, dict[str, float]]] = None,
    objective: str = "ffd",
    device=None,
    backend: Optional[str] = None,
    shards: int = 0,
    required_only: bool = False,
    compat_cache=None,
) -> Solution:
    """Pack `pods` onto `existing` nodes and new nodes from the pools.
    `device=None` runs on the card (and raises without one); the host
    backend runs no device. `required_only` groups pods on their
    required terms alone (the relaxation ladder's retry);
    `compat_cache` (solver/incremental.EncodedCache) memoizes the
    launchable config columns and compat rows across solves."""
    if _check_supported(objective, backend) == "device":
        device = resolve_device(device)
    groups = group_pods(pods, required_only=required_only)
    enc = encode(groups, pools_with_types, existing, daemon_overhead,
                 compat_cache=compat_cache)
    return solve_encoded(enc, objective=objective, device=device,
                         backend=backend, shards=shards)


def solve_encoded(
    enc: Encoded, objective: str = "ffd", device=None,
    price_hint: Optional[np.ndarray] = None, backend: Optional[str] = None,
    shards: int = 0,
) -> Solution:
    """`price_hint`: an alternative [C] price vector fed to the packing
    kernel as its type-preference ordering; decode always prices nodes
    from the true `enc.cfg_price`. `shards > 1` splits every pack's
    config axis over a mesh of that many shards (`pack.solve_packing`);
    the result is identical to the unsharded solve's. The device LP
    stays unsharded unless KARPENTER_LP_SHARDS is set, so the race's
    arms see the same duals at any shard count. The host backend
    (`backend="host"` or KARPENTER_SOLVER_BACKEND=host) decodes the
    host FFD oracle and ignores `objective`, `device`, `price_hint` and
    `shards`, as the JAX package's does."""
    host = _check_supported(objective, backend) == "host"
    dev = None if host else resolve_device(device)
    G, C = enc.compat.shape
    if G == 0 or C == 0:
        return Solution(
            new_nodes=[],
            existing=[],
            unschedulable=[p for g in enc.groups for p in g.pods],
        )
    if host:
        return _decode_host(enc)
    return _decode_device(enc, objective, dev, price_hint=price_hint, shards=shards)


def _solve_packing(enc: Encoded, mode: str, device: torch.device,
                   plan=None, shards: int = 0) -> pack.PackResult:
    """The solver seam, routed through the resilience ladder
    (`resilience.shared().solve_packing`): the sharded and single-device
    kernels under their circuit breakers and the optional deadlines and
    hedge, then the host FFD oracle. A rung other than the first that
    serves a call is reported as degraded; on a CUDA device only an
    injected fault or a deadline degrades, any other failure is raised
    (`resilience.may_degrade`).
    Everything stacked on this seam (the cost race's arms, the split
    solves) inherits the ladder."""
    return resilience.shared().solve_packing(
        enc, mode=mode, plan=plan, shards=shards, device=device)


def _solve_packing_async(enc: Encoded, mode: str, device: torch.device,
                         plan=None, shards: int = 0):
    """Dispatch a solve without blocking, with the same ladder guarding
    the fetch (`resilience.shared().solve_packing_async`): a healthy
    device solve is launched here and the card computes while the host
    keeps working; deadline-budgeted or degraded solves run on a worker.
    Returns an object whose `result()` is the PackResult."""
    return resilience.shared().solve_packing_async(
        enc, mode=mode, plan=plan, shards=shards, device=device)


def _decode_device(
    enc: Encoded, objective: str, device: torch.device,
    price_hint: Optional[np.ndarray] = None, shards: int = 0,
) -> Solution:
    if objective == "cost":
        return _decode_cost(enc, device, shards)
    kernel_enc = enc
    if price_hint is not None:
        kernel_enc = replace(enc, cfg_price=np.asarray(price_hint, np.float32))
    result = _solve_packing(kernel_enc, mode=objective, device=device, shards=shards)
    return _build_solution_arrays(
        enc,
        np.flatnonzero(result.node_active[: result.node_count]),
        result.node_mask,
        result.assign,
        result.unschedulable,
    )


# ---------------------------------------------------------------- cost


# last FFD race key per problem fingerprint: (unschedulable, fleet
# price, active node count), the full key, so the steady-state skip
# reproduces min()'s tiebreaks (oldest evicted at 32 entries)
_ffd_floor: dict[bytes, tuple[int, float, int]] = {}
# which cost arm won the last cold race per fingerprint ("cost" | "rank")
_warm_arm: dict[bytes, str] = {}
# column-generation plan per problem fingerprint (oldest evicted at 4)
_plan_cache: dict[bytes, object] = {}


def reset_caches() -> None:
    """Test hook: forget the race floors, winning arms and plans, and
    the planner's and the device LP's own caches."""
    _ffd_floor.clear()
    _warm_arm.clear()
    _plan_cache.clear()
    lp_plan.reset()
    lp_device.reset()


def _decode_cost(enc: Encoded, device: torch.device, shards: int = 0) -> Solution:
    """Cost objective: the LP-planned pack raced against plain FFD; the
    cheaper fleet wins (fewer unschedulable pods first), so FFD is a
    floor. With dual guidance (KARPENTER_LP_GUIDE) the device LP adds a
    third arm on the first solve of a problem, the planned pack ranked
    by the duals' reduced costs, and the duals drive the trim of the
    winner. Warm solves of the same problem re-run only the winning
    arm while it strictly beats the recorded FFD floor.

    The cold race is a pipeline around one card, in the JAX package's
    order: dispatch FFD, run column generation (`_plan_for`) on the
    host while FFD's kernels run, dispatch the cost arm and the rank
    arm, then fetch FFD, cost and rank in that order. Every launch goes
    to the current stream, so the card runs the arms in dispatch order
    and only the host overlaps."""

    def key(item):
        # only nodes that hold pods count: pre-opened planned rows the
        # packer never filled are skipped by decode
        result, masks = item
        act = np.flatnonzero(
            result.node_active[: result.node_count]
            & (result.assign[: result.node_count].sum(axis=1) > 0)
        )
        prices = np.where(masks[act], enc.cfg_price[None, :], np.inf).min(axis=1)
        fleet = float(np.where(np.isfinite(prices), prices, 0.0).sum())
        return (int(result.unschedulable.sum()), fleet, len(act))

    fp = _race_fingerprint(enc)
    floor = _ffd_floor.get(fp)
    plan = None
    cost_tuple = None  # (result, masks, arm)
    # the LP does not inherit the packs' shard count (KARPENTER_LP_SHARDS
    # is its own opt-in), so its duals are the same at any shard count
    dlp = lp_device.maybe_solve(enc, device=device)

    def arm_enc(arm: str) -> Encoded:
        # the rank arm feeds the dual-adjusted ranking through the
        # kernel's price input; decode and keys read the true prices
        if arm == "rank" and dlp is not None:
            return replace(enc, cfg_price=lp_device.rank_prices(enc, dlp))
        return enc

    def guide_lam():
        if plan is not None and plan.duals is not None:
            return plan.duals
        return dlp.lam_guide if dlp is not None else None

    def lp_info(trim_saved: float):
        if plan is None and dlp is None:
            return None
        info: dict = {"guided": dlp is not None,
                      "trim_saved": round(float(trim_saved), 6)}
        if plan is not None:
            info["lower_bound"] = plan.lower_bound
            info["estimate"] = plan.objective_estimate
        if dlp is not None:
            info["device_bound"] = dlp.lower_bound
            info["device_wall_s"] = round(dlp.wall_s, 6)
            info["device_iterations"] = dlp.iterations
            info["device_converged"] = dlp.converged
            info.setdefault("lower_bound", dlp.lower_bound)
        return info

    def finish(result, masks) -> Solution:
        trim_saved = _finish_winner(enc, result, masks, guide_lam())
        solution = _build_solution_arrays(
            enc,
            np.flatnonzero(result.node_active[: result.node_count]),
            masks,
            result.assign,
            result.unschedulable,
        )
        solution.lp = lp_info(trim_saved)
        return solution

    if floor is not None:
        plan = _plan_for(fp, enc, device)
        if plan is not None:
            arm = _warm_arm.get(fp, "cost")
            cost_result = _solve_packing(arm_enc(arm), "cost", device, plan, shards)
            masks = _downsize_masks(enc, cost_result)
            cost_tuple = (cost_result, masks, arm)
            if key((cost_result, masks)) < floor:
                return finish(cost_result, masks)
        # the planned pack is missing or not strictly better than the
        # recorded floor: race, reusing the plan and the cost pack

    ffd_pending = _solve_packing_async(enc, "ffd", device, shards=shards)
    if plan is None:
        plan = _plan_for(fp, enc, device)
    pendings = []
    if plan is not None and cost_tuple is None:
        arms = ["cost"]
        if dlp is not None and lp_device.rank_beta() > 0:
            # the ranked arm joins the cold race only
            arms.append("rank")
        for arm in arms:
            pendings.append(
                (arm, _solve_packing_async(arm_enc(arm), "cost", device, plan, shards)))
    ffd_result = ffd_pending.result()
    candidates = [(ffd_result, _downsize_masks(enc, ffd_result), "ffd")]
    if cost_tuple is not None:
        candidates.append(cost_tuple)
    for arm, pending in pendings:
        arm_result = pending.result()
        candidates.append((arm_result, _downsize_masks(enc, arm_result), arm))

    if len(_ffd_floor) >= 32:
        _ffd_floor.pop(next(iter(_ffd_floor)))
    _ffd_floor[fp] = key(candidates[0][:2])

    result, masks, won = min(candidates, key=lambda it: key(it[:2]))
    if len(_warm_arm) >= 32:
        _warm_arm.pop(next(iter(_warm_arm)))
    _warm_arm[fp] = won if won in ("cost", "rank") else "cost"
    # improvement passes on the winner only, after the race keys and
    # the recorded floor
    return finish(result, masks)


def _plan_for(fp: bytes, enc: Encoded, device: torch.device):
    if fp in _plan_cache:
        return _plan_cache[fp]
    plan = lp_plan.plan(enc, device=device)
    # a FleetPlan carries planned_quota [Np, G]: keep the working set
    if len(_plan_cache) >= 4:
        _plan_cache.pop(next(iter(_plan_cache)))
    _plan_cache[fp] = plan
    return plan


def _race_fingerprint(enc: Encoded) -> bytes:
    """Digest of everything the FFD pack's outcome depends on, plus the
    dual-guidance configuration, so guided and unguided runs of the
    same problem never serve each other's floors or plans."""
    h = hashlib.blake2b(digest_size=16)
    h.update(
        (
            f"g{int(lp_device.enabled())}|b{lp_device.rank_beta()}"
            f"|i{lp_device.iters()}|t{_trim_budget()}"
            f"|p{os.environ.get('KARPENTER_LP_PRIORITY_WEIGHT', '')}"
        ).encode()
    )
    for buf in (
        enc.group_count, enc.group_req, enc.cfg_price, enc.cfg_alloc,
        np.ascontiguousarray(enc.compat), enc.cfg_pool,
        enc.pool_overhead, enc.existing_used,
    ):
        h.update(np.ascontiguousarray(buf).tobytes())
    for opt in (
        enc.cfg_rsv, enc.rsv_cap, enc.group_cap, enc.conflict,
        enc.existing_quota, enc.loose_groups, enc.group_priority,
    ):
        h.update(
            b"\x00" if opt is None
            else np.ascontiguousarray(opt).tobytes()
        )
    h.update(enc.n_existing.to_bytes(4, "little"))
    return h.digest()


def _merge_budget_pairs() -> int:
    """Work budget (pair feasibility checks) of the post-pack merge; a
    work budget, not a deadline, so identical inputs give identical
    fleets. 0 disables."""
    return int(os.environ.get("KARPENTER_MERGE_BUDGET", "12000"))


def _trim_budget() -> int:
    """Receiver-feasibility checks the dual-guided trim may spend per
    solve (a work budget, like the merge's)."""
    return int(os.environ.get("KARPENTER_LP_TRIM_BUDGET", "200000"))


def _uncapped_cols(enc: Encoded) -> np.ndarray:
    """[C] bool: columns not drawing on a capacity reservation."""
    return (
        enc.cfg_rsv < 0 if enc.cfg_rsv is not None
        else np.ones(len(enc.configs), bool)
    )


def _fresh_uncapped_cols(enc: Encoded, masks: np.ndarray, ni: int,
                         uncapped: np.ndarray):
    """The eligibility gate of the mask post-passes: a node is
    resizable only if it is fresh (not an existing node) and its mask
    touches no reservation-capped column. Returns the mask's columns,
    or None if the node is off-limits."""
    cols = np.flatnonzero(masks[ni])
    if cols.size == 0:
        return None
    if enc.configs[cols[0]].existing_index >= 0:
        return None
    if not uncapped[cols].all():
        return None
    return cols


def _merge_underfilled(enc: Encoded, result, masks: np.ndarray) -> None:
    """Host-side improvement pass on a finished cost pack: greedily
    merge pairs of FRESH nodes when one machine that holds both loads
    is cheaper than the two they would launch as. FFD fragmentation
    under selector/taint-split demand leaves tails of underfilled
    nodes; the LP cannot see them (its patterns are per-class optimal
    but integrality strands remainders). Mutates `result` and `masks`
    in place.

    Feasibility comes straight from the DOWNSIZED masks: downsize
    widens each fresh node's mask to every same-pool config that is
    compatible with all residents AND fits its current load — any
    config fitting the merged load fits both current loads, so
    mask_i & mask_j & fits(combined) is EXACTLY the merged node's
    valid launch set (compat, pool and reservation rules included).
    Additional guards: no loose-group residents (k-way legality is
    re-judged at decode), per-node group caps, pairwise group
    conflicts, pool daemon overhead counted once."""
    n = result.node_count
    if n == 0:
        return
    active = result.node_active[:n] & (result.assign[:n].sum(axis=1) > 0)
    uncapped = _uncapped_cols(enc)
    cand: list[int] = []
    cand_pool: list[int] = []
    for ni in np.flatnonzero(active):
        cols = _fresh_uncapped_cols(enc, masks, ni, uncapped)
        if cols is None:
            continue
        if enc.loose_groups is not None and (
            enc.loose_groups & (result.assign[ni] > 0)
        ).any():
            continue
        pool = int(enc.cfg_pool[cols[0]])
        if enc.pool_min_values is not None and enc.pool_min_values[pool]:
            # a minValues pool: narrowing the mask could drop the
            # plan's type coverage below the floor and turn an
            # optional optimization into unschedulable pods
            continue
        # mergeable in principle: some masked config could hold about
        # twice this load (cheap prefilter; exact check is per-pair)
        pool = int(enc.cfg_pool[cols[0]])
        oh = enc.pool_overhead[pool]
        doubled = 2.0 * result.node_used[ni] - oh
        if not (enc.cfg_alloc[cols] + 1e-4 >= doubled[None, :]).all(
            axis=1
        ).any():
            continue
        cand.append(int(ni))
        cand_pool.append(pool)
    if len(cand) < 2:
        return
    pool_of = dict(zip(cand, cand_pool))
    order = sorted(cand, key=lambda x: float(result.node_used[x].sum()))
    caps = enc.group_cap
    conflict = enc.conflict
    # fast pair pruning: bit-packed masks for O(C/64) intersection
    # tests, plus a per-pool "largest machine" envelope so partners
    # whose combined load can't fit ANY config are skipped in one
    # vectorized sweep per anchor
    m = len(order)
    packed = np.packbits(masks[order], axis=1)
    used = result.node_used[np.array(order)]
    pools = np.array([pool_of[ni] for ni in order], np.int32)
    launch_cols = enc.cfg_pool >= 0
    pool_max: dict[int, np.ndarray] = {}
    for pool in np.unique(pools):
        pcols = launch_cols & (enc.cfg_pool == pool)
        pool_max[int(pool)] = enc.cfg_alloc[pcols].max(axis=0)
    alive = np.ones(m, bool)
    # current cheapest launch price per candidate (decode's choice),
    # maintained incrementally — recomputing it per pair would put two
    # full-C reductions on every probe
    p_cur = np.array([
        float(enc.cfg_price[masks[ni]].min()) for ni in order
    ])
    budget = _merge_budget_pairs()
    for a in range(m):
        if not alive[a] or budget <= 0:
            continue
        merged_any = True
        while merged_any:
            merged_any = False
            pool = int(pools[a])
            oh = enc.pool_overhead[pool]
            envelope = pool_max[pool] + oh
            quick = (
                alive
                & (pools == pools[a])
                & (
                    (used + used[a][None, :])
                    <= envelope[None, :] + 1e-4
                ).all(axis=1)
            )
            quick[a] = False
            # largest partner first: densest merged node
            for b in np.flatnonzero(quick)[::-1]:
                if budget <= 0:
                    break
                budget -= 1
                if not (packed[a] & packed[b]).any():
                    continue
                na, nb = order[a], order[b]
                shared = masks[na] & masks[nb]
                cols = np.flatnonzero(shared)
                combined = used[a] + used[b] - oh
                fits = (
                    enc.cfg_alloc[cols] + 1e-4 >= combined[None, :]
                ).all(axis=1)
                if not fits.any():
                    continue
                new_price = float(enc.cfg_price[cols[fits]].min())
                if new_price + 1e-9 >= p_cur[a] + p_cur[b]:
                    continue
                comb_assign = result.assign[na] + result.assign[nb]
                if caps is not None and (comb_assign > caps).any():
                    continue
                if conflict is not None:
                    gi = np.flatnonzero(result.assign[na] > 0)
                    gj = np.flatnonzero(result.assign[nb] > 0)
                    if conflict[np.ix_(gi, gj)].any():
                        continue
                # merge nb into na
                result.assign[na] = comb_assign
                result.node_used[na] = combined
                result.assign[nb] = 0
                result.node_active[nb] = False
                result.node_used[nb] = 0.0
                masks[nb] = False
                row = np.zeros_like(masks[na])
                row[cols[fits]] = True
                masks[na] = row
                used[a] = combined
                used[b] = 0.0
                p_cur[a] = new_price
                packed[a] = np.packbits(row)
                packed[b] = 0
                alive[b] = False
                merged_any = True
                break


def _trim_undervalued(enc: Encoded, result, masks: np.ndarray,
                      lam: np.ndarray, budget: int | None = None) -> float:
    """Dual-guided trim: empty the nodes the LP duals
    certify as BAD DEALS — price above the dual value of what they
    hold — by moving their pods into the rest of the fleet's headroom,
    then re-fit each donor onto the cheapest machine that still holds
    its remainder (or delete it outright). This is the integrality-gap
    closer: FFD remainders strand many slightly-underfilled machines
    whose pods fit in aggregate slack the prefix fill has already
    passed; the duals say exactly which nodes to attack
    (slack = price - lam.assign, largest first).

    Legality is re-proved per move from first principles — compat with
    the receiver's resolved config, capacity against its allocatable,
    pairwise group conflicts, per-node group caps — and receiver masks
    are narrowed to configs compatible with the incoming group that
    still fit, so decode semantics hold exactly. Nodes off-limits to
    the merge pass (existing, reservation-pinned, loose-group
    residents, minValues pools) are off-limits here for the same
    reasons. Every commit strictly lowers fleet price (receivers keep
    their resolved config by construction), so the pass can only
    improve the solution. Mutates `result`/`masks` in place; returns
    the price saved."""
    n = result.node_count
    if n == 0 or lam is None:
        return 0.0
    budget = _trim_budget() if budget is None else budget
    if budget <= 0:
        return 0.0
    active = result.node_active[:n] & (result.assign[:n].sum(axis=1) > 0)
    uncapped = _uncapped_cols(enc)
    launch = enc.cfg_pool >= 0
    loose = enc.loose_groups
    # vectorized candidate collection (the same eligibility the merge
    # pass applies per node, but in one sweep — a 50k-pod fleet has
    # thousands of active rows and this runs on every warm solve):
    # fresh (no pseudo-config column), reservation-uncapped mask, no
    # loose residents, not a minValues pool
    act_idx = np.flatnonzero(active)
    if act_idx.size < 2:
        return 0.0
    sub = masks[act_idx]
    pseudo = np.array(
        [cfg.existing_index >= 0 for cfg in enc.configs], dtype=bool
    )
    ok = (
        sub.any(axis=1)
        & ~(sub & pseudo[None, :]).any(axis=1)
        & ~(sub & ~uncapped[None, :]).any(axis=1)
    )
    if loose is not None:
        ok &= ~((result.assign[act_idx] > 0) & loose[None, :]).any(axis=1)
    price_mat = np.where(sub, enc.cfg_price[None, :], np.inf)
    pcol_all = price_mat.argmin(axis=1)
    if enc.pool_min_values is not None:
        ok &= ~enc.pool_min_values[enc.cfg_pool[pcol_all]]
    rows_a = act_idx[ok]
    if rows_a.size < 2:
        return 0.0
    rows = rows_a.tolist()
    m = len(rows)
    lam = np.asarray(lam, np.float64)
    req_all = enc.group_req.astype(np.float64)
    caps = enc.group_cap
    conflict = enc.conflict
    price = price_mat[ok].min(axis=1)
    pcol = pcol_all[ok]
    used = result.node_used[rows_a].astype(np.float64).copy()
    assign_rows = result.assign[rows_a].astype(np.int64).copy()
    alive = np.ones(m, bool)
    alloc_p = enc.cfg_alloc[pcol].astype(np.float64)  # [m, R]
    vals = assign_rows @ lam
    slack = price - vals
    donor_order = np.argsort(-slack, kind="stable")
    idx = np.arange(m)
    saved = 0.0
    for di in donor_order:
        if budget <= 0:
            break
        if not alive[di] or price[di] <= 0 or slack[di] <= 1e-9:
            continue
        pool = int(enc.cfg_pool[pcol[di]])
        gs = np.flatnonzero(assign_rows[di])
        if gs.size == 0:
            continue
        # plan the moves against a scratch copy; commit only if the
        # donor provably refits cheaper afterwards
        order_g = gs[np.argsort(-req_all[gs].sum(axis=1), kind="stable")]
        assign_d = assign_rows[di].copy()
        sim_used = used.copy()
        sim_assign = assign_rows  # reads only; adds tracked in moves
        moves: list[tuple[int, int, int]] = []
        for g in order_g:
            needed = int(assign_d[g])
            if needed == 0:
                continue
            req = req_all[g]
            reqpos = req > 0
            budget -= m
            elig = alive & (idx != di) & enc.compat[g, pcol]
            if conflict is not None and conflict[g].any():
                elig &= (sim_assign @ conflict[g].astype(np.int64)) == 0
            head = alloc_p - sim_used
            with np.errstate(divide="ignore", invalid="ignore"):
                kr = np.floor(
                    np.where(reqpos[None, :], (head + 1e-4) / np.where(
                        reqpos, req, 1.0
                    )[None, :], np.inf).min(axis=1)
                )
            kr = np.where(np.isfinite(kr), kr, 0.0)
            k = np.where(elig, np.clip(kr, 0, None), 0.0).astype(np.int64)
            if caps is not None:
                k = np.minimum(
                    k, np.clip(caps[g] - sim_assign[:, g], 0, None)
                )
            cum = np.cumsum(k)
            take = np.clip(needed - (cum - k), 0, k)
            hit = np.flatnonzero(take)
            for ri in hit:
                moves.append((int(ri), int(g), int(take[ri])))
                sim_used[ri] = sim_used[ri] + int(take[ri]) * req
            assign_d[g] = needed - int(take.sum())
        oh = enc.pool_overhead[pool].astype(np.float64)
        new_used = oh + assign_d @ req_all
        if assign_d.sum() == 0:
            new_price, new_mask = 0.0, None
        else:
            groups_on = np.flatnonzero(assign_d)
            fits = np.all(enc.cfg_alloc + 1e-4 >= new_used[None, :], axis=1)
            compat_all = enc.compat[groups_on].all(axis=0)
            ok = launch & (enc.cfg_pool == pool) & fits & compat_all & uncapped
            if not ok.any():
                continue
            new_price = float(enc.cfg_price[ok].min())
            new_mask = ok
        if new_price >= price[di] - 1e-9:
            continue
        # ---- commit
        d = rows[di]
        for ri, g, kk in moves:
            r0 = rows[ri]
            result.assign[r0, g] += kk
            assign_rows[ri, g] += kk
            add = kk * req_all[g]
            result.node_used[r0] = result.node_used[r0] + add
            used[ri] = used[ri] + add
            masks[r0] = masks[r0] & enc.compat[g] & np.all(
                enc.cfg_alloc + 1e-4 >= np.asarray(
                    result.node_used[r0], np.float64
                )[None, :],
                axis=1,
            )
        saved += price[di] - new_price
        if assign_d.sum() == 0:
            result.assign[d] = 0
            result.node_active[d] = False
            result.node_used[d] = 0.0
            masks[d] = False
            alive[di] = False
            assign_rows[di] = 0
            used[di] = 0.0
            price[di] = 0.0
        else:
            result.assign[d] = assign_d.astype(result.assign.dtype)
            result.node_used[d] = new_used
            masks[d] = new_mask
            assign_rows[di] = assign_d
            used[di] = new_used
            price[di] = new_price
            # the donor resolved onto a (smaller) config: later donors
            # may use it as a RECEIVER, so its capacity row must be
            # the new machine's, not the one it just shed
            new_pcol = int(
                np.flatnonzero(new_mask)[np.argmin(enc.cfg_price[new_mask])]
            )
            pcol[di] = new_pcol
            alloc_p[di] = enc.cfg_alloc[new_pcol].astype(np.float64)
    return saved


def _finish_winner(enc: Encoded, result, masks: np.ndarray,
                   lam: np.ndarray | None) -> float:
    """The improvement pipeline applied to the race winner AFTER the
    selection keys (and the recorded FFD floor) are computed: the
    pairwise merge, then — with dual guidance on — trim rounds
    interleaved with re-merges while they keep paying. Each stage only
    ever lowers fleet price, so the served solution is never worse
    than the raw race winner. Deterministic: round count depends only
    on the inputs (fleet size + what the rounds saved), never on the
    clock. Returns the trim savings."""
    _merge_underfilled(enc, result, masks)
    if lam is None or not lp_device.enabled():
        return 0.0
    saved = _trim_undervalued(enc, result, masks, lam)
    if saved <= 1e-12:
        return 0.0
    # follow-up rounds pay a full merge pass each; past a few hundred
    # candidates that merge dominates the steady-state wall (its pair
    # budget saturates ~130ms), so deep refinement is reserved for the
    # small-fleet shapes where it is nearly free — the first trim
    # round captures the bulk of the gap everywhere (measured: it
    # alone takes reserved_50k 6.5% -> 0.8%)
    n_active = int(
        (result.node_active[: result.node_count]
         & (result.assign[: result.node_count].sum(axis=1) > 0)).sum()
    )
    rounds = 2 if n_active <= 256 else 0
    for _ in range(rounds):
        _merge_underfilled(enc, result, masks)
        s = _trim_undervalued(enc, result, masks, lam)
        if s <= 1e-12:
            break
        saved += s
    return saved


def _downsize_masks(enc: Encoded, result) -> np.ndarray:
    """Re-widen each planned/fresh node's config mask to every same-pool
    config that fits its *final* fill, so decode can pick a smaller,
    cheaper machine for underfilled nodes. The kernel's mask only ever
    tightens during placement (reference semantics: the in-flight
    NodeClaim filters its instance-type options, nodeclaim.go:373-447);
    once placement is final, any config compatible with all resident
    pods and large enough is a valid — possibly cheaper — launch choice.
    """
    masks = result.node_mask.copy()
    launch = enc.cfg_pool >= 0
    uncapped = _uncapped_cols(enc)
    for ni in range(result.node_count):
        if not result.node_active[ni]:
            continue
        row = masks[ni]
        # fresh + reservation-uncapped only (a pinned node's pin is the
        # point: FinalizeScheduling, scheduling/nodeclaim.go:252)
        cols = _fresh_uncapped_cols(enc, masks, ni, uncapped)
        if cols is None:
            continue
        pool = enc.cfg_pool[cols[0]]
        groups_on = np.flatnonzero(result.assign[ni] > 0)
        if groups_on.size == 0:
            continue
        fits = np.all(
            enc.cfg_alloc + 1e-4 >= result.node_used[ni][None, :], axis=1
        )
        compat_all = enc.compat[groups_on].all(axis=0)
        # capacity-reservation columns only stay valid if the packer
        # already pinned this node to them — widening onto them would
        # overspend the reservation budget
        wide = (
            launch & (enc.cfg_pool == pool) & fits & compat_all
            & (uncapped | row)
        )
        if wide.any():
            # the kernel-validated columns stay in as a floor: they
            # provably hold the final fill, so numeric edge cases in
            # the re-widened fits check can never leave the node with
            # only configs smaller than its actual usage
            masks[ni] = wide | row
    return masks


def _decode_host(enc: Encoded) -> Solution:
    """The host backend: the ladder's host rung (`resilience.
    host_pack_result`, the FFD oracle `reference_ffd.solve_ffd_host`)
    decoded like a device result, so the two never drift apart."""
    res = resilience.host_pack_result(enc)
    return _build_solution_arrays(enc, np.arange(res.node_count), res.node_mask,
                                  res.assign, res.unschedulable)


def _node_options(enc: Encoded, mask: np.ndarray):
    """Closure for NodePlan's lazy (instance_types, offerings): expand
    the config mask's members cheapest-first. Captures only the masked
    ConfigInfo slice, not the Encoded."""
    cols = np.flatnonzero(mask)
    configs = enc.configs
    alts = enc.cfg_alts
    prices = enc.cfg_price[cols].tolist()

    def thunk():
        members: list[tuple[float, int, object]] = []
        for ci, price in zip(cols.tolist(), prices):
            cfg = configs[ci]
            if alts is not None and alts[ci]:
                members.extend((p, ci, m) for p, m in alts[ci])
            else:
                members.append((price, ci, cfg))
        members.sort(key=lambda t: (t[0], t[1]))
        seen_types: dict[str, InstanceType] = {}
        offerings: list[Offering] = []
        for _, _, cfg in members:
            seen_types.setdefault(cfg.instance_type.name, cfg.instance_type)
            offerings.append(cfg.offering)
        return list(seen_types.values()), offerings

    return thunk


def _node_primary(enc: Encoded, price_col: int):
    """Closure for NodePlan.primary(): the cheapest (type, offering)
    the decode resolved the node onto."""
    cfg = enc.configs[price_col]
    members = enc.cfg_alts[price_col] if enc.cfg_alts is not None else None

    def thunk():
        if members:
            _, best = min(members, key=lambda t: t[0])
            return best.instance_type, best.offering
        return cfg.instance_type, cfg.offering

    return thunk


def _build_solution_arrays(
    enc: Encoded,
    active_idx: np.ndarray,    # node rows with pods
    node_masks: np.ndarray,    # [N, C] bool
    assign: np.ndarray,        # [N, G] int
    unsched: np.ndarray,       # [G] int
) -> Solution:
    """Vectorized decode: per-node price/first-config via one masked
    reduction each; option lists stay lazy (see NodePlan). Its wall is
    the solve's "decode" phase."""
    _t_decode = time.perf_counter()
    new_nodes: list[NodePlan] = []
    existing: dict[int, ExistingAssignment] = {}
    group_cursor = np.zeros(len(enc.groups), np.int64)

    sub_mask = node_masks[active_idx]
    price_mat = np.where(sub_mask, enc.cfg_price[None, :], np.inf)
    node_price = price_mat.min(axis=1)
    price_col = price_mat.argmin(axis=1)
    first_col = sub_mask.argmax(axis=1)
    any_col = sub_mask.any(axis=1)

    extra_unsched = np.zeros(len(enc.groups), np.int64)
    loose = enc.loose_groups
    for row, ni in enumerate(active_idx):
        gs = np.nonzero(assign[ni])[0]
        if gs.size == 0 or not any_col[row]:
            continue
        if gs.size > 1 and loose is not None and loose[gs].any():
            # k-way re-validation: pairwise conflict rows cannot see a
            # three-way empty intersection on an open key; walk the
            # node's groups in index order tightening like the
            # reference's incremental Add (nodeclaim.go:114-167) and
            # evict what no longer fits
            running = enc.configs[int(first_col[row])].requirements.copy()
            admitted = []
            for gi in gs:
                reqs = enc.groups[gi].requirements
                if running.intersects(reqs) is not None:
                    extra_unsched[gi] += int(assign[ni, gi])
                    continue
                running.add(*reqs.values())
                admitted.append(gi)
            gs = np.asarray(admitted, dtype=gs.dtype)
            if gs.size == 0:
                continue
        pods: list[Pod] = []
        for gi in gs:
            count = int(assign[ni, gi])
            start = int(group_cursor[gi])
            group_cursor[gi] += count
            pods.extend(enc.groups[gi].pods[start : start + count])
        first_cfg = enc.configs[int(first_col[row])]
        if first_cfg.existing_index >= 0:
            slot = existing.setdefault(
                first_cfg.existing_index, ExistingAssignment(first_cfg.existing_index)
            )
            slot.pods.extend(pods)
            continue
        plan = NodePlan(
            pool=first_cfg.pool,
            price=float(node_price[row]),
            pods=pods,
            lazy=_node_options(enc, sub_mask[row]),
            lazy_primary=_node_primary(enc, int(price_col[row])),
        )
        # the decode resolves the claim onto the cheapest offering; if
        # that is a reserved one, the node consumes reservation budget
        cheapest_cfg = enc.configs[int(price_col[row])]
        if cheapest_cfg.offering is not None and cheapest_cfg.offering.reservation_id:
            plan.reservation_id = cheapest_cfg.offering.reservation_id
        new_nodes.append(plan)

    unschedulable: list[Pod] = []
    evicted: list[Pod] = []
    total_unsched = unsched.astype(np.int64) + extra_unsched
    for gi in np.nonzero(total_unsched)[0]:
        # unplaced pods are the tail of the group after placements
        group = enc.groups[gi]
        tail = group.pods[len(group.pods) - int(total_unsched[gi]) :]
        unschedulable.extend(tail)
        if extra_unsched[gi]:
            evicted.extend(tail[len(tail) - int(extra_unsched[gi]) :])
    _t_done = time.perf_counter()
    SOLVER_PHASE_DURATION.observe(_t_done - _t_decode, {"phase": "decode"})
    sentinel.observe_phase("decode", _t_done - _t_decode)
    tracing.record("solve.decode", _t_decode, _t_done,
                   nodes=len(new_nodes), unschedulable=len(unschedulable))
    return Solution(
        new_nodes=new_nodes,
        existing=sorted(existing.values(), key=lambda e: e.existing_index),
        unschedulable=unschedulable,
        evicted=evicted,
    )


def fingerprint(solution: Solution) -> tuple:
    """What identifies a solution across packages and devices: per new
    node its pool, primary instance type and offering, price and sorted
    pod names; per existing node its sorted pod names; the
    unschedulable pod names."""
    nodes = []
    for plan in solution.new_nodes:
        it, off = plan.primary()
        nodes.append((
            plan.pool.metadata.name,
            it.name if it is not None else "",
            (off.capacity_type, off.zone) if off is not None else ("", ""),
            round(float(plan.price), 9),
            tuple(sorted(p.metadata.name for p in plan.pods)),
            plan.reservation_id,
        ))
    existing = tuple(
        (e.existing_index, tuple(sorted(p.metadata.name for p in e.pods)))
        for e in solution.existing
    )
    return (
        tuple(nodes),
        existing,
        tuple(sorted(p.metadata.name for p in solution.unschedulable)),
    )
