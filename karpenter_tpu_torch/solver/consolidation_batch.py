"""Batched consolidation probes: candidate subsets as lanes of one
device solve.

Copy of `karpenter_tpu/solver/consolidation_batch.py`, whole. A
consolidation search probes many candidate subsets of one fleet: each
probe removes its candidates' nodes and repacks their pods onto what
remains. Every probe shares one fleet and one catalog, and a probe's
pods are a subset of the union of all probes' pods, so one `group_pods`
+ `encode` over the union covers every lane: a group a lane does not use
carries count 0 (a no-op in the packing kernel), and a lane's removed
nodes are bound rows whose live bit is cleared (capacity 0, the other
rows keep their order and arithmetic).

`LaneSolver.solve_lazy` stages the shared arrays once, as
`pack._run_pack` does, and dispatches chunks of `probe_batch_width`
lanes lazily: a chunk of several lanes runs B6 `pack_probe_lanes_flat`
(B1, or B3 when the union has enough groups, over the lane axis, then
the lane epilogue), a chunk of one lane runs the plain split solve
`pack_split_flat` on that lane's own groups. Each lane decodes through
`_build_solution_arrays` against a per-lane view of the encode, so a
lane's Solution is the one solving its subset alone gives.
`ProbePruner` asks the lane solver's `lp_device.DualCertificate`
whether a subset can be replaced strictly cheaper at all.
`BatchProbeSolver` is the disruption engine's seam: one Scheduler over
the fleet snapshot, its probes primed as lanes, each lane decoded to
the `(SchedulerResults, all_ok)` a sequential `simulate_scheduling`
returns (or None where the sequential path must run).

The chunk dispatch is the `probe` fault site (`solver/faults.py`) and
opens the `disruption.probe_batch` span, as in the JAX package. A
dispatch that fails charges the device breaker
(`resilience.shared().breaker("device")`) when its failure classifies
as `device_lost`, `deadline` or `compile_timeout` (a host-side staging
error does not) and `resilience.may_degrade` lets it through (on a CUDA
device, an injected fault only: a failing kernel must not open the
breaker and send later solves to the host), then re-raises.
`dual_certificate` remembers a degraded LP, or a certificate that
failed to build, as "no certificate" until the next staging; on a CUDA
device a build failure other than an injected fault is raised.

Differences from the JAX package: the lane solver and the batch take a
`device` (None means the card, and raises without one), and on a CUDA
device a failed batch or lane decode is raised unless
`resilience.may_degrade` admits it. The probe counters are the JAX
package's: `SOLVER_PROBE_BATCH{outcome}` (lane, batch, capped_retry,
fallback_lane) and `SOLVER_DEVICE_STEPS{path}`, one observation a
dispatch.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.kube.objects import Pod
from karpenter_tpu_torch.metrics.store import SOLVER_DEVICE_STEPS, SOLVER_PROBE_BATCH
from karpenter_tpu_torch.solver import faults, lp_device, resilience
from karpenter_tpu_torch.solver import pack_split as kernels
from karpenter_tpu_torch.solver.encode import ExistingNodeInput, encode, group_pods
from karpenter_tpu_torch.solver.pack import (
    _bucket,
    _lane_bucket,
    _pad_axis,
    probe_batch_width,
    wavefront_plan,
)
from karpenter_tpu_torch.solver.solver import (
    Solution,
    _build_solution_arrays,
    resolve_device,
)

log = logging.getLogger("karpenter.solver.consolidation_batch")

def probe_counts(since: Optional[dict] = None) -> dict:
    """`SOLVER_PROBE_BATCH` by outcome (lane, batch, capped_retry,
    fallback_lane) as plain numbers; with `since`, an earlier return,
    the growth since then."""
    out = {o: SOLVER_PROBE_BATCH.value({"outcome": o})
           for o in ("lane", "batch", "capped_retry", "fallback_lane")}
    if since is not None:
        out = {k: v - since.get(k, 0) for k, v in out.items()}
    return out


def _pow2(n: int, base: int) -> int:
    out = base
    while out < n:
        out *= 2
    return out


@dataclass
class ProbeLane:
    """One candidate subset to evaluate: mask these nodes out, repack
    these pods against what remains."""

    exclude_names: tuple[str, ...]
    pods: list[Pod] = field(default_factory=list)


class LaneSolver:
    """Encode-once, mask-per-lane probe solver over one fleet state.

    `existing_inputs` is the whole fleet (candidates included); each
    lane names the nodes it removes. `pending` pods (a shared backlog)
    join every lane's demand. `shape_floors` ({"G", "C", "E", "F"})
    raises the padded axes to a caller's floors, so a caller probing a
    shrinking fleet round after round keeps one set of shapes; padding
    is inert. `device=None` is the card and raises without one."""

    def __init__(
        self,
        pools_with_types,
        existing_inputs: Sequence[ExistingNodeInput],
        daemon_overhead: Optional[dict] = None,
        reserved_in_use: Optional[dict[str, int]] = None,
        pending: Sequence[Pod] = (),
        compat_cache=None,
        shape_floors: Optional[dict[str, int]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.pools = list(pools_with_types)
        self.inputs = list(existing_inputs)
        self.daemon_overhead = daemon_overhead
        self.reserved_in_use = dict(reserved_in_use or {})
        self.pending = list(pending)
        # solver/incremental.EncodedCache, shared with the caller's
        # other encodes over the same catalog
        self.compat_cache = compat_cache
        self.shape_floors = dict(shape_floors or {})
        # the padded shapes of the last staging, for chaining floors
        self.last_shapes: dict[str, int] = {}
        self._idx = {inp.name: i for i, inp in enumerate(self.inputs)}
        # the last staged union encode and pod -> group map, which the
        # dual-certificate pruner reads
        self.last_enc = None
        self.last_gi_by_key: dict[str, int] = {}
        self._certificate = None

    def dual_certificate(self):
        """The DualCertificate over the last staged union encode (B5
        runs once per staging), or None when guidance is off, nothing
        is staged yet, the problem is degenerate, or the LP degraded.
        A degraded LP, or a certificate that failed to build, is
        remembered as False until the next staging: a search probes its
        certificate once per candidate subset, and re-running a failing
        LP per probe would turn the pruning fast path into repeated
        wasted work."""
        if self._certificate is not None:
            return self._certificate or None
        if self.last_enc is None or not lp_device.enabled():
            return None
        dlp = lp_device.maybe_solve(self.last_enc, device=self.device)
        if dlp is None:
            self._certificate = False  # degraded: don't retry this staging
            return None
        try:
            self._certificate = lp_device.DualCertificate(self.last_enc, dlp)
        except Exception as err:
            if not resilience.may_degrade(err, self.device):
                raise
            log.exception("dual certificate build failed; not pruning")
            self._certificate = False
            return None
        return self._certificate

    def knows(self, name: str) -> bool:
        return name in self._idx

    # -- solve ----------------------------------------------------------------

    def solve(self, lanes: Sequence[ProbeLane], mode: str = "ffd") -> list[Solution]:
        """Per-lane Solutions, index-aligned with `lanes`, decoded at
        once (see solve_lazy for the search's entry)."""
        return [thunk() for thunk in self.solve_lazy(lanes, mode=mode)]

    def solve_lazy(self, lanes: Sequence[ProbeLane], mode: str = "ffd"):
        """Stage the whole lane batch now (one encode, one set of padded
        arrays on the device for every lane) and return per-lane
        zero-argument thunks. A chunk of `probe_batch_width` lanes is
        dispatched when one of its lanes is first consulted, and a lane
        is decoded when it is consulted: a binary search consults
        O(log n) of its n lanes. A chunk of one lane runs the plain
        split solve on that lane's groups alone. Existing assignments
        index this solver's `existing_inputs` (the whole fleet)."""
        dev = self.device
        lane_pod_lists = [list(lane.pods) + self.pending for lane in lanes]
        union: dict[str, Pod] = {}
        for pods in lane_pod_lists:
            for p in pods:
                union.setdefault(p.key, p)
        if not union:
            # nothing to place anywhere: every lane trivially succeeds
            return [
                lambda: Solution(new_nodes=[], existing=[], unschedulable=[])
                for _ in lanes
            ]
        groups = group_pods(list(union.values()))
        gi_by_key = {
            p.key: gi for gi, g in enumerate(groups) for p in g.pods
        }
        enc = encode(
            groups,
            self.pools,
            self.inputs,
            self.daemon_overhead,
            reserved_in_use=self.reserved_in_use,
            compat_cache=self.compat_cache,
        )
        # the pruner's certificate is a function of this encode
        self.last_enc = enc
        self.last_gi_by_key = gi_by_key
        self._certificate = None

        # the staging below does not forward existing_quota / group_cap
        # (probe encodes never produce them: they come only from the
        # topology-lowered path, which probes do not take)
        assert enc.existing_quota is None and enc.group_cap is None, (
            "probe staging does not forward existing_quota/group_cap; "
            "route this solve through the sequential path"
        )
        G, C = enc.compat.shape
        R = enc.group_req.shape[1]
        E = enc.n_existing
        L = len(lanes)

        # per-lane demand over the unpadded axes
        counts = np.zeros((L, G), np.int32)
        for li, pods in enumerate(lane_pod_lists):
            for p in pods:
                counts[li, gi_by_key[p.key]] += 1
        base_live = np.zeros((E,), bool)
        bound_cfg_raw = np.full((E,), -1, np.int32)
        for ci, cfg in enumerate(enc.configs):
            if cfg.existing_index >= 0:
                bound_cfg_raw[cfg.existing_index] = ci
        base_live[:] = bound_cfg_raw >= 0
        live = np.repeat(base_live[None, :], max(L, 1), axis=0)
        for li, lane in enumerate(lanes):
            for name in lane.exclude_names:
                live[li, self._idx[name]] = False

        # ---- shared staging, `pack._run_pack`'s padding raised to the
        # caller's floors
        Gp, Cp = _pad_axis(G), _pad_axis(C)
        Cp = -(-Cp // 32) * 32
        Ep = _pad_axis(E) if E else 0
        Gp = max(Gp, self.shape_floors.get("G", 0))
        Cp = -(-max(Cp, self.shape_floors.get("C", 0)) // 32) * 32
        Ep = max(Ep, self.shape_floors.get("E", 0))

        compat = np.zeros((Gp, Cp), bool)
        compat[:G, :C] = enc.compat
        group_req = np.zeros((Gp, R), np.float32)
        group_req[:G] = enc.group_req
        cfg_alloc = np.zeros((Cp, R), np.float32)
        cfg_alloc[:C] = enc.cfg_alloc
        cfg_pool = np.full((Cp,), -1, np.int32)
        cfg_pool[:C] = enc.cfg_pool
        cfg_price = np.zeros((Cp,), np.float32)
        cfg_price[:C] = enc.cfg_price

        bound_cfg = np.full((Ep,), -1, np.int32)
        bound_cfg[:E] = bound_cfg_raw
        bound_live_any = bound_cfg >= 0
        safe_cfg = np.maximum(bound_cfg, 0)
        bound_alloc = np.where(
            bound_live_any[:, None], cfg_alloc[safe_cfg], 0.0
        ).astype(np.float32)
        bound_used0 = np.zeros((Ep, R), np.float32)
        bound_compat = np.zeros((Gp, Ep), bool)
        if Ep:
            bound_compat[:, :] = compat[:, safe_cfg] & bound_live_any[None, :]

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        cfg_rsv_t = None
        rsv_cap_t = None
        K = 0
        cfg_rsv_h = np.full((Cp,), -1, np.int32)
        if enc.rsv_cap is not None and enc.rsv_cap.size:
            K = int(enc.rsv_cap.size)
            cfg_rsv_h[:C] = enc.cfg_rsv
            cfg_rsv_t = put(cfg_rsv_h)
            rsv_cap_t = put(enc.rsv_cap.astype(np.float32))
        bound_slot = np.where(
            bound_live_any & (cfg_rsv_h[safe_cfg] >= 0),
            cfg_rsv_h[safe_cfg], K,
        ).astype(np.int32)
        conflict_t = None
        if enc.conflict is not None and enc.conflict.any():
            cf = np.zeros((Gp, Gp), bool)
            cf[:G, :G] = enc.conflict
            conflict_t = put(cf)

        shared = tuple(put(x) for x in (
            compat, group_req, cfg_alloc, cfg_pool,
            np.asarray(enc.pool_overhead, np.float32), bound_compat,
            bound_alloc, bound_used0, bound_slot, cfg_price,
        ))

        # fresh-axis estimate: per-group best single-node capacity once,
        # then the largest per-lane ceil-sum (the bound
        # pack._estimate_nodes uses, per lane); a capped first attempt
        # regrows
        launch = enc.cfg_pool >= 0
        per_best = np.ones((G,))
        for gi in range(G):
            mask = enc.compat[gi] & launch
            if not mask.any():
                continue
            req = enc.group_req[gi]
            safe = np.where(req > 0, req, 1.0)
            pn = np.floor((enc.cfg_alloc[mask] + 1e-4) / safe[None, :])
            pn = np.where(req[None, :] > 0, pn, np.inf).min(axis=1)
            per_best[gi] = max(1.0, float(pn.max()) if pn.size else 1.0)
        lane_est = np.ceil(counts / per_best[None, :]).sum(axis=1)
        lane_total = counts.sum(axis=1)
        F = _bucket(max(32, int(1.35 * float(lane_est.max() if L else 0)) + 16))
        F = max(F, self.shape_floors.get("F", 0))
        self.last_shapes = {"G": Gp, "C": Cp, "E": Ep, "F": F}

        width = probe_batch_width(dev)
        # chunk index -> (flat [rows, ...] uint32, F used, Gp used, the
        # lane's compacted groups or None), dispatched (and cap-regrown)
        # when a member lane is first consulted
        chunk_cache: dict[int, tuple] = {}

        def dispatch(ci: int) -> tuple:
            hit = chunk_cache.get(ci)
            if hit is not None:
                return hit
            with tracing.span("disruption.probe_batch", chunk=ci):
                return _dispatch_traced(ci)

        def _dispatch_traced(ci: int) -> tuple:
            chunk = list(range(ci * width, min((ci + 1) * width, L)))
            tracing.annotate(lanes=len(chunk))
            # counted once a chunk: cap-regrow retries dispatch again
            # (batch + capped_retry) but ship no lane again
            SOLVER_PROBE_BATCH.inc({"outcome": "lane"}, value=float(len(chunk)))
            solo = len(chunk) == 1
            if solo:
                # one lane: the plain split kernel, no lane axis, the
                # group axis compacted to the lane's groups with demand
                # and the fresh axis sized from the lane's own estimate;
                # both axes snap to one power-of-two level k (G = 16<<k,
                # F = 64<<k), as the JAX package pads them
                li = chunk[0]
                rows = np.flatnonzero(counts[li])
                gsel = rows if rows.size else np.zeros((0,), np.int64)
                g_level = 0
                while (16 << g_level) < max(int(gsel.size), 1):
                    g_level += 1
                f_req = max(32, int(1.35 * float(lane_est[li])) + 16)
                f_level = 0
                while (64 << f_level) < f_req:
                    f_level += 1
                k = max(g_level, f_level)
                Gp_c = 16 << k
                compat_c = np.zeros((Gp_c, Cp), bool)
                compat_c[: gsel.size] = compat[gsel]
                req_c = np.zeros((Gp_c, R), np.float32)
                req_c[: gsel.size] = group_req[gsel]
                counts_c = np.zeros((Gp_c,), np.int32)
                counts_c[: gsel.size] = counts[li][gsel]
                bcompat_c = np.zeros((Gp_c, Ep), bool)
                bcompat_c[: gsel.size] = bound_compat[gsel]
                conflict_c = None
                if conflict_t is not None and gsel.size:
                    cfc = np.zeros((Gp_c, Gp_c), bool)
                    cfc[: gsel.size, : gsel.size] = enc.conflict[np.ix_(gsel, gsel)]
                    conflict_c = put(cfc)
                live_row = np.zeros((Ep,), bool)
                live_row[:E] = live[li]
                F_try = 64 << k
                worst = int(lane_total[li])
                Gp_used = Gp_c
                solo_in = tuple(put(x) for x in (compat_c, req_c, counts_c,
                                                 bcompat_c, live_row))
            else:
                F_try = F
                worst = int(lane_total[chunk].max())
                Gp_used = Gp
                gsel = None
                Lp = _lane_bucket(len(chunk))
                counts_pad = np.zeros((Lp, Gp), np.int32)
                counts_pad[: len(chunk), :G] = counts[chunk]
                live_pad = np.zeros((Lp, Ep), bool)
                live_pad[: len(chunk), :E] = live[chunk]
                lane_in = (put(counts_pad), put(live_pad))
            while True:
                N = Ep + F_try
                W = Cp // 32
                SOLVER_PROBE_BATCH.inc({"outcome": "batch"})
                # the device-bound probe dispatch: the fault site chaos
                # drives (`...@probe`), with the breaker's bookkeeping
                # so a failing card stops attracting probe batches
                try:
                    faults.fire("probe")
                    # the wavefront width is judged per dispatch on the
                    # group count the kernel walks: the lane's compacted
                    # groups alone, or the union for a batch
                    if solo:
                        wf = wavefront_plan(int(gsel.size), dev)
                        flat_t = kernels.pack_split_flat(
                            solo_in[0], solo_in[1], solo_in[2],
                            shared[2], shared[3], shared[4], solo_in[3],
                            shared[6], shared[7], shared[8], solo_in[4],
                            shared[9], max_free=F_try, mode=mode, wavefront=wf,
                            cfg_rsv=cfg_rsv_t, rsv_cap=rsv_cap_t,
                            conflict=conflict_c,
                        )[None, :]
                    else:
                        wf = wavefront_plan(G, dev)
                        flat_t = kernels.pack_probe_lanes_flat(
                            shared[0], shared[1], lane_in[0],
                            shared[2], shared[3], shared[4], shared[5],
                            shared[6], shared[7], shared[8], lane_in[1],
                            shared[9], max_free=F_try, mode=mode, wavefront=wf,
                            cfg_rsv=cfg_rsv_t, rsv_cap=rsv_cap_t,
                            conflict=conflict_t,
                        )
                    # the one device-to-host copy of the chunk
                    flat = flat_t.cpu().numpy().view(np.uint32)
                except Exception as err:
                    # only device-class failures charge the breaker: a
                    # host-side staging error (deterministic) must not
                    # open it and exile every solve to the host oracle
                    reason = resilience.classify(err)
                    if reason in ("device_lost", "deadline", "compile_timeout") \
                            and resilience.may_degrade(err, dev):
                        resilience.shared().breaker("device").record_failure(reason)
                    raise
                o1 = N * Gp_used + F_try * W
                # a capped lane's truncated answer is never served: the
                # chunk regrows the fresh axis and dispatches again
                capped = any(
                    int(flat[row, o1]) >= N
                    and int(flat[row, o1 + 1 : o1 + 1 + Gp_used].sum()) > 0
                    for row in range(len(chunk))
                )
                if capped and F_try <= worst:
                    # one node holds at least one pod, so the largest
                    # lane's pod count bounds any fresh axis needed
                    grown = min(max(F_try * 2, F_try + 16), worst + 1)
                    F_try = _pow2(grown, 32) if solo else _bucket(grown)
                    SOLVER_PROBE_BATCH.inc({"outcome": "capped_retry"})
                    continue
                # device steps once a dispatch: the wavefront batch runs
                # the most rounds of any lane, the sequential kernel one
                # step a padded group
                if wf > 1:
                    chunk_steps = max(
                        int(flat[r, o1 + 1 + 2 * Gp_used]) for r in range(len(chunk)))
                else:
                    chunk_steps = Gp_used
                SOLVER_DEVICE_STEPS.observe(
                    chunk_steps, {"path": "wavefront" if wf > 1 else "sequential"})
                chunk_cache[ci] = (flat, F_try, Gp_used, gsel)
                return chunk_cache[ci]

        def make_thunk(li: int):
            """Dispatch if needed and decode one lane; memoized."""
            cell: list = []

            def thunk() -> Solution:
                if cell:
                    return cell[0]
                flat, F_used, Gp_used, gsel = dispatch(li // width)
                row = li % width
                N = Ep + F_used
                W = Cp // 32
                o0 = N * Gp_used
                o1 = o0 + F_used * W
                packed_a = flat[row, :o0].reshape(N, Gp_used)
                assign = np.zeros((N, G), np.int32)
                packed_u = flat[row, o1 + 1 : o1 + 1 + Gp_used]
                unsched = np.zeros((G,), np.int32)
                if gsel is None:
                    assign[:, :] = packed_a[:, :G]
                    unsched[:] = packed_u[:G]
                elif gsel.size:
                    assign[:, gsel] = packed_a[:, : gsel.size]
                    unsched[gsel] = packed_u[: gsel.size]
                node_count = int(flat[row, o1])
                node_mask = np.zeros((N, C), bool)
                live_rows = np.flatnonzero(live[li])
                if live_rows.size:
                    node_mask[live_rows, bound_cfg[live_rows]] = True
                if F_used:
                    words = np.ascontiguousarray(
                        flat[row, o0:o1].reshape(F_used, W)
                    )
                    bits = np.unpackbits(
                        words.view(np.uint8).reshape(F_used, W * 4),
                        axis=1, bitorder="little",
                    )
                    node_mask[Ep:] = bits[:, :C].astype(bool)
                node_active = assign.sum(axis=1) > 0
                node_active[:Ep] |= np.pad(live[li], (0, Ep - E))
                per: dict[int, list[Pod]] = {}
                for p in lane_pod_lists[li]:
                    per.setdefault(gi_by_key[p.key], []).append(p)
                lane_enc = replace(enc, groups=[
                    replace(g, pods=per.get(gi, []))
                    for gi, g in enumerate(groups)
                ])
                cell.append(_build_solution_arrays(
                    lane_enc,
                    np.flatnonzero(node_active[:node_count]),
                    node_mask,
                    assign,
                    unsched,
                ))
                return cell[0]

            return thunk

        return [make_thunk(li) for li in range(L)]


class ProbePruner:
    """Dual-based pruning of the consolidation probe ladder: before a
    candidate subset is simulated, ask the lane solver's
    DualCertificate whether it can be replaced strictly cheaper at
    all. By weak duality a pruned probe could only have found no
    cheaper replacement. A gap in the certificate (an unknown node, a
    pod outside the staged union, no certificate) answers False."""

    def __init__(self, lane_solver: LaneSolver):
        self.lane_solver = lane_solver
        # the last prune's numbers (the floor against the price), set
        # when cannot_pay has just returned True
        self.last: Optional[dict] = None

    def cannot_pay(self, candidates) -> bool:
        """`candidates`: objects with `state_node.name`, `price` and
        `reschedulable_pods`."""
        self.last = None
        ls = self.lane_solver
        cert = ls.dual_certificate()
        if cert is None or ls.last_enc is None:
            return False
        gi = ls.last_gi_by_key
        demand = np.zeros(ls.last_enc.compat.shape[0], np.int64)
        rows: list[int] = []
        current_price = 0.0
        for c in candidates:
            name = c.state_node.name
            if not ls.knows(name):
                return False
            rows.append(ls._idx[name])
            current_price += float(c.price)
            for p in c.reschedulable_pods:
                g = gi.get(p.key)
                if g is None:
                    return False
                demand[g] += 1
        if current_price <= 0:
            return False
        margin = lp_device.prune_margin()
        floor = cert.floor(demand, rows)
        pruned = cert.cannot_pay(demand, rows, current_price,
                                 margin=margin, floor=floor)
        if pruned:
            self.last = {
                "lp_floor": round(floor, 6),
                "current_price": round(current_price, 6),
                "margin": margin,
            }
        return pruned


def _relaxable(pod: Pod) -> bool:
    """True when preferences.relax() would strip something — the
    sequential path retries such pods, so a batched lane that left one
    unscheduled must be re-probed sequentially, not cached. One
    canonical predicate (provisioning/preferences.relaxable) shared
    with the incremental live tick's fallback gate."""
    from karpenter_tpu_torch.provisioning.preferences import relaxable

    return relaxable(pod)


class BatchProbeSolver:
    """simulate_scheduling-faithful probe batching for the engine.

    Construction pays the per-round costs once: one deep-copied
    snapshot becomes one Scheduler (existing inputs, daemon overhead,
    reservation ledger, catalog filtering). `prime(lane_specs)` then
    evaluates many candidate subsets in one kernel batch and returns,
    per lane, either the exact `(SchedulerResults, all_ok)` tuple the
    sequential probe would compute, or None when that lane (or the
    whole batch) must fall back to the sequential path.

    `device` is the card (None, raising without one) or the device the
    caller asks for; the Scheduler and the LaneSolver run on it. On a
    CUDA device a batch or lane failure reaches the caller unless
    `resilience.may_degrade` admits it (an injected fault, a deadline);
    off the card every failure falls back to the sequential probe, as
    in the JAX package.
    """

    def __init__(
        self,
        pools_with_types,
        snapshot,
        daemonsets,
        cluster_pods,
        pending_pods,
        options,
        kube,
        clock,
        compat_cache=None,
        existing_input_cache=None,
        device=None,
    ):
        from karpenter_tpu_torch.provisioning.scheduler import Scheduler

        self.device = resolve_device(device)
        self.kube = kube
        self.scheduler = Scheduler(
            pools_with_types=pools_with_types,
            state_nodes=snapshot,
            # retained ExistingNodeInput rows from the fleet seam
            # (state/retained.py): unchanged nodes skip the per-node
            # input derivation
            existing_input_cache=existing_input_cache,
            daemonsets=daemonsets,
            cluster_pods=cluster_pods,
            allow_reserved=options.feature_gates.reserved_capacity,
            min_values_policy=options.min_values_policy,
            ignore_dra_requests=options.ignore_dra_requests,
            metrics_controller="disruption",
            kube=kube,
            clock=clock,
            objective="ffd",
            compat_cache=compat_cache,
            device=self.device,
        )
        self.pending = list(pending_pods)
        self.lane_solver = LaneSolver(
            self.scheduler.pools_with_types,
            self.scheduler.existing_inputs,
            daemon_overhead=self.scheduler.daemon_overhead,
            reserved_in_use=dict(self.scheduler.reserved_in_use),
            pending=self.pending,
            compat_cache=compat_cache,
            device=self.device,
        )
        # which snapshot nodes hold a reservation: masking one out
        # frees budget the shared encode cannot express per lane
        from karpenter_tpu_torch.apis.v1.labels import RESERVATION_ID_LABEL
        from karpenter_tpu_torch.provisioning.scheduler import _state_node_key

        self._reserved_nodes: set[str] = set()
        for node in snapshot:
            rid = node.labels().get(RESERVATION_ID_LABEL, "")
            if not rid and node.node_claim is not None:
                for spec in node.node_claim.spec.requirements:
                    if spec.key == RESERVATION_ID_LABEL and spec.values:
                        rid = spec.values[0]
                        break
            if rid:
                self._reserved_nodes.add(_state_node_key(node))

    def pruner(self) -> ProbePruner:
        """The dual-certificate pruner over this batch's staged union
        problem (valid once prime() has staged it)."""
        return ProbePruner(self.lane_solver)

    def usable(self) -> bool:
        """False when the sequential path would not run the in-process
        device kernel — matching its backend is part of the oracle
        contract — or when the device breaker is open (a faulting
        device must not attract whole probe batches that each burn a
        failure before degrading; the sequential path's ladder goes
        straight to the working rung)."""
        import os

        from karpenter_tpu_torch.solver.solver import _backend

        if _backend() == "host":
            return False
        # a solver endpoint sends the sequential path to the remote rung
        # (not ported: the ladder raises naming it), never to this batch
        if os.environ.get("KARPENTER_SOLVER_ENDPOINT"):
            return False
        if resilience.shared().breaker("device").is_open():
            log.warning(
                "device breaker open; consolidation probing sequentially")
            return False
        return True

    def _batch_eligible(self, pods: Sequence[Pod]) -> tuple[bool, set[str]]:
        """(eligible, dra_keys): the batched path only reproduces the
        Scheduler's FAST path. Pods that would route to the topology /
        host-port / volume-limited machinery gate the whole batch; DRA
        pods are permanently errored exactly as Scheduler._solve does,
        so they just report as unscheduled per lane."""
        from karpenter_tpu_torch.provisioning import volume_topology
        from karpenter_tpu_torch.scheduling.hostports import pod_host_ports
        from karpenter_tpu_torch.scheduling.volumeusage import pod_volume_drivers
        from karpenter_tpu_torch.utils.pod import has_dra_requirements

        sched = self.scheduler
        dra: set[str] = set()
        limited = {
            d for usage in sched._volume_usage.values() for d in usage.limits
        }
        for pod in pods:
            if sched.ignore_dra_requests and has_dra_requirements(pod):
                dra.add(pod.key)
                continue
            if self.kube is not None and (
                pod.spec.volumes or pod.spec.injected_requirements
            ):
                # same per-solve re-derivation the sequential probe runs
                volume_topology.inject(pod, self.kube)
            if (
                limited
                and pod.spec.volumes
                and limited & pod_volume_drivers(pod, self.kube).keys()
            ):
                return False, dra
            if sched.topology.has_constraints(pod) or pod_host_ports(pod):
                return False, dra
        return True, dra

    def prime(self, lane_specs) -> Optional[list]:
        """Evaluate `lane_specs` (lists of Candidates) as one batch.
        Returns None when the WHOLE batch is unsupported, else a list
        aligned with lane_specs holding, per lane, a zero-arg thunk
        that decodes to `(SchedulerResults, all_ok)` — or to None when
        that lane turns out to need the sequential path — or None for
        lanes known-unsupported up front. The device work happens here;
        per-lane decode cost is deferred to the probes the search
        actually consults."""
        lanes: list[ProbeLane] = []
        lane_pods: list[list[Pod]] = []
        supported = [True] * len(lane_specs)
        for i, spec in enumerate(lane_specs):
            names = tuple(c.state_node.name for c in spec)
            pods = [p for c in spec for p in c.reschedulable_pods]
            if any(not self.lane_solver.knows(n) for n in names) or (
                self._reserved_nodes and self._reserved_nodes & set(names)
            ):
                supported[i] = False
                names, pods = (), []
            lanes.append(ProbeLane(exclude_names=names, pods=pods))
            lane_pods.append(pods)
        union: dict[str, Pod] = {}
        for pods in lane_pods:
            for p in pods:
                union.setdefault(p.key, p)
        for p in self.pending:
            union.setdefault(p.key, p)
        ok_batch, dra = self._batch_eligible(list(union.values()))
        if not ok_batch:
            SOLVER_PROBE_BATCH.inc(
                {"outcome": "fallback_lane"}, value=float(len(lane_specs))
            )
            return None
        # DRA pods never enter the solve (Scheduler gates them first)
        if dra:
            lanes = [
                ProbeLane(
                    exclude_names=lane.exclude_names,
                    pods=[p for p in lane.pods if p.key not in dra],
                )
                for lane in lanes
            ]
            self.lane_solver.pending = [
                p for p in self.pending if p.key not in dra
            ]
        try:
            lazy = self.lane_solver.solve_lazy(lanes, mode="ffd")
        except Exception as err:
            if not resilience.may_degrade(err, self.device):
                raise
            log.exception("probe batch failed; falling back to sequential")
            SOLVER_PROBE_BATCH.inc(
                {"outcome": "fallback_lane"}, value=float(len(lane_specs))
            )
            return None

        def make_verdict(i, decode):
            cell: list = []

            def verdict():
                if not cell:
                    try:
                        cell.append(
                            self._to_results(lane_pods[i], decode(), dra)
                        )
                    except Exception as err:
                        if not resilience.may_degrade(err, self.device):
                            raise
                        log.exception("probe lane decode failed; "
                                      "falling back to sequential")
                        cell.append(None)
                    if cell[0] is None:
                        SOLVER_PROBE_BATCH.inc({"outcome": "fallback_lane"})
                return cell[0]

            return verdict

        out = []
        for i, decode in enumerate(lazy):
            if not supported[i]:
                SOLVER_PROBE_BATCH.inc({"outcome": "fallback_lane"})
                out.append(None)
                continue
            out.append(make_verdict(i, decode))
        return out

    def _to_results(self, lane_pods, sol: Solution, dra: set[str]):
        """One lane's Solution -> the (SchedulerResults, all_ok) tuple
        `simulate_scheduling` would return — or None when sequential-
        only machinery (eviction retries, the preference-relaxation
        ladder) would have engaged."""
        from karpenter_tpu_torch.provisioning.scheduler import (
            DRA_ERROR,
            NO_CAPACITY_ERROR,
            SchedulerResults,
        )

        sched = self.scheduler
        if sol.evicted:
            return None
        if sol.unschedulable and sched.honor_preferences and any(
            _relaxable(p) for p in sol.unschedulable
        ):
            return None
        results = SchedulerResults(new_node_plans=[], existing_assignments={})
        kept = [
            plan for plan in sol.new_nodes
            if sched._enforce_min_values(plan, results)
        ]
        for a in sol.existing:
            name = sched.existing_inputs[a.existing_index].name
            results.existing_assignments.setdefault(name, []).extend(a.pods)
        for pod in sol.unschedulable:
            results.errors[pod.key] = NO_CAPACITY_ERROR
        for key in dra:
            results.errors[key] = DRA_ERROR
        for plan in kept:
            sched._finalize_plan(plan)
            if sched._enforce_min_values(plan, results):
                results.new_node_plans.append(plan)
        scheduled = {
            p.key for plan in results.new_node_plans for p in plan.pods
        } | {
            p.key for ps in results.existing_assignments.values() for p in ps
        }
        all_ok = all(p.key in scheduled for p in lane_pods)
        return results, all_ok
