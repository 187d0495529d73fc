"""Pure-Python per-pod first-fit-decreasing oracle.

Copy of `karpenter_tpu/solver/reference_ffd.py` over this package's
`Encoded`: numpy only, the same loop. It is the resilience ladder's host
rung (`resilience.host_pack_result`) and the `backend="host"` decode
(`solver._decode_host`).

Implements the reference scheduler's decision procedure
(scheduler.go:434-647) directly over the encoded problem: pods in
size-descending order, each tried against nodes in index order
(existing first), else a new node on the highest-weight admitting
pool. Used as (a) a parity oracle for the packing kernels and (b) the
degraded answer when every device rung of the ladder failed or was
skipped — never in place of a missing card (`solver.resolve_device`
still raises without one).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.solver.encode import Encoded


@dataclass
class _Node:
    mask: np.ndarray           # [C] bool
    used: np.ndarray           # [R] float32
    assign: dict[int, int] = field(default_factory=dict)  # group -> count
    quota: np.ndarray | None = None  # [G] remaining per-group cap (existing)


def solve_ffd_host(enc: Encoded) -> tuple[list[_Node], dict[int, int]]:
    """Returns (nodes, unschedulable{group: count})."""
    C = len(enc.configs)
    alloc = enc.cfg_alloc  # [C, R]
    # reservation budgets shared per reservation id, not per column
    cfg_rsv = (
        enc.cfg_rsv if enc.cfg_rsv is not None else np.full((C,), -1, np.int32)
    )
    rsv_cap = (
        enc.rsv_cap.astype(np.float64)
        if enc.rsv_cap is not None
        else np.zeros((0,), np.float64)
    )
    capped = cfg_rsv >= 0
    rsv_used = np.zeros(len(rsv_cap), np.float64)
    G = len(enc.groups)
    # lowered topology constraints (solver/topo_batch.py) — the host
    # oracle must enforce the same per-node caps / group conflicts /
    # existing-node quotas the device kernel does
    group_cap = (
        enc.group_cap.astype(np.int64)
        if enc.group_cap is not None
        else np.full((G,), np.iinfo(np.int64).max, np.int64)
    )
    conflict = enc.conflict if enc.conflict is not None else None
    nodes: list[_Node] = []
    for ei in range(enc.n_existing):
        mask = np.zeros((C,), bool)
        for ci, cfg in enumerate(enc.configs):
            if cfg.existing_index == ei:
                mask[ci] = True
        quota = (
            enc.existing_quota[ei].astype(np.int64)
            if enc.existing_quota is not None
            else None
        )
        nodes.append(
            _Node(mask=mask, used=enc.existing_used[ei].copy(), quota=quota)
        )
    unschedulable: dict[int, int] = {}

    def node_admits(node: _Node, gi: int) -> bool:
        have = node.assign.get(gi, 0)
        cap = group_cap[gi]
        if node.quota is not None:
            cap = min(cap, node.quota[gi])
        if have >= cap:
            return False
        if conflict is not None:
            for other, count in node.assign.items():
                if count > 0 and conflict[gi, other]:
                    return False
        return True

    for gi in range(G):
        req = enc.group_req[gi]
        row = enc.compat[gi]
        for _ in range(int(enc.group_count[gi])):
            placed = False
            for node in nodes:
                if not node_admits(node, gi):
                    continue
                ok = node.mask & row & np.all(node.used[None, :] + req[None, :] <= alloc + 1e-4, axis=1)
                if ok.any():
                    node.mask = ok
                    node.used = node.used + req
                    node.assign[gi] = node.assign.get(gi, 0) + 1
                    placed = True
                    break
            if placed:
                continue
            # open new node on highest-weight (lowest index) admitting pool
            if len(rsv_cap):
                slot = np.clip(cfg_rsv, 0, None)
                budget_ok = ~capped | (rsv_used[slot] < rsv_cap[slot])
            else:
                budget_ok = np.ones((C,), bool)
            fresh = row & (enc.cfg_pool >= 0) & budget_ok
            overhead = enc.pool_overhead[enc.cfg_pool]
            fresh &= np.all(overhead + req[None, :] <= alloc + 1e-4, axis=1)
            if not fresh.any():
                unschedulable[gi] = unschedulable.get(gi, 0) + 1
                continue
            pool = int(enc.cfg_pool[fresh].min())
            mask = fresh & (enc.cfg_pool == pool)
            # a reserved (capped) column pins the node and consumes one
            # reservation instance; otherwise capped columns drop from
            # the option mask (ReservationManager semantics)
            reserved_opts = np.flatnonzero(mask & capped)
            if reserved_opts.size and enc.cfg_price is not None and (
                enc.cfg_price[reserved_opts].min()
                <= enc.cfg_price[mask].min() + 1e-12
            ):
                pin = reserved_opts[np.argmin(enc.cfg_price[reserved_opts])]
                mask = np.zeros((C,), bool)
                mask[pin] = True
                rsv_used[cfg_rsv[pin]] += 1
            else:
                # an uncapped option is strictly cheaper, so at least
                # one survives the filter
                mask = mask & ~capped
            node = _Node(mask=mask, used=enc.pool_overhead[pool] + req)
            node.assign[gi] = 1
            nodes.append(node)
    return nodes, unschedulable
