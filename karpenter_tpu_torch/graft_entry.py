"""The port's counterpart of the JAX package's `__graft_entry__.entry()`.

`entry()` returns the dense packing step B7 (`solver.pack_dense.pack`)
with example arguments: the benchmark problem at 64 pods x 8 instance
types (seed 7), grouped and encoded by this package, with an empty
existing-node block, on a node axis of 128 rows. Call it as

    fn, args = entry()          # the card (raises without CUDA)
    outs = fn(*args)            # assign, node_mask, node_used,
                                # node_active, node_count, unsched

or `entry(device="cpu")` for the plain version. The arguments carry the
dtypes the JAX entry's arrays have (bool, float32, int32).

`dryrun_multichip(n)` is the counterpart of the JAX
`__graft_entry__.dryrun_multichip`: the split solve (B8) on a mesh of n
shards, held to the unsplit solve at bench scale.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.pack import pack
from karpenter_tpu_torch.solver.solver import resolve_device
from karpenter_tpu_torch.workloads import build_problem

MAX_NODES = 128


def _example_problem(n_pods: int = 64, n_types: int = 8,
                     reservations: bool = False):
    pods, pools = build_problem(n_pods, n_types, seed=7, reservations=reservations)
    return encode(group_pods(pods), pools)


def same_solution(a, b) -> bool:
    """Used-row PackResult equality (the JAX `_same_solution`): the
    node-axis size may differ between calls, the placement in the used
    rows may not."""
    n = a.node_count
    if n != b.node_count:
        return False
    return (
        np.array_equal(a.assign[:n], b.assign[:n])
        and np.array_equal(a.node_mask[:n], b.node_mask[:n])
        and np.array_equal(a.unschedulable, b.unschedulable)
    )


def dryrun_multichip(n_devices: int, device: torch.device | str | None = None,
                     n_pods: int = 10_000, n_types: int = 200) -> dict:
    """The split solve paths over a mesh of `n_devices` shards at bench
    scale — 10k diverse pods against a 200-type catalog with capacity
    reservations (the JAX dryrun's problem):

    1. FFD, shards=n against shards=1: identical assignment;
    2. the cost objective (column-generation plan + planned pack),
       shards=n against shards=1: identical assignment, and every pod
       placed.

    `device=None` is the card; the function asks for a virtual mesh of
    n shard slots on it (`force_virtual_mesh`), as the JAX function pins
    `force_cpu_mesh(n)`, and restores the caller's mesh on return. The
    JAX dryrun's third pass, through the gRPC solver service, waits for
    the service's port (ROADMAP item 8).
    Returns the node counts and unschedulable pods of both passes."""
    from karpenter_tpu_torch.solver import lp_plan
    from karpenter_tpu_torch.solver.pack import solve_packing
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh, virtual_mesh

    dev = resolve_device(device)
    before = virtual_mesh()
    force_virtual_mesh(n_devices)
    try:
        enc = _example_problem(n_pods, n_types, reservations=True)

        sharded = solve_packing(enc, mode="ffd", device=dev, shards=n_devices)
        assert int(sharded.assign.sum()) > 0, "multichip dryrun scheduled nothing"
        # shards=1 pins the baseline: 0 would inherit KARPENTER_SOLVER_SHARDS
        single = solve_packing(enc, mode="ffd", device=dev, shards=1)
        assert same_solution(single, sharded), (
            "sharded FFD solve diverged from single-device solve")

        plan = lp_plan.plan(enc, device=dev)
        assert plan is not None, "LP planner produced no plan at dryrun scale"
        cost_sharded = solve_packing(enc, mode="cost", plan=plan, device=dev,
                                     shards=n_devices)
        cost_single = solve_packing(enc, mode="cost", plan=plan, device=dev, shards=1)
        assert same_solution(cost_single, cost_sharded), (
            "sharded cost solve diverged from single-device solve")
        assert int(cost_sharded.unschedulable.sum()) == 0, (
            "cost dryrun left pods unschedulable")
        return {
            "shards": n_devices,
            "ffd_nodes": int(sharded.node_count),
            "cost_nodes": int(cost_sharded.node_count),
            "planned_rows": int(len(plan.planned_cols)),
            "unschedulable": int(sharded.unschedulable.sum()),
        }
    finally:
        force_virtual_mesh(before)


def entry(device: torch.device | str | None = None):
    """(fn, args): `fn` is `pack` with max_nodes=128, `args` its nine
    positional tensors on `device` (None: the card)."""
    dev = resolve_device(device)
    enc = _example_problem()
    C = enc.compat.shape[1]
    existing_mask = np.zeros((enc.n_existing, C), dtype=bool)
    arrays = (
        (enc.compat, np.bool_), (enc.group_req, np.float32),
        (enc.group_count, np.int32), (enc.cfg_alloc, np.float32),
        (enc.cfg_pool, np.int32), (enc.pool_overhead, np.float32),
        (existing_mask, np.bool_), (enc.existing_used, np.float32),
        (enc.cfg_price, np.float32),
    )
    args = tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
        for a, dt in arrays)
    return functools.partial(pack, max_nodes=MAX_NODES), args
