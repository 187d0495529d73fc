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


def _example_problem(n_pods: int = 64, n_types: int = 8):
    pods, pools = build_problem(n_pods, n_types, seed=7)
    return encode(group_pods(pods), pools)


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
