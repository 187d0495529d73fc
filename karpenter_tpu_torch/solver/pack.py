"""Host side of the provisioning pack: staging, node-axis sizing and the
flat-buffer decode around the packing kernels.

Copy of the host half of `karpenter_tpu/solver/pack.py`
(`PackResult`, the shape buckets, `_estimate_nodes`, the node-axis
retry of `solve_packing_async` as a synchronous loop, `_run_pack`'s
bound-block staging, the wavefront routing, the uint32 decode of its
`fetch`, the consolidation probes' lane width and lane bucket, and the
shard resolution and per-shard staging of a split solve).
The kernels themselves are in `pack_split.py`: B1
`pack_split`, B3 `pack_split_wavefront` and B2 `pack_flat_words`,
which run on the tensors' device — the hand-written CUDA kernels on a
GPU, their plain versions on the CPU; their split versions (B8, the
config axis over S shards) are in `pack_shard.py`.

Shards: `solve_packing(..., shards=S)` (or KARPENTER_SOLVER_SHARDS)
splits the config axis over a mesh of S shards (`_mesh`). The visible
devices are the real ones unless `utils.platform.force_virtual_mesh`
asked for S shard slots on the one device of the solve, the port's
counterpart of the JAX package's `force_cpu_mesh`. An explicit `shards`
beyond the visible devices raises; the env default falls back to the
unsharded solve with a warning (the JAX rule). A mesh over several real
cards raises: that launch is ROADMAP item 10. The dense kernel B7 (`pack`,
`pack_flat`, in `pack_dense.py`) is re-exported here, where the JAX
package defines it.

Determinism: every kernel choice is an index-tie-broken arg-reduction
over a static axis, so a solve is bit-reproducible and equal to the
JAX package's on the same encoded input.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.solver.encode import Encoded
from karpenter_tpu_torch.solver.pack_dense import pack, pack_flat  # noqa: F401
from karpenter_tpu_torch.solver import stream as stream_mod
from karpenter_tpu_torch.solver.pack_shard import pack_split_flat_sharded
from karpenter_tpu_torch.solver.pack_split import pack_split_flat
from karpenter_tpu_torch.utils.platform import real_devices, virtual_mesh


@dataclass(frozen=True)
class Mesh:
    """The devices of a split solve, one per shard (a virtual mesh
    repeats the one device of the solve)."""

    devices: tuple
    # True for every mesh `_mesh` builds today; the launch over several
    # cards (ROADMAP item 10) is to read it to tell real cards from shard
    # slots on one device
    virtual: bool

    @property
    def shards(self) -> int:
        return len(self.devices)


def _mesh(shards: int, device: str = "cuda") -> Mesh:
    """The mesh of `shards` shards for a solve on `device`: on a
    virtual mesh (`force_virtual_mesh`) every shard is that device;
    otherwise the visible devices of its kind. Raises when fewer are
    visible, and for a mesh over several real cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    visible = visible_devices(0, dev)
    if visible < shards:
        raise ValueError(
            f"{shards} solver shards requested but only {visible} devices visible"
        )
    if virtual_mesh():
        return Mesh(devices=(dev,) * shards, virtual=True)
    raise NotImplementedError(
        f"a mesh of {shards} shards over {shards} real {dev.type} devices: the "
        "launch over several cards is ROADMAP item 10 (peer memory at system "
        "scope or NCCL between launches); use force_virtual_mesh for shard "
        "slots on one device")


def default_shards() -> int:
    """Shard count the framework paths inherit (0 = unsharded)."""
    try:
        return int(os.environ.get("KARPENTER_SOLVER_SHARDS", "0") or 0)
    except ValueError:
        return 0


# the last shard resolution: the shards the last solve ran with (1 =
# unsharded) and the devices visible then (the JAX package keeps the
# same record behind a gauge)
_shards_observed = {"effective": 0, "devices": 0}


def last_resolved_shards() -> dict:
    """{"effective", "devices"} of the last solve; 0s before any."""
    return dict(_shards_observed)


def visible_devices(default: int = 1, device=None) -> int:
    """The shard slots a solve on `device` may split over: the forced
    virtual mesh, else the real devices of its kind (`default` when the
    runtime cannot say)."""
    n = virtual_mesh()
    if n:
        return n
    try:
        return real_devices(device)
    except Exception:
        return default


def _observe_shards(effective: int, device=None) -> None:
    _shards_observed["effective"] = effective if effective > 1 else 1
    _shards_observed["devices"] = visible_devices(0, device)


def resolve_shards(shards: int, device) -> int:
    """`shards` as the JAX package resolves it (pack.py:1479-1496): 0
    takes KARPENTER_SOLVER_SHARDS, which falls back to unsharded, with a
    warning, when it exceeds the visible devices; an explicit count is
    kept (and `_mesh` raises if it cannot be met)."""
    if shards == 0:
        shards = default_shards()
        if shards > 1:
            visible = visible_devices(1, device)
            if shards > visible:
                logging.getLogger("karpenter.solver").warning(
                    "KARPENTER_SOLVER_SHARDS=%d exceeds %d visible devices; "
                    "running unsharded", shards, visible,
                )
                shards = 0
    _observe_shards(shards, device)
    return shards if shards > 1 else 0


@dataclass
class PackResult:
    assign: np.ndarray        # [N, G] int32 pods of group g on node n
    node_mask: np.ndarray     # [N, C] bool configs remaining per node
    node_used: np.ndarray     # [N, R] float64 (exact host recompute)
    node_active: np.ndarray   # [N] bool
    node_count: int
    unschedulable: np.ndarray  # [G] int32 pods that found no placement
    # outer-loop device steps the solve executed (sequential: one per
    # padded group; wavefront: one per committed round) and, for
    # wavefront solves, the groups committed per round
    device_steps: int = 0
    wavefront_widths: np.ndarray | None = None


# unrecognized KARPENTER_WAVEFRONT spellings already warned about
_warned_wavefront: set[str] = set()


def wavefront_width(device: torch.device | str) -> int:
    """Resolve the KARPENTER_WAVEFRONT knob into a lane width (0 =
    sequential) for a solve on `device`.

    Unset / "1" / "on" / "auto" is device-aware auto: the wavefront
    kernel on the card, the sequential one on the CPU (the JAX
    package's rule for its backends). "0"/"off" disables everywhere;
    "force" (or an integer >= 2, which is the width) enables on any
    device. KARPENTER_WAVEFRONT_WIDTH overrides the default width (16)
    without forcing the device choice."""
    raw = os.environ.get("KARPENTER_WAVEFRONT", "auto").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return 0
    width = 0
    force = raw == "force"
    if raw not in ("", "1", "on", "true", "yes", "auto", "force"):
        try:
            width = int(raw)
            if width <= 0:
                # a non-positive width can only mean "off"
                return 0
        except ValueError:
            # unrecognized spelling: auto, said once per spelling
            if raw not in _warned_wavefront:
                _warned_wavefront.add(raw)
                logging.getLogger("karpenter.solver").warning(
                    "unrecognized KARPENTER_WAVEFRONT=%r; using auto "
                    "(the card on, the CPU sequential — use 0/off to "
                    "disable, force or an integer width to enable)", raw,
                )
            width = 0
        force = width > 1
    if width == 0:
        wraw = os.environ.get("KARPENTER_WAVEFRONT_WIDTH", "").strip()
        if wraw:
            try:
                width = max(0, int(wraw))
            except ValueError:
                width = 0
    if width == 0:
        width = 16
    if not force and torch.device(device).type != "cuda":
        return 0
    return 0 if width <= 1 else width


# Below this many real groups the sequential loop wins: a wavefront
# round plans `width` lanes to commit at most the groups that remain,
# so a tiny solve pays the fan-out without amortizing it.
WAVEFRONT_MIN_GROUPS = 8


def wavefront_plan(n_groups: int, device: torch.device | str) -> int:
    """Wavefront width for a solve over `n_groups` real groups on
    `device`; 0 routes the sequential kernel (knob off, or the solve is
    too small to amortize the fan-out)."""
    if n_groups < WAVEFRONT_MIN_GROUPS:
        return 0
    return wavefront_width(device)


def _pad_axis(n: int, base: int = 16) -> int:
    """1.25x-spaced shape buckets (identical to the JAX package's, so
    the padded shapes of both packages match)."""
    out = base
    while out < n:
        out = (out * 5 + 3) // 4
    return out


def _bucket(n: int) -> int:
    """Node-axis bucket: 1.25x spacing from 32."""
    return _pad_axis(n, base=32)


def probe_batch_width(device: torch.device | str) -> int:
    """Consolidation probe lanes per dispatch
    (KARPENTER_PROBE_BATCH_WIDTH). Unset, the width follows the device,
    as the JAX package's follows its backend: 64 on the card, whose
    lane kernels run the lanes in parallel, and 1 on the CPU, whose
    plain versions run them one after another anyway."""
    raw = os.environ.get("KARPENTER_PROBE_BATCH_WIDTH", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return 64 if torch.device(device).type == "cuda" else 1


def _lane_bucket(n: int) -> int:
    """Lane-axis bucket (KARPENTER_PROBE_LANE_BUCKET sets the base, 8):
    lanes pad to the same 1.25x-spaced family as the node axis; padded
    lanes carry no demand and no live rows."""
    try:
        base = max(1, int(os.environ.get("KARPENTER_PROBE_LANE_BUCKET", "8")))
    except ValueError:
        base = 8
    return _pad_axis(n, base=base)


# problem-shape signature -> node-axis bucket that fit last time
_axis_memory: dict[tuple, int] = {}
_axis_lock = threading.Lock()


def _estimate_nodes(enc: Encoded) -> int:
    """Lower bound on fresh nodes: per group, count / best-config
    capacity, summed. The packer retries with a larger axis if the
    estimate proves too tight (cap detection in solve_packing)."""
    launchable = enc.cfg_pool >= 0
    total = 0
    for gi in range(enc.compat.shape[0]):
        mask = enc.compat[gi] & launchable
        count = int(enc.group_count[gi])
        if not mask.any() or count == 0:
            continue
        req = enc.group_req[gi]
        safe_req = np.where(req > 0, req, 1.0)
        per_node = np.floor((enc.cfg_alloc[mask] + 1e-4) / safe_req[None, :])
        per_node = np.where(req[None, :] > 0, per_node, np.inf).min(axis=1)
        best = max(1.0, float(per_node.max()) if per_node.size else 1.0)
        total += -(-count // int(best))
    return total


def _bound_rows(enc: Encoded, plan=None):
    """The bound block's rows, as the JAX `solve_packing_async` builds
    them: the existing nodes (one-hot on their pseudo-config columns),
    then with a `plan` (lp_plan.FleetPlan) one pre-opened row per
    planned node on its config column, its usage the pool's overhead
    and its per-group quota the plan's. Returns (mask [E+Np, C],
    used [E+Np, R], quota [E+Np, G] int32 or None)."""
    G, C = enc.compat.shape
    E = enc.n_existing
    n_planned = len(plan.planned_cols) if plan is not None else 0
    existing_mask = np.zeros((E + n_planned, C), dtype=bool)
    for ci, cfg in enumerate(enc.configs):
        if cfg.existing_index >= 0:
            existing_mask[cfg.existing_index, ci] = True
    existing_used = enc.existing_used
    existing_rows = (
        enc.existing_quota.astype(np.int32)
        if enc.existing_quota is not None
        else np.full((E, G), np.iinfo(np.int32).max, np.int32)
    )
    quota = existing_rows if enc.existing_quota is not None else None
    if plan is not None:
        existing_mask[E + np.arange(n_planned), plan.planned_cols] = True
        planned_used = enc.pool_overhead[enc.cfg_pool[plan.planned_cols]]
        existing_used = np.concatenate([enc.existing_used, planned_used], axis=0)
        quota = np.concatenate([existing_rows, plan.planned_quota], axis=0)
    return existing_mask, existing_used, quota


def _axis_key(enc: Encoded, mode: str, existing_used: np.ndarray,
              reserved_p: int, plan=None) -> tuple:
    """Repeated solves of the same problem reuse the node axis that
    worked last time; the key fingerprints the demand content and the
    planned rows."""
    G, C = enc.compat.shape
    fingerprint = (
        zlib.crc32(enc.group_count.tobytes())
        ^ zlib.crc32(enc.group_req.tobytes())
        ^ zlib.crc32(existing_used.tobytes())
        ^ (zlib.crc32(plan.planned_cols.tobytes()) if plan is not None else 0)
    )
    return (G, C, int(enc.group_count.sum()), mode, plan is not None,
            reserved_p, fingerprint)


def node_axis(enc: Encoded, mode: str = "ffd", plan=None) -> int:
    """The node axis (bound block plus fresh rows) the next solve of
    `enc` starts from: the one remembered from the last solve of the
    same problem, else a bucketed estimate (with a plan, whose rows
    cover the bulk, the fresh axis only takes the rounding spill)."""
    _, existing_used, _ = _bound_rows(enc, plan)
    reserved = existing_used.shape[0]
    reserved_p = _pad_axis(reserved) if reserved else 0
    with _axis_lock:
        remembered = _axis_memory.get(
            _axis_key(enc, mode, existing_used, reserved_p, plan))
    if remembered is not None:
        return remembered
    estimate = _estimate_nodes(enc)
    if plan is not None:
        return reserved_p + _bucket(max(32, estimate // 8 + 8))
    total_pods = int(enc.group_count.sum())
    # the fresh axis is bucketed separately from the padded bound block
    fresh = max(32, int(1.35 * estimate) + 16)
    return reserved_p + _bucket(min(fresh, max(64, total_pods)))


def solve_packing(enc: Encoded, mode: str = "ffd", plan=None,
                  device: torch.device | str = "cuda",
                  shards: int = 0) -> PackResult:
    """Host entry: run the packing kernels on the encoded problem.

    With a `plan` (lp_plan.FleetPlan), the planned nodes are pre-opened
    after the existing ones as bound rows on their config column, each
    with the plan's per-group quotas; the fresh rows take the spill.

    The node axis is sized from a per-group capacity estimate (or the
    axis remembered from the last solve of the same problem), rounded
    to 1.25x-spaced buckets, and grown on a cap hit: when every row of
    the axis opened and pods are still unschedulable, the solve runs
    again on a larger axis.

    With `shards > 1` (or KARPENTER_SOLVER_SHARDS set) the config axis
    is split over a mesh of that many shards (`_mesh`) and the split
    kernels run; the result is identical to the unsharded solve's.
    """
    device = torch.device(device)
    shards = resolve_shards(shards, device)
    existing_mask, existing_used, quota = _bound_rows(enc, plan)
    reserved = existing_mask.shape[0]
    # the kernel sees the bound block padded to its shape bucket, so
    # fresh nodes open at the padded offset
    reserved_p = _pad_axis(reserved) if reserved else 0

    total_pods = int(enc.group_count.sum())
    axis_key = _axis_key(enc, mode, existing_used, reserved_p, plan)
    max_nodes = node_axis(enc, mode, plan)
    worst_case = reserved_p + total_pods
    while True:
        result = _run_pack(
            enc, existing_mask, existing_used, max_nodes, mode, quota, device,
            shards,
        )
        capped = (
            result.node_count >= max_nodes
            and result.unschedulable.sum() > 0
        )
        if not capped or max_nodes > worst_case:
            if not capped:
                with _axis_lock:
                    if len(_axis_memory) > 256:
                        _axis_memory.clear()
                    # remember a tight axis from the fresh node count
                    # actually used
                    fresh_used = max(0, result.node_count - reserved_p)
                    _axis_memory[axis_key] = reserved_p + _bucket(
                        int(fresh_used * 1.15) + 16
                    )
            return result
        # grow proportionally to the observed density
        scheduled = total_pods - int(result.unschedulable.sum())
        if scheduled > 0:
            needed = int(result.node_count * total_pods / scheduled * 1.2)
        else:
            needed = max_nodes * 2
        needed = min(needed, worst_case + 1)
        max_nodes = _bucket(max(needed, max_nodes + 1))


@dataclass
class Staged:
    """Padded kernel inputs of one attempt, as numpy, plus what the
    decode needs. `args` are the positional arguments of `pack_split`
    in order; `kwargs` its optional inputs (None when absent)."""

    args: tuple
    kwargs: dict
    max_free: int
    N: int
    Gp: int
    Cp: int
    Ep: int
    bound_cfg: np.ndarray
    bound_live: np.ndarray
    bound_used: np.ndarray
    cfg_pool: np.ndarray
    cfg_rsv: np.ndarray       # [Cp] int32, -1 without a reservation


def config_width(Cp: int, shards: int = 0) -> int:
    """The kernels' config axis: a multiple of 32 (the mask words of
    the flat output), and with `shards > 1` of lcm(32, shards), so that
    it also splits evenly over the shards (pack.py:1693-1694 of the JAX
    package)."""
    step = math.lcm(32, shards) if shards > 1 else 32
    return -(-Cp // step) * step


def stage(enc: Encoded, existing_mask: np.ndarray, existing_used: np.ndarray,
          max_nodes: int, quota: np.ndarray | None = None, shards: int = 0,
          config_axis: bool = True) -> Staged:
    """Pad the encoded problem to its shape buckets and flatten the
    one-hot existing rows into the bound block (`_run_pack`'s staging
    in the JAX package, value for value). With `shards > 1` the config
    axis pads to a multiple of lcm(32, shards); with `config_axis`
    False the padded compat, cfg_alloc and cfg_price are not built (the
    streaming staging builds them shard by shard) and stand as None."""
    # int32 width guard: the kernel state, the flat transport and the
    # decode carry pod counts in 32 bits
    total_demand = int(np.asarray(enc.group_count, np.int64).sum())
    if total_demand >= 2**31:
        raise ValueError(
            f"total pod demand {total_demand} exceeds the solver's "
            "int32 range (2^31-1); split the solve"
        )
    G, C = enc.compat.shape
    R = enc.group_req.shape[1]
    E = existing_mask.shape[0]
    Gp, Cp, Ep = _pad_axis(G), _pad_axis(C), _pad_axis(E) if E else 0
    Cp = config_width(Cp, shards)
    N = max_nodes
    assert N >= Ep, (N, Ep)
    F = N - Ep

    group_req = np.zeros((Gp, R), np.float32)
    group_req[:G] = enc.group_req
    group_count = np.zeros((Gp,), np.int32)
    group_count[:G] = enc.group_count
    cfg_pool = np.full((Cp,), -1, np.int32)
    cfg_pool[:C] = enc.cfg_pool
    compat = cfg_alloc = cfg_price = None
    if config_axis:
        compat = np.zeros((Gp, Cp), bool)
        compat[:G, :C] = enc.compat
        cfg_alloc = np.zeros((Cp, R), np.float32)
        cfg_alloc[:C] = enc.cfg_alloc
        cfg_price = np.zeros((Cp,), np.float32)
        cfg_price[:C] = enc.cfg_price

    # ---- bound block: one-hot rows flattened to per-row vectors
    bound_cfg = np.full((Ep,), -1, np.int32)
    bound_used = np.zeros((Ep, R), np.float32)
    if E:
        any_col = existing_mask.any(axis=1)
        assert (existing_mask.sum(axis=1) <= 1).all()
        bound_cfg[:E] = np.where(any_col, existing_mask.argmax(axis=1), -1)
        bound_used[:E] = existing_used
    bound_live = bound_cfg >= 0
    safe_cfg = np.maximum(bound_cfg, 0)
    bound_alloc = np.where(
        bound_live[:, None], enc.cfg_alloc[safe_cfg], 0.0
    ).astype(np.float32)
    bound_compat = np.zeros((Gp, Ep), bool)
    if Ep:
        bound_compat[:G, :] = enc.compat[:, safe_cfg] & bound_live[None, :]

    bound_quota = None
    if quota is not None:
        # int16: per-node pod counts are bounded by the 'pods' capacity,
        # so 32767 is an honest "no cap"; the kernel widens to int32
        bound_quota = np.full((Ep, Gp), np.int16(32767), np.int16)
        bound_quota[: quota.shape[0], :G] = np.minimum(
            quota[:, :G], 32767
        ).astype(np.int16)
        if enc.group_cap is not None:
            bound_quota[:, :G] = np.minimum(
                bound_quota[:, :G],
                np.minimum(enc.group_cap, 32767)[None, :].astype(np.int16),
            )
    group_cap = None
    if enc.group_cap is not None:
        group_cap = np.full((Gp,), np.iinfo(np.int32).max, np.int32)
        group_cap[:G] = enc.group_cap
    conflict = None
    if enc.conflict is not None and enc.conflict.any():
        conflict = np.zeros((Gp, Gp), bool)
        conflict[:G, :G] = enc.conflict
    cfg_rsv = np.full((Cp,), -1, np.int32)
    rsv_cap = None
    K = 0
    if enc.rsv_cap is not None and enc.rsv_cap.size:
        K = int(enc.rsv_cap.size)
        cfg_rsv[:C] = enc.cfg_rsv
        rsv_cap = enc.rsv_cap.astype(np.float32)
    bound_slot = np.where(
        bound_live & (cfg_rsv[safe_cfg] >= 0), cfg_rsv[safe_cfg], K
    ).astype(np.int32)

    args = (
        compat, group_req, group_count, cfg_alloc, cfg_pool,
        np.ascontiguousarray(enc.pool_overhead, dtype=np.float32),
        bound_compat, bound_alloc, bound_used, bound_slot, bound_live,
        cfg_price,
    )
    kwargs = {
        "bound_quota": bound_quota,
        "cfg_rsv": cfg_rsv if K else None,
        "rsv_cap": rsv_cap,
        "group_cap": group_cap,
        "conflict": conflict,
    }
    return Staged(args=args, kwargs=kwargs, max_free=F, N=N, Gp=Gp, Cp=Cp,
                  Ep=Ep, bound_cfg=bound_cfg, bound_live=bound_live,
                  bound_used=bound_used, cfg_pool=cfg_pool, cfg_rsv=cfg_rsv)


# positions of pack_split's config-axis inputs and the axis each splits on
_CONFIG_ARGS = {0: 1, 3: 0, 4: 0, 11: 0}


def to_mesh(staged: Staged, enc: Encoded, mesh: Mesh, stream: bool
            ) -> tuple[list, dict]:
    """The staged arrays as a split solve's inputs: each config-axis
    input (compat, cfg_alloc, cfg_pool, cfg_price, and cfg_rsv, padded
    with -1 for reservation-free solves too) as a list of per-shard
    column blocks, each its own allocation on its shard's device; the
    rest replicated on the mesh's device. `stream` builds the blocks
    shard by shard from the encode (`stream.stage`), without the padded
    matrices; otherwise they are cut from the staged ones."""
    dev = mesh.devices[0]
    S = mesh.shards
    G, C = enc.compat.shape
    R = enc.group_req.shape[1]
    Gp, Cp = staged.Gp, staged.Cp

    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    args = [None if i in _CONFIG_ARGS else put(x) for i, x in enumerate(staged.args)]
    kwargs = {k: put(v) for k, v in staged.kwargs.items() if k != "cfg_rsv"}
    if kwargs["rsv_cap"] is None:
        kwargs["rsv_cap"] = torch.zeros((0,), dtype=torch.float32, device=dev)
    devices = list(mesh.devices)
    if stream:
        staging = stream_mod._Staging()
        args[0] = stream_mod.stage(devices, 1, (Gp, Cp), np.bool_, stream_mod.col_fill_2d(
            enc.compat, Gp, G, C, np.bool_), staging)
        args[3] = stream_mod.stage(devices, 0, (Cp, R), np.float32, stream_mod.row_fill_2d(
            enc.cfg_alloc, R, C, np.float32), staging)
        args[4] = stream_mod.stage(devices, 0, (Cp,), np.int32, stream_mod.vec_fill(
            enc.cfg_pool, C, np.int32, pad_value=-1), staging)
        args[11] = stream_mod.stage(devices, 0, (Cp,), np.float32, stream_mod.vec_fill(
            enc.cfg_price, C, np.float32), staging)
        rsv_src = (enc.cfg_rsv if enc.rsv_cap is not None and enc.rsv_cap.size
                   else np.full((C,), -1, np.int32))
        kwargs["cfg_rsv"] = stream_mod.stage(devices, 0, (Cp,), np.int32, stream_mod.vec_fill(
            rsv_src, C, np.int32, pad_value=-1), staging)
        staging.commit()
    else:
        for i, axis in _CONFIG_ARGS.items():
            args[i] = [torch.from_numpy(np.ascontiguousarray(b)).to(d, copy=True)
                       for b, d in zip(np.split(staged.args[i], S, axis=axis), devices)]
        kwargs["cfg_rsv"] = [torch.from_numpy(np.ascontiguousarray(b)).to(d, copy=True)
                             for b, d in zip(np.split(staged.cfg_rsv, S), devices)]
    return args, kwargs


def to_device(staged: Staged, device: torch.device) -> tuple[tuple, dict]:
    """The staged arrays as tensors on `device`."""
    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (
        tuple(put(x) for x in staged.args),
        {k: put(v) for k, v in staged.kwargs.items()},
    )


def _run_pack(
    enc: Encoded,
    existing_mask: np.ndarray,
    existing_used: np.ndarray,
    max_nodes: int,
    mode: str = "ffd",
    quota: np.ndarray | None = None,
    device: torch.device = torch.device("cuda"),
    shards: int = 0,
) -> PackResult:
    """One kernel attempt: stage, launch, and decode the flat buffer
    into a PackResult. With `shards > 1` the config axis is split over
    `_mesh(shards)` and the split kernels run (streaming staging unless
    KARPENTER_STREAM_ENCODE=0); the flat buffer is the same."""
    G, C = enc.compat.shape
    # judged on the real group count: padding groups carry no demand
    # and are committed before the first round
    wf = wavefront_plan(G, device)
    if shards > 1:
        mesh = _mesh(shards, str(device))
        stream_on = stream_mod.enabled()
        staged = stage(enc, existing_mask, existing_used, max_nodes, quota,
                       shards=shards, config_axis=not stream_on)
        args, kwargs = to_mesh(staged, enc, mesh, stream_on)
        flat_dev = pack_split_flat_sharded(
            *args, max_free=staged.max_free, mode=mode, wavefront=wf, **kwargs
        )
    else:
        staged = stage(enc, existing_mask, existing_used, max_nodes, quota)
        args, kwargs = to_device(staged, device)
        flat_dev = pack_split_flat(
            *args, max_free=staged.max_free, mode=mode, wavefront=wf, **kwargs
        )
    R = enc.group_req.shape[1]
    N, Gp, Ep, F = staged.N, staged.Gp, staged.Ep, staged.max_free
    W = staged.Cp // 32
    group_req_h = enc.group_req.astype(np.float32)
    pool_overhead_h = enc.pool_overhead

    # the one device-to-host copy; the buffer holds uint32 words
    flat = flat_dev.cpu().numpy().view(np.uint32)
    o0 = N * Gp
    o1 = o0 + F * W
    assign = flat[:o0].reshape(N, Gp)[:, :G].astype(np.int32)
    node_mask = np.zeros((N, C), bool)
    if Ep:
        # bound rows: one-hot reconstruction from the host-side
        # config vector (the kernel never tightens a one-hot row)
        rows = np.flatnonzero(staged.bound_live)
        node_mask[rows, staged.bound_cfg[rows]] = True
    if F:
        words = np.ascontiguousarray(flat[o0:o1].reshape(F, W))
        bits = np.unpackbits(
            words.view(np.uint8).reshape(F, W * 4), axis=1,
            bitorder="little",
        )
        node_mask[Ep:] = bits[:, :C].astype(bool)
    node_count = int(flat[o1])
    unsched = flat[o1 + 1 : o1 + 1 + Gp][:G].astype(np.int32)
    # device-step accounting: the sequential kernel runs one step per
    # padded group; the wavefront buffer carries its per-round widths
    # and round count after the sequential layout
    if wf > 1:
        o2 = o1 + 1 + Gp
        steps = int(flat[o2 + Gp])
        wf_widths = flat[o2 : o2 + Gp][:steps].astype(np.int32)
    else:
        steps = Gp
        wf_widths = None
    # node_active / node_used are pure functions of the shipped
    # state: active = holds pods or is a live existing slot; used =
    # base (existing usage / fresh pool overhead) + the placed pods'
    # requests, summed exactly in float64
    node_active = assign.sum(axis=1) > 0
    if Ep:
        node_active[:Ep] |= staged.bound_live
    base = np.zeros((N, R), np.float64)
    if Ep:
        base[:Ep] = staged.bound_used
    fresh = node_active.copy()
    fresh[:Ep] = False
    if fresh.any():
        first_col = node_mask[fresh].argmax(axis=1)
        base[fresh] = pool_overhead_h[staged.cfg_pool[first_col]]
    node_used = base + assign.astype(np.float64) @ group_req_h.astype(np.float64)
    return PackResult(
        assign=assign,
        node_mask=node_mask,
        node_used=node_used,
        node_active=node_active,
        node_count=node_count,
        unschedulable=unsched,
        device_steps=steps,
        wavefront_widths=wf_widths,
    )
