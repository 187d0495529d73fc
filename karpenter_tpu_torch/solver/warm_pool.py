"""The kernel warm pool: build, load and launch the solver's kernels
before the first solve needs them.

Counterpart of `karpenter_tpu/solver/warm_pool.py`, with its shape
buckets, knobs, metric and contract: `MODES`, `DEFAULT_SHAPES`,
`DEFAULT_PROBE_SHAPES`, `shapes_from_env` (KARPENTER_WARM_SHAPES,
"G:C:E:N[:R[:P]];..."), `probe_shapes_from_env`
(KARPENTER_WARM_PROBE_SHAPES, "L:G:C:E:N[:R[:P]];..."), `warm_shards`
(KARPENTER_WARM_SHARDS), `bucket_args`, `warmed`, `rewarm_canary`,
`warm` and `start_background`; the `warm` fault site fires once a
bucket; `karpenter_solver_warm_compiles_total{outcome}` counts each
bucket; buckets run smallest first; the background thread is
non-daemon, its `stop` event registered with
`threading._register_atexit`.

What a bucket's "compile" is on the card. The JAX package
ahead-of-time compiles an XLA program per padded shape. The port's
kernels are built once per process from `csrc/` (`cuda_build`), so a
bucket here is:
1. `cuda_build.build_all()`: every library built, or loaded from
   `_build/` (the counterpart of the persistent compilation cache, its
   digests carrying `cuda_build.machine_tag()`);
2. the libraries loaded;
3. one canary launch of each kernel the bucket's route would run, at
   the bucket's padded shape, on a small problem (every real group
   one pod, every real config and bound row open to it), read back
   with one device-to-host copy: B1, and B3 where `wavefront_plan`
   gives the bucket's group count a width, each with B2 (`pack`
   buckets, in both modes, with and without the topology inputs); B6
   with its lane epilogue (probe buckets, ffd; on the CPU, one lane a
   dispatch, the solo diagonal of B1); B5 (`lp_device.warm`); and the
   split variants (B8) when KARPENTER_WARM_SHARDS > 1 shard slots are
   visible. CUDA loads a kernel's module lazily, at its first launch in
   the process: the canary pays it instead of the first solve.

A dual-ascent bucket whose padded shape B5 refuses on the card
(`lp_device.ascent_refusal`: past the wide layout's axes, a named limit
that no default bucket reaches; a solve of it raises there) is counted
`skipped` and logged, not launched.

No fallback through the warm pool: a failed bucket is counted
(`outcome="error"`) and logged, as in the JAX package, but it is never
marked warm, and nothing here swaps in a plain version: the first real
solve of that bucket still launches its kernel or raises. Each canary
bucket's first and latest walls are kept in `CANARIES`, one record of
plain numbers a bucket.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.utils.platform import caller_stream, on_stream

log = logging.getLogger("karpenter.solver.warmpool")

# (groups, configs, existing/bound rows, fresh node axis) per bucket,
# the JAX package's family
DEFAULT_SHAPES: tuple[tuple[int, int, int, int], ...] = (
    (16, 256, 0, 64),
    (64, 1024, 0, 512),
    (128, 4096, 0, 2048),
    (16, 1024, 1024, 64),
    (128, 4096, 0, 4096),
    (200, 4096, 0, 3200),
)

MODES = ("ffd", "cost")

# (lanes, groups, configs, existing/bound rows, fresh axis) buckets of
# the consolidation probe kernel B6; probes pack ffd only
DEFAULT_PROBE_SHAPES: tuple[tuple[int, int, int, int, int], ...] = (
    (8, 16, 256, 64, 32),
    (32, 32, 512, 512, 32),
)

# the kernel libraries a solve loads (the phase-clock builds are never
# loaded by a solve)
LIBRARIES = ("pack_split", "pack_wavefront", "pack_flat", "pack_dense",
             "lp_price", "lp_ascend")


def shapes_from_env(spec: Optional[str] = None) -> list[tuple]:
    """Parse KARPENTER_WARM_SHAPES ("G:C:E:N[:R[:P]];..."): R is the
    resource-axis width (default 4) and P the NodePool count (default
    1). Malformed entries are dropped."""
    spec = spec if spec is not None else os.environ.get(
        "KARPENTER_WARM_SHAPES", ""
    )
    if not spec:
        return list(DEFAULT_SHAPES)
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            fields = [int(x) for x in part.split(":")]
            if len(fields) < 4 or len(fields) > 6:
                raise ValueError(part)
            g, c, e, n = fields[:4]
            r = fields[4] if len(fields) > 4 else 4
            p = fields[5] if len(fields) > 5 else 1
            if g > 0 and c > 0 and e >= 0 and n > 0 and r > 0 and p > 0:
                out.append((g, c, e, n, r, p))
        except ValueError:
            log.warning("ignoring malformed warm shape %r", part)
    return out or list(DEFAULT_SHAPES)


def probe_shapes_from_env(spec: Optional[str] = None) -> list[tuple]:
    """Parse KARPENTER_WARM_PROBE_SHAPES ("L:G:C:E:N[:R[:P]];..."), the
    probe kernel's buckets; L is the lane count. Malformed entries are
    dropped."""
    spec = spec if spec is not None else os.environ.get(
        "KARPENTER_WARM_PROBE_SHAPES", ""
    )
    if not spec:
        return [s + (4, 1) for s in DEFAULT_PROBE_SHAPES]
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            fields = [int(x) for x in part.split(":")]
            if len(fields) < 5 or len(fields) > 7:
                raise ValueError(part)
            l, g, c, e, n = fields[:5]
            r = fields[5] if len(fields) > 5 else 4
            p = fields[6] if len(fields) > 6 else 1
            if l > 0 and g > 0 and c > 0 and e >= 0 and n > 0 and r > 0 and p > 0:
                out.append((l, g, c, e, n, r, p))
        except ValueError:
            log.warning("ignoring malformed probe warm shape %r", part)
    return out or [s + (4, 1) for s in DEFAULT_PROBE_SHAPES]


def warm_shards(device=None) -> int:
    """KARPENTER_WARM_SHARDS: the shard count the warm pool also
    launches each bucket's split kernels at. "auto" spans every visible
    shard slot; 0/unset skips them; a count above the visible slots is
    clamped to them."""
    raw = os.environ.get("KARPENTER_WARM_SHARDS", "").strip().lower()
    if not raw or raw in ("0", "off", "false", "no"):
        return 0
    from karpenter_tpu_torch.solver.pack import visible_devices

    visible = visible_devices(0, device)
    if visible == 0:
        return 0
    if raw == "auto":
        return visible if visible > 1 else 0
    try:
        want = int(raw)
    except ValueError:
        log.warning("ignoring malformed KARPENTER_WARM_SHARDS=%r", raw)
        return 0
    want = min(want, visible)
    return want if want > 1 else 0


# ---------------------------------------------------------------- canaries


def canary_staged(Gp: int, Cp: int, Ep: int, F: int, R: int, P: int,
                  real: Optional[tuple] = None, rsv_k: Optional[int] = None,
                  group_cap: bool = False, conflict: bool = False,
                  quota: bool = False):
    """One padded packing problem of a bucket, as `pack.stage` lays it
    out (`pack.Staged`): the first `real` = (G, C, E) groups, configs
    and bound rows are real (default: all of them), each group one pod
    of half a unit of every resource, every real config (pool 0, four
    units, prices rising with the column) and every live bound row open
    to it; `rsv_k` reservation rows of zero budget that no config
    names; the topology inputs without a cap, a conflict or a quota."""
    from karpenter_tpu_torch.solver.pack import Staged

    G, C, E = real if real is not None else (Gp, Cp, Ep)
    compat = np.zeros((Gp, Cp), bool)
    compat[:G, :C] = True
    group_req = np.zeros((Gp, R), np.float32)
    group_req[:G] = 0.5
    group_count = np.zeros((Gp,), np.int32)
    group_count[:G] = 1
    cfg_alloc = np.zeros((Cp, R), np.float32)
    cfg_alloc[:C] = 4.0
    cfg_pool = np.full((Cp,), -1, np.int32)
    cfg_pool[:C] = 0
    cfg_price = np.zeros((Cp,), np.float32)
    cfg_price[:C] = 1.0 + 0.01 * np.arange(C, dtype=np.float32)
    pool_overhead = np.zeros((P + 1, R), np.float32)
    K = int(rsv_k or 0)
    bound_compat = np.zeros((Gp, Ep), bool)
    bound_compat[:G, :E] = True
    bound_alloc = np.zeros((Ep, R), np.float32)
    bound_alloc[:E] = 4.0
    bound_used = np.zeros((Ep, R), np.float32)
    bound_live = np.zeros((Ep,), bool)
    bound_live[:E] = True
    bound_slot = np.full((Ep,), K, np.int32)
    bound_cfg = np.where(bound_live, 0, -1).astype(np.int32)
    cfg_rsv = np.full((Cp,), -1, np.int32)
    kwargs = {
        "bound_quota": (np.full((Ep, Gp), np.int16(32767), np.int16)
                        if quota and Ep else None),
        "cfg_rsv": cfg_rsv if rsv_k is not None else None,
        "rsv_cap": np.zeros((K,), np.float32) if rsv_k is not None else None,
        "group_cap": (np.full((Gp,), np.iinfo(np.int32).max, np.int32)
                      if group_cap else None),
        "conflict": np.zeros((Gp, Gp), bool) if conflict else None,
    }
    args = (compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
            bound_compat, bound_alloc, bound_used, bound_slot, bound_live, cfg_price)
    return Staged(args=args, kwargs=kwargs, max_free=F, N=Ep + F, Gp=Gp, Cp=Cp, Ep=Ep,
                  bound_cfg=bound_cfg, bound_live=bound_live, bound_used=bound_used,
                  cfg_pool=cfg_pool, cfg_rsv=cfg_rsv)


def bucket_args(
    Gp: int, Cp: int, Ep: int, R: int, P: int,
    shards: int = 0, rsv_k: Optional[int] = None,
    group_cap: bool = False, conflict: bool = False,
    quota: bool = False, device=None, real: Optional[tuple] = None,
) -> tuple[list, dict]:
    """The (args, kwargs) of one padded `pack_split_flat` bucket as
    tensors on `device` (None: the card): `canary_staged`'s problem,
    with the JAX package's shapes and dtypes argument for argument.
    With `shards > 1`, the split launch's inputs over the virtual mesh
    (each config-axis input a list of column blocks; reservation inputs
    always present, as the split solve passes them)."""
    from karpenter_tpu_torch.solver import pack
    from karpenter_tpu_torch.solver.solver import resolve_device

    dev = resolve_device(device)
    if shards > 1 and rsv_k is None:
        rsv_k = 0
    staged = canary_staged(Gp, Cp, Ep, 0, R, P, real, rsv_k, group_cap, conflict, quota)
    if shards > 1:
        args, kw = pack.to_mesh(staged, None, pack._mesh(shards, str(dev)), stream=False)
    else:
        args, kw = pack.to_device(staged, dev)
    return list(args), {k: v for k, v in kw.items() if v is not None}


# one record a canary bucket, keyed (kernel, bucket, shards, wavefront):
# {"kernel", "bucket", "shards", "wavefront", "launches" (the wrappers'
# launch counts its first launch added), "seconds" (that launch's host
# wall, launch to the copy back), "first" (no earlier canary of the same
# wrappers in this process), "runs" (its launches in this process),
# "last" (the latest launch's wall)}. Plain numbers only, and one record
# a bucket however often it launches again (`warm`, `rewarm_canary`):
# no tensor outlives its launch.
CANARIES: dict[tuple, dict] = {}
_seen_wrappers: set = set()


def _launch_counts() -> dict:
    from karpenter_tpu_torch.solver import lp_device
    from karpenter_tpu_torch.solver import pack_split as kernels

    return {**kernels.LAUNCHES, **lp_device.LAUNCHES}


def _canary(kernel: str, bucket: tuple, shards: int, wavefront: int, run) -> float:
    """Launch `run` once (it returns the output tensor), copy the output
    back, record the canary; returns its wall. A launch that counted
    nothing on a CUDA device is an error: the bucket did not launch."""
    before = _launch_counts()
    t0 = time.perf_counter()
    out = run()
    out.cpu()
    seconds = time.perf_counter() - t0
    after = _launch_counts()
    added = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    if out.is_cuda and not added:
        raise RuntimeError(f"warm canary {kernel} {bucket}: no kernel launched")
    key = (kernel, bucket, shards, wavefront)
    rec = CANARIES.get(key)
    if rec is None:
        wrappers = tuple(sorted(added))
        rec = CANARIES[key] = {
            "kernel": kernel, "bucket": bucket, "shards": shards, "wavefront": wavefront,
            "launches": added, "seconds": seconds, "runs": 0,
            "first": bool(wrappers) and wrappers not in _seen_wrappers}
        _seen_wrappers.add(wrappers)
    rec["runs"] += 1
    rec["last"] = seconds
    return seconds


def _pack_launch(staged, mode: str, wavefront: int, shards: int, dev):
    from karpenter_tpu_torch.solver import pack

    if shards > 1:
        args, kw = pack.to_mesh(staged, None, pack._mesh(shards, str(dev)), stream=False)
        launch = pack.pack_split_flat_sharded
    else:
        args, kw = pack.to_device(staged, dev)
        launch = pack.pack_split_flat
    return lambda: launch(*args, max_free=staged.max_free, mode=mode,
                          wavefront=wavefront, **kw)


def _compile_bucket(
    G: int, C: int, E: int, N: int, mode: str,
    R: int = 4, P: int = 1, topo: bool = False, shards: int = 0,
    device=None,
) -> None:
    """Launch the packing route of one padded bucket: the sequential
    program (B1 + B2), and the wavefront one (B3 + B2) when its group
    count takes a width, as a real solve of the bucket would (padding
    as `pack.stage`: `_pad_axis` groups, configs and bound rows, the
    config axis to a multiple of lcm(32, shards), the fresh axis a
    `_bucket`)."""
    from karpenter_tpu_torch.solver import faults, telemetry
    from karpenter_tpu_torch.solver.pack import (
        _bucket,
        _pad_axis,
        config_width,
        wavefront_plan,
    )
    from karpenter_tpu_torch.solver.solver import resolve_device

    faults.fire("warm")
    dev = resolve_device(device)
    Gp = _pad_axis(G)
    Cp = config_width(_pad_axis(C), shards)
    Ep = _pad_axis(E) if E else 0
    F = _bucket(max(N, 1))
    rsv_k = 0 if shards > 1 else None
    quota = topo and Ep > 0
    staged = canary_staged(Gp, Cp, Ep, F, R, P, (G, C, E), rsv_k, topo, topo, quota)
    wf = wavefront_plan(G, dev)
    for width in ((wf, 0) if wf > 1 else (0,)):
        bucket = (Gp, Cp, Ep, F, mode,
                  telemetry.variant_tag(width, rsv_k, topo, topo, quota))
        _canary("pack", bucket, shards, width,
                _pack_launch(staged, mode, width, shards, dev))
        telemetry.record_compiled(
            "pack", bucket,
            telemetry.pack_stated(Gp, Cp, Ep, F, R, P, width, rsv_k, topo, topo, quota),
            shards=shards)
    # only a bucket whose every route launched is warm
    compiled_buckets.add((Gp, Cp, Ep, F, mode, shards))


def _compile_probe_bucket(
    L: int, G: int, C: int, E: int, N: int, mode: str,
    R: int = 4, P: int = 1, device=None,
) -> None:
    """Launch the probe kernel(s) a real probe batch of this bucket
    would, padded as `consolidation_batch.LaneSolver` pads it. With one
    lane a dispatch (`probe_batch_width`, the CPU's default) that is the
    solo diagonal of B1 (G = 16<<k, F = 64<<k, and B3 where the level's
    real groups take a width); otherwise B6 over `_lane_bucket(L)`
    lanes with its lane epilogue, wavefront and sequential."""
    from karpenter_tpu_torch.solver import faults, telemetry
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver.pack import (
        _bucket,
        _lane_bucket,
        _pad_axis,
        probe_batch_width,
        wavefront_plan,
    )
    from karpenter_tpu_torch.solver.solver import resolve_device

    faults.fire("warm")
    dev = resolve_device(device)
    Cp = -(-_pad_axis(C) // 32) * 32
    Ep = _pad_axis(E) if E else 0
    if probe_batch_width(dev) == 1:
        k_max = 0
        while (16 << k_max) < max(G, 1):
            k_max += 1
        for k in range(k_max + 1):
            Gp, F = 16 << k, 64 << k
            g_real = min(G, Gp)
            staged = canary_staged(Gp, Cp, Ep, F, R, P, (g_real, C, E))
            wf = wavefront_plan(g_real, dev)
            for width in ((wf, 0) if wf > 1 else (0,)):
                bucket = (Gp, Cp, Ep, F, mode, telemetry.variant_tag(width))
                _canary("probe_solo", bucket, 0, width, _pack_launch(staged, mode, width, 0, dev))
                telemetry.record_compiled(
                    "probe_solo", bucket, telemetry.pack_stated(Gp, Cp, Ep, F, R, P, width))
        return
    Gp = _pad_axis(G)
    Lp = _lane_bucket(L)
    F = _bucket(max(N, 1))
    staged = canary_staged(Gp, Cp, Ep, F, R, P, (G, C, E))
    lane_counts = np.zeros((Lp, Gp), np.int32)
    lane_counts[:L] = staged.args[2]
    lane_live = np.zeros((Lp, Ep), bool)
    lane_live[:L] = staged.args[10]
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in staged.args]
    args[2] = torch.from_numpy(lane_counts).to(dev)
    args[10] = torch.from_numpy(lane_live).to(dev)
    wf = wavefront_plan(G, dev)
    for width in ((wf, 0) if wf > 1 else (0,)):
        bucket = (Lp, Gp, Cp, Ep, F, mode, telemetry.variant_tag(width))
        _canary("probe_lanes", bucket, 0, width,
                lambda width=width: kernels.pack_probe_lanes_flat(
                    *args, max_free=F, mode=mode, wavefront=width))
        telemetry.record_compiled(
            "probe_lanes", bucket,
            telemetry.pack_stated(Gp, Cp, Ep, F, R, P, width, lanes=Lp))


# padded (Gp, Cp, Ep, F, mode, shards) signatures whose canaries all
# launched in this process; read via `warmed` from pack's launch path
compiled_buckets: set[tuple] = set()


def warmed(Gp: int, Cp: int, Ep: int, F: int, mode: str,
           shards: int = 0) -> bool:
    """True when a warm-pool bucket launched this exact padded shape
    (the `warm_hit` attribute of a solve's compile span)."""
    return (Gp, Cp, Ep, F, mode, shards) in compiled_buckets


def reset() -> None:
    """Tests: forget the warmed buckets and the canary records."""
    compiled_buckets.clear()
    CANARIES.clear()
    _seen_wrappers.clear()


def _prepare(device) -> None:
    """Steps 1 and 2 of a bucket on the card: every library built (or
    found in `_build/`) and loaded. Nothing to build for the CPU."""
    if torch.device(device).type != "cuda":
        return
    from karpenter_tpu_torch import cuda_build

    cuda_build.build_all()
    for name in LIBRARIES:
        cuda_build.library(name)


def rewarm_canary(device=None) -> bool:
    """One canary launch of the smallest shape bucket (ffd, no
    topology) on `device` (None: the card), proving the kernels launch
    and read back again: the resilience ladder's gate on a device
    breaker's half-open -> closed transition under
    KARPENTER_REWARM_ON_CLOSE=1. Runs the `warm` fault site. An injected
    fault (or any failure off the card) is counted as an error and
    returns False; on a CUDA device any other failure is the card's code
    failing: it is counted and raised (`resilience.may_degrade`)."""
    from karpenter_tpu_torch.metrics.store import SOLVER_WARM_COMPILES
    from karpenter_tpu_torch.solver import resilience
    from karpenter_tpu_torch.solver.solver import resolve_device

    dev = resolve_device(device)
    try:
        _prepare(dev)
        _compile_bucket(*DEFAULT_SHAPES[0], "ffd", device=dev)
        SOLVER_WARM_COMPILES.inc({"outcome": "ok"})
        return True
    except Exception as err:
        SOLVER_WARM_COMPILES.inc({"outcome": "error"})
        if not resilience.may_degrade(err, dev):
            raise
        log.warning("re-warm canary failed: %s", err)
        return False


def warm(
    shapes: Optional[Iterable[tuple[int, int, int, int]]] = None,
    modes: Sequence[str] = MODES,
    topo: bool = True,
    stop: Optional[threading.Event] = None,
    probe_shapes: Optional[Iterable[tuple]] = None,
    device=None,
) -> dict[str, int]:
    """Launch every (shape bucket, mode, topology variant[, shards])
    combination, the probe buckets (ffd) and the dual-ascent buckets
    on `device` (None: the card; raises before any bucket without
    one). Returns {"ok": n, "error": n, "skipped": n}; a failed bucket
    is counted and logged, never raised. `stop` is polled between
    buckets; buckets run smallest first."""
    from karpenter_tpu_torch.metrics.store import SOLVER_WARM_COMPILES
    from karpenter_tpu_torch.solver import lp_device
    from karpenter_tpu_torch.solver.solver import resolve_device

    dev = resolve_device(device)
    shapes = list(shapes) if shapes is not None else shapes_from_env()
    shapes.sort(key=lambda s: s[0] * s[1] + s[2] + s[3])
    counts = {"ok": 0, "error": 0, "skipped": 0}
    if os.environ.get("KARPENTER_BATCH_PROBES", "1").lower() in (
        "0", "false", "off"
    ):
        # batching disabled: no probe kernel will ever launch
        probe_shapes = []
    probes = (
        list(probe_shapes) if probe_shapes is not None
        else probe_shapes_from_env()
    )
    probes.sort(key=lambda s: s[0] * (s[1] * s[2] + s[3] + s[4]))
    try:
        _prepare(dev)
        broken = None
    except Exception as err:
        # every bucket fails on it: counted once a bucket below
        log.warning("kernel build for the warm pool failed: %s", err)
        broken = err

    def attempt(what: str, fn) -> None:
        if stop is not None and stop.is_set():
            counts["skipped"] += 1
            return
        try:
            if broken is not None:
                raise broken
            fn()
            counts["ok"] += 1
            SOLVER_WARM_COMPILES.inc({"outcome": "ok"})
        except Exception as err:
            counts["error"] += 1
            SOLVER_WARM_COMPILES.inc({"outcome": "error"})
            log.warning("warm launch %s failed: %s", what, err)

    for shape in probes:
        L, G, C, E, N = shape[:5]
        R = shape[5] if len(shape) > 5 else 4
        P = shape[6] if len(shape) > 6 else 1
        attempt(f"probe (L={L},G={G},C={C},E={E},N={N},R={R},P={P})",
                lambda: _compile_probe_bucket(L, G, C, E, N, "ffd", R=R, P=P, device=dev))
    # dual-ascent buckets, gated on the guidance knob the solve honors
    if lp_device.enabled():
        lp_shapes = sorted(
            {(s[0], s[1], (s[4] if len(s) > 4 else 4)) for s in shapes}
        )
        for lp_shape in lp_shapes:
            if stop is not None and stop.is_set():
                counts["skipped"] += 1
                continue
            refusal = (lp_device.ascent_refusal(*(lp_device._pad_to(x) for x in lp_shape[:2]))
                       if dev.type == "cuda" else None)
            if refusal:
                # B5 refuses the bucket on the card (a named width limit):
                # a solve of it raises there, so there is nothing to warm
                counts["skipped"] += 1
                log.warning("lp warm bucket %s skipped: %s", lp_shape, refusal)
                continue
            try:
                if broken is not None:
                    raise broken
                done = lp_device.warm([lp_shape], device=dev)
                counts["ok"] += done
                if done:
                    SOLVER_WARM_COMPILES.inc({"outcome": "ok"}, value=float(done))
            except Exception as err:
                counts["error"] += 1
                SOLVER_WARM_COMPILES.inc({"outcome": "error"})
                log.warning("lp warm launch %s failed: %s", lp_shape, err)
    ws = warm_shards(dev)
    shard_variants = (0, ws) if ws > 1 else (0,)
    for shape in shapes:
        G, C, E, N = shape[:4]
        R = shape[4] if len(shape) > 4 else 4
        P = shape[5] if len(shape) > 5 else 1
        for mode in modes:
            for with_topo in ((False, True) if topo else (False,)):
                for shards in shard_variants:
                    attempt(
                        f"(G={G},C={C},E={E},N={N},R={R},P={P},mode={mode},"
                        f"topo={with_topo},shards={shards})",
                        lambda: _compile_bucket(G, C, E, N, mode, R=R, P=P,
                                                topo=with_topo, shards=shards,
                                                device=dev))
    return counts


def start_background(
    shapes: Optional[Iterable[tuple[int, int, int, int]]] = None,
    device=None,
    probe_shapes: Optional[Iterable[tuple]] = None,
) -> threading.Thread:
    """Operator-startup entry: warm the buckets on a background thread
    so the first tick's solve waits for no build or module load.
    `device` is resolved here (None: the card; raises without one).
    Returns the started thread; its `stop` event abandons the remaining
    buckets.

    The thread is non-daemon, as in the JAX package: a daemon thread
    killed inside a launch or a build at interpreter exit can take the
    process down. The stop event is registered with threading's
    shutdown hooks, which run before non-daemon threads are joined, so
    exit waits for at most the one bucket in flight."""
    from karpenter_tpu_torch.solver.solver import resolve_device

    dev = resolve_device(device)
    stop = threading.Event()
    # the thread launches on the stream of the thread that started it
    stream = caller_stream(dev)

    def _run() -> None:
        try:
            with on_stream(stream):
                counts = warm(shapes, stop=stop, probe_shapes=probe_shapes, device=dev)
            log.info("warm pool launched %d shape buckets (%d failed, %d skipped)",
                     counts["ok"], counts["error"], counts["skipped"])
        except Exception:  # never take the operator down
            log.exception("solver warm pool crashed")

    thread = threading.Thread(target=_run, name="solver-warm-pool", daemon=False)
    thread.stop = stop
    register = getattr(threading, "_register_atexit", None)
    if register is not None:
        register(stop.set)
    else:  # pragma: no cover - interpreters before 3.9
        import atexit

        atexit.register(stop.set)
    thread.start()
    return thread
