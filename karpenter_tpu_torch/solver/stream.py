"""Streaming staging of a sharded solve's config-axis inputs.

Copy of `karpenter_tpu/solver/stream.py`. The classic staging of
`pack.stage` materializes every padded config-axis matrix on the host
(the [Gp, Cp] compat block and the [Cp, R] / [Cp] config vectors) and
then splits it into the shards' column blocks. This module builds each
shard's padded block on the host one at a time (padding and slicing in
one fill callback), moves it to the shard's device and frees it, so the
host's transient peak per matrix is one 1/shards-width block. The
blocks are value-identical to the classic split.

Knob: KARPENTER_STREAM_ENCODE — "auto" (default: stream whenever the
solve is sharded), "0"/"off" (always classic), "1"/"on"/"force"
(stream sharded solves). An unsharded solve always stages classically.
`last_stats()` keeps the stats of the most recent streamed staging:
{"arrays", "blocks", "peak_block_bytes", "full_bytes"}, as the JAX
module's.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

import numpy as np
import torch

_lock = threading.Lock()
_last: dict = {}


def enabled() -> bool:
    """KARPENTER_STREAM_ENCODE for a sharded solve: only the explicit
    off switch stages classically (streaming is value-identical)."""
    raw = os.environ.get("KARPENTER_STREAM_ENCODE", "auto").strip().lower()
    return raw not in ("0", "off", "false", "no")


def reset_stats() -> None:
    with _lock:
        _last.clear()


def last_stats() -> dict:
    """Stats of the most recent streamed staging: full_bytes is what
    one full host copy of every streamed matrix would have allocated,
    peak_block_bytes the streamed path's largest host block."""
    with _lock:
        return dict(_last)


class _Staging:
    """Per-solve stats over the stage() calls of one staging pass;
    commit() publishes them as last_stats()."""

    def __init__(self):
        self.arrays = 0
        self.blocks = 0
        self.peak_block_bytes = 0
        self.full_bytes = 0

    def commit(self) -> None:
        from karpenter_tpu_torch.metrics.store import SOLVER_STREAM_BLOCKS
        from karpenter_tpu_torch.solver import telemetry

        SOLVER_STREAM_BLOCKS.inc(value=self.blocks)
        stats = dict(arrays=self.arrays, blocks=self.blocks,
                     peak_block_bytes=self.peak_block_bytes,
                     full_bytes=self.full_bytes)
        with _lock:
            _last.clear()
            _last.update(stats)
        # the same stats on the device-telemetry gauges and snapshot
        telemetry.note_staging(stats)


def shard_index(shape: tuple, axis: int, shards: int) -> list[tuple]:
    """Each shard's index tuple (slices into `shape`) for a split of
    `axis` into `shards` equal blocks, in shard order (what
    NamedSharding's device map gives a 1-D mesh)."""
    width = shape[axis] // shards
    out = []
    for s in range(shards):
        idx = [slice(None)] * len(shape)
        idx[axis] = slice(s * width, (s + 1) * width)
        out.append(tuple(idx))
    return out


def stage(devices: list, axis: int, shape: tuple, dtype,
          fill: Callable[[tuple], np.ndarray],
          staging: _Staging | None = None) -> list[torch.Tensor]:
    """Per-shard blocks of a global [.., Cp, ..] array split on `axis`
    over `devices` (one per shard, repeats allowed on a virtual mesh),
    built one at a time: `fill(index)` returns the shard's block as a
    host array, already padded and of the right dtype; it is moved to
    the shard's device and released before the next block is built.
    Returns the list of per-shard tensors, each its own allocation."""
    out = []
    for dev, idx in zip(devices, shard_index(shape, axis, len(devices))):
        block = np.ascontiguousarray(fill(idx))
        if staging is not None:
            staging.blocks += 1
            staging.peak_block_bytes = max(staging.peak_block_bytes, block.nbytes)
        # a copy even on the CPU: each shard's block is its own allocation
        out.append(torch.from_numpy(block).to(dev, copy=True))
        del block
    if staging is not None:
        staging.arrays += 1
        staging.full_bytes += int(np.prod(shape) * np.dtype(dtype).itemsize)
    return out


def col_fill_2d(src: np.ndarray, rows: int, real_rows: int, real_cols: int,
                dtype):
    """Fill callback for a [rows, Cp] matrix split on its column axis:
    rows beyond `real_rows` and columns beyond `real_cols` are zero."""

    def fill(idx):
        _, cs = idx
        lo = cs.start or 0
        hi = cs.stop if cs.stop is not None else src.shape[1]
        blk = np.zeros((rows, hi - lo), dtype)
        if lo < real_cols:
            take = min(hi, real_cols) - lo
            blk[:real_rows, :take] = src[:, lo : lo + take]
        return blk

    return fill


def row_fill_2d(src: np.ndarray, cols: int, real_rows: int, dtype):
    """Fill callback for a [Cp, cols] matrix split on its row (config)
    axis."""

    def fill(idx):
        rs, _ = idx
        lo = rs.start or 0
        hi = rs.stop
        blk = np.zeros((hi - lo, cols), dtype)
        if lo < real_rows:
            take = min(hi, real_rows) - lo
            blk[:take] = src[lo : lo + take]
        return blk

    return fill


def vec_fill(src: np.ndarray, real_len: int, dtype, pad_value=0):
    """Fill callback for a [Cp] vector split on the config axis."""

    def fill(idx):
        (cs,) = idx
        lo = cs.start or 0
        hi = cs.stop
        blk = np.full((hi - lo,), pad_value, dtype)
        if lo < real_len:
            take = min(hi, real_len) - lo
            blk[:take] = src[lo : lo + take]
        return blk

    return fill
