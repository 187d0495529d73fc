"""The shard slots a solve may split its config axis over.

Counterpart of `karpenter_tpu/utils/platform.py::force_cpu_mesh`. The
JAX package proves its sharded solve on one host by asking XLA for n
virtual CPU devices; the port asks for n virtual shard slots on the
one device a solve runs on (the CPU in the tests, the card in
`chip_smoke.py` and `graft_entry.dryrun_multichip`). Each slot of such
a mesh holds its own column block and its own copy of the replicated
state, and the slots exchange only their partial reductions.

Without `force_virtual_mesh`, the visible devices are the real ones:
`torch.cuda.device_count()` for the card, 1 for the CPU.
"""

from __future__ import annotations

import torch

# shard slots forced by force_virtual_mesh (0: none forced)
_virtual = {"n": 0}


def force_virtual_mesh(n_devices: int = 0) -> None:
    """Make the shard-resolution sites see `n_devices` shard slots on
    the one device a solve runs on; 0 restores the real devices."""
    if n_devices < 0:
        raise ValueError(f"force_virtual_mesh: {n_devices} < 0")
    _virtual["n"] = int(n_devices)


def virtual_mesh() -> int:
    """The forced slot count (0 when the real devices are visible)."""
    return _virtual["n"]


def real_devices(device: torch.device | str | None = None) -> int:
    """Devices of `device`'s kind: the visible cards for CUDA (or when
    `device` is None and a card is present), 1 for the CPU."""
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return torch.cuda.device_count()
    return 1
