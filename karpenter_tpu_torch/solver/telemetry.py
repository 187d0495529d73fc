"""Device cost and memory accounting for the solver.

Counterpart of `karpenter_tpu/solver/telemetry.py`, with the same
surfaces under the same names (`mode`/`enabled`, `variant_tag`,
`record_compiled`, `compiled_entry`, `request_pack_capture`,
`request_lp_capture`, `drain`, `device_memory_snapshot`,
`publish_device_memory`, `note_staging`, `snapshot`, `headroom`,
`reset`) and the same `karpenter_device_*` series. What each surface
reads is what a CUDA card can state:

1. **Per-kernel entries.** The JAX package reads XLA's
   `memory_analysis()` and `cost_analysis()` off a compiled program.
   Here a (kernel, padded bucket, shards, variant) entry holds what the
   card and the build can state: the ptxas report `cuda_build` keeps
   beside each library (per kernel function: registers, static shared
   memory, stack frame, spill stores and loads), the launch's dynamic
   shared memory (`pack_split.DYNAMIC_SMEM`), and the argument and
   output bytes of the bucket's padded inputs and flat buffer. XLA's
   `flops` and `bytes_accessed` keys stay in each entry's `cost` and
   read None: nothing here counts them, and no count is made up.
2. **No queue.** Reading the ptxas report costs nothing, so a cold
   bucket's capture (`request_pack_capture`, `request_lp_capture`) is
   recorded at once, and `drain()` returns True with nothing queued.
3. **Live device memory** from `torch.cuda.memory_stats(device)`
   (bytes in use, peak, the card's total, the largest segment); on the
   CPU there are no allocator stats, so the gauges stay unset and the
   snapshot carries None, as the JAX package's does on XLA:CPU.
4. **Staging attribution**: `stream._Staging.commit` feeds
   `note_staging`.

Everything lands three ways, as in the JAX package: gauges
(`karpenter_device_*`), `tm_*` attributes on the `solve.compile` and
`solve.execute` spans (stripped from `tracing.structure()`), and the
`snapshot()` block.

Knob: KARPENTER_DEVICE_TELEMETRY (off | auto | force; force behaves as
auto here: every entry is complete when it is recorded).
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Optional

log = logging.getLogger("karpenter.solver.telemetry")

ENV = "KARPENTER_DEVICE_TELEMETRY"

# memory_stats() keys exported per live device, under the JAX package's
# stat names: torch's allocator keys -> the XLA names
_DEVICE_STATS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
    ("largest_alloc_size", "largest_segment"),
)

# the libraries each kernel route of an entry launches
_LIBRARIES = {
    ("pack", False): ("pack_split", "pack_flat"),
    ("pack", True): ("pack_wavefront", "pack_flat"),
    ("probe_lanes", False): ("pack_split", "pack_flat"),
    ("probe_lanes", True): ("pack_wavefront", "pack_flat"),
    ("probe_solo", False): ("pack_split", "pack_flat"),
    ("probe_solo", True): ("pack_wavefront", "pack_flat"),
    ("lp", False): ("lp_ascend",),
}


def mode() -> str:
    """off | auto | force (read per call)."""
    raw = os.environ.get(ENV, "auto").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return "off"
    if raw in ("force", "2"):
        return "force"
    return "auto"


def enabled() -> bool:
    return mode() != "off"


# -- per-kernel registry ------------------------------------------------------

_lock = threading.Lock()
# (kernel, bucket, shards) -> {"memory": {...}|None, "cost": {...},
#                              "kernels": {...}|None, "source": str}
_compiled: dict[tuple, dict] = {}
_staging: dict = {}


def variant_tag(wavefront: int, rsv_k: Optional[int] = None,
                group_cap: bool = False, conflict: bool = False,
                quota: bool = False) -> str:
    """The variant component of a pack bucket key, as the JAX package
    spells it: the wavefront width, the reservation rows (n: none), and
    the optional inputs a launch passed (gc, cf, qt)."""
    parts = ["wf%d" % wavefront,
             "rsv%s" % ("n" if rsv_k is None else int(rsv_k))]
    if group_cap:
        parts.append("gc")
    if conflict:
        parts.append("cf")
    if quota:
        parts.append("qt")
    return "-".join(parts)


def _bucket_key(kernel: str, bucket: tuple, shards: int) -> tuple:
    return (kernel, tuple(int(x) if isinstance(x, (int, bool)) else str(x)
                          for x in bucket), int(shards))


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_function(mangled: str) -> str:
    """A mangled kernel name as "name<targs>": its identifier and its
    bool and int template arguments (`pack_split_kernel<0,256>`)."""
    k = re.search(r"([a-z_]+_kernel)(I(L[bi]\d+E)+E)?", mangled)
    if not k:
        return mangled
    targs = re.findall(r"L[bi](\d+)E", k.group(2) or "")
    return k.group(1) + (f"<{','.join(targs)}>" if targs else "")


def parse_ptxas(text: str) -> dict:
    """`ptxas -v` output -> {kernel function: {"registers",
    "static_smem", "stack", "spill_stores", "spill_loads"}}, in the
    report's order; values a line does not state stay absent."""
    out: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = kernel_function(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m and "stack" not in out[name]:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            out[name]["static_smem"] = int(s.group(1)) if s else 0
    return out


def library_report(library: str) -> Optional[dict]:
    """The parsed ptxas report of one built library (None before it is
    built or loaded from `_build/`, and on the CPU)."""
    from karpenter_tpu_torch import cuda_build

    info = cuda_build.BUILD_INFO.get(library)
    if not info or not info.get("ptxas"):
        return None
    return parse_ptxas(info["ptxas"])


def _kernels_of(kernel: str, wavefront: int) -> Optional[dict]:
    libs = _LIBRARIES.get((kernel, wavefront > 1))
    out = {}
    for lib in libs or ():
        report = library_report(lib)
        if report:
            out[lib] = report
    return out or None


def record_compiled(kernel: str, bucket: tuple, compiled: dict,
                    shards: int = 0, source: str = "warm_pool") -> None:
    """Account one kernel bucket. `compiled` is what a launch of the
    bucket stated: {"argument": bytes, "output": bytes, "wavefront": w,
    "dynamic_smem": placement text or None}; the ptxas reports of the
    route's libraries are read here. Never raises (telemetry must not
    take a solve down; it never launches anything)."""
    if not enabled():
        return
    try:
        memory = {k: int(compiled[k]) for k in ("argument", "output")
                  if compiled.get(k) is not None}
        smem = compiled.get("dynamic_smem")
        if smem:
            m = re.match(r"(\d+) B shared, (\d+) B global scratch", smem)
            if m:
                memory["dynamic_smem"] = int(m.group(1))
                memory["global_scratch"] = int(m.group(2))
        entry = {
            "memory": memory or None,
            # XLA's cost-model keys: nothing on the card states them
            "cost": {"flops": None, "bytes_accessed": None},
            "kernels": _kernels_of(kernel, int(compiled.get("wavefront", 0))),
            "source": source,
        }
        _publish_compiled(kernel, bucket, shards, entry)
    except Exception:  # pragma: no cover - defensive
        log.debug("kernel telemetry failed for %s %s", kernel, bucket,
                  exc_info=True)


def _publish_compiled(kernel: str, bucket: tuple, shards: int,
                      entry: dict) -> None:
    from karpenter_tpu_torch.metrics.store import DEVICE_COMPILED_MEMORY

    key = _bucket_key(kernel, bucket, shards)
    with _lock:
        prior = _compiled.get(key)
        if prior is not None:
            # a later capture never drops what an earlier one stated
            for part in ("memory", "kernels"):
                if entry[part] is None and prior.get(part) is not None:
                    entry = {**entry, part: prior[part]}
        _compiled[key] = entry
    labels = {"kernel": kernel, "bucket": "x".join(str(x) for x in key[1]),
              "shards": str(shards)}
    for component, value in (entry["memory"] or {}).items():
        DEVICE_COMPILED_MEMORY.set(float(value), {**labels, "component": component})


def compiled_entry(kernel: str, bucket: tuple, shards: int = 0
                   ) -> Optional[dict]:
    """The recorded entry of one bucket (None until captured)."""
    with _lock:
        entry = _compiled.get(_bucket_key(kernel, bucket, shards))
        return dict(entry) if entry is not None else None


def pack_stated(Gp: int, Cp: int, Ep: int, F: int, R: int, P: int,
               wavefront: int = 0, rsv_k: Optional[int] = None,
               group_cap: bool = False, conflict: bool = False,
               quota: bool = False, lanes: int = 0) -> dict:
    """What one padded packing launch states, as `record_compiled` takes
    it: the argument bytes of its inputs as `warm_pool.bucket_args` lays
    them out (lane counts and liveness in place of the group counts and
    bound liveness when `lanes`), the output bytes of its int32 flat
    buffer (`pack_split.flat_layout`), and the dynamic shared memory of
    the route's last launch (`pack_split.DYNAMIC_SMEM`)."""
    from karpenter_tpu_torch.solver.pack_split import DYNAMIC_SMEM, flat_layout

    L = max(lanes, 1)
    arg = (Gp * Cp + Gp * R * 4 + L * Gp * 4 + Cp * R * 4 + Cp * 4
           + (P + 1) * R * 4 + Gp * Ep + Ep * R * 8 + Ep * 4 + L * Ep + Cp * 4)
    if rsv_k is not None:
        arg += Cp * 4 + rsv_k * 4
    if group_cap:
        arg += Gp * 4
    if conflict:
        arg += Gp * Gp
    if quota and Ep:
        arg += Ep * Gp * 2
    lay = flat_layout(L, Ep + F, Gp, F, Cp, wavefront > 1)
    route = ("pack_probe_lanes" if lanes else "pack_split") + (
        "_wavefront" if wavefront > 1 else "")
    return {"argument": arg, "output": L * lay["row"] * 4, "wavefront": wavefront,
            "dynamic_smem": DYNAMIC_SMEM.get(route)}


def request_pack_capture(Gp: int, Cp: int, Ep: int, F: int, R: int,
                         P: int, mode_: str, wavefront: int,
                         shards: int, rsv_k: Optional[int],
                         group_cap: bool = False, conflict: bool = False,
                         quota: bool = False) -> None:
    """A cold pack bucket, recorded at once (the JAX package queues it
    for `drain`): its bytes, the route's ptxas reports and the last
    launch's dynamic shared memory."""
    if not enabled():
        return
    stated = pack_stated(Gp, Cp, Ep, F, R, P, wavefront, rsv_k, group_cap,
                        conflict, quota)
    bucket = (Gp, Cp, Ep, F, mode_,
              variant_tag(wavefront, rsv_k, group_cap, conflict, quota))
    record_compiled("pack", bucket, stated, shards=shards, source="cold_capture")


def request_lp_capture(Gp: int, Cp: int, R: int, Kp: int,
                       n_iters: int) -> None:
    """A cold dual-ascent bucket, recorded at once: B5's padded inputs
    (`lp_device.AscentInputs`) and its outputs (lambda and the trace)."""
    if not enabled():
        return
    arg = (3 * Gp * 4 + Gp * Cp + Gp * R * 4 + Cp * R * 4 + Cp * 4 + Cp * R
           + Kp * Cp + Kp * 4 + Cp)
    record_compiled("lp", (Gp, Cp, R, Kp, "iters%d" % n_iters),
                    {"argument": arg, "output": Gp * 4}, source="cold_capture")


def drain(timeout: float = 10.0) -> bool:
    """Nothing is ever queued (captures are recorded at once): True."""
    return True


# -- live device memory -------------------------------------------------------

def device_memory_snapshot() -> list[dict]:
    """Per-card live memory: [{"device", "platform", "stats": {...}}]
    from `torch.cuda.memory_stats`; [] without a CUDA device (the CPU
    reports no allocator stats)."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = None
        try:
            raw = torch.cuda.memory_stats(i)
            total = torch.cuda.get_device_properties(i).total_memory
        except Exception:
            raw, total = None, None
        if raw:
            stats = {name: int(raw[key]) for name, key in _DEVICE_STATS if key in raw}
            if total:
                stats["bytes_limit"] = int(total)
            stats = stats or None
        out.append({"device": f"cuda:{i}", "platform": "gpu", "stats": stats})
    return out


def publish_device_memory() -> list[dict]:
    """Refresh the `karpenter_device_memory_bytes` gauges and return the
    snapshot. Devices without stats leave no series."""
    snap = device_memory_snapshot()
    if not enabled():
        return snap
    from karpenter_tpu_torch.metrics.store import DEVICE_MEMORY

    for dev in snap:
        for stat, value in (dev["stats"] or {}).items():
            DEVICE_MEMORY.set(float(value), {"device": dev["device"], "stat": stat})
    return snap


# -- staging attribution ------------------------------------------------------

def note_staging(stats: dict) -> None:
    """Record the most recent streamed staging pass (called by
    `stream._Staging.commit`) into the staging gauges and `snapshot()`."""
    if not stats:
        return
    with _lock:
        _staging.clear()
        _staging.update(stats)
    if not enabled():
        return
    from karpenter_tpu_torch.metrics.store import DEVICE_STAGING

    for stat, key in (("peak_block", "peak_block_bytes"),
                      ("full", "full_bytes")):
        if key in stats:
            DEVICE_STAGING.set(float(stats[key]), {"stat": stat})


# -- the snapshot -------------------------------------------------------------

def compiled_keys() -> set:
    """The registry's bucket keys (taken before an arm, so `snapshot`
    can scope its roll-up to the arm)."""
    with _lock:
        return set(_compiled)


def snapshot(compiled_before: Optional[set] = None) -> dict:
    """The `device_telemetry` block, always well-formed, with None where
    the host states nothing. `compiled_peak_temp_mb` (XLA's temp
    buffers) has no counterpart on the card and reads None;
    `compiled_peak_argument_mb` is the largest bucket's argument bytes
    (scope "arm" with `compiled_before`, else "process");
    `device_peak_in_use_mb` is the allocator's process-wide peak."""
    with _lock:
        items = list(_compiled.items())
        staging = dict(_staging) if _staging else None
    compiled = {}
    arg_peaks = []
    for k, v in items:
        name = "%s[%s]sh%d" % (k[0], "x".join(str(x) for x in k[1]), k[2])
        compiled[name] = {
            "memory": dict(v["memory"]) if v["memory"] else None,
            "cost": dict(v["cost"]),
            "kernels": v["kernels"],
            "source": v["source"],
        }
        if (v["memory"] and "argument" in v["memory"]
                and (compiled_before is None or k not in compiled_before)):
            arg_peaks.append(v["memory"]["argument"])
    devices = device_memory_snapshot()
    in_use_peaks = [
        d["stats"]["peak_bytes_in_use"] for d in devices
        if d["stats"] and "peak_bytes_in_use" in d["stats"]
    ]
    return {
        "mode": mode(),
        "compiled": compiled or None,
        "devices": devices or None,
        "staging": staging,
        "compiled_peak_temp_mb": None,
        "compiled_peak_argument_mb": (
            round(max(arg_peaks) / 2**20, 2) if arg_peaks else None
        ),
        "compiled_scope": "arm" if compiled_before is not None else "process",
        "device_peak_in_use_mb": (
            round(max(in_use_peaks) / 2**20, 2) if in_use_peaks else None
        ),
        "device_scope": "process",
    }


def headroom() -> Optional[dict]:
    """Device-memory headroom where real stats exist: the least over
    cards of 1 - bytes in use / the card's memory (live, not the peak),
    the peak's alongside. None on the CPU."""
    fractions = []
    peaks = []
    for dev in device_memory_snapshot():
        stats = dev["stats"] or {}
        limit = stats.get("bytes_limit")
        in_use = stats.get("bytes_in_use")
        if limit and in_use is not None:
            fractions.append(1.0 - in_use / limit)
            if "peak_bytes_in_use" in stats:
                peaks.append(1.0 - stats["peak_bytes_in_use"] / limit)
    if not fractions:
        return None
    return {
        "min_headroom_fraction": round(min(fractions), 4),
        "min_peak_headroom_fraction": round(min(peaks), 4) if peaks else None,
        "devices_reporting": len(fractions),
    }


def reset() -> None:
    """Tests: drop the registry and the staging record (gauges keep
    their last values; tests read deltas)."""
    with _lock:
        _compiled.clear()
        _staging.clear()
