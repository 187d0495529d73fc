"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface, loaded with ctypes. The build runs at
first use, into `_build/` beside this file, one `nvcc` process per
source, all started together. A library's file name carries a digest
of its source, the shared headers (`csrc/*.cuh`: pack_common.cuh and
the split kernels' exchange, shard_xchg.cuh), the flags and the
machine (`machine_tag`: the `nvcc` version and the card's compute
capability), so an edited source is rebuilt, an unchanged one is loaded
as it is, and a `_build/` directory carried to another host never
loads a library built for another toolkit or card. `_build/` is the
port's counterpart of the JAX package's persistent compilation cache
(`solver/warm_pool.py` builds and loads it before the first solve).

Flags: sm_90a (Hopper), -O3, and -fmad=false so that no multiply-add
is contracted into an FMA (the kernels must match their plain versions
bit for bit); never --use_fast_math.

B1's, B3's, B7's, B4's and B5's sources are also built a second time
with -DKARPENTER_PHASE_CLOCKS (`pack_split_clocks`,
`pack_wavefront_clocks`, `pack_dense_clocks`, `lp_price_clocks`,
`lp_ascend_clocks`): block 0 (B4: every config's block) then sums
clock64() cycles per phase of a group step, round, pricing chain or
ascent iteration into a device array that
`phase_clocks_take` reads and clears. The solve never loads these;
`pack_split.phase_clocks` swaps them in for a timed run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path


class KernelError(RuntimeError):
    """A kernel of this package failed to launch (a nonzero CUDA error
    from its launch, `pack_split._raise_on`) or to build (`nvcc`
    missing, a source that does not compile, a library that does not
    load). The resilience ladder classifies it as `device_lost`
    (`solver/resilience.classify`), as the JAX package classifies its
    XLA runtime and compile errors, and raises it to the caller on a
    CUDA device (`resilience.may_degrade`)."""


HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE / "_build"

# library name -> source file under csrc/
SOURCES = {
    "pack_split": "pack_split.cu",
    "pack_wavefront": "pack_wavefront.cu",
    "pack_flat": "pack_flat.cu",
    "pack_dense": "pack_dense.cu",
    "lp_price": "lp_price.cu",
    "lp_ascend": "lp_ascend.cu",
    "pack_split_clocks": "pack_split.cu",
    "pack_wavefront_clocks": "pack_wavefront.cu",
    "pack_dense_clocks": "pack_dense.cu",
    "lp_ascend_clocks": "lp_ascend.cu",
    "lp_price_clocks": "lp_price.cu",
}
# extra nvcc flags of a library
EXTRA_FLAGS = {
    "pack_split_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "pack_wavefront_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "pack_dense_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "lp_ascend_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "lp_price_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: argument types of each library's entry points
# a packing launch's placement: its segment offsets (null: all in shared
# memory), the spilled tables' scratch and a block's bytes of it
_PLACE = [_P, _P, _L]
SIGNATURES = {
    "pack_split": {
        "pack_split_launch": [_P] * 25 + [_I] * 11 + [_L] + _PLACE + [_P],
        "pack_split_sharded_launch": [_P] * 26 + [_I] * 11 + _PLACE + [_P],
    },
    "pack_wavefront": {
        "pack_wavefront_launch": [_P] * 36 + [_I] * 10 + _PLACE + [_P],
        "pack_probe_wavefront_launch": [_P] * 34 + [_I] * 11 + _PLACE + [_P, _P],
        "pack_wavefront_sharded_launch": [_P] * 39 + [_I] * 12 + _PLACE + [_P] * 3,
        "wave_barrier_probe_launch": [_I, _P, _P],
    },
    "pack_flat": {
        "pack_flat_launch": [_P] * 7 + [_I] * 5 + [_P],
        "pack_flat_sharded_launch": [_P] * 7 + [_I] * 5 + [_P],
        "pack_flat_masks_launch": [_P] * 2 + [_I] * 5 + [_P],
    },
    "pack_dense": {"pack_dense_launch": [_P] * 24 + [_I] * 10 + _PLACE + [_P],
                   "pack_dense_barrier_probe_launch": [_I, _I, _P, _P]},
    "lp_price": {"lp_price_launch": [_P] * 7 + [_I] * 4 + [_P]},
    "lp_ascend": {
        "lp_ascend_launch": [_P] * 15 + [_I, _P, _L] + [_I] * 6 + [_P, _P],
        "lp_ascend_sharded_launch": [_P] * 15 + [_I, _P, _L, _P] + [_I] * 7 + [_P],
        "lp_barrier_probe_launch": [_I, _P, _P],
        "lp_cluster_barrier_probe_launch": [_I, _I, _P, _P],
    },
}
for _name in ("pack_split", "pack_wavefront", "pack_dense", "lp_ascend", "lp_price"):
    SIGNATURES[f"{_name}_clocks"] = {**SIGNATURES[_name], "phase_clocks_take": [_P],
                                     "phase_ns_take": [_P], "xchg_census_take": [_P]}

# name -> {"seconds": wall of its nvcc, "ptxas": what -Xptxas -v said
# (kept beside the library, so a cached build reports it too),
# "cached": True when an earlier build was loaded, "machine_tag"}
BUILD_INFO: dict[str, dict] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


_machine: list[str] = []


def machine_tag() -> str:
    """A short digest of what a built library depends on besides its
    sources and flags: the `nvcc --version` text and the compute
    capability of the current card ("no-nvcc" / "no-card" where there
    is none). Computed once a process."""
    if not _machine:
        try:
            out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                                 text=True, check=False).stdout
        except (KernelError, OSError):
            out = "no-nvcc"
        try:
            import torch

            cap = ("sm_%d%d" % torch.cuda.get_device_capability()
                   if torch.cuda.is_available() else "no-card")
        except Exception:
            cap = "no-card"
        _machine.append(hashlib.sha256(f"{out}\n{cap}".encode()).hexdigest()[:8])
    return _machine[0]


def _target(name: str) -> Path:
    # the shared headers and the machine are part of every digest
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()
                            + machine_tag().encode()).hexdigest()[:12]
    return BUILD / f"{name}-{digest}.so"


def _ptxas_log(out: Path) -> Path:
    return out.with_suffix(".ptxas.txt")


def _note_cached(name: str, out: Path) -> None:
    log = _ptxas_log(out)
    BUILD_INFO.setdefault(name, {
        "seconds": 0.0, "cached": True,
        "ptxas": log.read_text() if log.exists() else "",
        "machine_tag": machine_tag(),
    })


def build_all() -> dict[str, dict]:
    """Build every library that is not built yet, one nvcc per source
    in parallel; returns BUILD_INFO."""
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                _note_cached(name, out)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                time.perf_counter(), tmp, out,
            )
        failed = []
        for name, (proc, t0, tmp, out) in procs.items():
            log, _ = proc.communicate()
            text = log.decode(errors="replace")
            BUILD_INFO[name] = {
                "seconds": time.perf_counter() - t0, "ptxas": text, "cached": False,
                "machine_tag": machine_tag(),
            }
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
                continue
            _ptxas_log(out).write_text(text)
            os.replace(tmp, out)
        if failed:
            raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
        return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _target(name).exists():
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _note_cached(name, _target(name))
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as err:
                raise KernelError(f"{name}: the built library does not load: {err}") from err
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib
