"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface, loaded with ctypes. The build runs at
first use, into `_build/` beside this file, one `nvcc` process per
source, all started together. A library's file name carries a digest
of its source, the shared headers (`csrc/*.cuh`: pack_common.cuh and
the split kernels' exchange, shard_xchg.cuh) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Flags: sm_90a (Hopper), -O3, and -fmad=false so that no multiply-add
is contracted into an FMA (the kernels must match their plain versions
bit for bit); never --use_fast_math.

B1's, B3's and B5's sources are also built a second time with
-DKARPENTER_PHASE_CLOCKS (`pack_split_clocks`, `pack_wavefront_clocks`,
`lp_ascend_clocks`): block 0 then sums clock64() cycles per phase of a
group step, round or ascent iteration into a device array that
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
    "lp_ascend_clocks": "lp_ascend.cu",
}
# extra nvcc flags of a library
EXTRA_FLAGS = {
    "pack_split_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "pack_wavefront_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
    "lp_ascend_clocks": ("-DKARPENTER_PHASE_CLOCKS",),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: argument types of each library's entry points
SIGNATURES = {
    "pack_split": {
        "pack_split_launch": [_P] * 25 + [_I] * 10 + [_P],
        "pack_split_sharded_launch": [_P] * 27 + [_I] * 11 + [_P],
    },
    "pack_wavefront": {
        "pack_wavefront_launch": [_P] * 36 + [_I] * 10 + [_P],
        "pack_probe_wavefront_launch": [_P] * 34 + [_I] * 11 + [_P, _P],
        "pack_wavefront_sharded_launch": [_P] * 38 + [_I] * 12 + [_P] * 3,
    },
    "pack_flat": {
        "pack_flat_launch": [_P] * 7 + [_I] * 5 + [_P],
        "pack_flat_sharded_launch": [_P] * 7 + [_I] * 5 + [_P],
    },
    "pack_dense": {"pack_dense_launch": [_P] * 22 + [_I] * 9 + [_P]},
    "lp_price": {"lp_price_launch": [_P] * 7 + [_I] * 3 + [_P]},
    "lp_ascend": {
        "lp_ascend_launch": [_P] * 15 + [_I, _P, _L] + [_I] * 5 + [_P],
        "lp_ascend_sharded_launch": [_P] * 15 + [_I, _P, _L, _P, _P] + [_I] * 7 + [_P],
        "lp_barrier_probe_launch": [_I, _P, _P],
    },
}
for _name in ("pack_split", "pack_wavefront", "lp_ascend"):
    SIGNATURES[f"{_name}_clocks"] = {**SIGNATURES[_name], "phase_clocks_take": [_P]}

# name -> {"seconds": wall of its nvcc, "ptxas": what -Xptxas -v said
# (kept beside the library, so a cached build reports it too),
# "cached": True when an earlier build was loaded}
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
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    # the shared headers are part of every source's digest
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD / f"{name}-{digest}.so"


def _ptxas_log(out: Path) -> Path:
    return out.with_suffix(".ptxas.txt")


def build_all() -> dict[str, dict]:
    """Build every library that is not built yet, one nvcc per source
    in parallel; returns BUILD_INFO."""
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                log = _ptxas_log(out)
                BUILD_INFO.setdefault(name, {
                    "seconds": 0.0, "cached": True,
                    "ptxas": log.read_text() if log.exists() else "",
                })
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
            }
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
                continue
            _ptxas_log(out).write_text(text)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
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
            lib = ctypes.CDLL(str(_target(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib
