"""The port's device telemetry (`solver/telemetry.py`), on the CPU.

The counterparts of tests/test_telemetry.py's cases, where the port's
surfaces read what a CUDA card states (the ptxas report, the launch's
bytes and shared memory, `torch.cuda.memory_stats`) in place of XLA's
analyses:

- a warm-pool bucket records an entry with its argument and output
  bytes and, once a library's ptxas report exists, each kernel's
  registers, static shared memory, stack and spills (read here from a
  fixture in ptxas's own format); XLA's `flops` and `bytes_accessed`
  stay present and None; a cold solve is recorded at once and
  `drain()` returns True with nothing queued;
- a later capture never drops what an earlier one stated;
- the kill switch records nothing;
- the CPU's memory stats are null-safe; headroom from monkeypatched
  `torch.cuda.memory_stats`;
- `stream._Staging.commit` feeds the staging gauges and the snapshot,
  as in the JAX package (held against it);
- the snapshot is well-formed JSON; its arm-scoped roll-up covers only
  new buckets;
- the `tm_*` attributes on the compile span are stripped from
  `tracing.structure()`.
"""

import json

import pytest
import torch

from karpenter_tpu_torch import cuda_build, tracing
from karpenter_tpu_torch.metrics.store import (
    DEVICE_COMPILED_COST,
    DEVICE_COMPILED_MEMORY,
    DEVICE_MEMORY,
    DEVICE_STAGING,
)
from karpenter_tpu_torch.solver import telemetry, warm_pool
from karpenter_tpu_torch.solver.encode import encode, group_pods
from karpenter_tpu_torch.solver.pack import solve_packing
from karpenter_tpu_torch.testing import mk_nodepool, mk_pod
from karpenter_tpu_torch.cloudprovider.fake import instance_types

# ptxas -v's report of one library, in its own format (two
# instantiations of one kernel, one with spills)
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__f0aee24b_13_pack_split_cu_2731785617pack_split_kernelILb0ELi1024EEEvNS_4ArgsENS_9PlacementE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__f0aee24b_13_pack_split_cu_2731785617pack_split_kernelILb0ELi1024EEEvNS_4ArgsENS_9PlacementE
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size, 400 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__f0aee24b_13_pack_split_cu_2731785617pack_split_kernelILb1ELi1024EEEvNS_4ArgsENS_9PlacementE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__f0aee24b_13_pack_split_cu_2731785617pack_split_kernelILb1ELi1024EEEvNS_4ArgsENS_9PlacementE
    192 bytes stack frame, 8 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 192 bytes cumulative stack size
"""
FLAT = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__65226ac6_12_pack_flat_cu_0fa05b1d21pack_flat_masks_kernelEPiPKhiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__65226ac6_12_pack_flat_cu_0fa05b1d21pack_flat_masks_kernelEPiPKhiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
"""


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("KARPENTER_DEVICE_TELEMETRY", raising=False)
    telemetry.reset()
    warm_pool.reset()
    yield
    telemetry.reset()
    warm_pool.reset()


@pytest.fixture
def ptxas(monkeypatch):
    """The two libraries' ptxas reports, as a build leaves them."""
    monkeypatch.setitem(cuda_build.BUILD_INFO, "pack_split",
                        {"seconds": 0.0, "cached": True, "ptxas": PTXAS})
    monkeypatch.setitem(cuda_build.BUILD_INFO, "pack_flat",
                        {"seconds": 0.0, "cached": True, "ptxas": FLAT})


def _enc(prefix: str):
    pods = [mk_pod(name=f"{prefix}-{i}", cpu=1.0) for i in range(40)]
    return encode(group_pods(pods), [(mk_nodepool("default"), instance_types(10))])


def test_ptxas_report_parses():
    report = telemetry.parse_ptxas(PTXAS)
    assert report == {
        "pack_split_kernel<0,1024>": {"stack": 16, "spill_stores": 0, "spill_loads": 0,
                                      "registers": 64, "static_smem": 400},
        "pack_split_kernel<1,1024>": {"stack": 192, "spill_stores": 8, "spill_loads": 24,
                                      "registers": 64, "static_smem": 0},
    }
    assert telemetry.parse_ptxas(FLAT) == {"pack_flat_masks_kernel": {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 30, "static_smem": 0}}
    assert telemetry.parse_ptxas("") == {}


def test_warm_pool_bucket_records_its_entry(ptxas):
    warm_pool._compile_bucket(16, 256, 0, 64, "ffd", device="cpu")
    snap = telemetry.snapshot()
    assert snap["compiled"], "no entry recorded"
    key, entry = next(iter(snap["compiled"].items()))
    # padded as a solve pads: 256 configs -> 320, a fresh axis of 64 -> 79
    assert key == "pack[16x320x0x79xffdxwf0-rsvn]sh0"
    assert entry["source"] == "warm_pool"
    want = telemetry.pack_stated(16, 320, 0, 79, 4, 1)
    assert entry["memory"]["argument"] == want["argument"] > 0
    assert entry["memory"]["output"] == want["output"] > 0
    # XLA's cost-model keys stay and read None: nothing counts them
    assert entry["cost"] == {"flops": None, "bytes_accessed": None}
    assert entry["kernels"]["pack_split"]["pack_split_kernel<1,1024>"]["spill_loads"] == 24
    assert entry["kernels"]["pack_flat"]["pack_flat_masks_kernel"]["registers"] == 30
    labels = {"kernel": "pack", "bucket": "16x320x0x79xffdxwf0-rsvn", "shards": "0"}
    assert DEVICE_COMPILED_MEMORY.value({**labels, "component": "argument"}) == want["argument"]
    assert not any(dict(p).get("kernel") == "pack" for p, _ in DEVICE_COMPILED_COST.samples())
    assert snap["compiled_peak_temp_mb"] is None
    assert snap["compiled_peak_argument_mb"] == round(want["argument"] / 2**20, 2)


def test_cold_solve_is_recorded_at_once():
    solve_packing(_enc("ct"), mode="ffd", device="cpu")
    assert telemetry.drain(0.0)
    entries = {k: v for k, v in (telemetry.snapshot()["compiled"] or {}).items()
               if k.startswith("pack[")}
    assert entries, "the cold launch recorded no pack bucket"
    entry = next(iter(entries.values()))
    assert entry["source"] == "cold_capture"
    assert entry["memory"]["argument"] > 0 and entry["memory"]["output"] > 0
    # no library was built on the CPU: no ptxas report to read
    assert entry["kernels"] is None


def test_record_never_drops_what_an_earlier_capture_stated(ptxas):
    telemetry.record_compiled("pack", (1, 2, 3), {"argument": 10, "output": 20})
    cuda_build.BUILD_INFO.pop("pack_split")
    cuda_build.BUILD_INFO.pop("pack_flat")
    telemetry.record_compiled("pack", (1, 2, 3), {}, source="cold_capture")
    entry = telemetry.compiled_entry("pack", (1, 2, 3))
    assert entry["memory"] == {"argument": 10, "output": 20}
    assert set(entry["kernels"]) == {"pack_split", "pack_flat"}
    assert entry["source"] == "cold_capture"


def test_kill_switch_records_nothing(monkeypatch):
    monkeypatch.setenv("KARPENTER_DEVICE_TELEMETRY", "0")
    assert not telemetry.enabled() and telemetry.mode() == "off"
    telemetry.record_compiled("pack", (9, 9), {"argument": 1})
    telemetry.request_pack_capture(16, 32, 0, 32, 4, 1, "ffd", 0, 0, None)
    telemetry.request_lp_capture(16, 32, 4, 1, 10)
    solve_packing(_enc("ks"), mode="ffd", device="cpu")
    assert telemetry.snapshot()["compiled"] is None
    monkeypatch.setenv("KARPENTER_DEVICE_TELEMETRY", "force")
    assert telemetry.mode() == "force" and telemetry.enabled()


def test_cpu_memory_stats_are_null_safe():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device reports allocator stats")
    before = DEVICE_MEMORY.samples()
    assert telemetry.device_memory_snapshot() == []
    assert telemetry.publish_device_memory() == []
    assert DEVICE_MEMORY.samples() == before
    assert telemetry.headroom() is None
    assert telemetry.snapshot()["devices"] is None


def test_headroom_from_memory_stats(monkeypatch):
    """The allocator's stats of two (faked) cards: the headroom is the
    least of 1 - in use / the card's memory, the peak's beside it."""
    stats = {0: {"allocated_bytes.all.current": 30, "allocated_bytes.all.peak": 80,
                 "largest_segment": 5},
             1: {"allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 40}}

    class Props:
        total_memory = 100

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    snap = telemetry.device_memory_snapshot()
    assert snap[0] == {"device": "cuda:0", "platform": "gpu", "stats": {
        "bytes_in_use": 30, "peak_bytes_in_use": 80, "largest_alloc_size": 5,
        "bytes_limit": 100}}
    assert telemetry.headroom() == {"min_headroom_fraction": 0.7,
                                    "min_peak_headroom_fraction": 0.2,
                                    "devices_reporting": 2}
    telemetry.publish_device_memory()
    assert DEVICE_MEMORY.value({"device": "cuda:1", "stat": "bytes_in_use"}) == 10.0
    assert telemetry.snapshot()["device_peak_in_use_mb"] == round(80 / 2**20, 2)


def test_stream_commit_unifies_staging_stats_like_jax():
    from karpenter_tpu.metrics.store import DEVICE_STAGING as J_STAGING
    from karpenter_tpu.metrics.store import SOLVER_STREAM_BLOCKS as J_BLOCKS
    from karpenter_tpu.solver import stream as jstream
    from karpenter_tpu.solver import telemetry as jtelemetry
    from karpenter_tpu_torch.metrics.store import SOLVER_STREAM_BLOCKS
    from karpenter_tpu_torch.solver import stream

    out = []
    for mod, tm, staging_g, blocks in ((stream, telemetry, DEVICE_STAGING, SOLVER_STREAM_BLOCKS),
                                       (jstream, jtelemetry, J_STAGING, J_BLOCKS)):
        before = blocks.total()
        staging = mod._Staging()
        staging.arrays, staging.blocks = 2, 8
        staging.peak_block_bytes, staging.full_bytes = 1024, 8192
        staging.commit()
        out.append((tm.snapshot()["staging"], staging_g.value({"stat": "peak_block"}),
                    staging_g.value({"stat": "full"}), blocks.total() - before,
                    mod.last_stats()))
        tm.reset()
    assert out[0] == out[1]
    assert out[0][:3] == ({"arrays": 2, "blocks": 8, "peak_block_bytes": 1024,
                           "full_bytes": 8192}, 1024.0, 8192.0)


def test_snapshot_is_always_well_formed_json():
    snap = telemetry.snapshot()
    assert set(snap) == {
        "mode", "compiled", "devices", "staging", "compiled_peak_temp_mb",
        "compiled_peak_argument_mb", "compiled_scope", "device_peak_in_use_mb",
        "device_scope",
    }
    assert snap["compiled"] is None and snap["staging"] is None
    assert snap["compiled_peak_temp_mb"] is None and snap["device_peak_in_use_mb"] is None
    assert snap["compiled_scope"] == "process" and snap["device_scope"] == "process"
    json.dumps(snap)


def test_arm_scoped_rollup_covers_only_new_buckets():
    warm_pool._compile_bucket(16, 256, 0, 64, "ffd", device="cpu")
    before = telemetry.compiled_keys()
    assert telemetry.snapshot()["compiled_peak_argument_mb"] > 0
    arm = telemetry.snapshot(compiled_before=before)
    assert arm["compiled_scope"] == "arm"
    assert arm["compiled_peak_argument_mb"] is None  # nothing new
    warm_pool._compile_bucket(64, 1024, 0, 512, "ffd", device="cpu")
    assert telemetry.snapshot(compiled_before=before)["compiled_peak_argument_mb"] > 0
    json.dumps(telemetry.snapshot())


def test_compile_span_carries_tm_attrs_outside_structure():
    enc = _enc("sa")
    solve_packing(enc, mode="ffd", device="cpu")       # cold: recorded at once
    tracing.clear()
    with tracing.trace("tick"):
        solve_packing(enc, mode="ffd", device="cpu")
    trace = tracing.last_trace()
    spans = {s["name"]: s for s in trace["spans"]}
    assert {"solve.transfer", "solve.compile", "solve.execute"} <= set(spans)
    assert spans["solve.compile"]["attrs"]["tm_argument"] > 0
    assert spans["solve.compile"]["attrs"]["warm_hit"] is False

    def walk(node):
        name, attrs, events, children = node
        assert not any(k.startswith("tm_") or k == "warm_hit" for k, _ in attrs), attrs
        for child in children:
            walk(child)

    for root in tracing.structure(trace):
        walk(root)
    tracing.clear()
