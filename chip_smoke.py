#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --quick   # phases 1-3, the warm first request's
                                    # hold and phase 5 alone, then B5 on
                                    # reserved_50k's LP (~2 min)

Phases, each reported on its own line; any failure exits non-zero:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile the CUDA kernels from karpenter_tpu_torch/csrc
                (one nvcc per source, in parallel, B1's and B3's sources
                a second time with their phase clocks); print build
                seconds and what ptxas reports (registers, shared memory).
  3. kernels  — hold each kernel against its plain PyTorch version on
                the card, on seeded problems (B4 and B5 on their own
                seeded cases, B5 also on edge cases: one whose arrays
                exceed the shared memory and must take the global-memory
                path, column maxima at 0 with tied groups, 801 configs,
                sums of at most 32 terms; the packing kernels in both modes, reservations,
                bound rows with quotas, group caps, conflicts, negative
                and huge demand, a capped node axis): outputs must be
                byte-identical, B3's at widths 1, 8, 16 and 32, and B3's
                equal to B1's on the same problem; two of them also at
                config axes the staging never gives the kernels (200, not
                a multiple of 32, and 800, past the consolidation union's
                768). The dense kernel B7
                and `pack_flat` on the same problems laid out densely
                (bound rows as one-hot existing_mask rows, their quotas
                as quota rows), and on LP-planned rows with quotas, in
                both modes: byte-identical to their plain versions, and
                B7's assignments, node counts, unschedulable pods and
                free rows equal to B1's on the same problem.
  4. main path — `solve()` the benchmark problem (50k pods x 500
                instance types, seed 42) as a user would, on each of
                the port's routes, with the kernel launch counts set to
                0 just before each and read just after:
                  first      one cold and five warm solves, on the
                             route the card takes by default: the
                             wavefront kernel B3 (168 groups >= 8);
                  second     10k more pods against the first solve's
                             nodes as existing nodes (the bound block);
                  sequential five warm solves of the first request
                             with KARPENTER_WAVEFRONT=0: B1;
                  small      a request of fewer than 8 groups: B1.
                Each route must launch its kernels and only those.
                Every pod is placed or unschedulable, and every
                fingerprint equals the CPU path's (the plain versions,
                which the CPU tests hold against the JAX package) and
                the other routes' of the same request. The kernel
                inputs of every distinct shape the routes staged are
                kept, and B1, B3 (width 16) and B2 are held
                byte-identical to their plain versions on them.
  5. timing   — each packing kernel's CUDA-event time on the warm
                first request's inputs (B1 and B3 in turns), its plain
                version's, its bound, and the dynamic shared memory a
                block of B1 and B3 takes; then one run each of B1's and
                B3's phase-clock builds: each phase's share of block 0's
                cycles, the us a step (B1) or round (B3) from the
                CUDA-event times, and the slowest thread of a step's sweep
                and takes against the mean.
  6. cost     — the cost objective on `build_problem(50_000, 500,
                reservations=True, zonal_frac=0.1)`, the benchmark's
                reserved_50k: one cold solve and five warm ones with
                the launch counts set to 0 just before and read just
                after; the fleet price beside FFD's, the certified and
                device bounds, the column-generation rounds and how
                they ended, the planned nodes, the warm median and the
                cold solve's breakdown (encode, plan with its B4 calls,
                ascent, each arm's pack, merge/trim, decode). It must
                launch B4, B5 and a packing kernel in cost mode, the
                cost fleet must not cost more than FFD's and the
                certified bound must not exceed it. B4 (first seed
                call, first and last rounds), B5 and the cost-mode
                packs are held against their plain versions on the
                inputs this run recorded; the card's fingerprint equals
                the CPU path's on two mid-size problems (column
                generation ending by convergence or stall, its HiGHS
                MIPs stopped after the root node on both sides, since
                their wall-clock limits round by the machine's load).
  7. LP timing — B4's and B5's CUDA-event times on the recorded
                inputs, their plain versions', and their bounds; B5's
                phase clocks (each phase's share, the regions inside the
                phases, barriers an iteration) and the floor of its chain
                of barriers (its barriers times one barrier alone).
  8. consolidation — `bench.py`'s consolidation_500, uncut: the FFD
                fleet of `build_problem(21000, 200, seed=9)` solved on
                the card, 55% of its pods removed, then the benchmark's
                convergence loop twice: arm (a) with one `solve()` per
                probe (B3/B1 and B2), arm (c) with every prefix of a
                cycle's ladder a lane of one `LaneSolver.solve_lazy`
                (B6 wavefront and the lane epilogue). The decisions must
                be identical and the final fleets agree within the
                benchmark's eps. Every packing call of both arms is
                bracketed by CUDA events: each cycle's wall is printed
                beside its packing calls' device time and their share
                of the wall, and arm (a)'s per-probe device time. Routes, with the launch counts set to
                0 before each and read after: the two arms, then one
                cycle each with KARPENTER_WAVEFRONT=0 (B6 sequential)
                and KARPENTER_PROBE_BATCH_WIDTH=1 (solo probes, no B6);
                each launches its kernels and only those, and the first
                cycle decides alike on every route. B6 (both programs)
                and the lane epilogue are held byte-identical to their
                plain versions on seeded lane cases (both modes,
                reservations, conflicts, padded lanes, widths 8 and 16)
                and on the first cycle's first chunk, whose every lane
                row also equals B1/B3 + B2 run alone on that lane. The
                pruner: `LaneSolver.dual_certificate()` on the first
                cycle's staging (B5 once, then timed and clocked on the
                certificate's own inputs), `ProbePruner.cannot_pay` on
                every prefix; no feasible lane costs less than the
                floor, and no pruned prefix has a strictly cheaper
                solution. A mid-size fleet (3000 x 60) runs arm (c) on
                the card and on the CPU (the plain versions, width 8):
                equal decisions and per-lane solutions. Then B6's and
                the epilogue's CUDA-event times on the recorded chunk,
                per dispatch and per lane, their plain versions', their
                bounds, the clusters the card holds at once and the
                memory the wavefront program took.
  9. dense    — the dense kernel B7 (`pack`, `pack_flat`): the port's
                `graft_entry.entry()` on the card (the counterpart of the
                JAX package's `__graft_entry__.entry()`: 64 pods x 8
                types, seed 7, 128 rows), with the launch counts set to
                0 before and read after; it must launch B7 once and
                equal the plain version and `entry(device="cpu")`. Then
                the dense ≡ split oracle at full width on what phases 4
                and 6 staged: the first request (50k x 500, ffd), the
                second (its bound rows as one-hot existing_mask rows)
                and reserved_50k's cost arm (planned rows with quotas),
                each on `max_nodes` = the split axis: B7 and `pack_flat`
                (decoded as the host reads it) must equal B1 on every
                assignment, node count, unschedulable tally and free
                row, with the bound rows left one-hot, and B7 must equal
                its plain version byte for byte. B7's CUDA-event times
                on each of them in turns with B1's on the same problem,
                on the entry problem, the epilogue's on the first
                request's outputs, the plain versions', and their
                bounds.
  10. sharded — B8, the config axis split over S shards, on virtual
                meshes of shard slots on the card (`force_virtual_mesh`):
                split B1, B3 (widths 8 and 16) and B2 byte-identical to
                their plain split versions on seeded problems and on
                boundary-tie problems at S in (2, 3, 4, 8), every
                replica equal and the flat buffers equal to the unsplit
                kernels'; split B5 bit-identical to its plain version at
                S in (2, 4). Then, each route with the launch counts set
                to 0 just before it and read just after, launching the
                split kernels and no unsplit packing kernel: the first
                50k x 500 request at S in (2, 3, 4, 8) on the B3 route
                and the KARPENTER_WAVEFRONT=0 B1 route, the second
                request at S=4, reserved_50k's cost solve at S=4 (each
                fingerprint equal to the unsharded card solve's); the
                device LP under KARPENTER_LP_SHARDS=4 (split B5, held to
                its plain version, its gap to the unsplit B5 printed);
                bench.py's million_pod demand (1M pods, 100 types, 400
                signatures) at S=8 with streamed staging, equal to the
                unsharded card solve, with the staging's peak block
                against the full matrices, the node count and the wall;
                the port's `graft_entry.dryrun_multichip(4)`. Every
                split B1, B3 and B2 launch of these routes is recorded
                and held against its plain split version on the same
                inputs, at the shapes the path gave it: byte-identical
                outputs, masks whole, every replica equal. Last, each
                split kernel's CUDA-event time in turns with its unsplit
                kernel's (unsplit, split, split, unsplit) on the first
                request's inputs at S in (2, 4, 8) (B5: reserved_50k's
                LP at S=4), the bounds, and the plain split versions'
                times from the runs that held the first request at S=4.
Kernel times are CUDA-event times taken with a spin kernel holding the
stream while the host launches the timed calls, so they time the
card's work alone; B2 and the lane epilogue are also timed as the host
launches them. Plain versions are timed as the host drives them.
One JSON line {"kernels": [...]} reports every kernel (the split ones
at S=4).
The last line is {"ok": true, "device": {...}}. The script uses one
card: the first of CUDA_VISIBLE_DEVICES (card 0 when it is unset).

Imports torch, numpy and karpenter_tpu_torch only.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

N_PODS, N_TYPES, SEED = 50_000, 500, 42
N_EXTRA = 10_000
WARM_SOLVES = 5
# groups of the request that takes the sequential route by its size
# (the wavefront route needs WAVEFRONT_MIN_GROUPS = 8)
SMALL_GROUPS = 5
WIDTHS = (1, 8, 16, 32)
# config axes the staging never gives the kernels: not a multiple of 32,
# and wider than the consolidation union's 768
ODD_CONFIG_AXES = (200, 800)
OUTPUTS = ("assign", "free_mask", "node_count", "unsched", "steps", "widths")
DENSE_OUTPUTS = ("assign", "node_mask", "node_used", "node_active", "node_count",
                 "unsched")
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores,
# HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# cycles of the spin kernel that `event_ms` queues ahead of each timed
# kernel call: ~0.5 ms at the H100's clock, several times what the host
# takes to launch one call
SPIN_CYCLES_PER_CALL = 1_000_000
# f32 operations per (row, config, requested resource) capacity
# term: subtract, add, divide, floor, min
OPS_PER_CAP_TERM = 5
# the cost phase: the benchmark's reserved_50k and two mid-size
# problems for the card-against-CPU check
COST_PODS, COST_TYPES, COST_ZONAL = 50_000, 500, 0.1
ASCENT_ITERS = (8, 192)
# B5's edge cases (testing.ASCENT_EDGE_CASES): the one whose arrays
# exceed the shared memory, and its iterations (its plain version is
# slow at 192)
GLOBAL_CASE = "ascent-global"
EDGE_ITERS = {GLOBAL_CASE: (8, 32)}
# block barriers in a row that time one barrier (lp_device.barrier_probe)
BARRIER_PROBE = 20_000
# the consolidation phase: bench.py's consolidation_500 (its defaults
# in workloads.consolidation_fleet), a mid-size fleet for the
# card-against-CPU check, the cluster widths held on seeded lane cases
# and the lane width the CPU run forces
MID_FLEET = (3000, 60)
# the argument that runs phases 1-3 and 5 only (`quick_timing`)
QUICK = "--quick"
PROBE_WIDTHS = (8, 16)
CPU_PROBE_WIDTH = 8
PROBE_KNOBS = ("KARPENTER_WAVEFRONT", "KARPENTER_WAVEFRONT_WIDTH",
               "KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_PROBE_LANE_BUCKET")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def one_card() -> str:
    """Narrow CUDA_VISIBLE_DEVICES to its first card (before torch
    initialises CUDA); returns that card's id."""
    card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def nvidia_smi(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def to_cuda(case):
    import numpy as np
    import torch

    def put(x):
        if x is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    return [put(a) for a in case.args], {k: put(v) for k, v in case.kwargs.items()}


def max_abs_diff(a, b) -> float:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return float("inf")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0


def event_ms(fn, reps: int, queued: bool = True) -> float:
    """CUDA-event ms a call of `fn`, over `reps` calls. Queued (the
    kernels), a spin kernel holds the stream while the host launches the
    calls, so the events time the card's work alone, not the host's
    launch path; unqueued (the plain versions), a call as the host
    drives it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold(kernels, case, err: dict, widths=(16,)) -> str:
    """Run B1, B3 at each of `widths`, and B2
    on both routes, and their plain versions, on the card on `case`;
    fail unless every output is byte-identical and B3's outputs equal
    B1's. Returns a summary."""
    import torch

    args, kw = to_cuda(case)
    got = kernels.pack_split(*args, max_free=case.max_free, mode=case.mode, **kw)
    torch.cuda.synchronize()
    want = kernels.pack_split_ref(*args, max_free=case.max_free, mode=case.mode, **kw)
    torch.cuda.synchronize()
    for label, a, b in zip(OUTPUTS, got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            fail(f"pack_split differs from pack_split_ref on {case.name}: {label}")
        err["pack_split"] = max(err["pack_split"], max_abs_diff(a, b))
    flats = [(got, ())]
    rounds = []
    for width in widths:
        wf = kernels.pack_split_wavefront(
            *args, max_free=case.max_free, mode=case.mode, width=width, **kw)
        torch.cuda.synchronize()
        wf_ref = kernels.pack_split_wavefront_ref(
            *args, max_free=case.max_free, mode=case.mode, width=width, **kw)
        torch.cuda.synchronize()
        for label, a, b in zip(OUTPUTS, wf, wf_ref):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                fail(f"pack_split_wavefront (width {width}) differs from "
                     f"pack_split_wavefront_ref on {case.name}: {label}")
            err["pack_split_wavefront"] = max(err["pack_split_wavefront"], max_abs_diff(a, b))
        for label, a, b in zip(OUTPUTS, wf, got):
            if not torch.equal(a, b):
                fail(f"pack_split_wavefront (width {width}) differs from "
                     f"pack_split on {case.name}: {label}")
        flats.append((wf[:4], (wf[5], wf[4])))
        rounds.append(f"W{width}:{int(wf[4])}")
    # B2 takes whole mask words: a config axis that is a multiple of 32
    for outs, stats in flats if args[0].shape[1] % 32 == 0 else ():
        flat = kernels.pack_flat_words(*outs, *stats)
        flat_ref = kernels.pack_flat_words_ref(*outs, *stats)
        torch.cuda.synchronize()
        if flat.dtype != flat_ref.dtype or not torch.equal(flat, flat_ref):
            fail(f"pack_flat_words differs from pack_flat_words_ref on {case.name}")
        err["pack_split_flat"] = max(err["pack_split_flat"], max_abs_diff(flat, flat_ref))
    B = args[7].shape[0]
    return (f"  case {case.name} mode={case.mode} Gp={args[0].shape[0]} "
            f"Cp={args[0].shape[1]} B={B} F={case.max_free}: nodes={int(got[2])} "
            f"bound_pods={int(got[0][:B].sum())} unsched={int(got[3].sum())} "
            f"rounds {' '.join(rounds)} identical")


def same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def hold_price(lp_plan, name: str, xs, err: dict) -> str:
    """B4 against its plain version on the card: bit-identical q and
    value, or fail."""
    import torch

    q, v = lp_plan.price_kernel(*xs)
    torch.cuda.synchronize()
    qr, vr = lp_plan.price_kernel_ref(*xs)
    torch.cuda.synchronize()
    if not (same_bits(q, qr) and same_bits(v, vr)):
        fail(f"lp_price differs from price_kernel_ref on {name}")
    err["lp_price"] = max(err["lp_price"], max_abs_diff(q, qr), max_abs_diff(v, vr))
    return (f"  case {name} Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} "
            f"R={xs[2].shape[1]}: pods planned {int(q.sum())}, hits at price 0 "
            f"{int((v > 0).sum())} identical")


def hold_ascent(lp_device, name: str, a, n_iters: int, err: dict) -> str:
    """B5 against its plain version on the card: bit-identical best,
    duals and last improving iteration, or fail."""
    import torch

    got = lp_device.ascend(a, n_iters)
    torch.cuda.synchronize()
    want = lp_device.ascend_ref(a, n_iters)
    torch.cuda.synchronize()
    if not all(same_bits(x, y) for x, y in zip(got, want)):
        fail(f"lp_ascend differs from ascend_ref on {name}")
    err["lp_ascend"] = max(err["lp_ascend"], *(max_abs_diff(x, y) for x, y in zip(got, want)))
    return (f"  case {name} Gp={a.compat.shape[0]} Cp={a.compat.shape[1]} "
            f"Kp={a.onehot.shape[0]}: best {float(got[0]):.6f} last improving "
            f"iteration {int(got[2])} identical")


def price_ops(q, R: int) -> int:
    """The f32 operations B4 must do on inputs that gave `q`: per
    config, one round per group it took plus the round that found
    nothing (a taken group never fits again), each testing every group:
    per requested resource add, divide, floor and min, then the cap,
    the k >= 1 test and the argmax compare."""
    Gp = q.shape[1]
    rounds = (q > 0).sum(dim=1).clamp(max=Gp - 1) + 1
    return int(rounds.sum()) * Gp * (4 * R + 3)


def ascent_ops(a, n_iters: int) -> int:
    """The f32 operations B5 does for `n_iters` iterations on these
    shapes: per iteration one bound evaluation (ratios; the max and its
    ties over groups for every (config, resource); the value bounds,
    theta, excess and cap duals; two dot products) and one
    supergradient (the cap and theta ties; the (group, resource) sums
    over configs, two operations a term; the sums over resources; the
    step)."""
    Gp, Cp = a.compat.shape
    R = a.req.shape[1]
    Kp = a.onehot.shape[0]
    bound = Gp * R + 2 * Gp * Cp * R + 3 * Cp * R + 6 * Cp + 2 * Kp * Cp + 4 * Gp + 2 * Kp
    grad = Kp * Cp + 3 * Gp + 12 * Cp + 6 * Cp * R + 2 * Gp * R * Cp + 2 * Gp * R + 8 * Gp
    return (n_iters + 1) * bound + n_iters * grad


def histogram(widths) -> dict:
    """Rounds per committed width, {width: rounds}."""
    out: dict[int, int] = {}
    for w in widths.tolist():
        out[int(w)] = out.get(int(w), 0) + 1
    return dict(sorted(out.items()))


def b1_ops(kernels, args, kw, max_free: int) -> int:
    """The f32 operations B1 must do on these inputs: per group with
    demand, one capacity term per requested resource for each live
    bound row the group may use, and for each (opened fresh row,
    config) pair that is still in the row's mask and compatible with
    the group, with the masks as they stand when the group starts
    (replayed through the plain version). The prefix scan and the
    open picks are left out, so the bound is a floor."""
    compat, group_req = args[0], args[1]
    bound_compat, bound_live = args[6], args[10]
    B = bound_live.shape[0]
    n_req = (group_req > 0).sum(dim=1).tolist()
    bound_ok = (bound_compat & bound_live[None, :]).sum(dim=1).tolist()
    terms = [0]

    def on_group(g, free_mask, node_count):
        nfresh = node_count - B
        fresh = int((free_mask[:nfresh] & compat[g][None, :]).sum()) if nfresh else 0
        terms[0] += (bound_ok[g] + fresh) * n_req[g]

    kernels.pack_split_ref(*args, max_free=max_free, mode="ffd", on_group=on_group, **kw)
    return terms[0] * OPS_PER_CAP_TERM


def cost_phase(kernels, lp_plan, lp_device, pack, solver, build_problem,
               heterogeneous_instance_types, err: dict, launches: dict) -> dict:
    """Phase 6: the cost objective on reserved_50k through `solve()`,
    with its inputs recorded; returns what phase 7 times."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.testing import KernelCase, root_node_mips

    pods, pools = build_problem(COST_PODS, COST_TYPES, seed=SEED,
                                reservations=True, zonal_frac=COST_ZONAL)
    real = {name: getattr(mod, name) for mod, name in (
        (lp_plan, "price_kernel"), (lp_plan, "_price_patterns"), (lp_plan, "plan"),
        (lp_device, "ascend"), (lp_device, "maybe_solve"), (pack, "stage"),
        (pack, "pack_split_flat"), (solver, "_solve_packing"),
        (solver, "_finish_winner"), (solver, "_build_solution_arrays"),
        (solver, "group_pods"), (solver, "encode"))}
    owner = {"price_kernel": lp_plan, "_price_patterns": lp_plan, "plan": lp_plan,
             "ascend": lp_device, "maybe_solve": lp_device, "stage": pack,
             "pack_split_flat": pack}
    rec = {"price": [], "pp_calls": 0, "ascents": [], "plans": [], "cases": {},
           "mode_launches": {"ffd": {}, "cost": {}}, "times": {}, "mode": "ffd",
           "arm": None, "base_price": None}

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                rec["times"][key] = rec["times"].get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    def price_kernel(*xs):
        rec["price"].append((rec["pp_calls"], [x.clone() for x in xs]))
        return real["price_kernel"](*xs)

    def price_patterns(*a, **k):
        rec["pp_calls"] += 1
        return real["_price_patterns"](*a, **k)

    def plan(*a, **k):
        out = real["plan"](*a, **k)
        rec["plans"].append(out)
        return out

    def ascend(inputs, n_iters):
        rec["ascents"].append((inputs, n_iters))
        return real["ascend"](inputs, n_iters)

    def stage(*a, **k):
        st = real["stage"](*a, **k)
        if rec["arm"] == "cost":
            rec["cost_staged"] = st  # the planned pack, for phase 9
        if rec["mode"] == "cost":
            key = tuple(None if x is None else x.shape
                        for x in (*st.args, *st.kwargs.values())) + (st.max_free,)
            rec["cases"].setdefault(key, KernelCase(
                f"cost-path-B{st.args[7].shape[0]}", st.args, st.kwargs,
                st.max_free, "cost"))
        return st

    def pack_split_flat(*a, mode="ffd", **k):
        before = dict(kernels.LAUNCHES)
        out = real["pack_split_flat"](*a, mode=mode, **k)
        torch.cuda.synchronize()
        tally = rec["mode_launches"][mode]
        for name, n in kernels.LAUNCHES.items():
            tally[name] = tally.get(name, 0) + n - before[name]
        return out

    def solve_packing(enc, mode, device, plan=None, shards=0):
        arm = "ffd" if plan is None else (
            "cost" if enc.cfg_price is rec["base_price"] else "rank")
        rec["mode"], rec["arm"] = mode, arm
        return timed(f"pack {arm}", real["_solve_packing"])(enc, mode, device, plan, shards)

    def encode(*a, **k):
        enc = real["encode"](*a, **k)
        rec["base_price"] = enc.cfg_price
        return enc

    wrapped = {
        "price_kernel": price_kernel, "_price_patterns": price_patterns,
        "plan": timed("plan", plan), "ascend": ascend,
        "maybe_solve": timed("ascent", real["maybe_solve"]), "stage": stage,
        "pack_split_flat": pack_split_flat, "_solve_packing": solve_packing,
        "_finish_winner": timed("merge/trim", real["_finish_winner"]),
        "_build_solution_arrays": timed("decode", real["_build_solution_arrays"]),
        "group_pods": timed("encode", real["group_pods"]),
        "encode": timed("encode", encode),
    }

    def install(table):
        for name, fn in table.items():
            setattr(owner.get(name, solver), name, fn)

    def all_counts():
        return {**kernels.LAUNCHES, **lp_plan.LAUNCHES, **lp_device.LAUNCHES}

    def reset_counts():
        kernels.reset_launch_counts()
        for table in (lp_plan.LAUNCHES, lp_device.LAUNCHES):
            for name in table:
                table[name] = 0

    solver.reset_caches()
    install(wrapped)
    try:
        reset_counts()
        t0 = time.perf_counter()
        sol = solver.solve(pods, pools, objective="cost")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        breakdown = dict(rec["times"])
        warm, warm_sols = [], []
        for _ in range(WARM_SOLVES):
            t0 = time.perf_counter()
            warm_sols.append(solver.solve(pods, pools, objective="cost"))
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        launches["cost"] = all_counts()
    finally:
        install(real)
    ffd = solver.solve(pods, pools)
    torch.cuda.synchronize()
    n = launches["cost"]
    cost_mode = rec["mode_launches"]["cost"]
    if n["lp_price"] < 1 or n["lp_ascend"] < 1:
        fail(f"the cost path did not launch B4 and B5: {n}")
    if cost_mode.get("pack_split", 0) + cost_mode.get("pack_split_wavefront", 0) < 1:
        fail(f"the cost path launched no packing kernel in cost mode: {rec['mode_launches']}")
    fleet_plan = rec["plans"][0] if rec["plans"] else None
    if fleet_plan is None or not sol.lp or not sol.lp.get("guided"):
        fail(f"the cost solve was not planned and guided: lp={sol.lp}")
    fp = solver.fingerprint(sol)
    if any(solver.fingerprint(w) != fp for w in warm_sols):
        fail("warm cost solves differ from the cold one")
    placed = sum(len(p.pods) for p in sol.new_nodes) + sum(len(e.pods) for e in sol.existing)
    if placed + len(sol.unschedulable) != COST_PODS:
        fail(f"cost solve: {placed} placed + {len(sol.unschedulable)} unschedulable "
             f"!= {COST_PODS} pods")
    if sol.total_price > ffd.total_price + 1e-6:
        fail(f"cost fleet ${sol.total_price:.6f}/h costs more than FFD's "
             f"${ffd.total_price:.6f}/h")
    if sol.lp["lower_bound"] > sol.total_price + 1e-6:
        fail(f"certified bound {sol.lp['lower_bound']} above the fleet price "
             f"{sol.total_price}")
    d = fleet_plan.debug
    say(f"phase 6 cost: {COST_PODS} pods x {COST_TYPES} types, reservations, zonal "
        f"{COST_ZONAL} -> {len(sol.new_nodes)} nodes "
        f"({sum(1 for n in sol.new_nodes if n.reservation_id)} reserved), "
        f"{len(sol.unschedulable)} unschedulable, ${sol.total_price:.6f}/h against "
        f"FFD's ${ffd.total_price:.6f}/h ({len(ffd.new_nodes)} nodes) | certified bound "
        f"{sol.lp['lower_bound']:.6f}, device bound {sol.lp['device_bound']:.6f} "
        f"({sol.lp['device_iterations']} iterations, converged "
        f"{sol.lp['device_converged']}), estimate {sol.lp['estimate']:.6f}, trim saved "
        f"${sol.lp['trim_saved']:.6f}/h")
    say(f"  column generation: {d['iters']} rounds, stopped by {d['stop']}, "
        f"integer covering {d['cover']}, "
        f"{d['patterns']} patterns, {len(fleet_plan.planned_cols)} planned nodes, "
        f"{d['price_calls']} B4 calls in {d['price_wall_s']:.6f}s of {d['plan_wall_s']:.6f}s")
    say(f"  cold {cold_s:.6f}s, breakdown (s): "
        + ", ".join(f"{k} {v:.6f}" for k, v in breakdown.items())
        + f" | warm median {statistics.median(warm):.6f}s "
        f"({', '.join(f'{w:.6f}' for w in warm)})")
    say(f"  launches: {json.dumps(n)}; packing kernels by mode "
        f"{json.dumps(rec['mode_launches'])}")

    # the kernels against their plain versions on this run's inputs
    t0 = time.perf_counter()
    calls = rec["price"]
    first_round = min(c for c, _ in calls if c > 1) if any(c > 1 for c, _ in calls) else None
    picks = {"seed": next(xs for c, xs in calls if c == 1)}
    if first_round is not None:
        picks["first round"] = next(xs for c, xs in calls if c == first_round)
        picks["last round"] = next(xs for c, xs in calls if c == calls[-1][0])
    for label, xs in picks.items():
        say(hold_price(lp_plan, f"reserved_50k {label}", xs, err))
    inputs, n_iters = rec["ascents"][0]
    say(hold_ascent(lp_device, "reserved_50k", inputs, n_iters, err))
    for case in rec["cases"].values():
        say(hold(kernels, case, err))
    say(f"  recorded inputs: B4 ({', '.join(picks)}), B5 and "
        f"{len(rec['cases'])} cost-mode pack shapes identical to the plain "
        f"versions ({time.perf_counter() - t0:.3f}s)")

    # the card against the CPU path on two mid-size problems
    hpods, hpools = build_problem(2000, 80, seed=5)
    hpools = [(hpools[0][0], heterogeneous_instance_types(80))]
    checks = [("hetero 2000x80", hpods, hpools),
              ("reservations 5000x100", *build_problem(5000, 100, seed=SEED,
                                                      reservations=True))]
    # the planner's HiGHS MIPs stop at wall-clock limits, so the same
    # plan can round differently under another load: both runs stop
    # them after the root node instead, the same work on both sides
    for name, cpods, cpools in checks:
        stops, fps = [], []
        for device in (None, "cpu"):
            solver.reset_caches()
            rec["plans"].clear()
            lp_plan.plan = plan
            try:
                with root_node_mips():
                    t0 = time.perf_counter()
                    out = solver.solve(cpods, cpools, objective="cost", device=device)
                    wall = time.perf_counter() - t0
            finally:
                lp_plan.plan = real["plan"]
            p = rec["plans"][0]
            stops.append(p.debug["stop"] if p is not None else None)
            fps.append(solver.fingerprint(out))
            say(f"  {name} on {device or 'the card'}: ${out.total_price:.6f}/h, "
                f"{len(out.new_nodes)} nodes, column generation stopped by "
                f"{stops[-1]} after {p.debug['iters'] if p else 0} rounds, estimate "
                f"{p.objective_estimate if p else float('nan'):.6f}, "
                f"{len(p.planned_cols) if p else 0} planned nodes, {wall:.3f}s")
        if any(stop not in ("converged", "stall") for stop in stops):
            fail(f"{name}: column generation did not end by convergence or stall: {stops}")
        if fps[0] != fps[1]:
            fail(f"{name}: the card's cost fingerprint differs from the CPU path's")
    solver.reset_caches()
    say("  card and CPU fingerprints equal on both problems")
    return {"price_inputs": picks.get("first round", picks["seed"]),
            "ascent": rec["ascents"][0], "staged": rec["cost_staged"]}


def hold_dense(pd, kernels, case, err: dict) -> str:
    """B7 and its flat epilogue against their plain versions on the card
    on `case` (a testing.DenseCase), byte for byte on every output, and
    the dense ≡ split oracle against B1 on the same problem; fail
    otherwise. Returns a summary."""
    import torch

    from karpenter_tpu_torch.testing import split_mismatch

    args, kw = to_cuda(case)
    got = pd.pack(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    torch.cuda.synchronize()
    want = pd.pack_ref(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    torch.cuda.synchronize()
    for label, a, b in zip(DENSE_OUTPUTS, got, want):
        if not same_bits(a, b):
            fail(f"pack differs from pack_ref on {case.name}: {label}")
        err["pack"] = max(err["pack"], max_abs_diff(a, b))
    flat = pd.pack_flat(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    torch.cuda.synchronize()
    flat_ref = pd.pack_flat_ref(*args, max_nodes=case.max_nodes, mode=case.mode, **kw)
    if not same_bits(flat, flat_ref):
        fail(f"pack_flat differs from pack_flat_ref on {case.name}")
    err["pack_flat"] = max(err["pack_flat"], max_abs_diff(flat, flat_ref))
    s_args, s_kw = to_cuda(case.split)
    split = kernels.pack_split(*s_args, max_free=case.split.max_free, mode=case.mode, **s_kw)
    bad = split_mismatch(got, split, args[6])
    if bad is not None:
        fail(f"pack differs from pack_split (B1) on {case.name}: {bad}")
    return (f"  dense case {case.name} mode={case.mode} Gp={args[0].shape[0]} "
            f"Cp={args[0].shape[1]} N={case.max_nodes} E={case.Ep}: nodes={int(got[4])} "
            f"unsched={int(got[5].sum())} identical, equal to B1")


def decode_dense_flat(flat, N: int, G: int, C: int):
    """`pack_flat`'s buffer read on the host as the JAX package's fetch
    reads it: (assign [N, G], node_mask [N, C], None, None, node_count,
    unsched), the places of node_used and node_active empty."""
    import numpy as np

    u = flat.cpu().numpy().view(np.uint32)
    W = C // 32
    o0 = N * G
    o1 = o0 + N * W
    words = np.ascontiguousarray(u[o0:o1].reshape(N, W))
    bits = np.unpackbits(words.view(np.uint8).reshape(N, W * 4), axis=1,
                         bitorder="little")
    return (u[:o0].reshape(N, G).astype(np.int32), bits[:, :C].astype(bool),
            None, None, np.int32(u[o1]), u[o1 + 1:o1 + 1 + G].astype(np.int32))


def b7_ops(pd, args, kw, max_nodes: int, mode: str) -> int:
    """The f32 operations B7 must do on these inputs: per group with
    demand, one capacity term per requested resource for each (row below
    node_count, config) pair still in the row's mask and compatible with
    the group, with the masks as they stand when the group starts
    (replayed through the plain version). The prefix scan, the usage
    update and the open picks are left out, so the bound is a floor."""
    compat, group_req = args[0], args[1]
    n_req = (group_req > 0).sum(dim=1).tolist()
    terms = [0]

    def on_group(g, node_mask, node_count):
        pairs = int((node_mask[:node_count] & compat[g][None, :]).sum())
        terms[0] += pairs * n_req[g]

    pd.pack_ref(*args, max_nodes=max_nodes, mode=mode, on_group=on_group, **kw)
    return terms[0] * OPS_PER_CAP_TERM


def bound(ops: int, nb: int):
    """(ms, "operations" or "bytes"): the least time the card could take
    for `ops` f32 operations and `nb` bytes moved."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nb / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def dense_phase(pd, kernels, graft_entry, staged: dict, err: dict, smi: str) -> dict:
    """Phase 9: B7 on the card. The port's `graft_entry.entry()` (one
    launch of B7), then the dense ≡ split oracle at full width on the
    requests phases 4 and 6 staged, then B7's and its epilogue's times;
    returns the kernels' report entries and the launches."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.testing import dense_case, split_mismatch

    t_phase = time.perf_counter()
    launches = {}

    # ---- the entry problem, as the JAX package's __graft_entry__ runs it
    pd.reset_launch_counts()
    fn, e_args = graft_entry.entry()
    e_out = fn(*e_args)
    torch.cuda.synchronize()
    launches["entry"] = dict(pd.LAUNCHES)
    if launches["entry"]["pack"] != 1:
        fail(f"entry() launched {launches['entry']}: expected B7 once")
    e_ref = pd.pack_ref(*e_args, max_nodes=graft_entry.MAX_NODES)
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    e_cpu = cpu_fn(*cpu_args)
    for label, a, b, c in zip(DENSE_OUTPUTS, e_out, e_ref, e_cpu):
        if not (same_bits(a, b) and same_bits(a.cpu(), c)):
            fail(f"entry(): B7 differs from the plain version on the card or "
                 f"the CPU: {label}")
        err["pack"] = max(err["pack"], max_abs_diff(a, b))
    say(f"phase 9 dense: entry() (Gp={e_args[0].shape[0]} Cp={e_args[0].shape[1]} "
        f"N={graft_entry.MAX_NODES}) launched {json.dumps(launches['entry'])}: "
        f"nodes={int(e_out[4])} unsched={int(e_out[5].sum())}, equal to the plain "
        f"version on the card and on the CPU")

    # ---- full width: each request's staged split problem laid out
    # densely, max_nodes = Ep + max_free; B7 (and pack_flat, decoded as
    # the host would) against B1 on the same problem
    cases = [dense_case(st, name, mode) for name, (st, mode) in staged.items()]
    inputs = {c.name: to_cuda(c) for c in cases}
    pd.reset_launch_counts()
    outs, rows = {}, []
    for c in cases:
        args, kw = inputs[c.name]
        s_args, s_kw = to_cuda(c.split)
        t0 = time.perf_counter()
        got = pd.pack(*args, max_nodes=c.max_nodes, mode=c.mode, **kw)
        flat = pd.pack_flat(*args, max_nodes=c.max_nodes, mode=c.mode, **kw)
        split = kernels.pack_split(*s_args, max_free=c.split.max_free, mode=c.mode, **s_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = split_mismatch(got, split, args[6])
        host = [x.cpu().numpy() for x in split]
        decoded = decode_dense_flat(flat, c.max_nodes, args[0].shape[0], args[0].shape[1])
        bad = bad or split_mismatch(decoded, host, args[6].cpu().numpy())
        if bad is not None:
            fail(f"full width {c.name}: B7 differs from B1 (pack_split): {bad}")
        outs[c.name] = got
        rows.append(f"{c.name} ({c.mode}, Gp={args[0].shape[0]} Cp={args[0].shape[1]} "
                    f"E={c.Ep} N={c.max_nodes}): nodes={int(got[4])} "
                    f"bound pods={int(got[0][:c.Ep].sum())} unsched={int(got[5].sum())}, "
                    f"{wall:.3f}s for B7, pack_flat and B1")
    torch.cuda.synchronize()
    launches["full width"] = dict(pd.LAUNCHES)
    n = launches["full width"]
    if n["pack"] != 2 * len(cases) or n["pack_flat"] != len(cases):
        fail(f"the full-width oracle launched {n}: expected B7 twice and its "
             f"epilogue once per request")
    say(f"  full width, B7 equal to B1 on assignments, node counts, "
        f"unschedulable pods and free rows, bound rows one-hot, launches "
        f"{json.dumps(n)}:")
    for row in rows:
        say(f"    {row}")

    # ---- the plain version on each request (timed on the first), and
    # B7's and the epilogue's CUDA-event times
    first = cases[0]
    for c in cases:
        args, kw = inputs[c.name]
        t0 = time.perf_counter()
        want = pd.pack_ref(*args, max_nodes=c.max_nodes, mode=c.mode, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for label, a, b in zip(DENSE_OUTPUTS, outs[c.name], want):
            if not same_bits(a, b):
                fail(f"full width {c.name}: pack differs from pack_ref: {label}")
            err["pack"] = max(err["pack"], max_abs_diff(a, b))
        if c is first:
            b7_plain_ms = plain_s * 1e3
    # B7 and B1 on the same problem, in turns on the same card (B7, B1,
    # B1, B7), on each request
    times = {}
    for c in cases:
        args, kw = inputs[c.name]
        s_args, s_kw = to_cuda(c.split)
        b7 = (lambda args=args, kw=kw, c=c:
              pd.pack(*args, max_nodes=c.max_nodes, mode=c.mode, **kw))
        b1 = (lambda s_args=s_args, s_kw=s_kw, c=c:
              kernels.pack_split(*s_args, max_free=c.split.max_free, mode=c.mode, **s_kw))
        b7_runs, b1_runs = [event_ms(b7, 3)], [event_ms(b1, 3), event_ms(b1, 3)]
        b7_runs.append(event_ms(b7, 3))
        times[c.name] = (b7_runs, b1_runs)
    args, kw = inputs[first.name]
    N = first.max_nodes
    b7_ms = statistics.mean(times[first.name][0])
    e_ms = event_ms(lambda: fn(*e_args), 50)
    e_plain_ms = event_ms(lambda: pd.pack_ref(*e_args, max_nodes=graft_entry.MAX_NODES),
                          2, queued=False)
    o = outs[first.name]
    fw_in = (o[0], o[1], o[4], o[5])
    flat_ms = event_ms(lambda: pd.flat_words(*fw_in), 50)
    flat_host_ms = event_ms(lambda: pd.flat_words(*fw_in), 50, queued=False)
    flat_plain_ms = event_ms(lambda: kernels.pack_flat_words_ref(*fw_in), 20,
                             queued=False)
    flat = pd.flat_words(*fw_in)
    if not same_bits(flat, kernels.pack_flat_words_ref(*fw_in)):
        fail("pack_flat's epilogue differs from its plain version at full width")

    b7_op_count = b7_ops(pd, args, kw, N, first.mode)
    b7_bytes = nbytes(list(args) + list(kw.values())) + nbytes(o)
    b7_bound, b7_by = bound(b7_op_count, b7_bytes)
    flat_bound, flat_by = bound(o[1].numel(), nbytes(fw_in) + nbytes([flat]))
    for name, (b7_runs, b1_runs) in times.items():
        say(f"  {name}: B7 {', '.join(f'{x:.4f}' for x in b7_runs)} ms, B1 "
            f"{', '.join(f'{x:.4f}' for x in b1_runs)} ms on the same problem")
    say(f"  timing on {first.name} (Gp={args[0].shape[0]} Cp={args[0].shape[1]} "
        f"N={N} R={args[1].shape[1]}): B7 {b7_ms:.4f} ms, plain "
        f"{b7_plain_ms:.1f} ms; ops={b7_op_count} bytes={b7_bytes}; epilogue "
        f"{flat_ms:.6f} ms on the card, {flat_host_ms:.6f} ms a call as the host "
        f"launches it, plain {flat_plain_ms:.3f} ms | entry problem: B7 {e_ms:.6f} ms, "
        f"plain {e_plain_ms:.3f} ms | card: {smi}")
    say(f"  phase 9 took {time.perf_counter() - t_phase:.3f}s")
    return {"launches": launches, "entries": [
        {"name": "pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_dense.cu",
         "replaces": "karpenter_tpu/solver/pack.py:164",
         "launches": sum(x["pack"] for x in launches.values()),
         "max_abs_err": err["pack"], "ms": b7_ms, "plain_ms": b7_plain_ms,
         "bound_ms": b7_bound, "bound_by": b7_by, "library_ms": None},
        {"name": "pack_flat", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_flat.cu",
         "replaces": "karpenter_tpu/solver/pack.py:431",
         "launches": sum(x["pack_flat"] for x in launches.values()),
         "max_abs_err": err["pack_flat"], "ms": flat_ms, "plain_ms": flat_plain_ms,
         "bound_ms": flat_bound, "bound_by": flat_by, "library_ms": None},
    ]}


def same_outputs(got, want) -> bool:
    return len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want))


def hold_lanes(kernels, name, args, kw, max_free, mode, err, widths=PROBE_WIDTHS,
               plain=None) -> str:
    """B6's sequential and wavefront programs and its lane epilogue
    against their plain versions on the card (`plain` may hold the
    plain outputs already computed, keyed "seq" and by width); fail
    unless byte-identical and the wavefront's first four outputs equal
    the sequential's. Returns a summary."""
    import torch

    plain = plain or {}
    seq = kernels.pack_probe_lanes(*args, max_free=max_free, mode=mode, **kw)
    torch.cuda.synchronize()
    want = plain.get("seq") or kernels.pack_probe_lanes_ref(
        *args, max_free=max_free, mode=mode, **kw)
    if not same_outputs(seq, want):
        fail(f"pack_probe_lanes differs from pack_probe_lanes_ref on {name} ({mode})")
    err["pack_probe_lanes"] = max(err["pack_probe_lanes"],
                                  *(max_abs_diff(a, b) for a, b in zip(seq, want)))
    flats = [seq]
    rounds = []
    for width in widths:
        wf = kernels.pack_probe_lanes_wavefront(
            *args, max_free=max_free, mode=mode, width=width, **kw)
        torch.cuda.synchronize()
        want = plain.get(width) or kernels.pack_probe_lanes_wavefront_ref(
            *args, max_free=max_free, mode=mode, width=width, **kw)
        if not same_outputs(wf, want):
            fail(f"pack_probe_lanes_wavefront (width {width}) differs from its plain "
                 f"version on {name} ({mode})")
        if not same_outputs(wf[:4], seq):
            fail(f"pack_probe_lanes_wavefront (width {width}) differs from "
                 f"pack_probe_lanes on {name} ({mode})")
        err["pack_probe_lanes_wavefront"] = max(
            err["pack_probe_lanes_wavefront"], *(max_abs_diff(a, b) for a, b in zip(wf, want)))
        flats.append((*wf[:4], wf[5], wf[4]))
        rounds.append(f"W{width}:{int(wf[4].max())}")
    for outs in flats:
        flat = kernels.pack_flat_lanes(*outs)
        flat_ref = kernels.pack_flat_lanes_ref(*outs)
        torch.cuda.synchronize()
        if not same_outputs([flat], [flat_ref]):
            fail(f"pack_flat_lanes differs from pack_flat_lanes_ref on {name} ({mode})")
        err["pack_probe_lanes_flat"] = max(err["pack_probe_lanes_flat"],
                                           max_abs_diff(flat, flat_ref))
    lanes = args[2].shape[0]
    return (f"  lanes {name} mode={mode} Lp={lanes} Gp={args[0].shape[0]} "
            f"Cp={args[0].shape[1]} B={args[7].shape[0]} F={max_free}: nodes "
            f"{int(seq[2].min())}..{int(seq[2].max())}, unschedulable "
            f"{int(seq[3].sum())}, most rounds {' '.join(rounds)} identical")


def timed_once(fn):
    """(CUDA-event ms, result) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class DeviceSpans:
    """Brackets calls with CUDA events; `per_cycle` adds their device
    time up by the ladder cycle each began in. A span runs from its
    start event to its end event on the stream: the call's kernels
    (output fills included), and any wait for the host's next launch
    inside the call."""

    def __init__(self):
        self.spans = []  # (time.perf_counter() at the call, start, end)

    def wrap(self, fn):
        import torch

        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = fn(*a, **k)
            end.record()
            self.spans.append((t, start, end))
            return out
        return call

    def per_cycle(self, ladder) -> tuple[list, list, list]:
        """(device ms, calls) per cycle of `ladder`, and every span's
        ms; calls before the first cycle (arm (c)'s warm staging) are
        left out."""
        import torch

        torch.cuda.synchronize()
        ms, calls, each = [0.0] * len(ladder.walls), [0] * len(ladder.walls), []
        for t, start, end in self.spans:
            c = bisect.bisect_right(ladder.begins, t) - 1
            if c < 0:
                continue
            dt = start.elapsed_time(end)
            ms[c] += dt
            calls[c] += 1
            each.append(dt)
        self.spans = []
        return ms, calls, each


def cycle_report(name: str, ladder, ms, calls) -> str:
    """One arm's walls beside its packing calls' device time."""
    cells = [f"{w:.6f}s/{m:.4f}ms/{n}/{m / 1e3 / w:.6f}"
             for w, m, n in zip(ladder.walls, ms, calls)]
    total = sum(ms) / 1e3 / sum(ladder.walls)
    return (f"  {name} per cycle (wall/packing device ms/calls/device share): "
            f"{', '.join(cells)}; device share of the arm {total:.6f}")


def probe_phase(kernels, cb, lp_device, cuda_build, err: dict, smi: str) -> dict:
    """Phase 8: bench.py's consolidation_500 on the card, arms (a) and
    (c), the routes, the holds, the pruner, the card against the CPU
    and B6's timing; returns the kernels' report entries."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import pack
    from karpenter_tpu_torch.solver.pack import probe_batch_width
    from karpenter_tpu_torch.testing import (
        Candidate,
        NodeRef,
        consolidation_ladder,
        lane_cases,
    )
    from karpenter_tpu_torch.workloads import consolidation_fleet

    for knob in PROBE_KNOBS:
        os.environ.pop(knob, None)
    err.update({"pack_probe_lanes": 0.0, "pack_probe_lanes_wavefront": 0.0,
                "pack_probe_lanes_flat": 0.0})
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fleet = consolidation_fleet()
    torch.cuda.synchronize()
    pools, nodes0, prices0, pods_on0 = fleet
    fleet_s = time.perf_counter() - t0

    # the first cycle's first chunk (and every other dispatch's inputs,
    # by staging): the lane solver's stagings are counted so the warm
    # staging of arm (c) can be told from the first cycle's
    rec = {"staging": 0, "calls": []}
    real_lazy = cb.LaneSolver.solve_lazy
    real_flat = kernels.pack_probe_lanes_flat

    def solve_lazy(self, *a, **k):
        rec["staging"] += 1
        return real_lazy(self, *a, **k)

    def pack_probe_lanes_flat(*a, **k):
        rec["calls"].append((rec["staging"], a, k))
        return real_flat(*a, **k)

    launches: dict[str, dict] = {}
    stats: dict[str, dict] = {}

    def drive(route: str, fn):
        kernels.reset_launch_counts()
        cb.reset_probe_stats()
        out = fn()
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
        stats[route] = dict(cb.PROBE_STATS)
        return out

    # arm (a)'s probes reach the packing kernels through pack.py's
    # pack_split_flat, arm (c)'s chunks through the lane solver's
    # pack_probe_lanes_flat (and pack_split_flat for a chunk of one)
    spans = DeviceSpans()
    real_pack_flat, real_split_flat = pack.pack_split_flat, kernels.pack_split_flat
    pack.pack_split_flat = spans.wrap(real_pack_flat)
    try:
        arm_a = drive("arm (a)", lambda: consolidation_ladder(*fleet, batched=False,
                                                              device="cuda"))
    finally:
        pack.pack_split_flat = real_pack_flat
    a_ms, a_calls, a_each = spans.per_cycle(arm_a)
    cb.LaneSolver.solve_lazy = solve_lazy
    kernels.pack_probe_lanes_flat = spans.wrap(pack_probe_lanes_flat)
    kernels.pack_split_flat = spans.wrap(real_split_flat)
    try:
        arm_c = drive("arm (c)", lambda: consolidation_ladder(
            *fleet, batched=True, device="cuda", fresh=arm_a.fresh))
    finally:
        cb.LaneSolver.solve_lazy, kernels.pack_probe_lanes_flat = real_lazy, real_flat
        kernels.pack_split_flat = real_split_flat
    c_ms, c_calls, _ = spans.per_cycle(arm_c)
    eps = 1e-6 + 1e-4 * abs(arm_a.price)
    if arm_a.decisions != arm_c.decisions or abs(arm_a.price - arm_c.price) >= eps:
        fail(f"consolidation_500: arm (c) decided {arm_c.decisions} (${arm_c.price:.6f}/h), "
             f"arm (a) {arm_a.decisions} (${arm_a.price:.6f}/h)")
    if not arm_a.decisions:
        fail("consolidation_500: no cycle consolidated anything")
    for route, knob, value in (("KARPENTER_WAVEFRONT=0", "KARPENTER_WAVEFRONT", "0"),
                               ("KARPENTER_PROBE_BATCH_WIDTH=1",
                                "KARPENTER_PROBE_BATCH_WIDTH", "1")):
        os.environ[knob] = value
        try:
            one = drive(route, lambda: consolidation_ladder(*fleet, batched=True,
                                                            device="cuda", cycles=1))
        finally:
            os.environ.pop(knob, None)
        if one.decisions != arm_c.decisions[:1] or one.probes != {
                k: v for k, v in arm_c.probes.items() if k[0] == 1}:
            fail(f"route {route}: the first cycle decided {one.decisions} with other "
                 f"probe solutions than the default route's {arm_c.decisions[:1]}")
    b6 = ("pack_probe_lanes", "pack_probe_lanes_wavefront", "pack_probe_lanes_flat")
    expect = {
        "arm (a)": ((), b6),
        "arm (c)": (("pack_probe_lanes_wavefront", "pack_probe_lanes_flat"),
                    ("pack_probe_lanes",)),
        "KARPENTER_WAVEFRONT=0": (("pack_probe_lanes", "pack_probe_lanes_flat"),
                                  ("pack_probe_lanes_wavefront", "pack_split_wavefront")),
        "KARPENTER_PROBE_BATCH_WIDTH=1": (("pack_split_flat",), b6),
    }
    for route, (used, unused) in expect.items():
        n = launches[route]
        if (any(n[k] < 1 for k in used) or any(n[k] for k in unused)
                or (route == "arm (a)" and n["pack_split_flat"] < 1)):
            fail(f"route {route} launched {n}: expected {used} and none of {unused}")
    say(f"phase 8 consolidation_500: fleet {len(nodes0)} nodes "
        f"${sum(prices0):.6f}/h, {sum(len(p) for p in pods_on0)} pods after the "
        f"scale-down ({fleet_s:.3f}s to build) -> arm (a) {arm_a.nodes} nodes "
        f"${arm_a.price:.6f}/h in {arm_a.cycles} cycles, arm (c) {arm_c.nodes} nodes "
        f"${arm_c.price:.6f}/h in {arm_c.cycles} cycles; decisions identical "
        f"{arm_c.decisions}")
    say(f"  arm (a) {sum(arm_a.walls):.6f}s, per cycle "
        f"{', '.join(f'{w:.6f}' for w in arm_a.walls)}; {len(arm_a.probes)} probe solves, "
        f"{len(a_each)} packing calls of {min(a_each):.4f}..{max(a_each):.4f} ms "
        f"(median {statistics.median(a_each):.4f} ms) on the card")
    say(cycle_report("arm (a)", arm_a, a_ms, a_calls))
    say(f"  arm (c) {sum(arm_c.walls):.6f}s, per cycle "
        f"{', '.join(f'{w:.6f}' for w in arm_c.walls)}; {arm_c.lanes} lanes shipped, "
        f"{len(arm_c.probes)} consulted; dispatches {json.dumps(stats['arm (c)'])}")
    say(cycle_report("arm (c)", arm_c, c_ms, c_calls))
    say(f"  launches per route: {json.dumps(launches)}; first cycle equal on every route")

    # ---- holds: seeded lane cases, then the first cycle's first chunk
    t0 = time.perf_counter()
    for case in lane_cases(0):
        cargs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in case.args]
        ckw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in case.kwargs.items()}
        for mode in ("ffd", "cost"):
            say(hold_lanes(kernels, case.name, cargs, ckw, case.max_free, mode, err))
    say(f"  seeded lane cases byte-identical ({time.perf_counter() - t0:.3f}s)")
    first = [c for c in rec["calls"] if c[0] == 2]
    if not first:
        fail("arm (c)'s first cycle dispatched no lane chunk")
    _, args, kwargs = first[0]
    kw = {k: kwargs.get(k) for k in ("cfg_rsv", "rsv_cap", "conflict")}
    F, mode, W = kwargs["max_free"], kwargs["mode"], kwargs["wavefront"]
    if W <= 1:
        fail(f"the first chunk took the sequential route (wavefront {W})")
    Lp = args[2].shape[0]
    n_real = int((args[10].any(dim=1) | (args[2] > 0).any(dim=1)).sum())
    t0 = time.perf_counter()
    seq_plain_ms, seq_ref = timed_once(lambda: kernels.pack_probe_lanes_ref(
        *args, max_free=F, mode=mode, **kw))
    wf_plain_ms, wf_ref = timed_once(lambda: kernels.pack_probe_lanes_wavefront_ref(
        *args, max_free=F, mode=mode, width=W, **kw))
    say(hold_lanes(kernels, "first cycle's first chunk", args, kw, F, mode, err,
                   widths=(W,), plain={"seq": seq_ref, W: wf_ref}))
    flat_wf = kernels.pack_probe_lanes_flat(*args, max_free=F, mode=mode, wavefront=W, **kw)
    flat_seq = kernels.pack_probe_lanes_flat(*args, max_free=F, mode=mode, **kw)
    for lane in range(Lp):
        alone = list(args)
        alone[2], alone[10] = args[2][lane].contiguous(), args[10][lane].contiguous()
        for width, flat in ((W, flat_wf), (0, flat_seq)):
            row = kernels.pack_split_flat(*alone, max_free=F, mode=mode, wavefront=width, **kw)
            if not torch.equal(row, flat[lane]):
                fail(f"lane {lane} of the first chunk differs from its solve alone "
                     f"(wavefront {width})")
    torch.cuda.synchronize()
    say(f"  first chunk ({n_real} lanes padded to {Lp}): B6 and the lane epilogue "
        f"byte-identical to the plain versions, every lane row equal to B1/B3 + B2 "
        f"alone ({time.perf_counter() - t0:.3f}s)")

    # ---- the pruner on the first cycle's staging
    first_cycle = arm_c.first
    solver, verdicts = first_cycle["solver"], first_cycle["verdicts"]
    cands = first_cycle["candidates"]
    fnodes, fprices, fpods = (first_cycle[k] for k in ("nodes", "prices", "pods_on"))
    lp_device.reset()
    b5_before = lp_device.LAUNCHES["lp_ascend"]
    cert_inputs = []
    real_ascend = lp_device.ascend

    def recording_ascend(a, n_iters):
        cert_inputs.append((a, n_iters))
        return real_ascend(a, n_iters)

    lp_device.ascend = recording_ascend
    try:
        t0 = time.perf_counter()
        cert = solver.dual_certificate()
        torch.cuda.synchronize()
        cert_s = time.perf_counter() - t0
    finally:
        lp_device.ascend = real_ascend
    b5_launches = lp_device.LAUNCHES["lp_ascend"] - b5_before
    if cert is None or b5_launches != 1 or len(cert_inputs) != 1:
        fail("dual_certificate did not launch B5 once and certify")
    pruner = cb.ProbePruner(solver)
    pruned, floors, feasible = [], [], 0
    for n in range(1, len(cands) + 1):
        cs = [Candidate(NodeRef(fnodes[i].name), fprices[i], fpods[i]) for i in cands[:n]]
        is_pruned = pruner.cannot_pay(cs)
        demand = np.zeros(solver.last_enc.compat.shape[0], np.int64)
        for c in cs:
            for p in c.reschedulable_pods:
                demand[solver.last_gi_by_key[p.key]] += 1
        floor = cert.floor(demand, cands[:n])
        floors.append(floor)
        sol = verdicts[n - 1]()
        if sol.unschedulable:
            continue
        feasible += 1
        added = sum(x.price for x in sol.new_nodes)
        if added < floor - 1e-9 - 1e-9 * abs(floor):
            fail(f"prefix {n}: a repack costing ${added:.9f}/h beats the dual floor "
                 f"${floor:.9f}/h")
        if is_pruned:
            pruned.append(n)
            if added < sum(fprices[i] for i in cands[:n]):
                fail(f"pruned prefix {n} has a strictly cheaper solution")
    say(f"  pruner: dual_certificate {cert_s:.6f}s (B5 once), {len(cands)} prefixes, "
        f"{feasible} feasible, none below its floor; pruned {len(pruned)} {pruned[:10]}; "
        f"floors ${min(floors):.6f}..${max(floors):.6f}/h, absorb total "
        f"${cert.absorb_total:.6f}/h, margin {lp_device.prune_margin()}")
    a_cert, n_cert = cert_inputs[0]
    ascent_timing(kernels, lp_device, "the certificate's LP", a_cert, n_cert, err, smi)

    # ---- the card against the CPU on a mid-size fleet
    t0 = time.perf_counter()
    mid_card = consolidation_fleet(*MID_FLEET)
    mid_cpu = consolidation_fleet(*MID_FLEET, device="cpu")
    if (mid_card[2] != mid_cpu[2]
            or [n.name for n in mid_card[1]] != [n.name for n in mid_cpu[1]]
            or [[p.key for p in ps] for ps in mid_card[3]]
            != [[p.key for p in ps] for ps in mid_cpu[3]]):
        fail(f"consolidation_fleet{MID_FLEET}: the card's fleet differs from the CPU's")
    card = consolidation_ladder(*mid_card, batched=True, device="cuda")
    os.environ["KARPENTER_PROBE_BATCH_WIDTH"] = str(CPU_PROBE_WIDTH)
    try:
        cpu = consolidation_ladder(*mid_cpu, batched=True, device="cpu")
    finally:
        os.environ.pop("KARPENTER_PROBE_BATCH_WIDTH", None)
    if card.decisions != cpu.decisions or card.probes != cpu.probes:
        fail(f"consolidation_fleet{MID_FLEET}: the card decided {card.decisions}, the CPU "
             f"{cpu.decisions}, or their lane solutions differ")
    say(f"  mid-size fleet {MID_FLEET}: {len(mid_card[1])} nodes, the card (width "
        f"{probe_batch_width('cuda')}) and the CPU (width {CPU_PROBE_WIDTH}) decide "
        f"{card.decisions} with {len(card.probes)} equal lane solutions "
        f"({time.perf_counter() - t0:.3f}s)")

    # ---- timing on the first chunk: B6 wavefront and sequential in
    # turns, then the lane epilogue
    def run_wf():
        return kernels.pack_probe_lanes_wavefront(*args, max_free=F, mode=mode, width=W, **kw)

    def run_seq():
        return kernels.pack_probe_lanes(*args, max_free=F, mode=mode, **kw)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_wf = run_wf()
    torch.cuda.synchronize()
    wf_mem = torch.cuda.max_memory_allocated() - base
    out_seq = run_seq()
    wf_runs, seq_runs = [event_ms(run_wf, 5)], []
    seq_runs += [event_ms(run_seq, 5), event_ms(run_seq, 5)]
    wf_runs.append(event_ms(run_wf, 5))
    wf_ms, seq_ms = statistics.mean(wf_runs), statistics.mean(seq_runs)
    flat_in = (*out_wf[:4], out_wf[5], out_wf[4])
    flat_ms = event_ms(lambda: kernels.pack_flat_lanes(*flat_in), 20)
    flat_host_ms = event_ms(lambda: kernels.pack_flat_lanes(*flat_in), 20, queued=False)
    flat_plain_ms = event_ms(lambda: kernels.pack_flat_lanes_ref(*flat_in), 2,
                             queued=False)
    in_bytes = nbytes(list(args) + list(kw.values()))
    ops = 0
    for lane in range(n_real):
        alone = list(args)
        alone[2], alone[10] = args[2][lane], args[10][lane]
        ops += b1_ops(kernels, alone, kw, F)

    def bound(n_ops, nb):
        t_ops, t_bytes = n_ops / PEAK_F32_OPS, nb / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    wf_bound = bound(ops, in_bytes + nbytes(out_wf))
    seq_bound = bound(ops, in_bytes + nbytes(out_seq))
    flat_out = kernels.pack_flat_lanes(*flat_in)
    flat_bound = bound(out_wf[1].numel(), nbytes(flat_in) + nbytes([flat_out]))
    Gp, Cp = args[0].shape
    R, B = args[1].shape[1], args[7].shape[0]
    K = 0 if kw["rsv_cap"] is None else kw["rsv_cap"].shape[0]
    N = B + F
    # what the wavefront program's wrapper allocates, from the shapes:
    # outputs, then the state and plan scratch (the lanes' opened rows'
    # bits and usage are most of it)
    shape_bytes = Lp * (N * Gp * 4 + F * Cp + 4 + Gp * 4 + 4 + Gp * 4) + nbytes(
        kernels.wavefront_scratch((Lp,), W, Gp, Cp, R, B, F, K, "meta"))
    ptxas = [" ".join(line.split(":", 1)[-1].split())
             for name in ("pack_wavefront", "pack_split")
             for line in cuda_build.BUILD_INFO[name]["ptxas"].splitlines()
             if "Used" in line or "Compiling entry" in line or "spill" in line]
    say(f"phase 8 timing on the first chunk ({n_real} lanes, Lp={Lp}, Gp={Gp} Cp={Cp} "
        f"B={B} F={F} R={R}, W={W}): B6 wavefront {', '.join(f'{x:.4f}' for x in wf_runs)} "
        f"ms ({wf_ms / n_real:.6f} ms a lane, most rounds {int(out_wf[4].max())}, "
        f"{kernels.ACTIVE_CLUSTERS.get(W, 0)} clusters of {W} at once, {wf_mem} bytes "
        f"allocated, {shape_bytes} by the shapes); B6 sequential "
        f"{', '.join(f'{x:.4f}' for x in seq_runs)} ms ({seq_ms / n_real:.6f} "
        f"ms a lane); lane epilogue {flat_ms:.6f} ms ({flat_ms / n_real:.6f} ms a lane; "
        f"{flat_host_ms:.6f} ms a call as the host launches it) | "
        f"plain: wavefront {wf_plain_ms:.3f} ms, sequential {seq_plain_ms:.3f} ms, "
        f"epilogue {flat_plain_ms:.3f} ms | ops={ops} input bytes={in_bytes} | card: {smi}")
    say("  ptxas (B6 sequential is B1's kernel over a grid of lanes): " + " | ".join(ptxas))
    say(f"  phase 8 took {time.perf_counter() - t_phase:.3f}s")
    n_b6 = {name: sum(n[name] for n in launches.values()) for name in b6}
    return {"launches": launches, "b5_launches": b5_launches, "entries": [
        {"name": "pack_probe_lanes_wavefront", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_wavefront.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1227",
         "launches": n_b6["pack_probe_lanes_wavefront"],
         "max_abs_err": err["pack_probe_lanes_wavefront"], "ms": wf_ms,
         "plain_ms": wf_plain_ms, "bound_ms": wf_bound[0], "bound_by": wf_bound[1],
         "library_ms": None},
        {"name": "pack_probe_lanes", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_split.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1227",
         "launches": n_b6["pack_probe_lanes"], "max_abs_err": err["pack_probe_lanes"],
         "ms": seq_ms, "plain_ms": seq_plain_ms, "bound_ms": seq_bound[0],
         "bound_by": seq_bound[1], "library_ms": None},
        {"name": "pack_probe_lanes_flat", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_flat.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1292",
         "launches": n_b6["pack_probe_lanes_flat"],
         "max_abs_err": err["pack_probe_lanes_flat"], "ms": flat_ms,
         "plain_ms": flat_plain_ms, "bound_ms": flat_bound[0], "bound_by": flat_bound[1],
         "library_ms": None},
    ]}


SHARDS = (2, 3, 4, 8)
TIMED_SHARDS = (2, 4, 8)
LP_SHARDS = 4
MILLION = (1_000_000, 100, 400)
MILLION_SHARDS = 8


SPLIT_WRAPPERS = ("pack_split_sharded", "pack_split_wavefront_sharded",
                  "pack_flat_words_sharded")
# the outputs of which each shard keeps its own replica (the rest: the
# per-shard masks; split B2 returns one buffer)
SPLIT_REPLICATED = {"pack_split_sharded": (0, 2, 3),
                    "pack_split_wavefront_sharded": (0, 2, 3, 4, 5)}


def flat_tensors(xs) -> list:
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out += flat_tensors(x)
        elif x is not None:
            out.append(x)
    return out


def hold_split(shard, kernels, case, S: int, err: dict) -> str:
    """Split B1, B3 (widths 8 and 16) and B2 on the card against their
    plain split versions on `case` cut into S shards: byte-identical,
    every replica equal, and the flat buffers equal to the unsplit
    kernels' on the same padded problem; or fail."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.testing import split_case

    def put(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in x]
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    sa, skw, fa, fkw = split_case(case, S)
    sa, fa = [put(a) for a in sa], [put(a) for a in fa]
    skw, fkw = {k: put(v) for k, v in skw.items()}, {k: put(v) for k, v in fkw.items()}
    F, mode = case.max_free, case.mode

    def check(name, got, want, replicated):
        torch.cuda.synchronize()
        for i in replicated:
            g = got[i]
            if not all(torch.equal(g[0], g[r]) for r in range(S)):
                fail(f"{name}: replicas differ on {case.name} at S={S} (output {i})")
            if not torch.equal(g, want[i]):
                fail(f"{name} differs from its plain version on {case.name} at S={S} "
                     f"(output {i})")
            err[name] = max(err[name], max_abs_diff(g, want[i]))
        if not all(torch.equal(a, b) for a, b in zip(got[1], want[1])):
            fail(f"{name}: masks differ from its plain version on {case.name} at S={S}")

    got = shard.pack_split_sharded(*sa, max_free=F, mode=mode, **skw)
    want = shard.pack_split_sharded_ref(*sa, max_free=F, mode=mode, **skw)
    check("pack_split_sharded", got, want, SPLIT_REPLICATED["pack_split_sharded"])
    flats = [(shard.pack_flat_words_sharded(*got), shard.pack_flat_words_sharded_ref(*got),
              kernels.pack_flat_words(*kernels.pack_split(*fa, max_free=F, mode=mode, **fkw)))]
    rounds = []
    for width in (8, 16):
        got = shard.pack_split_wavefront_sharded(*sa, max_free=F, mode=mode, width=width, **skw)
        want = shard.pack_split_wavefront_sharded_ref(
            *sa, max_free=F, mode=mode, width=width, **skw)
        check("pack_split_wavefront_sharded", got, want,
              SPLIT_REPLICATED["pack_split_wavefront_sharded"])
        whole = kernels.pack_split_wavefront(*fa, max_free=F, mode=mode, width=width, **fkw)
        stats = (got[5], got[4])
        flats.append((shard.pack_flat_words_sharded(*got[:4], *stats),
                      shard.pack_flat_words_sharded_ref(*got[:4], *stats),
                      kernels.pack_flat_words(*whole[:4], whole[5], whole[4])))
        rounds.append(f"W{width}:{int(got[4][0])}")
    torch.cuda.synchronize()
    for flat, ref, whole in flats:
        if not torch.equal(flat, ref):
            fail(f"pack_flat_words_sharded differs from its plain version on {case.name} "
                 f"at S={S}")
        if not torch.equal(flat, whole):
            fail(f"the split kernels' flat buffer differs from the unsplit kernels' on "
                 f"{case.name} at S={S}")
        err["pack_flat_words_sharded"] = max(err["pack_flat_words_sharded"],
                                             max_abs_diff(flat, ref))
    Cs = sa[0][0].shape[1]
    return (f"  S={S} {case.name} mode={mode} Cs={Cs} Gp={sa[0][0].shape[0]} "
            f"B={fa[7].shape[0]} F={F}: rounds {' '.join(rounds)}, replicas equal, "
            f"identical to the plain split versions and to the unsplit kernels")


class SplitLaunches:
    """Records every call the main path makes of the split packing
    wrappers, with its arguments and outputs, so that each launch is
    held against its plain split version at the shapes the main path
    gave it. The wrappers' own launch counts are untouched."""

    def __init__(self, shard):
        self.shard, self.calls = shard, []
        self.real = {n: getattr(shard, n) for n in SPLIT_WRAPPERS}
        for n in SPLIT_WRAPPERS:
            setattr(shard, n, self._wrap(n))

    def _wrap(self, name):
        real = self.real[name]

        def recorded(*a, **k):
            out = real(*a, **k)
            self.calls.append((name, a, k, out))
            return out
        return recorded

    def close(self) -> None:
        for n, fn in self.real.items():
            setattr(self.shard, n, fn)


def hold_launches(shard, route: str, rec: SplitLaunches, err: dict) -> tuple[dict, dict]:
    """Hold each split launch `rec` recorded on `route` against its plain
    split version on the same inputs: every output byte-identical (the
    per-shard masks whole, unused bits included; the round stats) and
    every replica equal; or fail. Returns the launches held and the
    CUDA-event ms of each wrapper's last plain run, by wrapper."""
    import torch

    held = {n: 0 for n in SPLIT_WRAPPERS}
    plain_ms = {}
    for name, a, k, got in rec.calls:
        where = f"{name} on the {route} route (launch {held[name] + 1})"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = getattr(shard, name + "_ref")(*a, **k)
        end.record()
        torch.cuda.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        if name == "pack_flat_words_sharded":
            if not same_bits(got, want):
                fail(f"{where} differs from its plain version")
            err[name] = max(err[name], max_abs_diff(got, want))
        else:
            S = len(a[0])
            for i in SPLIT_REPLICATED[name]:
                g = got[i]
                if g.shape[0] != S or not all(torch.equal(g[0], g[r]) for r in range(S)):
                    fail(f"{where}: replicas differ (output {i})")
                if not same_bits(g, want[i]):
                    fail(f"{where} differs from its plain version (output {i})")
                err[name] = max(err[name], max_abs_diff(g, want[i]))
            if len(got[1]) != S or not same_outputs(got[1], want[1]):
                fail(f"{where}: masks differ from its plain version")
        held[name] += 1
    return held, plain_ms


def shard_phase(ctx: dict, err: dict, smi: str) -> dict:
    """Phase 10: B8 on the card, on virtual meshes of shard slots."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import graft_entry
    from karpenter_tpu_torch.solver import lp_device, pack, pack_shard as shard
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver import stream
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.solver import fingerprint, reset_caches, solve
    from karpenter_tpu_torch.testing import (
        ascent_cases, kernel_cases, root_node_mips, tie_case)
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh
    from karpenter_tpu_torch.workloads import build_problem, build_scaled_demand

    t_phase = time.perf_counter()
    force_virtual_mesh(max(SHARDS))
    err.update({"pack_split_sharded": 0.0, "pack_split_wavefront_sharded": 0.0,
                "pack_flat_words_sharded": 0.0, "lp_ascend_sharded": 0.0})

    # ---- 1. the split kernels against their plain split versions
    cases = kernel_cases(0, n_pods=800, n_types=30)
    held = 0
    for S in SHARDS:
        for case in [cases[i] for i in (1, 2, 4, 7)] + [
                tie_case(21, S, "cost"), tie_case(22, S, "ffd", quota=True)]:
            say(hold_split(shard, kernels, case, S, err))
            held += 1
    for S in (2, LP_SHARDS):
        for name, inputs in ascent_cases(0, S):
            a = lp_device.ShardedAscentInputs.split(inputs.to("cuda"), S, ["cuda"] * S)
            got = lp_device.ascend_sharded(a, 192)
            want = lp_device.ascend_sharded_ref(a, 192)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                if not all(same_bits(x[0], x[r]) for r in range(S)):
                    fail(f"lp_ascend_sharded: replicas differ on {name} at S={S}")
                if not same_bits(x, y):
                    fail(f"lp_ascend_sharded differs from its plain version on {name} "
                         f"at S={S}")
                err["lp_ascend_sharded"] = max(err["lp_ascend_sharded"], max_abs_diff(x, y))
    say(f"phase 10 sharded: split B1, B3 (widths 8, 16) and B2 byte-identical to their "
        f"plain split versions and to the unsplit kernels on {held // len(SHARDS)} "
        f"problems at each S in {SHARDS}, replicas equal; split B5 on {len(ascent_cases(0))} ascent cases at "
        f"S in (2, {LP_SHARDS}), 192 iterations, bit-identical "
        f"({time.perf_counter() - t_phase:.3f}s)")

    # ---- 2. the 50k x 500 requests, split, on both routes
    launches: dict[str, dict] = {}
    held_at: dict[str, dict] = {}  # split launches held, by route
    plain_at: dict[str, dict] = {}  # their plain versions' ms, by route
    unsplit = ("pack_split", "pack_split_wavefront", "pack_split_flat")

    def hold_route(route, rec):
        """Every split launch of `route` held against its plain version;
        fails unless each launch the counts show was held."""
        held_at[route], plain_at[route] = hold_launches(shard, route, rec, err)
        for k in SPLIT_WRAPPERS:
            if held_at[route][k] != shard.LAUNCHES[k]:
                fail(f"{route}: {shard.LAUNCHES[k]} launches of {k}, "
                     f"{held_at[route][k]} held")

    def drive(route, fn, used):
        kernels.reset_launch_counts()
        shard.reset_launch_counts()
        lp_device.LAUNCHES["lp_ascend_sharded"] = 0
        rec = SplitLaunches(shard)
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rec.close()
        n = {**{k: kernels.LAUNCHES[k] for k in unsplit}, **shard.LAUNCHES,
             "lp_ascend_sharded": lp_device.LAUNCHES["lp_ascend_sharded"]}
        launches[route] = n
        if any(n[k] for k in unsplit):
            fail(f"split route {route} launched an unsplit packing kernel: {n}")
        for k in used:
            if n[k] < 1:
                fail(f"split route {route} did not launch {k}: {n}")
        hold_route(route, rec)
        return out, wall

    def held_line(routes) -> str:
        n = {k: sum(held_at[r][k] for r in routes) for k in SPLIT_WRAPPERS}
        return (f"each split launch held against its plain split version at the path's "
                f"shapes, byte-identical, replicas equal (B1 {n['pack_split_sharded']}, "
                f"B3 {n['pack_split_wavefront_sharded']}, "
                f"B2 {n['pack_flat_words_sharded']} launches)")

    pods, pools, extra, existing = ctx["pods"], ctx["pools"], ctx["extra"], ctx["existing"]
    walls = {}
    os.environ.pop("KARPENTER_WAVEFRONT", None)
    for S in SHARDS:
        sol, walls[f"first-S{S}"] = drive(
            f"first-S{S}", lambda: solve(pods, pools, shards=S),
            ("pack_split_wavefront_sharded", "pack_flat_words_sharded"))
        if fingerprint(sol) != ctx["first_fp"]:
            fail(f"first request at S={S}: fingerprint differs from the unsharded solve's")
        os.environ["KARPENTER_WAVEFRONT"] = "0"
        try:
            sol, walls[f"first-seq-S{S}"] = drive(
                f"first-seq-S{S}", lambda: solve(pods, pools, shards=S),
                ("pack_split_sharded", "pack_flat_words_sharded"))
        finally:
            os.environ.pop("KARPENTER_WAVEFRONT", None)
        if fingerprint(sol) != ctx["first_fp"]:
            fail(f"first request, KARPENTER_WAVEFRONT=0, at S={S}: fingerprint differs")
    sol2, walls["second-S4"] = drive(
        "second-S4", lambda: solve(extra, pools, existing, shards=4),
        ("pack_split_wavefront_sharded", "pack_flat_words_sharded"))
    if fingerprint(sol2) != ctx["second_fp"]:
        fail("second request at S=4: fingerprint differs from the unsharded solve's")
    say(f"  50k x 500: first request at S in {SHARDS} on the B3 and B1 routes, second "
        f"request at S=4: fingerprints equal to the unsharded card solves'; "
        f"{held_line(walls)} | walls (s) "
        + ", ".join(f"{k} {v:.6f}" for k, v in walls.items()))

    # ---- 3. reserved_50k, cost, split packs; then the split ascent
    rpods, rpools = build_problem(COST_PODS, COST_TYPES, seed=SEED, reservations=True,
                                  zonal_frac=COST_ZONAL)
    with root_node_mips():
        reset_caches()
        t0 = time.perf_counter()
        cost_fp = fingerprint(solve(rpods, rpools, objective="cost"))
        cost_wall = time.perf_counter() - t0
        reset_caches()
        sol_c, cost_s_wall = drive(
            "cost-S4", lambda: solve(rpods, rpools, objective="cost", shards=4),
            ("pack_split_wavefront_sharded", "pack_flat_words_sharded"))
    if fingerprint(sol_c) != cost_fp:
        fail("reserved_50k cost at S=4: fingerprint differs from the unsharded cost solve's")
    renc = encode(group_pods(rpods), rpools)
    captured = {}
    real_split = lp_device.ascend_sharded

    def capture(a, n_iters):
        captured["a"], captured["n"] = a, n_iters
        return real_split(a, n_iters)

    os.environ["KARPENTER_LP_SHARDS"] = str(LP_SHARDS)
    lp_device.ascend_sharded = capture
    try:
        lp_device.reset()
        dlp_split, lp_wall = drive("lp-S4", lambda: lp_device.solve(renc, device="cuda"),
                                   ("lp_ascend_sharded",))
    finally:
        lp_device.ascend_sharded = real_split
        os.environ.pop("KARPENTER_LP_SHARDS", None)
        lp_device.reset()
    a4, n_iters = captured["a"], captured["n"]
    got = lp_device.ascend_sharded(a4, n_iters)
    # the plain split version, timed as the host drives it (the timing
    # below reads this run)
    want = []
    lp_plain_ms = event_ms(lambda: want.extend(lp_device.ascend_sharded_ref(a4, n_iters)),
                           1, queued=False)
    for x, y in zip(got, want):
        if not same_bits(x, y):
            fail("lp_ascend_sharded differs from its plain version on reserved_50k's LP")
        err["lp_ascend_sharded"] = max(err["lp_ascend_sharded"], max_abs_diff(x, y))
    a1, n1 = ctx["ascent"]
    one = lp_device.ascend(a1, n1)
    G = a1.compat.shape[0]
    lam_gap = float((got[1][0][:G] - one[1][:G]).abs().max() / one[1][:G].abs().max())
    say(f"  reserved_50k cost at S=4: fingerprint equal to the unsharded cost solve's, "
        f"{held_line(['cost-S4'])} ({cost_s_wall:.3f}s against {cost_wall:.3f}s, both "
        f"cold) | "
        f"KARPENTER_LP_SHARDS=4: split B5 launched {launches['lp-S4']['lp_ascend_sharded']}x "
        f"(Cp={a4.compat[0].shape[1] * LP_SHARDS}, Cs={a4.compat[0].shape[1]}), "
        f"bit-identical to its plain version; against the unsplit B5: best "
        f"{float(got[0][0]):.9g} vs {float(one[0]):.9g}, last improving iteration "
        f"{int(got[2][0])} vs {int(one[2])}, max |d lambda|/max lambda {lam_gap:.3e}; "
        f"certified bound {dlp_split.lower_bound:.6f}")

    # ---- 4. million_pod, S=8, streamed staging
    menc, _ = build_scaled_demand(*MILLION)
    t0 = time.perf_counter()
    base = pack.solve_packing(menc, device="cuda")
    torch.cuda.synchronize()
    base_wall = time.perf_counter() - t0
    stream.reset_stats()
    res, m_wall = drive(
        "million-S8", lambda: pack.solve_packing(menc, device="cuda", shards=MILLION_SHARDS),
        ("pack_split_wavefront_sharded", "pack_flat_words_sharded"))
    st = stream.last_stats()
    if not graft_entry.same_solution(base, res):
        fail("million_pod at S=8: the split solve differs from the unsharded card solve")
    if not st or st["peak_block_bytes"] * MILLION_SHARDS > st["full_bytes"]:
        fail(f"million_pod: the staging did not stream per-shard blocks: {st}")
    say(f"  million_pod: {MILLION[0]} pods, {MILLION[1]} types, {MILLION[2]} signatures "
        f"(G={menc.compat.shape[0]}, C={menc.compat.shape[1]}) at S={MILLION_SHARDS}, "
        f"streamed: {res.node_count} nodes, {int(res.unschedulable.sum())} unschedulable, "
        f"equal to the unsharded card solve, {held_line(['million-S8'])} | solve wall "
        f"{m_wall:.3f}s (unsharded "
        f"{base_wall:.3f}s, cold) | staging {st}: peak block {st['peak_block_bytes']} B "
        f"against {st['full_bytes']} B of full matrices")

    # ---- 5. the port's dryrun_multichip(4)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    shard.reset_launch_counts()
    rec = SplitLaunches(shard)
    try:
        with root_node_mips():
            dry = graft_entry.dryrun_multichip(4)
        torch.cuda.synchronize()
    finally:
        rec.close()
    dry_wall = time.perf_counter() - t0
    launches["dryrun"] = dict(shard.LAUNCHES)
    if launches["dryrun"]["pack_split_wavefront_sharded"] < 2:
        fail(f"dryrun_multichip(4) did not run the split kernels: {launches['dryrun']}")
    hold_route("dryrun", rec)
    say(f"  dryrun_multichip(4): {dry} passed, {held_line(['dryrun'])} ({dry_wall:.3f}s)")

    # ---- 6. timing: each split kernel in turns with its unsplit kernel
    # on the first request's inputs (the same padded problem)
    enc = ctx["enc"]
    mask, used, quota = pack._bound_rows(enc)
    N = pack.node_axis(enc, "ffd")
    W = pack.wavefront_width(torch.device("cuda"))
    times = {}
    bounds = {}
    for S in TIMED_SHARDS:
        st_ = pack.stage(enc, mask, used, N, quota, shards=S)
        sargs, skw = pack.to_mesh(st_, enc, pack._mesh(S, "cuda"), stream=False)
        fargs, fkw = pack.to_device(st_, torch.device("cuda"))
        F = st_.max_free
        runs = {
            "pack_split": lambda: kernels.pack_split(*fargs, max_free=F, mode="ffd", **fkw),
            "pack_split_sharded": lambda: shard.pack_split_sharded(
                *sargs, max_free=F, mode="ffd", **skw),
            "pack_split_wavefront": lambda: kernels.pack_split_wavefront(
                *fargs, max_free=F, mode="ffd", width=W, **fkw),
            "pack_split_wavefront_sharded": lambda: shard.pack_split_wavefront_sharded(
                *sargs, max_free=F, mode="ffd", width=W, **skw),
        }
        outs = {k: fn() for k, fn in runs.items()}
        so = outs["pack_split_wavefront_sharded"]
        fo = outs["pack_split_wavefront"]
        runs["pack_flat_words"] = lambda: kernels.pack_flat_words(*fo[:4], fo[5], fo[4])
        runs["pack_flat_words_sharded"] = lambda: shard.pack_flat_words_sharded(
            *so[:4], so[5], so[4])
        for plain, split in (("pack_split", "pack_split_sharded"),
                             ("pack_split_wavefront", "pack_split_wavefront_sharded"),
                             ("pack_flat_words", "pack_flat_words_sharded")):
            reps = 50 if plain == "pack_flat_words" else 10
            seq = [event_ms(runs[plain], reps), event_ms(runs[split], reps),
                   event_ms(runs[split], reps), event_ms(runs[plain], reps)]
            times[(split, S)] = (seq[1], seq[2], seq[0], seq[3])
        in_bytes = nbytes(flat_tensors(list(sargs) + list(skw.values())))
        ops = b1_ops(kernels, fargs, fkw, F)
        out_b = nbytes([fo[0], fo[1], fo[2], fo[3]])
        bounds[("pack_split_sharded", S)] = bound(ops, in_bytes + out_b)
        bounds[("pack_split_wavefront_sharded", S)] = bound(ops, in_bytes + out_b)
        flat = runs["pack_flat_words_sharded"]()
        bounds[("pack_flat_words_sharded", S)] = bound(
            F * st_.Cp, nbytes([fo[0], fo[2], fo[3], fo[4], fo[5]]) + nbytes(so[1])
            + nbytes([flat]))
    seq = [event_ms(lambda: lp_device.ascend(a1, n1), 3),
           event_ms(lambda: lp_device.ascend_sharded(a4, n_iters), 3),
           event_ms(lambda: lp_device.ascend_sharded(a4, n_iters), 3),
           event_ms(lambda: lp_device.ascend(a1, n1), 3)]
    times[("lp_ascend_sharded", LP_SHARDS)] = (seq[1], seq[2], seq[0], seq[3])
    dense_a4 = lp_device.AscentInputs(**{
        n: (torch.cat(getattr(a4, n), dim=lp_device.ShardedAscentInputs.SPLIT[n])
            if n in lp_device.ShardedAscentInputs.SPLIT else getattr(a4, n))
        for n in lp_device.AscentInputs.NAMES})
    bounds[("lp_ascend_sharded", LP_SHARDS)] = bound(
        ascent_ops(dense_a4, n_iters),
        nbytes(flat_tensors([getattr(a4, n) for n in lp_device.AscentInputs.NAMES]))
        + nbytes([got[1][0], got[0][:1], got[2][:1]]))
    # the plain split versions as the host drives them: the runs that
    # held the first request's launches at S=4 (B1 on the
    # KARPENTER_WAVEFRONT=0 route, B3 and its B2 on the default one) and
    # reserved_50k's split ascent
    plain_ms = {
        "pack_split_sharded": plain_at["first-seq-S4"]["pack_split_sharded"],
        "pack_split_wavefront_sharded": plain_at["first-S4"]["pack_split_wavefront_sharded"],
        "pack_flat_words_sharded": plain_at["first-S4"]["pack_flat_words_sharded"],
        "lp_ascend_sharded": lp_plain_ms}
    for (name, S), (s1, s2, u1, u2) in times.items():
        b, by = bounds[(name, S)]
        say(f"  timing {name} S={S}: split {s1:.4f}, {s2:.4f} ms; unsplit {u1:.4f}, "
            f"{u2:.4f} ms (in turns: unsplit, split, split, unsplit); bound {b:.6f} ms "
            f"({by})")
    total = {k: sum(n.get(k, 0) for n in launches.values())
             for k in ("pack_split_sharded", "pack_split_wavefront_sharded",
                       "pack_flat_words_sharded", "lp_ascend_sharded")}
    say(f"  launches per split route: {json.dumps(launches)}")
    say(f"  phase 10 took {time.perf_counter() - t_phase:.3f}s | card: {smi}")
    force_virtual_mesh(0)
    entries = []
    for name, src, rep, S in (
        ("pack_split_sharded", "pack_split.cu", "karpenter_tpu/solver/pack.py:1817", 4),
        ("pack_split_wavefront_sharded", "pack_wavefront.cu",
         "karpenter_tpu/solver/pack.py:1817", 4),
        ("pack_flat_words_sharded", "pack_flat.cu", "karpenter_tpu/solver/pack.py:1817", 4),
        ("lp_ascend_sharded", "lp_ascend.cu", "karpenter_tpu/solver/lp_device.py:430",
         LP_SHARDS),
    ):
        s1, s2, _, _ = times[(name, S)]
        b, by = bounds[(name, S)]
        entries.append({
            "name": name, "route": "cuda", "source": f"karpenter_tpu_torch/csrc/{src}",
            "replaces": rep, "launches": total[name], "max_abs_err": err[name],
            "ms": (s1 + s2) / 2, "plain_ms": plain_ms[name], "bound_ms": b,
            "bound_by": by, "library_ms": None})
    return {"launches": launches, "entries": entries}


def phase_breakdown(kernels, lib: str, run, ms: float, unit: str) -> str:
    """One run of `run` with library `lib`'s phase-clock build swapped
    in: each phase's share of block 0's cycles, and the time a step or
    round from the CUDA-event time `ms` of the normal build."""
    with kernels.phase_clocks(lib) as take:
        run()
        clk = take()
    n = clk.pop("count")
    spreads = clk.pop("spreads")
    total = sum(clk.values())
    if not n or not total:
        fail(f"{lib}: the phase-clock build counted {n} {unit}s, {total} cycles")
    shares = ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in clk.items())
    # the slowest thread against the mean over the block's threads
    spread = ", ".join(f"{k} {hi / n:.1f} (mean {tot / n / 1024:.1f})"
                       for k, (hi, tot) in spreads.items())
    return (f"{n} {unit}s, {1000 * ms / n:.3f} us a {unit} (CUDA events), "
            f"{total / n:.0f} cycles a {unit} on block 0 | {shares} | a {unit}'s slowest "
            f"thread: {spread}")


def timing_phase(kernels, pack, case, smi: str) -> dict:
    """Phase 5: B1, B3 (in turns) and B2 on the warm first request's
    inputs, their plain versions, bounds, dynamic shared memory and the
    phase-clock breakdowns of B1 and B3."""
    import torch

    args, kw = to_cuda(case)
    B = args[7].shape[0]
    F = case.max_free
    W = pack.wavefront_width(torch.device("cuda"))

    def run_b1():
        return kernels.pack_split(*args, max_free=F, mode="ffd", **kw)

    def run_b3():
        return kernels.pack_split_wavefront(*args, max_free=F, mode="ffd", width=W, **kw)

    out1, out3 = run_b1(), run_b3()
    # B1 and B3 in turns on the same card: B1, B3, B3, B1
    b1_runs, b3_runs = [event_ms(run_b1, 10)], []
    b3_runs += [event_ms(run_b3, 10), event_ms(run_b3, 10)]
    b1_runs.append(event_ms(run_b1, 10))
    b1_ms, b3_ms = statistics.mean(b1_runs), statistics.mean(b3_runs)
    smem = dict(kernels.DYNAMIC_SMEM)
    b1_clocks = phase_breakdown(kernels, "pack_split", run_b1, b1_ms, "step")
    b3_clocks = phase_breakdown(kernels, "pack_wavefront", run_b3, b3_ms, "round")
    b1_plain_ms = event_ms(
        lambda: kernels.pack_split_ref(*args, max_free=F, mode="ffd", **kw), 2,
        queued=False)
    b3_plain_ms = event_ms(
        lambda: kernels.pack_split_wavefront_ref(*args, max_free=F, mode="ffd",
                                                 width=W, **kw), 2, queued=False)
    # B2 as the main path runs it: on B3's outputs, stats appended
    b2_in = (*out3[:4], out3[5], out3[4])
    b2_ms = event_ms(lambda: kernels.pack_flat_words(*b2_in), 50)
    b2_host_ms = event_ms(lambda: kernels.pack_flat_words(*b2_in), 50, queued=False)
    b2_plain_ms = event_ms(lambda: kernels.pack_flat_words_ref(*b2_in), 20,
                           queued=False)

    Gp, Cp = args[0].shape
    R = args[1].shape[1]
    # B3 computes B1's function: the work its inputs need is B1's
    b1_op_count = b1_ops(kernels, args, kw, F)
    in_bytes = nbytes(list(args) + list(kw.values()))
    b1_bytes = in_bytes + nbytes(out1)
    b3_bytes = in_bytes + nbytes(out3)
    flat = kernels.pack_flat_words(*b2_in)
    b2_bytes = nbytes(b2_in) + nbytes([flat])
    b2_op_count = out3[1].numel()

    b1_bound, b1_by = bound(b1_op_count, b1_bytes)
    b3_bound, b3_by = bound(b1_op_count, b3_bytes)
    b2_bound, b2_by = bound(b2_op_count, b2_bytes)
    say(f"phase 5 timing on {case.name} (Gp={Gp} Cp={Cp} B={B} F={F} R={R}, W={W}): "
        f"B1 {', '.join(f'{x:.4f}' for x in b1_runs)} ms; B3 "
        f"{', '.join(f'{x:.4f}' for x in b3_runs)} ms, {int(out3[4])} rounds, widths "
        f"{histogram(out3[5][:int(out3[4])])}; B1/B3 ops={b1_op_count} "
        f"B1 bytes={b1_bytes} B3 bytes={b3_bytes}; B2 {b2_ms:.6f} ms on the card, "
        f"{b2_host_ms:.6f} ms a call as the host launches it, ops={b2_op_count} "
        f"bytes={b2_bytes} | card: {smi}")
    say(f"  dynamic shared memory a block: B1 {smem['pack_split']} B, "
        f"B3 {smem['pack_split_wavefront']} B")
    say(f"  B1 phase clocks: {b1_clocks}")
    say(f"  B3 phase clocks: {b3_clocks}")
    return {"b1_ms": b1_ms, "b1_plain_ms": b1_plain_ms, "b1_bound": b1_bound,
            "b1_by": b1_by, "b3_ms": b3_ms, "b3_plain_ms": b3_plain_ms,
            "b3_bound": b3_bound, "b3_by": b3_by, "b2_ms": b2_ms,
            "b2_plain_ms": b2_plain_ms, "b2_bound": b2_bound, "b2_by": b2_by}


def ascent_clocks(kernels, lp_device, a, n_iters: int, ms: float) -> tuple[str, int]:
    """One run of B5 from its phase-clock build: each phase's share of
    block 0's cycles, the us an iteration from the CUDA-event time `ms`
    of the normal build, and the block barriers of the launch (returned
    with the text)."""
    with kernels.phase_clocks("lp_ascend") as take:
        lp_device.ascend(a, n_iters)
        clk = take()
    n = clk.pop("count")
    barriers = clk.pop("barriers")
    regions = clk.pop("regions")
    total = sum(clk.values())
    if not n or not total:
        fail(f"lp_ascend: the phase-clock build counted {n} iterations, {total} cycles")
    ranked = sorted(clk.items(), key=lambda kv: -kv[1])
    shares = ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in ranked if v)
    inside = ", ".join(f"{k} {v / n:.0f}" for k, v in regions.items())
    return (f"{n} iterations, {1000 * ms / n:.3f} us an iteration (CUDA events), "
            f"{total / n:.0f} cycles an iteration on block 0, {barriers} block barriers "
            f"({barriers / n:.1f} an iteration) | {shares} | regions inside the phases, "
            f"cycles an iteration on the thread that runs each: {inside}"), barriers


def ascent_timing(kernels, lp_device, name: str, a, n_iters: int, err: dict,
                  smi: str) -> dict:
    """B5 on `a`: held bit for bit against its plain version, its
    CUDA-event time (5 calls) beside the plain version's (one call as
    the host drives it), its bound, the shared memory a launch took, its
    phase clocks, and the floor of its chain of barriers (the launch's
    barriers times the cost of one)."""
    say(hold_ascent(lp_device, name, a, n_iters, err))
    out = lp_device.ascend(a, n_iters)
    ms = event_ms(lambda: lp_device.ascend(a, n_iters), 5)
    plain_ms = event_ms(lambda: lp_device.ascend_ref(a, n_iters), 1, queued=False)
    nb = nbytes(a.tensors()) + nbytes(out)
    ops = ascent_ops(a, n_iters)
    b_ms, by = bound(ops, nb)
    smem = getattr(lp_device, "ASCENT_SMEM", {}).get("lp_ascend")
    say(f"  B5 on {name} (Gp={a.compat.shape[0]} Cp={a.compat.shape[1]} "
        f"R={a.req.shape[1]} Kp={a.onehot.shape[0]}, {n_iters} iterations): "
        f"{ms:.6f} ms, plain {plain_ms:.3f} ms, ops={ops} bytes={nb} bound {b_ms:.6f} ms "
        f"({by}); {smem} | card: {smi}")
    text, barriers = ascent_clocks(kernels, lp_device, a, n_iters, ms)
    say(f"  B5 phase clocks on {name}: {text}")
    if hasattr(lp_device, "barrier_probe"):
        t0 = event_ms(lambda: lp_device.barrier_probe(0), 5)
        t1 = event_ms(lambda: lp_device.barrier_probe(BARRIER_PROBE), 5)
        per_us = 1000 * (t1 - t0) / BARRIER_PROBE
        say(f"  B5's chain of barriers on {name}: {barriers} barriers x {per_us:.4f} us "
            f"(one barrier of the block alone) = {barriers * per_us / 1000:.6f} ms floor, "
            f"against {ms:.6f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound": b_ms, "by": by}


def reserved_ascent(lp_device, build_problem, encode, group_pods):
    """reserved_50k's B5 inputs on the card, staged from its encode by
    `lp_device._stage` and `ascent_inputs` (no column generation), and
    the ascent's iterations."""
    pods, pools = build_problem(COST_PODS, COST_TYPES, seed=SEED,
                                reservations=True, zonal_frac=COST_ZONAL)
    st = lp_device._stage(encode(group_pods(pods), pools))
    return lp_device.ascent_inputs(st).to("cuda"), lp_device.iters()


def quick_timing(kernels, pack, solve, build_problem, KernelCase, err: dict,
                 smi: str, kind: str, lp_device, encode, group_pods) -> None:
    """`--quick`: after phases 1-3, stage the warm first request (a cold
    and a warm solve on the card), hold B1, B3 and B2 on it, and run
    phase 5 alone; then B5's times and phase clocks on reserved_50k's
    LP."""
    import torch

    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    real_stage = pack.stage
    staged = []

    def recording_stage(*a, **k):
        staged.append(real_stage(*a, **k))
        return staged[-1]

    pack.stage = recording_stage
    try:
        solve(pods, pools)
        solve(pods, pools)
        torch.cuda.synchronize()
    finally:
        pack.stage = real_stage
    st = staged[-1]
    case = KernelCase("main-path-first-warm", st.args, st.kwargs, st.max_free, "ffd", st)
    say(hold(kernels, case, err))
    timing_phase(kernels, pack, case, smi)
    a, n_iters = reserved_ascent(lp_device, build_problem, encode, group_pods)
    ascent_timing(kernels, lp_device, "reserved_50k's LP", a, n_iters, err, smi)
    say(f"chip_smoke --quick: {time.perf_counter() - T_START:.3f}s wall")
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main() -> None:
    card = one_card()
    import numpy as np
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if torch.cuda.device_count() != 1:
        fail(f"expected one visible card, got {torch.cuda.device_count()}")
    sys.path.insert(0, HERE)
    try:
        from karpenter_tpu_torch import cuda_build, graft_entry
        from karpenter_tpu_torch.solver import pack, pack_dense, pack_split as kernels
        from karpenter_tpu_torch.solver.solver import (
            _build_solution_arrays,
            fingerprint,
            resolve_device,
            solve,
        )
        from karpenter_tpu_torch.solver.encode import encode, group_pods
        from karpenter_tpu_torch.cloudprovider.fake import heterogeneous_instance_types
        from karpenter_tpu_torch.solver import consolidation_batch, lp_device, lp_plan
        from karpenter_tpu_torch.solver import solver as solver_mod
        from karpenter_tpu_torch.testing import (
            ASCENT_EDGE_CASES,
            PRICE_CASES,
            KernelCase,
            ascent_cases,
            ascent_edge_cases,
            config_axis,
            dense_cases,
            existing_from_solution,
            kernel_cases,
            price_cases,
        )
        from karpenter_tpu_torch.workloads import build_problem
    except ImportError as err:
        fail(f"karpenter_tpu_torch is not importable beside this script: {err}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi(card)
    say(f"phase 1 device: {kind} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | nvidia-smi: {smi}")

    # ---- 2. build
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.library(name)
    say(f"phase 2 build: {time.perf_counter() - t0:.3f}s wall")
    for name, rec in info.items():
        usage = [
            " ".join(line.split(":", 1)[-1].split())
            for line in rec["ptxas"].splitlines()
            if "Used" in line or "Compiling entry" in line or "spill" in line
        ]
        if not usage:
            fail(f"{name}: no ptxas report (registers, shared memory) from its build")
        say(f"  {name}: nvcc {rec['seconds']:.3f}s cached={rec['cached']} | "
            + " | ".join(usage))

    # ---- 3. kernels against their plain versions on the card
    t0 = time.perf_counter()
    err = {"pack_split": 0.0, "pack_split_wavefront": 0.0, "pack_split_flat": 0.0}
    cases = kernel_cases(0)
    for case in cases + [config_axis(cases[i], C) for i, C in ((4, ODD_CONFIG_AXES[0]),
                                                                 (2, ODD_CONFIG_AXES[1]))]:
        say(hold(kernels, case, err, widths=WIDTHS))
    err.update({"pack": 0.0, "pack_flat": 0.0})
    dcases = dense_cases(0, kernel=cases)
    for case in dcases:
        say(hold_dense(pack_dense, kernels, case, err))
    err.update({"lp_price": 0.0, "lp_ascend": 0.0})
    for name, case in price_cases(0):
        say(hold_price(lp_plan, name, [torch.from_numpy(x).cuda() for x in case], err))
    for name, inputs in ascent_cases(0):
        for n_iters in ASCENT_ITERS:
            say(hold_ascent(lp_device, f"{name}-{n_iters}", inputs.to("cuda"),
                            n_iters, err))
    for name, inputs in ascent_edge_cases(0):
        iters = EDGE_ITERS.get(name, ASCENT_ITERS)
        for n_iters in iters:
            before = dict(lp_device.LAUNCHES)
            say(hold_ascent(lp_device, f"{name}-{n_iters}", inputs.to("cuda"), n_iters, err)
                + f"; {lp_device.ASCENT_SMEM['lp_ascend']}")
            global_path = lp_device.LAUNCHES["lp_ascend_global"] - before["lp_ascend_global"]
            if global_path != (1 if name == GLOBAL_CASE else 0):
                fail(f"lp_ascend took the global-memory path {global_path}x on {name}")
    say(f"phase 3 kernels: {len(cases)} seeded packing problems and 2 at config axes "
        f"{ODD_CONFIG_AXES} byte-identical to the plain versions, B3 at widths "
        f"{WIDTHS} equal to B1; B7 and pack_flat "
        f"on {len(dcases)} dense ones byte-identical, B7 equal to B1; B4 on "
        f"{len(PRICE_CASES)} and B5 on {3 * len(ASCENT_ITERS)} seeded cases and "
        f"{len(ASCENT_EDGE_CASES)} edge cases (one on the global-memory path) "
        f"bit-identical ({time.perf_counter() - t0:.3f}s)")

    if QUICK in sys.argv[1:]:
        quick_timing(kernels, pack, solve, build_problem, KernelCase, err, smi, kind,
                     lp_device, encode, group_pods)
        return

    # ---- 4. main path, route by route; the kernel inputs of each
    # distinct shape the routes stage are kept, to hold the kernels
    # against the plain versions, and each solve's PackResult is kept
    # for its rounds
    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    extra, _ = build_problem(N_EXTRA, N_TYPES, seed=SEED + 1, name_prefix="extra-")
    groups = group_pods(pods)
    small = [p for g in groups[:SMALL_GROUPS] for p in g.pods]
    staged_cases: dict[tuple, KernelCase] = {}
    label = ""
    timed: KernelCase | None = None  # the warm first request's inputs
    last_staged: dict = {}  # each route's last staged problem, for phase 9
    results: dict[str, list] = {}
    real_stage, real_solve_packing = pack.stage, pack.solve_packing

    def recording_stage(*a, **k):
        nonlocal timed
        st = real_stage(*a, **k)
        key = tuple(
            None if x is None else x.shape for x in (*st.args, *st.kwargs.values())
        ) + (st.max_free,)
        case = staged_cases.setdefault(
            key, KernelCase(f"main-path-{label}", st.args, st.kwargs, st.max_free, "ffd", st))
        if label == "first-warm":
            timed = case
        last_staged[label] = st
        return st

    def recording_solve_packing(enc, *a, **k):
        res = real_solve_packing(enc, *a, **k)
        results.setdefault(label, []).append((enc.compat.shape[0], res))
        return res

    launches: dict[str, dict] = {}

    def drive(route: str, fn):
        """Run one route with the launch counts set to 0 just before it
        and read just after."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
        return out

    def timed_solves(name: str, *args):
        nonlocal label
        label = name
        walls, sols = [], []
        for _ in range(WARM_SOLVES):
            t0 = time.perf_counter()
            sols.append(solve(*args))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return sols, walls

    os.environ.pop("KARPENTER_WAVEFRONT", None)
    os.environ.pop("KARPENTER_WAVEFRONT_WIDTH", None)
    pack.stage, pack.solve_packing = recording_stage, recording_solve_packing
    try:
        def first():
            nonlocal label
            label = "first-cold"
            t0 = time.perf_counter()
            sol = solve(pods, pools)
            torch.cuda.synchronize()
            return sol, time.perf_counter() - t0, timed_solves("first-warm", pods, pools)

        sol, cold_s, (warm_sols, warm) = drive("first", first)
        existing = existing_from_solution(sol)

        def second():
            nonlocal label
            label = "second"
            t0 = time.perf_counter()
            out = solve(extra, pools, existing)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        sol2, second_s = drive("second", second)
        os.environ["KARPENTER_WAVEFRONT"] = "0"
        try:
            seq_sols, seq_warm = drive(
                "sequential", lambda: timed_solves("sequential", pods, pools))
        finally:
            os.environ.pop("KARPENTER_WAVEFRONT", None)

        def small_route():
            nonlocal label
            label = "small"
            return solve(small, pools)

        sol_small = drive("small", small_route)
    finally:
        pack.stage, pack.solve_packing = real_stage, real_solve_packing
    groups2 = results["second"][-1][0]
    expect = {
        "first": ("pack_split_wavefront", "pack_split"),
        "second": (("pack_split_wavefront", "pack_split") if groups2 >= 8
                   else ("pack_split", "pack_split_wavefront")),
        "sequential": ("pack_split", "pack_split_wavefront"),
        "small": ("pack_split", "pack_split_wavefront"),
    }
    for route, (used, unused) in expect.items():
        n = launches[route]
        if n[used] < 1 or n["pack_split_flat"] < 1 or n[unused] != 0:
            fail(f"route {route} launched {n}: expected {used} and "
                 f"pack_split_flat, and no {unused}")
    for name in ("pack_split", "pack_split_wavefront", "pack_split_flat"):
        if sum(n[name] for n in launches.values()) < 1:
            fail(f"the main path never launched {name}: {launches}")
    first_fp = fingerprint(sol)
    if any(fingerprint(s) != first_fp for s in warm_sols + seq_sols):
        fail("warm solves of the first request differ between solves or routes")
    for name, s, n in (("first", sol, N_PODS), ("second", sol2, N_EXTRA),
                       ("small", sol_small, len(small))):
        placed = sum(len(p.pods) for p in s.new_nodes) + sum(len(e.pods) for e in s.existing)
        if placed + len(s.unschedulable) != n:
            fail(f"{name} request: {placed} placed + {len(s.unschedulable)} "
                 f"unschedulable != {n} pods")
    if fingerprint(solve(pods, pools, device="cpu")) != first_fp:
        fail("first request: GPU fingerprint differs from the CPU path's")
    if fingerprint(solve(extra, pools, existing, device="cpu")) != fingerprint(sol2):
        fail("second request: GPU fingerprint differs from the CPU path's")
    if fingerprint(solve(small, pools, device="cpu")) != fingerprint(sol_small):
        fail("small request: GPU fingerprint differs from the CPU path's")
    if timed is None or not any(c.args[7].shape[0] for c in staged_cases.values()):
        fail("the main path staged no warm first-request or bound-row kernel inputs")
    rounds = {}
    for route in ("first-warm", "second", "sequential", "small"):
        G, res = results[route][-1]
        rounds[route] = (G, res.device_steps, res.wavefront_widths)
    if rounds["first-warm"][2] is None or rounds["sequential"][2] is not None:
        fail(f"routes did not report their rounds as expected: {rounds}")
    # where a warm solve's wall goes, phase by phase (median of 3);
    # "pack" is staging, upload, the kernels, download and unpacking
    phases = {"group_pods": [], "encode": [], "pack": [], "decode": []}
    for _ in range(3):
        t0 = time.perf_counter()
        groups = group_pods(pods)
        t1 = time.perf_counter()
        enc = encode(groups, pools)
        t2 = time.perf_counter()
        res = pack.solve_packing(enc, device=resolve_device())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _build_solution_arrays(
            enc, np.flatnonzero(res.node_active[: res.node_count]),
            res.node_mask, res.assign, res.unschedulable,
        )
        t4 = time.perf_counter()
        for key, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            phases[key].append(dt)
    breakdown = {k: statistics.median(v) for k, v in phases.items()}
    bound_pods = sum(len(e.pods) for e in sol2.existing)
    say(f"phase 4 main path: {N_PODS} pods x {N_TYPES} types -> "
        f"{len(sol.new_nodes)} nodes, {len(sol.unschedulable)} unschedulable, "
        f"${sol.total_price:.6f}/h | cold {cold_s:.6f}s | warm median, wavefront "
        f"route {statistics.median(warm):.6f}s ({', '.join(f'{w:.6f}' for w in warm)}); "
        f"KARPENTER_WAVEFRONT=0 {statistics.median(seq_warm):.6f}s "
        f"({', '.join(f'{w:.6f}' for w in seq_warm)})")
    for route, (G, steps, widths) in rounds.items():
        hist = "sequential" if widths is None else f"widths {histogram(widths)}"
        say(f"  {route}: G={G} groups, {steps} device steps, {hist}")
    say(f"  second request: {N_EXTRA} pods against {len(existing)} existing nodes "
        f"-> {bound_pods} on existing, {len(sol2.new_nodes)} new nodes, "
        f"{len(sol2.unschedulable)} unschedulable, {second_s:.6f}s | small request: "
        f"{len(small)} pods in {SMALL_GROUPS} groups -> {len(sol_small.new_nodes)} nodes")
    say(f"  launches per route: {json.dumps(launches)} | fingerprints equal to the "
        f"CPU path's and across routes")
    say("  warm solve breakdown (median of 3, s): "
        + ", ".join(f"{k} {v:.6f}" for k, v in breakdown.items()))
    t0 = time.perf_counter()
    for case in staged_cases.values():
        say(hold(kernels, case, err))
    say(f"  main path's kernel inputs: {len(staged_cases)} distinct shapes "
        f"byte-identical to the plain versions ({time.perf_counter() - t0:.3f}s)")

    # ---- 5. timing on the warm first request's inputs
    timing = timing_phase(kernels, pack, timed, smi)
    # ---- 6. the cost objective on reserved_50k
    t0 = time.perf_counter()
    recorded = cost_phase(kernels, lp_plan, lp_device, pack, solver_mod, build_problem,
                          heterogeneous_instance_types, err, launches)
    say(f"  phase 6 took {time.perf_counter() - t0:.3f}s")

    # ---- 7. B4 and B5 timing on the cost path's recorded inputs
    xs = recorded["price_inputs"]
    q, _ = lp_plan.price_kernel(*xs)
    b4_ms = event_ms(lambda: lp_plan.price_kernel(*xs), 20)
    b4_plain_ms = event_ms(lambda: lp_plan.price_kernel_ref(*xs), 2, queued=False)
    b4_bytes = nbytes(xs) + nbytes(lp_plan.price_kernel(*xs))
    b4_ops = price_ops(q, xs[2].shape[1])
    b4_bound, b4_by = bound(b4_ops, b4_bytes)
    say(f"phase 7 LP timing: B4 on the first column-generation round's inputs "
        f"(Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} R={xs[2].shape[1]}): {b4_ms:.6f} ms, "
        f"plain {b4_plain_ms:.3f} ms, ops={b4_ops} bytes={b4_bytes} | card: {smi}")
    a, n_iters = recorded["ascent"]
    b5 = ascent_timing(kernels, lp_device, "reserved_50k's LP", a, n_iters, err, smi)

    # ---- 8. the consolidation probe path
    probes = probe_phase(kernels, consolidation_batch, lp_device, cuda_build, err, smi)

    # ---- 9. the dense kernel B7: the entry problem, and the dense ≡
    # split oracle at full width on what phases 4 and 6 staged
    dense = dense_phase(pack_dense, kernels, graft_entry, {
        "first request": (last_staged["first-warm"], "ffd"),
        "second request": (last_staged["second"], "ffd"),
        "reserved_50k cost arm": (recorded["staged"], "cost"),
    }, err, smi)
    route_launches = {
        name: sum(n[name] for n in (*launches.values(), *probes["launches"].values()))
        for name in ("pack_split", "pack_split_wavefront", "pack_split_flat")
    }

    # ---- 10. B8: the config axis split over shards, on virtual meshes
    sharded = shard_phase({
        "pods": pods, "pools": pools, "extra": extra, "existing": existing,
        "first_fp": first_fp, "second_fp": fingerprint(sol2), "enc": enc,
        "ascent": recorded["ascent"],
    }, err, smi)
    report = {"kernels": [
        {"name": "pack_split", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_split.cu",
         "replaces": "karpenter_tpu/solver/pack.py:444",
         "launches": route_launches["pack_split"], "max_abs_err": err["pack_split"],
         "ms": timing["b1_ms"], "plain_ms": timing["b1_plain_ms"], "bound_ms": timing["b1_bound"],
         "bound_by": timing["b1_by"], "library_ms": None},
        {"name": "pack_split_wavefront", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_wavefront.cu",
         "replaces": "karpenter_tpu/solver/pack.py:786",
         "launches": route_launches["pack_split_wavefront"],
         "max_abs_err": err["pack_split_wavefront"],
         "ms": timing["b3_ms"], "plain_ms": timing["b3_plain_ms"], "bound_ms": timing["b3_bound"],
         "bound_by": timing["b3_by"], "library_ms": None},
        {"name": "pack_split_flat", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_flat.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1374",
         "launches": route_launches["pack_split_flat"], "max_abs_err": err["pack_split_flat"],
         "ms": timing["b2_ms"], "plain_ms": timing["b2_plain_ms"], "bound_ms": timing["b2_bound"],
         "bound_by": timing["b2_by"], "library_ms": None},
        {"name": "lp_price", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/lp_price.cu",
         "replaces": "karpenter_tpu/solver/lp_plan.py:150",
         "launches": launches["cost"]["lp_price"], "max_abs_err": err["lp_price"],
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound,
         "bound_by": b4_by, "library_ms": None},
        {"name": "lp_ascend", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/lp_ascend.cu",
         "replaces": "karpenter_tpu/solver/lp_device.py:202",
         "launches": launches["cost"]["lp_ascend"] + probes["b5_launches"],
         "max_abs_err": err["lp_ascend"], "ms": b5["ms"], "plain_ms": b5["plain_ms"],
         "bound_ms": b5["bound"], "bound_by": b5["by"], "library_ms": None},
        *probes["entries"],
        *dense["entries"],
        *sharded["entries"],
    ]}
    say(f"chip_smoke: {time.perf_counter() - T_START:.3f}s wall")
    say(json.dumps(report))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
