#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile the CUDA kernels from karpenter_tpu_torch/csrc
                (one nvcc per source, in parallel); print build seconds
                and what ptxas reports (registers, shared memory).
  3. kernels  — hold each kernel against its plain PyTorch version on
                the card, on seeded problems (B4 and B5 on their own
                seeded cases; the packing kernels in both modes, reservations,
                bound rows with quotas, group caps, conflicts, negative
                and huge demand, a capped node axis): outputs must be
                byte-identical, B3's at widths 1, 8 and 16, and B3's
                equal to B1's on the same problem.
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
                version's, and its bound.
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
                inputs, their plain versions', and their bounds.
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
                cycle's staging (B5 once), `ProbePruner.cannot_pay` on
                every prefix; no feasible lane costs less than the
                floor, and no pruned prefix has a strictly cheaper
                solution. A mid-size fleet (3000 x 60) runs arm (c) on
                the card and on the CPU (the plain versions, width 8):
                equal decisions and per-lane solutions. Then B6's and
                the epilogue's CUDA-event times on the recorded chunk,
                per dispatch and per lane, their plain versions', their
                bounds, the clusters the card holds at once and the
                memory the wavefront program took.
Kernel times are CUDA-event times taken with a spin kernel holding the
stream while the host launches the timed calls, so they time the
card's work alone; B2 and the lane epilogue are also timed as the host
launches them. Plain versions are timed as the host drives them.
One JSON line {"kernels": [...]} reports every kernel.
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

N_PODS, N_TYPES, SEED = 50_000, 500, 42
N_EXTRA = 10_000
WARM_SOLVES = 5
# groups of the request that takes the sequential route by its size
# (the wavefront route needs WAVEFRONT_MIN_GROUPS = 8)
SMALL_GROUPS = 5
WIDTHS = (1, 8, 16)
OUTPUTS = ("assign", "free_mask", "node_count", "unsched", "steps", "widths")
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
# the consolidation phase: bench.py's consolidation_500 (its defaults
# in workloads.consolidation_fleet), a mid-size fleet for the
# card-against-CPU check, the cluster widths held on seeded lane cases
# and the lane width the CPU run forces
MID_FLEET = (3000, 60)
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
    """Run B1, B3 at each of `widths`, and B2 on both routes, and their
    plain versions, on the card on `case`; fail unless every output is
    byte-identical and B3's outputs equal B1's. Returns a summary."""
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
    for outs, stats in flats:
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
           "base_price": None}

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

    def solve_packing(enc, mode, device, plan=None):
        arm = "ffd" if plan is None else (
            "cost" if enc.cfg_price is rec["base_price"] else "rank")
        rec["mode"] = mode
        return timed(f"pack {arm}", real["_solve_packing"])(enc, mode, device, plan)

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
            "ascent": rec["ascents"][0]}


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
    t0 = time.perf_counter()
    cert = solver.dual_certificate()
    torch.cuda.synchronize()
    cert_s = time.perf_counter() - t0
    if cert is None or lp_device.LAUNCHES["lp_ascend"] != b5_before + 1:
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
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
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
    # outputs, the state, the plan scratch (o_mask, W x F x Cp bytes a
    # lane, is most of it)
    shape_bytes = Lp * (
        N * Gp * 4 + F * Cp + 4 + Gp * 4 + 4 + Gp * 4
        + F * R * 4 + B * R * 4 + (K + 1) * 4 + Gp
        + W * (2 * N * 4 + Cp + Cp * 4 + (K + 1) * 4 + F * Cp + F * R * 4 + F * 4
               + Cp + kernels.WAVEFRONT_LANE_FIELDS * 4 + W))
    ptxas = [" ".join(line.split(":", 1)[1].split())
             for name in ("pack_wavefront", "pack_split")
             for line in cuda_build.BUILD_INFO[name]["ptxas"].splitlines()
             if "Used" in line or "Compiling entry" in line]
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
    return {"launches": launches, "entries": [
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
        from karpenter_tpu_torch import cuda_build
        from karpenter_tpu_torch.solver import pack, pack_split as kernels
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
            PRICE_CASES,
            KernelCase,
            ascent_cases,
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
            " ".join(line.split(":", 1)[1].split())
            for line in rec["ptxas"].splitlines()
            if "Used" in line or "Compiling entry" in line
        ]
        if not usage:
            fail(f"{name}: no ptxas report (registers, shared memory) from its build")
        say(f"  {name}: nvcc {rec['seconds']:.3f}s cached={rec['cached']} | "
            + " | ".join(usage))

    # ---- 3. kernels against their plain versions on the card
    t0 = time.perf_counter()
    err = {"pack_split": 0.0, "pack_split_wavefront": 0.0, "pack_split_flat": 0.0}
    cases = kernel_cases(0)
    for case in cases:
        say(hold(kernels, case, err, widths=WIDTHS))
    err.update({"lp_price": 0.0, "lp_ascend": 0.0})
    for name, case in price_cases(0):
        say(hold_price(lp_plan, name, [torch.from_numpy(x).cuda() for x in case], err))
    for name, inputs in ascent_cases(0):
        for n_iters in ASCENT_ITERS:
            say(hold_ascent(lp_device, f"{name}-{n_iters}", inputs.to("cuda"),
                            n_iters, err))
    say(f"phase 3 kernels: {len(cases)} seeded packing problems byte-identical to "
        f"the plain versions, B3 at widths {WIDTHS} equal to B1; B4 on "
        f"{len(PRICE_CASES)} and B5 on {3 * len(ASCENT_ITERS)} seeded cases "
        f"bit-identical ({time.perf_counter() - t0:.3f}s)")

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
    results: dict[str, list] = {}
    real_stage, real_solve_packing = pack.stage, pack.solve_packing

    def recording_stage(*a, **k):
        nonlocal timed
        st = real_stage(*a, **k)
        key = tuple(
            None if x is None else x.shape for x in (*st.args, *st.kwargs.values())
        ) + (st.max_free,)
        case = staged_cases.setdefault(
            key, KernelCase(f"main-path-{label}", st.args, st.kwargs, st.max_free, "ffd"))
        if label == "first-warm":
            timed = case
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
    case = timed
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
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    in_bytes = nbytes(list(args) + list(kw.values()))
    b1_bytes = in_bytes + nbytes(out1)
    b3_bytes = in_bytes + nbytes(out3)
    flat = kernels.pack_flat_words(*b2_in)
    b2_bytes = nbytes(b2_in) + nbytes([flat])
    b2_op_count = out3[1].numel()

    def bound(ops, nb):
        t_ops, t_bytes = ops / PEAK_F32_OPS, nb / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

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
    a, n_iters = recorded["ascent"]
    b5_out = lp_device.ascend(a, n_iters)
    b5_ms = event_ms(lambda: lp_device.ascend(a, n_iters), 5)
    b5_plain_ms = event_ms(lambda: lp_device.ascend_ref(a, n_iters), 1, queued=False)
    b5_bytes = nbytes(a.tensors()) + nbytes(b5_out)
    b5_ops = ascent_ops(a, n_iters)
    b5_bound, b5_by = bound(b5_ops, b5_bytes)
    say(f"phase 7 LP timing: B4 on the first column-generation round's inputs "
        f"(Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} R={xs[2].shape[1]}): {b4_ms:.6f} ms, "
        f"plain {b4_plain_ms:.3f} ms, ops={b4_ops} bytes={b4_bytes}; B5 at {n_iters} "
        f"iterations (Gp={a.compat.shape[0]} Cp={a.compat.shape[1]} "
        f"Kp={a.onehot.shape[0]}): {b5_ms:.6f} ms, plain {b5_plain_ms:.3f} ms, "
        f"ops={b5_ops} bytes={b5_bytes} | card: {smi}")

    # ---- 8. the consolidation probe path
    probes = probe_phase(kernels, consolidation_batch, lp_device, cuda_build, err, smi)
    route_launches = {
        name: sum(n[name] for n in (*launches.values(), *probes["launches"].values()))
        for name in ("pack_split", "pack_split_wavefront", "pack_split_flat")
    }
    report = {"kernels": [
        {"name": "pack_split", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_split.cu",
         "replaces": "karpenter_tpu/solver/pack.py:444",
         "launches": route_launches["pack_split"], "max_abs_err": err["pack_split"],
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None},
        {"name": "pack_split_wavefront", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_wavefront.cu",
         "replaces": "karpenter_tpu/solver/pack.py:786",
         "launches": route_launches["pack_split_wavefront"],
         "max_abs_err": err["pack_split_wavefront"],
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None},
        {"name": "pack_split_flat", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_flat.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1374",
         "launches": route_launches["pack_split_flat"], "max_abs_err": err["pack_split_flat"],
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
        {"name": "lp_price", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/lp_price.cu",
         "replaces": "karpenter_tpu/solver/lp_plan.py:150",
         "launches": launches["cost"]["lp_price"], "max_abs_err": err["lp_price"],
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound,
         "bound_by": b4_by, "library_ms": None},
        {"name": "lp_ascend", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/lp_ascend.cu",
         "replaces": "karpenter_tpu/solver/lp_device.py:202",
         "launches": launches["cost"]["lp_ascend"], "max_abs_err": err["lp_ascend"],
         "ms": b5_ms, "plain_ms": b5_plain_ms, "bound_ms": b5_bound,
         "bound_by": b5_by, "library_ms": None},
        *probes["entries"],
    ]}
    say(json.dumps(report))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
