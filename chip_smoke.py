#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --quick   # phases 1-3, the warm first request's
                                    # hold and phase 5 alone, split B1 and
                                    # B3 at S=4 on it (held, timed in turns
                                    # with B1 and B3, phase clocks and
                                    # exchange census; the census also in
                                    # cost mode and on reserved_50k in both
                                    # modes), then B5 on reserved_50k's LP
                                    # (~2.5 min)
    python3 chip_smoke.py --split   # phases 1-2, then split B1 and B3 at
                                    # S = 2, 4, 8 on the first request
                                    # alone (held, in turns with B1 and
                                    # B3, barriers, clocks, census)
    python3 chip_smoke.py --catalog # phases 1-2 and 11 alone (~2 min of
                                    # command once built)
    python3 chip_smoke.py --lanes   # phases 1-2, then B6 sequential (shared
                                    # and spilled) and the in-place flat
                                    # routes held alone
    python3 chip_smoke.py --dense   # phases 1-2, then phase 9 (B7) alone
                                    # on the three full-width problems,
                                    # staged by the port's solves (~3 min)
    python3 chip_smoke.py --ladder  # phases 1-2 and 12 alone: the
                                    # resilience ladder's script on the
                                    # card and its walls
    python3 chip_smoke.py --provision # phases 1-2 and 13 alone: the
                                    # provisioning path through the
                                    # Provisioner on the card, held
                                    # against device="cpu"
    python3 chip_smoke.py --tick    # phases 1-2 and 14 alone: the
                                    # incremental tick, the micro path
                                    # and IncrementalPipeline on the
                                    # card, held against device="cpu"
    python3 chip_smoke.py --disrupt # phases 1-2 and 15 alone: the
                                    # consolidation engine's rounds on the
                                    # card, held against the batch off,
                                    # the pruner off and device="cpu"
    python3 chip_smoke.py --warm    # phases 1-2 and the warm phase alone
    python3 chip_smoke.py --environment
                                    # phases 1-2, the warm phase and 16:
                                    # the simulated cluster on the card,
                                    # held against device="cpu"
    python3 chip_smoke.py --operator # phases 1-2 and 17 alone: the
                                    # Operator's main path, the
                                    # real-client stack and the binary
                                    # on the card, held against
                                    # device="cpu"
    python3 chip_smoke.py --soak    # phases 1-2 and 18 alone: the
                                    # scenario soak on the card, held
                                    # against device="cpu"
    python3 chip_smoke.py --b5-against DIR
                                    # phases 1-2, then B5 here against the
                                    # checkout DIR's: its time on
                                    # reserved_50k's LP (the 2048 layout),
                                    # the 4096-config bucket shape and
                                    # aws_catalog_50k's LP (the wide one,
                                    # with phase clocks and chain floor)
                                    # in turns (DIR, here, here, DIR) and
                                    # each lp_ascend kernel's machine code
    python3 chip_smoke.py --b6-against DIR
                                    # phases 1-2, then B6's wavefront
                                    # program here against DIR's, in
                                    # turns: phase 8's first chunk (phase
                                    # clocks, chain floor) and
                                    # lane_cases(0) at 10 and 64 lanes;
                                    # each pack_wavefront kernel's
                                    # machine code
    python3 chip_smoke.py --against DIR
                                    # phases 1-2, then `compare_timings`
                                    # in the checkout DIR (e.g. the
                                    # parent's, unpacked with git
                                    # archive) and here, in turns (DIR,
                                    # here, here, DIR): B1, B3, B2, split
                                    # B1/B3/B2 at S = 2, 4, 8, split B2's
                                    # kernel alone, B4 (its phase clocks
                                    # where the tree has them), B6 on
                                    # lane_cases(0) at 10 and 64 lanes and
                                    # on phase 8's first chunk, the whole
                                    # pack_split_flat and
                                    # pack_probe_lanes_flat calls, B2 and
                                    # the lane epilogue as the main path
                                    # runs them, B7 (and B1) on entry()
                                    # and phase 9's three problems (staged
                                    # once, by the first run) and the whole
                                    # pack_flat call; then the machine code
                                    # of B1, B3 and B2 in each tree compared
                                    # kernel by kernel

Phases, each reported on its own line; any failure exits non-zero. The
CPU references that need nothing of the card (phase 4's first and small
requests, phase 11's catalog and its cost solve, phase 13's benchmark
rounds, phase 14's stream with its micro path and its pipeline, phase
16's Environment stream, phase 17's operator and real-client runs,
phase 18's soaks, each with device="cpu" from the same seeds) are
computed in two worker
processes, started after the build, beside the card's phases; the
processes are stopped when the script ends.
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile the CUDA kernels from karpenter_tpu_torch/csrc
                (one nvcc per source, in parallel, B1's and B3's sources
                a second time with their phase clocks); print build
                seconds, each library's machine tag (`cuda_build.
                machine_tag()`: the nvcc version and the card's compute
                capability, part of its digest) and what ptxas reports
                (registers, shared memory).
  warm        — `warm_pool.warm()` on the card over its default buckets
                (`DEFAULT_SHAPES` in both modes, with and without the
                topology inputs, the default probe buckets, the
                dual-ascent buckets): one canary launch of each kernel a
                bucket's route runs (B1, B3, B2, B6 and its epilogue, B5),
                read back; `karpenter_solver_warm_compiles_total` must
                show no `error` and no bucket may be skipped (B5's wide
                layout takes the 4096-config dual-ascent buckets).
                Each bucket's wall, and each kernel's
                first launch in the process (CUDA loads its module then)
                against the same canary again. Then the resilience
                ladder's re-warm gate (KARPENTER_REWARM_ON_CLOSE=1): two
                injected device faults open the device breaker on
                `build_problem(200, 20, seed=7)`, and the half-open
                success closes it only after `rewarm_canary()` launched
                on the card. Later phases' device-served checks count
                from the ladder's counts after this phase.
  3. kernels  — hold each kernel against its plain PyTorch version on
                the card, on seeded problems (B4 and B5 on their own
                seeded cases, B5 also on edge cases: one whose arrays
                exceed the shared memory and must take the global-memory
                path, column maxima at 0 with tied groups, 801 configs,
                sums of at most 32 terms; and past 2048 padded groups or
                configs, its wide layout: the warm buckets' 155 x 4438
                and 243 x 4438, 2840 and 2272 configs, 2272 and 4438
                groups); the packing kernels in both modes, reservations,
                bound rows with quotas, group caps, conflicts, negative
                and huge demand, a capped node axis): outputs must be
                byte-identical, B3's at widths 1, 8, 16 and 32, and B3's
                equal to B1's on the same problem, and the flat routes
                in place (`pack_split_flat` on B1 and B3 at 8, 16, 32:
                the packing kernel writing into the buffer's regions,
                the mask epilogue) equal to the full copy of the plain
                outputs; B6 sequential on `lane_cases(0)` (256 threads a
                block), all shared and spilled (compat bits alone, every
                segment), and the lane flat routes on both programs (the
                sequential one in place, then the mask epilogue) at
                L = 10 and L = 1; two of them also at
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
                block of B1 and B3 takes; the whole `pack_split_flat`
                call on the B1 and B3 routes (the card's time and as the
                host launches it), B2 as the main path runs it (the mask
                epilogue on the B3 route's buffer: its kernel, its call,
                its plain version, the host clock of the route's
                parts) beside the full copy; then one run each of B1's and
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
                ascent, each arm's pack, merge/trim, decode). The cold
                race runs in the JAX package's order (FFD dispatched,
                `_plan_for` on the host, the planned arms dispatched,
                then FFD, cost and rank fetched), which the run holds
                from the cold solve's `solve.*` spans and a `race.plan`
                span; it prints how much of FFD's kernel time (CUDA
                events, put on the host clock) lay under `_plan_for`,
                and the cold and warm race walls. It must
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
                row also equals B1/B3 + B2 run alone on that lane; B6
                wavefront also on every launch shape of arm (c) (and of
                phases 15 and 16, `hold_b6_shapes`). The
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
                bounds, the lanes the card holds at once and the
                memory the wavefront program took; B6 sequential's lane 0
                and the lane with the most demand alone, and the phase
                clocks of both; the
                whole `pack_probe_lanes_flat` call on both programs; the
                lane epilogue on both routes (the wavefront route's full
                copy, the sequential route's in place).
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
                (B7 once, writing the flat buffer in place; decoded as
                the host reads it) must equal B1 on every assignment,
                node count, unschedulable tally and free row, with the
                bound rows left one-hot, and both must equal their plain
                versions byte for byte; each launches B7 once per
                request. B7's CUDA-event times on the entry problem and
                on each request, at both block sizes, in turns with B1's
                on the same problem; the whole `pack_flat` call; the
                plain versions' times; the bounds; B7's phase clocks at
                both sizes on the entry problem and the second and third
                requests; and the chain floor (the steps with demand x
                the least step's block barriers x one barrier alone).
  10. sharded — B8, the config axis split over S shards, on virtual
                meshes of shard slots on the card (`force_virtual_mesh`):
                split B1, B3 (widths 8 and 16) and B2 byte-identical to
                their plain split versions on seeded problems (four at
                S = 2 and 4, two at S = 3 and 8), on
                boundary-tie problems and on the open loop's corners
                (`testing.fold_cases`: three pools, a reserved column
                cheaper than every uncapped one on one shard only, a
                chosen pool of zero open capacity) at S in (2, 3, 4, 8), every
                replica equal and the flat buffers equal to the unsplit
                kernels'; split B5 bit-identical to its plain version at
                S in (2, 4) (64 iterations; 192 on the LP route below).
                Then, each route with the launch counts set
                to 0 just before it and read just after, launching the
                split kernels and no unsplit packing kernel: the first
                50k x 500 request at S in (2, 3, 4, 8) on the B3 route
                and the KARPENTER_WAVEFRONT=0 B1 route, the second
                request at S=4, reserved_50k's cost solve at S=4 (its
                encode's split B1 and B3 then run once each from their
                phase-clock builds in both modes: the exchange census
                with reserved columns), each
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
                LP at S=4), the bounds, the plain split versions'
                times from the runs that held the first request at S=4,
                and one run of split B1 and B3 at each timed S from their
                phase-clock builds: the phases of shard 0's block and the
                exchange census (each kind's exchanges a launch, the
                cycles one took on block 0's thread 0 and its block
                barriers; split B3's round barriers).
  11. catalog — the packing kernels past the shared-memory ceiling on
                `workloads.aws_catalog_50k()`: 800 instance types of
                distinct shapes (2,400 configs) against 50k pods of
                bench.py's million_pod recipe (538 groups), whose tables
                no longer fit a block. `solve()` on the B3 route and the
                B1 route (KARPENTER_WAVEFRONT=0), the launch counts set
                to 0 before each and read after: each must launch its
                spilled kernel ("<wrapper>_global") and B2, and equal the
                CPU path's fingerprint (computed once). Held byte for
                byte against the plain versions there: B1 and B3 (widths
                8, 16) and B2, B6 (both programs) on seeded lanes, B7 and
                pack_flat on the problem laid out densely. The fleet
                consolidates with a wave of 5,000 pods pending (a cycle's
                100-prefix ladder as lanes of LaneSolver, B6 spilled, on
                both programs; three lanes equal to solve() of the same
                probe). The 1,600-type catalog (4,800 configs) at S=2:
                solve() on both routes equal to the unsharded card solve
                (the spilled split B1 and B3), then held with B2; split
                B1/B3/B2 with 80 node pools at S=2, 4, and spilled at S=2.
                Each spilled kernel timed beside the all-shared one on
                the largest shape that fits both (the catalog cut to the
                groups B3's block holds whole, spilled through
                `forced_budget`), in turns; then each at the catalog's
                own shape with its plain version and bound. Last, the
                cost objective past 2048 configs: B5's wide layout held
                bit for bit on the catalog's LP (594 x 2840 padded) and
                on the warm bucket's 243 x 4438 shape, timed there with
                its bound and phase clocks; the catalog's cost solve
                without column generation (the FFD pack, B5's duals
                guiding the trim; the planner's MIPs stop on the host's
                wall clock) equal to device="cpu"'s fingerprint,
                launching B5's wide layout.
Every packing solve of phases 4-11 goes through the resilience ladder
(`solver/resilience.py`). After phase 11 (and at the end of `--quick`)
the run fails unless the device or sharded rung served every one of
them: the ladder's counter holds only `ok` outcomes on those rungs,
`resilience.pop_degraded()` was empty after each phase, and no device
LP degraded.
  12. ladder  — `testing.ladder_script` on the card, on
                `build_problem(1000, 50, seed=7)` (the host oracle is a
                Python loop a pod and a node: the benchmark's 50k pods
                would take it minutes; 2000 pods before phase 18 came):
                healthy solves on the device
                rung; a lost device opening the breaker (skipped while
                it cools, half-open, closed again); an execute stall
                past KARPENTER_SOLVE_DEADLINE_MS and a launch stall past
                KARPENTER_COMPILE_DEADLINE_MS, served by the host; the
                hedge winning; a lost sharded rung served by the device
                rung; the probe site's fault charging the device
                breaker; the device LP failing inside its own call
                (`maybe_solve` None and counted, the cost solve equal to
                the one without the LP, the certificate not retried
                until the next staging); the asynchronous seam
                (`solve_packing_async`): a healthy solve served by the
                device rung at its guarded fetch, device_lost at the
                fetch's execute site served by the host, and a
                deadline-mode solve whose ladder runs on an executor
                worker, served by the host with the degradation report
                on the calling thread. Every device-served result is
                byte-identical to a direct `pack.solve_packing` on the
                card, every host-served one equal to `host_pack_result`.
                Then the walls (host clock, median of 5, in turns): the
                warm 50k x 500 first request through
                `resilience.shared().solve_packing` against
                `pack.solve_packing` directly, and with
                KARPENTER_SOLVE_DEADLINE_MS=10000 (the attempt on a
                watchdog thread); the host rung's wall on the script's
                problem; the deadline case's wall against its budget.
  13. provisioning — the port's main path, pending pods in the in-memory
                API (`kube.client.KubeClient`, the cluster mirror
                `state.cluster.Cluster` on its watches, a
                `FakeCloudProvider`) to NodeClaims through
                `Provisioner.reconcile`, on three problems, each held
                against the same run with device="cpu" by the
                name-insensitive decision fingerprint
                (`testing.decision_fingerprint`, in-flight claims named
                by creation order): the benchmark problem (50k pods x
                500 types) in two rounds, the second after the first
                round's claims launch (in flight, no node registered)
                and 10k more pods arrive, so the pending pods land on
                the in-flight claims (one warm-up environment, then
                one fresh one timed); bench.py's scenario_topology
                demand (1000 pods of 20 apps, zonal spread, hostname
                anti-affinity on every tenth, over `instance_types(100)`)
                through `Scheduler.solve`; bench.py's scenario_mixed
                demand (`build_problem(10_000, 400)` on the family-priced
                catalog beside a tainted pool of weight 50 over 60 types,
                every fifth pod tolerating it) through the Provisioner.
                Between two rounds the claims launch through the
                lifecycle controller (`NodeClaimLifecycle` over the
                `FakeCloudProvider`: `testing.launch`).
                Each problem's card runs, with the launch counts set to 0
                just before and read just after, must launch a packing
                kernel and B2; every pod is placed or unschedulable. The
                host-clock walls of a round (intake, the Scheduler's own
                host work, `solve_encoded`, claim creation) and the
                card's ms inside its packing calls. Phase 13 runs with
                KARPENTER_INCREMENTAL=0: the full Scheduler path. After
                phase 13 the device rung must have served every solve of
                the phase.
  14. tick    — the incremental tick (`provisioning/incremental_tick.py`),
                the Provisioner's default path, as an event stream
                (`testing.run_stream`): phase 13's two rounds of the
                benchmark problem, then 4 steady rounds that register the
                claims, bind the pods, delete 1% of the bound pods (a
                seeded draw) and respawn their shapes (bench.py's
                steady_state_churn), then 2 quiet rounds of 0.1%. Each
                round's decision fingerprint and route (path, reason)
                equal to the same stream with device="cpu"; the stream
                with KARPENTER_INCREMENTAL=0 on the card equal decision
                for decision; once more with audit_every=1, every shadow
                audit clean. Per round: the route, the tick's sync, host
                work and solve_encoded, claim creation, the whole round
                and the card's ms beside the full path's on the same
                round; the fallbacks by reason. Then the micro path:
                under KARPENTER_MICRO_DUAL=1 a tick refreshes the dual
                floor (B5), and `Provisioner.micro_solve` takes 2,000
                arrivals; its `micro_order`, decisions and `lam_by_sig`
                equal to device="cpu"'s. Then `IncrementalPipeline` on
                `build_problem(50_000, 500, seed=3)`, objective cost, 1%
                churn a tick through the delta API: the cold tick and 3
                churn ticks equal to device="cpu"'s (fleet price,
                unschedulable, each node's pods; the planner's MIPs
                stopped at the root node and its time budget lifted on
                both sides), 10 churn ticks timed against a full cost
                solve of the same pods (the first 3). Each part launches
                a packing kernel and B2, the micro part B5; the device
                rung serves every solve of the phase.
  15. disruption — the consolidation engine (`disruption/engine.py`) on
                the card: bench.py's consolidation fleet
                (`build_problem(21000, 200, seed=9)`) provisioned through
                the Provisioner and settled, 55% of its pods deleted
                (consolidation_fleet's draw), then rounds of
                `DisruptionEngine.reconcile` and the queue
                (`testing.disruption_rounds`: replacements registered,
                validation, the candidates drained through
                `KubeClient.evict`, the displaced pods placed again)
                until a round decides nothing or stalls (the same command
                rolled back again); per round the deciding method, its
                command, the fleet's $/h, each method's wall (the
                engine's own DISRUPTION_EVALUATION_DURATION), the card's
                ms in the packing calls, B6's lanes and dispatches; then
                the probe methods on the final fleet. Holds: round 1 of
                fresh streams with KARPENTER_BATCH_PROBES=0 and with
                KARPENTER_LP_PRUNE=0 decides the same, and so do the
                probe methods on the final fleet (single-node only with
                the pruner off: batch off it is a solve a candidate); the
                first B6 chunk the engine dispatched is byte-identical to
                `pack_probe_lanes_flat_ref`; with the counts zeroed
                before the stream and read after the probe pass, the
                engine launched B6 and the lane epilogue, B5, B4, B3 or
                B1, and B2; the stream on MID_FLEET decides round for
                round as device="cpu"'s; at 50k x 500 (registered, all
                bound) one reconcile decides alike with the retained seam
                warm and with KARPENTER_DISRUPTION_SNAPSHOT=0 (the scan
                walls of both printed). The device rung serves every
                solve of the phase.
  16. environment — the simulated cluster: `testing.Environment(device=
                "cuda")` (the in-memory API, the cluster mirror, the kwok
                provider, the lifecycle, termination, disruption,
                interruption and static-capacity controllers) over phase
                13's 500-type catalog and 50k pods, through
                `testing.environment_stream`: the pods provisioned (claims
                launched through `KwokCloudProvider`, nodes registered,
                pods bound), 30% of them deleted and
                one `reconcile_disruption` round (ENV_ROUNDS; the
                stream ends early when nothing is decided or the command
                stalls, ROADMAP C6), the probe methods on
                what is left, `reconcile_termination`, then three spot
                interruptions and `reconcile_interruption` rounds. Each
                step's name-insensitive decision and fleet equal to the
                same stream with device="cpu" (computed in the worker);
                per step its host wall, the card's ms in the packing
                calls and the kernels it launched (the counts zeroed
                before the stream, read after it); B2, B3, B4, B5 and B6
                must launch, and the device rung serve every solve. Then
                `metrics.exposition.render()` must carry the five phase
                labels of `karpenter_solver_phase_duration_seconds`,
                `karpenter_solver_probe_batch_total` and
                `karpenter_solver_device_steps` must agree with the
                launches of B6 and of the flat solves, and the metrics
                controllers' gauges (pods, nodes, node pools, status
                conditions) equal the CPU run's.
  17. operator — the system as a user starts it: (a) `Operator(device=
                "cuda")` over the in-memory store and the kwok provider
                (`testing.operator_run`): phase 13's 50k pods x 500 types
                in two waves of provisioning ticks (claims launched
                through the lifecycle, the binding queue's drain), 200
                arrivals through `micro_step` with the reactive plane on,
                16 pods of a PriorityClass of 1000 under the pool capped
                at the fleet's cpu (preemption nominates victims), then
                the pods of 20 nodes and those still pending deleted and
                the pool consolidated when empty, and six disruption
                scans (the emptied nodes' command, an empty-handed scan,
                then the skip gate); every step's name-free
                record (fleet, pending and nominated pods, claims,
                instances, `readyz()`'s clock-free counts, the counters'
                growth, micro digests, commands) equal to device="cpu"'s
                (the worker, PYTHONHASHSEED=0), each step's wall and the
                card's ms; it must launch B1 or B3 and B2. (b) the
                real-client stack, `RealKubeClient(InMemoryApiServer())`,
                at 5,000 pods x 500 types under
                KARPENTER_FAULTS=operator_crash@crash_launch:1, the client
                and the Operator rebuilt after the crash: it converges to
                device="cpu"'s fleet with nothing leaked; OPERATOR_RECOVERY
                and KUBE_RETRIES printed. (c) the binary, `python -m
                karpenter_tpu_torch --demo 2000 --run-seconds 20
                --metrics-port 0`, as a subprocess on the card: /healthz,
                /readyz and /metrics read over HTTP while it runs, exit 0
                with every pod bound; with CUDA_VISIBLE_DEVICES="" it
                must exit non-zero. The device rung serves every solve.
  18. soak    — the scenario flywheel (`scenarios.run_soak`, the full
                reactive Operator over `RealKubeClient(InMemoryApiServer())`
                and the kwok provider under injected virtual time, forced
                oracle audits, spot storms from the composed fault spec)
                with device="cuda": `smoke_spec()` and
                `flywheel_spec(duration_s=600)` must pass and their
                `report_digest` equal device="cpu"'s (the worker's, under
                the same hash seed); then the sensitivity control,
                `smoke_spec()` with exec_delay@crash_tick:*=2s#lag, must
                fail on the sentinel and SLO planes, its digest equal to
                the CPU's too. Per soak its wall, the card's ms in its
                packing calls and the kernels it launched. The device rung
                serves every solve.
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
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
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
# B4 past its staged layout (R = 4: 6,428 groups), seeded (G, C): the walk
# order kept, then the full argmax (past 19,280 groups)
PRICE_PAST_CEILING = ((7_000, 64), (20_000, 64))
EDGE_ITERS = {GLOBAL_CASE: (8, 32)}
# B5's wide layout (past 2048 padded axes): a few iterations each (the
# plain version of a 4438-group axis takes ~1 s an iteration on the card's
# host); phase 11 holds the warm bucket's 243 x 4438 at the ascent's 192
WIDE_ITERS = {"ascent-wide-g4438": (4,)}
WIDE_ITERS_DEFAULT = 8
# block barriers in a row that time one barrier (lp_device.barrier_probe)
BARRIER_PROBE = 20_000
# the consolidation phase: bench.py's consolidation_500 (its defaults
# in workloads.consolidation_fleet), a mid-size fleet for the
# card-against-CPU check, the wavefront widths held on seeded lane cases
# and the lane width the CPU run forces
MID_FLEET = (3000, 60)
# the argument that runs phases 1-3 and 5 only (`quick_timing`), and
# the one that runs phases 1-2 and the split kernels' timing alone
QUICK = "--quick"
SPLIT = "--split"
PROBE_WIDTHS = (8, 16)
CPU_PROBE_WIDTH = 8
PROBE_KNOBS = ("KARPENTER_WAVEFRONT", "KARPENTER_WAVEFRONT_WIDTH",
               "KARPENTER_PROBE_BATCH_WIDTH", "KARPENTER_PROBE_LANE_BUCKET")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# the references on the CPU that need nothing of the card, by name: the
# fingerprints of phase 4's first and small requests (device="cpu"), of
# phase 11's catalog (its ffd and its cost solve), phase 13's benchmark
# rounds, phase 14's stream with its micro path and its pipeline, phase
# 16's Environment stream, phase 17's operator run and real-client
# run, and phase 18's soaks. The whole run computes them in two worker processes of their own
# (CPU_REF_THREADS threads each, one group of CPU_REFS_ORDER each),
# started after the build, so that they run beside the card's phases; a
# phase run alone computes its own inline
CPU_REFS_ORDER = (("first", "small", "catalog", "provision", "tick", "pipeline",
                   "environment"),
                  ("cost hetero 2000x80", "cost reservations 5000x100", "catalog_cost",
                   "operator", "client", "soak smoke", "soak flywheel", "soak lag"))
CPU_REF_THREADS = 2


def cpu_reference(name: str):
    """The reference `name` computed on the CPU from its seeds: phase
    4's and 11's a solution fingerprint; phase 13's the benchmark
    problem's two reconcile rounds in a fresh environment (the rounds'
    fingerprints, pods placed or unschedulable, and rungs degraded);
    phase 14's `tick_stream` (fingerprints, routes, rungs degraded) and
    then its `micro_continue`, `pipeline_run`'s held rows and cold
    tick's wall, phase 16's `environment_run` (its records, the
    metrics controllers' gauges after it, the rungs degraded), phase
    11's cost solve of the catalog (`catalog_cost`), phase 17's
    `operator_main_run` records and `client_main_run`, and phase 18's
    `soak_run` of each spec."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver.encode import group_pods
    from karpenter_tpu_torch.solver.solver import fingerprint, solve
    from karpenter_tpu_torch.workloads import aws_catalog_50k, build_problem

    if name == "catalog":
        pods, pools = aws_catalog_50k(CATALOG_TYPES)
        return fingerprint(solve(pods, pools, device="cpu"))
    if name == "catalog_cost":
        pods, pools = aws_catalog_50k(CATALOG_TYPES)
        return catalog_cost(pods, pools, "cpu")
    if name.startswith("cost "):
        return cost_check(name[len("cost "):], "cpu")
    if name == "operator":
        return operator_main_run("cpu")
    if name == "client":
        return client_main_run("cpu")
    if name.startswith("soak "):
        return soak_run(name[len("soak "):], "cpu")
    if name == "tick":
        degraded: list = []
        env, out = tick_stream("cpu", on_round=lambda k, r: degraded.append(
            [] if r is None else list(r.degraded_rungs)))
        stream = {"fingerprints": list(out["fingerprints"]), "routes": list(out["routes"])}
        return {"stream": stream, "degraded": degraded, "micro": micro_continue(env, out)}
    if name == "pipeline":
        rows, _, _, cold = pipeline_run("cpu", PIPELINE_HELD, 0)
        return rows, cold
    if name == "environment":
        from karpenter_tpu_torch.solver import resilience

        resilience.pop_degraded()
        env, steps = environment_run("cpu")
        return {"steps": steps, "gauges": controller_gauges(env),
                "degraded": resilience.pop_degraded()}
    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    if name == "first":
        return fingerprint(solve(pods, pools, device="cpu"))
    if name == "small":
        small = [p for g in group_pods(pods)[:SMALL_GROUPS] for p in g.pods]
        return fingerprint(solve(small, pools, device="cpu"))
    if name != "provision":
        raise ValueError(f"no CPU reference {name!r}")
    extra, _ = build_problem(N_EXTRA, N_TYPES, seed=SEED + 1, name_prefix="extra-")
    out = testing.reconcile_rounds(testing.pods_env(pods, pools, device="cpu"), [extra])
    return {"fingerprints": out["fingerprints"],
            "placed": [placed_pods(r) for r in out["results"]],
            "degraded": [list(r.degraded_rungs) for r in out["results"]]}


def placed_pods(results) -> int:
    """Pods a provisioning round placed on new or existing nodes or left
    unschedulable."""
    return (sum(len(p.pods) for p in results.new_node_plans)
            + sum(len(v) for v in results.existing_assignments.values())
            + len(results.errors))


def cpu_ref_worker(names, conn) -> None:
    """A worker process's body: each reference of `names` in turn, sent
    down `conn` as (name, "ok" or "error", value or message, seconds)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(CPU_REF_THREADS)
    for name in names:
        t0 = time.perf_counter()
        try:
            out = ("ok", cpu_reference(name))
        except Exception as err:  # noqa: BLE001 - the parent fails with it
            out = ("error", f"{type(err).__name__}: {err}")
        conn.send((name, *out, time.perf_counter() - t0))
    conn.close()


class CpuRefs:
    """The CPU references: from the worker processes once `start`ed (one a
    group of names), else computed inline on first use."""

    def __init__(self):
        self.workers, self.done = [], {}

    @property
    def names(self) -> tuple:
        return tuple(n for _, _, names in self.workers for n in names)

    def start(self, groups=CPU_REFS_ORDER) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        for names in groups:
            conn, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=cpu_ref_worker, args=(names, child), daemon=True)
            proc.start()
            child.close()
            self.workers.append((proc, conn, tuple(names)))

    def get(self, name: str):
        """The reference and the seconds it took to compute."""
        if name not in self.names and name not in self.done:
            t0 = time.perf_counter()
            self.done[name] = ("inline", cpu_reference(name), time.perf_counter() - t0)
        proc, conn = next(((p, c) for p, c, names in self.workers if name in names),
                          (None, None))
        while name not in self.done:
            try:
                got, status, value, secs = conn.recv()
            except EOFError:
                fail(f"the CPU reference worker ended before computing {name} "
                     f"(exit code {proc.exitcode})")
            if status != "ok":
                fail(f"the CPU reference {got} failed: {value}")
            self.done[got] = ("worker", value, secs)
        return self.done[name][1:]

    def where(self, name: str) -> str:
        return {"worker": "in the worker process, beside the card's phases",
                "inline": "inline"}[self.done[name][0]]

    def close(self) -> None:
        for proc, _, _ in self.workers:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        self.workers = []


CPU_REFS = CpuRefs()


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
    # B2 takes whole mask words: a config axis that is a multiple of 32;
    # the full copy on each route's outputs, and the flat route in place
    # (B1 or B3 writing into the buffer's regions, the mask epilogue)
    for wf, (outs, stats) in zip((0, *widths), flats) if args[0].shape[1] % 32 == 0 else ():
        flat_ref = kernels.pack_flat_words_ref(*outs, *stats)
        rows = {"pack_flat_words": kernels.pack_flat_words(*outs, *stats)}
        if wf != 1:  # a width of 1 takes the B1 route, without B3's stats
            rows["pack_split_flat in place"] = kernels.pack_split_flat(
                *args, max_free=case.max_free, mode=case.mode, wavefront=wf, **kw)
        torch.cuda.synchronize()
        for label, row in rows.items():
            if row.dtype != flat_ref.dtype or not torch.equal(row, flat_ref):
                fail(f"{label} (wavefront {wf}) differs from pack_flat_words_ref of the plain "
                     f"outputs on {case.name}")
            err["pack_split_flat"] = max(err["pack_split_flat"], max_abs_diff(row, flat_ref))
    B = args[7].shape[0]
    return (f"  case {case.name} mode={case.mode} Gp={args[0].shape[0]} "
            f"Cp={args[0].shape[1]} B={B} F={case.max_free}: nodes={int(got[2])} "
            f"bound_pods={int(got[0][:B].sum())} unsched={int(got[3].sum())} "
            f"rounds {' '.join(rounds)} identical")


@contextlib.contextmanager
def b6_wavefront_shapes(kernels):
    """Within the block, the first B6 wavefront launch of each distinct
    shape (lanes, groups, configs, bound rows, free rows, mode, width) on
    the card keeps its inputs and outputs, cloned: {shape: (args, kwargs,
    outputs)}, for `hold_b6_shapes`."""
    import torch

    real = kernels.pack_probe_lanes_wavefront
    rec: dict = {}

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def call(*a, **k):
        out = real(*a, **k)
        key = (tuple(a[2].shape), tuple(a[0].shape), a[7].shape[0], k.get("max_free"),
               k.get("mode"), k.get("width"))
        if a[0].is_cuda and key not in rec:
            rec[key] = ([clone(x) for x in a], {n: clone(v) for n, v in k.items()},
                        [clone(o) for o in out])
        return out

    kernels.pack_probe_lanes_wavefront = call
    try:
        yield rec
    finally:
        kernels.pack_probe_lanes_wavefront = real


def hold_b6_shapes(kernels, rec: dict, label: str) -> str:
    """Each launch `b6_wavefront_shapes` kept, against the plain version
    on the same inputs: every output (assign, free_mask, node_count,
    unsched, steps, widths) byte for byte."""
    import torch

    if not rec:
        fail(f"{label}: no B6 wavefront launch to hold")
    host = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
    shapes = []
    for (lanes, (G, C), B, F, mode, W), (a, k, got) in rec.items():
        want = kernels.pack_probe_lanes_wavefront_ref(
            *[host(x) for x in a], **{n: host(v) for n, v in k.items()})
        if not all(same_bits(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"{label}: B6 wavefront at L={lanes[0]} Gp={G} Cp={C} B={B} F={F} {mode} "
                 f"W={W} differs from pack_probe_lanes_wavefront_ref")
        shapes.append(f"L={lanes[0]} Gp={G} Cp={C} B={B} F={F} {mode} W={W}")
    return (f"  {label}: B6 wavefront byte-identical to its plain version on each of its "
            f"{len(rec)} launch shapes ({'; '.join(shapes)})")


def same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def hold_price(lp_plan, name: str, xs, err: dict, layouts=(None,)) -> str:
    """B4 against its plain version on the card, in each of `layouts`
    (None: the wrapper's choice): bit-identical q and value, or fail."""
    import torch

    qr, vr = lp_plan.price_kernel_ref(*xs)
    torch.cuda.synchronize()
    names = []
    for layout in layouts:
        q, v = lp_plan.price_kernel(*xs, layout=layout)
        torch.cuda.synchronize()
        if layout is None:
            layout = lp_plan.price_layout(xs[0].shape[0], xs[2].shape[1])
        names.append(lp_plan.PRICE_LAYOUTS[layout])
        if not (same_bits(q, qr) and same_bits(v, vr)):
            fail(f"lp_price differs from price_kernel_ref on {name} ({names[-1]} layout)")
        err["lp_price"] = max(err["lp_price"], max_abs_diff(q, qr), max_abs_diff(v, vr))
    return (f"  case {name} Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} "
            f"R={xs[2].shape[1]}: pods planned {int(q.sum())}, hits at price 0 "
            f"{int((v > 0).sum())} identical ({', '.join(names)} layout)")


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


def price_clocks(kernels, lp_plan, xs) -> tuple[str, float]:
    """One run of B4 from its phase-clock build: each phase's share of
    the configs' chains (summed), their rounds, the least and most cycles
    of a round (a config's rounds' cycles over its rounds), the SM clock
    (cycles over the global timer's ns), and the chain's floor in ms: the
    most rounds of a config times the least cycles of a round, at that
    clock."""
    with kernels.phase_clocks("lp_price") as take:
        lp_plan.price_kernel(*xs)
        c = take()
    phases = kernels.PHASES["lp_price"]
    total = sum(c[k] for k in phases)
    if not total or not c["ns"] or not c["count"]:
        fail(f"lp_price: the phase-clock build counted nothing: {c}")
    mhz = total / c["ns"] * 1e3
    lo, hi = c["round_cycles"]
    floor_ms = c["max_rounds"] * lo / (mhz * 1e3)
    text = (f"{c['count']} configs ({c['monotone']} on the monotone path), "
            f"{c['round_count']} rounds (at most {c['max_rounds']} a config), a round "
            f"{lo}..{hi} cycles, {mhz:.0f} MHz | "
            + ", ".join(f"{k} {100 * c[k] / total:.1f}% ({c[k] / c['count']:.0f} cycles "
                        f"a config)" for k in phases)
            + " | a round's parts (cycles a round): "
            + ", ".join(f"{k} {v / max(c['round_count'], 1):.0f}"
                        for k, v in c["round_parts"].items())
            + f" | walks (entries tested a round): lane 0 "
            f"{c['walk'][0] / max(c['round_count'], 1):.2f}, the longest "
            f"{c['walk'][1] / max(c['round_count'], 1):.2f}"
            + f" | chain floor {floor_ms:.6f} ms")
    return text, floor_ms


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


def cost_phase(kernels, lp_plan, lp_device, pack, solver, build_problem, err: dict,
               launches: dict) -> dict:
    """Phase 6: the cost objective on reserved_50k through `solve()`,
    with its inputs recorded; returns what phase 7 times."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.testing import KernelCase

    pods, pools = build_problem(COST_PODS, COST_TYPES, seed=SEED,
                                reservations=True, zonal_frac=COST_ZONAL)
    from karpenter_tpu_torch import tracing

    real = {name: getattr(mod, name) for mod, name in (
        (lp_plan, "price_kernel"), (lp_plan, "_price_patterns"), (lp_plan, "plan"),
        (lp_device, "ascend"), (lp_device, "maybe_solve"), (pack, "stage"),
        (pack, "pack_split_flat"), (solver, "_solve_packing"),
        (solver, "_solve_packing_async"), (solver, "_plan_for"),
        (solver, "_finish_winner"), (solver, "_build_solution_arrays"),
        (solver, "group_pods"), (solver, "encode"))}
    owner = {"price_kernel": lp_plan, "_price_patterns": lp_plan, "plan": lp_plan,
             "ascend": lp_device, "maybe_solve": lp_device, "stage": pack,
             "pack_split_flat": pack}
    rec = {"price": [], "pp_calls": 0, "ascents": [], "plans": [], "cases": {},
           "mode_launches": {"ffd": {}, "cost": {}}, "times": {}, "mode": "ffd",
           "arm": None, "base_price": None, "ffd_events": None, "plan_for": []}

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
        # no synchronization here: the race's host work overlaps the card
        before = dict(kernels.LAUNCHES)
        events = rec["ffd_events"] if rec["arm"] == "ffd" else None
        if events is not None and not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = real["pack_split_flat"](*a, mode=mode, **k)
        if events is not None and len(events) == 1:
            events.append(torch.cuda.Event(enable_timing=True))
            events[1].record()
        tally = rec["mode_launches"][mode]
        for name, n in kernels.LAUNCHES.items():
            tally[name] = tally.get(name, 0) + n - before[name]
        return out

    def arm_of(enc, plan):
        return "ffd" if plan is None else (
            "cost" if enc.cfg_price is rec["base_price"] else "rank")

    def solve_packing(enc, mode, device, plan=None, shards=0):
        rec["mode"], rec["arm"] = mode, arm_of(enc, plan)
        return timed(f"pack {rec['arm']}", real["_solve_packing"])(enc, mode, device, plan,
                                                                  shards)

    class TimedPending:
        """An asynchronous arm whose fetch adds to its arm's pack time."""

        def __init__(self, pending, arm):
            self.pending, self.arm = pending, arm

        def result(self):
            return timed(f"pack {self.arm}", self.pending.result)()

    def solve_packing_async(enc, mode, device, plan=None, shards=0):
        rec["mode"], rec["arm"] = mode, arm_of(enc, plan)
        pending = timed(f"pack {rec['arm']}", real["_solve_packing_async"])(
            enc, mode, device, plan, shards)
        return TimedPending(pending, rec["arm"])

    def plan_for(*a, **k):
        t0 = time.perf_counter()
        with tracing.span("race.plan"):
            out = real["_plan_for"](*a, **k)
        rec["plan_for"].append((t0, time.perf_counter()))
        return out

    def encode(*a, **k):
        enc = real["encode"](*a, **k)
        rec["base_price"] = enc.cfg_price
        return enc

    wrapped = {
        "price_kernel": price_kernel, "_price_patterns": price_patterns,
        "plan": timed("plan", plan), "ascend": ascend,
        "maybe_solve": timed("ascent", real["maybe_solve"]), "stage": stage,
        "pack_split_flat": pack_split_flat, "_solve_packing": solve_packing,
        "_solve_packing_async": solve_packing_async, "_plan_for": plan_for,
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
        # the card idle: an event recorded now fires at this host time, so
        # the card's clock can be read on the host's (the FFD arm's events)
        torch.cuda.synchronize()
        ref_event = torch.cuda.Event(enable_timing=True)
        ref_event.record()
        t_ref = time.perf_counter()
        rec["ffd_events"] = []
        t0 = time.perf_counter()
        with tracing.trace("phase6-cold"):
            sol = solver.solve(pods, pools, objective="cost")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        ffd_events, rec["ffd_events"] = rec["ffd_events"], None
        cold_trace = tracing.last_trace()
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
    say("  " + race_overlap(cold_trace, ffd_events, ref_event, t_ref, rec["plan_for"],
                            cold_s, warm))

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

    # the card against the CPU path (the worker's) on two mid-size problems
    for name in COST_CHECKS:
        runs = [("the card", cost_check(name, None)),
                ("cpu", CPU_REFS.get(f"cost {name}")[0])]
        for where, (fp, price, nodes, stop, iters, est, planned, wall) in runs:
            say(f"  {name} on {where}: ${price:.6f}/h, {nodes} nodes, column generation "
                f"stopped by {stop} after {iters} rounds, estimate {est:.6f}, {planned} "
                f"planned nodes, {wall:.3f}s")
        if any(r[3] not in ("converged", "stall") for _, r in runs):
            fail(f"{name}: column generation did not end by convergence or stall: "
                 f"{[r[3] for _, r in runs]}")
        if runs[0][1][0] != runs[1][1][0]:
            fail(f"{name}: the card's cost fingerprint differs from the CPU path's")
    solver.reset_caches()
    say("  card and CPU fingerprints equal on both problems")
    return {"price_inputs": picks.get("first round", picks["seed"]),
            "ascent": rec["ascents"][0], "staged": rec["cost_staged"]}


def race_overlap(trace: dict, events: list, ref_event, t_ref: float, plans: list,
                 cold_s: float, warm: list) -> str:
    """Phase 6's cold race against the JAX package's order: FFD
    dispatched, `_plan_for` on the host, the planned arms dispatched, then
    the fetches. From the `solve.*` spans: FFD's launch (`solve.compile`)
    and its execute (launch return to the end of its copy), against the
    `race.plan` span. From CUDA events around FFD's launch, put on the
    host's clock through an event recorded while the card was idle: FFD's
    kernels on the card, and how much of them lay under `_plan_for`."""
    spans = trace["spans"] if trace else []
    by = {}
    for sp in spans:
        by.setdefault(sp["name"], []).append(sp)
    need = ("solve.compile", "solve.execute", "race.plan")
    if any(not by.get(name) for name in need) or len(events) != 2 or not plans:
        fail(f"phase 6: the cold race recorded spans "
             f"{ {k: len(v) for k, v in by.items()} }, {len(events)} FFD events, "
             f"{len(plans)} _plan_for calls")
    plan_sp = by["race.plan"][0]
    launch, execute = by["solve.compile"][0], by["solve.execute"][0]
    # the planned arms are launched before FFD's fetch ends
    before_fetch = [sp for sp in by["solve.compile"] if sp["t1_s"] <= execute["t1_s"]]
    if not (launch["t1_s"] <= plan_sp["t0_s"] and execute["t1_s"] >= plan_sp["t1_s"]
            and len(before_fetch) >= 2):
        fail(f"phase 6: the race did not dispatch FFD, plan, dispatch the arms and fetch "
             f"after: FFD launch {launch['t0_s']:.6f}-{launch['t1_s']:.6f}, plan "
             f"{plan_sp['t0_s']:.6f}-{plan_sp['t1_s']:.6f}, FFD execute "
             f"{execute['t0_s']:.6f}-{execute['t1_s']:.6f}, launches at "
             f"{[round(sp['t0_s'], 6) for sp in by['solve.compile']]}")
    in_flight = plan_sp["t1_s"] - plan_sp["t0_s"]
    k0 = t_ref + ref_event.elapsed_time(events[0]) / 1000
    k1 = t_ref + ref_event.elapsed_time(events[1]) / 1000
    p0, p1 = plans[0]
    kernel_s = max(0.0, k1 - k0)
    under = max(0.0, min(k1, p1) - max(k0, p0))
    return (f"race overlap (cold): FFD launched {1e3 * (launch['t1_s'] - launch['t0_s']):.3f} "
            f"ms, then _plan_for {1e3 * in_flight:.3f} ms on the host while FFD was in "
            f"flight (its execute span {1e3 * (execute['t1_s'] - execute['t0_s']):.3f} ms, "
            f"launch return to the end of its copy), {len(before_fetch)} launches before the "
            f"first fetch; FFD's kernels on the card {1e3 * kernel_s:.3f} ms (CUDA events), "
            f"{1e3 * under:.3f} ms of them under _plan_for "
            f"({(under / kernel_s if kernel_s else 0.0):.2%}); cold race wall "
            f"{cold_s:.6f}s, warm median {statistics.median(warm):.6f}s")


# phase 6's card-against-CPU cost solves (the CPU's in the worker)
COST_CHECKS = ("hetero 2000x80", "reservations 5000x100")


def cost_check(name: str, device) -> tuple:
    """The cost solve of COST_CHECKS' problem `name` on `device`, caches
    cleared: (fingerprint, $/h, nodes, column generation's stop reason,
    rounds, estimate, planned nodes, wall s). The planner's HiGHS MIPs
    stop at wall-clock limits, so the same plan can round differently
    under another load: every run stops them after the root node
    instead, the same work on every side."""
    from karpenter_tpu_torch.cloudprovider.fake import heterogeneous_instance_types
    from karpenter_tpu_torch.solver import lp_plan
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.testing import root_node_mips
    from karpenter_tpu_torch.workloads import build_problem

    if name == COST_CHECKS[0]:
        pods, pools = build_problem(2000, 80, seed=5)
        pools = [(pools[0][0], heterogeneous_instance_types(80))]
    else:
        pods, pools = build_problem(5000, 100, seed=SEED, reservations=True)
    plans, real = [], lp_plan.plan

    def plan(*a, **k):
        plans.append(real(*a, **k))
        return plans[-1]

    solver_mod.reset_caches()
    lp_plan.plan = plan
    try:
        with root_node_mips():
            t0 = time.perf_counter()
            out = solver_mod.solve(pods, pools, objective="cost", device=device)
            wall = time.perf_counter() - t0
    finally:
        lp_plan.plan = real
    p = plans[0] if plans else None
    return (solver_mod.fingerprint(out), out.total_price, len(out.new_nodes),
            p.debug["stop"] if p is not None else None, p.debug["iters"] if p else 0,
            p.objective_estimate if p else float("nan"), len(p.planned_cols) if p else 0,
            wall)


def hold_dense(pd, kernels, case, err: dict) -> str:
    """B7 and `pack_flat` (B7 writing the flat buffer in place) against
    their plain versions on the card on `case` (a testing.DenseCase),
    byte for byte on every output, and the dense ≡ split oracle against
    B1 on the same problem; fail otherwise. Returns a summary."""
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


# B7's full-width problems (phase 9, `--dense`, `compare_timings`)
DENSE_PROBLEMS = ("first request", "second request", "reserved_50k cost arm")
# the block barriers of B7's least step with demand (one chunk of rows,
# no open, no conflict row): the prefix scan's three, the take's one and
# the step's end; its chain floor is these a step times one barrier
DENSE_BARRIERS_A_STEP = 5


def barrier_us(pd, threads: int) -> float:
    """One block barrier of `threads` threads on its own, in us: B7's
    barrier probe at BARRIER_PROBE barriers less the probe at none."""
    t0 = event_ms(lambda: pd.barrier_probe(0, threads), 5)
    t1 = event_ms(lambda: pd.barrier_probe(BARRIER_PROBE, threads), 5)
    return 1000 * (t1 - t0) / BARRIER_PROBE


def dense_problems(cache: str | None = None) -> list:
    """B7's full-width problems as `testing.DenseCase`s, staged on the
    card through the tree's own `solve()` with `pack.stage` recorded:
    the first 50k x 500 request, the second (10k more pods against the
    first solve's nodes) and reserved_50k's planned pack (the cost arm
    of its cold cost solve). With `cache` (a file), the first call
    pickles their arrays there and later calls load them, so that runs
    in turns (other processes, other trees) time the same inputs: the
    planner's MIPs stop on wall-clock limits."""
    import pickle

    from karpenter_tpu_torch.solver import pack, solver as solver_mod
    from karpenter_tpu_torch.testing import (
        DenseCase, KernelCase, dense_case, existing_from_solution)
    from karpenter_tpu_torch.workloads import build_problem

    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            rows = pickle.load(f)
    else:
        calls, ctx = [], {"route": None, "planned": False}
        real_stage, real_sp = pack.stage, solver_mod._solve_packing
        real_async = solver_mod._solve_packing_async

        def stage(*a, **k):
            st = real_stage(*a, **k)
            calls.append((ctx["route"], ctx["planned"], st))
            return st

        def solve_packing(enc, mode, device, plan=None, shards=0, seam=real_sp):
            ctx["planned"] = plan is not None
            try:
                return seam(enc, mode, device, plan, shards)
            finally:
                ctx["planned"] = False

        def solve_packing_async(enc, mode, device, plan=None, shards=0):
            # the cold race's arms stage at their dispatch
            return solve_packing(enc, mode, device, plan, shards, seam=real_async)

        pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
        extra, _ = build_problem(N_EXTRA, N_TYPES, seed=SEED + 1, name_prefix="extra-")
        rpods, rpools = build_problem(COST_PODS, COST_TYPES, seed=SEED, reservations=True,
                                      zonal_frac=COST_ZONAL)
        pack.stage, solver_mod._solve_packing = stage, solve_packing
        solver_mod._solve_packing_async = solve_packing_async
        try:
            solver_mod.reset_caches()
            ctx["route"] = "first request"
            sol = solver_mod.solve(pods, pools)
            ctx["route"] = "second request"
            solver_mod.solve(extra, pools, existing_from_solution(sol))
            ctx["route"] = "reserved_50k cost arm"
            solver_mod.solve(rpods, rpools, objective="cost")
        finally:
            pack.stage, solver_mod._solve_packing = real_stage, real_sp
            solver_mod._solve_packing_async = real_async
            solver_mod.reset_caches()
        staged = {
            "first request": [st for r, _, st in calls if r == "first request"][-1],
            "second request": [st for r, _, st in calls if r == "second request"][-1],
            "reserved_50k cost arm": next(
                (st for r, planned, st in calls if r == "reserved_50k cost arm" and planned),
                None),
        }
        if staged["reserved_50k cost arm"] is None:
            fail("reserved_50k's cold cost solve staged no planned pack")
        rows = []
        for name in DENSE_PROBLEMS:
            mode = "cost" if name.startswith("reserved") else "ffd"
            c = dense_case(staged[name], name, mode)
            rows.append((name, c.args, c.kwargs, c.max_nodes, mode, c.Ep, c.split.args,
                         c.split.kwargs, c.split.max_free))
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(rows, f)
    return [DenseCase(name, args, kw, N, mode, Ep, KernelCase(name, s_args, s_kw, F, mode))
            for name, args, kw, N, mode, Ep, s_args, s_kw, F in rows]


def dense_timing(pd, kernels, graft_entry, cases, smi: str | None = None,
                 clocks: bool = True) -> dict:
    """B7's CUDA-event ms on `graft_entry.entry()`'s problem and on each
    full-width case (testing.DenseCase) beside B1's on the same problem,
    in turns (B7, B1, B1, B7; at each of B7's block sizes where the tree
    offers more than one: every size, B1 twice, the sizes in reverse),
    "B7 <problem>" the size the tree's rule takes, and the whole
    `pack_flat` call on the first case; with `clocks`, B7's phase clocks
    on `entry()` and the second and third cases at each size (where the
    tree has B7's phase-clock build). Returns {label: ms or text};
    prints the lines when `smi` (the card's line) is given."""
    import torch

    out = {}
    sizes = tuple(getattr(pd, "BLOCK_SIZES", (None,)))

    def at(size, fn):
        if size is None:
            return fn

        def run():
            with pd.forced_threads(size):
                return fn()
        return run

    def b7_label(name, size):
        return f"B7 {name}" + ("" if size is None else f" at {size} threads")

    fn, e_args = graft_entry.entry()
    runs = {"entry()": (lambda: fn(*e_args), None, graft_entry.MAX_NODES)}
    for c in cases:
        args, kw = to_cuda(c)
        s_args, s_kw = to_cuda(c.split)
        runs[c.name] = (
            lambda args=args, kw=kw, c=c: pd.pack(*args, max_nodes=c.max_nodes, mode=c.mode,
                                                  **kw),
            lambda s_args=s_args, s_kw=s_kw, c=c: kernels.pack_split(
                *s_args, max_free=c.split.max_free, mode=c.mode, **s_kw),
            c.max_nodes)
    for name, (b7, b1, N) in runs.items():
        reps = 50 if b1 is None else 3
        seq = [(size, at(size, b7)) for size in sizes]
        for _, f in seq:
            f()
        if b1 is not None:
            b1()
        torch.cuda.synchronize()
        first = {size: event_ms(f, reps) for size, f in seq}
        b1_ms = [event_ms(b1, reps), event_ms(b1, reps)] if b1 is not None else []
        last = {size: event_ms(f, reps) for size, f in reversed(seq)}
        for size in sizes:
            out[b7_label(name, size)] = (first[size] + last[size]) / 2
            out[b7_label(name, size) + " in turns"] = [first[size], last[size]]
        chosen = pd.block_threads(N) if hasattr(pd, "block_threads") else sizes[0]
        out[f"B7 {name}"] = out[b7_label(name, chosen)]
        if b1_ms:
            out[f"B1 {name}"] = sum(b1_ms) / 2
            out[f"B1 {name} in turns"] = b1_ms
        if smi is not None:
            b7_text = "; ".join(
                f"{'' if s is None else f'{s} threads '}{first[s]:.4f}, {last[s]:.4f}"
                for s in sizes)
            say(f"  {name} (N={N}): B7 {b7_text} ms" + (
                f", B1 {b1_ms[0]:.4f}, {b1_ms[1]:.4f} ms on the same problem" if b1_ms else "")
                + f" (in turns); the rule takes {chosen or 'its one size'}")
    c = cases[0]
    args, kw = to_cuda(c)
    flat = lambda: pd.pack_flat(*args, max_nodes=c.max_nodes, mode=c.mode, **kw)  # noqa: E731
    flat()
    out[f"pack_flat {c.name}"] = event_ms(flat, 5)
    out[f"pack_flat {c.name} as the host launches it"] = event_ms(flat, 5, queued=False)
    if smi is not None:
        say(f"  pack_flat's whole call on {c.name}: {out[f'pack_flat {c.name}']:.4f} ms on "
            f"the card, {out[f'pack_flat {c.name} as the host launches it']:.4f} ms as the "
            f"host launches it | card: {smi}")
    if clocks and "pack_dense" in kernels.PHASES and sizes[0] is not None:
        for name in ("entry()", *(c.name for c in cases[1:])):
            for size in sizes:
                text = phase_breakdown(kernels, "pack_dense", at(size, runs[name][0]),
                                       out[b7_label(name, size)], "step", threads=size)
                out[f"B7 {name} clocks at {size} threads"] = text
                if smi is not None:
                    say(f"  B7 phase clocks, {name} at {size} threads: {text}")
    return out


def bound(ops: int, nb: int):
    """(ms, "operations" or "bytes"): the least time the card could take
    for `ops` f32 operations and `nb` bytes moved."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nb / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def dense_phase(pd, kernels, graft_entry, cases: list, err: dict, smi: str) -> dict:
    """Phase 9 (and `--dense`): B7 on the card. The port's
    `graft_entry.entry()` (one launch of B7), then the dense ≡ split
    oracle at full width on `cases` (testing.DenseCase: the requests
    phases 4 and 6 staged), `pack` and `pack_flat` (B7 writing the flat
    buffer in place) byte for byte against their plain versions, then
    B7's times beside B1's on every problem, the whole `pack_flat` call
    and B7's phase clocks (`dense_timing`); returns the kernels' report
    entries and the launches."""
    import torch

    from karpenter_tpu_torch.testing import split_mismatch

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
    inputs = {c.name: to_cuda(c) for c in cases}
    pd.reset_launch_counts()
    outs, flats, rows = {}, {}, []
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
        outs[c.name], flats[c.name] = got, flat
        rows.append(f"{c.name} ({c.mode}, Gp={args[0].shape[0]} Cp={args[0].shape[1]} "
                    f"E={c.Ep} N={c.max_nodes}): nodes={int(got[4])} "
                    f"bound pods={int(got[0][:c.Ep].sum())} unsched={int(got[5].sum())}, "
                    f"{wall:.3f}s for B7, pack_flat and B1")
    torch.cuda.synchronize()
    launches["full width"] = dict(pd.LAUNCHES)
    n = launches["full width"]
    if n["pack"] != len(cases) or n["pack_flat"] != len(cases):
        fail(f"the full-width oracle launched {n}: expected B7 once for pack and once "
             f"for pack_flat (in place) per request")
    say(f"  full width, B7 equal to B1 on assignments, node counts, "
        f"unschedulable pods and free rows, bound rows one-hot, launches "
        f"{json.dumps(n)}:")
    for row in rows:
        say(f"    {row}")

    # ---- the plain version on each request (timed on the first): pack
    # and pack_flat byte for byte
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
        flat_ref = kernels.pack_flat_words_ref(want[0], want[1], want[4], want[5])
        if not same_bits(flats[c.name], flat_ref):
            fail(f"full width {c.name}: pack_flat differs from pack_flat_ref")
        err["pack_flat"] = max(err["pack_flat"], max_abs_diff(flats[c.name], flat_ref))
        if c is first:
            b7_plain_ms = plain_s * 1e3
    args, kw = inputs[first.name]
    N = first.max_nodes
    flat_plain_ms = event_ms(lambda: pd.pack_flat_ref(*args, max_nodes=N, mode=first.mode,
                                                      **kw), 1, queued=False)

    # ---- B7's times beside B1's, the whole pack_flat call, the clocks
    times = dense_timing(pd, kernels, graft_entry, cases, smi)
    b7_ms = times[f"B7 {first.name}"]
    flat_ms = times[f"pack_flat {first.name}"]
    o = outs[first.name]
    b7_op_count = b7_ops(pd, args, kw, N, first.mode)
    in_bytes = nbytes(list(args) + list(kw.values()))
    b7_bound, b7_by = bound(b7_op_count, in_bytes + nbytes(o))
    flat_bound, flat_by = bound(b7_op_count, in_bytes + nbytes([flats[first.name]]))
    say(f"  timing on {first.name} (Gp={args[0].shape[0]} Cp={args[0].shape[1]} "
        f"N={N} R={args[1].shape[1]}): B7 {b7_ms:.4f} ms at {pd.block_threads(N)} threads, plain "
        f"{b7_plain_ms:.1f} ms; ops={b7_op_count} bytes={in_bytes + nbytes(o)}, bound "
        f"{b7_bound:.6f} ms ({b7_by}); pack_flat {flat_ms:.4f} ms a call (its buffer's "
        f"fill and B7 in place), plain {flat_plain_ms:.1f} ms | card: {smi}")
    # the chain floor: the steps with demand x the least step's block
    # barriers x one barrier of the block alone, at the rule's size
    bar_us = {t: barrier_us(pd, t) for t in pd.BLOCK_SIZES}
    floors = []
    for name, counts, n in (("entry()", e_args[2], graft_entry.MAX_NODES),
                            *((c.name, inputs[c.name][0][2], c.max_nodes) for c in cases)):
        steps, t = int((counts > 0).sum()), pd.block_threads(n)
        floor_ms = steps * DENSE_BARRIERS_A_STEP * bar_us[t] / 1e3
        times[f"B7 {name} chain floor"] = floor_ms
        floors.append(f"{name} {steps} steps at {t} threads, {floor_ms:.6f} ms against "
                      f"{times[f'B7 {name}']:.6f} ms")
    say(f"  B7's chain floor ({DENSE_BARRIERS_A_STEP} block barriers a step; one barrier "
        f"alone {', '.join(f'{v:.4f} us at {t} threads' for t, v in bar_us.items())}): "
        + "; ".join(floors))
    say(f"  phase 9 took {time.perf_counter() - t_phase:.3f}s")
    return {"launches": launches, "times": times, "entries": [
        {"name": "pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_dense.cu",
         "replaces": "karpenter_tpu/solver/pack.py:164",
         "launches": sum(x["pack"] for x in launches.values()),
         "max_abs_err": err["pack"], "ms": b7_ms, "plain_ms": b7_plain_ms,
         "bound_ms": b7_bound, "bound_by": b7_by, "library_ms": None},
        {"name": "pack_flat", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_dense.cu",
         "replaces": "karpenter_tpu/solver/pack.py:410",
         "launches": sum(x["pack_flat"] for x in launches.values()),
         "max_abs_err": err["pack_flat"], "ms": flat_ms, "plain_ms": flat_plain_ms,
         "bound_ms": flat_bound, "bound_by": flat_by, "library_ms": None},
    ]}


def same_outputs(got, want) -> bool:
    return len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want))


# the plain lane outputs phase 3 computes on `lane_cases(0)`, keyed by
# (case, mode) and "seq" or a width: phase 8 holds the same cases
LANE_PLAIN: dict = {}


def lane_plain(kernels, name, args, kw, F, mode, width=None):
    key = (name, mode, "seq" if width is None else width)
    if key not in LANE_PLAIN:
        LANE_PLAIN[key] = (
            kernels.pack_probe_lanes_ref(*args, max_free=F, mode=mode, **kw) if width is None
            else kernels.pack_probe_lanes_wavefront_ref(*args, max_free=F, mode=mode,
                                                         width=width, **kw))
    return LANE_PLAIN[key]


def hold_lane_placements(kernels, name, args, kw, F, mode, err) -> str:
    """B6's sequential program (`LANE_THREADS` threads a block) all
    shared and spilled (the compat bits alone in global memory, and every
    segment there), and the lane flat route on both programs (the
    sequential one in place, then the mask epilogue) at L > 1 and L = 1
    (lane 0 alone), against the plain versions on the card; fail unless
    byte-identical."""
    import torch

    want = lane_plain(kernels, name, args, kw, F, mode)
    wf_want = lane_plain(kernels, name, args, kw, F, mode, 16)
    G, C = args[0].shape
    K = 0 if kw.get("rsv_cap") is None else kw["rsv_cap"].shape[0]
    lay = kernels.table_placement(C, args[1].shape[1], args[5].shape[0], K, G)
    placements = (("shared", None), ("compat bits spilled", lay["smem"] - 1),
                  ("all spilled", 0))
    for label, budget in placements:
        before = kernels.LAUNCHES["pack_probe_lanes_global"]
        with kernels.forced_budget(kernels.SMEM_BUDGET if budget is None else budget):
            got = kernels.pack_probe_lanes(*args, max_free=F, mode=mode, **kw)
        torch.cuda.synchronize()
        spilled = kernels.LAUNCHES["pack_probe_lanes_global"] - before
        if not same_outputs(got, want) or spilled != (budget is not None):
            fail(f"pack_probe_lanes ({label}) differs from pack_probe_lanes_ref on {name} "
                 f"({mode}), or spilled {spilled}x")
        err["pack_probe_lanes"] = max(err["pack_probe_lanes"],
                                      *(max_abs_diff(a, b) for a, b in zip(got, want)))
    # the flat routes: every lane, and lane 0 alone
    one = list(args)
    one[2], one[10] = args[2][:1].contiguous(), args[10][:1].contiguous()
    rows = {0: kernels.pack_flat_lanes_ref(*want),
            16: kernels.pack_flat_lanes_ref(*wf_want[:4], wf_want[5], wf_want[4])}
    for a, sl in ((args, slice(None)), (one, slice(0, 1))):
        for wf, ref in rows.items():
            got = kernels.pack_probe_lanes_flat(*a, max_free=F, mode=mode, wavefront=wf, **kw)
            torch.cuda.synchronize()
            if not same_outputs([got], [ref[sl]]):
                fail(f"pack_probe_lanes_flat (wavefront {wf}, L={a[2].shape[0]}) differs "
                     f"from pack_flat_lanes_ref of the plain outputs on {name} ({mode})")
            key = "pack_probe_lanes_flat" if wf else "pack_probe_lanes_flat_masks"
            err[key] = max(err[key], max_abs_diff(got, ref[sl]))
    return (f"  lanes {name} mode={mode} Lp={args[2].shape[0]} Gp={G} Cp={C} "
            f"B={args[7].shape[0]} F={F}: B6 sequential at {kernels.LANE_THREADS} threads x "
            f"{len(placements)} placements and the lane flat routes (both programs, "
            f"L={args[2].shape[0]} and 1) identical")


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
                "pack_probe_lanes_flat": 0.0,
                "pack_probe_lanes_flat_masks": 0.0})
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
        before = cb.probe_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
        stats[route] = cb.probe_counts(since=before)
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
        with b6_wavefront_shapes(kernels) as arm_c_shapes:
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
    b6 = ("pack_probe_lanes", "pack_probe_lanes_wavefront", "pack_probe_lanes_flat",
          "pack_probe_lanes_flat_masks")
    expect = {
        "arm (a)": ((), b6),
        "arm (c)": (("pack_probe_lanes_wavefront", "pack_probe_lanes_flat"),
                    ("pack_probe_lanes", "pack_probe_lanes_flat_masks")),
        "KARPENTER_WAVEFRONT=0": (("pack_probe_lanes", "pack_probe_lanes_flat_masks"),
                                  ("pack_probe_lanes_wavefront", "pack_split_wavefront",
                                   "pack_probe_lanes_flat")),
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
            # the plain outputs phase 3 computed on the same case, if it did
            plain = {w: LANE_PLAIN.get((case.name, mode, w)) for w in ("seq", *PROBE_WIDTHS)}
            say(hold_lanes(kernels, case.name, cargs, ckw, case.max_free, mode, err,
                           plain={w: v for w, v in plain.items() if v is not None}))
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
    seq_rows = kernels.pack_flat_lanes_ref(*seq_ref)
    if not same_outputs([flat_seq], [seq_rows]):
        fail("the first chunk's sequential flat route differs from pack_flat_lanes_ref")
    err["pack_probe_lanes_flat_masks"] = max(err["pack_probe_lanes_flat_masks"],
                                             max_abs_diff(flat_seq, seq_rows))
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
    say(hold_b6_shapes(kernels, arm_c_shapes, "arm (c)"))

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
    lanes = lane_route_timing(kernels, args, kw, F, mode, W, n_real, seq_ms, smi)
    # the lane epilogue as arm (c)'s wavefront route runs it: the full copy
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
    # the sequential route's epilogue in place moves the mask bytes and
    # words alone
    masks_bound = bound(out_wf[1].numel(), lanes["epilogue_bytes"])
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
        f"{kernels.ACTIVE_LANES.get('pack_probe_lanes_wavefront', 0)} lanes at once, {wf_mem} bytes "
        f"allocated, {shape_bytes} by the shapes); B6 sequential "
        f"{', '.join(f'{x:.4f}' for x in seq_runs)} ms ({seq_ms / n_real:.6f} "
        f"ms a lane, {kernels.LANE_THREADS} threads a block); lane "
        f"epilogue (the wavefront route's full copy) {flat_ms:.6f} ms ({flat_ms / n_real:.6f} "
        f"ms a lane; {flat_host_ms:.6f} ms a call as the host launches it; bound "
        f"{flat_bound[0]:.6f} ms), the sequential route's in place {lanes['epilogue_ms']:.6f} "
        f"ms ({lanes['epilogue_call_ms']:.6f} ms a call; bound {masks_bound[0]:.6f} ms) | "
        f"plain: wavefront {wf_plain_ms:.3f} ms, sequential {seq_plain_ms:.3f} ms, epilogue "
        f"{flat_plain_ms:.3f} ms | ops={ops} input bytes={in_bytes} | card: {smi}")
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
        {"name": "pack_probe_lanes_flat_masks", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/pack_flat.cu",
         "replaces": "karpenter_tpu/solver/pack.py:1292",
         "launches": n_b6["pack_probe_lanes_flat_masks"],
         "max_abs_err": err["pack_probe_lanes_flat_masks"], "ms": lanes["epilogue_ms"],
         "plain_ms": lanes["epilogue_plain_ms"], "bound_ms": masks_bound[0],
         "bound_by": masks_bound[1], "library_ms": None},
    ]}


def flat_filled(kernels, args, kw, F: int, mode: str, width: int = 0, lanes: bool = False):
    """A flat route's buffer filled as the route fills it, the packing
    kernel writing into its regions (B1; B3 at `width` > 1; with `lanes`
    B6 sequential), its mask words not yet packed: (buffer, layout)."""
    G, C = args[0].shape
    L = args[2].shape[0] if lanes else 1
    buf, lay = kernels.flat_buffer(L, args[7].shape[0] + F, G, F, C, width > 1, args[0].device)
    if lanes:
        kernels.pack_probe_lanes(*args, max_free=F, mode=mode, flat=(buf, lay), **kw)
    elif width > 1:
        kernels.pack_split_wavefront(*args, max_free=F, mode=mode, width=width,
                                     flat=(buf, lay), **kw)
    else:
        kernels.pack_split(*args, max_free=F, mode=mode, flat=(buf, lay), **kw)
    return buf, lay


def lane_route_timing(kernels, args, kw, F: int, mode: str, W: int, n_real: int,
                      seq_ms: float, smi: str) -> dict:
    """Phase 8's B6 sequential and lane flat routes on the first chunk:
    lane 0 and the lane with the most demand alone, their phase clocks;
    the whole `pack_probe_lanes_flat` call on both programs; the
    sequential route's lane epilogue in place (its kernel, its call, its
    plain version; the wavefront route's is the full copy, timed by the
    caller)."""
    import torch

    C = args[0].shape[1]
    B = args[7].shape[0]
    L = args[2].shape[0]
    N = B + F
    one = list(args)
    one[2], one[10] = args[2][:1].contiguous(), args[10][:1].contiguous()

    def seq(a=args):
        return kernels.pack_probe_lanes(*a, max_free=F, mode=mode, **kw)

    seq()
    threads = kernels.LANE_THREADS
    placed = kernels.DYNAMIC_SMEM["pack_probe_lanes"]
    alone_ms = event_ms(lambda: seq(one), 10)
    # the lane with the most demand, alone: the dispatch's floor
    heavy = int(args[2].to(torch.int64).sum(dim=1).argmax())
    top = list(args)
    top[2], top[10] = args[2][heavy:heavy + 1].contiguous(), args[10][heavy:heavy + 1].contiguous()
    heavy_ms = event_ms(lambda: seq(top), 10)
    clocks = phase_breakdown(kernels, "pack_split", seq, seq_ms, "step", threads=threads)
    heavy_clocks = phase_breakdown(kernels, "pack_split", lambda: seq(top), heavy_ms, "step",
                                   threads=threads)
    whole = {}
    for label, wf in (("sequential", 0), ("wavefront", W)):
        fn = lambda wf=wf: kernels.pack_probe_lanes_flat(  # noqa: E731
            *args, max_free=F, mode=mode, wavefront=wf, **kw)
        whole[label] = (event_ms(fn, 5), event_ms(fn, 5, queued=False))
    rows = kernels.pack_probe_lanes_flat(*args, max_free=F, mode=mode, **kw)
    buf, lay = flat_filled(kernels, args, kw, F, mode, lanes=True)
    ep = lambda: kernels.flat_masks(buf, lay, "pack_probe_lanes_flat_masks")  # noqa: E731
    ep()
    if not torch.equal(kernels.flat_views(buf, lay)[0], rows):
        fail("the chunk's sequential buffer differs from pack_probe_lanes_flat's rows")
    ep_ms = event_ms(ep, 50)
    ep_call_ms = event_ms(ep, 50, queued=False)
    ep_plain_ms = event_ms(lambda: kernels.pack_flat_masks_ref(buf, lay), 5, queued=False)
    say(f"  B6 sequential on the first chunk (L={L}, {n_real} real, rows B+F={N}): "
        f"{threads} threads a block ({placed}); lane 0 alone {alone_ms:.4f} ms, lane "
        f"{heavy} (the most demand) alone {heavy_ms:.4f} ms | lane 0's phase clocks: "
        f"{clocks} | lane {heavy} alone, its phase clocks: {heavy_clocks} | card: {smi}")
    say(f"  lane flat routes (pack_probe_lanes_flat, whole call): sequential "
        f"{whole['sequential'][0]:.6f} ms on the card, {whole['sequential'][1]:.6f} ms as the "
        f"host launches it; wavefront {whole['wavefront'][0]:.6f} ms, "
        f"{whole['wavefront'][1]:.6f} ms | the sequential route's lane epilogue in place "
        f"({lay['L']} x {F} x {C // 32} words): {ep_ms:.6f} ms on the card, {ep_call_ms:.6f} ms "
        f"a call as the host launches it, plain {ep_plain_ms:.6f} ms | card: {smi}")
    return {"alone_ms": alone_ms, "heavy_ms": heavy_ms,
            "clocks": clocks, "heavy_clocks": heavy_clocks,
            "whole": whole, "epilogue_ms": ep_ms, "epilogue_call_ms": ep_call_ms,
            "epilogue_plain_ms": ep_plain_ms,
            "epilogue_bytes": L * F * C + 4 * L * F * (C // 32)}


SHARDS = (2, 3, 4, 8)
# the seeded kernel_cases held split at each S (fresh-cost,
# reservations-ffd, bound-quota-cap-conflict-ffd, conflict-cost); at S = 3
# and 8 only the two ffd ones, a depth cut for phase 18's time
SPLIT_SEEDED = {2: (1, 2, 4, 7), 4: (1, 2, 4, 7), 3: (2, 4), 8: (2, 4)}
TIMED_SHARDS = (2, 4, 8)
LP_SHARDS = 4
# split B5's seeded holds: iterations (192 before phase 18 came; the
# KARPENTER_LP_SHARDS route below holds it at the ascent's 192 on
# reserved_50k's LP)
SPLIT_ASCENT_ITERS = 64
MILLION = (1_000_000, 100, 400)
MILLION_SHARDS = 8
# `--quick`: split B1 and B3 timed at this S on the first request
QUICK_SHARDS = 4


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
        ascent_cases, fold_cases, kernel_cases, root_node_mips, tie_case)
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
        for case in [cases[i] for i in SPLIT_SEEDED[S]] + [
                tie_case(21, S, "cost"), tie_case(22, S, "ffd", quota=True)] + fold_cases(3, S):
            say(hold_split(shard, kernels, case, S, err))
            held += 1
    for S in (2, LP_SHARDS):
        for name, inputs in ascent_cases(0, S):
            a = lp_device.ShardedAscentInputs.split(inputs.to("cuda"), S, ["cuda"] * S)
            got = lp_device.ascend_sharded(a, SPLIT_ASCENT_ITERS)
            want = lp_device.ascend_sharded_ref(a, SPLIT_ASCENT_ITERS)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                if not all(same_bits(x[0], x[r]) for r in range(S)):
                    fail(f"lp_ascend_sharded: replicas differ on {name} at S={S}")
                if not same_bits(x, y):
                    fail(f"lp_ascend_sharded differs from its plain version on {name} "
                         f"at S={S}")
                err["lp_ascend_sharded"] = max(err["lp_ascend_sharded"], max_abs_diff(x, y))
    say(f"phase 10 sharded: split B1, B3 (widths 8, 16) and B2 byte-identical to their "
        f"plain split versions and to the unsplit kernels on {held} problems over S in "
        f"{SHARDS} ({json.dumps({S: len(v) for S, v in SPLIT_SEEDED.items()})} seeded, the "
        f"rest tie and fold cases at each S), replicas equal; split B5 on "
        f"{len(ascent_cases(0))} ascent cases at "
        f"S in (2, {LP_SHARDS}), {SPLIT_ASCENT_ITERS} iterations, bit-identical "
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
    for mode in ("ffd", "cost"):
        census_runs(kernels, pack, shard, renc, LP_SHARDS, mode, "reserved_50k")
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
        # each split packing kernel's phases and exchange census
        for lib, split, unit in (("pack_split", "pack_split_sharded", "step"),
                                 ("pack_wavefront", "pack_split_wavefront_sharded", "round")):
            s1, s2, _, _ = times[(split, S)]
            say(f"  {split} S={S} phase clocks: "
                f"{phase_breakdown(kernels, lib, runs[split], (s1 + s2) / 2, unit)}")
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


def phase_breakdown(kernels, lib: str, run, ms: float, unit: str, threads: int = 1024) -> str:
    """One run of `run` with library `lib`'s phase-clock build swapped
    in: each phase's share of block 0's cycles, and the time a step or
    round from the CUDA-event time `ms` of the normal build (block 0 of
    `threads` threads)."""
    with kernels.phase_clocks(lib) as take:
        run()
        clk = take()
    n = clk.pop("count")
    spreads = clk.pop("spreads")
    exchanges = clk.pop("exchanges")
    ns = clk.pop("ns")
    total = sum(clk.values())
    if not n or not total:
        fail(f"{lib}: the phase-clock build counted {n} {unit}s, {total} cycles")
    shares = ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in clk.items())
    # the slowest thread against the mean over the block's threads
    spread = ", ".join(f"{k} {hi / n:.1f} (mean {tot / n / threads:.1f})"
                       for k, (hi, tot) in spreads.items())
    text = (f"{n} {unit}s, {1000 * ms / n:.3f} us a {unit} (CUDA events), "
            f"{total / n:.0f} cycles a {unit} on block 0 at {1000 * total / max(ns, 1):.0f} "
            f"MHz (its cycles over the global timer's ns) | {shares} | a {unit}'s slowest "
            f"thread: {spread}")
    if any(c for c, _, _ in exchanges.values()):
        text += f" | exchange census a launch: {census(exchanges, n, unit)}"
    return text


def census(exchanges: dict, n: int, unit: str) -> str:
    """A split launch's exchange census (block 0's thread 0: shard 0,
    lane 0): each kind's exchanges in the launch and per step or round,
    the mean cycles one took (its wait for the slowest shard included)
    and the block barriers one took; the opens made, and the exchanges
    an open."""
    ex = dict(exchanges)
    opens = ex.pop("opens made", (0, 0, 0))[0]
    parts = [f"{k} {c} ({c / n:.2f} a {unit}), {cyc / c:.0f} cycles each, "
             f"{bars / c:.1f} block barriers each"
             for k, (c, cyc, bars) in ex.items() if c]
    if opens:
        # each open takes one fold exchange (and ffd with reserved columns
        # one reserved key); the other fold exchanges end a loop with
        # demand left (no pool can open, or the node axis is full)
        per_open = (opens + ex["reserved key"][0]) / opens
        parts.append(f"opens made {opens}: {per_open:.2f} exchanges an open, "
                     f"{ex['open'][0] - opens} more ending a loop with demand left")
    return "; ".join(parts)


def census_runs(kernels, pack, shard, enc, S: int, mode: str, label: str) -> None:
    """One launch each of split B1 and split B3 from their phase-clock
    builds on `enc` staged at S shards in `mode` (the virtual mesh must
    hold S slots), with the reservation slots the encode carries: their
    phases and exchange census (an open's exchanges by mode: one in cost
    mode and in ffd without reserved columns, two in ffd with them)."""
    import torch

    mask, used, quota = pack._bound_rows(enc)
    N = pack.node_axis(enc, mode)
    W = pack.wavefront_width(torch.device("cuda"))
    st = pack.stage(enc, mask, used, N, quota, shards=S)
    sargs, skw = pack.to_mesh(st, enc, pack._mesh(S, "cuda"), stream=False)
    F = st.max_free
    K = 0 if skw.get("rsv_cap") is None else int(skw["rsv_cap"].shape[0])
    b1 = lambda: shard.pack_split_sharded(*sargs, max_free=F, mode=mode, **skw)  # noqa: E731
    b3 = lambda: shard.pack_split_wavefront_sharded(  # noqa: E731
        *sargs, max_free=F, mode=mode, width=W, **skw)
    for lib, run, unit, name in (("pack_split", b1, "step", "split B1"),
                                 ("pack_wavefront", b3, "round", "split B3")):
        ms = event_ms(run, 3)
        say(f"  census {name} S={S} {label} ({mode}, K={K}): "
            f"{phase_breakdown(kernels, lib, run, ms, unit)}")


def split_timing(kernels, pack, shard, enc, S: int, err: dict, smi: str) -> dict:
    """Split B1 and split B3 at S shards on `enc` (the first request),
    staged as the split route stages it (the virtual mesh must hold S
    slots): each held once against its plain split version, then timed
    in turns with its unsplit kernel on the same padded problem
    (unsplit, split, split, unsplit), and run once from its phase-clock
    build (phases and exchange census). Returns {wrapper: (split ms,
    split ms, unsplit ms, unsplit ms)}."""
    import torch

    mask, used, quota = pack._bound_rows(enc)
    N = pack.node_axis(enc, "ffd")
    W = pack.wavefront_width(torch.device("cuda"))
    st = pack.stage(enc, mask, used, N, quota, shards=S)
    sargs, skw = pack.to_mesh(st, enc, pack._mesh(S, "cuda"), stream=False)
    fargs, fkw = pack.to_device(st, torch.device("cuda"))
    F = st.max_free
    runs = {
        "pack_split": lambda: kernels.pack_split(*fargs, max_free=F, mode="ffd", **fkw),
        "pack_split_sharded": lambda: shard.pack_split_sharded(
            *sargs, max_free=F, mode="ffd", **skw),
        "pack_split_wavefront": lambda: kernels.pack_split_wavefront(
            *fargs, max_free=F, mode="ffd", width=W, **fkw),
        "pack_split_wavefront_sharded": lambda: shard.pack_split_wavefront_sharded(
            *sargs, max_free=F, mode="ffd", width=W, **skw),
    }
    for k in SPLIT_WRAPPERS:
        err.setdefault(k, 0.0)
    rec = SplitLaunches(shard)
    try:
        runs["pack_split_sharded"]()
        runs["pack_split_wavefront_sharded"]()
    finally:
        rec.close()
    hold_launches(shard, f"first request at S={S}", rec, err)
    times = {}
    for plain, split in (("pack_split", "pack_split_sharded"),
                         ("pack_split_wavefront", "pack_split_wavefront_sharded")):
        seq = [event_ms(runs[plain], 10), event_ms(runs[split], 10),
               event_ms(runs[split], 10), event_ms(runs[plain], 10)]
        times[split] = (seq[1], seq[2], seq[0], seq[3])
    b1 = phase_breakdown(kernels, "pack_split", runs["pack_split_sharded"],
                         sum(times["pack_split_sharded"][:2]) / 2, "step")
    b3 = phase_breakdown(kernels, "pack_wavefront", runs["pack_split_wavefront_sharded"],
                         sum(times["pack_split_wavefront_sharded"][:2]) / 2, "round")
    for split, (s1, s2, u1, u2) in times.items():
        say(f"  split timing {split} S={S} (Cs={sargs[0][0].shape[1]}, W={W}): split "
            f"{s1:.4f}, {s2:.4f} ms; unsplit {u1:.4f}, {u2:.4f} ms (in turns: unsplit, "
            f"split, split, unsplit); held byte-identical to the plain split version | "
            f"card: {smi}")
    say(f"  split B1 S={S} phase clocks: {b1}")
    say(f"  split B3 S={S} phase clocks: {b3}")
    return times


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
    # B2's full copy on B3's outputs, stats appended (the standalone
    # pack_flat_words; B7's epilogue is the same kernel)
    b2_in = (*out3[:4], out3[5], out3[4])
    copy_ms = event_ms(lambda: kernels.pack_flat_words(*b2_in), 50)
    copy_host_ms = event_ms(lambda: kernels.pack_flat_words(*b2_in), 50, queued=False)
    copy_plain_ms = event_ms(lambda: kernels.pack_flat_words_ref(*b2_in), 20,
                             queued=False)
    # the flat routes as the main path runs them: the whole call on the B1
    # and B3 routes, and B2 as it runs there, the mask epilogue on the B3
    # route's buffer
    flat = flat_route_timing(kernels, args, kw, F, W, smi)

    Gp, Cp = args[0].shape
    R = args[1].shape[1]
    # B3 computes B1's function: the work its inputs need is B1's
    b1_op_count = b1_ops(kernels, args, kw, F)
    in_bytes = nbytes(list(args) + list(kw.values()))
    b1_bytes = in_bytes + nbytes(out1)
    b3_bytes = in_bytes + nbytes(out3)
    copy = kernels.pack_flat_words(*b2_in)
    copy_bytes = nbytes(b2_in) + nbytes([copy])
    b2_op_count = out3[1].numel()

    b1_bound, b1_by = bound(b1_op_count, b1_bytes)
    b3_bound, b3_by = bound(b1_op_count, b3_bytes)
    # B2 on the main path moves the mask bytes and words; the whole row's
    # old work (the full copy) beside it
    b2_bound, b2_by = bound(b2_op_count, flat["epilogue_bytes"])
    copy_bound, _ = bound(b2_op_count, copy_bytes)
    say(f"phase 5 timing on {case.name} (Gp={Gp} Cp={Cp} B={B} F={F} R={R}, W={W}): "
        f"B1 {', '.join(f'{x:.4f}' for x in b1_runs)} ms; B3 "
        f"{', '.join(f'{x:.4f}' for x in b3_runs)} ms, {int(out3[4])} rounds, widths "
        f"{histogram(out3[5][:int(out3[4])])}; B1/B3 ops={b1_op_count} "
        f"B1 bytes={b1_bytes} B3 bytes={b3_bytes}; B2 (the mask epilogue in place) "
        f"{flat['epilogue_ms']:.6f} ms on the card, {flat['epilogue_call_ms']:.6f} ms a call "
        f"as the host launches it, ops={b2_op_count} bytes={flat['epilogue_bytes']} (bound "
        f"{b2_bound:.6f} ms), plain {flat['epilogue_plain_ms']:.6f} ms; the full copy "
        f"{copy_ms:.6f} ms on the card, {copy_host_ms:.6f} ms a call, bytes={copy_bytes} (bound "
        f"{copy_bound:.6f} ms), plain {copy_plain_ms:.6f} ms | card: {smi}")
    say(f"  placement a block: B1 {smem['pack_split']}; B3 {smem['pack_split_wavefront']}")
    say(f"  B1 phase clocks: {b1_clocks}")
    say(f"  B3 phase clocks: {b3_clocks}")
    return {"b1_ms": b1_ms, "b1_plain_ms": b1_plain_ms, "b1_bound": b1_bound,
            "b1_by": b1_by, "b3_ms": b3_ms, "b3_plain_ms": b3_plain_ms,
            "b3_bound": b3_bound, "b3_by": b3_by, "b2_ms": flat["epilogue_ms"],
            "b2_plain_ms": flat["epilogue_plain_ms"], "b2_bound": b2_bound, "b2_by": b2_by}


def host_us(fn, reps: int) -> float:
    """The host's us a call of `fn`, by the host clock, the card's queue
    drained before and after (the calls enqueue their kernels and
    return)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def flat_route_timing(kernels, args, kw, F: int, W: int, smi: str) -> dict:
    """Phase 5's flat routes on the warm first request's inputs: the
    whole `pack_split_flat` call on the B1 and B3 routes (CUDA events,
    queued: the card's work; and as the host launches it), the B3
    route's buffer once filled, then B2 as the main path runs it (the
    mask epilogue in place): its kernel, its call, its plain version, and
    the host's part of each piece of the route by the host clock."""
    import torch

    G, C = args[0].shape
    B = args[7].shape[0]
    N = B + F
    routes = {
        "B1": lambda: kernels.pack_split_flat(*args, max_free=F, mode="ffd", **kw),
        "B3": lambda: kernels.pack_split_flat(*args, max_free=F, mode="ffd", wavefront=W, **kw),
    }
    whole = {k: (event_ms(fn, 10), event_ms(fn, 10, queued=False)) for k, fn in routes.items()}
    row = routes["B3"]()
    buf, lay = flat_filled(kernels, args, kw, F, "ffd", W)
    ep = lambda: kernels.flat_masks(buf, lay)  # noqa: E731
    ep()
    if not torch.equal(kernels.flat_views(buf, lay)[0][0], row):
        fail("the B3 route's buffer differs from pack_split_flat's row")
    ep_ms = event_ms(ep, 50)
    ep_call_ms = event_ms(ep, 50, queued=False)
    ep_plain_ms = event_ms(lambda: kernels.pack_flat_masks_ref(buf, lay), 20, queued=False)
    host = {"buffer": host_us(lambda: kernels.flat_buffer(1, N, G, F, C, True, args[0].device),
                              200),
            "epilogue": host_us(ep, 200),
            "whole B3 route": host_us(routes["B3"], 10)}
    ep_bytes = F * C + 4 * F * (C // 32)
    say(f"  flat routes (pack_split_flat, whole call: the buffer's fill, the packing kernel "
        f"in place, the epilogue): B1 route {whole['B1'][0]:.6f} ms on the card, "
        f"{whole['B1'][1]:.6f} ms as the host launches it; B3 route {whole['B3'][0]:.6f} ms, "
        f"{whole['B3'][1]:.6f} ms | B2 (mask epilogue, F={F} C={C}, {lay['F'] * C // 32} "
        f"words): {ep_ms:.6f} ms on the card, {ep_call_ms:.6f} ms a call as the host "
        f"launches it, plain "
        f"{ep_plain_ms:.6f} ms | host clock, us a call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f" | card: {smi}")
    return {"whole": whole, "epilogue_ms": ep_ms, "epilogue_call_ms": ep_call_ms,
            "epilogue_plain_ms": ep_plain_ms, "epilogue_bytes": ep_bytes, "host_us": host}


def ascent_clocks(kernels, lp_device, a, n_iters: int, ms: float) -> tuple[str, int, int]:
    """One run of B5 from its phase-clock build: each phase's share of
    block 0's cycles, the us an iteration from the CUDA-event time `ms`
    of the normal build, and the block and cluster barriers of the launch
    (block 0's; returned with the text)."""
    with kernels.phase_clocks("lp_ascend") as take:
        lp_device.ascend(a, n_iters)
        clk = take()
    n = clk.pop("count")
    barriers = clk.pop("barriers")
    cbarriers = clk.pop("cluster barriers", 0)
    cregions = clk.pop("cluster regions", {})
    regions = clk.pop("regions")
    clk.pop("ns")
    total = sum(clk.values())
    if not n or not total:
        fail(f"lp_ascend: the phase-clock build counted {n} iterations, {total} cycles")
    ranked = sorted(clk.items(), key=lambda kv: -kv[1])
    shares = ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in ranked if v)
    inside = ", ".join(f"{k} {v / n:.0f}" for k, v in regions.items())
    return (f"{n} iterations, {1000 * ms / n:.3f} us an iteration (CUDA events), "
            f"{total / n:.0f} cycles an iteration on block 0, {barriers} block barriers "
            f"({barriers / n:.1f} an iteration), {cbarriers} cluster barriers "
            f"({cbarriers / n:.1f} an iteration) | {shares} | regions inside the phases, "
            f"cycles an iteration on the thread that runs each: {inside}"
            + (" | the cluster's d ratio pass, cycles an iteration on block 0's thread 0: "
               + ", ".join(f"{k} {v / n:.0f}" for k, v in cregions.items()) if cbarriers else "")
            ), barriers, cbarriers


def ascent_floor(lp_device, a, barriers: int, cbarriers: int) -> tuple[str, float]:
    """The floor of B5's chain of barriers on `a`: its block barriers
    times one block barrier alone (`lp_device.barrier_probe`), and its
    wide layout's cluster barriers times one barrier of a cluster of its
    size (`cluster_barrier_probe`, where the tree has it). Returns the
    text and the ms."""
    probe = lambda fn: 1000 * (event_ms(lambda: fn(BARRIER_PROBE), 5)  # noqa: E731
                               - event_ms(lambda: fn(0), 5)) / BARRIER_PROBE
    per = probe(lp_device.barrier_probe)
    ms = barriers * per / 1000
    text = f"{barriers} block barriers x {per:.4f} us (one barrier of the block alone)"
    S = getattr(lp_device, "ascent_cluster", lambda G, C: 0)(*a.compat.shape)
    if S and cbarriers:
        cper = probe(lambda n: lp_device.cluster_barrier_probe(n, S))
        ms += cbarriers * cper / 1000
        text += f" + {cbarriers} cluster barriers x {cper:.4f} us (a cluster of {S} alone)"
    return f"{text} = {ms:.6f} ms floor", ms


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
    text, barriers, cbarriers = ascent_clocks(kernels, lp_device, a, n_iters, ms)
    say(f"  B5 phase clocks on {name}: {text}")
    say(f"  B5's chain of barriers on {name}: "
        f"{ascent_floor(lp_device, a, barriers, cbarriers)[0]}, against {ms:.6f} ms")
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
                 smi: str, kind: str, lp_device, encode, group_pods,
                 split_only: bool = False) -> None:
    """`--quick`: after phases 1-3, stage the warm first request (a cold
    and a warm solve on the card), hold B1, B3 and B2 on it, and run
    phase 5 alone; split B1 and B3 on it at S=4 (`split_timing`) and
    their exchange census (`census_runs`, also in cost mode and on
    reserved_50k in both modes); then B5's times and phase clocks on
    reserved_50k's LP. `--split`: after phases 1-2, the split part alone,
    split_timing at each S of TIMED_SHARDS."""
    import torch

    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    real_stage = pack.stage
    staged = []
    encs = []

    def recording_stage(*a, **k):
        staged.append(real_stage(*a, **k))
        encs.append(a[0])
        return staged[-1]

    pack.stage = recording_stage
    try:
        solve(pods, pools)
        solve(pods, pools)
        torch.cuda.synchronize()
    finally:
        pack.stage = real_stage
    st = staged[-1]
    if not split_only:
        case = KernelCase("main-path-first-warm", st.args, st.kwargs, st.max_free, "ffd", st)
        say(hold(kernels, case, err))
        timing_phase(kernels, pack, case, smi)
    from karpenter_tpu_torch.solver import pack_shard
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh

    rpods, rpools = build_problem(COST_PODS, COST_TYPES, seed=SEED, reservations=True,
                                  zonal_frac=COST_ZONAL)
    renc = encode(group_pods(rpods), rpools)
    shards = TIMED_SHARDS if split_only else (QUICK_SHARDS,)
    force_virtual_mesh(max(shards))
    try:
        for S in shards:
            split_timing(kernels, pack, pack_shard, encs[-1], S, err, smi)
        census_runs(kernels, pack, pack_shard, encs[-1], QUICK_SHARDS, "cost", "first request")
        for mode in ("ffd", "cost"):
            census_runs(kernels, pack, pack_shard, renc, QUICK_SHARDS, mode, "reserved_50k")
    finally:
        force_virtual_mesh(0)
    if not split_only:
        a, n_iters = reserved_ascent(lp_device, build_problem, encode, group_pods)
        ascent_timing(kernels, lp_device, "reserved_50k's LP", a, n_iters, err, smi)
    served = served_by_device(SPLIT if split_only else QUICK)
    say(f"ladder: every packing solve served by the device or sharded rung "
        f"({json.dumps(served)} ok), none degraded, no device LP degraded")
    say(f"chip_smoke {SPLIT if split_only else QUICK}: "
        f"{time.perf_counter() - T_START:.3f}s wall")
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# phase 11: aws_catalog_50k (`workloads.aws_catalog_50k`): the catalog's
# types, the split hold's (4,800 configs at S = CATALOG_S), the B6 lanes
# on it, and the node pools of the many-pools holds; `--catalog` runs
# phases 1-2 and 11 alone
CATALOG_TYPES, CATALOG_SPLIT_TYPES, CATALOG_S = 800, 1600, 2
CATALOG_LANES = 3
# the wave of pods pending while the catalog's fleet consolidates
CATALOG_WAVE = 5_000
MANY_POOLS = 80
CATALOG = "--catalog"
# `--lanes`: phases 1-2, then the holds of B6 sequential at each block
# size and of the in-place flat routes alone
LANES = "--lanes"
# `--against DIR`: phases 1-2, then `compare_timings` in DIR (a checkout
# of another commit, e.g. the parent) and here, in turns
AGAINST = "--against"
# `--b5-against DIR`: phases 1-2, then `b5_timings` in the checkout DIR
# and here, in turns (`b5_against`)
B5_AGAINST = "--b5-against"
# `--b6-against DIR`: phases 1-2, then `b6_timings` in the checkout DIR
# and here, in turns
B6_AGAINST = "--b6-against"
# the timed launches of a B5 shape in `b5_timings`: 3 x this many
B5_TURN_REPS = {"reserved_50k's LP": 20, "the 4096-config bucket shape": 5,
                "aws_catalog_50k's LP": 5}


def b5_timings() -> None:
    """B5 through a tree's own public wrappers, printed as one JSON line
    (`b5_against` runs it in each tree in turns, each turn a fresh process
    from that tree's root, its package first on sys.path, building its
    libraries on first use): reserved_50k's LP staged from its encode (the
    2048 layout), the warm pool's 4096-config bucket shape
    (`ascent_wide_cases`' 243 x 4438) and aws_catalog_50k's LP (the wide
    layout), the ascent's iterations each, three timings of
    `B5_TURN_REPS` launches; the wide shapes' phase clocks and the floor
    of their chain of barriers (`ascent_floor`)."""
    import torch

    from karpenter_tpu_torch import cuda_build

    from karpenter_tpu_torch.solver import lp_device
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.testing import ascent_wide_cases
    from karpenter_tpu_torch.workloads import aws_catalog_50k, build_problem

    cuda_build.build_all()
    n = lp_device.iters()
    pods, pools = build_problem(COST_PODS, COST_TYPES, seed=SEED, reservations=True,
                                zonal_frac=COST_ZONAL)
    (_, bucket), = ascent_wide_cases(0, names=("wide-c4438-g243",))
    cpods, cpools = aws_catalog_50k(CATALOG_TYPES)
    shapes = {
        "reserved_50k's LP": lp_device.ascent_inputs(
            lp_device._stage(encode(group_pods(pods), pools))),
        "the 4096-config bucket shape": bucket,
        "aws_catalog_50k's LP": lp_device.ascent_inputs(
            lp_device._stage(encode(group_pods(cpods), cpools))),
    }
    out = {}
    for name, a in shapes.items():
        a = a.to("cuda")
        lp_device.ascend(a, n)
        torch.cuda.synchronize()
        ms = [event_ms(lambda: lp_device.ascend(a, n), B5_TURN_REPS[name]) for _ in range(3)]
        out[f"B5 {name}"] = ms
        Gp, Cp = a.compat.shape
        out[f"B5 {name} shape"] = (f"Gp={Gp} Cp={Cp} R={a.req.shape[1]} Kp={a.onehot.shape[0]}, "
                                   f"{n} iterations; {lp_device.ASCENT_SMEM.get('lp_ascend')}")
        if lp_device.ascent_wide(Gp, Cp):
            text, barriers, cbarriers = ascent_clocks(kernels, lp_device, a, n,
                                                      statistics.mean(ms))
            out[f"B5 {name} clocks"] = text
            out[f"B5 {name} chain floor"] = ascent_floor(lp_device, a, barriers, cbarriers)[0]
    print(json.dumps(out), flush=True)


def b6_timings() -> None:
    """B6's wavefront program through a tree's own public wrappers,
    printed as one JSON line (`--b6-against` runs it in each tree in
    turns, as `b5_against` does): phase 8's first chunk (`first_chunk`),
    three timings of 10 dispatches, lane 0 alone, the lanes on the card at
    once, each phase's share of a round on block 0 (lane 0) from the
    phase-clock build and the chain floor (the rounds' barriers x one
    barrier of the kind they take); `lane_cases(0)`'s first case at 10 and
    64 lanes; B6 sequential on the chunk beside it."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import cuda_build

    from karpenter_tpu_torch.solver import consolidation_batch as cb
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.testing import lane_cases

    cuda_build.build_all()
    out = {}
    args, kw, F, mode, W, n_real = first_chunk(kernels, cb)
    one = list(args)
    one[2], one[10] = args[2][:1].contiguous(), args[10][:1].contiguous()
    wf = lambda a=args: kernels.pack_probe_lanes_wavefront(  # noqa: E731
        *a, max_free=F, mode=mode, width=W, **kw)
    seq = lambda: kernels.pack_probe_lanes(*args, max_free=F, mode=mode, **kw)  # noqa: E731
    got = wf()
    torch.cuda.synchronize()
    out["B6 wavefront chunk"] = [event_ms(wf, 10) for _ in range(3)]
    wf(one)
    out["B6 wavefront chunk lane 0 alone"] = event_ms(lambda: wf(one), 10)
    seq()
    out["B6 sequential chunk"] = event_ms(seq, 10)
    Gp, Cp = args[0].shape
    out["B6 wavefront chunk shape"] = (
        f"L={args[2].shape[0]} ({n_real} real) Gp={Gp} Cp={Cp} B={args[7].shape[0]} F={F} "
        f"W={W}, rounds {got[4].tolist()}; {kernels.DYNAMIC_SMEM.get('pack_probe_lanes_wavefront')}"
        f"; at once: clusters of {W} {getattr(kernels, 'ACTIVE_CLUSTERS', {}).get(W)} (a "
        f"cluster a lane), lanes "
        f"{getattr(kernels, 'ACTIVE_LANES', {}).get('pack_probe_lanes_wavefront')} (a block a lane)")
    # the plans of a design that plans a round's candidates in lane order up
    # to the first rejected, against W a round
    plans = 0
    for lane in range(args[2].shape[0]):
        left = int((args[2][lane] > 0).sum())
        for w in got[5][lane][:int(got[4][lane])].tolist():
            plans += min(w + 1, left, W)
            left -= w
    out["B6 wavefront chunk plans made"] = (
        f"{int(got[5].sum())} groups committed in {int(got[4].sum())} rounds over "
        f"{args[2].shape[0]} lanes: {plans} plans in lane order up to the first rejected, "
        f"against {W * int(got[4].sum())} at W={W} plans a round")
    ms = statistics.mean(out["B6 wavefront chunk"])
    out["B6 wavefront chunk clocks"] = phase_breakdown(kernels, "pack_wavefront", wf, ms,
                                                       "round")
    probe = getattr(kernels, "wave_barrier_probe", None)
    if probe is not None:
        # lane 0's plans: a round plans its candidates in lane order up to
        # the first rejected (at most W, at most the groups left)
        left, plans = int((args[2][0] > 0).sum()), 0
        for w in got[5][0][:int(got[4][0])].tolist():
            plans += min(w + 1, left, W)
            left -= w
        t0 = event_ms(lambda: probe(0), 5)
        t1 = event_ms(lambda: probe(BARRIER_PROBE), 5)
        per = 1000 * (t1 - t0) / BARRIER_PROBE
        bars = 3 * int(got[4][0]) + 7 * plans
        out["B6 wavefront chunk chain floor"] = (
            f"lane 0: {int(got[4][0])} rounds, {plans} plans; at least {bars} block barriers "
            f"(3 a round, 7 a plan besides its opens) x {per:.4f} us = "
            f"{bars * per / 1000:.6f} ms")
    for n_lanes in (10, 64):
        lc = lane_cases(0, n_lanes=n_lanes)[0]
        largs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in lc.args]
        lkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in lc.kwargs.items()}
        fn = lambda: kernels.pack_probe_lanes_wavefront(  # noqa: E731
            *largs, max_free=lc.max_free, width=16, **lkw)
        fn()
        out[f"B6 wavefront lane_cases(0) {n_lanes} lanes"] = event_ms(fn, 10)
    print(json.dumps(out), flush=True)


def in_turns(other: str, func: str, smi: str, label: str, *fargs) -> list:
    """`func` of this script in the checkout `other` (another commit, e.g.
    the parent, unpacked with `git archive`) and in this one, in turns
    (other, here, here, other), each in a process of its own from its
    tree's root, that tree's package first on sys.path; prints each key's
    four values and returns the four JSON records."""
    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, "karpenter_tpu_torch")):
        fail(f"{label} {other}: no karpenter_tpu_torch there")
    script = os.path.join(HERE, "chip_smoke.py")
    runs = []
    for tree in (other, HERE, HERE, other):
        call = ", ".join(repr(x) for x in fargs)
        code = (f"import runpy, sys; sys.path.insert(0, {tree!r}); "
                f"runpy.run_path({script!r})[{func!r}]({call})")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
                             text=True, timeout=1200)
        if out.returncode != 0:
            fail(f"{func} in {tree} exited {out.returncode}: {out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        say(f"  {func} in {tree}: {time.perf_counter() - t0:.3f}s")
    say(f"{label} {other}: in turns (there, here, here, there) | card: {smi}")
    for key in runs[1]:
        vals = [r.get(key) for r in runs]
        if all(isinstance(v, float) for v in vals):
            say(f"  {key}: there {vals[0]:.6f}, {vals[3]:.6f}; here {vals[1]:.6f}, "
                f"{vals[2]:.6f}")
        elif all(isinstance(v, list) for v in vals):
            fmt = lambda v: ", ".join(f"{x:.6f}" for x in v)  # noqa: E731
            say(f"  {key}: there {fmt(vals[0])} / {fmt(vals[3])}; here {fmt(vals[1])} / "
                f"{fmt(vals[2])}")
        else:
            say(f"  {key}: there {vals[0]}; here {vals[1]}")
    for key in runs[0]:
        if key not in runs[1]:
            say(f"  {key} (there only): {runs[0][key]}; {runs[3][key]}")
    return runs


def sass_compare(other: str, lib: str) -> None:
    """Whether each kernel of library `lib` has the same machine code in
    the checkout `other` as here, kernel by kernel."""
    there, here = sass_digests(os.path.abspath(other), lib), sass_digests(HERE, lib)
    if not there or not here:
        say(f"  SASS {lib}: not compared (no build or no cuobjdump)")
        return
    same = sorted(k for k in here if there.get(k) == here[k])
    differ = sorted(k for k in here if k in there and there[k] != here[k])
    say(f"  SASS {lib}: identical {', '.join(same) or 'none'}; differ "
        f"{', '.join(differ) or 'none'}; here only "
        f"{', '.join(sorted(set(here) - set(there))) or 'none'}")


def b5_against(other: str, smi: str) -> None:
    """`--b5-against DIR`: `b5_timings` in the checkout DIR and here in
    turns, then the machine code of each `lp_ascend` kernel in both
    trees, kernel by kernel."""
    in_turns(other, "b5_timings", smi, B5_AGAINST)
    sass_compare(other, "lp_ascend")


def b6_against(other: str, smi: str) -> None:
    """`--b6-against DIR`: `b6_timings` in the checkout DIR and here in
    turns, then the machine code of each `pack_wavefront` kernel in both
    trees, kernel by kernel."""
    in_turns(other, "b6_timings", smi, B6_AGAINST)
    sass_compare(other, "pack_wavefront")


# `--dense`: phases 1-2, then phase 9 alone on the full-width problems
# staged through `dense_problems`
DENSE = "--dense"
# `--ladder`: phases 1-2, then phase 12 alone
LADDER = "--ladder"
# phase 12's problem: the host oracle is a Python loop a pod and a node
LADDER_PROBLEM = (1000, 50, 7)
# phase 12's turns of the pack alone (direct, ladder, watchdog thread)
# and pairs of the whole solve (seam bypassed, ladder); 25 and 10 before
# phase 17, cut for its time
LADDER_TURNS = 13
LADDER_WHOLE_TURNS = 5
# `--provision`: phases 1-2, then phase 13 alone
PROVISION = "--provision"
# phase 13: fresh environments timed after one warm-up (the benchmark
# problem; one since phase 17 (three, then two, before it): the claims
# launch through the lifecycle controller, ~10 s an environment on a slow
# host);
# bench.py's scenario_topology demand (pods, services, types)
# and scenario_mixed's (pods, types of the default pool, of the tainted
# one)
PROVISION_TURNS = 1
TOPOLOGY_PROBLEM = (1000, 20, 100)
MIXED_PROBLEM = (10_000, 400, 60)
COMPARE_SHARDS = (2, 4, 8)


def fits_groups(kernels, C: int, R: int, P1: int, K: int, G: int, W: int, N: int,
                pools: bool = False) -> int:
    """The most groups (at most G) whose tables B1's and B3's (width W,
    N rows) blocks hold whole in shared memory."""
    for g in range(G, 0, -1):
        if not kernels.table_placement(C, R, P1, K, g, pools=pools, W=W, N=N)["spilled"]:
            return g
    return 0


def spill_timing(kernels, name: str, run, lay: dict, reps: int, smi: str) -> tuple:
    """`run` all shared and spilled (under a budget one byte short of
    its all-shared layout: the groups' compat bits go to global memory),
    in turns (shared, spilled, spilled, shared), after checking that the
    two give byte-identical outputs and that the spilled launch took the
    catalog's placement."""
    import torch

    budget = lay["smem"] - 1

    def spilled():
        with kernels.forced_budget(budget):
            return run()

    a = run()
    b = spilled()
    torch.cuda.synchronize()
    flat = lambda x: flat_tensors(x if isinstance(x, (list, tuple)) else [x])  # noqa: E731
    if not same_outputs(flat(a), flat(b)):
        fail(f"{name}: the spilled launch differs from the all-shared one")
    seq = (event_ms(run, reps), event_ms(spilled, reps), event_ms(spilled, reps),
           event_ms(run, reps))
    say(f"  spilled against all shared, {name}: shared {seq[0]:.4f}, {seq[3]:.4f} ms; "
        f"spilled {seq[1]:.4f}, {seq[2]:.4f} ms (in turns: shared, spilled, spilled, "
        f"shared; outputs byte-identical) | card: {smi}")
    return seq


def catalog_cost(pods, pools, device) -> tuple:
    """The cost solve of the catalog on `device`, caches cleared: its
    fingerprint, fleet price, nodes and launches of B5's wide layout.
    Column generation is left out (`lp_plan.plan` returns None): the race
    is the FFD pack, and B5's duals guide the trim of the winner, the same
    work under any load. With it, its HiGHS MIPs stop on the host's wall
    clock (the card and the CPU may plan differently), and stopped at the
    root node instead the 2,400-config covering took ~70 s of host time a
    solve."""
    from karpenter_tpu_torch.solver import lp_device, lp_plan
    from karpenter_tpu_torch.solver import solver as solver_mod

    solver_mod.reset_caches()
    lp_device.reset()
    real_plan, wide0 = lp_plan.plan, lp_device.LAUNCHES["lp_ascend_wide"]
    lp_plan.plan = lambda enc, **kw: None
    try:
        sol = solver_mod.solve(pods, pools, objective="cost", device=device)
    finally:
        lp_plan.plan = real_plan
    return (solver_mod.fingerprint(sol), sol.total_price, len(sol.new_nodes),
            lp_device.LAUNCHES["lp_ascend_wide"] - wide0)


def catalog_lp(kernels, enc, pods, pools, err: dict, smi: str) -> dict:
    """Phase 11's cost objective on aws_catalog_50k (2,400 configs, padded
    past 2048: B5's wide layout): B5 held bit for bit on the catalog's LP,
    held and timed on the warm pool's 4096-config bucket shape (243 x
    4438); the cost solve without column generation on the card against
    device="cpu"'s fingerprint. Returns the report entry of the wide
    layout."""
    import torch

    from karpenter_tpu_torch.solver import lp_device
    from karpenter_tpu_torch.testing import ascent_wide_cases

    t0 = time.perf_counter()
    err.setdefault("lp_ascend", 0.0)
    a = lp_device.ascent_inputs(lp_device._stage(enc)).to("cuda")
    if not lp_device.ascent_wide(*a.compat.shape):
        fail(f"aws_catalog_50k's LP is {tuple(a.compat.shape)}: not past 2048")
    (_, bucket), = ascent_wide_cases(0, names=("wide-c4438-g243",))
    say(hold_ascent(lp_device, "aws_catalog_50k's LP", a, lp_device.iters(), err)
        + f"; {lp_device.ASCENT_SMEM['lp_ascend']}")
    b5_bucket = ascent_timing(kernels, lp_device, "the warm pool's 4096-config bucket shape",
                              bucket.to("cuda"), lp_device.iters(), err, smi)
    t1 = time.perf_counter()
    fp, price, nodes, launched = catalog_cost(pods, pools, None)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    (cpu_fp, cpu_price, cpu_nodes, _), cpu_s = CPU_REFS.get("catalog_cost")
    if launched < 1:
        fail("aws_catalog_50k's cost solve did not launch B5's wide layout")
    if fp != cpu_fp:
        fail(f"aws_catalog_50k's cost solve on the card (${price:.6f}/h, {nodes} nodes) "
             f"differs from device=\"cpu\"'s (${cpu_price:.6f}/h, {cpu_nodes} nodes)")
    say(f"  aws_catalog_50k cost, without column generation (the FFD pack, B5's duals "
        f"guiding the trim): the card ${price:.6f}/h, {nodes} nodes in {card_s:.3f}s (B5 "
        f"wide {launched}x), fingerprint equal to device=\"cpu\"'s (computed "
        f"{CPU_REFS.where('catalog_cost')} in {cpu_s:.3f}s) "
        f"({time.perf_counter() - t0:.3f}s) | card: {smi}")
    return {"name": "lp_ascend_wide", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/lp_ascend.cu",
            "replaces": "karpenter_tpu/solver/lp_device.py:202",
            "launches": launched, "max_abs_err": err["lp_ascend"],
            "ms": b5_bucket["ms"], "plain_ms": b5_bucket["plain_ms"],
            "bound_ms": b5_bucket["bound"], "bound_by": b5_bucket["by"], "library_ms": None}


def catalog_phase(err: dict, smi: str) -> dict:
    """Phase 11: aws_catalog_50k, past the shared-memory ceiling. Returns
    the report entries of the spilled launches."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import pack, pack_dense as pd, pack_shard as shard
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.solver import fingerprint, solve
    from karpenter_tpu_torch.testing import (
        KernelCase, cut_groups, dense_case, lane_case, pools_cases, split_case)
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh
    from karpenter_tpu_torch.workloads import aws_catalog_50k

    t_phase = time.perf_counter()
    for k in ("pack_split", "pack_split_wavefront", "pack_split_flat", "pack", "pack_flat",
              "pack_probe_lanes", "pack_probe_lanes_wavefront", "pack_probe_lanes_flat",
              "pack_probe_lanes_flat_masks", *SPLIT_WRAPPERS):
        err.setdefault(k, 0.0)
    pods, pools = aws_catalog_50k(CATALOG_TYPES)
    enc = encode(group_pods(pods), pools)
    G, C = enc.compat.shape
    cpu_fp, cpu_s = CPU_REFS.get("catalog")

    # ---- 1. the main path on the card, each route with the counts set
    # to 0 just before it and read just after
    staged, launches, walls, placed = {}, {}, {}, {}
    real_stage = pack.stage
    route = ""

    def recording(*a, **k):
        out = real_stage(*a, **k)
        staged.setdefault(route, out)
        return out

    pack.stage = recording
    try:
        for route, knob, want, lib in (
                ("wavefront", None, "pack_split_wavefront_global", "pack_split_wavefront"),
                ("sequential", "0", "pack_split_global", "pack_split")):
            if knob is not None:
                os.environ["KARPENTER_WAVEFRONT"] = knob
            try:
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                sol = solve(pods, pools)
                torch.cuda.synchronize()
                walls[route] = time.perf_counter() - t0
                launches[route] = dict(kernels.LAUNCHES)
                placed[route] = kernels.DYNAMIC_SMEM[lib]
            finally:
                os.environ.pop("KARPENTER_WAVEFRONT", None)
            n = launches[route]
            if n[want] < 1 or n["pack_split_flat"] < 1:
                fail(f"aws_catalog_50k, {route} route: launched {n}; expected {want} and "
                     "pack_split_flat")
            if fingerprint(sol) != cpu_fp:
                fail(f"aws_catalog_50k, {route} route: the card's fingerprint differs from "
                     "the CPU path's")
    finally:
        pack.stage = real_stage
    st = staged["wavefront"]
    R, P1, K = st.args[1].shape[1], st.args[5].shape[0], 0
    say(f"phase 11 aws_catalog_50k: {len(pods)} pods x {CATALOG_TYPES} types -> G={G} "
        f"groups, C={C} configs (staged Gp={st.Gp} Cp={st.Cp} N={st.N} R={R}), "
        f"{len(sol.new_nodes)} nodes, {len(sol.unschedulable)} unschedulable, "
        f"${sol.total_price:.6f}/h | B3 a block: {placed['wavefront']} | B1 a block: "
        f"{placed['sequential']} | walls (s): B3 route {walls['wavefront']:.6f}, B1 route "
        f"{walls['sequential']:.6f}; CPU path {cpu_s:.3f}s ({CPU_REFS.where('catalog')}), "
        f"fingerprints equal on both routes | launches: {json.dumps(launches)}")

    # ---- 2. holds past the ceiling, byte-identical to the plain versions
    t0 = time.perf_counter()
    case = KernelCase("aws_catalog_50k", st.args, st.kwargs, st.max_free, "ffd", st)
    kernels.reset_launch_counts()
    say(hold(kernels, case, err, widths=(8, 16)))
    n = dict(kernels.LAUNCHES)
    if n["pack_split_global"] < 1 or n["pack_split_wavefront_global"] < 2:
        fail(f"aws_catalog_50k's holds did not take the spilled B1 and B3: {n}")
    lc = lane_case("aws_catalog_50k lanes", enc, SEED, CATALOG_LANES)
    largs = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in lc.args]
    lkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
           for k, v in lc.kwargs.items()}
    kernels.reset_launch_counts()
    say(hold_lanes(kernels, lc.name, largs, lkw, lc.max_free, "ffd", err)
        + f"; B6 wavefront a block: {kernels.DYNAMIC_SMEM['pack_probe_lanes_wavefront']}")
    n = dict(kernels.LAUNCHES)
    if n["pack_probe_lanes_global"] < 1 or n["pack_probe_lanes_wavefront_global"] < 2:
        fail(f"aws_catalog_50k's lanes did not take the spilled B6 programs: {n}")
    dc = dense_case(st, "aws_catalog_50k dense", "ffd")
    pd.reset_launch_counts()
    say(hold_dense(pd, kernels, dc, err) + f"; B7 a block: {kernels.DYNAMIC_SMEM['pack']}")
    if pd.LAUNCHES["pack_global"] < 2:
        fail(f"aws_catalog_50k's dense hold did not take the spilled B7: {pd.LAUNCHES}")
    say(f"  holds past the ceiling: B1, B3 (widths 8, 16), B2, B6 (both programs, "
        f"{CATALOG_LANES} lanes), B7 and pack_flat byte-identical to their plain versions "
        f"({time.perf_counter() - t0:.3f}s)")
    oracle = {"pack_global": pd.LAUNCHES["pack_global"]}

    # ---- 2b. consolidation of the catalog's fleet with a second wave
    # pending: one cycle's ladder (the 100 candidates with the fewest
    # pods, consolidation_500's rule) as lanes of LaneSolver, every lane
    # also placing the wave; the union's groups spill B6. Both programs
    # (the default route and KARPENTER_WAVEFRONT=0), each held on three
    # lanes against solve() of the same probe on the card
    from karpenter_tpu_torch.solver.consolidation_batch import LaneSolver, ProbeLane
    from karpenter_tpu_torch.testing import summarize
    from karpenter_tpu_torch.workloads import node_input

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    keep = {p.metadata.name for p, k in zip(pods, rng.random(len(pods)) >= 0.55) if k}
    nodes, pods_on = [], []
    for ni, plan in enumerate(sol.new_nodes):
        kept = [p for p in plan.pods if p.metadata.name in keep]
        nodes.append(node_input(f"n-{ni}", plan.instance_types[0], plan.offerings[0],
                                plan.pool, kept))
        pods_on.append(kept)
    wave, _ = aws_catalog_50k(CATALOG_TYPES, total_pods=CATALOG_WAVE, seed=SEED + 1)
    for p in wave:
        p.metadata.name = f"wave-{p.metadata.name}"
    cands = sorted(range(len(nodes)), key=lambda i: (len(pods_on[i]), i))[:100]
    lanes = [ProbeLane(exclude_names=tuple(nodes[i].name for i in cands[:n]),
                       pods=[p for i in cands[:n] for p in pods_on[i]])
             for n in range(1, len(cands) + 1)]
    probe_launches, probe_walls = {}, {}
    for route, knob, want, ep in (
            ("wavefront", None, "pack_probe_lanes_wavefront_global", "pack_probe_lanes_flat"),
            ("sequential", "0", "pack_probe_lanes_global", "pack_probe_lanes_flat_masks")):
        if knob is not None:
            os.environ["KARPENTER_WAVEFRONT"] = knob
        try:
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            ls = LaneSolver(pools, nodes, pending=wave)
            lane_sols = [th() for th in ls.solve_lazy(lanes)]
            torch.cuda.synchronize()
            probe_walls[route] = time.perf_counter() - t1
            probe_launches[route] = dict(kernels.LAUNCHES)
        finally:
            os.environ.pop("KARPENTER_WAVEFRONT", None)
        n = probe_launches[route]
        if n[want] < 1 or n[ep] < 1:
            fail(f"catalog consolidation, {route} route: launched {n}; expected {want} and "
                 f"{ep}")
        for i in sorted({0, len(lanes) // 2, len(lanes) - 1}):
            gone = set(cands[:i + 1])
            rest = [node for j, node in enumerate(nodes) if j not in gone]
            ref = solve(list(lanes[i].pods) + wave, pools, existing=rest)
            if summarize(lane_sols[i], nodes) != summarize(ref, rest):
                fail(f"catalog consolidation, {route} route: lane {i + 1} differs from "
                     "solve() of the same probe")
    say(f"  consolidation of the catalog's fleet ({len(nodes)} nodes, {len(lanes)} lanes, "
        f"a wave of {len(wave)} pods pending; union Gp={ls.last_shapes.get('G')} "
        f"Cp={ls.last_shapes.get('C')}): B6 a block "
        f"{kernels.DYNAMIC_SMEM['pack_probe_lanes']} (sequential), "
        f"{kernels.DYNAMIC_SMEM['pack_probe_lanes_wavefront']} (wavefront); lanes 1, "
        f"{len(lanes) // 2 + 1}, {len(lanes)} equal to solve() of the same probe on both "
        f"routes; walls (s) {json.dumps(probe_walls)}; launches "
        f"{json.dumps(probe_launches)} ({time.perf_counter() - t0:.3f}s)")

    # ---- 3. the split hold: 4,800 configs at S = CATALOG_S, through
    # solve() on both routes, then held; and 80 node pools
    t0 = time.perf_counter()
    pods2, pools2 = aws_catalog_50k(CATALOG_SPLIT_TYPES)
    enc2 = encode(group_pods(pods2), pools2)
    force_virtual_mesh(max(CATALOG_S, 4))
    split_launches = {}
    try:
        whole_fp = fingerprint(solve(pods2, pools2))
        for route, knob, want in (("wavefront", None, "pack_split_wavefront_sharded_global"),
                                  ("sequential", "0", "pack_split_sharded_global")):
            if knob is not None:
                os.environ["KARPENTER_WAVEFRONT"] = knob
            try:
                shard.reset_launch_counts()
                sol2 = solve(pods2, pools2, shards=CATALOG_S)
                torch.cuda.synchronize()
                split_launches[route] = dict(shard.LAUNCHES)
            finally:
                os.environ.pop("KARPENTER_WAVEFRONT", None)
            n = split_launches[route]
            if n[want] < 1 or n["pack_flat_words_sharded"] < 1:
                fail(f"{CATALOG_SPLIT_TYPES}-type catalog at S={CATALOG_S}, {route} route: "
                     f"launched {n}; expected {want} and pack_flat_words_sharded")
            if fingerprint(sol2) != whole_fp:
                fail(f"{CATALOG_SPLIT_TYPES}-type catalog at S={CATALOG_S}, {route} route: "
                     "fingerprint differs from the unsharded card solve's")
        mask2 = np.zeros((0, enc2.compat.shape[1]), bool)
        used2 = np.zeros((0, enc2.group_req.shape[1]), np.float32)
        st2 = pack.stage(enc2, mask2, used2, pack.node_axis(enc2, "ffd"))
        case2 = KernelCase(f"catalog-{CATALOG_SPLIT_TYPES}", st2.args, st2.kwargs,
                           st2.max_free, "ffd", st2)
        shard.reset_launch_counts()
        say(hold_split(shard, kernels, case2, CATALOG_S, err)
            + f"; a block: {kernels.DYNAMIC_SMEM['pack_split_wavefront_sharded']}")
        if shard.LAUNCHES["pack_split_sharded_global"] < 1:
            fail(f"the split hold did not take the spilled split B1: {shard.LAUNCHES}")
        say(f"  {CATALOG_SPLIT_TYPES} types -> G={enc2.compat.shape[0]} "
            f"C={enc2.compat.shape[1]} (Cs={st2.Cp // CATALOG_S} at S={CATALOG_S}): solve() "
            f"on the B3 and B1 routes equal to the unsharded card solve; launches "
            f"{json.dumps(split_launches)}")
        many = pools_cases(SEED, MANY_POOLS, n_pods=3000, n_types=60, per_pool=4)
        for pc in many:
            for S in (2, 4):
                say(hold_split(shard, kernels, pc, S, err) + f" (P1={pc.args[5].shape[0]})")
            with kernels.forced_budget(0):
                say(hold_split(shard, kernels, pc, 2, err)
                    + f" (P1={pc.args[5].shape[0]}, every table spilled: "
                    f"{kernels.DYNAMIC_SMEM['pack_split_sharded']})")
        say(f"  split holds at {CATALOG_SPLIT_TYPES} types and with {MANY_POOLS} node pools "
            f"byte-identical ({time.perf_counter() - t0:.3f}s)")

        # ---- 4. each spilled kernel beside the all-shared one on the
        # largest shape that fits both (the catalog's groups cut)
        W = pack.wavefront_width(torch.device("cuda"))
        N = st.N
        g_fit = fits_groups(kernels, st.Cp, R, P1, K, st.Gp, W, N)
        cut = cut_groups(case, g_fit)
        cargs, ckw = to_cuda(cut)
        F = cut.max_free
        lay1 = kernels.table_placement(st.Cp, R, P1, K, g_fit)
        lay3 = kernels.table_placement(st.Cp, R, P1, K, g_fit, W=W, N=N)
        lcut = cut_groups(lc, g_fit)
        lcargs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in lcut.args]
        lckw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in lcut.kwargs.items()}
        dargs = (*cargs[:6], torch.zeros((0, st.Cp), dtype=torch.bool, device="cuda"),
                 cargs[8], cargs[11])
        say(f"  timing spilled against all shared on aws_catalog_50k cut to Gp={g_fit} "
            f"(Cp={st.Cp}, the most groups whose tables B3's block holds whole)")
        spill = {
            "pack_split_global": spill_timing(
                kernels, "B1", lambda: kernels.pack_split(*cargs, max_free=F, **ckw), lay1, 5,
                smi),
            "pack_split_wavefront_global": spill_timing(
                kernels, f"B3 (W={W})", lambda: kernels.pack_split_wavefront(
                    *cargs, max_free=F, width=W, **ckw), lay3, 5, smi),
            "pack_probe_lanes_global": spill_timing(
                kernels, "B6 sequential", lambda: kernels.pack_probe_lanes(
                    *lcargs, max_free=lcut.max_free, **lckw), lay1, 5, smi),
            "pack_probe_lanes_wavefront_global": spill_timing(
                kernels, f"B6 wavefront (W={W})", lambda: kernels.pack_probe_lanes_wavefront(
                    *lcargs, max_free=lcut.max_free, width=W, **lckw), lay3, 5, smi),
            "pack_global": spill_timing(
                kernels, "B7", lambda: pd.pack(*dargs, max_nodes=N, **{
                    k: ckw[k] for k in ("cfg_rsv", "rsv_cap", "group_cap", "conflict")}),
                lay1, 3, smi),
        }
        g2 = fits_groups(kernels, st2.Cp // CATALOG_S, R, P1, K, st2.Gp, W, st2.N, pools=True)
        sa, skw, _, _ = split_case(cut_groups(case2, g2), CATALOG_S)
        sargs = [[torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in a]
                 if isinstance(a, list) else torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in sa]
        skw = {k: None if v is None else (
            [torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in v]
            if isinstance(v, list) else torch.from_numpy(np.ascontiguousarray(v)).cuda())
            for k, v in skw.items()}
        Cs = st2.Cp // CATALOG_S
        say(f"  timing the split kernels at S={CATALOG_S} on the {CATALOG_SPLIT_TYPES}-type "
            f"catalog cut to Gp={g2} (Cs={Cs})")
        spill["pack_split_sharded_global"] = spill_timing(
            kernels, f"split B1 S={CATALOG_S}", lambda: shard.pack_split_sharded(
                *sargs, max_free=st2.max_free, **skw),
            kernels.table_placement(Cs, R, P1, K, g2, pools=True), 5, smi)
        spill["pack_split_wavefront_sharded_global"] = spill_timing(
            kernels, f"split B3 S={CATALOG_S} (W={W})",
            lambda: shard.pack_split_wavefront_sharded(
                *sargs, max_free=st2.max_free, width=W, **skw),
            kernels.table_placement(Cs, R, P1, K, g2, pools=True, W=W, N=st2.N), 5, smi)

        # ---- 5. the spilled kernels at the catalog's own shapes, for the
        # report: their time, their plain versions', their bounds
        fargs, fkw = to_cuda(case)
        s2args, s2kw, _, _ = split_case(case2, CATALOG_S)
        s2args = [[torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in a]
                  if isinstance(a, list) else torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in s2args]
        s2kw = {k: None if v is None else (
            [torch.from_numpy(np.ascontiguousarray(b)).cuda() for b in v]
            if isinstance(v, list) else torch.from_numpy(np.ascontiguousarray(v)).cuda())
            for k, v in s2kw.items()}
        dfull = to_cuda(dc)
        runs = {
            "pack_split_global": (
                lambda: kernels.pack_split(*fargs, max_free=st.max_free, **fkw),
                lambda: kernels.pack_split_ref(*fargs, max_free=st.max_free, **fkw)),
            "pack_split_wavefront_global": (
                lambda: kernels.pack_split_wavefront(*fargs, max_free=st.max_free, width=W,
                                                     **fkw),
                lambda: kernels.pack_split_wavefront_ref(*fargs, max_free=st.max_free,
                                                         width=W, **fkw)),
            "pack_probe_lanes_global": (
                lambda: kernels.pack_probe_lanes(*largs, max_free=lc.max_free, **lkw),
                lambda: kernels.pack_probe_lanes_ref(*largs, max_free=lc.max_free, **lkw)),
            "pack_probe_lanes_wavefront_global": (
                lambda: kernels.pack_probe_lanes_wavefront(*largs, max_free=lc.max_free,
                                                           width=W, **lkw),
                lambda: kernels.pack_probe_lanes_wavefront_ref(*largs, max_free=lc.max_free,
                                                               width=W, **lkw)),
            "pack_global": (
                lambda: pd.pack(*dfull[0], max_nodes=dc.max_nodes, **dfull[1]),
                lambda: pd.pack_ref(*dfull[0], max_nodes=dc.max_nodes, **dfull[1])),
            "pack_split_sharded_global": (
                lambda: shard.pack_split_sharded(*s2args, max_free=st2.max_free, **s2kw),
                lambda: shard.pack_split_sharded_ref(*s2args, max_free=st2.max_free,
                                                     **s2kw)),
            "pack_split_wavefront_sharded_global": (
                lambda: shard.pack_split_wavefront_sharded(*s2args, max_free=st2.max_free,
                                                           width=W, **s2kw),
                lambda: shard.pack_split_wavefront_sharded_ref(
                    *s2args, max_free=st2.max_free, width=W, **s2kw)),
        }
        ops1 = b1_ops(kernels, fargs, fkw, st.max_free)
        ops2 = b1_ops(kernels, *to_cuda(case2), st2.max_free)
        in1 = nbytes(list(fargs) + list(fkw.values()))
        entries = []
        for name, (run, plain) in runs.items():
            out = run()
            torch.cuda.synchronize()
            ms = [event_ms(run, 3), event_ms(run, 3)]
            plain_ms = event_ms(plain, 1, queued=False)
            if name in ("pack_probe_lanes_global", "pack_probe_lanes_wavefront_global"):
                b = bound(0, nbytes(largs + [v for v in lkw.values() if v is not None])
                          + nbytes(flat_tensors(out)))
            elif name == "pack_global":
                b = bound(b7_ops(pd, dfull[0], dfull[1], dc.max_nodes, "ffd"),
                          nbytes(flat_tensors(list(dfull[0]) + list(dfull[1].values())))
                          + nbytes(flat_tensors(out)))
            elif name.startswith("pack_split_sharded") or name.startswith(
                    "pack_split_wavefront_sharded"):
                b = bound(ops2, nbytes(flat_tensors(list(s2args) + list(s2kw.values())))
                          + nbytes(flat_tensors(out)))
            else:
                b = bound(ops1, in1 + nbytes(flat_tensors(out)))
            src, rep = GLOBAL_KERNELS[name]
            base = name[: -len("_global")]
            total = (sum(n.get(name, 0) for n in launches.values())
                     + sum(n.get(name, 0) for n in split_launches.values())
                     + sum(n.get(name, 0) for n in probe_launches.values())
                     + oracle.get(name, 0))
            say(f"  {name} on the catalog's shape: {ms[0]:.4f}, {ms[1]:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {b[0]:.6f} ms ({b[1]}), {total} launches on the "
                f"phase's paths (solves, consolidation, B7's oracle) | card: {smi}")
            entries.append({
                "name": name, "route": "cuda", "source": f"karpenter_tpu_torch/csrc/{src}",
                "replaces": rep, "launches": total, "max_abs_err": err[base],
                "ms": (ms[0] + ms[1]) / 2, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None})
    finally:
        force_virtual_mesh(0)
    entries.append(catalog_lp(kernels, enc, pods, pools, err, smi))
    say(f"  phase 11 took {time.perf_counter() - t_phase:.3f}s | card: {smi}")
    return {"entries": entries,
            "launches": {**launches, **{f"split-{k}": v for k, v in split_launches.items()},
                         **{f"consolidation-{k}": v for k, v in probe_launches.items()}}}


def compare_timings(dense_cache: str | None = None) -> None:
    """Times, on fixed inputs through a tree's own public wrappers, the
    kernels the redesigns touched and those that must not slow, and
    prints them as one JSON line. `against` runs it in a process of its
    own from each tree's root, that tree's package first on sys.path:
    B1, B3 and B2's full copy on the first 50k x 500 request; split B1,
    B3 and B2 at S = 2, 4, 8 on the same request (split B2's kernel alone
    too); B4 on reserved_50k's first column-generation round and its
    phase clocks; B6's two programs on `testing.lane_cases(0)`'s first
    case at 10 and 64 lanes; the whole `pack_split_flat` call on the B1
    and B3 routes and B2 as the main path runs it; phase 8's first chunk
    (staged by `first_chunk`): B6 sequential (the dispatch, lane 0 and
    the lane with the most demand alone, their phase clocks), B6
    wavefront, the whole `pack_probe_lanes_flat` call on both programs
    and the lane epilogue on both routes; B7 on `entry()` and on phase
    9's three problems beside B1 and the whole `pack_flat` call
    (`dense_timing`; the problems staged by `dense_problems`, pickled at
    `dense_cache` by the first run and loaded by the others); the stack
    frames and registers of the packing kernels and B4. The other tree
    must have this one's wrappers (`pack_shard.flat_sharded_launcher`,
    B4's phase clocks)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import graft_entry
    from karpenter_tpu_torch.solver import lp_plan, pack, pack_dense as pd, pack_shard as shard
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.testing import lane_cases
    from karpenter_tpu_torch.utils.platform import force_virtual_mesh
    from karpenter_tpu_torch.workloads import build_problem

    out = {}
    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    enc = encode(group_pods(pods), pools)
    mask, used, quota = pack._bound_rows(enc)
    N = pack.node_axis(enc, "ffd")
    W = pack.wavefront_width(torch.device("cuda"))
    st = pack.stage(enc, mask, used, N, quota)
    fargs, fkw = pack.to_device(st, torch.device("cuda"))
    F = st.max_free
    runs = {
        "B1": lambda: kernels.pack_split(*fargs, max_free=F, mode="ffd", **fkw),
        "B3": lambda: kernels.pack_split_wavefront(*fargs, max_free=F, mode="ffd", width=W,
                                                   **fkw),
    }
    o3 = runs["B3"]()
    runs["B2"] = lambda: kernels.pack_flat_words(*o3[:4], o3[5], o3[4])
    force_virtual_mesh(max(COMPARE_SHARDS))
    try:
        for S in COMPARE_SHARDS:
            st_ = pack.stage(enc, mask, used, N, quota, shards=S)
            sargs, skw = pack.to_mesh(st_, enc, pack._mesh(S, "cuda"), stream=False)
            runs[f"split B1 S={S}"] = (lambda a=sargs, k=skw: shard.pack_split_sharded(
                *a, max_free=F, mode="ffd", **k))
            runs[f"split B3 S={S}"] = (lambda a=sargs, k=skw: shard.pack_split_wavefront_sharded(
                *a, max_free=F, mode="ffd", width=W, **k))
            so = runs[f"split B3 S={S}"]()
            runs[f"split B2 S={S}"] = (lambda o=so: shard.pack_flat_words_sharded(
                *o[:4], o[5], o[4]))
            runs[f"split B2 S={S} kernel alone"] = shard.flat_sharded_launcher(
                *so[:4], so[5], so[4])
        for name, fn in list(runs.items()):
            rc = fn()
            torch.cuda.synchronize()
            if isinstance(rc, int) and rc != 0:
                fail(f"compare_timings: {name} returned CUDA error {rc}")
            reps = 50 if "B2" in name else 10
            out[name] = event_ms(fn, reps)
    finally:
        force_virtual_mesh(0)

    # B4 on reserved_50k's first column-generation round
    rpods, rpools = build_problem(COST_PODS, COST_TYPES, seed=SEED, reservations=True,
                                  zonal_frac=COST_ZONAL)
    renc = encode(group_pods(rpods), rpools)
    real_pk, real_pp = lp_plan.price_kernel, lp_plan._price_patterns
    seen, calls = [0], []

    class FirstRound(Exception):
        pass

    def price_patterns(*a, **k):
        seen[0] += 1
        return real_pp(*a, **k)

    def price_kernel(*xs):
        if seen[0] > 1:
            calls.append([x.clone() for x in xs])
            raise FirstRound
        return real_pk(*xs)

    lp_plan.price_kernel, lp_plan._price_patterns = price_kernel, price_patterns
    try:
        lp_plan.plan(renc, device="cuda")
    except FirstRound:
        pass
    finally:
        lp_plan.price_kernel, lp_plan._price_patterns = real_pk, real_pp
    if not calls:
        fail("compare_timings: reserved_50k's planner made no second round of pricing")
    xs = calls[0]
    lp_plan.price_kernel(*xs)
    out["B4"] = event_ms(lambda: lp_plan.price_kernel(*xs), 50)
    out["B4 shape"] = f"Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} R={xs[2].shape[1]}"
    out["B4 clocks"] = price_clocks(kernels, lp_plan, xs)[0]

    # B6 on the first seeded lane case, at 10 lanes and at 64
    for suffix, n_lanes in (("", 10), (" 64 lanes", 64)):
        lc = lane_cases(0, n_lanes=n_lanes)[0]
        largs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in lc.args]
        lkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in lc.kwargs.items()}
        runs = {"B6 sequential": lambda: kernels.pack_probe_lanes(
                    *largs, max_free=lc.max_free, **lkw),
                "B6 wavefront": lambda: kernels.pack_probe_lanes_wavefront(
                    *largs, max_free=lc.max_free, width=16, **lkw)}
        for name, fn in runs.items():
            fn()
            out[name + suffix] = event_ms(fn, 10)

    # the whole flat calls on the first request (B1, B3 routes), and B2 as
    # the main path runs it: this tree's mask epilogue on the B3 route's
    # buffer, or the full copy of a tree that has no flat_masks
    flat_runs = {
        "pack_split_flat B1": lambda: kernels.pack_split_flat(*fargs, max_free=F, mode="ffd",
                                                              **fkw),
        "pack_split_flat B3": lambda: kernels.pack_split_flat(
            *fargs, max_free=F, mode="ffd", wavefront=W, **fkw)}
    for name, fn in flat_runs.items():
        fn()
        out[name] = event_ms(fn, 10)
        out[name + " as the host launches it"] = event_ms(fn, 10, queued=False)
    if hasattr(kernels, "flat_masks"):
        buf, lay = flat_filled(kernels, fargs, fkw, F, "ffd", W)
        b2 = lambda: kernels.flat_masks(buf, lay)  # noqa: E731
    else:
        b2 = lambda: kernels.pack_flat_words(*o3[:4], o3[5], o3[4])  # noqa: E731
    b2()
    out["B2 as the main path runs it"] = event_ms(b2, 50)
    out["B2 as the main path runs it, a call as the host launches it"] = event_ms(
        b2, 50, queued=False)

    # phase 8's first chunk: B6 sequential (the dispatch, lane 0 alone,
    # lane 0's phase clocks), B6 wavefront, the whole lane flat calls and
    # the lane epilogue as the main path runs it
    from karpenter_tpu_torch.solver import consolidation_batch as cb

    args, kw, cF, cmode, cW, n_real = first_chunk(kernels, cb)
    one = list(args)
    one[2], one[10] = args[2][:1].contiguous(), args[10][:1].contiguous()
    seq = lambda a=args: kernels.pack_probe_lanes(  # noqa: E731
        *a, max_free=cF, mode=cmode, **kw)
    wf = lambda: kernels.pack_probe_lanes_wavefront(  # noqa: E731
        *args, max_free=cF, mode=cmode, width=cW, **kw)
    heavy = int(args[2].to(torch.int64).sum(dim=1).argmax())
    top = list(args)
    top[2], top[10] = args[2][heavy:heavy + 1].contiguous(), args[10][heavy:heavy + 1].contiguous()
    for name, fn in (("B6 sequential chunk", seq), ("B6 sequential chunk lane 0 alone",
                                                    lambda: seq(one)),
                     (f"B6 sequential chunk lane {heavy} (the most demand) alone",
                      lambda: seq(top)),
                     ("B6 wavefront chunk", wf)):
        fn()
        out[name] = event_ms(fn, 10)
    threads = getattr(kernels, "LANE_THREADS", 1024)
    out["B6 sequential chunk shape"] = (f"L={args[2].shape[0]} ({n_real} real) "
                                        f"Gp={args[0].shape[0]} Cp={args[0].shape[1]} "
                                        f"B={args[7].shape[0]} F={cF}, {threads} threads, "
                                        f"{kernels.DYNAMIC_SMEM.get('pack_probe_lanes')}")
    seq()
    out["B6 sequential chunk clocks"] = phase_breakdown(
        kernels, "pack_split", seq, out["B6 sequential chunk"], "step", threads=threads)
    out[f"B6 sequential chunk lane {heavy} alone clocks"] = phase_breakdown(
        kernels, "pack_split", lambda: seq(top),
        out[f"B6 sequential chunk lane {heavy} (the most demand) alone"], "step",
        threads=threads)
    for label, w in (("sequential", 0), ("wavefront", cW)):
        fn = lambda w=w: kernels.pack_probe_lanes_flat(  # noqa: E731
            *args, max_free=cF, mode=cmode, wavefront=w, **kw)
        fn()
        out[f"pack_probe_lanes_flat {label} chunk"] = event_ms(fn, 5)
        out[f"pack_probe_lanes_flat {label} chunk as the host launches it"] = event_ms(
            fn, 5, queued=False)
    # the lane epilogue on the wavefront route (the full copy in both
    # trees) and on the sequential route (this tree's in place, or the
    # full copy of a tree that has no flat_masks)
    ow = wf()
    if hasattr(kernels, "flat_masks"):
        lbuf, llay = flat_filled(kernels, args, kw, cF, cmode, lanes=True)
        seq_ep = lambda: kernels.flat_masks(  # noqa: E731
            lbuf, llay, "pack_probe_lanes_flat_masks")
    else:
        os_ = seq()
        seq_ep = lambda: kernels.pack_flat_lanes(*os_)  # noqa: E731
    for label, ep in (("wavefront route", lambda: kernels.pack_flat_lanes(
            *ow[:4], ow[5], ow[4])), ("sequential route", seq_ep)):
        ep()
        out[f"lane epilogue, {label}"] = event_ms(ep, 50)
        out[f"lane epilogue, {label}, a call as the host launches it"] = event_ms(
            ep, 50, queued=False)
    # B7 (and B1) on entry() and the three full-width problems, the whole
    # pack_flat call, B7's phase clocks where the tree has them
    out.update(dense_timing(pd, kernels, graft_entry, dense_problems(dense_cache)))
    from karpenter_tpu_torch import cuda_build

    info = cuda_build.build_all()
    for lib in ("pack_split", "pack_wavefront", "pack_dense", "lp_price"):
        out[f"ptxas {lib}"] = ptxas_usage(info[lib]["ptxas"])
    print(json.dumps(out), flush=True)


def first_chunk(kernels, cb):
    """Phase 8's first chunk, staged through a tree's own public
    functions: consolidation_500's fleet (`workloads.consolidation_fleet`)
    and one cycle of arm (c) (`testing.consolidation_ladder`), its first
    `pack_probe_lanes_flat` call after the warm staging. Returns (args,
    kwargs without max_free, mode and wavefront, max_free, mode, the
    wavefront width, the real lanes)."""
    from karpenter_tpu_torch.testing import consolidation_ladder
    from karpenter_tpu_torch.workloads import consolidation_fleet

    for knob in PROBE_KNOBS:
        os.environ.pop(knob, None)
    fleet = consolidation_fleet()
    rec = {"staging": 0, "calls": []}
    real_lazy, real_flat = cb.LaneSolver.solve_lazy, kernels.pack_probe_lanes_flat

    def solve_lazy(self, *a, **k):
        rec["staging"] += 1
        return real_lazy(self, *a, **k)

    def pack_probe_lanes_flat(*a, **k):
        rec["calls"].append((rec["staging"], a, k))
        return real_flat(*a, **k)

    cb.LaneSolver.solve_lazy, kernels.pack_probe_lanes_flat = solve_lazy, pack_probe_lanes_flat
    try:
        consolidation_ladder(*fleet, batched=True, device="cuda", cycles=1)
    finally:
        cb.LaneSolver.solve_lazy, kernels.pack_probe_lanes_flat = real_lazy, real_flat
    first = [c for c in rec["calls"] if c[0] == 2]
    if not first:
        fail("first_chunk: the first cycle dispatched no lane chunk")
    _, args, k = first[0]
    kw = {key: k.get(key) for key in ("cfg_rsv", "rsv_cap", "conflict")}
    n_real = int((args[10].any(dim=1) | (args[2] > 0).any(dim=1)).sum())
    return args, kw, k["max_free"], k["mode"], k["wavefront"], n_real


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as "name<0|1[,threads]>" (its bool and int
    template arguments)."""
    import re

    k = re.search(r"([a-z_]+_kernel)(ILb([01])E(Li(\d+)E)?)?", mangled)
    if not k:
        return mangled
    return k.group(1) + (f"<{k.group(3)}{',' + k.group(5) if k.group(5) else ''}>"
                         if k.group(3) else "")


def sass_digests(tree: str, lib: str) -> dict:
    """{kernel: digest of its machine code} of library `lib` as the
    checkout `tree` built it (`cuobjdump -sass` of its `_build/` copy);
    empty when the tree has not built it or the toolkit has no
    cuobjdump."""
    import glob
    import hashlib
    import re
    import shutil

    paths = glob.glob(os.path.join(tree, "karpenter_tpu_torch", "_build", f"{lib}-*.so"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not paths or not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", max(paths, key=os.path.getmtime)],
                         capture_output=True, text=True, timeout=300)
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            funcs[name] = hashlib.sha256()
        elif name:
            # the dump pads its columns to its longest line: compare the
            # instructions and encodings, not the padding
            funcs[name].update(" ".join(line.split()).encode())
    return {k: v.hexdigest() for k, v in funcs.items()}


def ptxas_usage(text: str) -> str:
    """Each kernel's stack frame and registers from a build's ptxas
    report, as "name<0|1>: s B stack, r registers" (the bool template
    argument of a kernel's instantiation)."""
    import re

    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} B stack")
        m = re.search(r"Used (\d+) registers", line)
        if m and name and out and out[-1].startswith(name + ":"):
            out[-1] += f", {m.group(1)} registers"
    return " | ".join(out)


def against(other: str, smi: str) -> None:
    """`--against DIR`: `compare_timings` in the checkout DIR (another
    commit, e.g. the parent, unpacked with `git archive`) and in this
    one, in turns (`in_turns`; B7's problems staged once, by the first
    turn), then whether the machine code of B1, B3 and B2 is the same in
    both trees, kernel by kernel."""
    import shutil
    import tempfile

    scratch = tempfile.mkdtemp(prefix="chip_smoke_dense_")
    try:
        in_turns(other, "compare_timings", smi, AGAINST, os.path.join(scratch, "problems.pkl"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for lib in ("pack_split", "pack_wavefront", "pack_flat"):
        sass_compare(other, lib)


def ladder_counts() -> dict:
    """The ladder's counter by (labels), and the degraded device LPs
    under the key "lp": what `served_by_device` counts from."""
    from karpenter_tpu_torch.metrics.store import SOLVER_LADDER, SOLVER_LP_SOLVES

    out = dict(SOLVER_LADDER.samples())
    out["lp"] = SOLVER_LP_SOLVES.value({"outcome": "degraded"})
    return out


def served_by_device(phase: str, since: dict | None = None) -> dict:
    """Fail unless the device or sharded rung served every packing solve
    since the warm phase (`LADDER_BASE`: its re-warm check injects device
    faults), or since the `ladder_counts()` taken as `since`: the
    ladder's counter holds only `ok` outcomes on those rungs,
    `resilience.pop_degraded()` is empty (nothing degraded since the last
    check), and no device LP degraded. Returns the ok counts by rung."""
    from karpenter_tpu_torch.solver import resilience

    degraded = resilience.pop_degraded()
    since = since or LADDER_BASE
    counts = ladder_counts()
    served, other = {}, {}
    for labels, n in counts.items():
        if labels == "lp" or n == since.get(labels, 0):
            continue
        n -= since.get(labels, 0)
        rung, outcome = dict(labels).get("rung"), dict(labels).get("outcome")
        if rung in ("device", "sharded") and outcome == "ok":
            served[rung] = int(n)
        else:
            other[f"{rung}/{outcome}"] = int(n)
    lp = counts["lp"] - since.get("lp", 0)
    if degraded or other or lp:
        fail(f"{phase}: a solve was not served by the device: degraded {degraded}, "
             f"ladder {other}, device LP degraded {lp:.0f}x")
    return served


def ladder_phase(smi: str, first_enc=None) -> None:
    """Phase 12: `testing.ladder_script` on the card on LADDER_PROBLEM,
    held to its expected sequence, then the ladder's walls."""
    import torch

    from karpenter_tpu_torch.metrics.store import SOLVER_LADDER
    from karpenter_tpu_torch.solver import pack, resilience
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.solver import fingerprint
    from karpenter_tpu_torch.testing import (
        LADDER_DEADLINE_MS,
        LadderPackage,
        ladder_fleet,
        ladder_mismatches,
        ladder_script,
        pack_digest,
        scoped_env,
    )
    from karpenter_tpu_torch.workloads import build_problem

    t0 = time.perf_counter()
    n_pods, n_types, seed = LADDER_PROBLEM
    pods, pools = build_problem(n_pods, n_types, seed=seed)
    enc = encode(group_pods(pods), pools)
    fleet = ladder_fleet(pods, pools, "cuda")
    records, walls = ladder_script(LadderPackage(enc, fleet, "cuda"))
    for rec in records:
        say("  " + json.dumps(rec))
    bad = ladder_mismatches(records, walls)
    if bad:
        fail("phase 12 ladder: " + "; ".join(bad))
    served = [f"{r['stage']}-{r['step']}:{'+'.join(r['served'])}" for r in records
              if "served" in r]
    say(f"phase 12 ladder: build_problem{LADDER_PROBLEM} (G={enc.compat.shape[0]} "
        f"C={enc.compat.shape[1]}), {len(fleet[1])} fleet nodes: the script's sequence "
        f"held ({', '.join(served)}; the probe site and the LP seam as expected), every "
        f"device-served result byte-identical to a direct card solve, every host-served one "
        f"equal to host_pack_result ({time.perf_counter() - t0:.3f}s)")
    budget = LADDER_DEADLINE_MS / 1000
    say(f"  walls (host clock): host rung {walls['host_s']:.6f}s; deadline case "
        f"{walls['deadline-0']:.6f}s against its budget {budget:.3f}s + the host solve; "
        f"compile-deadline case {walls['compile_deadline-0']:.6f}s; hedge case "
        f"{walls['hedge-0']:.6f}s ({walls['hedge_attempts']} attempt(s)); breaker cooldown "
        f"{walls['cooldown_ms']} ms, slept {walls['breaker_sleep_s']:.6f}s before the "
        f"half-open probe | card: {smi}")
    pend = {r["stage"]: r.get("pending") for r in records if r["stage"].startswith("async")}
    say(f"  asynchronous seam (solve_packing_async, result() on the caller): healthy "
        f"{walls['async-0']:.6f}s ({pend['async']}, the device rung at its fetch); "
        f"device_lost at the fetch's execute site {walls['async_fetch-0']:.6f}s "
        f"({pend['async_fetch']}, the host); deadline mode {walls['async_deadline-0']:.6f}s "
        f"({pend['async_deadline']}: the ladder on an executor worker, the host serving, the "
        f"report on the calling thread) | card: {smi}")

    # the healthy path's cost on the warm first request, in turns whose
    # order alternates (a fixed order would bias one side): the whole
    # solve (`solve_encoded`: pack and decode) through the ladder
    # against the same solve with the seam calling the pack directly
    # (LADDER_WHOLE_TURNS pairs), then the pack alone, direct, through
    # the ladder and on its watchdog thread, the order rotated each turn
    # (median of LADDER_TURNS: the ladder's cost is tens of us against a
    # spread of a few hundred)
    if first_enc is None:
        fpods, fpools = build_problem(N_PODS, N_TYPES, seed=SEED)
        first_enc = encode(group_pods(fpods), fpools)
    dev = torch.device("cuda")
    resilience.reset()
    rs = resilience.shared()
    seam = solver_mod._solve_packing

    def bypass(enc, mode, device, plan=None, shards=0):
        return pack.solve_packing(enc, mode=mode, plan=plan, device=device, shards=shards)

    def timed(fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t1, out

    def whole(via_ladder: bool):
        solver_mod._solve_packing = seam if via_ladder else bypass
        try:
            return fingerprint(solver_mod.solve_encoded(first_enc, device=dev))
        finally:
            solver_mod._solve_packing = seam

    fps = set()
    solves = {"bypass": [], "ladder": []}
    ok = {"rung": "device", "outcome": "ok"}
    seam_before = SOLVER_LADDER.value(ok)
    whole(True)
    seam_calls = int(SOLVER_LADDER.value(ok) - seam_before)
    for turn in range(LADDER_WHOLE_TURNS):
        for name in (("bypass", "ladder") if turn % 2 == 0 else ("ladder", "bypass")):
            wall, fp = timed(lambda: whole(name == "ladder"))
            solves[name].append(wall)
            fps.add(fp)
    want = pack_digest(pack.solve_packing(first_enc, device=dev))
    packs = {"direct": [], "ladder": [], "watchdog": []}
    order = list(packs)
    digests = set()
    for turn in range(LADDER_TURNS):
        for name in order[turn % 3:] + order[: turn % 3]:
            if name == "direct":
                wall, out = timed(lambda: pack.solve_packing(first_enc, device=dev))
            elif name == "ladder":
                wall, out = timed(lambda: rs.solve_packing(first_enc, device=dev))
            else:
                with scoped_env({"KARPENTER_SOLVE_DEADLINE_MS": "10000"}):
                    wall, out = timed(lambda: rs.solve_packing(first_enc, device=dev))
            packs[name].append(wall)
            digests.add(pack_digest(out))
    if len(fps) != 1 or digests != {want} or resilience.pop_degraded():
        fail("phase 12: a healthy ladder solve of the first request differs from the "
             "direct solve or was degraded")

    def line(walls: dict, base: str) -> str:
        med = {k: statistics.median(v) for k, v in walls.items()}
        return "; ".join(
            f"{k} {med[k]:.6f}"
            + ("" if k == base else f" ({1e6 * (med[k] - med[base]):+.1f} us, "
                                    f"{100 * (med[k] / med[base] - 1):+.2f}%)")
            + f" [{', '.join(f'{w:.6f}' for w in walls[k])}]"
            for k in walls)

    pairs = list(zip(solves["bypass"], solves["ladder"]))
    wins = sum(lad < byp for byp, lad in pairs)
    first = [lad - byp for turn, (byp, lad) in enumerate(pairs) if turn % 2 == 0]
    second = [lad - byp for turn, (byp, lad) in enumerate(pairs) if turn % 2 == 1]
    over = statistics.median(solves["ladder"]) / statistics.median(solves["bypass"]) - 1
    say(f"  warm 50k x 500 first request (s, host clock, in turns of alternating order), "
        f"the whole solve (solve_encoded, {seam_calls} seam call(s) a solve), median of "
        f"{LADDER_WHOLE_TURNS}, the seam calling the pack directly against the ladder: "
        f"{line(solves, 'bypass')}; the ladder faster in {wins} of {len(pairs)} pairs; "
        f"ladder - bypass, median of the pairs with bypass first "
        f"{1e6 * statistics.median(first):+.1f} us, ladder first "
        f"{1e6 * statistics.median(second):+.1f} us; overhead {100 * over:+.2f}% against "
        f"the ~1% aim: {'met' if over <= 0.01 else 'missed'} | card: {smi}")
    say(f"  the pack alone, median of {LADDER_TURNS}: pack.solve_packing direct, through "
        f"the ladder, and with KARPENTER_SOLVE_DEADLINE_MS=10000 (the attempt on a "
        f"watchdog thread), the order rotated each turn: {line(packs, 'direct')}; "
        f"results byte-identical | card: {smi}")


class HostWalls:
    """Host-clock seconds of calls, summed by name: each wrapped in place
    (`wrap`) until `close` puts the originals back."""

    def __init__(self):
        self.walls: dict[str, float] = {}
        self._undo = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.walls[name] = self.walls.get(name, 0.0) + time.perf_counter() - t
        setattr(owner, attr, call)
        self._undo.append((owner, attr, fn))

    def take(self) -> dict:
        out, self.walls = self.walls, {}
        return out

    def close(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def provision_phase(smi: str) -> dict:
    """Phase 13 under KARPENTER_INCREMENTAL=0: the full Scheduler path it
    measures (the incremental tick, the default, is phase 14's)."""
    from karpenter_tpu_torch.testing import scoped_env

    with scoped_env({"KARPENTER_INCREMENTAL": "0"}):
        return full_path_phase(smi)


def full_path_phase(smi: str) -> dict:
    """Phase 13: the provisioning path, pending pods in the port's
    in-memory API to NodeClaims, on three problems, each run on the card
    and held against the same run with device="cpu" by the
    name-insensitive decision fingerprint. Returns the kernel launches
    of each problem's card runs."""
    import torch

    from karpenter_tpu_torch import testing, workloads
    from karpenter_tpu_torch.apis.v1.nodepool import NodePool
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.kube.objects import ObjectMeta
    from karpenter_tpu_torch.provisioning import provisioner as prov_mod
    from karpenter_tpu_torch.provisioning import scheduler as sched_mod
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver import resilience
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.solver import topo_batch

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    lowered: list = []  # what topo_batch.prepare gave the topology solves
    real_prepare = topo_batch.prepare

    def recording_prepare(*a, **k):
        tb = real_prepare(*a, **k)
        lowered.append(tb)
        return tb

    topo_batch.prepare = recording_prepare
    walls = HostWalls()
    for owner, attr, name in (
        (topo_batch, "prepare", "topo_batch"),
        (prov_mod.Provisioner, "get_pending_pods", "intake"),
        (prov_mod.Provisioner, "reschedulable_pods_from_deleting_nodes", "intake"),
        (prov_mod.Provisioner, "_make_scheduler", "scheduler"),
        (sched_mod.Scheduler, "solve", "scheduler"),
        (sched_mod, "solve_encoded", "solve_encoded"),
        (prov_mod.Provisioner, "create_node_claims", "create"),
        (prov_mod.Provisioner, "reconcile", "round"),
    ):
        walls.wrap(owner, attr, name)
    # every packing call bracketed by CUDA events: the card's share of
    # a round
    spans: list = []
    seam = solver_mod._solve_packing

    def bracketed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = seam(*a, **k)
        end.record()
        spans.append((start, end))
        return out

    def take(results) -> dict:
        """This round's walls (s, host clock): intake, the Scheduler's
        own host work (its construction and solve without the solves it
        hands to solve_encoded), solve_encoded, claim creation, the whole
        round; and the card's ms inside its packing calls."""
        torch.cuda.synchronize()
        w = walls.take()
        out = {"intake": w.get("intake", 0.0),
               "scheduler_host": w.get("scheduler", 0.0) - w.get("solve_encoded", 0.0),
               "topo_batch": w.get("topo_batch", 0.0),
               "solve_encoded": w.get("solve_encoded", 0.0),
               "create": w.get("create", 0.0),
               "round": w.get("round", w.get("scheduler", 0.0)),
               "card_ms": sum(s.elapsed_time(e) for s, e in spans),
               "packs": len(spans)}
        spans.clear()
        if results.degraded_rungs:
            fail(f"phase 13: a solve was served degraded via {results.degraded_rungs}")
        return out

    def benchmark_rounds(device: str):
        """The benchmark problem's two rounds in a fresh environment."""
        pods, pools = workloads.build_problem(N_PODS, N_TYPES, seed=SEED)
        extra, _ = workloads.build_problem(N_EXTRA, N_TYPES, seed=SEED + 1,
                                           name_prefix="extra-")
        env = testing.pods_env(pods, pools, device=device)
        per_round = []
        walls.take()
        out = testing.reconcile_rounds(env, [extra],
                                       on_round=lambda r: per_round.append(take(r)))
        for k, (results, n) in enumerate(zip(out["results"], (N_PODS, N_PODS + N_EXTRA))):
            if placed_pods(results) != n:
                fail(f"phase 13 round {k + 1} on {device}: {placed_pods(results)} pods "
                     f"placed or unschedulable, {n} pending")
        return out, per_round

    def topology(device: str):
        n_pods, n_services, n_types = TOPOLOGY_PROBLEM
        pool = NodePool(metadata=ObjectMeta(name="default"))
        sched = sched_mod.Scheduler(pools_with_types=[(pool, instance_types(n_types))],
                                    device=device, clock=lambda: testing.CASE_T0)
        pods = workloads.topology_pods(n_pods, n_services)
        walls.take()
        results = sched.solve(pods)
        w = take(results)
        if placed_pods(results) != n_pods:
            fail(f"phase 13 topology on {device}: {placed_pods(results)} of {n_pods} pods")
        return testing.decision_fingerprint(results), results, w

    def mixed(device: str):
        n_pods, n_types, n_tainted = MIXED_PROBLEM
        pods, pools = workloads.mixed_problem(n_pods, n_types, n_tainted)
        env = testing.pods_env(pods, pools, device=device)
        per_round = []
        walls.take()
        out = testing.reconcile_rounds(env, [], on_round=lambda r: per_round.append(take(r)))
        if placed_pods(out["results"][0]) != n_pods:
            fail(f"phase 13 mixed on {device}: {placed_pods(out['results'][0])} of {n_pods} pods")
        return out, per_round[0]

    def cells(rows: list, key: str) -> str:
        vals = [r[key] for r in rows]
        return (f"{key} {statistics.median(vals):.6f} "
                f"[{', '.join(f'{v:.6f}' for v in vals)}]")

    def line(rows: list) -> str:
        return "; ".join(cells(rows, k) for k in (
            "intake", "scheduler_host", "topo_batch", "solve_encoded", "create", "round",
            "card_ms"))

    def nonzero(counts: dict) -> str:
        return json.dumps({k: v for k, v in counts.items() if v})

    launches: dict[str, dict] = {}
    solver_mod._solve_packing = bracketed
    seam_async = solver_mod._solve_packing_async
    solver_mod._solve_packing_async = async_bracket(spans, seam_async)
    try:
        # ---- 13.1 the benchmark problem through the Provisioner: one
        # warm-up environment, then PROVISION_TURNS fresh ones timed
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        runs = [benchmark_rounds("cuda") for _ in range(1 + PROVISION_TURNS)]
        torch.cuda.synchronize()
        launches["provision"] = dict(kernels.LAUNCHES)
        card_s = time.perf_counter() - t0
        ref, cpu_s = CPU_REFS.get("provision")
        for k, (n, want) in enumerate(zip(ref["placed"], (N_PODS, N_PODS + N_EXTRA))):
            if n != want:
                fail(f"phase 13 round {k + 1} on cpu: {n} pods placed or unschedulable, "
                     f"{want} pending")
        if any(ref["degraded"]):
            fail(f"phase 13: a CPU solve was served degraded via {ref['degraded']}")
        for k, (out, _) in enumerate(runs):
            if out["fingerprints"] != ref["fingerprints"]:
                fail(f"phase 13 benchmark problem: card run {k} decides differently "
                     f"from the CPU path's")
        out, _ = runs[0]
        r1, r2 = out["results"]
        c1, c2 = (len(c) for c in out["claims"])
        on_existing = sum(len(v) for v in r2.existing_assignments.values())
        say(f"phase 13 provisioning: {N_PODS} pods x {N_TYPES} types through "
            f"Provisioner.reconcile, then {N_EXTRA} more: round 1 -> {c1} claims, "
            f"{len(r1.errors)} unschedulable; the claims launched (in flight), round 2 "
            f"({N_PODS + N_EXTRA} pending) -> {on_existing} pods on "
            f"{len(r2.existing_assignments)} in-flight claims, {c2} new claims, "
            f"{len(r2.errors)} unschedulable; both rounds' fingerprints equal to "
            f"device=\"cpu\"'s in all {len(runs)} card runs | card runs "
            f"{card_s:.3f}s, CPU run {cpu_s:.3f}s ({CPU_REFS.where('provision')})")
        for k in (0, 1):
            rows = [per_round[k] for _, per_round in runs[1:]]
            say(f"  round {k + 1} walls (s, host clock; card ms in the packing calls), "
                f"median of {PROVISION_TURNS} fresh environments after one warm-up: "
                f"{line(rows)}; packing calls {rows[0]['packs']} | card: {smi}")
        say(f"  launches: {nonzero(launches['provision'])}")

        # ---- 13.2 topology: bench.py's scenario_topology demand through
        # a Scheduler
        t0 = time.perf_counter()
        lowered.clear()
        kernels.reset_launch_counts()
        topo = [topology("cuda") for _ in range(2)]
        torch.cuda.synchronize()
        launches["topology"] = dict(kernels.LAUNCHES)
        topo_ref = topology("cpu")
        if any(fp != topo_ref[0] for fp, _, _ in topo):
            fail("phase 13 topology: the card decides differently from the CPU path")
        tb = lowered[0]
        if tb.conflict is None or not tb.assignments:
            fail("phase 13 topology: the lowering gave no group conflicts or domain pins")
        results = topo[0][1]
        say(f"  topology: workloads.topology_pods{TOPOLOGY_PROBLEM[:2]} over "
            f"instance_types({TOPOLOGY_PROBLEM[2]}) through Scheduler.solve -> "
            f"{len(results.new_node_plans)} nodes, {len(results.errors)} unschedulable; "
            f"equal to device=\"cpu\"'s; lowered: {len(tb.groups)} groups, conflict "
            f"{tuple(tb.conflict.shape)} with {int(tb.conflict.sum())} set, group caps "
            f"{'none' if tb.group_cap is None else int((tb.group_cap < tb.group_cap.max()).sum())}"
            f" below the largest, {len(tb.assignments)} pods pinned to a domain, "
            f"{len(tb.fallback)} to the per-pod loop; second (warm) run: "
            f"{line([topo[1][2]])}; packing calls {topo[1][2]['packs']}; launches "
            f"{nonzero(launches['topology'])} ({time.perf_counter() - t0:.3f}s) | card: {smi}")

        # ---- 13.3 mixed pools: bench.py's scenario_mixed demand through
        # the Provisioner
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        mix = [mixed("cuda") for _ in range(2)]
        torch.cuda.synchronize()
        launches["mixed"] = dict(kernels.LAUNCHES)
        mix_ref, _ = mixed("cpu")
        if any(out["fingerprints"] != mix_ref["fingerprints"] for out, _ in mix):
            fail("phase 13 mixed pools: the card decides differently from the CPU path")
        results = mix[0][0]["results"][0]
        by_pool: dict[str, int] = {}
        for plan in results.new_node_plans:
            by_pool[plan.pool.metadata.name] = by_pool.get(plan.pool.metadata.name, 0) + 1
        say(f"  mixed pools: workloads.mixed_problem{MIXED_PROBLEM} through "
            f"Provisioner.reconcile -> claims by pool {json.dumps(by_pool)}, "
            f"{len(results.errors)} unschedulable; equal to device=\"cpu\"'s; "
            f"second (warm) run: {line([mix[1][1]])}; packing calls "
            f"{mix[1][1]['packs']}; launches {nonzero(launches['mixed'])} "
            f"({time.perf_counter() - t0:.3f}s) | card: {smi}")
    finally:
        solver_mod._solve_packing = seam
        solver_mod._solve_packing_async = seam_async
        walls.close()
        topo_batch.prepare = real_prepare
    for name, n in launches.items():
        if n["pack_split_flat"] < 1 or n["pack_split"] + n["pack_split_wavefront"] < 1:
            fail(f"phase 13 {name} launched {n}: expected a packing kernel and "
                 f"pack_split_flat")
    served = served_by_device("phase 13", since)
    say(f"phase 13: every packing solve served by the device rung "
        f"({json.dumps(served)} ok, the topology and mixed CPU runs' included), none degraded "
        f"({time.perf_counter() - t_phase:.3f}s)")
    return launches


# `--tick`: phases 1-2, then phase 14 alone
TICK = "--tick"
# phase 14: phase 13's two rounds of the benchmark problem, then steady
# rounds each deleting this share of the bound pods (a seeded draw) and
# respawning their shapes (bench.py's steady_state_churn), then quiet
# rounds of a tenth of that churn, whose dirty rows stay under the
# tick's churn gate; rounds with a few arrivals before the micro batch
# (under KARPENTER_MICRO_DUAL=1 the first that rides the tick refreshes
# its dual floor); the pipeline's churn ticks held against
# device="cpu" and timed (8 steady and 4 quiet rounds before phase 17, cut
# for its time)
TICK_STEADY = 4
TICK_CHURN = 0.01
TICK_QUIET = 2
TICK_QUIET_CHURN = 0.001
MICRO_WARM = (2, 20)
MICRO_BATCH = 2000
PIPELINE_HELD = 3
# the pipeline's timed churn ticks and full cost solves: 10 and 3 before
# phase 17, cut for its time
PIPELINE_TIMED = 5
PIPELINE_FULL = 2


def tick_stream(device: str, audit_every=None, on_round=None):
    """Phase 14's stream in a fresh environment: phase 13's two rounds,
    then TICK_STEADY steady rounds of TICK_CHURN and TICK_QUIET quiet
    ones of TICK_QUIET_CHURN (`testing.run_stream`). Returns the
    environment and the stream's record."""
    from karpenter_tpu_torch import testing, workloads
    from karpenter_tpu_torch.testing import StreamRound

    pods, pools = workloads.build_problem(N_PODS, N_TYPES, seed=SEED)
    extra, _ = workloads.build_problem(N_EXTRA, N_TYPES, seed=SEED + 1,
                                       name_prefix="extra-")
    testing.reset_counters(testing.package_api())
    env = testing.pods_env(pods, pools, device=device)
    if audit_every is not None:
        env.provisioner.incremental.audit_every = audit_every
    rounds = [StreamRound(), StreamRound(settle=False, pods=extra)] + [
        StreamRound(delete=TICK_CHURN, respawn=True, pick="seeded", seed=k)
        for k in range(TICK_STEADY)] + [
        StreamRound(delete=TICK_QUIET_CHURN, respawn=True, pick="seeded", seed=100 + k)
        for k in range(TICK_QUIET)]
    return env, testing.run_stream(env, rounds, on_round=on_round)


def micro_continue(env, out, on_warm=None, before_batch=None, on_batch=None) -> tuple:
    """Phase 14's micro path, continuing the stream `out` on `env` under
    KARPENTER_MICRO_DUAL=1: MICRO_WARM[0] rounds of MICRO_WARM[1]
    arrivals, then MICRO_BATCH arrivals through `micro_solve`. Returns
    micro_order's keys per call, the batch's fingerprint, the last
    routes, and the dual floor's lam_by_sig (by repr of its keys)."""
    from karpenter_tpu_torch import testing, workloads
    from karpenter_tpu_torch.testing import StreamRound, scoped_env

    tick = env.provisioner.incremental
    orders: list = []
    real_order = tick.micro_order

    def recording_order(pods):
        got = real_order(pods)
        orders.append([p.key for p in got])
        return got

    tick.micro_order = recording_order
    warm = [StreamRound(pods=workloads.build_problem(
                MICRO_WARM[1], N_TYPES, seed=SEED + 10 + i,
                name_prefix=f"warm{i}-")[0]) for i in range(MICRO_WARM[0])]
    batch = workloads.build_problem(MICRO_BATCH, N_TYPES, seed=SEED + 20,
                                    name_prefix="micro-")[0]
    with scoped_env({"KARPENTER_MICRO_DUAL": "1"}):
        testing.run_stream(env, warm, resume=out,
                           on_round=None if on_warm is None else lambda k, r: on_warm(r))
        dual = tick._dual
        if before_batch is not None:
            before_batch()
        testing.run_stream(env, [StreamRound(pods=batch, micro=True)], resume=out,
                           on_round=None if on_batch is None else lambda k, r: on_batch(r))
    return (orders, out["fingerprints"][-1], out["routes"][-MICRO_WARM[0] - 1:],
            None if dual is None else {repr(k): v for k, v in dual.lam_by_sig.items()})


def pipeline_run(device: str, ticks: int, full: int):
    """Phase 14's `IncrementalPipeline` on build_problem(N_PODS, N_TYPES,
    seed=3), objective cost: the cold tick, then `ticks` ticks of
    TICK_CHURN through the delta API (a seeded draw), the first `full`
    of them also solved whole. Returns the cold tick's and the first
    PIPELINE_HELD churn ticks' rows (mode, reason, fleet price,
    unschedulable, each node's pods), the churn ticks' walls, the whole
    solves (wall, price, unschedulable, the tick's result) and the cold
    tick's wall."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.kube.objects import ObjectMeta, Pod
    from karpenter_tpu_torch.solver import lp_plan
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.solver.incremental import IncrementalPipeline
    from karpenter_tpu_torch.testing import root_node_mips

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    pods, pools = workloads.build_problem(N_PODS, N_TYPES, seed=3)
    rng = np.random.default_rng(17)
    solver_mod.reset_caches()
    pipe = IncrementalPipeline(full_every=0, device=device)
    rows, inc, whole = [], [], []

    def row(r) -> tuple:
        return (r.mode, r.reason, round(r.fleet_price, 6), r.unschedulable,
                sorted(tuple(sorted(n.pods)) for n in pipe._fleet))

    budget = lp_plan._TIME_BUDGET_S
    lp_plan._TIME_BUDGET_S = 1e4
    try:
        with root_node_mips():
            t1 = time.perf_counter()
            r = pipe.solve_tick(pods, pools, objective="cost")
            cold = time.perf_counter() - t1
    finally:
        lp_plan._TIME_BUDGET_S = budget
    rows.append(row(r))
    for t in range(ticks):
        k = max(1, int(len(pods) * TICK_CHURN))
        drop = rng.choice(len(pods), size=k, replace=False).tolist()
        dropset = set(drop)
        born = [Pod(metadata=ObjectMeta(name=f"churn-{t}-{j}"), spec=pods[i].spec)
                for j, i in enumerate(drop)]
        removed = [pods[i].key for i in drop]
        pods = [p for i, p in enumerate(pods) if i not in dropset] + born
        sync()
        t1 = time.perf_counter()
        r = pipe.solve_tick(pods, pools, objective="cost", delta=(born, removed))
        sync()
        inc.append(time.perf_counter() - t1)
        if t < PIPELINE_HELD:
            rows.append(row(r))
        if t < full:
            t1 = time.perf_counter()
            sol = solver_mod.solve(pods, pools, objective="cost", device=device)
            sync()
            whole.append((time.perf_counter() - t1, float(sol.total_price),
                          len(sol.unschedulable), r))
    return rows, inc, whole, cold


def tick_phase(smi: str) -> dict:
    """Phase 14: the incremental tick, the Provisioner's default path,
    on phase 13's problem and steady churn after it (card against
    device="cpu", the tick against KARPENTER_INCREMENTAL=0, every
    round audited in a third run), the micro path with its dual floor,
    and `IncrementalPipeline` at 50k x 500 under 1% churn. Returns the
    kernel launches of each part's card runs."""
    import torch

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.metrics.store import INCREMENTAL_AUDITS
    from karpenter_tpu_torch.provisioning import incremental_tick as tick_mod
    from karpenter_tpu_torch.provisioning import provisioner as prov_mod
    from karpenter_tpu_torch.provisioning import scheduler as sched_mod
    from karpenter_tpu_torch.solver import lp_device, lp_plan, resilience
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.testing import scoped_env

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    walls = HostWalls()
    for owner, attr, name in (
        (tick_mod.IncrementalTickScheduler, "_sync", "sync"),
        (tick_mod.IncrementalTickScheduler, "_solve", "tick_solve"),
        (tick_mod, "solve_encoded", "tick_solve_encoded"),
        (tick_mod.IncrementalTickScheduler, "_audit", "audit"),
        (prov_mod.Provisioner, "_make_scheduler", "scheduler"),
        (sched_mod.Scheduler, "solve", "scheduler"),
        (sched_mod, "solve_encoded", "solve_encoded"),
        (prov_mod.Provisioner, "create_node_claims", "create"),
        (prov_mod.Provisioner, "reconcile", "round"),
        (prov_mod.Provisioner, "micro_solve", "round"),
        (testing, "settle", "settle"),
    ):
        walls.wrap(owner, attr, name)
    spans: list = []
    seam = solver_mod._solve_packing

    def bracketed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = seam(*a, **k)
        end.record()
        spans.append((start, end))
        return out

    def take(results) -> dict:
        """This round's walls (s, host clock): the tick's sync, its host
        work (`_solve` less its solve_encoded calls) and solve_encoded;
        the full path's Scheduler host work and solve_encoded (the
        shadow audit's included); the audit; claim creation; the
        stream's settle before the round (the harness's registrations
        and bindings); the whole reconcile; the card's ms in the packing
        calls."""
        torch.cuda.synchronize()
        w = walls.take()
        out = {"sync": w.get("sync", 0.0),
               "tick_host": w.get("tick_solve", 0.0) - w.get("tick_solve_encoded", 0.0),
               "tick_solve_encoded": w.get("tick_solve_encoded", 0.0),
               "full_host": w.get("scheduler", 0.0) - w.get("solve_encoded", 0.0),
               "full_solve_encoded": w.get("solve_encoded", 0.0),
               "audit": w.get("audit", 0.0), "create": w.get("create", 0.0),
               "settle": w.get("settle", 0.0), "round": w.get("round", 0.0),
               "card_ms": sum(s.elapsed_time(e) for s, e in spans), "packs": len(spans)}
        spans.clear()
        if results is not None and results.degraded_rungs:
            fail(f"phase 14: a solve was served degraded via {results.degraded_rungs}")
        return out

    def reset_launches() -> None:
        kernels.reset_launch_counts()
        for table in (lp_device.LAUNCHES, lp_plan.LAUNCHES):
            for name in table:
                table[name] = 0

    def read_launches() -> dict:
        torch.cuda.synchronize()
        out = dict(kernels.LAUNCHES)
        out.update(lp_device.LAUNCHES)
        out.update(lp_plan.LAUNCHES)
        return out

    def nonzero(counts: dict) -> str:
        return json.dumps({k: v for k, v in counts.items() if v})

    def stream(device: str, audit_every=None):
        per_round: list = []
        walls.take()
        spans.clear()
        env, out = tick_stream(device, audit_every,
                               on_round=lambda k, r: per_round.append(take(r)))
        return env, out, per_round

    def route(r: list) -> str:
        return "+".join(f"{p}/{why}" for p, why in r) or "full/disabled"

    def cells(rows: list, keys) -> str:
        return ", ".join(f"{k} {rows[k]:.6f}" if isinstance(rows[k], float)
                         else f"{k} {rows[k]}" for k in keys)

    launches: dict[str, dict] = {}
    solver_mod._solve_packing = bracketed
    seam_async = solver_mod._solve_packing_async
    solver_mod._solve_packing_async = async_bracket(spans, seam_async)
    try:
        # ---- 14.1 the tick at 50k x 500: rounds 1-2 and steady churn
        t0 = time.perf_counter()
        reset_launches()
        card_env, card, card_walls = stream("cuda")
        launches["tick"] = read_launches()
        card_s = time.perf_counter() - t0
        ref, cpu_s = CPU_REFS.get("tick")
        if any(ref["degraded"]):
            fail(f"phase 14: a CPU solve was served degraded via {ref['degraded']}")
        cpu = ref["stream"]
        for k in range(len(card["results"])):
            if card["fingerprints"][k] != cpu["fingerprints"][k]:
                fail(f"phase 14 round {k + 1}: the card decides differently from "
                     f"device=\"cpu\"")
            if card["routes"][k] != cpu["routes"][k]:
                fail(f"phase 14 round {k + 1}: route {card['routes'][k]} on the card, "
                     f"{cpu['routes'][k]} on the CPU")
        t0 = time.perf_counter()
        with scoped_env({"KARPENTER_INCREMENTAL": "0"}):
            _, full, full_walls = stream("cuda")
        full_s = time.perf_counter() - t0
        for k in range(len(card["results"])):
            if full["fingerprints"][k] != card["fingerprints"][k]:
                fail(f"phase 14 round {k + 1}: the tick decides differently from the "
                     f"full path (KARPENTER_INCREMENTAL=0) on the card")
        t0 = time.perf_counter()
        before = dict(INCREMENTAL_AUDITS.samples())
        audit_env, audited, audit_walls = stream("cuda", audit_every=1)
        audits: dict = {}
        for labels, n in INCREMENTAL_AUDITS.samples():
            n -= before.get(labels, 0.0)
            if n:
                key = f"{dict(labels)['verdict']}/{dict(labels)['trigger']}"
                audits[key] = audits.get(key, 0) + int(n)
        audit_s = time.perf_counter() - t0
        st = audit_env.provisioner.incremental.status()
        if st["divergences"] or st["quarantined"] or any(
                not k.startswith("ok/") for k in audits):
            fail(f"phase 14: an audit under audit_every=1 was not clean: {audits}, "
                 f"divergences {st['divergences']}, quarantined {st['quarantined']}")
        if audited["fingerprints"] != card["fingerprints"]:
            fail("phase 14: the audited stream decides differently from the tick's")
        on_tick = [any(p == "incremental" for p, _ in r) for r in card["routes"]]
        steady = sum(on_tick[2:2 + TICK_STEADY])
        quiet = sum(on_tick[2 + TICK_STEADY:])
        status = card_env.provisioner.incremental.status()
        say(f"phase 14 tick: {N_PODS} pods x {N_TYPES} types, then {N_EXTRA} more "
            f"(claims in flight), then {TICK_STEADY} steady rounds of {TICK_CHURN:.0%} "
            f"churn and {TICK_QUIET} quiet rounds of {TICK_QUIET_CHURN:.1%} through "
            f"Provisioner(device=\"cuda\").reconcile with the tick on: every round's "
            f"decisions and route equal to device=\"cpu\"'s; equal to "
            f"KARPENTER_INCREMENTAL=0 on the card; under audit_every=1 every audit "
            f"clean ({json.dumps(audits)}); on the incremental path: {steady} of "
            f"{TICK_STEADY} steady rounds, {quiet} of {TICK_QUIET} quiet ones; fallbacks "
            f"{json.dumps(status['fallbacks'])} | tick run {card_s:.3f}s, CPU "
            f"{cpu_s:.3f}s with the micro path ({CPU_REFS.where('tick')}), full path "
            f"{full_s:.3f}s, audited {audit_s:.3f}s")
        if not steady + quiet:
            fail("phase 14: no round after the first two rode the incremental path")
        tick_keys = ("sync", "tick_host", "tick_solve_encoded", "full_host",
                     "full_solve_encoded", "create", "settle", "round", "card_ms", "packs")
        full_keys = ("full_host", "full_solve_encoded", "create", "round", "card_ms")
        for k, (tw, fw) in enumerate(zip(card_walls, full_walls)):
            res = card["results"][k]
            say(f"  round {k + 1} ({route(card['routes'][k])}; "
                f"{len(card['deleted'][k])} deleted, {len(card['respawned'][k])} "
                f"respawned; {len(res.new_node_plans)} new claims, "
                f"{sum(len(v) for v in res.existing_assignments.values())} pods on "
                f"existing nodes, {len(res.errors)} unschedulable): tick {cells(tw, tick_keys)}"
                f" | full path {cells(fw, full_keys)} | audited round "
                f"{audit_walls[k]['round']:.6f} (audit {audit_walls[k]['audit']:.6f}) "
                f"| card: {smi}")
        say(f"  launches (the tick's card run): {nonzero(launches['tick'])}")

        # ---- 14.2 the micro path with its dual floor, continuing the
        # card's stream (the CPU's continues in the CPU reference)
        t0 = time.perf_counter()
        reset_launches()
        micro: dict = {}
        card_m = micro_continue(card_env, card, on_warm=take, before_batch=walls.take,
                                on_batch=lambda r: micro.setdefault("walls", take(r)))
        launches["micro"] = read_launches()
        cpu_m = ref["micro"]
        if card_m[3] is None:
            fail(f"phase 14 micro: no tick refreshed the dual floor (routes "
                 f"{card_m[2]})")
        if card_m[1] is None:
            fail(f"phase 14 micro: the batch was deferred ({card_m[2][-1]})")
        for i, what in enumerate(("micro_order", "decisions", "routes", "lam_by_sig")):
            if card_m[i] != cpu_m[i]:
                fail(f"phase 14 micro: the card's {what} differs from device=\"cpu\"'s")
        res = card["results"][-1]
        gap = 0
        if card_m[0]:
            keys = card_m[0][-1]
            gap = sum(a != b for a, b in zip(keys, sorted(keys)))
        mw = micro["walls"]
        say(f"  micro: KARPENTER_MICRO_DUAL=1, {MICRO_WARM[0]} rounds of "
            f"{MICRO_WARM[1]} arrivals ({', '.join(route(r) for r in card_m[2][:-1])}), "
            f"the dual floor refreshed on the card ({len(card_m[3])} signatures), then "
            f"{MICRO_BATCH} arrivals through Provisioner.micro_solve "
            f"({route(card_m[2][-1])}): {len(res.new_node_plans)} new claims, "
            f"{sum(len(v) for v in res.existing_assignments.values())} pods on existing "
            f"nodes, {len(res.errors)} unschedulable; micro_order ({gap} of "
            f"{MICRO_BATCH} moved from arrival order), decisions and lam_by_sig equal to "
            f"device=\"cpu\"'s; walls {cells(mw, ('sync', 'tick_host', 'tick_solve_encoded', 'create', 'round', 'card_ms', 'packs'))}; "
            f"launches {nonzero(launches['micro'])} ({time.perf_counter() - t0:.3f}s) "
            f"| card: {smi}")

        # ---- 14.3 IncrementalPipeline at 50k x 500, 1% churn, objective
        # cost, the delta API (bench.py's steady_state_churn)
        t0 = time.perf_counter()
        reset_launches()
        spans.clear()
        rows, inc, whole, cold = pipeline_run("cuda", PIPELINE_TIMED, PIPELINE_FULL)
        launches["pipeline"] = read_launches()
        card_ms = sum(s.elapsed_time(e) for s, e in spans)
        spans.clear()
        card_p = time.perf_counter() - t0
        (cpu_rows, cpu_cold), cpu_p = CPU_REFS.get("pipeline")
        for t, (a, b) in enumerate(zip(rows, cpu_rows)):
            if a != b:
                fail(f"phase 14 pipeline: tick {t} ({a[:4]}) differs from "
                     f"device=\"cpu\"'s ({b[:4]})")
        solver_mod.reset_caches()
        p50 = statistics.median(inc)
        full_p50 = statistics.median(w for w, _, _, _ in whole)
        drift = [f"{r.fleet_price / price - 1:+.6f}" for _, price, _, r in whole]
        say(f"  pipeline: IncrementalPipeline(full_every=0) on build_problem({N_PODS}, "
            f"{N_TYPES}, seed=3), objective cost, {TICK_CHURN:.0%} churn a tick through "
            f"the delta API: the cold tick ({rows[0][1]}, ${rows[0][2]:.6f}/h, "
            f"{len(rows[0][4])} nodes, {cold:.3f}s on the card, {cpu_cold:.3f}s on the "
            f"CPU) and {PIPELINE_HELD} churn ticks equal to device=\"cpu\"'s (fleet price, "
            f"unschedulable, each node's pods); {PIPELINE_TIMED} churn ticks p50 "
            f"{p50:.6f}s [{', '.join(f'{w:.6f}' for w in inc)}] against a full "
            f"solve(objective=\"cost\") of the same pods p50 {full_p50:.6f}s "
            f"[{', '.join(f'{w:.6f}' for w, _, _, _ in whole)}] over the first "
            f"{PIPELINE_FULL}, the tick's fleet price against the full solve's "
            f"{', '.join(drift)}; card ms in the packing calls {card_ms:.3f}; launches "
            f"{nonzero(launches['pipeline'])} | card run {card_p:.3f}s, CPU {cpu_p:.3f}s "
            f"({CPU_REFS.where('pipeline')}) | card: {smi}")
    finally:
        solver_mod._solve_packing = seam
        solver_mod._solve_packing_async = seam_async
        walls.close()
    for name in ("tick", "micro", "pipeline"):
        n = launches.get(name, {})
        if n.get("pack_split_flat", 0) < 1 or n.get("pack_split", 0) + n.get(
                "pack_split_wavefront", 0) < 1:
            fail(f"phase 14 {name} launched {n}: expected a packing kernel and "
                 f"pack_split_flat")
    if launches["micro"].get("lp_ascend", 0) < 1:
        fail(f"phase 14 micro: the dual floor launched no B5 ({launches['micro']})")
    served = served_by_device("phase 14", since)
    say(f"phase 14: every packing solve served by the device rung "
        f"({json.dumps(served)} ok; the CPU references run in their worker), none "
        f"degraded ({time.perf_counter() - t_phase:.3f}s)")
    return launches


DISRUPT = "--disrupt"
# phase 15: bench.py's consolidation fleet (`workloads.consolidation_fleet`'s
# build_problem(21000, 200, seed=9)) as a live cluster: provisioned on the
# card through Provisioner.reconcile and settled, DISRUPT_DROP of its pods
# deleted (consolidation_fleet's own draw, default_rng(7)), then rounds of
# DisruptionEngine.reconcile and the queue (`testing.disruption_rounds`)
# until a round decides nothing; the same stream on MID_FLEET on the card
# and on the CPU; one reconcile round on the registered 50k x 500 fleet
# with the retained seam warm and with KARPENTER_DISRUPTION_SNAPSHOT=0
DISRUPT_FLEET = (21_000, 200, 9)
DISRUPT_DROP = 0.55
DISRUPT_ROUNDS = 12
ENGINE_METHODS = ("emptiness", "drift", "global_repack_consolidation",
                  "multi_node_consolidation", "single_node_consolidation")
B6_KERNELS = ("pack_probe_lanes", "pack_probe_lanes_wavefront")
B6_EPILOGUES = ("pack_probe_lanes_flat", "pack_probe_lanes_flat_masks")


def disruption_fleet(device: str, n_pods: int, n_types: int, seed: int, t0: float,
                     drop: float = DISRUPT_DROP):
    """`build_problem(n_pods, n_types, seed)`'s pods (each owned by a
    ReplicaSet, so that a drained pod comes back pending) provisioned
    through `Provisioner(device=device).reconcile` at t0 and settled
    (`testing.place`), the disruption engine attached, then each pod
    deleted with probability `drop` (consolidation_fleet's draw)."""
    import numpy as np

    from karpenter_tpu_torch import testing, workloads
    from karpenter_tpu_torch.kube.objects import OwnerReference

    pods, pools = workloads.build_problem(n_pods, n_types, seed=seed)
    for pod in pods:
        name = pod.metadata.name
        pod.metadata.owner_references = [OwnerReference(
            kind="ReplicaSet", name=f"{name}-rs", uid=f"uid-{name}-rs", controller=True)]
    testing.reset_counters(testing.package_api())
    env = testing.disruption_env(testing.pods_env(pods, pools, device=device))
    testing.place(env, t0)
    if drop:
        keep = np.random.default_rng(7).random(len(pods)) >= drop
        for pod, k in zip(pods, keep):
            if not k:
                env.kube.delete(pod, now=t0 + 50)
    return env


def disrupt_phase(smi: str, card: str = "cuda") -> dict:
    """Phase 15: the consolidation engine (`disruption/engine.py`) on the
    card. Holds: the stream decides round for round as with
    KARPENTER_BATCH_PROBES=0 and with KARPENTER_LP_PRUNE=0 (round 1 of
    fresh streams, and the probe methods on the final fleet), the first
    B6 chunk the engine dispatches is byte-identical to its plain
    version, the mid fleet's stream on the card equals device="cpu"'s,
    and at 50k x 500 the retained seam decides as a fresh scan. Returns
    the kernel launches of the main stream (counts zeroed just before
    it, read just after)."""
    import random

    import torch

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.disruption import engine as engine_mod
    from karpenter_tpu_torch.metrics.store import DISRUPTION_EVALUATION_DURATION as EVALS
    from karpenter_tpu_torch.solver import consolidation_batch as cb
    from karpenter_tpu_torch.solver import lp_device, lp_plan, resilience
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver import solver as solver_mod
    from karpenter_tpu_torch.testing import scoped_env

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    T = testing.DISRUPTION_T0
    walls = HostWalls()

    def evaluations() -> dict:
        """Each method's (evaluations, seconds) so far, from the
        engine's own DISRUPTION_EVALUATION_DURATION{method}."""
        return {m: (EVALS.count({"method": m}), EVALS.sum({"method": m}))
                for m in ENGINE_METHODS}

    mark = [evaluations()]

    def method_walls(command) -> tuple[dict, list]:
        """Each method's seconds in `reconcile` since the last call, and
        the method that decided `command`: reconcile stops at the first
        method that returns one, the last evaluated."""
        now, last = evaluations(), mark[0]
        mark[0] = now
        ran = [m for m in ENGINE_METHODS if now[m][0] > last[m][0]]
        return ({m: now[m][1] - last[m][1] for m in ENGINE_METHODS},
                ran[-1:] if command is not None else [])

    for owner, attr, name in (
        (engine_mod.DisruptionEngine, "get_candidates", "scan"),
        (lp_plan, "plan", "plan"),
        (lp_device, "maybe_solve", "lp"),
        (engine_mod.OrchestrationQueue, "reconcile", "queue"),
        (testing, "terminate", "terminate"),
        (testing, "place", "place"),
    ):
        walls.wrap(owner, attr, name)
    # the card's ms in the packing calls: the Scheduler's solves (through
    # the ladder's seam) and the lane solver's chunk dispatches
    spans: list = []
    inside = [0]
    seam = solver_mod._solve_packing
    real_split_flat, real_lanes_flat = kernels.pack_split_flat, kernels.pack_probe_lanes_flat
    first_chunk_rec: list = []

    def bracket(fn, lane: bool):
        """CUDA events around `fn` (a lane-solver wrapper when `lane`:
        not bracketed again inside a bracketed Scheduler solve); the
        first B6 chunk's inputs and output are kept."""
        def call(*a, **k):
            if lane and inside[0]:
                return fn(*a, **k)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            inside[0] += 0 if lane else 1
            start.record()
            try:
                out = fn(*a, **k)
            finally:
                inside[0] -= 0 if lane else 1
            end.record()
            spans.append((start, end))
            if fn is real_lanes_flat and not first_chunk_rec:
                first_chunk_rec.append((a, dict(k), out.clone()))
            return out
        return call

    # the probe counters when the current round began
    probe_mark = [cb.probe_counts()]

    def take_round(k, rnd) -> dict:
        torch.cuda.synchronize()
        w = walls.take()
        per_method, decided = method_walls(rnd["command"])
        stats = cb.probe_counts(since=probe_mark[0])
        probe_mark[0] = cb.probe_counts()
        out = {"walls": {**w, **per_method},
               "card_ms": sum(s.elapsed_time(e) for s, e in spans),
               "packs": len(spans), "lanes": stats["lane"], "dispatches": stats["batch"],
               "decided": decided}
        spans.clear()
        placed = rnd["placed"]
        if placed is not None and placed.degraded_rungs:
            fail(f"phase 15: a solve was served degraded via {placed.degraded_rungs}")
        return out

    def reset_launches() -> None:
        kernels.reset_launch_counts()
        for table in (lp_device.LAUNCHES, lp_plan.LAUNCHES):
            for name in table:
                table[name] = 0

    def read_launches() -> dict:
        torch.cuda.synchronize()
        out = dict(kernels.LAUNCHES)
        out.update(lp_device.LAUNCHES)
        out.update(lp_plan.LAUNCHES)
        return out

    def stream(device, fleet, env=None, max_rounds=DISRUPT_ROUNDS, per=None):
        env = env or disruption_fleet(device, *fleet, T)
        per = [] if per is None else per
        walls.take()
        method_walls(None)
        spans.clear()
        probe_mark[0] = cb.probe_counts()
        rounds = testing.disruption_rounds(
            env, T + 100, max_rounds=max_rounds,
            on_round=lambda k, r: per.append(take_round(k, r)))
        return env, rounds

    def summary(rnd) -> str:
        ident = rnd["identity"]
        if ident is None:
            return "nothing"
        return (f"{ident[0]}: {len(ident[1])} candidates, {len(ident[2])} replacements"
                + (" (stalled: the same command rolled back again)" if rnd["stalled"] else ""))

    def probe_pass(env, now) -> tuple[dict, dict]:
        """The probe methods on one fleet, with the batch and the
        pruner on (the defaults): each decision as a name-insensitive
        identity, and each method's wall (s)."""
        out, secs = {}, {}
        for name in ("multi_node_consolidation", "single_node_consolidation"):
            env.disruption._rng = random.Random(0)
            t = time.perf_counter()
            out[name] = testing.command_identity(getattr(env.disruption, name)(now))
            secs[name] = time.perf_counter() - t
        return out, secs

    launches: dict = {}
    solver_mod._solve_packing = bracket(seam, lane=False)
    seam_async = solver_mod._solve_packing_async
    solver_mod._solve_packing_async = async_bracket(spans, seam_async)
    kernels.pack_split_flat = bracket(real_split_flat, lane=True)
    kernels.pack_probe_lanes_flat = bracket(real_lanes_flat, lane=True)
    try:
        # ---- 15.1 the consolidation fleet on the card, to the end
        t0 = time.perf_counter()
        env = disruption_fleet(card, *DISRUPT_FLEET, T)
        fleet_s = time.perf_counter() - t0
        nodes0 = len(env.kube.nodes())
        pods0 = sum(1 for p in env.kube.pods() if p.spec.node_name)
        before = testing.fleet_state(env)
        t0 = time.perf_counter()
        per: list = []
        reset_launches()
        with b6_wavefront_shapes(kernels) as engine_shapes:
            env, rounds = stream(card, DISRUPT_FLEET, env=env, per=per)
        final_now = T + 100 * len(rounds) + 100
        env.pod_events.reconcile_all(now=final_now)
        env.conditions.reconcile_all(now=final_now)
        walls.take()
        spans.clear()
        probe_mark[0] = cb.probe_counts()
        t1 = time.perf_counter()
        probes, probe_walls = probe_pass(env, final_now)
        probe_s = time.perf_counter() - t1
        probe_stats = cb.probe_counts(since=probe_mark[0])
        walls.take()
        torch.cuda.synchronize()
        probe_ms = sum(s.elapsed_time(e) for s, e in spans)
        spans.clear()
        launches["engine"] = read_launches()
        card_s = time.perf_counter() - t0
        after = rounds[-1]["fleet"]
        say(f"phase 15 disruption: build_problem{DISRUPT_FLEET} provisioned through "
            f"Provisioner(device=\"{card}\").reconcile and settled -> {nodes0} nodes, "
            f"${before[2]:.6f}/h; {DISRUPT_DROP:.0%} of the pods deleted -> {pods0} left "
            f"bound ({fleet_s:.3f}s to build); {len(rounds)} rounds of "
            f"DisruptionEngine.reconcile + the queue -> {len(after[0])} nodes, "
            f"${after[2]:.6f}/h, {len(after[1])} pods pending ({card_s:.3f}s) | card: {smi}")
        for k, (rnd, row) in enumerate(zip(rounds, per)):
            w = row["walls"]
            methods = ", ".join(f"{m.split('_')[0] if m != 'global_repack_consolidation' else 'global'}"
                                f" {w.get(m, 0.0):.6f}" for m in ENGINE_METHODS)
            say(f"  round {k + 1}: {'/'.join(row['decided']) or 'no method'} decided "
                f"{summary(rnd)}; fleet {len(rnd['fleet'][0])} nodes ${rnd['fleet'][2]:.6f}/h"
                f" | walls (s) {methods}, scan {w.get('scan', 0.0):.6f}, column generation "
                f"{w.get('plan', 0.0):.6f}, device LP {w.get('lp', 0.0):.6f}, queue "
                f"{w.get('queue', 0.0):.6f}, terminate {w.get('terminate', 0.0):.6f}, "
                f"place {w.get('place', 0.0):.6f} | card {row['card_ms']:.3f} ms in "
                f"{row['packs']} packing calls | B6 {row['lanes']} lanes, "
                f"{row['dispatches']} dispatches")
        say(f"  probe pass on the final fleet (batch and pruner on): "
            f"{json.dumps({k: summary({'identity': v, 'stalled': False}) for k, v in probes.items()})}"
            f" | walls multi {probe_walls.get('multi_node_consolidation', 0.0):.6f}s, single "
            f"{probe_walls.get('single_node_consolidation', 0.0):.6f}s ({probe_s:.3f}s), card "
            f"{probe_ms:.3f} ms, B6 {probe_stats['lane']} lanes, {probe_stats['batch']} "
            f"dispatches")
        n = launches["engine"]
        say(f"  launches (counts zeroed before the stream, read after the probe pass): "
            f"{json.dumps({k: v for k, v in n.items() if v})}")
        missing = [what for what, names in (
            ("B6", B6_KERNELS), ("the lane epilogue", B6_EPILOGUES),
            ("B5", ("lp_ascend",)), ("B4", ("lp_price",)),
            ("B3 or B1", ("pack_split_wavefront", "pack_split")),
            ("B2", ("pack_split_flat",))) if not sum(n.get(x, 0) for x in names)]
        if missing:
            fail(f"phase 15: the engine launched no {', '.join(missing)}: {n}")
        if not any(r["command"] is not None for r in rounds):
            fail("phase 15: no round decided anything")

        # ---- 15.2 the first B6 chunk the engine dispatched, against its
        # plain version
        if not first_chunk_rec:
            fail("phase 15: the engine dispatched no B6 chunk")
        a, kw, got = first_chunk_rec[0]
        host = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
        want = kernels.pack_probe_lanes_flat_ref(
            *[host(x) for x in a], **{key: host(v) for key, v in kw.items()})
        if not same_bits(got.cpu(), want):
            fail("phase 15: the engine's first B6 chunk differs from its plain version")
        say(f"  first B6 chunk (L={a[2].shape[0]}, Gp={a[0].shape[0]}, Cp={a[0].shape[1]}, "
            f"wavefront {kw.get('wavefront', 0)}): byte-identical to "
            f"pack_probe_lanes_flat_ref")
        if engine_shapes:
            say(hold_b6_shapes(kernels, engine_shapes, "phase 15's stream"))

        # ---- 15.3 the same stream's first round with the batch off and
        # with the pruner off; the probe methods on the final fleet so
        t0 = time.perf_counter()
        holds = []
        for knob in ("KARPENTER_BATCH_PROBES", "KARPENTER_LP_PRUNE"):
            with scoped_env({knob: "0"}):
                _, other = stream(card, DISRUPT_FLEET, max_rounds=1)
                if other[0]["identity"] != rounds[0]["identity"]:
                    fail(f"phase 15: round 1 with {knob}=0 decided "
                         f"{summary(other[0])}, the default {summary(rounds[0])}")
                again = {}
                for name in probes:
                    if knob == "KARPENTER_BATCH_PROBES" and name == "single_node_consolidation":
                        continue  # one full scheduling solve a candidate
                    env.disruption._rng = random.Random(0)
                    again[name] = testing.command_identity(
                        getattr(env.disruption, name)(final_now))
                    if again[name] != probes[name]:
                        fail(f"phase 15: {name} on the final fleet with {knob}=0 "
                             f"decided otherwise")
                holds.append(f"{knob}=0: round 1 and {', '.join(again)} equal")
        say(f"  holds: {'; '.join(holds)} ({time.perf_counter() - t0:.3f}s)")

        # ---- 15.4 the mid fleet: card against device="cpu", round for round
        mid = (MID_FLEET[0], MID_FLEET[1], DISRUPT_FLEET[2])
        t0 = time.perf_counter()
        _, mid_card = stream(card, mid)
        mid_card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, mid_cpu = stream("cpu", mid)
        mid_cpu_s = time.perf_counter() - t0
        for k, (x, y) in enumerate(zip(mid_card, mid_cpu)):
            if (x["identity"], x["fleet"]) != (y["identity"], y["fleet"]):
                fail(f"phase 15 mid fleet round {k + 1}: the card decides "
                     f"{summary(x)}, device=\"cpu\" {summary(y)}")
        if len(mid_card) != len(mid_cpu):
            fail(f"phase 15 mid fleet: {len(mid_card)} rounds on the card, "
                 f"{len(mid_cpu)} on the CPU")
        say(f"  mid fleet build_problem{mid}: {len(mid_card)} rounds "
            f"({'; '.join(summary(r) for r in mid_card)}) -> "
            f"{len(mid_card[-1]['fleet'][0])} nodes ${mid_card[-1]['fleet'][2]:.6f}/h, "
            f"decisions and fleets equal to device=\"cpu\"'s round for round | card "
            f"{mid_card_s:.3f}s, CPU {mid_cpu_s:.3f}s")

        # ---- 15.5 the registered 50k x 500 fleet: one reconcile round
        # with the retained seam warm, and with it off, each deciding
        # on the same fleet (the queue records the command, starts none)
        t0 = time.perf_counter()
        big = disruption_fleet(card, N_PODS, N_TYPES, SEED, T, drop=0.0)
        build_s = time.perf_counter() - t0
        now = T + 100
        big.pod_events.reconcile_all(now=now)
        big.conditions.reconcile_all(now=now)
        started: list = []
        big.disruption.queue.start_command = lambda cmd, now=None: started.append(cmd)
        scale = {}
        for label, knobs in (("retained", {}), ("fresh", {"KARPENTER_DISRUPTION_SNAPSHOT": "0"})):
            with scoped_env(knobs):
                solver_mod.reset_caches()
                lp_device.reset()
                warm = 0.0
                if label == "retained":
                    t0 = time.perf_counter()
                    big.disruption.get_candidates("Underutilized", now)
                    warm = time.perf_counter() - t0
                walls.take()
                method_walls(None)
                t0 = time.perf_counter()
                big.disruption._rng = random.Random(0)
                cmd = big.disruption.reconcile(now=now)
                wall = time.perf_counter() - t0
                w = walls.take()
                scale[label] = (testing.command_identity(cmd), wall, w, warm, build_s,
                                method_walls(cmd)[1], len(big.kube.nodes()),
                                big.disruption.fleet_seam.status())
        del big
        if scale["retained"][0] != scale["fresh"][0]:
            fail("phase 15: at 50k x 500 the retained seam decides otherwise than "
                 "KARPENTER_DISRUPTION_SNAPSHOT=0")
        r, f = scale["retained"], scale["fresh"]
        say(f"  50k x 500 registered fleet ({r[6]} nodes): one reconcile round decided by "
            f"{'/'.join(r[5]) or 'no method'} "
            f"{summary({'identity': r[0], 'stalled': False})}, equal with "
            f"KARPENTER_DISRUPTION_SNAPSHOT=0 | scan walls (s): retained "
            f"{r[2].get('scan', 0.0):.6f} (after a warm-up scan of {r[3]:.6f}), fresh "
            f"{f[2].get('scan', 0.0):.6f}; round {r[1]:.6f} against {f[1]:.6f}; seam "
            f"{json.dumps(r[7])} | the fleet built in {r[4]:.3f}s | card: {smi}")
    finally:
        solver_mod._solve_packing = seam
        solver_mod._solve_packing_async = seam_async
        kernels.pack_split_flat, kernels.pack_probe_lanes_flat = real_split_flat, real_lanes_flat
        walls.close()
    served = served_by_device("phase 15", since)
    say(f"phase 15: every packing solve served by the device rung "
        f"({json.dumps(served)} ok, the CPU runs' included), none degraded "
        f"({time.perf_counter() - t_phase:.3f}s)")
    return launches


WARM = "--warm"
# the warm phase's ladder check: the device breaker opened by two injected
# device faults on this problem, then closed by a half-open success whose
# close gate launches the warm pool's canary (KARPENTER_REWARM_ON_CLOSE=1)
REWARM_PROBLEM = (200, 20, 7)
# the ladder counts the warm phase's injected faults leave: later phases'
# device-served checks count from here
LADDER_BASE: dict = {}


def warm_phase(smi: str) -> dict:
    """The warm phase: `warm_pool.warm()` on the card over its default
    buckets (DEFAULT_SHAPES in both modes, with and without the topology
    inputs, the default probe buckets, the dual-ascent buckets): every
    bucket must launch (`karpenter_solver_warm_compiles_total` shows no
    `error`) and none may be skipped (B5's wide layout takes the two
    4096-config dual-ascent buckets); each bucket's wall and each
    kernel's first launch in the process against its second (a second
    `warm()` pass launches every canary again). Then
    `rewarm_canary` as the ladder's close gate: two injected device
    faults open the device breaker, a half-open success closes it only
    after the canary launched on the card. Returns the warm pool's
    launches and walls."""
    import torch

    from karpenter_tpu_torch.metrics.store import SOLVER_WARM_COMPILES
    from karpenter_tpu_torch.solver import faults, lp_device, resilience, warm_pool
    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver.encode import encode, group_pods
    from karpenter_tpu_torch.solver.resilience import STATE_CLOSED, STATE_OPEN
    from karpenter_tpu_torch.testing import scoped_env
    from karpenter_tpu_torch.workloads import build_problem

    def outcomes() -> dict:
        return {o: SOLVER_WARM_COMPILES.value({"outcome": o}) for o in ("ok", "error")}

    def launch_counts() -> dict:
        return {**kernels.LAUNCHES, **lp_device.LAUNCHES}

    t_phase = time.perf_counter()
    before, counts0 = outcomes(), launch_counts()
    warm_pool.reset()
    with scoped_env({"KARPENTER_WARM_SHAPES": None, "KARPENTER_WARM_PROBE_SHAPES": None,
                     "KARPENTER_WARM_SHARDS": None, "KARPENTER_FAULTS": None}):
        faults.reset()
        # the dual-ascent buckets B5 would refuse on the card: none (its
        # wide layout takes the 4096-config buckets, ROADMAP C4)
        refused = sorted(
            lp for lp in {(s[0], s[1], s[4] if len(s) > 4 else 4)
                          for s in warm_pool.shapes_from_env()}
            if lp_device.enabled() and lp_device.ascent_refusal(
                *(lp_device._pad_to(x) for x in lp[:2])))
        t0 = time.perf_counter()
        counts = warm_pool.warm(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = outcomes()
        got = {o: after[o] - before[o] for o in after}
        launched = {k: v - counts0.get(k, 0) for k, v in launch_counts().items()
                    if v != counts0.get(k, 0)}
        first_walls = {key: rec["seconds"] for key, rec in warm_pool.CANARIES.items()}
        # every bucket again: each canary's second launch in the process
        t0 = time.perf_counter()
        again = warm_pool.warm(device="cuda")
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if counts["error"] or got["error"] or not counts["ok"]:
        fail(f"warm phase: the warm pool counted {counts}, SOLVER_WARM_COMPILES "
             f"{got}: every bucket must launch")
    if refused or counts["skipped"] or again != counts:
        fail(f"warm phase: the warm pool counted {counts}, then {again}; no bucket may be "
             f"skipped (B5 refuses {refused})")
    if launched.get("lp_ascend_wide", 0) < 2:
        fail(f"warm phase: B5's wide layout launched {launched.get('lp_ascend_wide', 0)}x: "
             "the two 4096-config dual-ascent buckets must launch it")
    if any(rec["runs"] != 2 for rec in warm_pool.CANARIES.values()) \
            or set(first_walls) != set(warm_pool.CANARIES):
        fail("warm phase: a canary bucket did not launch once in each pass")
    buckets: dict = {}
    for rec in warm_pool.CANARIES.values():
        key = f"{rec['kernel']}[{'x'.join(str(x) for x in rec['bucket'])}]"
        buckets[key] = buckets.get(key, 0.0) + rec["seconds"]
    firsts = [(" + ".join(sorted(rec["launches"])), rec["seconds"], rec["last"])
              for rec in warm_pool.CANARIES.values() if rec["first"]]
    say(f"warm phase: warm_pool.warm() on the card -> {json.dumps(counts)} in "
        f"{wall:.3f}s (again: {wall2:.3f}s); SOLVER_WARM_COMPILES by outcome "
        f"{json.dumps(got)}; skipped: none (B5's wide layout "
        f"{launched.get('lp_ascend_wide', 0)}x); "
        f"{len(warm_pool.CANARIES)} canaries, {len(warm_pool.compiled_buckets)} padded "
        f"signatures warm; launches {json.dumps(launched)} | card: {smi}")
    say("  bucket walls (s, host clock, launch to the copy back): "
        + "; ".join(f"{k} {v:.6f}" for k, v in buckets.items()))
    say("  first launch in the process against the second (s, host clock): "
        + "; ".join(f"{name}: {a:.6f} / {b:.6f}" for name, a, b in firsts))
    # the close gate through the ladder
    pods, pools = build_problem(*REWARM_PROBLEM[:2], seed=REWARM_PROBLEM[2])
    enc = encode(group_pods(pods), pools)
    with scoped_env({"KARPENTER_REWARM_ON_CLOSE": "1", "KARPENTER_BREAKER_COOLDOWN_MS": "60000",
                     "KARPENTER_FAULTS": "device_lost@solve:1-2",
                     "KARPENTER_FAULT_SEED": None}):
        faults.reset()
        resilience.reset()
        rs = resilience.shared()
        for _ in range(2):
            rs.solve_packing(enc, device="cuda")
        br = rs.breaker("device")
        if br.state != STATE_OPEN:
            fail(f"warm phase: two injected device faults left the breaker at {br.state}")
        br._retry_at = 0.0
        ok0 = SOLVER_WARM_COMPILES.value({"outcome": "ok"})
        runs0 = {key: rec["runs"] for key, rec in warm_pool.CANARIES.items()}
        gate_counts = launch_counts()
        rs.solve_packing(enc, device="cuda")
        torch.cuda.synchronize()
        gate_launched = {k: v - gate_counts.get(k, 0) for k, v in launch_counts().items()
                         if v != gate_counts.get(k, 0)}
        canary = [rec for key, rec in warm_pool.CANARIES.items()
                  if rec["runs"] > runs0.get(key, 0)]
        if (br.state != STATE_CLOSED or SOLVER_WARM_COMPILES.value({"outcome": "ok"}) != ok0 + 1
                or not canary or not any(rec["launches"] for rec in canary)
                or len(warm_pool.CANARIES) != len(runs0)):
            fail(f"warm phase: the half-open success left the breaker at {br.state}, "
                 f"canaries {len(canary)}")
    faults.reset()
    resilience.reset()
    resilience.pop_degraded()
    LADDER_BASE.update(ladder_counts())
    say(f"  re-warm gate (KARPENTER_REWARM_ON_CLOSE=1): two injected device faults on "
        f"build_problem{REWARM_PROBLEM} opened the device breaker (the host rung served "
        f"them); the half-open solve closed it only after rewarm_canary() launched on the "
        f"card ({len(canary)} canaries, launches with the solve {json.dumps(gate_launched)}) "
        f"({time.perf_counter() - t_phase:.3f}s)")
    return {"launches": launched, "wall": wall}


ENVIRON = "--environment"
# phase 16: testing.Environment over phase 13's catalog and pods (the
# benchmark problem, 50k pods x 500 types, each pod owned by a ReplicaSet
# so that a drained pod comes back pending), on one fixed deadline clock
# (no solve bound or method budget fires, so a slow run decides as a fast
# one), through `testing.environment_stream`
ENV_DROP = 0.3
# the global repack decides every round at this size without stalling
# (the fleet grows: PERF.md §6); one round holds its decisions (two
# before phase 17, cut for its time)
ENV_ROUNDS = 1
ENV_INTERRUPTS = 3
ENV_STEPS = ("provision", "disruption", "probes", "termination", "interruption")


def environment_run(device: str, on_step=None):
    """Phase 16's stream on `device`: returns the environment and
    `testing.environment_stream`'s records."""
    from karpenter_tpu_torch import testing, workloads
    from karpenter_tpu_torch.kube.objects import OwnerReference
    from karpenter_tpu_torch.solver import faults, lp_plan

    pods, pools = workloads.build_problem(N_PODS, N_TYPES, seed=SEED)
    for pod in pods:
        name = pod.metadata.name
        pod.metadata.owner_references = [OwnerReference(
            kind="ReplicaSet", name=f"{name}-rs", uid=f"uid-{name}-rs", controller=True)]
    testing.reset_counters(testing.package_api())
    env = testing.Environment(types=list(pools[0][1]), device=device,
                              clock=lambda: testing.ENV_T0)
    env.kube.create(testing.mk_nodepool("default"))
    # the global repack's column generation stops on wall-clock limits:
    # its MIPs stop at the root node and its time budget is lifted, so a
    # slow run plans as a fast one
    budget = lp_plan._TIME_BUDGET_S
    lp_plan._TIME_BUDGET_S = 1e4
    try:
        with testing.root_node_mips():
            steps = testing.environment_stream(
                env, pods, faults, drop=ENV_DROP, seed=SEED, max_rounds=ENV_ROUNDS,
                interrupts=ENV_INTERRUPTS, on_step=on_step)
    finally:
        lp_plan._TIME_BUDGET_S = budget
    return env, steps


def controller_gauges(env) -> dict:
    """The metrics controllers' gauges over `env` (pod, node, node pool
    and status-condition controllers, fresh, one pass at the stream's
    end), as sorted samples by name."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.metrics import controllers as mc

    now = testing.ENV_T0 + 10_000
    for ctrl in (mc.PodMetricsController(env.kube, env.cluster),
                 mc.NodeMetricsController(env.kube, env.cluster),
                 mc.NodePoolMetricsController(env.kube, env.cluster),
                 mc.StatusConditionMetricsController(env.kube, clock=lambda: now)):
        ctrl.reconcile_all(now=now)
    return {g.name: sorted(g.samples()) for g in (
        mc.PODS_STATE, mc.NODES_ALLOCATABLE, mc.NODES_TOTAL_POD_REQUESTS,
        mc.NODES_UTILIZATION, mc.NODEPOOL_USAGE, mc.NODEPOOL_LIMIT,
        mc.NODEPOOL_NODE_COUNT, mc.NODEPOOL_WEIGHT, mc.STATUS_CONDITION_COUNT)}


def first_difference(a, b, path: str = "") -> str:
    """Where two nested tuples or lists first differ, and the two values."""
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
        if len(a) != len(b):
            return f"{path}: lengths {len(a)} and {len(b)}"
    return f"{path}: {str(a)[:300]} against {str(b)[:300]}"


def step_text(rec) -> str:
    """One record of the stream, without its pods."""
    dec = rec["decision"]
    if rec["step"] == "provision":
        what = f"{len(dec[0])} new nodes, {len(dec[1])} existing, {len(dec[2])} errors"
    elif rec["step"] in ("probes", "interruption"):
        what = "[" + ", ".join("nothing" if d is None else
                               f"{d[0]}: {len(d[1])} candidates, {len(d[2])} replacements"
                               for d in dec) + "]"
    elif dec is None:
        what = "nothing"
    else:
        what = f"{dec[0]}: {len(dec[1])} candidates, {len(dec[2])} replacements"
    nodes, pending, claims, instances = rec["fleet"]
    return (f"{rec['step']} -> {what}; {len(nodes)} nodes, {claims} claims, "
            f"{instances} instances, {len(pending)} pending")


def async_bracket(spans: list, seam_async):
    """`solver._solve_packing_async` with CUDA events around its dispatch
    (a healthy solve queues its launches there, on this thread's stream),
    each (start, end) pair appended to `spans`."""
    import torch

    def call(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return seam_async(*a, **k)
        finally:
            end.record()
            spans.append((start, end))
    return call


@contextlib.contextmanager
def card_spans():
    """Within the block, CUDA events bracket every packing call of a
    Scheduler solve (`solver._solve_packing`, and the dispatch of
    `solver._solve_packing_async`, the cost race's arms) and every
    lane-solver call outside one (`pack_split_flat`,
    `pack_probe_lanes_flat`); yields the list the (start, end) pairs are
    appended to."""
    import torch

    from karpenter_tpu_torch.solver import pack_split as kernels
    from karpenter_tpu_torch.solver import solver as solver_mod

    spans: list = []
    inside = [0]
    seam = solver_mod._solve_packing
    real_split_flat, real_lanes_flat = kernels.pack_split_flat, kernels.pack_probe_lanes_flat

    def bracket(fn, lane: bool):
        def call(*a, **k):
            if lane and inside[0]:
                return fn(*a, **k)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            inside[0] += 0 if lane else 1
            start.record()
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 0 if lane else 1
                end.record()
                spans.append((start, end))
        return call

    solver_mod._solve_packing = bracket(seam, lane=False)
    seam_async = solver_mod._solve_packing_async
    solver_mod._solve_packing_async = async_bracket(spans, seam_async)
    kernels.pack_split_flat = bracket(real_split_flat, lane=True)
    kernels.pack_probe_lanes_flat = bracket(real_lanes_flat, lane=True)
    try:
        yield spans
    finally:
        solver_mod._solve_packing = seam
        solver_mod._solve_packing_async = seam_async
        kernels.pack_split_flat, kernels.pack_probe_lanes_flat = real_split_flat, real_lanes_flat


def environment_phase(smi: str) -> dict:
    """Phase 16: the simulated cluster (`testing.Environment`) on the
    card, held step for step against device="cpu"'s stream, the kernels
    each step launched, the metrics it exposes. Returns the launches of
    the stream (counts zeroed just before it, read just after)."""
    import torch

    from karpenter_tpu_torch.metrics import exposition
    from karpenter_tpu_torch.metrics.store import (
        SOLVER_DEVICE_STEPS,
        SOLVER_PHASE_DURATION,
        SOLVER_PROBE_BATCH,
    )
    from karpenter_tpu_torch.solver import lp_device, lp_plan, resilience
    from karpenter_tpu_torch.solver import pack_split as kernels

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    tables = (kernels.LAUNCHES, lp_device.LAUNCHES, lp_plan.LAUNCHES)

    def counts() -> dict:
        out = {}
        for table in tables:
            out.update(table)
        paths = ({"path": "sequential"}, {"path": "wavefront"})
        out["execute"] = SOLVER_PHASE_DURATION.count({"phase": "execute"})
        out["steps_observed"] = sum(SOLVER_DEVICE_STEPS.count(p) for p in paths)
        for outcome in ("batch", "lane", "capped_retry"):
            out[f"probe_{outcome}"] = SOLVER_PROBE_BATCH.value({"outcome": outcome})
        return out

    kernel_names = {name for table in tables for name in table}
    per_step: list = []
    mark = {}

    def on_step(rec) -> None:
        torch.cuda.synchronize()
        now = counts()
        per_step.append({
            "text": step_text(rec), "wall": time.perf_counter() - mark["t"],
            "card_ms": sum(s.elapsed_time(e) for s, e in spans),
            "launches": {k: v - mark["c"].get(k, 0) for k, v in now.items()
                         if v != mark["c"].get(k, 0)}})
        spans.clear()
        mark.update(t=time.perf_counter(), c=now)

    for table in tables:
        for name in table:
            table[name] = 0
    with card_spans() as spans, b6_wavefront_shapes(kernels) as env_shapes:
        start = counts()
        mark.update(t=time.perf_counter(), c=start)
        t0 = time.perf_counter()
        env, steps = environment_run("cuda", on_step=on_step)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        total = {k: v - start.get(k, 0) for k, v in counts().items()}
    served = served_by_device("phase 16", since)
    gauges = controller_gauges(env)
    text = exposition.render()
    ref, ref_s = CPU_REFS.get("environment")
    if ref["degraded"]:
        fail(f"phase 16 on the CPU: solves served degraded via {ref['degraded']}")
    if [r["step"] for r in steps] != [r["step"] for r in ref["steps"]]:
        fail(f"phase 16: the card's steps {[r['step'] for r in steps]} differ from the "
             f"CPU's {[r['step'] for r in ref['steps']]}")
    for k, (mine, theirs) in enumerate(zip(steps, ref["steps"])):
        if mine != theirs:
            part = "decision" if mine["decision"] != theirs["decision"] else "fleet"
            fail(f"phase 16 step {k} ({mine['step']}): the {part} differs from the "
                 f"CPU's: the card {step_text(mine)}, the CPU {step_text(theirs)}; "
                 f"first difference {first_difference(mine[part], theirs[part])}")
    if gauges != ref["gauges"]:
        diff = sorted(k for k in gauges if gauges[k] != ref["gauges"].get(k))
        fail(f"phase 16: the metrics controllers' gauges differ from the CPU run's: {diff}")
    missing = [p for p in ("encode", "transfer", "compile", "execute", "decode")
               if f'karpenter_solver_phase_duration_seconds_count{{phase="{p}"}}' not in text]
    if missing:
        fail(f"phase 16: render() has no phase_duration series for {missing}")
    b6 = total["pack_probe_lanes"] + total["pack_probe_lanes_wavefront"]
    b6_epilogue = total["pack_probe_lanes_flat"] + total["pack_probe_lanes_flat_masks"]
    solo = total["probe_batch"] - b6
    # every dispatch that was not regrown observes its device steps once
    observed = total["execute"] + total["probe_batch"] - total["probe_capped_retry"]
    if (b6 != b6_epilogue or solo < 0 or total["steps_observed"] != observed
            or total["pack_split_flat"] != total["execute"] + solo):
        fail(f"phase 16: the counters disagree with the launches: SOLVER_PROBE_BATCH "
             f"batch {total['probe_batch']:.0f}, SOLVER_DEVICE_STEPS observations "
             f"{total['steps_observed']}, solves {total['execute']}; B6 {b6}, its "
             f"epilogue {b6_epilogue}, flat solves {total['pack_split_flat']}")
    need = {"B2": total["pack_split_flat"],
            "B3": total["pack_split_wavefront"], "B4": total["lp_price"],
            "B5": total["lp_ascend"], "B6": b6}
    if not all(need.values()):
        fail(f"phase 16: the Environment's path launched {json.dumps(need)}: each of "
             f"B2, B3, B4, B5 and B6 must launch")
    say(f"phase 16 environment: testing.Environment(device=\"cuda\") over "
        f"build_problem({N_PODS}, {N_TYPES}, seed={SEED}): {len(steps)} steps in "
        f"{card_s:.3f}s on the card, each equal to device=\"cpu\"'s (computed "
        f"{CPU_REFS.where('environment')} in {ref_s:.3f}s) | card: {smi}")
    for rec in per_step:
        say(f"  {rec['text']} | {rec['wall']:.6f}s, card {rec['card_ms']:.3f} ms | "
            f"launches {json.dumps({k: v for k, v in rec['launches'].items() if k in kernel_names})}")
    say(f"  metrics: render() carries the five phase labels; SOLVER_PROBE_BATCH batch "
        f"{total['probe_batch']:.0f} = B6 {b6} + solo {solo:.0f}, lanes "
        f"{total['probe_lane']:.0f}; SOLVER_DEVICE_STEPS observations "
        f"{total['steps_observed']} = solves {total['execute']} + probe dispatches less "
        f"{total['probe_capped_retry']:.0f} regrown; flat launches {total['pack_split_flat']} "
        f"= solves + solo; the controllers' "
        f"{sum(len(v) for v in gauges.values())} gauge series equal to the CPU run's")
    if env_shapes:
        say(hold_b6_shapes(kernels, env_shapes, "phase 16's stream"))
    say(f"phase 16: every packing solve served by the device rung ({json.dumps(served)} ok), "
        f"none degraded; launches {json.dumps({k: v for k, v in total.items() if v})} "
        f"({time.perf_counter() - t_phase:.3f}s)")
    return {"environment": {k: v for k, v in total.items() if k in kernel_names}}


OPERATOR = "--operator"
# phase 17: the operator on the card. (a) its main path over phase 13's
# 50k pods x 500 types in two waves, OP_MICRO arrivals for the micro
# path, OP_HIGH pods of PriorityClass "critical" under the capped pool,
# the pods of OP_EMPTY nodes deleted and the pool consolidated when empty,
# OP_SCANS disruption scans (a command, an empty-handed scan, then the
# skip gate); (b) the
# real-client stack at CLIENT_PROBLEM (every write goes through
# `kube/serialize.py`, so 5,000 pods, not 50k) with an injected crash;
# (c) the binary as a subprocess for BINARY_SECONDS
OP_SPLIT = 40_000
OP_MICRO = 200
OP_HIGH = 16
OP_EMPTY = 20
OP_SCANS = 6
CLIENT_PROBLEM = (5_000, 500, SEED)
CLIENT_FAULTS = "operator_crash@crash_launch:1"
BINARY_DEMO = 2000
BINARY_SECONDS = 20


def operator_main_run(device: str, on_step=None) -> list:
    """Phase 17 (a) on `device`: `testing.operator_run` over the benchmark
    problem, the planners' MIPs stopped at the root node and their time
    budget lifted, one fixed deadline clock (a slow run decides as a fast
    one). Returns its records."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver import lp_plan
    from karpenter_tpu_torch.workloads import build_problem

    pods, pools = build_problem(N_PODS, N_TYPES, seed=SEED)
    extra, _ = build_problem(OP_MICRO + OP_HIGH, N_TYPES, seed=SEED + 7, name_prefix="op-")
    # claim and node names order the retained rows: both runs name alike
    testing.reset_counters(testing.package_api())
    budget = lp_plan._TIME_BUDGET_S
    lp_plan._TIME_BUDGET_S = 1e4
    try:
        with testing.root_node_mips():
            return testing.operator_run(
                testing.operator_api(), device, list(pools[0][1]), pools[0][0],
                [pods[:OP_SPLIT], pods[OP_SPLIT:]], extra[:OP_MICRO], extra[OP_MICRO:],
                empty=OP_EMPTY, policy="WhenEmpty", scans=OP_SCANS, seed=SEED,
                clock=lambda: testing.DISRUPTION_T0, on_step=on_step)
    finally:
        lp_plan._TIME_BUDGET_S = budget


def client_main_run(device: str) -> dict:
    """Phase 17 (b) on `device`: `testing.client_run` over
    `RealKubeClient(InMemoryApiServer())` with CLIENT_FAULTS (a crash in
    the launch, the client and Operator rebuilt against the same server).
    Returns its fleet, broken invariants, crashes, recovery actions,
    retries and fired faults."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.workloads import build_problem

    pods, pools = build_problem(CLIENT_PROBLEM[0], CLIENT_PROBLEM[1], seed=CLIENT_PROBLEM[2])
    pool = pools[0][0]
    pool.spec.disruption.consolidate_after = "Never"
    testing.reset_counters(testing.package_api())
    res = testing.client_run(testing.client_api(), device, list(pools[0][1]), pool, pods,
                             faults_spec=CLIENT_FAULTS)
    return {k: res[k] for k in ("fleet", "broken", "pending", "crashes", "recovery",
                                "retries", "fault_log")}


def operator_step_text(rec: dict) -> str:
    """One record of `operator_run`, without its pods."""
    extra = rec["extra"]
    if rec["step"] == "micro" and extra:
        what = f"; batch {len(extra['batch'])}, {extra['solved']} solved, {extra['outcome']}"
    elif rec["step"] == "disrupt":
        what = "; " + ", ".join(
            "nothing" if c is None else f"{c[0]}: {len(c[1])} candidates, "
            f"{len(c[2])} replacements" for c in extra) if extra else "; skipped"
    else:
        what = ""
    grown = {k: v for k, v in rec["counters"].items() if v}
    return (f"{rec['step']}: {len(rec['nodes'])} nodes, {rec['claims']} claims, "
            f"{len(rec['pending'])} pending, {len(rec['nominated'])} nominated{what}; "
            f"counters {json.dumps(grown)}")


def operator_binary(smi: str) -> str:
    """Phase 17 (c): `python -m karpenter_tpu_torch --demo BINARY_DEMO
    --run-seconds BINARY_SECONDS --metrics-port 0` on the card as a
    subprocess, /healthz, /readyz and /metrics read over HTTP while it
    runs; it must exit 0 with every demo pod bound. Then the same command
    with CUDA_VISIBLE_DEVICES="" must exit non-zero (no fallback)."""
    import re
    import urllib.request

    cmd = [sys.executable, "-m", "karpenter_tpu_torch", "--demo", str(BINARY_DEMO),
           "--run-seconds", str(BINARY_SECONDS), "--metrics-port", "0"]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: list = []
    try:
        port, deadline = None, time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"operator up: .* device=(\S+) metrics=\S+:(\d+)", line)
            if m:
                device, port = m.group(1), int(m.group(2))
        if port is None:
            fail("phase 17 (c): the binary never logged its metrics port: "
                 + "".join(lines)[-2000:])
        up_s = time.perf_counter() - t0
        time.sleep(3.0)
        base = f"http://127.0.0.1:{port}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        ready = json.loads(urllib.request.urlopen(f"{base}/readyz", timeout=30).read())
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=30).read().decode()
        _, rest = proc.communicate(timeout=BINARY_SECONDS + 180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = "".join(lines) + (rest or "")
    m = re.search(r"shutdown: (\d+) nodes, (\d+) bound pods", log)
    if proc.returncode != 0 or m is None or int(m.group(2)) != BINARY_DEMO:
        fail(f"phase 17 (c): the binary exited {proc.returncode}: " + log[-2000:])
    if device != "cuda" or "karpenter_operator_tick_duration_seconds" not in metrics \
            or "checks" not in ready or "ok" not in health:
        fail(f"phase 17 (c): device {device}, /healthz {health}, /readyz keys {sorted(ready)}")
    wall = time.perf_counter() - t0
    none = subprocess.run(cmd[:-4] + ["--run-seconds", "1", "--metrics-port", "0"], cwd=HERE,
                          env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=120)
    if none.returncode == 0 or "no CUDA device" not in none.stderr:
        fail(f"phase 17 (c): with CUDA_VISIBLE_DEVICES=\"\" the binary exited "
             f"{none.returncode}: {none.stderr[-1000:]}")
    return (f"  (c) {' '.join(cmd[1:])}: up in {up_s:.3f}s (device={device}), /healthz ok="
            f"{health.get('ok')}, /readyz ok={ready.get('ok')} with {len(ready)} keys, "
            f"/metrics {len(metrics.splitlines())} lines; exit 0 after {wall:.3f}s, "
            f"{m.group(1)} nodes, {m.group(2)} bound pods; with CUDA_VISIBLE_DEVICES=\"\" "
            f"exit {none.returncode} (no CUDA device) | card: {smi}")


def operator_phase(smi: str) -> dict:
    """Phase 17: the operator on the card. (a) `operator_main_run("cuda")`
    held step for step against device="cpu"'s records (computed in the
    worker), each step's wall and the card's ms in its packing calls;
    (b) `client_main_run("cuda")`: converged, nothing broken, one crash,
    the fleet device="cpu"'s; (c) `operator_binary`, on a thread beside
    (a) and (b) (its process holds the card for its own solves). Returns
    the launches of (a) and (b) (counts zeroed just before each, read just
    after; the binary's are its own process's)."""
    import torch

    from karpenter_tpu_torch.solver import lp_device, lp_plan, resilience
    from karpenter_tpu_torch.solver import pack_split as kernels

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    tables = (kernels.LAUNCHES, lp_device.LAUNCHES, lp_plan.LAUNCHES)

    def counts() -> dict:
        out = {}
        for table in tables:
            out.update(table)
        return out

    def zero() -> dict:
        for table in tables:
            for name in table:
                table[name] = 0
        return counts()

    per_step: list = []
    mark: dict = {}

    def on_step(rec, wall) -> None:
        torch.cuda.synchronize()
        now = counts()
        per_step.append({"text": operator_step_text(rec), "wall": wall,
                         "card_ms": sum(s.elapsed_time(e) for s, e in spans),
                         "launches": {k: v - mark["c"].get(k, 0) for k, v in now.items()
                                      if v != mark["c"].get(k, 0)}})
        spans.clear()
        mark["c"] = now

    # ---- (c) the binary, a subprocess beside (a) and (b) (it holds the card
    # for its solves alone; its own HTTP reads and checks)
    binary: dict = {}

    def run_binary() -> None:
        try:
            binary["text"] = operator_binary(smi)
        except BaseException as err:  # noqa: BLE001 - re-raised below
            binary["error"] = err

    binary_thread = threading.Thread(target=run_binary, name="phase17-binary")
    binary_thread.start()

    # ---- (a) the main path
    with card_spans() as spans:
        start = zero()
        mark["c"] = start
        t0 = time.perf_counter()
        recs = operator_main_run("cuda", on_step=on_step)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        total_a = {k: v - start.get(k, 0) for k, v in counts().items() if v != start.get(k, 0)}
    ref, ref_s = CPU_REFS.get("operator")
    if [r["step"] for r in recs] != [r["step"] for r in ref]:
        fail(f"phase 17 (a): the card's steps {[r['step'] for r in recs]} differ from the "
             f"CPU's {[r['step'] for r in ref]}")
    for k, (mine, theirs) in enumerate(zip(recs, ref)):
        if mine != theirs:
            keys = [key for key in mine if mine[key] != theirs[key]]
            fail(f"phase 17 (a) step {k} ({mine['step']}): {keys} differ from the CPU's: "
                 f"the card {operator_step_text(mine)}, the CPU {operator_step_text(theirs)}; "
                 f"first difference {first_difference(mine[keys[0]], theirs[keys[0]])}")
    last = recs[-1]["counters"]
    served_micro = any(r["step"] == "micro" and r["extra"] and r["extra"]["outcome"] == "served"
                       for r in recs)
    commands = [c for r in recs if r["step"] == "disrupt" for c in r["extra"] if c is not None]
    need = {"B2": total_a.get("pack_split_flat", 0),
            "B1/B3": total_a.get("pack_split", 0) + total_a.get("pack_split_wavefront", 0)}
    if not all(need.values()) or not served_micro or not last["PREEMPTION_NOMINATIONS"] \
            or not last["DISRUPTION_SCAN_SKIPPED"]:
        fail(f"phase 17 (a): launches {json.dumps(need)}, a micro batch served "
             f"{served_micro}, counters {json.dumps(last)}: the path must launch B1 or B3 "
             f"and B2, serve a micro batch, nominate a preemption victim and skip a scan")
    say(f"phase 17 operator (a): Operator(device=\"cuda\") over the in-memory store and "
        f"the kwok provider, build_problem({N_PODS}, {N_TYPES}, seed={SEED}) in two "
        f"waves, {OP_MICRO} micro arrivals, {OP_HIGH} critical pods, {OP_EMPTY} nodes emptied "
        f"(WhenEmpty), "
        f"{OP_SCANS} scans: {len(recs)} steps in {card_s:.3f}s, each equal to "
        f"device=\"cpu\"'s (computed {CPU_REFS.where('operator')} in {ref_s:.3f}s); "
        f"{len(commands)} disruption commands | card: {smi}")
    for rec in per_step:
        share = rec["card_ms"] / 1000 / rec["wall"] if rec["wall"] > 0 else 0.0
        say(f"  {rec['text']} | {rec['wall']:.6f}s, card {rec['card_ms']:.3f} ms "
            f"({share:.2%}) | launches {json.dumps(rec['launches'])}")
    served = served_by_device("phase 17 (a)", since)

    # ---- (b) the real-client stack, a crash and a restart
    start = zero()
    t0 = time.perf_counter()
    res = client_main_run("cuda")
    torch.cuda.synchronize()
    client_s = time.perf_counter() - t0
    total_b = {k: v - start.get(k, 0) for k, v in counts().items() if v != start.get(k, 0)}
    cref, cref_s = CPU_REFS.get("client")
    if res["crashes"] != 1 or res["broken"] or res["fleet"] != cref["fleet"] \
            or res["pending"] != cref["pending"] \
            or res["fault_log"] != cref["fault_log"] or res["recovery"] != cref["recovery"]:
        fail(f"phase 17 (b): crashes {res['crashes']}, broken {res['broken']}, recovery "
             f"{res['recovery']} against the CPU's {cref['recovery']}, fleets equal "
             f"{res['fleet'] == cref['fleet']}, fault logs equal "
             f"{res['fault_log'] == cref['fault_log']}")
    say(f"  (b) RealKubeClient(InMemoryApiServer()) at {CLIENT_PROBLEM[0]} pods x "
        f"{CLIENT_PROBLEM[1]} types (every write through kube/serialize.py, hence not 50k), "
        f"KARPENTER_FAULTS={CLIENT_FAULTS}: {res['crashes']} crash, the client and Operator "
        f"rebuilt against the same server; converged in {client_s:.3f}s to "
        f"device=\"cpu\"'s fleet ({len(res['fleet'])} nodes, {len(res['pending'])} pending; "
        f"computed "
        f"{CPU_REFS.where('client')} in {cref_s:.3f}s), nothing leaked; OPERATOR_RECOVERY "
        f"{json.dumps(res['recovery'])}, KUBE_RETRIES +{res['retries']:.0f}; launches "
        f"{json.dumps(total_b)} | card: {smi}")
    served_by_device("phase 17 (b)", since)
    binary_thread.join()
    if "error" in binary:
        raise binary["error"]
    say(binary["text"])
    say(f"phase 17: every packing solve served by the device rung ({json.dumps(served)} ok), "
        f"none degraded ({time.perf_counter() - t_phase:.3f}s)")
    return {"operator": total_a, "client": total_b}


SOAK = "--soak"
# phase 18: the scenario soak on the card, each spec's report held against
# device="cpu"'s (the worker's): the smoke trace, the flywheel at the JAX
# bench arm's horizon, and the sensitivity control (the smoke trace with
# a 2 s exec delay at the always-fired crash_tick site), which must fail
SOAK_SPECS = ("smoke", "flywheel", "lag")
SOAK_FLYWHEEL_S = 600.0
SOAK_LAG = "exec_delay@crash_tick:*=2s#lag"


def soak_spec(name: str):
    """Phase 18's spec `name` of SOAK_SPECS."""
    import dataclasses

    from karpenter_tpu_torch.scenarios import flywheel_spec, smoke_spec

    if name == "smoke":
        return smoke_spec()
    if name == "flywheel":
        return flywheel_spec(duration_s=SOAK_FLYWHEEL_S)
    return dataclasses.replace(smoke_spec(), name="smoke_flywheel_injected",
                               faults=(SOAK_LAG,))


def soak_run(name: str, device: str) -> dict:
    """`run_soak` of phase 18's spec `name` on `device`: the report's
    digest, verdict, failing planes, fault log and observations, and the
    process's hash seed (the drains iterate sets of names, ROADMAP C7)."""
    from karpenter_tpu_torch.scenarios import run_soak

    report = run_soak(soak_spec(name), device=device)
    return {"digest": report["report_digest"], "pass": report["pass"],
            "failures": report["failures"], "fault_log": report["fault_log"],
            "observations": report["observations"], "planes": report["planes"],
            "hashseed": os.environ.get("PYTHONHASHSEED")}


def soak_phase(smi: str) -> dict:
    """Phase 18: `run_soak` on the card (`device="cuda"`) for each spec of
    SOAK_SPECS, its report digest held against device="cpu"'s (computed in
    the worker, under the same hash seed); the calm specs must pass and
    the lag control must fail on the sentinel and SLO planes. Per spec the
    soak's wall, the card's ms in its packing calls and the kernels it
    launched (the counts zeroed just before, read just after). Returns the
    launches by spec."""
    import torch

    from karpenter_tpu_torch.solver import lp_device, lp_plan, resilience
    from karpenter_tpu_torch.solver import pack_split as kernels

    t_phase = time.perf_counter()
    resilience.reset()
    since = ladder_counts()
    tables = (kernels.LAUNCHES, lp_device.LAUNCHES, lp_plan.LAUNCHES)

    def counts() -> dict:
        out = {}
        for table in tables:
            out.update(table)
        return out

    launches: dict = {}
    for name in SOAK_SPECS:
        with card_spans() as spans:
            for table in tables:
                for key in table:
                    table[key] = 0
            t0 = time.perf_counter()
            got = soak_run(name, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            card_ms = sum(a.elapsed_time(b) for a, b in spans)
            n_calls = len(spans)
        launches[name] = {k: v for k, v in counts().items() if v}
        ref, ref_s = CPU_REFS.get(f"soak {name}")
        if got["hashseed"] != ref["hashseed"]:
            fail(f"phase 18 {name}: hash seeds differ, the card's process "
                 f"{got['hashseed']!r}, the CPU worker {ref['hashseed']!r}")
        if got["digest"] != ref["digest"]:
            keys = [k for k in ("failures", "fault_log", "observations", "planes")
                    if got[k] != ref[k]]
            fail(f"phase 18 {name}: the card's report digest {got['digest'][:16]} differs "
                 f"from device=\"cpu\"'s {ref['digest'][:16]}: {keys} differ; first "
                 f"difference {first_difference(got[keys[0]], ref[keys[0]]) if keys else '?'}")
        want_fail = name == "lag"
        if want_fail and not {"sentinel", "slo"} <= set(got["failures"]):
            fail(f"phase 18 lag: the sensitivity control did not fail on sentinel and slo: "
                 f"{got['failures']}")
        if not want_fail and not got["pass"]:
            fail(f"phase 18 {name}: the soak failed on {got['failures']}")
        obs = got["observations"]
        need = launches[name].get("pack_split_flat", 0)
        if not need:
            fail(f"phase 18 {name}: the soak launched no packing kernel: {launches[name]}")
        share = card_ms / 1000 / wall if wall > 0 else 0.0
        say(f"phase 18 soak {name} ({soak_spec(name).name}, {obs['virtual_seconds']} virtual "
            f"s): {'PASS' if got['pass'] else 'FAIL on ' + ','.join(got['failures'])}, "
            f"digest {got['digest'][:16]} equal to device=\"cpu\"'s (computed "
            f"{CPU_REFS.where(f'soak {name}')} in {ref_s:.3f}s) | {obs['ticks']} ticks, "
            f"{obs['micro_steps']} micro steps, {obs['crashes']} crashes, "
            f"{obs['events_applied']['create']} creates, {obs['fault_log_len']} faults "
            f"{obs['fault_kinds']}, fleet {json.dumps(obs['fleet'])} | wall {wall:.3f}s, card "
            f"{card_ms:.3f} ms in {n_calls} packing calls ({share:.2%}) | launches "
            f"{json.dumps(launches[name])} | card: {smi}")
    served = served_by_device("phase 18", since)
    say(f"phase 18: every packing solve served by the device rung ({json.dumps(served)} ok), "
        f"none degraded ({time.perf_counter() - t_phase:.3f}s)")
    return launches


# the spilled launches: their source and the JAX program each replaces
GLOBAL_KERNELS = {
    "pack_split_global": ("pack_split.cu", "karpenter_tpu/solver/pack.py:444"),
    "pack_split_wavefront_global": ("pack_wavefront.cu", "karpenter_tpu/solver/pack.py:786"),
    "pack_probe_lanes_global": ("pack_split.cu", "karpenter_tpu/solver/pack.py:1227"),
    "pack_probe_lanes_wavefront_global": ("pack_wavefront.cu",
                                          "karpenter_tpu/solver/pack.py:1227"),
    "pack_global": ("pack_dense.cu", "karpenter_tpu/solver/pack.py:164"),
    "pack_split_sharded_global": ("pack_split.cu", "karpenter_tpu/solver/pack.py:1817"),
    "pack_split_wavefront_sharded_global": ("pack_wavefront.cu",
                                            "karpenter_tpu/solver/pack.py:1817"),
}


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
        from karpenter_tpu_torch.solver import consolidation_batch, lp_device, lp_plan
        from karpenter_tpu_torch.solver import solver as solver_mod
        from karpenter_tpu_torch.testing import (
            ASCENT_EDGE_CASES,
            ASCENT_WIDE_CASES,
            PRICE_CASES,
            KernelCase,
            ascent_cases,
            ascent_edge_cases,
            ascent_wide_cases,
            config_axis,
            dense_case,
            dense_cases,
            existing_from_solution,
            kernel_cases,
            lane_cases,
            price_case,
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
        say(f"  {name}: nvcc {rec['seconds']:.3f}s cached={rec['cached']} "
            f"machine_tag={rec['machine_tag']} | " + " | ".join(usage))

    if SPLIT in sys.argv[1:]:
        quick_timing(kernels, pack, solve, build_problem, KernelCase, {}, smi, kind,
                     lp_device, encode, group_pods, split_only=True)
        return
    if B5_AGAINST in sys.argv[1:]:
        b5_against(sys.argv[sys.argv.index(B5_AGAINST) + 1], smi)
        finish(kind, smi)
        return
    if B6_AGAINST in sys.argv[1:]:
        b6_against(sys.argv[sys.argv.index(B6_AGAINST) + 1], smi)
        finish(kind, smi)
        return
    if AGAINST in sys.argv[1:]:
        other = sys.argv[sys.argv.index(AGAINST) + 1]
        against(other, smi)
        finish(kind, smi)
        return
    if LANES in sys.argv[1:]:
        t0 = time.perf_counter()
        err = {k: 0.0 for k in ("pack_split", "pack_split_wavefront", "pack_split_flat",
                                "pack_probe_lanes", "pack_probe_lanes_flat",
                                "pack_probe_lanes_flat_masks")}
        for case in kernel_cases(0):
            say(hold(kernels, case, err, widths=(8, 16)))
        for lc in lane_cases(0):
            largs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in lc.args]
            lkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
                   for k, v in lc.kwargs.items()}
            for mode in ("ffd", "cost"):
                say(hold_lane_placements(kernels, lc.name, largs, lkw, lc.max_free, mode, err))
        say(f"chip_smoke {LANES}: holds identical ({time.perf_counter() - t0:.3f}s), "
            f"{time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if DENSE in sys.argv[1:]:
        dense = dense_phase(pack_dense, kernels, graft_entry, dense_problems(),
                            {"pack": 0.0, "pack_flat": 0.0}, smi)
        say(f"chip_smoke {DENSE}: {time.perf_counter() - T_START:.3f}s wall")
        say(json.dumps({"kernels": dense["entries"]}))
        finish(kind, smi)
        return
    if LADDER in sys.argv[1:]:
        ladder_phase(smi)
        say(f"chip_smoke {LADDER}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if PROVISION in sys.argv[1:]:
        provision_phase(smi)
        say(f"chip_smoke {PROVISION}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if TICK in sys.argv[1:]:
        tick_phase(smi)
        say(f"chip_smoke {TICK}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if DISRUPT in sys.argv[1:]:
        disrupt_phase(smi)
        say(f"chip_smoke {DISRUPT}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if WARM in sys.argv[1:]:
        warm_phase(smi)
        say(f"chip_smoke {WARM}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if ENVIRON in sys.argv[1:]:
        CPU_REFS.start(groups=(("environment",),))
        warm_phase(smi)
        environment_phase(smi)
        say(f"chip_smoke {ENVIRON}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if OPERATOR in sys.argv[1:]:
        CPU_REFS.start(groups=(("operator", "client"),))
        operator_phase(smi)
        say(f"chip_smoke {OPERATOR}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if SOAK in sys.argv[1:]:
        CPU_REFS.start(groups=(tuple(f"soak {n}" for n in SOAK_SPECS),))
        soak_phase(smi)
        say(f"chip_smoke {SOAK}: {time.perf_counter() - T_START:.3f}s wall")
        finish(kind, smi)
        return
    if CATALOG in sys.argv[1:]:
        report = {"kernels": catalog_phase({}, smi)["entries"]}
        say(f"chip_smoke {CATALOG}: {time.perf_counter() - T_START:.3f}s wall")
        say(json.dumps(report))
        finish(kind, smi)
        return

    CPU_REFS.start()
    # ---- the warm phase: the warm pool's canaries, the re-warm gate
    warm_phase(smi)

    # ---- 3. kernels against their plain versions on the card
    t0 = time.perf_counter()
    err = {"pack_split": 0.0, "pack_split_wavefront": 0.0, "pack_split_flat": 0.0}
    cases = kernel_cases(0)
    for case in cases + [config_axis(cases[i], C) for i, C in ((4, ODD_CONFIG_AXES[0]),
                                                                 (2, ODD_CONFIG_AXES[1]))]:
        say(hold(kernels, case, err, widths=WIDTHS))
    err.update({"pack_probe_lanes": 0.0, "pack_probe_lanes_flat": 0.0,
                "pack_probe_lanes_flat_masks": 0.0})
    n_lane = 0
    for lc in lane_cases(0):
        largs = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in lc.args]
        lkw = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in lc.kwargs.items()}
        for mode in ("ffd", "cost"):
            say(hold_lane_placements(kernels, lc.name, largs, lkw, lc.max_free, mode, err))
            n_lane += 1
    err.update({"pack": 0.0, "pack_flat": 0.0})
    dcases = dense_cases(0, kernel=cases)
    for case in dcases:
        say(hold_dense(pack_dense, kernels, case, err))
    err.update({"lp_price": 0.0, "lp_ascend": 0.0})
    before = lp_plan.LAUNCHES["lp_price_global"]
    for name, case in price_cases(0):
        say(hold_price(lp_plan, name, [torch.from_numpy(x).cuda() for x in case], err,
                       layouts=(None, 1, 2)))
    for G, C in PRICE_PAST_CEILING:
        xs = [torch.from_numpy(x).cuda() for x in price_case(9, G, C, 4)]
        say(hold_price(lp_plan, f"price-G{G}-C{C}-R4", xs, err))
    global_path = lp_plan.LAUNCHES["lp_price_global"] - before
    if global_path != 2 * len(PRICE_CASES) + len(PRICE_PAST_CEILING):
        fail(f"lp_price read the groups' tables in place {global_path}x")
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
    for name, inputs in ascent_wide_cases(0):
        for n_iters in WIDE_ITERS.get(name, (WIDE_ITERS_DEFAULT,)):
            before = lp_device.LAUNCHES["lp_ascend_wide"]
            say(hold_ascent(lp_device, f"{name}-{n_iters}", inputs.to("cuda"), n_iters, err)
                + f"; {lp_device.ASCENT_SMEM['lp_ascend']}")
            if lp_device.LAUNCHES["lp_ascend_wide"] != before + 1:
                fail(f"lp_ascend did not take its wide layout on {name}")
    say(f"phase 3 kernels: {len(cases)} seeded packing problems and 2 at config axes "
        f"{ODD_CONFIG_AXES} byte-identical to the plain versions, B3 at widths "
        f"{WIDTHS} equal to B1, the in-place flat routes identical; B6 sequential at "
        f"{kernels.LANE_THREADS} threads, shared and spilled, and the lane flat routes "
        f"on {n_lane} seeded lane cases identical; B7 and pack_flat "
        f"on {len(dcases)} dense ones byte-identical, B7 equal to B1; B4 on "
        f"{len(PRICE_CASES)} (each in its three layouts) and {len(PRICE_PAST_CEILING)} past "
        f"its staged layout and B5 on {3 * len(ASCENT_ITERS)} seeded cases, "
        f"{len(ASCENT_EDGE_CASES)} edge cases (one on the global-memory path) and "
        f"{len(ASCENT_WIDE_CASES)} past 2048 padded axes (its wide layout) "
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
    if CPU_REFS.get("first")[0] != first_fp:
        fail("first request: GPU fingerprint differs from the CPU path's")
    if fingerprint(solve(extra, pools, existing, device="cpu")) != fingerprint(sol2):
        fail("second request: GPU fingerprint differs from the CPU path's")
    if CPU_REFS.get("small")[0] != fingerprint(sol_small):
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

    served_by_device("phase 4")
    # ---- 5. timing on the warm first request's inputs
    timing = timing_phase(kernels, pack, timed, smi)
    # ---- 6. the cost objective on reserved_50k
    t0 = time.perf_counter()
    recorded = cost_phase(kernels, lp_plan, lp_device, pack, solver_mod, build_problem,
                          err, launches)
    say(f"  phase 6 took {time.perf_counter() - t0:.3f}s")
    served_by_device("phase 6")

    # ---- 7. B4 and B5 timing on the cost path's recorded inputs
    xs = recorded["price_inputs"]
    q, _ = lp_plan.price_kernel(*xs)
    b4_ms = event_ms(lambda: lp_plan.price_kernel(*xs), 20)
    b4_plain_ms = event_ms(lambda: lp_plan.price_kernel_ref(*xs), 2, queued=False)
    b4_bytes = nbytes(xs) + nbytes(lp_plan.price_kernel(*xs))
    b4_ops = price_ops(q, xs[2].shape[1])
    b4_bound, b4_by = bound(b4_ops, b4_bytes)
    b4_clocks, _ = price_clocks(kernels, lp_plan, xs)
    say(f"phase 7 LP timing: B4 on the first column-generation round's inputs "
        f"(Gp={xs[0].shape[0]} Cp={xs[1].shape[1]} R={xs[2].shape[1]}): {b4_ms:.6f} ms, "
        f"plain {b4_plain_ms:.3f} ms, ops={b4_ops} bytes={b4_bytes} | card: {smi}")
    say(f"  B4 phase clocks: {b4_clocks}")
    lay_ms = [event_ms(lambda i=i: lp_plan.price_kernel(*xs, layout=i), 20) for i in (0, 1, 2, 0)]
    say(f"  B4 by layout on these inputs, in turns: {lp_plan.PRICE_LAYOUTS[0]} "
        f"{lay_ms[0]:.6f}, {lay_ms[3]:.6f} ms; {lp_plan.PRICE_LAYOUTS[1]} {lay_ms[1]:.6f} ms; "
        f"{lp_plan.PRICE_LAYOUTS[2]} {lay_ms[2]:.6f} ms | card: {smi}")
    a, n_iters = recorded["ascent"]
    b5 = ascent_timing(kernels, lp_device, "reserved_50k's LP", a, n_iters, err, smi)

    # ---- 8. the consolidation probe path
    probes = probe_phase(kernels, consolidation_batch, lp_device, cuda_build, err, smi)
    served_by_device("phase 8")

    # ---- 9. the dense kernel B7: the entry problem, and the dense ≡
    # split oracle at full width on what phases 4 and 6 staged
    dense = dense_phase(pack_dense, kernels, graft_entry, [
        dense_case(st, name, mode) for name, st, mode in (
            ("first request", last_staged["first-warm"], "ffd"),
            ("second request", last_staged["second"], "ffd"),
            ("reserved_50k cost arm", recorded["staged"], "cost"))], err, smi)
    route_launches = {
        name: sum(n[name] for n in (*launches.values(), *probes["launches"].values()))
        for name in ("pack_split", "pack_split_wavefront", "pack_split_flat")
    }

    # ---- 10. B8: the config axis split over shards, on virtual meshes
    served_by_device("phase 9")
    sharded = shard_phase({
        "pods": pods, "pools": pools, "extra": extra, "existing": existing,
        "first_fp": first_fp, "second_fp": fingerprint(sol2), "enc": enc,
        "ascent": recorded["ascent"],
    }, err, smi)

    # ---- 11. aws_catalog_50k: the packing kernels past the shared-memory
    # ceiling
    served_by_device("phase 10")
    catalog = catalog_phase(err, smi)
    served = served_by_device("phase 11")
    say(f"ladder: every packing solve of phases 4-11 served by the device or sharded "
        f"rung ({json.dumps(served)} ok), none degraded, no device LP degraded")

    # ---- 12. the resilience ladder on the card
    ladder_phase(smi, enc)
    # ---- 13. the provisioning path: pending pods to NodeClaims
    provisioning = provision_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n[name] for n in provisioning.values())
    # ---- 14. the incremental tick, the micro path, the pipeline
    ticking = tick_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n[name] for n in ticking.values())
    # ---- 15. the consolidation engine
    disrupting = disrupt_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n[name] for n in disrupting.values())
    # ---- 16. the simulated cluster: testing.Environment on the card
    environment = environment_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n[name] for n in environment.values())
    # ---- 17. the operator: its main path, the real-client stack, the binary
    operating = operator_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n.get(name, 0) for n in operating.values())
    # ---- 18. the scenario soak on the card
    soaking = soak_phase(smi)
    for name in route_launches:
        route_launches[name] += sum(n.get(name, 0) for n in soaking.values())
    later = (*ticking.values(), *disrupting.values(), *environment.values(),
             *operating.values(), *soaking.values())
    tick_lp = {name: sum(n.get(name, 0) for n in later) for name in ("lp_price", "lp_ascend")}
    for entry in probes["entries"]:
        entry["launches"] += sum(n.get(entry["name"], 0)
                                 for n in (*disrupting.values(), *environment.values(),
                                           *operating.values(), *soaking.values()))
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
         "launches": launches["cost"]["lp_price"] + tick_lp["lp_price"],
         "max_abs_err": err["lp_price"],
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound,
         "bound_by": b4_by, "library_ms": None},
        {"name": "lp_ascend", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/lp_ascend.cu",
         "replaces": "karpenter_tpu/solver/lp_device.py:202",
         "launches": launches["cost"]["lp_ascend"] + probes["b5_launches"]
         + tick_lp["lp_ascend"],
         "max_abs_err": err["lp_ascend"], "ms": b5["ms"], "plain_ms": b5["plain_ms"],
         "bound_ms": b5["bound"], "bound_by": b5["by"], "library_ms": None},
        *probes["entries"],
        *dense["entries"],
        *sharded["entries"],
        *catalog["entries"],
    ]}
    say(f"chip_smoke: {time.perf_counter() - T_START:.3f}s wall")
    say(json.dumps(report))
    finish(kind, smi)


def finish(kind: str, smi: str) -> None:
    """The card's line, then the contract's last line."""
    import torch

    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        # one order of string hashes in this process and in the CPU
        # worker it spawns: the simulated cluster's drain and rebinding
        # iterate sets of names (in the JAX package too), so phase 16's
        # card and CPU runs compare only under the same hash seed
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.argv])
    try:
        main()
    finally:
        CPU_REFS.close()
