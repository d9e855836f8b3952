#!/usr/bin/env python3
"""Quickest proof that the PyTorch / H100 port starts on the card.

    python3 chip_smoke.py                    # every phase, one card

Phases, each printing one JSON line:

1. env      torch / CUDA versions, the card's name and power limit
            (also printed raw, as nvidia-smi gives them), the host's
            CPU model and the CPUs this process may use (nproc);
2. build    the native host library and converter built with g++ from
            lux_tpu_torch/native (their compiler seconds), beside
            every kernel built from lux_tpu_torch/csrc (B1
            chunk_partials and its batched form chunk_partials_batched,
            B2 lane_shuffle, and the probe kernels S7
            carry, S8 fused_carry, S9 onehot_reduce, S3/S12
            transposed_reduce, S2/S11 sub_gather, S4/S5 elementwise, S6
            block_rowsum: every entry of _kernels.KERNELS), one nvcc per
            source started together, build seconds;
3. graph    the main path's graph: R-MAT scale 21, edge factor 16
            (2,097,152 vertices, 33,554,432 edges), made from --seed,
            and its PageRank engine on the card; its build with every
            sort site (edges_to_csc's) run both ways on the same keys,
            numpy's stable sort on copies then native.sort_kv, keys and
            payloads required equal (SortSites), each site's seconds
            both ways, the build's measured wall time (graph_seconds
            holds it: both ways' sorts included) and its set-up
            seconds each way, derived, not timed alone (the wall less
            the other way's sorts and copies); and
            native.rmat_csc two scales under (its seconds), a
            measurement only (another RNG stream: the smoke's graphs
            stay numpy's);
4. kernels  kernel B1 (chunk_partials) against its plain PyTorch
            version on the card: the main path's own chunks, plus
            {f32, int32} x {sum, min, max} cases with pads, empty lanes,
            unsorted pair-row lanes, an odd C and NaN lanes, and the
            edge cases of its warp design (one lane for a whole chunk,
            runs across every 4- and 32-entry boundary, all-pad chunks,
            E in {1, 3, 33, 130}, rows that ascend then descend, lanes
            outside [0, W), unaligned bases, paged-shaped rows with NaN
            in every pad's value, int32 sums that wrap); two
            launches on the main path's chunks must be bit-equal; then
            the kernel's times, bound and library time at that shape;
5. main     PageRank, 10 iterations, through the port's entry points,
            against the float64 oracle (rtol 5e-5, atol 1e-9); B1's
            launch count must rise by exactly one per iteration, B2's
            by none;
6. layers   per-layer device time of one iteration (gather, kernel,
            combine, apply), and kernel S7 (carry_combine) on the
            layer's own partials followed by the take of each tile's
            last chunk, held to the combine's result (rtol 2e-5) and
            timed beside it (measured only: the engine does not call
            it; the pairs phase does the same on the residual's
            partials);
7. paged    bench.py's gather-ab@paged: the same graph degree-relabelled,
            128-aligned layout, gather="paged", 10 iterations against
            the float64 oracle of the relabelled graph; B2 and B1 each
            launched once per iteration; plan stats and build seconds,
            per-layer times (page fetch, B2, B1, class combine, apply).
            Before it, a second kernels line: B2 (lane_shuffle) against
            its plain version, bit for bit, on the paged path's own rows
            and on f32 NaN payloads, int32 rows, packed words with bit
            31 set and row counts that are not multiples of 512.  After
            it, B1 on the path's own [Rp, 128] rows against its plain
            version, two launches bit-equal, and B1's times at that
            shape (the kernels line's chunk_partials@paged entry);
8. pagemajor the same with gather="pagemajor" (B2 over the gather rows,
            B1 over the virtual rows), its own rows checked the same way
            (the kernels line's chunk_partials@pagemajor entry);
9. parts    R-MAT scale 17 with 4 parts on one card and a chunk width
            that needs the segmented combine, then the same graph
            relabelled with 4 parts paged and page-major, then
            pair_relabel'd with 4 parts and pair-lane rows (streamed and
            monolithic), against the oracle; then the push engine on the
            same graph and parts: hop SSSP, weighted SSSP with
            delta="auto" (integer weights 1..5) and components on the
            symmetrized graph, each over the tiled layout, paged,
            page-major and pair rows streamed and monolithic, labels
            bit-equal to the oracle, kernels launched only by dense
            iterations (B2 once each on the paged paths); then
            colfilter (R-MAT 17, ef 16, weighted) with 4 parts tiled (E
            128), flat, pair rows monolithic and streamed and paged,
            each within rtol 1e-5 of the float64 oracle with no hand
            kernel launched, and page-major refused with the
            reference's ValueError; and exchange="owner": PageRank (B1
            once a step over every part's owner chunks), hop and
            weighted SSSP, components with pair rows, and the batched
            k-source SSSP and personalized PageRank (B1's batched form
            once a dense iteration), each against its oracle, and each
            of those apps again on the owner exchange's paged and
            page-major plans (B2 and B1 once a step or dense iteration,
            the batched engines B1's batched form);
9b. owner   the exchange sweep: the PageRank pull step with
            exchange="gather" and "owner" in turns on R-MAT --scale with
            1 part (the main engine) and 4 parts (OWNER_SWEEP), beside
            what exchange="auto" resolves to, three
            iterations of each agreeing; the streamed forms against
            their monolithic runs (stream_msgs on the pull and push
            tiled paths of the main graph, B1 a block of 1,024 chunks;
            the 4-part owner layout's fused streamed combine with
            ops/owner.STREAM_MSG_BYTES lowered, then restored); then
            bench.py's pagerank-mp (R-MAT --scale + OWNER_SCALE_OVER,
            the main graph since the cut to 0, ef 16, 4 parts,
            pair_relabel, pair rows at threshold 16, min_fill 24,
            exchange="owner"; 10 iterations against the float64 oracle
            at MAIN_TOL, B1 once over the owner chunks plus once a pair
            block each step; layout stats and build seconds, step and
            host enqueue ms, layer times with both owner gather forms in
            turns, peak memory against memwatch's ledger) and sssp-mp
            on the same relabelled graph (hop SSSP from input vertex 0,
            or the smallest input id with an out-edge, labels bit-equal
            to a BFS, B1 only in dense iterations, host syncs counted);
            B1 at the owner chunks (f32 sum; sssp-mp's int32 min) and at
            one streamed block against its plain version, two launches
            bit-equal (the kernels line's chunk_partials@owner,
            @owner_sssp, @owner_block entries).  Its owner_paged step
            runs after the paged phases, on their graph (bench.py's
            gather-ab: the degree-relabelled R-MAT --scale), 128-aligned
            with 4 parts, exchange="owner", gather="paged" then
            "pagemajor" (one plan a mode, built once by
            pagegather.engine_page_plan and given to both apps' engines
            as ``page_plan``): PageRank, 10
            iterations against the float64 oracle at MAIN_TOL, B2 and B1
            once a step; hop SSSP from input vertex 0 (or the smallest
            input id with an out-edge) bit-equal to a BFS, B2 and B1
            once a dense iteration; plan stats and build seconds, step
            and host enqueue ms, the layers (page fetch, B2, then B1,
            class combine and fold, or the route, the virtual-row take,
            B1 and class combine), peak memory against memwatch's
            ledger, the step's audit; B2 and B1 on each path's own rows,
            fetched from a state of distinct values, against their
            plain versions (B2 bit for bit, B1's float32 sums at rtol
            1e-5), two launches of each bit-equal (B1 in blocks of rows
            and at a row count that is not a multiple of its block); then what gather="auto"
            resolves to under the owner exchange beside the flat owner
            step and the two measured (the kernels line's
            lane_shuffle@owner_paged, @owner_pagemajor and
            chunk_partials@owner_paged, @owner_pagemajor entries);
9c. mesh    (ROADMAP A6b-1; printed after the owner lines) the parts
            mesh over torch.cuda.device_count() ranks, NCCL: one card
            is world 1 in this process on an in-process HashStore (a
            collective is then a copy on the card, and no link is
            timed), several cards one spawned rank each; a mesh_env line
            (backend, world, NCCL version); the dryrun's six
            configurations (lux_tpu_torch/parallel/dryrun.py) against
            their oracles; pagerank-mp and sssp-mp with mesh= on the
            owner phase's graph, ShardedGraph and pair plan, against the
            owner phase's engines without a mesh (PageRank within rtol
            2e-5, bit equality recorded; labels, iterations and the
            dense / sparse schedule equal), every kernel's launches a
            run and a converge equal to theirs; step and converge ms
            with and without the mesh; the all_gather of the state, the
            owner reduce-scatter and all_to_all and the count's
            all_reduce timed alone by CUDA events; B1 on the mesh
            path's owner chunks against its plain version, two launches
            bit-equal (the kernels line's chunk_partials@mesh entry);
10. pairs   bench.py's pagerank config on the main graph: pair_relabel,
            pair_threshold 16, min_fill 24, tile_e 128, through
            pagerank.build_engine once with each pair_stream setting
            (monolithic, then streamed, the default), 10 iterations
            against the float64 oracle of the relabelled graph; B1
            launched once per iteration over the residual chunks plus
            once over the pair rows (monolithic) or once a block
            (streamed), B2 never; plan stats, set-up seconds, per-layer
            times (B1 on the residual chunks with its bound, plain and
            scatter_reduce times); then B1 on the path's own [Rp, 128]
            pair rows against its plain version (two launches
            bit-equal) and on the residual chunks, its times on the pair
            rows (the kernels line's chunk_partials@pairs entry), and
            how many 32-lane steps of those rows take B1's sorted path
            and how many its __match_any_sync path; the pair set-up
            (pair_relabel, then the monolithic engine's build: layout,
            plan_sharded_pairs, upload) with every sort site both ways,
            as the graph phase's build (the streamed engine's build is
            native only);
11. probes  the TPU probe scripts' counterparts (lux_tpu_torch/probes:
            profile_kernel --3d, profile_slotted on the main graph's
            in-degrees, profile_v3, profile_true, profile_shuffle,
            profile_vpu) at the scripts' shapes and seed, each run once
            with every launch count at 0 just before and read just after
            (its kernels must launch, B2 in profile_true and
            profile_shuffle too; no system path above launched a probe
            kernel); then each probe kernel against its plain version on
            the scripts' full inputs and on edge shapes: S7, S8, S9 and
            S3/S12 at rtol 1e-5, atol 1e-5 (C or N not a multiple of the
            kernel's tile, start[0] = 0, one segment across all rows, a
            start on every row, unsorted lanes, lanes W and outside
            [0, W), E in {1, 33, 512}, W in {1, 37, 100} and, for S7,
            200; S7 twice bit-equal on the full inputs and on one
            segment across all rows, three S7 calls captured in a CUDA
            graph and replayed twice, each output bit-equal to an eager
            call's, and a torch.profiler count over 10 S7 calls: 10
            carry.cu kernels and no memset; S3/S12 columns that hit
            few or no output rows, N under
            a CTA's columns, E under or no multiple of its slices, and
            wg in {1, 3, 8, 16, 32, 37, W}, every launch of a
            case at a wg bit-equal to the first; for S9 also C of
            1,003 to 12,677, E in {1, 33, 257, 512, 1000} and unsorted
            rows over all 128 lanes at W in {1, 37, 100, 128}); S1/S10
            (B2) and S2/S11 sub_gather bit for bit
            (M at each boundary of its plan, 1 to 7264, R / M of 1, 5
            and 15, ids at 0 and M - 1, int32 words and NaN payloads);
            S4/S5 elementwise
            bit for bit (every body and dtype at 1,001 rows and at an
            element count that is no multiple of the 16 B vector, with
            NaN, -0.0, inf and subnormal inputs, aliased and distinct
            inputs, and at one element short of and one past a vector,
            a tile and a wave of tiles; NaN
            positions must match and every other word be equal, and each
            case says whether the NaN words were equal too); S6
            block_rowsum at rtol 1e-5, atol 1e-5 (bm in {1, 37, 1024}, R
            = bm and 5 bm, negative values) with two launches bit-equal;
            then each kernel's loop_bench time, its plain version's, its
            host enqueue time, one library call's where one computes the
            same function (scatter_add_, torch.gather, torch.add,
            torch.sum) and its bound at the scripts' shapes (S5's from
            unique bytes: an aliased input is read once); S3/S12 once
            at each of wg 8, 16, 32 and W; S7 also replayed from a CUDA
            graph of 20 calls, and torch.cumsum(part, 0) beside it (the
            same bytes, not the same function); and B1 itself at
            profile_kernel's shape: its time, plain and scatter_reduce
            times and bound (the kernels line's
            chunk_partials@profile_kernel entry);
12. sssp    bench.py's sssp config on the pairs phase's relabelled
            graph: pair_threshold 16, min_fill 24, hops, no delta,
            sparse iterations on, one part, through
            sssp.build_engine(...); started at the relabelled id of the
            smallest input id with an out-edge (bench.py's vertex 0 has
            none in this graph); labels bit-equal to a level-synchronous
            numpy BFS, the host and device audits at 0 violations, at
            least one dense and one sparse iteration, B1 launched only
            by dense iterations (the residual chunks plus each pair
            block), at most one host sync an iteration (torch's sync
            debug mode over the converge), the same launches step by
            step; timed converges (wall and CUDA-event spans, GTEPS as
            bench.py reckons it), one converge under torch.profiler (its
            device time against its wall time: the idle share; the
            kernels by time), per-layer device ms of one dense and one
            sparse iteration (and each replayed from a CUDA graph), and
            B1 on the path's own int32 residual chunks and pair rows
            (min) against its plain version, two launches bit-equal (the
            kernels line's chunk_partials@sssp entry);
13. cc      bench.py's cc config: R-MAT two scales under --scale (19;
            bench.py's cc runs 20),
            symmetrized, pair_relabel, pair_threshold 16, min_fill 24,
            one part, through components.build_engine(...); the same
            checks with max, labels bit-equal to scipy's components
            (each one's largest relabelled id) (chunk_partials@cc);
14. colfilter bench.py's colfilter config (bench.py:1012-1033): R-MAT 16,
            ef 128, seed --seed, weights 1..5; (a) pair_relabel,
            threshold 16, min_fill 22 (what the reference resolves
            "auto" to at K = 20), tile_e 128, pair rows monolithic (the
            default by the 1 GB rule) and streamed; (b) no pairs, tile_e
            512; (c) gather="paged" on the degree-relabelled graph; each
            through colfilter.build_engine and run, 10 iterations: TF32
            off, the state within rtol 1e-5, atol 1e-8 of the float64
            oracle (colfilter_oracle: the numpy oracle's recurrence in
            float64 on the card), three runs bit-equal, B1 and B2 launched 0 times,
            both audits at 0 (RMSE does not rise), the reduce from a
            state in {-1, 0, 1} bit-equal to the int64 oracle; times,
            GTEPS, host enqueue, peak memory, set-up seconds, per-layer
            device ms (fetch, D, lane select, messages, one-hot reduce,
            combine_chunks, class combine, apply), device launches an
            iteration (torch.profiler) and the step at the default
            blocks (1 GB of D a block) against the reference's;
15. batch   kernel B1's batched form (csrc/chunk_partials_batched.cu,
            [C, E, B] -> [C, W, B]) against its plain version on
            synthetic shapes (B in {1, 2, 3, 4, 8, 9, 16, 64}: each
            column group and a partial one; sorted and unsorted rows,
            paged-like E = 128 rows at ~95% pads with whole all-pad
            steps, rows switching between sorted and unsorted steps,
            threads whose entries descend, E % 4 != 0, C = 0,
            unaligned bases, lanes outside [0, W), int32 extremes, NaN
            for min/max; f32 sums within E * 2^-23 * sum|v| over the
            lane, the rest bit-equal; three launches bit-equal at B = 4
            and 8 sorted and on the paged-like rows; a strided view
            refused); then bench.py's
            ksssp-batch@8 and ppr-batch@8 (bench.py:941-976; run ppr,
            the serve phase, then ksssp, printed in that order) uncut: R-MAT
            one scale under --scale (20), --ef, --seed, one part, no
            relabel, B = 8 sources from default_rng(7); ksssp through
            sssp.build_engine(sources=...) to convergence, every
            iteration dense, labels bit-equal to a numpy BFS from
            each source and two columns to single-source scalar runs, B1's
            batched form launched once an iteration and the scalar B1
            and B2 never, at most one host sync an iteration; ppr
            through pagerank.build_engine(sources=...) for 20
            iterations within rtol 5e-5 of the float64 oracle; for each,
            times, GTEPS and query_gteps (B x GTEPS), host enqueue and
            syncs an iteration, per-layer device ms (gather, batched
            B1, combine, apply) and B1's batched form on the path's own
            messages against its plain version (the kernels line's
            chunk_partials_batched@ entries);
16. serve   serve.Server on the same graph, batch 8, seg_iters 2,
            deadline 0, bench.py's SLO targets: a warm-up query of each
            kind, then 36 queries (12 sssp, 12 components, 12
            pagerank, seeded order and sources) drained with every
            launch count at 0; every answer against its oracle (BFS
            levels and reachability, the float64 PageRank oracle at the
            query's iterations), a boundary that retired and refilled,
            serve_retired_total = 36, only B1's batched form launched;
            p50 / p99 latency, per-kind iterations and segments;
17. batch_paged  the batch phases' graph and sources degree-relabelled
            (128-aligned) on gather="paged" and "pagemajor": ksssp-batch@8
            labels bit-equal to the batch phase's and ppr-batch@8 within
            rtol 5e-5, atol 1e-9 of its float64 oracle (both mapped
            through the relabel); B1's batched form launched once an
            iteration, B2 and the scalar B1 never, at most one host sync
            an iteration; B1's batched form on the paths' own [Rp, 128,
            8] rows against its plain version (int32 min bit-equal over
            all rows, f32 sums per element on 2^18 rows), on the same
            rows with NaN / int32-min in every dead lane, three launches
            bit-equal (the kernels line's chunk_partials_batched@*_paged
            entries); per-layer ms (page fetch, page-major lane-index
            take, lane resolve, messages, B1 batched, class combine,
            apply / update), step ms, query_gteps, peak, plan seconds;
18. guarded the watchdog on the pairs phase's streamed engine (state
            bit-equal to the plain run, B1's launches unchanged, at most
            one host sync more, the word clean; plain and guarded step
            ms in turns, host enqueue, the added ops alone), a NaN drill
            after iteration 3 of 10 (HealthError nonfinite_state at
            global iteration 3, part 0; one iteration executed, its
            state kept), resilience.supervised_run in segments of 2
            with a seeded crash and with a bit-flipped newest
            checkpoint (bit-equal to the plain run; checkpoint bytes and
            save ms), a DurationBudget of ~2.5 iterations (its lock,
            bits unchanged); the sssp phase's converge_health (labels
            bit-equal, one sync an iteration, converge ms in turns);
            ksssp-batch@8 guarded (labels equal); ROADMAP A9's
            livelock repro on the card: HealthError [frontier_stall] at
            the CPU run's iteration.  The pairs, sssp and batch
            phases return their engines and plain results; main runs
            each engine's cases as its phase returns and frees it (held
            to the end, the engines would count in later phases'
            peaks); this phase runs the livelock repro and prints
            every case;
19. reorder (runs after pagemajor) bench.py's gather-ab path on its
            community shape (bench.py:798-869), uncut:
            community_graph(three scales under --scale: 18, edge factor
            16, community_scale 8, p_in 0.98, --seed, scrambled) and
            three sides: "none" (degree_relabel), page_reorder "native"
            and "hillclimb" (continuing the native side's order:
            page_reorder(start=));
            each side's reorder seconds a candidate and the candidates'
            padded_fill / page_ratio / rows (hillclimb's chosen fill no
            lower than any candidate's), the paged plan's seconds (the
            hillclimb side's engine build with its sort sites both
            ways) and Rp; on the native and hillclimb sides B2 against
            its plain version bit for bit on the engine's own rows, and
            after the run B1 on the path's own rows (two launches
            bit-equal), each with its kernels-line entry
            (lane_shuffle@reorder_<side>, chunk_partials@reorder_<side>);
            PageRank gather="paged", 10 iterations against the float64
            oracle of that side's graph with B2 and B1 launched once an
            iteration each; the step ms, the layers (page fetch, B2, B1,
            class combine, apply) and peak memory; gather="flat" on the
            hillclimb graph as the yardstick (B1 once an iteration, B2
            never); flat and paged on the hillclimb graph timed on the
            card alone (``device_ms``: the host's enqueue held off the
            clock; both steps are host bound here) in turns, three
            rounds, and gather="auto" required to resolve the faster by
            median; the .perm sidecar round trip (write_perm_sidecar,
            then Graph.from_file(reorder=True), mmap and native loader,
            equal to the hillclimb graph);
20. observe (ROADMAP A10a; printed after guarded, gathered as the
            phases hand their engines over; the pairs engine is kept
            through the probes phase, so the profiler sessions below
            follow the probes' S7 count) timed_phases(state, 3) on
            main, pairs (monolithic
            and streamed) and paged, and on every sssp iteration: the
            reference's phase names in order, the state bit-equal to
            run's (push: converge's), each phase's ms beside the plain
            step's; on the pairs cell (streamed) run_stats(state, 10):
            the state bit-equal to run's, every counter row equal to the
            stepwise counters, max / sum over parts equal to the scalars
            bitwise, zero host syncs before the fetch, its ms and host
            enqueue against run in turns and the aten ops it adds an
            iteration (a TorchDispatchMode count); one profiling.trace
            session over 10 iterations (10 lux_exchange / lux_gather /
            lux_reduce / lux_apply host ranges in the Chrome trace; the
            pull idle share from the trace's kernels, copies and fills);
            the plain run's host enqueue with the ranges entered and
            without, in turns; a supervised run (segments of 2,
            checkpointed) under an EventLog whose trace_export passes
            validate_trace with no error, RunReport.counters the
            digest; the NaN fault under a flight recorder: FLIGHT.json
            read back with its reason and the health_trip word; on the
            sssp cell converge_stats: every frontier size, out-edge sum
            and per-part row equal, bit for bit, to what the engine's
            own steps give one at a time (the BFS level sizes beside
            them: a sparse queue past its edge budget keeps its
            unexpanded suffix active, so the two part), the same host
            syncs as converge, its cost in turns;
            MemoryLedger.for_engine of the pairs and ksssp_batch engines
            against the allocator's peak over a run (verdicts printed,
            not raised); on the serve phase's drain a MemoryTrail
            (Server.mem): every sample graded measured, its peak equal
            to max_memory_allocated over the drain;
21. pricing (ROADMAP A10b; printed after observe, gathered as the
            phases run) observe.calibrate() on the card (its
            fingerprint; canonical on the constants' own card); a
            gather over float32 state tables of 8-256 MB (33,554,432
            random ids: the flat rates and the table-size step);
            observe.decompose on main, pairs (monolithic), sssp and
            colfilter (pairs, monolithic) at their cells' sizes: each
            phase's ms beside the model, its verdict, the share of the
            split the verdicts cover; gather="auto" on the paged cell's
            R-MAT 21 graph and the reorder cell's hillclimb graph, which
            must resolve to the mode the smoke measured fastest there;
            pair_min_fill="auto" on bench.py's pagerank config beside
            bench.py's fill 24: each a monolithic engine's step ms and
            rows; every
            figure of scalemodel.CardConstants as measured here (from
            these and the phases' own layer times, as
            scalemodel.H100_SOURCES names them) beside the package's
            table, with the combine timed both ways on main's and
            colfilter's partials; the memory ledger's new ratios (pairs streamed,
            ksssp_batch, the Server) with their verdicts at MEM_TOL;
22. mxu     (ROADMAP A8) use_mxu=True against use_mxu=False: main
            PageRank through kernel S9 (one launch an iteration, B1
            none; rtol 2e-5 of the B1 path, MAIN_TOL of the oracle; S9
            against its plain version on the path's chunks at rtol
            1e-5 and an atol scaled to the largest partial, raising on
            lanes it does not take, and its kernels-line entry
            onehot_reduce@main_mxu), ppr_batch (B = 8, rtol 5e-5),
            colfilter (rtol 1e-5), sssp and cc (labels and iterations
            bit-equal); each side's step (push: converge) ms, what
            use_mxu="auto" resolved to and, on main and colfilter, the
            model's price of each side and whether "auto" took the
            faster;
23. live    (ROADMAP A11a; after batch_paged) bench.py's serve-live
            traffic (bench.py:527-700) on the batch phases' R-MAT 20
            graph with integer weights 1..5 (float32): a LiveGraph of
            65,536 delta slots (compact_threshold 0.75, a WAL in a
            temporary directory), Server(batch=4, seg_iters=2,
            weighted=True, live=, cache=True) over sssp, components and
            pagerank, a CompactionScheduler on the Server's SLO burn;
            six phases of an append batch (12,288 edges) and two waves
            of 3 queries (the second repeating the first's sources at
            the same epoch), a deletion and the honest re-seed on
            phases 2 and 4, a reweight on the others, the scheduler's
            fold at each boundary; a forced fold, LiveGraph.recover
            from the WAL and a tear_wal drill.  Required: all 36
            answers equal to the numpy oracles at their admission
            epochs (livegraph.check_live_answers, on a host thread
            beside the traffic), each re-seed equal to the engine's full
            recompute and to the numpy oracle, the recovered state and
            the torn replay bit-equal, epochs monotone, the delta step
            on the card bit-equal to the CPU's once a phase, B1 launched
            by the re-seeds and B1's batched form by the runners
            (counted, the checks' own runs left out).  Printed only:
            the scheduler's decisions, drag samples, cache hits,
            latencies, SLO burn and qps (the host's clock decides them);
            the delta step's ms at a full block and a revalidate over
            it;
24. fleet   (ROADMAP A11b; after live, before guarded) bench.py's
            serve-chaos (bench.py:405-491) on the same R-MAT 20 graph:
            FleetServer(replicas=2, batch=4, seg_iters=2, the SLO
            targets, RetryPolicy(3, 0.01, 0.1, jitter_seed=0)) over
            the serve phase's 36-query stream, checked against the
            serve phase's kept oracle answers.  Drill 1: a journal,
            heal=True (respawn jitter_seed 1), warm every (replica,
            kind), a ReplicaKillPlan on the routing target at its
            boundary 1, one run(); drill 2: a fresh fleet and journal
            dies whole (FLEET_CRASH at its first loaded boundary, armed
            on both replicas), then FleetServer.recover and one run();
            drill 3: one in-process replica and a subprocess replica
            (python -m lux_tpu_torch.fleet -worker on the same card,
            spawned at the phase's start beside drills 1-2, armed to
            hard-kill itself at its boundary 1) sent a third of the
            stream directly.  Required: the kill and the crash fired,
            failovers >= 1, one respawn, no quarantine, no shed, every
            admitted query retired once with its oracle's answer, the
            journal's open admits re-dispatched exactly, the worker's
            exit HARD_KILL_CODE and its queries failed over to r0,
            B1's batched form launched in every drill and equal to its
            plain version on a replica's own rows at B = 4 (int32 min
            bit for bit, f32 sum within the batch tolerance; the
            kernels line's chunk_partials_batched@fleet_* entries).
            Printed only: the walls, MTTR, latencies, SLO good counts,
            qps, beat ages, the routing pick.

25. audit   (ROADMAP A12b, A12c and A12a's CLI half; printed after
            guarded) lux_tpu_torch/audit.py on the card over main, paged,
            pagemajor, pagerank-mp, sssp-mp, owner_paged and
            owner_pagemajor (their step variant), pairs (monolithic and
            streamed), sssp, cc, colfilter (pairs, monolithic),
            ksssp_batch, ppr_batch and the live delta step
            (LiveGraph.register_audit on the serving sssp runner), each
            in its own phase after that phase's checks: one iteration of
            every program variant on a fresh state, mode "error" with
            the ledger (its launches left out of the phases' counts; the
            step variants under torch.cuda.set_sync_debug_mode
            "error"); per engine the variants, state-table gathers (1,
            0 on the owner exchange), host syncs and hand-kernel
            launches each variant's iteration made (the dense step must
            launch one, the dot path and the delta step none) and
            memwatch's ledger over one step's measured peak; then the
            reference's engine matrix (audit.run_repo_audit: 34 small
            configurations, its two owner paged ones included, mode
            "error" with the ledger where the reference checks it) on
            the card, the port's lockcheck, ``python -m
            lux_tpu_torch.lint`` (clean: exit 0, "lint: clean"), GCC's
            analyzer over the five native units
            (their seconds) and the CLI in this process on an R-MAT 12
            .lux: -validate -audit error -check, -validate on a copy
            with one out-degree changed (exit 2, its GraphFormatError),
            -tol 1e-7 -max-iters 500 -check, sssp -sparse 0 / 1 -check
            (the same iterations);

The last line is {"ok": true, "device": {...}}.  Any failure raises
and the script exits non-zero without that line; so does a machine
without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import resource
import runpy
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, dense bf16 tensor-core
# operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

MAIN_TOL = dict(rtol=5e-5, atol=1e-9)   # tests/test_pagerank.py:31

# bench.py's pagerank config: PAIR_THRESHOLD (bench.py:103) and the
# per-config min_fill default (bench.py:1381-1382)
PAIR_THRESHOLD = 16
PAIR_MIN_FILL = 24


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's elapsed
    seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# timing repetitions of the phases whose timed calls take tens of ms
# (the colfilter steps and their stages; the batched paged stages and
# B1's batched form over 2.5M rows): at --reps 20 their timings took
# ~60 s of the smoke's time limit
CF_REPS = 5
BATCH_PAGED_REPS = 5


def fewer_reps(args, reps: int):
    """``args`` with at most ``reps`` timing repetitions."""
    return argparse.Namespace(**{**vars(args),
                                 "reps": min(args.reps, reps)})


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, hold_ms: float = 40.0) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up,
    with the host's enqueue off the clock: a spin kernel holds the
    stream while the calls are enqueued behind it, and the events time
    the card's work alone from the hold's end (``cuda_ms`` of a step
    bound by the host's launches times the launches).  The hold must
    outlast the enqueue; it is doubled until it does, at most thrice."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(10 ** 6)
    ev[1].record()
    ev[1].synchronize()
    cycles_per_ms = 10 ** 6 / ev[0].elapsed_time(ev[1])
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        held_ms = ev[0].elapsed_time(ev[1])
        if enqueue_ms < 0.8 * held_ms:
            return ev[1].elapsed_time(ev[2]) / reps
        hold_ms = 2 * max(hold_ms, enqueue_ms)
    require(False, f"device_ms: the host took {enqueue_ms:.3f} ms to "
                   f"enqueue {reps} calls behind a {held_ms:.3f} ms hold")


def step_ms_in_turns(args, torch, engs: dict, state,
                     rounds: int = 3) -> dict:
    """Two engines' device ms a step on one state (``device_ms`` over
    ``--reps`` steps), timed in turns (a, b, b, a) ``rounds`` times:
    the samples by name."""
    a, b = engs
    ms = {a: [], b: []}
    for _ in range(rounds):
        for name in (a, b, b, a):
            eng = engs[name]
            ms[name].append(device_ms(torch, lambda eng=eng: eng.step(state),
                                      args.reps))
    return ms


def host_ms(torch, fn, reps: int) -> float:
    """Mean host wall ms to enqueue ``fn`` over ``reps`` calls, after
    one warm-up and with the device idle at the start (few enough calls
    that the launch queue never fills and blocks)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def same_bits(a, b) -> bool:
    """Bit-equal, NaN positions matching (any NaN payload)."""
    import torch
    an, bn = torch.isnan(a), torch.isnan(b)
    if not torch.equal(an, bn):
        return False
    return torch.equal(torch.where(an, torch.zeros_like(a), a),
                       torch.where(bn, torch.zeros_like(b), b))


def phase_env(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "cpu_model": cpu_model(), "nproc": len(os.sched_getaffinity(0)),
          "cpu_count": os.cpu_count()})
    return card


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives it: its "model name", and
    where a sandboxed kernel hides that ("unknown"), the vendor, family,
    model number and MHz."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                    # the first CPU only
                k, _, v = line.partition(":")
                info[k.strip()] = v.strip()
    except OSError:
        return "unknown"
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
            f" ({info.get('cpu MHz', '?')} MHz; model name unknown)")


def phase_build():
    import threading

    from lux_tpu_torch import _kernels, native
    t0 = time.perf_counter()
    host = {}

    def build_native():
        try:
            host["report"] = native.build()
        except Exception as e:            # re-raised below
            host["error"] = e

    th = threading.Thread(target=build_native)
    th.start()                         # g++ beside the nvcc processes
    rep = _kernels.build()
    th.join()
    if "error" in host:
        raise host["error"]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "native": {"compiler": native.compiler(),
                     "library": native.library_path().name,
                     "library_seconds": round(host["report"]["library"], 3),
                     "converter_seconds":
                         round(host["report"]["converter"], 3)},
          "kernels": {k: {"seconds": round(v["seconds"], 3),
                          "ptxas": [ln.strip() for ln in
                                    v["ptxas"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for k, v in rep.items()}})


class SortSites:
    """While active, every ``native.sort_kv`` call of the port runs
    both ways on the same inputs: numpy's stable sort on copies, then
    the native sort in place, each timed; the keys and every payload
    must come out equal (a stable sort's permutation is unique).  The
    seconds are kept by call site (the caller's file and function)."""

    def __init__(self):
        self.sites = {}

    def __enter__(self):
        from lux_tpu_torch import native
        self.native = native          # every site calls native.sort_kv
        self.orig = native.sort_kv
        native.sort_kv = self._sort_kv
        return self

    def __exit__(self, *exc):
        self.native.sort_kv = self.orig

    def _sort_kv(self, keys, payloads=(), threads=None, native=None):
        if native is False:
            return self.orig(keys, payloads, threads, native=False)
        frame = sys._getframe(1)
        while frame.f_code.co_filename.endswith(
                os.path.join("native", "__init__.py")):
            frame = frame.f_back
        path = frame.f_code.co_filename
        site = (f"{os.path.basename(os.path.dirname(path))}/"
                f"{os.path.basename(path)}:{frame.f_code.co_name}")
        t0 = time.perf_counter()
        k_np = keys.copy()
        p_np = tuple(p.copy() for p in payloads)
        t_copy = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.orig(k_np, p_np, threads, native=False)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.orig(keys, payloads, threads, native=True)
        t_nat = time.perf_counter() - t0
        require(np.array_equal(keys, k_np)
                and all(np.array_equal(a, b)
                        for a, b in zip(payloads, p_np)),
                f"sort site {site}: native.sort_kv and numpy disagree "
                f"on {keys.size} keys")
        rec = self.sites.setdefault(site, {"calls": 0, "keys": 0,
                                           "payloads": 0, "numpy_s": 0.0,
                                           "native_s": 0.0, "copy_s": 0.0})
        rec["calls"] += 1
        rec["keys"] += int(keys.size)
        rec["payloads"] += len(payloads)
        rec["numpy_s"] += t_np
        rec["native_s"] += t_nat
        rec["copy_s"] += t_copy

    def report(self) -> dict:
        return {k: {**v, **{t: round(v[t], 3) for t in (
                    "numpy_s", "native_s", "copy_s")}, "equal": True}
                for k, v in self.sites.items()}


def setup_both_ways(build):
    """``build()`` once under SortSites: every sort site sorts both
    ways, required equal.  ``wall_seconds`` is the run's measured wall
    time (both ways' sorts and the copies included); the set-up's
    seconds each way are DERIVED from it, not timed alone: the wall
    time less the other way's sorts and the copies.  Returns (the
    result, the report)."""
    with SortSites() as sites:
        t0 = time.perf_counter()
        out = build()
        wall = time.perf_counter() - t0
    return out, both_ways_report(wall, sites.report())


def both_ways_report(wall: float, sites: dict) -> dict:
    tot = {k: sum(v[k] for v in sites.values())
           for k in ("numpy_s", "native_s", "copy_s")}
    return {"native_seconds_derived": round(wall - tot["numpy_s"]
                                            - tot["copy_s"], 3),
            "numpy_seconds_derived": round(wall - tot["native_s"]
                                           - tot["copy_s"], 3),
            "wall_seconds": round(wall, 3), "equal": True, "sites": sites}


def phase_graph(args, torch):
    from lux_tpu_torch import native
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph
    t0 = time.perf_counter()
    src, dst, nv = rmat_edges(args.scale, args.ef, seed=args.seed)
    t_draws = time.perf_counter() - t0
    g, csc = setup_both_ways(lambda: Graph.from_edges(src, dst, nv))
    del src, dst
    t_graph = t_draws + csc["wall_seconds"]     # both ways' sorts included
    # the native generator two scales under (a measurement only; at the
    # graph's own scale it took 16 s of the smoke's time limit)
    t0 = time.perf_counter()
    rp, col, deg = native.rmat_csc(args.scale - 2, args.ef, seed=args.seed)
    t_rmat_csc = time.perf_counter() - t0
    rmat_native = {"scale": args.scale - 2,
                   "seconds": round(t_rmat_csc, 3), "ne": int(col.size),
                   "max_out_degree": int(deg.max()),
                   "max_in_degree": int(np.diff(rp.astype(np.int64),
                                                prepend=0).max())}
    del rp, col, deg
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g, num_parts=1)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    emit({"phase": "graph", "nv": g.nv, "ne": g.ne, "scale": args.scale,
          "edge_factor": args.ef, "seed": args.seed,
          "chunks": eng.tiles.n_chunks, "E": eng.tiles.E,
          "W": eng.tiles.W, "needs_scan": eng.tiles.needs_scan,
          "longest_tile_chunks": eng._plan.max_len,
          "graph_seconds": round(t_graph, 3),
          "rmat_edges_seconds": round(t_draws, 3),
          "csc_sort": csc,
          "rmat_csc_native": rmat_native,
          "max_out_degree": int(g.out_degrees.max()),
          "max_in_degree": int(g.in_degrees().max()),
          "engine_seconds": round(t_engine, 3)})
    return g, eng


def _check_case(torch, name, vals, rel, W, kind, signed=False,
                plain_on="cuda"):
    """One kernel-vs-plain comparison at the stated tolerance.  The
    plain version runs on ``plain_on`` ("cpu" for the NaN cases: its
    CPU scatter_reduce propagates NaN for certain)."""
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_plain)
    got = chunk_partials(vals, rel, W, kind)
    want = chunk_partials_plain(vals.to(plain_on), rel.to(plain_on), W,
                                kind).to(vals.device)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
            f"{want.shape}/{want.dtype}")
    if vals.dtype == torch.int32 or kind != "sum":
        ok = same_bits(got, want)
        tol = "bit-equal"
        err = 0.0 if ok else float(
            (got.double() - want.double()).abs().nan_to_num().max())
    else:
        finite = torch.isfinite(want)
        require(torch.equal(finite, torch.isfinite(got)),
                f"{name}: non-finite lanes differ")
        diff = (got.double() - want.double()).abs()[finite]
        err = float(diff.max()) if diff.numel() else 0.0
        if signed:
            E = vals.shape[1]
            atol = E * 2.0 ** -23 * float(vals.abs().nan_to_num(0.0).max())
            ok = err <= atol
            tol = f"atol {atol:.3e}"
        else:
            rel_err = (diff / want.double().abs()[finite].clamp(
                min=1e-30)).max() if diff.numel() else torch.tensor(0.0)
            ok = float(rel_err) <= 1e-5
            tol = "rtol 1e-5"
    require(ok, f"kernel case {name} disagrees with the plain version "
                f"(max abs err {err}, {tol})")
    return {"case": name, "C": vals.shape[0], "E": vals.shape[1],
            "dtype": str(vals.dtype).replace("torch.", ""), "kind": kind,
            "max_abs_err": err, "tolerance": tol}


def check_deterministic(torch, name, vals, rel, W, kind="sum"):
    """Two launches of B1 on the same inputs give the same bits: the
    kernel has no atomics, so its combine order is fixed."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    a = chunk_partials(vals, rel, W, kind)
    b = chunk_partials(vals, rel, W, kind)
    torch.cuda.synchronize()
    require(_same_words(a, b), f"B1 {name}: two launches differ in bits")
    return {"case": f"{name}/deterministic", "C": vals.shape[0],
            "E": vals.shape[1],
            "dtype": str(vals.dtype).replace("torch.", ""), "kind": kind,
            "max_abs_err": 0.0, "tolerance": "bit-equal across launches"}


B1_RUN_LENGTHS = (3, 5, 6, 7, 31, 33, 100, 129)


def b1_edge_cases(torch, gen, dev, W):
    """Kernel B1 against its plain version at the shapes on which its
    design splits, f32 and int32, sum/min/max: one lane for a whole
    chunk (a single run of E), runs crossing every 4-entry (one
    thread) and 32-entry boundary, all-pad chunks, unaligned E (1, 3,
    33, 130: the scalar path) with sorted and unsorted rows, rows that
    ascend then descend, lanes outside [0, W) with W = 100 and 37,
    unaligned base pointers, paged-shaped rows with NaN in every pad's
    value, and int32 sums that wrap past INT32_MAX.  C = 1001 leaves a
    part-filled last group where a warp takes 2 or 4 rows at once.
    f32 sums within E * 2^-23 * max|v|, the rest bit-equal."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    cases = []

    def make_vals(dtype, c, e, offset):
        n = c * e + offset
        if dtype == torch.int32:
            flat = torch.randint(-1000, 1000, (n,), generator=gen,
                                 device=dev, dtype=torch.int32)
        else:
            flat = torch.randn((n,), generator=gen, device=dev)
        return flat[offset:].view(c, e)

    def run_all(label, rel, w=W, offset=0):
        c, e = rel.shape
        for dtype in (torch.float32, torch.int32):
            for kind in ("sum", "min", "max"):
                cases.append(_check_case(
                    torch, f"{label}/{str(dtype)[6:]}_{kind}",
                    make_vals(dtype, c, e, offset), rel, w, kind,
                    signed=True))

    C = 1001
    rows = torch.arange(C, device=dev)[:, None]
    e512 = torch.arange(512, device=dev)[None, :]
    run_all("one_lane", (rows * 17 % W).expand(C, 512).to(torch.int8)
            .contiguous())
    L = torch.tensor(B1_RUN_LENGTHS, device=dev)[rows % len(B1_RUN_LENGTHS)]
    run_all("runs_cross_boundaries", torch.clamp(
        (e512 + rows // 8 % 4 + 1) // L, max=W - 1).to(torch.int8))
    for e in (512, 128):
        run_all(f"all_pad_E{e}",
                torch.full((C, e), -1, dtype=torch.int8, device=dev))
    for e in (1, 3, 33, 130):
        r = torch.randint(0, W, (C, e), generator=gen, device=dev)
        r[::2] = r[::2].sort(dim=1).values
        r = torch.where(torch.rand((C, e), generator=gen, device=dev) < 0.1,
                        -1, r)
        run_all(f"E{e}", r.to(torch.int8))
    r = torch.randint(0, W, (C, 512), generator=gen,
                      device=dev).sort(dim=1).values
    r[:, 256:] = r[:, 256:].flip(1)
    run_all("ascend_descend", r.to(torch.int8))
    r = torch.randint(-128, 128, (C, 256), generator=gen,
                      device=dev).to(torch.int8)
    for w in (100, 37):
        run_all(f"lanes_outside_W{w}", r, w)
    r = torch.randint(-1, W, (C * 512 + 1,), generator=gen,
                      device=dev).to(torch.int8)[1:].view(C, 512)
    run_all("unaligned_base", r.sort(dim=1).values.contiguous(), offset=1)
    run_all("unaligned_base_unsorted", r, offset=1)
    # a paged row's shape (a few ascending lanes at the front, pads
    # after them, four rows a warp) with NaN in every pad's value: the
    # kernel reads no pad's value, and none reaches a lane
    n_live = torch.randint(0, 24, (C, 1), generator=gen, device=dev)
    r = torch.randint(0, W, (C, 128), generator=gen,
                      device=dev).sort(dim=1).values
    r = torch.where(torch.arange(128, device=dev)[None, :] < n_live, r,
                    -1).to(torch.int8)
    for dtype in (torch.float32, torch.int32):
        for kind in ("sum", "min", "max"):
            v = make_vals(dtype, C, 128, 0)
            if dtype == torch.float32:
                v = torch.where(r < 0, float("nan"), v)
            cases.append(_check_case(
                torch, f"paged_rows_nan_pads/{str(dtype)[6:]}_{kind}", v, r,
                W, kind, signed=True))
    # int32 sums past INT32_MAX wrap mod 2^32, as the reference's do
    r = torch.randint(0, 4, (C, 512), generator=gen,
                      device=dev).sort(dim=1).values
    v = torch.randint(1 << 29, (1 << 31) - 1, (C, 512), generator=gen,
                      device=dev, dtype=torch.int64)
    for kind in ("sum", "min", "max"):
        cases.append(_check_case(torch, f"int32_wrap/{kind}",
                                 v.to(torch.int32), r.to(torch.int8), W,
                                 kind))
    wide = torch.zeros((C, W), dtype=torch.int64,
                       device=dev).scatter_add_(1, r, v)
    require(bool((wide > (1 << 31) - 1).any()), "int32_wrap: no sum wraps")
    wrapped = ((wide + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    require(torch.equal(chunk_partials(v.to(torch.int32), r.to(torch.int8),
                                       W, "sum"), wrapped),
            "int32_wrap: kernel sums are not the int64 sums mod 2^32")
    return cases


def b1_bound(torch, vals, rel, W) -> dict:
    """B1's least time on these inputs.  Bytes: every lane id read
    once, the value of every entry that matches a lane (in the 32 B
    sectors the card reads: the sectors holding at least one such
    entry; a pad's value is never needed), the output written once.
    Operations: one combine per live entry.  Counted in blocks of
    entries (a reorder side's rows hold 4.3G entries)."""
    C, E = vals.shape
    per = 32 // vals.element_size()          # entries in a 32 B sector
    flat_rel = rel.reshape(-1)
    step = per << 24                         # a whole number of sectors
    ops = sectors = 0
    for i in range(0, flat_rel.numel(), step):
        r = flat_rel[i:i + step]
        live = (r >= 0) & (r.to(torch.int16) < W)
        ops += int(live.sum())
        pad = -live.numel() % per
        if pad:
            live = torch.cat([live, live.new_zeros(pad)])
        sectors += int(live.view(-1, per).any(dim=1).sum())
    bytes_moved = C * E + sectors * 32 + C * W * vals.element_size()
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "live_entries": ops,
            "live_sectors": sectors,
            # reading every value, pads included
            "all_values_bytes": C * E * (vals.element_size() + 1)
            + C * W * vals.element_size()}


def b1_line(args, torch, vals, rel, W, name, kind="sum"):
    """The kernels-line entry of B1 on ``vals``/``rel`` reducing by
    ``kind``: kernel, plain and one-``scatter_reduce`` times, and the
    bound (``b1_bound``)."""
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_plain)
    from lux_tpu_torch.ops.segment import SCATTER_REDUCE, identity_for
    reps = args.reps
    C, E = vals.shape
    ms = cuda_ms(lambda: chunk_partials(vals, rel, W, kind), reps)
    plain_ms = cuda_ms(lambda: chunk_partials_plain(vals, rel, W, kind),
                       reps)
    relw = rel.to(torch.int64)
    idx = (torch.arange(C, device=vals.device)[:, None] * (W + 1)
           + torch.where((relw >= 0) & (relw < W), relw, W)).reshape(-1)
    del relw
    base = torch.full((C * (W + 1),), identity_for(kind, vals.dtype),
                      dtype=vals.dtype, device=vals.device)
    flat = vals.reshape(-1)
    library_ms = cuda_ms(lambda: base.scatter_reduce(
        0, idx, flat, SCATTER_REDUCE[kind], include_self=True), reps)
    del idx, base
    # a block of rows at a time: B1 is row by row, and the float64
    # copies of all [P*Rp, 128] partials of the owner paged rows would
    # take 30 GB
    errs = []
    for r0 in range(0, C, B1_CHECK_ROWS):
        v, r = vals[r0:r0 + B1_CHECK_ROWS], rel[r0:r0 + B1_CHECK_ROWS]
        got = chunk_partials(v, r, W, kind)
        want = chunk_partials_plain(v, r, W, kind)
        errs.append((got.double() - want.double()).abs().max())
        del got, want
    max_abs_err = float(torch.stack(errs).max()) if errs else 0.0
    return {"name": name, "route": "cuda",
            "source": "lux_tpu_torch/csrc/chunk_partials.cu",
            "replaces": "lux_tpu/ops/pallas_reduce.py:63",
            "shape": [C, E, W], "kind": kind,
            "dtype": str(vals.dtype).replace("torch.", ""), "launches": None,
            "max_abs_err": max_abs_err, "max_err": max_abs_err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            **b1_bound(torch, vals, rel, W),
            "library_ms": library_ms}


def phase_kernels(args, torch, eng):
    """Kernel B1 vs its plain version on the card, then its timings at
    the main path's shape on the main path's own chunks."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tiles = eng.tiles
    C, E, W = eng.num_parts * tiles.n_chunks, tiles.E, tiles.W
    # the main path's own inputs: its rel_dst and the first iteration's
    # messages
    rel_main = eng.arrays["rel_dst"].reshape(C, E)
    msgs_main = eng._messages(eng.init_state().reshape(-1)).reshape(C, E)
    cases = [_check_case(torch, "main_path_chunks", msgs_main, rel_main,
                         W, "sum")]

    def rel_with_pads(c, e, sorted_lanes):
        r = torch.randint(0, W, (c, e), generator=gen, device=dev)
        if sorted_lanes:
            r = r.sort(dim=1).values
        # lanes W//2.. of every 4th chunk stay empty; ~10% pads
        r = torch.where((torch.arange(c, device=dev)[:, None] % 4 == 0)
                        & (r >= W // 2), -1, r)
        pad = torch.rand((c, e), generator=gen, device=dev) < 0.1
        return torch.where(pad, -1, r).to(torch.int8).contiguous()

    def values(c, e, dtype, positive):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, (c, e), generator=gen,
                                 device=dev, dtype=torch.int32)
        v = torch.randn((c, e), generator=gen, device=dev)
        return v.abs() + 1e-3 if positive else v

    shapes = [("main_shape", C, E, True), ("pair_rows", 64 * 37, 128, False),
              ("odd_C", 1001, 300, False)]
    for label, c, e, sorted_lanes in shapes:
        rel = rel_with_pads(c, e, sorted_lanes)
        for dtype in (torch.float32, torch.int32):
            for kind in ("sum", "min", "max"):
                pos = dtype == torch.float32 and kind == "sum"
                cases.append(_check_case(
                    torch, f"{label}/{kind}", values(c, e, dtype, pos), rel,
                    W, kind))
        cases.append(_check_case(
            torch, f"{label}/sum_signed", values(c, e, torch.float32, False),
            rel, W, "sum", signed=True))
    # NaN lanes for min and max (the health watchdog relies on them)
    rel = rel_with_pads(257, 512, True)
    v = values(257, 512, torch.float32, False)
    v[::5, ::7] = float("nan")
    for kind in ("min", "max"):
        cases.append(_check_case(torch, f"nan/{kind}", v, rel, W, kind,
                                 plain_on="cpu"))
    cases += b1_edge_cases(torch, gen, dev, W)
    cases.append(check_deterministic(torch, "main_path_chunks", msgs_main,
                                     rel_main, W))
    emit({"phase": "kernels", "cases": len(cases), "all_pass": True,
          "detail": cases})

    # timings at the main path's shape, on the main path's chunks
    return b1_line(args, torch, msgs_main, rel_main, W, "chunk_partials")


def zero_launches():
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_batched)
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    from lux_tpu_torch.ops.onehot_reduce import onehot_reduce
    chunk_partials.launches = 0
    chunk_partials.launches_by_e = {}
    chunk_partials_batched.launches = 0
    lane_shuffle.launches = 0
    onehot_reduce.launches = 0      # kernel S9 (a system path: use_mxu)


def batched_launches() -> int:
    """B1's batched form's launch count (read_launches keeps the two
    keys the single-query phases compare)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched
    return chunk_partials_batched.launches


def b1_launches_at(E: int) -> int:
    """B1's launches at chunk length ``E`` since the counts were last
    zeroed."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    return chunk_partials.launches_by_e.get(E, 0)


def read_launches():
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    return {"chunk_partials": chunk_partials.launches,
            "lane_shuffle": lane_shuffle.launches}


def timed_run(torch, eng, iters):
    """Warm up one iteration, then run ``iters`` from a fresh state
    with every launch count at 0 just before and read just after.
    Returns (state, seconds, launches, peak device bytes, host enqueue
    seconds): the last is the host's wall time to enqueue the run, so
    a run whose enqueue takes as long as its device time is bound by
    the host's launches, not by the card."""
    eng.step(eng.init_state())                    # warm-up iteration
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = eng.init_state()
    torch.cuda.synchronize()
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    state = eng.run(state, iters)
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    launches = read_launches()
    return (state, start.elapsed_time(end) / 1e3, launches,
            torch.cuda.max_memory_allocated(), host_s)


def phase_main(args, torch, g, eng, card):
    from lux_tpu_torch.apps import pagerank
    state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
    launches = counts["chunk_partials"]
    got = eng.unpad(state)
    want = pagerank.reference_pagerank(g, args.iters)
    require(got.shape == (g.nv,) and np.isfinite(got).all(),
            "main path result is not finite [nv]")
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    ok = np.allclose(got, want, **MAIN_TOL)
    require(ok, f"main path disagrees with the float64 oracle (max rel "
                f"err {rel_err.max():.3e})")
    require(launches == args.iters,
            f"chunk_partials launched {launches} times in {args.iters} "
            f"iterations (want one per iteration)")
    require(counts["lane_shuffle"] == 0,
            "the flat path launched lane_shuffle")
    # two more timed runs (after the counts are read): the spread, and
    # whether the host's enqueue keeps up with the card
    repeats = []
    for _ in range(2):
        _s, r_secs, _c, _p, r_host = timed_run(torch, eng, args.iters)
        repeats.append({"ms_per_iter": r_secs * 1e3 / args.iters,
                        "host_enqueue_ms_per_iter":
                            r_host * 1e3 / args.iters})
    emit({"phase": "main", "app": "pagerank", "nv": g.nv, "ne": g.ne,
          "iters": args.iters, "seconds": secs,
          "ms_per_iter": secs * 1e3 / args.iters,
          "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
          "gteps": g.ne * args.iters / secs / 1e9,
          "peak_bytes": int(peak), "max_rel_err": float(rel_err.max()),
          "tolerance": MAIN_TOL, "chunk_partials_launches": launches,
          "repeats": repeats,
          "state_table_bytes": eng.num_parts * eng.vpad * 4,
          "note": "the f32 state table fits in the card's 50 MB L2",
          "card": card})
    PRICED["main_answer"] = (got, want)
    return launches


def carry_combined(torch, eng, partials, starts):
    """The engine's combine of its per-chunk partials [R*C, W] computed
    by S7 instead (measured only: the engine does not call it):
    ``carry_combine`` over the partials with the layout's chunk starts
    as int32 ``starts`` [R*C] (each part's first chunk starts a
    segment), then each tile's last chunk taken by the engine's
    SegmentPlan, edge-less tiles set to the sum's identity, cut to
    [R, vpad] (or [vpad]) as ``combine_partials`` returns it."""
    from lux_tpu_torch.ops.carry import carry_combine
    from lux_tpu_torch.ops.segment import identity_for
    t, plan, lc = eng.tiles, eng._plan, eng.arrays["last_chunk"]
    scan = carry_combine(partials, starts)
    tiles = scan[plan.take].reshape(tuple(lc.shape) + (t.W,))
    tiles = torch.where(plan.empty.reshape(tuple(lc.shape) + (1,)),
                        identity_for("sum", tiles.dtype), tiles)
    lead = tuple(lc.shape[:-1])
    return tiles.reshape(lead + (t.n_tiles * t.W,)).narrow(len(lead), 0,
                                                           eng.vpad)


# carry_combined against combine_partials: the chunk sums agree to the
# tolerance the port's f32 PageRank is held to (tests/test_torch_pagerank.py),
# not in bits: the carry adds in sequence, combine_chunks by doubling
CARRY_COMBINED_TOL = dict(rtol=2e-5, atol=0.0)


# launches of probe kernels made to measure them beside a system path
# (carry_layer), no path's own: the probes phase's guard allows these
MEASURE_LAUNCHES = {"carry_combine": 0}


def carry_layer(args, torch, eng, partials, red) -> dict:
    """S7 on the engine's own partials, beside its combine: held to
    ``red`` (``combine_partials``' result) at CARRY_COMBINED_TOL, then
    timed as the scan and take together (``carry_combine_ms``) and the
    scan alone, with the scan's byte bound.  The int32 starts are made
    once, outside the timing, as an engine would keep them.  These
    launches measure and are no path's: S7's count must rise by the
    calls made here, which MEASURE_LAUNCHES adds up."""
    from lux_tpu_torch.ops.carry import carry_combine
    before = carry_combine.launches
    starts = eng.arrays["chunk_start"].to(torch.int32).reshape(-1)
    got = carry_combined(torch, eng, partials, starts)
    torch.cuda.synchronize()
    require(got.shape == red.shape and bool(torch.isfinite(got).all()),
            f"carry_combined: shape {tuple(got.shape)} (want "
            f"{tuple(red.shape)}) or a non-finite value")
    rel = ((got - red).abs() / red.abs().clamp_min(1e-30)).max().item()
    require(torch.allclose(got, red, **CARRY_COMBINED_TOL),
            f"carry_combined disagrees with combine_partials (max rel err "
            f"{rel:.3e})")
    C, W = partials.shape
    out = {"carry_combine_ms": cuda_ms(
               lambda: carry_combined(torch, eng, partials, starts),
               args.reps),
           "carry_scan_ms": cuda_ms(lambda: carry_combine(partials, starts),
                                    args.reps),
           "carry_scan_bound_ms": C * (8 * W + 4) / HBM_BYTES_PER_S * 1e3,
           "carry_shape": [C, W], "carry_max_rel_err": rel,
           "carry_tolerance": CARRY_COMBINED_TOL}
    # one checked call, then cuda_ms's warm-up and reps, twice
    calls, made = 3 + 2 * args.reps, carry_combine.launches - before
    require(made == calls,
            f"carry_layer: S7 launched {made} times, it made {calls} calls")
    MEASURE_LAUNCHES["carry_combine"] += made
    return out


def phase_layers(args, torch, eng):
    """Device ms of each layer of one iteration, each timed alone, and
    S7 timed on the layer's partials beside the combine."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.tiled import combine_partials
    a, t = eng.arrays, eng.tiles
    state = eng.init_state()
    flat = state.reshape(-1)
    msgs = eng._messages(flat)
    C = eng.num_parts * t.n_chunks
    partials = chunk_partials(msgs.reshape(C, t.E),
                              a["rel_dst"].reshape(C, t.E), t.W, "sum")
    red = combine_partials(partials, t, a["chunk_start"], a["last_chunk"],
                           eng.vpad, "sum", eng._plan)
    reps = args.reps
    out = {
        "gather_ms": cuda_ms(lambda: eng._messages(flat), reps),
        "chunk_partials_ms": cuda_ms(lambda: chunk_partials(
            msgs.reshape(C, t.E), a["rel_dst"].reshape(C, t.E), t.W, "sum"),
            reps),
        "combine_ms": cuda_ms(lambda: combine_partials(
            partials, t, a["chunk_start"], a["last_chunk"], eng.vpad, "sum",
            eng._plan), reps),
        "apply_ms": cuda_ms(lambda: eng._apply_epilogue(state, red), reps),
        "step_ms": cuda_ms(lambda: eng.step(state), reps),
        # the host's time to enqueue each: where it reaches the device
        # time above, the card waits on the host's launches
        "combine_host_ms": host_ms(torch, lambda: combine_partials(
            partials, t, a["chunk_start"], a["last_chunk"], eng.vpad, "sum",
            eng._plan), 10),
        "step_host_ms": host_ms(torch, lambda: eng.step(state), 10),
        **carry_layer(args, torch, eng, partials, red),
    }
    emit({"phase": "layers", **out})
    PRICED["main"] = dict(out, chunks=C, E=t.E,
                          padded_vertices=eng.num_parts * eng.vpad)


def check_pagerank(g, got, want, what: str) -> float:
    """Finite [nv] result within MAIN_TOL of the oracle; returns the
    max relative error."""
    require(got.shape == (g.nv,) and np.isfinite(got).all(),
            f"{what}: result is not finite [nv]")
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **MAIN_TOL),
            f"{what} disagrees with the float64 oracle (max rel err "
            f"{rel_err.max():.3e})")
    return float(rel_err.max())


def phase_paged_graph(args, torch, g):
    """bench.py's gather-ab preprocessing on the main graph: degree
    relabel, then the 128-aligned layout both paged modes share."""
    from lux_tpu_torch.graph import ShardedGraph, degree_relabel
    t0 = time.perf_counter()
    g2, _perm = degree_relabel(g)
    t_relabel = time.perf_counter() - t0
    t0 = time.perf_counter()
    sg = ShardedGraph.build(g2, 1, vpad_align=128)
    t_layout = time.perf_counter() - t0
    emit({"phase": "paged_graph", "nv": g2.nv, "ne": g2.ne, "vpad": sg.vpad,
          "relabel_seconds": round(t_relabel, 3),
          "layout_seconds": round(t_layout, 3)})
    return g2, _perm, sg


def _same_words(a, b) -> bool:
    """Bit-equal 4-byte words, NaN payloads included."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_b2(args, torch, eng, label: str, synthetic: bool):
    """Kernel B2 against its plain version on the card, bit for bit:
    the engine's own rows (the first iteration's fetched page rows and
    its slot_lane), then (``synthetic``) int32 rows, f32 NaN payloads,
    packed words over the full 32-bit range (bit 31 set) and row
    counts that are not multiples of 512.  Returns the engine's own
    (rows, slot_lane) for timing."""
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
    from lux_tpu_torch.ops.pagegather import W, row_slots
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    a = eng.arrays
    sl = a["pg_sl"].reshape(-1, W)
    P, n_pages = a["pg_ids"].shape
    flat = eng.init_state().reshape(-1)
    pages = torch.index_select(flat.reshape(-1, W), 0,
                               a["pg_ids"].reshape(-1).long())
    base = torch.arange(P, device=dev)[:, None] * n_pages
    rows = torch.index_select(pages, 0,
                              (row_slots(a["pg_sl"]) + base).reshape(-1))

    def words(shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    cases = [(f"{label}_rows", rows, sl)]
    if synthetic:
        R = rows.shape[0]
        cases.append((f"{label}_rows/int32", words((R, W)), sl))
        nan = rows.clone()
        nbits = nan.view(torch.int32)
        # quiet and signalling NaNs with payloads, both signs
        pay = words((R, W), 1, 1 << 23)     # mantissa: never 0
        nbits[::3, ::5] = (0x7F800000 | pay[::3, ::5]) \
            .to(torch.int32)
        nbits[1::3, 2::5] = (-0x800000 | pay[1::3, 2::5]).to(torch.int32)
        cases.append((f"{label}_rows/nan_payloads", nan, sl))
        for r in (1, 7, 520, 1001, 4099):
            cases.append((f"R{r}/f32_bit31", words((r, W)).view(
                torch.float32), words((r, W))))
            cases.append((f"R{r}/int32_bit31", words((r, W)), words((r, W))))
        cases.append(("R0", words((0, W)), words((0, W))))
    detail = []
    for name, rws, sls in cases:
        got = lane_shuffle(rws, sls)
        want = lane_shuffle_plain(rws, sls)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"B2 {name}: shape/dtype")
        require(_same_words(got, want),
                f"B2 case {name} is not bit-equal to the plain version")
        detail.append({"case": name, "R": rws.shape[0],
                       "dtype": str(rws.dtype).replace("torch.", ""),
                       "nan": int(torch.isnan(rws).sum())
                       if rws.is_floating_point() else 0,
                       "bit31_words": int((sls < 0).sum()),
                       "tolerance": "bit-equal"})
    emit({"phase": "kernels", "kernel": "lane_shuffle", "path": label,
          "cases": len(detail), "all_pass": True, "detail": detail})
    return rows, sl


def b2_line(args, torch, rows, sl):
    """The kernels-line entry of B2 at a paged path's own shape."""
    from lux_tpu_torch.ops.lane_shuffle import (decode_lanes, lane_shuffle,
                                                lane_shuffle_plain)
    reps = args.reps
    lane = decode_lanes(sl)
    R = rows.shape[0]
    bytes_moved = R * rows.shape[1] * 12     # read rows + slot_lane, write
    return {"name": "lane_shuffle", "route": "cuda",
            "source": "lux_tpu_torch/csrc/lane_shuffle.cu",
            "replaces": "lux_tpu/ops/pagegather.py:1040",
            "shape": list(rows.shape), "launches": None,
            "max_abs_err": 0.0 if _same_words(
                lane_shuffle(rows, sl), lane_shuffle_plain(rows, sl))
            else float("inf"),
            "ms": cuda_ms(lambda: lane_shuffle(rows, sl), reps),
            "plain_ms": cuda_ms(lambda: lane_shuffle_plain(rows, sl), reps),
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": bytes_moved,
            "library_ms": cuda_ms(lambda: torch.gather(rows, 1, lane),
                                  reps)}


def paged_layers(args, torch, eng, keep_rows: bool = True):
    """Device ms of each layer of one paged iteration, each timed
    alone on the engine's own arrays, holding no more than two
    [Rp, 128] intermediates at a time (one reorder side's rows take 17
    GB each).  Returns (times, B1's input rows and rel ids, or None
    and None when not ``keep_rows``)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    from lux_tpu_torch.ops.pagegather import W, row_slots
    from lux_tpu_torch.ops.pairs import class_combine
    a, pp = eng.arrays, eng.page_plan
    P, n_pages = a["pg_ids"].shape
    state = eng.init_state()
    flat = state.reshape(-1)
    ids = a["pg_ids"].reshape(-1).long()
    sl = a["pg_sl"].reshape(-1, W)
    base = torch.arange(P, device=flat.device)[:, None] * n_pages

    def fetch():
        pages = torch.index_select(flat.reshape(-1, W), 0, ids)
        return torch.index_select(pages, 0,
                                  (row_slots(a["pg_sl"]) + base).reshape(-1))

    reps = args.reps
    out = {"page_fetch_ms": cuda_ms(fetch, reps)}
    rows = fetch()
    out["lane_shuffle_ms"] = cuda_ms(lambda: lane_shuffle(rows, sl), reps)
    vals = lane_shuffle(rows, sl)
    del rows
    vrs = a.get("pg_vrs")
    if vrs is not None:
        vidx = (vrs.long() + torch.arange(P, device=flat.device)[:, None]
                * sl.shape[0] // P).reshape(-1)
        out["vrow_take_ms"] = cuda_ms(
            lambda: torch.index_select(vals, 0, vidx), reps)
        vals = torch.index_select(vals, 0, vidx)
    rel = a["pg_rel"].reshape(-1, W)
    out["chunk_partials_ms"] = cuda_ms(
        lambda: chunk_partials(vals, rel, W, "sum"), reps)
    partials = chunk_partials(vals, rel, W, "sum")
    # byte bounds at these shapes: B2 reads rows and slot_lane and
    # writes out (12 B a lane); B1 as b1_bound counts it
    out["lane_shuffle_bound_ms"] = sl.numel() * 12 / HBM_BYTES_PER_S * 1e3
    out["chunk_partials_bound_ms"] = b1_bound(torch, vals, rel,
                                              W)["bound_ms"]
    if not keep_rows:
        vals = rel = None
    part3 = partials.view(P, pp.Rp, W)[:, :pp.R]
    out["class_combine_ms"] = cuda_ms(
        lambda: class_combine(pp, part3, a["pg_tp"], "sum"), reps)
    red = class_combine(pp, part3, a["pg_tp"], "sum").reshape(P, -1)
    del part3, partials
    out["apply_ms"] = cuda_ms(lambda: eng._apply_epilogue(state, red), reps)
    out["step_ms"] = cuda_ms(lambda: eng.step(state), reps)
    return out, vals, rel


def check_b1_rows(args, torch, vals, rel, label: str):
    """Kernel B1 on a paged path's own rows: against its plain version,
    two launches bit-equal, and its kernels-line entry."""
    from lux_tpu_torch.ops.pagegather import W
    cases = [_check_case(torch, f"{label}_rows", vals, rel, W, "sum"),
             check_deterministic(torch, f"{label}_rows", vals, rel, W)]
    emit({"phase": "kernels", "kernel": "chunk_partials", "path": label,
          "cases": len(cases), "all_pass": True, "detail": cases})
    return b1_line(args, torch, vals, rel, W, f"chunk_partials@{label}")


def phase_paged(args, torch, g2, sg, mode: str, want, card):
    """One paged mode end to end: engine build (plan + upload), B2
    checks on its own rows, the timed run against the oracle with both
    kernels launched once per iteration, per-layer times, then B1 on
    the path's own rows and B1's kernels-line entry at that shape."""
    from lux_tpu_torch.apps import pagerank
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g2, sg=sg, gather=mode)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    require(eng.gather == mode, f"engine resolved gather={eng.gather}")
    engine_bytes = sum(t.numel() * t.element_size()
                       for t in eng.arrays.values())
    rows, sl = check_b2(args, torch, eng, mode, synthetic=mode == "paged")
    state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
    err = check_pagerank(g2, eng.unpad(state), want, f"{mode} path")
    for k, n in counts.items():
        require(n == args.iters, f"{mode} path launched {k} {n} times in "
                                 f"{args.iters} iterations")
    pp = eng.page_plan
    line = b2_line(args, torch, rows, sl)
    layers, b1_vals, b1_rel = paged_layers(args, torch, eng)
    emit({"phase": mode, "app": "pagerank", "nv": g2.nv, "ne": g2.ne,
          "iters": args.iters, "seconds": secs,
          "ms_per_iter": secs * 1e3 / args.iters,
          "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
          "gteps": g2.ne * args.iters / secs / 1e9,
          "peak_bytes": int(peak), "engine_bytes": int(engine_bytes),
          "max_rel_err": err, "tolerance": MAIN_TOL, "launches": counts,
          "engine_seconds": round(t_engine, 3),
          "plan_seconds": round(eng.plan_seconds, 3),
          # the process's peak resident host memory so far (Linux: KiB)
          "host_peak_rss_bytes":
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
          "plan": {"R": pp.R, "Rp": pp.Rp, "Rg": pp.Rg or pp.Rp,
                   "n_pages": pp.n_pages, "classes": len(pp.classes),
                   **{k: pp.stats[k] for k in (
                       "rows", "fill", "padded_fill", "page_ratio",
                       "unique_pages", "lane_inflation", "g_rows",
                       "g_fill") if k in pp.stats}},
          "layers": layers,
          "lane_shuffle": {k: line[k] for k in (
              "shape", "ms", "plain_ms", "bound_ms", "library_ms")},
          "card": card})
    if mode == "paged":
        observed(observe_pull_split, torch, eng, "paged", "paged")
    audit_case(torch, eng, mode)
    flat = eng.init_state().reshape(-1)
    PRICED[mode] = {"layers": layers, "P": eng.num_parts, "Rp": pp.Rp,
                    "Rg": pp.Rg or pp.Rp, "n_pages": pp.n_pages,
                    "unique_pages": int(pp.stats["unique_pages"]),
                    "ne": g2.ne,
                    "delivery_ms": cuda_ms(lambda: eng._paged_red(flat),
                                           args.reps)}
    del eng, state, rows, sl, flat
    torch.cuda.empty_cache()
    b1 = check_b1_rows(args, torch, b1_vals, b1_rel, mode)
    del b1_vals, b1_rel
    torch.cuda.empty_cache()
    return counts, line, b1


# bench.py's gather-ab on its community shape: community_graph's
# defaults (lux_tpu/convert.py:176) and the sides the reorder token
# takes (bench.py:822-835)
COMMUNITY_SCALE, COMMUNITY_P_IN = 8, 0.98
# the community graph's scale under --scale: three (R-MAT 18's size;
# one, R-MAT 20's, took 85-99 s, and scale 21 213 s, of the smoke's
# time limit, which the owner phase needed)
REORDER_SCALE_UNDER = 3
REORDER_SIDES = ("none", "native", "hillclimb")


def reorder_side(g, side: str, start=None):
    """One side's vertex order: "none" is bench.py's degree_relabel,
    the others page_reorder's methods (hillclimb continuing from the
    native side's ``start``, whose candidates it would score again).
    Returns (graph, perm, report or None, seconds, seconds a
    candidate)."""
    from lux_tpu_torch.graph import degree_relabel
    from lux_tpu_torch.reorder import page_reorder
    timings = {}
    t0 = time.perf_counter()
    if side == "none":
        g2, perm = degree_relabel(g)
        rep = None
    else:
        g2, perm, rep = page_reorder(g, method=side, timings=timings,
                                     start=start)
    secs = time.perf_counter() - t0
    if rep is not None:
        chosen = rep["chosen_fill"]
        worst = [t for t, c in rep["candidates"].items()
                 if c["padded_fill"] > chosen]
        require(not worst, f"reorder {side}: chosen padded_fill {chosen} "
                           f"below candidate(s) {worst}")
    return g2, perm, rep, secs, {k: round(v, 3) for k, v in timings.items()}


def phase_reorder(args, torch, card):
    """bench.py's gather-ab path on the community graph (the module
    docstring's phase 19).  On the native and hillclimb sides B2 and
    B1 are held against their plain versions on the engine's own rows
    (the none side's rows, [35.9M, 128] at scale 21, take 17 GB each:
    its check would hold three beside the engine).  Returns (the
    launches by path, B1's and B2's kernels-line entries by path)."""
    import tempfile

    from lux_tpu_torch import format as luxfmt
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import community_graph
    from lux_tpu_torch.graph import Graph, ShardedGraph
    t0 = time.perf_counter()
    scale = args.scale - REORDER_SCALE_UNDER
    g = community_graph(scale=scale, edge_factor=args.ef,
                        community_scale=COMMUNITY_SCALE,
                        p_in=COMMUNITY_P_IN, seed=args.seed)
    t_graph = time.perf_counter() - t0
    counts_by, steps, b1_lines, b2_lines = {}, {}, {}, {}
    start = None
    for side in REORDER_SIDES:
        path = f"reorder_{side}"
        g2, perm, rep, t_reorder, timings = reorder_side(
            g, side, start if side == "hillclimb" else None)
        if side == "native":
            start = (g2, perm, rep)
        sg = ShardedGraph.build(g2, 1, vpad_align=128)
        want = pagerank.reference_pagerank(g2, args.iters)

        def build():
            e = pagerank.build_engine(g2, sg=sg, gather="paged")
            torch.cuda.synchronize()
            return e

        plan_setup = None
        if side == "hillclimb":
            # the engine's build (the paged plan's sort sites) both
            # ways, where its rows are few (the "none" side's plan
            # alone takes tens of GB)
            eng, plan_setup = setup_both_ways(build)
            t_engine = plan_setup["wall_seconds"]
        else:
            t0 = time.perf_counter()
            eng = build()
            t_engine = time.perf_counter() - t0
        checked = side != "none"
        if checked:
            rows, sl = check_b2(args, torch, eng, path, synthetic=False)
            b2_lines[path] = b2_line(args, torch, rows, sl)
            b2_lines[path]["name"] = f"lane_shuffle@{path}"
            del rows, sl
        state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
        err = check_pagerank(g2, eng.unpad(state), want, f"reorder {side}")
        require(counts == {"chunk_partials": args.iters,
                           "lane_shuffle": args.iters},
                f"reorder {side}: launched {counts} in {args.iters} "
                f"iterations (want B2 and B1 once an iteration)")
        layers, vals, rel = paged_layers(args, torch, eng,
                                         keep_rows=checked)
        pp = eng.page_plan
        steps[side] = layers["step_ms"]
        emit({"phase": "reorder", "side": side, "app": "pagerank",
              "gather": "paged", "nv": g2.nv, "ne": g2.ne,
              "iters": args.iters, "seconds": secs,
              "ms_per_iter": secs * 1e3 / args.iters,
              "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
              "gteps": g2.ne * args.iters / secs / 1e9,
              "peak_bytes": int(peak), "max_rel_err": err,
              "tolerance": MAIN_TOL, "launches": counts,
              "reorder_seconds": round(t_reorder, 3),
              "candidate_seconds": timings,
              "trail": None if rep is None else rep["candidates"],
              "chosen_fill": None if rep is None else rep["chosen_fill"],
              "baseline_fill": None if rep is None else rep["baseline_fill"],
              "engine_seconds": round(t_engine, 3),
              "plan_seconds": round(eng.plan_seconds, 3),
              "plan_setup": plan_setup,
              "host_peak_rss_bytes":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
              "plan": {"R": pp.R, "Rp": pp.Rp, "n_pages": pp.n_pages,
                       "classes": len(pp.classes),
                       **{k: pp.stats[k] for k in (
                           "rows", "fill", "padded_fill", "page_ratio",
                           "unique_pages", "lane_inflation")}},
              "layers": layers, "card": card})
        counts_by[path] = counts
        del eng, state
        torch.cuda.empty_cache()
        if checked:
            b1_lines[path] = check_b1_rows(args, torch, vals, rel, path)
            del vals, rel
            torch.cuda.empty_cache()
        if side != "hillclimb":
            del g2, sg, perm, want
    del start
    # the yardstick: the flat gather on the hillclimb graph and layout
    eng = pagerank.build_engine(g2, sg=sg, gather="flat")
    state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
    err = check_pagerank(g2, eng.unpad(state), want, "reorder flat")
    require(counts == {"chunk_partials": args.iters, "lane_shuffle": 0},
            f"reorder flat: launched {counts} in {args.iters} iterations "
            f"(want B1 once an iteration, B2 never)")
    state = eng.init_state()
    flat_step = cuda_ms(lambda: eng.step(state), args.reps)
    counts_by["reorder_flat"] = counts
    # gather="auto" is held to the faster of flat and paged on this
    # graph.  Both steps are bound by the host's launches here (enqueue
    # ms = step ms: the two windows above time the host, and one stall
    # of it decided a comparison), and the rule prices the card's work:
    # the two are timed on the card alone, in turns, and the medians
    # compared
    paged = pagerank.build_engine(g2, sg=sg, gather="paged")
    turns = step_ms_in_turns(args, torch,
                             {"flat": eng, "paged": paged}, state)
    del eng, paged, state
    torch.cuda.empty_cache()
    priced(pricing_gather_auto, args, torch, g2, sg, "community_hillclimb",
           {k: float(np.median(v)) for k, v in turns.items()})
    # the .perm sidecar round trip on the hillclimb perm
    with tempfile.TemporaryDirectory() as tmp:
        lux = os.path.join(tmp, "community.lux")
        luxfmt.write_lux(lux, g.row_ptrs, g.col_idx,
                         degrees=g.out_degrees)
        luxfmt.write_perm_sidecar(lux, perm)
        sidecar_bytes = os.path.getsize(luxfmt.perm_sidecar_path(lux))
        for use_native in (False, True):
            g3 = Graph.from_file(lux, reorder=True, use_native=use_native)
            require((g3.nv, g3.ne) == (g2.nv, g2.ne) and all(
                np.array_equal(getattr(g3, f), getattr(g2, f))
                for f in ("row_ptrs", "col_idx", "out_degrees")),
                f"the .perm sidecar round trip (use_native={use_native}) "
                f"is not the hillclimb graph")
            del g3
    emit({"phase": "reorder", "side": "flat", "app": "pagerank",
          "gather": "flat", "graph": "hillclimb", "nv": g2.nv, "ne": g2.ne,
          "iters": args.iters, "seconds": secs,
          "ms_per_iter": secs * 1e3 / args.iters,
          "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
          "gteps": g2.ne * args.iters / secs / 1e9, "step_ms": flat_step,
          "peak_bytes": int(peak), "max_rel_err": err,
          "tolerance": MAIN_TOL, "launches": counts,
          "community_graph": {"scale": scale, "edge_factor": args.ef,
                              "community_scale": COMMUNITY_SCALE,
                              "p_in": COMMUNITY_P_IN, "seed": args.seed,
                              "scrambled": True,
                              "seconds": round(t_graph, 3)},
          "paged_step_ms": steps,
          "paged_beats_flat": {k: v < flat_step for k, v in steps.items()},
          "hillclimb_device_step_ms_in_turns": turns,
          "sidecar_round_trip": True, "sidecar_bytes": sidecar_bytes,
          "card": card})
    return counts_by, b1_lines, b2_lines


# the parts phase's R-MAT scale: 17, one under its earlier 18, to keep
# the whole smoke well inside its time limit with the reorder phase
PARTS_SCALE = 17


def phase_parts(args, torch):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, degree_relabel, pair_relabel
    from lux_tpu_torch.ops.pairs import stream_blocks
    src, dst, nv = rmat_edges(PARTS_SCALE, 16, seed=args.seed + 1)
    g = Graph.from_edges(src, dst, nv)
    eng = pagerank.build_engine(g, num_parts=4, tile_e=128)
    require(eng.tiles.needs_scan, "parts phase must need the segmented "
                                  "combine")
    state = eng.init_state()
    zero_launches()
    state = eng.run(state, args.iters)
    torch.cuda.synchronize()
    counts = read_launches()
    launches = counts["chunk_partials"]
    got = eng.unpad(state)
    want = pagerank.reference_pagerank(g, args.iters)
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **MAIN_TOL),
            f"4-part run disagrees with the oracle ({rel_err.max():.3e})")
    require(launches == args.iters and counts["lane_shuffle"] == 0,
            f"4-part run launched {counts}")
    paged = {}
    g2, _perm = degree_relabel(g)
    want2 = pagerank.reference_pagerank(g2, args.iters)
    for mode in ("paged", "pagemajor"):
        peng = pagerank.build_engine(g2, num_parts=4, gather=mode)
        state = peng.init_state()
        zero_launches()
        state = peng.run(state, args.iters)
        torch.cuda.synchronize()
        pcounts = read_launches()
        err = check_pagerank(g2, peng.unpad(state), want2,
                             f"4-part {mode} run")
        require(all(n == args.iters for n in pcounts.values()),
                f"4-part {mode} run launched {pcounts}")
        paged[mode] = {"Rp": peng.page_plan.Rp, "max_rel_err": err,
                       "launches": pcounts}
    del peng
    pairs = {}
    g3, _perm, starts = pair_relabel(g, 4, pair_threshold=16)
    want3 = pagerank.reference_pagerank(g3, args.iters)
    for stream in (True, False):
        peng = pagerank.build_engine(g3, num_parts=4, starts=starts,
                                     pair_threshold=16, pair_min_fill=24,
                                     pair_stream=stream)
        state = peng.init_state()
        zero_launches()
        state = peng.run(state, args.iters)
        torch.cuda.synchronize()
        pcounts = read_launches()
        err = check_pagerank(g3, peng.unpad(state), want3,
                             f"4-part pairs (stream={stream}) run")
        per_iter = 1 + (len(stream_blocks(peng.pairs.classes)) if stream
                        else 1)
        require(pcounts == {"chunk_partials": per_iter * args.iters,
                            "lane_shuffle": 0},
                f"4-part pairs (stream={stream}) run launched {pcounts}")
        pairs["streamed" if stream else "monolithic"] = {
            "Rp": peng.pairs.Rp, "classes": len(peng.pairs.classes),
            "max_rel_err": err, "launches": pcounts}
    del peng
    owner = parts_owner(args, torch, g, want)
    push = parts_push(args, torch, g)
    cf = parts_colfilter(args, torch)
    emit({"phase": "parts", "nv": g.nv, "ne": g.ne, "num_parts": 4,
          "tile_e": 128, "chunks": eng.num_parts * eng.tiles.n_chunks,
          "iters": args.iters, "max_rel_err": float(rel_err.max()),
          "chunk_partials_launches": launches, "paged": paged,
          "pairs": pairs, "owner": owner, "push": push, "colfilter": cf})


def parts_owner(args, torch, g, want) -> dict:
    """exchange="owner" on the parts phase's graph ``g`` with 4 parts:
    PageRank against ``want``, its float64 oracle (B1 once a step over
    every part's owner chunks), then the query-batched engines, k-source
    SSSP (labels bit-equal to a BFS a column) and personalized PageRank
    (MAIN_TOL against the float64 oracle), each through B1's batched
    form once a dense iteration and the scalar B1 never."""
    from lux_tpu_torch.apps import pagerank, sssp
    out = {}
    eng = pagerank.build_engine(g, num_parts=4, exchange="owner")
    (state, counts, _syncs) = counted_sync_run(
        torch, lambda: eng.run(eng.init_state(), args.iters))
    err = check_pagerank(g, eng.unpad(state), want, "4-part owner run")
    require(counts == {"chunk_partials": args.iters, "lane_shuffle": 0,
                       "chunk_partials_batched": 0},
            f"4-part owner run launched {counts}")
    out["pagerank"] = {"owner_chunks": 4 * eng.owner.n_chunks,
                       "owner_stats": eng.owner.stats, "max_rel_err": err,
                       "launches": counts}
    del eng
    sources = sorted(int(v) for v in np.random.default_rng(
        BATCH_SOURCE_SEED).choice(g.nv, BATCH_B, replace=False))
    for mode in ("paged", "pagemajor"):
        out[f"owner_{mode}"] = parts_owner_paged(args, torch, g, want,
                                                 sources, mode)
    eng = sssp.build_engine(g, sources=sources, num_parts=4,
                            exchange="owner")
    lab0, act0 = eng.init_state()
    (label, _act, it), counts, _syncs = counted_sync_run(
        torch, lambda: eng.converge(lab0, act0))
    levels = bfs_many(g, sources)
    got = eng.unpad(label)
    for q, v in enumerate(sources):
        require(np.array_equal(got[:, q], levels[v]),
                f"4-part owner ksssp column {q} (source {v}) differs "
                f"from its BFS")
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": it},
            f"4-part owner ksssp launched {counts} in {it} iterations")
    out["ksssp_batch"] = {"B": BATCH_B, "iterations": it,
                          "launches": counts}
    del eng, label
    eng = pagerank.build_engine(g, 4, sources=sources, exchange="owner")
    (state, counts, _syncs) = counted_sync_run(
        torch, lambda: eng.run(eng.init_state(), args.iters))
    ref = ppr_oracle(g, pagerank.one_hot_resets(g.nv, sources), args.iters)
    got = eng.unpad(state)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    require(np.isfinite(got).all() and np.allclose(got, ref, **MAIN_TOL),
            f"4-part owner ppr disagrees with the float64 oracle "
            f"({rel.max():.3e})")
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": args.iters},
            f"4-part owner ppr launched {counts}")
    out["ppr_batch"] = {"B": BATCH_B, "max_rel_err": float(rel.max()),
                        "launches": counts}
    del eng
    torch.cuda.empty_cache()
    return out


def parts_owner_paged(args, torch, g, want, sources, mode) -> dict:
    """exchange="owner" with ``gather=mode`` on the parts phase's graph
    with 4 parts (128-aligned): PageRank against ``want`` (B2 and B1
    once a step), then k-source SSSP (labels bit-equal to a BFS a
    column) and personalized PageRank (MAIN_TOL against the float64
    oracle), each through B1's batched form once a dense iteration, the
    scalar kernels never."""
    from lux_tpu_torch.apps import pagerank, sssp
    out = {}
    eng = pagerank.build_engine(g, num_parts=4, exchange="owner",
                                gather=mode)
    require(eng.exchange == "owner" and eng.gather == mode,
            f"4-part owner {mode}: resolved {eng.exchange}/{eng.gather}")
    (state, counts, _syncs) = counted_sync_run(
        torch, lambda: eng.run(eng.init_state(), args.iters))
    err = check_pagerank(g, eng.unpad(state), want, f"4-part owner {mode}")
    require(counts == {"chunk_partials": args.iters,
                       "lane_shuffle": args.iters,
                       "chunk_partials_batched": 0},
            f"4-part owner {mode} launched {counts}")
    out["pagerank"] = {"Rp": eng.page_plan.Rp, "Mg": eng.page_plan.route,
                       "max_rel_err": err, "launches": counts}
    del eng
    eng = sssp.build_engine(g, sources=sources, num_parts=4,
                            exchange="owner", gather=mode)
    lab0, act0 = eng.init_state()
    (label, _act, it), counts, _syncs = counted_sync_run(
        torch, lambda: eng.converge(lab0, act0))
    levels = bfs_many(g, sources)
    got = eng.unpad(label)
    for q, v in enumerate(sources):
        require(np.array_equal(got[:, q], levels[v]),
                f"4-part owner {mode} ksssp column {q} (source {v}) "
                f"differs from its BFS")
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": it},
            f"4-part owner {mode} ksssp launched {counts} in {it} "
            f"iterations")
    out["ksssp_batch"] = {"iterations": it, "launches": counts}
    del eng, label
    eng = pagerank.build_engine(g, 4, sources=sources, exchange="owner",
                                gather=mode)
    (state, counts, _syncs) = counted_sync_run(
        torch, lambda: eng.run(eng.init_state(), args.iters))
    ref = ppr_oracle(g, pagerank.one_hot_resets(g.nv, sources), args.iters)
    got = eng.unpad(state)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    require(np.isfinite(got).all() and np.allclose(got, ref, **MAIN_TOL),
            f"4-part owner {mode} ppr disagrees with the float64 oracle "
            f"({rel.max():.3e})")
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": args.iters},
            f"4-part owner {mode} ppr launched {counts}")
    out["ppr_batch"] = {"max_rel_err": float(rel.max()), "launches": counts}
    del eng
    torch.cuda.empty_cache()
    return out


def b1_step_paths(rel, W) -> dict:
    """How kernel B1 takes the 128-entry (32 threads x 4) steps of rows
    ``rel`` [C, E], E a multiple of 128, counted on the host: a step
    with no live entry is skipped; one whose live lanes, in entry
    order, never fall takes the segmented-scan path; any other the
    __match_any_sync path (the kernel's ballot in step())."""
    import torch
    steps = rel.reshape(-1, 128).cpu().to(torch.int16)
    live = (steps >= 0) & (steps < W)
    keyed = torch.where(live, steps, torch.full_like(steps, -1))
    running = torch.cummax(keyed, dim=1).values
    falls = (live[:, 1:] & (keyed[:, 1:] < running[:, :-1])).any(dim=1)
    has = live.any(dim=1)
    n_live = live.sum(dim=1)
    return {"steps": steps.shape[0], "all_pad": int((~has).sum()),
            "sorted": int((has & ~falls).sum()),
            "match_any": int((has & falls).sum()),
            "live_entries_per_live_step":
                float(n_live[has].double().mean()) if has.any() else 0.0}


def pair_layers(args, torch, eng):
    """Device ms of each layer of one pair-lane iteration, each timed
    alone on the engine's own arrays: the residual's gather, B1 and
    segmented combine; the pair rows' fetch, B1 and class combine
    (streamed: summed over the blocks, each layer's blocks timed as one
    loop); combine_op; apply.  Returns (layers, the monolithic pair
    rows' values and rel for the B1 checks)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.pairs import (W, _reduce_depth, _take_slots,
                                         class_combine, stream_blocks)
    from lux_tpu_torch.ops.tiled import combine_op, combine_partials
    a, t, sp = eng.arrays, eng.tiles, eng.pairs
    P, reps = eng.num_parts, args.reps
    state = eng.init_state()
    flat = state.reshape(-1)
    msgs = eng._messages(flat)
    C = P * t.n_chunks
    msgs_res = msgs.reshape(C, t.E)
    rel_res = a["rel_dst"].reshape(C, t.E)
    partials = chunk_partials(msgs_res, rel_res, t.W, "sum")
    red = combine_partials(partials, t, a["chunk_start"], a["last_chunk"],
                           eng.vpad, "sum", eng._plan)
    res_line = b1_line(args, torch, msgs_res, rel_res, t.W,
                       "chunk_partials@pairs_residual")
    out = {
        "residual_gather_ms": cuda_ms(lambda: eng._messages(flat), reps),
        "residual_chunk_partials_ms": res_line["ms"],
        "residual_chunk_partials_bound_ms": res_line["bound_ms"],
        "residual_chunk_partials_plain_ms": res_line["plain_ms"],
        "residual_scatter_reduce_ms": res_line["library_ms"],
        "segmented_combine_ms": cuda_ms(lambda: combine_partials(
            partials, t, a["chunk_start"], a["last_chunk"], eng.vpad, "sum",
            eng._plan), reps),
        **carry_layer(args, torch, eng, partials, red),
    }
    s2d = flat.reshape(-1, W)
    rb = a["pair_rowbind"].reshape(-1).long()
    rel = a["pair_rel"].reshape(-1, W)

    def fetch():
        return torch.index_select(s2d, 0, rb)

    vals = fetch()
    pparts = chunk_partials(vals, rel, W, "sum")
    part3 = pparts.view(P, sp.Rp, W)[:, :sp.R]
    tp = a["pair_tile_pos"]
    if eng.pair_stream:
        blocks = stream_blocks(sp.classes)
        rb2 = a["pair_rowbind"]
        rl2 = a["pair_rel"]
        bidx = [rb2[:, r0:r0 + S * L].reshape(-1).long()
                for r0, S, L in blocks]
        brel = [rl2[:, r0:r0 + S * L].reshape(-1, W) for r0, S, L in blocks]
        bvals = [torch.index_select(s2d, 0, i) for i in bidx]
        bparts = [chunk_partials(v, r, W, "sum").view(P, S, L, W)
                  for v, r, (_r0, S, L) in zip(bvals, brel, blocks)]

        def combine():
            outs = [_reduce_depth(p, "sum") for p in bparts]
            return _take_slots(outs, tp, "sum", torch.float32, flat.device,
                               (W,))

        out.update(
            pair_blocks=len(blocks),
            pair_fetch_ms=cuda_ms(lambda: [torch.index_select(s2d, 0, i)
                                           for i in bidx], reps),
            pair_chunk_partials_ms=cuda_ms(lambda: [
                chunk_partials(v, r, W, "sum")
                for v, r in zip(bvals, brel)], reps),
            pair_combine_ms=cuda_ms(combine, reps))
        del bvals, bparts
    else:
        out.update(
            pair_blocks=1,
            pair_fetch_ms=cuda_ms(fetch, reps),
            pair_chunk_partials_ms=cuda_ms(
                lambda: chunk_partials(vals, rel, W, "sum"), reps),
            pair_combine_ms=cuda_ms(
                lambda: class_combine(sp, part3, tp, "sum"), reps))
    out["pair_chunk_partials_bound_ms"] = b1_bound(torch, vals, rel,
                                                   W)["bound_ms"]
    pred = eng._pair_red(flat)
    out["pair_delivery_ms"] = cuda_ms(lambda: eng._pair_red(flat), reps)
    out["combine_op_ms"] = cuda_ms(lambda: combine_op("sum")(red, pred),
                                   reps)
    both = combine_op("sum")(red, pred)
    out["apply_ms"] = cuda_ms(lambda: eng._apply_epilogue(state, both), reps)
    out["step_ms"] = cuda_ms(lambda: eng.step(state), reps)
    out["step_host_ms"] = host_ms(torch, lambda: eng.step(state), 10)
    return out, vals, rel


def pair_relabelled(g):
    """bench.py's preprocessing for its pair configs: pair_relabel with
    one part, every sort both ways -> (relabelled graph, perm, starts,
    the relabel's SortSites report)."""
    from lux_tpu_torch.graph import pair_relabel
    (g2, perm, starts), setup = setup_both_ways(
        lambda: pair_relabel(g, 1, pair_threshold=PAIR_THRESHOLD))
    return g2, perm, starts, setup


def phase_pairs(args, torch, g2, starts, relabel, card):
    """bench.py's pagerank config (bench.py:987-1011) on the main graph
    ``g2`` (pair_relabelled, with its cut points ``starts``; ``relabel``
    the relabel's SortSites report), once with each pair_stream
    setting.  The monolithic engine's build (layout, pair plan, upload)
    runs under SortSites too: with the relabel it is the set-up both
    ways, printed on the first line.  Returns (launches by setting, the
    kernels-line entry of B1 on the pair rows, the streamed engine's
    guarded case: the engine, its plain state and its pair blocks)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.pairs import stream_blocks
    want = pagerank.reference_pagerank(g2, args.iters)
    counts_by = {}
    for stream in (False, True):
        label = "streamed" if stream else "monolithic"

        def build():
            e = pagerank.build_engine(g2, 1, pair_threshold=PAIR_THRESHOLD,
                                      pair_min_fill=PAIR_MIN_FILL,
                                      starts=starts, pair_stream=stream)
            torch.cuda.synchronize()
            return e

        setup = None
        if stream:
            t0 = time.perf_counter()
            eng = build()
            t_engine = time.perf_counter() - t0
        else:
            eng, built = setup_both_ways(build)
            t_engine = built["wall_seconds"]
            setup = both_ways_report(
                relabel["wall_seconds"] + t_engine,
                {**{f"relabel {k}": v for k, v in relabel["sites"].items()},
                 **{f"engine {k}": v for k, v in built["sites"].items()}})
        require(eng.pair_stream is stream and eng.tiles.E == 128,
                f"pairs {label}: engine resolved stream={eng.pair_stream} "
                f"E={eng.tiles.E}")
        sp = eng.pairs
        blocks = len(stream_blocks(sp.classes)) if stream else 1
        state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
        err = check_pagerank(g2, eng.unpad(state), want, f"pairs {label}")
        require(counts == {"chunk_partials": (1 + blocks) * args.iters,
                           "lane_shuffle": 0},
                f"pairs {label} launched {counts} in {args.iters} "
                f"iterations (want B1 {1 + blocks} a iteration: the "
                f"residual chunks and {blocks} pair launch(es); B2 none)")
        repeats = []
        for _ in range(2):
            _s, r_secs, _c, _p, r_host = timed_run(torch, eng, args.iters)
            repeats.append({"ms_per_iter": r_secs * 1e3 / args.iters,
                            "host_enqueue_ms_per_iter":
                                r_host * 1e3 / args.iters})
        layers, vals, rel = pair_layers(args, torch, eng)
        engine_bytes = sum(t.numel() * t.element_size()
                           for t in eng.arrays.values())
        emit({"phase": "pairs", "pair_stream": stream, "app": "pagerank",
              "nv": g2.nv, "ne": g2.ne, "iters": args.iters,
              "pair_threshold": PAIR_THRESHOLD, "min_fill": PAIR_MIN_FILL,
              "tile_e": eng.tiles.E, "seconds": secs,
              "ms_per_iter": secs * 1e3 / args.iters,
              "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
              "gteps": g2.ne * args.iters / secs / 1e9,
              "repeats": repeats, "peak_bytes": int(peak),
              "engine_bytes": int(engine_bytes), "max_rel_err": err,
              "tolerance": MAIN_TOL, "launches": counts,
              "relabel_seconds": relabel["wall_seconds"],
              "pair_plan_seconds": round(eng.plan_seconds, 3),
              **({} if stream else {"setup_both_ways": setup}),
              "engine_seconds": round(t_engine, 3),
              "host_peak_rss_bytes":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
              "plan": {"R": sp.R, "Rp": sp.Rp, "classes": len(sp.classes),
                       "n_slots": sp.n_slots, "blocks": blocks,
                       "covered": sp.stats["covered"],
                       "coverage": sp.stats["coverage"],
                       "inflation": sp.stats["inflation"],
                       "residual_edges": int(eng.sg.ne_part.sum()),
                       "residual_chunks": eng.num_parts * eng.tiles.n_chunks,
                       "needs_scan": eng.tiles.needs_scan,
                       "longest_tile_chunks": eng._plan.max_len},
              "layers": layers, "card": card})
        counts_by[label] = counts
        observed(observe_pull_split, torch, eng, f"pairs_{label}")
        audit_case(torch, eng, f"pairs_{label}")
        if not stream:
            del eng, state, vals, rel
            torch.cuda.empty_cache()
    # B1's own checks and timing at the pair rows, once (both settings
    # deliver the same rows)
    b1 = check_pair_rows(args, torch, eng, vals, rel)
    del vals, rel
    torch.cuda.empty_cache()
    return counts_by, b1, (eng, state, blocks)


def check_pair_rows(args, torch, eng, vals, rel):
    """Kernel B1 on the pair config's own rows [Rp, 128] (sum, min,
    max against its plain version, two launches bit-equal) and on its
    residual chunks; the host count of each path's step kinds; B1's
    kernels-line entry at the pair rows."""
    res = eng.arrays["rel_dst"].reshape(-1, 128)
    res_msgs = eng._messages(eng.init_state().reshape(-1)).reshape(res.shape)
    paths = {"pair_rows": b1_step_paths(rel, 128),
             "residual_chunks": b1_step_paths(res, 128)}
    cases = [_check_case(torch, f"pairs_rows/{kind}", vals, rel, 128, kind)
             for kind in ("sum", "min", "max")]
    cases.append(check_deterministic(torch, "pairs_rows", vals, rel, 128))
    cases.append(_check_case(torch, "pairs_residual_chunks", res_msgs, res,
                             128, "sum"))
    del res_msgs, res
    emit({"phase": "kernels", "kernel": "chunk_partials", "path": "pairs",
          "cases": len(cases), "all_pass": True, "detail": cases,
          "step_paths": paths})
    b1 = b1_line(args, torch, vals, rel, 128, "chunk_partials@pairs")
    b1["step_paths"] = paths["pair_rows"]
    return b1



# ---------------------------------------------------------------------
# the push engine: bench.py's sssp and cc configs, and 4 parts
# ---------------------------------------------------------------------

SYNC_WARNING = "synchronizing CUDA operation"


def first_out_vertex(g) -> int:
    """The smallest input id with an out-edge: bench.py's sssp starts
    at vertex 0 (bench.py:1062-1066), which has none in R-MAT seed 0,
    so a run from it would stop after one iteration."""
    has = np.flatnonzero(np.asarray(g.out_degrees) > 0)
    require(has.size > 0, "the graph has no edge")
    return int(has[0])


# host threads for the smoke's numpy oracles of many sources (their
# large array operations release the GIL)
ORACLE_THREADS = max(1, min(8, os.cpu_count() or 1))


def bfs_many(g, sources) -> dict:
    """bfs_levels from each of ``sources``, on ORACLE_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor
    edges = g.edge_arrays()
    srcs = sorted({int(s) for s in sources})
    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as ex:
        return dict(zip(srcs, ex.map(lambda s: bfs_levels(g, s, edges),
                                     srcs)))


def relabelled_id(perm, v: int) -> int:
    """The new id of input vertex ``v`` under ``perm`` (perm[new] =
    old)."""
    return int(np.flatnonzero(np.asarray(perm) == v)[0])


def bfs_levels(g, start: int, edges=None) -> np.ndarray:
    """Level-synchronous BFS over the edge list -> int32 hop counts,
    HOP_INF where unreached: the hop SSSP's exact fixed point.
    ``edges``: g.edge_arrays(), when the caller holds them."""
    from lux_tpu_torch.apps.sssp import HOP_INF
    src, dst = g.edge_arrays() if edges is None else edges
    dist = np.full(g.nv, HOP_INF, np.int32)
    dist[start] = 0
    level = 0
    while True:
        reach = dst[dist[src] == level]
        reach = reach[dist[reach] == HOP_INF]
        if reach.size == 0:
            return dist
        level += 1
        dist[reach] = level


def components_oracle(g):
    """Each vertex's component's largest id (the max-propagation fixed
    point on a symmetrized graph), through scipy -> (int64 labels,
    component sizes)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    src, dst = g.edge_arrays()
    m = csr_matrix((np.ones(src.size, np.int8), (src, dst)),
                   shape=(g.nv, g.nv))
    n, comp = connected_components(m, directed=True, connection="weak")
    top = np.full(n, -1, np.int64)
    np.maximum.at(top, comp, np.arange(g.nv, dtype=np.int64))
    return top[comp], np.bincount(comp, minlength=n)


def dense_launches(eng) -> dict:
    """Kernel launches of one dense push iteration: B1 once over the
    chunks (the tiled or owner chunks, or the paged rows; an owner
    layout past the stream budget once a block of each part) plus once
    a pair block; B2 once on the paged paths."""
    from lux_tpu_torch.ops.pairs import stream_blocks
    if eng.page_plan is not None:
        return {"chunk_partials": 1, "lane_shuffle": 1}
    lay = getattr(eng, "owner", None)
    if lay is not None and "own_ep" in eng.arrays:   # fused streamed
        import math

        from lux_tpu_torch.ops.tiled import STREAM_BLOCK_CHUNKS
        return {"chunk_partials": eng.num_parts * math.ceil(
            lay.n_chunks / STREAM_BLOCK_CHUNKS), "lane_shuffle": 0}
    pairs = 0 if eng.pairs is None else (
        len(stream_blocks(eng.pairs.classes)) if eng.pair_stream else 1)
    return {"chunk_partials": 1 + pairs, "lane_shuffle": 0}


def counted_sync_run(torch, fn):
    """``fn()`` with every launch count at 0 just before and read just
    after, and the host syncs it makes counted by torch's sync debug
    mode -> (result, launches incl. the batched form, syncs)."""
    import warnings
    torch.cuda.synchronize()
    zero_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(read_launches(), chunk_partials_batched=batched_launches())
    return out, counts, sum(SYNC_WARNING in str(w.message) for w in caught)


def converge_counted(torch, eng):
    """One converge from a fresh init_state with every launch count at 0
    just before and read just after, and the host syncs it makes
    counted by torch's sync debug mode -> (label, active, iterations,
    launches, syncs, schedule).  A single-query engine launches no
    batched B1."""
    label, active = eng.init_state()
    (label, active, it), counts, syncs = counted_sync_run(
        torch, lambda: eng.converge(label, active))
    require(counts.pop("chunk_partials_batched") == 0,
            "a single-query converge launched B1's batched form")
    return label, active, it, counts, syncs, list(eng.schedule)


def check_push_launches(eng, counts, schedule, what: str) -> dict:
    """A converge's launches are its dense iterations' and nothing
    else: a sparse iteration launches no kernel."""
    per = dense_launches(eng)
    n_dense = schedule.count("dense")
    want = {k: n_dense * v for k, v in per.items()}
    require(counts == want,
            f"{what}: launched {counts} in {n_dense} dense and "
            f"{schedule.count('sparse')} sparse iterations (want {want}: "
            f"{per} a dense iteration, none a sparse one)")
    return per


def push_steps(torch, eng):
    """The run again one ``step`` at a time from init_state, each step's
    launches read around it: a dense step must launch its kernels once
    each (dense_launches), a sparse step none.  Returns (steps, the
    input state of the first dense step, that of the sparse step with
    the largest frontier)."""
    per = dense_launches(eng)
    label, active = eng.init_state()
    steps, dense_in, sparse_in = [], None, None
    while True:
        cnt = int(active.sum())
        if cnt == 0:
            return steps, dense_in, sparse_in
        before = read_launches()
        new_l, new_a, _c = eng.step(label, active)
        torch.cuda.synchronize()
        kind = eng.schedule[-1]
        made = {k: v - before[k] for k, v in read_launches().items()}
        want = per if kind == "dense" else {k: 0 for k in per}
        require(made == want, f"a {kind} push step launched {made} "
                              f"(want {want})")
        steps.append({"kind": kind, "frontier": cnt})
        if kind == "dense" and dense_in is None:
            dense_in = (label, active)
        if kind == "sparse" and (sparse_in is None
                                 or cnt > sparse_in[2]):
            sparse_in = (label, active, cnt)
        label, active = new_l, new_a


def pair_block_rows(eng):
    """The pair rows as the engine launches them: (first row, rows) of
    each block (one block when monolithic)."""
    from lux_tpu_torch.ops.pairs import stream_blocks
    sp = eng.pairs
    if not eng.pair_stream:
        return [(0, sp.Rp)]
    return [(r0, S * L) for r0, S, L in stream_blocks(sp.classes)]


def push_dense_layers(args, torch, eng, label, active) -> dict:
    """Device ms of each layer of one dense push iteration on its own
    input state, each timed alone: the masked flat table, the residual's
    gather + relax, B1 on its chunks, the segmented combine, the pair
    rows' fetch + relax, B1 on them and the class combine (summed over
    the blocks), the combine of both, the update; then the whole
    iteration, alone, replayed from a CUDA graph of 3 (no host gaps),
    and its host enqueue time."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.pairs import (W, _reduce_depth, _take_slots,
                                         class_combine)
    from lux_tpu_torch.ops.tiled import combine_op, combine_partials
    a, t, sp, P = eng.arrays, eng.tiles, eng.pairs, eng.num_parts
    kind, reps = eng.program.reduce, args.reps
    flat = eng._masked_flat(label, active)
    cand = eng._dense_cand(flat)
    C = P * t.n_chunks
    vals, rel = cand.reshape(C, t.E), a["rel_dst"].reshape(C, t.E)
    partials = chunk_partials(vals, rel, t.W, kind)
    red = combine_partials(partials, t, a["chunk_start"], a["last_chunk"],
                           eng.vpad, kind, eng._plan)
    out = {
        "mask_ms": cuda_ms(lambda: eng._masked_flat(label, active), reps),
        "gather_relax_ms": cuda_ms(lambda: eng._dense_cand(flat), reps),
        "chunk_partials_ms": cuda_ms(
            lambda: chunk_partials(vals, rel, t.W, kind), reps),
        "combine_ms": cuda_ms(lambda: combine_partials(
            partials, t, a["chunk_start"], a["last_chunk"], eng.vpad, kind,
            eng._plan), reps)}
    s2d = flat.reshape(-1, W)
    pw = a.get("pair_weight")
    blocks = pair_block_rows(eng)

    def fetch(r0, n):
        rows = torch.index_select(
            s2d, 0, a["pair_rowbind"][:, r0:r0 + n].reshape(-1).long())
        return eng._msg(rows.view(P, n, W),
                        None if pw is None else pw[:, r0:r0 + n])

    bvals = [fetch(r0, n).reshape(-1, W) for r0, n in blocks]
    brel = [a["pair_rel"][:, r0:r0 + n].reshape(-1, W).contiguous()
            for r0, n in blocks]
    bparts = [chunk_partials(v, r, W, kind) for v, r in zip(bvals, brel)]
    tp = a["pair_tile_pos"]
    if eng.pair_stream:
        from lux_tpu_torch.ops.pairs import stream_blocks
        shapes = [(S, L) for _r0, S, L in stream_blocks(sp.classes)]

        def pair_combine():
            outs = [_reduce_depth(p.view(P, S, L, W), kind)
                    for p, (S, L) in zip(bparts, shapes)]
            return _take_slots(outs, tp, kind, flat.dtype, flat.device, (W,))
    else:
        def pair_combine():
            return class_combine(sp, bparts[0].view(P, sp.Rp, W)[:, :sp.R],
                                 tp, kind)
    pred = eng._pair_red(flat)
    both = combine_op(kind)(red, pred)
    out.update(
        pair_blocks=len(blocks),
        pair_fetch_ms=cuda_ms(lambda: [fetch(r0, n) for r0, n in blocks],
                              reps),
        pair_chunk_partials_ms=cuda_ms(lambda: [
            chunk_partials(v, r, W, kind) for v, r in zip(bvals, brel)],
            reps),
        class_combine_ms=cuda_ms(pair_combine, reps),
        combine_op_ms=cuda_ms(lambda: combine_op(kind)(red, pred), reps),
        update_ms=cuda_ms(lambda: eng._dense_update(label, both), reps),
        step_ms=cuda_ms(lambda: eng._dense(label, active), reps),
        step_graph_ms=graph_ms(torch, lambda: eng._dense(label, active), 3),
        step_host_ms=host_ms(torch, lambda: eng._dense(label, active), 10),
        frontier=int(active.sum()))
    out["layers_sum_ms"] = sum(out[k] for k in (
        "mask_ms", "gather_relax_ms", "chunk_partials_ms", "combine_ms",
        "pair_fetch_ms", "pair_chunk_partials_ms", "class_combine_ms",
        "combine_op_ms", "update_ms"))
    return out


def kernel_rows(prof, calls: int) -> list:
    """[name, device ms a call] of every device activity (kernels,
    copies, fills) in a torch.profiler run of ``calls`` calls, the
    largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([e.key[:80], us / calls / 1e3])
    return sorted(rows, key=lambda r: -r[1])


def device_events(prof) -> int:
    """How many device activities (kernels, copies, fills) a
    torch.profiler run recorded."""
    n = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            n += e.count
    return n


def converge_profile(torch, eng, wall_ms: float) -> dict:
    """One converge under torch.profiler: its summed device time
    (kernels, the count copies, fills) against its own wall time and
    against ``wall_ms``, the median unprofiled converge -> the device's
    busy and idle shares (None where the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    label, active = eng.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.converge(label, active)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    return {"device_ms": busy, "profiled_wall_ms": prof_wall,
            "idle_share_profiled": 1 - busy / prof_wall if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top": rows[:10]}


def push_sparse_layers(args, torch, eng, label, active) -> dict:
    """Device ms of each layer of one sparse push iteration on its own
    input state: the queue compaction, the expansion over the
    src-sorted view, the relax + bounded scatter, the clear; then the
    whole iteration, alone, replayed from a CUDA graph of 3 (no host
    gaps), and its host enqueue time."""
    reps = args.reps
    gids, vals, cnts = eng._sparse_compact(label, active)
    edge_idx, src_val, in_range, off = eng._sparse_expand(gids, vals)
    return {
        "frontier": int(active.sum()),
        "out_edges": int(off[:, -1].max()),
        "edge_budget": eng.edge_budget, "queue_cap": eng.queue_cap,
        "compact_ms": cuda_ms(lambda: eng._sparse_compact(label, active),
                              reps),
        "expand_ms": cuda_ms(lambda: eng._sparse_expand(gids, vals), reps),
        "relax_scatter_ms": cuda_ms(lambda: eng._sparse_relax(
            label, edge_idx, src_val, in_range), reps),
        "clear_ms": cuda_ms(lambda: eng._sparse_clear(active, gids, cnts,
                                                      off), reps),
        "step_ms": cuda_ms(lambda: eng._sparse(label, active), reps),
        "step_graph_ms": graph_ms(torch, lambda: eng._sparse(label, active),
                                  3),
        "step_host_ms": host_ms(torch, lambda: eng._sparse(label, active),
                                10)}


def push_b1(args, torch, eng, label, active, name: str):
    """Kernel B1 on the push path's own inputs at a dense iteration: the
    residual chunks and the pair rows (the program's int32 min or max)
    against its plain version, two launches bit-equal on each; then
    B1's kernels-line entry at the residual chunks, with its numbers at
    the pair rows beside."""
    a, t, P = eng.arrays, eng.tiles, eng.num_parts
    kind = eng.program.reduce
    flat = eng._masked_flat(label, active)
    C = P * t.n_chunks
    vals = eng._dense_cand(flat).reshape(C, t.E).contiguous()
    rel = a["rel_dst"].reshape(C, t.E)
    rows = torch.index_select(flat.reshape(-1, 128), 0,
                              a["pair_rowbind"].reshape(-1).long())
    pw = a.get("pair_weight")
    pvals = eng._msg(rows.view(P, -1, 128), pw).reshape(-1, 128)
    pvals = pvals.contiguous()
    prel = a["pair_rel"].reshape(-1, 128)
    cases = [_check_case(torch, f"{name}_residual/{kind}", vals, rel, t.W,
                         kind),
             check_deterministic(torch, f"{name}_residual", vals, rel, t.W,
                                 kind),
             _check_case(torch, f"{name}_pair_rows/{kind}", pvals, prel, 128,
                         kind),
             check_deterministic(torch, f"{name}_pair_rows", pvals, prel,
                                 128, kind)]
    emit({"phase": "kernels", "kernel": "chunk_partials", "path": name,
          "cases": len(cases), "all_pass": True, "detail": cases,
          "step_paths": {"pair_rows": b1_step_paths(prel, 128),
                         "residual_chunks": b1_step_paths(rel, 128)}})
    line = b1_line(args, torch, vals, rel, t.W, f"chunk_partials@{name}",
                   kind)
    rows_line = b1_line(args, torch, pvals, prel, 128,
                        f"chunk_partials@{name}_pair_rows", kind)
    line["pair_rows"] = {k: rows_line[k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")}
    line["note"] = ("int32 compare-selects counted at the f32 rate (the "
                    "data sheet gives no int32 rate); bytes bound it")
    return line


def timed_converges(torch, eng, n: int):
    """``n`` converges from fresh init states: host wall seconds (fenced)
    and the device's span between two CUDA events, each."""
    out = []
    for _ in range(n):
        label, active = eng.init_state()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        label, active, it = eng.converge(label, active)
        end.record()
        end.synchronize()
        out.append({"wall_s": time.perf_counter() - t0,
                    "event_s": start.elapsed_time(end) / 1e3,
                    "iterations": it})
    return out


def run_push_config(args, torch, eng, g, want, name: str, card, extra):
    """Drive one push engine to convergence through converge and hold it
    to everything: labels bit-equal to ``want`` (the oracle in the
    engine's ids), both audits at 0, launches per iteration kind, at
    most one host sync an iteration; then timed runs, the stepwise
    launch check, per-layer times and B1 at the path's own inputs.
    Returns (the kernels-line entry, the counted run's launches, its
    labels and iterations)."""
    from lux_tpu_torch import check, device_check
    prog = eng.program
    eng.converge(*eng.init_state())                # warm-up run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    label, active, it, counts, syncs, schedule = converge_counted(torch,
                                                                  eng)
    peak = torch.cuda.max_memory_allocated()
    n_dense, n_sparse = schedule.count("dense"), schedule.count("sparse")
    got = eng.unpad(label)
    require(got.shape == (g.nv,) and got.dtype == np.int32,
            f"{name}: labels are not int32 [nv]")
    require(np.array_equal(got.astype(np.int64), want.astype(np.int64)),
            f"{name}: labels differ from the oracle at "
            f"{int((got != want).sum())} vertices")
    require(not bool(active.any()), f"{name}: converge left vertices "
                                    f"active")
    require(n_dense >= 1, f"{name}: no dense iteration ({schedule})")
    if prog.reduce == "min":
        require(n_sparse >= 1, f"{name}: no sparse iteration ({schedule})")
    per = check_push_launches(eng, counts, schedule, name)
    require(syncs <= it, f"{name}: {syncs} host syncs in {it} iterations "
                         f"(want at most one an iteration)")
    if prog.reduce == "min":           # hop counts
        host = check.check_sssp(g, got)
        dev = device_check.DeviceChecker(eng.sg).sssp(label)
    else:
        host = check.check_components(g, got)
        dev = device_check.DeviceChecker(eng.sg).components(label)
    require(host.ok and dev.ok, f"{name}: audits {host} / {dev}")
    runs = timed_converges(torch, eng, 3)
    steps, dense_in, sparse_in = push_steps(torch, eng)
    require([s["kind"] for s in steps] == schedule,
            f"{name}: stepwise kinds {steps} differ from the converge's "
            f"{schedule}")
    layers = {"dense": push_dense_layers(args, torch, eng, *dense_in)}
    if sparse_in is not None:
        layers["sparse"] = push_sparse_layers(args, torch, eng,
                                              *sparse_in[:2])
    wall = [r["wall_s"] for r in runs]
    best = float(np.median(wall))
    profiled = converge_profile(torch, eng, best * 1e3)
    emit({"phase": name, "nv": g.nv, "ne": g.ne, "iterations": it,
          "dense_iterations": n_dense, "sparse_iterations": n_sparse,
          "schedule": schedule, "frontiers": [s["frontier"] for s in steps],
          "launches": counts, "launches_per_dense_iteration": per,
          "host_syncs": syncs, "host_syncs_per_iteration": syncs / it,
          "converge_wall_s": wall,
          "converge_event_s": [r["event_s"] for r in runs],
          "ms_per_iter": best * 1e3 / it,
          "gteps": g.ne * it / best / 1e9,
          "gteps_note": "ne x iterations / median wall seconds of 3 "
                        "converges (bench.py:333-335)",
          "device_profile": profiled,
          "peak_bytes": int(peak), "audit_host": str(host),
          "audit_device": str(dev), "layers": layers, **extra,
          "card": card})
    line = push_b1(args, torch, eng, *dense_in, name)
    return line, counts, label, it


def phase_sssp(args, torch, g, g2, perm, starts, card):
    """bench.py's sssp config (bench.py:1034-1077) on the main graph:
    pair_relabel (threshold 16), min_fill 24, hops, no delta, sparse
    iterations on, one part, started at the relabelled id of the
    smallest input id with an out-edge (first_out_vertex).  Returns
    (the kernels-line entry, B1 launches, the guarded case: the engine,
    its labels, iterations and launches)."""
    from lux_tpu_torch.apps import sssp
    v0 = first_out_vertex(g)
    start = relabelled_id(perm, v0)
    t0 = time.perf_counter()
    eng = sssp.build_engine(g2, start, 1, pair_threshold=PAIR_THRESHOLD,
                            pair_min_fill=PAIR_MIN_FILL, starts=starts)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = bfs_levels(g2, start)
    t_oracle = time.perf_counter() - t0
    extra = {"start_input_id": v0, "start_relabelled_id": start,
             "input_vertex_0_out_degree": int(g.out_degrees[0]),
             "reached": int((want < sssp.HOP_INF).sum()),
             "pair_threshold": PAIR_THRESHOLD, "min_fill": PAIR_MIN_FILL,
             "tile_e": eng.tiles.E, "pair_stream": eng.pair_stream,
             "queue_cap": eng.queue_cap, "edge_budget": eng.edge_budget,
             "sparse_limit": eng._sparse_mode()[1],
             "setup_seconds": round(t_setup, 3),
             "pair_plan_seconds": round(eng.plan_seconds, 3),
             "oracle": "level-synchronous numpy BFS",
             "oracle_seconds": round(t_oracle, 3)}
    line, counts, label, it = run_push_config(args, torch, eng, g2, want,
                                              "sssp", card, extra)
    audit_case(torch, eng, "sssp")
    priced(pricing_decompose, torch, eng, "sssp", it)
    em = sssp.build_engine(g2, start, 1, pair_threshold=PAIR_THRESHOLD,
                           pair_min_fill=PAIR_MIN_FILL, starts=starts,
                           use_mxu=True)
    priced(mxu_push, torch, "sssp", eng, em, label, it)
    del em
    torch.cuda.empty_cache()
    return line, counts["chunk_partials"], (eng, label, it, counts)


# the cc phase's R-MAT scale under --scale: bench.py's cc runs one under
# its sssp (R-MAT 20); two (R-MAT 19) give the owner phase the ~25 s it
# took
CC_SCALE_UNDER = 2


def phase_cc(args, torch, card):
    """bench.py's cc config (bench.py:1038-1053) at R-MAT CC_SCALE_UNDER
    scales under --scale (19 by default; bench.py runs 20),
    --ef, --seed, symmetrized, pair_relabel (threshold 16), min_fill 24,
    one part; labels held to scipy's components (each one's largest
    relabelled id)."""
    from lux_tpu_torch.apps import components
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, pair_relabel
    t0 = time.perf_counter()
    scale = args.scale - CC_SCALE_UNDER
    src, dst, nv = rmat_edges(scale, args.ef, seed=args.seed)
    s, d = components.symmetrize(src, dst)
    del src, dst
    g = Graph.from_edges(s, d, nv)
    del s, d
    g2, _perm, starts = pair_relabel(g, 1, pair_threshold=PAIR_THRESHOLD)
    del g
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = components.build_engine(g2, 1, pair_threshold=PAIR_THRESHOLD,
                                  pair_min_fill=PAIR_MIN_FILL, starts=starts)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, sizes = components_oracle(g2)
    t_oracle = time.perf_counter() - t0
    extra = {"scale": scale, "edge_factor": args.ef, "seed": args.seed,
             "components": int(sizes.size),
             "largest_component": int(sizes.max()),
             "isolated": int((sizes == 1).sum()),
             "pair_threshold": PAIR_THRESHOLD, "min_fill": PAIR_MIN_FILL,
             "tile_e": eng.tiles.E, "pair_stream": eng.pair_stream,
             "queue_cap": eng.queue_cap, "edge_budget": eng.edge_budget,
             "sparse_limit": eng._sparse_mode()[1],
             "graph_seconds": round(t_graph, 3),
             "setup_seconds": round(t_setup, 3),
             "pair_plan_seconds": round(eng.plan_seconds, 3),
             "oracle": "scipy connected_components, max id a component",
             "oracle_seconds": round(t_oracle, 3)}
    line, counts, label, it = run_push_config(args, torch, eng, g2, want,
                                              "cc", card, extra)
    audit_case(torch, eng, "cc")
    em = components.build_engine(g2, 1, pair_threshold=PAIR_THRESHOLD,
                                 pair_min_fill=PAIR_MIN_FILL, starts=starts,
                                 use_mxu=True)
    priced(mxu_push, torch, "cc", eng, em, label, it)
    del eng, em, g2
    torch.cuda.empty_cache()
    return line, counts["chunk_partials"]


def parts_push(args, torch, g) -> dict:
    """The push engine on the parts phase's graph ``g`` with 4 parts on
    one card: hop SSSP, weighted SSSP with delta="auto" (weights drawn as
    bench.py:198-200 draws them) and components on the symmetrized
    graph, each over a tiled layout that needs the segmented combine,
    degree-relabelled paged and page-major delivery on either exchange,
    and pair_relabel'd pair rows streamed and monolithic; labels
    bit-equal to the oracle,
    launches as dense_launches says for every dense iteration, none
    for a sparse one (the paged paths: B2 once a dense iteration)."""
    from lux_tpu_torch.apps import components, sssp
    from lux_tpu_torch.engine.push import PushEngine
    from lux_tpu_torch.graph import (Graph, ShardedGraph, degree_relabel,
                                     pair_relabel)
    P = 4
    src, dst = g.edge_arrays()
    w = np.random.default_rng(1).integers(1, 6, size=g.ne).astype(np.int32)
    gw = Graph.from_edges(src, dst, g.nv, w)
    gs = Graph.from_edges(*components.symmetrize(src, dst), g.nv)
    del src, dst
    v0 = first_out_vertex(g)
    want_hops = bfs_levels(g, v0)
    want_w = sssp.reference_sssp(gw, v0, weighted=True)
    want_cc, _sizes = components_oracle(gs)
    apps = {"hops": (g, want_hops), "weighted": (gw, want_w),
            "cc": (gs, want_cc)}
    out = {}
    for app, (G, want) in apps.items():
        gd, perm_d = degree_relabel(G)
        gp, perm_p, starts_p = pair_relabel(G, P, pair_threshold=16)
        variants = {
            "tiled": (G, None, ShardedGraph.build(G, P), dict(tile_e=128)),
            "paged": (gd, perm_d, ShardedGraph.build(gd, P, vpad_align=128),
                      dict(gather="paged")),
            "pagemajor": (gd, perm_d,
                          ShardedGraph.build(gd, P, vpad_align=128),
                          dict(gather="pagemajor")),
            # the owner exchange's paged plans (B2 and B1 once a dense
            # iteration, as the dense paged paths)
            "owner_paged": (gd, perm_d,
                            ShardedGraph.build(gd, P, vpad_align=128),
                            dict(gather="paged", exchange="owner")),
            "owner_pagemajor": (gd, perm_d,
                                ShardedGraph.build(gd, P, vpad_align=128),
                                dict(gather="pagemajor", exchange="owner")),
            "pairs_streamed": (gp, perm_p, ShardedGraph.build(
                gp, P, starts=starts_p, pair_threshold=16),
                dict(pair_threshold=16, pair_min_fill=24)),
            "pairs_monolithic": (gp, perm_p, ShardedGraph.build(
                gp, P, starts=starts_p, pair_threshold=16),
                dict(pair_threshold=16, pair_min_fill=24,
                     pair_stream=False))}
        # the owner exchange: hop and weighted SSSP on the plain layout,
        # components with pair rows
        if app == "cc":
            variants["owner_pairs"] = (gp, perm_p, ShardedGraph.build(
                gp, P, starts=starts_p, pair_threshold=16),
                dict(pair_threshold=16, pair_min_fill=24,
                     exchange="owner"))
        else:
            variants["owner"] = (G, None, ShardedGraph.build(G, P),
                                 dict(exchange="owner"))
        for vname, (Gv, perm, sg, opts) in variants.items():
            if app == "cc":
                prog, delta = components.make_program(), None
                if perm is None:
                    want_v = want
                else:   # each component's largest id in the new ids
                    rank = np.empty(G.nv, np.int64)
                    rank[perm] = np.arange(G.nv)
                    top = np.full(G.nv, -1, np.int64)
                    np.maximum.at(top, want, rank)
                    want_v = top[want[perm]]
            else:
                start = v0 if perm is None else relabelled_id(perm, v0)
                prog = sssp.make_program(start, app == "weighted")
                delta = sssp.default_delta(Gv) if app == "weighted" \
                    else None
                want_v = want if perm is None else want[perm]
            eng = PushEngine(sg, prog, delta=delta, **opts)
            if vname == "tiled":
                require(eng.tiles.needs_scan, "parts push: the tiled "
                                              "layout must need the "
                                              "segmented combine")
            label, active, it, counts, _syncs, sched = converge_counted(
                torch, eng)
            got = eng.unpad(label).astype(np.float64)
            require(np.array_equal(got, np.asarray(want_v, np.float64)),
                    f"parts push {app}/{vname}: labels differ from the "
                    f"oracle at {int((got != want_v).sum())} vertices")
            check_push_launches(eng, counts, sched,
                                f"parts push {app}/{vname}")
            out[f"{app}/{vname}"] = {
                "iterations": it, "dense": sched.count("dense"),
                "sparse": sched.count("sparse"), "launches": counts,
                "delta": delta}
            del eng, label, active
        torch.cuda.empty_cache()
    return out


# bench.py's pagerank-mp / sssp-mp (bench.py:987-1011, :1056-1077):
# R-MAT this many scales over --scale (0: the main graph, R-MAT 21 by
# default; cut from bench.py's 23 to 22 for the audit step, then to 21
# for the owner paged step and the lint: with it at 22 the smoke took
# 851 s of its 900 on an NVIDIA H100 80GB HBM3 at 700 W whose host ran
# the host-bound phases slowly), 4 parts, the exchange pinned to "owner";
# the exchange sweep's (scale over --scale, parts) cases
OWNER_SCALE_OVER = 0
OWNER_PARTS = 4
OWNER_SWEEP = ((0, 1), (0, OWNER_PARTS))
W_LANES = 128


def owner_sweep_case(args, torch, g, P, gather_eng=None,
                     keep_owner=False) -> tuple:
    """The PageRank pull step with exchange="gather" and "owner" on one
    ShardedGraph of ``g`` with ``P`` parts, timed in turns (gather,
    owner, owner, gather), beside what exchange="auto" resolves to;
    three iterations of each from the same state agree within rtol
    2e-5.  ``gather_eng``: a gather engine of ``g`` already built.
    Returns (the case, the owner engine when ``keep_owner``)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.engine.pull import OWNER_AUTO_BYTES, resolve_exchange
    from lux_tpu_torch.graph import ShardedGraph
    build = {}
    engs = {}
    t0 = time.perf_counter()
    sg = gather_eng.sg if gather_eng is not None else \
        ShardedGraph.build(g, P)
    build["sharded_graph"] = round(time.perf_counter() - t0, 3)
    for ex in ("gather", "owner"):
        if ex == "gather" and gather_eng is not None:
            engs[ex] = gather_eng
            continue
        t0 = time.perf_counter()
        engs[ex] = pagerank.build_engine(g, P, sg=sg, exchange=ex)
        torch.cuda.synchronize()
        build[ex] = round(time.perf_counter() - t0, 3)
    st = engs["gather"].init_state()
    ms = {"gather": [], "owner": []}
    for ex in ("gather", "owner", "owner", "gather"):
        eng = engs[ex]
        ms[ex].append(cuda_ms(lambda eng=eng: eng.step(st), args.reps))
    a = engs["gather"].run(st, 3)
    b = engs["owner"].run(st, 3)
    torch.cuda.synchronize()
    rel = float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())
    require(torch.allclose(a, b, rtol=2e-5, atol=1e-9),
            f"exchange sweep P={P}: owner and gather disagree ({rel:.3e})")
    gather_ms, owner_ms = (float(np.mean(ms[k])) for k in ("gather",
                                                           "owner"))
    lay = engs["owner"].owner
    out = {"nv": g.nv, "ne": g.ne, "parts": P,
           "table_bytes": P * sg.vpad * 4,
           "auto": resolve_exchange("auto", sg, pagerank.make_program(),
                                    device=st.device),
           "auto_off_card": resolve_exchange("auto", sg,
                                             pagerank.make_program()),
           "owner_auto_bytes": OWNER_AUTO_BYTES,
           "gather_step_ms": ms["gather"], "owner_step_ms": ms["owner"],
           "owner_over_gather": owner_ms / gather_ms,
           "owner_chunks": P * lay.n_chunks, "owner_stats": lay.stats,
           "build_seconds": build, "max_rel_diff_3_iters": rel}
    kept = engs["owner"] if keep_owner else None
    del engs, a, b
    torch.cuda.empty_cache()
    return out, kept


def owner_gather_global(torch, state, src):
    """The gather form the engines do not take, timed beside theirs:
    one ``index_select`` over the part-major global ids ``s * vpad +
    src`` on the flat [P * vpad] table (the engines gather a source part
    at a time from its own shard, ops/owner.gather_messages)."""
    from lux_tpu_torch.engine.pull import gather_rows
    P, vpad = state.shape[:2]
    trail = tuple(state.shape[2:])
    base = (torch.arange(P, dtype=torch.int32, device=src.device)
            * vpad).reshape(P, 1, 1)
    return gather_rows(state.reshape((P * vpad,) + trail),
                       (src + base).reshape(-1)).view((P, -1) + trail)


def owner_layers(args, torch, eng) -> dict:
    """One owner iteration's layers on the engine's own arrays, each
    timed alone (CUDA events): the packed slots' decode, the gather in
    both forms in turns (one index_select a source part, one over the
    part-major global ids: ``owner_gather_ab``), kernel B1 over every
    part's owner chunks, the segmented combine, the fold across source
    parts, the pair rows, the apply, and the whole step with its host
    enqueue."""
    from lux_tpu_torch.ops import owner as om
    from lux_tpu_torch.ops.tiled import combine_chunks, reduce_partials
    a, lay, reps = eng.arrays, eng.owner, args.reps
    P, C, E, W = eng.num_parts, lay.n_chunks, lay.E, lay.W
    kind = eng.program.reduce
    state = eng.init_state()
    out = {"decode_ms": cuda_ms(lambda: om.decoded_slots(a), reps)}
    src, rel = om.decoded_slots(a)
    forms = {"per_part": lambda: om.gather_messages(state, src),
             "global": lambda: owner_gather_global(torch, state, src)}
    ab = {"per_part": [], "global": []}
    for form in ("per_part", "global", "global", "per_part"):
        ab[form].append(cuda_ms(forms[form], reps))
    vals = om.gather_messages(state, src)
    require(torch.equal(vals, forms["global"]()),
            "owner gather: the two forms give other messages")
    out["owner_gather_ab"] = ab
    out["gather_ms"] = float(np.mean(ab["per_part"]))
    msgs = eng.program.edge_value(vals.view(P, C, E), None,
                                  a.get("own_w")).reshape(P * C, E)
    rel2 = rel.reshape(P * C, E)
    out["b1_ms"] = cuda_ms(lambda: reduce_partials(msgs, rel2, W, kind),
                           reps)
    partials = reduce_partials(msgs, rel2, W, kind)
    out["segmented_combine_ms"] = cuda_ms(lambda: combine_chunks(
        partials, lay, a["own_cs"], a["own_lc"], kind, eng._plan), reps)
    tiles = combine_chunks(partials, lay, a["own_cs"], a["own_lc"], kind,
                           eng._plan)
    out["fold_ms"] = cuda_ms(lambda: om.fold_parts(tiles, P, kind), reps)
    red = om.fold_parts(tiles, P, kind)[:, :eng.vpad]
    if eng.pairs is not None:
        flat = state.reshape(-1)
        out["pair_rows_ms"] = cuda_ms(lambda: eng._pair_red(flat), reps)
    out["apply_ms"] = cuda_ms(lambda: eng._apply_epilogue(state, red), reps)
    out["step_ms"] = cuda_ms(lambda: eng.step(state), reps)
    out["step_host_ms"] = host_ms(torch, lambda: eng.step(state), reps)
    return out


def pagerank_oracle_card(torch, g, iters: int,
                         device="cuda") -> np.ndarray:
    """apps/pagerank.reference_pagerank's recurrence in float64 on the
    card, each iteration's in-edge sums one ``index_add_`` (the numpy
    oracle's bincount): a second where the numpy oracle takes ~27 s at
    R-MAT 23."""
    from lux_tpu_torch.apps.pagerank import ALPHA
    src, dst = (torch.as_tensor(np.asarray(a, np.int64), device=device)
                for a in g.edge_arrays())
    deg = torch.as_tensor(g.out_degrees.astype(np.float64), device=device)
    nv = g.nv
    live = deg > 0
    state = torch.where(live, (1.0 / nv) / deg.clamp(min=1), 1.0 / nv)
    for _ in range(iters):
        acc = torch.zeros_like(state).index_add_(0, dst, state[src])
        pr = (1.0 - ALPHA) / nv + ALPHA * acc
        state = torch.where(live, pr / deg.clamp(min=1), pr)
    return state.cpu().numpy()


def bfs_levels_card(torch, g, start: int, device="cuda") -> np.ndarray:
    """bfs_levels on the card: the same level-synchronous BFS over the
    edge list (int32 hop counts, HOP_INF where unreached)."""
    from lux_tpu_torch.apps.sssp import HOP_INF
    src, dst = (torch.as_tensor(np.asarray(a, np.int64), device=device)
                for a in g.edge_arrays())
    dist = torch.full((g.nv,), HOP_INF, dtype=torch.int32, device=device)
    dist[start] = 0
    level = 0
    while True:
        reach = dst[dist[src] == level]
        reach = reach[dist[reach] == HOP_INF]
        if reach.numel() == 0:
            return dist.cpu().numpy()
        level += 1
        dist[reach] = level


class SharedPairPlans:
    """Within the block, every engine built on one ShardedGraph takes
    one pair plan: ``plan_sharded_pairs`` as the engines import it,
    memoized on (ShardedGraph, threshold, min_fill, kdim) and restored
    after (the pair plan of R-MAT 23 with 4 parts takes ~47 s on the
    card's host; pagerank-mp and sssp-mp plan the same)."""

    def __enter__(self):
        from lux_tpu_torch.engine import pull, push
        self.mods = (pull, push)
        self.real = pull.plan_sharded_pairs
        memo = {}

        def shared(sg, threshold, min_fill=None, kdim=1, mesh=None):
            # a whole ShardedGraph plans the same on any mesh
            key = (id(sg), threshold, min_fill, kdim)
            if key not in memo:
                memo[key] = (sg, self.real(sg, threshold, min_fill=min_fill,
                                           kdim=kdim, mesh=mesh))
            return memo[key][1]

        for m in self.mods:
            m.plan_sharded_pairs = shared
        self.memo = memo
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.plan_sharded_pairs = self.real
        self.memo.clear()


def owner_b1(args, torch, eng, msgs, rel, name, kind) -> tuple:
    """B1 at an owner path's own chunks: held against its plain version
    (``_check_case``), two launches bit-equal, and its kernels-line
    entry (``b1_line``)."""
    cases = [_check_case(torch, name, msgs, rel, eng.owner.W, kind),
             check_deterministic(torch, name, msgs, rel, eng.owner.W, kind)]
    line = b1_line(args, torch, msgs, rel, eng.owner.W,
                   f"chunk_partials@{name}", kind)
    return cases, line


def owner_streamed(args, torch, g, main_eng, owner4) -> dict:
    """The streamed forms on the card, each against its monolithic run:
    ``stream_msgs`` on the pull engine's tiled path (the main engine,
    its switch flipped; f32 at MAIN_TOL, its bits reported) and on the
    push engine's (hop SSSP on the main graph, labels and iterations
    bit-equal), and the owner layout's fused streamed combine
    (``owner4``, the sweep's 4-part owner engine, with
    ops/owner.STREAM_MSG_BYTES lowered under one part's messages, the
    extraction plan its build would add, then both restored): B1 a
    block of STREAM_BLOCK_CHUNKS chunks."""
    import math

    from lux_tpu_torch.apps import sssp
    from lux_tpu_torch.engine.push import PushEngine
    from lux_tpu_torch.ops import owner as om
    from lux_tpu_torch.ops.tiled import STREAM_BLOCK_CHUNKS
    out = {}
    t = main_eng.tiles
    blocks = math.ceil(main_eng.num_parts * t.n_chunks / STREAM_BLOCK_CHUNKS)
    want = main_eng.run(main_eng.init_state(), args.iters)
    main_eng.stream_chunks = True
    try:
        state, counts, _s = counted_sync_run(
            torch, lambda: main_eng.run(main_eng.init_state(), args.iters))
        ms = cuda_ms(lambda: main_eng.step(want), args.reps)
    finally:
        main_eng.stream_chunks = False
    require(counts["chunk_partials"] == blocks * args.iters,
            f"streamed pull launched {counts} (want {blocks} a step)")
    require(torch.allclose(state, want, **MAIN_TOL),
            "streamed pull disagrees with the monolithic run")
    out["pull"] = {"blocks_per_iter": blocks, "launches": counts,
                   "bit_equal": bool(torch.equal(state, want)),
                   "step_ms": ms,
                   "monolithic_step_ms": cuda_ms(
                       lambda: main_eng.step(want), args.reps)}
    v0 = first_out_vertex(g)
    eng = PushEngine(main_eng.sg, sssp.make_program(v0))
    label, _a, it, counts, _syncs, sched = converge_counted(torch, eng)
    eng.stream_chunks = True
    label2, _a2, it2, counts2, _s2, sched2 = converge_counted(torch, eng)
    require(it == it2 and sched == sched2 and torch.equal(label, label2),
            "streamed push converge differs from the monolithic one")
    require(counts2["chunk_partials"] == blocks * sched2.count("dense"),
            f"streamed push launched {counts2}")
    out["push"] = {"iterations": it, "dense": sched.count("dense"),
                   "launches": counts2, "monolithic_launches": counts}
    del eng, label, label2
    lay, a = owner4.owner, owner4.arrays
    budget = om.STREAM_MSG_BYTES
    want = owner4.run(owner4.init_state(), args.iters)
    om.STREAM_MSG_BYTES = lay.n_chunks * lay.E * 4 - 1
    try:
        require(lay.streams(), "the lowered budget must stream the layout")
        ep, et = lay.extract_plan()
        a["own_ep"] = torch.tensor(ep, device=want.device)
        a["own_et"] = torch.tensor(et, device=want.device)
        state, counts, _s = counted_sync_run(
            torch, lambda: owner4.run(owner4.init_state(), args.iters))
        ms = cuda_ms(lambda: owner4.step(want), args.reps)
        src, rel = om.decoded_slots({k: v[0] for k, v in a.items()
                                     if k in ("own_sr", "own_nv",
                                              "own_src", "own_rel")})
    finally:
        om.STREAM_MSG_BYTES = budget
        a.pop("own_ep", None)
        a.pop("own_et", None)
    nb = math.ceil(lay.n_chunks / STREAM_BLOCK_CHUNKS)
    require(counts["chunk_partials"] == owner4.num_parts * nb * args.iters,
            f"fused streamed owner run launched {counts}")
    require(torch.allclose(state, want, **MAIN_TOL),
            "fused streamed owner run disagrees with the monolithic one")
    out["owner_fused"] = {"parts": owner4.num_parts, "blocks_per_part": nb,
                          "extract_width": int(ep.shape[-1]),
                          "launches": counts, "step_ms": ms,
                          "bit_equal": bool(torch.equal(state, want))}
    st = owner4.init_state()[0]
    block = owner4.program.edge_value(
        st[src[:STREAM_BLOCK_CHUNKS].long()], None, None).contiguous()
    return out, block, rel[:STREAM_BLOCK_CHUNKS].contiguous(), counts


# the owner exchange's paged plans (the owner phase's owner_paged step):
# bench.py's gather-ab graph (the paged phases' degree-relabelled R-MAT
# --scale), 128-aligned, with this many parts
OWNER_PAGED_PARTS = 4
# timing repetitions of the owner_paged step (its rows are 15M deep: at
# --reps 20 the plain and library timings took seconds of the step's)
OWNER_PAGED_REPS = 5
# rows a block of the owner paged paths' B1 check against its plain
# version (whose int64 index of all [P*Rp, 128] rows takes ~15 GB)
B1_CHECK_ROWS = 1 << 22


def owner_paged_rows(torch, eng, state):
    """The page rows an owner paged / page-major step fetches, as its
    step fetches them: (rows [R, 128], slot_lane int32 [R, 128]), R =
    P * Rp (paged) or P * P * Mg (page-major gather rows)."""
    from lux_tpu_torch.ops.pagegather import W, fetch_pages, row_slots
    a, pm = eng.arrays, eng.page_plan.mode == "pagemajor"
    ids = a["own_pm_ids" if pm else "own_pg_ids"]
    sl = a["own_pm_gsl" if pm else "own_pg_sl"]
    P, n_pages = ids.shape
    pages = fetch_pages(state.reshape(-1), ids, shard=True)
    base = torch.arange(P, device=state.device)[:, None] * n_pages
    rows = torch.index_select(pages, 0, (row_slots(sl) + base).reshape(-1))
    return rows, sl.reshape(-1, W)


def owner_paged_layers(args, torch, eng) -> tuple:
    """Device ms of each layer of one owner paged / page-major step on
    the engine's own arrays, each timed alone (CUDA events): the page
    fetch (one index_select a source part on its shard's pages, then
    the row fetch), kernel B2, then paged: B1, the class combine, the
    fold across source parts; page-major: the messages' route (the
    transpose), the virtual-row take, B1, the class combine; then the
    apply, the step and its host enqueue.  The layers run on a state of
    distinct values, (i + 1) / n for vertex slot i of n (distinct in
    float32 for n < 2**24), so that B2 and B1's checks on the rows
    returned can tell every lane of a page apart (the init state's low
    degree tail holds one value across whole pages); the apply and the
    step run on the init state.  Returns (the times, B2's rows and
    slot_lane, B1's rows and rel ids)."""
    from lux_tpu_torch.ops import pagegather as pgm
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    from lux_tpu_torch.ops.owner import fold_parts
    from lux_tpu_torch.ops.pairs import class_combine
    W = pgm.W
    a, pp, reps = eng.arrays, eng.page_plan, args.reps
    pm = pp.mode == "pagemajor"
    P = eng.num_parts
    state = eng.init_state()
    n = state.numel()
    require(n < 1 << 24, f"{n} vertex slots: (i + 1) / n not distinct")
    distinct = ((torch.arange(n, dtype=torch.float64, device=state.device)
                 + 1) / n).to(state.dtype).reshape(state.shape)
    out = {"page_fetch_ms": cuda_ms(
        lambda: owner_paged_rows(torch, eng, distinct), reps)}
    rows, sl = owner_paged_rows(torch, eng, distinct)
    out["lane_shuffle_ms"] = cuda_ms(lambda: lane_shuffle(rows, sl), reps)
    vals = lane_shuffle(rows, sl)
    out["lane_shuffle_bound_ms"] = sl.numel() * 12 / HBM_BYTES_PER_S * 1e3
    key = "own_pm_" if pm else "own_pg_"
    rel = a[key + "rel"].reshape(-1, W)
    if pm:
        msgs = eng.program.edge_value(vals.view(P, -1, W), None,
                                      a.get("own_pm_w"))
        m4 = msgs.view(P, P, pp.route, W)
        out["route_ms"] = cuda_ms(lambda: pgm.pagemajor_route(m4), reps)
        recv = pgm.pagemajor_route(m4)
        out["route_bytes"] = recv.numel() * recv.element_size()
        vidx = (a["own_pm_vrs"].long() + torch.arange(
            P, device=recv.device)[:, None] * (P * pp.route)).reshape(-1)
        out["vrow_take_ms"] = cuda_ms(
            lambda: torch.index_select(recv, 0, vidx), reps)
        del vals, msgs, m4
        vals = torch.index_select(recv, 0, vidx)
        del recv
    out["chunk_partials_ms"] = cuda_ms(
        lambda: chunk_partials(vals, rel, W, "sum"), reps)
    partials = chunk_partials(vals, rel, W, "sum")
    out["chunk_partials_bound_ms"] = b1_bound(torch, vals, rel,
                                              W)["bound_ms"]
    part3 = partials.view(P, pp.Rp, W)[:, :pp.R]
    tp = a[key + "tp"]
    out["class_combine_ms"] = cuda_ms(
        lambda: class_combine(pp, part3, tp, "sum"), reps)
    red = class_combine(pp, part3, tp, "sum")
    del part3, partials
    if not pm:
        tiles = red.reshape(P, pp.n_tiles, W)
        out["fold_ms"] = cuda_ms(lambda: fold_parts(tiles, P, "sum"), reps)
        red = fold_parts(tiles, P, "sum")
    red = red.reshape(P, -1)[:, :eng.vpad]
    out["apply_ms"] = cuda_ms(lambda: eng._apply_epilogue(state, red), reps)
    out["step_ms"] = cuda_ms(lambda: eng.step(state), reps)
    out["step_host_ms"] = host_ms(torch, lambda: eng.step(state), reps)
    return out, (rows, sl), (vals, rel)


def owner_paged_kernels(args, torch, label, b2_in, b1_in) -> list:
    """B2 and B1 on the owner paged path's own rows against their plain
    versions (B2 bit for bit, B1's float32 sums at rtol 1e-5), two
    launches of each bit-equal, B1 also at a
    row count that is not a multiple of its block; their kernels-line
    entries (lane_shuffle@<label>, chunk_partials@<label>).  ``b2_in``
    (rows, slot_lane) and ``b1_in`` (rows, rel) are lists, emptied as
    they are used: the plain versions' int64 indices of the [P*Rp, 128]
    rows take tens of GB, so B1's plain version is held to the kernel a
    block of B1_CHECK_ROWS rows at a time."""
    import gc

    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
    from lux_tpu_torch.ops.pagegather import W
    rows, sl = b2_in
    b2_in.clear()
    a, b = lane_shuffle(rows, sl), lane_shuffle(rows, sl)
    want = lane_shuffle_plain(rows, sl)
    torch.cuda.synchronize()
    require(_same_words(a, want), f"B2 at {label}'s rows is not bit-equal "
                                  f"to its plain version")
    require(_same_words(a, b), f"B2 at {label}'s rows: two launches "
                               f"differ in bits")
    del a, b, want
    b2 = b2_line(args, torch, rows, sl)
    b2["name"] = f"lane_shuffle@{label}"
    R = rows.shape[0]
    del rows, sl
    gc.collect()
    torch.cuda.empty_cache()
    vals, rel = b1_in
    b1_in.clear()
    C = vals.shape[0]
    blocks = [_check_case(torch, f"{label}_rows[{r0}:{min(C, r0 + n)}]",
                          vals[r0:r0 + n], rel[r0:r0 + n], W, "sum")
              for r0, n in ((r0, B1_CHECK_ROWS)
                            for r0 in range(0, C, B1_CHECK_ROWS))]
    odd = min(C, B1_CHECK_ROWS) - 3
    cases = [{"case": f"{label}_rows", "C": C, "E": W, "dtype": "float32",
              "kind": "sum", "blocks": len(blocks),
              "max_abs_err": max(c["max_abs_err"] for c in blocks),
              "tolerance": blocks[0]["tolerance"]},
             check_deterministic(torch, f"{label}_rows", vals, rel, W),
             _check_case(torch, f"{label}_rows/R{odd}", vals[:odd],
                         rel[:odd], W, "sum")]
    emit({"phase": "kernels", "kernel": "lane_shuffle+chunk_partials",
          "path": label, "cases": len(cases) + 2, "all_pass": True,
          "detail": cases + [
              {"case": f"{label}_rows/lane_shuffle", "R": R,
               "tolerance": "bit-equal"},
              {"case": f"{label}_rows/lane_shuffle/deterministic", "R": R,
               "tolerance": "bit-equal across launches"}]})
    b1 = b1_line(args, torch, vals, rel, W, f"chunk_partials@{label}")
    del vals, rel
    gc.collect()
    torch.cuda.empty_cache()
    return [b2, b1]


def phase_owner_paged(args, torch, g, g2, perm, want, card):
    """The owner phase's owner_paged step: bench.py's gather-ab graph
    ``g2`` (the paged phases' degree-relabelled R-MAT, its PageRank
    oracle ``want``), 128-aligned with OWNER_PAGED_PARTS parts,
    exchange="owner" with gather="paged" and "pagemajor": PageRank
    against the float64 oracle at MAIN_TOL (B2 and B1 once a step), hop
    SSSP from input vertex 0 (or the smallest input id with an
    out-edge) bit-equal to a BFS (B2 and B1 once a dense iteration, none
    a sparse one), the layers, peak memory against memwatch's ledger,
    B2 and B1 on each path's own rows against their plain versions;
    then what gather="auto" resolves to under the owner exchange beside
    the flat owner engine's step and the two measured.  Returns (the
    kernels-line entries, the paths' launches)."""
    import gc

    from lux_tpu_torch import memwatch
    from lux_tpu_torch.apps import pagerank, sssp
    from lux_tpu_torch.engine.pull import PullEngine
    from lux_tpu_torch.engine.push import PushEngine
    from lux_tpu_torch.graph import ShardedGraph
    from lux_tpu_torch.ops import pagegather as pgm
    P = OWNER_PAGED_PARTS
    args = fewer_reps(args, OWNER_PAGED_REPS)
    t_step = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    sg = ShardedGraph.build(g2, P, vpad_align=pgm.W)
    seconds["sharded_graph"] = round(time.perf_counter() - t0, 3)
    v0 = 0 if g.out_degrees[0] > 0 else first_out_vertex(g)
    start = relabelled_id(perm, v0)
    t0 = time.perf_counter()
    bfs = bfs_levels_card(torch, g2, start)
    seconds["bfs_oracle"] = round(time.perf_counter() - t0, 3)
    lines, paths, steps, cases, plan_stats = [], {}, {}, {}, {}
    seconds["plans"] = {}
    pr_program = pagerank.make_program()
    for mode in ("paged", "pagemajor"):
        label = f"owner_{mode}"
        # one plan a mode, shared by the PageRank and SSSP engines
        t0 = time.perf_counter()
        plan = pgm.engine_page_plan(sg, mode, pr_program, "owner")
        seconds["plans"][f"owner/{mode}"] = round(time.perf_counter() - t0,
                                                  3)
        t0 = time.perf_counter()
        eng = PullEngine(sg, pr_program, exchange="owner", gather=mode,
                         page_plan=plan)
        torch.cuda.synchronize()
        seconds[f"{mode}_engine"] = round(time.perf_counter() - t0, 3)
        pp = eng.page_plan
        plan_stats[mode] = pp.stats
        require(eng.exchange == "owner" and eng.gather == mode
                and eng.owner is None and pp.owner,
                f"{label}: engine resolved exchange={eng.exchange} "
                f"gather={eng.gather}")
        state, secs, counts, peak, host_s = timed_run(torch, eng,
                                                      args.iters)
        err = check_pagerank(g2, eng.unpad(state), want, label)
        require(counts == {"chunk_partials": args.iters,
                           "lane_shuffle": args.iters},
                f"{label} launched {counts} in {args.iters} "
                f"iterations (want B2 and B1 once a step)")
        del state
        ledger = memwatch.MemoryLedger.for_engine(eng, label)
        audit_case(torch, eng, label, only=("step",))
        gc.collect()
        torch.cuda.empty_cache()
        layers, b2_in, b1_in = owner_paged_layers(args, torch, eng)
        b2_in, b1_in = list(b2_in), list(b1_in)
        del eng
        torch.cuda.empty_cache()
        lines += owner_paged_kernels(args, torch, label, b2_in, b1_in)
        for ln in lines[-2:]:
            ln["launches"] = counts[ln["name"].split("@")[0]]
        steps[mode] = layers["step_ms"]
        if mode == "pagemajor":
            PRICED["route"] = {"bytes": layers["route_bytes"],
                               "ms": layers["route_ms"]}
        # hop SSSP on the same ShardedGraph and plan
        t0 = time.perf_counter()
        seng = PushEngine(sg, sssp.make_program(start), exchange="owner",
                          gather=mode, page_plan=plan)
        torch.cuda.synchronize()
        seconds[f"{mode}_sssp_engine"] = round(time.perf_counter()
                                               - t0, 3)
        label_t, _act, it, scounts, syncs, sched = converge_counted(
            torch, seng)
        require(np.array_equal(seng.unpad(label_t), bfs),
                f"{label} sssp labels differ from the BFS oracle")
        check_push_launches(seng, scounts, sched, f"{label} sssp")
        del seng, label_t
        torch.cuda.empty_cache()
        paths[label] = counts
        paths[f"{label}_sssp"] = scounts
        cases[mode] = {
            "plan": {"Rp": pp.Rp, "R": pp.R, "Rg": pp.Rg or pp.Rp,
                     "n_pages": pp.n_pages, "classes": len(pp.classes),
                     "Mg": pp.route, "n_tiles": pp.n_tiles,
                     **{k: pp.stats[k] for k in (
                         "rows", "fill", "padded_fill", "page_ratio",
                         "unique_pages", "lane_inflation", "g_rows",
                         "g_fill", "padded_g_fill", "route_rows",
                         "route_inflation") if k in pp.stats}},
            "iters": args.iters, "ms_per_iter": secs * 1e3 / args.iters,
            "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
            "gteps": g2.ne * args.iters / secs / 1e9,
            "max_rel_err": err, "tolerance": MAIN_TOL,
            "launches": counts, "layers": layers,
            "peak_bytes": int(peak),
            "ledger_bytes": ledger.total_bytes,
            "ledger_over_peak": ledger.total_bytes / peak,
            "ledger_terms": ledger.terms,
            "sssp": {"start_input_id": v0, "start_relabelled_id": start,
                     "iterations": it, "dense": sched.count("dense"),
                     "sparse": sched.count("sparse"),
                     "host_syncs": syncs, "launches": scounts}}
        del plan, pp
    # gather="auto" under the owner exchange, beside the flat owner step:
    # the counting pass's stats (pagegather.plan_paged_stats) are the
    # two built plans' (tests/test_torch_owner_paged.py holds them
    # equal), so they are read from the plans, not counted again
    pst, mst = plan_stats["paged"], plan_stats["pagemajor"]
    stats = dict(pst, pm_rows=mst["rows"], pm_vfill=mst["fill"],
                 pm_padded_vfill=mst["padded_fill"],
                 pm_g_rows=mst["g_rows"], pm_g_fill=mst["g_fill"],
                 pm_g_padded_fill=mst["padded_g_fill"])
    auto = pgm.resolve_gather("auto", stats, pgm.state_table_bytes(
        sg, pagerank.make_program()), exchange="owner")
    t0 = time.perf_counter()
    flat = pagerank.build_engine(g2, P, sg=sg, exchange="owner")
    torch.cuda.synchronize()
    seconds["flat_owner_engine"] = round(time.perf_counter() - t0, 3)
    st = flat.init_state()
    steps["flat"] = cuda_ms(lambda: flat.step(st), args.reps)
    del flat, st
    torch.cuda.empty_cache()
    emit({"phase": "owner", "config": "owner_paged", "graph": "gather-ab",
          "scale": args.scale, "ef": args.ef, "nv": g2.nv, "ne": g2.ne,
          "parts": P, "vpad": sg.vpad, "modes": cases,
          "gather_auto": {"resolves": auto, "step_ms": steps,
                          "stats": stats},
          "seconds": seconds,
          "step_seconds": round(time.perf_counter() - t_step, 3),
          "card": card})
    return lines, paths


def phase_owner(args, torch, g, main_eng, card):
    """bench.py's pagerank-mp and sssp-mp on the owner exchange, the
    exchange sweep and the streamed forms (see the module docstring),
    the two configs' engines on one ShardedGraph and one pair plan
    (SharedPairPlans).  Returns (the kernels-line entries of B1 at the
    owner shapes, the owner paths' launches)."""
    with SharedPairPlans():
        return _phase_owner(args, torch, g, main_eng, card)


def _phase_owner(args, torch, g, main_eng, card):
    from lux_tpu_torch import memwatch
    from lux_tpu_torch.apps import pagerank, sssp
    from lux_tpu_torch.convert import rmat_graph
    from lux_tpu_torch.engine.pull import OWNER_AUTO_BYTES
    from lux_tpu_torch.graph import ShardedGraph, pair_relabel
    from lux_tpu_torch.ops import owner as om
    from lux_tpu_torch.ops.pairs import stream_blocks
    scale = args.scale + OWNER_SCALE_OVER
    seconds = {}
    t0 = time.perf_counter()
    g_mp = g if OWNER_SCALE_OVER == 0 else rmat_graph(scale, args.ef,
                                                      seed=args.seed)
    seconds["rmat_graph"] = round(time.perf_counter() - t0, 3)
    sweep = []
    owner4 = None
    for over, P in OWNER_SWEEP:
        G = g if over == 0 else g_mp
        case, kept = owner_sweep_case(
            args, torch, G, P, main_eng if (over, P) == (0, 1) else None,
            keep_owner=(over, P) == (0, OWNER_PARTS))
        case["scale"] = args.scale + over
        sweep.append(case)
        owner4 = kept or owner4
    emit({"phase": "owner_sweep", "owner_auto_bytes": OWNER_AUTO_BYTES,
          "cases": sweep, "card": card})
    streamed, block, block_rel, fused_counts = owner_streamed(
        args, torch, g, main_eng, owner4)
    del owner4
    torch.cuda.empty_cache()
    emit({"phase": "owner_streamed", **streamed})
    # pagerank-mp: one relabelled graph and ShardedGraph for both configs
    t0 = time.perf_counter()
    g3, perm, starts = pair_relabel(g_mp, OWNER_PARTS,
                                    pair_threshold=PAIR_THRESHOLD)
    seconds["pair_relabel"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    sg = ShardedGraph.build(g3, OWNER_PARTS, starts=starts,
                            pair_threshold=PAIR_THRESHOLD)
    seconds["sharded_graph"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g3, OWNER_PARTS, sg=sg,
                                pair_threshold=PAIR_THRESHOLD,
                                pair_min_fill=PAIR_MIN_FILL,
                                exchange="owner")
    torch.cuda.synchronize()
    seconds["pagerank_engine"] = round(time.perf_counter() - t0, 3)
    lay = eng.owner
    t0 = time.perf_counter()
    want = pagerank_oracle_card(torch, g3, args.iters)
    seconds["pagerank_oracle"] = round(time.perf_counter() - t0, 3)
    state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
    own_launches = b1_launches_at(lay.E)
    per_iter = 1 + len(stream_blocks(eng.pairs.classes))
    require(counts == {"chunk_partials": per_iter * args.iters,
                       "lane_shuffle": 0},
            f"pagerank-mp launched {counts} (want {per_iter} B1 a step)")
    require(own_launches == args.iters,
            f"pagerank-mp launched B1 {own_launches} times on its owner "
            f"chunks (want one a step)")
    pr_host = eng.unpad(state)
    err = check_pagerank(g3, pr_host, want, "pagerank-mp")
    ref = {"pagerank-mp": dict(result=pr_host, launches=counts,
                               owner_launches=own_launches,
                               step_ms=secs * 1e3 / args.iters)}
    del want, state
    layers = owner_layers(args, torch, eng)
    PRICED["owner"] = {"slots": OWNER_PARTS * lay.n_chunks * lay.E,
                       "ms": sum(layers[k] for k in (
                           "decode_ms", "gather_ms", "b1_ms",
                           "segmented_combine_ms", "fold_ms"))}
    ledger = memwatch.MemoryLedger.for_engine(eng, "pagerank-mp")
    src, rel = om.decoded_slots(eng.arrays)
    P, C, E = OWNER_PARTS, lay.n_chunks, lay.E
    msgs = om.gather_messages(eng.init_state(), src).reshape(P * C, E)
    cases, line = owner_b1(args, torch, eng, msgs, rel.reshape(P * C, E),
                           "owner", "sum")
    line["launches"] = own_launches
    del msgs, src, rel
    emit({"phase": "owner", "config": "pagerank-mp", "scale": scale,
          "ef": args.ef, "nv": g3.nv, "ne": g3.ne, "parts": OWNER_PARTS,
          "pair_threshold": PAIR_THRESHOLD, "min_fill": PAIR_MIN_FILL,
          "exchange": eng.exchange, "owner_tile_e": lay.E,
          "owner_chunks": P * C, "owner_stats": lay.stats,
          "pair_rows": eng.pairs.Rp, "pair_blocks": per_iter - 1,
          "plan_seconds": round(eng.plan_seconds, 3), "seconds": seconds,
          "iters": args.iters, "step_ms": secs * 1e3 / args.iters,
          "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
          "gteps": g3.ne * args.iters / secs / 1e9,
          "max_rel_err": err, "launches": counts,
          "owner_chunk_launches": own_launches,
          "pair_block_launches": counts["chunk_partials"] - own_launches,
          "b1_launches_per_iter": per_iter, "layers": layers,
          "peak_bytes": peak, "ledger_bytes": ledger.total_bytes,
          "ledger_over_peak": ledger.total_bytes / peak,
          "ledger_terms": ledger.terms, "kernel_cases": cases,
          "card": card})
    audit_case(torch, eng, "pagerank-mp")
    del eng
    torch.cuda.empty_cache()
    # sssp-mp on the same relabelled graph, ShardedGraph and pair plan
    v0 = 0 if g_mp.out_degrees[0] > 0 else first_out_vertex(g_mp)
    start = relabelled_id(perm, v0)
    t0 = time.perf_counter()
    eng = sssp.build_engine(g3, start, OWNER_PARTS, sg=sg,
                            pair_threshold=PAIR_THRESHOLD,
                            pair_min_fill=PAIR_MIN_FILL, exchange="owner")
    torch.cuda.synchronize()
    seconds["sssp_engine"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    want = bfs_levels_card(torch, g3, start)
    t_oracle = time.perf_counter() - t0
    label, _act, it, scounts, syncs, sched = converge_counted(torch, eng)
    sown = b1_launches_at(eng.owner.E)
    require(np.array_equal(eng.unpad(label), want),
            "sssp-mp labels differ from the BFS oracle")
    check_push_launches(eng, scounts, sched, "sssp-mp")
    require(sown == sched.count("dense"),
            f"sssp-mp launched B1 {sown} times on its owner chunks (want "
            f"one a dense iteration)")
    walls = []
    for _ in range(3):
        lab0, act0 = eng.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.converge(lab0, act0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ssrc, srel = om.decoded_slots(eng.arrays)
    lay = eng.owner
    P, C, E = OWNER_PARTS, lay.n_chunks, lay.E
    vals = om.gather_messages(label, ssrc).reshape(P * C, E)
    cand = eng._msg(vals, None).contiguous()
    del ssrc, vals
    scases, sline = owner_b1(args, torch, eng, cand, srel.reshape(P * C, E),
                             "owner_sssp", "min")
    sline["launches"] = sown
    del cand, srel
    emit({"phase": "owner", "config": "sssp-mp", "scale": scale,
          "parts": OWNER_PARTS, "start_input_id": v0,
          "input_vertex_0_out_degree": int(g_mp.out_degrees[0]),
          "start_relabelled_id": start,
          "reached": int((want < sssp.HOP_INF).sum()),
          "iterations": it, "dense": sched.count("dense"),
          "sparse": sched.count("sparse"), "host_syncs": syncs,
          "converge_ms": walls, "launches": scounts,
          "owner_chunk_launches": sown,
          "pair_block_launches": scounts["chunk_partials"] - sown,
          "setup_seconds": seconds["sssp_engine"],
          "oracle": "level-synchronous BFS on the card",
          "oracle_seconds": round(t_oracle, 3), "kernel_cases": scases,
          "card": card})
    audit_case(torch, eng, "sssp-mp")
    ref["sssp-mp"] = dict(result=eng.unpad(label), iterations=it,
                          schedule=sched, launches=scounts,
                          owner_launches=sown, converge_ms=walls)
    del eng, label, want
    torch.cuda.empty_cache()
    bcase = [_check_case(torch, "owner_block", block, block_rel, W_LANES,
                         "sum")]
    bline = b1_line(args, torch, block, block_rel, W_LANES,
                    "chunk_partials@owner_block")
    bline["launches"] = fused_counts["chunk_partials"]
    bline["cases"] = bcase
    mline, mcounts = phase_mesh(args, torch, g3, sg, start, ref, card)
    paths = {"owner": counts, "owner_sssp": scounts,
             "owner_fused": fused_counts, "mesh": mcounts}
    return [line, sline, bline, mline], paths


def mesh_ranks(args, torch, g3, sg, start, spec):
    """The dryrun's configurations and the mp configs on a mesh of every
    card (``torch.cuda.device_count()`` ranks): one card in this process
    over NCCL on an in-process HashStore, several cards as spawned
    ranks.  Returns (backend, world, per-rank dryrun results, per-rank
    mp results, the dryrun's seconds)."""
    import torch.distributed as dist
    from lux_tpu_torch.parallel import dryrun, multihost, suites
    from lux_tpu_torch.parallel.launch import spawn_ranks
    from lux_tpu_torch.parallel.mesh import make_mesh
    world = torch.cuda.device_count()
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    t0 = time.perf_counter()
    if world > 1:
        emit({"phase": "mesh_env", "backend": "nccl", "world": world,
              "nccl": nccl, "ranks": "spawned, one a card"})
        dry = spawn_ranks(dryrun.configs, world, "cuda", 600)
        dry_s = time.perf_counter() - t0
        res = spawn_ranks(suites.mp_configs, world, "cuda", 900, args=(
            dict(spec, scale=args.scale + OWNER_SCALE_OVER, ef=args.ef,
                 seed=args.seed),))
        return "nccl", world, dry, res, dry_s
    multihost.initialize(store=dist.HashStore(), world_size=1, rank=0,
                         device="cuda")
    try:
        mesh = make_mesh(1, "cuda:0")
        backend = str(dist.get_backend())
        emit({"phase": "mesh_env", "backend": backend, "world": mesh.world,
              "nccl": nccl, "ranks": "this process, an in-process "
                                     "HashStore"})
        dry = [dryrun.configs(mesh)]
        dry_s = time.perf_counter() - t0
        res = [suites.mp_configs(mesh, dict(spec, g3=g3, sg=sg,
                                            start=start, keep=True))]
        res[0]["turns"] = mesh_turns(args, torch, g3, sg, start,
                                     res[0].pop("engines"))
    finally:
        dist.destroy_process_group()
    return backend, 1, dry, res, dry_s


def mesh_turns(args, torch, g3, sg, start, mesh_engs) -> dict:
    """pagerank-mp and sssp-mp with and without the mesh in turns
    (without, mesh, mesh, without; twice), the engines without it built
    on the same ShardedGraph and pair plan: ms of a run of --iters steps
    by CUDA events (the host's enqueue on the clock: the step syncs with
    the host, so ``device_ms``'s hold cannot take it off), and the wall
    of a converge (host clock, synchronized)."""
    from lux_tpu_torch.apps import pagerank, sssp
    kw = dict(sg=sg, pair_threshold=PAIR_THRESHOLD,
              pair_min_fill=PAIR_MIN_FILL, exchange="owner")
    pr_mesh, ss_mesh = mesh_engs
    pr = {"without_mesh": pagerank.build_engine(g3, OWNER_PARTS, **kw),
          "mesh": pr_mesh}
    ss = {"without_mesh": sssp.build_engine(g3, start, OWNER_PARTS, **kw),
          "mesh": ss_mesh}
    out = {k: {n: [] for n in pr} for k in ("run_ms", "converge_ms")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(2):
        for name in ("without_mesh", "mesh", "mesh", "without_mesh"):
            eng = pr[name]
            st = eng.init_state()
            torch.cuda.synchronize()
            ev[0].record()
            eng.run(st, args.iters)
            ev[1].record()
            ev[1].synchronize()
            out["run_ms"][name].append(ev[0].elapsed_time(ev[1]))
            eng = ss[name]
            lab, act = eng.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.converge(lab, act)
            torch.cuda.synchronize()
            out["converge_ms"][name].append(
                (time.perf_counter() - t0) * 1e3)
    return out


def phase_mesh(args, torch, g3, sg, start, ref, card):
    """The parts mesh (ROADMAP A6b-1) on the card: the dryrun's six
    configurations against their oracles; bench.py's pagerank-mp and
    sssp-mp with ``mesh=`` held against the same engines without one
    (``ref``: the owner phase's, same graph, ShardedGraph and pair
    plan): results, iterations and schedules, and every kernel's
    launches a run and a converge equal; the steps with and without
    the mesh and each collective of an iteration timed alone; B1 on
    the mesh path's owner chunks against its plain version.  One card:
    world 1, where a collective is a copy on the card and no link is
    timed.  Returns (B1's kernels-line entry, the path's launches)."""
    from lux_tpu_torch.parallel import dryrun
    t_phase = time.perf_counter()
    spec = dict(parts=OWNER_PARTS, threshold=PAIR_THRESHOLD,
                min_fill=PAIR_MIN_FILL, iters=args.iters, reps=args.reps)
    backend, world, dry, res, dry_s = mesh_ranks(args, torch, g3, sg,
                                                 start, spec)
    want = dryrun.oracles()
    for r in dry:
        dryrun.check(r, want)
    out = res[0]
    pr, ss = out["pagerank-mp"], out["sssp-mp"]
    rpr, rss = ref["pagerank-mp"], ref["sssp-mp"]
    pr_bits = bool(np.array_equal(pr["result"], rpr["result"]))
    pr_err = float(np.max(np.abs(pr["result"] - rpr["result"])
                          / np.maximum(np.abs(rpr["result"]), 1e-30)))
    require(np.allclose(pr["result"], rpr["result"], rtol=2e-5, atol=0),
            f"pagerank-mp on the mesh differs from the engine without "
            f"one (max rel err {pr_err:.3e})")
    require(np.array_equal(ss["result"], rss["result"])
            and ss["iterations"] == rss["iterations"]
            and ss["schedule"] == rss["schedule"],
            "sssp-mp on the mesh differs from the engine without one "
            "(labels, iterations or dense / sparse schedule)")
    E = pr["owner_E"]
    for name, got, exp in (
            ("pagerank-mp", pr["launches"], rpr),
            ("sssp-mp", ss["launches"], rss)):
        want_l = {"chunk_partials": exp["launches"]["chunk_partials"],
                  "lane_shuffle": exp["launches"]["lane_shuffle"],
                  "chunk_partials_batched": 0,
                  "owner": exp["owner_launches"]}
        got_l = {k: got[k] for k in ("chunk_partials", "lane_shuffle",
                                      "chunk_partials_batched")}
        got_l["owner"] = got["chunk_partials_by_e"].get(E, 0)
        require(got_l == want_l,
                f"{name} on the mesh launched {got_l}, the engine "
                f"without one {want_l}")
    msgs, rel = (x.cuda() for x in out["b1_rows"])
    cases = [_check_case(torch, "mesh", msgs, rel, W_LANES, "sum"),
             check_deterministic(torch, "mesh", msgs, rel, W_LANES, "sum")]
    line = b1_line(args, torch, msgs, rel, W_LANES, "chunk_partials@mesh")
    line["launches"] = pr["launches"]["chunk_partials_by_e"].get(E, 0)
    line["cases"] = cases
    del msgs, rel, out["b1_rows"]
    mesh_ms = pr["run_ms"] / args.iters
    emit({"phase": "mesh", "backend": backend, "world": world,
          "parts": OWNER_PARTS, "scale": args.scale + OWNER_SCALE_OVER,
          "dryrun": sorted(dry[0]), "dryrun_seconds": round(dry_s, 3),
          "pagerank_mp": {
              "bit_equal": pr_bits, "max_rel_err": pr_err,
              "step_ms": mesh_ms, "step_ms_without_mesh": rpr["step_ms"],
              "launches": pr["launches"],
              "b1_per_iter": pr["launches"]["chunk_partials"] / args.iters},
          "sssp_mp": {
              "bit_equal": True, "iterations": ss["iterations"],
              "dense": ss["schedule"].count("dense"),
              "sparse": ss["schedule"].count("sparse"),
              "converge_ms": ss["converge_ms"],
              "converge_ms_without_mesh": rss["converge_ms"],
              "launches": ss["launches"]},
          "in_turns": out.get("turns"),
          "collectives_ms": out["collectives_ms"],
          "collective_bytes": out["collective_bytes"],
          "link": ("none timed: world 1, each collective a copy on the "
                   "card" if world == 1 else f"{world} cards"),
          "phase_seconds": round(time.perf_counter() - t_phase, 3),
          "card": card})
    return line, {"chunk_partials": pr["launches"]["chunk_partials"],
                  "lane_shuffle": pr["launches"]["lane_shuffle"]}


def probe_close(torch, name, got, want) -> dict:
    """``got`` finite, of ``want``'s dtype, and within the probes'
    tolerance of it (rtol 1e-5, atol 1e-5: values in [0, 1))."""
    from lux_tpu_torch.probes import ProbeCheckError, max_abs_err
    torch.cuda.synchronize()
    require(got.dtype == want.dtype and bool(torch.isfinite(got).all()),
            f"probe case {name}: dtype {got.dtype} (want {want.dtype}) or "
            f"a non-finite output")
    try:
        err = max_abs_err(got, want)
    except ProbeCheckError as e:
        raise SmokeFailure(f"probe case {name}: {e}") from e
    return {"case": name, "shape": list(got.shape), "max_abs_err": err}


def carry_graph_case(torch, gen, part, start) -> dict:
    """Three S7 calls on ``part``, ``start`` captured in a CUDA graph
    (after a call on the capture stream, which makes its scratch),
    replayed twice, each time after new data of the same shape was
    copied into them: starts at p = 0.3, then rare starts and none on
    row 0, so each tile looks back further than before.  Every output
    of a replay is bit-equal to an eager call on that data and within
    the probes' tolerance of the plain version: a status left by an
    earlier call or replay is never taken for a fresh one, and nothing
    a replay would freeze comes from the host."""
    from lux_tpu_torch.ops.carry import carry_combine, carry_combine_plain
    dev = part.device
    C = part.shape[0]
    p, s = part.clone(), start.clone().reshape(C)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        carry_combine(p, s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [carry_combine(p, s) for _ in range(3)]
    err = 0.0
    for r, (prob, first) in enumerate(((0.3, 1), (0.002, 0))):
        p.copy_(torch.rand(p.shape, generator=gen, device=dev))
        new = (torch.rand(C, generator=gen, device=dev) < prob)
        s.copy_(new.to(torch.int32))
        s[0] = first
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        eager = carry_combine(p, s)
        want = carry_combine_plain(p, s)
        for i, o in enumerate(outs):
            err = max(err, probe_close(torch, f"carry/graph_replay{r}/{i}",
                                       o, want)["max_abs_err"])
            require(_same_words(o, eager),
                    f"carry graph replay {r}, call {i}: not the words of "
                    f"an eager call on the replay's data")
    return {"case": "carry/graph_replay", "shape": list(part.shape),
            "captured_calls": 3, "replays": 2, "new_data_each_replay": True,
            "max_abs_err": err}


def carry_profile_case(torch, part, start) -> dict:
    """torch.profiler over 10 S7 calls: the card ran 10 kernels, each
    carry.cu's carry_kernel, and no memset (the status scratch is
    zeroed once, when it is allocated).  A profile that delivered no
    device event at all (the process's first tracer session has come
    back empty on this machine) is the tracer's failure, not the
    kernel's: it is taken once more, and the count holds for that
    one."""
    from torch.profiler import ProfilerActivity, profile

    from lux_tpu_torch.ops.carry import carry_combine
    carry_combine(part, start)
    torch.cuda.synchronize()
    for tries in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                carry_combine(part, start)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    kernels = sum("carry_kernel" in n for n in names)
    memsets = sum("memset" in n.lower() for n in names)
    require(kernels == 10 and memsets == 0 and len(names) == 10,
            f"carry profile: {kernels} carry kernels, {memsets} memsets "
            f"among {len(names)} device events over 10 calls (want 10, 0, "
            f"10)")
    return {"case": "carry/profile_10_calls", "shape": list(part.shape),
            "profiles_taken": tries,
            "device_events": len(names), "carry_kernels": kernels,
            "memsets": memsets, "max_abs_err": 0.0}


def probe_cases(torch, gen, full) -> list:
    """Each probe kernel against its plain version on the card: the
    scripts' full inputs (``full``), then the edge shapes."""
    from lux_tpu_torch.ops.carry import (carry_combine, carry_combine_plain,
                                         fused_carry, fused_carry_plain)
    from lux_tpu_torch.ops.onehot_reduce import (onehot_reduce,
                                                 onehot_reduce_plain)
    from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                     transposed_reduce_plain)
    dev = gen.device
    cases = []

    def carry_case(name, part, start, twice=False):
        got = carry_combine(part, start)
        cases.append(probe_close(torch, f"carry/{name}", got,
                                 carry_combine_plain(part, start)))
        if twice:
            # a call on other data of the same shape, with rare starts,
            # between the two: its statuses must not be taken for the
            # next call's
            op, os_ = rand(*part.shape), starts(part.shape[0], 0.002, 0)
            other = carry_combine(op, os_)
            again = carry_combine(part, start)
            cases.append(probe_close(torch, f"carry/{name}/between", other,
                                     carry_combine_plain(op, os_)))
            require(_same_words(got, again),
                    f"carry {name}: two calls differ")
            cases[-2]["two_calls_bit_equal"] = True

    def fused_case(name, vals, rel, start, W=128):
        cases.append(probe_close(torch, f"fused_carry/{name}",
                                 fused_carry(vals, rel, start, W),
                                 fused_carry_plain(vals, rel, start, W)))

    def onehot_case(name, vals, rel, W=128):
        cases.append(probe_close(torch, f"onehot/{name}",
                                 onehot_reduce(vals, rel, W),
                                 onehot_reduce_plain(vals, rel, W)))

    def transposed_case(name, vals, rel, W=128):
        """Every wg of TRANSPOSED_WGS up to W, and W: one launch each (wg
        does not change it), each bit-equal to the first."""
        want = transposed_reduce_plain(vals, rel, W)
        first = None
        for wg in sorted({w for w in TRANSPOSED_WGS if w <= W} | {W}):
            got = transposed_reduce(vals, rel, W, wg)
            cases.append(probe_close(torch, f"transposed/{name}/wg{wg}",
                                     got, want))
            first = got if first is None else first
            require(_same_words(got, first),
                    f"transposed {name}: the launches at wg {wg} and 1 "
                    f"differ")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def lanes(c, e, lo, hi, sort):
        r = torch.randint(lo, hi, (c, e), generator=gen, device=dev,
                          dtype=torch.int32)
        return r.sort(dim=1).values.contiguous() if sort else r

    def starts(c, p, first=1):
        st = (rand(c) < p).to(torch.int32)
        st[0] = first
        return st.reshape(c, 1)

    # the scripts' full inputs
    carry_case("script_full", full["partials"], full["slot_start"], True)
    cases.append(carry_graph_case(torch, gen, full["partials"],
                                  full["slot_start"]))
    cases.append(carry_profile_case(torch, full["partials"],
                                    full["slot_start"]))
    fused_case("script_full", full["vals"], full["rel"], full["start"])
    onehot_case("script_full", full["vals"], full["rel"])
    transposed_case("script_full", full["tvals"], full["trel"])
    C_full = full["partials"].shape[0]
    one = torch.zeros((C_full, 1), dtype=torch.int32, device=dev)
    one[0] = 1
    carry_case("one_segment_full", rand(C_full, 128), one, True)
    Ck = full["vals"].shape[0]
    one_k = torch.zeros((Ck, 1), dtype=torch.int32, device=dev)
    one_k[0] = 1
    fused_case("one_segment_full", full["vals"], full["rel"], one_k)
    # S7: odd C (not a multiple of its 64-row tile), start[0] = 0, a
    # start on every row, no start at all, W in {1, 37, 128, 200}
    for W in (1, 37, 128, 200):
        carry_case(f"C1001_W{W}", rand(1001, W), starts(1001, 0.3))
    carry_case("start0_zero", rand(1001, 128), starts(1001, 0.3, first=0))
    carry_case("start_every_row", rand(1001, 128),
               torch.ones((1001, 1), dtype=torch.int32, device=dev))
    carry_case("no_start", rand(4099, 128),
               torch.zeros(4099, dtype=torch.int32, device=dev))
    carry_case("C1", rand(1, 128), starts(1, 1.0, first=0))
    # S8 and S9: odd C (not a multiple of 32 or of 4), E in {1, 33,
    # 512}, sorted and unsorted lanes, pads W, lanes outside [0, W),
    # W in {1, 37, 100}
    for E in (1, 33, 512):
        for sort in (True, False):
            label = f"C1001_E{E}_{'sorted' if sort else 'unsorted'}"
            v, r = rand(1001, E), lanes(1001, E, 0, 129, sort)
            fused_case(label, v, r, starts(1001, 0.2))
            onehot_case(label, v, r)
    v, r = rand(1001, 256), lanes(1001, 256, -5, 140, False)
    for W in (1, 37, 100):
        fused_case(f"outside_W{W}", v, r, starts(1001, 0.2), W)
        onehot_case(f"outside_W{W}", v, r, W)
    v, r = rand(1001, 512), lanes(1001, 512, 0, 129, True)
    fused_case("start0_zero", v, r, starts(1001, 0.2, first=0))
    fused_case("start_every_row", v, r,
               torch.ones((1001, 1), dtype=torch.int32, device=dev))
    fused_case("one_segment", v, r, starts(1001, 0.0))
    onehot_case("few_lanes", v, lanes(1001, 512, 120, 132, True))
    # S9's staging and product: C not a multiple of its 8 chunks a block
    # and more chunks than its persistent warps (several a warp), E of
    # one, two and four 256-entry stages with part-filled last ones (the
    # scalar copy where E % 4 != 0), unsorted rows over all 128 lanes,
    # so that every 16-lane tile is hit, W in {1, 37, 100, 128}
    for C, E in ((1003, 1), (1003, 33), (12677, 512), (1003, 1000),
                 (1005, 257)):
        for W in (1, 37, 100, 128):
            v, r = rand(C, E), lanes(C, E, -3, 131, False)
            onehot_case(f"C{C}_E{E}_unsorted_W{W}", v, r, W)
        onehot_case(f"C{C}_E{E}_sorted", rand(C, E),
                    lanes(C, E, 0, 129, True))
    # S3/S12, every wg of each: N not a multiple of a CTA's columns and
    # under them, E in {1, 33, 512} and E under the plan's slices or no
    # multiple of them (the last slice shorter), E past two 16-row
    # batches a slice, sorted and unsorted lanes, lanes outside [0, W),
    # W in {1, 37, 100}, columns that hit few or no output rows (their
    # other rows must be 0)
    for E in (1, 33, 512):
        transposed_case(f"N1001_E{E}", rand(E, 1001),
                        lanes(E, 1001, 0, 128, False))
    for E, N in ((2, 5), (3, 31), (5, 33), (1000, 1), (77, 97)):
        transposed_case(f"N{N}_E{E}_sorted", rand(E, N),
                        lanes(E, N, 0, 128, True))
    r = lanes(512, 1001, -5, 140, False)
    for W in (1, 37, 100):
        transposed_case(f"outside_W{W}", rand(512, 1001), r, W)
    r = lanes(512, 1001, 0, 128, True)
    r[:, ::3] = torch.randint(0, 4, (512, len(range(0, 1001, 3))),
                              generator=gen, device=dev, dtype=torch.int32)
    r[:, 1::7] = -1
    transposed_case("empty_rows", rand(512, 1001), r.contiguous())
    return (cases + gather_cases(torch, gen, full)
            + elementwise_cases(torch, gen, full)
            + rowsum_cases(torch, gen, full))


# S3/S12's wg in the probe cases: the scripts' 8, 16 and 32, and 1, 3
# and 37 (no divisor of W), each with W itself
TRANSPOSED_WGS = (1, 3, 8, 16, 32, 37)


def _words(torch, gen, shape, lo=-2**31, hi=2**31 - 1):
    """Random int32 words over [lo, hi) on the card."""
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int64).to(torch.int32)


def _nan_payloads(torch, gen, x):
    """A copy of f32 ``x`` with quiet and signalling NaNs of random
    payloads, both signs, in a regular pattern."""
    x = x.clone()
    bits = x.view(torch.int32)
    pay = _words(torch, gen, x.shape, 1, 1 << 23)     # mantissa: never 0
    bits[::3, ::5] = (0x7F800000 | pay[::3, ::5]).to(torch.int32)
    bits[1::3, 2::5] = (-0x800000 | pay[1::3, 2::5]).to(torch.int32)
    return x


def gather_cases(torch, gen, full) -> list:
    """S1/S10 (B2) and S2/S11 (sub_gather) against their plain versions
    on the card, bit for bit: the scripts' full inputs, then every M at
    a boundary of sub_gather's plan with R / M of 1, 5 and 15 (1 and 5
    from M = 4096), ids 0 and M - 1 in the first and last rows, f32
    values, int32 words and NaN payloads."""
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
    from lux_tpu_torch.ops.sub_gather import (MAX_M, sub_gather,
                                              sub_gather_plain)
    dev, W = gen.device, 128
    cases = []

    def case(name, got, want, x):
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype
                and _same_words(got, want),
                f"probe case {name} is not bit-equal to its plain version")
        cases.append({"case": name, "shape": list(got.shape),
                      "dtype": str(x.dtype).replace("torch.", ""),
                      "nan": int(torch.isnan(x).sum())
                      if x.is_floating_point() else 0,
                      "tolerance": "bit-equal", "max_abs_err": 0.0})

    def sub_case(name, x, idx, M):
        case(f"sub_gather/{name}", sub_gather(x, idx, M),
             sub_gather_plain(x, idx, M), x)

    for label, x, idx in (("S1", full["x0"], full["sidx"]),
                          ("S10", full["sx"], full["idx1"])):
        case(f"lane_shuffle/script_full_{label}", lane_shuffle(x, idx),
             lane_shuffle_plain(x, idx), x)
    sub_case("script_full_S2_M8", full["x0"], full["sidx8"], 8)
    for M in (8, 64, 512, 4096):
        sub_case(f"script_full_S11_M{M}", full["sx"], full[f"idx0_{M}"], M)
    # each M where sub_gather's plan changes (direct to staged at 8/9,
    # 64 rows a tile to one block at 64/65, the strip width at 128/129,
    # 256/257 and 512, staged to direct at 512/513, and MAX_M), block
    # counts of 1, 5 and 15 (M = 9 takes 7 blocks a tile: 15 leaves a
    # part-filled tile)
    for M in (1, 3, 8, 9, 63, 64, 65, 128, 129, 256, 257, 512, 513, 4096,
              MAX_M):
        for nb in ((1, 5, 15) if M < 4096 else (1, 5)):
            R = M * nb
            idx = torch.randint(0, M, (R, W), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[0], idx[-1] = 0, M - 1
            x = torch.rand((R, W), generator=gen, device=dev)
            sub_case(f"M{M}_R{R}/f32", x, idx, M)
            sub_case(f"M{M}_R{R}/int32", _words(torch, gen, (R, W)), idx, M)
            sub_case(f"M{M}_R{R}/nan_payloads", _nan_payloads(torch, gen, x),
                     idx, M)
    return cases


def _special_values(torch, gen, x):
    """A copy of f32 ``x`` with NaNs of random payloads (quiet and
    signalling, both signs), -0.0, +-inf, values near the f32 limit and
    subnormals in a regular pattern."""
    flat = x.clone().reshape(-1)
    bits = flat.view(torch.int32)
    pay = _words(torch, gen, flat.shape, 1, 1 << 23)   # mantissa: never 0
    bits[1::23] = (0x7F800000 | pay[1::23]).to(torch.int32)
    bits[2::29] = (-0x800000 | pay[2::29]).to(torch.int32)
    flat[3::11] = -0.0
    flat[5::13] = float("inf")
    flat[7::17] = float("-inf")
    flat[9::19] = -3.0e38
    flat[11::31] = 1.0e-39          # subnormal in f32 and in bf16
    return flat.reshape(x.shape)


def _word_view(torch, x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def elementwise_cases(torch, gen, full) -> list:
    """S4/S5 (elementwise) against its plain version on the card: each
    body on its script's full inputs, then every body and dtype at
    [1001, 128] and at 128,131 elements (no multiple of the 16 B
    vector), random values and then NaN, -0.0, inf and subnormal
    inputs, the two-input bodies aliased (x, x) and distinct; then at
    one element short of and one past a vector, a tile and a wave of
    tiles.  NaN positions must match and every other word be bit-equal;
    each case records whether the NaN words were equal too."""
    from lux_tpu_torch.ops.elementwise import (BODIES, THREADS, UNROLL,
                                               VECTOR_BYTES, elementwise,
                                               elementwise_plain)
    dev = gen.device
    cases = []

    def case(name, body, ins):
        got = elementwise(body, *ins)
        want = elementwise_plain(body, *ins)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"probe case {name}: shape/dtype")
        gw, ww = _word_view(torch, got), _word_view(torch, want)
        gn, wn = torch.isnan(got), torch.isnan(want)
        require(torch.equal(gn, wn) and torch.equal(gw[~gn], ww[~wn]),
                f"probe case {name} is not bit-equal to its plain version")
        neg_zero = _word_view(torch, torch.full((1,), -0.0, dtype=got.dtype,
                                                device=dev))
        cases.append({"case": name, "shape": list(got.shape),
                      "nan_in": int(torch.isnan(ins[0]).sum()),
                      "nan_out": int(gn.sum()),
                      "neg_zero_out": int((gw == neg_zero).sum()),
                      "nan_words_equal": torch.equal(gw, ww),
                      "tolerance": "bit-equal", "max_abs_err": 0.0})

    for name, body, ins in script_bodies(torch, full):
        case(f"elementwise/script_full/{name}", body, ins)
    for shape in ((1001, 128), (1001 * 128 + 3,)):
        base = torch.rand(shape, generator=gen, device=dev)
        other = torch.rand(shape, generator=gen, device=dev)
        lanes = torch.randint(0, 20, shape, generator=gen, device=dev,
                              dtype=torch.int32)
        for values in ("random", "special"):
            a32, b32 = base, other
            if values == "special":
                a32 = _special_values(torch, gen, base)
                b32 = _special_values(torch, gen, other).flip(0).contiguous()
            for body, (_, types) in BODIES.items():
                for dtype, (b_dtype, _) in types.items():
                    a, b = a32.to(dtype), b32.to(dtype)
                    if b_dtype is None:
                        calls = {"one": (a,)}
                    elif b_dtype == torch.int32:
                        calls = {"lanes": (a, lanes)}
                    else:
                        calls = {"aliased": (a, a), "distinct": (a, b)}
                    label = (f"elementwise/{body}/"
                             f"{str(dtype).replace('torch.', '')}/"
                             f"{'x'.join(map(str, shape))}/{values}")
                    for form, ins in calls.items():
                        case(f"{label}/{form}", body, ins)
    # the kernel's tile boundaries: one element short of and one past a
    # 16 B vector, a tile (THREADS x UNROLL[body] vectors) and a wave of
    # tiles (one CTA a tile, 2,048 threads an SM), each body and dtype
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for body, (_, types) in BODIES.items():
        for dtype, (b_dtype, _) in types.items():
            vec = VECTOR_BYTES // torch.empty(0, dtype=dtype).element_size()
            tile = THREADS * UNROLL[body] * vec
            for m, what in ((vec, "vector"), (tile, "tile"),
                            (sms * (2048 // THREADS) * tile, "wave")):
                for n in (m - 1, m + 1):
                    a = torch.rand(n, generator=gen, device=dev).to(dtype)
                    ins = ((a,) if b_dtype is None else
                           (a, torch.randint(0, 20, (n,), generator=gen,
                                             device=dev, dtype=torch.int32))
                           if b_dtype == torch.int32 else
                           (a, torch.rand(n, generator=gen,
                                          device=dev).to(dtype)))
                    case(f"elementwise/{body}/"
                         f"{str(dtype).replace('torch.', '')}/{what}_{n}",
                         body, ins)
    return cases


def rowsum_cases(torch, gen, full) -> list:
    """S6 (block_rowsum) against its plain version on the card at rtol
    1e-5, atol 1e-5 (another summation order): the script's full input,
    then bm in {1, 37, 1024} with R = bm and 5 bm and values in
    [-0.5, 0.5); two launches must be bit-equal."""
    from lux_tpu_torch.ops.block_rowsum import (block_rowsum,
                                                block_rowsum_plain)
    dev = gen.device
    inputs = [("script_full", full["vx"], 1024)]
    for bm in (1, 37, 1024):
        for nb in (1, 5):
            inputs.append((f"bm{bm}_R{bm * nb}",
                           torch.rand((bm * nb, 128), generator=gen,
                                      device=dev) - 0.5, bm))
    cases = []
    for name, x, bm in inputs:
        got = block_rowsum(x, bm)
        again = block_rowsum(x, bm)
        cases.append(probe_close(torch, f"block_rowsum/{name}", got,
                                 block_rowsum_plain(x, bm)))
        require(_same_words(got, again),
                f"block_rowsum {name}: two launches differ")
    return cases


def graph_ms(torch, fn, calls: int) -> float:
    """Device ms a call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls: the median of 3 replays, each between two CUDA
    events, after one warm replay (no host launches in the timing).
    ``fn`` runs once on the capture stream first (S7 makes its status
    scratch there)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # first on the capture stream
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bench_ms(args, dev, fn) -> float:
    """Median ms a call of ``fn``: the port's loop_bench, 3 samples of
    ``--reps`` calls."""
    from lux_tpu_torch.timing import loop_bench, median_mad
    return median_mad(loop_bench(fn, args.reps, repeats=3,
                                 device=dev))[0] * 1e3


def fusion_answers(args, torch, dev, vals, rel, start, W) -> dict:
    """At the probe's [C, E] shape: B1 alone, B1 then carry_combine (the
    unfused form of S8), fused_carry and onehot_reduce, timed in turns
    (each twice, the order reversed the second time), and onehot's
    median over B1's; fused_carry is first held to B1 then
    carry_combine."""
    from lux_tpu_torch.ops.carry import carry_combine, fused_carry
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.onehot_reduce import onehot_reduce
    rel8 = torch.where((rel >= 0) & (rel < W), rel, -1).to(torch.int8)
    forms = {
        "b1": lambda: chunk_partials(vals, rel8, W, "sum"),
        "b1_then_carry": lambda: carry_combine(
            chunk_partials(vals, rel8, W, "sum"), start),
        "fused_carry": lambda: fused_carry(vals, rel, start, W),
        "onehot_reduce": lambda: onehot_reduce(vals, rel, W),
    }
    check = probe_close(torch, "fused_carry_vs_b1_then_carry",
                        forms["fused_carry"](), forms["b1_then_carry"]())
    order = list(forms) + list(forms)[::-1]
    times = {k: [] for k in forms}
    for k in order:
        times[k].append(bench_ms(args, dev, forms[k]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"shape": list(vals.shape) + [W], "ms": times,
            "onehot_vs_b1": med["onehot_reduce"] / med["b1"],
            "check": check}


def probe_line(args, torch, dev, spec: dict, counts: dict) -> dict:
    """The kernels-line entry of a probe kernel from ``spec``: the
    loop_bench median ms of its kernel, its plain version and its
    library call (None: no PyTorch call computes the function), its
    bound from (bytes, operations, peak operations/s), its launches in
    each probe's run (``counts``; none on the system paths)."""
    n_bytes, ops, ops_rate = spec["bound"]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    key = spec["key"]
    return {"name": spec["name"], "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(c[key] for c in counts.values()),
            "launches_by_path": {"system paths": 0,
                                 **{k: c[key] for k, c in counts.items()}},
            "shape": spec["shape"], "max_abs_err": spec["max_abs_err"],
            "ms": bench_ms(args, dev, spec["kernel"]),
            "plain_ms": bench_ms(args, dev, spec["plain"]),
            # the host's time to enqueue a call: where it reaches "ms",
            # the card waits on the host's launches
            "host_enqueue_ms": host_ms(torch, spec["kernel"], 10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": ops,
            "library_ms": None if spec["library"] is None
            else bench_ms(args, dev, spec["library"]),
            **spec.get("extra", {})}


def gather_specs(torch, full, err) -> list:
    """The kernels-line specs of S1/S10 (kernel B2 at profile_true's
    shape) and S2/S11 (sub_gather at profile_shuffle's, each M), bound
    by bytes: x and idx read once, out written once.  The library call
    is one ``torch.gather`` with int64 ids made outside the timed
    call."""
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
    from lux_tpu_torch.ops.sub_gather import sub_gather, sub_gather_plain
    x0, sidx = full["x0"], full["sidx"]
    sidx64 = sidx.long()
    R = x0.shape[0]
    specs = [{"name": "lane_shuffle@profile_true", "key": "lane_shuffle",
              "shape": [R, 128], "kernel": lambda: lane_shuffle(x0, sidx),
              "plain": lambda: lane_shuffle_plain(x0, sidx),
              "library": lambda: torch.gather(x0, 1, sidx64),
              "bound": (R * 128 * 12, 0, FP32_OPS_PER_S),
              "source": "lux_tpu_torch/csrc/lane_shuffle.cu",
              "replaces": "scripts/profile_true.py:60 and "
                          "scripts/profile_shuffle.py:56, on kernel B2 "
                          "(lux_tpu/ops/pagegather.py:1040)",
              "max_abs_err": err["lane_shuffle/script_full_S1"]}]
    x = full["sx"]
    R = x.shape[0]
    for M in (8, 64, 512, 4096):
        idx = full[f"idx0_{M}"]
        idx64 = idx.long().view(R // M, M, 128)
        xv = x.view(R // M, M, 128)
        specs.append({
            "name": "sub_gather" if M == 8 else f"sub_gather@M{M}",
            "key": "sub_gather", "shape": [R, 128, M],
            "kernel": lambda idx=idx, M=M: sub_gather(x, idx, M),
            "plain": lambda idx=idx, M=M: sub_gather_plain(x, idx, M),
            "library": lambda idx64=idx64, xv=xv: torch.gather(xv, 1, idx64),
            "bound": (R * 128 * 12, 0, FP32_OPS_PER_S),
            "source": "lux_tpu_torch/csrc/sub_gather.cu",
            "replaces": "scripts/profile_shuffle.py:82" + (
                " and scripts/profile_true.py:89" if M == 8 else ""),
            "max_abs_err": err[f"sub_gather/script_full_S11_M{M}"]})
    return specs


def script_bodies(torch, full) -> list:
    """(name, body, inputs) of each S4/S5 line at its script's shape:
    profile_vpu's x and r ([524,288 x 128]; ``x + x`` and both chain10
    lines pass one array twice, as the script does) and profile_true's
    x0 for chain32 ([262,144 x 128])."""
    vx, vr = full["vx"], full["vr"]
    vxb = vx.to(torch.bfloat16)
    return [("add", "add", (vx, vx)), ("chain10", "chain10", (vx, vx)),
            ("chain10_bf16", "chain10", (vxb, vxb)),
            ("cmpsel16", "cmpsel16", (vx, vr)),
            ("cmpmul16", "cmpmul16", (vx, vr)),
            ("chain32", "chain32", (full["x0"],))]


def vpu_specs(torch, full, err) -> list:
    """The kernels-line specs of S4/S5 (elementwise, each body at its
    script's shape) and S6 (block_rowsum).  Bounds count unique bytes:
    an input passed twice is read once.  Operations are the scripts'
    own counts (S5's work, S4's 64 an element) against the f32 rate;
    bytes bound every one.  Library calls: ``torch.add(x, x)`` for add,
    ``torch.sum`` of the [R / 1024, 1024, 128] view for S6, none for
    the chains and compare bodies."""
    from lux_tpu_torch.ops.block_rowsum import (block_rowsum,
                                                block_rowsum_plain)
    from lux_tpu_torch.ops.elementwise import elementwise, elementwise_plain
    # operations an element: the scripts' work counts
    ops = {"add": 1, "chain10": 10, "chain10_bf16": 10, "cmpsel16": 48,
           "cmpmul16": 64, "chain32": 64}
    specs = []
    for name, body, ins in script_bodies(torch, full):
        a = ins[0]
        n_bytes = sum(t.numel() * t.element_size()
                      for t in {t.data_ptr(): t for t in ins}.values())
        n_bytes += a.numel() * a.element_size()          # the output
        specs.append({
            "name": f"elementwise@{name}", "key": "elementwise",
            "shape": list(a.shape),
            "kernel": lambda body=body, ins=ins: elementwise(body, *ins),
            "plain": lambda body=body, ins=ins: elementwise_plain(body, *ins),
            "library": (lambda a=a: torch.add(a, a)) if body == "add"
            else None,
            "bound": (n_bytes, ops[name] * a.numel(), FP32_OPS_PER_S),
            "source": "lux_tpu_torch/csrc/elementwise.cu",
            "replaces": "scripts/profile_true.py:175" if body == "chain32"
            else "scripts/profile_vpu.py:49 (mk's run)",
            "max_abs_err": err[f"elementwise/script_full/{name}"],
            "extra": {"body": body,
                      "dtype": str(a.dtype).replace("torch.", "")}})
    vx = full["vx"]
    R = vx.shape[0]
    specs.append({
        "name": "block_rowsum", "key": "block_rowsum", "shape": [R, 128],
        "kernel": lambda: block_rowsum(vx, 1024),
        "plain": lambda: block_rowsum_plain(vx, 1024),
        "library": lambda: torch.sum(vx.view(R // 1024, 1024, 128), dim=1),
        "bound": ((R + R // 1024) * 128 * 4, vx.numel(), FP32_OPS_PER_S),
        "source": "lux_tpu_torch/csrc/block_rowsum.cu",
        "replaces": "scripts/profile_vpu.py:102",
        "max_abs_err": err["block_rowsum/script_full"]})
    return specs


def phase_probes(args, torch, g, card):
    """The probe entry points, each run once with the counts at 0 just
    before it and read just after; the probe kernels' checks; their
    kernels-line entries at the scripts' shapes."""
    from lux_tpu_torch.ops.carry import (carry_combine, carry_combine_plain,
                                         fused_carry, fused_carry_plain)
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.onehot_reduce import (MMA_OPS, mma_count,
                                                 onehot_reduce,
                                                 onehot_reduce_plain)
    from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                     transposed_reduce_plain)
    from lux_tpu_torch.ops.block_rowsum import block_rowsum
    from lux_tpu_torch.ops.elementwise import elementwise
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    from lux_tpu_torch.ops.sub_gather import sub_gather
    from lux_tpu_torch.probes import (profile_kernel, profile_shuffle,
                                      profile_slotted, profile_true,
                                      profile_v3, profile_vpu)
    w = {"carry_combine": carry_combine, "fused_carry": fused_carry,
         "onehot_reduce": onehot_reduce,
         "transposed_reduce": transposed_reduce, "sub_gather": sub_gather,
         "elementwise": elementwise, "block_rowsum": block_rowsum}
    before = {k: f.launches for k, f in w.items()}
    measured = {k: MEASURE_LAUNCHES.get(k, 0) for k in w}
    require(before == measured,
            f"a system path launched a probe kernel: {before} (launches "
            f"made to measure beside a path: {measured})")
    t0 = time.perf_counter()
    hk = profile_kernel.make_inputs()
    C_slot = profile_slotted.host_half(g.in_degrees())["C"]
    hs = profile_slotted.make_inputs(C_slot, g.nv)
    hv = profile_v3.make_inputs()
    ht = profile_true.make_inputs()
    hsh = profile_shuffle.make_inputs()
    hvpu = profile_vpu.make_inputs()
    t_inputs = time.perf_counter() - t0
    runs, counts = {}, {}
    for label, run in (
            ("profile_kernel", lambda: profile_kernel.main(
                ["--3d"], inputs=hk)),
            ("profile_slotted", lambda: profile_slotted.main(
                ["--scale", str(args.scale)], graph=g, inputs=hs)),
            ("profile_v3", lambda: profile_v3.main([], inputs=hv)),
            ("profile_true", lambda: profile_true.main([], inputs=ht)),
            ("profile_shuffle", lambda: profile_shuffle.main(
                [], inputs=hsh)),
            ("profile_vpu", lambda: profile_vpu.main([], inputs=hvpu))):
        zero_launches()
        for f in w.values():
            f.launches = 0
        t0 = time.perf_counter()
        runs[label] = run()
        torch.cuda.synchronize()
        counts[label] = {"seconds": time.perf_counter() - t0,
                         "chunk_partials": chunk_partials.launches,
                         "lane_shuffle": lane_shuffle.launches,
                         **{k: f.launches for k, f in w.items()}}
    want = {"profile_kernel": ("chunk_partials", "fused_carry",
                               "onehot_reduce"),
            "profile_slotted": ("carry_combine",),
            "profile_v3": ("transposed_reduce",),
            "profile_true": ("lane_shuffle", "sub_gather",
                             "transposed_reduce", "elementwise"),
            "profile_shuffle": ("lane_shuffle", "sub_gather"),
            "profile_vpu": ("elementwise", "block_rowsum")}
    for label, names in want.items():
        for k in names:
            require(counts[label][k] > 0,
                    f"{label} never launched {k}: {counts[label]}")

    dev = torch.device("cuda")
    full = {"vals": torch.from_numpy(hk["vals"]).to(dev),
            "rel": torch.from_numpy(hk["rel"]).to(dev),
            "start": torch.from_numpy(hk["start"]).to(dev),
            "slot_start": torch.from_numpy(hs["start"]).to(dev),
            "tvals": torch.from_numpy(hv["vals"]).to(dev),
            "trel": torch.from_numpy(hv["rel"]).to(dev),
            **{k: torch.from_numpy(ht[k]).to(dev)
               for k in ("x0", "sidx", "sidx8")},
            "sx": torch.from_numpy(hsh["x"]).to(dev),
            **{k: torch.from_numpy(v).to(dev) for k, v in hsh.items()
               if k.startswith("idx")},
            "vx": torch.from_numpy(hvpu["x"]).to(dev),
            "vr": torch.from_numpy(hvpu["r"]).to(dev)}
    slots = torch.from_numpy(hs["slots"]).to(dev).reshape(-1)
    state = torch.from_numpy(hs["state"]).to(dev)
    # the slotted probe's partials: its gather + sum
    full["partials"] = torch.index_select(state, 0, slots).view(
        C_slot, profile_slotted.K, profile_slotted.W).sum(dim=1)
    del slots, state, hk, hs, hv, ht, hsh, hvpu
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    cases = probe_cases(torch, gen, full)
    emit({"phase": "probes", "input_seconds": round(t_inputs, 3),
          "runs": counts, "cases": len(cases), "all_pass": True,
          "detail": cases,
          "probe_lines": {k: v["lines"] for k, v in runs.items()},
          "slot_host": runs["profile_slotted"]["host"], "card": card})

    err = {c["case"]: c["max_abs_err"] for c in cases}
    part, sst = full["partials"], full["slot_start"]
    vals, rel, start = full["vals"], full["rel"], full["start"]
    tvals, trel = full["tvals"], full["trel"]
    C, W = part.shape
    Ck, E = vals.shape
    Et, N = tvals.shape
    # one scatter_add computes S9's sums over [C, W + 1] (the pad lane
    # dropped after) and S3/S12's along dim 0 over [W + 1, N]
    lane = torch.where((rel >= 0) & (rel < W), rel, W).long()
    flat_idx = (torch.arange(Ck, device=dev)[:, None] * (W + 1)
                + lane).reshape(-1)
    del lane
    flat_vals = vals.reshape(-1)
    base = torch.zeros(Ck * (W + 1), device=dev)
    tidx = torch.where((trel >= 0) & (trel < W), trel, W).long()
    tbase = torch.zeros((W + 1, N), device=dev)
    mmas = mma_count(rel, W)
    specs = [
        {"name": "carry", "key": "carry_combine", "shape": [C, W],
         "kernel": lambda: carry_combine(part, sst),
         "plain": lambda: carry_combine_plain(part, sst), "library": None,
         "bound": (C * (8 * W + 4), C * W, FP32_OPS_PER_S),
         "source": "lux_tpu_torch/csrc/carry.cu",
         "replaces": "scripts/profile_slotted.py:127",
         "max_abs_err": err["carry/script_full"],
         "extra": {
             "graph_replay_ms": graph_ms(torch, lambda: carry_combine(
                 part, sst), 20),
             "cumsum_ms": bench_ms(args, dev,
                                   lambda: torch.cumsum(part, 0)),
             "cumsum_note": "torch.cumsum(part, 0): the same bytes, not "
                            "the same function (no segments); a "
                            "yardstick, not the library column"}},
        {"name": "fused_carry", "key": "fused_carry", "shape": [Ck, E, W],
         "kernel": lambda: fused_carry(vals, rel, start, W),
         "plain": lambda: fused_carry_plain(vals, rel, start, W),
         "library": None,
         "bound": (Ck * (8 * E + 4 + 4 * W), Ck * (E + W), FP32_OPS_PER_S),
         "source": "lux_tpu_torch/csrc/fused_carry.cu",
         "replaces": "scripts/profile_kernel.py:82",
         "max_abs_err": err["fused_carry/script_full"]},
        {"name": "onehot_reduce", "key": "onehot_reduce",
         "shape": [Ck, E, W],
         "kernel": lambda: onehot_reduce(vals, rel, W),
         "plain": lambda: onehot_reduce_plain(vals, rel, W),
         "library": lambda: base.scatter_add(0, flat_idx, flat_vals),
         "bound": (Ck * (8 * E + 4 * W), mmas * MMA_OPS, BF16_TC_OPS_PER_S),
         "source": "lux_tpu_torch/csrc/onehot_mma.cu",
         "replaces": "scripts/profile_kernel.py:123",
         "max_abs_err": err["onehot/script_full"],
         "extra": {"mma_issued": mmas}},
        *({"name": f"transposed_reduce@wg{wg}", "key": "transposed_reduce",
           "shape": [Et, N, W],
           "kernel": lambda wg=wg: transposed_reduce(tvals, trel, W, wg),
           "plain": lambda: transposed_reduce_plain(tvals, trel, W),
           "library": lambda: tbase.scatter_add(0, tidx, tvals),
           "bound": ((8 * Et + 4 * W) * N, Et * N, FP32_OPS_PER_S),
           "source": "lux_tpu_torch/csrc/transposed_reduce.cu",
           "replaces": "scripts/profile_v3.py:66 and "
                       "scripts/profile_true.py:141",
           "max_abs_err": err[f"transposed/script_full/wg{wg}"],
           "extra": {"wg": wg}} for wg in (8, 16, 32, W)),
        *gather_specs(torch, full, err), *vpu_specs(torch, full, err),
    ]
    lines = [probe_line(args, torch, dev, spec, counts) for spec in specs]
    # B1 itself at profile_kernel's shape (--3d), beside its probes:
    # its bound, plain and scatter_reduce times there
    rel8 = torch.where((rel >= 0) & (rel < W), rel, -1).to(torch.int8)
    b1 = b1_line(args, torch, vals, rel8, W, "chunk_partials@profile_kernel")
    del rel8
    b1["launches"] = sum(c["chunk_partials"] for c in counts.values())
    b1["launches_by_path"] = {k: c["chunk_partials"]
                              for k, c in counts.items()}
    lines.append(b1)
    emit({"phase": "probes_fusion",
          **fusion_answers(args, torch, dev, vals, rel, start, W),
          "card": card})
    return lines


# ---------------------------------------------------------------------
# colfilter: bench.py's colfilter config on the dot path (no hand kernel)
# ---------------------------------------------------------------------

# bench.py's colfilter config: R-MAT scale 16, edge factor 128
# (DEFAULT_SHAPE, bench.py:105-112), weights 1..5 (bench.py:198-200),
# pair threshold 16 and min_fill "auto" (bench.py:1381-1383), which the
# reference resolves to 22 at K = 20 (lux_tpu/ops/pairs.py:160-168); the
# port refuses "auto" (ROADMAP A10), so the run passes 22
CF_SCALE, CF_EF, CF_MIN_FILL = 16, 128, 22
CF_TOL = dict(rtol=1e-5, atol=1e-8)     # __graft_entry__.py:76
# the reference's TPU blocks, timed against the port's default (1 GB of
# the [B, E, W] dot intermediate D a block, ops/dot.DOT_BLOCK_BYTES):
# chunks (lux_tpu/engine/pull.py:48) and rows (lux_tpu/ops/pairs.py:843)
REF_DOT_BLOCKS = (128, 256)


def weighted_rmat(scale: int, ef: int, seed: int):
    """bench.py's weighted graph (bench.py:191-203): R-MAT from
    ``seed``, weights ``default_rng(1).integers(1, 6)`` int32 in CSR
    order."""
    from lux_tpu_torch.convert import rmat_graph
    g = rmat_graph(scale, ef, seed=seed)
    g.weights = np.random.default_rng(1).integers(
        1, 6, size=g.ne).astype(np.int32)
    return g


def require_full_fp32(torch, what: str) -> dict:
    """The dot path's matmuls must run in full f32: TF32 would break
    the reference's rtol 1e-5."""
    flags = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "float32_matmul_precision":
                 torch.get_float32_matmul_precision()}
    require(flags["allow_tf32"] is False
            and flags["float32_matmul_precision"] == "highest",
            f"{what}: TF32 is enabled ({flags})")
    return flags


def cf_blocks(eng, state):
    """The engine's dot blocks of one iteration, for the layer timing:
    (tiled-chunk blocks, pair-row blocks (each with its S, L when
    streamed), paged-row blocks, and the thunk that builds the paged
    blocks, which fetches the unique pages)."""
    from lux_tpu_torch.ops.pagegather import paged_dot_blocks
    from lux_tpu_torch.ops.pairs import pair_dot_blocks, pair_dot_stream_units
    a = eng.arrays
    flat = state.reshape(-1, state.shape[-1])
    chunk = eng.dot_chunk_blocks(state) if eng.tiles is not None else []
    pairs = []
    if eng.pairs is not None:
        args = (flat, a["pair_rowbind"], a["pair_rel"], a["pair_weight"],
                a["pair_row_tile"], a["pair_tile0"])
        if eng.pair_dot_stream:
            pairs = pair_dot_stream_units(*args, eng.pairs.classes)
        else:
            pairs = [(b, None, None) for b in
                     pair_dot_blocks(*args, eng.dot_block_rows)]
    paged_thunk = None
    if eng.page_plan is not None:
        def paged_thunk():
            return paged_dot_blocks(flat, a["pg_ids"], a["pg_sl"],
                                    a["pg_rel"], a["pg_w"], a["pg_rt"],
                                    a["pg_t0"], eng.dot_block_rows)
    return chunk, pairs, paged_thunk


def dot_stage_ms(args, torch, blocks, fn, prefix: str) -> tuple:
    """Device ms of each stage of the SDDMM step over ``blocks`` (one
    iteration's blocks of one delivery), each stage timed alone as a
    loop over every block on the previous stage's outputs: the row /
    tile fetch, D = S @ T^T, the lane select, the messages and the
    one-hot reduce.  Returns (times, the blocks' partials)."""
    from lux_tpu_torch.ops.dot import lane_select, onehot_sum
    reps = max(3, args.reps // 4)
    ST = [b.fetch() for b in blocks]
    W = ST[0][1].shape[1]

    def dmat():
        return [torch.bmm(S, T.transpose(1, 2)) for S, T in ST]

    Ds = dmat()

    def select():
        return [lane_select(D, b.rel) for D, b in zip(Ds, blocks)]

    dots = select()
    out = {f"{prefix}fetch_ms": cuda_ms(lambda: [b.fetch() for b in blocks],
                                        reps),
           f"{prefix}dot_matmul_ms": cuda_ms(dmat, reps),
           f"{prefix}lane_select_ms": cuda_ms(select, reps)}
    Ds.clear()

    def msgs_fn():
        return [fn(S, d, b.weight) for (S, _T), d, b in zip(ST, dots,
                                                             blocks)]

    msgs = msgs_fn()
    out[f"{prefix}messages_ms"] = cuda_ms(msgs_fn, reps)
    out[f"{prefix}onehot_reduce_ms"] = cuda_ms(
        lambda: [onehot_sum(m, b.rel, W) for m, b in zip(msgs, blocks)],
        reps)
    parts = [onehot_sum(m, b.rel, W) for m, b in zip(msgs, blocks)]
    out[f"{prefix}blocks"] = len(blocks)
    return out, parts


def cf_layers(args, torch, eng) -> dict:
    """Device ms of each layer of one colfilter iteration on the
    engine's own arrays and blocks: per delivery the fetch, D, lane
    select, messages and one-hot reduce (ops/dot.py, summed over the
    blocks), then combine_chunks (as the engine runs it), the class
    combine, the pair merge and apply; the whole step, its host enqueue and its device launches
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from lux_tpu_torch.ops.pairs import W, class_combine, fold_stream_slots
    from lux_tpu_torch.ops.tiled import combine_partials
    a, reps = eng.arrays, args.reps
    state = eng.init_state()
    P, K = eng.num_parts, state.shape[-1]
    fn = eng.program.edge_value_from_dot
    chunk, pairs, paged_thunk = cf_blocks(eng, state)
    out, red = {}, None
    if chunk:
        times, parts = dot_stage_ms(args, torch, chunk, fn, "chunk_")
        out.update(times)
        partials = torch.cat(parts)
        # the engine's own combine: the scan as matmuls under use_mxu
        out["combine_chunks_ms"] = cuda_ms(lambda: combine_partials(
            partials, eng.tiles, a["chunk_start"], a["last_chunk"],
            eng.vpad, "sum", eng._plan, eng.use_mxu), reps)
        red = combine_partials(partials, eng.tiles, a["chunk_start"],
                               a["last_chunk"], eng.vpad, "sum", eng._plan,
                               eng.use_mxu)
        del partials, parts
    geo, rows = None, None
    if pairs:
        geo, tp = eng.pairs, a["pair_tile_pos"]
        times, parts = dot_stage_ms(args, torch, [b for b, _S, _L in pairs],
                                    fn, "pair_")
        out.update(times)
        if eng.pair_dot_stream:
            def combine():
                return fold_stream_slots(
                    geo, ((p, S, L) for p, (_b, S, L) in zip(parts, pairs)),
                    tp, K, torch.float32, state.device)
        else:
            rows = torch.cat(parts).view(P, geo.Rp, W, K)[:, :geo.R]

            def combine():
                return class_combine(geo, rows, tp, "sum")
        out["class_combine_ms"] = cuda_ms(combine, reps)
        pred = combine().reshape(P, -1, K)[:, :eng.vpad]
        out["pair_merge_ms"] = cuda_ms(lambda: red + pred, reps)
        red = red + pred
        del parts, rows
    if paged_thunk is not None:
        geo = eng.page_plan
        out["page_fetch_ms"] = cuda_ms(paged_thunk, reps)
        times, parts = dot_stage_ms(args, torch, paged_thunk(), fn, "paged_")
        out.update(times)
        rows = torch.cat(parts).view(P, geo.Rp, W, K)[:, :geo.R]
        tp = a["pg_tp"]
        out["class_combine_ms"] = cuda_ms(
            lambda: class_combine(geo, rows, tp, "sum"), reps)
        red = class_combine(geo, rows, tp, "sum").reshape(
            P, -1, K)[:, :eng.vpad]
        del parts, rows
    out["apply_ms"] = cuda_ms(lambda: eng._apply_epilogue(state, red), reps)
    out["reduced_ms"] = cuda_ms(lambda: eng.reduced(state), reps)
    out["step_ms"] = cuda_ms(lambda: eng.step(state), reps)
    out["step_host_ms"] = host_ms(torch, lambda: eng.step(state), 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step(state)
        torch.cuda.synchronize()
    rows_p = kernel_rows(prof, 1)
    out["device_events_per_iter"] = device_events(prof)
    out["profiled_device_ms"] = sum(r[1] for r in rows_p)
    out["top"] = rows_p[:8]
    return out


def cf_block_sweep(args, torch, eng) -> list:
    """The step's device ms, host enqueue ms and peak memory at the
    engine's default blocks and at the reference's (REF_DOT_BLOCKS;
    streamed pair rows keep their default live-bytes budget), the
    engine's own sizes restored after."""
    keep = (eng.dot_block_chunks, eng.dot_block_rows)
    state = eng.init_state()
    out = []
    for label, sizes in (("default", keep),
                         ("reference", (REF_DOT_BLOCKS[0] if eng.tiles
                                        is not None else keep[0],
                                        REF_DOT_BLOCKS[1]))):
        eng.dot_block_chunks, eng.dot_block_rows = sizes
        eng.step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: eng.step(state), 5)
        out.append({"blocks": label, "block_chunks": sizes[0],
                    "block_rows": sizes[1], "step_ms": ms,
                    "step_host_ms": host_ms(torch, lambda: eng.step(state),
                                            3),
                    "peak_bytes": int(torch.cuda.max_memory_allocated())})
    eng.dot_block_chunks, eng.dot_block_rows = keep
    return out


def run_cf_config(args, torch, eng, g, sg, want, int_case, name, card,
                  extra) -> dict:
    """Drive one colfilter engine through ``run`` and hold it to
    everything: the float64 oracle ``want`` at CF_TOL, two runs
    bit-equal, no hand kernel launched, both audits at 0 (RMSE does not
    rise), the integer-valued reduce bit-equal to the int64 oracle
    (``int_case`` = (state, reduce) in the engine's ids); then its
    times, layers and block-size sweep.  Returns its launch counts."""
    from lux_tpu_torch import check, device_check
    from lux_tpu_torch.apps import colfilter
    flags = require_full_fp32(torch, name)
    state, secs, counts, peak, host_s = timed_run(torch, eng, args.iters)
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0},
            f"{name}: the dot path launched {counts} (want no hand "
            f"kernel)")
    got = eng.unpad(state)
    require(got.shape == (g.nv, colfilter.K) and np.isfinite(got).all(),
            f"{name}: state is not finite [nv, K]")
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **CF_TOL),
            f"{name}: disagrees with the float64 oracle (max rel err "
            f"{rel_err.max():.3e})")
    repeats = []
    for _ in range(2):
        again, r_secs, _c, _p, r_host = timed_run(torch, eng, args.iters)
        require(same_bits(again, state), f"{name}: two runs differ")
        repeats.append({"ms_per_iter": r_secs * 1e3 / args.iters,
                        "host_enqueue_ms_per_iter":
                            r_host * 1e3 / args.iters})
    del again
    host = check.check_colfilter(g, got)
    dev = device_check.DeviceChecker(sg).colfilter(state)
    require(host.ok and dev.ok, f"{name}: audits {host} / {dev}")
    rmse = [colfilter.rmse(g, np.full((g.nv, colfilter.K),
                                      np.sqrt(1 / colfilter.K))),
            colfilter.rmse(g, got)]
    st, red_want = int_case
    red = eng.unpad(eng.reduced(colfilter.to_state(eng, st)))
    require(np.array_equal(red, red_want.astype(np.float32))
            and np.abs(red_want).max() < 2 ** 24,
            f"{name}: the integer-valued reduce differs from the int64 "
            f"oracle at {int((red != red_want).any(axis=1).sum())} "
            f"vertices")
    del state
    layers = cf_layers(args, torch, eng)
    sweep = cf_block_sweep(args, torch, eng)
    emit({"phase": "colfilter", "config": name, "nv": g.nv, "ne": g.ne,
          "iters": args.iters, "seconds": secs,
          "ms_per_iter": secs * 1e3 / args.iters,
          "host_enqueue_ms_per_iter": host_s * 1e3 / args.iters,
          "gteps": g.ne * args.iters / secs / 1e9,
          "gteps_note": "ne x iterations / CUDA-event seconds of the run",
          "repeats": repeats, "peak_bytes": int(peak),
          "engine_bytes": int(sum(t.numel() * t.element_size()
                                  for t in eng.arrays.values())),
          "max_rel_err": float(rel_err.max()), "tolerance": CF_TOL,
          "bit_equal_runs": 3, "launches": counts, "fp32": flags,
          "audit_host": str(host), "audit_device": str(dev),
          "rmse_init_final": rmse,
          "int_reduce": {"bit_equal": True,
                         "max_abs": int(np.abs(red_want).max())},
          "block_chunks": eng.dot_block_chunks,
          "block_rows": eng.dot_block_rows,
          "pair_dot_stream": eng.pair_dot_stream,
          "layers": layers, "block_sweep": sweep,
          "host_peak_rss_bytes":
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
          **extra, "card": card})
    return counts


def phase_colfilter(args, torch, card) -> dict:
    """bench.py's colfilter config (bench.py:1012-1033) on R-MAT 16, ef
    128, seed --seed, weighted: (a) pair_relabel, threshold 16,
    min_fill 22, tile_e 128, pair rows monolithic (the default here)
    and streamed; (b) no pairs, tile_e 512; (c) gather="paged" on the
    degree-relabelled, 128-aligned graph.  Returns launches by path."""
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.graph import ShardedGraph, degree_relabel, pair_relabel
    args = fewer_reps(args, CF_REPS)
    t0 = time.perf_counter()
    g = weighted_rmat(CF_SCALE, CF_EF, args.seed)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = colfilter_oracle(torch, g, args.iters).astype(np.float32)
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    int_state = np.random.default_rng(args.seed).integers(
        -1, 2, (g.nv, colfilter.K)).astype(np.float32)
    int_red = colfilter.reduced_int64(g, int_state)
    t_int = time.perf_counter() - t0
    deg = g.in_degrees()
    common = {"scale": CF_SCALE, "edge_factor": CF_EF, "seed": args.seed,
              "graph_seconds": round(t_graph, 3),
              "oracle_seconds": round(t_oracle, 3),
              "int_oracle_seconds": round(t_int, 3),
              "max_in_degree": int(deg.max()),
              "median_in_degree": float(np.median(deg))}
    counts = {}
    t0 = time.perf_counter()
    g3, perm, starts = pair_relabel(g, 1, pair_threshold=PAIR_THRESHOLD)
    t_relabel = time.perf_counter() - t0
    for stream in (False, True):
        label = "streamed" if stream else "monolithic"
        t0 = time.perf_counter()
        sg = ShardedGraph.build(g3, 1, starts=starts,
                                pair_threshold=PAIR_THRESHOLD)
        eng = colfilter.build_engine(
            g3, 1, sg=sg, pair_threshold=PAIR_THRESHOLD,
            pair_min_fill=CF_MIN_FILL, pair_stream=None if not stream
            else True)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        require(eng.pairs is not None and eng.tiles.E == 128
                and eng.pair_dot_stream is stream,
                f"pairs {label}: resolved stream={eng.pair_dot_stream} "
                f"E={eng.tiles.E}")
        sp = eng.pairs
        extra = dict(common, pair_threshold=PAIR_THRESHOLD,
                     min_fill=CF_MIN_FILL, tile_e=eng.tiles.E,
                     relabel_seconds=round(t_relabel, 3),
                     setup_seconds=round(t_setup, 3),
                     pair_plan_seconds=round(eng.plan_seconds, 3),
                     plan={"R": sp.R, "Rp": sp.Rp,
                           "classes": len(sp.classes),
                           "covered": sp.stats["covered"],
                           "coverage": sp.stats["coverage"],
                           "residual_edges": int(eng.sg.ne_part.sum()),
                           "residual_chunks": eng.tiles.n_chunks})
        counts[f"colfilter_pairs_{label}"] = run_cf_config(
            args, torch, eng, g3, sg, want[perm],
            (int_state[perm], int_red[perm]), f"pairs_{label}", card,
            extra)
        if not stream:
            audit_case(torch, eng, "colfilter")
            priced(cf_pricing, args, torch, eng, lambda um: colfilter.
                   build_engine(g3, 1, sg=sg, pair_threshold=PAIR_THRESHOLD,
                                pair_min_fill=CF_MIN_FILL, pair_stream=None,
                                use_mxu=um))
        del eng, sg
        torch.cuda.empty_cache()
    del g3, perm, starts
    t0 = time.perf_counter()
    sg = ShardedGraph.build(g, 1)
    eng = colfilter.build_engine(g, 1, sg=sg)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    require(eng.pairs is None and eng.tiles.E == 512,
            "no pairs: tile_e is not 512")
    counts["colfilter_tiled"] = run_cf_config(
        args, torch, eng, g, sg, want, (int_state, int_red), "tiled", card,
        dict(common, tile_e=eng.tiles.E, setup_seconds=round(t_setup, 3),
             chunks=eng.tiles.n_chunks,
             longest_tile_chunks=eng._plan.max_len))
    del eng, sg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g2, perm2 = degree_relabel(g)
    t_relabel = time.perf_counter() - t0
    t0 = time.perf_counter()
    sg = ShardedGraph.build(g2, 1, vpad_align=128)
    eng = colfilter.build_engine(g2, 1, sg=sg, gather="paged")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    pp = eng.page_plan
    counts["colfilter_paged"] = run_cf_config(
        args, torch, eng, g2, sg, want[perm2],
        (int_state[perm2], int_red[perm2]), "paged", card,
        dict(common, relabel_seconds=round(t_relabel, 3),
             setup_seconds=round(t_setup, 3),
             plan_seconds=round(eng.plan_seconds, 3),
             plan={"R": pp.R, "Rp": pp.Rp, "classes": len(pp.classes),
                   "n_pages": pp.n_pages}))
    flat = eng.init_state().reshape(eng.num_parts * eng.vpad, -1)
    PRICED["colfilter_paged"] = {
        "delivery_ms": cuda_ms(lambda: eng._paged_dot_red(flat), args.reps),
        "rows": eng.num_parts * pp.Rp, "K": colfilter.K,
        "unique_pages": int(pp.stats["unique_pages"])}
    del flat
    del eng, sg
    torch.cuda.empty_cache()
    return counts


def parts_colfilter(args, torch) -> dict:
    """ColFilter at R-MAT PARTS_SCALE, ef 16, seed --seed + 1, weighted,
    4 parts:
    tiled E 128, flat, pair rows monolithic and streamed, paged; each
    against the float64 oracle at CF_TOL with no hand kernel launched;
    page-major must raise the reference's ValueError."""
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.graph import pair_relabel
    g = weighted_rmat(PARTS_SCALE, 16, args.seed + 1)
    want = colfilter_oracle(torch, g, args.iters)
    g3, perm, starts = pair_relabel(g, 4, pair_threshold=PAIR_THRESHOLD)
    runs = {"tiled": (g, want, dict(tile_e=128)),
            "flat": (g, want, dict(layout="flat")),
            "pairs_monolithic": (g3, want[perm], dict(
                pair_threshold=PAIR_THRESHOLD, pair_min_fill=CF_MIN_FILL,
                starts=starts, pair_stream=False)),
            "pairs_streamed": (g3, want[perm], dict(
                pair_threshold=PAIR_THRESHOLD, pair_min_fill=CF_MIN_FILL,
                starts=starts, pair_stream=True)),
            "paged": (g, want, dict(gather="paged"))}
    out = {}
    for name, (gr, wt, kw) in runs.items():
        eng = colfilter.build_engine(gr, 4, **kw)
        state = eng.init_state()
        zero_launches()
        state = eng.run(state, args.iters)
        torch.cuda.synchronize()
        counts = read_launches()
        got = eng.unpad(state)
        rel_err = np.abs(got - wt) / np.maximum(np.abs(wt), 1e-30)
        require(np.allclose(got, wt, **CF_TOL),
                f"4-part colfilter {name} disagrees with the oracle "
                f"({rel_err.max():.3e})")
        require(counts == {"chunk_partials": 0, "lane_shuffle": 0},
                f"4-part colfilter {name} launched {counts}")
        out[name] = {"max_rel_err": float(rel_err.max()),
                     "launches": counts,
                     "pairs_R": None if eng.pairs is None else eng.pairs.R}
        del eng, state
    try:
        colfilter.build_engine(g, 4, gather="pagemajor")
    except ValueError as e:
        require("keep gather='paged'" in str(e),
                f"page-major refused with another message: {e}")
        out["pagemajor"] = f"ValueError: {e}"
    else:
        raise SmokeFailure("colfilter gather='pagemajor' was not refused")
    torch.cuda.empty_cache()
    return {"nv": g.nv, "ne": g.ne, **out}


# ---------------------------------------------------------------------
# the query-batched engines and the Server (bench.py's ksssp-batch@8,
# ppr-batch@8 and the serve-slo mix)

BATCH_B = 8                 # bench.py's "@8" sweep point
BATCH_SOURCE_SEED = 7       # bench.py:955-957: default_rng(7).choice
PPR_ITERS = 20              # bench.py's -ni default (bench.py:1289)
SERVE_QUERIES = 36          # bench.py's -serve-queries default
SERVE_SEG_ITERS = 2         # serve-slo's Server(seg_iters=2)
SERVE_SLO_MS = {"sssp": 250.0, "components": 250.0,
                "pagerank": 1000.0}          # bench.py's -slo-ms default


def _check_batched_case(torch, name, vals, rel, W, kind, plain_on=None):
    """B1's batched form against its plain version (on ``plain_on``,
    default the inputs' device): f32 sums element by element within E *
    2^-23 * S[c, w, b], S the sum of |v| over the same lane in float64
    (the kernel folds each lane in ascending e, the
    plain scatter in another order; each order's error is under half
    that; ``chunk_partials_batched_sum_tolerance``), everything else
    bit-equal."""
    from lux_tpu_torch.ops.chunk_reduce import (
        chunk_partials_batched, chunk_partials_batched_plain,
        chunk_partials_batched_sum_tolerance)
    plain_on = plain_on or vals.device
    got = chunk_partials_batched(vals, rel, W, kind)
    want = chunk_partials_batched_plain(
        vals.to(plain_on), rel.to(plain_on), W, kind).to(vals.device)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
            f"{want.shape}/{want.dtype}")
    if vals.dtype == torch.int32 or kind != "sum":
        ok, tol = same_bits(got, want), "bit-equal"
        err = 0.0 if ok else float(
            (got.double() - want.double()).abs().nan_to_num().max())
    else:
        diff = (got.double() - want.double()).abs()
        bound = chunk_partials_batched_sum_tolerance(vals, rel, W)
        err = float(diff.max()) if got.numel() else 0.0
        ok = bool((diff <= bound).all())
        tol = "per element E * 2^-23 * sum|v| over the lane"
    require(ok, f"batched B1 case {name} disagrees with the plain version "
                f"(max abs err {err}, {tol})")
    return {"case": name, "shape": list(vals.shape), "W": W,
            "dtype": str(vals.dtype).replace("torch.", ""), "kind": kind,
            "max_abs_err": err, "tolerance": tol}


def check_batched_deterministic(torch, name, vals, rel, W, kind):
    """Three launches on the same inputs give the same bits."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched
    outs = [chunk_partials_batched(vals, rel, W, kind) for _ in range(3)]
    torch.cuda.synchronize()
    require(_same_words(outs[0], outs[1]) and _same_words(outs[0], outs[2]),
            f"batched B1 {name}: three launches differ in bits")
    return {"case": f"{name}/deterministic", "shape": list(vals.shape),
            "W": W, "dtype": str(vals.dtype).replace("torch.", ""),
            "kind": kind, "max_abs_err": 0.0,
            "tolerance": "bit-equal across three launches"}


def b1_batched_cases(torch, gen, dev) -> list:
    """B1's batched form against its plain version on the shapes its
    design splits on: B in {1, 2, 3, 4, 8, 9, 16, 64} (column groups of
    1, 2, 4 and 8 with vector loads where whole, a partial last group
    at B = 3 and 9, several groups at 9, 16 and 64), sorted tiled-like
    rows with pads at the tail (the scan), unsorted rows (the match
    groups), paged-like E = 128 rows at ~95% pads with whole all-pad
    steps, rows whose steps switch between sorted and unsorted, rows
    whose threads' entries descend (1, 0, 1, 0, ...), E in
    {1, 3, 33, 130} (a partial step), all-pad and empty-lane chunks,
    lanes outside [0, W), unaligned value and lane bases, C = 0, int32
    at INT32_MIN / INT32_MAX and wrapping sums, NaN values for min and
    max; three launches bit-equal at B = 4 and 8 sorted and on the
    paged-like rows; a strided view refused."""
    from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                                chunk_partials_batched)
    W, cases = 128, []

    def lanes(c, e, sort, w=W, lo=0):
        r = torch.randint(lo, w, (c, e), generator=gen, device=dev)
        if sort:
            r = r.sort(dim=1).values
        # pads: a random tail of each row (sorted) or ~10% anywhere
        if sort:
            n_live = torch.randint(0, e + 1, (c, 1), generator=gen,
                                   device=dev)
            r = torch.where(torch.arange(e, device=dev)[None, :] < n_live,
                            r, -1)
        else:
            r = torch.where(torch.rand((c, e), generator=gen, device=dev)
                            < 0.1, -1, r)
        r[::7] = -1                                # all-pad chunks
        return r.to(torch.int8).contiguous()

    def values(c, e, b, dtype, offset=0):
        n = c * e * b + offset
        if dtype == torch.int32:
            flat = torch.randint(-1000, 1000, (n,), generator=gen,
                                 device=dev, dtype=torch.int32)
        else:
            flat = torch.randn((n,), generator=gen, device=dev)
        return flat[offset:].view(c, e, b)

    C = 1001
    for B in (1, 3, 8, 64):
        for sort in (True, False):
            e = 512 if sort else 128
            rel = lanes(C if B < 64 else 203, e, sort)
            for dtype in (torch.float32, torch.int32):
                for kind in ("sum", "min", "max"):
                    cases.append(_check_batched_case(
                        torch, f"B{B}_{'sorted' if sort else 'unsorted'}/"
                               f"{str(dtype)[6:]}_{kind}",
                        values(rel.shape[0], e, B, dtype), rel, W, kind))
    for e in (1, 3, 33, 130):
        for B in (3, 8):
            rel = lanes(C, e, e % 2 == 1)
            for kind in ("sum", "min", "max"):
                cases.append(_check_batched_case(
                    torch, f"E{e}_B{B}/f32_{kind}",
                    values(C, e, B, torch.float32), rel, W, kind))
    for w in (100, 37):
        rel = lanes(C, 256, False, w=128, lo=-128)
        for kind in ("sum", "max"):
            cases.append(_check_batched_case(
                torch, f"lanes_outside_W{w}/int32_{kind}",
                values(C, 256, 8, torch.int32), rel, w, kind))
    # unaligned bases: values one element off 16 B (the scalar-load
    # path at B = 8), lane ids one byte off 4 B
    rel_buf = lanes(C * 512 + 1, 1, False).reshape(-1)
    rel = rel_buf[1:].view(C, 512)
    for kind in ("sum", "min"):
        cases.append(_check_batched_case(
            torch, f"unaligned_bases/f32_{kind}",
            values(C, 512, 8, torch.float32, offset=1), rel, W, kind))
    cases.append(_check_batched_case(
        torch, "C0/f32_sum", values(0, 512, 8, torch.float32),
        lanes(0, 512, True), W, "sum"))
    # int32 extremes: the min/max identities are INT32_MAX / INT32_MIN
    rel = lanes(C, 512, True)
    v = values(C, 512, 8, torch.int32)
    v[::3] = torch.iinfo(torch.int32).min
    v[1::3] = torch.iinfo(torch.int32).max
    for kind in ("sum", "min", "max"):
        cases.append(_check_batched_case(torch, f"int32_extremes/{kind}", v,
                                         rel, W, kind))
    # NaN values: min and max propagate them (plain on the CPU, where
    # scatter_reduce propagates NaN for certain)
    rel = lanes(257, 512, True)
    v = values(257, 512, 8, torch.float32)
    v[::5, ::7] = float("nan")
    for kind in ("min", "max"):
        cases.append(_check_batched_case(torch, f"nan/{kind}", v, rel, W,
                                         kind, plain_on="cpu"))
    # the fleet's regime (B = 4, 2 on sorted E = 512 rows), a column
    # group with a one-column remainder (B = 9) and two whole groups (16)
    for B in (2, 4, 9, 16):
        for sort in ((True,) if B < 8 else (True, False)):
            e = 512 if sort else 128
            rel = lanes(C if B < 16 else 503, e, sort)
            for dtype in (torch.float32, torch.int32):
                for kind in ("sum", "min", "max"):
                    cases.append(_check_batched_case(
                        torch, f"B{B}_{'sorted' if sort else 'unsorted'}/"
                               f"{str(dtype)[6:]}_{kind}",
                        values(rel.shape[0], e, B, dtype), rel, W, kind))

    def paged_like(c):
        # the paged rows' regime: E = W = 128, lanes in source order,
        # ~95% pads, whole all-pad steps (every other row's second and
        # fourth steps), a row with one live entry
        r = torch.randint(0, W, (c, 128), generator=gen, device=dev)
        r = torch.where(torch.rand((c, 128), generator=gen, device=dev)
                        < 0.95, -1, r)
        r[::2, 32:64] = -1
        r[::2, 96:] = -1
        r[1::9] = -1
        r[1::9, 77] = 3
        return r.to(torch.int8).contiguous()

    rel_paged = paged_like(C)
    for B in (4, 8):
        for dtype in (torch.float32, torch.int32):
            for kind in ("sum", "min", "max"):
                cases.append(_check_batched_case(
                    torch, f"paged_like_B{B}/{str(dtype)[6:]}_{kind}",
                    values(C, 128, B, dtype), rel_paged, W, kind))
    # sorted rows whose odd steps are reversed: steps switch between the
    # scan and the match groups within a row
    rel = lanes(C, 512, True).view(C, 16, 32)
    rel[:, 1::2] = rel[:, 1::2].flip(2)
    rel = rel.reshape(C, 512).contiguous()
    for B in (4, 8):
        for kind in ("sum", "min", "max"):
            cases.append(_check_batched_case(
                torch, f"mixed_steps_B{B}/f32_{kind}",
                values(C, 512, B, torch.float32), rel, W, kind))
    # lanes 1, 0, 1, 0, ... over a row's first 64 entries: a thread's
    # entries descend (B <= 4 holds several) though no thread's first
    # lane falls below the tail below it
    rel = lanes(C, 128, False)
    rel[::3, :64] = (1 - torch.arange(64, device=dev) % 2).to(torch.int8)
    for B in (1, 2, 4):
        for dtype, kind in ((torch.float32, "sum"), (torch.float32, "min"),
                            (torch.int32, "sum")):
            cases.append(_check_batched_case(
                torch, f"descending_pairs_B{B}/{str(dtype)[6:]}_{kind}",
                values(C, 128, B, dtype), rel, W, kind))
    v = values(C, 512, 8, torch.float32)
    cases.append(check_batched_deterministic(torch, "B8_sorted_sum", v,
                                             lanes(C, 512, True), W, "sum"))
    cases.append(check_batched_deterministic(
        torch, "B4_sorted_sum", values(C, 512, 4, torch.float32),
        lanes(C, 512, True), W, "sum"))
    cases.append(check_batched_deterministic(
        torch, "paged_like_B8_sum", values(C, 128, 8, torch.float32),
        rel_paged, W, "sum"))
    strided = values(C, 512, 16, torch.float32)[:, :, ::2]
    try:
        chunk_partials_batched(strided, lanes(C, 512, True), W, "sum")
    except KernelInputError:
        cases.append({"case": "strided_view_refused", "tolerance": "raises"})
    else:
        raise SmokeFailure("batched B1 took a strided view")
    return cases


def b1_batched_bound(torch, vals, rel, W) -> dict:
    """The batched B1's least time on these inputs: bytes = every lane
    id once + the B values of every entry that matches a lane (a pad's
    values are never needed) + the output written once, at 3.35 TB/s;
    operations = one combine per live value, at the f32 rate
    (``chunk_partials_batched_traffic`` counts the bytes)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched_traffic
    traffic = chunk_partials_batched_traffic(vals, rel, W)
    t_bytes = traffic["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = traffic["live_entries"] * vals.shape[2] / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **traffic}


def colfilter_oracle(torch, g, iters: int, device="cuda") -> np.ndarray:
    """float64 ColFilter with the semantics of
    apps/colfilter.reference_colfilter (the same update from the
    uniform init), run on ``device`` in float64, each destination's
    gradient sums one ``index_add_`` (the numpy oracle's bincount a
    column): a second where the numpy oracle takes a minute at R-MAT 16
    ef 128."""
    from lux_tpu_torch.apps.colfilter import GAMMA, K, LAMBDA
    src, dst = (torch.as_tensor(np.asarray(a, np.int64), device=device)
                for a in g.edge_arrays()[:2])
    w = torch.as_tensor(np.asarray(g.weights, np.float64), device=device)
    state = torch.full((g.nv, K), np.sqrt(1.0 / K), dtype=torch.float64,
                       device=device)
    for _ in range(iters):
        s = state[src]
        s *= (w - (s * state[dst]).sum(1))[:, None]
        acc = torch.zeros_like(state).index_add_(0, dst, s)
        state = state + GAMMA * (acc - LAMBDA * state)
    return state.cpu().numpy()


def in_edge_matrix(g):
    """The [nv, nv] in-edge matrix A[d, s] (duplicate edges add) that
    ppr_oracle multiplies by, built once a graph."""
    from scipy.sparse import csr_matrix
    src, dst = g.edge_arrays()
    return csr_matrix((np.ones(src.size), (dst, src)), shape=(g.nv, g.nv))


def ppr_oracle(g, resets, iters: int, a=None) -> np.ndarray:
    """float64 personalized PageRank with the semantics of
    apps/pagerank.reference_pagerank_batched (the same update, the
    same degree normalization), each iteration's in-edge sums one
    scipy sparse product for every column (duplicate edges add, as
    the numpy oracle's bincount does): seconds where the numpy oracle
    takes a minute at R-MAT 20.  ``a``: in_edge_matrix(g), when the
    caller holds it."""
    from lux_tpu_torch.apps.pagerank import ALPHA
    if a is None:
        a = in_edge_matrix(g)
    resets = np.asarray(resets, dtype=np.float64)
    deg = g.out_degrees.astype(np.float64)[:, None]
    state = np.where(deg > 0, resets / np.maximum(deg, 1), resets)
    for _ in range(iters):
        pr = (1.0 - ALPHA) * resets + ALPHA * (a @ state)
        state = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
    return state


def ppr_oracle_at(g, sources, iters) -> dict:
    """ppr_oracle of one-hot resets at ``sources``, each column read at
    its own iteration count: one run of max(iters) iterations over all
    the columns (each column's recurrence is its own) ->
    {(source, iters): [nv]}."""
    from lux_tpu_torch.apps.pagerank import ALPHA, one_hot_resets
    if not sources:
        return {}
    a = in_edge_matrix(g)
    resets = one_hot_resets(g.nv, sources).astype(np.float64)
    deg = g.out_degrees.astype(np.float64)[:, None]
    state = np.where(deg > 0, resets / np.maximum(deg, 1), resets)
    out = {(s, n): state[:, q].copy()
           for q, (s, n) in enumerate(zip(sources, iters)) if n == 0}
    for t in range(1, max(iters) + 1):
        pr = (1.0 - ALPHA) * resets + ALPHA * (a @ state)
        state = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
        for q, (s, n) in enumerate(zip(sources, iters)):
            if n == t:
                out[(s, n)] = state[:, q].copy()
    return out


def b1_batched_line(args, torch, vals, rel, W, name, kind):
    """The kernels-line entry of B1's batched form on ``vals``/``rel``:
    kernel, plain and one-``scatter_reduce`` times (over [C * (W + 1),
    B]), the bound."""
    from lux_tpu_torch.ops.chunk_reduce import (
        chunk_partials_batched, chunk_partials_batched_plain)
    from lux_tpu_torch.ops.segment import SCATTER_REDUCE, identity_for
    reps = args.reps
    C, E, B = vals.shape
    ms = cuda_ms(lambda: chunk_partials_batched(vals, rel, W, kind), reps)
    plain_ms = cuda_ms(
        lambda: chunk_partials_batched_plain(vals, rel, W, kind), reps)
    relw = rel.to(torch.int64)
    idx = (torch.arange(C, device=vals.device)[:, None] * (W + 1)
           + torch.where((relw >= 0) & (relw < W), relw, W)
           ).reshape(-1, 1).expand(C * E, B)
    del relw
    base = torch.full((C * (W + 1), B), identity_for(kind, vals.dtype),
                      dtype=vals.dtype, device=vals.device)
    flat = vals.reshape(C * E, B)
    library_ms = cuda_ms(lambda: base.scatter_reduce(
        0, idx, flat, SCATTER_REDUCE[kind], include_self=True), reps)
    del idx, base
    got = chunk_partials_batched(vals, rel, W, kind)
    want = chunk_partials_batched_plain(vals, rel, W, kind)
    max_abs_err = max_abs_diff(got, want)
    del got, want
    return {"name": name, "route": "cuda",
            "source": "lux_tpu_torch/csrc/chunk_partials_batched.cu",
            "replaces": "lux_tpu/ops/pallas_reduce.py:63",
            "replaces_note": "B1 over a query axis: the reference's "
                             "Pallas kernel is scalar; its vector payload "
                             "runs XLA (lux_tpu/ops/tiled.py:357)",
            "shape": [C, E, B, W], "kind": kind,
            "dtype": str(vals.dtype).replace("torch.", ""), "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, **b1_batched_bound(torch, vals, rel, W),
            "library_ms": library_ms,
            "library": "scatter_reduce over [C * (W + 1), B]"}


def max_abs_diff(a, b, rows: int = 1 << 16) -> float:
    """max |a - b| in float64, a block of leading rows at a time (the
    paged rows' [Rp, 128, 8] outputs are 10 GB: a whole float64 copy
    would not fit beside them)."""
    return max((float((a[r:r + rows].double() - b[r:r + rows].double())
                      .abs().max()) for r in range(0, a.shape[0], rows)),
               default=0.0)


def batch_graph(args):
    """bench.py's ksssp-batch / ppr-batch graph: R-MAT one scale under
    --scale (20 by default), --ef, --seed, one part, no relabel; and
    its sources, bench.py's draw (bench.py:955-957)."""
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph
    t0 = time.perf_counter()
    src, dst, nv = rmat_edges(args.scale - 1, args.ef, seed=args.seed)
    g = Graph.from_edges(src, dst, nv)
    del src, dst
    rng = np.random.default_rng(BATCH_SOURCE_SEED)
    sources = sorted(int(x) for x in rng.choice(g.nv, size=BATCH_B,
                                                replace=False))
    return g, sources, time.perf_counter() - t0


def batched_layers(args, torch, eng, state, active=None) -> dict:
    """Device ms of each layer of one batched iteration on its own
    input state: the gather (push: mask + gather + relax), B1's batched
    form, the segmented combine, the apply / update; the whole
    iteration alone and replayed from a CUDA graph of 3; its host
    enqueue time."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched
    from lux_tpu_torch.ops.tiled import combine_partials
    a, t, P, B = eng.arrays, eng.tiles, eng.num_parts, eng.batch
    kind, reps = eng.program.reduce, args.reps
    C = P * t.n_chunks
    rel = a["rel_dst"].reshape(C, t.E)
    if active is None:                       # pull
        flat = state.reshape(-1, B)
        msgs = eng._messages(flat)
        gather = lambda: eng._messages(flat)            # noqa: E731
        step = lambda: eng.step(state)                   # noqa: E731
    else:                                    # push (dense only)
        flat = eng._masked_flat(state, active)
        msgs = eng._dense_cand(flat)
        gather = lambda: eng._dense_cand(                # noqa: E731
            eng._masked_flat(state, active))
        step = lambda: eng._dense(state, active)         # noqa: E731
    vals = msgs.reshape(C, t.E, B)
    parts = chunk_partials_batched(vals, rel, t.W, kind)
    red = combine_partials(parts, t, a["chunk_start"], a["last_chunk"],
                           eng.vpad, kind, eng._plan)
    if active is None:
        apply = lambda: eng._apply_epilogue(state, red)  # noqa: E731
    else:
        apply = lambda: eng._dense_update(state, red)    # noqa: E731
    out = {"gather_ms": cuda_ms(gather, reps),
           # the same rows by plain index_select (engine/pull.gather_rows)
           "index_select_ms": cuda_ms(
               lambda: torch.index_select(flat, 0, eng._src), reps),
           "chunk_partials_batched_ms": cuda_ms(
               lambda: chunk_partials_batched(vals, rel, t.W, kind), reps),
           "combine_ms": cuda_ms(lambda: combine_partials(
               parts, t, a["chunk_start"], a["last_chunk"], eng.vpad, kind,
               eng._plan), reps),
           "apply_ms": cuda_ms(apply, reps),
           "step_ms": cuda_ms(step, reps),
           "step_graph_ms": graph_ms(torch, step, 3),
           "step_host_ms": host_ms(torch, step, 10),
           "chunks": C, "E": t.E, "W": t.W, "B": B,
           "messages_bytes": vals.numel() * vals.element_size()}
    out["layers_sum_ms"] = sum(out[k] for k in (
        "gather_ms", "chunk_partials_batched_ms", "combine_ms", "apply_ms"))
    return out, vals, rel


def gather_width_sweep(args, torch, eng) -> dict:
    """The batched source gather at widths B in {1, 2, 4, 8, 16}, on the
    engine's own edge slots: ``torch.index_select`` of [N, B] rows beside
    ``engine/pull.gather_rows`` (the rows read through a padded view),
    whose result must be the same bits."""
    from lux_tpu_torch.engine.pull import gather_rows
    idx, out = eng._src, {}
    gen = torch.Generator(device=idx.device).manual_seed(args.seed)
    for B in (1, 2, 4, 8, 16):
        table = torch.randn((eng.num_parts * eng.vpad, B), generator=gen,
                            device=idx.device)
        require(_same_words(gather_rows(table, idx),
                            torch.index_select(table, 0, idx)),
                f"gather_rows differs from index_select at B = {B}")
        out[f"B{B}"] = {
            "index_select_ms": cuda_ms(
                lambda: torch.index_select(table, 0, idx), args.reps),
            "gather_rows_ms": cuda_ms(lambda: gather_rows(table, idx),
                                      args.reps)}
    del table
    return {"rows": idx.numel(), **out}


def phase_ksssp_batch(args, torch, g, sources, card):
    """bench.py's ksssp-batch@8 (bench.py:941-966): hop SSSP from the 8
    sources on R-MAT 20, one part, no relabel, dense iterations only;
    labels bit-equal to a numpy BFS from each source (bfs_levels) and,
    for the two columns reaching the
    most vertices, to single-source runs of the scalar engine; B1's
    batched form launched once an iteration, the scalar B1 and B2
    never; at most one host sync an iteration.  Returns (the
    kernels-line entry, the launches, B1's own cases, the host labels,
    the guarded case: the engine, its labels and iterations)."""
    from lux_tpu_torch.apps import sssp
    t0 = time.perf_counter()
    eng = sssp.build_engine(g, sources=sources, num_parts=1)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    eng.converge(*eng.init_state())                # warm-up run
    torch.cuda.reset_peak_memory_stats()
    lab0, act0 = eng.init_state()
    (label, active, it), counts, syncs = counted_sync_run(
        torch, lambda: eng.converge(lab0, act0))
    peak = torch.cuda.max_memory_allocated()
    schedule = list(eng.schedule)
    require(schedule == ["dense"] * it and it > 1,
            f"ksssp_batch: schedule {schedule}")
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": it},
            f"ksssp_batch: launched {counts} in {it} dense iterations "
            f"(want the batched B1 once an iteration, nothing else)")
    require(syncs <= it, f"ksssp_batch: {syncs} host syncs in {it} "
                         f"iterations")
    got = eng.unpad(label)
    require(got.shape == (g.nv, BATCH_B) and got.dtype == np.int32,
            "ksssp_batch: labels are not int32 [nv, B]")
    t0 = time.perf_counter()
    levels = bfs_many(g, sources)
    want = np.stack([levels[int(s)] for s in sources],
                    axis=1).astype(np.int64)
    t_oracle = time.perf_counter() - t0
    require(np.array_equal(got.astype(np.int64), want),
            f"ksssp_batch: labels differ from the numpy BFS oracle at "
            f"{int((got != want).sum())} (vertex, query) pairs")
    reached = (want < sssp.HOP_INF).sum(axis=0)
    single = {}
    for q in np.argsort(-reached, kind="stable")[:2]:
        one = sssp.build_engine(g, sources[q], num_parts=1)
        lab1, it1 = one.run()
        require(np.array_equal(lab1, got[:, q]),
                f"ksssp_batch: column {q} differs from the single-source "
                f"run from {sources[q]}")
        single[int(sources[q])] = {"iterations": it1,
                                   "schedule": list(one.schedule)}
        del one
    runs = timed_converges(torch, eng, 3)
    wall = [r["wall_s"] for r in runs]
    best = float(np.median(wall))
    lab, act = eng.init_state()
    for _ in range(2):                      # a state inside the run
        lab, act, _c = eng.step(lab, act)
    layers, vals, rel = batched_layers(args, torch, eng, lab, act)
    profiled = converge_profile(torch, eng, best * 1e3)
    gteps = g.ne * it / best / 1e9
    emit({"phase": "ksssp_batch", "nv": g.nv, "ne": g.ne, "B": BATCH_B,
          "sources": sources, "iterations": it, "schedule_dense": it,
          "reached_per_query": [int(x) for x in reached],
          "launches": counts, "host_syncs": syncs,
          "host_syncs_per_iteration": syncs / it,
          "converge_wall_s": wall,
          "converge_event_s": [r["event_s"] for r in runs],
          "ms_per_iter": best * 1e3 / it, "gteps": gteps,
          "query_gteps": BATCH_B * gteps,
          "gteps_note": "ne x iterations / median wall seconds of 3 "
                        "converges (bench.py:333-335); query_gteps = B x "
                        "gteps, as bench.py records it",
          "host_enqueue_ms_per_iter": layers["step_host_ms"],
          "layers": layers, "device_profile": profiled,
          "peak_bytes": int(peak), "tile_e": eng.tiles.E,
          "setup_seconds": round(t_setup, 3),
          "oracle": "bfs_levels (numpy BFS a source) + 2 scalar runs",
          "oracle_seconds": round(t_oracle, 3), "single_source": single,
          "card": card})
    cases = [_check_batched_case(torch, "ksssp_batch_own/min", vals, rel,
                                 eng.tiles.W, "min"),
             check_batched_deterministic(torch, "ksssp_batch_own", vals, rel,
                                         eng.tiles.W, "min")]
    line = b1_batched_line(args, torch, vals, rel, eng.tiles.W,
                           "chunk_partials_batched@ksssp_batch", "min")
    audit_case(torch, eng, "ksssp_batch")
    line["note"] = ("int32 compare-selects counted at the f32 rate (the "
                    "data sheet gives no int32 rate); bytes bound it")
    del vals, rel
    torch.cuda.empty_cache()
    return line, counts, cases, got, (eng, label, it)


def phase_ppr_batch(args, torch, g, sources, card):
    """bench.py's ppr-batch@8 (bench.py:967-976): personalized PageRank
    with one-hot resets at the 8 sources, PPR_ITERS iterations, one
    part, no relabel; within rtol 5e-5 of the float64 oracle; B1's
    batched form launched once an iteration, nothing else; no host sync
    in the run."""
    from lux_tpu_torch.apps import pagerank
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g, 1, sources=sources)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    state, secs, counts, peak, host_s = timed_run(torch, eng, PPR_ITERS)
    counts = dict(counts, chunk_partials_batched=batched_launches())
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": PPR_ITERS},
            f"ppr_batch: launched {counts} in {PPR_ITERS} iterations")
    got = eng.unpad(state)
    require(got.shape == (g.nv, BATCH_B) and np.isfinite(got).all(),
            "ppr_batch: state is not finite [nv, B]")
    t0 = time.perf_counter()
    want = ppr_oracle(g, pagerank.one_hot_resets(g.nv, sources), PPR_ITERS)
    t_oracle = time.perf_counter() - t0
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **MAIN_TOL),
            f"ppr_batch: disagrees with the float64 oracle (max rel err "
            f"{rel_err.max():.3e})")
    st0 = eng.init_state()
    _r, _c, syncs = counted_sync_run(torch,
                                     lambda: eng.run(st0, PPR_ITERS))
    repeats = []
    for _ in range(2):
        _s, r_secs, _c, _p, r_host = timed_run(torch, eng, PPR_ITERS)
        repeats.append({"ms_per_iter": r_secs * 1e3 / PPR_ITERS,
                        "host_enqueue_ms_per_iter":
                            r_host * 1e3 / PPR_ITERS})
    st = eng.run(eng.init_state(), 3)
    layers, vals, rel = batched_layers(args, torch, eng, st)
    layers["gather_by_width"] = gather_width_sweep(args, torch, eng)
    PRICED["gather_by_width"] = layers["gather_by_width"]
    priced(mxu_ppr, args, torch, g, sources, eng, got, want)
    gteps = g.ne * PPR_ITERS / secs / 1e9
    emit({"phase": "ppr_batch", "nv": g.nv, "ne": g.ne, "B": BATCH_B,
          "sources": sources, "iters": PPR_ITERS, "seconds": secs,
          "ms_per_iter": secs * 1e3 / PPR_ITERS,
          "host_enqueue_ms_per_iter": host_s * 1e3 / PPR_ITERS,
          "host_syncs_per_iteration": syncs / PPR_ITERS,
          "gteps": gteps, "query_gteps": BATCH_B * gteps,
          "max_rel_err": float(rel_err.max()), "tolerance": MAIN_TOL,
          "launches": counts, "repeats": repeats, "layers": layers,
          "peak_bytes": int(peak),
          "state_table_bytes": eng.num_parts * eng.vpad * 4 * BATCH_B,
          "tile_e": eng.tiles.E, "setup_seconds": round(t_setup, 3),
          "oracle": "ppr_oracle (float64, scipy sparse products)",
          "oracle_seconds": round(t_oracle, 3), "card": card})
    cases = [_check_batched_case(torch, "ppr_batch_own/sum", vals, rel,
                                 eng.tiles.W, "sum"),
             check_batched_deterministic(torch, "ppr_batch_own", vals, rel,
                                         eng.tiles.W, "sum")]
    line = b1_batched_line(args, torch, vals, rel, eng.tiles.W,
                           "chunk_partials_batched@ppr_batch", "sum")
    audit_case(torch, eng, "ppr_batch")
    del eng, vals, rel
    torch.cuda.empty_cache()
    return line, counts, cases, want


def serve_stream(g, seed: int):
    """SERVE_QUERIES queries, a third of each kind, in a seeded order
    with seeded sources."""
    rng = np.random.default_rng(seed + 1)
    kinds = np.repeat(np.array(["sssp", "components", "pagerank"]),
                      SERVE_QUERIES // 3)
    kinds = kinds[rng.permutation(kinds.size)]
    return [(str(k), int(rng.integers(0, g.nv))) for k in kinds]


# the oracle answers of the serve stream, kept for the fleet phase,
# which serves the same stream on the same graph: BFS levels by source,
# PageRank by (source, iterations)
SERVE_ORACLE: dict = {"bfs": {}, "ppr": {}}


def serve_check(g, responses, what: str = "serve"):
    """Every answer against its oracle: hop counts and seeded
    components from a numpy BFS per source (bfs_levels: the component
    of a seed is what it reaches), PageRank from the float64 batched
    oracle (ppr_oracle) at the query's own iterations (rtol 5e-5,
    atol 1e-9).  The oracles run only for what SERVE_ORACLE lacks;
    returns (the worst PageRank relative error, how many oracle answers
    were computed)."""
    from lux_tpu_torch.apps.sssp import HOP_INF
    worst = 0.0
    bfs, ppr = SERVE_ORACLE["bfs"], SERVE_ORACLE["ppr"]
    need = {r.source for r in responses
            if r.kind in ("sssp", "components")} - set(bfs)
    bfs.update(bfs_many(g, need))
    pr = sorted({(r.source, r.iters) for r in responses
                 if r.kind == "pagerank"} - set(ppr))
    ppr.update(ppr_oracle_at(g, [s for s, _ in pr], [n for _, n in pr]))
    for r in responses:
        require(r.converged, f"{what}: query {r.qid} retired unconverged")
        if r.kind in ("sssp", "components"):
            lv = bfs[r.source]
            want = lv if r.kind == "sssp" else \
                np.where(lv < HOP_INF, r.source, -1).astype(np.int32)
            require(r.answer.dtype == np.int32
                    and np.array_equal(r.answer, want),
                    f"{what}: {r.kind} query {r.qid} from {r.source} "
                    f"differs from the oracle")
        else:
            want = ppr[(r.source, r.iters)]
            require(np.allclose(r.answer, want, **MAIN_TOL),
                    f"{what}: pagerank query {r.qid} differs from the "
                    f"float64 oracle")
            worst = max(worst, float((np.abs(r.answer - want) / np.maximum(
                np.abs(want), 1e-30)).max()))
    return worst, len(need) + len(pr)


def phase_serve(args, torch, g, card):
    """The Server on the batch phases' graph: batch 8, seg_iters 2,
    deadline 0, bench.py's SLO targets; a warm-up query of each kind
    builds the three engines, then SERVE_QUERIES mixed queries drain
    through continuous-batching refill with every launch count at 0
    just before; every answer against its oracle, at least one boundary
    that retired and refilled columns, serve_retired_total = 36, B1's
    batched form launched, nothing else."""
    from lux_tpu_torch import memwatch, metrics, serve, telemetry
    stream = serve_stream(g, args.seed)
    t0 = time.perf_counter()
    srv = serve.Server(g, batch=BATCH_B, seg_iters=SERVE_SEG_ITERS,
                       deadline_s=0.0, slo_ms=SERVE_SLO_MS)
    for kind in serve.KINDS:                 # builds the three engines
        srv.submit(kind, source=stream[0][1])
    srv.run()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    reg = metrics.Registry()
    srv.set_metrics(reg)
    for r in srv._runners.values():          # forget the warm-up's
        r._slo_window.clear()
        r.boundaries = r.refills = 0
    ev = telemetry.EventLog()
    for kind, s in stream:
        srv.submit(kind, source=s)
    # the memory trail (ROADMAP A10a) on the measured drain: sampled at
    # every boundary, its window opened by the peak reset
    trail = memwatch.MemoryTrail()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv.mem = trail
    zero_launches()
    t0 = time.perf_counter()
    with telemetry.use(events=ev):
        responses = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trail.sample("final")
    window_peak = torch.cuda.max_memory_allocated()
    srv.mem = None
    require(trail.count == sum(r.boundaries for r in srv._runners.values())
            + 1 and trail.grade == memwatch.GRADE_MEASURED
            and all(x.grade == memwatch.GRADE_MEASURED
                    for x in trail.samples),
            f"serve: the trail took {trail.count} samples graded "
            f"{trail.grade}")
    require(trail.peak_bytes == window_peak,
            f"serve: the trail's peak {trail.peak_bytes} != "
            f"max_memory_allocated {window_peak} over the drain")
    led = memwatch.MemoryLedger.for_server(srv, "serve")
    OBSERVE["trail"] = {
        "cell": "serve (ksssp_batch graph, 36 queries)",
        "samples": trail.count, "grade": trail.grade,
        "peak_bytes": trail.peak_bytes,
        "max_memory_allocated": window_peak,
        "live_bytes": [x.live_bytes for x in trail.samples],
        "events": {k: v for k, v in ev.counts().items()
                   if k.startswith("mem_")},
        "server_ledger_bytes": led.total_bytes,
        "verdict": memwatch.drift_verdict(
            trail.peak_bytes, led.total_bytes,
            grade=memwatch.GRADE_MEASURED, where="serve")}
    counts = dict(read_launches(), chunk_partials_batched=batched_launches())
    require(len(responses) == SERVE_QUERIES,
            f"serve: {len(responses)} of {SERVE_QUERIES} answered")
    require(counts["chunk_partials_batched"] > 0
            and counts["chunk_partials"] == 0
            and counts["lane_shuffle"] == 0,
            f"serve: launched {counts} (want only B1's batched form)")
    refills = [e for e in ev.events if e["kind"] == "serve_refill"
               and e.get("retired") and e.get("filled")]
    require(refills, "serve: no boundary retired and refilled columns")
    retired = sum(reg.counter("serve_retired_total", kind=k).value
                  for k in serve.KINDS)
    require(retired == SERVE_QUERIES,
            f"serve: serve_retired_total {retired} != {SERVE_QUERIES}")
    t0 = time.perf_counter()
    worst, _n = serve_check(g, responses)
    t_oracle = time.perf_counter() - t0
    lat = np.array([r.latency_s for r in responses])
    hist = metrics.Histogram()
    for k in serve.KINDS:
        hist = hist.merge(reg.histogram("serve_latency_seconds", kind=k))
    per_kind = {}
    for k in serve.KINDS:
        rs = [r for r in responses if r.kind == k]
        lk = np.array([r.latency_s for r in rs])
        per_kind[k] = {
            "queries": len(rs), "iters": [r.iters for r in rs],
            "segments": [r.segments for r in rs],
            "p50_ms": float(np.percentile(lk, 50)) * 1e3,
            "p99_ms": float(np.percentile(lk, 99)) * 1e3,
            "slo_ms": SERVE_SLO_MS[k],
            "slo_good": reg.counter("serve_slo_good_total", kind=k).value,
            "slo_burn_rate": reg.gauge("serve_slo_burn_rate",
                                       kind=k).value,
            "boundaries": srv._runners[k].boundaries,
            "refill_boundaries": srv._runners[k].refills}
    emit({"phase": "serve", "nv": g.nv, "ne": g.ne, "B": BATCH_B,
          "queries": SERVE_QUERIES, "seg_iters": SERVE_SEG_ITERS,
          "deadline_s": 0.0, "wall_s": wall,
          "qps": SERVE_QUERIES / wall,
          "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
          "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
          "histogram_p50_ms": hist.quantile(0.5) * 1e3,
          "histogram_p99_ms": hist.quantile(0.99) * 1e3,
          "latency_note": "enqueue -> retire, all 36 queued at once "
                          "(offline drain, deadline 0)",
          "per_kind": per_kind, "refill_events": len(refills),
          "serve_retired_total": retired, "launches": counts,
          "pagerank_max_rel_err": worst,
          "warmup_seconds": round(t_warm, 3),
          "oracle_seconds": round(t_oracle, 3), "card": card})
    del srv
    torch.cuda.empty_cache()
    return counts


def phase_batch(args, torch, card):
    """The batch phases: B1's batched form against its plain version on
    synthetic shapes, then ppr-batch@8, the Server and ksssp-batch@8 on
    one R-MAT 20 graph (ksssp last: its engine is returned for the
    guarded case).  Returns (kernels-line entries, launches by path,
    what batch_paged reuses, the ksssp guarded case)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = b1_batched_cases(torch, gen, dev)
    g, sources, t_graph = batch_graph(args)
    emit({"phase": "batch_graph", "nv": g.nv, "ne": g.ne,
          "scale": args.scale - 1, "edge_factor": args.ef, "seed": args.seed,
          "B": BATCH_B, "sources": sources,
          "graph_seconds": round(t_graph, 3)})
    pline, n_p, own_p, ppr_want = phase_ppr_batch(args, torch, g, sources,
                                                  card)
    n_s = phase_serve(args, torch, g, card)
    kline, n_k, own_k, k_labels, k_case = phase_ksssp_batch(
        args, torch, g, sources, card)
    cases += own_k + own_p
    emit({"phase": "kernels", "kernel": "chunk_partials_batched",
          "cases": len(cases), "all_pass": True, "detail": cases})
    by_path = {"ksssp_batch": n_k, "ppr_batch": n_p, "serve": n_s}
    batched = {k: v["chunk_partials_batched"] for k, v in by_path.items()}
    for line, n in ((kline, n_k), (pline, n_p)):
        line["launches"] = n["chunk_partials_batched"]
        line["launches_by_path"] = batched
    return [pline, kline], by_path, (g, sources, k_labels, ppr_want), \
        k_case


# ---------------------------------------------------------------------
# live graphs (ROADMAP A11a): bench.py's serve-live traffic on the
# Server phase's graph

LIVE_CAPACITY = 65536           # delta slots
LIVE_THRESHOLD = 0.75           # bench.py:583
LIVE_PHASES = 6                 # bench.py:625
LIVE_B = 4                      # Server(batch=4)
LIVE_DELETE_PHASES = (2, 4)     # bench.py:632
LIVE_TRAFFIC_SEED = 7           # bench.py's one_step: default_rng(7)
LIVE_WEIGHT_SEED = 1            # bench.py:199-200
LIVE_STEP_REPS = 20             # timed delta steps at a full block


def live_graph(g):
    """bench.py's weighted serve-live graph (bench.py:191-204, 569-572):
    ``g`` with integer weights 1..5 from default_rng(1) in edge order,
    as float32 (integer-valued: every distance sum is exact)."""
    import dataclasses
    w = np.random.default_rng(LIVE_WEIGHT_SEED).integers(
        1, 6, size=g.ne).astype(np.float32)
    return dataclasses.replace(g, weights=w)


class Uncounted:
    """Keep the launch counts as they were across a block: the live
    phase's checks run engines that are not its traffic."""

    def __enter__(self):
        from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                    chunk_partials_batched)
        from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
        from lux_tpu_torch.ops.onehot_reduce import onehot_reduce
        self.fns = (chunk_partials, chunk_partials_batched, lane_shuffle,
                    onehot_reduce)
        self.saved = [f.launches for f in self.fns]
        return self

    def __exit__(self, *exc):
        for f, n in zip(self.fns, self.saved):
            f.launches = n
        return False


def live_state(lv) -> tuple:
    """What a recovery must reproduce, bit for bit."""
    return (lv.base.row_ptrs, lv.base.col_idx, lv.base.weights,
            lv.base.out_degrees, lv.d_src, lv.d_dst, lv.d_w, lv.d_kind,
            lv.d_epoch, lv.count, lv.epoch, lv.base_epoch, lv.generation,
            lv.mutations, lv.deletions, lv.reweights, list(lv._anti))


def same_state(a, b) -> bool:
    return all(np.array_equal(x, y) if isinstance(x, np.ndarray)
               else x == y for x, y in zip(a, b))


def live_converged(eng, nv: int, sources):
    """A batched sssp engine's converged state from one source a column
    (the engine's own init seeds its placeholder sources)."""
    from lux_tpu_torch.apps.sssp import DIST_INF
    lab = np.full((nv, len(sources)), DIST_INF, np.float32)
    act = np.zeros((nv, len(sources)), bool)
    for q, s in enumerate(sources):
        lab[s, q], act[s, q] = 0.0, True
    with Uncounted():
        lab, act, _ = eng.converge(*eng.place(eng.sg.to_padded(lab),
                                              eng.sg.to_padded(act)))
    return lab, act


def live_step_check(torch, lv, eng, sources) -> dict:
    """The delta step on the card against the same step on the CPU, on
    one label, active mask, delta block and column epochs (the engine's
    converged state from ``sources``, its columns pinned to
    [base_epoch, view, epoch, epoch]): labels, active masks and the
    improved count bit-equal."""
    step = lv.delta_step(eng)
    args = lv.delta_tensors(eng)
    ce = lv.col_epochs(eng, np.array(
        [lv.base_epoch, lv.view_epoch(), lv.epoch, lv.epoch][:LIVE_B],
        np.int32))
    lab, act = live_converged(eng, lv.base.nv, sources)
    torch.cuda.synchronize()
    got = step(lab, act, *args, ce)
    want = step(lab.cpu(), act.cpu(), *(a.cpu() for a in args), ce.cpu())
    ok = (same_bits(got[0].cpu(), want[0])
          and torch.equal(got[1].cpu(), want[1])
          and int(got[2]) == int(want[2]))
    require(ok, f"live: the delta step on the card differs from the CPU's "
                f"at epoch {lv.epoch} ({lv.count} slots)")
    return {"slots": int(lv.count), "improved": int(got[2]),
            "col_epoch": ce.cpu().tolist(), "bit_equal": ok}


def live_reseed(torch, lv, target: int, source: int, checker):
    """bench.py's reseed_honest (bench.py:639-671) from ``source``:
    converge over the graph before the deletion, repair that state to
    ``target`` on an engine over graph_at(target) (LiveGraph.revalidate:
    the re-seed), and require it bit-equal to the engine's own full
    recompute and (on the ``checker`` thread) to the numpy oracle.
    Returns (the record, the oracle's future, (graph_at(target), its
    engine, the re-seeded label))."""
    from lux_tpu_torch.apps import sssp
    t0 = time.perf_counter()
    pre = lv.graph_at(target - 1)
    g_t = lv.graph_at(target)
    t_graphs = time.perf_counter() - t0
    eng0 = sssp.build_engine(pre, source, weighted=True)
    lab, act, it0 = eng0.converge(*eng0.init_state())
    host = eng0.unpad(lab)
    del eng0, lab, act
    eng1 = sssp.build_engine(g_t, source, weighted=True)
    lab1, act1 = eng1.place(eng1.sg.to_padded(host),
                            eng1.sg.to_padded(np.zeros(g_t.nv, bool)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fallbacks = lv.reseed_fallbacks
    lab1, act1, it = lv.revalidate(eng1, lab1, act1)
    torch.cuda.synchronize()
    t_reseed = time.perf_counter() - t1
    got = eng1.unpad(lab1)
    with Uncounted():
        full = eng1.unpad(eng1.converge(*eng1.init_state())[0])
    require(np.array_equal(got, full),
            f"live: the re-seed at epoch {target} differs from the engine's "
            f"full recompute")

    def oracle():
        t = time.perf_counter()
        want = sssp.reference_sssp_batched(g_t, [source], weighted=True)
        return (np.array_equal(got.astype(np.float64), want[:, 0]),
                round(time.perf_counter() - t, 3))

    return ({"target": target, "source": source, "pre_iterations": it0,
             "iterations": it, "fallback": lv.reseed_fallbacks > fallbacks,
             "reached": int(np.isfinite(got).sum()),
             "cone_note": "a fallback re-seeds from init (cone > cone_cap nv)",
             "reseed_seconds": round(t_reseed, 4),
             "graph_at_seconds": round(t_graphs, 3),
             "seconds": round(time.perf_counter() - t0, 3),
             "equals_engine_full_recompute": True},
            checker.submit(oracle), (g_t, eng1, lab1))


def live_full_block(args, torch, g, eng_b, eng_1, label_1, sources) -> dict:
    """The delta step's ms at a full block (LIVE_CAPACITY appends, one
    epoch, over ``g``) on the Server's batched sssp engine (its state
    converged from ``sources``) and on a one-source engine over ``g``
    (``label_1``, its fixed point), and a revalidate of that state over
    it (its iterations and wall ms)."""
    from lux_tpu_torch.livegraph import LiveGraph
    rng = np.random.default_rng(args.seed + 11)
    lv = LiveGraph(g, capacity=LIVE_CAPACITY)
    lv.append_edges(rng.integers(g.nv, size=LIVE_CAPACITY),
                    rng.integers(g.nv, size=LIVE_CAPACITY),
                    rng.integers(1, 6, size=LIVE_CAPACITY).astype(np.float32))
    out = {"slots": int(lv.count)}
    for name, eng in (("batched_B4", eng_b), ("one_source", eng_1)):
        step = lv.delta_step(eng)
        dargs = lv.delta_tensors(eng)
        ce = lv.col_epochs(eng, lv.epoch)
        if eng is eng_1:
            lab = label_1
            act = torch.zeros_like(lab, dtype=torch.bool)
        else:
            lab, act = live_converged(eng, g.nv, sources)
        out[f"improved_{name}"] = int(step(lab, act, *dargs, ce)[2])
        out[f"delta_step_ms_{name}"] = cuda_ms(
            lambda: step(lab, act, *dargs, ce), LIVE_STEP_REPS)
    act = torch.zeros_like(label_1, dtype=torch.bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _lab, _act, it = lv.revalidate(eng_1, label_1, act)
    torch.cuda.synchronize()
    out.update(revalidate_ms=(time.perf_counter() - t0) * 1e3,
               revalidate_iterations=it)
    return out


def phase_live(args, torch, g0, card):
    """ROADMAP A11a on the card, shaped like bench.py's serve-live
    (bench.py:527-700) at the Server phase's width: the batch phases'
    R-MAT 20 graph weighted 1..5, a LiveGraph (65,536 delta slots,
    compact_threshold 0.75, a WAL in a temporary directory),
    Server(batch=4, seg_iters=2, weighted=True, live=, cache=True) and
    a CompactionScheduler on its SLO burn.  The re-seeds start from the
    smallest id with an out-edge (bench.py's vertex 0 has none in this
    graph).  Six phases, each an append
    batch of ceil(0.75 * 65,536 / 4) edges and two query waves (the
    second repeats the first's hot sources at the same epoch), deletions
    with the honest re-seed on phases 2 and 4, a reweight on the others,
    the scheduler's fold at each phase boundary; then a forced fold, a
    recovery from the WAL and a tear_wal drill.  Required: every answer
    equal to its numpy oracle at its admission epoch
    (livegraph.check_live_answers), each re-seed equal to the full
    recompute, the recovered state bit-equal, epochs monotone, the delta
    step on the card bit-equal to the CPU's once a phase, B1 (both
    forms) launched.  Printed only: what the clock decides (the
    scheduler's decisions, drag samples, cache hits, latencies, SLO
    counts, qps).  The numpy oracles run on a thread beside the traffic,
    each phase's answers as soon as they are in.  Returns the launches
    (scalar B1, B2, batched B1)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from lux_tpu_torch import faults, livegraph, serve
    t_phase = time.perf_counter()
    g = live_graph(g0)
    nv = g.nv
    source = first_out_vertex(g)
    checker = ThreadPoolExecutor(max_workers=1)
    workers = max(1, min(4, (os.cpu_count() or 2) // 2))
    checks = []
    tmp = tempfile.mkdtemp(prefix="lux_live_")
    wal = os.path.join(tmp, "live.wal")
    lv = livegraph.LiveGraph(g, capacity=LIVE_CAPACITY,
                             compact_threshold=LIVE_THRESHOLD, wal_path=wal)
    srv = serve.Server(g, batch=LIVE_B, seg_iters=SERVE_SEG_ITERS,
                       slo_ms=SERVE_SLO_MS, weighted=True, live=lv,
                       cache=True)
    sc = livegraph.CompactionScheduler(lv, burn=srv.slo_burn)
    kinds = list(serve.KINDS)
    t0 = time.perf_counter()
    for kind in kinds:                      # bench.py: loadgen.warm
        srv.submit(kind, source=0)
    srv.run()
    t_warm = time.perf_counter() - t0
    per = max(len(kinds), SERVE_QUERIES // (2 * LIVE_PHASES))
    per_mut = int(np.ceil(LIVE_THRESHOLD * LIVE_CAPACITY
                          / max(1, LIVE_PHASES - 2)))
    rng = np.random.default_rng(LIVE_TRAFFIC_SEED)
    tracked, responses, phases, reseeds, steps = [], [], [], [], []
    epochs = [lv.epoch]
    eng_b = last_reseed = None
    zero_launches()
    t_traffic = time.perf_counter()
    for phase in range(LIVE_PHASES):
        t_p = time.perf_counter()
        s_new = rng.integers(nv, size=per_mut)
        d_new = rng.integers(nv, size=per_mut)
        w_new = rng.integers(1, 6, size=per_mut).astype(np.float32)
        t0 = time.perf_counter()
        srv.mutate(s_new, d_new, w_new)
        t_mut = time.perf_counter() - t0
        tracked.append((int(s_new[0]), int(d_new[0])))
        if phase in LIVE_DELETE_PHASES and len(tracked) > 1:
            es, ed = tracked.pop(0)
            srv.mutate([es], [ed], op="delete")
            *rec_, last_reseed = live_reseed(torch, lv, lv.epoch, source,
                                             checker)
            reseeds.append(rec_)
        elif phase and tracked:
            rs, rd = tracked[-1]
            srv.mutate([rs], [rd], weights=[float(rng.integers(1, 6))],
                       op="reweight")
        epochs.append(lv.epoch)
        hot = {k: int(rng.integers(nv)) for k in kinds}
        view = lv.view_epoch()
        t0 = time.perf_counter()
        out = []
        for _wave in range(2):
            for i in range(per):
                kind = kinds[i % len(kinds)]
                srv.submit(kind, source=hot[kind] if i < len(kinds)
                           else int(rng.integers(nv)))
            out += srv.run()
        t_serve = time.perf_counter() - t0
        responses += out
        checks.append(checker.submit(livegraph.check_live_answers, lv, out,
                                     True, workers))
        col_src = [source, *hot.values()][:LIVE_B]
        steps.append(live_step_check(torch, lv, srv._runner("sssp").eng,
                                     col_src))
        if phase == LIVE_PHASES - 1:
            eng_b = srv._runner("sssp").eng       # kept for the timings
        t0 = time.perf_counter()
        decision = sc.maybe_compact(server=srv)
        t_fold = time.perf_counter() - t0
        t0 = time.perf_counter()
        if phase < LIVE_PHASES - 1:         # the new generation's engines
            with ThreadPoolExecutor(max_workers=len(kinds)) as ex:
                list(ex.map(srv._runner, kinds))
        t_adopt = time.perf_counter() - t0
        phases.append({
            "phase": phase, "epoch": lv.epoch, "view_epoch": view,
            "mutate_seconds": round(t_mut, 3),
            "serve_seconds": round(t_serve, 3),
            "decision": decision["action"], "reason": decision["reason"],
            "generation": decision.get("generation"),
            "fold_seconds": round(t_fold, 3),
            "refresh_live_seconds": round(t_adopt, 3),
            "seconds": round(time.perf_counter() - t_p, 3)})
    torch.cuda.synchronize()
    traffic_s = time.perf_counter() - t_traffic
    counts = dict(read_launches(), chunk_partials_batched=batched_launches())
    require(counts["chunk_partials"] > 0
            and counts["chunk_partials_batched"] > 0
            and counts["lane_shuffle"] == 0,
            f"live: launched {counts} (want B1 in the re-seeds' dense "
            f"iterations and B1's batched form in the runners)")
    require(len(responses) == 2 * per * LIVE_PHASES,
            f"live: {len(responses)} of {2 * per * LIVE_PHASES} answered")
    require(all(a <= b for a, b in zip(epochs, epochs[1:]))
            and all(r.epoch is not None and r.epoch <= lv.epoch
                    for r in responses),
            f"live: epochs not monotone: {epochs}")
    require(all(s["bit_equal"] for s in steps) and len(steps) == LIVE_PHASES,
            "live: a delta step check is missing")
    require(len(reseeds) == len(LIVE_DELETE_PHASES),
            f"live: {len(reseeds)} re-seeds")
    # the delta-relax step under the auditor, through register_audit
    lv.register_audit(eng_b)
    audit_case(torch, eng_b, "live_delta", only=["live_delta"])
    # the delta step at a full block, and a revalidate over it, on the
    # last re-seed's graph, engine and state (a fixed point there)
    with Uncounted():
        full = live_full_block(args, torch, *last_reseed[:1], eng_b,
                               *last_reseed[1:],
                               [source, *hot.values()][:LIVE_B])
    del eng_b, last_reseed
    # a forced fold (one more append, so there is a delta to fold), then
    # recovery from the WAL and the tear drill
    srv.mutate([int(rng.integers(nv))], [int(rng.integers(nv))], [3.0])
    t0 = time.perf_counter()
    gen = lv.compact(force=True)
    t_forced = time.perf_counter() - t0
    require(gen is not None and lv.compactions >= 1,
            "live: the forced compaction folded nothing")
    srv.refresh_live()
    live_now = live_state(lv)
    lv.close()
    t0 = time.perf_counter()
    rec = livegraph.LiveGraph.recover(g, wal)
    t_recover = time.perf_counter() - t0
    require(same_state(live_now, live_state(rec)),
            "live: the recovered state differs from the live one")
    pre = live_state(rec)
    size = os.path.getsize(wal)
    rec.close()
    faults.tear_wal(wal, 9)
    rec2 = livegraph.LiveGraph.recover(g, wal)
    rec2.close()
    require(same_state(pre, live_state(rec2)) and os.path.getsize(wal) == size,
            "live: the torn tail's replay is not the pre-append state")
    shutil.rmtree(tmp, ignore_errors=True)
    # the answers against their oracles at each admission epoch, and the
    # re-seeds against theirs (the checker thread's results)
    t0 = time.perf_counter()
    bad = sum(f.result() for f in checks)
    for rec_, fut in reseeds:
        ok, secs = fut.result()
        require(ok, f"live: the re-seed at epoch {rec_['target']} differs "
                    f"from the numpy oracle")
        rec_.update(equals_numpy_oracle=True, oracle_seconds=secs)
    checker.shutdown()
    t_check = time.perf_counter() - t0
    require(bad == 0, f"live: {bad} answer(s) differ from the numpy oracle "
                      f"at their admission epoch")
    reseeds = [r for r, _f in reseeds]
    cache = srv.cache
    lat = {k: [r.latency_s * 1e3 for r in responses if r.kind == k]
           for k in kinds}
    wall = time.perf_counter() - t_phase
    emit({"phase": "live", "nv": nv, "ne": g.ne, "capacity": LIVE_CAPACITY,
          "compact_threshold": LIVE_THRESHOLD, "batch": LIVE_B,
          "seg_iters": SERVE_SEG_ITERS, "per_mutation_batch": per_mut,
          "queries": len(responses), "answers_checked": len(responses),
          "answers_bad": bad, "check_wait_seconds": round(t_check, 3),
          "oracle_workers": workers, "reseed_source": source,
          "epochs": epochs, "mutations": lv.mutations,
          "deletions": lv.deletions, "reweights": lv.reweights,
          "reseeds": reseeds, "delta_step_checks": steps,
          "full_block": full, "launches": counts,
          "forced_fold": {"generation": gen, "seconds": round(t_forced, 3)},
          "recover": {"seconds": round(t_recover, 3), "bit_equal": True,
                      "records_bytes": size},
          "tear_drill": {"torn_bytes": 9, "pre_append_state": True},
          "printed_only": {
              "phases": phases,
              "scheduler_compactions": sc.scheduler_compactions,
              "deferrals": sc.deferrals, "compactions": lv.compactions,
              "drag_samples": len(lv._drag_samples),
              "economics": lv.compact_economics(),
              "cache_hits": cache.hits, "cache_misses": cache.misses,
              "cache_hit_fraction": cache.hit_fraction(),
              "latency_ms": {k: {"p50": float(np.percentile(v, 50)),
                                 "p99": float(np.percentile(v, 99))}
                             for k, v in lat.items() if v},
              "slo_burn": srv.slo_burn(),
              "qps": len(responses) / traffic_s,
              "traffic_seconds": round(traffic_s, 3)},
          "warmup_seconds": round(t_warm, 3), "wall_s": round(wall, 3),
          "card": card})
    del srv, lv, rec, rec2
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------
# the serving fleet (ROADMAP A11b): bench.py's serve-chaos shape on the
# batch phases' graph

FLEET_REPLICAS = 2          # bench.py's -serve-replicas default
FLEET_B = 4                 # bench.py's -serve-batch default
FLEET_KILL_BOUNDARY = 1     # bench.py's -kill-boundary default
FLEET_RETRY = dict(retries=3, backoff_s=0.01, max_backoff_s=0.1)
FLEET_SPAWN_BUDGET_S = 240.0


def fleet_server(g, recover: str | None = None, **kw):
    """bench.py's serve-chaos FleetServer (bench.py:405-415) at the
    serving phases' width, on the card; with ``recover``, the one
    FleetServer.recover brings back from that journal."""
    from lux_tpu_torch import fleet, resilience
    kw = {"replicas": FLEET_REPLICAS, "batch": FLEET_B,
          "seg_iters": SERVE_SEG_ITERS, "slo_ms": SERVE_SLO_MS,
          "retry": resilience.RetryPolicy(**FLEET_RETRY, jitter_seed=0),
          **kw}
    if recover is not None:
        return fleet.FleetServer.recover(g, recover, **kw)
    return fleet.FleetServer(g, **kw)


def fleet_summary(flt, responses, wall: float) -> dict:
    """What the clock decides, printed only: latencies and SLO good
    counts per kind, qps, beat ages."""
    out = {"qps": len(responses) / wall if wall else None,
           "beat_age_s": {r.name: flt.board.age(r.name)
                          for r in flt._replicas}}
    for k in sorted({r.kind for r in responses}):
        lat = np.array([r.latency_s for r in responses if r.kind == k])
        out[k] = {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
                  "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                  "slo_ms": SERVE_SLO_MS[k],
                  "slo_good": (flt.metrics.counter(
                      "serve_slo_good_total", kind=k).value
                      if flt.metrics is not None else None)}
    return out


def retired_once(responses, admitted, what: str) -> None:
    qids = [r.qid for r in responses]
    require(len(set(qids)) == len(qids),
            f"fleet {what}: a qid retired twice")
    require(set(qids) == set(admitted),
            f"fleet {what}: retired {len(set(qids))} of {len(admitted)} "
            f"admitted queries")


def fleet_rows(torch, eng, sources=None):
    """(vals [C, E, B], rel [C, E]) of one batched iteration of a fleet
    runner's engine, the messages B1's batched form reduces: push from
    one source a column after two steps, pull after three iterations."""
    t, a, B = eng.tiles, eng.arrays, eng.batch
    C = eng.num_parts * t.n_chunks
    if sources is None:                     # pull
        state = eng.run(eng.init_state(), 3)
        msgs = eng._messages(state.reshape(-1, B))
    else:                                   # push, hop sssp
        from lux_tpu_torch.apps.sssp import HOP_INF
        nv = eng.sg.nv
        lab = np.full((nv, B), HOP_INF, np.int32)
        act = np.zeros((nv, B), bool)
        for q, s in enumerate(sources[:B]):
            lab[s, q], act[s, q] = 0, True
        lab, act = eng.place(eng.sg.to_padded(lab), eng.sg.to_padded(act))
        for _ in range(2):
            lab, act, _c = eng.step(lab, act)
        msgs = eng._dense_cand(eng._masked_flat(lab, act))
    return msgs.reshape(C, t.E, B), a["rel_dst"].reshape(C, t.E)


def fleet_kernels(args, torch, flt, stream) -> tuple:
    """B1's batched form against its plain version on a live replica's
    own rows at B = 4: int32 min from the sssp runner bit for bit, f32
    sum from the pagerank runner within the batch line's tolerance; and
    its kernels-line entries at those shapes (the checks' launches are
    not counted)."""
    rep = next(r for r in flt._replicas
               if {"sssp", "pagerank"} <= set(r._runners))
    cases, lines = [], []
    with Uncounted():
        for kind, op in (("sssp", "min"), ("pagerank", "sum")):
            eng = rep.runner(kind).eng
            srcs = [s for k, s in stream if k == "sssp"] \
                if kind == "sssp" else None
            vals, rel = fleet_rows(torch, eng, srcs)
            cases.append(_check_batched_case(
                torch, f"fleet_{kind}/{op}", vals, rel, eng.tiles.W, op))
            line = b1_batched_line(args, torch, vals, rel, eng.tiles.W,
                                   f"chunk_partials_batched@fleet_{kind}",
                                   op)
            if op == "min":
                line["note"] = ("int32 compare-selects counted at the f32 "
                                "rate (the data sheet gives no int32 "
                                "rate); bytes bound it")
            lines.append(line)
            del vals, rel
    torch.cuda.empty_cache()
    return cases, lines


def fleet_chaos(args, torch, g, stream, tmp) -> tuple:
    """Drill 1, bench.py's serve-chaos: warm every (replica, kind), arm
    the kill on the routing target at its first loaded boundary past
    warm-up, one run() of the 36 queries with healing on."""
    from lux_tpu_torch import faults, resilience, serve
    kinds = list(serve.KINDS)
    flt = fleet_server(
        g, journal_path=os.path.join(tmp, "chaos.journal"),
        board_path=os.path.join(tmp, "board-chaos"), heal=True,
        respawn_retry=resilience.RetryPolicy(**FLEET_RETRY, jitter_seed=1))
    t0 = time.perf_counter()
    n_warm = flt.warm(kinds)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    victim = flt.routing_target(kinds[0])
    plan = faults.ReplicaKillPlan({victim: FLEET_KILL_BOUNDARY})
    flt.set_fault(plan)
    qids = [flt.submit(k, source=s) for k, s in stream]
    t0 = time.perf_counter()
    responses = flt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(plan.fired and plan.fired[0][0] == victim,
            f"fleet chaos: the kill on {victim} never fired")
    require(flt.failovers >= 1 and flt.respawns == 1
            and flt.quarantines == 0,
            f"fleet chaos: failovers {flt.failovers}, respawns "
            f"{flt.respawns}, quarantines {flt.quarantines}")
    require(not flt.shed_records and flt.journal_replayed == 0,
            f"fleet chaos: {len(flt.shed_records)} shed, journal replayed "
            f"{flt.journal_replayed}")
    retired_once(responses, qids, "chaos")
    require(all(r.state == "up" for r in flt._replicas),
            "fleet chaos: the pool is not whole after run()")
    return flt, responses, {
        "warm_responses": n_warm, "warm_seconds": round(t_warm, 3),
        "drain_seconds": round(wall, 3), "victim": victim,
        "kill": [list(f) for f in plan.fired], "failovers": flt.failovers,
        "respawns": flt.respawns, "quarantines": flt.quarantines,
        "shed": len(flt.shed_records), "dup_dropped": flt.dup_dropped,
        "journal_replayed": flt.journal_replayed,
        "printed_only": {"mttr_s": flt.mttr_s,
                         **fleet_summary(flt, responses, wall)}}


def fleet_crash(args, torch, g, stream, tmp) -> tuple:
    """Drill 2: a fresh fleet on a fresh journal dies whole at its
    first loaded boundary (FLEET_CRASH armed on every replica: before
    any drain the routing pick follows beat ages microseconds apart, so
    a plan on ``routing_target`` alone could wait on a replica that
    never drains); the journal's admitted-unretired queries come back
    through FleetServer.recover and one run()."""
    from lux_tpu_torch import faults, journal
    jpath = os.path.join(tmp, "crash.journal")
    flt = fleet_server(g, journal_path=jpath,
                       board_path=os.path.join(tmp, "board-crash"))
    qids = [flt.submit(k, source=s) for k, s in stream]
    plan = faults.ReplicaKillPlan({r: 0 for r in flt.replica_names},
                                  action=faults.FLEET_CRASH)
    flt.set_fault(plan)
    t0 = time.perf_counter()
    crashed = None
    try:
        flt.run()
    except faults.InjectedFleetCrash as e:
        crashed = e
    t_crash = time.perf_counter() - t0
    require(crashed is not None and plan.fired,
            "fleet crash: the whole-fleet crash never fired")
    flt.close()
    # the crashed fleet's engines are gone with it
    pre = {rep.name: sorted(rep._runners) for rep in flt._replicas}
    del flt
    torch.cuda.empty_cache()
    opens, retired, _hnv, torn = journal.AdmissionJournal.scan(jpath,
                                                               nv=g.nv)
    open_qids = [r.qid for r in opens]
    require(opens and torn == 0
            and set(open_qids) | set(retired) == set(qids),
            f"fleet crash: the journal holds {len(opens)} open and "
            f"{len(retired)} retired of {len(qids)} admitted")
    t0 = time.perf_counter()
    rec = fleet_server(g, recover=jpath,
                       board_path=os.path.join(tmp, "board-recover"))
    require(rec.journal_replayed == len(opens),
            f"fleet crash: recover re-dispatched {rec.journal_replayed} of "
            f"{len(opens)} open admits")
    responses = rec.run()
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    rec.close()
    retired_once(responses, open_qids, "recover")
    final, fretired, _h, _t = journal.AdmissionJournal.scan(jpath, nv=g.nv)
    require(not final and set(fretired) == set(qids)
            and all(c == "answered" for c in fretired.values()),
            "fleet crash: the journal is not closed answered after the "
            "recovered drain")
    return rec, responses, {
        "crash": [list(f) for f in plan.fired],
        "crash_seconds": round(t_crash, 3), "engines_at_crash": pre,
        "admitted": len(qids), "retired_before_crash": len(retired),
        "open_at_crash": len(opens), "recovered": rec.journal_replayed,
        "recover_seconds": round(t_recover, 3),
        "dup_dropped": rec.dup_dropped,
        "printed_only": fleet_summary(rec, responses, t_recover)}


def fleet_subprocess(args, torch, flt, spawned, stream) -> tuple:
    """Drill 3: one in-process replica and a subprocess replica on the
    same card (spawned beside drills 1 and 2), armed to hard-kill itself
    at its second boundary; a third of the stream goes to it directly,
    the rest through run()."""
    from lux_tpu_torch import faults, telemetry
    rep, t_spawn, log = spawned
    if rep is None:
        with open(log) as f:
            raise SmokeFailure(f"fleet subprocess: no worker beat within "
                               f"{FLEET_SPAWN_BUDGET_S} s; its log ends: "
                               f"{f.read()[-2000:]}")
    qids = [flt.submit(k, source=s) for k, s in stream]
    sent = set(qids[::3])
    for q in flt._queues.values():           # a third of the stream
        for req in q.collect(len(q)):
            if req.qid in sent:
                flt._assign(rep, req)
            else:
                q.put(req)
    ev = telemetry.EventLog()
    t0 = time.perf_counter()
    with telemetry.use(events=ev):
        responses = flt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rc = rep.proc.wait(timeout=60)
    require(rc == faults.HARD_KILL_CODE and rep.state == "lost",
            f"fleet subprocess: the worker exited {rc}, state {rep.state}")
    moved = [e for e in ev.events if e["kind"] == "failover"]
    by_worker = {e["qid"] for e in ev.events if e["kind"] == "query_done"
                 and e.get("replica") == rep.name}
    require(moved and all(e["from_replica"] == rep.name
                          and e["to_replica"] == "r0" for e in moved)
            and sent <= {e["qid"] for e in moved} | by_worker,
            f"fleet subprocess: {len(moved)} failovers for {len(sent)} "
            f"queries sent to the worker")
    retired_once(responses, qids, "subprocess")
    return responses, {
        "spawn_seconds": round(t_spawn, 3), "sent_to_worker": len(sent),
        "answered_by_worker": len(by_worker), "failovers": len(moved),
        "worker_exit": rc, "drain_seconds": round(wall, 3),
        "printed_only": fleet_summary(flt, responses, wall)}


def phase_fleet(args, torch, g, card):
    """ROADMAP A11b on the card, shaped like bench.py's serve-chaos
    (bench.py:405-491) at the serving phases' width: the batch phases'
    R-MAT 20 graph, FleetServer(replicas=2, batch=4, seg_iters=2,
    bench.py's SLO targets, RetryPolicy(3, 0.01, 0.1, jitter_seed=0)),
    the serve phase's 36-query stream and its oracle answers.  Three
    drills: the chaos drain (journal, heal=True, respawn jitter_seed 1,
    the kill on the routing target), the whole-fleet crash and its
    recovery from the journal, and a subprocess replica (``python -m
    lux_tpu_torch.fleet -worker``, spawned at the phase's start beside
    the first two drills) that hard-kills itself mid-drain.  Required:
    what the inputs decide (the kill and crash fired, failovers,
    respawns, quarantines, sheds, exactly-once retirement, the journal's
    counts, the worker's exit code, every answer equal to its oracle,
    B1's batched form launched and equal to its plain version on a
    replica's own rows at B = 4).  Printed only: what the clock decides
    (walls, MTTR, latencies, SLO good counts, qps, beat ages, the
    routing pick).  Returns (the launches, the kernels-line entries)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    stream = serve_stream(g, args.seed)
    tmp = tempfile.mkdtemp(prefix="lux_fleet_")
    spec = {"kind": "rmat", "scale": args.scale - 1, "ef": args.ef,
            "seed": args.seed}
    # drill 3's fleet and its worker first: the worker builds its graph
    # while drills 1 and 2 run
    flt3 = fleet_server(g, replicas=1, replica_deadline_s=120.0,
                        board_path=os.path.join(tmp, "board-sub"))

    def spawn():
        t0 = time.perf_counter()
        spool = os.path.join(tmp, "spool")
        rep = flt3.add_subprocess_replica(
            spec, workdir=spool, kill_boundary=1,
            spawn_budget_s=FLEET_SPAWN_BUDGET_S)
        # the worker is r1 beside the in-process r0
        return rep, time.perf_counter() - t0, os.path.join(
            spool, "worker_r1.log")

    pool = ThreadPoolExecutor(max_workers=1)
    spawned = pool.submit(spawn)
    drills, launches = {}, {}
    try:
        zero_launches()
        n0 = 0
        for name, drill in (("chaos", fleet_chaos), ("crash", fleet_crash)):
            flt, responses, drills[name] = drill(args, torch, g, stream, tmp)
            launches[name] = batched_launches() - n0
            n0 = batched_launches()
            t0 = time.perf_counter()
            _w, computed = serve_check(g, responses, f"fleet {name}")
            drills[name]["oracle_check_seconds"] = round(
                time.perf_counter() - t0, 3)
            drills[name]["oracle_answers_computed"] = computed
            if name == "chaos":
                cases, lines = fleet_kernels(args, torch, flt, stream)
            del flt, responses
            torch.cuda.empty_cache()
        responses, drills["subprocess"] = fleet_subprocess(
            args, torch, flt3, spawned.result(), stream)
        launches["subprocess"] = batched_launches() - n0
        counts = dict(read_launches(),
                      chunk_partials_batched=batched_launches())
        _w, computed = serve_check(g, responses, "fleet subprocess")
        drills["subprocess"]["oracle_answers_computed"] = computed
    finally:
        # the worker stops with its fleet, whatever failed above
        pool.shutdown(wait=True)
        flt3.close()
        shutil.rmtree(tmp, ignore_errors=True)
    require(counts["chunk_partials_batched"] > 0
            and all(n > 0 for n in launches.values())
            and counts["chunk_partials"] == 0
            and counts["lane_shuffle"] == 0,
            f"fleet: launched {counts}, batched by drill {launches} (want "
            f"only B1's batched form, in every drill)")
    for line in lines:
        line["launches"] = counts["chunk_partials_batched"]
    del flt3
    torch.cuda.empty_cache()
    emit({"phase": "fleet", "nv": g.nv, "ne": g.ne,
          "replicas": FLEET_REPLICAS, "batch": FLEET_B,
          "seg_iters": SERVE_SEG_ITERS, "queries": SERVE_QUERIES,
          "slo_ms": SERVE_SLO_MS, "retry": FLEET_RETRY,
          "worker_graph": spec, "drills": drills,
          "launches": counts, "batched_launches_by_drill": launches,
          "kernel_checks": cases, "wall_s": round(
              time.perf_counter() - t_phase, 3), "card": card})
    SERVE_ORACLE["bfs"].clear()
    SERVE_ORACLE["ppr"].clear()
    return counts, lines


# ---------------------------------------------------------------------
# guarded execution and durability (ROADMAP A9): the watchdog, the
# checkpoints, the supervisor and DurationBudget on the main engines

# the supervisor's backoffs in the drills: short, the failures are
# injected
FAST_RETRY = dict(retries=3, backoff_s=0.01, max_backoff_s=0.05)


def pull_watch_ops(torch, eng, old, new):
    """The ops a guarded pull iteration adds to the plain one, on one
    iteration's (old, new) states: the counters, the word and window
    update, the where's that hold a tripped run and the buffer
    writes."""
    from lux_tpu_torch import health
    h, win = health.init_word(old.device), health.init_window(old.device)
    rb, cb, rbp, cbp = eng._stats_bufs()

    def ops():
        r, cnt, rp, cp = eng._iter_counters(new, old)
        h2, w2 = health.pull_update(h, win, new, r)
        ok = h[0] == 0
        torch.where(ok, new, old)
        torch.where(ok, h2, h)
        torch.where(ok, w2, win)
        rb[0] = torch.where(ok, r, rb[0])
        cb[0] = torch.where(ok, cnt, cb[0])
        rbp[0] = torch.where(ok, rp, rbp[0])
        cbp[0] = torch.where(ok, cp, cbp[0])
    return ops


def seeded_crash_plan(seed: int, boundaries: int):
    """The first FaultPlan.seeded(s) from ``seed`` on whose schedule
    crashes at one of the run's ``boundaries`` segment boundaries."""
    from lux_tpu_torch import faults
    for s in range(seed, seed + 1000):
        plan = faults.FaultPlan.seeded(s, n=boundaries, p_crash=0.3)
        if plan.schedule:
            return s, plan
    raise SmokeFailure("no seeded crash plan in 1000 seeds")


def guarded_pull(args, torch, eng, plain, blocks: int):
    """The guarded cases on the pairs phase's streamed engine (bench.py's
    pagerank config): the watchdog's run bit-equal to ``plain`` with
    B1's launches unchanged and at most one host read more than the
    plain run; its cost; the NaN drill; the supervisor with a seeded
    crash and with a bit-flipped newest checkpoint; DurationBudget.
    Returns the case's record."""
    import tempfile

    from lux_tpu_torch import (checkpoint, faults, health, resilience,
                               segmented, telemetry)
    iters, per = args.iters, 1 + blocks
    init = eng.init_state()
    want = {"chunk_partials": per * iters, "lane_shuffle": 0,
            "chunk_partials_batched": 0}
    eng.health = False
    _s, counts, plain_syncs = counted_sync_run(torch,
                                               lambda: eng.run(init, iters))
    require(counts == want, f"guarded: plain run launched {counts}")
    eng.health = True
    state, counts, syncs = counted_sync_run(torch,
                                            lambda: eng.run(init, iters))
    require(counts == want, f"guarded: the guarded run launched {counts} "
                            f"(want the plain run's {want})")
    require(same_bits(state, plain), "guarded: the guarded PageRank state "
                                     "is not bit-equal to the plain run's")
    require(syncs - plain_syncs <= 1,
            f"guarded: {syncs} host syncs against the plain run's "
            f"{plain_syncs} (want at most one more: the word's decode)")
    st, it, *_bufs, watch = eng.run_health(init, iters)
    word = health.digest(watch, "pull")
    require(int(it) == iters and not word["tripped"] and same_bits(st, plain),
            f"guarded: run_health executed {int(it)} iterations, {word}")
    # the watchdog's cost: device spans of the plain and guarded runs in
    # turns, their host enqueue, and the added ops alone
    reps = 3
    spans = {"plain": [], "guarded": []}
    for kind in ("plain", "guarded", "guarded", "plain"):
        fn = (lambda: eng.run_health(init, iters)) if kind == "guarded" \
            else (lambda: eng._run_plain(init, iters))
        spans[kind].append(cuda_ms(fn, reps) / iters)
    cost = {"plain_step_ms": spans["plain"],
            "guarded_step_ms": spans["guarded"],
            "plain_host_enqueue_ms": host_ms(
                torch, lambda: eng._run_plain(init, iters), 2) / iters,
            "guarded_host_enqueue_ms": host_ms(
                torch, lambda: eng.run_health(init, iters), 2) / iters,
            "watch_ops_ms": cuda_ms(pull_watch_ops(torch, eng, init, st),
                                    args.reps),
            "host_syncs_plain_run": plain_syncs,
            "host_syncs_guarded_run": syncs}
    # the NaN drill: a NaN poked into the state after iteration 3 of 10
    s3 = eng.run(init, 3)
    faults.nan_corrupt(s3, 1)
    s3_copy = s3.clone()
    try:
        segmented.run_segments(eng, s3, iters, iters, start_iter=3)
        raise SmokeFailure("guarded: the NaN drill did not trip")
    except health.HealthError as e:
        trip = {"checks": e.checks, "iteration": e.iteration,
                "part": e.part, "count": e.count, "message": str(e)}
    require("nonfinite_state" in trip["checks"] and trip["iteration"] == 3
            and trip["part"] == 0,
            f"guarded: the NaN drill's diagnosis is {trip}")
    out, it, *_bufs, watch = eng.run_health(s3_copy, iters - 3)
    require(int(it) == 1 and same_bits(out, eng._run_plain(s3_copy, 1)),
            f"guarded: the NaN drill executed {int(it)} iterations or kept "
            f"another state than the tripping iteration's")
    trip["iters_executed"] = int(it)
    tmp = tempfile.mkdtemp(prefix="lux_smoke_ckpt_")
    path = os.path.join(tmp, "pagerank.npz")
    policy = resilience.RetryPolicy(**FAST_RETRY)
    seed, plan = seeded_crash_plan(args.seed, iters // 2 - 1)
    ev = telemetry.EventLog()
    t0 = time.perf_counter()
    with telemetry.use(events=ev):
        out, rep = resilience.supervised_run(eng, iters, path, segment=2,
                                             faults=plan, policy=policy)
    t_sup = time.perf_counter() - t0
    require(same_bits(out, plain), "guarded: the supervised run with a "
                                   "crash is not bit-equal to the plain run")
    require(rep.attempts == len(plan.fired) + 1 and rep.resumed_from,
            f"guarded: supervisor report {rep.as_dict()}")
    saves = [{"iter": e["iter"], "bytes": e["staged_bytes"],
              "save_ms": e["seconds"] * 1e3}
             for e in ev.events if e["kind"] == "checkpoint_save"]
    supervised = {"seed": seed, "schedule": plan.schedule,
                  "fired": plan.fired, "report": rep.as_dict(),
                  "wall_s": t_sup, "checkpoint_file_bytes":
                      os.path.getsize(path), "saves": saves}
    plan = faults.FaultPlan({2: faults.CKPT_BITFLIP})
    ev = telemetry.EventLog()
    with telemetry.use(events=ev):
        out, rep = resilience.supervised_run(eng, iters, path, segment=2,
                                             faults=plan, policy=policy)
    require(same_bits(out, plain) and ev.counts().get("checkpoint_fallback")
            and rep.resumed_from,
            f"guarded: the bit-flip drill {rep.as_dict()} "
            f"{ev.counts()}")
    bitflip = {"report": rep.as_dict(), "events": ev.counts()}
    # DurationBudget: a budget of about 2.5 iterations of the guarded
    # run locks after its warm-up; the checkpoints land at that size
    per_iter_s = max(max(spans["guarded"]), cost["guarded_host_enqueue_ms"]
                     ) / 1e3
    budget = segmented.DurationBudget(2.5 * per_iter_s / 0.8)
    ev = telemetry.EventLog()
    with telemetry.use(events=ev):
        out = checkpoint.run_checkpointed(eng, init, iters, path,
                                          segment=budget)
    segs = [e["n"] for e in ev.events if e["kind"] == "segment"]
    require(same_bits(out, plain) and budget.locked is not None
            and len(segs) >= 3,
            f"guarded: DurationBudget segments {segs}, lock "
            f"{budget.locked}")
    checkpoint.remove(path)
    os.rmdir(tmp)
    eng.health = False
    return {
        "engine": "bench.py pagerank config (pairs, streamed)",
        "iters": iters, "bit_equal_plain": True, "word": word,
        "launches": counts, **cost, "nan_drill": trip,
        "supervised": supervised, "bitflip_fallback": bitflip,
        "budget": {"budget_s": budget.budget_s, "locked": budget.locked,
                   "per_iter_s": budget.per_iter, "segments": segs,
                   "default_45s_locks_to": min(
                       4096, int(0.8 * 45.0 / budget.per_iter))}}


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def guarded_push(torch, eng, label, it, counts):
    """The sssp phase's engine under converge_health: labels bit-equal,
    the same launches, the word clean, at most one host sync an
    iteration; converge ms against the unguarded run, in turns.
    Returns the case's record."""
    from lux_tpu_torch import health
    eng.converge_health(*eng.init_state())            # warm-up
    l0, a0 = eng.init_state()
    (lab, _act, it2, *_bufs, watch), c2, syncs = counted_sync_run(
        torch, lambda: eng.converge_health(l0, a0))
    word = health.digest(watch, "push")
    require(it2 == it and torch.equal(lab, label) and not word["tripped"],
            f"guarded sssp: {it2} iterations (plain {it}), word {word}")
    require(c2 == dict(counts, chunk_partials_batched=0),
            f"guarded sssp: launched {c2} (plain {counts})")
    require(syncs <= it2, f"guarded sssp: {syncs} host syncs in {it2} "
                          f"iterations")
    ms = {"plain": [], "guarded": []}
    for kind in ("plain", "guarded", "guarded", "plain"):
        lab0, act0 = eng.init_state()
        fn = (lambda: eng.converge_health(lab0, act0)) \
            if kind == "guarded" else (lambda: eng.converge(lab0, act0))
        ms[kind].append(wall_ms(torch, fn))
    return {"engine": "bench.py sssp config (pairs, sparse on)",
            "iterations": it2, "labels_bit_equal": True, "word": word,
            "launches": c2, "host_syncs": syncs,
            "host_syncs_per_iteration": syncs / it2,
            "converge_ms_plain": ms["plain"],
            "converge_ms_guarded": ms["guarded"]}


def guarded_batch(torch, eng, label, it):
    """ksssp-batch@8 on the batch phase's engine under converge_health:
    labels equal to that phase's.  Returns the case's record."""
    from lux_tpu_torch import health
    l0, a0 = eng.init_state()
    (lab, _a, it2, *_b, watch), counts, syncs = counted_sync_run(
        torch, lambda: eng.converge_health(l0, a0))
    word = health.digest(watch, "push")
    require(it2 == it and torch.equal(lab, label) and not word["tripped"]
            and syncs <= it2,
            f"guarded ksssp_batch: {it2} iterations (plain {it}), {syncs} "
            f"syncs, word {word}")
    return {"iterations": it2, "labels_equal": True, "word": word,
            "launches": counts, "host_syncs": syncs}


def guarded_livelock(torch):
    """ROADMAP A9's truncation livelock on the card: R-MAT 5 (ef 16,
    seed 1), start vertex 28 (out-degree 37), edge_budget 22,
    sparse_threshold 1, page-major: HealthError [frontier_stall] within
    max_iters 64, at the iteration the same run trips on the CPU.
    Returns the case's record."""
    from lux_tpu_torch import health
    from lux_tpu_torch.apps import sssp
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.engine.push import PushEngine
    from lux_tpu_torch.graph import Graph, ShardedGraph
    src, dst, nv = rmat_edges(5, 16, seed=1)
    g = Graph.from_edges(src, dst, nv)
    require(int(g.out_degrees[28]) == 37, "livelock repro: vertex 28's "
                                          "out-degree is not 37")
    sg = ShardedGraph.build(g, 1, vpad_align=128)

    def trip(device):
        eng = PushEngine(sg, sssp.make_program(28), gather="pagemajor",
                         edge_budget=22, sparse_threshold=1, device=device,
                         health=True)
        try:
            eng.run(max_iters=64)
        except health.HealthError as e:
            return e, len(eng.schedule)
        raise SmokeFailure(f"livelock repro on {device}: no trip in 64 "
                           f"iterations")

    card, n_card = trip(None)
    cpu, _n = trip("cpu")
    require(card.checks == ["frontier_stall"]
            and card.iteration == cpu.iteration,
            f"livelock repro: card {card.checks} at {card.iteration}, "
            f"CPU {cpu.checks} at {cpu.iteration}")
    return {"checks": card.checks, "trip_iteration": card.iteration,
            "iterations_run": n_card, "max_iters": 64,
            "stall_n": health.STALL_N, "cpu_trip_iteration": cpu.iteration}


def phase_guarded(torch, cases: dict, card) -> None:
    """The guarded phase's line: the cases main ran on the engines the
    pairs, sssp and batch phases returned (``cases``: pagerank, sssp,
    ksssp_batch), and the livelock repro, run here."""
    emit({"phase": "guarded", **cases, "livelock": guarded_livelock(torch),
          "card": card})


# ---------------------------------------------------------------------
# batched paged and page-major delivery (ROADMAP A7b)


PAGED_LAYERS = ("page_fetch_ms", "vrow_take_ms", "lane_resolve_ms",
                "messages_ms", "chunk_partials_batched_ms",
                "class_combine_ms")


def batch_paged_layers(args, torch, eng, state, active=None):
    """Device ms of each layer of one batched paged iteration on its own
    input state, timed on the engine's own delivery: its paged reduce
    stopped after each stage of ops/pagegather.PAGED_STAGES (page
    fetch; + page-major lane-index take; + lane resolve; + messages;
    + B1's batched form; + class combine), each layer the difference of
    two cumulative spans; then the apply / update and the whole step.
    Returns (layers, the messages of the rows, their rel)."""
    from lux_tpu_torch.ops import pagegather as pg
    reps = args.reps
    if active is None:
        flat = state.reshape(-1, eng.batch)
        red_fn = eng._paged_red
        apply = lambda red: eng._apply_epilogue(state, red)  # noqa: E731
        step = lambda: eng.step(state)                      # noqa: E731
    else:
        flat = eng._masked_flat(state, active)
        red_fn = lambda f, upto=None: eng._dense_red(f, None, upto)  # noqa
        apply = lambda red: eng._dense_update(state, red)   # noqa: E731
        step = lambda: eng._dense(state, active)            # noqa: E731
    red = red_fn(flat)
    cum = [cuda_ms(lambda u=u: red_fn(flat, upto=u), reps)
           for u in pg.PAGED_STAGES]
    out = dict(zip(PAGED_LAYERS, [cum[0]] + [b - a for a, b in
                                             zip(cum, cum[1:])]))
    out.update({"apply_ms": cuda_ms(lambda: apply(red), reps),
                "step_ms": cuda_ms(step, reps),
                "step_host_ms": host_ms(torch, step, 5)})
    out["layers_sum_ms"] = cum[-1] + out["apply_ms"]
    del red
    msgs = red_fn(flat, upto="messages")
    n = msgs.shape[0]
    out.update({"rows": n, "blocks": -(-n // pg.paged_block_rows(flat)),
                "B": eng.batch,
                "messages_bytes": msgs.numel() * msgs.element_size(),
                "note": "each layer the difference of two cumulative "
                        "spans of the engine's paged reduce stopped after "
                        "a stage (pagegather.PAGED_STAGES); vrow_take is "
                        "the page-major take of each virtual row's lane "
                        "index (0 for paged)"})
    return out, msgs, eng.arrays["pg_rel"].reshape(-1, pg.W)


def check_batch_paged_rows(torch, name, vals, rel, kind):
    """B1's batched form on a batched paged path's own rows: against its
    plain version (int32 min bit for bit over all rows; f32 sums by
    _check_batched_case's bound on a slice of rows, whose float64
    magnitudes would not fit at full size), on the same rows with
    garbage in every dead lane (NaN for f32, int32 extremes for int32),
    and three launches bit-equal."""
    from lux_tpu_torch.ops.chunk_reduce import (
        chunk_partials_batched, chunk_partials_batched_plain)
    W = rel.shape[1]
    sub = slice(0, min(vals.shape[0], 1 << 18))
    cases = []
    if kind == "sum":
        cases.append(_check_batched_case(torch, f"{name}_own/{kind}",
                                         vals[sub], rel[sub], W, kind))
    else:
        got = chunk_partials_batched(vals, rel, W, kind)
        want = chunk_partials_batched_plain(vals, rel, W, kind)
        require(torch.equal(got, want), f"batched B1 on {name}'s rows "
                                        f"differs from its plain version")
        del got, want
        cases.append({"case": f"{name}_own/{kind}",
                      "shape": list(vals.shape), "W": W, "kind": kind,
                      "max_abs_err": 0.0, "tolerance": "bit-equal"})
    dead = (rel[sub] < 0)[..., None].expand(-1, -1, vals.shape[2])
    junk = vals[sub].clone()
    if junk.is_floating_point():
        junk[dead] = float("nan")
    else:
        junk[dead] = torch.iinfo(torch.int32).min
    cases.append(_check_batched_case(torch, f"{name}_dead_lanes/{kind}",
                                     junk, rel[sub], W, kind))
    cases.append(check_batched_deterministic(torch, f"{name}_own",
                                             vals[sub], rel[sub], W, kind))
    return cases


def batch_paged_ksssp(args, torch, g2, sg, src2, want, mode, card):
    """ksssp-batch@8 on the relabelled graph with ``gather=mode``: labels
    bit-equal to the batch phase's (mapped), B1's batched form once an
    iteration and nothing else, at most one host sync an iteration."""
    from lux_tpu_torch.apps import sssp
    t0 = time.perf_counter()
    eng = sssp.build_engine(g2, sources=src2, num_parts=1, sg=sg,
                            gather=mode)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    require(eng.gather == mode and eng.batch == BATCH_B,
            f"batch_paged {mode}: engine {eng.gather} B={eng.batch}")
    eng.converge(*eng.init_state())                # warm-up run
    torch.cuda.reset_peak_memory_stats()
    l0, a0 = eng.init_state()
    (label, active, it), counts, syncs = counted_sync_run(
        torch, lambda: eng.converge(l0, a0))
    peak = torch.cuda.max_memory_allocated()
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": it} and it > 1,
            f"batch_paged {mode} ksssp: launched {counts} in {it} "
            f"iterations (want B1's batched form once an iteration)")
    require(syncs <= it, f"batch_paged {mode} ksssp: {syncs} host syncs "
                         f"in {it} iterations")
    got = eng.unpad(label)
    require(np.array_equal(got, want),
            f"batch_paged {mode} ksssp: labels differ from the batch "
            f"phase's at {int((got != want).sum())} (vertex, query) pairs")
    runs = timed_converges(torch, eng, 3)
    wall = [r["wall_s"] for r in runs]
    best = float(np.median(wall))
    lab, act = eng.init_state()
    for _ in range(2):
        lab, act, _c = eng.step(lab, act)
    layers, vals, rel = batch_paged_layers(args, torch, eng, lab, act)
    pp = eng.page_plan
    gteps = g2.ne * it / best / 1e9
    res = {"app": "ksssp", "iterations": it, "launches": counts,
           "host_syncs": syncs, "converge_wall_s": wall,
           "ms_per_iter": best * 1e3 / it, "gteps": gteps,
           "query_gteps": BATCH_B * gteps, "layers": layers,
           "peak_bytes": int(peak), "setup_seconds": round(t_setup, 3),
           "plan_seconds": round(eng.plan_seconds, 3),
           "plan": {"R": pp.R, "Rp": pp.Rp, "Rg": pp.Rg or pp.Rp,
                    "n_pages": pp.n_pages, "classes": len(pp.classes)},
           "labels_bit_equal_batch_phase": True}
    del eng
    torch.cuda.empty_cache()
    cases = check_batch_paged_rows(torch, f"ksssp_{mode}", vals, rel, "min")
    line = b1_batched_line(args, torch, vals, rel, 128,
                           f"chunk_partials_batched@ksssp_{mode}", "min")
    line["launches"] = counts["chunk_partials_batched"]
    line["note"] = ("the paged rows [Rp, 128, 8]: unsorted lanes, dead "
                    "lanes rel == -1; int32 compare-selects counted at "
                    "the f32 rate")
    del vals, rel
    torch.cuda.empty_cache()
    return res, cases, line, counts


def batch_paged_ppr(args, torch, g2, sg, src2, want, mode, card):
    """ppr-batch@8 on the relabelled graph with ``gather=mode``, 20
    iterations: within rtol 5e-5, atol 1e-9 of the batch phase's
    float64 oracle (mapped); B1's batched form once an iteration."""
    from lux_tpu_torch.apps import pagerank
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g2, 1, sg=sg, sources=src2, gather=mode)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    state, secs, counts, peak, host_s = timed_run(torch, eng, PPR_ITERS)
    counts = dict(counts, chunk_partials_batched=batched_launches())
    require(counts == {"chunk_partials": 0, "lane_shuffle": 0,
                       "chunk_partials_batched": PPR_ITERS},
            f"batch_paged {mode} ppr: launched {counts} in {PPR_ITERS} "
            f"iterations")
    got = eng.unpad(state)
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **MAIN_TOL),
            f"batch_paged {mode} ppr: max rel err {rel_err.max():.3e}")
    st0 = eng.init_state()
    _r, _c, syncs = counted_sync_run(torch, lambda: eng.run(st0, PPR_ITERS))
    st = eng.run(eng.init_state(), 3)
    layers, vals, rel = batch_paged_layers(args, torch, eng, st)
    gteps = g2.ne * PPR_ITERS / secs / 1e9
    res = {"app": "ppr", "iters": PPR_ITERS, "seconds": secs,
           "ms_per_iter": secs * 1e3 / PPR_ITERS,
           "host_enqueue_ms_per_iter": host_s * 1e3 / PPR_ITERS,
           "host_syncs_per_iteration": syncs / PPR_ITERS,
           "gteps": gteps, "query_gteps": BATCH_B * gteps,
           "max_rel_err": float(rel_err.max()), "tolerance": MAIN_TOL,
           "launches": counts, "layers": layers, "peak_bytes": int(peak),
           "setup_seconds": round(t_setup, 3),
           "plan_seconds": round(eng.plan_seconds, 3)}
    del eng, state, st
    torch.cuda.empty_cache()
    cases = check_batch_paged_rows(torch, f"ppr_{mode}", vals, rel, "sum")
    line = b1_batched_line(args, torch, vals, rel, 128,
                           f"chunk_partials_batched@ppr_{mode}", "sum")
    line["launches"] = counts["chunk_partials_batched"]
    line["note"] = ("the paged rows [Rp, 128, 8]: unsorted lanes, dead "
                    "lanes rel == -1")
    del vals, rel
    torch.cuda.empty_cache()
    return res, cases, line, counts


def phase_batch_paged(args, torch, g, sources, k_labels, ppr_want, card):
    """bench.py's ksssp-batch@8 and ppr-batch@8 graph and sources,
    degree-relabelled with the 128-aligned layout, on gather="paged"
    and "pagemajor": ksssp labels bit-equal to the batch phase's, PPR
    within rtol 5e-5 of its float64 oracle (both mapped through the
    relabel, not recomputed); B1's batched form on the paged rows
    against its plain version; per-layer ms, totals.  Returns (the
    kernels-line entries, the launches of each mode's two runs)."""
    from lux_tpu_torch.graph import ShardedGraph, degree_relabel
    args = fewer_reps(args, BATCH_PAGED_REPS)
    t0 = time.perf_counter()
    g2, perm = degree_relabel(g)
    sg = ShardedGraph.build(g2, 1, vpad_align=128)
    t_graph = time.perf_counter() - t0
    rank = np.empty(g.nv, np.int64)
    rank[perm] = np.arange(g.nv)
    src2 = [int(rank[s]) for s in sources]
    want_k, want_p = k_labels[perm], ppr_want[perm]
    out, cases, lines, by_mode = {}, [], [], {}
    for mode in ("paged", "pagemajor"):
        k, kc, kl, kn = batch_paged_ksssp(args, torch, g2, sg, src2, want_k,
                                          mode, card)
        p, pc, pl, pn = batch_paged_ppr(args, torch, g2, sg, src2, want_p,
                                        mode, card)
        out[mode] = {"ksssp": k, "ppr": p}
        cases += kc + pc
        lines += [kl, pl]
        by_mode[f"batch_{mode}"] = {key: kn[key] + pn[key] for key in kn}
    emit({"phase": "kernels", "kernel": "chunk_partials_batched",
          "path": "batch_paged", "cases": len(cases), "all_pass": True,
          "detail": cases})
    emit({"phase": "batch_paged", "nv": g2.nv, "ne": g2.ne, "B": BATCH_B,
          "sources_input_ids": sources, "sources_relabelled": src2,
          "graph_seconds": round(t_graph, 3), "vpad": sg.vpad,
          "lane_shuffle_launches": sum(c["lane_shuffle"]
                                       for c in by_mode.values()), **out,
          "kernels": [{k: ln[k] for k in ("name", "shape", "ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms", "launches")}
                      for ln in lines], "card": card})
    return lines, by_mode


# ---------------------------------------------------------------------
# run-time observability (ROADMAP A10a): the iteration counters, the
# phase split, the profiler ranges, span export and the flight recorder,
# and the memory trail, on the engines the earlier phases build

# what the observe phase gathers as the phases hand their engines over;
# printed at the end (phase_observe)
OBSERVE: dict = {}
OBS_PHASE_ITERS = 3          # timed_phases iterations a cell
OBS_ITERS = 10               # run_stats / profiler iterations

PULL_SPLIT = {"tiled": ["exchange", "gather", "reduce", "apply"],
              "paged": ["exchange", "gather_reduce", "apply"]}
PUSH_DENSE = ["frontier", "exchange", "relax", "reduce", "update"]


def _split_summary(report, step_ms: float) -> dict:
    """Per phase: ms of each iteration; the sum a split iteration
    takes; the plain step's ms beside them."""
    meta = ("frontier", "bucket", "advances")
    names = list(dict.fromkeys(k for t in report for k in t
                               if k not in meta))
    per = {k: [t[k] * 1e3 for t in report if k in t] for k in names}
    sums = [sum(v * 1e3 for k, v in t.items() if k not in meta)
            for t in report]
    return {"names": [list(t) for t in report], "phase_ms": per,
            "split_sum_ms": sums, "plain_step_ms": step_ms}


def observe_pull_split(torch, eng, name: str, kind: str = "tiled"):
    """timed_phases(state, 3): the reference's names in order, the state
    bit-equal to run(state, 3), each phase's ms beside the plain step's
    (CUDA events over 5 steps)."""
    init = eng.init_state()
    want = eng.run(init, OBS_PHASE_ITERS)
    state, report = eng.timed_phases(init, OBS_PHASE_ITERS)
    require(same_bits(state, want),
            f"observe {name}: timed_phases' state is not run's")
    require(all(list(t) == PULL_SPLIT[kind] for t in report),
            f"observe {name}: phases {[list(t) for t in report]} (want "
            f"{PULL_SPLIT[kind]} each iteration)")
    OBSERVE.setdefault("phases", {})[name] = _split_summary(
        report, cuda_ms(lambda: eng.step(init), 5))


def observe_push_split(torch, eng, name: str, iters: int):
    """timed_phases(label, active, iters) against converge(max_iters=
    iters): labels and active masks bit-equal; dense iterations split
    into the reference's phases, sparse ones one entry; the plain
    converge's ms an iteration beside them.  The sssp cell runs all its
    iterations: its first three may all be sparse."""
    l0, a0 = eng.init_state()
    wl, wa, it = eng.converge(l0, a0, max_iters=iters)
    lab, act, report = eng.timed_phases(l0, a0, iters)
    require(torch.equal(lab, wl) and torch.equal(act, wa),
            f"observe {name}: timed_phases' labels are not converge's")
    kinds = [list(t) for t in report]
    require(all(k in (PUSH_DENSE, ["frontier", "sparse"]) for k in kinds)
            and PUSH_DENSE in kinds,
            f"observe {name}: phases {kinds}")
    step = wall_ms(torch, lambda: eng.converge(l0, a0, max_iters=iters))
    out = _split_summary([{k: v for k, v in t.items()} for t in report],
                         step / max(it, 1))
    out["frontier"] = [t["frontier"] for t in report]
    OBSERVE.setdefault("phases", {})[name] = out


class OpCount:
    """Counts the aten operations dispatched inside the block (a
    TorchDispatchMode): ``ops`` all of them, ``compute`` those that are
    not views or metadata (an upper bound on the kernels launched)."""

    VIEWS = ("view", "_unsafe_view", "select", "slice", "reshape",
             "as_strided", "expand", "alias", "unsqueeze", "squeeze",
             "detach", "t", "permute", "_to_copy")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                outer.ops += 1
                if name not in OpCount.VIEWS:
                    outer.compute += 1
                return func(*args, **(kwargs or {}))

        self.ops = self.compute = 0
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def ops_per_iter(fn, iters: int) -> dict:
    with OpCount() as c:
        fn()
    return {"aten_ops": c.ops / iters, "non_view_ops": c.compute / iters}


def observe_counters_pull(args, torch, eng):
    """run_stats(state, 10) on the pairs cell: the state bit-equal to
    run's (``plain``), every counter row equal to _iter_counters of the
    states step gives one at a time, max and sum over parts equal to the
    scalars bitwise, zero host syncs before the fetch; its cost against
    run in turns and the ops it adds an iteration."""
    from lux_tpu_torch import telemetry
    n = OBS_ITERS
    init = eng.init_state()
    plain = eng.run(init, n)
    eng.run_stats(init, 1)                          # warm-up
    (state, rb, cb, rbp, cbp), counts, syncs = counted_sync_run(
        torch, lambda: eng.run_stats(init, n))
    require(same_bits(state, plain), "observe: run_stats' state is not "
                                     "run's")
    require(syncs == 0, f"observe: run_stats made {syncs} host syncs "
                        f"before the fetch (want 0)")
    from lux_tpu_torch.ops.pairs import stream_blocks
    per = 1 + (len(stream_blocks(eng.pairs.classes)) if eng.pair_stream
               else 1)
    require(counts == {"chunk_partials": per * n, "lane_shuffle": 0,
                       "chunk_partials_batched": 0},
            f"observe: run_stats launched {counts} (want run's: B1 "
            f"{per} an iteration)")
    s = init
    for i in range(n):
        new = eng.step(s)
        r, c, rp, cp = eng._iter_counters(new, s)
        require(same_bits(rb[i], r) and torch.equal(cb[i], c)
                and same_bits(rbp[i], rp) and torch.equal(cbp[i], cp),
                f"observe: run_stats' row {i} differs from the stepwise "
                f"counters")
        s = new
    require(same_bits(rbp[:n].amax(1), rb[:n])
            and torch.equal(cbp[:n].sum(1, dtype=torch.int32), cb[:n]),
            "observe: max / sum over parts differ from the scalars")
    st = telemetry.IterStats()
    st.extend_pull(rb, cb, n, rbp, cbp)
    ms = {"run": [], "run_stats": []}
    host = {"run": [], "run_stats": []}
    for kind in ("run", "run_stats", "run_stats", "run"):
        fn = (lambda: eng.run_stats(init, n)) if kind == "run_stats" \
            else (lambda: eng.run(init, n))
        ms[kind].append(cuda_ms(fn, 2) / n)
        host[kind].append(host_ms(torch, fn, 2) / n)
    ops = {k: ops_per_iter(fn, n) for k, fn in (
        ("run", lambda: eng.run(init, n)),
        ("run_stats", lambda: eng.run_stats(init, n)))}
    OBSERVE["run_stats"] = {
        "cell": "pairs (streamed)", "iters": n, "host_syncs": syncs,
        "launches": counts, "digest": st.summary(),
        "residual": st.residual, "changed": st.changed,
        "ms_per_iter": ms, "host_enqueue_ms_per_iter": host,
        "ops_per_iter": ops,
        "ops_added_per_iter": ops["run_stats"]["non_view_ops"]
        - ops["run"]["non_view_ops"]}


def observe_counters_push(args, torch, eng, label, it):
    """converge_stats on the sssp cell: every counter equal, bit for
    bit, to what the engine's own steps give one at a time (frontier:
    the active count after the step; out-edges: the out-degree sum of
    the frontier entering it; per part and their sums); the same host
    syncs as converge (one an iteration); the BFS level sizes beside
    the frontier (they differ where a sparse iteration's queue passes
    its edge budget: the unexpanded suffix stays active); its cost
    against converge in turns and the ops it adds an iteration."""
    from lux_tpu_torch.apps.sssp import HOP_INF
    l0, a0 = eng.init_state()
    (lab, _a, it2, fsz, fed, fszp, fedp), counts, syncs = counted_sync_run(
        torch, lambda: eng.converge_stats(l0, a0))
    _l, _a, _it, _c, plain_syncs, _sch = converge_counted(torch, eng)
    require(it2 == it and torch.equal(lab, label),
            f"observe sssp: converge_stats ran {it2} iterations (plain "
            f"{it}) or other labels")
    require(syncs == plain_syncs <= it,
            f"observe sssp: {syncs} host syncs (converge: {plain_syncs}, "
            f"iterations {it})")
    deg = eng.sg.deg_padded.astype(np.int64)           # [P, vpad]
    lab_s, act_s = eng.init_state()
    want_f, want_e, want_fp = [], [], []
    for _ in range(it):
        act_h = act_s.cpu().numpy()
        want_e.append(int((deg * act_h).sum()))
        lab_s, act_s, cnt = eng.step(lab_s, act_s)
        want_f.append(int(cnt))
        want_fp.append(act_s.sum(1, dtype=torch.int32).cpu().tolist())
    require(torch.equal(lab_s, label), "observe sssp: the stepwise labels "
                                       "are not converge's")
    got_f = fsz[:it].cpu().numpy().astype(np.int64).tolist()
    got_e = fed[:it].cpu().numpy().astype(np.int64).tolist()
    require(got_f == want_f and got_e == want_e
            and fszp[:it].cpu().tolist() == want_fp,
            f"observe sssp: counters frontier {got_f} edges {got_e} != "
            f"the stepwise {want_f} / {want_e}")
    require(torch.equal(fszp[:it].sum(1, dtype=torch.int32), fsz[:it])
            and torch.equal(fedp[:it].sum(1), fed[:it]),
            "observe sssp: per-part rows do not sum to the scalars")
    levels = eng.unpad(label)
    sizes = np.bincount(levels[levels < HOP_INF]).astype(np.int64)
    ms = {"converge": [], "converge_stats": []}
    for kind in ("converge", "converge_stats", "converge_stats",
                 "converge"):
        fn = (lambda: eng.converge_stats(l0, a0)) \
            if kind == "converge_stats" else (lambda: eng.converge(l0, a0))
        ms[kind].append(wall_ms(torch, fn) / it)
    ops = {"converge": ops_per_iter(lambda: eng.converge(l0, a0), it),
           "converge_stats": ops_per_iter(
               lambda: eng.converge_stats(l0, a0), it)}
    OBSERVE["converge_stats"] = {
        "cell": "sssp", "iterations": it2, "host_syncs": syncs,
        "frontier": got_f, "edges": got_e,
        "bfs_level_sizes": sizes.tolist(),
        "queue_cap": eng.queue_cap, "edge_budget": eng.edge_budget,
        "schedule": list(eng.schedule), "launches": counts,
        "ms_per_iter": ms, "ops_per_iter": ops,
        "ops_added_per_iter": ops["converge_stats"]["non_view_ops"]
        - ops["converge"]["non_view_ops"]}


def observe_profiler(args, torch, eng):
    """One profiling.trace session over 10 iterations of the pairs cell:
    the Chrome trace holds 10 lux_gather / lux_reduce / lux_apply /
    lux_exchange ranges; the pull engine's idle share from its device
    time (as converge_profile reckons it); the plain run's host enqueue
    an iteration with the ranges entered and without, in turns."""
    import tempfile

    from lux_tpu_torch import profiling
    n = OBS_ITERS
    init = eng.init_state()
    eng.run(init, 2)
    walls = sorted(wall_ms(torch, lambda: eng.run(init, n))
                   for _ in range(3))
    tmp = tempfile.mkdtemp(prefix="lux_smoke_trace_")
    with profiling.trace(tmp):
        t0 = time.perf_counter()
        eng.run(init, n)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(tmp, profiling.TRACE_FILE)
    evs = [e for e in json.load(open(path)).get("traceEvents", [])
           if e.get("ph") == "X"]
    # host ranges are "user_annotation"; the card's copy of a range
    # ("gpu_user_annotation") is not counted
    names = [e.get("name") for e in evs if e.get("cat") == "user_annotation"]
    ranges = {r: names.count(r) for r in (
        "lux_exchange", "lux_gather", "lux_reduce", "lux_apply",
        "lux_pagerank", "lux_gather_reduce")}
    for r in ("lux_exchange", "lux_gather", "lux_reduce", "lux_apply"):
        require(ranges[r] == n, f"observe: the trace holds {ranges[r]} "
                                f"{r} ranges (want {n})")
    # device time: the trace's kernels, copies and fills
    dev = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy",
                                              "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) \
            + e.get("dur", 0) / 1e3
    rows = sorted(([k, v] for k, v in by_name.items()),
                  key=lambda r: -r[1])
    trace_bytes = os.path.getsize(path)
    os.remove(path)
    os.rmdir(tmp)
    # record_function is a dispatcher op: enqueue with the ranges
    # entered (profiling.active forced on, no profiler) and without
    real = profiling.active
    enq = {"without": [], "with": []}
    for kind in ("without", "with", "with", "without"):
        profiling.active = (lambda: True) if kind == "with" else real
        try:
            enq[kind].append(host_ms(torch, lambda: eng.run(init, n), 2) / n)
        finally:
            profiling.active = real
    OBSERVE["profiler"] = {
        "cell": "pairs (streamed)", "iters": n, "ranges": ranges,
        "trace_bytes": trace_bytes, "device_ms": busy,
        "profiled_wall_ms": prof_wall, "plain_wall_ms": walls,
        "idle_share_profiled": 1 - busy / prof_wall if busy else None,
        "idle_share": 1 - busy / walls[1] if busy else None,
        "device_events": len(dev), "top": rows[:8],
        "host_enqueue_ms_per_iter": enq}


def observe_spans(args, torch, eng):
    """A supervised PageRank run of the pairs cell (segments of 2,
    checkpointed) under an EventLog and IterStats: its state bit-equal
    to the plain run, RunReport.counters the digest, trace_export then
    validate_trace -> []; then, under a flight recorder, the NaN fault
    of tests/test_tracing.py: FLIGHT.json written, read back with its
    reason and the last health word."""
    import tempfile

    from lux_tpu_torch import (faults, health, resilience, telemetry,
                               tracing)
    n = OBS_ITERS
    plain = eng.run(eng.init_state(), n)
    tmp = tempfile.mkdtemp(prefix="lux_smoke_spans_")
    ck = os.path.join(tmp, "pairs.npz")
    ev = telemetry.EventLog(os.path.join(tmp, "events.jsonl"))
    st = telemetry.IterStats()
    with telemetry.use(events=ev, iter_stats=st) as tel:
        tel.emit("run_start", schema=telemetry.SCHEMA, app="pagerank",
                 config="pairs")
        tel.emit("header", schema=telemetry.SCHEMA,
                 **eng.sg.telemetry_header())
        t0 = time.perf_counter()
        out, rep = resilience.supervised_run(eng, n, ck, segment=2)
        tel.emit("run_done", seconds=round(time.perf_counter() - t0, 6),
                 iters=n)
        tel.emit("iter_stats", **{("engine" if k == "kind" else k): v
                                  for k, v in st.summary().items()})
    ev.close()
    require(same_bits(out, plain), "observe: the supervised run is not "
                                   "bit-equal to the plain run")
    require(rep.counters == st.summary() and rep.counters["iters"] == n,
            f"observe: RunReport.counters {rep.counters}")
    events, errs = tracing.load_events(os.path.join(tmp, "events.jsonl"))
    trace = tracing.trace_export(events)
    verrs = tracing.validate_trace(trace)
    require(not errs and verrs == [],
            f"observe: the supervised run's trace: {errs + verrs}")
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    # the flight recorder on an injected NaN (guarded engine)
    flight = os.path.join(tmp, "FLIGHT.json")
    rec = tracing.install_flight_recorder(flight, capacity=64)
    plan = faults.FaultPlan(schedule={1: faults.NAN})
    eng.health = True
    try:
        with telemetry.use(events=telemetry.EventLog()):
            resilience.supervised_run(
                eng, n, ck, segment=2, faults=plan, guard=False,
                policy=resilience.RetryPolicy(retries=2,
                                              sleep=lambda s: None))
        raise SmokeFailure("observe: the NaN fault did not trip")
    except health.HealthError:
        pass
    finally:
        eng.health = False
        tracing.uninstall_flight_recorder()
    doc = tracing.load_flight(flight)
    require(rec.dumps == 1 and doc["classification"] == "fatal"
            and "HealthError" in doc["reason"]
            and doc["health"]["kind"] == "health_trip"
            and "nonfinite_state" in doc["health"]["flags"],
            f"observe: FLIGHT.json {doc.get('reason')} {doc.get('health')}")
    OBSERVE["spans"] = {
        "cell": "pairs (streamed)", "events": len(events),
        "kinds": ev.counts(), "trace_spans": len(spans),
        "validate_trace": verrs, "counters": rep.counters,
        "flight": {"reason": doc["reason"], "health": {
            k: doc["health"].get(k) for k in ("flags", "iteration", "part")},
            "ring": len(doc["events"]), "bytes": os.path.getsize(flight)}}
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)


def observe_ledger(torch, eng, name: str, run) -> None:
    """MemoryLedger.for_engine against the measured bytes: the
    allocator's peak over ``run()`` (torch.cuda.max_memory_allocated
    after reset_peak_memory_stats; everything the process holds then
    counts) and the engine's own argument bytes (engine_verdict).  A
    verdict outside MEM_TOL is printed and recorded, not raised."""
    from lux_tpu_torch import memwatch
    led = memwatch.MemoryLedger.for_engine(eng, name)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    OBSERVE.setdefault("ledger", {})[name] = {
        "terms": led.terms, "ledger_bytes": led.total_bytes,
        "argument_bytes": led.argument_bytes(),
        "allocated_before_run": before, "measured_peak_bytes": peak,
        "peak_verdict": memwatch.drift_verdict(
            peak, led.total_bytes, grade=memwatch.GRADE_MEASURED,
            where=name),
        "engine_verdict": memwatch.engine_verdict(eng, ledger=led)}


def observed(fn, *args, book=None):
    """Run one observe step, adding its wall seconds to the phase's
    (``book``: another phase's record, the pricing line's)."""
    t0 = time.perf_counter()
    out = fn(*args)
    secs = (OBSERVE if book is None else book).setdefault("seconds", {})
    secs[fn.__name__] = secs.get(fn.__name__, 0.0) + round(
        time.perf_counter() - t0, 3)
    return out


# the audit step's per-engine records: each phase that builds an engine
# audits it on the card after its own checks (audit_case), and
# phase_audit prints them with the lockcheck, analyzer and CLI runs
AUDITED = {}
AUDIT_ENGINES = ("main", "paged", "pagemajor", "pagerank-mp", "sssp-mp",
                 "owner_paged", "owner_pagemajor",
                 "pairs_monolithic", "pairs_streamed", "sssp", "cc",
                 "colfilter", "ksssp_batch", "ppr_batch", "live_delta")
# the engines whose audited paths launch no hand kernel: the dot path,
# and the live graph's delta-relax step (one gather and a scatter)
AUDIT_NO_KERNEL = ("colfilter", "live_delta")
CLI_SCALE = 12          # the CLI flags' R-MAT .lux (edge factor 8)


def audit_case(torch, eng, name: str, only=None) -> None:
    """lux_tpu_torch.audit over ``eng`` on the card: mode "error" with
    the ledger (one iteration of each registered variant, or of
    ``only``, on a fresh init state), its launches left out of the
    phases' counts.  Records the variants, the state-table gathers of
    the dense step (or of the one variant), the host syncs and the hand
    kernel launches each variant's iteration made, and memwatch's ledger
    over one step's measured peak."""
    from lux_tpu_torch import audit, memwatch
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    t0 = time.perf_counter()
    by_e = dict(chunk_partials.launches_by_e)
    with Uncounted():
        # the smoke runs no other thread: torch's process-wide sync
        # debug mode may watch the step variants
        traces = audit.run_variants(eng, only, sync_debug=True)
        findings = audit.audit_engine(eng, mode="error", ledger=True,
                                      traces=traces)
        led = audit.ledger_report(eng)
        gathers = audit.table_gathers(eng, traces,
                                      None if only is None else only[0])
    chunk_partials.launches_by_e = by_e
    torch.cuda.synchronize()
    launches = {v: tr.kernel_launches for v, tr in traces.items()}
    dense = only[0] if only else (
        "step_dense" if "step_dense" in traces else "step")
    if name in AUDIT_NO_KERNEL:
        require(sum(launches.values()) == 0,
                f"audit {name}: its path launched hand kernels {launches}")
    else:
        require(launches[dense] > 0,
                f"audit {name}: the dense step launched no hand kernel "
                f"on the card {launches}")
    require(gathers == (0 if eng.exchange == "owner" else 1),
            f"audit {name}: {gathers} state-table gathers")
    AUDITED[name] = {
        "variants": sorted(traces), "table_gathers": gathers,
        "host_syncs": {v: len(tr.host_reads) for v, tr in traces.items()},
        "kernel_launches": launches,
        "ledger_bytes": led["ledger_bytes"],
        "measured_bytes": led["measured_bytes"],
        "argument_bytes": led["argument_bytes"],
        "temp_terms": {k: v for k, v in memwatch.MemoryLedger.for_engine(
            eng).terms.items() if k in memwatch.TEMP_TERMS},
        "ledger_over_peak": led["ledger_bytes"] / max(1, led[
            "measured_bytes"]),
        "warnings": [str(f) for f in findings],
        "seconds": round(time.perf_counter() - t0, 3)}


def corrupt_degrees(src: str, dst: str) -> None:
    """A copy of a .lux file with its last out-degree changed: it loads,
    and fails format.validate_graph's degree check."""
    raw = bytearray(open(src, "rb").read())
    raw[-4:] = (int.from_bytes(raw[-4:], "little") + 7).to_bytes(4,
                                                                 "little")
    with open(dst, "wb") as f:
        f.write(bytes(raw))


def cli_run(argv) -> dict:
    """lux_tpu_torch.cli.main in this process, its output captured ->
    {"rc", "out": its last lines, "err": stderr's last line}."""
    import contextlib
    import io

    from lux_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return {"argv": list(argv), "rc": rc,
            "out": out.getvalue().strip().splitlines()[-4:],
            "err": (err.getvalue().strip().splitlines() or [""])[-1]}


def phase_audit(args, torch, card) -> None:
    """The audit step (ROADMAP A12b, A12c, A12a's CLI half): every engine
    the phases audited (AUDITED, each mode "error" with the ledger), the
    reference's engine matrix on the card (its owner paged
    configurations included), the port's lockcheck over its threaded
    modules, ``python -m lux_tpu_torch.lint``, GCC's analyzer over the
    five native units on this host, and the CLI's -validate (a sound
    file, and a corrupted copy that must exit 2 with its typed
    GraphFormatError), -audit error, -tol / -max-iters and -sparse on
    an R-MAT CLI_SCALE .lux, on the card."""
    import tempfile

    from lux_tpu_torch import lockcheck, native
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.format import GraphFormatError, write_lux
    from lux_tpu_torch.graph import Graph
    from lux_tpu_torch import audit
    t0 = time.perf_counter()
    require(sorted(AUDITED) == sorted(AUDIT_ENGINES),
            f"audit: engines audited {sorted(AUDITED)}, want "
            f"{sorted(AUDIT_ENGINES)}")
    # the reference's engine matrix on the card (its ops are the card's:
    # the hand kernels, not their plain versions)
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    by_e = dict(chunk_partials.launches_by_e)
    with Uncounted():
        found = audit.run_repo_audit(device="cuda", sync_debug=True)
    torch.cuda.synchronize()
    chunk_partials.launches_by_e = by_e
    errors = [str(f) for f in found if f.severity == "error"]
    require(not errors, f"audit: the matrix on the card: {errors[:4]}")
    labels = [lb for lb, _b, _l in audit.matrix_configs(device="cuda")]
    require({"pagerank_np4_owner_paged", "pagerank_np4_owner_pagemajor"}
            <= set(labels), "audit: the matrix lacks the owner paged "
                            "configurations")
    matrix = {"configs": len(labels), "errors": 0,
              "warnings": [str(f) for f in found if f.severity == "warn"],
              "seconds": round(time.perf_counter() - t0, 3)}
    lockcheck.run_lockcheck(mode="error")
    # the port's lint over its tree and documents: ``python -m
    # lux_tpu_torch.lint`` run in this process (runpy, as -m runs it;
    # a second interpreter's torch import took 9-11 s of the step)
    t1 = time.perf_counter()
    lint_out, lint_err = io.StringIO(), io.StringIO()
    argv, sys.argv = sys.argv, ["lux_tpu_torch.lint"]
    try:
        with contextlib.redirect_stdout(lint_out), \
                contextlib.redirect_stderr(lint_err):
            runpy.run_module("lux_tpu_torch.lint", run_name="__main__",
                             alter_sys=True)
        lint_rc = 0
    except SystemExit as e:
        lint_rc = e.code
    finally:
        sys.argv = argv
    require(lint_rc == 0 and lint_out.getvalue().strip() == "lint: clean",
            f"audit: python -m lux_tpu_torch.lint exited {lint_rc}: "
            f"{lint_err.getvalue()[-2000:]}")
    lint_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    units = native.analyze()
    analyzer_s = time.perf_counter() - t1
    cxx = subprocess.run([native.compiler(), "--version"],
                         capture_output=True, text=True).stdout
    cxx = (cxx.splitlines() or [""])[0]
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        src, dst, nv = rmat_edges(CLI_SCALE, 8, seed=args.seed)
        g = Graph.from_edges(src, dst, nv)
        f, bad = os.path.join(d, "g.lux"), os.path.join(d, "bad.lux")
        write_lux(f, g.row_ptrs, g.col_idx, None, g.out_degrees)
        corrupt_degrees(f, bad)
        try:
            Graph.from_file(bad, validate=True)
            typed = None
        except GraphFormatError as e:
            typed = f"{type(e).__name__}: {e}"
        require(typed is not None and "degree" in typed,
                f"audit: the corrupted copy passed validate_graph ({typed})")
        for name, argv, rc in (
                ("validate_audit", ["pagerank", "-file", f, "-ni", "5",
                                    "-validate", "-audit", "error",
                                    "-check"], 0),
                ("validate_corrupt", ["pagerank", "-file", bad, "-ni", "1",
                                      "-validate"], 2),
                ("tol", ["pagerank", "-file", f, "-tol", "1e-7",
                         "-max-iters", "500", "-check"], 0),
                ("sparse_0", ["sssp", "-file", f, "-sparse", "0",
                              "-audit", "error", "-check"], 0),
                ("sparse_1", ["sssp", "-file", f, "-sparse", "1",
                              "-check"], 0)):
            runs[name] = cli_run(argv)
            require(runs[name]["rc"] == rc,
                    f"audit: cli {' '.join(argv)} exited "
                    f"{runs[name]['rc']} (want {rc}): "
                    f"{runs[name]['err']} {runs[name]['out']}")
    require("degree" in runs["validate_corrupt"]["err"],
            f"audit: -validate on the corrupted copy said "
            f"{runs['validate_corrupt']['err']!r}")

    def iters(run):
        import re
        m = re.search(r"\((\d+) iterations", " ".join(run["out"]))
        return int(m.group(1)) if m else None

    require(iters(runs["tol"]) is not None and iters(runs["tol"]) < 500,
            f"audit: -tol ran {iters(runs['tol'])} iterations")
    require(iters(runs["sparse_0"]) == iters(runs["sparse_1"]),
            f"audit: -sparse 0 / 1 ran {iters(runs['sparse_0'])} / "
            f"{iters(runs['sparse_1'])} iterations")
    emit({"phase": "audit", "engines": AUDITED,
          "engine_audit_seconds": round(sum(
              a["seconds"] for a in AUDITED.values()), 3),
          "matrix": matrix,
          "lockcheck": {"modules": len(lockcheck.default_paths()),
                        "findings": 0},
          "lint": {"rc": lint_rc, "out": lint_out.getvalue().strip(),
                   "seconds": round(lint_s, 3)},
          "analyzer": {"units": {k: round(v, 3) for k, v in units.items()},
                       "seconds": round(analyzer_s, 3), "compiler": cxx,
                       "flags": " ".join(native.ANALYZE_FLAGS)},
          "cli": {"scale": CLI_SCALE, "ne": g.ne, "typed_error": typed,
                  "tol_iterations": iters(runs["tol"]),
                  "sparse_iterations": iters(runs["sparse_0"]),
                  "runs": runs},
          "seconds": round(time.perf_counter() - t0, 3), "card": card})


def phase_observe(card) -> None:
    """Print what the observe steps gathered, one line each, then the
    seconds each step took (the phase's share of the smoke)."""
    for key in ("run_stats", "converge_stats", "phases", "profiler",
                "spans", "ledger", "trail"):
        require(key in OBSERVE, f"observe: no {key} record")
        emit({"phase": "observe", "what": key, key: OBSERVE[key],
              "card": card})
    secs = OBSERVE.get("seconds", {})
    emit({"phase": "observe", "what": "seconds", "seconds": secs,
          "total_s": round(sum(secs.values()), 3), "card": card})


# -- pricing (ROADMAP A10b) and the matrix-unit forms (A8) -----------

# what the phases measured that the pricing line derives the card's
# constants from, and what it prints
PRICED = {}
PRICING = {"decompose": {}, "gather_auto": {}, "seconds": {}}
MXU = {}

# the gather sweep's state tables (MB) and ids (R-MAT 21's edges)
GATHER_TABLE_MB = (8, 16, 32, 64, 128, 256)
GATHER_SWEEP_IDS = 1 << 25
# fills the min_fill sweep adds beside bench.py's 24 and the resolved
# one: none (its two other pair engines, 12 and 48, took ~30 s of the
# smoke's time limit; PERF.md keeps their figures)
MIN_FILL_SWEEP = ()


def priced(fn, *args):
    """Run one pricing step, adding its wall seconds to the line's."""
    return observed(fn, *args, book=PRICING)


def pricing_calibrate(torch):
    """observe.calibrate() on the card: the fingerprint and its grade,
    which must be canonical on the constants' own card."""
    from lux_tpu_torch import observe, scalemodel
    fp = observe.calibrate()
    PRICING["fingerprint"] = fp.digest()
    PRICING["canonical_figures"] = fp.canonical
    name = torch.cuda.get_device_name(0)
    if name == scalemodel.H100.card:
        require(fp.grade == "canonical",
                f"pricing: the session graded {fp.grade} (deviation "
                f"{fp.deviation:.3f}) on {name}")
    return fp


def pricing_decompose(torch, eng, name: str, iters: int = 3):
    """observe.decompose on an engine at its cell's size over ``iters``
    iterations (a push cell: its whole converge, dense and sparse): each
    phase's measured ms beside the model and its verdict, and the share
    of the split the verdicts cover (the modeled phases' medians over
    all)."""
    from lux_tpu_torch import observe
    d = observe.decompose(eng, name, iters=iters,
                          fingerprint=observe.calibrate())
    total = sum(p.median_s for p in d.phases)
    covered = sum(p.median_s for p in d.phases if p.predicted_s)
    PRICING["decompose"][name] = {
        "ne": d.ne, "nv": d.nv, "scale": d.scale,
        "phases": [{"phase": p.phase, "median_ms": p.median_s * 1e3,
                    "mad_ms": p.mad_s * 1e3,
                    "model_ms": None if p.predicted_s is None
                    else p.predicted_s * 1e3,
                    "ratio": p.ratio, "verdict": p.verdict}
                   for p in d.phases],
        "modeled_share": covered / total if total else None}
    return d


def gather_table_sweep(args, torch) -> dict:
    """index_select of GATHER_SWEEP_IDS random ids from float32 state
    tables of GATHER_TABLE_MB: ns an edge at each size; the small rate
    (the smallest table), the big rate (the largest), and the step
    between them (the largest table still under 1.5x the small rate;
    past the sweep when every one is)."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}
    for mb in GATHER_TABLE_MB:
        n = mb * (1 << 20) // 4
        table = torch.rand(n, generator=gen, device="cuda")
        idx = torch.randint(0, n, (GATHER_SWEEP_IDS,), generator=gen,
                            device="cuda")
        ms = cuda_ms(lambda: torch.index_select(table, 0, idx), args.reps)
        out[mb] = ms * 1e6 / GATHER_SWEEP_IDS
        del table, idx
    torch.cuda.empty_cache()
    small = out[GATHER_TABLE_MB[0]]
    step = next((mb for mb in GATHER_TABLE_MB if out[mb] > 1.5 * small),
                None)
    big = out[GATHER_TABLE_MB[-1]]
    prev = GATHER_TABLE_MB[GATHER_TABLE_MB.index(step) - 1] if step else None
    PRICED["gather_sweep"] = {
        "ns_per_edge_by_table_mb": out, "step_mb": step,
        "big_table_bytes": (GATHER_TABLE_MB[-1] if step is None
                            else prev) * (1 << 20),
        "gather_small_ns": small, "gather_big_ns": big}
    return out


def pricing_gather_auto(args, torch, g2, sg, label: str, steps: dict):
    """gather="auto" through pagerank.build_engine on a cell's graph and
    layout: the resolved mode beside the steps (ms) the smoke measured
    there for each mode; it must be the fastest of them."""
    from lux_tpu_torch.apps import pagerank
    t0 = time.perf_counter()
    eng = pagerank.build_engine(g2, sg=sg, gather="auto")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    best = min(steps, key=steps.get)
    PRICING["gather_auto"][label] = {
        "resolved": eng.gather, "measured_step_ms": steps,
        "fastest": best, "build_seconds": round(secs, 3)}
    require(eng.gather == best,
            f"gather='auto' on {label} resolved {eng.gather}, but the "
            f"smoke measured {steps} ms")
    del eng
    torch.cuda.empty_cache()


def pricing_min_fill(args, torch, g2, starts):
    """pair_min_fill="auto" on bench.py's pagerank config beside a sweep
    of at most two fills (24 and the resolved one; MIN_FILL_SWEEP adds
    none now): each
    a monolithic pair engine's step ms and rows.  At 24 (bench.py's
    fill) the pair delivery and the residual path are timed whole, the
    pair_row_ns / residual_edge_ns figures, and the engine is
    decomposed (the pairs cell)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    auto = resolve_min_fill("auto")
    fills = sorted({auto, PAIR_MIN_FILL, *MIN_FILL_SWEEP})
    rows = {}
    for f in fills:
        t0 = time.perf_counter()
        eng = pagerank.build_engine(
            g2, 1, pair_threshold=PAIR_THRESHOLD, starts=starts,
            pair_min_fill="auto" if f == auto else f, pair_stream=False)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        sp = eng.pairs
        state = eng.init_state()
        flat = state.reshape(-1)
        rec = {"fill": f, "auto": f == auto,
               "step_ms": cuda_ms(lambda: eng.step(state), args.reps),
               "pair_rows": eng.num_parts * sp.Rp, "real_rows": sp.R,
               "coverage": sp.stats["coverage"],
               "residual_chunks": eng.tiles.n_chunks,
               "setup_seconds": round(setup, 3)}
        if f == PAIR_MIN_FILL:
            rec["pair_delivery_ms"] = cuda_ms(lambda: eng._pair_red(flat),
                                              args.reps)
            rec["residual_ms"] = cuda_ms(
                lambda: eng._reduce(eng._messages(flat)), args.reps)
            rec["ne"] = int(sp.stats["ne"])
            PRICED["pairs_monolithic"] = rec
            pricing_decompose(torch, eng, "pairs_monolithic")
        rows[f] = rec
        del eng, state, flat
        torch.cuda.empty_cache()
    best = min(rows.values(), key=lambda r: r["step_ms"])
    PRICING["min_fill"] = {
        "resolved": auto, "sweep": list(rows.values()),
        "best_fill": best["fill"],
        "resolved_over_best": rows[auto]["step_ms"] / best["step_ms"]}


# S9 against its plain version on the main path's chunks: rtol 1e-5,
# atol this fraction of the largest plain partial
S9_ATOL_OF_MAX = 1e-6


def mxu_s9_line(args, torch, msgs, rel8, W, launches: int) -> dict:
    """Kernel S9 on the main path's own chunks: against its plain
    version, its times, bound and library time (the probes' S9 entry's
    measures), with the main path's launches under use_mxu=True."""
    from lux_tpu_torch.ops.chunk_reduce import KernelInputError
    from lux_tpu_torch.ops.onehot_reduce import (MMA_OPS, mma_count,
                                                 onehot_reduce,
                                                 onehot_reduce_plain)
    dev = msgs.device
    rel = rel8.to(torch.int32)
    C, E = msgs.shape
    got = onehot_reduce(msgs, rel, W)
    want = onehot_reduce_plain(msgs, rel, W)
    err = float((got - want).abs().max())
    # scaled to the data: PageRank's messages are (1/nv)/deg, about
    # 5e-7 at R-MAT 21, so a fixed atol would pass a kernel writing
    # zeros; S9's three bf16 parts keep float32's accuracy
    scale = float(want.abs().max())
    require(scale > 0 and torch.allclose(got, want, rtol=1e-5,
                                         atol=S9_ATOL_OF_MAX * scale),
            f"S9 on the main path's chunks: max abs err {err} against "
            f"max |plain| {scale} (rtol 1e-5, atol {S9_ATOL_OF_MAX} of "
            f"max |plain|)")
    # no fallback on the card: a lane dtype S9 does not take raises
    try:
        onehot_reduce(msgs, rel8, W)
        raised = False
    except KernelInputError:
        raised = True
    require(raised, "S9 took int8 lanes on the card without raising")
    lane = torch.where((rel >= 0) & (rel < W), rel, W).long()
    flat_idx = (torch.arange(C, device=dev)[:, None] * (W + 1)
                + lane).reshape(-1)
    base = torch.zeros(C * (W + 1), device=dev)
    flat_vals = msgs.reshape(-1)
    mmas = mma_count(rel, W)
    n_bytes = C * (8 * E + 4 * W)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = mmas * MMA_OPS / BF16_TC_OPS_PER_S * 1e3
    line = {"name": "onehot_reduce@main_mxu", "route": "cuda",
            "source": "lux_tpu_torch/csrc/onehot_mma.cu",
            "replaces": "scripts/profile_kernel.py:123",
            "launches": launches, "shape": [C, E, W], "max_abs_err": err,
            "max_abs_plain": scale, "err_of_max": err / scale,
            "ms": cuda_ms(lambda: onehot_reduce(msgs, rel, W), args.reps),
            "plain_ms": cuda_ms(lambda: onehot_reduce_plain(msgs, rel, W),
                                args.reps),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": mmas * MMA_OPS,
            "library_ms": cuda_ms(
                lambda: base.scatter_add(0, flat_idx, flat_vals),
                args.reps),
            "launches_by_path": {"main_mxu": launches},
            "raises_on_int8_lanes": raised}
    PRICED["s9"] = {"ms": line["ms"], "rows": C * E / 128}
    return line


def combine_times(args, eng, partials, wide: int) -> dict:
    """combine_chunks on an engine's own partials, the doubling and the
    scan as matmuls (use_mxu), each timed whole: the combine figures of
    scalemodel."""
    from lux_tpu_torch import scalemodel
    from lux_tpu_torch.ops.tiled import combine_chunks
    a = eng.arrays

    def run(um):
        return combine_chunks(partials, eng.tiles, a["chunk_start"],
                              a["last_chunk"], "sum", eng._plan, um)
    max_len = eng._plan.max_len
    return {"doubling_ms": cuda_ms(lambda: run(False), args.reps),
            "matmul_ms": cuda_ms(lambda: run(True), args.reps),
            "chunks": int(partials.shape[0]), "W": eng.tiles.W,
            "wide": wide, "max_len": max_len,
            "passes": scalemodel.combine_passes(max_len)}


def mxu_model(eng) -> dict:
    """Each side's tiled reduce as scalemodel prices it on the engine's
    own layout (the prices use_mxu="auto" compared), in ms."""
    from lux_tpu_torch import scalemodel
    from lux_tpu_torch.engine.pull import mxu_wide_of
    p, t = eng.program, eng.tiles
    layout = scalemodel.ReduceLayout(eng.num_parts * t.n_chunks, t.E, t.W,
                                     eng._plan.max_len)
    kw = dict(kind=p.reduce, wide=mxu_wide_of(p),
              scalar_f32=eng.scalar_f32_sum,
              dot=p.edge_value_from_dot is not None)
    return {"layout": layout._asdict(),
            "mxu_ms": scalemodel.reduce_ns(True, layout, **kw) * 1e-6,
            "plain_ms": scalemodel.reduce_ns(False, layout, **kw) * 1e-6}


def mxu_main(args, torch, g, eng):
    """use_mxu=True on the main path (R-MAT 21 PageRank): kernel S9
    launched once an iteration, B1 never; within rtol 2e-5 of the B1
    path's ranks and MAIN_TOL of the float64 oracle; each side's step
    ms; what "auto" resolved to.  Returns S9's kernels-line entry."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.onehot_reduce import onehot_reduce
    got_b1, want = PRICED.pop("main_answer")
    em = pagerank.build_engine(g, use_mxu=True)
    require(em.use_mxu, "use_mxu=True did not engage")
    state, secs, counts, _peak, _h = timed_run(torch, em, args.iters)
    s9 = onehot_reduce.launches
    require(s9 == args.iters * em.num_parts
            and counts["chunk_partials"] == 0,
            f"main mxu: S9 launched {s9}, B1 {counts['chunk_partials']} "
            f"times in {args.iters} iterations (want S9 one an iteration, "
            f"B1 none)")
    got = em.unpad(state)
    vs_b1 = float(np.max(np.abs(got - got_b1) / np.maximum(
        np.abs(got_b1), 1e-30)))
    require(np.allclose(got, got_b1, rtol=2e-5, atol=1e-9),
            f"main mxu: {vs_b1:.3e} from the B1 path (rtol 2e-5)")
    vs_oracle = float(np.max(np.abs(got - want) / np.maximum(
        np.abs(want), 1e-30)))
    require(np.allclose(got, want, **MAIN_TOL),
            f"main mxu: {vs_oracle:.3e} from the float64 oracle")
    st = em.init_state()
    t = em.tiles
    msgs = em._messages(st.reshape(-1)).reshape(-1, t.E)
    rel8 = em.arrays["rel_dst"].reshape(-1, t.E)
    MXU["main"] = {
        "shape": [em.num_parts * t.n_chunks, t.E, t.W],
        "s9_launches": s9, "iters": args.iters,
        "mxu_step_ms": cuda_ms(lambda: em.step(st), args.reps),
        "b1_step_ms": cuda_ms(lambda: eng.step(st), args.reps),
        "ms_per_iter": secs * 1e3 / args.iters,
        "max_rel_err_vs_b1": vs_b1, "max_rel_err_vs_oracle": vs_oracle,
        "auto_resolved": eng.use_mxu, "model": mxu_model(eng)}
    MXU["main"]["auto_is_faster"] = eng.use_mxu is (
        MXU["main"]["mxu_step_ms"] < MXU["main"]["b1_step_ms"])
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    PRICED["combine_main"] = combine_times(
        args, eng, chunk_partials(msgs, rel8, t.W, "sum"), 1)
    line = mxu_s9_line(args, torch, msgs.contiguous(), rel8.contiguous(),
                       t.W, s9)
    del em, st, msgs
    torch.cuda.empty_cache()
    return line


def mxu_ppr(args, torch, g, sources, eng, got_b1, want):
    """use_mxu=True on ppr_batch: the one-hot sum (torch.bmm over
    [C, E, 8] in full float32) in place of B1's batched form; within
    rtol 5e-5 of the B1 path and of the float64 oracle; the one-hot
    sum's ms at the path's own messages, eight columns and one (the
    onehot_tile_ns / mxu_tile_ns figures)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.tiled import chunk_partials_mxu
    em = pagerank.build_engine(g, 1, sources=sources, use_mxu=True)
    state, secs, counts, _p, _h = timed_run(torch, em, PPR_ITERS)
    require(batched_launches() == 0 and counts["chunk_partials"] == 0,
            "ppr mxu: a B1 form launched under use_mxu=True")
    got = em.unpad(state)
    for what, ref, tol in (("the B1 path", got_b1, dict(rtol=5e-5,
                                                         atol=1e-9)),
                           ("the float64 oracle", want, MAIN_TOL)):
        require(np.allclose(got, ref, **tol),
                f"ppr mxu: disagrees with {what}")
    st = em.init_state()
    t = em.tiles
    msgs = em._messages(st.reshape(-1, st.shape[-1])).reshape(
        -1, t.E, st.shape[-1]).contiguous()
    rel8 = em.arrays["rel_dst"].reshape(-1, t.E)
    onehot_ms = cuda_ms(lambda: chunk_partials_mxu(msgs, rel8, t.W, "sum"),
                        max(3, args.reps // 4))
    one = msgs[..., :1].contiguous()
    onehot_1_ms = cuda_ms(lambda: chunk_partials_mxu(one, rel8, t.W, "sum"),
                          max(3, args.reps // 4))
    del one
    PRICED["onehot_sum"] = {"ms_b8": onehot_ms, "ms_b1": onehot_1_ms,
                            "rows": msgs.shape[0] * t.E / 128}
    MXU["ppr_batch"] = {
        "B": st.shape[-1], "iters": PPR_ITERS,
        "mxu_step_ms": cuda_ms(lambda: em.step(st), max(3, args.reps // 4)),
        "b1_step_ms": cuda_ms(lambda: eng.step(st), args.reps),
        "onehot_sum_ms": onehot_ms, "onehot_sum_one_column_ms": onehot_1_ms,
        "max_rel_err_vs_b1": float(np.max(np.abs(got - got_b1) / np.maximum(
            np.abs(got_b1), 1e-30))),
        "auto_resolved": eng.use_mxu}
    del em, st, msgs
    torch.cuda.empty_cache()


def mxu_colfilter(args, torch, eng, build):
    """use_mxu=True against use_mxu=False on colfilter's pairs
    (monolithic) cell, ``eng`` (built "auto") one of the two: the
    residual's segmented combine as matmuls; within rtol 1e-5 of the
    plain run."""
    em = eng if eng.use_mxu else build(True)
    ev = build(False) if eng.use_mxu else eng
    state, secs, _c, _p, _h = timed_run(torch, em, args.iters)
    got = em.unpad(state)
    ref = ev.unpad(ev.run(ev.init_state(), args.iters))
    require(np.allclose(got, ref, rtol=1e-5, atol=1e-8),
            "colfilter mxu: disagrees with the plain run (rtol 1e-5)")
    st = em.init_state()
    case = {
        "mxu_step_ms": cuda_ms(lambda: em.step(st), max(3, args.reps // 4)),
        "b1_step_ms": cuda_ms(lambda: ev.step(st), max(3, args.reps // 4)),
        "max_abs_diff": float(np.max(np.abs(got - ref))),
        "auto_resolved": eng.use_mxu, "model": mxu_model(eng)}
    case["auto_is_faster"] = eng.use_mxu is (case["mxu_step_ms"]
                                             < case["b1_step_ms"])
    MXU["colfilter"] = case
    del em, ev, st
    torch.cuda.empty_cache()


def mxu_push(torch, name: str, eng, em, label, it):
    """use_mxu=True on a push cell (the tournament for the dense min /
    max, the cumsum as matmuls for the sparse expansion): labels and
    iterations bit-equal to the plain converge's; each converge's
    wall ms."""
    lm, _am, itm = em.converge(*em.init_state())
    require(itm == it and torch.equal(lm, label),
            f"{name} mxu: labels or iterations ({itm} vs {it}) differ from "
            f"use_mxu=False")
    MXU[name] = {"iterations": it, "labels_bit_equal": True,
                 "mxu_converge_ms": wall_ms(
                     torch, lambda: em.converge(*em.init_state())),
                 "b1_converge_ms": wall_ms(
                     torch, lambda: eng.converge(*eng.init_state())),
                 "auto_resolved": eng.use_mxu}


def cf_pricing(args, torch, eng, build):
    """On colfilter's pairs (monolithic) cell: the pair rows' dot
    delivery and the residual's dot blocks and combine, each timed
    whole (the per-K figures), the cell decomposed, and the mxu case
    (``build(use_mxu)`` builds the engine)."""
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.ops.tiled import combine_partials
    a = eng.arrays
    state = eng.init_state()
    flat = state.reshape(eng.num_parts * eng.vpad, -1)
    PRICED["colfilter_pairs_monolithic"] = {
        "pair_ms": cuda_ms(lambda: eng._pair_dot_red(flat), args.reps),
        "pair_rows": eng.num_parts * eng.pairs.Rp,
        "residual_ms": cuda_ms(lambda: combine_partials(
            eng.dot_chunk_partials(state), eng.tiles, a["chunk_start"],
            a["last_chunk"], eng.vpad, "sum", eng._plan), args.reps),
        "residual_edges": int(eng.sg.ne), "K": colfilter.K}
    del flat
    PRICED["combine_colfilter"] = combine_times(
        args, eng, eng.dot_chunk_partials(state), colfilter.K)
    pricing_decompose(torch, eng, "colfilter")
    mxu_colfilter(args, torch, eng, build)


def card_constants() -> dict:
    """The card's figures from what the phases measured (PRICED), each
    as scalemodel.H100_SOURCES names it."""
    P = PRICED
    gs = P["gather_sweep"]
    pm = P["pairs_monolithic"]
    pair_row = pm["pair_delivery_ms"] * 1e6 / pm["pair_rows"]
    residual = pm["residual_ms"] * 1e6 / (pm["ne"] * (1 - pm["coverage"]))
    pg = P["paged"]
    fetch_rows = pg["P"] * (pg["n_pages"] + pg["Rg"])
    F = pg["layers"]["page_fetch_ms"] * 1e6 / fetch_rows
    paged_row = (pg["delivery_ms"] * 1e6 - pg["unique_pages"] * F) / (
        pg["P"] * pg["Rp"])
    pmj = P["pagemajor"]
    lay = pmj["layers"]
    vrow = (lay["vrow_take_ms"] + lay["chunk_partials_ms"]
            + lay["class_combine_ms"]) * 1e6 / (pmj["P"] * pmj["Rp"]) - F
    cf = P["colfilter_pairs_monolithic"]
    pair_k = (cf["pair_ms"] * 1e6 / cf["pair_rows"] - pair_row) / cf["K"]
    res_k = (cf["residual_ms"] * 1e6 / cf["residual_edges"]
             - residual) / cf["K"]
    cp = P["colfilter_paged"]
    paged_k = ((cp["delivery_ms"] * 1e6 - cp["unique_pages"] * F)
               / cp["rows"] - paged_row) / cp["K"]
    mn = P["main"]
    vpu = mn["chunk_partials_ms"] * 1e6 / (mn["chunks"] * mn["E"] / 128)
    oh = P["onehot_sum"]
    b1 = oh["ms_b1"] * 1e6 / oh["rows"]
    mxu_tile = (oh["ms_b8"] * 1e6 / oh["rows"] - b1) / 7
    wb = P["gather_by_width"]
    lane = (wb["B8"]["gather_rows_ms"] - wb["B1"]["gather_rows_ms"]) \
        * 1e6 / 7 / wb["rows"]
    apply_ms = next(p["median_ms"] for p in
                    PRICING["decompose"]["main"]["phases"]
                    if p["phase"] == "apply")
    s9 = P["s9"]
    cm, cc = P["combine_main"], P["combine_colfilter"]
    passes = [r["chunks"] * r["W"] * r["wide"] * r["passes"]
              for r in (cm, cc)]
    scan = [r["matmul_ms"] * 1e6 / (r["chunks"] * r["W"]) for r in (cm, cc)]
    scan_slice = (scan[1] - scan[0]) / (cc["wide"] - cm["wide"])
    fp = PRICING["fingerprint"]["probe"]
    return {
        "gather_small_ns": gs["gather_small_ns"],
        "gather_big_ns": gs["gather_big_ns"],
        "big_table_bytes": float(gs["big_table_bytes"]),
        "pair_row_ns": pair_row, "pair_dot_row_k_ns": pair_k,
        "residual_edge_ns": residual, "residual_dot_k_ns": res_k,
        "page_row_fetch_ns": F,
        "lane_shuffle_ns": pg["layers"]["lane_shuffle_ms"] * 1e6 / (
            pg["P"] * pg["Rg"] * 128),
        "paged_row_ns": paged_row, "paged_dot_row_k_ns": paged_k,
        "vrow_reduce_ns": vrow, "vpu_row_ns": vpu,
        "onehot_tile_ns": b1 - mxu_tile, "mxu_tile_ns": mxu_tile,
        "batch_lane_ns": lane,
        "state_ns_per_vertex": apply_ms * 1e6 / mn["padded_vertices"],
        "probe_gather_ns": fp["gather_small_ns"],
        "probe_pair_dot_row_ns": fp["pair_dot_row_ns"],
        "probe_page_row_ns": fp["page_gather_row_ns"],
        "s9_row_ns": s9["ms"] * 1e6 / s9["rows"],
        "combine_pass_ns": (cm["doubling_ms"] + cc["doubling_ms"]) * 1e6
        / sum(passes),
        "segscan_lane_ns": scan[0] - scan_slice * cm["wide"],
        "segscan_slice_ns": scan_slice,
        "owner_slot_ns": P["owner"]["ms"] * 1e6 / P["owner"]["slots"],
        "route_bytes_per_s": P["route"]["bytes"] / (P["route"]["ms"]
                                                    * 1e-3)}


def phase_pricing(card) -> None:
    """Print the pricing line: the fingerprint, the card's constants as
    measured here beside the package's table, the decompositions, the
    min_fill sweep, gather="auto" on its two graphs, the memory ratios
    and the seconds each step took."""
    import dataclasses

    from lux_tpu_torch import memwatch, scalemodel
    measured = card_constants()
    baked = dataclasses.asdict(scalemodel.H100)
    emit({"phase": "pricing", "what": "calibration",
          "fingerprint": PRICING["fingerprint"],
          "canonical_figures": PRICING["canonical_figures"], "card": card})
    emit({"phase": "pricing", "what": "constants", "measured": measured,
          "table": baked,
          "measured_over_table": {k: measured[k] / baked[k]
                                  if baked[k] else None for k in measured},
          "sources": scalemodel.H100_SOURCES,
          "gather_sweep": PRICED["gather_sweep"],
          "combine": {k: PRICED[f"combine_{k}"]
                      for k in ("main", "colfilter")}, "card": card})
    emit({"phase": "pricing", "what": "decompose",
          "decompose": PRICING["decompose"], "card": card})
    emit({"phase": "pricing", "what": "min_fill",
          "min_fill": PRICING["min_fill"], "card": card})
    emit({"phase": "pricing", "what": "gather_auto",
          "gather_auto": PRICING["gather_auto"], "card": card})
    mem = {}
    for name, rec in OBSERVE.get("ledger", {}).items():
        v = rec["peak_verdict"]
        mem[name] = {"ratio": v["ratio"], "errors": v["errors"],
                     "tol": memwatch.MEM_TOL, "ledger_bytes": v[
                         "ledger_bytes"], "peak_bytes": v["peak_bytes"],
                     "port_terms": {k: t for k, t in rec["terms"].items()
                                    if k.startswith("port_")}}
    tr = OBSERVE.get("trail")
    if tr is not None:
        mem["serve"] = {"ratio": tr["verdict"]["ratio"],
                        "errors": tr["verdict"]["errors"],
                        "tol": memwatch.MEM_TOL,
                        "ledger_bytes": tr["server_ledger_bytes"],
                        "peak_bytes": tr["peak_bytes"]}
    emit({"phase": "pricing", "what": "memory", "memory": mem,
          "card": card})
    secs = PRICING["seconds"]
    emit({"phase": "pricing", "what": "seconds", "seconds": secs,
          "total_s": round(sum(secs.values()), 3), "card": card})


def phase_mxu(card) -> None:
    """Print the mxu line: use_mxu=True against use_mxu=False on the
    main, ppr_batch, colfilter, sssp and cc cells."""
    for key in ("main", "ppr_batch", "colfilter", "sssp", "cc"):
        require(key in MXU, f"mxu: no {key} case")
    emit({"phase": "mxu", "cases": MXU, "card": card})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False — the smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lux_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    from lux_tpu_torch.apps import pagerank
    card = phase_env(torch)
    phase_build()
    priced(pricing_calibrate, torch)
    priced(gather_table_sweep, args, torch)
    g, eng = phase_graph(args, torch)
    kline = phase_kernels(args, torch, eng)
    kline["launches"] = phase_main(args, torch, g, eng, card)
    phase_layers(args, torch, eng)
    audit_case(torch, eng, "main")
    observed(observe_pull_split, torch, eng, "main")
    priced(pricing_decompose, torch, eng, "main")
    main_eng = eng          # the mxu case holds its B1 twin to it
    del eng
    torch.cuda.empty_cache()
    g2, perm2, sg = phase_paged_graph(args, torch, g)
    want = pagerank.reference_pagerank(g2, args.iters)
    by_path = {"main": {"chunk_partials": kline["launches"],
                        "lane_shuffle": 0}}
    lines, b1_lines = {}, {}
    for mode in ("paged", "pagemajor"):
        by_path[mode], lines[mode], b1_lines[mode] = phase_paged(
            args, torch, g2, sg, mode, want, card)
    priced(pricing_gather_auto, args, torch, g2, sg, "rmat_paged_cell",
           {"flat": PRICED["main"]["step_ms"],
            **{m: PRICED[m]["layers"]["step_ms"]
               for m in ("paged", "pagemajor")}})
    del sg
    # the owner exchange's paged plans on the same graph with 4 parts
    # (the owner phase's owner_paged step)
    owner_paged_lines, owner_paged_paths = phase_owner_paged(
        args, torch, g, g2, perm2, want, card)
    by_path.update(owner_paged_paths)
    del g2, perm2, want
    b2 = lines["paged"]                 # B2 at the paged path's own rows
    reorder_counts, reorder_b1, reorder_b2 = phase_reorder(args, torch, card)
    by_path.update(reorder_counts)
    b1_lines.update(reorder_b1)
    phase_parts(args, torch)
    # bench.py's pagerank-mp and sssp-mp on the owner exchange, the
    # exchange sweep (the main engine is its 1-part gather side) and the
    # streamed forms
    owner_lines, owner_paths = phase_owner(args, torch, g, main_eng, card)
    for path, n in owner_paths.items():
        by_path[path] = {k: n[k] for k in ("chunk_partials", "lane_shuffle")}
    g2, perm, starts, relabel = pair_relabelled(g)
    pair_counts, kpairs, case = phase_pairs(args, torch, g2, starts,
                                            relabel, card)
    # the guarded and observe cases run on each engine as its phase
    # returns it
    guarded = {"pagerank": guarded_pull(args, torch, *case)}
    pair_eng = case[0]
    del case
    torch.cuda.empty_cache()
    priced(pricing_min_fill, args, torch, g2, starts)
    # the probes before the push phases and the pairs engine's observe
    # steps: its torch.profiler count of S7 must be the process's first
    # profiler session (a later session can see a part of the device
    # events); in the one run that had the probes before the pairs
    # phase, that phase's host enqueue doubled (PERF.md §6, PR 15)
    probe_lines = phase_probes(args, torch, g, card)
    # the first system path of kernel S9, after the probes' check that
    # no system path launched a probe kernel
    s9_line = priced(mxu_main, args, torch, g, main_eng)
    del main_eng
    torch.cuda.empty_cache()
    observed(observe_counters_pull, args, torch, pair_eng)
    observed(observe_profiler, args, torch, pair_eng)
    observed(observe_spans, args, torch, pair_eng)
    observed(observe_ledger, torch, pair_eng, "pairs_streamed",
             lambda: pair_eng.run(pair_eng.init_state(), args.iters))
    del pair_eng
    torch.cuda.empty_cache()
    push_counts = {}
    b1_lines["sssp"], push_counts["sssp"], case = phase_sssp(
        args, torch, g, g2, perm, starts, card)
    guarded["sssp"] = guarded_push(torch, *case)
    observed(observe_counters_push, args, torch, case[0], case[1], case[2])
    observed(observe_push_split, torch, case[0], "sssp", case[2])
    del g, g2, perm, starts, case
    torch.cuda.empty_cache()
    b1_lines["cc"], push_counts["cc"] = phase_cc(args, torch, card)
    # the colfilter paths launch no hand kernel (chip_smoke checks 0)
    for path, n in phase_colfilter(args, torch, card).items():
        by_path[path] = n
    batch_lines, batch_paths, batch_ref, case = phase_batch(args, torch,
                                                            card)
    guarded["ksssp_batch"] = guarded_batch(torch, *case)
    observed(observe_ledger, torch, case[0], "ksssp_batch",
             lambda: case[0].converge(*case[0].init_state()))
    del case
    torch.cuda.empty_cache()
    paged_lines, paged_paths = phase_batch_paged(args, torch, *batch_ref,
                                                 card)
    batch_lines += paged_lines
    live_counts = phase_live(args, torch, batch_ref[0], card)
    fleet_counts, fleet_lines = phase_fleet(args, torch, batch_ref[0], card)
    del batch_ref
    for path, n in {**batch_paths, **paged_paths, "live": live_counts,
                    "fleet": fleet_counts}.items():
        by_path[path] = {k: n[k] for k in ("chunk_partials", "lane_shuffle")}
    batch_lines += fleet_lines
    for line in batch_lines:    # B1's batched form on the live and fleet
        line.setdefault("launches_by_path", {}).update(      # paths
            live=live_counts["chunk_partials_batched"],
            fleet=fleet_counts["chunk_partials_batched"])
    phase_guarded(torch, guarded, card)
    phase_audit(args, torch, card)
    phase_observe(card)
    phase_pricing(card)
    phase_mxu(card)
    by_path["pairs"] = pair_counts["streamed"]
    by_path["pairs_monolithic"] = pair_counts["monolithic"]
    for path, n in push_counts.items():
        by_path[path] = {"chunk_partials": n, "lane_shuffle": 0}
    kline["launches_by_path"] = {k: v["chunk_partials"]
                                 for k, v in by_path.items()}
    # B1 at each row path's own rows, with that path's launches
    b1_lines["pairs"] = kpairs
    for path, line in b1_lines.items():
        line["launches"] = by_path[path]["chunk_partials"]
        line["launches_by_path"] = kline["launches_by_path"]
    b2["launches"] = by_path["paged"]["lane_shuffle"]
    b2["launches_by_path"] = {k: v["lane_shuffle"]
                              for k, v in by_path.items()}
    for path, line in reorder_b2.items():   # B2 at each reorder side's rows
        line["launches"] = by_path[path]["lane_shuffle"]
        line["launches_by_path"] = b2["launches_by_path"]
    for line in probe_lines:           # B2 at S1's shape: its system paths
        if line["name"].startswith("lane_shuffle@"):
            del line["launches_by_path"]["system paths"]
            line["launches_by_path"].update(b2["launches_by_path"])
    for line in probe_lines:           # S9's system path beside its probe
        if line["name"] == "onehot_reduce":
            line["launches_by_path"]["system paths"] = s9_line["launches"]
    for line in owner_lines:           # B1 at the owner shapes
        line["launches_by_path"] = kline["launches_by_path"]
    for line in owner_paged_lines:     # B2 and B1 at the owner paged rows
        line["launches_by_path"] = (
            b2["launches_by_path"] if line["name"].startswith(
                "lane_shuffle") else kline["launches_by_path"])
    emit({"kernels": [kline, *b1_lines.values(), *owner_lines,
                      *owner_paged_lines,
                      *batch_lines, b2, *reorder_b2.values(), *probe_lines,
                      s9_line]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
