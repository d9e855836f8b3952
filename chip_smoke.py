#!/usr/bin/env python3
"""Quickest proof that the PyTorch / H100 port starts on the card.

    python3 chip_smoke.py                    # every phase, one card

Phases, each printing one JSON line:

1. env      torch / CUDA versions, the card's name and power limit
            (also printed raw, as nvidia-smi gives them);
2. build    every kernel built from lux_tpu_torch/csrc (B1
            chunk_partials and its batched form chunk_partials_batched,
            B2 lane_shuffle, and the probe kernels S7
            carry, S8 fused_carry, S9 onehot_reduce, S3/S12
            transposed_reduce, S2/S11 sub_gather, S4/S5 elementwise, S6
            block_rowsum: every entry of _kernels.KERNELS), one nvcc per
            source started together, build seconds;
3. graph    the main path's graph: R-MAT scale 21, edge factor 16
            (2,097,152 vertices, 33,554,432 edges), made from --seed,
            and its PageRank engine on the card;
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
9. parts    R-MAT scale 18 with 4 parts on one card and a chunk width
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
            colfilter (R-MAT 18, ef 16, weighted) with 4 parts tiled (E
            128), flat, pair rows monolithic and streamed and paged,
            each within rtol 1e-5 of the float64 oracle with no hand
            kernel launched, and page-major refused with the
            reference's ValueError;
10. pairs   bench.py's pagerank config on the main graph: pair_relabel,
            pair_threshold 16, min_fill 24, tile_e 128, through
            pagerank.build_engine once with each pair_stream setting
            (streamed, the default, then monolithic), 10 iterations
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
            and how many its __match_any_sync path;
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
            same bytes, not the same function);
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
13. cc      bench.py's cc config: R-MAT one scale under --scale,
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
            oracle, three runs bit-equal, B1 and B2 launched 0 times,
            both audits at 0 (RMSE does not rise), the reduce from a
            state in {-1, 0, 1} bit-equal to the int64 oracle; times,
            GTEPS, host enqueue, peak memory, set-up seconds, per-layer
            device ms (fetch, D, lane select, messages, one-hot reduce,
            combine_chunks, class combine, apply), device launches an
            iteration (torch.profiler) and the step at the default
            blocks (1 GB of D a block) against the reference's;
15. batch   kernel B1's batched form (csrc/chunk_partials_batched.cu,
            [C, E, B] -> [C, W, B]) against its plain version on
            synthetic shapes (B in {1, 3, 8, 64}, sorted and unsorted
            rows, E % 4 != 0, C = 0, unaligned bases, lanes outside
            [0, W), int32 extremes, NaN for min/max; f32 sums within
            E * 2^-23 * max|v|, the rest bit-equal; three launches
            bit-equal; a strided view refused); then bench.py's
            ksssp-batch@8 and ppr-batch@8 (bench.py:941-976) uncut: R-MAT
            one scale under --scale (20), --ef, --seed, one part, no
            relabel, B = 8 sources from default_rng(7); ksssp through
            sssp.build_engine(sources=...) to convergence, every
            iteration dense, labels bit-equal to the numpy batched
            oracle and two columns to single-source scalar runs, B1's
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
            p50 / p99 latency, per-kind iterations and segments.

The last line is {"ok": true, "device": {...}}.  Any failure raises
and the script exits non-zero without that line; so does a machine
without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
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
          "count": torch.cuda.device_count(), "nvidia_smi": card})
    return card


def phase_build():
    from lux_tpu_torch import _kernels
    t0 = time.perf_counter()
    rep = _kernels.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": {k: {"seconds": round(v["seconds"], 3),
                          "ptxas": [ln.strip() for ln in
                                    v["ptxas"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for k, v in rep.items()}})


def phase_graph(args, torch):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph
    t0 = time.perf_counter()
    src, dst, nv = rmat_edges(args.scale, args.ef, seed=args.seed)
    g = Graph.from_edges(src, dst, nv)
    del src, dst
    t_graph = time.perf_counter() - t0
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
    Operations: one combine per live entry."""
    C, E = vals.shape
    live = (rel >= 0) & (rel.to(torch.int16) < W)
    ops = int(live.sum())
    per = 32 // vals.element_size()          # entries in a 32 B sector
    flat = live.reshape(-1)
    pad = -flat.numel() % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    sectors = int(flat.view(-1, per).any(dim=1).sum())
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
    got = chunk_partials(vals, rel, W, kind)
    want = chunk_partials_plain(vals, rel, W, kind)
    max_abs_err = float((got.double() - want.double()).abs().max())
    del got, want
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
    chunk_partials.launches = 0
    chunk_partials_batched.launches = 0
    lane_shuffle.launches = 0


def batched_launches() -> int:
    """B1's batched form's launch count (read_launches keeps the two
    keys the single-query phases compare)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched
    return chunk_partials_batched.launches


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
    return g2, sg


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


def paged_layers(args, torch, eng):
    """Device ms of each layer of one paged iteration, each timed
    alone on the engine's own arrays."""
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

    rows = fetch()
    vals = lane_shuffle(rows, sl)
    reps = args.reps
    out = {"page_fetch_ms": cuda_ms(fetch, reps),
           "lane_shuffle_ms": cuda_ms(lambda: lane_shuffle(rows, sl), reps)}
    vrs = a.get("pg_vrs")
    if vrs is not None:
        vidx = (vrs.long() + torch.arange(P, device=flat.device)[:, None]
                * sl.shape[0] // P).reshape(-1)
        out["vrow_take_ms"] = cuda_ms(
            lambda: torch.index_select(vals, 0, vidx), reps)
        vals = torch.index_select(vals, 0, vidx)
    rel = a["pg_rel"].reshape(-1, W)
    partials = chunk_partials(vals, rel, W, "sum")
    out["chunk_partials_ms"] = cuda_ms(
        lambda: chunk_partials(vals, rel, W, "sum"), reps)
    # byte bounds at these shapes: B2 reads rows and slot_lane and
    # writes out (12 B a lane); B1 as b1_bound counts it
    out["lane_shuffle_bound_ms"] = sl.numel() * 12 / HBM_BYTES_PER_S * 1e3
    out["chunk_partials_bound_ms"] = b1_bound(torch, vals, rel,
                                              W)["bound_ms"]
    part3 = partials.view(P, pp.Rp, W)[:, :pp.R]
    out["class_combine_ms"] = cuda_ms(
        lambda: class_combine(pp, part3, a["pg_tp"], "sum"), reps)
    red = class_combine(pp, part3, a["pg_tp"], "sum").reshape(P, -1)
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
    del eng, state, rows, sl
    torch.cuda.empty_cache()
    b1 = check_b1_rows(args, torch, b1_vals, b1_rel, mode)
    del b1_vals, b1_rel
    torch.cuda.empty_cache()
    return counts, line, b1


def phase_parts(args, torch):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, degree_relabel, pair_relabel
    from lux_tpu_torch.ops.pairs import stream_blocks
    src, dst, nv = rmat_edges(18, 16, seed=args.seed + 1)
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
    push = parts_push(args, torch, g)
    cf = parts_colfilter(args, torch)
    emit({"phase": "parts", "nv": g.nv, "ne": g.ne, "num_parts": 4,
          "tile_e": 128, "chunks": eng.num_parts * eng.tiles.n_chunks,
          "iters": args.iters, "max_rel_err": float(rel_err.max()),
          "chunk_partials_launches": launches, "paged": paged,
          "pairs": pairs, "push": push, "colfilter": cf})


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
    one part -> (relabelled graph, perm, starts, seconds)."""
    from lux_tpu_torch.graph import pair_relabel
    t0 = time.perf_counter()
    g2, perm, starts = pair_relabel(g, 1, pair_threshold=PAIR_THRESHOLD)
    return g2, perm, starts, time.perf_counter() - t0


def phase_pairs(args, torch, g2, starts, t_relabel, card):
    """bench.py's pagerank config (bench.py:987-1011) on the main graph
    ``g2`` (pair_relabelled, with its cut points ``starts``), once with
    each pair_stream setting; returns (launches by setting, the
    kernels-line entry of B1 on the pair rows)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.pairs import stream_blocks
    want = pagerank.reference_pagerank(g2, args.iters)
    counts_by, b1 = {}, None
    for stream in (True, False):
        label = "streamed" if stream else "monolithic"
        t0 = time.perf_counter()
        eng = pagerank.build_engine(g2, 1, pair_threshold=PAIR_THRESHOLD,
                                    pair_min_fill=PAIR_MIN_FILL,
                                    starts=starts, pair_stream=stream)
        torch.cuda.synchronize()
        t_engine = time.perf_counter() - t0
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
              "relabel_seconds": round(t_relabel, 3),
              "pair_plan_seconds": round(eng.plan_seconds, 3),
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
        if stream:
            # B1's own checks and timing at the pair rows, once (both
            # settings deliver the same rows), before the monolithic
            # engine is built so that nothing held here counts in its
            # peak memory
            b1 = check_pair_rows(args, torch, eng, vals, rel)
        del eng, state, vals, rel
        torch.cuda.empty_cache()
    return counts_by, b1


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


def relabelled_id(perm, v: int) -> int:
    """The new id of input vertex ``v`` under ``perm`` (perm[new] =
    old)."""
    return int(np.flatnonzero(np.asarray(perm) == v)[0])


def bfs_levels(g, start: int) -> np.ndarray:
    """Level-synchronous BFS over the edge list -> int32 hop counts,
    HOP_INF where unreached: the hop SSSP's exact fixed point."""
    from lux_tpu_torch.apps.sssp import HOP_INF
    src, dst = g.edge_arrays()
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
    chunks (or the paged rows) plus once a pair block; B2 once on the
    paged paths."""
    from lux_tpu_torch.ops.pairs import stream_blocks
    if eng.page_plan is not None:
        return {"chunk_partials": 1, "lane_shuffle": 1}
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
    Returns (the kernels-line entry, B1 launches of the counted run)."""
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
    return line, counts["chunk_partials"]


def phase_sssp(args, torch, g, g2, perm, starts, card):
    """bench.py's sssp config (bench.py:1034-1077) on the main graph:
    pair_relabel (threshold 16), min_fill 24, hops, no delta, sparse
    iterations on, one part, started at the relabelled id of the
    smallest input id with an out-edge (first_out_vertex)."""
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
    line, launches = run_push_config(args, torch, eng, g2, want, "sssp",
                                     card, extra)
    del eng
    torch.cuda.empty_cache()
    return line, launches


def phase_cc(args, torch, card):
    """bench.py's cc config (bench.py:1038-1053): R-MAT one scale under
    --scale (20 by default, as bench.py's cc runs one under its sssp),
    --ef, --seed, symmetrized, pair_relabel (threshold 16), min_fill 24,
    one part; labels held to scipy's components (each one's largest
    relabelled id)."""
    from lux_tpu_torch.apps import components
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, pair_relabel
    t0 = time.perf_counter()
    scale = args.scale - 1
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
    line, launches = run_push_config(args, torch, eng, g2, want, "cc",
                                     card, extra)
    del eng, g2
    torch.cuda.empty_cache()
    return line, launches


def parts_push(args, torch, g) -> dict:
    """The push engine on the parts phase's graph ``g`` with 4 parts on
    one card: hop SSSP, weighted SSSP with delta="auto" (weights drawn as
    bench.py:198-200 draws them) and components on the symmetrized
    graph, each over a tiled layout that needs the segmented combine,
    degree-relabelled paged and page-major delivery, and pair_relabel'd
    pair rows streamed and monolithic; labels bit-equal to the oracle,
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
            "pairs_streamed": (gp, perm_p, ShardedGraph.build(
                gp, P, starts=starts_p, pair_threshold=16),
                dict(pair_threshold=16, pair_min_fill=24)),
            "pairs_monolithic": (gp, perm_p, ShardedGraph.build(
                gp, P, starts=starts_p, pair_threshold=16),
                dict(pair_threshold=16, pair_min_fill=24,
                     pair_stream=False))}
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
    zeroed once, when it is allocated)."""
    from torch.profiler import ProfilerActivity, profile

    from lux_tpu_torch.ops.carry import carry_combine
    carry_combine(part, start)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            carry_combine(part, start)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum("carry_kernel" in n for n in names)
    memsets = sum("memset" in n.lower() for n in names)
    require(kernels == 10 and memsets == 0 and len(names) == 10,
            f"carry profile: {kernels} carry kernels, {memsets} memsets "
            f"among {len(names)} device events over 10 calls (want 10, 0, "
            f"10)")
    return {"case": "carry/profile_10_calls", "shape": list(part.shape),
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
    blocks), then combine_chunks, the class combine, the pair merge and
    apply; the whole step, its host enqueue and its device launches
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
        out["combine_chunks_ms"] = cuda_ms(lambda: combine_partials(
            partials, eng.tiles, a["chunk_start"], a["last_chunk"],
            eng.vpad, "sum", eng._plan), reps)
        red = combine_partials(partials, eng.tiles, a["chunk_start"],
                               a["last_chunk"], eng.vpad, "sum", eng._plan)
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
    t0 = time.perf_counter()
    g = weighted_rmat(CF_SCALE, CF_EF, args.seed)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = colfilter.reference_colfilter(g, args.iters).astype(np.float32)
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
    del eng, sg
    torch.cuda.empty_cache()
    return counts


def parts_colfilter(args, torch) -> dict:
    """ColFilter at R-MAT 18, ef 16, seed --seed + 1, weighted, 4 parts:
    tiled E 128, flat, pair rows monolithic and streamed, paged; each
    against the float64 oracle at CF_TOL with no hand kernel launched;
    page-major must raise the reference's ValueError."""
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.graph import pair_relabel
    g = weighted_rmat(18, 16, args.seed + 1)
    want = colfilter.reference_colfilter(g, args.iters)
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


def _lane_abs_sums(torch, vals, rel, W):
    """S[c, w, b]: the sum of |vals[c, e, b]| over the entries with
    rel[c, e] == w, in float64."""
    C, E, B = vals.shape
    lane = rel.long()
    lane = torch.where((lane >= 0) & (lane < W), lane, W)
    idx = (torch.arange(C, device=vals.device)[:, None] * (W + 1) + lane)
    out = torch.zeros((C * (W + 1), B), dtype=torch.float64,
                      device=vals.device)
    out.scatter_add_(0, idx.reshape(-1, 1).expand(C * E, B),
                     vals.double().abs().reshape(C * E, B))
    return out.view(C, W + 1, B)[:, :W]


def _check_batched_case(torch, name, vals, rel, W, kind, plain_on=None):
    """B1's batched form against its plain version (on ``plain_on``,
    default the inputs' device): f32 sums element by element within E *
    2^-23 * S[c, w, b], S the sum of |v| over the same lane in float64
    (the kernel folds each lane in ascending e, the
    plain scatter in another order; each order's error is under half
    that), everything else bit-equal."""
    from lux_tpu_torch.ops.chunk_reduce import (
        chunk_partials_batched, chunk_partials_batched_plain)
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
        E = vals.shape[1]
        mag = _lane_abs_sums(torch, vals, rel, W)
        diff = (got.double() - want.double()).abs()
        bound = E * 2.0 ** -23 * mag
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
    design splits on: B in {1, 3, 8, 64} (the 16 B path where B % 4 ==
    0, scalar loads else), sorted tiled-like rows with pads at the
    tail, unsorted rows (the read-modify-write path), E in {1, 3, 33,
    130} (E % 4 != 0), all-pad and empty-lane chunks, lanes outside [0,
    W), unaligned value and lane bases, C = 0, int32 at INT32_MIN /
    INT32_MAX and wrapping sums, NaN values for min and max; three
    launches bit-equal; a strided view refused."""
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
    v = values(C, 512, 8, torch.float32)
    cases.append(check_batched_deterministic(torch, "B8_sorted_sum", v,
                                             lanes(C, 512, True), W, "sum"))
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
    operations = one combine per live value, at the f32 rate."""
    C, E, B = vals.shape
    live = int(((rel >= 0) & (rel.to(torch.int16) < W)).sum())
    isz = vals.element_size()
    bytes_moved = C * E + live * B * isz + C * W * B * isz
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = live * B / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "live_entries": live,
            # every value read, pads included
            "all_values_bytes": C * E * B * isz + C * E + C * W * B * isz}


def ppr_oracle(g, resets, iters: int) -> np.ndarray:
    """float64 personalized PageRank with the semantics of
    apps/pagerank.reference_pagerank_batched (the same update, the
    same degree normalization), each iteration's in-edge sums one
    scipy sparse product for every column (duplicate edges add, as
    the numpy oracle's bincount does): seconds where the numpy oracle
    takes a minute at R-MAT 20."""
    from scipy.sparse import csr_matrix
    from lux_tpu_torch.apps.pagerank import ALPHA
    src, dst = g.edge_arrays()
    a = csr_matrix((np.ones(src.size), (dst, src)), shape=(g.nv, g.nv))
    resets = np.asarray(resets, dtype=np.float64)
    deg = g.out_degrees.astype(np.float64)[:, None]
    state = np.where(deg > 0, resets / np.maximum(deg, 1), resets)
    for _ in range(iters):
        pr = (1.0 - ALPHA) * resets + ALPHA * (a @ state)
        state = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
    return state


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
    max_abs_err = float((got.double() - want.double()).abs().max())
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
    labels bit-equal to the port's numpy batched oracle
    (sssp.reference_sssp_batched) and, for the two columns reaching the
    most vertices, to single-source runs of the scalar engine; B1's
    batched form launched once an iteration, the scalar B1 and B2
    never; at most one host sync an iteration."""
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
    want = sssp.reference_sssp_batched(g, sources)
    t_oracle = time.perf_counter() - t0
    require(np.array_equal(got.astype(np.int64), want),
            f"ksssp_batch: labels differ from the numpy batched oracle at "
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
          "oracle": "sssp.reference_sssp_batched (numpy) + 2 scalar runs",
          "oracle_seconds": round(t_oracle, 3), "single_source": single,
          "card": card})
    cases = [_check_batched_case(torch, "ksssp_batch_own/min", vals, rel,
                                 eng.tiles.W, "min"),
             check_batched_deterministic(torch, "ksssp_batch_own", vals, rel,
                                         eng.tiles.W, "min")]
    line = b1_batched_line(args, torch, vals, rel, eng.tiles.W,
                           "chunk_partials_batched@ksssp_batch", "min")
    line["note"] = ("int32 compare-selects counted at the f32 rate (the "
                    "data sheet gives no int32 rate); bytes bound it")
    del eng, vals, rel
    torch.cuda.empty_cache()
    return line, counts["chunk_partials_batched"], cases


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
    del eng, vals, rel
    torch.cuda.empty_cache()
    return line, counts["chunk_partials_batched"], cases


def serve_stream(g, seed: int):
    """SERVE_QUERIES queries, a third of each kind, in a seeded order
    with seeded sources."""
    rng = np.random.default_rng(seed + 1)
    kinds = np.repeat(np.array(["sssp", "components", "pagerank"]),
                      SERVE_QUERIES // 3)
    kinds = kinds[rng.permutation(kinds.size)]
    return [(str(k), int(rng.integers(0, g.nv))) for k in kinds]


def serve_check(g, responses):
    """Every answer against its oracle: hop counts and seeded
    components from a numpy BFS per source (bfs_levels: the component
    of a seed is what it reaches), PageRank from the float64 batched
    oracle (ppr_oracle) at the query's own iterations (rtol 5e-5,
    atol 1e-9)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.apps.sssp import HOP_INF
    levels, worst = {}, 0.0
    for r in responses:
        require(r.converged, f"serve: query {r.qid} retired unconverged")
        if r.kind in ("sssp", "components"):
            if r.source not in levels:
                levels[r.source] = bfs_levels(g, r.source)
            lv = levels[r.source]
            want = lv if r.kind == "sssp" else \
                np.where(lv < HOP_INF, r.source, -1).astype(np.int32)
            require(r.answer.dtype == np.int32
                    and np.array_equal(r.answer, want),
                    f"serve: {r.kind} query {r.qid} from {r.source} differs "
                    f"from the oracle")
        else:
            want = ppr_oracle(g, pagerank.one_hot_resets(g.nv, [r.source]),
                              r.iters)[:, 0]
            require(np.allclose(r.answer, want, **MAIN_TOL),
                    f"serve: pagerank query {r.qid} differs from the "
                    f"float64 oracle")
            worst = max(worst, float((np.abs(r.answer - want) / np.maximum(
                np.abs(want), 1e-30)).max()))
    return worst


def phase_serve(args, torch, g, card):
    """The Server on the batch phases' graph: batch 8, seg_iters 2,
    deadline 0, bench.py's SLO targets; a warm-up query of each kind
    builds the three engines, then SERVE_QUERIES mixed queries drain
    through continuous-batching refill with every launch count at 0
    just before; every answer against its oracle, at least one boundary
    that retired and refilled columns, serve_retired_total = 36, B1's
    batched form launched, nothing else."""
    from lux_tpu_torch import metrics, serve, telemetry
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
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with telemetry.use(events=ev):
        responses = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    worst = serve_check(g, responses)
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
    return counts["chunk_partials_batched"]


def phase_batch(args, torch, card):
    """The batch phases: B1's batched form against its plain version on
    synthetic shapes, then ksssp-batch@8, ppr-batch@8 and the Server on
    one R-MAT 20 graph.  Returns (kernels-line entries, launches by
    path)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = b1_batched_cases(torch, gen, dev)
    g, sources, t_graph = batch_graph(args)
    emit({"phase": "batch_graph", "nv": g.nv, "ne": g.ne,
          "scale": args.scale - 1, "edge_factor": args.ef, "seed": args.seed,
          "B": BATCH_B, "sources": sources,
          "graph_seconds": round(t_graph, 3)})
    kline, n_k, own_k = phase_ksssp_batch(args, torch, g, sources, card)
    pline, n_p, own_p = phase_ppr_batch(args, torch, g, sources, card)
    cases += own_k + own_p
    emit({"phase": "kernels", "kernel": "chunk_partials_batched",
          "cases": len(cases), "all_pass": True, "detail": cases})
    n_s = phase_serve(args, torch, g, card)
    by_path = {"ksssp_batch": n_k, "ppr_batch": n_p, "serve": n_s}
    for line, n in ((kline, n_k), (pline, n_p)):
        line["launches"] = n
        line["launches_by_path"] = by_path
    return [pline, kline], by_path


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
    g, eng = phase_graph(args, torch)
    kline = phase_kernels(args, torch, eng)
    kline["launches"] = phase_main(args, torch, g, eng, card)
    phase_layers(args, torch, eng)
    del eng
    torch.cuda.empty_cache()
    g2, sg = phase_paged_graph(args, torch, g)
    want = pagerank.reference_pagerank(g2, args.iters)
    by_path = {"main": {"chunk_partials": kline["launches"],
                        "lane_shuffle": 0}}
    lines, b1_lines = {}, {}
    for mode in ("paged", "pagemajor"):
        by_path[mode], lines[mode], b1_lines[mode] = phase_paged(
            args, torch, g2, sg, mode, want, card)
    del g2, sg, want
    b2 = lines["paged"]                 # B2 at the paged path's own rows
    phase_parts(args, torch)
    g2, perm, starts, t_relabel = pair_relabelled(g)
    pair_counts, kpairs = phase_pairs(args, torch, g2, starts, t_relabel,
                                      card)
    # the probes before the push phases: its torch.profiler count of S7
    # must be the process's first profiler session (a later session can
    # see a part of the device events)
    probe_lines = phase_probes(args, torch, g, card)
    push_counts = {}
    b1_lines["sssp"], push_counts["sssp"] = phase_sssp(
        args, torch, g, g2, perm, starts, card)
    del g, g2, perm, starts
    b1_lines["cc"], push_counts["cc"] = phase_cc(args, torch, card)
    # the colfilter paths launch no hand kernel (chip_smoke checks 0)
    for path, n in phase_colfilter(args, torch, card).items():
        by_path[path] = n
    batch_lines, batch_paths = phase_batch(args, torch, card)
    for path in batch_paths:            # the scalar B1 and B2: none
        by_path[path] = {"chunk_partials": 0, "lane_shuffle": 0}
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
    for line in probe_lines:           # B2 at S1's shape: its system paths
        if line["name"].startswith("lane_shuffle@"):
            del line["launches_by_path"]["system paths"]
            line["launches_by_path"].update(b2["launches_by_path"])
    emit({"kernels": [kline, *b1_lines.values(), *batch_lines, b2,
                      *probe_lines]})
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
