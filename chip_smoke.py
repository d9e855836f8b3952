#!/usr/bin/env python3
"""Quickest proof that the PyTorch / H100 port starts on the card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. env      torch / CUDA versions, the card's name and power limit
            (also printed raw, as nvidia-smi gives them);
2. build    every kernel built from lux_tpu_torch/csrc (B1
            chunk_partials, B2 lane_shuffle, and the probe kernels S7
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
            monolithic), against the oracle;
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
            same bytes, not the same function).

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


def check_deterministic(torch, name, vals, rel, W):
    """Two launches of B1 on the same inputs give the same bits: the
    kernel has no atomics, so its combine order is fixed."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    a = chunk_partials(vals, rel, W, "sum")
    b = chunk_partials(vals, rel, W, "sum")
    torch.cuda.synchronize()
    require(_same_words(a, b), f"B1 {name}: two launches differ in bits")
    return {"case": f"{name}/deterministic", "C": vals.shape[0],
            "E": vals.shape[1],
            "dtype": str(vals.dtype).replace("torch.", ""), "kind": "sum",
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


def b1_line(args, torch, vals, rel, W, name):
    """The kernels-line entry of B1 on ``vals``/``rel``: kernel, plain
    and one-``scatter_reduce`` times, and the bound (``b1_bound``)."""
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_plain)
    from lux_tpu_torch.ops.segment import SCATTER_REDUCE, identity_for
    reps = args.reps
    C, E = vals.shape
    ms = cuda_ms(lambda: chunk_partials(vals, rel, W, "sum"), reps)
    plain_ms = cuda_ms(lambda: chunk_partials_plain(vals, rel, W, "sum"),
                       reps)
    relw = rel.to(torch.int64)
    idx = (torch.arange(C, device=vals.device)[:, None] * (W + 1)
           + torch.where((relw >= 0) & (relw < W), relw, W)).reshape(-1)
    del relw
    base = torch.full((C * (W + 1),), identity_for("sum", vals.dtype),
                      dtype=vals.dtype, device=vals.device)
    flat = vals.reshape(-1)
    library_ms = cuda_ms(lambda: base.scatter_reduce(
        0, idx, flat, SCATTER_REDUCE["sum"], include_self=True), reps)
    del idx, base
    got = chunk_partials(vals, rel, W, "sum")
    want = chunk_partials_plain(vals, rel, W, "sum")
    max_abs_err = float((got.double() - want.double()).abs().max())
    del got, want
    return {"name": name, "route": "cuda",
            "source": "lux_tpu_torch/csrc/chunk_partials.cu",
            "replaces": "lux_tpu/ops/pallas_reduce.py:63",
            "shape": [C, E, W], "launches": None,
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
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    chunk_partials.launches = 0
    lane_shuffle.launches = 0


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
    emit({"phase": "parts", "nv": g.nv, "ne": g.ne, "num_parts": 4,
          "tile_e": 128, "chunks": eng.num_parts * eng.tiles.n_chunks,
          "iters": args.iters, "max_rel_err": float(rel_err.max()),
          "chunk_partials_launches": launches, "paged": paged,
          "pairs": pairs})


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


def phase_pairs(args, torch, g, card):
    """bench.py's pagerank config (bench.py:987-1011) on the main graph,
    once with each pair_stream setting; returns (launches by setting,
    the kernels-line entry of B1 on the pair rows)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.graph import pair_relabel
    from lux_tpu_torch.ops.pairs import stream_blocks
    t0 = time.perf_counter()
    g2, _perm, starts = pair_relabel(g, 1, pair_threshold=PAIR_THRESHOLD)
    t_relabel = time.perf_counter() - t0
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
    pair_counts, kpairs = phase_pairs(args, torch, g, card)
    probe_lines = phase_probes(args, torch, g, card)
    del g
    by_path["pairs"] = pair_counts["streamed"]
    by_path["pairs_monolithic"] = pair_counts["monolithic"]
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
    emit({"kernels": [kline, *b1_lines.values(), b2, *probe_lines]})
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
