#!/usr/bin/env python3
"""Quickest proof that the PyTorch / H100 port starts on the card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. env      torch / CUDA versions, the card's name and power limit
            (also printed raw, as nvidia-smi gives them);
2. build    every kernel built from lux_tpu_torch/csrc, build seconds;
3. graph    the main path's graph: R-MAT scale 21, edge factor 16
            (2,097,152 vertices, 33,554,432 edges), made from --seed,
            and its PageRank engine on the card;
4. kernels  kernel B1 (chunk_partials) against its plain PyTorch
            version on the card: the main path's own chunks, plus
            {f32, int32} x {sum, min, max} cases with pads, empty lanes,
            unsorted pair-row lanes, an odd C and NaN lanes; then the
            kernels line with times, bound and launches;
5. main     PageRank, 10 iterations, through the port's entry points,
            against the float64 oracle (rtol 5e-5, atol 1e-9); B1's
            launch count must rise by exactly one per iteration;
6. layers   per-layer device time of one iteration (gather, kernel,
            combine, apply);
7. parts    R-MAT scale 18 with 4 parts on one card and a chunk width
            that needs the segmented combine, against the oracle.

The last line is {"ok": true, "device": {...}}.  Any failure raises
and the script exits non-zero without that line; so does a machine
without CUDA, or a directory without the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN_TOL = dict(rtol=5e-5, atol=1e-9)   # tests/test_pagerank.py:31


def emit(obj) -> None:
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
                          "ptxas": [ln for ln in v["ptxas"].splitlines()
                                    if "registers" in ln or "smem" in ln]}
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
            atol = E * 2.0 ** -23 * float(vals.abs().max())
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


def phase_kernels(args, torch, eng):
    """Kernel B1 vs its plain version on the card, then its timings at
    the main path's shape on the main path's own chunks."""
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_plain)
    from lux_tpu_torch.ops.segment import SCATTER_REDUCE, identity_for
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
    emit({"phase": "kernels", "cases": len(cases), "all_pass": True,
          "detail": cases})

    # timings at the main path's shape, on the main path's chunks
    reps = args.reps
    ms = cuda_ms(lambda: chunk_partials(msgs_main, rel_main, W, "sum"), reps)
    plain_ms = cuda_ms(
        lambda: chunk_partials_plain(msgs_main, rel_main, W, "sum"), reps)
    relw = rel_main.to(torch.int64)
    lane = torch.where((relw >= 0) & (relw < W), relw, W)
    idx = (torch.arange(C, device=dev)[:, None] * (W + 1) + lane).reshape(-1)
    base = torch.full((C * (W + 1),), identity_for("sum", msgs_main.dtype),
                      dtype=msgs_main.dtype, device=dev)
    flat_msgs = msgs_main.reshape(-1)
    library_ms = cuda_ms(lambda: base.scatter_reduce(
        0, idx, flat_msgs, SCATTER_REDUCE["sum"], include_self=True), reps)
    got = chunk_partials(msgs_main, rel_main, W, "sum")
    want = chunk_partials_plain(msgs_main, rel_main, W, "sum")
    max_abs_err = float((got.double() - want.double()).abs().max())
    bytes_moved = C * E * (msgs_main.element_size() + 1) \
        + C * W * msgs_main.element_size()
    ops = C * E                     # one combine per message
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"name": "chunk_partials", "route": "cuda",
            "source": "lux_tpu_torch/csrc/chunk_partials.cu",
            "replaces": "lux_tpu/ops/pallas_reduce.py:63",
            "shape": [C, E, W], "launches": None,
            "max_abs_err": max_abs_err, "max_err": max_abs_err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "library_ms": library_ms}


def phase_main(args, torch, g, eng, card):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    eng.step(eng.init_state())                    # warm-up iteration
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = eng.init_state()
    torch.cuda.synchronize()
    chunk_partials.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = eng.run(state, args.iters)
    end.record()
    end.synchronize()
    launches = chunk_partials.launches
    secs = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated()
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
    emit({"phase": "main", "app": "pagerank", "nv": g.nv, "ne": g.ne,
          "iters": args.iters, "seconds": secs,
          "ms_per_iter": secs * 1e3 / args.iters,
          "gteps": g.ne * args.iters / secs / 1e9,
          "peak_bytes": int(peak), "max_rel_err": float(rel_err.max()),
          "tolerance": MAIN_TOL, "chunk_partials_launches": launches,
          "state_table_bytes": eng.num_parts * eng.vpad * 4,
          "note": "the f32 state table fits in the card's 50 MB L2",
          "card": card})
    return launches


def phase_layers(args, torch, eng):
    """Device ms of each layer of one iteration, each timed alone."""
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
    }
    emit({"phase": "layers", **out})


def phase_parts(args, torch):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    src, dst, nv = rmat_edges(18, 16, seed=args.seed + 1)
    g = Graph.from_edges(src, dst, nv)
    eng = pagerank.build_engine(g, num_parts=4, tile_e=128)
    require(eng.tiles.needs_scan, "parts phase must need the segmented "
                                  "combine")
    state = eng.init_state()
    chunk_partials.launches = 0
    state = eng.run(state, args.iters)
    torch.cuda.synchronize()
    launches = chunk_partials.launches
    got = eng.unpad(state)
    want = pagerank.reference_pagerank(g, args.iters)
    rel_err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    require(np.allclose(got, want, **MAIN_TOL),
            f"4-part run disagrees with the oracle ({rel_err.max():.3e})")
    require(launches == args.iters, f"4-part run launched chunk_partials "
                                    f"{launches} times")
    emit({"phase": "parts", "nv": g.nv, "ne": g.ne, "num_parts": 4,
          "tile_e": 128, "chunks": eng.num_parts * eng.tiles.n_chunks,
          "iters": args.iters, "max_rel_err": float(rel_err.max()),
          "chunk_partials_launches": launches})


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

    card = phase_env(torch)
    phase_build()
    g, eng = phase_graph(args, torch)
    kline = phase_kernels(args, torch, eng)
    kline["launches"] = phase_main(args, torch, g, eng, card)
    phase_layers(args, torch, eng)
    phase_parts(args, torch)
    emit({"kernels": [kline]})
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
