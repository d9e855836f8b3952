"""A/B of kernel B1's design choices on the card.

    python3 -m lux_tpu_torch.tools.b1_ab [--scale 21] [--rounds 7]
    python3 -m lux_tpu_torch.tools.b1_ab --batched [--scale 21]
        [--old-source FILE] [--rounds 5]

Builds ``csrc/chunk_partials.cu`` as it is and in variants that each
undo one of its choices or try another, then times every build in turns (the order
reversed every other round) at the two shapes PageRank gives B1 on
R-MAT at ``--scale`` (edge factor 16, seed 0): the flat path's own
chunks [C, 512] and the paged path's own rows [Rp, 128].  Each build is
first held to the plain version on those inputs.

Variants (each an edit of the source, which must apply exactly once):

    as_is         the source as it is
    skip_pads     a value is read only where its lane id matches, so
                  the value loads wait on the lane-id loads
    match_only    every step groups lanes with __match_any_sync: no
                  segmented scan for sorted steps
    match_sparse  the scan only for steps with more than 8 live threads
    scalar_store  4 B stores of the output rows, never 16 B
    one_row       a warp takes one row at a time at every E
    regs64        __launch_bounds__ held to 64 registers (4 blocks/SM)
    regs48        held to 48 registers (5 blocks/SM)

With ``--batched`` it does the same for B1's batched form,
``csrc/chunk_partials_batched.cu``, at the shapes the batch and fleet
phases give it on R-MAT one scale under ``--scale`` (edge factor 16,
seed 0, the sources ``sorted(default_rng(7).choice(nv, 8))``): the tiled chunks
[C, 512, B] at B = 4 (a fleet replica's runners) and B = 8 (ppr_batch,
ksssp_batch, the Server), and the paged rows [Rp, 128, 8] of the
degree-relabelled graph, each as PageRank's f32 ``sum`` and hop SSSP's
int32 ``min`` messages.  Its variants:

    as_is         the source as it is
    all_values    a pad's values are read too
    match_only    every step takes the match groups: no scan
    adaptive      the scan runs only the levels the step's longest run
                  needs (__reduce_max_sync), not always five
    one_entry     one entry a thread at every column group (steps of 32)
    values16      16 values a thread a step (two entries at B = 8)

``--old-source FILE`` adds a build of another source with the same C
interface (an earlier design, e.g. ``git show
<rev>:lux_tpu_torch/csrc/chunk_partials_batched.cu`` saved under the
git-ignored lux_tpu_torch/_build/), timed in the same turns as ``old``.

Prints the card's name and power limit, each build's ptxas registers
and spills and its nvcc seconds (the builds run at once, one process
each, the source as one translation unit), then one JSON line per shape:
each variant's median ms, its per-round ms and its ratio to as_is (the
batched lines also the shape's byte bound, as chip_smoke.py counts it).
Needs a card and nvcc; it writes its builds under lux_tpu_torch/_build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

VARIANTS = {
    "as_is": [],
    "skip_pads": [
        ("    if (e < E) {\n      const uint4 raw",
         "    if (q.k[0] >= 0 || q.k[1] >= 0 || q.k[2] >= 0 || q.k[3] >= 0) {"
         "\n      const uint4 raw"),
        ("if (e + j < E) q.v[j] = __ldg(", "if (q.k[j] >= 0) q.v[j] = __ldg(")],
    "match_only": [(
        "if (__all_sync(kFull, r.asc && head >= kprev)) {",
        "if (false) {")],
    "match_sparse": [(
        "if (__all_sync(kFull, r.asc && head >= kprev)) {",
        "if (__popc(live) > 8 && __all_sync(kFull, r.asc && head >= kprev)) {")],
    "scalar_store": [(
        "if (W % 4 == 0 && (uintptr_t)orow % 16 == 0) {",
        "if (false) {")],
    "one_row": [(
        "return spr >= kGroup ? 1 : spr == 1 ? 4 : 2;",
        "return 1;")],
    "regs64": [(
        "__global__ void __launch_bounds__(kThreads)",
        "__global__ void __launch_bounds__(kThreads, 4)")],
    "regs48": [(
        "__global__ void __launch_bounds__(kThreads)",
        "__global__ void __launch_bounds__(kThreads, 5)")],
}


BATCHED_VARIANTS = {
    "as_is": [],
    "all_values": [(
        "  if (k < 0) return;                    // a pad's values",
        "  if (k == -2) return;                    // a pad's values")],
    "match_only": [(
        "if (__all_sync(kFull, r.asc && head >= kprev)) {",
        "if (false) {")],
    "adaptive": [(
        "    for (int d = 1; d < 32; d <<= 1) {\n      const bool take",
        "    const int longest = __reduce_max_sync(kFull, lane - seghead + 1);"
        "\n    for (int d = 1; d < longest; d <<= 1) {"
        "\n      const bool take")],
    "one_entry": [(
        "constexpr int entries_a_thread(int bg) {\n  return",
        "constexpr int entries_a_thread(int bg) {\n  return 1;\n  return")],
    "values16": [(
        "constexpr int kStepValues = 8;",
        "constexpr int kStepValues = 16;")],
}

HBM_BYTES_PER_S = 3.35e12      # the H100 SXM data sheet's HBM3 rate


def variant_source(text: str, edits) -> str:
    """``text`` with each (anchor, replacement) applied; an anchor must
    occur exactly once, so an edited source fails loudly here."""
    for anchor, repl in edits:
        n = text.count(anchor)
        if n != 1:
            raise ValueError(f"anchor found {n} times, want 1: {anchor!r}")
        text = text.replace(anchor, repl)
    return text


def build_variants(names, kernel="chunk_partials", variants=VARIANTS,
                   sources=None):
    """One nvcc per variant, all started together, with the flags of
    the port's own build: each variant of ``variants`` is an edit of
    ``kernel``'s source, a name in ``sources`` that file's text as it
    is.  Returns ({name: ctypes function}, {name: ptxas register and
    spill lines}, {name: seconds until its nvcc ended})."""
    from lux_tpu_torch import _kernels
    src_name, fns = _kernels.KERNELS[kernel]
    text = (_kernels.CSRC / src_name).read_text()
    sources = sources or {}
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in names:
        src = _kernels.BUILD_DIR / f"b1_ab_{kernel}_{name}.cu"
        src.write_text(sources[name].read_text() if name in sources
                       else variant_source(text, variants[name]))
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    def wait(proc):
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(procs)) as pool:
        logs = {name: pool.submit(wait, proc)
                for name, (proc, _lib) in procs.items()}
    out, ptxas, seconds = {}, {}, {}
    entry = f"lux_{kernel}"
    restype, argtypes = fns[entry]
    for name, (proc, lib) in procs.items():
        log, seconds[name] = logs[name].result()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.restype, fn.argtypes = restype, argtypes
        out[name] = fn
        ptxas[name] = sorted({ln.split(":", 1)[-1].strip()
                              for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln})
    return out, ptxas, seconds


def launch(torch, fn, vals, rel, W):
    C, E = vals.shape
    out = torch.empty((C, W), dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), rel.data_ptr(), out.data_ptr(), C, E, W,
             {torch.float32: 0, torch.int32: 1}[vals.dtype], 0,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")
    return out


def launch_batched(torch, fn, vals, rel, W, kind):
    C, E, B = vals.shape
    out = torch.empty((C, W, B), dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), rel.data_ptr(), out.data_ptr(), C, E, B, W,
             {torch.float32: 0, torch.int32: 1}[vals.dtype],
             {"sum": 0, "min": 1, "max": 2}[kind],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")
    return out


def cuda_ms(torch, fn, reps: int) -> float:
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


def shapes(torch, args):
    """(label, vals, rel, W) of the flat and the paged path: the first
    iteration's messages and the engines' own lane ids."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, ShardedGraph, degree_relabel
    from lux_tpu_torch.ops.pagegather import W, paged_values
    src, dst, nv = rmat_edges(args.scale, 16, seed=0)
    g = Graph.from_edges(src, dst, nv)
    del src, dst
    eng = pagerank.build_engine(g, num_parts=1)
    C = eng.num_parts * eng.tiles.n_chunks
    E = eng.tiles.E
    flat = (eng._messages(eng.init_state().reshape(-1)).reshape(C, E),
            eng.arrays["rel_dst"].reshape(C, E), eng.tiles.W)
    del eng
    g2, _perm = degree_relabel(g)
    sg = ShardedGraph.build(g2, 1, vpad_align=128)
    eng = pagerank.build_engine(g2, sg=sg, gather="paged")
    a = eng.arrays
    vals = paged_values(eng.init_state().reshape(-1), a["pg_ids"],
                        a["pg_sl"])
    paged = (vals, a["pg_rel"].reshape(-1, W).contiguous(), W)
    del eng, a
    return [("flat", *flat), ("paged", *paged)]


def batched_shapes(torch, args):
    """(label, vals [C, E, B], rel [C, E], W, kind) of B1's batched form
    on its system paths: the first messages after a few iterations of
    PageRank (f32 sum) and hop SSSP (int32 min) from the batch sources,
    on the tiled chunks at B = 4 and 8 and the paged rows at B = 8."""
    from lux_tpu_torch.apps import pagerank, sssp
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, ShardedGraph, degree_relabel
    src, dst, nv = rmat_edges(args.scale - 1, 16, seed=0)
    g = Graph.from_edges(src, dst, nv)
    del src, dst
    sources = sorted(int(x) for x in np.random.default_rng(7).choice(
        g.nv, size=8, replace=False))
    out = []

    def push_msgs(eng, srcs, paged):
        lab, act = eng.init_state()
        for _ in range(2):
            lab, act, _c = eng.step(lab, act)
        flat = eng._masked_flat(lab, act)
        if paged:
            return eng._dense_red(flat, None, upto="messages")
        return eng._dense_cand(flat)

    for B in (4, 8):
        eng = pagerank.build_engine(g, 1, sources=sources[:B])
        C, E = eng.num_parts * eng.tiles.n_chunks, eng.tiles.E
        rel = eng.arrays["rel_dst"].reshape(C, E)
        st = eng.run(eng.init_state(), 3)
        out.append((f"tiled_B{B}_ppr", eng._messages(st.reshape(-1, B))
                    .reshape(C, E, B), rel, eng.tiles.W, "sum"))
        del eng, st
        eng = sssp.build_engine(g, sources=sources[:B], num_parts=1)
        rel = eng.arrays["rel_dst"].reshape(C, E)
        out.append((f"tiled_B{B}_ksssp", push_msgs(eng, sources, False)
                    .reshape(C, E, B), rel, eng.tiles.W, "min"))
        del eng
    g2, perm = degree_relabel(g)
    sg = ShardedGraph.build(g2, 1, vpad_align=128)
    rank = np.empty(g.nv, np.int64)
    rank[perm] = np.arange(g.nv)
    src2 = [int(rank[s]) for s in sources]
    eng = pagerank.build_engine(g2, 1, sg=sg, sources=src2, gather="paged")
    st = eng.run(eng.init_state(), 3)
    out.append(("paged_B8_ppr", eng._paged_red(st.reshape(-1, 8),
                                               upto="messages"),
                eng.arrays["pg_rel"].reshape(-1, 128), 128, "sum"))
    del eng, st
    eng = sssp.build_engine(g2, sources=src2, num_parts=1, sg=sg,
                            gather="paged")
    out.append(("paged_B8_ksssp", push_msgs(eng, src2, True),
                eng.arrays["pg_rel"].reshape(-1, 128), 128, "min"))
    del eng
    torch.cuda.empty_cache()
    return out


def batched_bound_ms(vals, rel, W) -> float:
    """The byte bound chip_smoke.py's kernels line gives the batched
    form: ``chunk_partials_batched_traffic``'s bytes at the HBM rate."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_batched_traffic
    return (chunk_partials_batched_traffic(vals, rel, W)["bytes"]
            / HBM_BYTES_PER_S * 1e3)


def check_batched(torch, name, got, vals, rel, W, kind):
    """A build against the plain version on the first 2^18 rows: int32
    and min / max bit-equal, f32 sums within the smoke's tolerance
    (``chunk_partials_batched_sum_tolerance``)."""
    from lux_tpu_torch.ops.chunk_reduce import (
        chunk_partials_batched_plain, chunk_partials_batched_sum_tolerance)
    sub = slice(0, min(vals.shape[0], 1 << 18))
    v, r, got = vals[sub], rel[sub], got[sub]
    want = chunk_partials_batched_plain(v, r, W, kind)
    if vals.dtype == torch.int32 or kind != "sum":
        an, bn = torch.isnan(got), torch.isnan(want)
        ok = torch.equal(an, bn) and torch.equal(got[~an], want[~bn])
    else:
        bound = chunk_partials_batched_sum_tolerance(v, r, W)
        ok = bool(((got.double() - want.double()).abs() <= bound).all())
    if not ok:
        raise RuntimeError(f"build {name} disagrees with the plain version")


def main_batched(args, torch, card) -> int:
    names = list(BATCHED_VARIANTS)
    sources = {}
    if args.old_source:
        sources["old"] = Path(args.old_source)
        names.append("old")
    fns, ptxas, seconds = build_variants(names, "chunk_partials_batched",
                                         BATCHED_VARIANTS, sources)
    print(json.dumps({"ptxas": ptxas, "build_seconds": seconds}),
          flush=True)
    for label, vals, rel, W, kind in batched_shapes(torch, args):
        for name, fn in fns.items():
            got = launch_batched(torch, fn, vals, rel, W, kind)
            check_batched(torch, name, got, vals, rel, W, kind)
            del got
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                fn = fns[name]
                times[name].append(cuda_ms(
                    torch, lambda: launch_batched(torch, fn, vals, rel, W,
                                                  kind), args.reps))
        base = statistics.median(times["as_is"])
        bound = batched_bound_ms(vals, rel, W)
        print(json.dumps({
            "shape": label, "C": vals.shape[0], "E": vals.shape[1],
            "B": vals.shape[2], "W": W, "kind": kind,
            "dtype": str(vals.dtype).replace("torch.", ""),
            "bound_ms": bound, "rounds": args.rounds, "reps": args.reps,
            "card": card,
            "variants": {n: {"median_ms": statistics.median(t),
                             "over_as_is": statistics.median(t) / base,
                             "of_bound": bound / statistics.median(t),
                             "ms": t} for n, t in times.items()}}),
            flush=True)
        del vals, rel
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing")
    ap.add_argument("--batched", action="store_true",
                    help="B1's batched form and its variants")
    ap.add_argument("--old-source", default=None,
                    help="(--batched) another source with the same C "
                         "interface, timed as 'old'")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: the A/B needs an NVIDIA card", file=sys.stderr)
        return 1
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials_plain
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.batched:
        return main_batched(args, torch, card)
    names = list(VARIANTS)
    fns, ptxas, seconds = build_variants(names)
    print(json.dumps({"ptxas": ptxas, "build_seconds": seconds}),
          flush=True)
    for label, vals, rel, W in shapes(torch, args):
        want = chunk_partials_plain(vals, rel, W, "sum")
        for name, fn in fns.items():
            got = launch(torch, fn, vals, rel, W)
            if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
                raise RuntimeError(f"variant {name} disagrees with the "
                                   f"plain version on the {label} shape")
        del want
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                fn = fns[name]
                times[name].append(cuda_ms(
                    torch, lambda: launch(torch, fn, vals, rel, W),
                    args.reps))
        base = statistics.median(times["as_is"])
        print(json.dumps({
            "shape": label, "C": vals.shape[0], "E": vals.shape[1], "W": W,
            "rounds": args.rounds, "reps": args.reps, "card": card,
            "variants": {n: {"median_ms": statistics.median(t),
                             "over_as_is": statistics.median(t) / base,
                             "ms": t} for n, t in times.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
