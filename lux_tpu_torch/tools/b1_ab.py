"""A/B of kernel B1's design choices on the card.

    python3 -m lux_tpu_torch.tools.b1_ab [--scale 21] [--rounds 7]

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

Prints the card's name and power limit, each build's ptxas registers
and spills, then one JSON line per shape:
each variant's median ms, its per-round ms and its ratio to as_is.
Needs a card and nvcc; it writes its builds under lux_tpu_torch/_build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

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


def variant_source(text: str, edits) -> str:
    """``text`` with each (anchor, replacement) applied; an anchor must
    occur exactly once, so an edited source fails loudly here."""
    for anchor, repl in edits:
        n = text.count(anchor)
        if n != 1:
            raise ValueError(f"anchor found {n} times, want 1: {anchor!r}")
        text = text.replace(anchor, repl)
    return text


def build_variants(names):
    """One nvcc per variant, all started together, with the flags of
    the port's own build.  Returns ({name: ctypes function}, {name:
    ptxas register and spill lines})."""
    from lux_tpu_torch import _kernels
    src_name, fns = _kernels.KERNELS["chunk_partials"]
    text = (_kernels.CSRC / src_name).read_text()
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = _kernels.BUILD_DIR / f"b1_ab_{name}.cu"
        src.write_text(variant_source(text, VARIANTS[name]))
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    out, ptxas = {}, {}
    restype, argtypes = fns["lux_chunk_partials"]
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).lux_chunk_partials
        fn.restype, fn.argtypes = restype, argtypes
        out[name] = fn
        ptxas[name] = sorted({ln.split(":", 1)[-1].strip()
                              for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln})
    return out, ptxas


def launch(torch, fn, vals, rel, W):
    C, E = vals.shape
    out = torch.empty((C, W), dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), rel.data_ptr(), out.data_ptr(), C, E, W,
             {torch.float32: 0, torch.int32: 1}[vals.dtype], 0,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing")
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
    names = list(VARIANTS)
    fns, ptxas = build_variants(names)
    print(json.dumps({"ptxas": ptxas}), flush=True)
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
