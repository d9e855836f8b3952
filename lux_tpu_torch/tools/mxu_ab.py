"""A/B of the components engine's one-hot tournament (``use_mxu=True``)
on the card, across source trees.

    python3 -m lux_tpu_torch.tools.mxu_ab --tree NAME=DIR [--tree ...]
        [--scale 19] [--reps 20] [--rounds 1]

Each ``--tree NAME=DIR`` names a checkout of the repo (DIR holds its
``lux_tpu_torch`` package; an earlier commit unpacked with ``git
archive``).  For each tree and round one child process (``--child``)
imports the package from DIR, builds components as chip_smoke.py's cc
phase does (R-MAT ``--scale``, edge factor 16, seed 0, symmetrized,
pair_relabel at threshold 16, min_fill 24, one part) with
``use_mxu=True``, and times on the card one dense iteration from the
init state (every vertex active: the tournament over every chunk and
the pair rows) by CUDA events over ``--reps`` calls after a warm-up,
and one converge's wall ms.  The trees run in turns, in the order given
and then reversed, ``--rounds`` times.  Prints the card's name and power
limit, then one JSON line per tree: each run's numbers, their medians
and the converge's iterations and label checksum (equal across trees).
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PAIR_THRESHOLD = 16
PAIR_MIN_FILL = 24


def child(args) -> int:
    import numpy as np
    import torch

    from lux_tpu_torch.apps import components
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, pair_relabel

    src, dst, nv = rmat_edges(args.scale, 16, seed=0)
    s, d = components.symmetrize(src, dst)
    g2, _perm, starts = pair_relabel(Graph.from_edges(s, d, nv), 1,
                                     pair_threshold=PAIR_THRESHOLD)
    eng = components.build_engine(g2, 1, pair_threshold=PAIR_THRESHOLD,
                                  pair_min_fill=PAIR_MIN_FILL,
                                  starts=starts, use_mxu=True)
    if not eng.use_mxu:
        raise SystemExit("use_mxu=True did not engage")
    label, active = eng.init_state()
    eng._dense(label, active)                       # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        eng._dense(label, active)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab, _act, it = eng.converge(*eng.init_state())
    torch.cuda.synchronize()
    conv_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"dense_step_ms": step_ms, "converge_ms": conv_ms,
                      "iterations": int(it),
                      "label_sum": int(lab.to(torch.int64).sum()),
                      "chunks": int(eng.tiles.n_chunks),
                      "pair_rows": int(eng.pairs.Rp),
                      "ne": int(g2.ne), "nv": int(np.int64(nv))}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lux_tpu_torch.tools.mxu_ab")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: a checkout whose lux_tpu_torch runs")
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args)
    trees = [t.split("=", 1) for t in args.tree]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("give each tree as --tree NAME=DIR")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(card[0] if card else "no nvidia-smi")
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    runs = {name: [] for name, _d in trees}
    for name, d in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--scale", str(args.scale), "--reps", str(args.reps)],
            env=env, capture_output=True, text=True, cwd=d)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    for name, rs in runs.items():
        med = {k: sorted(r[k] for r in rs)[len(rs) // 2]
               for k in ("dense_step_ms", "converge_ms")}
        print(json.dumps({"tree": name, "scale": args.scale,
                          "reps": args.reps, "median": med, "runs": rs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
