"""A/B of the page plans' host build, seconds and peak memory, across
source trees.

    python3 -m lux_tpu_torch.tools.plan_ab --tree NAME=DIR [--tree ...]
        [--scale 21] [--parts 4] [--rounds 1]

Each ``--tree NAME=DIR`` names a checkout of the repo (DIR holds its
``lux_tpu_torch`` package; an earlier commit unpacked with ``git
archive``).  For each tree and round one child process (``--child``)
imports the package from DIR and builds chip_smoke.py's owner_paged
graph: R-MAT ``--scale``, edge factor 16, seed 0, degree_relabel, a
128-aligned ShardedGraph of ``--parts`` parts.  Then, for each plan
(owner paged, owner page-major, dense paged, dense page-major, all on
those parts), a forked process builds that plan alone and reports its
wall seconds, its peak resident bytes over the graph's (its resident
bytes read from /proc/self/statm every 2 ms on a thread, the largest
less those at the fork) and a checksum of its arrays (equal across
trees).  The trees run in turns, in the order given and then reversed,
``--rounds`` times.  Prints the host's CPU count, then one JSON line
per tree: each run's numbers and their medians (of an even count, the
upper).  Host work only: it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

PLANS = ("plan_owner_paged", "plan_owner_pagemajor", "plan_paged_gather",
         "plan_pagemajor")


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _one_plan(pg, sg, name) -> dict:
    import numpy as np
    rss0 = peak = _rss_bytes()
    done = threading.Event()

    def sample():
        nonlocal peak
        while not done.wait(0.002):
            peak = max(peak, _rss_bytes())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    t0 = time.perf_counter()
    plan = getattr(pg, name)(sg)
    secs = time.perf_counter() - t0
    done.set()
    th.join()
    peak = max(peak, _rss_bytes())
    return {"seconds": secs, "peak_bytes_over_graph": peak - rss0,
            "Rp": int(plan.Rp),
            "checksum": [int(plan.slot_lane.sum(dtype=np.uint64)),
                         int(plan.rel_dst.sum(dtype=np.int64)),
                         int(plan.tile_pos.sum(dtype=np.int64))]}


def child(args) -> int:
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph, ShardedGraph, degree_relabel
    from lux_tpu_torch.ops import pagegather as pg

    src, dst, nv = rmat_edges(args.scale, 16, seed=0)
    g2, _perm = degree_relabel(Graph.from_edges(src, dst, nv))
    del src, dst
    sg = ShardedGraph.build(g2, args.parts, vpad_align=pg.W)
    out = {}
    for name in PLANS:
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:                    # build one plan, report, exit
            os.close(r)
            with os.fdopen(w, "w") as f:
                f.write(json.dumps(_one_plan(pg, sg, name)))
            os._exit(0)
        os.close(w)
        with os.fdopen(r) as f:
            text = f.read()
        _pid, status = os.waitpid(pid, 0)
        if status != 0 or not text:
            raise SystemExit(f"{name}: the build process failed "
                             f"(status {status})")
        out[name] = json.loads(text)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m lux_tpu_torch.tools.plan_ab")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: a checkout whose lux_tpu_torch runs")
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args)
    trees = [t.split("=", 1) for t in args.tree]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("give each tree as --tree NAME=DIR")
    print(json.dumps({"cpus": os.cpu_count(), "scale": args.scale,
                      "parts": args.parts}))
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    runs = {name: [] for name, _d in trees}
    for name, d in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--scale", str(args.scale), "--parts", str(args.parts)],
            env=env, capture_output=True, text=True, cwd=d)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    for name, rs in runs.items():
        med = {p: {k: sorted(r[p][k] for r in rs)[len(rs) // 2]
                   for k in ("seconds", "peak_bytes_over_graph")}
               for p in PLANS}
        print(json.dumps({"tree": name, "median": med, "runs": rs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
