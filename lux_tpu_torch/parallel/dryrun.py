"""Every engine family on a parts mesh, checked against its NumPy oracle
(counterpart of __graft_entry__.py:19-30 ``_small_graphs`` and :41-146
``dryrun_multichip``).

The six configurations of the reference's dryrun, each run by every
rank of the mesh with ``num_parts`` = the mesh's world:

1. ``colfilter``   one ColFilter step, the [P, vpad, K] state;
2. ``pr_pairs``    one PageRank step with pair rows (``pair_threshold=8``
                   on the degree-relabelled graph);
3. ``pr_owner``    one PageRank step on the owner exchange;
4. ``pr_pairs_owner``  pairs and owner composed;
5. ``pr_owner_local``  the owner exchange on a local-parts build (each
                   rank builds only its own parts' rows);
6. ``sssp``        one SSSP step (its active count > 0), then the whole
                   converge, equal to Bellman-Ford bit for bit.

On the graphs ``rmat_edges(scale=9, edge_factor=8, seed=0)``, weights
``integers(1, 6)`` from seed 1.  ``configs(mesh)`` returns each
configuration's unpadded result (every rank the whole of it);
``check(results, oracles())`` holds them to the oracles with the
reference's tolerances.

    python -m lux_tpu_torch.parallel.dryrun -world N [-device cpu]

spawns N ranks on this host (gloo on the CPU, NCCL with one card a
rank), runs and checks every configuration, and prints one line.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PR_TOL = dict(rtol=5e-5, atol=1e-9)
CF_TOL = dict(rtol=1e-5, atol=1e-8)
CONFIGS = ("colfilter", "pr_pairs", "pr_owner", "pr_pairs_owner",
           "pr_owner_local", "sssp")


def small_graphs():
    """(plain, weighted) R-MAT scale 9, edge factor 8, seed 0; integer
    weights 1..5 from seed 1 (__graft_entry__.py:19)."""
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph

    src, dst, nv = rmat_edges(scale=9, edge_factor=8, seed=0)
    g_plain = Graph.from_edges(src, dst, nv)
    w = np.random.default_rng(1).integers(1, 6, size=src.shape[0]).astype(
        np.int32)
    return g_plain, Graph.from_edges(src, dst, nv, weights=w)


def configs(mesh, graphs=None) -> dict:
    """Run the six configurations as this rank of ``mesh`` -> name ->
    unpadded result (``sssp``: (one step's count, distances,
    iterations))."""
    from lux_tpu_torch.apps import colfilter, pagerank, sssp
    from lux_tpu_torch.graph import ShardedGraph, degree_relabel
    from lux_tpu_torch.parallel.mesh import local_part_rows

    g_plain, g_weighted = small_graphs() if graphs is None else graphs
    P = mesh.world
    out = {}
    eng = colfilter.build_engine(g_weighted, P, mesh=mesh)
    out["colfilter"] = eng.unpad(eng.step(eng.init_state()))
    g_pair, _perm = degree_relabel(g_plain)
    eng = pagerank.build_engine(g_pair, P, mesh=mesh, pair_threshold=8)
    if eng.pairs is None:
        raise AssertionError("the pair plan must engage")
    out["pr_pairs"] = eng.unpad(eng.step(eng.init_state()))
    eng = pagerank.build_engine(g_plain, P, mesh=mesh, exchange="owner")
    out["pr_owner"] = eng.unpad(eng.step(eng.init_state()))
    eng = pagerank.build_engine(g_pair, P, mesh=mesh, pair_threshold=8,
                                exchange="owner")
    out["pr_pairs_owner"] = eng.unpad(eng.step(eng.init_state()))
    sg_local = ShardedGraph.build(g_plain, P,
                                  parts=local_part_rows(mesh, P))
    eng = pagerank.build_engine(g_plain, P, mesh=mesh, sg=sg_local,
                                exchange="owner")
    out["pr_owner_local"] = eng.unpad(eng.step(eng.init_state()))
    eng = sssp.build_engine(g_plain, 0, P, mesh=mesh)
    label, active = eng.init_state()
    _l, _a, cnt = eng.step(label, active)
    dist, iters = eng.run()
    out["sssp"] = (int(cnt), dist, iters)
    return out


def oracles(graphs=None) -> dict:
    """The NumPy oracle of each configuration (float64; SSSP int64)."""
    from lux_tpu_torch.apps import colfilter, pagerank, sssp
    from lux_tpu_torch.graph import degree_relabel

    g_plain, g_weighted = small_graphs() if graphs is None else graphs
    g_pair, _perm = degree_relabel(g_plain)
    pr_plain = pagerank.reference_pagerank(g_plain, 1)
    pr_pair = pagerank.reference_pagerank(g_pair, 1)
    return {"colfilter": colfilter.reference_colfilter(g_weighted, 1),
            "pr_pairs": pr_pair, "pr_owner": pr_plain,
            "pr_pairs_owner": pr_pair, "pr_owner_local": pr_plain,
            "sssp": sssp.reference_sssp(g_plain, 0)}


def check(results: dict, want: dict) -> None:
    """Each configuration's result against its oracle: ColFilter within
    rtol 1e-5, PageRank within rtol 5e-5, SSSP's one step active and its
    converged distances bit for bit.  Raises AssertionError."""
    np.testing.assert_allclose(results["colfilter"], want["colfilter"],
                               **CF_TOL)
    for name in ("pr_pairs", "pr_owner", "pr_pairs_owner",
                 "pr_owner_local"):
        np.testing.assert_allclose(results[name], want[name], **PR_TOL,
                                   err_msg=name)
    cnt, dist, _iters = results["sssp"]
    if cnt <= 0:
        raise AssertionError(f"one SSSP step left {cnt} active vertices")
    np.testing.assert_array_equal(np.asarray(dist, np.int64), want["sssp"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.parallel.dryrun",
        description="the six mesh configurations on N spawned ranks, "
                    "each against its NumPy oracle")
    ap.add_argument("-world", type=int, default=2,
                    help="ranks to spawn (the parts: one a rank)")
    ap.add_argument("-device", default=None,
                    help="'cpu' (gloo ranks); default: one card a rank "
                         "(NCCL)")
    ap.add_argument("-timeout", type=float, default=300.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    from lux_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    device = "cuda" if args.device is None else args.device
    results = spawn_ranks(configs, args.world, device, args.timeout)
    want = oracles()
    for r in results:
        check(r, want)
    print(f"dryrun(world={args.world}, device={device}): all six "
          f"configurations oracle-checked on every rank "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
