"""Page-aware vertex reordering (counterpart of lux_tpu/reorder.py).

The paged gather (ops/pagegather.py) pays a delivery row for every
(destination tile, source page) bin, so it gains only where the edges
of a bin cluster; ``plan_paged_stats`` measures exactly that
(``padded_fill``: live lanes per padded row; ``page_ratio``).  This
module generates candidate vertex orders (the degree sort; the native
clustering passes of native/reorder.cc, communities and hub-first BFS)
and scores each by the plan builder's measured fill, on the host; the
hill-climb then refines the best with the dominant-destination-tile
regroup (sources feeding the same destination tile become page-mates),
each pass kept only if the measured ``padded_fill`` rises.

The permutation is kept beside the .lux file as a ``.perm`` sidecar
(format.write_perm_sidecar) and applied at load by
``Graph.from_file(reorder=...)``.
"""

from __future__ import annotations

import time

import numpy as np

from lux_tpu_torch import native as _native
from lux_tpu_torch.graph import Graph, ShardedGraph

W = 128

METHODS = ("none", "degree", "native", "hillclimb")


def apply_perm(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel ``g`` by ``perm`` (``perm[new] = old``, the
    degree_relabel direction).  Edge weights ride along."""
    perm = np.asarray(perm, np.int64)
    if perm.shape != (g.nv,) or not np.array_equal(
            np.sort(perm), np.arange(g.nv)):
        raise ValueError(f"perm must be a bijection of [0, {g.nv})")
    rank = np.empty(g.nv, np.int64)
    rank[perm] = np.arange(g.nv)
    src, dst = g.edge_arrays()
    return Graph.from_edges(rank[src], rank[dst], g.nv, weights=g.weights)


def page_fill_stats(g: Graph, num_parts: int = 1, exchange: str = "gather",
                    pagemajor: bool = False) -> dict:
    """The plan builder's measured objective for ``g`` in its current
    vertex order (lux_tpu/reorder.py:49-61): the 128-aligned layout and
    the counting pass of the paged plan (ops/pagegather.plan_paged_stats,
    none of the [P, Rp, 128] assembly), the dense plan's or, under
    ``exchange="owner"``, the owner plans'."""
    from lux_tpu_torch.ops.pagegather import plan_paged_stats

    sg = ShardedGraph.build(g, num_parts, vpad_align=W)
    return plan_paged_stats(sg, exchange=exchange, pagemajor=pagemajor)


def _dominant_tile_regroup(g: Graph) -> np.ndarray:
    """One hill-climb move, a relative permutation of the current
    order: key every vertex by the destination tile receiving most of
    its out-edges (ties to the smaller tile; sinks keep their own
    tile) and stable-sort."""
    src, dst = g.edge_arrays()
    n_tiles = -(-g.nv // W)
    key = src * np.int64(n_tiles) + dst // W
    _native.sort_kv(key, ())
    newg = np.ones(len(key), bool)
    if len(key):
        newg[1:] = key[1:] != key[:-1]
    b = np.nonzero(newg)[0]
    cnt = np.diff(np.concatenate((b, [len(key)])))
    uk = key[b]
    u_src = uk // np.int64(n_tiles)
    u_tile = uk % np.int64(n_tiles)
    # per source, the tile with the most edges (ties: the smaller)
    order = np.lexsort((u_tile, -cnt, u_src))
    first = np.ones(len(order), bool)
    if len(order):
        first[1:] = u_src[order][1:] != u_src[order][:-1]
    dom = np.full(g.nv, -1, np.int64)
    dom[u_src[order][first]] = u_tile[order][first]
    no_out = dom < 0
    dom[no_out] = np.nonzero(no_out)[0] // W
    return np.argsort(dom, kind="stable")


def page_reorder(g: Graph, method: str = "hillclimb", num_parts: int = 1,
                 exchange: str = "gather", passes: int = 8,
                 verbose: bool = False,
                 timings: dict | None = None, start=None):
    """Reorder ``g``'s vertices for page locality.

    method:
      none       identity (the report still measures the baseline)
      degree     descending total-degree sort (degree_relabel's order)
      native     the best by measured fill of the degree sort and the
                 native clustering passes (communities, hub-first BFS)
      hillclimb  the same candidates, then dominant-tile regroup passes,
                 each kept only if the measured ``padded_fill`` rises

    Returns ``(g2, perm, report)``: ``perm[new] = old`` maps g2's ids to
    g's, and ``report`` holds each candidate's measured stats (the same
    dict as the reference's).  Under ``native.numpy_versions()`` it sorts
    and clusters with the numpy versions (the clustering's orders differ
    from the C++ pass's).  ``timings``, when given, receives each
    candidate's host seconds (its order, relabel and scoring) under its
    report tag.  ``start``: the ``(g2, perm, report)`` of method
    "native" on the same ``g``, ``num_parts`` and ``exchange``;
    "hillclimb" then regroups from its choice instead of scoring the same
    candidates again (the same result, their timings left out)."""
    if method not in METHODS:
        raise ValueError(f"unknown reorder method {method!r} "
                         f"(one of {', '.join(METHODS)})")
    if start is not None and (method != "hillclimb"
                              or start[2].get("method") != "native"):
        raise ValueError("start= takes a 'native' result and continues "
                         "it with method='hillclimb'")

    def score(g2):
        return page_fill_stats(g2, num_parts, exchange)

    def timed(tag, t0):
        if timings is not None:
            timings[tag] = time.perf_counter() - t0

    if start is not None:
        g2, perm, rep0 = start
        report = {"method": method, "num_parts": num_parts,
                  "exchange": exchange,
                  "candidates": dict(rep0["candidates"])}
        t0 = time.perf_counter()
        st = score(g2)
        timed("start", t0)
        best = _regroup(g, g2, perm, st, passes, score, timed, report,
                        verbose)
        return _chosen(best, rep0["baseline_fill"], report)
    t0 = time.perf_counter()
    base = score(g)
    timed("none", t0)
    report = {"method": method, "num_parts": num_parts,
              "exchange": exchange,
              "candidates": {"none": _digest(base)}}
    identity = np.arange(g.nv, dtype=np.int64)
    if method == "none":
        return g, identity, report

    def degree_order():
        deg = (np.bincount(g.col_idx, minlength=g.nv).astype(np.int64)
               + g.in_degrees())
        return np.argsort(-deg, kind="stable")

    def cluster_order(mode):
        src, dst = g.edge_arrays()
        return _native.reorder_cluster(src, dst, g.nv,
                                       mode=mode).astype(np.int64)

    cands = [("degree", degree_order)]
    if method in ("native", "hillclimb"):
        cands += [(f"native-{m}", lambda m=m: cluster_order(m))
                  for m in ("communities", "hubs")]

    best = (g, identity, base)
    for tag, order in cands:
        t0 = time.perf_counter()
        perm = order()
        g2 = apply_perm(g, perm)
        st = score(g2)
        timed(tag, t0)
        report["candidates"][tag] = _digest(st)
        if verbose:
            print(f"# reorder {tag}: padded_fill "
                  f"{st['padded_fill']:.2f}", flush=True)
        if st["padded_fill"] > best[2]["padded_fill"]:
            best = (g2, perm, st)

    if method == "hillclimb":
        best = _regroup(g, *best, passes, score, timed, report, verbose)
    return _chosen(best, round(float(base["padded_fill"]), 3), report)


def _regroup(g, g2, perm, st, passes, score, timed, report, verbose):
    """Hillclimb's dominant-tile regroup passes from (g2, perm, its
    stats), each kept only if the measured ``padded_fill`` rises."""
    for i in range(passes):
        t0 = time.perf_counter()
        cand_perm = perm[_dominant_tile_regroup(g2)]
        g3 = apply_perm(g, cand_perm)
        st3 = score(g3)
        timed(f"regroup{i}", t0)
        report["candidates"][f"regroup{i}"] = _digest(st3)
        if verbose:
            print(f"# reorder regroup{i}: padded_fill "
                  f"{st3['padded_fill']:.2f}", flush=True)
        if st3["padded_fill"] <= st["padded_fill"]:
            break                       # hill-climb: accept only up
        g2, perm, st = g3, cand_perm, st3
    return g2, perm, st


def _chosen(best, baseline_fill: float, report: dict):
    g2, perm, st = best
    report["chosen_fill"] = round(float(st["padded_fill"]), 3)
    report["baseline_fill"] = baseline_fill
    report["chosen"] = _digest(st)
    return g2, perm, report


def _digest(stats: dict) -> dict:
    return {"fill": round(float(stats["fill"]), 3),
            "padded_fill": round(float(stats["padded_fill"]), 3),
            "page_ratio": round(float(stats["page_ratio"]), 4),
            "rows": int(stats["rows"])}
