"""Single-source shortest paths on the push engine (counterpart of
lux_tpu/apps/sssp.py:27-31, :103-195), with the same two modes:

- ``hops`` (default): hop counts, candidate = dist[src] + 1 — the
  reference's "SSSP", which never reads edge weights;
- ``weighted``: float32 distances, candidate = dist[src] + w.

Unreachable vertices keep the sentinel (``HOP_INF`` or ``DIST_INF``);
``unreachable`` masks them.  ``make_batched_program`` /
``build_engine(sources=)`` run k-source SSSP: labels [P, vpad, B], one
column per source, each bit-equal to its single-source run.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.push import PushEngine, PushProgram
from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph

HOP_INF = np.int32(np.iinfo(np.int32).max // 2)   # +1 cannot overflow
DIST_INF = np.float32(np.inf)


def make_program(start_vertex: int, weighted: bool = False) -> PushProgram:
    if weighted:
        def relax(src_label, w):
            return src_label + w
        identity, dtype = DIST_INF, np.float32
    else:
        def relax(src_label, w):
            return src_label + 1
        identity, dtype = HOP_INF, np.int32

    def init(sg: ShardedGraph):
        if not 0 <= start_vertex < sg.nv:
            raise ValueError(
                f"start vertex {start_vertex} out of range [0, {sg.nv})")
        dist = np.full(sg.nv, identity, dtype=dtype)
        dist[start_vertex] = 0
        active = np.zeros(sg.nv, dtype=bool)
        active[start_vertex] = True
        return sg.to_padded(dist), sg.to_padded(active)

    return PushProgram(reduce="min", relax=relax, identity=identity,
                       init=init, name="sssp")


def make_batched_program(sources, weighted: bool = False) -> PushProgram:
    """k-source SSSP: labels [P, vpad, B] whose column q is the
    independent run from ``sources[q]``; one masked gather an
    iteration serves every query, and columns retire through their own
    active masks.  Min fixed points are unique, so each column equals
    the single-source engine's run bit for bit."""
    sources = [int(s) for s in sources]
    if not sources:
        raise ValueError("sources must name at least one query")
    B = len(sources)
    if weighted:
        def relax(src_label, w):
            # weight [..., E] broadcasts over the trailing query axis
            return src_label + w[..., None]
        identity, dtype = DIST_INF, np.float32
    else:
        def relax(src_label, w):
            return src_label + 1
        identity, dtype = HOP_INF, np.int32

    def init(sg: ShardedGraph):
        for s in sources:
            if not 0 <= s < sg.nv:
                raise ValueError(
                    f"source vertex {s} out of range [0, {sg.nv})")
        dist = np.full((sg.nv, B), identity, dtype=dtype)
        active = np.zeros((sg.nv, B), dtype=bool)
        for q, s in enumerate(sources):
            dist[s, q] = 0
            active[s, q] = True
        return sg.to_padded(dist), sg.to_padded(active)

    return PushProgram(reduce="min", relax=relax, identity=identity,
                       init=init, name="ksssp", batch=B)


def default_delta(g: Graph) -> float:
    """Bucket width heuristic: the smallest positive edge weight,
    floored at mean/16 (the reference's rule)."""
    w = np.asarray(g.weights, np.float64)
    pos = w[w > 0]
    if not pos.size:
        return 1.0
    return float(max(pos.min(), np.mean(w) / 16.0))


def build_engine(g: Graph, start_vertex: int | None = 0,
                 num_parts: int = 1, mesh=None, weighted: bool = False,
                 delta: float | str | None = None,
                 sg: ShardedGraph | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 starts=None, exchange: str = "auto", gather: str = "flat",
                 enable_sparse: bool = True, use_mxu: bool | str = "auto",
                 health: bool = False, sources=None,
                 audit: str | None = None, *,
                 device=None) -> PushEngine:
    """SSSP engine on ``device`` (None = the card; "cpu" when asked).
    ``delta``: delta-stepping bucket width, "auto" for the heuristic
    (1.0 in hops mode), None for plain frontier relaxation.
    ``pair_threshold``: pair-lane delivery on dense iterations (after
    graph.pair_relabel, passing its ``starts``).  ``sources=[a, b,
    ...]`` builds the query-batched k-source engine instead
    (``make_batched_program``); start_vertex is then ignored, and delta
    and pair_threshold must be off (single-query machinery)."""
    dev = resolve_device(device)
    if weighted and g.weights is None:
        raise ValueError("weighted SSSP needs a weighted graph")
    if sources is not None:
        if delta is not None:
            raise ValueError("delta-stepping is single-query; "
                             "sources=[...] requires delta=None")
        program = make_batched_program(sources, weighted)
    else:
        if start_vertex is None:
            raise ValueError("single-query SSSP needs start_vertex "
                             "(or pass sources=[...] for a batch)")
        if delta == "auto":
            delta = default_delta(g) if weighted else 1.0
        program = make_program(start_vertex, weighted)
    if sg is None:
        sg = ShardedGraph.build(
            g, num_parts, starts=starts, pair_threshold=pair_threshold,
            vpad_align=128 if gather != "flat" else VPAD_ALIGN)
    return PushEngine(sg, program, device=dev, mesh=mesh, delta=delta,
                      pair_threshold=pair_threshold,
                      pair_min_fill=pair_min_fill, exchange=exchange,
                      gather=gather, enable_sparse=enable_sparse,
                      use_mxu=use_mxu, health=health, audit=audit)


def run(g: Graph, start_vertex: int = 0, num_parts: int = 1, mesh=None,
        weighted: bool = False, delta=None, max_iters=None,
        verbose: bool = False, *, device=None):
    """Returns (dist [nv], iterations)."""
    eng = build_engine(g, start_vertex, num_parts, mesh, weighted,
                       delta=delta, device=device)
    return eng.run(max_iters=max_iters, verbose=verbose)


def unreachable(dist: np.ndarray) -> np.ndarray:
    if dist.dtype == np.int32:
        return dist >= HOP_INF
    return ~np.isfinite(dist)


def reference_sssp(g: Graph, start_vertex: int = 0,
                   weighted: bool = False) -> np.ndarray:
    """NumPy Bellman-Ford oracle (exact fixed point): int64 hops or
    float64 distances."""
    src, dst = g.edge_arrays()
    if weighted:
        w = np.asarray(g.weights, dtype=np.float64)
        dist = np.full(g.nv, np.inf)
    else:
        w = np.ones(g.ne, dtype=np.int64)
        dist = np.full(g.nv, int(HOP_INF), dtype=np.int64)
    dist[start_vertex] = 0
    while True:
        cand = dist[src] + w
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def _by_dst(g: Graph):
    """(src, weights index, segment starts, destinations) of ``g``'s
    edges in destination order: the batched oracles' min/max per
    destination is one ``reduceat`` an iteration."""
    src, dst = g.edge_arrays()
    order = np.argsort(dst, kind="stable")
    ds = dst[order]
    starts = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]]) \
        if ds.size else np.zeros(0, np.int64)
    return src[order], order, starts, ds[starts]


def reference_sssp_batched(g: Graph, sources,
                           weighted: bool = False) -> np.ndarray:
    """NumPy k-source Bellman-Ford oracle -> [nv, B] (int64 hops or
    float64 distances).  Each iteration relaxes every edge for every
    column and takes each destination's minimum with one
    ``np.minimum.reduceat`` over the destination-sorted edges: the
    reference's ``np.minimum.at`` updates (lux_tpu/apps/sssp.py:322),
    whose result does not depend on the order of a minimum, so column q
    is ``reference_sssp(g, sources[q])`` bit for bit."""
    src, order, starts, dsts = _by_dst(g)
    B = len(sources)
    if weighted:
        w = np.asarray(g.weights, dtype=np.float64)[order][:, None]
        dist = np.full((g.nv, B), np.inf)
    else:
        w = np.ones((src.size, 1), dtype=np.int64)
        dist = np.full((g.nv, B), int(HOP_INF), dtype=np.int64)
    for q, s in enumerate(sources):
        dist[int(s), q] = 0
    if not src.size:
        return dist
    while True:
        red = np.minimum.reduceat(dist[src] + w, starts, axis=0)
        new = dist.copy()
        new[dsts] = np.minimum(new[dsts], red)
        if np.array_equal(new, dist):
            return dist
        dist = new
