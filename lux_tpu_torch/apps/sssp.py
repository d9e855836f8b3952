"""Single-source shortest paths on the push engine (counterpart of
lux_tpu/apps/sssp.py:27-31, :103-195), with the same two modes:

- ``hops`` (default): hop counts, candidate = dist[src] + 1 — the
  reference's "SSSP", which never reads edge weights;
- ``weighted``: float32 distances, candidate = dist[src] + w.

Unreachable vertices keep the sentinel (``HOP_INF`` or ``DIST_INF``);
``unreachable`` masks them.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.push import PushEngine, PushProgram, _refuse
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
    graph.pair_relabel, passing its ``starts``).  ``sources=`` (the query-batched engine) is not
    ported (ROADMAP A7)."""
    dev = resolve_device(device)
    if weighted and g.weights is None:
        raise ValueError("weighted SSSP needs a weighted graph")
    if sources is not None:
        _refuse("query-batched SSSP (sources=)", "A7")
    if start_vertex is None:
        raise ValueError("single-query SSSP needs start_vertex")
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
