"""Connected components by max-label propagation on the push engine
(counterpart of lux_tpu/apps/components.py:20-126): every vertex
starts active with its own id; each iteration a destination takes the
max label over its in-neighbours, until no label changes.  On a
symmetrized graph each component converges to its largest vertex id.
``make_batched_program`` / ``build_engine(sources=)`` run seeded
components over a query batch: column q labels the vertices reachable
from seed q with the seed's id, -1 elsewhere.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.push import PushEngine, PushProgram
from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph


def make_program() -> PushProgram:
    def relax(src_label, w):
        return src_label

    def init(sg: ShardedGraph):
        labels = np.arange(sg.nv, dtype=np.int32)
        active = np.ones(sg.nv, dtype=bool)
        return sg.to_padded(labels), sg.to_padded(active)

    return PushProgram(reduce="max", relax=relax, identity=np.int32(-1),
                       init=init, name="components")


def make_batched_program(seeds) -> PushProgram:
    """Batched seeded components: labels [P, vpad, B] whose column q is
    the propagation from the single seed ``seeds[q]`` (the seed's id
    where reachable from it, -1 elsewhere).  One label gather an
    iteration serves every query; max fixed points are unique, so each
    column equals the single-seed run bit for bit."""
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("seeds must name at least one query")
    B = len(seeds)

    def relax(src_label, w):
        return src_label

    def init(sg: ShardedGraph):
        for s in seeds:
            if not 0 <= s < sg.nv:
                raise ValueError(
                    f"seed vertex {s} out of range [0, {sg.nv})")
        labels = np.full((sg.nv, B), -1, dtype=np.int32)
        active = np.zeros((sg.nv, B), dtype=bool)
        for q, s in enumerate(seeds):
            labels[s, q] = s
            active[s, q] = True
        return sg.to_padded(labels), sg.to_padded(active)

    return PushProgram(reduce="max", relax=relax, identity=np.int32(-1),
                       init=init, name="cc_seeded", batch=B)


def build_engine(g: Graph, num_parts: int = 1, mesh=None,
                 sg: ShardedGraph | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 starts=None, exchange: str = "auto", gather: str = "flat",
                 enable_sparse: bool = True, use_mxu: bool | str = "auto",
                 health: bool = False, sources=None,
                 audit: str | None = None, *,
                 device=None) -> PushEngine:
    """Components engine on ``device`` (None = the card; "cpu" when
    asked).  ``pair_threshold``: pair-lane delivery on dense iterations
    (after graph.pair_relabel, passing its ``starts``; labels are then
    relabelled ids).  ``sources=[a, b, ...]`` builds the query-batched
    seeded engine (``make_batched_program``); pair_threshold must be
    off then."""
    dev = resolve_device(device)
    if sg is None:
        sg = ShardedGraph.build(
            g, num_parts, starts=starts, pair_threshold=pair_threshold,
            vpad_align=128 if gather != "flat" else VPAD_ALIGN)
    program = (make_program() if sources is None
               else make_batched_program(sources))
    return PushEngine(sg, program, device=dev, mesh=mesh,
                      pair_threshold=pair_threshold,
                      pair_min_fill=pair_min_fill, exchange=exchange,
                      gather=gather, enable_sparse=enable_sparse,
                      use_mxu=use_mxu, health=health, audit=audit)


def run(g: Graph, num_parts: int = 1, mesh=None, max_iters=None,
        verbose: bool = False, *, device=None):
    """Returns (labels [nv], iterations)."""
    eng = build_engine(g, num_parts, mesh, device=device)
    return eng.run(max_iters=max_iters, verbose=verbose)


def symmetrize(src, dst, weights=None):
    """Add reverse edges — CC semantics expect an undirected graph."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    if weights is not None:
        return s, d, np.concatenate([weights, weights])
    return s, d


def reference_components(g: Graph) -> np.ndarray:
    """NumPy oracle: max-propagation to its fixed point (int64)."""
    src, dst = g.edge_arrays()
    labels = np.arange(g.nv, dtype=np.int64)
    while True:
        new = labels.copy()
        np.maximum.at(new, dst, labels[src])
        if np.array_equal(new, labels):
            return labels
        labels = new


def reference_components_batched(g: Graph, seeds) -> np.ndarray:
    """NumPy seeded-propagation oracle -> [nv, B] int64 labels: column
    q is ``seeds[q]`` where the vertex is reachable from the seed, -1
    elsewhere.  Each iteration takes each destination's maximum with
    one ``np.maximum.reduceat`` over the destination-sorted edges (the
    reference's ``np.maximum.at``, lux_tpu/apps/components.py:203,
    whose result does not depend on the order of a maximum)."""
    from lux_tpu_torch.apps.sssp import _by_dst
    src, _order, starts, dsts = _by_dst(g)
    labels = np.full((g.nv, len(seeds)), -1, dtype=np.int64)
    for q, s in enumerate(seeds):
        labels[int(s), q] = int(s)
    if not src.size:
        return labels
    while True:
        red = np.maximum.reduceat(labels[src], starts, axis=0)
        new = labels.copy()
        new[dsts] = np.maximum(new[dsts], red)
        if np.array_equal(new, labels):
            return labels
        labels = new
