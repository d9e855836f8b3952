"""Connected components by max-label propagation on the push engine
(counterpart of lux_tpu/apps/components.py:20-126): every vertex
starts active with its own id; each iteration a destination takes the
max label over its in-neighbours, until no label changes.  On a
symmetrized graph each component converges to its largest vertex id.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.push import PushEngine, PushProgram, _refuse
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
    relabelled ids).  ``sources=``
    (seeded, query-batched components) is not ported (ROADMAP A7)."""
    dev = resolve_device(device)
    if sources is not None:
        _refuse("query-batched seeded components (sources=)", "A7")
    if sg is None:
        sg = ShardedGraph.build(
            g, num_parts, starts=starts, pair_threshold=pair_threshold,
            vpad_align=128 if gather != "flat" else VPAD_ALIGN)
    return PushEngine(sg, make_program(), device=dev, mesh=mesh,
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
