"""PageRank (pull model, fixed iteration count) — counterpart of
lux_tpu/apps/pagerank.py:26-47 and :126-218, with the same semantics:

- ALPHA = 0.15 used as ``pr = (1-ALPHA)/nv + ALPHA * sum`` — the
  damping factor is 0.15, not the usual 0.85 (kept for parity with the
  reference);
- the state is the degree-normalized rank: after each update the rank
  is divided by the out-degree (deg == 0 keeps it), and init seeds
  ``(1/nv)/deg``.  ``true_ranks`` un-scales it.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.pull import PullEngine
from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph

ALPHA = 0.15


def make_program() -> PullProgram:
    def edge_value(src_val, dst_val, weight):
        return src_val

    def apply(old, red, ctx):
        pr = (1.0 - ALPHA) / ctx.nv + ALPHA * red
        deg = ctx.deg.to(pr.dtype)
        return torch.where(ctx.deg > 0, pr / deg.clamp(min=1), pr)

    def init(sg: ShardedGraph):
        rank = 1.0 / sg.nv
        deg = sg.deg_padded
        state = np.where(deg > 0, rank / np.maximum(deg, 1), rank)
        return state.astype(np.float32)

    return PullProgram(reduce="sum", edge_value=edge_value, apply=apply,
                       init=init, needs_dst=False, state_bytes=4,
                       name="pagerank")


def build_engine(g: Graph, num_parts: int = 1, *, device=None,
                 sg: ShardedGraph | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 starts=None, tile_e: int | None = None,
                 layout: str = "tiled", exchange: str = "auto",
                 gather: str = "flat", mesh=None) -> PullEngine:
    """float32 PageRank engine on ``device`` (None = the card; "cpu"
    when asked).  ``sg`` is a prebuilt layout of ``g``; without it the
    layout is built here, with ``starts`` as its cut points (e.g. from
    graph.pair_relabel) and the 128-aligned vertex padding that
    ``gather="paged"|"pagemajor"`` and pair-lane delivery need.
    ``pair_threshold`` / ``pair_min_fill`` / ``pair_stream``: pair-lane
    delivery (engine.pull.PullEngine).  ``tile_e``, the chunk width,
    defaults to 128 with pairs (the residual edges are sparse) and 512
    without, as in the reference.  Options the port does not carry yet
    (owner, gather="auto", mesh, min_fill="auto") raise
    engine.pull.NotPortedError."""
    dev = resolve_device(device)
    if sg is None:
        sg = ShardedGraph.build(g, num_parts, starts=starts,
                                pair_threshold=pair_threshold,
                                vpad_align=128 if gather != "flat"
                                else VPAD_ALIGN)
    if tile_e is None:
        tile_e = 128 if pair_threshold is not None else 512
    return PullEngine(sg, make_program(), device=dev, layout=layout,
                      tile_e=tile_e, exchange=exchange, gather=gather,
                      pair_threshold=pair_threshold,
                      pair_min_fill=pair_min_fill, pair_stream=pair_stream,
                      mesh=mesh)


def run(g: Graph, num_iters: int, num_parts: int = 1, *,
        device=None) -> np.ndarray:
    """Run PageRank; returns degree-normalized ranks [nv] (host)."""
    eng = build_engine(g, num_parts, device=device)
    return eng.unpad(eng.run(eng.init_state(), num_iters))


def run_until(g: Graph, tol: float = 1e-9, max_iters: int = 10000,
              num_parts: int = 1, *, device=None):
    """Iterate until the max-abs change of the degree-scaled rank state
    is <= tol.  Returns (ranks [nv], iterations)."""
    eng = build_engine(g, num_parts, device=device)
    state, it, _res = eng.run_until(eng.init_state(), tol, max_iters)
    return eng.unpad(state), it


def true_ranks(norm_ranks: np.ndarray, out_degrees: np.ndarray):
    """Undo the degree scaling: conventional PageRank values."""
    deg = np.asarray(out_degrees)
    return np.where(deg > 0, norm_ranks * np.maximum(deg, 1), norm_ranks)


def reference_pagerank(g: Graph, num_iters: int) -> np.ndarray:
    """float64 NumPy oracle with identical semantics (degree-normalized).
    ``np.bincount`` with weights sums each destination's in-edges like
    the reference oracle's ``np.add.at``, far faster at tens of
    millions of edges."""
    src, dst = g.edge_arrays()
    deg = g.out_degrees.astype(np.float64)
    state = np.where(deg > 0, (1.0 / g.nv) / np.maximum(deg, 1), 1.0 / g.nv)
    for _ in range(num_iters):
        acc = np.bincount(dst, weights=state[src], minlength=g.nv)
        pr = (1.0 - ALPHA) / g.nv + ALPHA * acc
        state = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
    return state
