"""PageRank (pull model, fixed iteration count) — counterpart of
lux_tpu/apps/pagerank.py:26-241, with the same semantics:

- ALPHA = 0.15 used as ``pr = (1-ALPHA)/nv + ALPHA * sum`` — the
  damping factor is 0.15, not the usual 0.85 (kept for parity with the
  reference);
- the state is the degree-normalized rank: after each update the rank
  is divided by the out-degree (deg == 0 keeps it), and init seeds
  ``(1/nv)/deg``.  ``true_ranks`` un-scales it.

``make_batched_program`` / ``build_engine(sources=, resets=)`` run
personalized PageRank over a query batch: state [P, vpad, B], one
column per reset distribution, ``pr = (1-ALPHA) * reset_q + ALPHA *
sum`` per column.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.pull import PullEngine
from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph

ALPHA = 0.15


def make_program(dtype=np.float32) -> PullProgram:
    """Classic PageRank with state in ``dtype``: float32, or float64 on
    the flat layout (kernel B1, and so the tiled layout, takes float32
    and int32)."""
    dtype = np.dtype(dtype)

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
        return state.astype(dtype)

    return PullProgram(reduce="sum", edge_value=edge_value, apply=apply,
                       init=init, needs_dst=False,
                       state_bytes=dtype.itemsize, name="pagerank")


def one_hot_resets(nv: int, sources) -> np.ndarray:
    """[nv, B] reset matrix whose column q is the one-hot distribution
    of ``sources[q]``."""
    sources = [int(s) for s in sources]
    resets = np.zeros((nv, len(sources)), dtype=np.float32)
    for q, s in enumerate(sources):
        if not 0 <= s < nv:
            raise ValueError(f"source vertex {s} out of range [0, {nv})")
        resets[s, q] = 1.0
    return resets


def make_batched_program(resets, dtype=np.float32) -> PullProgram:
    """Personalized PageRank over a query batch: state [P, vpad, B] of
    degree-normalized ranks, one column per reset distribution
    ``resets`` [nv, B] (the uniform column 1/nv is classic PageRank).
    The resets ride ``extra_arrays`` (``ctx.extra["reset"]``), so the
    serving layer swaps a retired column's reset in place
    (PullEngine.update_program_arrays); ``deg_corr`` [nv, B] is the
    reference's per-column out-degree correction for live graphs, zero
    here (adding 0.0 keeps every bit).  ``state_bytes = 4 B``."""
    dtype = np.dtype(dtype)
    resets = np.asarray(resets, dtype=dtype)
    if resets.ndim != 2:
        raise ValueError(f"resets must be [nv, B], got {resets.shape}")
    B = resets.shape[1]

    def edge_value(src_val, dst_val, weight):
        return src_val

    def apply(old, red, ctx):
        pr = (1.0 - ALPHA) * ctx.extra["reset"] + ALPHA * red
        deg = ctx.deg.to(pr.dtype)[..., None] + ctx.extra["deg_corr"]
        return torch.where(deg > 0, pr / deg.clamp(min=1), pr)

    def init(sg: ShardedGraph):
        if resets.shape[0] != sg.nv:
            raise ValueError(f"resets rows {resets.shape[0]} != nv "
                             f"{sg.nv}")
        deg = np.asarray(sg.deg_padded)[..., None]
        r = sg.to_padded(resets)
        return np.where(deg > 0, r / np.maximum(deg, 1), r).astype(dtype)

    def extra_arrays(sg: ShardedGraph):
        return {"reset": sg.to_padded(resets),
                "deg_corr": sg.to_padded(np.zeros(resets.shape, dtype))}

    return PullProgram(reduce="sum", edge_value=edge_value, apply=apply,
                       init=init, needs_dst=False,
                       state_bytes=dtype.itemsize * B, name="ppr",
                       extra_arrays=extra_arrays, batch=B)


def build_engine(g: Graph, num_parts: int = 1, *, device=None,
                 sg: ShardedGraph | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 starts=None, tile_e: int | None = None,
                 layout: str = "tiled", exchange: str = "auto",
                 gather: str = "flat", mesh=None, sources=None,
                 resets=None, dtype=np.float32) -> PullEngine:
    """PageRank engine on ``device`` (None = the card; "cpu" when
    asked).  ``sg`` is a prebuilt layout of ``g``; without it the
    layout is built here, with ``starts`` as its cut points (e.g. from
    graph.pair_relabel) and the 128-aligned vertex padding that
    ``gather="paged"|"pagemajor"`` and pair-lane delivery need.
    ``pair_threshold`` / ``pair_min_fill`` / ``pair_stream``: pair-lane
    delivery (engine.pull.PullEngine).  ``tile_e``, the chunk width,
    defaults to 128 with pairs (the residual edges are sparse) and 512
    without, as in the reference.  Options the port does not carry yet
    (owner, gather="auto", mesh, min_fill="auto") raise
    engine.pull.NotPortedError.

    ``sources=[a, b, ...]`` builds the query-batched personalized
    engine with one-hot resets (state [P, vpad, B], one gather serving
    every query); ``resets`` [nv, B] passes arbitrary per-query reset
    distributions instead.  Batched engines refuse pair_threshold
    (pair rows read scalar state)."""
    if sources is not None and resets is not None:
        raise ValueError("pass sources=[...] OR resets=[nv, B], "
                         "not both")
    dev = resolve_device(device)
    if sources is not None:
        resets = one_hot_resets(g.nv, sources)
    if sg is None:
        sg = ShardedGraph.build(g, num_parts, starts=starts,
                                pair_threshold=pair_threshold,
                                vpad_align=128 if gather != "flat"
                                else VPAD_ALIGN)
    if tile_e is None:
        tile_e = 128 if pair_threshold is not None else 512
    program = (make_program(dtype) if resets is None
               else make_batched_program(resets, dtype))
    return PullEngine(sg, program, device=dev, layout=layout,
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


def reference_pagerank_batched(g: Graph, resets,
                               num_iters: int) -> np.ndarray:
    """float64 NumPy personalized-PageRank oracle -> [nv, B]
    degree-normalized ranks, one column per reset vector.  Each column
    sums its in-edges by ``np.bincount`` as ``reference_pagerank`` does,
    so a uniform 1/nv column reproduces it exactly."""
    src, dst = g.edge_arrays()
    resets = np.asarray(resets, dtype=np.float64)
    deg = g.out_degrees.astype(np.float64)[:, None]
    state = np.where(deg > 0, resets / np.maximum(deg, 1), resets)
    for _ in range(num_iters):
        acc = np.stack([np.bincount(dst, weights=state[src, q],
                                    minlength=g.nv)
                        for q in range(state.shape[1])], axis=1)
        pr = (1.0 - ALPHA) * resets + ALPHA * acc
        state = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
    return state
