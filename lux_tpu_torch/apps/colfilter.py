"""Collaborative filtering: matrix-factorization SGD on a weighted graph
(pull model, fixed iterations) — counterpart of
lux_tpu/apps/colfilter.py, with the same semantics:

- the state is a K = 20 latent-factor vector a vertex, initialised to
  sqrt(1/K);
- per iteration, for each vertex d with in-edges (s -> d, rating w):

      err_e  = w - <old[s], old[d]>
      acc[d] = sum_e err_e * old[s]
      new[d] = old[d] + GAMMA * (acc[d] - LAMBDA * old[d])

  LAMBDA regularizes once a vertex, not once an edge, as in the
  reference.

The engine computes the dot <old[s], old[d]> through
``edge_value_from_dot`` on the tiled layout, pair rows and paged rows
(engine/pull.py), and through ``edge_value`` with a per-edge
destination gather on the flat layout.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.pull import PullEngine
from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph
from lux_tpu_torch.parallel.mesh import mesh_device

K = 20              # reference col_filter/app.h:28
LAMBDA = 0.001      # reference col_filter/app.h:26
GAMMA = 0.00000035  # reference col_filter/app.h:27


def make_program(k: int = K, lam: float = LAMBDA,
                 gamma: float = GAMMA) -> PullProgram:
    def edge_value(src_val, dst_val, weight):
        # the rating error per edge, then its gradient to the dst
        err = weight - (src_val * dst_val).sum(dim=-1)
        return err[..., None] * src_val

    def edge_value_from_dot(src_val, dot, weight):
        return (weight - dot)[..., None] * src_val

    def apply(old, red, ctx):
        return old + gamma * (red - lam * old)

    def init(sg: ShardedGraph):
        val = np.sqrt(1.0 / k).astype(np.float32)
        return np.full((sg.num_parts, sg.vpad, k), val, dtype=np.float32)

    return PullProgram(reduce="sum", edge_value=edge_value, apply=apply,
                       init=init, needs_dst=True,
                       edge_value_from_dot=edge_value_from_dot,
                       state_bytes=4 * k, name="colfilter")


def build_engine(g: Graph, num_parts: int = 1, *, device=None,
                 sg: ShardedGraph | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 starts=None, tile_e: int | None = None,
                 layout: str = "tiled", gather: str = "flat",
                 dot_block_chunks: int | None = None,
                 dot_block_rows: int | None = None,
                 use_mxu: bool | str = "auto", health: bool = False,
                 audit: str | None = None, mesh=None) -> PullEngine:
    """float32 ColFilter engine on ``device`` (None = the card; "cpu"
    when asked).  ``sg`` is a prebuilt layout of ``g``; without it the
    layout is built here with ``starts`` as its cut points (e.g. from
    graph.pair_relabel) and the 128-aligned vertex padding that
    ``gather="paged"`` and pair rows need.  ``tile_e`` defaults to 128
    with pairs and 512 without, as in the reference;
    ``dot_block_chunks`` / ``dot_block_rows`` size the dot path's
    blocks (engine.pull.PullEngine).  ``health=True`` runs the
    watchdog variants (lux_tpu_torch/health.py).  ``use_mxu=True``
    runs the segmented combine as matmuls (the dot path's one-hot
    reduce is a ``torch.bmm`` either way); ``"auto"`` resolves through
    scalemodel at K = 20, as does ``pair_min_fill="auto"``.
    ``audit="warn"|"error"`` audits every program variant at build time
    (lux_tpu_torch/audit.py).  ``mesh``: run as this rank of a parts
    mesh (engine.pull.PullEngine); gather 'pagemajor' raises the
    reference's ValueError."""
    dev = (resolve_device(device) if mesh is None
           else mesh_device(mesh, device))
    if g.weights is None:
        raise ValueError("collaborative filtering needs a weighted graph")
    if sg is None:
        sg = ShardedGraph.build(g, num_parts, starts=starts,
                                pair_threshold=pair_threshold,
                                vpad_align=128 if gather != "flat"
                                else VPAD_ALIGN)
    if tile_e is None:
        tile_e = 128 if pair_threshold is not None else 512
    return PullEngine(sg, make_program(), device=dev, layout=layout,
                      tile_e=tile_e, gather=gather,
                      pair_threshold=pair_threshold,
                      pair_min_fill=pair_min_fill, pair_stream=pair_stream,
                      dot_block_chunks=dot_block_chunks,
                      dot_block_rows=dot_block_rows, mesh=mesh,
                      health=health, use_mxu=use_mxu, audit=audit)


def run(g: Graph, num_iters: int, num_parts: int = 1, *,
        device=None, **engine_kw) -> np.ndarray:
    """Run ColFilter; returns the latent factors [nv, K] (host).
    ``engine_kw`` go to ``build_engine``."""
    eng = build_engine(g, num_parts, device=device, **engine_kw)
    return eng.unpad(eng.run(eng.init_state(), num_iters))


def reference_colfilter(g: Graph, num_iters: int, k: int = K,
                        state: np.ndarray | None = None) -> np.ndarray:
    """float64 NumPy oracle with identical semantics, from the uniform
    init or from ``state`` [nv, k].  Each destination's gradient sum is
    a ``np.bincount`` a factor column (the reference's ``np.add.at``
    sums the same terms), fast enough at millions of edges."""
    src, dst = g.edge_arrays()
    w = np.asarray(g.weights, dtype=np.float64)
    if state is None:
        state = np.full((g.nv, k), np.sqrt(1.0 / k), dtype=np.float64)
    state = np.asarray(state, np.float64)
    for _ in range(num_iters):
        s = state[src]
        err = w - np.einsum("ek,ek->e", s, state[dst])
        s *= err[:, None]
        acc = np.stack([np.bincount(dst, weights=s[:, j], minlength=g.nv)
                        for j in range(state.shape[1])], axis=1)
        state = state + GAMMA * (acc - LAMBDA * state)
    return state


def reduced_int64(g: Graph, state: np.ndarray) -> np.ndarray:
    """Exact int64 gradient sums acc[d] = sum_e (w - <s, d>) * s over
    the in-edges of each d, for an integer-valued ``state`` [nv, k] and
    integer weights — what the engine's ``reduced`` must equal bit for
    bit while every partial sum stays under 2^24."""
    src, dst = g.edge_arrays()
    st = np.asarray(state).astype(np.int64)
    w = np.asarray(g.weights).astype(np.int64)
    s = st[src]
    s *= (w - np.einsum("ek,ek->e", s, st[dst]))[:, None]
    out = np.zeros_like(st)
    # edge_arrays is dst-sorted (CSR): one reduceat over each
    # destination's run of edges
    cnt = np.bincount(dst, minlength=g.nv)
    starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    live = cnt > 0
    if live.any():
        out[live] = np.add.reduceat(s, starts[live], axis=0)
    return out


def rmse(g: Graph, state: np.ndarray) -> float:
    """Root-mean-square rating prediction error over all edges."""
    src, dst = g.edge_arrays()
    state = np.asarray(state, np.float64)
    pred = np.einsum("ek,ek->e", state[src], state[dst])
    err = np.asarray(g.weights, dtype=np.float64) - pred
    return float(np.sqrt(np.mean(err * err)))


def to_state(eng: PullEngine, user: np.ndarray) -> torch.Tensor:
    """A host [nv, K] state in the engine's graph order as the padded
    [P, vpad, K] tensor on the engine's device."""
    return torch.as_tensor(eng.sg.to_padded(
        np.asarray(user, np.float32))).to(eng.device)
