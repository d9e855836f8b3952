"""Vertex-program abstraction (counterpart of
lux_tpu/engine/program.py:21-109).

A vertex program is a small bundle of functions over tensors.  The
port runs every part at once — parts are a leading batch dimension
written out — so the callbacks see stacked arrays: state ``[P, vpad,
...]``, per-edge values ``[P*C, E, ...]`` (tiled) or ``[P, epad, ...]``
(flat).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class PartCtx:
    """Context handed to ``apply`` (all parts stacked).

    deg    int32 [P, vpad]  out-degrees (the reference's VERTEX_DEGREE)
    vmask  bool  [P, vpad]  True for real (non-padding) vertex slots
    nv     int              global vertex count
    ne     int              global edge count
    extra  dict | None      the program's ``extra_arrays`` on the
                            device, [P, vpad, ...] each (query-batch
                            arrays such as personalized PageRank's
                            reset vectors)
    """
    deg: Any
    vmask: Any
    nv: int
    ne: int
    extra: Any = None


def vmask_of(g: dict, vpad: int) -> torch.Tensor:
    """Valid-vertex mask from the per-part counts ``nvp`` [P, 1]
    (one int32 per part instead of a [P, vpad] bool array)."""
    nvp = g["nvp"]
    return torch.arange(vpad, dtype=torch.int32, device=nvp.device) < nvp


@dataclasses.dataclass(frozen=True)
class PullProgram:
    """Dense gather-apply program (the reference's pull model).

    reduce      'sum' | 'min' | 'max' — how edge messages combine per
                destination.
    edge_value  (src_val, dst_val, weight|None) -> msg, per edge.
    apply       (old [P, vpad, ...], reduced [P, vpad, ...], ctx:
                PartCtx) -> new [P, vpad, ...]; the per-vertex
                epilogue.
    init        (sharded_graph) -> initial padded state [P, vpad, ...]
                (numpy).
    needs_dst   whether edge_value reads dst_val (the engine then
                gathers each edge's destination state too).
    edge_value_from_dot
                optional (src_val [..., K], dot [...], weight [...]) ->
                msg [..., K], for programs whose destination dependence
                is only the inner product <src, dst> (colfilter's
                rating error).  With the tiled layout, pair rows or
                paged rows the engine then computes every dot from the
                destination TILE by batched matmuls instead of a
                per-edge destination gather (engine/pull.py
                ``dot_partials``); needs reduce 'sum' and a weighted
                graph.
    state_bytes bytes per vertex of the iterated state (itemsize x
                trailing dims, 4 * K for a [vpad, K] f32 state); feeds
                the exchange='auto' table-size estimate and the
                streamed dot rule (None -> 4).
    name        optional app label.
    extra_arrays
                optional (sharded_graph) -> {name: [P, vpad, ...]
                numpy}: per-part constants the apply epilogue needs
                beyond deg/vmask.  The engine binds each as graph array
                ``prog_<name>`` and hands them to ``apply`` as
                ``ctx.extra``; ``PullEngine.update_program_arrays``
                swaps them in place (same shape and dtype) — the
                serving layer's refill path.
    batch       query-batch width B when the state carries a trailing
                query axis [P, vpad, B] (None = one query).  One
                state-table gather then serves all B queries.
    """
    reduce: str
    edge_value: Callable
    apply: Callable
    init: Callable
    needs_dst: bool = False
    edge_value_from_dot: Callable | None = None
    state_bytes: int | None = None
    name: str | None = None
    extra_arrays: Callable | None = None
    batch: int | None = None
