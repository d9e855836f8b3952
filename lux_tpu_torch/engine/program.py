"""Vertex-program abstraction (counterpart of
lux_tpu/engine/program.py:21-109).

A vertex program is a small bundle of functions over tensors.  The
port runs every part at once — parts are a leading batch dimension
written out — so the callbacks see stacked arrays: state ``[P, vpad,
...]``, per-edge values ``[P*C, E]`` (tiled) or ``[P, epad]`` (flat).
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
    """
    deg: Any
    vmask: Any
    nv: int
    ne: int


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
    apply       (old [P, vpad], reduced [P, vpad], ctx: PartCtx) ->
                new [P, vpad]; the per-vertex epilogue.
    init        (sharded_graph) -> initial padded state [P, vpad]
                (numpy).
    needs_dst   whether edge_value reads dst_val (not ported yet).
    state_bytes bytes per vertex of the iterated state; feeds the
                exchange='auto' table-size estimate (None -> 4).
    name        optional app label.
    """
    reduce: str
    edge_value: Callable
    apply: Callable
    init: Callable
    needs_dst: bool = False
    state_bytes: int | None = None
    name: str | None = None
