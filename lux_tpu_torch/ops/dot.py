"""The blocked-SDDMM step shared by every dot-path delivery (counterpart
of the block bodies of lux_tpu/engine/pull.py:681-697,
lux_tpu/ops/pairs.py:895-905 and lux_tpu/ops/pagegather.py:1184-1204).

A program whose destination dependence is only the inner product
<src, dst> (``PullProgram.edge_value_from_dot``, colfilter's rating
error) never gathers destination state per edge.  A block of B delivery
units — tiled chunks of E edges, or pair / paged rows of 128 lanes —
carries its source rows S [B, E, K] and the state of the destination
TILE it writes to, T [B, W, K], and then:

    D        = S @ T^T                 [B, E, W]  every (edge, lane) dot
    dot[e]   = D[e, rel[e]]            the edge's own destination lane
    msgs     = msg_dot_fn(S, dot, w)   [B, E, K]
    partial  = onehot(rel)^T @ msgs    [B, W, K]  the per-lane sums

D and the one-hot reduce are ``torch.bmm`` (cuBLAS on the card, full
f32: the package never enables TF32), the lane select an index
``gather``.  Nothing here scatters, so two runs give the same bits.
Dead lanes (rel outside [0, W), -1 in the layouts) get dot 0 and match
no output lane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# the reference's shared streaming budget (lux_tpu/ops/tiled.py:535):
# the monolithic pair dot stacks f32 [parts, Rp, 128, K] row partials,
# and past this many bytes the engine streams them instead
STREAM_MSG_BYTES = 1 << 30

# bytes of the f32 [B, E, W] intermediate D a block of every dot
# delivery (and the streamed pair dot's live bytes a block, a part).
# Measured by chip_smoke.py's colfilter phase on an H100 80GB HBM3 at
# 700 W, bench.py's colfilter config (PERF.md §6): the reference's TPU
# blocks (128 chunks, 256 rows, 64 MB) leave the step host bound at
# 35-245 ms; blocks of 256 MB, 1 GB and 4 GB of D took 21.2 / 20.3 /
# 20.2 ms without pairs and 27.7 / 26.6 / 26.3 with pair rows, 4 GB at
# 2.5-3.6x the peak memory of 1 GB
DOT_BLOCK_BYTES = 1 << 30


def onehot_sum(msgs: torch.Tensor, rel: torch.Tensor, W: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane sums of vector messages: ``msgs`` [B, E, K], ``rel``
    int [B, E] -> [B, W, K], ``out[b, w] = sum of msgs[b, e] over e
    with rel[b, e] == w`` (lanes outside [0, W) add nothing), as the
    one-hot matmul onehot(rel)^T @ msgs."""
    lanes = torch.arange(W, device=rel.device, dtype=rel.dtype)
    onehot = (rel.unsqueeze(-1) == lanes).to(msgs.dtype)    # [B, E, W]
    return torch.bmm(onehot.transpose(1, 2), msgs, out=out)


def lane_select(D: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Each edge's own dot: ``D`` [B, E, W], ``rel`` int [B, E] ->
    ``D[b, e, rel[b, e]]`` [B, E], 0 where rel is outside [0, W)."""
    W = D.shape[-1]
    idx = rel.to(torch.int64)
    live = (idx >= 0) & (idx < W)
    dot = torch.gather(D, 2, idx.clamp(0, W - 1).unsqueeze(-1))
    return torch.where(live, dot.squeeze(-1),
                       torch.zeros((), dtype=D.dtype, device=D.device))


def dot_partials(S: torch.Tensor, T: torch.Tensor, rel: torch.Tensor,
                 weight: torch.Tensor, msg_dot_fn,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One SDDMM block: ``S`` [B, E, K] source rows, ``T`` [B, W, K]
    each unit's destination tile, ``rel`` int8 [B, E] destination
    lanes, ``weight`` [B, E] -> [B, W, K] partial sums (into ``out``
    when given, a contiguous [B, W, K] tensor)."""
    dot = lane_select(torch.bmm(S, T.transpose(1, 2)), rel)  # D [B, E, W]
    msgs = msg_dot_fn(S, dot, weight)                        # [B, E, K]
    return onehot_sum(msgs, rel, T.shape[1], out=out)


def blocks(n: int, size: int):
    """(start, length) of consecutive blocks of ``size`` over ``n``."""
    size = max(1, int(size))
    return [(i, min(size, n - i)) for i in range(0, n, size)]


@dataclasses.dataclass(frozen=True)
class DotBlock:
    """One block of a dot delivery: ``fetch()`` -> (S [m, E, K] source
    rows, T [m, W, K] destination tiles), the block's ``rel`` and
    ``weight`` [m, E], and ``units``, its slice of the stacked
    [units, W, K] partials."""

    fetch: Callable
    rel: torch.Tensor
    weight: torch.Tensor
    units: slice

    def partials(self, msg_dot_fn, out=None) -> torch.Tensor:
        S, T = self.fetch()
        return dot_partials(S, T, self.rel, self.weight, msg_dot_fn,
                            out=out)


def run_blocks(dot_blocks, msg_dot_fn, out: torch.Tensor) -> torch.Tensor:
    """Every block's partials into its units of ``out`` [units, W, K]."""
    for b in dot_blocks:
        b.partials(msg_dot_fn, out=out[b.units])
    return out
