"""Row-class machinery shared by the row-granular deliveries (the
paged gather here; pair-lane delivery later, ROADMAP A3) —
counterpart of lux_tpu/ops/pairs.py:118 ``quantize_depths`` and :709
``_class_combine``.

Delivery rows are grouped per destination tile and laid out in depth
classes: ``classes = [(count, depth), ...]`` holds ``count`` slots of
``depth`` consecutive rows each, deepest first.  A tile's rows reduce
with one static reshape-reduce per class; ``tile_pos`` then maps each
tile to its slot (tiles without rows point at a trailing identity
slot).
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.ops.segment import identity_for


def quantize_depths(depth_sorted: np.ndarray,
                    levels_growth: float = 1.35) -> np.ndarray:
    """Round a descending per-slot row-count profile up to the fixed
    depth ladder (0..8 then *levels_growth), bounding the number of
    distinct classes to O(log max_depth)."""
    levels = [0, 1, 2, 3, 4, 5, 6, 7, 8]
    v = 8
    while v < int(np.max(depth_sorted, initial=0)):
        v = int(v * levels_growth) + 1
        levels.append(v)
    lev = np.asarray(levels, np.int64)
    return lev[np.searchsorted(lev, depth_sorted)]


# NaN-propagating reductions over one axis (like jnp.sum/min/max)
_REDUCE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}


def class_combine(plan, partials: torch.Tensor, tile_pos: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """Per-class reshape-reduce of row partials, all parts at once:
    ``partials`` [P, R, W] (the plan's R real class rows of each part),
    ``tile_pos`` int [P, n_tiles] -> [P, n_tiles, W].  ``plan`` is
    anything with ``classes``.  int32 sums wrap like the reference's."""
    if kind not in _REDUCE:
        raise ValueError(f"unknown reduction {kind!r}")
    P, trail = partials.shape[0], tuple(partials.shape[2:])
    outs, row0 = [], 0
    for cnt, L in plan.classes:
        blk = partials[:, row0:row0 + cnt * L].reshape((P, cnt, L) + trail)
        if kind == "sum":
            outs.append(blk.sum(dim=2, dtype=partials.dtype))
        else:
            outs.append(_REDUCE[kind](blk, dim=2))
        row0 += cnt * L
    outs.append(torch.full((P, 1) + trail,
                           identity_for(kind, partials.dtype),
                           dtype=partials.dtype, device=partials.device))
    slots = torch.cat(outs, dim=1)                   # [P, n_slots + 1, W]
    idx = tile_pos.to(torch.int64).reshape(
        tile_pos.shape + (1,) * len(trail)).expand(
        tuple(tile_pos.shape) + trail)
    return torch.gather(slots, 1, idx)
