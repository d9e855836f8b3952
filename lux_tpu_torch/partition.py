"""Edge-balanced contiguous vertex partitioning (counterpart of
lux_tpu/partition.py:20 and :108).

Cut point p is the smallest vertex whose cumulative in-edge count
reaches ``p * ne / num_parts`` — a quantile search over the CSC
end-offset array, with fix-ups so every part keeps a vertex.
"""

from __future__ import annotations

import numpy as np


def edge_balanced_bounds(row_ptrs, num_parts: int) -> np.ndarray:
    """Cut points ``starts`` [num_parts + 1]: part p owns vertices
    [starts[p], starts[p+1]); starts[0] == 0 and starts[-1] == nv."""
    row_ptrs = np.asarray(row_ptrs)
    nv = row_ptrs.shape[0]
    if num_parts < 1:
        raise ValueError("num_parts must be >= 1")
    if num_parts > nv:
        raise ValueError(f"num_parts={num_parts} exceeds nv={nv}")
    ne = int(row_ptrs[-1]) if nv else 0
    targets = (np.arange(1, num_parts) * ne) // num_parts
    cuts = np.searchsorted(row_ptrs, targets, side="left") + 1
    starts = np.empty(num_parts + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:num_parts] = cuts
    starts[num_parts] = nv
    # degenerate distributions can make cuts collide or run past nv;
    # keep them strictly monotone (feasible because num_parts <= nv)
    for p in range(1, num_parts):
        if starts[p] <= starts[p - 1]:
            starts[p] = starts[p - 1] + 1
    for p in range(num_parts - 1, 0, -1):
        if starts[p] >= starts[p + 1]:
            starts[p] = starts[p + 1] - 1
    if starts[0] != 0 or starts[num_parts] != nv:
        raise ValueError(f"partition cut points {starts} do not span "
                         f"[0, {nv}]")
    return starts


def part_edge_counts(row_ptrs, starts) -> np.ndarray:
    """Edges owned by each part (in-edges of its vertex range)."""
    row_ptrs = np.asarray(row_ptrs)
    ends = row_ptrs[np.asarray(starts[1:]) - 1].astype(np.int64)
    begins = np.empty_like(ends)
    begins[0] = 0
    begins[1:] = ends[:-1]
    return ends - begins
