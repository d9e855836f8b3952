"""Edge-balanced contiguous vertex partitioning and the push engine's
queue sizing (counterpart of lux_tpu/partition.py:20, :58, :108 and
:118).

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


def weighted_balanced_bounds(cost_ptrs, num_parts: int,
                             align: int = 1) -> np.ndarray:
    """Cut points balancing an arbitrary per-vertex cumulative cost
    (``cost_ptrs[v]`` = total cost through vertex v, END offsets like
    row_ptrs); ``edge_balanced_bounds`` is the case cost = in-degree.
    ``align > 1`` rounds interior cuts to multiples of ``align`` (128
    keeps every part tile-aligned), falling back to 1 when num_parts *
    align > nv."""
    cost_ptrs = np.asarray(cost_ptrs)
    nv = cost_ptrs.shape[0]
    if num_parts < 1:
        raise ValueError("num_parts must be >= 1")
    if num_parts > nv:
        raise ValueError(f"num_parts={num_parts} exceeds nv={nv}")
    if align > 1 and num_parts * align > nv:
        align = 1
    total = float(cost_ptrs[-1]) if nv else 0.0
    targets = np.arange(1, num_parts) * (total / num_parts)
    cuts = np.searchsorted(cost_ptrs, targets, side="left") + 1
    if align > 1:
        cuts = np.round(cuts / align).astype(np.int64) * align
    starts = np.empty(num_parts + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:num_parts] = cuts
    starts[num_parts] = nv
    # the fix-ups of edge_balanced_bounds, stepping by ``align`` where
    # feasible (alignment is an optimisation, not a requirement)
    for p in range(1, num_parts):
        if starts[p] <= starts[p - 1]:
            starts[p] = starts[p - 1] + align
    for p in range(num_parts - 1, 0, -1):
        if starts[p] >= starts[p + 1]:
            starts[p] = starts[p + 1] - (align if starts[p + 1] % align
                                         == 0 else 1)
    starts[1:num_parts] = np.clip(starts[1:num_parts], 1, nv - 1)
    for p in range(1, num_parts):
        if starts[p] <= starts[p - 1]:
            starts[p] = starts[p - 1] + 1
    if starts[0] != 0 or starts[num_parts] != nv or (
            np.diff(starts) <= 0).any():
        raise ValueError(f"partition cut points {starts} do not split "
                         f"[0, {nv}] into non-empty parts")
    return starts


def part_edge_counts(row_ptrs, starts) -> np.ndarray:
    """Edges owned by each part (in-edges of its vertex range)."""
    row_ptrs = np.asarray(row_ptrs)
    ends = row_ptrs[np.asarray(starts[1:]) - 1].astype(np.int64)
    begins = np.empty_like(ends)
    begins[0] = 0
    begins[1:] = ends[:-1]
    return ends - begins


def frontier_capacity(part_nv: int, sparse_threshold: int = 16,
                      slack: int = 100) -> int:
    """Sparse-frontier queue slots of a part: the reference's sizing
    rule ``part_nv / SPARSE_THRESHOLD + 100`` (push_model.inl:393-397)."""
    return part_nv // sparse_threshold + slack
