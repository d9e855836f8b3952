"""Reduce identities and the flat-layout segment reduction (counterpart
of lux_tpu/ops/segment.py:26 and :41).

``segment_reduce`` is the flat layout's oracle: a scatter-reduce of
per-edge messages into their destination rows.  The tiled layout
(ops/tiled.py) computes the same function without scattering.
"""

from __future__ import annotations

import torch

# torch's scatter_reduce names for the three reduce kinds
SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity_for(kind: str, dtype: torch.dtype):
    """The reduce identity as a Python scalar: 0 for sum; +inf or the
    integer max for min; -inf or the integer min for max."""
    if kind == "sum":
        return 0
    if kind not in ("min", "max"):
        raise ValueError(f"unknown reduction {kind!r}")
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce(vals: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, kind: str) -> torch.Tensor:
    """Reduce ``vals`` [n, ...] into ``num_segments`` rows by
    ``seg_ids`` [n]; empty segments get the reduce identity."""
    out = torch.full((num_segments,) + tuple(vals.shape[1:]),
                     identity_for(kind, vals.dtype), dtype=vals.dtype,
                     device=vals.device)
    idx = seg_ids.to(torch.int64)
    if vals.dim() > 1:
        idx = idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, SCATTER_REDUCE[kind],
                               include_self=True)
