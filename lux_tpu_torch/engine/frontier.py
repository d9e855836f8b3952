"""Sparse-frontier machinery for the push engine (counterpart of
lux_tpu/engine/frontier.py:67 ``compact_mask``, :90 ``expand_frontier``
and :168 ``scatter_reduce``).

The canonical frontier is the dense bool mask.  When it is small, a
push iteration compacts it into a capacity-bounded padded queue of
(vertex, label) pairs and relaxes only the queue's out-edges, a fixed
edge budget of work.  Everything here has static shapes and is built
from cumsum, searchsorted, cummax and a bounded scatter, so nothing
syncs the host.  Each function takes one part (``[N]`` arrays) or
every part at once (a leading ``[P, ...]`` dimension); int32 stays
int32, as in the reference, and every index is clamped into range
before it is used (torch raises on the CPU and faults on the card
where jnp would clamp or drop).

``use_mxu=True`` takes the reference's matrix-unit form of the
expansion (lux_tpu/engine/frontier.py:40-64, :130-148): the queue
indices' deltas scattered by addition, then an inclusive cumsum as
blocked lower-triangular matmuls (``_cumsum_matmul``) in place of the
running max; bit-equal to the plain form.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.segment import SCATTER_REDUCE


# block length of the cumsum as matmuls: one [256, 256] lower-triangular
# matrix (lux_tpu/engine/frontier.py:34)
FRONTIER_MXU_BLOCK = 256


def _cumsum_matmul(x: torch.Tensor,
                   block: int = FRONTIER_MXU_BLOCK) -> torch.Tensor:
    """Inclusive cumsum of an int32 [..., N] along the last axis as
    blocked lower-triangular matmuls: per block ``x_b @ L^T`` with L[i,
    j] = (i >= j), then each block adds the total of the blocks before
    it, itself this cumsum one level up.  The products are exact
    (ops/tiled._matmul_exact: byte planes in float32; cuBLAS has no
    int32 GEMM), so the result is ``torch.cumsum``'s, wrap-around
    included."""
    from lux_tpu_torch.ops.tiled import _matmul_exact
    lead = tuple(x.shape[:-1])
    N = x.shape[-1]
    if N == 0:
        return x.clone()
    nB = -(-N // block)
    Np = nB * block
    if Np != N:
        x = torch.cat([x, x.new_zeros(lead + (Np - N,))], -1)
    ii = torch.arange(block, device=x.device)
    L = (ii[:, None] >= ii[None, :]).to(torch.float32)
    xb = x.reshape(lead + (nB, block, 1))
    out = _matmul_exact(L, xb)[..., 0]              # [..., nB, block]
    if nB > 1:
        tot = _cumsum_matmul(out[..., -1], block)   # inclusive over blocks
        before = torch.cat([tot.new_zeros(lead + (1,)), tot[..., :-1]], -1)
        out = out + before[..., None]
    return out.reshape(lead + (Np,))[..., :N]


def check_use_mxu(use_mxu) -> None:
    """The expansion's ``use_mxu``: a bool (an engine's resolved flag)
    or ``"auto"``, which takes the plain form here (the engines resolve
    "auto" through scalemodel before they get here)."""
    if use_mxu not in (False, True, "auto"):
        raise ValueError(f"unknown use_mxu {use_mxu!r}")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis, batched over leading dims
    (idx int, already in range)."""
    return torch.gather(x, -1, idx.to(torch.int64))


def compact_mask(mask: torch.Tensor, labels: torch.Tensor, capacity: int):
    """Dense bool mask [..., vpad] -> padded queue.

    Returns (ids int32 [..., capacity], vals [..., capacity], count
    int32 [...]).  ids[i] for i >= count is vpad (an invalid slot).  If
    count > capacity the queue is truncated: callers must take the
    dense path then."""
    vpad = mask.shape[-1]
    ranks = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32)
    count = ranks[..., -1]
    # i-th set bit = first position whose running count reaches i+1
    want = torch.arange(1, capacity + 1, dtype=torch.int32,
                        device=mask.device)
    want = want.expand(mask.shape[:-1] + (capacity,)).contiguous()
    ids = torch.searchsorted(ranks.contiguous(), want, side="left",
                             out_int32=True)
    valid = want <= count.unsqueeze(-1)
    ids = torch.where(valid, ids, vpad)
    vals = _take(labels, ids.clamp(max=vpad - 1))
    return ids, vals, count


def expand_frontier(ids, vals, src_ids, src_off, nv: int,
                    edge_budget: int, use_mxu=False):
    """Map a queue to its out-edge slots in a part.

    ids     int32 [Q]     GLOBAL vertex ids, nv = invalid
    vals    [Q]           the queue vertices' labels
    src_ids int32 [..., S]    the part's present sources, sorted, pad nv
    src_off int32 [..., S+1]  END offsets into the part's src-sorted
                              edges (ShardedGraph.src_sorted)

    Returns (edge_idx int32 [..., EB], src_val [..., EB], in_range bool
    [..., EB], total int32 [...], off int32 [..., Q]): edge_idx indexes
    the part's src-sorted edge arrays, src_val is the owning queue
    item's label, off the running END offset of each item's out-edges
    (off[-1] == total), total the frontier's out-edges in this part
    (may exceed EB; slots past it are masked by in_range).  ``ids`` and
    ``vals`` may carry the same leading dims as ``src_ids`` or none."""
    check_use_mxu(use_mxu)
    lead = src_ids.shape[:-1]
    Q = ids.shape[-1]
    S = src_ids.shape[-1]
    EB = int(edge_budget)
    dev = src_ids.device
    ids = ids.expand(lead + (Q,)).contiguous()
    vals = vals.expand(lead + (Q,))
    # binary-search each queue id in the compressed source index
    pos = torch.searchsorted(src_ids.contiguous(), ids, side="left",
                             out_int32=True)
    posc = pos.clamp(max=S - 1)
    present = (_take(src_ids, posc) == ids) & (ids < nv)
    begin = torch.where(present, _take(src_off, posc), 0)
    end = torch.where(present, _take(src_off, posc + 1), 0)
    deg = end - begin
    off = torch.cumsum(deg, -1, dtype=torch.int32)   # END offsets
    total = off[..., -1]
    start = off - deg                                 # begin offsets
    # owner of each edge slot: drop each item's 1-based queue index at
    # its first slot, then a running max spreads it over its extent
    # (items with deg > 0 have distinct starts; 0 marks no item, and
    # the cummax - 1 maps it back to no owner)
    qidx = torch.arange(1, Q + 1, dtype=torch.int32, device=dev)
    marks = torch.zeros(lead + (EB + 1,), dtype=torch.int32, device=dev)
    at = start.clamp(max=EB).to(torch.int64)
    if use_mxu is True:
        # items with deg > 0 have increasing starts and queue indices,
        # so the running max of their scattered indices is the running
        # sum of the index deltas (they telescope; the clamped slot EB
        # is never read)
        qm = torch.where(deg > 0, qidx, 0)
        run = torch.cummax(qm, -1).values               # cheap, [.., Q]
        prev = torch.cat([torch.zeros_like(run[..., :1]), run[..., :-1]],
                         -1)
        marks.scatter_add_(-1, at, torch.where(deg > 0, qidx - prev, 0))
        owner = _cumsum_matmul(marks[..., :EB]) - 1
    else:
        # audit: allow(identity-init) 0 deliberately marks "no item starts
        # here": values are 1-based queue indices >= 1, and the cummax - 1
        # below maps an untouched 0 back to no owner (an int32-min init
        # would overflow that - 1)
        marks.scatter_reduce_(-1, at, torch.where(deg > 0, qidx, 0), "amax",
                              include_self=True)
        owner = torch.cummax(marks[..., :EB], -1).values - 1
    owner = owner.clamp(min=0)
    slot = torch.arange(EB, dtype=torch.int32, device=dev)
    in_range = slot < torch.clamp(total, max=EB).unsqueeze(-1)
    within = slot - _take(start, owner)
    edge_idx = torch.where(in_range, _take(begin, owner) + within, 0)
    src_val = _take(vals, owner)
    return edge_idx, src_val, in_range, total, off


def scatter_reduce(labels: torch.Tensor, dst_local: torch.Tensor,
                   cand: torch.Tensor, kind: str) -> torch.Tensor:
    """Scatter-combine candidates into labels [..., vpad] (a new
    tensor).  dst_local indexes [0, vpad) and is clamped there; lanes
    that must not act carry the reduce identity.  Only used on the
    bounded sparse edge budget, never on the full edge arrays."""
    if kind not in ("min", "max"):
        raise ValueError(f"unsupported sparse reduce {kind!r}")
    vpad = labels.shape[-1]
    safe = dst_local.clamp(0, vpad - 1).to(torch.int64)
    return labels.scatter_reduce(-1, safe, cand, SCATTER_REDUCE[kind],
                                 include_self=True)
