"""Tiled (chunked) edge layout and the scatter-free segment reduction
(counterpart of lux_tpu/ops/tiled.py:63-160, :166, :398-469, :800,
:812).

The host re-lays each part's dst-sorted edges into fixed-shape chunks
bound to output vertex tiles:

- output vertices are grouped into tiles of ``W``; each tile owns a
  whole number of ``E``-edge chunks -> arrays ``[C, E]``;
- within a chunk every edge's destination is a relative lane in
  ``[0, W)`` (int8, -1 = pad lane);
- the chunk's partial ``[W]`` is the chunk_partials kernel
  (ops/chunk_reduce.py); chunks of one tile are then folded by a
  segmented combine and the tile's last chunk is taken.

The arrays are array-equal to the reference's for the same graph: the
chunk count is padded to a multiple of 8 (pad chunks are isolated
identity segments, owned by the pad tile ``n_tiles``).  The MXU forms
of the reference (one-hot contraction, scan-as-matmul) are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch.ops.chunk_reduce import chunk_partials
from lux_tpu_torch.ops.segment import identity_for


def _ceil_div(a, b):
    return (a + b - 1) // b


@dataclasses.dataclass
class TiledLayout:
    """Host-side chunk plan for one partitioned graph (stacked over
    parts; all chunk arrays are ``[num_parts, C, ...]``)."""

    W: int                      # vertices per output tile
    E: int                      # edges per chunk
    n_tiles: int                # ceil(vpad / W), same for every part
    n_chunks: int               # padded chunk count C (max over parts)
    needs_scan: bool            # False when every tile fits in 1 chunk
    edge_gather: np.ndarray     # int64 [P, C, E] index into flat [epad]
    rel_dst: np.ndarray         # int8 [P, C, E] in [0, W); -1 = pad
    chunk_tile: np.ndarray      # int32 [P, C] owning tile; n_tiles = pad
    chunk_start: np.ndarray     # bool  [P, C] True at each tile's 1st chunk
    last_chunk: np.ndarray      # int32 [P, n_tiles] index of tile's last
                                #   chunk, -1 for edge-less tiles

    @classmethod
    def build(cls, row_ptr_local: np.ndarray, dst_local: np.ndarray,
              vpad: int, W: int = 128, E: int = 512) -> "TiledLayout":
        """row_ptr_local: int [P, vpad+1] END offsets; dst_local:
        int32 [P, epad] part-local sorted destinations (pad -> vpad)."""
        if W > 128:
            raise ValueError(
                f"tile width W={W} > 128: rel_dst is int8 (valid lane "
                f"offsets 0..127, -1 = pad) and wider tiles would wrap "
                f"offsets >= 128 negative, silently dropping edges")
        if E < 1:
            raise ValueError(f"chunk width E={E} must be >= 1")
        P = row_ptr_local.shape[0]
        n_tiles = max(1, _ceil_div(vpad, W))

        def tile_chunks(rp_row):
            rp = rp_row.astype(np.int64)
            tile_lo = rp[np.minimum(np.arange(n_tiles) * W, vpad)]
            tile_hi = rp[np.minimum((np.arange(n_tiles) + 1) * W, vpad)]
            n_ch = np.maximum(0, _ceil_div(tile_hi - tile_lo, E))
            return tile_lo, tile_hi, n_ch

        per_part = [tile_chunks(row_ptr_local[p]) for p in range(P)]
        C = max(1, int(max(int(x[2].sum()) for x in per_part)))
        C = _ceil_div(C, 8) * 8
        needs_scan = any(x[2].max(initial=0) > 1 for x in per_part)

        edge_gather = np.zeros((P, C, E), dtype=np.int64)
        rel_dst = np.full((P, C, E), -1, dtype=np.int8)
        chunk_tile = np.full((P, C), n_tiles, dtype=np.int32)
        chunk_start = np.ones((P, C), dtype=bool)   # pad chunks isolated
        last_chunk = np.full((P, n_tiles), -1, dtype=np.int32)

        lanes = np.arange(E, dtype=np.int64)
        for p in range(P):
            tile_lo, tile_hi, n_ch = per_part[p]
            nc = int(n_ch.sum())
            if nc == 0:
                continue
            ct = np.repeat(np.arange(n_tiles, dtype=np.int64), n_ch)
            tile_first = np.concatenate(([0], np.cumsum(n_ch)[:-1]))
            cj = np.arange(nc, dtype=np.int64) - tile_first[ct]
            start = tile_lo[ct] + cj * E
            idx = start[:, None] + lanes[None, :]          # [nc, E]
            valid = idx < tile_hi[ct][:, None]
            idx = np.where(valid, idx, 0)
            edge_gather[p, :nc] = idx
            rel_dst[p, :nc] = np.where(
                valid, dst_local[p][idx] - (ct * W)[:, None], -1)
            chunk_tile[p, :nc] = ct
            chunk_start[p, :nc] = cj == 0
            last_chunk[p] = np.where(n_ch > 0, np.cumsum(n_ch) - 1, -1)

        return cls(W=W, E=E, n_tiles=n_tiles, n_chunks=C,
                   needs_scan=needs_scan, edge_gather=edge_gather,
                   rel_dst=rel_dst, chunk_tile=chunk_tile,
                   chunk_start=chunk_start, last_chunk=last_chunk)

    def chunk(self, flat: np.ndarray) -> np.ndarray:
        """Re-lay a per-part flat edge array [P, epad, ...] into chunk
        form [P, C, E, ...] (host, once at build time)."""
        parts = np.arange(flat.shape[0])[:, None, None]
        return flat[parts, self.edge_gather]

    @property
    def geometry(self) -> "TileGeometry":
        return TileGeometry(W=self.W, E=self.E, n_tiles=self.n_tiles,
                            n_chunks=self.n_chunks,
                            needs_scan=self.needs_scan)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The scalars of a TiledLayout — all the device side needs once
    the chunk arrays are on the device (the host plan's [P, C, E]
    int64 gather index is then dropped)."""

    W: int
    E: int
    n_tiles: int
    n_chunks: int
    needs_scan: bool


def combine_op(kind: str):
    """The binary combiner for a reduce kind (NaN-propagating)."""
    return {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[kind]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Device-side plan of the segmented chunk combine, computed once
    per layout (``segment_plan``) so the per-iteration combine never
    syncs with the host."""

    pos: torch.Tensor           # int64 [R*C] position within its segment
    max_len: int                # longest segment (chunks of one tile)
    take: torch.Tensor          # int64 [R*n_tiles] flat index of last chunk
    empty: torch.Tensor         # bool [R, n_tiles] edge-less tiles


def segment_plan(chunk_start: torch.Tensor,
                 last_chunk: torch.Tensor) -> SegmentPlan:
    """chunk_start bool [R, C] (or [C]); last_chunk int [R, n_tiles]
    (or [n_tiles]).  Each run of chunks starting at a True flag is one
    segment; parts are independent because each part's first chunk is
    flagged (real first chunks and pad chunks both are)."""
    cs = chunk_start.reshape(-1).to(torch.bool)
    lc = last_chunk.reshape(-1, last_chunk.shape[-1]).to(torch.int64)
    R, n_tiles = lc.shape
    C = cs.numel() // R
    idx = torch.arange(cs.numel(), device=cs.device)
    first = torch.cummax(torch.where(cs, idx, torch.zeros_like(idx)),
                         dim=0).values
    pos = idx - first
    max_len = int(pos.max()) + 1 if pos.numel() else 1
    base = torch.arange(R, device=cs.device)[:, None] * C
    take = (base + lc.clamp(min=0)).reshape(-1)
    return SegmentPlan(pos=pos, max_len=max_len, take=take, empty=lc < 0)


def combine_chunks(partials: torch.Tensor, layout, chunk_start,
                   last_chunk, kind: str,
                   plan: SegmentPlan | None = None) -> torch.Tensor:
    """Segmented combine of per-chunk partials [R*C, W, ...] (or
    [C, W, ...]) into tile results [R, n_tiles, W, ...] (or
    [n_tiles, W, ...], following ``last_chunk``'s shape).

    An inclusive segmented scan by doubling (log2 of the longest
    segment passes; none when every tile fits in one chunk), then each
    tile's last chunk is taken; edge-less tiles get the identity and
    pad chunks (tile ``n_tiles``) are never taken.  Deterministic: the
    combine order is fixed by the layout."""
    if plan is None:
        plan = segment_plan(chunk_start, last_chunk)
    comb = combine_op(kind)
    trail = tuple(partials.shape[1:])
    x = partials.reshape((-1,) + trail)
    d = 1
    while d < plan.max_len:
        m = (plan.pos[d:] >= d).reshape((-1,) + (1,) * len(trail))
        x = torch.cat([x[:d], torch.where(m, comb(x[:-d], x[d:]), x[d:])])
        d *= 2
    out = x[plan.take].reshape(tuple(last_chunk.shape) + trail)
    empty = plan.empty.reshape(tuple(last_chunk.shape) +
                               (1,) * len(trail))
    ident = torch.full((), identity_for(kind, x.dtype), dtype=x.dtype,
                       device=x.device)
    return torch.where(empty, ident, out)


def combine_partials(partials, layout, chunk_start, last_chunk, vpad: int,
                     kind: str, plan: SegmentPlan | None = None):
    """Per-chunk partials -> per-vertex results [R, vpad, ...] (or
    [vpad, ...] for one part)."""
    tiles = combine_chunks(partials, layout, chunk_start, last_chunk, kind,
                           plan)
    lead = tuple(last_chunk.shape[:-1])
    flat = tiles.reshape(lead + (layout.n_tiles * layout.W,) +
                         tuple(tiles.shape[len(lead) + 2:]))
    return flat.narrow(len(lead), 0, vpad)


def tiled_segment_reduce(vals, layout, chunk_start, last_chunk, rel_dst,
                         vpad: int, kind: str,
                         plan: SegmentPlan | None = None):
    """Full scatter-free segment reduce: chunked messages [R*C, E]
    (or [C, E]) -> [R, vpad] (or [vpad]).  Drop-in for
    ``segment_reduce(msgs, dst_local, vpad+1, kind)[:vpad]``; the
    per-chunk partials go through kernel B1 (ops/chunk_reduce.py)."""
    partials = chunk_partials(vals.reshape(-1, layout.E),
                              rel_dst.reshape(-1, layout.E), layout.W, kind)
    return combine_partials(partials, layout, chunk_start, last_chunk, vpad,
                            kind, plan)
