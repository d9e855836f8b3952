"""Host graph and the padded part-major layout (counterpart of
lux_tpu/graph.py:69 ``Graph`` and :364-517 ``ShardedGraph``).

``ShardedGraph.build`` does all index translation once on the host so
the per-iteration device work is nothing but gathers and reductions:

- parts are edge-balanced contiguous vertex ranges (partition.py);
- every per-part array is padded to the max across parts (vertex dim
  to ``vpad``, edge dim to ``epad``) and stacked ``[num_parts, ...]``;
- vertex state lives in padded part-major order: the slot of vertex v
  is ``part(v) * vpad + (v - starts[part(v)])``, and edge sources are
  pre-translated into these slots (``src_slot``);
- edge destinations are part-local (``dst_local``); padding edges
  point at the trash segment ``vpad`` and their sources at slot 0.

The arrays stay host numpy; engines move them onto the device.
Local-parts (multi-host) builds are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lux_tpu_torch import format as luxfmt
from lux_tpu_torch.partition import edge_balanced_bounds, part_edge_counts


VPAD_ALIGN = 8      # padded vertices per part: a multiple of this
EPAD_ALIGN = 128    # padded edges per part: a multiple of this


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class Graph:
    """Host CSC graph: row_ptrs are END offsets (see format.py)."""

    nv: int
    ne: int
    row_ptrs: np.ndarray          # uint64 [nv], end offsets
    col_idx: np.ndarray           # uint32 [ne], edge sources, dst-sorted
    weights: np.ndarray | None    # [ne] or None
    out_degrees: np.ndarray       # uint32 [nv]

    @classmethod
    def from_file(cls, path: str, weighted: bool | None = None,
                  validate: bool = False) -> "Graph":
        """Load a .lux file (memory-mapped).  validate=True runs
        format.validate_graph and raises a typed GraphFormatError on a
        malformed file.  Out-degrees are recomputed when the file has
        no degree section."""
        hdr, row_ptrs, col_idx, weights, degrees = luxfmt.read_lux(
            path, weighted, validate=validate)
        if degrees is None:
            degrees = np.bincount(col_idx, minlength=hdr.nv).astype(np.uint32)
        return cls(nv=hdr.nv, ne=hdr.ne, row_ptrs=row_ptrs, col_idx=col_idx,
                   weights=weights, out_degrees=degrees)

    @classmethod
    def from_edges(cls, src, dst, nv: int, weights=None) -> "Graph":
        from lux_tpu_torch.convert import edges_to_csc
        row_ptrs, col_idx, w_sorted, deg = edges_to_csc(src, dst, nv, weights)
        return cls(nv=nv, ne=int(col_idx.shape[0]), row_ptrs=row_ptrs,
                   col_idx=col_idx, weights=w_sorted, out_degrees=deg)

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptrs.astype(np.int64), prepend=0)

    def edge_arrays(self):
        """(src, dst) int64 arrays in file (dst-sorted) order."""
        src = self.col_idx.astype(np.int64)
        dst = np.repeat(np.arange(self.nv, dtype=np.int64),
                        self.in_degrees())
        return src, dst


@dataclasses.dataclass
class ShardedGraph:
    """Padded part-major layout; all arrays are host numpy."""

    nv: int
    ne: int
    num_parts: int
    starts: np.ndarray        # int64 [num_parts+1] partition cut points
    vpad: int                 # padded vertices per part
    epad: int                 # padded edges per part
    nv_part: np.ndarray       # int32 [num_parts] real vertices per part
    ne_part: np.ndarray       # int64 [num_parts] real edges per part
    src_slot: np.ndarray      # int32 [num_parts, epad] padded global src slot
    dst_local: np.ndarray     # int32 [num_parts, epad] local dst, pad -> vpad
    edge_weight: np.ndarray | None  # float32 [num_parts, epad]
    row_ptr_local: np.ndarray  # int32 [num_parts, vpad+1] local END offsets
    vmask: np.ndarray         # bool [num_parts, vpad] valid-vertex mask
    deg_padded: np.ndarray    # int32 [num_parts, vpad] out-degrees, padded
    weighted: bool = False

    @classmethod
    def build(cls, g: Graph, num_parts: int) -> "ShardedGraph":
        """Edge-balanced parts, padded and stacked."""
        starts = edge_balanced_bounds(g.row_ptrs, num_parts)
        nv_part = (starts[1:] - starts[:-1]).astype(np.int32)
        ne_part = part_edge_counts(g.row_ptrs, starts).astype(np.int64)
        vpad = _round_up(max(1, int(nv_part.max())), VPAD_ALIGN)
        epad = _round_up(max(1, int(ne_part.max())), EPAD_ALIGN)
        if epad >= np.iinfo(np.int32).max:
            raise ValueError(
                f"per-part edge count {epad} overflows int32; "
                f"use more partitions")
        if num_parts * vpad >= np.iinfo(np.int32).max:
            raise ValueError(
                f"padded vertex-slot space {num_parts * vpad} overflows "
                f"int32 src_slot indices")

        rp = g.row_ptrs.astype(np.int64)
        col = g.col_idx
        v_part = np.searchsorted(starts, np.arange(g.nv, dtype=np.int64),
                                 side="right") - 1
        v_slot = (v_part * vpad +
                  (np.arange(g.nv, dtype=np.int64) - starts[v_part]))

        P = num_parts
        src_slot = np.zeros((P, epad), dtype=np.int32)
        dst_local = np.full((P, epad), vpad, dtype=np.int32)
        edge_weight = None
        if g.weights is not None:
            edge_weight = np.zeros((P, epad), dtype=np.float32)
        row_ptr_local = np.zeros((P, vpad + 1), dtype=np.int32)
        vmask = np.zeros((P, vpad), dtype=bool)
        deg_padded = np.zeros((P, vpad), dtype=np.int32)

        for p in range(P):
            v0, v1 = int(starts[p]), int(starts[p + 1])
            nep = int(ne_part[p])
            ebegin = int(rp[v0 - 1]) if v0 else 0
            eend = ebegin + nep
            # shard-boundary invariants, so an unvalidated malformed
            # graph errors here instead of building out-of-range slots
            local_ends = (rp[v0:v1] - ebegin).astype(np.int64)
            in_deg = np.diff(np.concatenate(([0], local_ends)))
            if nep < 0 or (in_deg < 0).any() or (
                    v1 > v0 and int(local_ends[-1]) != nep):
                raise luxfmt.GraphFormatError(
                    f"part {p}", "partition_edges",
                    f"row_ptrs not monotone within vertices "
                    f"[{v0}, {v1}) or edge count {nep} inconsistent "
                    f"with the part's end offsets")
            srcs = col[ebegin:eend].astype(np.int64)
            if srcs.size and (int(srcs.min()) < 0
                              or int(srcs.max()) >= g.nv):
                bad = int(srcs.max()) if int(srcs.max()) >= g.nv \
                    else int(srcs.min())
                raise luxfmt.GraphFormatError(
                    f"part {p}", "col_idx_range",
                    f"edge source {bad} outside [0, {g.nv})")
            src_slot[p, :nep] = v_slot[srcs]
            dst_local[p, :nep] = np.repeat(
                np.arange(v1 - v0, dtype=np.int32), in_deg)
            if edge_weight is not None:
                edge_weight[p, :nep] = np.asarray(
                    g.weights[ebegin:eend], dtype=np.float32)
            row_ptr_local[p, 1:v1 - v0 + 1] = local_ends
            row_ptr_local[p, v1 - v0 + 1:] = nep
            vmask[p, :v1 - v0] = True
            deg_padded[p, :v1 - v0] = g.out_degrees[v0:v1]

        return cls(nv=g.nv, ne=g.ne, num_parts=num_parts, starts=starts,
                   vpad=vpad, epad=epad, nv_part=nv_part, ne_part=ne_part,
                   src_slot=src_slot, dst_local=dst_local,
                   edge_weight=edge_weight, row_ptr_local=row_ptr_local,
                   vmask=vmask, deg_padded=deg_padded,
                   weighted=g.weights is not None)

    def to_padded(self, x: np.ndarray) -> np.ndarray:
        """[nv, ...] user order -> [num_parts, vpad, ...] padded."""
        x = np.asarray(x)
        out = np.zeros((self.num_parts, self.vpad) + x.shape[1:], x.dtype)
        for p in range(self.num_parts):
            v0, v1 = int(self.starts[p]), int(self.starts[p + 1])
            out[p, :v1 - v0] = x[v0:v1]
        return out

    def from_padded(self, x: np.ndarray) -> np.ndarray:
        """[num_parts, vpad, ...] padded -> [nv, ...] user order."""
        x = np.asarray(x)
        if x.shape[0] != self.num_parts:
            raise ValueError(
                f"from_padded needs all {self.num_parts} part rows, got "
                f"{x.shape[0]}")
        out = np.empty((self.nv,) + x.shape[2:], x.dtype)
        for p in range(self.num_parts):
            v0, v1 = int(self.starts[p]), int(self.starts[p + 1])
            out[v0:v1] = x[p, :v1 - v0]
        return out
