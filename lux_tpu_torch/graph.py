"""Host graph and the padded part-major layout (counterpart of
lux_tpu/graph.py:43 ``_check_partition_starts``, :69 ``Graph``, :198
``degree_relabel``, :213 ``pair_relabel``, :364-517 ``ShardedGraph``
and :615-690, its src-sorted push view).

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
``Graph.from_file`` reads through the mmap path or the native pthread
loader (``use_native=True``) and applies a ``.perm`` sidecar
(``reorder=``).  ``ShardedGraph.build(..., parts=)`` and
``build_from_file(..., parts=)`` materialize only some parts' rows, the
local-parts build of a several-process mesh (lux_tpu/graph.py:386-410,
:413-516, :520-600): each rank builds its own parts, the file's edges
read by the native loader a part at a time (``native.load_partition``),
while the global metadata (nv, starts, vpad, epad, nv_part, ne_part)
stays global so every rank lays out the same shapes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from lux_tpu_torch import format as luxfmt
from lux_tpu_torch import native as _native
from lux_tpu_torch.partition import edge_balanced_bounds, part_edge_counts

# the streamed SDDMM pair block the reference's advisor prices
# (lux_tpu/ops/pairs.py:916)
PAIR_DOT_BLOCK_BYTES = 64 << 20


VPAD_ALIGN = 8      # default: padded vertices per part, a multiple of this
EPAD_ALIGN = 128    # padded edges per part: a multiple of this
# pair_relabel deals each part at most ceil(VPAD_CAP * tiles / parts)
# tiles: pure cost balancing can blow up the worst part's padding
VPAD_CAP = 1.2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_partition_starts(starts: np.ndarray, num_parts: int,
                            nv: int) -> None:
    """Cut-point invariants: num_parts + 1 points spanning 0 .. nv,
    monotone non-decreasing.  A bad ``starts`` would otherwise build
    negative-size parts."""
    if starts.shape[0] != num_parts + 1:
        raise luxfmt.GraphFormatError(
            "starts", "partition_starts",
            f"{starts.shape[0]} cut points for {num_parts} parts "
            f"(need num_parts + 1)")
    if int(starts[0]) != 0 or int(starts[-1]) != nv:
        raise luxfmt.GraphFormatError(
            "starts", "partition_starts",
            f"cut points must span [0, {nv}], got "
            f"[{int(starts[0])}, {int(starts[-1])}]")
    d = np.diff(starts)
    if (d < 0).any():
        at = int(np.argmax(d < 0))
        raise luxfmt.GraphFormatError(
            "starts", "partition_starts",
            f"cut points decrease at part {at} "
            f"({int(starts[at])} -> {int(starts[at + 1])})")


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
                  use_native: bool = False, validate: bool = False,
                  reorder: bool | str = False) -> "Graph":
        """Load a .lux file: memory-mapped, or with ``use_native=True``
        read whole by the native pthread pread loader
        (``native.load_partition``; out-degrees counted from the loaded
        sources).  validate=True runs format.validate_graph and raises
        a typed GraphFormatError on a malformed file.  Out-degrees are
        recomputed when the file has no degree section.

        reorder: apply the ``.perm`` sidecar beside the file
        (format.read_perm_sidecar; written by reorder.page_reorder's
        caller through format.write_perm_sidecar).  True requires it
        (GraphFormatError [perm_header] when it is missing), "auto"
        applies it when it exists; the returned graph is relabelled
        with perm[new] = old."""
        if reorder not in (False, True, "auto"):
            raise ValueError(f"reorder={reorder!r} must be False, "
                             f"True or 'auto'")
        if use_native:
            hdr = luxfmt.peek_lux(path, weighted)
            row_ptrs, col_idx, weights, _ = _native.load_partition(
                path, hdr.nv, hdr.ne, 0, hdr.nv, weighted=hdr.has_weights,
                weight_dtype=luxfmt.W_DTYPE)
            if validate:
                luxfmt.validate_graph(hdr.nv, hdr.ne, row_ptrs, col_idx,
                                      path=path)
            degrees = None
        else:
            hdr, row_ptrs, col_idx, weights, degrees = luxfmt.read_lux(
                path, weighted, validate=validate)
        if degrees is None:
            degrees = np.bincount(col_idx, minlength=hdr.nv).astype(np.uint32)
        g = cls(nv=hdr.nv, ne=hdr.ne, row_ptrs=row_ptrs, col_idx=col_idx,
                weights=weights, out_degrees=degrees)
        if reorder:
            sidecar = luxfmt.perm_sidecar_path(path)
            if not os.path.exists(sidecar):
                if reorder == "auto":
                    return g
                raise luxfmt.GraphFormatError(
                    sidecar, "perm_header",
                    "reorder=True but no .perm sidecar exists (write one "
                    "with format.write_perm_sidecar from "
                    "reorder.page_reorder's perm, or pass reorder='auto')")
            perm = luxfmt.read_perm_sidecar(path, nv=g.nv)
            from lux_tpu_torch.reorder import apply_perm
            return apply_perm(g, perm)
        return g

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


def degree_relabel(g: Graph):
    """Relabel vertices by descending total degree (in + out), ties in
    vertex order — concentrates hubs into shared 128-vertex pages for
    the paged gather.  Returns (relabeled graph, perm) with
    perm[new] = old."""
    src, dst = g.edge_arrays()
    deg = (np.bincount(src, minlength=g.nv)
           + np.bincount(dst, minlength=g.nv))
    perm = np.argsort(-deg, kind="stable")
    rank = np.empty(g.nv, np.int64)
    rank[perm] = np.arange(g.nv)
    g2 = Graph.from_edges(rank[src], rank[dst], g.nv, weights=g.weights)
    return g2, perm


def pair_relabel(g: Graph, num_parts: int = 1, pair_threshold: int = 16):
    """Degree-sort, then deal whole 128-vertex tiles to parts, for
    pair-lane delivery (ops/pairs.py).  One part: the tiles in degree
    order (a plain degree sort).  Several parts: a capped LPT greedy
    over the degree-ordered tiles, each tile to the currently cheapest
    part holding fewer than ceil(VPAD_CAP * tiles / P) tiles, so every
    part gets a similar depth profile and estimated cost.  A tile's
    cost: ops/pairs.PAIR_COST per in-edge in a dense (>= pair_threshold
    edges) global (src tile, dst tile) pair, GATHER_COST per other
    in-edge.  Dealing moves whole tiles, so pair coverage equals the
    plain degree sort's.

    Returns (relabelled graph, perm, starts) with perm[new] = old and
    ``starts`` the tile-aligned cut points for ShardedGraph.build (a
    partial trailing tile goes last); starts is None where the graph
    has fewer full tiles than parts (plain degree sort)."""
    from lux_tpu_torch.ops.pairs import GATHER_COST, PAIR_COST

    src, dst = g.edge_arrays()
    src = src.astype(np.uint32)
    dst = dst.astype(np.uint32)
    deg = (np.bincount(src, minlength=g.nv)
           + np.bincount(dst, minlength=g.nv))
    by_deg = np.argsort(-deg, kind="stable")      # degree position -> old
    del deg
    Wt = 128
    n_tiles = -(-g.nv // Wt)
    full = n_tiles - 1 if g.nv % Wt else n_tiles
    P = max(1, num_parts)
    if P > 1 and full < P:
        rank = np.empty(g.nv, np.int64)
        rank[by_deg] = np.arange(g.nv)
        g2 = Graph.from_edges(rank[src], rank[dst], g.nv, weights=g.weights)
        return g2, by_deg, None

    if P > 1 and full:
        # estimated per-tile in-edge cost in the degree-sorted tiling
        rank0 = np.empty(g.nv, np.uint32)
        rank0[by_deg] = np.arange(g.nv, dtype=np.uint32)
        d2t = (rank0[dst] // Wt).astype(np.int32)
        key = (rank0[src] // Wt).astype(np.int64) * np.int64(n_tiles) + d2t
        # pair multiplicity of every edge: group the sorted keys, the
        # edge index riding the sort
        order = np.arange(len(key), dtype=np.uint32 if len(key) < 2**32
                          else np.int64)
        _native.sort_kv(key, (order,))
        newg = np.ones(len(key), bool)
        newg[1:] = key[1:] != key[:-1]
        del key
        gid = np.cumsum(newg) - 1
        cnt = np.bincount(gid)
        is_pair = np.empty(len(gid), bool)            # per-edge dense?
        is_pair[order] = cnt[gid] >= pair_threshold
        del order, newg, gid, cnt
        pair_by_tile = np.bincount(d2t[is_pair], minlength=n_tiles)
        all_by_tile = np.bincount(d2t, minlength=n_tiles)
        tile_cost = (PAIR_COST * pair_by_tile
                     + GATHER_COST * (all_by_tile - pair_by_tile))
        cap = max(1, int(np.ceil(VPAD_CAP * full / P)))
        load = np.zeros(P)
        tiles_held = np.zeros(P, np.int64)
        owner = np.empty(full, np.int64)
        for t in range(full):                     # capped LPT greedy
            masked = np.where(tiles_held < cap, load, np.inf)
            p = int(np.argmin(masked))
            owner[t] = p
            load[p] += tile_cost[t]
            tiles_held[p] += 1
        part_tiles = [np.nonzero(owner == p)[0] for p in range(P)]
    else:
        part_tiles = [np.arange(p, full, P) for p in range(P)]

    counts_v = [len(t) * Wt for t in part_tiles]
    if g.nv % Wt:
        part_tiles[-1] = np.concatenate(
            [part_tiles[-1], [full]]).astype(np.int64)
        counts_v[-1] += g.nv % Wt
    starts = np.concatenate(([0], np.cumsum(counts_v))).astype(np.int64)
    tile_seq = np.concatenate(part_tiles)
    vert_order = (tile_seq[:, None] * Wt
                  + np.arange(Wt)[None, :]).reshape(-1)
    vert_order = vert_order[vert_order < g.nv]    # clip the partial tile
    perm = by_deg[vert_order]                     # new -> old
    rank = np.empty(g.nv, np.uint32)
    rank[perm] = np.arange(g.nv, dtype=np.uint32)
    g2 = Graph.from_edges(rank[src], rank[dst], g.nv, weights=g.weights)
    return g2, perm, starts


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
    # max out-degree over the whole graph
    max_out_degree: int = 0
    # a local-parts build: only these parts' rows are materialized in
    # the part-major arrays (None = all parts)
    local_parts: np.ndarray | None = None
    # the global row_ptrs (END offsets), kept on local builds so the
    # chunk geometry can be sized over all parts
    row_ptr_global: np.ndarray | None = None
    # the src-sorted view, built once (_src_sorted_raw); not an init
    # field, so dataclasses.replace (the pair residual) starts empty
    _src_sorted_cache: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def part_ids(self) -> np.ndarray:
        """Global part id of each materialized array row."""
        if self.local_parts is None:
            return np.arange(self.num_parts, dtype=np.int64)
        return np.asarray(self.local_parts, dtype=np.int64)

    def sizing_row_ptr(self) -> np.ndarray:
        """row_ptr_local for ALL parts: the chunk geometry every rank
        of a local-parts build must agree on (lux_tpu/graph.py:595)."""
        if self.local_parts is None:
            return self.row_ptr_local
        rp = np.asarray(self.row_ptr_global).astype(np.int64)
        out = np.zeros((self.num_parts, self.vpad + 1), np.int64)
        for p in range(self.num_parts):
            v0, v1 = int(self.starts[p]), int(self.starts[p + 1])
            ebegin = int(rp[v0 - 1]) if v0 else 0
            out[p, 1:v1 - v0 + 1] = rp[v0:v1] - ebegin
            out[p, v1 - v0 + 1:] = out[p, v1 - v0]
        return out

    @classmethod
    def build(cls, g: Graph, num_parts: int,
              vpad_align: int = VPAD_ALIGN,
              starts: np.ndarray | None = None,
              pair_threshold: int | None = None,
              parts=None) -> "ShardedGraph":
        """Edge-balanced parts, padded and stacked.  ``vpad_align=128``
        gives the 128-aligned vertex padding the paged gather needs
        (ops/pagegather.py).  ``starts`` overrides the cut points.
        ``pair_threshold``: build for pair-lane delivery — 128-aligned
        vertex padding and, for several parts without ``starts``, cuts
        that balance the estimated cost under the pair/gather split
        (ops/pairs.cost_balanced_starts).  ``parts``: materialize only
        these parts' rows (a rank of a mesh builds its own; the engines
        take them as they are)."""
        if pair_threshold is not None:
            vpad_align = max(vpad_align, 128)
            if starts is None and num_parts > 1:
                from lux_tpu_torch.ops.pairs import cost_balanced_starts
                starts = cost_balanced_starts(g, num_parts, pair_threshold)
        if starts is None:
            starts = edge_balanced_bounds(g.row_ptrs, num_parts)
        starts = np.asarray(starts, np.int64)
        _check_partition_starts(starts, num_parts, g.nv)
        nv_part = (starts[1:] - starts[:-1]).astype(np.int32)
        ne_part = part_edge_counts(g.row_ptrs, starts).astype(np.int64)
        vpad = _round_up(max(1, int(nv_part.max())), vpad_align)
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

        local = None if parts is None else np.asarray(list(parts),
                                                       np.int64)
        if local is not None and (local.size == 0 or local.min() < 0
                                  or local.max() >= num_parts
                                  or np.unique(local).size != local.size):
            raise ValueError(f"parts {local.tolist()} are not distinct "
                             f"part ids in [0, {num_parts})")
        rows = np.arange(num_parts) if local is None else local
        R = len(rows)
        src_slot = np.zeros((R, epad), dtype=np.int32)
        dst_local = np.full((R, epad), vpad, dtype=np.int32)
        edge_weight = None
        if g.weights is not None:
            edge_weight = np.zeros((R, epad), dtype=np.float32)
        row_ptr_local = np.zeros((R, vpad + 1), dtype=np.int32)
        vmask = np.zeros((R, vpad), dtype=bool)
        deg_padded = np.zeros((R, vpad), dtype=np.int32)

        for r, p in enumerate(rows):
            p = int(p)
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
            src_slot[r, :nep] = v_slot[srcs]
            dst_local[r, :nep] = np.repeat(
                np.arange(v1 - v0, dtype=np.int32), in_deg)
            if edge_weight is not None:
                edge_weight[r, :nep] = np.asarray(
                    g.weights[ebegin:eend], dtype=np.float32)
            row_ptr_local[r, 1:v1 - v0 + 1] = local_ends
            row_ptr_local[r, v1 - v0 + 1:] = nep
            vmask[r, :v1 - v0] = True
            deg_padded[r, :v1 - v0] = g.out_degrees[v0:v1]

        return cls(nv=g.nv, ne=g.ne, num_parts=num_parts, starts=starts,
                   vpad=vpad, epad=epad, nv_part=nv_part, ne_part=ne_part,
                   src_slot=src_slot, dst_local=dst_local,
                   edge_weight=edge_weight, row_ptr_local=row_ptr_local,
                   vmask=vmask, deg_padded=deg_padded,
                   weighted=g.weights is not None,
                   max_out_degree=int(g.out_degrees.max(initial=0)),
                   local_parts=local,
                   row_ptr_global=(np.asarray(g.row_ptrs)
                                   if local is not None else None))

    @classmethod
    def build_from_file(cls, path: str, num_parts: int, parts=None,
                        vpad_align: int = VPAD_ALIGN,
                        starts: np.ndarray | None = None,
                        weighted: bool | None = None) -> "ShardedGraph":
        """Build from a .lux file.  ``parts=None``: every part, the graph
        read by the native pthread loader (under
        ``native.numpy_versions()``: the mmap path), then ``build``.
        ``parts``: only those parts' rows, each part's edges read by
        ``native.load_partition`` over its vertex range (the mmap view
        under ``numpy_versions()``); the small row_ptr and degree
        sections are read whole, for cuts and paddings every rank
        agrees on (lux_tpu/graph.py:520 ``build_from_file``).  A rank of
        a mesh passes ``parts=multihost.process_parts(P, mesh)``."""
        if parts is None:
            g = Graph.from_file(path, weighted,
                                use_native=not _native.numpy_only())
            return cls.build(g, num_parts, vpad_align=vpad_align,
                             starts=starts)
        hdr, row_ptrs, col_mm, w_mm, degrees = luxfmt.read_lux(path,
                                                               weighted)
        row_ptrs = np.asarray(row_ptrs)
        if degrees is not None:
            out_deg = np.asarray(degrees).astype(np.uint32)
        else:
            out_deg = np.bincount(np.asarray(col_mm),
                                  minlength=hdr.nv).astype(np.uint32)
        use_native = not _native.numpy_only()

        class _LazyCols:
            """Graph.col_idx stand-in serving per-part slices from the
            native loader (the mmap view without it)."""

            def __getitem__(self, sl):
                lo, hi = sl.start or 0, sl.stop
                if hi <= lo:
                    return np.empty(0, np.uint32)
                if not use_native:
                    return np.asarray(col_mm[sl])
                # parts are vertex-contiguous: the vertex range whose
                # in-edges cover this slice
                v0 = int(np.searchsorted(row_ptrs, lo, side="right"))
                v1 = min(hdr.nv, 1 + int(
                    np.searchsorted(row_ptrs, hi, side="left")))
                _r, cols, _w, e_lo = _native.load_partition(
                    path, hdr.nv, hdr.ne, v0, v1, weighted=False)
                return cols[lo - e_lo:hi - e_lo]

        g = Graph(nv=hdr.nv, ne=hdr.ne, row_ptrs=row_ptrs,
                  col_idx=_LazyCols(),
                  weights=w_mm if hdr.has_weights else None,
                  out_degrees=out_deg)
        return cls.build(g, num_parts, vpad_align=vpad_align,
                         starts=starts, parts=parts)

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

    # ---- the memory advisor ----------------------------------------

    def memory_report(self, *, exchange: str = "gather",
                      owner_slots_per_part: int | None = None,
                      owner_packed: bool | None = None,
                      push_sparse: bool = False, pairs=None,
                      pair_kdim: int = 1, pair_stream: bool | None = None,
                      page_plan=None, query_batch: int = 1,
                      use_mxu: bool = False,
                      mxu_tile_e: int = 512) -> dict:
        """Device bytes of an engine's edge layout and state, per part,
        as named terms (lux_tpu/graph.py:730 ``memory_report``, priced
        with the dtypes the port's engines hold, which for these arrays
        are the reference's): ``edge`` (src_slot int32 + rel int8 + f32
        weights over epad: a lower bound, chunk padding sits above it;
        or a paged plan's arrays, which replace the layout),
        ``push_sparse`` (the src-sorted view), ``pair`` (the pair rows'
        arrays), ``pair_temp`` (one streamed block, or the monolithic
        values and partials), ``page_buffer`` / ``page_temp`` (the paged
        delivery's per-iteration page and row buffers), ``mxu_temp``
        (``use_mxu``: the reference's price of the one-hot reduce's live
        lane matrix, one byte an (edge, lane) over a streamed block of
        ``mxu_tile_e``-edge chunks; lux_tpu/graph.py:898-905) and
        ``vertex`` (state + degrees; batched: a 4-byte label and a
        1-byte mask per query).  What the port's eager forms allocate
        beyond these terms, memwatch's ledger prices as ``port_*``
        terms.
        ``total_bytes`` is num_parts times the terms' sum.
        ``exchange="owner"`` prices the owner layout's slots instead of
        the tiled one's (lux_tpu/graph.py:731-749): one packed uint32 a
        slot, or int32 + int8 (``owner_packed`` None: packed whenever
        vpad <= 2^25), + f32 weights, over ``owner_slots_per_part``
        slots (default epad, a lower bound: the build's chunk padding
        sits above it, ops/owner.OwnerLayout.stats); the owner
        accumulator, vpad x 4 x query_batch bytes a part, is reported as
        ``owner_msg_bytes_per_part`` and left out of the total, as in
        the reference."""
        if exchange not in ("gather", "owner"):
            raise ValueError(f"unknown exchange {exchange!r}")
        if query_batch < 1:
            raise ValueError(f"query_batch must be >= 1, got "
                             f"{query_batch}")
        w = 4 if self.weighted else 0
        page_buf = page_temp = 0
        if page_plan is not None:
            pp = page_plan
            resident = sum(int(a.nbytes) for a in (
                pp.slot_lane, pp.rel_dst, pp.row_tile, pp.tile_pos,
                pp.page_ids, pp.weight, getattr(pp, "vrow_src", None))
                if a is not None)
            edge_bytes = resident // max(1, pp.slot_lane.shape[0])
            wide = max(1, pair_kdim) * query_batch
            page_buf = pp.n_pages * 128 * 4 * wide
            page_temp = (2 * pp.Rp + getattr(pp, "Rg", 0)) * 128 * 4 * wide
        elif exchange == "owner":
            slots = (self.epad if owner_slots_per_part is None
                     else int(owner_slots_per_part))
            if owner_packed is None:
                from lux_tpu_torch.ops.owner import OwnerLayout
                owner_packed = self.vpad <= OwnerLayout.PACK_VPAD_MAX
            edge_bytes = slots * ((4 if owner_packed else 5) + w)
        else:
            edge_bytes = self.epad * (4 + 1 + w)
        sparse_bytes = 0
        if push_sparse:
            S = (self.src_unique_max()
                 if self._src_sorted_cache is not None
                 else min(self.num_parts * self.vpad, self.epad))
            sparse_bytes = 4 * (2 * S + 1) + self.epad * (4 + w)
        pair_bytes = pair_temp = 0
        if pairs is not None:
            from lux_tpu_torch.ops.pairs import (PAIR_STREAM_BLOCK_BYTES,
                                                 W as PW,
                                                 resolve_pair_dot_stream,
                                                 resolve_pair_stream)
            Rp = int(pairs.Rp)
            wlane = PW * 4 if pairs.weight is not None else 0
            pair_bytes = Rp * (4 + PW + wlane) + pairs.tile_pos.shape[1] * 4
            if pair_kdim > 1:
                pair_bytes += Rp * 4                        # row_tile
                streamed = resolve_pair_dot_stream(
                    pair_stream, pairs, self.num_parts, pair_kdim)
                pair_temp = (PAIR_DOT_BLOCK_BYTES if streamed
                             else 2 * Rp * PW * pair_kdim * 4)
            else:
                streamed = resolve_pair_stream(pair_stream, pairs)
                pair_temp = (PAIR_STREAM_BLOCK_BYTES if streamed
                             else 2 * Rp * PW * 4)
        if query_batch == 1:
            vert_bytes = self.vpad * (4 + 4)
        else:
            vert_bytes = self.vpad * (5 * query_batch + 4)
        mxu_temp = 0
        if use_mxu and page_plan is None:
            from lux_tpu_torch.ops.tiled import STREAM_BLOCK_CHUNKS
            mxu_temp = min(self.epad,
                           STREAM_BLOCK_CHUNKS * int(mxu_tile_e)) * 128
        terms = {"edge": edge_bytes, "push_sparse": sparse_bytes,
                 "pair": pair_bytes, "pair_temp": pair_temp,
                 "page_buffer": page_buf, "page_temp": page_temp,
                 "mxu_temp": mxu_temp, "vertex": vert_bytes}
        return {
            "num_parts": self.num_parts,
            "query_batch": query_batch,
            "edge_bytes_per_part": edge_bytes,
            "push_sparse_bytes_per_part": sparse_bytes,
            "pair_bytes_per_part": pair_bytes,
            "pair_temp_bytes_per_part": pair_temp,
            "page_buffer_bytes_per_part": page_buf,
            "page_temp_bytes_per_part": page_temp,
            "mxu_temp_bytes_per_part": mxu_temp,
            "vertex_bytes_per_part": vert_bytes,
            "owner_msg_bytes_per_part": (self.vpad * 4 * query_batch
                                         if exchange == "owner" else 0),
            "terms_per_part": terms,
            "total_bytes": self.num_parts * sum(terms.values()),
        }

    def telemetry_header(self, **memory_kwargs) -> dict:
        """Graph shape and the memory advisor's per-part bytes, the
        payload of an event log's ``header`` event."""
        return {
            "nv": int(self.nv), "ne": int(self.ne),
            "weighted": bool(self.weighted),
            "num_parts": int(self.num_parts),
            "vpad": int(self.vpad), "epad": int(self.epad),
            "memory": {k: int(v) for k, v in
                       self.memory_report(**memory_kwargs).items()
                       if not isinstance(v, dict)},
        }

    # ---- push-model (src-sorted) edge view ---------------------------

    def _src_sorted_raw(self):
        """Per-part src-sort + unique-source compression (host, once):
        (ids, END offsets, dsts, weights) lists by part and the max
        edges of one source within a part."""
        if self._src_sorted_cache is None:
            ids_l, off_l, dst_l, w_l = [], [], [], []
            max_deg = 0
            for p, gp in enumerate(self.part_ids()):
                nep = int(self.ne_part[gp])
                # global source of each real edge: invert the
                # part-major slot translation
                slot = self.src_slot[p, :nep].astype(np.int64)
                sp = slot // self.vpad
                src = self.starts[sp] + (slot - sp * self.vpad)
                src_sorted, order = _native.stable_sort(src)
                uniq, counts = np.unique(src_sorted, return_counts=True)
                if counts.size:
                    max_deg = max(max_deg, int(counts.max()))
                ids_l.append(uniq.astype(np.int32))
                off_l.append(np.concatenate(
                    ([0], np.cumsum(counts))).astype(np.int32))
                dst_l.append(self.dst_local[p, :nep][order])
                w_l.append(self.edge_weight[p, :nep][order]
                           if self.weighted else None)
            self._src_sorted_cache = (ids_l, off_l, dst_l, w_l, max_deg)
        return self._src_sorted_cache

    def src_unique_max(self) -> int:
        """Max unique-source count over the parts (the compressed
        source index's pad size)."""
        return max((len(u) for u in self._src_sorted_raw()[0]),
                   default=1) or 1

    def max_in_deg(self) -> int:
        """Max edges of one source within a part."""
        return self._src_sorted_raw()[4]

    def src_sorted(self, s_pad: int | None = None) -> dict:
        """Per-part edges re-sorted by GLOBAL source id, with a
        compressed source index: only sources with an edge in the part
        are stored (sorted ids + END offsets), binary-searched when a
        frontier is expanded (engine/frontier.expand_frontier).

        Returns numpy arrays: src_ids int32 [P, S] (pad nv), src_off
        int32 [P, S+1] END offsets (pad repeats), ss_dst int32 [P,
        epad] (pad vpad), ss_weight float32 [P, epad] or None, and
        max_in_deg."""
        ids_l, off_l, dst_l, w_l, max_deg = self._src_sorted_raw()
        R = len(ids_l)
        need = max((len(u) for u in ids_l), default=0)
        S = max(1, need if s_pad is None else int(s_pad))
        if S < need:
            raise ValueError(f"s_pad={s_pad} < max unique sources {need}")
        src_ids = np.full((R, S), self.nv, dtype=np.int32)
        src_off = np.zeros((R, S + 1), dtype=np.int32)
        ss_dst = np.full((R, self.epad), self.vpad, dtype=np.int32)
        ss_weight = (np.zeros((R, self.epad), dtype=np.float32)
                     if self.weighted else None)
        for r in range(R):
            u, off = ids_l[r], off_l[r]
            src_ids[r, :len(u)] = u
            src_off[r, :len(u) + 1] = off
            src_off[r, len(u) + 1:] = off[-1]
            nep = len(dst_l[r])
            ss_dst[r, :nep] = dst_l[r]
            if ss_weight is not None:
                ss_weight[r, :nep] = w_l[r]
        return dict(src_ids=src_ids, src_off=src_off, ss_dst=ss_dst,
                    ss_weight=ss_weight, max_in_deg=max_deg)
