"""The owner-side (source-part-major) edge layout and exchange on one
device (counterpart of lux_tpu/ops/owner.py:47-433: ``OwnerLayout``
:47, ``owner_contribs`` :386, ``owner_exchange`` :433).

The gather exchange reads every part's source states from the whole
[P*vpad] table.  The owner exchange turns the edge layout around: each
source part's out-edges are sorted by global destination tile (dst
part x 128-vertex tile) and chunked as ops/tiled.py chunks them, with
``src_local`` indices into the part's OWN [vpad] shard.  One iteration:

1. each source part gathers from its own shard only, messages, and
   reduces its chunks to per-chunk partials (kernel B1, or its batched
   form over a trailing query axis);
2. the segmented combine folds each (source part, global tile)'s
   chunks -> [P_src, G, W] tile contributions;
3. the contributions fold across source parts, in source-part order
   0..P-1 as the reference's ``lax.scan`` folds them, into the
   accumulated [P_dst, n_tiles * W] reduction;
4. ``owner_exchange`` routes it to its destination parts: the identity
   on one device.

On the H100 the point is the gather's table: one part's shard, not the
whole table (``scalemodel.H100``'s flat gather steps from 0.0089 to
0.0337 ns an edge past 16 MB of table).  ``owner_contribs`` gathers by
one ``index_select`` a source part: on the card it took 0.56 ms at
bench.py's pagerank-mp against 0.88 for one over the part-major global
ids (which chip_smoke.py times beside it; the same messages).

The packed encoding (the default whenever vpad <= 2^25 and E <= 65,535)
keeps one uint32 ``src_local << 7 | rel`` a slot plus a uint16 live-lane
count a chunk instead of int32 + int8 slots; it is decoded by
ops/tiled.unpack_src_rel on the device, each iteration or each block.

On a mesh (lux_tpu/ops/owner.py:291-497) each rank holds its own
source parts' rows: step 3 folds them into contributions to every
destination part, and ``owner_exchange(axis=mesh)`` routes them: a sum
by one reduce-scatter (ops/collectives.py), a min or max by an
all_to_all and a local min / max, or with ``minmax_fused`` by the ring
reduce-scatter (``ring_reduce_scatter``: world - 1 hops of one
destination block, each folding the visited rank's contribution).  A
local-parts build (``sg.local_parts``) lays out only its source parts,
after the planning-time edge exchange (``_local_src_edges``) streams
every destination part's edge row across the ranks; the chunk count,
the scan's need and the extraction plan's width are agreed by
``allreduce_host``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch.ops.segment import identity_for
from lux_tpu_torch.ops.tiled import (STREAM_MSG_BYTES, build_extract_plan,
                                     combine_chunks, combine_op,
                                     extract_plan_width, reduce_partials,
                                     stream_by_default,
                                     streamed_chunk_combined,
                                     unpack_src_rel)

W = 128


def _ceil_div(a, b):
    return -(-a // b)


@dataclasses.dataclass
class OwnerLayout:
    """Host-side src-part-major chunk plan, stacked over source parts
    (lux_tpu/ops/owner.py:47): arrays lead with R = num_parts rows.
    Attribute names n_chunks / E / W / needs_scan match TiledLayout."""

    W: int                      # vertices per destination tile
    E: int                      # edges per chunk
    n_tiles: int                # dst tiles per part = ceil(vpad / W)
    G: int                      # global dst tiles = num_parts * n_tiles
    n_chunks: int               # padded per-src-part chunk count C
    needs_scan: bool
    src_local: np.ndarray | None  # int32 [R, C, E]; pad 0 (None packed)
    rel_dst: np.ndarray | None  # int8 [R, C, E]; -1 pad (None packed)
    weight: np.ndarray | None   # float32 [R, C, E]
    chunk_start: np.ndarray     # bool [R, C] True at each tile's 1st chunk
    last_chunk: np.ndarray      # int32 [R, G]; -1 for edge-less tiles
    stats: dict
    src_rel: np.ndarray | None = None   # uint32 [R, C, E]; pad 0
    n_valid: np.ndarray | None = None   # uint16 [R, C] live lanes
    # a local-parts layout's extraction-plan width, agreed across the
    # ranks at build time (None: computed from the rows held)
    extract_width: int | None = None

    # vpad bound of the packed encoding's 25-bit src_local field
    PACK_VPAD_MAX = 1 << 25

    @property
    def packed(self) -> bool:
        return self.src_rel is not None

    @property
    def geometry(self) -> "OwnerGeometry":
        return OwnerGeometry(W=self.W, E=self.E, n_tiles=self.n_tiles,
                             G=self.G, n_chunks=self.n_chunks,
                             needs_scan=self.needs_scan)

    @classmethod
    def build(cls, sg, E: int = 256, packed: bool | None = None,
              mesh=None) -> "OwnerLayout":
        """Re-lay a ShardedGraph's edges src-part-major (host, once;
        lux_tpu/ops/owner.py:90).  Chunks bind to one global dst tile
        each, so each (src part, dst tile)'s edge count rounds up to E:
        ``stats`` reports the inflation.  ``packed`` None: packed
        whenever the 25-bit src_local field and the uint16 lane count
        fit.  The arrays are the reference's, bit for bit.  A
        local-parts ``sg`` lays out its own source parts only, agreeing
        on the geometry with the ranks of ``mesh`` (None: the default
        process group); its arrays lead with its own row count."""
        local = getattr(sg, "local_parts", None) is not None
        P, vpad = sg.num_parts, sg.vpad
        if packed is None:
            packed = (vpad <= cls.PACK_VPAD_MAX
                      and E <= np.iinfo(np.uint16).max)
        elif packed and vpad > cls.PACK_VPAD_MAX:
            raise ValueError(
                f"packed owner layout needs vpad <= {cls.PACK_VPAD_MAX}"
                f" (25-bit src_local), got vpad={vpad}")
        elif packed and E > np.iinfo(np.uint16).max:
            raise ValueError(
                f"packed owner layout needs E <= "
                f"{np.iinfo(np.uint16).max} (uint16 live-lane "
                f"counts), got E={E}; pass packed=False")
        n_tiles = max(1, _ceil_div(vpad, W))
        G = P * n_tiles
        own_rows = np.asarray(sg.part_ids(), np.int64)
        R = len(own_rows)

        if local:
            key, srcl, rel, wgt = _local_src_edges(sg, n_tiles, G, mesh)
        else:
            # per edge (src part, src local, global dst tile, rel), then
            # one stable sort by (src part, dst tile)
            key_l, srcl_l, rel_l, w_l = [], [], [], []
            for r in range(P):
                nep = int(sg.ne_part[r])
                slot = sg.src_slot[r, :nep].astype(np.int64)
                s = slot // vpad
                srcl_l.append((slot - s * vpad).astype(np.int32))
                dst = sg.dst_local[r, :nep].astype(np.int64)
                key_l.append(s * G + (r * n_tiles + dst // W))
                rel_l.append((dst % W).astype(np.int8))
                if sg.weighted:
                    w_l.append(sg.edge_weight[r, :nep])
            key = (np.concatenate(key_l) if key_l
                   else np.empty(0, np.int64))
            srcl = (np.concatenate(srcl_l) if srcl_l
                    else np.empty(0, np.int32))
            rel = np.concatenate(rel_l) if rel_l else np.empty(0, np.int8)
            wgt = np.concatenate(w_l) if w_l else None
            del key_l, srcl_l, rel_l, w_l
        from lux_tpu_torch import native
        native.sort_kv(key, (srcl, rel) + (() if wgt is None else (wgt,)))
        s_of = key // G

        per_part = []
        for p in own_rows:
            lo, hi = (int(np.searchsorted(s_of, p)),
                      int(np.searchsorted(s_of, p + 1)))
            ks = key[lo:hi] - p * np.int64(G)
            if ks.size:
                newg = np.ones(len(ks), bool)
                newg[1:] = ks[1:] != ks[:-1]
                b = np.nonzero(newg)[0]
                uniq_g = ks[b]
                counts = np.diff(np.concatenate((b, [len(ks)])))
            else:
                uniq_g = np.empty(0, np.int64)
                counts = np.empty(0, np.int64)
            per_part.append((lo, uniq_g.astype(np.int64), counts))
        C = max(1, max((int(_ceil_div(c, E).sum())
                        for _, _, c in per_part), default=1))
        needs_scan = any((_ceil_div(c, E) > 1).any()
                         for _, _, c in per_part if c.size)
        if local:
            from lux_tpu_torch.ops.collectives import allreduce_host
            C = int(allreduce_host(mesh, np.int64(C), "max"))
            needs_scan = bool(allreduce_host(mesh, np.int64(needs_scan),
                                             "max"))
        C = _ceil_div(C, 8) * 8

        if packed:
            src_local = rel_dst = None
            src_rel = np.zeros((R, C, E), dtype=np.uint32)
            n_valid = np.zeros((R, C), dtype=np.uint16)
        else:
            src_rel = n_valid = None
            src_local = np.zeros((R, C, E), dtype=np.int32)
            rel_dst = np.full((R, C, E), -1, dtype=np.int8)
        weight = (np.zeros((R, C, E), dtype=np.float32)
                  if sg.weighted else None)
        chunk_start = np.ones((R, C), dtype=bool)   # pad chunks isolated
        last_chunk = np.full((R, G), -1, dtype=np.int32)

        lanes = np.arange(E, dtype=np.int64)
        used = 0
        for s, (lo, uniq_g, counts) in enumerate(per_part):
            if not counts.size:
                continue
            n_ch = _ceil_div(counts, E)
            nc = int(n_ch.sum())
            used += nc
            ci = np.repeat(np.arange(len(uniq_g)), n_ch)   # chunk -> tile
            tile_lo = lo + np.concatenate(([0], np.cumsum(counts)[:-1]))
            tile_hi = tile_lo + counts
            tile_first = np.concatenate(([0], np.cumsum(n_ch)[:-1]))
            cj = np.arange(nc, dtype=np.int64) - tile_first[ci]
            start = tile_lo[ci] + cj * E
            idx = start[:, None] + lanes[None, :]          # [nc, E]
            valid = idx < tile_hi[ci][:, None]
            idx = np.where(valid, idx, lo)
            if packed:
                sr = (srcl[idx].astype(np.uint32) << np.uint32(7)
                      | rel[idx].astype(np.uint32))
                src_rel[s, :nc] = np.where(valid, sr, 0)
                n_valid[s, :nc] = np.minimum(
                    tile_hi[ci] - start, E).astype(np.uint16)
            else:
                src_local[s, :nc] = np.where(valid, srcl[idx], 0)
                rel_dst[s, :nc] = np.where(valid, rel[idx], -1)
            if weight is not None:
                weight[s, :nc] = np.where(valid, wgt[idx], 0)
            chunk_start[s, :nc] = cj == 0
            last_chunk[s, uniq_g] = (tile_first + n_ch - 1).astype(
                np.int32)

        stats = dict(slots=R * C * E, used_chunks=used,
                     inflation=round(P * C * E / max(1, sg.ne), 3),
                     chunk_inflation=round(used * E / max(1, sg.ne), 3),
                     packed=packed)
        width = None
        if local:
            from lux_tpu_torch.ops.collectives import allreduce_host
            width = int(allreduce_host(mesh, np.int64(
                extract_plan_width(last_chunk, C)), "max"))
        return cls(W=W, E=E, n_tiles=n_tiles, G=G, n_chunks=C,
                   needs_scan=needs_scan, src_local=src_local,
                   rel_dst=rel_dst, weight=weight,
                   chunk_start=chunk_start, last_chunk=last_chunk,
                   stats=stats, src_rel=src_rel, n_valid=n_valid,
                   extract_width=width)

    def streams(self, device=None, wide: int = 1) -> bool:
        """Whether the engines run the fused streamed combine
        (lux_tpu/ops/owner.py:265).  Off the card: once one source
        part's [C, E] f32 message temporary passes STREAM_MSG_BYTES,
        read at call time.  On a card ``device``: only when the
        monolithic form's messages, every part's [C, E, wide] at once,
        do not fit (ops/tiled.stream_by_default)."""
        msg = self.n_chunks * self.E * 4
        if device is not None and torch.device(device).type == "cuda":
            return stream_by_default(
                len(self.chunk_start) * msg * wide, device)
        return msg > STREAM_MSG_BYTES

    def extract_plan(self):
        """The fused streamed combine's extraction plan (extr_pos,
        extr_tile), each int32 [R, nB, L] (lux_tpu/ops/owner.py:271)."""
        L = (extract_plan_width(self.last_chunk, self.n_chunks)
             if self.extract_width is None else self.extract_width)
        return build_extract_plan(self.last_chunk, self.n_chunks, L=L)


def _local_src_edges(sg, n_tiles: int, G: int, mesh=None):
    """The planning-time edge exchange of a local-parts owner build
    (lux_tpu/ops/owner.py:291): every destination part's edge row,
    sent by the rank that holds it to every rank, of which each keeps
    the edges its own source parts emit -> (key, src_local, rel,
    weight) in the full build's per-edge encoding (key = src part * G +
    global dst tile), in destination-part order.  Peak memory is one
    part's edges per rank; traffic is ne x world, once at build time."""
    from lux_tpu_torch.ops.collectives import allgather_host

    P, vpad = sg.num_parts, sg.vpad
    own = np.asarray(sg.local_parts, np.int64)
    own_mask = np.zeros(P, bool)
    own_mask[own] = True
    local_row = {int(p): i for i, p in enumerate(own)}
    holders = np.full(P, -1, np.int64)
    for q, parts in enumerate(allgather_host(mesh, own)):
        holders[np.asarray(parts, np.int64)] = q
    if (holders < 0).any():
        raise ValueError("local_parts rows do not cover every partition "
                         "across the ranks")
    key_l, srcl_l, rel_l, w_l = [], [], [], []
    for r in range(P):
        nep = int(sg.ne_part[r])
        if nep == 0:
            continue
        mine = local_row.get(r)
        row = None
        if mine is not None:
            row = (sg.src_slot[mine, :nep], sg.dst_local[mine, :nep],
                   sg.edge_weight[mine, :nep] if sg.weighted else None)
        row = allgather_host(mesh, row)[int(holders[r])]
        slot = np.asarray(row[0]).astype(np.int64)
        s = slot // vpad
        keep = own_mask[s]
        if not keep.any():
            continue
        s, slot = s[keep], slot[keep]
        dst = np.asarray(row[1]).astype(np.int64)[keep]
        key_l.append(s * G + (r * n_tiles + dst // W))
        srcl_l.append((slot - s * vpad).astype(np.int32))
        rel_l.append((dst % W).astype(np.int8))
        if sg.weighted:
            w_l.append(np.asarray(row[2], np.float32)[keep])
    key = np.concatenate(key_l) if key_l else np.empty(0, np.int64)
    srcl = np.concatenate(srcl_l) if srcl_l else np.empty(0, np.int32)
    rel = np.concatenate(rel_l) if rel_l else np.empty(0, np.int8)
    wgt = (np.concatenate(w_l) if w_l
           else (np.empty(0, np.float32) if sg.weighted else None))
    return key, srcl, rel, wgt


@dataclasses.dataclass(frozen=True)
class OwnerGeometry:
    """The scalars of an OwnerLayout: what the device side needs once
    the arrays are on the device."""

    W: int
    E: int
    n_tiles: int
    G: int
    n_chunks: int
    needs_scan: bool


# graph-array keys of the owner layout (lux_tpu/ops/owner.py:380):
# own_sr / own_nv packed, own_src / own_rel classic, own_w weighted,
# own_ep / own_et when the layout streams (the extraction plan)
OWNER_SCAN_KEYS = ("own_src", "own_rel", "own_cs", "own_lc", "own_w",
                   "own_ep", "own_et", "own_sr", "own_nv")


def owner_graph_arrays(lay: OwnerLayout, stream: bool | None = None) -> dict:
    """The layout's host arrays under the reference's keys
    (lux_tpu/engine/pull.py:153 ``_owner_edge_arrays`` and :305-321);
    the extraction plan when the layout streams (``stream`` None: by
    ``lay.streams()``, the rule off the card)."""
    if lay.packed:
        arrays = dict(own_sr=lay.src_rel, own_nv=lay.n_valid)
    else:
        arrays = dict(own_src=lay.src_local, own_rel=lay.rel_dst)
    arrays.update(own_cs=lay.chunk_start, own_lc=lay.last_chunk)
    if lay.weight is not None:
        arrays["own_w"] = lay.weight
    if lay.streams() if stream is None else stream:
        ep, et = lay.extract_plan()
        arrays.update(own_ep=ep, own_et=et)
    return arrays


def decoded_slots(a: dict):
    """(src int32 [P, C, E] into each part's own shard, pads 0; rel int8,
    pads -1) from an engine's owner arrays, packed or classic."""
    if "own_sr" in a:
        return unpack_src_rel(a["own_sr"], a["own_nv"])
    return a["own_src"], a["own_rel"]


def gather_messages(state: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Each slot's source value [P, C*E, ...] from ``state`` [P, vpad,
    ...] by ``src`` [P, C, E] (own-shard indices): one ``index_select``
    a source part on its own [vpad] shard."""
    from lux_tpu_torch.engine.pull import gather_rows
    P = state.shape[0]
    trail = tuple(state.shape[2:])
    out = state.new_empty((P, src[0].numel()) + trail)
    for s in range(P):
        gather_rows(state[s], src[s].reshape(-1), out=out[s])
    return out


def owner_partials(geom, state, a: dict, kind: str, msg_fn,
                   use_mxu: bool = False, rel32=None, occ=None):
    """The monolithic form's per-chunk partials [P*C, W, ...]: decode,
    gather (``gather_messages``), messages, then one launch of kernel B1
    (or its batched form, or the one-hot forms) over every source part's
    chunks."""
    P, C, E = state.shape[0], geom.n_chunks, geom.E
    src, rel = decoded_slots(a)
    vals = gather_messages(state, src).view(
        (P, C, E) + tuple(state.shape[2:]))
    msgs = msg_fn(vals, a.get("own_w"))
    return reduce_partials(msgs.reshape((P * C, E) + tuple(msgs.shape[3:])),
                           rel.reshape(P * C, E), geom.W, kind, use_mxu,
                           rel32, occ)


def fold_parts(tiles: torch.Tensor, num_parts: int, kind: str):
    """[P_src, G, W, ...] tile contributions -> [P_dst, n_tiles * W, ...]:
    from the identity, each source part's folded in order 0..P-1, as
    the reference's scan folds them (lux_tpu/ops/owner.py:386)."""
    P = tiles.shape[0]
    contrib = tiles.reshape((P, num_parts, -1) + tuple(tiles.shape[3:]))
    comb = combine_op(kind)
    acc = torch.full(tuple(contrib.shape[1:]),
                     identity_for(kind, contrib.dtype), dtype=contrib.dtype,
                     device=contrib.device)
    for s in range(P):
        acc = comb(acc, contrib[s])
    return acc


def owner_contribs(geom, state, a: dict, kind: str, msg_fn,
                   num_parts: int, use_mxu: bool = False, plan=None,
                   rel32=None, max_run: int | None = None, occ=None):
    """Every source part's contribution to every destination part,
    folded across source parts -> [P, n_tiles * W, ...]
    (lux_tpu/ops/owner.py:386).  ``state`` [P, vpad, ...]; ``a`` the
    engine's owner arrays (OWNER_SCAN_KEYS).  With the extraction plan
    (``own_ep``: a layout past the stream budget) each source part runs
    the fused streamed combine on its own shard (``max_run``: the
    longest segment); otherwise the monolithic form: ``owner_partials``
    (one B1 launch over [P*C, E]) and one segmented combine over [P, C]
    (``plan``: its ops/tiled.SegmentPlan).  ``occ``: the [P*C, W]
    ``lane_occupancy`` of use_mxu's tournament."""
    if "own_ep" in a:
        packed = "own_sr" in a
        tiles = torch.stack([streamed_chunk_combined(
            state[s], a["own_sr"][s] if packed else a["own_src"][s],
            None if packed else a["own_rel"][s],
            None if "own_w" not in a else a["own_w"][s], geom, kind,
            msg_fn, a["own_cs"][s], a["own_ep"][s], a["own_et"][s],
            a["own_lc"][s], use_mxu=use_mxu,
            nvalid=a["own_nv"][s] if packed else None, max_run=max_run,
            occ=None if occ is None else occ.view(
                state.shape[0], -1, geom.W)[s])
            for s in range(state.shape[0])])
    else:
        partials = owner_partials(geom, state, a, kind, msg_fn, use_mxu,
                                  rel32, occ)
        tiles = combine_chunks(partials, geom, a["own_cs"], a["own_lc"],
                               kind, plan, use_mxu)
    return fold_parts(tiles, num_parts, kind)


def owner_exchange(acc, kind: str, axis=None, ndev: int = 1,
                   minmax_fused: bool = False):
    """Route the accumulated contributions [P, ntw, ...] to their
    destination parts (lux_tpu/ops/owner.py:433).  One device
    (``axis=None``): the identity, whatever ``minmax_fused`` says, as
    in the reference.  ``axis`` a mesh: this rank's rows [P/world, ntw,
    ...] of the contributions combined across ranks: a sum by one
    reduce-scatter, a min or max by an all_to_all and a local min /
    max, or with ``minmax_fused`` by ``ring_reduce_scatter``.  ``ndev``
    is the mesh's world (the reference's argument; checked)."""
    if axis is None:
        return acc
    from lux_tpu_torch.ops.collectives import (all_to_all_parts,
                                               reduce_scatter_parts)
    mesh = axis
    if ndev not in (1, mesh.world):
        raise ValueError(f"ndev={ndev} is not the mesh's world "
                         f"{mesh.world}")
    if kind == "sum":
        return reduce_scatter_parts(mesh, acc, "sum")
    if kind not in ("min", "max"):
        raise ValueError(f"unknown reduction {kind!r}")
    if minmax_fused:
        return ring_reduce_scatter(acc, kind, mesh, mesh.world)
    recv = all_to_all_parts(mesh, acc)
    red = recv.reshape((mesh.world, acc.shape[0] // mesh.world)
                       + tuple(acc.shape[1:]))
    return red.amin(0) if kind == "min" else red.amax(0)


def ring_reduce_scatter(acc, kind: str, axis, ndev: int):
    """The ring reduce-scatter (lux_tpu/ops/owner.py:466): ``acc`` [P,
    ...] on every rank of the mesh ``axis`` -> this rank's rows
    [P/world, ...] combined by ``kind`` across ranks, the contract of
    the sum's reduce-scatter.  Block ``c`` starts at rank ``c + 1`` and
    travels the ring ``c + 1 -> c + 2 -> ... -> c``, each hop folding
    the visited rank's contribution: world - 1 hops of one [P/world,
    ...] block each."""
    from lux_tpu_torch.ops.collectives import ring_shift
    mesh = axis
    if ndev != mesh.world:
        raise ValueError(f"ndev={ndev} is not the mesh's world "
                         f"{mesh.world}")
    comb = combine_op(kind)
    rows = acc.shape[0] // ndev
    chunks = acc.reshape((ndev, rows) + tuple(acc.shape[1:]))
    idx = mesh.rank
    # rank i launches its contribution to block i - 1
    cur = chunks[(idx - 1) % ndev].contiguous()
    for s in range(ndev - 1):
        cur = ring_shift(mesh, cur)
        # after hop s rank i holds block (i - 2 - s) mod ndev and folds
        # its own contribution; the last hop lands block i at rank i
        cur = comb(cur, chunks[(idx - 2 - s) % ndev])
    return cur
