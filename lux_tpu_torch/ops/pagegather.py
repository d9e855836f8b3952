"""Page-binned two-level gather (counterpart of
lux_tpu/ops/pagegather.py:76-1140 and :1231-1459, dense engines).

The host plan (numpy, built once) bins every edge of a part by
(destination tile, source PAGE), where a page is one 128-wide row of
the reshaped state table ``[P * vpad / 128, 128]``:

- each bin of n edges becomes ceil(n / 128) delivery rows bound to ONE
  page; a row's 128 lanes carry (source lane, destination offset)
  pairs, dead lanes carry rel = -1;
- pages are deduplicated per part into ``page_ids``; each lane packs
  ``page_slot << 7 | lane`` into one uint32 (every lane of a row
  shares its page_slot, so the row's page decodes from lane 0);
- rows group per destination tile in depth classes
  (ops/pairs.quantize_depths) against the elementwise-max profile of
  all parts, so one class structure serves every part.

The page-major plan (``mode="pagemajor"``) binds full 128-lane GATHER
rows to pages first; the reduce runs over VIRTUAL rows (one per
(gather row, dst tile) run), each picking its gather row through
``vrow_src``.

The binning sorts are the reference's stable radix ``native.sort_kv``
(under ``native.numpy_versions()``: numpy's stable argsort, the same
permutation), so the plans are array-equal to the reference's,
padding shapes included.

Device side (``paged_partial``), every part in one launch of each
kernel:

1. ``pages = index_select(state2d, page_ids)``   [P*n_pages, 128]
2. ``rows = index_select(pages, page_slot)``      [P*Rg, 128]
3. ``vals = lane_shuffle(rows, slot_lane)``       kernel B2
4. page-major: ``vals = index_select(vals, vrow_src)``  [P*Rp, 128]
5. ``partials = chunk_partials(msgs, rel)``       kernel B1, E = 128
6. ``class_combine`` -> [P, n_tiles * 128]

Query-batched states [P*vpad, B] (``_paged_partial_rows``) fetch the
pages as [P*n_pages, 128, B], resolve the lanes by ``torch.gather``
(the reference's ``take_along_axis``; B2 moves scalar rows), page-major
rows through their gather row's lanes, all in blocks of rows under
``PAGED_BLOCK_BYTES``; the [P*Rp, 128, B] messages are then reduced by
ONE launch of B1's batched form (ops/chunk_reduce.py).

Vector-state dot programs (colfilter) take ``paged_partial_dot``: the
pair rows' SDDMM step (ops/dot.py) on page rows, each lane's source row
selected from its page by an index gather; no hand kernel.

On the device ``slot_lane`` rides as int32 with the uint32's bits;
page slots decode as ``(x >> 7) & 0x1FFFFFF``, lanes as ``x & 0x7F``.
``gather="auto"`` resolves flat, paged or page-major through
scalemodel's break-even on the counted plan stats (``resolve_gather``).
The owner-exchange plans (ROADMAP A6a-2) are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch import native as _native
from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                            chunk_partials_batched)
from lux_tpu_torch.ops.dot import DotBlock, blocks, run_blocks
from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
from lux_tpu_torch.ops.pairs import (DOT_BLOCK_ROWS, class_combine,
                                     dot_msgs_numpy, part_tile0,
                                     quantize_depths)
from lux_tpu_torch.ops.segment import identity_for

W = 128

# page_slot rides the high 25 bits of the packed uint32 (lane is 7
# bits at W = 128)
PAGE_SLOT_MAX = 1 << 25
SLOT_MASK = PAGE_SLOT_MAX - 1

GATHER_MODES = ("flat", "paged", "pagemajor")


@dataclasses.dataclass
class PagedPlan:
    """Stacked (all-parts) page-binned delivery plan (host numpy).

    page_ids  int32 [P, n_pages]     deduplicated state2d page rows per
                                     part (pad entries point at page 0)
    slot_lane uint32 [P, Rp|Rg, 128] packed ``page_slot << 7 | lane``;
                                     dead lanes carry lane 0
    rel_dst   int8 [P, Rp, 128]      dst offset in [0, 128); -1 = dead
    weight    f32 [P, Rp, 128] | None  per-lane edge weight (0 dead)
    row_tile  int32 [P, Rp]          dst tile of each row (dead -> 0)
    tile_pos  int32 [P, n_tiles]     class slot per tile; tiles with no
                                     slot point at ``n_slots``
    classes   [(count, depth)]       shared by every part
    vrow_src  int32 [P, Rp] | None   page-major: virtual row -> gather
                                     row (``slot_lane`` then has Rg
                                     gather rows)
    """

    page_ids: np.ndarray
    slot_lane: np.ndarray
    rel_dst: np.ndarray
    weight: np.ndarray | None
    row_tile: np.ndarray
    tile_pos: np.ndarray
    classes: list
    n_tiles: int
    n_slots: int
    R: int
    Rp: int
    n_pages: int
    stats: dict
    mode: str = "paged"
    vrow_src: np.ndarray | None = None
    Rg: int = 0

    @property
    def geometry(self) -> "PageGeometry":
        return PageGeometry(classes=tuple(tuple(c) for c in self.classes),
                            R=self.R, Rp=self.Rp, n_tiles=self.n_tiles,
                            n_slots=self.n_slots, mode=self.mode)


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """The scalars of a PagedPlan — all the device side needs once the
    plan's arrays are on the device."""

    classes: tuple
    R: int
    Rp: int
    n_tiles: int
    n_slots: int
    mode: str = "paged"


# ---------------------------------------------------------------------
# host plan builder
# ---------------------------------------------------------------------


def _part_rows(src_idx, dst_tile, dst_rel, n_dst_tiles: int,
               n_src_rows: int, weights=None):
    """Bin one part's edges by (dst tile, source page) and lay each
    bin into ceil(count/128) full 128-lane rows (tile-major order).

    Returns (row_page, lane int8 [R, 128], rel int8 [R, 128],
    weight f32 [R, 128] | None, row_tile, rows_by_tile); R = 0 for an
    edge-less part."""
    ne = len(src_idx)
    if ne == 0:
        z = np.zeros((0, W), np.int8)
        wz = np.zeros((0, W), np.float32) if weights is not None else None
        return (np.zeros(0, np.int64), z, z.copy(), wz,
                np.zeros(0, np.int64), np.zeros(n_dst_tiles, np.int64))
    src_idx = np.asarray(src_idx, np.int64)
    page = src_idx // W
    lane = (src_idx % W).astype(np.int8)
    rel8 = np.asarray(dst_rel, np.int64).astype(np.int8)
    key, idx = _native.stable_sort(
        np.asarray(dst_tile, np.int64) * np.int64(n_src_rows) + page)
    newg = np.ones(ne, bool)
    newg[1:] = key[1:] != key[:-1]
    bstart = np.nonzero(newg)[0]
    cnt = np.diff(np.concatenate((bstart, [ne])))
    bin_of = np.cumsum(newg) - 1                     # sorted pos -> bin
    off = np.arange(ne, dtype=np.int64) - bstart[bin_of]
    rows_of_bin = -(-cnt // W)
    row_base = np.concatenate(([0], np.cumsum(rows_of_bin)[:-1]))
    row_of = row_base[bin_of] + off // W
    lanepos = off % W
    R = int(rows_of_bin.sum())
    bin_page = key[bstart] % np.int64(n_src_rows)
    bin_tile = key[bstart] // np.int64(n_src_rows)
    row_page = np.repeat(bin_page, rows_of_bin)
    row_tile = np.repeat(bin_tile, rows_of_bin)
    lane_arr = np.zeros((R, W), np.int8)
    rel_arr = np.full((R, W), -1, np.int8)
    lane_arr[row_of, lanepos] = lane[idx]
    rel_arr[row_of, lanepos] = rel8[idx]
    w_arr = None
    if weights is not None:
        w_arr = np.zeros((R, W), np.float32)
        w_arr[row_of, lanepos] = np.asarray(weights, np.float32)[idx]
    # every edge must own a distinct (row, lane)
    delivered = int(np.count_nonzero(rel_arr != -1))
    if delivered != ne:
        raise AssertionError(
            f"paged plan dropped {ne - delivered} of {ne} edges "
            f"(colliding (row, lane) writes)")
    rows_by_tile = np.bincount(row_tile, minlength=n_dst_tiles)
    return row_page, lane_arr, rel_arr, w_arr, row_tile, rows_by_tile


def _pad8_distinct(n: int, avoid: int) -> int:
    """Round up to a multiple of 8 rows, distinct from ``avoid`` (the
    reshaped state table's row count) — the reference's padding rule,
    kept so the plans' shapes are the same."""
    n = max(8, -(-n // 8) * 8)
    while n == avoid:
        n += 8
    return n


def _check_slots(n_src_rows: int):
    if n_src_rows > PAGE_SLOT_MAX:
        raise ValueError(
            f"paged gather needs a state table of <= {PAGE_SLOT_MAX} "
            f"128-wide pages (25-bit page_slot), got {n_src_rows}")


def _class_ladder(parts_by_tile, n_dst_tiles: int):
    """Common depth profile over the parts' per-tile row counts ->
    (depth per slot, row offset per slot, classes, n_slots)."""
    prof = np.zeros(n_dst_tiles, np.int64)
    for by_tile in parts_by_tile:
        prof = np.maximum(prof, np.sort(by_tile)[::-1])
    depth = quantize_depths(prof)
    row_off = np.concatenate(([0], np.cumsum(depth)))
    classes = [(int((depth == L).sum()), int(L))
               for L in np.unique(depth)[::-1] if L > 0]
    return depth, row_off, classes, sum(c for c, _L in classes)


def _tile_slots(by_tile, depth, n_dst_tiles: int, tile_pos_row):
    """Order tiles by descending row count (stable), fill this part's
    ``tile_pos`` row, and return each tile's slot."""
    t_order = np.argsort(-by_tile, kind="stable")
    live = depth > 0
    tile_pos_row[t_order[live]] = np.nonzero(live)[0].astype(np.int32)
    if (by_tile[t_order] > depth).any():
        raise AssertionError("common depth profile does not cover a "
                             "part's per-tile row counts")
    slot_of_tile = np.full(n_dst_tiles, -1, np.int64)
    slot_of_tile[t_order] = np.arange(n_dst_tiles)
    return slot_of_tile


def _tile_major_rows(row_tile, slot_of_tile, row_off, n_dst_tiles: int):
    """Destination row of each tile-sorted row: its tile's slot offset
    plus its position within the tile's run."""
    first = np.bincount(row_tile, minlength=n_dst_tiles)
    first = np.concatenate(([0], np.cumsum(first)[:-1]))
    within = np.arange(len(row_tile)) - first[row_tile]
    return row_off[slot_of_tile[row_tile]] + within


def _pack(page_of_row, uniq, lane):
    pslot = np.searchsorted(uniq, page_of_row).astype(np.uint32)
    return ((pslot[:, None] << np.uint32(7))
            | lane.astype(np.uint32) & np.uint32(0x7F))


def _assemble(parts, n_dst_tiles: int, n_src_rows: int, ne_total: int,
              weighted: bool) -> PagedPlan:
    """Stack per-part ``_part_rows`` outputs against a common depth
    profile (elementwise max over parts, ladder-quantized) so every
    part shares one class structure."""
    _check_slots(n_src_rows)
    P = len(parts)
    depth, row_off, classes, n_slots = _class_ladder(
        [pr[5] for pr in parts], n_dst_tiles)
    Rtot = int(row_off[-1])
    Rp = _pad8_distinct(Rtot, n_src_rows)

    uniq_pages = [np.unique(pr[0]) for pr in parts]
    max_pages = max((len(u) for u in uniq_pages), default=1) or 1
    n_pages = _pad8_distinct(max_pages, n_src_rows)

    page_ids = np.zeros((P, n_pages), np.int32)
    slot_lane = np.zeros((P, Rp, W), np.uint32)
    rel_dst = np.full((P, Rp, W), -1, np.int8)
    wgt = np.zeros((P, Rp, W), np.float32) if weighted else None
    row_tile = np.zeros((P, Rp), np.int32)
    tile_pos = np.full((P, n_dst_tiles), n_slots, np.int32)

    rows_real = 0
    for p, pr in enumerate(parts):
        r_page, lane, rel, w, r_tile, by_tile = pr
        rows_real += len(r_page)
        u = uniq_pages[p]
        page_ids[p, :len(u)] = u.astype(np.int32)
        slot_of_tile = _tile_slots(by_tile, depth, n_dst_tiles,
                                   tile_pos[p])
        if not len(r_page):
            continue
        # rows come out of _part_rows tile-major
        dst = _tile_major_rows(r_tile, slot_of_tile, row_off, n_dst_tiles)
        slot_lane[p, dst] = _pack(r_page, u, lane)
        rel_dst[p, dst] = rel
        row_tile[p, dst] = r_tile.astype(np.int32)
        if weighted:
            wgt[p, dst] = w

    unique_total = sum(len(u) for u in uniq_pages)
    stats = dict(
        ne=ne_total, rows=rows_real, fill=ne_total / max(rows_real, 1),
        unique_pages=unique_total,
        page_ratio=unique_total * W / max(ne_total, 1),
        padded_fill=ne_total / max(P * Rp, 1),
        lane_inflation=P * Rp * W / max(ne_total, 1))
    return PagedPlan(
        page_ids=page_ids, slot_lane=slot_lane, rel_dst=rel_dst,
        weight=wgt, row_tile=row_tile, tile_pos=tile_pos,
        classes=classes, n_tiles=n_dst_tiles, n_slots=n_slots,
        R=Rtot, Rp=Rp, n_pages=n_pages, stats=stats)


def _pm_layout(src_idx, dst_local, n_dst_tiles: int, n_src_rows: int):
    """Index math of the page-major layout: sort a part's edges by
    (source page, destination), then derive each edge's GATHER row
    (full 128-lane rows binding to one page) and its VIRTUAL row (the
    contiguous lane run of one (gather row, dst tile))."""
    ne = len(src_idx)
    src_idx = np.asarray(src_idx, np.int64)
    dst = np.asarray(dst_local, np.int64)
    page = src_idx // W
    lane = (src_idx % W).astype(np.int8)
    D = np.int64(n_dst_tiles) * W
    key, idx = _native.stable_sort(page * D + dst)
    p_key = key // D
    dst_s = key % D
    newp = np.ones(ne, bool)
    newp[1:] = p_key[1:] != p_key[:-1]
    pstart = np.nonzero(newp)[0]
    pcnt = np.diff(np.concatenate((pstart, [ne])))
    rows_of = -(-pcnt // W)
    row_base = np.concatenate(([0], np.cumsum(rows_of)[:-1]))
    pbin = np.cumsum(newp) - 1
    off = np.arange(ne, dtype=np.int64) - pstart[pbin]
    gr = row_base[pbin] + off // W       # gather row of each edge
    lpos = off % W                       # its lane within that row
    Rg = int(rows_of.sum())
    g_page = np.repeat(p_key[pstart] % np.int64(n_src_rows), rows_of)
    # virtual rows: contiguous (gather row, dst tile) runs
    tile = dst_s // W
    vkey = gr * np.int64(n_dst_tiles) + tile
    newv = np.ones(ne, bool)
    newv[1:] = vkey[1:] != vkey[:-1]
    vb = np.nonzero(newv)[0]
    return dict(idx=idx, gr=gr, lpos=lpos, lane=lane, dst_s=dst_s,
                Rg=Rg, g_page=g_page, vid=np.cumsum(newv) - 1, vb=vb,
                vrow_gr=gr[vb], vrow_tile=tile[vb])


def _part_rows_pm(src_idx, dst_local, n_dst_tiles: int, n_src_rows: int,
                  weights=None):
    """One part's page-major rows -> (g_page, glane int8 [Rg, 128],
    vrow_gr, vrow_tile, rel int8 [Rv, 128], w_virtual, rows_by_tile)."""
    ne = len(src_idx)
    if ne == 0:
        z8 = np.zeros((0, W), np.int8)
        zi = np.zeros(0, np.int64)
        zw = np.zeros((0, W), np.float32) if weights is not None else None
        return (zi, z8, zi.copy(), zi.copy(), z8.copy(), zw,
                np.zeros(n_dst_tiles, np.int64))
    L = _pm_layout(src_idx, dst_local, n_dst_tiles, n_src_rows)
    idx, gr, lpos = L["idx"], L["gr"], L["lpos"]
    glane = np.zeros((L["Rg"], W), np.int8)
    glane[gr, lpos] = L["lane"][idx]
    Rv = len(L["vb"])
    rel = np.full((Rv, W), -1, np.int8)
    rel[L["vid"], lpos] = (L["dst_s"] % W).astype(np.int8)
    w_v = None
    if weights is not None:
        w_v = np.zeros((Rv, W), np.float32)
        w_v[L["vid"], lpos] = np.asarray(weights, np.float32)[idx]
    delivered = int(np.count_nonzero(rel != -1))
    if delivered != ne:
        raise AssertionError(
            f"page-major plan dropped {ne - delivered} of {ne} edges "
            f"(colliding (row, lane) writes)")
    rows_by_tile = np.bincount(L["vrow_tile"], minlength=n_dst_tiles)
    return (L["g_page"], glane, L["vrow_gr"], L["vrow_tile"], rel, w_v,
            rows_by_tile)


def _part_bin_stats_pm(src_idx, dst_local, n_dst_tiles: int,
                       n_src_rows: int):
    """Counting half of ``_part_rows_pm``: (virtual rows by tile,
    n virtual rows, n gather rows)."""
    if len(src_idx) == 0:
        return np.zeros(n_dst_tiles, np.int64), 0, 0
    L = _pm_layout(src_idx, dst_local, n_dst_tiles, n_src_rows)
    by_tile = np.bincount(L["vrow_tile"], minlength=n_dst_tiles)
    return by_tile, len(L["vb"]), L["Rg"]


def _assemble_pm(parts, n_dst_tiles: int, n_src_rows: int, ne_total: int,
                 weighted: bool) -> PagedPlan:
    """Stack per-part ``_part_rows_pm`` outputs against a common depth
    profile over the VIRTUAL rows; the gather rows pad to a common
    Rg."""
    _check_slots(n_src_rows)
    P = len(parts)
    depth, row_off, classes, n_slots = _class_ladder(
        [pr[6] for pr in parts], n_dst_tiles)
    Rtot = int(row_off[-1])
    Rp = _pad8_distinct(Rtot, n_src_rows)

    uniq_pages = [np.unique(pr[0]) for pr in parts]
    max_pages = max((len(u) for u in uniq_pages), default=1) or 1
    n_pages = _pad8_distinct(max_pages, n_src_rows)
    Rg_max = max((len(pr[0]) for pr in parts), default=1) or 1
    Rg = _pad8_distinct(Rg_max, n_src_rows)

    page_ids = np.zeros((P, n_pages), np.int32)
    gsl = np.zeros((P, Rg, W), np.uint32)
    rel_dst = np.full((P, Rp, W), -1, np.int8)
    wgt = np.zeros((P, Rp, W), np.float32) if weighted else None
    row_tile = np.zeros((P, Rp), np.int32)
    vrow_src = np.zeros((P, Rp), np.int32)
    tile_pos = np.full((P, n_dst_tiles), n_slots, np.int32)

    g_rows_real = v_rows_real = 0
    for p, pr in enumerate(parts):
        g_page, glane, vrow_gr, vrow_tile, rel, w_v, by_tile = pr
        g_rows_real += len(g_page)
        v_rows_real += len(vrow_gr)
        u = uniq_pages[p]
        page_ids[p, :len(u)] = u.astype(np.int32)
        slot_of_tile = _tile_slots(by_tile, depth, n_dst_tiles,
                                   tile_pos[p])
        if not len(g_page):
            continue
        gsl[p, :len(g_page)] = _pack(g_page, u, glane)
        # virtual rows come out page-major: re-sort them by tile
        ordv = np.argsort(vrow_tile, kind="stable")
        vt = vrow_tile[ordv]
        dst = _tile_major_rows(vt, slot_of_tile, row_off, n_dst_tiles)
        rel_dst[p, dst] = rel[ordv]
        row_tile[p, dst] = vt.astype(np.int32)
        vrow_src[p, dst] = vrow_gr[ordv].astype(np.int32)
        if weighted:
            wgt[p, dst] = w_v[ordv]

    unique_total = sum(len(u) for u in uniq_pages)
    stats = dict(
        ne=ne_total, rows=v_rows_real,
        fill=ne_total / max(v_rows_real, 1),
        unique_pages=unique_total,
        page_ratio=unique_total * W / max(ne_total, 1),
        padded_fill=ne_total / max(P * Rp, 1),
        lane_inflation=P * Rp * W / max(ne_total, 1),
        mode="pagemajor", g_rows=g_rows_real,
        g_fill=ne_total / max(g_rows_real, 1),
        padded_g_fill=ne_total / max(P * Rg, 1))
    return PagedPlan(
        page_ids=page_ids, slot_lane=gsl, rel_dst=rel_dst, weight=wgt,
        row_tile=row_tile, tile_pos=tile_pos, classes=classes,
        n_tiles=n_dst_tiles, n_slots=n_slots, R=Rtot, Rp=Rp,
        n_pages=n_pages, stats=stats, mode="pagemajor",
        vrow_src=vrow_src, Rg=Rg)


def _check_sg(sg):
    if sg.vpad % W:
        raise ValueError("paged gather needs vpad % 128 == 0; build "
                         "the ShardedGraph with vpad_align=128")


def _part_edges(sg, r: int):
    """Part r's real edges: (src slots, local dsts int64, weights)."""
    nep = int(sg.ne_part[r])
    w = np.asarray(sg.edge_weight[r, :nep]) if sg.weighted else None
    return sg.src_slot[r, :nep], sg.dst_local[r, :nep].astype(np.int64), w


def plan_paged_gather(sg) -> PagedPlan:
    """Dense-engine plan: one part per row, pages of the FULL
    ``[num_parts * vpad]`` flat state table, destination tiles the
    part's own ``vpad // 128``."""
    _check_sg(sg)
    n_src_rows = sg.num_parts * sg.vpad // W
    n_dst_tiles = sg.vpad // W
    parts = []
    for r in range(sg.num_parts):
        src, dst, w = _part_edges(sg, r)
        parts.append(_part_rows(src, dst // W, dst % W, n_dst_tiles,
                                n_src_rows, w))
    return _assemble(parts, n_dst_tiles, n_src_rows, int(sg.ne),
                     sg.weighted)


def plan_pagemajor(sg) -> PagedPlan:
    """Dense-engine PAGE-MAJOR plan: gather rows bind to pages of the
    full flat state table, virtual rows carry the per-tile reduce."""
    _check_sg(sg)
    n_src_rows = sg.num_parts * sg.vpad // W
    n_dst_tiles = sg.vpad // W
    parts = [_part_rows_pm(src, dst, n_dst_tiles, n_src_rows, w)
             for src, dst, w in (_part_edges(sg, r)
                                 for r in range(sg.num_parts))]
    return _assemble_pm(parts, n_dst_tiles, n_src_rows, int(sg.ne),
                        sg.weighted)


def _part_bin_stats(src_idx, dst_tile, n_dst_tiles: int,
                    n_src_rows: int):
    """The counting half of ``_part_rows``: per-tile row counts, real
    row count and unique-page count from one key sort."""
    ne = len(src_idx)
    if ne == 0:
        return np.zeros(n_dst_tiles, np.int64), 0, 0
    page = np.asarray(src_idx, np.int64) // W
    key = np.asarray(dst_tile, np.int64) * np.int64(n_src_rows) + page
    _native.sort_kv(key, ())
    newg = np.ones(ne, bool)
    newg[1:] = key[1:] != key[:-1]
    bstart = np.nonzero(newg)[0]
    cnt = np.diff(np.concatenate((bstart, [ne])))
    rows_of_bin = -(-cnt // W)
    bin_tile = key[bstart] // np.int64(n_src_rows)
    rows_by_tile = np.zeros(n_dst_tiles, np.int64)
    np.add.at(rows_by_tile, bin_tile, rows_of_bin)
    uniq = len(np.unique(key[bstart] % np.int64(n_src_rows)))
    return rows_by_tile, int(rows_of_bin.sum()), uniq


def plan_paged_stats(sg, pagemajor: bool = False) -> dict:
    """The dense plan's stats WITHOUT building its arrays (the same
    binning sort, none of the [P, Rp, 128] assembly);
    ``pagemajor=True`` adds the page-major counts under ``pm_*``."""
    _check_sg(sg)
    P = sg.num_parts
    n_dst_tiles = sg.vpad // W
    n_src_rows = P * sg.vpad // W
    prof = np.zeros(n_dst_tiles, np.int64)
    pm_prof = np.zeros(n_dst_tiles, np.int64)
    rows_real = unique_total = pm_vrows = pm_grows = pm_max_sd = 0
    for r in range(P):
        src, dst, _w = _part_edges(sg, r)
        by_tile, n_rows, uniq = _part_bin_stats(src, dst // W, n_dst_tiles,
                                                n_src_rows)
        prof = np.maximum(prof, np.sort(by_tile)[::-1])
        rows_real += n_rows
        unique_total += uniq
        if pagemajor:
            bt, nv_rows, ng_rows = _part_bin_stats_pm(
                src, dst, n_dst_tiles, n_src_rows)
            pm_prof = np.maximum(pm_prof, np.sort(bt)[::-1])
            pm_vrows += nv_rows
            pm_grows += ng_rows
            # the built plan pads every part's gather rows to the max
            pm_max_sd = max(pm_max_sd, ng_rows)
    Rtot = int(np.cumsum(quantize_depths(prof))[-1]) if n_dst_tiles else 0
    Rp = _pad8_distinct(Rtot, n_src_rows)
    ne = int(sg.ne)
    stats = dict(
        ne=ne, rows=rows_real, fill=ne / max(rows_real, 1),
        unique_pages=unique_total,
        page_ratio=unique_total * W / max(ne, 1),
        padded_fill=ne / max(P * Rp, 1),
        lane_inflation=P * Rp * W / max(ne, 1))
    if pagemajor:
        pm_Rtot = int(np.cumsum(quantize_depths(pm_prof))[-1]) \
            if n_dst_tiles else 0
        pm_Rp = _pad8_distinct(pm_Rtot, n_src_rows)
        pm_Rg_total = P * _pad8_distinct(max(pm_max_sd, 1), n_src_rows)
        stats.update(
            pm_rows=pm_vrows,
            pm_vfill=ne / max(pm_vrows, 1),
            pm_padded_vfill=ne / max(P * pm_Rp, 1),
            pm_g_rows=pm_grows,
            pm_g_fill=ne / max(pm_grows, 1),
            pm_g_padded_fill=ne / max(pm_Rg_total, 1))
    return stats


def resolve_gather(gather: str, stats: dict | None = None,
                   table_bytes: float = 0, kdim: int = 1,
                   exchange: str = "gather", constants=None) -> str:
    """'flat', 'paged' and 'pagemajor' pass through; 'auto' arbitrates
    three ways by scalemodel under ``constants`` (the card's by default)
    on the plan's counted ``stats`` (plan_paged_stats), as the
    reference does (lux_tpu/ops/pagegather.py:981-1024): paged wins
    when its delivered ns an edge undercuts the flat gather's rate for
    a ``table_bytes`` state table (the residual path's for ``kdim`` > 1),
    page-major (scalar programs, stats with ``pm_*`` keys) when it
    undercuts both.  Against the owner exchange 'auto' would price the
    owner paged plans, which wait for ROADMAP A6a-2."""
    if gather in GATHER_MODES:
        return gather
    if gather != "auto":
        raise ValueError(f"unknown gather {gather!r} (one of 'paged', "
                         f"'pagemajor', 'flat', 'auto')")
    from lux_tpu_torch import scalemodel as sm
    if exchange == "owner":
        from lux_tpu_torch.engine.pull import NotPortedError
        raise NotPortedError("gather='auto' against the owner exchange "
                             "is not ported yet (ROADMAP A6a-2: the owner "
                             "paged plans); pass gather='flat'")
    if stats is None:
        raise ValueError("gather='auto' resolves from the plan's stats "
                         "(plan_paged_stats)")
    paged = sm.page_gather_ns(stats["page_ratio"],
                              stats.get("padded_fill", stats["fill"]), kdim,
                              constants)
    if kdim > 1:
        baseline = sm.residual_edge_ns(kdim, constants)
    else:
        baseline = sm.flat_gather_ns(table_bytes, constants)
    best, best_ns = "flat", baseline
    if paged < best_ns:
        best, best_ns = "paged", paged
    if kdim <= 1 and "pm_padded_vfill" in stats:
        pm = sm.pagemajor_gather_ns(stats["page_ratio"],
                                    stats["pm_g_padded_fill"],
                                    stats["pm_padded_vfill"],
                                    constants=constants)
        if pm < best_ns:
            best = "pagemajor"
    return best


def state_table_bytes(sg, program) -> int:
    """Bytes of the flat state table an engine's gather reads: the
    program's ``state_bytes`` a vertex, else its identity's itemsize
    times the query batch (lux_tpu/ops/pagegather.py:957-963)."""
    itemsize = getattr(program, "state_bytes", None)
    if itemsize is None:
        ident = getattr(program, "identity", None)
        itemsize = (np.asarray(ident).dtype.itemsize
                    if ident is not None else 4)
        itemsize *= getattr(program, "batch", None) or 1
    return sg.num_parts * sg.vpad * itemsize


def engine_page_plan(sg, gather: str, program,
                     exchange: str = "gather") -> PagedPlan | None:
    """The engines' plan-or-not resolution (lux_tpu/ops/pagegather.py:
    925-975): the paged or page-major plan of a dense (gather-exchange)
    engine, None for the flat gather.  Dot programs
    (``edge_value_from_dot``) take gather='paged' only.  An explicit
    'paged' / 'pagemajor' raises ValueError, with the reference's
    messages, on configurations the plans do not support; 'auto' stays
    flat there, and elsewhere resolves from the counting pass alone
    (``resolve_gather``), so a flat answer builds no plan arrays.
    Under ``exchange="owner"`` the plans are the owner paged plans,
    which wait for ROADMAP A6a-2: 'paged', 'pagemajor' and an 'auto'
    that the plans could serve raise NotPortedError."""
    if gather not in GATHER_MODES + ("auto",):
        resolve_gather(gather)              # the typed ValueError
    if gather == "flat":
        return None
    if exchange == "owner" and gather != "auto":
        from lux_tpu_torch.engine.pull import NotPortedError
        raise NotPortedError(
            f"gather={gather!r} with exchange='owner' (the owner paged "
            f"plans) is not ported yet (ROADMAP A6a-2); pass "
            f"gather='flat'")
    dot = getattr(program, "edge_value_from_dot", None) is not None
    why = None
    if getattr(program, "needs_dst", False) and not dot:
        why = ("programs reading destination state (needs_dst "
               "without edge_value_from_dot) keep the flat gather")
    elif sg.vpad % W:
        why = ("paged gather needs vpad % 128 == 0; build the "
               "ShardedGraph with vpad_align=128")
    elif gather == "pagemajor" and dot:
        why = ("page-major rows split the reduce from the MXU dot "
               "pipeline; K-dim (SDDMM) programs keep gather='paged'")
    if why is not None:
        if gather == "auto":
            return None
        raise ValueError(f"gather={gather!r}: {why}")
    if gather == "auto":
        kdim = 1
        if dot:
            kdim = max(1, (getattr(program, "state_bytes", None) or 4) // 4)
        if exchange == "owner":
            resolve_gather("auto", exchange=exchange)   # A6a-2
        stats = plan_paged_stats(sg, pagemajor=not dot)
        gather = resolve_gather("auto", stats,
                                state_table_bytes(sg, program), kdim)
        if gather == "flat":
            return None
    return plan_pagemajor(sg) if gather == "pagemajor" \
        else plan_paged_gather(sg)


# graph-array keys of a dense paged engine (pg_w when weighted, pg_vrs
# for page-major plans, PAGED_DOT_KEYS for dot programs)
PAGED_KEYS = ("pg_ids", "pg_sl", "pg_rel", "pg_tp")
PAGED_DOT_KEYS = ("pg_rt", "pg_t0")


def plan_graph_arrays(pp: PagedPlan, dot: bool = False,
                      vpad: int | None = None) -> dict:
    """The plan's per-part host arrays for a dense engine's array dict
    (leading dim num_parts), under the reference's key names; ``dot``
    adds each row's destination tile and each part's tile 0 (``vpad``
    needed), which the SDDMM delivery fetches
    (lux_tpu/ops/pagegather.py:1255-1260)."""
    arrays = {"pg_ids": pp.page_ids, "pg_sl": pp.slot_lane,
              "pg_rel": pp.rel_dst, "pg_tp": pp.tile_pos}
    if pp.weight is not None:
        arrays["pg_w"] = pp.weight
    if pp.vrow_src is not None:
        arrays["pg_vrs"] = pp.vrow_src
    if dot:
        arrays["pg_rt"] = pp.row_tile
        arrays["pg_t0"] = part_tile0(pp.page_ids.shape[0], vpad)
    return arrays


# ---------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------


def row_slots(slot_lane: torch.Tensor) -> torch.Tensor:
    """int64 page slot of each row of ``slot_lane`` [..., 128] (int32
    bits of the packed uint32): the logical shift of lane 0."""
    return ((slot_lane[..., 0] >> 7) & SLOT_MASK).to(torch.int64)


def lane_resolve(rows: torch.Tensor, slot_lane: torch.Tensor) -> torch.Tensor:
    """Resolve each lane's value within its row's page:
    ``out[r, c, ...] = rows[r, slot_lane[r, c] & 0x7F, ...]``.  Scalar
    rows [R, 128] take kernel B2 (lane_shuffle); vector rows [R, 128,
    *trail] (query-batched states) one ``torch.gather`` along dim 1
    with the lane broadcast over the trailing dims — the reference's
    ``take_along_axis`` for vector payloads, which its Pallas kernel
    does not take either (lux_tpu/ops/pagegather.py:1068-1083)."""
    if rows.dim() == 2:
        return lane_shuffle(rows, slot_lane)
    trail = tuple(rows.shape[2:])
    lane = (slot_lane & 0x7F).to(torch.int64)
    lane = lane.reshape(tuple(lane.shape) + (1,) * len(trail)).expand(
        tuple(lane.shape) + trail)
    return torch.gather(rows, 1, lane)


def paged_values(flat_state: torch.Tensor, page_ids: torch.Tensor,
                 slot_lane: torch.Tensor) -> torch.Tensor:
    """The two-level gather for every part: unique-page row fetch (the
    state-table access), buffer row fetch, lane resolve (kernel B2 for
    scalar rows).  ``flat_state`` [P*vpad, ...], ``page_ids`` [P,
    n_pages], ``slot_lane`` int32 [P, Rg, 128] -> delivered values
    [P*Rg, 128, ...]."""
    P, n_pages = page_ids.shape
    trail = tuple(flat_state.shape[1:])
    s2d = flat_state.reshape((-1, W) + trail)
    pages = torch.index_select(s2d, 0,
                               page_ids.reshape(-1).to(torch.int64))
    base = torch.arange(P, device=slot_lane.device)[:, None] * n_pages
    rows = torch.index_select(pages, 0,
                              (row_slots(slot_lane) + base).reshape(-1))
    return lane_resolve(rows, slot_lane.reshape(-1, W))


# bytes of one [rows, 128, ...] intermediate of a block of vector rows
# (``paged_partial`` on query-batched states): the messages of every
# row are materialized once, for one launch of B1's batched form, while
# the page fetch and lane resolve run block by block under this budget
PAGED_BLOCK_BYTES = 1 << 30

# the stages of ``_paged_partial_rows`` in order; ``upto`` stops after
# one of them, so that a profile times the engine's own function layer
# by layer (each layer the difference of two cumulative spans)
PAGED_STAGES = ("fetch", "vrow_take", "lane_resolve", "messages",
                "reduce", "combine")


def paged_block_rows(flat_state: torch.Tensor) -> int:
    """Reduce rows a block of ``_paged_partial_rows`` for the vector
    state ``flat_state`` [P*vpad, *trail]: its [n, 128, *trail] values
    stay under ``PAGED_BLOCK_BYTES``."""
    width = int(np.prod(tuple(flat_state.shape[1:])))
    return max(1, PAGED_BLOCK_BYTES
               // (W * width * flat_state.element_size()))


def paged_partial(pp, flat_state, page_ids, slot_lane, rel, weight,
                  tile_pos, kind: str, msg_fn, vrow_src=None,
                  upto: str | None = None):
    """Full paged delivery + reduce for every part ->
    ``[P, n_tiles * 128, ...]`` (identity where no row delivers).
    ``pp`` is a PagedPlan or PageGeometry; msg_fn(vals [..., 128,
    *trail], weight [..., 128] | None) -> messages, elementwise.  Dead
    lanes carry real values that rel == -1 masks in kernel B1.

    ``vrow_src`` [P, Rp] (page-major plans): ``slot_lane`` then holds
    the Rg gather rows, and each virtual reduce row takes its gather
    row's delivered values (one row-granular index_select).

    Vector states ``flat_state`` [P*vpad, *trail] (a query axis) take
    ``_paged_partial_rows``: the same values, reduced by B1's batched
    form; ``upto`` (one of ``PAGED_STAGES``) stops that path after the
    stage it names."""
    if upto is not None and flat_state.dim() == 1:
        raise ValueError("upto= stops the vector-state path only")
    if flat_state.dim() > 1:
        return _paged_partial_rows(pp, flat_state, page_ids, slot_lane,
                                   rel, weight, tile_pos, kind, msg_fn,
                                   vrow_src, upto)
    P = page_ids.shape[0]
    vals = paged_values(flat_state, page_ids, slot_lane)
    if vrow_src is not None:
        base = torch.arange(P, device=vals.device)[:, None] \
            * slot_lane.shape[1]
        vals = torch.index_select(
            vals, 0, (vrow_src.to(torch.int64) + base).reshape(-1))
    msgs = msg_fn(vals.view(P, pp.Rp, W), weight)
    partials = chunk_partials(msgs.reshape(-1, W).contiguous(),
                              rel.reshape(-1, W), W, kind)
    red = class_combine(pp, partials.view(P, pp.Rp, W)[:, :pp.R],
                        tile_pos, kind)
    return red.reshape(P, pp.n_tiles * W)


def paged_row_index(page_ids, slot_lane, vrow_src=None):
    """Per reduce row of every part [P*Rp]: its row of the deduplicated
    page buffer ``index_select(state [P*vpad/128, 128, ...],
    page_ids)`` (int64) and its gather row of ``slot_lane`` (int64;
    ``vrow_src`` + the part's base for page-major plans, the row itself
    otherwise)."""
    P, n_pages = page_ids.shape
    Rg = slot_lane.shape[1]
    dev = slot_lane.device
    page_row = (row_slots(slot_lane)
                + torch.arange(P, device=dev)[:, None] * n_pages
                ).reshape(-1)
    if vrow_src is None:
        return page_row, None
    grow = (vrow_src.to(torch.int64)
            + torch.arange(P, device=dev)[:, None] * Rg).reshape(-1)
    return page_row[grow], grow


def _paged_partial_rows(pp, flat_state, page_ids, slot_lane, rel, weight,
                        tile_pos, kind, msg_fn, vrow_src, upto=None):
    """``paged_partial`` for vector states [P*vpad, *trail]: the page
    fetch, lane resolve and messages run in blocks of reduce rows whose
    [n, 128, *trail] values stay under ``PAGED_BLOCK_BYTES``; the
    messages of all P*Rp rows are then reduced by ONE launch of B1's
    batched form over the flattened trailing width, and the class
    combine follows -> [P, n_tiles * 128, *trail].  Page-major rows
    read their gather row's lanes: the reference's take of the
    delivered values, done on the lane index instead.

    ``upto`` (profiling) stops after the named stage of
    ``PAGED_STAGES`` and returns None up to "lane_resolve", the
    messages [P*Rp, 128, *trail] after "messages" and B1's partials
    after "reduce"."""
    stop = PAGED_STAGES.index(upto or "combine")
    P, n_pages = page_ids.shape
    trail = tuple(flat_state.shape[1:])
    width = int(np.prod(trail))
    n = P * pp.Rp
    pages = torch.index_select(flat_state.reshape((-1, W) + trail), 0,
                               page_ids.reshape(-1).to(torch.int64))
    page_row, grow = paged_row_index(page_ids, slot_lane, vrow_src)
    sl_flat = slot_lane.reshape(-1, W)
    w_flat = None if weight is None else weight.reshape(-1, W)
    step = paged_block_rows(flat_state)
    msgs = None
    for r0 in range(0, n, step):
        sl = slice(r0, min(n, r0 + step))
        rows = torch.index_select(pages, 0, page_row[sl])
        if stop == 0:
            continue
        lanes = sl_flat[sl] if grow is None else \
            torch.index_select(sl_flat, 0, grow[sl])
        if stop == 1:
            continue
        vals = lane_resolve(rows, lanes)
        if stop == 2:
            continue
        m = msg_fn(vals, None if w_flat is None else w_flat[sl])
        if msgs is None:
            msgs = torch.empty((n, W) + trail, dtype=m.dtype,
                               device=m.device)
        msgs[sl] = m
        del rows, vals, m
    if stop < 3:
        return None
    if msgs is None:                        # no rows: identity everywhere
        return torch.full((P, pp.n_tiles * W) + trail,
                          identity_for(kind, flat_state.dtype),
                          dtype=flat_state.dtype, device=flat_state.device)
    if stop == 3:
        return msgs
    partials = chunk_partials_batched(msgs.view(n, W, width),
                                      rel.reshape(-1, W), W, kind)
    del msgs
    if stop == 4:
        return partials
    red = class_combine(pp, partials.view((P, pp.Rp, W) + trail)[:, :pp.R],
                        tile_pos, kind)
    return red.reshape((P, pp.n_tiles * W) + trail)


def paged_dot_blocks(state, page_ids, slot_lane, rel, weight, row_tile,
                     part_tile0, block_rows: int = DOT_BLOCK_ROWS) -> list:
    """The paged dot delivery's blocks: the unique pages are fetched
    once here as [128, K] tiles; each block of ``block_rows`` of the
    [P*Rp] rows then fetches its rows' pages, picks each lane's source
    row from its page by an index gather, and fetches the destination
    tiles ``part_tile0 + row_tile``."""
    P, n_pages = page_ids.shape
    K = state.shape[-1]
    s3 = state.reshape(-1, W, K)
    pages = torch.index_select(s3, 0, page_ids.reshape(-1))
    base = torch.arange(P, device=state.device)[:, None] * n_pages
    rs = (row_slots(slot_lane) + base).reshape(-1)
    lane = (slot_lane & 0x7F).to(torch.int64).reshape(-1, W)
    tile = (part_tile0.reshape(P, 1) + row_tile).reshape(-1)
    rl, wt = rel.reshape(-1, W), weight.reshape(-1, W)

    def fetch(sl, n):
        pg = torch.index_select(pages, 0, rs[sl])           # [n, 128, K]
        S = torch.gather(pg, 1, lane[sl].unsqueeze(-1).expand(n, W, K))
        # dst-tile block fetch: row-granular [*, 128K] movement -- the same
        # fetch pair_partial_dot makes, exempt there because its operand
        # shape differs from the flat table; here the paged table view
        # shares the shape, so the exemption is explicit:
        # audit: allow(gather-budget)
        T = torch.index_select(s3, 0, tile[sl])
        return S, T

    out = []
    for r0, n in blocks(P * slot_lane.shape[1], block_rows):
        sl = slice(r0, r0 + n)
        out.append(DotBlock(fetch=lambda sl=sl, n=n: fetch(sl, n),
                            rel=rl[sl], weight=wt[sl], units=sl))
    return out


def paged_partial_dot(pp, state, page_ids, slot_lane, rel, weight,
                      row_tile, tile_pos, part_tile0, msg_dot_fn,
                      block_rows: int = DOT_BLOCK_ROWS):
    """Paged delivery for vector-state dot programs, every part at once
    -> ``[P, n_tiles * 128, K]`` sums (lux_tpu/ops/pagegather.py:1143).
    ``state`` [P*vpad, K]; the plan's arrays as for ``paged_partial``
    (``slot_lane`` int32 [P, Rp, 128]) plus ``row_tile`` [P, Rp] and
    ``part_tile0`` [P, 1]; ``paged_dot_blocks`` then
    ops/dot.dot_partials a block, then the class combine.  The
    reference picks each lane by a one-hot matmul; the gather gives the
    same bits for finite states, and an inf or NaN in a lane that is
    not picked no longer reaches the result."""
    if weight is None:
        raise ValueError("paged_partial_dot needs per-lane weights")
    P, Rp = slot_lane.shape[:2]
    K = state.shape[-1]
    partials = torch.empty((P * Rp, W, K), dtype=state.dtype,
                           device=state.device)
    run_blocks(paged_dot_blocks(state, page_ids, slot_lane, rel, weight,
                                row_tile, part_tile0, block_rows),
               msg_dot_fn, partials)
    red = class_combine(pp, partials.view(P, Rp, W, K)[:, :pp.R],
                        tile_pos, "sum")
    return red.reshape(P, pp.n_tiles * W, K)


# ---------------------------------------------------------------------
# NumPy oracles
# ---------------------------------------------------------------------


def decode_plan(pp: PagedPlan, p: int):
    """Decode part ``p``'s live lanes back to (src index, dst index)
    pairs: src = page_ids[slot] * 128 + lane, dst = row_tile * 128 +
    rel (page-major plans through each virtual row's gather row)."""
    sl = pp.slot_lane[p]
    rel = pp.rel_dst[p]
    rows, cols = np.nonzero(rel != -1)
    gr = (pp.vrow_src[p][rows].astype(np.int64)
          if pp.vrow_src is not None else rows)
    slot = (sl[gr, 0] >> np.uint32(7)).astype(np.int64)
    lane = (sl[gr, cols] & np.uint32(0x7F)).astype(np.int64)
    src = pp.page_ids[p][slot].astype(np.int64) * W + lane
    dst = pp.row_tile[p][rows].astype(np.int64) * W \
        + rel[rows, cols].astype(np.int64)
    return src, dst


def paged_reduce_numpy(pp: PagedPlan, p: int, state_flat: np.ndarray,
                       kind: str = "sum", msg=None) -> np.ndarray:
    """float64 oracle for one part of a plan -> [n_tiles * 128]
    partial (identity where no row delivers).  msg(vals [Rp, 128],
    weight) maps delivered values to messages."""
    s2d = np.asarray(state_flat, np.float64).reshape(-1, W)
    sl = pp.slot_lane[p]
    slot = (sl[:, 0] >> np.uint32(7)).astype(np.int64)
    lane = (sl & np.uint32(0x7F)).astype(np.int64)
    pages = s2d[pp.page_ids[p].astype(np.int64)]
    vals = np.take_along_axis(pages[slot], lane, axis=1)
    if pp.vrow_src is not None:
        vals = vals[pp.vrow_src[p].astype(np.int64)]
    wp = pp.weight[p] if pp.weight is not None else None
    if msg is not None:
        vals = msg(vals, wp)
    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[kind]
    op = {"sum": np.add, "min": np.minimum, "max": np.maximum}[kind]
    out = np.full(pp.n_tiles * W, ident)
    rel = pp.rel_dst[p].astype(np.int64)
    live = (rel >= 0) & (rel < W)
    rows, cols = np.nonzero(live)
    dst = pp.row_tile[p][rows].astype(np.int64) * W + rel[rows, cols]
    op.at(out, dst, vals[rows, cols])
    return out


def paged_dot_numpy(pp: PagedPlan, p: int, state: np.ndarray,
                    part_tile0: int, msg_dot_fn) -> np.ndarray:
    """float64 oracle for one part of the paged SDDMM delivery
    (lux_tpu/ops/pagegather.py:1462) -> [n_tiles * 128, K]: every live
    lane decoded to its (source, destination) edge, msgs =
    msg_dot_fn(S, <S, T>, w) summed per destination.  With
    integer-valued states and weights whose sums stay under 2^24 it
    equals the f32 device result exactly."""
    src, dst = decode_plan(pp, p)
    rel = pp.rel_dst[p]
    rows, cols = np.nonzero(rel != -1)
    msg = dot_msgs_numpy(state, src, dst + part_tile0 * W,
                         pp.weight[p][rows, cols], msg_dot_fn)
    out = np.zeros((pp.n_tiles * W, msg.shape[-1]))
    np.add.at(out, dst, msg)
    return out
