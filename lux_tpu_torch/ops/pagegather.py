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

The owner-exchange plans (lux_tpu/ops/pagegather.py:543-711, :878-924,
:1264-1364): ``plan_owner_paged`` bins each SOURCE part's edges by
(global destination tile, page of its own [vpad] shard);
``paged_owner_contribs`` runs the delivery above against every shard
(one ``index_select`` of pages a source part, then B2 and B1 once each
over every part's rows) and folds the [P_src, G, 128] tile partials
across source parts in order.  ``plan_owner_pagemajor`` groups each
source part's full gather rows by destination part, ``Mg`` rows a
(source, destination) pair; ``pagemajor_owner_deliver`` gathers and
messages them sender-side (B2 once), routes them whole (on one device
a transpose), and each destination part reduces its received buffer
through its virtual rows (B1 once over every part's rows).  An exchange
axis (several GPUs) is ROADMAP A6b-2.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

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

    Owner-exchange plans (``owner=True``) lead with SOURCE parts: pages
    lie in each part's own [vpad] shard and destination tiles are
    global (n_tiles = G = P * vpad / 128).  The owner page-major plan
    groups each source part's gather rows by DESTINATION part, ``route``
    = Mg rows a (source, destination) pair, weights on the sender side
    (``weight`` [P, P*Mg, 128]); its rel_dst / row_tile / tile_pos /
    vrow_src lead with DESTINATION parts, and vrow_src indexes the
    routed [P_src * Mg] row buffer.
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
    route: int = 0                  # Mg rows a (src, dst) pair (owner pm)
    owner: bool = False             # an owner-exchange plan

    @property
    def geometry(self) -> "PageGeometry":
        return PageGeometry(classes=tuple(tuple(c) for c in self.classes),
                            R=self.R, Rp=self.Rp, n_tiles=self.n_tiles,
                            n_slots=self.n_slots, mode=self.mode,
                            route=self.route, owner=self.owner)


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
    route: int = 0
    owner: bool = False


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


def _per_part(fn, items) -> list:
    """``fn(*item)`` for each part's item, on host threads (the native
    sort and numpy's array passes release the GIL), results in part
    order: each part's rows depend on its own edges only."""
    items = list(items)
    n = min(len(items), os.cpu_count() or 1)
    if n <= 1:
        return [fn(*it) for it in items]
    with ThreadPoolExecutor(n) as ex:
        return list(ex.map(lambda it: fn(*it), items))


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
    """``page_slot << 7 | lane`` [R, 128] uint32, built in place."""
    out = lane.astype(np.uint32)
    out &= np.uint32(0x7F)
    out |= (np.searchsorted(uniq, page_of_row).astype(np.uint32)
            << np.uint32(7))[:, None]
    return out


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

    def place(p, pr):
        r_page, lane, rel, w, r_tile, by_tile = pr
        u = uniq_pages[p]
        page_ids[p, :len(u)] = u.astype(np.int32)
        slot_of_tile = _tile_slots(by_tile, depth, n_dst_tiles,
                                   tile_pos[p])
        if not len(r_page):
            return
        # rows come out of _part_rows tile-major
        dst = _tile_major_rows(r_tile, slot_of_tile, row_off, n_dst_tiles)
        slot_lane[p, dst] = _pack(r_page, u, lane)
        rel_dst[p, dst] = rel
        row_tile[p, dst] = r_tile.astype(np.int32)
        if weighted:
            wgt[p, dst] = w

    _per_part(place, enumerate(parts))    # each part writes its own rows
    rows_real = sum(len(pr[0]) for pr in parts)
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


def _pm_layout(src_idx, dst_local, n_dst_tiles: int, n_src_rows: int,
               group=None):
    """Index math of the page-major layout: sort a part's edges by (row
    group, source page, destination), then derive each edge's GATHER
    row (full 128-lane rows binding to one (group, page)) and its
    VIRTUAL row (the contiguous lane run of one (gather row, dst
    tile)).  ``group``: the row-group key (the DESTINATION part for the
    owner routing plan; None = one group)."""
    ne = len(src_idx)
    src_idx = np.asarray(src_idx, np.int64)
    dst = np.asarray(dst_local, np.int64)
    page = src_idx // W
    lane = (src_idx % W).astype(np.int8)
    grp = (np.zeros(ne, np.int64) if group is None
           else np.asarray(group, np.int64))
    D = np.int64(n_dst_tiles) * W
    key, idx = _native.stable_sort((grp * np.int64(n_src_rows) + page) * D
                                   + dst)
    gp_key = key // D                    # group * n_src_rows + page
    dst_s = key % D
    newp = np.ones(ne, bool)
    newp[1:] = gp_key[1:] != gp_key[:-1]
    pstart = np.nonzero(newp)[0]
    pcnt = np.diff(np.concatenate((pstart, [ne])))
    rows_of = -(-pcnt // W)
    row_base = np.concatenate(([0], np.cumsum(rows_of)[:-1]))
    pbin = np.cumsum(newp) - 1
    off = np.arange(ne, dtype=np.int64) - pstart[pbin]
    gr = row_base[pbin] + off // W       # gather row of each edge
    lpos = off % W                       # its lane within that row
    Rg = int(rows_of.sum())
    g_page = np.repeat(gp_key[pstart] % np.int64(n_src_rows), rows_of)
    g_group = np.repeat(gp_key[pstart] // np.int64(n_src_rows), rows_of)
    # virtual rows: contiguous (gather row, dst tile) runs
    tile = dst_s // W
    vkey = gr * np.int64(n_dst_tiles) + tile
    newv = np.ones(ne, bool)
    newv[1:] = vkey[1:] != vkey[:-1]
    vb = np.nonzero(newv)[0]
    return dict(idx=idx, gr=gr, lpos=lpos, lane=lane, dst_s=dst_s,
                Rg=Rg, g_page=g_page, g_group=g_group,
                vid=np.cumsum(newv) - 1, vb=vb, vrow_gr=gr[vb],
                vrow_tile=tile[vb])


def _part_rows_pm(src_idx, dst_local, n_dst_tiles: int, n_src_rows: int,
                  weights=None, group=None):
    """One part's page-major rows -> (g_page, g_group, glane int8 [Rg,
    128], w_gather, vrow_gr, vrow_tile, rel int8 [Rv, 128], w_virtual,
    rows_by_tile)."""
    ne = len(src_idx)
    if ne == 0:
        z8 = np.zeros((0, W), np.int8)
        zi = np.zeros(0, np.int64)
        zw = np.zeros((0, W), np.float32) if weights is not None else None
        return (zi, zi.copy(), z8, zw, zi.copy(), zi.copy(), z8.copy(),
                None if zw is None else zw.copy(),
                np.zeros(n_dst_tiles, np.int64))
    L = _pm_layout(src_idx, dst_local, n_dst_tiles, n_src_rows, group)
    idx, gr, lpos = L["idx"], L["gr"], L["lpos"]
    glane = np.zeros((L["Rg"], W), np.int8)
    glane[gr, lpos] = L["lane"][idx]
    Rv = len(L["vb"])
    rel = np.full((Rv, W), -1, np.int8)
    rel[L["vid"], lpos] = (L["dst_s"] % W).astype(np.int8)
    w_g = w_v = None
    if weights is not None:
        ws = np.asarray(weights, np.float32)[idx]
        w_g = np.zeros((L["Rg"], W), np.float32)
        w_g[gr, lpos] = ws
        w_v = np.zeros((Rv, W), np.float32)
        w_v[L["vid"], lpos] = ws
    delivered = int(np.count_nonzero(rel != -1))
    if delivered != ne:
        raise AssertionError(
            f"page-major plan dropped {ne - delivered} of {ne} edges "
            f"(colliding (row, lane) writes)")
    rows_by_tile = np.bincount(L["vrow_tile"], minlength=n_dst_tiles)
    return (L["g_page"], L["g_group"], glane, w_g, L["vrow_gr"],
            L["vrow_tile"], rel, w_v, rows_by_tile)


def _part_bin_stats_pm(src_idx, dst_local, n_dst_tiles: int,
                       n_src_rows: int, group=None, n_groups: int = 1):
    """Counting half of ``_part_rows_pm``: (virtual rows by tile,
    n virtual rows, n gather rows, gather rows by group)."""
    if len(src_idx) == 0:
        return (np.zeros(n_dst_tiles, np.int64), 0, 0,
                np.zeros(n_groups, np.int64))
    L = _pm_layout(src_idx, dst_local, n_dst_tiles, n_src_rows, group)
    by_tile = np.bincount(L["vrow_tile"], minlength=n_dst_tiles)
    by_group = np.bincount(L["g_group"], minlength=n_groups)
    return by_tile, len(L["vb"]), L["Rg"], by_group


def _assemble_pm(parts, n_dst_tiles: int, n_src_rows: int, ne_total: int,
                 weighted: bool) -> PagedPlan:
    """Stack per-part ``_part_rows_pm`` outputs against a common depth
    profile over the VIRTUAL rows; the gather rows pad to a common
    Rg."""
    _check_slots(n_src_rows)
    P = len(parts)
    depth, row_off, classes, n_slots = _class_ladder(
        [pr[8] for pr in parts], n_dst_tiles)
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

    def place(p, pr):
        g_page, _gg, glane, _wg, vrow_gr, vrow_tile, rel, w_v, by_tile = pr
        u = uniq_pages[p]
        page_ids[p, :len(u)] = u.astype(np.int32)
        slot_of_tile = _tile_slots(by_tile, depth, n_dst_tiles,
                                   tile_pos[p])
        if not len(g_page):
            return
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

    _per_part(place, enumerate(parts))    # each part writes its own rows
    g_rows_real = sum(len(pr[0]) for pr in parts)
    v_rows_real = sum(len(pr[4]) for pr in parts)
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
    parts = _per_part(
        lambda src, dst, w: _part_rows(src, dst // W, dst % W, n_dst_tiles,
                                       n_src_rows, w),
        (_part_edges(sg, r) for r in range(sg.num_parts)))
    return _assemble(parts, n_dst_tiles, n_src_rows, int(sg.ne),
                     sg.weighted)


def plan_pagemajor(sg) -> PagedPlan:
    """Dense-engine PAGE-MAJOR plan: gather rows bind to pages of the
    full flat state table, virtual rows carry the per-tile reduce."""
    _check_sg(sg)
    n_src_rows = sg.num_parts * sg.vpad // W
    n_dst_tiles = sg.vpad // W
    parts = _per_part(
        lambda src, dst, w: _part_rows_pm(src, dst, n_dst_tiles,
                                          n_src_rows, w),
        (_part_edges(sg, r) for r in range(sg.num_parts)))
    return _assemble_pm(parts, n_dst_tiles, n_src_rows, int(sg.ne),
                        sg.weighted)


def _owner_part_edges(sg):
    """Edges regrouped per SOURCE part (the owner layout's
    src-part-major view; lux_tpu/ops/pagegather.py:878): yields one
    (src_local, global_dst_tile, rel, weight) tuple a source part."""
    P, vpad = sg.num_parts, sg.vpad
    n_tiles_part = vpad // W
    sp_l, srcl_l, gt_l, rel_l, w_l = [], [], [], [], []
    for r in range(P):
        src, dst, w = _part_edges(sg, r)
        slot = np.asarray(src, np.int64)
        s = slot // vpad
        sp_l.append(s)
        srcl_l.append(slot - s * vpad)
        gt_l.append(r * n_tiles_part + dst // W)
        rel_l.append(dst % W)
        if w is not None:
            w_l.append(w)
    sp = np.concatenate(sp_l) if sp_l else np.zeros(0, np.int64)
    srcl = np.concatenate(srcl_l) if srcl_l else np.zeros(0, np.int64)
    gt = np.concatenate(gt_l) if gt_l else np.zeros(0, np.int64)
    rel = np.concatenate(rel_l) if rel_l else np.zeros(0, np.int64)
    wall = np.concatenate(w_l).astype(np.float32) if w_l else None
    del sp_l, srcl_l, gt_l, rel_l, w_l
    # one stable sort by source part: each part's edges in their
    # original order, as a mask per part would select them
    _native.sort_kv(sp, (srcl, gt, rel) + (() if wall is None else (wall,)))
    cut = np.searchsorted(sp, np.arange(P + 1))
    for s in range(P):
        lo, hi = cut[s], cut[s + 1]
        yield (srcl[lo:hi], gt[lo:hi], rel[lo:hi],
               wall[lo:hi] if wall is not None else None)


def plan_owner_paged(sg) -> PagedPlan:
    """Owner-exchange plan (lux_tpu/ops/pagegather.py:907): one row a
    SOURCE part, pages within the part's OWN [vpad] state shard,
    destination tiles GLOBAL (G = num_parts * vpad / 128).  The device
    runs the paged delivery against each shard and folds the [G, 128]
    tile partials across source parts (``paged_owner_contribs``)."""
    _check_sg(sg)
    G = sg.num_parts * sg.vpad // W
    n_src_rows = sg.vpad // W
    parts = _per_part(
        lambda srcl, gt, rel, w: _part_rows(srcl, gt, rel, G, n_src_rows, w),
        _owner_part_edges(sg))
    pp = _assemble(parts, G, n_src_rows, int(sg.ne), sg.weighted)
    pp.owner = True
    return pp


def _runpos(sorted_vals: np.ndarray) -> np.ndarray:
    """Position of each element within its run of equal values
    (``sorted_vals`` ascending; lux_tpu/ops/pagegather.py:701)."""
    n = len(sorted_vals)
    if n == 0:
        return np.zeros(0, np.int64)
    new = np.ones(n, bool)
    new[1:] = sorted_vals[1:] != sorted_vals[:-1]
    start = np.nonzero(new)[0]
    return np.arange(n) - start[np.cumsum(new) - 1]


def plan_owner_pagemajor(sg) -> PagedPlan:
    """Owner-exchange PAGE-MAJOR plan (lux_tpu/ops/pagegather.py:543):
    each SOURCE part's gather rows bind to (destination part, page of
    its own shard), grouped by destination part and padded to a common
    ``Mg`` rows a (src, dst) pair, so whole rows route to their
    destination part (on one device a transpose, ``pagemajor_owner_
    deliver``); each DESTINATION part reduces its received [P_src * Mg]
    row buffer through virtual rows over its own tiles.  Weights ride
    the sender side: messages are complete before the route."""
    _check_sg(sg)
    P, vpad = sg.num_parts, sg.vpad
    n_tiles = vpad // W
    n_src_rows = vpad // W
    _check_slots(n_src_rows)
    built = _per_part(
        lambda srcl, gt, rel, w: _part_rows_pm(
            srcl, (gt % n_tiles) * W + rel, n_tiles, n_src_rows, weights=w,
            group=gt // n_tiles),
        _owner_part_edges(sg))
    # routing quantum: Mg rows a (src, dst) pair, every pair padded to
    # the max (the route needs equal splits)
    Mg = 8
    for pr in built:
        if len(pr[1]):
            Mg = max(Mg, int(np.bincount(pr[1], minlength=P).max()))
    Mg = -(-Mg // 8) * 8

    by_tile_d = np.zeros((P, n_tiles), np.int64)   # dst part x tile
    for pr in built:
        g_group, vrow_gr, vrow_tile = pr[1], pr[4], pr[5]
        np.add.at(by_tile_d, (g_group[vrow_gr], vrow_tile), 1)
    depth, row_off, classes, n_slots = _class_ladder(list(by_tile_d),
                                                     n_tiles)
    Rtot = int(row_off[-1])
    Rp = _pad8_distinct(Rtot, n_src_rows)

    uniq_pages = [np.unique(pr[0]) for pr in built]
    max_pages = max((len(u) for u in uniq_pages), default=1) or 1
    n_pages = _pad8_distinct(max_pages, n_src_rows)

    page_ids = np.zeros((P, n_pages), np.int32)
    gsl = np.zeros((P, P * Mg, W), np.uint32)
    w_send = np.zeros((P, P * Mg, W), np.float32) if sg.weighted else None
    rel_dst = np.full((P, Rp, W), -1, np.int8)
    row_tile = np.zeros((P, Rp), np.int32)
    vrow_src = np.zeros((P, Rp), np.int32)
    tile_pos = np.full((P, n_tiles), n_slots, np.int32)

    # receiver side: each destination part's slots from the common
    # profile; its per-tile cursors persist across source parts, so rows
    # of one tile from several senders stack in source order
    slot_of_tile_d = [_tile_slots(by_tile_d[d], depth, n_tiles, tile_pos[d])
                      for d in range(P)]
    cursor_d = np.zeros((P, n_tiles), np.int64)

    g_rows_real = v_rows_real = 0
    for s, pr in enumerate(built):
        g_page, g_group, glane, w_g, vrow_gr, vrow_tile, rel, _wv, _bt = pr
        g_rows_real += len(g_page)
        v_rows_real += len(vrow_gr)
        u = uniq_pages[s]
        page_ids[s, :len(u)] = u.astype(np.int32)
        if not len(g_page):
            continue
        # gather rows grouped by dst part (the sort made them
        # contiguous): row j of the (s -> d) block lands at d * Mg + j
        first_of_d = np.bincount(g_group, minlength=P)
        if (first_of_d > Mg).any():
            raise AssertionError("Mg does not cover a (src, dst) row block")
        first_of_d = np.concatenate(([0], np.cumsum(first_of_d)[:-1]))
        j = np.arange(len(g_page)) - first_of_d[g_group]
        send_pos = g_group * Mg + j
        gsl[s, send_pos] = _pack(g_page, u, glane)
        if w_send is not None and w_g is not None:
            w_send[s, send_pos] = w_g
        # virtual rows land on their dst part's receive plan; gather row
        # g sits at s * Mg + j[g] of the routed buffer
        vg = g_group[vrow_gr]
        buf_idx = s * Mg + j[vrow_gr]
        for d in range(P):
            m = vg == d
            if not m.any():
                continue
            vt = vrow_tile[m]
            ordv = np.argsort(vt, kind="stable")
            vt = vt[ordv]
            within = cursor_d[d][vt] + _runpos(vt)
            cursor_d[d] += np.bincount(vt, minlength=n_tiles)
            dstp = row_off[slot_of_tile_d[d][vt]] + within
            rel_dst[d, dstp] = rel[m][ordv]
            row_tile[d, dstp] = vt.astype(np.int32)
            vrow_src[d, dstp] = buf_idx[m][ordv].astype(np.int32)

    ne = int(sg.ne)
    unique_total = sum(len(u) for u in uniq_pages)
    stats = dict(
        ne=ne, rows=v_rows_real, fill=ne / max(v_rows_real, 1),
        unique_pages=unique_total,
        page_ratio=unique_total * W / max(ne, 1),
        padded_fill=ne / max(P * Rp, 1),
        lane_inflation=P * Rp * W / max(ne, 1),
        mode="pagemajor", g_rows=g_rows_real,
        g_fill=ne / max(g_rows_real, 1),
        padded_g_fill=ne / max(P * P * Mg, 1),
        route_rows=P * P * Mg,
        route_inflation=P * P * Mg * W / max(ne, 1))
    return PagedPlan(
        page_ids=page_ids, slot_lane=gsl, rel_dst=rel_dst, weight=w_send,
        row_tile=row_tile, tile_pos=tile_pos, classes=classes,
        n_tiles=n_tiles, n_slots=n_slots, R=Rtot, Rp=Rp, n_pages=n_pages,
        stats=stats, mode="pagemajor", vrow_src=vrow_src, Rg=P * Mg,
        route=Mg, owner=True)


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


def plan_paged_stats(sg, exchange: str = "gather",
                     pagemajor: bool = False) -> dict:
    """The plan's stats WITHOUT building its arrays (the same binning
    sort, none of the [P, Rp, 128] assembly; lux_tpu/ops/pagegather.py:
    739-850): of the dense plans, or of the owner plans under
    ``exchange="owner"``.  ``pagemajor=True`` adds the page-major counts
    under ``pm_*`` (owner: virtual rows a (dst part, tile) accumulate
    across source parts, gather rows pad to the common ``Mg``)."""
    _check_sg(sg)
    owner = exchange == "owner"
    P = sg.num_parts
    ntp = sg.vpad // W                        # tiles a part
    if owner:
        n_dst_tiles, n_src_rows = P * ntp, ntp
        parts = ((srcl, gt, (gt % ntp) * W + rel, gt // ntp)
                 for srcl, gt, rel, _w in _owner_part_edges(sg))
    else:
        n_dst_tiles, n_src_rows = ntp, P * ntp
        parts = ((src, dst // W, dst, None)
                 for src, dst, _w in (_part_edges(sg, r) for r in range(P)))
    prof = np.zeros(n_dst_tiles, np.int64)
    pm_prof = np.zeros(ntp, np.int64)
    pm_bt_d = np.zeros((P, ntp), np.int64)
    rows_real = unique_total = pm_vrows = pm_grows = pm_max_sd = 0
    for src_idx, dst_tile, dst_local, group in parts:
        by_tile, n_rows, uniq = _part_bin_stats(src_idx, dst_tile,
                                                n_dst_tiles, n_src_rows)
        prof = np.maximum(prof, np.sort(by_tile)[::-1])
        rows_real += n_rows
        unique_total += uniq
        if not pagemajor:
            continue
        if owner:
            if len(src_idx):
                Lm = _pm_layout(src_idx, dst_local, ntp, n_src_rows, group)
                vg = Lm["g_group"][Lm["vrow_gr"]]
                np.add.at(pm_bt_d, (vg, Lm["vrow_tile"]), 1)
                pm_vrows += len(Lm["vb"])
                pm_grows += Lm["Rg"]
                pm_max_sd = max(pm_max_sd, int(np.bincount(
                    Lm["g_group"], minlength=P).max()))
        else:
            bt, nv_rows, ng_rows, _bg = _part_bin_stats_pm(
                src_idx, dst_local, ntp, n_src_rows)
            pm_prof = np.maximum(pm_prof, np.sort(bt)[::-1])
            pm_vrows += nv_rows
            pm_grows += ng_rows
            # the built plan pads every part's gather rows to the max
            pm_max_sd = max(pm_max_sd, ng_rows)
    if pagemajor and owner:
        for d in range(P):
            pm_prof = np.maximum(pm_prof, np.sort(pm_bt_d[d])[::-1])
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
            if ntp else 0
        pm_Rp = _pad8_distinct(pm_Rtot, n_src_rows)
        if owner:
            Mg = max(8, -(-max(pm_max_sd, 1) // 8) * 8)
            pm_Rg_total = P * P * Mg
        else:
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
    reference does (lux_tpu/ops/pagegather.py:981-1023): paged wins
    when its delivered ns an edge undercuts the baseline the same
    engine would otherwise run — the flat gather's rate for a
    ``table_bytes`` state table (the residual path's for ``kdim`` > 1),
    or under ``exchange="owner"`` the owner scan's slot rate times the
    default chunk inflation (``owner_slot_ns * 1.2``); page-major
    (scalar programs, stats with ``pm_*`` keys) when it undercuts both,
    priced with the routing hop under the owner exchange."""
    if gather in GATHER_MODES:
        return gather
    if gather != "auto":
        raise ValueError(f"unknown gather {gather!r} (one of 'paged', "
                         f"'pagemajor', 'flat', 'auto')")
    from lux_tpu_torch import scalemodel as sm
    if stats is None:
        raise ValueError("gather='auto' resolves from the plan's stats "
                         "(plan_paged_stats)")
    paged = sm.page_gather_ns(stats["page_ratio"],
                              stats.get("padded_fill", stats["fill"]), kdim,
                              constants)
    if exchange == "owner":
        baseline = sm.owner_slot_ns(constants) * 1.2
    elif kdim > 1:
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
                                    routed=exchange == "owner",
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


def engine_page_plan(sg, gather: str, program, exchange: str = "gather",
                     plan: PagedPlan | None = None) -> PagedPlan | None:
    """The engines' plan-or-not resolution (lux_tpu/ops/pagegather.py:
    927-978): the paged or page-major plan, owner- or dense-shaped by
    ``exchange``, None for the flat gather.  Dot programs
    (``edge_value_from_dot``) take gather='paged' only.  An explicit
    'paged' / 'pagemajor' raises ValueError, with the reference's
    messages, on configurations the plans do not support; 'auto' stays
    flat there, and elsewhere resolves from the counting pass alone
    (``resolve_gather``), so a flat answer builds no plan arrays.
    ``plan``: one built before on ``sg`` for this explicit ``gather``
    and ``exchange`` (engines on one layout share it), checked against
    them and taken in place of a new one."""
    if gather not in GATHER_MODES + ("auto",):
        resolve_gather(gather)              # the typed ValueError
    owner = exchange == "owner"
    # destination tiles: global on the owner paged plan, else a part's
    tiles = sg.vpad // W * (sg.num_parts if owner and gather == "paged"
                            else 1)
    if plan is not None and (
            plan.mode, plan.owner, plan.page_ids.shape[0], plan.n_tiles) != (
            gather, owner, sg.num_parts, tiles):
        raise ValueError(
            f"page_plan is a {plan.mode!r} plan (owner={plan.owner}, "
            f"{plan.page_ids.shape[0]} parts, {plan.n_tiles} tiles), not "
            f"one for gather={gather!r}, exchange={exchange!r} on this "
            f"layout")
    if gather == "flat":
        return None
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
    if plan is not None:
        return plan
    if gather == "auto":
        kdim = 1
        if dot:
            kdim = max(1, (getattr(program, "state_bytes", None) or 4) // 4)
        stats = plan_paged_stats(sg, exchange=exchange, pagemajor=not dot)
        gather = resolve_gather("auto", stats,
                                state_table_bytes(sg, program), kdim,
                                exchange=exchange)
        if gather == "flat":
            return None
    if gather == "pagemajor":
        return plan_owner_pagemajor(sg) if owner else plan_pagemajor(sg)
    return plan_owner_paged(sg) if owner else plan_paged_gather(sg)


# graph-array keys of a dense paged engine (pg_w when weighted, pg_vrs
# for page-major plans, PAGED_DOT_KEYS for dot programs)
PAGED_KEYS = ("pg_ids", "pg_sl", "pg_rel", "pg_tp")
PAGED_DOT_KEYS = ("pg_rt", "pg_t0")
# the owner paged plan's keys (own_pg_w when weighted; leading dim the
# source parts) and the owner page-major plan's: the sender keys lead
# with source parts (own_pm_w when weighted), the receiver keys with
# destination parts (lux_tpu/ops/pagegather.py:1218-1228)
PAGED_OWNER_KEYS = ("own_pg_ids", "own_pg_sl", "own_pg_rel", "own_pg_tp")
PAGEMAJOR_OWNER_SEND_KEYS = ("own_pm_ids", "own_pm_gsl")
PAGEMAJOR_OWNER_RECV_KEYS = ("own_pm_vrs", "own_pm_rel", "own_pm_tp")


def plan_graph_arrays(pp: PagedPlan, dot: bool = False,
                      vpad: int | None = None) -> dict:
    """The plan's per-part host arrays for an engine's array dict
    (leading dim num_parts), under the reference's key names
    (lux_tpu/ops/pagegather.py:1231-1261): ``pg_*`` for a dense plan,
    ``own_pg_*`` for the owner paged plan, ``own_pm_*`` for the owner
    page-major plan; ``dot`` adds each row's destination tile and each
    part's tile 0 (``vpad`` needed), which the SDDMM delivery fetches."""
    if pp.owner and pp.mode == "pagemajor":
        arrays = {"own_pm_ids": pp.page_ids, "own_pm_gsl": pp.slot_lane,
                  "own_pm_vrs": pp.vrow_src, "own_pm_rel": pp.rel_dst,
                  "own_pm_tp": pp.tile_pos}
        if pp.weight is not None:
            arrays["own_pm_w"] = pp.weight
        return arrays
    pre = "own_pg_" if pp.owner else "pg_"
    arrays = {pre + "ids": pp.page_ids, pre + "sl": pp.slot_lane,
              pre + "rel": pp.rel_dst, pre + "tp": pp.tile_pos}
    if pp.weight is not None:
        arrays[pre + "w"] = pp.weight
    if pp.owner:
        return arrays
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


def fetch_pages(flat_state: torch.Tensor, page_ids: torch.Tensor,
                shard: bool = False) -> torch.Tensor:
    """The unique-page row fetch, the state-table access of a paged
    iteration -> [P*n_pages, 128, ...].  ``flat_state`` [P*vpad, ...];
    ``page_ids`` [P, n_pages] index the whole table's 128-wide pages, or
    with ``shard`` (the owner plans) each part's own [vpad] shard's: one
    ``index_select`` a source part on its [vpad / 128, 128, ...] shard,
    as the reference's scan gathers a shard a step."""
    P, n_pages = page_ids.shape
    trail = tuple(flat_state.shape[1:])
    if not shard:
        return torch.index_select(flat_state.reshape((-1, W) + trail), 0,
                                  page_ids.reshape(-1).to(torch.int64))
    shards = flat_state.reshape((P, -1, W) + trail)
    out = flat_state.new_empty((P, n_pages, W) + trail)
    for s in range(P):
        torch.index_select(shards[s], 0, page_ids[s].to(torch.int64),
                           out=out[s])
    return out.view((P * n_pages, W) + trail)


def paged_values(flat_state: torch.Tensor, page_ids: torch.Tensor,
                 slot_lane: torch.Tensor, shard: bool = False
                 ) -> torch.Tensor:
    """The two-level gather for every part: unique-page row fetch
    (``fetch_pages``), buffer row fetch, lane resolve (kernel B2 for
    scalar rows).  ``flat_state`` [P*vpad, ...], ``page_ids`` [P,
    n_pages], ``slot_lane`` int32 [P, Rg, 128] -> delivered values
    [P*Rg, 128, ...]."""
    P, n_pages = page_ids.shape
    pages = fetch_pages(flat_state, page_ids, shard)
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
                  upto: str | None = None, shard: bool = False):
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
    stage it names.  ``shard``: the owner paged plan's pages, each in
    its source part's own shard (``fetch_pages``)."""
    if upto is not None and flat_state.dim() == 1:
        raise ValueError("upto= stops the vector-state path only")
    if flat_state.dim() > 1:
        return _paged_partial_rows(pp, flat_state, page_ids, slot_lane,
                                   rel, weight, tile_pos, kind, msg_fn,
                                   vrow_src, upto, shard)
    P = page_ids.shape[0]
    vals = paged_values(flat_state, page_ids, slot_lane, shard)
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
                        tile_pos, kind, msg_fn, vrow_src, upto=None,
                        shard=False):
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
    pages = fetch_pages(flat_state, page_ids, shard)
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


def paged_owner_contribs(pp, state, a: dict, kind: str, msg_fn,
                         num_parts: int):
    """The owner paged delivery (lux_tpu/ops/pagegather.py:1264): every
    source part's page-binned rows run against its own [vpad] shard
    (``paged_partial`` with ``shard``: kernel B2 once over every part's
    [Rp, 128] rows, kernel B1 once over all of them, the class combine)
    and give [P_src, G, 128, ...] tile partials, which fold across
    source parts in order 0..P-1 (ops/owner.fold_parts, the reference's
    scan order) -> [P_dst, n_tiles * 128, ...].  ``state`` [P, vpad,
    ...]; ``a`` the engine's ``own_pg_*`` arrays."""
    from lux_tpu_torch.ops.owner import fold_parts
    P = state.shape[0]
    trail = tuple(state.shape[2:])
    tiles = paged_partial(pp, state.reshape((-1,) + trail), a["own_pg_ids"],
                          a["own_pg_sl"], a["own_pg_rel"], a.get("own_pg_w"),
                          a["own_pg_tp"], kind, msg_fn, shard=True)
    return fold_parts(tiles.view((P, pp.n_tiles, W) + trail), num_parts,
                      kind)


def pagemajor_owner_sends(state, a: dict, msg_fn, route: int):
    """The sender side of the owner page-major delivery: each source
    part's full-fill gather rows against its own shard (page fetch,
    kernel B2 over every part's [P*Mg, 128] rows at once) and their
    messages, weights applied here -> [P_src, P_dst, Mg, 128, ...]."""
    P = state.shape[0]
    trail = tuple(state.shape[2:])
    vals = paged_values(state.reshape((-1,) + trail), a["own_pm_ids"],
                        a["own_pm_gsl"], shard=True)
    msgs = msg_fn(vals.view((P, P * route, W) + trail), a.get("own_pm_w"))
    return msgs.view((P, P, route, W) + trail)


def pagemajor_route(msgs: torch.Tensor, axis=None) -> torch.Tensor:
    """The route of the owner page-major rows: [P_src, P_dst, Mg, 128,
    ...] -> each destination part's received buffer [P_dst * P_src * Mg,
    128, ...].  On one device a transpose (the reference's ``swapaxes``,
    lux_tpu/ops/pagegather.py:1341); an exchange axis (the route across
    a mesh's ranks) is ROADMAP A6b-2."""
    if axis is not None:
        from lux_tpu_torch.engine.pull import refuse_on_mesh
        refuse_on_mesh("the page-major owner route (all_to_all)")
    P = msgs.shape[0]
    return msgs.transpose(0, 1).contiguous().view(
        (P * P * msgs.shape[2],) + tuple(msgs.shape[3:]))


def pagemajor_owner_reduce(pp, recv: torch.Tensor, a: dict, kind: str):
    """The receiver side: every destination part's virtual rows take
    their values from its routed buffer (``own_pm_vrs`` + the part's
    base: one row-granular ``index_select``), kernel B1 (or its batched
    form over a query axis) once over every part's [Rp, 128] rows, then
    the class combine -> [P, n_tiles * 128, ...]."""
    P = a["own_pm_vrs"].shape[0]
    trail = tuple(recv.shape[2:])
    nbuf = recv.shape[0] // P
    base = torch.arange(P, device=recv.device)[:, None] * nbuf
    vals = torch.index_select(
        recv, 0, (a["own_pm_vrs"].to(torch.int64) + base).reshape(-1))
    rel = a["own_pm_rel"].reshape(-1, W)
    if trail:
        width = int(np.prod(trail))
        partials = chunk_partials_batched(
            vals.reshape(-1, W, width).contiguous(), rel, W, kind)
    else:
        partials = chunk_partials(vals, rel, W, kind)
    red = class_combine(pp, partials.view((P, pp.Rp, W) + trail)[:, :pp.R],
                        a["own_pm_tp"], kind)
    return red.reshape((P, pp.n_tiles * W) + trail)


def pagemajor_owner_deliver(pp, state, a: dict, kind: str, msg_fn,
                            axis=None):
    """The owner PAGE-MAJOR delivery, route included
    (lux_tpu/ops/pagegather.py:1301): the senders' complete message
    rows (``pagemajor_owner_sends``), routed whole to their destination
    parts (``pagemajor_route``), reduced receiver-side
    (``pagemajor_owner_reduce``) -> [P, n_tiles * 128, ...], already
    routed: no further exchange.  Launches an iteration: B2 once, B1
    once."""
    recv = pagemajor_route(pagemajor_owner_sends(state, a, msg_fn,
                                                 pp.route), axis)
    return pagemajor_owner_reduce(pp, recv, a, kind)


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
    rel (page-major plans through each virtual row's gather row).  The
    owner page-major plan's vrow_src indexes the routed buffer: it
    decodes by ``decode_pagemajor_owner``."""
    if pp.mode == "pagemajor" and pp.route:
        raise ValueError("owner page-major plans decode via "
                         "decode_pagemajor_owner (vrow_src indexes "
                         "the routed buffer, not this part's rows)")
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


def decode_pagemajor_owner(pp: PagedPlan, d: int):
    """Decode DESTINATION part ``d``'s live lanes of an owner page-major
    plan back to (src part, src local index, local dst index)
    (lux_tpu/ops/pagegather.py:1397): vrow_src indexes the routed
    [P_src * Mg] buffer, so the sender and its row recover as
    divmod(vrow_src, Mg)."""
    if not (pp.mode == "pagemajor" and pp.route):
        raise ValueError("not an owner page-major plan")
    Mg = pp.route
    rel = pp.rel_dst[d]
    rows, cols = np.nonzero(rel != -1)
    buf = pp.vrow_src[d][rows].astype(np.int64)
    s = buf // Mg                       # source part
    send_row = d * Mg + buf % Mg        # its slot in s's send layout
    sl = pp.slot_lane[s, send_row]      # [n, 128]
    slot = (sl[:, 0] >> np.uint32(7)).astype(np.int64)
    lane = (sl[np.arange(len(rows)), cols] & np.uint32(0x7F)).astype(
        np.int64)
    src_local = pp.page_ids[s, slot].astype(np.int64) * W + lane
    dst_local = pp.row_tile[d][rows].astype(np.int64) * W \
        + rel[rows, cols].astype(np.int64)
    return s, src_local, dst_local


def paged_reduce_numpy(pp: PagedPlan, p: int, state_flat: np.ndarray,
                       kind: str = "sum", msg=None) -> np.ndarray:
    """float64 oracle for one part of a plan -> [n_tiles * 128]
    partial (identity where no row delivers).  msg(vals [Rp, 128],
    weight) maps delivered values to messages.  The owner page-major
    plan has none (its vrow_src indexes the routed buffer)."""
    if pp.mode == "pagemajor" and pp.route:
        raise ValueError("owner page-major plans have no single-part "
                         "reduce oracle (vrow_src indexes the routed "
                         "buffer); compare whole engines instead")
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
