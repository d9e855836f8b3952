"""Pair-lane delivery and the row-class machinery it shares with the
paged gather (counterpart of lux_tpu/ops/pairs.py:40-1100).

Edges of a dense (src tile, dst tile) pair — both tiles 128 vertices,
a pair with at least ``threshold`` edges — are served by fetching the
pair's 128-wide source state row once per delivery row: lane c is the
source offset within the src tile, so the value needs no selection,
and kernel B1 routes it to its destination offset ``rel_dst`` (int8,
-1 = dead lane).  A pair whose source lane repeats gets one row per
occurrence.  The residual edges keep the tiled gather path.

Rows are grouped per destination tile in depth classes: ``classes =
[(count, depth), ...]`` holds ``count`` slots of ``depth`` consecutive
rows each, deepest first, the same for every part (laid out against
the elementwise-max profile).  A tile's rows reduce with one static
reshape-reduce per class; ``tile_pos`` then maps each tile to its slot
(tiles without rows point at a trailing identity slot).

Host planning is numpy.  Every sort is a stable numpy sort — the same
permutation as the reference's stable radix ``native.sort_kv`` — so
the plans are array-equal to the reference's.  Device side
(``pair_partial``), every part at once:

1. ``vals = index_select(state2d, rowbind)``   [P*Rp, 128] rows
2. ``partials = chunk_partials(msgs, rel)``    kernel B1, E = 128
3. ``class_combine`` -> [P, n_tiles * 128]

``pair_partial_streamed`` runs the same per class in blocks of whole
slots, one B1 launch per block.

Vector-state dot programs (colfilter, ``edge_value_from_dot``) take the
SDDMM forms instead, which launch no hand kernel: ``pair_partial_dot``
fetches each row's [128, K] source tile and its destination tile and
runs ops/dot.dot_partials in blocks of rows; ``pair_partial_dot_streamed``
runs it per class in blocks of whole slots and folds each block's depth
rows at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch.ops.chunk_reduce import chunk_partials
from lux_tpu_torch.ops.dot import (DOT_BLOCK_BYTES, STREAM_MSG_BYTES,
                                   DotBlock, blocks, run_blocks)
from lux_tpu_torch.ops.segment import identity_for

W = 128

# occurrences of one (pair, source lane) group past this many ride the
# residual path (the reference's max_occ default)
MAX_OCC = 128
# the reference's relative per-edge costs (ns) of a pair-served and a
# gather-served edge, which its partitioners balance; the port keeps
# them so that its cuts equal the reference's
PAIR_COST = 2.5
GATHER_COST = 9.0
# stacked plans pad their rows to a multiple of this (the reference's
# kernel grid granularity), so Rp equals the reference's
ROW_BLOCK = 64


# ---------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------


@dataclasses.dataclass
class PairPlan:
    """Per-part pair-lane arrays (host numpy).

    rowbind    int32 [R]       global state2d row (= src tile) per row
    rel_dst    int8 [R, 128]   dst offset in [0, 128), -1 = dead lane
    weight     f32 [R, 128] | None  per-lane edge weight (0 dead lanes)
    classes    [(tile_start, tile_count, depth)]; rows are tile-major
               in ``tile_order`` with per-tile depth padded to the
               class depth (dead rows are all -1)
    tile_order int32 [n_tiles] part-local dst tile of each class slot
    residual   bool [ne_part]  True for edges NOT covered by pairs
    row_tile   int32 [R]       part-local dst tile of each row
    """

    rowbind: np.ndarray
    rel_dst: np.ndarray
    weight: np.ndarray | None
    classes: list
    tile_order: np.ndarray
    residual: np.ndarray
    n_tiles: int
    stats: dict
    row_tile: np.ndarray


def occurrence_index(pair: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """Per-element occurrence counter within each (pair, slot) group:
    the o-th edge of a (pair id, source slot) group, in edge order,
    gets o.  One stable lexicographic sort (slot minor, pair major) —
    never a packed ``pair * 2^32 + slot`` key, which wraps at large
    scale and would alias distinct groups."""
    kp = np.asarray(pair, np.int64)
    ks = np.asarray(slot, np.int64)
    n = len(ks)
    idx = np.lexsort((ks, kp))
    kp, ks = kp[idx], ks[idx]
    newg = np.ones(n, bool)
    newg[1:] = (kp[1:] != kp[:-1]) | (ks[1:] != ks[:-1])
    pos = np.arange(n)
    gst = np.maximum.accumulate(np.where(newg, pos, 0))
    occ = np.empty(n, np.int64)
    occ[idx] = pos - gst
    return occ


def fill_histogram(pidx: np.ndarray, occ: np.ndarray):
    """Per-(pair, occurrence level) fill counts, sorted by (pair, occ):
    returns (gp, go, fill) — pair id, occurrence level and the number
    of edges at that level (= the live-lane count of that pair row)."""
    key = np.sort((np.asarray(pidx, np.int64) << np.int64(32))
                  | np.asarray(occ, np.int64))
    newg = np.ones(len(key), bool)
    newg[1:] = key[1:] != key[:-1]
    gidx = np.nonzero(newg)[0]
    fill = np.diff(np.concatenate((gidx, [len(key)])))
    gp = (key[gidx] >> np.int64(32)).astype(np.int64)
    go = (key[gidx] & np.int64(0xFFFFFFFF)).astype(np.int64)
    return gp, go, fill


def quantize_depths(depth_sorted: np.ndarray,
                    levels_growth: float = 1.35) -> np.ndarray:
    """Round a descending per-slot row-count profile up to the fixed
    depth ladder (0..8 then *levels_growth), bounding the number of
    distinct classes to O(log max_depth)."""
    levels = [0, 1, 2, 3, 4, 5, 6, 7, 8]
    v = 8
    while v < int(np.max(depth_sorted, initial=0)):
        v = int(v * levels_growth) + 1
        levels.append(v)
    lev = np.asarray(levels, np.int64)
    return lev[np.searchsorted(lev, depth_sorted)]


@dataclasses.dataclass
class PairAnalysis:
    """The threshold-dependent, layout-independent half of pair
    planning: everything through the sorted per-tile depth profile.
    plan_sharded_pairs computes it once per part and reuses it for the
    profile pass and the final layout."""

    ne: int
    n_tiles: int
    residual: np.ndarray       # bool [ne]
    cov: np.ndarray            # int32 [n_cov] covered edge idx
    occ: np.ndarray            # int32 [n_cov] occurrence in (pair, slot)
    pidx: np.ndarray           # int32 [n_cov] dense selected-pair id
    nrows_pair: np.ndarray     # int64 [n_sel]
    pair_dt: np.ndarray        # int64 [n_sel] dst tile of each pair
    tile_sort: np.ndarray      # int64 [n_sel]
    t_order: np.ndarray        # int64 [n_tiles]
    depth_sorted: np.ndarray   # int64 [n_tiles] descending


def resolve_min_fill(min_fill) -> int | None:
    """Integers and None pass through unchanged.  The reference's
    ``"auto"`` resolves through scalemodel's break-even fill, whose
    per-row and per-edge costs were measured on the TPU: refused until
    the port measures its own (ROADMAP A10)."""
    if min_fill == "auto":
        from lux_tpu_torch.engine.pull import NotPortedError
        raise NotPortedError(
            "min_fill='auto' is not ported yet (ROADMAP A10): it "
            "resolves through a cost model measured on the TPU; pass "
            "an int (bench.py's pagerank config uses 24, its colfilter "
            "config 22, what the reference resolves 'auto' to at K = "
            "20) or None")
    if min_fill is not None and not isinstance(min_fill, (int,
                                                          np.integer)):
        raise ValueError(f"min_fill must be an int, None or 'auto', "
                         f"got {min_fill!r}")
    return min_fill


def analyze_pairs(src_slot: np.ndarray, dst_local: np.ndarray,
                  vpad: int, threshold: int = 8,
                  min_fill: int | str | None = None) -> PairAnalysis:
    """The sorting and selection half of build_pair_plan.

    A pair with >= ``threshold`` edges is covered; each covered edge
    gets its occurrence within (pair, source slot); occurrences >=
    ``MAX_OCC`` ride the residual.  ``min_fill``: drop pair rows that
    would deliver fewer than ``min_fill`` live lanes.  Row fill falls
    with occurrence depth within a pair, so the dropped rows are each
    pair's occurrence tail — a per-pair cap from one (pidx, occ)
    histogram."""
    min_fill = resolve_min_fill(min_fill)
    if vpad % W:
        raise ValueError(f"pair planning needs vpad % {W} == 0, got "
                         f"vpad={vpad}")
    ne = len(dst_local)
    n_tiles = vpad // W
    src_slot = np.asarray(src_slot, np.int64)
    dst_local = np.asarray(dst_local, np.int64)

    pair = (src_slot // W) * n_tiles + dst_local // W
    order = np.argsort(pair, kind="stable")
    pp = pair[order]
    # a part with zero edges has zero pairs (starts must then be [0])
    starts = (np.concatenate(
        ([0], np.nonzero(pp[1:] != pp[:-1])[0] + 1, [ne]))
        if ne else np.zeros(1, np.int64))
    sizes = np.diff(starts)
    pair_id = np.repeat(np.arange(len(sizes)), sizes)

    sel_pair = sizes >= threshold
    esel_sorted = sel_pair[pair_id]               # in pair-sorted order
    residual = np.ones(ne, bool)
    residual[order[esel_sorted]] = False

    cov = order[esel_sorted]                      # original edge idx
    occ = occurrence_index(pair[cov], src_slot[cov])

    keep = occ < MAX_OCC
    if not keep.all():
        residual[cov[~keep]] = True
        cov = cov[keep]
        occ = occurrence_index(pair[cov], src_slot[cov])

    pid_cov = np.searchsorted(pp[starts[:-1]], pair[cov])
    sel_ids = np.nonzero(sel_pair)[0]
    remap = np.full(len(sizes), -1, np.int64)
    remap[sel_ids] = np.arange(len(sel_ids))
    pidx = remap[pid_cov]                         # [n_cov] dense pair id

    if min_fill is not None and min_fill > 1 and len(cov):
        gp, go, fill = fill_histogram(pidx, occ)
        # rows kept per pair: the leading run of occurrence levels
        # with fill >= min_fill (levels are contiguous from 0)
        ok = fill >= min_fill
        run = np.zeros(len(sel_ids), np.int64)
        firstbad = np.full(len(sel_ids), np.iinfo(np.int64).max)
        np.minimum.at(firstbad, gp[~ok], go[~ok])
        np.maximum.at(run, gp[ok],
                      np.minimum(go[ok] + 1, firstbad[gp[ok]]))
        keep2 = occ < run[pidx]
        if not keep2.all():
            residual[cov[~keep2]] = True
            cov = cov[keep2]
            pidx = pidx[keep2]
            occ = occ[keep2]    # no holes: kept occ stay < cap

    nrows_pair = np.zeros(len(sel_ids), np.int64)
    if len(cov):
        np.maximum.at(nrows_pair, pidx, occ + 1)

    # pairs ordered by dst tile (the per-tile combine), then src tile
    pair_dt = pp[starts[:-1]][sel_pair] % n_tiles
    tile_sort = np.argsort(pair_dt, kind="stable")
    rows_by_tile = np.zeros(n_tiles, np.int64)
    np.add.at(rows_by_tile, pair_dt, nrows_pair)
    t_order = np.argsort(-rows_by_tile, kind="stable")
    return PairAnalysis(
        ne=ne, n_tiles=n_tiles, residual=residual,
        cov=cov.astype(np.int32), occ=occ.astype(np.int32),
        pidx=pidx.astype(np.int32), nrows_pair=nrows_pair,
        pair_dt=pair_dt, tile_sort=tile_sort, t_order=t_order,
        depth_sorted=rows_by_tile[t_order])


def build_pair_plan(src_slot: np.ndarray, dst_local: np.ndarray,
                    vpad: int, threshold: int = 8,
                    weights: np.ndarray | None = None,
                    slot_depths: np.ndarray | None = None,
                    analysis: PairAnalysis | None = None,
                    min_fill: int | str | None = None) -> PairPlan:
    """One part's plan.  src_slot: int [ne] global padded state slots
    (state2d row = slot // 128); dst_local: int [ne] part-local dst in
    [0, vpad); weights (optional, [ne]) are laid out per lane.

    slot_depths (optional, [n_tiles] descending, ladder-quantized):
    lay rows out against this external per-slot depth profile, so
    every part of a multi-part graph gets identical classes.
    analysis: a precomputed analyze_pairs result for these arrays."""
    if analysis is None:
        analysis = analyze_pairs(src_slot, dst_local, vpad,
                                 threshold=threshold, min_fill=min_fill)
    a = analysis
    ne, n_tiles = a.ne, a.n_tiles
    src_slot = np.asarray(src_slot, np.int64)
    dst_local = np.asarray(dst_local, np.int64)
    residual, cov, occ, pidx = a.residual, a.cov, a.occ, a.pidx
    nrows_pair, pair_dt = a.nrows_pair, a.pair_dt
    tile_sort, t_order = a.tile_sort, a.t_order

    if slot_depths is None:
        depth = quantize_depths(a.depth_sorted)
    else:
        depth = np.asarray(slot_depths, np.int64)
        if depth.shape != (n_tiles,) or (depth < a.depth_sorted).any():
            raise ValueError("slot_depths must cover this part's own "
                             "sorted per-tile row counts")

    row_off_tile = np.concatenate(([0], np.cumsum(depth)))
    R = int(row_off_tile[-1])

    # rows of each pair: its tile's offset + the exclusive running row
    # count within the tile (pairs in tile_sort order are contiguous
    # per destination tile)
    tile_pos = np.empty(n_tiles, np.int64)        # tile -> class slot
    tile_pos[t_order] = np.arange(n_tiles)
    srt_rows = nrows_pair[tile_sort]
    cum = np.cumsum(srt_rows) - srt_rows
    dts = pair_dt[tile_sort]
    newt = np.ones(len(dts), bool)
    newt[1:] = dts[1:] != dts[:-1]
    grp_base = np.maximum.accumulate(np.where(newt, cum, 0))
    within = cum - grp_base
    pair_base = np.zeros(len(nrows_pair), np.int64)
    pair_base[tile_sort] = row_off_tile[tile_pos[dts]] + within
    if not (within + srt_rows <= depth[tile_pos[dts]]).all():
        raise AssertionError("a tile's pair rows overflow its class "
                             "depth")

    rowbind = np.zeros(R, np.int32)
    rel_dst = np.full((R, W), -1, np.int8)
    rows = pair_base[pidx] + occ
    rowbind[rows] = (src_slot[cov] // W).astype(np.int32)
    rel_dst[rows, src_slot[cov] % W] = (dst_local[cov] % W).astype(np.int8)
    # every covered edge must own a distinct (row, lane): a colliding
    # write would drop an edge silently
    delivered = int(np.count_nonzero(rel_dst != -1))
    if delivered != len(cov):
        raise AssertionError(
            f"pair plan dropped {len(cov) - delivered} of {len(cov)} "
            f"covered edges (colliding (row, lane) writes)")
    weight = None
    if weights is not None:
        weight = np.zeros((R, W), np.float32)
        weight[rows, src_slot[cov] % W] = np.asarray(
            weights, np.float32)[cov]

    classes = []
    t0 = 0
    for L in np.unique(depth)[::-1]:
        cnt = int((depth == L).sum())
        if L > 0:
            classes.append((t0, cnt, int(L)))
        t0 += cnt

    ncov = int((~residual).sum())
    return PairPlan(rowbind=rowbind, rel_dst=rel_dst, weight=weight,
                    classes=classes, tile_order=t_order.astype(np.int32),
                    residual=residual, n_tiles=n_tiles,
                    stats=dict(ne=ne, covered=ncov, R=R,
                               coverage=ncov / max(ne, 1),
                               inflation=R * W / max(ncov, 1),
                               depth_profile=a.depth_sorted),
                    row_tile=np.repeat(t_order.astype(np.int32), depth))


_NP_REDUCE = {"sum": (0.0, np.add), "min": (np.inf, np.minimum),
              "max": (-np.inf, np.maximum)}


def _reduce_rows_numpy(vals, rel_dst, row_tile, n_tiles: int, kind: str):
    """float64 [n_tiles * 128]: every live lane's value folded into its
    destination row_tile * 128 + rel, rows then lanes in order."""
    ident, op = _NP_REDUCE[kind]
    out = np.full(n_tiles * W, ident)
    rel = np.asarray(rel_dst, np.int64)
    rows, cols = np.nonzero((rel >= 0) & (rel < W))
    dst = np.asarray(row_tile, np.int64)[rows] * W + rel[rows, cols]
    op.at(out, dst, vals[rows, cols])
    return out


def pair_reduce_numpy(plan: PairPlan, state_flat: np.ndarray,
                      kind: str = "sum") -> np.ndarray:
    """Oracle of one part's plan on the host: [vpad] partial
    reduction, identity where pairs contribute nothing."""
    vals = np.asarray(state_flat).reshape(-1, W)[plan.rowbind]
    return _reduce_rows_numpy(vals, plan.rel_dst, plan.row_tile,
                              plan.n_tiles, kind)


@dataclasses.dataclass
class StackedPairPlan:
    """Common-frame pair-lane arrays for all parts (host numpy).

    rowbind   int32 [P, Rp]       global state2d row per delivery row
    rel_dst   int8 [P, Rp, 128]   dst offset in [0, 128), -1 = dead
    weight    f32 [P, Rp, 128] | None  per-lane edge weight
    tile_pos  int32 [P, n_tiles]  class slot of each part-local tile;
              tiles with no pair rows point at ``n_slots``
    classes   [(count, depth)] shared by every part, depth descending;
              a part with fewer tiles at some depth owns dead rows
              there, never referenced by its tile_pos
    row_tile  int32 [P, Rp]       dst tile of each row (dead rows -> 0)
    """

    rowbind: np.ndarray
    rel_dst: np.ndarray
    weight: np.ndarray | None
    tile_pos: np.ndarray
    classes: list
    n_tiles: int
    n_slots: int
    R: int
    Rp: int
    stats: dict
    row_tile: np.ndarray

    @property
    def geometry(self) -> "PairGeometry":
        return PairGeometry(classes=tuple(tuple(c) for c in self.classes),
                            R=self.R, Rp=self.Rp, n_tiles=self.n_tiles,
                            n_slots=self.n_slots)


@dataclasses.dataclass(frozen=True)
class PairGeometry:
    """The scalars of a StackedPairPlan — all the device side needs
    once the plan's arrays are on the device."""

    classes: tuple
    R: int
    Rp: int
    n_tiles: int
    n_slots: int


def stack_pair_plans(plans: list, weighted: bool) -> StackedPairPlan:
    """Pad per-part plans to a common class structure and stack.  The
    depth ladder is a prefix of one fixed sequence, so per-part class
    depths are subsets of a common descending list; the common count
    per depth is the max over parts.  Rows are padded to a multiple of
    ``ROW_BLOCK``."""
    P = len(plans)
    n_tiles = plans[0].n_tiles
    depths = sorted({L for pl in plans for (_t0, _c, L) in pl.classes},
                    reverse=True)
    cnt_by_depth = {
        L: max((c for pl in plans for (_t0, c, Ld) in pl.classes
                if Ld == L), default=0)
        for L in depths}
    classes = [(cnt_by_depth[L], L) for L in depths]
    n_slots = sum(c for c, _L in classes)
    R = sum(c * L for c, L in classes)
    Rp = -(-max(R, ROW_BLOCK) // ROW_BLOCK) * ROW_BLOCK

    slot_base, row_base = {}, {}
    s = r = 0
    for c, L in classes:
        slot_base[L], row_base[L] = s, r
        s += c
        r += c * L

    rowbind = np.zeros((P, Rp), np.int32)
    rel_dst = np.full((P, Rp, W), -1, np.int8)
    wgt = np.zeros((P, Rp, W), np.float32) if weighted else None
    tile_pos = np.full((P, n_tiles), n_slots, np.int32)
    row_tile = np.zeros((P, Rp), np.int32)
    for p, pl in enumerate(plans):
        prow = 0
        for (t0, c, L) in pl.classes:
            rb, sb = row_base[L], slot_base[L]
            rowbind[p, rb:rb + c * L] = pl.rowbind[prow:prow + c * L]
            rel_dst[p, rb:rb + c * L] = pl.rel_dst[prow:prow + c * L]
            if weighted:
                wgt[p, rb:rb + c * L] = pl.weight[prow:prow + c * L]
            row_tile[p, rb:rb + c * L] = pl.row_tile[prow:prow + c * L]
            tiles = pl.tile_order[t0:t0 + c]
            tile_pos[p, tiles] = sb + np.arange(c, dtype=np.int32)
            prow += c * L

    ne = sum(pl.stats["ne"] for pl in plans)
    cov = sum(pl.stats["covered"] for pl in plans)
    return StackedPairPlan(
        rowbind=rowbind, rel_dst=rel_dst, weight=wgt, tile_pos=tile_pos,
        classes=classes, n_tiles=n_tiles, n_slots=n_slots, R=R, Rp=Rp,
        stats=dict(ne=ne, covered=cov, coverage=cov / max(ne, 1),
                   inflation=P * Rp * W / max(cov, 1)),
        row_tile=row_tile)


def cost_balanced_starts(g, num_parts: int, threshold: int) -> np.ndarray:
    """Partition cut points balancing the estimated per-part iteration
    cost under pair-lane delivery instead of raw edge counts: an edge
    in a dense global (src tile, dst tile) pair costs ``PAIR_COST``,
    any other ``GATHER_COST`` (the port has not measured its own).
    Cuts are 128-aligned, so part-local tile structure equals the
    global tiling."""
    from lux_tpu_torch.partition import weighted_balanced_bounds

    src, dst = g.edge_arrays()
    n_st = (g.nv + W - 1) // W
    key = (src // W) * np.int64(n_st) + dst // W
    _uniq, inv, cnt = np.unique(key, return_inverse=True,
                                return_counts=True)
    edge_cost = np.where(cnt[inv] >= threshold, PAIR_COST, GATHER_COST)
    ccum = np.concatenate(([0.0], np.cumsum(edge_cost)))
    cost_ptrs = ccum[np.asarray(g.row_ptrs, np.int64)]  # END offsets
    return weighted_balanced_bounds(cost_ptrs, num_parts, align=W)


def plan_sharded_pairs(sg, threshold: int,
                       min_fill: int | str | None = None):
    """Per-part pair plans for a ShardedGraph and the RESIDUAL
    ShardedGraph (uncovered edges, re-padded) the tiled gather path
    runs on.  Returns (StackedPairPlan | None, residual_sg); None when
    no pair anywhere meets the threshold (the residual is ``sg``
    itself).  Requires vpad % 128 == 0.

    With several parts, every part is analysed once, then laid out
    against the elementwise-max depth profile so classes are identical
    across parts.  Multi-host local-parts builds are not ported."""
    if getattr(sg, "local_parts", None) is not None:
        from lux_tpu_torch.engine.pull import NotPortedError
        raise NotPortedError(
            "pair planning of a local-parts (multi-host) build is not "
            "ported yet (ROADMAP A6): it agrees on the depth profile "
            "across processes")
    min_fill = resolve_min_fill(min_fill)
    if sg.vpad % W:
        raise ValueError("pair delivery needs vpad % 128 == 0; build "
                         "the ShardedGraph with vpad_align=128")
    P = sg.num_parts

    def plan_part(p, slot_depths=None, analysis=None):
        nep = int(sg.ne_part[p])
        wp = (np.asarray(sg.edge_weight[p, :nep])
              if sg.weighted else None)
        return build_pair_plan(
            sg.src_slot[p, :nep], sg.dst_local[p, :nep], sg.vpad,
            threshold=threshold, weights=wp, slot_depths=slot_depths,
            analysis=analysis, min_fill=min_fill)

    if P > 1:
        analyses = []
        for p in range(P):
            nep = int(sg.ne_part[p])
            analyses.append(analyze_pairs(
                sg.src_slot[p, :nep], sg.dst_local[p, :nep], sg.vpad,
                threshold=threshold, min_fill=min_fill))
        prof_max = np.maximum.reduce([a.depth_sorted for a in analyses])
        if sum(int(a.depth_sorted.sum()) for a in analyses) == 0:
            return None, sg             # no pair anywhere dense enough
        common = quantize_depths(prof_max)
        plans = []
        for p in range(P):
            plans.append(plan_part(p, slot_depths=common,
                                   analysis=analyses[p]))
            analyses[p] = None          # release the per-part arrays
    else:
        plans = [plan_part(0)]
        if plans[0].stats["covered"] == 0:
            return None, sg

    sp = stack_pair_plans(plans, sg.weighted)

    ne_r = np.asarray([int(pl.residual.sum()) for pl in plans], np.int64)
    epad_r = max(128, -(-int(ne_r.max(initial=0)) // 128) * 128)
    src_slot = np.zeros((P, epad_r), np.int32)
    dst_local = np.full((P, epad_r), sg.vpad, np.int32)
    ew = np.zeros((P, epad_r), np.float32) if sg.weighted else None
    row_ptr_local = np.zeros((P, sg.vpad + 1), np.int32)
    for p, pl in enumerate(plans):
        nep = int(sg.ne_part[p])
        res = pl.residual
        nr = int(ne_r[p])
        src_slot[p, :nr] = sg.src_slot[p, :nep][res]
        r_dst = sg.dst_local[p, :nep][res]
        dst_local[p, :nr] = r_dst
        if ew is not None:
            ew[p, :nr] = sg.edge_weight[p, :nep][res]
        counts = np.bincount(r_dst, minlength=sg.vpad)
        row_ptr_local[p, 1:] = np.cumsum(counts).astype(np.int32)
    residual = dataclasses.replace(
        sg, src_slot=src_slot, dst_local=dst_local, edge_weight=ew,
        row_ptr_local=row_ptr_local, ne_part=ne_r, epad=epad_r)
    return sp, residual


def stacked_pair_reduce_numpy(sp: StackedPairPlan, p: int,
                              state_flat: np.ndarray, kind: str = "sum",
                              msg=None) -> np.ndarray:
    """float64 oracle for one part of a stacked plan -> [n_tiles *
    128].  msg(vals, weight) maps delivered values (+ per-lane
    weights) to messages; the default uses the values unchanged."""
    vals = np.asarray(state_flat).reshape(-1, W)[sp.rowbind[p]].astype(
        np.float64)
    if msg is not None:
        vals = msg(vals, sp.weight[p] if sp.weight is not None else None)
    return _reduce_rows_numpy(vals, sp.rel_dst[p], sp.row_tile[p],
                              sp.n_tiles, kind)


# ---------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------


# NaN-propagating reductions over one axis (like jnp.sum/min/max)
_REDUCE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}


def _reduce_depth(blk: torch.Tensor, kind: str) -> torch.Tensor:
    """Reduce [P, S, L, ...] slot rows over the depth axis L."""
    if kind == "sum":
        return blk.sum(dim=2, dtype=blk.dtype)
    return _REDUCE[kind](blk, dim=2)


def class_combine(plan, partials: torch.Tensor, tile_pos: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """Per-class reshape-reduce of row partials, all parts at once:
    ``partials`` [P, R, W] (the plan's R real class rows of each part),
    ``tile_pos`` int [P, n_tiles] -> [P, n_tiles, W].  ``plan`` is
    anything with ``classes``.  int32 sums wrap like the reference's."""
    if kind not in _REDUCE:
        raise ValueError(f"unknown reduction {kind!r}")
    P, trail = partials.shape[0], tuple(partials.shape[2:])
    outs, row0 = [], 0
    for cnt, L in plan.classes:
        outs.append(_reduce_depth(
            partials[:, row0:row0 + cnt * L].reshape((P, cnt, L) + trail),
            kind))
        row0 += cnt * L
    return _take_slots(outs, tile_pos, kind, partials.dtype,
                       partials.device, trail)


def _take_slots(outs, tile_pos, kind, dtype, device, trail):
    """Per-class slot results [P, cnt, *trail] + the trailing
    identity slot, taken by ``tile_pos`` [P, n_tiles] -> [P, n_tiles,
    *trail]."""
    P = tile_pos.shape[0]
    outs = outs + [torch.full((P, 1) + trail, identity_for(kind, dtype),
                              dtype=dtype, device=device)]
    slots = torch.cat(outs, dim=1)                   # [P, n_slots + 1, W]
    idx = tile_pos.to(torch.int64).reshape(
        tile_pos.shape + (1,) * len(trail)).expand(
        tuple(tile_pos.shape) + trail)
    return torch.gather(slots, 1, idx)


def _row_partials(flat_state, rowbind, rel, weight, kind, msg_fn):
    """Fetch the state rows of ``rowbind`` [P, n] for every part, make
    the messages and reduce each row with one launch of kernel B1 ->
    [P, n, W] row partials."""
    P, n = rowbind.shape
    vals = torch.index_select(flat_state.reshape(-1, W), 0,
                              rowbind.reshape(-1).to(torch.int64))
    msgs = msg_fn(vals.view(P, n, W), weight)
    # a block's slice of several parts' rows is a view the kernel cannot
    # take (one row a part merges into strides (Rp*W, 1))
    return chunk_partials(msgs.reshape(-1, W).contiguous(),
                          rel.reshape(-1, W).contiguous(), W,
                          kind).view(P, n, W)


def pair_partial(sp, flat_state, rowbind, rel, weight, tile_pos,
                 kind: str, msg_fn):
    """Pair-lane delivery + reduce for every part -> ``[P, n_tiles *
    128]`` (identity where pairs contribute nothing).  ``sp`` is a
    StackedPairPlan or PairGeometry; ``flat_state`` [P*vpad] the whole
    state; ``rowbind`` [P, Rp], ``rel`` int8 [P, Rp, 128], ``weight``
    [P, Rp, 128] | None and ``tile_pos`` [P, n_tiles] the stacked
    arrays; msg_fn(vals [P, Rp, 128], weight) -> messages (dead lanes
    carry real values that rel == -1 masks in kernel B1).  One launch
    of B1 over all [P*Rp, 128] rows."""
    if flat_state.dim() != 1:
        raise ValueError("pair delivery supports scalar vertex state "
                         "only")
    P = rowbind.shape[0]
    partials = _row_partials(flat_state, rowbind, rel, weight, kind,
                             msg_fn)
    red = class_combine(sp, partials[:, :sp.R], tile_pos, kind)
    return red.reshape(P, sp.n_tiles * W)


# streamed-delivery block budget: the delivered f32 value rows of one
# part in one block (a block covers every part: P times this)
PAIR_STREAM_BLOCK_BYTES = 64 << 20


def stream_blocks(classes, block_bytes: int = PAIR_STREAM_BLOCK_BYTES):
    """The streamed delivery's blocks, in order: (first row, slots S,
    depth L) for each, S*L rows of one class — the same blocks as the
    reference's scan (whole slots, sized so one part's f32 values fit
    ``block_bytes``, S a multiple of 8 where L is not)."""
    blocks, row0 = [], 0
    for cnt, L in classes:
        S = max(1, min(cnt, block_bytes // max(1, L * W * 4)))
        if L % 8 and S >= 8:
            S -= S % 8
        nB, rem = divmod(cnt, S)
        blocks += [(row0 + b * S * L, S, L) for b in range(nB)]
        if rem:
            blocks.append((row0 + nB * S * L, rem, L))
        row0 += cnt * L
    return blocks


def pair_partial_streamed(sp, flat_state, rowbind, rel, weight, tile_pos,
                          kind: str, msg_fn,
                          block_bytes: int = PAIR_STREAM_BLOCK_BYTES):
    """Memory-bounded pair delivery: the result of ``pair_partial``,
    but the delivered values and their row partials exist for one
    block at a time.  Each depth class runs in blocks of S whole slots
    (``stream_blocks``); a block fetches, reduces (one launch of
    kernel B1 over its [P*S*L, 128] rows) and folds its slots' depth
    rows to per-slot results [P, S, 128]."""
    if flat_state.dim() != 1:
        raise ValueError("pair delivery supports scalar vertex state "
                         "only")
    outs = []
    for r0, S, L in stream_blocks(sp.classes, block_bytes):
        n = S * L
        p = _row_partials(
            flat_state, rowbind[:, r0:r0 + n], rel[:, r0:r0 + n],
            None if weight is None else weight[:, r0:r0 + n], kind, msg_fn)
        outs.append(_reduce_depth(p.view(p.shape[0], S, L, W), kind))
    # the identity slot in the message dtype (msg_fn may promote)
    dtype = outs[0].dtype if outs else flat_state.dtype
    red = _take_slots(outs, tile_pos, kind, dtype, flat_state.device, (W,))
    return red.reshape(rowbind.shape[0], sp.n_tiles * W)


def resolve_pair_stream(pair_stream, pairs) -> bool:
    """Streamed delivery is the reference's default (its live memory
    is one block instead of [P*Rp, 128] values and partials);
    ``pair_stream=False`` keeps the monolithic path.  Which one the
    H100 should default to is open (ROADMAP)."""
    if pairs is None:
        return False
    return True if pair_stream is None else bool(pair_stream)


# ---------------------------------------------------------------------
# the SDDMM (vector-state dot) forms
# ---------------------------------------------------------------------


# rows a block of the monolithic pair and paged dot deliveries: 1 GB
# of D (ops/dot.DOT_BLOCK_BYTES); the reference's lax.map block is 256
# rows (lux_tpu/ops/pairs.py:843), a TPU choice
DOT_BLOCK_ROWS = DOT_BLOCK_BYTES // (W * W * 4)


def _row_block(s3, rowbind, rel, weight, tile, units) -> DotBlock:
    """A block of rows: source tiles ``rowbind`` and destination tiles
    ``tile`` (flat state-tile indices) of ``s3`` [n_rows, 128, K]."""
    return DotBlock(
        fetch=lambda: (torch.index_select(s3, 0, rowbind),
                       torch.index_select(s3, 0, tile)),
        rel=rel, weight=weight, units=units)


def pair_dot_blocks(state, rowbind, rel, weight, row_tile, part_tile0,
                    block_rows: int = DOT_BLOCK_ROWS) -> list:
    """The monolithic dot delivery's blocks: the [P*Rp] stacked rows in
    blocks of ``block_rows``, each fetching its rows' source tiles and
    destination tiles ``part_tile0 + row_tile`` from ``state`` [P*vpad,
    K] viewed as [P*vpad/128, 128, K]."""
    P, Rp = rowbind.shape
    s3 = state.reshape(-1, W, state.shape[-1])
    rb, rl = rowbind.reshape(-1), rel.reshape(-1, W)
    wt = weight.reshape(-1, W)
    tile = (part_tile0.reshape(P, 1) + row_tile).reshape(-1)
    return [_row_block(s3, rb[r0:r0 + n], rl[r0:r0 + n], wt[r0:r0 + n],
                       tile[r0:r0 + n], slice(r0, r0 + n))
            for r0, n in blocks(P * Rp, block_rows)]


def pair_partial_dot(sp, state, rowbind, rel, weight, row_tile, tile_pos,
                     part_tile0, msg_dot_fn,
                     block_rows: int = DOT_BLOCK_ROWS):
    """Pair-lane delivery for vector-state dot programs, every part at
    once -> ``[P, n_tiles * 128, K]`` sums (0 where pairs contribute
    nothing).  ``state`` [P*vpad, K] the whole state; ``rowbind``,
    ``row_tile`` [P, Rp], ``rel`` int8 / ``weight`` [P, Rp, 128],
    ``tile_pos`` [P, n_tiles] the stacked arrays; ``part_tile0`` [P, 1]
    the state tile of each part's tile 0 (p * vpad / 128).  Every
    [P*Rp] row runs ops/dot.dot_partials in blocks of ``block_rows``
    rows into stacked row partials, then the class combine."""
    if weight is None:
        raise ValueError("pair_partial_dot needs per-lane weights")
    P, Rp = rowbind.shape
    K = state.shape[-1]
    partials = torch.empty((P * Rp, W, K), dtype=state.dtype,
                           device=state.device)
    run_blocks(pair_dot_blocks(state, rowbind, rel, weight, row_tile,
                               part_tile0, block_rows),
               msg_dot_fn, partials)
    red = class_combine(sp, partials.view(P, Rp, W, K)[:, :sp.R],
                        tile_pos, "sum")
    return red.reshape(P, sp.n_tiles * W, K)


def dot_stream_blocks(classes, kdim: int,
                      block_bytes: int = DOT_BLOCK_BYTES):
    """The streamed dot delivery's blocks, in order: (first row, slots
    S, depth L), S*L rows of one class — the reference's scan blocks:
    whole slots, S sized so one part's block (its S and T tiles, the
    messages and partials [128, K] each and the [128, 128] dot and mask
    blocks a row) stays under ``block_bytes`` (ops/dot.DOT_BLOCK_BYTES;
    the reference's 64 MB, lux_tpu/ops/pairs.py:916, is a TPU
    choice)."""
    row_bytes = 4 * W * (W + 4 * max(1, kdim))
    out, row0 = [], 0
    for cnt, L in classes:
        S = max(1, min(cnt, block_bytes // max(1, L * row_bytes)))
        nB, rem = divmod(cnt, S)
        out += [(row0 + b * S * L, S, L) for b in range(nB)]
        if rem:
            out.append((row0 + nB * S * L, rem, L))
        row0 += cnt * L
    return out


def pair_dot_stream_units(state, rowbind, rel, weight, row_tile,
                          part_tile0, classes,
                          block_bytes: int = DOT_BLOCK_BYTES) -> list:
    """The streamed dot delivery's blocks (``dot_stream_blocks``, every
    part): [(DotBlock over the block's P*S*L rows, S, L)]."""
    P = rowbind.shape[0]
    s3 = state.reshape(-1, W, state.shape[-1])
    out = []
    for r0, S, L in dot_stream_blocks(classes, state.shape[-1],
                                      block_bytes):
        sl = slice(r0, r0 + S * L)
        tile = part_tile0.reshape(P, 1) + row_tile[:, sl]
        out.append((_row_block(s3, rowbind[:, sl].reshape(-1),
                               rel[:, sl].reshape(-1, W),
                               weight[:, sl].reshape(-1, W),
                               tile.reshape(-1), sl), S, L))
    return out


def pair_partial_dot_streamed(sp, state, rowbind, rel, weight, row_tile,
                              tile_pos, part_tile0, msg_dot_fn,
                              block_bytes: int = DOT_BLOCK_BYTES):
    """The result of ``pair_partial_dot`` with neither the [P*Rp, 128,
    K] row partials nor the fetched tiles existing beyond one block:
    each block (``dot_stream_blocks``, every part) runs the SDDMM step
    and folds its slots' depth rows to per-slot sums [P, S, 128, K]."""
    if weight is None:
        raise ValueError("pair_partial_dot needs per-lane weights")
    units = pair_dot_stream_units(state, rowbind, rel, weight, row_tile,
                                  part_tile0, sp.classes, block_bytes)
    return fold_stream_slots(
        sp, ((blk.partials(msg_dot_fn), S, L) for blk, S, L in units),
        tile_pos, state.shape[-1], state.dtype, state.device)


def fold_stream_slots(sp, block_partials, tile_pos, K: int, dtype,
                      device):
    """The streamed dot's combine: each block's row partials [P*S*L,
    128, K] (``block_partials`` yields (partials, S, L); a generator
    keeps one block live) summed over its slots' depth rows to per-slot
    sums [P, S, 128, K], then the slots taken by ``tile_pos`` ->
    ``[P, n_tiles * 128, K]``."""
    P = tile_pos.shape[0]
    outs = [p.view(P, S, L, W, K).sum(dim=2)
            for p, S, L in block_partials]
    red = _take_slots(outs, tile_pos, "sum", dtype, device, (W, K))
    return red.reshape(P, sp.n_tiles * W, K)


def resolve_pair_dot_stream(pair_stream, sp, rows: int, kdim: int) -> bool:
    """The reference's rule (lux_tpu/ops/pairs.py:1003): stream once the
    monolithic path's stacked f32 row partials [rows, Rp, 128, kdim]
    pass ``STREAM_MSG_BYTES``; True/False force."""
    if sp is None:
        return False
    if pair_stream is not None:
        return bool(pair_stream)
    return rows * sp.Rp * W * max(1, kdim) * 4 > STREAM_MSG_BYTES


def dot_msgs_numpy(state: np.ndarray, src: np.ndarray, dst: np.ndarray,
                   weight: np.ndarray, msg_dot_fn) -> np.ndarray:
    """float64 messages of edges ``src`` -> ``dst`` (indices into
    ``state`` [n, K]): msg_dot_fn(S, <S, T>, w), vectorised over the
    edges (``msg_dot_fn`` broadcasts, as colfilter's ``(w - dot)[...,
    None] * S`` does) -> [n_edges, K]."""
    s2 = np.asarray(state, np.float64)
    S = s2[src]
    dot = np.einsum("ek,ek->e", S, s2[dst])
    return np.asarray(msg_dot_fn(S, dot, np.asarray(weight, np.float64))
                      ).reshape(len(src), s2.shape[-1])


def stacked_pair_dot_numpy(sp: StackedPairPlan, p: int,
                           state: np.ndarray, part_tile0: int,
                           msg_dot_fn) -> np.ndarray:
    """float64 oracle for one part of the SDDMM pair delivery
    (lux_tpu/ops/pairs.py:1061): per live lane, dot = <S, T> with S the
    lane's source row and T its destination row, msgs = msg_dot_fn(S,
    dot, w) summed into the destination.  ``state`` [n_rows * 128, K];
    returns [n_tiles * 128, K].  With integer-valued states and weights
    whose sums stay under 2^24 it equals the f32 device result
    exactly."""
    rel = sp.rel_dst[p].astype(np.int64)
    rows, cols = np.nonzero((rel >= 0) & (rel < W))
    src = sp.rowbind[p][rows].astype(np.int64) * W + cols
    dst = sp.row_tile[p][rows].astype(np.int64) * W + rel[rows, cols]
    msg = dot_msgs_numpy(state, src, dst + part_tile0 * W,
                         sp.weight[p][rows, cols], msg_dot_fn)
    out = np.zeros((sp.n_tiles * W, msg.shape[-1]))
    np.add.at(out, dst, msg)
    return out


# graph-array keys of an engine's pair rows (pair_weight when weighted),
# under the reference's names; dot programs add PAIR_DOT_KEYS
PAIR_KEYS = ("pair_rowbind", "pair_rel", "pair_tile_pos")
PAIR_DOT_KEYS = ("pair_row_tile", "pair_tile0")


def part_tile0(num_parts: int, vpad: int) -> np.ndarray:
    """int32 [P, 1]: the state tile of each part's tile 0."""
    return (np.arange(num_parts) * (vpad // W)).astype(np.int32)[:, None]


def pair_graph_arrays(sp: StackedPairPlan, dot: bool = False,
                      vpad: int | None = None) -> dict:
    """The stacked plan's per-part host arrays for an engine's array
    dict (leading dim num_parts); ``dot`` adds each row's destination
    tile and each part's tile 0 (``vpad`` needed), which the SDDMM
    delivery fetches."""
    arrays = {"pair_rowbind": sp.rowbind, "pair_rel": sp.rel_dst,
              "pair_tile_pos": sp.tile_pos}
    if sp.weight is not None:
        arrays["pair_weight"] = sp.weight
    if dot:
        arrays["pair_row_tile"] = sp.row_tile
        arrays["pair_tile0"] = part_tile0(sp.rowbind.shape[0], vpad)
    return arrays
