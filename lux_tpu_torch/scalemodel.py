"""Cost model of one card, priced from constants measured on it
(counterpart of lux_tpu/scalemodel.py:64-372, :527).

Every per-unit figure lives in one frozen dataclass, ``CardConstants``.
The package's default instance, ``H100``, holds an NVIDIA H100's
figures, each measured by ``chip_smoke.py`` (its ``pricing`` line
prints them; ``H100_SOURCES`` names the phase and shape of each).
Every function takes ``constants=`` (None means ``H100``), so the same
formulas run on another table: the CPU tests feed the reference's TPU
figures and hold each function and each ``"auto"`` decision equal to
``lux_tpu.scalemodel``'s.

The formulas are the reference's; what a figure prices:

- the flat gather, per edge (``gather_small_ns`` below the card's
  table-size step ``big_table_bytes``, ``gather_big_ns`` past it);
- a pair row and a residual edge as whole paths: a delivered pair row
  (fetch, kernel B1, class combine) and a residual edge (gather, B1,
  segmented combine), each measured on the same cell the same way, so
  their ratio is the break-even fill; the dot path adds a per-K term
  to each;
- the paged rows: a page row's fetch, the lane shuffle per element and
  a delivered paged row (everything past the unique-page fetch); the
  page-major virtual row (``vrow_reduce_ns``);
- what ``use_mxu`` changes, each by the mechanism that runs it: the
  chunk partials per 128-lane chunk row (``vpu_row_ns`` a payload
  slice for kernel B1; ``s9_row_ns`` for kernel S9, which serves a
  scalar float32 sum; ``onehot_tile_ns`` fixed plus ``mxu_tile_ns`` a
  slice and round for the ``torch.bmm`` one-hot that serves every other
  width and kind), and a sum's segmented combine per partial element
  (``combine_pass_ns`` a doubling pass; ``segscan_lane_ns`` fixed plus
  ``segscan_slice_ns`` a slice for the scan as matmuls).  The dot path
  changes only its combine.  The reference prices its VPU row with
  ``VROW_REDUCE_NS`` and has one form; the card's B1 row and its
  page-major row differ, so they are two figures here;
- a query-batched gather's extra lane, the apply epilogue per vertex;
- the session-calibration probes' own figures (observe.py grades a
  session against them).

- the owner exchange's scan a padded owner slot (``owner_slot_ns``:
  decode, gather, B1, segmented combine and fold, the baseline the
  owner paged plans are priced against) and the owner page-major
  plan's route (``route_bytes_per_s``: on one card a device-local
  transpose of the routed rows; under the reference's figures its ICI
  link, ``pagemajor_route_ns``, lux_tpu/scalemodel.py:223).

What waits for ROADMAP A6b-2: the link tiers and measured link rates
between cards, ``Projection`` / ``project_pull`` / ``project_table``
and the owner branch of ``phase_model``.  Each raises NotPortedError
naming A6b-2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple


@dataclasses.dataclass(frozen=True)
class CardConstants:
    """One card's measured figures (ns a unit unless named otherwise)."""

    card: str                   # torch.cuda.get_device_name of the card
    power_limit: str            # nvidia-smi's power.limit at measurement
    gather_small_ns: float      # flat gather, per edge, small table
    gather_big_ns: float        # flat gather past the table-size step
    big_table_bytes: float      # the step: table bytes past which the
    #                             big-table rate prices the gather
    pair_row_ns: float          # one delivered 128-lane pair row
    pair_dot_row_k_ns: float    # + per K on the dot (SDDMM) path
    residual_edge_ns: float     # one residual edge (gather + B1 + combine)
    residual_dot_k_ns: float    # + per K on the dot path
    page_row_fetch_ns: float    # one [*, 128] page row fetched
    lane_shuffle_ns: float      # the 128-lane shuffle, per element
    paged_row_ns: float         # one delivered paged row past the fetch
    paged_dot_row_k_ns: float   # + per K on the dot path
    vrow_reduce_ns: float       # page-major: a virtual row's reduce
    #                             beyond its row fetch
    vpu_row_ns: float           # kernel B1, one 128-lane chunk row, a
    #                             payload slice
    onehot_tile_ns: float       # the one-hot forms' fixed toll a row
    mxu_tile_ns: float          # + a payload slice and round
    batch_lane_ns: float        # a batched gather's extra lane, per edge
    state_ns_per_vertex: float  # apply epilogue, per padded vertex
    probe_gather_ns: float      # observe's gather probe, per element
    probe_pair_dot_row_ns: float  # observe's pair-dot probe, per row
    probe_page_row_ns: float    # observe's paged-row probe, per row
    # the port's own use_mxu forms (None: a table without them, as the
    # reference's, whose use_mxu rule prices its one form alone)
    s9_row_ns: float | None = None         # kernel S9, one chunk row of
    #                                        a scalar float32 sum
    combine_pass_ns: float | None = None   # the segmented combine, one
    #                                        doubling pass, per element
    segscan_lane_ns: float | None = None   # the combine as matmuls, per
    #                                        chunk lane
    segscan_slice_ns: float | None = None  # + per payload slice
    # the owner exchange (None: a table without it)
    owner_slot_ns: float | None = None     # the owner scan, per padded
    #                                        owner slot
    route_bytes_per_s: float | None = None  # the owner page-major
    #                                        route: routed row bytes a
    #                                        second


# NVIDIA H100 80GB HBM3 at 700.00 W, as chip_smoke.py's pricing line
# measured them (PERF.md §6 names the run of each).  Shapes:
# H100_SOURCES.
H100 = CardConstants(
    card="NVIDIA H100 80GB HBM3",
    power_limit="700.00 W",
    gather_small_ns=0.0088872,
    gather_big_ns=0.033683,
    big_table_bytes=16777216.0,
    pair_row_ns=2.3973,
    pair_dot_row_k_ns=9.4518,
    residual_edge_ns=0.13981,
    residual_dot_k_ns=0.056390,
    page_row_fetch_ns=0.65202,
    lane_shuffle_ns=0.0038693,
    paged_row_ns=1.7400,
    paged_dot_row_k_ns=9.9473,
    vrow_reduce_ns=0.54113,
    vpu_row_ns=0.32786,
    onehot_tile_ns=103.57,
    mxu_tile_ns=0.77645,
    batch_lane_ns=0.0033908,
    state_ns_per_vertex=0.090996,
    probe_gather_ns=0.0417,
    probe_pair_dot_row_ns=181.98,
    probe_page_row_ns=69.209,
    s9_row_ns=0.66351,
    combine_pass_ns=0.010589,
    segscan_lane_ns=0.20683,
    segscan_slice_ns=0.017196,
    owner_slot_ns=0.080400,
    route_bytes_per_s=1.0993e12,
)

# Where each H100 figure came from: chip_smoke.py's phase and shape.
H100_SOURCES = {
    "gather_small_ns": "pricing: index_select of 33,554,432 random "
                       "int64 ids from f32 tables of 8 MB",
    "gather_big_ns": "pricing: the same gather from a 256 MB table",
    "big_table_bytes": "pricing: the table-size sweep 8-256 MB, the "
                       "largest table under 1.5x the 8 MB rate",
    "pair_row_ns": "pairs (monolithic): pair delivery ms / P*Rp, R-MAT "
                   "21 ef 16 pair_relabel, threshold 16, min_fill 24",
    "residual_edge_ns": "pairs (monolithic): residual gather + B1 + "
                        "segmented combine ms / residual edges, the same "
                        "cell",
    "pair_dot_row_k_ns": "colfilter pairs_monolithic: (pair dot delivery "
                         "+ class combine ms / P*Rp - pair_row_ns) / 20, "
                         "R-MAT 16 ef 128, min_fill 22",
    "residual_dot_k_ns": "colfilter pairs_monolithic: (residual dot "
                         "blocks + combine ms / residual edges - "
                         "residual_edge_ns) / 20",
    "page_row_fetch_ns": "paged: page fetch ms / (n_pages + Rp) rows, "
                         "R-MAT 21 ef 16 degree-relabelled",
    "lane_shuffle_ns": "paged: kernel B2 ms / (Rp * 128)",
    "paged_row_ns": "paged: (the paged delivery ms, timed whole, - "
                    "unique_pages * page_row_fetch_ns) / P*Rp",
    "paged_dot_row_k_ns": "colfilter paged: (delivery ms less the unique "
                          "pages' fetch, / P*Rp - paged_row_ns) / 20",
    "vrow_reduce_ns": "pagemajor: (virtual-row take + B1 + class combine "
                      "ms) / P*Rp - page_row_fetch_ns",
    "vpu_row_ns": "main: kernel B1 ms / (C * E / 128) rows, [73,712, 512]",
    "onehot_tile_ns": "mxu: the one-hot sum (torch.bmm) of ppr_batch's "
                      "one-column messages / (C * E / 128) rows, "
                      "[36,856, 512, 1], less mxu_tile_ns",
    "mxu_tile_ns": "mxu: (the same at eight columns [36,856, 512, 8] - at "
                   "one) / 7, per row",
    "batch_lane_ns": "ppr_batch: gather_by_width, (ms at B = 8 - ms at "
                     "B = 1) / 7 / rows, R-MAT 20",
    "state_ns_per_vertex": "pricing: main's decomposed apply median / "
                           "padded vertices",
    "probe_gather_ns": "pricing: observe.calibrate's gather probe",
    "probe_pair_dot_row_ns": "pricing: observe.calibrate's pair-dot probe",
    "probe_page_row_ns": "pricing: observe.calibrate's paged-row probe",
    "s9_row_ns": "mxu: kernel S9 ms / (C * E / 128) rows on the main "
                 "path's chunks, [73,712, 512] into W = 128",
    "combine_pass_ns": "mxu: the doubling combine_chunks ms over "
                       "chunks * W * K * passes, summed over main's "
                       "[73,712 x 128] partials and colfilter "
                       "pairs_monolithic's residual [C x 128 x 20]",
    "segscan_lane_ns": "mxu: the combine as matmuls (combine_chunks, "
                       "use_mxu) ms / (chunks * W) on main's partials "
                       "(K = 1), less segscan_slice_ns",
    "segscan_slice_ns": "mxu: (the same on colfilter pairs_monolithic's "
                        "residual partials (K = 20) - on main's) / 19",
    "owner_slot_ns": "owner: pagerank-mp's decode + owner gather + B1 + "
                     "segmented combine + fold ms / (P * C * E) padded "
                     "owner slots, R-MAT 21 ef 16 pair_relabel, 4 parts",
    "route_bytes_per_s": "owner_paged: the page-major route's [P, P*Mg, "
                         "128] f32 rows / its transpose ms, gather-ab's "
                         "R-MAT 21, 4 parts",
}

DEFAULT = H100
STATE_NS_PER_VERTEX = H100.state_ns_per_vertex


def _c(constants):
    return DEFAULT if constants is None else constants


def _refuse_a6(what: str):
    from lux_tpu_torch.engine.pull import NotPortedError
    raise NotPortedError(f"{what} is not ported yet (ROADMAP A6b-2): it "
                         f"prices the owner exchange or a link between "
                         f"cards")


# ---------------------------------------------------------------------
# pair rows against the residual path (min_fill="auto")

def pair_row_ns(kdim: int = 1, constants=None) -> float:
    """Cost of one delivered pair row: the scalar row, + a per-K term on
    the dot path."""
    c = _c(constants)
    if kdim <= 1:
        return c.pair_row_ns
    return c.pair_row_ns + c.pair_dot_row_k_ns * kdim


def residual_edge_ns(kdim: int = 1, constants=None) -> float:
    """Per-edge cost of the residual path serving the same program."""
    c = _c(constants)
    if kdim <= 1:
        return c.residual_edge_ns
    return c.residual_edge_ns + c.residual_dot_k_ns * kdim


def break_even_fill(kdim: int = 1, residual_ns: float | None = None,
                    constants=None) -> int:
    """min_fill break-even: the live lanes a pair row must deliver to
    beat sending its edges down the residual path, row cost over the
    residual's per-edge cost, rounded up."""
    if residual_ns is None:
        residual_ns = residual_edge_ns(kdim, constants)
    return max(1, math.ceil(pair_row_ns(kdim, constants) / residual_ns))


# ---------------------------------------------------------------------
# the paged and page-major gathers (gather="auto")

def paged_row_ns(kdim: int = 1, constants=None) -> float:
    """Cost of one delivered 128-lane paged row."""
    c = _c(constants)
    if kdim <= 1:
        return c.paged_row_ns
    return c.paged_row_ns + c.paged_dot_row_k_ns * kdim


def flat_gather_ns(table_bytes: float, constants=None) -> float:
    """The flat per-edge gather rate for a state table of this size."""
    c = _c(constants)
    return c.gather_big_ns if table_bytes > c.big_table_bytes \
        else c.gather_small_ns


def page_gather_ns(page_ratio: float, fill: float, kdim: int = 1,
                   constants=None) -> float:
    """Delivered ns an edge of the paged gather from the plan's stats:
    ``page_ratio`` (unique page elements an edge) prices the page
    fetch, ``fill`` (live lanes a row) amortizes the row."""
    c = _c(constants)
    if fill <= 0:
        raise ValueError(f"fill must be > 0, got {fill}")
    if page_ratio < 0:
        raise ValueError(f"page_ratio must be >= 0, got {page_ratio}")
    fetch = page_ratio * (c.page_row_fetch_ns / 128.0) * max(1, kdim)
    return fetch + paged_row_ns(kdim, constants) / fill


def page_break_even_fill(page_ratio: float = 1.0, table_bytes: float = 0.0,
                         kdim: int = 1, constants=None) -> int:
    """Row fill above which the paged path beats the flat gather at a
    given unique-page ratio (1 << 30: flat always wins)."""
    c = _c(constants)
    rate = flat_gather_ns(table_bytes, constants)
    if kdim > 1:
        rate = residual_edge_ns(kdim, constants)
    margin = rate - page_ratio * (c.page_row_fetch_ns / 128.0) \
        * max(1, kdim)
    if margin <= 0:
        return 1 << 30
    return max(1, math.ceil(paged_row_ns(kdim, constants) / margin))


def page_break_even_ratio(fill: float, table_bytes: float = 0.0,
                          kdim: int = 1, constants=None) -> float:
    """Largest unique-page ratio at which paged rows of this fill still
    beat the flat gather (negative: never)."""
    c = _c(constants)
    rate = flat_gather_ns(table_bytes, constants)
    if kdim > 1:
        rate = residual_edge_ns(kdim, constants)
    return (rate - paged_row_ns(kdim, constants) / fill) \
        / ((c.page_row_fetch_ns / 128.0) * max(1, kdim))


def owner_slot_ns(constants=None) -> float:
    """The owner exchange's scan, ns a padded owner slot (the reference's
    OWNER_SLOT_NS, lux_tpu/scalemodel.py:43)."""
    c = _c(constants)
    if c.owner_slot_ns is None:
        raise ValueError(f"{c.card}'s table has no owner slot rate")
    return c.owner_slot_ns


def pagemajor_route_ns(g_fill: float, itemsize: int = 4,
                       constants=None) -> float:
    """The owner page-major route's ns an edge: every (padded) lane of a
    routed 128-lane row moves ``itemsize`` bytes once, so an edge pays
    itemsize * 128 / g_fill bytes at ``route_bytes_per_s``
    (lux_tpu/scalemodel.py:223, there a link's rate; on one card a
    transpose)."""
    c = _c(constants)
    if g_fill <= 0:
        raise ValueError(f"g_fill must be > 0, got {g_fill}")
    if c.route_bytes_per_s is None:
        raise ValueError(f"{c.card}'s table has no route rate")
    return itemsize * (128.0 / g_fill) / (c.route_bytes_per_s * 1e-9)


def pagemajor_gather_ns(page_ratio: float, g_fill: float, v_fill: float,
                        kdim: int = 1, routed: bool = False,
                        itemsize: int = 4, constants=None) -> float:
    """Delivered ns an edge of the page-major layout: the page fetch,
    row fetch and shuffle over the gather rows (``g_fill``), the reduce
    over the virtual rows (``v_fill``), and with ``routed`` (the owner
    plan) the route (``pagemajor_route_ns``)."""
    c = _c(constants)
    if kdim > 1:
        raise ValueError("page-major does not serve K-dim (SDDMM) "
                         "programs; use page_gather_ns")
    if g_fill <= 0 or v_fill <= 0:
        raise ValueError(f"fills must be > 0, got g_fill={g_fill} "
                         f"v_fill={v_fill}")
    if page_ratio < 0:
        raise ValueError(f"page_ratio must be >= 0, got {page_ratio}")
    fetch = page_ratio * (c.page_row_fetch_ns / 128.0)
    gather = (c.page_row_fetch_ns + 128 * c.lane_shuffle_ns) / g_fill
    reduce = (c.page_row_fetch_ns + c.vrow_reduce_ns) / v_fill
    route = pagemajor_route_ns(g_fill, itemsize, constants) if routed \
        else 0.0
    return fetch + gather + reduce + route


def pagemajor_break_even_vfill(page_ratio: float = 1.0,
                               g_fill: float = 128.0,
                               table_bytes: float = 0.0,
                               routed: bool = False, itemsize: int = 4,
                               constants=None) -> int:
    """Virtual-row fill above which page-major beats the flat gather
    (``routed``: with the owner plan's route)."""
    c = _c(constants)
    rate = flat_gather_ns(table_bytes, constants)
    margin = rate - page_ratio * (c.page_row_fetch_ns / 128.0) \
        - (c.page_row_fetch_ns + 128 * c.lane_shuffle_ns) / g_fill
    if routed:
        margin -= pagemajor_route_ns(g_fill, itemsize, constants)
    if margin <= 0:
        return 1 << 30
    return max(1, math.ceil((c.page_row_fetch_ns + c.vrow_reduce_ns)
                            / margin))


# ---------------------------------------------------------------------
# the one-hot (matrix-unit) reduce against kernel B1 (use_mxu="auto")

def mxu_reduce_rounds(kind: str, nbits: int = 32) -> int:
    """Contractions a chunk row for a reduce kind: sum one; min/max the
    bit-serial tournament, a vote and a route-back a bit."""
    if kind == "sum":
        return 1
    if kind in ("min", "max"):
        return 2 * nbits
    raise ValueError(f"unknown reduce kind {kind!r}")


def vpu_reduce_row_ns(wide: int = 1, constants=None) -> float:
    """Kernel B1's cost of one 128-lane chunk row, once a payload slice."""
    if wide < 1:
        raise ValueError(f"wide must be >= 1, got {wide}")
    return _c(constants).vpu_row_ns * wide


def mxu_reduce_row_ns(wide: int = 1, kind: str = "sum", nbits: int = 32,
                      constants=None) -> float:
    """The one-hot forms' cost of one 128-lane chunk row: the fixed toll
    plus a contraction a payload slice and round."""
    c = _c(constants)
    if wide < 1:
        raise ValueError(f"wide must be >= 1, got {wide}")
    return c.onehot_tile_ns + c.mxu_tile_ns * wide * mxu_reduce_rounds(
        kind, nbits)


def mxu_break_even_wide(kind: str = "sum", nbits: int = 32,
                        constants=None) -> int:
    """Smallest K x B payload width at which the one-hot reduce beats B1
    for a kind (1 << 30: never)."""
    c = _c(constants)
    per_slice_margin = c.vpu_row_ns \
        - c.mxu_tile_ns * mxu_reduce_rounds(kind, nbits)
    if per_slice_margin <= 0:
        return 1 << 30
    return max(1, math.ceil(c.onehot_tile_ns / per_slice_margin))


# use_mxu="auto" on the card's table takes the matrix-unit forms only
# when they price under this share of the plain reduce: they reorder
# the float sums, and a near tie is inside the spread of the figures
# between hosts (host-bound figures moved up to 1.5x between two runs
# on the card, PERF.md §6)
MXU_MARGIN = 0.9


class ReduceLayout(NamedTuple):
    """The tiled reduce's shape, as the engine holds it: every part's
    chunks of E edges into W lanes, and the longest tile in chunks."""

    chunks: int
    E: int
    W: int
    max_len: int


def _has_port_forms(c) -> bool:
    return None not in (c.s9_row_ns, c.combine_pass_ns, c.segscan_lane_ns,
                        c.segscan_slice_ns)


def partials_row_ns(use_mxu: bool, wide: int = 1, kind: str = "sum",
                    nbits: int = 32, scalar_f32: bool = False,
                    constants=None) -> float:
    """One 128-lane chunk row of the partials ``use_mxu`` selects:
    kernel B1 (False); kernel S9 for a scalar float32 sum when the
    table has its row; the one-hot forms otherwise."""
    c = _c(constants)
    if not use_mxu:
        return vpu_reduce_row_ns(wide, constants)
    if scalar_f32 and kind == "sum" and wide == 1 \
            and c.s9_row_ns is not None:
        return c.s9_row_ns
    return mxu_reduce_row_ns(wide, kind, nbits, constants)


def combine_passes(max_len: int) -> int:
    """Doubling passes of the segmented combine: ceil(log2(max_len))."""
    return (int(max_len) - 1).bit_length() if max_len > 1 else 0


def combine_ns(chunks: int, W: int, wide: int, max_len: int,
               use_mxu: bool, constants=None) -> float:
    """The segmented combine of [chunks, W, wide] partials: its doubling
    passes, or (``use_mxu``, a sum) the scan as matmuls; nothing when
    every tile fits in one chunk."""
    c = _c(constants)
    if not _has_port_forms(c):
        raise ValueError(f"the table {c.card!r} has no combine figures")
    if max_len <= 1:
        return 0.0
    lanes = chunks * W
    if use_mxu:
        return lanes * (c.segscan_lane_ns + c.segscan_slice_ns * wide)
    return lanes * wide * combine_passes(max_len) * c.combine_pass_ns


def reduce_ns(use_mxu: bool, layout: ReduceLayout, kind: str = "sum",
              wide: int = 1, nbits: int = 32, scalar_f32: bool = False,
              dot: bool = False, constants=None) -> float:
    """The tiled reduce of one iteration, partials plus combine, as
    ``use_mxu`` runs it.  The dot path's partials do not change with
    ``use_mxu`` (its combine does), so they are left out there."""
    partials = 0.0 if dot else layout.chunks * layout.E / 128.0 \
        * partials_row_ns(use_mxu, wide, kind, nbits, scalar_f32, constants)
    return partials + combine_ns(layout.chunks, layout.W, wide,
                                 layout.max_len, use_mxu and kind == "sum",
                                 constants)


def resolve_use_mxu(kind: str, wide: int = 1, nbits: int = 32,
                    constants=None, *, scalar_f32: bool = False,
                    dot: bool = False,
                    layout: ReduceLayout | None = None) -> bool:
    """``use_mxu="auto"``.  On a table without the port's own forms
    (the reference's): the one-hot reduce when the payload (K x B) is
    wide enough to amortize its toll, the reference's rule.  On the
    card's table, the matrix-unit reduce when ``reduce_ns`` prices it
    under MXU_MARGIN of the plain one on the engine's ``layout``; with
    no tiled layout (a flat or paged pull engine, the push engine) the
    partial rows alone, and a dot program keeps the plain path."""
    c = _c(constants)
    if not _has_port_forms(c):
        return wide >= mxu_break_even_wide(kind, nbits, constants)
    if layout is None:
        if dot:
            return False
        return partials_row_ns(True, wide, kind, nbits, scalar_f32, c) \
            < MXU_MARGIN * partials_row_ns(False, wide, kind, nbits,
                                           scalar_f32, c)
    kw = dict(kind=kind, wide=wide, nbits=nbits, scalar_f32=scalar_f32,
              dot=dot, constants=c)
    return reduce_ns(True, layout, **kw) \
        < MXU_MARGIN * reduce_ns(False, layout, **kw)


# ---------------------------------------------------------------------
# query batching

def batched_edge_ns(B: int, rate: float | None = None,
                    constants=None) -> float:
    """Per-edge cost of one batched dense iteration serving B queries:
    the scalar gather plus (B - 1) lanes riding along."""
    c = _c(constants)
    if rate is None:
        rate = c.gather_small_ns
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    return rate + c.batch_lane_ns * (B - 1)


def per_query_edge_ns(B: int, rate: float | None = None,
                      constants=None) -> float:
    """Delivered cost an edge a query at batch width B."""
    return batched_edge_ns(B, rate, constants) / B


def batch_sweep_table(widths=(1, 2, 4, 8, 16, 32, 64),
                      rate: float | None = None, constants=None) -> str:
    """Markdown table of the per-query cost over batch widths."""
    lines = ["| B | edge ns (batched iter) | ns/edge/query "
             "| vs B=1 |",
             "|---|---|---|---|"]
    base = per_query_edge_ns(1, rate, constants)
    for b in widths:
        pq = per_query_edge_ns(b, rate, constants)
        lines.append(f"| {b} | {batched_edge_ns(b, rate, constants):.2f} | "
                     f"{pq:.2f} | {base / pq:.1f}x |")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# the per-phase model observe.decompose compares against

def phase_model(*, engine: str, exchange: str, ne: int, nv: int,
                kdim: int = 1, pair_coverage: float = 0.0,
                pair_row_inflation: float = 1.0,
                chunk_inflation: float = 1.2,
                state_bytes_per_vertex: int = 4,
                dot: bool = False, scale: float = 1.0,
                paged: bool = False, page_ratio: float = 0.0,
                page_fill: float = 128.0,
                page_scale: float | None = None,
                page_mode: str = "paged",
                page_g_fill: float = 128.0,
                use_mxu: bool = False,
                mxu_wide: int = 1,
                reduce_kind: str = "sum",
                state_nbits: int = 32, scalar_f32: bool = False,
                constants=None) -> dict:
    """Predicted ns of each phase of ONE engine iteration, keyed by the
    engines' ``timed_phases`` names; None where no measured figure
    prices the phase (observe's verdict "unmodeled").  ``scale``
    rescales every figure into this session's ns (observe.session_scale);
    ``page_scale`` the paged delivery's, when the session has one.  The
    pair rows are priced into the gather (relax) phase, as the
    reference prices them, though both engines deliver them in reduce.
    ``scalar_f32``: the reduce is a scalar float32 sum, which kernel S9
    serves under ``use_mxu``."""
    c = _c(constants)
    if engine not in ("pull", "push"):
        raise ValueError(f"unknown engine {engine!r}")
    if exchange == "owner":
        _refuse_a6("phase_model's owner exchange branch")
    cov = pair_coverage
    pair_rows = ne * cov * pair_row_inflation / 128.0
    pair_ns = pair_rows * pair_row_ns(kdim, constants) * scale
    residual_ne = ne * (1.0 - cov)
    state_bytes = nv * state_bytes_per_vertex

    if paged:
        if page_mode == "pagemajor":
            per_edge = pagemajor_gather_ns(page_ratio, page_g_fill,
                                           page_fill, constants=constants)
        else:
            per_edge = page_gather_ns(page_ratio, page_fill, kdim,
                                      constants)
        deliver = ne * per_edge \
            * (scale if page_scale is None else page_scale)
    else:
        rate = (c.gather_big_ns if state_bytes > c.big_table_bytes
                else c.gather_small_ns)
        if dot:
            rate = residual_edge_ns(kdim, constants)
        deliver = residual_ne * rate * scale
    apply_ns = nv * c.state_ns_per_vertex * scale
    if paged:
        pair_ns = 0.0

    model: dict[str, float | None] = {"exchange": None}
    if dot:
        model["dot_reduce"] = deliver + pair_ns
    else:
        key = "relax" if engine == "push" else "gather"
        model[key] = deliver + pair_ns
        if use_mxu:
            rows = ne * chunk_inflation / 128.0
            red = rows * partials_row_ns(
                True, mxu_wide, reduce_kind, state_nbits, scalar_f32,
                constants) * scale
            model["reduce"] = red
            model[f"{key}_reduce"] = deliver + pair_ns + red
        else:
            model["reduce"] = None
            model[f"{key}_reduce"] = deliver + pair_ns
    model["update" if engine == "push" else "apply"] = apply_ns
    return model


def project_pull(ne: int, nv: int, chips: int, **kw):
    """The reference's projection of a pull step onto ``chips`` cards
    over its link tiers (lux_tpu/scalemodel.py:457): ROADMAP A6b-2,
    which needs a link's measured rate between cards."""
    _refuse_a6("project_pull (a step projected over a link)")


def project_table(ne: int, nv: int, chip_counts=(1, 4, 8, 16, 64), **kw):
    """The reference's projection table (lux_tpu/scalemodel.py:639):
    ROADMAP A6b-2."""
    _refuse_a6("project_table (steps projected over links)")
