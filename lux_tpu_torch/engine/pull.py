"""The pull engine: dense gather-apply iterations on one device
(counterpart of lux_tpu/engine/pull.py:45-60, :142-194, :240-304,
:361-462, :535-729, :922-962, :1108, :1235).

One iteration, every part at once (parts are a batch dimension):

1. gather each edge's source state by its precomputed padded slot
   (``gather_rows`` on the flat ``[P*vpad, ...]`` state table);
2. per-edge message (``program.edge_value``);
3. scatter-free segment reduction to each part's local destinations:
   the tiled layout (ops/tiled.py) runs kernel B1 over all ``P*C``
   chunks in one launch and then the segmented chunk combine;
   ``layout="flat"`` is the scatter-reduce oracle (ops/segment.py);
4. per-vertex apply epilogue, masked to real vertex slots.

``gather="paged"`` / ``"pagemajor"`` replace steps 1-3 with the
page-binned delivery (ops/pagegather.py): the plan IS the edge layout,
so neither chunk arrays nor a per-edge gather exist; one iteration
launches kernel B2 (lane shuffle) and kernel B1 (over [P*Rp, 128]
rows) once each.

``pair_threshold`` moves the edges of dense (src tile, dst tile) pairs
out of the tiled path into pair-lane rows (ops/pairs.py): an iteration
runs the tiled path over the residual edges and the pair delivery
(one launch of B1 over all [P*Rp, 128] pair rows, or one a block when
streamed), combined per destination.

Query-batched programs (``program.batch = B``; personalized PageRank)
carry a trailing query axis: state [P, vpad, B], one source gather an
edge serving all B queries, and kernel B1's batched form
(ops/chunk_reduce.py ``chunk_partials_batched``) over the [P*C, E, B]
messages.  A program's ``extra_arrays`` (the reset vectors) ride as
graph arrays ``prog_<name>``, reach ``apply`` as ``ctx.extra`` and are
swapped in place by ``update_program_arrays``.

Programs whose destination dependence is only the inner product <src,
dst> (``edge_value_from_dot``, colfilter) replace steps 1-3 on the
tiled layout, pair rows and paged rows by the blocked SDDMM of
ops/dot.py: per block of chunks or rows, the source rows and the
destination tile, D = S @ T^T, each edge's lane of D, the messages and
a one-hot matmul to per-lane sums (``torch.bmm``; no hand kernel: the
reference computes these products outside Pallas too), then the same
chunk or class combine.  Other programs reading the destination
(``needs_dst``) gather it per edge.  State may carry trailing dims
(colfilter's [P, vpad, K]).

The reference fuses a fixed-iteration run into one XLA program; here a
run is a Python loop over ``step`` on the device's stream.  The
reference's exchange variants (owner), ``gather="auto"``, streamed
chunk blocks and the mesh are refused with a typed
:class:`NotPortedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.program import PartCtx, PullProgram, vmask_of
from lux_tpu_torch.graph import ShardedGraph
from lux_tpu_torch.ops.dot import (DOT_BLOCK_BYTES, DotBlock, blocks,
                                   run_blocks)
from lux_tpu_torch.ops.pagegather import (PAGED_DOT_KEYS, PAGED_KEYS, W,
                                          engine_page_plan, paged_partial,
                                          paged_partial_dot,
                                          plan_graph_arrays, row_slots)
from lux_tpu_torch.ops.pairs import (DOT_BLOCK_ROWS, PAIR_DOT_KEYS,
                                     PAIR_KEYS,
                                     pair_graph_arrays,
                                     pair_partial, pair_partial_dot,
                                     pair_partial_dot_streamed,
                                     pair_partial_streamed,
                                     plan_sharded_pairs,
                                     resolve_pair_dot_stream,
                                     resolve_pair_stream)
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (TiledLayout, combine_op,
                                     combine_partials, segment_plan,
                                     tiled_segment_reduce)

# exchange="auto" picks the owner exchange once the flat state table
# passes this many bytes — the reference's rule (engine/pull.py:80)
OWNER_AUTO_BYTES = 96 << 20

TILED_KEYS = ("src_slot", "rel_dst", "chunk_start", "last_chunk", "deg",
              "nvp")


def dot_kdim(program) -> int:
    """K of a dot program's vector state, from ``state_bytes`` = 4 * K
    (the reference's ``_dot_kdim``, lux_tpu/engine/pull.py:51-60); 1
    for other programs.  It feeds the streamed pair-dot rule."""
    if getattr(program, "edge_value_from_dot", None) is None:
        return 1
    return max(1, (getattr(program, "state_bytes", None) or 4) // 4)


def uses_dst(program) -> bool:
    """Whether the program reads destination state at all (per edge, or
    only through <src, dst>)."""
    return bool(program.needs_dst
                or getattr(program, "edge_value_from_dot", None)
                is not None)


class NotPortedError(NotImplementedError):
    """An option of the reference engine that the port does not carry
    yet; the message names the ROADMAP item that brings it."""


def _refuse(what: str, item: str):
    raise NotPortedError(f"{what} is not ported yet (ROADMAP {item}); "
                         f"the port runs one device, layout "
                         f"'tiled'/'flat', gather 'flat'/'paged'/"
                         f"'pagemajor' or pair-lane rows, exchange "
                         f"'gather'")


def _check_pair_program(layout: str, program) -> None:
    """What pair-lane delivery refuses, with the reference's messages
    (lux_tpu/engine/pull.py:372-384)."""
    if layout != "tiled":
        raise ValueError("pair_threshold requires the tiled layout")
    if getattr(program, "batch", None) is not None:
        raise ValueError(
            "pair_threshold does not support query-batched programs: "
            "pair delivery reads scalar vertex state "
            "(ops/pairs.pair_partial); run batched engines without pairs")
    dot = getattr(program, "edge_value_from_dot", None)
    if program.needs_dst and dot is None:
        raise ValueError("pair_threshold supports programs whose "
                         "edge_value depends only on the source state, "
                         "or on <src, dst> via edge_value_from_dot")


def check_batched_gather(gather: str, program, refuse) -> None:
    """Query-batched programs on the page-binned deliveries: their
    vector rows through the lane shuffle come with ROADMAP A7b."""
    if gather in ("paged", "pagemajor") and \
            getattr(program, "batch", None) is not None:
        refuse(f"query-batched programs with gather={gather!r} (vector "
               f"rows through the paged lane resolve)", "A7b")


def program_arrays(program, sg) -> dict:
    """The program's ``extra_arrays`` as graph arrays ``prog_<name>``."""
    fn = getattr(program, "extra_arrays", None)
    if fn is None:
        return {}
    return {f"prog_{k}": np.asarray(v) for k, v in fn(sg).items()}


def _outside(x: torch.Tensor, hi: int) -> bool:
    """Any entry of ``x`` outside [0, hi)."""
    return bool(x.numel()) and (int(x.min()) < 0 or int(x.max()) >= hi)


def resolve_exchange(exchange: str, sg: ShardedGraph, program,
                     itemsize: int | None = None) -> str:
    """'auto' resolves as the reference does: 'owner' once the state
    table passes OWNER_AUTO_BYTES (for programs whose messages depend
    only on the source), else 'gather'.  Only 'gather' is ported.
    ``itemsize``: bytes per vertex of the state (default the program's
    ``state_bytes``, else 4)."""
    if exchange == "auto":
        itemsize = itemsize or getattr(program, "state_bytes", None) or 4
        big = sg.num_parts * sg.vpad * itemsize > OWNER_AUTO_BYTES
        if big and not uses_dst(program):
            _refuse(f"the owner exchange, which exchange='auto' picks "
                    f"for this {sg.num_parts * sg.vpad * itemsize} B "
                    f"state table (pass exchange='gather'),", "A6")
        exchange = "gather"
    if exchange == "owner":
        _refuse("exchange='owner'", "A6")
    if exchange != "gather":
        raise ValueError(f"unknown exchange {exchange!r}")
    return exchange


def common_graph_arrays(sg: ShardedGraph) -> dict:
    """deg + nvp, the apply-epilogue arrays every layout needs."""
    return dict(deg=sg.deg_padded,
                nvp=sg.nv_part.astype(np.int32)[:, None])


def build_graph_arrays(sg: ShardedGraph, layout: str, tile_e: int,
                       needs_dst: bool = False):
    """Per-part host arrays (leading dim num_parts) for either edge
    layout -> (arrays dict, TiledLayout | None).  The tiled keys and
    values are the reference's (engine/pull.py:164-194); ``needs_dst``
    adds each chunk's destination tile ``chunk_tile``."""
    common = common_graph_arrays(sg)
    if layout == "flat":
        arrays = dict(src_slot=sg.src_slot, dst_local=sg.dst_local,
                      **common)
        if sg.weighted:
            arrays["weight"] = sg.edge_weight
        return arrays, None
    if layout != "tiled":
        raise ValueError(f"unknown layout {layout!r}")
    lay = TiledLayout.build(sg.row_ptr_local, sg.dst_local, sg.vpad,
                            E=tile_e)
    arrays = dict(src_slot=lay.chunk(sg.src_slot), rel_dst=lay.rel_dst,
                  chunk_start=lay.chunk_start, last_chunk=lay.last_chunk,
                  **common)
    if sg.weighted:
        arrays["weight"] = lay.chunk(sg.edge_weight)
    if needs_dst:
        arrays["chunk_tile"] = lay.chunk_tile
    return arrays, lay


def device_arrays(arrays: dict, device) -> dict:
    """Host arrays -> tensors on ``device``.  uint32 arrays (the packed
    slot_lane) ride as int32 with the same bits: torch's uint32 has
    thin CUDA coverage."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.tensor(v, device=device)
    return out


def padded_view(table: torch.Tensor) -> torch.Tensor:
    """A copy of a [N, B] table as a view with one element of row
    padding (row stride B + 1): the same values, rows that are no
    longer a multiple of 16 bytes apart."""
    padded = table.new_empty((table.shape[0], table.shape[1] + 1))
    padded[:, :-1] = table
    return padded[:, :-1]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a [N] or [N, B] state table: the engines' one
    state gather an edge.  On the card, torch's ``index_select`` of
    rows whose bytes are a multiple of 16 takes a vectorized kernel
    that costs about 0.6 ns a row whatever the row's width (11.34 ms
    for the 18.9M rows of R-MAT 20 at B = 4, 8 or 16, against 0.13-0.15
    ms at B = 1 or 2; NVIDIA H100 80GB HBM3, 700.00 W, torch 2.11).  The
    same rows read through ``padded_view`` take its generic kernel:
    0.31 / 0.57 / 1.00 ms at B = 4 / 8 / 16, the same bits (``chip_smoke.py``'s ppr_batch
    ``gather_by_width``; PERF.md §5).  Other tables, and every table
    on the CPU, go to ``index_select`` as they are."""
    if (table.device.type == "cuda" and table.dim() == 2
            and table.shape[1] * table.element_size() % 16 == 0):
        table = padded_view(table)
    return torch.index_select(table, 0, idx)


def check_dense_arrays(a: dict, P: int, vpad: int, tiles, pages,
                       pairs) -> None:
    """Shapes and index ranges of a dense engine's arrays on the
    device (tiled, flat or paged, with or without pair rows), checked
    once: an out-of-range index would fault on the card."""
    if a["deg"].shape != (P, vpad) or a["nvp"].shape != (P, 1):
        raise ValueError(f"deg {tuple(a['deg'].shape)} / nvp "
                         f"{tuple(a['nvp'].shape)} do not match "
                         f"num_parts={P} vpad={vpad}")
    if pages is not None:
        check_paged_arrays(a, P, vpad, pages)
        return
    src = a["src_slot"]
    if _outside(src, P * vpad):
        raise ValueError(f"src_slot outside the [0, {P * vpad}) state "
                         f"table")
    if tiles is not None:
        shape = (P, tiles.n_chunks, tiles.E)
        if (tuple(src.shape) != shape
                or tuple(a["rel_dst"].shape) != shape
                or a["rel_dst"].dtype != torch.int8
                or tuple(a["last_chunk"].shape) != (P, tiles.n_tiles)):
            raise ValueError(
                f"tiled arrays do not match [P, C, E] = {shape} / "
                f"last_chunk [P, n_tiles={tiles.n_tiles}] int8 rel")
        ct = a.get("chunk_tile")
        if ct is not None and (tuple(ct.shape) != shape[:2]
                               or _outside(ct, tiles.n_tiles + 1)):
            raise ValueError(f"chunk_tile is not [P, C] = {shape[:2]} "
                             f"in [0, {tiles.n_tiles}]")
        if pairs is not None:
            check_pair_arrays(a, P, vpad, pairs)


def flat_segments(dst_local: torch.Tensor, vpad: int) -> torch.Tensor:
    """The flat oracle's segment ids: one segment space for all parts,
    with each part's trash row vpad kept apart."""
    P = dst_local.shape[0]
    base = torch.arange(P, device=dst_local.device)[:, None] * (vpad + 1)
    return (dst_local.to(torch.int64) + base).reshape(-1)


def check_paged_arrays(a: dict, P: int, vpad: int, pp) -> None:
    """Shapes and index ranges of an engine's paged arrays ``a`` (on
    the device), checked once: an out-of-range index would fault on
    the card."""
    ids, sl, rel, tp = (a[k] for k in PAGED_KEYS)
    Rg = sl.shape[1] if sl.dim() == 3 else -1
    vrs = a.get("pg_vrs")
    w = a.get("pg_w")
    ok = (ids.dim() == 2 and ids.shape[0] == P
          and tuple(sl.shape) == (P, Rg, W) and sl.dtype == torch.int32
          and tuple(rel.shape) == (P, pp.Rp, W)
          and rel.dtype == torch.int8
          and tuple(tp.shape) == (P, pp.n_tiles)
          and pp.n_tiles * W == vpad
          and sum(c * L for c, L in pp.classes) == pp.R <= pp.Rp
          and (w is None or tuple(w.shape) == (P, pp.Rp, W))
          and (tuple(vrs.shape) == (P, pp.Rp) if vrs is not None
               else Rg == pp.Rp))
    if not ok:
        raise ValueError(
            f"paged arrays do not match the plan geometry {pp} "
            f"(num_parts={P}, vpad={vpad})")

    if (_outside(ids, P * vpad // W)
            or _outside(row_slots(sl), ids.shape[1])
            or _outside(tp, pp.n_slots + 1)
            or (vrs is not None and _outside(vrs, Rg))):
        raise ValueError("paged arrays index outside the state table, "
                         "the page list, the class slots or the "
                         "gather rows")
    if "pg_rt" in a:
        check_dot_tiles(a["pg_rt"], a["pg_t0"], P, vpad, pp, "pg")


def check_dot_tiles(row_tile, tile0, P: int, vpad: int, geom,
                    what: str) -> None:
    """A dot engine's destination-tile arrays: ``row_tile`` [P, Rp] in
    [0, n_tiles) and ``tile0`` [P, 1] = each part's first state tile."""
    want = torch.arange(P, device=tile0.device)[:, None] * (vpad // W)
    if (tuple(row_tile.shape) != (P, geom.Rp)
            or _outside(row_tile, geom.n_tiles)
            or tuple(tile0.shape) != (P, 1)
            or not torch.equal(tile0.to(torch.int64), want)):
        raise ValueError(f"{what} dot arrays: row tiles must be [P, Rp] "
                         f"in [0, {geom.n_tiles}) and tile 0 [P, 1] = "
                         f"p * vpad / {W}")


def check_pair_arrays(a: dict, P: int, vpad: int, sp) -> None:
    """Shapes and index ranges of an engine's pair arrays ``a`` (on the
    device), checked once: an out-of-range rowbind or tile_pos would
    fault on the card."""
    rb, rel, tp = (a[k] for k in PAIR_KEYS)
    w = a.get("pair_weight")
    ok = (tuple(rb.shape) == (P, sp.Rp) and rb.dtype == torch.int32
          and tuple(rel.shape) == (P, sp.Rp, W)
          and rel.dtype == torch.int8
          and tuple(tp.shape) == (P, sp.n_tiles)
          and sp.n_tiles * W == vpad
          and sum(c * L for c, L in sp.classes) == sp.R <= sp.Rp
          and sum(c for c, _L in sp.classes) == sp.n_slots
          and (w is None or tuple(w.shape) == (P, sp.Rp, W)))
    if not ok:
        raise ValueError(
            f"pair arrays do not match the plan geometry (classes "
            f"{len(sp.classes)}, R={sp.R}, Rp={sp.Rp}, n_tiles="
            f"{sp.n_tiles}, n_slots={sp.n_slots}; num_parts={P}, "
            f"vpad={vpad})")
    if _outside(rb, P * vpad // W) or _outside(tp, sp.n_slots + 1):
        raise ValueError("pair arrays index outside the state table "
                         "or the class slots")
    if "pair_row_tile" in a:
        check_dot_tiles(a["pair_row_tile"], a["pair_tile0"], P, vpad, sp,
                        "pair")


class PullEngine:
    """Pull-model iterations for one ShardedGraph + program on one
    device (``device=None`` means the card; pass ``"cpu"`` for the
    plain PyTorch versions)."""

    plan_seconds = 0.0      # host seconds spent building the paged or
                            # pair plan

    def __init__(self, sg: ShardedGraph, program: PullProgram, *,
                 device=None, layout: str = "tiled", tile_e: int = 512,
                 exchange: str = "auto", gather: str = "flat",
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 stream_msgs: bool | None = None, mesh=None,
                 dot_block_chunks: int | None = None,
                 dot_block_rows: int | None = None):
        """``pair_threshold``: serve the edges of (src tile, dst tile)
        pairs with at least this many edges by pair-lane rows
        (ops/pairs.py; needs vpad % 128 == 0), the rest by the tiled
        path; ``pair_min_fill`` drops pair rows with fewer live lanes
        to the residual; ``pair_stream`` (None = the reference's
        default: streamed for scalar programs, by the 1 GB rule for
        dot programs) reduces the pair rows in blocks.
        ``dot_block_chunks`` / ``dot_block_rows``: chunks / rows a
        block of the dot path (None: 1 GB of the [B, E, W] f32 dot
        intermediate, ops/dot.DOT_BLOCK_BYTES; the reference's TPU
        blocks are 128 chunks and 256 rows); results do not depend on
        them beyond the order of float sums."""
        dev = resolve_device(device)
        if mesh is not None:
            _refuse("a device mesh", "A6")
        if gather == "auto":
            _refuse("gather='auto' (it resolves through scalemodel, "
                    "whose constants were measured on the TPU)", "A10")
        if gather in ("paged", "pagemajor") and pair_threshold is not None:
            raise ValueError(
                f"gather={gather!r} subsumes pair delivery (both are "
                f"row-granular layouts); build without pair_threshold")
        if stream_msgs:
            _refuse("streamed chunk blocks (stream_msgs)", "A6")
        if pair_threshold is not None:
            _check_pair_program(layout, program)
        check_batched_gather(gather, program, _refuse)
        resolve_exchange(exchange, sg, program)
        t0 = time.perf_counter()
        plan = engine_page_plan(sg, gather, program)
        pairs = None
        if pair_threshold is not None:
            # the tiled path runs on the residual of the pair plan
            pairs, sg = plan_sharded_pairs(sg, pair_threshold,
                                           min_fill=pair_min_fill)
        plan_seconds = time.perf_counter() - t0
        dot = getattr(program, "edge_value_from_dot", None) is not None
        if plan is not None:
            # the paged plan IS the edge layout: no chunk arrays
            arrays, tiles = dict(common_graph_arrays(sg),
                                 **plan_graph_arrays(plan, dot=dot,
                                                     vpad=sg.vpad)), None
        else:
            arrays, lay = build_graph_arrays(sg, layout, tile_e,
                                             needs_dst=uses_dst(program))
            tiles = None if lay is None else lay.geometry
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs, dot=dot,
                                                vpad=sg.vpad))
        arrays.update(program_arrays(program, sg))
        self._bind(program, arrays, tiles, nv=sg.nv, ne=sg.ne,
                   num_parts=sg.num_parts, vpad=sg.vpad, device=dev, sg=sg,
                   pages=plan, pairs=pairs, pair_stream=pair_stream,
                   dot_block_chunks=dot_block_chunks,
                   dot_block_rows=dot_block_rows)
        self.plan_seconds = plan_seconds

    @classmethod
    def from_arrays(cls, program: PullProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    device=None, pages=None, pairs=None, pair_stream=None,
                    dot_block_chunks=None, dot_block_rows=None):
        """An engine on given per-part arrays and their geometry — how
        interop.from_reference carries a reference engine's arrays
        across bit for bit.  Tiled: keys src_slot, rel_dst,
        chunk_start, last_chunk, deg, nvp (+ weight; + chunk_tile for
        programs reading the destination) and ``tiles`` an
        ops/tiled.TileGeometry; with pair rows also pair_rowbind,
        pair_rel, pair_tile_pos (+ pair_weight; + pair_row_tile,
        pair_tile0 for dot programs) and ``pairs`` an
        ops/pairs.PairGeometry.  Paged: keys pg_ids, pg_sl, pg_rel,
        pg_tp (+ pg_w, pg_vrs; + pg_rt, pg_t0 for dot programs), deg,
        nvp, ``tiles=None`` and ``pages`` an
        ops/pagegather.PageGeometry.  A program with ``extra_arrays``
        takes them as keys ``prog_<name>``."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None, pages=pages,
                  pairs=pairs, pair_stream=pair_stream,
                  dot_block_chunks=dot_block_chunks,
                  dot_block_rows=dot_block_rows)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg, pages=None, pairs=None, pair_stream=None,
              dot_block_chunks=None, dot_block_rows=None):
        self.program = program
        self.sg = sg
        self.tiles = tiles
        # the PagedPlan (or, carried from arrays, its PageGeometry)
        self.page_plan = pages
        self.gather = "flat" if pages is None else pages.mode
        # the StackedPairPlan (or its PairGeometry); None without pairs
        if pairs is not None and tiles is None:
            raise ValueError("pair rows need the tiled layout")
        self.pairs = pairs
        self.pair_stream = resolve_pair_stream(pair_stream, pairs)
        self.nv, self.ne = int(nv), int(ne)
        self.num_parts, self.vpad = int(num_parts), int(vpad)
        self.device = device
        dot = getattr(program, "edge_value_from_dot", None) is not None
        # the dot path runs on tiled chunks, pair rows and paged rows;
        # the flat layout calls edge_value with a per-edge dst gather
        self.dot = dot and (tiles is not None or pages is not None)
        # the SDDMM pair rows stream by the reference's 1 GB rule
        self.pair_dot_stream = resolve_pair_dot_stream(
            pair_stream, pairs if dot else None, self.num_parts,
            dot_kdim(program))
        self.dot_block_chunks = None if tiles is None else int(
            dot_block_chunks
            or max(1, DOT_BLOCK_BYTES // (tiles.E * tiles.W * 4)))
        self.dot_block_rows = int(dot_block_rows or DOT_BLOCK_ROWS)
        if pages is not None:
            need = PAGED_KEYS + ("deg", "nvp") + (
                ("pg_vrs",) if pages.mode == "pagemajor" else ())
            wkey = "pg_w"
            if dot:
                need += PAGED_DOT_KEYS
        elif tiles is not None:
            need = TILED_KEYS + (("chunk_tile",) if uses_dst(program)
                                 else ())
            wkey = "weight"
        else:
            need = ("src_slot", "dst_local", "deg", "nvp")
            wkey = "weight"
        if pairs is not None:
            need += PAIR_KEYS + (PAIR_DOT_KEYS + ("pair_weight",) if dot
                                 else ())
        if dot:
            # the reference's dot-program checks (engine/pull.py:279-288)
            if program.reduce != "sum":
                raise ValueError(
                    "edge_value_from_dot requires reduce='sum' (the "
                    "mask-matmul partial reduction is a sum)")
            if wkey not in arrays:
                raise ValueError(
                    "edge_value_from_dot requires a weighted graph "
                    "(the dot path passes per-edge weights)")
        missing = [k for k in need if k not in arrays]
        if missing:
            raise KeyError(f"graph arrays lack {missing}")
        self.batch = getattr(program, "batch", None)
        if self.batch is not None:
            if pairs is not None:
                _check_pair_program("tiled", program)
            if pages is not None:
                check_batched_gather(pages.mode, program, _refuse)
        self.arrays = device_arrays(arrays, device)
        a, P = self.arrays, self.num_parts
        check_dense_arrays(a, P, self.vpad, tiles, pages, pairs)
        for k, v in a.items():
            if k.startswith("prog_") and tuple(v.shape[:2]) != (P,
                                                               self.vpad):
                raise ValueError(f"program array {k[5:]!r} "
                                 f"{tuple(v.shape)} is not [num_parts, "
                                 f"vpad, ...] = [{P}, {self.vpad}, ...]")
        if pages is not None:
            return
        self._src = a["src_slot"].reshape(-1)
        if tiles is not None:
            self._plan = segment_plan(a["chunk_start"], a["last_chunk"])
        else:
            self._seg = flat_segments(a["dst_local"], self.vpad)
        self._dst = None
        if program.needs_dst and not self.dot:
            self._dst = self._dst_slots()

    def _dst_slots(self) -> torch.Tensor:
        """Each edge's destination slot in the flat state table, clipped
        into its part as the reference does (pads point at a real slot;
        the reduce drops them): flat ``dst_local``, tiled ``chunk_tile
        * W + rel_dst``."""
        a, P, vpad = self.arrays, self.num_parts, self.vpad
        if self.tiles is None:
            local = a["dst_local"].to(torch.int64).clamp(max=vpad - 1)
        else:
            local = (a["chunk_tile"].to(torch.int64)[..., None]
                     * self.tiles.W + a["rel_dst"].to(torch.int64)
                     ).clamp(0, vpad - 1)
        base = torch.arange(P, device=local.device) * vpad
        return (local + base.reshape((P,) + (1,) * (local.dim() - 1))
                ).reshape(-1)

    # -- state --------------------------------------------------------

    def init_state(self) -> torch.Tensor:
        if self.sg is None:
            raise ValueError("engine built from arrays has no graph to "
                             "initialise from; pass the state in")
        return torch.as_tensor(self.program.init(self.sg)).to(self.device)

    def place(self, state) -> torch.Tensor:
        """A host state [P, vpad, ...] -> a tensor on the engine's
        device (the serving layer's re-place after a refill)."""
        st = torch.as_tensor(np.asarray(state)).to(self.device)
        if tuple(st.shape[:2]) != (self.num_parts, self.vpad):
            raise ValueError(f"state {tuple(st.shape)} is not [num_parts, "
                             f"vpad, ...] = [{self.num_parts}, "
                             f"{self.vpad}, ...]")
        return st

    def update_program_arrays(self, **host_arrays) -> None:
        """Swap the program's ``extra_arrays`` (key ``<name>`` here is
        graph array ``prog_<name>``) for host replacements of the SAME
        shape and dtype; the next step reads them.  The serving layer's
        refill path: a retired query column's reset vector is replaced
        without rebuilding the engine (lux_tpu/engine/pull.py:499)."""
        new = {}
        for k, v in host_arrays.items():
            key = f"prog_{k}"
            if key not in self.arrays:
                raise KeyError(
                    f"engine has no program array {k!r} "
                    f"(program.extra_arrays supplies "
                    f"{[x[5:] for x in self.arrays if x.startswith('prog_')]})")
            cur = self.arrays[key]
            arr = np.asarray(v)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if tuple(t.shape) != tuple(cur.shape) or t.dtype != cur.dtype:
                raise ValueError(
                    f"program array {k!r} must keep shape "
                    f"{tuple(cur.shape)}/{cur.dtype} (got "
                    f"{arr.shape}/{arr.dtype}) — shapes are fixed; "
                    f"rebuild the engine to change B")
            new[key] = t
        for key, t in new.items():
            self.arrays[key] = t.to(self.device)

    def unpad(self, state: torch.Tensor) -> np.ndarray:
        """Padded device state [P, vpad, ...] -> [nv, ...] user order
        (host)."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no partition "
                             "to unpad with")
        return self.sg.from_padded(state.detach().cpu().numpy())

    # -- one iteration ------------------------------------------------

    def _apply_epilogue(self, old, red):
        vm = vmask_of(self.arrays, self.vpad)
        extra = {k[5:]: v for k, v in self.arrays.items()
                 if k.startswith("prog_")}
        ctx = PartCtx(deg=self.arrays["deg"], vmask=vm, nv=self.nv,
                      ne=self.ne, extra=extra or None)
        new = self.program.apply(old, red, ctx)
        # vector state: the [P, vpad] mask over its trailing dims
        keep = vm.reshape(tuple(vm.shape) + (1,) * (new.dim() - 2))
        return torch.where(keep, new, old)

    def _messages(self, flat_state):
        """Phase 1 (gather): per-edge source (and, for programs reading
        it, destination) gather + message values."""
        shape = tuple(self.arrays["src_slot"].shape) + \
            tuple(flat_state.shape[1:])
        src_vals = gather_rows(flat_state, self._src).view(shape)
        dst_vals = None
        if self._dst is not None:
            dst_vals = gather_rows(flat_state, self._dst).view(shape)
        return self.program.edge_value(src_vals, dst_vals,
                                       self.arrays.get("weight"))

    def _reduce(self, msgs):
        """Phase 2 (reduce): [P, vpad, ...] per-vertex reductions."""
        prog, a, P, vpad = self.program, self.arrays, self.num_parts, \
            self.vpad
        if self.tiles is None:
            trail = tuple(msgs.shape[2:])
            red = segment_reduce(msgs.reshape((-1,) + trail), self._seg,
                                 P * (vpad + 1), prog.reduce)
            return red.view((P, vpad + 1) + trail)[:, :vpad]
        if msgs.dim() > 3 and (self.batch is None or msgs.dim() > 4):
            # query-batched messages [P, C, E, B] take B1's batched
            # form; other vector programs reach the tiled layout through
            # edge_value_from_dot (the dot path)
            _refuse("vector messages of unbatched programs on the tiled "
                    "layout outside the dot path", "A7b")
        return tiled_segment_reduce(msgs, self.tiles, a["chunk_start"],
                                    a["last_chunk"], a["rel_dst"], vpad,
                                    prog.reduce, self._plan,
                                    batch=self.batch)

    def _paged_red(self, flat_state):
        """Paged delivery + reduce for every part -> [P, vpad] (the
        plan serves every edge).  A page-major plan rides the same
        call: ``pg_vrs`` binds each virtual reduce row to its gather
        row."""
        prog, a = self.program, self.arrays
        red = paged_partial(
            self.page_plan, flat_state, a["pg_ids"], a["pg_sl"],
            a["pg_rel"], a.get("pg_w"), a["pg_tp"], prog.reduce,
            lambda vals, w: prog.edge_value(vals, None, w),
            vrow_src=a.get("pg_vrs"))
        return red[:, :self.vpad]

    def _pair_red(self, flat_state):
        """Pair-lane delivery + reduce for every part -> [P, vpad]
        (identity where pairs contribute nothing)."""
        prog, a = self.program, self.arrays
        fn = pair_partial_streamed if self.pair_stream else pair_partial
        return fn(self.pairs, flat_state, a["pair_rowbind"], a["pair_rel"],
                  a.get("pair_weight"), a["pair_tile_pos"], prog.reduce,
                  lambda vals, w: prog.edge_value(vals, None, w))

    # -- the dot path (edge_value_from_dot programs) --------------------

    def dot_chunk_blocks(self, state) -> list:
        """The tiled layout's SDDMM blocks (ops/dot.DotBlock): the
        [P*C] chunks in blocks of ``dot_block_chunks``, each fetching
        its edges' source rows and its chunks' destination tiles from
        ``state`` [P, vpad, K] padded to whole tiles
        (lux_tpu/engine/pull.py:635-697).  Pad chunks (tile n_tiles)
        read the last tile and are never taken by the combine."""
        a, t = self.arrays, self.tiles
        P, vpad, K = state.shape
        pad = t.n_tiles * t.W - vpad
        if pad:
            state_t = torch.cat([state, state.new_zeros((P, pad, K))], 1)
        else:
            state_t = state
        tiles = state_t.reshape(P * t.n_tiles, t.W, K)
        flat = state.reshape(-1, K)
        n = P * t.n_chunks
        src = self._src.view(n, t.E)
        rel = a["rel_dst"].view(n, t.E)
        wgt = a["weight"].view(n, t.E)
        base = torch.arange(P, device=state.device)[:, None] * t.n_tiles
        tix = (base + a["chunk_tile"].to(torch.int64).clamp(
            max=t.n_tiles - 1)).reshape(-1)

        def fetch(sl, m):
            S = torch.index_select(flat, 0, src[sl].reshape(-1))
            return S.view(m, t.E, K), torch.index_select(tiles, 0, tix[sl])

        out = []
        for c0, m in blocks(n, self.dot_block_chunks):
            sl = slice(c0, c0 + m)
            out.append(DotBlock(fetch=lambda sl=sl, m=m: fetch(sl, m),
                                rel=rel[sl], weight=wgt[sl], units=sl))
        return out

    def dot_chunk_partials(self, state):
        """Every chunk's [W, K] partials -> [P*C, W, K]."""
        t = self.tiles
        out = torch.empty((self.num_parts * t.n_chunks, t.W,
                           state.shape[-1]), dtype=state.dtype,
                          device=state.device)
        return run_blocks(self.dot_chunk_blocks(state),
                          self.program.edge_value_from_dot, out)

    def _pair_dot_red(self, flat_state):
        """SDDMM pair delivery for every part -> [P, vpad, K]."""
        a = self.arrays
        args = (self.pairs, flat_state, a["pair_rowbind"], a["pair_rel"],
                a["pair_weight"], a["pair_row_tile"], a["pair_tile_pos"],
                a["pair_tile0"], self.program.edge_value_from_dot)
        if self.pair_dot_stream:
            red = pair_partial_dot_streamed(*args)
        else:
            red = pair_partial_dot(*args, block_rows=self.dot_block_rows)
        return red[:, :self.vpad]

    def _paged_dot_red(self, flat_state):
        """Paged SDDMM delivery for every part -> [P, vpad, K]."""
        a = self.arrays
        red = paged_partial_dot(
            self.page_plan, flat_state, a["pg_ids"], a["pg_sl"],
            a["pg_rel"], a["pg_w"], a["pg_rt"], a["pg_tp"], a["pg_t0"],
            self.program.edge_value_from_dot,
            block_rows=self.dot_block_rows)
        return red[:, :self.vpad]

    def _dot_red(self, state, flat_state):
        """The tiled dot path: chunk partials, their segmented combine,
        plus the pair rows' sums -> [P, vpad, K]."""
        a = self.arrays
        red = combine_partials(self.dot_chunk_partials(state), self.tiles,
                               a["chunk_start"], a["last_chunk"],
                               self.vpad, "sum", self._plan)
        if self.pairs is not None:
            red = red + self._pair_dot_red(flat_state)
        return red

    # -- the step -------------------------------------------------------

    def reduced(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration's delivery and reduce, before the apply
        epilogue: [P, vpad, ...] -> the per-vertex reductions [P, vpad,
        ...] (the reduce identity where no edge arrives)."""
        flat = state.reshape((-1,) + tuple(state.shape[2:]))
        if self.page_plan is not None:
            if self.dot:
                return self._paged_dot_red(flat)
            return self._paged_red(flat)
        if self.dot:
            return self._dot_red(state, flat)
        red = self._reduce(self._messages(flat))
        if self.pairs is not None:
            # the residual's reduction, then the pair rows', as the
            # reference combines them (engine/pull.py:591)
            red = combine_op(self.program.reduce)(red, self._pair_red(flat))
        return red

    def step(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration: [P, vpad, ...] -> [P, vpad, ...]."""
        return self._apply_epilogue(state, self.reduced(state))

    def run(self, state: torch.Tensor, num_iters: int) -> torch.Tensor:
        """``num_iters`` iterations, enqueued on the device's stream
        without host round-trips."""
        for _ in range(num_iters):
            state = self.step(state)
        return state

    def run_until(self, state: torch.Tensor, tol: float,
                  max_iters: int = np.iinfo(np.int32).max):
        """Iterate until the max-abs change of the state is <= tol, or
        max_iters.  Returns (state, iterations, final residual).  A NaN
        residual never reports convergence (``not res <= tol``)."""
        it, res = 0, float("inf")
        while not res <= tol and it < max_iters:
            new = self.step(state)
            res = float((new.float() - state.float()).abs().max())
            state, it = new, it + 1
        return state, it, res
