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
rows) once each; a query-batched state's [rows, 128, B] values are
resolved by ``torch.gather`` and reduced by B1's batched form.

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
run is a Python loop over ``step`` on the device's stream.  With
``health=True`` a run takes the watchdog variant (``run_health``:
lux_tpu_torch/health.py's word folded each iteration on the device,
decoded once at the end).

Observability (lux_tpu/engine/pull.py:964-1110, :1244-1432):
``run_stats`` / ``run_until_stats`` write each iteration's residual and
changed-vertex counts (and their per-part rows) into device buffers of
``stats_cap`` rows at the host-known iteration index, so ``run_stats``
reads nothing to the host until the caller fetches the buffers;
``timed_phases`` runs the step's phases (``exchange``, then ``gather``
and ``reduce``, or ``gather_reduce`` on paged rows, or ``dot_reduce``
on the dot path, then ``apply``) one at a time, fenced, through the
same methods ``step`` calls; and ``step`` names its phases as profiler
ranges (profiling.annotation: entered only while a profiler records).

``use_mxu`` (lux_tpu/engine/pull.py:111-139; default ``"auto"``,
resolved through scalemodel from the program's K x B payload width
and the tiled layout, each side priced by the mechanism it runs) takes the matrix-unit forms of the tiled path's reduce
(ops/tiled.chunk_partials_mxu: kernel S9 for a scalar float32 sum) and
of a sum's segmented combine (the scan as matmuls); pair and paged rows
keep kernel B1, as in the reference.  ``gather="auto"`` resolves flat,
paged or page-major through scalemodel's break-even on the plan's
counted stats (ops/pagegather.resolve_gather).

``exchange="owner"`` (ops/owner.py; lux_tpu/engine/pull.py:738-818)
lays the edges out source-part-major: one iteration gathers each source
part's messages from its own [vpad] shard, reduces them with one launch
of kernel B1 over every part's [C, E] owner chunks (its batched form
over a query axis), combines them per (source part, destination tile)
and folds the contributions across source parts; pair rows still fetch
from the whole table.  With ``gather="paged"`` the owner paged plan
replaces the owner chunks (no ``OwnerLayout`` is built, as in the
reference): each source part's page rows against its own shard, B2
and B1 once each over every part's rows, the fold across source parts
(ops/pagegather.paged_owner_contribs); with ``"pagemajor"`` the
senders' full rows route to their destination parts, which reduce them
(ops/pagegather.pagemajor_owner_deliver: B2 and B1 once each, no
separate exchange).  ``exchange="auto"`` keeps the gather exchange
on the card, where the owner exchange lost at every table measured,
and elsewhere takes the owner exchange, as the reference does, once
the state table passes ``OWNER_AUTO_BYTES``.  ``stream_msgs`` runs the
tiled path's gather and partials in blocks of chunks
(ops/tiled.streamed_chunk_partials); None streams on the card only
what would not fit in its free memory, elsewhere by the reference's
1 GB rule (ops/tiled.stream_by_default).  An owner layout that streams
by the same rule runs the fused streamed combine.

``mesh=`` (lux_tpu/engine/pull.py:206-233, :346, :481, :760-880,
:1235) runs the engine on one rank of a parts mesh
(lux_tpu_torch/parallel/mesh.py): the rank holds its part rows
``[r*P/world, (r+1)*P/world)`` of every array and of the state, and
an iteration adds the collectives of ops/collectives.py.  The gather
exchange all_gathers the state into the whole [P*vpad, ...] table
(the ``exchange`` phase), then the tiled, flat, pair-row and dot
paths reduce the rank's own parts; the owner exchange reduce-scatters
(a sum) or all_to_alls (a min / max) the contributions, and pair rows
all_gather the table only for themselves.  ``run_until``'s residual is
the max across ranks, so every rank stops at the same iteration;
``unpad`` all_gathers the state.  A local-parts build
(``ShardedGraph.build(..., parts=)``) must hold exactly the rank's
rows.  What a mesh does not run yet raises :class:`NotPortedError`
naming ROADMAP A6b-2: query-batched programs, ``health``, the counter
and watchdog variants, ``timed_phases``, duration-budgeted segments,
``audit=`` and the paged / page-major deliveries.
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
                                          paged_owner_contribs,
                                          paged_partial_dot,
                                          pagemajor_owner_deliver,
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
from lux_tpu_torch.ops.owner import (OwnerLayout, owner_contribs,
                                     owner_exchange, owner_graph_arrays)
from lux_tpu_torch.ops.collectives import all_gather_parts, all_reduce_scalar
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (TiledLayout, combine_op,
                                     combine_partials,
                                     engine_lane_occupancy, segment_plan,
                                     stream_by_default,
                                     streamed_tiled_reduce,
                                     tiled_segment_reduce)
from lux_tpu_torch.parallel.mesh import (check_divisible, local_part_rows,
                                         mesh_device, rows_of,
                                         shard_over_parts)
from lux_tpu_torch.profiling import annotation, device_fence
from lux_tpu_torch.scalemodel import ReduceLayout
from lux_tpu_torch.telemetry import DEFAULT_STATS_CAP

# exchange="auto" picks the owner exchange off the card once the flat
# state table passes this many bytes: the reference's figure
# (lux_tpu/engine/pull.py:76-80).  On the card "auto" keeps the gather
# exchange, since the owner exchange won at no table the card's sweep
# measured.  NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py's
# owner_sweep line: the PageRank step took 2.08-2.15x the gather
# exchange's at 8 MB (R-MAT 21, 1 and 4 parts) and at 32 MB (R-MAT 23,
# 4 parts, 8 MB shards under the gather's 16 MB step while the whole
# table is past it); no table past 96 MB was measured (PERF.md, §6)
OWNER_AUTO_BYTES = 96 << 20

TILED_KEYS = ("src_slot", "rel_dst", "chunk_start", "last_chunk", "deg",
              "nvp")
# an owner engine's keys beside its slots (own_sr + own_nv packed, or
# own_src + own_rel)
OWNER_KEYS = ("own_cs", "own_lc", "deg", "nvp")


def dot_kdim(program) -> int:
    """K of a dot program's vector state, from ``state_bytes`` = 4 * K
    (the reference's ``_dot_kdim``, lux_tpu/engine/pull.py:51-60); 1
    for other programs.  It feeds the streamed pair-dot rule."""
    if getattr(program, "edge_value_from_dot", None) is None:
        return 1
    return max(1, (getattr(program, "state_bytes", None) or 4) // 4)


def mxu_wide_of(program) -> int:
    """K x B payload width of a program's state: the free minor
    dimension the one-hot reduce amortizes its toll over
    (lux_tpu/engine/pull.py:111).  ``state_bytes`` covers the whole
    trailing row (colfilter's 4 K, batched pagerank's 4 B)."""
    sb = getattr(program, "state_bytes", None)
    if sb is not None:
        return max(1, sb // 4)
    return int(getattr(program, "batch", None) or 1)


def resolve_use_mxu(use_mxu, program, constants=None, *, layout=None,
                    scalar_f32: bool = False) -> bool:
    """``use_mxu="auto"`` engages the matrix-unit forms where
    scalemodel.resolve_use_mxu (under ``constants``) prices them cheaper
    for the program's reduce kind and K x B width, on the engine's tiled
    ``layout`` (a scalemodel.ReduceLayout) with S9 serving a
    ``scalar_f32`` sum; True / False force either path
    (lux_tpu/engine/pull.py:125)."""
    if isinstance(use_mxu, bool):
        return use_mxu
    if use_mxu != "auto":
        raise ValueError(f"unknown use_mxu {use_mxu!r}")
    from lux_tpu_torch import scalemodel
    kind = getattr(program, "reduce", "sum")
    dot = getattr(program, "edge_value_from_dot", None) is not None
    return scalemodel.resolve_use_mxu(kind, mxu_wide_of(program),
                                      constants=constants,
                                      scalar_f32=scalar_f32, dot=dot,
                                      layout=layout)


def scalar_f32_sum(program, sg) -> bool:
    """Whether the program reduces scalar float32 sums, the one reduce
    kernel S9 serves under ``use_mxu``: read from its initial state's
    dtype (an engine built from arrays has no graph: False)."""
    if sg is None or getattr(program, "reduce", "sum") != "sum" \
            or mxu_wide_of(program) != 1 \
            or getattr(program, "edge_value_from_dot", None) is not None:
        return False
    return np.asarray(program.init(sg)).dtype == np.float32


def uses_dst(program) -> bool:
    """Whether the program reads destination state at all (per edge, or
    only through <src, dst>)."""
    return bool(program.needs_dst
                or getattr(program, "edge_value_from_dot", None)
                is not None)


class NotPortedError(NotImplementedError):
    """An option of the reference engine that the port does not carry
    yet; the message names the ROADMAP item that brings it."""


def refuse_on_mesh(what: str):
    """The options a mesh does not run yet (ROADMAP A6b-2)."""
    raise NotPortedError(f"{what} on a device mesh is not ported yet "
                         f"(ROADMAP A6b-2); a mesh runs the tiled, flat, "
                         f"pair-row and dot paths on the gather or owner "
                         f"exchange, unbatched, without health, counters, "
                         f"phase timing or the auditor")


def check_mesh_build(sg, mesh, *, batch=None, health=False, audit=None,
                     gather="flat", page_plan=None) -> None:
    """A mesh engine's build rules: the reference's divisibility and
    local-parts checks (lux_tpu/engine/pull.py:226, :1434), then the
    options left for ROADMAP A6b-2."""
    if mesh is None:
        check_local_parts(sg, mesh)
        return
    check_divisible(sg.num_parts, mesh)
    check_local_parts(sg, mesh)
    if batch is not None:
        refuse_on_mesh("a query-batched program (batch=B)")
    if health:
        refuse_on_mesh("the health watchdog (health=True)")
    if audit is not None:
        refuse_on_mesh("the build-time auditor (audit=)")
    if gather not in ("flat", "auto") or page_plan is not None:
        refuse_on_mesh(f"gather={gather!r} (the paged deliveries)")


def check_local_parts(sg, mesh) -> None:
    """A local-parts build (``sg.local_parts``) needs a mesh and must
    hold exactly this rank's rows (lux_tpu/engine/pull.py:1434)."""
    local = getattr(sg, "local_parts", None)
    if local is None:
        return
    if mesh is None:
        raise ValueError(
            "a ShardedGraph built with parts= (multi-host local rows) "
            "requires a mesh")
    expect = list(local_part_rows(mesh, sg.num_parts))
    got = [int(p) for p in np.asarray(local)]
    if got != expect:
        raise ValueError(
            f"local_parts {got} != this process's sharding rows "
            f"{expect}; build with parts=multihost.process_parts(P)")


def bind_mesh(eng, mesh, num_parts: int) -> None:
    """An engine's place in the mesh: ``mesh`` (None: one device),
    ``ndev`` its world, and the rank's part rows (``part0`` on, ``lp``
    of them; every part without a mesh)."""
    eng.mesh = mesh
    rows = (range(num_parts) if mesh is None
            else local_part_rows(mesh, num_parts))
    eng.part0, eng.lp = rows.start, len(rows)
    eng.ndev = 1 if mesh is None else mesh.world


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
                     itemsize: int | None = None, device=None) -> str:
    """'auto' on a card ``device`` resolves to 'gather' (see
    OWNER_AUTO_BYTES).  Elsewhere it resolves as the reference does
    (lux_tpu/engine/pull.py:83): 'owner' when the program's messages
    depend on the source state only (no ``needs_dst``, no dot program)
    and the state table passes OWNER_AUTO_BYTES, else 'gather'.
    ``itemsize``: bytes a vertex of the state (default the program's
    ``state_bytes``, else its identity's itemsize, else 4)."""
    if exchange == "auto":
        if device is not None and torch.device(device).type == "cuda":
            return "gather"
        if itemsize is None:
            itemsize = getattr(program, "state_bytes", None)
        if itemsize is None:
            ident = getattr(program, "identity", None)
            itemsize = (np.asarray(ident).dtype.itemsize
                        if ident is not None else 4)
        big = sg.num_parts * sg.vpad * itemsize > OWNER_AUTO_BYTES
        return "owner" if big and not uses_dst(program) else "gather"
    if exchange not in ("gather", "owner"):
        raise ValueError(f"unknown exchange {exchange!r}")
    return exchange


def check_owner_program(program) -> None:
    """The owner exchange's program rule (lux_tpu/engine/pull.py:255):
    owner-side parts hold no destination state."""
    if uses_dst(program):
        raise ValueError(
            "exchange='owner' supports programs whose edge_value depends "
            "only on the source state (owner-side parts hold no "
            "destination state)")


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
    lay = TiledLayout.build(
        sg.row_ptr_local, sg.dst_local, sg.vpad, E=tile_e,
        sizing_row_ptr=(None if getattr(sg, "local_parts", None) is None
                        else sg.sizing_row_ptr()))
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
    slot_lane, the packed owner slots) ride as int32 and uint16 arrays
    (the owner's live-lane counts) as int16, with the same bits: torch's
    unsigned types have thin CUDA coverage."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        elif v.dtype == np.uint16:
            v = v.view(np.int16)
        out[k] = torch.tensor(v, device=device)
    return out


def padded_view(table: torch.Tensor) -> torch.Tensor:
    """A copy of a [N, B] table as a view with one element of row
    padding (row stride B + 1): the same values, rows that are no
    longer a multiple of 16 bytes apart."""
    padded = table.new_empty((table.shape[0], table.shape[1] + 1))
    padded[:, :-1] = table
    return padded[:, :-1]


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``table[idx]`` for a [N] or [N, B] state table: the engines' one
    state gather an edge.  On the card, torch's ``index_select`` of
    rows whose bytes are a multiple of 16 takes a vectorized kernel
    that costs about 0.6 ns a row whatever the row's width (11.34 ms
    for the 18.9M rows of R-MAT 20 at B = 4, 8 or 16, against 0.13-0.15
    ms at B = 1 or 2; NVIDIA H100 80GB HBM3, 700.00 W, torch 2.11).  The
    same rows read through ``padded_view`` take its generic kernel:
    0.31 / 0.57 / 1.00 ms at B = 4 / 8 / 16, the same bits (``chip_smoke.py``'s ppr_batch
    ``gather_by_width``; PERF.md §5).  Other tables, and every table
    on the CPU, go to ``index_select`` as they are.  ``out``: a
    contiguous buffer of the result's shape to write into."""
    if (table.device.type == "cuda" and table.dim() == 2
            and table.shape[1] * table.element_size() % 16 == 0):
        table = padded_view(table)
    if out is not None:
        return torch.index_select(table, 0, idx, out=out)
    return torch.index_select(table, 0, idx)


def check_dense_arrays(a: dict, P: int, vpad: int, tiles, pages,
                       pairs, num_parts: int | None = None,
                       part0: int = 0) -> None:
    """Shapes and index ranges of a dense engine's arrays on the
    device (tiled, flat or paged, with or without pair rows), checked
    once: an out-of-range index would fault on the card.  ``P`` rows of
    the ``num_parts`` (default P) parts, from part ``part0`` on: a
    mesh rank's (its sources index the whole table)."""
    Pg = P if num_parts is None else int(num_parts)
    if a["deg"].shape != (P, vpad) or a["nvp"].shape != (P, 1):
        raise ValueError(f"deg {tuple(a['deg'].shape)} / nvp "
                         f"{tuple(a['nvp'].shape)} do not match "
                         f"num_parts={P} vpad={vpad}")
    if pages is not None:
        check_paged_arrays(a, P, vpad, pages)
        return
    src = a["src_slot"]
    if _outside(src, Pg * vpad):
        raise ValueError(f"src_slot outside the [0, {Pg * vpad}) state "
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
            check_pair_arrays(a, P, vpad, pairs, Pg, part0)


def check_owner_arrays(a: dict, P: int, vpad: int, geom,
                       num_parts: int | None = None) -> None:
    """Shapes, dtypes and index ranges of an engine's owner arrays (on
    the device), checked once: an out-of-range index would fault on the
    card.  ``P`` source rows of ``num_parts`` (default P) parts."""
    Pg = P if num_parts is None else int(num_parts)
    C, E = geom.n_chunks, geom.E
    packed = "own_sr" in a
    missing = [k for k in OWNER_KEYS + (("own_sr", "own_nv") if packed
                                        else ("own_src", "own_rel"))
               if k not in a]
    if missing:
        raise KeyError(f"graph arrays lack {missing}")
    slots = a["own_sr"] if packed else a["own_src"]
    ep = a.get("own_ep")
    ok = (geom.W == W and geom.n_tiles * geom.W >= vpad
          and geom.G == Pg * geom.n_tiles
          and tuple(slots.shape) == (P, C, E)
          and slots.dtype == torch.int32
          and tuple(a["own_cs"].shape) == (P, C)
          and a["own_cs"].dtype == torch.bool
          and tuple(a["own_lc"].shape) == (P, geom.G)
          and (a.get("own_w") is None
               or tuple(a["own_w"].shape) == (P, C, E))
          and (ep is None or (ep.dim() == 3 and ep.shape[0] == P
                              and tuple(a["own_et"].shape)
                              == tuple(ep.shape))))
    if packed:
        ok = ok and (tuple(a["own_nv"].shape) == (P, C)
                     and a["own_nv"].dtype == torch.int16)
    else:
        ok = ok and (tuple(a["own_rel"].shape) == (P, C, E)
                     and a["own_rel"].dtype == torch.int8)
    if not ok:
        raise ValueError(f"owner arrays do not match the layout geometry "
                         f"{geom} (num_parts={P}, vpad={vpad})")
    if packed:
        src = torch.bitwise_right_shift(slots, 7) & 0x1FFFFFF
        nv = a["own_nv"].to(torch.int32) & 0xFFFF
        bad = _outside(nv, E + 1)
    else:
        src, bad = slots, False
    if (bad or _outside(src, vpad) or _outside(a["own_lc"] + 1, C + 1)
            or (ep is not None and (_outside(a["own_et"], geom.G + 1)
                                    or _outside(ep, C)))):
        raise ValueError("owner arrays index outside a part's shard, "
                         "its chunks or the global tiles")


def flat_segments(dst_local: torch.Tensor, vpad: int) -> torch.Tensor:
    """The flat oracle's segment ids: one segment space for all parts,
    with each part's trash row vpad kept apart."""
    P = dst_local.shape[0]
    base = torch.arange(P, device=dst_local.device)[:, None] * (vpad + 1)
    return (dst_local.to(torch.int64) + base).reshape(-1)


def check_paged_arrays(a: dict, P: int, vpad: int, pp) -> None:
    """Shapes and index ranges of an engine's paged arrays ``a`` (on
    the device), checked once: an out-of-range index would fault on
    the card.  A dense plan's ``pg_*`` keys, the owner paged plan's
    ``own_pg_*`` (pages in a part's own shard, global destination
    tiles) or the owner page-major plan's ``own_pm_*`` (sender rows and
    weights [P, P*Mg, 128], ``own_pm_vrs`` into the routed rows)."""
    owner, pm = getattr(pp, "owner", False), pp.mode == "pagemajor"
    if owner:
        pre = "own_pm_" if pm else "own_pg_"
        keys = tuple(pre + k for k in (("ids", "gsl", "rel", "tp") if pm
                                       else ("ids", "sl", "rel", "tp")))
    else:
        pre, keys = "pg_", PAGED_KEYS
    missing = [k for k in keys if k not in a]
    if missing:
        raise KeyError(f"graph arrays lack {missing}")
    ids, sl, rel, tp = (a[k] for k in keys)
    Rg = sl.shape[1] if sl.dim() == 3 else -1
    vrs = a.get(pre + "vrs")
    w = a.get(pre + "w")
    ntp = vpad // W
    # tiles a plan row reduces into, pages a page id indexes, rows a
    # weight row follows
    n_tiles = P * ntp if owner and not pm else ntp
    n_pages = ntp if owner else P * ntp
    w_rows = Rg if owner and pm else pp.Rp
    ok = (vpad % W == 0 and ids.dim() == 2 and ids.shape[0] == P
          and tuple(sl.shape) == (P, Rg, W) and sl.dtype == torch.int32
          and tuple(rel.shape) == (P, pp.Rp, W)
          and rel.dtype == torch.int8
          and tuple(tp.shape) == (P, pp.n_tiles) and pp.n_tiles == n_tiles
          and sum(c * L for c, L in pp.classes) == pp.R <= pp.Rp
          and (w is None or tuple(w.shape) == (P, w_rows, W))
          and (tuple(vrs.shape) == (P, pp.Rp) if vrs is not None
               else Rg == pp.Rp and not pm))
    if not ok:
        raise ValueError(
            f"paged arrays do not match the plan geometry {pp} "
            f"(num_parts={P}, vpad={vpad})")
    if (_outside(ids, n_pages)
            or _outside(row_slots(sl), ids.shape[1])
            or _outside(tp, pp.n_slots + 1)
            or (vrs is not None and _outside(vrs, Rg))):
        raise ValueError("paged arrays index outside the state table or "
                         "a part's shard, the page list, the class slots "
                         "or the gather rows")
    if "pg_rt" in a:
        check_dot_tiles(a["pg_rt"], a["pg_t0"], P, vpad, pp, "pg")


def check_dot_tiles(row_tile, tile0, P: int, vpad: int, geom,
                    what: str, part0: int = 0) -> None:
    """A dot engine's destination-tile arrays: ``row_tile`` [P, Rp] in
    [0, n_tiles) and ``tile0`` [P, 1] = each part's first state tile
    (parts ``part0`` on)."""
    want = (part0 + torch.arange(P, device=tile0.device)[:, None]) * (
        vpad // W)
    if (tuple(row_tile.shape) != (P, geom.Rp)
            or _outside(row_tile, geom.n_tiles)
            or tuple(tile0.shape) != (P, 1)
            or not torch.equal(tile0.to(torch.int64), want)):
        raise ValueError(f"{what} dot arrays: row tiles must be [P, Rp] "
                         f"in [0, {geom.n_tiles}) and tile 0 [P, 1] = "
                         f"p * vpad / {W}")


def check_pair_arrays(a: dict, P: int, vpad: int, sp,
                      num_parts: int | None = None, part0: int = 0) -> None:
    """Shapes and index ranges of an engine's pair arrays ``a`` (on the
    device), checked once: an out-of-range rowbind or tile_pos would
    fault on the card.  ``P`` rows of ``num_parts`` (default P) parts,
    from part ``part0`` on."""
    Pg = P if num_parts is None else int(num_parts)
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
    if _outside(rb, Pg * vpad // W) or _outside(tp, sp.n_slots + 1):
        raise ValueError("pair arrays index outside the state table "
                         "or the class slots")
    if "pair_row_tile" in a:
        check_dot_tiles(a["pair_row_tile"], a["pair_tile0"], P, vpad, sp,
                        "pair", part0)


class Placement:
    """The surface both engines share (lux_tpu/engine/auditable.py):

    - placement, which checkpoints and the supervisor reason through:
      ``ndev`` and ``placement_meta()``.  A resume must match num_parts
      / vpad / exchange ("gather" or "owner"); ``ndev`` is the mesh's
      world (1 without a mesh);
    - the registry of program variants the auditor (lux_tpu_torch/
      audit.py) runs: name -> (callable, example-args thunk).  Each
      callable runs ONE iteration of its variant on the thunk's
      arguments, a fresh init state; the registry is filled at first use
      (``_register_engine_variants``), and a live graph adds its
      delta-relax step (LiveGraph.register_audit)."""

    ndev = 1
    mesh = None
    exchange = "gather"

    def placement_meta(self) -> dict:
        return {"ndev": self.ndev, "num_parts": self.num_parts,
                "vpad": self.vpad, "exchange": self.exchange}

    def _variants(self) -> dict:
        reg = self.__dict__.get("_audit_variants")
        if reg is None:
            reg = self._audit_variants = {}
            self._register_engine_variants()
        return reg

    def _register_engine_variants(self) -> None:
        """Each engine registers its variants here."""

    def _register_variant(self, name: str, fn, args_thunk) -> None:
        """Expose one program variant to the auditor: ``fn(*args_thunk())``
        runs one iteration of it."""
        self._variants()[name] = (fn, args_thunk)

    def audit_programs(self) -> dict:
        """name -> (callable, example-args thunk) for every program
        variant this engine can run."""
        return dict(self._variants())

    def audit_variant(self, name: str):
        """One registered variant."""
        try:
            return self._variants()[name]
        except KeyError:
            raise KeyError(f"no registered program variant {name!r} "
                           f"(have {sorted(self._variants())})") from None

    def _run_audit(self, audit) -> None:
        """The engines' build-time ``audit=`` (None skips it; the mode is
        validated by audit_engine: an unknown one is a ValueError)."""
        if audit is not None:
            from lux_tpu_torch import audit as _audit
            _audit.audit_engine(self, mode=audit)


class PullEngine(Placement):
    """Pull-model iterations for one ShardedGraph + program on one
    device (``device=None`` means the card; pass ``"cpu"`` for the
    plain PyTorch versions)."""

    plan_seconds = 0.0      # host seconds spent building the paged or
                            # pair plan
    health = False          # run the watchdog variants (health.py)
    stats_cap = DEFAULT_STATS_CAP   # rows of the counter buffers

    def __init__(self, sg: ShardedGraph, program: PullProgram, *,
                 device=None, layout: str = "tiled", tile_e: int = 512,
                 exchange: str = "auto", gather: str = "flat",
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 stream_msgs: bool | None = None, mesh=None,
                 dot_block_chunks: int | None = None,
                 dot_block_rows: int | None = None,
                 health: bool = False, stats_cap: int | None = None,
                 use_mxu: bool | str = "auto",
                 owner_tile_e: int | None = None,
                 owner_minmax_fused: bool = False,
                 page_plan=None, audit: str | None = None):
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
        them beyond the order of float sums.
        ``health=True``: ``run`` and the segmented drivers take the
        watchdog variants (``run_health`` / ``run_until_health``,
        lux_tpu_torch/health.py).  ``stats_cap``: rows of the
        per-iteration counter buffers (default
        telemetry.DEFAULT_STATS_CAP); writes past it drop.
        ``use_mxu``: the one-hot forms of the tiled reduce (True / False,
        or "auto" through scalemodel); ``gather="auto"`` picks the
        delivery by scalemodel's break-even on the plan's stats.
        ``exchange``: "gather", "owner" (ops/owner.py; its chunk width
        ``owner_tile_e``, default 256; ``owner_minmax_fused`` is taken
        and, on one device, changes nothing, as in the reference) or
        "auto" (``resolve_exchange``).  ``page_plan``: a paged or
        page-major plan built before on ``sg`` for this ``gather`` and
        ``exchange`` (ops/pagegather.engine_page_plan), which engines on
        one layout share; checked, not rebuilt.  ``stream_msgs``: the
        tiled path's gather and partials in blocks of chunks (None: by
        ops/tiled.stream_by_default on the [P, epad] messages; an
        owner layout by ``OwnerLayout.streams``).  ``audit="warn"|
        "error"`` runs one iteration of every program variant under the
        auditor at build time (lux_tpu_torch/audit.py).  ``mesh``: run as
        this rank of a parts mesh (lux_tpu_torch/parallel/mesh.py) on
        the mesh's device; ``sg`` holds every part or exactly the
        rank's (a local-parts build)."""
        dev = (resolve_device(device) if mesh is None
               else mesh_device(mesh, device))
        check_mesh_build(sg, mesh, batch=getattr(program, "batch", None),
                         health=health, audit=audit, gather=gather,
                         page_plan=page_plan)
        if gather in ("paged", "pagemajor") and pair_threshold is not None:
            raise ValueError(
                f"gather={gather!r} subsumes pair delivery (both are "
                f"row-granular layouts); build without pair_threshold")
        if pair_threshold is not None:
            _check_pair_program(layout, program)
        exchange = resolve_exchange(exchange, sg, program, device=dev)
        if exchange == "owner":
            check_owner_program(program)
        t0 = time.perf_counter()
        plan = engine_page_plan(sg, gather, program, exchange, page_plan)
        if plan is not None and mesh is not None:
            refuse_on_mesh(f"gather={plan.mode!r} (the paged deliveries)")
        pairs = None
        if pair_threshold is not None:
            # the tiled (or owner) path runs on the pair plan's residual
            pairs, sg = plan_sharded_pairs(sg, pair_threshold,
                                           min_fill=pair_min_fill,
                                           kdim=dot_kdim(program),
                                           mesh=mesh)
        plan_seconds = time.perf_counter() - t0
        dot = getattr(program, "edge_value_from_dot", None) is not None
        local = getattr(sg, "local_parts", None)
        owner = None
        if plan is None and exchange == "owner":
            owner = OwnerLayout.build(sg, E=owner_tile_e or 256, mesh=mesh)
            arrays = dict(common_graph_arrays(sg), **owner_graph_arrays(
                owner, owner.streams(dev, mxu_wide_of(program))))
            tiles = None
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs, vpad=sg.vpad))
        elif plan is not None:
            # the paged plan IS the edge layout: no chunk arrays, and
            # under the owner exchange no OwnerLayout
            arrays, tiles = dict(common_graph_arrays(sg),
                                 **plan_graph_arrays(plan, dot=dot,
                                                     vpad=sg.vpad)), None
        else:
            arrays, lay = build_graph_arrays(sg, layout, tile_e,
                                             needs_dst=uses_dst(program))
            tiles = None if lay is None else lay.geometry
            if pairs is not None:
                arrays.update(pair_graph_arrays(
                    pairs, dot=dot, vpad=sg.vpad,
                    parts=None if local is None else sg.part_ids()))
        arrays.update(program_arrays(program, sg))
        # a mesh rank keeps its own part rows
        arrays = {k: rows_of(mesh, v, sg.num_parts)
                  for k, v in arrays.items()}
        rows = sg.num_parts if mesh is None else sg.num_parts // mesh.world
        if stream_msgs is None:
            wide = mxu_wide_of(program) if dev.type == "cuda" else 1
            stream_msgs = stream_by_default(rows * sg.epad * 4 * wide, dev)
        self._bind(program, arrays, tiles, nv=sg.nv, ne=sg.ne,
                   num_parts=sg.num_parts, vpad=sg.vpad, device=dev, sg=sg,
                   pages=plan, pairs=pairs, pair_stream=pair_stream,
                   dot_block_chunks=dot_block_chunks,
                   dot_block_rows=dot_block_rows, use_mxu=use_mxu,
                   owner=owner, stream_msgs=stream_msgs,
                   owner_minmax_fused=owner_minmax_fused, mesh=mesh)
        self.plan_seconds = plan_seconds
        self.health = bool(health)
        if stats_cap is not None:
            if int(stats_cap) < 1:
                raise ValueError(f"stats_cap must be >= 1, got {stats_cap}")
            self.stats_cap = int(stats_cap)
        self._run_audit(audit)

    @classmethod
    def from_arrays(cls, program: PullProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    device=None, pages=None, pairs=None, pair_stream=None,
                    dot_block_chunks=None, dot_block_rows=None,
                    use_mxu=False, owner=None, stream_msgs=False,
                    owner_minmax_fused=False):
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
        ops/pagegather.PageGeometry.  Owner exchange: keys own_sr,
        own_nv (packed) or own_src, own_rel, and own_cs, own_lc (+
        own_w; + own_ep, own_et for the fused streamed combine), deg,
        nvp, ``tiles=None`` and ``owner`` an ops/owner.OwnerGeometry;
        pair rows ride beside them as on the tiled layout.  A program
        with ``extra_arrays`` takes them as keys ``prog_<name>``."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None, pages=pages,
                  pairs=pairs, pair_stream=pair_stream,
                  dot_block_chunks=dot_block_chunks,
                  dot_block_rows=dot_block_rows, use_mxu=use_mxu,
                  owner=owner, stream_msgs=stream_msgs,
                  owner_minmax_fused=owner_minmax_fused)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg, pages=None, pairs=None, pair_stream=None,
              dot_block_chunks=None, dot_block_rows=None, use_mxu=False,
              owner=None, stream_msgs=False, owner_minmax_fused=False,
              mesh=None):
        self.program = program
        bind_mesh(self, mesh, num_parts)
        self.sg = sg
        self.tiles = tiles
        # the OwnerLayout (or, carried from arrays, its OwnerGeometry)
        self.owner = owner
        owner_pages = pages is not None and getattr(pages, "owner", False)
        self.exchange = "owner" if owner is not None or owner_pages \
            else "gather"
        if self.exchange == "owner":
            check_owner_program(program)
        if owner is not None and (tiles is not None or pages is not None):
            raise ValueError("the owner layout replaces the tiled and "
                             "paged layouts")
        if owner_pages and (tiles is not None or pairs is not None):
            raise ValueError("the owner paged plan replaces the tiled "
                             "layout and pair rows")
        self.owner_minmax_fused = bool(owner_minmax_fused)
        # the PagedPlan (or, carried from arrays, its PageGeometry)
        self.page_plan = pages
        self.gather = "flat" if pages is None else pages.mode
        # the StackedPairPlan (or its PairGeometry); None without pairs
        if pairs is not None and tiles is None and owner is None:
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
        if owner_pages:
            need = ("deg", "nvp")           # check_paged_arrays's
            wkey = "own_pm_w" if pages.mode == "pagemajor" else "own_pg_w"
        elif pages is not None:
            need = PAGED_KEYS + ("deg", "nvp") + (
                ("pg_vrs",) if pages.mode == "pagemajor" else ())
            wkey = "pg_w"
            if dot:
                need += PAGED_DOT_KEYS
        elif owner is not None:
            need = ()                       # check_owner_arrays's
            wkey = "own_w"
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
        self.arrays = device_arrays(arrays, device)
        a, P, Pg = self.arrays, self.lp, self.num_parts
        if owner is not None:
            check_owner_arrays(a, P, self.vpad, owner, Pg)
            if pairs is not None:
                check_pair_arrays(a, P, self.vpad, pairs, Pg, self.part0)
        else:
            check_dense_arrays(a, P, self.vpad, tiles, pages, pairs, Pg,
                               self.part0)
        for k, v in a.items():
            if k.startswith("prog_") and tuple(v.shape[:2]) != (P,
                                                               self.vpad):
                raise ValueError(f"program array {k[5:]!r} "
                                 f"{tuple(v.shape)} is not [num_parts, "
                                 f"vpad, ...] = [{P}, {self.vpad}, ...]")
        layout = None
        chunks = tiles if owner is None else owner
        if chunks is not None:
            self._plan = segment_plan(
                *((a["chunk_start"], a["last_chunk"]) if owner is None
                  else (a["own_cs"], a["own_lc"])))
            layout = ReduceLayout(P * chunks.n_chunks, chunks.E, chunks.W,
                                  self._plan.max_len)
        self.scalar_f32_sum = scalar_f32_sum(program, sg)
        self.use_mxu = resolve_use_mxu(use_mxu, program, layout=layout,
                                       scalar_f32=self.scalar_f32_sum)
        # the tournament's occupied slots, fixed by the layout
        self._occ = engine_lane_occupancy(self)
        # the tiled path's gather and partials in blocks of chunks
        self.stream_chunks = bool(stream_msgs)
        if pages is not None or owner is not None:
            return
        self._src = a["src_slot"].reshape(-1)
        self._rel32 = None
        if tiles is not None:
            if self.use_mxu and not self.dot and program.reduce == "sum":
                # kernel S9 takes int32 lanes
                self._rel32 = a["rel_dst"].to(torch.int32)
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
        a, P, vpad = self.arrays, self.lp, self.vpad
        if self.tiles is None:
            local = a["dst_local"].to(torch.int64).clamp(max=vpad - 1)
        else:
            local = (a["chunk_tile"].to(torch.int64)[..., None]
                     * self.tiles.W + a["rel_dst"].to(torch.int64)
                     ).clamp(0, vpad - 1)
        base = (self.part0 + torch.arange(P, device=local.device)) * vpad
        return (local + base.reshape((P,) + (1,) * (local.dim() - 1))
                ).reshape(-1)

    def _register_engine_variants(self) -> None:
        """One iteration of each program variant the reference compiles
        (lux_tpu/engine/pull.py:1143-1320), from the init state."""
        def st():
            return (self.init_state(),)
        reg = self._register_variant
        reg("step", self.step, st)
        reg("run", lambda s: self.run(s, 1), st)
        reg("run_stats", lambda s: self.run_stats(s, 1), st)
        reg("run_until_stats", lambda s: self.run_until_stats(s, 0.0, 1), st)
        reg("run_health", lambda s: self.run_health(s, 1), st)
        reg("run_until_health",
            lambda s: self.run_until_health(s, 0.0, 1), st)
        reg("run_until", lambda s: self.run_until(s, 0.0, 1), st)

    # -- state --------------------------------------------------------

    def init_state(self) -> torch.Tensor:
        if self.sg is None:
            raise ValueError("engine built from arrays has no graph to "
                             "initialise from; pass the state in")
        st = self.program.init(self.sg)
        if self.mesh is not None:
            return shard_over_parts(self.mesh, np.asarray(st),
                                    self.num_parts)
        return torch.as_tensor(st).to(self.device)

    def place(self, state) -> torch.Tensor:
        """A host state [P, vpad, ...] -> a tensor on the engine's
        device (the serving layer's re-place after a refill); on a mesh,
        this rank's rows of it, so a state saved on one world resumes
        on any other that divides P (lux_tpu/engine/pull.py:481)."""
        st = rows_of(self.mesh, np.asarray(state), self.num_parts)
        st = torch.as_tensor(np.ascontiguousarray(st)).to(self.device)
        if tuple(st.shape[:2]) != (self.lp, self.vpad):
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
        from lux_tpu_torch.parallel.multihost import fetch_global
        return self.sg.from_padded(fetch_global(state, self.mesh,
                                                self.num_parts))

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
        prog, a, P, vpad = self.program, self.arrays, self.lp, self.vpad
        if self.tiles is None:
            trail = tuple(msgs.shape[2:])
            red = segment_reduce(msgs.reshape((-1,) + trail), self._seg,
                                 P * (vpad + 1), prog.reduce)
            return red.view((P, vpad + 1) + trail)[:, :vpad]
        # vector messages [P, C, E, *trail] (a query axis, or the
        # vector state of an unbatched program outside the dot path)
        # take B1's batched form over the flattened trailing dims
        trail = tuple(msgs.shape[3:])
        red = tiled_segment_reduce(msgs, self.tiles, a["chunk_start"],
                                   a["last_chunk"], a["rel_dst"], vpad,
                                   prog.reduce, self._plan,
                                   batch=int(np.prod(trail)) if trail
                                   else None, use_mxu=self.use_mxu,
                                   rel32=self._rel32, occ=self._occ)
        return red.reshape((P, vpad) + trail)

    def _paged_red(self, flat_state, upto: str | None = None):
        """Paged delivery + reduce for every part -> [P, vpad] (the
        plan serves every edge).  A page-major plan rides the same
        call: ``pg_vrs`` binds each virtual reduce row to its gather
        row.  ``upto`` (profiling, vector states) returns what
        ``paged_partial`` returns after that stage."""
        prog, a = self.program, self.arrays
        red = paged_partial(
            self.page_plan, flat_state, a["pg_ids"], a["pg_sl"],
            a["pg_rel"], a.get("pg_w"), a["pg_tp"], prog.reduce,
            lambda vals, w: prog.edge_value(vals, None, w),
            vrow_src=a.get("pg_vrs"), upto=upto)
        return red[:, :self.vpad] if upto is None else red

    def _pair_red(self, flat_state):
        """Pair-lane delivery + reduce for every part -> [P, vpad]
        (identity where pairs contribute nothing)."""
        prog, a = self.program, self.arrays
        fn = pair_partial_streamed if self.pair_stream else pair_partial
        return fn(self.pairs, flat_state, a["pair_rowbind"], a["pair_rel"],
                  a.get("pair_weight"), a["pair_tile_pos"], prog.reduce,
                  lambda vals, w: prog.edge_value(vals, None, w))

    # -- the dot path (edge_value_from_dot programs) --------------------

    def dot_chunk_blocks(self, state, flat=None) -> list:
        """The tiled layout's SDDMM blocks (ops/dot.DotBlock): the
        [P*C] chunks in blocks of ``dot_block_chunks``, each fetching
        its edges' source rows from the whole table ``flat`` [P*vpad, K]
        (default ``state``'s rows) and its chunks' destination tiles
        from ``state`` [P, vpad, K] (a mesh rank's rows) padded to
        whole tiles (lux_tpu/engine/pull.py:635-697).  Pad chunks (tile
        n_tiles) read the last tile and are never taken by the
        combine."""
        a, t = self.arrays, self.tiles
        P, vpad, K = state.shape
        pad = t.n_tiles * t.W - vpad
        if pad:
            state_t = torch.cat([state, state.new_zeros((P, pad, K))], 1)
        else:
            state_t = state
        tiles = state_t.reshape(P * t.n_tiles, t.W, K)
        if flat is None:
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

    def dot_chunk_partials(self, state, flat=None):
        """Every chunk's [W, K] partials -> [P*C, W, K] (``flat``: the
        whole source table, as ``dot_chunk_blocks``)."""
        t = self.tiles
        out = torch.empty((self.lp * t.n_chunks, t.W, state.shape[-1]),
                          dtype=state.dtype, device=state.device)
        return run_blocks(self.dot_chunk_blocks(state, flat),
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
        red = combine_partials(self.dot_chunk_partials(state, flat_state),
                               self.tiles,
                               a["chunk_start"], a["last_chunk"],
                               self.vpad, "sum", self._plan, self.use_mxu)
        if self.pairs is not None:
            red = red + self._pair_dot_red(flat_state)
        return red

    # -- the phases of one iteration (the reference's names) -----------

    def _phase_exchange(self, state):
        """exchange: the flat [P*vpad, ...] state table every part reads
        (one device: a view of the state; a mesh: every rank's rows,
        all_gathered)."""
        if self.mesh is not None:
            state = all_gather_parts(self.mesh, state)
        return state.reshape((-1,) + tuple(state.shape[2:]))

    def _phase_gather(self, flat):
        """gather: per-edge source (and destination) values -> the
        messages."""
        return self._messages(flat)

    def _phase_reduce(self, flat, msgs):
        """reduce: the residual's per-vertex reduction, then the pair
        rows' delivery and reduction combined into it, as the reference
        combines them (engine/pull.py:591)."""
        red = self._reduce(msgs)
        if self.pairs is not None:
            red = combine_op(self.program.reduce)(red, self._pair_red(flat))
        return red

    def _phase_gather_reduce(self, flat):
        """gather_reduce: the paged delivery, which fetches and reduces
        in one go, or the streamed tiled path (gather, messages and B1 a
        block of chunks at a time, then the combine and the pair
        rows)."""
        if self.page_plan is not None:
            return self._paged_red(flat)
        prog = self.program
        red = streamed_tiled_reduce(
            flat, self.arrays, self.tiles, self.vpad, prog.reduce,
            lambda vals, w: prog.edge_value(vals, None, w), self._plan,
            self.use_mxu, self._occ)
        if self.pairs is not None:
            red = combine_op(prog.reduce)(red, self._pair_red(flat))
        return red

    @property
    def _streams(self) -> bool:
        """Whether the tiled path runs streamed (``stream_msgs``; the
        reference's rule: tiled layouts of programs that read no
        destination state, lux_tpu/engine/pull.py:597)."""
        return (self.stream_chunks and self.tiles is not None
                and not self.dot and not self.program.needs_dst)

    # -- the owner exchange (ops/owner.py) -------------------------------

    def _owner_contribs(self, state):
        """Every source part's contribution to every destination part
        [P, n_tiles * W, ...] (ops/owner.owner_contribs; an owner paged
        plan's by ops/pagegather.paged_owner_contribs)."""
        prog = self.program
        if self.page_plan is not None:
            return paged_owner_contribs(
                self.page_plan, state, self.arrays, prog.reduce,
                lambda vals, w: prog.edge_value(vals, None, w),
                self.num_parts)
        return owner_contribs(
            self.owner, state, self.arrays, prog.reduce,
            lambda vals, w: prog.edge_value(vals, None, w),
            self.num_parts, use_mxu=self.use_mxu, plan=self._plan,
            max_run=self._plan.max_len, occ=self._occ)

    def _owner_exchange(self, acc):
        """The contributions to their destination parts
        (ops/owner.owner_exchange: the identity on one device, across
        the mesh's ranks on one)."""
        return owner_exchange(acc, self.program.reduce, axis=self.mesh,
                              ndev=self.ndev,
                              minmax_fused=self.owner_minmax_fused)

    def _phase_gen_exchange(self, state):
        """gen_exchange: the owner exchange's message generation and
        routing, one fused phase as in the reference
        (lux_tpu/engine/pull.py:784-808) -> [P, vpad, ...].  An owner
        page-major plan routes its full rows and reduces them
        receiver-side: that replaces the exchange."""
        if self.page_plan is not None and self.page_plan.mode == "pagemajor":
            prog = self.program
            return pagemajor_owner_deliver(
                self.page_plan, state, self.arrays, prog.reduce,
                lambda vals, w: prog.edge_value(vals, None, w))[
                :, :self.vpad]
        return self._owner_exchange(self._owner_contribs(state))[
            :, :self.vpad]

    def _owner_red(self, state, red):
        """The pair rows' contribution folded into the owner reduction;
        pair rows fetch from the whole state table."""
        if self.pairs is None:
            return red
        flat = self._phase_exchange(state)
        return combine_op(self.program.reduce)(red, self._pair_red(flat))

    def _phase_owner_apply(self, state, red):
        """apply on an owner engine: the pair rows, then the epilogue
        (lux_tpu/engine/pull.py:772 ``_owner_apply``)."""
        return self._apply_epilogue(state, self._owner_red(state, red))

    def _phase_dot_reduce(self, flat, state):
        """dot_reduce: the blocked SDDMM delivery and its combine."""
        if self.page_plan is not None:
            return self._paged_dot_red(flat)
        return self._dot_red(state, flat)

    def _phase_apply(self, state, red):
        """apply: the per-vertex epilogue."""
        return self._apply_epilogue(state, red)

    def _delivery(self, state, flat):
        """The phases between exchange and apply, each under its
        profiler range."""
        if self.dot:
            with annotation("lux_dot_reduce"):
                return self._phase_dot_reduce(flat, state)
        if self.page_plan is not None or self._streams:
            with annotation("lux_gather_reduce"):
                return self._phase_gather_reduce(flat)
        with annotation("lux_gather"):
            msgs = self._phase_gather(flat)
        with annotation("lux_reduce"):
            return self._phase_reduce(flat, msgs)

    # -- the step -------------------------------------------------------

    def reduced(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration's delivery and reduce, before the apply
        epilogue: [P, vpad, ...] -> the per-vertex reductions [P, vpad,
        ...] (the reduce identity where no edge arrives)."""
        if self.exchange == "owner":
            return self._owner_red(state, self._phase_gen_exchange(state))
        return self._delivery(state, self._phase_exchange(state))

    def step(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration: [P, vpad, ...] -> [P, vpad, ...]."""
        with annotation(f"lux_{self.program.name or 'pull'}"):
            if self.exchange == "owner":
                with annotation("lux_gen_exchange"):
                    red = self._phase_gen_exchange(state)
                with annotation("lux_apply"):
                    return self._phase_owner_apply(state, red)
            with annotation("lux_exchange"):
                flat = self._phase_exchange(state)
            red = self._delivery(state, flat)
            with annotation("lux_apply"):
                return self._phase_apply(state, red)

    def timed_phases(self, state: torch.Tensor, iters: int = 1):
        """``iters`` iterations run phase by phase, each fenced (a
        device synchronize on the card) -> (state, [{phase: seconds}])
        (lux_tpu/engine/pull.py:1397).  The phases are the methods
        ``step`` calls, in its order, so the state is ``run``'s; an
        owner engine's are ``gen_exchange`` and ``apply``.  The
        fences and host returns between phases are not in a plain run:
        read the split for relative weight, not for the rate."""
        if self.mesh is not None:
            refuse_on_mesh("timed_phases")
        from lux_tpu_torch.engine.phased import PhaseTimer
        fence = device_fence(self.device)
        fence()             # the caller's queued work is no phase's
        report = []
        for _ in range(int(iters)):
            pt = PhaseTimer(fence)
            if self.exchange == "owner":
                red = pt("gen_exchange", self._phase_gen_exchange, state)
                state = pt("apply", self._phase_owner_apply, state, red)
                report.append(pt.t)
                continue
            flat = pt("exchange", self._phase_exchange, state)
            if self.dot:
                red = pt("dot_reduce", self._phase_dot_reduce, flat, state)
            elif self.page_plan is not None or self._streams:
                red = pt("gather_reduce", self._phase_gather_reduce, flat)
            else:
                msgs = pt("gather", self._phase_gather, flat)
                red = pt("reduce", self._phase_reduce, flat, msgs)
            state = pt("apply", self._phase_apply, state, red)
            report.append(pt.t)
        return state, report

    def run(self, state: torch.Tensor, num_iters: int,
            seg_budget: float | None = None) -> torch.Tensor:
        """``num_iters`` iterations, enqueued on the device's stream
        without host round-trips.  With ``health`` set, the guarded
        variant runs and its word is read once at the end
        (``health.ensure_ok``: a trip raises HealthError).
        ``seg_budget`` (seconds) runs duration-budgeted segments
        instead (segmented.DurationBudget)."""
        if seg_budget is not None:
            if self.mesh is not None:
                refuse_on_mesh("a duration-budgeted run (seg_budget=)")
            from lux_tpu_torch.segmented import DurationBudget, run_segments
            return run_segments(self, state, num_iters,
                                DurationBudget(seg_budget))
        if self.health:
            from lux_tpu_torch import health as hw
            state, _it, _rb, _cb, _rbp, _cbp, watch = self.run_health(
                state, num_iters)
            # audit: allow(callback-in-loop) the word is read once, after
            # the loop
            hw.ensure_ok(watch, engine="pull", where="pull run")
            return state
        return self._run_plain(state, num_iters)

    def _run_plain(self, state: torch.Tensor, num_iters: int):
        for _ in range(num_iters):
            state = self.step(state)
        return state

    # -- the health watchdog variants (lux_tpu_torch/health.py) ---------

    def _iter_counters(self, new, old):
        """One iteration's counters (the reference's ``_iter_counters``,
        lux_tpu/engine/pull.py:964): the max-abs state change (the
        residual), the count of vertices whose state changed, and both
        per part ([P] float32 / int32).  The scalars are the max / sum
        of the per-part rows."""
        d = (new.to(torch.float32) - old.to(torch.float32)).abs()
        P = d.shape[0]
        res_p = d.reshape(P, -1).amax(1)
        if d.dim() > 2:                         # vector payloads
            d = d.reshape(P, d.shape[1], -1).amax(-1)
        chg_p = (d > 0).sum(1, dtype=torch.int32)
        return res_p.amax(), chg_p.sum(dtype=torch.int32), res_p, chg_p

    def _stats_bufs(self):
        """The per-iteration counter buffers: residual f32 [cap],
        changed int32 [cap] and their per-part rows [cap, P] (the
        reference's are uint32 counts; torch's uint32 has thin CUDA
        coverage).  Writes past ``stats_cap`` drop."""
        cap, P, dev = self.stats_cap, self.num_parts, self.device
        return (torch.zeros((cap,), dtype=torch.float32, device=dev),
                torch.zeros((cap,), dtype=torch.int32, device=dev),
                torch.zeros((cap, P), dtype=torch.float32, device=dev),
                torch.zeros((cap, P), dtype=torch.int32, device=dev))

    def run_stats(self, state: torch.Tensor, num_iters: int):
        """``run`` plus the per-iteration counters -> (state, residual
        f32 [stats_cap], changed int32 [stats_cap], residual per part
        f32 [stats_cap, P], changed per part int32 [stats_cap, P])
        (lux_tpu/engine/pull.py:1012): residual[i] is iteration i's
        max-abs state change, changed[i] the vertices it changed; the
        scalars are the max / sum of the per-part rows.  Each counter is
        written at the host-known index ``i``: no host read happens
        until the caller fetches the buffers (telemetry.IterStats).
        Iterations past ``stats_cap`` run and record nothing.  The state
        is ``run``'s, bit for bit."""
        if self.mesh is not None:
            refuse_on_mesh("run_stats")
        bufs = _PullCounters(self)
        for i in range(num_iters):
            new = self.step(state)
            bufs.write(i, new, state)
            state = new
        return state, bufs.rb, bufs.cb, bufs.rbp, bufs.cbp

    def run_until_stats(self, state: torch.Tensor, tol: float,
                        max_iters: int = np.iinfo(np.int32).max):
        """``run_until`` plus ``run_stats``'s counters -> (state, it,
        residual, residual_buf, changed_buf, residual_parts,
        changed_parts) (lux_tpu/engine/pull.py:1097).  The loop keeps
        ``run_until``'s one small read an iteration, the residual."""
        if self.mesh is not None:
            refuse_on_mesh("run_until_stats")
        bufs = _PullCounters(self)
        state, it, res = self._run_until(state, tol, max_iters, bufs)
        return state, it, res, bufs.rb, bufs.cb, bufs.rbp, bufs.cbp

    def run_health(self, state: torch.Tensor, num_iters: int, watch=None):
        """``num_iters`` iterations under the health watchdog: returns
        (state, iters_executed, residual_buf, changed_buf,
        residual_parts, changed_parts, watch) with watch = (word
        int32[6], residual window f32[8]), as the reference's
        (lux_tpu/engine/pull.py:1119-1180).  Pass the previous
        segment's ``watch`` back in to keep the window's history.

        No host read happens here.  The reference's loop exits the
        iteration a check trips; here every later iteration is still
        enqueued but keeps the tripped state, word, window and buffers
        through a ``torch.where`` on the word's flags, so the returned
        state, ``iters_executed`` (a device int32 scalar) and word are
        the reference's.  A healthy run's state is the plain run's,
        bit for bit (``where`` on True returns the new state).  Decode
        the word once with ``health.ensure_ok(watch)``."""
        if self.mesh is not None:
            refuse_on_mesh("run_health")
        from lux_tpu_torch import health as hw
        h, win = watch if watch is not None else (
            hw.init_word(self.device), hw.init_window(self.device))
        rb, cb, rbp, cbp = self._stats_bufs()
        cap = rb.shape[0]
        it = torch.zeros((), dtype=torch.int32, device=self.device)
        for i in range(num_iters):
            ok = h[0] == 0
            new = self.step(state)
            r, cnt, rp, cp = self._iter_counters(new, state)
            h2, win2 = hw.pull_update(h, win, new, r)
            state = torch.where(ok, new, state)
            h = torch.where(ok, h2, h)
            win = torch.where(ok, win2, win)
            if i < cap:
                rb[i] = torch.where(ok, r, rb[i])
                cb[i] = torch.where(ok, cnt, cb[i])
                rbp[i] = torch.where(ok, rp, rbp[i])
                cbp[i] = torch.where(ok, cp, cbp[i])
            it = it + ok.to(torch.int32)
        return state, it, rb, cb, rbp, cbp, (h, win)

    def run_until_health(self, state: torch.Tensor, tol: float,
                         max_iters: int = np.iinfo(np.int32).max):
        """``run_until`` under the health watchdog: returns (state, it,
        residual, residual_buf, changed_buf, residual_parts,
        changed_parts, watch), as the reference's (:1220-1233).  The
        loop reads one small tensor an iteration, the residual and the
        word's flags together, and stops when the residual is <= tol
        (never on a NaN residual), at max_iters, or the iteration a
        check trips."""
        if self.mesh is not None:
            refuse_on_mesh("run_until_health")
        guard = _PullGuard(self)
        state, it, res = self._run_until(state, tol, max_iters, guard)
        return (state, it, res, guard.rb, guard.cb, guard.rbp, guard.cbp,
                (guard.h, guard.win))

    def run_until(self, state: torch.Tensor, tol: float,
                  max_iters: int = np.iinfo(np.int32).max):
        """Iterate until the max-abs change of the state is <= tol, or
        max_iters.  Returns (state, iterations, final residual).  A NaN
        residual never reports convergence (``not res <= tol``).  On a
        mesh the residual is the max over every rank's parts, so the
        ranks stop together."""
        return self._run_until(state, tol, max_iters, None)

    def _run_until(self, state, tol, max_iters, guard):
        it, res = 0, float("inf")
        while not res <= tol and it < max_iters:
            new = self.step(state)
            if guard is None:
                r = (new.float() - state.float()).abs().max()
                if self.mesh is not None:
                    r = all_reduce_scalar(self.mesh, r, "max")
                res, flags = float(r), 0
            else:
                res, flags = guard.record(it, new, state)  # the one read
            state, it = new, it + 1
            if flags:
                break
        return state, it, res


class _PullCounters:
    """The counter buffers of one pull run, written at host-known
    iteration indices."""

    def __init__(self, eng):
        self.eng = eng
        self.rb, self.cb, self.rbp, self.cbp = eng._stats_bufs()

    def write(self, it: int, new, old):
        """Iteration ``it``'s counters into row ``it`` (dropped past the
        buffers' end) -> the residual (a device scalar), or None when
        dropped."""
        if it >= self.rb.shape[0]:
            return None
        r, cnt, rp, cp = self.eng._iter_counters(new, old)
        self.rb[it], self.cb[it] = r, cnt
        self.rbp[it], self.cbp[it] = rp, cp
        return r

    def record(self, it: int, new, old):
        """``write`` plus the one host read of the residual -> (residual,
        flags=0)."""
        r = self.write(it, new, old)
        if r is None:
            r = (new.float() - old.float()).abs().max()
        return float(r), 0


class _PullGuard(_PullCounters):
    """The device-side state of one guarded ``run_until``: the health
    word, the residual window and the counter buffers."""

    def __init__(self, eng):
        from lux_tpu_torch import health as hw
        super().__init__(eng)
        self.hw = hw
        self.h, self.win = hw.init_word(eng.device), hw.init_window(
            eng.device)

    def record(self, it: int, new, old):
        """Fold iteration ``it`` into the word and the buffers; one host
        read of [residual, flags]."""
        r, cnt, rp, cp = self.eng._iter_counters(new, old)
        self.h, self.win = self.hw.pull_update(self.h, self.win, new, r)
        if it < self.rb.shape[0]:
            self.rb[it], self.cb[it] = r, cnt
            self.rbp[it], self.cbp[it] = rp, cp
        # the flags ride as float32 bits beside the float32 residual
        pair = torch.stack([r, self.h[0].view(torch.float32)]).cpu()
        return float(pair[0]), int(pair[1:].view(torch.int32))
