"""The pull engine: dense gather-apply iterations on one device
(counterpart of lux_tpu/engine/pull.py:142-194, :240-304, :361-462,
:535-629, :922-962, :1108, :1235).

One iteration, every part at once (parts are a batch dimension):

1. gather each edge's source state by its precomputed padded slot
   (``index_select`` on the flat ``[P*vpad]`` state table);
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
from lux_tpu_torch.ops.pagegather import (PAGED_KEYS, W, engine_page_plan,
                                          paged_partial, plan_graph_arrays,
                                          row_slots)
from lux_tpu_torch.ops.pairs import (PAIR_KEYS, pair_graph_arrays,
                                     pair_partial, pair_partial_streamed,
                                     plan_sharded_pairs, resolve_pair_stream)
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (TiledLayout, combine_op, segment_plan,
                                     tiled_segment_reduce)

# exchange="auto" picks the owner exchange once the flat state table
# passes this many bytes — the reference's rule (engine/pull.py:80)
OWNER_AUTO_BYTES = 96 << 20

TILED_KEYS = ("src_slot", "rel_dst", "chunk_start", "last_chunk", "deg",
              "nvp")


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
    (lux_tpu/engine/pull.py:372-384); its dot path is ROADMAP A5."""
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
    if dot is not None:
        _refuse("pair delivery of edge_value_from_dot programs", "A5")


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
        if big and not getattr(program, "needs_dst", False):
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


def build_graph_arrays(sg: ShardedGraph, layout: str, tile_e: int):
    """Per-part host arrays (leading dim num_parts) for either edge
    layout -> (arrays dict, TiledLayout | None).  The tiled keys and
    values are the reference's (engine/pull.py:164-194)."""
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
                 stream_msgs: bool | None = None, mesh=None):
        """``pair_threshold``: serve the edges of (src tile, dst tile)
        pairs with at least this many edges by pair-lane rows
        (ops/pairs.py; needs vpad % 128 == 0), the rest by the tiled
        path; ``pair_min_fill`` drops pair rows with fewer live lanes
        to the residual; ``pair_stream`` (None = True, the reference's
        default) reduces the pair rows in blocks."""
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
        if program.needs_dst:
            _refuse("programs whose edge_value reads the destination",
                    "A5")
        resolve_exchange(exchange, sg, program)
        t0 = time.perf_counter()
        plan = engine_page_plan(sg, gather, program)
        pairs = None
        if pair_threshold is not None:
            # the tiled path runs on the residual of the pair plan
            pairs, sg = plan_sharded_pairs(sg, pair_threshold,
                                           min_fill=pair_min_fill)
        plan_seconds = time.perf_counter() - t0
        if plan is not None:
            # the paged plan IS the edge layout: no chunk arrays
            arrays, tiles = dict(common_graph_arrays(sg),
                                 **plan_graph_arrays(plan)), None
        else:
            arrays, lay = build_graph_arrays(sg, layout, tile_e)
            tiles = None if lay is None else lay.geometry
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs))
        self._bind(program, arrays, tiles, nv=sg.nv, ne=sg.ne,
                   num_parts=sg.num_parts, vpad=sg.vpad, device=dev, sg=sg,
                   pages=plan, pairs=pairs, pair_stream=pair_stream)
        self.plan_seconds = plan_seconds

    @classmethod
    def from_arrays(cls, program: PullProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    device=None, pages=None, pairs=None, pair_stream=None):
        """An engine on given per-part arrays and their geometry — how
        interop.from_reference carries a reference engine's arrays
        across bit for bit.  Tiled: keys src_slot, rel_dst,
        chunk_start, last_chunk, deg, nvp and ``tiles`` an
        ops/tiled.TileGeometry; with pair rows also pair_rowbind,
        pair_rel, pair_tile_pos (+ pair_weight) and ``pairs`` an
        ops/pairs.PairGeometry.  Paged: keys pg_ids, pg_sl, pg_rel,
        pg_tp (+ pg_w, pg_vrs), deg, nvp, ``tiles=None`` and ``pages``
        an ops/pagegather.PageGeometry."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None, pages=pages,
                  pairs=pairs, pair_stream=pair_stream)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg, pages=None, pairs=None, pair_stream=None):
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
        if pages is not None:
            need = PAGED_KEYS + ("deg", "nvp") + (
                ("pg_vrs",) if pages.mode == "pagemajor" else ())
        elif tiles is not None:
            need = TILED_KEYS
        else:
            need = ("src_slot", "dst_local", "deg", "nvp")
        if pairs is not None:
            need += PAIR_KEYS
        missing = [k for k in need if k not in arrays]
        if missing:
            raise KeyError(f"graph arrays lack {missing}")
        self.arrays = device_arrays(arrays, device)
        a, P = self.arrays, self.num_parts
        check_dense_arrays(a, P, self.vpad, tiles, pages, pairs)
        if pages is not None:
            return
        self._src = a["src_slot"].reshape(-1)
        if tiles is not None:
            self._plan = segment_plan(a["chunk_start"], a["last_chunk"])
        else:
            self._seg = flat_segments(a["dst_local"], self.vpad)

    # -- state --------------------------------------------------------

    def init_state(self) -> torch.Tensor:
        if self.sg is None:
            raise ValueError("engine built from arrays has no graph to "
                             "initialise from; pass the state in")
        return torch.as_tensor(self.program.init(self.sg)).to(self.device)

    def unpad(self, state: torch.Tensor) -> np.ndarray:
        """Padded device state -> [nv, ...] user order (host)."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no partition "
                             "to unpad with")
        return self.sg.from_padded(state.detach().cpu().numpy())

    # -- one iteration ------------------------------------------------

    def _apply_epilogue(self, old, red):
        vm = vmask_of(self.arrays, self.vpad)
        ctx = PartCtx(deg=self.arrays["deg"], vmask=vm, nv=self.nv,
                      ne=self.ne)
        new = self.program.apply(old, red, ctx)
        return torch.where(vm, new, old)

    def _messages(self, flat_state):
        """Phase 1 (gather): per-edge source gather + message values."""
        src_vals = torch.index_select(flat_state, 0, self._src)
        src_vals = src_vals.view(self.arrays["src_slot"].shape)
        return self.program.edge_value(src_vals, None,
                                       self.arrays.get("weight"))

    def _reduce(self, msgs):
        """Phase 2 (reduce): [P, vpad] per-vertex reductions."""
        prog, a, P, vpad = self.program, self.arrays, self.num_parts, \
            self.vpad
        if self.tiles is None:
            red = segment_reduce(msgs.reshape(-1), self._seg,
                                 P * (vpad + 1), prog.reduce)
            return red.view(P, vpad + 1)[:, :vpad]
        return tiled_segment_reduce(msgs, self.tiles, a["chunk_start"],
                                    a["last_chunk"], a["rel_dst"], vpad,
                                    prog.reduce, self._plan)

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

    def step(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration: [P, vpad] -> [P, vpad]."""
        flat = state.reshape(-1)
        if self.page_plan is not None:
            return self._apply_epilogue(state, self._paged_red(flat))
        red = self._reduce(self._messages(flat))
        if self.pairs is not None:
            # the residual's reduction, then the pair rows', as the
            # reference combines them (engine/pull.py:591)
            red = combine_op(self.program.reduce)(red, self._pair_red(flat))
        return self._apply_epilogue(state, red)

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
