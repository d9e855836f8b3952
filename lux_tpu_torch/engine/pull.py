"""The pull engine: dense gather-apply iterations on one device
(counterpart of lux_tpu/engine/pull.py:142-194, :535-629, :922-962,
:1108, :1235).

One iteration, every part at once (parts are a batch dimension):

1. gather each edge's source state by its precomputed padded slot
   (``index_select`` on the flat ``[P*vpad]`` state table);
2. per-edge message (``program.edge_value``);
3. scatter-free segment reduction to each part's local destinations:
   the tiled layout (ops/tiled.py) runs kernel B1 over all ``P*C``
   chunks in one launch and then the segmented chunk combine;
   ``layout="flat"`` is the scatter-reduce oracle (ops/segment.py);
4. per-vertex apply epilogue, masked to real vertex slots.

The reference fuses a fixed-iteration run into one XLA program; here a
run is a Python loop over ``step`` on the device's stream.  The
reference's exchange variants (owner), pair-lane and paged deliveries,
streamed blocks and the mesh are refused with a typed
:class:`NotPortedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.program import PartCtx, PullProgram, vmask_of
from lux_tpu_torch.graph import ShardedGraph
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (TiledLayout, segment_plan,
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
                         f"this slice runs one device, layout "
                         f"'tiled'/'flat', exchange 'gather'")


def resolve_exchange(exchange: str, sg: ShardedGraph, program) -> str:
    """'auto' resolves as the reference does: 'owner' once the state
    table passes OWNER_AUTO_BYTES (for programs whose messages depend
    only on the source), else 'gather'.  Only 'gather' is ported."""
    if exchange == "auto":
        itemsize = program.state_bytes or 4
        big = sg.num_parts * sg.vpad * itemsize > OWNER_AUTO_BYTES
        if big and not program.needs_dst:
            _refuse(f"the owner exchange, which exchange='auto' picks "
                    f"for this {sg.num_parts * sg.vpad * itemsize} B "
                    f"state table (pass exchange='gather'),", "A6")
        exchange = "gather"
    if exchange == "owner":
        _refuse("exchange='owner'", "A6")
    if exchange != "gather":
        raise ValueError(f"unknown exchange {exchange!r}")
    return exchange


def build_graph_arrays(sg: ShardedGraph, layout: str, tile_e: int):
    """Per-part host arrays (leading dim num_parts) for either edge
    layout -> (arrays dict, TiledLayout | None).  The tiled keys and
    values are the reference's (engine/pull.py:164-194)."""
    common = dict(deg=sg.deg_padded,
                  nvp=sg.nv_part.astype(np.int32)[:, None])
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


class PullEngine:
    """Pull-model iterations for one ShardedGraph + program on one
    device (``device=None`` means the card; pass ``"cpu"`` for the
    plain PyTorch versions)."""

    def __init__(self, sg: ShardedGraph, program: PullProgram, *,
                 device=None, layout: str = "tiled", tile_e: int = 512,
                 exchange: str = "auto", gather: str = "flat",
                 pair_threshold: int | None = None,
                 stream_msgs: bool | None = None, mesh=None):
        dev = resolve_device(device)
        if mesh is not None:
            _refuse("a device mesh", "A6")
        if pair_threshold is not None:
            _refuse("pair-lane delivery (pair_threshold)", "A3")
        if gather != "flat":
            _refuse(f"gather={gather!r}", "A8")
        if stream_msgs:
            _refuse("streamed chunk blocks (stream_msgs)", "A6")
        if program.needs_dst:
            _refuse("programs whose edge_value reads the destination",
                    "A5")
        resolve_exchange(exchange, sg, program)
        arrays, lay = build_graph_arrays(sg, layout, tile_e)
        self._bind(program, arrays, None if lay is None else lay.geometry,
                   nv=sg.nv, ne=sg.ne, num_parts=sg.num_parts,
                   vpad=sg.vpad, device=dev, sg=sg)

    @classmethod
    def from_arrays(cls, program: PullProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    device=None):
        """An engine on given per-part arrays (tiled keys: src_slot,
        rel_dst, chunk_start, last_chunk, deg, nvp) and tile geometry
        (ops/tiled.TileGeometry) — how interop.from_reference carries a
        reference engine's arrays across bit for bit."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg):
        self.program = program
        self.sg = sg
        self.tiles = tiles
        self.nv, self.ne = int(nv), int(ne)
        self.num_parts, self.vpad = int(num_parts), int(vpad)
        self.device = device
        need = TILED_KEYS if tiles is not None else (
            "src_slot", "dst_local", "deg", "nvp")
        missing = [k for k in need if k not in arrays]
        if missing:
            raise KeyError(f"graph arrays lack {missing}")
        self.arrays = {k: torch.tensor(np.asarray(v), device=device)
                       for k, v in arrays.items()}
        a, P = self.arrays, self.num_parts
        if a["deg"].shape != (P, self.vpad) or a["nvp"].shape != (P, 1):
            raise ValueError(f"deg {tuple(a['deg'].shape)} / nvp "
                             f"{tuple(a['nvp'].shape)} do not match "
                             f"num_parts={P} vpad={self.vpad}")
        src = a["src_slot"]
        if src.numel() and (int(src.min()) < 0
                            or int(src.max()) >= P * self.vpad):
            raise ValueError(f"src_slot outside the [0, {P * self.vpad}) "
                             f"state table")
        self._src = src.reshape(-1)
        if tiles is not None:
            shape = (P, tiles.n_chunks, tiles.E)
            if (tuple(src.shape) != shape
                    or tuple(a["rel_dst"].shape) != shape
                    or a["rel_dst"].dtype != torch.int8
                    or tuple(a["last_chunk"].shape) != (P, tiles.n_tiles)):
                raise ValueError(
                    f"tiled arrays do not match [P, C, E] = {shape} / "
                    f"last_chunk [P, n_tiles={tiles.n_tiles}] int8 rel")
            self._plan = segment_plan(a["chunk_start"], a["last_chunk"])
        else:
            # flat oracle: one segment space for all parts, with each
            # part's trash row vpad kept apart
            base = torch.arange(P, device=device)[:, None] * (self.vpad + 1)
            self._seg = (a["dst_local"].to(torch.int64) + base).reshape(-1)

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

    def step(self, state: torch.Tensor) -> torch.Tensor:
        """One iteration: [P, vpad] -> [P, vpad]."""
        msgs = self._messages(state.reshape(-1))
        return self._apply_epilogue(state, self._reduce(msgs))

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
