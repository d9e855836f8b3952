"""The push engine: frontier-driven label propagation to convergence
(counterpart of lux_tpu/engine/push.py:63 ``PushProgram``, :99
``PushEngine``).

The canonical frontier is a dense bool mask in the padded part-major
layout.  Each iteration takes one of two paths, chosen as the
reference chooses (frontier > nv/16 or past the queue: dense;
push.py:743-759, :1281):

- DENSE: inactive sources are masked to the program's identity before
  the one per-edge gather, then the candidates reduce per destination
  with kernel B1 (``min``/``max``) and the segmented chunk combine
  (ops/tiled.py), plus the pair rows (ops/pairs.py) or, with
  ``gather="paged"|"pagemajor"``, the page-binned delivery that
  replaces both (ops/pagegather.py: kernels B2 and B1);
- SPARSE: each part's mask is compacted into a capacity-bounded queue
  of (vertex, label) pairs and only the queue's out-edges are relaxed,
  through the FULL graph's src-sorted view and a bounded scatter
  (engine/frontier.py).  When the frontier's out-edges pass the edge
  budget, the queue suffix that was not expanded stays active.

The reference runs a whole convergence as one ``lax.while_loop`` with
no host sync.  Here the loop is Python on the device's stream: an
iteration reads one int32 count to the host (the next frontier's
size, which picks the next path and is the stop test; delta-stepping
reads the bucket front's size and the active count as one [2] tensor),
and nothing else in it syncs: queues are cumsum + searchsorted +
scatter into fixed capacities, never ``nonzero`` or mask indexing.

Query-batched programs (``program.batch = B``: k-source SSSP, seeded
components) carry labels and active masks [P, vpad, B]: one masked
gather an edge serves all B queries, kernel B1's batched form reduces
the [P*C, E, B] candidates, and every iteration is dense (the
reference's rule: sparse queues, delta buckets and pair rows are
single-query machinery).  A column converges when its own frontier
empties; the loop reads one int32 an iteration, the count of active
(vertex, query) pairs.

Options the port does not carry yet raise :class:`NotPortedError`
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine import frontier as fr
from lux_tpu_torch.engine.program import vmask_of
from lux_tpu_torch.engine.pull import (NotPortedError, _outside,
                                       build_graph_arrays,
                                       check_batched_gather,
                                       check_dense_arrays,
                                       common_graph_arrays, device_arrays,
                                       flat_segments, gather_rows,
                                       resolve_exchange)
from lux_tpu_torch.graph import ShardedGraph
from lux_tpu_torch.ops.pagegather import (engine_page_plan, paged_partial,
                                          plan_graph_arrays)
from lux_tpu_torch.ops.pairs import (pair_graph_arrays, pair_partial,
                                     pair_partial_streamed,
                                     plan_sharded_pairs, resolve_pair_stream)
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (combine_op, segment_plan,
                                     tiled_segment_reduce)
from lux_tpu_torch.partition import frontier_capacity

INT32_MAX = int(np.iinfo(np.int32).max)

# the src-sorted view's keys (ss_weight when weighted)
SPARSE_KEYS = ("src_ids", "src_off", "ss_dst", "part_start")


def _refuse(what: str, item: str):
    raise NotPortedError(f"{what} is not ported yet (ROADMAP {item}); "
                         f"the port's push engine runs one device, "
                         f"layout 'tiled'/'flat', gather "
                         f"'flat'/'paged'/'pagemajor' or pair-lane rows "
                         f"(query-batched programs: tiled or flat), "
                         f"exchange 'gather'")


@dataclasses.dataclass(frozen=True)
class PushProgram:
    """Monotone label-propagation program.

    reduce    'min' (SSSP) or 'max' (components).
    relax     (src_label, weight | None) -> candidate label offered to
              the edge's destination (tensors).
    identity  numpy scalar no-op candidate in the label dtype (+inf or
              HOP_INF for min, -1 for components' max).
    init      (sharded_graph) -> (label0 [P, vpad], active0 bool [P,
              vpad]) numpy.
    name      optional app label.
    batch     query-batch width B when labels and active masks carry a
              trailing query axis [P, vpad, B] (None = one query).
    """
    reduce: str
    relax: Callable
    identity: Any
    init: Callable
    name: str | None = None
    batch: int | None = None

    def better(self, cand, old):
        return cand < old if self.reduce == "min" else cand > old


class PushEngine:
    """Frontier iterations for one ShardedGraph + PushProgram on one
    device (``device=None`` means the card; pass ``"cpu"`` for the
    plain PyTorch versions).  ``schedule`` lists the kind ("dense" or
    "sparse") of every iteration since the last ``converge``."""

    plan_seconds = 0.0      # host seconds spent building the paged or
                            # pair plan

    def __init__(self, sg: ShardedGraph, program: PushProgram, *,
                 device=None, mesh=None, layout: str = "tiled",
                 tile_e: int = 512, use_mxu: bool | str = "auto",
                 enable_sparse: bool = True, sparse_threshold: int = 16,
                 edge_budget: int | None = None,
                 delta: float | None = None,
                 pair_threshold: int | None = None,
                 pair_min_fill: int | str | None = None,
                 pair_stream: bool | None = None,
                 stream_msgs: bool | None = None,
                 exchange: str = "auto", gather: str = "flat",
                 stats_cap: int | None = None, health: bool = False,
                 audit: str | None = None):
        dev = resolve_device(device)
        if mesh is not None:
            _refuse("a device mesh", "A6")
        if stream_msgs:
            _refuse("streamed chunk blocks (stream_msgs)", "A6")
        if program.batch is not None:
            # the reference's rule (lux_tpu/engine/push.py:131-146):
            # dense masked iterations only
            if delta is not None:
                raise ValueError(
                    "delta-stepping is single-query (one scalar bucket "
                    "bound); build batched engines with delta=None")
            if pair_threshold is not None:
                raise ValueError(
                    "pair_threshold does not support query-batched "
                    "programs: pair delivery reads scalar vertex state "
                    "(ops/pairs.pair_partial)")
            check_batched_gather(gather, program, _refuse)
            enable_sparse = False
        if health:
            _refuse("the device health watchdog (health=True)", "A9")
        if stats_cap is not None:
            _refuse("device-side iteration counters (stats_cap)", "A10")
        if audit is not None:
            _refuse("the static program audit (audit=)", "A12")
        if gather == "auto":
            _refuse("gather='auto' (it resolves through scalemodel, "
                    "whose constants were measured on the TPU)", "A10")
        fr.check_use_mxu(use_mxu)
        # the auto-exchange estimate is the whole label table's bytes: a
        # B-wide batch is B tables
        ident_dt = np.asarray(program.identity).dtype
        resolve_exchange(exchange, sg, program,
                         itemsize=ident_dt.itemsize * (program.batch or 1))
        if layout == "flat" and dev.type != "cpu":
            raise ValueError(
                "layout='flat' is the scatter oracle over every edge and "
                "runs on the CPU only; the card runs layout='tiled' "
                "(kernel B1)")
        if gather in ("paged", "pagemajor") and pair_threshold is not None:
            raise ValueError(
                f"gather={gather!r} subsumes pair delivery (both are "
                f"row-granular layouts); build without pair_threshold")
        if pair_threshold is not None and layout != "tiled":
            raise ValueError("pair_threshold requires the tiled layout")
        t0 = time.perf_counter()
        plan = engine_page_plan(sg, gather, program)
        pairs, dense_sg = None, sg
        if pair_threshold is not None:
            # the dense tiled path runs on the pair plan's residual;
            # sparse iterations keep the FULL graph's src-sorted view
            pairs, dense_sg = plan_sharded_pairs(sg, pair_threshold,
                                                 min_fill=pair_min_fill)
        plan_seconds = time.perf_counter() - t0
        if plan is not None:
            arrays, tiles = dict(common_graph_arrays(dense_sg),
                                 **plan_graph_arrays(plan)), None
        else:
            arrays, lay = build_graph_arrays(dense_sg, layout, tile_e)
            tiles = None if lay is None else lay.geometry
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs))
        queue_cap = eb = 0
        if enable_sparse:
            ss = sg.src_sorted(s_pad=sg.src_unique_max())
            # the reference's queue sizing (push_model.inl:393-397)
            queue_cap = frontier_capacity(sg.vpad, sparse_threshold)
            # the budget covers any one source's out-edges in a part,
            # so a truncated hub always makes progress
            default_eb = max(1024, sg.epad // sparse_threshold)
            eb = int(edge_budget if edge_budget is not None
                     else max(default_eb, (sg.max_in_deg() or 1) + 128))
            arrays.update(src_ids=ss["src_ids"], src_off=ss["src_off"],
                          ss_dst=ss["ss_dst"],
                          part_start=sg.starts[:-1].astype(
                              np.int32)[:, None])
            if ss["ss_weight"] is not None:
                arrays["ss_weight"] = ss["ss_weight"]
        self._bind(program, arrays, tiles, nv=sg.nv, ne=sg.ne,
                   num_parts=sg.num_parts, vpad=sg.vpad, device=dev, sg=sg,
                   pages=plan, pairs=pairs, pair_stream=pair_stream,
                   enable_sparse=enable_sparse,
                   sparse_threshold=sparse_threshold, queue_cap=queue_cap,
                   edge_budget=eb, delta=delta)
        self.plan_seconds = plan_seconds

    @classmethod
    def from_arrays(cls, program: PushProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    queue_cap: int, edge_budget: int,
                    enable_sparse: bool = True, sparse_threshold: int = 16,
                    delta=None, device=None, pages=None, pairs=None,
                    pair_stream=None):
        """An engine on given per-part arrays and their geometry — how
        interop.push_from_reference carries a reference engine's
        arrays across bit for bit.  The dense keys are
        PullEngine.from_arrays's; with sparse iterations also
        src_ids, src_off, ss_dst, part_start (+ ss_weight)."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None, pages=pages,
                  pairs=pairs, pair_stream=pair_stream,
                  enable_sparse=enable_sparse,
                  sparse_threshold=sparse_threshold, queue_cap=queue_cap,
                  edge_budget=edge_budget, delta=delta)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg, pages, pairs, pair_stream, enable_sparse,
              sparse_threshold, queue_cap, edge_budget, delta):
        if program.reduce not in ("min", "max"):
            raise ValueError(f"push programs reduce by 'min' or 'max', "
                             f"not {program.reduce!r}")
        ldt = np.asarray(program.identity).dtype
        if delta is not None:
            if program.reduce != "min":
                raise ValueError("delta-stepping requires a 'min' program")
            # in the LABEL dtype: a fractional delta truncates to 0 on
            # int32 labels and would spin the bucket loop forever
            if not float(np.asarray(delta, ldt)) > 0:
                raise ValueError(
                    f"delta-stepping bucket width {delta!r} is not > 0 "
                    f"in label dtype {ldt}")
        if pairs is not None and tiles is None:
            raise ValueError("pair rows need the tiled layout")
        self.batch = program.batch
        if self.batch is not None and (enable_sparse or pairs is not None
                                       or pages is not None):
            raise ValueError("query-batched push engines run dense tiled "
                             "or flat iterations only (no sparse queue, "
                             "pair rows or paged rows)")
        self.program = program
        self.sg = sg
        self.tiles = tiles
        self.page_plan = pages
        self.gather = "flat" if pages is None else pages.mode
        self.pairs = pairs
        self.pair_stream = resolve_pair_stream(pair_stream, pairs)
        self.nv, self.ne = int(nv), int(ne)
        self.num_parts, self.vpad = int(num_parts), int(vpad)
        self.device = device
        self.delta = delta
        self.enable_sparse = bool(enable_sparse)
        self.sparse_threshold = int(sparse_threshold)
        self.queue_cap = int(queue_cap)
        self.edge_budget = int(edge_budget)
        self.schedule: list[str] = []
        self._placed = None
        self.arrays = device_arrays(arrays, device)
        a, P = self.arrays, self.num_parts
        check_dense_arrays(a, P, vpad, tiles, pages, pairs)
        if pages is None:
            self._src = a["src_slot"].reshape(-1)
            if tiles is not None:
                self._plan = segment_plan(a["chunk_start"], a["last_chunk"])
            else:
                self._seg = flat_segments(a["dst_local"], self.vpad)
        if self.enable_sparse:
            self._check_sparse()
        self._ident = np.asarray(program.identity).item()
        if delta is not None:
            self._delta_t = torch.tensor(np.asarray(delta, ldt),
                                         device=device)
        self._vmask = vmask_of(a, self.vpad)

    def _check_sparse(self):
        """Shapes and index ranges of the src-sorted view, checked once
        (an out-of-range index would fault on the card)."""
        a, P = self.arrays, self.num_parts
        missing = [k for k in SPARSE_KEYS if k not in a]
        if missing:
            raise KeyError(f"sparse iterations need {missing}")
        ids, off, dst, ps = (a[k] for k in SPARSE_KEYS)
        S, E = ids.shape[-1], dst.shape[-1]
        w = a.get("ss_weight")
        ok = (ids.dim() == 2 and ids.shape[0] == P
              and ids.dtype == off.dtype == dst.dtype == ps.dtype
              == torch.int32
              and tuple(off.shape) == (P, S + 1)
              and tuple(dst.shape) == (P, E) and tuple(ps.shape) == (P, 1)
              and (w is None or tuple(w.shape) == (P, E))
              and self.queue_cap >= 1 and self.edge_budget >= 1)
        if not ok:
            raise ValueError("src-sorted arrays do not match [P, S] int32 "
                             "ids, [P, S+1] offsets, [P, E] dsts, [P, 1] "
                             "part starts (queue_cap, edge_budget >= 1)")
        if (_outside(ids, self.nv + 1) or _outside(off, E + 1)
                or bool((off[:, 1:] < off[:, :-1]).any())
                or _outside(ps, self.nv + 1)):
            raise ValueError("src-sorted arrays index outside the graph "
                             "or the part's edges")

    # -- state ---------------------------------------------------------

    def init_state(self):
        """(label, active) of the program's init on the device."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no graph to "
                             "initialise from; pass the state in")
        return self.place(*self.program.init(self.sg))

    def place(self, label, active):
        """Host state arrays -> (label, active) tensors on the device.
        The host counts the active mask here, so a converge from this
        state reads no count before its first iteration."""
        active = np.asarray(active, dtype=bool)
        lab = torch.tensor(np.asarray(label), device=self.device)
        act = torch.tensor(active, device=self.device)
        self._placed = (act, int(np.count_nonzero(active)))
        return lab, act

    def unpad(self, state: torch.Tensor) -> np.ndarray:
        """Padded device state -> [nv] user order (host)."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no partition "
                             "to unpad with")
        return self.sg.from_padded(state.detach().cpu().numpy())

    def _count(self, active: torch.Tensor) -> int:
        """The active count on the host: known for a state ``place``
        made, else one read of one int32."""
        if self._placed is not None and self._placed[0] is active:
            return self._placed[1]
        return int(active.sum(dtype=torch.int32))

    # -- messages ------------------------------------------------------

    def _msg(self, vals, w):
        """relax, with identity sources mapped back to the identity (a
        masked source offers nothing)."""
        c = self.program.relax(vals, w)
        return torch.where(vals == self._ident, self._ident, c)

    # -- dense iteration -----------------------------------------------

    def _masked_flat(self, label, active):
        """Phase 1: inactive sources -> identity BEFORE the one gather,
        as one flat [P*vpad] table ([P*vpad, B] batched: the same
        gather fetches every query's column, and a retired column is
        all-inactive, so it offers the identity)."""
        masked = torch.where(active, label, self._ident)
        return masked.reshape((-1,) + tuple(label.shape[2:]))

    def _dense_cand(self, flat):
        """Phase 2 (tiled / flat layouts): per-edge source gather +
        candidates [P, C, E] or [P, epad] (+ [B])."""
        vals = gather_rows(flat, self._src).view(
            tuple(self.arrays["src_slot"].shape) + tuple(flat.shape[1:]))
        return self._msg(vals, self.arrays.get("weight"))

    def _dense_red(self, flat, cand):
        """Phase 3: per-destination reduce [P, vpad] (kernel B1 and the
        segmented combine, plus the pair rows; or the paged delivery,
        which fetches and reduces in one go)."""
        a, kind, P, vpad = self.arrays, self.program.reduce, \
            self.num_parts, self.vpad
        if self.page_plan is not None:
            return paged_partial(
                self.page_plan, flat, a["pg_ids"], a["pg_sl"], a["pg_rel"],
                a.get("pg_w"), a["pg_tp"], kind, self._msg,
                vrow_src=a.get("pg_vrs"))[:, :vpad]
        if self.tiles is None:
            trail = tuple(flat.shape[1:])
            red = segment_reduce(cand.reshape((-1,) + trail), self._seg,
                                 P * (vpad + 1), kind)
            red = red.view((P, vpad + 1) + trail)[:, :vpad]
        else:
            red = tiled_segment_reduce(cand, self.tiles, a["chunk_start"],
                                       a["last_chunk"], a["rel_dst"], vpad,
                                       kind, self._plan, batch=self.batch)
        if self.pairs is not None:
            red = combine_op(kind)(red, self._pair_red(flat))
        return red

    def _pair_red(self, flat):
        """Pair-lane delivery for every part -> [P, vpad]."""
        a = self.arrays
        fn = pair_partial_streamed if self.pair_stream else pair_partial
        return fn(self.pairs, flat, a["pair_rowbind"], a["pair_rel"],
                  a.get("pair_weight"), a["pair_tile_pos"],
                  self.program.reduce, self._msg)[:, :self.vpad]

    def _dense_update(self, label, red):
        """Phase 4: keep improvements, flag the new frontier (per query
        on batched labels: the vertex mask broadcasts over the query
        axis)."""
        vm = self._vmask.reshape(tuple(self._vmask.shape)
                                 + (1,) * (red.dim() - 2))
        improved = self.program.better(red, label) & vm
        return torch.where(improved, red, label), improved

    def _dense(self, label, active):
        flat = self._masked_flat(label, active)
        cand = None if self.page_plan is not None else \
            self._dense_cand(flat)
        return self._dense_update(label, self._dense_red(flat, cand))

    # -- sparse iteration ----------------------------------------------

    def _sparse_compact(self, label, active):
        """Each part's mask -> (global id, label) queue [P, Q] and its
        count [P]."""
        ids, vals, cnts = fr.compact_mask(active, label, self.queue_cap)
        gids = torch.where(ids < self.vpad,
                           self.arrays["part_start"] + ids, self.nv)
        return gids, vals, cnts

    def _sparse_expand(self, gids, vals):
        """Every part expands the whole [P*Q] queue over its own
        src-sorted edges -> (edge_idx, src_val, in_range, off)."""
        a = self.arrays
        edge_idx, src_val, in_range, _total, off = fr.expand_frontier(
            gids.reshape(-1), vals.reshape(-1), a["src_ids"], a["src_off"],
            self.nv, self.edge_budget)
        return edge_idx, src_val, in_range, off

    def _sparse_relax(self, label, edge_idx, src_val, in_range):
        """Relax the expanded edges and scatter-reduce them into the
        labels -> (new labels, improved mask)."""
        a, prog, vpad = self.arrays, self.program, self.vpad
        idx = edge_idx.to(torch.int64)
        dst = torch.gather(a["ss_dst"], 1, idx)
        w = a.get("ss_weight")
        cand = prog.relax(src_val, None if w is None
                          else torch.gather(w, 1, idx))
        cand = torch.where(in_range & (dst < vpad), cand, self._ident)
        dst = torch.where(in_range, dst, vpad - 1)
        new = fr.scatter_reduce(label, dst, cand, prog.reduce)
        return new, prog.better(new, label) & self._vmask

    def _sparse_clear(self, active, gids, cnts, off):
        """Clear the queue prefix that every part expanded fully; the
        rest stays active (truncation safety)."""
        P, Q, vpad = self.num_parts, self.queue_cap, self.vpad
        budget = torch.full((P, 1), self.edge_budget, dtype=torch.int32,
                            device=off.device)
        done = torch.searchsorted(off, budget, side="right",
                                  out_int32=True)
        pos = torch.arange(Q, dtype=torch.int32, device=off.device)
        flat_pos = torch.arange(P, dtype=torch.int32,
                                device=off.device)[:, None] * Q + pos
        processed = ((flat_pos < done.min()) & (pos < cnts[:, None])
                     & (gids < self.nv))
        loc = (gids - self.arrays["part_start"]).clamp(0, vpad - 1)
        upd = torch.zeros((P, vpad), dtype=torch.int32, device=off.device)
        upd.scatter_reduce_(1, loc.to(torch.int64),
                            processed.to(torch.int32), "amax",
                            include_self=True)
        return active & (upd == 0)

    def _sparse(self, label, active):
        gids, vals, cnts = self._sparse_compact(label, active)
        edge_idx, src_val, in_range, off = self._sparse_expand(gids, vals)
        new, improved = self._sparse_relax(label, edge_idx, src_val,
                                           in_range)
        return new, improved | self._sparse_clear(active, gids, cnts, off)

    def _sparse_mode(self):
        """(usable, count limit): the reference's frontier > nv/16 pull
        switch (sssp_gpu.cu:414) and the queue capacity."""
        limit = min(self.queue_cap,
                    max(1, self.nv // self.sparse_threshold)) \
            if self.enable_sparse else 0
        return self.enable_sparse, limit

    def _body(self, label, active, count: int):
        """One iteration of ``active`` (host count ``count``)."""
        use_sparse, limit = self._sparse_mode()
        if use_sparse and count <= limit:
            self.schedule.append("sparse")
            return self._sparse(label, active)
        self.schedule.append("dense")
        return self._dense(label, active)

    # -- public API ----------------------------------------------------

    def step(self, label, active):
        """One iteration -> (label, active, active count as a device
        int32 scalar)."""
        label, active = self._body(label, active, self._count(active))
        return label, active, active.sum(dtype=torch.int32)

    def converge(self, label, active, max_iters: int | None = None):
        """Iterate to an empty frontier (or ``max_iters``).  Returns
        (label, active, iterations) with iterations a host int."""
        cap = INT32_MAX if max_iters is None else int(max_iters)
        self.schedule = []
        if self.delta is not None:
            return self._converge_delta(label, active, cap)
        it, cnt = 0, self._count(active)
        while cnt > 0 and it < cap:
            label, active = self._body(label, active, cnt)
            cnt = int(active.sum(dtype=torch.int32))    # the one read
            it += 1
        return label, active, it

    def _bucket(self, label, active, B):
        """Delta-stepping's bucket front on the device: B, or, when no
        active vertex lies below B, the bound advanced strictly past
        the active minimum (push.py:872-886) — the reference's advance
        pass folded into the next relax.  Returns (front, B, counts
        int32 [2] = front size, active count)."""
        front0 = active & (label < B)
        am = torch.where(active, label, self._ident).amin()
        nb = am + self._delta_t
        if label.dtype.is_floating_point:
            nb = torch.maximum(nb, torch.nextafter(
                am, torch.full_like(am, float("inf"))))
        B = torch.where(front0.any(), B, nb)
        front = active & (label < B)
        counts = torch.stack([front.sum(dtype=torch.int32),
                              active.sum(dtype=torch.int32)])
        return front, B, counts

    def _converge_delta(self, label, active, cap):
        """Delta-stepping (Meyer & Sanders): relax only the bucket
        [*, B) until it empties, then raise B.  ``it`` counts relax
        iterations only; an advance relaxes nothing.  One read of
        [front size, active count] per relax iteration, plus one
        before the first."""
        am = torch.where(active, label, self._ident).amin()
        B = am + self._delta_t
        it = 0
        while it < cap:
            front, B, counts = self._bucket(label, active, B)
            nf, cnt = counts.cpu().tolist()              # the one read
            if cnt == 0:
                break
            if nf == 0:
                continue            # labels at the identity: advance on
            nl, na = self._body(label, front, nf)
            active = (active & ~front) | na
            label = nl
            it += 1
        return label, active, it

    def run(self, max_iters: int | None = None, verbose: bool = False,
            seg_budget: float | None = None):
        """init -> converge -> host labels [nv]; returns (labels,
        iterations)."""
        if verbose:
            _refuse("run(verbose=True) (it replays device-side iteration "
                    "counters)", "A10")
        if seg_budget is not None:
            _refuse("run(seg_budget=...) (duration-budgeted segments)",
                    "A9")
        label, active = self.init_state()
        label, active, it = self.converge(label, active, max_iters)
        return self.unpad(label), it

    def timed_phases(self, label, active, iters: int = 1):
        _refuse("timed_phases (per-phase fenced programs)", "A10")
