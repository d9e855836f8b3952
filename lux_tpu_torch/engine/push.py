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

With ``health=True`` a converge takes the watchdog variant
(``converge_health``): NaN labels and the truncation-livelock stall
fold into lux_tpu_torch/health.py's word, whose flags ride the one read
an iteration.

Observability (lux_tpu/engine/push.py:1075-1160, :1182-1432):
``converge_stats`` records each iteration's frontier size and the
out-edges it relaxes (and their per-part rows) into device buffers of
``stats_cap`` rows, with no read beyond the converge's one int32 an
iteration; ``run(verbose=True)`` replays them; ``timed_phases`` runs
dense iterations phase by phase (``exchange``, ``relax``, ``reduce``
or, on paged rows, ``relax_reduce``, then ``update``), fenced, through
the methods a converge calls, sparse ones as one ``sparse`` entry, and
a delta engine's actual bucket schedule; and every iteration names its
work as profiler ranges (``lux_dense`` / ``lux_sparse`` and the
phases inside; profiling.annotation).

``use_mxu`` (default ``"auto"``, resolved by the pull engine's rule on
the partial rows alone: scalemodel.resolve_use_mxu with no layout) takes
the matrix-unit forms (lux_tpu/engine/push.py:184): the dense
residual's min / max by the one-hot tournament (ops/tiled.py) and the
sparse expansion's running owner by the cumsum as matmuls
(engine/frontier.py); ``gather="auto"`` picks the dense delivery by
scalemodel (ops/pagegather.resolve_gather).

``exchange="owner"`` (ops/owner.py; lux_tpu/engine/push.py:474-540)
runs the dense iterations owner-side: each source part masks its own
label shard and gathers from it, kernel B1 reduces every part's owner
chunks in one launch, and the contributions fold across source parts
(one ``gen_exchange`` phase); sparse iterations are unchanged.  With
``gather="paged"`` / ``"pagemajor"`` the owner paged plans replace the
owner chunks (lux_tpu/engine/push.py:505-528; ops/pagegather.py
``paged_owner_contribs``, ``pagemajor_owner_deliver``: B2 and B1 once
each a dense iteration), weighted plans carrying ``own_pg_w`` /
``own_pm_w``.
``stream_msgs`` runs the tiled dense path's gather, relax and partials
in blocks of chunks; None streams on the card only what would not fit
in its free memory, elsewhere by the reference's 1 GB rule
(ops/tiled.stream_by_default).

``audit="warn"|"error"`` runs one iteration of every program variant
under the auditor at build time (lux_tpu_torch/audit.py).  Options the
port does not carry yet raise :class:`NotPortedError` naming the
ROADMAP item that brings them.

``mesh=`` (lux_tpu/engine/push.py:102-130, :309, :333, :493-546,
:641-790, :1175) runs the engine on one rank of a parts mesh, holding
its own part rows (engine/pull.py's rules): a dense iteration
all_gathers the masked labels into the whole table (or, on the owner
exchange, all_to_alls the contributions for a local min / max, or
rings them with ``owner_minmax_fused``); a sparse one all_gathers
every rank's (vertex, label) queue, relaxes the rank's own parts and
clears the queue prefix every part expanded, agreed by a min across
ranks.  The one int32 an iteration is read after its sum across ranks,
so every rank takes the same dense-or-sparse branch and stops at the
same iteration; delta-stepping's bucket bound and counts are agreed
the same way.  ``converge_stats`` / ``converge_health``,
``timed_phases``, duration-budgeted segments and the options pull
refuses on a mesh raise :class:`NotPortedError` naming ROADMAP A6b-2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine import frontier as fr
from lux_tpu_torch.engine.program import vmask_of
from lux_tpu_torch.engine.pull import (NotPortedError, Placement, _outside,
                                       bind_mesh, build_graph_arrays,
                                       check_mesh_build,
                                       check_dense_arrays,
                                       check_owner_arrays,
                                       check_pair_arrays,
                                       common_graph_arrays, device_arrays,
                                       flat_segments, gather_rows,
                                       refuse_on_mesh, resolve_exchange,
                                       resolve_use_mxu)
from lux_tpu_torch.graph import ShardedGraph
from lux_tpu_torch.ops.collectives import (all_gather_parts,
                                           all_reduce_scalar,
                                           allreduce_host)
from lux_tpu_torch.ops.pagegather import (engine_page_plan,
                                          paged_owner_contribs, paged_partial,
                                          pagemajor_owner_deliver,
                                          plan_graph_arrays)
from lux_tpu_torch.ops.pairs import (pair_graph_arrays, pair_partial,
                                     pair_partial_streamed,
                                     plan_sharded_pairs, resolve_pair_stream)
from lux_tpu_torch.ops.owner import (OwnerLayout, owner_contribs,
                                     owner_exchange, owner_graph_arrays)
from lux_tpu_torch.ops.segment import segment_reduce
from lux_tpu_torch.ops.tiled import (combine_op, engine_lane_occupancy,
                                     segment_plan,
                                     stream_by_default,
                                     streamed_tiled_reduce,
                                     tiled_segment_reduce)
from lux_tpu_torch.parallel.mesh import mesh_device, rows_of
from lux_tpu_torch.partition import frontier_capacity
from lux_tpu_torch.profiling import annotation, device_fence
from lux_tpu_torch.telemetry import DEFAULT_STATS_CAP

INT32_MAX = int(np.iinfo(np.int32).max)

# the src-sorted view's keys (ss_weight when weighted)
SPARSE_KEYS = ("src_ids", "src_off", "ss_dst", "part_start")


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


class PushEngine(Placement):
    """Frontier iterations for one ShardedGraph + PushProgram on one
    device (``device=None`` means the card; pass ``"cpu"`` for the
    plain PyTorch versions).  ``schedule`` lists the kind ("dense" or
    "sparse") of every iteration since the last ``converge``.
    ``page_plan``: a paged or page-major plan built before on ``sg``
    for this ``gather`` and ``exchange``, shared with other engines on
    the layout (as PullEngine's)."""

    plan_seconds = 0.0      # host seconds spent building the paged or
                            # pair plan
    health = False          # converge under the watchdog (health.py)
    stats_cap = DEFAULT_STATS_CAP   # rows of the counter buffers

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
                 owner_tile_e: int | None = None,
                 owner_minmax_fused: bool = False,
                 stats_cap: int | None = None, health: bool = False,
                 page_plan=None, audit: str | None = None):
        dev = (resolve_device(device) if mesh is None
               else mesh_device(mesh, device))
        check_mesh_build(sg, mesh, batch=program.batch, health=health,
                         audit=audit, gather=gather, page_plan=page_plan)
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
            enable_sparse = False
        if stats_cap is not None and int(stats_cap) < 1:
            raise ValueError(f"stats_cap must be >= 1, got {stats_cap}")
        fr.check_use_mxu(use_mxu)
        # the auto-exchange estimate is the whole label table's bytes: a
        # B-wide batch is B tables
        ident_dt = np.asarray(program.identity).dtype
        exchange = resolve_exchange(
            exchange, sg, program,
            itemsize=ident_dt.itemsize * (program.batch or 1), device=dev)
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
        plan = engine_page_plan(sg, gather, program, exchange, page_plan)
        if plan is not None and mesh is not None:
            refuse_on_mesh(f"gather={plan.mode!r} (the paged deliveries)")
        pairs, dense_sg = None, sg
        if pair_threshold is not None:
            # the dense tiled path runs on the pair plan's residual;
            # sparse iterations keep the FULL graph's src-sorted view
            pairs, dense_sg = plan_sharded_pairs(sg, pair_threshold,
                                                 min_fill=pair_min_fill,
                                                 mesh=mesh)
        plan_seconds = time.perf_counter() - t0
        owner = None
        local = getattr(sg, "local_parts", None) is not None
        if plan is None and exchange == "owner":
            owner = OwnerLayout.build(dense_sg, E=owner_tile_e or 256,
                                      mesh=mesh)
            arrays, tiles = dict(
                common_graph_arrays(dense_sg), **owner_graph_arrays(
                    owner, owner.streams(dev, program.batch or 1))), None
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs))
        elif plan is not None:
            arrays, tiles = dict(common_graph_arrays(dense_sg),
                                 **plan_graph_arrays(plan)), None
        else:
            arrays, lay = build_graph_arrays(dense_sg, layout, tile_e)
            tiles = None if lay is None else lay.geometry
            if pairs is not None:
                arrays.update(pair_graph_arrays(pairs))
        queue_cap = eb = 0
        if enable_sparse:
            s_pad = sg.src_unique_max()
            if local:
                # a shape every rank of a local-parts build agrees on
                s_pad = int(allreduce_host(mesh, np.int64(s_pad), "max"))
            ss = sg.src_sorted(s_pad=s_pad)
            # the reference's queue sizing (push_model.inl:393-397)
            queue_cap = frontier_capacity(sg.vpad, sparse_threshold)
            # the budget covers any one source's out-edges in a part,
            # so a truncated hub always makes progress; a local-parts
            # build bounds it by the global max out-degree, the same on
            # every rank (lux_tpu/engine/push.py:293)
            max_deg = (int(sg.max_out_degree) if local
                       else sg.max_in_deg()) or 1
            default_eb = max(1024, sg.epad // sparse_threshold)
            eb = int(edge_budget if edge_budget is not None
                     else max(default_eb, max_deg + 128))
            arrays.update(src_ids=ss["src_ids"], src_off=ss["src_off"],
                          ss_dst=ss["ss_dst"],
                          part_start=sg.starts[:-1].astype(
                              np.int32)[:, None])
            if ss["ss_weight"] is not None:
                arrays["ss_weight"] = ss["ss_weight"]
        # a mesh rank keeps its own part rows
        arrays = {k: rows_of(mesh, v, sg.num_parts)
                  for k, v in arrays.items()}
        rows = sg.num_parts if mesh is None else sg.num_parts // mesh.world
        if stream_msgs is None:
            wide = (program.batch or 1) if dev.type == "cuda" else 1
            stream_msgs = stream_by_default(
                rows * dense_sg.epad * 4 * wide, dev)
        self._bind(program, arrays, tiles, nv=sg.nv, ne=sg.ne,
                   num_parts=sg.num_parts, vpad=sg.vpad, device=dev, sg=sg,
                   pages=plan, pairs=pairs, pair_stream=pair_stream,
                   enable_sparse=enable_sparse,
                   sparse_threshold=sparse_threshold, queue_cap=queue_cap,
                   edge_budget=eb, delta=delta, use_mxu=use_mxu,
                   owner=owner, stream_msgs=stream_msgs,
                   owner_minmax_fused=owner_minmax_fused, mesh=mesh)
        self.plan_seconds = plan_seconds
        self.health = bool(health)
        if stats_cap is not None:
            self.stats_cap = int(stats_cap)
        self._run_audit(audit)

    @classmethod
    def from_arrays(cls, program: PushProgram, arrays: dict, tiles, *,
                    nv: int, ne: int, num_parts: int, vpad: int,
                    queue_cap: int, edge_budget: int,
                    enable_sparse: bool = True, sparse_threshold: int = 16,
                    delta=None, device=None, pages=None, pairs=None,
                    pair_stream=None, use_mxu=False, owner=None,
                    stream_msgs=False, owner_minmax_fused=False):
        """An engine on given per-part arrays and their geometry — how
        interop.push_from_reference carries a reference engine's
        arrays across bit for bit.  The dense keys are
        PullEngine.from_arrays's (``owner`` an ops/owner.OwnerGeometry
        for the owner exchange's arrays); with sparse iterations also
        src_ids, src_off, ss_dst, part_start (+ ss_weight)."""
        eng = cls.__new__(cls)
        eng._bind(program, arrays, tiles, nv=nv, ne=ne,
                  num_parts=num_parts, vpad=vpad,
                  device=resolve_device(device), sg=None, pages=pages,
                  pairs=pairs, pair_stream=pair_stream,
                  enable_sparse=enable_sparse,
                  sparse_threshold=sparse_threshold, queue_cap=queue_cap,
                  edge_budget=edge_budget, delta=delta, use_mxu=use_mxu,
                  owner=owner, stream_msgs=stream_msgs,
                  owner_minmax_fused=owner_minmax_fused)
        return eng

    def _bind(self, program, arrays, tiles, *, nv, ne, num_parts, vpad,
              device, sg, pages, pairs, pair_stream, enable_sparse,
              sparse_threshold, queue_cap, edge_budget, delta,
              use_mxu=False, owner=None, stream_msgs=False,
              owner_minmax_fused=False, mesh=None):
        bind_mesh(self, mesh, num_parts)
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
        if pairs is not None and tiles is None and owner is None:
            raise ValueError("pair rows need the tiled layout")
        if owner is not None and (tiles is not None or pages is not None):
            raise ValueError("the owner layout replaces the tiled and "
                             "paged layouts")
        owner_pages = pages is not None and getattr(pages, "owner", False)
        if owner_pages and (tiles is not None or pairs is not None):
            raise ValueError("the owner paged plan replaces the tiled "
                             "layout and pair rows")
        # the OwnerLayout (or its OwnerGeometry); None on the gather
        # exchange and under an owner paged plan
        self.owner = owner
        self.exchange = "owner" if owner is not None or owner_pages \
            else "gather"
        self.owner_minmax_fused = bool(owner_minmax_fused)
        self.stream_chunks = bool(stream_msgs)
        self.batch = program.batch
        if self.batch is not None and (enable_sparse or pairs is not None):
            raise ValueError("query-batched push engines run dense "
                             "iterations only (no sparse queue or pair "
                             "rows)")
        self.program = program
        # the one-hot tournament for the dense reduce, and the cumsum as
        # matmuls for the sparse expansion (lux_tpu/engine/push.py:184)
        self.use_mxu = resolve_use_mxu(use_mxu, program)
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
        a, P, Pg = self.arrays, self.lp, self.num_parts
        if owner is not None:
            check_owner_arrays(a, P, vpad, owner, Pg)
            if pairs is not None:
                check_pair_arrays(a, P, vpad, pairs, Pg, self.part0)
            self._plan = segment_plan(a["own_cs"], a["own_lc"])
        else:
            check_dense_arrays(a, P, vpad, tiles, pages, pairs, Pg,
                               self.part0)
        if pages is None and owner is None:
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
        # the tournament's occupied slots, fixed by the layout
        self._occ = engine_lane_occupancy(self)

    def _check_sparse(self):
        """Shapes and index ranges of the src-sorted view, checked once
        (an out-of-range index would fault on the card)."""
        a, P = self.arrays, self.lp
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

    def _register_engine_variants(self) -> None:
        """One iteration of each program variant the reference compiles
        (lux_tpu/engine/push.py:658-694), from the init state.  The
        reference's step holds both paths (a cond); here an iteration
        takes one, so an engine that also iterates sparse registers each
        path forced too: ``step_dense`` and ``step_sparse``."""
        reg = self._register_variant
        st = self.init_state
        reg("step", self.step, st)
        if self.enable_sparse:
            reg("step_dense", lambda l, a: self._body(l, a, INT32_MAX), st)
            reg("step_sparse", lambda l, a: self._body(l, a, 0), st)
        reg("converge", lambda l, a: self.converge(l, a, 1), st)
        reg("converge_stats", lambda l, a: self.converge_stats(l, a, 1), st)
        reg("converge_health",
            lambda l, a: self.converge_health(l, a, 1), st)

    # -- state ---------------------------------------------------------

    def init_state(self):
        """(label, active) of the program's init on the device."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no graph to "
                             "initialise from; pass the state in")
        return self.place(*self.program.init(self.sg))

    def place(self, label, active):
        """Host state arrays -> (label, active) tensors on the device
        (on a mesh, this rank's rows of the global [P, vpad] arrays).
        The host counts the active mask here (across ranks on a mesh),
        so a converge from this state reads no count before its first
        iteration."""
        active = rows_of(self.mesh, np.asarray(active, dtype=bool),
                         self.num_parts)
        label = rows_of(self.mesh, np.asarray(label), self.num_parts)
        lab = torch.tensor(np.ascontiguousarray(label), device=self.device)
        act = torch.tensor(np.ascontiguousarray(active), device=self.device)
        cnt = int(np.count_nonzero(active))
        if self.mesh is not None:
            cnt = int(all_reduce_scalar(
                self.mesh, torch.tensor(cnt, dtype=torch.int64,
                                        device=self.device), "sum"))
        self._placed = (act, cnt)
        return lab, act

    def unpad(self, state: torch.Tensor) -> np.ndarray:
        """Padded device state -> [nv] user order (host)."""
        if self.sg is None:
            raise ValueError("engine built from arrays has no partition "
                             "to unpad with")
        from lux_tpu_torch.parallel.multihost import fetch_global
        return self.sg.from_padded(fetch_global(state, self.mesh,
                                                self.num_parts))

    def _global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A count summed across the mesh's ranks (itself without one):
        what every rank reads, so every rank branches alike."""
        if self.mesh is None:
            return x
        return all_reduce_scalar(self.mesh, x, "sum")

    def _active_count(self, active: torch.Tensor) -> torch.Tensor:
        """The active count as a device int32 scalar, across ranks."""
        return self._global_sum(active.sum(dtype=torch.int32))

    def _count(self, active: torch.Tensor) -> int:
        """The active count on the host: known for a state ``place``
        made, else one read of one int32."""
        if self._placed is not None and self._placed[0] is active:
            return self._placed[1]
        return int(self._active_count(active))

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
        if self.mesh is not None:
            masked = all_gather_parts(self.mesh, masked)
        return masked.reshape((-1,) + tuple(label.shape[2:]))

    def _dense_cand(self, flat):
        """Phase 2 (tiled / flat layouts): per-edge source gather +
        candidates [P, C, E] or [P, epad] (+ [B])."""
        vals = gather_rows(flat, self._src).view(
            tuple(self.arrays["src_slot"].shape) + tuple(flat.shape[1:]))
        return self._msg(vals, self.arrays.get("weight"))

    def _dense_red(self, flat, cand, upto: str | None = None):
        """Phase 3: per-destination reduce [P, vpad] (kernel B1 and the
        segmented combine, plus the pair rows; or the paged delivery,
        which fetches and reduces in one go; ``upto``, profiling, stops
        a vector state's paged delivery after that stage)."""
        a, kind, P, vpad = self.arrays, self.program.reduce, self.lp, \
            self.vpad
        if self.page_plan is not None:
            red = paged_partial(
                self.page_plan, flat, a["pg_ids"], a["pg_sl"], a["pg_rel"],
                a.get("pg_w"), a["pg_tp"], kind, self._msg,
                vrow_src=a.get("pg_vrs"), upto=upto)
            return red[:, :vpad] if upto is None else red
        if self.tiles is None:
            trail = tuple(flat.shape[1:])
            red = segment_reduce(cand.reshape((-1,) + trail), self._seg,
                                 P * (vpad + 1), kind)
            red = red.view((P, vpad + 1) + trail)[:, :vpad]
        else:
            red = tiled_segment_reduce(cand, self.tiles, a["chunk_start"],
                                       a["last_chunk"], a["rel_dst"], vpad,
                                       kind, self._plan, batch=self.batch,
                                       use_mxu=self.use_mxu, occ=self._occ)
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

    # the phases of a dense iteration (the reference's names)
    _phase_exchange = _masked_flat
    _phase_relax = _dense_cand
    _phase_reduce = _dense_red
    _phase_update = _dense_update

    def _phase_relax_reduce(self, flat):
        """relax_reduce: the paged delivery, which relaxes and reduces
        in one go, or the streamed tiled path (gather, relax and B1 a
        block of chunks at a time, then the combine and the pair
        rows)."""
        if self.page_plan is not None:
            return self._dense_red(flat, None)
        kind = self.program.reduce
        red = streamed_tiled_reduce(flat, self.arrays, self.tiles,
                                    self.vpad, kind, self._msg, self._plan,
                                    self.use_mxu, self._occ)
        if self.pairs is not None:
            red = combine_op(kind)(red, self._pair_red(flat))
        return red

    @property
    def _streams(self) -> bool:
        """Whether the tiled dense path runs streamed (``stream_msgs``)."""
        return self.stream_chunks and self.tiles is not None

    def _phase_gen_exchange(self, label, active):
        """gen_exchange: one owner dense iteration, one fused phase as in
        the reference (lux_tpu/engine/push.py:487 ``_dense_parts_owner``):
        each source part's shard masked (inactive -> identity), the owner
        contributions folded across source parts and routed, the pair
        rows from the whole masked table, the update -> (label,
        improved)."""
        kind, pp = self.program.reduce, self.page_plan
        masked = torch.where(active, label, self._ident)
        if pp is not None and pp.mode == "pagemajor":
            # the route of whole rows replaces the owner exchange
            red = pagemajor_owner_deliver(pp, masked, self.arrays, kind,
                                          self._msg)[:, :self.vpad]
            return self._dense_update(label, red)
        if pp is not None:
            acc = paged_owner_contribs(pp, masked, self.arrays, kind,
                                       self._msg, self.num_parts)
        else:
            acc = owner_contribs(self.owner, masked, self.arrays, kind,
                                 self._msg, self.num_parts,
                                 use_mxu=self.use_mxu, plan=self._plan,
                                 max_run=self._plan.max_len, occ=self._occ)
        red = owner_exchange(acc, kind, axis=self.mesh, ndev=self.ndev,
                             minmax_fused=self.owner_minmax_fused)[
            :, :self.vpad]
        if self.pairs is not None:
            if self.mesh is not None:
                masked = all_gather_parts(self.mesh, masked)
            flat = masked.reshape((-1,) + tuple(label.shape[2:]))
            red = combine_op(kind)(red, self._pair_red(flat))
        return self._dense_update(label, red)

    def _dense(self, label, active):
        if self.exchange == "owner":
            with annotation("lux_gen_exchange"):
                return self._phase_gen_exchange(label, active)
        with annotation("lux_exchange"):
            flat = self._phase_exchange(label, active)
        if self.page_plan is not None or self._streams:
            with annotation("lux_reduce"):
                red = self._phase_relax_reduce(flat)
        else:
            with annotation("lux_relax"):
                cand = self._phase_relax(flat)
            with annotation("lux_reduce"):
                red = self._phase_reduce(flat, cand)
        with annotation("lux_update"):
            return self._phase_update(label, red)

    # -- sparse iteration ----------------------------------------------

    def _sparse_compact(self, label, active):
        """Each part's mask -> (global id, label) queue [P, Q] and its
        count [P]."""
        ids, vals, cnts = fr.compact_mask(active, label, self.queue_cap)
        gids = torch.where(ids < self.vpad,
                           self.arrays["part_start"] + ids, self.nv)
        return gids, vals, cnts

    def _sparse_expand(self, gids, vals):
        """Every part expands the whole [P*Q] queue (every rank's, on a
        mesh) over its own src-sorted edges -> (edge_idx, src_val,
        in_range, off)."""
        a = self.arrays
        if self.mesh is not None:
            gids = all_gather_parts(self.mesh, gids)
            vals = all_gather_parts(self.mesh, vals)
        edge_idx, src_val, in_range, _total, off = fr.expand_frontier(
            gids.reshape(-1), vals.reshape(-1), a["src_ids"], a["src_off"],
            self.nv, self.edge_budget, use_mxu=self.use_mxu)
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
        """Clear the queue prefix that every part (of every rank)
        expanded fully; the rest stays active (truncation safety)."""
        P, Q, vpad = self.lp, self.queue_cap, self.vpad
        budget = torch.full((P, 1), self.edge_budget, dtype=torch.int32,
                            device=off.device)
        done = torch.searchsorted(off, budget, side="right",
                                  out_int32=True).min()
        if self.mesh is not None:
            done = all_reduce_scalar(self.mesh, done, "min")
        pos = torch.arange(Q, dtype=torch.int32, device=off.device)
        flat_pos = (self.part0 + torch.arange(
            P, dtype=torch.int32, device=off.device))[:, None] * Q + pos
        processed = ((flat_pos < done) & (pos < cnts[:, None])
                     & (gids < self.nv))
        loc = (gids - self.arrays["part_start"]).clamp(0, vpad - 1)
        # a count of the processed entries a slot (a sum onto zeros: the
        # sum's identity), not their max onto zeros
        upd = torch.zeros((P, vpad), dtype=torch.int32, device=off.device)
        upd.scatter_add_(1, loc.to(torch.int64), processed.to(torch.int32))
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
        with annotation(f"lux_{self.program.name or 'push'}"):
            if use_sparse and count <= limit:
                self.schedule.append("sparse")
                with annotation("lux_sparse"):
                    return self._sparse(label, active)
            self.schedule.append("dense")
            with annotation("lux_dense"):
                return self._dense(label, active)

    # -- public API ----------------------------------------------------

    def step(self, label, active):
        """One iteration -> (label, active, active count as a device
        int32 scalar)."""
        label, active = self._body(label, active, self._count(active))
        return label, active, self._active_count(active)

    def converge(self, label, active, max_iters: int | None = None):
        """Iterate to an empty frontier (or ``max_iters``).  Returns
        (label, active, iterations) with iterations a host int.  With
        ``health`` set the guarded converge runs and its word is decoded
        once at the end (``health.ensure_ok``: a trip raises
        HealthError)."""
        if not self.health:
            return self._converge(label, active, max_iters, None)
        from lux_tpu_torch import health as hw
        label, active, it, *_bufs, watch = self.converge_health(
            label, active, max_iters)
        # audit: allow(callback-in-loop) the word is read once, after
        # the loop
        hw.ensure_ok(watch, engine="push", where="push converge")
        return label, active, it

    def converge_stats(self, label, active, max_iters: int | None = None):
        """``converge`` plus the per-iteration counters -> (label,
        active, iters, frontier int32 [stats_cap], edges int64
        [stats_cap], frontier per part int32 [stats_cap, P], edges per
        part int64 [stats_cap, P]) (lux_tpu/engine/push.py:1078).
        Classic engines record the frontier after each iteration and
        the out-edges of the frontier entering it; delta engines each
        relax step's bucket front and its out-edges.  Each scalar is the
        sum of its per-part row; writes past ``stats_cap`` drop, rows
        past ``iters`` are zero (the reference's edges are uint32).  The
        loop reads the same one int32 an iteration as ``converge``."""
        if self.mesh is not None:
            refuse_on_mesh("converge_stats")
        stats = _PushStats(self, active)
        label, active, it = self._converge(label, active, max_iters, stats)
        return (label, active, it, stats.fsz, stats.fed, stats.fszp,
                stats.fedp)

    def converge_health(self, label, active, max_iters: int | None = None,
                        watch=None):
        """``converge`` under the health watchdog
        (lux_tpu/engine/push.py:651-1010): returns (label, active,
        iters, frontier buf, edges buf, frontier-parts buf, edges-parts
        buf, watch) with watch = (word int32[6], stall int32), as the
        reference's.  NaN labels trip NONFINITE_STATE (+Inf never
        does); a non-empty frontier with an unchanged count and
        bit-identical labels for ``health.STALL_N`` steps trips
        FRONTIER_STALL.  The loop stops the iteration a check trips.
        The word's flags ride the one int32 read an iteration that
        ``converge`` already makes (now [count, flags]), so the host
        syncs once an iteration still.  Counters: frontier int32 and
        out-edges int64 [stats_cap] and their per-part rows [stats_cap,
        P] (classic: the frontier after each iteration and the entering
        frontier's out-edges; delta: each relax step's bucket front);
        writes past stats_cap drop.  Pass the previous segment's
        ``watch`` back in so a stall spanning a boundary accumulates."""
        if self.mesh is not None:
            refuse_on_mesh("converge_health")
        guard = _PushGuard(self, active, watch)
        label, active, it = self._converge(label, active, max_iters, guard)
        return (label, active, it, guard.fsz, guard.fed, guard.fszp,
                guard.fedp, (guard.h, guard.stall))

    def _converge(self, label, active, max_iters, guard):
        cap = INT32_MAX if max_iters is None else int(max_iters)
        self.schedule = []
        if self.delta is not None:
            return self._converge_delta(label, active, cap, guard)
        it, cnt = 0, self._count(active)
        while cnt > 0 and it < cap:
            if guard is None:
                label, active = self._body(label, active, cnt)
                cnt = int(self._active_count(active))     # the one read
                it += 1
                continue
            guard.enter(it, active)
            nl, na = self._body(label, active, cnt)
            ncnt = na.sum(dtype=torch.int32)
            guard.frontier(it, na, ncnt)
            guard.watch(label, nl, ncnt)
            label, active = nl, na
            it += 1
            cnt, flags = guard.read(ncnt)                 # the one read
            if flags:
                break
        return label, active, it

    def _bucket(self, label, active, B):
        """Delta-stepping's bucket front on the device: B, or, when no
        active vertex lies below B, the bound advanced strictly past
        the active minimum (push.py:872-886) — the reference's advance
        pass folded into the next relax.  Returns (front, B, counts
        int32 [2] = front size, active count)."""
        front0 = active & (label < B)
        am = self._active_min(label, active)
        nb = am + self._delta_t
        if label.dtype.is_floating_point:
            nb = torch.maximum(nb, torch.nextafter(
                am, torch.full_like(am, float("inf"))))
        B = torch.where(self._global_sum(front0.sum(dtype=torch.int32))
                        > 0, B, nb)
        front = active & (label < B)
        counts = self._global_sum(torch.stack(
            [front.sum(dtype=torch.int32), active.sum(dtype=torch.int32)]))
        return front, B, counts

    def _active_min(self, label, active):
        """The least active label (the identity when none), across
        ranks."""
        am = torch.where(active, label, self._ident).amin()
        if self.mesh is None:
            return am
        return all_reduce_scalar(self.mesh, am, "min")

    def _converge_delta(self, label, active, cap, guard=None):
        """Delta-stepping (Meyer & Sanders): relax only the bucket
        [*, B) until it empties, then raise B.  ``it`` counts relax
        iterations only; an advance relaxes nothing.  One read of
        [front size, active count] (+ the health flags when guarded)
        per relax iteration, plus one before the first."""
        B = self._active_min(label, active) + self._delta_t
        it = 0
        while it < cap:
            front, B, counts = self._bucket(label, active, B)
            if guard is None:
                nf, cnt = counts.cpu().tolist()          # the one read
            else:
                nf, cnt, flags = guard.read_bucket(counts)
                if flags:
                    break
            if cnt == 0:
                break
            if nf == 0:
                continue            # labels at the identity: advance on
            if guard is not None:
                guard.enter(it, front)
                guard.frontier(it, front, counts[0])
            nl, na = self._body(label, front, nf)
            active = (active & ~front) | na
            if guard is not None:
                guard.watch_bucket(label, nl, counts, active)
            label = nl
            it += 1
        return label, active, it

    def run(self, max_iters: int | None = None, verbose: bool = False,
            seg_budget: float | None = None):
        """init -> converge -> host labels [nv]; returns (labels,
        iterations).  ``seg_budget`` (seconds) converges in
        duration-budgeted segments (segmented.DurationBudget).
        ``verbose=True`` replays the converge's device-side counters,
        one ``iter i: frontier=F edges=E`` line an iteration (a delta
        engine's relax steps), also under ``seg_budget``, where the
        counters accumulate across segments (lux_tpu/engine/push.py:
        1121-1173).  Under an active ``telemetry.use(iter_stats=)`` the
        counters land there."""
        from lux_tpu_torch import telemetry
        label, active = self.init_state()
        tel = telemetry.current()
        st = tel.iter_stats
        ctx = contextlib.nullcontext()
        if verbose and st is None:
            st = telemetry.IterStats()
            ctx = telemetry.use(events=tel.events, iter_stats=st)
        with ctx:
            if seg_budget is not None:
                if self.mesh is not None:
                    refuse_on_mesh("a duration-budgeted converge "
                                   "(seg_budget=)")
                from lux_tpu_torch.segmented import (DurationBudget,
                                                     converge_segments)
                label, active, it = converge_segments(
                    self, label, active, DurationBudget(seg_budget),
                    max_iters)
            elif self.health:
                from lux_tpu_torch import health as hw
                label, active, it, fsz, fed, fszp, fedp, watch = \
                    self.converge_health(label, active, max_iters)
                if st is not None:
                    st.begin_run()
                    st.extend_push(fsz, fed, it, fszp, fedp)
                hw.ensure_ok(watch, engine="push", where="push converge")
            elif st is not None:
                st.begin_run()
                label, active, it, fsz, fed, fszp, fedp = \
                    self.converge_stats(label, active, max_iters)
                st.extend_push(fsz, fed, it, fszp, fedp)
            else:
                label, active, it = self.converge(label, active, max_iters)
        if verbose:
            for line in st.replay_lines():
                print(line)
        return self.unpad(label), it

    # -- per-iteration phases -------------------------------------------

    def timed_phases(self, label, active, iters: int = 1):
        """``iters`` iterations, dense ones phase by phase, each phase
        fenced (a device synchronize on the card) -> (label, active,
        [{phase: seconds, "frontier": count}])
        (lux_tpu/engine/push.py:1327).  Dense iterations split into
        exchange / relax / reduce / update (relax_reduce on paged
        rows and the streamed tiled path; one ``gen_exchange`` on an
        owner engine); those the engine runs sparse are one ``sparse``
        entry.
        A delta engine runs its actual bucket schedule, each entry also
        carrying the bucket bound and the advances before it.  The
        phases are the methods a converge calls, in its order: the
        labels are a converge's of the same iterations."""
        if self.mesh is not None:
            refuse_on_mesh("timed_phases")
        device_fence(self.device)()   # the caller's queued work is no phase's
        if self.delta is not None:
            return self._timed_phases_delta(label, active, int(iters))
        self.schedule = []
        report = []
        cnt = self._count(active)
        for _ in range(int(iters)):
            t = {"frontier": cnt}
            label, active, cnt = self._relax_once(label, active, cnt, t)
            report.append(t)
        return label, active, report

    def _relax_once(self, label, active, cnt: int, t: dict):
        """One iteration of ``active`` (host count ``cnt``), its phase
        seconds into ``t`` -> (label, improved mask, its count)."""
        from lux_tpu_torch.engine.phased import PhaseTimer
        fence = device_fence(self.device)
        use_sparse, limit = self._sparse_mode()
        if use_sparse and cnt <= limit:
            self.schedule.append("sparse")
            t0 = time.perf_counter()
            label, na = self._sparse(label, active)
            fence()
            t["sparse"] = time.perf_counter() - t0
            return label, na, int(na.sum(dtype=torch.int32))
        self.schedule.append("dense")
        pt = PhaseTimer(fence)
        pt.t = t
        if self.exchange == "owner":
            label, na = pt("gen_exchange", self._phase_gen_exchange, label,
                           active)
            return label, na, int(na.sum(dtype=torch.int32))
        flat = pt("exchange", self._phase_exchange, label, active)
        if self.page_plan is not None or self._streams:
            red = pt("relax_reduce", self._phase_relax_reduce, flat)
        else:
            cand = pt("relax", self._phase_relax, flat)
            red = pt("reduce", self._phase_reduce, flat, cand)
        label, na = pt("update", self._phase_update, label, red)
        return label, na, int(na.sum(dtype=torch.int32))

    def _timed_phases_delta(self, label, active, iters: int):
        """The delta-stepping schedule of ``_converge_delta``, each relax
        step timed by phase (lux_tpu/engine/push.py:1355).  One read a
        bucket test: [front size, active count, advanced, bound]."""
        self.schedule = []
        report = []
        am = torch.where(active, label, self._ident).amin()
        B = am + self._delta_t
        it = n_adv = 0
        while it < iters:
            old = B
            front, B, counts = self._bucket(label, active, B)
            nf, cnt, moved, bound = torch.cat(
                [counts.double(), (B != old).double().reshape(1),
                 B.double().reshape(1)]).cpu().tolist()
            nf, cnt = int(nf), int(cnt)
            n_adv += int(moved)
            if cnt == 0:
                break
            if nf == 0:
                continue            # labels at the identity: advance on
            t = {"frontier": nf, "bucket": bound, "advances": n_adv}
            n_adv = 0
            label, na, _c = self._relax_once(label, front, nf, t)
            active = (active & ~front) | na
            report.append(t)
            it += 1
        return label, active, report


class _PushStats:
    """The counter buffers of one converge, written at host-known
    iteration indices; its read is the converge's one int32."""

    def __init__(self, eng, active):
        dev, P, cap = eng.device, eng.num_parts, eng.stats_cap
        self.fsz = torch.zeros((cap,), dtype=torch.int32, device=dev)
        self.fed = torch.zeros((cap,), dtype=torch.int64, device=dev)
        self.fszp = torch.zeros((cap, P), dtype=torch.int32, device=dev)
        self.fedp = torch.zeros((cap, P), dtype=torch.int64, device=dev)
        # out-degrees of the FULL graph: a pair residual's layout keeps
        # them (PageRank's apply needs them), so the dense arrays' deg
        self.deg = eng.arrays["deg"]

    def enter(self, it: int, act) -> None:
        """Out-edges of the frontier entering iteration ``it``, per part
        (batched: of the union over the query axis — one gather an edge
        serves every query)."""
        if it >= self.fed.shape[0]:
            return
        if act.dim() > 2:
            act = act.any(-1)
        ep = torch.where(act, self.deg, 0).sum(1, dtype=torch.int64)
        self.fed[it] = ep.sum()
        self.fedp[it] = ep

    def frontier(self, it: int, act, count) -> None:
        """The frontier size (classic: after the iteration; delta: the
        bucket front) and its per-part counts."""
        if it >= self.fsz.shape[0]:
            return
        self.fsz[it] = count
        self.fszp[it] = act.sum(dim=tuple(range(1, act.dim())),
                                dtype=torch.int32)

    def watch(self, old_label, new_label, new_cnt) -> None:
        """The health watch's hook (a guard's); counters keep none."""

    def watch_bucket(self, old_label, new_label, counts, active) -> None:
        """The delta loop's watch hook (a guard's)."""

    def read(self, ncnt):
        """One host read: the active count (flags 0)."""
        return int(ncnt), 0

    def read_bucket(self, counts):
        """One host read of [front size, active count] (flags 0)."""
        nf, cnt = counts.cpu().tolist()
        return nf, cnt, 0


class _PushGuard(_PushStats):
    """The device-side state of one guarded converge: the health word,
    the stall counter, the counter buffers and the entering frontier's
    count as a device scalar."""

    def __init__(self, eng, active, watch):
        from lux_tpu_torch import health as hw
        super().__init__(eng, active)
        self.hw = hw
        self.h, self.stall = watch if watch is not None else (
            hw.init_word(eng.device), hw.init_stall(eng.device))
        self.cnt = active.sum(dtype=torch.int32)

    def watch(self, old_label, new_label, new_cnt) -> None:
        self.h, self.stall = self.hw.push_update(
            self.h, self.stall, old_label, new_label, self.cnt, new_cnt)
        self.cnt = new_cnt

    def watch_bucket(self, old_label, new_label, counts, active) -> None:
        """A relax step of the bucket schedule: the stall watch compares
        the active count entering the bucket test with the one after."""
        self.cnt = counts[1]
        self.watch(old_label, new_label, active.sum(dtype=torch.int32))

    def read(self, ncnt):
        """One host read of [active count, flags]."""
        cnt, flags = torch.stack([ncnt, self.h[0]]).cpu().tolist()
        return cnt, flags

    def read_bucket(self, counts):
        """One host read of [front size, active count, flags]."""
        return tuple(torch.cat([counts, self.h[:1]]).cpu().tolist())
