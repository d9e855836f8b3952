"""Runtime memory observatory: the measured occupancy trail, the byte
ledger's drift verdicts and the admission projection (counterpart of
lux_tpu/memwatch.py).

**The occupancy trail.**  :class:`MemoryTrail` samples at segment
boundaries only (the segmented drivers' and the Server's boundary
hooks: host work, never inside a run).  On the card the sample is
``torch.cuda.memory_stats(device)``'s allocated bytes, current and
peak (grade ``measured``; a CUDA device whose stats lack those keys
raises :class:`MemoryStatsUnavailable`, it is never graded
``modeled``); on the CPU it is the byte ledger's model or the host's
resident set (grade ``modeled``).  The trail keeps the peak watermark
and a bounded series and emits ``mem_sample`` (throttleable) and
``mem_watermark`` (each new peak) events, which the flight recorder
keeps and tracing.py draws as a counter track.

**The byte ledger.**  :class:`MemoryLedger` is named integer terms and
their sum.  ``for_engine`` prices an engine by the reference's terms
(ShardedGraph.memory_report through ``report_kwargs``, this module's
copy of the reference's audit.report_kwargs derivation) with the
dtypes the port's engines hold, plus ``port_index``: the int64 index
tensors the port's eager reduce keeps (tiled combine plan, flat
segment ids, destination slots), which the reference's compiled
programs do not hold.  ``drift_verdict`` / ``check_drift`` compare a
peak with a ledger within MEM_TOL; ``engine_verdict`` compares the
bytes an engine's step takes as arguments (its graph tensors and one
state, counted from the tensors: grade ``modeled``) with the ledger's
argument side.

**Admission.**  ``projected_admission_bytes`` prices admitting B more
query columns; :class:`MemoryForecaster` projects time to full from
the trail's growth rate.

The live graph's consumer terms (``consumer_terms(live=)``,
``LiveGraph.memory_terms``) join the Server's ledger, and
``replica_ledger`` prices one fleet replica the same way (fleet.py's
memory admission).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

# sample grades: ``measured`` came from the allocator's counters on the
# card; ``modeled`` from the ledger or the host's resident set
GRADE_MEASURED = "measured"
GRADE_MODELED = "modeled"

# watermark-vs-ledger drift tolerance (the reference's, mirroring its
# compile-time ledger check): the ratio must lie in [1/(1+tol), 1+tol]
MEM_TOL = 0.5

# below this many priced argument bytes a comparison is padding-
# dominated: digests record the ledger but no verdict
MEM_CHECK_FLOOR_BYTES = 128 * 1024

# admission projection: answer-cache headroom per admitted query (one
# nv-length answer copy, int64/f64 worst case)
ANSWER_BYTES_PER_VERTEX = 8

# ledger terms that price per-iteration temporaries, not resident
# arrays (subtracted for the argument-side comparison)
TEMP_TERMS = ("graph_pair_temp", "graph_page_buffer", "graph_page_temp",
              "graph_mxu_temp", "port_messages", "port_candidates",
              "port_partials", "port_combine", "port_mxu",
              "port_pair_temp", "port_dot",
              "port_host_roundtrip", "port_owner_decode", "port_owner_acc",
              "port_owner_tiles", "port_route")

# memory_report terms the ledger prices the port's own way instead:
# ``mxu_temp``, the [C, E, W] one-hot the reference's XLA form holds
# (S9 builds none, the port's other one-hot forms a block at a time:
# eager_terms' port_mxu), and ``pair_temp``, a streamed TPU block budget
# whatever the rows, or the dot path's (pair_terms' port_pair_temp,
# dot_terms' port_dot)
REPLACED_TERMS = ("mxu_temp", "pair_temp")

# torch.cuda.memory_stats keys of the allocator's live and peak bytes
CUDA_CURRENT = "allocated_bytes.all.current"
CUDA_PEAK = "allocated_bytes.all.peak"


class MemoryDriftError(RuntimeError):
    """A peak drifted outside the stated tolerance of the byte ledger:
    an unpriced consumer is resident, or the pricing has rotted."""

    check = "mem-drift"

    def __init__(self, where: str, grade: str, measured: int,
                 ledger: int, ratio: float, tol: float):
        super().__init__(
            f"{where}: {grade} peak {measured} bytes vs unified ledger "
            f"{ledger} bytes (ratio {ratio:.2f}) outside the stated "
            f"tolerance x{1 + tol:.2f} — an unpriced consumer is "
            f"resident, or the ledger's terms have drifted from reality")
        self.where = where
        self.grade = grade
        self.measured = int(measured)
        self.ledger = int(ledger)
        self.ratio = float(ratio)
        self.tol = float(tol)


class MemoryStatsUnavailable(RuntimeError):
    """A CUDA device's allocator stats lack the current / peak keys: a
    measured sample is impossible, and a modeled one would pass a model
    off as the card's own count."""


# ---------------------------------------------------------------------
# host / device byte sources

def host_rss_bytes() -> int:
    """This process's resident set size in bytes (Linux /proc; 0 when
    unavailable): a side channel, never summed into device bytes."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def device_memory_stats(device=None):
    """``[(device, {"bytes_in_use", "peak_bytes_in_use", ...})]`` from
    ``torch.cuda.memory_stats`` on a CUDA device (the allocator's
    allocated bytes, current and peak since the last
    ``reset_peak_memory_stats``), or None on the CPU.  A CUDA device
    whose stats lack those keys raises MemoryStatsUnavailable."""
    from lux_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    if not stats or CUDA_CURRENT not in stats or CUDA_PEAK not in stats:
        raise MemoryStatsUnavailable(
            f"torch.cuda.memory_stats({dev}) has no {CUDA_CURRENT!r} / "
            f"{CUDA_PEAK!r}: the sample cannot be measured, and it is "
            f"not graded 'modeled' on a card")
    return [(str(dev), {"bytes_in_use": int(stats[CUDA_CURRENT]),
                        "peak_bytes_in_use": int(stats[CUDA_PEAK]),
                        "reserved_bytes": int(stats.get(
                            "reserved_bytes.all.current", 0))})]


# the byte size of the most recent checkpoint staging buffer
# (checkpoint._timed_save notes it; the ledger prices it)
_STAGING_BYTES = 0


def note_staging(nbytes: int) -> None:
    global _STAGING_BYTES
    _STAGING_BYTES = int(nbytes)


def staging_bytes() -> int:
    return _STAGING_BYTES


# ---------------------------------------------------------------------
# the byte ledger

def report_kwargs(eng) -> dict:
    """The ``sg.memory_report`` kwargs matching an engine's build (the
    reference's audit.report_kwargs, lux_tpu/audit.py:907): the page
    plan, the pair plan, push sparsity and the query batch."""
    from lux_tpu_torch.engine.pull import dot_kdim
    from lux_tpu_torch.engine.push import PushEngine
    is_push = isinstance(eng, PushEngine)
    kw = dict(exchange=eng.exchange)
    if getattr(eng, "page_plan", None) is not None:
        kw["page_plan"] = eng.page_plan
        if not is_push:
            kw["pair_kdim"] = dot_kdim(eng.program)
    if eng.pairs is not None:
        kw["pairs"] = eng.pairs
        if not is_push:
            kw["pair_kdim"] = dot_kdim(eng.program)
    if is_push:
        kw["push_sparse"] = bool(eng.enable_sparse)
        kw["query_batch"] = int(getattr(eng, "batch", None) or 1)
    if getattr(eng, "use_mxu", False):
        kw["use_mxu"] = True
        lay = eng.tiles or getattr(eng, "owner", None)
        if lay is not None:
            kw["mxu_tile_e"] = int(lay.E)
    return kw


def _tensor_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def port_index_tensors(eng) -> list:
    """The int64 index tensors the port's engines keep for their eager
    reduce (the tiled combine plan, the flat segment ids, destination
    slots, the one-hot tournament's lane occupancy): resident, and
    absent from the reference's programs."""
    out = []
    plan = getattr(eng, "_plan", None)
    if plan is not None:
        out += [plan.pos, plan.take, plan.empty]
    for name in ("_seg", "_dst", "_occ"):
        t = getattr(eng, name, None)
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _state_nbytes(eng) -> int:
    """Bytes of one state tensor set: pull [P, vpad, ...] of the
    program's ``state_bytes`` a vertex; push labels and the active mask
    [P, vpad, B]."""
    from lux_tpu_torch.engine.push import PushEngine
    n = eng.num_parts * eng.vpad
    if isinstance(eng, PushEngine):
        isz = np.asarray(eng.program.identity).dtype.itemsize
        return n * (eng.batch or 1) * (isz + 1)
    return n * (getattr(eng.program, "state_bytes", None) or 4)


def _makes_new_tensor(fn, dtype, weighted: bool) -> bool:
    """Whether ``fn(x, w)`` returns a new tensor rather than ``x``
    itself, probed on one element."""
    x = torch.zeros(1, dtype=dtype)
    y = fn(x, torch.ones(1, dtype=dtype) if weighted else None)
    return (not isinstance(y, torch.Tensor)
            or y.untyped_storage().data_ptr()
            != x.untyped_storage().data_ptr())


def pair_row_bytes(eng) -> int:
    """Bytes one element of a pair row holds at the delivery's peak.
    Pull: the fetched value and B1's row partial (4 + 4), and the
    message when the program's edge value makes a new tensor
    (PageRank's returns its source value).  Push: the fetched label,
    the message and B1's row partial (3 x itemsize), or, at the
    message's select, the label, its relaxed candidate when ``relax``
    makes a new tensor (components' returns its source), the identity
    mask and the selected message, whichever is more."""
    from lux_tpu_torch.engine.push import PushEngine
    weighted = "pair_weight" in eng.arrays
    prog = eng.program
    if isinstance(eng, PushEngine):
        dt = np.asarray(prog.identity).dtype
        isz = int(dt.itemsize)
        fresh = _makes_new_tensor(prog.relax, getattr(torch, dt.name),
                                  weighted)
        return max(3 * isz, (3 if fresh else 2) * isz + 1)
    fresh = _makes_new_tensor(lambda v, w: prog.edge_value(v, None, w),
                              torch.float32, weighted)
    return 4 * (3 if fresh else 2)


def pair_temp_bytes(eng) -> int:
    """The pair rows' delivery temporaries as the port allocates them
    (bytes, whole engine): ``pair_row_bytes`` over the [rows, 128] rows
    of the monolithic form (Rp rows a part), or of the streamed form's
    largest block (ops/pairs.stream_blocks: at most
    PAIR_STREAM_BLOCK_BYTES a part, where the reference prices the whole
    budget whatever the rows) with its per-slot results.  Scalar rows
    (the dot path's: ``dot_terms``)."""
    from lux_tpu_torch.ops.pairs import W, stream_blocks
    sp, P = eng.pairs, eng.num_parts
    per = pair_row_bytes(eng)
    if not eng.pair_stream:
        return P * int(sp.Rp) * W * per
    rows = max((S * L for _r, S, L in stream_blocks(sp.classes)),
               default=0)
    return P * (rows * per + int(sp.n_slots) * 4) * W


def pair_terms(eng, phase: dict) -> dict:
    """``port_pair_temp``, in place of the reference's ``pair_temp``:
    what the pair rows' phase adds above ``phase``, the residual (or
    owner) phase's temporaries, which it never coexists with.  The pair
    phase holds its delivery's temporaries (``pair_temp_bytes``), the
    residual's reduced [P, vpad] state and what its caller still holds:
    a pull step's messages, a push step's candidates (its gathered
    labels die with the relax); so the ledger prices the larger of the
    two phases."""
    from lux_tpu_torch.engine.push import PushEngine
    n = eng.num_parts * eng.vpad
    if isinstance(eng, PushEngine):
        isz = int(np.asarray(eng.program.identity).dtype.itemsize)
        held = phase.get("port_candidates", 0)
    else:
        isz = 4
        held = phase.get("port_messages", 0)
    pair = pair_temp_bytes(eng) + n * isz + held
    return {"port_pair_temp": max(0, pair - sum(phase.values()))}


def dot_block_bytes(units: int, lanes: int, kdim: int) -> int:
    """Peak bytes of one ops/dot.dot_partials block of ``units`` units
    of ``lanes`` edges: the fetched source rows [units, lanes, K] and
    destination tiles [units, 128, K], the messages and their product
    (two more [units, lanes, K]), and the larger of D [units, lanes,
    128] f32 and the one-hot sum's f32 one-hot beside its bool mask (5
    bytes an element)."""
    from lux_tpu_torch.ops.pairs import W
    return units * (3 * lanes * kdim * 4 + W * kdim * 4 + lanes * W * 5)


def dot_terms(eng) -> dict:
    """The dot path's per-iteration temporaries on the tiled layout
    (bytes, whole engine): ``port_dot``, the larger of its two phases,
    which never coexist (the chunk partials are combined before the
    pair rows run): the chunk partials [P*C, 128, K] with the larger of
    a chunk block (ops/dot.dot_partials over ``dot_block_chunks``
    chunks) and the doubling combine's three buffers; the pair rows'
    stacked partials [P*Rp, 128, K] (monolithic) with a block of
    ``dot_block_rows`` rows, or the streamed form's largest block
    (ops/pairs.dot_stream_blocks) with its per-slot sums, beside the
    combined chunk result [P, vpad, K].  It prices the reference's
    ``pair_temp`` too, which it replaces.  Paged dot engines keep the
    reference's page terms ({})."""
    from lux_tpu_torch.engine.pull import dot_kdim
    from lux_tpu_torch.ops.pairs import W, dot_stream_blocks
    t = getattr(eng, "tiles", None)
    if t is None:
        return {}
    P, K = eng.num_parts, dot_kdim(eng.program)
    n = P * t.n_chunks
    partials = n * W * K * 4
    plan = getattr(eng, "_plan", None)
    combine = 3 * partials if plan is not None and plan.max_len > 1 else 0
    peak = partials + max(dot_block_bytes(min(n, eng.dot_block_chunks),
                                          t.E, K), combine)
    sp = eng.pairs
    if sp is not None:
        red = P * eng.vpad * K * 4
        if eng.pair_dot_stream:
            rows = P * max((S * L for _r, S, L in
                            dot_stream_blocks(sp.classes, K)), default=0)
            pair = (dot_block_bytes(rows, W, K) + rows * W * K * 4
                    + P * int(sp.n_slots) * W * K * 4)
        else:
            rows = P * int(sp.Rp)
            pair = (rows * W * K * 4
                    + dot_block_bytes(min(rows, eng.dot_block_rows), W, K))
        peak = max(peak, red + pair)
    return {"port_dot": peak}


def eager_terms(eng) -> dict:
    """The per-iteration temporaries the port's eager tiled step
    allocates beyond the reference's terms, priced from the engine's
    shapes (bytes, whole engine), with the pair rows' (``pair_terms``)
    and, on the dot path, ``dot_terms`` alone:

    - ``port_messages``: the gathered source rows (the messages of a
      program whose edge value is the source value) over every chunk
      slot, [P*C*E, K*B];
    - ``port_candidates`` (push): the relaxed candidates and the
      activity mask beside the gathered labels, [P*C*E, B];
    - ``port_partials``: kernel B1's [P*C, W, K*B] partials;
    - ``port_combine``: the doubling combine's buffers when a tile
      spans chunks (the combined values, the masked select and the
      concatenation live beside the partials: three of them);
    - ``port_mxu`` (``use_mxu``): kernel S9's int32 lanes (resident),
      or the one-hot forms' blocks (ops/tiled.MXU_BLOCK_BYTES).

    Paged rows are priced by the reference's own terms (page_buffer,
    page_temp): {} for that layout, beside ``owner_page_terms`` on the
    owner exchange.  Owner engines: ``owner_terms``."""
    if getattr(eng, "dot", False):
        return dot_terms(eng)
    pp = getattr(eng, "page_plan", None)
    if getattr(eng, "owner", None) is not None:
        terms = owner_terms(eng)
    elif pp is not None and getattr(pp, "owner", False):
        terms = owner_page_terms(eng)
    elif getattr(eng, "tiles", None) is not None:
        terms = _tiled_terms(eng, eng.tiles)
    else:
        terms = {}
    if getattr(eng, "pairs", None) is not None:
        phase = {k: v for k, v in terms.items() if k in TEMP_TERMS}
        terms.update(pair_terms(eng, phase))
    return terms


def _tiled_terms(eng, tiles) -> dict:
    """eager_terms' tiled-layout part."""
    from lux_tpu_torch.engine.push import PushEngine
    is_push = isinstance(eng, PushEngine)
    wide, isz = _payload(eng)
    rows = eng.num_parts * tiles.n_chunks
    slots = rows * tiles.E
    partials = rows * tiles.W * wide * isz
    terms = {"port_messages": slots * wide * isz,
             "port_partials": partials}
    if is_push:
        terms["port_candidates"] = slots * wide * (isz + 1)
    plan = getattr(eng, "_plan", None)
    if plan is not None and plan.max_len > 1:
        terms["port_combine"] = 3 * partials
    if getattr(eng, "use_mxu", False):
        rel32 = getattr(eng, "_rel32", None)
        if rel32 is not None:
            terms["port_mxu"] = rel32.numel() * 4
        else:
            from lux_tpu_torch.ops.tiled import MXU_BLOCK_BYTES
            terms["port_mxu"] = min(MXU_BLOCK_BYTES,
                                    rows * tiles.E * tiles.W * 4)
    return terms


def _payload(eng) -> tuple:
    """(payload slices a vertex, bytes a slice) of an engine's state:
    push labels by their dtype and query batch, pull by state_bytes."""
    from lux_tpu_torch.engine.push import PushEngine
    if isinstance(eng, PushEngine):
        return (int(eng.batch or 1),
                int(np.asarray(eng.program.identity).dtype.itemsize))
    sb = getattr(eng.program, "state_bytes", None) or 4
    return max(1, sb // 4), 4


def owner_page_terms(eng) -> dict:
    """An owner paged engine's temporaries beyond the reference's page
    terms (bytes, whole engine).  The paged plan: ``port_owner_tiles``,
    the class combine's [P_src, G, 128] tile partials and the folded
    [P_dst, n_tiles * 128] accumulator beside them.  The page-major
    plan: ``port_route``, the routed copy of the senders' [P, P*Mg, 128]
    message rows, which lives beside them while the route runs."""
    pp, P = eng.page_plan, eng.num_parts
    wide, isz = _payload(eng)
    if pp.mode == "pagemajor":
        return {"port_route": P * P * pp.route * 128 * wide * isz}
    ntp = eng.vpad // 128
    return {"port_owner_tiles": (P * pp.n_tiles + P * ntp) * 128 * wide
            * isz}


def owner_terms(eng) -> dict:
    """An owner engine's terms beyond memory_report's (bytes, whole
    engine): ``port_owner_layout`` (resident: the owner arrays' bytes
    above the report's ``edge`` term, which prices epad slots only: the
    chunk padding, the chunk flags, the last-chunk table and any
    extraction plan), and the per-iteration temporaries of the
    monolithic form (a streamed layout holds one block at a time):
    ``port_owner_decode`` (a packed layout's decoded int32 slots and
    int8 lanes), ``port_messages`` (the gathered values, [P*C*E,
    K*B]), ``port_candidates`` (push: the masked labels and the
    candidates beside them), ``port_partials`` (B1's [P*C, W, K*B]):
    the gather stage, all live at B1's launch; then
    ``port_owner_acc``, what the combine stage adds above it: the
    partials with the doubling combine's three buffers (when a tile
    spans chunks), the [P, G, W] tiles and the folded [P, n_tiles * W]
    accumulator, which outlive the gather stage's slots (the two
    stages never coexist: the ledger prices the larger)."""
    from lux_tpu_torch.engine.push import PushEngine
    lay, P = eng.owner, eng.num_parts
    is_push = isinstance(eng, PushEngine)
    wide, isz = _payload(eng)
    own = _tensor_bytes(t for k, t in eng.arrays.items()
                        if k.startswith("own_"))
    edge = eng.sg.memory_report(**report_kwargs(eng))["terms_per_part"][
        "edge"] * P if eng.sg is not None else 0
    terms = {"port_owner_layout": max(0, own - edge)}
    if "own_ep" in eng.arrays:
        return terms
    slots = P * lay.n_chunks * lay.E
    partials = P * lay.n_chunks * lay.W * wide * isz
    if "own_sr" in eng.arrays:
        terms["port_owner_decode"] = slots * 5
    terms["port_messages"] = slots * wide * isz
    if is_push:
        terms["port_candidates"] = slots * wide * (isz + 1)
    terms["port_partials"] = partials
    gather = sum(v for k, v in terms.items() if k != "port_owner_layout")
    plan = getattr(eng, "_plan", None)
    combine = 3 * partials if plan is not None and plan.max_len > 1 \
        else 0
    acc = (P * lay.G + P * lay.n_tiles) * lay.W * wide * isz
    terms["port_owner_acc"] = max(0, partials + combine + acc - gather)
    return terms


class MemoryLedger:
    """Named integer byte terms -> one total.  ``argument_bytes``
    leaves out the per-iteration temporaries (TEMP_TERMS)."""

    def __init__(self, terms: dict, where: str = ""):
        self.terms = {k: int(v) for k, v in terms.items()}
        self.where = where

    @property
    def total_bytes(self) -> int:
        return sum(self.terms.values())

    def argument_bytes(self) -> int:
        return self.total_bytes - sum(self.terms.get(t, 0)
                                      for t in TEMP_TERMS)

    def __repr__(self):
        return (f"MemoryLedger({self.where or '?'}: {self.total_bytes} B "
                f"over {len(self.terms)} terms)")

    @classmethod
    def for_engine(cls, eng, where: str | None = None) -> "MemoryLedger":
        """One engine's ledger: memory_report's per-part terms times
        num_parts (``graph_<term>``), the program's wider state
        (``program_state``: state_bytes - 4 a vertex) and extra arrays
        (``program_extra``, the bytes of the engine's own ``prog_*``
        tensors), ``port_index`` (port_index_tensors) and the eager
        step's temporaries (``eager_terms``).  REPLACED_TERMS of the
        report give way to the port's own pricing."""
        if eng.sg is None:
            raise ValueError("an engine built from arrays has no graph "
                             "to price")
        P = eng.sg.num_parts
        rep = eng.sg.memory_report(**report_kwargs(eng))
        terms = {f"graph_{k}": P * v
                 for k, v in rep["terms_per_part"].items()
                 if v and k not in REPLACED_TERMS}
        sb = getattr(eng.program, "state_bytes", None)
        if sb:
            terms["program_state"] = P * eng.sg.vpad * (sb - 4)
        extra = [t for k, t in eng.arrays.items() if k.startswith("prog_")]
        if extra:
            terms["program_extra"] = _tensor_bytes(extra)
        idx = _tensor_bytes(port_index_tensors(eng))
        if idx:
            terms["port_index"] = idx
        terms.update(eager_terms(eng))
        return cls(terms, where or type(eng).__name__)

    @classmethod
    def for_server(cls, server, where: str | None = None
                   ) -> "MemoryLedger":
        """A serving tier's ledger: every built runner engine's resident
        terms (prefixed by its kind), the per-iteration temporaries of
        the runner with the most of them (the runners step one at a
        time, so theirs never coexist), among them its host round trip
        (a boundary re-places the [P, vpad, B] state on the card beside
        the one it replaces: two states, ``port_host_roundtrip``), and
        the dynamic consumers (the answer cache, the live graph,
        checkpoint staging)."""
        return cls._runners_ledger(
            getattr(server, "_runners", None) or {},
            getattr(server, "cache", None), getattr(server, "live", None),
            where or type(server).__name__)

    @classmethod
    def _runners_ledger(cls, runners: dict, cache, live,
                        where: str) -> "MemoryLedger":
        terms: dict = {}
        temps: dict = {}
        for kind, runner in sorted(runners.items()):
            eng = getattr(runner, "eng", None)
            if eng is None:
                continue
            own = dict(cls.for_engine(eng).terms,
                       port_host_roundtrip=2 * _state_nbytes(eng))
            for k, v in own.items():
                (temps.setdefault(kind, {}) if k in TEMP_TERMS
                 else terms)[f"{kind}_{k}"] = v
        if temps:
            terms.update(max(temps.values(), key=lambda t: sum(t.values())))
        terms.update(consumer_terms(cache=cache, live=live))
        return cls(terms, where)


def consumer_terms(cache=None, live=None) -> dict:
    """The dynamic consumer terms: the answer cache's own byte count,
    the live graph's terms (LiveGraph.memory_terms) and the last
    checkpoint staging buffer."""
    terms: dict = {}
    if cache is not None:
        terms["cache"] = int(cache.bytes)
    if live is not None:
        terms.update(live.memory_terms())
    if _STAGING_BYTES:
        terms["checkpoint_staging"] = _STAGING_BYTES
    return terms


def replica_ledger(fleet, rep) -> MemoryLedger:
    """One fleet replica's ledger (lux_tpu/memwatch.py:295): its built
    runners' terms as ``MemoryLedger.for_server`` prices a Server's, plus
    the fleet-shared cache and live graph, which every in-process
    replica's budget must absorb.  A subprocess replica prices only what
    the parent sees: the shared consumers."""
    return MemoryLedger._runners_ledger(
        getattr(rep, "_runners", None) or {}, fleet.cache, fleet.live,
        f"replica:{rep.name}")


# ---------------------------------------------------------------------
# drift verdicts and the bench digest

def drift_verdict(measured: int, ledger_bytes: int, *, grade: str,
                  where: str = "", tol: float = MEM_TOL) -> dict:
    """One peak-vs-ledger comparison -> a JSON-serializable verdict
    (``errors`` is 1 when the ratio leaves [1/(1+tol), 1+tol])."""
    measured = int(measured)
    ledger_bytes = int(ledger_bytes)
    ratio = measured / max(1, ledger_bytes)
    ok = 1.0 / (1.0 + tol) <= ratio <= 1.0 + tol
    return {"where": where, "grade": grade, "peak_bytes": measured,
            "ledger_bytes": ledger_bytes, "ratio": round(ratio, 4),
            "tol": tol, "errors": 0 if ok else 1, "warnings": 0}


def check_drift(measured: int, ledger: MemoryLedger, *, grade: str,
                where: str = "", tol: float = MEM_TOL,
                mode: str = "error") -> dict:
    """drift_verdict, raising MemoryDriftError on a failing verdict
    under ``mode="error"`` and warning under ``mode="warn"``."""
    import warnings as _warnings

    v = drift_verdict(measured, ledger.total_bytes, grade=grade,
                      where=where or ledger.where, tol=tol)
    if v["errors"]:
        err = MemoryDriftError(v["where"], grade, measured,
                               ledger.total_bytes, v["ratio"], tol)
        if mode == "error":
            raise err
        _warnings.warn(str(err), stacklevel=2)
    return v


def state_bytes(eng) -> int:
    """Bytes of one state of the engine (pull: the program's state;
    push: labels and the active mask), from its shape, without making
    it."""
    from lux_tpu_torch.engine.push import PushEngine
    n = eng.num_parts * eng.vpad * (getattr(eng, "batch", None) or 1)
    if isinstance(eng, PushEngine):
        return n * (np.asarray(eng.program.identity).dtype.itemsize + 1)
    return eng.num_parts * eng.vpad * (
        getattr(eng.program, "state_bytes", None) or 4) * (
        getattr(eng, "batch", None) or 1)


def argument_bytes(eng) -> int:
    """What one step takes as arguments: the engine's graph tensors,
    its index tensors and one state (the port's counterpart of XLA's
    argument bytes)."""
    return (_tensor_bytes(list(eng.arrays.values())
                          + port_index_tensors(eng)) + state_bytes(eng))


def engine_verdict(eng, *, ledger: MemoryLedger | None = None,
                   tol: float = MEM_TOL, mode: str = "warn",
                   where: str | None = None) -> dict:
    """An engine build's drift verdict: ``argument_bytes`` (counted
    from the tensors, grade ``modeled``: not a device watermark)
    against the ledger's argument side."""
    where = where or type(eng).__name__
    ledger = ledger or MemoryLedger.for_engine(eng, where)
    measured = argument_bytes(eng)
    v = drift_verdict(measured, ledger.argument_bytes(),
                      grade=GRADE_MODELED, where=where, tol=tol)
    if v["errors"] and mode == "error":
        raise MemoryDriftError(where, GRADE_MODELED, measured,
                               ledger.argument_bytes(), v["ratio"], tol)
    return v


def bench_digest(eng, *, trail: "MemoryTrail | None" = None,
                 consumers: dict | None = None,
                 tol: float = MEM_TOL) -> dict:
    """The ``mem`` digest of a run: the measured trail's peak against
    the full ledger when a measured trail exists, else
    ``engine_verdict``; consumer terms widen the measured comparison
    and are reported as ``consumer_bytes``.  Below
    MEM_CHECK_FLOOR_BYTES of priced arguments a failing verdict is
    recorded as a warning (padding-dominated shape)."""
    eng_ledger = MemoryLedger.for_engine(eng)
    ledger = MemoryLedger(dict(eng_ledger.terms), eng_ledger.where)
    if consumers:
        ledger.terms.update({k: int(v) for k, v in consumers.items()})
    if trail is not None and trail.grade == GRADE_MEASURED \
            and trail.peak_bytes:
        v = drift_verdict(trail.peak_bytes, ledger.total_bytes,
                          grade=GRADE_MEASURED, where=ledger.where, tol=tol)
    else:
        v = engine_verdict(eng, ledger=eng_ledger, tol=tol, mode="warn")
    if consumers:
        v["consumer_bytes"] = sum(int(x) for x in consumers.values())
    if v.get("errors") \
            and eng_ledger.argument_bytes() < MEM_CHECK_FLOOR_BYTES:
        v["errors"] = 0
        v["warnings"] = v.get("warnings", 0) + 1
        v["skipped"] = "below check floor (padding-dominated shape)"
    return v


# ---------------------------------------------------------------------
# the time-to-full forecaster

class MemoryForecaster:
    """A pure policy over the occupancy growth rate: ``record`` takes
    (live bytes, time) at each boundary sample and returns ``decide``'s
    verdict, ``fired`` True only on the ok -> pressure crossing."""

    def __init__(self, budget_bytes: int, *, horizon_s: float = 5.0,
                 window: int = 8, clock=time.monotonic):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got "
                             f"{budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.horizon_s = float(horizon_s)
        self.clock = clock
        self.samples: collections.deque = collections.deque(
            maxlen=max(2, int(window)))
        self.pressed = False         # hysteresis latch
        self.pressures = 0           # crossings signalled

    def record(self, live_bytes: int, t: float | None = None) -> dict:
        self.samples.append((self.clock() if t is None else float(t),
                             int(live_bytes)))
        d = self.decide()
        was = self.pressed
        self.pressed = d["action"] == "pressure"
        d["fired"] = self.pressed and not was
        if d["fired"]:
            self.pressures += 1
        return d

    def rate_bytes_per_s(self) -> float:
        """Growth over the window, first to last sample."""
        if len(self.samples) < 2:
            return 0.0
        (t0, b0), (t1, b1) = self.samples[0], self.samples[-1]
        if t1 <= t0:
            return 0.0
        return (b1 - b0) / (t1 - t0)

    def time_to_full_s(self) -> float:
        if not self.samples:
            return float("inf")
        head = self.budget_bytes - self.samples[-1][1]
        if head <= 0:
            return 0.0
        rate = self.rate_bytes_per_s()
        if rate <= 0:
            return float("inf")
        return head / rate

    def burn(self) -> float:
        """The share of the remaining budget one horizon consumes at the
        current rate (> 1: gone within the horizon)."""
        if not self.samples:
            return 0.0
        head = max(1, self.budget_bytes - self.samples[-1][1])
        return max(0.0, self.rate_bytes_per_s()) * self.horizon_s / head

    def decide(self) -> dict:
        """no samples -> ok; over budget -> pressure(over_budget); full
        within the horizon -> pressure(time_to_full); else ok."""
        if not self.samples:
            return {"action": "ok", "reason": "empty", "live_bytes": 0,
                    "budget_bytes": self.budget_bytes,
                    "rate_bytes_per_s": 0.0, "time_to_full_s": None,
                    "horizon_s": self.horizon_s, "burn": 0.0}
        live = self.samples[-1][1]
        ttf = self.time_to_full_s()
        base = {"live_bytes": live, "budget_bytes": self.budget_bytes,
                "rate_bytes_per_s": round(self.rate_bytes_per_s(), 2),
                "time_to_full_s": (None if ttf == float("inf")
                                   else round(ttf, 4)),
                "horizon_s": self.horizon_s, "burn": round(self.burn(), 4)}
        if live >= self.budget_bytes:
            return {"action": "pressure", "reason": "over_budget", **base}
        if ttf <= self.horizon_s:
            return {"action": "pressure", "reason": "time_to_full", **base}
        return {"action": "ok", "reason": "headroom", **base}


# ---------------------------------------------------------------------
# the boundary sampler

@dataclasses.dataclass(frozen=True)
class MemorySample:
    t: float
    where: str
    grade: str
    live_bytes: int
    peak_bytes: int
    host_rss_bytes: int


class MemoryTrail:
    """An occupancy trail fed at segment boundaries.  ``device`` (None
    means the card, as everywhere in the port) picks the source: a CUDA
    device's allocator stats (``measured``), or on the CPU ``bytes_fn``
    (a ledger total, ``modeled``) or the host's resident set
    (``modeled``, ``source`` "rss")."""

    def __init__(self, *, device=None, bytes_fn=None, metrics=None,
                 replica: str | None = None,
                 budget_bytes: int | None = None, horizon_s: float = 5.0,
                 clock=time.monotonic, emit_every: int = 1,
                 keep: int = 256):
        from lux_tpu_torch.device import resolve_device
        self.device = resolve_device(device)
        self.bytes_fn = bytes_fn
        self.metrics = metrics
        self.replica = replica
        self.clock = clock
        self.emit_every = max(1, int(emit_every))
        self.samples: collections.deque = collections.deque(
            maxlen=max(1, int(keep)))
        self.peak_bytes = 0
        self.grade: str | None = None
        self.count = 0
        self.forecaster = (None if budget_bytes is None else
                           MemoryForecaster(budget_bytes,
                                            horizon_s=horizon_s,
                                            clock=clock))

    def _labels(self) -> dict:
        return {} if self.replica is None else {"replica": self.replica}

    def sample(self, where: str = "") -> MemorySample:
        from lux_tpu_torch import telemetry

        t = self.clock()
        stats = device_memory_stats(self.device)
        if stats is not None:
            grade, source = GRADE_MEASURED, "memory_stats"
            live = sum(s["bytes_in_use"] for _, s in stats)
            dev_peak = max(s["peak_bytes_in_use"] for _, s in stats)
        elif self.bytes_fn is not None:
            grade, source = GRADE_MODELED, "ledger"
            live, dev_peak = int(self.bytes_fn()), 0
        else:
            grade, source = GRADE_MODELED, "rss"
            live, dev_peak = host_rss_bytes(), 0
        rss = host_rss_bytes()
        self.grade = grade
        new_peak = max(live, dev_peak)
        rose = new_peak > self.peak_bytes
        if rose:
            self.peak_bytes = new_peak
        s = MemorySample(t=t, where=where, grade=grade, live_bytes=live,
                         peak_bytes=self.peak_bytes, host_rss_bytes=rss)
        self.samples.append(s)
        self.count += 1
        telemetry.emit_sampled(
            "mem_sample", every=self.emit_every, where=where, grade=grade,
            source=source, live_bytes=live, peak_bytes=self.peak_bytes,
            host_rss_bytes=rss, **self._labels())
        if rose:
            # never throttled: the peak series is the verdict's side
            telemetry.current().emit(
                "mem_watermark", where=where, grade=grade,
                peak_bytes=self.peak_bytes, live_bytes=live,
                **self._labels())
        if self.metrics is not None:
            self.metrics.gauge("mem_live_bytes", **self._labels()).set(live)
            self.metrics.gauge("mem_peak_bytes",
                               **self._labels()).set_max(self.peak_bytes)
        if self.forecaster is not None:
            d = self.forecaster.record(live, t=t)
            if self.metrics is not None:
                self.metrics.gauge("mem_burn",
                                   **self._labels()).set(d["burn"])
            if d["fired"]:
                telemetry.current().emit(
                    "mem_pressure", where=where, grade=grade,
                    reason=d["reason"], live_bytes=d["live_bytes"],
                    budget_bytes=d["budget_bytes"],
                    rate_bytes_per_s=d["rate_bytes_per_s"],
                    time_to_full_s=d["time_to_full_s"],
                    horizon_s=d["horizon_s"], burn=d["burn"],
                    **self._labels())
        return s

    def snapshot(self) -> dict:
        """A JSON-serializable summary (the flight recorder's)."""
        return {"grade": self.grade, "samples": self.count,
                "peak_bytes": self.peak_bytes, "replica": self.replica,
                "series": [dataclasses.asdict(s)
                           for s in list(self.samples)[-32:]]}


# ---------------------------------------------------------------------
# the admission projection

def column_state_bytes(eng) -> int:
    """Resident state of one query column of a batched engine: a 4-byte
    label or rank and a 1-byte active mask per vertex slot (pull
    engines carry no mask: 1 B a vertex over, the safe side)."""
    return int(eng.sg.num_parts) * int(eng.sg.vpad) * 5


def projected_admission_bytes(current_bytes: int, *, batch: int,
                              column_bytes: int,
                              answer_bytes: int = 0) -> int:
    """Resident bytes after admitting ``batch`` more columns: the
    current ledger total plus their state columns and the answer-cache
    copies their retirements make."""
    return int(current_bytes) \
        + max(0, int(batch)) * (int(column_bytes) + int(answer_bytes))
