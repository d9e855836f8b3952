"""Multi-query serving: request batching and continuous refill
(counterpart of lux_tpu/serve.py:96-1528).

The engines carry a query axis (state [P, vpad, B]), so one state
gather an edge serves every query of a batch.  This module is the
continuous-batching layer above them:

- a **request queue** (``Server.submit`` / ``BatchCollector``): each
  request is one query (a source vertex, or a reset distribution for
  personalized PageRank); the collector hands over up to B queries, or
  what has arrived when its deadline expires;
- a **runner** per query kind holding ONE batched engine of B columns.
  Queries occupy columns; a free column is idle (push: all-inactive, so
  it offers the reduce identity through the ordinary pre-gather mask;
  pull: a uniform-reset column whose updates nobody reads);
- segments run on the segmented drivers (segmented.py): push kinds
  through ``converge_segments``, pull kinds through ``run_segments``,
  with the refill as their ``on_segment`` hook.  At each boundary the
  hook RETIRES converged columns (push: the column's frontier is
  empty; pull: the column's state changed by at most ``tol`` over the
  segment), hands their answers to per-query :class:`Response`
  objects and REFILLS the freed columns from the queue (pull refills
  swap the column's reset vector in place,
  ``PullEngine.update_program_arrays``).  The state comes to the host
  only at boundaries that retire or fill (push) or to measure the
  residual (pull), as in the reference;
- per-query telemetry events (``query_enqueue`` / ``query_start`` /
  ``query_done`` / ``serve_refill``) and host-side metrics at segment
  boundaries (metrics.py): queue depth, wait, occupancy, refills,
  per-kind latency histograms and, with ``slo_ms``, SLO good/violation
  counters and a rolling burn-rate gauge.

``on_boundary(runner)`` fires at the top of every boundary and
``replica`` labels a runner's events and gauges (the hooks a fleet of
servers would use).  Not ported yet, each raising NotPortedError:
live graphs (``live=``, ``mutate``, ``refresh_live``,
``admission_epoch``, ``admit_query``: ROADMAP A11; with them the
admission epochs that key the reference's answer cache), the memory
trail (``mem=``: A10), the health watchdog (``health=True``: A9) and a
device mesh (``mesh``: A6).

Smoke: ``python -m lux_tpu_torch.serve [-device cpu]`` builds a small
random graph, enqueues 2B mixed queries, drains them through
continuous-batching refill and checks every answer against the apps'
batched NumPy oracles (exit 1 on any mismatch).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue as _queuemod
import threading
import time
from typing import Callable

import numpy as np

from lux_tpu_torch import telemetry
from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.pull import NotPortedError

DEFAULT_SEG_ITERS = 4
KINDS = ("sssp", "components", "pagerank")

# rolling SLO burn-rate window: the violating fraction over the last
# SLO_WINDOW retirements of a kind
SLO_WINDOW = 64


def _refuse(what: str, item: str):
    raise NotPortedError(f"{what} is not ported yet (ROADMAP {item}); the "
                         f"port's Server serves a static graph on one "
                         f"device")


@dataclasses.dataclass
class Request:
    """One query: ``source`` for sssp/components (and one-hot
    pagerank); ``reset`` [nv] overrides it for personalized pagerank.
    ``priority`` / ``deadline_s`` are admission fields
    (``PriorityCollector`` orders by them; a plain Server ignores
    them)."""
    qid: int
    kind: str
    source: int | None = None
    reset: np.ndarray | None = None
    t_enqueue: float = 0.0
    priority: int = 0
    deadline_s: float | None = None


@dataclasses.dataclass
class Response:
    qid: int
    kind: str
    source: int | None
    answer: np.ndarray          # [nv] labels / distances / ranks
    iters: int                  # engine iterations while resident
    segments: int               # boundaries the query lived through
    latency_s: float            # enqueue -> retire
    wait_s: float               # enqueue -> column assignment
    converged: bool = True      # False: retired on the segment cap
    cached: bool = False        # served from the answer cache


class _Drained(Exception):
    """Raised by the pull hook when the queue is empty and every
    column is idle: the documented ``on_segment`` stop of
    ``segmented.run_segments``."""


class BatchCollector:
    """Thread-safe request queue + the collect-up-to-B-or-deadline
    rule.  ``collect(n, deadline_s)`` returns up to ``n`` requests,
    waiting at most ``deadline_s`` for the FIRST one and then taking
    only what has already arrived (a deadline of 0 never blocks).
    With ``metrics``/``kind`` set, ``put`` and ``collect`` keep the
    ``serve_queue_depth`` gauge current and ``collect`` observes each
    request's queue wait into ``serve_wait_seconds``; ``replica``
    labels the depth gauge."""

    def __init__(self, metrics=None, kind: str | None = None,
                 replica: str | None = None):
        self._q: _queuemod.Queue = _queuemod.Queue()
        self.metrics = metrics
        self.kind = kind
        self.replica = replica

    def _labels(self) -> dict:
        if self.replica is None:
            return {"kind": self.kind}
        return {"kind": self.kind, "replica": self.replica}

    def _depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("serve_queue_depth",
                               **self._labels()).set(len(self))

    def put(self, req: Request) -> None:
        self._q.put(req)
        self._depth()

    def __len__(self) -> int:
        return self._q.qsize()

    def _observe_wait(self, out: list) -> None:
        if self.metrics is None:
            return
        self._depth()
        now = time.monotonic()
        wait = self.metrics.histogram("serve_wait_seconds", kind=self.kind)
        for req in out:
            wait.observe(max(0.0, now - req.t_enqueue))

    def collect(self, n: int, deadline_s: float = 0.0) -> list[Request]:
        out: list[Request] = []
        deadline = time.monotonic() + max(0.0, deadline_s)
        while len(out) < n:
            timeout = deadline - time.monotonic()
            try:
                if not out and timeout > 0:
                    out.append(self._q.get(timeout=timeout))
                else:
                    out.append(self._q.get_nowait())
            except _queuemod.Empty:
                break
        self._observe_wait(out)
        return out


class PriorityCollector(BatchCollector):
    """Deadline-priority request queue: requests collect highest
    ``priority`` first, FIFO within a priority, EXCEPT that a request
    already past half its ``deadline_s`` is AGED and outranks every
    un-aged one (aged requests among themselves: earliest absolute
    deadline first, then FIFO).  The aging bounds a displaced
    request's extra wait by half its own deadline plus one collection
    round.  ``collect``'s deadline semantics are the base class's."""

    def __init__(self, metrics=None, kind: str | None = None,
                 replica: str | None = None,
                 now: Callable[[], float] = time.monotonic):
        # no base queue: collection is a sort of this list
        self.metrics = metrics
        self.kind = kind
        self.replica = replica
        self.now = now
        self._items: list[Request] = []
        self._cv = threading.Condition()

    def put(self, req: Request) -> None:
        with self._cv:
            self._items.append(req)
            self._cv.notify()
        self._depth()

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def _key(self, idx: int, req: Request, now: float):
        aged = (req.deadline_s is not None
                and now - req.t_enqueue >= 0.5 * req.deadline_s)
        if aged:
            return (0, req.t_enqueue + req.deadline_s, idx)
        return (1, -int(req.priority), idx)

    def collect(self, n: int, deadline_s: float = 0.0) -> list[Request]:
        deadline = time.monotonic() + max(0.0, deadline_s)
        with self._cv:
            while not self._items:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                self._cv.wait(timeout)
            now = self.now()
            order = sorted(range(len(self._items)),
                           key=lambda i: self._key(i, self._items[i], now))
            take = order[:max(0, n)]
            out = [self._items[i] for i in take]
            for i in sorted(take, reverse=True):
                del self._items[i]
        self._observe_wait(out)
        return out


# the answer cache's TTL with a per-kind SLO: an answer this many times
# older than the kind's latency target is stale by the operator's own
# standard; without an SLO entries live until evicted
CACHE_TTL_SLO_MULT = 50.0
CACHE_MAX_ENTRIES = 4096
# each entry copies a whole nv-length answer, so the byte budget is the
# binding cap on big graphs and the entry count on small ones
CACHE_MAX_BYTES = 256 * 1024 * 1024


@dataclasses.dataclass
class _CacheEntry:
    answer: np.ndarray
    iters: int
    t: float


class AnswerCache:
    """(kind, source or reset digest) -> answer cache for a static
    graph (the reference keys live graphs' entries by admission epoch
    too: ROADMAP A11).  ``ttl_s`` per kind bounds an entry's age; least
    recently used entries go past ``max_entries`` or ``max_bytes``.
    Thread-safe (submit threads look up while the drain thread
    inserts)."""

    def __init__(self, ttl_s: dict | None = None,
                 max_entries: int = CACHE_MAX_ENTRIES,
                 max_bytes: int = CACHE_MAX_BYTES):
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.ttl_s = dict(ttl_s or {})
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.bytes = 0              # sum of the cached answers' nbytes
        self.hits = 0
        self.misses = 0
        self._gauge = None

    def set_metrics(self, registry, replica: str | None = None):
        """Mirror the byte ledger into a ``serve_cache_bytes`` gauge of
        ``registry`` (None: no gauge)."""
        labels = {} if replica is None else {"replica": replica}
        self._gauge = (None if registry is None
                       else registry.gauge("serve_cache_bytes", **labels))
        self._sync_gauge()

    def _sync_gauge(self) -> None:
        if self._gauge is not None:
            self._gauge.set(self.bytes)

    def _pop(self, key) -> None:
        """Drop one entry, keeping the byte ledger exact (the caller
        holds the lock)."""
        ent = self._d.pop(key)
        self.bytes -= ent.answer.nbytes
        self._sync_gauge()

    @classmethod
    def from_slo(cls, slo_ms: dict | None) -> "AnswerCache":
        """TTLs of ``CACHE_TTL_SLO_MULT`` x each kind's latency target:
        the one construction rule behind ``Server(cache=True)``."""
        return cls(ttl_s={k: CACHE_TTL_SLO_MULT * v / 1e3
                          for k, v in (slo_ms or {}).items()})

    @staticmethod
    def query_key(req: Request):
        # memoized per request: the reset digest hashes a whole
        # nv-length vector, and a lookup then an insert would pay it
        # twice inside the measured latency
        key = getattr(req, "_cache_key", None)
        if key is not None:
            return key
        if req.reset is not None:
            buf = np.ascontiguousarray(req.reset, np.float32).tobytes()
            # a 128-bit digest: two resets colliding would serve each
            # other's answers, silently wrong
            key = ("reset", hashlib.blake2b(buf, digest_size=16).digest(),
                   len(buf))
        else:
            key = ("source", req.source)
        req._cache_key = key
        return key

    def get(self, kind: str, req: Request,
            now: float) -> _CacheEntry | None:
        key = (kind, self.query_key(req))
        ttl = self.ttl_s.get(kind)
        with self._lock:
            ent = self._d.get(key)
            if ent is not None and ttl is not None and now - ent.t > ttl:
                self._pop(key)          # expired: a miss, and forgotten
                ent = None
            if ent is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)    # a hit renews recency
            self.hits += 1
            return ent

    def put(self, kind: str, req: Request, answer: np.ndarray, iters: int,
            now: float) -> None:
        key = (kind, self.query_key(req))
        ent = _CacheEntry(np.asarray(answer).copy(), int(iters), now)
        with self._lock:
            old = self._d.get(key)
            if old is not None:
                self.bytes -= old.answer.nbytes
            self._d[key] = ent
            self._d.move_to_end(key)
            self.bytes += ent.answer.nbytes
            self._sync_gauge()
            while len(self._d) > 1 and (len(self._d) > self.max_entries
                                        or self.bytes > self.max_bytes):
                self._pop(next(iter(self._d)))


def admission_epoch(live, kind: str):
    """The epoch a query would pin on a live graph: ROADMAP A11."""
    _refuse("live graphs (admission_epoch)", "A11")


def admit_query(live, kind: str):
    """Atomic admission on a live graph: ROADMAP A11."""
    _refuse("live graphs (admit_query)", "A11")


@dataclasses.dataclass
class _Slot:
    req: Request
    t_start: float
    iter_start: int
    segments: int = 0


def _emit(event: str, **fields):
    telemetry.current().emit(event, **fields)


class _RunnerBase:
    """Column bookkeeping for one batched engine of width B."""

    def __init__(self, kind: str, B: int, seg_iters: int,
                 max_segments: int, metrics=None,
                 slo_ms: float | None = None, cache=None):
        self.kind = kind
        self.B = int(B)
        self.seg_iters = int(seg_iters)
        self.max_segments = int(max_segments)
        self.slots: list[_Slot | None] = [None] * self.B
        self.responses: list[Response] = []
        self.metrics = metrics
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.cache = cache
        # serving-tier hooks: ``replica`` labels the runner's events and
        # gauges; ``on_boundary(runner)`` fires at the top of every
        # segment boundary (an exception raised there leaves drain())
        self.replica: str | None = None
        self.on_boundary: Callable | None = None
        # rolling SLO window: True per retirement = a violation
        self._slo_window = collections.deque(maxlen=SLO_WINDOW)
        self.boundaries = 0         # segment boundaries seen
        self.refills = 0            # boundaries that retired AND filled

    def _rep(self) -> dict:
        return {} if self.replica is None else {"replica": self.replica}

    def _free_cols(self):
        return [c for c, s in enumerate(self.slots) if s is None]

    def _occupied(self):
        return [c for c, s in enumerate(self.slots) if s is not None]

    def _start(self, col: int, req: Request, total_iters: int):
        now = time.monotonic()
        self.slots[col] = _Slot(req=req, t_start=now,
                                iter_start=total_iters)
        _emit("query_start", qid=req.qid, query_kind=self.kind, col=col,
              wait_s=round(now - req.t_enqueue, 6), **self._rep())

    def _account(self, resp: Response, converged: bool) -> dict:
        """The latency histogram, retirement counters and SLO series
        of one response; returns its SLO fields for the event."""
        slo = {}
        if self.slo_ms is not None:
            ok = resp.latency_s * 1e3 <= self.slo_ms
            slo = {"slo_ms": self.slo_ms, "slo_ok": ok}
            self._slo_window.append(not ok)
        if self.metrics is not None:
            m = self.metrics
            m.histogram("serve_latency_seconds",
                        kind=self.kind).observe(resp.latency_s)
            m.counter("serve_retired_total", kind=self.kind).inc()
            if not converged:
                m.counter("serve_segment_cap_total", kind=self.kind).inc()
            if self.slo_ms is not None:
                m.counter("serve_slo_good_total" if slo["slo_ok"]
                          else "serve_slo_violation_total",
                          kind=self.kind).inc()
        return slo

    def _retire(self, col: int, answer: np.ndarray, total_iters: int,
                converged: bool = True):
        slot = self.slots[col]
        self.slots[col] = None
        now = time.monotonic()
        resp = Response(
            qid=slot.req.qid, kind=self.kind, source=slot.req.source,
            answer=answer, iters=total_iters - slot.iter_start,
            segments=slot.segments, latency_s=now - slot.req.t_enqueue,
            wait_s=slot.t_start - slot.req.t_enqueue, converged=converged)
        self.responses.append(resp)
        if self.cache is not None and converged:
            self.cache.put(self.kind, slot.req, answer, resp.iters, now)
        slo = self._account(resp, converged)
        if self.metrics is not None and self.slo_ms is not None:
            burn = sum(self._slo_window) / max(1, len(self._slo_window))
            self.metrics.gauge("serve_slo_burn_rate",
                               kind=self.kind).set(burn)
        _emit("query_done", qid=resp.qid, query_kind=self.kind, col=col,
              iters=resp.iters, segments=resp.segments,
              latency_s=round(resp.latency_s, 6),
              wait_s=round(resp.wait_s, 6), converged=converged, **slo,
              **self._rep())
        return resp

    def _serve_cached(self, req: Request) -> bool:
        """Answer ``req`` from the answer cache when it can, with no
        column and no engine work."""
        if self.cache is None:
            return False
        now = time.monotonic()
        ent = self.cache.get(self.kind, req, now)
        if self.metrics is not None:
            self.metrics.counter(
                "serve_cache_hit_total" if ent is not None
                else "serve_cache_miss_total", kind=self.kind).inc()
        if ent is None:
            return False
        resp = Response(
            qid=req.qid, kind=self.kind, source=req.source,
            answer=ent.answer.copy(), iters=ent.iters, segments=0,
            latency_s=now - req.t_enqueue, wait_s=now - req.t_enqueue,
            converged=True, cached=True)
        self.responses.append(resp)
        slo = self._account(resp, True)
        _emit("query_done", qid=resp.qid, query_kind=self.kind, col=-1,
              iters=resp.iters, segments=0,
              latency_s=round(resp.latency_s, 6),
              wait_s=round(resp.wait_s, 6), converged=True, cached=True,
              **slo, **self._rep())
        return True

    def _boundary(self) -> None:
        """The top of a segment boundary: the hook, and one more
        segment for every resident query."""
        self.boundaries += 1
        if self.on_boundary is not None:
            self.on_boundary(self)
        for s in self.slots:
            if s is not None:
                s.segments += 1

    def _boundary_metrics(self, retired: int, filled: int,
                          queued: int) -> None:
        """Per-boundary series: occupancy, segments, refills."""
        if retired and filled:
            self.refills += 1
        if self.metrics is None:
            return
        m = self.metrics
        m.counter("serve_segments_total", kind=self.kind).inc()
        m.gauge("serve_batch_occupancy", kind=self.kind,
                **self._rep()).set(len(self._occupied()))
        m.gauge("serve_queue_depth", kind=self.kind,
                **self._rep()).set(queued)
        if filled:
            m.counter("serve_refilled_total", kind=self.kind).inc(filled)

    def _fill(self, collector, total_iters: int, deadline_s: float,
              init_col: Callable) -> int:
        """Fill free columns from ``collector`` (the first collect may
        wait ``deadline_s``); cache hits take no column.
        ``init_col(col, req)`` writes the column's fresh state."""
        free = self._free_cols()
        filled = 0
        first = True
        while free:
            reqs = collector.collect(len(free),
                                     deadline_s if first else 0.0)
            first = False
            if not reqs:
                break
            for req in reqs:
                if self._serve_cached(req):
                    continue
                col = free.pop(0)
                init_col(col, req)
                self._start(col, req, total_iters)
                filled += 1
        return filled


class PushBatchRunner(_RunnerBase):
    """Continuous batching for the push kinds (sssp, components): one
    batched PushEngine; a column retires when its own frontier
    empties; the refill rides ``converge_segments``'s hook."""

    def __init__(self, kind: str, g, B: int, *, num_parts: int = 1,
                 device=None, exchange: str = "auto",
                 weighted: bool = False,
                 seg_iters: int = DEFAULT_SEG_ITERS,
                 max_segments: int = 10_000, metrics=None,
                 slo_ms: float | None = None, cache=None):
        super().__init__(kind, B, seg_iters, max_segments, metrics=metrics,
                         slo_ms=slo_ms, cache=cache)
        self.g = g
        self.weighted = bool(weighted and kind == "sssp")
        placeholder = [0] * self.B
        if kind == "sssp":
            from lux_tpu_torch.apps import sssp as app
            self.eng = app.build_engine(
                g, sources=placeholder, num_parts=num_parts,
                weighted=self.weighted, exchange=exchange, device=device)
            self._inf = app.DIST_INF if self.weighted else app.HOP_INF
            self._dtype = np.float32 if self.weighted else np.int32
        elif kind == "components":
            from lux_tpu_torch.apps import components as app
            self.eng = app.build_engine(
                g, sources=placeholder, num_parts=num_parts,
                exchange=exchange, device=device)
            self._inf = np.int32(-1)
            self._dtype = np.int32
        else:
            raise ValueError(f"unknown push kind {kind!r}")

    def _col_init(self, req: Request):
        """(label [nv], active [nv]) of a fresh query column."""
        nv = self.g.nv
        s = int(req.source)
        if not 0 <= s < nv:
            raise ValueError(f"query {req.qid}: source {s} out of range "
                             f"[0, {nv})")
        lab = np.full(nv, self._inf, dtype=self._dtype)
        act = np.zeros(nv, dtype=bool)
        lab[s] = s if self.kind == "components" else 0
        act[s] = True
        return lab, act

    def drain(self, collector: BatchCollector,
              deadline_s: float = 0.0) -> list[Response]:
        """Serve until the collector is empty and every column is idle;
        returns the responses retired during this drain."""
        from lux_tpu_torch.segmented import converge_segments

        eng, sg = self.eng, self.eng.sg
        nv, B = self.g.nv, self.B
        n0 = len(self.responses)
        lab_h = np.full((nv, B), self._inf, dtype=self._dtype)
        act_h = np.zeros((nv, B), dtype=bool)

        def init_col(col, req):
            lab_h[:, col], act_h[:, col] = self._col_init(req)

        if not self._fill(collector, 0, deadline_s, init_col):
            return self.responses[n0:]       # cache hits took no column
        label, active = eng.place(sg.to_padded(lab_h), sg.to_padded(act_h))

        def hook(label, active, total, cnt):
            self._boundary()
            # per-column active counts: B integers to the host
            counts = active.reshape(-1, B).sum(dim=0).cpu().numpy()
            done = [c for c in self._occupied()
                    if counts[c] == 0
                    or self.slots[c].segments >= self.max_segments]
            want_fill = len(collector) > 0 and (done or self._free_cols())
            if not done and not want_fill:
                self._boundary_metrics(0, 0, len(collector))
                return None
            lab = sg.from_padded(label.cpu().numpy())
            act = sg.from_padded(active.cpu().numpy())
            lab_h[...], act_h[...] = lab, act
            for c in done:
                self._retire(c, lab_h[:, c].copy(), total,
                             converged=bool(counts[c] == 0))
                lab_h[:, c] = self._inf
                act_h[:, c] = False
            n_filled = self._fill(collector, total, deadline_s, init_col)
            _emit("serve_refill", query_kind=self.kind, retired=len(done),
                  filled=n_filled, occupied=len(self._occupied()),
                  queued=len(collector))
            self._boundary_metrics(len(done), n_filled, len(collector))
            return eng.place(sg.to_padded(lab_h), sg.to_padded(act_h))

        converge_segments(eng, label, active, self.seg_iters,
                          on_segment=hook)
        return self.responses[n0:]


class PullBatchRunner(_RunnerBase):
    """Continuous batching for personalized PageRank: one batched
    PullEngine; a column retires when its state changed by at most
    ``tol`` (max-abs over the segment, at the boundary); a refill swaps
    the column's reset vector in place
    (``PullEngine.update_program_arrays``)."""

    def __init__(self, kind: str, g, B: int, *, num_parts: int = 1,
                 device=None, exchange: str = "auto",
                 seg_iters: int = DEFAULT_SEG_ITERS, tol: float = 1e-8,
                 max_segments: int = 500, metrics=None,
                 slo_ms: float | None = None, cache=None):
        super().__init__(kind, B, seg_iters, max_segments, metrics=metrics,
                         slo_ms=slo_ms, cache=cache)
        if kind != "pagerank":
            raise ValueError(f"unknown pull kind {kind!r}")
        from lux_tpu_torch.apps import pagerank as app
        self.g = g
        self.app = app
        self.tol = float(tol)
        # idle columns iterate the uniform reset, refilled before they
        # matter
        self.resets = np.full((g.nv, B), 1.0 / g.nv, dtype=np.float32)
        self.eng = app.build_engine(g, num_parts=num_parts,
                                    resets=self.resets, exchange=exchange,
                                    device=device)

    def _col_reset(self, req: Request) -> np.ndarray:
        if req.reset is not None:
            r = np.asarray(req.reset, np.float32)
            if r.shape != (self.g.nv,):
                raise ValueError(f"query {req.qid}: reset must be [nv], "
                                 f"got {r.shape}")
            return r
        return self.app.one_hot_resets(self.g.nv, [int(req.source)])[:, 0]

    def _col_init(self, reset: np.ndarray) -> np.ndarray:
        deg = np.asarray(self.g.out_degrees, np.float32)
        return np.where(deg > 0, reset / np.maximum(deg, 1),
                        reset).astype(np.float32)

    def drain(self, collector: BatchCollector,
              deadline_s: float = 0.0) -> list[Response]:
        from lux_tpu_torch.segmented import run_segments

        eng, sg = self.eng, self.eng.sg
        n0 = len(self.responses)
        state_h = sg.from_padded(np.asarray(eng.program.init(sg)))

        def init_col(col, req):
            reset = self._col_reset(req)
            self.resets[:, col] = reset
            state_h[:, col] = self._col_init(reset)

        if not self._fill(collector, 0, deadline_s, init_col):
            return self.responses[n0:]       # cache hits took no column
        self._push_resets()
        prev = state_h.copy()
        state = eng.place(sg.to_padded(state_h))

        def hook(state, done_iters):
            nonlocal prev
            self._boundary()
            new = sg.from_padded(state.cpu().numpy())
            # per-query convergence: the max-abs change over the whole
            # segment (a bound on its last iteration's)
            res = np.max(np.abs(new - prev), axis=0)
            done = [c for c in self._occupied()
                    if res[c] <= self.tol
                    or self.slots[c].segments >= self.max_segments]
            for c in done:
                self._retire(c, new[:, c].copy(), done_iters,
                             converged=bool(res[c] <= self.tol))
            state_h[...] = new
            n_filled = self._fill(collector, done_iters, deadline_s,
                                  init_col)
            if done or n_filled:
                _emit("serve_refill", query_kind=self.kind,
                      retired=len(done), filled=n_filled,
                      occupied=len(self._occupied()),
                      queued=len(collector))
            self._boundary_metrics(len(done), n_filled, len(collector))
            if not self._occupied() and not len(collector):
                raise _Drained()
            prev = state_h.copy()
            if n_filled:
                self._push_resets()
                return eng.place(sg.to_padded(state_h))
            return None

        try:
            run_segments(eng, state, np.iinfo(np.int32).max,
                         self.seg_iters, on_segment=hook)
        except _Drained:
            pass
        return self.responses[n0:]

    def _push_resets(self):
        self.eng.update_program_arrays(
            reset=self.eng.sg.to_padded(self.resets))


class Server:
    """Route queries by kind to per-kind batch runners and drain them.

    One engine per kind is built at the first query of that kind
    (``batch`` columns, on ``device``: None means the card);
    ``run()`` drains every kind's queue through continuous-batching
    refill and returns the responses in retirement order.
    ``deadline_s`` is the collector's wait for more (0 serves what is
    queued).  ``slo_ms`` maps kinds to latency targets in ms (SLO
    counters and the burn-rate gauge); ``metrics`` is a
    metrics.Registry to share, None for a private one, or False for
    none.  ``cache=True`` builds an AnswerCache (``AnswerCache.from_slo``)
    or takes the one given."""

    def __init__(self, g, batch: int = 4, *, num_parts: int = 1,
                 device=None, mesh=None, exchange: str = "auto",
                 health: bool = False, weighted: bool = False,
                 seg_iters: int = DEFAULT_SEG_ITERS, tol: float = 1e-8,
                 deadline_s: float = 0.0, slo_ms: dict | None = None,
                 metrics=None, snapshot_every_s: float = 1.0,
                 on_boundary=None, replica: str | None = None, live=None,
                 cache=False, mem=None):
        if live is not None:
            _refuse("live graphs (Server(live=...))", "A11")
        if mem is not None:
            _refuse("the memory trail (Server(mem=...))", "A10")
        if health:
            _refuse("the device health watchdog (health=True)", "A9")
        if mesh is not None:
            _refuse("a device mesh", "A6")
        self.g = g
        self.device = resolve_device(device)
        if cache is True:
            self.cache: AnswerCache | None = AnswerCache.from_slo(slo_ms)
        elif cache:
            self.cache = cache
        else:
            self.cache = None
        self.on_boundary = on_boundary
        self.replica = replica
        self.batch = int(batch)
        self.opts = dict(num_parts=num_parts, exchange=exchange,
                         device=self.device)
        self.weighted = bool(weighted)
        self.seg_iters = int(seg_iters)
        self.tol = float(tol)
        self.deadline_s = float(deadline_s)
        self.slo_ms = dict(slo_ms or {})
        for k in self.slo_ms:
            if k not in KINDS:
                raise ValueError(f"slo_ms names unknown kind {k!r}; "
                                 f"choose from {KINDS}")
        if metrics is False:
            self.metrics = None
        elif metrics is None:
            from lux_tpu_torch import metrics as metrics_mod
            self.metrics = metrics_mod.Registry()
        else:
            self.metrics = metrics
        if self.cache is not None:
            self.cache.set_metrics(self.metrics, replica)
        self.snapshot_every_s = float(snapshot_every_s)
        self._last_snapshot = 0.0
        self._collectors: dict[str, BatchCollector] = {}
        self._runners: dict[str, _RunnerBase] = {}
        self._next_qid = 0

    def _collector(self, kind: str) -> BatchCollector:
        if kind not in KINDS:
            raise ValueError(f"unknown query kind {kind!r}; choose from "
                             f"{KINDS}")
        return self._collectors.setdefault(
            kind, BatchCollector(metrics=self.metrics, kind=kind))

    def _runner(self, kind: str) -> _RunnerBase:
        if kind not in self._runners:
            mkw = dict(metrics=self.metrics, slo_ms=self.slo_ms.get(kind),
                       cache=self.cache, seg_iters=self.seg_iters,
                       **self.opts)
            if kind == "pagerank":
                runner = PullBatchRunner(kind, self.g, self.batch,
                                         tol=self.tol, **mkw)
            else:
                runner = PushBatchRunner(kind, self.g, self.batch,
                                         weighted=self.weighted, **mkw)
            runner.on_boundary = self.on_boundary
            runner.replica = self.replica
            self._runners[kind] = runner
        return self._runners[kind]

    def set_metrics(self, registry) -> None:
        """Re-point every collector and runner at ``registry`` (None to
        disable), without rebuilding the engines."""
        self.metrics = registry
        for coll in self._collectors.values():
            coll.metrics = registry
        for runner in self._runners.values():
            runner.metrics = registry
        if self.cache is not None:
            self.cache.set_metrics(registry, self.replica)

    def emit_metrics_snapshot(self, **extra):
        """Publish a ``metrics_snapshot`` event of this server's
        registry (None when metrics are off or no event sink is
        active)."""
        if self.metrics is None:
            return None
        return self.metrics.emit_snapshot(**extra)

    def submit(self, kind: str, source: int | None = None, reset=None,
               priority: int = 0,
               deadline_s: float | None = None) -> int:
        qid = self._next_qid
        self._next_qid += 1
        req = Request(qid=qid, kind=kind,
                      source=None if source is None else int(source),
                      reset=(None if reset is None
                             else np.asarray(reset, np.float32)),
                      t_enqueue=time.monotonic(), priority=int(priority),
                      deadline_s=(None if deadline_s is None
                                  else float(deadline_s)))
        if self.metrics is not None:
            self.metrics.counter("serve_queries_total", kind=kind).inc()
        self._collector(kind).put(req)
        _emit("query_enqueue", qid=qid, query_kind=kind,
              source=req.source, queued=len(self._collector(kind)))
        return qid

    def mutate(self, src, dst, weights=None, op: str = "append") -> int:
        _refuse("live graphs (Server.mutate)", "A11")

    def refresh_live(self) -> None:
        _refuse("live graphs (Server.refresh_live)", "A11")

    def run(self) -> list[Response]:
        """Drain every kind's queue; returns the responses in
        retirement order (later queries refill columns freed by
        earlier retirements).  Publishes a ``metrics_snapshot`` event
        at most once per ``snapshot_every_s`` of non-empty drains."""
        out: list[Response] = []
        # list(): a submitter thread may add a kind's collector meanwhile
        for kind, coll in list(self._collectors.items()):
            while len(coll):
                out += self._runner(kind).drain(coll, self.deadline_s)
        now = time.monotonic()
        if out and now - self._last_snapshot >= self.snapshot_every_s:
            self._last_snapshot = now
            self.emit_metrics_snapshot()
        return out


# ---------------------------------------------------------------------
# smoke: python -m lux_tpu_torch.serve

def _smoke_graph(scale: int, ef: int, seed: int = 0):
    from lux_tpu_torch.graph import Graph
    r = np.random.default_rng(seed)
    nv = 1 << scale
    ne = nv * ef
    return Graph.from_edges(r.integers(0, nv, ne), r.integers(0, nv, ne),
                            nv)


def _check_answers(g, responses) -> int:
    """Hold every response to the apps' batched NumPy oracles; returns
    the mismatch count."""
    from lux_tpu_torch.apps import components, pagerank, sssp
    bad = 0
    for r in responses:
        if r.kind == "sssp":
            ref = sssp.reference_sssp_batched(g, [r.source])[:, 0]
            ok = np.array_equal(r.answer.astype(np.int64), ref)
        elif r.kind == "components":
            ref = components.reference_components_batched(
                g, [r.source])[:, 0]
            ok = np.array_equal(r.answer.astype(np.int64), ref)
        else:
            reset = pagerank.one_hot_resets(g.nv, [r.source])
            ref = pagerank.reference_pagerank_batched(
                g, reset, max(1, r.iters))[:, 0]
            ok = bool(np.allclose(r.answer, ref, atol=5e-5))
        if not ok:
            bad += 1
            print(f"MISMATCH qid={r.qid} kind={r.kind} source={r.source}")
    return bad


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.serve",
        description="continuous-batching serve smoke: 2B mixed queries "
                    "drain through refill; answers are oracle-checked")
    ap.add_argument("-scale", type=int, default=9,
                    help="graph scale (nv = 2**scale; default 9)")
    ap.add_argument("-ef", type=int, default=8)
    ap.add_argument("-batch", type=int, default=4,
                    help="engine column count B (default 4)")
    ap.add_argument("-queries", type=int, default=0,
                    help="total mixed queries (default 2B)")
    ap.add_argument("-kinds", default="sssp,components,pagerank",
                    help="comma list of query kinds to mix")
    ap.add_argument("-np", type=int, default=2, dest="num_parts")
    ap.add_argument("-seg-iters", type=int, default=2, dest="seg_iters",
                    help="iterations per serve segment (the refill "
                         "cadence)")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-events", default=None, metavar="FILE",
                    help="append the per-query event trail as JSONL")
    ap.add_argument("-no-check", action="store_true", dest="no_check",
                    help="skip the oracle verification")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch.device import DeviceUnavailableError

    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    for k in kinds:
        if k not in KINDS:
            print(f"error: unknown kind {k!r}")
            return 2
    g = _smoke_graph(args.scale, args.ef, args.seed)
    n_queries = args.queries or 2 * args.batch
    rng = np.random.default_rng(args.seed + 1)

    ev = telemetry.EventLog(args.events) if args.events else \
        telemetry.EventLog()
    with telemetry.use(events=ev):
        ev.emit("run_start", schema=telemetry.SCHEMA, app="serve",
                file=f"<rmat{args.scale}>", mesh=1, np=args.num_parts)
        try:
            srv = Server(g, batch=args.batch, num_parts=args.num_parts,
                         seg_iters=args.seg_iters, device=args.device)
        except DeviceUnavailableError as e:
            print(f"error: {e}")
            return 2
        # the primary kind OVERSUBSCRIBES its B columns, so later
        # queries wait for retirements and enter through refill
        others = kinds[1:]
        seq = [others[i - 1] if 0 < i <= len(others) else kinds[0]
               for i in range(n_queries)]
        for k in seq:
            srv.submit(k, source=int(rng.integers(0, g.nv)))
        t0 = time.perf_counter()
        responses = srv.run()
        elapsed = time.perf_counter() - t0
        ev.emit("run_done", seconds=round(elapsed, 6),
                iters=sum(r.iters for r in responses))
    refills = sum(1 for e in ev.events
                  if e["kind"] == "serve_refill"
                  and e.get("retired", 0) and e.get("filled", 0))
    ev.close()

    lat = sorted(r.latency_s for r in responses)
    p50 = lat[len(lat) // 2] if lat else 0.0
    for r in responses:
        print(f"query {r.qid} [{r.kind}] source={r.source}: "
              f"{r.iters} iters over {r.segments} segment(s), "
              f"latency {r.latency_s * 1e3:.1f} ms"
              + ("" if r.converged else " (SEGMENT CAP)"))
    print(f"# served {len(responses)}/{n_queries} queries "
          f"(B={args.batch}, {len(kinds)} kind(s)) in {elapsed:.2f}s; "
          f"p50 latency {p50 * 1e3:.1f} ms, max "
          f"{(lat[-1] if lat else 0) * 1e3:.1f} ms; "
          f"{refills} retire+refill boundary(ies)")
    if len(responses) != n_queries:
        print("error: queue did not drain")
        return 1
    if n_queries > args.batch and not refills:
        print("error: oversubscribed queue drained without any "
              "continuous-batching refill")
        return 1
    if not args.no_check:
        bad = _check_answers(g, responses)
        if bad:
            print(f"error: {bad} answer(s) mismatched their oracle")
            return 1
        print("# all answers match their NumPy oracles")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
