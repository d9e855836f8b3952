"""Live graphs: a crash-consistent mutation log, snapshot-isolated
epochs, incremental revalidation and compaction (counterpart of
lux_tpu/livegraph.py:1-1619).

1. **Mutation log** (:class:`MutationLog`): every mutation is written
   to a CRC-chained append-only WAL before it is visible: record i's
   CRC32 is seeded with record i-1's (checkpoint.chained_crc32), the
   chain with the header's, so a torn append breaks the chain at the
   tear.  Replay truncates a torn TAIL and comes up on the exact
   pre-append state; a broken chain followed by whole records, an epoch
   that goes backwards, an unknown record kind or a header of another
   graph raise a typed :class:`MutationLogError`.  The header lives
   with the other formats (format.py ``read_wal_header``).  The files
   are byte-identical to the reference's.

2. **Delta blocks and epochs**: published mutations land in
   fixed-capacity host arrays (src, dst, weight, kind, epoch) handed to
   the delta-relax step as tensors; no plan is rebuilt on a mutation.
   A published slot is never rewritten (compaction swaps in fresh
   arrays), and an unwritten slot carries the ``EPOCH_SENTINEL`` epoch,
   written last, so a reader pinned to epoch e sees exactly the slots
   with ``d_epoch <= e``.  ``epoch`` advances once per published batch.

3. **Revalidation** (:meth:`LiveGraph.revalidate`): the delta-relax
   step (one gather of the state table by the delta sources, the
   program's relax, a per-column epoch mask and a scatter min/max into
   the table) alternates with the push engine's converge until the
   delta improves nothing.  It runs as plain torch operations on the
   engine's device: the reference computes it in XLA, it is no TPU
   kernel.  Deletions and reweights (anti-monotone) publish tombstone /
   overwrite slots that the relax masks to the identity; revalidating
   past one re-seeds the affected cone (forward reachability from the
   touched destinations, capped by ``cone_cap`` with a full-recompute
   fallback) from the program's init labels and re-converges over
   ``graph_at(epoch)``: proved equal to full recompute against the
   decremental oracles (apps/sssp.reference_sssp_decremental,
   apps/components.reference_components_decremental; the reference
   cites them at lux_tpu/livegraph.py:67-68), bitwise for the integer
   apps.

4. **Compaction** (:meth:`LiveGraph.compact`,
   :class:`CompactionScheduler`): the delta folds into a new base
   through ``_apply_ops`` (origin + the op history, the rule graph_at
   and recover share, so the live, oracle and recovered bases are
   bit-identical), the generation swaps under the lock, and the WAL
   brackets the fold with COMPACT_START / COMPACT_DONE; a crash between
   them recovers the surviving generation.  When ingest outruns
   compaction the blocks fill and mutations raise
   :class:`DeltaFullError`.

Push kinds (sssp, components) see base + published delta through the
delta relax; pull kinds (pagerank) through the Server's host-side
degree correction (serve.py ``PullBatchRunner``).  While an
anti-monotone op is pending, ``view_epoch`` holds both families at the
epoch before it.  ``register_audit`` adds the delta-relax step to an
engine's audited variants (lux_tpu_torch/audit.py).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import weakref

import numpy as np
import torch

from lux_tpu_torch import format as luxfmt
from lux_tpu_torch import telemetry
from lux_tpu_torch.checkpoint import chained_crc32
from lux_tpu_torch.graph import Graph

# WAL record kinds (format.py owns the header).  A record is [epoch u32,
# kind u32, a u32, b u32, c u32, crc u32], crc = chained_crc32(the first
# 20 bytes, the previous record's crc).
REC_EDGE = 1           # a=src, b=dst, c=float32 weight bits
REC_COMPACT_START = 2  # a=delta count folded, b=new generation
REC_COMPACT_DONE = 3   # a=new generation, b=base epoch after the fold
REC_DELETE = 4         # (v2) a=src, b=dst, c=0
REC_REWEIGHT = 5       # (v2) a=src, b=dst, c=new float32 weight bits

_V1_KINDS = frozenset((REC_EDGE, REC_COMPACT_START, REC_COMPACT_DONE))
_V2_KINDS = _V1_KINDS | {REC_DELETE, REC_REWEIGHT}
_KINDS_BY_VERSION = {1: _V1_KINDS, 2: _V2_KINDS}

# delta-slot kinds (the d_kind column): DELETE / REWEIGHT slots take a
# slot (occupancy and DeltaFullError count them) but the delta relax
# masks them to the reduce identity
DK_APPEND = 0
DK_DELETE = 1
DK_REWEIGHT = 2

_REC_BY_OP = {"append": REC_EDGE, "delete": REC_DELETE,
              "reweight": REC_REWEIGHT}
_DK_BY_OP = {"append": DK_APPEND, "delete": DK_DELETE,
             "reweight": DK_REWEIGHT}
_OP_BY_REC = {REC_EDGE: "append", REC_DELETE: "delete",
              REC_REWEIGHT: "reweight"}

# the epoch of an unwritten delta slot, written last in a publish
EPOCH_SENTINEL = np.int32(np.iinfo(np.int32).max)

# nominal host prices of the pointer-structured consumers
# (memory_terms): a history op (a 5-tuple and its list slot) and an
# entry of the live-edge multiset (a dict slot, a 2-tuple key, an int)
HISTORY_ENTRY_BYTES = 112
MULTISET_ENTRY_BYTES = 96


class LiveGraphError(RuntimeError):
    """Base of the live-graph typed failures."""


class MutationLogError(LiveGraphError):
    """The mutation log failed verification.  ``check`` is torn_tail /
    crc_chain / epoch_order / record_kind / compact_pair /
    capacity_overflow / wal_exists; only ``torn_tail`` is recoverable
    (replay truncates it)."""

    def __init__(self, path: str, check: str, detail: str):
        super().__init__(f"{path}: mutation log [{check}] — {detail}")
        self.path = path
        self.check = check
        self.detail = detail


class DeltaFullError(LiveGraphError):
    """The delta blocks are full: ingest has outrun compaction."""

    def __init__(self, capacity: int):
        super().__init__(
            f"delta blocks full ({capacity} slots): compact before "
            f"appending more mutations")
        self.capacity = capacity


class CompactPinnedError(LiveGraphError):
    """compact() while queries pin the current generation: the swap
    would unmask base edges newer than their admission epochs."""


def _emit(kind: str, **fields):
    telemetry.current().emit(kind, **fields)


@dataclasses.dataclass(frozen=True)
class WalRecord:
    epoch: int
    kind: int
    a: int
    b: int
    c: int


def _pack_record(epoch: int, kind: int, a: int, b: int, c: int,
                 prev_crc: int) -> bytes:
    body = np.array([epoch, kind, a, b, c], luxfmt.V_DTYPE).tobytes()
    crc = chained_crc32(body, prev_crc)
    return body + np.array([crc], luxfmt.V_DTYPE).tobytes()


class MutationLog:
    """The CRC-chained append-only WAL.  One instance owns an open
    append handle; each ``append_*`` writes one 24-byte record and
    fsyncs it.  ``stage_mutation`` / ``commit`` write a batch with one
    fsync (LiveGraph's publish: the reference fsyncs each record of a
    batch, lux_tpu/livegraph.py:299-343; the batch's epoch is published
    after the commit in both, so an acknowledged batch is durable, and a
    crash inside a batch leaves a prefix of it).  ``scan`` / ``replay``
    verify the chain; ``replay`` also truncates a torn tail."""

    def __init__(self, path: str, nv: int, capacity: int,
                 version: int = luxfmt.WAL_VERSION,
                 _resume: tuple | None = None):
        self.path = path
        self.nv = int(nv)
        self.capacity = int(capacity)
        self.version = int(version)
        self.records = 0        # records appended through this handle
        self._staged: list[bytes] = []      # packed, not yet written
        if _resume is None:
            header = luxfmt.pack_wal_header(self.nv, self.capacity,
                                            version=self.version)
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644)
            except FileExistsError:
                raise MutationLogError(
                    path, "wal_exists",
                    "a mutation log already exists at this path — a "
                    "fresh log would orphan its durable history; use "
                    "LiveGraph.recover(g, path) to replay it, or remove "
                    "the file to start over") from None
            self._f = os.fdopen(fd, "wb")
            self._f.write(header)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._crc = chained_crc32(header)
        else:
            size, crc = _resume
            self._f = open(path, "r+b")
            self._f.seek(size)
            self._crc = crc

    # -- append side ---------------------------------------------------

    def _append(self, record: bytes) -> None:
        self.commit()
        self._f.write(record)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._crc = int(np.frombuffer(record, luxfmt.V_DTYPE)[5])
        self.records += 1

    def stage_mutation(self, epoch: int, op: str, src: int, dst: int,
                       wbits: int) -> None:
        """Pack one mutation record at the chain's position and hold it
        for ``commit``."""
        record = self.pack_mutation(epoch, op, src, dst, wbits)
        self._staged.append(record)
        self._crc = int(np.frombuffer(record, luxfmt.V_DTYPE)[5])

    def commit(self) -> None:
        """Write the staged records and fsync them once."""
        if not self._staged:
            return
        self._f.write(b"".join(self._staged))
        self._f.flush()
        os.fsync(self._f.fileno())
        self.records += len(self._staged)
        self._staged.clear()

    def buffer_bytes(self) -> int:
        """The header and every record written through this handle
        (the memory ledger's ``live_wal`` term)."""
        return luxfmt.WAL_HEADER_SIZE + self.records * luxfmt.WAL_RECORD_SIZE

    def pack_edge(self, epoch: int, src: int, dst: int, wbits: int) -> bytes:
        return _pack_record(epoch, REC_EDGE, src, dst, wbits, self._crc)

    def pack_mutation(self, epoch: int, op: str, src: int, dst: int,
                      wbits: int) -> bytes:
        """One record of any op at the current chain position (the
        WAL_TORN fault needs the exact bytes the append would write)."""
        kind = _REC_BY_OP[op]
        if kind not in _KINDS_BY_VERSION[self.version]:
            raise MutationLogError(
                self.path, "record_kind",
                f"op {op!r} (record kind {kind}) is not in the "
                f"v{self.version} header's kind set — recover into a "
                f"fresh v{luxfmt.WAL_VERSION} log to use the full "
                f"mutation algebra")
        return _pack_record(epoch, kind, src, dst, wbits, self._crc)

    def append_edge(self, epoch: int, src: int, dst: int, wbits: int):
        self._append(self.pack_edge(epoch, src, dst, wbits))

    def append_mutation(self, epoch: int, op: str, src: int, dst: int,
                        wbits: int) -> None:
        self._append(self.pack_mutation(epoch, op, src, dst, wbits))

    def append_marker(self, epoch: int, kind: int, a: int, b: int) -> None:
        self._append(_pack_record(epoch, kind, a, b, 0, self._crc))

    def write_torn(self, record: bytes) -> None:
        """Fault hook (faults.WAL_TORN): persist a strict prefix of
        ``record`` after the records staged before it, as a power loss
        mid-append would."""
        self.commit()
        self._f.write(record[:len(record) // 2])
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    # -- replay / verify side ------------------------------------------

    @classmethod
    def scan(cls, path: str, nv: int | None = None):
        """Verify the whole log without changing it: (records, header
        nv, capacity, torn bytes); corruption raises."""
        recs, hnv, cap, tail, _crc, _ver = cls._scan(path, nv=nv)
        return recs, hnv, cap, tail

    @classmethod
    def _scan(cls, path: str, nv: int | None = None):
        with open(path, "rb") as f:
            blob = f.read()
        head = blob[:luxfmt.WAL_HEADER_SIZE]
        hnv, cap, ver = luxfmt.read_wal_header(path, nv=nv, head=head)
        known = _KINDS_BY_VERSION[ver]
        crc = chained_crc32(head)
        recs: list[WalRecord] = []
        off = luxfmt.WAL_HEADER_SIZE
        R = luxfmt.WAL_RECORD_SIZE
        last_epoch = 0
        bad_at = None
        while off + R <= len(blob):
            raw = blob[off:off + R]
            words = np.frombuffer(raw, luxfmt.V_DTYPE)
            if int(words[5]) != chained_crc32(raw[:20], crc):
                bad_at = off
                break
            epoch, kind = int(words[0]), int(words[1])
            if kind not in known:
                extra = (f" (a v2 mutation kind inside a v{ver} header — "
                         f"the kind set is part of the version contract)"
                         if kind in _V2_KINDS else
                         " — log written by a newer/foreign build")
                raise MutationLogError(
                    path, "record_kind",
                    f"record at byte {off} has kind {kind} outside the "
                    f"v{ver} kind set with a VALID chain CRC{extra}, "
                    f"refusing to replay")
            if epoch < last_epoch:
                raise MutationLogError(
                    path, "epoch_order",
                    f"record at byte {off} carries epoch {epoch} after "
                    f"epoch {last_epoch} — the monotone epoch counter "
                    f"never goes backwards; the log is corrupt or "
                    f"spliced")
            last_epoch = epoch
            recs.append(WalRecord(epoch, kind, int(words[2]),
                                  int(words[3]), int(words[4])))
            crc = int(words[5])
            off += R
        tail = len(blob) - off
        if bad_at is not None:
            # a torn append leaves a strict prefix of a record, which the
            # loop stops short of (the tail); a full-size record with a
            # bad CRC is corruption of a possibly acknowledged append
            behind = len(blob) - bad_at - R
            what = (f"with {behind} byte(s) of further records behind "
                    f"it — mid-file corruption" if behind else
                    "at full record size — corruption of a "
                    "possibly-acknowledged final record")
            raise MutationLogError(
                path, "crc_chain",
                f"record at byte {bad_at} fails the CRC chain {what}, "
                f"not a torn append; refusing to replay")
        return recs, hnv, cap, tail, crc, ver

    @classmethod
    def replay(cls, path: str, nv: int | None = None):
        """Crash recovery: scan, truncate a torn tail in place (the torn
        record was never acknowledged), and return (records, truncated
        bytes, a MutationLog open at the end, keeping the header's
        version)."""
        recs, hnv, cap, torn, crc, ver = cls._scan(path, nv=nv)
        good = luxfmt.WAL_HEADER_SIZE + len(recs) * luxfmt.WAL_RECORD_SIZE
        if torn:
            with open(path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            _emit("wal_truncate", path=path, torn_bytes=int(torn),
                  records=len(recs))
        log = cls(path, hnv, cap, version=ver, _resume=(good, crc))
        return recs, torn, log


# ---------------------------------------------------------------------
# the live graph


def _targets(base_src, base_dst, nv: int, keys) -> dict:
    """(src, dst) -> the base edge indices holding it, in edge order,
    for the pairs in ``keys`` only (one vectorised match instead of a
    dict over every base edge)."""
    if not keys:
        return {}
    want = np.array(sorted(s * nv + d for s, d in keys), np.int64)
    code = base_src * nv + base_dst
    hit = np.flatnonzero(np.isin(code, want))
    out: dict = {}
    for i, c in zip(hit.tolist(), code[hit].tolist()):
        out.setdefault(divmod(c, nv), []).append(i)
    return out


class _EdgeMultiset:
    """(src, dst) -> live multiplicity, the reference's Counter over the
    origin's edges and the history (lux_tpu/livegraph.py:640-657) held
    as one sorted int64 key array of the origin's edges plus a dict of
    the changes since: the same counts and the same ``len`` (distinct
    keys ever counted), without a Python object per origin edge.  A
    read of a missing key is 0 and adds nothing, as a Counter's."""

    def __init__(self, origin: Graph):
        src, dst = origin.edge_arrays()
        self.nv = int(origin.nv)
        self.keys = np.sort(src * self.nv + dst)
        self.distinct = int(np.count_nonzero(np.diff(self.keys))
                            + (1 if self.keys.size else 0))
        self.delta: dict = {}
        self.extra = 0              # keys counted outside the origin

    def _base(self, key: int) -> int:
        return int(np.searchsorted(self.keys, key, "right")
                   - np.searchsorted(self.keys, key, "left"))

    def __getitem__(self, sd) -> int:
        key = int(sd[0]) * self.nv + int(sd[1])
        return self._base(key) + self.delta.get(key, 0)

    def __setitem__(self, sd, count: int) -> None:
        key = int(sd[0]) * self.nv + int(sd[1])
        base = self._base(key)
        if key not in self.delta and base == 0:
            self.extra += 1
        self.delta[key] = int(count) - base

    def __len__(self) -> int:
        return self.distinct + self.extra


def _apply_ops(origin: Graph, ops, weighted: bool) -> Graph:
    """origin + a mutation-op prefix ``[(op, src, dst, w, epoch), ...]``:
    the one rule graph_at, compact and recover share.  A delete or
    reweight of (s, d) hits the first surviving base edge of (s, d) in
    ``edge_arrays`` order, else the first live appended one (publish
    order); the survivors are concatenated base first, appends after,
    into ``Graph.from_edges`` (lux_tpu/livegraph.py:474-540)."""
    if not ops:
        return origin
    base_src, base_dst = origin.edge_arrays()
    base_w = (np.asarray(origin.weights, np.float32).copy()
              if weighted else None)
    alive = np.ones(origin.ne, dtype=bool)
    app_src: list = []
    app_dst: list = []
    app_w: list = []
    app_alive: list = []
    app_ix: dict = {}
    base_ix = _targets(base_src, base_dst, origin.nv,
                       {(int(h[1]), int(h[2])) for h in ops
                        if h[0] != "append"})
    for h in ops:
        op, s, d, w = h[0], int(h[1]), int(h[2]), h[3]
        if op == "append":
            app_ix.setdefault((s, d), []).append(len(app_src))
            app_src.append(s)
            app_dst.append(d)
            app_w.append(np.float32(w))
            app_alive.append(True)
            continue
        tgt = next((i for i in base_ix.get((s, d), ()) if alive[i]), None)
        if op == "delete":
            if tgt is not None:
                alive[tgt] = False
            else:
                j = next(i for i in app_ix.get((s, d), ()) if app_alive[i])
                app_alive[j] = False
        else:  # reweight
            if tgt is not None:
                base_w[tgt] = np.float32(w)
            else:
                j = next(i for i in app_ix.get((s, d), ()) if app_alive[i])
                app_w[j] = np.float32(w)
    keep = [i for i, ok in enumerate(app_alive) if ok]
    src = np.concatenate([base_src[alive],
                          np.array([app_src[i] for i in keep], np.int64)])
    dst = np.concatenate([base_dst[alive],
                          np.array([app_dst[i] for i in keep], np.int64)])
    w_all = None
    if weighted:
        w_all = np.concatenate([base_w[alive],
                                np.array([app_w[i] for i in keep],
                                         np.float32)])
    return Graph.from_edges(src, dst, origin.nv, weights=w_all)


class LiveGraph:
    """Base generation + fixed-capacity delta blocks + monotone epochs.
    Mutations take the lock; readers snapshot ``(epoch, count)`` without
    it and mask by epoch (published slots never change, unwritten ones
    carry EPOCH_SENTINEL)."""

    def __init__(self, g: Graph, *, capacity: int = 1024,
                 wal_path: str | None = None, fault=None,
                 compact_threshold: float = 0.75, cone_cap: float = 0.5,
                 _recovering: bool = False):
        if capacity < 1:
            raise ValueError(f"delta capacity {capacity} must be >= 1")
        if not 0.0 < compact_threshold <= 1.0:
            raise ValueError(f"compact_threshold {compact_threshold} "
                             f"must be in (0, 1]")
        if not 0.0 < cone_cap <= 1.0:
            raise ValueError(f"cone_cap {cone_cap} must be in (0, 1]")
        self.origin = g               # the recovery and oracle anchor
        self.base = g                 # the current generation's base
        self.base_epoch = 0           # the epoch folded into the base
        self.generation = 0
        self.epoch = 0                # the latest published epoch
        self.capacity = int(capacity)
        self.weighted = g.weights is not None
        self.compact_threshold = float(compact_threshold)
        self.cone_cap = float(cone_cap)
        self.fault = fault
        self._lock = threading.Lock()
        self._fresh_delta()
        self.count = 0                # published delta slots
        self.pins = 0                 # resident queries on this gen
        self.admitted = 0             # admitted, not yet retired
        self.mutations = 0
        self.deletions = 0
        self.reweights = 0
        self.reseeds = 0
        self.reseed_fallbacks = 0
        self.compactions = 0
        self.peak_count = 0
        # every publish [(op, src, dst, w, epoch)]: graph_at's surface
        self._history: list[tuple] = []
        # pending anti-monotone ops [(epoch, op, src, dst)], not folded
        self._anti: list[tuple] = []
        # measured per-slot delta drag (ns), fed by the serve runners
        self._drag_samples = collections.deque(maxlen=64)
        # (src, dst) -> live multiplicity (_EdgeMultiset), built at the
        # first anti-monotone mutation (a phantom edge refuses before
        # the WAL)
        self._edge_counts = None
        self._graph_cache: dict[int, Graph] = {}
        self._graph_lock = threading.Lock()   # one build of an epoch
        self._slot_cache: dict[int, tuple] = {}
        self._vslot_cache: dict[int, tuple] = {}
        self._step_cache: dict[int, tuple] = {}
        self._dev_cache: dict[int, tuple] = {}
        self._wal: MutationLog | None = None
        if wal_path is not None and not _recovering:
            self._wal = MutationLog(wal_path, g.nv, capacity)

    def _fresh_delta(self) -> None:
        # fresh arrays at every generation swap: a reader holding the
        # old ones keeps a consistent block
        cap = self.capacity
        self.d_src = np.zeros(cap, np.int32)
        self.d_dst = np.zeros(cap, np.int32)
        self.d_w = np.zeros(cap, np.float32)
        self.d_kind = np.zeros(cap, np.int32)
        self.d_epoch = np.full(cap, EPOCH_SENTINEL, np.int32)

    # -- ingest --------------------------------------------------------

    def _check_pair(self, src, dst, what: str):
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        n = len(src)
        if len(dst) != n:
            raise ValueError(f"{what} src/dst length mismatch "
                             f"({n} vs {len(dst)})")
        nv = self.base.nv
        if src.size and (int(src.max()) >= nv or int(src.min()) < 0
                         or int(dst.max()) >= nv or int(dst.min()) < 0):
            raise ValueError(f"{what}: edge endpoint outside [0, {nv})")
        return src, dst, n

    def _live_edge_counts(self):
        if self._edge_counts is None:
            counts = _EdgeMultiset(self.origin)
            for h in self._history:
                if h[0] == "append":
                    counts[(h[1], h[2])] += 1
                elif h[0] == "delete":
                    counts[(h[1], h[2])] -= 1
            self._edge_counts = counts
        return self._edge_counts

    def _publish(self, op: str, src, dst, w) -> int:
        """The batch's WAL records (one fsync) -> delta slots -> epoch
        advance: one new epoch, visible once every slot is written.  An
        anti-monotone op of an edge that does not exist refuses here,
        under the journal's lock."""
        n = len(src)
        dk = _DK_BY_OP[op]
        with self._lock:
            if self.count + n > self.capacity:
                raise DeltaFullError(self.capacity)
            if dk != DK_APPEND:
                counts = self._live_edge_counts()
                need = collections.Counter(zip(src.tolist(), dst.tolist()))
                for (s, d), k in need.items():
                    required = k if dk == DK_DELETE else 1
                    have = counts[(s, d)]
                    if have < required:
                        raise ValueError(
                            f"{op} of edge ({s}, {d}): {have} live "
                            f"edge(s), batch needs {required} — refusing "
                            f"before journaling (mutations of phantom "
                            f"edges would replay on every recovery)")
            epoch = self.epoch + 1
            wbits = np.asarray(w, np.float32).view(np.uint32)
            try:
                for i in range(n):
                    s, d, wb = int(src[i]), int(dst[i]), int(wbits[i])
                    if self.fault is not None:
                        record = (self._wal.pack_mutation(epoch, op, s, d, wb)
                                  if self._wal is not None else b"")
                        self.fault.fire_append(self._wal, record, op=op)
                    if self._wal is not None:
                        self._wal.stage_mutation(epoch, op, s, d, wb)
            except BaseException:
                # a crash inside the batch: the records before it are on
                # disk, as the reference's fsync a record leaves them
                if self._wal is not None:
                    self._wal.commit()
                raise
            if self._wal is not None:
                self._wal.commit()          # durable before visible
            for i in range(n):
                s, d = int(src[i]), int(dst[i])
                slot = self.count
                self.d_src[slot] = s
                self.d_dst[slot] = d
                self.d_w[slot] = w[i]
                self.d_kind[slot] = dk
                self.d_epoch[slot] = epoch          # last
                self.count = slot + 1
                self._history.append((op, s, d, float(w[i]), epoch))
                if self._edge_counts is not None:
                    if op == "append":
                        self._edge_counts[(s, d)] += 1
                    elif op == "delete":
                        self._edge_counts[(s, d)] -= 1
                if dk != DK_APPEND:
                    self._anti.append((epoch, op, s, d))
            self.mutations += n
            if op == "delete":
                self.deletions += n
            elif op == "reweight":
                self.reweights += n
            self.peak_count = max(self.peak_count, self.count)
            self.epoch = epoch
        wal_kw = {"wal": self._wal.path} if self._wal is not None else {}
        _emit("mutation", op=op, edges=int(n), epoch=int(epoch),
              delta_count=int(self.count),
              occupancy=round(self.count / self.capacity, 4), **wal_kw)
        _emit("epoch_advance", from_epoch=int(epoch - 1),
              to_epoch=int(epoch), **wal_kw)
        return epoch

    def append_edges(self, src, dst, weights=None) -> int:
        """Publish one append batch (one new epoch); returns the epoch.
        DeltaFullError when it does not fit."""
        src, dst, n = self._check_pair(src, dst, "append_edges")
        if n == 0:
            return self.epoch
        if self.weighted:
            if weights is None:
                raise ValueError("weighted live graph needs weights for "
                                 "every appended edge")
            w = np.atleast_1d(np.asarray(weights, np.float32))
            if len(w) != n:
                raise ValueError(f"append_edges src/weights length "
                                 f"mismatch ({n} vs {len(w)})")
        else:
            if weights is not None:
                raise ValueError(
                    "append_edges got weights for an UNWEIGHTED live "
                    "graph — build the LiveGraph over a weighted base, "
                    "or drop the weights")
            w = np.zeros(n, np.float32)
        return self._publish("append", src, dst, w)

    def delete_edges(self, src, dst) -> int:
        """Publish one deletion batch: each (src, dst) removes one live
        edge (the ``_apply_ops`` targeting rule); a phantom edge raises
        ValueError before the WAL sees it.  Returns the epoch."""
        src, dst, n = self._check_pair(src, dst, "delete_edges")
        if n == 0:
            return self.epoch
        return self._publish("delete", src, dst, np.zeros(n, np.float32))

    def reweight_edges(self, src, dst, weights) -> int:
        """Publish one weight-update batch (anti-monotone for both
        families); refused on a phantom edge or an unweighted graph.
        Returns the epoch."""
        if not self.weighted:
            raise ValueError(
                "reweight_edges on an UNWEIGHTED live graph — hop-count "
                "semantics have no weights to update; build the "
                "LiveGraph over a weighted base")
        src, dst, n = self._check_pair(src, dst, "reweight_edges")
        if n == 0:
            return self.epoch
        if weights is None:
            raise ValueError("reweight_edges needs the new weights")
        w = np.atleast_1d(np.asarray(weights, np.float32))
        if len(w) != n:
            raise ValueError(f"reweight_edges src/weights length "
                             f"mismatch ({n} vs {len(w)})")
        return self._publish("reweight", src, dst, w)

    def occupancy(self) -> float:
        return self.count / self.capacity

    def memory_terms(self) -> dict:
        """The live graph's byte terms for the memory ledger
        (memwatch.consumer_terms): the five delta arrays (capacity
        sized), the history and the multiset at their nominal entry
        prices, and the WAL handle's bytes."""
        delta = (self.d_src.nbytes + self.d_dst.nbytes + self.d_w.nbytes
                 + self.d_kind.nbytes + self.d_epoch.nbytes)
        return {
            "live_delta": int(delta),
            "live_history": len(self._history) * HISTORY_ENTRY_BYTES,
            "live_multiset": (0 if self._edge_counts is None
                              else len(self._edge_counts)
                              * MULTISET_ENTRY_BYTES),
            "live_wal": 0 if self._wal is None else self._wal.buffer_bytes(),
        }

    # -- pins and admission --------------------------------------------

    def pin(self) -> None:
        with self._lock:
            self.pins += 1

    def unpin(self) -> None:
        with self._lock:
            self.pins = max(0, self.pins - 1)

    def admit(self, family: str | None = None) -> int | None:
        """Count one admitted query and return the epoch it pins, under
        one lock acquisition (a compaction can never fold the stamped
        view away between the two)."""
        with self._lock:
            self.admitted += 1
            if family is None:
                return None
            return self.view_epoch(family)

    def release(self) -> None:
        with self._lock:
            self.admitted = max(0, self.admitted - 1)

    # -- epoch views ---------------------------------------------------

    def anti_pending(self) -> int:
        return len(self._anti)

    def view_epoch(self, family: str = "push") -> int:
        """The epoch a query admitted now pins: the latest, unless an
        anti-monotone op is pending, then the epoch before the earliest
        such op (both families)."""
        anti = list(self._anti)     # a snapshot: compact() clears it
        if anti:
            return min(t[0] for t in anti) - 1
        return self.epoch

    def graph_at(self, epoch: int) -> Graph:
        """The host Graph as of ``epoch`` (origin + every mutation of
        epoch <= e, by ``_apply_ops``; cached): the oracle surface."""
        if not 0 <= epoch <= self.epoch:
            raise ValueError(f"epoch {epoch} outside [0, {self.epoch}]")
        with self._graph_lock:      # an oracle thread may ask meanwhile
            if epoch not in self._graph_cache:
                hist = [h for h in list(self._history) if h[4] <= epoch]
                self._graph_cache[epoch] = _apply_ops(self.origin, hist,
                                                      self.weighted)
            return self._graph_cache[epoch]

    # -- the delta relax -----------------------------------------------

    @staticmethod
    def _evict_dead(cache: dict) -> None:
        """Drop the entries whose weak referent is gone (a rebuilt
        engine or geometry is never probed again under its old id)."""
        for k in [k for k, v in cache.items() if v[0]() is None]:
            del cache[k]

    def _vertex_slots(self, sg) -> np.ndarray:
        """vertex -> padded part-major slot of one geometry, cached per
        geometry (it never changes with the delta)."""
        key = id(sg)
        vs = self._vslot_cache.get(key)
        if vs is None or vs[0]() is not sg:
            self._evict_dead(self._vslot_cache)
            v = np.arange(sg.nv, dtype=np.int64)
            v_part = np.searchsorted(sg.starts, v, side="right") - 1
            v_slot = (v_part * sg.vpad
                      + (v - sg.starts[v_part])).astype(np.int32)
            vs = (weakref.ref(sg), v_slot)
            self._vslot_cache[key] = vs
        return vs[1]

    def delta_arrays(self, sg):
        """The delta block in ``sg``'s padded slots: (src_slot i32,
        dst_slot i32, w f32, kind i32, epoch i32), each [capacity];
        unwritten slots have dst_slot = P * vpad (out of range, so the
        scatter drops them).  Fresh copies, cached per geometry and
        published count."""
        key = id(sg)
        cached = self._slot_cache.get(key)
        n = self.count
        if cached is None or cached[0]() is not sg \
                or cached[1] is not self.d_src or cached[2] < n:
            self._evict_dead(self._slot_cache)
            v_slot = self._vertex_slots(sg)
            src_slot = np.zeros(self.capacity, np.int32)
            dst_slot = np.full(self.capacity, sg.num_parts * sg.vpad,
                               np.int32)
            src_slot[:n] = v_slot[self.d_src[:n]]
            dst_slot[:n] = v_slot[self.d_dst[:n]]
            cached = (weakref.ref(sg), self.d_src, n, src_slot, dst_slot,
                      self.d_w.copy(), self.d_kind.copy(),
                      self.d_epoch.copy())
            # lockcheck: allow(guarded-field) idempotent cache fill
            # (last-writer-wins over immutable published slots);
            # compact()'s under-lock clear targets a generation the
            # engines must refresh_live() past before serving anyway
            self._slot_cache[key] = cached
        return cached[3], cached[4], cached[5], cached[6], cached[7]

    def delta_tensors(self, eng):
        """``delta_arrays(eng.sg)`` on the engine's device, uploaded once
        per translated block."""
        arrs = self.delta_arrays(eng.sg)
        ent = self._dev_cache.get(id(eng))
        if ent is None or ent[0]() is not eng or ent[1] is not arrs[0]:
            self._evict_dead(self._dev_cache)
            ent = (weakref.ref(eng), arrs[0],
                   tuple(torch.from_numpy(a).to(eng.device) for a in arrs))
            self._dev_cache[id(eng)] = ent
        return ent[2]

    def append_deltas(self):
        """The published APPEND slots on the host: (src i64, dst i64, w
        f32, epoch i32), tombstones and overwrites left out (the pull
        runners' correction)."""
        n = self.count
        m = self.d_kind[:n] == DK_APPEND
        return (self.d_src[:n][m].astype(np.int64),
                self.d_dst[:n][m].astype(np.int64),
                self.d_w[:n][m].copy(), self.d_epoch[:n][m].copy())

    def delta_step(self, eng):
        """The delta-relax step of one push engine, cached per engine
        (keyed by id, checked by a weak reference, dead entries evicted
        on a miss)."""
        ent = self._step_cache.get(id(eng))
        if ent is None or ent[0]() is not eng:
            self._evict_dead(self._step_cache)
            step = self._build_delta_step(eng)
            self._step_cache[id(eng)] = (weakref.ref(eng), step)
        else:
            step = ent[1]
        return step

    def _build_delta_step(self, eng):
        """(label [P, vpad(, B)], active, src_slot, dst_slot, w, kind,
        epoch, col_epoch) -> (label, active, improved count as a device
        int32): one gather of the state table by ``src_slot``, the
        program's relax, the identity where the source holds it, the
        per-column epoch mask and the append mask, a scatter min / max
        into the flat table that drops slots outside it (the
        reference's ``mode="drop"``, lux_tpu/livegraph.py:1066-1094),
        and the improved count from a compare of the whole table."""
        prog = eng.program
        sg = eng.sg
        flat_n = sg.num_parts * sg.vpad
        if prog.reduce not in ("min", "max"):
            raise ValueError(
                f"live delta relax requires a monotone min/max program, "
                f"got reduce={prog.reduce!r} (pull kinds use the "
                f"host-side degree correction instead — serve.py)")
        how = "amin" if prog.reduce == "min" else "amax"
        weighted = self.weighted

        def step(label, active, src_slot, dst_slot, w, d_kind, d_epoch,
                 col_epoch):
            ident = torch.as_tensor(prog.identity, dtype=label.dtype,
                                    device=label.device)
            flat = label.reshape((flat_n,) + tuple(label.shape[2:]))
            src_l = flat.index_select(0, src_slot.long())
            cand = prog.relax(src_l, w if weighted else None)
            cand = torch.where(src_l == ident, ident, cand.to(label.dtype))
            col = (-1,) + (1,) * (cand.dim() - 1)
            mask = (d_epoch.view(col) <= col_epoch) \
                & (d_kind == DK_APPEND).view(col)
            cand = torch.where(mask, cand, ident)
            # out-of-range slots land on one spare row, then dropped
            idx = torch.where((dst_slot >= 0) & (dst_slot < flat_n),
                              dst_slot, flat_n).long()
            ext = torch.cat([flat, flat[:1]])
            ext = ext.scatter_reduce(0, idx.view(col).expand_as(cand), cand,
                                     reduce=how, include_self=True)
            new_flat = ext[:flat_n]
            improved = new_flat != flat
            return (new_flat.reshape(label.shape),
                    active | improved.reshape(active.shape),
                    improved.sum(dtype=torch.int32))

        return step

    def register_audit(self, eng) -> None:
        """Expose the delta-relax step to the auditor as the engine's
        ``live_delta`` variant (lux_tpu/livegraph.py:1098), so an audit
        of ``eng`` checks its single state-table gather with the
        engine's own ProgramSpec.  Its arguments: a fresh init state,
        this graph's published delta slots and the published epoch."""
        step = self.delta_step(eng)

        def args():
            label, active = eng.init_state()
            return (label, active, *self.delta_tensors(eng),
                    self.col_epochs(eng, self.epoch))

        eng._register_variant("live_delta", step, args)

    # -- incremental revalidation --------------------------------------

    def col_epochs(self, eng, col_epoch):
        """``col_epoch`` (a scalar, or one per query column) as the
        device int32 the delta step compares with."""
        batched = eng.program.batch
        ce = (np.full(batched, col_epoch, np.int32)
              if batched is not None and np.ndim(col_epoch) == 0
              else np.asarray(col_epoch, np.int32))
        return torch.as_tensor(ce, device=eng.device)

    def revalidate(self, eng, label, active, col_epoch=None):
        """Re-converge a converged state to the published epoch (or to
        per-column epochs): the delta step, then the engine's converge,
        until the delta improves nothing (one host read of the improved
        count a round).  Returns (label, active, engine iterations).
        Past a pending anti-monotone op at or before the target it
        re-seeds instead (``_revalidate_anti``): ``eng`` must then be
        built over ``graph_at(target)`` and ``col_epoch`` be a scalar."""
        if col_epoch is None:
            col_epoch = self.epoch
        anti_min = min((t[0] for t in list(self._anti)), default=None)
        if np.ndim(col_epoch) == 0:
            if anti_min is not None and anti_min <= int(col_epoch):
                return self._revalidate_anti(eng, label, active,
                                             int(col_epoch))
        elif anti_min is not None and anti_min <= int(np.max(col_epoch)):
            raise LiveGraphError(
                f"per-column revalidation cannot cross the pending "
                f"anti-monotone epoch {anti_min} — the re-seed needs ONE "
                f"target epoch; call revalidate with a scalar col_epoch "
                f"and an engine built over graph_at(epoch)")
        step = self.delta_step(eng)
        args = self.delta_tensors(eng)
        ce = self.col_epochs(eng, col_epoch)
        total = 0
        while True:
            label, active, imp = step(label, active, *args, ce)
            if int(imp) == 0:
                break
            label, active, it = eng.converge(label, active)
            total += int(it)
        return label, active, total

    def _revalidate_anti(self, eng, label, active, target: int):
        """The anti-monotone re-seed: the cone (forward reachability
        over ``graph_at(target)`` from every pending anti op's
        destination) restarts from the program's init labels, every
        real vertex is activated, and the engine converges to the
        fixed point; a cone over ``cone_cap * nv`` falls back to a full
        recompute from ``init_state``.  ``eng`` is built over
        ``graph_at(target)``."""
        sg = eng.sg
        g_new = self.graph_at(target)
        if sg.nv != g_new.nv:
            raise LiveGraphError(
                f"re-seed engine geometry nv={sg.nv} does not match "
                f"graph_at({target}).nv={g_new.nv}")
        src, dst = g_new.edge_arrays()
        cone = np.zeros(g_new.nv, dtype=bool)
        touched = [d for (e, _op, _s, d) in list(self._anti) if e <= target]
        cone[np.asarray(touched, np.int64)] = True
        while True:
            add = np.zeros(g_new.nv, dtype=bool)
            add[dst[cone[src]]] = True
            add &= ~cone
            if not add.any():
                break
            cone |= add
        cone_n = int(cone.sum())
        fallback = cone_n > self.cone_cap * g_new.nv
        batched = eng.program.batch
        if fallback:
            label, active = eng.init_state()
        else:
            init_lab, _ = eng.program.init(sg)
            lab_host = sg.from_padded(label.detach().cpu().numpy())
            init_host = sg.from_padded(np.asarray(init_lab))
            cmask = cone if batched is None else cone[:, None]
            new_host = np.where(cmask, init_host, lab_host)
            # every real vertex active (padding stays inactive): the
            # converge also carries appends into the untouched region
            ones = np.ones((g_new.nv,) if batched is None
                           else (g_new.nv, batched), bool)
            label, active = eng.place(sg.to_padded(new_host),
                                      sg.to_padded(ones))
        if self.fault is not None:
            # RESEED_CRASH: between the cone and the converge; recovery
            # comes up with the anti ops still pending
            self.fault.fire_reseed()
        label, active, it = eng.converge(label, active)
        self.reseeds += 1
        if fallback:
            self.reseed_fallbacks += 1
        wal_kw = {"wal": self._wal.path} if self._wal is not None else {}
        _emit("reseed", epoch=int(target), cone=cone_n,
              cone_frac=round(cone_n / g_new.nv, 4),
              fallback=bool(fallback), anti=len(touched), **wal_kw)
        return label, active, int(it)

    # -- compaction ----------------------------------------------------

    def record_drag_sample(self, seconds: float, count: int) -> None:
        """One measured delta-drag sample: a fenced delta-relax boundary
        over ``count`` published slots."""
        if count <= 0 or seconds <= 0:
            return
        self._drag_samples.append(seconds * 1e9 / count)

    def compact_economics(self, constants=None) -> dict:
        """The standing delta drag against the re-pack: drag = slots x
        the card's flat-gather figure (``constants``, default
        scalemodel.H100) until measured samples arrive, then their
        median per slot."""
        from lux_tpu_torch import scalemodel
        c = scalemodel.H100 if constants is None else constants
        occ = self.occupancy()
        modeled = self.count * c.gather_small_ns
        if self._drag_samples:
            per_slot = float(np.median(np.fromiter(self._drag_samples,
                                                   np.float64)))
            drag, source = per_slot * self.count, "measured"
        else:
            drag, source = modeled, "modeled"
        return {
            "occupancy": round(occ, 4),
            "threshold": self.compact_threshold,
            "should_compact": occ >= self.compact_threshold,
            "delta_count": int(self.count),
            "anti_pending": len(self._anti),
            "delta_drag_ns_per_boundary": round(drag, 1),
            "modeled_drag_ns_per_boundary": round(modeled, 1),
            "drag_source": source,
            "drag_samples": len(self._drag_samples),
            "repack_edges": int(self.base.ne + self.count),
        }

    def should_compact(self) -> bool:
        return self.compact_economics()["should_compact"]

    def compact(self, force: bool = False):
        """Fold the published delta into a new base generation and swap
        it in, holding the mutation lock throughout (an append in a
        released window would be lost from both the base and the delta,
        and its WAL record would precede this fold's START marker).
        Returns the new generation, or None when there is nothing to
        fold (or occupancy is under the threshold without ``force``).
        CompactPinnedError while queries pin the generation."""
        with self._lock:
            if self.pins or self.admitted:
                raise CompactPinnedError(
                    f"{self.pins} resident / {self.admitted} admitted "
                    f"query(ies) pin generation {self.generation}; drain "
                    f"before compacting")
            n = self.count
            epoch = self.epoch
            if n == 0 or (not force and not self.should_compact()):
                return None
            new_gen = self.generation + 1
            if self._wal is not None:
                self._wal.append_marker(epoch, REC_COMPACT_START, n,
                                        new_gen)
            _emit("compact_start", epoch=int(epoch), generation=new_gen,
                  delta_count=int(n), occupancy=round(n / self.capacity, 4))
            if self.fault is not None:
                # COMPACT_CRASH: after START, before the swap
                self.fault.fire_compact()
            # origin + the whole op history through _apply_ops: the
            # graph_at construction (and cache), so the live, oracle
            # and recovered bases are one
            new_base = self.graph_at(epoch)
            self.base = new_base
            self.base_epoch = epoch
            self.generation = new_gen
            self._fresh_delta()
            self.count = 0
            self.compactions += 1
            self._anti = [t for t in self._anti if t[0] > epoch]
            self._slot_cache.clear()
            if self._wal is not None:
                self._wal.append_marker(epoch, REC_COMPACT_DONE, new_gen,
                                        epoch)
        _emit("compact_done", epoch=int(epoch), generation=new_gen,
              folded=int(n), ne=int(new_base.ne))
        return new_gen

    # -- recovery ------------------------------------------------------

    @classmethod
    def recover(cls, origin: Graph, wal_path: str, *, fault=None,
                compact_threshold: float = 0.75) -> "LiveGraph":
        """Rebuild from the origin graph + the WAL: verify the chain
        (truncating a torn tail), replay every mutation into the delta
        blocks and re-fold the completed compactions (START..DONE
        pairs); a START without a DONE is ignored, so the surviving
        generation is what the log proves durable.  A fold's base is
        ``_apply_ops`` of the origin and the history through its epoch,
        whatever folded before it, so only the last completed fold is
        built (the reference builds each; the bases are the same)."""
        recs, torn, log = MutationLog.replay(wal_path, nv=origin.nv)
        lg = cls(origin, capacity=log.capacity, wal_path=wal_path,
                 fault=fault, compact_threshold=compact_threshold,
                 _recovering=True)
        lg._wal = log
        pending_start = None
        fold_epoch = None
        for rec in recs:
            if rec.kind in (REC_EDGE, REC_DELETE, REC_REWEIGHT):
                if lg.count >= lg.capacity:
                    raise MutationLogError(
                        wal_path, "capacity_overflow",
                        f"replay overflows the delta capacity "
                        f"{lg.capacity} with no compaction marker — log "
                        f"inconsistent with its own header")
                op = _OP_BY_REC[rec.kind]
                slot = lg.count
                lg.d_src[slot] = rec.a
                lg.d_dst[slot] = rec.b
                w = float(np.uint32(rec.c).view(np.float32))
                lg.d_w[slot] = w
                lg.d_kind[slot] = _DK_BY_OP[op]
                lg.d_epoch[slot] = rec.epoch
                lg.count = slot + 1
                lg._history.append((op, rec.a, rec.b, w, rec.epoch))
                lg.mutations += 1
                if op == "delete":
                    lg.deletions += 1
                    lg._anti.append((rec.epoch, op, rec.a, rec.b))
                elif op == "reweight":
                    lg.reweights += 1
                    lg._anti.append((rec.epoch, op, rec.a, rec.b))
                lg.peak_count = max(lg.peak_count, lg.count)
                lg.epoch = max(lg.epoch, rec.epoch)
            elif rec.kind == REC_COMPACT_START:
                pending_start = rec
            elif rec.kind == REC_COMPACT_DONE:
                if pending_start is None:
                    raise MutationLogError(
                        wal_path, "compact_pair",
                        f"COMPACT_DONE at epoch {rec.epoch} without a "
                        f"preceding COMPACT_START — the log's compaction "
                        f"bracket is broken")
                n = pending_start.a
                fold_epoch = rec.b
                lg.base_epoch = fold_epoch
                lg.generation = rec.a
                # the delta published after the fold's snapshot moves
                # down into a fresh block
                tail = lg.count - n
                ts, td = lg.d_src[n:lg.count].copy(), \
                    lg.d_dst[n:lg.count].copy()
                tw = lg.d_w[n:lg.count].copy()
                tk = lg.d_kind[n:lg.count].copy()
                te = lg.d_epoch[n:lg.count].copy()
                lg._fresh_delta()
                lg.d_src[:tail], lg.d_dst[:tail] = ts, td
                lg.d_w[:tail], lg.d_epoch[:tail] = tw, te
                lg.d_kind[:tail] = tk
                lg.count = tail
                lg.compactions += 1
                lg._anti = [t for t in lg._anti if t[0] > fold_epoch]
                pending_start = None
        if fold_epoch is not None:
            lg.base = _apply_ops(
                lg.origin, [h for h in lg._history if h[4] <= fold_epoch],
                lg.weighted)
        lg._slot_cache.clear()
        _emit("wal_replay", path=wal_path, records=len(recs),
              epoch=int(lg.epoch), generation=int(lg.generation),
              truncated_bytes=int(torn), delta_count=int(lg.count))
        return lg

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()


# ---------------------------------------------------------------------
# the compaction scheduler


class CompactionScheduler:
    """When to fold, under live traffic.  ``decide()`` reads the live
    graph's economics, the admission ledger and an optional SLO burn
    gauge; the first match wins:

    1. empty           -> none   (nothing published or pending)
    2. admitted/pinned -> defer  (never fold a view an admitted query
                                  pins)
    3. slo_burn        -> defer  (burn over ``burn_max`` while occupancy
                                  is under 0.9)
    4. anti_monotone   -> compact (pending deletions / reweights hold
                                  admission back)
    5. occupancy       -> compact (past ``compact_threshold``)
    6. drag            -> compact (the per-boundary delta drag over
                                  ``drag_budget_ns``)
    7. idle            -> none

    ``maybe_compact()`` acts on a compact decision (a pin race demotes
    it to a deferral) and, given the server, refreshes its engines.
    Every compact decision emits ``compact_scheduled`` with its
    economics."""

    def __init__(self, live: LiveGraph, *, burn=None,
                 burn_max: float = 0.5, drag_budget_ns: float = 4096.0):
        self.live = live
        self.burn = burn              # callable -> the current SLO burn
        self.burn_max = float(burn_max)
        self.drag_budget_ns = float(drag_budget_ns)
        self.scheduler_compactions = 0
        self.deferrals = 0

    def decide(self) -> dict:
        lv = self.live
        eco = lv.compact_economics()
        burn = float(self.burn()) if self.burn is not None else 0.0
        base = {
            "occupancy": eco["occupancy"],
            "threshold": eco["threshold"],
            "delta_count": eco["delta_count"],
            "anti_pending": eco["anti_pending"],
            "drag_ns": eco["delta_drag_ns_per_boundary"],
            "drag_source": eco["drag_source"],
            "admitted": int(lv.admitted),
            "pins": int(lv.pins),
            "burn": round(burn, 4),
        }
        if lv.count == 0 and not lv._anti:
            return {"action": "none", "reason": "empty", **base}
        if lv.pins or lv.admitted:
            self.deferrals += 1
            return {"action": "defer", "reason": "admitted", **base}
        if burn > self.burn_max and eco["occupancy"] < 0.9:
            self.deferrals += 1
            return {"action": "defer", "reason": "slo_burn", **base}
        if lv._anti:
            reason = "anti_monotone"
        elif eco["occupancy"] >= eco["threshold"]:
            reason = "occupancy"
        elif eco["delta_drag_ns_per_boundary"] >= self.drag_budget_ns:
            reason = "drag"
        else:
            return {"action": "none", "reason": "idle", **base}
        decision = {"action": "compact", "reason": reason, **base}
        _emit("compact_scheduled", **decision)
        return decision

    def maybe_compact(self, server=None) -> dict:
        decision = self.decide()
        if decision["action"] != "compact":
            return decision
        try:
            gen = self.live.compact(force=True)
        except CompactPinnedError:
            self.deferrals += 1
            return dict(decision, action="defer", reason="pin_race")
        if gen is not None:
            self.scheduler_compactions += 1
            if server is not None:
                server.refresh_live()
        return dict(decision, generation=gen)


# ---------------------------------------------------------------------
# the answers of a live Server against the numpy oracles


def check_live_answers(live: LiveGraph, responses, weighted: bool = False,
                       workers: int = 1) -> int:
    """Hold every response to the apps' numpy oracles on
    ``graph_at(its admission epoch)``: sssp and components bit for bit
    (weighted distances too: the reference's ``np.allclose`` becomes
    equality, exact for integer-valued weights), PageRank within atol
    5e-5 at the query's iterations.  The answers of one (epoch, kind,
    iterations) go through one batched oracle call (its columns are the
    single-source oracle's, bit for bit); ``workers`` > 1 runs the
    groups on that many threads.  Returns the mismatch count."""
    from concurrent.futures import ThreadPoolExecutor

    from lux_tpu_torch.apps import components, pagerank, sssp

    groups: dict = {}
    for r in responses:
        key = (r.epoch or 0, r.kind,
               max(1, r.iters) if r.kind == "pagerank" else 0)
        groups.setdefault(key, []).append(r)
    for epoch in sorted({k[0] for k in groups}):
        live.graph_at(epoch)            # built once, before the threads

    def check(item) -> list:
        (epoch, kind, iters), rs = item
        g_e = live.graph_at(epoch)
        srcs = sorted({int(r.source) for r in rs})
        col = {s: q for q, s in enumerate(srcs)}
        if kind == "sssp":
            ref = sssp.reference_sssp_batched(g_e, srcs, weighted=weighted)
            if not weighted:
                ref = np.minimum(ref, int(sssp.HOP_INF))
        elif kind == "components":
            ref = components.reference_components_batched(g_e, srcs)
        else:
            ref = pagerank.reference_pagerank_batched(
                g_e, pagerank.one_hot_resets(g_e.nv, srcs), iters)
        bad = []
        for r in rs:
            want = ref[:, col[int(r.source)]]
            if kind == "pagerank":
                ok = bool(np.allclose(r.answer, want, atol=5e-5))
            elif kind == "sssp" and weighted:
                ok = np.array_equal(np.asarray(r.answer, np.float64), want)
            else:
                ok = np.array_equal(r.answer.astype(np.int64), want)
            if not ok:
                bad.append(f"LIVE MISMATCH qid={r.qid} kind={kind} "
                           f"source={r.source} epoch={epoch}")
        return bad

    items = sorted(groups.items(), key=lambda kv: kv[0][:2])
    if workers > 1:
        with ThreadPoolExecutor(max_workers=int(workers)) as ex:
            found = list(ex.map(check, items))
    else:
        found = [check(it) for it in items]
    lines = [x for f in found for x in f]
    for line in lines:
        print(line)
    return len(lines)
