"""The durable admission journal: the serving fleet's crash ledger
(counterpart of lux_tpu/journal.py, byte for byte the same files).

Without it the fleet (fleet.py) holds admission state only in memory,
and a whole-fleet crash loses every admitted-but-unretired query.  The
journal gives admission the durability the mutation WAL
(livegraph.MutationLog) gives graph state:

* every ADMITTED query appends one 48-byte CRC-chained record and
  fsyncs it before the query is queued (format.py owns the ``LUXJ``
  header: magic, version, nv);
* every retirement (an answer or a late shed) appends a RETIRE record
  closing the entry, so recovery retires each qid exactly once;
* ``FleetServer.recover`` replays the journal after a crash and
  re-dispatches every admitted-unretired query at its original
  admission epoch.

Corruption follows MutationLog: a torn tail (a strict prefix of one
record, what a power loss mid-append leaves) is recoverable and
``replay`` truncates it; a full-size record failing the chain CRC is rot
of a possibly acknowledged append and raises typed (``crc_chain``);
ADMIT/RETIRE pairing is validated at rest (``admit_dup``,
``retire_unmatched``, ``retire_dup``, ``qid_order``).

Record layout (12 little-endian uint32 words, 48 bytes):

  w0   record kind: 1=ADMIT, 2=RETIRE
  w1   qid
  ADMIT:  w2 query-kind code (index into serve.KINDS)
          w3 source  (0xFFFFFFFF = personalized/reset query)
          w4 admission epoch (0xFFFFFFFF = static graph)
          w5 deadline in ms (0 = no deadline)
          w6 priority (two's-complement int32)
          w7-w8  tenant, UTF-8, zero-padded to 8 bytes
          w9-w10 first 8 bytes of the blake2b reset digest (zeros
                 when the query has no reset vector)
  RETIRE: w2 cause: 1=answered, 2=shed; w3..w10 zero
  w11  crc = chained_crc32(first 44 bytes, previous record's crc); the
       chain seeds from the header's CRC.

A reset vector is nv floats and cannot live in a fixed record: the
journal keeps its digest, and recovery re-dispatches a reset query only
when the caller supplies the vector again
(``FleetServer.recover(resets=...)``), else closes it as a typed shed.
The journal is a host object: nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from lux_tpu_torch import format as luxfmt
from lux_tpu_torch.checkpoint import chained_crc32

# record kinds (w0)
JREC_ADMIT = 1
JREC_RETIRE = 2

# retirement causes (w2 of a RETIRE record): "answered" closes with a
# delivered Response, "shed" with a typed AdmissionError after admission
RETIRE_ANSWERED = 1
RETIRE_SHED = 2
_CAUSE_NAMES = {RETIRE_ANSWERED: "answered", RETIRE_SHED: "shed"}
_CAUSE_CODES = {v: k for k, v in _CAUSE_NAMES.items()}

_U32_NONE = 0xFFFFFFFF   # source/epoch "absent" sentinel
TENANT_BYTES = 8
DIGEST_BYTES = 8


def _emit(kind: str, **fields):
    from lux_tpu_torch import telemetry
    telemetry.current().emit(kind, **fields)


class AdmissionJournalError(RuntimeError):
    """The admission journal failed verification.  Carries ``path``,
    ``check`` (torn_tail / crc_chain / record_kind / qid_order /
    admit_dup / retire_unmatched / retire_dup / tenant_size /
    journal_exists) and ``detail``.  Only a torn tail is recoverable
    (``replay`` truncates it); every other check is corruption that
    must never re-dispatch."""

    def __init__(self, path: str, check: str, detail: str):
        super().__init__(f"{path}: admission journal [{check}] — {detail}")
        self.path = path
        self.check = check
        self.detail = detail


def reset_digest(reset) -> bytes:
    """The 8-byte blake2b fingerprint of a reset vector's float32
    bytes."""
    buf = np.ascontiguousarray(reset, np.float32).tobytes()
    return hashlib.blake2b(buf, digest_size=DIGEST_BYTES).digest()


def _kinds() -> tuple:
    from lux_tpu_torch.serve import KINDS
    return KINDS


def _kind_name(code: int, path: str, off: int) -> str:
    kinds = _kinds()
    if not 0 <= code < len(kinds):
        raise AdmissionJournalError(
            path, "record_kind",
            f"ADMIT record at byte {off} names query-kind code {code} "
            f"outside {tuple(range(len(kinds)))} ({kinds}) with a VALID "
            f"chain CRC — journal written by a newer/foreign build, "
            f"refusing to re-dispatch")
    return kinds[code]


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One decoded ADMIT entry (RETIREs fold into the scan's retired
    map)."""
    qid: int
    kind: str
    source: int | None
    epoch: int | None
    deadline_s: float | None
    priority: int
    tenant: str
    digest: bytes | None       # 8-byte reset digest, None = source query


def _encode_admit(path: str, qid: int, kind: str, source: int | None,
                  epoch: int | None, deadline_s: float | None,
                  priority: int, tenant: str,
                  digest: bytes | None) -> np.ndarray:
    tb = tenant.encode("utf-8")
    if len(tb) > TENANT_BYTES:
        raise AdmissionJournalError(
            path, "tenant_size",
            f"tenant {tenant!r} is {len(tb)} UTF-8 bytes; the journal "
            f"record holds {TENANT_BYTES} — journalled fleets need short "
            f"tenant ids (the quota key must survive the crash byte for "
            f"byte, not truncated)")
    tb = tb.ljust(TENANT_BYTES, b"\x00")
    db = (digest or b"").ljust(DIGEST_BYTES, b"\x00")
    # rounded UP, so a tiny positive deadline never becomes the
    # no-deadline sentinel
    dl_ms = 0 if deadline_s is None else max(
        1, int(np.ceil(float(deadline_s) * 1000.0)))
    words = np.zeros(11, luxfmt.V_DTYPE)
    words[0] = JREC_ADMIT
    words[1] = qid
    words[2] = _kinds().index(kind)
    words[3] = _U32_NONE if source is None else int(source)
    words[4] = _U32_NONE if epoch is None else int(epoch)
    words[5] = min(dl_ms, _U32_NONE - 1)
    words[6] = priority & 0xFFFFFFFF
    words[7:9] = np.frombuffer(tb, luxfmt.V_DTYPE)
    words[9:11] = np.frombuffer(db, luxfmt.V_DTYPE)
    return words


def _decode_admit(words, path: str, off: int) -> JournalRecord:
    source, epoch, dl_ms, prio = (int(words[i]) for i in (3, 4, 5, 6))
    digest = words[9:11].tobytes()
    return JournalRecord(
        qid=int(words[1]), kind=_kind_name(int(words[2]), path, off),
        source=None if source == _U32_NONE else source,
        epoch=None if epoch == _U32_NONE else epoch,
        deadline_s=None if dl_ms == 0 else dl_ms / 1000.0,
        priority=prio if prio < 2 ** 31 else prio - 2 ** 32,
        tenant=words[7:9].tobytes().rstrip(b"\x00").decode("utf-8"),
        digest=None if digest == b"\x00" * DIGEST_BYTES else digest)


class AdmissionJournal:
    """The CRC-chained append-only admission log.  One instance owns an
    open append handle; each ``append_*`` writes one record and fsyncs.
    ``scan`` verifies without modifying; ``replay`` also truncates a
    torn tail and returns a handle resumed at the end."""

    def __init__(self, path: str, nv: int,
                 version: int = luxfmt.JOURNAL_VERSION,
                 _resume: tuple | None = None):
        self.path = path
        self.nv = int(nv)
        self.version = int(version)
        self.records = 0        # records appended THROUGH this handle
        if _resume is None:
            header = luxfmt.pack_journal_header(self.nv,
                                                version=self.version)
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644)
            except FileExistsError:
                raise AdmissionJournalError(
                    path, "journal_exists",
                    "an admission journal already exists at this path — "
                    "a fresh journal would orphan its admitted-unretired "
                    "entries; use FleetServer.recover(g, path) to replay "
                    "it, or remove the file to start over") from None
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
        self._f.write(record)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._crc = int(np.frombuffer(record, luxfmt.V_DTYPE)[11])
        self.records += 1

    def buffer_bytes(self) -> int:
        """Host bytes this handle accounts for in the byte ledger: the
        header and every record appended through it."""
        return (luxfmt.JOURNAL_HEADER_SIZE
                + self.records * luxfmt.JOURNAL_RECORD_SIZE)

    def _seal(self, words: np.ndarray) -> bytes:
        body = words.tobytes()
        crc = chained_crc32(body, self._crc)
        return body + np.array([crc], luxfmt.V_DTYPE).tobytes()

    def pack_admit(self, req) -> bytes:
        """One ADMIT record for a serve.Request at the current chain
        position (the bytes the append would write)."""
        digest = reset_digest(req.reset) if req.reset is not None else None
        return self._seal(_encode_admit(
            self.path, req.qid, req.kind, req.source, req.epoch,
            req.deadline_s, req.priority, req.tenant, digest))

    def pack_retire(self, qid: int, cause: str) -> bytes:
        words = np.zeros(11, luxfmt.V_DTYPE)
        words[0] = JREC_RETIRE
        words[1] = qid
        words[2] = _CAUSE_CODES[cause]
        return self._seal(words)

    def append_admit(self, req) -> None:
        self._append(self.pack_admit(req))

    def append_retire(self, qid: int, cause: str = "answered") -> None:
        self._append(self.pack_retire(qid, cause))

    def write_torn(self, record: bytes) -> None:
        """Fault injection: persist a STRICT PREFIX of ``record`` (what
        a power loss mid-append leaves) and fsync it."""
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
        """Verify the whole journal without modifying it.  Returns
        (open_records, retired, header_nv, torn_bytes): the
        admitted-unretired entries in qid order, the closed qids' causes,
        and a recoverable torn tail's length (0 when clean).  Corruption
        raises AdmissionJournalError."""
        opens, retired, hnv, tail, _crc, _ver = cls._scan(path, nv=nv)
        return opens, retired, hnv, tail

    @classmethod
    def _scan(cls, path: str, nv: int | None = None):
        with open(path, "rb") as f:
            blob = f.read()
        head = blob[:luxfmt.JOURNAL_HEADER_SIZE]
        hnv, ver = luxfmt.read_journal_header(path, nv=nv, head=head)
        crc = chained_crc32(head)
        open_by_qid: dict[int, JournalRecord] = {}
        retired: dict[int, str] = {}
        off = luxfmt.JOURNAL_HEADER_SIZE
        R = luxfmt.JOURNAL_RECORD_SIZE
        last_qid = -1
        bad_at = None
        while off + R <= len(blob):
            raw = blob[off:off + R]
            words = np.frombuffer(raw, luxfmt.V_DTYPE)
            if int(words[11]) != chained_crc32(raw[:R - 4], crc):
                bad_at = off
                break
            rec, qid = int(words[0]), int(words[1])
            if rec == JREC_ADMIT:
                if qid in open_by_qid or qid in retired:
                    raise AdmissionJournalError(
                        path, "admit_dup",
                        f"ADMIT record at byte {off} re-admits qid {qid} "
                        f"with a VALID chain CRC — qids are issued once; "
                        f"the journal is corrupt or spliced")
                if qid <= last_qid:
                    raise AdmissionJournalError(
                        path, "qid_order",
                        f"ADMIT record at byte {off} carries qid {qid} "
                        f"after qid {last_qid} — the monotone qid counter "
                        f"never goes backwards; the journal is corrupt "
                        f"or spliced")
                last_qid = qid
                open_by_qid[qid] = _decode_admit(words, path, off)
            elif rec == JREC_RETIRE:
                cause = int(words[2])
                if cause not in _CAUSE_NAMES:
                    raise AdmissionJournalError(
                        path, "record_kind",
                        f"RETIRE record at byte {off} carries cause "
                        f"{cause} outside {tuple(_CAUSE_NAMES)} with a "
                        f"VALID chain CRC — journal written by a "
                        f"newer/foreign build, refusing to re-dispatch")
                if qid in retired:
                    raise AdmissionJournalError(
                        path, "retire_dup",
                        f"RETIRE record at byte {off} re-retires qid "
                        f"{qid} — exactly-once retirement is the "
                        f"journal's contract; a double close means the "
                        f"writer double-answered or the journal is "
                        f"corrupt")
                if qid not in open_by_qid:
                    raise AdmissionJournalError(
                        path, "retire_unmatched",
                        f"RETIRE record at byte {off} closes qid {qid} "
                        f"that no ADMIT opened — the journal is corrupt "
                        f"or spliced")
                del open_by_qid[qid]
                retired[qid] = _CAUSE_NAMES[cause]
            else:
                raise AdmissionJournalError(
                    path, "record_kind",
                    f"record at byte {off} has kind {rec} outside "
                    f"({JREC_ADMIT}, {JREC_RETIRE}) with a VALID chain "
                    f"CRC — journal written by a newer/foreign build, "
                    f"refusing to re-dispatch")
            crc = int(words[11])
            off += R
        tail = len(blob) - off
        if bad_at is not None:
            # a torn append leaves only a strict prefix; a full-size
            # bad-CRC record is rot of a possibly acknowledged record
            behind = len(blob) - bad_at - R
            what = (f"with {behind} byte(s) of further records behind it "
                    f"— mid-file corruption" if behind else
                    "at full record size — corruption of a "
                    "possibly-acknowledged final record")
            raise AdmissionJournalError(
                path, "crc_chain",
                f"record at byte {bad_at} fails the CRC chain {what}, not "
                f"a torn append; refusing to re-dispatch")
        opens = sorted(open_by_qid.values(), key=lambda r: r.qid)
        return opens, retired, hnv, tail, crc, ver

    @classmethod
    def replay(cls, path: str, nv: int | None = None):
        """Crash recovery: scan, truncate a torn tail in place (it was
        never acknowledged) and return (open_records, retired,
        truncated_bytes, a journal handle resumed at the end)."""
        opens, retired, hnv, torn, crc, ver = cls._scan(path, nv=nv)
        good = os.path.getsize(path) - torn
        if torn:
            with open(path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            _emit("journal_truncate", path=path, torn_bytes=int(torn),
                  open=len(opens), retired=len(retired))
        journal = cls(path, hnv, version=ver, _resume=(good, crc))
        return opens, retired, torn, journal
