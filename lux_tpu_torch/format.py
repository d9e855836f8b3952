"""The .lux binary CSC graph file format and its permutation sidecar
(counterpart of lux_tpu/format.py:51-400 and :479, byte-for-byte the
same formats).

Layout (little-endian):

    offset 0   : nv        uint32      number of vertices
    offset 4   : ne        uint64      number of directed edges
    offset 12  : row_ptrs  uint64[nv]  END offsets: in-edges of vertex v
                                       occupy col_idx[row_ptrs[v-1] : row_ptrs[v]]
    ...        : col_idx   uint32[ne]  edge sources, sorted by destination
    ...        : weights   int32[ne]   optional
    ...        : degrees   uint32[nv]  optional trailing out-degrees

The file does not say whether weights/degrees are present; the layout
is inferred from the file size, with explicit overrides.

The ``.perm`` sidecar (``<file>.lux.perm``) holds a vertex
permutation beside the file instead of rewriting its edge sections:
magic ``LUXP``, uint32 nv, then uint32[nv] ``perm`` with perm[new] =
old (reorder.py writes it, ``Graph.from_file(reorder=...)`` applies
it).  A truncated or non-bijective sidecar raises a typed
GraphFormatError.

The mutation-log (WAL) header of live graphs (livegraph.py): a 16-byte
header (magic ``LUXW``, uint32 version, uint32 nv, uint32 delta
capacity) before the log's 24-byte chained records.  A log of another
graph (nv mismatch) or a foreign file raises a typed GraphFormatError
instead of replaying wrong mutations.

The serving fleet's admission-journal header (journal.py): 16 bytes
(magic ``LUXJ``, uint32 version, uint32 nv, uint32 reserved) before the
journal's 48-byte chained records.  The nv binds the journal to its
graph: a journal of another graph, a foreign file or an unknown version
raises a typed GraphFormatError instead of re-dispatching queries.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

HEADER_SIZE = 12

V_DTYPE = np.dtype("<u4")
E_DTYPE = np.dtype("<u8")
W_DTYPE = np.dtype("<i4")   # weights: int32, the reference's WeightType


class GraphFormatError(ValueError):
    """A .lux file (or in-memory CSC graph) failed structural
    validation.  ``check`` names the violated invariant (header,
    section_size, weighted_mismatch, ambiguous_layout,
    row_ptrs_monotone, row_ptrs_total, col_idx_range, degrees_length,
    degrees_consistent, partition_edges, perm_header, perm_length,
    perm_bijection, wal_header, wal_version, wal_capacity,
    journal_header, journal_version)."""

    def __init__(self, path: str, check: str, detail: str):
        super().__init__(f"{path}: invalid graph [{check}] — {detail}")
        self.path = path
        self.check = check
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class LuxFileHeader:
    nv: int
    ne: int
    has_weights: bool
    has_degrees: bool


def _infer_sections(path: str, nv: int, ne: int, weighted: bool | None):
    """Infer optional-section presence from total file size."""
    size = os.path.getsize(path)
    base = HEADER_SIZE + 8 * nv + 4 * ne
    wbytes = W_DTYPE.itemsize * ne
    candidates = {
        (False, False): base,
        (False, True): base + 4 * nv,
        (True, False): base + wbytes,
        (True, True): base + wbytes + 4 * nv,
    }
    matches = [k for k, v in candidates.items() if v == size]
    if weighted is not None:
        filtered = [m for m in matches if m[0] == weighted]
        if matches and not filtered:
            have = "a weighted" if matches[0][0] else "an unweighted"
            want = "weighted" if weighted else "unweighted"
            raise GraphFormatError(
                path, "weighted_mismatch",
                f"looks like {have} graph but was opened as "
                f"{want} (nv={nv} ne={ne} size={size})")
        matches = filtered
    if not matches:
        raise GraphFormatError(
            path, "section_size",
            f"size {size} does not match any .lux layout for "
            f"nv={nv} ne={ne} (expected one of "
            f"{sorted(candidates.values())}) — truncated or torn file?")
    if len(matches) > 1:
        raise GraphFormatError(
            path, "ambiguous_layout",
            f"size matches layouts {matches}; pass weighted=True/"
            f"False explicitly")
    return matches[0]


def peek_lux(path: str, weighted: bool | None = None) -> LuxFileHeader:
    """Read only the 12-byte header + infer the section layout."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    if len(head) != HEADER_SIZE:
        raise GraphFormatError(path, "header",
                               f"only {len(head)} bytes, a .lux "
                               f"header is {HEADER_SIZE}")
    nv = int(np.frombuffer(head, V_DTYPE, count=1, offset=0)[0])
    ne = int(np.frombuffer(head, E_DTYPE, count=1, offset=4)[0])
    has_w, has_d = _infer_sections(path, nv, ne, weighted)
    return LuxFileHeader(nv=nv, ne=ne, has_weights=has_w, has_degrees=has_d)


def validate_graph(nv: int, ne: int, row_ptrs, col_idx,
                   degrees=None, path: str = "<arrays>") -> None:
    """Structural CSC invariants, each violation a typed
    :class:`GraphFormatError` naming the check and the first offending
    index: monotone END offsets with ``row_ptrs[-1] == ne``; every
    source in ``[0, nv)``; ``degrees`` (when present) of length nv and
    exactly the out-degree histogram of ``col_idx``.  A gather with an
    out-of-range index on the card would read garbage or fault, so a
    malformed file must stop here."""
    row_ptrs = np.asarray(row_ptrs)
    col_idx = np.asarray(col_idx)
    if row_ptrs.shape[0] != nv:
        raise GraphFormatError(
            path, "row_ptrs_total",
            f"{row_ptrs.shape[0]} row_ptrs for nv={nv}")
    if nv:
        d = np.diff(row_ptrs.astype(np.int64))
        if row_ptrs[0] > ne or (d < 0).any():
            at = (0 if row_ptrs[0] > ne
                  else int(np.argmax(d < 0)) + 1)
            raise GraphFormatError(
                path, "row_ptrs_monotone",
                f"end offsets decrease at vertex {at} "
                f"(row_ptrs[{at}]={int(row_ptrs[at])})")
        if int(row_ptrs[-1]) != ne:
            raise GraphFormatError(
                path, "row_ptrs_total",
                f"row_ptrs[-1]={int(row_ptrs[-1])} != ne={ne}")
    elif ne:
        raise GraphFormatError(path, "row_ptrs_total",
                               f"nv=0 but ne={ne}")
    if col_idx.shape[0] != ne:
        raise GraphFormatError(
            path, "col_idx_range",
            f"{col_idx.shape[0]} col_idx entries for ne={ne}")
    if ne:
        c64 = col_idx.astype(np.int64, copy=False)
        bad = (c64 < 0) | (c64 >= nv)
        if bad.any():
            at = int(np.argmax(bad))
            raise GraphFormatError(
                path, "col_idx_range",
                f"col_idx[{at}]={int(c64[at])} outside [0, {nv})")
    if degrees is not None:
        degrees = np.asarray(degrees)
        if degrees.shape[0] != nv:
            raise GraphFormatError(
                path, "degrees_length",
                f"{degrees.shape[0]} degrees for nv={nv}")
        want = np.bincount(col_idx.astype(np.int64, copy=False),
                           minlength=nv)
        got = degrees.astype(np.int64, copy=False)
        if not np.array_equal(got, want):
            at = int(np.argmax(got != want))
            raise GraphFormatError(
                path, "degrees_consistent",
                f"degrees[{at}]={int(got[at])} but col_idx counts "
                f"{int(want[at])} out-edges")


def read_lux(path: str, weighted: bool | None = None,
             validate: bool = False):
    """Read a .lux file -> (header, row_ptrs[u8 nv], col_idx[u4 ne],
    weights[i4 ne]|None, degrees|None), the sections memory-mapped.
    validate=True runs :func:`validate_graph`."""
    hdr = peek_lux(path, weighted)
    off = HEADER_SIZE

    def arr(dtype, count, offset):
        return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                         shape=(count,))

    row_ptrs = arr(E_DTYPE, hdr.nv, off)
    off += 8 * hdr.nv
    col_idx = arr(V_DTYPE, hdr.ne, off)
    off += 4 * hdr.ne
    weights = None
    if hdr.has_weights:
        weights = arr(W_DTYPE, hdr.ne, off)
        off += W_DTYPE.itemsize * hdr.ne
    degrees = None
    if hdr.has_degrees:
        degrees = arr(V_DTYPE, hdr.nv, off)
    if validate:
        validate_graph(hdr.nv, hdr.ne, row_ptrs, col_idx,
                       degrees=degrees, path=path)
    return hdr, row_ptrs, col_idx, weights, degrees


PERM_MAGIC = b"LUXP"
PERM_SUFFIX = ".perm"


def perm_sidecar_path(lux_path: str) -> str:
    return lux_path + PERM_SUFFIX


def validate_perm(perm, nv: int, path: str = "<perm>") -> None:
    """The sidecar's invariants: length nv (``perm_length``) and a
    bijection of [0, nv) (``perm_bijection``)."""
    perm = np.asarray(perm)
    if perm.ndim != 1 or perm.shape[0] != nv:
        raise GraphFormatError(
            path, "perm_length",
            f"{perm.shape} permutation for nv={nv}")
    if nv:
        p64 = perm.astype(np.int64, copy=False)
        seen = np.zeros(nv, bool)
        bad = (p64 < 0) | (p64 >= nv)
        if bad.any():
            at = int(np.argmax(bad))
            raise GraphFormatError(
                path, "perm_bijection",
                f"perm[{at}]={int(p64[at])} outside [0, {nv})")
        seen[p64] = True
        if not seen.all():
            at = int(np.argmax(~seen))
            raise GraphFormatError(
                path, "perm_bijection",
                f"vertex {at} never appears (duplicate entries "
                f"elsewhere) — not a bijection of [0, {nv})")


def write_perm_sidecar(lux_path: str, perm, path: str | None = None) -> str:
    """Write ``perm`` (perm[new] = old) beside ``lux_path``, validated
    first: a corrupt sidecar is never written, only detected.  Returns
    the sidecar's path."""
    perm = np.ascontiguousarray(perm, dtype=V_DTYPE)
    out = path or perm_sidecar_path(lux_path)
    validate_perm(perm, perm.shape[0], out)
    with open(out, "wb") as f:
        f.write(PERM_MAGIC)
        f.write(np.array([perm.shape[0]], V_DTYPE).tobytes())
        f.write(perm.tobytes())
    return out


def read_perm_sidecar(lux_path: str, nv: int | None = None,
                      path: str | None = None) -> np.ndarray:
    """Read and validate the sidecar beside ``lux_path``.  ``nv`` (the
    .lux header's vertex count) must match the sidecar's: a sidecar of
    another graph raises instead of relabelling."""
    p = path or perm_sidecar_path(lux_path)
    with open(p, "rb") as f:
        head = f.read(8)
        if len(head) != 8 or head[:4] != PERM_MAGIC:
            raise GraphFormatError(
                p, "perm_header",
                f"bad magic {head[:4]!r} (a .perm sidecar starts "
                f"with {PERM_MAGIC!r})")
        n = int(np.frombuffer(head, V_DTYPE, count=1, offset=4)[0])
        perm = np.frombuffer(f.read(), V_DTYPE)
    if perm.shape[0] != n:
        raise GraphFormatError(
            p, "perm_length",
            f"header says nv={n} but payload holds {perm.shape[0]} "
            f"entries — truncated or torn sidecar?")
    if nv is not None and n != nv:
        raise GraphFormatError(
            p, "perm_length",
            f"sidecar nv={n} does not match the graph's nv={nv} — "
            f"sidecar from a different graph?")
    validate_perm(perm, n, p)
    return perm


# ---------------------------------------------------------------------
# the mutation-log (WAL) header of live graphs

WAL_MAGIC = b"LUXW"
# v1: append-only (record kinds EDGE / COMPACT_START / COMPACT_DONE);
# v2: the full mutation algebra (DELETE and REWEIGHT join).  The record
# layout is the same, so a v2 reader replays v1 logs bit for bit; a v2
# kind inside a v1 header is typed corruption (livegraph.MutationLog).
WAL_VERSION = 2
WAL_KNOWN_VERSIONS = (1, 2)
WAL_HEADER_SIZE = 16
WAL_RECORD_SIZE = 24
WAL_SUFFIX = ".wal"


def wal_sidecar_path(lux_path: str) -> str:
    return lux_path + WAL_SUFFIX


def pack_wal_header(nv: int, capacity: int,
                    version: int = WAL_VERSION) -> bytes:
    if version not in WAL_KNOWN_VERSIONS:
        raise ValueError(f"unknown WAL version {version} "
                         f"(known: {WAL_KNOWN_VERSIONS})")
    return WAL_MAGIC + np.array([version, nv, capacity], V_DTYPE).tobytes()


def read_wal_header(path: str, nv: int | None = None,
                    head: bytes | None = None):
    """Read and validate a mutation-log header; returns (nv, capacity,
    version).  ``nv``, when given, must match the header's.  ``head``
    skips the file read (the replay already holds the bytes)."""
    if head is None:
        with open(path, "rb") as f:
            head = f.read(WAL_HEADER_SIZE)
    if len(head) != WAL_HEADER_SIZE or head[:4] != WAL_MAGIC:
        raise GraphFormatError(
            path, "wal_header",
            f"bad magic/length {head[:4]!r} ({len(head)} bytes) — a "
            f"mutation log starts with {WAL_MAGIC!r} and a "
            f"{WAL_HEADER_SIZE}-byte header")
    ver, hnv, cap = (int(x) for x in
                     np.frombuffer(head, V_DTYPE, count=3, offset=4))
    if ver not in WAL_KNOWN_VERSIONS:
        raise GraphFormatError(
            path, "wal_version",
            f"log version {ver}, this build reads {WAL_KNOWN_VERSIONS}")
    if cap < 1:
        raise GraphFormatError(
            path, "wal_capacity", f"delta capacity {cap} must be >= 1")
    if nv is not None and hnv != nv:
        raise GraphFormatError(
            path, "wal_header",
            f"log written for nv={hnv} but the graph has nv={nv} — "
            f"mutation log from a different graph?")
    return hnv, cap, ver



# ---------------------------------------------------------------------
# the admission-journal header of the serving fleet

JOURNAL_MAGIC = b"LUXJ"
JOURNAL_VERSION = 1
JOURNAL_KNOWN_VERSIONS = (1,)
JOURNAL_HEADER_SIZE = 16
JOURNAL_RECORD_SIZE = 48
JOURNAL_SUFFIX = ".journal"


def journal_sidecar_path(lux_path: str) -> str:
    return lux_path + JOURNAL_SUFFIX


def pack_journal_header(nv: int, version: int = JOURNAL_VERSION) -> bytes:
    if version not in JOURNAL_KNOWN_VERSIONS:
        raise ValueError(f"unknown journal version {version} "
                         f"(known: {JOURNAL_KNOWN_VERSIONS})")
    return JOURNAL_MAGIC + np.array([version, nv, 0], V_DTYPE).tobytes()


def read_journal_header(path: str, nv: int | None = None,
                        head: bytes | None = None):
    """Read and validate an admission-journal header; returns (nv,
    version).  ``nv``, when given, must match the header's: a journal
    copied from another graph would re-dispatch sources and epochs it
    was never admitted for.  ``head`` skips the file read."""
    if head is None:
        with open(path, "rb") as f:
            head = f.read(JOURNAL_HEADER_SIZE)
    if len(head) != JOURNAL_HEADER_SIZE or head[:4] != JOURNAL_MAGIC:
        raise GraphFormatError(
            path, "journal_header",
            f"bad magic/length {head[:4]!r} ({len(head)} bytes) — an "
            f"admission journal starts with {JOURNAL_MAGIC!r} and a "
            f"{JOURNAL_HEADER_SIZE}-byte header")
    ver, hnv, _rsvd = (int(x) for x in
                       np.frombuffer(head, V_DTYPE, count=3, offset=4))
    if ver not in JOURNAL_KNOWN_VERSIONS:
        raise GraphFormatError(
            path, "journal_version",
            f"journal version {ver}, this build reads "
            f"{JOURNAL_KNOWN_VERSIONS}")
    if nv is not None and hnv != nv:
        raise GraphFormatError(
            path, "journal_header",
            f"journal written for nv={hnv} but the graph has nv={nv} — "
            f"admission journal from a different graph?")
    return hnv, ver

def write_lux(path: str, row_ptrs, col_idx, weights=None, degrees=None):
    """Write a .lux file from CSC arrays (row_ptrs are END offsets)."""
    row_ptrs = np.ascontiguousarray(row_ptrs, dtype=E_DTYPE)
    col_idx = np.ascontiguousarray(col_idx, dtype=V_DTYPE)
    nv = row_ptrs.shape[0]
    ne = col_idx.shape[0]
    if nv and int(row_ptrs[-1]) != ne:
        raise ValueError(f"row_ptrs[-1]={row_ptrs[-1]} != ne={ne}")
    with open(path, "wb") as f:
        f.write(np.array([nv], V_DTYPE).tobytes())
        f.write(np.array([ne], E_DTYPE).tobytes())
        f.write(row_ptrs.tobytes())
        f.write(col_idx.tobytes())
        if weights is not None:
            w = np.ascontiguousarray(weights)
            if w.shape[0] != ne:
                raise ValueError("weights length mismatch")
            f.write(w.tobytes())
        if degrees is not None:
            d = np.ascontiguousarray(degrees, dtype=V_DTYPE)
            if d.shape[0] != nv:
                raise ValueError("degrees length mismatch")
            f.write(d.tobytes())
