"""The port's native host tools (counterpart of lux_tpu/native/): the
pthread ``.lux`` loader (loader.cc), the stable parallel radix sort
(sort.cc), the R-MAT generator (rmat.cc), the clustering vertex reorder
(reorder.cc) and the ``lux_converter`` CLI (converter.cc), with the
reference's C ABI.

The library is built with ``g++`` (or ``$CXX``) at first use into the
git-ignored ``lux_tpu_torch/_build/``, under a file name that carries a
hash of the sources and the flags, and loaded with ``ctypes``; importing
this module builds nothing.  A build goes to a temporary file that
``os.replace`` moves into place, so processes building at once never
load a partial library.

There is no silent fallback: a missing compiler or a refused source
raises :class:`NativeBuildError` carrying the compiler's output.  The
numpy versions are the plain versions; only a caller that asks for them
gets them: ``native=False`` on one call of ``sort_kv``, ``stable_sort``,
``argsort_u64`` or ``reorder_cluster``, or ``use_numpy()`` /
``numpy_versions()`` for every call that does not say, which reaches
every builder that sorts (for a machine with no C++ compiler).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"

LIB_SOURCES = ("loader.cc", "rmat.cc", "sort.cc", "reorder.cc")
CONVERTER_SOURCE = "converter.cc"
SANITIZE_SOURCE = "sanitize_driver.cc"
LIB_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-shared", "-fPIC",
             "-pthread")
CONVERTER_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra")
# lux_tpu/native/Makefile's sanitize target
SANITIZE_FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all", "-Wall", "-Wextra", "-Werror")

# lux_tpu/native/Makefile's analyze target: -fanalyzer needs a real
# compilation (-fsyntax-only stops before the analyzer pass)
ANALYZE_SOURCES = ("converter.cc", "loader.cc", "rmat.cc", "sort.cc",
                   "reorder.cc")
ANALYZE_FLAGS = ("-fanalyzer", "-O1", "-std=c++17", "-Wall", "-Wextra",
                 "-Werror")

MAX_PAYLOADS = 4        # sort.cc kMaxPay


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused a native source.
    ``stderr`` holds the compiler's output."""

    def __init__(self, message: str, stderr: str = ""):
        super().__init__(message + (f"\n{stderr}" if stderr else ""))
        self.stderr = stderr


_lib = None
_LOCK = threading.Lock()
_NUMPY = False          # use_numpy(): the default of native= is False


def use_numpy(on: bool = True) -> bool:
    """Run every ``sort_kv`` / ``stable_sort`` / ``argsort_u64`` /
    ``reorder_cluster`` call that passes no ``native=`` with its numpy
    version (``on``), or with the C++ library (``on=False``, the
    default); ``ShardedGraph.build_from_file`` then reads through the
    mmap path.  Returns the previous setting."""
    global _NUMPY
    prev, _NUMPY = _NUMPY, bool(on)
    return prev


def numpy_only() -> bool:
    """Whether ``use_numpy`` is on."""
    return _NUMPY


@contextlib.contextmanager
def numpy_versions():
    """``use_numpy()`` for the body of a ``with`` block."""
    prev = use_numpy(True)
    try:
        yield
    finally:
        use_numpy(prev)


def _native_wanted(native: bool | None) -> bool:
    return not _NUMPY if native is None else bool(native)


def compiler() -> str:
    """The C++ compiler: ``$CXX`` (its first word), else ``g++``."""
    return (os.environ.get("CXX") or "g++").split()[0]


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for name in sources:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"liblux_native-{_digest(LIB_SOURCES, LIB_FLAGS)}.so"


def _converter_out() -> Path:
    return BUILD_DIR / (f"lux_converter-"
                        f"{_digest((CONVERTER_SOURCE,), CONVERTER_FLAGS)}")


def compile_to(out: Path, sources, flags, cxx: str | None = None) -> float:
    """Compile ``sources`` (names under this directory, or paths) with
    ``flags`` into ``out`` through a temporary file moved into place.
    Returns the compiler's seconds; raises NativeBuildError."""
    cxx = cxx or compiler()
    exe = shutil.which(cxx)
    if exe is None:
        raise NativeBuildError(
            f"C++ compiler {cxx!r} not found: the native host tools are "
            f"built from lux_tpu_torch/native with g++ (set CXX, or pass "
            f"use native.use_numpy() for the numpy versions)")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [exe, *flags, "-o", str(tmp),
           *[str(SRC_DIR / s) if not os.path.isabs(str(s)) else str(s)
             for s in sources]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{cxx} failed (exit {proc.returncode}) building {out.name}",
            proc.stderr)
    os.replace(tmp, out)          # atomic: readers never see a partial
    return secs


def build() -> dict:
    """Build the library and the converter if not built yet.  Returns
    {"library": seconds, "converter": seconds} (0.0 when already
    built)."""
    report = {}
    for key, out, sources, flags in (
            ("library", library_path(), LIB_SOURCES, LIB_FLAGS),
            ("converter", _converter_out(), (CONVERTER_SOURCE,),
             CONVERTER_FLAGS)):
        report[key] = 0.0 if out.exists() else compile_to(out, sources,
                                                          flags)
    return report


def analyze() -> dict:
    """GCC's static analyzer over the five translation units
    (lux_tpu/native/Makefile's ``analyze`` target; sanitize_driver.cc is
    left out, as there): real compilation with ``ANALYZE_FLAGS`` into
    the git-ignored ``_build/analyze/``, the five compilers started
    together.  Returns {source: seconds}; any diagnostic raises
    NativeBuildError carrying every failing unit's output.  A justified
    exemption is a ``/* lockcheck: allow(analyzer) */`` comment in the
    source plus a ``-Wno-analyzer-*`` flag for that unit alone (none is
    needed)."""
    cxx = compiler()
    exe = shutil.which(cxx)
    if exe is None:
        raise NativeBuildError(f"C++ compiler {cxx!r} not found: the "
                               f"analyzer runs inside g++ (set CXX)")
    out_dir = BUILD_DIR / "analyze"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in ANALYZE_SOURCES:
        obj = out_dir / f"{Path(src).stem}.{os.getpid()}.o"
        procs[src] = (obj, subprocess.Popen(
            [exe, *ANALYZE_FLAGS, "-c", str(SRC_DIR / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for src, (obj, proc) in procs.items():
        text, _ = proc.communicate()
        secs[src] = time.perf_counter() - t0
        obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            failed.append(f"--- {src} (exit {proc.returncode})\n{text}")
    if failed:
        raise NativeBuildError(
            f"{cxx} -fanalyzer refused {len(failed)} unit(s)",
            "\n".join(failed))
    return secs


def converter_path() -> str:
    """The ``lux_converter`` binary, built first if needed (usage:
    ``lux_converter -nv N [-ne M] -input edges.txt -output g.lux
    [-weighted]``)."""
    out = _converter_out()
    if not out.exists():
        compile_to(out, (CONVERTER_SOURCE,), CONVERTER_FLAGS)
    return str(out)


def _load_lib():
    global _lib
    with _LOCK:
        if _lib is None:
            path = library_path()
            if not path.exists():
                compile_to(path, LIB_SOURCES, LIB_FLAGS)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib):
    P, I32, I64, U32, U64 = (ctypes.c_void_p, ctypes.c_int32,
                             ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_uint64)
    sigs = {
        "lux_read_header": [ctypes.c_char_p, ctypes.POINTER(U32),
                            ctypes.POINTER(U64)],
        "lux_load_partition": [ctypes.c_char_p, U32, U64, U32, U32,
                               ctypes.c_int, U32, ctypes.POINTER(U64),
                               ctypes.POINTER(U64), P, P, P, ctypes.c_int],
        "lux_count_degrees": [ctypes.c_char_p, U32, U64, P, ctypes.c_int],
        "lux_rmat_csc": [ctypes.c_int, ctypes.c_int, U64, ctypes.c_double,
                         ctypes.c_double, ctypes.c_double, P, P, P],
        "lux_argsort_u64": [P, I64, ctypes.c_int, P],
        "lux_sort_kv_u64": [P, P, I64, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(P), ctypes.POINTER(P),
                            ctypes.POINTER(I32)],
        "lux_reorder_cluster": [U32, U64, P, P, ctypes.c_int, P],
    }
    for name, argtypes in sigs.items():
        f = getattr(lib, name)
        f.restype = ctypes.c_int
        f.argtypes = argtypes


def _check(rc: int, what: str):
    if rc != 0:
        raise OSError(f"{what} failed with native error {rc} "
                      f"({os.strerror(-rc) if rc < 0 else rc})")


def _threads(threads):
    return int(threads) if threads else min(16, os.cpu_count() or 1)


def read_header(path: str) -> tuple[int, int]:
    """(nv, ne) from a .lux header."""
    lib = _load_lib()
    nv = ctypes.c_uint32()
    ne = ctypes.c_uint64()
    _check(lib.lux_read_header(path.encode(), ctypes.byref(nv),
                               ctypes.byref(ne)), "read_header")
    return nv.value, ne.value


def load_partition(path: str, nv: int, ne: int, v0: int, v1: int,
                   weighted: bool = False, weight_dtype=np.int32,
                   threads: int = 8):
    """Load vertex range [v0, v1) with the pthread pread loader:
    returns (row_ptrs u64[v1-v0] END offsets, col_idx u32[e_hi-e_lo],
    weights | None, e_lo)."""
    lib = _load_lib()
    e_lo = ctypes.c_uint64()
    e_hi = ctypes.c_uint64()
    _check(lib.lux_load_partition(path.encode(), nv, ne, v0, v1,
                                  int(weighted), 4, ctypes.byref(e_lo),
                                  ctypes.byref(e_hi), None, None, None,
                                  threads), "load_partition(size)")
    n_edges = e_hi.value - e_lo.value
    rows = np.empty(v1 - v0, dtype=np.uint64)
    cols = np.empty(n_edges, dtype=np.uint32)
    wdt = np.dtype(weight_dtype)
    weights = np.empty(n_edges, dtype=wdt) if weighted else None
    _check(lib.lux_load_partition(
        path.encode(), nv, ne, v0, v1, int(weighted), wdt.itemsize,
        ctypes.byref(e_lo), ctypes.byref(e_hi),
        rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p) if weighted else None,
        threads), "load_partition")
    return rows, cols, weights, e_lo.value


def count_degrees(path: str, nv: int, ne: int, threads: int = 8):
    """Out-degree histogram of a .lux file's col_idx section."""
    lib = _load_lib()
    deg = np.zeros(nv, dtype=np.uint32)
    _check(lib.lux_count_degrees(path.encode(), nv, ne,
                                 deg.ctypes.data_as(ctypes.c_void_p),
                                 threads), "count_degrees")
    return deg


def rmat_csc(scale: int, edge_factor: int = 16, seed: int = 0,
             a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """An R-MAT graph generated directly as dst-sorted CSC in C++:
    (row_ptrs u64[nv] END offsets, col_idx u32[ne], out_degrees
    u32[nv]).  Same distribution as convert.rmat_edges, another RNG
    stream: the graphs differ from the numpy generator's."""
    lib = _load_lib()
    nv = 1 << scale
    ne = nv * edge_factor
    row_ptrs = np.empty(nv, dtype=np.uint64)
    col_idx = np.empty(ne, dtype=np.uint32)
    degrees = np.empty(nv, dtype=np.uint32)
    _check(lib.lux_rmat_csc(
        scale, edge_factor, seed, a, b, c,
        row_ptrs.ctypes.data_as(ctypes.c_void_p),
        col_idx.ctypes.data_as(ctypes.c_void_p),
        degrees.ctypes.data_as(ctypes.c_void_p)), "rmat_csc")
    return row_ptrs, col_idx, degrees


def _as_u64(keys, what: str, inplace: bool):
    """Non-negative int64 or uint64 keys as a uint64 view (contiguous;
    in place: the caller's own memory)."""
    if inplace and (not isinstance(keys, np.ndarray)
                    or not keys.flags.c_contiguous):
        raise ValueError(f"{what} keys must be a contiguous numpy array")
    keys = keys if inplace else np.ascontiguousarray(keys)
    if keys.dtype == np.int64:
        if keys.size and int(keys.min()) < 0:
            raise ValueError(f"{what} needs non-negative keys")
        return keys.view(np.uint64)
    if keys.dtype != np.uint64:
        raise ValueError(f"{what}: unsupported key dtype {keys.dtype}")
    return keys


def argsort_u64(keys, threads: int | None = None,
                native: bool | None = None):
    """Stable argsort of non-negative int64 / uint64 keys (sort.cc's
    parallel LSD radix; ``native=False``: numpy's stable argsort).
    Returns the int64 permutation."""
    keys = _as_u64(keys, "argsort_u64", inplace=False)
    if not _native_wanted(native):
        return np.argsort(keys, kind="stable").astype(np.int64)
    out = np.empty(keys.size, np.int64)
    lib = _load_lib()
    _check(lib.lux_argsort_u64(
        keys.ctypes.data_as(ctypes.c_void_p), keys.size, _threads(threads),
        out.ctypes.data_as(ctypes.c_void_p)), "lux_argsort_u64")
    return out


def sort_kv(keys, payloads=(), threads: int | None = None,
            native: bool | None = None) -> None:
    """Stable sort IN PLACE of non-negative int64 / uint64 ``keys``,
    carrying each array of ``payloads`` (same length, element size
    1/2/4/8, at most 4) through the same permutation: sort.cc's fused
    radix sort (``lux_sort_kv_u64``); ``native=False``: numpy's stable
    argsort and a take of each array."""
    keys = _as_u64(keys, "sort_kv", inplace=True)
    n = keys.size
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"sort_kv supports at most {MAX_PAYLOADS} "
                         f"payloads, got {len(payloads)}")
    for p in payloads:
        if not isinstance(p, np.ndarray) or not p.flags.c_contiguous:
            raise ValueError("sort_kv payloads must be contiguous "
                             "numpy arrays")
        if p.shape != (n,):
            raise ValueError("sort_kv payloads must match keys' length")
        if p.dtype.itemsize not in (1, 2, 4, 8):
            raise ValueError(f"unsupported payload itemsize "
                             f"{p.dtype.itemsize}")
    if n == 0:
        return
    if not _native_wanted(native):
        order = np.argsort(keys, kind="stable")
        keys[:] = keys[order]
        for p in payloads:
            p[:] = p[order]
        return
    lib = _load_lib()
    key_tmp = np.empty(n, np.uint64)
    pay_tmp = [np.empty(n, p.dtype) for p in payloads]
    npay = len(payloads)
    PtrArr = ctypes.c_void_p * max(1, npay)
    pays = PtrArr(*[p.ctypes.data for p in payloads])
    tmps = PtrArr(*[p.ctypes.data for p in pay_tmp])
    sizes = (ctypes.c_int32 * max(1, npay))(
        *[p.dtype.itemsize for p in payloads])
    _check(lib.lux_sort_kv_u64(
        keys.ctypes.data_as(ctypes.c_void_p),
        key_tmp.ctypes.data_as(ctypes.c_void_p),
        n, _threads(threads), npay, pays, tmps, sizes), "lux_sort_kv_u64")


def stable_sort(key, native: bool | None = None):
    """(sorted int64 copy of ``key``, int64 permutation): the stable
    argsort of non-negative keys as the plan builders take it, one
    ``sort_kv`` carrying the edge index."""
    key = np.array(key, dtype=np.int64, copy=True)
    idx = np.arange(key.size, dtype=np.int64)
    sort_kv(key, (idx,), native=native)
    return key, idx


REORDER_MODES = {"cm": 0, "hubs": 1, "communities": 2}


def reorder_cluster(src, dst, nv: int, mode: str | int = "hubs",
                    native: bool | None = None) -> np.ndarray:
    """Clustering vertex reorder (reorder.cc): ``"cm"`` ascending-degree
    Cuthill-McKee BFS, ``"hubs"`` hub-first BFS, ``"communities"``
    label-propagation communities.  Returns uint32 ``perm`` with
    ``perm[new] = old``.  ``native=False`` runs the numpy version
    (``_reorder_cluster_numpy``: the same contract, a bijection of
    [0, nv), but not the same order)."""
    src = np.ascontiguousarray(src, np.uint32)
    dst = np.ascontiguousarray(dst, np.uint32)
    m = REORDER_MODES.get(mode, mode) if isinstance(mode, str) \
        else int(mode)
    if m not in (0, 1, 2):
        raise ValueError(f"unknown reorder mode {mode!r} (one of "
                         f"{', '.join(REORDER_MODES)})")
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("reorder_cluster needs matching 1-D src/dst")
    if src.size and (int(src.max()) >= nv or int(dst.max()) >= nv):
        raise ValueError(f"edge endpoint outside [0, {nv})")
    if not _native_wanted(native):
        return _reorder_cluster_numpy(src, dst, nv, m)
    perm = np.empty(nv, np.uint32)
    lib = _load_lib()
    _check(lib.lux_reorder_cluster(
        nv, src.size,
        src.ctypes.data_as(ctypes.c_void_p),
        dst.ctypes.data_as(ctypes.c_void_p),
        m,
        perm.ctypes.data_as(ctypes.c_void_p)), "lux_reorder_cluster")
    return perm


def _reorder_cluster_numpy(src, dst, nv: int, mode: int) -> np.ndarray:
    """The numpy version of reorder.cc (bijection, perm[new] = old):
    the BFS of modes 0 and 1 visits neighbours in another order than
    the C++ pass, and mode 2 propagates labels synchronously where the
    C++ pass is asynchronous."""
    from collections import deque

    deg = (np.bincount(src, minlength=nv).astype(np.int64)
           + np.bincount(dst, minlength=nv))
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    order = np.argsort(u, kind="stable")
    v = v[order]
    off = np.zeros(nv + 1, np.int64)
    np.add.at(off, u + 1, 1)
    off = np.cumsum(off)
    u = u[order]
    if mode == 2:
        labels = np.arange(nv, dtype=np.int64)
        for _ in range(8):
            key = u * np.int64(nv) + labels[v]
            ks = np.sort(key, kind="stable")
            new = np.ones(len(ks), bool)
            new[1:] = ks[1:] != ks[:-1]
            b = np.nonzero(new)[0]
            cnt = np.diff(np.concatenate((b, [len(ks)])))
            uu = ks[b] // nv
            lab = ks[b] % nv
            o2 = np.lexsort((lab, -cnt, uu))
            first = np.ones(len(o2), bool)
            first[1:] = uu[o2][1:] != uu[o2][:-1]
            newlab = labels.copy()
            newlab[uu[o2][first]] = lab[o2][first]
            if np.array_equal(newlab, labels):
                break
            labels = newlab
        # communities by first touch in degree-major order
        sweep = np.argsort(-deg, kind="stable")
        rank = np.empty(nv, np.int64)
        rank[sweep] = np.arange(nv)
        comm_rank = np.full(nv, nv, np.int64)
        np.minimum.at(comm_rank, labels, rank)
        return sweep[np.argsort(comm_rank[labels[sweep]],
                                kind="stable")].astype(np.uint32)
    sign = -1 if mode == 1 else 1
    seeds = np.argsort(sign * deg, kind="stable")
    visited = np.zeros(nv, bool)
    out = np.empty(nv, np.uint32)
    pos = 0
    dq = deque()
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        dq.append(int(s))
        while dq:
            x = dq.popleft()
            out[pos] = x
            pos += 1
            nb = v[off[x]:off[x + 1]]
            nb = np.unique(nb[~visited[nb]])
            if nb.size:
                nb = nb[np.argsort(sign * deg[nb], kind="stable")]
                visited[nb] = True
                dq.extend(int(n) for n in nb)
    assert pos == nv
    return out
