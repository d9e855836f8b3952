"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface
(``fused_carry.cu`` includes ``carry_tiles.cuh``).
It is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``lux_tpu_torch/_build/`` (git-ignored) at first use, and loaded with
``ctypes``.  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale build is never
loaded.  Nothing is built or imported when this module is imported:
the CPU tests import every module, and there is no ``nvcc`` there.

``build()`` compiles every kernel not built yet, one ``nvcc`` per
source (per part of a source in ``PARTS``), all started together; ``load(name)`` builds on demand and
returns the library with ``argtypes``/``restype`` set on every C
function (without them ctypes would pass a Python int as 32 bits and
cut a pointer); ``launch(name, *args)`` calls kernel ``name``'s
``lux_<name>`` and raises on a failed launch; ``counted`` is where each
wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a part's object: the same flags, compiled only
PART_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32

# kernel name -> (source under csrc/, {C function: (restype, argtypes)})
KERNELS = {
    "chunk_partials": ("chunk_partials.cu", {
        "lux_chunk_partials": (ctypes.c_int,
                               [_P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                                _P]),
    }),
    "chunk_partials_batched": ("chunk_partials_batched.cu", {
        "lux_chunk_partials_batched": (ctypes.c_int,
                                       [_P, _P, _P, _I64, _I64, _I64, _I64,
                                        _I32, _I32, _P]),
    }),
    "lane_shuffle": ("lane_shuffle.cu", {
        "lux_lane_shuffle": (ctypes.c_int, [_P, _P, _P, _I64, _P]),
    }),
    "carry": ("carry.cu", {
        "lux_carry": (ctypes.c_int,
                      [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P]),
        "lux_carry_status_bytes": (ctypes.c_int64, [_I64]),
    }),
    "fused_carry": ("fused_carry.cu", {
        "lux_fused_carry": (ctypes.c_int,
                            [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32,
                             _I32, _P]),
    }),
    "onehot_reduce": ("onehot_mma.cu", {
        "lux_onehot_reduce": (ctypes.c_int,
                              [_P, _P, _P, _I64, _I64, _I32, _P]),
    }),
    "transposed_reduce": ("transposed_reduce.cu", {
        "lux_transposed_reduce": (ctypes.c_int,
                                  [_P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                                   _I32, _P]),
    }),
    "sub_gather": ("sub_gather.cu", {
        "lux_sub_gather": (ctypes.c_int, [_P, _P, _P, _I64, _I32, _I32,
                                          _I32, _I32, _I32, _P]),
    }),
    "elementwise": ("elementwise.cu", {
        "lux_elementwise": (ctypes.c_int, [_I32, _P, _P, _P, _I64, _P]),
    }),
    "block_rowsum": ("block_rowsum.cu", {
        "lux_block_rowsum": (ctypes.c_int, [_P, _P, _I64, _I32, _P]),
    }),
}


# kernel name -> parts: its source is compiled that many times at once,
# with -DLUX_PART=0, 1, ..., and the objects are linked into its library
# (the source says what each part holds).  A source with many template
# forms is otherwise the build's longest nvcc.
PARTS = {"chunk_partials_batched": 3}


# the audit's recorder (lux_tpu_torch/audit.py) while one records on
# this thread: shown each launch as (kernel name, input tensors, output
# tensors).  Thread-local, as the recorder's torch modes are: a launch
# from another thread is not the recorded program's.
_local = threading.local()


def observer():
    """The calling thread's launch observer, or None."""
    return getattr(_local, "observer", None)


def set_observer(fn) -> None:
    """Make ``fn`` (or None) the calling thread's launch observer."""
    _local.observer = fn


def counted(wrapper, name: str, inputs=(), outputs=()) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``
    (the counts chip_smoke.py reads) and show it, with its tensors, to
    an audit recording on this thread if one is active.  The kernels
    stay ctypes calls: no dispatcher hop on the launch-bound streamed
    paths."""
    wrapper.launches += 1
    obs = getattr(_local, "observer", None)
    if obs is not None:
        obs(name, inputs, outputs)


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a kernel source."""


_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the PATH, or the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME, or put nvcc on the PATH): the "
        "port's kernels are built from lux_tpu_torch/csrc on the card's "
        "machine")


def library_path(name: str) -> Path:
    """Where kernel ``name`` is built: the hash covers the source, the
    headers it may include (every ``csrc/*.cuh``) and the flags."""
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if name in PARTS:
        h.update(f"parts {PARTS[name]}".encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile the kernels in ``names`` (default: all) that are not
    built yet, one nvcc process per source (per part of a source in
    ``PARTS``, whose objects are then linked), all started together.
    Returns {name: {"seconds", "path", "ptxas"}} (seconds 0.0 and no
    compiler output for a kernel that was already built)."""
    names = list(KERNELS if names is None else names)
    report, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "path": str(out), "ptxas": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = str(CSRC / KERNELS[name][0])
        if name in PARTS:
            objs = [out.with_name(f"{out.stem}.part{k}.{os.getpid()}.o")
                    for k in range(PARTS[name])]
            cmds = [[nvcc_path(), *PART_FLAGS, f"-DLUX_PART={k}", "-o",
                     str(obj), src] for k, obj in enumerate(objs)]
        else:
            objs = []
            cmds = [[nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), src]]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        running[name] = (procs, objs, tmp, out, time.perf_counter())
    failed = []
    # each kernel is waited for (and its parts linked) on its own thread,
    # so that its seconds end when its own nvcc processes do
    with ThreadPoolExecutor(max(1, len(running))) as pool:
        done = {name: pool.submit(_finish, *job)
                for name, job in running.items()}
    for name, fut in done.items():
        secs, log, code, out = fut.result()
        if code != 0:
            failed.append(f"{name} (exit {code}):\n{log}")
        else:
            report[name] = {"seconds": secs, "path": str(out), "ptxas": log}
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return report


def _finish(procs, objs, tmp, out, t0):
    """Wait for one kernel's nvcc processes, link its parts' objects if
    it has parts, and move the library into place.  Returns (seconds,
    compiler output, exit code, library path)."""
    logs, code = [], 0
    for proc in procs:
        log, _ = proc.communicate()
        logs.append(log)
        code = code or proc.returncode
    if objs and code == 0:
        link = subprocess.run([nvcc_path(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        code = link.returncode
    for obj in objs:
        obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    if code == 0:
        os.replace(tmp, out)          # atomic: readers never see a partial
    return secs, "".join(logs), code, out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it first if
    needed), with argtypes and restype set on its C functions."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C function ``lux_<name>`` with ``args``
    (it launches on the stream it is given and returns a cudaError_t);
    raise ``KernelLaunchError`` when that is not 0."""
    from lux_tpu_torch.ops.chunk_reduce import KernelLaunchError

    err = getattr(load(name), f"lux_{name}")(*args)
    if err != 0:
        raise KernelLaunchError(f"{name} launch failed with cudaError_t "
                                f"{err}")
