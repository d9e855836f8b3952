"""Program auditor: the engines' invariants checked on the ops one
iteration runs (counterpart of lux_tpu/audit.py).

The reference traces every engine program variant to a jaxpr and walks
it; tracing never executes.  An eager PyTorch program has no trace
apart from its execution, so this auditor RUNS one iteration of each
registered variant (engine.pull.Placement's registry: pull ``step``,
``run``, ``run_stats``, ``run_until``, ``run_until_stats``,
``run_health``, ``run_until_health``; push ``step`` plus the forced
``step_dense`` / ``step_sparse`` paths, ``converge``,
``converge_stats``, ``converge_health``; a live graph's ``live_delta``)
on a fresh init state, under a ``TorchDispatchMode`` that records every
aten op with its operands' storages, shapes and dtypes, and a
``TorchFunctionMode`` that sees the host reads (``item``, ``int()``,
``tolist``, ``.cpu()``, ...) which a CPU tensor never dispatches.  The
hand kernels are ctypes calls that no mode sees: each wrapper's launch
count (``_kernels.counted``) shows the launch to the recorder with its
tensors, so on the card the recorded sequence is the one the card runs.
The state's storages are tainted at the start and the taint follows
every op, which tells state-derived values from graph constants.

Check catalogue (check name -> typed error), mapped to eager PyTorch:

  gather-budget        GatherBudgetError
      Per-element gathers (``index_select``, ``gather``, advanced
      indexing, ``take``, ``embedding``) of one iteration whose operand
      derives from the state and has the flat state table's shape
      [P*vpad, ...] (the card's ``gather_rows`` reads a padded COPY of
      the table, so identity is by value lineage and shape, not by
      storage), or on a paged engine its tile-reshaped view: at most
      the engine's budget (1, or 0 on the owner exchange), counted by
      call site (a blocked loop gathering at one line is one gather, as
      a jaxpr's scan body is).  Pair-row fetches ([T, 128] rows) are
      row-granular and exempt, as in the reference.
  collective-schedule  CollectiveScheduleError
      One card's half: the owner exchange gathers each source part from
      its own [vpad, ...] shard, its paged plans from the shard's
      [vpad / 128, 128, ...] pages (at least num_parts shard gathers a
      dense iteration), never over the global ids.  The ring,
      reduce-scatter and all-to-all rules come with the mesh (ROADMAP
      A6b-2).
  dtype-discipline     DtypeDisciplineError
      No complex and no float wider than max(4, state itemsize)
      anywhere.  Integers wider than that (int64) pass where torch
      requires them or the code asks for them: factory ops, explicit
      casts (``.to(torch.int64)``, ``.long()``) and reductions with an
      explicit ``dtype=`` (the push engine's int64 edge counters).  An
      int64 that comes from type promotion fails: an op without an
      explicit dtype whose integer or float input is narrower than its
      int64 output (an int32 label plus an int64 tensor), or a sum /
      cumsum / prod of a narrower input with no ``dtype=``.
  callback-in-loop     CallbackInLoopError
      Host reads inside one iteration beyond the variant's stated
      budget: ``item``, ``int()`` / ``float()`` / ``bool()``,
      ``tolist``, ``numpy``, a device-to-host copy, and ops that sync
      by nature (``nonzero``, ``masked_select``, ``unique``, boolean
      indexing, a scalar read inside torch's own Python code,
      ``equal``, ``bincount``, ``repeat_interleave`` without
      ``output_size``), all seen by the recorder on its own thread.
      Budgets: 0 for every step and fixed-count run, 1 an iteration for
      ``run_until*`` (the residual, with the health flags) and the push
      converges (the next frontier's count, with the flags).  With
      ``sync_debug`` (chip_smoke.py) the step variants also run under
      ``torch.cuda.set_sync_debug_mode("error")`` on the card; that
      mode is process-wide, so it is taken only where no other Python
      thread runs.
  const-bytes          ConstBytesError
      Host data made into tensors inside one iteration (``torch.tensor``
      / ``as_tensor`` / ``asarray`` of host data, a CPU tensor moved to
      the card) above the reference's 1 MiB ceiling: graph arrays live
      on the device, built once.
  loop-invariant       LoopInvariantError (warning severity)
      An expensive op (a gather, a matmul, a scatter, a sort, a hand
      kernel) of at least 4,096 elements whose inputs are all
      independent of the state: the same result is recomputed every
      iteration.  (XLA would hoist it out of a loop, the reference's
      benchmarking trap; eager PyTorch hoists nothing.)
  identity-init        IdentityInitError
      A scatter-reduce that includes its destination (``scatter_reduce``
      with include_self, ``scatter_add``, ``index_add``,
      ``index_reduce``, ``index_put`` with accumulate) onto a buffer
      from a factory op whose statically known fill is not the
      reduction's identity.
  ledger-drift         LedgerDriftError
      memwatch's ledger (MemoryLedger.for_engine: the priced resident
      arrays and the eager step's temporaries) against the measured
      peak of one step, within [1/(1+tol), 1+tol], tol 0.5: on the card
      ``torch.cuda.max_memory_allocated`` after a reset, above the
      allocation before the step, plus the engine's own tensors; on the
      CPU the recorder's peak of live storage bytes the step allocated,
      plus the same.  The audit's own state is the one state both
      sides count.  The verdict is memwatch.drift_verdict's; below
      memwatch.MEM_CHECK_FLOOR_BYTES of priced arguments (a
      padding-dominated shape) a failing ratio is a warning.

Exemptions, as in the reference: ``# audit: allow(check-name)`` on a
line of the op's call stack (or in the comment block directly above
it), for the op-anchored checks; ``allow={"check-name", ...}`` at the
audit call for the others.

Usage: the engines' ``audit=None|"warn"|"error"`` (every variant at
build time), ``LiveGraph.register_audit(eng)`` (the delta-relax step),
``audit_engine(eng, mode, allow, ledger, ledger_tol)``, and ``python -m
lux_tpu_torch.audit`` (the reference's engine matrix without its mesh
configurations; on the card unless ``-device cpu`` asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import sys
import threading
import warnings
import weakref

import numpy as np
import torch

__all__ = [
    "AuditError", "AuditWarning", "Finding", "ProgramSpec",
    "GatherBudgetError", "ConstBytesError", "DtypeDisciplineError",
    "LoopInvariantError", "CollectiveScheduleError",
    "CallbackInLoopError", "IdentityInitError", "LedgerDriftError",
    "Trace", "record", "audit_trace", "audit_engine", "engine_spec",
    "check_ledger", "ledger_report", "table_gathers", "matrix_configs",
    "run_repo_audit",
    "digest", "main",
]

# ---------------------------------------------------------------------
# typed errors (the reference's, lux_tpu/audit.py:111-160)


class AuditError(Exception):
    """Base of every auditor violation; ``findings`` carries the full
    list behind a raised (possibly aggregated) error."""
    check = "audit"

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings = list(findings)


class GatherBudgetError(AuditError):
    check = "gather-budget"


class ConstBytesError(AuditError):
    check = "const-bytes"


class DtypeDisciplineError(AuditError):
    check = "dtype-discipline"


class LoopInvariantError(AuditError):
    check = "loop-invariant"


class CollectiveScheduleError(AuditError):
    check = "collective-schedule"


class CallbackInLoopError(AuditError):
    check = "callback-in-loop"


class IdentityInitError(AuditError):
    check = "identity-init"


class LedgerDriftError(AuditError):
    check = "ledger-drift"


ERROR_TYPES = {cls.check: cls for cls in (
    GatherBudgetError, ConstBytesError, DtypeDisciplineError,
    LoopInvariantError, CollectiveScheduleError, CallbackInLoopError,
    IdentityInitError, LedgerDriftError)}

CHECKS = tuple(sorted(ERROR_TYPES))


class AuditWarning(UserWarning):
    """Category used for ``mode='warn'`` reporting."""


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str          # one of CHECKS
    severity: str       # "error" | "warn"
    where: str          # "<engine>.<variant>" or caller-supplied
    detail: str

    def __str__(self):
        return f"[{self.check}] {self.where}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """Expectations for one recorded iteration.

    table_shape       shape of the flat state table [P*vpad, ...];
                      None skips gather-budget.
    gather_budget     most state-table gather sites an iteration.
    paged_table_shapes  the tile-reshaped views of the table a paged
                      engine's page fetch reads ([T, 128, ...] and
                      [T, 128*K]): the same budget.
    const_bytes_max   host-data ceiling an iteration (the reference's).
    state_itemsize    bytes an element of the state; floats wider than
                      max(4, this) fail dtype-discipline.
    shard_shape       owner exchange: one part's shard [vpad, ...];
                      None skips collective-schedule.
    min_shard_gathers owner exchange: shard gathers a dense iteration
                      must make (num_parts: one a source part).
    """
    table_shape: tuple | None = None
    gather_budget: int | None = None
    paged_table_shapes: tuple = ()
    const_bytes_max: int = 1 << 20
    state_itemsize: int = 4
    shard_shape: tuple | None = None
    min_shard_gathers: int = 0


# ---------------------------------------------------------------------
# source pragmas: ``# audit: allow(check-name)`` on a line of the op's
# call stack, or in the comment block directly above it

_PRAGMA_RE = re.compile(r"#\s*audit:\s*allow\(([a-z-]+)\)")


@functools.lru_cache(maxsize=512)
def _file_lines(path: str):
    try:
        with open(path) as f:
            return f.readlines()
    except OSError:
        return []


def _line_allows(fname: str, line: int, check: str) -> bool:
    lines = _file_lines(fname)
    if not 0 < line <= len(lines):
        return False

    def hit(text):
        return any(m.group(1) == check for m in _PRAGMA_RE.finditer(text))

    if hit(lines[line - 1]):
        return True
    ln = line - 2
    while ln >= 0:
        stripped = lines[ln].strip()
        if stripped.startswith("#"):
            if hit(stripped):
                return True
            ln -= 1
        elif not stripped:
            ln -= 1
        else:
            break
    return False


def _pragma_allows(site, check: str) -> bool:
    """True when any frame of ``site`` (innermost first) carries an
    ``# audit: allow(check)`` pragma."""
    return any(_line_allows(f, ln, check) for f, ln in site)


def _where_src(site, where: str) -> str:
    if not site:
        return where
    f, ln = site[0]
    return f"{where} ({os.path.basename(f)}:{ln})"


# ---------------------------------------------------------------------
# the recorder

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_THIS = os.path.abspath(__file__)
_KERNELS_FILE = os.path.join(os.path.dirname(_THIS), "_kernels.py")
_OPS_DIR = os.path.join(os.path.dirname(_THIS), "ops") + os.sep
_SITE_DEPTH = 48


def _site() -> tuple:
    """The calling Python frames outside torch and this module,
    innermost first, as ((file, line), ...), and whether one of them is
    a kernel's plain version (a ``*_plain`` function under ops/)."""
    out, plain = [], False
    f = sys._getframe(2)
    while f is not None and len(out) < _SITE_DEPTH:
        fn = f.f_code.co_filename
        if fn == _THIS:
            if f.f_code.co_name == "_run_recorded":
                break
        elif not fn.startswith(_TORCH_DIR) and fn != _KERNELS_FILE \
                and not fn.startswith("<"):
            out.append((fn, f.f_lineno))
            plain = plain or (f.f_code.co_name.endswith("_plain")
                              and fn.startswith(_OPS_DIR))
        f = f.f_back
    return tuple(out), plain


@dataclasses.dataclass(frozen=True)
class TInfo:
    key: tuple | None       # (device type, index, storage data_ptr)
    shape: tuple
    dtype: torch.dtype
    numel: int
    tainted: bool


@dataclasses.dataclass
class Op:
    name: str               # aten op name ("index_select"), "kernel:<k>",
                            # "read:<method>" or "host:<function>"
    ins: list
    outs: list
    site: tuple
    explicit_dtype: bool = False
    reduce: str | None = None       # the scatter-reduce kind, if any
    dest: TInfo | None = None       # the buffer it reduces onto
    fill: object = None             # that buffer's known fill
    nbytes: int = 0                 # host data made into a tensor
    bool_index: bool = False
    sync: bool = False              # an op that reads a value to the host


def _skey(t: torch.Tensor):
    try:
        ptr = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    if ptr == 0:
        return None
    return (t.device.type, t.device.index, ptr)


_FACTORY_FILL = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1,
                 "ones_like": 1, "new_ones": 1}
_FULL = {"full", "full_like", "new_full"}
_CAST_OPS = frozenset({"_to_copy", "to", "_to_dtype",
                       "convert_element_type"})
_REDUCE_PROMOTING = frozenset({"sum", "cumsum", "prod", "cumprod",
                               "nansum"})
GATHER_OPS = frozenset({"index_select", "gather", "index", "take",
                        "embedding", "take_along_dim"})
EXPENSIVE_OPS = GATHER_OPS | frozenset({
    "mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
    "_convolution", "scatter", "scatter_add", "scatter_reduce",
    "index_add", "index_put", "_index_put_impl", "index_reduce",
    "index_copy", "sort", "argsort", "topk", "kthvalue"})
# ops whose int64 outputs are torch's index type (argmax, sort, ...)
INDEX_OPS = frozenset({"argmax", "argmin", "cummax", "cummin", "max", "min",
                       "sort", "argsort", "topk", "kthvalue", "mode",
                       "median", "nanmedian", "searchsorted", "bucketize",
                       "nonzero", "_unique", "_unique2", "unique_dim",
                       "unique_consecutive", "max_pool2d_with_indices"})
SYNC_OPS = frozenset({"nonzero", "masked_select", "_unique", "_unique2",
                      "unique_dim", "unique_consecutive"})
# ops that read a device value to the host inside their own kernel (a
# sync on the card that no Python-level read shows): a scalar read, a
# comparison to one bool, and a result sized from the data
_HIDDEN_SYNC_OPS = frozenset({"_local_scalar_dense", "equal", "is_nonzero",
                              "bincount"})
_SCATTER_KIND = {"scatter_add": "sum", "index_add": "sum"}
_TORCH_TO_KIND = {"sum": "sum", "prod": "prod", "amax": "max",
                  "amin": "min", "mean": "mean"}
_INVARIANT_MIN_ELEMS = 4096

_READ_METHODS = frozenset({"item", "__int__", "__float__", "__bool__",
                           "__index__", "tolist", "numpy", "__complex__"})
_MOVE_METHODS = frozenset({"cpu", "to", "cuda"})
_HOST_FUNCS = frozenset({"tensor", "as_tensor", "asarray", "from_numpy"})


class Trace:
    """One recorded iteration: ``ops`` (Op records in order), the peak of
    the live storage bytes allocated while recording (``peak_bytes``)
    and the push ``schedule`` it ran, if any."""

    def __init__(self):
        self.ops: list[Op] = []
        self.peak_bytes = 0
        self.schedule: list = []
        self.sync_error: str | None = None

    @property
    def kernel_launches(self) -> int:
        return sum(1 for o in self.ops if o.name.startswith("kernel:"))

    @property
    def host_reads(self) -> list:
        return [o for o in self.ops
                if o.name.startswith("read:") or o.name in SYNC_OPS
                or o.bool_index or o.sync]


class _Recorder:
    """The shared state of one recording: the trace, each storage's
    taint, the statically known fills of factory buffers, the storages
    already read to the host, and the live bytes allocated here.

    A kernel's plain version stands in for the kernel on the CPU: its
    own temporaries are not the card's, so a storage it allocates joins
    the live bytes only once an op outside it reads the storage (the
    plain version's result, as the kernel's output)."""

    def __init__(self, state):
        self.trace = Trace()
        self.taint: dict = {}
        self.fills: dict = {}
        self.host: set = set()
        self.in_read = False          # inside a recorded read method
        self.live = 0
        self._tracked: set = set()
        self._pending: dict = {}
        for t in state:
            k = _skey(t)
            if k is not None:
                self.taint[k] = True

    def info(self, t: torch.Tensor) -> TInfo:
        k = _skey(t)
        return TInfo(k, tuple(t.shape), t.dtype, t.numel(),
                     bool(self.taint.get(k, False)))

    def _track(self, t: torch.Tensor, plain: bool):
        """Count a fresh storage's bytes live until it dies (from its
        first read outside a plain version, if one allocated it)."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        k = _skey(t)
        if k is None or k in self._tracked or k in self._pending:
            return
        n = st.nbytes()
        if plain:
            self._pending[k] = n
        else:
            self._count_live(k, n)
        weakref.finalize(st, self._release, k, n)

    def _count_live(self, k, n):
        self._tracked.add(k)
        self.live += n
        self.trace.peak_bytes = max(self.trace.peak_bytes, self.live)

    def _release(self, k, n):
        self._pending.pop(k, None)
        if k in self._tracked:
            self._tracked.discard(k)
            self.live -= n

    def add(self, name, in_tensors, out_tensors, *, explicit_dtype=False,
            reduce=None, dest=None, nbytes=0, bool_index=False,
            mutated=(), fill=None, sync=False):
        """Record one op: its operands' TInfo before it ran, and the taint,
        fills and live bytes its outputs and writes leave.  ``reduce`` /
        ``dest``: a scatter-reduce and the buffer it reduces onto;
        ``fill``: a factory's known value for its output."""
        ins = [self.info(t) for t in in_tensors]
        dest = None if dest is None else self.info(dest)
        in_keys = {i.key for i in ins if i.key is not None}
        tainted = any(i.tainted for i in ins)
        site, plain = _site()
        if not plain:
            for k in in_keys & self._pending.keys():
                self._count_live(k, self._pending.pop(k))
        dest_fill = None if dest is None else self.fills.get(dest.key)
        outs = []
        for t in out_tensors:
            k = _skey(t)
            if k is None:
                outs.append(self.info(t))
                continue
            if k in in_keys:
                # a view or an in-place write: the storage keeps what it
                # held, joined with what was written into it
                self.taint[k] = self.taint.get(k, False) or tainted
            else:
                self.taint[k] = tainted
                self.host.discard(k)
                self.fills.pop(k, None)
                self._track(t, plain)
            outs.append(self.info(t))
        for t in mutated:
            k = _skey(t)
            if k is not None:
                self.taint[k] = self.taint.get(k, False) or tainted
                self.fills.pop(k, None)
        if fill is not None and out_tensors:
            k = _skey(out_tensors[0])
            if k is not None:
                self.fills[k] = fill
        op = Op(name, ins, outs, site, explicit_dtype=explicit_dtype,
                reduce=reduce, dest=dest, fill=dest_fill, nbytes=nbytes,
                bool_index=bool_index, sync=sync)
        self.trace.ops.append(op)
        return op


def _reduce_kind(name: str, args, kwargs) -> str | None:
    """The reduce kind of a scatter-reduce that includes its destination
    (sum, prod, min, max, mean), else None."""
    if name in ("scatter_reduce", "index_reduce"):
        if not kwargs.get("include_self", True):
            return None
        kind = args[4] if len(args) > 4 else kwargs.get("reduce")
        return _TORCH_TO_KIND.get(kind, kind)
    if name in _SCATTER_KIND:
        return _SCATTER_KIND[name]
    if name in ("index_put", "_index_put_impl"):
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return "sum" if acc else None
    return None


def _factory_fill(name: str, args, mutated):
    """The statically known value a factory op (or a ``fill_`` of a
    scalar) gives every element of its output, else None."""
    if name in _FACTORY_FILL:
        return _FACTORY_FILL[name]
    if name in _FULL:
        v = args[2] if name == "new_full" else args[-1]
    elif name == "fill" and mutated:
        v = args[1]
    else:
        return None
    return None if isinstance(v, torch.Tensor) else v


def _hidden_sync(name: str, args, kwargs, out) -> bool:
    """Whether an aten op reads a device value to the host inside its
    own kernel: _HIDDEN_SYNC_OPS, ``repeat_interleave`` of tensor repeats
    without ``output_size``, an ``index_put`` through a bool mask, and a
    copy from the card into host memory."""
    if name in _HIDDEN_SYNC_OPS:
        return True
    if name == "repeat_interleave":
        reps = args[1] if len(args) > 1 else args[0]
        size = kwargs.get("output_size")
        if size is None and len(args) > 3:
            size = args[3]
        return isinstance(reps, torch.Tensor) and reps.numel() > 1 \
            and size is None
    if name in ("index_put", "_index_put_impl") and len(args) > 1:
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] or ()))
    if name in ("copy", "_to_copy") and args \
            and isinstance(args[0], torch.Tensor):
        src = args[1] if name == "copy" and len(args) > 1 else args[0]
        dst = args[0] if name == "copy" else out
        return (isinstance(src, torch.Tensor)
                and isinstance(dst, torch.Tensor)
                and src.device.type == "cuda" and dst.device.type == "cpu")
    return False


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _make_modes(rec: _Recorder):
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class DispatchRecorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__.rstrip("_")
            mutated = [a for a, arg in zip(args, func._schema.arguments)
                       if isinstance(a, torch.Tensor) and arg.alias_info
                       is not None and arg.alias_info.is_write]
            mutated += [v for k, v in kwargs.items()
                        if k == "out" and isinstance(v, torch.Tensor)]
            reduce = _reduce_kind(name, args, kwargs)
            bool_index = name == "index" and len(args) > 1 and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] or ()))
            # a read method's own copy or scalar read is its read: not
            # a second one
            sync = not rec.in_read and _hidden_sync(name, args, kwargs,
                                                    out)
            rec.add(name, _tensors((args, kwargs)), _tensors(out),
                    explicit_dtype=(kwargs.get("dtype") is not None
                                    or name in _CAST_OPS),
                    reduce=reduce, dest=args[0] if reduce else None,
                    bool_index=bool_index, mutated=mutated,
                    fill=_factory_fill(name, args, mutated), sync=sync)
            return out

    class HostRecorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            owner = getattr(func, "__qualname__", "")
            self_t = args[0] if args and isinstance(args[0],
                                                    torch.Tensor) else None
            method = self_t is not None and owner.startswith(
                ("TensorBase.", "Tensor."))
            reading = method and name in _READ_METHODS | _MOVE_METHODS
            outer = rec.in_read
            rec.in_read = outer or reading
            try:
                out = func(*args, **kwargs)
            finally:
                rec.in_read = outer
            if method:
                if name in _READ_METHODS:
                    if _skey(self_t) not in rec.host:
                        rec.add(f"read:{name}", [self_t], [])
                elif name in _MOVE_METHODS and isinstance(out,
                                                          torch.Tensor):
                    src, dst = self_t.device, out.device
                    if dst.type == "cpu" and (src.type != "cpu"
                                              or name == "cpu"):
                        if _skey(self_t) not in rec.host:
                            rec.add(f"read:{name}", [self_t], [])
                        rec.host.add(_skey(out))
                        rec.host.add(_skey(self_t))
                    elif src.type == "cpu" and dst.type != "cpu":
                        rec.add(f"host:{name}", [], [],
                                nbytes=out.numel() * out.element_size())
            elif name in _HOST_FUNCS and isinstance(out, torch.Tensor):
                data = args[0] if args else None
                if not isinstance(data, torch.Tensor) or (
                        data.device.type == "cpu"
                        and out.device.type != "cpu"):
                    rec.add(f"host:{name}", [], [],
                            nbytes=out.numel() * out.element_size())
            return out

    return DispatchRecorder(), HostRecorder()


def _run_recorded(fn, args, rec: _Recorder):
    """Run ``fn(*args)`` under the recorder's modes (and the kernel
    observer), all three on this thread only; returns its result."""
    from lux_tpu_torch import _kernels
    dmode, fmode = _make_modes(rec)

    def observe(name, inputs, outputs):
        rec.add(f"kernel:{name}", [t for t in inputs if t is not None],
                list(outputs))

    prev = _kernels.observer()
    _kernels.set_observer(observe)
    try:
        with fmode, dmode:
            return fn(*args)
    finally:
        _kernels.set_observer(prev)


def record(fn, args, state=None, sync_debug: bool = False) -> Trace:
    """One recorded execution of ``fn(*args)`` on this thread: the Trace
    of every op it ran (what other threads run meanwhile is not in it).
    ``state`` (default: the tensors among ``args``) seeds the taint.
    Host reads are the recorder's own (``Trace.host_reads``).
    ``sync_debug``: on the card, also run it under
    ``torch.cuda.set_sync_debug_mode("error")`` (a sync then ends the
    run and is noted as ``trace.sync_error``).  That mode is
    process-wide, so a sync on any other thread would raise there: it is
    taken only in a process that runs no other Python thread, and
    asking for it with one running is a RuntimeError."""
    state = _tensors(args) if state is None else list(state)
    if sync_debug and threading.active_count() > 1:
        raise RuntimeError(
            f"sync_debug: {threading.active_count()} threads run in this "
            f"process; torch's sync debug mode is process-wide and would "
            f"fail another thread's syncs (the recorder's own host-read "
            f"detection needs no such mode)")
    rec = _Recorder(state)
    cuda = any(t.device.type == "cuda" for t in state)
    if sync_debug and cuda:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _run_recorded(fn, args, rec)
        except RuntimeError as e:
            if "synchroniz" not in str(e).lower():
                raise
            rec.trace.sync_error = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    else:
        _run_recorded(fn, args, rec)
    return rec.trace


# ---------------------------------------------------------------------
# the checks, each over one recorded iteration


def _table_shapes(spec: ProgramSpec) -> set:
    shapes = set()
    if spec.table_shape is not None:
        shapes.add(tuple(spec.table_shape))
    shapes.update(tuple(s) for s in spec.paged_table_shapes)
    return shapes


def _gather_operand(op: Op):
    return op.ins[0] if op.name in GATHER_OPS and op.ins else None


def table_gather_sites(trace: Trace, spec: ProgramSpec) -> set:
    """The call sites of the iteration's state-table gathers (a gather
    carrying an ``# audit: allow(gather-budget)`` pragma does not
    count)."""
    shapes = _table_shapes(spec)
    sites = set()
    for op in trace.ops:
        t = _gather_operand(op)
        if (t is not None and t.tainted and t.shape in shapes
                and not _pragma_allows(op.site, "gather-budget")):
            sites.add(op.site)
    return sites


def check_gather_budget(trace: Trace, spec: ProgramSpec, where: str):
    if spec.table_shape is None or spec.gather_budget is None:
        return []
    n = len(table_gather_sites(trace, spec))
    if n <= spec.gather_budget:
        return []
    return [Finding(
        "gather-budget", "error", where,
        f"{n} state-table gathers (operand {tuple(spec.table_shape)}) in "
        f"one iteration; budget is {spec.gather_budget} — mask into the "
        f"value vector pre-gather instead of gathering twice (the gather "
        f"is most of an iteration)")]


def check_collectives(trace: Trace, spec: ProgramSpec, where: str,
                      dense: bool = True):
    if spec.shard_shape is None or not dense:
        return []
    shard = tuple(spec.shard_shape)
    n = sum(1 for op in trace.ops
            if (t := _gather_operand(op)) is not None and t.tainted
            and t.shape == shard)
    if n >= spec.min_shard_gathers:
        return []
    return [Finding(
        "collective-schedule", "error", where,
        f"owner exchange must gather each source part from its own "
        f"{shard} shard (one gather a part, {spec.min_shard_gathers} "
        f"parts); {n} shard gathers seen — a gather over the global ids "
        f"pays the whole table's rate (PERF.md §5: 0.878 ms against "
        f"0.556 ms a part).  The ring, reduce-scatter and all-to-all "
        f"rules come with the mesh (ROADMAP A6b-2)")]


def check_dtypes(trace: Trace, spec: ProgramSpec, where: str):
    limit = max(4, int(spec.state_itemsize))
    offenders = {}
    for op in trace.ops:
        for o in op.outs:
            dt = o.dtype
            size = dt.itemsize
            bad = dt.is_complex or (dt.is_floating_point and size > limit)
            if not bad and size > limit and not dt.is_floating_point \
                    and dt != torch.bool and not op.explicit_dtype \
                    and op.name not in INDEX_OPS:
                narrower = [i for i in op.ins
                            if i.dtype != torch.bool and not i.dtype.is_complex
                            and i.dtype.itemsize < size]
                promoting = op.name in _REDUCE_PROMOTING and any(
                    i.dtype == torch.bool for i in op.ins)
                bad = bool(narrower) or promoting
            if bad and not _pragma_allows(op.site, "dtype-discipline"):
                key = (str(dt).replace("torch.", ""), op.name)
                offenders[key] = offenders.get(key, 0) + 1
    if not offenders:
        return []
    det = ", ".join(f"{d} out of {p} x{n}"
                    for (d, p), n in sorted(offenders.items()))
    return [Finding(
        "dtype-discipline", "error", where,
        f"values wider than the {limit}-byte state dtype ceiling (no "
        f"f64/complex; int64 only by explicit cast, dtype= or a factory, "
        f"never by promotion): {det}")]


def check_callbacks(trace: Trace, where: str, budget: int):
    findings = []
    reads = [op for op in trace.host_reads
             if not _pragma_allows(op.site, "callback-in-loop")]
    if len(reads) > budget:
        sites = ", ".join(
            f"{op.name.split(':')[-1]}@{os.path.basename(op.site[0][0])}:"
            f"{op.site[0][1]}" if op.site else op.name
            for op in reads[:6])
        findings.append(Finding(
            "callback-in-loop", "error", where,
            f"{len(reads)} host reads in one iteration; budget is "
            f"{budget} ({sites}) — a host round trip an iteration is what "
            f"the device-side loop exists to avoid; accumulate on the "
            f"device and fetch at run or segment boundaries"))
    if trace.sync_error:
        findings.append(Finding(
            "callback-in-loop", "error", where,
            f"torch.cuda sync debug mode caught a synchronization: "
            f"{trace.sync_error}"))
    return findings


def check_const_bytes(trace: Trace, spec: ProgramSpec, where: str):
    total = sum(op.nbytes for op in trace.ops
                if op.name.startswith("host:")
                and not _pragma_allows(op.site, "const-bytes"))
    if total <= spec.const_bytes_max:
        return []
    return [Finding(
        "const-bytes", "error", where,
        f"{total} bytes of host data made into tensors in one iteration "
        f"exceed the {spec.const_bytes_max}-byte ceiling — graph arrays "
        f"belong on the device, built once")]


def _op_elems(op: Op) -> int:
    return max([t.numel for t in op.ins + op.outs] or [0])


def check_loop_invariant(trace: Trace, where: str):
    findings = []
    for op in trace.ops:
        expensive = (op.name in EXPENSIVE_OPS
                     or op.name.startswith("kernel:"))
        if (expensive and op.ins and not any(i.tainted for i in op.ins)
                and _op_elems(op) >= _INVARIANT_MIN_ELEMS
                and not _pragma_allows(op.site, "loop-invariant")):
            findings.append(Finding(
                "loop-invariant", "warn", _where_src(op.site, where),
                f"{op.name} ({_op_elems(op)} elems) in an iteration "
                f"depends on no state value — the same result is "
                f"recomputed every iteration; compute it once when the "
                f"engine is built"))
    return findings


def identity_value(kind: str, dtype: torch.dtype):
    """The reduce identity of ``kind`` in ``dtype`` (ops/segment's
    convention; prod 1; bool: False for sum / max, True for min)."""
    if dtype == torch.bool:
        return {"sum": False, "max": False, "min": True, "prod": True}[kind]
    if kind == "prod":
        return 1
    from lux_tpu_torch.ops.segment import identity_for
    return identity_for(kind, dtype)


def check_identity_inits(trace: Trace, where: str):
    findings = []
    for op in trace.ops:
        if op.reduce is None or op.fill is None or op.reduce == "mean":
            continue
        dt = op.dest.dtype
        ident = identity_value(op.reduce, dt)
        try:
            same = bool(np.asarray(op.fill) == np.asarray(ident))
        except (TypeError, ValueError):
            same = False
        if not same and not _pragma_allows(op.site, "identity-init"):
            findings.append(Finding(
                "identity-init", "error", _where_src(op.site, where),
                f"{op.name} initialized with constant {op.fill} but the "
                f"{op.reduce}-reduce identity for "
                f"{str(dt).replace('torch.', '')} is {ident} — padding "
                f"and empty segments will contribute a non-identity value "
                f"(the one-identity convention)"))
    return findings


def audit_trace(trace: Trace, spec: ProgramSpec | None = None,
                where: str = "<program>", sync_budget: int = 0,
                dense: bool = True):
    """Every op-level check on one recorded iteration -> Findings."""
    spec = spec or ProgramSpec()
    findings = []
    findings += check_gather_budget(trace, spec, where)
    findings += check_const_bytes(trace, spec, where)
    findings += check_dtypes(trace, spec, where)
    findings += check_loop_invariant(trace, where)
    findings += check_collectives(trace, spec, where, dense=dense)
    findings += check_callbacks(trace, where, sync_budget)
    findings += check_identity_inits(trace, where)
    return findings


def raise_findings(findings, where: str = "",
                   warnings_as_errors: bool = False):
    """Raise the typed AuditError for ``findings`` (the specific
    subclass when they share one check); warnings raise only under
    ``warnings_as_errors``."""
    errs = [f for f in findings
            if f.severity == "error"
            or (warnings_as_errors and f.severity == "warn")]
    if not errs:
        return
    checks = {f.check for f in errs}
    cls = ERROR_TYPES[next(iter(checks))] if len(checks) == 1 \
        else AuditError
    msg = "; ".join(str(f) for f in errs[:8])
    if len(errs) > 8:
        msg += f" (+{len(errs) - 8} more)"
    raise cls(f"audit failed{' for ' + where if where else ''}: "
              f"{msg}", errs)


# ---------------------------------------------------------------------
# the engine-level driver


def engine_spec(engine, state) -> ProgramSpec:
    """The ProgramSpec an engine's own configuration implies (the
    reference's, lux_tpu/audit.py:796): ``state`` is one state tensor
    [P, vpad, ...] (push: the labels)."""
    P, vpad = engine.num_parts, engine.vpad
    trail = tuple(state.shape[2:])
    owner = engine.exchange == "owner"
    paged = getattr(engine, "page_plan", None) is not None
    T = P * vpad // 128
    paged_shapes = ()
    if paged and not owner:
        paged_shapes = ((T, 128) + trail,)
        if trail:
            paged_shapes += ((T, 128 * int(np.prod(trail))),)
    # the owner exchange gathers from each part's shard; its paged plans
    # from the PAGE-RESHAPED shard (lux_tpu/audit.py:821-825)
    shard = (vpad // 128, 128) + trail if paged else (vpad,) + trail
    return ProgramSpec(
        table_shape=(P * vpad,) + trail,
        gather_budget=0 if owner else 1,
        paged_table_shapes=paged_shapes,
        state_itemsize=state.element_size(),
        shard_shape=shard if owner else None,
        min_shard_gathers=P if owner else 0)


# host reads an iteration each variant may make (callback-in-loop)
SYNC_BUDGETS = {"run_until": 1, "run_until_stats": 1,
                "run_until_health": 1, "converge": 1, "converge_stats": 1,
                "converge_health": 1}


def _state_of(args):
    """The state tensors among a variant's arguments: the leading
    tensors before the first non-state argument (pull: the state; push:
    labels and active)."""
    return [a for a in args[:2] if isinstance(a, torch.Tensor)]


def run_variants(engine, names=None, sync_debug: bool = False) -> dict:
    """Record one iteration of each registered variant (or of
    ``names``) on a fresh state -> {name: Trace}.  Push engines keep
    their placed state and schedule.  ``sync_debug``: the step variants
    also under torch's sync debug mode (``record``)."""
    variants = engine.audit_programs()
    saved = (getattr(engine, "_placed", None),
             list(getattr(engine, "schedule", []) or []))
    traces = {}
    try:
        for name, (fn, args_thunk) in variants.items():
            if names is not None and name not in names:
                continue
            args = args_thunk()
            if hasattr(engine, "schedule"):
                engine.schedule = []
            tr = record(fn, args, state=_state_of(args),
                        sync_debug=sync_debug and name.startswith("step"))
            tr.schedule = list(getattr(engine, "schedule", []) or [])
            traces[name] = tr
    finally:
        if hasattr(engine, "_placed"):
            engine._placed, engine.schedule = saved
    return traces


def table_gathers(engine, traces=None, name: str | None = None) -> int:
    """The state-table gather count of variant ``name``'s iteration;
    by default the dense step's (the reference's ``_table_gathers`` of
    its step program): pull ``step``, push ``step_dense`` where the
    engine also iterates sparse, else ``step``."""
    variants = engine.audit_programs()
    if name is None:
        name = "step_dense" if "step_dense" in variants else "step"
    if traces is None or name not in traces:
        traces = run_variants(engine, [name])
    args = variants[name][1]()
    spec = engine_spec(engine, _state_of(args)[0])
    return len(table_gather_sites(traces[name], spec))


def audit_engine(engine, mode: str | None = "error",
                 allow=frozenset(), ledger: bool = False,
                 ledger_tol: float = 0.5, traces: dict | None = None,
                 sync_debug: bool = False):
    """Run one iteration of every registered program variant of
    ``engine`` on a fresh state and the full check catalogue; with
    ``ledger`` also cross-validate the memory ledger against one step's
    measured peak (``check_ledger``).  Returns the Finding list;
    ``mode='error'`` raises the typed AuditError on any error finding,
    ``mode='warn'`` emits an AuditWarning, ``mode=None`` only returns
    the findings; any other mode is a typed ValueError (a typo must not
    silently disable enforcement).  ``allow`` drops named checks (record
    WHY at the call site).  ``traces``: recorded iterations to reuse
    (run_variants); ``sync_debug``: passed to run_variants when it
    records them here."""
    if mode not in (None, "warn", "error"):
        raise ValueError(
            f"audit mode {mode!r} is not None|'warn'|'error' — an "
            f"unknown mode must not silently skip enforcement")
    eng_name = type(engine).__name__
    variants = engine.audit_programs()
    if traces is None:
        traces = run_variants(engine, sync_debug=sync_debug)
    findings = []
    spec = None
    for name in variants:
        tr = traces.get(name)
        if tr is None:
            continue
        if spec is None:
            spec = engine_spec(engine, _state_of(variants[name][1]())[0])
        dense = not tr.schedule or "dense" in tr.schedule
        findings += audit_trace(tr, spec, where=f"{eng_name}.{name}",
                                sync_budget=SYNC_BUDGETS.get(name, 0),
                                dense=dense)
    if ledger:
        findings += check_ledger(engine, tol=ledger_tol)
    findings = [f for f in findings if f.check not in allow]
    if mode == "error":
        raise_findings(findings, where=eng_name)
    elif mode == "warn":
        for f in findings:
            warnings.warn(str(f), AuditWarning, stacklevel=2)
    return findings


def measure_step_peak(engine) -> int:
    """The measured bytes of one (dense) step: the engine's own tensors
    (its graph and index tensors and one state, memwatch.argument_bytes)
    plus the peak the step allocates above what was live before it — on the
    card from the allocator's peak after a reset, on the CPU from the
    recorder's live storage bytes.  The audit's state is the one state
    counted."""
    from lux_tpu_torch import memwatch
    variants = engine.audit_programs()
    # the dense iteration, the one whose temporaries the ledger prices
    fn, thunk = variants.get("step_dense", variants["step"])
    args = thunk()
    base = memwatch.argument_bytes(engine)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        before = torch.cuda.memory_allocated(engine.device)
        torch.cuda.reset_peak_memory_stats(engine.device)
        out = fn(*args)
        torch.cuda.synchronize(engine.device)
        extra = torch.cuda.max_memory_allocated(engine.device) - before
        del out
        return base + int(extra)
    saved = getattr(engine, "_placed", None)
    tr = record(fn, args, state=_state_of(args))
    if hasattr(engine, "_placed"):
        engine._placed = saved
    return base + int(tr.peak_bytes)


def ledger_report(engine) -> dict:
    """memwatch's ledger (MemoryLedger.for_engine) beside one step's
    measured peak (``measure_step_peak``): {"measured_bytes",
    "ledger_bytes", "ratio" = measured / ledger, "argument_bytes" (the
    ledger's argument side), "grade" (memwatch's: measured on the card,
    modeled on the CPU)}."""
    from lux_tpu_torch import memwatch
    led = memwatch.MemoryLedger.for_engine(engine)
    measured = measure_step_peak(engine)
    return {"measured_bytes": int(measured),
            "ledger_bytes": int(led.total_bytes),
            "ratio": measured / max(1, led.total_bytes),
            "argument_bytes": int(led.argument_bytes()),
            "grade": (memwatch.GRADE_MEASURED
                      if engine.device.type == "cuda"
                      else memwatch.GRADE_MODELED)}


def check_ledger(engine, tol: float = 0.5, where: str | None = None):
    """The ledger against one step's measured peak (``ledger_report``),
    judged by memwatch.drift_verdict: the ratio must stay within
    [1/(1+tol), 1+tol] (the reference's tolerance, lux_tpu/audit.py:
    988).  Below memwatch.MEM_CHECK_FLOOR_BYTES of priced arguments the
    shape is padding-dominated and a failing ratio is a warning, as in
    memwatch.bench_digest."""
    from lux_tpu_torch import memwatch
    where = where or type(engine).__name__
    if engine.sg is None:
        return [Finding("ledger-drift", "warn", where,
                        "an engine built from arrays has no graph to "
                        "price; ledger cross-validation skipped")]
    rep = ledger_report(engine)
    v = memwatch.drift_verdict(rep["measured_bytes"], rep["ledger_bytes"],
                               grade=rep["grade"], where=where, tol=tol)
    if not v["errors"]:
        return []
    floor = rep["argument_bytes"] < memwatch.MEM_CHECK_FLOOR_BYTES
    return [Finding(
        "ledger-drift", "warn" if floor else "error", where,
        f"one step's measured peak {v['peak_bytes']} bytes vs priced "
        f"ledger {v['ledger_bytes']} (ratio {v['ratio']:.2f}) outside "
        f"the stated tolerance x{1 + tol:.2f} — memwatch's ledger has "
        f"drifted from the engine (exchange={engine.exchange})"
        + (f"; below the check floor ({rep['argument_bytes']} priced "
           f"argument bytes: a padding-dominated shape)" if floor
           else ""))]


# ---------------------------------------------------------------------
# the repo-wide matrix (python -m lux_tpu_torch.audit)


def _matrix_graphs():
    from lux_tpu_torch.graph import Graph

    def mk(nv, ne, weighted=False, seed=0):
        r = np.random.default_rng(seed)
        src = r.integers(0, nv, ne)
        dst = r.integers(0, nv, ne)
        w = (r.integers(1, 6, ne).astype(np.float32)
             if weighted else None)
        return Graph.from_edges(src, dst, nv, weights=w)

    return {
        "tiny": mk(256, 2048),
        "tiny_w": mk(256, 2048, weighted=True),
        # dense enough that edge arrays dominate padding: the ledger
        # cross-check is meaningful here
        "dense": mk(2048, 32768),
        "dense_w": mk(2048, 32768, weighted=True, seed=1),
    }


def matrix_configs(ledger: bool = True, device=None):
    """The reference's engine configuration matrix (lux_tpu/audit.py:
    1046), each config under the reference's label, its owner paged
    ones included, without its mesh configurations (ROADMAP A6b-2):
    [(label, build thunk, ledger?)].
    ``device``: the card unless "cpu" is asked for."""
    from lux_tpu_torch.apps import colfilter, components, pagerank, sssp
    from lux_tpu_torch.device import resolve_device
    from lux_tpu_torch.graph import pair_relabel

    graphs = _matrix_graphs()
    dev = resolve_device(device)
    configs = []
    g = graphs["tiny"]
    gw = graphs["tiny_w"]
    configs.append(("pagerank_np2_gather",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  device=dev), False))
    configs.append(("pagerank_np4_owner",
                    lambda: pagerank.build_engine(g, num_parts=4,
                                                  exchange="owner",
                                                  device=dev), False))

    def _pair_engine():
        g2, _perm, starts = pair_relabel(g, 2, pair_threshold=8)
        return pagerank.build_engine(g2, num_parts=2, pair_threshold=8,
                                     starts=starts, device=dev)

    configs.append(("pagerank_np2_pair", _pair_engine, False))
    configs.append(("sssp_np2_sparse",
                    lambda: sssp.build_engine(g, 0, num_parts=2,
                                              device=dev), False))
    configs.append(("sssp_np2_delta_w",
                    lambda: sssp.build_engine(gw, 0, num_parts=2,
                                              weighted=True, delta=1.0,
                                              device=dev), False))
    configs.append(("cc_np2_dense_only",
                    lambda: components.build_engine(
                        g, num_parts=2, enable_sparse=False, device=dev),
                    False))
    configs.append(("colfilter_np1_dot",
                    lambda: colfilter.build_engine(gw, num_parts=1,
                                                   device=dev), False))

    def _pair_dot_engine():
        g2, _perm, starts = pair_relabel(gw, 2, pair_threshold=8)
        return colfilter.build_engine(g2, num_parts=2, pair_threshold=8,
                                      starts=starts, device=dev)

    configs.append(("colfilter_np2_pair_dot", _pair_dot_engine, False))
    configs.append(("pagerank_np2_paged",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  gather="paged",
                                                  device=dev), False))
    configs.append(("sssp_np2_paged",
                    lambda: sssp.build_engine(g, 0, num_parts=2,
                                              gather="paged", device=dev),
                    False))
    configs.append(("pagerank_np4_owner_paged",
                    lambda: pagerank.build_engine(g, num_parts=4,
                                                  exchange="owner",
                                                  gather="paged",
                                                  device=dev), False))
    configs.append(("colfilter_np2_paged_dot",
                    lambda: colfilter.build_engine(gw, num_parts=2,
                                                   gather="paged",
                                                   device=dev), False))
    configs.append(("ppr_np2_paged_batched",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  sources=[0, 3, 7],
                                                  gather="paged",
                                                  device=dev), False))
    configs.append(("pagerank_np2_pagemajor",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  gather="pagemajor",
                                                  device=dev), False))
    configs.append(("cc_np2_pagemajor",
                    lambda: components.build_engine(
                        g, num_parts=2, enable_sparse=False,
                        gather="pagemajor", device=dev), False))
    configs.append(("pagerank_np4_owner_pagemajor",
                    lambda: pagerank.build_engine(g, num_parts=4,
                                                  exchange="owner",
                                                  gather="pagemajor",
                                                  device=dev), False))
    QB = [0, 3, 7, 11]
    configs.append(("ksssp_np2_batched",
                    lambda: sssp.build_engine(g, num_parts=2, sources=QB,
                                              device=dev), False))
    configs.append(("ksssp_np4_owner_batched",
                    lambda: sssp.build_engine(g, num_parts=4, sources=QB,
                                              exchange="owner",
                                              device=dev), False))
    configs.append(("ppr_np2_batched",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  sources=QB, device=dev),
                    False))
    configs.append(("ppr_np4_owner_batched",
                    lambda: pagerank.build_engine(g, num_parts=4,
                                                  sources=QB,
                                                  exchange="owner",
                                                  device=dev), False))
    configs.append(("cc_np2_batched",
                    lambda: components.build_engine(g, num_parts=2,
                                                    sources=QB[:2],
                                                    device=dev), False))

    def _live(builder):
        from lux_tpu_torch.livegraph import LiveGraph
        lg = LiveGraph(g, capacity=64)
        lg.append_edges([1, 2, 3], [9, 17, 33])
        # a published tombstone slot: the audited step keeps its single
        # state-table gather with the kind mask in it
        lg.delete_edges([1], [9])
        eng = builder()
        lg.register_audit(eng)
        return eng

    configs.append(("sssp_np2_live_delta",
                    lambda: _live(lambda: sssp.build_engine(
                        g, 0, num_parts=2, device=dev)), False))
    configs.append(("ksssp_np2_live_batched",
                    lambda: _live(lambda: sssp.build_engine(
                        g, num_parts=2, sources=QB, device=dev)), False))
    configs.append(("cc_np2_live_delta",
                    lambda: _live(lambda: components.build_engine(
                        g, num_parts=2, device=dev)), False))
    configs.append(("pagerank_np2_mxu",
                    lambda: pagerank.build_engine(g, num_parts=2,
                                                  use_mxu=True,
                                                  device=dev), False))
    configs.append(("sssp_np2_mxu",
                    lambda: sssp.build_engine(g, 0, num_parts=2,
                                              use_mxu=True, device=dev),
                    False))
    configs.append(("cc_np2_mxu_dense",
                    lambda: components.build_engine(
                        g, num_parts=2, enable_sparse=False, use_mxu=True,
                        device=dev), False))
    configs.append(("pagerank_np4_owner_mxu",
                    lambda: pagerank.build_engine(g, num_parts=4,
                                                  exchange="owner",
                                                  use_mxu=True,
                                                  device=dev), False))
    if ledger:
        gd = graphs["dense"]
        gdw = graphs["dense_w"]
        configs.append(("pagerank_np2_ledger",
                        lambda: pagerank.build_engine(gd, num_parts=2,
                                                      device=dev), True))
        configs.append(("sssp_np2_ledger",
                        lambda: sssp.build_engine(gdw, 0, num_parts=2,
                                                  weighted=True,
                                                  device=dev), True))
        configs.append(("ksssp_np2_batched_ledger",
                        lambda: sssp.build_engine(
                            gd, num_parts=2, sources=list(range(8)),
                            device=dev), True))
        configs.append(("ppr_np2_batched_ledger",
                        lambda: pagerank.build_engine(
                            gd, num_parts=2, sources=list(range(8)),
                            device=dev), True))
        configs.append(("pagerank_np2_paged_ledger",
                        lambda: pagerank.build_engine(
                            gd, num_parts=2, gather="paged", device=dev),
                        True))
        configs.append(("pagerank_np2_mxu_ledger",
                        lambda: pagerank.build_engine(
                            gd, num_parts=2, use_mxu=True, device=dev),
                        True))
    return configs


def run_repo_audit(verbose: bool = False, ledger: bool = True,
                   device=None, sync_debug: bool = False):
    """Build the engine matrix (``matrix_configs``, on the card unless
    ``device`` is "cpu") and audit every variant of every configuration
    (``sync_debug``: ``record``'s, for the step variants).  Returns the
    error/warn Findings (empty = clean)."""
    all_findings = []
    for label, build, do_ledger in matrix_configs(ledger=ledger,
                                                  device=device):
        eng = build()
        fs = audit_engine(eng, mode=None, ledger=do_ledger,
                          sync_debug=sync_debug)
        if verbose:
            n_err = sum(1 for f in fs if f.severity == "error")
            print(f"# audit {label}: {len(eng.audit_programs())} "
                  f"variants, {n_err} errors, {len(fs) - n_err} warnings")
        for f in fs:
            all_findings.append(dataclasses.replace(
                f, where=f"{label}/{f.where}"))
    return all_findings


def digest(findings, mode: str = "warn") -> dict:
    """JSON-serializable summary of an audit (the reference's
    lux_tpu/audit.py:1374)."""
    errs = [f for f in findings if f.severity == "error"]
    warns = [f for f in findings if f.severity == "warn"]
    return {
        "mode": mode,
        "errors": len(errs),
        "warnings": len(warns),
        "failed_checks": sorted({f.check for f in errs}),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.audit",
        description="repo-wide program audit of the port's engine matrix "
                    "(one recorded iteration a variant, on the card unless "
                    "-device cpu asks for the CPU)")
    ap.add_argument("-no-ledger", action="store_true", dest="no_ledger",
                    help="skip the ledger cross-validation")
    ap.add_argument("-warnings-as-errors", action="store_true",
                    dest="werror",
                    help="exit 1 on warning-severity findings too "
                         "(loop-invariant)")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                    help="device the matrix's engines run on (cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("-v", "-verbose", action="store_true", dest="verbose")
    args = ap.parse_args(argv)

    # this process runs no other thread: on the card the step variants
    # also run under torch's process-wide sync debug mode
    findings = run_repo_audit(verbose=args.verbose,
                              ledger=not args.no_ledger,
                              device=args.device,
                              sync_debug=args.device == "cuda")
    errors = [f for f in findings if f.severity == "error"]
    warns = [f for f in findings if f.severity == "warn"]
    for f in findings:
        print(("ERROR: " if f.severity == "error" else "WARNING: ")
              + str(f))
    bad = errors + (warns if args.werror else [])
    if bad:
        print(f"audit: {len(errors)} error(s), {len(warns)} "
              f"warning(s) — FAILED")
        return 1
    print(f"audit: clean ({len(warns)} warning(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
