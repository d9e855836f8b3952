"""Checkpoint / resume for long iterative runs (counterpart of
lux_tpu/checkpoint.py; the file format is the reference's, byte for
byte, so either package resumes a run the other began).

- ``save(path, state, meta)`` / ``load(path)``: one atomic ``.npz``
  written by ``numpy.savez`` with members ``_meta`` (a JSON string),
  ``_n`` (the leaf count), ``_crc`` (a JSON list of per-leaf CRC32s)
  and ``leaf_0 .. leaf_{n-1}``.  State leaves are device tensors
  (``.cpu()`` fences the stream) or arrays; dtypes and C-order bytes
  are kept (the push engine's active mask stays bool), so a leaf's
  CRC is the one the reference computes for the same state.  The file
  is fsynced before the atomic rename, and the previous file rotates
  to ``<path>.prev``: two generations on disk.
- ``load`` re-checksums every leaf: a bit flip, a torn write or a
  truncated container raises :class:`CorruptCheckpointError`;
  ``load_any`` falls back one generation (a ``checkpoint_fallback``
  event) and quarantines the corrupt file to ``<path>.corrupt``.
- Every save records the engine's placement (``ndev``, ``num_parts``,
  ``vpad``, ``exchange``); a resume must match num_parts / vpad /
  exchange (``_check_placement``); a device-count difference is the
  reference's re-placement contract and emits a ``replace`` event.
- ``run_checkpointed`` (pull, fixed iterations) and
  ``converge_checkpointed`` (push, to convergence) save after every
  segment (segmented.py) and resume from the newest good generation.
- On a mesh (lux_tpu/checkpoint.py:91-100, :263-290) ``save(...,
  mesh=)`` all_gathers every leaf into the global [P, vpad, ...] view
  on every rank (all ranks call it together) and rank 0 alone writes;
  a resume's ``eng.place`` keeps each rank's rows of that view, so a
  run saved on one world resumes on any world that divides P.

Leaf order is the reference's flattening: a pull checkpoint holds one
leaf (the state), a push checkpoint two (labels, then the active mask).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib

import numpy as np
import torch

from lux_tpu_torch import telemetry
from lux_tpu_torch.debug import leaves as _leaves
from lux_tpu_torch.debug import to_host


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file failed integrity verification (CRC mismatch,
    truncated or garbage container, missing members).  Carries
    ``path``; resilience.classify treats it as RETRYABLE — the retry's
    resume goes through ``load_any``, which falls back one
    generation."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: corrupt checkpoint — {detail}")
        self.path = path
        self.detail = detail


def prev_path(path: str) -> str:
    """The previous-generation file ``save`` rotates into."""
    return path + ".prev"


def any_generation(path: str) -> bool:
    """True if either generation exists on disk."""
    return os.path.exists(path) or os.path.exists(prev_path(path))


def corrupt_path(path: str) -> str:
    """Where ``load_any`` quarantines a corrupt newest generation."""
    return path + ".corrupt"


def remove(path: str) -> None:
    """Remove BOTH generations (a fresh start must clear the fallback
    too) plus any quarantined corrupt file."""
    for p in (path, prev_path(path), corrupt_path(path)):
        if os.path.exists(p):
            os.unlink(p)


def _leaf_crc(leaf: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(leaf).tobytes()) & 0xFFFFFFFF


def chained_crc32(data: bytes, prev: int = 0) -> int:
    """CRC32 of ``data`` seeded with the previous link's CRC: a record's
    CRC covers its bytes and, through the seed, every byte before it,
    so a torn or reordered tail of an append-only log cannot
    re-validate (the reference's mutation log uses it; ROADMAP A11)."""
    return zlib.crc32(data, prev & 0xFFFFFFFF) & 0xFFFFFFFF


def save(path: str, state, meta: dict | None = None,
         rotate: bool = True, mesh=None) -> int:
    """Atomically write a checkpoint: ``state`` is a tensor or array,
    or a tuple / list / dict of them; ``meta`` a JSON-serializable
    dict.  Returns the staged host bytes.  With ``rotate`` an existing
    file at ``path`` becomes ``<path>.prev`` before the rename.
    ``mesh``: the leaves are a rank's part rows; every rank calls this,
    the global view is gathered, rank 0 writes it (the others return
    0) and every rank returns once the file is in place."""
    if mesh is not None:
        from lux_tpu_torch.ops.collectives import barrier
        from lux_tpu_torch.parallel.multihost import fetch_global
        leaves = [np.ascontiguousarray(fetch_global(x, mesh))
                  for x in _leaves(state)]
        staged = 0
        if mesh.rank == 0:
            staged = _write(path, leaves, meta, rotate)
        barrier(mesh)
        return staged
    leaves = [np.ascontiguousarray(to_host(x)) for x in _leaves(state)]
    return _write(path, leaves, meta, rotate)


def _write(path: str, leaves: list, meta: dict | None,
           rotate: bool) -> int:
    """The atomic write of host leaves -> their bytes."""
    staged = sum(int(leaf.nbytes) for leaf in leaves)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    crcs = [_leaf_crc(leaf) for leaf in leaves]
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, _meta=json.dumps(meta or {}),
                     _n=len(leaves), _crc=json.dumps(crcs), **payload)
            # the rename is atomic against a process kill; only an
            # fsync before it makes the file durable against a host
            # crash or power loss
            f.flush()
            os.fsync(f.fileno())
        if rotate and os.path.exists(path):
            # a crash between the two renames leaves only .prev —
            # exactly the state load_any's fallback recovers from
            os.replace(path, prev_path(path))
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
        except OSError:
            return staged
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return staged


def load(path: str, verify: bool = True):
    """Returns (leaves list, meta dict), leaves in save order.
    Unreadable containers and — with ``verify`` — per-leaf CRC
    mismatches raise CorruptCheckpointError; a missing FILE raises
    FileNotFoundError (absent and corrupt are different conditions:
    only the latter has a generation to fall back to)."""
    import zipfile

    try:
        with np.load(path, allow_pickle=False) as z:
            n = int(z["_n"])
            meta = json.loads(str(z["_meta"]))
            leaves = [z[f"leaf_{i}"] for i in range(n)]
            crcs = (json.loads(str(z["_crc"]))
                    if "_crc" in z.files else None)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, KeyError, ValueError, EOFError,
            OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            path, f"unreadable ({type(e).__name__}: {e})") from e
    if verify and crcs is not None:
        if len(crcs) != len(leaves):
            raise CorruptCheckpointError(
                path, f"{len(leaves)} leaves but {len(crcs)} CRCs")
        for i, (want, leaf) in enumerate(zip(crcs, leaves)):
            got = _leaf_crc(leaf)
            if got != want:
                raise CorruptCheckpointError(
                    path, f"leaf {i} CRC32 {got:#010x} != recorded "
                          f"{want:#010x} (bit flip or torn write)")
    return leaves, meta


def load_any(path: str):
    """Newest-first load with generation fallback: returns (leaves,
    meta, used_path).  A corrupt newest generation emits a
    ``checkpoint_fallback`` event, is quarantined to
    ``<path>.corrupt`` (so the next save's rotation cannot promote it
    over the only good generation) and ``<path>.prev`` is loaded;
    raises CorruptCheckpointError when every generation is corrupt,
    FileNotFoundError when none exists."""
    prev = prev_path(path)
    if os.path.exists(path):
        try:
            leaves, meta = load(path)
            return leaves, meta, path
        except CorruptCheckpointError as e:
            if not os.path.exists(prev):
                raise
            telemetry.current().emit(
                "checkpoint_fallback", path=path, fallback=prev,
                error=str(e)[:200])
            leaves, meta = load(prev)
            try:
                os.replace(path, corrupt_path(path))
            except OSError:
                pass
            return leaves, meta, prev
    leaves, meta = load(prev)
    return leaves, meta, prev


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.dtype(x.dtype)


def _check_leaves(path, expect, leaves):
    """Shape / dtype of loaded ``leaves`` against ``expect`` (anything
    with shape and dtype): a checkpoint of another graph or scale must
    not resume into this engine."""
    for i, (d, l) in enumerate(zip(expect, leaves)):
        if (tuple(d.shape) != tuple(l.shape)
                or _np_dtype(d) != np.dtype(l.dtype)):
            raise ValueError(
                f"{path} leaf {i} is {l.dtype}{tuple(l.shape)}, engine "
                f"expects {_np_dtype(d)}{tuple(d.shape)} — checkpoint "
                f"from a different graph/scale?")


def _placement_of(eng) -> dict:
    """{"placement": {...}} for a save (empty for engines without the
    placement surface)."""
    meta = getattr(eng, "placement_meta", None)
    if meta is None:
        return {}
    return {"placement": meta()}


def _check_placement(used: str, meta: dict, eng, kind: str) -> None:
    """A checkpoint's recorded placement against the resuming engine:
    num_parts / vpad / exchange must MATCH (the padded layout and the
    reduction order are fixed across a recovery); a device-count
    difference is a re-placement and emits a ``replace`` event."""
    pl = meta.get("placement")
    want = getattr(eng, "placement_meta", None)
    if not isinstance(pl, dict) or want is None:
        return                      # legacy checkpoint / bare engine
    want = want()
    for key in ("num_parts", "vpad", "exchange"):
        if key in pl and pl[key] != want[key]:
            raise ValueError(
                f"{used} was written with {key}={pl[key]!r}, this "
                f"engine has {key}={want[key]!r} — re-placement keeps "
                f"the partitioning and exchange FIXED and changes "
                f"only the device mapping (rebuild the engine with "
                f"the checkpoint's config, or start fresh)")
    old_ndev = pl.get("ndev")
    if isinstance(old_ndev, int) and old_ndev != want["ndev"]:
        telemetry.current().emit(
            "replace", engine=kind, from_ndev=old_ndev,
            to_ndev=want["ndev"], iter=int(meta.get("iter", 0)),
            path=used)


def _timed_save(path, state, meta, mesh=None):
    """save() under a ``lux_checkpoint_save`` profiler range and a
    ``checkpoint_save`` event (its staged bytes and seconds); the staged
    bytes are the memory ledger's ``checkpoint_staging`` term
    (memwatch.note_staging)."""
    from lux_tpu_torch import memwatch
    from lux_tpu_torch.profiling import annotation

    t0 = time.perf_counter()
    with annotation("lux_checkpoint_save"):
        staged = save(path, state, meta, mesh=mesh)
    memwatch.note_staging(staged)
    telemetry.current().emit(
        "checkpoint_save", iter=int(meta.get("iter", 0)),
        engine=meta.get("kind"), path=path, staged_bytes=int(staged),
        seconds=round(time.perf_counter() - t0, 6))


def run_checkpointed(eng, state, num_iters: int, path: str,
                     segment=50, start_iter: int = 0,
                     resume: bool = False, on_segment=None):
    """Run a pull engine ``num_iters`` iterations, checkpointing every
    segment (``segment``: int size or segmented.DurationBudget).

    ``resume=True`` loads the checkpoint at ``path`` (if either
    generation exists), places its state on the engine's device
    (``eng.place``) and continues from its iteration counter; the
    passed ``state`` then only supplies the shape to check against.
    A corrupt newest generation falls back to ``<path>.prev`` and the
    segments past its counter are re-run.  ``on_segment(state, done)``
    runs BEFORE each save and may raise (the save is skipped, so the
    checkpoint stays at the last good segment) or return a replacement
    state (which is what gets saved)."""
    from lux_tpu_torch.segmented import run_segments

    if resume and any_generation(path):
        leaves, meta, used = load_any(path)
        expect = _leaves(state)
        if meta.get("kind") != "pull" or len(expect) != len(leaves):
            raise ValueError(
                f"{used} is not a matching pull-engine checkpoint "
                f"(kind={meta.get('kind')!r}, {len(leaves)} arrays)")
        _check_leaves(used, expect, leaves)
        _check_placement(used, meta, eng, "pull")
        state = eng.place(leaves[0])
        start_iter = int(meta["iter"])
        telemetry.current().emit("checkpoint_resume", engine="pull",
                                 iter=start_iter, path=used)

    def seg_hook(s, done):
        out = None
        if on_segment is not None:
            res = on_segment(s, done)
            if res is not None:
                s = out = res
        _timed_save(path, (s,), {"iter": done, "kind": "pull",
                                 **_placement_of(eng)},
                    getattr(eng, "mesh", None))
        return out

    return run_segments(eng, state, num_iters, segment,
                        start_iter=start_iter, on_segment=seg_hook)


class _Spec:
    """A shape and a dtype: what ``_check_leaves`` compares."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)


def push_state_specs(eng) -> list:
    """(label, active) shapes and dtypes of a push engine's state,
    without building it: [P, vpad] (+ [B] batched), the program's label
    dtype and bool."""
    shape = (eng.num_parts, eng.vpad) + (
        (eng.batch,) if getattr(eng, "batch", None) else ())
    return [_Spec(shape, np.asarray(eng.program.identity).dtype),
            _Spec(shape, bool)]


def converge_checkpointed(eng, path: str, segment=50,
                          resume: bool = False,
                          max_iters: int | None = None,
                          on_segment=None):
    """Run a push engine to convergence in segments (``segment``: int
    size or segmented.DurationBudget), checkpointing after each.
    ``on_segment(label, active, total, cnt)`` runs BEFORE each save,
    with run_checkpointed's raise / replace contract.  Returns
    (label, active, total_iters)."""
    from lux_tpu_torch.segmented import converge_segments

    if resume and any_generation(path):
        leaves, meta, used = load_any(path)
        if meta.get("kind") != "push" or len(leaves) != 2:
            raise ValueError(
                f"{used} is not a push-engine checkpoint "
                f"(kind={meta.get('kind')!r}, {len(leaves)} arrays)")
        _check_leaves(used, push_state_specs(eng), leaves)
        _check_placement(used, meta, eng, "push")
        label, active = eng.place(*leaves)
        done = int(meta["iter"])
        telemetry.current().emit("checkpoint_resume", engine="push",
                                 iter=done, path=used)
    else:
        label, active = eng.init_state()
        done = 0

    def seg_hook(lbl, act, total, cnt):
        out = None
        if on_segment is not None:
            res = on_segment(lbl, act, total, cnt)
            if res is not None:
                lbl, act = res
                out = res
        _timed_save(path, (lbl, act), {"iter": total, "kind": "push",
                                       **_placement_of(eng)},
                    getattr(eng, "mesh", None))
        return out

    return converge_segments(
        eng, label, active, segment, max_iters, start_iter=done,
        on_segment=seg_hook)
