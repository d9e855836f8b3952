"""Structured run events and device-side iteration counters
(counterpart of lux_tpu/telemetry.py).

- ``EventLog``: an append-only event sink, kept in memory and, with
  ``path``, written as JSONL, one ``os.write`` an event (line-atomic
  under concurrent appenders); ``rotate_bytes`` bounds the file by
  size-triggered rotation into ``<path>.1``, ``<path>.2``, ...
  (``rotated_paths`` lists the set oldest first);
- ``IterStats``: the host accumulator of the engines' device-side
  per-iteration counters (push: frontier size and out-edges relaxed;
  pull: residual and changed vertices; both per part as well), fetched
  once a run or segment;
- ``Telemetry`` / ``use()`` / ``current()``: a contextvar-scoped handle,
  so run paths emit without threading a parameter through every call;
  the default handle drops events;
- event observers (``add_observer``): every event built, by a sink or
  by a sink-less handle while an observer is installed, is offered to
  each observer (tracing.py's flight recorder);
- ``emit_sampled``: a throttled emit for per-boundary trails.

Counter semantics, engine by engine (the reference's):

- push classic (``PushEngine.converge_stats``): ``frontier[i]`` is the
  active count AFTER iteration i; ``edges[i]`` the out-edges of the
  frontier ENTERING it;
- push delta-stepping: ``frontier[i]`` is the bucket front entering
  relax step i, ``edges[i]`` its out-edges;
- pull (``PullEngine.run_stats`` / ``run_until_stats``):
  ``residual[i]`` is the max-abs state change of iteration i,
  ``changed[i]`` the number of vertices whose state changed.

The port's buffers hold int32 counts (edges int64) where the
reference's hold uint32: ``IterStats`` takes either, and its digest is
the reference's on the same counts.  Pure host Python; it imports
nothing of the reference.
"""

from __future__ import annotations

import binascii
import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time

import numpy as np

SCHEMA = 1

# rows of the engines' per-iteration counter buffers (writes past it
# drop), as the reference's
DEFAULT_STATS_CAP = 4096

# One id per PROCESS, minted at import: several processes may append
# to one event file, wall clocks ("t") skew across hosts while
# monotonic clocks ("tm") only order within a process, so (session,
# pid) is the merge key of a combined log.
_SESSION = binascii.hexlify(os.urandom(6)).decode()


def session_id() -> str:
    """This process's 12-hex-char telemetry session id."""
    return _SESSION


# Event observers (tracing.py's flight recorder): every event built by
# EventLog.emit, or by a sink-less Telemetry.emit while an observer is
# installed, is offered to each.  Observer failures are swallowed: a
# postmortem ride-along must never fail the run it diagnoses.
_OBSERVERS: list = []


def add_observer(fn) -> None:
    if fn not in _OBSERVERS:
        _OBSERVERS.append(fn)


def remove_observer(fn) -> None:
    if fn in _OBSERVERS:
        _OBSERVERS.remove(fn)


def make_event(kind: str, fields: dict) -> dict:
    """One wire-format event dict: ``tm`` (monotonic) orders events
    within a process, ``t`` (wall) only roughly across processes."""
    return {"t": round(time.time(), 6), "tm": round(time.monotonic(), 6),
            "pid": os.getpid(), "session": _SESSION, "kind": str(kind),
            **fields}


def _notify(ev: dict) -> None:
    for fn in list(_OBSERVERS):
        try:
            fn(ev)
        except Exception:       # noqa: BLE001 — see _OBSERVERS
            pass


class EventLog:
    """Append-only structured event sink.  Events are kept in memory
    (``self.events``); with ``path`` each is also written at once as
    one JSON line, by one ``os.write`` to a file opened O_APPEND, so
    two processes' lines never interleave and a crashed run still
    leaves its trail.

    ``rotate_bytes`` bounds the file: when the live file has passed
    the threshold, the next emit renames it to ``<path>.1`` (older
    generations shift up, the one past ``generations`` drops), opens a
    fresh live file and stamps it with a ``log_rotate`` event.  The
    rotation runs under an flock'd ``<path>.lock``; a writer that lost
    the race follows the rename on its next emit (its descriptor still
    holds a whole, untorn generation), and every write stays one
    O_APPEND ``os.write``.  A rotation also trims ``self.events`` to
    the newest ``MEM_KEEP``."""

    MEM_KEEP = 4096

    def __init__(self, path: str | None = None,
                 rotate_bytes: int | None = None, generations: int = 2):
        if rotate_bytes is not None and rotate_bytes <= 0:
            raise ValueError(f"rotate_bytes must be > 0, got "
                             f"{rotate_bytes}")
        if generations < 1:
            raise ValueError(f"generations must be >= 1, got "
                             f"{generations}")
        self.path = path
        self.rotate_bytes = rotate_bytes
        self.generations = int(generations)
        self.rotations = 0
        self.events: list[dict] = []
        self._closed = False
        self._fd = self._open() if path else None

    def _open(self) -> int:
        return os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                       0o644)

    def _swap_fd(self) -> None:
        """Close the held descriptor and reopen the live path; ``_fd``
        is valid or None at every step (a failed reopen leaves None and
        the next emit retries)."""
        fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fd = self._open()

    @staticmethod
    def _ident(st):
        return None if st is None else (st.st_dev, st.st_ino)

    def _stat_path(self):
        try:
            return os.stat(self.path)
        except FileNotFoundError:
            return None

    def _maybe_rotate(self) -> None:
        """Before the next event: recover a sink lost to a failed
        reopen, follow a rotation another writer made, or rotate when
        the live file has passed ``rotate_bytes``."""
        import fcntl
        try:
            if self._fd is None:
                if not self._closed:
                    self._fd = self._open()
                return
            mine = os.fstat(self._fd)
            if self._ident(self._stat_path()) != self._ident(mine):
                self._swap_fd()             # someone else rotated
                return
            if mine.st_size <= self.rotate_bytes:
                return
            lfd = os.open(self.path + ".lock", os.O_WRONLY | os.O_CREAT,
                          0o644)
            try:
                fcntl.flock(lfd, fcntl.LOCK_EX)
                mine = os.fstat(self._fd)   # re-check under the lock
                rotated = (self._ident(self._stat_path())
                           == self._ident(mine)
                           and mine.st_size > self.rotate_bytes)
                if rotated:
                    for g in range(self.generations - 1, 0, -1):
                        src = f"{self.path}.{g}"
                        if os.path.exists(src):
                            os.replace(src, f"{self.path}.{g + 1}")
                    os.replace(self.path, f"{self.path}.1")
                self._swap_fd()
            finally:
                fcntl.flock(lfd, fcntl.LOCK_UN)
                os.close(lfd)
            if rotated:
                self.rotations += 1
                if len(self.events) > self.MEM_KEEP:
                    self.events = self.events[-self.MEM_KEEP:]
                rot = make_event("log_rotate", {
                    "path": self.path, "rotation": self.rotations,
                    "rotate_bytes": self.rotate_bytes,
                    "generations": self.generations})
                self.events.append(rot)
                os.write(self._fd, (json.dumps(rot) + "\n").encode())
                _notify(rot)
        except OSError:
            pass        # best effort: the event still lands in memory

    def emit(self, kind: str, **fields) -> dict:
        if self.path is not None and self.rotate_bytes is not None:
            self._maybe_rotate()
        ev = make_event(kind, fields)
        self.events.append(ev)
        if self._fd is not None:
            os.write(self._fd, (json.dumps(ev) + "\n").encode())
        _notify(ev)
        return ev

    def counts(self) -> dict:
        """{kind: occurrences} over everything emitted so far."""
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def close(self) -> None:
        self._closed = True
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def rotated_paths(path: str) -> list[str]:
    """The on-disk generations of a (possibly rotated) event log, OLDEST
    FIRST: [path.N, ..., path.1, path]; a log never rotated is
    [path]."""
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    return [f"{path}.{g}" for g in range(n - 1, 0, -1)] + [path]


class IterStats:
    """Host accumulator of the engines' device-side per-iteration
    counters.  ``extend_push`` / ``extend_pull`` append one run's or
    segment's buffers (one fetch of their live prefix); ``begin_run``
    resets, so a timed helper keeps its last run while the segmented
    drivers accumulate across segments."""

    def __init__(self):
        self.begin_run()

    def __len__(self):
        return len(self.frontier) if self.kind == "push" \
            else len(self.residual)

    def begin_run(self) -> None:
        self.kind: str | None = None
        self.frontier: list[int] = []
        self.edges: list[int] = []
        self.residual: list[float] = []
        self.changed: list[int] = []
        # one [P] row an iteration, from the [stats_cap, P] buffers
        self.frontier_parts: list[list[int]] = []
        self.edges_parts: list[list[int]] = []
        self.residual_parts: list[list[float]] = []
        self.changed_parts: list[list[int]] = []
        self.truncated = False

    def _fetch(self, buf, n: int):
        """The first ``n`` rows of a counter buffer on the host: the
        slice is taken on the device, so only the live prefix moves."""
        cap = buf.shape[0]
        if n > cap:
            self.truncated = True
        head = buf[:min(int(n), cap)]
        if hasattr(head, "detach"):
            head = head.detach().cpu().numpy()
        return np.asarray(head)

    def extend_push(self, frontier_buf, edges_buf, n: int,
                    frontier_parts=None, edges_parts=None) -> None:
        """Append ``n`` iterations of a push engine's buffers (frontier
        [cap], edges [cap]; optional per-part [cap, P])."""
        self.kind = "push"
        self.frontier += [int(x) for x in self._fetch(frontier_buf, n)]
        self.edges += [int(x) for x in self._fetch(edges_buf, n)]
        if frontier_parts is not None:
            self.frontier_parts += [[int(x) for x in row] for row in
                                    self._fetch(frontier_parts, n)]
        if edges_parts is not None:
            self.edges_parts += [[int(x) for x in row] for row in
                                 self._fetch(edges_parts, n)]

    def extend_pull(self, residual_buf, changed_buf, n: int,
                    residual_parts=None, changed_parts=None) -> None:
        """Append ``n`` iterations of a pull engine's buffers (residual
        float32 [cap], changed [cap]; optional per-part [cap, P])."""
        self.kind = "pull"
        self.residual += [float(x) for x in self._fetch(residual_buf, n)]
        self.changed += [int(x) for x in self._fetch(changed_buf, n)]
        if residual_parts is not None:
            self.residual_parts += [[float(x) for x in row] for row in
                                    self._fetch(residual_parts, n)]
        if changed_parts is not None:
            self.changed_parts += [[int(x) for x in row] for row in
                                   self._fetch(changed_parts, n)]

    def _work_rows(self):
        return self.edges_parts if self.kind == "push" \
            else self.changed_parts

    def num_parts(self) -> int:
        rows = self._work_rows()
        return len(rows[0]) if rows else 0

    def part_totals(self) -> list[int] | None:
        """Per-part work over the run (push: out-edges relaxed; pull:
        changed vertices); they sum to ``edges_sum`` / ``changed_sum``.
        None without per-part rows."""
        rows = self._work_rows()
        if not rows:
            return None
        return [sum(r[p] for r in rows) for p in range(len(rows[0]))]

    def imbalance(self) -> float | None:
        """max / mean of the per-part work totals (1.0 = balanced);
        None without per-part rows or with no work."""
        totals = self.part_totals()
        if not totals or sum(totals) == 0:
            return None
        return max(totals) / (sum(totals) / len(totals))

    def imbalance_digest(self) -> dict | None:
        """{kind, index, parts} or None."""
        totals = self.part_totals()
        imb = self.imbalance()
        if totals is None or imb is None:
            return None
        return {"kind": self.kind, "index": round(imb, 4), "parts": totals}

    def parts_lines(self):
        """The per-part attribution table, line by line."""
        totals = self.part_totals()
        if totals is None:
            return
        metric = "edges" if self.kind == "push" else "changed"
        tot = sum(totals) or 1
        imb = self.imbalance()
        yield (f"per-part {metric} (imbalance "
               f"{'n/a' if imb is None else f'{imb:.3f}'} max/mean):")
        for p, v in enumerate(totals):
            yield f"  part {p}: {v} ({v / tot * 100:.1f}%)"

    def summary(self) -> dict | None:
        """The compact digest of event logs and RunReport.counters."""
        if self.kind is None:
            return None
        out = {"kind": self.kind, "iters": len(self),
               "truncated": bool(self.truncated)}
        if self.kind == "push":
            if self.frontier:
                out.update(frontier_last=self.frontier[-1],
                           frontier_max=max(self.frontier),
                           frontier_sum=sum(self.frontier),
                           edges_sum=sum(self.edges))
        elif self.residual:
            out.update(residual_first=self.residual[0],
                       residual_last=self.residual[-1],
                       changed_last=self.changed[-1],
                       changed_sum=sum(self.changed))
        totals = self.part_totals()
        if totals is not None:
            imb = self.imbalance()
            out["parts"] = len(totals)
            out["parts_edges" if self.kind == "push"
                else "parts_changed"] = totals
            if imb is not None:
                out["imbalance"] = round(imb, 4)
        return out

    def replay_lines(self):
        """One line an iteration: push ``iter i: frontier=F edges=E``,
        pull ``iter i: residual=R changed=C``."""
        if self.kind == "push":
            for i, (f, e) in enumerate(zip(self.frontier, self.edges), 1):
                yield f"iter {i}: frontier={f} edges={e}"
        elif self.kind == "pull":
            for i, (r, c) in enumerate(zip(self.residual, self.changed),
                                       1):
                yield f"iter {i}: residual={r:.6e} changed={c}"
        if self.truncated:
            yield ("... counters truncated (buffer filled before the "
                   "run finished)")


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The sinks a run path consults; either may be None.  Without an
    event sink ``emit`` only feeds installed observers."""

    events: EventLog | None = None
    iter_stats: IterStats | None = None

    def emit(self, kind: str, **fields):
        if self.events is not None:
            return self.events.emit(kind, **fields)
        if _OBSERVERS:
            ev = make_event(kind, fields)
            _notify(ev)
            return ev
        return None


_NULL = Telemetry()
_current: contextvars.ContextVar[Telemetry] = contextvars.ContextVar(
    "lux_tpu_torch_telemetry", default=_NULL)

# per-kind occurrence counters behind emit_sampled (process-wide, as
# the trails it throttles are)
_SAMPLED: dict = {}
_SAMPLED_LOCK = threading.Lock()


def emit_sampled(kind: str, every: int = 1, **fields):
    """Throttled ``current().emit`` for high-frequency kinds: emits
    occurrence 0, every, 2*every, ... of ``kind`` and drops the rest;
    each emitted event carries ``sampled_skipped`` (events dropped
    since the last emitted one).  ``every=1`` is a plain emit."""
    every = max(1, int(every))
    with _SAMPLED_LOCK:
        n = _SAMPLED.get(kind, 0)
        _SAMPLED[kind] = n + 1
    if n % every:
        return None
    return current().emit(kind, sampled_skipped=min(n, every - 1),
                          **fields)


def current() -> Telemetry:
    """The active Telemetry handle (a null no-op one by default)."""
    return _current.get()


@contextlib.contextmanager
def use(events: EventLog | None = None, iter_stats: IterStats | None = None):
    """Scope a Telemetry handle: every run path entered inside the
    block (the timing helpers, the segmented drivers, the supervisor,
    the serving layer) emits into ``events`` and, where it runs an
    engine's counter variant, accumulates into ``iter_stats``."""
    tel = Telemetry(events=events, iter_stats=iter_stats)
    token = _current.set(tel)
    try:
        yield tel
    finally:
        _current.reset(token)
