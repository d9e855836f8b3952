"""Structured run events: the event path that the serving layer and
the segmented drivers emit through (counterpart of
lux_tpu/telemetry.py:119-305 and :510-575).

- ``EventLog``: an append-only event sink, kept in memory and, with
  ``path``, written as JSONL, one ``os.write`` an event (line-atomic
  under concurrent appenders);
- ``Telemetry`` / ``use()`` / ``current()``: a contextvar-scoped handle,
  so run paths emit without threading a parameter through every call;
  the default handle drops events;
- ``emit_sampled``: a throttled emit for per-boundary trails.

Not ported yet: the device-side iteration counters (``IterStats``;
``use(iter_stats=...)`` raises NotPortedError naming ROADMAP A10), the
reference's size-triggered log rotation and its event observers (the
flight recorder of tracing.py), which nothing in the port emits to.
Pure host Python; it imports nothing of the reference.
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

SCHEMA = 1

# One id per PROCESS, minted at import: several processes may append
# to one event file, wall clocks ("t") skew across hosts while
# monotonic clocks ("tm") only order within a process, so (session,
# pid) is the merge key of a combined log.
_SESSION = binascii.hexlify(os.urandom(6)).decode()


def session_id() -> str:
    """This process's 12-hex-char telemetry session id."""
    return _SESSION


def make_event(kind: str, fields: dict) -> dict:
    """One wire-format event dict: ``tm`` (monotonic) orders events
    within a process, ``t`` (wall) only roughly across processes."""
    return {"t": round(time.time(), 6), "tm": round(time.monotonic(), 6),
            "pid": os.getpid(), "session": _SESSION, "kind": str(kind),
            **fields}


class EventLog:
    """Append-only structured event sink.  Events are kept in memory
    (``self.events``); with ``path`` each is also written at once as
    one JSON line, by one ``os.write`` to a file opened O_APPEND, so
    two processes' lines never interleave and a crashed run still
    leaves its trail."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.events: list[dict] = []
        self._fd = (os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                            0o644) if path else None)

    def emit(self, kind: str, **fields) -> dict:
        ev = make_event(kind, fields)
        self.events.append(ev)
        if self._fd is not None:
            os.write(self._fd, (json.dumps(ev) + "\n").encode())
        return ev

    def counts(self) -> dict:
        """{kind: occurrences} over everything emitted so far."""
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The sink a run path consults; with none, ``emit`` is a no-op."""

    events: EventLog | None = None

    def emit(self, kind: str, **fields):
        if self.events is not None:
            return self.events.emit(kind, **fields)
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
def use(events: EventLog | None = None, iter_stats=None):
    """Scope a Telemetry handle: every run path entered inside the
    block (the segmented drivers, the serving layer) emits into it.
    ``iter_stats`` (device-side iteration counters) is not ported."""
    if iter_stats is not None:
        from lux_tpu_torch.engine.pull import NotPortedError
        raise NotPortedError("device-side iteration counters "
                             "(telemetry.use(iter_stats=...)) are not "
                             "ported yet (ROADMAP A10)")
    tel = Telemetry(events=events)
    token = _current.set(tel)
    try:
        yield tel
    finally:
        _current.reset(token)
