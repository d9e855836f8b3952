"""Heartbeat supervision on a shared directory (counterpart of
lux_tpu/heartbeat.py, host-only: no tensor is touched here).

Two boards, one discipline: each participant writes its newest beat to
a file of its own with an atomic rename (a reader never sees a torn
beat), and a participant whose newest beat is older than a deadline is
presumed dead.

- :class:`ReplicaBoard` is the serving fleet's (fleet.py): keyed by
  replica NAME, free-form status fields, no barrier.  The dispatcher
  reads beat AGES for its routing score and health gauges; for a
  subprocess replica that was hard-killed, a stale beat is the only
  trace its death leaves besides the exit code.
- :class:`Heartbeat` is one worker's view of a multi-process run:
  ``sync(boundary)`` beats and waits at a segment boundary until every
  peer reached it (or finished), and raises :class:`WorkerLostError`
  (classified TOPOLOGY by resilience.classify) when a peer's beat goes
  stale — before the next segment, so a dead peer costs one deadline,
  not a hang.  ``propose_shrink`` agrees on the survivors' topology
  through the board: the lowest surviving pid writes it, everyone reads
  the same file.  The supervisor's ``heartbeat=`` / ``elastic=``
  options, which drive this across a device mesh, stay refused until
  ROADMAP A6b-2.

Clocks and sleeps are injectable, so detection is tested with a fake
clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable


class WorkerLostError(RuntimeError):
    """One or more peers missed their heartbeat deadline.  Carries
    ``lost`` (process ids) and ``boundary``; resilience.classify treats
    it as TOPOLOGY."""

    def __init__(self, lost, boundary: int, deadline_s: float):
        lost = tuple(int(p) for p in lost)
        super().__init__(
            f"worker(s) {list(lost)} missed the heartbeat deadline "
            f"({deadline_s:g} s) at segment boundary {boundary} — "
            f"presumed dead; survivors must agree on a shrunken "
            f"topology and re-place")
        self.lost = lost
        self.boundary = int(boundary)


def _atomic_json(directory: str, suffix: str, doc: dict, dest: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, dest)


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


@dataclasses.dataclass
class ReplicaBoard:
    """Name-keyed replica heartbeats for the serving fleet: a replica
    whose newest beat is older than ``deadline_s`` is presumed dead."""

    path: str
    deadline_s: float = 3.0
    now: Callable[[], float] = time.time

    def __post_init__(self):
        os.makedirs(self.path, exist_ok=True)

    def _file(self, name: str) -> str:
        return os.path.join(self.path, f"rb_{name}.json")

    def beat(self, name: str, **fields) -> None:
        """Record a replica's sign of life; extra fields (boundary,
        status, kind) ride along for diagnostics."""
        _atomic_json(self.path, ".rb.tmp",
                     {"replica": str(name), "t": self.now(), **fields},
                     self._file(name))

    def read(self, name: str) -> dict | None:
        return _read_json(self._file(name))

    def replicas(self) -> list[str]:
        """Names with a beat on the board, sorted."""
        return sorted(f[3:-5] for f in os.listdir(self.path)
                      if f.startswith("rb_") and f.endswith(".json"))

    def age(self, name: str) -> float | None:
        """Seconds since the replica's newest beat (None before its
        first one: the caller owns the launch grace)."""
        r = self.read(name)
        if r is None or not isinstance(r.get("t"), (int, float)):
            return None
        return max(0.0, self.now() - r["t"])

    def alive(self, name: str) -> bool:
        a = self.age(name)
        return a is not None and a <= self.deadline_s


@dataclasses.dataclass
class Heartbeat:
    """One worker's view of the shared heartbeat board.

    path        shared directory
    pid         this worker's process index (0..nproc-1)
    nproc       workers at launch
    deadline_s  staleness after which a peer is declared dead (the
                reference's default, the longest legitimate silence of
                one segment)
    """

    path: str
    pid: int
    nproc: int
    deadline_s: float = 55.0
    poll_s: float = 0.05
    # a live-but-behind peer triggers ONE straggler event per boundary
    # once it lags this many seconds (default: half the deadline)
    straggler_s: float | None = None
    now: Callable[[], float] = time.time
    sleep: Callable[[float], None] = time.sleep
    _t_start: float = dataclasses.field(default=0.0, init=False)

    def __post_init__(self):
        os.makedirs(self.path, exist_ok=True)
        if self.straggler_s is None:
            self.straggler_s = self.deadline_s / 2
        self._t_start = self.now()

    def _file(self, pid: int) -> str:
        return os.path.join(self.path, f"hb_{pid}.json")

    def beat(self, boundary: int, done: bool = False) -> None:
        """Record that this worker reached ``boundary``."""
        _atomic_json(self.path, ".hb.tmp",
                     {"pid": self.pid, "boundary": int(boundary),
                      "t": self.now(), "done": bool(done)},
                     self._file(self.pid))

    def read(self, pid: int) -> dict | None:
        """A peer's newest beat, or None before its first one."""
        return _read_json(self._file(pid))

    def sync(self, boundary: int) -> None:
        """Beat, then wait for every peer to reach ``boundary`` (or
        finish).  Raises WorkerLostError when a peer's newest beat goes
        stale past ``deadline_s``."""
        from lux_tpu_torch import telemetry

        t_sync = self.now()
        self.beat(boundary)
        warned = False
        while True:
            now = self.now()
            late = {}
            for p in range(self.nproc):
                if p == self.pid:
                    continue
                r = self.read(p)
                if r is not None and (r.get("done")
                                      or r.get("boundary", -1) >= boundary):
                    continue
                # a worker that never beat gets the deadline from our
                # start: its launch is its implicit first beat
                last = r["t"] if r is not None else self._t_start
                late[p] = now - last
            if not late:
                telemetry.current().emit(
                    "heartbeat", boundary=int(boundary),
                    nproc=int(self.nproc), waited_s=round(now - t_sync, 3))
                return
            dead = sorted(p for p, age in late.items()
                          if age > self.deadline_s)
            if dead:
                raise WorkerLostError(dead, boundary, self.deadline_s)
            if not warned and max(late.values()) > self.straggler_s:
                telemetry.current().emit(
                    "straggler", boundary=int(boundary), peers=sorted(late),
                    behind_s=round(max(late.values()), 3))
                warned = True
            self.sleep(self.poll_s)

    def finish(self) -> None:
        """Mark this worker done: peers still syncing must not wait for
        boundaries it will never reach."""
        self.beat(boundary=-1, done=True)

    def survivors(self) -> list[int]:
        """Workers presumed alive (fresh or finished beats, or still in
        their launch grace), always including self."""
        now = self.now()
        out = []
        for p in range(self.nproc):
            if p == self.pid:
                out.append(p)
                continue
            r = self.read(p)
            if r is None:
                if now - self._t_start <= self.deadline_s:
                    out.append(p)
                continue
            if r.get("done") or now - r["t"] <= self.deadline_s:
                out.append(p)
        return out

    def _topo_file(self) -> str:
        return os.path.join(self.path, "topology.json")

    def propose_shrink(self, survivors, generation: int = 1) -> dict:
        """Agree on the degraded topology: the LOWEST surviving pid
        writes the topology file, every survivor polls until a record
        of this ``generation`` appears, and all return the same dict."""
        from lux_tpu_torch import telemetry

        survivors = sorted(int(p) for p in survivors)
        if self.pid == survivors[0]:
            _atomic_json(self.path, ".topo.tmp",
                         {"generation": int(generation),
                          "survivors": survivors, "nproc": len(survivors),
                          "t": self.now()}, self._topo_file())
        t0 = self.now()
        while True:
            topo = _read_json(self._topo_file())
            if topo is not None and topo.get("generation") == generation:
                telemetry.current().emit(
                    "mesh_shrink", protocol="heartbeat",
                    from_nproc=int(self.nproc),
                    to_nproc=len(topo["survivors"]),
                    survivors=topo["survivors"], generation=int(generation))
                return topo
            if self.now() - t0 > self.deadline_s:
                raise WorkerLostError(
                    [p for p in survivors if p != self.pid], -1,
                    self.deadline_s)
            self.sleep(self.poll_s)
