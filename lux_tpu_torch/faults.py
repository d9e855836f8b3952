"""Deterministic fault injection for the resilience layer (counterpart
of the parts of lux_tpu/faults.py that the supervisor uses).

Real failures — a dead worker, a slow segment, a corrupted state or
checkpoint — do not come on demand, so the recovery paths that handle
them would ship untested.  A :class:`FaultPlan` injects synthetic ones
at SEGMENT BOUNDARIES on a deterministic schedule (explicit, or drawn
from a seed):

- CRASH raises :class:`InjectedWorkerCrash` (retryable) before the
  segment's checkpoint save;
- DELAY sleeps ``delay_s``;
- NAN corrupts the state: NaN into the first floating leaf, or, for
  integer labels, the program's identity (a lost update);
- CKPT_BITFLIP / CKPT_TRUNCATE damage the newest checkpoint
  generation, then crash, so the resume must fall back a generation;
- DEVICE_LOSS raises :class:`InjectedDeviceLoss` (a topology fault:
  fatal on one device, where there is no mesh to shrink).

Faults key on a boundary COUNTER, not on iteration numbers: after a
crash and resume the counter has moved past the fired fault, so a
schedule never re-fires and every supervised run ends.

State corruption pokes the state's own tensors IN PLACE (on the card,
no copy through the host) and returns the state, which the supervisor
continues with (the reference returns a corrupted host copy).

Live graphs (livegraph.py) have their own counters in a
:class:`MutationFaultPlan`: MUT_CRASH, WAL_TORN and the op-asserting
MUT_DELETE / MUT_REWEIGHT at a mutation index, COMPACT_CRASH at a
compaction, RESEED_CRASH at a re-seed; ``tear_wal`` damages a log at
rest.

The serving fleet (fleet.py) has its own: a :class:`ReplicaKillPlan`
maps a replica NAME to the boundary at which it dies, counted over all
of that replica's runners.  Its actions: WORKER_KILL
(:class:`InjectedWorkerKill`, or with ``hard_kill`` a real
``os._exit(HARD_KILL_CODE)`` in a subprocess replica), DEVICE_LOSS,
FLEET_CRASH (the whole fleet: :class:`InjectedFleetCrash`, a
BaseException) and REPLICA_FLAP (the one action that fires again, at
every later boundary, until quarantine stops it).  Not ported yet:
``FaultPlan``'s own WORKER_KILL, a worker process of a device mesh
dying (NotPortedError naming ROADMAP A6b-2).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lux_tpu_torch.debug import leaves

CRASH = "crash"
DELAY = "delay"
NAN = "nan"
CKPT_BITFLIP = "ckpt_bitflip"
CKPT_TRUNCATE = "ckpt_truncate"
DEVICE_LOSS = "device_loss"
WORKER_KILL = "worker_kill"

# live graphs (livegraph.py): the mutation-scoped actions
MUT_CRASH = "mut_crash"          # die before the WAL record lands
WAL_TORN = "wal_torn"            # die mid-append: a record prefix lands
COMPACT_CRASH = "compact_crash"  # die between COMPACT_START and the swap
MUT_DELETE = "mut_delete"        # MUT_CRASH that asserts a deletion
MUT_REWEIGHT = "mut_reweight"    # MUT_CRASH that asserts a reweight
RESEED_CRASH = "reseed_crash"    # die between the cone and the converge

# the serving fleet's whole-fleet and flapping-replica drills
FLEET_CRASH = "fleet_crash"      # the whole fleet dies, coordinator too
REPLICA_FLAP = "replica_flap"    # the same replica dies at every boundary

# the exit code of a hard kill: nonzero and outside the shell's and the
# signals' ranges
HARD_KILL_CODE = 113


class InjectedWorkerCrash(RuntimeError):
    """Synthetic transient worker death; resilience.classify treats it
    as retryable."""


class InjectedDeviceLoss(RuntimeError):
    """Synthetic topology fault: named devices became unavailable.
    Carries ``lost_devices``; resilience.classify treats it as
    TOPOLOGY."""

    def __init__(self, msg: str, lost_devices=()):
        super().__init__(msg)
        self.lost_devices = tuple(int(d) for d in lost_devices)


class InjectedWorkerKill(RuntimeError):
    """Synthetic topology fault: a whole worker (a serving replica)
    died, taking its devices with it; the message mimics the
    coordination-service heartbeat signature real deaths surface as.
    Carries ``lost_devices``; resilience.classify treats it as
    TOPOLOGY."""

    def __init__(self, msg: str, lost_devices=()):
        super().__init__(msg)
        self.lost_devices = tuple(int(d) for d in lost_devices)


class InjectedFleetCrash(BaseException):
    """Synthetic whole-fleet death: the coordinator and every replica
    at once.  Nothing survives to fail over to, so it subclasses
    BaseException: no ``except Exception`` in the dispatcher may swallow
    it.  The only continuation is ``FleetServer.recover`` over the
    durable journals.  Carries ``replica``, where it fired."""

    def __init__(self, msg: str, replica: str = ""):
        super().__init__(msg)
        self.replica = replica


@dataclasses.dataclass
class FaultPlan:
    """A deterministic boundary-counter -> action schedule
    (lux_tpu/faults.py:163-283).  ``fire(state)`` is called by the
    supervisor at every segment boundary and returns None (no change)
    or the corrupted state; ``fired`` records what happened."""

    schedule: dict
    delay_s: float = 0.0
    nan_count: int = 1
    # sentinel poked into integer-labelled states by a NAN action when
    # the caller passes none
    int_value: int | None = None
    # devices a DEVICE_LOSS takes: explicit ids, or the last N of the
    # caller's device ids
    lose: int | tuple = 1
    boundaries: int = dataclasses.field(default=0, init=False)
    fired: list = dataclasses.field(default_factory=list, init=False)
    ckpt_path: str | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        known = (CRASH, DELAY, NAN, CKPT_BITFLIP, CKPT_TRUNCATE,
                 DEVICE_LOSS)
        for i, a in self.schedule.items():
            if a == WORKER_KILL:
                from lux_tpu_torch.engine.pull import NotPortedError
                raise NotPortedError("the WORKER_KILL fault (a whole "
                                     "worker process dying) is not "
                                     "ported yet (ROADMAP A6b-2)")
            if a not in known:
                raise ValueError(f"schedule[{i}]: unknown fault action "
                                 f"{a!r}")

    @classmethod
    def seeded(cls, seed: int, n: int = 16, p_crash: float = 0.25,
               p_delay: float = 0.0, p_nan: float = 0.0,
               delay_s: float = 0.0, nan_count: int = 1) -> "FaultPlan":
        """A schedule over the first ``n`` boundaries drawn from a seed
        — the reference's draw, so the same seed gives the same
        schedule in both packages."""
        rng = np.random.default_rng(seed)
        schedule = {}
        for i in range(n):
            r = float(rng.random())
            if r < p_crash:
                schedule[i] = CRASH
            elif r < p_crash + p_delay:
                schedule[i] = DELAY
            elif r < p_crash + p_delay + p_nan:
                schedule[i] = NAN
        return cls(schedule=schedule, delay_s=delay_s,
                   nan_count=nan_count)

    def bind_checkpoint(self, path: str) -> None:
        """Point the CKPT_* actions at a run's checkpoint file (the
        supervisor calls this with its checkpoint path)."""
        self.ckpt_path = path

    def _lost_ids(self, device_ids) -> tuple:
        if isinstance(self.lose, (tuple, list)):
            return tuple(int(d) for d in self.lose)
        ids = tuple(int(d) for d in (device_ids or ()))
        n = max(0, int(self.lose))
        return ids[max(0, len(ids) - n):] if n and ids else ()

    def fire(self, state, int_value: int | None = None,
             device_ids=None):
        import os

        i = self.boundaries
        self.boundaries += 1
        action = self.schedule.get(i)
        if action is None:
            return None
        self.fired.append((i, action))
        if action == CRASH:
            raise InjectedWorkerCrash(
                f"injected worker crash at segment boundary {i}")
        if action == DELAY:
            time.sleep(self.delay_s)
            return None
        if action == NAN:
            return corrupt_state(
                state, self.nan_count,
                int_value if int_value is not None else self.int_value)
        if action == DEVICE_LOSS:
            lost = self._lost_ids(device_ids)
            raise InjectedDeviceLoss(
                f"injected device loss at segment boundary {i}: "
                f"devices {list(lost)} unavailable", lost)
        # CKPT_BITFLIP / CKPT_TRUNCATE: the newest generation is damaged
        # AND the worker dies; the retry's resume must detect it
        if self.ckpt_path and os.path.exists(self.ckpt_path):
            if action == CKPT_BITFLIP:
                bitflip_checkpoint(self.ckpt_path)
            else:
                truncate_checkpoint(self.ckpt_path)
        raise InjectedWorkerCrash(
            f"injected worker crash after {action} at segment boundary "
            f"{i}")


def _kind(leaf) -> str:
    """'float', 'int' or 'other' (bool and the rest) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype.is_floating_point:
            return "float"
        return "other" if (leaf.dtype == torch.bool
                           or leaf.dtype.is_complex) else "int"
    dt = np.asarray(leaf).dtype
    if np.issubdtype(dt, np.floating):
        return "float"
    return "int" if np.issubdtype(dt, np.integer) else "other"


def _poke(state, count: int, kind: str, value) -> bool:
    """Write ``value`` into the first ``count`` cells of the first
    non-empty leaf of ``kind`` in ``state``, in place (tensors on their
    device; arrays must be contiguous).  False if there is none."""
    for leaf in leaves(state):
        if _kind(leaf) != kind:
            continue
        flat = leaf.view(-1) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf).reshape(-1)
        if flat.shape[0]:
            flat[:count] = value
            return True
    return False


def nan_corrupt(state, count: int = 1):
    """NaN into the first ``count`` cells of the first floating leaf of
    ``state`` (a tensor, an array, or a tuple / list of them), in
    place; returns ``state`` (what a corrupted segment output looks like
    to debug.check_finite and the health watchdog)."""
    if not _poke(state, count, "float", float("nan")):
        raise ValueError(
            "no floating leaf to NaN-corrupt (integer-labeled "
            "programs: use int_corrupt / corrupt_state with the "
            "program's identity sentinel)")
    return state


def int_corrupt(state, count: int = 1, value: int | None = None):
    """``value`` (the program's identity / sentinel: a lost update, not
    out-of-band garbage a max-program would propagate) into the first
    ``count`` cells of the first integer leaf, in place; returns
    ``state``."""
    if value is None:
        raise ValueError(
            "int_corrupt needs the program's identity/sentinel value "
            "(e.g. sssp.HOP_INF, components' -1)")
    if not _poke(state, count, "int", int(value)):
        raise ValueError("no integer leaf to corrupt")
    return state


def corrupt_state(state, count: int = 1, int_value: int | None = None):
    """Type-appropriate corruption: NaN into the first float leaf when
    one exists, else ``int_value`` into the first integer leaf."""
    if any(_kind(x) == "float" for x in leaves(state)):
        return nan_corrupt(state, count)
    return int_corrupt(state, count, int_value)


@dataclasses.dataclass
class ReplicaKillPlan:
    """Replica-scoped kill schedule for the serving fleet
    (lux_tpu/faults.py:285-400): ``schedule`` maps a replica NAME to its
    segment-boundary index at which it dies.  The fleet's boundary hook
    calls ``fire(name)`` at every boundary of every runner the replica
    owns (one counter per replica, all kinds), so the kill lands
    mid-drain with queries resident in columns.

    ``action`` is WORKER_KILL (InjectedWorkerKill, or with
    ``hard_kill`` a real ``os._exit(HARD_KILL_CODE)``: a subprocess
    replica's death that only its exit code and the board's stale beat
    show), DEVICE_LOSS, FLEET_CRASH (InjectedFleetCrash, or with
    ``hard_kill`` a real exit) or REPLICA_FLAP, which fires at EVERY
    boundary from the scheduled index on (at most ``flap_count`` times,
    None: until quarantine stops the replica's boundaries).  Every other
    entry fires once.  ``fired`` records (replica, boundary, action).
    Arm a schedule on ``FleetServer.routing_target``: routing is a
    positive-feedback loop, so a fixed replica is a coin flip."""

    schedule: dict
    action: str = WORKER_KILL
    hard_kill: bool = False
    flap_count: int | None = None
    boundaries: dict = dataclasses.field(default_factory=dict, init=False)
    fired: list = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self):
        if self.action not in (WORKER_KILL, DEVICE_LOSS, FLEET_CRASH,
                               REPLICA_FLAP):
            raise ValueError(
                f"ReplicaKillPlan action must be WORKER_KILL, DEVICE_LOSS, "
                f"FLEET_CRASH, or REPLICA_FLAP, got {self.action!r}")

    def fire(self, replica: str) -> None:
        import os

        i = int(self.boundaries.get(replica, 0))
        self.boundaries[replica] = i + 1
        due = self.schedule.get(replica)
        if due is None:
            return
        if self.action == REPLICA_FLAP:
            if i < int(due):
                return
            shots = sum(1 for r, _, _ in self.fired if r == replica)
            if self.flap_count is not None and shots >= self.flap_count:
                return
            self.fired.append((replica, i, self.action))
            raise InjectedWorkerKill(
                f"injected replica flap on serving replica {replica!r} at "
                f"its boundary {i} (death {shots + 1}): coordination "
                f"service heartbeat to the replica timed out", ())
        if i != int(due):
            return
        self.fired.append((replica, i, self.action))
        if self.action == FLEET_CRASH:
            if self.hard_kill:
                os._exit(HARD_KILL_CODE)
            raise InjectedFleetCrash(
                f"injected fleet crash at replica {replica!r} boundary "
                f"{i}: coordinator and all replicas died — recover from "
                f"the admission journal + mutation WAL", replica)
        if self.action == DEVICE_LOSS:
            raise InjectedDeviceLoss(
                f"injected device loss on serving replica {replica!r} at "
                f"its boundary {i}: devices unavailable", ())
        if self.hard_kill:
            # a real death mid-drain: no exception, no cleanup
            os._exit(HARD_KILL_CODE)
        raise InjectedWorkerKill(
            f"injected worker death on serving replica {replica!r} at its "
            f"boundary {i}: coordination service heartbeat to the replica "
            f"timed out", ())


@dataclasses.dataclass
class MutationFaultPlan:
    """The live graph's fault schedule (lux_tpu/faults.py:393-505),
    three deterministic counters: ``schedule`` maps a mutation index to
    MUT_CRASH (nothing reaches the WAL), WAL_TORN (a strict prefix of
    the record reaches it) or MUT_DELETE / MUT_REWEIGHT (MUT_CRASH, but
    the firing mutation's op must match: ValueError otherwise);
    ``compact_schedule`` a compaction index to COMPACT_CRASH;
    ``reseed_schedule`` a re-seed index to RESEED_CRASH.  Each fires as
    InjectedWorkerCrash, once (the counters move past it); ``fired``
    records what fired."""

    schedule: dict = dataclasses.field(default_factory=dict)
    compact_schedule: dict = dataclasses.field(default_factory=dict)
    reseed_schedule: dict = dataclasses.field(default_factory=dict)
    mutations: int = dataclasses.field(default=0, init=False)
    compactions: int = dataclasses.field(default=0, init=False)
    reseeds: int = dataclasses.field(default=0, init=False)
    fired: list = dataclasses.field(default_factory=list, init=False)

    _OP_BY_ACTION = {MUT_DELETE: "delete", MUT_REWEIGHT: "reweight"}

    def __post_init__(self):
        for i, a in self.schedule.items():
            if a not in (MUT_CRASH, WAL_TORN, MUT_DELETE, MUT_REWEIGHT):
                raise ValueError(
                    f"MutationFaultPlan schedule[{i}] must be MUT_CRASH, "
                    f"WAL_TORN, MUT_DELETE, or MUT_REWEIGHT, got {a!r}")
        for i, a in self.compact_schedule.items():
            if a != COMPACT_CRASH:
                raise ValueError(f"MutationFaultPlan compact_schedule[{i}] "
                                 f"must be COMPACT_CRASH, got {a!r}")
        for i, a in self.reseed_schedule.items():
            if a != RESEED_CRASH:
                raise ValueError(f"MutationFaultPlan reseed_schedule[{i}] "
                                 f"must be RESEED_CRASH, got {a!r}")

    def fire_append(self, wal, record: bytes, op: str = "append") -> None:
        """Called by LiveGraph._publish before the record is written
        (``wal`` None: nothing to tear, the crash still fires)."""
        i = self.mutations
        self.mutations += 1
        action = self.schedule.get(i)
        if action is None:
            return
        want = self._OP_BY_ACTION.get(action)
        if want is not None and op != want:
            raise ValueError(
                f"MutationFaultPlan schedule[{i}] = {action} expects a "
                f"{want!r} mutation at index {i}, but a {op!r} fired — "
                f"the drill's mutation stream is not the one the plan "
                f"was written against")
        self.fired.append((i, action))
        if action == WAL_TORN and wal is not None:
            wal.write_torn(record)
        how = ("mid-append (torn WAL write)" if action == WAL_TORN
               else "before the WAL record landed")
        raise InjectedWorkerCrash(f"injected {action} at mutation {i} "
                                  f"(op={op}): worker died {how}")

    def fire_compact(self) -> None:
        """Called by LiveGraph.compact between COMPACT_START and the
        generation swap."""
        i = self.compactions
        self.compactions += 1
        if self.compact_schedule.get(i) != COMPACT_CRASH:
            return
        self.fired.append((i, COMPACT_CRASH))
        raise InjectedWorkerCrash(
            f"injected compact_crash at compaction {i}: worker died after "
            f"COMPACT_START, before the generation swap")

    def fire_reseed(self) -> None:
        """Called by LiveGraph._revalidate_anti between the cone and the
        converge."""
        i = self.reseeds
        self.reseeds += 1
        if self.reseed_schedule.get(i) != RESEED_CRASH:
            return
        self.fired.append((i, RESEED_CRASH))
        raise InjectedWorkerCrash(
            f"injected reseed_crash at re-seed {i}: worker died after the "
            f"affected-cone computation, before the re-converge")


def tear_wal(path: str, keep_bytes: int = 7) -> None:
    """Append ``keep_bytes`` of a garbage partial record to a mutation
    log at rest (what a power loss mid-append leaves), clamped below
    the record size: a whole garbage record would read as hard
    crc_chain corruption, not a torn tail."""
    from lux_tpu_torch import format as luxfmt
    with open(path, "ab") as f:
        f.write(b"\x7f" * min(max(1, int(keep_bytes)),
                               luxfmt.WAL_RECORD_SIZE - 1))


# -- checkpoint-file injectors -------------------------------------------

def bitflip_checkpoint(path: str, leaf: int = 0, bit: int = 0) -> None:
    """Flip one bit in ``leaf``'s payload INSIDE the npz container,
    rewriting the zip so its own member CRC stays consistent — the
    well-formed corruption only checkpoint.py's per-leaf CRC32 catches.
    The flipped bit is in the last payload byte, past the .npy
    header."""
    import io
    import zipfile

    name = f"leaf_{leaf}.npy"
    with zipfile.ZipFile(path, "r") as z:
        items = [(zi.filename, z.read(zi.filename)) for zi in z.infolist()]
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        for fname, data in items:
            if fname == name:
                data = bytearray(data)
                data[-1] ^= (1 << (bit & 7))
                data = bytes(data)
            z.writestr(fname, data)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def truncate_checkpoint(path: str, keep: float = 0.5) -> None:
    """Truncate the file to ``keep`` of its size — the torn-write
    corruption (an unreadable container)."""
    import os

    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep)))
