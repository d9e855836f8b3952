"""The serving fleet: replicated runners, admission control, heartbeat
failover, brownout shedding, self-healing and whole-fleet crash
recovery (counterpart of lux_tpu/fleet.py).

- **Replicas**: a :class:`FleetServer` owns N replicas, each a full
  per-kind runner set (serve.PushBatchRunner / PullBatchRunner) on the
  fleet's device, in-process by default; ``add_subprocess_replica``
  adds one in its own OS process (a whole serve.Server fed through a
  spool directory, ``python -m lux_tpu_torch.fleet -worker spec.json``:
  a fresh interpreter with its own CUDA context, never a fork of a
  parent that has initialised CUDA), whose liveness shows only through
  its exit code and the shared heartbeat.ReplicaBoard.  Every replica
  beats the board at each segment boundary (the runners'
  ``on_boundary`` hook); ``replica_up`` / ``replica_lost`` events trail
  the membership.

- **Admission** (``submit``): a typed :class:`AdmissionError` sheds, in
  check order: ``no_capacity`` (no healthy replica), ``brownout``
  (capacity lost and the priority below ``brownout_min_priority``),
  ``quota`` (the tenant's in-flight and queued count at its cap),
  ``queue_full``, ``deadline`` (queue ahead x mean observed service
  time / surviving column capacity past the query's deadline) and
  ``memory`` (the routing target's byte ledger plus B more columns past
  ``mem_budget_bytes``: memwatch.replica_ledger).  Admitted queries
  queue in a deadline-priority serve.PriorityCollector and route to the
  healthiest replica: min (beat age + BURN_WEIGHT x SLO burn, load).
  Every shed leaves a ``query_shed`` event and a ``shed_records`` entry;
  resilience.classify treats AdmissionError as FATAL.

- **Failover**, exactly once: a replica death mid-drain
  (heartbeat.WorkerLostError, faults.InjectedWorkerKill /
  InjectedDeviceLoss from a faults.ReplicaKillPlan, a subprocess exit,
  or a beat older than ``replica_deadline_s``) marks it lost and
  re-dispatches its unretired queries to survivors, each after a
  resilience.RetryPolicy backoff, with a ``failover`` event.  The
  front end retires each qid once (``_retired``), and the engines are
  deterministic, so a failed-over integer answer is bit-equal to a
  fault-free one.

- **Brownout**: one level per replica not serving; while above 0,
  admission requires ``priority >= brownout_min_priority`` (default 0:
  which tenants are sacrificial is an operator's policy).

- **Self-healing**: the durable admission journal (``journal_path=``,
  journal.py) makes every admit durable before it queues and every
  retirement at the exactly-once gate, so :meth:`FleetServer.recover`
  restarts a crashed fleet and re-dispatches each admitted-unretired
  query at its original admission epoch (the only recovery sheds are
  the typed ``reset_unavailable`` / ``epoch_folded``).  Recovery order:
  WAL replay, then generation adoption, then journal re-dispatch.
  ``heal=True`` respawns lost in-process replicas under
  ``respawn_retry`` backoff; ``flap_threshold`` deaths of one name
  within ``flap_window_s`` (resilience.FlapDetector) quarantine it
  instead, and routing re-entry waits for an oracle-checked canary
  query.  ``mttr_s`` is first loss to a whole pool.

- **Live graphs** (``live=``): one livegraph.LiveGraph shared by the
  in-process replicas, each query pinned at its admission epoch across
  failover; ``mutate`` sheds a full delta block as a typed
  ``delta_full``.  Subprocess replicas serve the static graph spec, so a
  live fleet refuses them.

``device`` (None means the card, as everywhere in the port) goes to
every runner and to a subprocess replica's spec; so does ``exchange``
("owner" runs every replica's engines on the owner exchange).  Refused
until ROADMAP A6b-2: ``mesh=``.

Smoke: ``python -m lux_tpu_torch.fleet [-device cpu]`` drains an
oversubscribed mixed load across 2 replicas with one killed mid-drain
and checks every answer against its numpy oracle.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from lux_tpu_torch import faults as faults_mod
from lux_tpu_torch import heartbeat as heartbeat_mod
from lux_tpu_torch import journal as journal_mod
from lux_tpu_torch import resilience
from lux_tpu_torch import serve as serve_mod
from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.engine.pull import NotPortedError
from lux_tpu_torch.serve import (KINDS, DEFAULT_SEG_ITERS, PriorityCollector,
                                 PullBatchRunner, PushBatchRunner, Request,
                                 Response, _emit)

# shed reasons (AdmissionError.reason / query_shed events), in the order
# admission checks them
SHED_NO_CAPACITY = "no_capacity"
SHED_BROWNOUT = "brownout"
SHED_QUOTA = "quota"
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"
SHED_RETRIES = "retries"
# the ingest path's backpressure: the live graph's delta blocks are full
SHED_DELTA_FULL = "delta_full"
# admitting B more columns would take the routing target past its budget
SHED_MEMORY = "memory"
# recovery only: a journalled reset query whose vector the caller did
# not supply again, and an admission epoch the recovered generation
# already folded away
SHED_RESET_UNAVAILABLE = "reset_unavailable"
SHED_EPOCH_FOLDED = "epoch_folded"

# routing score: beat age (s) + BURN_WEIGHT x the replica's rolling SLO
# burn fraction
BURN_WEIGHT = 5.0

# the parent's poll cadence while only subprocess answers are due
REMOTE_POLL_S = 0.01
# a subprocess replica may hold this many x batch requests before
# routing passes it over
REMOTE_QUEUE_FACTOR = 2


class AdmissionError(RuntimeError):
    """Typed shed: the fleet rejected a query instead of admitting it.
    Carries qid / kind / tenant / reason (a SHED_* constant) and the
    projection that shed it.  resilience.classify treats it as FATAL."""

    def __init__(self, qid: int, kind: str, tenant: str, reason: str,
                 projected_wait_s: float | None = None,
                 deadline_s: float | None = None,
                 projected_bytes: int | None = None,
                 budget_bytes: int | None = None):
        msg = f"query {qid} [{kind}] from tenant {tenant!r} shed: {reason}"
        if projected_wait_s is not None:
            msg += (f" (projected wait {projected_wait_s:.3f}s vs "
                    f"deadline {deadline_s}s)")
        if projected_bytes is not None:
            msg += (f" (projected {projected_bytes} bytes vs budget "
                    f"{budget_bytes} bytes)")
        super().__init__(msg)
        self.qid = int(qid)
        self.kind = kind
        self.tenant = tenant
        self.reason = reason
        self.projected_wait_s = projected_wait_s
        self.deadline_s = deadline_s
        self.projected_bytes = projected_bytes
        self.budget_bytes = budget_bytes


class _InProcessReplica:
    """One in-process runner set (one batched engine per kind, built at
    its first query) and its health state."""

    remote = False

    def __init__(self, fleet: "FleetServer", name: str, index: int):
        self.fleet = fleet
        self.name = name
        self.index = int(index)
        self.state = "up"
        self.error: BaseException | None = None
        self._runners: dict = {}
        self._collectors: dict = {}

    def runner(self, kind: str):
        if kind not in self._runners:
            r = self.fleet._build_runner(kind)
            r.replica = self.name
            r.on_boundary = lambda runner, rep=self: \
                self.fleet._boundary(rep, runner)
            self._runners[kind] = r
        return self._runners[kind]

    def collector(self, kind: str) -> PriorityCollector:
        if kind not in self._collectors:
            self._collectors[kind] = PriorityCollector(
                metrics=self.fleet.metrics, kind=kind, replica=self.name)
        return self._collectors[kind]

    def pending(self, kind: str) -> int:
        n = len(self._collectors[kind]) if kind in self._collectors else 0
        if kind in self._runners:
            n += sum(1 for s in self._runners[kind].slots if s is not None)
        return n

    def pending_total(self) -> int:
        kinds = set(self._collectors) | set(self._runners)
        return sum(self.pending(k) for k in kinds)

    def slo_burn(self) -> float:
        """Mean rolling SLO-burn fraction over the runners (0.0 before
        any SLO accounting)."""
        fracs = [sum(r._slo_window) / len(r._slo_window)
                 for r in self._runners.values() if r._slo_window]
        return sum(fracs) / len(fracs) if fracs else 0.0


class _SubprocessReplica:
    """A replica in its own OS process, fed through a spool directory.
    Liveness comes from the board and the exit code; answers arrive as
    npy + json file pairs, the json written last."""

    remote = True

    def __init__(self, fleet: "FleetServer", name: str, index: int,
                 spool: str, proc, batch: int, log: str | None = None):
        self.fleet = fleet
        self.name = name
        self.index = int(index)
        self.state = "up"
        self.error: BaseException | None = None
        self.spool = spool
        self.inbox = os.path.join(spool, f"inbox_{name}")
        self.outdir = os.path.join(spool, f"out_{name}")
        self.proc = proc
        self.log = log
        self.batch = int(batch)
        self.inflight: dict[int, Request] = {}

    def free(self) -> int:
        return REMOTE_QUEUE_FACTOR * self.batch - len(self.inflight)

    def pending(self, kind: str) -> int:
        return sum(1 for r in self.inflight.values() if r.kind == kind)

    def pending_total(self) -> int:
        return len(self.inflight)

    def slo_burn(self) -> float:
        return 0.0          # the worker's burn is not exported

    def dispatch(self, req: Request) -> None:
        doc = {"qid": req.qid, "kind": req.kind, "source": req.source}
        if req.reset is not None:
            # a reset vector rides an npy sidecar written BEFORE the
            # request json (the json's presence marks a complete pair)
            fd, tmp = tempfile.mkstemp(dir=self.spool, suffix=".rst.tmp")
            with os.fdopen(fd, "wb") as f:
                # lockcheck: allow(durable-before-visible) same-host
                # IPC spool, not a durability record: a torn/lost
                # reset is re-dispatched from the admission journal
                np.save(f, np.asarray(req.reset, np.float32))
            os.replace(tmp, os.path.join(self.inbox,
                                         f"q{req.qid:08d}.reset.npy"))
            doc["reset"] = True
        fd, tmp = tempfile.mkstemp(dir=self.spool, suffix=".req.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(self.inbox, f"q{req.qid:08d}.json"))
        self.inflight[req.qid] = req

    def stop(self) -> None:
        try:
            with open(os.path.join(self.spool, "stop"), "w") as f:
                f.write("stop\n")
        except OSError:
            pass
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class FleetServer:
    """The serving tier above serve.Server: route queries by kind across
    a pool of replicas with admission control, heartbeat-supervised
    failover, brownout shedding and self-healing (module docstring).
    Duck-type compatible with serve.Server for a load generator: ``g``,
    ``submit``, ``run``, ``set_metrics``, ``emit_metrics_snapshot``,
    ``_collectors``."""

    def __init__(self, g, *, replicas: int = 2, batch: int = 4,
                 num_parts: int = 1, device=None, mesh=None,
                 exchange: str = "auto", health: bool = False,
                 weighted: bool = False,
                 seg_iters: int = DEFAULT_SEG_ITERS, tol: float = 1e-8,
                 slo_ms: dict | None = None, metrics=None,
                 snapshot_every_s: float = 1.0,
                 board_path: str | None = None,
                 max_queue: int = 256, quota: dict | None = None,
                 brownout_min_priority: int = 0,
                 retry: resilience.RetryPolicy | None = None,
                 fault: faults_mod.ReplicaKillPlan | None = None,
                 replica_deadline_s: float = 3.0, live=None,
                 cache=False, mem_budget_bytes: int | None = None,
                 mem_horizon_s: float = 5.0, mem_clock=time.monotonic,
                 journal_path: str | None = None, heal: bool = False,
                 respawn_retry: resilience.RetryPolicy | None = None,
                 flap_threshold: int = 3, flap_window_s: float = 60.0,
                 heal_clock=time.monotonic):
        if mesh is not None:
            raise NotPortedError("FleetServer(mesh=...) is not ported yet "
                                 "(ROADMAP A6b-2); the port's replicas serve "
                                 "one device each")
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        self.device = resolve_device(device)
        self.g = g
        # one LiveGraph shared by every in-process replica: its published
        # delta blocks are immutable, so a failed-over query re-runs on
        # the survivor at its original admission epoch
        self.live = live
        if live is not None and g is not live.base:
            raise ValueError("FleetServer(live=...) requires g to be "
                             "live.base")
        if cache is True:
            self.cache = serve_mod.AnswerCache.from_slo(slo_ms)
        else:
            self.cache = cache or None
        self.batch = int(batch)
        self.opts = dict(num_parts=num_parts, exchange=exchange,
                         health=health, device=self.device)
        self.weighted = bool(weighted)
        self.seg_iters = int(seg_iters)
        self.tol = float(tol)
        self.slo_ms = dict(slo_ms or {})
        for k in self.slo_ms:
            if k not in KINDS:
                raise ValueError(f"slo_ms names unknown kind {k!r}; "
                                 f"choose from {KINDS}")
        if metrics is False:
            self.metrics = None
        elif metrics is None:
            from lux_tpu_torch import metrics as metrics_mod
            self.metrics = metrics_mod.Registry()
        else:
            self.metrics = metrics
        self.snapshot_every_s = float(snapshot_every_s)
        self._last_snapshot = 0.0
        self.board = heartbeat_mod.ReplicaBoard(
            board_path or tempfile.mkdtemp(prefix="lux_fleet_board_"),
            deadline_s=float(replica_deadline_s))
        self.replica_deadline_s = float(replica_deadline_s)
        self.max_queue = int(max_queue)
        self.quota = dict(quota or {})
        self.brownout_min_priority = int(brownout_min_priority)
        self.retry = retry or resilience.RetryPolicy(
            retries=3, backoff_s=0.02, max_backoff_s=0.5)
        self.fault = fault
        # the per-replica byte budget (None: no memory admission) and
        # the boundary-fed occupancy trails, built at first use
        self.mem_budget_bytes = (None if mem_budget_bytes is None
                                 else int(mem_budget_bytes))
        self.mem_horizon_s = float(mem_horizon_s)
        self.mem_clock = mem_clock
        self._mem_trails: dict = {}
        # admission (submitter threads) and retirement (the drain
        # thread) share the tenant and qid maps
        self._lock = threading.RLock()
        # every kind's queue exists from the start, so the run loop can
        # iterate them while submitters insert
        self._queues: dict[str, PriorityCollector] = {
            k: PriorityCollector(metrics=None, kind=k) for k in KINDS}
        self._replicas: list = []
        self._next_qid = 0
        self._qreq: dict[int, Request] = {}
        self._retired: set[int] = set()
        self._attempts: dict[int, int] = {}
        self._tenant_load: dict[str, int] = {}
        self.failovers = 0
        self.dup_dropped = 0
        self.shed_records: list[AdmissionError] = []
        self._brownout = 0
        # self-healing: the journal, the respawn supervisor, flap
        # detection and the canary gate
        self.journal = (None if journal_path is None else
                        journal_mod.AdmissionJournal(journal_path, nv=g.nv))
        self._journaled: set[int] = set()
        self.heal = bool(heal)
        self.respawn_retry = respawn_retry or self.retry
        self.heal_clock = heal_clock
        self.flap = resilience.FlapDetector(
            threshold=int(flap_threshold), window_s=float(flap_window_s),
            clock=heal_clock)
        self.respawns = 0
        self.quarantines = 0
        self.journal_replayed = 0
        self.mttr_s: float | None = None
        self._respawn_at: dict[str, float] = {}
        self._respawn_attempts: dict[str, int] = {}
        self._canaries: set[int] = set()
        self._t_degraded: float | None = None
        for _ in range(int(replicas)):
            self._add_inproc_replica()

    # -- replica pool --------------------------------------------------

    @property
    def replica_names(self) -> list[str]:
        return [r.name for r in self._replicas]

    def _add_inproc_replica(self):
        name = f"r{len(self._replicas)}"
        rep = _InProcessReplica(self, name, len(self._replicas))
        self._replicas.append(rep)
        self.board.beat(name, status="up", boundary=0)
        _emit("replica_up", replica=name, remote=False, capacity=self.batch)
        self._health_gauges()
        return rep

    def add_subprocess_replica(self, graph_spec: dict, *,
                               workdir: str | None = None,
                               num_parts: int = 1,
                               kill_boundary: int | None = None,
                               spawn_budget_s: float = 60.0):
        """Spawn a subprocess replica: start the worker (a fresh
        interpreter on the fleet's device), wait up to
        ``spawn_budget_s`` for its first beat, and return the replica,
        or None when no worker beat in budget.  ``graph_spec`` must
        rebuild the graph the parent serves (``_graph_from_spec``);
        ``kill_boundary`` arms a hard-kill ReplicaKillPlan inside the
        worker.  The worker's output goes to ``worker_<name>.log`` in
        the spool directory."""
        import subprocess

        if self.live is not None:
            raise ValueError(
                "subprocess replicas serve the static graph spec and "
                "cannot answer at a live admission epoch — a live-graph "
                "fleet is in-process only")
        name = f"r{len(self._replicas)}"
        spool = workdir or tempfile.mkdtemp(prefix="lux_fleet_")
        os.makedirs(os.path.join(spool, f"inbox_{name}"), exist_ok=True)
        os.makedirs(os.path.join(spool, f"out_{name}"), exist_ok=True)
        spec = {"name": name, "dir": spool, "board": self.board.path,
                "graph": dict(graph_spec), "batch": self.batch,
                "num_parts": int(num_parts), "seg_iters": self.seg_iters,
                "tol": self.tol, "weighted": self.weighted,
                "device": str(self.device), "kill_boundary": kill_boundary,
                "exchange": self.opts["exchange"]}
        spec_path = os.path.join(spool, f"spec_{name}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        log = os.path.join(spool, f"worker_{name}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "lux_tpu_torch.fleet", "-worker",
                 spec_path], env=_worker_env(), stdout=out,
                stderr=subprocess.STDOUT)
        t0 = time.monotonic()
        ok = False
        while time.monotonic() - t0 < float(spawn_budget_s):
            if self.board.read(name) is not None:
                ok = True
                break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        if not ok:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            return None
        rep = _SubprocessReplica(self, name, len(self._replicas), spool,
                                 proc, self.batch, log=log)
        self._replicas.append(rep)
        _emit("replica_up", replica=name, remote=True, capacity=self.batch)
        self._health_gauges()
        return rep

    def _build_runner(self, kind: str):
        mkw = dict(metrics=self.metrics, slo_ms=self.slo_ms.get(kind),
                   live=self.live, cache=self.cache,
                   seg_iters=self.seg_iters, **self.opts)
        if kind == "pagerank":
            return PullBatchRunner(kind, self.g, self.batch, tol=self.tol,
                                   **mkw)
        return PushBatchRunner(kind, self.g, self.batch,
                               weighted=self.weighted, **mkw)

    def _boundary(self, rep, runner) -> None:
        """A replica's segment-boundary hook: beat the board, sample the
        memory trail (budgeted fleets), then fire the kill plan (whose
        raise leaves the drain as a mid-drain death)."""
        self.board.beat(rep.name, status="up", kind=runner.kind)
        if self.mem_budget_bytes is not None:
            self.mem_trail(rep.name).sample(where=f"{runner.kind}:boundary")
        if self.fault is not None:
            self.fault.fire(rep.name)

    def mem_trail(self, name: str):
        """The named replica's boundary-fed memwatch.MemoryTrail (built
        at first use, with the budget and forecaster when the fleet has
        ``mem_budget_bytes``).  On the card it samples the allocator; on
        the CPU its bytes are the replica's ledger."""
        from lux_tpu_torch import memwatch

        if name not in self._mem_trails:
            rep = next(r for r in self._replicas if r.name == name)
            self._mem_trails[name] = memwatch.MemoryTrail(
                device=self.device, bytes_fn=lambda: self._replica_bytes(rep),
                metrics=self.metrics or None, replica=name,
                budget_bytes=self.mem_budget_bytes,
                horizon_s=self.mem_horizon_s, clock=self.mem_clock)
        return self._mem_trails[name]

    def _replica_bytes(self, rep) -> int:
        from lux_tpu_torch import memwatch
        return memwatch.replica_ledger(self, rep).total_bytes

    def set_fault(self, plan) -> None:
        """Arm (or disarm with None) a faults.ReplicaKillPlan, after a
        warm-up so its boundaries count loaded traffic only."""
        self.fault = plan

    def _healthy(self) -> list:
        return [r for r in self._replicas if r.state == "up"]

    def _score(self, rep, kind: str) -> float:
        age = self.board.age(rep.name)
        return (age if age is not None else 0.0) \
            + BURN_WEIGHT * rep.slo_burn()

    def _pick(self, kind: str):
        """The healthiest replica with room: min (score, load, index)."""
        cands = [r for r in self._healthy() if not r.remote or r.free() > 0]
        if not cands:
            return None
        return min(cands, key=lambda r: (round(self._score(r, kind), 6),
                                         r.pending_total(), r.index))

    def routing_target(self, kind: str) -> str | None:
        """The replica the NEXT query of ``kind`` would route to (None
        when none is healthy).  Arm kill plans on it: the picked replica
        drains, which refreshes its beat, which keeps it the pick, so a
        plan on a fixed index may never fire."""
        rep = self._pick(kind)
        return None if rep is None else rep.name

    def _health_gauges(self) -> None:
        if self.metrics is None:
            return
        m = self.metrics
        m.gauge("fleet_replicas_healthy").set(len(self._healthy()))
        m.gauge("fleet_brownout_level").set(self._brownout)
        for rep in self._replicas:
            age = self.board.age(rep.name)
            m.gauge("fleet_replica_beat_age", replica=rep.name).set(
                age if age is not None else -1.0)

    # -- admission -----------------------------------------------------

    def _queue(self, kind: str) -> PriorityCollector:
        # the fleet's queues carry no metrics: a request's queue wait is
        # observed once, in its replica's collector
        if kind not in self._queues:
            raise ValueError(f"unknown query kind {kind!r}; choose from "
                             f"{KINDS}")
        return self._queues[kind]

    def _projected_wait(self, kind: str) -> float:
        """Queue ahead x mean observed service time / surviving column
        capacity; 0.0 before the first retirement (cold admission is
        optimistic)."""
        mean = None
        if self.metrics is not None:
            mean = self.metrics.histogram("fleet_service_seconds",
                                          kind=kind).mean()
        if mean is None:
            return 0.0
        ahead = len(self._queue(kind)) + sum(
            r.pending(kind) for r in self._healthy())
        cap = self.batch * max(1, len(self._healthy()))
        return ahead * mean / cap

    def _shed(self, req: Request, reason: str, *,
              projected: float | None = None,
              projected_bytes: int | None = None, raise_: bool = True):
        err = AdmissionError(req.qid, req.kind, req.tenant, reason,
                             projected_wait_s=projected,
                             deadline_s=req.deadline_s,
                             projected_bytes=projected_bytes,
                             budget_bytes=(self.mem_budget_bytes
                                           if projected_bytes is not None
                                           else None))
        with self._lock:
            self.shed_records.append(err)
            if req.qid in self._qreq:   # a late shed of an admitted query
                self._qreq.pop(req.qid, None)
                self._tenant_load[req.tenant] = max(
                    0, self._tenant_load.get(req.tenant, 1) - 1)
                if self.live is not None:
                    self.live.release()
            if self.journal is not None and req.qid in self._journaled:
                # a late shed retires the journal entry: recover() must
                # not resurrect a query the fleet already rejected
                self.journal.append_retire(req.qid, "shed")
                self._journaled.discard(req.qid)
        if self.metrics is not None:
            self.metrics.counter("fleet_shed_total", kind=req.kind,
                                 reason=reason).inc()
        extra = {} if projected is None else {
            "projected_wait_s": round(projected, 6)}
        if projected_bytes is not None:
            extra["projected_bytes"] = int(projected_bytes)
            extra["budget_bytes"] = self.mem_budget_bytes
        _emit("query_shed", qid=req.qid, query_kind=req.kind,
              tenant=req.tenant, priority=req.priority, reason=reason,
              **extra)
        if raise_:
            raise err
        return err

    def _admission(self, req: Request) -> None:
        if not self._healthy():
            self._shed(req, SHED_NO_CAPACITY)
        if self._brownout and req.priority < self.brownout_min_priority:
            self._shed(req, SHED_BROWNOUT)
        cap = self.quota.get(req.tenant)
        if cap is not None and self._tenant_load.get(req.tenant, 0) >= cap:
            self._shed(req, SHED_QUOTA)
        if len(self._queue(req.kind)) >= self.max_queue:
            self._shed(req, SHED_QUEUE_FULL)
        if req.deadline_s is not None:
            p = self._projected_wait(req.kind)
            if p > req.deadline_s:
                self._shed(req, SHED_DEADLINE, projected=p)
        if self.mem_budget_bytes is not None:
            b = self._projected_bytes(req.kind)
            if b is not None and b > self.mem_budget_bytes:
                self._shed(req, SHED_MEMORY, projected_bytes=b)

    def _projected_bytes(self, kind: str) -> int | None:
        """The routing target's ledger total after admitting a batch of
        ``kind``: + batch x (column state + answer-cache headroom).
        None when no in-process replica is routable or its engine of
        ``kind`` is not built yet (cold admission is optimistic)."""
        from lux_tpu_torch import memwatch

        rep = self._pick(kind)
        if rep is None or rep.remote:
            return None
        runner = rep._runners.get(kind)
        if runner is None:
            return None
        return memwatch.projected_admission_bytes(
            self._replica_bytes(rep), batch=self.batch,
            column_bytes=memwatch.column_state_bytes(runner.eng),
            answer_bytes=(0 if self.cache is None else
                          self.g.nv * memwatch.ANSWER_BYTES_PER_VERTEX))

    def _admission_epoch(self, kind: str) -> int | None:
        """The epoch a query of ``kind`` would pin (cache sweeps; the
        admission itself stamps through serve.admit_query)."""
        return serve_mod.admission_epoch(self.live, kind)

    def mutate(self, src, dst, weights=None, tenant: str = "default",
               op: str = "append") -> int:
        """The ingest path: publish one mutation batch into the shared
        live graph (``op`` "append", "delete" or "reweight").  A full
        delta block sheds the batch with a typed
        ``AdmissionError(reason="delta_full")``, recorded like every
        other rejection."""
        from lux_tpu_torch import livegraph

        if self.live is None:
            raise ValueError("mutate() needs a live graph "
                             "(FleetServer(live=LiveGraph(...)))")
        if op not in ("append", "delete", "reweight"):
            raise ValueError(f"unknown mutation op {op!r}; choose from "
                             f"('append', 'delete', 'reweight')")
        try:
            if op == "delete":
                return self.live.delete_edges(src, dst)
            if op == "reweight":
                return self.live.reweight_edges(src, dst, weights)
            return self.live.append_edges(src, dst, weights)
        except livegraph.DeltaFullError:
            with self._lock:
                qid = self._next_qid
                self._next_qid += 1
            req = Request(qid=qid, kind="mutation",
                          t_enqueue=time.monotonic(), tenant=str(tenant))
            self._shed(req, SHED_DELTA_FULL)

    def slo_burn(self) -> float:
        """The worst replica's rolling SLO burn: the
        CompactionScheduler's back-off input."""
        return max((rep.slo_burn() for rep in self._replicas), default=0.0)

    def refresh_live(self) -> None:
        """Adopt the live graph's new generation after a compaction:
        every in-process replica's runners are dropped and rebuilt over
        the new base at first use.  Refused while queries are resident
        at a replica, or centrally queued at an epoch the new base
        cannot reproduce."""
        if self.live is None:
            return
        stale = [req for q in self._queues.values()
                 for req in q.pending_requests()
                 if not serve_mod._epoch_reproducible(self.live, req)]
        if stale:
            raise RuntimeError(
                f"refresh_live with {len(stale)} query(ies) queued at an "
                f"epoch the new generation cannot reproduce — drain first")
        if any(rep.pending_total() for rep in self._healthy()):
            raise RuntimeError("refresh_live with queries still "
                               "dispatched or resident — drain first")
        self.g = self.live.base
        for rep in self._replicas:
            if not rep.remote:
                rep._runners.clear()

    def _register(self, req: Request) -> None:
        """Count an admitted request in the qid and tenant maps (the
        caller holds the lock)."""
        self._qreq[req.qid] = req
        self._tenant_load[req.tenant] = \
            self._tenant_load.get(req.tenant, 0) + 1

    def _unregister(self, req: Request) -> None:
        """Undo ``_register`` for a request leaving the fleet (the
        caller holds the lock)."""
        if self._qreq.pop(req.qid, None) is not None:
            self._tenant_load[req.tenant] = max(
                0, self._tenant_load.get(req.tenant, 1) - 1)
            if self.live is not None:
                self.live.release()

    def submit(self, kind: str, source: int | None = None, reset=None,
               tenant: str = "default", priority: int = 0,
               deadline_s: float | None = None) -> int:
        """Admit or shed: returns the qid, or raises a typed
        AdmissionError (which also leaves a query_shed event and a
        shed_records entry)."""
        q = self._queue(kind)           # validates the kind first
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
        req = Request(qid=qid, kind=kind,
                      source=None if source is None else int(source),
                      reset=(None if reset is None
                             else np.asarray(reset, np.float32)),
                      t_enqueue=time.monotonic(), tenant=str(tenant),
                      priority=int(priority),
                      deadline_s=(None if deadline_s is None
                                  else float(deadline_s)),
                      # the epoch stamp and the admission ledger entry in
                      # one lock, released at the exactly-once retirement
                      # (_accept) or a later shed
                      epoch=serve_mod.admit_query(self.live, kind))
        if self.metrics is not None:
            self.metrics.counter("serve_queries_total", kind=kind).inc()
        _emit("query_enqueue", qid=qid, query_kind=kind, source=req.source,
              tenant=req.tenant, priority=req.priority, queued=len(q))
        with self._lock:
            try:
                self._admission(req)
                if self.journal is not None:
                    # durable BEFORE visible: the admit record is fsynced
                    # before the query enters a queue, so a crash can
                    # lose an unacknowledged submit but never an
                    # acknowledged one
                    self.journal.append_admit(req)
            except BaseException:
                if self.live is not None:
                    self.live.release()
                raise
            if self.journal is not None:
                self._journaled.add(qid)
            self._register(req)
            q.put(req)
        return qid

    def _probe(self, kind: str) -> Request:
        """A throwaway query from vertex 0 (warm-ups and canaries),
        registered like an admitted one and assigned directly by the
        caller, never routed."""
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
        req = Request(qid=qid, kind=kind, source=0,
                      t_enqueue=time.monotonic(),
                      epoch=serve_mod.admit_query(self.live, kind),
                      no_cache=True)
        with self._lock:
            self._register(req)
        return req

    def warm(self, kinds=None) -> int:
        """Build EVERY (replica, kind) engine outside a measured load:
        one throwaway query per replica per kind, assigned directly to
        the replica (routing would warm one replica and bill the others'
        engine builds to the first measured queries).  Returns the
        number of warm responses drained."""
        for rep in self._replicas:
            if rep.state != "up":
                continue
            for k in list(kinds or KINDS):
                req = self._probe(k)
                _emit("query_enqueue", qid=req.qid, query_kind=k, source=0,
                      tenant=req.tenant, priority=req.priority, queued=0)
                self._assign(rep, req)
        return len(self.run())

    # -- dispatch / drain / failover -----------------------------------

    def _assign(self, rep, req: Request) -> None:
        if rep.remote:
            rep.dispatch(req)
        else:
            rep.collector(req.kind).put(req)

    def _drop_dup(self, kind: str) -> None:
        """Count one replayed query or late answer dropped (the caller
        holds the lock)."""
        self.dup_dropped += 1
        if self.metrics is not None:
            self.metrics.counter("fleet_dup_dropped_total", kind=kind).inc()

    def _accept(self, resp: Response) -> bool:
        """Exactly-once retirement: False (and dropped) when the qid
        already retired."""
        with self._lock:
            if resp.qid in self._retired:
                self._drop_dup(resp.kind)
                return False
            self._retired.add(resp.qid)
            req = self._qreq.get(resp.qid)
            if req is not None:
                self._unregister(req)
            if self.journal is not None and resp.qid in self._journaled:
                # the _retired gate above makes this exactly once on disk
                self.journal.append_retire(resp.qid, "answered")
                self._journaled.discard(resp.qid)
        if self.metrics is not None and not resp.cached:
            # cache hits never touch an engine: they would drag down the
            # mean the deadline projection divides by
            self.metrics.histogram("fleet_service_seconds",
                                   kind=resp.kind).observe(
                max(0.0, resp.latency_s - resp.wait_s))
        return True

    def _drain_inproc(self, rep, kind: str) -> list[Response]:
        runner = rep.runner(kind)
        n0 = len(runner.responses)
        err = None
        try:
            runner.drain(rep.collector(kind), deadline_s=0.0)
        except (heartbeat_mod.WorkerLostError, faults_mod.InjectedWorkerKill,
                faults_mod.InjectedDeviceLoss) as e:
            err = e
        out = [r for r in runner.responses[n0:] if self._accept(r)]
        if err is not None:
            self._mark_lost(rep, err)
        return out

    def _mark_lost(self, rep, err: BaseException) -> None:
        if rep.state == "lost":
            return
        rep.state = "lost"
        rep.error = err
        inflight: list[Request] = []
        if rep.remote:
            inflight = list(rep.inflight.values())
            rep.inflight.clear()
        else:
            for runner in rep._runners.values():
                for c, slot in enumerate(runner.slots):
                    if slot is not None:
                        inflight.append(slot.req)
                        runner.slots[c] = None
                        if runner.live is not None:
                            # the re-dispatch pins again at its start
                            runner.live.unpin()
            for coll in rep._collectors.values():
                # the requests re-queue on a survivor: observing their
                # partial wait here would count it twice
                coll.metrics = None
                inflight += coll.collect(len(coll))
        inflight = [r for r in inflight if r.qid not in self._retired]
        # a dead replica's canary dies with it: it probes THAT replica
        canaries = [r for r in inflight if r.qid in self._canaries]
        inflight = [r for r in inflight if r.qid not in self._canaries]
        with self._lock:
            for r in canaries:
                self._retired.add(r.qid)
                self._unregister(r)
                self._canaries.discard(r.qid)
        _emit("replica_lost", replica=rep.name, error=type(err).__name__,
              message=str(err)[:200], inflight=len(inflight))
        if self.metrics is not None:
            self.metrics.counter("fleet_replica_lost_total").inc()
        # healing bookkeeping before the failovers: MTTR counts from the
        # first loss, and the flap verdict decides between a respawn and
        # the quarantine (for manual resurrect() too)
        if self._t_degraded is None:
            self._t_degraded = float(self.heal_clock())
        deaths = self.flap.record(rep.name)
        if not rep.remote:
            if deaths >= self.flap.threshold:
                self._quarantine(rep, reason="flap", deaths=deaths)
            else:
                k = self._respawn_attempts.get(rep.name, 0)
                self._respawn_at[rep.name] = (
                    float(self.heal_clock()) + self.respawn_retry.delay_s(k))
        self._set_brownout()
        self._health_gauges()
        t_detect = time.monotonic()
        for req in sorted(inflight, key=lambda r: r.t_enqueue):
            self._failover(req, rep, t_detect=t_detect)

    def _set_brownout(self) -> None:
        """The brownout level from the pool as it is (one per replica not
        serving), with an event at each change, both ways."""
        level = sum(1 for r in self._replicas if r.state != "up")
        if level != self._brownout:
            self._brownout = level
            total = max(1, len(self._replicas))
            _emit("brownout", level=level,
                  capacity_frac=round(len(self._healthy()) / total, 4),
                  min_priority=self.brownout_min_priority)

    def _quarantine(self, rep, reason: str, deaths: int = 0) -> None:
        """Typed removal from the resurrection loop: neither routed to
        nor respawned.  ``reason`` is "flap" or "canary" (the probe
        answered wrong: worse than dead)."""
        rep.state = "quarantined"
        self.quarantines += 1
        self._respawn_at.pop(rep.name, None)
        _emit("replica_quarantine", replica=rep.name, reason=reason,
              deaths=int(deaths), window_s=round(self.flap.window_s, 3))
        if self.metrics is not None:
            self.metrics.counter("fleet_quarantines_total").inc()
        self._set_brownout()
        self._health_gauges()

    # -- resurrection --------------------------------------------------

    def _heal(self) -> None:
        """The run loop's non-blocking supervisor tick: respawn every
        lost in-process replica whose backoff has expired."""
        if not self.heal:
            return
        now = float(self.heal_clock())
        for rep in list(self._replicas):
            if rep.state != "lost" or rep.remote:
                continue
            due = self._respawn_at.get(rep.name)
            if due is not None and now >= due:
                self._respawn(rep)

    def resurrect(self, wait: bool = True) -> list[str]:
        """Drive resurrection to quiescence outside a serve loop (also
        with ``heal=False``): respawn every lost in-process replica,
        waiting out each backoff when ``wait``, until each is up or
        quarantined.  Returns the names that re-entered routing."""
        out: list[str] = []
        while True:
            targets = [r for r in self._replicas
                       if r.state == "lost" and not r.remote]
            if not targets:
                break
            for rep in targets:
                now = float(self.heal_clock())
                due = self._respawn_at.get(rep.name)
                if due is None:
                    k = self._respawn_attempts.get(rep.name, 0)
                    due = now + self.respawn_retry.delay_s(k)
                    self._respawn_at[rep.name] = due
                if due > now:
                    if not wait:
                        return out
                    self.respawn_retry.sleep(due - now)
                if self._respawn(rep):
                    out.append(rep.name)
        return out

    def _respawn(self, rep) -> bool:
        """One resurrection attempt: a fresh runner set under the same
        name and index, built over the current base (generation
        adoption), re-entering routing only when its canary answers its
        numpy oracle exactly.  True when it re-entered."""
        name = rep.name
        k = self._respawn_attempts.get(name, 0)
        self._respawn_attempts[name] = k + 1
        self._respawn_at.pop(name, None)
        new = _InProcessReplica(self, name, rep.index)
        new.state = "warming"       # invisible to _pick until the canary
        self._replicas[rep.index] = new
        self._mem_trails.pop(name, None)   # it priced the dead runners
        self.board.beat(name, status="warming", boundary=0)
        ok = self._run_canary(new)
        if new.state != "warming":
            # died while warming: _mark_lost rescheduled or quarantined
            return False
        if not ok:
            self._quarantine(new, reason="canary",
                             deaths=self.flap.deaths(name))
            return False
        new.state = "up"
        self.respawns += 1
        self._respawn_attempts[name] = 0    # healthy: a fresh incident
        _emit("replica_respawn", replica=name, attempt=k + 1,
              backoff_s=round(self.respawn_retry.delay_s(k), 4),
              canary_ok=True)
        if self.metrics is not None:
            self.metrics.counter("fleet_respawns_total").inc()
        self.board.beat(name, status="up", boundary=0)
        self._set_brownout()
        self._health_gauges()
        if (self._t_degraded is not None
                and all(r.state == "up" for r in self._replicas)):
            self.mttr_s = float(self.heal_clock()) - self._t_degraded
            self._t_degraded = None
            if self.metrics is not None:
                self.metrics.gauge("fleet_mttr_seconds").set(
                    round(self.mttr_s, 6))
        return True

    def _run_canary(self, rep, kind: str = "components") -> bool:
        """The oracle-checked warm-up probe: one throwaway query assigned
        directly to the warming replica; True when the replica stayed up
        and the answer equals its numpy oracle (a live fleet's at the
        canary's admission epoch).  Components: integer labels, and the
        same rule for weighted and unweighted fleets."""
        req = self._probe(kind)
        with self._lock:
            self._canaries.add(req.qid)
        # a probe, not traffic: the runner's and collector's SLO and
        # latency metrics are off for its drain
        runner = rep.runner(kind)
        coll = rep.collector(kind)
        saved = (runner.metrics, coll.metrics)
        runner.metrics = coll.metrics = None
        self._assign(rep, req)
        resps: list[Response] = []
        try:
            while rep.state == "warming" and rep.pending(kind):
                resps += self._drain_inproc(rep, kind)
        finally:
            runner.metrics, coll.metrics = saved
        with self._lock:
            self._canaries.discard(req.qid)
        canary = next((r for r in resps if r.qid == req.qid), None)
        if rep.state != "warming" or canary is None:
            _emit("canary", replica=rep.name, qid=req.qid, query_kind=kind,
                  ok=False, reason="died")
            return False
        if self.live is not None:
            from lux_tpu_torch import livegraph
            bad = livegraph.check_live_answers(self.live, [canary],
                                               self.weighted)
        else:
            bad = serve_mod._check_answers(self.g, [canary])
        ok = bad == 0
        _emit("canary", replica=rep.name, qid=req.qid, query_kind=kind,
              ok=ok, **({} if ok else {"reason": "oracle_mismatch"}))
        return ok

    def _failover(self, req: Request, from_rep,
                  t_detect: float | None = None) -> None:
        with self._lock:
            # a query whose retirement raced the loss detection must not
            # run twice: checked and counted under the lock
            if req.qid in self._retired:
                self._drop_dup(req.kind)
                return
        k = self._attempts.get(req.qid, 0)
        self._attempts[req.qid] = k + 1
        if k >= self.retry.retries:
            self._shed(req, SHED_RETRIES, raise_=False)
            return
        # each delay is a not-before offset from the detection instant,
        # so a batch of failovers waits for the largest, not the sum
        d = self.retry.delay_s(k)
        waited = 0.0 if t_detect is None else time.monotonic() - t_detect
        if d > waited:
            self.retry.sleep(d - waited)
        to = self._pick(req.kind)
        if to is None:
            self._shed(req, SHED_NO_CAPACITY, raise_=False)
            return
        self.failovers += 1
        if self.metrics is not None:
            self.metrics.counter("fleet_failovers_total",
                                 kind=req.kind).inc()
        _emit("failover", qid=req.qid, query_kind=req.kind,
              from_replica=from_rep.name, to_replica=to.name,
              attempt=k + 1, backoff_s=round(d, 4))
        self._assign(to, req)

    # -- subprocess answers --------------------------------------------

    def _poll_remote(self) -> list[Response]:
        out: list[Response] = []
        for rep in self._replicas:
            if not rep.remote:
                continue
            try:
                names = sorted(os.listdir(rep.outdir))
            except OSError:
                continue
            for f in names:
                if not f.endswith(".json"):
                    continue
                jpath = os.path.join(rep.outdir, f)
                npath = jpath[:-5] + ".npy"
                try:
                    with open(jpath) as fh:
                        meta = json.load(fh)
                    answer = np.load(npath)
                except (OSError, ValueError):
                    continue            # a torn pair: the next poll
                for p in (jpath, npath):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                qid = int(meta["qid"])
                req = rep.inflight.pop(qid, None) or self._qreq.get(qid)
                with self._lock:
                    # a late answer from a replica already failed over
                    dup = qid in self._retired or req is None
                    if dup:
                        self._drop_dup(meta.get("kind", "?"))
                if not dup:
                    out.append(self._accept_remote(rep, req, meta, answer))
        return [r for r in out if r is not None]

    def _accept_remote(self, rep, req: Request, meta: dict,
                       answer) -> Response | None:
        latency = max(0.0, time.monotonic() - req.t_enqueue)
        service = float(meta.get("service_s") or 0.0)
        resp = Response(
            qid=req.qid, kind=req.kind, source=req.source,
            answer=np.asarray(answer), iters=int(meta.get("iters", 0)),
            segments=int(meta.get("segments", 0)), latency_s=latency,
            wait_s=max(0.0, latency - service),
            converged=bool(meta.get("converged", True)))
        slo = {}
        slo_ms = self.slo_ms.get(req.kind)
        if slo_ms is not None:
            slo = {"slo_ms": slo_ms, "slo_ok": latency * 1e3 <= slo_ms}
        if self.metrics is not None:
            m = self.metrics
            m.histogram("serve_latency_seconds",
                        kind=req.kind).observe(latency)
            m.counter("serve_retired_total", kind=req.kind).inc()
            if slo:
                m.counter("serve_slo_good_total" if slo["slo_ok"]
                          else "serve_slo_violation_total",
                          kind=req.kind).inc()
        if not self._accept(resp):
            return None
        _emit("query_done", qid=resp.qid, query_kind=resp.kind, col=-1,
              iters=resp.iters, segments=resp.segments,
              latency_s=round(resp.latency_s, 6),
              wait_s=round(resp.wait_s, 6), converged=resp.converged,
              replica=rep.name, **slo)
        return resp

    def _check_remote_health(self) -> None:
        for rep in self._replicas:
            if not rep.remote or rep.state != "up":
                continue
            rc = rep.proc.poll() if rep.proc is not None else None
            age = self.board.age(rep.name)
            if (rc is not None and rc != 0) or (
                    age is not None and age > self.replica_deadline_s):
                self._mark_lost(rep, heartbeat_mod.WorkerLostError(
                    [rep.index], -1, self.replica_deadline_s))

    # -- the serve loop ------------------------------------------------

    def _pending_any(self) -> bool:
        if any(len(q) for q in self._queues.values()):
            return True
        return any(rep.pending_total() for rep in self._healthy())

    def _respawn_due(self) -> bool:
        """A heal-armed fleet with a lost in-process replica: a
        resurrection is scheduled."""
        return self.heal and any(r.state == "lost" and not r.remote
                                 for r in self._replicas)

    def run(self) -> list[Response]:
        """Serve until every admitted query retired or was shed: route
        queued requests to the healthiest replicas, drain the in-process
        ones through continuous-batching refill, poll subprocess
        answers, and fail over on any death seen on the way.  Returns
        this call's responses in retirement order."""
        if self.live is not None and self.g is not self.live.base:
            # engines over a stale base would serve old base + an empty
            # delta: a wrong answer at the right epoch
            raise RuntimeError("live graph compacted to a new generation — "
                               "call refresh_live() before serving")
        if self.cache is not None and self.live is not None:
            self.cache.sweep({k: self._admission_epoch(k) for k in KINDS})
        out: list[Response] = []
        while True:
            progressed = False
            got = self._poll_remote()
            if got:
                out += got
                progressed = True
            self._check_remote_health()
            if self.heal:
                self._heal()
            for kind in list(self._queues):
                q = self._queues[kind]
                if len(q):
                    if not self._healthy():
                        if self._respawn_due():
                            # HOLD the queue: the respawn either succeeds
                            # or quarantines, and then this sheds
                            continue
                        for req in q.collect(len(q)):
                            self._shed(req, SHED_NO_CAPACITY, raise_=False)
                        progressed = True
                        continue
                    leftover = []
                    for req in q.collect(len(q)):
                        if req.qid in self._retired:
                            continue
                        rep = self._pick(kind)
                        if rep is None:
                            leftover.append(req)
                            continue
                        self._assign(rep, req)
                        progressed = True
                    for req in leftover:
                        q.put(req)      # full remotes: wait, not shed
                for rep in list(self._replicas):
                    if (rep.state == "up" and not rep.remote
                            and rep.pending(kind)):
                        out += self._drain_inproc(rep, kind)
                        progressed = True
            # a heal-armed run also restores the pool before returning,
            # so mttr_s is final and the next submit sees the capacity
            if not self._pending_any() and not self._respawn_due():
                break
            if not progressed:
                time.sleep(REMOTE_POLL_S)
        self._health_gauges()
        now = time.monotonic()
        if out and now - self._last_snapshot >= self.snapshot_every_s:
            self._last_snapshot = now
            self.emit_metrics_snapshot()
        return out

    # -- the serve.Server surface --------------------------------------

    @property
    def _collectors(self) -> dict:
        """Per-kind pending views (queued, replica-resident and
        subprocess in-flight): a load generator's drain predicate."""
        return {k: _PendingView(self, k) for k in self._queues}

    def set_metrics(self, registry) -> None:
        self.metrics = registry
        for rep in self._replicas:
            if rep.remote:
                continue
            for coll in rep._collectors.values():
                coll.metrics = registry
            for runner in rep._runners.values():
                runner.metrics = registry

    def emit_metrics_snapshot(self, **extra):
        if self.metrics is None:
            return None
        return self.metrics.emit_snapshot(**extra)

    def close(self) -> None:
        for rep in self._replicas:
            if rep.remote:
                rep.stop()
        if self.journal is not None:
            self.journal.close()

    # -- whole-fleet crash recovery ------------------------------------

    @classmethod
    def recover(cls, g, journal_path: str, /, *, resets=None, live=None,
                **kw) -> "FleetServer":
        """Restart a crashed fleet from its admission journal: replay it
        (a torn tail truncated in place), seed the exactly-once set from
        the persisted retirements, and re-dispatch every
        admitted-unretired query so the next run() answers it at its
        ORIGINAL admission epoch.

        The order matters: the caller replays the mutation WAL first
        (``LiveGraph.recover``) and passes that handle as ``live`` with
        ``g = live.base``, so the generation is adopted before any epoch
        verdict.  Re-dispatch is unconditional but for two typed,
        journal-retired sheds: ``reset_unavailable`` (a reset query
        whose vector ``resets`` (qid -> vector) does not supply, or
        supplies with another digest) and ``epoch_folded`` (a live
        base already folded past the admission epoch).  Deadlines
        restart at re-dispatch.  ``journal_path`` must not be among the
        keywords: the journal is resumed, not created."""
        if "journal_path" in kw:
            raise ValueError(
                "recover() resumes the journal at journal_path; do not "
                "also pass journal_path= (that would O_EXCL-create over "
                "the evidence)")
        opens, retired, torn, jrnl = journal_mod.AdmissionJournal.replay(
            journal_path, nv=g.nv)
        flt = cls(g, live=live, **kw)
        flt.journal = jrnl
        with flt._lock:
            flt._retired.update(retired)
            seen = [rec.qid for rec in opens] + list(retired)
            if seen:
                flt._next_qid = max(seen) + 1
        flt.journal_replayed = len(opens)
        _emit("journal_replay", path=journal_path, replayed=len(opens),
              retired=len(retired), torn_bytes=torn)
        if flt.metrics is not None:
            flt.metrics.counter("fleet_journal_replayed_total").inc(
                len(opens))
        resets = dict(resets or {})
        for rec in opens:
            reset = None
            if rec.digest is not None:
                reset = resets.get(rec.qid)
                if reset is not None:
                    reset = np.asarray(reset, np.float32)
                if (reset is None
                        or journal_mod.reset_digest(reset) != rec.digest):
                    req = Request(qid=rec.qid, kind=rec.kind, source=None,
                                  reset=reset, t_enqueue=time.monotonic(),
                                  tenant=rec.tenant, priority=rec.priority,
                                  deadline_s=rec.deadline_s, epoch=None)
                    flt._journaled.add(rec.qid)
                    flt._shed(req, SHED_RESET_UNAVAILABLE, raise_=False)
                    continue
            req = Request(qid=rec.qid, kind=rec.kind, source=rec.source,
                          reset=reset, t_enqueue=time.monotonic(),
                          tenant=rec.tenant, priority=rec.priority,
                          deadline_s=rec.deadline_s, epoch=rec.epoch)
            if live is not None:
                if not serve_mod._epoch_reproducible(live, req):
                    flt._journaled.add(rec.qid)
                    flt._shed(req, SHED_EPOCH_FOLDED, raise_=False)
                    continue
                # a fresh admission-ledger entry keeps the generation
                # serveable; the query still answers at its journalled
                # epoch
                live.admit(serve_mod._engine_family(rec.kind))
            with flt._lock:
                flt._journaled.add(rec.qid)
                flt._register(req)
                flt._queue(rec.kind).put(req)
            _emit("query_enqueue", qid=rec.qid, query_kind=rec.kind,
                  source=req.source, tenant=req.tenant,
                  priority=req.priority,
                  queued=len(flt._queue(rec.kind)), recovered=True)
        return flt


class _PendingView:
    def __init__(self, fleet: FleetServer, kind: str):
        self.fleet = fleet
        self.kind = kind

    def __len__(self) -> int:
        n = len(self.fleet._queues[self.kind])
        for rep in self.fleet._healthy():
            n += rep.pending(self.kind)
        return n


# ---------------------------------------------------------------------
# the subprocess replica's worker

def _worker_env() -> dict:
    """The worker's environment: the caller's, with the repository at the
    head of PYTHONPATH.  Nothing that hides the card is set: the worker
    takes the device its spec names."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + pp)
    return env


def _graph_from_spec(spec: dict):
    """Rebuild the seeded graph a subprocess replica serves through the
    port's generators: bit for bit the parent's, or the answers could
    not equal the oracle's."""
    from lux_tpu_torch.graph import Graph

    kind = spec.get("kind", "uniform")
    if kind == "uniform":
        from lux_tpu_torch.convert import uniform_random_edges
        src, dst = uniform_random_edges(int(spec["nv"]), int(spec["ne"]),
                                        seed=int(spec.get("seed", 0)))
        return Graph.from_edges(src, dst, int(spec["nv"]))
    if kind == "rmat":
        from lux_tpu_torch.convert import rmat_graph
        return rmat_graph(scale=int(spec["scale"]),
                          edge_factor=int(spec["ef"]),
                          seed=int(spec.get("seed", 0)))
    raise ValueError(f"unknown graph spec kind {spec!r}")


def _write_answer(spool: str, outdir: str, fq: int, r) -> None:
    """One answer pair into ``outdir``: the npy first, then the json,
    whose presence marks a complete pair."""
    base = os.path.join(outdir, f"q{fq:08d}")
    fd, tmp = tempfile.mkstemp(dir=spool, suffix=".npy.tmp")
    with os.fdopen(fd, "wb") as fh:
        # lockcheck: allow(durable-before-visible) same-host answer
        # spool, not a durability record: a lost answer re-runs from
        # the journal; fsync per answer would serialize the drain on
        # disk latency
        np.save(fh, r.answer)
    os.replace(tmp, base + ".npy")
    meta = {"qid": fq, "kind": r.kind, "source": r.source, "iters": r.iters,
            "segments": r.segments, "converged": r.converged,
            "service_s": round(r.latency_s, 6)}
    fd, tmp = tempfile.mkstemp(dir=spool, suffix=".json.tmp")
    with os.fdopen(fd, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, base + ".json")


def _worker_main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    name = spec["name"]
    board = heartbeat_mod.ReplicaBoard(spec["board"])
    plan = None
    if spec.get("kill_boundary") is not None:
        plan = faults_mod.ReplicaKillPlan({name: int(spec["kill_boundary"])},
                                          hard_kill=True)
    state = {"boundary": 0}

    def on_boundary(runner):
        state["boundary"] += 1
        board.beat(name, status="up", boundary=state["boundary"])
        if plan is not None:
            plan.fire(name)

    g = _graph_from_spec(spec["graph"])
    srv = serve_mod.Server(g, batch=int(spec["batch"]),
                           num_parts=int(spec["num_parts"]),
                           device=spec.get("device"),
                           seg_iters=int(spec["seg_iters"]),
                           tol=float(spec.get("tol", 1e-8)),
                           weighted=bool(spec.get("weighted", False)),
                           exchange=spec.get("exchange", "auto"),
                           metrics=False, on_boundary=on_boundary,
                           replica=name)
    inbox = os.path.join(spec["dir"], f"inbox_{name}")
    outdir = os.path.join(spec["dir"], f"out_{name}")
    stop = os.path.join(spec["dir"], "stop")
    qmap: dict[int, int] = {}
    board.beat(name, status="up", boundary=0)
    while not os.path.exists(stop):
        board.beat(name, status="up", boundary=state["boundary"])
        for f in sorted(os.listdir(inbox)):
            if not f.endswith(".json"):
                continue
            p = os.path.join(inbox, f)
            try:
                with open(p) as fh:
                    doc = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            reset = None
            rp = p[:-5] + ".reset.npy"
            if doc.get("reset"):
                try:
                    reset = np.load(rp)
                except (OSError, ValueError):
                    continue    # a torn pair: the json stays for later
            os.remove(p)
            if doc.get("reset"):
                try:
                    os.remove(rp)
                except OSError:
                    pass
            wq = srv.submit(doc["kind"], source=doc.get("source"),
                            reset=reset)
            qmap[wq] = int(doc["qid"])
        for r in srv.run():
            _write_answer(spec["dir"], outdir, qmap.pop(r.qid), r)
        time.sleep(0.02)
    return 0


# ---------------------------------------------------------------------
# smoke: python -m lux_tpu_torch.fleet

def main(argv=None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "-worker":
        return _worker_main(argv[1])

    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.fleet",
        description="serving-fleet chaos smoke: an oversubscribed "
                    "mixed-kind load across N replicas with one replica "
                    "killed mid-drain; every answer is oracle-checked, "
                    "shed queries carry typed rejections, and no qid "
                    "retires twice")
    ap.add_argument("-scale", type=int, default=8)
    ap.add_argument("-ef", type=int, default=8)
    ap.add_argument("-batch", type=int, default=2)
    ap.add_argument("-replicas", type=int, default=2)
    ap.add_argument("-np", type=int, default=2, dest="num_parts")
    ap.add_argument("-queries", type=int, default=0,
                    help="total mixed queries (default 4B)")
    ap.add_argument("-kill-boundary", type=int, default=1,
                    dest="kill_boundary",
                    help="boundary of the routed replica at which the kill "
                         "plan fires (-1 disables)")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-events", default=None, metavar="FILE")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch import telemetry
    from lux_tpu_torch.device import DeviceUnavailableError
    from lux_tpu_torch.serve import _check_answers, _smoke_graph

    g = _smoke_graph(args.scale, args.ef, args.seed)
    rng = np.random.default_rng(args.seed + 1)
    n = args.queries or 4 * args.batch
    kinds = list(KINDS)
    ev = telemetry.EventLog(args.events) if args.events else \
        telemetry.EventLog()
    with telemetry.use(events=ev):
        ev.emit("run_start", schema=telemetry.SCHEMA, app="fleet",
                file=f"<rmat{args.scale}>", np=args.num_parts)
        try:
            flt = FleetServer(g, replicas=args.replicas, batch=args.batch,
                              num_parts=args.num_parts, device=args.device,
                              retry=resilience.RetryPolicy(
                                  retries=3, backoff_s=0.01,
                                  max_backoff_s=0.05, jitter_seed=0))
        except DeviceUnavailableError as e:
            print(f"error: {e}")
            return 2
        if args.kill_boundary >= 0 and args.replicas > 1:
            # arm the replica routing WILL pick
            flt.set_fault(faults_mod.ReplicaKillPlan(
                {flt.routing_target(kinds[0]): args.kill_boundary}))
        for i in range(n):
            flt.submit(kinds[i % len(kinds)],
                       source=int(rng.integers(0, g.nv)))
        t0 = time.perf_counter()
        responses = flt.run()
        ev.emit("run_done", seconds=round(time.perf_counter() - t0, 6),
                iters=sum(r.iters for r in responses))
    ev.close()
    qids = [r.qid for r in responses]
    shed_qids = {e.qid for e in flt.shed_records}
    print(f"# served {len(responses)}/{n} queries across {args.replicas} "
          f"replica(s); failovers={flt.failovers} "
          f"shed={len(flt.shed_records)} dup_dropped={flt.dup_dropped}")
    if len(set(qids)) != len(qids):
        print("error: duplicate retirement")
        return 1
    if set(qids) | shed_qids != set(range(n)) or set(qids) & shed_qids:
        print("error: served + shed do not partition the admitted queries")
        return 1
    if args.kill_boundary >= 0 and args.replicas > 1 \
            and not flt.failovers and not flt.fault.fired:
        print("error: the kill plan never fired")
        return 1
    bad = _check_answers(g, responses)
    if bad:
        print(f"error: {bad} answer(s) mismatched their oracle")
        return 1
    print("# all served answers match their NumPy oracles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
