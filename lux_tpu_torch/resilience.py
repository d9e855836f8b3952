"""Resilient run supervision: failure classification, retry and resume,
duration-budgeted segments and bench sample screening (counterpart of
lux_tpu/resilience.py:106-722).

- ``classify`` sorts a failure into RETRYABLE (a transient worker or
  transport death, an injected crash, a NaN escape caught by
  debug.check_finite, a corrupt checkpoint generation — the retry's
  resume falls back one generation), TOPOLOGY (devices gone) or FATAL
  (deterministic: retrying reruns the same failure).
- ``supervise`` retries retryable failures with decorrelated-jitter
  backoff; TOPOLOGY failures go to an ``on_topology`` handler and are
  fatal without one.
- ``supervised_run`` / ``supervised_converge`` compose the retry loop
  with checkpoint.py's segmented paths: every segment checkpoints
  atomically, a retry resumes from the last checkpoint, and fault
  injection (faults.py) plus the finite guard (debug.py) run at each
  boundary before the save.  ``seg_budget`` sizes the segments with
  segmented.DurationBudget.
- ``screen_outliers`` is the bench's discard-and-rerun rule for
  collapsed samples.

A supervisor retries only what ``classify`` calls RETRYABLE, on the
engine's own device: it never falls back to the CPU.  A fatal failure
or a topology fault dumps the installed crash flight recorder
(tracing.flight_dump: ``FLIGHT.json``), and a supervised run under
``telemetry.use(iter_stats=)`` carries the counters' digest in
``RunReport.counters``.  Not ported yet: the elastic path (a TOPOLOGY
fault re-placing the run on the surviving devices, ``elastic=`` / the
CLI's ``-elastic``: ROADMAP A6b-2) and the supervisor's per-segment
heartbeat sync across a mesh (``heartbeat=``: A6b-2; the board itself,
heartbeat.py, is ported); each raises NotPortedError when asked for.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from statistics import median
from typing import Callable

import numpy as np

from lux_tpu_torch import telemetry

RETRYABLE = "retryable"
FATAL = "fatal"
TOPOLOGY = "topology"

# Topology-fault signatures, scanned before the fatal / transient word
# scans (lux_tpu/resilience.py:66-78).
_TOPOLOGY_RE = re.compile(
    r"device(?:s)?\s+(?:\S+\s+)?(?:is\s+|are\s+)?unavailable|"
    r"DEVICE_UNAVAILABLE|"
    r"device\s+\S+\s+(?:lost|removed|failed)|"
    r"coordination\s+service|"
    r"heartbeat\s+(?:deadline|timeout|timed[\s_-]?out|missed)|"
    r"slice\s+health|task\s+\d+\s+(?:left|lost|missing)", re.I)

# A sticky CUDA error leaves the context dead: nothing in this process
# can launch on the card again, so an in-process retry cannot succeed.
_STICKY_CUDA_RE = re.compile(
    r"illegal memory access|illegal instruction|misaligned address|"
    r"unspecified launch failure|device-side assert|"
    r"hardware stack error|invalid program counter|"
    r"uncorrectable ECC|CUDA error: an? .*(?:exception|fault)", re.I)

# Deterministic failures — retrying replays the same program into the
# same rejection (\b413\b so a port or byte count cannot match).
_FATAL_RE = re.compile(
    r"\b413\b|too\s+large|resource.?exhausted|out of memory|"
    r"failed to allocate|program shape", re.I)

# Transient worker / transport signatures.
_RETRYABLE_RE = re.compile(
    r"unavailable|connection|socket|deadline|timed?[\s_-]?out|"
    r"worker|terminated|cancell?ed|aborted|heartbeat|broken pipe|"
    r"reset by peer|transport|tunnel", re.I)

_RETRYABLE_TYPES = (ConnectionError, TimeoutError, BrokenPipeError,
                    EOFError)

# Deterministic filesystem failures (a bad resume path, a read-only
# checkpoint directory).
_FATAL_OSERRORS = (FileNotFoundError, NotADirectoryError,
                   IsADirectoryError, PermissionError, FileExistsError)


def _fatal_types() -> tuple:
    """The port's own deterministic failures, and torch's: a missing
    card, an option not ported yet, a kernel that did not build (its
    message carries nvcc's log, which may say 'terminated' or 'timed
    out') or did not launch, a kernel's refused input, and the card
    running out of memory."""
    import torch

    from lux_tpu_torch._kernels import KernelBuildError
    from lux_tpu_torch.device import DeviceUnavailableError
    from lux_tpu_torch.engine.pull import NotPortedError
    from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                                KernelLaunchError)
    return (DeviceUnavailableError, NotPortedError, KernelBuildError,
            KernelLaunchError, KernelInputError,
            torch.cuda.OutOfMemoryError)


def classify(exc: BaseException) -> str:
    """RETRYABLE, TOPOLOGY or FATAL for one failure.  Typed checks
    outrank every message scan: first the injected faults, the port's
    and torch's own errors (FATAL), the watchdog and guard errors and a
    corrupt checkpoint; then the message scans, a sticky CUDA error
    (FATAL) before the transient words.  A lost replica or peer
    (InjectedWorkerKill, heartbeat.WorkerLostError) is TOPOLOGY; the
    fleet's typed shed (fleet.AdmissionError) is FATAL before any scan:
    a shed is a decision, and retrying it would re-admit a query the
    tier rejected (its message says 'deadline').  The auditor's
    AuditError is FATAL too: a violation is a property of the build, and
    a retry runs the same program into the same refusal."""
    from lux_tpu_torch import (audit, checkpoint, debug, faults, fleet,
                               health, heartbeat)

    if isinstance(exc, (faults.InjectedDeviceLoss, faults.InjectedWorkerKill,
                        heartbeat.WorkerLostError)):
        return TOPOLOGY
    if isinstance(exc, faults.InjectedWorkerCrash):
        return RETRYABLE
    if isinstance(exc, (fleet.AdmissionError, audit.AuditError)):
        return FATAL
    if isinstance(exc, _fatal_types()):
        return FATAL
    if isinstance(exc, health.HealthError):
        return FATAL            # fatal-with-diagnosis: the corruption
        #                         is in the state itself
    if isinstance(exc, checkpoint.CorruptCheckpointError):
        return RETRYABLE        # the resume falls back one generation
    if isinstance(exc, debug.StallError):
        return FATAL
    if isinstance(exc, debug.DivergenceError):
        return RETRYABLE        # possibly transient; a deterministic
        #                         NaN exhausts the retries
    if isinstance(exc, _RETRYABLE_TYPES):
        return RETRYABLE
    msg = f"{type(exc).__name__}: {exc}"
    if _TOPOLOGY_RE.search(msg):
        return TOPOLOGY
    if _STICKY_CUDA_RE.search(msg):
        return FATAL
    if _FATAL_RE.search(msg):
        return FATAL
    if isinstance(exc, _FATAL_OSERRORS):
        return FATAL
    if isinstance(exc, OSError):
        return RETRYABLE        # transport I/O
    if _RETRYABLE_RE.search(msg):
        return RETRYABLE
    return FATAL


@dataclasses.dataclass
class RetryPolicy:
    """Backoff for retryable failures.  ``sleep`` is injectable so
    tests never wait.  Delays use DECORRELATED JITTER (delay_k drawn
    uniformly from [backoff_s, min(max, 3 * delay_{k-1})]), seeded
    (default from the pid; ``jitter_seed`` for deterministic tests) and
    cached per failure index; ``jitter=0`` is the plain exponential
    schedule."""

    retries: int = 3
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 60.0
    sleep: Callable[[float], None] = time.sleep
    jitter: float = 1.0
    jitter_seed: int | None = None
    _delays: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    _rng: object = dataclasses.field(default=None, init=False,
                                     repr=False, compare=False)

    def delay_s(self, failure_index: int) -> float:
        k = int(failure_index)
        exp = min(self.backoff_s * self.backoff_factor ** k,
                  self.max_backoff_s)
        if not self.jitter:
            return exp
        if k in self._delays:
            return self._delays[k]
        if self._rng is None:
            seed = (self.jitter_seed if self.jitter_seed is not None
                    else (os.getpid() * 2654435761) & 0xFFFFFFFF)
            self._rng = np.random.default_rng(seed)
        prev = self._delays.get(k - 1, self.backoff_s)
        lo = self.backoff_s
        hi = min(self.max_backoff_s, max(lo, 3.0 * prev))
        frac = float(self._rng.random()) * min(1.0, max(0.0, self.jitter))
        d = min(self.max_backoff_s, lo + (hi - lo) * frac)
        self._delays[k] = d
        return d


@dataclasses.dataclass
class FlapDetector:
    """Deaths-in-a-window flap detection: past ``threshold`` deaths of
    one name inside ``window_s`` it is flapping.  ``clock`` is
    injectable."""

    threshold: int = 3
    window_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _deaths: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def record(self, name: str) -> int:
        """Record one death of ``name`` now; returns the deaths inside
        the rolling window (>= threshold means flapping)."""
        now = float(self.clock())
        ds = [t for t in self._deaths.get(name, ())
              if now - t <= self.window_s]
        ds.append(now)
        self._deaths[name] = ds
        return len(ds)

    def deaths(self, name: str) -> int:
        now = float(self.clock())
        return sum(1 for t in self._deaths.get(name, ())
                   if now - t <= self.window_s)

    def flapping(self, name: str) -> bool:
        return self.deaths(name) >= self.threshold


@dataclasses.dataclass
class RunReport:
    """What the supervisor did: for logs and bench lines."""

    attempts: int = 0
    failures: list = dataclasses.field(default_factory=list)
    #           ^ (exception type name, message[:200], classification)
    resumed_from: list = dataclasses.field(default_factory=list)
    #           ^ checkpoint iteration counter at each resume
    initial_resume: int | None = None
    #           ^ iteration a PRE-EXISTING checkpoint supplied to the
    #             first attempt (explicit resume=True only)
    total_iters: int = 0
    segments: int = 0
    counters: dict | None = None
    #           ^ the iteration counters' digest (IterStats.summary)
    topology: list = dataclasses.field(default_factory=list)
    #           ^ one entry per elastic mesh shrink (ROADMAP A6b-2)

    def as_dict(self) -> dict:
        return dict(attempts=self.attempts, segments=self.segments,
                    resumed_from=list(self.resumed_from),
                    initial_resume=self.initial_resume,
                    failures=[list(f) for f in self.failures],
                    total_iters=self.total_iters,
                    counters=self.counters,
                    topology=[dict(t) for t in self.topology])


def _flight_dump(exc: BaseException, kind: str) -> None:
    """Dump the installed flight recorder (tracing.py) with the failure
    as its reason; best effort: a postmortem writer must never mask the
    fault it records (lux_tpu/resilience.py:298-309)."""
    try:
        from lux_tpu_torch import tracing
        tracing.flight_dump(reason=f"{type(exc).__name__}: {exc}"[:300],
                            classification=kind)
    except Exception:           # noqa: BLE001 — see docstring
        pass


def _attach_counters(report) -> None:
    """The active iter-stats digest into ``report.counters``."""
    st = telemetry.current().iter_stats
    if st is not None:
        report.counters = st.summary()


def supervise(attempt: Callable, policy: RetryPolicy | None = None,
              report: RunReport | None = None, on_topology=None):
    """Run ``attempt(k)`` (k = 0-based attempt index) under classified
    retries: retryable failures back off and retry, fatal ones (and
    the retry budget's exhaustion) re-raise.  Returns (result, report).
    ``on_topology(exc)`` may re-place the run after a TOPOLOGY failure
    and return True (the next attempt then proceeds without backoff);
    without a handler a topology fault is fatal."""
    policy = policy or RetryPolicy()
    report = report or RunReport()
    tel = telemetry.current()
    for k in range(max(0, policy.retries) + 1):
        report.attempts += 1
        try:
            return attempt(k), report
        except Exception as e:      # noqa: BLE001 — classified below
            kind = classify(e)
            report.failures.append((type(e).__name__, str(e)[:200], kind))
            handled = False
            if (kind == TOPOLOGY and on_topology is not None
                    and k < policy.retries):
                handled = bool(on_topology(e))
            if kind == TOPOLOGY:
                tel.emit("topology_fault", attempt=k,
                         error=type(e).__name__, message=str(e)[:200],
                         handled=handled)
                # after the event, so the ring holds it
                _flight_dump(e, kind)
            fatal = (kind == FATAL
                     or (kind == TOPOLOGY and not handled)
                     or k >= policy.retries)
            if fatal:
                tel.emit("failure", attempt=k, error=type(e).__name__,
                         message=str(e)[:200], classification=kind)
                if kind != TOPOLOGY:        # topology already dumped
                    _flight_dump(e, kind)
                raise
            if kind == TOPOLOGY:
                continue            # re-placed: retry at once
            d = policy.delay_s(k)
            tel.emit("retry", attempt=k, error=type(e).__name__,
                     message=str(e)[:200], classification=kind,
                     backoff_s=round(d, 3))
            policy.sleep(d)
    raise AssertionError("unreachable")


def _make_segment(segment, seg_budget):
    if seg_budget:
        from lux_tpu_torch.segmented import DurationBudget
        return DurationBudget(float(seg_budget))
    return segment


def _refuse_unported(elastic, heartbeat) -> None:
    from lux_tpu_torch.engine.pull import NotPortedError
    if elastic is not None:
        raise NotPortedError("elastic re-placement after a topology "
                             "fault (elastic=) is not ported yet (ROADMAP "
                             "A6b-2)")
    if heartbeat is not None:
        raise NotPortedError("per-segment heartbeat supervision "
                             "(heartbeat=) is not ported yet (ROADMAP A6b-2)")


def _int_sentinel(eng):
    """The integer identity of the engine's program (faults'
    corrupt_state pokes it into integer labels); None for float
    programs."""
    ident = getattr(getattr(eng, "program", None), "identity", None)
    if ident is None:
        return None
    ident = np.asarray(ident)
    return int(ident) if np.issubdtype(ident.dtype, np.integer) else None


def _record_resume(path, report):
    """The iteration the resume will ACTUALLY continue from (the .prev
    one when the newest is corrupt; load_any quarantines it, so the
    fallback is detected and reported once)."""
    from lux_tpu_torch import checkpoint

    if checkpoint.any_generation(path):
        try:
            _leaves, meta, _used = checkpoint.load_any(path)
            report.resumed_from.append(int(meta.get("iter", 0)))
        except Exception:           # noqa: BLE001 — all gens corrupt
            pass                    # the attempt itself will surface it


def supervised_run(eng, num_iters: int, path: str, *,
                   policy: RetryPolicy | None = None,
                   segment=50, seg_budget: float | None = None,
                   resume: bool = False, faults=None,
                   guard: bool = True, report: RunReport | None = None,
                   elastic=None, heartbeat=None):
    """Supervised pull-engine fixed-iteration run: segmented and
    checkpointed to ``path``, classified retries resuming from the last
    atomic checkpoint.  Returns (state, report).

    ``resume=False`` starts fresh (a stale file at ``path`` is
    removed); retries within the run always resume.  ``faults``
    (faults.FaultPlan) and the finite ``guard`` run at each boundary
    BEFORE the save, so corruption never reaches a checkpoint; an
    engine built with ``health=True`` also decodes its watchdog word
    there (segmented.py)."""
    from lux_tpu_torch import checkpoint, debug

    _refuse_unported(elastic, heartbeat)
    report = report or RunReport()
    if not resume:
        checkpoint.remove(path)
    if faults is not None and hasattr(faults, "bind_checkpoint"):
        faults.bind_checkpoint(path)
    # one segment sizer for the whole run: a budget's learned rate
    # survives retries
    seg = _make_segment(segment, seg_budget)

    def hook(s, done):
        report.segments += 1
        out = None
        if faults is not None:
            # a corrupting fault pokes the state in place on the device
            # and returns it: the run continues with it
            res = faults.fire(s, int_value=_int_sentinel(eng))
            if res is not None:
                s = out = res
        if guard:
            debug.check_finite(s, f"supervised pull run @ iteration "
                                  f"{done}")
        return out

    def attempt(k):
        do_resume = resume or k > 0
        if do_resume:
            _record_resume(path, report)
            if k == 0 and report.resumed_from:
                report.initial_resume = report.resumed_from[0]
        return checkpoint.run_checkpointed(
            eng, eng.init_state(), num_iters, path, segment=seg,
            resume=do_resume, on_segment=hook)

    state, report = supervise(attempt, policy, report)
    report.total_iters = num_iters
    _attach_counters(report)
    return state, report


def supervised_converge(eng, path: str, *,
                        policy: RetryPolicy | None = None,
                        segment=50, seg_budget: float | None = None,
                        resume: bool = False,
                        max_iters: int | None = None, faults=None,
                        guard: bool = True,
                        report: RunReport | None = None,
                        elastic=None, heartbeat=None):
    """Supervised push-engine convergence: segmented and checkpointed
    to ``path``, classified retries resuming from the last atomic
    checkpoint.  Returns (label, active, total_iters, report).  The
    boundary guard allows +inf (the unreached sentinel); NaN raises
    DivergenceError, which is retryable (the checkpoint predates
    it)."""
    from lux_tpu_torch import checkpoint, debug

    _refuse_unported(elastic, heartbeat)
    report = report or RunReport()
    if not resume:
        checkpoint.remove(path)
    if faults is not None and hasattr(faults, "bind_checkpoint"):
        faults.bind_checkpoint(path)
    seg = _make_segment(segment, seg_budget)

    def hook(lbl, act, total, cnt):
        report.segments += 1
        out = None
        if faults is not None:
            res = faults.fire((lbl, act), int_value=_int_sentinel(eng))
            if res is not None:
                lbl, act = out = tuple(res)
        if guard:
            debug.check_finite(
                lbl, f"supervised converge @ iteration {total}",
                allow_inf=True)
        return out

    def attempt(k):
        do_resume = resume or k > 0
        if do_resume:
            _record_resume(path, report)
            if k == 0 and report.resumed_from:
                report.initial_resume = report.resumed_from[0]
        return checkpoint.converge_checkpointed(
            eng, path, segment=seg, resume=do_resume,
            max_iters=max_iters, on_segment=hook)

    (label, active, total), report = supervise(attempt, policy, report)
    report.total_iters = total
    _attach_counters(report)
    return label, active, total, report


def screen_outliers(samples, rerun: Callable[[], float] | None,
                    factor: float = 3.0):
    """The bench's discard-and-rerun rule: a sample more than
    ``factor``x off its batch's median is a collapse, not a
    measurement — it is discarded and re-run ONCE, and the discards are
    reported.  Returns (kept_samples, discarded, attempts), attempts
    counting every timed run.  factor <= 0 disables screening."""
    tel = telemetry.current()
    samples = list(samples)
    attempts = len(samples)
    if len(samples) < 2 or not factor or factor <= 0:
        return samples, [], attempts
    m = median(samples)

    def is_outlier(s):
        return s < m / factor or s > m * factor

    kept = [s for s in samples if not is_outlier(s)]
    discarded = [s for s in samples if is_outlier(s)]
    if not kept:        # mutual disagreement: nothing to trust more
        return samples, [], attempts
    for d in list(discarded):
        tel.emit("outlier_discard", sample=round(d, 6),
                 median=round(m, 6), factor=factor)
        if rerun is None:
            continue
        s = rerun()
        attempts += 1
        if is_outlier(s):
            discarded.append(s)
        else:
            kept.append(s)
        tel.emit("outlier_rerun", sample=round(s, 6),
                 kept=not is_outlier(s))
    return kept, discarded, attempts
