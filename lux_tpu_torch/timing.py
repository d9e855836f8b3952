"""Timed runs with completion fences (counterpart of
lux_tpu/timing.py:51 ``fence``, :69 ``loop_bench``, :113
``timed_fused_run`` and :174 ``timed_converge``), and ``median_mad``.
Under ``telemetry.use(iter_stats=)`` the timed runs are the engines'
counter variants, their counters fetched after the clock stops.

PyTorch returns before the card finishes, so a host clock without a
fence measures the enqueue.  On the card a run is timed with CUDA
events recorded on the stream around it; on the CPU (eager ops have
finished when they return) with the host clock.  Outputs never leave
the device inside a timed region.
"""

from __future__ import annotations

import statistics
import time

import torch

from lux_tpu_torch.device import resolve_device


def fence(device: torch.device) -> None:
    """Wait until all work queued on ``device`` has finished (a no-op
    on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed(dev, fn):
    """(fn(), seconds): CUDA events around ``fn`` on the card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def timed_fused_run(eng, num_iters: int, trace_dir: str | None = None):
    """Warm up ``eng`` with one untimed run of the same length, then
    time one run of ``num_iters`` iterations from a fresh
    ``init_state`` whose upload is fenced outside the timed region.
    Returns (final_state, seconds).

    Under ``telemetry.use(iter_stats=)`` the timed run is
    ``eng.run_stats`` (guarded engines: ``run_health``, whose buffers
    hold the same counters) and its counters are fetched after the
    clock stops, so the fetch is never billed.  ``trace_dir`` captures
    the timed run alone in a profiler trace (profiling.trace).  The
    timed run emits a ``timed_run`` event (reference
    lux_tpu/timing.py:121-175)."""
    from lux_tpu_torch import telemetry
    from lux_tpu_torch.profiling import step_annotation, trace

    tel = telemetry.current()
    st = tel.iter_stats
    guarded = getattr(eng, "health", False)
    dev = eng.device

    def one(state):
        if guarded:
            s, _it, rb, cb, rbp, cbp, watch = eng.run_health(state,
                                                             num_iters)
            return s, (rb, cb, rbp, cbp), watch
        if st is not None:
            s, *bufs = eng.run_stats(state, num_iters)
            return s, tuple(bufs), None
        return eng.run(state, num_iters), None, None

    one(eng.init_state())
    state = eng.init_state()
    fence(dev)
    with trace(trace_dir, dev):
        with step_annotation("lux_timed_run", 0):
            (state, bufs, watch), seconds = _elapsed(dev,
                                                     lambda: one(state))
    tel.emit("timed_run", repeat=0, iters=num_iters,
             seconds=round(seconds, 6))
    if guarded:
        from lux_tpu_torch import health
        tel.emit("health", **health.ensure_ok(
            watch, engine="pull", where="timed pull run"), iters=num_iters)
    if st is not None:
        st.begin_run()          # the counters of the timed run alone
        st.extend_pull(bufs[0], bufs[1], num_iters, bufs[2], bufs[3])
    return state, seconds


def timed_run_until(eng, tol: float, max_iters: int,
                    trace_dir: str | None = None):
    """Warm up a pull engine with one untimed iteration, then time one
    ``run_until(tol, max_iters)`` from a fresh ``init_state`` whose
    upload is fenced outside the timed region (the reference's
    lux_tpu/timing.py ``timed_run_until``; guarded engines take
    ``run_until_health`` and decode its word after the clock stops).
    Returns (state, iterations, final residual, seconds)."""
    from lux_tpu_torch import telemetry
    from lux_tpu_torch.profiling import step_annotation, trace

    dev = eng.device
    guarded = getattr(eng, "health", False)

    def one(state, cap):
        if guarded:
            s, it, res, *_bufs, watch = eng.run_until_health(state, tol,
                                                             cap)
            return s, it, res, watch
        s, it, res = eng.run_until(state, tol, cap)
        return s, it, res, None

    one(eng.init_state(), 1)
    state = eng.init_state()
    fence(dev)
    with trace(trace_dir, dev):
        with step_annotation("lux_timed_run", 0):
            (state, it, res, watch), seconds = _elapsed(
                dev, lambda: one(state, max_iters))
    tel = telemetry.current()
    tel.emit("timed_run", repeat=0, iters=int(it), seconds=round(seconds, 6))
    if guarded:
        from lux_tpu_torch import health
        tel.emit("health", **health.ensure_ok(
            watch, engine="pull", where="timed pull run_until"),
            iters=int(it))
    return state, int(it), float(res), seconds


def timed_converge(eng, max_iters=None, repeats: int = 1,
                   verbose: bool = False, trace_dir: str | None = None):
    """Warm up a push engine with one untimed converge, then time
    ``repeats`` converges (guarded when ``eng.health``), each from a
    fresh ``init_state`` whose upload is fenced outside the timed
    region.  A converge reads a count to the host every iteration, so
    its host wall time, fenced at the end, is the run's time.  Returns
    (labels [nv] host, iterations, [seconds per repeat]).

    ``verbose`` replays the warm-up's per-iteration frontier counters
    (``eng.run(verbose=True)``) when no iter-stats handle is active;
    under ``telemetry.use(iter_stats=)`` the timed converges are
    ``converge_stats`` and the last one's counters are fetched after
    its clock stops.  ``trace_dir`` captures the timed converges alone
    in a profiler trace.  Each emits a ``timed_run`` event (reference
    lux_tpu/timing.py:178-228)."""
    from lux_tpu_torch import telemetry
    from lux_tpu_torch.profiling import step_annotation, trace

    tel = telemetry.current()
    st = tel.iter_stats
    guarded = getattr(eng, "health", False)
    dev = eng.device

    def one(label, active):
        if guarded:
            return eng.converge_health(label, active, max_iters)
        if st is not None:
            return (*eng.converge_stats(label, active, max_iters), None)
        return (*eng.converge(label, active, max_iters),) + (None,) * 5

    if verbose and st is None:
        eng.run(max_iters=max_iters, verbose=True)
    else:
        one(*eng.init_state())
    fence(dev)
    elapsed = []
    with trace(trace_dir, dev):
        for i in range(repeats):
            label, active = eng.init_state()
            fence(dev)
            with step_annotation("lux_timed_converge", i):
                t0 = time.perf_counter()
                label, _active, it, fsz, fed, fszp, fedp, watch = one(
                    label, active)
                fence(dev)
                elapsed.append(time.perf_counter() - t0)
            tel.emit("timed_run", repeat=i, iters=it,
                     seconds=round(elapsed[-1], 6))
    if guarded:
        from lux_tpu_torch import health
        tel.emit("health", **health.ensure_ok(
            watch, engine="push", where="timed converge"), iters=it)
    if st is not None:
        st.begin_run()
        st.extend_push(fsz, fed, it, fszp, fedp)
    return eng.unpad(label), it, elapsed


def median_mad(xs):
    """(median, median absolute deviation) of ``xs`` — the robust pair
    the probes report instead of mean and stdev (counterpart of
    lux_tpu/observe.py:118 ``median_mad``)."""
    xs = list(xs)
    if not xs:
        raise ValueError("median_mad of an empty sample set")
    m = statistics.median(xs)
    return m, statistics.median(abs(x - m) for x in xs)


def loop_bench(fn, k: int, repeats: int = 3, device=None, clock=None):
    """Seconds per call of ``fn()``: one warm-up call, then ``repeats``
    samples of ``k`` calls each, on ``device`` (None means the card, as
everywhere in the port) (counterpart of lux_tpu/timing.py:69
    ``loop_bench``).  The reference threads a loop-dependent carry
    through one ``fori_loop`` so that XLA cannot hoist the work; eager
    PyTorch hoists nothing, so ``k`` plain calls stand in for it.  On
    the card each sample is two CUDA events around the ``k`` calls; on
    the CPU the host clock.  ``clock`` (a host clock, e.g. a
    deterministic one in tests) times every sample instead, the device
    fenced before each reading.  Returns the list of per-call seconds,
    one entry a sample."""
    dev = resolve_device(device)
    if k < 1 or repeats < 1:
        raise ValueError(f"loop_bench needs k >= 1 and repeats >= 1 "
                         f"(got k={k}, repeats={repeats})")
    fn()
    fence(dev)
    samples = []
    for _ in range(repeats):
        if clock is not None:
            t0 = clock()
            for _ in range(k):
                fn()
            fence(dev)
            samples.append((clock() - t0) / k)
        elif dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / k)
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            samples.append((time.perf_counter() - t0) / k)
    return samples
