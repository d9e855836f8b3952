"""Timed runs with completion fences (counterpart of
lux_tpu/timing.py:51 ``fence``, :69 ``loop_bench``, :113
``timed_fused_run`` and :174 ``timed_converge``), and ``median_mad``.

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


def timed_fused_run(eng, num_iters: int):
    """Warm up ``eng`` with one untimed run of the same length, then
    time one run of ``num_iters`` iterations from a fresh
    ``init_state`` whose upload is fenced outside the timed region.
    Returns (final_state, seconds)."""
    dev = eng.device
    eng.run(eng.init_state(), num_iters)
    state = eng.init_state()
    fence(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = eng.run(state, num_iters)
        end.record()
        end.synchronize()
        return state, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    state = eng.run(state, num_iters)
    return state, time.perf_counter() - t0


def timed_converge(eng, max_iters=None, repeats: int = 1):
    """Warm up a push engine with one untimed converge, then time
    ``repeats`` converges, each from a fresh ``init_state`` whose
    upload is fenced outside the timed region.  A converge reads a
    count to the host every iteration, so its host wall time, fenced
    at the end, is the run's time.  Returns (labels [nv] host,
    iterations, [seconds per repeat])."""
    dev = eng.device
    eng.converge(*eng.init_state(), max_iters)
    fence(dev)
    elapsed = []
    for _ in range(repeats):
        label, active = eng.init_state()
        fence(dev)
        t0 = time.perf_counter()
        label, _active, it = eng.converge(label, active, max_iters)
        fence(dev)
        elapsed.append(time.perf_counter() - t0)
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


def loop_bench(fn, k: int, repeats: int = 3, device=None):
    """Seconds per call of ``fn()``: one warm-up call, then ``repeats``
    samples of ``k`` calls each, on ``device`` (None means the card, as
everywhere in the port) (counterpart of lux_tpu/timing.py:69
    ``loop_bench``).  The reference threads a loop-dependent carry
    through one ``fori_loop`` so that XLA cannot hoist the work; eager
    PyTorch hoists nothing, so ``k`` plain calls stand in for it.  On
    the card each sample is two CUDA events around the ``k`` calls; on
    the CPU the host clock.  Returns the list of per-call seconds, one
    entry a sample."""
    dev = resolve_device(device)
    if k < 1 or repeats < 1:
        raise ValueError(f"loop_bench needs k >= 1 and repeats >= 1 "
                         f"(got k={k}, repeats={repeats})")
    fn()
    fence(dev)
    samples = []
    for _ in range(repeats):
        if dev.type == "cuda":
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
