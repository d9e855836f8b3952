"""Segmented execution drivers (counterpart of lux_tpu/segmented.py:133
``run_segments`` and :209 ``converge_segments``).

An engine runs in host-visible slices of ``segment`` iterations; after
each slice an ``on_segment`` hook may return a replacement state to
continue with (the serving layer's retire-and-refill), return None to
keep the current state, or raise to stop.  With an active telemetry
handle (telemetry.use) every slice emits a ``segment`` event with its
seconds, fenced by a device synchronize.

Not ported yet: a ``DurationBudget`` as the segment (ROADMAP A9), the
health watchdog variants (``eng.health``, A9), the memory trail
(``mem=``, A10) and the device-side iteration counters (A10).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from lux_tpu_torch import telemetry
from lux_tpu_torch.engine.pull import NotPortedError


class DurationBudget:
    """Adaptive segment sizing against a duration budget: not ported
    (ROADMAP A9; its 45 s default answers a TPU-tunnel limit, and the
    port's must be set by measurement on the card)."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError("DurationBudget (duration-budgeted segments) "
                             "is not ported yet (ROADMAP A9); pass an "
                             "int segment size")


def _check(eng, segment, mem) -> int:
    if mem is not None:
        raise NotPortedError("the memory trail (mem=) is not ported yet "
                             "(ROADMAP A10)")
    if getattr(eng, "health", False):
        raise NotPortedError("the health watchdog variants (eng.health) "
                             "are not ported yet (ROADMAP A9)")
    if isinstance(segment, bool) or not isinstance(segment,
                                                   (int, np.integer)):
        raise NotPortedError(f"segment {segment!r}: only an int segment "
                             f"size is ported (DurationBudget is ROADMAP "
                             f"A9)")
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    return int(segment)


def _fence(x) -> None:
    """Wait for the device work behind ``x`` (a no-op on the CPU)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def run_segments(eng, state, num_iters: int, segment,
                 on_segment: Callable | None = None,
                 start_iter: int = 0, mem=None):
    """Run a pull engine ``num_iters`` iterations in slices of
    ``segment``.  ``on_segment(state, done_iters)`` runs after each
    slice and may return a replacement state.  Returns the state."""
    seg = _check(eng, segment, mem)
    tel = telemetry.current()
    timed = tel.events is not None
    done = int(start_iter)
    while done < num_iters:
        n = min(seg, num_iters - done)
        t0 = time.perf_counter()
        state = eng.run(state, n)
        if timed:
            _fence(state)
        dt = time.perf_counter() - t0
        done += n
        if timed:
            tel.emit("segment", engine="pull", n=n, done=done,
                     seconds=round(dt, 6))
        if on_segment is not None:
            res = on_segment(state, done)
            if res is not None:
                state = res
    return state


def converge_segments(eng, label, active, segment,
                      max_iters: int | None = None,
                      on_segment: Callable | None = None,
                      start_iter: int = 0, mem=None):
    """Run a push engine to convergence in slices of ``segment``
    iterations.  ``on_segment(label, active, total_iters,
    active_count)`` runs after each slice and may return a replacement
    ``(label, active)`` or raise to stop.  Convergence is read from the
    active mask (one int32 read a slice), never from iteration counts.
    Returns (label, active, total_iters)."""
    seg = _check(eng, segment, mem)
    tel = telemetry.current()
    total = int(start_iter)
    cap = np.iinfo(np.int32).max if max_iters is None else int(max_iters)
    while total < cap:
        n = min(seg, cap - total)
        t0 = time.perf_counter()
        label, active, it = eng.converge(label, active, n)
        cnt = int(active.sum(dtype=torch.int32))    # the fence, O(1) B
        dt = time.perf_counter() - t0
        total += it
        tel.emit("segment", engine="push", iters=it, total=total,
                 active=cnt, seconds=round(dt, 6))
        if on_segment is not None:
            res = on_segment(label, active, total, cnt)
            if res is not None:
                label, active = res
                cnt = int(active.sum(dtype=torch.int32))
        if cnt == 0:
            break
    return label, active, total
