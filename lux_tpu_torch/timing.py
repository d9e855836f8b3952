"""Timed runs with completion fences (counterpart of
lux_tpu/timing.py:51 ``fence`` and :113 ``timed_fused_run``).

PyTorch returns before the card finishes, so a host clock without a
fence measures the enqueue.  On the card a run is timed with CUDA
events recorded on the stream around it; on the CPU (eager ops have
finished when they return) with the host clock.  Outputs never leave
the device inside a timed region.
"""

from __future__ import annotations

import time

import torch


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
