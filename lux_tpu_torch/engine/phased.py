"""Per-iteration phase timing shared by the engines' ``timed_phases``
(counterpart of lux_tpu/engine/phased.py:53 ``PhaseTimer``, as
lux_tpu/engine/pull.py:1397 ``timed_phases`` uses it).

Each phase is a plain method of the eager engine, run on its own and
fenced (``profiling.device_fence``: a device synchronize on the card,
nothing on the CPU), so one phase's time holds its own kernels and
none of the next's.  The split adds a synchronize and a host return
per phase that the plain run does not make: read the phases for their
relative weight, and the fused step's time for the rate.
"""

from __future__ import annotations

import time

from lux_tpu_torch.profiling import annotation


class PhaseTimer:
    """Runs phases one at a time, recording wall seconds per name in
    ``t``.  ``fence`` is a zero-argument function that waits for the
    device's queued work."""

    def __init__(self, fence):
        self._fence = fence
        self.t: dict = {}

    def __call__(self, name: str, fn, *args):
        with annotation(f"lux_phase_{name}"):
            t0 = time.perf_counter()
            out = fn(*args)
            self._fence()
            self.t[name] = time.perf_counter() - t0
        return out
