"""Profiling and named ranges (counterpart of lux_tpu/profiling.py).

- ``trace(log_dir)``: one ``torch.profiler.profile`` session (host
  ranges, and the card's kernels and copies on CUDA) around the block,
  exported as a Chrome trace, ``<log_dir>/trace.json``, that
  chrome://tracing and ui.perfetto.dev load.  One session a trace: a
  session that follows many others has been seen to drop launches.
- ``annotation(name)`` / ``step_annotation(name, step)``: a
  ``torch.profiler.record_function`` range, entered only while a
  profiler is recording.  ``record_function`` is a dispatcher op even
  with no profiler on, and the engines enter several ranges an
  iteration, so outside a trace these are a ``nullcontext``.  The
  engines name their device-side work with the reference's names: pull
  ``lux_exchange`` / ``lux_gather`` / ``lux_reduce`` / ``lux_apply``
  (``lux_gather_reduce`` for paged steps, ``lux_dot_reduce`` on the
  dot path), push ``lux_dense`` / ``lux_sparse`` with ``lux_exchange``
  / ``lux_relax`` / ``lux_reduce`` / ``lux_update`` inside, and one
  ``lux_<program>`` range a step; the run paths add ``lux_segment``,
  ``lux_timed_run``, ``lux_checkpoint_save`` and the phase timers'
  ``lux_phase_<name>``.
- ``PhaseTimer``: named host phases (load / build / iterate) with
  completion fences, printed like the reference's
  loadTime/compTime/updateTime table.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def active() -> bool:
    """Whether a torch profiler is recording on this thread."""
    return torch.autograd._profiler_enabled()


def annotation(name: str):
    """A named profiler range, or a ``nullcontext`` when no profiler is
    recording (then it costs one flag read)."""
    if active():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def step_annotation(name: str, step: int):
    """A numbered range (segments and repeats show as ``name#step``)."""
    return annotation(f"{name}#{int(step)}")


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Capture one profiler session into ``<log_dir>/trace.json`` (a
    no-op without ``log_dir``).  The card's activity is recorded when
    ``device`` (default: CUDA if available) is a CUDA device; the
    session is fenced on it before it closes.  Yields the profiler
    (None when disabled)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def device_fence(device):
    """A function that waits for the work queued on ``device``:
    ``torch.cuda.synchronize`` on the card, nothing on the CPU (eager
    CPU ops have finished when they return)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


class _Phase:
    """Set ``.fence`` to a tensor made inside the block to wait for it
    before the phase's clock stops."""

    def __init__(self):
        self.fence = None


class PhaseTimer:
    """Named phase wall clocks with completion fences.

    >>> pt = PhaseTimer()
    >>> with pt.phase("load"):
    ...     g = Graph.from_file(...)
    >>> with pt.phase("iterate") as ph:
    ...     state = eng.run(state, 10)
    ...     ph.fence = state
    >>> pt.report()
    """

    def __init__(self):
        self.phases: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        h = _Phase()
        with annotation(f"lux_phase_{name}"):
            t0 = time.perf_counter()
            yield h
            f = fence() if callable(fence) else fence
            for val in (f, h.fence):
                if isinstance(val, torch.Tensor) \
                        and val.device.type == "cuda":
                    torch.cuda.synchronize(val.device)
            self.phases.append((name, time.perf_counter() - t0))

    def report(self, file=None) -> list[tuple[str, float]]:
        """Print the phase table and return the (name, seconds) list."""
        total = sum(t for _, t in self.phases)
        for name, t in self.phases:
            print(f"  {name:<12s} {t:8.3f} s "
                  f"({100 * t / max(total, 1e-12):5.1f}%)", file=file)
        print(f"  {'total':<12s} {total:8.3f} s", file=file)
        return list(self.phases)
