"""lux_tpu_torch — the PyTorch / CUDA (H100) port of lux_tpu.

A second package beside ``lux_tpu``, which stays the reference.  It
imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``lux_tpu`` — and mirrors the reference's module layout so each module's
counterpart is easy to find:

  format.py       .lux binary CSC file format (read/write/peek/validate)
  convert.py      edge list -> .lux, R-MAT generator
  partition.py    edge-balanced contiguous vertex partitioner
  graph.py        host Graph + padded part-major ShardedGraph layout
  ops/            segment oracle, tiled chunk layout, chunk_partials
                  (hand-written CUDA kernel, csrc/chunk_partials.cu),
                  paged / page-major gather with lane_shuffle
                  (csrc/lane_shuffle.cu) and the row-class combine;
                  the probe kernels carry / fused_carry, onehot_reduce
                  and transposed_reduce (csrc/carry.cu, fused_carry.cu,
                  onehot_mma.cu, transposed_reduce.cu); the matrix-unit
                  (use_mxu) forms in tiled.py, onehot_reduce on a
                  system path
  engine/         vertex-program bundle, the pull and push engines,
                  phased.py (timed_phases' PhaseTimer)
  apps/           PageRank
  timing.py       CUDA-event timed runs, loop_bench, median_mad
  probes/         counterparts of the TPU probe scripts
                  (profile_kernel, profile_slotted, profile_v3)
  check.py        host correctness audit
  cli.py          python -m lux_tpu_torch.cli {pagerank,sssp,components,
                  colfilter,convert}
  interop.py      carry arrays, state and health watches across from
                  the reference
  health.py       the device health watchdog word (guarded runs)
  debug.py        host-side finite and stall guards
  checkpoint.py   CRC-checked two-generation checkpoints (the
                  reference's file format)
  segmented.py    segmented drivers, DurationBudget
  faults.py       deterministic fault injection
  resilience.py   failure classification, supervised retry / resume
  telemetry.py    event log, iteration counters (IterStats), observers
  profiling.py    torch.profiler traces and the engines' named ranges
  tracing.py      span export (Chrome trace) and the flight recorder
  memwatch.py     memory trail, byte ledger, drift verdicts
  scalemodel.py   the cost model on the card's measured constants
  observe.py      session calibration, phase attribution, perf ledger
                  (python -m lux_tpu_torch.observe)
  livegraph.py    live graphs: the mutation log (WAL), epochs and delta
                  blocks, the delta relax, re-seed, compaction, recovery

Not ported yet: the serving fleet and its admission journal
(``lux_tpu_torch.fleet`` / ``.journal`` raise NotPortedError naming
ROADMAP A11b).

Every entry point runs on the card unless the caller passes
``device="cpu"`` (device.py).  Host planning stays numpy, as in the
reference; per-iteration work is torch tensors on the chosen device.
"""

__version__ = "0.1.0"

from lux_tpu_torch.device import DeviceUnavailableError, resolve_device
from lux_tpu_torch.format import GraphFormatError
from lux_tpu_torch.graph import Graph, ShardedGraph

__all__ = ["DeviceUnavailableError", "GraphFormatError", "Graph",
           "ShardedGraph", "resolve_device"]

# the reference's modules that have no counterpart yet
_NOT_PORTED = {"fleet": "A11b", "journal": "A11b"}


def __getattr__(name: str):
    item = _NOT_PORTED.get(name)
    if item is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from lux_tpu_torch.engine.pull import NotPortedError
    raise NotPortedError(f"lux_tpu_torch.{name} (lux_tpu/{name}.py) is not "
                         f"ported yet (ROADMAP {item})")
