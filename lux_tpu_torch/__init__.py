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
                  system path; the streamed chunk blocks (tiled.py)
                  and the owner exchange's layout (owner.py)
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
  heartbeat.py    the replica board and the workers' heartbeat sync
  journal.py      the fleet's durable admission journal (LUXJ)
  fleet.py        the serving fleet: replicas (in-process and
                  subprocess), admission and typed sheds, failover,
                  brownout, self-healing, whole-fleet crash recovery
                  (python -m lux_tpu_torch.fleet)

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
