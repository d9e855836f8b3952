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
                  (csrc/lane_shuffle.cu) and the row-class combine
  engine/         vertex-program bundle and the pull engine
  apps/           PageRank
  timing.py       CUDA-event timed runs
  check.py        host correctness audit
  cli.py          python -m lux_tpu_torch.cli {pagerank,convert}
  interop.py      carry arrays and state across from the reference

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
