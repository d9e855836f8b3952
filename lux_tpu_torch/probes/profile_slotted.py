"""Counterpart of scripts/profile_slotted.py: the slotted positional
layout's padding on the host, and the step core it enables on the card.

    python3 -m lux_tpu_torch.probes.profile_slotted [--scale S] \
        [--device cpu] [--small]

1. Host: the k-slot layout's padding inflation (K = 8 slots, W = 128
   lanes a tile) on R-MAT ``--scale`` (default 21; ``--small``: 10),
   edge factor 16, seed 0, built by the port's ``convert.rmat_edges``
   and ``Graph``, unsorted and with in-degrees sorted; C is the sorted
   layout's chunk count rounded up to 64.
2. Card: slots [C, K, W] int32 uniform over the vertices, a state of
   2^scale f32 in [0, 1), start with probability 0.3 and on row 0,
   drawn from ``np.random.default_rng(0)`` in the script's order.  The
   script's XLA lines (gather + sum, gather alone, gather + sum of a
   bf16 state) are plain torch ops here (``index_select`` and ``sum``),
   as the script leaves them to XLA outside any kernel; its Pallas
   ``carry`` is S7, ``carry_combine`` (csrc/carry.cu), checked against
   its plain version before it is timed; the last line is the gather,
   sum and carry together.

Rates are GTEPS-equivalent: the graph's edges over the time.  Then one
JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.carry import carry_combine, carry_combine_plain
from lux_tpu_torch.probes import max_abs_err, parser, timeit

SCALE = 21
SMALL_SCALE = 10
EF = 16
K = 8
W = 128
WIDTH = 42          # the script's name column


def inflation(indeg, sort: bool, k: int = K, w: int = W):
    """(slots over edges, chunks) of the k-slot layout: tiles of w
    vertices (in-degrees sorted descending when ``sort``), each taking
    ceil(max in-degree / k) chunks, at least one."""
    d = np.sort(indeg)[::-1] if sort else np.asarray(indeg)
    ntile = (len(d) + w - 1) // w
    pad = np.zeros(ntile * w, dtype=np.int64)
    pad[:len(d)] = d
    tiles = pad.reshape(ntile, w)
    chunks = np.maximum(1, -(-tiles.max(axis=1) // k))
    slots = int(chunks.sum()) * k * w
    return slots / int(indeg.sum()), int(chunks.sum())


def host_half(indeg) -> dict:
    """The script's host lines; returns both layouts' figures and C."""
    out = {}
    for sort in (False, True):
        inf, chunks = inflation(indeg, sort)
        print(f"sorted={sort}: slot inflation {inf:.3f}x, chunks={chunks}",
              flush=True)
        out["sorted" if sort else "unsorted"] = {"inflation": inf,
                                                 "chunks": chunks}
    out["C"] = -(-out["sorted"]["chunks"] // 64) * 64
    return out


def make_inputs(C: int, V: int) -> dict:
    """The script's card arrays: slots [C, K, W] int32, state [V] f32,
    start [C, 1] int32."""
    rng = np.random.default_rng(0)
    slots = rng.integers(0, V, (C, K, W)).astype(np.int32)
    state = rng.random(V, np.float32)
    starts = rng.random(C) < 0.3
    starts[0] = True
    return {"slots": slots, "state": state,
            "start": starts.astype(np.int32).reshape(C, 1)}


def main(argv=None, graph=None, inputs=None) -> dict:
    """Run the probe on ``graph`` (R-MAT ``--scale``, made here when
    None) and ``inputs`` (``make_inputs``' arrays, made here when
    None); returns the JSON line's dict."""
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=None,
                    help=f"R-MAT scale (default {SCALE}, {SMALL_SCALE} "
                         f"with --small)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scale = args.scale or (SMALL_SCALE if args.small else SCALE)
    if graph is None:
        from lux_tpu_torch.convert import rmat_graph
        graph = rmat_graph(scale, EF, seed=0)
    if graph.nv != 1 << scale:
        raise ValueError(f"graph has {graph.nv} vertices, not 2^{scale}")
    host = host_half(graph.in_degrees())
    C = host["C"]
    h = make_inputs(C, graph.nv) if inputs is None else inputs
    if h["slots"].shape != (C, K, W):
        raise ValueError(f"slots {h['slots'].shape} are not [{C}, {K}, {W}]")
    slots = torch.from_numpy(h["slots"]).to(dev).reshape(-1)
    state = torch.from_numpy(h["state"]).to(dev)
    start = torch.from_numpy(h["start"]).to(dev)
    state_bf16 = state.to(torch.bfloat16)

    def gather_sum(s):
        return torch.index_select(s, 0, slots).view(C, K, W).sum(dim=1)

    lines = []

    def line(name, fn):
        lines.append(timeit(name, fn, graph.ne, "GTEPS-equiv", WIDTH, dev))

    line("gather+sum (index_select + sum)", lambda: gather_sum(state))
    line("gather only (materialized)",
         lambda: torch.index_select(state, 0, slots))
    line("gather+sum bf16 state", lambda: gather_sum(state_bf16))
    partials = gather_sum(state)
    err = max_abs_err(carry_combine(partials, start),
                      carry_combine_plain(partials, start))
    line("carry combine [C,W]: carry_combine",
         lambda: carry_combine(partials, start))
    lines[-1]["max_abs_err"] = err
    line("gather+sum+carry", lambda: carry_combine(gather_sum(state), start))
    out = {"probe": "profile_slotted", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "scale": scale, "ne": graph.ne, "host": host,
           "shape": [C, K, W], "lines": lines}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
