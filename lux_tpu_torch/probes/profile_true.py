"""Counterpart of scripts/profile_true.py: the architecture-selection
microbenchmarks, timed on the card at the script's shapes.

    python3 -m lux_tpu_torch.probes.profile_true [--device cpu] [--small]

The script's six lines, from ``np.random.default_rng(0)`` drawn in its
order (``--small`` cuts every shape):
1. gather of N = 2^25 ids from a 2^21 table, summed: plain torch
   (``index_select`` + ``sum``), as the script's was XLA's;
2. lane shuffle of [2^18 x 128] f32 by ids in [0, 128): S1 on kernel
   B2, ``lane_shuffle`` (csrc/lane_shuffle.cu);
3. sublane gather in 8-row blocks: S2, ``sub_gather`` (csrc/sub_gather.cu);
4. transpose of [8192 x 4096] f32: plain torch (``.T.contiguous()``);
5. the v3 compare reduce [512 x 65,536] -> [128 x 65,536]: S3,
   ``transposed_reduce`` at the script's wg 8;
6. the 64-op chain ``acc = acc * 1.0000001 + v`` (32 steps): S4,
   ``elementwise("chain32")`` (csrc/elementwise.cu), in Tops/s.
Each kernel is checked against its plain version before it is timed:
bit for bit where it moves bits or rounds as the plain version does
(2, 3, 6), within rtol 1e-5, atol 1e-5 for the reduce (5).  Then one
JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.elementwise import elementwise, elementwise_plain
from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
from lux_tpu_torch.ops.sub_gather import sub_gather, sub_gather_plain
from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                 transposed_reduce_plain)
from lux_tpu_torch.probes import bit_equal, max_abs_err, parser, timeit

N, V, R = 1 << 25, 1 << 21, 1 << 18
XT = (8192, 4096)
E, NB, W = 512, 512, 128
M = 8
WG = 8
SMALL = dict(N=1 << 12, V=1 << 10, R=1 << 10, XT=(128, 64), E=64, NB=4)
WIDTH = 46          # the script's name column


def make_inputs(small: bool = False) -> dict:
    """The script's arrays, drawn in its order: table0 [V] f32, idx [N]
    int32, x0 [R, 128] f32, sidx [R, 128] int32 in [0, 128), sidx8
    [R, 128] int32 in [0, 8), xt0 f32, vals0 [E, NB * 128] f32, rel
    [E, NB * 128] int32 sorted down each column."""
    s = SMALL if small else dict(N=N, V=V, R=R, XT=XT, E=E, NB=NB)
    rng = np.random.default_rng(0)
    h = {"table0": rng.random(s["V"], np.float32)}
    h["idx"] = rng.integers(0, s["V"], s["N"]).astype(np.int32)
    h["x0"] = rng.random((s["R"], 128), np.float32)
    h["sidx"] = rng.integers(0, 128, (s["R"], 128)).astype(np.int32)
    h["sidx8"] = rng.integers(0, M, (s["R"], 128)).astype(np.int32)
    h["xt0"] = rng.random(s["XT"], np.float32)
    cols = s["NB"] * 128
    h["vals0"] = rng.random((s["E"], cols), np.float32)
    h["rel"] = np.sort(rng.integers(0, W, (s["E"], cols)),
                       axis=0).astype(np.int32)
    return h


def main(argv=None, inputs=None) -> dict:
    """Run the probe (``inputs``: ``make_inputs``' arrays, made here
    when None); returns the JSON line's dict."""
    args = parser(__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    h = make_inputs(args.small) if inputs is None else inputs
    t = {k: torch.from_numpy(v).to(dev) for k, v in h.items()}
    table, idx, x0 = t["table0"], t["idx"], t["x0"]
    sidx, sidx8, xt = t["sidx"], t["sidx8"], t["xt0"]
    vals, rel = t["vals0"], t["rel"]
    n, r = idx.numel(), x0.shape[0]
    e, cols = vals.shape
    checks = {
        "lane_shuffle": bit_equal(lane_shuffle(x0, sidx),
                                  lane_shuffle_plain(x0, sidx)),
        "sub_gather": bit_equal(sub_gather(x0, sidx8, M),
                                sub_gather_plain(x0, sidx8, M)),
        "transposed_reduce": max_abs_err(
            transposed_reduce(vals, rel, W, WG),
            transposed_reduce_plain(vals, rel, W)),
        "elementwise": bit_equal(elementwise("chain32", x0),
                                 elementwise_plain("chain32", x0)),
    }
    # name, kernel (None: plain torch), call, work, unit, per
    runs = [
        ("xla gather 33.5M (loop-dep)", None,
         lambda: torch.sum(torch.index_select(table, 0, idx)), n,
         "Gelem/s", 1e9),
        ("pallas lane shuffle 33.5M (loop-dep)", "lane_shuffle",
         lambda: lane_shuffle(x0, sidx), r * 128, "Gelem/s", 1e9),
        ("pallas sublane shuffle M=8 (loop-dep)", "sub_gather",
         lambda: sub_gather(x0, sidx8, M), r * 128, "Gelem/s", 1e9),
        ("xla transpose 33.5M f32 (loop-dep)", None,
         lambda: xt.T.contiguous(), xt.numel(), "Gelem/s", 1e9),
        ("v3 compare reduce 33.5M edges (loop-dep)", "transposed_reduce",
         lambda: transposed_reduce(vals, rel, W, WG), e * cols, "Gedge/s",
         1e9),
        ("vpu 64 ops/elem chain (loop-dep)", "elementwise",
         lambda: elementwise("chain32", x0), 64 * r * 128, "Tops/s", 1e12),
    ]
    lines = []
    for name, kernel, fn, work, unit, per in runs:
        line = timeit(name, fn, work, unit, WIDTH, dev, per)
        line["kernel"] = kernel
        if kernel is not None:
            line["max_abs_err"] = checks[kernel]
        lines.append(line)
    res = {"probe": "profile_true", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "shapes": {"gather": [n, table.numel()], "shuffle": [r, 128],
                      "transpose": list(xt.shape), "v3": [e, cols, W, WG]},
           "lines": lines}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
