"""Counterpart of scripts/profile_kernel.py: variants of the chunk
partial reduce, timed on the card at the script's shape.

    python3 -m lux_tpu_torch.probes.profile_kernel [--3d] [--device cpu] \
        [--small]

C = 81,920 chunks of E = 512 entries into W = 128 lanes (``--small``:
1,024 x 64): vals uniform in [0, 1), rel sorted along each row in
[0, 128] (128, which is W, is the pad), start with probability 0.2 and
on chunk 0, drawn from ``np.random.default_rng(0)`` in the script's
order.  Lines, each checked against its plain version first:

  --3d  the script's "3d kernel" (lux_tpu/ops/pallas_reduce.py) is B1:
        ``chunk_partials`` (csrc/chunk_partials.cu) on rel as B1's int8
        lanes, the pad as -1;
  S8    ``fused_carry`` (csrc/fused_carry.cu).  The script sweeps
        block_c 32 and 128, the TPU's VMEM block of chunks; the port's
        kernel has one tile of 32 chunks a block, so it prints one line;
  S9    ``onehot_reduce`` (csrc/onehot_mma.cu), the script's
        ``mxu onehot block_c=32``.

Then one JSON line: the shape, the device and each line's ms, rate and
max abs error against its plain version.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.carry import FUSED_TILE, fused_carry, fused_carry_plain
from lux_tpu_torch.ops.chunk_reduce import chunk_partials, chunk_partials_plain
from lux_tpu_torch.ops.onehot_reduce import onehot_reduce, onehot_reduce_plain
from lux_tpu_torch.probes import max_abs_err, parser, timeit

C = 80 * 1024
E = 512
W = 128
SMALL = (1024, 64)
WIDTH = 40          # the script's name column


def make_inputs(small: bool = False) -> dict:
    """The script's arrays: vals [C, E] f32, rel [C, E] int32, start
    [C, 1] int32."""
    c, e = SMALL if small else (C, E)
    rng = np.random.default_rng(0)
    vals = rng.random((c, e), np.float32)
    rel = np.sort(rng.integers(0, W + 1, (c, e)), axis=1).astype(np.int32)
    start = (rng.random(c) < 0.2).astype(np.int32)
    start[0] = 1
    return {"vals": vals, "rel": rel, "start": start.reshape(c, 1)}


def main(argv=None, inputs=None) -> dict:
    """Run the probe (``inputs``: ``make_inputs``' arrays, made here
    when None); returns the JSON line's dict."""
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--3d", dest="three_d", action="store_true",
                    help="also time B1 (chunk_partials), the 3d kernel")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h = make_inputs(args.small) if inputs is None else inputs
    vals = torch.from_numpy(h["vals"]).to(dev)
    rel = torch.from_numpy(h["rel"]).to(dev)
    start = torch.from_numpy(h["start"]).to(dev)
    c, e = vals.shape
    lines = []

    def line(name, fn, plain):
        err = max_abs_err(fn(), plain())
        lines.append({**timeit(name, fn, c * e, "Gedge/s", WIDTH, dev),
                      "max_abs_err": err})

    if args.three_d:
        rel8 = torch.where((rel >= 0) & (rel < W), rel, -1).to(torch.int8)
        line("3d kernel: B1 chunk_partials",
             lambda: chunk_partials(vals, rel8, W, "sum"),
             lambda: chunk_partials_plain(vals, rel8, W, "sum"))
    line(f"2d fused-carry: fused_carry tile={FUSED_TILE}",
         lambda: fused_carry(vals, rel, start, W),
         lambda: fused_carry_plain(vals, rel, start, W))
    line("mxu onehot: onehot_reduce (mma.sync)",
         lambda: onehot_reduce(vals, rel, W),
         lambda: onehot_reduce_plain(vals, rel, W))
    out = {"probe": "profile_kernel", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "shape": [c, e, W], "lines": lines}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
