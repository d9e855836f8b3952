"""Counterpart of scripts/profile_vpu.py: elementwise, compare-select
and block-reduce throughput, timed on the card at the script's shape.

    python3 -m lux_tpu_torch.probes.profile_vpu [--device cpu] [--small]

x [524,288 x 128] f32 and r [524,288 x 128] int32 in [0, 128) from
``np.random.default_rng(0)``, drawn in the script's order
(``--small``: 2,048 rows).  The script's lines, in its order and in
Tops/s of its own work counts:
- ``x + x``, chain10 (ten ``a = a + b``), cmpsel16, cmpmul16 and, last,
  chain10 on x rounded to bf16: S5, ``elementwise`` (csrc/elementwise.cu);
  ``x + x`` and both chain10 lines pass the same array twice, as the
  script does, and the kernel reads it once;
- the sum of each 1,024-row block, [524,288 x 128] -> [512 x 128]: S6,
  ``block_rowsum`` (csrc/block_rowsum.cu).
Each kernel is checked against its plain version before it is timed:
the bodies bit for bit, the block sums within rtol 1e-5, atol 1e-5
(another summation order).  Then one JSON line.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.block_rowsum import block_rowsum, block_rowsum_plain
from lux_tpu_torch.ops.elementwise import elementwise, elementwise_plain
from lux_tpu_torch.probes import bit_equal, max_abs_err, parser, timeit

N = 64 * 1024 * 1024 // 128     # rows: N * 128 = 64M elements
BM = 1024
SMALL_N = 2048
WIDTH = 46                      # the script's name column


def make_inputs(small: bool = False) -> dict:
    """The script's arrays, drawn in its order: x [N, 128] f32, r
    [N, 128] int32 in [0, 128)."""
    n = SMALL_N if small else N
    rng = np.random.default_rng(0)
    x = rng.random((n, 128), np.float32)
    r = rng.integers(0, 128, (n, 128)).astype(np.int32)
    return {"x": x, "r": r}


def main(argv=None, inputs=None) -> dict:
    """Run the probe (``inputs``: ``make_inputs``' arrays, made here
    when None); returns the JSON line's dict."""
    args = parser(__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    h = make_inputs(args.small) if inputs is None else inputs
    x = torch.from_numpy(h["x"]).to(dev)
    r = torch.from_numpy(h["r"]).to(dev)
    xb = x.to(torch.bfloat16)
    n = x.numel()
    # name, body (None: the block sum), inputs, work (the script's)
    runs = [("add x+x (1 op/elem)", "add", (x, x), n),
            ("10 chained adds", "chain10", (x, x), 10 * n),
            ("16x (cmp+sel+add)", "cmpsel16", (x, r), 3 * 16 * n),
            ("16x (cmp+cast+mul+add)", "cmpmul16", (x, r), 4 * 16 * n),
            ("block reduce rows [1024,128]->[1,128]", None, (x,), n),
            ("bf16 10 chained adds", "chain10", (xb, xb), 10 * n)]
    lines = []
    for name, body, ins, work in runs:
        if body is None:
            kernel = "block_rowsum"
            fn = functools.partial(block_rowsum, x, BM)
            err = max_abs_err(fn(), block_rowsum_plain(x, BM))
        else:
            kernel = "elementwise"
            fn = functools.partial(elementwise, body, *ins)
            err = bit_equal(fn(), elementwise_plain(body, *ins))
        line = timeit(name, fn, work, "Tops/s", WIDTH, dev, 1e12)
        lines.append({**line, "kernel": kernel, "body": body,
                      "dtype": str(ins[0].dtype).replace("torch.", ""),
                      "max_abs_err": err})
    res = {"probe": "profile_vpu", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "shape": list(x.shape), "bm": BM, "lines": lines}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
