"""Counterpart of scripts/profile_shuffle.py: the lane shuffle and the
sublane gather at several block heights, timed on the card at the
script's shapes.

    python3 -m lux_tpu_torch.probes.profile_shuffle [--device cpu] [--small]

x [2^18 x 128] f32 (``--small``: 2^13 rows), from
``np.random.default_rng(0)`` drawn in the script's order: x, the lane
ids idx1 in [0, 128), one idx0 in [0, M) for each M in (8, 64, 512,
4096), then xt [16384 x 2048] f32.  Lines:
- the lane shuffle ``x[r, idx1[r, j]]``: S10 on kernel B2,
  ``lane_shuffle`` (csrc/lane_shuffle.cu).  The script times it at
  bm = 512 and 2,048, VMEM block sizes; B2 takes one warp a row, so bm
  does not reach the kernel and there is one line;
- the sublane gather in M-row blocks for each M: S11, ``sub_gather``
  (csrc/sub_gather.cu);
- the transpose of xt: plain torch (``.T.contiguous()``), as the
  script's was XLA's.
Each kernel is checked bit for bit against its plain version before it
is timed; rates are elements / s / 1e9, as the script prints them.
Then one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
from lux_tpu_torch.ops.sub_gather import sub_gather, sub_gather_plain
from lux_tpu_torch.probes import bit_equal, parser, timeit

R = 1 << 18
MS = (8, 64, 512, 4096)
BMS = (512, 2048)          # the script's bm: VMEM blocks, not the kernel's
XT = (16384, 2048)
SMALL = dict(R=1 << 13, XT=(256, 128))
WIDTH = 44                 # the script's name column


def make_inputs(small: bool = False) -> dict:
    """The script's arrays, drawn in its order: x [R, 128] f32, idx1
    [R, 128] int32 in [0, 128), idx0_<M> [R, 128] int32 in [0, M) for
    each M, xt f32."""
    s = SMALL if small else dict(R=R, XT=XT)
    rng = np.random.default_rng(0)
    h = {"x": rng.random((s["R"], 128), np.float32)}
    h["idx1"] = rng.integers(0, 128, (s["R"], 128)).astype(np.int32)
    for m in MS:
        h[f"idx0_{m}"] = rng.integers(0, m, (s["R"], 128)).astype(np.int32)
    h["xt"] = rng.random(s["XT"], np.float32)
    return h


def main(argv=None, inputs=None) -> dict:
    """Run the probe (``inputs``: ``make_inputs``' arrays, made here
    when None); returns the JSON line's dict."""
    args = parser(__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    h = make_inputs(args.small) if inputs is None else inputs
    t = {k: torch.from_numpy(v).to(dev) for k, v in h.items()}
    x, idx1, xt = t["x"], t["idx1"], t["xt"]
    n = x.numel()
    err = bit_equal(lane_shuffle(x, idx1), lane_shuffle_plain(x, idx1))
    line = timeit("lane shuffle axis=1 [R,128]",
                  lambda: lane_shuffle(x, idx1), n, "G/s", WIDTH, dev)
    lines = [{**line, "kernel": "lane_shuffle", "max_abs_err": err,
              "script_bm": list(BMS),
              "bm_note": "the script's bm is a VMEM block size; B2 takes "
                         "one warp a row, so bm does not reach the kernel"}]
    for m in MS:
        idx0 = t[f"idx0_{m}"]
        err = bit_equal(sub_gather(x, idx0, m), sub_gather_plain(x, idx0, m))
        line = timeit(f"sublane gather axis=0 M={m}",
                      lambda idx0=idx0, m=m: sub_gather(x, idx0, m), n, "G/s",
                      WIDTH, dev)
        lines.append({**line, "kernel": "sub_gather", "M": m,
                      "max_abs_err": err})
    line = timeit("xla transpose [16384,2048]", lambda: xt.T.contiguous(),
                  xt.numel(), "G/s", WIDTH, dev)
    lines.append({**line, "kernel": None})
    res = {"probe": "profile_shuffle", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "shape": list(x.shape), "transpose": list(xt.shape),
           "lines": lines}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
