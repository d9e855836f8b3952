"""Counterpart of scripts/profile_v3.py (and of the v3 section of
scripts/profile_true.py): the chunk reduce on the transposed layout,
one chunk a column, timed on the card at the script's shape.

    python3 -m lux_tpu_torch.probes.profile_v3 [--device cpu] [--small]

E = 512 entries of NB * 128 = 65,536 chunks into W = 128 output rows
(``--small``: E 64, NB 4): vals uniform in [0, 1), rel sorted down each
column in [0, 128), from ``np.random.default_rng(0)``.  S3/S12,
``transposed_reduce`` (csrc/transposed_reduce.cu), at the script's wg
8, 16 and 32 (its output rows a TPU program) and at wg = 128, each
checked against the plain version first.  On this card wg does not
change the launch: a CTA owns all W output rows of its columns (64
columns by 2 slices of the rows: ops/transposed_reduce.py ``plan``)
and reads every input once, at every wg.  Then the script's own check
(the first 128 columns against a numpy loop) and one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                 transposed_reduce_plain)
from lux_tpu_torch.probes import ProbeCheckError, max_abs_err, parser, timeit

E = 512
W = 128
NB = 512
SMALL = (64, 4)
WGS = (8, 16, 32, W)
WIDTH = 44          # the script's name column


def make_inputs(small: bool = False) -> dict:
    """The script's arrays: vals [E, NB * 128] f32, rel [E, NB * 128]
    int32."""
    e, nb = SMALL if small else (E, NB)
    rng = np.random.default_rng(0)
    vals = rng.random((e, nb * 128), np.float32)
    rel = np.sort(rng.integers(0, W, (e, nb * 128)), axis=0).astype(np.int32)
    return {"vals": vals, "rel": rel}


def main(argv=None, inputs=None) -> dict:
    """Run the probe (``inputs``: ``make_inputs``' arrays, made here
    when None); returns the JSON line's dict."""
    args = parser(__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(args.device)
    h = make_inputs(args.small) if inputs is None else inputs
    vals = torch.from_numpy(h["vals"]).to(dev)
    rel = torch.from_numpy(h["rel"]).to(dev)
    e, n = vals.shape
    want = transposed_reduce_plain(vals, rel, W)
    lines = []
    for wg in WGS:
        err = max_abs_err(transposed_reduce(vals, rel, W, wg), want)
        lines.append({**timeit(f"v3 transposed compare wg={wg}",
                               lambda wg=wg: transposed_reduce(vals, rel, W,
                                                               wg),
                               e * n, "Gedge/s", WIDTH, dev),
                      "wg": wg, "max_abs_err": err})
    # the script's sanity check: its first 128 chunks against numpy
    out = transposed_reduce(vals, rel, W, WGS[0])[:, :128].cpu().numpy()
    v, r = h["vals"][:, :128], h["rel"][:, :128]
    ref = np.zeros((W, 128), np.float32)
    for wd in range(W):
        ref[wd] = np.where(r == wd, v, 0).sum(axis=0)
    check = float(np.abs(out - ref).max())
    print("max err:", check, flush=True)
    if not np.allclose(out, ref, rtol=1e-5, atol=1e-5):
        raise ProbeCheckError(f"v3: first 128 chunks differ from the numpy "
                              f"loop by {check}")
    res = {"probe": "profile_v3", "device": dev.type,
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "shape": [e, n, W], "lines": lines, "numpy_check_max_err": check}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
