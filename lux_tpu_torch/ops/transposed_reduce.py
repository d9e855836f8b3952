"""Kernel S3/S12, the chunk reduce on the transposed layout (one chunk a
column): its wrapper, its launch plan, its plain PyTorch version and
its launch count (counterpart of scripts/profile_v3.py:66 ``reduce_v3``
and scripts/profile_true.py:141 ``v3``, which compute the same
function).

    out[w, n] = sum of vals[e, n] over every e with rel[e, n] == w

``vals`` [E, N] float32, ``rel`` [E, N] int32 (the scripts' dtypes;
lanes outside [0, W) add nothing; columns need not be sorted),
1 <= W <= 128; an output row that no entry hits is 0.

``wg`` is the scripts' output rows a TPU program, a tiling of the TPU's
grid that does not change the function (the TPU reads each input block
once at any wg).  On this card a CTA owns all W output rows of its
columns at every wg, so the kernel reads every input once and its
launch does not depend on wg: the wrapper checks 1 <= wg <= W and
passes nothing on.  ``plan`` gives a CTA its columns, one thread each,
and splits their E rows over slices of threads
(csrc/transposed_reduce.cu); ``plan_ctas`` lists what each slice
reads, which the CPU tests check.

``transposed_reduce`` launches the CUDA kernel
(csrc/transposed_reduce.cu) for tensors on the card and takes
``transposed_reduce_plain`` only for tensors on the CPU — there is no
fallback from the card to the plain version.
``transposed_reduce.launches`` counts kernel launches.  No system path
calls it: the probe lux_tpu_torch/probes/profile_v3.py does.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                            check_int32_lanes)

# csrc/transposed_reduce.cu's grid limit, and the plan: COLS columns a
# CTA by SLICES slices of the rows (PERF.md)
MAX_CTAS = 2**31 - 1     # the grid's x limit
COLS, SLICES = 64, 2


def _check(vals: torch.Tensor, rel: torch.Tensor, W: int, wg=None):
    check_int32_lanes(vals, rel, W, "[E, N]", 0)
    if wg is not None and not 1 <= wg <= W:
        raise KernelInputError(f"wg={wg} outside [1, W={W}]")


def plan(E: int, W: int) -> dict:
    """The kernel's launch plan: a CTA of COLS neighbouring columns (one
    thread a column) by SLICES slices of the E rows, each thread with
    its own column of a [W x COLS] f32 accumulator a slice
    (csrc/transposed_reduce.cu).  Slices hold ``slice`` consecutive
    rows, the last what is left; no more slices than leave each a
    row."""
    if E < 1 or not 1 <= W <= 128:
        raise KernelInputError(f"no transposed_reduce plan for E={E}, W={W}")
    slice_ = -(-E // min(SLICES, E))
    slices = -(-E // slice_)
    return {"cols": COLS, "slices": slices, "slice": slice_,
            "smem": slices * W * COLS * 4}


def plan_ctas(p: dict, E: int, N: int):
    """What each slice of each CTA of plan ``p`` reads, in the kernel's
    order (csrc/transposed_reduce.cu): int64 numpy columns (CTA, slice,
    first column, columns, first row, rows), one line a slice; the
    threads of a column past N read column N - 1 and write nothing, and
    are not counted."""
    C, K = p["cols"], p["slices"]
    ctas = -(-N // C)
    cta = np.repeat(np.arange(ctas, dtype=np.int64), K)
    sl = np.tile(np.arange(K, dtype=np.int64), ctas)
    c0 = cta * C
    e0 = sl * p["slice"]
    return np.stack([cta, sl, c0, np.minimum(C, N - c0), e0,
                     np.minimum(p["slice"], E - e0)], axis=1)


def transposed_reduce_plain(vals: torch.Tensor, rel: torch.Tensor,
                            W: int) -> torch.Tensor:
    """The plain PyTorch version: one ``scatter_add_`` along dim 0 into
    [W + 1, N], lanes outside [0, W) sent to row W, which is dropped."""
    _check(vals, rel, W)
    lane = torch.where((rel >= 0) & (rel < W), rel, W).long()
    out = torch.zeros((W + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.scatter_add_(0, lane, vals)
    return out[:W]


def transposed_reduce(vals: torch.Tensor, rel: torch.Tensor, W: int,
                      wg=None) -> torch.Tensor:
    """Transposed chunk reduce [E, N] -> [W, N]: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU.
    ``wg`` (the scripts' output rows a program, 1 <= wg <= W) is checked
    and does not change the launch."""
    _check(vals, rel, W, wg)
    if vals.device.type == "cpu":
        return transposed_reduce_plain(vals, rel, W)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no transposed_reduce path for device "
                               f"{vals.device}")
    if not (vals.is_contiguous() and rel.is_contiguous()):
        raise KernelInputError("vals and rel must be contiguous")
    E, N = vals.shape
    p = plan(E, W)
    if -(-N // p["cols"]) > MAX_CTAS:
        raise KernelInputError(f"N={N} columns exceed the kernel's "
                               f"{MAX_CTAS} CTAs of {p['cols']} columns")
    out = torch.empty((W, N), dtype=torch.float32, device=vals.device)
    if N == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        _kernels.launch("transposed_reduce", vals.data_ptr(), rel.data_ptr(),
                        out.data_ptr(), E, N, W, p["cols"], p["slices"],
                        p["slice"], stream)
    transposed_reduce.launches += 1
    return out


transposed_reduce.launches = 0
