"""Kernel S3/S12, the chunk reduce on the transposed layout (one chunk a
column): its wrapper, its plain PyTorch version and its launch count
(counterpart of scripts/profile_v3.py:66 ``reduce_v3`` and
scripts/profile_true.py:141 ``v3``, which compute the same function).

    out[w, n] = sum of vals[e, n] over every e with rel[e, n] == w

``vals`` [E, N] float32, ``rel`` [E, N] int32 (the scripts' dtypes;
lanes outside [0, W) add nothing; columns need not be sorted),
1 <= W <= 128; an output row that no entry hits is 0.  ``wg`` is the
kernel's output rows a block, the scripts' wg (default W: every input
read once).

``transposed_reduce`` launches the CUDA kernel
(csrc/transposed_reduce.cu) for tensors on the card and takes
``transposed_reduce_plain`` only for tensors on the CPU — there is no
fallback from the card to the plain version.
``transposed_reduce.launches`` counts kernel launches.  No system path
calls it: the probe lux_tpu_torch/probes/profile_v3.py does.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                            check_int32_lanes)

COLS = 128              # columns a block (csrc/transposed_reduce.cu)
MAX_COL_TILES = 65535   # the grid's y limit


def _check(vals: torch.Tensor, rel: torch.Tensor, W: int, wg=None):
    check_int32_lanes(vals, rel, W, "[E, N]", 0)
    if wg is not None and not 1 <= wg <= W:
        raise KernelInputError(f"wg={wg} outside [1, W={W}]")


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
    """Transposed chunk reduce [E, N] -> [W, N]: the CUDA kernel (``wg``
    output rows a block, default W) for tensors on the card, the plain
    version for tensors on the CPU."""
    _check(vals, rel, W, wg)
    if vals.device.type == "cpu":
        return transposed_reduce_plain(vals, rel, W)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no transposed_reduce path for device "
                               f"{vals.device}")
    if not (vals.is_contiguous() and rel.is_contiguous()):
        raise KernelInputError("vals and rel must be contiguous")
    E, N = vals.shape
    if -(-N // COLS) > MAX_COL_TILES:
        raise KernelInputError(f"N={N} columns exceed the kernel's "
                               f"{MAX_COL_TILES} blocks of {COLS}")
    out = torch.empty((W, N), dtype=torch.float32, device=vals.device)
    if N == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        _kernels.launch("transposed_reduce", vals.data_ptr(), rel.data_ptr(),
                        out.data_ptr(), E, N, W, W if wg is None else wg,
                        stream)
    transposed_reduce.launches += 1
    return out


transposed_reduce.launches = 0
