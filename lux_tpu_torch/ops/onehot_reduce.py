"""Kernel S9, the per-chunk reduce as a one-hot product on the tensor
cores: its wrapper, its plain PyTorch version and its launch count
(counterpart of scripts/profile_kernel.py:123 ``mxu``).

    out[c, w] = sum of vals[c, e] over every e with rel[c, e] == w

``vals`` [C, E] float32 with finite values, ``rel`` [C, E] int32 (the
script's dtypes: lanes outside [0, W), the script's pad W among them,
add nothing; rows need not be sorted), 1 <= W <= 128.  It is B1's sum
(chunk_partials) on other hardware units: csrc/onehot_mma.cu issues
``mma.sync`` with lane % 16 as the one-hot's rows and lane / 16 as its
columns, the values split into three bf16 parts (see there).

``onehot_reduce`` launches that kernel for tensors on the card and
takes ``onehot_reduce_plain`` only for tensors on the CPU — there is
no fallback from the card to the plain version.
``onehot_reduce.launches`` counts kernel launches.  Its system path is
the scalar float32 sum under ``use_mxu=True``
(ops/tiled.chunk_partials_mxu, PageRank's reduce); the probe
lux_tpu_torch/probes/profile_kernel.py calls it too.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                            check_int32_lanes)
from lux_tpu_torch.ops.tiled import full_fp32

PLAIN_BLOCK = 1024          # chunks a bmm of the plain version
K_STEP = 16                 # entries an mma k-step (m16n8k16)
MMAS_A_STEP = 3             # mma a k-step: one a bf16 part of the values
MMA_OPS = 2 * 16 * 8 * 16   # operations of one m16n8k16


def onehot_reduce_plain(vals: torch.Tensor, rel: torch.Tensor,
                        W: int) -> torch.Tensor:
    """The plain PyTorch version: the one-hot contraction
    vals[c, 1, E] @ onehot(rel)[c, E, W], PLAIN_BLOCK chunks a ``bmm``
    (at [81,920 x 512] the whole one-hot would take 21 GB), in full
    float32 (``tiled.full_fp32``)."""
    check_int32_lanes(vals, rel, W, "[C, E]", 1)
    C, E = vals.shape
    out = torch.empty((C, W), dtype=torch.float32, device=vals.device)
    lanes = torch.arange(W, device=vals.device, dtype=torch.int32)
    with full_fp32():
        for c0 in range(0, C, PLAIN_BLOCK):
            c1 = c0 + PLAIN_BLOCK
            onehot = (rel[c0:c1, :, None] == lanes).to(torch.float32)
            out[c0:c1] = torch.bmm(vals[c0:c1, None, :], onehot)[:, 0]
    return out


def mma_count(rel: torch.Tensor, W: int) -> int:
    """How many m16n8k16 the kernel issues on ``rel``: MMAS_A_STEP (one
    a bf16 part of the values) for each (chunk, 16-entry k-step), pad
    steps included; W and the lanes do not change it."""
    C, E = rel.shape
    return MMAS_A_STEP * C * -(-E // K_STEP)


def onehot_reduce(vals: torch.Tensor, rel: torch.Tensor,
                  W: int) -> torch.Tensor:
    """Per-chunk sums [C, E] -> [C, W] on the tensor cores for tensors
    on the card, the plain version for tensors on the CPU."""
    check_int32_lanes(vals, rel, W, "[C, E]", 1)
    if vals.device.type == "cpu":
        return onehot_reduce_plain(vals, rel, W)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no onehot_reduce path for device "
                               f"{vals.device}")
    if not (vals.is_contiguous() and rel.is_contiguous()):
        raise KernelInputError("vals and rel must be contiguous")
    C, E = vals.shape
    out = torch.empty((C, W), dtype=torch.float32, device=vals.device)
    if C == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        _kernels.launch("onehot_reduce", vals.data_ptr(), rel.data_ptr(),
                        out.data_ptr(), C, E, W, stream)
    _kernels.counted(onehot_reduce, "onehot_reduce", (vals, rel), (out,))
    return out


onehot_reduce.launches = 0
