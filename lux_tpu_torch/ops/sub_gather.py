"""Kernel S2/S11, the sublane gather inside M-row blocks: its wrapper,
its plain PyTorch version and its launch count (counterpart of
scripts/profile_true.py:89 ``sub_shuffle``, M = 8, and
scripts/profile_shuffle.py:82 ``sub_gather``, M in {8, 64, 512, 4096},
which compute the same function).

    out[b*M + i, j] = x[b*M + idx[b*M + i, j], j]

``x`` [R, 128] float32 or int32, ``idx`` [R, 128] int32 in [0, M)
(the scripts' dtypes), R % M == 0 (the scripts' grid covers R // M
whole blocks; a ragged block's ids could point past the array), and
1 <= M <= MAX_M (the kernel stages an 8-column strip of a block, 32 B
a row, in shared memory).  Pure data movement of 4-byte words: the
kernel is bit-equal to the plain version, NaN payloads included.

``sub_gather`` launches the CUDA kernel (csrc/sub_gather.cu) for
tensors on the card and takes ``sub_gather_plain`` only for tensors on
the CPU — there is no fallback from the card to the plain version.
``sub_gather.launches`` counts kernel launches.  No system path calls
it: the probes lux_tpu_torch/probes/profile_true.py and
profile_shuffle.py do.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError

W = 128
MAX_M = 232448 // 32     # 227 KB of shared memory / 32 B a row (7,264)

_DTYPES = (torch.float32, torch.int32)


def _check(x: torch.Tensor, idx: torch.Tensor, M: int):
    if x.dtype not in _DTYPES:
        raise KernelInputError(f"x dtype {x.dtype} is not float32 or int32")
    if idx.dtype != torch.int32:
        raise KernelInputError(f"idx dtype {idx.dtype} is not int32")
    if x.dim() != 2 or x.shape[1] != W or \
            tuple(idx.shape) != tuple(x.shape):
        raise KernelInputError(
            f"x {tuple(x.shape)} and idx {tuple(idx.shape)} must be the "
            f"same [R, {W}] shape")
    if x.device != idx.device:
        raise KernelInputError(f"x on {x.device}, idx on {idx.device}")
    if not 1 <= M <= MAX_M:
        raise KernelInputError(f"M={M} outside [1, {MAX_M}] (an 8-column "
                               f"strip of M rows must fit 227 KB)")
    if x.shape[0] % M:
        raise KernelInputError(f"R={x.shape[0]} is not a multiple of "
                               f"M={M}")


def sub_gather_plain(x: torch.Tensor, idx: torch.Tensor,
                     M: int) -> torch.Tensor:
    """The plain PyTorch version: one ``torch.gather`` along dim 1 of
    the [R / M, M, 128] view."""
    _check(x, idx, M)
    R = x.shape[0]
    return torch.gather(x.view(R // M, M, W), 1,
                        idx.view(R // M, M, W).long()).view(R, W)


def sub_gather(x: torch.Tensor, idx: torch.Tensor, M: int) -> torch.Tensor:
    """[R, 128] gather within M-row blocks: the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    _check(x, idx, M)
    if x.device.type == "cpu":
        return sub_gather_plain(x, idx, M)
    if x.device.type != "cuda":
        raise KernelInputError(f"no sub_gather path for device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise KernelInputError("x and idx must be contiguous")
    if x.data_ptr() % 16 or idx.data_ptr() % 16:
        raise KernelInputError("x and idx must be 16-byte aligned (the "
                               "kernel moves 16 B words)")
    R = x.shape[0]
    out = torch.empty_like(x)
    if R == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch("sub_gather", x.data_ptr(), idx.data_ptr(),
                        out.data_ptr(), R, M, stream)
    sub_gather.launches += 1
    return out


sub_gather.launches = 0
