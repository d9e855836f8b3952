"""Kernel S6, the sum of each bm-row block: its wrapper, its plain
PyTorch version and its launch count (counterpart of
scripts/profile_vpu.py:102 ``redrow``).

    out[b, j] = sum over i < bm of x[b*bm + i, j]

``x`` [R, 128] float32 -> [R / bm, 128] float32, with R % bm == 0 (the
script's ``out_shape`` is hard-coded to N // 1024, its grid to N // bm
blocks).  The default bm is the script's 1,024.  The kernel sums in a
fixed order without atomics, so two launches are bit-equal; it sums in
another order than the plain version, which it matches within rtol
1e-5, atol 1e-5.

``block_rowsum`` launches the CUDA kernel (csrc/block_rowsum.cu) for
tensors on the card and takes ``block_rowsum_plain`` only for tensors
on the CPU — there is no fallback from the card to the plain version.
``block_rowsum.launches`` counts kernel launches.  No system path
calls it: the probe lux_tpu_torch/probes/profile_vpu.py does.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError

W = 128
BM = 1024               # scripts/profile_vpu.py:102


def _check(x: torch.Tensor, bm: int):
    if x.dtype != torch.float32:
        raise KernelInputError(f"x dtype {x.dtype} is not float32")
    if x.dim() != 2 or x.shape[1] != W:
        raise KernelInputError(f"x {tuple(x.shape)} is not [R, {W}]")
    if bm < 1 or x.shape[0] % bm:
        raise KernelInputError(f"R={x.shape[0]} is not a multiple of "
                               f"bm={bm} >= 1")


def block_rowsum_plain(x: torch.Tensor, bm: int = BM) -> torch.Tensor:
    """The plain PyTorch version: ``sum`` of the [R / bm, bm, 128] view
    along dim 1."""
    _check(x, bm)
    return x.view(x.shape[0] // bm, bm, W).sum(dim=1)


def block_rowsum(x: torch.Tensor, bm: int = BM) -> torch.Tensor:
    """[R, 128] -> [R / bm, 128] block sums: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    _check(x, bm)
    if x.device.type == "cpu":
        return block_rowsum_plain(x, bm)
    if x.device.type != "cuda":
        raise KernelInputError(f"no block_rowsum path for device "
                               f"{x.device}")
    if not x.is_contiguous():
        raise KernelInputError("x must be contiguous")
    if x.data_ptr() % 16:
        raise KernelInputError("x must be 16-byte aligned (the kernel "
                               "reads 16 B vectors)")
    R = x.shape[0]
    out = torch.empty((R // bm, W), dtype=torch.float32, device=x.device)
    if R == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _kernels.launch("block_rowsum", x.data_ptr(), out.data_ptr(), R, bm,
                        stream)
    _kernels.counted(block_rowsum, "block_rowsum", (x,), (out,))
    return out


block_rowsum.launches = 0
