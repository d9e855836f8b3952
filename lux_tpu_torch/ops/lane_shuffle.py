"""Kernel B2, the 128-lane shuffle: its wrapper, its plain PyTorch
version and its launch count (counterpart of
lux_tpu/ops/pagegather.py:1031-1083, ``_lane_shuffle_pallas``).

    out[r, c] = rows[r, slot_lane[r, c] & 0x7F]

``rows`` [R, 128] float32 or int32; ``slot_lane`` [R, 128] int32 that
carries the bits of the plan's packed uint32 ``page_slot << 7 | lane``
(torch's uint32 has thin CUDA coverage).  Any R >= 0.  Pure data
movement of 4-byte words: the result is bit-equal to the input words,
NaN payloads included.

``lane_shuffle`` launches the CUDA kernel (csrc/lane_shuffle.cu) for
tensors on the card and takes ``lane_shuffle_plain`` only for tensors
on the CPU — there is no fallback from the card to the plain version.
``lane_shuffle.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError, KernelLaunchError

W = 128
LANE_MASK = 0x7F

_DTYPES = (torch.float32, torch.int32)


def _check(rows: torch.Tensor, slot_lane: torch.Tensor):
    if rows.dtype not in _DTYPES:
        raise KernelInputError(f"rows dtype {rows.dtype} is not float32 "
                               f"or int32")
    if slot_lane.dtype != torch.int32:
        raise KernelInputError(f"slot_lane dtype {slot_lane.dtype} is not "
                               f"int32 (the packed uint32's bits)")
    if rows.dim() != 2 or rows.shape[1] != W or \
            tuple(slot_lane.shape) != tuple(rows.shape):
        raise KernelInputError(
            f"rows {tuple(rows.shape)} and slot_lane "
            f"{tuple(slot_lane.shape)} must be the same [R, {W}] shape")
    if rows.device != slot_lane.device:
        raise KernelInputError(f"rows on {rows.device}, slot_lane on "
                               f"{slot_lane.device}")


def decode_lanes(slot_lane: torch.Tensor) -> torch.Tensor:
    """int64 lane of each entry: the low 7 bits."""
    return (slot_lane & LANE_MASK).to(torch.int64)


def lane_shuffle_plain(rows: torch.Tensor,
                       slot_lane: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: decode the lanes, then one
    ``torch.gather`` along dim 1."""
    _check(rows, slot_lane)
    return torch.gather(rows, 1, decode_lanes(slot_lane))


def lane_shuffle(rows: torch.Tensor, slot_lane: torch.Tensor) -> torch.Tensor:
    """[R, 128] lane shuffle: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    _check(rows, slot_lane)
    if rows.device.type == "cpu":
        return lane_shuffle_plain(rows, slot_lane)
    if rows.device.type != "cuda":
        raise KernelInputError(f"no lane_shuffle path for device "
                               f"{rows.device}")
    if not (rows.is_contiguous() and slot_lane.is_contiguous()):
        raise KernelInputError("rows and slot_lane must be contiguous")
    if rows.data_ptr() % 16 or slot_lane.data_ptr() % 16:
        raise KernelInputError("rows and slot_lane must be 16-byte "
                               "aligned (the kernel moves 16 B words)")
    R = rows.shape[0]
    out = torch.empty_like(rows)
    if R == 0:
        return out
    from lux_tpu_torch import _kernels

    lib = _kernels.load("lane_shuffle")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.lux_lane_shuffle(rows.data_ptr(), slot_lane.data_ptr(),
                                   out.data_ptr(), R, stream)
    if err != 0:
        raise KernelLaunchError(f"lane_shuffle launch failed with "
                                f"cudaError_t {err} (R={R})")
    lane_shuffle.launches += 1
    return out


lane_shuffle.launches = 0
