"""Kernel S2/S11, the sublane gather inside M-row blocks: its wrapper,
its plain PyTorch version and its launch count (counterpart of
scripts/profile_true.py:89 ``sub_shuffle``, M = 8, and
scripts/profile_shuffle.py:82 ``sub_gather``, M in {8, 64, 512, 4096},
which compute the same function).

    out[b*M + i, j] = x[b*M + idx[b*M + i, j], j]

``x`` [R, 128] float32 or int32, ``idx`` [R, 128] int32 in [0, M)
(the scripts' dtypes), R % M == 0 (the scripts' grid covers R // M
whole blocks; a ragged block's ids could point past the array), and
1 <= M <= MAX_M (the kernel may stage a column strip of a block in
shared memory; MAX_M is the M whose 8-column strip, 32 B a row, fills
a block's 227 KB).  Pure data movement of 4-byte words: the
kernel is bit-equal to the plain version, NaN payloads included.

``sub_gather`` launches the CUDA kernel (csrc/sub_gather.cu) for
tensors on the card and takes ``sub_gather_plain`` only for tensors on
the CPU — there is no fallback from the card to the plain version.
``plan(M)`` is the kernel's launch plan (its mode, strip width, blocks
a tile, threads), chosen on the host from M so that the CPU tests can
check that its CTAs cover every (row, column) once, stage whole blocks
and fit a block's shared memory (``plan_ctas``, ``plan_smem``).
``sub_gather.launches`` counts kernel launches.  No system path calls
it: the probes lux_tpu_torch/probes/profile_true.py and
profile_shuffle.py do.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError

W = 128
SMEM_BYTES = 232448      # a block's shared memory on sm_90 (227 KB)
MAX_M = SMEM_BYTES // 32     # 227 KB / 32 B a row (7,264)
MODES = {"staged": 0, "direct": 1}  # csrc/sub_gather.cu Mode
MIN_COLS = 8             # narrowest strip: 32 B a row, one sector
SMALL_ROWS = 64          # rows a tile for M <= 64 (all 128 columns)
TILE_BYTES = 64 * 1024   # the most a CTA stages for M > 64
DIRECT_M = 8             # the default plan stages nothing up to this M
STAGED_MAX_M = 512       # ... and past this one

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


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(M: int, mode: str | None = None,
         tile_bytes: int = TILE_BYTES) -> dict:
    """The kernel's launch plan for block size M (csrc/sub_gather.cu).

    ``mode`` None takes the default: "staged" for DIRECT_M < M <=
    STAGED_MAX_M, else "direct" (lux_tpu_torch/tools/probe_ab.py's
    measurements, PERF.md).
    - "staged": M <= 64, all 128 columns of SMALL_ROWS // M whole
      blocks (64 rows; 63 for M = 3) a tile, 256 threads; larger M, one
      block a tile, the widest power-of-two strip whose M rows fit
      ``tile_bytes`` (never under MIN_COLS), threads for about eight
      16 B units each (256 to 1,024).
    - "direct": no staging; one CTA of 256 threads a 256 16 B units.
    """
    if not 1 <= M <= MAX_M:
        raise KernelInputError(f"M={M} outside [1, {MAX_M}]")
    if mode is None:
        mode = "staged" if DIRECT_M < M <= STAGED_MAX_M else "direct"
    if mode not in MODES:
        raise KernelInputError(f"sub_gather mode {mode!r} is not one of "
                               f"{sorted(MODES)}")
    cw, K, threads = W, 1, 256
    if mode == "staged" and M <= SMALL_ROWS:
        K = SMALL_ROWS // M
    elif mode == "staged":
        while cw > MIN_COLS and M * cw * 4 > tile_bytes:
            cw //= 2
        threads = min(1024, max(256, _ceil_pow2(M * cw // 32)))
    return {"mode": mode, "cw": cw, "K": K, "threads": threads}


def plan_smem(p: dict, M: int) -> int:
    """Shared memory bytes a CTA of plan ``p`` takes."""
    return p["K"] * M * p["cw"] * 4 if p["mode"] == "staged" else 0


def plan_ctas(p: dict, M: int, n_blocks: int):
    """What each CTA of plan ``p`` writes over ``n_blocks`` M-row
    blocks, in the kernel's order (csrc/sub_gather.cu): int64 numpy
    columns (first row, rows, first column, columns).  "staged": K
    whole blocks a CTA, the strips of one block range neighbours, each
    reading only its staged rows; "direct": one CTA a 256 16 B units
    (8 rows), each row reading its own block."""
    R = n_blocks * M
    if p["mode"] == "direct":
        r0 = np.arange(0, R, 8, dtype=np.int64)
        return np.stack([r0, np.minimum(8, R - r0), 0 * r0, 0 * r0 + W],
                        axis=1)
    cw, K = p["cw"], p["K"]
    strips = W // cw
    t = np.arange(strips * -(-n_blocks // K), dtype=np.int64)
    g = t // strips
    return np.stack([g * K * M, np.minimum(K, n_blocks - g * K) * M,
                     (t - g * strips) * cw, np.full_like(t, cw)], axis=1)


def sub_gather(x: torch.Tensor, idx: torch.Tensor, M: int,
               plan_override: dict | None = None) -> torch.Tensor:
    """[R, 128] gather within M-row blocks: the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU.
    ``plan_override`` replaces ``plan(M)`` (the A/B tool's variants)."""
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
        p = plan_override or plan(M)
        _kernels.launch("sub_gather", x.data_ptr(), idx.data_ptr(),
                        out.data_ptr(), R, M, MODES[p["mode"]], p["cw"],
                        p["K"], p["threads"], stream)
    _kernels.counted(sub_gather, "sub_gather", (x, idx), (out,))
    return out


sub_gather.launches = 0
