"""Kernel B1, the per-chunk partial reduction: its wrapper, its plain
PyTorch version and its launch count (counterpart of
lux_tpu/ops/pallas_reduce.py:38-89, ``chunk_partials_pallas``).

    out[c, w] = sum | min | max of vals[c, e] over every e with
                rel_dst[c, e] == w; identity_for(kind) where none.

``vals`` [C, E] float32 or int32, ``rel_dst`` [C, E] int8 with lanes in
[0, W) and -1 as the pad, W <= 128 (the int8 contract of
ops/tiled.TiledLayout).  Any C and any E >= 1.

``chunk_partials`` launches the CUDA kernel (csrc/chunk_partials.cu)
for tensors on the card and takes ``chunk_partials_plain`` only for
tensors on the CPU — there is no fallback from the card to the plain
version.  ``chunk_partials.launches`` counts kernel launches, and
``chunk_partials.launches_by_e`` the same launches by chunk length.

The same function over a trailing query axis (query-batched programs,
whose state is [P, vpad, B]):

    out[c, w, b] = reduce of vals[c, e, b] over every e with
                   rel_dst[c, e] == w; the identity where none.

``chunk_partials_batched`` takes ``vals`` [C, E, B] and gives
[C, W, B] through its own kernel (csrc/chunk_partials_batched.cu),
``chunk_partials_batched_plain`` is its plain version and
``chunk_partials_batched.launches`` its launch count.  It is the
function the reference computes with XLA for a vector payload
(lux_tpu/ops/tiled.py:326 ``chunk_partials``, :357): its Pallas kernel
is scalar only.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.segment import SCATTER_REDUCE, identity_for

MAX_W = 128

_DTYPES = {torch.float32: 0, torch.int32: 1}
_KINDS = {"sum": 0, "min": 1, "max": 2}


class KernelInputError(ValueError):
    """A tensor the kernel does not take (dtype, shape, device,
    contiguity), or an unknown reduce kind."""


class KernelLaunchError(RuntimeError):
    """The CUDA launch returned a non-zero cudaError_t."""


def _check(vals: torch.Tensor, rel_dst: torch.Tensor, W: int, kind: str,
           batched: bool = False):
    if kind not in _KINDS:
        raise KernelInputError(f"unknown reduce kind {kind!r} "
                               f"(sum, min or max)")
    if vals.dtype not in _DTYPES:
        raise KernelInputError(f"vals dtype {vals.dtype} is not float32 "
                               f"or int32")
    if rel_dst.dtype != torch.int8:
        raise KernelInputError(f"rel_dst dtype {rel_dst.dtype} is not "
                               f"int8")
    if batched:
        if (vals.dim() != 3 or rel_dst.dim() != 2
                or vals.shape[:2] != rel_dst.shape or vals.shape[2] < 1):
            raise KernelInputError(
                f"vals {tuple(vals.shape)} and rel_dst "
                f"{tuple(rel_dst.shape)} must be [C, E, B] and [C, E], "
                f"B >= 1")
    elif vals.dim() != 2 or vals.shape != rel_dst.shape:
        raise KernelInputError(
            f"vals {tuple(vals.shape)} and rel_dst "
            f"{tuple(rel_dst.shape)} must be the same [C, E] shape")
    if vals.shape[1] < 1:
        raise KernelInputError("chunks need E >= 1 edges")
    if not 1 <= W <= MAX_W:
        raise KernelInputError(
            f"W={W} outside [1, {MAX_W}]: rel_dst is int8, lanes "
            f"0..127 with -1 as the pad")
    if vals.device != rel_dst.device:
        raise KernelInputError(f"vals on {vals.device}, rel_dst on "
                               f"{rel_dst.device}")


def check_int32_lanes(vals: torch.Tensor, rel: torch.Tensor, W: int,
                      shape: str, reduce_dim: int) -> None:
    """The probe kernels' inputs (the TPU scripts' dtypes): f32 ``vals``
    and int32 lanes ``rel`` of one 2-D ``shape`` ("[C, E]" or "[E, N]")
    with at least one entry along ``reduce_dim``, on one device, and
    1 <= W <= 128."""
    if vals.dtype != torch.float32:
        raise KernelInputError(f"vals dtype {vals.dtype} is not float32")
    if rel.dtype != torch.int32:
        raise KernelInputError(f"rel dtype {rel.dtype} is not int32")
    if vals.dim() != 2 or vals.shape != rel.shape or \
            vals.shape[reduce_dim] < 1:
        raise KernelInputError(f"vals {tuple(vals.shape)} and rel "
                               f"{tuple(rel.shape)} must be the same "
                               f"{shape} shape, E >= 1")
    if not 1 <= W <= MAX_W:
        raise KernelInputError(f"W={W} outside [1, {MAX_W}]")
    if vals.device != rel.device:
        raise KernelInputError(f"vals on {vals.device}, rel on {rel.device}")


def chunk_partials_plain(vals: torch.Tensor, rel_dst: torch.Tensor,
                         W: int, kind: str) -> torch.Tensor:
    """The plain PyTorch version: one ``scatter_reduce`` over the
    flattened index ``c * (W + 1) + lane``, pads (and any lane outside
    [0, W)) routed to a dump column W, starting from the identity.
    O(C*E) memory — it never builds the [C, E, W] broadcast."""
    _check(vals, rel_dst, W, kind)
    C, E = vals.shape
    idx = _lane_index(rel_dst, W)
    out = torch.full((C * (W + 1),), identity_for(kind, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1),
                        SCATTER_REDUCE[kind], include_self=True)
    return out.view(C, W + 1)[:, :W]


def _lane_index(rel_dst: torch.Tensor, W: int) -> torch.Tensor:
    """The plain versions' flat index ``c * (W + 1) + lane`` [C, E],
    pads and lanes outside [0, W) routed to the dump column W."""
    C = rel_dst.shape[0]
    rel = rel_dst.to(torch.int64)
    lane = torch.where((rel >= 0) & (rel < W), rel, W)
    return (torch.arange(C, device=rel.device, dtype=torch.int64)[:, None]
            * (W + 1) + lane)


def chunk_partials(vals: torch.Tensor, rel_dst: torch.Tensor, W: int,
                   kind: str) -> torch.Tensor:
    """Per-chunk partials [C, E] -> [C, W]: the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    _check(vals, rel_dst, W, kind)
    if vals.device.type == "cpu":
        return chunk_partials_plain(vals, rel_dst, W, kind)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no chunk_partials path for device "
                               f"{vals.device}")
    if not (vals.is_contiguous() and rel_dst.is_contiguous()):
        raise KernelInputError("vals and rel_dst must be contiguous")
    C, E = vals.shape
    out = torch.empty((C, W), dtype=vals.dtype, device=vals.device)
    if C == 0:
        return out
    from lux_tpu_torch import _kernels

    lib = _kernels.load("chunk_partials")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.lux_chunk_partials(
            vals.data_ptr(), rel_dst.data_ptr(), out.data_ptr(), C, E, W,
            _DTYPES[vals.dtype], _KINDS[kind], stream)
    if err != 0:
        raise KernelLaunchError(f"chunk_partials launch failed with "
                                f"cudaError_t {err} (C={C} E={E} W={W})")
    _kernels.counted(chunk_partials, "chunk_partials", (vals, rel_dst),
                     (out,))
    chunk_partials.launches_by_e[E] = (
        chunk_partials.launches_by_e.get(E, 0) + 1)
    return out


chunk_partials.launches = 0
# the same launches by chunk length E: a path that reduces chunks of
# two shapes (owner chunks at E = 256, pair rows at 128) tells them apart
chunk_partials.launches_by_e = {}


def chunk_partials_batched_plain(vals: torch.Tensor, rel_dst: torch.Tensor,
                                 W: int, kind: str) -> torch.Tensor:
    """The plain PyTorch version of the batched reduce: one
    ``scatter_reduce`` over [C * (W + 1), B], each edge's B values to
    its row ``c * (W + 1) + lane`` (pads to the dump row W), starting
    from the identity."""
    _check(vals, rel_dst, W, kind, batched=True)
    C, E, B = vals.shape
    idx = _lane_index(rel_dst, W).reshape(-1, 1).expand(C * E, B)
    out = torch.full((C * (W + 1), B), identity_for(kind, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, idx, vals.reshape(C * E, B),
                        SCATTER_REDUCE[kind], include_self=True)
    return out.view(C, W + 1, B)[:, :W]


def chunk_partials_batched(vals: torch.Tensor, rel_dst: torch.Tensor,
                           W: int, kind: str) -> torch.Tensor:
    """Per-chunk partials over a query axis [C, E, B] -> [C, W, B]: the
    CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU.  On the card both inputs must be contiguous (a strided
    view raises: make it contiguous first)."""
    _check(vals, rel_dst, W, kind, batched=True)
    if vals.device.type == "cpu":
        return chunk_partials_batched_plain(vals, rel_dst, W, kind)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no chunk_partials_batched path for "
                               f"device {vals.device}")
    if not (vals.is_contiguous() and rel_dst.is_contiguous()):
        raise KernelInputError("vals and rel_dst must be contiguous")
    C, E, B = vals.shape
    out = torch.empty((C, W, B), dtype=vals.dtype, device=vals.device)
    if C == 0:
        return out
    from lux_tpu_torch import _kernels

    lib = _kernels.load("chunk_partials_batched")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.lux_chunk_partials_batched(
            vals.data_ptr(), rel_dst.data_ptr(), out.data_ptr(), C, E, B,
            W, _DTYPES[vals.dtype], _KINDS[kind], stream)
    if err != 0:
        raise KernelLaunchError(
            f"chunk_partials_batched launch failed with cudaError_t {err} "
            f"(C={C} E={E} B={B} W={W})")
    _kernels.counted(chunk_partials_batched, "chunk_partials_batched",
                     (vals, rel_dst), (out,))
    return out


chunk_partials_batched.launches = 0


def chunk_partials_batched_traffic(vals: torch.Tensor, rel_dst: torch.Tensor,
                                   W: int) -> dict:
    """The bytes the batched reduce must move on these inputs (its byte
    bound): every lane id once, the B values of every entry whose lane
    is in [0, W) (a pad's values are never needed) and the output once.
    Also the live entries, and the bytes with every value read, pads
    included."""
    C, E, B = vals.shape
    live = int(((rel_dst >= 0) & (rel_dst.to(torch.int16) < W)).sum())
    isz = vals.element_size()
    out_bytes = C * W * B * isz
    return {"bytes": C * E + live * B * isz + out_bytes,
            "live_entries": live,
            "all_values_bytes": C * E + C * E * B * isz + out_bytes}


def chunk_partials_batched_sum_tolerance(vals: torch.Tensor,
                                         rel_dst: torch.Tensor,
                                         W: int) -> torch.Tensor:
    """Per element of a float32 ``sum`` [C, W, B], the error allowed
    against another fold order: E * 2^-23 times the sum of |v| over
    the entries of that lane and column, in float64 (an f32 sum of n
    values in any order is within (n - 1) * 2^-24 of that sum, so two
    orders differ by less)."""
    C, E, B = vals.shape
    lane = rel_dst.long()
    lane = torch.where((lane >= 0) & (lane < W), lane, W)
    idx = torch.arange(C, device=vals.device)[:, None] * (W + 1) + lane
    mag = torch.zeros((C * (W + 1), B), dtype=torch.float64,
                      device=vals.device)
    mag.scatter_add_(0, idx.reshape(-1, 1).expand(C * E, B),
                     vals.double().abs().reshape(C * E, B))
    return E * 2.0 ** -23 * mag.view(C, W + 1, B)[:, :W]
