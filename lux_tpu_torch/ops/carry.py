"""Kernels S7 and S8, the segmented carry over per-chunk partials and
the chunk reduce with that carry fused in: their wrappers, plain
PyTorch versions and launch counts (counterparts of
scripts/profile_slotted.py:127 ``carry`` and scripts/profile_kernel.py:82
``fused``).

    carry_combine:  out[i] = start[i] == 1 ? part[i] : out[i-1] + part[i]
    fused_carry:    the same over part[c, w] = sum of vals[c, e] over
                    every e with rel[c, e] == w

with a carry of 0 before row 0.  ``part`` [C, W] float32; ``vals``
[C, E] float32 and ``rel`` [C, E] int32 (the scripts' dtypes: lanes
outside [0, W), the script's pad W among them, add nothing; rows need
not be sorted); ``start`` int32 [C] or the scripts' [C, 1], where only
1 marks a start.  W <= 128 for ``fused_carry``.

The wrappers launch the CUDA kernels (csrc/carry.cu, csrc/fused_carry.cu)
for tensors on the card and take the plain versions only for tensors
on the CPU — there is no fallback from the card to the plain version.
``carry_combine.launches`` and ``fused_carry.launches`` count wrapper
calls that launched the kernel.  ``carry_combine`` enqueues one kernel
a call, a single-pass chained scan with decoupled look-back, and
allocates only its output: the kernel's tile statuses live in a scratch
kept per stream, zeroed once when it is allocated and grown (never
freed: a captured CUDA graph may still hold an older one).  Calls that
share a scratch must not overlap in time, and calls on one stream run
in order, so calls on any mix of streams never meet.  A CUDA graph
keeps the scratch of the stream it was captured on: a capture
allocates none, so make one call at the size on that stream before
it, and do not replay the graph beside calls on that stream.  A
look-back wait that lasts 4 s traps on the card, so a call that broke
these rules fails at the next synchronising call instead of hanging.
``fused_carry``
still runs three passes (csrc/fused_carry.cu) in one launch of its C
function.  No system path calls them: the probes in
lux_tpu_torch/probes do.
"""

from __future__ import annotations

import functools

import torch

from lux_tpu_torch.ops.chunk_reduce import (KernelInputError,
                                            KernelLaunchError,
                                            check_int32_lanes,
                                            chunk_partials_plain)

# rows (carry) and chunks (fused_carry) a tile: kTile in csrc/carry.cu
# and csrc/fused_carry.cu, which refuse any other value; kLanes columns
# a column group of csrc/carry.cu
CARRY_TILE = 64
CARRY_LANES = 128
FUSED_TILE = 32

# (device index, raw stream handle) -> [(status scratch, slots)], the
# newest last
_STATUS: dict = {}


def _check_start(start: torch.Tensor, C: int, device) -> torch.Tensor:
    if start.dtype != torch.int32:
        raise KernelInputError(f"start dtype {start.dtype} is not int32")
    if start.numel() != C or start.dim() not in (1, 2) or \
            (start.dim() == 2 and start.shape[1] != 1):
        raise KernelInputError(f"start {tuple(start.shape)} must be [C] or "
                               f"[C, 1] with C = {C}")
    if start.device != device:
        raise KernelInputError(f"start on {start.device}, data on {device}")
    return start.reshape(C)


def _check_part(part: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    if part.dtype != torch.float32:
        raise KernelInputError(f"part dtype {part.dtype} is not float32")
    if part.dim() != 2 or part.shape[1] < 1:
        raise KernelInputError(f"part {tuple(part.shape)} must be [C, W] "
                               f"with W >= 1")
    return _check_start(start, part.shape[0], part.device)


def _check_fused(vals, rel, start, W):
    check_int32_lanes(vals, rel, W, "[C, E]", 1)
    return _check_start(start, vals.shape[0], vals.device)


def carry_combine_plain(part: torch.Tensor,
                        start: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: segment ids by a cumsum of the starts
    (0 before the first start), a float64 inclusive cumsum down the
    rows, less its value just before each segment's first row, cast to
    float32."""
    st = _check_part(part, start) == 1
    seg = torch.cumsum(st, dim=0)
    cs = torch.cumsum(part.double(), dim=0)
    firsts = (cs - part.double())[st]          # cumsum before each start
    base = torch.cat([firsts.new_zeros((1, part.shape[1])), firsts])[seg]
    return (cs - base).float()


def _scratch(C: int, W: int, tile: int, device):
    nT = -(-C // tile)
    return (torch.empty((nT, W), dtype=torch.float32, device=device),
            torch.empty((nT,), dtype=torch.int32, device=device),
            torch.empty((nT, W), dtype=torch.float32, device=device))


def carry_slots(C: int, W: int) -> int:
    """Status slots a call at [C, W] takes: one a (tile, column
    group)."""
    return -(-C // CARRY_TILE) * -(-W // CARRY_LANES)


def _status(device, stream: int, slots: int):
    """(scratch, its slots) of calls on ``stream`` (the raw handle of
    the current stream of ``device``) with room for ``slots``.  A new
    one is zeroed on that stream when it is allocated, never while a
    graph is being captured (the zeroing would be captured and
    replayed)."""
    held = _STATUS.setdefault((device.index, stream), [])
    if held and held[-1][1] >= slots:
        return held[-1]
    if torch.cuda.is_current_stream_capturing():
        raise KernelInputError(
            f"carry_combine needs a status scratch of {slots} slots on a "
            f"stream that is capturing a CUDA graph: make one call at "
            f"this size on that stream before the capture")
    cap = max(slots, 2 * held[-1][1]) if held else slots
    nbytes = _carry_fns()[1](cap)
    held.append((torch.zeros(-(-nbytes // 8), dtype=torch.int64,
                             device=device), cap))
    return held[-1]


@functools.lru_cache(maxsize=None)
def _carry_fns():
    """(lux_carry, lux_carry_status_bytes) of the built kernel, looked
    up once: a call through _kernels.launch looks it up each time."""
    from lux_tpu_torch import _kernels
    lib = _kernels.load("carry")
    return lib.lux_carry, lib.lux_carry_status_bytes


def _launch_carry(part, st, out):
    C, W = part.shape
    # the raw stream handle: torch.cuda.current_stream() builds a
    # Stream object, several microseconds of host time a call
    stream = torch._C._cuda_getCurrentRawStream(part.device.index)
    status, cap = _status(part.device, stream, carry_slots(C, W))
    err = _carry_fns()[0](part.data_ptr(), st.data_ptr(), out.data_ptr(),
                          status.data_ptr(), cap, C, W, CARRY_TILE, stream)
    if err != 0:
        raise KernelLaunchError(f"carry launch failed with cudaError_t "
                                f"{err}")


def carry_combine(part: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Segmented carry [C, W] -> [C, W]: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    st = _check_part(part, start)
    if part.device.type == "cpu":
        return carry_combine_plain(part, start)
    if not (part.is_contiguous() and st.is_contiguous()):
        raise KernelInputError("part and start must be contiguous")
    if part.device.type != "cuda":
        raise KernelInputError(f"no carry_combine path for device "
                               f"{part.device}")
    out = torch.empty_like(part)
    if part.shape[0] == 0:
        return out
    if part.device.index == torch.cuda.current_device():
        _launch_carry(part, st, out)
    else:
        with torch.cuda.device(part.device):
            _launch_carry(part, st, out)
    from lux_tpu_torch import _kernels
    _kernels.counted(carry_combine, "carry", (part, st), (out,))
    return out


carry_combine.launches = 0


def _lanes_int8(rel: torch.Tensor, W: int) -> torch.Tensor:
    """int32 lanes as B1's int8 lanes: outside [0, W) becomes the -1 pad."""
    return torch.where((rel >= 0) & (rel < W), rel, -1).to(torch.int8)


def fused_carry_plain(vals: torch.Tensor, rel: torch.Tensor,
                      start: torch.Tensor, W: int) -> torch.Tensor:
    """The plain PyTorch version: B1's plain per-chunk sums, then the
    plain carry."""
    _check_fused(vals, rel, start, W)
    part = chunk_partials_plain(vals, _lanes_int8(rel, W), W, "sum")
    return carry_combine_plain(part, start)


def fused_carry(vals: torch.Tensor, rel: torch.Tensor, start: torch.Tensor,
                W: int) -> torch.Tensor:
    """Per-chunk sums with the segmented carry fused in, [C, E] ->
    [C, W]: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    st = _check_fused(vals, rel, start, W)
    if vals.device.type == "cpu":
        return fused_carry_plain(vals, rel, start, W)
    if vals.device.type != "cuda":
        raise KernelInputError(f"no fused_carry path for device "
                               f"{vals.device}")
    if not (vals.is_contiguous() and rel.is_contiguous()
            and st.is_contiguous()):
        raise KernelInputError("vals, rel and start must be contiguous")
    C, E = vals.shape
    out = torch.empty((C, W), dtype=torch.float32, device=vals.device)
    if C == 0:
        return out
    agg, first, cin = _scratch(C, W, FUSED_TILE, vals.device)
    from lux_tpu_torch import _kernels

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        _kernels.launch("fused_carry", vals.data_ptr(), rel.data_ptr(),
                        st.data_ptr(), out.data_ptr(), agg.data_ptr(),
                        first.data_ptr(), cin.data_ptr(), C, E, W,
                        FUSED_TILE, stream)
    _kernels.counted(fused_carry, "fused_carry", (vals, rel, st),
                     (out,))
    return out


fused_carry.launches = 0
