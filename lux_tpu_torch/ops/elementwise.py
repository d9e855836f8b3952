"""Kernel S4/S5, the TPU probe scripts' elementwise bodies: the wrapper
of one templated kernel, the plain PyTorch version of each body and the
launch count (counterpart of scripts/profile_true.py:175 ``chain``, S4,
and the ``run`` that scripts/profile_vpu.py:43 ``mk`` builds around a
body, S5).

    add       a + b                                 f32, f32
    chain10   10 x (a = a + b)                      f32, f32 or bf16, bf16
    chain32   acc = v; 32 x (acc = acc * c + v),    f32 (S4, one input)
              c = 1.0000001
    cmpsel16  sum over wd < 16 of where(r == wd, v, 0)   f32, int32
    cmpmul16  sum over wd < 16 of v * (r == wd)          f32, int32

Each body works element by element on inputs of one shape; the output
has the first input's shape and dtype.  The kernel rounds after every
op as the plain version's eager ops do, so the two are bit-equal, NaN
and -0.0 included (the chain32 step is not contracted to an FMA, and
bf16 rounds after every add).  The scripts' aliased call (``x, x``) is
allowed: the kernel then reads the array once.

``elementwise`` launches the CUDA kernel (csrc/elementwise.cu) for
tensors on the card and takes ``elementwise_plain`` only for tensors
on the CPU — there is no fallback from the card to the plain version.
``elementwise.launches`` counts kernel launches.  No system path calls
it: the probes lux_tpu_torch/probes/profile_true.py and profile_vpu.py
do.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError

CHAIN_C = 1.0000001     # scripts/profile_true.py:171; torch rounds it to f32
# csrc/elementwise.cu's tile: THREADS x UNROLL[body] vectors of
# VECTOR_BYTES, one CTA a tile (chip_smoke.py tests the element counts
# around them)
VECTOR_BYTES = 16
THREADS = 256
UNROLL = {"add": 1, "chain10": 1, "chain32": 2, "cmpsel16": 1,
          "cmpmul16": 1}


def _add(a, b):
    return a + b


def _chain10(a, b):
    for _ in range(10):
        a = a + b
    return a


def _chain32(v, _b):
    acc = v
    for _ in range(32):
        acc = acc * CHAIN_C + v
    return acc


def _cmpsel16(v, r):
    acc = torch.zeros_like(v)
    for wd in range(16):
        acc = acc + torch.where(r == wd, v, 0.0)
    return acc


def _cmpmul16(v, r):
    acc = torch.zeros_like(v)
    for wd in range(16):
        acc = acc + v * (r == wd).to(v.dtype)
    return acc


# body -> (plain version, {first input dtype: (second input dtype or
# None for one input, the C entry's body id)})
BODIES = {
    "add": (_add, {torch.float32: (torch.float32, 0)}),
    "chain10": (_chain10, {torch.float32: (torch.float32, 1),
                           torch.bfloat16: (torch.bfloat16, 2)}),
    "chain32": (_chain32, {torch.float32: (None, 3)}),
    "cmpsel16": (_cmpsel16, {torch.float32: (torch.int32, 4)}),
    "cmpmul16": (_cmpmul16, {torch.float32: (torch.int32, 5)}),
}


def _check(body: str, a: torch.Tensor, b) -> int:
    """The C entry's body id for (body, a, b), or KernelInputError."""
    if body not in BODIES:
        raise KernelInputError(f"unknown body {body!r} "
                               f"({', '.join(BODIES)})")
    types = BODIES[body][1]
    if a.dtype not in types:
        raise KernelInputError(f"{body}: first input dtype {a.dtype} is not "
                               f"{' or '.join(map(str, types))}")
    b_dtype, body_id = types[a.dtype]
    if b_dtype is None:
        if b is not None:
            raise KernelInputError(f"{body} takes one input")
        return body_id
    if b is None:
        raise KernelInputError(f"{body} takes two inputs")
    if b.dtype != b_dtype:
        raise KernelInputError(f"{body}: second input dtype {b.dtype} is "
                               f"not {b_dtype}")
    if b.shape != a.shape:
        raise KernelInputError(f"{body}: shapes {tuple(a.shape)} and "
                               f"{tuple(b.shape)} differ")
    if b.device != a.device:
        raise KernelInputError(f"{body}: inputs on {a.device} and "
                               f"{b.device}")
    return body_id


def elementwise_plain(body: str, a: torch.Tensor,
                      b: torch.Tensor = None) -> torch.Tensor:
    """The plain PyTorch version: the script's body as eager ops."""
    _check(body, a, b)
    return BODIES[body][0](a, b)


def elementwise(body: str, a: torch.Tensor,
                b: torch.Tensor = None) -> torch.Tensor:
    """Body ``body`` over ``a`` (and ``b``): the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    body_id = _check(body, a, b)
    if a.device.type == "cpu":
        return elementwise_plain(body, a, b)
    if a.device.type != "cuda":
        raise KernelInputError(f"no elementwise path for device {a.device}")
    b = a if b is None else b
    if not (a.is_contiguous() and b.is_contiguous()):
        raise KernelInputError("inputs must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise KernelInputError("inputs must be 16-byte aligned (the kernel "
                               "moves 16 B vectors)")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    if a.numel() == 0:
        return out
    from lux_tpu_torch import _kernels

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _kernels.launch("elementwise", body_id, a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), a.numel(), stream)
    elementwise.launches += 1
    return out


elementwise.launches = 0
