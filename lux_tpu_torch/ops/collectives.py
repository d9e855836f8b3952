"""Every ``torch.distributed`` call of the port: the parts mesh's
collectives (counterparts of lux_tpu/engine/pull.py:814 and :874, the
state all_gather; lux_tpu/engine/push.py:664-790, the count's psum,
the queue all_gather and the pmin; lux_tpu/ops/owner.py:433-497, the
owner exchange's psum_scatter, all_to_all and ring; and
lux_tpu/parallel/multihost.py:78-106, the host-side agreement).

The reference runs one SPMD program per mesh under ``shard_map`` and
names an axis; here every rank is one process holding one device, and
each call names the :class:`~lux_tpu_torch.parallel.mesh.Mesh` whose
process group it runs over.  A tensor leads with the rank's part rows;
a collective over part rows keeps the parts in rank order, which is
part order, since rank ``r`` holds the contiguous rows ``[r*P/world,
(r+1)*P/world)``.

Tensors travel on the mesh's device: NCCL moves CUDA tensors, gloo CPU
ones, and nothing is staged through the host (``allgather_host`` is
the one host-side call, for planning-time agreement on numpy values).
Bool tensors ride as uint8 (the active masks), with the same bits.

Only names that exist in torch 2.11 and 2.13 are used:
``reduce_scatter_tensor`` warns "deprecated" on 2.13 in favour of a
name 2.11 may not have.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

# torch 2.13 marks these two names deprecated in favour of names that
# torch 2.11 may not have; the port keeps the names both versions carry
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r".*`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def reduce_op(kind: str):
    """The ReduceOp of a reduction kind ("sum", "min" or "max")."""
    try:
        return _OPS[kind]
    except KeyError:
        raise ValueError(f"unknown reduction {kind!r}") from None


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backends move: bool as uint8."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def all_gather_parts(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part rows [lp, ...] -> every rank's, in part order
    [world * lp, ...] (``all_gather_into_tensor``; the reference's
    ``all_gather(..., tiled=True)``)."""
    src = _wire(x)
    out = src.new_empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    return _unwire(out, x.dtype)


def reduce_scatter_parts(mesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Every rank's [P, ...] contributions -> this rank's rows [P/world,
    ...] of their elementwise ``kind`` across ranks
    (``reduce_scatter_tensor``; the reference's ``psum_scatter``)."""
    src = x.contiguous()
    if src.shape[0] % mesh.world:
        raise ValueError(f"{src.shape[0]} rows do not split over "
                         f"{mesh.world} ranks")
    out = src.new_empty((src.shape[0] // mesh.world,)
                        + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=reduce_op(kind),
                               group=mesh.group)
    return out


def all_to_all_parts(mesh, x: torch.Tensor) -> torch.Tensor:
    """[P, ...] rows split in world equal blocks, block ``j`` to rank
    ``j`` -> the blocks every rank sent here, in rank order [P, ...]
    (``all_to_all_single``; the reference's ``all_to_all(...,
    tiled=True)``)."""
    src = _wire(x)
    if src.shape[0] % mesh.world:
        raise ValueError(f"{src.shape[0]} rows do not split over "
                         f"{mesh.world} ranks")
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return _unwire(out, x.dtype)


def ring_shift(mesh, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to rank ``rank + 1`` and receive rank ``rank - 1``'s
    (mod world), one ``batch_isend_irecv`` (the reference's
    ``ppermute`` over the ring ``j -> j + 1``)."""
    src = _wire(x)
    out = torch.empty_like(src)
    if mesh.world == 1:
        out.copy_(src)
        return _unwire(out, x.dtype)
    ranks = mesh.ranks
    nxt = ranks[(mesh.rank + 1) % mesh.world]
    prv = ranks[(mesh.rank - 1) % mesh.world]
    ops = [dist.P2POp(dist.isend, src, nxt, group=mesh.group),
           dist.P2POp(dist.irecv, out, prv, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(out, x.dtype)


def all_reduce_scalar(mesh, x: torch.Tensor, kind: str = "sum"):
    """A small tensor's elementwise ``kind`` across ranks, into a new
    tensor (the reference's ``psum`` / ``pmin`` / ``pmax``)."""
    out = _wire(x).clone()
    if x.dtype == torch.bool:
        out = out.to(torch.int32)
    dist.all_reduce(out, op=reduce_op(kind), group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def allgather_host(mesh, value) -> list:
    """A host (numpy or picklable) value of every rank, in rank order:
    planning-time agreement (the reference's ``process_allgather``).
    ``mesh`` None, or no process group: this process's value alone."""
    if mesh is None:
        if not dist.is_initialized():
            return [value]
        group, world = None, dist.get_world_size()
    else:
        group, world = mesh.group, mesh.world
    out = [None] * world
    dist.all_gather_object(out, value, group=group)
    return out


def allreduce_host(mesh, x, op: str = "max"):
    """Elementwise ``op`` ("max", "min" or "sum") of a host numpy value
    across ranks (identity on one process)."""
    vals = [np.asarray(v) for v in allgather_host(mesh, np.asarray(x))]
    return {"max": np.max, "min": np.min, "sum": np.sum}[op](
        np.stack(vals), axis=0)


def barrier(mesh) -> None:
    """Every rank of the mesh reaches this point."""
    dist.barrier(group=mesh.group)
