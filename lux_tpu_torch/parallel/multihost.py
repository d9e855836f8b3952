"""Process-group initialization and the host side of a several-process
run (counterpart of lux_tpu/parallel/multihost.py: ``initialize`` :31,
``global_mesh`` :69, ``fetch_global`` :78, ``allreduce_host`` :92,
``process_parts`` :108).

The reference joins a ``jax.distributed`` process group and spans every
device of the slice with one mesh.  Here each process drives one
device, and the group is ``torch.distributed``'s:

    from lux_tpu_torch.parallel import multihost
    multihost.initialize()                # torchrun's env, or nothing
    mesh = multihost.global_mesh()        # every rank, one card each
    sg = ShardedGraph.build_from_file(
        path, P, parts=multihost.process_parts(P, mesh))
    eng = PullEngine(sg, program, mesh=mesh)

started as ``torchrun --nproc-per-node N <script>``.  A process that
nothing configured (no ``init_method``, no launcher environment) runs
as a group of one on an in-process store; any other failure to join
raises, since computing per-process answers where a group was asked for
is the worst way to fail (the reference's rule).
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from lux_tpu_torch.ops import collectives
from lux_tpu_torch.parallel.mesh import (Mesh, backend_of, default_device,
                                         local_part_rows, make_mesh)

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def launched() -> bool:
    """Whether a launcher (torchrun) configured this process's group in
    its environment."""
    return all(k in os.environ for k in _ENV)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               *, device=None, store=None,
               timeout_s: float | None = None) -> None:
    """Join the process group.  Explicit ``init_method`` (a
    ``tcp://host:port`` or ``file://`` URL) or ``store`` with
    ``world_size`` and ``rank``; else the launcher's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); else, when
    nothing is configured, a group of one on an in-process HashStore.
    The backend is the ``device``'s (None: the card, NCCL; "cpu":
    gloo).  A group already joined is kept."""
    if dist.is_initialized():
        return
    dev = torch.device("cuda") if device is None else torch.device(device)
    backend = backend_of(dev)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    explicit = (init_method is not None or store is not None
                or world_size is not None or rank is not None)
    if explicit:
        if world_size is None or rank is None:
            raise ValueError("an explicit process group needs world_size "
                             "and rank")
        if store is None and init_method is None:
            raise ValueError("an explicit process group needs "
                             "init_method or store")
        dist.init_process_group(backend, init_method=init_method,
                                store=store, world_size=int(world_size),
                                rank=int(rank), **kw)
    elif launched():
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        logging.getLogger(__name__).info(
            "no process group configured; running as a group of one")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kw)
    if dev.type == "cuda":
        torch.cuda.set_device(default_device(dist.get_rank()))


def global_mesh(world: int | None = None, device=None) -> Mesh | None:
    """The parts mesh over every rank of the group (or its first
    ``world``), each rank on its own card (``device`` None) or the
    CPU."""
    return make_mesh(world, device)


def fetch_global(x, mesh: Mesh | None = None,
                 num_parts: int | None = None) -> np.ndarray:
    """Device state -> host numpy with ALL part rows: a mesh's rows are
    all_gathered from every rank first (every rank must call this).
    No mesh: the tensor's own rows."""
    if mesh is None:
        return x.detach().cpu().numpy()
    full = collectives.all_gather_parts(mesh, x.detach())
    if num_parts is not None and full.shape[0] != num_parts:
        raise ValueError(f"gathered {full.shape[0]} part rows, expected "
                         f"{num_parts}")
    return full.cpu().numpy()


def allreduce_host(x, op: str = "max", mesh: Mesh | None = None):
    """Elementwise allreduce of a HOST numpy value across the group (the
    pair planner's common depth profile, the owner layout's chunk count,
    the sparse view's pad): identity on one process."""
    return collectives.allreduce_host(mesh, x, op)


def process_parts(num_parts: int, mesh: Mesh | None = None) -> range:
    """The contiguous part ids this process loads (``local_parts``): all
    of them on one process.  ``num_parts`` must split evenly."""
    if mesh is not None:
        return local_part_rows(mesh, num_parts)
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if num_parts % nproc:
        raise ValueError(f"num_parts={num_parts} must divide evenly over "
                         f"{nproc} processes")
    per = num_parts // nproc
    return range(pid * per, (pid + 1) * per)
