"""The parts mesh as a ``torch.distributed`` process group (counterpart
of lux_tpu/parallel/mesh.py: ``PARTS_AXIS`` :18, ``make_mesh`` :21,
``local_part_rows`` :41, ``shard_over_parts`` :52).

The reference lays a 1-D ``Mesh('parts')`` over its devices and runs
one SPMD program under ``shard_map``.  PyTorch's idiom is one process a
device: a :class:`Mesh` is the process group those processes share,
this process's rank in it and the device it drives.  With ``P`` parts
over ``world`` ranks, rank ``r`` holds the contiguous part rows
``[r*P/world, (r+1)*P/world)`` (``local_parts``), the rows the
reference's parts sharding gives its devices in order.

Backend and device go together: NCCL on ``cuda:<local rank>`` (the
default) or gloo on the CPU (``device="cpu"``).  A mesh whose device
does not match the process group's backend raises; there is no switch
from one to the other, and no CUDA tensor is staged through the host
for a collective.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

PARTS_AXIS = "parts"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the parts mesh: its process group (None: the
    default group), the group's size ``world``, this process's ``rank``
    in it, the global ranks of its members (``ranks``), the device the
    rank drives and the backend that moves its tensors."""

    group: object
    world: int
    rank: int
    device: torch.device
    backend: str
    ranks: tuple = ()

    def __post_init__(self):
        if not self.ranks:
            object.__setattr__(self, "ranks", tuple(range(self.world)))
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world}")

    def local_parts(self, num_parts: int) -> range:
        """The contiguous part rows this rank holds."""
        return local_part_rows(self, num_parts)


def check_divisible(num_parts: int, mesh: Mesh) -> None:
    """The reference's rule (lux_tpu/engine/pull.py:226): the parts
    split evenly over the ranks."""
    if num_parts % mesh.world:
        raise ValueError(f"num_parts={num_parts} not divisible by mesh "
                         f"size {mesh.world}")


def local_part_rows(mesh: Mesh, num_parts: int) -> range:
    """The global part rows rank ``mesh.rank`` holds (sorted)."""
    check_divisible(num_parts, mesh)
    per = num_parts // mesh.world
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def backend_of(device) -> str:
    """The backend a device's tensors travel by: nccl or gloo."""
    dev = torch.device(device)
    try:
        return _BACKEND[dev.type]
    except KeyError:
        raise ValueError(f"no collective backend for device {dev}") \
            from None


def default_device(rank: int | None = None) -> torch.device:
    """``cuda:<local rank>``: LOCAL_RANK from the launcher, else the
    global rank modulo the cards of this host."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        r = dist.get_rank() if rank is None else rank
        n = max(1, torch.cuda.device_count())
        local = r % n
    return torch.device("cuda", int(local))


def make_mesh(world: int | None = None, device=None) -> Mesh | None:
    """The parts mesh over the first ``world`` ranks of the initialized
    process group (None: all of them), driving ``device`` (None:
    ``cuda:<local rank>`` over NCCL; ``"cpu"`` over gloo).  A world
    larger than the group raises; a smaller one makes a subgroup, which
    every rank must call this to create, and ranks outside it get None.
    The group's backend must be the device's."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call lux_tpu_torch.parallel.multihost."
            "initialize() (or torch.distributed.init_process_group) "
            "before make_mesh")
    have = dist.get_world_size()
    n = have if world is None else int(world)
    if not 1 <= n <= have:
        raise ValueError(f"requested a mesh of {n} ranks, the process "
                         f"group has {have}")
    rank = dist.get_rank()
    dev = default_device(rank) if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = default_device(rank)
    want = backend_of(dev)
    got = str(dist.get_backend()).lower()
    if want not in got.split(":") and want not in got:
        raise ValueError(
            f"device {dev} needs the {want} backend, the process group "
            f"runs {got}; initialize the group for this device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group, ranks = None, tuple(range(have))
    if n < have:
        ranks = tuple(range(n))
        group = dist.new_group(list(ranks), backend=want)
        if rank >= n:
            return None
    return Mesh(group=group, world=n, rank=rank, device=dev, backend=want,
                ranks=ranks)


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device of an engine on ``mesh``: the mesh's (``device``
    None), or ``device`` when it names the mesh's; another raises."""
    if device is None:
        return mesh.device
    dev = torch.device(device)
    if dev.type != mesh.device.type or (
            dev.index is not None and dev != mesh.device):
        raise ValueError(f"device {dev} is not the mesh's "
                         f"{mesh.device}: a rank computes on its own")
    return mesh.device


def rows_of(mesh: Mesh | None, x, num_parts: int):
    """This rank's rows of a part-major array: ``x[part rows]`` when it
    carries all ``num_parts`` rows, ``x`` itself when it carries only
    the rank's (a local-parts build).  Any other leading dimension
    raises."""
    if mesh is None or x is None:
        return x
    rows = local_part_rows(mesh, num_parts)
    n = x.shape[0]
    if n == num_parts:
        return x[rows.start:rows.stop]
    if n == len(rows):
        return x
    raise ValueError(f"array of {n} rows is neither all {num_parts} "
                     f"parts nor this rank's {len(rows)}")


def shard_over_parts(mesh: Mesh, x, num_parts: int):
    """A part-major array (numpy or tensor) -> this rank's part rows
    (``rows_of``) as a tensor on the mesh's device."""
    x = rows_of(mesh, x, num_parts)
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh.device)
