"""Run one function on every rank of a fresh process group on this
host (counterpart of tests/mp_worker.py and tests/test_multiprocess.py:
24-29, the reference's two-process launch).

``spawn_ranks(fn, world, device)`` starts ``world`` processes by the
``spawn`` start method, joins them into a group over a ``FileStore``
in a temporary directory (no TCP port, so concurrent launches cannot
collide), builds each rank's :class:`~lux_tpu_torch.parallel.mesh.Mesh`
and calls ``fn(mesh, *args)`` there; the ranks' return values come back
in rank order.  ``fn`` must be a module-level function of an importable
module.  Each rank runs one intra-op thread.  A rank that raises, dies
or outlives ``timeout_s`` fails the launch: every rank is killed and
:class:`RankError` names what happened.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank of a launch raised, died or ran past its deadline."""


def _rank_main(fn, rank, world, device, store_path, q, args, timeout_s):
    import torch.distributed as dist

    from lux_tpu_torch.parallel import multihost
    from lux_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        multihost.initialize(store=store, world_size=world, rank=rank,
                             device=device, timeout_s=timeout_s)
        mesh = make_mesh(world, device)
        out = fn(mesh, *args)
        q.put((rank, True, out))
    except BaseException:                       # noqa: BLE001
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, device="cpu", timeout_s: float = 120.0,
                args: tuple = ()) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks
    (gloo on ``device="cpu"``, NCCL on the cards) -> their results in
    rank order.  Raises RankError (after killing every rank) if a rank
    raises, exits without a result or the deadline passes."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lux_ranks_")
    q = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, world, str(device), os.path.join(tmp, "store"), q,
              tuple(args), timeout_s))
        for r in range(world)]
    deadline = time.monotonic() + float(timeout_s)
    results, done = [None] * world, set()
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            try:
                rank, ok, payload = q.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RankError(
                        f"ranks {sorted(set(range(world)) - done)} of "
                        f"{world} passed the {timeout_s:g} s deadline"
                    ) from None
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # a result may still be in the pipe: one last look
                    try:
                        rank, ok, payload = q.get(timeout=1.0)
                    except queue.Empty:
                        raise RankError(
                            f"ranks {dead} exited (codes "
                            f"{[procs[r].exitcode for r in dead]}) "
                            f"without a result") from None
                else:
                    continue
            if not ok:
                raise RankError(f"rank {rank} of {world} failed:\n"
                                f"{payload}")
            results[rank] = payload
            done.add(rank)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)

