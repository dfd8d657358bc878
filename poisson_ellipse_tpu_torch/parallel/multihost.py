"""Rank processes and their process group (the ``MPI_Init`` lifecycle).

The counterpart of ``poisson_ellipse_tpu.parallel.multihost``. The
reference starts its ranks with ``mpirun`` (``README.md:102``) and brackets
them with ``MPI_Init``/``MPI_Finalize`` (``poisson_mpi_cuda2.cu:986-990,
1036``); JAX runs one process per host over ``jax.distributed``. Here each
rank is a process in a ``torch.distributed`` group:

- ``initialize_multihost`` joins the group: from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when it is set, else from an
  explicit rank, world size and rendezvous (``file://`` in a temporary
  directory works where a TCP one is not wanted). The backend follows the
  layout (``utils.device.backend_for``): NCCL when each rank has a card of
  its own, gloo on the CPU and when ranks share a card;
- ``spawn`` starts ``world`` rank processes on this host with
  ``torch.multiprocessing`` (the spawn method), runs a function of this
  package in each, and returns rank 0's result. Each rank sets one CPU
  thread; a child imports torch and this package only;
- ``global_mesh`` and ``process_info`` are JAX's helpers over the group.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_module
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.parallel.mesh import Mesh, make_mesh
from poisson_ellipse_tpu_torch.utils.device import backend_for, rank_device

# how long a collective may wait for a peer before the group gives up
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def torchrun_env() -> bool:
    """Whether torchrun's environment describes this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def initialize_multihost(rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         init_method: Optional[str] = None,
                         device=None, backend: Optional[str] = None) -> None:
    """Join the default process group (a no-op once joined).

    Without arguments it reads torchrun's environment; otherwise it needs
    ``rank``, ``world_size`` and ``init_method``. ``device`` ("cuda" by
    default, or "cpu") picks the backend unless ``backend`` is given; on a
    card the rank's device is made current first."""
    if dist.is_initialized():
        return
    if rank is None and world_size is None and init_method is None:
        if not torchrun_env():
            raise ValueError(
                "initialize_multihost needs rank, world_size and "
                "init_method, or torchrun's environment (RANK, WORLD_SIZE, "
                "MASTER_ADDR)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    if rank is None or world_size is None or init_method is None:
        raise ValueError("pass rank, world_size and init_method together")
    dev = rank_device(device, rank, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or backend_for(dev, world_size), init_method=init_method,
        rank=rank, world_size=world_size, timeout=GROUP_TIMEOUT)


def shutdown_multihost() -> None:
    """``MPI_Finalize``: leave the process group, if this process joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device=None) -> Mesh:
    """The near-square mesh over every rank of the group."""
    return make_mesh(None, device)


def process_info() -> tuple[int, int]:
    """(rank, world size): the ``Comm_rank``/``Comm_size`` analog."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_jobs(jobs) -> list:
    """Run each job ``(function, args, kwargs)`` in order on this rank and
    return the results: the rank function of ``spawn`` that runs many calls
    of this package in one group. Every rank runs the same jobs."""
    return [fn(*args, **kwargs) for fn, args, kwargs in jobs]


def _rank_main(rank: int, world: int, init_method: str, device,
               target: Callable, args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        initialize_multihost(rank, world, init_method, device)
        out = target(*args)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown_multihost()


def spawn(target: Callable, world: int, args: tuple = (), device="cuda",
          timeout: float = 1800.0):
    """Run ``target(*args)`` in ``world`` new rank processes joined in one
    group on ``device``'s type, and return rank 0's result.

    ``target`` must be a module-level function of this package (a child
    unpickles it by name). A rank that raises, or a run past ``timeout``
    seconds, ends every rank and raises ``RuntimeError`` with the rank's
    traceback."""
    if world < 1:
        raise ValueError("world must be >= 1")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rendezvous = tempfile.mkdtemp(prefix="pe_rendezvous_")
    init_method = "file://" + os.path.join(rendezvous, "group")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_method, device, target, args,
                               results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        reports: dict = {}
        while len(reports) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_module.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"a rank process exited with code {dead[0].exitcode}"
                        " before it reported") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the {world} ranks did not finish within "
                        f"{timeout:g} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            reports[rank] = value
        for p in procs:
            p.join(timeout=60)
        return reports[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
