"""Start and join the ranks of one process group.

:func:`spawn_ranks` starts ``world`` processes on this host with
``torch.multiprocessing`` and joins them under a deadline: a rank that
raises fails the whole group, and a group that outlives the deadline (a
deadlocked collective) is killed and reported.  :func:`init_rank`
joins a rank to its group with the backend the caller names
(``"nccl"`` or ``"gloo"``; never inferred), and picks its device:

* through a ``FileStore`` rendezvous file (ranks this host started):
  ``cuda:(rank % device_count)``;
* through ``env://`` (``store_path=None``), the rendezvous of ranks that
  ``torchrun`` (or any launcher) started on one or more hosts: it reads
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT`` (:func:`env_rank`), and the device is
  ``cuda:LOCAL_RANK`` (modulo the host's cards, so ranks may share one);

or the CPU when asked.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.comm import CPComm
from repro_torch.device import resolve_device

__all__ = ["spawn_ranks", "init_rank", "env_rank", "ENV_KEYS"]

#: the variables of an env:// rendezvous (``torchrun`` sets them)
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def spawn_ranks(fn, world: int, args=(), timeout: float | None = None):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes and wait for
    all of them.  Raises what a rank raised, or ``TimeoutError`` (after
    killing every rank) once ``timeout`` seconds have passed."""
    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def env_rank() -> tuple[int, int] | None:
    """``(RANK, WORLD_SIZE)`` where every variable of an env://
    rendezvous is set, else None."""
    if not all(k in os.environ for k in ENV_KEYS):
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


def init_rank(rank: int, world: int, backend: str, store_path: str | None,
              device: str = "cuda") -> tuple[CPComm, torch.device]:
    """Join the default process group as ``rank`` of ``world`` through
    the rendezvous file ``store_path``, or through ``env://`` where it is
    None (the environment must then name the same rank and world);
    returns this rank's CP group and its device."""
    dev = resolve_device(device)
    if store_path is None:
        if env_rank() != (rank, world):
            raise ValueError(
                f"an env:// rendezvous of rank {rank} of {world} needs "
                f"{', '.join(ENV_KEYS)} set to it (found {env_rank()})")
        local = int(os.environ["LOCAL_RANK"])
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        local, on_host = rank, world
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // on_host))
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if store_path is None:
        kw["init_method"] = "env://"
    else:
        kw["store"] = dist.FileStore(store_path, world)
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return CPComm(backend), dev
