"""Start and join the ranks of one CP process group on this host.

:func:`spawn_ranks` starts ``world`` processes with
``torch.multiprocessing`` and joins them under a deadline: a rank that
raises fails the whole group, and a group that outlives the deadline (a
deadlocked collective) is killed and reported.  :func:`init_rank`
joins a rank to its group through a ``FileStore`` rendezvous file, with
the backend the caller names (``"nccl"`` or ``"gloo"``; never
inferred), and picks its device: ``cuda:(rank % device_count)``, or the
CPU when asked.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.comm import CPComm
from repro_torch.device import resolve_device

__all__ = ["spawn_ranks", "init_rank"]


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


def init_rank(rank: int, world: int, backend: str, store_path: str,
              device: str = "cuda") -> tuple[CPComm, torch.device]:
    """Join the default process group as ``rank`` of ``world`` through
    the rendezvous file ``store_path``; returns this rank's CP group and
    its device."""
    dev = resolve_device(device)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    return CPComm(backend), dev
