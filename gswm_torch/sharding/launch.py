"""Run a function as every rank of a process group of new processes.

``spawn(fn, world, args, device_type)`` starts ``world`` processes with
``torch.multiprocessing`` (the spawn start method: ``fn`` is pickled by name,
so it must live in a module that imports without side effects), joins them
to one process group through a ``FileStore`` in a fresh temporary
directory (no TCP port), runs ``fn(*args)`` on each and returns what each
returned, in rank order.  The backend is asked for by name: ``backend``, or
the one of ``device_type`` (gloo for the CPU, NCCL for CUDA).  Two ranks on
one card need gloo: NCCL refuses two ranks on one device.

``run_world(fn, args, device_type, spawn)`` is what the multi-rank tools
call: the process group of the caller when one is joined, else ``spawn``
new ranks, else the group a launcher such as ``torchrun`` describes in the
environment, else a group of one.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from gswm_torch.sharding.mesh import BACKENDS, init_process_group


def _entry(rank: int, fn: Callable, world: int, device_type: str, backend: str,
           directory: str, args: tuple) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), device_type: str = "cuda",
          backend: Optional[str] = None) -> list:
    """``fn(*args)`` on ranks 0 .. world - 1 of a new process group of new
    processes, on the card unless ``device_type`` names the CPU; their
    return values, in rank order.  A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    backend = backend or BACKENDS[device_type]
    with tempfile.TemporaryDirectory(prefix="gswm_spawn_") as directory:
        mp.start_processes(_entry, args=(fn, world, device_type, backend, directory, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def run_world(fn: Callable, args: tuple = (), device_type: str = "cuda",
              spawn_ranks: int = 0) -> list:
    """``fn(*args)`` on every rank of one process group; rank 0's result
    first.  The group: the caller's when it has joined one (its own result
    alone is returned), else ``spawn_ranks`` new processes, else the one
    ``torchrun`` describes (``RANK`` in the environment), else one of a
    single process, which is left when ``fn`` returns."""
    if dist.is_initialized():
        return [fn(*args)]
    if spawn_ranks:
        return spawn(fn, spawn_ranks, args, device_type)
    if "RANK" in os.environ:
        init_process_group(device_type)
    else:
        init_process_group(device_type, store=dist.HashStore(), rank=0, world_size=1)
    try:
        return [fn(*args)]
    finally:
        dist.destroy_process_group()
