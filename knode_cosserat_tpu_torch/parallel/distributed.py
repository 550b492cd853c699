"""Multi-process start-up on ``torch.distributed``.

PyTorch counterpart of ``knode_cosserat_tpu/parallel/distributed.py`` (which
starts ``jax.distributed``). The reference has no distributed backend at all
(its only transports are pipes, serial and ROS topics); here one process runs
per card (NCCL), or per CPU worker (gloo), and the ("data", "seq", "model")
mesh of parallel/mesh.py spans them all.

Call ``init_distributed()`` once per process before building a mesh. It
reads its arguments first, then the environment ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); with neither it does nothing and returns False, as the JAX
package's does on a single host. On a machine with CUDA each rank takes the
card ``LOCAL_RANK`` (``torch.cuda.set_device``), so ``device.default_device()``
(``torch.device("cuda")``) is the rank's own card.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multihost", "process_summary"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Start the default process group when running multi-process; returns
    True if distributed mode is active (also when a group already runs).

    coordinator_address: ``"host:port"`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``); num_processes: the world size (default
    ``WORLD_SIZE``); process_id: this process's rank (default ``RANK``).
    The backend is NCCL where CUDA is available, gloo otherwise."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    if addr is None and world is None:
        return False
    if addr is None or world is None:
        raise ValueError("init_distributed needs the coordinator's address "
                         "and the number of processes (arguments or "
                         "MASTER_ADDR / MASTER_PORT / WORLD_SIZE)")
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    cuda = torch.cuda.is_available()
    if cuda:
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{addr}", world_size=world,
                            rank=rank)
    return True


def is_multihost() -> bool:
    """True when more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    if not dist.is_initialized():
        return "process 0/1 (no process group)"
    dev = (f"cuda:{torch.cuda.current_device()}"
           if dist.get_backend() == "nccl" else "cpu")
    return (f"process {dist.get_rank()}/{dist.get_world_size()} "
            f"({dist.get_backend()}, {dev})")
