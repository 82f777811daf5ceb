"""Multi-process execution: ``torch.distributed`` in place of the JAX
package's ``jax.distributed`` (its ``runtime/distributed.py``).

Every process initializes one process group, owns a contiguous run of the
P shards (process-major, as the JAX package's device order) and
materializes only those (``mesh/partition.partition_mesh(owned=...)``).
The collectives over the shards are ``runtime/comm.ProcessComm``'s.

The backend is named by the caller, never chosen from what is found:
"gloo" (the CPU twin; on CUDA tensors the comm stages each transfer
through host memory) or "nccl" (device tensors directly; it needs one card
a process, so a machine with one card cannot check it).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch.distributed as dist

__all__ = ["initialize_multihost", "owned_shards", "process_count",
           "process_index", "init_method"]


def init_method(coordinator: str) -> str:
    """``torch.distributed``'s init method for a coordinator given as
    ``host:port``, ``tcp://host:port`` or ``file:///path`` (a file store,
    which lets tests on one machine avoid picking a port)."""
    if coordinator.startswith(("tcp://", "file://")):
        return coordinator
    return f"tcp://{coordinator}"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout_seconds: float = 600.0) -> None:
    """Join the process group before any collective.

    Arguments default to the PRFDD_COORDINATOR / PRFDD_NUM_PROCESSES /
    PRFDD_PROCESS_ID / PRFDD_BACKEND environment variables; without a
    coordinator this is a no-op single process. ``backend`` ("gloo" or
    "nccl") must be given one way or the other. A collective that waits
    longer than ``timeout_seconds`` raises instead of hanging."""
    coordinator = coordinator or os.environ.get("PRFDD_COORDINATOR")
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ["PRFDD_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PRFDD_PROCESS_ID"])
    backend = backend or os.environ.get("PRFDD_BACKEND")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"name the backend: 'gloo' or 'nccl', got "
                         f"{backend!r}")
    dist.init_process_group(backend=backend,
                            init_method=init_method(coordinator),
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_seconds))


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def owned_shards(num_shards: int):
    """The contiguous global shard range this process owns: process r of
    n holds shards [r P/n, (r + 1) P/n). The shard count must be a
    multiple of the process count, so every process owns whole shards."""
    nproc = process_count()
    if nproc == 1:
        return tuple(range(num_shards))
    if num_shards % nproc:
        raise ValueError(
            f"num_shards ({num_shards}) must be a multiple of the process "
            f"count ({nproc}) so every process owns whole shards")
    per = num_shards // nproc
    pid = process_index()
    return tuple(range(pid * per, (pid + 1) * per))
