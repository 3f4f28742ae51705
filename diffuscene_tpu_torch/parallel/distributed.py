"""Process-group start-up and per-process data sharding on ``torch.distributed``.

Port of ``diffuscene_tpu/parallel/distributed.py``.  The JAX package runs
one process a host and lets ``jax.distributed`` join them; here a process
drives one card (or, on the CPU, one gloo rank), as ``torchrun`` starts
them:

- :func:`initialize` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes an explicit
  ``init_method`` / ``world_size`` / ``rank``, and joins the process group.
  It returns ``(rank, world_size)``, is a no-op for one process with
  nothing set, and is safe to call twice.
- The backend is explicit: NCCL for CUDA, gloo for the CPU.  Gloo on CUDA
  tensors only when the caller passes ``backend="gloo"``.  NCCL takes one
  card a rank: two ranks on one device raise here, at start-up, and
  nothing falls back to gloo.
- :func:`launch` is a CLI's start: the process group under torchrun
  (of one rank too), nothing without it;
- :func:`host_local_slice`, :func:`shard_indices_for_host` and
  :func:`global_batch_from_host_local` split a global batch or dataset
  over the processes and put the pieces back together.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(backend: Optional[str] = None, device: torch.device | str = "cuda",
               init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, timeout_s: float = 600.0) -> Tuple[int, int]:
    """Join the process group -> (rank, world_size).

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  With one process and no ``init_method`` nothing is
    started and (0, 1) comes back; an ``init_method`` starts a group even
    of one rank.  ``backend`` defaults to NCCL on a CUDA ``device`` and
    gloo on the CPU; NCCL on the CPU raises.  With NCCL, each rank's card
    (``device``, made current) must be its own: two ranks on one device
    raise ``RuntimeError``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if world_size == 1 and init_method is None:
        return 0, 1
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only; pass backend='gloo' for the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        _check_one_rank_a_card(device)
    return rank, world_size


def _check_one_rank_a_card(device: torch.device) -> None:
    """Raise when two NCCL ranks hold the same card (the hostname and the
    device's UUID, gathered over a gloo side group)."""
    side = dist.new_group(backend="gloo")
    mine = (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine, group=side)
    dist.destroy_process_group(side)
    seen = {}
    for r, key in enumerate(every):
        if key in seen:
            dist.destroy_process_group()
            raise RuntimeError(
                f"NCCL: ranks {seen[key]} and {r} are on the same device ({key[1]} on "
                f"{key[0]}); NCCL takes one card a rank (start one process a card, or pass "
                f"backend='gloo' to share a device)")
        seen[key] = r


def launch(device: torch.device | str = "cuda") -> Tuple[torch.device, int, int]:
    """A CLI's start: under torchrun (its ``LOCAL_RANK`` set) join the
    process group, one card a rank (``cuda`` becomes ``cuda:LOCAL_RANK``;
    NCCL on the cards, gloo on the CPU), a group of one rank included ->
    (this rank's device, rank, world size).  Without torchrun:
    (``device``, 0, 1), and nothing is started."""
    device = torch.device(device)
    if "LOCAL_RANK" not in os.environ:
        return device, 0, 1
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank, world = initialize(device=device, init_method="env://")
    return device, rank, world


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a global batch."""
    rank, world = rank_and_world()
    per, rem = divmod(global_batch, world)
    if rem:
        raise ValueError(f"a global batch of {global_batch} does not split over {world} processes")
    return slice(rank * per, (rank + 1) * per)


def shard_indices_for_host(indices: Sequence[int] | np.ndarray) -> np.ndarray:
    """Round-robin dataset indices for this process; the ragged tail is
    dropped so every process sees the same number of batches."""
    indices = np.asarray(indices)
    rank, world = rank_and_world()
    m = (len(indices) // world) * world
    return indices[:m][rank::world]


def global_batch_from_host_local(local: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from every data rank's local rows (an all-gather
    over ``mesh``'s data group, in data-rank order)."""
    from .mesh import all_gather_rows

    return all_gather_rows(local, mesh)
