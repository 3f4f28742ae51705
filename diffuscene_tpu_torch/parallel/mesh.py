"""A 2-D (data, model) grid of ranks and the collectives the trainers and
the sampler use.

Port of ``diffuscene_tpu/parallel/mesh.py``.  The JAX package lays the
devices out as a ``('data', 'model')`` mesh and lets XLA insert the
collectives; here each rank is one process (``parallel/distributed.py``)
and the collectives are explicit:

- rank ``r`` sits at data index ``r // n_model`` and model index
  ``r % n_model`` (the JAX ``devices.reshape(n_data, n_model)``);
- the *data group* of a rank holds the ranks of its model index (they see
  different rows of the batch and average their gradients), the *model
  group* the ranks of its data index (they see the same rows and split the
  large kernels' columns, ``parallel/tp.py``);
- without a process group the mesh is 1x1 and every collective is the
  identity, so code paths stay mesh-agnostic.

Only ``all_reduce`` (sum), ``all_gather`` and ``broadcast`` are used: gloo
and NCCL both have them on CUDA tensors (gloo has no ``reduce_scatter``),
so one code path serves both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_and_world


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    distributed: bool = False

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) grid over every rank of the process group;
    ``n_data`` defaults to world_size // n_model and the grid must hold
    every rank.  1x1 without a process group.  A collective call: every
    rank makes the same meshes in the same order."""
    rank, world = rank_and_world()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data} data x {n_model} model) mesh does not cover "
                         f"{world} rank(s)")
    if not dist.is_initialized():
        return Mesh(1, 1)
    data_group = model_group = None
    for m in range(n_model):        # every rank creates every group, in one order
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == rank % n_model:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group, distributed=True)


def rows_of(n_rows: int, mesh: Mesh) -> slice:
    """This data rank's contiguous rows of a global batch of ``n_rows``."""
    per, rem = divmod(n_rows, mesh.n_data)
    if rem:
        raise ValueError(f"a global batch of {n_rows} does not split over {mesh.n_data} data "
                         f"ranks")
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis: int = 0) -> Dict[str, Any]:
    """This data rank's rows (along ``axis``) of every array or tensor of a
    global host batch."""
    out = {}
    for k, v in batch.items():
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        index = [slice(None)] * axis + [rows_of(v.shape[axis], mesh)]
        out[k] = v[tuple(index)]
    return out


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Broadcast ``tensors`` from rank 0 to every rank, in place."""
    tensors = list(tensors)
    if mesh.distributed:
        for t in tensors:
            dist.broadcast(t, src=0)
    return tensors


def all_reduce_mean_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over the data group, in place (a sum, then a
    division by n_data: gloo has no average)."""
    if mesh.distributed:
        dist.all_reduce(x, group=mesh.data_group)
        x.div_(mesh.n_data)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's ``x`` concatenated on dim 0, in data-rank order."""
    if not mesh.distributed:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """A sum over a group whose backward is the sum of the ranks' gradients
    (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The differentiable sum of ``x`` over the data group."""
    if not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh.data_group)
