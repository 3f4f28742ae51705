"""Tensor-parallel parameters: large kernels split by output columns over
the mesh's model group.

Port of ``diffuscene_tpu/parallel/tp.py``.  The rule is the JAX
package's: a 2-D kernel of at least ``min_size`` elements whose output
dimension divides ``n_model`` is column-sharded, and everything else is
replicated.  The rule reads the Flax layout, so on the port's tensors a
``Conv1x1`` weight (O, I, 1) or a ``Linear`` / ``nn.Linear`` weight (O, I)
is the (I, O) kernel and splits along its dim 0, and any other 2-D
parameter (the learnable positional embedding) keeps the Flax layout and
splits along its last dim.  Weight standardization runs over the input
axis, so a column block is self-contained.

The JAX package lets GSPMD place the blocks and insert the collectives.
Here a rank keeps its block of each sharded kernel (:func:`shard_params`,
with its optimizer slots) and the forward re-assembles the full kernels
with one all-gather over the model group (:func:`gather_full`), whose
backward keeps this rank's block of each full gradient.  The ranks of a
model group see the same rows, so their full gradients are equal and the
numbers are those of data parallelism; the card kernels are untouched.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..models.denoiser import Conv1x1, Linear
from .mesh import Mesh

MIN_SIZE = 1 << 14


def param_shardings(module: nn.Module, mesh: Mesh, min_size: int = MIN_SIZE
                    ) -> Dict[str, Optional[int]]:
    """name -> the dim of the port's tensor that is split over the model
    group, or None (replicated), for every parameter of ``module``."""
    n_model = mesh.n_model
    kernels = {id(m.weight) for m in module.modules()
               if isinstance(m, (Conv1x1, Linear, nn.Linear))}
    out: Dict[str, Optional[int]] = {}
    for name, p in module.named_parameters():
        if id(p) in kernels:        # the (I, O) kernel of a (O, I[, 1]) weight
            flax_2d, dim = p.dim() in (2, 3) and p.shape[2:] in ((), (1,)), 0
        else:
            flax_2d, dim = p.dim() == 2, p.dim() - 1
        split = (n_model > 1 and flax_2d and p.numel() >= min_size
                 and p.shape[dim] % n_model == 0)
        out[name] = dim if split else None
    return out


def local_block(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This model rank's block of ``t`` split along ``dim`` (a contiguous
    copy); ``t`` itself when ``dim`` is None (replicated)."""
    if dim is None:
        return t
    return t.chunk(mesh.n_model, dim=dim)[mesh.model_rank].contiguous().clone()


def shard_params(tensors: Dict[str, torch.Tensor], shardings: Dict[str, Optional[int]],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This model rank's block of each sharded tensor; replicated tensors as
    they are.  Serves parameters and their optimizer slots alike."""
    return {name: local_block(t, shardings.get(name), mesh) for name, t in tensors.items()}


def _gather(blocks: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh
            ) -> List[torch.Tensor]:
    """Full tensors from every model rank's blocks, with one all-gather of
    all the blocks flattened together."""
    if not blocks:
        return []
    flat = torch.cat([b.reshape(-1) for b in blocks])
    parts = [torch.empty_like(flat) for _ in range(mesh.n_model)]
    dist.all_gather(parts, flat, group=mesh.model_group)
    out, offset = [], 0
    for b, dim in zip(blocks, dims):
        n = b.numel()
        out.append(torch.cat([p[offset: offset + n].view(b.shape) for p in parts], dim=dim))
        offset += n
    return out


class _GatherFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, *blocks):
        ctx.mesh, ctx.dims = mesh, dims
        return tuple(_gather(blocks, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(None if g is None else local_block(g, d, ctx.mesh)
                                    for g, d in zip(grads, ctx.dims))


def gather_full(blocks: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh,
                differentiable: bool = False) -> List[torch.Tensor]:
    """The full tensors of this rank's ``blocks`` (split along ``dims``).
    ``differentiable``: the backward keeps this rank's block of each
    gradient."""
    if differentiable:
        return list(_GatherFull.apply(mesh, tuple(dims), *blocks))
    with torch.no_grad():
        return _gather(blocks, dims, mesh)
