"""K-nearest-neighbour indices over point clouds, in plain torch.

Port of ``diffuscene_tpu/ops/knn.py`` (no Pallas kernel there): for
(B, N, D) points, the indices (B, N, k) of the k nearest points, self
included.  The similarity is -(|q|^2 + |x|^2 - 2 q.x), so the inner product
is one batched matmul, and ``torch.topk`` selects.  Neighbours of equal
distance may come in another order than ``jax.lax.top_k`` gives them; the
callers (max-pool, covariance) do not depend on the order.
"""
from __future__ import annotations

import torch


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, D) -> (B, N, k) int64 indices of the k nearest neighbours."""
    xx = (x * x).sum(-1)                                     # (B, N)
    sim = 2.0 * torch.einsum("bnd,bmd->bnm", x, x) - xx[..., None] - xx[:, None, :]
    return sim.topk(k, dim=-1).indices


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features: (B, N, C), (B, S, k) -> (B, S, k, C)."""
    B, S, k = idx.shape
    flat = torch.gather(points, 1, idx.reshape(B, S * k, 1).expand(B, S * k, points.shape[-1]))
    return flat.reshape(B, S, k, points.shape[-1])
