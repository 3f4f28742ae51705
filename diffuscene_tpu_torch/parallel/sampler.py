"""Batched scene sampling split over the mesh's data ranks.

Port of ``diffuscene_tpu/parallel/sampler.py``.  Each data rank samples
``batch_size / n_data`` scenes through ``SceneDiffusion.sample`` (the 3-D
engine on the ResnetBlock and set-attention kernels for ``fused=True``,
the rows engine on the chain kernel for ``fused="rows"``), with its rows of
``text_emb``, ``partial_boxes`` and ``input_boxes``; the samples are then
all-gathered, so every rank returns the global batch, as the JAX sampler
returns the global array.  Sampling needs no other communication.

The noise does not depend on the split: every draw of the sampling loop
(x_T and each step's noise, in the eager loop's order) is made for the
whole batch from the caller's generator and sliced to this rank's rows
(``sample(shard=...)``), so the gathered sample equals
``SceneDiffusion.sample`` of the whole batch from the same seed.  On a
card each rank's loop runs from a CUDA graph, as ``SceneDiffusion.sample``
does by default.  The weights must be equal on every rank
(:meth:`ShardedSampler.put_params` broadcasts rank 0's).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.scene_model import SceneDiffusion
from .mesh import Mesh, all_gather_rows, make_mesh, replicate, rows_of


class ShardedSampler:
    """``SceneDiffusion.sample`` over the mesh's data ranks."""

    def __init__(self, scene: SceneDiffusion, mesh: Optional[Mesh] = None,
                 clip_denoised: bool = True, ddim: bool = False, ddim_steps: int = 50,
                 dpm: bool = False, dpm_steps: int = 20, fused=False):
        self.scene = scene
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_data = self.mesh.n_data
        self.clip_denoised = clip_denoised
        self.ddim, self.ddim_steps = ddim, ddim_steps
        self.dpm, self.dpm_steps = dpm, dpm_steps
        self.fused = fused

    def put_params(self) -> "ShardedSampler":
        """Rank 0's weights (the networks' parameters and buffers) on every
        rank."""
        with torch.no_grad():
            replicate(list(self.scene.networks.parameters()) +
                      list(self.scene.networks.buffers()), self.mesh)
        return self

    def sample(self, batch_size: int, generator: torch.Generator,
               text_emb: Optional[torch.Tensor] = None,
               partial_boxes: Optional[torch.Tensor] = None,
               input_boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample ``batch_size`` scenes -> the global (B, N, point_dim) on
        every rank.  ``batch_size`` must be a multiple of n_data; the
        conditioning tensors are global (B, ...).  ``generator`` (on the
        scene's device) is seeded alike on every rank."""
        rows = rows_of(batch_size, self.mesh)

        def mine(x):
            return None if x is None else x[rows]

        local = self.scene.sample(
            rows.stop - rows.start, generator=generator, shard=(self.mesh.data_rank, self.n_data),
            clip_denoised=self.clip_denoised,
            fused=self.fused, ddim=self.ddim, ddim_steps=self.ddim_steps, dpm=self.dpm,
            dpm_steps=self.dpm_steps, text_emb=mine(text_emb),
            partial_boxes=mine(partial_boxes), input_boxes=mine(input_boxes))
        return all_gather_rows(local, self.mesh)
