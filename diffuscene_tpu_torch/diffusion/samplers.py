"""DDPM ancestral sampling.

Port of ``diffuscene_tpu/diffusion/samplers.py:26-70``.  The JAX loop is one
``lax.scan``; here it is a Python loop over eager torch ops.  Randomness comes
from an explicit ``torch.Generator``, or from ``noise_fn(shape) -> tensor``
so a test can replay another framework's noise stream.  The loop draws
T + 1 noise tensors: x_T first, then one per step (the t == 0 draw is masked
out), the order of the JAX sampler's key splits.

``denoise_fn(x, t) -> model_output`` closes over the network and the
per-scene conditioning.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .gaussian import p_mean_variance
from .schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]


def p_sample_step(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    clip_denoised: bool,
) -> torch.Tensor:
    """One ancestral DDPM step with the given standard-normal ``noise``.
    (diffusion_ddpm.py:339-352)"""
    model_output = denoise_fn(x, t)
    model_mean, model_log_variance, _ = p_mean_variance(
        sched, model_mean_type, model_var_type, model_output, x, t, clip_denoised
    )
    nonzero_mask = (t > 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
    return model_mean + nonzero_mask * torch.exp(0.5 * model_log_variance) * noise


def p_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """Full T-step DDPM ancestral sampling.  (diffusion_ddpm.py:355-371)

    Exactly one of ``generator`` (draws on its device) and ``noise_fn``
    must be given."""
    if (generator is None) == (noise_fn is None):
        raise ValueError("pass exactly one of generator and noise_fn")
    device = sched.betas.device
    if noise_fn is None:
        def noise_fn(shp):
            return torch.randn(shp, generator=generator, device=device,
                               dtype=torch.float32)

    x = noise_fn(tuple(shape)).to(device=device, dtype=torch.float32)
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        noise = noise_fn(tuple(shape)).to(device=device, dtype=torch.float32)
        x = p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                          x, t, noise, clip_denoised)
    return x
