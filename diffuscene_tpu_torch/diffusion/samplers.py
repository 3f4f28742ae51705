"""Sampling loops: DDPM ancestral sampling, DDIM and DPM-Solver++(2M).

Port of ``diffuscene_tpu/diffusion/samplers.py:26-70`` and ``:147-279``.  The
JAX loops are ``lax.scan``s; here they are Python loops over eager torch ops,
with every step-dependent scalar (DDIM's and DPM-Solver++'s coefficients)
computed on the host in f32 up front, so a step sends no value back from the
card.  Randomness comes from an explicit ``torch.Generator``, or from
``noise_fn(shape) -> tensor`` so a test can replay another framework's noise
stream.  Each loop draws in the order of the JAX sampler's key splits: DDPM
draws x_T and then one tensor per step (the t == 0 draw is masked out), DDIM
x_T and then one tensor per step (even at eta 0), DPM-Solver++ x_T only.

``denoise_fn(x, t) -> model_output`` closes over the network and the
per-scene conditioning.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .gaussian import model_predictions, p_mean_variance
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
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    x = draw(shape)
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        x = p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                          x, t, draw(shape), clip_denoised)
    return x


def _noise_source(sched: DiffusionSchedule, generator: Optional[torch.Generator],
                  noise_fn: Optional[NoiseFn]) -> Callable[[Tuple[int, ...]], torch.Tensor]:
    """shape -> standard-normal f32 tensor on the schedule's device, from
    exactly one of ``generator`` (drawing on its device) and ``noise_fn``."""
    if (generator is None) == (noise_fn is None):
        raise ValueError("pass exactly one of generator and noise_fn")
    device = sched.betas.device

    def draw(shape):
        if noise_fn is not None:
            return noise_fn(tuple(shape)).to(device=device, dtype=torch.float32)
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)

    return draw


def _time_pairs(num_timesteps: int, steps: int) -> List[Tuple[int, int]]:
    """(time, time_next) pairs walking linspace(-1, T-1, steps+1) in
    reverse, truncated to int32 as the JAX samplers do; the last time_next
    is -1."""
    times = np.linspace(-1, num_timesteps - 1, num=steps + 1).astype(np.int32).tolist()
    times = times[::-1]
    return list(zip(times[:-1], times[1:]))


def _alphas_cumprod_ext(sched: DiffusionSchedule) -> torch.Tensor:
    """alphas_cumprod on the host with a 1.0 appended, so index -1 (the final
    time_next) reads alpha_bar = 1."""
    acp = sched.alphas_cumprod.detach().to("cpu", torch.float32)
    return torch.cat([acp, torch.ones(1)])


def ddim_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    sampling_timesteps: int = 50,
    eta: float = 0.0,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """DDIM over a strided timestep subsequence (the JAX package's corrected
    version of reference ddim_sample_loop, diffusion_ddpm.py:401-444):

        x <- x0 sqrt(a_next) + c eps + sigma z,   c = sqrt(max(1 - a_next - sigma^2, 0))

    with sigma = eta sqrt((1 - a/a_next)(1 - a_next)/(1 - a)); the last step
    returns x0 exactly."""
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    acp = _alphas_cumprod_ext(sched)
    x = draw(shape)
    for time, time_next in _time_pairs(sched.num_timesteps, sampling_timesteps):
        t = torch.full((shape[0],), time, dtype=torch.long, device=device)
        pred_noise, x_start = model_predictions(
            sched, model_mean_type, denoise_fn(x, t), x, t, clip_x_start=clip_denoised)
        noise = draw(shape)
        if time_next < 0:
            x = x_start
            continue
        alpha, alpha_next = acp[time], acp[time_next]
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
        x = (x_start * torch.sqrt(alpha_next).item() + c.item() * pred_noise
             + sigma.item() * noise)
    return x


def dpm_solver_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    sampling_timesteps: int = 20,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al., arXiv 2211.01095) in data-prediction
    form, with sigma_t = sqrt(1 - alpha_bar_t), a_t = sqrt(alpha_bar_t),
    lambda_t = log(a_t / sigma_t):

        x_{i+1} = (sigma_{i+1}/sigma_i) x_i - a_{i+1} (e^{-h_i} - 1) D_i
        D_i     = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}

    with h_i = lambda_{i+1} - lambda_i, r_i = h_{i-1}/h_i, and e^{-h} as the
    ratio (a_i sigma_{i+1})/(a_{i+1} sigma_i), exactly 0 at the final
    boundary.  First order (D = x0) on the first step, at the final boundary
    and where h or h_prev is 0 (duplicate integer timesteps)."""
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    acp = _alphas_cumprod_ext(sched)
    a_all = torch.sqrt(acp)
    sig_all = torch.sqrt(torch.clamp(1.0 - acp, min=1e-20))
    lam_all = torch.log(a_all) - torch.log(sig_all)
    x = draw(shape)
    x0_prev = None
    h_prev = torch.ones(())
    for step, (time, time_next) in enumerate(_time_pairs(sched.num_timesteps, sampling_timesteps)):
        t = torch.full((shape[0],), time, dtype=torch.long, device=device)
        _, x0 = model_predictions(sched, model_mean_type, denoise_fn(x, t), x, t,
                                  clip_x_start=clip_denoised)
        a_i, a_n = a_all[time], a_all[time_next]
        s_i, s_n = sig_all[time], sig_all[time_next]
        h = lam_all[time_next] - lam_all[time]
        first_order = step == 0 or time_next < 0 or h.item() == 0.0 or h_prev.item() == 0.0
        if first_order:
            d = x0
        else:
            r = h_prev / h
            c2 = 1.0 / (2.0 * r)
            d = (1.0 + c2).item() * x0 - c2.item() * x0_prev
        exp_mh = (a_i * s_n) / (a_n * s_i)
        x = (s_n / s_i).item() * x - (a_n * (exp_mh - 1.0)).item() * d
        x0_prev, h_prev = x0, h
    return x
