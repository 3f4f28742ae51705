"""Sampling loops: DDPM ancestral sampling (with its trajectory, scene
completion and re-arrangement variants), DDIM, DPM-Solver++(2M) and the
variational-bound sweep.

Port of ``diffuscene_tpu/diffusion/samplers.py``.  The JAX loops are
``lax.scan``s; here they are Python loops over eager torch ops, with every
step-dependent scalar (DDIM's and DPM-Solver++'s coefficients) computed on
the host in f32 up front, so a step sends no value back from the card.
Randomness comes from an explicit ``torch.Generator``, or from
``noise_fn(shape) -> tensor`` so a test can replay another framework's noise
stream.  Each loop draws in the order of the JAX sampler's key splits:

- DDPM (``p_sample_loop``, ``p_sample_loop_trajectory`` and
  ``p_sample_loop_arrange``, the last on the (B, N, translation_dim +
  angle_dim) sub-shape): x_T, then one tensor per step (the t == 0 draw is
  masked out);
- completion (``p_sample_loop_complete``): x_T, then per step the partial
  boxes' noise at (B, P, D) first and the step noise at (B, N, D) second
  (the JAX body's ``split(k, 3)``: k_noise, then k_step);
- DDIM: x_T, then one tensor per step (even at eta 0);
- DPM-Solver++: x_T only;
- the bound sweep (``calc_bpd_loop``): no x_T, one tensor per step.

``denoise_fn(x, t) -> model_output`` closes over the network and the
per-scene conditioning.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .gaussian import model_predictions, p_mean_variance, prior_bpd, q_sample, vb_terms_bpd
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


def p_sample_loop_trajectory(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    freq: int,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """DDPM sampling that also returns frames (diffusion_ddpm.py:373-398):
    x_T, then x after every step whose t == T - 1 or t % freq == 0, stacked
    -> (n_frames, *shape); (1 + T) frames for freq == 1, 2 + T // freq for
    a freq > 1 that divides T."""
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    T = sched.num_timesteps
    x = draw(shape)
    frames = [x]
    for t_scalar in range(T - 1, -1, -1):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        x = p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                          x, t, draw(shape), clip_denoised)
        if t_scalar == T - 1 or t_scalar % freq == 0:
            frames.append(x)
    return torch.stack(frames)


def p_sample_loop_complete(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    partial_boxes: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """RePaint-style scene completion (diffusion_ddpm.py:447-476): before
    every reverse step the first P slots are overwritten with
    ``q_sample(partial_boxes, t, noise)``; after the last step the clean
    ``partial_boxes`` (B, P, D) are spliced in, bit for bit."""
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    P = partial_boxes.shape[1]
    x = draw(shape)
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        partial_t = q_sample(sched, partial_boxes, t, draw(partial_boxes.shape))
        x = torch.cat([partial_t, x[:, P:]], dim=1)
        x = p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                          x, t, draw(shape), clip_denoised)
    return torch.cat([partial_boxes, x[:, P:]], dim=1)


def p_sample_loop_arrange(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    translation_dim: int,
    angle_dim: int,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
) -> torch.Tensor:
    """Re-arrangement (diffusion_ddpm.py:478-506): DDPM on the (translation,
    angle) channels only.  ``shape`` is the full (B, N, point_dim) scene
    shape; the result is (B, N, translation_dim + angle_dim), which the
    caller splices into the conditioning boxes."""
    return p_sample_loop(sched, model_mean_type, model_var_type, denoise_fn,
                         (shape[0], shape[1], translation_dim + angle_dim),
                         generator=generator, clip_denoised=clip_denoised, noise_fn=noise_fn)


def calc_bpd_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
):
    """The variational bound in bits/dim over every timestep, t = T-1 down
    to 0 (reference calc_bpd_loop, diffusion_ddpm.py:690-717) -> the means
    of (total bpd, the vb terms, the prior bpd, the x_0 MSE)."""
    draw = _noise_source(sched, generator, noise_fn)
    device = sched.betas.device
    B = x_start.shape[0]
    vals, mses = [], []
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=device)
        data_t = q_sample(sched, x_start, t, draw(x_start.shape))
        vb, pred_xstart = vb_terms_bpd(sched, model_mean_type, model_var_type,
                                       denoise_fn(data_t, t), x_start, data_t, t, clip_denoised)
        vals.append(vb)
        mses.append(((pred_xstart - x_start) ** 2).reshape(B, -1).mean(dim=-1))
    vals_bt, mse_bt = torch.stack(vals), torch.stack(mses)   # (T, B) each
    prior = prior_bpd(sched, x_start)
    total = vals_bt.sum(dim=0) + prior
    return total.mean(), vals_bt.mean(), prior.mean(), mse_bt.mean()


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
