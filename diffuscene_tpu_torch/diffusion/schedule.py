"""Diffusion noise schedules, precomputed on the host in float64.

Port of ``diffuscene_tpu/diffusion/schedule.py``: every per-timestep
coefficient vector is computed once in numpy float64 (as the reference does,
diffusion_ddpm.py:160) and held as a float32 tensor on the chosen device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_betas(schedule_type: str, b_start: float, b_end: float, time_num: int) -> np.ndarray:
    """Beta schedule (float64): linear, warm0.1 / warm0.2 / warm0.5, cosine."""
    if schedule_type == "linear":
        betas = np.linspace(b_start, b_end, time_num, dtype=np.float64)
    elif schedule_type.startswith("warm"):
        frac = float(schedule_type[len("warm"):])
        betas = b_end * np.ones(time_num, dtype=np.float64)
        warmup_time = int(time_num * frac)
        betas[:warmup_time] = np.linspace(b_start, b_end, warmup_time, dtype=np.float64)
    elif schedule_type == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = np.array(
            [
                min(1.0 - alpha_bar((i + 1) / time_num) / alpha_bar(i / time_num), 0.999)
                for i in range(time_num)
            ],
            dtype=np.float64,
        )
    else:
        raise NotImplementedError(schedule_type)
    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError(f"betas out of (0, 1] for schedule {schedule_type!r}")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient vectors, shape (T,), float32 on ``device``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor
    # log-variance vector used when model_var_type == 'fixedlarge'
    fixedlarge_log_variance: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(
    schedule_type: str = "linear",
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    time_num: int = 1000,
    model_mean_type: str = "eps",
    device: torch.device | str = "cpu",
) -> DiffusionSchedule:
    betas = get_betas(schedule_type, beta_start, beta_end, time_num)
    return schedule_from_betas(betas, model_mean_type=model_mean_type, device=device)


def schedule_from_betas(
    betas: np.ndarray, model_mean_type: str = "eps", device: torch.device | str = "cpu"
) -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(np.maximum(posterior_variance, 1e-20))
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)

    snr = alphas_cumprod / (1.0 - alphas_cumprod)
    if model_mean_type == "eps":
        loss_weight = np.ones_like(snr)
    elif model_mean_type == "x0":
        loss_weight = snr
    elif model_mean_type == "v":
        loss_weight = snr / (snr + 1.0)
    else:
        raise NotImplementedError(model_mean_type)

    # 'fixedlarge': beta_t as the variance, with the first posterior variance
    # spliced in for t=0 (diffusion_ddpm.py:318-319)
    fixedlarge_log_variance = np.log(
        np.concatenate([posterior_variance[1:2], betas[1:]])
    )

    def as_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(
        betas=as_dev(betas),
        alphas_cumprod=as_dev(alphas_cumprod),
        alphas_cumprod_prev=as_dev(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_dev(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=as_dev(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=as_dev(posterior_variance),
        posterior_log_variance_clipped=as_dev(posterior_log_variance_clipped),
        posterior_mean_coef1=as_dev(posterior_mean_coef1),
        posterior_mean_coef2=as_dev(posterior_mean_coef2),
        loss_weight=as_dev(loss_weight),
        fixedlarge_log_variance=as_dev(fixedlarge_log_variance),
    )


def extract(a: torch.Tensor, t: torch.Tensor, x_ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients (T,) at ``t`` (B,) and reshape to
    (B, 1, ..., 1) so they broadcast over an ``x_ndim``-dim tensor."""
    out = a[t]
    return out.reshape(out.shape[0], *([1] * (x_ndim - 1)))
