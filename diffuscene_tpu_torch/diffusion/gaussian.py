"""Gaussian diffusion core, sampling half: posterior, parameterizations and
the reverse-step mean/variance.

Port of ``diffuscene_tpu/diffusion/gaussian.py`` (reference
GaussianDiffusion, diffusion_ddpm.py:125-717).  ``x`` is (B, N, C) with C
packed as translation, size, angle, class (, objectness)(, objfeat).  The
training losses and the IoU regularizer are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .schedule import DiffusionSchedule, extract


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AttributeSpec:
    """Static layout of the per-object attribute vector (diffusion_ddpm.py:128-134)."""

    translation_dim: int = 3
    size_dim: int = 3
    angle_dim: int = 2
    class_dim: int = 22
    objectness_dim: int = 0
    objfeat_dim: int = 32

    @property
    def bbox_dim(self) -> int:
        return self.translation_dim + self.size_dim + self.angle_dim

    @property
    def point_dim(self) -> int:
        return self.bbox_dim + self.class_dim + self.objectness_dim + self.objfeat_dim

    @property
    def trans_slice(self):
        return slice(0, self.translation_dim)

    @property
    def size_slice(self):
        return slice(self.translation_dim, self.translation_dim + self.size_dim)

    @property
    def angle_slice(self):
        return slice(self.translation_dim + self.size_dim, self.bbox_dim)

    @property
    def class_slice(self):
        return slice(self.bbox_dim, self.bbox_dim + self.class_dim)

    @property
    def objectness_slice(self):
        s = self.bbox_dim + self.class_dim
        return slice(s, s + self.objectness_dim)

    @property
    def objfeat_slice(self):
        s = self.bbox_dim + self.class_dim + self.objectness_dim
        return slice(s, s + self.objfeat_dim)

    @property
    def empty_slice(self):
        """Channel whose sign marks an empty slot: the objectness channel
        (empty if < 0), else the last class channel (empty if > 0)."""
        if self.objectness_dim > 0:
            return self.objectness_slice
        s = self.bbox_dim + self.class_dim - 1
        return slice(s, s + 1)


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """Posterior q(x_{t-1} | x_t, x_0).  (diffusion_ddpm.py:289-302)"""
    posterior_mean = (
        extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
        + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    posterior_variance = extract(sched.posterior_variance, t, x_t.ndim)
    posterior_log_variance = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return posterior_mean, posterior_variance, posterior_log_variance


def predict_xstart_from_eps(sched, x_t, t, eps):
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def predict_eps_from_xstart(sched, x_t, t, x0):
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def predict_xstart_from_v(sched, x_t, t, v):
    return (
        extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
    )


def model_predictions(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_output: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    clip_x_start: bool = False,
) -> ModelPrediction:
    """Convert raw network output to (eps, x0).  (diffusion_ddpm.py:242-264)"""
    def clip(x):
        return x.clamp(-1.0, 1.0) if clip_x_start else x

    if model_mean_type == "eps":
        pred_noise = model_output
        x_start = clip(predict_xstart_from_eps(sched, x_t, t, pred_noise))
    elif model_mean_type == "x0":
        x_start = clip(model_output)
        pred_noise = predict_eps_from_xstart(sched, x_t, t, x_start)
    elif model_mean_type == "v":
        x_start = clip(predict_xstart_from_v(sched, x_t, t, model_output))
        pred_noise = predict_eps_from_xstart(sched, x_t, t, x_start)
    else:
        raise NotImplementedError(model_mean_type)
    return ModelPrediction(pred_noise, x_start)


def p_mean_variance(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    model_output: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool,
):
    """Reverse-step mean/log-variance.  (diffusion_ddpm.py:305-335)"""
    preds = model_predictions(sched, model_mean_type, model_output, x_t, t,
                              clip_x_start=clip_denoised)
    x_recon = preds.pred_x_start
    if model_var_type == "fixedsmall":
        model_log_variance = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    elif model_var_type == "fixedlarge":
        model_log_variance = extract(sched.fixedlarge_log_variance, t, x_t.ndim)
    else:
        raise NotImplementedError(model_var_type)
    model_mean, _, _ = q_posterior_mean_variance(sched, x_recon, x_t, t)
    return model_mean, model_log_variance, x_recon
