"""Gaussian diffusion core: the forward process, the parameterizations,
the reverse-step mean/variance, the training loss with its IoU regularizer
and the variational bound's terms in bits per dimension.

Port of ``diffuscene_tpu/diffusion/gaussian.py`` (reference
GaussianDiffusion, diffusion_ddpm.py:125-717).  ``x`` is (B, N, C) with C
packed as translation, size, angle, class (, objectness)(, objfeat).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.iou3d import axis_aligned_bbox_overlaps_3d
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


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """x_t = sqrt(a_bar) x_0 + sqrt(1 - a_bar) eps.  (diffusion_ddpm.py:276-286)"""
    return (
        extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
    )


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """Mean, variance and log-variance of q(x_t | x_0)."""
    mean = extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, x_start.ndim)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


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


def predict_v(sched, x0, t, eps):
    return (
        extract(sched.sqrt_alphas_cumprod, t, x0.ndim) * eps
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * x0
    )


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


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians.  (diffusion_ddpm.py:96-101)"""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss configuration (diffusion_ddpm.py:126-152)."""

    model_mean_type: str = "v"
    model_var_type: str = "fixedsmall"
    loss_type: str = "mse"
    loss_separate: bool = True
    loss_iou: bool = True
    room_arrange_condition: bool = False
    iou_weight: float = 0.1


def _mean_tail(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims -> (B,)."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def descale_to_origin(x, minimum, maximum):
    """[-1, 1] -> world units.  (diffusion_ddpm.py:668-675)"""
    x = (x + 1.0) / 2.0
    return x * (maximum - minimum)[None, None, :] + minimum[None, None, :]


def iou_regularizer(
    sched: DiffusionSchedule,
    spec: AttributeSpec,
    cfg: LossConfig,
    x_recon: torch.Tensor,
    t: torch.Tensor,
    bounds: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise box-IoU penalty on the reconstructed scene
    (diffusion_ddpm.py:600-635): x0 clamped to [-1, 1], translations and
    sizes descaled with the train-set ``bounds``, corners [c - s, c + s]
    (sizes are half-extents), the full IoU matrix (diagonal included, as in
    the reference) masked to non-empty slots, weighted by
    alphas_cumprod[t] * iou_weight and divided by the valid-pair count
    + 1e-6.  Returns (loss_iou_valid_avg, bbox_iou_valid_avg), each (B,)."""
    x_recon = x_recon.clamp(-1.0, 1.0)
    trans = x_recon[:, :, spec.trans_slice]
    sizes = x_recon[:, :, spec.size_slice]
    empty = x_recon[:, :, spec.empty_slice]
    if spec.objectness_dim > 0:
        valid = (empty >= 0).to(x_recon.dtype)[..., 0]
    else:
        valid = (empty <= 0).to(x_recon.dtype)[..., 0]

    descale_trans = descale_to_origin(trans, bounds["translations_min"], bounds["translations_max"])
    descale_sizes = descale_to_origin(sizes, bounds["sizes_min"], bounds["sizes_max"])
    corners = torch.cat([descale_trans - descale_sizes, descale_trans + descale_sizes], dim=-1)
    bbox_iou = axis_aligned_bbox_overlaps_3d(corners, corners)   # (B, N, N)
    pair_mask = valid[:, :, None] * valid[:, None, :]
    bbox_iou_valid = bbox_iou * pair_mask

    B = x_recon.shape[0]
    w_iou = extract(sched.alphas_cumprod, t, bbox_iou.ndim)
    denom = pair_mask.reshape(B, -1).sum(dim=-1) + 1e-6
    loss_iou_valid_avg = (w_iou * cfg.iou_weight * bbox_iou_valid).reshape(B, -1).sum(dim=-1) / denom
    bbox_iou_valid_avg = bbox_iou_valid.reshape(B, -1).sum(dim=-1) / denom
    return loss_iou_valid_avg, bbox_iou_valid_avg


def p_losses(
    sched: DiffusionSchedule,
    spec: AttributeSpec,
    cfg: LossConfig,
    denoise_out: torch.Tensor,
    data_start: torch.Tensor,
    data_t: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    bounds: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-sample training loss given the denoiser output: the MSE branch of
    the reference ``p_losses`` (diffusion_ddpm.py:520-665), with the
    per-attribute terms, ``loss_separate``, the SNR loss weight and the IoU
    regularizer.  Returns (losses_weight (B,), dict of 0-d loss terms)."""
    if cfg.model_mean_type == "eps":
        target = noise
    elif cfg.model_mean_type == "x0":
        target = data_start
    elif cfg.model_mean_type == "v":
        target = predict_v(sched, data_start, t, noise)
    else:
        raise NotImplementedError(cfg.model_mean_type)

    diff2 = (target - denoise_out) ** 2

    if cfg.room_arrange_condition:
        # arrange mode diffuses only the (translation, angle) channels
        td = spec.translation_dim
        loss_trans = _mean_tail(diff2[:, :, :td])
        loss_angle = _mean_tail(diff2[:, :, td:])
        losses = loss_trans + loss_angle if cfg.loss_separate else _mean_tail(diff2)
        losses_weight = losses * extract(sched.loss_weight, t, losses.ndim)
        return losses_weight, {"loss.trans": loss_trans.mean(), "loss.angle": loss_angle.mean()}

    loss_trans = _mean_tail(diff2[:, :, spec.trans_slice])
    loss_size = _mean_tail(diff2[:, :, spec.size_slice])
    loss_angle = _mean_tail(diff2[:, :, spec.angle_slice])
    loss_bbox = _mean_tail(diff2[:, :, : spec.bbox_dim])
    loss_class = _mean_tail(diff2[:, :, spec.class_slice])
    loss_object = _mean_tail(diff2[:, :, spec.empty_slice])
    if spec.objfeat_dim > 0:
        loss_objfeat = _mean_tail(diff2[:, :, spec.objfeat_slice])
    else:
        loss_objfeat = data_start.new_zeros(data_start.shape[0])

    if cfg.loss_separate:
        losses = loss_bbox + loss_class
        if spec.objectness_dim > 0:
            losses = losses + loss_object
        if spec.objfeat_dim > 0:
            losses = losses + loss_objfeat
    else:
        losses = _mean_tail(diff2)

    losses_weight = losses * extract(sched.loss_weight, t, losses.ndim)

    if cfg.loss_iou:
        if bounds is None:
            raise ValueError("loss_iou needs the train set's bounds")
        if cfg.model_mean_type == "eps":
            x_recon = predict_xstart_from_eps(sched, data_t, t, denoise_out)
        elif cfg.model_mean_type == "x0":
            x_recon = denoise_out
        else:
            x_recon = predict_xstart_from_v(sched, data_t, t, denoise_out)
        loss_iou_valid_avg, bbox_iou_valid_avg = iou_regularizer(
            sched, spec, cfg, x_recon, t, bounds)
        losses_weight = losses_weight + loss_iou_valid_avg
    else:
        loss_iou_valid_avg = torch.zeros_like(losses)
        bbox_iou_valid_avg = torch.zeros_like(losses)

    return losses_weight, {
        "loss.bbox": loss_bbox.mean(),
        "loss.trans": loss_trans.mean(),
        "loss.size": loss_size.mean(),
        "loss.angle": loss_angle.mean(),
        "loss.class": loss_class.mean(),
        "loss.object": loss_object.mean(),
        "loss.objfeat": loss_objfeat.mean(),
        "loss.liou": loss_iou_valid_avg.mean(),
        "loss.bbox_iou": bbox_iou_valid_avg.mean(),
    }


def vb_terms_bpd(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    model_output: torch.Tensor,
    data_start: torch.Tensor,
    data_t: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool,
):
    """Variational-bound KL term in bits/dim -> ((B,), pred_xstart).
    (diffusion_ddpm.py:511-518)"""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, data_start, data_t, t)
    model_mean, model_log_var, pred_xstart = p_mean_variance(
        sched, model_mean_type, model_var_type, model_output, data_t, t, clip_denoised)
    kl = normal_kl(true_mean, true_log_var, model_mean, model_log_var)
    return _mean_tail(kl) / math.log(2.0), pred_xstart


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits/dim -> (B,).  (diffusion_ddpm.py:679-688)"""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    kl = normal_kl(qt_mean, qt_log_var, torch.zeros_like(qt_mean), torch.zeros_like(qt_log_var))
    return _mean_tail(kl) / math.log(2.0)
