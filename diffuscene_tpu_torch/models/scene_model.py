"""Top-level scene-layout diffusion model: conditioning, training loss and
sampling.

Port of ``diffuscene_tpu/models/scene_model.py`` (reference
DiffusionSceneLayout_DDPM, diffusion_scene_layout_ddpm.py:14-454).  The
modules hold only networks and parameters; diffusion math and the sampling
loops are plain functions from ``diffusion/``.

Ported: the unconditional task with the learnable or the fixed one-hot
instance embedding; the training loss (``get_loss``: q_sample, the module
forward, ``p_losses`` with the IoU regularizer on the train-set bounds);
``fused=False`` (module forward), ``fused=True`` (the 3-D engine on the
ResnetBlock and set-attention kernels) and ``fused="rows"`` (rows engine on
the chain kernel); DDPM, DDIM and DPM-Solver++ sampling.  Raising
``NotImplementedError``: completion and arrangement (ROADMAP A6), text
(ROADMAP A5) and room-mask conditions (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion import (AttributeSpec, DiffusionSchedule, LossConfig, make_schedule, p_losses,
                         q_sample)
from ..diffusion import samplers as S
from ..utils.config import as_dtype
from ..utils.convert import denoiser_tree
from .denoiser import Unet1D, init_parameters


@dataclasses.dataclass(frozen=True)
class SceneModelConfig:
    """Static model configuration (mirrors the YAML ``network`` section)."""

    # attribute layout
    point_dim: int = 62
    translation_dim: int = 3
    size_dim: int = 3
    angle_dim: int = 2
    class_dim: int = 22
    objectness_dim: int = 0
    objfeat_dim: int = 32
    # conditioning
    sample_num_points: int = 12
    room_mask_condition: bool = False
    latent_dim: int = 0
    instance_condition: bool = True
    learnable_embedding: bool = True
    instance_emb_dim: int = 128
    text_condition: bool = False
    text_glove_embedding: bool = False
    text_clip_embedding: bool = False
    text_embed_dim: int = 512
    room_partial_condition: bool = False
    partial_num_points: int = 0
    partial_emb_dim: int = 64
    room_arrange_condition: bool = False
    arrange_emb_dim: int = 64
    # diffusion
    schedule_type: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    time_num: int = 1000
    loss_type: str = "mse"
    model_mean_type: str = "v"
    model_var_type: str = "fixedsmall"
    loss_separate: bool = True
    loss_iou: bool = True
    # denoiser net kwargs
    net_kwargs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def bbox_dim(self) -> int:
        return self.translation_dim + self.size_dim + self.angle_dim

    @property
    def spec(self) -> AttributeSpec:
        return AttributeSpec(
            translation_dim=self.translation_dim,
            size_dim=self.size_dim,
            angle_dim=self.angle_dim,
            class_dim=self.class_dim,
            objectness_dim=self.objectness_dim,
            objfeat_dim=self.objfeat_dim,
        )

    @property
    def loss_config(self) -> LossConfig:
        return LossConfig(
            model_mean_type=self.model_mean_type,
            model_var_type=self.model_var_type,
            loss_type=self.loss_type,
            loss_separate=self.loss_separate,
            loss_iou=self.loss_iou,
            room_arrange_condition=self.room_arrange_condition,
        )

    @classmethod
    def from_config(cls, network: Dict[str, Any]) -> "SceneModelConfig":
        """Build from a reference-format ``network`` config dict (already
        parsed: this package reads no YAML)."""
        dk = network.get("diffusion_kwargs", {})
        fields = dict(
            point_dim=network.get("point_dim", 62),
            translation_dim=network.get("translation_dim", 3),
            size_dim=network.get("size_dim", 3),
            angle_dim=network.get("angle_dim", 1),
            class_dim=network.get("class_dim", 21),
            objectness_dim=network.get("objectness_dim", 1),
            objfeat_dim=network.get("objfeat_dim", 0),
            sample_num_points=network.get("sample_num_points", 12),
            room_mask_condition=network.get("room_mask_condition", True),
            latent_dim=network.get("latent_dim", 0),
            instance_condition=network.get("instance_condition", False),
            learnable_embedding=network.get("learnable_embedding", False),
            instance_emb_dim=network.get("instance_emb_dim", 64),
            text_condition=network.get("text_condition", False),
            text_glove_embedding=network.get("text_glove_embedding", False),
            text_clip_embedding=network.get("text_clip_embedding", False),
            text_embed_dim=network.get("text_embed_dim", 512),
            room_partial_condition=network.get("room_partial_condition", False),
            partial_num_points=network.get("partial_num_points", 0),
            partial_emb_dim=network.get("partial_emb_dim", 64),
            room_arrange_condition=network.get("room_arrange_condition", False),
            arrange_emb_dim=network.get("arrange_emb_dim", 64),
            schedule_type=dk.get("schedule_type", "linear"),
            beta_start=dk.get("beta_start", 1e-4),
            beta_end=dk.get("beta_end", 0.02),
            time_num=dk.get("time_num", 1000),
            loss_type=dk.get("loss_type", "mse"),
            model_mean_type=dk.get("model_mean_type", "eps"),
            model_var_type=dk.get("model_var_type", "fixedsmall"),
            loss_separate=dk.get("loss_separate", False),
            loss_iou=dk.get("loss_iou", False),
            net_kwargs=tuple(sorted(network.get("net_kwargs", {}).items())),
        )
        return cls(**fields)


def pack_target(cfg: SceneModelConfig, sample_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Attribute dict -> the diffusion target (B, N, point_dim), in the order
    of diffusion_scene_layout_ddpm.py:148-160: translations, sizes, angles,
    class_labels (, objectness)(, objfeats)."""
    parts = [sample_params["translations"], sample_params["sizes"],
             sample_params["angles"], sample_params["class_labels"]]
    if cfg.objectness_dim > 0:
        parts.append(sample_params["objectness"])
    if cfg.objfeat_dim > 0:
        parts.append(sample_params["objfeats_32" if cfg.objfeat_dim == 32 else "objfeats"])
    return torch.cat(parts, dim=-1)


_UNET_ARGS = frozenset(inspect.signature(Unet1D.__init__).parameters) - {"self", "device"}


def build_unet1d(cfg: SceneModelConfig, device=None) -> Unet1D:
    """Unet1D from the config's net_kwargs (unknown keys are dropped, as the
    JAX package drops keys its Unet1D does not have)."""
    net_kwargs = {k: v for k, v in dict(cfg.net_kwargs).items() if k in _UNET_ARGS}
    net_kwargs.setdefault("text_condition", cfg.text_condition)
    if "dim_mults" in net_kwargs:
        net_kwargs["dim_mults"] = tuple(net_kwargs["dim_mults"])
    if "compute_dtype" in net_kwargs:
        net_kwargs["compute_dtype"] = as_dtype(net_kwargs["compute_dtype"])
    return Unet1D(**net_kwargs, device=device)


class ConditionNets(nn.Module):
    """Conditioning heads: the instance condition, as a learnable embedding
    or as the fixed one-hot rows through ``fc_instance_condition``
    (Linear, LeakyReLU(0.1), Linear, no biases;
    diffusion_scene_layout_ddpm.py:27-129)."""

    def __init__(self, cfg: SceneModelConfig, device=None):
        super().__init__()
        if cfg.room_partial_condition or cfg.room_arrange_condition:
            raise NotImplementedError(
                "completion and arrange conditions are not ported yet (ROADMAP A6)")
        if cfg.text_condition:
            raise NotImplementedError("text conditions are not ported yet (ROADMAP A5)")
        if cfg.room_mask_condition:
            raise NotImplementedError(
                "room-mask conditions (the feature extractors) are not ported yet (ROADMAP A8)")
        self.cfg = cfg
        self.positional_embedding = None
        self.fc_instance_condition = None
        n, e = cfg.sample_num_points, cfg.instance_emb_dim
        if cfg.instance_condition and cfg.learnable_embedding:
            self.positional_embedding = nn.Parameter(torch.empty(n, e, device=device))
        elif cfg.instance_condition:
            self.fc_instance_condition = nn.Sequential(
                nn.Linear(n, e, bias=False, device=device), nn.LeakyReLU(0.1),
                nn.Linear(e, e, bias=False, device=device))

    def forward(self, batch_size: int, num_points: int) -> Optional[torch.Tensor]:
        """-> condition (B, N, instance_emb_dim) f32, or None."""
        e = self.cfg.instance_emb_dim
        if self.positional_embedding is not None:
            return self.positional_embedding[None, :num_points, :].expand(batch_size, num_points, e)
        if self.fc_instance_condition is not None:
            # the one-hot rows of every slot (the JAX package feeds the
            # (B, N, N) identity; each scene's rows are the same)
            n = self.cfg.sample_num_points
            eye = torch.eye(n, device=self.fc_instance_condition[0].weight.device)
            return self.fc_instance_condition(eye)[None].expand(batch_size, n, e)
        return None


class SceneDiffusion:
    """Networks + schedule + loss + sampler (DiffusionSceneLayout_DDPM +
    DiffusionPoint, diffusion_scene_layout_ddpm.py:131-347).  Built on the
    card unless ``device`` says otherwise.  ``bounds`` are the train set's
    (``Bounds.as_device_bounds()``), which the IoU regularizer needs; they
    live on the model's device.  ``networks`` holds the denoiser and the
    conditioning heads as one module (state_dict keys ``denoiser.*`` and
    ``conditioner.*``)."""

    def __init__(self, cfg: SceneModelConfig, bounds: Optional[Dict[str, np.ndarray]] = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.spec = cfg.spec
        self.loss_cfg = cfg.loss_config
        self.device = torch.device(device)
        self.denoiser = build_unet1d(cfg, device=self.device)
        self.conditioner = ConditionNets(cfg, device=self.device)
        self.networks = nn.ModuleDict({"denoiser": self.denoiser, "conditioner": self.conditioner})
        self.sched: DiffusionSchedule = make_schedule(
            cfg.schedule_type, cfg.beta_start, cfg.beta_end, cfg.time_num,
            model_mean_type=cfg.model_mean_type, device=self.device,
        )
        self.bounds = None if bounds is None else {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in bounds.items()}

    def to(self, device: torch.device | str) -> "SceneDiffusion":
        """Move the networks, the schedule and the bounds to ``device``."""
        device = torch.device(device)
        if device != self.device:
            cfg = self.cfg
            self.networks.to(device)
            self.sched = make_schedule(cfg.schedule_type, cfg.beta_start, cfg.beta_end,
                                       cfg.time_num, model_mean_type=cfg.model_mean_type,
                                       device=device)
            if self.bounds is not None:
                self.bounds = {k: v.to(device) for k, v in self.bounds.items()}
            self.device = device
        return self

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "SceneDiffusion":
        """Random parameters from a CPU ``generator``: the same seed gives the
        same weights on any device."""
        init_parameters(self.denoiser, generator)
        if self.conditioner.positional_embedding is not None:
            pe = self.conditioner.positional_embedding
            pe.copy_(torch.randn(pe.shape, generator=generator))
        if self.conditioner.fc_instance_condition is not None:
            for lin in self.conditioner.fc_instance_condition[::2]:
                w = torch.randn(lin.weight.shape, generator=generator) / math.sqrt(lin.in_features)
                lin.weight.copy_(w)
        return self

    def make_condition(self, batch_size: int) -> Optional[torch.Tensor]:
        return self.conditioner(batch_size, self.cfg.sample_num_points)

    def get_loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """Training loss of one batch (diffusion_scene_layout_ddpm.py:131-226
        + diffusion_ddpm.py:758-772) -> (0-d loss, dict of 0-d terms).
        ``batch`` holds the attribute tensors (or the ``packed`` target) on
        this model's device.  The timesteps ``t`` (B,) and the ``noise``
        (B, N, point_dim) are used when given, else drawn from
        ``generator`` (on this model's device)."""
        cfg = self.cfg
        target = batch["packed"] if "packed" in batch else pack_target(cfg, batch)
        B = target.shape[0]
        condition = self.conditioner(B, cfg.sample_num_points)
        if t is None:
            t = torch.randint(0, self.sched.num_timesteps, (B,), generator=generator,
                              device=target.device)
        if noise is None:
            noise = torch.randn(target.shape, generator=generator, device=target.device)
        data_t = q_sample(self.sched, target, t, noise)
        denoise_out = self.denoiser(data_t, t, condition)
        losses, loss_dict = p_losses(self.sched, self.spec, self.loss_cfg, denoise_out,
                                     target, data_t, t, noise, bounds=self.bounds)
        return losses.mean(), loss_dict

    def _denoise_fn(self, condition, fused=False):
        """``fused`` is False (module forward), True (the 3-D engine, each
        ResnetBlock on the ResnetBlock kernel and mid_attn on the
        set-attention kernel) or ``"rows"`` (flat-row engine, its resblock
        chains on the chain kernel)."""
        if fused is False:
            def fn(x, t):
                with torch.no_grad():
                    return self.denoiser(x, t, condition)
            return fn
        if fused is not True and fused != "rows":
            raise ValueError(f"fused must be False, True or 'rows', got {fused!r}")
        from .inference import (
            fused_unet1d_forward,
            fused_unet1d_forward_rows,
            precompute_conditioning,
            prepare_chain_params,
            prepare_inference_params,
        )

        net = self.denoiser
        prep = prepare_inference_params(net, denoiser_tree(net),
                                        num_timesteps=self.sched.num_timesteps)
        cond_ctx = precompute_conditioning(net, prep, condition)
        if fused is True:
            def fn(x, t):
                return fused_unet1d_forward(net, prep, x, t, cond_ctx=cond_ctx)
            return fn

        chains = prepare_chain_params(net, prep, frozenset(cond_ctx["film_c"]))
        film_c2 = {name: v.reshape(-1, v.shape[-1]).contiguous()
                   for name, v in cond_ctx["film_c"].items()}
        ctx_rows = {"film_c2": film_c2}

        def fn(x, t):
            return fused_unet1d_forward_rows(net, prep, chains, x, t, ctx_rows)

        return fn

    @torch.no_grad()
    def sample(
        self,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        clip_denoised: bool = False,
        fused=False,
        noise_fn=None,
        ddim: bool = False,
        ddim_steps: int = 50,
        ddim_eta: float = 0.0,
        dpm: bool = False,
        dpm_steps: int = 20,
        partial_boxes=None,
        input_boxes=None,
    ) -> torch.Tensor:
        """Sample ``batch_size`` scenes -> (B, N, point_dim)
        (diffusion_scene_layout_ddpm.py:228-310): DPM-Solver++ with ``dpm``,
        else DDIM with ``ddim``, else DDPM ancestral sampling.  Noise comes
        from ``generator`` (on this model's device) or from ``noise_fn``."""
        if partial_boxes is not None or input_boxes is not None:
            raise NotImplementedError("completion and arrangement are not ported yet (ROADMAP A6)")
        cfg = self.cfg
        condition = self.make_condition(batch_size)
        fn = self._denoise_fn(condition, fused=fused)
        shape = (batch_size, cfg.sample_num_points, cfg.point_dim)
        noise = dict(generator=generator, noise_fn=noise_fn)
        mmt = cfg.model_mean_type
        if dpm:
            return S.dpm_solver_sample_loop(self.sched, mmt, fn, shape, dpm_steps,
                                            clip_denoised, **noise)
        if ddim:
            return S.ddim_sample_loop(self.sched, mmt, fn, shape, ddim_steps, ddim_eta,
                                      clip_denoised, **noise)
        return S.p_sample_loop(self.sched, mmt, cfg.model_var_type, fn, shape,
                               clip_denoised=clip_denoised, **noise)

    def split_samples(self, samples: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split packed samples into an attribute dict + empty-slot mask
        (the slicing part of delete_empty_from_network_samples,
        diffusion_scene_layout_ddpm.py:352-364)."""
        spec = self.spec
        out = {
            "translations": samples[:, :, spec.trans_slice],
            "sizes": samples[:, :, spec.size_slice],
            "angles": samples[:, :, spec.angle_slice],
            # raw probability map without the empty channel
            "class_labels": samples[:, :, spec.bbox_dim: spec.bbox_dim + spec.class_dim - 1]
            if spec.objectness_dim == 0
            else samples[:, :, spec.class_slice],
            "objectness": samples[:, :, spec.empty_slice],
        }
        if spec.objfeat_dim > 0:
            out["objfeats"] = samples[:, :, spec.objfeat_slice]
        if spec.objectness_dim > 0:
            out["is_empty"] = samples[:, :, spec.empty_slice][..., 0] < 0
        else:
            out["is_empty"] = samples[:, :, spec.empty_slice][..., 0] >= 0
        return out
