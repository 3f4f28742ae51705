"""Top-level scene-layout diffusion model: conditioning, training loss and
sampling.

Port of ``diffuscene_tpu/models/scene_model.py`` (reference
DiffusionSceneLayout_DDPM, diffusion_scene_layout_ddpm.py:14-454).  The
modules hold only networks and parameters; diffusion math and the sampling
loops are plain functions from ``diffusion/``.

Ported: the room-mask condition (``room_mask_condition``: the frozen-BN
ResNet18 or AlexNet of ``models/feature_extractors.py`` over each scene's
(1, H, W) room layout, then ``fc_room_f``), the instance condition (the
learnable or the fixed one-hot embedding), the partial-scene head
(``room_partial_condition``), the arrange head
(``room_arrange_condition``) and the text condition (``text_condition``:
token embeddings through ``fc_text_f``, or a CLIP sentence vector as one
token, into the denoiser's cross-attention); the training loss
(``get_loss``: q_sample, the module forward, ``p_losses`` with the IoU regularizer on the
train-set bounds; with the arrange head the diffusion target is the
(translation, angle) channels only); ``fused=False`` (module forward),
``fused=True`` (the 3-D engine on the ResnetBlock and set-attention
kernels) and ``fused="rows"`` (rows engine on the chain kernel); DDPM (with
its trajectory), DDIM and DPM-Solver++ sampling, scene completion
(``partial_boxes``, the RePaint splice) and re-arrangement
(``input_boxes``), both DDPM only; the variational bound (``prior_kl``,
``all_kl``).

Departures from the JAX package: a room-mask model given neither
``room_layout`` nor ``room_feat`` raises ``ValueError`` (the JAX package
drops the part silently and then fails on the condition's width), and the
extractor is the config's ``feature_extractor`` section (name,
feature_size, input_channels), where the JAX package always builds a
ResNet18 with 64 features over 1 channel (the shipped values).
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
                         prior_bpd, q_sample)
from ..diffusion import samplers as S
from ..utils.config import as_dtype
from ..utils.convert import denoiser_tree
from .denoiser import Unet1D, init_parameters
from .feature_extractors import FrozenBatchNorm, get_feature_extractor


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
    feature_extractor: str = "resnet18"
    room_feature_size: int = 64
    room_input_channels: int = 1
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
    def from_config(cls, network: Dict[str, Any],
                    feature_extractor: Optional[Dict[str, Any]] = None) -> "SceneModelConfig":
        """Build from a reference-format ``network`` config dict (already
        parsed: this package reads no YAML) and the config's
        ``feature_extractor`` section (name, feature_size, input_channels;
        ``freeze_bn: false`` raises), which a room-mask model reads."""
        dk = network.get("diffusion_kwargs", {})
        fe = dict(feature_extractor or {})
        if not fe.get("freeze_bn", True):
            raise ValueError("feature_extractor.freeze_bn: false is not supported: the "
                             "extractor's BatchNorm statistics are frozen")
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
            feature_extractor=fe.get("name", "resnet18"),
            room_feature_size=int(fe.get("feature_size", 64)),
            room_input_channels=int(fe.get("input_channels", 1)),
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


def _head(d_in: int, d_out: int, device=None) -> nn.Sequential:
    """Linear, LeakyReLU(0.1), Linear, no biases."""
    return nn.Sequential(nn.Linear(d_in, d_out, bias=False, device=device), nn.LeakyReLU(0.1),
                         nn.Linear(d_out, d_out, bias=False, device=device))


def text_emb_dim_for_network(network: Dict) -> int:
    """Token-embedding width implied by the network's text flags, so the data
    pipeline and the model's fc_text_f projection agree (the reference embeds
    with GloVe-50 at train time and runs frozen BERT-768 in the model,
    diffusion_scene_layout_ddpm.py:47-52,210-221; here both are precomputed
    host-side)."""
    if network.get("text_glove_embedding"):
        return 50
    if network.get("text_clip_embedding"):
        return 512
    return 768  # BERT-style token embeddings


class ConditionNets(nn.Module):
    """Conditioning heads (diffusion_scene_layout_ddpm.py:27-129).  A
    room-mask model projects its (B, F) room features through
    ``fc_room_f``, one Linear with a bias, to latent_dim.  The others are
    each Linear, LeakyReLU(0.1), Linear without biases: the instance condition,
    as a learnable embedding or as the fixed one-hot rows through
    ``fc_instance_condition``; the partial-scene head
    ``fc_partial_condition`` (point_dim -> partial_emb_dim) and the arrange
    head ``fc_arrange_condition`` (size, class, objectness and objfeat
    channels -> arrange_emb_dim).  A text model with token embeddings
    (768-wide BERT-style, or 50-wide GloVe) projects them through
    ``fc_text_f``, one Linear with a bias, to text_embed_dim; with CLIP the
    512-wide sentence vector is the one token itself."""

    def __init__(self, cfg: SceneModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fc_room_f = None
        if cfg.room_mask_condition:
            if cfg.latent_dim <= 0:
                raise ValueError(
                    "room_mask_condition=True needs network.latent_dim > 0 (the fc_room_f "
                    "width, diffusion_scene_layout_ddpm.py:30); the Unet's net_kwargs "
                    "context_dim must grow by the same amount so the condition vector fits")
            self.fc_room_f = nn.Linear(cfg.room_feature_size, cfg.latent_dim, device=device)
        self.positional_embedding = None
        self.fc_instance_condition = None
        self.fc_partial_condition = None
        self.fc_arrange_condition = None
        self.fc_text_f = None
        n, e = cfg.sample_num_points, cfg.instance_emb_dim
        if cfg.instance_condition and cfg.learnable_embedding:
            self.positional_embedding = nn.Parameter(torch.empty(n, e, device=device))
        elif cfg.instance_condition:
            self.fc_instance_condition = _head(n, e, device)
        if cfg.room_partial_condition:
            self.fc_partial_condition = _head(cfg.point_dim, cfg.partial_emb_dim, device)
        if cfg.room_arrange_condition:
            arrange_dim = cfg.size_dim + cfg.class_dim + cfg.objectness_dim + cfg.objfeat_dim
            self.fc_arrange_condition = _head(arrange_dim, cfg.arrange_emb_dim, device)
        if cfg.text_condition and not cfg.text_clip_embedding:
            width = text_emb_dim_for_network({"text_glove_embedding": cfg.text_glove_embedding})
            self.fc_text_f = nn.Linear(width, cfg.text_embed_dim, device=device)

    def heads(self):
        """The Linear-LeakyReLU-Linear heads this config has."""
        return [h for h in (self.fc_instance_condition, self.fc_partial_condition,
                            self.fc_arrange_condition) if h is not None]

    def forward(self, batch_size: int, num_points: int,
                partial_input: Optional[torch.Tensor] = None,
                arrange_input: Optional[torch.Tensor] = None,
                text_emb: Optional[torch.Tensor] = None,
                room_feat: Optional[torch.Tensor] = None):
        """-> (condition, condition_cross).  condition (B, N, room +
        instance + partial + arrange widths) f32, or None: a room-mask
        model's ``room_feat`` (B, F) through ``fc_room_f``, the same for
        every slot of a scene; ``partial_input``
        (B, N, point_dim) is the partial scene zero-padded to N slots and
        ``arrange_input`` (B, N, arrange width) the channels an arrangement
        keeps; each head's part is there when the config has the head and
        its input is given, concatenated in the JAX order: room, instance,
        partial, arrange.  A room-mask model raises ValueError without
        ``room_feat``.  condition_cross (B, L, text_embed_dim), or None:
        a text model's ``text_emb``, the (B, L, 768 | 50) token embeddings
        through ``fc_text_f`` or the CLIP (B, 512) sentence vector as one
        token.  A text model raises ValueError without ``text_emb``."""
        cross = None
        if self.cfg.text_condition:
            if text_emb is None:
                raise ValueError("a text-conditioned model needs text_emb, the token "
                                 "embeddings of one description a scene")
            if self.fc_text_f is not None:
                cross = self.fc_text_f(text_emb)
            else:
                cross = text_emb if text_emb.ndim == 3 else text_emb[:, None, :]
        e = self.cfg.instance_emb_dim
        parts = []
        if self.fc_room_f is not None:
            if room_feat is None:
                raise ValueError("a room-mask model needs room_layout (B, 1, H, W) or "
                                 "room_feat (B, F), one room a scene")
            room = self.fc_room_f(room_feat)
            parts.append(room[:, None, :].expand(batch_size, num_points, room.shape[-1]))
        if self.positional_embedding is not None:
            parts.append(self.positional_embedding[None, :num_points, :].expand(
                batch_size, num_points, e))
        elif self.fc_instance_condition is not None:
            # the one-hot rows of every slot (the JAX package feeds the
            # (B, N, N) identity; each scene's rows are the same)
            n = self.cfg.sample_num_points
            eye = torch.eye(n, device=self.fc_instance_condition[0].weight.device)
            parts.append(self.fc_instance_condition(eye)[None].expand(batch_size, n, e))
        if self.fc_partial_condition is not None and partial_input is not None:
            parts.append(self.fc_partial_condition(partial_input))
        if self.fc_arrange_condition is not None and arrange_input is not None:
            parts.append(self.fc_arrange_condition(arrange_input))
        if not parts:
            return None, cross
        return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)), cross


class SceneDiffusion:
    """Networks + schedule + loss + sampler (DiffusionSceneLayout_DDPM +
    DiffusionPoint, diffusion_scene_layout_ddpm.py:131-347).  Built on the
    card unless ``device`` says otherwise.  ``bounds`` are the train set's
    (``Bounds.as_device_bounds()``), which the IoU regularizer needs; they
    live on the model's device.  ``networks`` holds the denoiser, the
    conditioning heads and a room-mask model's feature extractor as one
    module (state_dict keys ``denoiser.*``, ``conditioner.*`` and
    ``feature_extractor.*``, the extractor's frozen BatchNorm statistics
    among them as buffers)."""

    def __init__(self, cfg: SceneModelConfig, bounds: Optional[Dict[str, np.ndarray]] = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.spec = cfg.spec
        self.loss_cfg = cfg.loss_config
        self.device = torch.device(device)
        self.denoiser = build_unet1d(cfg, device=self.device)
        self.conditioner = ConditionNets(cfg, device=self.device)
        self.networks = nn.ModuleDict({"denoiser": self.denoiser, "conditioner": self.conditioner})
        self.feature_extractor = None
        if cfg.room_mask_condition:
            self.feature_extractor = get_feature_extractor(
                cfg.feature_extractor, input_channels=cfg.room_input_channels,
                feature_size=cfg.room_feature_size, device=self.device)
            self.networks["feature_extractor"] = self.feature_extractor
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
        linears = [lin for head in self.conditioner.heads() for lin in head[::2]]
        for lin in (self.conditioner.fc_text_f, self.conditioner.fc_room_f):
            if lin is not None:
                linears.append(lin)
        if self.feature_extractor is not None:
            linears += [m for m in self.feature_extractor.modules() if isinstance(m, nn.Linear)]
        for lin in linears:
            w = torch.randn(lin.weight.shape, generator=generator) / math.sqrt(lin.in_features)
            lin.weight.copy_(w)
            if lin.bias is not None:
                lin.bias.zero_()
        if self.feature_extractor is not None:
            # He-scaled convolutions; the frozen BatchNorms the identity
            for m in self.feature_extractor.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   * math.sqrt(2.0 / fan_in))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, FrozenBatchNorm):
                    for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                                 (m.running_var, 1.0)):
                        t.fill_(v)
        return self

    def make_condition(self, batch_size: int, partial_input: Optional[torch.Tensor] = None,
                       arrange_input: Optional[torch.Tensor] = None,
                       text_emb: Optional[torch.Tensor] = None,
                       room_layout: Optional[torch.Tensor] = None,
                       room_feat: Optional[torch.Tensor] = None):
        """-> (condition, condition_cross), as ``ConditionNets.forward``; a
        room-mask model's ``room_feat`` is the feature extractor's output
        on ``room_layout`` (B, 1, H, W) unless it is given."""
        if room_feat is None and room_layout is not None and self.feature_extractor is not None:
            room_feat = self.feature_extractor(room_layout)
        return self.conditioner(batch_size, self.cfg.sample_num_points, partial_input,
                                arrange_input, text_emb, room_feat)

    def arrange_input(self, boxes: torch.Tensor) -> torch.Tensor:
        """The channels an arrangement keeps: sizes, then class, objectness
        and objfeat, of (B, N, point_dim) ``boxes``."""
        td, sd, bd = self.cfg.translation_dim, self.cfg.size_dim, self.cfg.bbox_dim
        return torch.cat([boxes[:, :, td: td + sd], boxes[:, :, bd:]], dim=-1)

    def condition_from_target(self, target: torch.Tensor,
                              batch: Optional[Dict[str, torch.Tensor]] = None):
        """(condition, condition_cross) of a training batch from its packed
        (B, N, point_dim) target and, for a text model, the batch's
        ``text_emb``, for a room-mask model its ``room_feat`` or else its
        ``room_layout`` (the JAX ``_conditions_from_batch``): the partial
        input is the target's first ``partial_num_points`` slots with the
        rest zeroed, the arrange input its kept channels."""
        cfg = self.cfg
        batch = batch or {}
        text_emb = batch.get("text_emb")
        room_feat = batch.get("room_feat")
        room_layout = None if room_feat is not None else batch.get("room_layout")
        partial_input = arrange_input = None
        if cfg.room_partial_condition:
            keep = torch.arange(target.shape[1], device=target.device) < cfg.partial_num_points
            partial_input = target * keep.to(target.dtype)[None, :, None]
        if cfg.room_arrange_condition:
            arrange_input = self.arrange_input(target)
        return self.make_condition(target.shape[0], partial_input, arrange_input, text_emb,
                                   room_layout, room_feat)

    def get_loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 shard: Tuple[int, int] = (0, 1)):
        """Training loss of one batch (diffusion_scene_layout_ddpm.py:131-226
        + diffusion_ddpm.py:758-772) -> (0-d loss, dict of 0-d terms).
        ``batch`` holds the attribute tensors (or the ``packed`` target), a
        text model's ``text_emb`` and a room-mask model's ``room_layout``
        (B, 1, H, W) or ``room_feat``, on this model's device.  The timesteps
        ``t`` (B,) and the ``noise`` (B, N, D) are used when given, else
        drawn from ``generator`` (on this model's device); D is point_dim,
        or translation_dim + angle_dim with the arrange head, whose model
        diffuses those channels only.

        ``shard`` (index, count): ``batch`` is the index-th of ``count``
        equal row blocks of a global batch (a data rank's rows).  ``t`` and
        ``noise`` are then the global batch's, drawn for all of it in the
        order above when not given, and this block's rows are kept, so the
        draws do not depend on the split."""
        cfg = self.cfg
        target = batch["packed"] if "packed" in batch else pack_target(cfg, batch)
        condition, condition_cross = self.condition_from_target(target, batch)
        if cfg.room_arrange_condition:
            td, sd, bd = cfg.translation_dim, cfg.size_dim, cfg.bbox_dim
            target = torch.cat([target[:, :, :td], target[:, :, td + sd: bd]], dim=-1)
        index, count = shard
        B = target.shape[0]
        if t is None:
            t = torch.randint(0, self.sched.num_timesteps, (B * count,), generator=generator,
                              device=target.device)
        if noise is None:
            noise = torch.randn((B * count, *target.shape[1:]), generator=generator,
                                device=target.device)
        if count > 1:
            t, noise = t[index * B:(index + 1) * B], noise[index * B:(index + 1) * B]
        data_t = q_sample(self.sched, target, t, noise)
        denoise_out = self.denoiser(data_t, t, condition, condition_cross)
        losses, loss_dict = p_losses(self.sched, self.spec, self.loss_cfg, denoise_out,
                                     target, data_t, t, noise, bounds=self.bounds)
        return losses.mean(), loss_dict

    def _denoise_fn(self, condition, condition_cross=None, fused=False):
        """``fused`` is False (module forward), True (the 3-D engine, each
        ResnetBlock on the ResnetBlock kernel and mid_attn on the
        set-attention kernel) or ``"rows"`` (flat-row engine, its resblock
        chains on the chain kernel).  The engines' step-invariant parts
        (weights, FiLM rows, a text model's 9 cross-attention contexts) are
        made here, once a sampling call.  ``"rows"`` on unequal level dims
        serves the 3-D engine, as the JAX package does; on the card each
        engine takes only the widths and groupings its kernels take, one
        set for both dtypes (``inference.check_card_widths`` and, for the
        rows engine, ``inference.check_rows_widths`` raise otherwise,
        before any launch)."""
        if fused is False:
            def fn(x, t):
                with torch.no_grad():
                    return self.denoiser(x, t, condition, condition_cross)
            return fn
        if fused is not True and fused != "rows":
            raise ValueError(f"fused must be False, True or 'rows', got {fused!r}")
        from .inference import (
            check_card_widths,
            check_rows_widths,
            fused_unet1d_forward,
            fused_unet1d_forward_rows,
            precompute_conditioning,
            prepare_chain_params,
            prepare_inference_params,
        )

        net = self.denoiser
        prep = prepare_inference_params(net, denoiser_tree(net),
                                        num_timesteps=self.sched.num_timesteps)
        cond_ctx = precompute_conditioning(net, prep, condition, condition_cross)
        chains = None
        if fused == "rows" and len(set(net.dim_mults)) == 1:
            if self.device.type == "cuda":
                check_rows_widths(net)
            chains = prepare_chain_params(net, prep, frozenset(cond_ctx["film_c"]))
        if chains is None:          # unequal level dims serve the 3-D engine, as in JAX
            if self.device.type == "cuda":
                check_card_widths(net)

            def fn(x, t):
                return fused_unet1d_forward(net, prep, x, t, cond_ctx=cond_ctx)
            return fn

        film_c2 = {name: v.reshape(-1, v.shape[-1]).contiguous()
                   for name, v in cond_ctx["film_c"].items()}
        ctx_rows = {"film_c2": film_c2, "cross": cond_ctx["cross"]}

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
        partial_boxes: Optional[torch.Tensor] = None,
        input_boxes: Optional[torch.Tensor] = None,
        ret_traj: bool = False,
        freq: int = 100,
        text_emb: Optional[torch.Tensor] = None,
        room_layout: Optional[torch.Tensor] = None,
        room_feat: Optional[torch.Tensor] = None,
        graph: Optional[bool] = None,
        shard: Tuple[int, int] = (0, 1),
    ) -> torch.Tensor:
        """Sample ``batch_size`` scenes -> (B, N, point_dim)
        (diffusion_scene_layout_ddpm.py:228-310).  With ``input_boxes``
        (B, N, point_dim), re-arrangement: DDPM on the (translation, angle)
        channels, conditioned on (and spliced into) the other channels of
        the input.  With ``partial_boxes`` (B, P, point_dim), completion:
        the RePaint splice, the first P slots the partial boxes.  Both run
        the ancestral chain only.  Else DPM-Solver++ with ``dpm``, DDIM with
        ``ddim``, the DDPM trajectory (n_frames, B, N, point_dim) with
        ``ret_traj`` (a frame every ``freq`` steps), or DDPM.  A text model
        takes ``text_emb``, one description's token embeddings a scene
        ((B, L, 768 | 50), or CLIP's (B, 512)); a room-mask model
        ``room_layout``, one (1, H, W) floor mask a scene, or their
        features ``room_feat`` (B, F): the extractor runs once a call,
        before the engines prepare their FiLM rows.  Noise comes from
        ``generator`` (on this model's device) or from ``noise_fn``.

        ``graph``: None runs the sampler's step from a CUDA graph on a CUDA
        device (captured once a call after one eager step, replayed for the
        rest; the port's counterpart of the JAX loops' ``lax.scan``) and
        eagerly on the CPU or with ``noise_fn``; False runs it eagerly;
        True asks for the graph and raises where it cannot run
        (``diffusion/samplers.py``).  ``shard`` (index, count): draw the
        noise for ``count`` times ``batch_size`` scenes and keep the
        index-th block of rows (a data rank's share of a global batch, as
        in ``get_loss``)."""
        if (partial_boxes is not None or input_boxes is not None) and (ddim or dpm):
            raise ValueError(
                "ddim/dpm fast sampling is not supported for completion (partial_boxes) or "
                "re-arrangement (input_boxes): those tasks run their own ancestral splice chains")
        cfg = self.cfg
        N = cfg.sample_num_points
        partial_input = arrange_input = None
        if cfg.room_partial_condition and partial_boxes is not None:
            pad = partial_boxes.new_zeros(batch_size, N - partial_boxes.shape[1],
                                          partial_boxes.shape[2])
            partial_input = torch.cat([partial_boxes, pad], dim=1)
        if cfg.room_arrange_condition and input_boxes is not None:
            arrange_input = self.arrange_input(input_boxes)
        condition, condition_cross = self.make_condition(batch_size, partial_input, arrange_input,
                                                         text_emb, room_layout, room_feat)
        fn = self._denoise_fn(condition, condition_cross, fused=fused)
        shape = (batch_size, N, cfg.point_dim)
        noise = dict(generator=generator, noise_fn=noise_fn, graph=graph, shard=shard)
        mmt, mvt = cfg.model_mean_type, cfg.model_var_type
        if input_boxes is not None:
            sub = S.p_sample_loop_arrange(self.sched, mmt, mvt, fn, shape, cfg.translation_dim,
                                          cfg.angle_dim, clip_denoised=clip_denoised, **noise)
            # the predicted (translation, angle) into the input's other channels
            td, sd, bd = cfg.translation_dim, cfg.size_dim, cfg.bbox_dim
            return torch.cat([sub[:, :, :td], input_boxes[:, :, td: td + sd], sub[:, :, td:],
                              input_boxes[:, :, bd:]], dim=-1)
        if partial_boxes is not None:
            return S.p_sample_loop_complete(self.sched, mmt, mvt, fn, shape, partial_boxes,
                                            clip_denoised=clip_denoised, **noise)
        if dpm:
            return S.dpm_solver_sample_loop(self.sched, mmt, fn, shape, dpm_steps,
                                            clip_denoised, **noise)
        if ddim:
            return S.ddim_sample_loop(self.sched, mmt, fn, shape, ddim_steps, ddim_eta,
                                      clip_denoised, **noise)
        if ret_traj:
            return S.p_sample_loop_trajectory(self.sched, mmt, mvt, fn, shape, freq,
                                              clip_denoised=clip_denoised, **noise)
        return S.p_sample_loop(self.sched, mmt, mvt, fn, shape,
                               clip_denoised=clip_denoised, **noise)

    def prior_kl(self, x0: torch.Tensor) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) in bits/dim, (B,).  (diffusion_ddpm.py:735-736)"""
        return prior_bpd(self.sched, x0)

    @torch.no_grad()
    def all_kl(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
               batch: Optional[Dict[str, torch.Tensor]] = None, clip_denoised: bool = True,
               noise_fn=None, graph: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """The whole variational-bound sweep on the module forward
        (DiffusionPoint.all_kl, diffusion_ddpm.py:738-746) -> the means of
        the total bpd, the vb terms, the prior bpd and the x_0 MSE.  With a
        ``batch`` the conditions are the batch's own
        (``condition_from_target(x0, batch)``: its task inputs from x0, a
        text model's ``text_emb``), else ``make_condition`` without
        inputs.  ``graph`` as in :meth:`sample`."""
        if batch is not None:
            condition, condition_cross = self.condition_from_target(x0, batch)
        else:
            condition, condition_cross = self.make_condition(x0.shape[0])
        total, terms, prior, mse = S.calc_bpd_loop(
            self.sched, self.cfg.model_mean_type, self.cfg.model_var_type,
            self._denoise_fn(condition, condition_cross), x0, generator=generator,
            clip_denoised=clip_denoised, noise_fn=noise_fn, graph=graph)
        return {"total_bpd_b": total, "terms_bpd": terms, "prior_bpd_b": prior, "mse_bt": mse}

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
