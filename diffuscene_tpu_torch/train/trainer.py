"""Train and eval steps for the scene diffusion model.

Port of ``diffuscene_tpu/train/trainer.py`` (reference per-batch loop,
``scripts/train_diffusion.py:221-255`` +
``diffusion_scene_layout_ddpm.py:456-482``).  A train step is the loss of
``SceneDiffusion.get_loss`` (the module forward, differentiated by torch
autograd: the JAX package trains through XLA autodiff and no Pallas kernel),
the gradients optionally cast to ``training.grads_dtype``, their global
norm in f32, then the optimizer of ``train/optim.py`` (clip + Adam, or the
fused recipe with bf16 moments) and the EMA.

Config keys, as in the JAX package:

- ``ema_decay`` (e.g. 0.9999): an exponential moving average of the
  parameters, updated after each optimizer update as
  ``d * e + (1 - d) * p`` in f32 and stored in ``ema_dtype`` (f32 unless
  "bfloat16"); samplers use it through :meth:`Trainer.ema_or_params`.
- ``grad_accum`` (k): the mean of k micro-batch gradients (a running mean,
  as optax.MultiSteps forms it) feeds one optimizer update and one EMA
  update; the step counter counts micro-steps.
- ``grads_dtype: bfloat16``: the gradients are rounded to bf16 after the
  backward (autograd gives f32 gradients of the f32 master weights).

A room-mask model's feature extractor trains with the rest; its frozen
BatchNorm statistics are buffers, so they stay out of the flat parameter
buffer, the clip, Adam and the EMA (the JAX package zeroes their updates
with an optax mask before the clip, ``diffuscene_tpu/train/trainer.py:
121-135``), and they go into and out of every checkpoint, the EMA weights'
included.

Departures from the JAX package, where its behaviour is a fault:

- with ``ema_dtype: float32`` the JAX EMA aliases the parameters
  (``diffuscene_tpu/train/trainer.py:246``); here the EMA is always a copy;
- with bf16 gradients and ``grad_accum`` > 1 the JAX package accumulates in
  bf16 (``diffuscene_tpu/train/trainer.py:163``); here the accumulator is
  f32;
- the logged "gradnorm" is the norm the clip uses.  The JAX package logs the
  norm of the whole variables tree's gradients (``trainer.py:167``), the
  frozen statistics' included, before the mask zeroes them, so for a
  room-mask model its logged norm is not its clip's norm.

``Trainer(mixed_precision=True)`` of the JAX package (the parameters cast
to bf16 once a step) is not ported yet (ROADMAP A14).  The trainer runs on
the card unless it is asked for the CPU, and moves the model there.
Timesteps and noise come from the trainer's generator unless a step is
given them; each step's metrics come back in one host transfer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.scene_model import SceneDiffusion
from ..utils.config import as_dtype
from .optim import f32_global_norm, flatten, lr_schedule_factory, optimizer_factory, unflatten

# batch entries that go to the device ("desc_emb" arrives from the data
# pipeline and is renamed to the model's "text_emb")
_DEVICE_BATCH_KEYS = frozenset({
    "translations", "sizes", "angles", "class_labels", "objectness",
    "objfeats", "objfeats_32", "room_feat", "text_emb", "room_layout",
    "packed",
})


def _device_name(key: str) -> Optional[str]:
    name = "text_emb" if key == "desc_emb" else key
    return name if name in _DEVICE_BATCH_KEYS else None


class Trainer:
    """Owns the optimizer state, the EMA and the gradient accumulator of a
    :class:`SceneDiffusion` model."""

    def __init__(self, scene: SceneDiffusion, training_cfg: Dict[str, Any],
                 steps_per_epoch: int = 500, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.training_cfg = training_cfg
        self.steps_per_epoch = steps_per_epoch
        self.ema_decay = float(training_cfg.get("ema_decay", 0.0) or 0.0)
        self.grad_accum = int(training_cfg.get("grad_accum", 1) or 1)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        self.grads_dtype = as_dtype(training_cfg.get("grads_dtype"))
        self.ema_dtype = as_dtype(training_cfg.get("ema_dtype"))
        named = list(scene.networks.named_parameters())
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.opt = optimizer_factory(self.params, training_cfg, steps_per_epoch)
        self.lr_schedule = lr_schedule_factory(training_cfg)
        self.generator = torch.Generator(device=self.device)
        self.step = 0          # micro-steps taken (the JAX TrainState.step)
        self.mini_step = 0     # micro-batches in the accumulator
        # the EMA (one flat buffer; ``ema`` holds per-parameter views of it)
        # and the flat f32 gradient accumulator
        self._ema: Optional[torch.Tensor] = None
        self.ema: Optional[List[torch.Tensor]] = None
        self.acc: Optional[torch.Tensor] = None
        self._reset_state()

    @torch.no_grad()
    def _reset_state(self) -> None:
        self.step = self.mini_step = 0
        self.opt.count = 0
        for slot in self.opt.slots:
            for s in slot:
                s.zero_()
        if self.ema_decay > 0.0:
            self._ema = flatten(self.params).to(self.ema_dtype or torch.float32)
            self.ema = unflatten(self._ema, self.params)
        self.acc = (torch.zeros(sum(p.numel() for p in self.params), device=self.device)
                    if self.grad_accum > 1 else None)

    def init(self, seed: int) -> "Trainer":
        """Random parameters from ``seed`` (the same on any device), fresh
        optimizer state, the EMA a copy of the parameters, and the
        generator of timesteps and noise seeded."""
        self.scene.init(torch.Generator().manual_seed(seed))
        self._reset_state()
        self.generator.manual_seed(seed + 1)
        return self

    @torch.no_grad()
    def set_weights(self, params: Dict[str, torch.Tensor],
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Load ``scene.networks`` weights (a warm start); the EMA becomes
        ``ema`` when given, else a copy of the loaded weights."""
        self.scene.networks.load_state_dict(params)
        if self.ema is not None:
            for n, e, p in zip(self.names, self.ema, self.params):
                e.copy_(ema[n] if ema is not None else p)

    # ------------------------------------------------------------------
    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch of numpy arrays -> float32 tensors on the device."""
        out = {}
        for k, v in batch.items():
            name = _device_name(k)
            if name is not None:
                out[name] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
        return out

    def put_batches(self, batches: Sequence[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
        """k host batches stacked into (k, B, ...) tensors for :meth:`train_step_scan`."""
        out = {}
        for k in batches[0]:
            name = _device_name(k)
            if name is not None:
                host = np.stack([np.asarray(b[k], np.float32) for b in batches])
                out[name] = torch.as_tensor(host).to(self.device)
        return out

    # ------------------------------------------------------------------
    def _train_step(self, batch, t=None, noise=None) -> Dict[str, torch.Tensor]:
        """One micro-step; the metrics stay on the device."""
        loss, loss_dict = self.scene.get_loss(batch, self.generator, t, noise)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        g = flatten([torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)])
        del grads
        if self.grads_dtype is not None and g.dtype == torch.float32:
            g = g.to(self.grads_dtype)
        gnorm = f32_global_norm(g)
        with torch.no_grad():
            if self.acc is None:
                self.opt.step(g)
                self._update_ema()
            else:
                # running mean of the micro-batch gradients, in f32
                self.acc.add_((g.float() - self.acc) / (self.mini_step + 1))
                self.mini_step += 1
                if self.mini_step == self.grad_accum:
                    self.opt.step(self.acc)
                    self._update_ema()
                    self.acc.zero_()
                    self.mini_step = 0
        self.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = loss.detach()
        metrics["gradnorm"] = gnorm
        return metrics

    @torch.no_grad()
    def _update_ema(self) -> None:
        if self._ema is None:
            return
        d = self.ema_decay
        self._ema.copy_(d * self._ema.float() + (1.0 - d) * flatten(self.params))

    @staticmethod
    def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics.keys(), values))

    def train_step(self, batch: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One train step on a device batch; ``t`` (B,) and ``noise`` (the
        diffusion target's shape: (B, N, point_dim), or (B, N,
        translation_dim + angle_dim) for a rearrange config) replace the
        generator's draws.  Returns the loss
        terms, "loss" and "gradnorm" (of this micro-batch's gradients,
        before the clip), fetched in one host transfer."""
        return self._to_host(self._train_step(batch, t, noise))

    def train_step_scan(self, batches: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """k train steps in one call on (k, B, ...) batches (:meth:`put_batches`),
        equal to k :meth:`train_step` calls; the metrics are the mean over
        the k steps, fetched in one host transfer."""
        k = int(next(iter(batches.values())).shape[0])
        total: Dict[str, torch.Tensor] = {}
        for i in range(k):
            m = self._train_step({n: v[i] for n, v in batches.items()},
                                 None if t is None else t[i], None if noise is None else noise[i])
            for name, v in m.items():
                total[name] = v if name not in total else total[name] + v
        return self._to_host({name: v / k for name, v in total.items()})

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The loss of a batch with the current (not EMA) parameters."""
        loss, loss_dict = self.scene.get_loss(batch, self.generator, t, noise)
        metrics = dict(loss_dict)
        metrics["loss"] = loss
        return self._to_host(metrics)

    def current_lr(self, step: Optional[int] = None) -> float:
        """The schedule's learning rate at micro-step ``step`` (default: now)."""
        step = self.step if step is None else step
        return float(self.lr_schedule(step // max(self.steps_per_epoch, 1)))

    def ema_or_params(self) -> Dict[str, torch.Tensor]:
        """The weights a sampler should use: the EMA when there is one,
        keyed as ``scene.networks``' state_dict, with the networks' buffers
        (a room-mask extractor's frozen statistics)."""
        values = self.ema if self.ema is not None else [p.detach() for p in self.params]
        out = dict(zip(self.names, values))
        out.update((n, b.detach()) for n, b in self.scene.networks.named_buffers())
        return out

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The whole training state: step, parameters, EMA, Adam count and
        moments in their dtypes, the accumulator and the generator."""
        return {
            "step": self.step,
            "model": self.scene.networks.state_dict(),
            "ema": None if self.ema is None else {
                n: e.clone() for n, e in self.ema_or_params().items()},
            "optimizer": self.opt.state_dict(),
            "acc": None if self.acc is None else self.acc.clone(),
            "mini_step": self.mini_step,
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.mini_step = int(state.get("mini_step", 0))
        self.set_weights(state["model"], state.get("ema"))
        if self.acc is not None and state.get("acc") is not None:
            self.acc.copy_(state["acc"])
        self.generator.set_state(state["generator"].cpu())
