"""Optimizer and learning-rate schedule, with optax's arithmetic.

Port of the part of ``diffuscene_tpu/train/optim.py`` (reference
``scene_synthesis/networks/__init__.py:15-34,127-137``) that the shipped
configs select: global-norm clipping, then Adam, with the "step" epoch
schedule applied per step (epoch = step // steps_per_epoch).  The update
repeats optax's formulas (``clip_by_global_norm``, ``scale_by_adam``) so
that one step matches the JAX package:

- the clip scales the gradients by max_norm / norm only when the norm is
  not below the cap, with no epsilon;
- Adam: mu_hat / (sqrt(nu_hat) + eps), with the learning rate of the step
  count before the increment.

The JAX package's other choices (SGD, RAdam, AdamW by weight decay, the
"lambda" and "warmup_cosine" schedules, ``fused_adam``,
``adam_moment_dtype``) are not ported yet (ROADMAP A2) and raise here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch


def lr_schedule_factory(training_cfg: Dict[str, Any]) -> Callable[[int], float]:
    """epoch -> learning rate of the "step" schedule (networks/__init__.py:
    127-137): lr * lr_decay ** (epoch // lr_step)."""
    name = training_cfg.get("schedule", "lambda")
    if name != "step":
        raise NotImplementedError(f"the {name!r} LR schedule is not ported yet (ROADMAP A2)")
    lr = float(training_cfg.get("lr", 1e-3))
    lr_step = int(training_cfg.get("lr_step", 10000))
    lr_decay = float(training_cfg.get("lr_decay", 0.5))

    def sched(epoch):
        return lr * (lr_decay ** (epoch // lr_step))

    return sched


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm: (the gradients, scaled by max_norm / norm
    unless norm < max_norm; their global norm before the clip, 0-d)."""
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = gnorm < max_norm
    return [torch.where(keep, g, (g / gnorm) * max_norm) for g in grads], gnorm


class Optimizer:
    """Global-norm clip + Adam over a list of parameters, reading ``p.grad``.
    :meth:`step` applies one update in place and returns the gradients'
    global norm before the clip (a 0-d tensor)."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], float],
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn = lr_fn
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.slots = [[torch.zeros_like(p) for p in self.params] for _ in range(2)]   # mu, nu

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.lr_fn(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, *self.slots):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            p.add_(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
        return gnorm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "slots": [[s.clone() for s in slot] for slot in self.slots]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for slot, saved in zip(self.slots, state["slots"]):
            for s, v in zip(slot, saved):
                s.copy_(v)


def optimizer_factory(params: Sequence[torch.Tensor], training_cfg: Dict[str, Any],
                      steps_per_epoch: int = 1) -> Optimizer:
    """The clip + Adam + step schedule of a config's ``training`` section
    (networks/__init__.py:15-34)."""
    name = training_cfg.get("optimizer", "Adam")
    if name != "Adam":
        raise NotImplementedError(f"the {name!r} optimizer is not ported yet (ROADMAP A2)")
    if training_cfg.get("weight_decay"):
        raise NotImplementedError("weight decay (AdamW) is not ported yet (ROADMAP A2)")
    if training_cfg.get("fused_adam") or training_cfg.get("adam_moment_dtype") is not None:
        raise NotImplementedError(
            "fused_adam / adam_moment_dtype are not ported yet (ROADMAP A2)")
    epoch_sched = lr_schedule_factory(training_cfg)
    spe = max(int(steps_per_epoch), 1)
    return Optimizer(params, lambda step: epoch_sched(step // spe),
                     max_grad_norm=training_cfg.get("max_grad_norm", 10.0))
