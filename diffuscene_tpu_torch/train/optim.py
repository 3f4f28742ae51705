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

``training.fused_adam`` / ``training.adam_moment_dtype`` select the JAX
package's ``fused_clip_adam`` (``diffuscene_tpu/train/optim.py:75``): the
norm squared in f32 (:func:`f32_global_norm`), the clip scale folded into
the moment update, the bias corrections folded into one step multiplier
and a rescaled eps, and the moments stored in ``adam_moment_dtype`` (f32
arithmetic).  Departure: the JAX package drops ``fused_adam`` silently when
the optimizer is not Adam or the weight decay is not 0
(``diffuscene_tpu/train/optim.py:181``); the port raises.

The JAX package's other choices (SGD, RAdam, AdamW by weight decay, the
"lambda" and "warmup_cosine" schedules) are selected by no shipped config;
they are not ported (ROADMAP A10) and raise here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import as_dtype


def lr_schedule_factory(training_cfg: Dict[str, Any]) -> Callable[[int], float]:
    """epoch -> learning rate of the "step" schedule (networks/__init__.py:
    127-137): lr * lr_decay ** (epoch // lr_step)."""
    name = training_cfg.get("schedule", "lambda")
    if name != "step":
        raise NotImplementedError(f"the {name!r} LR schedule is not ported yet (ROADMAP A10)")
    lr = float(training_cfg.get("lr", 1e-3))
    lr_step = int(training_cfg.get("lr_step", 10000))
    lr_decay = float(training_cfg.get("lr_decay", 0.5))

    def sched(epoch):
        return lr * (lr_decay ** (epoch // lr_step))

    return sched


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' elements as one 1-D tensor (one copy)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of a 1-D ``flat`` shaped like ``like``, in order."""
    return [v.view(t.shape) for v, t in zip(torch.split(flat, [t.numel() for t in like]), like)]


def f32_global_norm(grads) -> torch.Tensor:
    """Global L2 norm of a list of tensors (or of a flat one) with every
    element squared and summed in f32 (0-d f32)."""
    g = (grads if isinstance(grads, torch.Tensor) else flatten(grads)).float()
    return torch.sqrt((g * g).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm: (the gradients, scaled by max_norm / norm
    unless norm < max_norm; their global norm before the clip, 0-d)."""
    flat, gnorm = _clip(flatten(grads), max_norm)
    return unflatten(flat, grads), gnorm


def _clip(g: torch.Tensor, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    gnorm = torch.sqrt((g * g).sum())
    return torch.where(gnorm < max_norm, g, (g / gnorm) * max_norm), gnorm


class Optimizer:
    """Global-norm clip + Adam over a list of parameters.  :meth:`step`
    applies one update in place, from the given gradients (a list, or all
    of them flattened into one 1-D tensor) or from ``p.grad``, and returns
    the gradients' global norm before the clip (a 0-d tensor).  ``fused``
    selects the arithmetic of the JAX package's ``fused_clip_adam``, with
    the moments stored in ``moment_dtype``.

    The moments live in one flat buffer (``slots`` are per-parameter views
    of it) and every step works on the flattened gradient, so an update is
    a few kernels over all parameters, not a few per parameter; the
    arithmetic of each element is the per-leaf formula's."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], float],
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 fused: bool = False, moment_dtype: Optional[torch.dtype] = None):
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn = lr_fn
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.fused = fused or moment_dtype is not None
        self.count = 0
        n = sum(p.numel() for p in self.params)
        self._moments = torch.zeros(2, n, dtype=moment_dtype or torch.float32,
                                    device=self.params[0].device)
        self.slots = [unflatten(m, self.params) for m in self._moments]   # mu, nu

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads=None) -> torch.Tensor:
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        g = grads if isinstance(grads, torch.Tensor) else flatten(grads)
        mu, nu = self._moments
        lr = self.lr_fn(self.count)
        self.count += 1
        if self.fused:
            upd, gnorm = self._fused_update(g, mu, nu, lr)
        else:
            g, gnorm = _clip(g, self.max_grad_norm)
            b1, b2 = self.b1, self.b2
            bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            upd = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        torch._foreach_add_(self.params, unflatten(upd, self.params))
        return gnorm

    def _fused_update(self, g, mu, nu, lr):
        """``fused_clip_adam`` (diffuscene_tpu/train/optim.py:75-140): the
        clip scale where(norm < cap, 1, cap / norm) folded into the moment
        update, the bias corrections folded into ``step_mult`` and
        ``eps_eff`` (host scalars in f32, as the JAX package forms them),
        the moments read and written in their dtype, all arithmetic f32.
        Returns (the update, the norm)."""
        gnorm = f32_global_norm(g)
        cap = self.max_grad_norm
        scale = torch.where(gnorm < cap, torch.ones_like(gnorm), cap / gnorm)
        f32 = np.float32
        c = f32(self.count)
        bc1, bc2 = f32(1.0) - f32(self.b1) ** c, f32(1.0) - f32(self.b2) ** c
        step_mult = float(-f32(lr) * np.sqrt(bc2) / bc1)
        eps_eff = float(f32(self.eps) * np.sqrt(bc2))
        b1, b2 = self.b1, self.b2
        gf = g.float() * scale
        muf = b1 * mu.float() + (1.0 - b1) * gf
        nuf = b2 * nu.float() + (1.0 - b2) * gf * gf
        mu.copy_(muf)
        nu.copy_(nuf)
        return step_mult * muf / (torch.sqrt(nuf) + eps_eff), gnorm

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
    (networks/__init__.py:15-34), fused with ``fused_adam`` or
    ``adam_moment_dtype`` (diffuscene_tpu/train/optim.py:158-183)."""
    name = training_cfg.get("optimizer", "Adam")
    wd = training_cfg.get("weight_decay")
    moment_dtype = as_dtype(training_cfg.get("adam_moment_dtype"))
    fused = bool(training_cfg.get("fused_adam")) or moment_dtype is not None
    if fused and (name != "Adam" or wd):
        raise ValueError(
            f"fused_adam / adam_moment_dtype need the Adam optimizer without weight decay "
            f"(got {name!r}, weight_decay={wd!r}); the JAX package ignores them silently there")
    if name != "Adam":
        raise NotImplementedError(f"the {name!r} optimizer is not ported yet (ROADMAP A10)")
    if wd:
        raise NotImplementedError("weight decay (AdamW) is not ported yet (ROADMAP A10)")
    epoch_sched = lr_schedule_factory(training_cfg)
    spe = max(int(steps_per_epoch), 1)
    return Optimizer(params, lambda step: epoch_sched(step // spe),
                     max_grad_norm=training_cfg.get("max_grad_norm", 10.0),
                     fused=fused, moment_dtype=moment_dtype)
