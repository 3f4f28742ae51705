"""Optimizers and learning-rate schedules, with optax's arithmetic.

Port of ``diffuscene_tpu/train/optim.py`` (reference
``scene_synthesis/networks/__init__.py:15-34,78-168``): global-norm
clipping, then SGD with momentum, Adam (AdamW with a weight decay) or
RAdam, with the "step", "lambda" and "warmup_cosine" epoch schedules applied
per step (epoch = step // steps_per_epoch).  The updates repeat optax's
formulas so that a step matches the JAX package's chain:

- the clip scales the gradients by max_norm / norm only when the norm is
  not below the cap, with no epsilon;
- SGD is optax's ``trace`` (t = g + momentum * t) then -lr * t;
- Adam: mu_hat / (sqrt(nu_hat) + eps); AdamW adds ``weight_decay * p`` to
  that (optax ``add_decayed_weights``, every parameter) before the
  learning rate;
- RAdam (``scale_by_radam``, threshold 5): r * mu_hat / (sqrt(nu_hat) +
  eps) once the rectification term ro reaches the threshold, mu_hat
  before.  ro and r are Python floats: optax forms ro = ro_inf -
  2 t b2^t / (1 - b2^t) in f32, where the two terms nearly cancel near
  the threshold (ROADMAP §C), so the port's r is the exact one and differs
  from optax's by up to 1e-4 relative there;
- the learning rate is the schedule's at the step count before the
  increment; the schedules are Python floats.

The values that change from step to step (the learning rate, Adam's bias
corrections, RAdam's r and its branch, the fused recipe's step multiplier
and eps) are formed on the host in that arithmetic
(:meth:`Optimizer.next_scalars`, ``SCALARS``) and sent to a small f32
device tensor in one copy before each step; the update (:meth:`Optimizer.update`) reads them
there, RAdam's branch as weights 1 and 0 of its two updates.  So one body
serves the eager step and a CUDA graph's replays (``train/trainer.py``,
``train/ae_trainer.py``).  Every such value is rounded to f32 as the
Python scalar it replaces was; on the card a division by a 0-d device
tensor is a true division, where a division by a host scalar multiplies by
its reciprocal.

``training.fused_adam`` / ``training.adam_moment_dtype`` select the JAX
package's ``fused_clip_adam`` (``diffuscene_tpu/train/optim.py:75``): the
norm squared in f32 (:func:`f32_global_norm`), the clip scale folded into
the moment update, the bias corrections folded into one step multiplier
and a rescaled eps, and the moments stored in ``adam_moment_dtype`` (f32
arithmetic).  Departure: the JAX package drops ``fused_adam`` silently when
the optimizer is not Adam or the weight decay is not 0
(``diffuscene_tpu/train/optim.py:181``); the port raises.

:func:`freeze_mask` is the JAX package's ``optax.masked(set_to_zero())``
before the chain: the named parameters' gradients become zeros before the
clip, so they take no gradient step (AdamW still decays them, as in optax).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import as_dtype

OPTIMIZERS = ("SGD", "Adam", "RAdam")
RADAM_THRESHOLD = 5.0
# the per-step values of a step, in the order of Optimizer.scalars: the
# count of a trainer's gradient running mean (train/trainer.py's
# grad_accum; the optimizer leaves it to the trainer), the learning rate,
# Adam's bias corrections 1 - b^t, RAdam's r and the weights of its
# rectified and plain updates (1 and 0, or 0 and 1), the fused recipe's
# step multiplier and eps; those a step does not use are 0
SCALARS = ("acc_count", "lr", "bc1", "bc2", "radam_r", "radam_rect", "radam_plain", "step_mult",
           "eps_eff")
ACC_COUNT, LR, BC1, BC2, RADAM_R, RADAM_RECT, RADAM_PLAIN, STEP_MULT, EPS_EFF = range(len(SCALARS))


def lr_schedule_factory(training_cfg: Dict[str, Any]) -> Callable[[int], float]:
    """epoch -> learning rate (networks/__init__.py:127-168): "step",
    lr * lr_decay ** (epoch // lr_step); "lambda", lr until ``start_epoch``,
    then lr * lr_decay ** (epoch - start_epoch); "warmup_cosine", a linear
    warm-up over ``warmup_epochs`` then a cosine from lr to ``min_lr`` at
    ``epochs``."""
    name = training_cfg.get("schedule", "lambda")
    lr = float(training_cfg.get("lr", 1e-3))
    if name == "step":
        lr_step = int(training_cfg.get("lr_step", 10000))
        lr_decay = float(training_cfg.get("lr_decay", 0.5))

        def sched(epoch):
            return lr * (lr_decay ** (epoch // lr_step))

    elif name == "lambda":
        start_epoch = int(training_cfg.get("start_epoch", 1000))
        lr_decay = float(training_cfg.get("lr_decay", 0.999))

        def sched(epoch):
            return lr if epoch < start_epoch else lr * (lr_decay ** max(epoch - start_epoch, 0))

    elif name == "warmup_cosine":
        warmup = int(training_cfg.get("warmup_epochs", 500))
        total = int(training_cfg.get("epochs", 10000))
        min_lr = float(training_cfg.get("min_lr", 1e-6))

        def sched(epoch):
            if epoch < warmup:
                return lr * epoch / max(warmup, 1)
            p = (epoch - warmup) / max(total - warmup, 1)
            return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * p))

    else:
        raise NotImplementedError(f"LR schedule {name!r} (step, lambda or warmup_cosine)")
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


def _clip(g: torch.Tensor, max_norm: float, sq_norm: Optional[Callable] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    gnorm = torch.sqrt((g * g).sum() if sq_norm is None else sq_norm(g))
    return torch.where(gnorm < max_norm, g, (g / gnorm) * max_norm), gnorm


def freeze_mask(names: Sequence[str], frozen_prefixes: Sequence[str]) -> List[bool]:
    """Which of the parameters ``names`` (dotted, as ``named_parameters``
    gives them) lie under one of ``frozen_prefixes``: a name any of whose
    components starts with a prefix, as the JAX package matches the
    components of a tree path.  Pass it to :class:`Optimizer` as
    ``frozen``."""
    prefixes = tuple(frozen_prefixes)
    return [any(part.startswith(prefixes) for part in n.split(".")) for n in names]


class Optimizer:
    """Global-norm clip + SGD, Adam (AdamW with ``weight_decay``) or RAdam
    over a list of parameters.  :meth:`step` applies one update in place,
    from the given gradients (a list, or all of them flattened into one 1-D
    tensor) or from ``p.grad``, and returns the gradients' global norm
    before the clip (a 0-d tensor).  ``fused`` selects the arithmetic of the
    JAX package's ``fused_clip_adam``, with the moments stored in
    ``moment_dtype``.  ``frozen`` (one bool a parameter, :func:`freeze_mask`)
    zeroes those parameters' gradients first.  ``sq_norm`` (flat gradient ->
    its global sum of squares, f32), when set, replaces the local sum of
    squares of the clip's norm: a tensor-parallel trainer's blocks are
    parts of one global gradient.

    The moments live in one flat buffer (``slots`` are per-parameter views
    of it: SGD's trace, or Adam's and RAdam's mu and nu) and every step
    works on the flattened gradient, so an update is a few kernels over all
    parameters, not a few per parameter; the arithmetic of each element is
    the per-leaf formula's.

    :meth:`step` is :meth:`prepare` (the host's part: the count advanced,
    the step's values formed and sent to :attr:`scalars`), then
    :meth:`update` (the device's part, which a CUDA graph captures)."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], float],
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 fused: bool = False, moment_dtype: Optional[torch.dtype] = None,
                 name: str = "Adam", weight_decay: float = 0.0, momentum: float = 0.9,
                 frozen: Optional[Sequence[bool]] = None):
        if name not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer {name!r} ({', '.join(OPTIMIZERS)})")
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn = lr_fn
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.name = name
        self.weight_decay = float(weight_decay or 0.0)
        self.momentum = float(momentum)
        self.fused = fused or moment_dtype is not None
        if self.fused and (name != "Adam" or self.weight_decay):
            raise ValueError("the fused update is Adam's without weight decay")
        self.count = 0
        self.sq_norm: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        device = self.params[0].device
        n = sum(p.numel() for p in self.params)
        self._moments = torch.zeros(1 if name == "SGD" else 2, n,
                                    dtype=moment_dtype or torch.float32, device=device)
        self.slots = [unflatten(m, self.params) for m in self._moments]
        self.scalars = torch.zeros(len(SCALARS), dtype=torch.float32, device=device)
        self._keep = None
        if frozen is not None and any(frozen):
            self._keep = flatten([torch.full((p.numel(),), not f, dtype=torch.bool, device=device)
                                  for p, f in zip(self.params, frozen)])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads=None) -> torch.Tensor:
        self.prepare()
        return self.update(grads)

    def prepare(self, advance: bool = True, acc_count: float = 0.0) -> None:
        """The host's part of a step: :meth:`next_scalars` (zeros without
        ``advance``, for a step that does not update), with ``acc_count``
        in its first slot, sent to :attr:`scalars` in one copy."""
        out = self.next_scalars() if advance else [0.0] * len(SCALARS)
        out[ACC_COUNT] = acc_count
        self.scalars.copy_(torch.tensor(out), non_blocking=True)

    def next_scalars(self) -> List[float]:
        """Advance the step count; this step's per-step values in
        ``SCALARS`` order, formed on the host as optax (the fused recipe: the
        JAX package's ``fused_clip_adam``) forms them."""
        out = [0.0] * len(SCALARS)
        out[LR] = lr = self.lr_fn(self.count)
        self.count += 1
        t = self.count
        if self.fused:
            # the JAX package's host scalars, in f32
            f32 = np.float32
            c = f32(t)
            bc1, bc2 = f32(1.0) - f32(self.b1) ** c, f32(1.0) - f32(self.b2) ** c
            out[STEP_MULT] = float(-f32(lr) * np.sqrt(bc2) / bc1)
            out[EPS_EFF] = float(f32(self.eps) * np.sqrt(bc2))
        elif self.name != "SGD":
            out[BC1], out[BC2] = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
            bc2 = out[BC2]
            if self.name == "RAdam":
                ro_inf = 2.0 / (1.0 - self.b2) - 1.0
                ro = ro_inf - 2.0 * t * self.b2 ** t / bc2
                if ro < RADAM_THRESHOLD:
                    out[RADAM_PLAIN] = 1.0
                else:
                    out[RADAM_RECT] = 1.0
                    out[RADAM_R] = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                             / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return out

    @torch.no_grad()
    def update(self, grads=None) -> torch.Tensor:
        """One update in place on the device, its per-step values read from
        :attr:`scalars`, from the given gradients (a list, or one flat
        tensor) or from ``p.grad``; returns the gradients' global norm
        before the clip (0-d)."""
        s = self.scalars
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        g = grads if isinstance(grads, torch.Tensor) else flatten(grads)
        if self._keep is not None:
            g = torch.where(self._keep, g, torch.zeros_like(g))
        if self.fused:
            upd, gnorm = self._fused_update(g, *self._moments, s)
        else:
            g, gnorm = _clip(g, self.max_grad_norm, self.sq_norm)
            upd = self._update(g, s)
        torch._foreach_add_(self.params, unflatten(upd, self.params))
        return gnorm

    def _update(self, g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """The update of the clipped flat gradient ``g`` (optax's chains)."""
        neg_lr = -s[LR]
        if self.name == "SGD":
            (tr,) = self._moments
            tr.copy_(g + self.momentum * tr)
            return neg_lr * tr
        mu, nu = self._moments
        b1, b2 = self.b1, self.b2
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / s[BC1]
        if self.name == "RAdam":
            rect = s[RADAM_R] * mu_hat / (torch.sqrt(nu / s[BC2]) + self.eps)
            return neg_lr * (s[RADAM_RECT] * rect + s[RADAM_PLAIN] * mu_hat)
        upd = mu_hat / (torch.sqrt(nu / s[BC2]) + self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * flatten(self.params)
        return neg_lr * upd

    def _fused_update(self, g, mu, nu, s):
        """``fused_clip_adam`` (diffuscene_tpu/train/optim.py:75-140): the
        clip scale where(norm < cap, 1, cap / norm) folded into the moment
        update, the bias corrections folded into ``step_mult`` and
        ``eps_eff`` (host scalars in f32, as the JAX package forms them),
        the moments read and written in their dtype, all arithmetic f32.
        Returns (the update, the norm)."""
        gnorm = f32_global_norm(g) if self.sq_norm is None else torch.sqrt(self.sq_norm(g))
        cap = self.max_grad_norm
        scale = torch.where(gnorm < cap, torch.ones_like(gnorm), cap / gnorm)
        b1, b2 = self.b1, self.b2
        gf = g.float() * scale
        muf = b1 * mu.float() + (1.0 - b1) * gf
        nuf = b2 * nu.float() + (1.0 - b2) * gf * gf
        mu.copy_(muf)
        nu.copy_(nuf)
        return s[STEP_MULT] * muf / (torch.sqrt(nuf) + s[EPS_EFF]), gnorm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "slots": [[s.clone() for s in slot] for slot in self.slots]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for slot, saved in zip(self.slots, state["slots"]):
            for s, v in zip(slot, saved):
                s.copy_(v)


def optimizer_factory(params: Sequence[torch.Tensor], training_cfg: Dict[str, Any],
                      steps_per_epoch: int = 1) -> Optimizer:
    """The clip + optimizer + epoch schedule of a config's ``training``
    section (networks/__init__.py:15-34): ``optimizer`` SGD (``momentum``,
    default 0.9), Adam (AdamW when ``weight_decay`` is not 0) or RAdam,
    fused with ``fused_adam`` or ``adam_moment_dtype``
    (diffuscene_tpu/train/optim.py:158-200)."""
    name = training_cfg.get("optimizer", "Adam")
    wd = training_cfg.get("weight_decay")
    moment_dtype = as_dtype(training_cfg.get("adam_moment_dtype"))
    fused = bool(training_cfg.get("fused_adam")) or moment_dtype is not None
    if fused and (name != "Adam" or wd):
        raise ValueError(
            f"fused_adam / adam_moment_dtype need the Adam optimizer without weight decay "
            f"(got {name!r}, weight_decay={wd!r}); the JAX package ignores them silently there")
    epoch_sched = lr_schedule_factory(training_cfg)
    spe = max(int(steps_per_epoch), 1)
    return Optimizer(params, lambda step: epoch_sched(step // spe),
                     max_grad_norm=training_cfg.get("max_grad_norm", 10.0),
                     fused=fused, moment_dtype=moment_dtype, name=name,
                     weight_decay=float(wd or 0.0),
                     momentum=float(training_cfg.get("momentum", 0.9)))
