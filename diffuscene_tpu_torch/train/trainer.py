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

``mixed_precision`` (``diffuscene_tpu/train/trainer.py:150-160``) casts
the f32 master parameters to bf16 once a step, outside the gradient: the
loss runs on those copies (``torch.func.functional_call``).  What the JAX
step computes then, for a bf16 config and an f32 one alike: flax promotes a
bf16 parameter to the module's dtype, so the port's modules see each copy
in its parameter's dtype (bf16 values in f32 for an f32 config), except
the weight-standardized kernels, which the JAX WSDense standardizes in
bf16 arithmetic (its moments summed in f32 and rounded): those stay bf16
(``WSConv1x1`` standardizes a bf16 kernel in bf16).  The gradients are taken with respect to the
bf16 copies, so they are rounded to bf16 as the JAX gradients of bf16
leaves are, and come back to f32.  The parameters, the optimizer slots and
the EMA stay f32.

Over a mesh (``parallel/mesh.py``, one process a card) the step computes
what the JAX step computes on the *global* batch, whatever the world size:

- :meth:`put_batch` takes the global host batch and keeps this data rank's
  rows (B must divide over the data ranks);
- the timesteps and noise are drawn for the global batch from the
  trainer's generator (seeded alike on every rank) and sliced
  (``SceneDiffusion.get_loss(shard=)``), and a step's given ``t`` and
  ``noise`` are the global batch's too;
- the loss is a per-scene mean, so the mean over the data group of the
  ranks' losses is the global loss: one all-reduce of the flat gradient
  and the metrics averages them over the data group, before the clip's
  norm, so the logged "gradnorm" is the global one (with ``grad_accum``,
  at every micro-step, as the JAX step logs each micro-step's norm);
- ``tensor_parallel`` keeps this model rank's column block of each large
  kernel (``parallel/tp.py``: the JAX rule and default size,
  ``shard_params``) as its f32 master copy, with its Adam moments and EMA;
  each step all-gathers the full kernels for the forward, and the clip's
  norm counts each sharded element once and each replicated one once.  It
  shards the optimizer state and the EMA only: every rank still holds the
  module's full parameters (brought up to date from the blocks when they
  are read: ``eval_step``, ``state_dict``) and runs the whole forward and
  backward on its data rank's rows, so it saves no compute against data
  parallelism.

The trainer runs on the card unless it is asked for the CPU, and moves the
model there.  Timesteps and noise come from the trainer's generator unless
a step is given them; each step's metrics come back in one host transfer.

A micro-step is one body over device buffers (:meth:`Trainer._body`: the
loss, autograd, the norm, and the optimizer step and the EMA, or the
gradient's running mean): its per-step values (the running mean's count
and the optimizer's) come from the optimizer's device tensor, which the
host fills with one copy before the step (``train/optim.py:prepare``).
``graph`` chooses how it runs (``utils/graphs.py:use_graph``), as the JAX
package jits its step (``diffuscene_tpu/train/trainer.py:206-217``):
``None`` (the default) from
a CUDA graph on a single-process CUDA trainer, eagerly on the CPU and over
a distributed mesh (its collectives, and the tensor-parallel norm's
boolean mask, which has a data-dependent shape, are not captured);
``False`` eagerly; ``True`` raises where ``None`` runs eagerly.  From a
graph, each variant of the step (a batch shape, whether t and noise are
given, for ``grad_accum`` a micro-step with or without the update) runs
eagerly on a side stream at its first call, is captured at its second and
replayed from then on (``utils/graphs.py:GraphedSteps``); the caller's
batch, t and noise are copied into the variant's static buffers first, and
the trainer's generator is registered with every graph, so a graphed run
draws what an eager run of the same seed draws.  The eval step (the
counterpart of the JAX package's jitted ``_eval_step``,
``diffuscene_tpu/train/trainer.py:200-217``) runs the same way: one body
(:meth:`Trainer._eval_body`, the loss of the current parameters with t and
noise drawn inside it) over static copies of the batch, a variant a batch
shape (a validation loader's ragged last batch is its own), the metrics
fetched in one host transfer after the replay.
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.denoiser import WSConv1x1
from ..models.scene_model import SceneDiffusion
from ..parallel.mesh import Mesh, all_reduce_mean_, make_mesh, shard_batch
from ..parallel.tp import gather_full, param_shardings, shard_params
from ..utils.config import as_dtype
from ..utils.graphs import GraphedSteps, use_graph
from .optim import (ACC_COUNT, f32_global_norm, flatten, lr_schedule_factory, optimizer_factory,
                    unflatten)

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


class _SceneLoss(nn.Module):
    """``SceneDiffusion.get_loss`` as a module over ``scene.networks``, so
    that ``functional_call`` can run it on other parameter values."""

    def __init__(self, scene: SceneDiffusion):
        super().__init__()
        self.networks = scene.networks
        self.__dict__["scene"] = scene          # not a submodule

    def forward(self, batch, generator, t, noise, shard):
        return self.scene.get_loss(batch, generator, t, noise, shard)


class Trainer:
    """Owns the optimizer state, the EMA and the gradient accumulator of a
    :class:`SceneDiffusion` model; over ``mesh`` (default: every rank of
    the process group, or none), data-parallel, and with
    ``tensor_parallel`` the large kernels split over the model group;
    ``graph`` as in the module's docstring."""

    def __init__(self, scene: SceneDiffusion, training_cfg: Dict[str, Any],
                 steps_per_epoch: int = 500, device: torch.device | str = "cuda",
                 mesh: Optional[Mesh] = None, tensor_parallel: bool = False,
                 mixed_precision: bool = False, graph: Optional[bool] = None):
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.mixed_precision = mixed_precision
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
        self._module_params: List[torch.Tensor] = [p for _, p in named]
        self.shardings = (param_shardings(scene.networks, self.mesh) if tensor_parallel
                          else dict.fromkeys(self.names))
        self._sharded = [i for i, n in enumerate(self.names) if self.shardings[n] is not None]
        self._dims = [self.shardings[self.names[i]] for i in self._sharded]
        # the master tensors: the module's parameters, or this model rank's
        # column block of a sharded kernel
        self.params: List[torch.Tensor] = list(self._module_params)
        blocks = self._shard([p.detach() for p in self._module_params])
        for i in self._sharded:
            self.params[i] = nn.Parameter(blocks[i])
        self._sharded_mask = None
        if self._sharded:
            self._sharded_mask = flatten([
                torch.full((p.numel(),), i in self._sharded, dtype=torch.bool, device=self.device)
                for i, p in enumerate(self.params)])
        self._loss_module = _SceneLoss(self.scene)
        # under mixed precision the weight-standardized kernels are seen in
        # bf16 (standardized in bf16, as the JAX WSDense does on a bf16
        # kernel), every other bf16 copy in its parameter's dtype
        self._bf16_seen = {f"{m_name}.weight" for m_name, m in scene.networks.named_modules()
                           if isinstance(m, WSConv1x1)}
        self.opt = optimizer_factory(self.params, training_cfg, steps_per_epoch)
        if self._sharded:
            self.opt.sq_norm = self._sq_norm
        self.lr_schedule = lr_schedule_factory(training_cfg)
        self.generator = torch.Generator(device=self.device)
        self.graph = use_graph(graph, self.device, uncapturable=(
            "over a distributed mesh" if self.mesh.distributed else None))
        self.step_graphs = GraphedSteps(self.device, self.generator)
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
        # the graphs hold the EMA and the accumulator this rebinds
        self.step_graphs.close()
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
        self._blocks_from_module()
        self._reset_state()
        self.generator.manual_seed(seed + 1)
        return self

    @torch.no_grad()
    def set_weights(self, params: Dict[str, torch.Tensor],
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Load ``scene.networks`` weights (a warm start; full tensors); the
        EMA becomes ``ema`` when given, else a copy of the loaded weights."""
        self.scene.networks.load_state_dict(params)
        self._blocks_from_module()
        if self.ema is not None:
            src = self.params if ema is None else self._shard([ema[n] for n in self.names])
            for e, v in zip(self.ema, src):
                e.copy_(v)

    # -- tensor parallelism: this rank's blocks and the full tensors --------
    def _shard(self, full: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This model rank's blocks of per-parameter full tensors
        (parameters, EMA or slots); replicated ones as they are."""
        return list(shard_params(dict(zip(self.names, full)), self.shardings,
                                 self.mesh).values())

    def _full(self, local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Full tensors of per-parameter ``local`` values (parameters, EMA or
        slots): one all-gather over the model group.  A collective call."""
        out = list(local)
        if self._sharded:
            blocks = gather_full([local[i] for i in self._sharded], self._dims, self.mesh)
            for i, t in zip(self._sharded, blocks):
                out[i] = t
        return out

    @torch.no_grad()
    def _blocks_from_module(self) -> None:
        if self._sharded:
            blocks = self._shard(self._module_params)
            for i in self._sharded:
                self.params[i].copy_(blocks[i])

    @torch.no_grad()
    def _module_from_blocks(self) -> None:
        if self._sharded:
            for p, full in zip(self._module_params, self._full(self.params)):
                if full is not p:
                    p.copy_(full)

    def _sq_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The global sum of squares of the flat gradient in f32: each
        replicated element once, each model rank's block once."""
        gg = g.float() * g.float()
        sharded = gg[self._sharded_mask].sum()
        if self.mesh.distributed:
            dist.all_reduce(sharded, group=self.mesh.model_group)
        return gg[~self._sharded_mask].sum() + sharded

    # ------------------------------------------------------------------
    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A global host batch of numpy arrays -> this data rank's rows as
        float32 tensors on the device."""
        out = {}
        for k, v in shard_batch(batch, self.mesh).items():
            name = _device_name(k)
            if name is not None:
                out[name] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
        return out

    def put_batches(self, batches: Sequence[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
        """k global host batches stacked into (k, B, ...) tensors (this data
        rank's rows) for :meth:`train_step_scan`."""
        out = {}
        for k in batches[0]:
            name = _device_name(k)
            if name is not None:
                host = np.stack([np.asarray(b[k], np.float32) for b in batches])
                out[name] = torch.as_tensor(
                    shard_batch({k: host}, self.mesh, axis=1)[k]).to(self.device)
        return out

    # ------------------------------------------------------------------
    def _loss(self, batch, t, noise, differentiable: bool = True):
        """(loss, terms, the tensors to differentiate): the module's own
        parameters, or (mixed precision, tensor parallelism) the forward
        through ``functional_call`` on their bf16 copies or full kernels."""
        shard = (self.mesh.data_rank, self.mesh.n_data)
        if not (self.mixed_precision or self._sharded):
            loss, terms = self.scene.get_loss(batch, self.generator, t, noise, shard)
            return loss, terms, self.params
        leaves = [p.detach().to(torch.bfloat16).requires_grad_(differentiable)
                  if self.mixed_precision and p.dtype == torch.float32 else p
                  for p in self.params]
        full = list(leaves)
        if self._sharded:
            blocks = gather_full([leaves[i] for i in self._sharded], self._dims, self.mesh,
                                 differentiable=differentiable)
            for i, b in zip(self._sharded, blocks):
                full[i] = b
        values = {f"networks.{n}": v if n in self._bf16_seen else v.to(p.dtype)
                  for n, v, p in zip(self.names, full, self._module_params)}
        loss, terms = torch.func.functional_call(self._loss_module, values,
                                                 (batch, self.generator, t, noise, shard))
        return loss, terms, leaves

    def _body(self, batch, t, noise, update: bool) -> Dict[str, torch.Tensor]:
        """One micro-step on the device, reading its per-step values from
        ``opt.scalars``: the loss and its gradients, their norm, then the
        optimizer step and the EMA, or (``grad_accum``) the gradient's
        running mean, followed with ``update`` by the optimizer step on it,
        the EMA and the accumulator zeroed.  Keeps no host state, so that a
        CUDA graph replays it; the metrics stay on the device."""
        loss, loss_dict, leaves = self._loss(batch, t, noise)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = flatten([torch.zeros_like(p) if g is None else g.to(p.dtype)
                     for g, p in zip(grads, self.params)])
        del grads
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = loss.detach()
        if self.mesh.distributed:
            # one all-reduce: the flat gradient and the metrics, averaged
            # over the data group
            buf = torch.cat([g.float(), torch.stack([v.float() for v in metrics.values()])])
            all_reduce_mean_(buf, self.mesh)
            g = buf[:g.numel()]
            metrics = dict(zip(metrics, buf[g.numel():]))
        if self.grads_dtype is not None and g.dtype == torch.float32:
            g = g.to(self.grads_dtype)
        gnorm = torch.sqrt(self._sq_norm(g)) if self._sharded else f32_global_norm(g)
        with torch.no_grad():
            if self.acc is not None:
                # running mean of the micro-batch gradients, in f32
                self.acc.add_((g.float() - self.acc) / self.opt.scalars[ACC_COUNT])
                g = self.acc
            if update:
                self.opt.update(g)
                self._update_ema()
                if self.acc is not None:
                    self.acc.zero_()
        metrics["gradnorm"] = gnorm
        return metrics

    def _train_step(self, batch, t=None, noise=None) -> Dict[str, torch.Tensor]:
        """One micro-step: its per-step values to the device (one copy), then
        the body, eagerly or from the graph of its variant; the metrics stay
        on the device (a graph's static outputs, which its next replay
        overwrites)."""
        update = self.acc is None or self.mini_step + 1 == self.grad_accum
        self.opt.prepare(advance=update, acc_count=self.mini_step + 1.0)
        if self.graph:
            body = functools.partial(type(self)._body, weakref.proxy(self), update=update)
            metrics = self.step_graphs(body, batch, t, noise, key=update)
        else:
            metrics = self._body(batch, t, noise, update)
        if self.acc is not None:
            self.mini_step = 0 if update else self.mini_step + 1
        self.step += 1
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
        """One train step on a device batch (this data rank's rows,
        :meth:`put_batch`); ``t`` (B,) and ``noise`` (the diffusion target's
        shape: (B, N, point_dim), or (B, N, translation_dim + angle_dim) for
        a rearrange config), both of the global batch, replace the
        generator's draws.  Returns the loss terms, "loss" and "gradnorm"
        (of this micro-batch's gradients, before the clip), of the global
        batch, fetched in one host transfer."""
        return self._to_host(self._train_step(batch, t, noise))

    def train_step_scan(self, batches: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """k train steps in one call on (k, B, ...) batches (:meth:`put_batches`),
        equal to k :meth:`train_step` calls (the ``lax.scan`` of the JAX
        package's ``train_step_scan``: from a graph, k replays); the metrics
        are the mean over the k steps, summed on the device and fetched in
        one host transfer."""
        k = int(next(iter(batches.values())).shape[0])
        total: Dict[str, torch.Tensor] = {}
        for i in range(k):
            m = self._train_step({n: v[i] for n, v in batches.items()},
                                 None if t is None else t[i], None if noise is None else noise[i])
            for name, v in m.items():
                # a graph's outputs are overwritten by its next replay
                total[name] = v.clone() if name not in total else total[name] + v
        return self._to_host({name: v / k for name, v in total.items()})

    def _eval_body(self, batch, t, noise) -> Dict[str, torch.Tensor]:
        """The loss terms and "loss" of a batch with the current (not EMA)
        parameters, on the device; keeps no host state, so that a CUDA graph
        replays it."""
        loss, loss_dict = self.scene.get_loss(batch, self.generator, t, noise,
                                              (self.mesh.data_rank, self.mesh.n_data))
        metrics = dict(loss_dict)
        metrics["loss"] = loss
        if self.mesh.distributed:
            values = all_reduce_mean_(torch.stack([v.float() for v in metrics.values()]),
                                      self.mesh)
            metrics = dict(zip(metrics, values))
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The loss of a batch with the current (not EMA) f32 parameters,
        averaged over the data group; ``t`` and ``noise`` as in
        :meth:`train_step`.  From the graph of its batch shape where the
        train step runs from a graph; the metrics come back in one host
        transfer."""
        self._module_from_blocks()
        if self.graph:
            metrics = self.step_graphs(functools.partial(type(self)._eval_body,
                                                         weakref.proxy(self)),
                                       batch, t, noise, key="eval")
        else:
            metrics = self._eval_body(batch, t, noise)
        return self._to_host(metrics)

    def current_lr(self, step: Optional[int] = None) -> float:
        """The schedule's learning rate at micro-step ``step`` (default: now)."""
        step = self.step if step is None else step
        return float(self.lr_schedule(step // max(self.steps_per_epoch, 1)))

    def ema_or_params(self) -> Dict[str, torch.Tensor]:
        """The weights a sampler should use: the EMA when there is one,
        keyed as ``scene.networks``' state_dict, with the networks' buffers
        (a room-mask extractor's frozen statistics); full tensors (under
        tensor parallelism a collective call)."""
        values = self.ema if self.ema is not None else [p.detach() for p in self.params]
        out = dict(zip(self.names, self._full(values)))
        out.update((n, b.detach()) for n, b in self.scene.networks.named_buffers())
        return out

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The whole training state: step, parameters, EMA, Adam count and
        moments in their dtypes, the accumulator and the generator; full
        tensors (under tensor parallelism a collective call)."""
        self._module_from_blocks()
        opt = self.opt.state_dict()
        acc = None if self.acc is None else self.acc.clone()
        if self._sharded:
            opt["slots"] = [self._full(slot) for slot in opt["slots"]]
            if acc is not None:
                acc = flatten(self._full(unflatten(acc, self.params)))
        return {
            "step": self.step,
            "model": self.scene.networks.state_dict(),
            "ema": None if self.ema is None else {
                n: e.clone() for n, e in self.ema_or_params().items()},
            "optimizer": opt,
            "acc": acc,
            "mini_step": self.mini_step,
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        opt, acc = state["optimizer"], state.get("acc")
        if self._sharded:
            opt = dict(opt, slots=[self._shard(slot) for slot in opt["slots"]])
            if acc is not None:
                acc = flatten(self._shard(unflatten(acc.to(self.device), self._module_params)))
        self.opt.load_state_dict(opt)
        self.step = int(state["step"])
        self.mini_step = int(state.get("mini_step", 0))
        self.set_weights(state["model"], state.get("ema"))
        if self.acc is not None and acc is not None:
            self.acc.copy_(acc)
        self.generator.set_state(state["generator"].cpu())
