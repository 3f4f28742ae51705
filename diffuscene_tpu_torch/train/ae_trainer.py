"""Train, eval and encode steps for the KL shape autoencoder.

Port of ``diffuscene_tpu/train/ae_trainer.py`` (reference per-batch loop,
``scene_synthesis/networks/foldingnet_autoencoder.py:394-420``).  A train
step is: forward in train mode (BatchNorm normalises with the batch moments
and updates its running ones), chamfer + KL loss, backward, global-norm
clip + Adam.  The chamfer of every step runs the CUDA kernel on the card
(two directed launches).

Over a mesh (``parallel/mesh.py``, one process a card) the step is the
JAX step on the global batch, whose batch is sharded over ``data``:
:meth:`AETrainer.put_batch` keeps this data rank's clouds of the global
batch, the posterior noise is drawn for the global batch and sliced, the
train-mode BatchNorm moments are summed over the data ranks (so the
running moments follow the global batch's), each rank's chamfer runs on its
own clouds, and one all-reduce averages the flat gradient and the metrics
before the clip.

The trainer owns the model and the optimizer state; it runs on the card
unless it is asked for the CPU, and moves the model there.

A train step is one body over device buffers (:meth:`AETrainer._body`:
the gradients zeroed, the forward, the backward, the clip and Adam, the
BatchNorm running moments updated in place), its per-step values sent to
the optimizer's device tensor in one copy before it (``train/optim.py``).
``graph`` chooses how it runs, as on :class:`train.trainer.Trainer`
(``utils/graphs.py``): ``None`` from a CUDA graph on a single-process CUDA
trainer (the first step of each batch shape eagerly on a side stream, the
second captured, then replays; the chamfer kernel's two launches a step
tallied by the capture and counted at every replay), eagerly on the CPU
and over a distributed mesh; ``False`` eagerly; ``True`` raises where
``None`` runs eagerly.  The chamfer's backward sums with ``index_add_``
atomics in a varying order (``ops/chamfer.py``), so a graphed step equals
an eager one only to rounding, as two eager steps do.  The eval step (eval
mode, the posterior mean, no backward; the JAX package's jitted
``_eval_step``, ``diffuscene_tpu/train/ae_trainer.py:71-93``) runs the same
way, a graph a batch shape, and equals the eager one bit for bit.
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.autoencoder import BatchNorm, KLAutoEncoder, init_parameters, kl_autoencoder_loss
from ..parallel.mesh import Mesh, all_reduce_mean_, all_reduce_sum, make_mesh, rows_of
from ..utils.graphs import GraphedSteps, use_graph
from .optim import flatten, optimizer_factory

METRICS = ("loss", "loss.cd", "loss.kl", "gradnorm")


class AETrainer:
    def __init__(self, model: KLAutoEncoder, training_cfg: Dict[str, Any],
                 steps_per_epoch: int = 500, device: torch.device | str = "cuda",
                 mesh: Optional[Mesh] = None, graph: Optional[bool] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.distributed:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.sync = (lambda t: all_reduce_sum(t, self.mesh), self.mesh.n_data)
        self.opt = optimizer_factory(list(model.parameters()), training_cfg, steps_per_epoch)
        self.generator = torch.Generator(device=self.device)
        self.graph = use_graph(graph, self.device, uncapturable=(
            "over a distributed mesh" if self.mesh.distributed else None))
        self.step_graphs = GraphedSteps(self.device, self.generator)

    def init(self, seed: int) -> "AETrainer":
        """Random parameters from ``seed`` (the same on any device), fresh
        optimizer state, and the posterior-sample generator seeded."""
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.opt.count = 0
        for slot in self.opt.slots:
            for s in slot:
                s.zero_()
        self.generator.manual_seed(seed + 1)
        return self

    @property
    def step(self) -> int:
        return self.opt.count

    def put_batch(self, pc: np.ndarray) -> torch.Tensor:
        """A global (B, N, 3) host batch -> this data rank's clouds on the
        device."""
        pc = np.asarray(pc, np.float32)
        return torch.as_tensor(pc[rows_of(len(pc), self.mesh)]).to(self.device)

    def _eps(self, pc: torch.Tensor, eps: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This data rank's rows of the global batch's posterior noise (drawn
        where it is not given); with one data rank the model draws it."""
        if self.mesh.n_data == 1:
            return eps
        total = pc.shape[0] * self.mesh.n_data
        if eps is None:
            eps = torch.randn((total, self.model.latent_dim), generator=self.generator,
                              device=self.device)
        return eps[rows_of(total, self.mesh)]

    def _body(self, pc: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """One step on the device: (loss, loss.cd, loss.kl, gradnorm), 4 f32
        values of the global batch."""
        self.opt.zero_grad()
        kl, _, recon = self.model(pc, eps=self._eps(pc, eps), generator=self.generator)
        loss, parts = kl_autoencoder_loss(kl, recon, pc, self.model.kl_weight)
        loss.backward()
        values = torch.stack([loss.detach(), parts["loss.cd"].detach(), parts["loss.kl"].detach()])
        if self.mesh.distributed:
            # one all-reduce: the flat gradient and the metrics, averaged
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.opt.params]
            buf = all_reduce_mean_(torch.cat([flatten(grads), values]), self.mesh)
            gnorm = self.opt.update(buf[:-len(values)])
            values = buf[-len(values):]
        else:
            gnorm = self.opt.update()
        return torch.cat([values, gnorm[None]])

    def train_step(self, pc: torch.Tensor, eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, float]:
        """One optimizer step on a (B, N, 3) batch (this data rank's clouds,
        :meth:`put_batch`).  ``eps`` (the global batch's (B, latent_dim))
        replaces the posterior sample's noise, else the trainer's generator
        draws it.  Returns the global batch's metrics, fetched in one host
        transfer."""
        self.model.train()
        self.opt.prepare()
        if self.graph:
            out = self.step_graphs(functools.partial(type(self)._body, weakref.proxy(self)), pc,
                                   eps)
        else:
            out = self._body(pc, eps)
        return dict(zip(METRICS, out.tolist()))

    def _eval_body(self, pc: torch.Tensor) -> torch.Tensor:
        """(loss, loss.cd, loss.kl) of a batch in eval mode, on the device."""
        kl, _, recon = self.model(pc, deterministic=True)
        loss, parts = kl_autoencoder_loss(kl, recon, pc, self.model.kl_weight)
        return all_reduce_mean_(torch.stack([loss, parts["loss.cd"], parts["loss.kl"]]),
                                self.mesh)

    @torch.no_grad()
    def eval_step(self, pc: torch.Tensor) -> Dict[str, float]:
        """Loss in eval mode with the posterior mean (running BatchNorm
        moments), averaged over the data ranks; from the graph of its batch
        shape where the train step runs from a graph (the chamfer kernel's
        two launches tallied by the capture and counted at every replay),
        fetched in one host transfer."""
        self.model.eval()
        if self.graph:
            values = self.step_graphs(functools.partial(type(self)._eval_body,
                                                        weakref.proxy(self)), pc, key="eval")
        else:
            values = self._eval_body(pc)
        return dict(zip(METRICS, values.tolist()))

    @torch.no_grad()
    def encode(self, pc: torch.Tensor) -> torch.Tensor:
        """Deterministic latents (B, latent_dim) for objfeat export
        (generate_objautoencoder.py:215-221)."""
        self.model.eval()
        return self.model.encode(pc, deterministic=True)[1]

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.opt.count, "model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
