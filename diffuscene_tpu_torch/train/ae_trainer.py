"""Train, eval and encode steps for the KL shape autoencoder.

Port of ``diffuscene_tpu/train/ae_trainer.py`` (reference per-batch loop,
``scene_synthesis/networks/foldingnet_autoencoder.py:394-420``).  A train
step is: forward in train mode (BatchNorm normalises with the batch moments
and updates its running ones), chamfer + KL loss, backward, global-norm
clip + Adam.  The chamfer of every step runs the CUDA kernel on the card
(two directed launches).

The trainer owns the model and the optimizer state; it runs on the card
unless it is asked for the CPU, and moves the model there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.autoencoder import KLAutoEncoder, init_parameters, kl_autoencoder_loss
from .optim import optimizer_factory

METRICS = ("loss", "loss.cd", "loss.kl", "gradnorm")


class AETrainer:
    def __init__(self, model: KLAutoEncoder, training_cfg: Dict[str, Any],
                 steps_per_epoch: int = 500, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.opt = optimizer_factory(list(model.parameters()), training_cfg, steps_per_epoch)
        self.generator = torch.Generator(device=self.device)

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
        return torch.as_tensor(np.asarray(pc, np.float32)).to(self.device)

    def train_step(self, pc: torch.Tensor, eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, float]:
        """One optimizer step on a (B, N, 3) batch.  ``eps`` (B, latent_dim)
        replaces the posterior sample's noise, else the trainer's generator
        draws it.  Returns the metrics, fetched in one host transfer."""
        self.model.train()
        kl, _, recon = self.model(pc, eps=eps, generator=self.generator)
        loss, parts = kl_autoencoder_loss(kl, recon, pc, self.model.kl_weight)
        self.opt.zero_grad()
        loss.backward()
        gnorm = self.opt.step()
        values = torch.stack([loss.detach(), parts["loss.cd"].detach(),
                              parts["loss.kl"].detach(), gnorm]).tolist()
        return dict(zip(METRICS, values))

    @torch.no_grad()
    def eval_step(self, pc: torch.Tensor) -> Dict[str, float]:
        """Loss in eval mode with the posterior mean (running BatchNorm
        moments)."""
        self.model.eval()
        kl, _, recon = self.model(pc, deterministic=True)
        loss, parts = kl_autoencoder_loss(kl, recon, pc, self.model.kl_weight)
        values = torch.stack([loss, parts["loss.cd"], parts["loss.kl"]]).tolist()
        return dict(zip(METRICS, values))

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
