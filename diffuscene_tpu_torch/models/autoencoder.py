"""KL-regularized point-cloud shape autoencoder (graph encoder + FoldingNet),
as torch ``nn.Module``s in the (B, N, C) layout.

Port of ``diffuscene_tpu/models/autoencoder.py`` (reference
``scene_synthesis/networks/foldingnet_autoencoder.py:131-420``).  The
autoencoder makes the 32-d "objfeats" codes of the scene model.  Every conv
of the reference has kernel size 1, so each is one matmul over the
channel-last rows.

Parameters carry the reference state_dict names and shapes that
``diffuscene_tpu.utils.convert.convert_autoencoder`` reads: k=1 Conv1d
weights (O, I, 1) under ``encoder.conv1..4``,
``encoder.graph_layer{1,2}.conv`` and ``decoder.fold{1,2}.layers.{0,3,6}``;
BatchNorm1d ``weight``/``bias``/``running_mean``/``running_var``/
``num_batches_tracked`` under ``encoder.bn1..4``,
``encoder.graph_layer{1,2}.bn`` and ``decoder.fold{1,2}.layers.{1,4}``;
Linear (O, I) ``mean_fc``, ``logvar_fc``, ``fc``.  A reference checkpoint
loads with ``load_state_dict``.

BatchNorm is the port's own, with flax's semantics: momentum 0.9 on the
running average, eps 1e-5, and the *biased* variance E[x^2] - E[x]^2
(clamped at 0) both to normalise and to update the running variance
(``torch.nn.BatchNorm1d`` updates with the unbiased one).

The training loss runs the chamfer kernel of ``ops/chamfer.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chamfer import chamfer_distance
from ..ops.knn import gather_neighbors, knn_indices

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
LOGVAR_CLIP = (-30.0, 20.0)


class Conv1x1(nn.Module):
    """k=1 Conv1d on channel-last (..., C) tensors; weight (O, I, 1)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 1))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with flax's statistics (see
    the module docstring).  Train mode normalises with the batch moments
    and updates the running ones; eval mode uses the running moments.

    ``sync`` (set by a data-parallel trainer): (a differentiable sum over
    the data ranks, their number).  Train mode then sums each channel's
    values and squares over the ranks, so the moments, and the running
    ones after them, are those of the global batch, as under the JAX
    package's sharded batch (every rank holds as many rows)."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.sync: Optional[Tuple[Callable[[torch.Tensor], torch.Tensor], int]] = None
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            if self.sync is None:
                mean = rows.mean(dim=0)
                var = ((rows * rows).mean(dim=0) - mean * mean).clamp_min(0.0)
            else:
                total, n_ranks = self.sync
                sums = total(torch.cat([rows.sum(dim=0), (rows * rows).sum(dim=0)]))
                mean, mean2 = (sums / (rows.shape[0] * n_ranks)).chunk(2)
                var = (mean2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GraphLayer(nn.Module):
    """KNN local max-pool in feature space, then conv + BN + ReLU
    (foldingnet_autoencoder.py:131-160)."""

    def __init__(self, c_in: int, c_out: int, k: int = 16):
        super().__init__()
        self.k = k
        self.conv = Conv1x1(c_in, c_out)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        with torch.no_grad():
            idx = knn_indices(x, self.k)
        x = gather_neighbors(x, idx).amax(dim=2)
        return F.relu(self.bn(self.conv(x)))


class Encoder(nn.Module):
    """Graph encoder: KNN covariances -> 3 conv layers -> 2 graph layers ->
    conv + BN -> global max (foldingnet_autoencoder.py:161-207).
    (B, N, 3) -> (B, 512)."""

    def __init__(self, k: int = 16):
        super().__init__()
        self.k = k
        self.conv1 = Conv1x1(12, 64)
        self.conv2 = Conv1x1(64, 64)
        self.conv3 = Conv1x1(64, 64)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(64)
        self.bn3 = BatchNorm(64)
        self.graph_layer1 = GraphLayer(64, 128, k)
        self.graph_layer2 = GraphLayer(128, 1024, k)
        self.conv4 = Conv1x1(1024, 512)
        self.bn4 = BatchNorm(512)

    def forward(self, pc):
        B, N, _ = pc.shape
        with torch.no_grad():
            idx = knn_indices(pc, self.k)
        neigh = gather_neighbors(pc, idx)                          # (B, N, k, 3)
        centered = neigh - neigh.mean(dim=2, keepdim=True)
        cov = torch.einsum("bnki,bnkj->bnij", centered, centered).reshape(B, N, 9)
        x = torch.cat([pc, cov], dim=-1)                           # (B, N, 12)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = self.graph_layer2(self.graph_layer1(x))
        return self.bn4(self.conv4(x)).amax(dim=1)


class FoldingLayer(nn.Module):
    """Shared MLP over concatenated (grid or points, codewords):
    Sequential [conv, BN, ReLU, conv, BN, ReLU, conv] as in the reference
    (foldingnet_autoencoder.py:210-241)."""

    def __init__(self, c_in: int, out_channels: Tuple[int, ...] = (512, 512, 3)):
        super().__init__()
        layers = []
        for oc in out_channels[:-1]:
            layers += [Conv1x1(c_in, oc), BatchNorm(oc), nn.ReLU()]
            c_in = oc
        layers.append(Conv1x1(c_in, out_channels[-1]))
        self.layers = nn.Sequential(*layers)

    def forward(self, grids, codewords):
        return self.layers(torch.cat([grids, codewords], dim=-1))


def folding_grid(grid_size: int = 45, extent: float = 0.3) -> np.ndarray:
    """2-D folding seed grid, (grid_size^2, 2) f32, in the reference's order."""
    xx = np.linspace(-extent, extent, grid_size, dtype=np.float32)
    yy = np.linspace(-extent, extent, grid_size, dtype=np.float32)
    g = np.meshgrid(xx, yy)
    return np.stack([g[0].reshape(-1), g[1].reshape(-1)], axis=-1)


class Decoder(nn.Module):
    """FoldingNet decoder, two folds over a 45x45 grid
    (foldingnet_autoencoder.py:244-282).  (B, 512) -> (B, 2025, 3)."""

    def __init__(self, grid_size: int = 45):
        super().__init__()
        self.register_buffer("grid", torch.from_numpy(folding_grid(grid_size)), persistent=False)
        self.fold1 = FoldingLayer(2 + 512)
        self.fold2 = FoldingLayer(3 + 512)

    def forward(self, code):
        B = code.shape[0]
        m = self.grid.shape[0]
        grid = self.grid[None].expand(B, m, 2)
        code = code[:, None, :].expand(B, m, code.shape[-1])
        return self.fold2(self.fold1(grid, code), code)


def diagonal_gaussian_kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, var) || N(0, I)), the *mean* over the latent axis -> (B,)."""
    logvar = logvar.clamp(*LOGVAR_CLIP)
    return 0.5 * (mean ** 2 + logvar.exp() - 1.0 - logvar).mean(dim=1)


class AutoEncoder(nn.Module):
    """The plain (non-KL) encoder/decoder pair (foldingnet_autoencoder.py:
    285-295): (B, N, 3) -> 512-d codeword -> (B, 2025, 3).  Built on the
    card unless ``device`` says otherwise."""

    def __init__(self, device: torch.device | str = "cuda"):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.to(device)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(pc))


class KLAutoEncoder(nn.Module):
    """KL-regularized shape autoencoder (foldingnet_autoencoder.py:337-390).
    ``latent_dim=32`` and ``kl_weight=0.001`` in the shipped configs.  Built
    on the card unless ``device`` says otherwise; train or eval mode is the
    module's own (``.train()`` / ``.eval()``)."""

    def __init__(self, latent_dim: int = 64, kl_weight: float = 0.001,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.latent_dim = latent_dim
        self.kl_weight = kl_weight
        self.encoder = Encoder()
        self.mean_fc = nn.Linear(512, latent_dim)
        self.logvar_fc = nn.Linear(512, latent_dim)
        self.fc = nn.Linear(latent_dim, 512)
        self.decoder = Decoder()
        self.to(device)

    def posterior(self, pc: torch.Tensor):
        """(B, N, 3) -> (mean, clipped logvar) of the latent posterior."""
        h = self.encoder(pc)
        return self.mean_fc(h), self.logvar_fc(h).clamp(*LOGVAR_CLIP)

    def encode(self, pc: torch.Tensor, deterministic: bool = False,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """(B, N, 3) -> (kl (B,), latent (B, latent_dim)).  The sample is
        mean + exp(logvar / 2) * eps, with ``eps`` given or drawn from
        ``generator``."""
        mean, logvar = self.posterior(pc)
        if deterministic:
            lat = mean
        else:
            if eps is None:
                eps = torch.randn(mean.shape, generator=generator, device=mean.device)
            lat = mean + torch.exp(0.5 * logvar) * eps
        return diagonal_gaussian_kl(mean, logvar), lat

    def decode(self, lat: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.fc(lat))

    def forward(self, pc: torch.Tensor, deterministic: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        kl, lat = self.encode(pc, deterministic, eps, generator)
        return kl, lat, self.decode(lat)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisation from a CPU ``generator``: weights from a
    normal truncated at 2 std with variance 1/fan_in (lecun normal), biases
    0, BatchNorm scale 1 and running moments (0, 1).  The same seed gives
    the same weights on any device."""
    std_of_truncated = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, (Conv1x1, nn.Linear)):
            w = mod.weight
            fan_in = w.shape[1]
            std = (1.0 / fan_in) ** 0.5 / std_of_truncated
            t = torch.empty(w.shape)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
            w.copy_(t)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()


def build_autoencoder(network_cfg: Dict[str, Any], device: torch.device | str = "cuda"
                      ) -> KLAutoEncoder:
    """A ``KLAutoEncoder`` from a config's ``network`` section
    (``objfeat_dim``, ``kl_weight``), on the card unless asked otherwise."""
    return KLAutoEncoder(latent_dim=int(network_cfg.get("objfeat_dim", 32)),
                         kl_weight=float(network_cfg.get("kl_weight", 0.001)),
                         device=device)


def kl_autoencoder_loss(kl, recon, pc, kl_weight: float):
    """loss = chamfer + kl_weight * KL (foldingnet_autoencoder.py:374-390)."""
    dist1, dist2, _, _ = chamfer_distance(pc, recon)
    loss_cd = (dist1.mean(dim=1) + dist2.mean(dim=1)).mean()
    loss_kl = kl.mean()
    loss = loss_cd + loss_kl * kl_weight
    return loss, {"loss.cd": loss_cd, "loss.kl": loss_kl}
