"""FID / KID over rendered scene images, with the feature extractors on the
card.

Port of ``diffuscene_tpu/eval/fid.py`` (reference
``scripts/compute_fid_scores.py``, which calls cleanfid's
``compute_fid``/``compute_kid`` over two render folders, lines 113-116).

- The metric math (``frechet_distance``, ``fid_from_features``,
  ``kid_from_features``) is a copy: host numpy and scipy in f64.
- ``PixelFeatures``: 32x32 grey pixels, as torch ops on the card.  The JAX
  package takes Pillow's ``convert("L")`` (integer luma) and a BILINEAR
  resize, which antialiases when it shrinks; here the same integer luma and
  ``F.interpolate(mode="bilinear", antialias=True)`` in Pillow's two
  passes (rows, then columns), each rounded to 8 bits as Pillow rounds.
  Pillow's weights are fixed point, so a feature may still differ from
  Pillow's by one level (1/255): on 0.02-0.1% of the features of random
  and smooth 256x256 images.  NOT comparable to published FID values.
- ``InceptionFeatures`` / ``VGG16Features``: the counterparts of the JAX
  package's ``JaxInceptionFeatures`` and ``JaxVGG16Features`` over
  ``eval/backbones.py``: resize with ``F.interpolate(bilinear,
  align_corners=False, antialias=True)`` (``jax.image.resize`` antialiases
  when it shrinks, VGG's 256 -> 224; Inception's 256 -> 299 enlarges), then
  the backbone in f32 on the card.

FID: Frechet distance between feature Gaussians (Heusel et al. 2017).
KID: unbiased block MMD^2 with the cubic polynomial kernel
     k(x, y) = (x.y / d + 1)^3 (Binkowski et al. 2018), the estimator
     cleanfid uses (subset_size-sized blocks, averaged).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.image import pillow_bilinear_resize
from .png import read_image_rgb

FeatureFn = Callable[[np.ndarray], np.ndarray]  # (B, H, W, C) uint8 -> (B, D)


# ---------------------------------------------------------------------------
# metric math
# ---------------------------------------------------------------------------

def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians N(mu1, sigma1), N(mu2, sigma2)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, sigma1 = feats1.mean(0), np.cov(feats1, rowvar=False)
    mu2, sigma2 = feats2.mean(0), np.cov(feats2, rowvar=False)
    return frechet_distance(mu1, sigma1, mu2, sigma2)


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def _mmd2_unbiased(x: np.ndarray, y: np.ndarray) -> float:
    m = x.shape[0]
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    np.fill_diagonal(kxx, 0.0)
    np.fill_diagonal(kyy, 0.0)
    return float(
        kxx.sum() / (m * (m - 1)) + kyy.sum() / (m * (m - 1)) - 2.0 * kxy.mean()
    )


def kid_from_features(
    feats1: np.ndarray, feats2: np.ndarray,
    subset_size: int = 1000, n_subsets: int = 100, seed: int = 0,
) -> float:
    """Averaged block unbiased MMD^2 (the cleanfid KID estimator)."""
    rng = np.random.default_rng(seed)
    n = min(feats1.shape[0], feats2.shape[0], subset_size)
    vals = []
    for _ in range(n_subsets):
        i1 = rng.choice(feats1.shape[0], n, replace=False)
        i2 = rng.choice(feats2.shape[0], n, replace=False)
        vals.append(_mmd2_unbiased(feats1[i1], feats2[i2]))
    return float(np.mean(vals))


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------

class PixelFeatures:
    """Grayscale, bilinear-resized, flattened pixel features (offline-safe).

    NOT comparable to Inception-based FID numbers; use for relative
    comparisons (e.g. tracking training progress) and tests only.
    """

    def __init__(self, size: int = 32, device: str = "cuda", batch_size: int = 256):
        self.size = size
        self.device = torch.device(device)
        self.batch_size = batch_size

    def __call__(self, images: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(images), self.batch_size):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + self.batch_size, ..., :3]))
            x = x.to(self.device).to(torch.int32)
            # Pillow's convert("L"): (19595 R + 38470 G + 7471 B + 2^15) >> 16
            luma = (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16
            y = pillow_bilinear_resize(luma, (self.size, self.size)) / 255.0
            out.append(y.reshape(len(y), -1).cpu().numpy())
        return np.concatenate(out).astype(np.float32)


class _BatchedFeatures:
    """A backbone on the card over (B, H, W, 3) uint8 images in chunks of
    ``batch_size``: the image in [0, 1], resized to ``size`` and prepared by
    ``_prepare``, then the backbone; (B, D) f32 numpy."""

    size: int
    model: torch.nn.Module

    def __init__(self, batch_size: int, device: str):
        self.batch_size = batch_size
        self.device = torch.device(device)

    def _prepare(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, images: np.ndarray) -> np.ndarray:
        feats = []
        for i in range(0, len(images), self.batch_size):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + self.batch_size]))
            x = x.to(self.device).permute(0, 3, 1, 2).float() / 255.0
            x = F.interpolate(x, size=(self.size, self.size), mode="bilinear",
                              align_corners=False, antialias=True)
            feats.append(self.model(self._prepare(x)).cpu().numpy())
        return np.concatenate(feats)


class InceptionFeatures(_BatchedFeatures):
    """InceptionV3 pool3 features on the card (``eval/backbones.py``).

    ``weights_path`` points to an inception_v3 state_dict with torchvision
    key layout (torch ``.pth`` or ``.npz`` with the same keys).
    Preprocessing matches the FID standard: bilinear resize to 299x299 of
    the [0, 1] image, then scale to [-1, 1].  ``fid_pools=True`` (default)
    is the canonical FID network's pooling, for FID-network weights;
    ``fid_pools=False, transform_input=True`` is plain torchvision ImageNet
    inception_v3.
    """

    size = 299

    def __init__(self, weights_path: str, batch_size: int = 64, fid_pools: bool = True,
                 transform_input: bool = False, device: str = "cuda"):
        from .backbones import InceptionV3Pool3, load_inception_params

        if not weights_path or not os.path.isfile(weights_path):
            raise FileNotFoundError(
                f"InceptionV3 weights not found at {weights_path!r}: FID with "
                "--features inception needs a locally shipped "
                "inception_v3 state_dict (.pth) or .npz; refusing to fall "
                "back to pixel features silently")
        super().__init__(batch_size, device)
        self.model = InceptionV3Pool3(load_inception_params(weights_path), fid_pools=fid_pools,
                                      transform_input=transform_input).to(self.device).eval()

    def _prepare(self, x):
        return x * 2.0 - 1.0


class VGG16Features(_BatchedFeatures):
    """VGG16 fc2 features on the card (``eval/backbones.py``).

    Matches the reference IPR pipeline (improved_precision_recall.py:319-325,
    141-167): resize to 224, ImageNet mean/std normalize, fc2 pre-activation.
    """

    size = 224
    _MEAN = (0.485, 0.456, 0.406)
    _STD = (0.229, 0.224, 0.225)

    def __init__(self, weights_path: str, batch_size: int = 64, device: str = "cuda"):
        from .backbones import VGG16Fc2, load_vgg16_params

        if not weights_path or not os.path.isfile(weights_path):
            raise FileNotFoundError(
                f"VGG16 weights not found at {weights_path!r}: IPR with "
                "--features vgg needs a locally shipped torchvision vgg16 "
                "state_dict (.pth) or .npz")
        super().__init__(batch_size, device)
        self.model = VGG16Fc2(load_vgg16_params(weights_path)).to(self.device).eval()
        self._mean = torch.tensor(self._MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(self._STD, device=self.device).view(1, 3, 1, 1)

    def _prepare(self, x):
        return (x - self._mean) / self._std


def load_image_paths(paths) -> np.ndarray:
    """Load an explicit list of image files into (B, H, W, 3) uint8 (the
    port's PNG reader; Pillow only for other formats)."""
    return np.stack([read_image_rgb(f) for f in paths])


def load_image_folder(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Load a folder of renders into (B, H, W, 3) uint8 (sorted order)."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if limit:
        files = files[:limit]
    return load_image_paths(files)


def compute_fid_folders(real_dir: str, fake_dir: str,
                        feature_fn: Optional[FeatureFn] = None) -> float:
    """compute_fid_scores.py:113 equivalent over two render folders."""
    feature_fn = feature_fn or PixelFeatures()
    return fid_from_features(
        feature_fn(load_image_folder(real_dir)), feature_fn(load_image_folder(fake_dir))
    )


def compute_kid_folders(real_dir: str, fake_dir: str,
                        feature_fn: Optional[FeatureFn] = None,
                        subset_size: int = 1000) -> float:
    feature_fn = feature_fn or PixelFeatures()
    return kid_from_features(
        feature_fn(load_image_folder(real_dir)),
        feature_fn(load_image_folder(fake_dir)),
        subset_size=subset_size,
    )
