"""Improved Precision & Recall (Kynkäänniemi et al. 2019) over render features,
on the card in f64.

Port of ``diffuscene_tpu/eval/ipr.py`` (reference
``scripts/improved_precision_recall.py``, IPR class at 51-199, metric math
at 202-300): build the k-NN radius manifold of each feature set (k=3, 5000
samples by default) and measure

  precision = fraction of fake samples inside the real manifold
  recall    = fraction of real samples inside the fake manifold

where "inside" means distance to some reference sample <= that sample's
k-th-nearest-neighbour radius.  The pairwise distances, the radii and the
``<=`` tests run as torch ops on ``device`` in f64, with the JAX package's
expansion ||x||^2 + ||y||^2 - 2 x.yT, clamped at 0, then sqrt; so the
radius tests decide as numpy's f64 does and the counts compare exactly.
The subsampling draws stay on the host (``np.random.default_rng``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class PrecisionRecall(NamedTuple):
    precision: float
    recall: float


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)


def _distances(x: torch.Tensor, y: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """(N, D), (M, D) f64 -> (N, M) euclidean distances, chunked over rows."""
    yy = (y * y).sum(1)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        d2 = (xc * xc).sum(1)[:, None] + yy[None, :] - 2.0 * xc @ y.T
        out[i:i + chunk] = torch.sqrt(torch.clamp(d2, min=0.0))
    return out


def _radii(feats: torch.Tensor, k: int) -> torch.Tensor:
    # column 0 is self (distance 0); the k-th neighbour is at sorted index k
    return torch.sort(_distances(feats, feats), dim=1).values[:, k]


def pairwise_distances(x: np.ndarray, y: np.ndarray, chunk: int = 1024,
                       device: str = "cuda") -> np.ndarray:
    """(N, D), (M, D) -> (N, M) euclidean distances, computed on ``device``."""
    return _distances(_f64(x, device), _f64(y, device), chunk).cpu().numpy()


def knn_radii(feats: np.ndarray, k: int = 3, device: str = "cuda") -> np.ndarray:
    """Distance to the k-th nearest neighbour (excluding self) per sample
    (improved_precision_recall.py: manifold radii with k=3)."""
    return _radii(_f64(feats, device), k).cpu().numpy()


def _fraction_inside(subjects: torch.Tensor, refs: torch.Tensor, radii: torch.Tensor) -> float:
    inside = (_distances(subjects, refs) <= radii[None, :]).any(dim=1)
    return int(inside.sum()) / len(inside)


def subsample_features(feats: np.ndarray, num_samples: Optional[int],
                       rng: np.random.Generator) -> np.ndarray:
    """Uniform without-replacement subsample to at most ``num_samples`` rows
    (the reference caps both manifolds at --num_samples=5000,
    improved_precision_recall.py:377-379)."""
    if num_samples is not None and len(feats) > num_samples:
        return feats[rng.choice(len(feats), num_samples, replace=False)]
    return feats


def save_manifold(path: str, feats: np.ndarray, k: int = 3, device: str = "cuda"):
    """Persist a precalculated reference manifold (features + k-NN radii),
    the reference's --fname_precalc / IPR.save_ref
    (improved_precision_recall.py:381,463-467)."""
    # native dtype (no cast) so a reloaded manifold reproduces the
    # folder-based precision/recall bit-exactly
    np.savez(path if path.endswith(".npz") else path + ".npz",
             feats=np.asarray(feats),
             radii=np.asarray(knn_radii(feats, k, device)),
             k=np.int64(k))


def load_manifold(path: str):
    """(feats, radii, k) from a save_manifold npz — accepted anywhere the
    reference accepts a precalculated .npz as path_real
    (improved_precision_recall.py:106)."""
    d = np.load(path)
    return d["feats"], d["radii"], int(d["k"])


def compute_precision_recall(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    k: int = 3,
    num_samples: Optional[int] = 5000,
    seed: int = 0,
    device: str = "cuda",
) -> PrecisionRecall:
    """IPR over two feature sets (improved_precision_recall.py:256-300)."""
    rng = np.random.default_rng(seed)
    real = _f64(subsample_features(real_feats, num_samples, rng), device)
    fake = _f64(subsample_features(fake_feats, num_samples, rng), device)
    precision = _fraction_inside(fake, real, _radii(real, k))
    recall = _fraction_inside(real, fake, _radii(fake, k))
    return PrecisionRecall(precision, recall)


def realism(real_feats: np.ndarray, real_radii: np.ndarray,
            subject_feat: np.ndarray, eps: float = 1e-6, device: str = "cuda") -> float:
    """Realism score of ONE subject feature against the real manifold:
    the max over real samples of radius_i / (||feat_i - subject|| + eps)
    (``scripts/improved_precision_recall.py:273-281``; the reference clips
    no radius to the median, and neither does this).  A score >= 1 means
    the subject lies inside at least one real-manifold ball."""
    dists = torch.linalg.norm(_f64(real_feats, device) - _f64(subject_feat, device), dim=1)
    return float((_f64(real_radii, device) / (dists + eps)).max())


def compute_realism_scores(real_feats: np.ndarray, subject_feats: np.ndarray,
                           k: int = 3, eps: float = 1e-6, device: str = "cuda") -> np.ndarray:
    """Realism of a batch of subjects: (M,) scores from one pairwise-distance
    matrix, the real manifold radii by the same k-NN rule as
    precision/recall (improved_precision_recall.py:240-253)."""
    real = _f64(real_feats, device)
    d = _distances(_f64(subject_feats, device), real)           # (M, N)
    return (_radii(real, k)[None, :] / (d + eps)).max(dim=1).values.cpu().numpy()


def compute_ipr_folders(
    real_dir: str, fake_dir: str,
    feature_fn: Optional[Callable] = None,
    k: int = 3, num_samples: int = 5000, device: str = "cuda",
) -> PrecisionRecall:
    from .fid import PixelFeatures, load_image_folder

    feature_fn = feature_fn or PixelFeatures(device=device)
    return compute_precision_recall(
        feature_fn(load_image_folder(real_dir)),
        feature_fn(load_image_folder(fake_dir)),
        k=k, num_samples=num_samples, device=device,
    )
