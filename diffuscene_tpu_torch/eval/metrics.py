"""Scene-level evaluation metrics.

Copy of ``diffuscene_tpu/eval/metrics.py`` (numpy only), so the port does not
import the JAX package.

Equivalents of the reference eval toolkit:
- `categorical_kl` (generate_diffusion.py:44-45)
- eval-variant bbox IoU returning the per-scene overlap ratio
  (scripts/utils.py:560-662)
- pairwise intersection statistics (scripts/utils.py:664-701) — here over
  axis-aligned boxes directly, so no mesh library is required; mesh-level
  exact intersection (pyvista in the reference) can be plugged via
  ``pair_intersects``
- symmetric-pair counting (scripts/utils.py:703-747)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def categorical_kl(p: np.ndarray, q: np.ndarray) -> float:
    """KL(p || q) over category frequencies.  (generate_diffusion.py:44-45)"""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    return float((p * (np.log(p + 1e-6) - np.log(q + 1e-6))).sum())


def bbox_iou_and_overlap_ratio(
    bboxes: np.ndarray, eps: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise IoU matrix + per-scene overlap ratio.

    ``bboxes`` is (B, N, 6) <x1,y1,z1,x2,y2,z2>.  Mirrors the eval
    `axis_aligned_bbox_overlaps_3d` (scripts/utils.py:560-662):
    overlap_ratio = (sum of pairwise overlaps / 2) / (total box volume - that sum).
    Returns (ious (B, N, N), overlap_ratio (B,)).
    """
    b = np.asarray(bboxes, np.float64)
    area = (b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1]) * (b[..., 5] - b[..., 2])
    lt = np.maximum(b[..., :, None, :3], b[..., None, :, :3])
    rb = np.minimum(b[..., :, None, 3:], b[..., None, :, 3:])
    wh = np.clip(rb - lt, 0.0, None)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    union = np.maximum(area[..., :, None] + area[..., None, :] - overlap, eps)
    ious = overlap / union
    n = b.shape[-2]
    diag = np.arange(n)
    overlap_nd = overlap.copy()
    overlap_nd[..., diag, diag] = 0.0
    overlap_sum = overlap_nd.sum(axis=(-1, -2)) / 2.0
    area_sum = area.sum(axis=-1) - overlap_sum
    overlap_ratio = overlap_sum / np.maximum(area_sum, eps)
    return ious.astype(np.float32), overlap_ratio.astype(np.float32)


def compute_intersection(
    bboxes: np.ndarray,
    pair_intersects: Optional[Callable[[int, int], bool]] = None,
) -> Tuple[int, int, float, float, float]:
    """Per-scene intersection stats over object bounding boxes.

    Equivalent of `computer_intersection` (scripts/utils.py:664-701).
    ``bboxes`` is (N, 6).  Returns (num_objects, num_pairs, avg_iou,
    avg_intersection, overlap_ratio).  When ``pair_intersects`` is given
    (e.g. an exact mesh intersection test) a positive box IoU only counts if
    the callable confirms it — mirroring the `judge_mesh_intersec` branch.
    """
    n = len(bboxes)
    if n <= 1:
        return n, 1, 0.0, 0.0, 0.0
    ious, overlap_ratio = bbox_iou_and_overlap_ratio(np.asarray(bboxes)[None])
    ious = ious[0]
    iou_list, insec_list = [], []
    for i in range(n):
        for j in range(i + 1, n):
            if ious[i, j] > 0.0:
                if pair_intersects is not None and not pair_intersects(i, j):
                    iou_list.append(0.0)
                    insec_list.append(0)
                else:
                    iou_list.append(float(ious[i, j]))
                    insec_list.append(1)
            else:
                iou_list.append(0.0)
                insec_list.append(0)
    n_pairs = len(iou_list)
    return (
        n,
        n_pairs,
        float(sum(iou_list)) / n_pairs,
        float(sum(insec_list)) / n_pairs,
        float(overlap_ratio[0]),
    )


def judge_if_symmetry(box1: np.ndarray, box2: np.ndarray,
                      size_diff: float = 0.1, pos_diff: float = 0.1) -> bool:
    """(scripts/utils.py:703-714)"""
    box1 = np.asarray(box1)
    box2 = np.asarray(box2)
    center1, size1 = (box1[3:6] + box1[0:3]) / 2.0, (box1[3:6] - box1[0:3]) / 2.0
    center2, size2 = (box2[3:6] + box2[0:3]) / 2.0, (box2[3:6] - box2[0:3]) / 2.0
    if np.abs(size1 - size2).max() < size_diff:
        return bool(
            abs(center1[0] - center2[0]) < pos_diff or abs(center1[2] - center2[2]) < pos_diff
        )
    return False


def compute_symmetry(
    bboxes: np.ndarray,
    class_labels: np.ndarray,
    model_jids: Optional[Sequence[str]] = None,
    identity: Optional[Sequence] = None,
) -> int:
    """Count symmetric same-class pairs.  (scripts/utils.py:716-747)

    ``identity`` replaces the reference's (n_verts, n_faces) mesh-identity
    check when ``model_jids`` is None; pass any hashable per-object value
    (e.g. retrieved mesh ids).  When both are None, same class suffices.
    """
    n = len(bboxes)
    if n <= 1:
        return 0
    cls = np.asarray(class_labels).argmax(-1)
    num_symmetry = 0
    for i in range(n):
        for j in range(i + 1, n):
            if cls[i] != cls[j]:
                continue
            if model_jids is not None and model_jids[i] != model_jids[j]:
                continue
            if model_jids is None and identity is not None and identity[i] != identity[j]:
                continue
            if judge_if_symmetry(bboxes[i], bboxes[j]):
                num_symmetry += 1
    return num_symmetry


def scene_bboxes_from_params(translations: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """(N, 3) centers + half-extents -> (N, 6) corner boxes."""
    return np.concatenate([translations - sizes, translations + sizes], axis=-1)


# reference-spelled aliases (scripts/utils.py:664 'computer_intersection',
# :716 'computer_symmetry' — sic)
computer_intersection = compute_intersection
computer_symmetry = compute_symmetry
