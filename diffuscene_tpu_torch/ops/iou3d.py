"""Axis-aligned 3-D box IoU and GIoU, batched, in plain torch.

Port of ``diffuscene_tpu/ops/iou3d.py`` (reference
``scene_synthesis/networks/loss.py:7-102``).  The object counts are tiny
(N <= 21), so the whole (B, N, N) matrix is a few elementwise torch ops
inside the loss; the JAX package has no Pallas kernel here either.
"""
from __future__ import annotations

import torch


def axis_aligned_bbox_overlaps_3d(
    bboxes1: torch.Tensor,
    bboxes2: torch.Tensor,
    mode: str = "iou",
    is_aligned: bool = False,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Pairwise (or aligned) IoU/GIoU of boxes (..., M, 6) given as
    <x1, y1, z1, x2, y2, z2>.  ``is_aligned=False`` gives (..., M, N),
    otherwise (..., M).  The union (and the enclosing volume of GIoU) is
    clamped at ``eps`` from below."""
    if mode not in ("iou", "giou"):
        raise ValueError(f"mode must be 'iou' or 'giou', got {mode!r}")
    if bboxes1.shape[-1] != 6 or bboxes2.shape[-1] != 6:
        raise ValueError("boxes must have 6 coordinates in the last axis")

    def volume(b):
        return (b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1]) * (b[..., 5] - b[..., 2])

    area1, area2 = volume(bboxes1), volume(bboxes2)
    if is_aligned:
        lo1, hi1, lo2, hi2 = bboxes1[..., :3], bboxes1[..., 3:], bboxes2[..., :3], bboxes2[..., 3:]
    else:
        lo1, hi1 = bboxes1[..., :, None, :3], bboxes1[..., :, None, 3:]
        lo2, hi2 = bboxes2[..., None, :, :3], bboxes2[..., None, :, 3:]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    wh = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp_min(0.0)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    union = (area1 + area2 - overlap).clamp_min(eps)
    ious = overlap / union
    if mode == "iou":
        return ious
    ewh = (torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2)).clamp_min(0.0)
    enclose = (ewh[..., 0] * ewh[..., 1] * ewh[..., 2]).clamp_min(eps)
    return ious - (enclose - union) / enclose
