"""Pillow's 8-bit BILINEAR resize on tensors, without Pillow.

``Image.resize(size, Image.BILINEAR)`` of an 8-bit image resamples in two
passes, the horizontal one first, each with a triangle filter whose support
grows with the downscale factor (so a shrink antialiases), and rounds each
pass to 8 bits.  ``F.interpolate(mode="bilinear", antialias=True)`` is that
filter; rounding after each pass gives Pillow's result up to Pillow's
fixed-point weights, which may move a value by one level (1/255).  The
port does not depend on Pillow, so the room masks of the data pipeline
(``data/threed_front.py``) and the pixel features of FID
(``eval/fid.py``) both resize through here, one computation whether
Pillow is installed or not.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pillow_bilinear_resize(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) 8-bit values of any dtype -> (..., h, w) float32 holding
    integers in [0, 255]; ``size`` is (w, h), as Pillow orders it.  Runs on
    the tensor's device."""
    w, h = size
    lead = img.shape[:-2]
    y = img.reshape(-1, 1, *img.shape[-2:]).float()
    for out in ((y.shape[2], w), (h, w)):
        y = F.interpolate(y, size=out, mode="bilinear", align_corners=False, antialias=True)
        y = torch.floor(y + 0.5).clamp_(0, 255)
    return y.reshape(*lead, h, w)
