"""Weight standardization for the serving engine.

Port of ``diffuscene_tpu/ops/fused_resblock.py:184 standardize_kernel`` only;
the single-ResnetBlock kernel of that module (``fused_resnet_block``) is not
ported yet (ROADMAP queue B).
"""
from __future__ import annotations

import torch


def standardize_kernel(kernel: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Weight standardization over the input axis of an (in, out) kernel
    (WSDense semantics, models/denoiser.py): per output unit, biased mean and
    variance over the inputs.  Precomputed once per sampling call."""
    mean = kernel.mean(dim=0, keepdim=True)
    var = kernel.var(dim=0, unbiased=False, keepdim=True)
    return (kernel - mean) * torch.rsqrt(var + eps)
