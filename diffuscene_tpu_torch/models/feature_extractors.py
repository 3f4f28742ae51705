"""Room-mask feature extractors: ResNet18 and AlexNet with frozen BatchNorm.

Port of ``diffuscene_tpu/models/feature_extractors.py`` (reference
``scene_synthesis/networks/feature_extractors.py:8-85`` and
``frozen_batchnorm.py:6-71``): ResNet18 with a 1-channel stem and an FC
head to ``feature_size``, and the AlexNet variant.  ``FrozenBatchNorm`` is
an affine over fixed running statistics: its scale and bias are parameters
(they train, as in the JAX package, whose optimizer masks only the
statistics), its ``running_mean``/``running_var`` are buffers, so they stay
out of the optimizer and the EMA and go into every checkpoint.

Departures from the JAX package: the modules take NCHW (``(B, 1, H, W)``,
as the dataset's CHW room layouts stack and as ``nn.Conv2d`` wants; the JAX
modules take NHWC and transpose an NCHW input), and they carry the
reference's module names (``conv1``, ``layer1.0.bn1``, ``downsample.0``,
``fc.0``; AlexNet's ``features.{0,3,6,8,10}`` and ``fc``), so a reference
checkpoint's ``feature_extractor._feature_extractor.*`` keys load by
renaming (``utils/convert.py``).  The convolutions are their input's
windows and one matmul (``Conv2d``), not cuDNN's; the JAX package runs them
outside any Pallas kernel as well.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """x * scale / sqrt(var + eps) + (bias - mean * scale / sqrt(var + eps))
    over NCHW channels (frozen_batchnorm.py:6-68), eps 1e-5 in the forward
    as in the JAX module."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state_dict keys) computed as
    its input's windows and one f32 matmul, so that an output whose inputs
    are all 0 is exactly 0.  On an H100 with TF32 off, the algorithms cuDNN
    picks for these f32 convolutions leave rounding noise there instead,
    over the masks' empty floor (most of each image), and ReLU passes
    gradient through it: in chip_smoke.py phase 19's check the extractor's
    BatchNorm-bias gradients came out 4-8% from the CPU's f64 through cuDNN,
    at most 0.3% this way (the CPU's f32: 6e-7).  The backward is
    autograd's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw), (ph, pw) = self.kernel_size, self.stride, self.padding
        # every window as a view (B, C, H', W', kh, kw), then the columns
        # (C kh kw, B H' W') in one copy: F.unfold launches a kernel an image
        patches = F.pad(x, (pw, pw, ph, ph)).unfold(2, kh, sh).unfold(3, kw, sw)
        b, c, h, w = patches.shape[:4]
        cols = patches.permute(1, 4, 5, 0, 2, 3).reshape(c * kh * kw, b * h * w)
        y = self.weight.reshape(self.out_channels, -1) @ cols
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y.reshape(self.out_channels, b, h, w).transpose(0, 1)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0, bias: bool = False,
          device=None) -> nn.Conv2d:
    return Conv2d(c_in, c_out, k, stride=stride, padding=padding, bias=bias, device=device)


class BasicBlock(nn.Module):
    """ResNet basic block: 3x3 + 3x3 with frozen BN, and a 1x1 strided
    projection of the residual when the width or the stride changes."""

    def __init__(self, c_in: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, stride, 1, device=device)
        self.bn1 = FrozenBatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, 1, 1, device=device)
        self.bn2 = FrozenBatchNorm(features, device=device)
        self.downsample = None
        if c_in != features or stride != 1:
            self.downsample = nn.Sequential(_conv(c_in, features, 1, stride, device=device),
                                            FrozenBatchNorm(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """(B, C, H, W) room masks -> (B, feature_size) (feature_extractors.py:
    19-44): a 7x7 stride-2 stem over ``input_channels``, frozen BN, a 3x3
    stride-2 max pool, 4 stages of 2 basic blocks (64, 128, 256, 512), the
    global mean, then fc.0 512 -> 512, ReLU, fc.2 512 -> feature_size."""

    def __init__(self, feature_size: int = 256, input_channels: int = 1, device=None):
        super().__init__()
        self.conv1 = _conv(input_channels, 64, 7, 2, 3, device=device)
        self.bn1 = FrozenBatchNorm(64, device=device)
        c_in = 64
        for i, feats in enumerate((64, 128, 256, 512)):
            stride = 2 if i > 0 else 1
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(c_in, feats, stride, device=device),
                                  BasicBlock(feats, feats, 1, device=device)))
            c_in = feats
        self.fc = nn.Sequential(nn.Linear(512, 512, device=device), nn.ReLU(),
                                nn.Linear(512, feature_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
        return self.fc(y.mean(dim=(2, 3)))


def adaptive_avg_pool_2d(x: torch.Tensor, out: int) -> torch.Tensor:
    """``AdaptiveAvgPool2d((out, out))`` over NCHW: bin i averages rows
    [floor(i H / out), ceil((i + 1) H / out)), and out > H repeats rows;
    ``F.adaptive_avg_pool2d`` has that bin rule (the JAX package writes it
    out, as XLA has no adaptive pool)."""
    return F.adaptive_avg_pool2d(x, (out, out))


# torchvision AlexNet's feature convolutions: (index in ``features``,
# out channels, kernel, stride, padding); a max pool follows indices 0, 3, 10
_ALEXNET = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1), (8, 256, 3, 1, 1),
            (10, 256, 3, 1, 1))


class AlexNet(nn.Module):
    """torchvision AlexNet's features, a 6x6 adaptive pool, the NCHW flatten
    to 9216 and one Linear to feature_size (feature_extractors.py:47-68)."""

    def __init__(self, feature_size: int = 256, input_channels: int = 1, device=None):
        super().__init__()
        layers, c_in = [], input_channels
        for idx, feats, k, s, p in _ALEXNET:
            while len(layers) < idx:
                layers.append(nn.MaxPool2d(3, 2) if len(layers) in (2, 5) else nn.ReLU())
            layers.append(_conv(c_in, feats, k, s, p, bias=True, device=device))
            c_in = feats
        layers += [nn.ReLU(), nn.MaxPool2d(3, 2)]
        self.features = nn.Sequential(*layers)
        self.fc = nn.Linear(256 * 6 * 6, feature_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = adaptive_avg_pool_2d(self.features(x), 6)
        return self.fc(y.reshape(y.shape[0], -1))


def get_feature_extractor(name: str = "resnet18", freeze_bn: bool = True,
                          input_channels: int = 1, feature_size: int = 256,
                          device=None) -> nn.Module:
    """(feature_extractors.py:71-85).  BatchNorm is always frozen, as in
    the JAX package and the reference's shipped configs; ``freeze_bn=False``
    raises (the JAX package ignores it)."""
    if not freeze_bn:
        raise ValueError("feature_extractor.freeze_bn: false is not supported: the "
                         "extractor's BatchNorm statistics are frozen")
    if name == "resnet18":
        return ResNet18(feature_size, input_channels, device=device)
    if name == "alexnet":
        return AlexNet(feature_size, input_channels, device=device)
    raise NotImplementedError(f"feature extractor {name!r}")
