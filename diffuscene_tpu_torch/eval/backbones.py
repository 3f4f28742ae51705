"""InceptionV3 and VGG16 feature backbones for FID and improved
precision/recall, as ``nn.Module``s in NCHW on the card.

Port of ``diffuscene_tpu/eval/backbones.py``.  The reference computes FID
with cleanfid's InceptionV3 (scripts/compute_fid_scores.py:113-116) and
improved precision/recall with torchvision's VGG16 fc2 features
(scripts/improved_precision_recall.py:52-59, 141-167).  Neither torchvision
nor the weights are assumed: the modules are built from the spec tables
below over a flat parameter dict keyed by the torchvision state-dict names,
loaded from a torch ``.pth`` state dict or an ``.npz`` with the same keys.

- The loaders are copies of the JAX package's: Inception's BatchNorm
  (eps 1e-3) is folded into each convolution at load, and every weight is
  kept as the JAX package keeps it (HWIO convolutions, (in, out) linears).
  That dict is the weight bridge: ``InceptionV3Pool3(params)`` and
  ``VGG16Fc2(params)`` take the port's loader's output or the JAX
  package's ``load_inception_params`` / ``load_vgg16_params`` alike.
- The forward passes are ``F.conv2d``, pools and ``F.linear`` in f32 (the
  JAX package runs these convolutions and products outside any Pallas
  kernel); callers keep TF32 off.

Feature taps match the reference:
- InceptionV3: the 2048-d global-average "pool3" features (torchvision
  inception_v3 up to avgpool, aux head ignored).
- VGG16: ``classifier[:4]``, the fc2 pre-activation, 4096-d
  (improved_precision_recall.py:166).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Dict[str, np.ndarray]]

# ---------------------------------------------------------------------------
# architecture specs: (name, in_ch, out_ch, (kh, kw), stride, (ph, pw))
# ---------------------------------------------------------------------------

ConvSpec = Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]


def _a(prefix: str, in_ch: int, pool: int) -> List[ConvSpec]:
    """InceptionA (torchvision Mixed_5b/5c/5d)."""
    return [
        (f"{prefix}.branch1x1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch5x5_1", in_ch, 48, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch_pool", in_ch, pool, (1, 1), 1, (0, 0)),
    ]


def _b(prefix: str, in_ch: int) -> List[ConvSpec]:
    """InceptionB (Mixed_6a)."""
    return [
        (f"{prefix}.branch3x3", in_ch, 384, (3, 3), 2, (0, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
    ]


def _c(prefix: str, in_ch: int, c7: int) -> List[ConvSpec]:
    """InceptionC (Mixed_6b..6e)."""
    return [
        (f"{prefix}.branch1x1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


def _d(prefix: str, in_ch: int) -> List[ConvSpec]:
    """InceptionD (Mixed_7a)."""
    return [
        (f"{prefix}.branch3x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
        (f"{prefix}.branch7x7x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
    ]


def _e(prefix: str, in_ch: int) -> List[ConvSpec]:
    """InceptionE (Mixed_7b/7c)."""
    return [
        (f"{prefix}.branch1x1", in_ch, 320, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_1", in_ch, 384, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{prefix}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 448, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


INCEPTION_CONVS: List[ConvSpec] = (
    [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ]
    + _a("Mixed_5b", 192, 32) + _a("Mixed_5c", 256, 64) + _a("Mixed_5d", 288, 64)
    + _b("Mixed_6a", 288)
    + _c("Mixed_6b", 768, 128) + _c("Mixed_6c", 768, 160)
    + _c("Mixed_6d", 768, 160) + _c("Mixed_6e", 768, 192)
    + _d("Mixed_7a", 768)
    + _e("Mixed_7b", 1280) + _e("Mixed_7c", 2048)
)

# torchvision VGG16 (cfg "D"): features.<idx> conv layers + classifier fc1/fc2
VGG16_CONVS: List[ConvSpec] = [
    (f"features.{idx}", cin, cout, (3, 3), 1, (1, 1))
    for idx, cin, cout in [
        (0, 3, 64), (2, 64, 64),
        (5, 64, 128), (7, 128, 128),
        (10, 128, 256), (12, 256, 256), (14, 256, 256),
        (17, 256, 512), (19, 512, 512), (21, 512, 512),
        (24, 512, 512), (26, 512, 512), (28, 512, 512),
    ]
]
VGG16_POOL_AFTER = {"features.2", "features.7", "features.14",
                    "features.21", "features.28"}
VGG16_FCS = [("classifier.0", 25088, 4096), ("classifier.3", 4096, 4096)]

_BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------

def _fold_conv_bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Fold ``{prefix}.bn`` into ``{prefix}.conv`` -> HWIO weight + bias."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)  # (O, I, kH, kW)
    g = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
    scale = g / np.sqrt(var + _BN_EPS)
    w = w * scale[:, None, None, None]
    b = beta - mean * scale
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}  # HWIO


def _plain_conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}


def _state_dict_from_file(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def load_inception_params(path: str) -> Params:
    """Load torchvision inception_v3 weights (.pth state_dict or .npz)."""
    sd = _state_dict_from_file(path)
    return {name: _fold_conv_bn(sd, name) for name, *_ in INCEPTION_CONVS}


def load_vgg16_params(path: str) -> Params:
    """Load torchvision vgg16 weights (.pth state_dict or .npz)."""
    sd = _state_dict_from_file(path)
    params = {name: _plain_conv(sd, name) for name, *_ in VGG16_CONVS}
    for name, _, _ in VGG16_FCS:
        params[name] = {
            "w": np.asarray(sd[f"{name}.weight"], np.float32).T,  # (in, out)
            "b": np.asarray(sd[f"{name}.bias"], np.float32),
        }
    return params


def random_inception_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random torchvision-format state_dict (loader/numerics tests)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, cin, cout, (kh, kw), _, _ in INCEPTION_CONVS:
        fan_in = cin * kh * kw
        sd[f"{name}.conv.weight"] = rng.normal(
            0, 1.0 / math.sqrt(fan_in), (cout, cin, kh, kw)).astype(np.float32)
        sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        sd[f"{name}.bn.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = rng.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    return sd


def random_vgg16_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, cin, cout, (kh, kw), _, _ in VGG16_CONVS:
        fan_in = cin * kh * kw
        sd[f"{name}.weight"] = rng.normal(
            0, 1.0 / math.sqrt(fan_in), (cout, cin, kh, kw)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.05, cout).astype(np.float32)
    for name, fin, fout in VGG16_FCS:
        sd[f"{name}.weight"] = rng.normal(
            0, 1.0 / math.sqrt(fin), (fout, fin)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.05, fout).astype(np.float32)
    return sd


# ---------------------------------------------------------------------------
# forward passes (torch, NCHW)
# ---------------------------------------------------------------------------

class _FoldedConvs(nn.Module):
    """The convolutions of a spec table with their folded weights, as
    buffers (OIHW weight, bias) named after the spec's layer."""

    def __init__(self, params: Params, specs: List[ConvSpec]):
        super().__init__()
        self._layers = {}
        for name, cin, cout, (kh, kw), stride, pad in specs:
            key = name.replace(".", "__")
            w = torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(params[name]["w"], np.float32), (3, 2, 0, 1))))
            if tuple(w.shape) != (cout, cin, kh, kw):
                raise ValueError(f"{name}: weight {tuple(w.shape)}, the spec says "
                                 f"{(cout, cin, kh, kw)}")
            self.register_buffer(f"{key}_w", w)
            self.register_buffer(f"{key}_b", torch.from_numpy(
                np.asarray(params[name]["b"], np.float32).copy()))
            self._layers[name] = (key, stride, pad)

    def conv(self, name: str, x):
        """conv + bias + ReLU with the spec's stride and padding."""
        key, stride, pad = self._layers[name]
        return F.relu(F.conv2d(x, getattr(self, f"{key}_w"), getattr(self, f"{key}_b"),
                               stride=stride, padding=pad))


class InceptionV3Pool3(_FoldedConvs):
    """(B, 3, 299, 299) float in [-1, 1] -> (B, 2048) pool3 features.

    Mirrors torchvision ``Inception3._forward`` (aux head skipped), with the
    two switches of the JAX package's ``inception_v3_pool3``:

    - ``fid_pools=True`` (default): the canonical FID network's pooling
      (pytorch-fid FIDInceptionA/C/E_1/E_2): avg pools exclude padding and
      Mixed_7c's pool branch is a max pool; use it with FID-network
      weights;
    - ``fid_pools=False``: plain torchvision inception_v3 semantics;
    - ``transform_input=True``: torchvision's ImageNet input
      re-normalization (Inception3._transform_input).
    """

    def __init__(self, params: Params, fid_pools: bool = True,
                 transform_input: bool = False):
        super().__init__(params, INCEPTION_CONVS)
        self.fid_pools = fid_pools
        self.transform_input = transform_input

    def _avgpool(self, x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not self.fid_pools)

    def forward(self, x):
        if self.transform_input:
            x = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                           x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                           x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=1)
        c = self.conv
        x = c("Conv2d_1a_3x3", x)
        x = c("Conv2d_2a_3x3", x)
        x = c("Conv2d_2b_3x3", x)
        x = F.max_pool2d(x, 3, 2)
        x = c("Conv2d_3b_1x1", x)
        x = c("Conv2d_4a_3x3", x)
        x = F.max_pool2d(x, 3, 2)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):          # InceptionA
            b1 = c(f"{p}.branch1x1", x)
            b5 = c(f"{p}.branch5x5_2", c(f"{p}.branch5x5_1", x))
            b3 = c(f"{p}.branch3x3dbl_3", c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x)))
            bp = c(f"{p}.branch_pool", self._avgpool(x))
            x = torch.cat([b1, b5, b3, bp], dim=1)
        b3 = c("Mixed_6a.branch3x3", x)                          # InceptionB
        bd = c("Mixed_6a.branch3x3dbl_3",
               c("Mixed_6a.branch3x3dbl_2", c("Mixed_6a.branch3x3dbl_1", x)))
        x = torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):  # InceptionC
            b1 = c(f"{p}.branch1x1", x)
            b7 = c(f"{p}.branch7x7_3", c(f"{p}.branch7x7_2", c(f"{p}.branch7x7_1", x)))
            bd = x
            for i in range(1, 6):
                bd = c(f"{p}.branch7x7dbl_{i}", bd)
            bp = c(f"{p}.branch_pool", self._avgpool(x))
            x = torch.cat([b1, b7, bd, bp], dim=1)
        b3 = c("Mixed_7a.branch3x3_2", c("Mixed_7a.branch3x3_1", x))   # InceptionD
        b7 = x
        for i in range(1, 5):
            b7 = c(f"Mixed_7a.branch7x7x3_{i}", b7)
        x = torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)
        for p in ("Mixed_7b", "Mixed_7c"):                      # InceptionE
            b1 = c(f"{p}.branch1x1", x)
            b3 = c(f"{p}.branch3x3_1", x)
            b3 = torch.cat([c(f"{p}.branch3x3_2a", b3), c(f"{p}.branch3x3_2b", b3)], dim=1)
            bd = c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x))
            bd = torch.cat([c(f"{p}.branch3x3dbl_3a", bd), c(f"{p}.branch3x3dbl_3b", bd)], dim=1)
            # FIDInceptionE_2 (Mixed_7c) pools with MAX, not avg
            pool = (F.max_pool2d(x, 3, 1, 1) if p == "Mixed_7c" and self.fid_pools
                    else self._avgpool(x))
            x = torch.cat([b1, b3, bd, c(f"{p}.branch_pool", pool)], dim=1)
        return x.mean(dim=(2, 3))


class VGG16Fc2(_FoldedConvs):
    """(B, 3, 224, 224) ImageNet-normalized -> (B, 4096) fc2 features:
    ``vgg16.classifier[:4](vgg16.features(x).view(-1, 25088))``, the fc2
    pre-activation (dropout is the identity in eval;
    improved_precision_recall.py:164-166)."""

    def __init__(self, params: Params):
        super().__init__(params, VGG16_CONVS)
        for name, fin, fout in VGG16_FCS:
            w = np.asarray(params[name]["w"], np.float32)
            if w.shape != (fin, fout):
                raise ValueError(f"{name}: weight {w.shape}, the spec says {(fin, fout)}")
            key = name.replace(".", "__")
            self.register_buffer(f"{key}_w", torch.from_numpy(np.ascontiguousarray(w.T)))
            self.register_buffer(f"{key}_b", torch.from_numpy(
                np.asarray(params[name]["b"], np.float32).copy()))

    def forward(self, x):
        for name, *_ in VGG16_CONVS:
            x = self.conv(name, x)
            if name in VGG16_POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        x = x.flatten(1)                                         # NCHW order, as torch's view
        x = F.relu(F.linear(x, self.classifier__0_w, self.classifier__0_b))
        return F.linear(x, self.classifier__3_w, self.classifier__3_b)
