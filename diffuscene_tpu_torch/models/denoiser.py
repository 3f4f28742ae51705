"""Unet1D denoiser over object sets, as torch ``nn.Module``s, (B, N, C) layout.

Port of the forward of ``diffuscene_tpu/models/denoiser.py`` (reference
``scene_synthesis/networks/denoise_net.py:335-593``).  Every conv of the
reference has kernel size 1, so each layer is a (B*N, C_in) x (C_in, C_out)
matmul on channel-last tensors.

Parameters carry the reference DiffuScene state_dict names and shapes
(``downs.L.S.*``, ``mid_*``, ``ups.*``, ``final_res_block.*``; k=1 Conv1d
weights (O, I, 1), Linear weights (O, I), LayerNorm ``g`` (1, C, 1)), so
``diffuscene_tpu.utils.convert.convert_denoiser`` reads a port state_dict
as it reads a reference checkpoint, and ``utils/convert.py`` here is its
inverse.

Numerics follow the Flax module: the input is cast to ``compute_dtype`` and
every layer computes in it, with f32 statistics for the norms.  GroupNorm eps
is 1e-6 (the flax default, not torch's 1e-5); the WSDense and
ChannelLayerNorm eps is 1e-5 for float32 activations and 1e-3 otherwise.

``Unet1D(ws_fast_vjp=True)`` gives every WSDense the JAX package's
residual-light backward (``_WSStandardizeFast``, an autograd Function).

``Unet1D(text_condition=True)`` has the text models' 9 linear
cross-attention blocks (``LinearAttentionCross``): one between block1 and
block2 of every down and up level (slot 2 of the level's ModuleList, the
reference's ``attncross``) and ``mid_attn_cross`` before ``mid_attn``.

``Unet1D(learned_sinusoidal_cond=True)`` (or ``random_fourier_features``)
embeds the timestep with learned (or fixed random) Fourier features,
``sinu_pos_emb.weights``: [t, sin(2 pi t w), cos(2 pi t w)],
``learned_sinusoidal_dim`` + 1 wide.  The random weights take no gradient
(the JAX package's ``stop_gradient``) but stay parameters, so an optimizer
keeps them among its buffers as optax keeps them in its tree.

Unequal ``dim_mults`` follow the Flax module's widths: level i's blocks are
dim * dim_mults[i - 1] wide (dim at level 0) and read whatever width comes
in (a ``res_conv`` where the two differ), only the last down level projects
to dim * dim_mults[-1] and the last up level back to dim, and an up block
whose skip concatenation is as wide as the block has an identity residual.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6


def _dtype_eps(dtype: torch.dtype) -> float:
    """WSDense / ChannelLayerNorm eps: 1e-5 for float32 activations, else 1e-3."""
    return 1e-5 if dtype == torch.float32 else 1e-3


class Conv1x1(nn.Module):
    """k=1 Conv1d applied to channel-last (..., C) tensors in ``dtype``;
    weight (O, I, 1) as in the reference (flax ``nn.Dense``)."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device)) if bias else None

    def kernel(self) -> torch.Tensor:
        """(I, O) kernel."""
        return self.weight[:, :, 0].t()

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel().to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Linear(nn.Module):
    """nn.Linear layout (O, I) computing in ``dtype`` (flax ``nn.Dense``)."""

    def __init__(self, c_in: int, c_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, device=device))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        return torch.matmul(x.to(self.dtype), self.weight.t().to(self.dtype)) + self.bias.to(self.dtype)


class _WSStandardizeFast(torch.autograd.Function):
    """Weight standardization with the JAX package's residual-light VJP
    (``diffuscene_tpu/models/denoiser.py:33-72``).

    Forward: one-pass moments of the f32 (I, O) kernel, E[k^2] - E[k]^2
    clamped at 0, then (k - mean) * rsqrt(var + eps) cast to ``dtype``.
    Backward: the layer-norm gradient
    ``inv * (dw - mean(dw) - w * mean(dw * w))`` from the SAVED
    compute-dtype ``w`` and ``inv``, in f32.  With a bf16 ``w`` the
    projection term carries its rounding (about 2^-9 relative), which is
    where it departs from autograd through the exact standardization."""

    @staticmethod
    def forward(ctx, kernel, eps, dtype):
        mean = kernel.mean(dim=0, keepdim=True)
        mean2 = (kernel * kernel).mean(dim=0, keepdim=True)
        inv = torch.rsqrt((mean2 - mean * mean).clamp_min(0.0) + eps)
        w = ((kernel - mean) * inv).to(dtype)
        ctx.save_for_backward(w, inv)
        return w

    @staticmethod
    def backward(ctx, dw):
        w, inv = ctx.saved_tensors
        dwf, wf = dw.float(), w.float()
        m_dw = dwf.mean(dim=0, keepdim=True)
        m_dww = (dwf * wf).mean(dim=0, keepdim=True)
        return inv * (dwf - m_dw - wf * m_dww), None, None


def ws_standardize_fast(kernel: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """(I, O) f32 kernel -> standardized ``dtype`` kernel, with the fast VJP."""
    return _WSStandardizeFast.apply(kernel, eps, dtype)


class WSConv1x1(Conv1x1):
    """WSDense: k=1 conv with weight standardization over the input axis
    (per output unit, biased variance) in f32, then cast to ``dtype``;
    ``fast_vjp`` switches to :func:`ws_standardize_fast`.  A bf16 weight
    (a mixed-precision step's copy) is standardized in bf16, each moment
    summed in f32 and rounded, as the JAX WSDense computes on a bf16
    kernel."""

    fast_vjp = False

    def forward(self, x):
        k = self.kernel()
        if k.dtype != torch.bfloat16:
            k = k.float()
        eps = _dtype_eps(x.dtype)
        if self.fast_vjp:
            w = ws_standardize_fast(k, eps, self.dtype)
        else:
            mean = k.mean(dim=0, keepdim=True)
            var = k.var(dim=0, unbiased=False, keepdim=True)
            w = ((k - mean) * torch.rsqrt(var + eps)).to(self.dtype)
        return torch.matmul(x.to(self.dtype), w) + self.bias.to(self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm on (B, N, C): statistics over the N objects and the group's
    channels, f32 one-pass moments clamped at 0, eps 1e-6; output in ``dtype``."""

    def __init__(self, groups: int, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        B, N, C = x.shape
        xf = x.float().reshape(B, N, self.groups, C // self.groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xf - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, N, C)
        return (y * self.weight + self.bias).to(self.dtype)


class ChannelLayerNorm(nn.Module):
    """Scale-only LayerNorm over the channel axis, one-pass biased variance
    (reference LayerNorm, denoise_net.py:93-102); ``g`` is (1, C, 1)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, channels, 1, device=device))

    def forward(self, x):
        eps = _dtype_eps(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * self.g.reshape(-1).to(x.dtype)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (denoise_net.py:127-139): (B,) -> (B, dim) f32."""
    half_dim = dim // 2
    emb = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier features of the timestep (denoise_net.py:141-156):
    (B,) -> (B, dim + 1) f32, [t, sin(2 pi t w), cos(2 pi t w)] with
    ``weights`` w of dim // 2, learned, or fixed when ``is_random``."""

    def __init__(self, dim: int, is_random: bool = False, device=None):
        super().__init__()
        self.is_random = is_random
        self.weights = nn.Parameter(torch.empty(dim // 2, device=device))

    def forward(self, t):
        w = self.weights.detach() if self.is_random else self.weights
        t = t.float()[:, None]
        freqs = t * w[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def head_blockmask(heads: int, dim_head: int, dtype, device=None) -> torch.Tensor:
    """(H*D, H*D) block-diagonal ones: 1 where both channels are one head's."""
    h = torch.arange(heads * dim_head, device=device) // dim_head
    return (h[:, None] == h[None, :]).to(dtype)


def seg_softmax_heads(x: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """Softmax within each head's ``dim_head``-channel segment of the last
    axis, in f32, with each segment's own max as the stabilizer."""
    xf = x.float().reshape(*x.shape[:-1], heads, dim_head)
    return torch.softmax(xf, dim=-1).reshape(x.shape).to(x.dtype)


class Block(nn.Module):
    """WSDense -> GroupNorm -> (scale, shift) -> SiLU  (denoise_net.py:160-176)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.proj = WSConv1x1(dim_in, dim_out, dtype=dtype, device=device)
        self.norm = GroupNorm(groups, dim_out, dtype=dtype, device=device)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two Blocks with FiLM from an embedding: (B, E) time rows broadcast over
    objects, or (B, N, E) per-object conditions (denoise_net.py:178-206)."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int = 0, groups: int = 8,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim_out = dim_out
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(emb_dim, dim_out * 2, dtype=dtype, device=device))
                    if emb_dim > 0 else None)
        self.block1 = Block(dim_in, dim_out, groups, dtype, device)
        self.block2 = Block(dim_out, dim_out, groups, dtype, device)
        self.res_conv = (Conv1x1(dim_in, dim_out, dtype=dtype, device=device)
                         if dim_in != dim_out else None)

    def forward(self, x, emb=None):
        scale_shift = None
        if self.mlp is not None and emb is not None:
            h = self.mlp(emb)
            if h.ndim == 2:
                h = h[:, None, :]
            scale_shift = (h[..., : self.dim_out], h[..., self.dim_out:])
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class LinearAttention(nn.Module):
    """'Linear' self-attention (denoise_net.py:208-235): q softmaxed over each
    head's features, k over the objects; per-head (D x D) contexts live as
    the diagonal blocks of one (H*D, H*D) matrix."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv1x1(dim, hidden * 3, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Sequential(Conv1x1(hidden, dim, dtype=dtype, device=device),
                                    ChannelLayerNorm(dim, device=device))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)   # (B, N, H*D) each
        q = seg_softmax_heads(q, self.heads, self.dim_head) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=1)                 # over the objects
        ctx = torch.einsum("bnx,bny->bxy", k, v)
        ctx = ctx * head_blockmask(self.heads, self.dim_head, ctx.dtype, ctx.device)
        out = torch.einsum("bnx,bxy->bny", q, ctx)
        return self.to_out(out)


class Attention(nn.Module):
    """Full softmax self-attention over the objects (denoise_net.py:237-259)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv1x1(dim, hidden * 3, bias=False, dtype=dtype, device=device)
        self.to_out = Conv1x1(hidden, dim, dtype=dtype, device=device)

    def forward(self, x):
        B, N, _ = x.shape
        H, D = self.heads, self.dim_head
        q, k, v = (a.reshape(B, N, H, D) for a in self.to_qkv(x).chunk(3, dim=-1))
        sim = torch.einsum("bihd,bjhd->bhij", q * (D ** -0.5), k)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, N, H * D)
        return self.to_out(out)


class LinearAttentionCross(nn.Module):
    """Linear cross-attention from the objects to text tokens
    (denoise_net.py:261-332): q = ``to_q``(x) softmaxed over each head's
    features and scaled by dim_head^-1/2; k, v = ``to_kv``(context), k
    softmaxed over the tokens (pads included, no mask); the per-head
    (D x D) contexts as the diagonal blocks of one (H*D, H*D) matrix a
    scene; then ``to_out`` and the output LayerNorm."""

    def __init__(self, dim: int, context_dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_q = Conv1x1(dim, hidden, bias=False, dtype=dtype, device=device)
        self.to_kv = Conv1x1(context_dim, hidden * 2, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Sequential(Conv1x1(hidden, dim, dtype=dtype, device=device),
                                    ChannelLayerNorm(dim, device=device))

    def forward(self, x, context):
        q = seg_softmax_heads(self.to_q(x), self.heads, self.dim_head) * (self.dim_head ** -0.5)
        k, v = self.to_kv(context).chunk(2, dim=-1)   # (B, L, H*D) each
        k = torch.softmax(k, dim=1)                   # over the tokens
        ctx = torch.einsum("blx,bly->bxy", k, v)
        ctx = ctx * head_blockmask(self.heads, self.dim_head, ctx.dtype, ctx.device)
        return self.to_out(torch.einsum("bnx,bxy->bny", q, ctx))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, device=None):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim, device=device)

    def forward(self, x, *context):
        return self.fn(self.norm(x), *context)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *context):
        return x + self.fn(x, *context)


def _mlp(widths: Sequence[int], exact_gelu: bool, dtype, device) -> nn.Sequential:
    """Sequential(Conv1d, GELU, Conv1d, GELU, Conv1d): the reference's
    per-attribute encoder/decoder MLPs (denoise_net.py:484-504)."""
    approx = "none" if exact_gelu else "tanh"
    layers = []
    for i in range(3):
        layers.append(Conv1x1(widths[i], widths[i + 1], dtype=dtype, device=device))
        if i < 2:
            layers.append(nn.GELU(approximate=approx))
    return nn.Sequential(*layers)


def _MLPEnc(c_in: int, hidden: int, exact_gelu: bool, dtype, device):
    """C_in -> d -> 2d -> d."""
    return _mlp((c_in, hidden, hidden * 2, hidden), exact_gelu, dtype, device)


def _MLPDec(hidden: int, out: int, exact_gelu: bool, dtype, device):
    """d -> 2d -> d -> C_out."""
    return _mlp((hidden, hidden * 2, hidden, out), exact_gelu, dtype, device)


class Unet1D(nn.Module):
    """Permutation-equivariant set denoiser (reference Unet1D,
    denoise_net.py:335-593): per-attribute encoder MLPs summed into one
    feature, an init projection, ``len(dim_mults)`` levels of [cond-ResBlock,
    time-ResBlock, (text cross-attention), time-ResBlock, linear
    self-attention, level projection], a middle stack with (text
    cross-attention and) full attention, the mirrored up path with skip
    concatenations, a final residual block on [x, r], and per-attribute
    decoder MLPs."""

    def __init__(
        self,
        dim: int = 512,
        dim_mults: Sequence[int] = (1, 1, 1, 1),
        channels: int = 62,
        objectness_dim: int = 0,
        class_dim: int = 22,
        translation_dim: int = 3,
        size_dim: int = 3,
        angle_dim: int = 2,
        objfeat_dim: int = 32,
        context_dim: int = 0,
        instanclass_dim: int = 128,
        seperate_all: bool = True,
        text_condition: bool = False,
        text_dim: int = 512,
        resnet_block_groups: int = 8,
        learned_sinusoidal_cond: bool = False,
        random_fourier_features: bool = False,
        learned_sinusoidal_dim: int = 16,
        out_dim: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        exact_gelu: bool = True,
        ws_fast_vjp: bool = False,
        device=None,
    ):
        super().__init__()
        self.dim = dim
        self.dim_mults = tuple(dim_mults)
        self.channels = channels
        self.objectness_dim = objectness_dim
        self.class_dim = class_dim
        self.translation_dim = translation_dim
        self.size_dim = size_dim
        self.angle_dim = angle_dim
        self.objfeat_dim = objfeat_dim
        self.context_dim = context_dim
        self.instanclass_dim = instanclass_dim
        self.seperate_all = seperate_all
        self.text_condition = text_condition
        self.text_dim = text_dim
        self.resnet_block_groups = resnet_block_groups
        self.learned_sinusoidal_cond = learned_sinusoidal_cond
        self.random_fourier_features = random_fourier_features
        self.learned_sinusoidal_dim = learned_sinusoidal_dim
        self.out_dim = out_dim
        self.compute_dtype = compute_dtype
        self.exact_gelu = exact_gelu
        self.ws_fast_vjp = ws_fast_vjp

        dt, dev, g = compute_dtype, device, resnet_block_groups
        cond_dim = context_dim + instanclass_dim
        time_dim = dim * 4
        if seperate_all:
            self.bbox_embedf = _MLPEnc(self.bbox_dim, dim, exact_gelu, dt, dev)
            self.class_embedf = _MLPEnc(class_dim, dim, exact_gelu, dt, dev)
            if objectness_dim > 0:
                self.objectness_embedf = _MLPEnc(objectness_dim, dim, exact_gelu, dt, dev)
            if objfeat_dim > 0:
                self.objfeat_embedf = _MLPEnc(objfeat_dim, dim, exact_gelu, dt, dev)
            self.init_conv = Conv1x1(dim, dim, dtype=dt, device=dev)
        else:
            self.init_conv = Conv1x1(channels, dim, dtype=dt, device=dev)
        fourier = learned_sinusoidal_cond or random_fourier_features
        self.sinu_pos_emb = (RandomOrLearnedSinusoidalPosEmb(
            learned_sinusoidal_dim, random_fourier_features, dev) if fourier else None)
        t_feat = learned_sinusoidal_dim + 1 if fourier else dim
        # slot 0 is the embedding, applied in forward (sinu_pos_emb keeps
        # the Fourier weights under the name the JAX converter reads)
        self.time_mlp = nn.Sequential(
            nn.Identity(), Linear(t_feat, time_dim, dtype=dt, device=dev),
            nn.GELU(approximate="none" if exact_gelu else "tanh"),
            Linear(time_dim, time_dim, dtype=dt, device=dev),
        )

        n_levels = len(self.dim_mults)
        # level i's blocks are level_dim[i] wide; each reads what comes in
        level_dim = [dim * (1 if i == 0 else self.dim_mults[i - 1]) for i in range(n_levels)]
        mid_dim = dim * self.dim_mults[-1]

        def res(c_in, c_out, emb):
            return ResnetBlock(c_in, c_out, emb, g, dt, dev)

        def attn(c):
            return Residual(PreNorm(c, LinearAttention(c, dtype=dt, device=dev), dev))

        def cross(c) -> nn.Module:
            if not text_condition:
                return nn.Identity()
            return Residual(PreNorm(c, LinearAttentionCross(c, text_dim, dtype=dt, device=dev),
                                    dev))

        self.downs = nn.ModuleList()
        w = dim
        for i, c in enumerate(level_dim):
            last = i == n_levels - 1
            self.downs.append(nn.ModuleList([
                res(w, c, cond_dim), res(c, c, time_dim), cross(c), res(c, c, time_dim), attn(c),
                Conv1x1(c, mid_dim, dtype=dt, device=dev) if last else nn.Identity(),
            ]))
            w = mid_dim if last else c
        self.mid_block0 = res(w, mid_dim, cond_dim)
        self.mid_block1 = res(mid_dim, mid_dim, time_dim)
        if text_condition:
            self.mid_attn_cross = cross(mid_dim)
        self.mid_attn = Residual(PreNorm(mid_dim, Attention(mid_dim, dtype=dt, device=dev), dev))
        self.mid_block2 = res(mid_dim, mid_dim, time_dim)
        self.ups = nn.ModuleList()
        w = mid_dim
        for j in range(n_levels):
            i = n_levels - 1 - j
            c_in, c_out = level_dim[i], dim * self.dim_mults[i]
            last = j == n_levels - 1
            self.ups.append(nn.ModuleList([
                res(w, c_in, cond_dim), res(2 * c_in, c_out, time_dim), cross(c_out),
                res(c_out + c_in, c_out, time_dim), attn(c_out),
                Conv1x1(c_out, c_in, dtype=dt, device=dev) if last else nn.Identity(),
            ]))
            w = c_in if last else c_out
        self.final_res_block = res(w + dim, dim, time_dim)

        if seperate_all:
            self.bbox_hidden2output = _MLPDec(dim, self.bbox_dim, exact_gelu, dt, dev)
            self.class_hidden2output = _MLPDec(dim, class_dim, exact_gelu, dt, dev)
            if objectness_dim > 0:
                self.objectness_hidden2output = _MLPDec(dim, objectness_dim, exact_gelu, dt, dev)
            if objfeat_dim > 0:
                self.objfeat_hidden2output = _MLPDec(dim, objfeat_dim, exact_gelu, dt, dev)
        else:
            self.final_conv = Conv1x1(dim, out_dim if out_dim is not None else channels,
                                      dtype=dt, device=dev)
        for m in self.modules():
            if isinstance(m, WSConv1x1):
                m.fast_vjp = ws_fast_vjp

    @property
    def bbox_dim(self) -> int:
        return self.translation_dim + self.size_dim + self.angle_dim

    def forward(self, x, beta, context=None, context_cross=None):
        """x (B, N, point_dim), beta (B,) integer timesteps, context
        (B, N, context_dim + instanclass_dim), context_cross (B, L, text_dim)
        text tokens (text models) -> (B, N, out) float32."""
        dt = self.compute_dtype
        x = x.to(dt)
        if context is not None:
            context = context.to(dt)
        if self.text_condition:
            context_cross = context_cross.to(dt)

        if self.seperate_all:
            bd = self.bbox_dim
            h = self.bbox_embedf(x[..., :bd]) + self.class_embedf(x[..., bd: bd + self.class_dim])
            ofs = bd + self.class_dim
            if self.objectness_dim > 0:
                h = h + self.objectness_embedf(x[..., ofs: ofs + self.objectness_dim])
                ofs += self.objectness_dim
            if self.objfeat_dim > 0:
                h = h + self.objfeat_embedf(x[..., ofs: ofs + self.objfeat_dim])
            x = h
        x = self.init_conv(x)
        r = x
        t_feat = (sinusoidal_pos_emb(beta, self.dim) if self.sinu_pos_emb is None
                  else self.sinu_pos_emb(beta))
        t_emb = self.time_mlp(t_feat)

        skips = []
        for block0, block1, cross, block2, attn, proj in self.downs:
            x = block0(x, context)
            x = block1(x, t_emb)
            skips.append(x)
            if self.text_condition:
                x = cross(x, context_cross)
            x = block2(x, t_emb)
            x = attn(x)
            skips.append(x)
            x = proj(x)

        x = self.mid_block0(x, context)
        x = self.mid_block1(x, t_emb)
        if self.text_condition:
            x = self.mid_attn_cross(x, context_cross)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t_emb)

        for block0, block1, cross, block2, attn, proj in self.ups:
            x = block0(x, context)
            x = block1(torch.cat([x, skips.pop()], dim=-1), t_emb)
            if self.text_condition:
                x = cross(x, context_cross)
            x = block2(torch.cat([x, skips.pop()], dim=-1), t_emb)
            x = attn(x)
            x = proj(x)

        x = self.final_res_block(torch.cat([x, r], dim=-1), t_emb)

        if self.seperate_all:
            outs = [self.bbox_hidden2output(x), self.class_hidden2output(x)]
            if self.objectness_dim > 0:
                outs.append(self.objectness_hidden2output(x))
            if self.objfeat_dim > 0:
                outs.append(self.objfeat_hidden2output(x))
            out = torch.cat(outs, dim=-1)
        else:
            out = self.final_conv(x)
        return out.float()


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (a CPU generator, so a seed gives the
    same weights on every device): matmul weights N(0, 1/fan_in), biases 0,
    norm scales 1 (the flax initializers, without truncation)."""
    for m in module.modules():
        if isinstance(m, (Conv1x1, Linear)):
            fan_in = m.weight.shape[1]
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ChannelLayerNorm):
            m.g.fill_(1.0)
        elif isinstance(m, RandomOrLearnedSinusoidalPosEmb):
            m.weights.copy_(torch.randn(m.weights.shape, generator=generator))
