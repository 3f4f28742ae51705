"""Pre-norm full set attention with its residual, per scene.

Port of ``diffuscene_tpu/ops/attention.py``.  :func:`fused_set_attention`
computes the reference's ``Residual(PreNorm(Attention))`` block
(denoise_net.py:237-259 + 93-123) over the N <= 24 objects of each scene:

    out = x + W_out softmax(q k^T / sqrt(d)) v + b_out,   q, k, v = W_qkv LN(x)

with the roundings of the Pallas kernel ``_attn_kernel``: x is promoted to
f32; the LayerNorm is two-pass (the variance around the mean), scale only,
with the given ``eps``; LN(x) is cast to w_qkv's dtype and the product
accumulates in f32; q is scaled by d^-1/2 after the product; the softmax
runs in f32 per head; the head outputs are cast to w_out's dtype, then
``+ b_out`` in f32, and ``x + y`` is cast to x's dtype.  The model's own
pre-norm is one-pass with an eps chosen by the activation dtype
(``ChannelLayerNorm``): the two agree in f32, and the serving engine passes
the model's eps.

:func:`fused_set_attention` sends CUDA tensors to the hand-written kernel in
``csrc/set_attention.cu`` and CPU tensors to
:func:`fused_set_attention_reference`.  It never falls back: a CUDA tensor
the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fused_level import pack_mma_weights

CSRC = build.CSRC_DIR / "set_attention.cu"
MAX_N = 24        # objects per scene (kMaxN)


def fused_set_attention_reference(
    x: torch.Tensor,          # (B, N, C)
    g_prenorm: torch.Tensor,  # (C,)
    w_qkv: torch.Tensor,      # (C, 3 * heads * dim_head)
    w_out: torch.Tensor,      # (heads * dim_head, C)
    b_out: torch.Tensor,      # (C,)
    heads: int = 4,
    dim_head: int = 32,
    eps: float = 1e-5,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """x + Attention(LN(x)) in plain torch ops, with B2's roundings."""
    B, N, C = x.shape
    H, D = heads, dim_head
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + eps) * g_prenorm.float()
    qkv = ln.to(compute_dtype).float() @ w_qkv.to(compute_dtype).float()
    q, k, v = (a.reshape(B, N, H, D) for a in qkv.chunk(3, dim=-1))
    sim = torch.einsum("bihd,bjhd->bhij", q * D ** -0.5, k)
    attn = torch.softmax(sim, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, N, H * D)
    y = o.to(compute_dtype).float() @ w_out.to(compute_dtype).float() + b_out.float()
    return (xf + y).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/set_attention.cu`` for sm_90a (unless this source was
    built already, see ``ops/build.py``) and load it."""
    lib = build.load(CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.set_attention_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         ctypes.c_float, vp]
    lib.set_attention_launch.restype = ci
    lib.set_attention_max_n.restype = ci
    if lib.set_attention_max_n() != MAX_N:
        raise RuntimeError("csrc/set_attention.cu and ops/attention.py disagree on MAX_N")
    return lib


def _kernel_weight(w: torch.Tensor, dt) -> torch.Tensor:
    """(in, out) weight as the kernel reads it: f32 as is, bf16 packed."""
    w = w.to(dt)
    return w.contiguous() if dt == torch.float32 else pack_mma_weights(w[None]).reshape(-1)


def _launch_kernel(x, g, w_qkv, w_out, b_out, heads, dim_head, eps, dt) -> torch.Tensor:
    B, N, C = x.shape
    hd = heads * dim_head
    if x.dtype != dt or dt not in build.DTYPE_CODES:
        raise ValueError(f"the set-attention kernel takes x in the compute dtype, float32 or "
                         f"bfloat16; got x {x.dtype}, compute dtype {dt}")
    if N > MAX_N or C % 16 or hd % 16:
        raise ValueError(f"the set-attention kernel takes N <= {MAX_N} and C, heads * dim_head "
                         f"multiples of 16; got N={N}, C={C}, {heads} x {dim_head}")
    dev = x.device
    build.check_operand("x", x, dev, dt, (B, N, C))
    Wqkv, Wout, V = build.prepared(b_out, (g, w_qkv, w_out), lambda: (
        _kernel_weight(w_qkv, dt), _kernel_weight(w_out, dt),
        torch.stack([g.float(), b_out.float()])), key=dt)
    for name, w in (("w_qkv", Wqkv), ("w_out", Wout), ("g, b_out", V)):
        if w.device != dev or w.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on {dev}")
    out = torch.empty_like(x)
    rc = load_library().set_attention_launch(
        build.DTYPE_CODES[dt], x.data_ptr(), V[0].data_ptr(), Wqkv.data_ptr(), Wout.data_ptr(),
        V[1].data_ptr(), out.data_ptr(), B, N, C, heads, dim_head, eps,
        build.stream_ptr(dev),
    )
    if rc != 0:
        raise RuntimeError(f"set_attention_launch failed with code {rc}")
    return out


def fused_set_attention(
    x: torch.Tensor,          # (B, N, C)
    g_prenorm: torch.Tensor,  # (C,) pre-norm LayerNorm scale
    w_qkv: torch.Tensor,      # (C, 3 * heads * dim_head)
    w_out: torch.Tensor,      # (heads * dim_head, C)
    b_out: torch.Tensor,      # (C,)
    heads: int = 4,
    dim_head: int = 32,
    eps: float = 1e-5,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """x + Attention(LN(x)) per scene: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``fused_set_attention.launches`` counts
    the kernel launches."""
    B, N, C = x.shape
    hd = heads * dim_head
    if tuple(g_prenorm.shape) != (C,) or tuple(b_out.shape) != (C,):
        raise ValueError(f"g_prenorm and b_out must be ({C},)")
    if tuple(w_qkv.shape) != (C, 3 * hd) or tuple(w_out.shape) != (hd, C):
        raise ValueError(f"w_qkv must be ({C}, {3 * hd}) and w_out ({hd}, {C})")
    args = (x, g_prenorm, w_qkv, w_out, b_out, heads, dim_head, eps)
    if x.device.type == "cpu":
        return fused_set_attention_reference(*args, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_set_attention runs on cpu or cuda tensors, got {x.device}")
    out = _launch_kernel(*args, compute_dtype)
    fused_set_attention.launches += 1
    return out


fused_set_attention.launches = 0
