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

The bf16 kernel is a cluster kernel for Hopper: a tile of whole scenes (at
most ``TILE_ROWS`` rows) is one cluster of ``HEADS`` CTAs, CTA h owning head
h; it takes C = 512 and 4 heads of 32 only.  :func:`tile_plan` is its launch
and shared-memory plan and :func:`pack_attention_weights` the weight layout
its bulk copies read.  The f32 kernel takes other widths.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .fused_resblock import TILE_ROWS, pack_group_tiles

CSRC = build.CSRC_DIR / "set_attention.cu"
MAX_N = 24        # objects per scene (kMaxN)
# the bf16 cluster kernel (attention_sm90)
CHANNELS, HEADS, DIM_HEAD = 512, 4, 32
K_TILE = 64       # depth of one W_qkv chunk


class TilePlan(NamedTuple):
    scenes_per_tile: int
    tiles: int
    clusters: int       # clusters launched: the tiles, or those resident at once
    ctas: int
    smem_bytes: int     # dynamic shared memory of one CTA


def tile_plan(B: int, n: int, resident: Optional[int] = None) -> TilePlan:
    """The bf16 kernel's launch for B scenes of n rows: tiles of the most
    whole scenes that fit in 64 rows, one cluster of 4 CTAs a tile, at most
    ``resident`` clusters launched (each then walks several tiles).  Its
    shared-memory sum mirrors the .cu (``set_attention_smem_bytes``): 8 W_qkv
    chunks of 64 x 96, the (64, 520) x tile (which later holds q | k | v and
    the probabilities in f32), the (128, 128) W_out block, the gathered
    (64, 136) o, the CTA's 128 of b_out in f32, 14 mbarriers."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the set-attention kernel takes 1 <= N <= {MAX_N}, got {n}")
    ts = TILE_ROWS // n
    tiles = -(-B // ts)
    clusters = tiles if resident is None else min(tiles, resident)
    hd = HEADS * DIM_HEAD
    smem = (CHANNELS * 3 * DIM_HEAD * 2 + TILE_ROWS * (CHANNELS + 8) * 2
            + hd * (CHANNELS // HEADS) * 2 + TILE_ROWS * (hd + 8) * 2 + (CHANNELS // HEADS) * 4
            + (CHANNELS // K_TILE + 2 + HEADS) * 8)
    return TilePlan(ts, tiles, clusters, HEADS * clusters, smem)


def pack_attention_weights(w_qkv: torch.Tensor, w_out: torch.Tensor):
    """The bf16 kernel's weights, flat.  W_qkv (512, 384): for head h and K
    tile kt, a chunk of rows [64 kt, 64 kt + 64) of head h's 96 columns
    [q_h | k_h | v_h] (columns 32h.., 128 + 32h.., 256 + 32h..), 6144
    elements from (h * 8 + kt) * 6144, in the wgmma no-swizzle core-matrix
    layout of csrc/sm90.cuh with 12 core matrices across: (k, n) at
    ((k // 8) * 12 + n // 8) * 64 + (n % 8) * 8 + k % 8.  W_out (128, 512):
    :func:`pack_group_tiles`, so head h's (128, 128) block of output columns
    [128h, 128h + 128) is the 16384 elements from h * 16384.  Done once per
    weight set."""
    K, Q = w_qkv.shape
    hd = HEADS * DIM_HEAD
    if (K, Q) != (CHANNELS, 3 * hd) or tuple(w_out.shape) != (hd, CHANNELS):
        raise ValueError(f"pack_attention_weights takes ({CHANNELS}, {3 * hd}) and ({hd}, "
                         f"{CHANNELS}) weights, got {tuple(w_qkv.shape)}, {tuple(w_out.shape)}")
    # (K, 3, H, D) -> (H, K, 3 * D): head h's columns [q_h | k_h | v_h]
    heads = w_qkv.reshape(K, 3, HEADS, DIM_HEAD).permute(2, 0, 1, 3).reshape(HEADS, K, 3 * DIM_HEAD)
    nb = 3 * DIM_HEAD // 8
    # (h, kt, kb, k8, nb, n8) -> (h, kt, kb, nb, n8, k8)
    qkv = heads.reshape(HEADS, K // K_TILE, 8, 8, nb, 8).permute(0, 1, 2, 4, 5, 3)
    return qkv.contiguous().reshape(-1), pack_group_tiles(w_out)


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
    for fn in (lib.set_attention_max_n, lib.set_attention_smem_bytes,
               lib.set_attention_max_active_clusters):
        fn.argtypes, fn.restype = [], ci
    if (lib.set_attention_max_n(), lib.set_attention_smem_bytes()) != (
            MAX_N, tile_plan(1, 12).smem_bytes):
        raise RuntimeError("csrc/set_attention.cu and ops/attention.py disagree on limits")
    return lib


def _kernel_weights(w_qkv: torch.Tensor, w_out: torch.Tensor, dt):
    """The weights as the kernel reads them: f32 (in, out) as they are, bf16
    packed by :func:`pack_attention_weights`."""
    w_qkv, w_out = w_qkv.to(dt), w_out.to(dt)
    if dt == torch.float32:
        return w_qkv.contiguous(), w_out.contiguous()
    return pack_attention_weights(w_qkv, w_out)


def _launch_kernel(x, g, w_qkv, w_out, b_out, heads, dim_head, eps, dt) -> torch.Tensor:
    B, N, C = x.shape
    hd = heads * dim_head
    if x.dtype != dt or dt not in build.DTYPE_CODES:
        raise ValueError(f"the set-attention kernel takes x in the compute dtype, float32 or "
                         f"bfloat16; got x {x.dtype}, compute dtype {dt}")
    if N > MAX_N or C % 16 or hd % 16:
        raise ValueError(f"the set-attention kernel takes N <= {MAX_N} and C, heads * dim_head "
                         f"multiples of 16; got N={N}, C={C}, {heads} x {dim_head}")
    if dt == torch.bfloat16 and (C, heads, dim_head) != (CHANNELS, HEADS, DIM_HEAD):
        raise ValueError(f"the bf16 set-attention kernel takes C={CHANNELS} and {HEADS} heads "
                         f"of {DIM_HEAD}; got C={C}, {heads} x {dim_head}")
    dev = x.device
    build.check_operand("x", x, dev, dt, (B, N, C))
    Wqkv, Wout, V = build.prepared(b_out, (g, w_qkv, w_out), lambda: (
        *_kernel_weights(w_qkv, w_out, dt), torch.stack([g.float(), b_out.float()])), key=dt)
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
