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

The kernels are cluster kernels for Hopper: a tile of whole scenes (at most
``TILE_ROWS`` rows) is one cluster of ``HEADS`` CTAs, CTA h owning head h.
Both dtypes take one set (:func:`check_kernel_shapes`): 4 heads of 32, N
<= 24, C = 256, 512 or 1024; C = 512 runs ``attention_sm90`` (bf16) or
``attention_tf32`` (f32), C = 256 and 1024 the dtype's wide kernel
(``attention_bf16_wide``, ``attention_tf32_wide``; one body, no x tile).
The f32 kernels run both products in split TF32 (three tf32 products per
f32 product, ``fused_resblock.tf32_split``).  :func:`tile_plan` is each
kernel's launch and shared-memory plan, and :func:`pack_attention_weights`
(bf16) and :func:`pack_attention_weights_tf32` (f32) the weight layouts
their bulk copies read.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .fused_resblock import (F32_STEP, SET_CHANNELS, TILE_ROWS, pack_group_tiles, pack_tf32_tiles,
                             tf32_split)

CSRC = build.CSRC_DIR / "set_attention.cu"
MAX_N = 24        # objects per scene (kMaxN)
# the C of the C = 512 kernels, heads of dim_head; both dtypes take C in
# SET_CHANNELS (fused_resblock's set)
CHANNELS, HEADS, DIM_HEAD = 512, 4, 32
K_TILE = 64       # depth of one bf16 W_qkv chunk
F32_STAGES = 3    # the f32 kernels' ring of split weights, a W_out step (32 KB) a stage;
                  # the bf16 wide kernel's ring, a W_qkv chunk (12 KB) a stage


class TilePlan(NamedTuple):
    scenes_per_tile: int
    tiles: int
    clusters: int       # clusters launched: the tiles, or (bf16) those resident at once
    ctas: int
    smem_bytes: int     # dynamic shared memory of one CTA
    weight_bytes: int   # W_qkv and W_out bytes the CTAs of a call read


def tile_plan(B: int, n: int, resident: Optional[int] = None,
              dtype=torch.bfloat16, C: int = CHANNELS) -> TilePlan:
    """The ``dtype`` kernel's launch for B scenes of n rows of C channels:
    tiles of the most whole scenes that fit in 64 rows, one cluster of 4
    CTAs a tile.  bf16 at C = 512 (attention_sm90): at most ``resident``
    clusters launched, each walking several tiles with its weights loaded
    once; shared memory (``set_attention_smem_bytes``): 8 W_qkv chunks of
    64 x 96, the (64, 520) x tile (which later holds q | k | v and the
    probabilities in f32), the (128, 128) W_out block, the gathered (64,
    136) o, the CTA's 128 of b_out in f32, 14 mbarriers.  f32, and bf16 at
    C = 256 and 1024: one cluster a tile, each CTA streaming its weights
    (f32 split: C / 32 W_qkv steps of 24 KB, W_out's 4 steps of 16 KB for
    each 64 of its C / 4 output columns; bf16: C / 64 W_qkv chunks of 12 KB,
    W_out's 4 steps of 4 KB for each 64 columns).  Shared memory at f32 C =
    512 (attention_tf32): a ring of 3 stages of 32 KB, the (64, 516) f32 x
    tile (which later holds q | k | v, the probabilities and the gathered o
    as 4 slices of (64, 36)), the 128 of b_out, 11 mbarriers; at C = 256
    and 1024 (the wide kernels, no x tile): the ring (3 stages of 32 KB in
    f32, of 12 KB in bf16), q | k | v (64, 100), the probabilities (64,
    25), the gathered o, the LayerNorm scale and b_out (room for C = 1024),
    each row's mean and rstd, 10 mbarriers."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the set-attention kernel takes 1 <= N <= {MAX_N}, got {n}")
    ts = TILE_ROWS // n
    tiles = -(-B // ts)
    hd, cols = HEADS * DIM_HEAD, C // HEADS
    if dtype == torch.float32 or C != CHANNELS:
        if dtype == torch.float32:
            stage = 2 * F32_STEP * (CHANNELS // HEADS) * 4
            per_cta = 2 * C * 3 * DIM_HEAD * 4 + 2 * hd * cols * 4
        else:
            stage = K_TILE * 3 * DIM_HEAD * 2
            per_cta = C * 3 * DIM_HEAD * 2 + hd * cols * 2
        if C == CHANNELS:
            smem = (F32_STAGES * stage + TILE_ROWS * (CHANNELS + 4) * 4 + cols * 4
                    + (2 * F32_STAGES + 1 + HEADS) * 8)
        else:
            cmax = SET_CHANNELS[-1]
            smem = (F32_STAGES * stage + TILE_ROWS * (3 * DIM_HEAD + 4) * 4
                    + TILE_ROWS * (MAX_N + 1) * 4 + HEADS * TILE_ROWS * (DIM_HEAD + 4) * 4
                    + cmax * 4 + cmax // HEADS * 4 + TILE_ROWS * 2 * 4
                    + (2 * F32_STAGES + HEADS) * 8)
        return TilePlan(ts, tiles, tiles, HEADS * tiles, smem, HEADS * tiles * per_cta)
    clusters = tiles if resident is None else min(tiles, resident)
    smem = (CHANNELS * 3 * DIM_HEAD * 2 + TILE_ROWS * (CHANNELS + 8) * 2
            + hd * cols * 2 + TILE_ROWS * (hd + 8) * 2 + cols * 4
            + (CHANNELS // K_TILE + 2 + HEADS) * 8)
    per_cta = CHANNELS * 3 * DIM_HEAD * 2 + hd * cols * 2
    return TilePlan(ts, tiles, clusters, HEADS * clusters, smem, HEADS * clusters * per_cta)


def pack_attention_weights(w_qkv: torch.Tensor, w_out: torch.Tensor, permuted: bool = False):
    """The bf16 kernels' weights, flat.  W_qkv (C, 384), C in SET_CHANNELS:
    for head h and K tile kt, a chunk of rows [64 kt, 64 kt + 64) of head
    h's 96 columns [q_h | k_h | v_h] (columns 32h.., 128 + 32h.., 256 +
    32h..), 6144 elements from (h * C / 64 + kt) * 6144, in the wgmma
    no-swizzle core-matrix layout of csrc/sm90.cuh with 12 core matrices
    across: (k, n) at ((k // 8) * 12 + n // 8) * 64 + (n % 8) * 8 + k % 8;
    ``permuted`` (the wide kernel, which reads LN(x) from device memory)
    with the K tile's rows in the order of
    ``fused_resblock.pack_group_tiles(..., permuted=True)``.  W_out (128,
    C): :func:`pack_group_tiles`, so chunk g's (columns [64 g, 64 g + 64))
    two K tiles are the 8192 elements from g * 8192, and head h's output
    columns are chunks h C / 256 to (h + 1) C / 256 - 1 (at C = 512 its
    (128, 128) block, the 16384 elements from h * 16384).  Done once per
    weight set."""
    K, Q = w_qkv.shape
    hd = HEADS * DIM_HEAD
    if K not in SET_CHANNELS or Q != 3 * hd or tuple(w_out.shape) != (hd, K):
        raise ValueError(f"pack_attention_weights takes (C, {3 * hd}) and ({hd}, C) weights with "
                         f"C in {SET_CHANNELS}, got {tuple(w_qkv.shape)}, {tuple(w_out.shape)}")
    if permuted:   # (kt, t, j, h, e) -> (kt, j, h, t, e), as pack_group_tiles
        w_qkv = w_qkv.reshape(K // 64, 4, 4, 2, 2, Q).permute(0, 2, 3, 1, 4, 5).reshape(K, Q)
    # (K, 3, H, D) -> (H, K, 3 * D): head h's columns [q_h | k_h | v_h]
    heads = w_qkv.reshape(K, 3, HEADS, DIM_HEAD).permute(2, 0, 1, 3).reshape(HEADS, K, 3 * DIM_HEAD)
    nb = 3 * DIM_HEAD // 8
    # (h, kt, kb, k8, nb, n8) -> (h, kt, kb, nb, n8, k8)
    qkv = heads.reshape(HEADS, K // K_TILE, 8, 8, nb, 8).permute(0, 1, 2, 4, 5, 3)
    return qkv.contiguous().reshape(-1), pack_group_tiles(w_out)


def pack_attention_weights_tf32(w_qkv: torch.Tensor, w_out: torch.Tensor):
    """The f32 kernels' weights, flat, each value split into its tf32 hi and
    lo parts (:func:`tf32_split`).  W_qkv (C, 384), C in SET_CHANNELS: for
    head h and 32-deep K step st, rows [32 st, 32 st + 32) of head h's 96
    columns [q_h | k_h | v_h], 6144 values from (h * C / 32 + st) * 6144:
    the hi parts, then the lo
    parts, each in the tf32 K-major core-matrix layout of csrc/sm90.cuh with
    12 core matrices across, (kappa, n) at ((kappa // 4) * 12 + n // 8) * 32
    + (n % 8) * 4 + kappa % 4, the step's k permuted as in
    :func:`pack_tf32_tiles` (kappa = 8 j + t + 4 h holds row 32 st + 8 t +
    2 j + h).  W_out (128, C): :func:`pack_tf32_tiles`, so chunk g's
    (columns [64 g, 64 g + 64)) 4 steps are the 16384 values from g * 16384,
    and head h's output columns are chunks h C / 256 to (h + 1) C / 256 - 1.
    Done once per weight set."""
    K, Q = w_qkv.shape
    hd = HEADS * DIM_HEAD
    if K not in SET_CHANNELS or Q != 3 * hd or tuple(w_out.shape) != (hd, K):
        raise ValueError(f"pack_attention_weights_tf32 takes (C, {3 * hd}) and ({hd}, C) "
                         f"weights with C in {SET_CHANNELS}, got {tuple(w_qkv.shape)}, "
                         f"{tuple(w_out.shape)}")
    heads = w_qkv.float().reshape(K, 3, HEADS, DIM_HEAD).permute(2, 0, 1, 3)
    heads = heads.reshape(HEADS, K, 3 * DIM_HEAD).contiguous()

    def part(v):   # (h, st, t, j, hh, nb, n8) -> (h, st, j, hh, nb, n8, t)
        return v.reshape(HEADS, K // F32_STEP, 4, 4, 2, 3 * DIM_HEAD // 8, 8).permute(
            0, 1, 3, 4, 5, 6, 2)

    hi, lo = tf32_split(heads)
    qkv = torch.stack([part(hi), part(lo)], dim=2).contiguous().reshape(-1)
    return qkv, pack_tf32_tiles(w_out)


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
    for fn in (lib.set_attention_launch, lib.set_attention_launch_wide):
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    lib.set_attention_max_n.argtypes, lib.set_attention_max_n.restype = [], ci
    for fn in (lib.set_attention_smem_bytes, lib.set_attention_max_active_clusters):
        fn.argtypes, fn.restype = [ci, ci], ci
    shapes = [(dt, C) for dt in build.DTYPE_CODES for C in SET_CHANNELS]
    if lib.set_attention_max_n() != MAX_N or any(
            lib.set_attention_smem_bytes(build.DTYPE_CODES[dt], C)
            != tile_plan(1, 12, dtype=dt, C=C).smem_bytes for dt, C in shapes):
        raise RuntimeError("csrc/set_attention.cu and ops/attention.py disagree on limits")
    return lib


def check_kernel_shapes(n: int, C: int, heads: int, dim_head: int, dt) -> None:
    """Raise ``ValueError`` unless the kernels take these shapes (the
    library's ``-1``), one set for both dtypes: x in float32 or bfloat16,
    C in SET_CHANNELS, 4 heads of 32, 1 <= N <= 24.  Every config's
    ``mid_attn`` is 4 x 32."""
    if dt not in build.DTYPE_CODES:
        raise ValueError(f"the set-attention kernel takes float32 or bfloat16, got {dt}")
    if C not in SET_CHANNELS or (heads, dim_head) != (HEADS, DIM_HEAD) or not 1 <= n <= MAX_N:
        raise ValueError(f"the set-attention kernel takes C in {SET_CHANNELS}, {HEADS} heads of "
                         f"{DIM_HEAD} and N <= {MAX_N}; got C={C}, {heads} x {dim_head}, N={n}")


def kernel_name(dt, C: int) -> str:
    """The kernel of a call of the set in ``dt`` at C channels."""
    if C == CHANNELS:
        return "attention_tf32" if dt == torch.float32 else "attention_sm90"
    return "attention_tf32_wide" if dt == torch.float32 else "attention_bf16_wide"


def _kernel_weights(w_qkv: torch.Tensor, w_out: torch.Tensor, dt):
    """The weights as the kernel reads them: bf16 packed by
    :func:`pack_attention_weights` (``permuted`` for the wide kernel, C !=
    512), f32 split and packed by :func:`pack_attention_weights_tf32`."""
    if dt == torch.float32:
        return pack_attention_weights_tf32(w_qkv.float(), w_out.float())
    return pack_attention_weights(w_qkv.to(dt), w_out.to(dt), permuted=w_qkv.shape[0] != CHANNELS)


def _launch_kernel(x, g, w_qkv, w_out, b_out, heads, dim_head, eps, dt) -> torch.Tensor:
    B, N, C = x.shape
    check_kernel_shapes(N, C, heads, dim_head, dt)
    if x.dtype != dt:
        raise ValueError(f"the set-attention kernel takes x in the compute dtype; got x "
                         f"{x.dtype}, compute dtype {dt}")
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
    kernel = kernel_name(dt, C)
    build.count_launch(fused_set_attention, kernel)
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
    the kernel launches, ``fused_set_attention.by_kernel`` them by kernel
    name (:func:`kernel_name`).  They count the launches the card runs: a call
    captured into a CUDA graph counts nothing itself, and each replay of the
    graph adds its launches (``build.count_launch``)."""
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
    return _launch_kernel(*args, compute_dtype)


fused_set_attention.launches = 0
fused_set_attention.by_kernel = {}
