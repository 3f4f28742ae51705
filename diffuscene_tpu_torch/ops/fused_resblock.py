"""One ResnetBlock on flat (M, C_in) rows, and weight standardization.

Port of ``diffuscene_tpu/ops/fused_resblock.py``.  :func:`fused_resnet_block`
computes one ResnetBlock (denoise_net.py:178-206 semantics):

    h   = silu(GN(x @ w1 + b1) * (film_scale + 1) + film_shift)
    h   = silu(GN(h @ w2 + b2))
    out = h + (x  or  x @ w_res + b_res)

with the roundings of the Pallas kernel ``_resblock_kernel``: the products
accumulate in f32, the GroupNorm takes one-pass f32 moments
E[h^2] - E[h]^2 over each scene's N rows and the group's channels (no
rounding of h before them, no clamp), FiLM and SiLU run in f32, h is cast to
the compute dtype only as the second product's operand, and the sum is cast
to x's dtype at the end.  These are not the 3-D engine's nor the chain
kernel's roundings, which round each dense output first.

Two input forms beside B1's own:

- ``film`` may be per scene, (B, 2C), read at row ``r // n_per_scene``, so a
  caller need not copy a scene's time-FiLM row to its N objects; ``None``
  means zero film rows (exact: h * 1 + 0 == h);
- ``skip`` is the second half of a skip-concat input [x | skip]; ``w1`` and
  ``w_res`` keep their (C_x + C_skip, C) shape and the kernel splits them.

:func:`fused_resnet_block` sends CUDA tensors to the hand-written kernel in
``csrc/fused_resblock.cu`` and CPU tensors to
:func:`fused_resnet_block_reference`, which builds the expanded film rows and
the concatenation explicitly.  It never falls back: a CUDA tensor the kernel
cannot take raises.

The kernels are cluster kernels for Hopper: a tile of whole scenes (at most
``TILE_ROWS`` rows, the wgmma M) is one cluster of CTAs, each owning 64 or
128 output columns.  Both dtypes take one set (:func:`takes`): C = 256, 512
or 1024 in 4, 8, 16 or 32 groups of at least 16 channels, x and skip widths
of multiples of 64 up to 2048 together, scenes of at most 64 rows.  Within
it :func:`kernel_name` routes a block: C = 512 in 8 groups to the
cluster-of-8 kernels (``resblock_sm90``, bf16, where its whole x tile fits:
inputs of a multiple of 128 columns up to 1024 and an identity residual
over x alone; ``resblock_tf32``, f32), every other block to the dtype's
wide kernel (``resblock_bf16_wide``, ``resblock_tf32_wide``; one body, A
fragments from L2, h through a device scratch).  The f32 kernels run their
products in split TF32: three tf32 products per f32 product, never one.
:func:`tile_plan` is each kernel's launch and shared-memory plan, and
:func:`pack_group_tiles` (bf16; ``permuted`` for the wide kernel) and
:func:`pack_tf32_tiles` (f32, split into tf32 hi and lo) the weight layouts
their bulk copies read.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

CSRC = build.CSRC_DIR / "fused_resblock.cu"
# the cluster kernels (csrc/fused_resblock.cu, csrc/sm90.cuh)
TILE_ROWS = 64     # rows of a scene tile: the wgmma M (kTileRows), the most of one scene
# the set both dtypes take: widths, GroupNorm groups, the fewest channels a
# group, x and skip widths together (kMaxIn)
SET_CHANNELS = (256, 512, 1024)
SET_GROUPS = (4, 8, 16, 32)
MIN_GROUP = 16
MAX_IN = 2048
MAX_IN_90 = 1024   # resblock_sm90's inputs (kMaxIn90: its x tile sits whole)
CLUSTER = 8        # the C=512 kernels (and B4): CTAs of a tile's cluster, one per group
CHANNELS = 512     # their C, so 64 columns per group
K_TILE = 64        # depth of one weight chunk
CHUNK_BYTES = K_TILE * (CHANNELS // CLUSTER) * 2      # a bf16 weight chunk (64 deep)
F32_STEP = 32                                         # depth of an f32 weight chunk
F32_CHUNK_BYTES = 2 * F32_STEP * (CHANNELS // CLUSTER) * 4   # its tf32 hi and lo
WIDE_STAGES = 4    # the wide kernels' ring (kStagesW)
SMEM_LIMIT = 232448    # dynamic shared memory one CTA may use on an H100


class TilePlan(NamedTuple):
    scenes_per_tile: int
    clusters: int
    ctas: int
    stages: int         # weight chunks in flight in a CTA's ring
    smem_bytes: int     # dynamic shared memory of one CTA


def takes(C: int, groups: int, kx: int, ks: int = 0, n: int = 1) -> bool:
    """Whether the kernels (either dtype) take a block of C channels in
    ``groups`` GroupNorm groups, [x | skip] inputs of kx + ks columns and
    scenes of n rows: C in SET_CHANNELS, groups in SET_GROUPS with at least
    MIN_GROUP channels each, kx and ks multiples of 64 (kx > 0) up to
    MAX_IN together, n <= 64."""
    return (C in SET_CHANNELS and groups in SET_GROUPS and C // groups >= MIN_GROUP
            and kx > 0 and not kx % K_TILE and not ks % K_TILE
            and kx + ks <= MAX_IN and 1 <= n <= TILE_ROWS)


def kernel_name(dt, C: int, groups: int, kx: int, ks: int = 0, has_res: bool = True) -> str:
    """The kernel of a block of the set in ``dt``: at C = 512 in 8 groups
    with a residual projection or an identity residual over x alone the
    cluster-of-8 kernel (bf16 ``resblock_sm90`` only where its whole x tile
    fits: inputs of a multiple of 128 columns up to 1024; f32
    ``resblock_tf32``), else the dtype's wide kernel (the library's
    ``cluster8``)."""
    kin = kx + ks
    if C == CHANNELS and groups == CLUSTER and (has_res or not ks):
        if dt == torch.float32:
            return "resblock_tf32"
        if not kin % (2 * K_TILE) and kin <= MAX_IN_90:
            return "resblock_sm90"
    return "resblock_tf32_wide" if dt == torch.float32 else "resblock_bf16_wide"


def wide_warpgroups(C: int) -> int:
    """Consumer warpgroups (64 output columns each) of a wide-kernel CTA: 2
    at C = 1024, else 1, so a cluster is 4 or 8 CTAs."""
    return 2 if C > 512 else 1


def wide_smem_bytes(wg: int, dtype, vectors: int = 7) -> int:
    """Dynamic shared memory of one CTA of a wide kernel (B1's, or B4's with
    14 vectors) with ``wg`` consumer warpgroups in ``dtype``, mirroring
    ``layout_wide`` in csrc/sm90.cuh: the weight ring (WIDE_STAGES stages of
    one chunk a warpgroup: a 32-deep split f32 chunk of 16 KB, or a 64-deep
    bf16 chunk of 8 KB), the CTA's columns of the vectors, each row's sums
    and squares in 8-column blocks, each scene's partial sums and its mean
    and rsqrt for up to 4 groups a warpgroup (float2), 8 mbarriers."""
    chunk = F32_CHUNK_BYTES if dtype == torch.float32 else CHUNK_BYTES
    group, rows = CHANNELS // CLUSTER, TILE_ROWS
    return (WIDE_STAGES * wg * chunk + vectors * wg * group * 4 + 2 * wg * rows * 8 * 4
            + 2 * wg * 4 * rows * 8 + 2 * WIDE_STAGES * 8)


def tile_plan(B: int, n: int, kx: int, ks: int = 0, dtype=torch.bfloat16, C: int = CHANNELS,
              groups: int = CLUSTER, has_res: Optional[bool] = None) -> TilePlan:
    """The launch of the kernel that takes the block (C channels in
    ``groups`` groups, [x | skip] inputs of kx + ks columns, a residual
    projection when ``has_res``, by default when kx + ks != C) in
    ``dtype`` (:func:`kernel_name`) for B scenes of n rows; its
    shared-memory sum mirrors ``layout()`` (resblock_sm90),
    ``layout_tf32()`` (resblock_tf32) or ``layout_wide()`` (the wide
    kernels) in the .cu (``fused_resblock_smem_bytes``).

    resblock_sm90: the weight ring (4 stages, 8 past 512 input columns),
    the [x | skip] tile (64 rows, padded by 8; later the gathered (64, 512)
    h), the CTA's 64 columns of the 7 vectors, row sums and squares, scene
    moments, 25 mbarriers (the ring's full and empty ones, the x tile's, one
    for each CTA's slice of the gathered h).

    resblock_tf32 (the same for every width): the weight ring (5 stages of
    a 32-deep chunk's tf32 hi and lo, 16 KB), 8 slots of 64 rows x 64
    columns (rows 68 floats apart) that hold the [x | skip] tile's K tiles
    in turn and then the slices of the gathered (64, 512) h, the vectors,
    row sums and squares, scene moments, 34 mbarriers (the ring's full and
    empty ones, the slots' full and empty ones, one for each CTA's slice of
    h).

    resblock_tf32_wide and resblock_bf16_wide (one or two consumer
    warpgroups, :func:`wide_warpgroups`; a cluster of C / 64 / warpgroups
    CTAs): :func:`wide_smem_bytes` with the 7 vectors."""
    kin = kx + ks
    group = CHANNELS // CLUSTER
    rows = TILE_ROWS
    if has_res is None:
        has_res = kin != C
    kernel = kernel_name(dtype, C, groups, kx, ks, has_res)
    ctas = CLUSTER
    if kernel.endswith("_wide"):
        wg = wide_warpgroups(C)
        stages = WIDE_STAGES
        smem = wide_smem_bytes(wg, dtype)
        ctas = C // (group * wg)
    elif kernel == "resblock_tf32":
        stages = 5
        smem = (stages * F32_CHUNK_BYTES + CLUSTER * rows * (group + 4) * 4 + 7 * group * 4
                + 2 * rows * 4 + 2 * rows * 4 + (2 * stages + 3 * CLUSTER) * 8)
    else:
        stages = 4 if kin <= CHANNELS else 8
        smem = (stages * CHUNK_BYTES + rows * (max(kin, CHANNELS) + 8) * 2 + 7 * group * 4
                + 2 * rows * 4 + 2 * rows * 4 + (2 * 8 + 1 + CLUSTER) * 8)
    ts = rows // n
    tiles = -(-B // ts)
    return TilePlan(ts, tiles, ctas * tiles, stages, smem)


def _check_chunked(w: torch.Tensor, name: str) -> None:
    K, C = w.shape
    if K % K_TILE or C not in SET_CHANNELS:
        raise ValueError(f"{name} takes ({K_TILE}k, C) weights with C in {SET_CHANNELS}, "
                         f"got {(K, C)}")


def pack_group_tiles(w: torch.Tensor, permuted: bool = False) -> torch.Tensor:
    """A (K, C) (in, out) weight, C in SET_CHANNELS, as the bf16 kernels'
    chunks, flat: chunk (g, kt) holds rows [64 kt, 64 kt + 64) of the 64
    columns [64 g, 64 g + 64) (a GroupNorm group's in resblock_sm90; a CTA's,
    or one warpgroup's of it, in the wide kernel), 4096 elements from (g *
    K / 64 + kt) * 4096, in the wgmma no-swizzle core-matrix layout of
    csrc/sm90.cuh: (k, n) of the chunk at ((k // 8) * 8 + n // 8) * 64 + (n
    % 8) * 8 + k % 8.  ``permuted`` (resblock_bf16_wide, which reads its A
    fragments from device memory, ``load_a_global_bf16``): the chunk's k =
    16 j + 8 h + 2 t + e holds row 16 t + 4 j + 2 h + e of the K tile, so
    that each thread's fragments are 16 contiguous columns.  With K = kx +
    ks and kx a multiple of 64, the first kx / 64 chunks of a column block
    are its x rows and the rest its skip rows.  Done once per weight set."""
    _check_chunked(w, "pack_group_tiles")
    K, C = w.shape
    if permuted:   # (kt, t, j, h, e) -> (kt, j, h, t, e)
        w = w.reshape(K // 64, 4, 4, 2, 2, C).permute(0, 2, 3, 1, 4, 5).reshape(K, C)
    G = C // 64
    # (kt, kb, k8, g, nb, n8) -> (g, kt, kb, nb, n8, k8)
    return w.reshape(K // 64, 8, 8, G, 8, 8).permute(3, 0, 1, 4, 5, 2).contiguous().reshape(-1)


def pack_tf32_tiles(w: torch.Tensor) -> torch.Tensor:
    """A (K, C) (in, out) f32 weight, C in SET_CHANNELS, as the f32
    kernels' chunks, flat: chunk (g, st) holds rows [32 st, 32 st + 32) of
    the 64 columns [64 g, 64 g + 64) (a GroupNorm group's at C = 512 in 8
    groups; a CTA's, or one warpgroup's of it, in the wide kernel), 4096
    values from (g * K / 32 + st) * 4096: their tf32 hi
    parts (:func:`tf32_split`), then their lo parts, each in the wgmma
    no-swizzle K-major core-matrix layout of tf32 (core matrices of 8
    columns x 4 k, 128 bytes apart in n and 1024 in k): (kappa, n) at
    ((kappa // 4) * 8 + n // 8) * 32 + (n % 8) * 4 + kappa % 4.  The step's
    k is permuted so that each consumer thread reads its A fragments as
    contiguous columns (``load_a`` in the .cu): kappa = 8 j + t + 4 h holds
    row 32 st + 8 t + 2 j + h.  Done once per weight set."""
    _check_chunked(w, "pack_tf32_tiles")
    K, C = w.shape

    def part(v):   # (st, t, j, h, g, nb, n8) -> (g, st, j, h, nb, n8, t)
        return v.reshape(K // F32_STEP, 4, 4, 2, C // 64, 8, 8).permute(4, 0, 2, 3, 5, 6, 1)

    hi, lo = tf32_split(w.float().contiguous())
    return torch.stack([part(hi), part(lo)], dim=2).contiguous().reshape(-1)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's split of a finite f32 tensor into two tf32 parts, in
    plain torch (``tf32_split`` in csrc/sm90.cuh): hi is v rounded to tf32,
    to nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds
    (half of the 13 dropped mantissa bits' range added to the bits, then
    those bits cleared), and lo is v - hi rounded the same way.  The kernel
    forms each f32 product as hi*hi + hi*lo + lo*hi."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def standardize_kernel(kernel: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Weight standardization over the input axis of an (in, out) kernel
    (WSDense semantics, models/denoiser.py): per output unit, biased mean and
    variance over the inputs.  Precomputed once per sampling call."""
    mean = kernel.mean(dim=0, keepdim=True)
    var = kernel.var(dim=0, unbiased=False, keepdim=True)
    return (kernel - mean) * torch.rsqrt(var + eps)


def _film_rows(film: torch.Tensor, M: int, n: int) -> torch.Tensor:
    """(M, 2C) film rows from per-row (M, 2C) or per-scene (M // n, 2C) rows."""
    return film if film.shape[0] == M else film.repeat_interleave(n, dim=0)


def fused_resnet_block_reference(
    x: torch.Tensor,                        # (M, C_x)
    film: Optional[torch.Tensor],           # (M, 2C) | (M // n, 2C) | None
    w1: torch.Tensor,                       # (C_x [+ C_skip], C) pre-standardized
    b1: torch.Tensor,
    gn1_scale: torch.Tensor, gn1_bias: torch.Tensor,
    w2: torch.Tensor,                       # (C, C) pre-standardized
    b2: torch.Tensor,
    gn2_scale: torch.Tensor, gn2_bias: torch.Tensor,
    w_res: Optional[torch.Tensor] = None,   # (C_x [+ C_skip], C)
    b_res: Optional[torch.Tensor] = None,
    n_per_scene: int = 1,
    groups: int = 8,
    eps: float = 1e-6,
    compute_dtype=torch.bfloat16,
    skip: Optional[torch.Tensor] = None,    # (M, C_skip)
) -> torch.Tensor:
    """The block in plain torch ops, with B1's roundings (module docstring)."""
    dt = x.dtype
    xin = x if skip is None else torch.cat([x, skip], dim=-1)
    M, C = xin.shape[0], w1.shape[-1]
    n = n_per_scene
    B = M // n

    def dense(a, w, b):
        out = a.float() @ w.to(compute_dtype).float()
        return out if b is None else out + b.float()

    def groupnorm(h, scale, bias):
        hg = h.reshape(B, n, groups, C // groups)
        mean = hg.mean(dim=(1, 3), keepdim=True)
        e2 = (hg * hg).mean(dim=(1, 3), keepdim=True)
        inv = torch.rsqrt(e2 - mean * mean + eps)
        return ((hg - mean) * inv).reshape(M, C) * scale.float() + bias.float()

    h = groupnorm(dense(xin, w1, b1), gn1_scale, gn1_bias)
    if film is not None:
        f = _film_rows(film, M, n).to(dt)
        h = h * (f[:, :C] + 1).float() + f[:, C:].float()
    h = F.silu(h)
    h = F.silu(groupnorm(dense(h.to(compute_dtype), w2, b2), gn2_scale, gn2_bias))
    res = xin.float()[:, :C] if w_res is None else dense(xin, w_res, b_res)
    return (h + res).to(dt)


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/fused_resblock.cu`` for sm_90a (unless this source was
    built already, see ``ops/build.py``), load it, and check its limits
    against this module's."""
    lib = build.load(CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_resblock_launch.argtypes = [
        ci, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp,
    ]
    lib.fused_resblock_launch.restype = ci
    for fn, args in ((lib.fused_resblock_max_rows, []), (lib.fused_resblock_max_in, []),
                     (lib.fused_resblock_smem_bytes, [ci] * 6),
                     (lib.fused_resblock_max_active_clusters, [ci] * 6)):
        fn.argtypes, fn.restype = args, ci
    shapes = [(dt, code, C, groups, kx, ks) for dt, code in build.DTYPE_CODES.items()
              for C, groups, kx, ks in (
                  (512, 8, 512, 0), (512, 8, 1024, 0), (512, 8, 512, 512), (256, 8, 256, 0),
                  (512, 4, 512, 0), (512, 8, 256, 256), (512, 8, 576, 0), (1024, 8, 1024, 1024))]
    if (lib.fused_resblock_max_rows(), lib.fused_resblock_max_in()) != (TILE_ROWS, MAX_IN) or any(
            lib.fused_resblock_smem_bytes(code, C, groups, kx, ks, int(kx + ks != C))
            != tile_plan(1, 1, kx, ks, dt, C, groups).smem_bytes
            for dt, code, C, groups, kx, ks in shapes):
        raise RuntimeError("csrc/fused_resblock.cu and ops/fused_resblock.py disagree on limits")
    return lib


def check_kernel_shapes(C: int, groups: int, kx: int, ks: int, n: int, has_res: bool,
                        dt) -> None:
    """Raise ``ValueError`` unless the kernels take the block (the
    library's ``-1``): float32 or bfloat16, and the set of :func:`takes`,
    the same for both dtypes."""
    if dt not in build.DTYPE_CODES:
        raise ValueError(f"the resblock kernel takes float32 or bfloat16, got {dt}")
    if not takes(C, groups, kx, ks, n):
        raise ValueError(
            f"the resblock kernel takes C in {SET_CHANNELS} in {SET_GROUPS} groups of at least "
            f"{MIN_GROUP} channels, input widths of multiples of {K_TILE} up to {MAX_IN} "
            f"together and at most {TILE_ROWS} rows per scene; got C={C}, groups={groups}, "
            f"C_x={kx}, C_skip={ks}, N={n}")


def _kernel_weights(w: Optional[torch.Tensor], dt, kernel: str) -> Optional[torch.Tensor]:
    """An (in, out) weight as ``kernel`` reads it: :func:`pack_tf32_tiles`
    (f32) or :func:`pack_group_tiles` (bf16, ``permuted`` for the wide
    kernel) chunks."""
    if w is None:
        return None
    w = w.to(dt)
    if dt == torch.float32:
        return pack_tf32_tiles(w)
    return pack_group_tiles(w, permuted=kernel == "resblock_bf16_wide")


def kernel_operands(w1, b1, g1s, g1b, w2, b2, g2s, g2b, w_res, b_res, dt, kernel: str):
    """The block's operands for ``kernel`` in ``dt``: its packed weights
    (W1, W2, Wres or None) and its 7 vectors (b1, the GN1 scale and bias,
    b2, the GN2 scale and bias, b_res) in f32, with their device and data
    pointers; made once per weight set and dtype and kept on b1
    (``build.prepared``; the kernel follows from the weights' shapes)."""
    C = w1.shape[-1]

    def make():
        ops = (_kernel_weights(w1, dt, kernel), _kernel_weights(w2, dt, kernel),
               _kernel_weights(w_res, dt, kernel),
               torch.stack([v.float() for v in (b1, g1s, g1b, b2, g2s, g2b,
                                                 b1.new_zeros(C) if b_res is None else b_res)]))
        for name, w in zip(("w1", "w2", "w_res", "vectors"), ops):
            if w is not None and w.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        return ops, ops[3].device, tuple(None if w is None else w.data_ptr() for w in ops)

    return build.prepared(b1, (w1, g1s, g1b, w2, b2, g2s, g2b, w_res, b_res), make, key=dt)


def _launch_kernel(x, skip, film, w1, b1, g1s, g1b, w2, b2, g2s, g2b, w_res, b_res,
                   n: int, groups: int, eps: float, dt) -> torch.Tensor:
    M, kx = x.shape
    ks = 0 if skip is None else skip.shape[1]
    C = w1.shape[-1]
    if x.dtype != dt or dt not in build.DTYPE_CODES:
        raise ValueError(f"the resblock kernel takes x in the compute dtype, float32 or "
                         f"bfloat16; got x {x.dtype}, compute dtype {dt}")
    check_kernel_shapes(C, groups, kx, ks, n, w_res is not None, dt)
    dev = x.device
    build.check_operand("x", x, dev, dt, (M, kx))
    if skip is not None:
        build.check_operand("skip", skip, dev, dt, (M, ks))
    film_kind = 0
    if film is not None:
        if film.dtype != dt:
            film = film.to(dt)
        build.check_operand("film", film, dev, dt, film.shape)
        film_kind = 2 if film.shape[0] == M else 1
    kernel = kernel_name(dt, C, groups, kx, ks, w_res is not None)
    _, wdev, (w1p, w2p, wresp, vp) = kernel_operands(w1, b1, g1s, g1b, w2, b2, g2s, g2b, w_res,
                                                     b_res, dt, kernel)
    if wdev != dev:
        raise ValueError(f"the weights are on {wdev}, x on {dev}")
    out = x.new_empty((M, C))
    # the wide kernels' block1 output goes through device memory
    h = x.new_empty((M, C)) if kernel.endswith("_wide") else None
    rc = load_library().fused_resblock_launch(
        build.DTYPE_CODES[dt], x.data_ptr(), None if skip is None else skip.data_ptr(),
        None if film is None else film.data_ptr(), film_kind, w1p, w2p, wresp, vp,
        None if h is None else h.data_ptr(), out.data_ptr(),
        M // n, n, C, kx, ks, groups, eps, build.stream_ptr(dev),
    )
    if rc != 0:
        raise RuntimeError(f"fused_resblock_launch failed with code {rc}")
    build.count_launch(fused_resnet_block, kernel)
    return out


def fused_resnet_block(
    x: torch.Tensor,                        # (M, C_x)
    film: Optional[torch.Tensor],           # (M, 2C) | (M // n, 2C) | None (zero film)
    w1: torch.Tensor,                       # (C_x [+ C_skip], C) pre-standardized
    b1: torch.Tensor,
    gn1_scale: torch.Tensor, gn1_bias: torch.Tensor,
    w2: torch.Tensor,                       # (C, C) pre-standardized
    b2: torch.Tensor,
    gn2_scale: torch.Tensor, gn2_bias: torch.Tensor,
    w_res: Optional[torch.Tensor] = None,   # (C_x [+ C_skip], C) when C_in != C
    b_res: Optional[torch.Tensor] = None,
    n_per_scene: int = 1,
    groups: int = 8,
    eps: float = 1e-6,
    compute_dtype=torch.bfloat16,
    skip: Optional[torch.Tensor] = None,    # (M, C_skip): the input is [x | skip]
) -> torch.Tensor:
    """One ResnetBlock over all rows: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Any number of whole scenes works (the
    kernel masks a ragged last tile).  ``fused_resnet_block.launches`` counts
    the kernel launches, ``fused_resnet_block.by_kernel`` them by kernel
    name (:func:`kernel_name`).  They count the launches the card runs: a call
    captured into a CUDA graph counts nothing itself, and each replay of the
    graph adds its launches (``build.count_launch``)."""
    M = x.shape[0]
    n = n_per_scene
    C = w1.shape[-1]
    c_in = x.shape[1] + (0 if skip is None else skip.shape[1])
    if M % n:
        raise ValueError(f"{M} rows are not whole scenes of {n}")
    if skip is not None and skip.shape[0] != M:
        raise ValueError(f"skip has {skip.shape[0]} rows, x {M}")
    if w1.shape[0] != c_in or (w_res is not None and tuple(w_res.shape) != (c_in, C)):
        raise ValueError(f"w1 / w_res must be ({c_in}, {C})")
    if w_res is None and c_in != C:
        raise ValueError(f"an identity residual needs C_in == C, got {c_in} and {C}")
    if film is not None and (film.shape[-1] != 2 * C or film.shape[0] not in (M, M // n)):
        raise ValueError(f"film has shape {tuple(film.shape)}, expected ({M} or {M // n}, {2 * C})")
    args = (x, film, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale, gn2_bias, w_res, b_res)
    if x.is_cpu:
        return fused_resnet_block_reference(*args, n_per_scene=n, groups=groups, eps=eps,
                                            compute_dtype=compute_dtype, skip=skip)
    if not x.is_cuda:
        raise ValueError(f"fused_resnet_block runs on cpu or cuda tensors, got {x.device}")
    return _launch_kernel(x, skip, *args[1:], n, groups, eps, compute_dtype)


fused_resnet_block.launches = 0
fused_resnet_block.by_kernel = {}
