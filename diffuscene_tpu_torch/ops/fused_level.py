"""Whole-level ResnetBlock chains on flat (B*N, C) rows.

Port of ``diffuscene_tpu/ops/fused_level.py``.  The rows engine
(``models/inference.py:fused_unet1d_forward_rows``) runs every ResnetBlock of
the denoiser through :func:`apply_chain`, 19 chains of 1-2 blocks per
forward.  Each block computes

    z   = x @ W1 (+ skip @ W1s) + b1          # f32 accumulate -> compute dtype
    a,b = groupnorm_coeffs(z)                  # per scene, f32 moments
    a,b = film_fold(a, b)                      # "scene" FiLM rows (B, 2C)
    z   = silu(z * a + b)                      # "row" FiLM (M, 2C) before the silu
    z   = z @ W2 + b2
    z   = silu(groupnorm(z))
    out = z + (x | x @ Wres (+ skip @ Wres_s) + bres)

GroupNorm statistics span each scene's N rows and the group's channels (eps
1e-6, the flax default).  Weights arrive standardized and cast.

On the H100, (B, N, C) -> (B*N, C) is a view, so flat rows are the natural
layout here (on the TPU, N=12 padded to 16 sublanes made every such reshape
a copy).

:func:`apply_chain` sends CUDA tensors to the hand-written kernel in
``csrc/fused_chain.cu`` and CPU tensors to :func:`apply_chain_reference`,
the plain torch twin of the JAX ``apply_chain_xla``.  It never falls back:
a CUDA tensor the kernel cannot take raises.

The kernels are B1's cluster kernels carried over a chain: a tile of whole
scenes (at most 64 rows) is one cluster of CTAs, each owning 64 or 128
output columns of every product.  Both dtypes take B1's set (:func:`takes`):
C = 256, 512 or 1024 in 4, 8, 16 or 32 groups of at least 16 channels,
scenes of at most 64 rows, 1-2 blocks and at most one skip a chain.  Within
it :func:`kernel_name` routes a chain: C = 512 in 8 groups to the
cluster-of-8 kernels (``chain_sm90``, bf16; ``chain_tf32``, f32), every other
chain to the dtype's wide kernel (``chain_bf16_wide``, ``chain_tf32_wide``;
one body, A fragments from L2, h and block 1's output through device
scratches).  The f32 kernels run their products in split TF32, three tf32
products per f32 product (never one), as B1's f32 kernels do.
:func:`tile_plan` is each kernel's launch and shared-memory plan and
:func:`pack_chain_weights` the weight layout their bulk copies read.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .fused_resblock import (CHANNELS, CHUNK_BYTES, CLUSTER, F32_CHUNK_BYTES, MIN_GROUP,
                             SET_CHANNELS, SET_GROUPS, TILE_ROWS, WIDE_STAGES, pack_group_tiles,
                             pack_tf32_tiles, wide_smem_bytes, wide_warpgroups)

CSRC = build.CSRC_DIR / "fused_chain.cu"
# rows of one scene each kernel takes: a scene tile's (kTileRows)
MAX_ROWS = {torch.float32: TILE_ROWS, torch.bfloat16: TILE_ROWS}
MAX_VECTORS = 14     # vectors of a two-block chain staged in shared memory (kMaxVectors)


@dataclasses.dataclass(frozen=True)
class ChainBlock:
    """Static description of one ResnetBlock in a chain."""

    has_skip: bool = False        # block1 input is concat(h, skip) -> split matmuls
    film: str = "none"            # "none" | "scene" (B, 2C) rows | "row" (M, 2C) rows
    has_res_proj: bool = False    # res path is a projection (required when has_skip)

    def __post_init__(self):
        if self.film not in ("none", "scene", "row"):
            raise ValueError(f"film must be none, scene or row, got {self.film!r}")
        # an identity residual over an implicit concat would change the width
        if self.has_skip and not self.has_res_proj:
            raise ValueError("skip-cat blocks must have a res projection")

    @property
    def spec(self) -> int:
        """The kernel's bit encoding of this block."""
        film = {"none": 0, "scene": 1, "row": 2}[self.film]
        return int(self.has_skip) | film << 1 | int(self.has_res_proj) << 3


@dataclasses.dataclass
class ChainParams:
    """Stacked weights and static spec for one chain call."""

    blocks: Tuple[ChainBlock, ...]
    W: torch.Tensor               # (nW, C, C) compute dtype, pre-standardized, (in, out)
    V: torch.Tensor               # (nV, C) f32: per block b1,g1s,g1b,b2,g2s,g2b[,bres]
    n_w: Tuple[int, ...]          # per-block number of (C, C) weights
    n_v: Tuple[int, ...]          # per-block number of (C,) vectors
    # W as each kernel's weight chunks (pack_chain_weights), by kernel name,
    # packed at the kernel's first launch
    W_packed: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def build_chain(blocks: Sequence[ChainBlock], weights: Sequence[Dict[str, Any]],
                compute_dtype=torch.bfloat16) -> ChainParams:
    """Stack a chain's weights into (nW, C, C) + (nV, C) tensors (once per
    sampling call).  ``weights[i]`` keys: w1, [w1s], w2, [wres, [wres_s]],
    b1, gn1_scale, gn1_bias, b2, gn2_scale, gn2_bias, [bres]."""
    Ws: List[torch.Tensor] = []
    Vs: List[torch.Tensor] = []
    n_w: List[int] = []
    n_v: List[int] = []
    for blk, wd in zip(blocks, weights):
        w = [wd["w1"]]
        if blk.has_skip:
            w.append(wd["w1s"])
        w.append(wd["w2"])
        if blk.has_res_proj:
            w.append(wd["wres"])
            if blk.has_skip:
                w.append(wd["wres_s"])
        v = [wd["b1"], wd["gn1_scale"], wd["gn1_bias"],
             wd["b2"], wd["gn2_scale"], wd["gn2_bias"]]
        if blk.has_res_proj:
            v.append(wd["bres"])
        Ws += w
        Vs += v
        n_w.append(len(w))
        n_v.append(len(v))
    W = torch.stack([a.to(compute_dtype) for a in Ws]).contiguous()
    V = torch.stack([a.to(torch.float32) for a in Vs]).contiguous()
    return ChainParams(blocks=tuple(blocks), W=W, V=V, n_w=tuple(n_w), n_v=tuple(n_v))


# ---------------------------------------------------------------------------
# plain torch version (CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------

def _silu(z: torch.Tensor) -> torch.Tensor:
    """SiLU computed in f32, rounded to z's dtype."""
    zf = z.float()
    return (zf * torch.sigmoid(zf)).to(z.dtype)


def apply_chain_reference(
    chain: ChainParams,
    x: torch.Tensor,
    films: Sequence[Optional[torch.Tensor]],
    skips: Sequence[Optional[torch.Tensor]],
    n_per_scene: int,
    groups: int = 8,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The chain in plain torch ops, twin of the JAX ``apply_chain_xla``.
    Matmuls take f32 products of the compute-dtype operands and accumulate
    in f32; the dense outputs are rounded to the compute dtype before the
    GroupNorm moments are taken, as in the kernel."""
    M, C = x.shape
    n = n_per_scene
    B = M // n
    films = [f for f in films if f is not None]
    skips = [s for s in skips if s is not None]
    dt = x.dtype
    gs = C // groups

    def mm(a, w):
        return torch.matmul(a.float(), w.float())

    def gn_affine(z, scale, bias):
        """(M, C) compute-dtype z -> per-scene f32 affine (B, C) a, b."""
        zf = z.float().reshape(B, n, groups, gs)
        mean = zf.mean(dim=(1, 3))                      # (B, g)
        e2 = (zf * zf).mean(dim=(1, 3))
        var = (e2 - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        a = inv.repeat_interleave(gs, dim=1) * scale
        b = bias - (mean * inv).repeat_interleave(gs, dim=1) * scale
        return a, b

    def affine(z, a, b):
        """z * a[scene] + b[scene] in the compute dtype."""
        z3 = z.reshape(B, n, C)
        return (z3 * a.to(dt)[:, None, :] + b.to(dt)[:, None, :]).reshape(M, C)

    h = x
    wi = vi = si = fi = 0
    W, V = chain.W, chain.V
    for bi, blk in enumerate(chain.blocks):
        xin = h
        b1, g1s, g1b = V[vi], V[vi + 1], V[vi + 2]
        b2, g2s, g2b = V[vi + 3], V[vi + 4], V[vi + 5]

        z = mm(h, W[wi])
        wj = wi + 1
        if blk.has_skip:
            sk = skips[si]
            z = z + mm(sk, W[wj])
            wj += 1
        z = (z + b1).to(dt)
        a, b = gn_affine(z, g1s, g1b)
        if blk.film == "scene":
            f = films[fi].float()                  # (B, 2C)
            fs = f[:, :C] + 1.0
            a = a * fs
            b = b * fs + f[:, C:]
            fi += 1
        z = affine(z, a, b)
        if blk.film == "row":
            f = films[fi].to(dt)                   # (M, 2C)
            z = z * (f[:, :C] + 1) + f[:, C:]
            fi += 1
        z = _silu(z)

        z2 = mm(z, W[wj])
        wj += 1
        z2 = (z2 + b2).to(dt)
        a, b = gn_affine(z2, g2s, g2b)
        z2 = _silu(affine(z2, a, b))

        if blk.has_res_proj:
            res = mm(xin, W[wj])
            wj += 1
            if blk.has_skip:
                res = res + mm(sk, W[wj])
                wj += 1
            res = (res + V[vi + 6]).to(dt)
        else:
            res = xin
        h = z2 + res
        if blk.has_skip:
            si += 1
        wi += chain.n_w[bi]
        vi += chain.n_v[bi]
    return h


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------

class TilePlan(NamedTuple):
    scenes_per_tile: int
    clusters: int
    ctas: int
    stages: int                # weight chunks in flight in a CTA's ring
    smem_bytes: int            # dynamic shared memory of one CTA
    resident: Optional[int]    # clusters that fit on the card at once (with ``lib``)


def takes(C: int, groups: int, n: int) -> bool:
    """Whether the kernels (either dtype) take chains of C channels in
    ``groups`` GroupNorm groups on scenes of n rows: B1's set
    (``fused_resblock.takes``), C in SET_CHANNELS, groups in SET_GROUPS with
    at least MIN_GROUP channels each, n <= 64."""
    return (C in SET_CHANNELS and groups in SET_GROUPS and C // groups >= MIN_GROUP
            and 1 <= n <= TILE_ROWS)


def kernel_name(dt, C: int, groups: int) -> str:
    """The kernel of a chain of the set in ``dt``: at C = 512 in 8 groups
    the cluster-of-8 kernel (``chain_tf32``, ``chain_sm90``), else the
    dtype's wide kernel (the library's ``fused_chain_wide``)."""
    if C == CHANNELS and groups == CLUSTER:
        return "chain_tf32" if dt == torch.float32 else "chain_sm90"
    return "chain_tf32_wide" if dt == torch.float32 else "chain_bf16_wide"


def tile_plan(B: int, n: int, blocks: Sequence[ChainBlock], lib=None,
              dtype=torch.bfloat16, C: int = CHANNELS, groups: int = CLUSTER) -> TilePlan:
    """The launch of the kernel that takes a chain of ``blocks`` on C
    channels in ``groups`` groups in ``dtype`` (:func:`kernel_name`) for B
    scenes of n rows; its shared-memory sum mirrors ``layout()``
    (chain_sm90), ``layout_tf32()`` (chain_tf32, csrc/sm90.cuh) or
    ``layout_wide()`` (the wide kernels, csrc/sm90.cuh) in the .cu
    (``fused_chain_smem_bytes``).

    chain_sm90: the weight ring (8 stages with a skip, else 4), the x tile
    (later the gathered h and each block's gathered output), the skip tile
    if a block takes one, the CTA's 64 columns of up to 14 vectors, row
    sums and squares, scene moments, and 35 mbarriers (the ring's full and
    empty ones, the x and skip tiles', block 1's output tile's, one for each
    CTA's slice of each block's h).

    chain_tf32 (the same for every chain): the weight ring (5 stages of a
    32-deep chunk's tf32 hi and lo, 16 KB), 8 slots of 64 rows x 64 columns
    (rows 68 floats apart) that hold each block's input K tiles in turn and
    then the slices of its h, up to 14 vectors, row sums and squares, scene
    moments, and 42 mbarriers (the ring's full and empty ones, the slots'
    full and empty ones, one for each CTA's slice of each block's h).

    chain_tf32_wide and chain_bf16_wide (one or two consumer warpgroups,
    ``fused_resblock.wide_warpgroups``; a cluster of C / 64 / warpgroups
    CTAs; the same for every chain): ``fused_resblock.wide_smem_bytes``
    with up to 14 vectors.

    With ``lib``, the loaded library, ``resident`` is
    cudaOccupancyMaxActiveClusters."""
    skip = any(b.has_skip for b in blocks)
    ts = TILE_ROWS // n
    tiles = -(-B // ts)
    group = CHANNELS // CLUSTER
    moments = 2 * TILE_ROWS * 4 + 2 * TILE_ROWS * 4
    ctas = CLUSTER
    if kernel_name(dtype, C, groups).endswith("_wide"):
        wg = wide_warpgroups(C)
        stages, smem = WIDE_STAGES, wide_smem_bytes(wg, dtype, MAX_VECTORS)
        ctas = C // (group * wg)
    elif dtype == torch.float32:
        stages = 5
        smem = (stages * F32_CHUNK_BYTES + CLUSTER * TILE_ROWS * (group + 4) * 4
                + MAX_VECTORS * group * 4 + moments + (2 * stages + 4 * CLUSTER) * 8)
    else:
        stages = 8 if skip else 4
        tile = TILE_ROWS * (CHANNELS + 8) * 2
        smem = (stages * CHUNK_BYTES + tile * (1 + skip) + MAX_VECTORS * group * 4 + moments
                + (2 * 8 + 3 + 2 * CLUSTER) * 8)
    resident = (None if lib is None else lib.fused_chain_max_active_clusters(
        build.DTYPE_CODES[dtype], int(skip), C, groups))
    return TilePlan(ts, tiles, ctas * tiles, stages, smem, resident)


def pack_chain_weights(W: torch.Tensor, permuted: bool = False) -> torch.Tensor:
    """A chain's stacked (nW, C, C) (in, out) weights as the kernels'
    chunks, packed once per chain from the (nW * C, C) stack, so that each
    64-column group's chunks for the whole chain are contiguous, and a
    CTA's (its one or two groups') too.  With S = C / 32 (f32) or C / 64
    (bf16) K steps a weight: f32, :func:`pack_tf32_tiles`, the 32-deep step
    st of weight w for group g is the 4096 floats (tf32 hi, then lo) from
    (g * S nW + S w + st) * 4096, for every kernel; bf16,
    :func:`pack_group_tiles`, K tile st of weight w for group g is the 4096
    elements from (g * S nW + S w + st) * 4096, with each K tile's rows
    permuted for the wide kernel (``permuted``).  A skip block's w1 and w1s
    (wres and wres_s) are consecutive weights: the (2C, C) [x | skip]
    weight, whose K steps the wide kernel streams in one run."""
    flat = W.reshape(-1, W.shape[-1])
    if W.dtype == torch.float32:
        return pack_tf32_tiles(flat)
    return pack_group_tiles(flat, permuted=permuted)


def check_kernel_shapes(blocks: Sequence[ChainBlock], dt: torch.dtype, C: int, n: int,
                        groups: int) -> None:
    """Raise ValueError unless the kernels take a chain of ``blocks`` in
    ``dt`` on scenes of n rows of C channels in ``groups`` groups: float32
    or bfloat16, the set of :func:`takes`, 1-2 blocks and at most one skip a
    chain (no JAX chain has two, ``models/inference.py:prepare_chain_params``)."""
    if dt not in build.DTYPE_CODES:
        raise ValueError(f"the chain kernel takes float32 or bfloat16, got {dt}")
    if not 1 <= len(blocks) <= 2:
        raise ValueError("the chain kernel runs chains of 1 or 2 blocks")
    skips = sum(b.has_skip for b in blocks)
    if not takes(C, groups, n) or skips > 1:
        raise ValueError(
            f"the {dt} chain kernel takes C in {SET_CHANNELS} in {SET_GROUPS} groups of at "
            f"least {MIN_GROUP} channels, at most {MAX_ROWS[dt]} rows per scene and at most one "
            f"skip a chain; got C={C}, groups={groups}, N={n}, {skips} skips")


# (C, groups) of the set whose plans load_library holds against the library
PLAN_CHECKS = ((512, 8), (256, 8), (256, 16), (512, 4), (512, 32), (1024, 4), (1024, 8))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/fused_chain.cu`` for sm_90a (unless this source was
    built already, see ``ops/build.py``), load it, and check its limits,
    routes and shared-memory sums against this module's."""
    lib = build.load(CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_chain_launch.argtypes = [
        ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, vp,
    ]
    lib.fused_chain_launch.restype = ci
    lib.fused_chain_launch_wide.argtypes = lib.fused_chain_launch.argtypes
    lib.fused_chain_launch_wide.restype = ci
    for fn, args in ((lib.fused_chain_max_rows, [ci]), (lib.fused_chain_smem_bytes, [ci] * 4),
                     (lib.fused_chain_wide, [ci, ci]),
                     (lib.fused_chain_max_active_clusters, [ci] * 4)):
        fn.argtypes, fn.restype = args, ci
    rows = {dt: lib.fused_chain_max_rows(code) for dt, code in build.DTYPE_CODES.items()}
    plans = {(code, skip, C, g): tile_plan(1, 1, [ChainBlock(has_skip=skip, has_res_proj=skip)],
                                           dtype=dt, C=C, groups=g).smem_bytes
             for dt, code in build.DTYPE_CODES.items() for skip in (False, True)
             for C, g in PLAN_CHECKS}
    routes = {(C, g): lib.fused_chain_wide(C, g) for C in (*SET_CHANNELS, 2048)
              for g in (2, *SET_GROUPS, 64)}
    want = {(C, g): (int(kernel_name(torch.float32, C, g).endswith("_wide"))
                     if takes(C, g, 1) else -1) for C, g in routes}
    if rows != MAX_ROWS or routes != want or any(
            lib.fused_chain_smem_bytes(*key) != v for key, v in plans.items()):
        raise RuntimeError("csrc/fused_chain.cu and ops/fused_level.py disagree on limits")
    return lib


def _launch_kernel(chain: ChainParams, x, films, skips, n: int, groups: int,
                   eps: float) -> torch.Tensor:
    M, C = x.shape
    dt = x.dtype
    check_kernel_shapes(chain.blocks, dt, C, n, groups)
    dev = x.device
    build.check_operand("x", x, dev, dt, (M, C))
    build.check_operand("W", chain.W, dev, dt, (sum(chain.n_w), C, C))
    build.check_operand("V", chain.V, dev, torch.float32, (sum(chain.n_v), C))
    ptr_skip, ptr_film = [None, None], [None, None]
    for i, (f, sk) in enumerate(zip(films, skips)):
        if sk is not None:
            build.check_operand(f"skips[{i}]", sk, dev, dt, (M, C))
            ptr_skip[i] = sk.data_ptr()
        if f is not None:
            build.check_operand(f"films[{i}]", f, dev, dt, f.shape)
            ptr_film[i] = f.data_ptr()
    kernel = kernel_name(dt, C, groups)
    wide = kernel.endswith("_wide")
    W = chain.W_packed.get(kernel)
    if W is None:
        W = chain.W_packed[kernel] = pack_chain_weights(chain.W, permuted=wide)
        build.prepared.made += 1
    specs = [blk.spec for blk in chain.blocks] + [0]
    out = torch.empty_like(x)
    # the wide kernels' h and block 1's output go through device memory
    h = torch.empty_like(x) if wide else None
    mid = torch.empty_like(x) if wide and len(chain.blocks) == 2 else None
    rc = load_library().fused_chain_launch(
        build.DTYPE_CODES[dt], x.data_ptr(), ptr_skip[0], ptr_skip[1], ptr_film[0], ptr_film[1],
        W.data_ptr(), chain.V.data_ptr(), None if h is None else h.data_ptr(),
        None if mid is None else mid.data_ptr(), out.data_ptr(),
        M // n, n, C, groups, eps, len(chain.blocks), specs[0], specs[1],
        build.stream_ptr(dev),
    )
    if rc != 0:
        raise RuntimeError(f"fused_chain_launch failed with code {rc}")
    build.count_launch(apply_chain, kernel)
    return out


def apply_chain(
    chain: ChainParams,
    x: torch.Tensor,                                  # (M, C) compute dtype, M = B * n
    films: Sequence[Optional[torch.Tensor]],          # per block: None | (B, 2C) | (M, 2C)
    skips: Sequence[Optional[torch.Tensor]],          # per block: None | (M, C)
    n_per_scene: int,
    groups: int = 8,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Run the chain over all rows: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Any B works (the kernel masks a ragged
    last tile).  ``apply_chain.launches`` counts the chains sent to the
    kernel, one per launch, ``apply_chain.by_kernel`` them by kernel name
    (:func:`kernel_name`).  They count the launches the card runs: a call
    captured into a CUDA graph counts nothing itself, and each replay of the
    graph adds its launches (``build.count_launch``)."""
    M, C = x.shape
    n = n_per_scene
    B = M // n
    if M != B * n:
        raise ValueError(f"{M} rows are not whole scenes of {n}")
    if len(films) != len(chain.blocks) or len(skips) != len(chain.blocks):
        raise ValueError("films and skips need one entry per block")
    for blk, f, sk in zip(chain.blocks, films, skips):
        if (f is not None) != (blk.film != "none"):
            raise ValueError(f"film given/missing for a {blk.film!r} block")
        if (sk is not None) != blk.has_skip:
            raise ValueError("skip given/missing for a block")
        if f is not None:
            want = (B, 2 * C) if blk.film == "scene" else (M, 2 * C)
            if tuple(f.shape) != want:
                raise ValueError(f"film shape {tuple(f.shape)}, expected {want}")
    if x.device.type == "cpu":
        return apply_chain_reference(chain, x, films, skips, n, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"apply_chain runs on cpu or cuda tensors, got {x.device}")
    return _launch_kernel(chain, x, films, skips, n, groups, eps)


apply_chain.launches = 0
apply_chain.by_kernel = {}
