"""Chamfer distance between point clouds: the CUDA nearest-neighbour kernel
and its plain torch twin.

Port of ``diffuscene_tpu/ops/chamfer.py``.  For clouds x (B, N, D) and
y (B, M, D) the chamfer distance is, in both directions, each point's
squared distance to its nearest neighbour in the other cloud, with the
argmin.  The shape autoencoder's loss (``models/autoencoder.py``) runs it
once per step, two directed launches.

- :func:`directed_nn` sends CUDA tensors to the hand-written kernel in
  ``csrc/chamfer_nn.cu`` and CPU tensors to :func:`directed_nn_reference`.
  It never falls back: a CUDA tensor the kernel cannot take raises.
- :func:`chamfer_distance` is a ``torch.autograd.Function``.  Its backward is
  the gather and scatter-add of the JAX custom VJP (``_chamfer_bwd``) in
  plain torch; the JAX backward is no Pallas kernel either.  On CUDA,
  ``index_add_`` sums with atomics in a varying order, so gradients agree
  with a fixed-order sum only to rounding.

Distances use the expansion |x|^2 + |y|^2 - 2 x.y, as the JAX package's
Pallas kernel and ``chamfer_oracle`` do, and are not clamped at 0.  Ties
take the lowest index.

The kernel keeps two x points per thread and splits the sweep over y
across a thread-block cluster of two, merging the slices' minima in slice order;
:func:`launch_plan` is its launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

CSRC = build.CSRC_DIR / "chamfer_nn.cu"
MAX_DIM = 8
POINTS_PER_THREAD = 2     # x points a thread keeps (kPoints)
THREADS = 32              # threads a CTA, one warp (kThreads)
MAX_CLUSTER = 2           # CTAs splitting the y sweep (kMaxCluster)
MIN_SLICE = 64            # fewer CTAs below MAX_CLUSTER * MIN_SLICE y points (kMinSlice)


class LaunchPlan(NamedTuple):
    points_per_thread: int
    threads: int
    cluster: int                          # CTAs of a cluster = slices of y
    slices: Tuple[Tuple[int, int], ...]   # [lo, hi) of y each CTA sweeps
    x_blocks: int                         # clusters along x per cloud
    ctas: int


def launch_plan(B: int, N: int, M: int) -> LaunchPlan:
    """The kernel's launch for x (B, N, D) against y (B, M, D): slice q of
    the cluster sweeps y points [q L, min(M, (q + 1) L)), L = ceil(M / S),
    S = min(2, ceil(M / 64)); each cluster covers 64 x points of a cloud."""
    S = min(MAX_CLUSTER, -(-M // MIN_SLICE))
    L = -(-M // S)
    slices = tuple((q * L, min(M, (q + 1) * L)) for q in range(S))
    x_blocks = -(-N // (THREADS * POINTS_PER_THREAD))
    return LaunchPlan(POINTS_PER_THREAD, THREADS, S, slices, x_blocks, B * x_blocks * S)


def pairwise_sqdist_kernel_order(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic, every product and sum rounded on its own in
    the kernel's order: |x|^2 and |y|^2 and x.y summed over d = 0, 1, ...,
    then (|x|^2 + |y|^2) - 2 x.y."""
    xx = x[..., 0] * x[..., 0]
    yy = y[..., 0] * y[..., 0]
    xy = x[:, :, None, 0] * y[:, None, :, 0]
    for d in range(1, x.shape[-1]):
        xx = xx + x[..., d] * x[..., d]
        yy = yy + y[..., d] * y[..., d]
        xy = xy + x[:, :, None, d] * y[:, None, :, d]
    return (xx[:, :, None] + yy[:, None, :]) - 2.0 * xy


def directed_nn_reference(x: torch.Tensor, y: torch.Tensor):
    """Plain torch twin of the kernel, equal to it bit for bit:
    (B, N, D) vs (B, M, D) -> (dist (B, N) f32, idx (B, N) int32)."""
    dist, idx = pairwise_sqdist_kernel_order(x.float(), y.float()).min(dim=2)
    return dist, idx.int()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/chamfer_nn.cu`` for sm_90a (unless this source was
    built already, see ``ops/build.py``) and load it."""
    lib = build.load(CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.chamfer_nn_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.chamfer_nn_launch.restype = ci
    for fn, args in ((lib.chamfer_nn_max_dim, []), (lib.chamfer_nn_points_per_thread, []),
                     (lib.chamfer_nn_threads, []), (lib.chamfer_nn_cluster_size, [ci])):
        fn.argtypes, fn.restype = args, ci
    ms = (1, 64, 65, 777, 2025, 10 ** 6)
    if ((lib.chamfer_nn_max_dim(), lib.chamfer_nn_points_per_thread(), lib.chamfer_nn_threads())
            != (MAX_DIM, POINTS_PER_THREAD, THREADS)
            or [lib.chamfer_nn_cluster_size(m) for m in ms]
            != [launch_plan(1, 1, m).cluster for m in ms]):
        raise RuntimeError("csrc/chamfer_nn.cu and ops/chamfer.py disagree on the launch")
    return lib


def _launch_kernel(x: torch.Tensor, y: torch.Tensor):
    B, N, D = x.shape
    M = y.shape[1]
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise ValueError(f"the chamfer kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"the chamfer kernel takes 1 <= D <= {MAX_DIM}, got {D}")
    dist = torch.empty(B, N, dtype=torch.float32, device=x.device)
    idx = torch.empty(B, N, dtype=torch.int32, device=x.device)
    rc = load_library().chamfer_nn_launch(
        x.data_ptr(), y.data_ptr(), dist.data_ptr(), idx.data_ptr(), B, N, M, D,
        build.stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"chamfer_nn_launch failed with code {rc}")
    build.count_launch(directed_nn)
    return dist, idx


def directed_nn(x: torch.Tensor, y: torch.Tensor):
    """Nearest neighbour in y of every point of x: (dist (B, N), idx (B, N)
    int32).  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``directed_nn.launches`` counts the kernel launches the card
    runs: a call captured into a CUDA graph counts nothing itself, and each
    replay of the graph adds its launches (``build.count_launch``)."""
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] or x.shape[2] != y.shape[2]:
        raise ValueError(f"expected (B, N, D) and (B, M, D), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.shape[1] == 0 or y.shape[1] == 0:
        raise ValueError("both clouds need at least one point")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return directed_nn_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"directed_nn runs on cpu or cuda tensors, got {x.device} and {y.device}")
    return _launch_kernel(x, y)


directed_nn.launches = 0


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        dist1, idx1 = directed_nn(x, y)
        dist2, idx2 = directed_nn(y, x)
        ctx.save_for_backward(x, y, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, dist2, idx1, idx2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x, y, idx1, idx2 = ctx.saved_tensors
        B, N, D = x.shape
        M = y.shape[1]
        if g1 is None:
            g1 = torch.zeros(B, N, dtype=x.dtype, device=x.device)
        if g2 is None:
            g2 = torch.zeros(B, M, dtype=y.dtype, device=y.device)
        i1 = idx1.long()
        i2 = idx2.long()
        # dist1 term: d|x_n - y_idx1[n]|^2
        y_near = torch.gather(y, 1, i1[..., None].expand(B, N, D))
        diff1 = 2.0 * (x - y_near) * g1[..., None]
        # dist2 term: d|y_m - x_idx2[m]|^2
        x_near = torch.gather(x, 1, i2[..., None].expand(B, M, D))
        diff2 = 2.0 * (y - x_near) * g2[..., None]
        base_y = (torch.arange(B, device=x.device) * M)[:, None]
        base_x = (torch.arange(B, device=x.device) * N)[:, None]
        gx = diff1.reshape(B * N, D).clone()
        gx.index_add_(0, (i2 + base_x).reshape(-1), -diff2.reshape(B * M, D))
        gy = diff2.reshape(B * M, D).clone()
        gy.index_add_(0, (i1 + base_y).reshape(-1), -diff1.reshape(B * N, D))
        return gx.reshape(B, N, D), gy.reshape(B, M, D)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """Bidirectional chamfer: (dist1 (B, N), dist2 (B, M), idx1, idx2).
    Differentiable in both clouds through dist1 and dist2; the int32 index
    outputs are not differentiable."""
    return _Chamfer.apply(x, y)


def _check_dim(x, y, d):
    if x.shape[-1] != d or y.shape[-1] != d:
        raise ValueError(f"expected {d}-d points, got {x.shape[-1]} and {y.shape[-1]}")


def chamfer_2d(x, y):
    _check_dim(x, y, 2)
    return chamfer_distance(x, y)


def chamfer_3d(x, y):
    _check_dim(x, y, 3)
    return chamfer_distance(x, y)


def chamfer_5d(x, y):
    _check_dim(x, y, 5)
    return chamfer_distance(x, y)


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 0.001):
    """Point-cloud F-score from chamfer distances: (f, precision_1,
    precision_2), each (B,)."""
    precision_1 = (dist1 < threshold).float().mean(dim=1)
    precision_2 = (dist2 < threshold).float().mean(dim=1)
    denom = precision_1 + precision_2
    f = torch.where(denom > 0, 2 * precision_1 * precision_2 / denom.clamp_min(1e-12),
                    torch.zeros_like(denom))
    return f, precision_1, precision_2
