// Directed nearest neighbour for the chamfer distance, by hand for Hopper.
//
// Replaces the Pallas TPU kernel diffuscene_tpu/ops/chamfer.py:65 _nn_kernel
// (called from _directed_nn :115, pallas_call :130).  For x (B, N, D) and
// y (B, M, D), f32, D <= 8:
//
//   dist[b, n] = min_m (|x_n|^2 + |y_m|^2 - 2 x_n . y_m)
//   idx[b, n]  = the lowest m that reaches that minimum
//
// The same expansion as the Pallas kernel and the oracle, not clamped at 0,
// so that results agree where it rounds below zero; the strict "<" over m in
// increasing order keeps the first index of a tie, as jnp.argmin does.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), in the order of the plain torch twin
// ops/chamfer.py:directed_nn_reference, so the two agree bit for bit: an
// argmin between two distances that differ by a rounding is the same in both.
//
// What bounds it: operations.  One pair needs at least D + 3 FP32
// instructions (D FMAs of the dot product, the expansion's add and FMA, a
// compare-select: 6 at D=3); the AE loss's two directions at
// (16, 2048, 3) x (16, 2025, 3) are 1.33e8 pairs, about 24 us on 132 SMs x
// 128 FP32 lanes at ~1.98 GHz.  Bytes are under 1 MB.  Rounding each step
// on its own costs 2D - 1 instructions for the dot product and 3 for the
// expansion, and the compare-select 3: 11 at D=3, about 44 us.
//
// Design.  A thread keeps kPoints = 2 x points in registers (points t and
// t + 32 of its CTA's 64), and each y point, read once from shared memory as
// a broadcast (one 16-byte load at D <= 3), feeds 2 independent (min,
// argmin) chains; the y loop is unrolled 8 deep, so a thread has 16
// independent pairs in flight.  The M sweep is split across a cluster of S
// CTAs (S = min(2, ceil(M / 64)); slice q is y points [q L, (q + 1) L),
// L = ceil(M / S)), each staging its slice in shared memory in chunks of
// kTileM points (coordinates, then |y|^2).  The CTAs then merge their
// partial (dist, idx) through distributed shared memory: CTA q takes 1/S of
// the block's points and reads the S partials in rank order with a strict
// "<", so the lowest index still wins a tie that spans two slices.  One
// launch a directed call, a grid of (ceil(N / 64) * S, B) CTAs of one warp:
// at the AE shape 1024 CTAs, 7.8 an SM.
//
// Why these sizes: the pair loop is issue-bound (11 instructions a pair, as
// above), so the kernel's time is set by how evenly the CTAs land on the
// SMs.  Clusters of 3 to 8 CTAs were placed on 124 of the 132 SMs, and an SM
// holding one CTA more than the mean finishes last; clusters of 2 use all
// 132, and 1024 one-warp CTAs put 7 or 8 on each.  chip_smoke.py on an
// H100 (PERF.md §6): 4 points a thread in 512 CTAs of 4 warps and
// clusters of 8 took 0.089 ms a chamfer forward as graph replay, this
// layout 0.070.
#include <cooperative_groups.h>
#include <math.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 32;
constexpr int kPoints = 2;                      // x points a thread
constexpr int kBlockPoints = kThreads * kPoints;
constexpr int kMaxCluster = 2;                  // CTAs splitting the M sweep
constexpr int kMinSlice = 64;                   // one CTA below 2 x 64 y points
constexpr int kTileM = 512;                     // y points staged at once
constexpr int kMaxDim = 8;

// floats a staged y point takes: D coordinates, |y|^2, padded to 16 bytes
template <int D>
__host__ __device__ constexpr int y_stride() { return (D + 1 + 3) / 4 * 4; }

int cluster_size(int M) {
  const int s = (M + kMinSlice - 1) / kMinSlice;
  return s < kMaxCluster ? s : kMaxCluster;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
chamfer_nn_sm90(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ dist, int* __restrict__ idx, int N, int M, int slice) {
  constexpr int kS = y_stride<D>();
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);                       // kTileM x kS
  float2* part = reinterpret_cast<float2*>(ys + kTileM * kS);       // (dist, idx bits)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int n0 = (blockIdx.x / S) * kBlockPoints;
  const int m_lo = rank * slice, m_hi = min(M, m_lo + slice);

  float xv[kPoints][D], xx[kPoints], best[kPoints];
  int best_i[kPoints];
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    const int n = n0 + p * kThreads + threadIdx.x;
    const float* xp = x + ((size_t)b * N + (n < N ? n : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xv[p][d] = n < N ? xp[d] : 0.f;
      const float sq = __fmul_rn(xv[p][d], xv[p][d]);
      xx[p] = d == 0 ? sq : __fadd_rn(xx[p], sq);
    }
    best[p] = INFINITY;
    best_i[p] = 0;
  }

  const float* yb = y + (size_t)b * M * D;
  for (int m0 = m_lo; m0 < m_hi; m0 += kTileM) {
    const int len = min(kTileM, m_hi - m0);
    __syncthreads();                     // the previous chunk is no longer read
#pragma unroll 4
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* yp = yb + (size_t)(m0 + j) * D;
      float yy = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float v = yp[d];
        ys[j * kS + d] = v;
        yy = d == 0 ? __fmul_rn(v, v) : __fadd_rn(yy, __fmul_rn(v, v));
      }
      ys[j * kS + D] = yy;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < len; ++j) {
      float yv[kS];
#pragma unroll
      for (int v = 0; v < kS / 4; ++v) {
        const float4 q = reinterpret_cast<const float4*>(ys + j * kS)[v];
        yv[4 * v] = q.x;
        yv[4 * v + 1] = q.y;
        yv[4 * v + 2] = q.z;
        yv[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        float xy = __fmul_rn(xv[p][0], yv[0]);
#pragma unroll
        for (int d = 1; d < D; ++d) xy = __fadd_rn(xy, __fmul_rn(xv[p][d], yv[d]));
        const float dd = __fsub_rn(__fadd_rn(xx[p], yv[D]), __fmul_rn(2.f, xy));
        if (dd < best[p]) {
          best[p] = dd;
          best_i[p] = m0 + j;
        }
      }
    }
  }

  // merge the cluster's partials: CTA `rank` takes points [rank * per, ...)
  // of the block, reading slice 0's partial first, then each later one that
  // is strictly smaller
#pragma unroll
  for (int p = 0; p < kPoints; ++p)
    part[p * kThreads + threadIdx.x] = make_float2(best[p], __int_as_float(best_i[p]));
  sm90::cluster_arrive();              // every partial of the cluster is written
  sm90::cluster_wait();
  const int per = (kBlockPoints + S - 1) / S;
  for (int i = threadIdx.x; i < per; i += kThreads) {
    const int q = rank * per + i, n = n0 + q;
    if (q >= kBlockPoints || n >= N) break;
    float bd = 0.f;
    int bi = 0;
    for (int c = 0; c < S; ++c) {
      const uint2 v = sm90::ld_cluster_u2(sm90::cluster_addr(&part[q], c));
      const float d = __uint_as_float(v.x);
      if (c == 0 || d < bd) {
        bd = d;
        bi = (int)v.y;
      }
    }
    dist[(size_t)b * N + n] = bd;
    idx[(size_t)b * N + n] = bi;
  }
  sm90::cluster_arrive();              // no CTA leaves while another reads its partials
  sm90::cluster_wait();
}

template <int D>
cudaError_t launch(const float* x, const float* y, float* dist, int* idx, int B, int N, int M,
                   cudaStream_t stream) {
  const int S = cluster_size(M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kBlockPoints - 1) / kBlockPoints * S), (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * kTileM * y_stride<D>() + sizeof(float2) * kBlockPoints;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chamfer_nn_sm90<D>, x, y, dist, idx, N, M, (M + S - 1) / S);
}

}  // namespace

extern "C" {

int chamfer_nn_max_dim() { return kMaxDim; }
int chamfer_nn_points_per_thread() { return kPoints; }
int chamfer_nn_threads() { return kThreads; }
// CTAs of a cluster (slices of the M sweep) for M points of y
int chamfer_nn_cluster_size(int M) { return M < 1 ? 0 : cluster_size(M); }

// x (B, N, D), y (B, M, D) f32 contiguous; dist (B, N) f32, idx (B, N) int32.
// Returns 0, or the CUDA error of the launch (a refused launch never runs).
int chamfer_nn_launch(const float* x, const float* y, float* dist, int* idx, int B, int N, int M,
                      int D, void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 1: return (int)launch<1>(x, y, dist, idx, B, N, M, stream);
    case 2: return (int)launch<2>(x, y, dist, idx, B, N, M, stream);
    case 3: return (int)launch<3>(x, y, dist, idx, B, N, M, stream);
    case 4: return (int)launch<4>(x, y, dist, idx, B, N, M, stream);
    case 5: return (int)launch<5>(x, y, dist, idx, B, N, M, stream);
    case 6: return (int)launch<6>(x, y, dist, idx, B, N, M, stream);
    case 7: return (int)launch<7>(x, y, dist, idx, B, N, M, stream);
    case 8: return (int)launch<8>(x, y, dist, idx, B, N, M, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
