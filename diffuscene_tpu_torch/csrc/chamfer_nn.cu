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
// on its own costs 2D + 4 instructions a pair instead.
//
// Design: one thread per x point, 128 threads a block, a grid of
// (ceil(N / 128), B).  The block stages y in chunks of kTileM points in
// shared memory, each point as D coordinates and its squared norm; every
// thread of a warp reads the same point at once (a broadcast, no bank
// conflicts).  The running (min, argmin) of each thread stays in registers.
// D is a template parameter so that the dot product unrolls.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileM = 1024;
constexpr int kMaxDim = 8;

template <int D>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
          float* __restrict__ dist, int* __restrict__ idx, int N, int M) {
  extern __shared__ float ys[];          // kTileM x (D + 1): coordinates, then |y|^2
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = n < N;

  float xv[D];
  float xx = 0.f;
  const float* xp = x + ((size_t)b * N + (valid ? n : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xv[d] = valid ? xp[d] : 0.f;
    xx = d == 0 ? __fmul_rn(xv[0], xv[0]) : __fadd_rn(xx, __fmul_rn(xv[d], xv[d]));
  }

  float best = INFINITY;
  int best_i = 0;
  const float* yb = y + (size_t)b * M * D;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    const int len = min(kTileM, M - m0);
    __syncthreads();                     // the previous chunk is no longer read
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* yp = yb + (size_t)(m0 + j) * D;
      float yy = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float v = yp[d];
        ys[j * (D + 1) + d] = v;
        yy = d == 0 ? __fmul_rn(v, v) : __fadd_rn(yy, __fmul_rn(v, v));
      }
      ys[j * (D + 1) + D] = yy;
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < len; ++j) {
        const float* yp = ys + j * (D + 1);
        float xy = __fmul_rn(xv[0], yp[0]);
#pragma unroll
        for (int d = 1; d < D; ++d) xy = __fadd_rn(xy, __fmul_rn(xv[d], yp[d]));
        const float dd = __fsub_rn(__fadd_rn(xx, yp[D]), __fmul_rn(2.f, xy));
        if (dd < best) {
          best = dd;
          best_i = m0 + j;
        }
      }
    }
  }
  if (valid) {
    dist[(size_t)b * N + n] = best;
    idx[(size_t)b * N + n] = best_i;
  }
}

template <int D>
cudaError_t launch(const float* x, const float* y, float* dist, int* idx, int B, int N, int M,
                   cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  const size_t smem = sizeof(float) * kTileM * (D + 1);
  nn_kernel<D><<<grid, kThreads, smem, stream>>>(x, y, dist, idx, N, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int chamfer_nn_max_dim() { return kMaxDim; }

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
