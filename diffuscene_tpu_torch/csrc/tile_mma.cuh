// Device helpers shared by the single-ResnetBlock kernel (fused_resblock.cu:
// its f32 kernel, and ldmatrix and the conversions in its bf16 one) and the
// set-attention kernel (set_attention.cu), for sm_90a:
//
// - float <-> storage-type conversions and rounding;
// - 16-byte row copies from device memory into padded shared-memory tiles;
// - the bf16 product of a 32-row shared-memory tile with a weight matrix
//   packed into mma.m16n8k16 B-fragment order (pack_mma_weights in
//   ops/fused_level.py), on the tensor cores with f32 accumulation;
// - the f32 product of a shared-memory tile with a row-major weight matrix,
//   on the FMA pipes.
//
// Every function here is called by all threads of the block, or (warp_mma)
// by all lanes of a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// v rounded to T's precision, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

// two adjacent elements, converted to / from float
template <typename T>
__device__ __forceinline__ float2 ld2(const T* p) { return make_float2(to_f<T>(p[0]), to_f<T>(p[1])); }
template <>
__device__ __forceinline__ float2 ld2<float>(const float* p) { return *reinterpret_cast<const float2*>(p); }
template <>
__device__ __forceinline__ float2 ld2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ void st2(T* p, float a, float b);
template <>
__device__ __forceinline__ void st2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void st2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copy `rows` rows of width `width` from a row-major array with row stride
// `ld_src` into a shared tile of `tile_rows` rows and stride `lda`, zeroing
// rows [rows, tile_rows).  16-byte vectors: width, ld_src and lda are
// multiples of 16 bytes' worth of T.
template <typename T>
__device__ void load_rows(T* dst, int lda, const T* src, int ld_src, int rows, int tile_rows,
                          int width) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = width / kVec;
  for (int i = threadIdx.x; i < tile_rows * per_row; i += blockDim.x) {
    const int r = i / per_row, v = i % per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = reinterpret_cast<const uint4*>(src + (size_t)r * ld_src)[v];
    reinterpret_cast<uint4*>(dst + r * lda)[v] = val;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][j] += A[0:32, 0:K] @ W[0:K, n0 + 8j : n0 + 8j + 8] for j < NJ, by
// one warp.  A: a bf16 shared tile of 32 rows, stride lda (a multiple of 8
// elements).  Wp: the weight packed as (N, K), each 16-wide k block ordered
// so that lane (g, t) finds its B fragment {k = 2t, 2t+1, 2t+8, 2t+9} of
// column g as 8 contiguous bytes.  Accumulator (m, j, i) is row
// 16m + g (+8 for i >= 2), column n0 + 8j + 2t (+1 for odd i).
template <int NJ>
__device__ __forceinline__ void warp_mma(float (&acc)[2][NJ][4], const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* __restrict__ Wp, int K, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* wb = Wp + (size_t)(n0 + g) * K + 4 * t;
  const size_t jstride = (size_t)8 * K;
  const __nv_bfloat16* ab = A + (lane & 15) * lda + (lane >> 4) * 8;
  uint2 b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[j] = __ldg(reinterpret_cast<const uint2*>(wb + j * jstride));
#pragma unroll 1
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, ab + ks * 16);
    ldmatrix_x4(a1, ab + 16 * lda + ks * 16);
    uint2 nb[NJ];
    const bool more = ks + 1 < K / 16;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      nb[j] = more ? __ldg(reinterpret_cast<const uint2*>(wb + j * jstride + (ks + 1) * 16)) : b[j];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma_bf16(acc[0][j], a0, b[j].x, b[j].y);
      mma_bf16(acc[1][j], a1, b[j].x, b[j].y);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = nb[j];
  }
}

// acc[r] += A[r, 0:K] @ W[0:K, col:col+2] for r < R, by one thread.  A: an
// f32 shared tile, stride lda (a multiple of 4); W: row-major (K, ldw) in
// device memory; K a multiple of 4.
template <int R>
__device__ __forceinline__ void fma_mm(float (&acc)[R][2], const float* A, int lda,
                                       const float* __restrict__ W, int ldw, int K, int col) {
  const float* wp = W + col;
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    const float* p = wp + (size_t)k * ldw;
    const float2 w0 = __ldg(reinterpret_cast<const float2*>(p));
    const float2 w1 = __ldg(reinterpret_cast<const float2*>(p + ldw));
    const float2 w2 = __ldg(reinterpret_cast<const float2*>(p + 2 * ldw));
    const float2 w3 = __ldg(reinterpret_cast<const float2*>(p + 3 * ldw));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
      float s0 = acc[r][0], s1 = acc[r][1];
      s0 = fmaf(a.x, w0.x, s0); s1 = fmaf(a.x, w0.y, s1);
      s0 = fmaf(a.y, w1.x, s0); s1 = fmaf(a.y, w1.y, s1);
      s0 = fmaf(a.z, w2.x, s0); s1 = fmaf(a.z, w2.y, s1);
      s0 = fmaf(a.w, w3.x, s0); s1 = fmaf(a.w, w3.y, s1);
      acc[r][0] = s0; acc[r][1] = s1;
    }
  }
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// byte offset rounded up to 16
__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

}  // namespace tile
