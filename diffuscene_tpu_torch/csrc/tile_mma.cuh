// Device helpers shared by the cluster kernels (fused_resblock.cu,
// fused_chain.cu, set_attention.cu, through sm90.cuh) and the f32
// set-attention kernel (set_attention.cu), for sm_90a:
//
// - float <-> storage-type conversions and rounding;
// - ldmatrix of a bf16 A fragment;
// - the f32 product of a shared-memory tile with a row-major weight matrix,
//   on the FMA pipes (the f32 set-attention kernel).
//
// Every function here is called by all threads of the block, or (ldmatrix)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

// byte offset rounded up to 16
__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

}  // namespace tile
