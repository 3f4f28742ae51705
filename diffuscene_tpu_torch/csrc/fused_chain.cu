// Whole-level ResnetBlock chain on flat (B*n, C) rows, for sm_90a.
//
// Replaces the Pallas kernel diffuscene_tpu/ops/fused_level.py:_chain_kernel
// (with _gn_coeffs).  One launch runs a static chain of 1-2 ResnetBlocks:
//
//     z   = x @ W1 (+ skip @ W1s) + b1        -> compute dtype
//     a,b = GroupNorm coefficients of z        (per scene, f32 moments)
//     a,b = scene-FiLM folded into a, b        (film "scene": (B, 2C) rows)
//     z   = z * a + b                          (film "row": then * (f+1) + f)
//     z   = silu(z) @ W2 + b2                  -> compute dtype
//     z   = silu(GroupNorm(z))
//     out = z + (x | x @ Wres (+ skip @ Wres_s) + bres)
//
// in float32 or bfloat16, with f32 accumulation and f32 GroupNorm
// statistics, rounding to the compute dtype at the same places as the Pallas
// kernel and the plain twin apply_chain_reference.
//
// Design.  A thread block owns a tile of whole scenes (at most kRows valid
// rows), so the GroupNorm statistics of a scene never leave the block: no
// one-hot group or scene matmuls (those exist on the TPU only to avoid
// lane-crossing reshapes).  The activation tile, the skip tile and both
// intermediates stay in shared memory for the whole chain; only x, skips,
// films, weights and the output touch device memory.  Group sums reduce
// through shared memory in a fixed order, so results are deterministic.
//
// Products.  bfloat16 runs on the tensor cores (mma.sync m16n8k16, f32
// accumulate): the tile is padded to 32 rows (two m16 tiles), warp w owns
// output columns [64w, 64w + 64), A fragments come from shared memory by
// ldmatrix, and B fragments stream from device memory (L2) straight into
// registers, two k-steps ahead, from a copy of the weights that the wrapper
// packs once per chain into the fragment order (pack_mma_weights in
// ops/fused_level.py).  float32 runs on the FMA pipes in full f32: thread t
// owns output columns 2t, 2t+1 for all rows, each weight element is read
// once per block and each activation value is a shared-memory broadcast.
//
// What bounds it.  At B=64, n=12 a launch has only 32 blocks (a quarter of
// the SMs), and every block streams each 512x512 weight matrix from L2
// (512 KB in bf16), so the bf16 path is bound by per-SM L2 bandwidth and
// latency, the f32 path by per-SM FMA issue.  wgmma with TMA-fed weight
// tiles shared across a cluster, and more blocks per launch, are next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 24;       // valid rows per tile: 2 scenes of 12 or 1 of 21
constexpr int kMaxScenes = 4;   // scenes per tile (bounds the reduction buffer)
constexpr int kPad = 8;         // shared-memory row padding (elements): no ldmatrix bank conflicts

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float2 ldg2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

struct ChainArgs {
  const void* x;        // (M, C)
  const void* skip[2];  // per block: (M, C) or null
  const void* film[2];  // per block: (B, 2C) scene rows, (M, 2C) rows, or null
  const void* W;        // (nW, C, C): f32 (in, out); bf16 packed by pack_mma_weights
  const float* V;       // (nV, C) f32: b1, g1s, g1b, b2, g2s, g2b [, bres]
  void* out;            // (M, C)
  int B, n, C, groups, ts, nblocks;
  int spec[2];          // bit 0 has_skip, bits 1-2 film (0 none, 1 scene, 2 row), bit 3 res proj
  float eps;
};

// Copy `rows` rows of a row-major (., C) array into a tile_rows x lda smem
// tile, zero-filling the other rows.  16-byte vectors.
template <typename T>
__device__ void load_tile(T* dst, int lda, const T* src, int rows, int tile_rows, int C) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = C / kVec;
  for (int i = threadIdx.x; i < tile_rows * per_row; i += blockDim.x) {
    const int r = i / per_row, v = i % per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = reinterpret_cast<const uint4*>(src + (size_t)r * C)[v];
    reinterpret_cast<uint4*>(dst + r * lda)[v] = val;
  }
}

template <typename T>
__device__ void store_tile(T* dst, const T* src, int lda, int rows, int C) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = C / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, v = i % per_row;
    reinterpret_cast<uint4*>(dst + (size_t)r * C)[v] = reinterpret_cast<const uint4*>(src + r * lda)[v];
  }
}

// ---------------------------------------------------------------------------
// float32: FMA products.  Thread t owns columns 2t, 2t+1 of all kTileRows rows.
// ---------------------------------------------------------------------------
struct MmF32 {
  static constexpr int kTileRows = kRows;
  float v[kTileRows][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) v[r][0] = v[r][1] = 0.f;
  }

  // v += A[0:kTileRows, :] @ W[:, col:col+2]; A in smem (stride lda), W (C, C) (in, out)
  __device__ __forceinline__ void mma(const float* __restrict__ A, int lda,
                                      const float* __restrict__ W, int C) {
    const int col = 2 * threadIdx.x;
    const float* wp = W + col;
    // the next four weight rows are fetched while the current four are used
    float2 n0 = Io<float>::ldg2(wp), n1 = Io<float>::ldg2(wp + C);
    float2 n2 = Io<float>::ldg2(wp + 2 * C), n3 = Io<float>::ldg2(wp + 3 * C);
#pragma unroll 1
    for (int k = 0; k < C; k += 4) {
      const float2 w0 = n0, w1 = n1, w2 = n2, w3 = n3;
      if (k + 4 < C) {
        const float* p = wp + (size_t)(k + 4) * C;
        n0 = Io<float>::ldg2(p);
        n1 = Io<float>::ldg2(p + C);
        n2 = Io<float>::ldg2(p + 2 * C);
        n3 = Io<float>::ldg2(p + 3 * C);
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 a = Io<float>::ld4(A + r * lda + k);
        float s0 = v[r][0], s1 = v[r][1];
        s0 = fmaf(a.x, w0.x, s0); s1 = fmaf(a.x, w0.y, s1);
        s0 = fmaf(a.y, w1.x, s0); s1 = fmaf(a.y, w1.y, s1);
        s0 = fmaf(a.z, w2.x, s0); s1 = fmaf(a.z, w2.y, s1);
        s0 = fmaf(a.w, w3.x, s0); s1 = fmaf(a.w, w3.y, s1);
        v[r][0] = s0; v[r][1] = s1;
      }
    }
  }

  // Z = round(v + bias)
  __device__ __forceinline__ void store_bias(float* Z, int lda, const float* bias) const {
    const int col = 2 * threadIdx.x;
    const float bx = bias[col], by = bias[col + 1];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) Io<float>::st2(Z + r * lda + col, v[r][0] + bx, v[r][1] + by);
  }

  // X = Z2 + round(v + bres)
  __device__ __forceinline__ void store_residual(float* X, const float* Z2, int lda,
                                                 const float* bres) const {
    const int col = 2 * threadIdx.x;
    const float bx = bres[col], by = bres[col + 1];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float2 z = Io<float>::ld2(Z2 + r * lda + col);
      Io<float>::st2(X + r * lda + col, z.x + (v[r][0] + bx), z.y + (v[r][1] + by));
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16: tensor-core products.  Warp w owns columns [64w, 64w + 64) of the
// 32-row tile: 2 (m16) x 8 (n8) accumulator tiles of mma.m16n8k16.
// ---------------------------------------------------------------------------
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

struct MmBf16 {
  static constexpr int kTileRows = 32;
  float v[2][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[m][j][0] = v[m][j][1] = v[m][j][2] = v[m][j][3] = 0.f;
  }

  // v += A[0:32, :] @ W[:, n0:n0+64], n0 = 64 * warp.  Wp is the packed
  // weight: (C_out, C_in), each 16-wide k block ordered so that lane (g, t)
  // finds its B fragment {k = 2t, 2t+1, 2t+8, 2t+9} as 8 contiguous bytes.
  __device__ __forceinline__ void mma(const __nv_bfloat16* __restrict__ A, int lda,
                                      const __nv_bfloat16* __restrict__ Wp, int C) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* wb = Wp + (size_t)(64 * warp + g) * C + 4 * t;
    const size_t jstride = (size_t)8 * C;
    const __nv_bfloat16* ab = A + (lane & 15) * lda + (lane >> 4) * 8;
    const int ksteps = C / 16;
    uint2 b0[8], b1[8], b2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b0[j] = __ldg(reinterpret_cast<const uint2*>(wb + j * jstride));
      b1[j] = ksteps > 1 ? __ldg(reinterpret_cast<const uint2*>(wb + j * jstride + 16)) : b0[j];
    }
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      if (ks + 2 < ksteps) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b2[j] = __ldg(reinterpret_cast<const uint2*>(wb + j * jstride + (ks + 2) * 16));
      }
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, ab + ks * 16);
      ldmatrix_x4(a1, ab + 16 * lda + ks * 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_bf16(v[0][j], a0, b0[j].x, b0[j].y);
        mma_bf16(v[1][j], a1, b0[j].x, b0[j].y);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b0[j] = b1[j];
        b1[j] = b2[j];
      }
    }
  }

  // Accumulator (m, j, i) sits at row 16m + g (+8 for i >= 2), column
  // 64 * warp + 8j + 2t (+1 for odd i).
  __device__ __forceinline__ void store_bias(__nv_bfloat16* Z, int lda, const float* bias) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * warp + 8 * j + 2 * t;
      const float bx = bias[col], by = bias[col + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 16 * m + g;
        Io<__nv_bfloat16>::st2(Z + r * lda + col, v[m][j][0] + bx, v[m][j][1] + by);
        Io<__nv_bfloat16>::st2(Z + (r + 8) * lda + col, v[m][j][2] + bx, v[m][j][3] + by);
      }
    }
  }

  __device__ __forceinline__ void store_residual(__nv_bfloat16* X, const __nv_bfloat16* Z2,
                                                 int lda, const float* bres) const {
    using Io16 = Io<__nv_bfloat16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * warp + 8 * j + 2 * t;
      const float bx = bres[col], by = bres[col + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + g + 8 * h;
          const float2 z = Io16::ld2(Z2 + r * lda + col);
          Io16::st2(X + r * lda + col, z.x + Io16::rnd(v[m][j][2 * h] + bx),
                    z.y + Io16::rnd(v[m][j][2 * h + 1] + by));
        }
      }
    }
  }
};

template <typename T>
struct Mm;
template <>
struct Mm<float> {
  using type = MmF32;
};
template <>
struct Mm<__nv_bfloat16> {
  using type = MmBf16;
};

__device__ __forceinline__ float silu(float z) { return z * (1.f / (1.f + expf(-z))); }

// In place on the tile Z (compute dtype): GroupNorm with per-scene f32
// moments over (n rows x C/groups channels), the affine folded into per-scene
// coefficients a, b; scene-FiLM folded into a, b, or row-FiLM applied after;
// then SiLU.  Thread t owns columns 2t, 2t+1.  red: [2][ts][nthreads]
// partial sums, stat: [2][ts][groups].
template <typename T>
__device__ void gn_film_silu(T* Z, int lda, const ChainArgs& args, const float* scale,
                             const float* bias, int film_kind, const T* film, int scene0,
                             int nsc, float* red, float* stat) {
  const int C = args.C, n = args.n, ts = args.ts, groups = args.groups;
  const int tid = threadIdx.x, nthr = blockDim.x, col = 2 * tid;
  // 1. per-thread partial moments of its two columns, per scene
  for (int s = 0; s < nsc; ++s) {
    float sum = 0.f, sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float2 v = Io<T>::ld2(Z + (s * n + i) * lda + col);
      sum += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
    red[s * nthr + tid] = sum;
    red[(ts + s) * nthr + tid] = sq;
  }
  __syncthreads();
  // 2. per (scene, group) moments, summed over the group's threads in order
  const int gs = C / groups, tpg = gs / 2;
  for (int idx = tid; idx < nsc * groups; idx += nthr) {
    const int s = idx / groups, g = idx % groups;
    float sum = 0.f, sq = 0.f;
    for (int t = g * tpg; t < (g + 1) * tpg; ++t) {
      sum += red[s * nthr + t];
      sq += red[(ts + s) * nthr + t];
    }
    const float denom = 1.f / (float)(n * gs);
    const float mean = sum * denom;
    // one-pass variance can cancel slightly negative: clamp at 0
    const float var = fmaxf(sq * denom - mean * mean, 0.f);
    stat[s * groups + g] = mean;
    stat[(ts + s) * groups + g] = rsqrtf(var + args.eps);
  }
  __syncthreads();
  // 3. apply: z * a + b (+ row FiLM), SiLU, all rounded to the compute dtype
  const int g = col / gs;
  const float sc0 = scale[col], sc1 = scale[col + 1];
  const float bi0 = bias[col], bi1 = bias[col + 1];
  for (int s = 0; s < nsc; ++s) {
    const float mean = stat[s * groups + g], inv = stat[(ts + s) * groups + g];
    float a0 = inv * sc0, a1 = inv * sc1;
    float b0 = bi0 - mean * inv * sc0, b1 = bi1 - mean * inv * sc1;
    if (film_kind == 1) {
      const T* f = film + (size_t)(scene0 + s) * 2 * C;
      const float2 fs = Io<T>::ld2(f + col);
      const float2 fb = Io<T>::ld2(f + C + col);
      const float fs0 = fs.x + 1.f, fs1 = fs.y + 1.f;
      a0 *= fs0; a1 *= fs1;
      b0 = b0 * fs0 + fb.x; b1 = b1 * fs1 + fb.y;
    }
    a0 = Io<T>::rnd(a0); a1 = Io<T>::rnd(a1);
    b0 = Io<T>::rnd(b0); b1 = Io<T>::rnd(b1);
    for (int i = 0; i < n; ++i) {
      const int r = s * n + i;
      const float2 v = Io<T>::ld2(Z + r * lda + col);
      float z0 = Io<T>::rnd(Io<T>::rnd(v.x * a0) + b0);
      float z1 = Io<T>::rnd(Io<T>::rnd(v.y * a1) + b1);
      if (film_kind == 2) {
        const T* f = film + ((size_t)scene0 * n + r) * 2 * C;
        const float2 fs = Io<T>::ld2(f + col);
        const float2 fb = Io<T>::ld2(f + C + col);
        z0 = Io<T>::rnd(Io<T>::rnd(z0 * Io<T>::rnd(fs.x + 1.f)) + fb.x);
        z1 = Io<T>::rnd(Io<T>::rnd(z1 * Io<T>::rnd(fs.y + 1.f)) + fb.y);
      }
      Io<T>::st2(Z + r * lda + col, silu(z0), silu(z1));
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(256) fused_chain_kernel(ChainArgs args) {
  using M = typename Mm<T>::type;
  constexpr int kTile = M::kTileRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = args.C, n = args.n, ts = args.ts;
  const int lda = C + kPad;
  const int tid = threadIdx.x, nthr = blockDim.x, col = 2 * tid;
  T* X = reinterpret_cast<T*>(smem);   // chain activation (block input, then output)
  T* S = X + kTile * lda;              // skip rows of the current block
  T* Z = S + kTile * lda;              // block1 intermediate
  T* Z2 = Z + kTile * lda;             // block2 intermediate
  float* red = reinterpret_cast<float*>(Z2 + kTile * lda);  // [2][ts][nthr]
  float* stat = red + 2 * ts * nthr;                        // [2][ts][groups]

  const int scene0 = blockIdx.x * ts;
  const int nsc = min(ts, args.B - scene0);  // the last tile may be ragged
  const int rows = nsc * n;
  const size_t row0 = (size_t)scene0 * n;

  load_tile<T>(X, lda, static_cast<const T*>(args.x) + row0 * C, rows, kTile, C);
  __syncthreads();

  const T* W = static_cast<const T*>(args.W);
  const float* V = args.V;
  const size_t CC = (size_t)C * C;
  int wi = 0, vi = 0;
  M acc;
  for (int bi = 0; bi < args.nblocks; ++bi) {
    const int spec = args.spec[bi];
    const bool has_skip = spec & 1;
    const int film_kind = (spec >> 1) & 3;
    const bool has_res = (spec >> 3) & 1;
    const T* film = static_cast<const T*>(args.film[bi]);
    if (has_skip) {
      load_tile<T>(S, lda, static_cast<const T*>(args.skip[bi]) + row0 * C, rows, kTile, C);
      __syncthreads();
    }
    const float* b1 = V + (size_t)vi * C;

    // block1: dense (split matmuls over the implicit skip concat)
    acc.zero();
    acc.mma(X, lda, W + wi * CC, C);
    int wj = wi + 1;
    if (has_skip) acc.mma(S, lda, W + (wj++) * CC, C);
    acc.store_bias(Z, lda, b1);
    __syncthreads();
    gn_film_silu<T>(Z, lda, args, b1 + C, b1 + 2 * C, film_kind, film, scene0, nsc, red, stat);

    // block2
    acc.zero();
    acc.mma(Z, lda, W + (wj++) * CC, C);
    acc.store_bias(Z2, lda, b1 + 3 * C);
    __syncthreads();
    gn_film_silu<T>(Z2, lda, args, b1 + 4 * C, b1 + 5 * C, 0, nullptr, scene0, nsc, red, stat);

    // residual
    if (has_res) {
      acc.zero();
      acc.mma(X, lda, W + (wj++) * CC, C);
      if (has_skip) acc.mma(S, lda, W + (wj++) * CC, C);
      __syncthreads();  // every thread is done reading X
      acc.store_residual(X, Z2, lda, b1 + 6 * C);
    } else {
      for (int r = 0; r < kTile; ++r) {
        const float2 z = Io<T>::ld2(Z2 + r * lda + col);
        const float2 x = Io<T>::ld2(X + r * lda + col);
        Io<T>::st2(X + r * lda + col, z.x + x.x, z.y + x.y);
      }
    }
    __syncthreads();
    wi = wj;
    vi += has_res ? 7 : 6;
  }
  store_tile<T>(static_cast<T*>(args.out) + row0 * C, X, lda, rows, C);
}

template <typename T>
int launch(const ChainArgs& args, cudaStream_t stream) {
  constexpr int kTile = Mm<T>::type::kTileRows;
  const int threads = args.C / 2;
  const size_t smem = 4 * (size_t)kTile * (args.C + kPad) * sizeof(T) +
                      (2 * (size_t)args.ts * threads + 2 * (size_t)args.ts * args.groups) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (args.B + args.ts - 1) / args.ts;
  fused_chain_kernel<T><<<grid, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_chain_max_rows() { return kRows; }
int fused_chain_max_channels() { return 512; }

// dtype: 0 float32, 1 bfloat16 (W packed by pack_mma_weights).  Returns a
// cudaError_t code (0 on success), or -1 for arguments the kernel does not take.
int fused_chain_launch(int dtype, const void* x, const void* skip0, const void* skip1,
                       const void* film0, const void* film1, const void* W, const float* V,
                       void* out, int B, int n, int C, int groups, float eps, int nblocks,
                       int spec0, int spec1, void* stream) {
  if (n < 1 || n > kRows || C % 64 != 0 || C > 512 || groups < 1 || C % groups != 0 ||
      (C / groups) % 2 != 0 || nblocks < 1 || nblocks > 2 || B < 1)
    return -1;
  ChainArgs args;
  args.x = x;
  args.skip[0] = skip0;
  args.skip[1] = skip1;
  args.film[0] = film0;
  args.film[1] = film1;
  args.W = W;
  args.V = V;
  args.out = out;
  args.B = B;
  args.n = n;
  args.C = C;
  args.groups = groups;
  args.ts = kRows / n < kMaxScenes ? kRows / n : kMaxScenes;
  args.nblocks = nblocks;
  args.spec[0] = spec0;
  args.spec[1] = spec1;
  args.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, s);
  if (dtype == 1) return launch<__nv_bfloat16>(args, s);
  return -1;
}

}  // extern "C"
