// One ResnetBlock on flat (B*n, C_in) rows, for sm_90a.
//
// Replaces the Pallas kernel diffuscene_tpu/ops/fused_resblock.py:_resblock_kernel
// (with _groupnorm).  One launch runs
//
//     h   = [x | skip] @ W1 + b1                     f32, never rounded
//     h   = GroupNorm(h)                              per scene, one-pass f32 moments
//     h   = silu(h * (round(film_s) + 1) + film_b)    film rows: none, per scene, per row
//     h   = round_to_compute(h) @ W2 + b2             f32
//     h   = silu(GroupNorm(h))
//     out = round(h + ([x | skip] @ Wres + bres  or  x))
//
// in float32 or bfloat16, with B1's roundings (and not the chain kernel's):
// the dense output stays f32 up to its moments, the GroupNorm is
// (h - mean) * rsqrt(E[h^2] - mean^2 + eps) * scale + bias without a clamp,
// FiLM and SiLU run in f32, and h is rounded to the compute dtype only as the
// second product's operand.  The skip concat is never built: W1 and Wres are
// split into their x and skip rows.
//
// Design.  As in fused_chain.cu, a thread block owns a tile of whole scenes
// (2 of 12 rows or 1 of 21), so every scene's GroupNorm moments reduce in
// shared memory in a fixed order.  The x and skip tiles and the f32
// intermediate stay in shared memory for the whole block; only x, skip,
// film, the weights and the output touch device memory.  bfloat16 products
// run on the tensor cores (mma.sync m16n8k16, f32 accumulation, tile padded
// to 32 rows, warp w owns output columns [64w, 64w + 64), A by ldmatrix from
// shared memory, B fragments from device memory in the packed order of
// pack_mma_weights); float32 products run on the FMA pipes in full f32
// (thread t owns output columns 2t, 2t+1 of all 24 rows).
//
// What bounds it.  One flagship block is 0.8-2.0 GFLOP at B=64, N=12
// (two or three (768, 512-1024) x (., 512) products), 1-2 us at the bf16
// tensor-core peak; the weights (0.5-1.5 MB) and activations (1.5-3 MB) take
// about as long at the HBM rate.  At B=64 a launch has only 32 blocks, each
// streaming every weight matrix from L2, so like the chain kernel it is bound
// by per-SM L2 bandwidth and latency; wgmma with weight tiles shared across
// a cluster, and more blocks per launch, are the next steps.
#include "tile_mma.cuh"

namespace {

constexpr int kRows = 24;       // valid rows per tile: 2 scenes of 12 or 1 of 21
constexpr int kMaxScenes = 4;   // scenes per tile (bounds the reduction buffer)
constexpr int kPad = 8;         // shared-memory row padding (elements)
constexpr int kMaxIn = 1024;    // x and skip widths together

using bf16 = __nv_bfloat16;

struct Args {
  const void* x;      // (M, kx)
  const void* skip;   // (M, ks) or null
  const void* film;   // (B, 2C) per scene, (M, 2C) per row, or null
  const void* W1;     // f32: (kx + ks, C) (in, out); bf16: packed x rows, then packed skip rows
  const void* W2;     // f32: (C, C); bf16: packed
  const void* Wres;   // like W1, or null (identity residual)
  const float* V;     // (7, C) f32: b1, g1 scale, g1 bias, b2, g2 scale, g2 bias, bres
  void* out;          // (M, C)
  int B, n, C, kx, ks, groups, ts, film_kind;  // film_kind: 0 none, 1 per scene, 2 per row
  float eps;
};

// The block's product: accumulators for its output tile and a visitor that
// hands each thread's pairs of adjacent output columns to a functor.
template <typename T>
struct Prod;

template <>
struct Prod<bf16> {
  static constexpr int kTile = 32;
  float acc[2][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  }
  __device__ __forceinline__ void mm(const bf16* A, int lda, const void* W, int K, int /*C*/) {
    tile::warp_mma<8>(acc, A, lda, static_cast<const bf16*>(W), K, 64 * (threadIdx.x >> 5));
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * warp + 8 * j + 2 * t;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        f(16 * m + g, col, acc[m][j][0], acc[m][j][1]);
        f(16 * m + g + 8, col, acc[m][j][2], acc[m][j][3]);
      }
    }
  }
};

template <>
struct Prod<float> {
  static constexpr int kTile = kRows;
  float acc[kRows][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  }
  __device__ __forceinline__ void mm(const float* A, int lda, const void* W, int K, int C) {
    tile::fma_mm<kRows>(acc, A, lda, static_cast<const float*>(W), C, K, 2 * threadIdx.x);
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) f(r, 2 * threadIdx.x, acc[r][0], acc[r][1]);
  }
};

// GroupNorm over the f32 tile H (per scene: its n rows and the group's
// channels), then FiLM and SiLU, in f32.  The result goes to `dst` (stride
// ldd, rounded to D), which may be H itself.  Thread t owns columns 2t, 2t+1.
// red: [2][ts][nthreads] partial sums, stat: [2][ts][groups].
template <typename T, typename D>
__device__ void gn_film_silu(const float* H, int ldh, D* dst, int ldd, const Args& a,
                             const float* scale, const float* bias, int film_kind, const T* film,
                             int scene0, int nsc, float* red, float* stat) {
  const int C = a.C, n = a.n, ts = a.ts, groups = a.groups;
  const int tid = threadIdx.x, nthr = blockDim.x, col = 2 * tid;
  for (int s = 0; s < nsc; ++s) {
    float sum = 0.f, sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(H + (s * n + i) * ldh + col);
      sum += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
    red[s * nthr + tid] = sum;
    red[(ts + s) * nthr + tid] = sq;
  }
  __syncthreads();
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
    stat[s * groups + g] = mean;
    // B1's one-pass variance, without a clamp (fused_resblock.py:76-81)
    stat[(ts + s) * groups + g] = rsqrtf(sq * denom - mean * mean + a.eps);
  }
  __syncthreads();
  const int g = col / gs;
  const float sc0 = scale[col], sc1 = scale[col + 1];
  const float bi0 = bias[col], bi1 = bias[col + 1];
  for (int s = 0; s < nsc; ++s) {
    const float mean = stat[s * groups + g], inv = stat[(ts + s) * groups + g];
    float fs0 = 1.f, fs1 = 1.f, fb0 = 0.f, fb1 = 0.f;
    if (film_kind == 1) {
      const T* f = film + (size_t)(scene0 + s) * 2 * C;
      const float2 fs = tile::ld2<T>(f + col), fb = tile::ld2<T>(f + C + col);
      fs0 = tile::rnd<T>(fs.x + 1.f); fs1 = tile::rnd<T>(fs.y + 1.f);
      fb0 = fb.x; fb1 = fb.y;
    }
    for (int i = 0; i < n; ++i) {
      const int r = s * n + i;
      const float2 v = *reinterpret_cast<const float2*>(H + r * ldh + col);
      float z0 = (v.x - mean) * inv * sc0 + bi0;
      float z1 = (v.y - mean) * inv * sc1 + bi1;
      if (film_kind == 2) {
        const T* f = film + ((size_t)scene0 * n + r) * 2 * C;
        const float2 fs = tile::ld2<T>(f + col), fb = tile::ld2<T>(f + C + col);
        fs0 = tile::rnd<T>(fs.x + 1.f); fs1 = tile::rnd<T>(fs.y + 1.f);
        fb0 = fb.x; fb1 = fb.y;
      }
      if (film_kind != 0) {
        z0 = z0 * fs0 + fb0;
        z1 = z1 * fs1 + fb1;
      }
      tile::st2<D>(dst + r * ldd + col, tile::silu(z0), tile::silu(z1));
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(256) resblock_kernel(Args a) {
  using P = Prod<T>;
  constexpr int kTile = P::kTile;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, n = a.n, ts = a.ts, kx = a.kx, ks = a.ks;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ldx = kx + kPad, lds = ks + kPad, ldh = C + 4, ldb = C + kPad;

  T* X = reinterpret_cast<T*>(smem);                   // x tile
  T* S = X + kTile * ldx;                              // skip tile (ks > 0)
  float* H = reinterpret_cast<float*>(S + (ks ? kTile * lds : 0));  // f32 intermediate
  bf16* Hb = reinterpret_cast<bf16*>(H + kTile * ldh);  // bf16: the second product's operand
  float* red = reinterpret_cast<float*>(Hb + (kBf16 ? kTile * ldb : 0));
  float* stat = red + 2 * ts * nthr;

  const int scene0 = blockIdx.x * ts;
  const int nsc = min(ts, a.B - scene0);  // the last tile may be ragged
  const int rows = nsc * n;
  const size_t row0 = (size_t)scene0 * n;
  const float* V = a.V;
  const T* film = static_cast<const T*>(a.film);
  T* out = static_cast<T*>(a.out) + row0 * C;

  tile::load_rows<T>(X, ldx, static_cast<const T*>(a.x) + row0 * kx, kx, rows, kTile, kx);
  if (ks) tile::load_rows<T>(S, lds, static_cast<const T*>(a.skip) + row0 * ks, ks, rows, kTile, ks);
  if constexpr (kBf16) {  // the padded rows of the second product's operand
    for (int i = tid; i < (kTile - rows) * C; i += nthr)
      Hb[(rows + i / C) * ldb + i % C] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // block1: h = [x | skip] @ W1 + b1, kept in f32
  P p;
  p.zero();
  p.mm(X, ldx, a.W1, kx, C);
  if (ks) p.mm(S, lds, static_cast<const T*>(a.W1) + (size_t)C * kx, ks, C);
  p.each([&](int r, int c, float v0, float v1) {
    tile::st2<float>(H + r * ldh + c, v0 + V[c], v1 + V[c + 1]);
  });
  __syncthreads();
  if constexpr (kBf16)
    gn_film_silu<T, bf16>(H, ldh, Hb, ldb, a, V + C, V + 2 * C, a.film_kind, film, scene0, nsc,
                          red, stat);
  else
    gn_film_silu<T, float>(H, ldh, H, ldh, a, V + C, V + 2 * C, a.film_kind, film, scene0, nsc,
                           red, stat);

  // block2: h = round(h) @ W2 + b2, GroupNorm, SiLU
  p.zero();
  if constexpr (kBf16)
    p.mm(Hb, ldb, a.W2, C, C);
  else
    p.mm(H, ldh, a.W2, C, C);
  __syncthreads();  // every thread is done reading H
  p.each([&](int r, int c, float v0, float v1) {
    tile::st2<float>(H + r * ldh + c, v0 + V[3 * C + c], v1 + V[3 * C + c + 1]);
  });
  __syncthreads();
  gn_film_silu<T, float>(H, ldh, H, ldh, a, V + 4 * C, V + 5 * C, 0, film, scene0, nsc, red, stat);

  // residual and store
  if (a.Wres) {
    p.zero();
    p.mm(X, ldx, a.Wres, kx, C);
    if (ks) p.mm(S, lds, static_cast<const T*>(a.Wres) + (size_t)C * kx, ks, C);
    const float* bres = V + 6 * C;
    p.each([&](int r, int c, float v0, float v1) {
      if (r >= rows) return;
      const float2 h = *reinterpret_cast<const float2*>(H + r * ldh + c);
      tile::st2<T>(out + (size_t)r * C + c, h.x + (v0 + bres[c]), h.y + (v1 + bres[c + 1]));
    });
  } else {
    for (int i = tid; i < rows * (C / 2); i += nthr) {
      const int r = i / (C / 2), c = 2 * (i % (C / 2));
      const float2 h = *reinterpret_cast<const float2*>(H + r * ldh + c);
      const float2 x = tile::ld2<T>(X + r * ldx + c);
      tile::st2<T>(out + (size_t)r * C + c, h.x + x.x, h.y + x.y);
    }
  }
}

template <typename T>
size_t smem_bytes(const Args& a, int threads) {
  constexpr int kTile = Prod<T>::kTile;
  size_t b = (size_t)kTile * (a.kx + kPad) * sizeof(T);
  if (a.ks) b += (size_t)kTile * (a.ks + kPad) * sizeof(T);
  b += (size_t)kTile * (a.C + 4) * sizeof(float);
  if (sizeof(T) == 2) b += (size_t)kTile * (a.C + kPad) * sizeof(bf16);
  return b + (2 * (size_t)a.ts * threads + 2 * (size_t)a.ts * a.groups) * sizeof(float);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = a.C / 2;
  const size_t smem = smem_bytes<T>(a, threads);
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.B + a.ts - 1) / a.ts;
  resblock_kernel<T><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_resblock_max_rows() { return kRows; }
int fused_resblock_max_in() { return kMaxIn; }

// dtype: 0 float32, 1 bfloat16 (weights packed by pack_mma_weights).
// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take.
int fused_resblock_launch(int dtype, const void* x, const void* skip, const void* film,
                          int film_kind, const void* W1, const void* W2, const void* Wres,
                          const float* V, void* out, int B, int n, int C, int kx, int ks,
                          int groups, float eps, void* stream) {
  if (n < 1 || n > kRows || B < 1 || C % 64 != 0 || C > 512 || groups < 1 || C % groups != 0 ||
      (C / groups) % 2 != 0 || kx < 16 || kx % 16 != 0 || ks < 0 || ks % 16 != 0 ||
      kx + ks > kMaxIn || (ks > 0) != (skip != nullptr) || film_kind < 0 || film_kind > 2 ||
      (film_kind != 0) != (film != nullptr) || (Wres == nullptr && (kx != C || ks != 0)))
    return -1;
  Args a;
  a.x = x;
  a.skip = skip;
  a.film = film;
  a.W1 = W1;
  a.W2 = W2;
  a.Wres = Wres;
  a.V = V;
  a.out = out;
  a.B = B;
  a.n = n;
  a.C = C;
  a.kx = kx;
  a.ks = ks;
  a.groups = groups;
  a.ts = kRows / n < kMaxScenes ? kRows / n : kMaxScenes;
  a.film_kind = film_kind;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<bf16>(a, s);
  return -1;
}

}  // extern "C"
