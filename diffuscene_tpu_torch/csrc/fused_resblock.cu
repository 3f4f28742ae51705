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
// bfloat16 (the serving dtype; resblock_sm90): C = 512 in 8 GroupNorm groups
// of 64 channels.  A scene tile (at most 64 rows: 5 scenes of 12, 3 of 21;
// always the most whole scenes that fit, since every CTA runs the same K
// loop whatever its rows) is one thread-block cluster of 8 CTAs, and CTA g
// owns output columns [64g, 64g + 64) of both products, so each GroupNorm is
// CTA-local: a scene's group is its n rows x the CTA's own 64 columns, and
// the moments reduce in shared memory in a fixed order.  At B=64 that is 13
// clusters (104 CTAs) for n=12 and 22 (176 CTAs) for n=21.  In a CTA:
//
// - one producer warp brings in the [x | skip] tile, each CTA of the
//   cluster loading every 8th row once into all 8 (bulk copies multicast to
//   the cluster), and this CTA's 64 columns of the 7 vectors; then it
//   streams the CTA's weight chunks (64 deep x 64 columns, packed by the
//   wrapper in the wgmma B layout, see sm90.cuh) through a ring of 4 (C_in
//   512) or 8 (C_in 1024) stages by cp.async.bulk with mbarriers: W1 and
//   Wres chunks of each K tile in turn, then W2's;
// - one consumer warpgroup runs the products on wgmma m64n64k16 (A from the
//   shared tile by ldmatrix, B from the ring), two K tiles a group: W1 and
//   the residual projection share one K loop with two accumulators; an
//   identity residual keeps its 64-column slice of x in that second
//   accumulator;
// - after GN1, FiLM and SiLU each CTA writes its bf16 (rows x 64) slice of h
//   into its place in the gathered operand G (the x tile's space) and, once
//   a cluster barrier says every CTA is done with its x tile, stores it into
//   the other 7 CTAs' G by st.async through distributed shared memory, each
//   slice completing on its own mbarrier there; block2 starts on the CTA's
//   own slice and takes each other slice as it lands.  A second cluster
//   barrier, waited on at the end, keeps every CTA alive until all slices
//   have landed.
//
// float32 (resblock_kernel<float>, for parity): as before, a thread block
// owns 2 scenes of 12 or 1 of 21, the f32 intermediate stays in shared
// memory, and the products run in full f32 on the FMA pipes (thread t owns
// output columns 2t, 2t+1 of all 24 rows).
//
// What bounds it.  One flagship block is 0.8-2.0 GFLOP at B=64, N=12, 1-2 us
// at the bf16 tensor-core peak, and needs 2-6 MB of device memory traffic.
// The kernel is bound by latency along each CTA's chain of phases: the x
// tile's arrival, the weight stream of block1 from L2 (each of the 13-22 row
// tiles reads every weight matrix, 13-33 MB a block at B=64), the
// epilogues on one warpgroup, and the exchange of h through distributed
// shared memory.  The next steps are a 2-D cluster (row tiles x groups) with each
// weight chunk multicast to the row tiles that share it, and launches that
// overlap one block's prologue with the previous block's tail.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxIn = 1024;    // x and skip widths together

// ---------------------------------------------------------------------------
// bfloat16: the cluster kernel
// ---------------------------------------------------------------------------

using sm90::kC;
using sm90::kCluster;
using sm90::kConsumers;
using sm90::kGroup;
using sm90::kThreads;
using sm90::kTileRows;
using sm90::hslice;
using sm90::silu_fast;
constexpr int kMaxStages = 8;

// shared-memory layout of resblock_sm90 for kin = kx + ks input columns
struct Layout {
  int stages;
  unsigned ring, x, v, red, stat, bars, total;
};

__host__ __device__ constexpr Layout layout(int kin) {
  Layout L{};
  L.stages = kin <= kC ? 4 : kMaxStages;
  L.ring = 0;                                                     // stages x 8 KB
  L.x = L.ring + L.stages * sm90::kChunkBytes;                    // [x | skip], later G
  L.v = L.x + kTileRows * ((kin > kC ? kin : kC) + 8) * 2;        // this CTA's 7 vectors
  L.red = L.v + 7 * kGroup * 4;                                   // row sums, squares
  L.stat = L.red + 2 * kTileRows * 4;                             // scene mean, rsqrt
  L.bars = L.stat + 2 * kTileRows * 4;                            // full, empty, x, slices
  L.total = L.bars + (2 * kMaxStages + 1 + kCluster) * 8;
  return L;
}

// The gathered h, G (sm90::hslice), lives in the x tile's space.
static_assert(kCluster * kTileRows * kGroup * 2 <= kTileRows * (kC + 8) * 2,
              "G fits in the x tile's space");

struct Args90 {
  const bf16* x;      // (M, kx)
  const bf16* skip;   // (M, ks) or null
  const bf16* film;   // (B, 2C) per scene, (M, 2C) per row, or null
  const bf16* W1;     // (8, (kx + ks) / 64, 64 x 64) chunks (pack_group_tiles)
  const bf16* W2;     // (8, 8, 64 x 64)
  const bf16* Wres;   // like W1, or null (identity residual)
  const float* V;     // (7, C) f32: b1, g1 scale, g1 bias, b2, g2 scale, g2 bias, bres
  bf16* out;          // (M, C)
  int B, n, kx, ks, ts, film_kind;
  float eps;
};

template <bool kRes>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    resblock_sm90(const Args90 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kin = a.kx + a.ks;
  const Layout L = layout(kin);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* X = reinterpret_cast<bf16*>(smem + L.x);
  bf16* G = X;                       // the gathered h, once the x tile is read
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;   // the x tile and the vectors
  uint64_t* gbar = xbar + 1;        // [q]: CTA q's slice of h has landed here

  const int grp = (int)cg::this_cluster().block_rank();   // GroupNorm group = column slice
  const int scene0 = (blockIdx.x / kCluster) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);             // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int ldx = kin + 8;
  const int nkt1 = kin / sm90::kChunkK, nkt2 = kC / sm90::kChunkK;
  const int stages = L.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = grp * kGroup;               // this CTA's first output column
  const uint32_t slice_bytes = rows * kGroup * 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_init(xbar, 1);
    for (int q = 0; q < kCluster; ++q) {
      sm90::mbar_init(&gbar[q], 1);
      if (q != grp) sm90::mbar_expect_tx(&gbar[q], slice_bytes);   // this CTA's own is local
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  if (warp == kConsumers / 32) {
    // ---- producer warp: the x tile and this CTA's vectors, then the weight chunks ----
    // Every CTA of the cluster reads the same x tile: CTA g loads rows g,
    // g + 8, ... once from device memory into all 8 CTAs (multicast).
    if (lane == 0) sm90::mbar_expect_tx(xbar, (uint32_t)(rows * kin * 2 + 7 * kGroup * 4));
    __syncwarp();
    if (lane < 7) sm90::bulk_load(Vs + lane * kGroup, a.V + lane * kC + col0, kGroup * 4, xbar);
    for (int r = grp + kCluster * lane; r < rows; r += kCluster * 32) {
      sm90::bulk_load_multicast(X + r * ldx, a.x + (row0 + r) * a.kx, a.kx * 2, xbar, 0xff);
      if (a.ks)
        sm90::bulk_load_multicast(X + r * ldx + a.kx, a.skip + (row0 + r) * a.ks, a.ks * 2, xbar,
                                  0xff);
    }
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      auto put = [&](const bf16* src) {
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_expect_tx(&full[s], sm90::kChunkBytes);
        sm90::bulk_load(ring + s * sm90::kChunkElems, src, sm90::kChunkBytes, &full[s]);
        if (++s == stages) s = 0, ph ^= 1;
      };
      const bf16* w1 = a.W1 + (size_t)grp * nkt1 * sm90::kChunkElems;
      const bf16* wr = kRes ? a.Wres + (size_t)grp * nkt1 * sm90::kChunkElems : nullptr;
      for (int kt = 0; kt < nkt1; ++kt) {
        put(w1 + (size_t)kt * sm90::kChunkElems);
        if (kRes) put(wr + (size_t)kt * sm90::kChunkElems);
      }
      sm90::cluster_arrive_relaxed();      // (1) before W2, which waits on the second product
      // W2's K tiles in the order block2 takes the slices: this CTA's first
      const bf16* w2 = a.W2 + (size_t)grp * nkt2 * sm90::kChunkElems;
      for (int kt = 0; kt < nkt2; ++kt)
        put(w2 + (size_t)((grp + kt) % kCluster) * sm90::kChunkElems);
    } else {
      sm90::cluster_arrive_relaxed();      // (1)
    }
    sm90::cluster_wait();          // (1)
    sm90::cluster_arrive_relaxed();        // (2)
    sm90::cluster_wait();          // (2)
    return;
  }

  // ---- consumer warpgroup ----
  const int t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);    // this thread's rows: r0, r0 + 8
  // this thread's film scale and shift pairs, loaded now, used after block1
  uint32_t fsc[2][8], fsh[2][8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = min(r0 + 8 * half, rows - 1);
    const bf16* f = a.film_kind == 1 ? a.film + (size_t)(scene0 + r / a.n) * 2 * kC
                                     : a.film + (row0 + r) * 2 * kC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      fsc[half][j] = a.film_kind ? *reinterpret_cast<const uint32_t*>(f + c) : 0u;
      fsh[half][j] = a.film_kind ? *reinterpret_cast<const uint32_t*>(f + kC + c) : 0u;
    }
  }
  float acc[32], accR[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;

  // block1: h = [x | skip] @ W1 + b1 (and the residual projection), f32
  sm90::mbar_wait(xbar, 0);
  sm90::consume<kRes, false>(acc, accR, X, ldx, nkt1, ring, full, empty, stages, s, ph);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += Vs[8 * (i / 4) + 2 * t + (i & 1)];
  if constexpr (!kRes) {   // the identity residual: this CTA's slice of x
#pragma unroll
    for (int i = 0; i < 32; ++i)
      accR[i] = __bfloat162float(X[(r0 + 8 * ((i >> 1) & 1)) * ldx + col0 + 8 * (i / 4) + 2 * t +
                                   (i & 1)]);
  }
  // (1) the x tile is read: the others may write h into it.  Release, so
  // that the loads of the identity residual above are ordered before
  // the peers' stores into the same bytes
  sm90::cluster_arrive();
  sm90::scene_moments<false>(acc, a.n, nsc, a.eps, red, stat);

  // GN1, FiLM, SiLU; this CTA's bf16 slice of h into its place in G
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r < rows) {
      const int sc = r / a.n;
      const float mean = stat[sc], inv = stat[kTileRows + sc];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        float z0 = (acc[4 * j + 2 * half] - mean) * inv * Vs[kGroup + c] + Vs[2 * kGroup + c];
        float z1 =
            (acc[4 * j + 2 * half + 1] - mean) * inv * Vs[kGroup + c + 1] + Vs[2 * kGroup + c + 1];
        if (a.film_kind) {   // a bf16 pair: the low half is the first element
          z0 = z0 * tile::rnd<bf16>(__uint_as_float(fsc[half][j] << 16) + 1.f) +
               __uint_as_float(fsh[half][j] << 16);
          z1 = z1 * tile::rnd<bf16>(__uint_as_float(fsc[half][j] & 0xffff0000u) + 1.f) +
               __uint_as_float(fsh[half][j] & 0xffff0000u);
        }
        tile::st2<bf16>(G + hslice(grp, r, j) + 2 * t, silu_fast(z0), silu_fast(z1));
      }
    }
  }

  // the exchange: every consumer thread stores 16-byte pieces of this slice
  // into the other CTAs' G (st.async, each completing on the receiving CTA's
  // barrier for this slice), once every CTA of the cluster is done with its
  // x tile
  sm90::bar_sync<kConsumers>(1);
  sm90::cluster_wait();            // (1)
  sm90::send_slice(G, grp, rows, gbar);

  // block2: h = round(h) @ W2 + b2, from this CTA's slice on, each other one
  // as it lands; then GroupNorm, SiLU, the residual, the store
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sm90::consume<false, true>(acc, accR, G, 0, nkt2, ring, full, empty, stages, s, ph, grp, gbar);
  sm90::cluster_arrive_relaxed();  // (2) every slice of this CTA's G has landed
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += Vs[3 * kGroup + 8 * (i / 4) + 2 * t + (i & 1)];
  sm90::scene_moments<false>(acc, a.n, nsc, a.eps, red, stat);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r < rows) {
      const int sc = r / a.n;
      const float mean = stat[sc], inv = stat[kTileRows + sc];
      bf16* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const int i = 4 * j + 2 * half;
        const float h0 =
            silu_fast((acc[i] - mean) * inv * Vs[4 * kGroup + c] + Vs[5 * kGroup + c]);
        const float h1 =
            silu_fast((acc[i + 1] - mean) * inv * Vs[4 * kGroup + c + 1] + Vs[5 * kGroup + c + 1]);
        float res0 = accR[i], res1 = accR[i + 1];
        if constexpr (kRes) {
          res0 += Vs[6 * kGroup + c];
          res1 += Vs[6 * kGroup + c + 1];
        }
        tile::st2<bf16>(o + c, h0 + res0, h1 + res1);
      }
    }
  }
  sm90::cluster_wait();            // (2) no CTA leaves before every slice has landed
}

constexpr int kSmemMax = (int)layout(kMaxIn).total;

template <bool kRes>
cudaError_t prepare_sm90() {   // once per instantiation
  static const cudaError_t err = cudaFuncSetAttribute(
      resblock_sm90<kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return err;
}

int launch_sm90(const Args90& a, cudaStream_t stream) {
  const cudaError_t err = a.Wres ? prepare_sm90<true>() : prepare_sm90<false>();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.B + a.ts - 1) / a.ts) * kCluster;
  const size_t smem = layout(a.kx + a.ks).total;
  if (a.Wres)
    resblock_sm90<true><<<grid, kThreads, smem, stream>>>(a);
  else
    resblock_sm90<false><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the parity kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 24;       // valid rows per tile: 2 scenes of 12 or 1 of 21
constexpr int kMaxScenes = 4;   // scenes per tile (bounds the reduction buffer)
constexpr int kPad = 8;         // shared-memory row padding (elements)

struct Args {
  const void* x;      // (M, kx)
  const void* skip;   // (M, ks) or null
  const void* film;   // (B, 2C) per scene, (M, 2C) per row, or null
  const void* W1;     // (kx + ks, C) (in, out)
  const void* W2;     // (C, C)
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, n = a.n, ts = a.ts, kx = a.kx, ks = a.ks;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ldx = kx + kPad, lds = ks + kPad, ldh = C + 4;

  T* X = reinterpret_cast<T*>(smem);                   // x tile
  T* S = X + kTile * ldx;                              // skip tile (ks > 0)
  float* H = reinterpret_cast<float*>(S + (ks ? kTile * lds : 0));  // f32 intermediate
  float* red = H + kTile * ldh;
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
  gn_film_silu<T, float>(H, ldh, H, ldh, a, V + C, V + 2 * C, a.film_kind, film, scene0, nsc,
                         red, stat);

  // block2: h = h @ W2 + b2, GroupNorm, SiLU
  p.zero();
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
  return b + (2 * (size_t)a.ts * threads + 2 * (size_t)a.ts * a.groups) * sizeof(float);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(   // once per instantiation
      resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = a.C / 2;
  const size_t smem = smem_bytes<T>(a, threads);
  const int grid = (a.B + a.ts - 1) / a.ts;
  resblock_kernel<T><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of one scene the kernel of `dtype` (0 float32, 1 bfloat16) takes
int fused_resblock_max_rows(int dtype) { return dtype == 1 ? kTileRows : kRows; }
int fused_resblock_max_in() { return kMaxIn; }
// dynamic shared memory of one bf16 CTA for kx + ks input columns
int fused_resblock_smem_bytes(int kx, int ks) { return (int)layout(kx + ks).total; }

// clusters of the bf16 kernel that fit on the card at once, or minus a
// cudaError_t code
int fused_resblock_max_active_clusters(int kx, int ks, int has_res) {
  const cudaError_t err = has_res ? prepare_sm90<true>() : prepare_sm90<false>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout(kx + ks).total;
  int clusters = 0;
  const cudaError_t e = has_res
      ? cudaOccupancyMaxActiveClusters(&clusters, resblock_sm90<true>, &cfg)
      : cudaOccupancyMaxActiveClusters(&clusters, resblock_sm90<false>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// dtype: 0 float32, 1 bfloat16 (weights packed by pack_group_tiles).
// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take.
int fused_resblock_launch(int dtype, const void* x, const void* skip, const void* film,
                          int film_kind, const void* W1, const void* W2, const void* Wres,
                          const float* V, void* out, int B, int n, int C, int kx, int ks,
                          int groups, float eps, void* stream) {
  if (n < 1 || B < 1 || ks < 0 || kx + ks > kMaxIn || (ks > 0) != (skip != nullptr) ||
      film_kind < 0 || film_kind > 2 || (film_kind != 0) != (film != nullptr) ||
      (Wres == nullptr && (kx != C || ks != 0)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (n > kTileRows || C != kC || groups != kCluster || kx < sm90::kChunkK ||
        kx % sm90::kChunkK != 0 || ks % sm90::kChunkK != 0 || (kx + ks) % (2 * sm90::kChunkK) != 0)
      return -1;
    Args90 a;
    a.x = static_cast<const bf16*>(x);
    a.skip = static_cast<const bf16*>(skip);
    a.film = static_cast<const bf16*>(film);
    a.W1 = static_cast<const bf16*>(W1);
    a.W2 = static_cast<const bf16*>(W2);
    a.Wres = static_cast<const bf16*>(Wres);
    a.V = V;
    a.out = static_cast<bf16*>(out);
    a.B = B;
    a.n = n;
    a.kx = kx;
    a.ks = ks;
    a.ts = kTileRows / n;
    a.film_kind = film_kind;
    a.eps = eps;
    return launch_sm90(a, s);
  }
  if (dtype != 0 || n > kRows || C % 64 != 0 || C > 512 || groups < 1 || C % groups != 0 ||
      (C / groups) % 2 != 0 || kx < 16 || kx % 16 != 0 || ks % 16 != 0)
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
  return launch<float>(a, s);
}

}  // extern "C"
