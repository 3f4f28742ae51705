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
// kernel and the plain twin apply_chain_reference (the chain's roundings,
// not B1's): each dense output is rounded before its moments, the one-pass
// variance is clamped at 0, scene-FiLM is folded into the affine in f32
// before a and b are rounded, row-FiLM and every product and sum after run
// in the compute dtype, SiLU in f32, and the residual projection plus bres
// is rounded before it is added.  Block 2's input is block 1's output.
//
// bfloat16 (the serving dtype; chain_sm90): C = 512 in 8 GroupNorm groups,
// B1's cluster design (fused_resblock.cu, helpers in sm90.cuh) carried over
// a chain.  A scene tile (at most 64 rows: 5 scenes of 12, 3 of 21) is one
// thread-block cluster of 8 CTAs; CTA g owns output columns [64g, 64g + 64)
// of every product of the chain, so every GroupNorm is CTA-local and reduced
// in a fixed order.  At B=64 that is 13 clusters (104 CTAs) for n=12 and 22
// for n=21.  In a CTA:
//
// - one producer warp multicasts the x tile to the cluster (each CTA loads
//   every 8th row into all 8), then the skip tile of the block that takes
//   one (it lands while the blocks before run), bulk-loads this CTA's 64
//   columns of every vector of the chain, and streams the CTA's weight
//   chunks (64 deep x 64 columns, packed once per chain in the wgmma B
//   layout by pack_chain_weights) through a ring of 4 stages (8 with a skip)
//   by cp.async.bulk with mbarriers, every block of the chain in order, so
//   the next block's first chunks are in flight while the consumers finish
//   the block before;
// - one consumer warpgroup runs the products on wgmma m64n64k16: W1 (with
//   W1s over the skip tile) and the residual projection share one K loop
//   with two accumulators; an identity residual keeps the CTA's own slice of
//   the block input in that second accumulator;
// - after GN1, FiLM and SiLU each CTA writes its bf16 (rows x 64) slice of h
//   into the gathered G (the x tile's space) and stores it into the other 7
//   CTAs' G by st.async; the second product starts on the CTA's own slice
//   and takes the others as they land;
// - in a two-block chain each CTA stores its 64 columns of block 1's output
//   in `out` (it stays in L2) and, after a cluster barrier, the cluster
//   loads the whole output back into the x tile's space by bulk copies
//   multicast to the 8 CTAs (each loading every 8th row), as it loaded x:
//   that is block 2's input tile, and its identity residual the CTA's own
//   columns of it.  (An exchange of the output slices through distributed
//   shared memory into the space G held, the way h moves, faulted on the
//   card with an illegal address in every two-block chain; this route
//   replaced it.)
//
// A cluster barrier guards every reuse of the x tile's space: each CTA
// arrives (release) once it is done reading a region there (the input tile,
// G) and waits before anything is stored into the peers' copy.
//
// float32 (fused_chain_kernel, for parity): the first FMA kernel, a thread block
// owning 2 scenes of 12 or 1 of 21, products on the FMA pipes in full f32.
//
// What bounds it.  The 19 chains of a B=64 flagship forward are 33.4 GFLOP,
// 34 us at the bf16 tensor-core peak, well above their bytes.  A launch is
// bound by latency along each CTA's chain of phases: the x tile's arrival,
// the weight stream from L2 (each of the 13-22 row tiles reads every weight
// of the chain, 0.5 MB a 512 x 512 weight), the epilogues on one warpgroup,
// the exchanges of h through distributed shared memory and, between the
// blocks of a chain, the round trip of block 1's output through L2.  The
// next step is B1's: a 2-D cluster (row tiles x groups) that multicasts
// each weight chunk to the row tiles that share it.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: the cluster kernel
// ---------------------------------------------------------------------------

using sm90::hslice;
using sm90::kC;
using sm90::kCluster;
using sm90::kConsumers;
using sm90::kGroup;
using sm90::kThreads;
using sm90::kTileRows;
using sm90::silu_fast;
constexpr int kMaxStages = 8;
constexpr int kMaxVectors = 14;   // two blocks of b1, g1 scale, g1 bias, b2, g2 scale, g2 bias, bres
constexpr int kLdx = kC + 8;      // row stride of the x and skip tiles (conflict-free ldmatrix)

// shared-memory layout of chain_sm90, with or without a skip tile
struct Layout {
  int stages;
  unsigned ring, x, s, v, red, stat, bars, total;
};

__host__ __device__ constexpr Layout layout(bool skip) {
  Layout L{};
  L.stages = skip ? kMaxStages : 4;
  L.ring = 0;                                               // stages x 8 KB
  L.x = L.ring + L.stages * sm90::kChunkBytes;              // x tile, later G or block 1's output
  L.s = L.x + kTileRows * kLdx * 2;                         // the skip tile
  L.v = L.s + (skip ? kTileRows * kLdx * 2 : 0);            // this CTA's columns of the vectors
  L.red = L.v + kMaxVectors * kGroup * 4;                   // row sums, squares
  L.stat = L.red + 2 * kTileRows * 4;                       // scene mean, rsqrt
  L.bars = L.stat + 2 * kTileRows * 4;                      // full, empty, x, skip, out, slices
  L.total = L.bars + (2 * kMaxStages + 3 + 2 * kCluster) * 8;
  return L;
}
static_assert(kCluster * kTileRows * kGroup <= kTileRows * kLdx, "G fits in the x tile's space");

struct Args90 {
  const bf16* x;        // (M, C)
  const bf16* skip;     // (M, C) for the one block that takes a skip, or null
  const bf16* film[2];  // per block: (B, 2C) per scene, (M, 2C) per row, or null
  const bf16* W;        // chunks (pack_chain_weights of the (nW, C, C) stack)
  const float* V;       // (nV, C) f32: per block b1, g1s, g1b, b2, g2s, g2b [, bres]
  bf16* out;            // (M, C): block 1's output on its way to block 2, then the chain's
  int B, n, ts, nW, nV, nblocks;
  int spec[2];          // bit 0 has_skip, bits 1-2 film (0 none, 1 scene, 2 row), bit 3 res proj
  float eps;
};

__device__ __forceinline__ float lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    chain_sm90(const Args90 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_skip = a.skip != nullptr;
  const Layout L = layout(has_skip);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* X = reinterpret_cast<bf16*>(smem + L.x);   // a block's input tile, row-major
  bf16* G = X;                       // the gathered h, once the block input is read
  bf16* S = reinterpret_cast<bf16*>(smem + L.s);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;   // the x tile and the vectors
  uint64_t* sbar = xbar + 1;             // the skip tile
  uint64_t* obar = sbar + 1;             // block 1's output, back as block 2's input tile
  uint64_t* gbar = obar + 1;             // [8b + q]: CTA q's slice of block b's h has landed

  const int grp = (int)cg::this_cluster().block_rank();   // GroupNorm group = column slice
  const int scene0 = (blockIdx.x / kCluster) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);             // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int stages = L.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = grp * kGroup;               // this CTA's first output column
  const uint32_t tile_bytes = rows * kC * 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_init(xbar, 1);
    sm90::mbar_init(sbar, 1);
    sm90::mbar_init(obar, 1);
    if (a.nblocks == 2) sm90::mbar_expect_tx(obar, tile_bytes);
    for (int q = 0; q < kCluster * a.nblocks; ++q) {
      sm90::mbar_init(&gbar[q], 1);
      // CTA q's slices land here; this CTA's own are local
      if (q % kCluster != grp) sm90::mbar_expect_tx(&gbar[q], rows * kGroup * 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  // Cluster barrier phases after (0): (2b + 1) after block b's first K loop
  // (its input tile is read), (2b + 2) after its output is stored (G is read).
  if (warp == kConsumers / 32) {
    // ---- producer warp: the x and skip tiles and the vectors, then the weight chunks ----
    if (lane == 0) {
      sm90::mbar_expect_tx(xbar, tile_bytes + (uint32_t)(a.nV * kGroup * 4));
      if (has_skip) sm90::mbar_expect_tx(sbar, tile_bytes);
    }
    __syncwarp();
    if (lane < a.nV) sm90::bulk_load(Vs + lane * kGroup, a.V + lane * kC + col0, kGroup * 4, xbar);
    for (int r = grp + kCluster * lane; r < rows; r += kCluster * 32)
      sm90::bulk_load_multicast(X + r * kLdx, a.x + (row0 + r) * kC, kC * 2, xbar, 0xff);
    if (has_skip) {
      for (int r = grp + kCluster * lane; r < rows; r += kCluster * 32)
        sm90::bulk_load_multicast(S + r * kLdx, a.skip + (row0 + r) * kC, kC * 2, sbar, 0xff);
    }
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      const bf16* wg = a.W + (size_t)grp * a.nW * 8 * sm90::kChunkElems;   // this CTA's chunks
      auto put = [&](int w, int q) {   // K tile q of weight w of the stack
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_expect_tx(&full[s], sm90::kChunkBytes);
        sm90::bulk_load(ring + s * sm90::kChunkElems, wg + (size_t)(w * 8 + q) * sm90::kChunkElems,
                        sm90::kChunkBytes, &full[s]);
        if (++s == stages) s = 0, ph ^= 1;
      };
      // Arrive at a phase before putting the chunks the consumers take
      // after it, wait for it only once the chunks before are out.
      sm90::cluster_arrive_relaxed();   // (1)
      int wi = 0;
      for (int b = 0; b < a.nblocks; ++b) {
        const int spec = b ? a.spec[1] : a.spec[0];
        const bool skip = spec & 1, res = (spec >> 3) & 1;
        // the block's weights in the stack: w1, [w1s], w2, [wres, [wres_s]]
        const int w1 = wi, w1s = wi + 1, w2 = wi + 1 + skip, wr = w2 + 1, wrs = w2 + 2;
        for (int kt = 0; kt < 8; ++kt) {
          put(w1, kt);
          if (res) put(wr, kt);
        }
        if (skip) {
          for (int kt = 0; kt < 8; ++kt) {
            put(w1s, kt);
            put(wrs, kt);
          }
        }
        if (b > 0) {
          sm90::cluster_wait();             // (2b)
          sm90::cluster_arrive_relaxed();   // (2b + 1)
        }
        for (int kt = 0; kt < 8; ++kt) put(w2, (grp + kt) % kCluster);   // G from its own slice
        sm90::cluster_wait();               // (2b + 1)
        sm90::cluster_arrive_relaxed();     // (2b + 2)
        wi = w2 + 1 + res + (skip && res);
      }
      sm90::cluster_wait();                 // (2 nblocks)
    } else {
      for (int p = 0; p < 2 * a.nblocks; ++p) {
        sm90::cluster_arrive_relaxed();
        sm90::cluster_wait();
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);    // this thread's rows: r0, r0 + 8
  float acc[32], accR[32];
  int s = 0;
  uint32_t ph = 0;
  const float* Vb = Vs;                      // this block's vectors
  sm90::mbar_wait(xbar, 0);
#pragma unroll 1
  for (int b = 0; b < a.nblocks; ++b) {
    const int spec = b ? a.spec[1] : a.spec[0];
    const bool skip = spec & 1, res = (spec >> 3) & 1;
    const bool last = b + 1 == a.nblocks;
    const int film_kind = (spec >> 1) & 3;
    const bf16* film = b ? a.film[1] : a.film[0];
    // this thread's film scale and shift pairs, loaded now, used after the K loop
    uint32_t fsc[2][8], fsh[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = min(r0 + 8 * half, rows - 1);
      const bf16* f = film_kind == 1 ? film + (size_t)(scene0 + r / a.n) * 2 * kC
                                     : film + (row0 + r) * 2 * kC;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        fsc[half][j] = film_kind ? *reinterpret_cast<const uint32_t*>(f + c) : 0u;
        fsh[half][j] = film_kind ? *reinterpret_cast<const uint32_t*>(f + kC + c) : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;

    // the first K loop: z = h @ W1 (+ skip @ W1s), and the residual projection
    if (b > 0) sm90::mbar_wait(obar, 0);   // block 1's output is the input tile
    if (res)
      sm90::consume<true, false>(acc, accR, X, kLdx, 8, ring, full, empty, stages, s, ph);
    else
      sm90::consume<false, false>(acc, accR, X, kLdx, 8, ring, full, empty, stages, s, ph);
    if (skip) {   // a skip block has a residual projection (ChainBlock)
      sm90::mbar_wait(sbar, 0);
      sm90::consume<true, false>(acc, accR, S, kLdx, 8, ring, full, empty, stages, s, ph);
    }
    if (!res) {   // the identity residual: this CTA's slice of the block input
#pragma unroll
      for (int i = 0; i < 32; ++i)
        accR[i] = __bfloat162float(X[(r0 + 8 * ((i >> 1) & 1)) * kLdx + col0 + 8 * (i / 4) +
                                     2 * t + (i & 1)]);
    }
    // (2b + 1) the input tile is read: the others may write h over it.
    // Release, so that the loads above are ordered before their stores
    sm90::cluster_arrive();

    // z = round(z + b1); GN1 with scene-FiLM folded in, row-FiLM, SiLU; this
    // CTA's bf16 slice of h into its place in G
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = tile::rnd<bf16>(acc[i] + Vb[8 * (i / 4) + 2 * t + (i & 1)]);
    sm90::scene_moments<true>(acc, a.n, nsc, a.eps, red, stat);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        const float mean = stat[sc], inv = stat[kTileRows + sc];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;
            const float fs = e ? hi(fsc[half][j]) : lo(fsc[half][j]);
            const float fb = e ? hi(fsh[half][j]) : lo(fsh[half][j]);
            float ca = inv * Vb[kGroup + c];
            float cb = Vb[2 * kGroup + c] - mean * inv * Vb[kGroup + c];
            if (film_kind == 1) {
              ca *= fs + 1.f;
              cb = cb * (fs + 1.f) + fb;
            }
            ca = tile::rnd<bf16>(ca);
            cb = tile::rnd<bf16>(cb);
            float v = tile::rnd<bf16>(tile::rnd<bf16>(acc[4 * j + 2 * half + e] * ca) + cb);
            if (film_kind == 2)
              v = tile::rnd<bf16>(tile::rnd<bf16>(v * tile::rnd<bf16>(fs + 1.f)) + fb);
            z[e] = silu_fast(v);
          }
          tile::st2<bf16>(G + hslice(grp, r, j) + 2 * t, z[0], z[1]);
        }
      }
    }
    sm90::bar_sync<kConsumers>(1);
    sm90::cluster_wait();            // (2b + 1) every CTA is done with its input tile
    sm90::send_slice(G, grp, rows, gbar + kCluster * b);

    // the second K loop: z2 = h @ W2, from this CTA's slice on, each other
    // one as it lands
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::consume<false, true>(acc, accR, G, 0, 8, ring, full, empty, stages, s, ph, grp,
                               gbar + kCluster * b);

    // out = round(silu(GN2(round(z2 + b2))) + res), this CTA's 64 columns
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = tile::rnd<bf16>(acc[i] + Vb[3 * kGroup + 8 * (i / 4) + 2 * t + (i & 1)]);
    sm90::scene_moments<true>(acc, a.n, nsc, a.eps, red, stat);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        const float mean = stat[sc], inv = stat[kTileRows + sc];
        bf16* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e, i = 4 * j + 2 * half + e;
            const float ca = tile::rnd<bf16>(inv * Vb[4 * kGroup + c]);
            const float cb = tile::rnd<bf16>(Vb[5 * kGroup + c] - mean * inv * Vb[4 * kGroup + c]);
            const float z = tile::rnd<bf16>(
                silu_fast(tile::rnd<bf16>(tile::rnd<bf16>(acc[i] * ca) + cb)));
            v[e] = z + (res ? tile::rnd<bf16>(accR[i] + Vb[6 * kGroup + c]) : accR[i]);
          }
          tile::st2<bf16>(o + 8 * j + 2 * t, v[0], v[1]);
        }
      }
    }
    // (2b + 2) G is read and this CTA's columns are stored.  Release, after
    // a proxy fence: block 2's input tile is read back from them by bulk
    // copies (the async proxy) into the space G took
    sm90::fence_proxy_async();
    sm90::cluster_arrive();
    sm90::cluster_wait();
    if (!last) {   // block 1's output, every CTA loading every 8th row into all 8
      sm90::fence_proxy_async();
      for (int r = grp + kCluster * threadIdx.x; r < rows; r += kCluster * kConsumers)
        sm90::bulk_load_multicast(X + r * kLdx, a.out + (row0 + r) * kC, kC * 2, obar, 0xff);
    }
    Vb += (res ? 7 : 6) * kGroup;
  }
}

constexpr int kSmemMax = (int)layout(true).total;

cudaError_t prepare_sm90() {   // once
  static const cudaError_t err =
      cudaFuncSetAttribute(chain_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return err;
}

// ---------------------------------------------------------------------------
// float32: the parity kernel.  A thread block owns a tile of whole scenes
// (at most kRows rows); the activation, the skip tile and both
// intermediates stay in shared memory for the whole chain, and thread t
// owns output columns 2t, 2t+1 of all rows: each weight element is read
// once per block, each activation value is a shared-memory broadcast.
// ---------------------------------------------------------------------------

constexpr int kRows = 24;       // valid rows per tile: 2 scenes of 12 or 1 of 21
constexpr int kMaxScenes = 4;   // scenes per tile (bounds the reduction buffer)
constexpr int kPad = 8;         // shared-memory row padding (elements)

struct ArgsF32 {
  const float* x;        // (M, C)
  const float* skip[2];  // per block: (M, C) or null
  const float* film[2];  // per block: (B, 2C) scene rows, (M, 2C) rows, or null
  const float* W;        // (nW, C, C) (in, out)
  const float* V;        // (nV, C): b1, g1s, g1b, b2, g2s, g2b [, bres]
  float* out;            // (M, C)
  int B, n, C, groups, ts, nblocks;
  int spec[2];
  float eps;
};

// v[r] += A[r, :] @ W[:, col:col+2] for the kRows rows; A in smem (stride
// lda), W (C, C) (in, out)
__device__ __forceinline__ void mm_f32(float (&v)[kRows][2], const float* __restrict__ A, int lda,
                                       const float* __restrict__ W, int C) {
  const int col = 2 * threadIdx.x;
  const float* wp = W + col;
  auto ldg2 = [](const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); };
  // the next four weight rows are fetched while the current four are used
  float2 n0 = ldg2(wp), n1 = ldg2(wp + C), n2 = ldg2(wp + 2 * C), n3 = ldg2(wp + 3 * C);
#pragma unroll 1
  for (int k = 0; k < C; k += 4) {
    const float2 w0 = n0, w1 = n1, w2 = n2, w3 = n3;
    if (k + 4 < C) {
      const float* p = wp + (size_t)(k + 4) * C;
      n0 = ldg2(p);
      n1 = ldg2(p + C);
      n2 = ldg2(p + 2 * C);
      n3 = ldg2(p + 3 * C);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
      float s0 = v[r][0], s1 = v[r][1];
      s0 = fmaf(a.x, w0.x, s0); s1 = fmaf(a.x, w0.y, s1);
      s0 = fmaf(a.y, w1.x, s0); s1 = fmaf(a.y, w1.y, s1);
      s0 = fmaf(a.z, w2.x, s0); s1 = fmaf(a.z, w2.y, s1);
      s0 = fmaf(a.w, w3.x, s0); s1 = fmaf(a.w, w3.y, s1);
      v[r][0] = s0; v[r][1] = s1;
    }
  }
}

// In place on the tile Z: GroupNorm with per-scene f32 moments over (n rows
// x C/groups channels), the affine folded into per-scene coefficients a, b;
// scene-FiLM folded into a, b, or row-FiLM applied after; then SiLU.  Thread
// t owns columns 2t, 2t+1.  red: [2][ts][nthreads] partial sums, stat:
// [2][ts][groups].
__device__ void gn_film_silu(float* Z, int lda, const ArgsF32& args, const float* scale,
                             const float* bias, int film_kind, const float* film, int scene0,
                             int nsc, float* red, float* stat) {
  const int C = args.C, n = args.n, ts = args.ts, groups = args.groups;
  const int tid = threadIdx.x, nthr = blockDim.x, col = 2 * tid;
  // 1. per-thread partial moments of its two columns, per scene
  for (int s = 0; s < nsc; ++s) {
    float sum = 0.f, sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float2 v = tile::ld2<float>(Z + (s * n + i) * lda + col);
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
  // 3. apply: z * a + b (+ row FiLM), SiLU
  const int g = col / gs;
  const float sc0 = scale[col], sc1 = scale[col + 1];
  const float bi0 = bias[col], bi1 = bias[col + 1];
  for (int s = 0; s < nsc; ++s) {
    const float mean = stat[s * groups + g], inv = stat[(ts + s) * groups + g];
    float a0 = inv * sc0, a1 = inv * sc1;
    float b0 = bi0 - mean * inv * sc0, b1 = bi1 - mean * inv * sc1;
    if (film_kind == 1) {
      const float* f = film + (size_t)(scene0 + s) * 2 * C;
      const float2 fs = tile::ld2<float>(f + col);
      const float2 fb = tile::ld2<float>(f + C + col);
      const float fs0 = fs.x + 1.f, fs1 = fs.y + 1.f;
      a0 *= fs0; a1 *= fs1;
      b0 = b0 * fs0 + fb.x; b1 = b1 * fs1 + fb.y;
    }
    for (int i = 0; i < n; ++i) {
      const int r = s * n + i;
      const float2 v = tile::ld2<float>(Z + r * lda + col);
      float z0 = v.x * a0 + b0;
      float z1 = v.y * a1 + b1;
      if (film_kind == 2) {
        const float* f = film + ((size_t)scene0 * n + r) * 2 * C;
        const float2 fs = tile::ld2<float>(f + col);
        const float2 fb = tile::ld2<float>(f + C + col);
        z0 = z0 * (fs.x + 1.f) + fb.x;
        z1 = z1 * (fs.y + 1.f) + fb.y;
      }
      tile::st2<float>(Z + r * lda + col, tile::silu(z0), tile::silu(z1));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256) fused_chain_kernel(ArgsF32 args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = args.C, ts = args.ts;
  const int lda = C + kPad;
  const int col = 2 * threadIdx.x;
  float* X = reinterpret_cast<float*>(smem);   // chain activation (block input, then output)
  float* S = X + kRows * lda;                  // skip rows of the current block
  float* Z = S + kRows * lda;                  // block1 intermediate
  float* Z2 = Z + kRows * lda;                 // block2 intermediate
  float* red = Z2 + kRows * lda;               // [2][ts][nthr]
  float* stat = red + 2 * ts * blockDim.x;     // [2][ts][groups]

  const int scene0 = blockIdx.x * ts;
  const int nsc = min(ts, args.B - scene0);  // the last tile may be ragged
  const int rows = nsc * args.n;
  const size_t row0 = (size_t)scene0 * args.n;

  tile::load_rows<float>(X, lda, args.x + row0 * C, C, rows, kRows, C);
  __syncthreads();

  const float* W = args.W;
  const float* V = args.V;
  const size_t CC = (size_t)C * C;
  int wi = 0, vi = 0;
  float v[kRows][2];
  auto zero = [&] {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r][0] = v[r][1] = 0.f;
  };
  for (int bi = 0; bi < args.nblocks; ++bi) {
    const int spec = args.spec[bi];
    const bool has_skip = spec & 1;
    const int film_kind = (spec >> 1) & 3;
    const bool has_res = (spec >> 3) & 1;
    if (has_skip) {
      tile::load_rows<float>(S, lda, args.skip[bi] + row0 * C, C, rows, kRows, C);
      __syncthreads();
    }
    const float* b1 = V + (size_t)vi * C;

    // block1: dense (split matmuls over the implicit skip concat)
    zero();
    mm_f32(v, X, lda, W + wi * CC, C);
    int wj = wi + 1;
    if (has_skip) mm_f32(v, S, lda, W + (wj++) * CC, C);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      tile::st2<float>(Z + r * lda + col, v[r][0] + b1[col], v[r][1] + b1[col + 1]);
    __syncthreads();
    gn_film_silu(Z, lda, args, b1 + C, b1 + 2 * C, film_kind, args.film[bi], scene0, nsc, red,
                 stat);

    // block2
    zero();
    mm_f32(v, Z, lda, W + (wj++) * CC, C);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      tile::st2<float>(Z2 + r * lda + col, v[r][0] + b1[3 * C + col], v[r][1] + b1[3 * C + col + 1]);
    __syncthreads();
    gn_film_silu(Z2, lda, args, b1 + 4 * C, b1 + 5 * C, 0, nullptr, scene0, nsc, red, stat);

    // residual
    if (has_res) {
      zero();
      mm_f32(v, X, lda, W + (wj++) * CC, C);
      if (has_skip) mm_f32(v, S, lda, W + (wj++) * CC, C);
      __syncthreads();  // every thread is done reading X
      const float bx = b1[6 * C + col], by = b1[6 * C + col + 1];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 z = tile::ld2<float>(Z2 + r * lda + col);
        tile::st2<float>(X + r * lda + col, z.x + (v[r][0] + bx), z.y + (v[r][1] + by));
      }
    } else {
      for (int r = 0; r < kRows; ++r) {
        const float2 z = tile::ld2<float>(Z2 + r * lda + col);
        const float2 x = tile::ld2<float>(X + r * lda + col);
        tile::st2<float>(X + r * lda + col, z.x + x.x, z.y + x.y);
      }
    }
    __syncthreads();
    wi = wj;
    vi += has_res ? 7 : 6;
  }
  const int per_row = C / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, q = i % per_row;
    reinterpret_cast<float4*>(args.out + (row0 + r) * C)[q] =
        reinterpret_cast<const float4*>(X + r * lda)[q];
  }
}

int launch_f32(const ArgsF32& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      fused_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = a.C / 2;
  const size_t smem = 4 * (size_t)kRows * (a.C + kPad) * sizeof(float) +
                      (2 * (size_t)a.ts * threads + 2 * (size_t)a.ts * a.groups) * sizeof(float);
  const int grid = (a.B + a.ts - 1) / a.ts;
  fused_chain_kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// weights and vectors of one block of `spec`
int block_weights(int spec) { return 2 + (spec & 1) + ((spec >> 3) & 1) + ((spec & 9) == 9); }
int block_vectors(int spec) { return 6 + ((spec >> 3) & 1); }

}  // namespace

extern "C" {

// rows of one scene the kernel of `dtype` (0 float32, 1 bfloat16) takes
int fused_chain_max_rows(int dtype) { return dtype == 1 ? kTileRows : kRows; }
int fused_chain_max_channels() { return kC; }
// dynamic shared memory of one bf16 CTA, for a chain with or without a skip
int fused_chain_smem_bytes(int has_skip) { return (int)layout(has_skip != 0).total; }

// clusters of the bf16 kernel that fit on the card at once, or minus a
// cudaError_t code
int fused_chain_max_active_clusters(int has_skip) {
  const cudaError_t err = prepare_sm90();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout(has_skip != 0).total;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, chain_sm90, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// dtype: 0 float32 (W (nW, C, C) as is), 1 bfloat16 (W packed by
// pack_group_tiles).  Returns a cudaError_t code (0 on success), or -1 for
// arguments the kernel does not take.
int fused_chain_launch(int dtype, const void* x, const void* skip0, const void* skip1,
                       const void* film0, const void* film1, const void* W, const float* V,
                       void* out, int B, int n, int C, int groups, float eps, int nblocks,
                       int spec0, int spec1, void* stream) {
  const int spec[2] = {spec0, nblocks == 2 ? spec1 : 0};
  const void* skip[2] = {skip0, skip1};
  const void* film[2] = {film0, film1};
  if (n < 1 || B < 1 || nblocks < 1 || nblocks > 2) return -1;
  for (int b = 0; b < nblocks; ++b) {
    const int film_kind = (spec[b] >> 1) & 3;
    if (((spec[b] & 1) != 0) != (skip[b] != nullptr) || film_kind > 2 ||
        (film_kind != 0) != (film[b] != nullptr) || ((spec[b] & 1) && !(spec[b] & 8)))
      return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (n > kTileRows || C != kC || groups != kCluster || (skip0 && skip1)) return -1;
    Args90 a;
    a.x = static_cast<const bf16*>(x);
    a.skip = static_cast<const bf16*>(skip0 ? skip0 : skip1);
    a.film[0] = static_cast<const bf16*>(film0);
    a.film[1] = static_cast<const bf16*>(film1);
    a.W = static_cast<const bf16*>(W);
    a.V = V;
    a.out = static_cast<bf16*>(out);
    a.B = B;
    a.n = n;
    a.ts = kTileRows / n;
    a.nW = a.nV = 0;
    for (int b = 0; b < nblocks; ++b) {
      a.nW += block_weights(spec[b]);
      a.nV += block_vectors(spec[b]);
    }
    a.nblocks = nblocks;
    a.spec[0] = spec[0];
    a.spec[1] = spec[1];
    a.eps = eps;
    const cudaError_t err = prepare_sm90();
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((B + a.ts - 1) / a.ts) * kCluster;
    chain_sm90<<<grid, kThreads, layout(a.skip != nullptr).total, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype != 0 || n > kRows || C % 64 != 0 || C > 512 || groups < 1 || C % groups != 0 ||
      (C / groups) % 2 != 0)
    return -1;
  ArgsF32 a;
  a.x = static_cast<const float*>(x);
  a.skip[0] = static_cast<const float*>(skip0);
  a.skip[1] = static_cast<const float*>(skip1);
  a.film[0] = static_cast<const float*>(film0);
  a.film[1] = static_cast<const float*>(film1);
  a.W = static_cast<const float*>(W);
  a.V = V;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.n = n;
  a.C = C;
  a.groups = groups;
  a.ts = kRows / n < kMaxScenes ? kRows / n : kMaxScenes;
  a.nblocks = nblocks;
  a.spec[0] = spec[0];
  a.spec[1] = spec[1];
  a.eps = eps;
  return launch_f32(a, s);
}

}  // extern "C"
