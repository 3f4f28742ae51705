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
// bfloat16 (the b512 recipes' serving dtype; chain_sm90): C = 512 in 8
// GroupNorm groups, B1's cluster design (fused_resblock.cu, helpers in
// sm90.cuh) carried over a chain.  A scene tile (at most 64 rows: 5 scenes
// of 12, 3 of 21) is one thread-block cluster of 8 CTAs; CTA g owns output
// columns [64g, 64g + 64) of every product of the chain, so every GroupNorm
// is CTA-local and reduced in a fixed order.  At B=64 that is 13 clusters
// (104 CTAs) for n=12 and 22 for n=21.  In a CTA:
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
// float32 (chain_tf32; the serving dtype of 12 of the 15 diffusion
// configs, the flagship's among them): the same scene tile, cluster of 8
// CTAs and CTA-local GroupNorm, on the f32 ResnetBlock kernel's split-TF32
// design (fused_resblock.cu, resblock_tf32; its pieces in sm90.cuh): every
// product on wgmma m64n64k8 .tf32 as hi*lo + lo*hi + hi*hi of tf32 parts
// with f32 accumulation, the weights split on the host (pack_tf32_tiles of
// the chain's (nW * 512, 512) stack, so a CTA's chunks for the whole chain
// are contiguous), the rows split in registers; never one pass of hi*hi.
// Nothing is rounded: the compute dtype is f32.  In a CTA (192 threads):
//
// - 8 rolling slots of 64 rows x 64 columns take each block's input K
//   tiles in turn (an input loader warp: CTA g bulk-copies rows g, g + 8,
//   ... multicast into all 8 CTAs' slot, a slot released cluster-wide
//   before its reuse), the skip's K tiles after the input's, and then the
//   gathered h of the block; a producer warp streams the split chunks of
//   every block of the chain in order through a ring of 5 stages;
// - one consumer warpgroup runs the products (W1 and the residual
//   projection share the A fragments), the epilogues in the chain's order
//   (the one-pass variance clamped at 0, scene-FiLM folded into the affine,
//   row-FiLM after it as z * (f + 1) + f), and the exchange of its f32
//   slice of h by bulk copies into the other CTAs' slot;
// - block 1's output goes through `out` (L2): each CTA stores its 64
//   columns and, after a proxy fence and a cluster barrier, the loader warp
//   streams that output's K tiles through the slots as it streamed x.  The
//   identity residual (x, or block 1's output) is read from device memory,
//   exact.  226,128 bytes of shared memory a CTA.
//
// The other widths and groupings (chain_tf32_wide, chain_bf16_wide, one
// body, below): C = 256, 512 or 1024 in 4, 8, 16 or 32 groups of at least
// 16 channels, every chain the two kernels above do not take (they take C
// = 512 in 8 groups), on the wide ResnetBlock kernel's design with the
// chain's roundings.
//
// What bounds it.  The 19 chains of a B=64 flagship forward are 33.4 GFLOP:
// 34 us at the bf16 tensor-core peak, and in f32 0.2025 ms as three tf32
// products each at the 495 TFLOP/s TF32 rate (0.4988 ms at the FP32 rate),
// well above their bytes.  A launch is bound by latency along each CTA's
// chain of phases: the input tile's arrival, the weight stream from L2
// (each of the 13-22 row tiles reads every weight of the chain, 0.5 MB a
// 512 x 512 weight in bf16, 1 MB split in f32), the epilogues on one
// warpgroup, the exchanges of h and, between the blocks of a chain, the
// round trip of block 1's output through L2.  The next step is B1's: a 2-D
// cluster (row tiles x groups) that multicasts each weight chunk to the
// row tiles that share it.
#include <cooperative_groups.h>

#include <type_traits>

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
// float32: the split-TF32 cluster kernel
// ---------------------------------------------------------------------------

using sm90::kChunkPartF;
using sm90::kLdF;
using sm90::kSlotF;
using sm90::kStagesF;
using sm90::kThreadsF;
constexpr int kStepsF = kC / sm90::kStepK;   // 32-deep K steps of one (C, C) weight: 16

struct ArgsF {
  const float* x;       // (M, C)
  const float* skip;    // (M, C) for the one block that takes a skip, or null
  const float* film[2]; // per block: (B, 2C) per scene, (M, 2C) per row, or null
  const float* W;       // split chunks (pack_tf32_tiles of the (nW * C, C) stack)
  const float* V;       // (nV, C): per block b1, g1s, g1b, b2, g2s, g2b [, bres]
  float* out;           // (M, C): block 1's output on its way to block 2, then the chain's
  int B, n, ts, nW, nV, nblocks;
  int spec[2];          // as Args90's
  float eps;
};

constexpr sm90::LayoutF kLayoutF = sm90::layout_tf32(kMaxVectors, 2);

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreadsF, 1)
    chain_tf32(const ArgsF a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr sm90::LayoutF L = kLayoutF;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* slots = reinterpret_cast<float*>(smem + L.slots);   // a block's input K tiles, then
                                                             // the slices of its h
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStagesF;
  uint64_t* xfull = empty + kStagesF;     // [q]: slot q holds its K tile
  uint64_t* xempty = xfull + kCluster;    // [q]: every CTA's products are done with slot q
  uint64_t* gbar = xempty + kCluster;     // [8b + q]: CTA q's slice of block b's h has landed

  const int grp = (int)cg::this_cluster().block_rank();   // GroupNorm group = column slice
  const int scene0 = (blockIdx.x / kCluster) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);             // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = grp * kGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesF; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    for (int q = 0; q < kCluster; ++q) {
      sm90::mbar_init(&xfull[q], 1);
      sm90::mbar_init(&xempty[q], kCluster);   // one arrival from each CTA
    }
    for (int q = 0; q < kCluster * a.nblocks; ++q) {
      sm90::mbar_init(&gbar[q], 1);
      // CTA q's slices land here; this CTA's own are local
      if (q % kCluster != grp) sm90::mbar_expect_tx(&gbar[q], kSlotF * 4);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  // Cluster barrier phases after (0), as in chain_sm90: (2b + 1) after
  // block b's first product (every CTA's slots are read), (2b + 2) after its
  // output is stored (the slices are read; block 1's output is in `out`).
  if (warp == kConsumers / 32) {
    // ---- producer warp: this CTA's weight chunks, every block in order ----
    if (lane == 0) {
      sm90::RingF w{ring, full, empty, 0, 0};
      const float* wg = a.W + (size_t)grp * a.nW * kStepsF * 2 * kChunkPartF;   // this CTA's
      auto put = [&](int wi, int st) {   // 32-deep step st of weight wi of the stack
        w.put(wg + (size_t)(wi * kStepsF + st) * 2 * kChunkPartF);
      };
      sm90::cluster_arrive_relaxed();   // (1)
      int wi = 0;
      for (int b = 0; b < a.nblocks; ++b) {
        const int spec = b ? a.spec[1] : a.spec[0];
        const bool skip = spec & 1, res = (spec >> 3) & 1;
        // the block's weights in the stack: w1, [w1s], w2, [wres, [wres_s]]
        const int w1 = wi, w1s = wi + 1, w2 = wi + 1 + skip, wr = w2 + 1, wrs = w2 + 2;
        for (int st = 0; st < kStepsF; ++st) {
          put(w1, st);
          if (res) put(wr, st);
        }
        if (skip) {   // a skip block has a residual projection
          for (int st = 0; st < kStepsF; ++st) {
            put(w1s, st);
            put(wrs, st);
          }
        }
        if (b > 0) {
          sm90::cluster_wait();             // (2b)
          sm90::cluster_arrive_relaxed();   // (2b + 1)
        }
        // W2's K steps in the order the second product takes the slices
        for (int kt = 0; kt < kCluster; ++kt)
          for (int h = 0; h < 2; ++h) put(w2, 2 * ((grp + kt) % kCluster) + h);
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

  if (warp == kConsumers / 32 + 1) {
    // ---- input loader warp: each block's [input | skip] K tiles through
    // the slots (sm90::SlotsF); block 2's input is block 1's output, read
    // back from `out` once the cluster barrier (2) says every CTA stored its
    // columns ----
    sm90::SlotsF in{slots, xfull, xempty, 0, 0};
    for (int b = 0; b < a.nblocks; ++b) {
      const int ntiles = kCluster * (1 + ((b ? a.spec[1] : a.spec[0]) & 1));
      const float* src = b ? a.out : a.x;
      if (b > 0) sm90::fence_proxy_async();   // the stores before (2) are read by bulk copies
      in.load(ntiles, rows, grp, [&](int kt, int r) {
        return (kt < kCluster ? src : a.skip) + (row0 + r) * kC + kGroup * (kt % kCluster);
      });
      in.advance(ntiles);
      sm90::cluster_arrive_relaxed();   // (2b + 1)
      sm90::cluster_wait();
      sm90::cluster_arrive_relaxed();   // (2b + 2)
      sm90::cluster_wait();
    }
    return;
  }

  // ---- consumer warpgroup ----
  for (int i = threadIdx.x; i < a.nV * kGroup; i += kConsumers)   // this CTA's vectors
    Vs[i] = a.V[(i / kGroup) * kC + col0 + i % kGroup];
  const int t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);    // this thread's rows: r0, r0 + 8
  float acc[32], accR[32];
  sm90::RingF w{ring, full, empty, 0, 0};
  sm90::SlotsF in{slots, xfull, xempty, 0, 0};
  const float* Vb = Vs;                      // this block's vectors
#pragma unroll 1
  for (int b = 0; b < a.nblocks; ++b) {
    const int spec = b ? a.spec[1] : a.spec[0];
    const bool skip = spec & 1, res = (spec >> 3) & 1;
    const int film_kind = (spec >> 1) & 3;
    const float* film = b ? a.film[1] : a.film[0];
    const float* xin = b ? a.out : a.x;      // the block's input

    // the first product: z = [input | skip] @ W1 (and the residual projection)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;
    sm90::input_products(res, acc, accR, kCluster * (1 + skip), in, w);
    // (2b + 1) this CTA's reads of its slots are done (their values are in
    // the finished products): the others may copy h into them
    sm90::bar_sync<kConsumers>(1);   // and Vs is written by every consumer
    sm90::cluster_arrive_relaxed();

    // z = z + b1; GN1 (clamped one-pass variance) with scene-FiLM folded
    // into its affine, row-FiLM after it, SiLU; this CTA's slice of h into
    // slot grp
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += Vb[8 * (i / 4) + 2 * t + (i & 1)];
    sm90::scene_moments<true>(acc, a.n, nsc, a.eps, red, stat);
    float* mine = slots + grp * kSlotF;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        const float mean = stat[sc], inv = stat[kTileRows + sc];
        const float* f = film_kind == 1 ? film + (size_t)(scene0 + sc) * 2 * kC + col0
                                        : film + (row0 + r) * 2 * kC + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          float z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float ca = inv * Vb[kGroup + c + e];
            float cb = Vb[2 * kGroup + c + e] - mean * inv * Vb[kGroup + c + e];
            const float fs = film_kind ? f[c + e] + 1.f : 1.f;
            const float fb = film_kind ? f[kC + c + e] : 0.f;
            if (film_kind == 1) {
              ca *= fs;
              cb = cb * fs + fb;
            }
            float v = acc[4 * j + 2 * half + e] * ca + cb;
            if (film_kind == 2) v = v * fs + fb;
            z[e] = silu_fast(v);
          }
          *reinterpret_cast<float2*>(mine + r * kLdF + c) = make_float2(z[0], z[1]);
        }
      }
    }
    // the exchange: once every CTA is done with its slots (2b + 1), this
    // slice into the other CTAs' slot grp
    sm90::exchange_slice_f32(slots, grp, gbar + kCluster * b);

    // the identity residual: the block input's values, exact, from device
    // memory (block 2's: block 1's output, which this thread stored)
    if (!res) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = r0 + 8 * ((i >> 1) & 1);
        accR[i] = r < rows ? xin[(row0 + r) * kC + col0 + 8 * (i / 4) + 2 * t + (i & 1)] : 0.f;
      }
    }

    // the second product: z2 = h @ W2, from this CTA's slice on, each other
    // one as it lands
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::slice_products(acc, accR, slots, grp, gbar + kCluster * b, w);

    // out = silu(GN2(z2 + b2)) + (the residual | its projection + bres),
    // this CTA's 64 columns
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += Vb[3 * kGroup + 8 * (i / 4) + 2 * t + (i & 1)];
    sm90::scene_moments<true>(acc, a.n, nsc, a.eps, red, stat);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        const float mean = stat[sc], inv = stat[kTileRows + sc];
        float* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e, i = 4 * j + 2 * half + e;
            const float ca = inv * Vb[4 * kGroup + c];
            const float cb = Vb[5 * kGroup + c] - mean * inv * Vb[4 * kGroup + c];
            v[e] = silu_fast(acc[i] * ca + cb) + (res ? accR[i] + Vb[6 * kGroup + c] : accR[i]);
          }
          *reinterpret_cast<float2*>(o + 8 * j + 2 * t) = make_float2(v[0], v[1]);
        }
      }
    }
    // (2b + 2) every slice of this CTA's h has landed and is read, and its
    // columns are stored.  Release, after a proxy fence: block 2's input
    // tiles are read back from them by bulk copies (the async proxy).
    // Block 2 stores into the same `out`, and no store of it can overtake
    // a peer's load of block 1's output: a CTA stores only after it holds
    // all 8 slices of block 2's h, which its peers send only once every CTA
    // of the cluster has finished its first product (2b + 1 of block 2), so
    // every K tile of block 1's output has landed in every CTA by then; the
    // other clusters read and write other rows
    sm90::fence_proxy_async();
    sm90::cluster_arrive();
    sm90::cluster_wait();
    Vb += (res ? 7 : 6) * kGroup;
  }
}

cudaError_t prepare_tf32() {   // once
  static const cudaError_t err = cudaFuncSetAttribute(
      chain_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLayoutF.total);
  return err;
}

// ---------------------------------------------------------------------------
// the other widths and groupings: the wide chain kernels, f32 and bf16
// ---------------------------------------------------------------------------
//
// chain_tf32_wide takes every f32 chain chain_tf32 does not, and
// chain_bf16_wide every bf16 chain chain_sm90 does not: C = 256, 512 or
// 1024 in 4, 8, 16 or 32 GroupNorm groups of at least 16 channels (the set
// the wide ResnetBlock kernels take), scenes of at most 64 rows, 1-2 blocks
// and at most one skip a chain.  Both are one body (chain_wide) over the
// element type: the wide ResnetBlock kernel's design (fused_resblock.cu,
// resblock_wide; its pieces in sm90.cuh) carried over a chain, as
// chain_sm90 carries resblock_sm90's.  A scene tile is one cluster of
// C / (64 kWG) CTAs (4 or 8) of kWG consumer warpgroups (1, or 2 at
// C = 1024) and a producer warp; warpgroup u of CTA c owns output columns
// [64 (kWG c + u), 64 (kWG c + u) + 64) of every product of the chain, in
// f32 on wgmma m64n64k8 .tf32 in split TF32 (32-deep K steps), in bf16 on
// wgmma m64n64k16 (64-deep K steps), f32 accumulation.  For each block:
//
// - the products take their A fragments from device memory through L2
//   (in f32 the next K step's wait as raw values and are split once the
//   step before retires, stream_products_late: a CTA of two warpgroups and
//   a producer warp has 168 registers a thread, and one warpgroup's CTA
//   measured no faster with two split sets); the first product
//   reads the block input (x, or block 1's output), and for a skip block
//   [input | skip] against the (2C, C) [w1; w1s] and [wres; wres_s]
//   weights, which the chain's stack holds as consecutive (C, C) weights;
//   W1 and the residual projection share the fragments;
// - the epilogues are the chain's (chain_sm90's and chain_tf32's), not
//   B1's: each dense output rounded to the compute dtype before its f32
//   moments, the one-pass variance clamped at 0, scene-FiLM folded into the
//   affine in f32 before a and b are rounded, row-FiLM after it as
//   z * (f + 1) + f in the compute dtype, SiLU in f32 then rounded, the
//   residual projection plus bres rounded before the add, the identity
//   residual read exact;
// - a GroupNorm group of 16 to 256 channels is merged from the
//   warpgroups' partial sums in ascending order, across the cluster where
//   it spans CTAs (wide_partials, wide_stats: C = 1024 in 4 groups spans
//   two CTAs of 128 columns);
// - h goes through the device scratch `h`: each CTA writes its columns, a
//   cluster barrier (release, then acquire) orders them before any CTA's
//   reads of the second product;
// - block 1's output goes to the device scratch `mid`, and after a cluster
//   barrier (release, then acquire) block 2 reads it as its A fragments
//   and identity residual; no activation moves CTA to CTA through
//   distributed shared memory (an exchange of block 1's output that way
//   faulted on the card, see chain_sm90).  The chain's output goes to
//   `out`, which no CTA reads, so no store can overwrite rows a peer still
//   reads.
//
// Four cluster barriers a block order a launch: (A) the GN1 partials, (B)
// h in device memory, (C) the GN2 partials, (E) the block's output stored
// and every CTA done reading the others' partials.  The producer warp
// streams W1 (and Wres) of each K step of a block, then W2's, every block
// in order, and passes each barrier in turn: it puts a block's W1 chunks
// once it has arrived at the barrier before them, so that it never waits
// on a stage that the consumers take only after that barrier.
//
// What bounds it.  A CTA streams its columns' weights of the whole chain
// from L2 (at C = 1024 a two-block chain with a skip: 7 (C, C) weights,
// 7 MiB a CTA in split f32, 1.75 MiB in bf16), and every row tile reads them
// again; A fragments come through L2, each tile's rows once per CTA; the
// cluster barriers serialise each block's phases.  The 19 chains of a
// B=64 forward of a dim-1024 equal-width model are 133.7 GFLOP: 0.135 ms at
// the bf16 tensor-core peak, 0.81 ms as three tf32 products each at the
// 495 TFLOP/s TF32 rate.

using sm90::kMaxLocal;
using sm90::kStagesW;
using sm90::Wide;
using sm90::wide_groups;

template <typename T>
struct ArgsCW {
  const T* x;           // (M, C)
  const T* skip;        // (M, C) for the one block that takes a skip, or null
  const T* film[2];     // per block: (B, 2C) per scene, (M, 2C) per row, or null
  const T* W;           // chunks (pack_chain_weights of the (nW * C, C) stack, Wide<T>)
  const float* V;       // (nV, C): per block b1, g1s, g1b, b2, g2s, g2b [, bres]
  T* h;                 // (M, C) scratch: a block's h
  T* mid;               // (M, C) scratch: block 1's output, block 2's input
  T* out;               // (M, C)
  int B, n, ts, C, gw, nW, nV, nblocks;
  int spec[2];          // as Args90's
  float eps;
};

template <typename T, int kWG>
__device__ __forceinline__ void chain_wide(const ArgsCW<T>& a) {
  constexpr int kCons = kWG * kConsumers;   // consumer threads
  constexpr int kCols = kWG * kGroup;       // this CTA's output columns
  constexpr int kStep = Wide<T>::kStep;     // depth of a K step
  constexpr int kPart = Wide<T>::kPart;     // elements of one warpgroup's chunk
  constexpr sm90::LayoutW L = sm90::layout_wide_of<T>(kWG, kMaxVectors);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float2* part = reinterpret_cast<float2*>(smem + L.part);
  float2* stat = reinterpret_cast<float2*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStagesW;

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ncta = (int)cluster.num_blocks();
  const int scene0 = (blockIdx.x / ncta) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);   // the last tile may be ragged
  const int rows = nsc * a.n;
  const int row0 = scene0 * a.n;          // the tile's first row
  const int steps = a.C / kStep;            // K steps of one (C, C) weight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cta0 = rank * kCols;            // this CTA's first output column

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kCons);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kCons / 32) {
    // ---- producer warp: each block's W1 (and Wres) of each K step, a
    // chunk for each warpgroup, then its W2's ----
    sm90::RingW<T, kWG> w{ring, full, empty, 0, 0};
    constexpr uint32_t kBytes = kPart * sizeof(T);
    const size_t group = (size_t)a.nW * steps * kPart;     // one 64-column group's chunks
    const T* mine = a.W + (size_t)rank * kWG * group;      // this CTA's
    auto put = [&](int wi, int st) {   // K step st from weight wi of the stack on
      w.put(mine + ((size_t)wi * steps + st) * kPart, kBytes, kWG, group);
    };
    int wi = 0;
    for (int b = 0; b < a.nblocks; ++b) {
      const int spec = b ? a.spec[1] : a.spec[0];
      const bool skip = spec & 1, res = (spec >> 3) & 1;
      // the block's weights in the stack: w1, [w1s], w2, [wres, [wres_s]]
      const int w1 = wi, w2 = wi + 1 + skip, wr = w2 + 1;
      if (lane == 0) {
        for (int st = 0; st < steps * (1 + skip); ++st) {
          put(w1, st);
          if (res) put(wr, st);
        }
      }
      if (b > 0) sm90::cluster_wait();   // (E) of the block before
      sm90::cluster_arrive_relaxed();    // (A)
      sm90::cluster_wait();
      sm90::cluster_arrive_relaxed();    // (B): the ring is empty now, W2's first stages go in
      if (lane == 0) {
        for (int st = 0; st < steps; ++st) put(w2, st);
      }
      sm90::cluster_wait();
      sm90::cluster_arrive_relaxed();    // (C)
      sm90::cluster_wait();
      sm90::cluster_arrive_relaxed();    // (E)
      wi = w2 + 1 + res + (skip && res);
    }
    sm90::cluster_wait();                // (E) of the last block
    return;
  }

  // ---- the consumer warpgroups: warpgroup u owns columns [64 u, 64 u +
  // 64) of this CTA's ----
  const int u = warp / 4, t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int col0 = cta0 + u * kGroup;             // this warpgroup's first output column
  // this thread's rows of the tile's (clamped: rows past a ragged tile
  // repeat its last, and their results are not stored)
  const int ra = row0 + min(r0, rows - 1), rb = row0 + min(r0 + 8, rows - 1);
  const int gwl = min(a.gw, kGroup);
  for (int i = threadIdx.x; i < a.nV * kCols; i += kCons)
    Vs[i] = a.V[(i / kCols) * a.C + cta0 + i % kCols];
  float acc[32], accR[32];
  sm90::RingW<T, kWG> w{ring, full, empty, 0, 0};

  // Block kb of the chain (a compile-time index: its spec, film, input and
  // output come from the kernel's parameters, not from registers that
  // would stay live across the products)
  auto block = [&](auto kb) {
    constexpr int b = decltype(kb)::value;
    const bool skip = a.spec[b] & 1, res = (a.spec[b] >> 3) & 1;
    const int film_kind = (a.spec[b] >> 1) & 3;
    // this block's vector k at vec[k * kCols]: block 1's follow block 0's 6 or 7
    const float* vec = Vs + u * kGroup + (b ? (a.spec[0] & 8 ? 7 : 6) * kCols : 0);
    const T* xin = b ? a.mid : a.x;    // the block's input

    // the first product: z = [input | skip] @ W1 (and the residual projection)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;
    auto src = [&](int st, int r) {
      int c = kStep * st + kStep / 4 * t;
      const T* base = xin;
      if (c >= a.C) base = a.skip, c -= a.C;
      return base + (size_t)r * a.C + c;
    };
    if (res)
      sm90::wide_products<T, true, true>(acc, accR, steps * (1 + skip), src, ra, rb, w,
                                            u * kPart);
    else
      sm90::wide_products<T, false, true>(acc, accR, steps, src, ra, rb, w, u * kPart);
    sm90::bar_sync<kCons>(1);   // Vs written by every consumer
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = tile::rnd<T>(acc[i] + vec[8 * (i / 4) + 2 * t + (i & 1)]);
    sm90::wide_partials<kCons>(acc, u, a.n, nsc, gwl, red, part);
    sm90::cluster_arrive();     // (A) every partial of the cluster is written
    sm90::cluster_wait();
    sm90::wide_stats<kCons, true>(rank, a.n, nsc, a.gw, a.eps, part, stat);
    sm90::bar_sync<kCons>(1);

    // GN1 with scene-FiLM folded into its affine, row-FiLM after it, SiLU;
    // this warpgroup's columns of h into the scratch
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        const T* f = film_kind == 1 ? a.film[b] + (size_t)(scene0 + sc) * 2 * a.C + col0
                                    : a.film[b] + (size_t)(row0 + r) * 2 * a.C + col0;
        T* hr = a.h + (size_t)(row0 + r) * a.C + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 m = stat[(u * kMaxLocal + 8 * j / gwl) * kTileRows + sc];
          const float2 fs = film_kind ? tile::ld2<T>(f + c) : make_float2(0.f, 0.f);
          const float2 fb = film_kind ? tile::ld2<T>(f + a.C + c) : make_float2(0.f, 0.f);
          float z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = e ? fs.y : fs.x, sh = e ? fb.y : fb.x;
            float ca = m.y * vec[kCols + c + e];
            float cb = vec[2 * kCols + c + e] - m.x * m.y * vec[kCols + c + e];
            if (film_kind == 1) {
              ca *= s + 1.f;
              cb = cb * (s + 1.f) + sh;
            }
            ca = tile::rnd<T>(ca);
            cb = tile::rnd<T>(cb);
            float v = tile::rnd<T>(tile::rnd<T>(acc[4 * j + 2 * half + e] * ca) + cb);
            if (film_kind == 2) v = tile::rnd<T>(tile::rnd<T>(v * tile::rnd<T>(s + 1.f)) + sh);
            z[e] = silu_fast(v);
          }
          tile::st2<T>(hr + c, z[0], z[1]);
        }
      }
    }
    sm90::cluster_arrive();     // (B) this CTA's columns of h are written (release)

    // the identity residual: the block input's values, exact (block 2's:
    // block 1's output, which this thread stored)
    if (!res) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = r0 + 8 * ((i >> 1) & 1);
        const size_t at = (size_t)(row0 + r) * a.C + col0 + 8 * (i / 4) + 2 * t + (i & 1);
        accR[i] = r < rows ? tile::to_f<T>(xin[at]) : 0.f;
      }
    }
    sm90::cluster_wait();       // (B) every CTA's columns of h are written (acquire)

    // the second product: z2 = h @ W2 from the scratch
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::wide_products<T, false, true>(
        acc, accR, steps,
        [&](int st, int r) { return a.h + (size_t)r * a.C + kStep * st + kStep / 4 * t; }, ra, rb,
        w, u * kPart);

    // out = round(silu(GN2(round(z2 + b2))) + res), this warpgroup's columns
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = tile::rnd<T>(acc[i] + vec[3 * kCols + 8 * (i / 4) + 2 * t + (i & 1)]);
    sm90::wide_partials<kCons>(acc, u, a.n, nsc, gwl, red, part);
    sm90::cluster_arrive();     // (C)
    sm90::cluster_wait();
    sm90::wide_stats<kCons, true>(rank, a.n, nsc, a.gw, a.eps, part, stat);
    sm90::bar_sync<kCons>(1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < rows) {
        const int sc = r / a.n;
        T* o = (b + 1 == a.nblocks ? a.out : a.mid) + (size_t)(row0 + r) * a.C + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 m = stat[(u * kMaxLocal + 8 * j / gwl) * kTileRows + sc];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const float ca = tile::rnd<T>(m.y * vec[4 * kCols + c + e]);
            const float cb =
                tile::rnd<T>(vec[5 * kCols + c + e] - m.x * m.y * vec[4 * kCols + c + e]);
            const float z = tile::rnd<T>(silu_fast(tile::rnd<T>(tile::rnd<T>(acc[i] * ca) + cb)));
            v[e] = z + (res ? tile::rnd<T>(accR[i] + vec[6 * kCols + c + e]) : accR[i]);
          }
          tile::st2<T>(o + c, v[0], v[1]);
        }
      }
    }
    // (E) this CTA's columns of the block's output are stored (release; block
    // 2 reads them from `mid`) and it is done reading the others' partials
    sm90::cluster_arrive();
    sm90::cluster_wait();
  };
  block(std::integral_constant<int, 0>{});
  if (a.nblocks == 2) block(std::integral_constant<int, 1>{});
}

template <int kWG>
__global__ void __launch_bounds__(kWG * kConsumers + 32, 1) chain_tf32_wide(const ArgsCW<float> a) {
  chain_wide<float, kWG>(a);
}

template <int kWG>
__global__ void __launch_bounds__(kWG * kConsumers + 32, 1) chain_bf16_wide(const ArgsCW<bf16> a) {
  chain_wide<bf16, kWG>(a);
}

// the wide chain kernel of element type T
template <typename T, int kWG>
auto chain_wide_kernel() {
  if constexpr (std::is_same<T, float>::value)
    return chain_tf32_wide<kWG>;
  else
    return chain_bf16_wide<kWG>;
}

template <typename T>
unsigned smem_wide(int C) {
  return sm90::layout_wide_of<T>(wide_groups(C), kMaxVectors).total;
}

template <typename T, int kWG>
cudaError_t prepare_wide() {   // once per instantiation
  static const cudaError_t err =
      cudaFuncSetAttribute(chain_wide_kernel<T, kWG>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm90::layout_wide_of<T>(kWG, kMaxVectors).total);
  return err;
}

template <typename T, int kWG>
int launch_wide_as(const ArgsCW<T>& a, cudaStream_t stream) {
  const cudaError_t err = prepare_wide<T, kWG>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::wide_config(
      a.C, kWG, sm90::layout_wide_of<T>(kWG, kMaxVectors).total, (a.B + a.ts - 1) / a.ts, stream,
      &attr);
  return (int)cudaLaunchKernelEx(&cfg, chain_wide_kernel<T, kWG>(), a);
}

template <typename T>
int launch_wide(const ArgsCW<T>& a, cudaStream_t stream) {
  return wide_groups(a.C) == 2 ? launch_wide_as<T, 2>(a, stream) : launch_wide_as<T, 1>(a, stream);
}

template <typename T, int kWG>
int wide_active_clusters_as(int C) {
  const cudaError_t err = prepare_wide<T, kWG>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::wide_config(
      C, kWG, sm90::layout_wide_of<T>(kWG, kMaxVectors).total, 64, nullptr, &attr);
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, chain_wide_kernel<T, kWG>(), &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <typename T>
int wide_active_clusters(int C) {
  return wide_groups(C) == 2 ? wide_active_clusters_as<T, 2>(C) : wide_active_clusters_as<T, 1>(C);
}

// weights and vectors of one block of `spec`
int block_weights(int spec) { return 2 + (spec & 1) + ((spec >> 3) & 1) + ((spec & 9) == 9); }
int block_vectors(int spec) { return 6 + ((spec >> 3) & 1); }

// the kernel arguments of element type T (Args90 or ArgsF)
template <class Args, class T>
Args chain_args(const void* x, const void* skip, const void* film0, const void* film1,
                const void* W, const float* V, void* out, int B, int n, float eps, int nblocks,
                const int (&spec)[2]) {
  Args a;
  a.x = static_cast<const T*>(x);
  a.skip = static_cast<const T*>(skip);
  a.film[0] = static_cast<const T*>(film0);
  a.film[1] = static_cast<const T*>(film1);
  a.W = static_cast<const T*>(W);
  a.V = V;
  a.out = static_cast<T*>(out);
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
  return a;
}

// The set the kernels take (both dtypes): C = 256, 512 or 1024 in 4, 8, 16
// or 32 groups of at least 16 channels, the set of the wide ResnetBlock
// kernels
bool takes(int C, int groups) {
  return (C == 256 || C == 512 || C == 1024) &&
         (groups == 4 || groups == 8 || groups == 16 || groups == 32) && C / groups >= 16;
}

// Whether the cluster-of-8 kernel of the dtype (chain_tf32, chain_sm90)
// takes a chain of the set: C = 512 in 8 groups; the dtype's wide kernel
// takes the rest
bool cluster8(int C, int groups) { return C == kC && groups == kCluster; }

// dynamic shared memory of one CTA of the `dtype` kernel that takes a chain
// of C channels in `groups` groups, with or without a skip
unsigned smem_bytes(int dtype, bool has_skip, int C, int groups) {
  if (!cluster8(C, groups)) return dtype == 1 ? smem_wide<bf16>(C) : smem_wide<float>(C);
  return dtype == 1 ? layout(has_skip).total : kLayoutF.total;
}

template <typename T>
ArgsCW<T> wide_args(const void* x, const void* skip, const void* film0, const void* film1,
                    const void* W, const float* V, void* h, void* mid, void* out, int B, int n,
                    int C, int groups, float eps, int nblocks, const int (&spec)[2]) {
  ArgsCW<T> a;
  a.x = static_cast<const T*>(x);
  a.skip = static_cast<const T*>(skip);
  a.film[0] = static_cast<const T*>(film0);
  a.film[1] = static_cast<const T*>(film1);
  a.W = static_cast<const T*>(W);
  a.V = V;
  a.h = static_cast<T*>(h);
  a.mid = static_cast<T*>(mid);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.n = n;
  a.ts = kTileRows / n;
  a.C = C;
  a.gw = C / groups;
  a.nW = a.nV = 0;
  for (int b = 0; b < nblocks; ++b) {
    a.nW += block_weights(spec[b]);
    a.nV += block_vectors(spec[b]);
  }
  a.nblocks = nblocks;
  a.spec[0] = spec[0];
  a.spec[1] = spec[1];
  a.eps = eps;
  return a;
}

// fused_chain_launch's body: the wide kernel when `wide`, else the
// cluster-of-8 kernel of the dtype (C = 512 in 8 groups only)
int launch(bool wide, int dtype, const void* x, const void* skip0, const void* skip1,
           const void* film0, const void* film1, const void* W, const float* V, void* h,
           void* mid, void* out, int B, int n, int C, int groups, float eps, int nblocks,
           int spec0, int spec1, void* stream) {
  const int spec[2] = {spec0, nblocks == 2 ? spec1 : 0};
  const void* skip[2] = {skip0, skip1};
  const void* film[2] = {film0, film1};
  if (n < 1 || B < 1 || nblocks < 1 || nblocks > 2 || (dtype != 0 && dtype != 1) ||
      n > kTileRows || !takes(C, groups) || (!wide && !cluster8(C, groups)) || (skip0 && skip1))
    return -1;
  for (int b = 0; b < nblocks; ++b) {
    const int film_kind = (spec[b] >> 1) & 3;
    if (((spec[b] & 1) != 0) != (skip[b] != nullptr) || film_kind > 2 ||
        (film_kind != 0) != (film[b] != nullptr) || ((spec[b] & 1) && !(spec[b] & 8)))
      return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* sk = skip0 ? skip0 : skip1;
  if (wide) {
    if (h == nullptr || (nblocks == 2 && mid == nullptr)) return -1;
    if (dtype == 1)
      return launch_wide(wide_args<bf16>(x, sk, film0, film1, W, V, h, mid, out, B, n, C, groups,
                                         eps, nblocks, spec),
                         s);
    return launch_wide(wide_args<float>(x, sk, film0, film1, W, V, h, mid, out, B, n, C, groups,
                                        eps, nblocks, spec),
                       s);
  }
  const unsigned grid = (unsigned)((B + kTileRows / n - 1) / (kTileRows / n)) * kCluster;
  const cudaError_t err = dtype == 1 ? prepare_sm90() : prepare_tf32();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    chain_sm90<<<grid, kThreads, layout(sk != nullptr).total, s>>>(
        chain_args<Args90, bf16>(x, sk, film0, film1, W, V, out, B, n, eps, nblocks, spec));
  else
    chain_tf32<<<grid, kThreadsF, kLayoutF.total, s>>>(
        chain_args<ArgsF, float>(x, sk, film0, film1, W, V, out, B, n, eps, nblocks, spec));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of one scene the kernel of `dtype` (0 float32, 1 bfloat16) takes
int fused_chain_max_rows(int dtype) { return kTileRows; }
// dynamic shared memory of one CTA of the `dtype` kernel that takes a chain
// of C channels in `groups` groups, with or without a skip
int fused_chain_smem_bytes(int dtype, int has_skip, int C, int groups) {
  return (int)smem_bytes(dtype, has_skip != 0, C, groups);
}
// whether a chain of C channels in `groups` groups runs the dtype's wide
// kernel (chain_tf32_wide, chain_bf16_wide), 1, or its cluster-of-8 kernel,
// 0; -1 outside the set
int fused_chain_wide(int C, int groups) { return takes(C, groups) ? !cluster8(C, groups) : -1; }

// clusters of that kernel that fit on the card at once, or minus a
// cudaError_t code
int fused_chain_max_active_clusters(int dtype, int has_skip, int C, int groups) {
  if (!cluster8(C, groups))
    return dtype == 1 ? wide_active_clusters<bf16>(C) : wide_active_clusters<float>(C);
  const cudaError_t err = dtype == 1 ? prepare_sm90() : prepare_tf32();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(dtype == 1 ? kThreads : kThreadsF);
  cfg.dynamicSmemBytes = smem_bytes(dtype, has_skip != 0, C, groups);
  int clusters = 0;
  const cudaError_t e = dtype == 1 ? cudaOccupancyMaxActiveClusters(&clusters, chain_sm90, &cfg)
                                   : cudaOccupancyMaxActiveClusters(&clusters, chain_tf32, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// dtype: 0 float32 (W packed by pack_tf32_tiles), 1 bfloat16 (by
// pack_group_tiles; for chain_bf16_wide with the k permuted).  Both take C
// = 256, 512 or 1024 in 4, 8, 16 or 32 groups of at least 16 channels,
// scenes of at most 64 rows and at most one skip a chain; C = 512 in 8
// groups runs the cluster-of-8 kernel, the rest the wide kernel (h and mid:
// (M, C) scratches of the dtype that the wide kernel writes, mid for a
// two-block chain; unused otherwise).  Returns a cudaError_t code (0 on
// success), or -1 for arguments the kernels do not take.
int fused_chain_launch(int dtype, const void* x, const void* skip0, const void* skip1,
                       const void* film0, const void* film1, const void* W, const float* V,
                       void* h, void* mid, void* out, int B, int n, int C, int groups, float eps,
                       int nblocks, int spec0, int spec1, void* stream) {
  return launch(!cluster8(C, groups), dtype, x, skip0, skip1, film0, film1, W, V, h, mid, out, B,
                n, C, groups, eps, nblocks, spec0, spec1, stream);
}

// The same on the dtype's wide kernel at any C and grouping of the set, C =
// 512 in 8 groups too (W packed for the wide kernel): for measuring it
// beside the cluster-of-8 kernel.
int fused_chain_launch_wide(int dtype, const void* x, const void* skip0, const void* skip1,
                            const void* film0, const void* film1, const void* W, const float* V,
                            void* h, void* mid, void* out, int B, int n, int C, int groups,
                            float eps, int nblocks, int spec0, int spec1, void* stream) {
  return launch(true, dtype, x, skip0, skip1, film0, film1, W, V, h, mid, out, B, n, C, groups,
                eps, nblocks, spec0, spec1, stream);
}

}  // extern "C"
