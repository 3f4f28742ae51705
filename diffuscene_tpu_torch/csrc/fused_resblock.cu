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
// bfloat16 (the b512 recipe's serving dtype; resblock_sm90 at C = 512 in 8
// GroupNorm groups of 64 channels, inputs of a multiple of 128 columns up to
// 1024, an identity residual over x alone; resblock_bf16_wide, below, at
// the rest of the set both dtypes take).  A scene tile (at most 64 rows: 5 scenes of 12, 3 of 21;
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
// What bounds the bf16 kernel.  One flagship block is 0.8-2.0 GFLOP at
// B=64, N=12, 1-2 us at the bf16 tensor-core peak, and needs 2-6 MB of
// device memory traffic.  The kernel is bound by latency along each CTA's
// chain of phases: the x tile's arrival, the weight stream of block1 from
// L2 (each of the 13-22 row tiles reads every weight matrix, 13-33 MB a
// block at B=64), the epilogues on one warpgroup, and the exchange of h
// through distributed shared memory.  The next steps are a 2-D cluster (row
// tiles x groups) with each weight chunk multicast to the row tiles that
// share it, and launches that overlap one block's prologue with the
// previous block's tail.
//
// float32 (resblock_tf32 at C = 512 in 8 groups, inputs up to 2048 wide;
// resblock_tf32_wide, below, at the other widths and groupings; the serving
// dtype of every diffusion config but the three b512 ones): the same scene
// tile (at most 64 rows, the wgmma M),
// cluster of 8 CTAs and CTA-local GroupNorm, with every product on the
// tensor cores in split TF32: an f32 value v is hi = rna_tf32(v) plus
// lo = rna_tf32(v - hi), and a product runs as hi*lo + lo*hi + hi*hi with
// f32 accumulation (wgmma m64n64k8 .tf32), about 2^-21 relative per
// product.  Never one pass of hi*hi alone: that keeps 11 bits and is
// another result.  In a CTA (192 threads):
//
// - shared memory decides the layout: an f32 tile of 64 rows x 1024 input
//   columns is 256 KB, so the tile never sits whole.  8 slots of 64 rows x
//   64 columns (rows 68 floats apart) take its K tiles in turn and then
//   the gathered h (slot q = CTA q's slice); the ring holds 5 chunks of 32
//   k x the CTA's 64 columns, split on the host into tf32 hi and lo
//   (pack_tf32_tiles, 16 KB), 224,272 bytes a CTA in all;
// - a producer warp streams the chunks (W1 and Wres of each K step in
//   turn, then W2's in the order block2 takes the slices) by bulk copies;
// - an x loader warp brings in each K tile: CTA g bulk-copies rows g,
//   g + 8, ... multicast into all 8 CTAs' slot, once all 8 are done with
//   the slot's previous K tile (one remote mbarrier arrival from each);
// - one consumer warpgroup reads its A fragments (the rows) from the slot,
//   two 16-byte loads a row (the chunks' k is permuted to match), splits
//   them into hi and lo in registers, and issues the products with B (the
//   chunk's hi and lo) by descriptor; the next K step's fragments are
//   loaded and split while a step's products run.  W1 and the residual
//   projection share the A fragments;
// - after GN1, FiLM and SiLU (f32) each CTA writes its f32 slice of h
//   into its slot and, once a cluster barrier says every CTA is done with
//   its slots, 7 threads bulk-copy it into the other CTAs' slot (shared::cta
//   to shared::cluster, completing on the peer's barrier for the slice).
//   The identity residual is read from device memory, exact.
//
// The slots, the ring, the split K step and the exchange are sm90.cuh's
// split-TF32 scene tile, shared with the f32 chain kernel (fused_chain.cu).
//
// What bounds the f32 kernel.  The 28 blocks of a B=64, N=12 forward are
// 33.42 GFLOP: 0.2025 ms as 3 x 33.42 GFLOP at the 495 TFLOP/s TF32 rate
// (0.4988 ms at the 67 TFLOP/s FP32 rate).  Each CTA streams its group's
// split W1, Wres and W2 from L2 (512 KB for a 512-wide block, 1.25 MB for a
// skip block), so a skip block's launch moves 130 MiB out of L2 at B=64; a
// CTA's chain of phases (first K tile, the products, the epilogues on one
// warpgroup, the exchange) sets the rest.  A 24-row tile with the product
// swapped (out^T = W^T x^T, rows as the wgmma N) was measured first:
// nearly 3x slower, its 2.7x as many row tiles each streaming every weight
// in 3 waves of clusters (PERF.md, section 6).
//
#include <cooperative_groups.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxIn = 2048;     // x and skip widths together, the set of both dtypes
constexpr int kMaxIn90 = 1024;   // resblock_sm90's (its x tile sits whole)

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

constexpr int kSmemMax = (int)layout(kMaxIn90).total;

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
// float32: the split-TF32 cluster kernel
// ---------------------------------------------------------------------------

using sm90::kChunkPartF;
using sm90::kLdF;
using sm90::kSlotF;
using sm90::kStagesF;
using sm90::kThreadsF;

struct ArgsF {
  const float* x;      // (M, kx)
  const float* skip;   // (M, ks) or null
  const float* film;   // (B, 2C) per scene, (M, 2C) per row, or null
  const float* W1;     // (8, (kx + ks) / 32, 2, 2048) split chunks (pack_tf32_tiles)
  const float* W2;     // (8, 16, 2, 2048)
  const float* Wres;   // like W1, or null (identity residual)
  const float* V;      // (7, C): b1, g1 scale, g1 bias, b2, g2 scale, g2 bias, bres
  float* out;          // (M, C)
  int B, n, kx, ks, ts, film_kind;
  float eps;
};

template <bool kRes>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreadsF, 1)
    resblock_tf32(const ArgsF a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr sm90::LayoutF L = sm90::layout_tf32(7, 1);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* slots = reinterpret_cast<float*>(smem + L.slots);   // slot q: x K tile q (mod 8),
                                                             // later slice q of h
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStagesF;
  uint64_t* xfull = empty + kStagesF;     // [q]: slot q holds its x K tile
  uint64_t* xempty = xfull + kCluster;    // [q]: every CTA's products are done with slot q
  uint64_t* gbar = xempty + kCluster;     // [q]: CTA q's slice of h has landed here

  const int grp = (int)cg::this_cluster().block_rank();   // GroupNorm group = column slice
  const int scene0 = (blockIdx.x / kCluster) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);             // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int nkt1 = (a.kx + a.ks) / sm90::kChunkK;      // 64-deep x K tiles
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
      sm90::mbar_init(&gbar[q], 1);
      if (q != grp) sm90::mbar_expect_tx(&gbar[q], kSlotF * 4);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  if (warp == kConsumers / 32) {
    // ---- producer warp: this CTA's weight chunks ----
    if (lane == 0) {
      sm90::RingF w{ring, full, empty, 0, 0};
      const int nsteps = 2 * nkt1;
      const float* w1 = a.W1 + (size_t)grp * nsteps * 2 * kChunkPartF;
      const float* wr = kRes ? a.Wres + (size_t)grp * nsteps * 2 * kChunkPartF : nullptr;
      for (int st = 0; st < nsteps; ++st) {
        w.put(w1 + (size_t)st * 2 * kChunkPartF);
        if (kRes) w.put(wr + (size_t)st * 2 * kChunkPartF);
      }
      sm90::cluster_arrive_relaxed();      // (1) before W2, which waits on the second product
      // W2's K steps in the order block2 takes the slices: this CTA's first
      const float* w2 = a.W2 + (size_t)grp * 2 * kCluster * 2 * kChunkPartF;
      for (int kt = 0; kt < kCluster; ++kt)
        for (int h = 0; h < 2; ++h)
          w.put(w2 + (size_t)(2 * ((grp + kt) % kCluster) + h) * 2 * kChunkPartF);
    } else {
      sm90::cluster_arrive_relaxed();      // (1)
    }
    sm90::cluster_wait();          // (1)
    sm90::cluster_arrive_relaxed();        // (2)
    sm90::cluster_wait();          // (2)
    return;
  }

  if (warp == kConsumers / 32 + 1) {
    // ---- x loader warp: the [x | skip] tile's K tiles through the slots
    // (sm90::SlotsF) ----
    sm90::SlotsF in{slots, xfull, xempty, 0, 0};
    in.load(nkt1, rows, grp, [&](int kt, int r) {
      const int c = sm90::kChunkK * kt;
      const size_t row = row0 + r;
      return c < a.kx ? a.x + row * a.kx + c : a.skip + row * a.ks + (c - a.kx);
    });
    sm90::cluster_arrive_relaxed();        // (1)
    sm90::cluster_wait();
    sm90::cluster_arrive_relaxed();        // (2)
    sm90::cluster_wait();
    return;
  }

  // ---- consumer warpgroup ----
  // this CTA's 7 vectors (used after block1)
  for (int i = threadIdx.x; i < 7 * kGroup; i += kConsumers)
    Vs[i] = a.V[(i / kGroup) * kC + col0 + i % kGroup];
  float acc[32], accR[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;
  sm90::RingF w{ring, full, empty, 0, 0};
  sm90::SlotsF in{slots, xfull, xempty, 0, 0};

  // block1: h = [x | skip] @ W1 + b1 (and the residual projection), f32
  sm90::input_products(kRes, acc, accR, nkt1, in, w);
  // (1) this CTA's loads of its slots are done (their values are in the
  // finished products): the others may copy h into them
  sm90::bar_sync<kConsumers>(1);   // Vs written by every consumer
  sm90::cluster_arrive_relaxed();

  const int t = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);    // this thread's rows: r0, r0 + 8
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += Vs[8 * (i / 4) + 2 * t + (i & 1)];
  sm90::scene_moments<false>(acc, a.n, nsc, a.eps, red, stat);

  // GN1, FiLM, SiLU; this CTA's slice of h into slot grp
  float* mine = slots + grp * kSlotF;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r < rows) {
      const int sc = r / a.n;
      const float mean = stat[sc], inv = stat[kTileRows + sc];
      const float* f = a.film_kind == 1 ? a.film + (size_t)(scene0 + sc) * 2 * kC + col0
                                        : a.film + (row0 + r) * 2 * kC + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        float z0 = (acc[4 * j + 2 * half] - mean) * inv * Vs[kGroup + c] + Vs[2 * kGroup + c];
        float z1 =
            (acc[4 * j + 2 * half + 1] - mean) * inv * Vs[kGroup + c + 1] + Vs[2 * kGroup + c + 1];
        if (a.film_kind) {
          const float2 fs = *reinterpret_cast<const float2*>(f + c);
          const float2 fb = *reinterpret_cast<const float2*>(f + kC + c);
          z0 = z0 * (fs.x + 1.f) + fb.x;
          z1 = z1 * (fs.y + 1.f) + fb.y;
        }
        *reinterpret_cast<float2*>(mine + r * kLdF + c) = make_float2(silu_fast(z0), silu_fast(z1));
      }
    }
  }

  // the exchange: once every CTA of the cluster is done with its slots,
  // this slice into the other CTAs' slot grp
  sm90::exchange_slice_f32(slots, grp, gbar);

  // the identity residual: this thread's x values, exact, from device memory
  float res[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1);
    res[i] = !kRes && r < rows ? a.x[(row0 + r) * a.kx + col0 + 8 * (i / 4) + 2 * t + (i & 1)]
                               : 0.f;
  }

  // block2: h = h @ W2 + b2, from this CTA's slice on, each other one as it
  // lands; then GroupNorm, SiLU, the residual, the store
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sm90::slice_products(acc, accR, slots, grp, gbar, w);
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
      float* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const int i = 4 * j + 2 * half;
        const float h0 = silu_fast((acc[i] - mean) * inv * Vs[4 * kGroup + c] + Vs[5 * kGroup + c]);
        const float h1 =
            silu_fast((acc[i + 1] - mean) * inv * Vs[4 * kGroup + c + 1] + Vs[5 * kGroup + c + 1]);
        float res0 = res[i], res1 = res[i + 1];
        if constexpr (kRes) {
          res0 = accR[i] + Vs[6 * kGroup + c];
          res1 = accR[i + 1] + Vs[6 * kGroup + c + 1];
        }
        *reinterpret_cast<float2*>(o + c) = make_float2(h0 + res0, h1 + res1);
      }
    }
  }
  sm90::cluster_wait();            // (2) no CTA leaves before every slice has landed
}

constexpr int kSmemF = (int)sm90::layout_tf32(7, 1).total;

template <bool kRes>
cudaError_t prepare_tf32() {   // once per instantiation
  static const cudaError_t err = cudaFuncSetAttribute(
      resblock_tf32<kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF);
  return err;
}

int launch_tf32(const ArgsF& a, cudaStream_t stream) {
  const cudaError_t err = a.Wres ? prepare_tf32<true>() : prepare_tf32<false>();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.B + a.ts - 1) / a.ts) * kCluster;
  if (a.Wres)
    resblock_tf32<true><<<grid, kThreadsF, kSmemF, stream>>>(a);
  else
    resblock_tf32<false><<<grid, kThreadsF, kSmemF, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the other widths and groupings: the wide kernels, f32 and bf16
// ---------------------------------------------------------------------------
//
// resblock_tf32_wide takes every f32 block resblock_tf32 does not, and
// resblock_bf16_wide every bf16 block resblock_sm90 does not: C = 256, 512
// or 1024, GroupNorm groups of 16 to 256 channels, inputs up to 2048 wide
// (bf16: any multiple of 64), an identity residual over [x | skip].  Both
// are one body (resblock_wide) over the element type.  The scene tile (at
// most 64 rows) is again one cluster, now of C / (64 kWG) CTAs (4 or 8),
// and CTA c owns output columns [64 kWG c, 64 kWG (c + 1)): kWG consumer
// warpgroups (1, or 2 at C = 1024), each running one 64-column chunk of
// both products, in f32 on wgmma m64n64k8 .tf32 in split TF32 as
// resblock_tf32 does (32-deep K steps), in bf16 on wgmma m64n64k16 (64-deep
// K steps, f32 accumulation).  What changes:
//
// - shared memory holds no activation: at C = 1024 one tile's h (64 x 1024
//   f32) is 256 KB, beyond a CTA's 227 KB, and so is the [x | skip] tile
//   of a 2048-wide input (f32, or bf16 with the ring beside it).  Each
//   consumer thread reads its A fragments (8 f32 or 16 bf16 columns of its
//   2 rows a K step, two 16-byte loads a row) from device memory through
//   L2, the next step's while a step's products run; shared memory holds
//   the ring of weight chunks (4 stages, each one chunk per warpgroup: 16
//   or 32 KB split f32, 8 or 16 KB bf16), the CTA's vectors and the
//   moments.  bf16 could keep a tile of at most 1024 columns in rolling
//   K-tile slots, as resblock_tf32 does; it reads from L2 like the f32 body
//   instead, so that both dtypes are one kernel body and take 2048-wide
//   inputs;
// - h goes through device memory: each CTA writes its columns of h into a
//   (M, C) scratch of the element type, and a cluster barrier (release,
//   then acquire) orders every CTA's writes before any CTA's reads of the
//   second product.  The bf16 scratch is h rounded to bf16, which is B1's
//   one rounding of h, as the second product's operand.  No byte moves CTA
//   to CTA through distributed shared memory but the moments below;
// - a GroupNorm group is no longer a CTA's columns.  Each warpgroup sums
//   its rows' values and squares in 8-column blocks (a fixed order: a
//   thread's pair, the row's 4 threads by shuffles), then each scene's rows
//   and the blocks of each of its groups (16 to 64 channels) in turn; a
//   group of 128 or 256 channels spans 2 or 4 warpgroups, of this CTA or of
//   the cluster's next ones, and after a cluster barrier every CTA of the
//   group sums their partial sums in the same order (ld.shared::cluster, as
//   the chamfer kernel merges its partials), so all agree.  The moments
//   stay one-pass, f32, unclamped, over the unrounded dense output: B1's.
//   FiLM (bf16: (scale + 1) rounded to bf16, as the plain version adds in
//   bf16), SiLU and the residual run in f32; the output is rounded once.
//
// Four cluster barriers order a launch: (A) the GN1 partials, (B) h in
// device memory, (C) the GN2 partials, (D) no CTA leaves while another reads
// its partials.  The producer warp streams W1 (and Wres) of each K step,
// then W2's, and passes each barrier in turn; between (A) and (B) the ring
// is empty, so it may put W2's first stages before it waits.
//
// What bounds it.  A CTA streams its columns' weights from L2: at C = 1024
// and a 2048-wide input with a projection, 5 MB a CTA in split f32 (W1,
// Wres, W2), 1.25 MB in bf16, 520 and 130 MB of L2 reads a launch at B=64,
// N=12 (13 tiles x 8 CTAs); A fragments come through L2 too, each tile's
// rows once per CTA, and the four cluster barriers serialise the phases.
// They are simple kernels that are right, the f32 one 3-4x its split-TF32
// bound (PERF.md, section 6); making them fast (weights multicast to the
// row tiles that share them, A tiles in shared memory) is later work.

using sm90::kMaxLocal;
using sm90::kStagesW;
using sm90::layout_wide_of;
using sm90::LayoutW;
using sm90::RingW;
using sm90::Wide;
using sm90::wide_groups;
using sm90::wide_partials;
using sm90::wide_products;
using sm90::wide_stats;

template <typename T>
struct ArgsW {
  const T* x;      // (M, kx)
  const T* skip;   // (M, ks) or null
  const T* film;   // (B, 2C) per scene, (M, 2C) per row, or null
  const T* W1;     // (C / 64, (kx + ks) / kStep, kPart) chunks (Wide<T>)
  const T* W2;     // (C / 64, C / kStep, kPart)
  const T* Wres;   // like W1, or null (identity residual over [x | skip])
  const float* V;  // (7, C): b1, g1 scale, g1 bias, b2, g2 scale, g2 bias, bres
  T* h;            // (M, C) scratch: block1's output
  T* out;          // (M, C)
  int B, n, kx, ks, C, gw, ts, film_kind;
  float eps;
};

template <typename T, int kWG, bool kRes>
__device__ __forceinline__ void resblock_wide(const ArgsW<T>& a) {
  constexpr int kCons = kWG * kConsumers;   // consumer threads
  constexpr int kCols = kWG * kGroup;       // this CTA's output columns
  constexpr int kStep = Wide<T>::kStep;     // depth of a K step
  constexpr int kPart = Wide<T>::kPart;     // elements of one warpgroup's chunk
  constexpr LayoutW L = layout_wide_of<T>(kWG);
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
  const size_t row0 = (size_t)scene0 * a.n;
  const int nst1 = (a.kx + a.ks) / kStep, nst2 = a.C / kStep;
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
    // ---- producer warp: W1 (and Wres) of each K step, a chunk for each
    // warpgroup (group 64-column chunks rank kWG + u), then W2's ----
    RingW<T, kWG> w{ring, full, empty, 0, 0};
    const size_t g0 = (size_t)rank * kWG;
    constexpr uint32_t kBytes = kPart * sizeof(T);
    if (lane == 0) {
      const T* w1 = a.W1 + g0 * nst1 * kPart;
      const T* wr = kRes ? a.Wres + g0 * nst1 * kPart : nullptr;
      for (int st = 0; st < nst1; ++st) {
        w.put(w1 + (size_t)st * kPart, kBytes, kWG, (size_t)nst1 * kPart);
        if (kRes) w.put(wr + (size_t)st * kPart, kBytes, kWG, (size_t)nst1 * kPart);
      }
    }
    sm90::cluster_arrive_relaxed();   // (A)
    sm90::cluster_wait();
    sm90::cluster_arrive_relaxed();   // (B): the ring is empty now, W2's first stages go in
    if (lane == 0) {
      const T* w2 = a.W2 + g0 * nst2 * kPart;
      for (int st = 0; st < nst2; ++st)
        w.put(w2 + (size_t)st * kPart, kBytes, kWG, (size_t)nst2 * kPart);
    }
    sm90::cluster_wait();
    sm90::cluster_arrive_relaxed();   // (C)
    sm90::cluster_wait();
    sm90::cluster_arrive_relaxed();   // (D)
    sm90::cluster_wait();
    return;
  }

  // ---- the consumer warpgroups: warpgroup u owns columns [64 u, 64 u +
  // 64) of this CTA's ----
  const int u = warp / 4, t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int col0 = cta0 + u * kGroup;             // this warpgroup's first output column
  const size_t ra = row0 + min(r0, rows - 1), rb = row0 + min(r0 + 8, rows - 1);
  const int gwl = min(a.gw, kGroup);
  for (int i = threadIdx.x; i < 7 * kCols; i += kCons)
    Vs[i] = a.V[(i / kCols) * a.C + cta0 + i % kCols];
  const float* vec = Vs + u * kGroup;   // vector k of this warpgroup's columns at vec[k * kCols]
  float acc[32], accR[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = accR[i] = 0.f;
  RingW<T, kWG> w{ring, full, empty, 0, 0};

  // block1: h = [x | skip] @ W1 + b1 (and the residual projection), f32
  wide_products<T, kRes>(
      acc, accR, nst1,
      [&](int st, size_t r) {
        int c = kStep * st + kStep / 4 * t, ld = a.kx;
        const T* base = a.x;
        if (c >= a.kx) base = a.skip, ld = a.ks, c -= a.kx;
        return base + r * ld + c;
      },
      ra, rb, w, u * kPart);
  sm90::bar_sync<kCons>(1);   // Vs written by every consumer
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += vec[8 * (i / 4) + 2 * t + (i & 1)];
  wide_partials<kCons>(acc, u, a.n, nsc, gwl, red, part);
  sm90::cluster_arrive();         // (A) every partial of the cluster is written
  sm90::cluster_wait();
  wide_stats<kCons>(rank, a.n, nsc, a.gw, a.eps, part, stat);
  sm90::bar_sync<kCons>(1);

  // GN1, FiLM, SiLU; this warpgroup's columns of h into the scratch
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r < rows) {
      const int sc = r / a.n;
      const T* f = a.film_kind == 1 ? a.film + (size_t)(scene0 + sc) * 2 * a.C + col0
                                    : a.film + (row0 + r) * 2 * a.C + col0;
      T* hr = a.h + (row0 + r) * a.C + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 m = stat[(u * kMaxLocal + 8 * j / gwl) * kTileRows + sc];
        float z0 = (acc[4 * j + 2 * half] - m.x) * m.y * vec[kCols + c] + vec[2 * kCols + c];
        float z1 = (acc[4 * j + 2 * half + 1] - m.x) * m.y * vec[kCols + c + 1] +
                   vec[2 * kCols + c + 1];
        if (a.film_kind) {
          const float2 fs = tile::ld2<T>(f + c), fb = tile::ld2<T>(f + a.C + c);
          z0 = z0 * tile::rnd<T>(fs.x + 1.f) + fb.x;
          z1 = z1 * tile::rnd<T>(fs.y + 1.f) + fb.y;
        }
        tile::st2<T>(hr + c, silu_fast(z0), silu_fast(z1));
      }
    }
  }
  sm90::cluster_arrive();         // (B) this CTA's columns of h are written (release)

  // the identity residual: this thread's [x | skip] values, exact
  float res[32];
  {
    const bool in_x = col0 < a.kx;
    const T* base = in_x ? a.x : a.skip;
    const int ld = in_x ? a.kx : a.ks, c0 = in_x ? col0 : col0 - a.kx;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      res[i] = !kRes && r < rows
                   ? tile::to_f<T>(base[(row0 + r) * ld + c0 + 8 * (i / 4) + 2 * t + (i & 1)])
                   : 0.f;
    }
  }
  sm90::cluster_wait();           // (B) every CTA's columns of h are written (acquire)

  // block2: h @ W2 + b2 from the scratch; then GroupNorm, SiLU, the
  // residual, the store
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wide_products<T, false>(
      acc, accR, nst2,
      [&](int st, size_t r) { return a.h + r * a.C + kStep * st + kStep / 4 * t; }, ra, rb, w,
      u * kPart);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += vec[3 * kCols + 8 * (i / 4) + 2 * t + (i & 1)];
  wide_partials<kCons>(acc, u, a.n, nsc, gwl, red, part);
  sm90::cluster_arrive();         // (C)
  sm90::cluster_wait();
  wide_stats<kCons>(rank, a.n, nsc, a.gw, a.eps, part, stat);
  sm90::cluster_arrive();         // (D) this CTA is done reading the others' partials
  sm90::bar_sync<kCons>(1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r < rows) {
      const int sc = r / a.n;
      T* o = a.out + (row0 + r) * a.C + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const int i = 4 * j + 2 * half;
        const float2 m = stat[(u * kMaxLocal + 8 * j / gwl) * kTileRows + sc];
        const float h0 =
            silu_fast((acc[i] - m.x) * m.y * vec[4 * kCols + c] + vec[5 * kCols + c]);
        const float h1 =
            silu_fast((acc[i + 1] - m.x) * m.y * vec[4 * kCols + c + 1] + vec[5 * kCols + c + 1]);
        float res0 = res[i], res1 = res[i + 1];
        if constexpr (kRes) {
          res0 = accR[i] + vec[6 * kCols + c];
          res1 = accR[i + 1] + vec[6 * kCols + c + 1];
        }
        tile::st2<T>(o + c, h0 + res0, h1 + res1);
      }
    }
  }
  sm90::cluster_wait();           // (D) no CTA leaves while another reads its partials
}

template <int kWG, bool kRes>
__global__ void __launch_bounds__(kWG * kConsumers + 32, 1)
    resblock_tf32_wide(const ArgsW<float> a) {
  resblock_wide<float, kWG, kRes>(a);
}

template <int kWG, bool kRes>
__global__ void __launch_bounds__(kWG * kConsumers + 32, 1)
    resblock_bf16_wide(const ArgsW<bf16> a) {
  resblock_wide<bf16, kWG, kRes>(a);
}

// the wide kernel of element type T
template <typename T, int kWG, bool kRes>
auto wide_kernel() {
  if constexpr (std::is_same<T, float>::value)
    return resblock_tf32_wide<kWG, kRes>;
  else
    return resblock_bf16_wide<kWG, kRes>;
}

template <typename T, int kWG, bool kRes>
cudaError_t prepare_wide() {   // once per instantiation
  static const cudaError_t err =
      cudaFuncSetAttribute(wide_kernel<T, kWG, kRes>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)layout_wide_of<T>(kWG).total);
  return err;
}

template <typename T, int kWG, bool kRes>
int launch_wide_as(const ArgsW<T>& a, cudaStream_t stream) {
  const cudaError_t err = prepare_wide<T, kWG, kRes>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::wide_config(a.C, kWG, layout_wide_of<T>(kWG).total,
                                                   (a.B + a.ts - 1) / a.ts, stream, &attr);
  return (int)cudaLaunchKernelEx(&cfg, wide_kernel<T, kWG, kRes>(), a);
}

template <typename T>
int launch_wide(const ArgsW<T>& a, cudaStream_t stream) {
  if (wide_groups(a.C) == 2)
    return a.Wres ? launch_wide_as<T, 2, true>(a, stream) : launch_wide_as<T, 2, false>(a, stream);
  return a.Wres ? launch_wide_as<T, 1, true>(a, stream) : launch_wide_as<T, 1, false>(a, stream);
}

template <typename T, int kWG, bool kRes>
int wide_active_clusters_as(int C) {
  const cudaError_t err = prepare_wide<T, kWG, kRes>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      sm90::wide_config(C, kWG, layout_wide_of<T>(kWG).total, 64, nullptr, &attr);
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, wide_kernel<T, kWG, kRes>(), &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <typename T>
int wide_active_clusters(int C, bool has_res) {
  if (wide_groups(C) == 2)
    return has_res ? wide_active_clusters_as<T, 2, true>(C) : wide_active_clusters_as<T, 2, false>(C);
  return has_res ? wide_active_clusters_as<T, 1, true>(C) : wide_active_clusters_as<T, 1, false>(C);
}

// The set both dtypes take: C = 256, 512 or 1024 in 4, 8, 16 or 32 groups
// of at least 16 channels, x and skip widths of multiples of 64 (x > 0) up
// to kMaxIn together
bool takes(int C, int groups, int kx, int ks) {
  return (C == 256 || C == 512 || C == 1024) &&
         (groups == 4 || groups == 8 || groups == 16 || groups == 32) && C / groups >= 16 &&
         kx >= sm90::kChunkK && kx % sm90::kChunkK == 0 && ks >= 0 && ks % sm90::kChunkK == 0 &&
         kx + ks <= kMaxIn;
}

// Whether the cluster-of-8 kernel of `dtype` (0 resblock_tf32, 1
// resblock_sm90) takes a block of the set: C = 512 in 8 groups with a
// projection or an identity residual over x alone, in bf16 with inputs of
// a multiple of 128 columns up to kMaxIn90; the dtype's wide kernel takes
// the rest
bool cluster8(int dtype, int C, int groups, int kx, int ks, bool has_res) {
  return C == kC && groups == kCluster && (has_res || ks == 0) &&
         (dtype == 0 || ((kx + ks) % (2 * sm90::kChunkK) == 0 && kx + ks <= kMaxIn90));
}

template <typename T>
ArgsW<T> wide_args(const void* x, const void* skip, const void* film, int film_kind,
                   const void* W1, const void* W2, const void* Wres, const float* V, void* h,
                   void* out, int B, int n, int C, int kx, int ks, int groups, float eps) {
  ArgsW<T> a;
  a.x = static_cast<const T*>(x);
  a.skip = static_cast<const T*>(skip);
  a.film = static_cast<const T*>(film);
  a.W1 = static_cast<const T*>(W1);
  a.W2 = static_cast<const T*>(W2);
  a.Wres = static_cast<const T*>(Wres);
  a.V = V;
  a.h = static_cast<T*>(h);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.n = n;
  a.kx = kx;
  a.ks = ks;
  a.C = C;
  a.gw = C / groups;
  a.ts = kTileRows / n;
  a.film_kind = film_kind;
  a.eps = eps;
  return a;
}

}  // namespace

extern "C" {

// rows of one scene the kernels (either dtype) take
int fused_resblock_max_rows() { return kTileRows; }
// x and skip widths together
int fused_resblock_max_in() { return kMaxIn; }
// dynamic shared memory of one CTA of the kernel that takes a `dtype`
// block of C channels in `groups` groups, kx + ks input columns and a
// residual projection (has_res) or not
int fused_resblock_smem_bytes(int dtype, int C, int groups, int kx, int ks, int has_res) {
  if (cluster8(dtype, C, groups, kx, ks, has_res)) return dtype == 1 ? (int)layout(kx + ks).total : kSmemF;
  return dtype == 1 ? (int)layout_wide_of<bf16>(wide_groups(C)).total
                    : (int)layout_wide_of<float>(wide_groups(C)).total;
}

// clusters of that kernel that fit on the card at once, or minus a
// cudaError_t code
int fused_resblock_max_active_clusters(int dtype, int C, int groups, int kx, int ks, int has_res) {
  if (!cluster8(dtype, C, groups, kx, ks, has_res))
    return dtype == 1 ? wide_active_clusters<bf16>(C, has_res)
                      : wide_active_clusters<float>(C, has_res);
  const cudaError_t err = dtype == 1 ? (has_res ? prepare_sm90<true>() : prepare_sm90<false>())
                                     : (has_res ? prepare_tf32<true>() : prepare_tf32<false>());
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(dtype == 1 ? kThreads : kThreadsF);
  cfg.dynamicSmemBytes = fused_resblock_smem_bytes(dtype, C, groups, kx, ks, has_res);
  int clusters = 0;
  cudaError_t e;
  if (dtype == 1)
    e = has_res ? cudaOccupancyMaxActiveClusters(&clusters, resblock_sm90<true>, &cfg)
                : cudaOccupancyMaxActiveClusters(&clusters, resblock_sm90<false>, &cfg);
  else
    e = has_res ? cudaOccupancyMaxActiveClusters(&clusters, resblock_tf32<true>, &cfg)
                : cudaOccupancyMaxActiveClusters(&clusters, resblock_tf32<false>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// dtype: 0 float32 (weights packed by pack_tf32_tiles), 1 bfloat16 (by
// pack_group_tiles; for resblock_bf16_wide with the k permuted).  Both take
// C = 256, 512 or 1024 in 4, 8, 16 or 32 groups of at least 16 channels
// and input widths of multiples of 64 up to 2048 together, an identity
// residual over [x | skip]; C = 512 in 8 groups runs the cluster-of-8
// kernel where it takes the block (cluster8), the rest the wide kernel (h:
// an (M, C) scratch of the dtype that the wide kernel writes, unused
// otherwise).  Returns a cudaError_t code (0 on success), or -1 for
// arguments the kernels do not take.
int fused_resblock_launch(int dtype, const void* x, const void* skip, const void* film,
                          int film_kind, const void* W1, const void* W2, const void* Wres,
                          const float* V, void* h, void* out, int B, int n, int C, int kx, int ks,
                          int groups, float eps, void* stream) {
  if (n < 1 || n > kTileRows || B < 1 || ks < 0 || (ks > 0) != (skip != nullptr) ||
      film_kind < 0 || film_kind > 2 || (film_kind != 0) != (film != nullptr) ||
      (Wres == nullptr && kx + ks != C) || (dtype != 0 && dtype != 1) ||
      !takes(C, groups, kx, ks))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cluster8(dtype, C, groups, kx, ks, Wres != nullptr)) {
    if (h == nullptr) return -1;
    if (dtype == 1)
      return launch_wide(wide_args<bf16>(x, skip, film, film_kind, W1, W2, Wres, V, h, out, B, n,
                                         C, kx, ks, groups, eps),
                         s);
    return launch_wide(wide_args<float>(x, skip, film, film_kind, W1, W2, Wres, V, h, out, B, n,
                                        C, kx, ks, groups, eps),
                       s);
  }
  if (dtype == 1) {
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
  ArgsF a;
  a.x = static_cast<const float*>(x);
  a.skip = static_cast<const float*>(skip);
  a.film = static_cast<const float*>(film);
  a.W1 = static_cast<const float*>(W1);
  a.W2 = static_cast<const float*>(W2);
  a.Wres = static_cast<const float*>(Wres);
  a.V = V;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.n = n;
  a.kx = kx;
  a.ks = ks;
  a.ts = kTileRows / n;
  a.film_kind = film_kind;
  a.eps = eps;
  return launch_tf32(a, s);
}

}  // extern "C"
