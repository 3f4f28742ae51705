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
// bfloat16 (the b512 recipe's serving dtype; resblock_sm90): C = 512 in 8 GroupNorm groups
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
// float32 (resblock_tf32; the serving dtype of every diffusion config but
// the three b512 ones): the same scene tile (at most 64 rows, the wgmma M),
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

}  // namespace

extern "C" {

// rows of one scene the kernel of `dtype` (0 float32, 1 bfloat16) takes
int fused_resblock_max_rows(int dtype) { return kTileRows; }
int fused_resblock_max_in() { return kMaxIn; }
// dynamic shared memory of one CTA of the `dtype` kernel for kx + ks input
// columns
int fused_resblock_smem_bytes(int dtype, int kx, int ks) {
  return dtype == 1 ? (int)layout(kx + ks).total : kSmemF;
}

// clusters of the `dtype` kernel that fit on the card at once, or minus a
// cudaError_t code
int fused_resblock_max_active_clusters(int dtype, int kx, int ks, int has_res) {
  const cudaError_t err = dtype == 1 ? (has_res ? prepare_sm90<true>() : prepare_sm90<false>())
                                     : (has_res ? prepare_tf32<true>() : prepare_tf32<false>());
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(dtype == 1 ? kThreads : kThreadsF);
  cfg.dynamicSmemBytes = fused_resblock_smem_bytes(dtype, kx, ks);
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
// pack_group_tiles).  Both take C = 512 in 8 groups and input widths of
// multiples of 64.  Returns a cudaError_t code (0 on success), or -1 for
// arguments the kernel does not take.
int fused_resblock_launch(int dtype, const void* x, const void* skip, const void* film,
                          int film_kind, const void* W1, const void* W2, const void* Wres,
                          const float* V, void* out, int B, int n, int C, int kx, int ks,
                          int groups, float eps, void* stream) {
  if (n < 1 || B < 1 || ks < 0 || kx + ks > kMaxIn || (ks > 0) != (skip != nullptr) ||
      film_kind < 0 || film_kind > 2 || (film_kind != 0) != (film != nullptr) ||
      (Wres == nullptr && (kx != C || ks != 0)) || C != kC || groups != kCluster ||
      kx < sm90::kChunkK || kx % sm90::kChunkK != 0 || ks % sm90::kChunkK != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (n > kTileRows || (kx + ks) % (2 * sm90::kChunkK) != 0) return -1;
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
  if (dtype != 0 || n > kTileRows) return -1;
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
