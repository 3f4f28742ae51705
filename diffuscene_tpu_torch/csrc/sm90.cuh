// Hopper (sm_90a) building blocks for the cluster kernels of this package:
//
// - mbarriers: init, arrive, arrive with an expected byte count, and the
//   parity wait;
// - the bulk copy of contiguous bytes from device memory into shared memory
//   (cp.async.bulk, no tensor map; also multicast to the CTAs of a cluster),
//   and the 16-byte asynchronous store into another CTA's shared memory
//   (st.async), each completing on an mbarrier, and the 8-byte load from
//   another CTA's shared memory (ld.shared::cluster);
// - the split cluster barrier (barrier.cluster.arrive / wait);
// - warpgroup products: the shared-memory descriptor of a K-major operand in
//   the no-swizzle core-matrix layout (a weight chunk's, or one of another
//   width), and wgmma.mma_async m64n64k16 and m64n48k16 (bf16) and
//   m64n64k8 and m64n48k8 (tf32) with A in registers, B from shared memory,
//   f32 accumulation; the split of an f32 value into two tf32 parts;
// - the bulk copy of a CTA's shared memory into another CTA's of the
//   cluster (the f32 ResnetBlock kernel's exchange of h);
// - the named barrier of the consumer warps;
// - the scene-tile cluster shared by the bf16 ResnetBlock kernel
//   (fused_resblock.cu) and the bf16 chain kernel (fused_chain.cu): a tile of
//   whole scenes (at most 64 rows) is one cluster of 8 CTAs, CTA g owning
//   GroupNorm group g's 64 output columns; its layout of a gathered (64, 512)
//   activation (hslice), its K loop on wgmma fed by a ring of weight chunks
//   (consume), the per-scene moments of its 64 columns (scene_moments), and
//   the exchange of a CTA's slice with the other 7 (send_slice);
// - the split-TF32 scene tile of the f32 ResnetBlock and chain kernels: the
//   input's K tiles through 8 rolling slots (SlotsF), the ring of split
//   weight chunks (RingF), the K step on wgmma m64n64k8 .tf32 with the rows
//   split in registers (block_products), and the bulk-copy exchange of h
//   (exchange_slice_f32, slice_products); the f32 set-attention kernels
//   (set_attention.cu) take its split A fragments (load_a), its products
//   (products_3x) and a ring of larger stages (RingT); the wide f32
//   ResnetBlock kernel its K step with A from device memory
//   (load_a_global, stream_products) and a ring of two warpgroups' chunks;
//   the bf16 wide ResnetBlock and set-attention kernels its bf16 counterpart
//   (load_a_global_bf16, stream_products_bf16: A fragments of a 64-deep K
//   step from device memory, the weights' k permuted to match);
// - the wide kernels' pieces, shared by the wide ResnetBlock and chain
//   kernels (fused_resblock.cu, fused_chain.cu): their layout (layout_wide),
//   ring (RingW), K loop with A from device memory (wide_products), the
//   GroupNorm moments of groups of 16 to 256 channels merged across the
//   cluster (wide_partials, wide_stats) and the launch (wide_config).
//
// The weight chunk layout.  A chunk is one 64-deep K tile of one group of 64
// output columns, (k, n) in [0, 64)^2, stored as 8 x 8 core matrices of 8 n
// rows by 8 k values (16 bytes a row): element (k, n) at
//
//     ((k / 8) * 8 + n / 8) * 64 + (n % 8) * 8 + k % 8
//
// so core matrices adjacent in n are 128 bytes apart (the descriptor's
// stride byte offset) and those adjacent in k 1024 bytes apart (its leading
// byte offset), and each 16-deep k step starts 2048 bytes further on
// (pack_group_tiles in ops/fused_resblock.py writes this order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace sm90 {

constexpr int kChunkK = 64;                          // depth of one weight chunk
constexpr int kChunkN = 64;                          // output columns of one chunk
constexpr int kChunkElems = kChunkK * kChunkN;
constexpr int kChunkBytes = kChunkElems * 2;         // bf16
constexpr uint32_t kChunkLbo = 1024;                 // next core matrix in k
constexpr uint32_t kChunkSbo = 128;                  // next core matrix in n
constexpr uint32_t kChunkKStep = 2048;               // next 16-deep k step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy and the cluster
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival by each thread whose `pred` holds (predicated, not branched:
// a branch between asynchronous warpgroup products serializes them)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival on the mbarrier at cluster address `bar` (this CTA's or
// another's), releasing this thread's prior accesses to the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- bulk copy -----------------------------------------------------------

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bulk_load into the same offset of the shared memory of every CTA of the
// cluster in `mask`, completing on the mbarrier at `bar`'s offset in each
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// the address of `p` (in this CTA's shared memory) in the shared memory of
// the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// 16 bytes from registers to cluster address `dst` (another CTA's shared
// memory), completing on the mbarrier at cluster address `bar` in that CTA
__device__ __forceinline__ void st_async(uint32_t dst, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// orders this thread's generic-proxy memory accesses before its (or, after
// a barrier, another thread's) later bulk copies of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// the same for this CTA's shared memory only
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- cluster barrier -----------------------------------------------------

// every thread of the cluster arrives once and then waits once per phase;
// arrive releases this thread's writes, wait acquires the others'.
// cluster_arrive_relaxed orders nothing: for a signal that this thread is
// done reading (its loads have returned) or that a copy it waited for has
// landed
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ---- named barrier of the consumer warps --------------------------------

template <int kThreads>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// ---- warpgroup products -------------------------------------------------

// descriptor of a K-major operand in the no-swizzle core-matrix layout at
// shared address `p`: core matrices adjacent in k `lbo` bytes apart, those
// adjacent in n kChunkSbo (128) bytes apart, i.e. (k, n) at
// ((k / 8) * (lbo / 128) + n / 8) * 64 + (n % 8) * 8 + k % 8
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(kChunkSbo >> 4) << 32);  // layout type 0: no swizzle
}

// descriptor of a weight chunk (layout above) at shared address `chunk`
__device__ __forceinline__ uint64_t chunk_desc(const void* chunk) {
  return kmajor_desc(chunk, kChunkLbo);
}

// the descriptor advanced by `bytes` (the start address is in 16-byte units)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// d[64 x 64] += A[64 x 16] @ B[16 x 64], by one warpgroup.  A in registers:
// warp w of the group holds rows 16w..16w+15 as the mma.m16n8k16 A fragment
// (ldmatrix.x4 order).  B: a 16-deep k step of a chunk, by descriptor.
// Accumulator i of lane (g, t) of warp w: row 16w + g (+8 when i & 2),
// column 8 (i / 4) + 2t (+1 when i & 1).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"   // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 48] += A[64 x 16] @ B[16 x 48], as wgmma_m64n64k16 with 48
// columns: accumulator i < 24 of lane (g, t) of warp w is row 16w + g (+8
// when i & 2), column 8 (i / 4) + 2t (+1 when i & 1).
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- split TF32 ("3xTF32") on the tensor cores ---------------------------

// v rounded to tf32 (nearest, ties away from zero) in a 32-bit register:
// the low 13 mantissa bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as hi + lo, both tf32: hi = rna(v), lo = rna(v - hi), so that
// |v - hi - lo| <= 2^-22 |v|; a product then runs as hi*hi + hi*lo + lo*hi
// (never the one pass hi*hi alone, which keeps about 11 bits)
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d[64 x 64] += A[64 x 8] @ B[8 x 64] in tf32 with f32 accumulation, by one
// warpgroup.  A in registers: lane (g, t) of warp w holds rows 16w + g and
// 16w + g + 8 at k = t and t + 4, as {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}.  B: K-major in shared memory, by descriptor (tf32 takes
// no transposed operand).  Accumulator i of lane (g, t) of warp w: row
// 16w + g (+8 when i & 2), column 8 (i / 4) + 2t (+1 when i & 1), as in
// wgmma_m64n64k16.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 48] += A[64 x 8] @ B[8 x 48] in tf32, as wgmma_m64n64k8_tf32 with
// 48 columns: accumulator i < 24 of lane (g, t) of warp w is row 16w + g
// (+8 when i & 2), column 8 (i / 4) + 2t (+1 when i & 1).
__device__ __forceinline__ void wgmma_m64n48k8_tf32(float (&d)[24], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- the copy of a CTA's shared memory into a peer's -------------------------

// `bytes` of this CTA's shared memory at `src` into cluster address `dst`
// (another CTA's shared memory), completing on the mbarrier at cluster
// address `bar` in that CTA; the writer of `src` fences
// (fence_proxy_async_shared) before the copy is issued
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 8 bytes from cluster address `src` (another CTA's shared memory)
__device__ __forceinline__ uint2 ld_cluster_u2(uint32_t src) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(src)
               : "memory");
  return v;
}

// ---- the scene-tile cluster ------------------------------------------------

constexpr int kC = 512;                     // channels
constexpr int kCluster = 8;                 // CTAs per scene tile = GroupNorm groups
constexpr int kGroup = kC / kCluster;       // 64 columns per CTA
constexpr int kTileRows = 64;               // rows per scene tile (wgmma M)
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and one producer warp
static_assert(kGroup == kChunkN, "one chunk spans one group's columns");

// A gathered activation G: 8 slices of (64 rows x 64 columns), slice q from
// CTA q, each row 128 bytes with its 16-byte chunks swizzled (chunk ^ row % 8)
// so that ldmatrix reads and the epilogue's writes are free of bank
// conflicts; a slice's valid rows are contiguous, so it moves as rows * 8
// pieces of 16 bytes at the same offsets in every CTA.  Element offset of
// chunk `chunk` of row `row` of slice q:
__device__ __forceinline__ int hslice(int q, int row, int chunk) {
  return q * kTileRows * kGroup + row * kGroup + 8 * (chunk ^ (row & 7));
}

// silu in f32 with the fast exponential and division (the kernels round the
// result to bf16)
__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// acc[64 x 64] += A[64 x nkt*64] @ (this CTA's chunks) by the consumer
// warpgroup, and accR likewise from the interleaved residual chunks when
// kRes.  A: a row-major tile (stride lda) or, when kSlices, a gathered G,
// taken from CTA `first`'s slice on (K tile q is CTA q's slice, see hslice),
// each other slice waited for on its barrier in `slice_bar` so that the
// products start on the slices already in.  Two K tiles a step (nkt is
// even): their chunks are waited for and their A fragments loaded, then all
// their products issue as one group, and the stages go back to the producer
// when it is done.  A fragments in registers cannot load while products that
// read registers are in flight (ptxas serializes them), so the step is what
// amortizes the wait.  (s, ph): the ring position.
template <bool kRes, bool kSlices>
__device__ __forceinline__ void consume(float (&acc)[32], float (&accR)[32],
                                        const __nv_bfloat16* A, int lda, int nkt,
                                        __nv_bfloat16* ring, uint64_t* full, uint64_t* empty,
                                        int stages, int& s, uint32_t& ph, int first = 0,
                                        uint64_t* slice_bar = nullptr) {
  constexpr int kStep = 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane & 15), half = lane >> 4;
#pragma unroll 1
  for (int kt = 0; kt < nkt; kt += kStep) {
    int sw[kStep], sr[kStep];        // the stages of each tile's W and residual chunks
    uint32_t af[kStep][4][4];        // each tile's A fragments, 4 k16 steps
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      sw[u] = s;
      mbar_wait(&full[s], ph);
      if (++s == stages) s = 0, ph ^= 1;
      sr[u] = 0;
      if constexpr (kRes) {
        sr[u] = s;
        mbar_wait(&full[s], ph);
        if (++s == stages) s = 0, ph ^= 1;
      }
      int q = kt + u;
      if constexpr (kSlices) {
        q = (first + kt + u) % kCluster;
        if (q != first) mbar_wait(&slice_bar[q], 0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kSlices)
          tile::ldmatrix_x4(af[u][j], A + hslice(q, row, 2 * j + half));
        else
          tile::ldmatrix_x4(af[u][j], A + row * lda + (kt + u) * kChunkK + 16 * j + 8 * half);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const uint64_t dw = chunk_desc(ring + sw[u] * kChunkElems);
      const uint64_t dr = chunk_desc(ring + sr[u] * kChunkElems);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n64k16(acc, af[u][j], desc_add(dw, j * kChunkKStep));
        if constexpr (kRes) wgmma_m64n64k16(accR, af[u][j], desc_add(dr, j * kChunkKStep));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if constexpr (kRes) fence_operand(accR);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kStep; ++u) {   // this warp is done with the stages
      mbar_arrive_if(&empty[sw[u]], lane == 0);
      if constexpr (kRes) mbar_arrive_if(&empty[sr[u]], lane == 0);
    }
  }
}

// Per-scene moments of an accumulator h (this CTA's 64 columns) into stat:
// mean at [s], rsqrt(var + eps) at [64 + s], with the one-pass variance
// E[h^2] - E[h]^2 clamped at 0 when kClamp (the chain's GroupNorm) or not
// (B1's).  Fixed order: a row's 16 values per thread, the row's 4 threads by
// shuffles, the scene's rows in turn.  Called by the consumer warpgroup.
template <bool kClamp>
__device__ __forceinline__ void scene_moments(const float (&h)[32], int n, int nsc, float eps,
                                              float* red, float* stat) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);
  float s0 = 0.f, q0 = 0.f, s1 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s0 += h[4 * j] + h[4 * j + 1];
    q0 += h[4 * j] * h[4 * j] + h[4 * j + 1] * h[4 * j + 1];
    s1 += h[4 * j + 2] + h[4 * j + 3];
    q1 += h[4 * j + 2] * h[4 * j + 2] + h[4 * j + 3] * h[4 * j + 3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    q0 += __shfl_xor_sync(0xffffffffu, q0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    q1 += __shfl_xor_sync(0xffffffffu, q1, off);
  }
  if ((lane & 3) == 0) {
    red[r0] = s0;
    red[kTileRows + r0] = q0;
    red[r0 + 8] = s1;
    red[kTileRows + r0 + 8] = q1;
  }
  bar_sync<kConsumers>(1);
  if (threadIdx.x < nsc) {
    const int s = threadIdx.x;
    float sum = 0.f, sq = 0.f;
    for (int i = 0; i < n; ++i) {
      sum += red[s * n + i];
      sq += red[kTileRows + s * n + i];
    }
    const float denom = 1.f / (float)(n * kGroup);
    const float mean = sum * denom;
    const float var = sq * denom - mean * mean;
    stat[s] = mean;
    stat[kTileRows + s] = rsqrtf((kClamp ? fmaxf(var, 0.f) : var) + eps);
  }
  bar_sync<kConsumers>(1);
}

// The exchange: every consumer thread stores 16-byte pieces of this CTA's
// slice (`rank`, rows x 64) of the gathered G into the same place in the
// other 7 CTAs' G by st.async, each piece completing on bars[rank] there.
// The caller makes sure first that no peer still reads the bytes written.
__device__ __forceinline__ void send_slice(const __nv_bfloat16* G, int rank, int rows,
                                           uint64_t* bars) {
  const __nv_bfloat16* mine = G + hslice(rank, 0, 0);
  uint32_t dst[kCluster - 1], bar[kCluster - 1];
#pragma unroll
  for (int p = 0; p < kCluster - 1; ++p) {
    const int peer = (rank + 1 + p) % kCluster;
    dst[p] = cluster_addr(mine, peer);
    bar[p] = cluster_addr(&bars[rank], peer);
  }
  for (int i = threadIdx.x; i < rows * (kGroup / 8); i += kConsumers) {
    const uint4 v = reinterpret_cast<const uint4*>(mine)[i];
#pragma unroll
    for (int p = 0; p < kCluster - 1; ++p) st_async(dst[p] + 16 * i, v, bar[p]);
  }
}

// ---- the split-TF32 scene tile (the f32 kernels) ---------------------------
//
// The f32 ResnetBlock kernel (fused_resblock.cu, resblock_tf32) and the f32
// chain kernel (fused_chain.cu, chain_tf32) share this design: the scene
// tile's cluster of 8 CTAs above, with every product on the tensor cores in
// split TF32 (an f32 value v is hi = rna_tf32(v) plus lo = rna_tf32(v - hi),
// a product hi*lo + lo*hi + hi*hi with f32 accumulation on wgmma m64n64k8).
// An f32 tile of 64 rows x 512 columns or more does not fit in shared memory
// beside the weight ring, so 8 slots of 64 rows x 64 columns (rows kLdF
// floats apart) take an input's 64-column K tiles in turn (SlotsF) and then
// the slices of the gathered h (slot q = CTA q's slice); the ring holds
// kStagesF chunks of 32 k x the CTA's 64 columns, split on the host into
// tf32 hi and lo (pack_tf32_tiles in ops/fused_resblock.py).  A CTA has one
// consumer warpgroup, a weight producer warp and an input loader warp.

constexpr int kStepK = 32;                      // depth of one f32 weight chunk (a K step)
constexpr int kStagesF = 5;                     // the weight ring
constexpr int kThreadsF = kConsumers + 64;      // and a weight producer warp, an input loader warp
constexpr int kChunkPartF = kStepK * kGroup;    // floats of a chunk's hi (or lo) part: 2048
constexpr int kChunkBytesF = 2 * kChunkPartF * 4;        // hi and lo: 16 KB
constexpr uint32_t kLboF = kGroup / 8 * 128;    // next core matrix in k: 1024 bytes
constexpr uint32_t kKStepF = 2 * kLboF;         // next 8-deep k step: 2048 bytes
constexpr int kLdF = kGroup + 4;                // row stride (floats) of a slot: 64 + 4
constexpr int kSlotF = kTileRows * kLdF;        // floats of a slot: 64 rows x 64 columns

// shared-memory layout of a split-TF32 kernel with `vectors` vectors of the
// CTA's 64 columns and `slice_sets` sets of 8 barriers for the slices of h
struct LayoutF {
  unsigned ring, slots, v, red, stat, bars, total;
};

__host__ __device__ constexpr LayoutF layout_tf32(int vectors, int slice_sets) {
  LayoutF L{};
  L.ring = 0;                                     // kStagesF x 16 KB of split weights
  L.slots = L.ring + kStagesF * kChunkBytesF;     // 8 slots: K tiles, later the slices of h
  L.v = L.slots + kCluster * kSlotF * 4;          // this CTA's columns of the vectors
  L.red = L.v + vectors * kGroup * 4;             // row sums, squares
  L.stat = L.red + 2 * kTileRows * 4;             // scene mean, rsqrt
  L.bars = L.stat + 2 * kTileRows * 4;            // ring full, empty; slot full, empty; slices
  L.total = L.bars + (2 * kStagesF + 2 * kCluster + slice_sets * kCluster) * 8;
  return L;
}

// A lane's 8 columns of its two rows (v[0] row g, v[1] row g + 8) as its
// A fragments' tf32 hi and lo parts (load_a's order below)
__device__ __forceinline__ void split_a(const float (&v)[2][8], uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
    tf32_split(v[0][2 * j], hi[4 * j], lo[4 * j]);
    tf32_split(v[1][2 * j], hi[4 * j + 1], lo[4 * j + 1]);
    tf32_split(v[0][2 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
    tf32_split(v[1][2 * j + 1], hi[4 * j + 3], lo[4 * j + 3]);
  }
}

// This thread's A fragments of one K step (32 deep) of 64 rows kLd floats
// apart (a slot: rows 68 floats apart, the step at column 32 * half),
// split into tf32 hi and lo, for warp w % 4 of its warpgroup.  The chunks
// are packed with the step's k permuted (pack_tf32_tiles): fragment k = 8j
// + t + 4h of k step j reads column 8t + 2j + h of the step, so lane (g, t)
// reads 8 contiguous columns of rows 16w + g and + 8 as two 16-byte loads
// each; rows kLd = 4 (mod 32) floats apart keep a quarter warp's loads on
// distinct banks.
template <int kLd = kLdF>
__device__ __forceinline__ void load_a(const float* step, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
  static_assert(kLd % 32 == 4, "rows 4 banks apart");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const float* p = step + (16 * warp + (lane >> 2)) * kLd + 8 * (lane & 3);
  float v[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float4 u = *reinterpret_cast<const float4*>(p + 8 * r * kLd);
    const float4 w = *reinterpret_cast<const float4*>(p + 8 * r * kLd + 4);
    v[r][0] = u.x, v[r][1] = u.y, v[r][2] = u.z, v[r][3] = u.w;
    v[r][4] = w.x, v[r][5] = w.y, v[r][6] = w.z, v[r][7] = w.w;
  }
  split_a(v, hi, lo);
}

// The same fragments from device memory: p0 and p1 point at this thread's 8
// columns (8 (lane % 4) on from the K step's first) of its rows g and g + 8,
// read through L2 only (ld.global.cg: the bytes may have been written by
// another CTA of the cluster in this launch)
__device__ __forceinline__ void load_a_raw(const float* p0, const float* p1, float (&v)[2][8]) {
  const float* p[2] = {p0, p1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(p[r]));
    const float4 w = __ldcg(reinterpret_cast<const float4*>(p[r]) + 1);
    v[r][0] = u.x, v[r][1] = u.y, v[r][2] = u.z, v[r][3] = u.w;
    v[r][4] = w.x, v[r][5] = w.y, v[r][6] = w.z, v[r][7] = w.w;
  }
}
// ... split into tf32 hi and lo
__device__ __forceinline__ void load_a_global(const float* p0, const float* p1,
                                              uint32_t (&hi)[16], uint32_t (&lo)[16]) {
  float v[2][8];
  load_a_raw(p0, p1, v);
  split_a(v, hi, lo);
}

// d += A @ (the chunk at `chunk`: hi, then lo), as hi*lo + lo*hi + hi*hi in
// each of the step's 4 k steps
__device__ __forceinline__ void products_3x(float (&d)[32], const uint32_t (&ah)[16],
                                            const uint32_t (&al)[16], const float* chunk) {
  const uint64_t bh = kmajor_desc(chunk, kLboF);
  const uint64_t bl = kmajor_desc(chunk + kChunkPartF, kLboF);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_m64n64k8_tf32(d, ah + 4 * j, desc_add(bl, j * kKStepF));
    wgmma_m64n64k8_tf32(d, al + 4 * j, desc_add(bh, j * kKStepF));
    wgmma_m64n64k8_tf32(d, ah + 4 * j, desc_add(bh, j * kKStepF));
  }
}

// A weight ring of kStages stages of kStageElems elements of E (float, or
// bf16 for the bf16 wide kernels): the producer's side (put) and the
// consumers' (take, give; every consumer thread gives), each thread with
// its own position (s, ph)
template <int kStages, int kStageElems, class E = float>
struct RingT {
  E* base;
  uint64_t* full;
  uint64_t* empty;
  int s;
  uint32_t ph;
  // producer: `pieces` blocks of `bytes`, from src, src + stride, ..., back
  // to back into the next stage, once it is free
  __device__ __forceinline__ void put(const E* src, uint32_t bytes = kStageElems * sizeof(E),
                                      int pieces = 1, size_t stride = 0) {
    mbar_wait(&empty[s], ph ^ 1);
    mbar_expect_tx(&full[s], bytes * pieces);
    for (int i = 0; i < pieces; ++i)
      bulk_load(base + s * kStageElems + i * (bytes / sizeof(E)), src + i * stride, bytes,
                &full[s]);
    if (++s == kStages) s = 0, ph ^= 1;
  }
  __device__ __forceinline__ int take() {   // the next stage, once its chunk has landed
    const int st = s;
    mbar_wait(&full[st], ph);
    if (++s == kStages) s = 0, ph ^= 1;
    return st;
  }
  __device__ __forceinline__ const E* chunk(int st) const { return base + st * kStageElems; }
  __device__ __forceinline__ void give(int st) { mbar_arrive_if(&empty[st], true); }
};
// the f32 ResnetBlock and chain kernels' ring: a split chunk (16 KB) a stage
using RingF = RingT<kStagesF, 2 * kChunkPartF>;

// Issue one K step's products: this thread's split A fragments times the
// ring's next chunk into d (and the one after it into dr when kRes); `part`
// (floats) picks this warpgroup's chunk in a stage that holds several.
// Returns the stages, which retire_step gives back once the products are
// done.
template <bool kRes, class Ring>
__device__ __forceinline__ int2 issue_step(float (&d)[32], float (&dr)[32],
                                           const uint32_t (&ah)[16], const uint32_t (&al)[16],
                                           Ring& w, int part = 0) {
  const int s1 = w.take();
  const int s2 = kRes ? w.take() : s1;
  wgmma_fence();
  products_3x(d, ah, al, w.chunk(s1) + part);
  if constexpr (kRes) products_3x(dr, ah, al, w.chunk(s2) + part);
  wgmma_commit();
  return make_int2(s1, s2);
}

template <bool kRes, class Ring>
__device__ __forceinline__ void retire_step(float (&d)[32], float (&dr)[32], int2 st, Ring& w) {
  wgmma_wait<0>();
  fence_operand(d);
  if constexpr (kRes) fence_operand(dr);
  w.give(st.x);
  if constexpr (kRes) w.give(st.y);
}

// One product over `nsteps` (even) 32-deep K steps into d (and, when
// kRes, the residual projection into dr from the ring's interleaved
// chunks, sharing the A fragments): load(st, hi, lo) loads and splits K
// step st's A fragments, the next step's while a step's products run (two
// register sets); `part` picks this warpgroup's chunk in a stage.
template <bool kRes, class Ring, class Load>
__device__ __forceinline__ void stream_products(float (&d)[32], float (&dr)[32], int nsteps,
                                                Load load, Ring& w, int part = 0) {
  uint32_t h0[16], l0[16], h1[16], l1[16];
  load(0, h0, l0);
#pragma unroll 1
  for (int st = 0; st < nsteps; st += 2) {
    int2 s = issue_step<kRes>(d, dr, h0, l0, w, part);
    load(st + 1, h1, l1);
    retire_step<kRes>(d, dr, s, w);
    s = issue_step<kRes>(d, dr, h1, l1, w, part);
    if (st + 2 < nsteps) load(st + 2, h0, l0);
    retire_step<kRes>(d, dr, s, w);
  }
}

// stream_products with A from device memory for a kernel short of
// registers (the wide chain kernel's CTA of two warpgroups and a producer
// warp has 168 a thread): the next K step's fragments wait as raw f32
// values (16 registers, load_a_raw) while a step's products run, and are
// split into tf32 hi and lo once those retire (the products read hi and lo
// from registers until then): 48 registers of A fragments where
// stream_products holds two split sets, 64.  src(st, r): this thread's 8
// columns of K step st of row r (load_a_global's p0, p1); any nsteps.
template <bool kRes, class Ring, class Src, class Row>
__device__ __forceinline__ void stream_products_late(float (&d)[32], float (&dr)[32], int nsteps,
                                                     Src src, Row ra, Row rb, Ring& w,
                                                     int part) {
  float v[2][8];
  uint32_t hi[16], lo[16];
  load_a_raw(src(0, ra), src(0, rb), v);
  split_a(v, hi, lo);
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {
    const int2 s = issue_step<kRes>(d, dr, hi, lo, w, part);
    if (st + 1 < nsteps) load_a_raw(src(st + 1, ra), src(st + 1, rb), v);
    retire_step<kRes>(d, dr, s, w);
    if (st + 1 < nsteps) split_a(v, hi, lo);
  }
}

// ---- the bf16 K step with A from device memory (the bf16 wide kernels) ----
//
// A thread's A fragments of one 64-deep K step of wgmma m64n64k16 are 16
// values of each of its rows g and g + 8.  The wide kernels' bf16 weights
// are packed with the step's k permuted (pack_group_tiles(..., permuted) in
// ops/fused_resblock.py): fragment k = 16 j + 8 h + 2 t + e of k16 step j
// holds row 16 t + 4 j + 2 h + e of the step, so lane (g, t) reads the 16
// contiguous columns [16 t, 16 t + 16) of each row as two 16-byte loads,
// 32-bit word 2 j + h of them its fragment of k16 step j, half h.

// The fragments of one step from device memory: p0 and p1 point at this
// thread's 16 columns (16 (lane % 4) on from the step's first) of its rows
// g and g + 8, read through L2 only (ld.global.cg: the bytes may have been
// written by another CTA of the cluster in this launch).  af[j]: k16 step
// j's {(g, 2j), (g + 8, 2j), (g, 2j + 1), (g + 8, 2j + 1)} in words.
__device__ __forceinline__ void load_a_global_bf16(const __nv_bfloat16* p0,
                                                   const __nv_bfloat16* p1,
                                                   uint32_t (&af)[4][4]) {
  const uint4* q[2] = {reinterpret_cast<const uint4*>(p0), reinterpret_cast<const uint4*>(p1)};
  uint32_t w[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4 u = __ldcg(q[r]), v = __ldcg(q[r] + 1);
    w[r][0] = u.x, w[r][1] = u.y, w[r][2] = u.z, w[r][3] = u.w;
    w[r][4] = v.x, w[r][5] = v.y, w[r][6] = v.z, w[r][7] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    af[j][0] = w[0][2 * j];
    af[j][1] = w[1][2 * j];
    af[j][2] = w[0][2 * j + 1];
    af[j][3] = w[1][2 * j + 1];
  }
}

// Issue one bf16 K step's products: the fragments times the ring's next
// chunk (a 64-deep chunk of pack_group_tiles, at `part` elements into the
// stage) into d, and the one after it into dr when kRes.  Returns the
// stages for retire_step.
template <bool kRes, class Ring>
__device__ __forceinline__ int2 issue_step_bf16(float (&d)[32], float (&dr)[32],
                                                const uint32_t (&af)[4][4], Ring& w,
                                                int part = 0) {
  const int s1 = w.take();
  const int s2 = kRes ? w.take() : s1;
  const uint64_t b1 = chunk_desc(w.chunk(s1) + part), b2 = chunk_desc(w.chunk(s2) + part);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_m64n64k16(d, af[j], desc_add(b1, j * kChunkKStep));
    if constexpr (kRes) wgmma_m64n64k16(dr, af[j], desc_add(b2, j * kChunkKStep));
  }
  wgmma_commit();
  return make_int2(s1, s2);
}

// stream_products in bf16: `nsteps` (any count) 64-deep K steps,
// load(st, af) loading K step st's fragments (load_a_global_bf16), the next
// step's while a step's products run
template <bool kRes, class Ring, class Load>
__device__ __forceinline__ void stream_products_bf16(float (&d)[32], float (&dr)[32], int nsteps,
                                                     Load load, Ring& w, int part = 0) {
  uint32_t a0[4][4], a1[4][4];
  load(0, a0);
#pragma unroll 1
  for (int st = 0; st < nsteps; st += 2) {
    int2 s = issue_step_bf16<kRes>(d, dr, a0, w, part);
    if (st + 1 < nsteps) load(st + 1, a1);
    retire_step<kRes>(d, dr, s, w);
    if (st + 1 == nsteps) break;
    s = issue_step_bf16<kRes>(d, dr, a1, w, part);
    if (st + 2 < nsteps) load(st + 2, a0);
    retire_step<kRes>(d, dr, s, w);
  }
}

// The same over `ntiles` 64-deep K tiles of A in shared memory, two steps
// a tile: tile(kt) waits for K tile kt and returns its slot; done(kt)
// follows the last read of it.
template <bool kRes, class Tile, class Done>
__device__ __forceinline__ void block_products(float (&d)[32], float (&dr)[32], int ntiles,
                                               Tile tile, Done done, RingF& w) {
  const float* A = nullptr;
  stream_products<kRes>(
      d, dr, 2 * ntiles,
      [&](int st, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
        if (st % 2 == 0) {
          A = tile(st / 2);
          load_a(A, hi, lo);
        } else {
          load_a(A + kStepK, hi, lo);
          done(st / 2);
        }
      },
      w);
}

// An input's K tiles through the 8 slots: K tile kt of a pass (one
// product's input, 8 or 16 K tiles) goes into slot kt % 8 of every CTA of
// the cluster, CTA `rank` copying rows rank, rank + 8, ... (256 bytes each)
// into all 8 at once (bulk copies multicast to the cluster).  Within a pass
// a slot takes its next K tile once every CTA's products are done with the
// one before (`empty`: one remote arrival from each CTA); between passes a
// cluster barrier says so.  Rows past the tile are left as they are: they
// only reach rows of the products that are not stored.  The loader warp and
// the consumers each keep a copy and advance it after each pass.
struct SlotsF {
  float* base;
  uint64_t* full;      // [q]: slot q holds its K tile
  uint64_t* empty;     // [q]: every CTA's products are done with slot q's K tile
  uint32_t loads;      // K tiles each slot took in the passes before
  uint32_t reuses;     // of them, those that waited on `empty`

  __device__ __forceinline__ float* slot(int q) const { return base + q * kSlotF; }

  // the loader warp: the pass's `ntiles` K tiles; src(kt, r) is the device
  // address of row r's 64 columns of K tile kt
  template <class Src>
  __device__ __forceinline__ void load(int ntiles, int rows, int rank, Src src) {
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < ntiles; ++kt) {
      const int q = kt % kCluster;
      if (kt >= kCluster) mbar_wait(&empty[q], (reuses + kt / kCluster - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[q], (uint32_t)(rows * kGroup * 4));
      __syncwarp();
      const int r = rank + kCluster * lane;
      if (r < rows) bulk_load_multicast(slot(q) + r * kLdF, src(kt, r), kGroup * 4, &full[q], 0xff);
    }
  }
  // the consumers: wait for K tile kt of this pass
  __device__ __forceinline__ const float* tile(int kt) const {
    mbar_wait(&full[kt % kCluster], (loads + kt / kCluster) & 1);
    return slot(kt % kCluster);
  }
  // the consumers, after their last read of K tile kt: if the slot takes
  // another K tile in this pass, tell every CTA's loader
  __device__ __forceinline__ void release(int kt, int ntiles) const {
    if (kt + kCluster < ntiles) {
      bar_sync<kConsumers>(1);
      if (threadIdx.x < kCluster)
        mbar_arrive_cluster(cluster_addr(&empty[kt % kCluster], threadIdx.x));
    }
  }
  __device__ __forceinline__ void advance(int ntiles) {   // after a pass
    loads += ntiles / kCluster;
    reuses += ntiles / kCluster - 1;
  }
};

// A pass's product over the slots: acc (and accR when res) += the pass's
// K tiles @ the ring's chunks
__device__ __forceinline__ void input_products(bool res, float (&acc)[32], float (&accR)[32],
                                               int ntiles, SlotsF& in, RingF& w) {
  auto tile = [&](int kt) { return (const float*)in.tile(kt); };
  auto done = [&](int kt) { in.release(kt, ntiles); };
  if (res)
    block_products<true>(acc, accR, ntiles, tile, done, w);
  else
    block_products<false>(acc, accR, ntiles, tile, done, w);
  in.advance(ntiles);
}

// The exchange of h: this CTA's f32 slice is in its slot `rank` (the
// consumers wrote it), and the caller has arrived at the cluster barrier
// phase after its last read of its slots.  Once every CTA of the cluster
// has (the phase's wait), 7 threads each bulk-copy the slice into one other
// CTA's slot `rank`, completing on that CTA's bars[rank].
__device__ __forceinline__ void exchange_slice_f32(float* slots, int rank, uint64_t* bars) {
  fence_proxy_async_shared();   // this slice's writes before the copies read it
  bar_sync<kConsumers>(1);
  cluster_wait();
  if (threadIdx.x < kCluster - 1) {
    const int peer = (rank + 1 + threadIdx.x) % kCluster;
    const float* mine = slots + rank * kSlotF;
    bulk_copy_to_peer(cluster_addr(mine, peer), mine, kSlotF * 4, cluster_addr(&bars[rank], peer));
  }
}

// acc += h @ the ring's next 16 chunks, h the gathered slices in the slots
// (slot q = CTA q's), from this CTA's own slice on, each other one once it
// has landed on bars[q]
__device__ __forceinline__ void slice_products(float (&acc)[32], float (&unused)[32],
                                               const float* slots, int rank, uint64_t* bars,
                                               RingF& w) {
  block_products<false>(
      acc, unused, kCluster,
      [&](int kt) {
        const int q = (rank + kt) % kCluster;
        if (q != rank) mbar_wait(&bars[q], 0);
        return slots + q * kSlotF;
      },
      [](int) {}, w);
}

// ---- the wide kernels' pieces (fused_resblock.cu, fused_chain.cu) ----------
//
// The wide ResnetBlock and chain kernels hold no activation in shared
// memory: a scene tile (at most 64 rows) is one cluster of C / (64 wg) CTAs
// of wg consumer warpgroups (1, or 2 at C = 1024) and a producer warp, each
// warpgroup owning 64 output columns; A fragments come from device memory
// through L2, the weights through a ring of kStagesW stages of one chunk a
// warpgroup, and a GroupNorm group (16 to 256 channels) is merged from the
// warpgroups' partial sums in a fixed order, across the cluster where it
// spans CTAs.

constexpr int kStagesW = 4;     // the ring
constexpr int kMaxLocal = 4;    // groups within a warpgroup's 64 columns at most (16 channels)

// what the element type decides: the depth of a K step and the elements of
// one warpgroup's weight chunk of it (f32: a split chunk's tf32 hi and lo,
// pack_tf32_tiles; bf16: a chunk of pack_group_tiles with the k permuted)
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int kStep = kStepK;
  static constexpr int kPart = 2 * kChunkPartF;
};
template <>
struct Wide<__nv_bfloat16> {
  static constexpr int kStep = kChunkK;
  static constexpr int kPart = kChunkElems;
};

struct LayoutW {
  unsigned ring, v, red, part, stat, bars, total;
};

// shared-memory layout of a wide kernel with `wg` consumer warpgroups,
// weight chunks of `chunk_bytes` and `vectors` vectors of the CTA's columns
__host__ __device__ constexpr LayoutW layout_wide(int wg, int chunk_bytes, int vectors) {
  LayoutW L{};
  L.ring = 0;                                                 // stages x wg chunks
  L.v = L.ring + kStagesW * wg * chunk_bytes;                 // this CTA's columns of the vectors
  L.red = L.v + vectors * wg * kGroup * 4;                    // row x 8-column block sums, squares
  L.part = L.red + 2 * wg * kTileRows * 8 * 4;                // per-scene partial sums (float2)
  L.stat = L.part + wg * kMaxLocal * kTileRows * 8;           // per-scene mean, rsqrt (float2)
  L.bars = L.stat + wg * kMaxLocal * kTileRows * 8;           // ring full, empty
  L.total = L.bars + 2 * kStagesW * 8;
  return L;
}

template <typename T>
__host__ __device__ constexpr LayoutW layout_wide_of(int wg, int vectors = 7) {
  return layout_wide(wg, Wide<T>::kPart * (int)sizeof(T), vectors);
}

template <typename T, int kWG>
using RingW = RingT<kStagesW, kWG * Wide<T>::kPart, T>;

// The per-scene moments of the groups of this thread's warpgroup `u`: acc
// (its 64 columns, bias added) -> red -> part[u][q][s] = (sum, sum of
// squares) of scene s over group-part q (a group, or a 64-column part of a
// wider one).  By the kCons consumer threads; red and part are this CTA's.
template <int kCons>
__device__ __forceinline__ void wide_partials(const float (&acc)[32], int u, int n, int nsc,
                                              int gwl, float* red, float2* part) {
  constexpr int kWG = kCons / kConsumers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  float s[2][8], q[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      s[h][j] = a0 + a1;
      q[h][j] = a0 * a0 + a1 * a1;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][j] += __shfl_xor_sync(0xffffffffu, s[h][j], off);
        q[h][j] += __shfl_xor_sync(0xffffffffu, q[h][j], off);
      }
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[(u * kTileRows + r0 + 8 * h) * 8 + j] = s[h][j];
        red[((kWG + u) * kTileRows + r0 + 8 * h) * 8 + j] = q[h][j];
      }
  bar_sync<kCons>(1);
  const int local = kGroup / gwl, blocks = gwl / 8;
  for (int task = threadIdx.x; task < kWG * local * nsc; task += kCons) {
    const int sc = task % nsc, g = (task / nsc) % local, w = task / (nsc * local);
    float sum = 0.f, sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* rs = red + (w * kTileRows + sc * n + i) * 8 + g * blocks;
      const float* rq = rs + kWG * kTileRows * 8;
      for (int b = 0; b < blocks; ++b) {
        sum += rs[b];
        sq += rq[b];
      }
    }
    part[(w * kMaxLocal + g) * kTileRows + sc] = make_float2(sum, sq);
  }
}

// After the cluster barrier that follows wide_partials: each scene's mean
// and rsqrt(var + eps) of every group-part of this CTA into stat, a group
// of gw > 64 channels summed over the partials of its gw / 64 warpgroups
// (warpgroup k of the cluster is warpgroup k % kWG of CTA k / kWG) in
// ascending order, wherever they are; the one-pass variance clamped at 0
// when kClamp (the chain's GroupNorm) or not (B1's)
template <int kCons, bool kClamp = false>
__device__ __forceinline__ void wide_stats(int rank, int n, int nsc, int gw, float eps,
                                           float2* part, float2* stat) {
  constexpr int kWG = kCons / kConsumers;
  const int gwl = min(gw, kGroup), local = kGroup / gwl;
  const float denom = 1.f / (float)(n * gw);
  for (int task = threadIdx.x; task < kWG * local * nsc; task += kCons) {
    const int sc = task % nsc, g = (task / nsc) % local, w = task / (nsc * local);
    float2 m = part[(w * kMaxLocal + g) * kTileRows + sc];
    if (gw > kGroup) {
      const int span = gw / kGroup, first = (rank * kWG + w) / span * span;
      m = make_float2(0.f, 0.f);
      for (int k = first; k < first + span; ++k) {
        const uint2 v = ld_cluster_u2(
            cluster_addr(&part[(k % kWG) * kMaxLocal * kTileRows + sc], k / kWG));
        m.x += __uint_as_float(v.x);
        m.y += __uint_as_float(v.y);
      }
    }
    const float mean = m.x * denom, var = m.y * denom - mean * mean;
    stat[(w * kMaxLocal + g) * kTileRows + sc] =
        make_float2(mean, rsqrtf((kClamp ? fmaxf(var, 0.f) : var) + eps));
  }
}

// acc (and accR when kRes) += A @ the ring's next `nsteps` chunks, A's K
// step st of row r at src(st, r) (this thread's first column of the step;
// rows ra and rb): split TF32 in f32 (with kLate, stream_products_late),
// bf16 products in bf16.  The wide B1 kernel keeps two split sets: with
// the late loop its f32 blocks at C=512 took 2-4% longer on the H100; the
// wide chain kernel takes the late loop to fit two warpgroups' registers.
template <typename T, bool kRes, bool kLate = false, class Ring, class Src, class Row>
__device__ __forceinline__ void wide_products(float (&acc)[32], float (&accR)[32], int nsteps,
                                              Src src, Row ra, Row rb, Ring& w, int part) {
  if constexpr (std::is_same<T, float>::value && kLate)
    stream_products_late<kRes>(acc, accR, nsteps, src, ra, rb, w, part);
  else if constexpr (std::is_same<T, float>::value)
    stream_products<kRes>(
        acc, accR, nsteps,
        [&](int st, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
          load_a_global(src(st, ra), src(st, rb), hi, lo);
        },
        w, part);
  else
    stream_products_bf16<kRes>(
        acc, accR, nsteps,
        [&](int st, uint32_t (&af)[4][4]) { load_a_global_bf16(src(st, ra), src(st, rb), af); },
        w, part);
}

// consumer warpgroups of a wide kernel's CTA at C channels (a cluster of 4
// or 8 CTAs)
inline int wide_groups(int C) { return C > 512 ? 2 : 1; }

// the launch configuration of a wide kernel: one cluster of C / (64 wg)
// CTAs (wg consumer warpgroups and a producer warp each) a tile of `tiles`,
// `smem` bytes of dynamic shared memory a CTA
inline cudaLaunchConfig_t wide_config(int C, int wg, unsigned smem, int tiles,
                                      cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int ncta = C / (wg * kGroup);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * ncta));
  cfg.blockDim = dim3(wg * kConsumers + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ncta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace sm90
