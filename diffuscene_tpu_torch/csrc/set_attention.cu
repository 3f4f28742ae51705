// Pre-norm full set attention with its residual, for sm_90a.
//
// Replaces the Pallas kernel diffuscene_tpu/ops/attention.py:_attn_kernel
// (with _layernorm_g; called from fused_set_attention :57, pallas_call :72).
// Per scene of N <= 24 objects and C channels:
//
//     xf      = float(x)
//     ln      = (xf - mean) * rsqrt(var + eps) * g     two-pass, f32
//     q, k, v = round(ln) @ W_qkv                      f32 accumulation
//     o_h     = softmax(q_h k_h^T * d^-1/2) v_h        per head, f32
//     out     = round(xf + (round(o) @ W_out + b_out))
//
// where round() is the compute dtype (float32 or bfloat16), at the places
// of the Pallas kernel and of the plain twin fused_set_attention_reference.
//
// bfloat16 (the b512 recipes' serving dtype; attention_sm90 at C = 512,
// attention_bf16_wide below at C = 256 and 1024): 4 heads of 32.  A
// scene tile (at most 64 rows of whole scenes: 5 scenes of 12, 3 of 21, 2
// of 24) is one thread-block cluster of 4 CTAs, and CTA h owns head h.  A
// cluster is persistent: the launch holds at most as many clusters as fit
// on the card at once, and each walks tiles cluster, cluster + clusters, ...,
// so its weights are loaded once per launch.  A CTA is one producer warp and
// two consumer warpgroups (288 threads):
//
// - the producer warp brings in the x tile (64 x 512 bf16), each CTA of the
//   cluster loading every 4th row once into all 4 (bulk copies multicast to
//   the cluster); on the first tile also the CTA's 96 columns of W_qkv,
//   [q_h | k_h | v_h] as 8 chunks of 64 deep x 96 (a ring of 8 stages, one
//   per K tile, each on its own mbarrier, so the product starts on the
//   first chunk in), its (128, 128) block of W_out, in the wgmma B layout
//   (pack_attention_weights in ops/attention.py), and its 128 of b_out;
// - the 256 consumer threads take the two-pass f32 LayerNorm of each row (a
//   warp a row, four rows at once, the row's 512 values in registers) and
//   write LN(x) rounded to bf16 over x; warpgroup g runs its 48 columns of
//   q | k | v = LN(x) @ W_qkv[:, cols] on wgmma m64n48k16 (A from the tile by
//   ldmatrix), four K tiles a commit group, and puts them in f32 over the x
//   tile, q scaled by d^-1/2 after the product; all 256 run the scores, the
//   softmax and P v per scene in f32 on the FMA pipes with the f32 kernel's
//   arithmetic, each thread on several independent chains; o_h (rows x 32)
//   is rounded to bf16 into the CTA's slice of the gathered o (64 x 128) and
//   stored into the other 3 CTAs' o by st.async through distributed shared
//   memory, each slice completing on its own mbarrier there; then, with
//   every slice in, warpgroup g runs output columns [128h + 64g, +64) as
//   o @ W_out[:, cols] on wgmma m64n64k16 and stores round(x + (acc + b_out)).
// - A cluster barrier closes each tile, arrived at once a CTA has read its
//   x tile and o and waited at the tile's end: no CTA loads the next x tile
//   or sends the next slice of o while another still reads its own.
//
// float32 (attention_tf32 at C = 512, attention_tf32_wide below at C = 256
// and 1024; the serving dtype of the flagship config and of every
// diffusion config but the three b512 ones): the same scene tile,
// cluster of 4 CTAs (CTA h owns head h) and thread roles, with both products
// on the tensor cores in split TF32, as the f32 ResnetBlock and chain
// kernels run theirs: an f32 value v is hi = rna_tf32(v) plus lo =
// rna_tf32(v - hi), and a product runs as hi*lo + lo*hi + hi*hi with f32
// accumulation, never the one pass hi*hi alone.  The weights are split once
// on the host (pack_attention_weights_tf32 in ops/attention.py), the rows of
// LN(x) and of o in registers (sm90::load_a).  In a CTA:
//
// - shared memory decides the layout.  The f32 x tile (64 x 516 floats,
//   129 KB) sits whole, because the LayerNorm needs whole rows before the
//   product starts, beside a ring of 3 stages of 32 KB; once the qkv
//   product has read the tile, its bytes take q | k | v, the probabilities
//   and the gathered o (64 x 128 f32 as 4 slices of 64 x 36, slice q from
//   CTA q), 231,000 bytes a CTA in all.  The split weights (512 KB a CTA)
//   cannot stay resident, so a cluster takes one tile and exits
//   (not persistent): each tile streams its CTA's weights once, 13 tiles
//   x 4 CTAs x 512 KB out of L2 at B=64, 52 x 4 at B=256;
// - the producer warp multicasts the x tile as in bf16, then streams
//   through the ring the CTA's 16 K steps of W_qkv (32 deep x 96 columns
//   [q_h | k_h | v_h], hi then lo, 24 KB) and its 4 K steps of W_out (32
//   deep x 128 output columns, 32 KB), in the order the output product
//   takes the slices of o (this CTA's first);
// - the consumer warpgroups take the f32 two-pass LayerNorm in place over
//   the tile; warpgroup g runs its 48 columns of q | k | v on wgmma
//   m64n48k8 .tf32 (the bf16 kernel's split of the 96 columns: both
//   warpgroups run the whole K, so no partial sums meet), the next K step's
//   A fragments loaded and split while a step's products run;
// - a release cluster barrier says every CTA is done reading its x tile;
//   q | k | v (q scaled by d^-1/2 after the product), the scores, the
//   softmax and P v run in f32 on the FMA pipes as in bf16, o_h into this
//   CTA's slice; then, with every CTA past the barrier, 3 threads
//   bulk-copy the slice into the other CTAs' slice at the same offset,
//   completing on their barrier for it (as the f32 ResnetBlock kernel
//   exchanges h);
// - warpgroup g runs output columns [128h + 64g, +64) as o @ W_out on
//   wgmma m64n64k8 .tf32 from this CTA's slice on, each other slice once it
//   has landed, and stores x + (acc + b_out), x read again from device
//   memory (exact);
// - a last cluster barrier keeps every CTA until every slice has landed.
//
// What bounds it.  At B=64, N=12 a bf16 call reads 0.8 MB of x and 0.5 MB of
// weights and writes 0.8 MB: 0.6 us at the HBM rate; its 0.4 GFLOP take less
// on the tensor cores.  At that size the kernel is bound by latency along a
// CTA's chain of phases (the x tile's arrival, the LayerNorm, the qkv
// product, the per-scene attention, the exchange of o, the output product),
// 13 clusters of 4 CTAs on 132 SMs; the f32 phases are issue-bound on one
// SM's 8 consumer warps, hence two warpgroups.  At B=768 (154 tiles) the
// persistent bf16 clusters take about 5 tiles each, back to back.  In f32
// the same 0.4 GFLOP are 1.2 GFLOP of tf32 products, 2.4 us on the whole card
// at 495 TFLOP/s; but 13 tiles keep 52 SMs busy, and one CTA's share (25
// MFLOP of tf32) takes 6.7 us at one SM's rate, before its other phases.
#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxN = 24;    // objects per scene

// ---------------------------------------------------------------------------
// bfloat16: the cluster kernel
// ---------------------------------------------------------------------------

using sm90::kC;
using sm90::kTileRows;
constexpr int kHeads = 4;                      // CTAs of a tile's cluster
constexpr int kDh = 32;                        // dim_head
constexpr int kGroups = 2;                     // consumer warpgroups
constexpr int kWorkers = 128 * kGroups;        // their threads
constexpr int kThreads90 = kWorkers + 32;      // and one producer warp
constexpr int kQkvCols = 3 * kDh;              // a CTA's q | k | v columns
constexpr int kGroupQkv = kQkvCols / kGroups;  // a warpgroup's 48 of them
constexpr int kKt = kC / sm90::kChunkK;        // K tiles of the qkv product
constexpr int kQkvChunkElems = sm90::kChunkK * kQkvCols;
constexpr uint32_t kQkvChunkBytes = kQkvChunkElems * 2;
constexpr uint32_t kQkvLbo = (kQkvCols / 8) * 128;   // next core matrix in k
constexpr uint32_t kQkvKStep = 2 * kQkvLbo;          // next 16-deep k step
constexpr int kOutCols = kC / kHeads;          // a CTA's output columns
constexpr int kOutElems = kDh * kHeads * kOutCols;   // its (128, 128) W_out block
constexpr int kLdx = kC + 8;                   // x / LN(x) tile stride (elements)
constexpr int kLdq = kQkvCols + 4;             // q | k | v stride (floats)
constexpr int kLdp = kMaxN + 1;                // probabilities stride (floats)
constexpr int kLdo = kDh * kHeads + 8;         // gathered o stride (elements)

// shared-memory layout of attention_sm90 (bytes); q | k | v and the
// probabilities live in the x tile's space once the qkv product has read it
constexpr unsigned kRing = 0;                                   // 8 x 12 KB
constexpr unsigned kX = kRing + kKt * kQkvChunkBytes;           // x, LN(x), then q | k | v, P
constexpr unsigned kWo = kX + kTileRows * kLdx * 2;             // W_out block, 32 KB
constexpr unsigned kO = kWo + kOutElems * 2;                    // gathered o
constexpr unsigned kBo = kO + kTileRows * kLdo * 2;             // this CTA's b_out
constexpr unsigned kBars = kBo + kOutCols * 4;                  // full[8], x, W_out, o[4]
constexpr unsigned kSmem90 = kBars + (kKt + 2 + kHeads) * 8;
static_assert(kTileRows * (kLdq + kLdp) * 4 <= kTileRows * kLdx * 2,
              "q | k | v and the probabilities fit in the x tile's space");
static_assert(kSmem90 <= 232448, "one CTA's shared memory");
static_assert(4 * kTileRows == kWorkers && kMaxN % 4 == 0, "the softmax takes 4 threads a row");
static_assert(kOutCols == kGroups * sm90::kChunkN, "a warpgroup takes one chunk of outputs");

struct Args90 {
  const bf16* x;       // (B, N, 512)
  const float* g;      // (512,) LayerNorm scale
  const bf16* Wqkv;    // (4 heads, 8 K tiles, 64 x 96) chunks (pack_attention_weights)
  const bf16* Wout;    // (8 groups, 2 K tiles, 64 x 64) chunks (pack_group_tiles)
  const float* bout;   // (512,)
  bf16* out;           // (B, N, 512)
  int B, n, ts, tiles;
  float eps, scale;
};

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// This lane's 16 columns of the LayerNorm scale: in bf16 8l..8l+7 and
// 256 + 8l.. (one 16-byte load of a bf16 row each), in f32 4l..4l+3, 128 +
// 4l.., 256 + 4l.., 384 + 4l.. (one 16-byte load of an f32 row each)
template <typename T>
__device__ __forceinline__ void load_scale(float (&gv)[16], const float* g) {
  constexpr int kPer = 16 / sizeof(T), kStride = kC / (16 / kPer);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 16 / kPer; ++h)
#pragma unroll
    for (int i = 0; i < kPer; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(g + kStride * h + kPer * lane + i));
      gv[kPer * h + i] = v.x, gv[kPer * h + i + 1] = v.y;
      gv[kPer * h + i + 2] = v.z, gv[kPer * h + i + 3] = v.w;
    }
}

// Row r of a T tile (stride ld) at this lane's 16 columns (load_scale's)
// to and from f32 registers
template <typename T>
__device__ __forceinline__ void load_row(float (&v)[16], const T* X, int ld, int r);
template <>
__device__ __forceinline__ void load_row<bf16>(float (&v)[16], const bf16* X, int ld, int r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 w4 = *reinterpret_cast<const uint4*>(X + r * ld + 256 * h + 8 * lane);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * h + 2 * i] = bf_lo(w[i]);
      v[8 * h + 2 * i + 1] = bf_hi(w[i]);
    }
  }
}
template <>
__device__ __forceinline__ void load_row<float>(float (&v)[16], const float* X, int ld, int r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 u = *reinterpret_cast<const float4*>(X + r * ld + 128 * h + 4 * lane);
    v[4 * h] = u.x, v[4 * h + 1] = u.y, v[4 * h + 2] = u.z, v[4 * h + 3] = u.w;
  }
}
template <typename T>
__device__ __forceinline__ void store_row(T* X, int ld, int r, const float (&v)[16]);
template <>
__device__ __forceinline__ void store_row<bf16>(bf16* X, int ld, int r, const float (&v)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf_pack(v[8 * h + 2 * i], v[8 * h + 2 * i + 1]);
    *reinterpret_cast<uint4*>(X + r * ld + 256 * h + 8 * lane) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}
template <>
__device__ __forceinline__ void store_row<float>(float* X, int ld, int r, const float (&v)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 4; ++h)
    *reinterpret_cast<float4*>(X + r * ld + 128 * h + 4 * lane) =
        make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

// LN(x) of rows [0, rows) in place over the x tile (T, stride ld), rounded
// to T: worker warp w takes rows w, w + 8, ..., four at a time (independent
// chains of sums and shuffles); each lane holds its 16 columns of each row
// in registers, and gv the scale at those columns.
template <typename T>
__device__ __forceinline__ void layernorm_rows(T* X, int ld, int rows, const float (&gv)[16],
                                               float eps) {
  constexpr int kR = 4, kW = kWorkers / 32;
  const int warp = threadIdx.x >> 5;
  for (int base = warp; base < rows; base += kR * kW) {
    float v[kR][16], s[kR], q[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      load_row<T>(v[u], X, ld, min(base + u * kW, rows - 1));
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = v[u][2 * i] + v[u][2 * i + 1];
      s[u] = ((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int u = 0; u < kR; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      s[u] = s[u] / (float)kC;   // the mean
      float t[8];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[u][i] -= s[u];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = v[u][2 * i] * v[u][2 * i] + v[u][2 * i + 1] * v[u][2 * i + 1];
      q[u] = ((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int u = 0; u < kR; ++u) q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int r = base + u * kW;
      if (r >= rows) continue;
      const float rstd = rsqrtf(q[u] / (float)kC + eps);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[u][i] = v[u][i] * rstd * gv[i];
      store_row<T>(X, ld, r, v[u]);
    }
  }
}

// This warpgroup's 48 columns of q | k | v (the wgmma accumulators) in f32
// into rows r0 and r0 + 8 of QKV, q scaled by d^-1/2 (the scores' operand)
__device__ __forceinline__ void store_qkv(float* QKV, const float (&acc)[kGroupQkv / 2], int wg,
                                          int r0, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kGroupQkv / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = wg * kGroupQkv + 8 * j + 2 * t;
      float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (c < kDh) {
        v0 *= scale;
        v1 *= scale;
      }
      tile::st2<float>(QKV + (r0 + 8 * hh) * kLdq + c, v0, v1);
    }
}

// Scores, softmax and P v of this CTA's head for the tile's nsc scenes of n
// rows, in f32 (q was scaled by d^-1/2 when stored); o_h[r][d] handed to
// store_o(r, d, value).  By the worker threads, each on several independent
// chains.
template <class StoreO>
__device__ __forceinline__ void attend(const float* QKV, float* P, int nsc, int n,
                                       StoreO store_o) {
  constexpr int kW = kWorkers / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rows = nsc * n;
  // scores: item i is (scene, query, key); kI items a thread at once
  constexpr int kI = 3;
  const int nn = n * n, items = nsc * nn;
  for (int i0 = tid; i0 < items; i0 += kI * kWorkers) {
    const float4* qa[kI];
    const float4* ka[kI];
    int dst[kI];
    float sc[kI];
#pragma unroll
    for (int u = 0; u < kI; ++u) {
      sc[u] = 0.f;
      const int i = min(i0 + u * kWorkers, items - 1);
      const int s = i / nn, qi = (i - s * nn) / n, kj = i - s * nn - qi * n;
      qa[u] = reinterpret_cast<const float4*>(QKV + (s * n + qi) * kLdq);
      ka[u] = reinterpret_cast<const float4*>(QKV + (s * n + kj) * kLdq + kDh);
      dst[u] = (s * n + qi) * kLdp + kj;
    }
#pragma unroll
    for (int d4 = 0; d4 < kDh / 4; ++d4)
#pragma unroll
      for (int u = 0; u < kI; ++u) {
        const float4 q = qa[u][d4], k = ka[u][d4];
        sc[u] = fmaf(q.x, k.x, sc[u]);
        sc[u] = fmaf(q.y, k.y, sc[u]);
        sc[u] = fmaf(q.z, k.z, sc[u]);
        sc[u] = fmaf(q.w, k.w, sc[u]);
      }
#pragma unroll
    for (int u = 0; u < kI; ++u)
      if (i0 + u * kWorkers < items) P[dst[u]] = sc[u];
  }
  sm90::bar_sync<kWorkers>(1);
  // softmax over each row: four threads a row (rows <= 64), thread h of the
  // four holding keys h, h + 4, ... in registers
  {
    constexpr int kK = kMaxN / 4;
    const int r = tid >> 2, h = tid & 3;
    float* p = P + min(r, rows - 1) * kLdp;
    float v[kK];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      v[i] = 4 * i + h < n ? p[4 * i + h] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kK; ++i)
      if (4 * i + h < n) {
        v[i] = expf(v[i] - m);
        sum += v[i];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (r < rows)
#pragma unroll
      for (int i = 0; i < kK; ++i)
        if (4 * i + h < n) p[4 * i + h] = v[i] / sum;
  }
  sm90::bar_sync<kWorkers>(1);
  // o = P v: lane = column, worker warp w rows w, w + 8, ..., four at a time
  for (int base = warp; base < rows; base += 4 * kW) {
    const float* pr[4];
    const float* vr[4];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = min(base + u * kW, rows - 1);
      pr[u] = P + r * kLdp;
      vr[u] = QKV + (r / n) * n * kLdq + 2 * kDh + lane;
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(pr[u][j], vr[u][j * kLdq], acc[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = base + u * kW;
      if (r < rows) store_o(r, lane, acc[u]);
    }
  }
}

__global__ void __cluster_dims__(kHeads, 1, 1) __launch_bounds__(kThreads90, 1)
    attention_sm90(const Args90 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem + kRing);
  bf16* X = reinterpret_cast<bf16*>(smem + kX);
  float* QKV = reinterpret_cast<float*>(smem + kX);
  float* P = QKV + kTileRows * kLdq;
  bf16* Wo = reinterpret_cast<bf16*>(smem + kWo);
  bf16* O = reinterpret_cast<bf16*>(smem + kO);
  float* Bo = reinterpret_cast<float*>(smem + kBo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);   // [kt]: W_qkv chunk kt
  uint64_t* xbar = full + kKt;     // the x tile
  uint64_t* wbar = xbar + 1;       // the W_out block and b_out
  uint64_t* obar = wbar + 1;       // [q]: CTA q's slice of o has landed here

  const int head = (int)cg::this_cluster().block_rank();
  const int clusters = gridDim.x / kHeads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int kt = 0; kt < kKt; ++kt) sm90::mbar_init(&full[kt], 1);
    sm90::mbar_init(xbar, 1);
    sm90::mbar_init(wbar, 1);
    for (int q = 0; q < kHeads; ++q) sm90::mbar_init(&obar[q], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // every CTA's barriers are set up
  sm90::cluster_wait();

  uint32_t it = 0;
  for (int tile = blockIdx.x / kHeads; tile < a.tiles; tile += clusters, ++it) {
    const int scene0 = tile * a.ts;
    const int nsc = min(a.ts, a.B - scene0);   // the last tile may be ragged
    const int rows = nsc * a.n;
    const size_t row0 = (size_t)scene0 * a.n;
    const uint32_t par = it & 1;

    if (warp == kWorkers / 32) {
      // ---- producer warp: the x tile (CTA h loads rows h, h + 4, ... into
      // all 4 CTAs), then on the first tile this CTA's weights ----
      if (lane == 0) sm90::mbar_expect_tx(xbar, (uint32_t)(rows * kC * 2));
      __syncwarp();
      for (int r = head + kHeads * lane; r < rows; r += kHeads * 32)
        sm90::bulk_load_multicast(X + r * kLdx, a.x + (row0 + r) * kC, kC * 2, xbar,
                                  (1u << kHeads) - 1);
      if (it == 0 && lane == 0) {
        const bf16* w = a.Wqkv + (size_t)head * kKt * kQkvChunkElems;
        for (int kt = 0; kt < kKt; ++kt) {
          sm90::mbar_expect_tx(&full[kt], kQkvChunkBytes);
          sm90::bulk_load(ring + kt * kQkvChunkElems, w + (size_t)kt * kQkvChunkElems,
                          kQkvChunkBytes, &full[kt]);
        }
        sm90::mbar_expect_tx(wbar, kOutElems * 2 + kOutCols * 4);
        sm90::bulk_load(Wo, a.Wout + (size_t)head * kOutElems, kOutElems * 2, wbar);
        sm90::bulk_load(Bo, a.bout + head * kOutCols, kOutCols * 4, wbar);
      }
      sm90::cluster_arrive_relaxed();
    } else {
      // ---- the two consumer warpgroups: warpgroup wg owns columns
      // [48 wg, 48 wg + 48) of q | k | v and [64 wg, 64 wg + 64) of the
      // CTA's outputs; all 256 threads share the f32 phases ----
      const int wg = warp / 4, wwarp = warp % 4;
      const int g = lane >> 2, t = lane & 3;
      const int r0 = 16 * wwarp + g;               // this thread's rows: r0, r0 + 8
      const int row = 16 * wwarp + (lane & 15), half = lane >> 4;   // ldmatrix
      if (threadIdx.x == 0)
        for (int q = 0; q < kHeads; ++q)
          if (q != head) sm90::mbar_expect_tx(&obar[q], (uint32_t)(rows * kDh * 2));

      float gv[16];
      load_scale<bf16>(gv, a.g);
      sm90::mbar_wait(xbar, par);
      layernorm_rows<bf16>(X, kLdx, rows, gv, a.eps);
      sm90::bar_sync<kWorkers>(1);

      // this warpgroup's 48 columns of q | k | v = LN(x) @ W_qkv[:, cols],
      // four K tiles a commit group
      constexpr int kStep = 4;
      float acc[kGroupQkv / 2];
#pragma unroll
      for (int i = 0; i < kGroupQkv / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int kt = 0; kt < kKt; kt += kStep) {
        uint32_t af[kStep][4][4];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          sm90::mbar_wait(&full[kt + u], 0);   // loaded once, complete from then on
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tile::ldmatrix_x4(af[u][j], X + row * kLdx + (kt + u) * sm90::kChunkK + 16 * j +
                                            8 * half);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const uint64_t d = sm90::desc_add(
              sm90::kmajor_desc(ring + (kt + u) * kQkvChunkElems, kQkvLbo), wg * kGroupQkv * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sm90::wgmma_m64n48k16(acc, af[u][j], sm90::desc_add(d, j * kQkvKStep));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(acc);
      }
      sm90::bar_sync<kWorkers>(1);     // the tile is read: its bytes take q | k | v
      store_qkv(QKV, acc, wg, r0, a.scale);
      sm90::bar_sync<kWorkers>(1);

      attend(QKV, P, nsc, a.n, [&](int r, int d, float v) {
        O[r * kLdo + head * kDh + d] = __float2bfloat16(v);
      });
      sm90::bar_sync<kWorkers>(1);

      // the exchange: this CTA's slice of o (rows x 32, 4 pieces of 16
      // bytes a row) into the same place in the other CTAs' o, each piece
      // completing on their barrier for this slice
      {
        const unsigned char* mine = reinterpret_cast<const unsigned char*>(O + head * kDh);
        uint32_t dst[kHeads - 1], bar[kHeads - 1];
#pragma unroll
        for (int p = 0; p < kHeads - 1; ++p) {
          const int peer = (head + 1 + p) % kHeads;
          dst[p] = sm90::cluster_addr(mine, peer);
          bar[p] = sm90::cluster_addr(&obar[head], peer);
        }
        for (int i = threadIdx.x; i < rows * (kDh / 8); i += kWorkers) {
          const uint32_t off = (i / (kDh / 8)) * kLdo * 2 + (i % (kDh / 8)) * 16;
          const uint4 v = *reinterpret_cast<const uint4*>(mine + off);
#pragma unroll
          for (int p = 0; p < kHeads - 1; ++p) sm90::st_async(dst[p] + off, v, bar[p]);
        }
      }

      // this thread's residual pairs of x, loaded while the slices land
      const int col0 = head * kOutCols + wg * sm90::kChunkN;   // this warpgroup's outputs
      uint32_t xr[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bf16* xrow = a.x + (row0 + min(r0 + 8 * hh, rows - 1)) * kC + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xr[hh][j] = __ldg(reinterpret_cast<const unsigned int*>(xrow + 8 * j + 2 * t));
      }
      for (int q = 0; q < kHeads; ++q)
        if (q != head) sm90::mbar_wait(&obar[q], par);
      sm90::mbar_wait(wbar, 0);

      // out[:, col0 + 0..63] = o @ W_out[:, those columns], K = 128
      float acc2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
      uint32_t af[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) tile::ldmatrix_x4(af[s], O + row * kLdo + 16 * s + 8 * half);
      // the x tile and o are read: the end of the tile's cluster barrier
      if (tile + clusters < a.tiles) sm90::fence_proxy_async();
      sm90::cluster_arrive();
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s)
        sm90::wgmma_m64n64k16(acc2, af[s],
                              sm90::desc_add(sm90::chunk_desc(Wo + (2 * wg + s / 4) *
                                                                       sm90::kChunkElems),
                                             (s % 4) * sm90::kChunkKStep));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(acc2);

      const float* bo = Bo + wg * sm90::kChunkN;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (r < rows) {
          bf16* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t, i = 4 * j + 2 * hh;
            tile::st2<bf16>(o + c, bf_lo(xr[hh][j]) + (acc2[i] + bo[c]),
                            bf_hi(xr[hh][j]) + (acc2[i + 1] + bo[c + 1]));
          }
        }
      }
    }
    // the end of the tile: every CTA is done with its x tile and its o, and
    // every slice it was sent has landed
    sm90::cluster_wait();
  }
}

cudaError_t prepare_sm90() {   // once
  static const cudaError_t err =
      cudaFuncSetAttribute(attention_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem90);
  return err;
}

// clusters of attention_sm90 that fit on the card at once, or minus a
// cudaError_t code
int resident_clusters() {
  static const int n = [] {
    const cudaError_t err = prepare_sm90();
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kHeads * 64);
    cfg.blockDim = dim3(kThreads90);
    cfg.dynamicSmemBytes = kSmem90;
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, attention_sm90, &cfg);
    return e != cudaSuccess ? -(int)e : clusters > 0 ? clusters : -(int)cudaErrorInvalidConfiguration;
  }();
  return n;
}

int launch_sm90(const Args90& a, cudaStream_t stream) {
  const int resident = resident_clusters();
  if (resident < 0) return -resident;
  const int clusters = a.tiles < resident ? a.tiles : resident;
  attention_sm90<<<clusters * kHeads, kThreads90, kSmem90, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the split-TF32 cluster kernel
// ---------------------------------------------------------------------------

using sm90::kStepK;
constexpr int kStepsQkv = kC / kStepK;                 // K steps of the qkv product: 16
constexpr int kStepsOut = kHeads * kDh / kStepK;       // of the output product: 4, step q = slice q
constexpr int kQkvPartT = kStepK * kQkvCols;           // floats of a qkv step's hi (or lo) part
constexpr uint32_t kQkvBytesT = 2 * kQkvPartT * 4;     // a qkv step, hi and lo: 24 KB
constexpr uint32_t kQkvLboT = kQkvCols / 8 * 128;      // next core matrix in k: 1536 bytes
constexpr uint32_t kQkvKStepT = 2 * kQkvLboT;          // next 8-deep k step
constexpr int kOutPartsT = kOutCols / sm90::kGroup;    // W_out chunks of a step: one a warpgroup
constexpr int kOutChunkT = 2 * sm90::kChunkPartF;      // floats of one (pack_tf32_tiles)
constexpr int kStagesT = 3;                            // the ring
constexpr int kStageT = kOutPartsT * kOutChunkT;       // floats of a stage: a W_out step, 32 KB
constexpr int kLdxT = kC + 4;                          // x / LN(x) tile stride (floats)
constexpr int kLdoT = kDh + 4;                         // a slice of o: stride (floats)
constexpr int kSliceT = kTileRows * kLdoT;             // floats of a slice

// shared-memory layout of attention_tf32 (bytes); q | k | v, the
// probabilities and the gathered o live in the x tile's space once the qkv
// product has read it
constexpr unsigned kRingT = 0;                                   // 3 x 32 KB
constexpr unsigned kXT = kRingT + kStagesT * kStageT * 4;        // x, LN(x), then q | k | v
constexpr unsigned kPT = kXT + kTileRows * kLdq * 4;             // the probabilities
constexpr unsigned kOT = kPT + kTileRows * kLdp * 4;             // the gathered o: 4 slices
constexpr unsigned kBoT = kXT + kTileRows * kLdxT * 4;           // this CTA's b_out
constexpr unsigned kBarsT = kBoT + kOutCols * 4;                 // full[3], empty[3], x, o[4]
constexpr unsigned kSmemT = kBarsT + (2 * kStagesT + 1 + kHeads) * 8;
static_assert(kQkvBytesT <= kStageT * 4, "a qkv step fits in a stage");
static_assert(kOT + kHeads * kSliceT * 4 <= kBoT, "q | k | v, P and o fit in the x tile's space");
static_assert(kOT % 16 == 0 && kSliceT * 4 % 16 == 0 && kLdoT * 4 % 16 == 0,
              "the slices of o move by bulk copy");
static_assert(kSmemT <= 232448, "one CTA's shared memory");
static_assert(kOutPartsT == kGroups && kStepsOut == kHeads, "a warpgroup a W_out chunk, a step a slice");

struct ArgsT {
  const float* x;      // (B, N, 512)
  const float* g;      // (512,) LayerNorm scale
  const float* Wqkv;   // (4 heads, 16 K steps, 2, 32 x 96) split (pack_attention_weights_tf32)
  const float* Wout;   // (8 groups, 4 K steps, 2, 32 x 64) split (pack_tf32_tiles)
  const float* bout;   // (512,)
  float* out;          // (B, N, 512)
  int B, n, ts;
  float eps, scale;
};

// d += A @ (this warpgroup's 48 columns of the qkv step at `chunk`: hi,
// then lo), as hi*lo + lo*hi + hi*hi in each of the step's 4 k steps
__device__ __forceinline__ void qkv_products(float (&d)[kGroupQkv / 2], const uint32_t (&ah)[16],
                                             const uint32_t (&al)[16], const float* chunk, int wg) {
  const uint32_t cols = wg * kGroupQkv * 16;   // 6 core matrices of 8 columns, 128 bytes apart
  const uint64_t bh = sm90::desc_add(sm90::kmajor_desc(chunk, kQkvLboT), cols);
  const uint64_t bl = sm90::desc_add(sm90::kmajor_desc(chunk + kQkvPartT, kQkvLboT), cols);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm90::wgmma_m64n48k8_tf32(d, ah + 4 * j, sm90::desc_add(bl, j * kQkvKStepT));
    sm90::wgmma_m64n48k8_tf32(d, al + 4 * j, sm90::desc_add(bh, j * kQkvKStepT));
    sm90::wgmma_m64n48k8_tf32(d, ah + 4 * j, sm90::desc_add(bh, j * kQkvKStepT));
  }
}

using RingA = sm90::RingT<kStagesT, kStageT>;

// acc += this warpgroup's 48 columns of q | k | v over the ring's next
// `nst` (even) qkv steps, A from load(st, hi, lo) (split); the next step's
// A fragments are loaded and split while a step's products run
template <class Load>
__device__ __forceinline__ void qkv_steps(float (&acc)[kGroupQkv / 2], int nst, Load load,
                                          RingA& w, int wg) {
  uint32_t h0[16], l0[16], h1[16], l1[16];
  load(0, h0, l0);
#pragma unroll 1
  for (int st = 0; st < nst; st += 2) {
    int s = w.take();
    sm90::wgmma_fence();
    qkv_products(acc, h0, l0, w.chunk(s), wg);
    sm90::wgmma_commit();
    load(st + 1, h1, l1);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    w.give(s);
    s = w.take();
    sm90::wgmma_fence();
    qkv_products(acc, h1, l1, w.chunk(s), wg);
    sm90::wgmma_commit();
    if (st + 2 < nst) load(st + 2, h0, l0);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    w.give(s);
  }
}

__global__ void __cluster_dims__(kHeads, 1, 1) __launch_bounds__(kThreads90, 1)
    attention_tf32(const ArgsT a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + kRingT);
  float* X = reinterpret_cast<float*>(smem + kXT);
  float* QKV = X;
  float* P = reinterpret_cast<float*>(smem + kPT);
  float* O = reinterpret_cast<float*>(smem + kOT);     // slice q: CTA q's o, 64 x 32
  float* Bo = reinterpret_cast<float*>(smem + kBoT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarsT);
  uint64_t* empty = full + kStagesT;
  uint64_t* xbar = empty + kStagesT;   // the x tile
  uint64_t* obar = xbar + 1;           // [q]: CTA q's slice of o has landed here

  const int head = (int)cg::this_cluster().block_rank();
  const int scene0 = (blockIdx.x / kHeads) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);   // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesT; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWorkers);
    }
    sm90::mbar_init(xbar, 1);
    for (int q = 0; q < kHeads; ++q) {
      sm90::mbar_init(&obar[q], 1);
      if (q != head) sm90::mbar_expect_tx(&obar[q], (uint32_t)(rows * kLdoT * 4));
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  if (warp == kWorkers / 32) {
    // ---- producer warp: the x tile (CTA h loads rows h, h + 4, ... into
    // all 4 CTAs), then this CTA's split weights through the ring ----
    if (lane == 0) sm90::mbar_expect_tx(xbar, (uint32_t)(rows * kC * 4));
    __syncwarp();
    for (int r = head + kHeads * lane; r < rows; r += kHeads * 32)
      sm90::bulk_load_multicast(X + r * kLdxT, a.x + (row0 + r) * kC, kC * 4, xbar,
                                (1u << kHeads) - 1);
    sm90::cluster_arrive_relaxed();      // (1) this warp reads no x tile
    if (lane == 0) {
      RingA w{ring, full, empty, 0, 0};
      const float* wq = a.Wqkv + (size_t)head * kStepsQkv * 2 * kQkvPartT;
      for (int st = 0; st < kStepsQkv; ++st) w.put(wq + (size_t)st * 2 * kQkvPartT, kQkvBytesT);
      // W_out's steps in the order the output product takes the slices:
      // this CTA's first; step q holds groups 2h and 2h + 1's chunks of it
      for (int i = 0; i < kStepsOut; ++i) {
        const int q = (head + i) % kHeads;
        w.put(a.Wout + (size_t)(kOutPartsT * head * kStepsOut + q) * kOutChunkT,
              kOutChunkT * 4, kOutPartsT, (size_t)kStepsOut * kOutChunkT);
      }
    }
    sm90::cluster_wait();            // (1)
    sm90::cluster_arrive_relaxed();  // (2)
    sm90::cluster_wait();            // (2)
    return;
  }

  // ---- the two consumer warpgroups: warpgroup wg owns columns [48 wg,
  // 48 wg + 48) of q | k | v and [64 wg, 64 wg + 64) of the CTA's outputs;
  // all 256 threads share the f32 phases ----
  const int wg = warp / 4;
  const int t = lane & 3;
  const int r0 = 16 * (warp % 4) + (lane >> 2);   // this thread's rows: r0, r0 + 8
  if (threadIdx.x < kOutCols) Bo[threadIdx.x] = a.bout[head * kOutCols + threadIdx.x];
  RingA w{ring, full, empty, 0, 0};

  float gv[16];
  load_scale<float>(gv, a.g);
  sm90::mbar_wait(xbar, 0);
  layernorm_rows<float>(X, kLdxT, rows, gv, a.eps);
  sm90::bar_sync<kWorkers>(1);

  // this warpgroup's 48 columns of q | k | v = LN(x) @ W_qkv[:, cols]
  float acc[kGroupQkv / 2];
#pragma unroll
  for (int i = 0; i < kGroupQkv / 2; ++i) acc[i] = 0.f;
  qkv_steps(
      acc, kStepsQkv,
      [&](int st, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
        sm90::load_a<kLdxT>(X + st * kStepK, hi, lo);
      },
      w, wg);
  sm90::bar_sync<kWorkers>(1);   // the tile is read: its bytes take q | k | v
  // (1) this CTA is done reading its x tile: the others may copy o into it
  sm90::cluster_arrive();
  store_qkv(QKV, acc, wg, r0, a.scale);
  sm90::bar_sync<kWorkers>(1);

  attend(QKV, P, nsc, a.n,
         [&](int r, int d, float v) { O[head * kSliceT + r * kLdoT + d] = v; });

  // the exchange: once every CTA is done with its x tile, 3 threads copy
  // this CTA's slice into the same place in the other CTAs' o, completing on
  // their barrier for it
  sm90::fence_proxy_async_shared();   // the slice's writes before the copies read it
  sm90::bar_sync<kWorkers>(1);
  sm90::cluster_wait();               // (1)
  if (threadIdx.x < kHeads - 1) {
    const int peer = (head + 1 + threadIdx.x) % kHeads;
    const float* mine = O + head * kSliceT;
    sm90::bulk_copy_to_peer(sm90::cluster_addr(mine, peer), mine, (uint32_t)(rows * kLdoT * 4),
                            sm90::cluster_addr(&obar[head], peer));
  }

  // this thread's residual pairs of x, exact, loaded while the slices land
  const int col0 = head * kOutCols + wg * sm90::kGroup;   // this warpgroup's outputs
  float2 xr[2][8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float* xrow = a.x + (row0 + min(r0 + 8 * hh, rows - 1)) * kC + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) xr[hh][j] = __ldg(reinterpret_cast<const float2*>(xrow + 8 * j + 2 * t));
  }

  // out[:, col0 + 0..63] = o @ W_out[:, those columns]: K step i takes slice
  // (head + i) % 4, each other CTA's once it has landed
  float acc2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
  {
    uint32_t h0[16], l0[16], h1[16], l1[16];
    sm90::load_a<kLdoT>(O + head * kSliceT, h0, l0);
#pragma unroll 1
    for (int i = 0; i < kStepsOut; i += 2) {
      int s = w.take();
      sm90::wgmma_fence();
      sm90::products_3x(acc2, h0, l0, w.chunk(s) + wg * kOutChunkT);
      sm90::wgmma_commit();
      int q = (head + i + 1) % kHeads;
      sm90::mbar_wait(&obar[q], 0);
      sm90::load_a<kLdoT>(O + q * kSliceT, h1, l1);
      sm90::wgmma_wait<0>();
      sm90::fence_operand(acc2);
      w.give(s);
      s = w.take();
      sm90::wgmma_fence();
      sm90::products_3x(acc2, h1, l1, w.chunk(s) + wg * kOutChunkT);
      sm90::wgmma_commit();
      if (i + 2 < kStepsOut) {
        q = (head + i + 2) % kHeads;
        sm90::mbar_wait(&obar[q], 0);
        sm90::load_a<kLdoT>(O + q * kSliceT, h0, l0);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operand(acc2);
      w.give(s);
    }
  }
  sm90::cluster_arrive_relaxed();   // (2) every slice of this CTA's o has landed

  const float* bo = Bo + wg * sm90::kGroup;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r < rows) {
      float* o = a.out + (row0 + r) * kC + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t, i = 4 * j + 2 * hh;
        tile::st2<float>(o + c, xr[hh][j].x + (acc2[i] + bo[c]),
                         xr[hh][j].y + (acc2[i + 1] + bo[c + 1]));
      }
    }
  }
  sm90::cluster_wait();             // (2) no CTA leaves before every slice has landed
}

cudaError_t prepare_tf32() {   // once
  static const cudaError_t err =
      cudaFuncSetAttribute(attention_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemT);
  return err;
}

int launch_tf32(const ArgsT& a, cudaStream_t stream) {
  const cudaError_t err = prepare_tf32();
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((a.B + a.ts - 1) / a.ts);
  attention_tf32<<<tiles * kHeads, kThreads90, kSmemT, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C = 256 and 1024: the wide kernels, f32 and bf16
// ---------------------------------------------------------------------------
//
// attention_tf32_wide and attention_bf16_wide take the widths
// attention_tf32 and attention_sm90 do not (C = 256 or 1024; they take 512
// too, but the C = 512 kernels serve that).  They are one body
// (attention_wide) over the element type: the same scene tile, cluster of
// 4 CTAs (CTA h owns head h), thread roles, attention arithmetic and
// exchange of o as the C = 512 kernels; what changes is where LN(x) comes
// from.  An f32 x tile of 64 x 1024 is 256 KB, beyond a CTA's 227 KB, and
// a bf16 one (128 KB) leaves no room beside W_qkv (C x 96 bf16, 196 KB), so
// no x tile is held: the consumer warps first take each row's two-pass
// LayerNorm statistics (mean, then the variance around it, the row's
// values in registers) from device memory into shared memory, and the qkv
// product then reads its A fragments from device memory (L2), normalising
// them on the way: (x - mean) * rstd * g, the plain version's order (bf16:
// rounded to bf16, the product's operand).  q | k | v, the probabilities
// and the gathered o keep their own shared memory (no reuse of bytes, so no
// barrier before the exchange beyond the one after the mbarriers' set-up).
// The CTA's C / 4 output columns run as 64-column chunks, warpgroup g
// taking chunks g, g + 2, ... (at C = 256 the second warpgroup has none and
// only passes the ring's stages back).  The weights stream through a ring
// of 3 stages.  f32: split TF32 on wgmma m64n48k8 and m64n64k8 as
// attention_tf32.  bf16: the qkv product on wgmma m64n48k16 over 64-deep K
// steps (the chunks of pack_attention_weights with the k permuted as
// sm90::load_a_global_bf16 reads its rows); o is rounded to bf16 as it is
// written into its f32 slice (so the exchange is the f32 one), and each
// 32-deep step of the output product (one slice) is two wgmma m64n64k16 on
// the half of a W_out chunk (pack_group_tiles) that holds it.  What bounds
// it: as the C = 512 kernels, the latency of a CTA's chain of phases, with
// the weights (C x 96 and 128 x C / 4 a CTA) streamed from L2 once per
// tile.

constexpr int kMaxCW = 1024;                       // C at most
constexpr int kLdsW = 2;                           // a row's LayerNorm mean, rstd

// what the element type decides: the depth of a qkv K step, the elements of
// a qkv step and of one output chunk's W_out step (a slice's 32 rows), and
// of a ring stage
template <typename T>
struct WideA;
template <>
struct WideA<float> {
  static constexpr int kStep = kStepK;
  static constexpr int kQkvStep = 2 * kQkvPartT;   // hi and lo
  static constexpr int kOutStep = kOutChunkT;
  static constexpr int kStage = kStageT;
};
template <>
struct WideA<bf16> {
  static constexpr int kStep = sm90::kChunkK;
  static constexpr int kQkvStep = kQkvChunkElems;
  static constexpr int kOutStep = sm90::kChunkElems / 2;   // half a 64-deep chunk
  static constexpr int kStage = kQkvChunkElems;
};
static_assert(kGroups * WideA<bf16>::kOutStep <= WideA<bf16>::kStage, "a W_out step fits a stage");

// shared-memory layout of a wide kernel with ring stages of `stage_bytes`
struct LayoutAW {
  unsigned ring, qkv, p, o, g, bo, stat, bars, total;
};

__host__ __device__ constexpr LayoutAW layout_attention_wide(unsigned stage_bytes) {
  LayoutAW L{};
  L.ring = 0;                                      // 3 stages
  L.qkv = L.ring + kStagesT * stage_bytes;         // q | k | v
  L.p = L.qkv + kTileRows * kLdq * 4;              // the probabilities
  L.o = L.p + kTileRows * kLdp * 4;                // the gathered o: 4 slices
  L.g = L.o + kHeads * kSliceT * 4;                // the LayerNorm scale
  L.bo = L.g + kMaxCW * 4;                         // this CTA's b_out
  L.stat = L.bo + kMaxCW / kHeads * 4;             // each row's mean, rstd
  L.bars = L.stat + kTileRows * kLdsW * 4;         // full[3], empty[3], o[4]
  L.total = L.bars + (2 * kStagesT + kHeads) * 8;
  return L;
}

template <typename T>
__host__ __device__ constexpr LayoutAW layout_attention_wide_of() {
  return layout_attention_wide(WideA<T>::kStage * sizeof(T));
}

constexpr unsigned kSmemW = layout_attention_wide_of<float>().total;
constexpr unsigned kSmemWB = layout_attention_wide_of<bf16>().total;
static_assert(layout_attention_wide_of<float>().o % 16 == 0 &&
                  layout_attention_wide_of<bf16>().o % 16 == 0,
              "the slices of o move by bulk copy");
static_assert(kSmemW <= 232448 && kSmemWB <= 232448, "one CTA's shared memory");

template <typename T>
struct ArgsW {
  const T* x;          // (B, N, C)
  const float* g;      // (C,) LayerNorm scale
  const T* Wqkv;       // (4 heads, C / kStep K steps, kQkvStep) (pack_attention_weights[_tf32])
  const T* Wout;       // (C / 64 chunks, 4 K steps, kOutStep) (pack_tf32_tiles, pack_group_tiles)
  const float* bout;   // (C,)
  T* out;              // (B, N, C)
  int B, n, C, ts;
  float eps, scale;
};

// 16 bytes of T at p as floats
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
template <>
__device__ __forceinline__ void load16<bf16>(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[2 * i] = bf_lo(w[i]), v[2 * i + 1] = bf_hi(w[i]);
}

// d += A @ (this warpgroup's 48 columns of the bf16 qkv chunk at `chunk`),
// the step's 4 k16 steps
__device__ __forceinline__ void qkv_products_bf16(float (&d)[kGroupQkv / 2],
                                                  const uint32_t (&af)[4][4], const bf16* chunk,
                                                  int wg) {
  const uint64_t b = sm90::desc_add(sm90::kmajor_desc(chunk, kQkvLbo), wg * kGroupQkv * 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) sm90::wgmma_m64n48k16(d, af[j], sm90::desc_add(b, j * kQkvKStep));
}

// qkv_steps in bf16: load(st, af) loads 64-deep step st's fragments
template <class Load, class Ring>
__device__ __forceinline__ void qkv_steps_bf16(float (&acc)[kGroupQkv / 2], int nst, Load load,
                                               Ring& w, int wg) {
  uint32_t a0[4][4], a1[4][4];
  load(0, a0);
#pragma unroll 1
  for (int st = 0; st < nst; st += 2) {
    int s = w.take();
    sm90::wgmma_fence();
    qkv_products_bf16(acc, a0, w.chunk(s), wg);
    sm90::wgmma_commit();
    load(st + 1, a1);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    w.give(s);
    s = w.take();
    sm90::wgmma_fence();
    qkv_products_bf16(acc, a1, w.chunk(s), wg);
    sm90::wgmma_commit();
    if (st + 2 < nst) load(st + 2, a0);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    w.give(s);
  }
}

// This thread's A fragments of one slice of o (64 x 32, f32 values already
// rounded to bf16, rows kLdoT floats apart) for wgmma m64n64k16: k16 step
// j's {(g, 16 j + 2 t), (g + 8, ..), (g, 16 j + 8 + 2 t), (g + 8, ..)}
__device__ __forceinline__ void load_o_bf16(const float* slice, uint32_t (&af)[2][4]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const float* p = slice + (16 * warp + (lane >> 2)) * kLdoT + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v0 = *reinterpret_cast<const float2*>(p + 16 * j + 8 * h);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kLdoT + 16 * j + 8 * h);
      af[j][2 * h] = bf_pack(v0.x, v0.y);
      af[j][2 * h + 1] = bf_pack(v1.x, v1.y);
    }
}

template <typename T>
__device__ __forceinline__ void attention_wide(const ArgsW<T>& a) {
  using W = WideA<T>;
  using Ring = sm90::RingT<kStagesT, W::kStage, T>;
  constexpr LayoutAW L = layout_attention_wide_of<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  float* QKV = reinterpret_cast<float*>(smem + L.qkv);
  float* P = reinterpret_cast<float*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);     // slice q: CTA q's o, 64 x 32
  float* G = reinterpret_cast<float*>(smem + L.g);
  float* Bo = reinterpret_cast<float*>(smem + L.bo);
  float2* stat = reinterpret_cast<float2*>(smem + L.stat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStagesT;
  uint64_t* obar = empty + kStagesT;   // [q]: CTA q's slice of o has landed here

  const int head = (int)cg::this_cluster().block_rank();
  const int scene0 = (blockIdx.x / kHeads) * a.ts;
  const int nsc = min(a.ts, a.B - scene0);   // the last tile may be ragged
  const int rows = nsc * a.n;
  const size_t row0 = (size_t)scene0 * a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = a.C / kHeads;              // this CTA's output columns
  const int nchunk = cols / sm90::kGroup;     // as 64-column chunks: 1, 2 or 4
  const int nst = a.C / W::kStep;             // K steps of the qkv product

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesT; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWorkers);
    }
    for (int q = 0; q < kHeads; ++q) {
      sm90::mbar_init(&obar[q], 1);
      if (q != head) sm90::mbar_expect_tx(&obar[q], (uint32_t)(rows * kLdoT * 4));
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  sm90::cluster_arrive();          // (0) every CTA's barriers are set up
  sm90::cluster_wait();

  if (warp == kWorkers / 32) {
    // ---- producer warp: this CTA's weights through the ring: the qkv
    // steps, then for each pair of output chunks W_out's 4 steps in the
    // order the output product takes the slices (this CTA's first) ----
    if (lane == 0) {
      Ring w{ring, full, empty, 0, 0};
      const T* wq = a.Wqkv + (size_t)head * nst * W::kQkvStep;
      for (int st = 0; st < nst; ++st)
        w.put(wq + (size_t)st * W::kQkvStep, W::kQkvStep * sizeof(T));
      for (int c = 0; c < nchunk; c += kGroups) {
        const int pieces = min(kGroups, nchunk - c);
        for (int i = 0; i < kStepsOut; ++i) {
          const int q = (head + i) % kHeads;
          w.put(a.Wout + ((size_t)(head * nchunk + c) * kStepsOut + q) * W::kOutStep,
                W::kOutStep * sizeof(T), pieces, (size_t)kStepsOut * W::kOutStep);
        }
      }
    }
    sm90::cluster_arrive_relaxed();  // (1)
    sm90::cluster_wait();
    return;
  }

  // ---- the two consumer warpgroups ----
  const int wg = warp / 4;
  const int t = lane & 3;
  const int r0 = 16 * (warp % 4) + (lane >> 2);   // this thread's rows: r0, r0 + 8
  for (int i = threadIdx.x; i < a.C; i += kWorkers) G[i] = a.g[i];
  for (int i = threadIdx.x; i < cols; i += kWorkers) Bo[i] = a.bout[head * cols + i];
  Ring w{ring, full, empty, 0, 0};

  // each row's two-pass LayerNorm statistics: warp w takes rows w, w + 8,
  // ..., lane l its columns kVec l + 32 kVec i (16-byte loads)
  {
    constexpr int kVec = 16 / sizeof(T), kSpan = 32 * kVec;
    for (int r = warp; r < rows; r += kWorkers / 32) {
      const T* xr = a.x + (row0 + r) * a.C;
      float v[kMaxCW / 32];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxCW / kSpan; ++i)
        if (kSpan * i < a.C) {
          float u[kVec];
          load16<T>(xr + kSpan * i + kVec * lane, u);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[kVec * i + e] = u[e];
#pragma unroll
          for (int w2 = 1; w2 < kVec; w2 *= 2)   // pairwise: (u0 + u1) + (u2 + u3) ...
#pragma unroll
            for (int e = 0; e < kVec; e += 2 * w2) u[e] += u[e + w2];
          s += u[0];
        }
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mean = s / (float)a.C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxCW / kSpan; ++i)
        if (kSpan * i < a.C)
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float d = v[kVec * i + e] - mean;
            q += d * d;
          }
#pragma unroll
      for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      if (lane == 0) stat[r] = make_float2(mean, rsqrtf(q / (float)a.C + a.eps));
    }
  }
  sm90::bar_sync<kWorkers>(1);

  // this warpgroup's 48 columns of q | k | v = LN(x) @ W_qkv[:, cols]; A
  // fragments of rows ra, rb from device memory, normalised
  const int ra = min(r0, rows - 1), rb = min(r0 + 8, rows - 1);
  const float2 sa = stat[ra], sb = stat[rb];
  const T* pa = a.x + (row0 + ra) * a.C;
  const T* pb = a.x + (row0 + rb) * a.C;
  float acc[kGroupQkv / 2];
#pragma unroll
  for (int i = 0; i < kGroupQkv / 2; ++i) acc[i] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    qkv_steps(
        acc, nst,
        [&](int st, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
          const int c = kStepK * st + 8 * t;
          float v[2][8];
          const float* p[2] = {pa + c, pb + c};
          const float2 m[2] = {sa, sb};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float4 u0 = __ldg(reinterpret_cast<const float4*>(p[r]));
            const float4 u1 = __ldg(reinterpret_cast<const float4*>(p[r]) + 1);
            const float x8[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[r][e] = (x8[e] - m[r].x) * m[r].y * G[c + e];
          }
          sm90::split_a(v, hi, lo);
        },
        w, wg);
  } else {
    // thread t's 16 columns [16 t, 16 t + 16) of the 64-deep step, rounded
    // to bf16 in pairs; the chunks' k is permuted to match
    // (sm90::load_a_global_bf16)
    qkv_steps_bf16(
        acc, nst,
        [&](int st, uint32_t (&af)[4][4]) {
          const int c = sm90::kChunkK * st + 16 * t;
          const T* p[2] = {pa + c, pb + c};
          const float2 m[2] = {sa, sb};
          uint32_t wd[2][8];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float x8[8];
              load16<T>(p[r] + 8 * hh, x8);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int e = 8 * hh + 2 * i;
                wd[r][4 * hh + i] = bf_pack((x8[2 * i] - m[r].x) * m[r].y * G[c + e],
                                            (x8[2 * i + 1] - m[r].x) * m[r].y * G[c + e + 1]);
              }
            }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            af[j][0] = wd[0][2 * j];
            af[j][1] = wd[1][2 * j];
            af[j][2] = wd[0][2 * j + 1];
            af[j][3] = wd[1][2 * j + 1];
          }
        },
        w, wg);
  }
  store_qkv(QKV, acc, wg, r0, a.scale);
  sm90::bar_sync<kWorkers>(1);

  // o_h into this CTA's slice, rounded to T (the output product's operand)
  attend(QKV, P, nsc, a.n,
         [&](int r, int d, float v) { O[head * kSliceT + r * kLdoT + d] = tile::rnd<T>(v); });

  // the exchange: 3 threads copy this CTA's slice into the same place in
  // the other CTAs' o, completing on their barrier for it
  sm90::fence_proxy_async_shared();   // the slice's writes before the copies read it
  sm90::bar_sync<kWorkers>(1);
  if (threadIdx.x < kHeads - 1) {
    const int peer = (head + 1 + threadIdx.x) % kHeads;
    const float* mine = O + head * kSliceT;
    sm90::bulk_copy_to_peer(sm90::cluster_addr(mine, peer), mine, (uint32_t)(rows * kLdoT * 4),
                            sm90::cluster_addr(&obar[head], peer));
  }
  for (int q = 0; q < kHeads; ++q)
    if (q != head) sm90::mbar_wait(&obar[q], 0);

  // out[:, chunk] = x + (o @ W_out[:, chunk] + b_out): warpgroup wg takes
  // chunks wg, wg + 2, ...; K step i takes slice (head + i) % 4
  for (int c = 0; c < nchunk; c += kGroups) {
    const int chunk = c + wg;
    const bool mine = chunk < nchunk;   // the same for the whole warpgroup
    float acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
    for (int i = 0; i < kStepsOut; ++i) {
      const int s = w.take();
      if (mine) {
        const float* slice = O + ((head + i) % kHeads) * kSliceT;
        const T* b = w.chunk(s) + wg * W::kOutStep;
        if constexpr (std::is_same<T, float>::value) {
          uint32_t h0[16], l0[16];
          sm90::load_a<kLdoT>(slice, h0, l0);
          sm90::wgmma_fence();
          sm90::products_3x(acc2, h0, l0, b);
        } else {
          uint32_t af[2][4];
          load_o_bf16(slice, af);
          const uint64_t d = sm90::chunk_desc(b);
          sm90::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sm90::wgmma_m64n64k16(acc2, af[j], sm90::desc_add(d, j * sm90::kChunkKStep));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(acc2);
      }
      w.give(s);
    }
    if (!mine) continue;
    const int col0 = head * cols + chunk * sm90::kGroup;
    const float* bo = Bo + chunk * sm90::kGroup;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r < rows) {
        const T* xrow = a.x + (row0 + r) * a.C + col0;
        T* o = a.out + (row0 + r) * a.C + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = 8 * j + 2 * t, i = 4 * j + 2 * hh;
          const float2 xv = tile::ld2<T>(xrow + cc);
          tile::st2<T>(o + cc, xv.x + (acc2[i] + bo[cc]), xv.y + (acc2[i + 1] + bo[cc + 1]));
        }
      }
    }
  }
  sm90::cluster_arrive_relaxed();   // (1) every slice of this CTA's o has landed
  sm90::cluster_wait();             // (1) no CTA leaves before every slice has landed
}

__global__ void __cluster_dims__(kHeads, 1, 1) __launch_bounds__(kThreads90, 1)
    attention_tf32_wide(const ArgsW<float> a) {
  attention_wide<float>(a);
}

__global__ void __cluster_dims__(kHeads, 1, 1) __launch_bounds__(kThreads90, 1)
    attention_bf16_wide(const ArgsW<bf16> a) {
  attention_wide<bf16>(a);
}

cudaError_t prepare_wide(int dtype) {   // once per dtype
  static const cudaError_t f32 = cudaFuncSetAttribute(
      attention_tf32_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemW);
  static const cudaError_t b16 = cudaFuncSetAttribute(
      attention_bf16_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemWB);
  return dtype == 1 ? b16 : f32;
}

template <typename T>
int launch_wide(const ArgsW<T>& a, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const cudaError_t err = prepare_wide(kBf16 ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((a.B + a.ts - 1) / a.ts);
  if constexpr (kBf16)
    attention_bf16_wide<<<tiles * kHeads, kThreads90, kSmemWB, stream>>>(a);
  else
    attention_tf32_wide<<<tiles * kHeads, kThreads90, kSmemW, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_as(const void* x, const float* g, const void* Wqkv, const void* Wout,
                   const float* bout, void* out, int B, int N, int C, float eps, float scale,
                   cudaStream_t stream) {
  ArgsW<T> a;
  a.x = static_cast<const T*>(x);
  a.g = g;
  a.Wqkv = static_cast<const T*>(Wqkv);
  a.Wout = static_cast<const T*>(Wout);
  a.bout = bout;
  a.out = static_cast<T*>(out);
  a.B = B;
  a.n = N;
  a.C = C;
  a.ts = kTileRows / N;
  a.eps = eps;
  a.scale = scale;
  return launch_wide(a, stream);
}

}  // namespace

extern "C" {

int set_attention_max_n() { return kMaxN; }
// dynamic shared memory of one CTA of the kernel that takes the `dtype` (0
// float32, 1 bfloat16) call at C channels
int set_attention_smem_bytes(int dtype, int C) {
  if (C != kC) return (int)(dtype == 1 ? kSmemWB : kSmemW);
  return (int)(dtype == 1 ? kSmem90 : kSmemT);
}
// clusters of 4 CTAs of that kernel that fit on the card at once, or minus
// a cudaError_t code
int set_attention_max_active_clusters(int dtype, int C) {
  const bool wide = C != kC;
  if (dtype == 1 && !wide) return resident_clusters();
  const cudaError_t err = wide ? prepare_wide(dtype) : prepare_tf32();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kHeads * 64);
  cfg.blockDim = dim3(kThreads90);
  cfg.dynamicSmemBytes = set_attention_smem_bytes(dtype, C);
  int clusters = 0;
  const cudaError_t e =
      !wide         ? cudaOccupancyMaxActiveClusters(&clusters, attention_tf32, &cfg)
      : dtype == 1 ? cudaOccupancyMaxActiveClusters(&clusters, attention_bf16_wide, &cfg)
                    : cudaOccupancyMaxActiveClusters(&clusters, attention_tf32_wide, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// The wide kernel of `dtype` at C = 256, 512 or 1024 (weights packed by
// pack_attention_weights_tf32, or by pack_attention_weights with the k
// permuted); set_attention_launch sends C = 512 to the C = 512 kernels, and
// calls this at the other widths.  Returns as set_attention_launch.
int set_attention_launch_wide(int dtype, const void* x, const float* g, const void* Wqkv,
                              const void* Wout, const float* bout, void* out, int B, int N, int C,
                              int heads, int dh, float eps, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || heads != kHeads || dh != kDh) return -1;
  if ((C != 256 && C != kC && C != kMaxCW) || (dtype != 0 && dtype != 1)) return -1;
  const float scale = (float)pow((double)dh, -0.5);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_wide_as<bf16>(x, g, Wqkv, Wout, bout, out, B, N, C, eps, scale, s);
  return launch_wide_as<float>(x, g, Wqkv, Wout, bout, out, B, N, C, eps, scale, s);
}

// dtype: 0 float32 (weights packed by pack_attention_weights_tf32), 1
// bfloat16 (by pack_attention_weights, the k permuted for the wide
// kernel).  Both take 4 heads of 32, N <= 24 and C = 256, 512 or 1024
// (attention_tf32 or attention_sm90 at 512, the dtype's wide kernel at the
// others).  Returns a cudaError_t code (0 on success), or -1 for arguments
// the kernels do not take.
int set_attention_launch(int dtype, const void* x, const float* g, const void* Wqkv,
                         const void* Wout, const float* bout, void* out, int B, int N, int C,
                         int heads, int dh, float eps, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || heads != kHeads || dh != kDh) return -1;
  if ((dtype != 0 && dtype != 1) || (C != 256 && C != kC && C != kMaxCW)) return -1;
  if (C != kC) return set_attention_launch_wide(dtype, x, g, Wqkv, Wout, bout, out, B, N, C, heads,
                                                dh, eps, stream);
  const float scale = (float)pow((double)dh, -0.5);   // dim_head ** -0.5, as the twin
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    Args90 a;
    a.x = static_cast<const bf16*>(x);
    a.g = g;
    a.Wqkv = static_cast<const bf16*>(Wqkv);
    a.Wout = static_cast<const bf16*>(Wout);
    a.bout = bout;
    a.out = static_cast<bf16*>(out);
    a.B = B;
    a.n = N;
    a.ts = kTileRows / N;
    a.tiles = (B + a.ts - 1) / a.ts;
    a.eps = eps;
    a.scale = scale;
    return launch_sm90(a, s);
  }
  ArgsT a;
  a.x = static_cast<const float*>(x);
  a.g = g;
  a.Wqkv = static_cast<const float*>(Wqkv);
  a.Wout = static_cast<const float*>(Wout);
  a.bout = bout;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.n = N;
  a.ts = kTileRows / N;
  a.eps = eps;
  a.scale = scale;
  return launch_tf32(a, s);
}

}  // extern "C"
