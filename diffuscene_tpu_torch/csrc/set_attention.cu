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
// bfloat16 (the serving dtype; attention_sm90): C = 512, 4 heads of 32.  A
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
// float32 (set_attention_f32, for parity): one scene per thread block, the
// whole scene in shared memory in f32, every product on the FMA pipes (thread
// t owns output columns 2t, 2t+1 of all 24 rows).
//
// What bounds it.  At B=64, N=12 a bf16 call reads 0.8 MB of x and 0.5 MB of
// weights and writes 0.8 MB: 0.6 us at the HBM rate; its 0.4 GFLOP take less
// on the tensor cores.  At that size the kernel is bound by latency along a
// CTA's chain of phases (the x tile's arrival, the LayerNorm, the qkv
// product, the per-scene attention, the exchange of o, the output product),
// 13 clusters of 4 CTAs on 132 SMs; the f32 phases are issue-bound on one
// SM's 8 consumer warps, hence two warpgroups.  At B=768 (154 tiles) the
// persistent clusters take about 5 tiles each, back to back.
#include <cooperative_groups.h>
#include <math.h>

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

// This lane's 16 columns of the LayerNorm scale: 8l..8l+7, 256 + 8l..
__device__ __forceinline__ void load_scale(float (&gv)[16], const float* g) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + 256 * h + 8 * lane));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + 256 * h + 8 * lane + 4));
    gv[8 * h + 0] = g0.x; gv[8 * h + 1] = g0.y; gv[8 * h + 2] = g0.z; gv[8 * h + 3] = g0.w;
    gv[8 * h + 4] = g1.x; gv[8 * h + 5] = g1.y; gv[8 * h + 6] = g1.z; gv[8 * h + 7] = g1.w;
  }
}

// LN(x) of rows [0, rows) in place over the x tile: worker warp w takes rows
// w, w + 8, ..., four at a time (independent chains of sums and shuffles);
// lane l holds columns 8l..8l+7 and 256 + 8l..256 + 8l + 7 of each row in
// registers, and gv the scale at those columns.
__device__ __forceinline__ void layernorm_rows(bf16* X, int rows, const float (&gv)[16],
                                               float eps) {
  constexpr int kR = 4, kW = kWorkers / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = warp; base < rows; base += kR * kW) {
    float v[kR][16], s[kR], q[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int r = min(base + u * kW, rows - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(X + r * kLdx + 256 * h + 8 * lane);
        const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[u][8 * h + 2 * i] = bf_lo(w[i]);
          v[u][8 * h + 2 * i + 1] = bf_hi(w[i]);
        }
      }
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
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 8 * h + 2 * i;
          w[i] = bf_pack(v[u][j] * rstd * gv[j], v[u][j + 1] * rstd * gv[j + 1]);
        }
        *reinterpret_cast<uint4*>(X + r * kLdx + 256 * h + 8 * lane) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// Scores, softmax and P v of head `head` for the tile's nsc scenes of n rows,
// in f32 with the f32 kernel's arithmetic (q was scaled by d^-1/2 when
// stored); o_h rounded to bf16 into columns [32 head, 32 head + 32) of the
// gathered o.  By the worker threads, each on several independent chains.
__device__ __forceinline__ void attend(const float* QKV, float* P, bf16* O, int head, int nsc,
                                       int n) {
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
      if (r < rows) O[r * kLdo + head * kDh + lane] = __float2bfloat16(acc[u]);
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
      load_scale(gv, a.g);
      sm90::mbar_wait(xbar, par);
      layernorm_rows(X, rows, gv, a.eps);
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
      // q | k | v in f32 over the tile, q scaled by d^-1/2 (the scores' operand)
#pragma unroll
      for (int j = 0; j < kGroupQkv / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = wg * kGroupQkv + 8 * j + 2 * t;
          float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
          if (c < kDh) {
            v0 *= a.scale;
            v1 *= a.scale;
          }
          tile::st2<float>(QKV + (r0 + 8 * hh) * kLdq + c, v0, v1);
        }
      sm90::bar_sync<kWorkers>(1);

      attend(QKV, P, O, head, nsc, a.n);
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
// float32: the parity kernel
// ---------------------------------------------------------------------------

constexpr int kPad = 8;      // shared-memory row padding (elements)
constexpr int kThreadsF32 = 256;

struct Args {
  const float* x;      // (B, N, C)
  const float* g;      // (C,) LayerNorm scale
  const float* Wqkv;   // (C, 3HD) (in, out)
  const float* Wout;   // (HD, C)
  const float* bout;   // (C,)
  float* out;          // (B, N, C)
  int B, N, C, heads, dh;
  float eps, scale;
};

// Y[0:N, 0:ncol] = A[0:kMaxN, 0:K] @ W, handed to store(r, c, v0, v1) for
// r < N, by the whole block: thread t owns columns 2t, 2t+1 (+ 2 blockDim).
template <typename F>
__device__ void block_mm(const float* A, int lda, const float* W, int K, int ncol, int N,
                         F store) {
  for (int c = 2 * threadIdx.x; c < ncol; c += 2 * blockDim.x) {
    float acc[kMaxN][2] = {};
    tile::fma_mm<kMaxN>(acc, A, lda, W, ncol, K, c);
    for (int r = 0; r < N; ++r) store(r, c, acc[r][0], acc[r][1]);
  }
}

__global__ void __launch_bounds__(kThreadsF32) set_attention_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, C = a.C, H = a.heads, D = a.dh, HD = a.heads * a.dh, Q3 = 3 * HD;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int ldx = C + 4, lda = C + kPad, ldq = Q3 + 4, ldo = HD + kPad, ldp = kMaxN + 1;

  size_t off = 0;
  float* X = reinterpret_cast<float*>(smem);                    // x
  off += tile::align16((size_t)kMaxN * ldx * sizeof(float));
  float* A = reinterpret_cast<float*>(smem + off);              // LN(x)
  off += tile::align16((size_t)kMaxN * lda * sizeof(float));
  float* Q = reinterpret_cast<float*>(smem + off);              // q | k | v
  off += tile::align16((size_t)kMaxN * ldq * sizeof(float));
  float* P = reinterpret_cast<float*>(smem + off);              // [H][N][N] scores, then probabilities
  off += tile::align16((size_t)H * kMaxN * ldp * sizeof(float));
  float* O = reinterpret_cast<float*>(smem + off);              // head outputs
  off += tile::align16((size_t)kMaxN * ldo * sizeof(float));
  float* stat = reinterpret_cast<float*>(smem + off);           // [2][N] mean, rsqrt

  const float* x = a.x + (size_t)blockIdx.x * N * C;
  float* out = a.out + (size_t)blockIdx.x * N * C;

  for (int i = tid; i < N * C / 2; i += nthr) {
    const int r = (2 * i) / C, c = (2 * i) % C;
    const float2 v = tile::ld2<float>(x + (size_t)r * C + c);
    tile::st2<float>(X + r * ldx + c, v.x, v.y);
  }
  // zero the padded rows of the two product operands
  for (int i = tid; i < (kMaxN - N) * C; i += nthr) A[(N + i / C) * lda + i % C] = 0.f;
  for (int i = tid; i < (kMaxN - N) * HD; i += nthr) O[(N + i / HD) * ldo + i % HD] = 0.f;
  __syncthreads();

  // two-pass LayerNorm statistics, one warp per row
  for (int r = warp; r < N; r += nthr / 32) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += X[r * ldx + c];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = X[r * ldx + c] - mean;
      v += d * d;
    }
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      stat[r] = mean;
      stat[kMaxN + r] = rsqrtf(v / (float)C + a.eps);
    }
  }
  __syncthreads();
  for (int i = tid; i < N * C; i += nthr) {
    const int r = i / C, c = i % C;
    A[r * lda + c] = (X[r * ldx + c] - stat[r]) * stat[kMaxN + r] * a.g[c];
  }
  __syncthreads();

  // q | k | v = LN(x) @ W_qkv
  block_mm(A, lda, a.Wqkv, C, Q3, N, [&](int r, int c, float v0, float v1) {
    tile::st2<float>(Q + r * ldq + c, v0, v1);
  });
  __syncthreads();

  // per head: scores of q * d^-1/2 against k
  for (int i = tid; i < H * N * N; i += nthr) {
    const int h = i / (N * N), qi = (i / N) % N, kj = i % N;
    const float* q = Q + qi * ldq + h * D;
    const float* k = Q + kj * ldq + HD + h * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(q[d] * a.scale, k[d], s);
    P[(h * kMaxN + qi) * ldp + kj] = s;
  }
  __syncthreads();
  // softmax over each row, in f32
  for (int i = tid; i < H * N; i += nthr) {
    float* p = P + ((i / N) * kMaxN + i % N) * ldp;
    float m = p[0];
    for (int j = 1; j < N; ++j) m = fmaxf(m, p[j]);
    float sum = 0.f;
    for (int j = 0; j < N; ++j) {
      p[j] = expf(p[j] - m);
      sum += p[j];
    }
    for (int j = 0; j < N; ++j) p[j] = p[j] / sum;
  }
  __syncthreads();
  // o = P @ v, per head
  for (int i = tid; i < N * HD; i += nthr) {
    const int r = i / HD, c = i % HD, h = c / D;
    const float* p = P + (h * kMaxN + r) * ldp;
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(p[j], Q[j * ldq + 2 * HD + c], s);
    O[r * ldo + c] = s;
  }
  __syncthreads();

  // out = x + (o @ W_out + b_out)
  block_mm(O, ldo, a.Wout, HD, C, N, [&](int r, int c, float v0, float v1) {
    const float2 xv = *reinterpret_cast<const float2*>(X + r * ldx + c);
    tile::st2<float>(out + (size_t)r * C + c, xv.x + (v0 + a.bout[c]), xv.y + (v1 + a.bout[c + 1]));
  });
}

size_t smem_bytes_f32(const Args& a) {
  const int HD = a.heads * a.dh;
  return tile::align16((size_t)kMaxN * (a.C + 4) * sizeof(float)) +
         tile::align16((size_t)kMaxN * (a.C + kPad) * sizeof(float)) +
         tile::align16((size_t)kMaxN * (3 * HD + 4) * sizeof(float)) +
         tile::align16((size_t)a.heads * kMaxN * (kMaxN + 1) * sizeof(float)) +
         tile::align16((size_t)kMaxN * (HD + kPad) * sizeof(float)) + 2 * kMaxN * sizeof(float);
}

int launch_f32(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      set_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_bytes_f32(a);
  if (smem > 232448) return -1;
  set_attention_f32<<<a.B, kThreadsF32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int set_attention_max_n() { return kMaxN; }
// dynamic shared memory of one bf16 CTA
int set_attention_smem_bytes() { return (int)kSmem90; }
// clusters of 4 bf16 CTAs that fit on the card at once, or minus a
// cudaError_t code
int set_attention_max_active_clusters() { return resident_clusters(); }

// dtype: 0 float32 (weights (in, out) as they are), 1 bfloat16 (C = 512,
// 4 heads of 32; weights packed by pack_attention_weights).  Returns a
// cudaError_t code (0 on success), or -1 for arguments the kernel does not
// take.
int set_attention_launch(int dtype, const void* x, const float* g, const void* Wqkv,
                         const void* Wout, const float* bout, void* out, int B, int N, int C,
                         int heads, int dh, float eps, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || C < 16 || C % 16 != 0 || heads < 1 || dh < 1 ||
      (heads * dh) % 16 != 0)
    return -1;
  const float scale = (float)pow((double)dh, -0.5);   // dim_head ** -0.5, as the twin
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (C != kC || heads != kHeads || dh != kDh) return -1;
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
  if (dtype != 0) return -1;
  Args a;
  a.x = static_cast<const float*>(x);
  a.g = g;
  a.Wqkv = static_cast<const float*>(Wqkv);
  a.Wout = static_cast<const float*>(Wout);
  a.bout = bout;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.dh = dh;
  a.eps = eps;
  a.scale = scale;
  return launch_f32(a, s);
}

}  // extern "C"
