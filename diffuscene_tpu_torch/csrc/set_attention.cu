// Pre-norm full set attention with its residual, one scene per thread block,
// for sm_90a.
//
// Replaces the Pallas kernel diffuscene_tpu/ops/attention.py:_attn_kernel
// (with _layernorm_g).  Per scene of N <= 24 objects and C channels:
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
// Design.  The whole scene stays on chip: x in f32, LN(x), q/k/v, the
// per-head (N, N) probabilities and the head outputs are shared-memory
// tiles; only x, the weights and the output touch device memory.  bfloat16
// products (qkv and the output projection) run on the tensor cores
// (mma.sync m16n8k16 over a 32-row tile, each warp taking pairs of 8-column
// tiles, B fragments from the packed weights of pack_mma_weights); float32
// products run on the FMA pipes.  The scores, softmax and the product with v
// are N x N x 32 per head: FMAs, one output per thread.
//
// What bounds it.  At B=64, N=12, C=512 a call reads 0.8 MB of x and 0.5 MB
// of weights and writes 0.8 MB: about 0.6 us at the HBM rate, and its 0.4
// GFLOP take about as long on the tensor cores.  With one block per scene
// (64 blocks) it is bound by latency: each block streams both weight
// matrices from L2 and runs its steps one after another.
#include <math.h>

#include "tile_mma.cuh"

namespace {

constexpr int kMaxN = 24;    // objects per scene
constexpr int kPad = 8;      // shared-memory row padding (elements)
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

struct Args {
  const void* x;       // (B, N, C)
  const float* g;      // (C,) LayerNorm scale
  const void* Wqkv;    // f32: (C, 3HD) (in, out); bf16: packed (3HD, C)
  const void* Wout;    // f32: (HD, C); bf16: packed (C, HD)
  const float* bout;   // (C,)
  void* out;           // (B, N, C)
  int B, N, C, heads, dh;
  float eps, scale;
};

template <typename T>
struct Tile {
  static constexpr int kRows = sizeof(T) == 2 ? 32 : kMaxN;
};

// Y[0:N, 0:ncol] = A[0:rows, 0:K] @ W (f32), handed to store(r, c, v0, v1)
// for r < N, by the whole block.
template <typename T, typename F>
__device__ void block_mm(const T* A, int lda, const void* W, int K, int ncol, int N, F store) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    for (int j0 = 2 * warp; j0 < ncol / 8; j0 += 2 * nwarp) {
      float acc[2][2][4] = {};
      tile::warp_mma<2>(acc, A, lda, static_cast<const bf16*>(W), K, 8 * j0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = 8 * (j0 + j) + 2 * t, r = 16 * m + g;
          if (r < N) store(r, c, acc[m][j][0], acc[m][j][1]);
          if (r + 8 < N) store(r + 8, c, acc[m][j][2], acc[m][j][3]);
        }
    }
  } else {
    for (int c = 2 * threadIdx.x; c < ncol; c += 2 * blockDim.x) {
      float acc[kMaxN][2] = {};
      tile::fma_mm<kMaxN>(acc, A, lda, static_cast<const float*>(W), ncol, K, c);
      for (int r = 0; r < N; ++r) store(r, c, acc[r][0], acc[r][1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) set_attention_kernel(Args a) {
  constexpr int kTile = Tile<T>::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, C = a.C, H = a.heads, D = a.dh, HD = a.heads * a.dh, Q3 = 3 * HD;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int ldx = C + 4, lda = C + kPad, ldq = Q3 + 4, ldo = HD + kPad, ldp = kMaxN + 1;

  size_t off = 0;
  float* X = reinterpret_cast<float*>(smem);                    // x in f32
  off += tile::align16((size_t)kMaxN * ldx * sizeof(float));
  T* A = reinterpret_cast<T*>(smem + off);                      // LN(x), rounded
  off += tile::align16((size_t)kTile * lda * sizeof(T));
  float* Q = reinterpret_cast<float*>(smem + off);              // q | k | v
  off += tile::align16((size_t)kMaxN * ldq * sizeof(float));
  float* P = reinterpret_cast<float*>(smem + off);              // [H][N][N] scores, then probabilities
  off += tile::align16((size_t)H * kMaxN * ldp * sizeof(float));
  T* O = reinterpret_cast<T*>(smem + off);                      // head outputs, rounded
  off += tile::align16((size_t)kTile * ldo * sizeof(T));
  float* stat = reinterpret_cast<float*>(smem + off);           // [2][N] mean, rsqrt

  const T* x = static_cast<const T*>(a.x) + (size_t)blockIdx.x * N * C;
  T* out = static_cast<T*>(a.out) + (size_t)blockIdx.x * N * C;

  for (int i = tid; i < N * C / 2; i += nthr) {
    const int r = (2 * i) / C, c = (2 * i) % C;
    const float2 v = tile::ld2<T>(x + (size_t)r * C + c);
    tile::st2<float>(X + r * ldx + c, v.x, v.y);
  }
  // zero the padded rows of the two product operands
  for (int i = tid; i < (kTile - N) * C; i += nthr) A[(N + i / C) * lda + i % C] = tile::from_f<T>(0.f);
  for (int i = tid; i < (kTile - N) * HD; i += nthr) O[(N + i / HD) * ldo + i % HD] = tile::from_f<T>(0.f);
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
    A[r * lda + c] = tile::from_f<T>((X[r * ldx + c] - stat[r]) * stat[kMaxN + r] * a.g[c]);
  }
  __syncthreads();

  // q | k | v = LN(x) @ W_qkv
  block_mm<T>(A, lda, a.Wqkv, C, Q3, N, [&](int r, int c, float v0, float v1) {
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
  // o = P @ v, per head, rounded for the output projection
  for (int i = tid; i < N * HD; i += nthr) {
    const int r = i / HD, c = i % HD, h = c / D;
    const float* p = P + (h * kMaxN + r) * ldp;
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(p[j], Q[j * ldq + 2 * HD + c], s);
    O[r * ldo + c] = tile::from_f<T>(s);
  }
  __syncthreads();

  // out = x + (o @ W_out + b_out)
  block_mm<T>(O, ldo, a.Wout, HD, C, N, [&](int r, int c, float v0, float v1) {
    const float2 xv = *reinterpret_cast<const float2*>(X + r * ldx + c);
    tile::st2<T>(out + (size_t)r * C + c, xv.x + (v0 + a.bout[c]), xv.y + (v1 + a.bout[c + 1]));
  });
}

template <typename T>
size_t smem_bytes(const Args& a) {
  constexpr int kTile = Tile<T>::kRows;
  const int HD = a.heads * a.dh;
  return tile::align16((size_t)kMaxN * (a.C + 4) * sizeof(float)) +
         tile::align16((size_t)kTile * (a.C + kPad) * sizeof(T)) +
         tile::align16((size_t)kMaxN * (3 * HD + 4) * sizeof(float)) +
         tile::align16((size_t)a.heads * kMaxN * (kMaxN + 1) * sizeof(float)) +
         tile::align16((size_t)kTile * (HD + kPad) * sizeof(T)) + 2 * kMaxN * sizeof(float);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  if (smem > 232448) return -1;
  cudaError_t err = cudaFuncSetAttribute(set_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  set_attention_kernel<T><<<a.B, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int set_attention_max_n() { return kMaxN; }

// dtype: 0 float32, 1 bfloat16 (weights packed by pack_mma_weights).
// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take.
int set_attention_launch(int dtype, const void* x, const float* g, const void* Wqkv,
                         const void* Wout, const float* bout, void* out, int B, int N, int C,
                         int heads, int dh, float eps, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || C < 16 || C % 16 != 0 || heads < 1 || dh < 1 ||
      (heads * dh) % 16 != 0)
    return -1;
  Args a;
  a.x = x;
  a.g = g;
  a.Wqkv = Wqkv;
  a.Wout = Wout;
  a.bout = bout;
  a.out = out;
  a.B = B;
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.dh = dh;
  a.eps = eps;
  a.scale = (float)pow((double)dh, -0.5);  // dim_head ** -0.5, as the twin
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<bf16>(a, s);
  return -1;
}

}  // extern "C"
