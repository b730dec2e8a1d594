// Dense flash-attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
// body _flash_kernel), reached through repro.kernels.ops.mha_flash_attention.
//
// What bounds it on the H100: causal attention over S positions does
// 4 * S * (S + 1) / 2 * D flops per head against 2 bytes per element of q,
// k, v and out, i.e. ~S / 2 flops per byte at bf16: at the training shapes
// (S = 1024) that is ~500 flop/byte, above the H100's ~295 flop/byte bf16
// ridge, so the flops bound it (989 TFLOP/s on the tensor cores).  This
// simple version runs the flops in f32 on the CUDA cores (67 TFLOP/s peak),
// so it sits at least ~15x above that bound.
//
// Design: one thread block per (b * H + h, tile of BQ = 64 query rows); the
// Pallas grid's sequential kv axis with (m, l, acc) in VMEM scratch becomes
// a loop over kv tiles of BK rows inside the block.  256 threads form a
// 16 x 16 grid: thread (tx, ty) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j of each kv tile, and output columns 2 tx + 32 j (float2
// pairs) of D.  Its m, l and acc stay in registers in f32; a row's m and l
// are reduced over the 16 threads of a half-warp with shuffles.  Q stays in
// shared memory for the whole loop; each kv tile's K and V are staged in
// shared memory once and read by all 64 rows; P goes through shared memory
// from the score layout to the P.V layout.  Rows are padded by 4 floats so
// the float4 reads of 16 different K rows fall in different banks.
//
// GQA: q is (B, Sq, H, D) and k, v are (B, Skv, KV, D), un-broadcast; head
// h reads kv head h / (H / KV), so K/V are never materialised per query
// head.  Masks as in the Pallas kernel: kpos < Skv, causal (top-left)
// kpos <= qpos, window qpos - kpos < window; the softcap c * tanh(s / c) is
// applied before the mask.  Tiles that no row of the block can reach under
// the causal and window bounds are skipped.  A row with no valid key keeps
// p = 0 and writes zeros.  A second output, the per-row logsumexp m + log l
// (B, H, Sq) f32 (-inf for a row with no valid key), feeds the backward.
//
// Tiles by head dim: D <= 64 takes BK = 64 (69 KB of shared memory at
// D = 64); 64 < D <= 288 takes BK = 32 (158 KB at D = 288, gemma2-2b), both
// opted in above 48 KB.  D must be a multiple of 32.
//
// Simple first: f32 FMA on CUDA cores, no tensor cores, no cp.async or TMA,
// no double buffering.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 256;           // 16 x 16
constexpr int BQ = 64;                 // query rows per block
constexpr int RM = BQ / 16;            // rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int smem_floats(int BK, int D) {
  return BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4);
}

// MAXDJ: the most float2 column pairs per thread (D / 32) this
// instantiation holds in registers; the launch picks one with D / 32 <= it.
template <typename T, int BK, int MAXDJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q,        // (B, Sq, H, D)
    const T* __restrict__ k,        // (B, Skv, KV, D)
    const T* __restrict__ v,        // (B, Skv, KV, D)
    T* __restrict__ out,            // (B, Sq, H, D)
    float* __restrict__ lse,        // (B, H, Sq)
    int H, int KV, int Sq, int Skv, int D, float scale, int causal,
    int window, float softcap) {
  constexpr int CN = BK / 16;           // score columns per thread
  constexpr int PP = BK + 4;            // padded P row
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 4;                 // padded Q / K row
  float* q_s = smem;                    // BQ x DP
  float* k_s = q_s + BQ * DP;           // BK x DP
  float* v_s = k_s + BK * DP;           // BK x D
  float* p_s = v_s + BK * D;            // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int dj = D >> 5;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qr = q0 + r;
    q_s[r * DP + d] =
        qr < Sq ? to_f32(q[(((size_t)b * Sq + qr) * H + h) * D + d]) : 0.0f;
  }

  float acc[RM][2 * MAXDJ];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * MAXDJ; ++c) acc[i][c] = 0.0f;
  }

  int kt_lo = 0;
  int kt_hi = (Skv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1) / BK + 1);
  if (window > 0) {
    const int lo = q0 - (window - 1);   // oldest row's window start
    if (lo > 0) kt_lo = lo / BK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // last tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      const int kr = k0 + t;
      float kk = 0.0f, vv = 0.0f;       // rows past Skv: zeros, masked
      if (kr < Skv) {
        const size_t off = (((size_t)b * Skv + kr) * KV + kvh) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[t * DP + d] = kk;
      v_s[t * D + d] = vv;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        // a row with no valid key yet keeps p = 0, not exp(0) = 1
        const float p = m_new == NEG_INF ? 0.0f : expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = m_i[i] == NEG_INF ? 0.0f : expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * MAXDJ; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < CN; ++j)
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * PP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_s + (kk + e) * D + 2 * tx;
#pragma unroll
        for (int j = 0; j < MAXDJ; ++j) {
          if (j < dj) {
            const float2 w = *reinterpret_cast<const float2*>(vr + 32 * j);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float p = e == 0 ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z : pv[i].w;
              acc[i][2 * j] = fmaf(p, w.x, acc[i][2 * j]);
              acc[i][2 * j + 1] = fmaf(p, w.y, acc[i][2 * j + 1]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = l_i[i];
    T* o = out + (((size_t)b * Sq + row) * H + h) * D + 2 * tx;
#pragma unroll
    for (int j = 0; j < MAXDJ; ++j) {
      if (j < dj) {
        o[32 * j] = from_f32<T>(l == 0.0f ? 0.0f : acc[i][2 * j] / l);
        o[32 * j + 1] = from_f32<T>(l == 0.0f ? 0.0f : acc[i][2 * j + 1] / l);
      }
    }
    if (tx == 0)
      lse[(size_t)bh * Sq + row] = l == 0.0f ? -INFINITY : m_i[i] + logf(l);
  }
}

template <typename T, int BK, int MAXDJ>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int KV, int Sq, int Skv, int D, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, BK, MAXDJ>;
  const int smem = (int)sizeof(float) * smem_floats(BK, D);
  static int smem_opted = 48 * 1024;    // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const int q_tiles = (Sq + BQ - 1) / BQ;
  if (B * H > 0 && q_tiles > 0) {
    dim3 grid(B * H, q_tiles);
    kernel<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, H, KV,
        Sq, Skv, D, scale, causal, window, softcap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block uses at head dim D.
extern "C" int flash_attention_smem_bytes(int D) {
  return (int)sizeof(float) * (D <= 64 ? smem_floats(64, D)
                                       : smem_floats(32, D));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take (D not a multiple of 32 or above 288, H not a
// multiple of KV).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int H, int KV, int Sq, int Skv, int D, float scale,
    int causal, int window, float softcap, void* stream) {
  if (D <= 0 || D % 32 != 0 || D > 288 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (D <= 64)
      return launch<__nv_bfloat16, 64, 2>(q, k, v, out, lse, B, H, KV, Sq,
                                          Skv, D, scale, causal, window,
                                          softcap, s);
    return launch<__nv_bfloat16, 32, 9>(q, k, v, out, lse, B, H, KV, Sq, Skv,
                                        D, scale, causal, window, softcap, s);
  }
  if (D <= 64)
    return launch<float, 64, 2>(q, k, v, out, lse, B, H, KV, Sq, Skv, D,
                                scale, causal, window, softcap, s);
  return launch<float, 32, 9>(q, k, v, out, lse, B, H, KV, Sq, Skv, D, scale,
                              causal, window, softcap, s);
}
