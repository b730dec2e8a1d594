// Attention over an int8 K/V cache with per-token scales, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_int8kv
// (Pallas body _flash_kernel_int8kv).  The reference's model path computes
// the same attention in jnp (models/attention.py, the int8 branch of the
// dense decode cache); the port's dense-cache decode calls this kernel
// through repro_torch.kernels.ops.int8kv_attention.
//
// What bounds it on the H100: at the serving path's decode shapes (one
// query per row, G = 7 query heads per kv head, D = 64) each key costs
// 2 * D bytes of int8 K/V plus 4 bytes of bf16 scales per kv head and
// feeds 4 * G * D flops, ~13 flops per byte, far below the ~295 flop/byte
// bf16 ridge: the bytes of the cache bound it, half what a bf16 cache
// would move.  This simple version runs the flops in f32 on CUDA cores
// and gives each (row, kv head) one thread block, so at B = 8, KV = 2 it
// fills 16 of the 132 SMs and sits far above that bound.
//
// Design: one thread block per (batch row b, kv head h, tile of ROWS
// folded query rows).  Row r = i * G + g of the tile is query token i for
// query head h * G + g, so all G heads of a kv group share one K/V tile
// read, straight from the un-broadcast (B, Skv, KV, D) layout (no repeat
// per head, no dequantized copy in device memory).  The Pallas grid's
// sequential kv axis with (m, l, acc) in VMEM scratch becomes a loop over
// BK-key tiles inside the block, with per-row m, l and acc in shared
// memory in f32.  Each tile's int8 codes are loaded four at a time,
// multiplied by their token's scale and staged in shared memory as f32:
// K rounded to q's dtype first, V not, which is what the reference's
// jitted bf16 decode reads (with f32 q both are the TPU kernel's f32
// products).
//
// Per-row positions, which the TPU kernel's scalar seq_k and top-left mask
// cannot express: query i of row b sits at q_start[b] + i, and keys at or
// past kv_len[b] (clamped to Skv) are masked, so the serving decode passes
// q_start = position, kv_len = position + 1, and q_start = 0, kv_len = Skv
// is the TPU kernel's function.  Masks: causal kpos <= qpos, window
// qpos - kpos < window; the softcap c * tanh(s / c) is applied before the
// mask.  Only tiles between the window's first key and the last key any
// row of the block can see are visited; the lengths are read on the
// device, so the host never waits for them.  A row with no valid key
// keeps p = 0 and writes zeros.
//
// Tiles: BK = 64 keys for D <= 128, 32 above (113 KB of shared memory at
// gemma2-2b's D = 288); D must be a multiple of 4 and at most 288.
//
// Simple first: f32 FMA on CUDA cores, no tensor cores, no cp.async or
// TMA, no split over the key axis.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;
constexpr int ROWS = 16;                 // folded query rows per block

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

int smem_bytes(int D, int BK) {
  return (int)sizeof(float) *
         (2 * ROWS * D + BK * (D + 1) + BK * D + ROWS * BK + 3 * ROWS);
}

// T: the dtype of q, of both scales and of out (f32 or bf16)
template <typename T>
__global__ void __launch_bounds__(THREADS) int8kv_attention_kernel(
    const T* __restrict__ q,               // (B, Sq, H, D)
    const signed char* __restrict__ k8,    // (B, Skv, KV, D)
    const T* __restrict__ k_scale,         // (B, Skv, KV)
    const signed char* __restrict__ v8,    // (B, Skv, KV, D)
    const T* __restrict__ v_scale,         // (B, Skv, KV)
    const int* __restrict__ q_start,       // (B,)
    const int* __restrict__ kv_len,        // (B,)
    T* __restrict__ out,                   // (B, Sq, H, D)
    int Sq, int H, int KV, int Skv, int D, int BK, float scale, int causal,
    int window, float softcap) {
  extern __shared__ float smem[];
  const int Dk = D + 1;                  // padded K row: no bank conflicts
  float* q_s = smem;                     // ROWS * D
  float* k_s = q_s + ROWS * D;           // BK * Dk
  float* v_s = k_s + BK * Dk;            // BK * D
  float* s_s = v_s + BK * D;             // ROWS * BK
  float* acc_s = s_s + ROWS * BK;        // ROWS * D
  float* m_s = acc_s + ROWS * D;         // ROWS
  float* l_s = m_s + ROWS;               // ROWS
  float* a_s = l_s + ROWS;               // ROWS

  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, Sq * G - row0);
  const int tid = threadIdx.x;
  const int RD = nrows * D;

  // folded row r = i * G + g  <->  q[b, i, h * G + g, :]
  for (int e = tid; e < RD; e += THREADS) {
    const int r = e / D, d = e % D;
    const int fr = row0 + r;
    const int i = fr / G, g = fr % G;
    q_s[e] = to_f32(q[(((size_t)b * Sq + i) * H + h * G + g) * D + d]);
    acc_s[e] = 0.0f;
  }
  for (int r = tid; r < nrows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  const int qs = q_start[b];
  const int qpos_lo = qs + row0 / G;
  const int qpos_hi = qs + (row0 + nrows - 1) / G;
  int hi = min(kv_len[b], Skv);          // keys [lo, hi) can be visible
  if (causal) hi = min(hi, qpos_hi + 1);
  int lo = 0;
  if (window > 0) lo = max(0, qpos_lo - (window - 1));
  __syncthreads();

  const int D4 = D >> 2;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int nk = min(BK, hi - k0);
    for (int e = tid; e < BK * D4; e += THREADS) {
      const int t = e / D4, c = (e % D4) * 4;
      float kv_k[4] = {0.f, 0.f, 0.f, 0.f}, kv_v[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < nk) {
        const size_t tok = ((size_t)b * Skv + k0 + t) * KV + h;
        const char4 kc = *reinterpret_cast<const char4*>(k8 + tok * D + c);
        const char4 vc = *reinterpret_cast<const char4*>(v8 + tok * D + c);
        const float ks = to_f32(k_scale[tok]);
        const float vs = to_f32(v_scale[tok]);
        kv_k[0] = to_f32(from_f32<T>((float)kc.x * ks));
        kv_k[1] = to_f32(from_f32<T>((float)kc.y * ks));
        kv_k[2] = to_f32(from_f32<T>((float)kc.z * ks));
        kv_k[3] = to_f32(from_f32<T>((float)kc.w * ks));
        kv_v[0] = (float)vc.x * vs;
        kv_v[1] = (float)vc.y * vs;
        kv_v[2] = (float)vc.z * vs;
        kv_v[3] = (float)vc.w * vs;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k_s[t * Dk + c + j] = kv_k[j];
        v_s[t * D + c + j] = kv_v[j];
      }
    }
    __syncthreads();

    for (int e = tid; e < nrows * BK; e += THREADS) {
      const int r = e / BK, t = e % BK;
      const float* qr = q_s + r * D;
      const float* kr = k_s + t * Dk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      const int qpos = qs + (row0 + r) / G;
      const int kpos = k0 + t;
      bool ok = t < nk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s_s[e] = ok ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < nrows; r += THREADS) {
      float* sr = s_s + r * BK;
      const float m_prev = m_s[r];
      float m_cur = NEG_INF;
      for (int t = 0; t < BK; ++t) m_cur = fmaxf(m_cur, sr[t]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.0f;
      for (int t = 0; t < BK; ++t) {
        // a row with no valid key yet keeps p = 0, not exp(0) = 1
        const float pv = m_new == NEG_INF ? 0.0f : expf(sr[t] - m_new);
        sr[t] = pv;
        sum += pv;
      }
      const float alpha = m_prev == NEG_INF ? 0.0f : expf(m_prev - m_new);
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < RD; e += THREADS) {
      const int r = e / D, d = e % D;
      const float* pr = s_s + r * BK;
      float o = 0.0f;
      for (int t = 0; t < nk; ++t) o = fmaf(pr[t], v_s[t * D + d], o);
      acc_s[e] = acc_s[e] * a_s[r] + o;
    }
    __syncthreads();
  }

  for (int e = tid; e < RD; e += THREADS) {
    const int r = e / D, d = e % D;
    const int fr = row0 + r;
    const int i = fr / G, g = fr % G;
    const float l = l_s[r];
    out[(((size_t)b * Sq + i) * H + h * G + g) * D + d] =
        from_f32<T>(l == 0.0f ? 0.0f : acc_s[e] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k8, const void* ks, const void* v8,
           const void* vs, const void* q_start, const void* kv_len,
           void* out, int B, int Sq, int H, int KV, int Skv, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const int BK = D <= 128 ? 64 : 32;
  const int smem = smem_bytes(D, BK);
  static int smem_opted = 48 * 1024;     // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        int8kv_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const int tiles = (Sq * (H / KV) + ROWS - 1) / ROWS;
  if (B * KV > 0 && tiles > 0) {
    dim3 grid(B * KV, tiles);
    int8kv_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const signed char*)k8, (const T*)ks,
        (const signed char*)v8, (const T*)vs, (const int*)q_start,
        (const int*)kv_len, (T*)out, Sq, H, KV, Skv, D, BK, scale, causal,
        window, softcap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by q, both scales and out.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_int8kv_fwd(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* q_start, const void* kv_len, void* out,
    int dtype, int B, int Sq, int H, int KV, int Skv, int D,
    float scale, int causal, int window, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define INT8KV_ARGS q, k8, k_scale, v8, v_scale, q_start, kv_len, out, B, Sq, \
    H, KV, Skv, D, scale, causal, window, softcap, st
  if (dtype == 0) return launch<float>(INT8KV_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(INT8KV_ARGS);
#undef INT8KV_ARGS
  return (int)cudaErrorInvalidValue;
}
