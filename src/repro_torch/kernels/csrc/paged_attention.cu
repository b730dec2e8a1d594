// Paged single-token decode attention over block tables, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py :: paged_attention (Pallas
// body _paged_kernel), reached through repro.kernels.ops.paged_decode_attention.
//
// What bounds it on the H100: bytes.  One decode step reads, per sequence
// and KV head, every reachable K and V page once (2 * length * D bf16 values)
// and does 4 * G * D flops per position, about G flops per byte (G = 7 for
// qwen2-0.5b), far below the ~295 flop/byte at which the tensor cores
// would bound it.  So the only lever is moving each K/V byte exactly once.
//
// Design: one thread block per (batch row b, KV head h).  The block loads the
// G query heads of its KV group into shared memory once, then walks only the
// reachable pages of row b in order (from the sliding window's first page to
// ceil(length / page) - 1), so each K/V page is read from device memory once
// per KV head and shared by all G query heads, as on the TPU.  The Pallas
// grid's sequential page axis with (m, l, acc) in VMEM scratch becomes this
// loop inside one block, with m, l and acc in shared memory in f32: blocks
// run in no order on the GPU and carry nothing between them.  Table entries
// are clamped to [0, NP - 1]; positions past `length` or outside the window
// are masked to NEG_INF, so a garbage or trash-block entry never contributes.
// Rows with length 0 read no page and write zeros.
//
// Simple first: plain f32 FMA on CUDA cores, no tensor cores, no cp.async or
// TMA, no split over the context.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;

__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, KV, G, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (NP, page, KV, D)
    const __nv_bfloat16* __restrict__ v_pages,  // (NP, page, KV, D)
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ lengths,            // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, KV, G, D)
    int KV, int G, int D, int NP, int page, int pps,
    float scale, int window, float softcap) {
  extern __shared__ float smem[];
  const int Dk = D + 1;                  // padded K row: no bank conflicts
  float* q_s = smem;                     // G * D
  float* k_s = q_s + G * D;              // page * Dk
  float* v_s = k_s + page * Dk;          // page * D
  float* s_s = v_s + page * D;           // G * page
  float* acc_s = s_s + G * page;         // G * D
  float* m_s = acc_s + G * D;            // G
  float* l_s = m_s + G;                  // G
  float* a_s = l_s + G;                  // G (rescale factor of this page)

  const int bh = blockIdx.x;
  const int b = bh / KV;
  const int h = bh % KV;
  const int tid = threadIdx.x;
  const int GD = G * D;

  const __nv_bfloat16* qb = q + (size_t)bh * GD;
  for (int i = tid; i < GD; i += THREADS) {
    q_s[i] = __bfloat162float(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.0f;
  }

  const int length = lengths[b];
  const int q_pos = length - 1;
  int first = 0;
  if (window > 0) {
    const int lo = q_pos - (window - 1);
    first = lo > 0 ? lo / page : 0;
  }
  int last = length > 0 ? (length - 1) / page : -1;
  if (last > pps - 1) last = pps - 1;
  __syncthreads();

  for (int p = first; p <= last; ++p) {
    int blk = tables[(size_t)b * pps + p];
    blk = blk < 0 ? 0 : (blk > NP - 1 ? NP - 1 : blk);
    const size_t base = ((size_t)blk * page * KV + h) * D;  // (blk, 0, h, 0)
    const size_t tstride = (size_t)KV * D;
    for (int i = tid; i < page * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const size_t off = base + t * tstride + d;
      k_s[t * Dk + d] = __bfloat162float(k_pages[off]);
      v_s[t * D + d] = __bfloat162float(v_pages[off]);
    }
    __syncthreads();

    const int k_start = p * page;
    for (int i = tid; i < G * page; i += THREADS) {
      const int g = i / page, t = i % page;
      const float* qr = q_s + g * D;
      const float* kr = k_s + t * Dk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      const int kpos = k_start + t;
      bool ok = kpos < length;
      if (window > 0) ok = ok && (q_pos - kpos) < window;
      s_s[i] = ok ? s : NEG_INF;
    }
    __syncthreads();

    for (int g = tid; g < G; g += THREADS) {
      float* sr = s_s + g * page;
      const float m_prev = m_s[g];
      float m_cur = NEG_INF;
      for (int t = 0; t < page; ++t) m_cur = fmaxf(m_cur, sr[t]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.0f;
      for (int t = 0; t < page; ++t) {
        // a fully masked row keeps p = 0 rather than exp(0) = 1
        const float pv = m_new == NEG_INF ? 0.0f : expf(sr[t] - m_new);
        sr[t] = pv;
        sum += pv;
      }
      const float alpha = m_prev == NEG_INF ? 0.0f : expf(m_prev - m_new);
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < GD; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pr = s_s + g * page;
      float o = 0.0f;
      for (int t = 0; t < page; ++t) o = fmaf(pr[t], v_s[t * D + d], o);
      acc_s[i] = acc_s[i] * a_s[g] + o;
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + (size_t)bh * GD;
  for (int i = tid; i < GD; i += THREADS) {
    const float l = l_s[i / D];
    ob[i] = __float2bfloat16(l == 0.0f ? 0.0f : acc_s[i] / l);
  }
}

}  // namespace

extern "C" int paged_decode_smem_bytes(int G, int D, int page) {
  return (int)sizeof(float) *
         (2 * G * D + page * (D + 1) + page * D + G * page + 3 * G);
}

extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out,
    int B, int KV, int G, int D, int NP, int page, int pps,
    float scale, int window, float softcap, void* stream) {
  const int smem = paged_decode_smem_bytes(G, D, page);
  static int smem_opted = 48 * 1024;
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  if (B * KV > 0) {
    paged_decode_kernel<<<B * KV, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int*)tables,
        (const int*)lengths, (__nv_bfloat16*)out, KV, G, D, NP, page, pps,
        scale, window, softcap);
  }
  return (int)cudaGetLastError();
}
