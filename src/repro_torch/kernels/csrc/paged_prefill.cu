// Paged chunked-prefill attention over block tables, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_prefill.py :: paged_prefill (Pallas body
// _paged_prefill_kernel), reached through
// repro.kernels.ops.paged_prefill_attention.
//
// What bounds it on the H100: a (B, C) chunk of queries attends its rows'
// whole history; with the query chunk folded to C*G rows per KV head, each
// K/V page read once feeds 4 * C * G * D flops per position against 4 * D
// bytes, i.e. C * G flops per byte.  At the engine's default chunk (C = 16,
// G = 7: 112 flop/byte) that is below the H100's ~295 flop/byte bf16 ridge,
// so the bytes of K/V bound it; at C = 64 (448 flop/byte) the flops do.  This
// simple version runs the flops in f32 on CUDA cores and re-reads each page
// once per row tile, so it sits far above either bound.
//
// Design: one thread block per (batch row b, KV head h, tile of R query
// rows).  Query rows are the chunk-folded rows r = c * G + g of q
// (B, KV, C*G, D), so all G heads of a KV group share one page read.  The
// Pallas grid's sequential page axis with (m, l, acc) in VMEM scratch becomes
// a loop over pages inside the block, with per-row m, l and acc in shared
// memory in f32.  The loop runs from the window's first page (bounded by the
// oldest query, position start) to the page holding the newest query
// (start + q_len - 1); rows are masked causally with c = r / G, rows with
// c >= q_len are padding, and a fully masked row keeps p = 0 and writes
// zeros.  A row of the batch with q_len == 0 reads no page at all.  Table
// entries are clamped to [0, NP - 1] and every position past the causal
// bound is masked, so trash or garbage entries never contribute.
//
// Simple first: f32 FMA on CUDA cores, no tensor cores, no cp.async or TMA,
// each page re-read once per row tile.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;
constexpr int ROWS = 16;                 // query rows per thread block

__global__ void paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, KV, CG, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (NP, page, KV, D)
    const __nv_bfloat16* __restrict__ v_pages,  // (NP, page, KV, D)
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ start_pos,          // (B,)
    const int* __restrict__ q_lens,             // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, KV, CG, D)
    int KV, int CG, int G, int D, int NP, int page, int pps,
    float scale, int window, float softcap) {
  extern __shared__ float smem[];
  const int Dk = D + 1;                  // padded K row: no bank conflicts
  float* q_s = smem;                     // ROWS * D
  float* k_s = q_s + ROWS * D;           // page * Dk
  float* v_s = k_s + page * Dk;          // page * D
  float* s_s = v_s + page * D;           // ROWS * page
  float* acc_s = s_s + ROWS * page;      // ROWS * D
  float* m_s = acc_s + ROWS * D;         // ROWS
  float* l_s = m_s + ROWS;               // ROWS
  float* a_s = l_s + ROWS;               // ROWS

  const int bh = blockIdx.x;
  const int b = bh / KV;
  const int h = bh % KV;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, CG - row0);
  const int tid = threadIdx.x;
  const int RD = nrows * D;

  const size_t qoff = ((size_t)bh * CG + row0) * D;
  for (int i = tid; i < RD; i += THREADS) {
    q_s[i] = __bfloat162float(q[qoff + i]);
    acc_s[i] = 0.0f;
  }
  for (int r = tid; r < nrows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  const int start = start_pos[b];
  const int q_len = q_lens[b];
  int first = 0;
  if (window > 0) {
    const int lo = start - (window - 1);
    first = lo > 0 ? lo / page : 0;
  }
  int last = q_len > 0 ? (start + q_len - 1) / page : -1;
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
    for (int i = tid; i < nrows * page; i += THREADS) {
      const int r = i / page, t = i % page;
      const float* qr = q_s + r * D;
      const float* kr = k_s + t * Dk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      const int c = (row0 + r) / G;      // row c*G+g is query token c
      const int qpos = start + c;
      const int kpos = k_start + t;
      bool ok = kpos <= qpos && c < q_len;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s_s[i] = ok ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < nrows; r += THREADS) {
      float* sr = s_s + r * page;
      const float m_prev = m_s[r];
      float m_cur = NEG_INF;
      for (int t = 0; t < page; ++t) m_cur = fmaxf(m_cur, sr[t]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.0f;
      for (int t = 0; t < page; ++t) {
        // a fully masked (padding) row keeps p = 0, not exp(0) = 1
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

    for (int i = tid; i < RD; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = s_s + r * page;
      float o = 0.0f;
      for (int t = 0; t < page; ++t) o = fmaf(pr[t], v_s[t * D + d], o);
      acc_s[i] = acc_s[i] * a_s[r] + o;
    }
    __syncthreads();
  }

  for (int i = tid; i < RD; i += THREADS) {
    const float l = l_s[i / D];
    out[qoff + i] = __float2bfloat16(l == 0.0f ? 0.0f : acc_s[i] / l);
  }
}

}  // namespace

extern "C" int paged_prefill_smem_bytes(int D, int page) {
  return (int)sizeof(float) *
         (2 * ROWS * D + page * (D + 1) + page * D + ROWS * page + 3 * ROWS);
}

extern "C" int paged_prefill_rows_per_block() { return ROWS; }

extern "C" int paged_prefill_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start_pos, const void* q_lens,
    void* out, int B, int KV, int CG, int G, int D, int NP, int page,
    int pps, float scale, int window, float softcap, void* stream) {
  const int smem = paged_prefill_smem_bytes(D, page);
  static int smem_opted = 48 * 1024;
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const int tiles = (CG + ROWS - 1) / ROWS;
  if (B * KV > 0 && tiles > 0) {
    dim3 grid(B * KV, tiles);
    paged_prefill_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int*)tables,
        (const int*)start_pos, (const int*)q_lens, (__nv_bfloat16*)out, KV,
        CG, G, D, NP, page, pps, scale, window, softcap);
  }
  return (int)cudaGetLastError();
}
