// Paged chunked-prefill attention over block tables, for Hopper (sm_90a): a
// tensor-core kernel split over the context (bf16 with D in {32, 64, 96,
// 128, 288}) with the shared combine step, and a CUDA-core kernel for f32
// and the other head dims.
//
// Replaces: src/repro/kernels/paged_prefill.py :: paged_prefill (Pallas body
// _paged_prefill_kernel), reached through
// repro.kernels.ops.paged_prefill_attention.
//
// What bounds it on the H100: a (B, C) chunk of queries attends its rows'
// whole history; with the query chunk folded to C*G rows per KV head, each
// K/V page read once feeds 4 * C * G * D flops per position against 4 * D
// bytes, i.e. C * G flops per byte.  At the engine's default chunk (C = 16,
// G = 7: 112 flop/byte) that is near the H100's ~295 flop/byte bf16 ridge,
// at C = 64 (448 flop/byte) above it: the kernel belongs on tensor cores,
// reading each page once.
//
// Tensor-core kernel (paged_prefill_tc_kernel<D, MT>), grid (splits x row
// tiles, KV, B), 4 warps.  A block holds 64 MT folded query rows (row
// r = c * G + g of q (B, KV, C*G, D): query token c for head g of the kv
// group; MT = 2 for D <= 64), so the 112 rows of a C = 16, G = 7 chunk are
// one row tile and all G heads share every page read.  At gemma2-2b's C =
// 16, G = 2 a chunk folds to 32 rows: the upper two warps of the 64-row tile
// hold only padding and skip the products (they still load and meet the
// barriers), so the tile costs the two live warps' work.  The host cuts each
// row's key axis (the table's pps * page positions) into `splits` ranges of
// `keys_per_split` keys, a multiple of 64, from shapes only (never
// start_pos or q_lens, which live on the card), so that the grid covers the
// SMs.  A block clips its range to the keys its valid rows can see: from
// the window's first key of its oldest query to its newest query (c <
// q_len); a block with no valid row or an empty range writes neutral
// partials (m = -1e30, l = 0) and exits.  It walks its range in 64-key
// tiles (four 16-token pages), each staged through the block table with
// 16-byte cp.async into a two-stage bf16 ring in shared memory (tile n + 1
// in flight while tile n is multiplied, one barrier a tile; each page read
// once per block; table entries clamped to [0, NP - 1]).  At D = 288 the
// tiles are 32 keys (two pages) and Q's fragments are re-read from the
// staged Q tile at every k-step, as in the flash kernel (tc_attention.cuh:
// no spill, 113,664 bytes of shared memory, two blocks an SM).  S = Q K^T,
// the online softmax and O += P V are tc_attention.cuh's, shared with the
// flash forward: mma.sync.m16n8k16 in bf16 with f32 accumulators, P rounded to
// bf16 for the PV product (as the flash kernel and SDPA), l summing the
// unrounded f32 P.  Masks only on tiles that cross a boundary: causal from
// start_pos + c, the window, and keys past the table (the softcap comes
// before the mask).  The block writes its rows' partial (m, l, acc)
// unnormalised in f32; padding rows (c >= q_len) write neutral partials.
// split_combine::combine_kernel (split_combine.cuh) then merges the
// partials of each row into the bf16 output; a row with none (padding, or a
// q_len = 0 batch row) writes zeros.  Shared memory (64 MT + 4 KT) *
// (D + 8) * 2 bytes, 55,296 at D = 64, 113,664 at D = 288.
//
// CUDA-core kernel (paged_prefill_kernel), for f32 and the other head dims:
// one thread block per (batch row b, KV head h, tile of 16 folded
// query rows), walking the row's reachable pages through the block table
// with an online softmax in f32 (f32 FMA, P in f32), per-row m, l and acc in
// shared memory.  The loop runs from the window's first page (bounded by the
// oldest query, position start) to the page holding the newest query
// (start + q_len - 1); rows are masked causally with c = r / G, rows with
// c >= q_len are padding, and a fully masked row keeps p = 0 and writes
// zeros.  A row of the batch with q_len == 0 reads no page at all.  It
// re-reads each page once per row tile.  It is instantiated on the element
// type of q, the pages and the output: bf16 (paged_prefill_bf16) and f32
// (paged_prefill_f32, every head dim; the tensor-core kernel is bf16 only).
// Everything past the loads is f32 either way, so the f32 instantiation
// differs only in what it reads and writes.
//
// Both kernels clamp table entries to [0, NP - 1] and mask every position
// past the causal bound, so trash or garbage entries never contribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_combine.cuh"
#include "tc_attention.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;
constexpr int ROWS = 16;                 // query rows per thread block

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

template <typename T>
__global__ void paged_prefill_kernel(
    const T* __restrict__ q,                    // (B, KV, CG, D)
    const T* __restrict__ k_pages,              // (NP, page, KV, D)
    const T* __restrict__ v_pages,              // (NP, page, KV, D)
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ start_pos,          // (B,)
    const int* __restrict__ q_lens,             // (B,)
    T* __restrict__ out,                        // (B, KV, CG, D)
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
    q_s[i] = to_f(q[qoff + i]);
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
      k_s[t * Dk + d] = to_f(k_pages[off]);
      v_s[t * D + d] = to_f(v_pages[off]);
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
    put(out + qoff + i, l == 0.0f ? 0.0f : acc_s[i] / l);
  }
}


// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, D in {32, 64, 96, 128, 288}), split over the
// context
// ---------------------------------------------------------------------------
namespace tcp {

using tc_attn::THREADS;
using tc_attn::LN2;
using tc_attn::LOG2E;
using tc_attn::smem_bytes;

// keys [k0, k0 + KT) of kv head h of one row's pages, through its table,
// into a (KT, D + 8) bf16 tile; keys at or past k_end are zero-filled
template <int D, int KT>
__device__ __forceinline__ void load_page_tile(
    __nv_bfloat16* dst, const __nv_bfloat16* pages, const int* table,
    int k0, int k_end, int page, int NP, int KV, int h, int tid) {
  constexpr int CH = D / 8;            // 16-byte chunks per key row
  constexpr int DP = D + 8;
#pragma unroll
  for (int i = tid; i < KT * CH; i += THREADS) {
    const int t = i / CH, c = i - t * CH;
    const int pos = k0 + t;
    const bool ok = pos < k_end;
    const __nv_bfloat16* src = pages;
    if (ok) {
      const int pg = pos / page;
      int blk = table[pg];
      blk = blk < 0 ? 0 : (blk > NP - 1 ? NP - 1 : blk);
      src = pages + (((size_t)blk * page + (pos - pg * page)) * KV + h) * D +
            c * 8;
    }
    tc_attn::cp_async16(tc_attn::smem_u32(dst + t * DP + c * 8), src,
                        ok ? 16 : 0);
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(THREADS) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, KV, CG, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (NP, page, KV, D)
    const __nv_bfloat16* __restrict__ v_pages,  // (NP, page, KV, D)
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ start_pos,          // (B,)
    const int* __restrict__ q_lens,             // (B,)
    float* __restrict__ part_ml,                // (B, KV, splits, CG, 2)
    float* __restrict__ part_acc,               // (B, KV, splits, CG, D)
    int KV, int CG, int G, int NP, int page, int pps, int keys_per_split,
    int splits, float scale, int window, float softcap) {
  constexpr int BQ = 64 * MT;          // folded rows per block, 16 MT a warp
  constexpr int KT = tc_attn::key_tile(D);         // keys per tile
  constexpr bool QR = tc_attn::q_in_regs(D);
  constexpr int DP = D + 8;            // padded smem row (bf16 elements)
  constexpr int ND = D / 8;            // 8-wide column tiles of O
  constexpr int NK = KT / 8;           // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * DP;  // 2 stages of KT x DP
  __nv_bfloat16* v_s = k_s + 2 * KT * DP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sp = blockIdx.x % splits;
  const int row0 = (blockIdx.x / splits) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(BQ, CG - row0);
  const int start = start_pos[b], q_len = q_lens[b];
  const int T = pps * page;            // positions the table covers
  const size_t part = ((size_t)(b * KV + h) * splits + sp) * CG + row0;

  // the block's valid queries c_lo..c_hi (c < q_len) see keys from the
  // oldest one's window start to the newest one's position; clipped to the
  // table and to the split's range
  const int c_lo = row0 / G;
  const int c_hi = min((row0 + nrows - 1) / G, q_len - 1);
  int k_lo = 0, k_hi = 0;
  if (c_lo <= c_hi) {
    const int lo = window > 0 ? max(0, start + c_lo - (window - 1)) : 0;
    k_lo = max(lo, sp * keys_per_split);
    k_hi = min(min(start + c_hi + 1, T), sp * keys_per_split + keys_per_split);
  }
  if (k_lo >= k_hi) {                  // neutral partials
    for (int r = tid; r < nrows; r += THREADS) {
      part_ml[(part + r) * 2] = NEG_INF;
      part_ml[(part + r) * 2 + 1] = 0.0f;
    }
    return;
  }

  const int* table = tables + (size_t)b * pps;
  const int kt_lo = k_lo / KT, kt_hi = (k_hi + KT - 1) / KT;
  tc_attn::load_tile<D, BQ>(q_s, q, q + ((size_t)(b * KV + h) * CG + row0) * D,
                            nrows, D, tid);
  load_page_tile<D, KT>(k_s, k_pages, table, kt_lo * KT, k_hi, page, NP, KV,
                        h, tid);
  load_page_tile<D, KT>(v_s, v_pages, table, kt_lo * KT, k_hi, page, NP, KV,
                        h, tid);
  tc_attn::cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * MT;                 // the warp's first row
  // at D 288 a warp whose rows all lie past CG only helps load: gemma2-2b's
  // C = 16, G = 2 chunk folds to 32 rows, half of the 64-row tile (at D
  // <= 128 the models' chunks fill their tiles: 112 of 128 rows, 128 of
  // 128)
  const bool live = QR || wrow < nrows;
  // row c = row / G sees keys [qpos - window + 1, qpos], qpos = start + c,
  // and none past the table
  int qlo[MT][2], qhi[MT][2];
  float o[MT][ND][4];
  float m_r[MT][2], l_r[MT][2];                    // l_r: this thread's share
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = start + (row0 + wrow + mt * 16 + g + 8 * r) / G;
      qhi[mt][r] = min(qpos, T - 1);
      qlo[mt][r] = window > 0 ? qpos - window + 1 : 0;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.0f;
    m_r[mt][0] = m_r[mt][1] = NEG_INF;
    l_r[mt][0] = l_r[mt][1] = 0.0f;
  }
  // a tile needs masks where it reaches past the oldest valid query's
  // position (or the table's end), or before the newest one's window start
  const int min_hi = min(start + c_lo, T - 1);
  const int max_lo = window > 0 ? start + c_hi - window + 1 : 0;
  uint32_t qf[MT][QR ? D / 16 : 1][4];             // QR: Q's A fragments
  const float sl2 = softcap > 0.0f ? 1.0f : scale * LOG2E;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    tc_attn::cp_async_wait<0>();                 // tile kt (and Q) landed
    // one barrier a tile: it publishes tile kt and tells that every warp
    // is done with tile kt - 1, whose stage the prefetch below refills
    __syncthreads();
    if (kt + 1 < kt_hi) {                        // prefetch the next tile
      load_page_tile<D, KT>(k_s + (st ^ 1) * KT * DP, k_pages, table,
                            (kt + 1) * KT, k_hi, page, NP, KV, h, tid);
      load_page_tile<D, KT>(v_s + (st ^ 1) * KT * DP, v_pages, table,
                            (kt + 1) * KT, k_hi, page, NP, KV, h, tid);
    }
    tc_attn::cp_async_commit();
    if (!live) continue;

    float s[MT][NK][4];
    if constexpr (QR) {
      if (kt == kt_lo) tc_attn::load_q_frags<D, MT>(qf, q_s, wrow, lane);
    }
    tc_attn::qk_tile<D, MT, KT, QR>(s, qf, q_s, wrow, k_s + st * KT * DP,
                                    lane);

    const int k0 = kt * KT;
    const bool need_mask = k0 + KT - 1 > min_hi || k0 < max_lo;
    auto bounds = [&](int mt, int r, int& lo, int& hi) {
      lo = qlo[mt][r] - k0 - 2 * t;
      hi = qhi[mt][r] - k0 - 2 * t;
    };
    tc_attn::softmax_tile<D, MT, KT>(s, o, m_r, l_r, sl2, scale, softcap,
                                     need_mask, bounds);
    tc_attn::pv_tile<D, MT, KT>(o, s, v_s + st * KT * DP, lane);
  }
  tc_attn::cp_async_wait<0>();

  // the partials: (m in the natural units of the scaled score, l) and the
  // unnormalised acc; padding rows (c >= q_len) and rows that saw no key
  // write neutral ones
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = tc_attn::quad_sum(l_r[mt][r]);
      const int row = row0 + wrow + mt * 16 + g + 8 * r;
      if (row < CG) {
        const bool valid = row / G < q_len && l > 0.0f;
        const size_t pr = part + (row - row0);
        if (t == 0) {
          part_ml[pr * 2] = valid ? m_r[mt][r] * sl2 * LN2 : NEG_INF;
          part_ml[pr * 2 + 1] = valid ? l : 0.0f;
        }
        if (valid) {
#pragma unroll
          for (int jd = 0; jd < ND; ++jd)
            *reinterpret_cast<float2*>(part_acc + pr * D + jd * 8 + 2 * t) =
                make_float2(o[mt][jd][2 * r], o[mt][jd][2 * r + 1]);
        }
      }
    }
}

// MT = 2 row tiles a warp (128 folded rows a block) where the registers
// allow it (D <= 64), else 1
template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* start_pos, const void* q_lens,
           void* out, void* part_ml, void* part_acc, int B, int KV, int CG,
           int G, int NP, int page, int pps, int keys_per_split, int splits,
           float scale, int window, float softcap, cudaStream_t stream) {
  constexpr int MT = D <= 64 ? 2 : 1;
  constexpr int BQ = 64 * MT;
  auto kernel = paged_prefill_tc_kernel<D, MT>;
  constexpr int smem = smem_bytes(D, BQ);
  static int smem_opted = 48 * 1024;   // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const int tiles = (CG + BQ - 1) / BQ;
  if (B * KV * tiles == 0) return (int)cudaGetLastError();
  dim3 grid(splits * tiles, KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables,
      (const int*)start_pos, (const int*)q_lens, (float*)part_ml,
      (float*)part_acc, KV, CG, G, NP, page, pps, keys_per_split, splits,
      scale, window, softcap);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return split_combine::launch_combine(
      (const float*)part_ml, (const float*)part_acc, (__nv_bfloat16*)out, B,
      KV, CG, D, splits, 1, (long long)KV * CG * D, (long long)CG * D, D,
      stream);
}

}  // namespace tcp

}  // namespace

extern "C" int paged_prefill_smem_bytes(int D, int page) {
  return (int)sizeof(float) *
         (2 * ROWS * D + page * (D + 1) + page * D + ROWS * page + 3 * ROWS);
}

extern "C" int paged_prefill_rows_per_block() { return ROWS; }

namespace {

// The CUDA-core kernel on element type T (q, pages and out).
template <typename T>
int cuda_core_entry(const void* q, const void* k_pages, const void* v_pages,
                    const void* tables, const void* start_pos,
                    const void* q_lens, void* out, int B, int KV, int CG,
                    int G, int D, int NP, int page, int pps, float scale,
                    int window, float softcap, void* stream) {
  const int smem = paged_prefill_smem_bytes(D, page);
  static int smem_opted = 48 * 1024;     // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const int tiles = (CG + ROWS - 1) / ROWS;
  if (B * KV > 0 && tiles > 0) {
    dim3 grid(B * KV, tiles);
    paged_prefill_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)tables, (const int*)start_pos, (const int*)q_lens,
        (T*)out, KV, CG, G, D, NP, page, pps, scale, window, softcap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel: q (B, KV, CG, D), pages (NP, page, KV, D) and out
// bf16; tables (B, pps), start_pos and q_lens (B,) int32.
extern "C" int paged_prefill_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start_pos, const void* q_lens,
    void* out, int B, int KV, int CG, int G, int D, int NP, int page,
    int pps, float scale, int window, float softcap, void* stream) {
  return cuda_core_entry<__nv_bfloat16>(
      q, k_pages, v_pages, tables, start_pos, q_lens, out, B, KV, CG, G, D,
      NP, page, pps, scale, window, softcap, stream);
}

// The same with q, pages and out in f32.
extern "C" int paged_prefill_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start_pos, const void* q_lens,
    void* out, int B, int KV, int CG, int G, int D, int NP, int page,
    int pps, float scale, int window, float softcap, void* stream) {
  return cuda_core_entry<float>(
      q, k_pages, v_pages, tables, start_pos, q_lens, out, B, KV, CG, G, D,
      NP, page, pps, scale, window, softcap, stream);
}

// The tensor-core kernel: q (B, KV, CG, D), pages (NP, page, KV, D) and out
// bf16, D in {32, 64, 96, 128, 288}; tables (B, pps), start_pos and q_lens
// (B,) int32; part_ml (B, KV, splits, CG, 2) and part_acc (B, KV, splits,
// CG, D) f32 scratch; keys_per_split a multiple of 64 (a whole number of
// key tiles at every D) with keys_per_split * splits >= pps * page.
// Launches the split kernel and the combine kernel; returns
// cudaGetLastError() after each, or cudaErrorInvalidValue for a shape they
// do not take.
extern "C" int paged_prefill_tc_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start_pos, const void* q_lens,
    void* out, void* part_ml, void* part_acc, int B, int KV, int CG, int G,
    int D, int NP, int page, int pps, int keys_per_split, int splits,
    float scale, int window, float softcap, void* stream) {
  if (G <= 0 || CG % G != 0 || page <= 0 || keys_per_split <= 0 ||
      keys_per_split % 64 != 0 || splits <= 0 ||
      (long long)keys_per_split * splits < (long long)pps * page)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PREFILL_TC_ARGS q, k_pages, v_pages, tables, start_pos, q_lens, out, \
    part_ml, part_acc, B, KV, CG, G, NP, page, pps, keys_per_split, splits,  \
    scale, window, softcap, s
  switch (D) {
    case 32: return tcp::launch<32>(PREFILL_TC_ARGS);
    case 64: return tcp::launch<64>(PREFILL_TC_ARGS);
    case 96: return tcp::launch<96>(PREFILL_TC_ARGS);
    case 128: return tcp::launch<128>(PREFILL_TC_ARGS);
    case 288: return tcp::launch<288>(PREFILL_TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PREFILL_TC_ARGS
}
