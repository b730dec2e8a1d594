// Dense flash-attention forward (online softmax) for Hopper (sm_90a): a
// tensor-core kernel for bf16 with D <= 128, 160 and 288, and a CUDA-core
// kernel for f32 and the other head dims up to 288.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
// body _flash_kernel), reached through repro.kernels.ops.mha_flash_attention.
//
// What bounds it on the H100: causal attention over S positions does
// 4 * S * (S + 1) / 2 * D flops per head against 2 bytes per element of q,
// k, v and out, i.e. ~S / 2 flops per byte at bf16: at the training shapes
// (qwen2-0.5b, B 8, S 1024, H 14, KV 2, D 64: 15.05 GFLOP, 0.0152 ms at
// 989 TFLOP/s) that is ~500 flop/byte, above the H100's ~295 flop/byte bf16
// ridge, so the flops bound it, on the tensor cores.
//
// Routing (kernels/flash_attention.py, by dtype and D, never by a failed
// build or launch): bf16 with D in {32, 64, 96, 128, 160, 288} takes the
// tensor-core kernel flash_fwd_tc_kernel (160 is gemma2-27b's D = 144
// padded by the wrapper, 288 gemma2-2b's); f32, and bf16 with any other D,
// take the CUDA-core kernel flash_fwd_kernel.
//
// Tensor-core kernel (flash_fwd_tc_kernel<D, MT>), FlashAttention-2 style
// with mma.sync.m16n8k16 (bf16 operands, f32 accumulators): one block of 4
// warps per (b * H + h, 64 MT query rows), longest rows first; each warp
// owns 16 MT query rows (MT = 2 for D <= 64, so every K and V fragment read
// from shared memory feeds two row tiles; MT = 1 above, where the
// accumulators would not fit in registers: at D = 160 a thread holds 80
// f32 of O, 40 words of Q fragments and 32 f32 of S).  Up to D = 160, Q is
// loaded once (ldmatrix into A fragments kept in registers) and keys come
// in tiles of 64; at D = 288 a thread holds 144 f32 of O, so Q's fragments
// are read again from the staged Q tile at every k-step and keys come in
// tiles of 32 (16 f32 of S), which keeps the kernel within the 255
// registers without spilling (tc_attention.cuh's key_tile, q_in_regs).  K
// and V tiles stay bf16 in a two-stage ring in shared memory, filled with
// 16-byte cp.async: tile n + 1 is in flight while tile n is multiplied.
// Rows are padded by 8 bf16 (16 bytes), so the eight row addresses of every
// ldmatrix fall in different banks.  S = Q K^T runs on the tensor cores (K
// read with ldmatrix as the col-major B operand); the online softmax runs
// on S's accumulator fragments in registers (row max and sum over 4
// independent chains, then over the 4 threads of a quad with shuffles; p =
// 2^(s * scale * log2 e - m) is one FFMA and one ex2.approx); P is
// converted in registers into the A operand of O += P V (V read with
// ldmatrix.trans).  Causal, window and length masks are applied only on
// tiles that cross a boundary (two compares per element against per-row
// bounds); tiles no row of the block can reach are skipped, and at D = 288
// a warp whose rows all lie past Sq only helps load.  The fragment,
// ldmatrix and softmax code is tc_attention.cuh's, shared with the paged
// prefill kernel.  The output is staged through shared memory for 16-byte
// stores.  Shared
// memory: (64 MT + 4 KT) * (D + 8) * 2 bytes, 55,296 at D = 64, 107,520 at
// D = 160, 113,664 at D = 288 (two blocks an SM; 64-key tiles there would
// take 189,440, one block of 4 warps an SM).  No wgmma, TMA or warp
// specialisation yet: mma.sync was the design that could be made right and
// checked within one change.
//
// Numerics of the tensor-core kernel: S from bf16 inputs is exact products
// summed in f32 (as the plain version); m, l, the rescaling and the output
// accumulator are f32; P is rounded to bf16 (round to nearest, relative error
// <= 2^-9) as the A operand of the PV product, as SDPA does, while l sums the
// unrounded f32 P.  So |out - plain| <= 2^-9 * (|P| @ |V|) / l before the
// output's own bf16 rounding; chip_smoke.py holds it element by element to
// 2^-8 * (|P| @ |V|) / l + 2^-7 * |plain| (ref.rounding_bound_ratio).
//
// CUDA-core kernel (flash_fwd_kernel): one thread block per (b * H + h, tile
// of BQ = 64 query rows); the Pallas grid's sequential kv axis with
// (m, l, acc) in VMEM scratch becomes a loop over kv tiles of BK rows inside
// the block.  256 threads form a 16 x 16 grid: thread (tx, ty) owns query
// rows ty + 16 i (i < 4), score columns tx + 16 j of each kv tile, and output
// columns 2 tx + 32 j (float2 pairs) of D.  Its m, l and acc stay in
// registers in f32; a row's m and l are reduced over the 16 threads of a
// half-warp with shuffles.  Q stays in shared memory for the whole loop; each
// kv tile's K and V are staged in shared memory once and read by all 64 rows;
// P goes through shared memory from the score layout to the P.V layout, in
// f32.  Rows are padded by 4 floats so the float4 reads of 16 different K
// rows fall in different banks.  D <= 64 takes BK = 64 (69 KB of shared
// memory at D = 64); 64 < D <= 288 takes BK = 32 (158 KB at D = 288), both
// opted in above 48 KB.  It runs its flops in f32 on the CUDA cores (67
// TFLOP/s peak); P stays f32, so its error is f32 summation order only.
//
// Both kernels: GQA: q is (B, Sq, H, D) and k, v are (B, Skv, KV, D),
// un-broadcast; head h reads kv head h / (H / KV), so K/V are never
// materialised per query head.  Masks as in the Pallas kernel: kpos < Skv,
// causal (top-left) kpos <= qpos, window qpos - kpos < window; the softcap
// c * tanh(s / c) is applied before the mask.  A row with no valid key keeps
// p = 0 and writes zeros.  A second output, the per-row logsumexp m + log l
// (B, H, Sq) f32 (-inf for a row with no valid key), feeds the backward.
// D must be a multiple of 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_attention.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, D in {32, 64, 96, 128, 160, 288})
// ---------------------------------------------------------------------------
namespace tc {

// the shared tensor-core building blocks (tc_attention.cuh)
using tc_attn::THREADS;
using tc_attn::LOG2E;
using tc_attn::LN2;
using tc_attn::smem_u32;
using tc_attn::cp_async_commit;
using tc_attn::cp_async_wait;
using tc_attn::pack_bf16;
using tc_attn::load_tile;
using tc_attn::smem_bytes;

template <int D, int MT>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Sq, H, D)
    const __nv_bfloat16* __restrict__ k,   // (B, Skv, KV, D)
    const __nv_bfloat16* __restrict__ v,   // (B, Skv, KV, D)
    __nv_bfloat16* __restrict__ out,       // (B, Sq, H, D)
    float* __restrict__ lse,               // (B, H, Sq)
    int H, int KV, int Sq, int Skv, float scale, int causal, int window,
    float softcap) {
  constexpr int BQ = 64 * MT;          // query rows per block, 16 MT a warp
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
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first

  int kt_lo = 0;
  int kt_hi = (Skv + KT - 1) / KT;
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1) / KT + 1);
  if (window > 0) {
    const int lo = q0 - (window - 1);  // oldest row's window start
    if (lo > 0) kt_lo = lo / KT;
  }

  const size_t qs = (size_t)H * D, kvs = (size_t)KV * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  load_tile<D, BQ>(q_s, q, q + (((size_t)b * Sq + q0) * H + h) * D, Sq - q0,
                   qs, tid);
  if (kt_lo < kt_hi) {
    const int k0 = kt_lo * KT;
    load_tile<D, KT>(k_s, k, kb + k0 * kvs, Skv - k0, kvs, tid);
    load_tile<D, KT>(v_s, v, vb + k0 * kvs, Skv - k0, kvs, tid);
  }
  cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * MT;                 // the warp's first row
  // at D 288 a warp whose rows all lie past Sq (the last row tile) only
  // helps load: there a warp's products cost 2.25 times D 128's
  const bool live = QR || q0 + wrow < Sq;
  float o[MT][ND][4];
  float m_r[MT][2], l_r[MT][2];                    // l_r: this thread's share
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.0f;
    m_r[mt][0] = m_r[mt][1] = NEG_INF;
    l_r[mt][0] = l_r[mt][1] = 0.0f;
  }
  uint32_t qf[MT][QR ? D / 16 : 1][4];             // QR: Q's A fragments
  const float sl2 = softcap > 0.0f ? 1.0f : scale * LOG2E;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    cp_async_wait<0>();                          // tile kt (and Q) landed
    // one barrier a tile: it publishes tile kt and tells that every warp
    // is done with tile kt - 1, whose stage the prefetch below refills
    __syncthreads();
    if (kt + 1 < kt_hi) {                        // prefetch the next tile
      const int k1 = (kt + 1) * KT;
      load_tile<D, KT>(k_s + (st ^ 1) * KT * DP, k, kb + k1 * kvs, Skv - k1,
                       kvs, tid);
      load_tile<D, KT>(v_s + (st ^ 1) * KT * DP, v, vb + k1 * kvs, Skv - k1,
                       kvs, tid);
    }
    cp_async_commit();
    if (!live) continue;

    // S = Q K^T: 16 MT rows x KT keys per warp
    float s[MT][NK][4];
    if constexpr (QR) {
      if (kt == kt_lo) tc_attn::load_q_frags<D, MT>(qf, q_s, wrow, lane);
    }
    tc_attn::qk_tile<D, MT, KT, QR>(s, qf, q_s, wrow, k_s + st * KT * DP,
                                    lane);

    // online softmax on the accumulator fragments, masked only on tiles that
    // cross a boundary: key offset j * 8 + 2 t + (e & 1) of the tile is
    // valid for row r iff it lies in [lo_r, hi_r]
    const int k0 = kt * KT;
    const bool need_mask = (k0 + KT > Skv) || (causal && k0 + KT - 1 > q0) ||
                           (window > 0 && q0 + BQ - 1 - k0 >= window);
    auto bounds = [&](int mt, int r, int& lo, int& hi) {
      const int qpos = q0 + wrow + mt * 16 + g + 8 * r;
      hi = Skv - 1 - k0;
      if (causal) hi = min(hi, qpos - k0);
      lo = window > 0 ? qpos - window + 1 - k0 : -KT;
      hi -= 2 * t;
      lo -= 2 * t;
    };
    tc_attn::softmax_tile<D, MT, KT>(s, o, m_r, l_r, sl2, scale, softcap,
                                     need_mask, bounds);

    // O += P V, P rounded to bf16
    tc_attn::pv_tile<D, MT, KT>(o, s, v_s + st * KT * DP, lane);
  }

  cp_async_wait<0>();
  __syncthreads();                     // Q's tile is free for the output
  __nv_bfloat16* stage = q_s + wrow * DP;          // this warp's rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[mt][r] = tc_attn::quad_sum(l_r[mt][r]);
      inv[r] = l_r[mt][r] > 0.0f ? 1.0f / l_r[mt][r] : 0.0f;
    }
    __nv_bfloat16* st_r = stage + (mt * 16 + g) * DP + 2 * t;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      *reinterpret_cast<uint32_t*>(st_r + jd * 8) =
          pack_bf16(o[mt][jd][0] * inv[0], o[mt][jd][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(st_r + 8 * DP + jd * 8) =
          pack_bf16(o[mt][jd][2] * inv[1], o[mt][jd][3] * inv[1]);
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wrow + mt * 16 + g + 8 * r;
        if (row < Sq)
          lse[(size_t)bh * Sq + row] =
              l_r[mt][r] > 0.0f ? m_r[mt][r] * sl2 * LN2 + logf(l_r[mt][r])
                                : -INFINITY;
      }
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * MT * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    const int row = q0 + wrow + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + row) * H + h) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * DP + c * 8);
  }
}

// MT = 2 row tiles a warp (128 query rows a block) where the registers
// allow it (D <= 64), else 1
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int KV, int Sq, int Skv, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr int MT = D <= 64 ? 2 : 1;
  constexpr int BQ = 64 * MT;
  auto kernel = flash_fwd_tc_kernel<D, MT>;
  constexpr int smem = smem_bytes(D, BQ);
  static int smem_opted = 48 * 1024;   // one per instantiation
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
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, H, KV, Sq,
        Skv, scale, causal, window, softcap);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core kernel: bf16 q, k, v and out, D in {32, 64, 96, 128,
// 160, 288}.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H, int KV, int Sq, int Skv, int D, float scale, int causal,
    int window, float softcap, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return tc::launch<32>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                            causal, window, softcap, s);
    case 64:
      return tc::launch<64>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                            causal, window, softcap, s);
    case 96:
      return tc::launch<96>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                            causal, window, softcap, s);
    case 128:
      return tc::launch<128>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                             causal, window, softcap, s);
    case 160:  // gemma2-27b's D 144, padded by the wrapper
      return tc::launch<160>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                             causal, window, softcap, s);
    case 288:  // gemma2-2b
      return tc::launch<288>(q, k, v, out, lse, B, H, KV, Sq, Skv, scale,
                             causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
