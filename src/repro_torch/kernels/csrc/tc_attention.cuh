// Tensor-core attention building blocks for Hopper (sm_90a), shared by the
// flash forward (flash_attention.cu, flash_fwd_tc_kernel) and paged prefill
// (paged_prefill.cu, paged_prefill_tc_kernel).
//
// A block is 4 warps; each warp owns 16 MT query rows and walks tiles of KT
// keys of K and V staged bf16 in shared memory, rows padded by 8 bf16 (16
// bytes) so the eight row addresses of every ldmatrix fall in different
// banks.  The tiling follows the head dim (key_tile, q_in_regs): up to D =
// 160, 64-key tiles with Q's A fragments kept in registers; at D = 288
// (gemma2-2b) 32-key tiles with Q's fragments re-read from the staged Q
// tile at every k-step.  There a thread already holds 144 f32 of O; Q's 72
// words of fragments beside it and a 64-key S would pass the 255 registers
// a thread may have, and the smaller tiles bring a block's shared memory to
// 113,664 bytes, so two blocks (8 warps) share an SM.  Per tile:
// - qk_tile: S = Q K^T with mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators), Q's A fragments from registers or, at D = 288, read
//   with ldmatrix from the Q tile, K read with ldmatrix as the col-major B
//   operand; each K fragment feeds the warp's MT row tiles.
// - softmax_tile: the online softmax on S's accumulator fragments in
//   registers.  m is kept in the units of s; p = 2^(s * sl2 - m * sl2) is
//   one FFMA and one ex2.approx, with sl2 = scale * log2(e) (under a
//   softcap, whose tanh is applied first and already scaled, sl2 = 1).  Row
//   max and sum over 4 independent chains, then over the 4 threads of a
//   quad with shuffles; l sums the unrounded f32 P.  Masks are applied only
//   where the caller says the tile crosses a boundary, as per-row bounds on
//   the key offset.
// - pv_tile: O += P V, P rounded to bf16 in registers (round to nearest,
//   relative error <= 2^-9) as the A operand, V read with ldmatrix.trans.
// Numerics: S is exact products of the bf16 inputs summed in f32; m, l, the
// rescaling and O are f32; only P is rounded, for the PV product, as SDPA
// does.  The tile size moves where m is updated, not what is rounded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tc_attn {

constexpr int THREADS = 128;           // 4 warps
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// keys per tile, and whether Q's A fragments stay in registers, at head
// dim D (the header comment)
__host__ __device__ constexpr int key_tile(int D) { return D > 160 ? 32 : 64; }
__host__ __device__ constexpr bool q_in_regs(int D) { return D <= 160; }

// a block's shared memory: Q (BQ rows), two K and two V stages, bf16
__host__ __device__ constexpr int smem_bytes(int D, int BQ) {
  return (BQ + 4 * key_tile(D)) * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU op (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// x summed over the 4 threads of a quad (the threads holding one row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// rows [0, R) at row0_ptr, `row_stride` elements apart, into an (R, D + 8)
// bf16 tile; rows at or past `valid` are zero-filled (read from `base`)
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          const __nv_bfloat16* row0_ptr,
                                          int valid, size_t row_stride,
                                          int tid) {
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int DP = D + 8;
  if constexpr (THREADS % CH == 0) {
    // each thread keeps one chunk column: a fixed stride between its rows
    constexpr int RS = THREADS / CH;   // rows per pass
    const int r0 = tid / CH, c = tid - (tid / CH) * CH;
    const __nv_bfloat16* src = row0_ptr + r0 * row_stride + c * 8;
    const uint32_t d0 = smem_u32(dst + r0 * DP + c * 8);
#pragma unroll
    for (int i = 0; i < R / RS; ++i) {
      const bool ok = r0 + i * RS < valid;
      cp_async16(d0 + i * RS * DP * 2, ok ? src + i * RS * row_stride : base,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < R * CH; i += THREADS) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = r < valid;
      cp_async16(smem_u32(dst + r * DP + c * 8),
                 ok ? row0_ptr + r * row_stride + c * 8 : base, ok ? 16 : 0);
    }
  }
}

// the warp's A fragment of Q rows [row, row + 16), columns [16 ks, 16 ks +
// 16), read with ldmatrix from a (rows, D + 8) tile
template <int D>
__device__ __forceinline__ void ldsm_q(uint32_t (&a)[4],
                                       const __nv_bfloat16* q_s, int row,
                                       int ks, int lane) {
  ldsm_x4(a[0], a[1], a[2], a[3],
          smem_u32(q_s + (row + (lane & 15)) * (D + 8) + ks * 16 +
                   (lane >> 4) * 8));
}

// the warp's Q rows [wrow, wrow + 16 MT) of a (rows, D + 8) tile into A
// fragments kept in registers (q_in_regs)
template <int D, int MT>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[MT][D / 16][4],
                                             const __nv_bfloat16* q_s,
                                             int wrow, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldsm_q<D>(qf[mt][ks], q_s, wrow + mt * 16, ks, lane);
}

// S = Q K^T: 16 MT rows x KT keys per warp from a (KT, D + 8) K tile.
// Q's A fragments: with QR from `qf` (registers, load_q_frags), else read
// with ldmatrix from the warp's rows of the Q tile `q_s` at each k-step
// (`qf` unused)
template <int D, int MT, int KT, bool QR>
__device__ __forceinline__ void qk_tile(
    float (&s)[MT][KT / 8][4], const uint32_t (&qf)[MT][QR ? D / 16 : 1][4],
    const __nv_bfloat16* q_s, int wrow, const __nv_bfloat16* ks_,
    int lane) {
  constexpr int DP = D + 8;
  constexpr int NK = KT / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qa[MT][4];
    if constexpr (!QR) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_q<D>(qa[mt], q_s, wrow + mt * 16, ks, lane);
    }
#pragma unroll
    for (int j = 0; j < NK; j += 2) {
      const int mi = lane >> 3;
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              smem_u32(ks_ + (j * 8 + (mi >> 1) * 8 + (lane & 7)) * DP +
                       ks * 16 + (mi & 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QR) {
          mma_bf16(s[mt][j], qf[mt][ks], b0, b1);
          mma_bf16(s[mt][j + 1], qf[mt][ks], b2, b3);
        } else {
          mma_bf16(s[mt][j], qa[mt], b0, b1);
          mma_bf16(s[mt][j + 1], qa[mt], b2, b3);
        }
      }
    }
  }
}

// The online softmax of one tile, in place: s becomes P (f32), o is
// rescaled, m_r and l_r (this thread's share of l) are updated.  Under a
// softcap s becomes cl * tanh(s * cs) first (sl2 = 1 then).  With
// `need_mask`, key offset j * 8 + 2 t + (e & 1) of the tile is kept for row
// r (the thread's rows g and g + 8 of row tile mt) iff it lies in
// [lo, hi] from bounds(mt, r, lo, hi), both already less 2 t (t = lane & 3);
// the others become -1e30.  A row with no valid key yet keeps p = 0.
template <int D, int MT, int KT, typename Bounds>
__device__ __forceinline__ void softmax_tile(
    float (&s)[MT][KT / 8][4], float (&o)[MT][D / 8][4], float (&m_r)[MT][2],
    float (&l_r)[MT][2], float sl2, float scale, float softcap,
    bool need_mask, const Bounds& bounds) {
  constexpr int NK = KT / 8;
  constexpr int ND = D / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (softcap > 0.0f) {
      const float cs = scale / softcap, cl = softcap * LOG2E;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][j][e] = cl * tanhf(s[mt][j][e] * cs);
    }
    if (need_mask) {
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) bounds(mt, r, lo[r], hi[r]);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = j * 8 + (e & 1);
          const int r = e >> 1;
          s[mt][j][e] = off >= lo[r] && off <= hi[r] ? s[mt][j][e] : NEG_INF;
        }
    }
    // row max and sum over 4 independent chains each (ILP), then the quad
    float mx4[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) mx4[0][c] = mx4[1][c] = NEG_INF;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx4[e >> 1][(j & 1) * 2 + (e & 1)] =
            fmaxf(mx4[e >> 1][(j & 1) * 2 + (e & 1)], s[mt][j][e]);
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    float alpha[2], m_sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[mt][r], mx[r]);
      // m_r = NEG_INF (no key yet) gives alpha = 0 against a finite m_new
      alpha[r] = ex2((m_r[mt][r] - m_new) * sl2);
      m_r[mt][r] = m_new;
      // a row with no valid key yet keeps p = 2^(-1e30 sl2) = 0, not 2^0
      m_sc[r] = m_new == NEG_INF ? 0.0f : m_new * sl2;
    }
    float sum4[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[mt][j][e], sl2, -m_sc[e >> 1]));
        s[mt][j][e] = p;
        sum4[e >> 1][(j & 1) * 2 + (e & 1)] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_r[mt][r] = alpha[r] * l_r[mt][r] +
                   ((sum4[r][0] + sum4[r][1]) + (sum4[r][2] + sum4[r][3]));
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[mt][j][0] *= alpha[0];
      o[mt][j][1] *= alpha[0];
      o[mt][j][2] *= alpha[1];
      o[mt][j][3] *= alpha[1];
    }
  }
}

// O += P V from a (KT, D + 8) V tile: P rounded to bf16 in registers as the
// A operand; each V fragment feeds the warp's MT row tiles
template <int D, int MT, int KT>
__device__ __forceinline__ void pv_tile(float (&o)[MT][D / 8][4],
                                        const float (&s)[MT][KT / 8][4],
                                        const __nv_bfloat16* vs_, int lane) {
  constexpr int DP = D + 8;
  constexpr int ND = D / 8;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int jd = 0; jd < ND; jd += 2) {
      const int mi = lane >> 3;
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                smem_u32(vs_ + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * DP +
                         jd * 8 + (mi >> 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][jd], a[mt], b0, b1);
        mma_bf16(o[mt][jd + 1], a[mt], b2, b3);
      }
    }
  }
}

}  // namespace tc_attn
