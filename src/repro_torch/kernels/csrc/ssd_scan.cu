// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_scan (Pallas body
// _ssd_kernel), reached through repro.kernels.ops.ssd; the TPU form of
// repro.models.ssm.ssd_chunked, which the ssm family's full-sequence
// forward runs in every mamba2 layer.
//
// Per head, chunk by chunk (L rows each, with cum = the inclusive prefix
// sum of dt * A over the chunk and seg = cum[L - 1]):
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h_enter                       (y in x's dtype)
//   h_enter[c + 1] = exp(seg_c) h_enter[c] + sum_j B_j^T (exp(seg - cum_j)
//           dt_j x_j)
// with h_enter[0] = 0 (no D skip, no initial state: the TPU kernel's
// contract).
//
// What bounds it on the H100: per chunk the masked C.B^T product takes
// L(L+1)/2 N multiply-adds once per group (every head of a group shares
// it), and per head the masked M.x product L(L+1)/2 P, C.h_enter and the
// chunk state L N P each; at mamba2-1.3b training shapes (b 8, S 1024,
// H 64, G 1, P 64, N 128, L 256) that is 26 GFLOP (0.026 ms at 989
// TFLOP/s) against 140 MB (x read and y written in bf16, B and C read
// once, dt f32), 0.042 ms at 3.35 TB/s: the bytes bound it.
//
// Two kernels, chosen by the wrapper from dtype and shapes
// (kernels/ssd_scan.py::tensor_core_route):
//
// - The tensor-core scan (namespace ssd_tc): bf16 x, B, C; N and P
//   multiples of 16, N <= 128, P <= 64; L a multiple of 64 up to 256
//   (the states kernel's cum scan holds one position a thread).  The Pallas
//   grid walks the chunks of a head in order with the state in VMEM; here
//   the chunks are independent except for the (N, P) state carried
//   between them, so one call is three launches:
//   (a) ssd_cb_kernel, per (b, chunk, group, 64 x 64 tile at or below
//       the diagonal): CB = C . B^T with bf16 mma.sync into f32 (exact
//       products), written f32 (b, nc, G, L, L);
//   (b) ssd_states_kernel, per (b, head), 8 warps: the chunk states and
//       their passing.  Walking the head's chunks in order: cum by a
//       block scan, w = exp(seg - cum) dt, the chunk's contribution
//       B^T (w x) on the tensor cores (64-row tiles of B and x double-
//       buffered across chunks), and h_enter[c + 1] = exp(seg_c)
//       h_enter[c] + state_c in f32 registers; h_enter written f32
//       (b, nc, H, N, P), cum and dt kept for (c).  (Chunk-parallel state
//       blocks and a separate pass over the chunks measured slower: the
//       pass moved the f32 states through memory twice more.)
//   (c) ssd_output_kernel, per (b, chunk, head), h_enter staged once, for
//       each 64-row tile: C . h_enter on the tensor cores, each row then
//       scaled by exp(cum_i), and in the same f32 accumulator M . x over
//       the 64-column tiles at or below the diagonal (those above are
//       skipped), M_ij = CB_ij exp(cum_i - cum_j) dt_j selected before
//       the exp (above the diagonal it overflows to inf; never inf * 0);
//       y written once in bf16 through shared memory.
//   The fragments, ldmatrix, cp.async and the M . x product are
//   tc_attention.cuh's (the flash kernel's PV step, M in place of P, x in
//   place of V; once for M's hi and once for its lo).  At mamba2 training
//   shapes (a) and (c) run 320 and 2,048 independent blocks, (b) 512,
//   against the 512 serial ones of one block per (b, h) that computed
//   everything; the mma work is ~56 GFLOP (CB once per group, the three
//   split products twice).
//   Rounding: CB, the decays, the state passing and every accumulator are
//   f32.  Three f32 values enter a tensor-core product, each as a pair of
//   bf16 values hi = rn(v), lo = rn(v - hi), both multiplied, so each is
//   rounded by at most 2^-18 (relative):
//     M = CB exp(cum_i - cum_j) dt_j, for M . x;
//     w_j x_j, for the chunk state;
//     h_enter, for C . h_enter (each row then scaled by exp(cum_i), so C
//     enters exact).
//   C, B and x enter exact.  A single bf16 rounding of M or w x (2^-9)
//   is too coarse: where |y| < 1 beside terms of ~10 (x, B, C ~ N(0, 1),
//   N 128) it moves y past the 2e-2 element-wise check.  The split
//   doubles the M . x and chunk-state products.  The check
//   (ref.rounding_bound_ratio) holds y to p times the plain scan of |x|,
//   |B| and |C| plus one bf16 ulp of y, with p = 2^-8: the pairs' 2^-18
//   and the decays' f32 error (cum is summed in another order than the
//   plain version's cumsum: a few 2^-24 |cum|).  ref.ssd_tiles_ref
//   mirrors all of this in PyTorch.
//
// - The CUDA-core scan (anonymous namespace): f32, and every shape the
//   tensor-core scan does not take (the smoke configs' N 16, L 16).  One
//   thread block per (b, h) loops over the chunks itself, with the (N, P)
//   f32 state in shared memory for the whole scan.  A chunk's C and B
//   tiles in f32 do not fit beside the state, so the chunk is taken in row
//   tiles of TI = 64 (C rows, outputs) against the column tiles of TJ = 64
//   at or below them (B and x rows): per pair the 64 x 64 score tile is
//   formed in registers, masked and scaled into M in shared memory, and
//   M.x accumulated into the row tile's outputs in registers.  The state
//   update then walks the chunk's B and x tiles again.  Everything is f32
//   FMA on the CUDA cores, the prefix sum by one thread; limits: N a
//   multiple of 4 up to 128, P up to 64.
//
// Head h reads group h / (H / G) of the un-repeated B and C (b, S, G, N):
// they are never materialised per head.  Inputs are read in the model
// layout: x (b, S, H, P), dt (b, S, H) f32, A (H,) f32, B and C (b, S, G,
// N); y is (b, S, H, P); S a multiple of L.

#include "tc_attention.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int TI = 64;         // output rows per tile
constexpr int TJ = 64;         // B / x rows per tile
constexpr int RM = TI / 16;    // rows per thread
constexpr int CM = TJ / 16;    // score columns per thread
constexpr int MAXQ = 4;        // P / 16 <= 4
constexpr int MAXR = 8;        // N / 16 <= 8 (state rows per thread)
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;

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

__host__ __device__ constexpr int smem_floats(int N, int P, int L) {
  return N * P                 // state
         + TI * (N + 4)        // C tile (rows padded by 4 floats)
         + TJ * (N + 4)        // B tile
         + TJ * P              // x tile
         + TI * (TJ + 4)       // M tile
         + 3 * L;              // dt, cum, w = exp(seg - cum) dt
}

// rows [r0, r0 + rows) of a (b, S, groups, W) tensor's group g, as f32
// into dst (row stride ld); rows at or past `valid` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t row0, int stride, int W,
                                          int rows, int valid) {
  for (int e = threadIdx.x; e < rows * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    dst[r * ld + c] =
        r < valid ? to_f32(src[(row0 + r) * (size_t)stride + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ x,        // (b, S, H, P)
    const float* __restrict__ dt,   // (b, S, H)
    const float* __restrict__ A,    // (H,)
    const T* __restrict__ Bm,       // (b, S, G, N)
    const T* __restrict__ Cm,       // (b, S, G, N)
    T* __restrict__ y,              // (b, S, H, P)
    int S, int H, int G, int N, int P, int L) {
  extern __shared__ __align__(16) float smem[];
  const int NP4 = N + 4;
  float* st_s = smem;                  // N x P
  float* c_s = st_s + N * P;           // TI x NP4
  float* b_s = c_s + TI * NP4;         // TJ x NP4
  float* x_s = b_s + TJ * NP4;         // TJ x P
  float* m_s = x_s + TJ * P;           // TI x (TJ + 4)
  float* dt_s = m_s + TI * (TJ + 4);   // L
  float* cum_s = dt_s + L;             // L
  float* w_s = cum_s + L;              // L

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const int nq = (P + 15) / 16;

  for (int e = tid; e < N * P; e += THREADS) st_s[e] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += L) {
    const size_t row0 = (size_t)b * S + s0;     // first (b, s) row
    // ---- dt, cum = prefix sum of dt * a, w = exp(seg - cum) dt --------
    __syncthreads();                 // the previous chunk's reads are done
    for (int l = tid; l < L; l += THREADS)
      dt_s[l] = dt[(row0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      float c = 0.0f;
      for (int l = 0; l < L; ++l) {
        c += dt_s[l] * a;
        cum_s[l] = c;
      }
    }
    __syncthreads();
    const float seg = cum_s[L - 1];
    for (int l = tid; l < L; l += THREADS)
      w_s[l] = expf(seg - cum_s[l]) * dt_s[l];

    // ---- outputs, one row tile at a time -------------------------------
    for (int i0 = 0; i0 < L; i0 += TI) {
      const int ni = min(TI, L - i0);
      __syncthreads();
      load_tile(c_s, NP4, Cm + (size_t)g * N, row0 + i0, G * N, N, TI, ni);
      __syncthreads();

      float acc[RM][MAXQ];
      // inter-chunk: exp(cum_i) C_i . state
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) acc[r][q] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float sv[MAXQ];
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int p = tx + 16 * q;
          sv[q] = (q < nq && p < P) ? st_s[n * P + p] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float cv = c_s[(ty + 16 * r) * NP4 + n];
#pragma unroll
          for (int q = 0; q < MAXQ; ++q) acc[r][q] += cv * sv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ni ? expf(cum_s[i0 + i]) : 0.0f;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) acc[r][q] *= e;
      }

      // intra-chunk: column tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TJ) {
        const int nj = min(TJ, L - j0);
        __syncthreads();             // m_s, b_s, x_s free
        load_tile(b_s, NP4, Bm + (size_t)g * N, row0 + j0, G * N, N, TJ,
                  nj);
        load_tile(x_s, P, x + (size_t)h * P, row0 + j0, H * P, P, TJ, nj);
        __syncthreads();
        float sc[RM][CM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < CM; ++c) sc[r][c] = 0.0f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[RM], bv[CM];
#pragma unroll
          for (int r = 0; r < RM; ++r)
            cv[r] = *reinterpret_cast<const float4*>(
                &c_s[(ty + 16 * r) * NP4 + n]);
#pragma unroll
          for (int c = 0; c < CM; ++c)
            bv[c] = *reinterpret_cast<const float4*>(
                &b_s[(tx + 16 * c) * NP4 + n]);
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < CM; ++c)
              sc[r][c] += cv[r].x * bv[c].x + cv[r].y * bv[c].y +
                          cv[r].z * bv[c].z + cv[r].w * bv[c].w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            const int j = j0 + tx + 16 * c;
            // select before the exp: above the diagonal it overflows
            const float m = (j <= i && i < L)
                                ? sc[r][c] * expf(cum_s[i] - cum_s[j]) *
                                      dt_s[j]
                                : 0.0f;
            m_s[(ty + 16 * r) * (TJ + 4) + tx + 16 * c] = m;
          }
        }
        __syncthreads();
        const int jn = min(nj, i0 + TI - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float xv[MAXQ];
#pragma unroll
          for (int q = 0; q < MAXQ; ++q) {
            const int p = tx + 16 * q;
            xv[q] = (q < nq && p < P) ? x_s[jj * P + p] : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float mv = m_s[(ty + 16 * r) * (TJ + 4) + jj];
#pragma unroll
            for (int q = 0; q < MAXQ; ++q) acc[r][q] += mv * xv[q];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty + 16 * r;
        if (i >= ni) continue;
        T* yr = y + ((row0 + i0 + i) * H + h) * (size_t)P;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int p = tx + 16 * q;
          if (q < nq && p < P) yr[p] = from_f32<T>(acc[r][q]);
        }
      }
    }

    // ---- state update: exp(seg) state + sum_j B_j^T w_j x_j ------------
    float ct[MAXR][MAXQ];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
#pragma unroll
      for (int q = 0; q < MAXQ; ++q) ct[r][q] = 0.0f;
    for (int j0 = 0; j0 < L; j0 += TJ) {
      const int nj = min(TJ, L - j0);
      __syncthreads();
      load_tile(b_s, NP4, Bm + (size_t)g * N, row0 + j0, G * N, N, TJ, nj);
      load_tile(x_s, P, x + (size_t)h * P, row0 + j0, H * P, P, TJ, nj);
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        const float wj = w_s[j0 + jj];
        float xv[MAXQ];
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int p = tx + 16 * q;
          xv[q] = (q < nq && p < P) ? x_s[jj * P + p] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const int n = ty + 16 * r;
          const float bw = n < N ? b_s[jj * NP4 + n] * wj : 0.0f;
#pragma unroll
          for (int q = 0; q < MAXQ; ++q) ct[r][q] += bw * xv[q];
        }
      }
    }
    __syncthreads();                 // every y_inter read of the state done
    const float dec = expf(seg);
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int n = ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < MAXQ; ++q) {
        const int p = tx + 16 * q;
        if (q < nq && p < P)
          st_s[n * P + p] = dec * st_s[n * P + p] + ct[r][q];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int b, int S, int H, int G, int N, int P,
           int L, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T>;
  const int smem = (int)sizeof(float) * smem_floats(N, P, L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<b * H, THREADS, smem, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, (T*)y, S, H, G, N, P,
      L);
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core scan.  dtype: 0 = float32, 1 = bfloat16 (x, B, C and y
// alike; dt and A are f32).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            int dtype, int b, int S, int H, int G, int N,
                            int P, int L, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N % 4 != 0 || N > MAX_N || P <= 0 || P > MAX_P || L <= 0 ||
      S % L != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so ours is reported
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, b, S, H, G, N, P, L,
                                 s);
  return launch<float>(x, dt, A, Bm, Cm, y, b, S, H, G, N, P, L, s);
}

// ---------------------------------------------------------------------------
// The tensor-core scan
// ---------------------------------------------------------------------------

namespace ssd_tc {

using tc_attn::cp_async16;
using tc_attn::cp_async_commit;
using tc_attn::cp_async_wait;
using tc_attn::ldsm_x4;
using tc_attn::ldsm_x4_t;
using tc_attn::mma_bf16;
using tc_attn::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int TT = 128;        // threads: 4 warps, 16 rows each
constexpr int TR = 64;         // rows of a tile
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;
constexpr int MAX_L = 256;     // the states kernel's cum scan: one value a
                               // thread, L <= TS
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TS = 256;        // the states kernel: 8 warps, one n tile each
static_assert(MAX_L <= TS, "the cum scan holds one position a thread");

// 64 rows of W bf16 (W a multiple of 8; rows `stride` elements apart) into
// shared memory with row pitch W + 8, 16 bytes per cp.async, by NTH
// threads
template <int NTH = TT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int W, int tid) {
  const int ch = W >> 3;
  const int pitch = W + 8;
  for (int e = tid; e < TR * ch; e += NTH) {
    const int r = e / ch, c = e - r * ch;
    cp_async16(smem_u32(dst + r * pitch + c * 8), src + r * stride + c * 8,
               16);
  }
}

// (a) CB = C . B^T for one 64 x 64 tile (ti, tj), tj <= ti, of one (b,
// chunk, group); block = (b * nc + c) * G + g times the tile pairs
__global__ void __launch_bounds__(TT) ssd_cb_kernel(
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    float* __restrict__ cb, int G, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = N + 8;
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);    // TR x NP
  bf16* b_s = c_s + TR * NP;                        // TR x NP
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nI = L / TR;
  const int pairs = nI * (nI + 1) / 2;
  const int bcg = blockIdx.x / pairs;
  int k = blockIdx.x - bcg * pairs, ti = 0;
  while (k > ti) {
    k -= ti + 1;
    ++ti;
  }
  const int tj = k;
  const int g = bcg % G;
  const size_t row0 = (size_t)(bcg / G) * L;        // (b * nc + c) * L
  const size_t stride = (size_t)G * N;
  stage_rows(c_s, Cm + (row0 + ti * TR) * stride + (size_t)g * N, stride, N,
             tid);
  stage_rows(b_s, Bm + (row0 + tj * TR) * stride + (size_t)g * N, stride, N,
             tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[TR / 8][4];
#pragma unroll
  for (int j = 0; j < TR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int mi = lane >> 3;
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a[0], a[1], a[2], a[3],
            smem_u32(c_s + (warp * 16 + (lane & 15)) * NP + ks * 16 +
                     (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < TR / 8; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              smem_u32(b_s + (j * 8 + (mi >> 1) * 8 + (lane & 7)) * NP +
                       ks * 16 + (mi & 1) * 8));
      mma_bf16(acc[j], a, b0, b1);
      mma_bf16(acc[j + 1], a, b2, b3);
    }
  }
  const int g8 = lane >> 2, t = lane & 3;
  float* out = cb + ((size_t)bcg * L + ti * TR + warp * 16 + g8) * L +
               tj * TR + 2 * t;
#pragma unroll
  for (int j = 0; j < TR / 8; ++j) {
    *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][0],
                                                          acc[j][1]);
    *reinterpret_cast<float2*>(out + 8 * (size_t)L + j * 8) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// (b) the chunk states and their passing, fused: one block of 8 warps per
// (b, head) walks the head's chunks in order.  Per chunk: cum by a block
// scan (dt loaded a chunk ahead), w = exp(seg - cum) dt, and the chunk's
// state contribution B^T (w x) on the tensor cores (warp w owns n rows
// [16 w, 16 w + 16)), the 64-row tiles of B and x double-buffered across
// chunks; the state entering each chunk is written to st in f32 and
// carried in registers: h_enter[c + 1] = exp(seg_c) h_enter[c] + state_c.
// Block = b * H + h.  P = 8 NT.
template <int NT>
__global__ void __launch_bounds__(TS) ssd_states_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    float* __restrict__ cum_ws, float* __restrict__ dt_ws,
    float* __restrict__ st, int nc, int H, int G, int N, int L) {
  constexpr int P = 8 * NT;
  constexpr int XP = P + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int BP = N + 8;
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);    // 2 x TR x BP
  bf16* xr_s = b_s + 2 * TR * BP;                   // 2 x TR x XP, raw x
  bf16* xh_s = xr_s + 2 * TR * XP;                  // TR x XP, w x hi
  bf16* xl_s = xh_s + TR * XP;                      // TR x XP, w x lo
  float* cum_s = reinterpret_cast<float*>(xl_s + TR * XP);  // L
  float* w_s = cum_s + L;                           // L
  float* wtot = w_s + L;                            // TS / 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, g8 = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const int nI = L / TR;
  const int ntiles = nc * nI;
  const size_t xs = (size_t)H * P, bs = (size_t)G * N;
  const bf16* xb = x + (size_t)b * nc * L * xs + (size_t)h * P;
  const bf16* Bb = Bm + (size_t)b * nc * L * bs + (size_t)g * N;
  const bool active = warp * 16 < N;
  const int n0 = warp * 16 + g8;                    // rows n0 and n0 + 8

  stage_rows<TS>(b_s, Bb, bs, N, tid);
  stage_rows<TS>(xr_s, xb, xs, P, tid);
  cp_async_commit();

  // dt of chunk 0; thread tid holds position tid (L <= TS)
  const bool lv = tid < L;
  float d = lv ? dt[((size_t)b * nc * L + tid) * H + h] : 0.0f;
  float hr[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hr[j][e] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    if (active) {                    // h_enter[c]
      float* o = st + bch * N * P + (size_t)n0 * P + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<float2*>(o + j * 8) = make_float2(hr[j][0],
                                                            hr[j][1]);
        *reinterpret_cast<float2*>(o + 8 * P + j * 8) =
            make_float2(hr[j][2], hr[j][3]);
      }
    }
    // cum: a warp scan of dt * a, then the warps' totals
    const float v = __fmul_rn(d, a);
    float incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    float off = __shfl_up_sync(0xffffffffu, incl, 1);   // exclusive
    if (lane == 0) off = 0.0f;
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();                 // also: the last chunk's w_s reads done
    for (int w = 0; w < warp; ++w) off += wtot[w];
    if (lv) {
      const float cv = off + v;
      cum_s[tid] = cv;
      w_s[tid] = d;
      cum_ws[bch * L + tid] = cv;
      dt_ws[bch * L + tid] = d;
    }
    // the next chunk's dt, in flight during this chunk's tiles
    if (c + 1 < nc) {
      const size_t nrow = ((size_t)b * nc + c + 1) * L;
      d = lv ? dt[(nrow + tid) * H + h] : 0.0f;
    }
    __syncthreads();
    const float seg = cum_s[L - 1];
    for (int l = tid; l < L; l += TS)
      w_s[l] = expf(seg - cum_s[l]) * w_s[l];       // w_s held dt

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int it = 0; it < nI; ++it) {
      const int tile = c * nI + it, buf = tile & 1;
      cp_async_wait<0>();
      __syncthreads();               // tile arrived; w_s written; the last
                                     // tile's reads of xh, xl, buf ^ 1 done
      if (tile + 1 < ntiles) {
        stage_rows<TS>(b_s + (buf ^ 1) * TR * BP,
                       Bb + (size_t)(tile + 1) * TR * bs, bs, N, tid);
        stage_rows<TS>(xr_s + (buf ^ 1) * TR * XP,
                       xb + (size_t)(tile + 1) * TR * xs, xs, P, tid);
        cp_async_commit();
      }
      // w_j x_j (f32) as a bf16 hi + lo pair, both multiplied by B^T
      const bf16* xr = xr_s + buf * TR * XP;
      for (int e = tid; e < TR * (P / 2); e += TS) {
        const int r = e / (P / 2), c2 = e - r * (P / 2);
        const float2 f = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(xr + r * XP)[c2]);
        const float w = w_s[it * TR + r];
        const float2 vv = make_float2(f.x * w, f.y * w);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(vv.x, vv.y);
        const float2 fh = __bfloat1622float2(hi);
        reinterpret_cast<__nv_bfloat162*>(xh_s + r * XP)[c2] = hi;
        reinterpret_cast<__nv_bfloat162*>(xl_s + r * XP)[c2] =
            __floats2bfloat162_rn(vv.x - fh.x, vv.y - fh.y);
      }
      __syncthreads();
      if (active) {
        const bf16* bt = b_s + buf * TR * BP;
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          // A = B^T (n rows, l columns) from the (l, n) tile, transposed
          uint32_t af[4];
          ldsm_x4_t(af[0], af[1], af[2], af[3],
                    smem_u32(bt + (kk * 16 + (mi >> 1) * 8 + (lane & 7)) *
                                      BP + warp * 16 + (mi & 1) * 8));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const bf16* xv = half ? xl_s : xh_s;
#pragma unroll
            for (int jd = 0; jd < NT; jd += 2) {
              uint32_t b0, b1, b2, b3;
              ldsm_x4_t(b0, b1, b2, b3,
                        smem_u32(xv + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                          XP + jd * 8 + (mi >> 1) * 8));
              mma_bf16(acc[jd], af, b0, b1);
              mma_bf16(acc[jd + 1], af, b2, b3);
            }
          }
        }
      }
    }
    // h_enter[c + 1] = exp(seg_c) h_enter[c] + state_c, in f32
    const float dec = expf(seg);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hr[j][e] = dec * hr[j][e] + acc[j][e];
  }
}

// (c) y for one (b, chunk, head): block (b * nc + c) * H + h, walking the
// chunk's 64-row tiles with h_enter staged once.  P = 8 NT.
template <int NT>
__global__ void __launch_bounds__(TT) ssd_output_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Cm,
    const float* __restrict__ cb, const float* __restrict__ cum_ws,
    const float* __restrict__ dt_ws, const float* __restrict__ st,
    bf16* __restrict__ y, int H, int G, int N, int L) {
  constexpr int P = 8 * NT;
  constexpr int XP = P + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = N + 8;
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);    // TR x NP
  bf16* hh_s = c_s + TR * NP;                       // N x XP, h_enter hi
  bf16* hl_s = hh_s + N * XP;                       // N x XP, h_enter lo
  bf16* x_s = hl_s + N * XP;                        // 2 x TR x XP
  float* cum_s = reinterpret_cast<float*>(x_s + 2 * TR * XP);  // L
  float* dt_s = cum_s + L;                          // L
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nI = L / TR;
  const int bch = blockIdx.x;
  const int h = bch % H;
  const int bc = bch / H;                           // b * nc + c
  const int g = h / (H / G);
  const size_t row0 = (size_t)bc * L;
  const int mi = lane >> 3;
  const int wrow = warp * 16;
  const int g8 = lane >> 2, t = lane & 3;

  for (int l = tid; l < L; l += TT) {
    cum_s[l] = cum_ws[(size_t)bch * L + l];
    dt_s[l] = dt_ws[(size_t)bch * L + l];
  }
  // h_enter (N, P) f32 -> bf16 hi + bf16 lo = h to ~2^-16 relative
  const float4* hp = reinterpret_cast<const float4*>(st + (size_t)bch * N * P);
  for (int e = tid; e < N * P / 4; e += TT) {
    const float4 v = hp[e];
    const int n = (4 * e) / P, p = 4 * e - n * P;
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    __nv_bfloat162* hh = reinterpret_cast<__nv_bfloat162*>(hh_s + n * XP + p);
    __nv_bfloat162* hl = reinterpret_cast<__nv_bfloat162*>(hl_s + n * XP + p);
    hh[0] = h01;
    hh[1] = h23;
    hl[0] = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    hl[1] = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
  }

  for (int ti = nI - 1; ti >= 0; --ti) {
    const int i0 = ti * TR;
    __syncthreads();                 // the last tile's reads of c_s, x_s done
    stage_rows(c_s, Cm + (row0 + i0) * G * N + (size_t)g * N, (size_t)G * N,
               N, tid);
    stage_rows(x_s, x + row0 * H * P + (size_t)h * P, (size_t)H * P, P, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // inter-chunk: C_i . h_enter (hi and lo into one accumulator), then
    // each row times exp(cum_i)
    float acc[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3],
              smem_u32(c_s + (wrow + (lane & 15)) * NP + ks * 16 +
                       (lane >> 4) * 8));
#pragma unroll
      for (int jd = 0; jd < NT; jd += 2) {
        const int off = (ks * 16 + (mi & 1) * 8 + (lane & 7)) * XP + jd * 8 +
                        (mi >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, smem_u32(hh_s + off));
        mma_bf16(acc[0][jd], a, b0, b1);
        mma_bf16(acc[0][jd + 1], a, b2, b3);
        ldsm_x4_t(b0, b1, b2, b3, smem_u32(hl_s + off));
        mma_bf16(acc[0][jd], a, b0, b1);
        mma_bf16(acc[0][jd + 1], a, b2, b3);
      }
    }
    const int r0 = i0 + wrow + g8;                  // rows r0 and r0 + 8
    const float ci0 = cum_s[r0], ci1 = cum_s[r0 + 8];
    {
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[0][j][0] *= e0;
        acc[0][j][1] *= e0;
        acc[0][j][2] *= e1;
        acc[0][j][3] *= e1;
      }
    }

    // intra-chunk: M . x over the column tiles at or below the diagonal
    // this thread's CB values of a column tile (rows r0, r0 + 8), loaded
    // one tile ahead of their use
    const float* cbr = cb + (((size_t)bc * G + g) * L + r0) * L + 2 * t;
    float2 cv0[TR / 8], cv1[TR / 8];
#pragma unroll
    for (int nt = 0; nt < TR / 8; ++nt) {
      cv0[nt] = *reinterpret_cast<const float2*>(cbr + nt * 8);
      cv1[nt] = *reinterpret_cast<const float2*>(cbr + 8 * L + nt * 8);
    }
    for (int tj = 0; tj <= ti; ++tj) {
      if (tj < ti) {
        stage_rows(x_s + ((tj + 1) & 1) * TR * XP,
                   x + (row0 + (tj + 1) * TR) * H * P + (size_t)h * P,
                   (size_t)H * P, P, tid);
        cp_async_commit();
      }
      float m[1][TR / 8][4];
#pragma unroll
      for (int nt = 0; nt < TR / 8; ++nt) {
        const int j = tj * TR + nt * 8 + 2 * t;
        const float2 c0 = cv0[nt], c1 = cv1[nt];
        const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
        const float d0 = dt_s[j], d1 = dt_s[j + 1];
        // select before the exp: above the diagonal it overflows
        m[0][nt][0] = j <= r0
            ? c0.x * tc_attn::ex2((ci0 - cj0) * LOG2E) * d0 : 0.0f;
        m[0][nt][1] = j + 1 <= r0
            ? c0.y * tc_attn::ex2((ci0 - cj1) * LOG2E) * d1 : 0.0f;
        m[0][nt][2] = j <= r0 + 8
            ? c1.x * tc_attn::ex2((ci1 - cj0) * LOG2E) * d0 : 0.0f;
        m[0][nt][3] = j + 1 <= r0 + 8
            ? c1.y * tc_attn::ex2((ci1 - cj1) * LOG2E) * d1 : 0.0f;
      }
      if (tj < ti) {
#pragma unroll
        for (int nt = 0; nt < TR / 8; ++nt) {
          const float* cn = cbr + (tj + 1) * TR + nt * 8;
          cv0[nt] = *reinterpret_cast<const float2*>(cn);
          cv1[nt] = *reinterpret_cast<const float2*>(cn + 8 * L);
        }
      }
      // M as a bf16 hi + lo pair, each the A operand against x: pv_tile
      // rounds m to nearest (hi); ml = m - hi rounds to lo
      float ml[1][TR / 8][4];
#pragma unroll
      for (int nt = 0; nt < TR / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ml[0][nt][e] = m[0][nt][e] -
                         __bfloat162float(__float2bfloat16_rn(m[0][nt][e]));
      tc_attn::pv_tile<P, 1, TR>(acc, m, x_s + (tj & 1) * TR * XP, lane);
      tc_attn::pv_tile<P, 1, TR>(acc, ml, x_s + (tj & 1) * TR * XP, lane);
      if (tj < ti) {
        cp_async_wait<0>();
        __syncthreads();
      }
    }

    // y through the x buffer the last column tile did not read
    bf16* y_s = x_s + ((ti + 1) & 1) * TR * XP;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(y_s + (wrow + g8) * XP + j * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[0][j][0], acc[0][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(y_s + (wrow + g8 + 8) * XP + j * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[0][j][2], acc[0][j][3]);
    }
    __syncthreads();
    for (int e = tid; e < TR * (P / 8); e += TT) {
      const int r = e / (P / 8), c = e - r * (P / 8);
      *reinterpret_cast<uint4*>(y + ((row0 + i0 + r) * H + h) * P + c * 8) =
          *reinterpret_cast<const uint4*>(y_s + r * XP + c * 8);
    }
  }
}

inline int cb_smem(int N) { return 2 * TR * (N + 8) * (int)sizeof(bf16); }
inline int states_smem(int N, int P, int L) {
  return TR * (2 * (N + 8) + 4 * (P + 8)) * (int)sizeof(bf16) +
         (2 * L + TS / 32) * (int)sizeof(float);
}
inline int output_smem(int N, int P, int L) {
  return (TR * (N + 8) + 2 * N * (P + 8) + 2 * TR * (P + 8)) *
             (int)sizeof(bf16) +
         2 * L * (int)sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NT>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
           const bf16* Cm, bf16* y, float* cb, float* cum_ws, float* dt_ws,
           float* st, int b, int S, int H, int G, int N, int L,
           cudaStream_t stream) {
  constexpr int P = 8 * NT;
  const int nc = S / L, nI = L / TR;
  cudaError_t e;
  int smem = cb_smem(N);
  if ((e = allow_smem(ssd_cb_kernel, smem)) != cudaSuccess) return (int)e;
  ssd_cb_kernel<<<b * nc * G * (nI * (nI + 1) / 2), TT, smem, stream>>>(
      Bm, Cm, cb, G, N, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  smem = states_smem(N, P, L);
  if ((e = allow_smem(ssd_states_kernel<NT>, smem)) != cudaSuccess)
    return (int)e;
  ssd_states_kernel<NT><<<b * H, TS, smem, stream>>>(
      x, dt, A, Bm, cum_ws, dt_ws, st, nc, H, G, N, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  smem = output_smem(N, P, L);
  if ((e = allow_smem(ssd_output_kernel<NT>, smem)) != cudaSuccess)
    return (int)e;
  ssd_output_kernel<NT><<<b * nc * H, TT, smem, stream>>>(
      x, Cm, cb, cum_ws, dt_ws, st, y, H, G, N, L);
  return (int)cudaGetLastError();
}

}  // namespace ssd_tc

// The tensor-core scan, bf16 x, B, C and y; f32 workspaces from the
// wrapper: cb (b, nc, G, L, L), cum and dt (b, nc, H, L), st (b, nc, H, N,
// P), h_enter in st.  Launches its three kernels; returns the first nonzero
// cudaGetLastError() of its launches, or cudaErrorInvalidValue for a shape
// the kernels do not take.
extern "C" int ssd_scan_tc_fwd(const void* x, const float* dt,
                               const float* A, const void* Bm,
                               const void* Cm, void* y, float* cb,
                               float* cum_ws, float* dt_ws, float* st, int b,
                               int S, int H, int G, int N, int P, int L,
                               void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N < 16 ||
      N % 16 != 0 || N > ssd_tc::MAX_N || P < 16 || P % 16 != 0 ||
      P > ssd_tc::MAX_P || L < ssd_tc::TR || L % ssd_tc::TR != 0 ||
      L > ssd_tc::MAX_L || S % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so ours is reported
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  const bf16 *xb = (const bf16*)x, *Bb = (const bf16*)Bm,
             *Cb = (const bf16*)Cm;
  bf16* yb = (bf16*)y;
  switch (P) {
    case 16:
      return ssd_tc::launch<2>(xb, dt, A, Bb, Cb, yb, cb, cum_ws, dt_ws, st, b, S, H,
                       G, N, L, s);
    case 32:
      return ssd_tc::launch<4>(xb, dt, A, Bb, Cb, yb, cb, cum_ws, dt_ws, st, b, S, H,
                       G, N, L, s);
    case 48:
      return ssd_tc::launch<6>(xb, dt, A, Bb, Cb, yb, cb, cum_ws, dt_ws, st, b, S, H,
                       G, N, L, s);
    default:
      return ssd_tc::launch<8>(xb, dt, A, Bb, Cb, yb, cb, cum_ws, dt_ws, st, b, S, H,
                       G, N, L, s);
  }
}
