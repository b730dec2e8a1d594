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
//           + exp(cum_i) C_i . state                         (y in x's dtype)
//   state = exp(seg) state + sum_j B_j^T (exp(seg - cum_j) dt_j x_j)
// with the state (N, P) starting at zero (no D skip, no initial state: the
// TPU kernel's contract).
//
// What bounds it on the H100: per chunk the masked C.B^T product and the
// M.x product take L(L+1)/2 (N + P) multiply-adds and the two state
// products 2 L N P; at mamba2-1.3b training shapes (b 8, S 1024, H 64,
// P 64, N 128, L 256) that is ~43 GFLOP against ~140 MB (x read and y
// written in bf16, B and C read once per group), ~300 flop/byte, right at
// the H100's bf16 ridge: the tensor cores (989 TFLOP/s) and the memory
// (3.35 TB/s) bound it about equally (~0.04 ms).  This simple version does
// the flops in f32 on the CUDA cores (67 TFLOP/s peak), so it sits at least
// ~15x above that bound.
//
// Design: the Pallas grid's chunk axis runs in order with the state in a
// VMEM accumulator; GPU blocks run in no order, so one thread block per
// (b, h) loops over the chunks itself, with the (N, P) f32 state (32 KB at
// N 128, P 64) in shared memory for the whole scan.  A chunk's C and B
// tiles in f32 (128 KB each at L 256, N 128) do not fit beside the state,
// so the chunk is taken in row tiles of TI = 64 (C rows, outputs) against
// the column tiles of TJ = 64 at or below them (B and x rows): per pair the
// 64 x 64 score tile is formed in registers, masked and scaled into M in
// shared memory, and M.x accumulated into the row tile's outputs, which
// stay in registers (4 rows x P/16 columns per thread).  Above the diagonal
// exp(cum_i - cum_j) overflows to inf, so the mask selects before the exp
// (never inf * 0).  The state update then walks the chunk's B and x tiles
// again, each thread owning N/16 x P/16 state elements in registers.
//
// Head h reads group h / (H / G) of the un-repeated B and C (b, S, G, N):
// they are never materialised per head.  Inputs are read in the model
// layout: x (b, S, H, P), dt (b, S, H) f32, A (H,) f32, B and C (b, S, G,
// N); y is (b, S, H, P).  Limits: N a multiple of 4 up to 128 (float4
// reads of C and B rows), P up to 64, S a multiple of L.
//
// Simple first: f32 FMA on CUDA cores, no tensor cores, no cp.async or TMA,
// the prefix sum by one thread.  Those are later work.

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

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y alike; dt and A are
// f32).  Returns cudaGetLastError() after the launch, or
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
