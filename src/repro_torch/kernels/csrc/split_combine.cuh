// The combine step of the split-context attention kernels (paged decode,
// paged prefill, int8 flash), shared by paged_attention.cu, paged_prefill.cu
// and flash_attention_int8kv.cu.
//
// A split kernel cuts each (batch row b, kv head h) row's keys into `splits`
// ranges and writes, per range and per folded query row r of the rows the
// kv head serves, an unnormalised partial in f32:
//   part_ml  (B, KV, splits, R, 2): m (the range's max score, natural units
//            of the scaled score) and l (the sum of exp(s - m));
//   part_acc (B, KV, splits, R, D): sum of exp(s - m) v.
// A range with no valid key for row r writes the neutral partial m = -1e30,
// l = 0 (its acc is never written, and never multiplied in).
//
// combine_kernel, one block of 64 threads per (b, kv head, row r):
//   out = sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m) l_i
// over the partials with l_i > 0 (m their max), in f32, rounded to T once; a
// row with no non-neutral partial writes zeros.  The splits' (m, l) are read
// once, in parallel, into shared memory, and each thread's loads of acc over
// the splits are independent of each other, so the combine costs a few
// dependent memory round trips whatever the number of splits.
//
// Where row r lands: out + b * sb + h * sh + (r / grp) * si + (r % grp) * D.
// Paged decode and prefill write (B, KV, R, D) (grp = 1, si = D); the int8
// kernel writes the model layout (B, Sq, H, D), row r = i * G + g being
// query token i of head h * G + g (grp = G, si = H * D).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace split_combine {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 64;

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // red's last readers are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const float* __restrict__ part_ml,   // (B, KV, splits, R, 2)
    const float* __restrict__ part_acc,  // (B, KV, splits, R, D)
    T* __restrict__ out, int KV, int R, int D, int splits, int grp,
    long long sb, long long sh, long long si) {
  extern __shared__ float ml_s[];        // 2 x splits: m (then w), l
  __shared__ float red[THREADS / 32];
  float* w_s = ml_s;
  float* l_s = ml_s + splits;
  const int bhr = blockIdx.x;            // (b * KV + h) * R + r
  const int r = bhr % R;
  const int bh = bhr / R;
  const int b = bh / KV, h = bh - b * KV;
  const size_t row = (size_t)bh * splits;
  const int tid = threadIdx.x;
  float mx = NEG_INF;
  for (int i = tid; i < splits; i += THREADS) {
    const size_t j = ((row + i) * R + r) * 2;
    const float m = part_ml[j], l = part_ml[j + 1];
    w_s[i] = m;
    l_s[i] = l;
    if (l > 0.0f) mx = fmaxf(mx, m);
  }
  const float M = block_reduce(mx, true, red);
  float den = 0.0f;
  for (int i = tid; i < splits; i += THREADS) {
    const float l = l_s[i];
    const float w = l > 0.0f ? expf(w_s[i] - M) : 0.0f;
    w_s[i] = w;
    den += w * l;
  }
  den = block_reduce(den, false, red);   // its barriers publish w_s
  T* o = out + b * sb + h * sh + (long long)(r / grp) * si +
         (long long)(r % grp) * D;
  const size_t stride = (size_t)R * D;
  for (int d = tid; d < D; d += THREADS) {
    const float* a = part_acc + (row * R + r) * D + d;
    float num = 0.0f;
#pragma unroll 16
    for (int i = 0; i < splits; ++i) {
      const float x = a[i * stride];
      const float w = w_s[i];
      num += w > 0.0f ? w * x : 0.0f;
    }
    store(o + d, den > 0.0f ? num / den : 0.0f);
  }
}

// Launch the combine of (B, KV, splits, R) partials on `stream`; returns
// cudaGetLastError().
template <typename T>
inline int launch_combine(const float* part_ml, const float* part_acc,
                          T* out, int B, int KV, int R, int D, int splits,
                          int grp, long long sb, long long sh, long long si,
                          cudaStream_t stream) {
  if (B * KV * R > 0)
    combine_kernel<T><<<B * KV * R, THREADS, 2 * sizeof(float) * splits,
                        stream>>>(part_ml, part_acc, out, KV, R, D, splits,
                                  grp, sb, sh, si);
  return (int)cudaGetLastError();
}

}  // namespace split_combine
