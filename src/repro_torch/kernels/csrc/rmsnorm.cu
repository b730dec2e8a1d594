// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + s)
// in f32, written in the output's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py :: rmsnorm (Pallas body
// _rmsnorm_kernel), reached through repro.kernels.ops.rmsnorm; the same
// function as the reference's jnp modules.rmsnorm, which every layer of the
// port calls.
//
// What bounds it on the H100: 4 flops per element against 4-8 bytes per
// element (x read once, y written once, bf16 or f32), ~1 flop/byte, far
// below the ~295 flop/byte ridge: device-memory bandwidth bounds it (3.35
// TB/s).  At mamba2-1.3b's gated norm in training (8,192 rows x 4,096, f32
// in, bf16 out) that is 201 MB, 0.060 ms; at qwen2-0.5b's (8,192 x 896,
// f32 in, bf16 out) 44 MB, 0.013 ms.
//
// Two kernels, chosen by the wrapper from d and alignment
// (kernels/rmsnorm.py::one_pass_route):
//
// - One pass (rmsnorm_one_pass_kernel): d a multiple of 8 up to 8,192 and
//   x, scale, out 16-byte aligned.  A row is read once, into registers:
//   each of the row's TPR threads (a multiple of 32, from
//   rmsnorm.py::one_pass_plan) holds PPT packs of 8 elements (one 16-byte
//   load for bf16, two for f32), packs tid, tid + TPR, ...; the sum of
//   squares is reduced in f32 with shuffles inside each warp and the
//   row's warp totals through a small shared array, then each thread
//   normalises its packs from registers and stores them.  For d <= 1,024
//   a block holds several rows (256 threads in all), so qwen2's d = 896
//   keeps the card full.  Rows past the last are masked; threads past a
//   ragged row's packs hold zeros.
// - Two passes (rmsnorm_kernel, one warp per row, 8 rows per 256-thread
//   block): every other d and alignment.  Each lane walks the row in packs
//   of 8 (when d % 8 == 0 and the rows are aligned) or element by element,
//   once for the sum of squares and again to normalise; the second read of
//   a row of at most 16 KB comes from L1/L2.
//
// Numerics: the sum of squares, rsqrt and both products are f32, as in the
// reference; only the order of the sum differs from the plain version's,
// so a bf16 output is within one ulp of it and an f32 output within a few
// f32 roundings.
//
// Input f32 or bf16; output f32 or bf16 (the port feeds norms the unrounded
// f32 residual and asks for bf16 out).  The scale is f32 (the port keeps
// norm scales in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int MAX_BLOCK = 256;   // one-pass threads a block, at most

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

// 8 consecutive elements at p (16-byte aligned) to f32
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(
    const TI* __restrict__ x,          // (rows, d)
    const float* __restrict__ scale,   // (d,)
    TO* __restrict__ out,              // (rows, d)
    int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TI* xr = x + row * d;
  TO* yr = out + row * d;

  float ss = 0.0f;
  if (VEC) {
    for (int i = lane * 8; i < d; i += 32 * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) ss += v[k] * v[k];
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  if (VEC) {
    for (int i = lane * 8; i < d; i += 32 * 8) {
      float v[8], s[8];
      load8(xr + i, v);
      load8(scale + i, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (v[k] * r) * (1.0f + s[k]);
      store8(yr + i, v);
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<TO>((to_f32(xr[i]) * r) * (1.0f + scale[i]));
  }
}

// One row per TPR threads (a multiple of 32), blockDim.x / TPR rows per
// block; each thread holds packs lt, lt + TPR, ..., lt + (PPT - 1) TPR of
// its row (8 elements each) in registers between the reduction and the
// store.
template <typename TI, typename TO, int PPT>
__global__ void __launch_bounds__(MAX_BLOCK) rmsnorm_one_pass_kernel(
    const TI* __restrict__ x,          // (rows, d)
    const float* __restrict__ scale,   // (d,)
    TO* __restrict__ out,              // (rows, d)
    int rows, int d, int tpr, float eps) {
  __shared__ float wsum[MAX_BLOCK / 32];   // a partial per warp
  const int lt = threadIdx.x % tpr;
  const int rib = threadIdx.x / tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + rib;
  const bool live = row < rows;
  const int packs = d >> 3;
  const TI* xr = x + row * d;
  TO* yr = out + row * d;

  float v[PPT][8];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = lt + k * tpr;
    if (live && p < packs) {
      load8(xr + p * 8, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[k][i] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[k][i] * v[k][i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) wsum[warp] = ss;
  __syncthreads();
  const int wpr = tpr >> 5;            // warps per row
  float tot = 0.0f;
  for (int w = 0; w < wpr; ++w) tot += wsum[rib * wpr + w];
  const float r = rsqrtf(tot / (float)d + eps);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = lt + k * tpr;
    if (live && p < packs) {
      float s[8];
      load8(scale + p * 8, s);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[k][i] = (v[k][i] * r) * (1.0f + s[i]);
      store8(yr + p * 8, v[k]);
    }
  }
}

template <typename TI, typename TO>
int launch_one_pass(const void* x, const float* scale, void* out, int rows,
                    int d, float eps, int ppt, int tpr, int rpb,
                    cudaStream_t stream) {
  const dim3 grid((rows + rpb - 1) / rpb);
  const int threads = tpr * rpb;
  const TI* xi = static_cast<const TI*>(x);
  TO* o = static_cast<TO*>(out);
  switch (ppt) {
    case 1:
      rmsnorm_one_pass_kernel<TI, TO, 1><<<grid, threads, 0, stream>>>(
          xi, scale, o, rows, d, tpr, eps);
      break;
    case 2:
      rmsnorm_one_pass_kernel<TI, TO, 2><<<grid, threads, 0, stream>>>(
          xi, scale, o, rows, d, tpr, eps);
      break;
    case 3:
      rmsnorm_one_pass_kernel<TI, TO, 3><<<grid, threads, 0, stream>>>(
          xi, scale, o, rows, d, tpr, eps);
      break;
    case 4:
      rmsnorm_one_pass_kernel<TI, TO, 4><<<grid, threads, 0, stream>>>(
          xi, scale, o, rows, d, tpr, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
void launch(const void* x, const float* scale, void* out, int rows, int d,
            float eps, int vec, cudaStream_t stream) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  if (vec)
    rmsnorm_kernel<TI, TO, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const TI*>(x), scale, static_cast<TO*>(out), rows, d,
        eps);
  else
    rmsnorm_kernel<TI, TO, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const TI*>(x), scale, static_cast<TO*>(out), rows, d,
        eps);
}

}  // namespace

// The two-pass kernel.  in_dtype / out_dtype: 0 = float32, 1 = bfloat16.
// vec: 1 when d % 8 == 0
// and x, scale and out are 16-byte aligned (the wrapper checks).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const float* scale, void* out,
                           int in_dtype, int out_dtype, int rows, int d,
                           float eps, int vec, cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so ours is reported
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(x, scale, out, rows, d, eps, vec, stream);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, vec, stream);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, vec, stream);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, vec,
                                         stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The one-pass kernel: d % 8 == 0, x, scale and out 16-byte aligned; the
// plan (ppt packs a thread, tpr threads a row, a multiple of 32, rpb rows
// a block, tpr * rpb <= 256) from rmsnorm.py::one_pass_plan.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int rmsnorm_one_pass_fwd(const void* x, const float* scale,
                                    void* out, int in_dtype, int out_dtype,
                                    int rows, int d, float eps, int ppt,
                                    int tpr, int rpb, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || tpr <= 0 || tpr % 32 != 0 ||
      rpb <= 0 || tpr * rpb > MAX_BLOCK || (long long)ppt * tpr * 8 < d)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so ours is reported
  if (in_dtype == 0 && out_dtype == 0)
    return launch_one_pass<float, float>(x, scale, out, rows, d, eps, ppt,
                                         tpr, rpb, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_one_pass<float, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                 ppt, tpr, rpb, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_one_pass<__nv_bfloat16, float>(x, scale, out, rows, d, eps,
                                                 ppt, tpr, rpb, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_one_pass<__nv_bfloat16, __nv_bfloat16>(
        x, scale, out, rows, d, eps, ppt, tpr, rpb, stream);
  return (int)cudaErrorInvalidValue;
}
