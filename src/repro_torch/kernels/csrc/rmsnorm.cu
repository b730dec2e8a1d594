// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + s)
// in f32, written in the output's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py :: rmsnorm (Pallas body
// _rmsnorm_kernel), reached through repro.kernels.ops.rmsnorm; the same
// function as the reference's jnp modules.rmsnorm, which every layer of the
// port calls.
//
// What bounds it on the H100: 3 flops per element against 2-8 bytes per
// element (x read once, y written once, bf16 or f32), so ~0.5 flop/byte,
// far below the ~295 flop/byte ridge: device-memory bandwidth bounds it
// (3.35 TB/s).  At the gated norm of mamba2-1.3b training (8,192 rows x
// 4,096, bf16 in and out) that is 134 MB, 0.040 ms.
//
// Design: one warp per row, 8 rows per 256-thread block, so a row's sum of
// squares is reduced with shuffles alone (no shared memory, no block-wide
// barrier) and any row count works (the last block's idle warps return;
// Pallas pads the last row tile instead).  Each lane walks the row in
// packs of 8 elements (one 16-byte load for bf16, two for f32) when d is a
// multiple of 8 and the rows are 16-byte aligned, else element by element.
// The row is read twice: once for the sum, once to normalise; the second
// read of a row of at most 16 KB comes from L1/L2.  The sum of squares is
// f32, as in the reference.
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

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16.  vec: 1 when d % 8 == 0
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
