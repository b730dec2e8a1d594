// Exact three-term bf16 split of an f32 matrix, for the tied
// unembedding's backward on the tensor cores (kernels/unembed.py).
//
// Each f32 value g becomes hi = bf16(g), mid = bf16(g - hi),
// lo = bf16(g - hi - mid), all rounded to nearest even.  g - hi and
// (g - hi) - mid are exact in f32, and three 8-bit significands cover
// f32's 24, so hi + mid + lo == g wherever lo stays in bf16's normal
// range (|g| >= 2^-110).
//
// In:  g, rows x cols f32, row stride ld (elements).
// Out: out, rows x 3 x cols bf16, contiguous: row r holds hi's cols,
//      then mid's, then lo's.
//
// One read of g and one write of each term: 10 bytes an element, the
// least the split can move.  Bound by bytes.  Vector route (vec = 1):
// cols and ld multiples of 4, g 16-byte and out 8-byte aligned; each
// thread splits 4 consecutive values (one float4 in, three 8-byte
// stores).  Otherwise one value a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void split1(float g, __nv_bfloat16 &h,
                                       __nv_bfloat16 &m, __nv_bfloat16 &l) {
  h = __float2bfloat16_rn(g);
  const float r = g - __bfloat162float(h);
  m = __float2bfloat16_rn(r);
  l = __float2bfloat16_rn(r - __bfloat162float(m));
}

__global__ void split_vec_kernel(const float *__restrict__ g,
                                 __nv_bfloat16 *__restrict__ out,
                                 long long rows, int cols, long long ld) {
  const int per = cols / 4;
  const long long total = rows * per;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long r = i / per;
    const int c = 4 * (int)(i - r * per);
    const float4 v = *reinterpret_cast<const float4 *>(g + r * ld + c);
    __align__(8) __nv_bfloat16 h[4], m[4], l[4];
    split1(v.x, h[0], m[0], l[0]);
    split1(v.y, h[1], m[1], l[1]);
    split1(v.z, h[2], m[2], l[2]);
    split1(v.w, h[3], m[3], l[3]);
    __nv_bfloat16 *o = out + r * 3 * cols + c;
    *reinterpret_cast<uint2 *>(o) = *reinterpret_cast<const uint2 *>(h);
    *reinterpret_cast<uint2 *>(o + cols) =
        *reinterpret_cast<const uint2 *>(m);
    *reinterpret_cast<uint2 *>(o + 2 * cols) =
        *reinterpret_cast<const uint2 *>(l);
  }
}

__global__ void split_scalar_kernel(const float *__restrict__ g,
                                    __nv_bfloat16 *__restrict__ out,
                                    long long rows, int cols, long long ld) {
  const long long total = rows * cols;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long r = i / cols;
    const int c = (int)(i - r * cols);
    __nv_bfloat16 h, m, l;
    split1(g[r * ld + c], h, m, l);
    __nv_bfloat16 *o = out + r * 3 * cols + c;
    o[0] = h;
    o[cols] = m;
    o[2 * cols] = l;
  }
}

}  // namespace

extern "C" int unembed_split(const void *g, void *out, long long rows,
                             int cols, long long ld, int vec, void *stream) {
  const int threads = 256;
  const long long work = vec ? rows * (cols / 4) : rows * cols;
  if (work <= 0) return 0;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + threads - 1) / threads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    split_vec_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float *>(g), static_cast<__nv_bfloat16 *>(out),
        rows, cols, ld);
  else
    split_scalar_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float *>(g), static_cast<__nv_bfloat16 *>(out),
        rows, cols, ld);
  return (int)cudaGetLastError();
}
