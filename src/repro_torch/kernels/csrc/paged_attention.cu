// Paged single-token decode attention over block tables, for Hopper (sm_90a):
// a split-context (flash-decoding) kernel and its combine step.
//
// Replaces: src/repro/kernels/paged_attention.py :: paged_attention (Pallas
// body _paged_kernel), reached through repro.kernels.ops.paged_decode_attention.
//
// What bounds it on the H100: bytes.  One decode step reads, per sequence
// and KV head, every reachable K and V position once (2 * length * D bf16
// values) and does 4 * G * D flops per position, about G flops per byte
// (G = 7 for qwen2-0.5b), below even the CUDA cores' ~20 flop/byte ridge and
// far below the tensor cores' ~295: tensor cores would buy nothing.  At the
// timing shapes (B 8, KV 2, contexts 512-2048, D 64) the K/V bytes are
// 4.95 MB, 0.0015 ms at 3.35 TB/s.  So the design moves each K/V byte once
// and keeps enough loads in flight on all 132 SMs to reach that rate.
//
// Design.  One call issues two CUDA kernels on the caller's stream:
//
// 1. paged_decode_split_kernel, grid (splits, KV, B), 128 threads.  The host
//    cuts every row's page list into `splits` contiguous ranges of
//    `pages_per_split` pages, from shapes only (B, KV, pps, page, D; never
//    `lengths`, which would need a device sync), so that B * KV * splits
//    covers the SMs about four times over.  A block clips its range to the
//    row's reachable pages (from the window's first page to
//    (length - 1) / page); a block whose range is empty (past the length,
//    or before the window) writes a neutral partial, m = -1e30 and l = 0,
//    and exits.  Otherwise it issues 16-byte cp.async copies of all its K
//    pages (one group) and then all its V pages (a second group) into
//    shared memory, bf16, so every load of the range is in flight at once;
//    the V copies land while the scores are computed.  Scores: each warp
//    takes one key per group of 8 lanes (4 keys per warp, 16 per pass of
//    the block); a lane holds 16 bytes (8 bf16) of the key per step and
//    dots them with the same 8 dims of each of the G query heads of the
//    group (q in shared memory in f32, laid out so 8 lanes read 128
//    contiguous bytes), then a 3-step shuffle sums the 8 lanes: the G query
//    heads share every K read.  The softmax over the block's keys runs one
//    warp per query head (lanes over keys, shuffle max and sum).  P V: each
//    warp takes every fourth key, each lane a pair of output dims for all
//    G heads, and the 4 warps' sums meet in shared memory.  The block
//    writes its partial (m, l, acc) unnormalised, in f32, to scratch that
//    the wrapper allocates.
// 2. split_combine::combine_kernel (split_combine.cuh, shared with paged
//    prefill and the int8 flash kernel), one block of 64 threads per (b, kv
//    head, query head): out = sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m)
//    l_i over the partials with l_i > 0 (m their max), rounded to bf16; a
//    row with no non-neutral partial (length 0) writes zeros.  The splits'
//    (m, l) are read once, in parallel, into shared memory, and each
//    thread's loads of acc over the splits are independent of each other:
//    the combine costs a few dependent memory round trips, whatever the
//    number of splits.  (Merging in the last split block of each row, by
//    an atomic ticket, was tried and was slower: one block then walks the
//    whole row's G x D outputs.)
//
// Table entries are clamped to [0, NP - 1]; positions past `length` or
// outside the window are masked to -1e30 before the softmax, so a garbage
// or trash-block entry never contributes.  The softcap c * tanh(s / c)
// comes before the mask.  Numerics: q, K and V bf16 widened to f32; scores,
// P, the sums and the combine in f32 (no bf16 rounding of P); only the
// output is rounded to bf16.  D must be a multiple of 8 (16-byte copies)
// and at most 288; page at most 32.
//
// f32 (paged_decode_f32): the same two kernels, instantiated on the element
// type T (Elem<T> below).  A 16-byte copy then holds 4 elements, not 8: a
// lane of the score pass dots 4 dims of a key per step (one float4 of q,
// where bf16 takes two), K/V tiles take 4 bytes an element, and the host's
// split plan sizes a split by the element's bytes (paged_attention.py
// split_plan, elem_bytes), so the same 48 KB of K and V a split holds half
// the pages.  Nothing is rounded but the output, which the combine writes
// in f32.  The work is the same and still bound by bytes, now twice as
// many a position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;           // 4 warps
constexpr int NW = THREADS / 32;
constexpr int GB = 8;                  // query heads per pass of the loops

// What the kernels need of an element type: how many fit in a 16-byte
// copy, and the f32 values of one such chunk and of one pair.
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER16 = 8;
  __device__ static __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __forceinline__ void chunk(const __nv_bfloat16* p,
                                               float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(kp[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  }
  __device__ static __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <> struct Elem<float> {
  static constexpr int PER16 = 4;
  __device__ static __forceinline__ float to_f(float x) { return x; }
  __device__ static __forceinline__ void chunk(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
  __device__ static __forceinline__ float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of one split block, in bytes: K and V (keys x D elements
// of `esize` bytes each), q (G x D f32), scores (G x keys f32), the 4
// warps' P V sums (4 x G x D f32) and (m, l) per head.
__host__ __device__ inline int split_smem_bytes(int G, int D, int keys,
                                                int esize) {
  return 2 * esize * keys * D + 4 * (G * D + G * keys + NW * G * D + 2 * G);
}

// T: the element type of q, K and V (bf16 or f32); NPR: output dim pairs
// per lane in the P V pass, ceil(D / 64).
template <typename T, int NPR>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const T* __restrict__ q,                    // (B, KV, G, D)
    const T* __restrict__ k_pages,              // (NP, page, KV, D)
    const T* __restrict__ v_pages,              // (NP, page, KV, D)
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ lengths,            // (B,)
    float* __restrict__ part_ml,                // (B, KV, splits, G, 2)
    float* __restrict__ part_acc,               // (B, KV, splits, G, D)
    int KV, int G, int D, int NP, int page, int pps, int pages_per_split,
    float scale, int window, float softcap) {
  using E = Elem<T>;
  constexpr int PER16 = E::PER16;              // elements a 16-byte copy
  constexpr int HALVES = PER16 / 4;            // float4s of q a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int keys_max = pages_per_split * page;
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + keys_max * D;
  float* q_s = reinterpret_cast<float*>(v_s + keys_max * D);   // G x D
  float* s_s = q_s + G * D;                    // G x keys_max
  float* red = s_s + G * keys_max;             // NW x G x D
  float* ml_s = red + NW * G * D;              // G x 2

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t part = ((size_t)(b * KV + h) * splits + sp) * G;

  const int length = lengths[b];
  const int q_pos = length - 1;
  int first = 0;
  if (window > 0) {
    const int lo = q_pos - (window - 1);
    first = lo > 0 ? lo / page : 0;
  }
  int last = length > 0 ? (length - 1) / page : -1;
  if (last > pps - 1) last = pps - 1;
  const int p_lo = max(sp * pages_per_split, first);
  const int p_hi = min(sp * pages_per_split + pages_per_split - 1, last);
  if (p_lo > p_hi) {                           // neutral partial
    for (int g = tid; g < G; g += THREADS) {
      part_ml[(part + g) * 2] = NEG_INF;
      part_ml[(part + g) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int n_keys = (p_hi - p_lo + 1) * page;
  const int CH = D / PER16;                    // 16-byte chunks per key row

  // all K pages of the range, then all V pages: two cp.async groups
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? k_pages : v_pages;
    T* dst = pass == 0 ? k_s : v_s;
    for (int i = tid; i < n_keys * CH; i += THREADS) {
      const int t = i / CH, c = i - t * CH;
      const int pg = p_lo + t / page, tok = t - (t / page) * page;
      int blk = tables[(size_t)b * pps + pg];
      blk = blk < 0 ? 0 : (blk > NP - 1 ? NP - 1 : blk);
      cp_async16(smem_u32(dst + t * D + c * PER16),
                 src + (((size_t)blk * page + tok) * KV + h) * D + c * PER16);
    }
    cp_async_commit();
  }

  // q in f32, chunk-major: element (g, c * PER16 + e) at
  // ((g * HALVES + e / 4) * CH + c) * 4 + e % 4, so lanes reading chunks
  // c..c+7 of one float4 column read 128 contiguous bytes
  const T* qb = q + (size_t)(b * KV + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    const int c = d / PER16, e = d - c * PER16;
    q_s[((g * HALVES + (e >> 2)) * CH + c) * 4 + (e & 3)] = E::to_f(qb[i]);
  }
  cp_async_wait<1>();                          // K landed
  __syncthreads();

  // scores: one key per 8-lane group, 16 keys per pass of the block
  const int grp = lane >> 3, l8 = lane & 7;
  const int k_start = p_lo * page;
  for (int t0 = warp * 4; t0 < n_keys; t0 += 4 * NW) {
    const int t = t0 + grp;
    const bool valid = t < n_keys;
    for (int g0 = 0; g0 < G; g0 += GB) {
      float acc[GB];
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) acc[gi] = 0.0f;
      if (valid) {
        for (int c = l8; c < CH; c += 8) {
          float kf[PER16];
          E::chunk(k_s + t * D + c * PER16, kf);
#pragma unroll
          for (int gi = 0; gi < GB; ++gi) {
            if (g0 + gi < G) {
              float x = acc[gi];
#pragma unroll
              for (int hh = 0; hh < HALVES; ++hh) {
                const float4 a = *reinterpret_cast<const float4*>(
                    q_s + (((g0 + gi) * HALVES + hh) * CH + c) * 4);
                x = fmaf(a.x, kf[4 * hh], x);
                x = fmaf(a.y, kf[4 * hh + 1], x);
                x = fmaf(a.z, kf[4 * hh + 2], x);
                x = fmaf(a.w, kf[4 * hh + 3], x);
              }
              acc[gi] = x;
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        acc[gi] += __shfl_xor_sync(0xffffffffu, acc[gi], 4);
        acc[gi] += __shfl_xor_sync(0xffffffffu, acc[gi], 2);
        acc[gi] += __shfl_xor_sync(0xffffffffu, acc[gi], 1);
      }
      // lane l8 of the group writes head g0 + l8
      float mine = acc[0];
#pragma unroll
      for (int gi = 1; gi < GB; ++gi) mine = l8 == gi ? acc[gi] : mine;
      if (valid && g0 + l8 < G) {
        float x = mine * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int kpos = k_start + t;
        bool ok = kpos < length;
        if (window > 0) ok = ok && (q_pos - kpos) < window;
        s_s[(g0 + l8) * keys_max + t] = ok ? x : NEG_INF;
      }
    }
  }
  __syncthreads();

  // softmax over the block's keys: one warp per query head
  for (int g = warp; g < G; g += NW) {
    float* sr = s_s + g * keys_max;
    float mx = NEG_INF;
    for (int t = lane; t < n_keys; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int t = lane; t < n_keys; t += 32) {
      // a head with no valid key in the range keeps p = 0
      const float p = mx == NEG_INF ? 0.0f : expf(sr[t] - mx);
      sr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml_s[2 * g] = mx;
      ml_s[2 * g + 1] = sum;
    }
  }
  cp_async_wait<0>();                          // V landed
  __syncthreads();

  // P V: warp w sums keys t = w mod 4, lane owns dim pairs lane + 32 j
  const int DH = D >> 1;
  for (int g0 = 0; g0 < G; g0 += GB) {
    float acc[GB][NPR][2];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
#pragma unroll
      for (int j = 0; j < NPR; ++j) acc[gi][j][0] = acc[gi][j][1] = 0.0f;
    for (int t = warp; t < n_keys; t += NW) {
      float p[GB];
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
        p[gi] = g0 + gi < G ? s_s[(g0 + gi) * keys_max + t] : 0.0f;
#pragma unroll
      for (int j = 0; j < NPR; ++j) {
        const int dp = lane + 32 * j;
        if (dp < DH) {
          const float2 vf = E::pair(v_s + t * D + 2 * dp);
#pragma unroll
          for (int gi = 0; gi < GB; ++gi) {
            acc[gi][j][0] = fmaf(p[gi], vf.x, acc[gi][j][0]);
            acc[gi][j][1] = fmaf(p[gi], vf.y, acc[gi][j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (g0 + gi < G) {
#pragma unroll
        for (int j = 0; j < NPR; ++j) {
          const int dp = lane + 32 * j;
          if (dp < DH) {
            float* r = red + ((size_t)warp * G + g0 + gi) * D + 2 * dp;
            r[0] = acc[gi][j][0];
            r[1] = acc[gi][j][1];
          }
        }
      }
    }
    __syncthreads();
    const int gn = min(GB, G - g0);
    for (int i = tid; i < gn * D; i += THREADS) {
      const int g = g0 + i / D, d = i - (i / D) * D;
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) x += red[((size_t)w * G + g) * D + d];
      part_acc[(part + g) * D + d] = x;
    }
    __syncthreads();                           // red is reused by g0 + GB
  }
  for (int g = tid; g < G; g += THREADS) {
    part_ml[(part + g) * 2] = ml_s[2 * g];
    part_ml[(part + g) * 2 + 1] = ml_s[2 * g + 1];
  }
}

template <typename T, int NPR>
int launch_split(dim3 grid, int smem, cudaStream_t stream,
                 const void* q, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lengths, void* part_ml,
                 void* part_acc, int KV, int G, int D, int NP, int page,
                 int pps, int pages_per_split, float scale, int window,
                 float softcap) {
  auto kernel = paged_decode_split_kernel<T, NPR>;
  static int smem_opted = 48 * 1024;   // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, (const int*)tables,
      (const int*)lengths,
      (float*)part_ml, (float*)part_acc, KV, G, D, NP, page, pps,
      pages_per_split, scale, window, softcap);
  return (int)cudaGetLastError();
}

// The split kernel and the combine, on element type T (q, pages and out).
template <typename T>
int decode_entry(const void* q, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lengths, void* out,
                 void* part_ml, void* part_acc, int B, int KV, int G, int D,
                 int NP, int page, int pps, int pages_per_split, int splits,
                 float scale, int window, float softcap, void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 288 || page <= 0 || page > 32 ||
      pages_per_split <= 0 || splits <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  if (B * KV == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int smem =
      split_smem_bytes(G, D, page * pages_per_split, (int)sizeof(T));
  dim3 grid(splits, KV, B);
  const int npr = (D + 63) / 64;
  int e;
  if (npr <= 1)
    e = launch_split<T, 1>(grid, smem, s, q, k_pages, v_pages, tables,
                           lengths, part_ml, part_acc, KV, G, D, NP, page,
                           pps, pages_per_split, scale, window, softcap);
  else if (npr == 2)
    e = launch_split<T, 2>(grid, smem, s, q, k_pages, v_pages, tables,
                           lengths, part_ml, part_acc, KV, G, D, NP, page,
                           pps, pages_per_split, scale, window, softcap);
  else
    e = launch_split<T, 5>(grid, smem, s, q, k_pages, v_pages, tables,
                           lengths, part_ml, part_acc, KV, G, D, NP, page,
                           pps, pages_per_split, scale, window, softcap);
  if (e != 0) return e;
  return split_combine::launch_combine(
      (const float*)part_ml, (const float*)part_acc, (T*)out, B, KV, G, D,
      splits, 1, (long long)KV * G * D, (long long)G * D, D, s);
}

}  // namespace

// Shared memory (bytes) of one split block, elements of `esize` bytes.
extern "C" int paged_decode_smem_bytes(int G, int D, int page,
                                       int pages_per_split, int esize) {
  return split_smem_bytes(G, D, page * pages_per_split, esize);
}

// q (B, KV, G, D), pages (NP, page, KV, D), out (B, KV, G, D): bf16; tables
// (B, pps) and lengths (B,) int32; part_ml (B, KV, splits, G, 2) and
// part_acc (B, KV, splits, G, D) f32 scratch.  Launches the split kernel
// and the combine kernel; returns cudaGetLastError() after each, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* part_ml,
    void* part_acc, int B, int KV, int G, int D, int NP, int page, int pps,
    int pages_per_split, int splits, float scale, int window, float softcap,
    void* stream) {
  return decode_entry<__nv_bfloat16>(
      q, k_pages, v_pages, tables, lengths, out, part_ml, part_acc, B, KV, G,
      D, NP, page, pps, pages_per_split, splits, scale, window, softcap,
      stream);
}

// The same with q, pages and out in f32.
extern "C" int paged_decode_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* part_ml,
    void* part_acc, int B, int KV, int G, int D, int NP, int page, int pps,
    int pages_per_split, int splits, float scale, int window, float softcap,
    void* stream) {
  return decode_entry<float>(
      q, k_pages, v_pages, tables, lengths, out, part_ml, part_acc, B, KV, G,
      D, NP, page, pps, pages_per_split, splits, scale, window, softcap,
      stream);
}
