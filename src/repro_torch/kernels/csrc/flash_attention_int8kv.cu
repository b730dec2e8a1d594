// Attention over an int8 K/V cache with per-token scales, for Hopper
// (sm_90a): a split-context kernel and the shared combine step.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_int8kv
// (Pallas body _flash_kernel_int8kv).  The reference's model path computes
// the same attention in jnp (models/attention.py, the int8 branch of the
// dense decode cache); the port's dense-cache decode calls this kernel
// through repro_torch.kernels.ops.int8kv_attention, at B = 8 for decode
// steps and at B = 1 for every prompt token the dense engine replays.
//
// What bounds it on the H100: bytes.  At the serving path's shapes (one
// query per row, G = 7 query heads per kv head, D = 64) each key costs 2 * D
// bytes of int8 K/V plus 4 bytes of bf16 scales per kv head and feeds
// 4 * G * D flops, ~13 flops per byte, far below the ~295 flop/byte bf16
// ridge: the cache's bytes bound it, half what a bf16 cache would move.  So
// it stays on CUDA cores, and the design keeps enough loads in flight on
// all 132 SMs, at B = 8 and at B = 1, to reach that rate.
//
// Design.  One call issues two CUDA kernels on the caller's stream:
//
// 1. int8kv_split_kernel, grid (splits x row tiles, KV, B), 128 threads.
//    Rows are the folded query rows r = i * G + g (query token i for query
//    head h * G + g), ROWS = 16 to a tile, so all G heads of a kv group
//    share every K/V read, straight from the un-broadcast (B, Skv, KV, D)
//    layout.  The host cuts the key axis into `splits` ranges of
//    `keys_per_split` keys from shapes only (B, KV, Skv, D, rows; never
//    q_start or kv_len, which live on the card), so that the grid covers the
//    SMs several times over at B = 8 and at B = 1.  A block clips its range
//    to the keys its rows can see: from the window's first key (of its
//    oldest row) to min(kv_len, Skv) and the causal bound (of its newest
//    row); a block whose clipped range is empty writes a neutral partial
//    (m = -1e30, l = 0) for its rows and exits.  Otherwise it issues
//    cp.async copies (16 bytes where D is a multiple of 16 and the caches
//    are 16-byte aligned, else 4) of all its K codes in one group and all its
//    V codes in a second, so every load of the range is in flight at once,
//    and loads the scales beside them.  Scores: warp w takes rows w * 4 ..
//    w * 4 + 3 of the tile, its lanes the keys (32 a pass); a lane
//    dequantizes its key's codes 16 at a time in registers exactly as the
//    reference reads them (K times its scale, rounded to q's dtype, then
//    widened) and continues each of its rows' dots, so every dot is an fma
//    chain in ascending dim order, bit for bit the plain version's f32 dot
//    on the CPU (a shuffle sum of partials rounds most scores differently,
//    and the extra bf16 output flips are enough to move a greedy token of
//    the card-vs-CPU serving check); q rows are read as
//    broadcasts, and K rows padded to an odd number of 16-byte units so the
//    lanes' 16-byte reads fall in different banks.  Softmax: one warp per
//    row, lanes over keys (shuffle max and sum), P in f32.  P V: warp w
//    takes rows w, w + 4, ... (up to 4 a warp), each lane a pair of output
//    dims, V times its scale in f32; the block writes its partial (m, l,
//    acc) unnormalised, in f32.
// 2. split_combine::combine_kernel (split_combine.cuh), one block per (b,
//    kv head, folded row): the partials with l > 0 merged, in f32, rounded
//    to q's dtype once, into the model layout (B, Sq, H, D); a row with no
//    valid key writes zeros.
//
// Per-row positions, which the TPU kernel's scalar seq_k and top-left mask
// cannot express: query i of row b sits at q_start[b] + i, and keys at or
// past kv_len[b] (clamped to Skv) are masked, so the serving decode passes
// q_start = position, kv_len = position + 1, and q_start = 0, kv_len = Skv
// is the TPU kernel's function.  Masks: causal kpos <= qpos, window
// qpos - kpos < window; the softcap c * tanh(s / c) is applied before the
// mask.  Numerics: K rounded to q's dtype after its scale, V not (what the
// reference's jitted bf16 decode reads; with f32 q both are the TPU
// kernel's f32 products); scores, P, the sums and the combine in f32 (expf,
// not an approximation); only the output is rounded.  D must be a multiple
// of 4 and at most 288.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;             // 4 warps
constexpr int NW = THREADS / 32;
constexpr int ROWS = 16;                 // folded query rows per row tile
constexpr int RW = ROWS / NW;            // rows per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ inline int padded(int D) { return (D + 15) & ~15; }
// the K/V code row stride in shared memory: Dp, plus 16 bytes where Dp is
// an even number of 16-byte units, so the 16-byte reads of 8 lanes at 8
// consecutive keys fall in different banks
__host__ __device__ inline int code_stride(int D) {
  const int Dp = padded(D);
  return (Dp / 16) % 2 == 0 ? Dp + 16 : Dp;
}

// Shared memory of one split block, in bytes: K and V codes (keys x KP
// int8 each), their scales in f32, q (ROWS x Dp f32), scores (ROWS x keys
// f32) and (m, l) per row.
__host__ __device__ inline int split_smem_bytes(int D, int keys) {
  return 2 * keys * code_stride(D) +
         4 * (2 * keys + ROWS * padded(D) + ROWS * keys + 2 * ROWS);
}

// T: the dtype of q, both scales and out (f32 or bf16); CPB: bytes a
// cp.async moves (16, or 4 where D % 16 or the alignment forbids 16); NPR:
// output dim pairs per lane in the P V pass, ceil(Dp / 64).
template <typename T, int CPB, int NPR>
__global__ void __launch_bounds__(THREADS) int8kv_split_kernel(
    const T* __restrict__ q,               // (B, Sq, H, D)
    const signed char* __restrict__ k8,    // (B, Skv, KV, D)
    const T* __restrict__ k_scale,         // (B, Skv, KV)
    const signed char* __restrict__ v8,    // (B, Skv, KV, D)
    const T* __restrict__ v_scale,         // (B, Skv, KV)
    const int* __restrict__ q_start,       // (B,)
    const int* __restrict__ kv_len,        // (B,)
    float* __restrict__ part_ml,           // (B, KV, splits, R, 2)
    float* __restrict__ part_acc,          // (B, KV, splits, R, D)
    int Sq, int H, int KV, int Skv, int D, int keys_per_split, int splits,
    float scale, int causal, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = padded(D);
  const int KP = code_stride(D);
  const int KM = keys_per_split;
  signed char* k_s = reinterpret_cast<signed char*>(smem_raw);
  signed char* v_s = k_s + KM * KP;
  float* ks_s = reinterpret_cast<float*>(v_s + KM * KP);   // KM
  float* vs_s = ks_s + KM;                                 // KM
  float* q_s = vs_s + KM;                                  // ROWS x Dp
  float* s_s = q_s + ROWS * Dp;                            // ROWS x KM
  float* ml_s = s_s + ROWS * KM;                           // ROWS x 2

  const int G = H / KV;
  const int R = Sq * G;
  const int sp = blockIdx.x % splits;
  const int row0 = (blockIdx.x / splits) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(ROWS, R - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t part = ((size_t)(b * KV + h) * splits + sp) * R + row0;

  const int qs = q_start[b];
  const int qpos_lo = qs + row0 / G;
  const int qpos_hi = qs + (row0 + nrows - 1) / G;
  const int kv_n = min(kv_len[b], Skv);
  int hi = kv_n;                         // keys [lo, hi) can be visible
  if (causal) hi = min(hi, qpos_hi + 1);
  const int lo = window > 0 ? max(0, qpos_lo - (window - 1)) : 0;
  const int k_lo = max(lo, sp * KM);
  const int k_hi = min(hi, sp * KM + KM);
  if (k_lo >= k_hi) {                    // neutral partial
    for (int r = tid; r < nrows; r += THREADS) {
      part_ml[(part + r) * 2] = NEG_INF;
      part_ml[(part + r) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int n_keys = k_hi - k_lo;

  // all K codes of the range, then all V codes: two cp.async groups
  const int cpr = D / CPB;               // copies per key row
  const size_t tok0 = ((size_t)b * Skv + k_lo) * KV + h;
  for (int pass = 0; pass < 2; ++pass) {
    const signed char* src = (pass == 0 ? k8 : v8) + tok0 * D;
    signed char* dst = pass == 0 ? k_s : v_s;
    for (int i = tid; i < n_keys * cpr; i += THREADS) {
      const int t = i / cpr, c = i - t * cpr;
      cp_async<CPB>(smem_u32(dst + t * KP + c * CPB),
                    src + (size_t)t * KV * D + c * CPB);
    }
    cp_async_commit();
  }
  for (int t = tid; t < n_keys; t += THREADS) {
    const size_t tok = tok0 + (size_t)t * KV;
    ks_s[t] = to_f32(k_scale[tok]);
    vs_s[t] = to_f32(v_scale[tok]);
  }
  // q in f32, (ROWS, Dp); pad dims and rows are zeros
  const int CH = Dp >> 4;                // 16-code chunks per key row
  for (int i = tid; i < ROWS * Dp; i += THREADS) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.0f;
    if (r < nrows && d < D) {
      const int fr = row0 + r;
      const int qi = fr / G, g = fr - qi * G;
      x = to_f32(q[(((size_t)b * Sq + qi) * H + h * G + g) * D + d]);
    }
    q_s[i] = x;
  }
  cp_async_wait<1>();                    // K landed
  __syncthreads();

  // scores: warp w takes rows w * RW .. w * RW + RW - 1, its lanes the keys
  // (32 a pass); a lane dequantizes its key's codes 16 at a time and
  // continues each row's dot as an fma chain in ascending dim order, as the
  // plain version's f32 dot (q rows are read as broadcasts)
  const int r0 = warp * RW;
  if (r0 < nrows) {
    for (int t = lane; t < n_keys; t += 32) {
      const float ksc = ks_s[t];
      float acc[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) acc[j] = 0.0f;
      for (int c = 0; c < CH; ++c) {
        const int4 raw = *reinterpret_cast<const int4*>(k_s + t * KP + c * 16);
        float kf[16];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const int word = w4 == 0 ? raw.x : w4 == 1 ? raw.y
                         : w4 == 2 ? raw.z : raw.w;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kf[4 * w4 + e] = round_to<T>(
                (float)(signed char)(word >> (8 * e)) * ksc);
        }
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          if (r0 + j < nrows) {
            const float* qr = q_s + (r0 + j) * Dp + c * 16;
            float x = acc[j];
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const float4 a = *reinterpret_cast<const float4*>(qr + 4 * e4);
              x = fmaf(a.x, kf[4 * e4], x);
              x = fmaf(a.y, kf[4 * e4 + 1], x);
              x = fmaf(a.z, kf[4 * e4 + 2], x);
              x = fmaf(a.w, kf[4 * e4 + 3], x);
            }
            acc[j] = x;
          }
        }
      }
      const int kpos = k_lo + t;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int r = r0 + j;
        if (r < nrows) {
          float x = acc[j] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          const int qpos = qs + (row0 + r) / G;
          bool ok = kpos < kv_n;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          s_s[r * KM + t] = ok ? x : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // softmax over the block's keys: one warp per row
  for (int r = warp; r < nrows; r += NW) {
    float* sr = s_s + r * KM;
    float mx = NEG_INF;
    for (int t = lane; t < n_keys; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int t = lane; t < n_keys; t += 32) {
      // a row with no valid key in the range keeps p = 0
      const float p = mx == NEG_INF ? 0.0f : expf(sr[t] - mx);
      sr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml_s[2 * r] = mx;
      ml_s[2 * r + 1] = sum;
    }
  }
  cp_async_wait<0>();                    // V landed
  __syncthreads();

  // P V: warp w takes rows w + 4 j, lane the dim pairs lane + 32 i
  float o[RW][NPR][2];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int i = 0; i < NPR; ++i) o[j][i][0] = o[j][i][1] = 0.0f;
  const int DH = D >> 1;
  for (int t = 0; t < n_keys; ++t) {
    const float vsc = vs_s[t];
    float p[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int r = warp + NW * j;
      p[j] = r < nrows ? s_s[r * KM + t] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NPR; ++i) {
      const int dp = lane + 32 * i;
      if (dp < DH) {
        const char2 vc = *reinterpret_cast<const char2*>(v_s + t * KP + 2 * dp);
        const float v0 = (float)vc.x * vsc, v1 = (float)vc.y * vsc;
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          o[j][i][0] = fmaf(p[j], v0, o[j][i][0]);
          o[j][i][1] = fmaf(p[j], v1, o[j][i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + NW * j;
    if (r < nrows) {
#pragma unroll
      for (int i = 0; i < NPR; ++i) {
        const int dp = lane + 32 * i;
        if (dp < DH)
          *reinterpret_cast<float2*>(part_acc + (part + r) * D + 2 * dp) =
              make_float2(o[j][i][0], o[j][i][1]);
      }
      if (lane == 0) {
        part_ml[(part + r) * 2] = ml_s[2 * r];
        part_ml[(part + r) * 2 + 1] = ml_s[2 * r + 1];
      }
    }
  }
}

template <typename T, int CPB, int NPR>
int launch_split(dim3 grid, int smem, cudaStream_t stream, const void* q,
                 const void* k8, const void* ks, const void* v8,
                 const void* vs, const void* q_start, const void* kv_len,
                 float* part_ml, float* part_acc, int Sq, int H, int KV,
                 int Skv, int D, int keys_per_split, int splits, float scale,
                 int causal, int window, float softcap) {
  auto kernel = int8kv_split_kernel<T, CPB, NPR>;
  static int smem_opted = 48 * 1024;     // one per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const signed char*)k8, (const T*)ks,
      (const signed char*)v8, (const T*)vs, (const int*)q_start,
      (const int*)kv_len, part_ml, part_acc, Sq, H, KV, Skv, D,
      keys_per_split, splits, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int CPB>
int launch_cpb(dim3 grid, int smem, cudaStream_t s, const void* q,
               const void* k8, const void* ks, const void* v8, const void* vs,
               const void* q_start, const void* kv_len, float* part_ml,
               float* part_acc, int Sq, int H, int KV, int Skv, int D,
               int keys_per_split, int splits, float scale, int causal,
               int window, float softcap) {
#define INT8KV_SPLIT_ARGS grid, smem, s, q, k8, ks, v8, vs, q_start, kv_len, \
    part_ml, part_acc, Sq, H, KV, Skv, D, keys_per_split, splits, scale,    \
    causal, window, softcap
  const int Dp = padded(D);
  if (Dp <= 64) return launch_split<T, CPB, 1>(INT8KV_SPLIT_ARGS);
  if (Dp <= 128) return launch_split<T, CPB, 2>(INT8KV_SPLIT_ARGS);
  return launch_split<T, CPB, 5>(INT8KV_SPLIT_ARGS);
#undef INT8KV_SPLIT_ARGS
}

template <typename T>
int launch(const void* q, const void* k8, const void* ks, const void* v8,
           const void* vs, const void* q_start, const void* kv_len,
           void* out, void* part_ml, void* part_acc, int B, int Sq, int H,
           int KV, int Skv, int D, int keys_per_split, int splits,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const int G = H / KV;
  const int R = Sq * G;
  const int tiles = (R + ROWS - 1) / ROWS;
  if (B * KV * tiles == 0) return (int)cudaGetLastError();
  const int smem = split_smem_bytes(D, keys_per_split);
  dim3 grid(splits * tiles, KV, B);
  const bool vec16 =
      D % 16 == 0 && ((uintptr_t)k8 % 16 == 0) && ((uintptr_t)v8 % 16 == 0);
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  const int e = vec16
      ? launch_cpb<T, 16>(grid, smem, stream, q, k8, ks, v8, vs, q_start,
                          kv_len, ml, acc, Sq, H, KV, Skv, D, keys_per_split,
                          splits, scale, causal, window, softcap)
      : launch_cpb<T, 4>(grid, smem, stream, q, k8, ks, v8, vs, q_start,
                         kv_len, ml, acc, Sq, H, KV, Skv, D, keys_per_split,
                         splits, scale, causal, window, softcap);
  if (e != 0) return e;
  return split_combine::launch_combine(
      ml, acc, (T*)out, B, KV, R, D, splits, G, (long long)Sq * H * D,
      (long long)G * D, (long long)H * D, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by q, both scales and out.
// part_ml (B, KV, splits, Sq * G, 2) and part_acc (B, KV, splits, Sq * G, D)
// are f32 scratch.  Launches the split kernel and the combine kernel;
// returns cudaGetLastError() after each, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int flash_attention_int8kv_fwd(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* q_start, const void* kv_len, void* out,
    void* part_ml, void* part_acc, int dtype, int B, int Sq, int H, int KV,
    int Skv, int D, int keys_per_split, int splits, float scale, int causal,
    int window, float softcap, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > 288 || KV <= 0 || H % KV != 0 ||
      keys_per_split <= 0 || keys_per_split % 4 != 0 || splits <= 0 ||
      (long long)keys_per_split * splits < Skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define INT8KV_ARGS q, k8, k_scale, v8, v_scale, q_start, kv_len, out,        \
    part_ml, part_acc, B, Sq, H, KV, Skv, D, keys_per_split, splits, scale,  \
    causal, window, softcap, st
  if (dtype == 0) return launch<float>(INT8KV_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(INT8KV_ARGS);
#undef INT8KV_ARGS
  return (int)cudaErrorInvalidValue;
}
