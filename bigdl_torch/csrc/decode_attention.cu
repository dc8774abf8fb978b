// Cached decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the jnp attention of one decode position against a KV cache,
// bigdl_tpu/serve/decode.py `_slot_attention` (per-slot positions) and
// bigdl_tpu/models/decode.py `_cached_attention` (one position for every
// row), B8.  For each (slot s, head h), with n = pos[s] + 1 live keys:
//
//     s_j = (q . k_j) / sqrt(D)          float32, j < n
//     w_j = exp(s_j - max s) / sum exp   float32
//     o   = sum_j w_j v_j                float32, cast to q's type
//
// q is one row per (slot, head), [S, H, 1, D] in the compute type; the
// caches are [S, H, L, D] in the cache type (bf16 or float32, each may be
// either).  Keys at j >= n are never read: a stale row left by a slot's
// previous occupant, or the zeros of a grown cache, contributes exactly
// nothing, as the reference's exact-zero softmax weights do.  The reference
// divides the scores by sqrt(D) (not a folded multiply), and so does this
// kernel.  pos stays on the device (int32 [S]); the host never reads it.
//
// What bounds it on an H100: bytes.  Every live K and V row is read once
// (2 * n * D elements per (s, h)) against 4 * n * D operations: about one
// operation per byte in bf16, far below the ~295 at which the tensor
// cores would be the limit.  At [8, 8, 512, 64] bf16 with every pos at 511
// the call moves 8.39 MB, 2.5 us at 3.35 TB/s.
//
// Design (the first, simple one): one block of 256 threads per (s, h).
//  1. Scores.  A row of D elements is read by D / VEC lanes, VEC elements
//     (16 bytes) each, so a warp reads 32 / (D / VEC) rows at once with
//     coalesced 16-byte loads; the row's dot product meets over its lanes
//     by xor-shuffles.  Each score goes to shared memory (4 bytes per key
//     of the cache length L).
//  2. The block's max, then p_j = exp(s_j - max) in place and their sum,
//     each by a warp shuffle tree and one pass over the 8 warps' partials.
//  3. P.V.  The same row layout: each lane accumulates p_j * v_j over its
//     VEC elements of D; the row groups of a warp meet by xor-shuffles, the
//     8 warps in shared memory, and o = acc / sum is written in q's type.
// Not yet done (later work): splitting L over several blocks when S * H is
// below the 132 SMs, and fusing the append of the new k and v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of a cache row, loaded as one 16-byte piece, in float32
template <typename TC>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 f = __bfloat1622float2(b);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                        const TC* __restrict__ v, TQ* __restrict__ o,
                        const int* __restrict__ pos, int H, int L,
                        long long sqs, long long sqh, long long sks,
                        long long skh, long long svs, long long svh) {
  constexpr int VEC = Vec<TC>::N;
  constexpr int LPR = D / VEC;            // lanes per cache row
  constexpr int RPW = 32 / LPR;           // rows a warp reads at once
  constexpr int STEP = WARPS * RPW;       // rows the block reads at once
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "layout");

  extern __shared__ float scores[];       // [L]
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][D];

  const int s = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane / LPR;               // this lane's row in a warp step
  const int d0 = (lane % LPR) * VEC;      // its first element of D

  int p = pos[s];
  p = p < 0 ? 0 : (p >= L ? L - 1 : p);
  const int n = p + 1;

  const TQ* qrow = q + s * sqs + h * sqh;
  const TC* kb = k + s * sks + h * skh;
  const TC* vb = v + s * svs + h * svh;
  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] = to_float(qrow[d0 + e]);
  const float sqrt_d = sqrtf(static_cast<float>(D));

  // 1. scores of the live keys, and this thread's max of them
  float m = -INFINITY;
#pragma unroll 4
  for (int base = warp * RPW; base < n; base += STEP) {
    const int j = base + r;
    float kv[VEC];
    if (j < n) {
      Vec<TC>::load(kb + static_cast<long long>(j) * D + d0, kv);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kv[e] = 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kv[e], dot);
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (j < n) {
      const float sc = dot / sqrt_d;
      if (lane % LPR == 0) scores[j] = sc;
      m = fmaxf(m, sc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();                        // red is reused below

  // 2. p_j = exp(s_j - max) in place, and their sum
  float l = 0.f;
  for (int j = tid; j < n; j += THREADS) {
    const float e = expf(scores[j] - m);
    scores[j] = e;
    l += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) red[warp] = l;
  __syncthreads();                        // also publishes every p_j
  l = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l += red[w];

  // 3. acc = sum_j p_j v_j over this lane's VEC elements of D
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int base = warp * RPW; base < n; base += STEP) {
    const int j = base + r;
    if (j < n) {
      float vv[VEC];
      Vec<TC>::load(vb + static_cast<long long>(j) * D + d0, vv);
      const float pj = scores[j];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
  }
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[warp][d0 + e] = acc[e];
  }
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][tid];
    o[static_cast<long long>(blockIdx.x) * D + tid] =
        from_float<TQ>(sum / l);
  }
}

template <typename TQ, typename TC, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos, int S, int H, int L, long long sqs, long long sqh,
           long long sks, long long skh, long long svs, long long svh,
           cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TC, D>;
  const size_t smem = static_cast<size_t>(L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<S * H, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<TQ*>(o), pos, H, L, sqs, sqh,
      sks, skh, svs, svh);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             const int* pos, int S, int H, int L, long long sqs,
             long long sqh, long long sks, long long skh, long long svs,
             long long svh, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<TQ, TC, 16>(q, k, v, o, pos, S, H, L, sqs, sqh, sks, skh,
                                svs, svh, stream);
    case 32:
      return launch<TQ, TC, 32>(q, k, v, o, pos, S, H, L, sqs, sqh, sks, skh,
                                svs, svh, stream);
    case 64:
      return launch<TQ, TC, 64>(q, k, v, o, pos, S, H, L, sqs, sqh, sks, skh,
                                svs, svh, stream);
    case 128:
      return launch<TQ, TC, 128>(q, k, v, o, pos, S, H, L, sqs, sqh, sks,
                                 skh, svs, svh, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [S, H, 1, D] with strides (sqs, sqh, -, 1); k, v: [S, H, L, D] with
// strides (s*s, s*h, D, 1), 16-byte aligned bases and (s, h) strides;
// o: contiguous [S, H, 1, D] of q's type; pos: int32 [S] on the device.
// q_bf16 / cache_bf16 pick bf16 (1) or float32 (0).  Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int bigdl_decode_attention(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    int q_bf16, int cache_bf16, int S, int H, int L, int D, long long sqs,
    long long sqh, long long sks, long long skh, long long svs,
    long long svh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && cache_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k, v, o, pos, S, H, L, sqs, sqh, sks, skh, svs, svh, st);
  if (q_bf16)
    return launch_d<__nv_bfloat16, float>(D, q, k, v, o, pos, S, H, L, sqs,
                                          sqh, sks, skh, svs, svh, st);
  if (cache_bf16)
    return launch_d<float, __nv_bfloat16>(D, q, k, v, o, pos, S, H, L, sqs,
                                          sqh, sks, skh, svs, svh, st);
  return launch_d<float, float>(D, q, k, v, o, pos, S, H, L, sqs, sqh, sks,
                                skh, svs, svh, st);
}
