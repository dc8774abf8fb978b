// Training-mode BatchNorm kernels for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces four Pallas TPU kernels of bigdl_tpu/ops/batchnorm.py, all over
// x viewed as [R, C] (rows = every leading axis, channels last):
//  - B1 `_fwd_kernel` (`_bn_fwd_pallas`): per-channel float32 sums
//    (Σx, Σx²), mean = Σx/R, biased var = Σx²/R − mean² (one pass, not
//    Welford, no clamp), then y = x·scale + shift with scale = w·inv,
//    shift = b − mean·scale, inv = 1/sqrt(var + eps), computed in float32
//    and cast to x's dtype.  Returns (y, mean, var).
//  - B2 `_bwd_kernel` (`_bn_bwd_pallas`): sdy = Σdy, sdyx = Σdy·x̂ with
//    x̂ = (x − mean)·inv, then dx = w·inv·(dy − sdy/R − x̂·sdyx/R) in float32,
//    cast to x's dtype.  Returns (dx, sdy, sdyx); the caller casts the sums
//    to dγ = sdyx and dβ = sdy.
//  - B3 `_stat_kernel` (`_bn_stats_pallas`): the per-shard float32 (Σx,
//    Σx²) of sync-BN's forward, all-reduced over the data group by the
//    caller.  It is B1's statistics phase on its own: the same fixed-order
//    partials and finish, so B3's sums give B1's mean and var bit for bit.
//  - B4 `_grad_stat_kernel` (`_bn_grad_stats_pallas`): the (Σdy, Σdy·x̂)
//    pass of B2 alone; the fused conv-BN backward (ops/convbn.py) and
//    sync-BN's backward use it.
//
// Design (first, simple version).  The TPU kernels carry (Σ, Σ²) across a
// sequential grid in VMEM scratch; blocks on the card run in no order, so
// every reduction is split in two fixed-order passes instead of atomics:
//  1. stats: a grid of (row chunk, 32-channel tile) blocks of 32 x 8
//     threads.  Lane x owns one channel, the 8 row lanes stride the chunk's
//     rows, and the 8 row-lane sums meet in shared memory in a fixed order.
//     Each block writes one float32 partial per channel: [2, n_chunks, C].
//  2. finish: one block per 32-channel tile sums the partials over the
//     chunks, again 8 row lanes and a fixed-order tree, and turns the sums
//     into per-channel coefficients (mean, var, scale, shift for B1; the
//     sums and dx coefficients for B2; the sums alone for B3 and B4).
//  3. B1 and B2 then run one elementwise pass over [R, C] with a
//     grid-stride loop that advances each thread's channel incrementally
//     (no 64-bit modulo per element).
// No float atomics, and the chunking depends on the shape only, so results
// are bit-reproducible from run to run.  Rows past R are never read: there is
// no host padding.  All offsets are 64-bit (R·C reaches 2·10^8 in
// ResNet-50's stem at batch 256).
//
// What bounds it on an H100: bytes.  B1 reads x twice and writes y once,
// as on the TPU; B2 reads (x, dy) twice and writes dx once; B3 reads x
// once; B4 reads (x, dy) once.  The per-channel partials are a few MB at most.  This version loads
// one element per thread per row (2 bytes in bf16), so it does not reach the
// memory rate at narrow widths; 16-byte vector loads are the way there and
// are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;  // channels per block, one per lane
constexpr int TY = 8;   // row lanes per block
constexpr int THREADS = TX * TY;
constexpr int EW_THREADS = 256;  // elementwise passes
constexpr int EW_MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Fixed-order sum of the TY row lanes' values of (a, b) for channel lane
// threadIdx.x; the result is valid in row lane 0.
__device__ __forceinline__ void lane_sum(float& a, float& b) {
  __shared__ float sa[TY][TX];
  __shared__ float sb[TY][TX];
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0) {
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int i = 0; i < TY; ++i) {
      a += sa[i][threadIdx.x];
      b += sb[i][threadIdx.x];
    }
  }
}

// Pass 1 of B1: partial (Σx, Σx²) of one row chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
x_stats_kernel(const T* __restrict__ x, long long R, int C,
               long long rows_per_chunk, int n_chunks,
               float* __restrict__ part) {
  const int c = blockIdx.y * TX + threadIdx.x;
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f, ss = 0.f;
  if (c < C) {
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += TY) {
      const float v = load_f32(x + r * C + c);
      s += v;
      ss += v * v;
    }
  }
  lane_sum(s, ss);
  if (threadIdx.y == 0 && c < C) {
    part[static_cast<long long>(blockIdx.x) * C + c] = s;
    part[static_cast<long long>(n_chunks + blockIdx.x) * C + c] = ss;
  }
}

// Pass 1 of B2 and B4: partial (Σdy, Σdy·x̂) of one row chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv, long long R, int C,
                  long long rows_per_chunk, int n_chunks,
                  float* __restrict__ part) {
  const int c = blockIdx.y * TX + threadIdx.x;
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f, ss = 0.f;
  if (c < C) {
    const float m = mean[c], iv = inv[c];
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += TY) {
      const float g = load_f32(dy + r * C + c);
      const float xhat = (load_f32(x + r * C + c) - m) * iv;
      s += g;
      ss += g * xhat;
    }
  }
  lane_sum(s, ss);
  if (threadIdx.y == 0 && c < C) {
    part[static_cast<long long>(blockIdx.x) * C + c] = s;
    part[static_cast<long long>(n_chunks + blockIdx.x) * C + c] = ss;
  }
}

enum Finish { kForward = 0, kBackward = 1, kSums = 2 };

// Pass 2: sum the partials over the chunks and finish each channel.
//  kForward:  out0 = mean, out1 = var, coef = [scale | shift]
//  kBackward: out0 = sdy, out1 = sdyx, coef = [w·inv | sdy | sdyx]
//  kSums:     out0 = the first sum, out1 = the second (Σx, Σx² for B3;
//             Σdy, Σdy·x̂ for B4)
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ part, int n_chunks, int C,
              long long R, int mode, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ inv,
              float eps, float* __restrict__ out0, float* __restrict__ out1,
              float* __restrict__ coef) {
  const int c = blockIdx.x * TX + threadIdx.x;
  float s = 0.f, ss = 0.f;
  if (c < C) {
    for (int k = threadIdx.y; k < n_chunks; k += TY) {
      s += part[static_cast<long long>(k) * C + c];
      ss += part[static_cast<long long>(n_chunks + k) * C + c];
    }
  }
  lane_sum(s, ss);
  if (threadIdx.y != 0 || c >= C) return;
  const float n = static_cast<float>(R);
  if (mode == kForward) {
    const float mean = s / n;
    const float var = __fsub_rn(ss / n, __fmul_rn(mean, mean));
    const float iv = 1.f / sqrtf(var + eps);
    const float scale = __fmul_rn(w[c], iv);
    out0[c] = mean;
    out1[c] = var;
    coef[c] = scale;
    coef[C + c] = __fsub_rn(b[c], __fmul_rn(mean, scale));
    return;
  }
  out0[c] = s;
  out1[c] = ss;
  if (mode == kBackward) {
    coef[c] = __fmul_rn(w[c], inv[c]);
    coef[C + c] = s;
    coef[2 * C + c] = ss;
  }
}

// Pass 3 of B1: y = x·scale + shift.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ coef, long long n, int C) {
  long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * EW_THREADS;
  int c = static_cast<int>(i % C);
  const int dc = static_cast<int>(stride % C);
  for (; i < n; i += stride) {
    store_f32(y + i, load_f32(x + i) * coef[c] + coef[C + c]);
    c += dc;
    if (c >= C) c -= C;
  }
}

// Pass 3 of B2: dx = w·inv·(dy − sdy/R − x̂·sdyx/R), the TPU kernel's
// expression and evaluation order.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
          const float* __restrict__ mean, const float* __restrict__ inv,
          const float* __restrict__ coef, T* __restrict__ dx, long long n,
          int C, float rows) {
  long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * EW_THREADS;
  int c = static_cast<int>(i % C);
  const int dc = static_cast<int>(stride % C);
  for (; i < n; i += stride) {
    const float xhat = __fmul_rn(load_f32(x + i) - mean[c], inv[c]);
    const float t = __fsub_rn(load_f32(dy + i), coef[C + c] / rows);
    const float u = __fmul_rn(xhat, coef[2 * C + c]) / rows;
    store_f32(dx + i, __fmul_rn(coef[c], __fsub_rn(t, u)));
    c += dc;
    if (c >= C) c -= C;
  }
}

int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS);
}

template <typename T>
int forward(const void* x, const float* w, const float* b, void* y,
            float* mean, float* var, float* part, float* coef, long long R,
            int C, float eps, int n_chunks, long long rows_per_chunk,
            cudaStream_t st) {
  const dim3 block(TX, TY);
  x_stats_kernel<T><<<dim3(n_chunks, (C + TX - 1) / TX), block, 0, st>>>(
      static_cast<const T*>(x), R, C, rows_per_chunk, n_chunks, part);
  finish_kernel<<<(C + TX - 1) / TX, block, 0, st>>>(
      part, n_chunks, C, R, kForward, w, b, nullptr, eps, mean, var, coef);
  const long long n = R * C;
  normalize_kernel<T><<<ew_blocks(n), EW_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), coef, n, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int x_sums(const void* x, float* sum, float* sumsq, float* part, long long R,
           int C, int n_chunks, long long rows_per_chunk, cudaStream_t st) {
  const dim3 block(TX, TY);
  x_stats_kernel<T><<<dim3(n_chunks, (C + TX - 1) / TX), block, 0, st>>>(
      static_cast<const T*>(x), R, C, rows_per_chunk, n_chunks, part);
  finish_kernel<<<(C + TX - 1) / TX, block, 0, st>>>(
      part, n_chunks, C, R, kSums, nullptr, nullptr, nullptr, 0.f, sum,
      sumsq, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grad_sums(const void* x, const void* dy, const float* mean,
              const float* inv, const float* w, float* sdy, float* sdyx,
              float* part, float* coef, long long R, int C, int n_chunks,
              long long rows_per_chunk, int mode, cudaStream_t st) {
  const dim3 block(TX, TY);
  grad_stats_kernel<T><<<dim3(n_chunks, (C + TX - 1) / TX), block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, R, C,
      rows_per_chunk, n_chunks, part);
  finish_kernel<<<(C + TX - 1) / TX, block, 0, st>>>(
      part, n_chunks, C, R, mode, w, nullptr, inv, 0.f, sdy, sdyx, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* dy, const float* mean,
             const float* inv, const float* w, void* dx, float* sdy,
             float* sdyx, float* part, float* coef, long long R, int C,
             int n_chunks, long long rows_per_chunk, cudaStream_t st) {
  int err = grad_sums<T>(x, dy, mean, inv, w, sdy, sdyx, part, coef, R, C,
                         n_chunks, rows_per_chunk, kBackward, st);
  if (err) return err;
  const long long n = R * C;
  dx_kernel<T><<<ew_blocks(n), EW_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, coef,
      static_cast<T*>(dx), n, C, static_cast<float>(R));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long R, int C, int n_chunks, long long rows_per_chunk) {
  return R <= 0 || C <= 0 || C > 65535 * TX || n_chunks <= 0 ||
         rows_per_chunk <= 0 ||
         static_cast<long long>(n_chunks) * rows_per_chunk < R;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy, dx); w, b, mean, var, inv and
// the sums are float32.  part is float32 scratch of 2·n_chunks·C; coef is
// float32 scratch of 2·C (forward) or 3·C (backward).  Row chunk k covers
// rows [k·rows_per_chunk, (k+1)·rows_per_chunk) ∩ [0, R).  Each entry
// returns cudaGetLastError() after its launches, or cudaErrorInvalidValue
// for a dtype or shape it does not take.
extern "C" int bigdl_bn_forward(const void* x, const float* w,
                                const float* b, void* y, float* mean,
                                float* var, float* part, float* coef,
                                int dtype, long long R, int C, float eps,
                                int n_chunks, long long rows_per_chunk,
                                void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, w, b, y, mean, var, part, coef, R, C, eps,
                          n_chunks, rows_per_chunk, st);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, w, b, y, mean, var, part, coef, R, C,
                                  eps, n_chunks, rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_bn_backward(const void* x, const void* dy,
                                 const float* mean, const float* inv,
                                 const float* w, void* dx, float* sdy,
                                 float* sdyx, float* part, float* coef,
                                 int dtype, long long R, int C, int n_chunks,
                                 long long rows_per_chunk, void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, dy, mean, inv, w, dx, sdy, sdyx, part, coef, R,
                           C, n_chunks, rows_per_chunk, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, dy, mean, inv, w, dx, sdy, sdyx, part,
                                   coef, R, C, n_chunks, rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_bn_grad_stats(const void* x, const void* dy,
                                   const float* mean, const float* inv,
                                   float* sdy, float* sdyx, float* part,
                                   int dtype, long long R, int C,
                                   int n_chunks, long long rows_per_chunk,
                                   void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grad_sums<float>(x, dy, mean, inv, nullptr, sdy, sdyx, part,
                            nullptr, R, C, n_chunks, rows_per_chunk, kSums,
                            st);
  if (dtype == 1)
    return grad_sums<__nv_bfloat16>(x, dy, mean, inv, nullptr, sdy, sdyx,
                                    part, nullptr, R, C, n_chunks,
                                    rows_per_chunk, kSums, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_bn_stats(const void* x, float* sum, float* sumsq,
                              float* part, int dtype, long long R, int C,
                              int n_chunks, long long rows_per_chunk,
                              void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return x_sums<float>(x, sum, sumsq, part, R, C, n_chunks, rows_per_chunk,
                         st);
  if (dtype == 1)
    return x_sums<__nv_bfloat16>(x, sum, sumsq, part, R, C, n_chunks,
                                 rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
