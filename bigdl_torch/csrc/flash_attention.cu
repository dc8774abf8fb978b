// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bigdl_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_pallas`): o = softmax(q k^T * scale [causal mask]) v over
// q, k, v of shape [B, H, T, D], with an online softmax over key tiles and
// float32 running statistics (m, l) and accumulator, so the [Tq, Tk] score
// matrix never reaches device memory.  Rows whose every key is masked give 0.
//
// Design (first, simple version):
//  - grid = (query tiles of BQ rows, B*H).  Each block walks the key tiles
//    itself, in order, which is what the TPU got from its sequential third
//    grid axis.  Under the causal mask a block stops at the last key tile
//    that reaches its diagonal (the Pallas kernel's `run` predicate).
//  - Q, K and V tiles are staged in shared memory as float32 (bf16 inputs
//    widen on load).  s, m, l and the output accumulator stay in float32
//    registers; p goes through shared memory in float32 for the P.V product,
//    exactly as the Pallas kernel keeps p in float32.
//  - 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//    4*ty .. 4*ty+3, score columns tx + 16*j and output columns tx + 16*c.
//    Row max and row sum reduce over the 16 lanes of a half-warp with
//    shuffles.  K rows are padded by one float so the 16 lanes reading 16
//    different key rows hit 16 different banks.
//  - Ragged Tq and Tk are handled by bounds checks in the kernel: rows past
//    Tq are computed on zeros and never stored, keys past Tk are masked to
//    -inf.  Nothing is padded on the host.
//  - Operands are read, and the output written, through their strides over
//    (B, H, T); the last axis must be unit-stride.  MultiHeadAttention hands
//    over transposed [B, H, T, D] views of its [B, T, H, D] projections and
//    the wrapper allocates the output in [B, T, H, D] memory order, so no
//    operand is copied: a .contiguous() of each of q, k, v and o would read
//    and write B*T*E elements, 4 x 8.4 MB per layer at bf16 [8, 512, 512].
//
// What bounds it on an H100: by the roofline, bytes.  At [8, 8, 512, 64]
// bf16 causal the call must move 16.8 MB (about 5 us at 3.35 TB/s) against
// 2.15 GFLOP of causal work (about 2.2 us at 989 TFLOP/s on the tensor
// cores).  This design computes both products with float32 FMAs on the CUDA
// cores (67 TFLOP/s peak), issued from shared memory, so it is bound by FMA
// and shared-memory issue, well above the byte bound.  It trades that for
// parity: p stays float32 into the P.V product, as in the reference.  The
// way down to the byte bound is bf16 tensor-core products (mma.sync or
// wgmma) with TMA-fed tiles, which changes where p is rounded and is left to
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int ROWS = BQ / 16; // query rows per thread
constexpr int COLS = BK / 16; // score columns per thread
constexpr int PS = BK + 4;    // padded row stride of the p tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, t;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Tq,
                 int Tk, Strides sq, Strides sk, Strides sv, Strides so,
                 float sm_scale, int causal) {
  constexpr int QS = D + 1;  // padded row stride of the Q and K tiles
  constexpr int DC = D / 16; // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * QS;
  float* vs = ks + BK * QS;
  float* ps = vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    qs[r * QS + c] = qi < Tq ? load_f32(qb + qi * sq.t + c) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles that start past this block's last row contribute
  // nothing (kj > qi for every pair), so the walk stops before them
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and p are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool in = kj < Tk;
      ks[r * QS + c] = in ? load_f32(kb + kj * sk.t + c) : 0.f;
      vs[r * D + c] = in ? load_f32(vb + kj * sv.t + c) : 0.f;
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(ty * ROWS + i) * QS + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (kj >= Tk || (causal && kj > qi)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // exp(-inf - -inf) would be NaN: a row with nothing unmasked yet keeps
      // alpha = 0 and p = 0
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * ROWS + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole p tile is written

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(ty * ROWS + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Tq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked rows -> 0
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f32(ob + qi * so.t + tx + 16 * c, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
           Strides so, float sm_scale, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Tq, Tk, sq, sk, sv,
      so, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int Tq, int Tk, Strides sq, Strides sk,
               Strides sv, Strides so, float sm_scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Tq, Tk, sq, sk, sv, so,
                           sm_scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Tq, Tk, sq, sk, sv, so,
                           sm_scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Tq, Tk, sq, sk, sv, so,
                            sm_scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the B, H
// and T axes of each operand (the D axis is unit-stride).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dimension or dtype without an instance.
extern "C" int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, float sm_scale, int causal,
    void* stream) {
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      so{sob, soh, sot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, Tq, Tk, sq, sk, sv, so,
                             sm_scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Tq, Tk, sq, sk, sv,
                                     so, sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
