// Matrix product with BatchNorm statistics in its epilogue, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces bigdl_tpu/ops/convbn.py `_mm_stats_kernel` (launched by
// `matmul_stats`, B5): y = x[R, K] @ w[K, C] (+ bias[C]) with float32
// accumulation, written in x's dtype, and the per-column float32 sums
// Σy and Σy² taken from the float32 accumulator (bias added) before the
// cast.  Rows past R do not enter the sums.  ResNet's 1x1 stride-1
// convolutions are this product over the flattened NHWC rows, so a
// following BatchNorm needs no separate pass over y for its statistics.
//
// Design (simple versions, one per dtype; both tile the output in blocks
// of 128 rows, which fixes the partial-sum layout below):
//  - bf16: a tensor-core kernel.  grid = (row tiles of 128, column tiles
//    of 128), 256 threads as 8 warps in a 2 x 4 grid, each warp owning a
//    64 x 32 piece of the tile as 4 x 4 `mma.sync.m16n8k16` bf16 products
//    with float32 accumulators (64 per thread).  K is walked in steps of
//    32: the x tile (row-major, rows padded by 8 bf16) and the w tile
//    (k-major, rows padded by 8 bf16) are staged in shared memory with
//    16-byte loads where the row is aligned and whole, element loads with
//    zero fill at ragged edges.  The paddings make the fragment loads free
//    of bank conflicts.  bf16 products are exact in float32, so only the
//    order of the float32 sums differs from the plain version.
//  - float32: the same product on the CUDA cores (parity with a float32
//    reference rules out TF32 tensor cores): 128 x 64 tiles, 256 threads
//    as 16 x 16, each thread 8 rows x 4 columns of float32 FMAs from a
//    k-major x tile and a w tile in shared memory, K in steps of 16.
//  - Ragged R, K and C are bounds-checked on load (zeros) and on store;
//    nothing is padded on the host.
//  - Epilogue, both kernels: add the bias in float32, store y in x's
//    dtype, and sum each column's valid rows (value and square) from the
//    float32 accumulators, then across the threads that share the column
//    in a fixed order (shuffles, then shared memory).  Each block writes
//    one partial per column: [2, n_row_tiles, C].  A second small kernel
//    sums the partials over the row tiles in a fixed order (no float
//    atomics), so the statistics are bit-reproducible.
//  - Offsets are 64-bit: R·K reaches 2·10^8 at ResNet-50's batch 256.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int RM = BM / 16;  // rows per thread
constexpr int RN = BN / 16;  // columns per thread
constexpr int TX = 32;       // partial-sum pass: columns per block
constexpr int TY = 8;        // partial-sum pass: row-tile lanes

// ---- float32: CUDA cores ----

__global__ void __launch_bounds__(THREADS)
mm_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ part, long long R, int K, int C,
                    int n_row_tiles) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  __shared__ float red_s[16][BN];
  __shared__ float red_ss[16][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM x BK, 16 consecutive k of one row per 16 threads
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / BK;
      const int k = e % BK;
      const long long gr = row0 + r;
      const int gk = k0 + k;
      As[k][r] = (gr < R && gk < K) ? x[gr * K + gk] : 0.f;
    }
    // w tile: BK x BN, one row of BN consecutive columns per 64 threads
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int k = e / BN;
      const int c = e % BN;
      const int gk = k0 + k;
      const int gc = col0 + c;
      Bs[k][c] =
          (gk < K && gc < C) ? w[static_cast<long long>(gk) * C + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  // epilogue: bias, store, per-column sums over this tile's valid rows
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int gc = col0 + tx + 16 * j;
    const float bj = (bias != nullptr && gc < C) ? bias[gc] : 0.f;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long gr = row0 + ty + 16 * i;
      const float v = acc[i][j] + bj;
      if (gr < R && gc < C) {
        y[gr * C + gc] = v;
        s += v;
        ss += v * v;
      }
    }
    red_s[ty][tx + 16 * j] = s;
    red_ss[ty][tx + 16 * j] = ss;
  }
  __syncthreads();
  if (tid < BN && col0 + tid < C) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      s += red_s[t][tid];
      ss += red_ss[t][tid];
    }
    const int gc = col0 + tid;
    part[static_cast<long long>(blockIdx.x) * C + gc] = s;
    part[static_cast<long long>(n_row_tiles + blockIdx.x) * C + gc] = ss;
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16, float32 accumulators) ----

constexpr int TBM = 128;          // rows per block (= BM: same partials)
constexpr int TBN = 128;          // columns per block
constexpr int TBK = 32;           // K per shared-memory stage
constexpr int WM = 64;            // rows per warp
constexpr int WN = 32;            // columns per warp
constexpr int MI = WM / 16;       // m16 tiles per warp
constexpr int NI = WN / 8;        // n8 tiles per warp
constexpr int XS = TBK + 8;       // padded x-tile row, bf16
constexpr int WS = TBN + 8;       // padded w-tile row, bf16

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 8 consecutive bf16 of a row from global memory into shared memory:
// one 16-byte load when all 8 lie inside the row and the address is
// aligned, else element loads with zeros past the edge.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool row_ok,
                                       int col, int ncols, bool vec) {
  if (row_ok && vec && col + 8 <= ncols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (row_ok && col + e < ncols) ? src[e] : __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(THREADS)
mm_stats_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   long long R, int K, int C, int n_row_tiles) {
  __shared__ __align__(16) __nv_bfloat16 Xs[TBM][XS];
  __shared__ __align__(16) __nv_bfloat16 Ws[TBK][WS];
  __shared__ float red_s[2][TBN];
  __shared__ float red_ss[2][TBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * TBM;
  const int col0 = blockIdx.y * TBN;
  const bool vec_x =
      K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w =
      C % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TBK) {
    // x tile: TBM rows x TBK = 512 chunks of 8, two per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + THREADS * i;
      const int r = e >> 2;
      const int kc = (e & 3) * 8;
      const long long gr = row0 + r;
      stage8(&Xs[r][kc], x + gr * K + k0 + kc, gr < R, k0 + kc, K, vec_x);
    }
    // w tile: TBK rows x TBN = 512 chunks of 8, two per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + THREADS * i;
      const int k = e >> 4;
      const int nc = (e & 15) * 8;
      const int gk = k0 + k;
      stage8(&Ws[k][nc], w + static_cast<long long>(gk) * C + col0 + nc,
             gk < K, col0 + nc, C, vec_w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * WM + mi * 16 + gid;
        const int k = kk + tig * 2;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&Xs[r][k]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][k]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&Xs[r][k + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][k + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn * WN + ni * 8 + gid;
        const int k = kk + tig * 2;
        b[ni][0] = pack2(Ws[k][n], Ws[k + 1][n]);
        b[ni][1] = pack2(Ws[k + 8][n], Ws[k + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: thread holds rows wm*64 + mi*16 + gid (+8), columns
  // wn*32 + ni*8 + tig*2 (+1) of the tile
  float s[NI][2], ss[NI][2], bj[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gc = col0 + wn * WN + ni * 8 + tig * 2 + j;
      bj[ni][j] = (bias != nullptr && gc < C) ? bias[gc] : 0.f;
      s[ni][j] = 0.f;
      ss[ni][j] = 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gr = row0 + wm * WM + mi * 16 + gid + 8 * h;
      if (gr >= R) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int gc = col0 + wn * WN + ni * 8 + tig * 2;
        const float v0 = acc[mi][ni][2 * h] + bj[ni][0];
        const float v1 = acc[mi][ni][2 * h + 1] + bj[ni][1];
        __nv_bfloat16* out = y + gr * C + gc;
        if (gc + 1 < C && C % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (gc < C) out[0] = __float2bfloat16(v0);
          if (gc + 1 < C) out[1] = __float2bfloat16(v1);
        }
        if (gc < C) {
          s[ni][0] += v0;
          ss[ni][0] += v0 * v0;
        }
        if (gc + 1 < C) {
          s[ni][1] += v1;
          ss[ni][1] += v1 * v1;
        }
      }
    }
  // sum over the 8 row groups of the warp (lanes that differ in gid)
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[ni][j] += __shfl_xor_sync(0xffffffffu, s[ni][j], off);
        ss[ni][j] += __shfl_xor_sync(0xffffffffu, ss[ni][j], off);
      }
  if (gid == 0) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * WN + ni * 8 + tig * 2 + j;
        red_s[wm][c] = s[ni][j];
        red_ss[wm][c] = ss[ni][j];
      }
  }
  __syncthreads();
  if (tid < TBN && col0 + tid < C) {
    const int gc = col0 + tid;
    part[static_cast<long long>(blockIdx.x) * C + gc] =
        red_s[0][tid] + red_s[1][tid];
    part[static_cast<long long>(n_row_tiles + blockIdx.x) * C + gc] =
        red_ss[0][tid] + red_ss[1][tid];
  }
}

// Σ over the row tiles of the [2, n_row_tiles, C] partials, fixed order.
__global__ void __launch_bounds__(TX * TY)
column_sums_kernel(const float* __restrict__ part, int n_row_tiles, int C,
                   float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float sa[TY][TX];
  __shared__ float sb[TY][TX];
  const int c = blockIdx.x * TX + threadIdx.x;
  float s = 0.f, ss = 0.f;
  if (c < C) {
    for (int t = threadIdx.y; t < n_row_tiles; t += TY) {
      s += part[static_cast<long long>(t) * C + c];
      ss += part[static_cast<long long>(n_row_tiles + t) * C + c];
    }
  }
  sa[threadIdx.y][threadIdx.x] = s;
  sb[threadIdx.y][threadIdx.x] = ss;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    s = 0.f;
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < TY; ++i) {
      s += sa[i][threadIdx.x];
      ss += sb[i][threadIdx.x];
    }
    sum[c] = s;
    sumsq[c] = ss;
  }
}

int launch(const void* x, const void* w, const float* bias, void* y,
           float* sum, float* sumsq, float* part, int dtype, long long R,
           int K, int C, cudaStream_t st) {
  const int n_row_tiles = static_cast<int>((R + BM - 1) / BM);
  if (dtype == 0) {
    mm_stats_f32_kernel<<<dim3(n_row_tiles, (C + BN - 1) / BN), THREADS, 0,
                          st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(y), part, R, K, C, n_row_tiles);
  } else {
    mm_stats_tc_kernel<<<dim3(n_row_tiles, (C + TBN - 1) / TBN), THREADS, 0,
                         st>>>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(w), bias,
                               static_cast<__nv_bfloat16*>(y), part, R, K,
                               C, n_row_tiles);
  }
  column_sums_kernel<<<(C + TX - 1) / TX, dim3(TX, TY), 0, st>>>(
      part, n_row_tiles, C, sum, sumsq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, y); bias (may be null), sum and
// sumsq are float32.  part is float32 scratch of 2·ceil(R/128)·C.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// dtype or shape it does not take.
extern "C" int bigdl_matmul_stats(const void* x, const void* w,
                                  const float* bias, void* y, float* sum,
                                  float* sumsq, float* part, int dtype,
                                  long long R, int K, int C, void* stream) {
  if (R <= 0 || K <= 0 || C <= 0 || (R + BM - 1) / BM > 0x7fffffffLL ||
      (C + BN - 1) / BN > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, bias, y, sum, sumsq, part, dtype, R, K, C,
                static_cast<cudaStream_t>(stream));
}
