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
// What bounds it on an H100: at most of ResNet-50's shapes, bytes (x read
// and y written once: [802816, 256] x [256, 128] moves 616 MB, 0.184 ms
// at 3.35 TB/s, against 0.053 ms of bf16 tensor-core work); the widest
// (K, C) = (1024, 512), (512, 2048), (2048, 512) are above the ridge and
// bound by the tensor cores.  So loads must stream back to back, and the
// products must run at the wgmma rate.
//
// Every route writes float32 partial column sums, [2, n, C] (n = one row
// per 128-row tile, or per block for "tc"), and a second small kernel
// sums them over n in a fixed order (no float atomics), so the statistics
// are bit-reproducible.  Offsets are 64-bit: R·K reaches 2·10^8.
//
// Routes, chosen by the wrapper from dtype, shapes and alignment:
//  - "tc" (bf16, base 16-byte aligned, K and C multiples of 8: what TMA can
//    describe): `mm_stats_wgmma_kernel`.  Persistent: one block per SM
//    keeps one column tile and walks its share of the row tiles.  A
//    producer warp loads x tiles [128 rows x 64 K] and w tiles [64 K x BN]
//    by TMA (128-byte swizzle; the K, R and C edges arrive as zeros) into
//    a ring of 4 stages with full / empty barriers, running ahead into the
//    next tile while the consumers finish this one.  Two consumer
//    warpgroups each own 64 rows x BN columns and run wgmma m64nBNk16 (x
//    K-major, w MN-major), keeping one stage's products in flight.  BN =
//    64 for C <= 64, so those sites use no half-empty tile, and 128
//    otherwise.  (BN = 256 holds 128 accumulators a thread and spilled
//    under the 168 registers a thread such a block is compiled for.)
//    Epilogue: add the bias in float32; stage y as bf16 in shared memory in
//    the swizzled layout (no bank conflicts) and write it with TMA stores
//    in full lines (rows past R are dropped); sum each column's valid rows,
//    value and square, within the thread, then over the 8 row groups of a
//    warp by a reduce-scatter of shuffles (7 a value instead of 24), into
//    running sums over the block's tiles; at the block's end over the 8
//    warps through shared memory: one partial row per block, in a fixed
//    order.
//  - "mma_sync" (bf16 that TMA cannot describe, e.g. K = 19): the first
//    tensor-core version.  grid = (row tiles of 128, column tiles of 128),
//    256 threads as 8 warps in a 2 x 4 grid, each warp owning a 64 x 32
//    piece of the tile as 4 x 4 `mma.sync.m16n8k16` bf16 products with
//    float32 accumulators.  K is walked in steps of 32 through one
//    shared-memory stage filled by 16-byte loads where the row is aligned
//    and whole, element loads with zero fill at ragged edges; the paddings
//    make the fragment loads free of bank conflicts.
//  - "f32" (float32): the same product on the CUDA cores (parity with a
//    float32 reference rules out TF32 tensor cores): 128 x 64 tiles, 256
//    threads as 16 x 16, each thread 8 rows x 4 columns of float32 FMAs
//    from a k-major x tile and a w tile in shared memory, K in steps of 16.
//  - The last two bounds-check ragged R, K and C on load (zeros) and on
//    store; nothing is padded on the host.  bf16 products are exact in
//    float32, so only the order of the float32 sums differs from the plain
//    version.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
mm_stats_mma_sync_kernel(const __nv_bfloat16* __restrict__ x,
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

// Σ over the n_row_tiles rows of the [2, n_row_tiles, C] partials, in a
// fixed order.
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

// ---- bf16: wgmma fed by TMA, persistent (route "tc") ----------------------

namespace tc {

constexpr int BM = 128;  // rows per tile
constexpr int BKK = 64;  // K per stage: one 128-byte swizzled row of x
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // + the producer warp

template <int BN>
struct Layout {
  static constexpr int STAGES = 4;
  static constexpr int XT = BM * BKK * 2;  // x tile: 128 rows x 128 bytes
  static constexpr int WC = BKK * 64 * 2;  // a 64-column chunk of a w tile
  static constexpr int STAGE = XT + WC * (BN / 64);
  static constexpr int YC = 64 * 64 * 2;  // a 64 x 64 chunk of y
  static constexpr int Y = 2 * YC * (BN / 64);  // both warpgroups' rows
  static constexpr int RED = 2 * CONSUMER_WARPS * BN * 4;  // Σ, Σ² a warp
  static constexpr int SMEM = 1024 + STAGES * STAGE + Y + RED + 16 * STAGES;
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// Σ over the 8 lanes of a warp that share q4 (they differ in g, lane bits
// 2..4) of 16 values, by halving: afterwards lane g holds the sums of
// values 2g and 2g + 1 in v[0], v[1].
__device__ __forceinline__ void reduce_rows(float (&v)[16], int g) {
  {
    const bool hi = g & 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = hi ? v[i] : v[i + 8];
      const float keep = hi ? v[i + 8] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  {
    const bool hi = g & 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = hi ? v[i] : v[i + 4];
      const float keep = hi ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
  {
    const bool hi = g & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = hi ? v[i] : v[i + 2];
      const float keep = hi ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
  }
}

// Block b keeps one column tile, ct = b % n_col_tiles, and walks the row
// tiles p, p + P, p + 2P, ... with p = b / n_col_tiles and P blocks per
// column tile.  It sums its rows' statistics in registers over all its
// tiles, in order, and writes one partial row per column: part[2, P, C].
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
mm_stats_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw,
                      const __grid_constant__ CUtensorMap my,
                      const float* __restrict__ bias,
                      float* __restrict__ part, long long R, int K, int C,
                      int n_row_tiles, int n_col_tiles, int P) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ys = stages + L::STAGES * L::STAGE;
  float* red_s = reinterpret_cast<float*>(ys + L::Y);  // [warp][BN]
  float* red_ss = red_s + CONSUMER_WARPS * BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(red_ss + CONSUMER_WARPS * BN);
  uint64_t* empty = full + L::STAGES;

  const int ct = blockIdx.x % n_col_tiles;
  const int p = blockIdx.x / n_col_tiles;
  const int col0 = ct * BN;
  const int n_kb = (K + BKK - 1) / BKK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: one thread issues every load
    if (lane == 0) {
      int it = 0;
      for (int rt = p; rt < n_row_tiles; rt += P) {
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int s = it % L::STAGES;
          if (it >= L::STAGES)
            hopper::mbar_wait(&empty[s], (it / L::STAGES - 1) & 1);
          uint8_t* st = stages + s * L::STAGE;
          hopper::mbar_expect_tx(&full[s], L::STAGE);
          hopper::tma_load_2d(st, &mx, &full[s], kb * BKK, rt * BM);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_2d(st + L::XT + c * L::WC, &mw, &full[s],
                                col0 + 64 * c, kb * BKK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 63 of each tile; this
  // thread rows srow and srow + 8 of those, columns 8 j + 2 q4 (+1)
  const int wg = warp / 4;
  const int wl = warp % 4;
  const int g = lane / 4;
  const int q4 = lane % 4;
  const int srow = 16 * wl + g;
  const bool leader = wl == 0 && lane == 0;  // issues the warpgroup's stores
  uint8_t* yw = ys + wg * (L::Y / 2);
  float acc[BN / 2];
  // this lane's running column sums: columns 64 c + 8 g + 2 q4 (+1)
  float run_s[BN / 64][2], run_ss[BN / 64][2];
#pragma unroll
  for (int c = 0; c < BN / 64; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) run_s[c][e] = run_ss[c][e] = 0.f;
  int it = 0;
  for (int rt = p; rt < n_row_tiles; rt += P) {
    const long long row0 = static_cast<long long>(rt) * BM + 64 * wg;

    // main loop: one stage's products stay in flight while the next issue
    int prev = -1;
    for (int kb = 0; kb < n_kb; ++kb, ++it) {
      const int s = it % L::STAGES;
      hopper::mbar_wait(&full[s], (it / L::STAGES) & 1);
      const uint8_t* xt = stages + s * L::STAGE + wg * 64 * 128;
      const uint8_t* wt = stages + s * L::STAGE + L::XT;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKK / 16; ++kk)
        hopper::WgmmaSS<BN>::template mma<0, 1>(
            acc,
            hopper::smem_desc(xt + 32 * kk, 16, 1024, hopper::kSwizzle128),
            hopper::smem_desc(wt + kk * 16 * 128, L::WC, 1024,
                              hopper::kSwizzle128),
            kb > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue.  The staging of y is free once the previous tile's stores
    // have read it.
    if (leader) hopper::bulk_wait_read();
    hopper::named_sync(2 + wg, 128);
    const bool ok0 = row0 + srow < R;
    const bool ok1 = row0 + srow + 8 < R;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      uint8_t* yc = yw + c * L::YC;
      float cs[16], css[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
        const int col = col0 + 8 * j + 2 * q4;
        const float b0 =
            (bias != nullptr && col < C) ? __ldg(bias + col) : 0.f;
        const float b1 =
            (bias != nullptr && col + 1 < C) ? __ldg(bias + col + 1) : 0.f;
        const float v00 = acc[4 * j] + b0, v01 = acc[4 * j + 1] + b1;
        const float v10 = acc[4 * j + 2] + b0, v11 = acc[4 * j + 3] + b1;
        // 128-byte swizzle: piece jj of row r sits at piece jj ^ (r % 8),
        // and r % 8 == g for both of this thread's rows
        const int off = ((jj ^ g) << 4) + 4 * q4;
        *reinterpret_cast<uint32_t*>(yc + srow * 128 + off) =
            hopper::pack_bf16(v00, v01);
        *reinterpret_cast<uint32_t*>(yc + (srow + 8) * 128 + off) =
            hopper::pack_bf16(v10, v11);
        const float a0 = ok0 ? v00 : 0.f, a1 = ok0 ? v01 : 0.f;
        const float c0 = ok1 ? v10 : 0.f, c1 = ok1 ? v11 : 0.f;
        cs[2 * jj] = a0 + c0;
        cs[2 * jj + 1] = a1 + c1;
        css[2 * jj] = a0 * a0 + c0 * c0;
        css[2 * jj + 1] = a1 * a1 + c1 * c1;
      }
      reduce_rows(cs, g);
      reduce_rows(css, g);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        run_s[c][e] += cs[e];
        run_ss[c][e] += css[e];
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(2 + wg, 128);
    if (leader && row0 < R) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        hopper::tma_store_2d(&my, yw + c * L::YC, col0 + 64 * c,
                             static_cast<int>(row0));
      hopper::bulk_commit();
    }
  }

  // one partial per column of the block: the 8 warps' sums, in order
#pragma unroll
  for (int c = 0; c < BN / 64; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = (4 * wg + wl) * BN + 64 * c + 8 * g + 2 * q4 + e;
      red_s[i] = run_s[c][e];
      red_ss[i] = run_ss[c][e];
    }
  hopper::named_sync(1, 32 * CONSUMER_WARPS);
  const int t = threadIdx.x;
  if (t < BN && col0 + t < C) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMER_WARPS; ++w) {
      s += red_s[w * BN + t];
      ss += red_ss[w * BN + t];
    }
    part[static_cast<long long>(p) * C + col0 + t] = s;
    part[static_cast<long long>(P + p) * C + col0 + t] = ss;
  }
  if (leader) hopper::bulk_wait();
}

// Launches the kernel; returns the number of partial rows it writes.
template <int BN>
int launch(const void* x, const void* w, const float* bias, void* y,
           float* part, long long R, int K, int C, int n_row_tiles,
           cudaStream_t st, int* P) {
  using L = Layout<BN>;
  const cuuint64_t r = static_cast<cuuint64_t>(R);
  const cuuint64_t k = static_cast<cuuint64_t>(K);
  const cuuint64_t c = static_cast<cuuint64_t>(C);
  // innermost first: x (K, R), w (C, K), y (C, R)
  const cuuint64_t xd[2] = {k, r}, wd[2] = {c, k}, yd[2] = {c, r};
  const cuuint64_t xs[1] = {2 * k}, cs[1] = {2 * c};
  const cuuint32_t xb[2] = {BKK, BM}, wb[2] = {64, BKK}, yb[2] = {64, 64};
  CUtensorMap mx, mw, my;
  int err = hopper::make_map(&mx, x, 2, xd, xs, xb,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = hopper::make_map(&mw, w, 2, wd, cs, wb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = hopper::make_map(&my, y, 2, yd, cs, yb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaError_t attr =
      hopper::allow_smem(mm_stats_wgmma_kernel<BN>, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_sm = hopper::sm_count();
  // one block per SM of the current device, each keeping one column tile
  const int n_col_tiles = (C + BN - 1) / BN;
  int per = n_sm / n_col_tiles;
  if (per < 1) per = 1;
  if (per > n_row_tiles) per = n_row_tiles;
  *P = per;
  mm_stats_wgmma_kernel<BN><<<per * n_col_tiles, THREADS, L::SMEM, st>>>(
      mx, mw, my, bias, part, R, K, C, n_row_tiles, n_col_tiles, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int launch(const void* x, const void* w, const float* bias, void* y,
           float* sum, float* sumsq, float* part, int route, long long R,
           int K, int C, cudaStream_t st) {
  const int n_row_tiles = static_cast<int>((R + BM - 1) / BM);
  int n_part = n_row_tiles;  // rows of partials the first kernel writes
  int err = 0;
  if (route == 0) {
    mm_stats_f32_kernel<<<dim3(n_row_tiles, (C + BN - 1) / BN), THREADS, 0,
                          st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(y), part, R, K, C, n_row_tiles);
  } else if (route == 1) {
    mm_stats_mma_sync_kernel<<<dim3(n_row_tiles, (C + TBN - 1) / TBN),
                               THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<__nv_bfloat16*>(y), part, R, K, C, n_row_tiles);
  } else if (C <= 64) {
    err = tc::launch<64>(x, w, bias, y, part, R, K, C, n_row_tiles, st,
                         &n_part);
  } else {
    err = tc::launch<128>(x, w, bias, y, part, R, K, C, n_row_tiles, st,
                          &n_part);
  }
  if (err) return err;
  column_sums_kernel<<<(C + TX - 1) / TX, dim3(TX, TY), 0, st>>>(
      part, n_part, C, sum, sumsq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 = "f32" (float32 x, w, y), 1 = "mma_sync" and 2 = "tc" (bf16
// x, w, y; "tc" needs 16-byte aligned x and w and K, C multiples of 8).
// bias (may be null), sum and sumsq are float32.  part is float32 scratch
// of 2·ceil(R/128)·C.  Returns cudaGetLastError() after the launches, or an
// error code for a route or shape it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int bigdl_matmul_stats(const void* x, const void* w,
                                  const float* bias, void* y, float* sum,
                                  float* sumsq, float* part, int route,
                                  long long R, int K, int C, void* stream) {
  if (R <= 0 || K <= 0 || C <= 0 || (R + BM - 1) / BM > 0x7fffffffLL ||
      (C + BN - 1) / BN > 65535 || route < 0 || route > 2 ||
      (route == 2 && (K % 8 != 0 || C % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, bias, y, sum, sumsq, part, route, R, K, C,
                static_cast<cudaStream_t>(stream));
}
