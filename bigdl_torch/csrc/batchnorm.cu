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
// Every kernel has two routes; ops/batchnorm.py `route` picks one from
// dtype, C and the bases' alignment before the launch.
//
// Route "scalar" (the first design; for the calls "vec" does not take:
// ragged C, misaligned views).  The TPU kernels carry (Σ, Σ²) across a
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
// It loads one element per thread per row (2 bytes in bf16): on an H100
// SXM at 700 W it reached 40% (B1), 75% (B3), 60% (B4) and 35% (B2) of the
// memory rate (chip_smoke.py).
//
// What bounds every kernel on an H100: bytes.  B1 reads x twice and writes
// y once, as on the TPU; B2 reads (x, dy) twice and writes dx once; B3
// reads x once; B4 reads (x, dy) once.  Every pass does a few float
// operations per element, far below the card's ridge.
//
// Route "vec" (rows of whole 16-byte pieces, 16-byte aligned bases) is
// built to stream at the memory rate.  One stats kernel serves all four:
// stats_vec_kernel sums (Σx, Σx²) for B1 and B3, or (Σdy, Σdy·x̂) for B4
// and B2.
//  - A thread owns one 16-byte piece of a row (8 bf16 or 4 float32
//    channels) and walks the rows of its block's chunk with a stride:
//    16-byte loads, row offsets stepped by adding, 128 bytes a thread in
//    flight before the first is used (4 rows of x and dy, or 8 rows of x),
//    with ld.global.nc.L1::no_allocate: a row is read once by the pass, and
//    L2 keeps its normal policy, so B1's and B2's second pass finds the
//    last rows read still there.
//  - A block of 256 threads covers a column tile of at most 32 pieces (512
//    bytes of a row) of (x, dy), or 16 pieces of x alone, and 256 / pieces
//    rows per step, so each warp reads whole 128-byte lines: 32 rows a
//    step at C = 64 bf16, 8 at C >= 256 for B4.  A narrower tile than the
//    whole row keeps the partials, which one block sums at the end, at
//    2 x chunks x tile floats (at most about 0.5 MB); B1's and B3's
//    narrower tile halves them again, which the L2-sized calls need: there
//    the finish is as long as the data pass.
//  - The grid is (row chunk, column tile), about two blocks per SM; the
//    chunking is a function of (R, C, dtype, SM count) only
//    (ops/batchnorm.py `_vec_chunks`).
//  - One launch: each block sums its row lanes in shared memory in lane
//    order and writes one partial row; the last block of a column tile to
//    arrive (a ticket counter per tile, taken after __threadfence()) sums
//    the tile's partials in a fixed order (chunk k on k-lane k mod kl_n,
//    then the k-lanes in order), finishes them and resets its counter for
//    the next launch.  That block is alone on the card by then, so it
//    issues 16 partial loads a thread before adding any: one at a time,
//    each an L2 round trip, the finish cost as much as the whole data pass
//    of an L2-sized call.  Arrival order picks which block finishes, never
//    the order of a sum, so the sums are bit-reproducible; B2's equal B4's
//    and B3's give B1's mean and var bit for bit, since each pair shares
//    the kernel, the chunking and the order.
//  - The finish writes the sums (B3, B4), the sums and B2's dx
//    coefficients, or B1's mean, var, scale and shift with exactly the
//    arithmetic of the scalar route's finish (mean = Σx/R, var = Σx²/R −
//    mean², each operation rounded on its own).
//  - B1's normalize and B2's dx pass keep the thread-owns-a-piece layout
//    (16-byte loads and stores, the piece's coefficients in registers)
//    and walk each thread's rows backwards, so they first reread what the
//    stats pass read last, the part of x (and dy) still in the 50 MB L2.
//    Their loads and stores are streaming (evict first), keeping the
//    unread part in L2.  y = x·scale + shift is one fused multiply-add.
//    B2's coefficients are w·inv, sdy/R and sdyx/R, divided once per
//    channel: dx = w·inv·((dy − sdy/R) − x̂·(sdyx/R)) differs from the
//    scalar route's x̂·sdyx/R by at most one float32 rounding, far inside
//    the bf16 and float32 tolerances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

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

// ---- route "vec" ------------------------------------------------------------

constexpr int VT = 256;              // threads of a "vec" block
constexpr int VEC_PIECES = 32;       // 16-byte pieces in a tile of (x, dy)
constexpr int VEC_X_PIECES = 16;     // 16-byte pieces in a tile of x alone
constexpr int VEC_MAX_TILES = 4096;  // ticket counters the wrapper allocates
constexpr int VEC_ROWS = 4;          // rows of (x, dy) a thread has in flight
constexpr int VEC_FIN_LOADS = 16;    // partial loads a finishing thread issues

// One 16-byte piece of a row: N channels of T, unpacked to float32.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& v,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  // channel 2i is the low half of word i
  __device__ static __forceinline__ void unpack(const uint4& v,
                                                float (&f)[8]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// A 16-byte load that does not allocate in L1 (the data is used once) and
// leaves L2's policy as it is.
__device__ __forceinline__ uint4 ld_once(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A thread's place in a "vec" block: column tile blockIdx.y of `pt`
// pieces (w channels), row lane `lane` of rl = 256 / pt, first channel c0,
// and the block's row chunk [r0, r1).
struct VecPlace {
  int rl, lane, piece, w, c0;
  long long r0, r1;
  __device__ VecPlace(int pt, int N, long long R, long long rows_per_chunk)
      : rl(VT / pt),
        lane(static_cast<int>(threadIdx.x) / pt),
        piece(static_cast<int>(threadIdx.x) % pt),
        w(pt * N),
        c0(static_cast<int>(blockIdx.y) * pt * N +
           static_cast<int>(threadIdx.x) % pt * N),
        r0(static_cast<long long>(blockIdx.x) * rows_per_chunk),
        r1(min(R, static_cast<long long>(blockIdx.x) * rows_per_chunk +
                      rows_per_chunk)) {}
  // how many of r0 + lane, r0 + lane + rl, ... lie below r1
  __device__ long long rows() const {
    const long long first = r0 + lane;
    return first < r1 ? (r1 - first + rl - 1) / rl : 0;
  }
};

enum VecMode { kVecSums = 0, kVecBackward = 1, kVecForward = 2 };

// The stats pass of route "vec" with its finish, in one launch.  kGrad
// picks what it sums over the rows, per channel: (Σdy, Σdy·x̂) for B4 and
// B2 (x, dy, mean and inv read), or (Σx, Σx²) for B1 and B3 (x alone).
// part is [2, n_chunks, C] float32 scratch; tickets[tile] is 0 on entry and
// again on exit.  What the finishing block writes, by mode:
//  kVecSums:     out0, out1 = the two sums (B4, B3)
//  kVecBackward: the sums, and coef = [w·inv | sdy/R | sdyx/R] (B2)
//  kVecForward:  out0 = mean, out1 = var, coef = [scale | shift] (B1), by
//                the arithmetic of finish_kernel's kForward
template <typename T, bool kGrad>
__global__ void __launch_bounds__(VT, 2)
stats_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ wt, const float* __restrict__ bias,
                 float eps, long long R, int C, long long rows_per_chunk,
                 int pt, float* __restrict__ part, unsigned* tickets,
                 int mode, float* __restrict__ out0, float* __restrict__ out1,
                 float* __restrict__ coef) {
  constexpr int N = Piece<T>::N;
  // rows a thread has in flight: 128 bytes of loads either way
  constexpr int ROWS = kGrad ? VEC_ROWS : 2 * VEC_ROWS;
  // [lane][sum][channel of the tile]: rl · 2 · w = 2 · 256 · N floats
  __shared__ __align__(16) float red[2 * VT * N];
  __shared__ float4 fin[VT];
  __shared__ bool last;
  const VecPlace at(pt, N, R, rows_per_chunk);
  const int n_chunks = static_cast<int>(gridDim.x);
  float s[N], q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = q[j] = 0.f;
  if (at.lane < at.rl && at.c0 < C) {
    float m[N], iv[N];
    if constexpr (kGrad) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        m[j] = mean[at.c0 + j];
        iv[j] = inv[at.c0 + j];
      }
    }
    long long n = at.rows();
    const long long step = static_cast<long long>(at.rl) * C;
    const long long off = (at.r0 + at.lane) * C + at.c0;
    const T* px = x + off;
    const T* pd = kGrad ? dy + off : nullptr;
    auto add = [&](const uint4& xv, const uint4& dv) {
      float xf[N];
      Piece<T>::unpack(xv, xf);
      if constexpr (kGrad) {
        float gf[N];
        Piece<T>::unpack(dv, gf);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xhat = (xf[j] - m[j]) * iv[j];
          s[j] += gf[j];
          q[j] += gf[j] * xhat;
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          s[j] += xf[j];
          q[j] += xf[j] * xf[j];
        }
      }
    };
    // ROWS rows in flight before the first is used
    for (; n >= ROWS; n -= ROWS) {
      uint4 xv[ROWS], dv[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        xv[u] = ld_once(px + u * step);
        if constexpr (kGrad) dv[u] = ld_once(pd + u * step);
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) add(xv[u], dv[u]);
      px += ROWS * step;
      if constexpr (kGrad) pd += ROWS * step;
    }
    for (; n > 0; --n) {
      add(ld_once(px), kGrad ? ld_once(pd) : uint4{});
      px += step;
      if constexpr (kGrad) pd += step;
    }
  }
  // the block's row lanes, summed in lane order: one partial row
  if (at.lane < at.rl) {
    float* r = red + at.lane * 2 * at.w + at.piece * N;
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      *reinterpret_cast<float4*>(r + j) =
          make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
      *reinterpret_cast<float4*>(r + at.w + j) =
          make_float4(q[j], q[j + 1], q[j + 2], q[j + 3]);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * at.w; o += VT) {
    const int which = o / at.w, c = o % at.w;
    const int ch = static_cast<int>(blockIdx.y) * at.w + c;
    if (ch >= C) continue;
    float t = 0.f;
    for (int l = 0; l < at.rl; ++l) t += red[(l * 2 + which) * at.w + c];
    part[(static_cast<long long>(which) * n_chunks + blockIdx.x) * C + ch] =
        t;
  }
  // the last block of this column tile to arrive finishes the tile
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.y, 1u) ==
           static_cast<unsigned>(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // float4 groups of the tile's [2][w] sums; chunk k on k-lane k mod kl_n,
  // then the k-lanes in order
  const int groups = at.w / 2, kl_n = VT / groups;
  const int g = static_cast<int>(threadIdx.x) % groups;
  const int kl = static_cast<int>(threadIdx.x) / groups;
  const int which = 4 * g / at.w;
  const int ch = static_cast<int>(blockIdx.y) * at.w + 4 * g % at.w;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add4 = [&](const float4& v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  };
  if (kl < kl_n && ch < C) {
    const float4* p = reinterpret_cast<const float4*>(
        part + static_cast<long long>(which) * n_chunks * C + ch);
    const long long kstep = static_cast<long long>(kl_n) * C / 4;
    int k = kl;
    p += static_cast<long long>(k) * C / 4;
    // VEC_FIN_LOADS partials issued before the first is added: each is an
    // L2 round trip, and one at a time they would cost a round trip each
    for (; k + (VEC_FIN_LOADS - 1) * kl_n < n_chunks;
         k += VEC_FIN_LOADS * kl_n) {
      float4 v[VEC_FIN_LOADS];
#pragma unroll
      for (int u = 0; u < VEC_FIN_LOADS; ++u) v[u] = __ldcg(p + u * kstep);
#pragma unroll
      for (int u = 0; u < VEC_FIN_LOADS; ++u) add4(v[u]);
      p += VEC_FIN_LOADS * kstep;
    }
    for (; k < n_chunks; k += kl_n, p += kstep) add4(__ldcg(p));
  }
  fin[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
  const bool mine = static_cast<int>(threadIdx.x) < groups && ch < C;
  float t[4] = {acc.x, acc.y, acc.z, acc.w};
  if (mine) {
    for (int k = 1; k < kl_n; ++k) {
      const float4 v = fin[k * groups + g];
      t[0] += v.x;
      t[1] += v.y;
      t[2] += v.z;
      t[3] += v.w;
    }
  }
  const float n = static_cast<float>(R);
  if constexpr (!kGrad) {
    if (mode == kVecForward) {
      // a channel's Σx and Σx² lie with two threads: they meet in red,
      // which the block no longer reads
      if (mine) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[which * at.w + 4 * g % at.w + e] = t[e];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < at.w; c += VT) {
        const int cc = static_cast<int>(blockIdx.y) * at.w + c;
        if (cc >= C) break;
        const float mu = red[c] / n;
        const float var = __fsub_rn(red[at.w + c] / n, __fmul_rn(mu, mu));
        const float scale = __fmul_rn(wt[cc], 1.f / sqrtf(var + eps));
        out0[cc] = mu;
        out1[cc] = var;
        coef[cc] = scale;
        coef[C + cc] = __fsub_rn(bias[cc], __fmul_rn(mu, scale));
      }
      return;
    }
  }
  if (!mine) return;
  float* out = which == 0 ? out0 : out1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[ch + e] = t[e];
    if (mode != kVecBackward) continue;
    if (which == 0) {
      coef[ch + e] = __fmul_rn(wt[ch + e], inv[ch + e]);
      coef[C + ch + e] = t[e] / n;
    } else {
      coef[2 * C + ch + e] = t[e] / n;
    }
  }
}

// Pass 2 of B1's route "vec": y = x·scale + shift in float32 (one fused
// multiply-add), cast to x's dtype; each thread's rows walked from its last
// to its first, 2 · VEC_ROWS of them in flight.
template <typename T>
__global__ void __launch_bounds__(VT, 2)
normalize_vec_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                     T* __restrict__ y, long long R, int C,
                     long long rows_per_chunk, int pt) {
  constexpr int N = Piece<T>::N;
  constexpr int ROWS = 2 * VEC_ROWS;
  const VecPlace at(pt, N, R, rows_per_chunk);
  if (at.lane >= at.rl || at.c0 >= C) return;
  long long n = at.rows();
  if (n == 0) return;
  float a[N], b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = coef[at.c0 + j];
    b[j] = coef[C + at.c0 + j];
  }
  // in 16-byte pieces: C / N of them a row
  const long long step = static_cast<long long>(at.rl) * (C / N);
  const long long off =
      ((at.r0 + at.lane + (n - 1) * at.rl) * C + at.c0) / N;
  const uint4* px = reinterpret_cast<const uint4*>(x) + off;
  uint4* py = reinterpret_cast<uint4*>(y) + off;
  auto one = [&](const uint4& xv) {
    float f[N];
    Piece<T>::unpack(xv, f);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = fmaf(f[j], a[j], b[j]);
    return Piece<T>::pack(f);
  };
  // streaming (evict-first) loads and stores: what is left of x in L2 is
  // the rows this pass has yet to reach
  for (; n >= ROWS; n -= ROWS) {
    uint4 xv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) xv[u] = __ldcs(px - u * step);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) __stcs(py - u * step, one(xv[u]));
    px -= ROWS * step;
    py -= ROWS * step;
  }
  for (; n > 0; --n) {
    __stcs(py, one(__ldcs(px)));
    px -= step;
    py -= step;
  }
}

// Pass 2 of B2's route "vec": dx = w·inv·((dy − sdy/R) − x̂·(sdyx/R)), each
// thread's rows walked from its last to its first.
template <typename T>
__global__ void __launch_bounds__(VT, 2)
dx_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ coef, T* __restrict__ dx,
              long long R, int C, long long rows_per_chunk, int pt) {
  constexpr int N = Piece<T>::N;
  const VecPlace at(pt, N, R, rows_per_chunk);
  if (at.lane >= at.rl || at.c0 >= C) return;
  long long n = at.rows();
  if (n == 0) return;
  float m[N], iv[N], a[N], b[N], e[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = at.c0 + j;
    m[j] = mean[c];
    iv[j] = inv[c];
    a[j] = coef[c];
    b[j] = coef[C + c];
    e[j] = coef[2 * C + c];
  }
  // in 16-byte pieces: C / N of them a row
  const long long step = static_cast<long long>(at.rl) * (C / N);
  const long long off =
      ((at.r0 + at.lane + (n - 1) * at.rl) * C + at.c0) / N;
  const uint4* px = reinterpret_cast<const uint4*>(x) + off;
  const uint4* pd = reinterpret_cast<const uint4*>(dy) + off;
  uint4* po = reinterpret_cast<uint4*>(dx) + off;
  auto one = [&](const uint4& xv, const uint4& dv) {
    float xf[N], gf[N], o[N];
    Piece<T>::unpack(xv, xf);
    Piece<T>::unpack(dv, gf);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xhat = __fmul_rn(xf[j] - m[j], iv[j]);
      o[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(gf[j], b[j]),
                                       __fmul_rn(xhat, e[j])));
    }
    return Piece<T>::pack(o);
  };
  // streaming (evict-first) loads and stores: what is left of (x, dy) in
  // L2 is the rows this pass has yet to reach
  for (; n >= VEC_ROWS; n -= VEC_ROWS) {
    uint4 xv[VEC_ROWS], dv[VEC_ROWS];
#pragma unroll
    for (int u = 0; u < VEC_ROWS; ++u) {
      xv[u] = __ldcs(px - u * step);
      dv[u] = __ldcs(pd - u * step);
    }
#pragma unroll
    for (int u = 0; u < VEC_ROWS; ++u)
      __stcs(po - u * step, one(xv[u], dv[u]));
    px -= VEC_ROWS * step;
    pd -= VEC_ROWS * step;
    po -= VEC_ROWS * step;
  }
  for (; n > 0; --n) {
    __stcs(po, one(__ldcs(px), __ldcs(pd)));
    px -= step;
    pd -= step;
    po -= step;
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

// Route "vec": pieces of 16 bytes a row; a column tile of at most
// max_pieces of them.  Returns the tile's pieces, or 0 where the route does
// not take (C, the bases): C·sizeof(T) a multiple of 16, every base
// 16-byte aligned, at most VEC_MAX_TILES tiles.
template <typename T>
int vec_tile(int C, int max_pieces,
             std::initializer_list<const void*> bases) {
  constexpr int N = Piece<T>::N;
  for (const void* p : bases)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return 0;
  if (C % N != 0) return 0;
  const int pieces = C / N;
  const int pt = pieces < max_pieces ? pieces : max_pieces;
  return (pieces + pt - 1) / pt <= VEC_MAX_TILES ? pt : 0;
}

template <typename T>
int grad_sums_vec(const void* x, const void* dy, const float* mean,
                  const float* inv, const float* w, float* sdy, float* sdyx,
                  float* part, float* coef, unsigned* tickets, long long R,
                  int C, int n_chunks, long long rows_per_chunk, int mode,
                  cudaStream_t st) {
  const int pt = vec_tile<T>(C, VEC_PIECES, {x, dy});
  if (pt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C / Piece<T>::N + pt - 1) / pt;
  stats_vec_kernel<T, true><<<dim3(n_chunks, tiles), VT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, w,
      nullptr, 0.f, R, C, rows_per_chunk, pt, part, tickets, mode, sdy, sdyx,
      coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_vec(const void* x, const void* dy, const float* mean,
                 const float* inv, const float* w, void* dx, float* sdy,
                 float* sdyx, float* part, float* coef, unsigned* tickets,
                 long long R, int C, int n_chunks, long long rows_per_chunk,
                 cudaStream_t st) {
  const int pt = vec_tile<T>(C, VEC_PIECES, {x, dy, dx});
  if (pt == 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = grad_sums_vec<T>(x, dy, mean, inv, w, sdy, sdyx, part, coef,
                             tickets, R, C, n_chunks, rows_per_chunk,
                             kVecBackward, st);
  if (err) return err;
  const int tiles = (C / Piece<T>::N + pt - 1) / pt;
  dx_vec_kernel<T><<<dim3(n_chunks, tiles), VT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, coef,
      static_cast<T*>(dx), R, C, rows_per_chunk, pt);
  return static_cast<int>(cudaGetLastError());
}

// B3 (kVecSums: out0, out1 = Σx, Σx²) or B1's first pass (kVecForward:
// mean, var and coef).
template <typename T>
int x_sums_vec(const void* x, const float* w, const float* b, float* out0,
               float* out1, float* part, float* coef, unsigned* tickets,
               long long R, int C, float eps, int n_chunks,
               long long rows_per_chunk, int mode, cudaStream_t st) {
  const int pt = vec_tile<T>(C, VEC_X_PIECES, {x});
  if (pt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C / Piece<T>::N + pt - 1) / pt;
  stats_vec_kernel<T, false><<<dim3(n_chunks, tiles), VT, 0, st>>>(
      static_cast<const T*>(x), nullptr, nullptr, nullptr, w, b, eps, R, C,
      rows_per_chunk, pt, part, tickets, mode, out0, out1, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_vec(const void* x, const float* w, const float* b, void* y,
                float* mean, float* var, float* part, float* coef,
                unsigned* tickets, long long R, int C, float eps,
                int n_chunks, long long rows_per_chunk, cudaStream_t st) {
  const int pt = vec_tile<T>(C, VEC_X_PIECES, {x, y});
  if (pt == 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = x_sums_vec<T>(x, w, b, mean, var, part, coef, tickets, R, C, eps,
                          n_chunks, rows_per_chunk, kVecForward, st);
  if (err) return err;
  const int tiles = (C / Piece<T>::N + pt - 1) / pt;
  normalize_vec_kernel<T><<<dim3(n_chunks, tiles), VT, 0, st>>>(
      static_cast<const T*>(x), coef, static_cast<T*>(y), R, C,
      rows_per_chunk, pt);
  return static_cast<int>(cudaGetLastError());
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

// Route "vec" of B4 and B2: tickets is VEC_MAX_TILES unsigned ints, zero
// before and after every launch; launches that share it must not overlap
// (keep them on one stream).  n_chunks and rows_per_chunk come from
// ops/batchnorm.py `_vec_chunks`; C, dtype and the bases must suit the
// route (`route` there), else cudaErrorInvalidValue.
extern "C" int bigdl_bn_grad_stats_vec(const void* x, const void* dy,
                                       const float* mean, const float* inv,
                                       float* sdy, float* sdyx, float* part,
                                       unsigned* tickets, int dtype,
                                       long long R, int C, int n_chunks,
                                       long long rows_per_chunk,
                                       void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grad_sums_vec<float>(x, dy, mean, inv, nullptr, sdy, sdyx, part,
                                nullptr, tickets, R, C, n_chunks,
                                rows_per_chunk, kVecSums, st);
  if (dtype == 1)
    return grad_sums_vec<__nv_bfloat16>(x, dy, mean, inv, nullptr, sdy, sdyx,
                                        part, nullptr, tickets, R, C,
                                        n_chunks, rows_per_chunk, kVecSums,
                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_bn_backward_vec(const void* x, const void* dy,
                                     const float* mean, const float* inv,
                                     const float* w, void* dx, float* sdy,
                                     float* sdyx, float* part, float* coef,
                                     unsigned* tickets, int dtype,
                                     long long R, int C, int n_chunks,
                                     long long rows_per_chunk,
                                     void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward_vec<float>(x, dy, mean, inv, w, dx, sdy, sdyx, part,
                               coef, tickets, R, C, n_chunks, rows_per_chunk,
                               st);
  if (dtype == 1)
    return backward_vec<__nv_bfloat16>(x, dy, mean, inv, w, dx, sdy, sdyx,
                                       part, coef, tickets, R, C, n_chunks,
                                       rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route "vec" of B1 and B3, on the same terms as B4's and B2's above; B3's
// sums give B1's mean and var bit for bit (the same kernel, chunking and
// order).
extern "C" int bigdl_bn_forward_vec(const void* x, const float* w,
                                    const float* b, void* y, float* mean,
                                    float* var, float* part, float* coef,
                                    unsigned* tickets, int dtype, long long R,
                                    int C, float eps, int n_chunks,
                                    long long rows_per_chunk, void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward_vec<float>(x, w, b, y, mean, var, part, coef, tickets, R,
                              C, eps, n_chunks, rows_per_chunk, st);
  if (dtype == 1)
    return forward_vec<__nv_bfloat16>(x, w, b, y, mean, var, part, coef,
                                      tickets, R, C, eps, n_chunks,
                                      rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_bn_stats_vec(const void* x, float* sum, float* sumsq,
                                  float* part, unsigned* tickets, int dtype,
                                  long long R, int C, int n_chunks,
                                  long long rows_per_chunk, void* stream) {
  if (bad_shape(R, C, n_chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return x_sums_vec<float>(x, nullptr, nullptr, sum, sumsq, part, nullptr,
                             tickets, R, C, 0.f, n_chunks, rows_per_chunk,
                             kVecSums, st);
  if (dtype == 1)
    return x_sums_vec<__nv_bfloat16>(x, nullptr, nullptr, sum, sumsq, part,
                                     nullptr, tickets, R, C, 0.f, n_chunks,
                                     rows_per_chunk, kVecSums, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
