// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bigdl_tpu/ops/attention.py `_flash_bwd_chunked` (B7), the jnp
// recompute behind the `custom_vjp` of the Pallas forward (B6): given q, k,
// v, the forward's output o and its gradient do, all [B, H, T, D], it
// computes
//     P  = softmax(S),  S = scale * q k^T  (causal: kj > qi masked)
//     dv = P^T do;  dP = do v^T;  dS = P * (dP - rowsum(dP * P))
//     dq = scale * dS k;  dk = scale * dS^T q
// without keeping a [Tq, Tk] matrix in device memory.  rowsum(dP * P)
// equals rowsum(do * o) (o = P v), which is what the kernels use.  Sums
// are float32; outputs are in the operands' type.  Keys past Tk are
// masked; rows past Tq are computed on zeros and never stored; a row whose
// every key is masked (none on the paths that call it) gets zero gradient,
// as the reference's guards (max -> 0, sum -> 1) give.
//
// What bounds it on an H100: at [16, 8, 512, 64] bf16 causal the call must
// move 67 MB (20 us at 3.35 TB/s) against 10.8 GFLOP of causal work (11 us
// at 989 TFLOP/s on the tensor cores), so it sits near the ridge and every
// product must run on the tensor cores.
//
// Two launches per call, each block owning its outputs, so there are no
// atomics and the result does not depend on scheduling:
//
//  1. dq: a block per (query tile, b*h).  It loads its q and do rows, takes
//     delta = rowsum(do * o), then walks the key tiles twice (under the
//     causal mask only up to its diagonal): first for the row max and sum
//     (the forward's online softmax), giving the log-sum-exp, then for dP
//     and dS, accumulating dq = dS k in registers.  It writes dq, and the
//     log-sum-exp and delta as float32 [B*H, Tq] for launch 2.
//  2. dk, dv: a block per (key tile of 64, b*h).  It holds its k and v rows
//     and walks the query tiles from its causal start, rebuilding
//     P^T = exp(scale * k q^T - lse) and dS^T, and accumulates dv = P^T do
//     and dk = dS^T q in registers.
//
// Two routes, chosen by the operands' type:
//
// bf16 (`bwd_dq_mma_kernel`, `bwd_dkv_mma_kernel`, route "mma_sync"): the
// five products (and the score products again in launch 1's first pass) on
// the tensor cores by warp-level mma.sync m16n8k16, float32 accumulators.
//  - 128 threads, 4 warps of 16 rows (launch 1: query rows, 64 a block,
//    key tiles of 64; launch 2: keys, 64 a block, query tiles of 32).
//    Tiles sit in shared memory as bf16 rows padded by 16 bytes, loaded 16
//    bytes a thread (the wrapper hands over 16-byte aligned operands).
//  - A score tile comes out in the accumulator layout (lane (g, t) holds
//    rows g and g + 8, columns 2t and 2t + 1 of each 8 columns); the
//    softmax, the mask and dS = P (dP - delta) run on it in registers; P
//    and dS are rounded to bf16 and become the A operand of the next
//    product without leaving registers (the layouts line up pairwise).
//  - The second operand of dq += dS k, dv += P^T do and dk += dS^T q is
//    read column-wise from shared memory, two rows a register.
//  - Rounding P and dS to bf16 for those products is where it differs from
//    the plain version (float32 throughout), inside the bf16 tolerance.
//
// float32 (`bwd_dq_kernel`, `bwd_dkv_kernel`, route "f32", kept for float32
// parity checks): float32 FMAs on the CUDA cores, 256 threads as a 16 x 16
// grid: thread (ty, tx) owns rows 4*ty .. 4*ty+3 of its 64-row tile, score
// columns tx + 16*j and output columns tx + 16*c.  Row reductions run over
// the 16 lanes of a half-warp with shuffles.  Tiles in shared memory are
// float32 rows padded by one float, so 16 lanes reading 16 different rows
// hit 16 different banks.  Operands are read, and outputs written, through
// their strides over (B, H, T); the last axis is unit-stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int ROWS = 4;       // tile rows per thread
constexpr int COLS = 4;       // score columns per thread
constexpr int PS = 65;        // padded row stride of a score tile
static_assert(BQ == 16 * ROWS && BK == 16 * COLS && BQ == BK,
              "the thread grid covers one 64 x 64 score tile");

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [r0, r0 + 64) of a [T, D] operand into a padded float tile; rows
// past T are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < n ? src[(r0 + r) * st + c] : 0.f;
  }
}

// s[i][j] = sum_d a[4*ty + i][d] * b[tx + 16*j][d] over padded tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[ROWS][COLS],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int S = D + 1;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[ROWS], bv[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) av[i] = a[(ty * ROWS + i) * S + d];
#pragma unroll
    for (int j = 0; j < COLS; ++j) bv[j] = b[(tx + 16 * j) * S + d];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_kk p[4*ty + i][kk] * x[kk][tx + 16*c]: p a padded score
// tile, x a padded [64, D] tile
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[ROWS][D / 16],
                                         const float* p, const float* x,
                                         int ty, int tx) {
  constexpr int S = D + 1;
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    float pv[ROWS], xv[D / 16];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) pv[i] = p[(ty * ROWS + i) * PS + kk];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[kk * S + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * 64 * (D + 1) + BQ * PS;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * BK * PS + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, float* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ delta, int H,
              int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,
              Strides sd, Strides sdq, float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + 64 * S;
  float* ks = dos + 64 * S;
  float* vs = ks + 64 * S;
  float* ps = vs + 64 * S;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* db = dout + b * sd.b + h * sd.h;

  load_tile<D>(qs, qb, sq.t, q0, Tq);
  load_tile<D>(dos, db, sd.t, q0, Tq);
  __syncthreads();

  // delta = rowsum(do * o) for this thread's rows
  float dl[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty * ROWS + i;
    float part = 0.f;
    if (q0 + r < Tq) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        part = fmaf(dos[r * S + tx + 16 * c],
                    ob[(q0 + r) * so.t + tx + 16 * c], part);
    }
    dl[i] = half_warp_sum(part);
  }

  // causal: key tiles past this block's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;

  // pass 1: the row max m and this lane's share of the row sum l
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(ks, kb, sk.t, k0, Tk);
    __syncthreads();
    float s[ROWS][COLS];
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Tk || (causal && kj > qi)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      if (m_new == -INFINITY) continue;  // nothing unmasked yet
      float part = l[i] * expf(m[i] - m_new);  // exp(-inf) = 0 at the start
#pragma unroll
      for (int j = 0; j < COLS; ++j) part += expf(s[i][j] - m_new);
      l[i] = part;
      m[i] = m_new;
    }
  }
  // log-sum-exp; a fully-masked row keeps p = exp(-inf - 0) = 0
  float ls[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float sum = half_warp_sum(l[i]);
    ls[i] = m[i] == -INFINITY ? 0.f : m[i] + logf(sum);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
      if (qi < Tq) {
        lse[static_cast<long long>(bh) * Tq + qi] = ls[i];
        delta[static_cast<long long>(bh) * Tq + qi] = dl[i];
      }
    }
  }

  // pass 2: dS and dq
  float acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's k, v and dS are no longer read
    load_tile<D>(ks, kb, sk.t, k0, Tk);
    load_tile<D>(vs, vb, sv.t, k0, Tk);
    __syncthreads();
    float s[ROWS][COLS], dp[ROWS][COLS];
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool masked = kj >= Tk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[i][j] * scale - ls[i]);
        ps[(ty * ROWS + i) * PS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    tile_acc<D>(acc, ps, ks, ty, tx);
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[qi * sdq.t + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, Strides sq,
               Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv,
               float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + 64 * S;
  float* qs = vs + 64 * S;
  float* dos = qs + 64 * S;
  float* pt = dos + 64 * S;   // P^T: [key][query]
  float* dst = pt + BK * PS;  // dS^T
  float* lses = dst + BK * PS;
  float* dls = lses + BQ;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* db = dout + b * sd.b + h * sd.h;
  const float* lb = lse + static_cast<long long>(bh) * Tq;
  const float* deb = delta + static_cast<long long>(bh) * Tq;

  load_tile<D>(ks, kb, sk.t, k0, Tk);
  load_tile<D>(vs, vb, sv.t, k0, Tk);

  float dka[ROWS][DC], dva[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // causal: query tiles that end before this block's first key see none of
  // its keys (BQ == BK, so the first that does starts at k0)
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(qs, qb, sq.t, q0, Tq);
    load_tile<D>(dos, db, sd.t, q0, Tq);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < Tq ? lb[qi] : 0.f;
      dls[threadIdx.x] = qi < Tq ? deb[qi] : 0.f;
    }
    __syncthreads();
    float s[ROWS][COLS], dp[ROWS][COLS];
    tile_dot<D>(s, ks, qs, ty, tx);   // s[key][query]
    tile_dot<D>(dp, vs, dos, ty, tx); // dP^T[key][query]
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int kj = k0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + c;
        const bool masked = qi >= Tq || kj >= Tk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[i][j] * scale - lses[c]);
        pt[(ty * ROWS + i) * PS + c] = p;
        dst[(ty * ROWS + i) * PS + c] = p * (dp[i][j] - dls[c]);
      }
    }
    __syncthreads();
    tile_acc<D>(dva, pt, dos, ty, tx);
    tile_acc<D>(dka, dst, qs, ty, tx);
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kj = k0 + ty * ROWS + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[kj * sdk.t + tx + 16 * c] = dka[i][c] * scale;
      dvb[kj * sdv.t + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int H, int Tq, int Tk, const Strides* st,
           float scale, int causal, cudaStream_t stream) {
  const int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  const int dkv_bytes =
      dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_bytes);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  bwd_dq_kernel<D><<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, dq_bytes,
                     stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tdo,
      static_cast<float*>(dq), lse, delta, H, Tq, Tk, st[0], st[1], st[2],
      st[3], st[4], st[5], scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<D><<<dim3((Tk + BK - 1) / BK, B * H), THREADS, dkv_bytes,
                      stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, st[0], st[1], st[2], st[4], st[6],
      st[7], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: warp-level tensor-core products (mma.sync m16n8k16) ------------

namespace mma {

constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int BQ = 64;        // launch 1: query rows per block
constexpr int BK = 64;        // launch 1: keys per tile; launch 2: per block
constexpr int BQ2 = 32;       // launch 2: query rows per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + ROWS) of a [T, D] operand into a tile of row stride D + 8,
// 16 bytes a load (the wrapper passes 16-byte aligned bases and strides);
// rows past T are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int n) {
  constexpr int CH = D / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

// acc[j] (+)= A[16 rows x D] B^T over this warp's rows `a` (row stride
// D + 8) and the N = 8 * NJ rows of `b`: a score tile, k = the head dim
template <int D, int NJ>
__device__ __forceinline__ void scores(float (&acc)[NJ][4], const bf16* a,
                                       const bf16* b, int gid, int tig) {
  constexpr int S = D + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = 16 * kc + 2 * tig;
    const uint32_t af[4] = {ld32(a + gid * S + c), ld32(a + (gid + 8) * S + c),
                            ld32(a + gid * S + c + 8),
                            ld32(a + (gid + 8) * S + c + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* br = b + (8 * j + gid) * S + c;
      mma16816(acc[j], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc[n] += P X over a score tile p (16 rows x 8 * NJ, C-fragment layout,
// rounded to bf16 as the A operand) and the tile x [8 * NJ rows, D]
template <int D, int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&p)[NJ][4],
                                           const bf16* x, int gid, int tig) {
  constexpr int S = D + 8;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    const uint32_t af[4] = {pack(p[2 * kc][0], p[2 * kc][1]),
                            pack(p[2 * kc][2], p[2 * kc][3]),
                            pack(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    const bf16* xr = x + (16 * kc + 2 * tig) * S + gid;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* xc = xr + 8 * n;
      mma16816(acc[n], af, pack2(xc[0], xc[S]),
               pack2(xc[8 * S], xc[9 * S]));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * 64 * (D + 8) * 2;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BK + 2 * BQ2) * (D + 8) * 2 + 2 * BQ2 * 4;
}

// Launch 1: a warp owns 16 query rows; lane (gid, tig) holds rows gid and
// gid + 8 of them, score columns 8 * j + 2 * tig (+1) and dq columns
// 8 * n + 2 * tig (+1).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, bf16* __restrict__ dq,
                  float* __restrict__ lse, float* __restrict__ delta, int H,
                  int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                  Strides so, Strides sd, Strides sdq, float scale,
                  int causal) {
  constexpr int S = D + 8;
  constexpr int NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + 64 * S;
  bf16* ks = dos + 64 * S;
  bf16* vs = ks + 64 * S;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<D, 64>(qs, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  load_tile<D, 64>(dos, dout + b * sd.b + h * sd.h, sd.t, q0, Tq);
  __syncthreads();

  const bf16* qw = qs + 16 * warp * S;
  const bf16* dw = dos + 16 * warp * S;
  int rows[2];
  float dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + gid + 8 * hh;
    rows[hh] = q0 + r;
    float part = 0.f;
    if (rows[hh] < Tq) {
      const bf16* orow = o + b * so.b + h * so.h + rows[hh] * so.t;
#pragma unroll
      for (int c = 2 * tig; c < D; c += 8) {
        part = fmaf(__bfloat162float(dos[r * S + c]),
                    __bfloat162float(orow[c]), part);
        part = fmaf(__bfloat162float(dos[r * S + c + 1]),
                    __bfloat162float(orow[c + 1]), part);
      }
    }
    dl[hh] = quad_sum(part);
  }

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;

  // pass 1: row max m and this lane's share of the row sum l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D, 64>(ks, kb, sk.t, k0, Tk);
    __syncthreads();
    float s[NJ][4];
    scores<D, NJ>(s, qw, ks, gid, tig);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * tig + e;
          float x = s[j][2 * hh + e] * scale;
          if (kj >= Tk || (causal && kj > rows[hh])) x = -INFINITY;
          s[j][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hh], quad_max(mx));
      if (m_new == -INFINITY) continue;
      float part = l[hh] * expf(m[hh] - m_new);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part += expf(s[j][2 * hh] - m_new) + expf(s[j][2 * hh + 1] - m_new);
      l[hh] = part;
      m[hh] = m_new;
    }
  }
  float ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(l[hh]);
    ls[hh] = m[hh] == -INFINITY ? 0.f : m[hh] + logf(sum);
    if (tig == 0 && rows[hh] < Tq) {
      lse[static_cast<long long>(bh) * Tq + rows[hh]] = ls[hh];
      delta[static_cast<long long>(bh) * Tq + rows[hh]] = dl[hh];
    }
  }

  // pass 2: dS and dq = dS k
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D, 64>(ks, kb, sk.t, k0, Tk);
    load_tile<D, 64>(vs, vb, sv.t, k0, Tk);
    __syncthreads();
    float s[NJ][4], dp[NJ][4];
    scores<D, NJ>(s, qw, ks, gid, tig);
    scores<D, NJ>(dp, dw, vs, gid, tig);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kj = k0 + 8 * j + 2 * tig + (e & 1);
        const bool masked = kj >= Tk || (causal && kj > rows[hh]);
        const float p = masked ? 0.f : expf(s[j][e] * scale - ls[hh]);
        s[j][e] = p * (dp[j][e] - dl[hh]);
      }
    accumulate<D, NJ>(acc, s, ks, gid, tig);
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= Tq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqb + rows[hh] * sdq.t + 8 * n +
                                   2 * tig) =
          pack(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
  }
}

// Launch 2: a warp owns 16 keys; lane (gid, tig) holds keys gid and
// gid + 8 of them, query columns 8 * j + 2 * tig (+1) of each 32-row
// query tile, and dk, dv columns 8 * n + 2 * tig (+1).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Tq, int Tk, Strides sq,
                   Strides sk, Strides sv, Strides sd, Strides sdk,
                   Strides sdv, float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int NJ = BQ2 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BK * S;
  bf16* qs = vs + BK * S;
  bf16* dos = qs + BQ2 * S;
  float* lses = reinterpret_cast<float*>(dos + BQ2 * S);
  float* dls = lses + BQ2;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const float* lb = lse + static_cast<long long>(bh) * Tq;
  const float* deb = delta + static_cast<long long>(bh) * Tq;

  load_tile<D, BK>(ks, k + b * sk.b + h * sk.h, sk.t, k0, Tk);
  load_tile<D, BK>(vs, v + b * sv.b + h * sv.h, sv.t, k0, Tk);
  const bf16* kw = ks + 16 * warp * S;
  const bf16* vw = vs + 16 * warp * S;
  const int keys[2] = {k0 + 16 * warp + gid, k0 + 16 * warp + gid + 8};

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // causal: the first query tile that sees a key of this block starts at
  // k0 (k0 is a multiple of BQ2)
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += BQ2) {
    __syncthreads();
    load_tile<D, BQ2>(qs, qb, sq.t, q0, Tq);
    load_tile<D, BQ2>(dos, db, sd.t, q0, Tq);
    if (threadIdx.x < BQ2) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < Tq ? lb[qi] : 0.f;
      dls[threadIdx.x] = qi < Tq ? deb[qi] : 0.f;
    }
    __syncthreads();
    float s[NJ][4], dp[NJ][4];
    scores<D, NJ>(s, kw, qs, gid, tig);   // s[key][query]
    scores<D, NJ>(dp, vw, dos, gid, tig); // dP^T[key][query]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tig + (e & 1);
        const int qi = q0 + c;
        const int kj = keys[e >> 1];
        const bool masked = qi >= Tq || kj >= Tk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[j][e] * scale - lses[c]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dls[c]);
      }
    accumulate<D, NJ>(dva, s, dos, gid, tig);
    accumulate<D, NJ>(dka, dp, qs, gid, tig);
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (keys[hh] >= Tk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * tig;
      *reinterpret_cast<uint32_t*>(dkb + keys[hh] * sdk.t + c) =
          pack(dka[n][2 * hh] * scale, dka[n][2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + keys[hh] * sdv.t + c) =
          pack(dva[n][2 * hh], dva[n][2 * hh + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int H, int Tq, int Tk, const Strides* st,
           float scale, int causal, cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_bytes<D>();
  constexpr int dkv_bytes = dkv_smem_bytes<D>();
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_bytes);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  bwd_dq_mma_kernel<D><<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, dq_bytes,
                         stream>>>(
      tq, tk, tv, static_cast<const bf16*>(o), tdo, static_cast<bf16*>(dq),
      lse, delta, H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], scale,
      causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_mma_kernel<D><<<dim3((Tk + BK - 1) / BK, B * H), THREADS,
                          dkv_bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, st[0], st[1], st[2], st[4], st[6],
      st[7], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

template <int D>
int launch_route(int route, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, void* dq, void* dk,
                 void* dv, float* lse, float* delta, int B, int H, int Tq,
                 int Tk, const Strides* st, float scale, int causal,
                 cudaStream_t stream) {
  if (route == 0)
    return launch<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Tq, Tk,
                     st, scale, causal, stream);
  if (route == 1)
    return mma::launch<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H,
                          Tq, Tk, st, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// route: 0 = "f32" (float32 operands, CUDA cores), 1 = "mma_sync" (bf16
// operands, tensor cores; every operand's base 16-byte aligned and its B,
// H and T strides multiples of 8).  Strides are in elements, for the B, H
// and T axes of q, k, v, o, do, dq, dk and dv in that order (24 values;
// the D axis is unit-stride).  lse and delta are float32 scratch of
// B*H*Tq each.  Two launches on `stream`; returns cudaGetLastError() after
// them, or an error code for a head dimension or route without an
// instance.
extern "C" int bigdl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse,
    float* delta, int route, int B, int H, int Tq, int Tk, int D,
    const long long* strides, float sm_scale, int causal, void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_route<32>(route, q, k, v, o, dout, dq, dk, dv, lse,
                              delta, B, H, Tq, Tk, st, sm_scale, causal, s);
    case 64:
      return launch_route<64>(route, q, k, v, o, dout, dq, dk, dv, lse,
                              delta, B, H, Tq, Tk, st, sm_scale, causal, s);
    case 128:
      return launch_route<128>(route, q, k, v, o, dout, dq, dk, dv, lse,
                               delta, B, H, Tq, Tk, st, sm_scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
