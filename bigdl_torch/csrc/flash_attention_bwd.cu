// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bigdl_tpu/ops/attention.py:182 `_flash_bwd_chunked` (B7), the jnp
// recompute behind the `custom_vjp` of the Pallas forward (B6): given q, k,
// v, the forward's output o, its gradient do, all [B, H, T, D], and the
// forward's log-sum-exp lse (float32 [B*H, Tq], natural log; B6 writes it),
// it computes
//     P  = exp(S - lse),  S = scale * q k^T  (causal: kj > qi masked)
//     dv = P^T do;  dP = do v^T;  dS = P * (dP - rowsum(dP * P))
//     dq = scale * dS k;  dk = scale * dS^T q
// without keeping a [Tq, Tk] matrix in device memory.  rowsum(dP * P)
// equals rowsum(do * o) (o = P v), which is what the kernels use.  Sums
// are float32; outputs are in the operands' type.  Keys past Tk are
// masked; rows past Tq are computed on zeros and never stored; a row whose
// every key is masked (none on the paths that call it) gets zero gradient,
// since B6 gives it lse = 0 and every one of its P is masked to 0.
//
// What bounds it on an H100: at [16, 8, 512, 64] bf16 causal the call must
// move 67 MB (20 us at 3.35 TB/s) against 10.8 GFLOP of useful causal work
// (11 us at 989 TFLOP/s on the tensor cores); the two launches below issue
// 7/5 of that (S and dP are taken in both), 15.1 GFLOP or 15 us.  It sits
// near the ridge, so every product runs on the tensor cores, the tiles
// arrive by TMA while earlier ones are multiplied, and the log-sum-exp
// comes from the forward instead of a key pass of its own.
//
// Two launches per call, each block owning its outputs, so there are no
// atomics and the result does not depend on scheduling:
//
//  1. dq: work items of query rows of one (b, h).  An item takes delta =
//     rowsum(do * o) for its rows (and writes it for launch 2), reads their
//     lse, and walks the key tiles (under the causal mask only up to its
//     diagonal), taking S and dP, then dS, and accumulating dq = dS k in
//     registers.
//  2. dk, dv: work items of keys of one (b, h).  An item holds its k and v
//     rows and walks the query tiles from its causal start, rebuilding
//     P^T = exp(scale * k q^T - lse) and dS^T, and accumulates dv = P^T do
//     and dk = dS^T q in registers.
//
// Two routes, chosen by the operands' type:
//
// bf16 (`bwd_dq_tc_kernel`, `bwd_dkv_tc_kernel`, route "tc"): warpgroup
// tensor-core products (wgmma) on tiles fed by TMA, as B6's "tc".
//  - Persistent blocks, one per SM, of two consumer warpgroups and one
//    producer warp.  An item is 128 rows (launch 1 queries, launch 2 keys),
//    64 for each consumer warpgroup, and blocks take the items longest
//    first under the causal mask (launch 1 the last query tiles, launch 2
//    the first key tiles), snaking over the rounds as B6 does.
//  - The producer loads each item's two 128-row tiles (launch 1 Q and dO,
//    launch 2 K and V) into one of two buffers, and keeps a ring of the
//    other two operands' 64-row tiles (launch 1 K and V, launch 2 Q and dO)
//    in flight, running on into the next item.  Launch 2's producer warp
//    also stages each query tile's lse (times log2 e) and delta in shared
//    memory beside it.  Tiles are read straight from the strided
//    [B, H, T, D] views by 4-D tensor maps, with B6's swizzles (128-byte
//    chunks of 64 columns for D = 64 and 128, 64-byte rows for D = 32,
//    32-byte rows for D = 16, where each SS product is one k-step and
//    each RS product m64n16); rows past T arrive as zeros.
//  - Per streamed tile, a warpgroup takes two SS products (both operands
//    K-major in shared memory; launch 1 S = Q K^T and dP = dO V^T, launch 2
//    S^T = K Q^T and dP^T = V dO^T, m64n64k16), then on the accumulator
//    fragment P = exp2(S scale log2 e - lse log2 e) and dS = P (dP -
//    delta), the mask applied only on tiles that cross the diagonal or a T
//    edge.  P and dS are rounded to bf16 in registers and are the A operand
//    of the RS products (launch 1 dq += dS K, launch 2 dv += P^T dO and
//    dk += dS^T Q, m64nDk16), whose B tile is read MN-major from the same
//    stage: no score tile touches shared memory.  Seven products in all
//    (five would need atomics on dq).
//  - dq (times scale), dk (times scale) and dv are written once, as bf16
//    pairs from the accumulators.  Rounding P and dS to bf16 is where it
//    differs from the plain version (float32 throughout), inside the bf16
//    tolerance.
//  - A block of 9 warps is compiled for 168 registers a thread: launch 2
//    holds dk and dv beside S^T and dP^T and spills (400 bytes at D = 128,
//    where dk and dv take 64 each; 8 at D = 64).  The same register budget
//    leaves no room to issue the next tile's products before this tile's
//    dk and dv products finish; the second warpgroup fills the tensor
//    cores meanwhile.
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
#include <type_traits>

#include "hopper.cuh"

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
              const float* __restrict__ lse, float* __restrict__ delta, int H,
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

  // the forward's log-sum-exp; delta for launch 2
  float ls[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    ls[i] = qi < Tq ? lse[static_cast<long long>(bh) * Tq + qi] : 0.f;
    if (tx == 0 && qi < Tq)
      delta[static_cast<long long>(bh) * Tq + qi] = dl[i];
  }

  // dS and dq
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
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float* delta, int B, int H, int Tq, int Tk, const Strides* st,
           float scale, int causal, cudaStream_t stream) {
  const int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  const int dkv_bytes =
      dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t attr_dq = hopper::allow_smem(bwd_dq_kernel<D>, dq_bytes);
  const cudaError_t attr_dkv =
      hopper::allow_smem(bwd_dkv_kernel<D>, dkv_bytes);
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

// ---- bf16: warpgroup tensor-core products (wgmma) fed by TMA ---------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMER_WARPS = 8;                   // two warpgroups
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // + the producer warp
constexpr int ROWS = 128;  // rows of an item, 64 for each warpgroup
constexpr int BT = 64;     // rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int STAGES = D < 128 ? 4 : 2;  // streamed tiles in flight
  static constexpr int CW = D < 64 ? D : 64;  // columns of a swizzled chunk
  static constexpr int NCH = D / CW;          // chunks per row
  static constexpr int RB = 2 * CW;           // bytes of a chunk row
  static constexpr uint32_t SWZ = hopper::swizzle_for(RB);
  static constexpr int ITEM_CHUNK = ROWS * RB;  // a chunk of an item tile
  static constexpr int CHUNK = BT * RB;         // a chunk of a streamed tile
  static constexpr int ITEM_TILE = ROWS * D * 2;
  static constexpr int TILE = BT * D * 2;
  // two item operands, double-buffered; two streamed operands in STAGES
  // stages with launch 2's lse and delta; the barriers
  static constexpr int SMEM = 1024 + 4 * ITEM_TILE + 2 * STAGES * TILE +
                              2 * STAGES * BT * 4 + 8 * (4 + 3 * STAGES);
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// sum of a[i] * b[i] over the N bf16 values a thread holds of a row (N =
// D / 4), in order, read 16 bytes (8 values) a load, or 8 bytes at N = 4
// (D = 16, whose quarter rows start 8 bytes apart)
template <int N>
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b) {
  constexpr int V = N < 8 ? N : 8;
  static_assert(V == 4 || V == 8, "a quarter row of 4 or a multiple of 8");
  using Vec = typename std::conditional<V == 8, uint4, uint2>::type;
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += V) {
    const Vec av = *reinterpret_cast<const Vec*>(a + c);
    const Vec bv = *reinterpret_cast<const Vec*>(b + c);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const float2 af = __bfloat1622float2(ap[e]);
      const float2 bf = __bfloat1622float2(bp[e]);
      part = fmaf(af.x, bf.x, part);
      part = fmaf(af.y, bf.y, part);
    }
  }
  return part;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc = A B^T over the head dimension: A this warpgroup's 64 rows of an
// item tile, B a streamed 64-row tile, both K-major; one commit group.
template <int D>
__device__ __forceinline__ void ss_issue(float (&acc)[BT / 2],
                                         const uint8_t* a,
                                         const uint8_t* b) {
  using L = Layout<D>;
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ch = kk / (L::CW / 16), off = (kk % (L::CW / 16)) * 32;
    hopper::WgmmaSS<BT>::mma<0, 0>(
        acc,
        hopper::smem_desc(a + ch * L::ITEM_CHUNK + off, 16, 8 * L::RB,
                          L::SWZ),
        hopper::smem_desc(b + ch * L::CHUNK + off, 16, 8 * L::RB, L::SWZ),
        kk);
  }
  hopper::wgmma_commit();
}

// acc += A X: A the register operand (a 64 x 64 fragment as bf16 pairs, 16
// columns a step), X a streamed tile whose 64 rows run along the product's
// K, read MN-major; one commit group.
template <int D>
__device__ __forceinline__ void rs_issue(float (&acc)[D / 2],
                                         const uint32_t (&a)[BT / 16][4],
                                         const uint8_t* x) {
  using L = Layout<D>;
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    hopper::WgmmaRS<D>::template mma<1>(
        acc, a[kk],
        hopper::smem_desc(x + kk * 16 * L::RB, L::CHUNK, 8 * L::RB, L::SWZ),
        1);
  hopper::wgmma_commit();
}

// Shared memory of either launch: item tiles (two operands, two buffers),
// streamed tiles (two operands, STAGES each), launch 2's lse and delta per
// stage, then 4 + 3 * STAGES barriers.
template <int D>
struct Smem {
  uint8_t *item_a, *item_b, *tile_a, *tile_b;
  float *lse, *delta;
  uint64_t* bar;
  __device__ explicit Smem(uint8_t* raw) {
    using L = Layout<D>;
    item_a = hopper::align1024(raw);
    item_b = item_a + 2 * L::ITEM_TILE;
    tile_a = item_b + 2 * L::ITEM_TILE;
    tile_b = tile_a + L::STAGES * L::TILE;
    lse = reinterpret_cast<float*>(tile_b + L::STAGES * L::TILE);
    delta = lse + L::STAGES * BT;
    bar = reinterpret_cast<uint64_t*>(delta + L::STAGES * BT);
  }
};

// Launch 1: dq over items of 128 query rows; key tiles of 64 streamed.
// Thread t of consumer warpgroup wg holds, of each 64 x 64 score fragment,
// rows q0 + 64 wg + 16 (warp % 4) + g (+ 8) and columns 8 j + 2 q4 (+ 1).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mdo,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 bf16* __restrict__ dq, int B, int H, int Tq, int Tk,
                 Strides so, Strides sd, Strides sdq, float scale,
                 int causal) {
  using L = Layout<D>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  uint8_t* const qs = sm.item_a;
  uint8_t* const dos = sm.item_b;
  uint8_t* const ks = sm.tile_a;
  uint8_t* const vs = sm.tile_b;
  uint64_t* const item_full = sm.bar;
  uint64_t* const item_free = item_full + 2;
  uint64_t* const k_full = item_free + 2;
  uint64_t* const v_full = k_full + S;
  uint64_t* const kv_free = v_full + S;

  // under the causal mask the last query tiles have the most keys
  const hopper::Items items{(Tq + ROWS - 1) / ROWS, B * H, causal,
                            static_cast<int>(gridDim.x)};
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&item_full[i], 1);
      hopper::mbar_init(&item_free[i], CONSUMER_WARPS);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_free[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: one thread issues every load
    if (lane == 0) {
      int t = 0;  // key tiles loaded so far, over all of this block's items
      for (int r = 0;; ++r) {
        const int i = items.item(c, r);
        if (i >= items.count()) break;
        const int q0 = items.tile(i) * ROWS;
        const int b = (i % items.BH) / H, h = (i % items.BH) % H;
        const int n_kt = ((causal ? min(Tk, q0 + ROWS) : Tk) + BT - 1) / BT;
        if (r >= 2) hopper::mbar_wait(&item_free[r & 1], (r / 2 - 1) & 1);
        hopper::mbar_expect_tx(&item_full[r & 1], 2 * L::ITEM_TILE);
        for (int ch = 0; ch < L::NCH; ++ch) {
          const int off = (r & 1) * L::ITEM_TILE + ch * L::ITEM_CHUNK;
          hopper::tma_load_4d(qs + off, &mq, &item_full[r & 1], ch * L::CW,
                              q0, h, b);
          hopper::tma_load_4d(dos + off, &mdo, &item_full[r & 1],
                              ch * L::CW, q0, h, b);
        }
        for (int kt = 0; kt < n_kt; ++kt, ++t) {
          const int s = t % S;
          if (t >= S) hopper::mbar_wait(&kv_free[s], (t / S - 1) & 1);
          hopper::mbar_expect_tx(&k_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(ks + s * L::TILE + ch * L::CHUNK, &mk,
                                &k_full[s], ch * L::CW, kt * BT, h, b);
          hopper::mbar_expect_tx(&v_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(vs + s * L::TILE + ch * L::CHUNK, &mv,
                                &v_full[s], ch * L::CW, kt * BT, h, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int g = lane / 4;
  const int q4 = lane % 4;
  const float c2 = scale * LOG2E;
  float acc[D / 2];
  float sc[BT / 2], dp[BT / 2];
  uint32_t da[BT / 16][4];
  int t = 0;  // key tiles consumed so far, over all of this block's items
  for (int r = 0;; ++r) {
    const int i = items.item(c, r);
    if (i >= items.count()) break;
    const int q0 = items.tile(i) * ROWS;
    const int bh = i % items.BH, b = bh / H, h = bh % H;
    const int n_kt = ((causal ? min(Tk, q0 + ROWS) : Tk) + BT - 1) / BT;
    const int row_min = q0 + 64 * wg;  // this warpgroup's first row
    const int row_lo = row_min + 16 * (warp % 4) + g;

    // this thread's rows' lse (log2 domain) and delta = rowsum(do * o),
    // read while the tiles arrive; delta is written for launch 2 (a quad
    // sums a row, D / 4 columns a thread, in a fixed order)
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + 8 * hh;
      float part = 0.f;
      lse2[hh] = 0.f;
      if (row < Tq) {
        lse2[hh] = lse[static_cast<long long>(bh) * Tq + row] * LOG2E;
        const bf16* orow = o + b * so.b + h * so.h + row * so.t + q4 * (D / 4);
        const bf16* drow =
            dout + b * sd.b + h * sd.h + row * sd.t + q4 * (D / 4);
        part = dot_bf16<D / 4>(drow, orow);
      }
      dl[hh] = quad_sum(part);
      if (q4 == 0 && row < Tq)
        delta[static_cast<long long>(bh) * Tq + row] = dl[hh];
    }

#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    const uint8_t* qa = qs + (r & 1) * L::ITEM_TILE + 64 * wg * L::RB;
    const uint8_t* ga = dos + (r & 1) * L::ITEM_TILE + 64 * wg * L::RB;
    hopper::mbar_wait(&item_full[r & 1], (r / 2) & 1);
    for (int kt = 0; kt < n_kt; ++kt, ++t) {
      const int s = t % S;
      const uint32_t ph = (t / S) & 1;
      const int k0 = kt * BT;
      hopper::mbar_wait(&k_full[s], ph);
      hopper::mbar_wait(&v_full[s], ph);
      if (causal && k0 > row_min + 63) {  // every key masked for these rows
        if (lane == 0) hopper::mbar_arrive(&kv_free[s]);
        continue;
      }
      const uint8_t* kt_s = ks + s * L::TILE;
      ss_issue<D>(sc, qa, kt_s);
      ss_issue<D>(dp, ga, vs + s * L::TILE);
      hopper::wgmma_wait<1>();  // S is done; dP may run on
      hopper::fence_regs(sc);
      // the mask only where the tile crosses the diagonal or the Tk edge
      const bool edge = k0 + BT > Tk || (causal && k0 + BT - 1 > row_min);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * hh + e;
            float p = hopper::exp2_approx(fmaf(sc[idx], c2, -lse2[hh]));
            if (edge) {
              const int col = k0 + 8 * j + 2 * q4 + e;
              if (col >= Tk || (causal && col > row_lo + 8 * hh)) p = 0.f;
            }
            sc[idx] = p;
          }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * hh + e;
            dp[idx] = sc[idx] * (dp[idx] - dl[hh]);
          }
      hopper::pack_frag(da, dp);
      rs_issue<D>(acc, da, kt_s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) hopper::fence_regs(da[kk]);
      if (lane == 0) hopper::mbar_arrive(&kv_free[s]);
    }
    // every product of this item is done: its Q and dO buffer may be
    // refilled
    if (lane == 0) hopper::mbar_arrive(&item_free[r & 1]);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + 8 * hh;
      if (row < Tq) {
        bf16* out = dq + b * sdq.b + h * sdq.h + row * sdq.t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * q4) =
              hopper::pack_bf16(acc[4 * j + 2 * hh] * scale,
                                acc[4 * j + 2 * hh + 1] * scale);
      }
    }
  }
}

// Launch 2: dk, dv over items of 128 keys; query tiles of 64 streamed with
// their lse and delta.  Thread t of consumer warpgroup wg holds, of each
// 64 x 64 fragment of S^T, keys k0 + 64 wg + 16 (warp % 4) + g (+ 8) and
// query columns 8 j + 2 q4 (+ 1).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int B, int H, int Tq, int Tk,
                  Strides sdk, Strides sdv, float scale, int causal) {
  using L = Layout<D>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  uint8_t* const ks = sm.item_a;
  uint8_t* const vs = sm.item_b;
  uint8_t* const qs = sm.tile_a;
  uint8_t* const dos = sm.tile_b;
  uint64_t* const item_full = sm.bar;
  uint64_t* const item_free = item_full + 2;
  // Q by TMA, its lse and delta by the 32 producer lanes
  uint64_t* const q_full = item_free + 2;
  uint64_t* const do_full = q_full + S;
  uint64_t* const qdo_free = do_full + S;

  // under the causal mask the first key tiles see the most queries
  const hopper::Items items{(Tk + ROWS - 1) / ROWS, B * H, 0,
                            static_cast<int>(gridDim.x)};
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&item_full[i], 1);
      hopper::mbar_init(&item_free[i], CONSUMER_WARPS);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&q_full[s], 32);
      hopper::mbar_init(&do_full[s], 1);
      hopper::mbar_init(&qdo_free[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: lane 0 issues every TMA load; all 32 lanes stage each query
    // tile's lse (times log2 e) and delta, two rows a lane, and arrive
    int t = 0;  // query tiles loaded so far, over all of this block's items
    for (int r = 0;; ++r) {
      const int i = items.item(c, r);
      if (i >= items.count()) break;
      const int k0 = items.tile(i) * ROWS;
      const int bh = i % items.BH, b = bh / H, h = bh % H;
      const int qt0 = causal ? k0 : 0;  // the first query that sees key k0
      const int n_qt = qt0 < Tq ? (Tq - qt0 + BT - 1) / BT : 0;
      if (lane == 0) {
        if (r >= 2) hopper::mbar_wait(&item_free[r & 1], (r / 2 - 1) & 1);
        hopper::mbar_expect_tx(&item_full[r & 1], 2 * L::ITEM_TILE);
        for (int ch = 0; ch < L::NCH; ++ch) {
          const int off = (r & 1) * L::ITEM_TILE + ch * L::ITEM_CHUNK;
          hopper::tma_load_4d(ks + off, &mk, &item_full[r & 1], ch * L::CW,
                              k0, h, b);
          hopper::tma_load_4d(vs + off, &mv, &item_full[r & 1], ch * L::CW,
                              k0, h, b);
        }
      }
      for (int j = 0; j < n_qt; ++j, ++t) {
        const int s = t % S;
        const int qt = qt0 + j * BT;
        if (t >= S) hopper::mbar_wait(&qdo_free[s], (t / S - 1) & 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = 2 * lane + e, row = qt + rr;
          const long long at = static_cast<long long>(bh) * Tq + row;
          sm.lse[s * BT + rr] = row < Tq ? lse[at] * LOG2E : 0.f;
          sm.delta[s * BT + rr] = row < Tq ? delta[at] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_expect_tx(&q_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(qs + s * L::TILE + ch * L::CHUNK, &mq,
                                &q_full[s], ch * L::CW, qt, h, b);
          hopper::mbar_expect_tx(&do_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(dos + s * L::TILE + ch * L::CHUNK, &mdo,
                                &do_full[s], ch * L::CW, qt, h, b);
        } else {
          hopper::mbar_arrive(&q_full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int g = lane / 4;
  const int q4 = lane % 4;
  const float c2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
  float sc[BT / 2], dp[BT / 2];
  uint32_t pa[BT / 16][4], da[BT / 16][4];
  int t = 0;  // query tiles consumed so far, over all of this block's items
  for (int r = 0;; ++r) {
    const int i = items.item(c, r);
    if (i >= items.count()) break;
    const int k0 = items.tile(i) * ROWS;
    const int bh = i % items.BH, b = bh / H, h = bh % H;
    const int qt0 = causal ? k0 : 0;
    const int n_qt = qt0 < Tq ? (Tq - qt0 + BT - 1) / BT : 0;
    const int kw = k0 + 64 * wg;  // this warpgroup's first key
    const int key_lo = kw + 16 * (warp % 4) + g;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;
    const uint8_t* ka = ks + (r & 1) * L::ITEM_TILE + 64 * wg * L::RB;
    const uint8_t* va = vs + (r & 1) * L::ITEM_TILE + 64 * wg * L::RB;
    hopper::mbar_wait(&item_full[r & 1], (r / 2) & 1);
    for (int j = 0; j < n_qt; ++j, ++t) {
      const int s = t % S;
      const uint32_t ph = (t / S) & 1;
      const int qt = qt0 + j * BT;
      hopper::mbar_wait(&q_full[s], ph);
      hopper::mbar_wait(&do_full[s], ph);
      if (causal && qt + BT - 1 < kw) {  // every query before these keys
        if (lane == 0) hopper::mbar_arrive(&qdo_free[s]);
        continue;
      }
      const uint8_t* q_s = qs + s * L::TILE;
      const uint8_t* g_s = dos + s * L::TILE;
      ss_issue<D>(sc, ka, q_s);
      ss_issue<D>(dp, va, g_s);
      const float* ls = sm.lse + s * BT;
      const float* dd = sm.delta + s * BT;
      hopper::wgmma_wait<1>();  // S^T is done; dP^T may run on
      hopper::fence_regs(sc);
      // the mask only where the tile crosses the diagonal or a T edge
      const bool edge =
          qt + BT > Tq || kw + 64 > Tk || (causal && kw + 63 > qt);
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * q4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            float p = hopper::exp2_approx(
                fmaf(sc[idx], c2, -(e ? l2.y : l2.x)));
            if (edge) {
              const int col = qt + 8 * jj + 2 * q4 + e;
              const int key = key_lo + 8 * hh;
              if (col >= Tq || key >= Tk || (causal && key > col)) p = 0.f;
            }
            sc[idx] = p;
          }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dd + 8 * jj + 2 * q4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            dp[idx] = sc[idx] * (dp[idx] - (e ? d2.y : d2.x));
          }
      }
      hopper::pack_frag(pa, sc);
      hopper::pack_frag(da, dp);
      rs_issue<D>(dva, pa, g_s);
      rs_issue<D>(dka, da, q_s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(da[kk]);
      }
      if (lane == 0) hopper::mbar_arrive(&qdo_free[s]);
    }
    // every product of this item is done: its K and V buffer may be
    // refilled
    if (lane == 0) hopper::mbar_arrive(&item_free[r & 1]);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key_lo + 8 * hh;
      if (key < Tk) {
        bf16* ok = dk + b * sdk.b + h * sdk.h + key * sdk.t;
        bf16* ov = dv + b * sdv.b + h * sdv.h + key * sdv.t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(ok + 8 * j + 2 * q4) =
              hopper::pack_bf16(dka[4 * j + 2 * hh] * scale,
                                dka[4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(ov + 8 * j + 2 * q4) =
              hopper::pack_bf16(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float* delta, int B, int H, int Tq, int Tk, const Strides* st,
           float scale, int causal, cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapSwizzle swizzle = hopper::map_swizzle_for(L::RB);
  // (D, T, H, B), innermost first; a box is CW columns x `rows` rows
  auto make = [&](CUtensorMap* map, const void* base, const Strides& s,
                  int T, int rows) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2,
                                   static_cast<cuuint64_t>(s.h) * 2,
                                   static_cast<cuuint64_t>(s.b) * 2};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::CW),
                               static_cast<cuuint32_t>(rows), 1, 1};
    return hopper::make_map(map, base, 4, dims, strides, box, swizzle);
  };
  // launch 1 holds Q and dO by items and streams K and V; launch 2 the
  // other way round
  CUtensorMap q_item, do_item, k_tile, v_tile, k_item, v_item, q_tile,
      do_tile;
  int err = 0;
  if ((err = make(&q_item, q, st[0], Tq, ROWS)) ||
      (err = make(&do_item, dout, st[4], Tq, ROWS)) ||
      (err = make(&k_tile, k, st[1], Tk, BT)) ||
      (err = make(&v_tile, v, st[2], Tk, BT)) ||
      (err = make(&k_item, k, st[1], Tk, ROWS)) ||
      (err = make(&v_item, v, st[2], Tk, ROWS)) ||
      (err = make(&q_tile, q, st[0], Tq, BT)) ||
      (err = make(&do_tile, dout, st[4], Tq, BT)))
    return err;
  const cudaError_t attr_dq =
      hopper::allow_smem(bwd_dq_tc_kernel<D>, L::SMEM);
  const cudaError_t attr_dkv =
      hopper::allow_smem(bwd_dkv_tc_kernel<D>, L::SMEM);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  // persistent: one block per SM of the current device, or one per item
  // where there are fewer
  const int n_sm = hopper::sm_count();
  const long long n1 = static_cast<long long>((Tq + ROWS - 1) / ROWS) * B * H;
  const long long n2 = static_cast<long long>((Tk + ROWS - 1) / ROWS) * B * H;
  bwd_dq_tc_kernel<D><<<n1 < n_sm ? static_cast<int>(n1) : n_sm, THREADS,
                        L::SMEM, stream>>>(
      q_item, do_item, k_tile, v_tile, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), B,
      H, Tq, Tk, st[3], st[4], st[5], scale, causal);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  bwd_dkv_tc_kernel<D><<<n2 < n_sm ? static_cast<int>(n2) : n_sm, THREADS,
                         L::SMEM, stream>>>(
      k_item, v_item, q_tile, do_tile, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, Tq, Tk, st[6], st[7], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch_route(int route, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, void* dq, void* dk,
                 void* dv, const float* lse, float* delta, int B, int H,
                 int Tq, int Tk, const Strides* st, float scale, int causal,
                 cudaStream_t stream) {
  if (route == 0)
    return launch<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Tq, Tk,
                     st, scale, causal, stream);
  if (route == 1)
    return tc::launch<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Tq,
                         Tk, st, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// route: 0 = "f32" (float32 operands, CUDA cores), 1 = "tc" (bf16
// operands, tensor cores fed by TMA; every operand's base 16-byte aligned
// and its B, H and T strides multiples of 8).  Strides are in elements, for
// the B, H and T axes of q, k, v, o, do, dq, dk and dv in that order (24
// values; the D axis is unit-stride).  lse is the forward's log-sum-exp,
// float32 [B*H, Tq] (bigdl_flash_attention_fwd writes it); delta is float32
// scratch of B*H*Tq that launch 1 fills for launch 2.  Two launches on
// `stream`; returns cudaGetLastError() after them, or an error code for a
// head dimension or route without an instance or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int bigdl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, int route, int B, int H, int Tq, int Tk, int D,
    const long long* strides, float sm_scale, int causal, void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_route<16>(route, q, k, v, o, dout, dq, dk, dv, lse,
                              delta, B, H, Tq, Tk, st, sm_scale, causal, s);
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
