// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bigdl_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_pallas`, B6): o = softmax(q k^T * scale [causal mask]) v over
// q, k, v of shape [B, H, T, D], with an online softmax over key tiles and
// float32 running statistics (m, l) and accumulator, so the [Tq, Tk] score
// matrix never reaches device memory.  The causal mask is kj > qi, both
// counted from 0 (Tq may differ from Tk); keys past Tk are masked; rows
// whose every key is masked give 0.
//
// What bounds it on an H100: by the roofline, bytes.  At [8, 8, 512, 64]
// bf16 causal the call must move 16.8 MB (about 5 us at 3.35 TB/s) against
// 2.15 GFLOP of causal work (about 2.2 us at 989 TFLOP/s on the tensor
// cores).  Both products therefore have to run on the tensor cores, and the
// tiles have to arrive while the previous ones are multiplied.
//
// Two kernels, chosen by the operands' type:
//
// bf16 (`flash_tc_kernel`, route "tc"): tensor cores and TMA.
//  - Persistent: one block per SM walks a share of the work items, each
//    128 query rows of one (b, h) (under the causal mask the items with
//    the most keys first), with two consumer warpgroups of 64 rows each
//    and one producer warp.  Such a block is compiled for 168 registers a
//    thread: D = 128 holds more and spills (setmaxnreg did not raise the
//    compiler's budget).
//  - The producer loads each item's Q tile into one of two buffers, and
//    keeps a ring of K and V tiles (128 keys x D; 3 stages, 2 at D = 128)
//    in flight by TMA, running on into the next item while the consumers
//    finish this one; each stage has a full barrier for K, one for V, and
//    one empty barrier the 8 consumer warps release.  q, k, v stay the
//    strided [B, H, T, D] views of [B, T, H, D] memory
//    MultiHeadAttention hands over: a 4-D tensor map over
//    (D, T, H, B) reads them without a copy.  Rows of 64 bf16 (128 bytes)
//    use the 128-byte swizzle; D = 128 is two such column chunks; D = 32
//    uses the 64-byte swizzle.  Keys and queries past T arrive as zeros.
//  - S = Q K^T by wgmma m64n128k16 (both operands from shared memory,
//    K-major), into float registers; the scale (times log2 e) and, only on
//    tiles that cross the diagonal or the Tk edge, the mask; the online
//    softmax on the accumulator fragment (a row lives in the 4 lanes of a
//    quad: two shuffles for its max; l is summed per thread and over the
//    quad at the end).  Under the causal mask the key loop stops at the
//    diagonal.
//  - P is rounded to bf16 in registers and is the register A operand of
//    O += P V (wgmma m64nDk16, V from shared memory, MN-major).  The two
//    products overlap the softmax: a warpgroup issues S_t = Q K_t and
//    O += P_{t-1} V_{t-1}, takes the softmax of S_t as soon as it is done
//    while the second product runs, then rescales O by alpha_t.  The
//    un-normalised p is rounded per key tile and l is summed from the
//    float32 p: mha_reference rounds the normalised p to bf16 instead,
//    inside KERNEL_TOL[bf16].
//  - O / l (l = 0 leaves 0) is written as bf16 pairs into the
//    [B, T, H, D]-ordered output the wrapper allocates; rows past Tq are
//    not written.  Where the caller asks for it (training), each row's
//    natural log-sum-exp, (m + log2 l) ln 2, goes to a float32 [B*H, Tq]
//    array beside it: the backward reads it instead of recomputing it.
//    That is a second instance of the kernel: serving passes no array and
//    runs the one compiled without the write (a run-time test of the
//    pointer changed how the whole kernel compiled, and slowed it).
//
// float32 (`flash_fwd_kernel`, route "f32", the first version, kept for
// float32 parity checks): float32 FMAs on the CUDA cores.
//  - grid = (query tiles of 64 rows, B*H).  Each block walks the key tiles
//    itself, in order, which is what the TPU got from its sequential third
//    grid axis.  Under the causal mask a block stops at the last key tile
//    that reaches its diagonal (the Pallas kernel's `run` predicate).
//  - Q, K and V tiles are staged in shared memory; s, m, l and the output
//    accumulator stay in float32 registers; p goes through shared memory in
//    float32 for the P.V product, exactly as the Pallas kernel keeps p in
//    float32.
//  - 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//    4*ty .. 4*ty+3, score columns tx + 16*j and output columns tx + 16*c.
//    Row max and row sum reduce over the 16 lanes of a half-warp with
//    shuffles.  K rows are padded by one float so the 16 lanes reading 16
//    different key rows hit 16 different banks.
//  - It writes the log-sum-exp m + ln l where asked, as "tc" does.
//  - Ragged Tq and Tk are handled by bounds checks in the kernel: rows past
//    Tq are computed on zeros and never stored, keys past Tk are masked to
//    -inf.  Operands are read, and the output written, through their
//    strides over (B, H, T); the last axis must be unit-stride.
//  - Bound by FMA and shared-memory issue (67 TFLOP/s peak on the CUDA
//    cores), far above the byte bound: it trades speed for parity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int ROWS = BQ / 16; // query rows per thread
constexpr int COLS = BK / 16; // score columns per thread
constexpr int PS = BK + 4;    // padded row stride of the p tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq,
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(blockIdx.y) * Tq + qi] =
          m[i] == -INFINITY ? 0.f : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
           Strides so, float sm_scale, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk, sq, sk,
      sv, so, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores (wgmma) fed by TMA ----------------------------------

namespace tc {

constexpr int BQ = 128;  // query rows per block: two warpgroups of 64
constexpr int BKV = 128; // keys per tile
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // + the producer warp

template <int D>
struct Layout {
  static constexpr int STAGES = D < 128 ? 3 : 2;  // K/V tiles in flight
  static constexpr int CW = D < 64 ? D : 64;  // columns of a swizzled chunk
  static constexpr int NCH = D / CW;          // chunks per row
  static constexpr int RB = 2 * CW;           // bytes of a chunk row
  static constexpr uint32_t SWZ =
      RB == 128 ? hopper::kSwizzle128 : hopper::kSwizzle64;
  static constexpr int CHUNK = BQ * RB;  // one column chunk of a tile
  static constexpr int TILE = BQ * D * 2;  // a Q, K or V tile (BQ == BKV)
  static constexpr int SMEM =
      1024 + TILE * (2 + 2 * STAGES) + 8 * (4 + 3 * STAGES);
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// S = Q K^T for this warpgroup's 64 rows: D / 16 steps along the head
// dimension, both operands K-major in shared memory; one commit group.
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[BKV / 2],
                                         const uint8_t* qa,
                                         const uint8_t* kt) {
  using L = Layout<D>;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off =
        (kk / (L::CW / 16)) * L::CHUNK + (kk % (L::CW / 16)) * 32;
    hopper::WgmmaSS<BKV>::mma<0, 0>(
        sc, hopper::smem_desc(qa + off, 16, 8 * L::RB, L::SWZ),
        hopper::smem_desc(kt + off, 16, 8 * L::RB, L::SWZ), kk);
  }
  hopper::wgmma_commit();
}

// O += P V: P the register A operand, 16 keys a step; V MN-major in shared
// memory; one commit group.
template <int D>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         const uint8_t* vt) {
  using L = Layout<D>;
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    hopper::WgmmaRS<D>::template mma<1>(
        acc, pa[kk],
        hopper::smem_desc(vt + kk * 16 * L::RB, L::CHUNK, 8 * L::RB,
                          L::SWZ),
        1);
  hopper::wgmma_commit();
}

// The online softmax of one tile of scores, in place (sc becomes the
// un-normalised p), in the log2 domain: scale, mask where `edge` (the tile
// crosses the diagonal or the Tk edge), update this thread's rows' m and
// l, and return the factor alpha that rescales their O.
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int row_lo, int q4, int Tk,
                                             int causal, bool edge,
                                             float scale_log2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * hh + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * q4 + e;
          if (col >= Tk || (causal && col > row)) x = -INFINITY;
        }
        sc[4 * j + 2 * hh + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    // nothing unmasked yet: alpha = p = exp2(-inf) = 0 instead of NaN
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[hh] = hopper::exp2_approx(m[hh] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = hopper::exp2_approx(sc[4 * j + 2 * hh + e] - m_use);
        sc[4 * j + 2 * hh + e] = p;
        sum += p;
      }
    l[hh] = l[hh] * alpha[hh] + sum;
    m[hh] = m_new;
  }
}

// LSE: also write each row's log-sum-exp (a separate instance, so that
// serving runs the kernel compiled without that code).
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
                int H, int Tq, int Tk,
                long long sob, long long soh, long long sot, float scale_log2,
                int causal) {
  using L = Layout<D>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align1024(smem_raw);
  uint8_t* ks = qs + 2 * L::TILE;  // Q is double-buffered
  uint8_t* vs = ks + S * L::TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + S * L::TILE);
  uint64_t* q_free = q_full + 2;
  uint64_t* k_full = q_free + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* kv_free = v_full + S;

  // under the causal mask the last query tiles have the most keys
  const hopper::Items items{(Tq + BQ - 1) / BQ, B * H, causal,
                            static_cast<int>(gridDim.x)};
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_free[i], CONSUMER_WARPS);
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
      int t = 0;  // K/V tiles loaded so far, over all of this block's items
      for (int r = 0;; ++r) {
        const int i = items.item(c, r);
        if (i >= items.count()) break;
        const int q0 = items.tile(i) * BQ;
        const int b = (i % items.BH) / H, h = (i % items.BH) % H;
        const int n_kt = ((causal ? min(Tk, q0 + BQ) : Tk) + BKV - 1) / BKV;
        if (r >= 2) hopper::mbar_wait(&q_free[r & 1], (r / 2 - 1) & 1);
        hopper::mbar_expect_tx(&q_full[r & 1], L::TILE);
        for (int ch = 0; ch < L::NCH; ++ch)
          hopper::tma_load_4d(qs + (r & 1) * L::TILE + ch * L::CHUNK, &mq,
                              &q_full[r & 1], ch * L::CW, q0, h, b);
        for (int kt = 0; kt < n_kt; ++kt, ++t) {
          const int s = t % S;
          if (t >= S) hopper::mbar_wait(&kv_free[s], (t / S - 1) & 1);
          hopper::mbar_expect_tx(&k_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(ks + s * L::TILE + ch * L::CHUNK, &mk,
                                &k_full[s], ch * L::CW, kt * BKV, h, b);
          hopper::mbar_expect_tx(&v_full[s], L::TILE);
          for (int ch = 0; ch < L::NCH; ++ch)
            hopper::tma_load_4d(vs + s * L::TILE + ch * L::CHUNK, &mv,
                                &v_full[s], ch * L::CW, kt * BKV, h, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each
  // item; this thread rows row_lo and row_lo + 8, columns 8 j + 2 q4 (+1)
  // of each fragment
  const int wg = warp / 4;
  const int g = lane / 4;
  const int q4 = lane % 4;
  float acc[D / 2];
  float m[2], l[2];  // l: this thread's share of the row sums
  float alpha[2];
  float sc[BKV / 2];
  uint32_t pa[BKV / 16][4];
  int t = 0;  // K/V tiles consumed so far, over all of this block's items
  for (int r = 0;; ++r) {
    const int i = items.item(c, r);
    if (i >= items.count()) break;
    const int q0 = items.tile(i) * BQ;
    const int b = (i % items.BH) / H, h = (i % items.BH) % H;
    const int n_kt = ((causal ? min(Tk, q0 + BQ) : Tk) + BKV - 1) / BKV;
    const int row_lo = q0 + 64 * wg + 16 * (warp % 4) + g;
    const int row_min = q0 + 64 * wg;
    const uint8_t* qa = qs + (r & 1) * L::TILE + 64 * wg * L::RB;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    // Pipelined: while the tensor cores multiply P_{kt-1} V_{kt-1}, the
    // warpgroup takes the softmax of S_kt.
    hopper::mbar_wait(&q_full[r & 1], (r / 2) & 1);
    if (n_kt > 0) {
      hopper::mbar_wait(&k_full[t % S], (t / S) & 1);
      qk_issue<D>(sc, qa, ks + (t % S) * L::TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax_tile(sc, m, l, alpha, 0, row_lo, q4, Tk, causal,
                   BKV > Tk || (causal && BKV - 1 > row_min), scale_log2);
      hopper::pack_frag(pa, sc);
    }
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = (t + kt) % S;
      const int sp = (t + kt - 1) % S;
      const int k0 = kt * BKV;
      hopper::mbar_wait(&k_full[s], ((t + kt) / S) & 1);
      qk_issue<D>(sc, qa, ks + s * L::TILE);
      hopper::mbar_wait(&v_full[sp], ((t + kt - 1) / S) & 1);
      pv_issue<D>(acc, pa, vs + sp * L::TILE);
      hopper::wgmma_wait<1>();  // S_kt is done; P V may run on
      hopper::fence_regs(sc);
      softmax_tile(sc, m, l, alpha, k0, row_lo, q4, Tk, causal,
                   k0 + BKV > Tk || (causal && k0 + BKV - 1 > row_min),
                   scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
      if (lane == 0) hopper::mbar_arrive(&kv_free[sp]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * j + 2 * hh] *= alpha[hh];
          acc[4 * j + 2 * hh + 1] *= alpha[hh];
        }
      hopper::pack_frag(pa, sc);
    }
    if (n_kt > 0) {
      const int sl = (t + n_kt - 1) % S;
      hopper::mbar_wait(&v_full[sl], ((t + n_kt - 1) / S) & 1);
      pv_issue<D>(acc, pa, vs + sl * L::TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) hopper::fence_regs(pa[kk]);
      if (lane == 0) hopper::mbar_arrive(&kv_free[sl]);
    }
    // every product of this item is done: its Q buffer may be refilled
    if (lane == 0) hopper::mbar_arrive(&q_free[r & 1]);
    t += n_kt;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = lt == 0.f ? 0.f : 1.f / lt;  // fully masked -> 0
      const int row = row_lo + 8 * hh;
      // the natural log-sum-exp, from the log2-domain max: (m + log2 l) ln 2
      if constexpr (LSE) {
        if (q4 == 0 && row < Tq)
          lse[static_cast<long long>(i % items.BH) * Tq + row] =
              m[hh] == -INFINITY
                  ? 0.f
                  : (m[hh] + hopper::log2_approx(lt)) * 0.6931471805599453f;
      }
      if (row < Tq) {
        __nv_bfloat16* orow = o + b * sob + h * soh + row * sot;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * q4) =
              hopper::pack_bf16(acc[4 * j + 2 * hh] * inv,
                                acc[4 * j + 2 * hh + 1] * inv);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
           Strides so, float sm_scale, int causal, cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapSwizzle swizzle = L::RB == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  const void* base[3] = {q, k, v};
  const Strides* st[3] = {&sq, &sk, &sv};
  const int T[3] = {Tq, Tk, Tk};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    // (D, T, H, B), innermost first; a box is CW columns x 128 rows
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(T[i]),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[i]->t) * 2,
                                   static_cast<cuuint64_t>(st[i]->h) * 2,
                                   static_cast<cuuint64_t>(st[i]->b) * 2};
    const cuuint32_t box[4] = {L::CW, BQ, 1, 1};
    const int err = hopper::make_map(&maps[i], base[i], 4, dims, strides,
                                     box, swizzle);
    if (err) return err;
  }
  const auto kernel =
      lse != nullptr ? flash_tc_kernel<D, true> : flash_tc_kernel<D, false>;
  const cudaError_t attr = hopper::allow_smem(kernel, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // persistent: one block per SM of the current device, or one per item
  // where there are fewer
  const int n_sm = hopper::sm_count();
  const long long n_items = static_cast<long long>((Tq + BQ - 1) / BQ) * B * H;
  const int grid = n_items < n_sm ? static_cast<int>(n_items) : n_sm;
  kernel<<<grid, THREADS, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, B, H,
      Tq, Tk, so.b, so.h, so.t, sm_scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch_route(int route, const void* q, const void* k, const void* v,
                 void* o, float* lse, int B, int H, int Tq, int Tk,
                 Strides sq, Strides sk, Strides sv, Strides so,
                 float sm_scale, int causal, cudaStream_t stream) {
  if (route == 0)
    return launch<float, D>(q, k, v, o, lse, B, H, Tq, Tk, sq, sk, sv, so,
                            sm_scale, causal, stream);
  if (route == 1)
    return tc::launch<D>(q, k, v, o, lse, B, H, Tq, Tk, sq, sk, sv, so,
                         sm_scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// route: 0 = "f32" (float32 operands, CUDA cores), 1 = "tc" (bf16 operands,
// tensor cores; the base of each operand 16-byte aligned and its B, H and T
// strides multiples of 8).  Strides are in elements, for the B, H and T
// axes of each operand (the D axis is unit-stride).  `lse`, when not null,
// receives each row's natural log-sum-exp of its scaled, masked scores as
// float32 [B*H, Tq] (0 for a row whose every key is masked): what the
// backward (flash_attention_bwd.cu) takes instead of recomputing it.
// Returns
// cudaGetLastError() after the launch, or an error code for a head
// dimension or route without an instance or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int route, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, float sm_scale, int causal,
    void* stream) {
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      so{sob, soh, sot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_route<32>(route, q, k, v, o, lse, B, H, Tq, Tk, sq, sk,
                              sv, so, sm_scale, causal, st);
    case 64:
      return launch_route<64>(route, q, k, v, o, lse, B, H, Tq, Tk, sq, sk,
                              sv, so, sm_scale, causal, st);
    case 128:
      return launch_route<128>(route, q, k, v, o, lse, B, H, Tq, Tk, sq, sk,
                               sv, so, sm_scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
