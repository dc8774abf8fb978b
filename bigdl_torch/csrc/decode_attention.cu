// Cached decode attention with the cache append, for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the jnp attention of one decode position against a KV cache,
// bigdl_tpu/serve/decode.py `_slot_attention` (per-slot positions) and
// bigdl_tpu/models/decode.py `_cached_attention` (one position for every
// row), B8, and the cache write both make first (`dynamic_update_slice`).
// For each (slot s, head h), with p = pos[s] and n = p + 1 live keys:
//
//     k_p, v_p = k_new, v_new            rounded to the cache type, stored
//     s_j = (q . k_j) / sqrt(D)          float32, j < n
//     w_j = exp(s_j - max s) / sum exp   float32
//     o   = sum_j w_j v_j                float32, cast to q's type
//
// q, k_new and v_new are one row per (slot, head), [S, H, 1, D] in the
// compute type; the caches are [S, H, L, D] in the cache type (bf16 or
// float32, each may be either).  Keys at j >= n are never read: a stale row
// left by a slot's previous occupant, or the zeros of a grown cache,
// contributes exactly nothing, as the reference's exact-zero softmax
// weights do.  The reference divides the scores by sqrt(D) (not a folded
// multiply), and so does this kernel.  pos stays on the device (int32 [S]);
// the host never reads it.
//
// What bounds it on an H100: bytes.  Every live K and V row is read once
// (2 * n * D elements per (s, h)) against 4 * n * D operations: about one
// operation per byte in bf16, far below the ~295 at which the tensor cores
// would be the limit, so the arithmetic stays on the CUDA cores.  At
// [8, 8, 512, 64] bf16 with every pos at 511 the call moves 8.39 MB, 2.5 us
// at 3.35 TB/s; the engine's calls move less (each slot reads to its own
// position), so the launch and the latency of the first bytes weigh most.
//
// Design (one launch, the append included):
//  1. A thread-block cluster of C blocks (128 threads each) per (s, h); C
//     comes from the host, a run-time value chosen from S, H and L alone
//     (never from pos, so the host does not sync).  Block c takes rows
//     [c * ceil(n / C), min(n, (c + 1) * ceil(n / C))) of its slot's n live
//     rows: the work follows each slot's own horizon, and a block past it
//     has no rows.
//  2. A block's rows are one contiguous byte range of K and one of V (rows
//     of D in order).  Thread 0 streams them with 1D bulk async copies
//     (cp.async.bulk, no tensor map, nothing encoded on the host) in tiles
//     of ROWS rows into a ring of STAGES stages, K and V of a tile on one
//     mbarrier, every stage in flight as soon as the position has arrived;
//     a __syncthreads frees a stage for the next tile only where the ring
//     wraps.  What waits for no position (q, the new row, the barriers) is
//     started before it.
//  3. Each tile is computed as it lands.  A row of D elements is read by
//     D / VEC lanes, VEC elements (16 bytes) each; the row's dot product
//     meets over its lanes by xor-shuffles.  Each row group (the lanes of
//     one row) keeps its own online softmax in float32 over the rows it
//     reads: running max m, sum l, and the accumulator of its VEC elements
//     of D, rescaled once a tile.
//  4. The append: each lane rounds its VEC elements of k_new and v_new to
//     the cache type.  In the block whose rows end at p, warp 0's first row
//     group stores them to row p of the caches, and the row group that
//     reads row p of the last tile writes its elements over the stale row
//     the copy brought before reading them back (that stage is not reused).
//     No other block reads row p, so no order between blocks is needed; no
//     other row of the caches is written.
//  5. A warp's row groups meet at their common max by xor-shuffles, the
//     warps in shared memory, in a fixed order.  Each block but rank 0
//     stores its (m, l, acc[D]) into rank 0's shared memory (distributed
//     shared memory, st.async, each store counted as bytes on an mbarrier
//     of rank 0) and exits; rank 0 waits for those bytes, combines
//     c = 0..C-1 in order, M = max m_c,
//     o = sum e^(m_c - M) acc_c / sum e^(m_c - M) l_c, and writes o.  A
//     cluster barrier, arrived at when a block starts, is waited on before
//     the first store, so rank 0 runs and its mbarrier is initialised.
//     Block 0 always holds row 0, so M is finite and an empty block
//     (m = -inf, l = 0, acc = 0) weighs exactly 0.  A fixed C and a fixed
//     order make the output bit-repeatable, with no atomics and no scratch
//     in device memory.
//
// Rows, positions and the bounds of a block's rows are int32 (the wrapper
// keeps L <= 2^30); element offsets into the caches are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// the largest cluster the launch takes (above 8 it needs the non-portable
// size; the wrapper's splits stop at 8, chip_smoke times 16 beside it)
constexpr int MAX_SPLITS = 16;
// shared memory a block gives its ring of K and V tiles
constexpr int RING_BYTES = 64 * 1024;

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

// VEC elements of a cache row as one 16-byte piece, in float32: loaded,
// or stored from float32 values the cache type holds exactly
template <typename TC>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The row layout of a block and its ring, by cache type and head dim.
template <typename TC, int D>
struct Ring {
  static constexpr int VEC = Vec<TC>::N;
  static constexpr int LPR = D / VEC;           // lanes per cache row
  static constexpr int RPW = 32 / LPR;          // rows a warp reads at once
  static constexpr int STEP = WARPS * RPW;      // rows the block reads at once
  static constexpr int ROWS = STEP > 32 ? STEP : 32;  // rows a tile
  static constexpr int PER = ROWS / STEP;       // a row group's rows a tile
  static constexpr int TILE_BYTES = ROWS * D * static_cast<int>(sizeof(TC));
  static constexpr int FIT = RING_BYTES / (2 * TILE_BYTES);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int SMEM = STAGES * 2 * TILE_BYTES;
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "layout");
  static_assert(ROWS % STEP == 0 && TILE_BYTES % 16 == 0, "tile");
  static_assert(D <= THREADS, "the combines take a thread per element of D");
};

struct Operands {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* k;
  void* v;
  void* o;
  const int* pos;
  int H, L, C;
  // (slot, head) strides in elements of q, k_new, v_new, k, v
  long long sqs, sqh, sns, snh, sms, smh, sks, skh, svs, svh;
};

// (m, l, acc) of one partial softmax merged into another: both maxima may
// be -inf (no rows), and then the weights are 0, never NaN
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Operands a) {
  using R = Ring<TC, D>;
  constexpr int VEC = R::VEC, LPR = R::LPR, RPW = R::RPW, STEP = R::STEP;
  constexpr int ROWS = R::ROWS, PER = R::PER, STAGES = R::STAGES;

  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t gathered;    // rank 0: every state landed
  __shared__ float part[WARPS][D + 2];          // per warp: m, l, acc[D]
  __shared__ float comb[MAX_SPLITS][D + 2];     // rank 0: per block

  // a cluster is C consecutive blocks of x; block c is its rank c
  const int C = a.C;
  const int c = blockIdx.x % C;
  const int sh = blockIdx.x / C;
  const int s = sh / a.H;
  const int h = sh % a.H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane / LPR;               // this lane's row in a block step
  const int d0 = (lane % LPR) * VEC;      // its first element of D

  // the loads the launch waits on first: the position, q's slice and this
  // lane's slice of the new row, rounded to the cache type
  int p = a.pos[s];
  const TQ* qrow = static_cast<const TQ*>(a.q) + s * a.sqs + h * a.sqh;
  const TQ* knrow = static_cast<const TQ*>(a.k_new) + s * a.sns + h * a.snh;
  const TQ* vnrow = static_cast<const TQ*>(a.v_new) + s * a.sms + h * a.smh;
  float qv[VEC], kn[VEC], vn[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    qv[e] = to_float(qrow[d0 + e]);
    kn[e] = to_float(from_float<TC>(to_float(knrow[d0 + e])));
    vn[e] = to_float(from_float<TC>(to_float(vnrow[d0 + e])));
  }

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(&gathered, 1);
    hopper::fence_barrier_init();
  }
  // this block runs and its barriers are initialised; rank 0's is waited
  // for before the first write into its shared memory
  hopper::cluster_arrive_relaxed();

  p = p < 0 ? 0 : (p >= a.L ? a.L - 1 : p);
  const int n = p + 1;
  const int chunk = (n + C - 1) / C;
  const int r0 = min(n, c * chunk);
  const int r1 = min(n, r0 + chunk);
  const int ntiles = (r1 - r0 + ROWS - 1) / ROWS;
  const bool holds_p = r1 > r0 && r1 == n;   // row p is this block's last
  TC* kb = static_cast<TC*>(a.k) + s * a.sks + h * a.skh;
  TC* vb = static_cast<TC*>(a.v) + s * a.svs + h * a.svh;

  // tile t of this block's rows into stage t % STAGES, K then V
  auto issue = [&](int t) {
    const int j0 = r0 + t * ROWS;
    const uint32_t bytes = static_cast<uint32_t>(min(ROWS, r1 - j0)) * D *
                           sizeof(TC);
    unsigned char* st = ring + (t % STAGES) * 2 * R::TILE_BYTES;
    uint64_t* bar = &full[t % STAGES];
    hopper::mbar_expect_tx(bar, 2 * bytes);
    hopper::bulk_load_1d(st, kb + static_cast<long long>(j0) * D, bytes, bar);
    hopper::bulk_load_1d(st + R::TILE_BYTES,
                         vb + static_cast<long long>(j0) * D, bytes, bar);
  };
  if (tid == 0) {                         // its own barriers: no sync first
    for (int t = 0; t < min(STAGES, ntiles); ++t) issue(t);
  }
  if (holds_p && warp == 0 && r == 0) {   // the append: lanes 0..LPR-1
    Vec<TC>::store(kb + static_cast<long long>(p) * D + d0, kn);
    Vec<TC>::store(vb + static_cast<long long>(p) * D + d0, vn);
  }
  __syncthreads();                        // the barriers, for every thread

  const float sqrt_d = sqrtf(static_cast<float>(D));
  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stg = t % STAGES;
    hopper::mbar_wait(&full[stg], (t / STAGES) & 1);
    TC* sk = reinterpret_cast<TC*>(ring + stg * 2 * R::TILE_BYTES);
    TC* sv = reinterpret_cast<TC*>(ring + stg * 2 * R::TILE_BYTES +
                                   R::TILE_BYTES);
    const int j0 = r0 + t * ROWS;
    const int rows = min(ROWS, r1 - j0);
    // row p came stale with the copy: the lanes that read it write the new
    // row over it first (the block's last tile: its stage is not reused)
    if (holds_p && t == ntiles - 1 && (p - j0) % STEP == warp * RPW + r) {
      Vec<TC>::store(sk + (p - j0) * D + d0, kn);
      Vec<TC>::store(sv + (p - j0) * D + d0, vn);
    }
    float sc[PER];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int jj = i * STEP + warp * RPW + r;
      float kv[VEC];
      if (jj < rows) {
        Vec<TC>::load(sk + jj * D + d0, kv);
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
      sc[i] = jj < rows ? dot / sqrt_d : -INFINITY;
      tmax = fmaxf(tmax, sc[i]);
    }
    const float m_new = fmaxf(m, tmax);
    if (m_new != -INFINITY) {             // the same for a row's lanes
      const float scale = weight(m, m_new);
      l *= scale;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= scale;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int jj = i * STEP + warp * RPW + r;
        if (jj < rows) {
          const float pj = expf(sc[i] - m_new);
          l += pj;
          float vv[VEC];
          Vec<TC>::load(sv + jj * D + d0, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
        }
      }
      m = m_new;
    }
    if (t + STAGES < ntiles) {            // the ring wraps: free stg
      __syncthreads();
      if (tid == 0) issue(t + STAGES);
    }
  }

  // the row groups of a warp: their common max, each group's state scaled
  // to it once, then sums by xor-shuffles (lanes below LPR end with them)
  float mw = m;
#pragma unroll
  for (int off = LPR; off < 32; off *= 2)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  const float scale = weight(m, mw);
  l *= scale;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] *= scale;
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  m = mw;
  if (lane < LPR) {
    if (lane == 0) {
      part[warp][0] = m;
      part[warp][1] = l;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[warp][2 + d0 + e] = acc[e];
  }
  __syncthreads();

  // the warps in order: this block's (M, lsum, sum[D]), into rank 0's comb
  float M = -INFINITY, lsum = 0.f, sum = 0.f;
  if (tid < D) {
    M = part[0][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, part[w][0]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = weight(part[w][0], M);
      lsum += wt * part[w][1];
      sum += wt * part[w][2 + tid];
    }
  }
  hopper::cluster_wait();                 // rank 0 runs, `gathered` is set
  if (c != 0) {
    // store into rank 0 and go: each store counts its 4 bytes on rank 0's
    // `gathered`, which rank 0 waits on
    if (tid < D) {
      const uint32_t dst = hopper::cluster_map(&comb[c][0], 0);
      const uint32_t bar = hopper::cluster_map(&gathered, 0);
      if (tid == 0) {
        hopper::cluster_store_async(dst, M, bar);
        hopper::cluster_store_async(dst + 4, lsum, bar);
      }
      hopper::cluster_store_async(dst + 4 * (2 + tid), sum, bar);
    }
    return;
  }
  if (tid == 0) {
    comb[0][0] = M;
    comb[0][1] = lsum;
    hopper::mbar_expect_tx(&gathered, (C - 1) * (D + 2) * 4);
  }
  if (tid < D) comb[0][2 + tid] = sum;
  __syncthreads();
  if (tid < D) {
    hopper::mbar_wait(&gathered, 0);
    float Mx = comb[0][0];
    for (int b = 1; b < C; ++b) Mx = fmaxf(Mx, comb[b][0]);
    float num = 0.f, den = 0.f;
    for (int b = 0; b < C; ++b) {
      const float wt = weight(comb[b][0], Mx);
      num += wt * comb[b][2 + tid];
      den += wt * comb[b][1];
    }
    static_cast<TQ*>(a.o)[static_cast<long long>(sh) * D + tid] =
        from_float<TQ>(num / den);
  }
}

// An empty kernel launched like decode_attention_kernel: the floor under
// which no launch of that grid and cluster can finish.
__global__ void __launch_bounds__(THREADS) empty_kernel() {}

// The attributes a launch of `kernel` with `smem` bytes of dynamic shared
// memory and clusters of C blocks needs, set on the current device (each
// call: an attribute belongs to the device's context).  The engine's
// calls (bf16 caches, D = 64, C <= 8) need none.
template <typename K>
cudaError_t prepare(K kernel, int smem, int C) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename K, typename... Args>
int launch_cluster(K kernel, int blocks, int C, int smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int D>
int launch(const Operands& a, int S, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TC, D>;
  const cudaError_t ready = prepare(kernel, Ring<TC, D>::SMEM, a.C);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  return launch_cluster(kernel, S * a.H * a.C, a.C, Ring<TC, D>::SMEM, stream,
                        a);
}

template <typename TQ, typename TC>
int launch_d(int D, const Operands& a, int S, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TQ, TC, 16>(a, S, stream);
    case 32: return launch<TQ, TC, 32>(a, S, stream);
    case 64: return launch<TQ, TC, 64>(a, S, stream);
    case 128: return launch<TQ, TC, 128>(a, S, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TC>
int ring_smem(int D) {
  switch (D) {
    case 16: return Ring<TC, 16>::SMEM;
    case 32: return Ring<TC, 32>::SMEM;
    case 64: return Ring<TC, 64>::SMEM;
    case 128: return Ring<TC, 128>::SMEM;
    default: return -1;
  }
}

}  // namespace

// q, k_new, v_new: [S, H, 1, D] with strides (s*s, s*h, -, 1), k_new and
// v_new of q's type; k, v: [S, H, L, D] with strides (s*s, s*h, D, 1),
// 16-byte aligned bases and (s, h) strides, written at row pos[s] only;
// o: contiguous [S, H, 1, D] of q's type; pos: int32 [S] on the device.
// q_bf16 / cache_bf16 pick bf16 (1) or float32 (0); C (1..16) blocks per
// (s, h) in a cluster.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int bigdl_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k, void* v,
    void* o, const int* pos, int q_bf16, int cache_bf16, int S, int H, int L,
    int D, int C, long long sqs, long long sqh, long long sns, long long snh,
    long long sms, long long smh, long long sks, long long skh,
    long long svs, long long svh, void* stream) {
  if (C < 1 || C > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  const Operands a{q,   k_new, v_new, k,   v,   o,   pos, H,   L,   C,
                   sqs, sqh,   sns,   snh, sms, smh, sks, skh, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && cache_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, S, st);
  if (q_bf16) return launch_d<__nv_bfloat16, float>(D, a, S, st);
  if (cache_bf16) return launch_d<float, __nv_bfloat16>(D, a, S, st);
  return launch_d<float, float>(D, a, S, st);
}

// The empty kernel with the grid, cluster, block and shared memory of
// bigdl_decode_attention at (cache type, D, S, H, C).
extern "C" int bigdl_decode_attention_floor(int cache_bf16, int D, int S,
                                            int H, int C, void* stream) {
  const int smem =
      cache_bf16 ? ring_smem<__nv_bfloat16>(D) : ring_smem<float>(D);
  if (smem < 0 || C < 1 || C > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t ready = prepare(empty_kernel, smem, C);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  return launch_cluster(empty_kernel, S * H * C, C, smem,
                        static_cast<cudaStream_t>(stream));
}
