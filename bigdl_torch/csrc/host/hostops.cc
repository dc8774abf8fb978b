// Host-side parallel kernels for the data path and the bf16 wire format
// (the port's own copy, bound by bigdl_torch/utils/native.py).
//
// Reference: BigDL's FP16CompressedTensor compresses float32 gradients to
// bf16-style truncated halves with a loop parallelised over
// Engine.coreNumber() threads (parameters/FP16CompressedTensor.scala:122-222,
// truncate at :271-279).  On TPU the *gradient* path is native bf16 inside
// XLA; these host kernels serve checkpoint compression and the input
// pipeline (batch assembly = the role of MTLabeledBGRImgToBatch's thread
// pool, dataset/image/MTLabeledBGRImgToBatch.scala).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int g_num_threads = static_cast<int>(std::thread::hardware_concurrency());

// Run fn(begin, end) over [0, n) split across nthreads.
template <typename Fn>
void ParallelFor(size_t n, int nthreads, Fn fn) {
  if (nthreads <= 1 || n < (1u << 16)) {
    fn(size_t{0}, n);
    return;
  }
  nthreads = std::min<size_t>(nthreads, n);
  std::vector<std::thread> workers;
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    size_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    workers.emplace_back([=] { fn(b, e); });
  }
  for (auto& w : workers) w.join();
}

// Round-to-nearest-even f32 -> bf16, matching XLA/TPU semantics (the
// reference truncates — FP16CompressedTensor.scala:271-279 keeps the top 16
// bits; rounding is strictly more accurate and matches the hardware).
inline uint16_t F32ToBf16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  if ((bits & 0x7fffffffu) > 0x7f800000u)  // NaN: quiet it, keep sign
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7fffu + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

}  // namespace

extern "C" {

void bigdl_torch_set_num_threads(int n) { g_num_threads = n > 0 ? n : 1; }
int bigdl_torch_get_num_threads() { return g_num_threads; }

void bigdl_torch_f32_to_bf16(const float* src, uint16_t* dst, size_t n) {
  ParallelFor(n, g_num_threads, [&](size_t b, size_t e) {
    for (size_t i = b; i < e; ++i) dst[i] = F32ToBf16(src[i]);
  });
}

void bigdl_torch_bf16_to_f32(const uint16_t* src, float* dst, size_t n) {
  ParallelFor(n, g_num_threads, [&](size_t b, size_t e) {
    for (size_t i = b; i < e; ++i) {
      uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(&dst[i], &bits, 4);
    }
  });
}

// Gather n equally-sized rows into one contiguous batch buffer (the memcpy
// half of SampleToMiniBatch / MTLabeledBGRImgToBatch batching).
void bigdl_torch_gather_rows(char* dst, const char* const* srcs,
                             size_t row_bytes, size_t n) {
  ParallelFor(n * row_bytes, g_num_threads, [&](size_t b, size_t e) {
    size_t first = b / row_bytes, last = (e + row_bytes - 1) / row_bytes;
    for (size_t i = first; i < last && i < n; ++i) {
      size_t lo = std::max(b, i * row_bytes) - i * row_bytes;
      size_t hi = std::min(e, (i + 1) * row_bytes) - i * row_bytes;
      if (hi > lo) std::memcpy(dst + i * row_bytes + lo, srcs[i] + lo, hi - lo);
    }
  });
}

// Parallel sum of k float buffers into dst (the gradient-aggregation loop of
// DistriOptimizer.scala:226-250, kept for host-side reference optimizers).
// dst is fully overwritten (initialized from srcs[0]).
void bigdl_torch_reduce_sum_f32(float* dst, const float* const* srcs,
                                int k, size_t n) {
  if (k <= 0) return;
  ParallelFor(n, g_num_threads, [&](size_t b, size_t e) {
    std::memcpy(dst + b, srcs[0] + b, (e - b) * sizeof(float));
    for (int j = 1; j < k; ++j) {
      const float* s = srcs[j];
      for (size_t i = b; i < e; ++i) dst[i] += s[i];
    }
  });
}

}  // extern "C"
