// CRC32C (Castagnoli) for the checkpoint frame (bigdl_torch/utils/file_io.py):
// the port's own copy of the repo's host checksum, built with the host C++
// compiler (not nvcc) into bigdl_torch/_build/ at first use
// (bigdl_torch/utils/cuda_build.py build_host) and bound with ctypes
// (bigdl_torch/utils/crc32c.py).  SSE4.2's crc32 instruction where the CPU
// has it, a sliced-by-8 table otherwise.  The checksum is the one TFRecord
// frames and the JAX package's snapshots carry, so both packages read each
// other's files.
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <nmmintrin.h>
#define BIGDL_HAVE_SSE42_INTRIN 1
#endif

namespace {

// Sliced-by-8 software CRC32C; the tables are made at first use.
struct Tables {
  uint32_t t[8][256];
  Tables() {
    const uint32_t poly = 0x82f63b78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

const Tables& tables() {
  static Tables tb;
  return tb;
}

uint32_t crc32c_software(const void* data, size_t len, uint32_t seed) {
  const Tables& tb = tables();
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint32_t crc = seed ^ 0xffffffffu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    word ^= crc;
    crc = tb.t[7][word & 0xff] ^ tb.t[6][(word >> 8) & 0xff] ^
          tb.t[5][(word >> 16) & 0xff] ^ tb.t[4][(word >> 24) & 0xff] ^
          tb.t[3][(word >> 32) & 0xff] ^ tb.t[2][(word >> 40) & 0xff] ^
          tb.t[1][(word >> 48) & 0xff] ^ tb.t[0][word >> 56];
    p += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ tb.t[0][(crc ^ *p++) & 0xff];
  return crc ^ 0xffffffffu;
}

#ifdef BIGDL_HAVE_SSE42_INTRIN
__attribute__((target("sse4.2"))) uint32_t crc32c_hardware(const void* data,
                                                          size_t len,
                                                          uint32_t seed) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint64_t crc = seed ^ 0xffffffffu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    crc = _mm_crc32_u64(crc, word);
    p += 8;
    len -= 8;
  }
  uint32_t crc32 = static_cast<uint32_t>(crc);
  while (len--) crc32 = _mm_crc32_u8(crc32, *p++);
  return crc32 ^ 0xffffffffu;
}
#endif

}  // namespace

extern "C" {

// Streaming continuation: `crc` is the finalized CRC32C of the bytes seen
// so far (0 for the first chunk); returns the finalized CRC32C of the
// concatenation, so extend(extend(0, a), b) == crc32c(a + b).
uint32_t bigdl_torch_crc32c_extend(uint32_t crc, const char* data,
                                   size_t len) {
#ifdef BIGDL_HAVE_SSE42_INTRIN
  if (__builtin_cpu_supports("sse4.2")) return crc32c_hardware(data, len, crc);
#endif
  return crc32c_software(data, len, crc);
}

// 1 where the SSE4.2 instruction computes it, 0 where the table does.
int bigdl_torch_crc32c_hardware() {
#ifdef BIGDL_HAVE_SSE42_INTRIN
  return __builtin_cpu_supports("sse4.2") ? 1 : 0;
#else
  return 0;
#endif
}

}  // extern "C"
