// The port's CRC32C (crc32c.cc) for the record files' frame: recordio.cc
// and prefetch.cc are linked with crc32c.cc into one host library
// (bigdl_torch/utils/cuda_build.py HOST_LIBRARIES["native"]).
#ifndef BIGDL_TORCH_HOST_CRC32C_H_
#define BIGDL_TORCH_HOST_CRC32C_H_

#include <cstddef>
#include <cstdint>

extern "C" uint32_t bigdl_torch_crc32c_extend(uint32_t crc, const char* data,
                                              size_t len);

namespace bigdl_torch {

// TFRecord-style masked CRC32C of `len` bytes.
inline uint32_t MaskedCrc32c(const void* data, size_t len) {
  uint32_t crc =
      bigdl_torch_crc32c_extend(0, static_cast<const char*>(data), len);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

}  // namespace bigdl_torch

#endif  // BIGDL_TORCH_HOST_CRC32C_H_
