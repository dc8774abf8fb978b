// BDRecord file IO (the port's own copy of the repo's host record codec,
// bound by bigdl_torch/utils/native.py): the sharded record format
// replacing BigDL's Hadoop SequenceFile datasets (reference:
// dataset/DataSet.scala:319 SeqFileFolder; ETL in
// models/utils/ImageNetSeqFileGenerator.scala).  TFRecord framing:
//   u64 length | u32 masked_crc(length) | payload | u32 masked_crc(payload)
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "crc32c.h"

namespace {

struct Writer {
  FILE* f;
};

struct Reader {
  FILE* f;
  std::vector<char> buf;
};

bool WriteAll(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool ReadAll(FILE* f, void* p, size_t n) { return fread(p, 1, n, f) == n; }

}  // namespace

extern "C" {

void* bigdl_torch_record_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  // Large stdio buffer: sequential-write workload.
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return new Writer{f};
}

int bigdl_torch_record_writer_write(void* handle, const char* data,
                                    uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  char header[8];
  std::memcpy(header, &len, 8);
  uint32_t hcrc = bigdl_torch::MaskedCrc32c(header, 8);
  uint32_t pcrc = bigdl_torch::MaskedCrc32c(data, len);
  if (!WriteAll(w->f, header, 8) || !WriteAll(w->f, &hcrc, 4) ||
      !WriteAll(w->f, data, len) || !WriteAll(w->f, &pcrc, 4))
    return -1;
  return 0;
}

int bigdl_torch_record_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

void* bigdl_torch_record_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return new Reader{f, {}};
}

// Returns payload length (>=0), -1 on clean EOF, -2 on corruption/short read.
// Exceptions (e.g. bad_alloc on a bogus length from a truncated file) must
// not unwind through the ctypes FFI frame, so the body is fenced.
int64_t bigdl_torch_record_reader_next(void* handle) try {
  Reader* r = static_cast<Reader*>(handle);
  char header[8];
  size_t got = fread(header, 1, 8, r->f);
  if (got == 0) return -1;
  if (got < 8) return -2;
  uint32_t hcrc;
  if (!ReadAll(r->f, &hcrc, 4)) return -2;
  if (hcrc != bigdl_torch::MaskedCrc32c(header, 8)) return -2;
  uint64_t len;
  std::memcpy(&len, header, 8);
  r->buf.resize(len);
  if (len && !ReadAll(r->f, r->buf.data(), len)) return -2;
  uint32_t pcrc;
  if (!ReadAll(r->f, &pcrc, 4)) return -2;
  if (pcrc != bigdl_torch::MaskedCrc32c(r->buf.data(), len)) return -2;
  return static_cast<int64_t>(len);
} catch (...) {
  return -2;
}

const char* bigdl_torch_record_reader_data(void* handle) {
  return static_cast<Reader*>(handle)->buf.data();
}

void bigdl_torch_record_reader_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  fclose(r->f);
  delete r;
}

}  // extern "C"
