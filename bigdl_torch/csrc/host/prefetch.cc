// Multithreaded BDRecord shard prefetcher (the port's own copy, bound by
// bigdl_torch/utils/native.py NativePrefetchReader): N reader threads pull
// whole shards off a work queue and push records into one bounded ring buffer
// the consumer pops from.  This is the native concurrent-read path playing
// the role Spark partitions play for the reference's SequenceFile datasets
// (dataset/DataSet.scala:319 SeqFileFolder: one task per partition reads
// its shard in parallel); the Python MT batcher then overlaps transform
// work on top.  Plain C++17: std::thread + mutex/condvar, no deps.
//
// C ABI (ctypes-friendly, mirrors bigdl_torch_record_reader_*):
//   bigdl_torch_prefetch_open(paths, n_paths, n_threads, capacity) -> handle
//   bigdl_torch_prefetch_next(handle) -> record length (>=0), -1 end, -2 error
//   bigdl_torch_prefetch_data(handle) -> pointer to last record's bytes
//   bigdl_torch_prefetch_close(handle)
// Record order is nondeterministic across shards (like Spark partition
// interleaving); order within one shard is preserved per thread.
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "crc32c.h"

extern "C" {
// from recordio.cc (declarations must match its definitions exactly)
void* bigdl_torch_record_reader_open(const char* path);
int64_t bigdl_torch_record_reader_next(void* handle);
const char* bigdl_torch_record_reader_data(void* handle);
void bigdl_torch_record_reader_close(void* handle);
}

namespace {

struct Prefetcher {
  std::vector<std::string> paths;
  size_t next_path = 0;           // guarded by mu
  std::deque<std::vector<char>> ring;
  size_t capacity;
  bool error = false;
  int live_workers = 0;
  std::mutex mu;
  std::condition_variable not_empty;   // consumer waits
  std::condition_variable not_full;    // producers wait
  std::vector<std::thread> threads;
  std::vector<char> current;      // last record handed to the consumer
  bool closing = false;

  void Worker() {
    for (;;) {
      std::string path;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (closing || next_path >= paths.size()) break;
        path = paths[next_path++];
      }
      void* r = bigdl_torch_record_reader_open(path.c_str());
      if (!r) {
        std::lock_guard<std::mutex> lk(mu);
        error = true;
        break;
      }
      for (;;) {
        int64_t n = bigdl_torch_record_reader_next(r);
        if (n < 0) {
          if (n < -1) {  // corrupt record (bad CRC / truncated)
            std::lock_guard<std::mutex> lk(mu);
            error = true;
          }
          break;
        }
        std::vector<char> rec(static_cast<size_t>(n));
        if (n > 0) memcpy(rec.data(), bigdl_torch_record_reader_data(r),
                          static_cast<size_t>(n));
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [&] { return ring.size() < capacity || closing; });
        if (closing) break;
        ring.push_back(std::move(rec));
        not_empty.notify_one();
      }
      bigdl_torch_record_reader_close(r);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (closing || error) break;
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    --live_workers;
    not_empty.notify_all();  // consumer may be waiting on the last worker
  }
};

}  // namespace

extern "C" {

void* bigdl_torch_prefetch_open(const char** paths, int64_t n_paths,
                          int64_t n_threads, int64_t capacity) {
  if (n_paths <= 0 || n_threads <= 0 || capacity <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->capacity = static_cast<size_t>(capacity);
  int workers = static_cast<int>(
      n_threads < n_paths ? n_threads : n_paths);
  p->live_workers = workers;
  for (int i = 0; i < workers; ++i)
    p->threads.emplace_back(&Prefetcher::Worker, p);
  return p;
}

// >=0: record of that many bytes available via bigdl_torch_prefetch_data.
// -1: clean end of all shards.  -2: IO/CRC error (after draining).
int64_t bigdl_torch_prefetch_next(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->not_empty.wait(lk, [&] {
    return !p->ring.empty() || p->live_workers == 0;
  });
  if (p->ring.empty()) return p->error ? -2 : -1;
  p->current = std::move(p->ring.front());
  p->ring.pop_front();
  p->not_full.notify_one();
  return static_cast<int64_t>(p->current.size());
}

void* bigdl_torch_prefetch_data(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  return p->current.data();
}

void bigdl_torch_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->closing = true;
    p->not_full.notify_all();
    p->not_empty.notify_all();
  }
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"
