// Host RAM bandwidth characterisation — the memRateTest analog
// (utilities/pcie_bandwidth_tests/memRateTest_asm.h:37-113: hand-written
// AVX scan loops immune to compiler elision). Portable version: 32-byte
// vector scan read / scan write loops with volatile sinks; threads via
// std::thread; optional per-thread buffers like main.cpp:207 (1 GiB each
// there; caller chooses here).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double scan_write(std::uint8_t* buf, std::size_t bytes, double seconds) {
  // 64-bit stores, 16x unrolled (mirrors the reference's vmovdqa unroll).
  auto* p = reinterpret_cast<volatile std::uint64_t*>(buf);
  const std::size_t words = bytes / 8;
  std::uint64_t total = 0;
  auto t0 = Clock::now();
  double elapsed = 0;
  do {
    for (std::size_t i = 0; i + 16 <= words; i += 16) {
      p[i] = i; p[i+1] = i; p[i+2] = i; p[i+3] = i;
      p[i+4] = i; p[i+5] = i; p[i+6] = i; p[i+7] = i;
      p[i+8] = i; p[i+9] = i; p[i+10] = i; p[i+11] = i;
      p[i+12] = i; p[i+13] = i; p[i+14] = i; p[i+15] = i;
    }
    total += words * 8;
    elapsed = std::chrono::duration<double>(Clock::now() - t0).count();
  } while (elapsed < seconds);
  return total / elapsed;
}

double scan_read(std::uint8_t* buf, std::size_t bytes, double seconds) {
  auto* p = reinterpret_cast<volatile std::uint64_t*>(buf);
  const std::size_t words = bytes / 8;
  std::uint64_t total = 0;
  std::uint64_t sink = 0;
  auto t0 = Clock::now();
  double elapsed = 0;
  do {
    std::uint64_t acc = 0;
    for (std::size_t i = 0; i + 16 <= words; i += 16) {
      acc ^= p[i] ^ p[i+1] ^ p[i+2] ^ p[i+3] ^ p[i+4] ^ p[i+5] ^ p[i+6] ^
             p[i+7] ^ p[i+8] ^ p[i+9] ^ p[i+10] ^ p[i+11] ^ p[i+12] ^
             p[i+13] ^ p[i+14] ^ p[i+15];
    }
    sink += acc;
    total += words * 8;
    elapsed = std::chrono::duration<double>(Clock::now() - t0).count();
  } while (elapsed < seconds);
  // Publish the sink so the reads cannot be elided.
  static std::atomic<std::uint64_t> g_sink{0};
  g_sink.store(sink, std::memory_order_relaxed);
  return total / elapsed;
}

}  // namespace

extern "C" {

// Aggregate bandwidth in bytes/s across `n_threads`, each scanning its own
// `bytes_per_thread` buffer for ~`seconds`. mode: 0 = write, 1 = read.
double membw_scan(std::uint32_t n_threads, std::uint64_t bytes_per_thread,
                  double seconds, std::uint32_t mode) {
  if (n_threads == 0 || bytes_per_thread < 4096) return -1.0;
  std::vector<std::uint8_t*> bufs(n_threads);
  for (auto& b : bufs) {
    b = static_cast<std::uint8_t*>(std::aligned_alloc(64, bytes_per_thread));
    if (!b) {
      for (auto* q : bufs) std::free(q);
      return -1.0;
    }
    std::memset(b, 1, bytes_per_thread);  // fault pages in
  }
  std::vector<double> rates(n_threads, 0.0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (std::uint32_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t] {
      rates[t] = mode == 0 ? scan_write(bufs[t], bytes_per_thread, seconds)
                           : scan_read(bufs[t], bytes_per_thread, seconds);
    });
  }
  double total = 0;
  for (std::uint32_t t = 0; t < n_threads; ++t) {
    threads[t].join();
    total += rates[t];
  }
  for (auto* b : bufs) std::free(b);
  return total;
}

}  // extern "C"
