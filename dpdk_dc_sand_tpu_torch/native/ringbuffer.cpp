// Lock-free SPSC chunk ring buffer — the host replacement for the
// reference's DPDK extmem chunk pool (dpdk_send_recv/dpdk_send.cpp:62-117:
// refcounted chunks marked reusable by a free callback; producer spins on
// chunk.active as backpressure). Here: a single-producer single-consumer
// ring of fixed-size slots with release/acquire atomics, plus drop and
// occupancy accounting (ibverbs_rx.c:303-319 sequence-gap model).
// rb_create_external puts the slots in a caller's arena (the port's
// page-locked torch buffer, so a slot is copied to the card directly);
// the ring then never frees it.
//
// C ABI for ctypes. No exceptions, no STL containers across the boundary.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

constexpr std::size_t kCacheLine = 64;

struct alignas(kCacheLine) Ring {
  std::uint64_t n_slots;
  std::uint64_t slot_bytes;
  std::uint8_t* data;          // n_slots * slot_bytes payload arena
  std::uint64_t* sizes;        // per-slot valid byte counts
  std::uint64_t* seqs;         // per-slot producer sequence numbers
  bool owns_data;              // false: the arena is the caller's
  alignas(kCacheLine) std::atomic<std::uint64_t> head;  // next write
  alignas(kCacheLine) std::atomic<std::uint64_t> tail;  // next read
  alignas(kCacheLine) std::atomic<std::uint64_t> dropped;   // producer overruns
  std::atomic<std::uint64_t> produced;
  std::atomic<std::uint64_t> consumed;
};

Ring* make_ring(std::uint64_t n_slots, std::uint64_t slot_bytes,
                std::uint8_t* data, bool owns_data) {
  auto* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->n_slots = n_slots;
  r->slot_bytes = slot_bytes;
  r->data = data;
  r->owns_data = owns_data;
  r->sizes = static_cast<std::uint64_t*>(
      std::calloc(n_slots, sizeof(std::uint64_t)));
  r->seqs = static_cast<std::uint64_t*>(
      std::calloc(n_slots, sizeof(std::uint64_t)));
  if (!r->data || !r->sizes || !r->seqs) {
    if (owns_data) std::free(r->data);
    std::free(r->sizes);
    std::free(r->seqs);
    delete r;
    return nullptr;
  }
  r->head.store(0);
  r->tail.store(0);
  r->dropped.store(0);
  r->produced.store(0);
  r->consumed.store(0);
  return r;
}

}  // namespace

extern "C" {

Ring* rb_create(std::uint64_t n_slots, std::uint64_t slot_bytes) {
  if (n_slots == 0 || slot_bytes == 0) return nullptr;
  auto* data = static_cast<std::uint8_t*>(
      std::aligned_alloc(kCacheLine, ((n_slots * slot_bytes + kCacheLine - 1) /
                                      kCacheLine) * kCacheLine));
  return make_ring(n_slots, slot_bytes, data, true);
}

// The same ring over `data`, an arena of n_slots * slot_bytes bytes that
// the caller allocates, keeps alive until rb_destroy, and frees.
Ring* rb_create_external(std::uint64_t n_slots, std::uint64_t slot_bytes,
                         std::uint8_t* data) {
  if (n_slots == 0 || slot_bytes == 0 || !data) return nullptr;
  return make_ring(n_slots, slot_bytes, data, false);
}

void rb_destroy(Ring* r) {
  if (!r) return;
  if (r->owns_data) std::free(r->data);
  std::free(r->sizes);
  std::free(r->seqs);
  delete r;
}

std::uint64_t rb_slot_bytes(const Ring* r) { return r->slot_bytes; }
std::uint64_t rb_capacity(const Ring* r) { return r->n_slots; }

// Producer: pointer to the next writable slot, or NULL if the ring is full
// (the caller decides: spin = lossless backpressure like dpdk_send.cpp:259,
// or drop-and-count like a NIC RX overrun).
std::uint8_t* rb_acquire_write(Ring* r) {
  std::uint64_t head = r->head.load(std::memory_order_relaxed);
  std::uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->n_slots) return nullptr;  // full
  return r->data + (head % r->n_slots) * r->slot_bytes;
}

// Producer: publish the slot previously returned by rb_acquire_write.
void rb_commit_write(Ring* r, std::uint64_t nbytes, std::uint64_t seq) {
  std::uint64_t head = r->head.load(std::memory_order_relaxed);
  std::uint64_t idx = head % r->n_slots;
  r->sizes[idx] = nbytes;
  r->seqs[idx] = seq;
  r->produced.fetch_add(1, std::memory_order_relaxed);
  r->head.store(head + 1, std::memory_order_release);
}

// Producer: record an overrun drop (ring full, data discarded).
void rb_count_drop(Ring* r) {
  r->dropped.fetch_add(1, std::memory_order_relaxed);
}

// Consumer: pointer to the oldest unread slot (NULL if empty); outputs the
// slot's byte count and sequence number.
std::uint8_t* rb_acquire_read(Ring* r, std::uint64_t* nbytes,
                              std::uint64_t* seq) {
  std::uint64_t tail = r->tail.load(std::memory_order_relaxed);
  std::uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return nullptr;  // empty
  std::uint64_t idx = tail % r->n_slots;
  if (nbytes) *nbytes = r->sizes[idx];
  if (seq) *seq = r->seqs[idx];
  return r->data + idx * r->slot_bytes;
}

// Consumer: mark the oldest slot reusable (the extbuf free callback analog).
void rb_release_read(Ring* r) {
  r->tail.fetch_add(1, std::memory_order_release);
}

std::uint64_t rb_size(const Ring* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

void rb_stats(const Ring* r, std::uint64_t* produced, std::uint64_t* consumed,
              std::uint64_t* dropped) {
  if (produced) *produced = r->produced.load(std::memory_order_relaxed);
  if (consumed) *consumed = r->consumed.load(std::memory_order_relaxed);
  if (dropped) *dropped = r->dropped.load(std::memory_order_relaxed);
}

void rb_count_consumed(Ring* r) {
  r->consumed.fetch_add(1, std::memory_order_relaxed);
}

}  // extern "C"
