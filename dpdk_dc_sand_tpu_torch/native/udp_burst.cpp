// Native UDP burst data plane — the kernel fast paths.
//
// The reference moves sample streams with kernel-bypass burst I/O:
// `rte_eth_tx_burst` of 32 packets (dpdk_send_recv/dpdk_send.cpp:273-315)
// and 2048-deep RX rings drained in bursts (ibverbs_rx.c:282-335). Kernel
// sockets offer three successively faster equivalents, all implemented
// here behind one chunk-granular API:
//
//   mode 0  sendmmsg/recvmmsg   one syscall per 32 packets; the kernel
//                               still traverses the UDP stack per packet.
//   mode 1  GSO/GRO             UDP_SEGMENT staging: one *stack
//                               traversal* per ~15 packets (64 KB super-
//                               datagrams segmented by the kernel), still
//                               batched 32 super-packets per syscall —
//                               ~480 wire packets per syscall. RX side
//                               mirrors with UDP_GRO coalescing.
//   mode 2  io_uring            submission-queue TX/RX: SQEs staged in
//                               shared memory, one io_uring_enter per
//                               burst, completions reaped from the CQ
//                               ring — the closest socket analog of the
//                               reference's descriptor rings
//                               (ibverbs_tx.c:255-262, 64 WRs per post).
//
// Heap reassembly (SPEAD-lite, spead_codec.cpp) runs here too, delivering
// only completed chunks into the SPSC ring (ringbuffer.cpp) — Python
// never touches per-packet work.
//
// C ABI for ctypes. No exceptions across the boundary.

#include <arpa/inet.h>
#include <linux/io_uring.h>
#include <netinet/in.h>
#include <netinet/udp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <unordered_set>
#include <vector>

#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif
#ifndef UDP_GRO
#define UDP_GRO 104
#endif
#ifndef SOL_UDP
#define SOL_UDP 17
#endif

extern "C" {
// From ringbuffer.cpp / spead_codec.cpp (same shared library).
std::uint8_t* rb_acquire_write(void* r);
void rb_commit_write(void* r, std::uint64_t nbytes, std::uint64_t seq);
void rb_count_drop(void* r);
std::uint64_t rb_slot_bytes(const void* r);
std::uint64_t sp_header_bytes();
std::uint64_t sp_packetize(const std::uint8_t* payload, std::uint64_t heap_len,
                           std::uint64_t heap_id, std::uint64_t timestamp,
                           std::uint32_t channel_offset,
                           std::uint64_t mtu_payload, std::uint8_t* out,
                           std::uint64_t out_stride);
int sp_parse_header(const std::uint8_t* pkt, std::uint64_t pkt_len,
                    std::uint64_t* heap_id, std::uint64_t* timestamp,
                    std::uint32_t* channel_offset, std::uint16_t* packet_idx,
                    std::uint16_t* n_packets, std::uint32_t* payload_len,
                    std::uint32_t* heap_len);
int sp64_parse(const std::uint8_t* pkt, std::uint64_t pkt_len,
               std::uint64_t* heap_id, std::uint64_t* timestamp,
               std::uint32_t* channel_offset, std::uint64_t* payload_off,
               std::uint32_t* payload_len, std::uint32_t* heap_len,
               std::uint32_t* header_bytes);
std::uint64_t sp64_header_bytes();
std::uint64_t sp64_packetize(const std::uint8_t* payload,
                             std::uint64_t heap_len, std::uint64_t heap_id,
                             std::uint64_t timestamp,
                             std::uint32_t channel_offset,
                             std::uint64_t mtu_payload, std::uint8_t* out,
                             std::uint64_t out_stride);
void sp64_patch_fragment(std::uint8_t* pkt, std::uint64_t heap_len,
                         std::uint64_t payload_off);
}

namespace {

constexpr int kBurst = 32;          // packets per sendmmsg/recvmmsg call
constexpr int kUringDepth = 256;    // SQ/CQ entries for mode 2
constexpr std::uint64_t kGsoMax = 65000;  // staying under the UDP max

enum Mode { kModeBurst = 0, kModeGso = 1, kModeUring = 2 };
// OR'd into the receiver mode: share the port across N worker sockets
// (kernel flow-hashes by 4-tuple, so every heap's packets — one TX
// socket each — land wholly on one worker; the multi-queue RSS analog).
constexpr int kFlagReusePort = 0x100;
// OR'd into the sender mode: emit real SPEAD-64-48 packets instead of
// SPEAD-lite (stream/spead64.py wire contract; RX is dual-stack).
constexpr int kFlagWire64 = 0x200;

bool is_multicast(const char* ip) {
  in_addr a{};
  if (inet_pton(AF_INET, ip, &a) != 1) return false;
  std::uint32_t host = ntohl(a.s_addr);
  return host >= 0xE0000000u && host <= 0xEFFFFFFFu;
}

// ------------------------------------------------------------- io_uring
// Minimal raw-syscall io_uring wrapper (liburing is not in this image).

struct Uring {
  int ring_fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;
  // SQ ring pointers
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  io_uring_sqe* sqes = nullptr;
  // CQ ring pointers
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;
  void *sq_map = nullptr, *cq_map = nullptr, *sqe_map = nullptr;
  std::size_t sq_map_len = 0, cq_map_len = 0, sqe_map_len = 0;

  bool init(unsigned entries) {
    io_uring_params p{};
    ring_fd = static_cast<int>(syscall(__NR_io_uring_setup, entries, &p));
    if (ring_fd < 0) return false;
    sq_entries = p.sq_entries;
    cq_entries = p.cq_entries;
    sq_map_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_map_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
      std::size_t len = sq_map_len > cq_map_len ? sq_map_len : cq_map_len;
      sq_map = mmap(nullptr, len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
      if (sq_map == MAP_FAILED) return false;
      sq_map_len = len;
      cq_map = sq_map;
      cq_map_len = 0;  // shared mapping; do not munmap twice
    } else {
      sq_map = mmap(nullptr, sq_map_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
      cq_map = mmap(nullptr, cq_map_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_CQ_RING);
      if (sq_map == MAP_FAILED || cq_map == MAP_FAILED) return false;
    }
    sqe_map_len = p.sq_entries * sizeof(io_uring_sqe);
    sqe_map = mmap(nullptr, sqe_map_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQES);
    if (sqe_map == MAP_FAILED) return false;
    auto* sq = static_cast<std::uint8_t*>(sq_map);
    sq_head = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    auto* cq = static_cast<std::uint8_t*>(cq_map);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(cq + p.cq_off.cqes);
    sqes = static_cast<io_uring_sqe*>(sqe_map);
    return true;
  }

  io_uring_sqe* get_sqe() {
    unsigned tail = *sq_tail;  // single submitter: plain read is fine
    unsigned head =
        __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    if (tail - head >= sq_entries) return nullptr;
    io_uring_sqe* sqe = &sqes[tail & *sq_mask];
    std::memset(sqe, 0, sizeof(*sqe));
    sq_array[tail & *sq_mask] = tail & *sq_mask;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    return sqe;
  }

  int enter(unsigned to_submit, unsigned min_complete, unsigned flags) {
    return static_cast<int>(syscall(__NR_io_uring_enter, ring_fd, to_submit,
                                    min_complete, flags, nullptr, 0));
  }

  // Pop one CQE; returns false if the CQ is empty.
  bool pop(io_uring_cqe* out) {
    unsigned head = *cq_head;
    unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) return false;
    *out = cqes[head & *cq_mask];
    __atomic_store_n(cq_head, head + 1, __ATOMIC_RELEASE);
    return true;
  }

  void destroy() {
    if (sqe_map && sqe_map != MAP_FAILED) munmap(sqe_map, sqe_map_len);
    if (cq_map_len && cq_map && cq_map != MAP_FAILED) munmap(cq_map, cq_map_len);
    if (sq_map && sq_map != MAP_FAILED) munmap(sq_map, sq_map_len);
    if (ring_fd >= 0) close(ring_fd);
    ring_fd = -1;
  }
};

// ---------------------------------------------------------------- sender

struct Sender {
  int fd = -1;
  int mode = kModeBurst;
  std::uint64_t mtu_payload = 0;
  std::uint64_t stride = 0;        // header + mtu_payload per staged packet
  std::uint64_t hdr_bytes = 0;     // per-packet wire header size
  int wire = 0;                    // 0 = SPEAD-lite, 1 = SPEAD-64-48
  int stage_packets = kBurst;      // stage arena capacity
  int gso_segs = 1;                // packets per GSO super-datagram
  std::uint8_t* stage = nullptr;
  std::uint64_t* lens = nullptr;   // per-staged-packet wire lengths
  Uring uring;
  std::atomic<std::uint64_t> packets{0};
  std::atomic<std::uint64_t> bytes{0};
};

// Stage packets [base, base+count) of a heap into s->stage (contiguous
// stride-spaced SPEAD packets) and return the staged byte count.
std::uint64_t stage_packets(Sender* s, const std::uint8_t* payload,
                            std::uint64_t heap_len, std::uint64_t heap_id,
                            std::uint64_t timestamp,
                            std::uint32_t channel_offset, std::uint64_t total,
                            std::uint64_t base, int count,
                            std::uint64_t* lens) {
  std::uint64_t staged = 0;
  for (int i = 0; i < count; ++i) {
    std::uint64_t pkt_idx = base + i;
    std::uint64_t off = pkt_idx * s->mtu_payload;
    std::uint64_t len = heap_len - off < s->mtu_payload ? heap_len - off
                                                        : s->mtu_payload;
    std::uint8_t* dst = s->stage + i * s->stride;
    if (s->wire) {
      sp64_packetize(payload + off, len, heap_id, timestamp, channel_offset,
                     s->mtu_payload, dst, s->stride);
      sp64_patch_fragment(dst, heap_len, off);
      lens[i] = s->hdr_bytes + len;
      staged += lens[i];
      continue;
    }
    sp_packetize(payload + off, len, heap_id, timestamp, channel_offset,
                 s->mtu_payload, dst, s->stride);
    // Patch packet_idx (offset 24) / n_packets (26) / heap_len (32): the
    // codec numbered the slice as a standalone 1-packet heap.
    std::uint16_t idx16 = static_cast<std::uint16_t>(pkt_idx);
    std::uint16_t n16 = static_cast<std::uint16_t>(total);
    std::uint32_t hl32 = static_cast<std::uint32_t>(heap_len);
    std::memcpy(dst + 24, &idx16, 2);
    std::memcpy(dst + 26, &n16, 2);
    std::memcpy(dst + 32, &hl32, 4);
    lens[i] = s->hdr_bytes + len;
    staged += lens[i];
  }
  return staged;
}

long long send_staged_mmsg(Sender* s, int count, const std::uint64_t* lens) {
  mmsghdr msgs[kBurst];
  iovec iovs[kBurst];
  std::memset(msgs, 0, sizeof(mmsghdr) * count);
  for (int i = 0; i < count; ++i) {
    iovs[i].iov_base = s->stage + i * s->stride;
    iovs[i].iov_len = lens[i];
    msgs[i].msg_hdr.msg_iov = &iovs[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
  }
  int done = 0;
  while (done < count) {
    int n = sendmmsg(s->fd, msgs + done, count - done, 0);
    if (n < 0) return -1;
    done += n;
  }
  return count;
}

// GSO: the staged stride-spaced packets ARE a valid segmented super-
// datagram (every segment = one full [header|payload] of gso_size =
// stride bytes; only the final staged packet may be short, and staging
// order puts it last). Group gso_segs packets per message, then batch
// the messages through one sendmmsg.
long long send_staged_gso(Sender* s, int count, const std::uint64_t* lens) {
  mmsghdr msgs[kBurst];
  iovec iovs[kBurst];
  int n_msgs = 0;
  int i = 0;
  while (i < count) {
    int segs = 0;
    std::uint64_t msg_len = 0;
    while (segs < s->gso_segs && i + segs < count) {
      msg_len += lens[i + segs];
      ++segs;
      if (lens[i + segs - 1] != s->stride) break;  // short tail ends msg
    }
    iovs[n_msgs].iov_base = s->stage + i * s->stride;
    iovs[n_msgs].iov_len = msg_len;
    std::memset(&msgs[n_msgs], 0, sizeof(mmsghdr));
    msgs[n_msgs].msg_hdr.msg_iov = &iovs[n_msgs];
    msgs[n_msgs].msg_hdr.msg_iovlen = 1;
    ++n_msgs;
    i += segs;
  }
  // A short-tail segment inside iov_base relies on the staged packets
  // being CONTIGUOUS at stride spacing — true by construction, but the
  // final message's last segment is lens[last] < stride, so its iov_len
  // correctly stops short of the stride boundary.
  int done = 0;
  while (done < n_msgs) {
    int n = sendmmsg(s->fd, msgs + done, n_msgs - done, 0);
    if (n < 0) return -1;
    done += n;
  }
  return count;
}

long long send_staged_uring(Sender* s, int count, const std::uint64_t* lens) {
  int submitted = 0;
  while (submitted < count) {
    int batch = 0;
    while (submitted + batch < count) {
      io_uring_sqe* sqe = s->uring.get_sqe();
      if (!sqe) break;
      int i = submitted + batch;
      sqe->opcode = IORING_OP_SEND;
      sqe->fd = s->fd;
      sqe->addr = reinterpret_cast<std::uint64_t>(s->stage + i * s->stride);
      sqe->len = static_cast<std::uint32_t>(lens[i]);
      sqe->user_data = i;
      ++batch;
    }
    if (batch == 0) return -1;
    int n = s->uring.enter(batch, batch, IORING_ENTER_GETEVENTS);
    if (n < 0) return -1;
    io_uring_cqe cqe;
    for (int k = 0; k < batch; ++k) {
      while (!s->uring.pop(&cqe)) {
        if (s->uring.enter(0, 1, IORING_ENTER_GETEVENTS) < 0) return -1;
      }
      if (cqe.res < 0) return -1;
    }
    submitted += batch;
  }
  return count;
}

// --------------------------------------------------------------- receiver

// SPEAD-lite heap reassembly into the SPSC ring — shared by the socket
// receiver below and the AF_XDP receiver (xdp_burst.cpp) via the
// ub_reasm_* C interface.
struct Reasm {
  std::uint64_t mtu_payload = 0;
  void* ring = nullptr;
  std::uint64_t slot_bytes = 0;
  // Zero-copy-into-ring assembly: the current heap is built DIRECTLY in
  // the acquired (uncommitted) ring slot — rb_acquire_write returns the
  // same slot until commit, so an abandoned heap costs nothing and RX
  // does a single memcpy per byte (packet buffer → slot). One heap is
  // assembled at a time; streams are SPSC and in-order per the chunked
  // transport contract, so a packet from a NEWER heap evicts an
  // incomplete current one (= packets were lost), as the reference's
  // reassembly does on sequence gaps (ibverbs_rx.c:303-319).
  // A packet is counted once: a duplicate (a resent heap, a packet the
  // network repeats) neither completes a heap that still has holes nor,
  // after completion, opens the same heap again.
  std::uint64_t cur_heap = ~0ull;
  std::uint8_t* cur_slot = nullptr;
  std::uint64_t cur_timestamp = 0;
  std::uint32_t cur_channel_offset = 0;
  std::uint32_t cur_heap_len = 0;
  std::uint64_t cur_received = 0;  // payload bytes assembled
  std::uint64_t dropped_heap = ~0ull;  // ring-full heap id (count once)
  std::uint64_t done_heap = ~0ull;     // the last heap committed
  std::vector<std::uint64_t> seen;     // a bit per mtu_payload-aligned packet
  std::unordered_set<std::uint64_t> seen_at;  // offsets of the other packets
  std::atomic<std::uint64_t> heaps_done{0};
  std::atomic<std::uint64_t> ring_drops{0};
  std::atomic<std::uint64_t> evicted{0};  // incomplete heaps overwritten
};

struct Receiver {
  int fd = -1;
  int mode = kModeBurst;
  std::uint64_t mtu_payload = 0;
  std::uint64_t buf_cap = 0;  // per-message receive buffer size
  Reasm reasm;
  std::uint8_t* pkt_arena = nullptr;
  Uring uring;
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<std::uint64_t> packets{0};
  std::atomic<std::uint64_t> bytes{0};
};

// Returns the bytes the packet at `pkt` spans (its header and payload), or
// 0 where `pkt` is not a packet of either format.
std::uint64_t feed_packet(Reasm* rx, const std::uint8_t* pkt,
                          std::uint64_t len) {
  // Dual-stack ingest: SPEAD-lite fast path, real SPEAD-64-48 second
  // (the Python UdpReceiver has the same per-packet dispatch). Both
  // normalise to (heap, payload offset/len, totals); completion is
  // byte-counted so the formats share one state machine.
  std::uint64_t heap_id, timestamp, off;
  std::uint32_t channel_offset, payload_len, heap_len, hdr_bytes;
  std::uint16_t packet_idx, n_packets;
  if (sp_parse_header(pkt, len, &heap_id, &timestamp, &channel_offset,
                      &packet_idx, &n_packets, &payload_len, &heap_len)) {
    off = static_cast<std::uint64_t>(packet_idx) * rx->mtu_payload;
    hdr_bytes = static_cast<std::uint32_t>(sp_header_bytes());
  } else if (!sp64_parse(pkt, len, &heap_id, &timestamp, &channel_offset,
                         &off, &payload_len, &heap_len, &hdr_bytes)) {
    return 0;
  }
  const std::uint64_t span = static_cast<std::uint64_t>(hdr_bytes) + payload_len;
  if (heap_len > rx->slot_bytes - 16) return span;  // cannot ever deliver
  if (heap_id != rx->cur_heap) {
    if (heap_id == rx->dropped_heap) return span;  // ring was full for this heap
    if (heap_id == rx->done_heap) return span;     // a late duplicate
    if (rx->cur_slot && rx->cur_received > 0)
      rx->evicted.fetch_add(1, std::memory_order_relaxed);
    std::uint8_t* slot = rb_acquire_write(rx->ring);
    if (!slot) {
      rb_count_drop(rx->ring);
      rx->ring_drops.fetch_add(1, std::memory_order_relaxed);
      rx->dropped_heap = heap_id;
      rx->cur_heap = ~0ull;
      rx->cur_slot = nullptr;
      return span;
    }
    rx->cur_slot = slot;
    rx->cur_heap = heap_id;
    rx->cur_timestamp = timestamp;
    rx->cur_channel_offset = channel_offset;
    rx->cur_heap_len = heap_len;
    rx->cur_received = 0;  // bytes
    rx->seen.assign((heap_len / rx->mtu_payload + 64) / 64, 0);
    rx->seen_at.clear();
    // Ring slot layout matches stream.udp.UdpReceiver._deliver: a
    // 16-byte little-endian (timestamp, channel_offset) prefix.
    std::uint64_t meta[2] = {timestamp, channel_offset};
    std::memcpy(slot, meta, 16);
  }
  if (off + payload_len > rx->cur_heap_len) return span;
  // A packet is known by its offset: a bit where the offset is a multiple
  // of mtu_payload, else (a SPEAD-64-48 sender with another packet size)
  // an entry in seen_at.
  if (off % rx->mtu_payload == 0) {
    const std::uint64_t i = off / rx->mtu_payload;
    const std::uint64_t bit = 1ull << (i % 64);
    if (rx->seen[i / 64] & bit) return span;  // this packet arrived before
    rx->seen[i / 64] |= bit;
  } else if (!rx->seen_at.insert(off).second) {
    return span;  // this packet arrived before
  }
  std::memcpy(rx->cur_slot + 16 + off, pkt + hdr_bytes, payload_len);
  rx->cur_received += payload_len;
  if (rx->cur_received >= rx->cur_heap_len) {
    rb_commit_write(rx->ring, 16 + rx->cur_heap_len, rx->cur_heap);
    rx->heaps_done.fetch_add(1, std::memory_order_relaxed);
    rx->done_heap = rx->cur_heap;
    rx->cur_heap = ~0ull;
    rx->cur_slot = nullptr;
    rx->cur_received = 0;
  }
  return span;
}

// Feed a receive buffer that may hold several GRO-coalesced segments. With
// no segment size from the kernel, the buffer is walked packet by packet by
// each packet's own header and payload length: a kernel that takes
// UDP_SEGMENT but does not segment delivers the sender's super-datagram
// whole, and a plain datagram is one packet of exactly its length.
void feed_buffer(Receiver* rx, const std::uint8_t* buf, std::uint64_t len,
                 std::uint32_t gso_size) {
  if (gso_size == 0) {
    std::uint64_t off = 0, n = 0, span = 1;
    while (off < len && span) {
      span = feed_packet(&rx->reasm, buf + off, len - off);
      off += span;
      ++n;
    }
    rx->packets.fetch_add(n, std::memory_order_relaxed);
    return;
  }
  std::uint64_t off = 0, n = 0;
  while (off < len) {
    std::uint64_t seg = len - off < gso_size ? len - off : gso_size;
    feed_packet(&rx->reasm, buf + off, seg);
    off += seg;
    ++n;
  }
  rx->packets.fetch_add(n, std::memory_order_relaxed);
}

void rx_loop_mmsg(Receiver* rx) {
  const bool gro = rx->mode == kModeGso;
  mmsghdr msgs[kBurst];
  iovec iovs[kBurst];
  alignas(cmsghdr) char ctrl[kBurst][64];
  while (!rx->stop.load(std::memory_order_relaxed)) {
    std::memset(msgs, 0, sizeof(msgs));
    for (int i = 0; i < kBurst; ++i) {
      iovs[i].iov_base = rx->pkt_arena + i * rx->buf_cap;
      iovs[i].iov_len = rx->buf_cap;
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
      if (gro) {
        msgs[i].msg_hdr.msg_control = ctrl[i];
        msgs[i].msg_hdr.msg_controllen = sizeof(ctrl[i]);
      }
    }
    // Take what is queued; when nothing is, wait in poll (50 ms, then
    // check the stop flag). Not MSG_WAITFORONE: some kernels (gVisor)
    // refuse it with EINVAL.
    int n = recvmmsg(rx->fd, msgs, kBurst, MSG_DONTWAIT, nullptr);
    if (n <= 0) {
      pollfd pfd{rx->fd, POLLIN, 0};
      poll(&pfd, 1, 50);
      continue;
    }
    std::uint64_t nbytes = 0;
    for (int i = 0; i < n; ++i) {
      std::uint32_t gso_size = 0;
      if (gro) {
        for (cmsghdr* c = CMSG_FIRSTHDR(&msgs[i].msg_hdr); c;
             c = CMSG_NXTHDR(&msgs[i].msg_hdr, c)) {
          if (c->cmsg_level == SOL_UDP && c->cmsg_type == UDP_GRO) {
            int v;
            std::memcpy(&v, CMSG_DATA(c), sizeof(v));
            gso_size = static_cast<std::uint32_t>(v);
          }
        }
      }
      feed_buffer(rx, rx->pkt_arena + i * rx->buf_cap, msgs[i].msg_len,
                  gso_size);
      nbytes += msgs[i].msg_len;
    }
    rx->bytes.fetch_add(nbytes, std::memory_order_relaxed);
  }
}

void rx_loop_uring(Receiver* rx) {
  // Keep kUringDepth/2 RECV SQEs in flight plus one 50 ms timeout SQE per
  // wait so the stop flag is honoured (io_uring ignores SO_RCVTIMEO).
  const int inflight = kUringDepth / 2;
  auto submit_recv = [&](int slot) {
    io_uring_sqe* sqe = rx->uring.get_sqe();
    if (!sqe) return false;
    sqe->opcode = IORING_OP_RECV;
    sqe->fd = rx->fd;
    sqe->addr =
        reinterpret_cast<std::uint64_t>(rx->pkt_arena + slot * rx->buf_cap);
    sqe->len = static_cast<std::uint32_t>(rx->buf_cap);
    sqe->user_data = static_cast<std::uint64_t>(slot);
    return true;
  };
  for (int i = 0; i < inflight; ++i) submit_recv(i);
  rx->uring.enter(inflight, 0, 0);
  __kernel_timespec ts{0, 50'000'000};
  while (!rx->stop.load(std::memory_order_relaxed)) {
    // One timeout SQE arms the wait; user_data ~0 marks it.
    io_uring_sqe* sqe = rx->uring.get_sqe();
    int to_submit = 0;
    if (sqe) {
      sqe->opcode = IORING_OP_TIMEOUT;
      sqe->fd = -1;
      sqe->addr = reinterpret_cast<std::uint64_t>(&ts);
      sqe->len = 1;
      sqe->user_data = ~0ull;
      to_submit = 1;
    }
    if (rx->uring.enter(to_submit, 1, IORING_ENTER_GETEVENTS) < 0) continue;
    io_uring_cqe cqe;
    int resubmit = 0;
    std::uint64_t nbytes = 0;
    while (rx->uring.pop(&cqe)) {
      if (cqe.user_data == ~0ull) continue;  // timeout fired
      int slot = static_cast<int>(cqe.user_data);
      if (cqe.res > 0) {
        feed_buffer(rx, rx->pkt_arena + slot * rx->buf_cap,
                    static_cast<std::uint64_t>(cqe.res), 0);
        nbytes += static_cast<std::uint64_t>(cqe.res);
      }
      if (submit_recv(slot)) ++resubmit;
    }
    if (nbytes) rx->bytes.fetch_add(nbytes, std::memory_order_relaxed);
    if (resubmit) rx->uring.enter(resubmit, 0, 0);
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- sender

void* ub_sender_create_mode(const char* ip, std::uint16_t port,
                            std::uint64_t mtu_payload, int mode) {
  if (!ip || mtu_payload == 0) return nullptr;
  const int wire = (mode & kFlagWire64) ? 1 : 0;
  mode &= 0xFF;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in dst{};
  dst.sin_family = AF_INET;
  dst.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &dst.sin_addr) != 1 ||
      connect(fd, reinterpret_cast<sockaddr*>(&dst), sizeof(dst)) != 0) {
    close(fd);
    return nullptr;
  }
  if (is_multicast(ip)) {
    int ttl = 1, loop = 1;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
  }
  int sndbuf = 8 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sndbuf, sizeof(sndbuf));
  auto* s = new (std::nothrow) Sender();
  if (!s) {
    close(fd);
    return nullptr;
  }
  s->fd = fd;
  s->mode = mode;
  s->wire = wire;
  s->mtu_payload = mtu_payload;
  s->hdr_bytes = wire ? sp64_header_bytes() : sp_header_bytes();
  s->stride = s->hdr_bytes + mtu_payload;
  if (mode == kModeGso) {
    int seg = static_cast<int>(s->stride);
    if (s->stride > kGsoMax ||
        setsockopt(fd, SOL_UDP, UDP_SEGMENT, &seg, sizeof(seg)) != 0) {
      close(fd);
      delete s;
      return nullptr;
    }
    s->gso_segs = static_cast<int>(kGsoMax / s->stride);
    if (s->gso_segs > 64) s->gso_segs = 64;  // UDP_MAX_SEGMENTS
    if (s->gso_segs < 1) s->gso_segs = 1;
    s->stage_packets = s->gso_segs * kBurst;
  } else if (mode == kModeUring) {
    if (!s->uring.init(kUringDepth)) {
      s->uring.destroy();
      close(fd);
      delete s;
      return nullptr;
    }
    s->stage_packets = kUringDepth;
  } else {
    s->stage_packets = kBurst;
  }
  s->stage =
      static_cast<std::uint8_t*>(std::malloc(s->stage_packets * s->stride));
  s->lens = static_cast<std::uint64_t*>(
      std::malloc(s->stage_packets * sizeof(std::uint64_t)));
  if (!s->stage || !s->lens) {
    s->uring.destroy();
    close(fd);
    std::free(s->stage);
    std::free(s->lens);
    delete s;
    return nullptr;
  }
  return s;
}

void* ub_sender_create(const char* ip, std::uint16_t port,
                       std::uint64_t mtu_payload) {
  return ub_sender_create_mode(ip, port, mtu_payload, kModeBurst);
}

int ub_sender_mode(void* handle) {
  auto* s = static_cast<Sender*>(handle);
  return s ? s->mode : -1;
}

// Packetize one chunk and transmit it in staged bursts. Blocking socket
// => lossless backpressure (the tx_done_cleanup spin of
// dpdk_send.cpp:259-267). Returns packets sent, or -1 on error.
long long ub_send_chunk(void* handle, const std::uint8_t* payload,
                        std::uint64_t heap_len, std::uint64_t heap_id,
                        std::uint64_t timestamp,
                        std::uint32_t channel_offset) {
  auto* s = static_cast<Sender*>(handle);
  if (!s || !payload) return -1;
  std::uint64_t total =
      (heap_len + s->mtu_payload - 1) / s->mtu_payload;
  if (total == 0) total = 1;
  if (total > 0xFFFF) return -1;
  std::uint64_t* lens = s->lens;
  std::uint64_t sent_total = 0, sent_bytes = 0;
  for (std::uint64_t base = 0; base < total; base += s->stage_packets) {
    int count = static_cast<int>(total - base < (std::uint64_t)s->stage_packets
                                     ? total - base
                                     : (std::uint64_t)s->stage_packets);
    sent_bytes += stage_packets(s, payload, heap_len, heap_id, timestamp,
                                channel_offset, total, base, count, lens);
    long long r;
    if (s->mode == kModeGso)
      r = send_staged_gso(s, count, lens);
    else if (s->mode == kModeUring)
      r = send_staged_uring(s, count, lens);
    else
      r = send_staged_mmsg(s, count, lens);
    if (r < 0) return -1;
    sent_total += count;
  }
  s->packets.fetch_add(sent_total, std::memory_order_relaxed);
  s->bytes.fetch_add(sent_bytes, std::memory_order_relaxed);
  return static_cast<long long>(sent_total);
}

void ub_sender_stats(void* handle, std::uint64_t* packets,
                     std::uint64_t* bytes) {
  auto* s = static_cast<Sender*>(handle);
  if (!s) return;
  if (packets) *packets = s->packets.load(std::memory_order_relaxed);
  if (bytes) *bytes = s->bytes.load(std::memory_order_relaxed);
}

void ub_sender_destroy(void* handle) {
  auto* s = static_cast<Sender*>(handle);
  if (!s) return;
  s->uring.destroy();
  close(s->fd);
  std::free(s->stage);
  std::free(s->lens);
  delete s;
}

// -------------------------------------------------------------- receiver

void* ub_receiver_create_mode(const char* bind_ip, std::uint16_t port,
                              const char* group, std::uint64_t mtu_payload,
                              void* ring, int mode) {
  if (!bind_ip || mtu_payload == 0 || !ring) return nullptr;
  const bool reuse_port = mode & kFlagReusePort;
  mode &= 0xFF;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  int reuse = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  if (reuse_port)
    setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &reuse, sizeof(reuse));
  // Deep RX ring analog (ibverbs_rx.c:155-217, 2048×9000 B entries).
  // FORCE escapes rmem_max caps when privileged; plain RCVBUF otherwise.
  int rcvbuf = 64 << 20;
  if (setsockopt(fd, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf, sizeof(rcvbuf)))
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  timeval tv{0, 50000};  // 50 ms poll for stop flag (mmsg modes)
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (mode == kModeGso) {
    int on = 1;
    if (setsockopt(fd, SOL_UDP, UDP_GRO, &on, sizeof(on)) != 0) {
      close(fd);
      return nullptr;
    }
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, bind_ip, &addr.sin_addr) != 1 ||
      bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return nullptr;
  }
  if (group && is_multicast(group)) {
    ip_mreq mreq{};
    inet_pton(AF_INET, group, &mreq.imr_multiaddr);
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));
  }
  auto* rx = new (std::nothrow) Receiver();
  if (!rx) {
    close(fd);
    return nullptr;
  }
  rx->fd = fd;
  rx->mode = mode;
  rx->mtu_payload = mtu_payload;
  rx->reasm.mtu_payload = mtu_payload;
  rx->reasm.ring = ring;
  rx->reasm.slot_bytes = rb_slot_bytes(ring);
  // GRO delivers up to 64 KB coalesced buffers; plain modes one packet
  // sized for the LARGER of the two wire headers (SPEAD-64-48 is 64 B
  // vs SPEAD-lite's 40 B — a lite-sized buffer would silently truncate
  // spead64 datagrams and the parse would reject every packet).
  std::uint64_t hdr_max = sp_header_bytes();
  if (sp64_header_bytes() > hdr_max) hdr_max = sp64_header_bytes();
  rx->buf_cap = mode == kModeGso ? (64 << 10) : hdr_max + mtu_payload;
  int n_bufs = mode == kModeUring ? kUringDepth / 2 : kBurst;
  rx->pkt_arena =
      static_cast<std::uint8_t*>(std::malloc(n_bufs * rx->buf_cap));
  bool ok = rx->pkt_arena != nullptr;
  if (ok && mode == kModeUring) ok = rx->uring.init(kUringDepth);
  if (!ok) {
    rx->uring.destroy();
    std::free(rx->pkt_arena);
    close(fd);
    delete rx;
    return nullptr;
  }
  rx->thread =
      std::thread(mode == kModeUring ? rx_loop_uring : rx_loop_mmsg, rx);
  return rx;
}

void* ub_receiver_create(const char* bind_ip, std::uint16_t port,
                         const char* group, std::uint64_t mtu_payload,
                         void* ring) {
  return ub_receiver_create_mode(bind_ip, port, group, mtu_payload, ring,
                                 kModeBurst);
}

int ub_receiver_mode(void* handle) {
  auto* rx = static_cast<Receiver*>(handle);
  return rx ? rx->mode : -1;
}

std::uint16_t ub_receiver_port(void* handle) {
  auto* rx = static_cast<Receiver*>(handle);
  if (!rx) return 0;
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(rx->fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0)
    return 0;
  return ntohs(addr.sin_port);
}

void ub_receiver_stats(void* handle, std::uint64_t* packets,
                       std::uint64_t* bytes, std::uint64_t* heaps,
                       std::uint64_t* ring_drops, std::uint64_t* evicted) {
  auto* rx = static_cast<Receiver*>(handle);
  if (!rx) return;
  if (packets) *packets = rx->packets.load(std::memory_order_relaxed);
  if (bytes) *bytes = rx->bytes.load(std::memory_order_relaxed);
  if (heaps) *heaps = rx->reasm.heaps_done.load(std::memory_order_relaxed);
  if (ring_drops)
    *ring_drops = rx->reasm.ring_drops.load(std::memory_order_relaxed);
  if (evicted) *evicted = rx->reasm.evicted.load(std::memory_order_relaxed);
}

// ---------------------------------------------------- shared reassembly
// Used by the AF_XDP receiver (xdp_burst.cpp): same zero-copy-into-ring
// SPEAD-lite assembly as the socket receiver.

void* ub_reasm_create(void* ring, std::uint64_t mtu_payload) {
  if (!ring || mtu_payload == 0) return nullptr;
  auto* r = new (std::nothrow) Reasm();
  if (!r) return nullptr;
  r->mtu_payload = mtu_payload;
  r->ring = ring;
  r->slot_bytes = rb_slot_bytes(ring);
  return r;
}

void ub_reasm_feed(void* handle, const std::uint8_t* pkt, std::uint64_t len) {
  feed_packet(static_cast<Reasm*>(handle), pkt, len);
}

void ub_reasm_stats(void* handle, std::uint64_t* heaps,
                    std::uint64_t* ring_drops, std::uint64_t* evicted) {
  auto* r = static_cast<Reasm*>(handle);
  if (!r) return;
  if (heaps) *heaps = r->heaps_done.load(std::memory_order_relaxed);
  if (ring_drops) *ring_drops = r->ring_drops.load(std::memory_order_relaxed);
  if (evicted) *evicted = r->evicted.load(std::memory_order_relaxed);
}

void ub_reasm_destroy(void* handle) { delete static_cast<Reasm*>(handle); }

void ub_receiver_destroy(void* handle) {
  auto* rx = static_cast<Receiver*>(handle);
  if (!rx) return;
  rx->stop.store(true);
  if (rx->thread.joinable()) rx->thread.join();
  rx->uring.destroy();
  close(rx->fd);
  std::free(rx->pkt_arena);
  delete rx;
}

}  // extern "C"
