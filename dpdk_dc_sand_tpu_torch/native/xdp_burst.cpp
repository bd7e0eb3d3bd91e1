// AF_XDP (XSK) data plane — descriptor-ring kernel-bypass UDP.
//
// The closest kernel-socket-free analog of the reference's transports:
// UMEM frame pool + producer/consumer descriptor rings mirror DPDK's
// mempool/extbuf TX (dpdk_send_recv/dpdk_send.cpp:252-315) and the
// ibverbs WR/CQ rings (ibverbs_tx.c:33-34: SQ of 2048 descriptors;
// ibverbs_rx.c:155-217: RQ + flow steering). Specifically:
//
//   TX  — frames (hand-built Eth/IPv4/UDP headers + SPEAD-lite payload,
//         the packed-header discipline of common_functions.h:27-48) are
//         written into UMEM, descriptors pushed onto the TX ring, one
//         sendto() kick per burst, completions reaped from the
//         completion ring. No BPF program needed for TX.
//   RX  — a minimal hand-assembled eBPF XDP program (loaded via raw
//         bpf(2), no libbpf in this image) filters on our UDP dst port
//         and redirects matching frames into an XSKMAP — the rte_flow /
//         ibv_flow steering-rule analog (dpdk_recv.cpp:61-131,
//         ibverbs_rx.c:155-217); everything else passes to the stack
//         untouched. Frames land in the RX ring, headers are stripped,
//         and payloads feed the shared SPEAD reassembly (ub_reasm_*,
//         udp_burst.cpp) straight into the SPSC chunk ring.
//
// Attached in SKB (generic/copy) mode so it works on veth/any driver;
// on zero-copy-capable NICs the same code binds with XDP_ZEROCOPY.
// C ABI for ctypes. No exceptions across the boundary.

#include <arpa/inet.h>
#include <linux/bpf.h>
#include <linux/if_link.h>
#include <linux/if_xdp.h>
#include <net/if.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>

extern "C" {
// udp_burst.cpp / spead_codec.cpp (same shared library).
void* ub_reasm_create(void* ring, std::uint64_t mtu_payload);
void ub_reasm_feed(void* h, const std::uint8_t* pkt, std::uint64_t len);
void ub_reasm_stats(void* h, std::uint64_t* heaps, std::uint64_t* ring_drops,
                    std::uint64_t* evicted);
void ub_reasm_destroy(void* h);
std::uint64_t sp_header_bytes();
std::uint64_t sp_packetize(const std::uint8_t* payload, std::uint64_t heap_len,
                           std::uint64_t heap_id, std::uint64_t timestamp,
                           std::uint32_t channel_offset,
                           std::uint64_t mtu_payload, std::uint8_t* out,
                           std::uint64_t out_stride);
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

constexpr std::uint32_t kFrameSize = 4096;  // UMEM chunk (page)
constexpr std::uint32_t kNumFrames = 4096;  // 16 MiB UMEM
constexpr std::uint32_t kRingSize = 2048;   // ibverbs_tx.c:33 depth
constexpr std::uint32_t kWireHdr = 42;      // Eth(14) + IPv4(20) + UDP(8)
constexpr int kTxBurst = 64;                // WRs per kick (ibverbs_tx.c:34)

struct XskRing {
  std::uint32_t* producer = nullptr;
  std::uint32_t* consumer = nullptr;
  void* desc = nullptr;
  void* map = nullptr;
  std::size_t map_len = 0;
  std::uint32_t size = 0;
  std::uint32_t cached_prod = 0, cached_cons = 0;

  bool init(int fd, std::uint64_t pgoff, const xdp_ring_offset& off,
            std::uint32_t count, std::size_t desc_size) {
    map_len = off.desc + static_cast<std::size_t>(count) * desc_size;
    map = mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
               MAP_SHARED | MAP_POPULATE, fd, pgoff);
    if (map == MAP_FAILED) return false;
    auto* b = static_cast<std::uint8_t*>(map);
    producer = reinterpret_cast<std::uint32_t*>(b + off.producer);
    consumer = reinterpret_cast<std::uint32_t*>(b + off.consumer);
    desc = b + off.desc;
    size = count;
    return true;
  }
  void destroy() {
    if (map && map != MAP_FAILED) munmap(map, map_len);
    map = nullptr;
  }
};

struct Umem {
  std::uint8_t* buf = nullptr;
  std::size_t len = 0;

  bool init(int fd) {
    len = static_cast<std::size_t>(kFrameSize) * kNumFrames;
    buf = static_cast<std::uint8_t*>(
        mmap(nullptr, len, PROT_READ | PROT_WRITE,
             MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0));
    if (buf == MAP_FAILED) return false;
    xdp_umem_reg reg{};
    reg.addr = reinterpret_cast<std::uint64_t>(buf);
    reg.len = len;
    reg.chunk_size = kFrameSize;
    reg.headroom = 0;
    return setsockopt(fd, SOL_XDP, XDP_UMEM_REG, &reg, sizeof(reg)) == 0;
  }
  void destroy() {
    if (buf && buf != MAP_FAILED) munmap(buf, len);
    buf = nullptr;
  }
};

std::uint16_t ip_checksum(const std::uint8_t* hdr, int len) {
  std::uint32_t sum = 0;
  for (int i = 0; i < len; i += 2)
    sum += (static_cast<std::uint32_t>(hdr[i]) << 8) | hdr[i + 1];
  while (sum >> 16) sum = (sum & 0xFFFF) + (sum >> 16);
  return static_cast<std::uint16_t>(~sum);
}

// Build the 42-byte Eth/IPv4/UDP header in front of a payload of
// udp_payload_len bytes (common_functions.h:27-48 layout; broadcast
// dst MAC — the test fabric is a point-to-point veth; deployments
// would fill the peer MAC).
void build_headers(std::uint8_t* f, std::uint32_t src_ip, std::uint32_t dst_ip,
                   std::uint16_t src_port, std::uint16_t dst_port,
                   std::uint16_t udp_payload_len) {
  std::memset(f, 0xFF, 6);            // dst MAC broadcast
  std::memset(f + 6, 0x02, 6);        // src MAC locally administered
  f[12] = 0x08; f[13] = 0x00;         // ETH_P_IP
  std::uint8_t* ip = f + 14;
  std::uint16_t ip_len = 20 + 8 + udp_payload_len;
  ip[0] = 0x45; ip[1] = 0;
  ip[2] = ip_len >> 8; ip[3] = ip_len & 0xFF;
  ip[4] = 0; ip[5] = 0;               // id
  ip[6] = 0x40; ip[7] = 0;            // DF
  ip[8] = 64;                         // TTL
  ip[9] = 17;                         // UDP
  ip[10] = ip[11] = 0;                // checksum (filled below)
  std::memcpy(ip + 12, &src_ip, 4);   // already network order
  std::memcpy(ip + 16, &dst_ip, 4);
  std::uint16_t csum = ip_checksum(ip, 20);
  ip[10] = csum >> 8; ip[11] = csum & 0xFF;
  std::uint8_t* udp = f + 34;
  std::uint16_t ulen = 8 + udp_payload_len;
  udp[0] = src_port >> 8; udp[1] = src_port & 0xFF;
  udp[2] = dst_port >> 8; udp[3] = dst_port & 0xFF;
  udp[4] = ulen >> 8; udp[5] = ulen & 0xFF;
  udp[6] = udp[7] = 0;                // UDP checksum optional (IPv4)
}

long bpf_sys(int cmd, bpf_attr* attr) {
  return syscall(__NR_bpf, cmd, attr, sizeof(*attr));
}

// --------------------------------------------------------------- sender

struct XskSender {
  int fd = -1;
  Umem umem;
  XskRing tx, comp;
  std::uint64_t mtu_payload = 0;
  int wire = 0;  // 0 = SPEAD-lite, 1 = SPEAD-64-48
  std::uint64_t hdr_bytes = 0;
  std::uint32_t src_ip = 0, dst_ip = 0;
  std::uint16_t src_port = 0, dst_port = 0;
  // Explicit free-frame stack recycled from completion-ring entries.
  // A round-robin allocator would only be safe if the kernel completed
  // TX descriptors in submission order, which the API does not promise;
  // recycling the addresses the completion ring actually hands back is
  // correct under any reordering (the rte_mbuf refcount-free-callback
  // discipline, dpdk_send.cpp:62-117).
  std::uint32_t free_frames[kNumFrames];
  std::uint32_t n_free = 0;
  std::atomic<std::uint64_t> packets{0};
  std::atomic<std::uint64_t> bytes{0};
};

void tx_reap(XskSender* s) {
  std::uint32_t cons = __atomic_load_n(s->comp.consumer, __ATOMIC_RELAXED);
  std::uint32_t prod = __atomic_load_n(s->comp.producer, __ATOMIC_ACQUIRE);
  std::uint32_t n = prod - cons;
  if (n) {
    auto* addrs = static_cast<const std::uint64_t*>(s->comp.desc);
    for (std::uint32_t i = 0; i < n; ++i) {
      std::uint64_t a = addrs[(cons + i) & (s->comp.size - 1)];
      if (s->n_free < kNumFrames)
        s->free_frames[s->n_free++] =
            static_cast<std::uint32_t>(a / kFrameSize);
    }
    __atomic_store_n(s->comp.consumer, cons + n, __ATOMIC_RELEASE);
  }
}

// Bind an XSK to (ifindex, queue 0), retrying EBUSY: a just-closed XSK
// on the same queue unbinds asynchronously (RCU), so an immediate
// rebind races the kernel teardown.
bool bind_xsk_queue(int fd, unsigned ifindex) {
  sockaddr_xdp sxdp{};
  sxdp.sxdp_family = AF_XDP;
  sxdp.sxdp_flags = XDP_COPY;
  sxdp.sxdp_ifindex = ifindex;
  sxdp.sxdp_queue_id = 0;
  for (int attempt = 0; attempt < 200; ++attempt) {
    if (bind(fd, reinterpret_cast<sockaddr*>(&sxdp), sizeof(sxdp)) == 0)
      return true;
    if (errno != EBUSY) return false;
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  return false;
}

// Create-path diagnostics: the stage that failed and its errno, so the
// Python layer can report WHY AF_XDP is unavailable (capability, limit,
// kernel support) instead of a generic failure.
int g_xsk_fail_stage = 0;
int g_xsk_fail_errno = 0;

void xsk_fail(int stage) {
  g_xsk_fail_stage = stage;
  g_xsk_fail_errno = errno;
}

}  // namespace

extern "C" {

int xsk_last_fail_stage() { return g_xsk_fail_stage; }
int xsk_last_fail_errno() { return g_xsk_fail_errno; }

void* xsk_sender_create_fmt(const char* ifname, const char* src_ip,
                            const char* dst_ip, std::uint16_t src_port,
                            std::uint16_t dst_port,
                            std::uint64_t mtu_payload, int wire_fmt) {
  if (!ifname || !src_ip || !dst_ip || mtu_payload == 0) return nullptr;
  std::uint64_t hdr = wire_fmt ? sp64_header_bytes() : sp_header_bytes();
  std::uint64_t wire = kWireHdr + hdr + mtu_payload;
  unsigned ifindex = if_nametoindex(ifname);
  if (wire > kFrameSize || ifindex == 0) { xsk_fail(1); return nullptr; }
  int fd = socket(AF_XDP, SOCK_RAW, 0);
  if (fd < 0) { xsk_fail(2); return nullptr; }
  auto* s = new (std::nothrow) XskSender();
  if (!s) {
    close(fd);
    return nullptr;
  }
  s->fd = fd;
  s->mtu_payload = mtu_payload;
  s->wire = wire_fmt;
  s->hdr_bytes = hdr;
  inet_pton(AF_INET, src_ip, &s->src_ip);
  inet_pton(AF_INET, dst_ip, &s->dst_ip);
  s->src_port = src_port;
  s->dst_port = dst_port;
  int ring = kRingSize;
  bool ok = s->umem.init(fd) &&
            setsockopt(fd, SOL_XDP, XDP_UMEM_FILL_RING, &ring, sizeof(ring)) == 0 &&
            setsockopt(fd, SOL_XDP, XDP_UMEM_COMPLETION_RING, &ring, sizeof(ring)) == 0 &&
            setsockopt(fd, SOL_XDP, XDP_TX_RING, &ring, sizeof(ring)) == 0;
  xdp_mmap_offsets off{};
  socklen_t optlen = sizeof(off);
  ok = ok && getsockopt(fd, SOL_XDP, XDP_MMAP_OFFSETS, &off, &optlen) == 0;
  ok = ok && s->tx.init(fd, XDP_PGOFF_TX_RING, off.tx, kRingSize,
                        sizeof(xdp_desc));
  ok = ok && s->comp.init(fd, XDP_UMEM_PGOFF_COMPLETION_RING, off.cr,
                          kRingSize, sizeof(std::uint64_t));
  if (ok) ok = bind_xsk_queue(fd, ifindex);
  if (!ok) {
    xsk_fail(3);
    s->tx.destroy();
    s->comp.destroy();
    s->umem.destroy();
    close(fd);
    delete s;
    return nullptr;
  }
  for (std::uint32_t i = 0; i < kNumFrames; ++i) s->free_frames[i] = i;
  s->n_free = kNumFrames;
  return s;
}

void* xsk_sender_create(const char* ifname, const char* src_ip,
                        const char* dst_ip, std::uint16_t src_port,
                        std::uint16_t dst_port, std::uint64_t mtu_payload) {
  return xsk_sender_create_fmt(ifname, src_ip, dst_ip, src_port, dst_port,
                               mtu_payload, 0);
}

// Packetize one chunk into UMEM frames and transmit via the TX ring in
// kTxBurst kicks (the 64-WRs-per-post pattern, ibverbs_tx.c:255-262).
// Blocking backpressure on ring space. Returns packets sent or -1.
long long xsk_send_chunk(void* handle, const std::uint8_t* payload,
                         std::uint64_t heap_len, std::uint64_t heap_id,
                         std::uint64_t timestamp,
                         std::uint32_t channel_offset) {
  auto* s = static_cast<XskSender*>(handle);
  if (!s || !payload) return -1;
  if (heap_len == 0) return 0;  // sp_packetize emits nothing for n=0
  std::uint64_t total = (heap_len + s->mtu_payload - 1) / s->mtu_payload;
  if (total > 0xFFFF) return -1;
  std::uint64_t hdr = s->hdr_bytes;
  auto* descs = static_cast<xdp_desc*>(s->tx.desc);
  std::uint64_t sent_bytes = 0;
  std::uint64_t pkt = 0;
  while (pkt < total) {
    // Reap completions; bound outstanding so UMEM frames are never
    // overwritten while the kernel still owns them.
    tx_reap(s);
    std::uint32_t prod = __atomic_load_n(s->tx.producer, __ATOMIC_RELAXED);
    std::uint32_t cons = __atomic_load_n(s->tx.consumer, __ATOMIC_ACQUIRE);
    std::uint32_t space = s->tx.size - (prod - cons);
    std::uint32_t frames_free = s->n_free;
    int burst = kTxBurst;
    if ((std::uint32_t)burst > space) burst = space;
    if ((std::uint32_t)burst > frames_free) burst = frames_free;
    if (burst > static_cast<int>(total - pkt))
      burst = static_cast<int>(total - pkt);
    if (burst <= 0) {
      // Ring full: kick and retry (tx_done_cleanup spin,
      // dpdk_send.cpp:259-267).
      sendto(s->fd, nullptr, 0, MSG_DONTWAIT, nullptr, 0);
      continue;
    }
    for (int i = 0; i < burst; ++i) {
      std::uint64_t idx = pkt + i;
      std::uint64_t poff = idx * s->mtu_payload;
      std::uint64_t plen = heap_len - poff < s->mtu_payload
                               ? heap_len - poff
                               : s->mtu_payload;
      std::uint32_t frame = s->free_frames[--s->n_free];
      std::uint8_t* f = s->umem.buf + static_cast<std::uint64_t>(frame) * kFrameSize;
      std::uint16_t udp_payload =
          static_cast<std::uint16_t>(hdr + plen);
      build_headers(f, s->src_ip, s->dst_ip, s->src_port, s->dst_port,
                    udp_payload);
      if (s->wire) {
        sp64_packetize(payload + poff, plen, heap_id, timestamp,
                       channel_offset, s->mtu_payload, f + kWireHdr,
                       kFrameSize - kWireHdr);
        sp64_patch_fragment(f + kWireHdr, heap_len, poff);
      } else {
        sp_packetize(payload + poff, plen, heap_id, timestamp,
                     channel_offset, s->mtu_payload, f + kWireHdr,
                     kFrameSize - kWireHdr);
        // Patch multi-packet heap fields (cf. stage_packets,
        // udp_burst.cpp).
        std::uint16_t idx16 = static_cast<std::uint16_t>(idx);
        std::uint16_t n16 = static_cast<std::uint16_t>(total);
        std::uint32_t hl32 = static_cast<std::uint32_t>(heap_len);
        std::memcpy(f + kWireHdr + 24, &idx16, 2);
        std::memcpy(f + kWireHdr + 26, &n16, 2);
        std::memcpy(f + kWireHdr + 32, &hl32, 4);
      }
      xdp_desc& d = descs[(prod + i) & (s->tx.size - 1)];
      d.addr = static_cast<std::uint64_t>(frame) * kFrameSize;
      d.len = kWireHdr + udp_payload;
      d.options = 0;
      sent_bytes += kWireHdr + udp_payload;
    }
    __atomic_store_n(s->tx.producer, prod + burst, __ATOMIC_RELEASE);
    if (sendto(s->fd, nullptr, 0, MSG_DONTWAIT, nullptr, 0) < 0 &&
        errno != EAGAIN && errno != EBUSY && errno != ENOBUFS)
      return -1;
    pkt += burst;
  }
  // Kick until the kernel has taken every descriptor of this chunk. A kick
  // transmits at most one batch (32 frames in copy mode), so descriptors
  // left in the TX ring would leave only with the next chunk's kicks: the
  // tail of every heap late, behind the head of the next.
  while (__atomic_load_n(s->tx.consumer, __ATOMIC_ACQUIRE) !=
         __atomic_load_n(s->tx.producer, __ATOMIC_RELAXED)) {
    sendto(s->fd, nullptr, 0, MSG_DONTWAIT, nullptr, 0);
    tx_reap(s);
  }
  // Drain completions so destroy never leaves the kernel holding frames.
  while (s->n_free < kRingSize) {
    sendto(s->fd, nullptr, 0, MSG_DONTWAIT, nullptr, 0);
    tx_reap(s);
  }
  s->packets.fetch_add(total, std::memory_order_relaxed);
  s->bytes.fetch_add(sent_bytes, std::memory_order_relaxed);
  return static_cast<long long>(total);
}

void xsk_sender_stats(void* handle, std::uint64_t* packets,
                      std::uint64_t* bytes) {
  auto* s = static_cast<XskSender*>(handle);
  if (!s) return;
  if (packets) *packets = s->packets.load(std::memory_order_relaxed);
  if (bytes) *bytes = s->bytes.load(std::memory_order_relaxed);
}

void xsk_sender_destroy(void* handle) {
  auto* s = static_cast<XskSender*>(handle);
  if (!s) return;
  s->tx.destroy();
  s->comp.destroy();
  s->umem.destroy();
  close(s->fd);
  delete s;
}

}  // extern "C"

// -------------------------------------------------------------- receiver

namespace {

struct XskReceiver {
  int fd = -1;
  Umem umem;
  XskRing rx, fill;
  int map_fd = -1, prog_fd = -1, link_fd = -1;
  void* reasm = nullptr;
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<std::uint64_t> packets{0};
  std::atomic<std::uint64_t> bytes{0};
};

// Hand-assembled XDP program: redirect UDP/IPv4 packets whose dst port
// matches ANY of the subscribed ports into the XSKMAP; XDP_PASS
// everything else (so unrelated traffic — ARP, TCP, other ports — flows
// to the stack untouched). One port per subscribed stream endpoint: the
// multi-stream subscription model of ibverbs_rx.c:207-210 expressed as
// the rte_flow steering rule of dpdk_recv.cpp:61-131 in eBPF.
constexpr int kMaxFilterPorts = 16;

int load_filter_prog(int map_fd, const std::uint16_t* ports, int n_ports) {
  if (n_ports < 1 || n_ports > kMaxFilterPorts) return -1;
  auto ins = [](std::uint8_t code, std::uint8_t dst, std::uint8_t src,
                std::int16_t off, std::int32_t imm) {
    bpf_insn i{};
    i.code = code;
    i.dst_reg = dst;
    i.src_reg = src;
    i.off = off;
    i.imm = imm;
    return i;
  };
  // Layout: 13-insn prelude, n_ports JEQ matches, a JA to pass, the
  // 6-insn redirect block, the 2-insn pass block. Jump offsets are
  // relative to the NEXT instruction.
  const int redirect_at = 14 + n_ports;
  const int pass_at = redirect_at + 6;
  bpf_insn prog[13 + kMaxFilterPorts + 1 + 6 + 2];
  int k = 0;
  // r6 = ctx; r2 = data, r3 = data_end
  prog[k++] = ins(BPF_ALU64 | BPF_MOV | BPF_X, 6, 1, 0, 0);
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_W, 2, 6, 0, 0);
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_W, 3, 6, 4, 0);
  // bounds: data + 42 <= data_end, else pass
  prog[k++] = ins(BPF_ALU64 | BPF_MOV | BPF_X, 4, 2, 0, 0);
  prog[k++] = ins(BPF_ALU64 | BPF_ADD | BPF_K, 4, 0, 0, kWireHdr);
  prog[k] = ins(BPF_JMP | BPF_JGT | BPF_X, 4, 3, pass_at - k - 1, 0); k++;
  // eth proto == ETH_P_IP
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_H, 5, 2, 12, 0);
  prog[k] = ins(BPF_JMP | BPF_JNE | BPF_K, 5, 0, pass_at - k - 1, 0x0008); k++;
  // ip proto == UDP
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_B, 5, 2, 23, 0);
  prog[k] = ins(BPF_JMP | BPF_JNE | BPF_K, 5, 0, pass_at - k - 1, 17); k++;
  // IHL == 5 (we build these headers ourselves)
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_B, 5, 2, 14, 0);
  prog[k] = ins(BPF_JMP | BPF_JNE | BPF_K, 5, 0, pass_at - k - 1, 0x45); k++;
  // dst port ∈ subscribed set → redirect
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_H, 5, 2, 36, 0);
  for (int i = 0; i < n_ports; ++i) {
    prog[k] = ins(BPF_JMP | BPF_JEQ | BPF_K, 5, 0, redirect_at - k - 1,
                  htons(ports[i]));
    k++;
  }
  prog[k] = ins(BPF_JMP | BPF_JA, 0, 0, pass_at - k - 1, 0); k++;
  // redirect: bpf_redirect_map(xsks_map, ctx->rx_queue_index, XDP_PASS)
  prog[k++] = ins(BPF_LD | BPF_IMM | BPF_DW, 1, BPF_PSEUDO_MAP_FD, 0, map_fd);
  prog[k++] = ins(0, 0, 0, 0, 0);  // second half of ld_imm64
  prog[k++] = ins(BPF_LDX | BPF_MEM | BPF_W, 2, 6, 16, 0);
  prog[k++] = ins(BPF_ALU64 | BPF_MOV | BPF_K, 3, 0, 0, 2);
  prog[k++] = ins(BPF_JMP | BPF_CALL, 0, 0, 0, 51);  // BPF_FUNC_redirect_map
  prog[k++] = ins(BPF_JMP | BPF_EXIT, 0, 0, 0, 0);
  // pass:
  prog[k++] = ins(BPF_ALU64 | BPF_MOV | BPF_K, 0, 0, 0, 2);  // XDP_PASS
  prog[k++] = ins(BPF_JMP | BPF_EXIT, 0, 0, 0, 0);
  static char license[] = "GPL";
  bpf_attr attr{};
  attr.prog_type = BPF_PROG_TYPE_XDP;
  attr.insns = reinterpret_cast<std::uint64_t>(prog);
  attr.insn_cnt = k;
  attr.license = reinterpret_cast<std::uint64_t>(license);
  return static_cast<int>(bpf_sys(BPF_PROG_LOAD, &attr));
}

void rx_loop(XskReceiver* rx) {
  auto* descs = static_cast<xdp_desc*>(rx->rx.desc);
  auto* fills = static_cast<std::uint64_t*>(rx->fill.desc);
  pollfd pfd{rx->fd, POLLIN, 0};
  while (!rx->stop.load(std::memory_order_relaxed)) {
    std::uint32_t prod = __atomic_load_n(rx->rx.producer, __ATOMIC_ACQUIRE);
    std::uint32_t cons = __atomic_load_n(rx->rx.consumer, __ATOMIC_RELAXED);
    if (prod == cons) {
      poll(&pfd, 1, 50);  // interrupt-driven idle wait (dpdk_recv:230-244)
      continue;
    }
    std::uint32_t n = prod - cons;
    std::uint64_t nbytes = 0;
    std::uint32_t fprod = __atomic_load_n(rx->fill.producer, __ATOMIC_RELAXED);
    for (std::uint32_t i = 0; i < n; ++i) {
      const xdp_desc& d = descs[(cons + i) & (rx->rx.size - 1)];
      const std::uint8_t* f = rx->umem.buf + d.addr;
      if (d.len > kWireHdr)
        ub_reasm_feed(rx->reasm, f + kWireHdr, d.len - kWireHdr);
      nbytes += d.len;
      // Recycle the frame straight back to the fill ring.
      fills[(fprod + i) & (rx->fill.size - 1)] = d.addr & ~(std::uint64_t)(kFrameSize - 1);
    }
    __atomic_store_n(rx->rx.consumer, cons + n, __ATOMIC_RELEASE);
    __atomic_store_n(rx->fill.producer, fprod + n, __ATOMIC_RELEASE);
    rx->packets.fetch_add(n, std::memory_order_relaxed);
    rx->bytes.fetch_add(nbytes, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" {

void* xsk_receiver_create_multi(const char* ifname,
                                const std::uint16_t* ports, int n_ports,
                                std::uint64_t mtu_payload, void* ring) {
  if (!ifname || mtu_payload == 0 || !ring || !ports || n_ports < 1)
    return nullptr;
  unsigned ifindex = if_nametoindex(ifname);
  if (ifindex == 0) { xsk_fail(1); return nullptr; }
  int fd = socket(AF_XDP, SOCK_RAW, 0);
  if (fd < 0) { xsk_fail(2); return nullptr; }
  auto* rx = new (std::nothrow) XskReceiver();
  if (!rx) {
    close(fd);
    return nullptr;
  }
  rx->fd = fd;
  int rsize = kRingSize;
  bool ok = rx->umem.init(fd) &&
            setsockopt(fd, SOL_XDP, XDP_UMEM_FILL_RING, &rsize, sizeof(rsize)) == 0 &&
            setsockopt(fd, SOL_XDP, XDP_UMEM_COMPLETION_RING, &rsize, sizeof(rsize)) == 0 &&
            setsockopt(fd, SOL_XDP, XDP_RX_RING, &rsize, sizeof(rsize)) == 0;
  xdp_mmap_offsets off{};
  socklen_t optlen = sizeof(off);
  ok = ok && getsockopt(fd, SOL_XDP, XDP_MMAP_OFFSETS, &off, &optlen) == 0;
  ok = ok && rx->rx.init(fd, XDP_PGOFF_RX_RING, off.rx, kRingSize,
                         sizeof(xdp_desc));
  ok = ok && rx->fill.init(fd, XDP_UMEM_PGOFF_FILL_RING, off.fr, kRingSize,
                           sizeof(std::uint64_t));
  if (ok) ok = bind_xsk_queue(fd, ifindex);
  if (!ok) xsk_fail(3);
  if (ok) {
    // Pre-stock the fill ring with half the UMEM.
    auto* fills = static_cast<std::uint64_t*>(rx->fill.desc);
    std::uint32_t n = kRingSize;
    for (std::uint32_t i = 0; i < n; ++i)
      fills[i] = static_cast<std::uint64_t>(i) * kFrameSize;
    __atomic_store_n(rx->fill.producer, n, __ATOMIC_RELEASE);
  }
  if (ok) {
    // XSKMAP + filter program + link attach (SKB mode).
    bpf_attr mattr{};
    mattr.map_type = BPF_MAP_TYPE_XSKMAP;
    mattr.key_size = 4;
    mattr.value_size = 4;
    mattr.max_entries = 4;
    rx->map_fd = static_cast<int>(bpf_sys(BPF_MAP_CREATE, &mattr));
    ok = rx->map_fd >= 0;
    if (ok) {
      std::uint32_t key = 0, val = static_cast<std::uint32_t>(fd);
      bpf_attr uattr{};
      uattr.map_fd = rx->map_fd;
      uattr.key = reinterpret_cast<std::uint64_t>(&key);
      uattr.value = reinterpret_cast<std::uint64_t>(&val);
      ok = bpf_sys(BPF_MAP_UPDATE_ELEM, &uattr) == 0;
    }
    if (ok) {
      rx->prog_fd = load_filter_prog(rx->map_fd, ports, n_ports);
      ok = rx->prog_fd >= 0;
    }
    if (ok) {
      bpf_attr lattr{};
      lattr.link_create.prog_fd = rx->prog_fd;
      lattr.link_create.target_fd = static_cast<int>(ifindex);
      lattr.link_create.attach_type = BPF_XDP;
      lattr.link_create.flags = XDP_FLAGS_SKB_MODE;
      rx->link_fd = static_cast<int>(bpf_sys(BPF_LINK_CREATE, &lattr));
      ok = rx->link_fd >= 0;
    }
    if (!ok) xsk_fail(4);
  }
  if (ok) {
    rx->reasm = ub_reasm_create(ring, mtu_payload);
    ok = rx->reasm != nullptr;
  }
  if (!ok) {
    if (rx->link_fd >= 0) close(rx->link_fd);
    if (rx->prog_fd >= 0) close(rx->prog_fd);
    if (rx->map_fd >= 0) close(rx->map_fd);
    rx->rx.destroy();
    rx->fill.destroy();
    rx->umem.destroy();
    close(fd);
    delete rx;
    return nullptr;
  }
  rx->thread = std::thread(rx_loop, rx);
  return rx;
}

void* xsk_receiver_create(const char* ifname, std::uint16_t port,
                          std::uint64_t mtu_payload, void* ring) {
  return xsk_receiver_create_multi(ifname, &port, 1, mtu_payload, ring);
}

void xsk_receiver_stats(void* handle, std::uint64_t* packets,
                        std::uint64_t* bytes, std::uint64_t* heaps,
                        std::uint64_t* ring_drops, std::uint64_t* evicted) {
  auto* rx = static_cast<XskReceiver*>(handle);
  if (!rx) return;
  if (packets) *packets = rx->packets.load(std::memory_order_relaxed);
  if (bytes) *bytes = rx->bytes.load(std::memory_order_relaxed);
  ub_reasm_stats(rx->reasm, heaps, ring_drops, evicted);
}

void xsk_receiver_destroy(void* handle) {
  auto* rx = static_cast<XskReceiver*>(handle);
  if (!rx) return;
  rx->stop.store(true);
  if (rx->thread.joinable()) rx->thread.join();
  if (rx->link_fd >= 0) close(rx->link_fd);  // detaches the XDP program
  if (rx->prog_fd >= 0) close(rx->prog_fd);
  if (rx->map_fd >= 0) close(rx->map_fd);
  rx->rx.destroy();
  rx->fill.destroy();
  rx->umem.destroy();
  close(rx->fd);
  ub_reasm_destroy(rx->reasm);
  delete rx;
}

}  // extern "C"
