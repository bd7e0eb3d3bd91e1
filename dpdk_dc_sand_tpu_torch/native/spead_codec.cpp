// SPEAD-lite heap codec — native packetize/reassemble hot path.
//
// The reference transmits pre-built SPEAD heaps of (timestamp, frequency,
// payload) immediate items (fgpu_send_prototype.py:19-61) over UDP, with
// payload sequence numbers for loss accounting (ibverbs_rx.c:303-319) and
// an offline arange-pattern verifier (dpdk_send_recv/verify.py:20-33).
// This implements the same contract with a fixed 40-byte little-endian
// header per packet; Python holds the buffers, C++ does the byte work.

#include <cstdint>
#include <cstring>

namespace {

constexpr std::uint32_t kMagic = 0x4B415430;  // "KAT0" as a LE u32
constexpr std::size_t kHeaderBytes = 40;

#pragma pack(push, 1)
struct Header {
  std::uint32_t magic;
  std::uint32_t channel_offset;  // SPEAD frequency item analog
  std::uint64_t heap_id;         // chunk sequence number
  std::uint64_t timestamp;       // ADC sample count (SPEAD item 0x1600)
  std::uint16_t packet_idx;
  std::uint16_t n_packets;
  std::uint32_t payload_len;     // bytes in this packet
  std::uint32_t heap_len;        // total heap payload bytes
  std::uint32_t reserved;
};
#pragma pack(pop)

static_assert(sizeof(Header) == kHeaderBytes, "header size drift");

}  // namespace

extern "C" {

std::uint64_t sp_header_bytes() { return kHeaderBytes; }

// Split `payload[heap_len]` into packets of at most `mtu_payload` payload
// bytes each, written consecutively at out + i*out_stride (header + slice).
// Returns the packet count, or 0 on bad arguments.
std::uint64_t sp_packetize(const std::uint8_t* payload, std::uint64_t heap_len,
                           std::uint64_t heap_id, std::uint64_t timestamp,
                           std::uint32_t channel_offset,
                           std::uint64_t mtu_payload, std::uint8_t* out,
                           std::uint64_t out_stride) {
  if (!payload || !out || mtu_payload == 0 ||
      out_stride < kHeaderBytes + mtu_payload)
    return 0;
  std::uint64_t n = (heap_len + mtu_payload - 1) / mtu_payload;
  if (n == 0) n = 1;
  if (n > 0xFFFF) return 0;
  for (std::uint64_t i = 0; i < n; ++i) {
    std::uint64_t off = i * mtu_payload;
    std::uint64_t len = heap_len - off < mtu_payload ? heap_len - off
                                                     : mtu_payload;
    Header h;
    h.magic = kMagic;
    h.channel_offset = channel_offset;
    h.heap_id = heap_id;
    h.timestamp = timestamp;
    h.packet_idx = static_cast<std::uint16_t>(i);
    h.n_packets = static_cast<std::uint16_t>(n);
    h.payload_len = static_cast<std::uint32_t>(len);
    h.heap_len = static_cast<std::uint32_t>(heap_len);
    h.reserved = 0;
    std::uint8_t* dst = out + i * out_stride;
    std::memcpy(dst, &h, kHeaderBytes);
    std::memcpy(dst + kHeaderBytes, payload + off, len);
  }
  return n;
}

// Parse one packet header. Returns 1 on success (outputs filled), 0 if the
// magic doesn't match or the buffer is too short.
int sp_parse_header(const std::uint8_t* pkt, std::uint64_t pkt_len,
                    std::uint64_t* heap_id, std::uint64_t* timestamp,
                    std::uint32_t* channel_offset, std::uint16_t* packet_idx,
                    std::uint16_t* n_packets, std::uint32_t* payload_len,
                    std::uint32_t* heap_len) {
  if (!pkt || pkt_len < kHeaderBytes) return 0;
  Header h;
  std::memcpy(&h, pkt, kHeaderBytes);
  if (h.magic != kMagic) return 0;
  if (pkt_len < kHeaderBytes + h.payload_len) return 0;
  if (heap_id) *heap_id = h.heap_id;
  if (timestamp) *timestamp = h.timestamp;
  if (channel_offset) *channel_offset = h.channel_offset;
  if (packet_idx) *packet_idx = h.packet_idx;
  if (n_packets) *n_packets = h.n_packets;
  if (payload_len) *payload_len = h.payload_len;
  if (heap_len) *heap_len = h.heap_len;
  return 1;
}

// Scatter one packet's payload into a heap assembly buffer laid out with
// slot size mtu_payload. Returns the packet's payload length, or -1 on a
// malformed packet / overflow.
long long sp_scatter(const std::uint8_t* pkt, std::uint64_t pkt_len,
                     std::uint64_t mtu_payload, std::uint8_t* heap_buf,
                     std::uint64_t heap_cap) {
  if (!pkt || pkt_len < kHeaderBytes) return -1;
  Header h;
  std::memcpy(&h, pkt, kHeaderBytes);
  if (h.magic != kMagic) return -1;
  std::uint64_t off = static_cast<std::uint64_t>(h.packet_idx) * mtu_payload;
  if (off + h.payload_len > heap_cap) return -1;
  if (pkt_len < kHeaderBytes + h.payload_len) return -1;
  std::memcpy(heap_buf + off, pkt + kHeaderBytes, h.payload_len);
  return static_cast<long long>(h.payload_len);
}

// ---------------------------------------------------------------------
// Deterministic payload pattern (dpdk verify.py contract): 64-bit words,
// word[i] = (chunk_id << 32) + i, except word[0] carries a packet counter.
// ---------------------------------------------------------------------

void sp_fill_pattern(std::uint64_t* words, std::uint64_t n_words,
                     std::uint64_t chunk_id, std::uint64_t counter) {
  if (!words) return;
  const std::uint64_t base = chunk_id << 32;
  for (std::uint64_t i = 0; i < n_words; ++i) words[i] = base + i;
  if (n_words) words[0] = counter;
}

// Count mismatching words (ignoring word 0). Returns mismatch count.
std::uint64_t sp_check_pattern(const std::uint64_t* words,
                               std::uint64_t n_words, std::uint64_t chunk_id) {
  if (!words) return n_words;
  const std::uint64_t base = chunk_id << 32;
  std::uint64_t bad = 0;
  for (std::uint64_t i = 1; i < n_words; ++i)
    if (words[i] != base + i) ++bad;
  return bad;
}

}  // extern "C"

// ------------------------------------------------------------------
// Real SPEAD-64-48 (stream/spead64.py contract): 8-byte header +
// seven big-endian 64-bit item pointers per packet + payload slice.
// Native hot path for spead2-interoperable egress at rate.
// ------------------------------------------------------------------
namespace {

constexpr std::size_t kSp64HeaderBytes = 8 + 7 * 8;
constexpr int kAddrBits = 48;
constexpr std::uint64_t kAddrMask = (1ULL << kAddrBits) - 1;
constexpr std::uint64_t kImmediate = 1ULL << 63;

inline void put_be64(std::uint8_t* p, std::uint64_t v) {
  for (int i = 7; i >= 0; --i) {
    p[i] = static_cast<std::uint8_t>(v & 0xFF);
    v >>= 8;
  }
}

inline void put_ptr(std::uint8_t* p, bool imm, std::uint16_t id,
                    std::uint64_t value) {
  std::uint64_t ptr = (static_cast<std::uint64_t>(id) << kAddrBits) |
                      (value & kAddrMask);
  if (imm) ptr |= kImmediate;
  put_be64(p, ptr);
}

}  // namespace

extern "C" {

std::uint64_t sp64_header_bytes() { return kSp64HeaderBytes; }

// Parse one SPEAD-64-48 packet (any pointer count/order). Returns 1 on
// success; 0 when the packet is not this flavour, malformed, or a
// stream-control packet. ``header_bytes`` reports where the payload
// starts (8 + 8*n_items).
int sp64_parse(const std::uint8_t* pkt, std::uint64_t pkt_len,
               std::uint64_t* heap_id, std::uint64_t* timestamp,
               std::uint32_t* channel_offset, std::uint64_t* payload_off,
               std::uint32_t* payload_len, std::uint32_t* heap_len,
               std::uint32_t* header_bytes) {
  if (!pkt || pkt_len < 8) return 0;
  if (pkt[0] != 0x53 || pkt[1] != 4 || pkt[2] != 8 || pkt[3] != 6) return 0;
  std::uint32_t n_items =
      (static_cast<std::uint32_t>(pkt[6]) << 8) | pkt[7];
  std::uint64_t hdr = 8 + 8ull * n_items;
  if (pkt_len < hdr) return 0;
  std::uint64_t hid = ~0ull, ts = 0, freq = 0, off = 0;
  std::uint64_t hlen = ~0ull, plen = ~0ull;
  for (std::uint32_t i = 0; i < n_items; ++i) {
    std::uint64_t ptr = 0;
    const std::uint8_t* p = pkt + 8 + 8ull * i;
    for (int b = 0; b < 8; ++b) ptr = (ptr << 8) | p[b];
    std::uint16_t id = static_cast<std::uint16_t>((ptr >> 48) & 0x7FFF);
    std::uint64_t value = ptr & ((1ULL << 48) - 1);
    switch (id) {
      case 0x01: hid = value; break;
      case 0x02: hlen = value; break;
      case 0x03: off = value; break;
      case 0x04: plen = value; break;
      case 0x06: return 0;  // stream control: not a data packet
      case 0x1600: ts = value; break;
      case 0x4103: freq = value; break;
      default: break;
    }
  }
  if (hid == ~0ull || hlen == ~0ull) return 0;
  if (plen == ~0ull) plen = pkt_len - hdr;
  if (hdr + plen > pkt_len) return 0;
  *heap_id = hid;
  *timestamp = ts;
  *channel_offset = static_cast<std::uint32_t>(freq);
  *payload_off = off;
  *payload_len = static_cast<std::uint32_t>(plen);
  *heap_len = static_cast<std::uint32_t>(hlen);
  *header_bytes = static_cast<std::uint32_t>(hdr);
  return 1;
}

// SPEAD-64-48 packetize: same calling convention as sp_packetize.
// Every packet repeats the full pointer set (heap cnt/size, this
// packet's offset/length, immediate timestamp 0x1600 and frequency
// 0x4103, addressed feng_raw 0x4300) so capture tools read the
// timestamp off any packet.
std::uint64_t sp64_packetize(const std::uint8_t* payload,
                             std::uint64_t heap_len, std::uint64_t heap_id,
                             std::uint64_t timestamp,
                             std::uint32_t channel_offset,
                             std::uint64_t mtu_payload, std::uint8_t* out,
                             std::uint64_t out_stride) {
  if (!payload || !out || mtu_payload == 0 ||
      out_stride < kSp64HeaderBytes + mtu_payload)
    return 0;
  std::uint64_t n = (heap_len + mtu_payload - 1) / mtu_payload;
  if (n == 0) n = 1;
  for (std::uint64_t i = 0; i < n; ++i) {
    std::uint64_t off = i * mtu_payload;
    std::uint64_t len = heap_len - off < mtu_payload ? heap_len - off
                                                     : mtu_payload;
    std::uint8_t* dst = out + i * out_stride;
    dst[0] = 0x53;  // magic
    dst[1] = 4;     // version
    dst[2] = 8;     // item pointer width (bytes)
    dst[3] = 6;     // heap address width (bytes)
    dst[4] = dst[5] = 0;
    dst[6] = 0;
    dst[7] = 7;  // item pointer count (big-endian u16)
    std::uint8_t* p = dst + 8;
    put_ptr(p + 0 * 8, true, 0x01, heap_id);          // heap counter
    put_ptr(p + 1 * 8, true, 0x02, heap_len);         // heap size
    put_ptr(p + 2 * 8, true, 0x03, off);              // payload offset
    put_ptr(p + 3 * 8, true, 0x04, len);              // payload length
    put_ptr(p + 4 * 8, true, 0x1600, timestamp);      // ADC timestamp
    put_ptr(p + 5 * 8, true, 0x4103, channel_offset); // frequency
    put_ptr(p + 6 * 8, false, 0x4300, 0);             // feng_raw @ 0
    std::memcpy(dst + kSp64HeaderBytes, payload + off, len);
  }
  return n;
}

// Rewrite the heap-size (pointer 1) and payload-offset (pointer 2)
// items of a packet produced by a single-slice sp64_packetize call so
// it becomes fragment ``payload_off`` of a ``heap_len``-byte heap —
// the per-packet staging pattern of the burst/XDP TX engines.
void sp64_patch_fragment(std::uint8_t* pkt, std::uint64_t heap_len,
                         std::uint64_t payload_off) {
  put_ptr(pkt + 8 + 1 * 8, true, 0x02, heap_len);
  put_ptr(pkt + 8 + 2 * 8, true, 0x03, payload_off);
}

}  // extern "C"
