"""SPEAD-lite heap codec (counterpart of ``dpdk_dc_sand_tpu/stream/spead.py``).

The production protocol in the reference is SPEAD: pre-built heaps of
(timestamp, frequency, payload) items mutated in place and sent without
per-send construction (fgpu_send_prototype.py:3-9,45-61). This module
keeps that shape: fixed 40-byte headers, heap = chunk payload split into
MTU packets, reassembly with per-heap completion tracking and loss
accounting via heap-id gaps.

The reference package packetizes with its native library where it can and
falls back to byte-identical Python; the port keeps the Python codec only
(the native host library waits, ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, List, Optional

import numpy as np

from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk, StreamStats

_MAGIC = 0x4B415430
HEADER_BYTES = 40
#: header little-endian layout (the reference's native/spead_codec.cpp)
_HDR = struct.Struct("<IIQQHHIII")


@dataclasses.dataclass
class PacketHeader:
    heap_id: int
    timestamp: int
    channel_offset: int
    packet_idx: int
    n_packets: int
    payload_len: int
    heap_len: int


def packetize(
    payload: np.ndarray,
    heap_id: int,
    timestamp: int = 0,
    channel_offset: int = 0,
    mtu_payload: int = 4096,
) -> List[bytes]:
    """Split one heap payload into header-prefixed packets."""
    flat = np.ascontiguousarray(payload).view(np.uint8).ravel()
    n = -(-max(flat.nbytes, 1) // mtu_payload)
    pkts = []
    for i in range(n):
        chunk = flat[i * mtu_payload : (i + 1) * mtu_payload]
        hdr = _HDR.pack(
            _MAGIC,
            channel_offset,
            heap_id,
            timestamp,
            i,
            n,
            chunk.nbytes,
            flat.nbytes,
            0,
        )
        pkts.append(hdr + chunk.tobytes())
    return pkts


def parse_header(packet: bytes) -> Optional[PacketHeader]:
    """Decode one packet header; None if malformed."""
    if len(packet) < HEADER_BYTES:
        return None
    magic, chan, heap_id, ts, idx, n, plen, hlen, _ = _HDR.unpack_from(packet)
    if magic != _MAGIC or len(packet) < HEADER_BYTES + plen:
        return None
    return PacketHeader(heap_id, ts, chan, idx, n, plen, hlen)


class HeapAssembler:
    """Reassemble packets into heaps; emit complete chunks in arrival order.

    Tracks losses two ways, as the reference does: heap-id gaps (payload
    sequence accounting, ibverbs_rx.c:303-319) and incomplete heaps evicted
    when more than ``window`` heaps are in flight.
    """

    def __init__(
        self,
        mtu_payload: int = 4096,
        window: int = 8,
        on_chunk: Optional[Callable[[Chunk], None]] = None,
    ) -> None:
        self.mtu_payload = mtu_payload
        self.window = window
        self.on_chunk = on_chunk
        self.stats = StreamStats()
        self.incomplete_dropped = 0
        self._partial: Dict[int, dict] = {}

    def feed(self, packet: bytes) -> Optional[Chunk]:
        """Process one packet; a Chunk when its heap completes."""
        hdr = parse_header(packet)
        if hdr is None:
            return None
        st = self._partial.get(hdr.heap_id)
        if st is None:
            st = {
                "buf": np.zeros(hdr.heap_len, np.uint8),
                "got": 0,
                "need": hdr.n_packets,
                "timestamp": hdr.timestamp,
                "channel_offset": hdr.channel_offset,
            }
            self._partial[hdr.heap_id] = st
            self._evict(hdr.heap_id)
        off = hdr.packet_idx * self.mtu_payload
        payload = np.frombuffer(
            packet, np.uint8, hdr.payload_len, HEADER_BYTES
        )
        st["buf"][off : off + hdr.payload_len] = payload
        st["got"] += 1
        if st["got"] == st["need"]:
            del self._partial[hdr.heap_id]
            chunk = Chunk(
                st["buf"],
                seq=hdr.heap_id,
                timestamp=st["timestamp"],
                channel_offset=st["channel_offset"],
            )
            self.stats.observe(hdr.heap_id, st["buf"].nbytes)
            if self.on_chunk is not None:
                self.on_chunk(chunk)
            return chunk
        return None

    def _evict(self, newest: int) -> None:
        stale = [h for h in self._partial if h <= newest - self.window]
        for h in stale:
            del self._partial[h]
            self.incomplete_dropped += 1


# ----------------------------------------------------------------------
# Deterministic payload pattern (verify.py:20-33 contract)
# ----------------------------------------------------------------------
def fill_pattern(n_words: int, chunk_id: int, counter: int = 0) -> np.ndarray:
    """``word[i] = (chunk_id << 32) + i`` with a counter in word 0."""
    out = (np.uint64(chunk_id) << np.uint64(32)) + np.arange(
        n_words, dtype=np.uint64
    )
    if n_words:
        out[0] = counter
    return out


def check_pattern(words: np.ndarray, chunk_id: int) -> int:
    """Count mismatching words (word 0 excluded)."""
    words = np.ascontiguousarray(words, np.uint64)
    want = (np.uint64(chunk_id) << np.uint64(32)) + np.arange(
        words.size, dtype=np.uint64
    )
    return int((words[1:] != want[1:]).sum())
