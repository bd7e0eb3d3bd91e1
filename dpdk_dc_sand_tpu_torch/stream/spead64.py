"""Real SPEAD-64-48 wire codec (counterpart of ``dpdk_dc_sand_tpu/stream/spead64.py``).

SPEAD-lite (:mod:`dpdk_dc_sand_tpu_torch.stream.spead`) keeps the reference's
heap *contract* in a fixed 40-byte header — fast, but not the wire
protocol MeerKAT actually speaks. This module implements the SPEAD
protocol proper in the 64-48 flavour the reference uses throughout
(``spead2.Flavour(4, 64, 48, 0)``, fgpu_send_prototype.py:19): 8-byte
header, big-endian 64-bit item pointers with a 48-bit immediate/address
field, standard heap bookkeeping items, and the katgpucbf application
items — immediate ADC timestamp 0x1600, immediate frequency (= absolute
channel offset, the ``xeng_id`` addressing) 0x4103 and the addressed
payload item 0x4300 (fgpu_send_prototype.py:20-42).

Every packet repeats all item pointers (spead2's ``repeat_pointers``
behaviour), which is what lets passive capture tools read the timestamp
off ANY packet of a heap (packet_latency/extract_timestamps.py:17-35) —
:mod:`dpdk_dc_sand_tpu_torch.stream.latency` relies on the same property.

Byte-level layout (SPEAD protocol, 64-48 flavour)::

    offset 0: 0x53 'S' magic          4: reserved (0, 2 bytes)
           1: version = 4             6: number of item pointers (>u2)
           2: item pointer width = 8
           3: heap address width = 6
    then n_items × 8-byte big-endian pointers:
           bit 63      immediate flag
           bits 62..48 item id (15 bits)
           bits 47..0  value (immediate) or payload byte offset (addressed)
    then the payload slice for this packet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Callable, Dict, List, Optional

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk, StreamStats

MAGIC = 0x53
VERSION = 4
ITEM_PTR_BYTES = 8
HEAP_ADDR_BYTES = 6
ADDR_BITS = 8 * HEAP_ADDR_BYTES
ADDR_MASK = (1 << ADDR_BITS) - 1
IMMEDIATE = 1 << 63

# Standard SPEAD item ids.
HEAP_CNT_ID = 0x01
HEAP_SIZE_ID = 0x02
HEAP_OFFSET_ID = 0x03
PAYLOAD_LEN_ID = 0x04
STREAM_CTRL_ID = 0x06
STREAM_CTRL_STOP = 2

# katgpucbf application ids (fgpu_send_prototype.py:20-22).
TIMESTAMP_ID = 0x1600
FREQUENCY_ID = 0x4103
FENG_RAW_ID = 0x4300

_HDR = struct.Struct(">BBBBHH")
_PTR = struct.Struct(">Q")


def _imm(item_id: int, value: int) -> bytes:
    return _PTR.pack(IMMEDIATE | (item_id << ADDR_BITS) | (value & ADDR_MASK))


def _addr(item_id: int, offset: int) -> bytes:
    return _PTR.pack((item_id << ADDR_BITS) | (offset & ADDR_MASK))


def packetize64(
    payload: np.ndarray,
    heap_cnt: int,
    timestamp: int = 0,
    channel_offset: int = 0,
    mtu_payload: int = 4096,
) -> List[bytes]:
    """Split one heap payload into SPEAD-64-48 packets.

    Each packet carries the full pointer set: heap counter/size, this
    packet's payload offset/length, the immediate timestamp and
    frequency, and the addressed raw-data item — so any single packet
    identifies its heap and instant (extract_timestamps.py:21-31).
    The host library's ``sp64_packetize`` where it loads, else the
    byte-identical Python codec.
    """
    flat = np.ascontiguousarray(payload).view(np.uint8).ravel()
    total = flat.nbytes
    n = max(1, -(-total // mtu_payload))
    lib = load_native()
    if lib is not None:
        hdr = int(lib.sp64_header_bytes())
        stride = hdr + mtu_payload
        out = np.empty(n * stride, np.uint8)
        p8 = ctypes.POINTER(ctypes.c_uint8)
        wrote = lib.sp64_packetize(
            flat.ctypes.data_as(p8), total, heap_cnt, timestamp, channel_offset,
            mtu_payload, out.ctypes.data_as(p8), stride,
        )
        if wrote != n:
            raise ValueError(f"sp64_packetize wrote {wrote} of {n} packets")
        return [
            out[i * stride : i * stride + hdr + min(mtu_payload, total - i * mtu_payload)]
            .tobytes()
            for i in range(n)
        ]

    pkts = []
    for i in range(n):
        off = i * mtu_payload
        part = flat[off : off + mtu_payload]
        ptrs = b"".join(
            (
                _imm(HEAP_CNT_ID, heap_cnt),
                _imm(HEAP_SIZE_ID, total),
                _imm(HEAP_OFFSET_ID, off),
                _imm(PAYLOAD_LEN_ID, part.nbytes),
                _imm(TIMESTAMP_ID, timestamp),
                _imm(FREQUENCY_ID, channel_offset),
                _addr(FENG_RAW_ID, 0),
            )
        )
        hdr = _HDR.pack(
            MAGIC, VERSION, ITEM_PTR_BYTES, HEAP_ADDR_BYTES, 0, len(ptrs) // 8
        )
        pkts.append(hdr + ptrs + part.tobytes())
    return pkts


def stream_stop_packet() -> bytes:
    """A stream-control STOP packet (spead2 end-of-stream convention)."""
    ptrs = _imm(STREAM_CTRL_ID, STREAM_CTRL_STOP)
    return _HDR.pack(MAGIC, VERSION, ITEM_PTR_BYTES, HEAP_ADDR_BYTES, 0, 1) + ptrs


@dataclasses.dataclass
class Packet64:
    heap_cnt: int
    heap_size: int
    payload_offset: int
    payload_len: int
    timestamp: int
    channel_offset: int
    payload: bytes
    stream_ctrl: Optional[int] = None


def parse_packet64(pkt: bytes) -> Optional[Packet64]:
    """Decode one SPEAD-64-48 packet; None if not SPEAD or wrong flavour."""
    if len(pkt) < _HDR.size:
        return None
    magic, ver, ipw, haw, _, n_items = _HDR.unpack_from(pkt)
    if magic != MAGIC or ver != VERSION or ipw != ITEM_PTR_BYTES:
        return None
    if haw != HEAP_ADDR_BYTES:
        return None
    end = _HDR.size + 8 * n_items
    if len(pkt) < end:
        return None
    fields = {
        "heap_cnt": -1,
        "heap_size": -1,
        "payload_offset": 0,
        "payload_len": -1,
        "timestamp": 0,
        "channel_offset": 0,
    }
    ctrl = None
    for i in range(n_items):
        (ptr,) = _PTR.unpack_from(pkt, _HDR.size + 8 * i)
        item_id = (ptr >> ADDR_BITS) & 0x7FFF
        value = ptr & ADDR_MASK
        if item_id == HEAP_CNT_ID:
            fields["heap_cnt"] = value
        elif item_id == HEAP_SIZE_ID:
            fields["heap_size"] = value
        elif item_id == HEAP_OFFSET_ID:
            fields["payload_offset"] = value
        elif item_id == PAYLOAD_LEN_ID:
            fields["payload_len"] = value
        elif item_id == TIMESTAMP_ID:
            fields["timestamp"] = value
        elif item_id == FREQUENCY_ID:
            fields["channel_offset"] = value
        elif item_id == STREAM_CTRL_ID:
            ctrl = value
    payload = pkt[end:]
    if fields["payload_len"] < 0:
        fields["payload_len"] = len(payload)
    if fields["payload_len"] > len(payload):
        return None
    return Packet64(
        payload=payload[: fields["payload_len"]], stream_ctrl=ctrl, **fields
    )


class Heap64Assembler:
    """Reassemble SPEAD-64-48 packets into heaps (the spead2 RX contract).

    Same interface and loss accounting as
    :class:`dpdk_dc_sand_tpu_torch.stream.spead.HeapAssembler` — heap-cnt gap
    tracking plus eviction of stale incomplete heaps — but driven by the
    protocol's own payload offset/length bookkeeping items rather than a
    packet index, so partial, reordered and duplicated packets are all
    handled per the spec.
    """

    def __init__(
        self,
        window: int = 8,
        on_chunk: Optional[Callable[[Chunk], None]] = None,
    ) -> None:
        self.window = window
        self.on_chunk = on_chunk
        self.stats = StreamStats()
        self.incomplete_dropped = 0
        self.stopped = False
        self._partial: Dict[int, dict] = {}

    def feed(self, packet: bytes) -> Optional[Chunk]:
        hdr = parse_packet64(packet)
        if hdr is None:
            return None
        if hdr.stream_ctrl == STREAM_CTRL_STOP:
            self.stopped = True
            return None
        if hdr.heap_cnt < 0 or hdr.heap_size < 0:
            return None
        st = self._partial.get(hdr.heap_cnt)
        if st is None:
            st = {
                "buf": np.zeros(hdr.heap_size, np.uint8),
                "got": 0,
                "seen": set(),
                "timestamp": hdr.timestamp,
                "channel_offset": hdr.channel_offset,
            }
            self._partial[hdr.heap_cnt] = st
            self._evict(hdr.heap_cnt)
        off = hdr.payload_offset
        if off + hdr.payload_len > st["buf"].nbytes or off in st["seen"]:
            return None
        st["seen"].add(off)
        st["buf"][off : off + hdr.payload_len] = np.frombuffer(
            hdr.payload, np.uint8
        )
        st["got"] += hdr.payload_len
        if st["got"] >= st["buf"].nbytes:
            del self._partial[hdr.heap_cnt]
            chunk = Chunk(
                st["buf"],
                seq=hdr.heap_cnt,
                timestamp=st["timestamp"],
                channel_offset=st["channel_offset"],
            )
            self.stats.observe(hdr.heap_cnt, st["buf"].nbytes)
            if self.on_chunk is not None:
                self.on_chunk(chunk)
            return chunk
        return None

    def _evict(self, newest: int) -> None:
        stale = [h for h in self._partial if h <= newest - self.window]
        for h in stale:
            del self._partial[h]
            self.incomplete_dropped += 1
