"""Native burst UDP transport: sendmmsg / GSO / io_uring fast paths (counterpart of ``dpdk_dc_sand_tpu/stream/udp_native.py``).

Python's per-datagram ``sendto`` loop tops out well under a Gbps; the
reference's data plane bursts 32 packets per call into the NIC
(dpdk_send.cpp:273-315, ``rte_eth_tx_burst``). This wraps the native
engines (:mod:`dpdk_dc_sand_tpu_torch.native` ``udp_burst.cpp``): sendmmsg
bursts, UDP_SEGMENT/UDP_GRO segmentation offload (~15 wire packets per
kernel stack traversal, ~480 per syscall), or an io_uring
submission-queue ring (the descriptor-ring model of ibverbs_tx.c:255-262)
— header build + heap reassembly in C++, completed chunks delivered
straight into the native SPSC ring. Python touches data only at chunk
granularity, exactly like the reference's chunked zero-copy pipeline.
Reassembly counts each packet once, so a repeated packet (a resent heap)
neither completes a heap with holes nor opens a heap already delivered; a
datagram that holds several packets with no segment size from the kernel
(one that takes ``UDP_SEGMENT`` but does not segment, as gVisor) is walked
packet by packet, and the receive loop polls rather than asking for
``MSG_WAITFORONE``, which such kernels refuse.
On a page-locked ring (``ChunkRing(pinned=True)``) each heap lands where
the node's feed copies it to the card. Rates on the card's host:
``chip_smoke.py`` phase 23 (``node_native``).

API mirrors :mod:`dpdk_dc_sand_tpu_torch.stream.udp`; ring slot layout is
identical (16-byte timestamp/channel_offset prefix + payload), so
consumers use ``UdpReceiver.unpack`` unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing


def burst_available() -> bool:
    """Whether the native burst engine can be used on this host."""
    return load_native() is not None


#: Engine selection: mode name -> native mode id.
_MODES = {"burst": 0, "gso": 1, "uring": 2}


def _resolve_mode(mode: str) -> list[int]:
    """Candidate native mode ids, best first (``auto`` tries gso→burst)."""
    if mode == "auto":
        return [_MODES["gso"], _MODES["burst"]]
    if mode not in _MODES:
        raise ValueError(f"unknown transport mode {mode!r}")
    return [_MODES[mode]]


class BurstUdpSender:
    """Chunk transmitter over the native kernel fast paths.

    ``mode``: ``"auto"`` (GSO segmentation offload when the kernel
    supports it, else sendmmsg), ``"burst"`` (sendmmsg), ``"gso"``
    (UDP_SEGMENT super-datagrams), or ``"uring"`` (io_uring submission
    ring).
    """

    def __init__(
        self,
        dest: Tuple[str, int],
        mtu_payload: int = 4096,
        mode: str = "auto",
        wire_format: str = "lite",
    ) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("no g++ to build the host library; use stream.udp")
        if wire_format not in ("lite", "spead64"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self._lib = lib
        self.dest = dest
        self.mtu_payload = mtu_payload
        #: "spead64" emits real SPEAD-64-48 packets at native rate
        #: (spead_codec.cpp sp64_packetize; OR'd kFlagWire64 mode bit).
        self.wire_format = wire_format
        flag = 0x200 if wire_format == "spead64" else 0
        self._h = ctypes.c_void_p()
        for m in _resolve_mode(mode):
            self._h = ctypes.c_void_p(
                lib.ub_sender_create_mode(
                    dest[0].encode(), dest[1], mtu_payload, m | flag
                )
            )
            if self._h:
                break
        if not self._h:
            raise OSError(f"cannot open UDP sender to {dest} (mode={mode})")
        self.mode = {v: k for k, v in _MODES.items()}[
            lib.ub_sender_mode(self._h)
        ]

    def send_chunk(self, chunk: Chunk) -> int:
        payload = np.ascontiguousarray(chunk.payload).view(np.uint8).ravel()
        n = self._lib.ub_send_chunk(
            self._h,
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            payload.nbytes,
            chunk.seq,
            chunk.timestamp,
            chunk.channel_offset,
        )
        if n < 0:
            raise OSError("ub_send_chunk failed")
        return int(n)

    def stats(self) -> Tuple[int, int]:
        """(packets, bytes) sent."""
        p, b = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.ub_sender_stats(self._h, ctypes.byref(p), ctypes.byref(b))
        return p.value, b.value

    def close(self) -> None:
        if self._h:
            self._lib.ub_sender_destroy(self._h)
            self._h = ctypes.c_void_p()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class BurstUdpReceiver:
    """Burst receiver: C++ thread drains the socket, reassembles heaps,
    and delivers completed chunks into ``ring`` (which must be native)."""

    def __init__(
        self,
        bind: Tuple[str, int],
        ring: ChunkRing,
        mtu_payload: int = 4096,
        group: Optional[str] = None,
        mode: str = "auto",
        reuse_port: bool = False,
    ) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("no g++ to build the host library; use stream.udp")
        if not ring.native:
            raise ValueError("BurstUdpReceiver needs a native ChunkRing")
        self._lib = lib
        self.ring = ring
        self._h = ctypes.c_void_p()
        # reuse_port: N worker receivers share one port (the multi-queue
        # RSS analog); the kernel flow-hashes by 4-tuple, so each TX
        # socket's heaps land wholly on one worker and reassembly stays
        # per-worker. OR'd into the native mode word (kFlagReusePort).
        flag = 0x100 if reuse_port else 0
        for m in _resolve_mode(mode):
            self._h = ctypes.c_void_p(
                lib.ub_receiver_create_mode(
                    bind[0].encode(),
                    bind[1],
                    group.encode() if group else None,
                    mtu_payload,
                    ring._ring,
                    m | flag,
                )
            )
            if self._h:
                break
        if not self._h:
            raise OSError(f"cannot bind UDP receiver on {bind} (mode={mode})")
        self.mode = {v: k for k, v in _MODES.items()}[
            lib.ub_receiver_mode(self._h)
        ]

    @property
    def port(self) -> int:
        return int(self._lib.ub_receiver_port(self._h))

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(5)]
        self._lib.ub_receiver_stats(self._h, *map(ctypes.byref, vals))
        keys = ("packets", "bytes", "heaps", "ring_drops", "evicted")
        return dict(zip(keys, (v.value for v in vals)))

    def stop(self) -> None:
        if self._h:
            self._lib.ub_receiver_destroy(self._h)
            self._h = ctypes.c_void_p()

    close = stop

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.stop()
        except Exception:
            pass
