"""AF_XDP (XSK) chunk transport, descriptor-ring kernel bypass (counterpart of ``dpdk_dc_sand_tpu/stream/udp_xdp.py``).

The fourth transport engine behind the burst-UDP contract (after
sendmmsg / GSO / io_uring, :mod:`dpdk_dc_sand_tpu_torch.stream.udp_native`):
UMEM frame pools and producer/consumer descriptor rings, the closest
software analog of the reference's DPDK extbuf TX
(dpdk_send_recv/dpdk_send.cpp:252-315) and ibverbs WR/CQ rings
(ibverbs_tx.c:33-34). Native implementation: ``native/xdp_burst.cpp``.

Unlike the socket engines this one addresses an *interface*, not an
IP route — TX injects raw Eth/IPv4/UDP frames at the device and RX
steers frames off the device with a hand-assembled eBPF filter
(the rte_flow rule of dpdk_recv.cpp:61-131). Use :func:`veth_pair`
to build an isolated two-ended test fabric (raw frames genuinely
traverse a veth; host-local IP routing would shortcut via loopback).

Requires CAP_NET_RAW (+ CAP_BPF/CAP_NET_ADMIN for RX attach); raises
``OSError`` where the kernel or capabilities forbid it.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional, Tuple

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing


def _fail_detail(lib) -> str:
    """Human-readable create-failure cause from the native error capture."""
    import os

    stage = lib.xsk_last_fail_stage()
    err = lib.xsk_last_fail_errno()
    names = {1: "frame-size/ifindex", 2: "socket(AF_XDP)", 3: "ring/bind setup",
             4: "XDP program/attach"}
    return f"stage={names.get(stage, stage)} errno={err} {os.strerror(err)}"


class XdpSender:
    """Raw-frame AF_XDP chunk transmitter on ``ifname`` queue 0."""

    def __init__(
        self,
        ifname: str,
        src_ip: str,
        dst_ip: str,
        port: int,
        mtu_payload: int = 3584,
        src_port: int = 5001,
        wire_format: str = "lite",
    ) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("no g++ to build the host library")
        if wire_format not in ("lite", "spead64"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self._lib = lib
        self.mtu_payload = mtu_payload
        self.wire_format = wire_format
        self._h = ctypes.c_void_p(
            lib.xsk_sender_create_fmt(
                ifname.encode(), src_ip.encode(), dst_ip.encode(),
                src_port, port, mtu_payload,
                1 if wire_format == "spead64" else 0,
            )
        )
        if not self._h:
            raise OSError(
                f"cannot open AF_XDP sender on {ifname} "
                f"({_fail_detail(lib)})"
            )

    def send_chunk(self, chunk: Chunk) -> int:
        payload = np.ascontiguousarray(chunk.payload).view(np.uint8).ravel()
        n = self._lib.xsk_send_chunk(
            self._h,
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            payload.nbytes,
            chunk.seq,
            chunk.timestamp,
            chunk.channel_offset,
        )
        if n < 0:
            raise OSError("xsk_send_chunk failed")
        return int(n)

    def stats(self) -> Tuple[int, int]:
        p, b = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.xsk_sender_stats(self._h, ctypes.byref(p), ctypes.byref(b))
        return p.value, b.value

    def close(self) -> None:
        if self._h:
            self._lib.xsk_sender_destroy(self._h)
            self._h = ctypes.c_void_p()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class XdpReceiver:
    """AF_XDP receiver: eBPF port filter steers frames into the XSK RX
    ring; a C++ thread strips headers and reassembles SPEAD heaps into
    ``ring`` (must be a native ChunkRing).

    ``port`` may be an int or a list of ints: multiple subscribed stream
    endpoints are matched in one filter program — the multi-stream
    subscription model of ibverbs_rx.c:207-210 at the XDP layer (each
    engine steers exactly the channel-slice streams it owns into its
    ring; everything else passes to the stack untouched).
    """

    def __init__(
        self,
        ifname: str,
        port,
        ring: ChunkRing,
        mtu_payload: int = 3584,
    ) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("no g++ to build the host library")
        if not ring.native:
            raise ValueError("XdpReceiver needs a native ChunkRing")
        self._lib = lib
        self.ring = ring
        ports = [port] if isinstance(port, int) else list(port)
        if not ports or len(ports) > 16:
            raise ValueError("1..16 subscribed ports supported")
        arr = (ctypes.c_uint16 * len(ports))(*ports)
        self._h = ctypes.c_void_p(
            lib.xsk_receiver_create_multi(
                ifname.encode(), arr, len(ports), mtu_payload, ring._ring
            )
        )
        if not self._h:
            raise OSError(
                f"cannot open AF_XDP receiver on {ifname} "
                f"({_fail_detail(lib)})"
            )

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(5)]
        self._lib.xsk_receiver_stats(self._h, *map(ctypes.byref, vals))
        keys = ("packets", "bytes", "heaps", "ring_drops", "evicted")
        return dict(zip(keys, (v.value for v in vals)))

    def stop(self) -> None:
        if self._h:
            self._lib.xsk_receiver_destroy(self._h)
            self._h = ctypes.c_void_p()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.stop()
        except Exception:
            pass


def veth_pair(
    name_a: str = "dcsxdp0", name_b: str = "dcsxdp1", mtu: int = 8000
) -> Optional[Tuple[str, str]]:
    """Create an up'd veth pair for the XDP fabric; None if not allowed.

    Raw AF_XDP frames injected at ``name_a`` genuinely traverse the pair
    and ingress ``name_b`` (host-local IP routing would shortcut via
    loopback, which is why the socket engines can't use this fabric and
    this engine doesn't touch theirs)."""
    import time as _time

    try:
        subprocess.run(
            ["ip", "link", "del", name_a], capture_output=True, check=False
        )
        # Teardown is asynchronous in the kernel; a fresh add can race a
        # just-deleted pair of the same name. Retry briefly.
        for attempt in range(10):
            r = subprocess.run(
                ["ip", "link", "add", name_a, "type", "veth", "peer",
                 "name", name_b],
                capture_output=True,
            )
            if r.returncode == 0:
                break
            _time.sleep(0.05)
        else:
            return None
        for cmd in (
            ["ip", "link", "set", name_a, "mtu", str(mtu), "up"],
            ["ip", "link", "set", name_b, "mtu", str(mtu), "up"],
        ):
            if subprocess.run(cmd, capture_output=True).returncode != 0:
                return None
    except FileNotFoundError:
        return None
    return name_a, name_b


def veth_destroy(name_a: str = "dcsxdp0") -> None:
    subprocess.run(["ip", "link", "del", name_a], capture_output=True, check=False)
