"""The port's burst-UDP transport (``stream/udp_native.py``) vs the JAX package's.

Every case of ``tests/test_udp_native.py`` on the port, over the engine
modes (sendmmsg, GSO/GRO, io_uring) and both wire formats; heaps across the
packages (the JAX sender into the port's receiver and the port's sender into
the JAX receiver, with the slot bytes equal); and a small CPU ``EngineNode``
fed by the port's receiver straight into its native ring, whose beams
equal its engine's step. A mode the kernel refuses skips, as in the
reference's tests.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

from dpdk_dc_sand_tpu.stream import udp_native as j_udp_native
from dpdk_dc_sand_tpu.stream.ring import ChunkRing as JChunkRing
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
from dpdk_dc_sand_tpu_torch.stream import udp_native
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing
from dpdk_dc_sand_tpu_torch.stream.spead import check_pattern, fill_pattern
from dpdk_dc_sand_tpu_torch.stream.udp import UdpReceiver, UdpSender

MODES = ["burst", "gso", "uring"]
WIRES = ["lite", "spead64"]


@pytest.fixture(autouse=True)
def _library():
    if not udp_native.burst_available():
        pytest.skip("no g++ on PATH: the host library cannot be built")


def _drain(ring, want, deadline_s=10.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        r = ring.acquire_read()
        if r is None:
            time.sleep(0.002)
            continue
        view, seq = r
        chunk = UdpReceiver.unpack(view)
        got.append((seq, chunk.timestamp, chunk.channel_offset, chunk.payload.copy()))
        ring.release_read()
    return got


def _open(mode, ring, mtu, wire="lite"):
    """A port receiver and sender in ``mode``; skips where the kernel refuses."""
    try:
        rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=mtu, mode=mode)
    except OSError as e:
        pytest.skip(f"{mode} receiver unsupported on this kernel: {e}")
    try:
        tx = udp_native.BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=mtu, mode=mode,
                                       wire_format=wire)
    except OSError as e:
        rx.stop()
        pytest.skip(f"{mode} sender unsupported on this kernel: {e}")
    return rx, tx


@pytest.mark.parametrize("wire", WIRES)
def test_burst_roundtrip_multi_packet_heaps(wire):
    ring = ChunkRing(64, 1 << 20, native=True)
    rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=4096)
    tx = udp_native.BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=4096, wire_format=wire)
    try:
        assert tx.mode == rx.mode == "gso"  # auto: GSO first, as the reference
        rng = np.random.default_rng(2021)
        chunks = [rng.integers(0, 255, size=300_000, dtype=np.uint8) for _ in range(6)]
        for i, c in enumerate(chunks):
            tx.send_chunk(Chunk(payload=c, seq=i, timestamp=5000 + i, channel_offset=i * 64))
            time.sleep(0.01)  # loopback pacing: UDP is lossy by contract
        got = _drain(ring, len(chunks))
        assert len(got) == len(chunks), rx.stats()
        for i, (seq, ts, co, payload) in enumerate(got):
            assert (seq, ts, co) == (i, 5000 + i, i * 64)
            np.testing.assert_array_equal(payload, chunks[i])
        pkts, nbytes = tx.stats()
        assert pkts == 74 * len(chunks)  # 300000/4096 -> 74 packets per heap
        st = rx.stats()
        assert st["heaps"] == len(chunks) and st["ring_drops"] == st["evicted"] == 0
        assert st["packets"] >= pkts - st["evicted"] * 74
    finally:
        rx.stop()
        tx.close()
        ring.close()


def test_burst_pattern_payload_verifies():
    """The dpdk verify.py arange-pattern survives packetize/reassemble."""
    ring = ChunkRing(8, 1 << 16, native=True)
    rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=1024)
    tx = udp_native.BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=1024)
    try:
        payload = fill_pattern(4096, chunk_id=7, counter=42)
        tx.send_chunk(Chunk(payload=payload, seq=7, timestamp=1, channel_offset=0))
        got = _drain(ring, 1)
        assert len(got) == 1
        words = np.ascontiguousarray(got[0][3]).view(np.uint64)
        assert check_pattern(words, chunk_id=7) == 0
        assert int(words[0]) == 42
    finally:
        rx.stop()
        tx.close()
        ring.close()


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mode", MODES)
def test_roundtrip_all_engine_modes(mode, wire):
    """Every kernel fast path round-trips multi-packet heaps with intact
    payloads and metadata, in either wire format."""
    ring = ChunkRing(64, 1 << 20, native=True)
    rx, tx = _open(mode, ring, 4096, wire)
    try:
        assert tx.mode == mode and rx.mode == mode and tx.wire_format == wire
        rng = np.random.default_rng(7)
        chunks = [rng.integers(0, 255, size=200_000, dtype=np.uint8) for _ in range(4)]
        for i, c in enumerate(chunks):
            tx.send_chunk(Chunk(payload=c, seq=i, timestamp=100 + i, channel_offset=i))
            time.sleep(0.01)
        got = _drain(ring, len(chunks))
        assert len(got) == len(chunks), (mode, rx.stats())
        for i, (seq, ts, co, payload) in enumerate(got):
            assert (seq, ts, co) == (i, 100 + i, i)
            np.testing.assert_array_equal(payload, chunks[i])
    finally:
        rx.stop()
        tx.close()
        ring.close()


@pytest.mark.parametrize("wire", WIRES)
def test_receiver_walks_a_datagram_of_several_packets(wire):
    """A datagram that carries several packets back to back with no segment
    size from the kernel (a kernel that takes UDP_SEGMENT but does not
    segment delivers the sender's super-datagram whole): the receiver walks
    it by each packet's own length and completes the heap."""
    import socket

    from dpdk_dc_sand_tpu_torch.stream.spead import packetize
    from dpdk_dc_sand_tpu_torch.stream.spead64 import packetize64

    ring = ChunkRing(4, 1 << 16, native=True)
    rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=1024, mode="gso")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        pay = np.random.default_rng(9).integers(0, 256, 5000, dtype=np.uint8)
        if wire == "lite":
            pkts = packetize(pay, heap_id=3, timestamp=8, channel_offset=1, mtu_payload=1024)
        else:
            pkts = packetize64(pay, heap_cnt=3, timestamp=8, channel_offset=1, mtu_payload=1024)
        s.sendto(b"".join(pkts[:3]), ("127.0.0.1", rx.port))
        s.sendto(b"".join(pkts[3:]) + b"trailing", ("127.0.0.1", rx.port))
        got = _drain(ring, 1, 5.0)
        assert len(got) == 1 and got[0][:3] == (3, 8, 1), rx.stats()
        np.testing.assert_array_equal(got[0][3], pay)
        assert rx.stats()["packets"] == 6  # 5 packets and the trailing bytes
    finally:
        s.close()
        rx.stop()
        ring.close()


def test_burst_receiver_requires_native_ring():
    ring = ChunkRing(4, 1024, native=False)
    assert not ring.native
    with pytest.raises(ValueError, match="native ChunkRing"):
        udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring)


def test_unknown_mode_and_wire_format_raise():
    ring = ChunkRing(4, 1024, native=True)
    with pytest.raises(ValueError, match="mode"):
        udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mode="pacing")
    with pytest.raises(ValueError, match="wire_format"):
        udp_native.BurstUdpSender(("127.0.0.1", 9), wire_format="spead2")
    ring.close()


@pytest.mark.parametrize("wire,hdr", [("lite", 40), ("spead64", 64)])
def test_burst_sender_stats_accumulate(wire, hdr):
    ring = ChunkRing(8, 1 << 16, native=True)
    rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=512)
    tx = udp_native.BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=512, wire_format=wire)
    try:
        data = np.zeros(2048, np.uint8)
        for i in range(3):
            tx.send_chunk(Chunk(payload=data, seq=i, timestamp=0, channel_offset=0))
        pkts, nbytes = tx.stats()
        assert pkts == 3 * 4  # 2048/512
        assert nbytes == 3 * 4 * (512 + hdr)
    finally:
        rx.stop()
        tx.close()
        ring.close()


def test_native_receiver_dual_stack_spead64():
    """The C reassembly ingests real SPEAD-64-48 and SPEAD-lite heaps on
    one port (byte-counted completion shared across formats)."""
    ring = ChunkRing(8, 1 << 20, native=True)
    rx = udp_native.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=1024)
    tx64 = UdpSender(("127.0.0.1", rx.port), mtu_payload=1024, wire_format="spead64")
    txl = UdpSender(("127.0.0.1", rx.port), mtu_payload=1024)
    try:
        rng = np.random.default_rng(2)
        pa = rng.integers(0, 256, 8192, dtype=np.uint8)
        pb = rng.integers(0, 256, 8192, dtype=np.uint8)
        tx64.send_chunk(Chunk(pa, seq=1, timestamp=11, channel_offset=5))
        txl.send_chunk(Chunk(pb, seq=2, timestamp=22, channel_offset=6))
        got = {seq: (ts, co, p) for seq, ts, co, p in _drain(ring, 2, 5.0)}
        assert got[1][:2] == (11, 5) and got[2][:2] == (22, 6)
        np.testing.assert_array_equal(got[1][2], pa)
        np.testing.assert_array_equal(got[2][2], pb)
    finally:
        tx64.close()
        txl.close()
        rx.stop()
        ring.close()


@pytest.mark.parametrize("mode", MODES)
def test_native_spead64_tx_all_engines(mode):
    """Every socket engine emits real SPEAD-64-48 (kFlagWire64); the
    dual-stack RX reassembles bit-exact, and the Python receiver reads the
    same heap."""
    ring = ChunkRing(8, 1 << 20, native=True)
    rx, tx = _open(mode, ring, 1024, "spead64")
    py_ring = ChunkRing(8, 1 << 20, native=False)
    py_rx = UdpReceiver(("127.0.0.1", 0), py_ring, mtu_payload=1024).start()
    py_tx = udp_native.BurstUdpSender(("127.0.0.1", py_rx.port), mtu_payload=1024, mode=mode,
                                      wire_format="spead64")
    try:
        pay = np.random.default_rng(1).integers(0, 256, 50000, dtype=np.uint8)
        tx.send_chunk(Chunk(pay, seq=4, timestamp=99, channel_offset=3))
        py_tx.send_chunk(Chunk(pay, seq=4, timestamp=99, channel_offset=3))
        for r in (ring, py_ring):
            got = _drain(r, 1, 5.0)
            assert len(got) == 1 and got[0][:3] == (4, 99, 3)
            np.testing.assert_array_equal(got[0][3], pay)
    finally:
        tx.close()
        py_tx.close()
        rx.stop()
        py_rx.stop()
        ring.close()


def test_reuse_port_workers_share_one_port():
    """``reuse_port``: two receivers on one port (the RSS analog), each
    reassembling whole heaps into its own ring."""
    rings = [ChunkRing(8, 1 << 18, native=True) for _ in range(2)]
    rxs = [udp_native.BurstUdpReceiver(("127.0.0.1", 0), rings[0], mtu_payload=1024,
                                       mode="burst", reuse_port=True)]
    try:
        rxs.append(udp_native.BurstUdpReceiver(("127.0.0.1", rxs[0].port), rings[1],
                                               mtu_payload=1024, mode="burst",
                                               reuse_port=True))
        pay = np.random.default_rng(4).integers(0, 256, 20000, dtype=np.uint8)
        for seq in range(8):  # one sender a heap: the kernel hashes each flow to a worker
            tx = udp_native.BurstUdpSender(("127.0.0.1", rxs[0].port), mtu_payload=1024,
                                           mode="burst")
            tx.send_chunk(Chunk(pay, seq=seq))
            tx.close()
            time.sleep(0.01)
        deadline = time.time() + 5
        while sum(rx.stats()["heaps"] for rx in rxs) < 8 and time.time() < deadline:
            time.sleep(0.01)
        assert sum(rx.stats()["heaps"] for rx in rxs) == 8
        assert all(rx.stats()["evicted"] == 0 for rx in rxs)
        got = _drain(rings[0], len(rings[0])) + _drain(rings[1], len(rings[1]))
        assert sorted(g[0] for g in got) == list(range(8))
        for g in got:
            np.testing.assert_array_equal(g[3], pay)
    finally:
        for rx in rxs:
            rx.stop()
        for r in rings:
            r.close()


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_heaps_cross_the_packages_with_equal_slot_bytes(direction, wire):
    """The JAX sender into the port's receiver and the port's sender into the
    JAX receiver: the same heaps land as the same slot bytes as a same-package
    pair gives."""
    rng = np.random.default_rng(11)
    chunks = [rng.integers(0, 256, 100_000 + 333 * i, dtype=np.uint8) for i in range(3)]
    port_rx_side = direction == "jax_to_port"
    ring = ChunkRing(8, 1 << 18, native=True) if port_rx_side else JChunkRing(8, 1 << 18,
                                                                              native=True)
    ref_ring = JChunkRing(8, 1 << 18, native=True) if port_rx_side else ChunkRing(8, 1 << 18,
                                                                                  native=True)
    rx_mod, tx_mod = (udp_native, j_udp_native) if port_rx_side else (j_udp_native, udp_native)
    rx = rx_mod.BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=2048, mode="burst")
    ref_rx = tx_mod.BurstUdpReceiver(("127.0.0.1", 0), ref_ring, mtu_payload=2048, mode="burst")
    tx = tx_mod.BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=2048, mode="burst",
                               wire_format=wire)
    ref_tx = tx_mod.BurstUdpSender(("127.0.0.1", ref_rx.port), mtu_payload=2048, mode="burst",
                                   wire_format=wire)
    try:
        for seq, c in enumerate(chunks):
            for t in (tx, ref_tx):
                t.send_chunk(Chunk(c, seq=seq, timestamp=1000 * seq, channel_offset=8 * seq))
            time.sleep(0.01)
        slots = []
        for r in (ring, ref_ring):
            got = []
            deadline = time.time() + 10
            while len(got) < len(chunks) and time.time() < deadline:
                item = r.acquire_read()
                if item is None:
                    time.sleep(0.002)
                    continue
                got.append((item[1], bytes(item[0])))
                r.release_read()
            slots.append(got)
        assert slots[0] == slots[1]
        assert [s for s, _ in slots[0]] == [0, 1, 2]
        for (seq, raw), c in zip(slots[0], chunks):
            assert raw[16:] == c.tobytes()
            assert np.frombuffer(raw[:16], "<u8").tolist() == [1000 * seq, 8 * seq]
        assert tx.stats() == ref_tx.stats()
        assert {k: v for k, v in rx.stats().items()} == ref_rx.stats()
    finally:
        for t in (tx, ref_tx):
            t.close()
        for r in (rx, ref_rx):
            r.stop()
        ring.close()
        ref_ring.close()


# ----------------------------------------------------------------------
# The node, fed over native UDP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["gso", "burst"])
def test_engine_node_fed_over_native_udp_matches_its_engine(mode):
    """A CPU EngineNode takes its ADC heaps from the port's burst receiver,
    which reassembles them straight into the node's native ring: each
    chunk's beams equal the node's engine step on that chunk."""
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=4)
    out = {}
    node = EngineNode(cfg, n_spectra=8, fengine="xla", beam_quant_scale=0.25, device="cpu",
                      on_beams=lambda b, s: out.setdefault(s, np.array(b)))
    assert node.ring.native
    chunks = [np.random.default_rng(s).integers(-64, 64, node.chunk_shape, dtype=np.int8)
              for s in range(3)]

    async def scenario():
        tx = None
        try:
            rx = node.attach_ingest(udp_native.BurstUdpReceiver(("127.0.0.1", 0), node.ring,
                                                                mode=mode))
            assert isinstance(rx, udp_native.BurstUdpReceiver) and rx.mode == mode
            await node.start()
            tx = udp_native.BurstUdpSender(("127.0.0.1", rx.port), mode=mode)
            for seq, adc in enumerate(chunks):  # one heap in flight at a time
                tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq))
                deadline = time.monotonic() + 60
                while seq not in out and time.monotonic() < deadline:
                    await asyncio.sleep(0.01)
            return rx.stats()
        finally:
            if tx is not None:
                tx.close()
            await node.stop()

    loop = asyncio.new_event_loop()
    try:
        stats = loop.run_until_complete(asyncio.wait_for(scenario(), 240))
    finally:
        loop.close()
    assert sorted(out) == [0, 1, 2]
    assert stats["heaps"] == 3 and stats["ring_drops"] == stats["evicted"] == 0
    assert node.feed.stats.lost == 0
    zi, zf = np.zeros(cfg.n_ants, np.int32), np.zeros(cfg.n_ants, np.float32)
    for seq, adc in enumerate(chunks):
        np.testing.assert_array_equal(out[seq], node.fb.step(adc, zi, zf, zf).numpy())
