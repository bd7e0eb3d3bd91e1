"""The port's AF_XDP transport (``stream/udp_xdp.py``): raw-frame round trips over a veth fabric.

Every case of ``tests/test_udp_xdp.py`` on the port, on a veth pair of its
own (``dcstxdp0``/``dcstxdp1``: the JAX tests, which may run at the same
time in another process, use ``dcsxdp0``/``dcsxdp1``). SPEAD-lite and
SPEAD-64-48 chunks packetized into raw Eth/IPv4/UDP frames on one end,
steered off the other by the eBPF port filter into the XSK, reassembled
into the native ring. Resends are delivery-gated as in the reference; the
port's reassembly counts each packet once, so a resent heap arrives once
and whole. Skips where the kernel or the capabilities forbid veth or
AF_XDP, as the reference's tests do.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from dpdk_dc_sand_tpu_torch.stream import udp_xdp
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing
from dpdk_dc_sand_tpu_torch.stream.udp import UdpReceiver

VETH = ("dcstxdp0", "dcstxdp1")


@pytest.fixture()
def fabric():
    if not udp_xdp.load_native():
        pytest.skip("no g++ on PATH: the host library cannot be built")
    pair = udp_xdp.veth_pair(*VETH)
    if pair is None:
        pytest.skip("cannot create a veth pair (no CAP_NET_ADMIN?)")
    try:
        yield pair
    finally:
        udp_xdp.veth_destroy(pair[0])


def _receiver(ifname, port, ring, mtu):
    try:
        return udp_xdp.XdpReceiver(ifname, port, ring, mtu_payload=mtu)
    except OSError as e:
        pytest.skip(f"AF_XDP unavailable: {e}")


def _drainer(ring, got):
    def drain():
        while (r := ring.acquire_read()) is not None:
            view, seq = r
            chunk = UdpReceiver.unpack(view)
            got.setdefault(seq, (chunk.timestamp, chunk.channel_offset, chunk.payload.copy()))
            ring.release_read()
    return drain


def _deliver(tx, chunk, got, drain, timeout=10.0):
    """Resend ``chunk`` until its seq appears (the chunk.active backpressure
    spin of dpdk_send.cpp:259-267); returns the number of sends."""
    sends = 0
    deadline = time.time() + timeout
    while chunk.seq not in got and time.time() < deadline:
        tx.send_chunk(chunk)
        sends += 1
        t_wait = time.time() + 0.25
        while chunk.seq not in got and time.time() < t_wait:
            drain()
            time.sleep(0.005)
    return sends


def test_xdp_roundtrip_chunks(fabric):
    a, b = fabric
    ring = ChunkRing(64, 1 << 20, native=True)
    rx = _receiver(b, 5002, ring, 3584)
    tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 5002, mtu_payload=3584)
    try:
        rng = np.random.default_rng(2021)
        chunks = [rng.integers(0, 255, size=300_000, dtype=np.uint8) for _ in range(5)]
        got = {}
        drain = _drainer(ring, got)
        for i, c in enumerate(chunks):
            _deliver(tx, Chunk(payload=c, seq=i, timestamp=5000 + i, channel_offset=i * 64),
                     got, drain)
            assert i in got, (i, tx.stats(), rx.stats())
        for i, c in enumerate(chunks):
            ts, co, payload = got[i]
            assert (ts, co) == (5000 + i, i * 64)
            np.testing.assert_array_equal(payload.view(np.uint8), c)
        st = rx.stats()
        assert st["heaps"] == len(chunks) and st["ring_drops"] == 0
    finally:
        tx.close()
        rx.stop()
        ring.close()


def test_xdp_sender_flushes_each_heap(fabric):
    """Each ``send_chunk`` leaves with its whole heap: sent once, every small
    heap completes (a kick transmits one batch, so the sender kicks until the
    kernel has taken every descriptor, not leaving a heap's tail in the TX
    ring for the next chunk's kicks)."""
    a, b = fabric
    ring = ChunkRing(8, 1 << 18, native=True)
    rx = _receiver(b, 5002, ring, 3584)
    tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 5002, mtu_payload=3584)
    try:
        pay = np.random.default_rng(5).integers(0, 256, 150_000, dtype=np.uint8)
        for seq in range(3):
            tx.send_chunk(Chunk(pay, seq=seq))
        deadline = time.time() + 5
        while rx.stats()["heaps"] < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert rx.stats()["heaps"] == 3, (tx.stats(), rx.stats())
        assert rx.stats()["packets"] == tx.stats()[0] == 3 * 42
    finally:
        tx.close()
        rx.stop()
        ring.close()


def test_xdp_port_filter_passes_other_traffic(fabric):
    """The eBPF steering rule consumes only OUR port: packets for another
    port pass to the stack untouched."""
    a, b = fabric
    ring = ChunkRing(8, 1 << 16, native=True)
    rx = _receiver(b, 5002, ring, 1024)
    tx_other = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 6000, mtu_payload=1024)
    try:
        tx_other.send_chunk(Chunk(payload=np.zeros(512, np.uint8), seq=0))
        time.sleep(0.3)
        assert rx.stats()["packets"] == 0  # not steered into our XSK
    finally:
        tx_other.close()
        rx.stop()
        ring.close()


def test_xdp_multiport_subscription(fabric):
    """One engine's filter steers SEVERAL stream endpoints into its ring
    (ibverbs_rx.c:207-210) while foreign endpoints still pass. Senders open
    one at a time: one XSK per veth queue."""
    a, b = fabric
    ring = ChunkRing(16, 1 << 16, native=True)
    rx = _receiver(b, [5003, 5004], ring, 1024)
    rng = np.random.default_rng(3)
    payloads = {p: rng.integers(0, 255, 2048, dtype=np.uint8) for p in (5003, 5004, 6001)}
    got = {}
    drain = _drainer(ring, got)
    try:
        for i, p in enumerate((5003, 5004)):
            tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", p, mtu_payload=1024)
            try:
                _deliver(tx, Chunk(payload=payloads[p], seq=i, channel_offset=i * 128), got, drain)
            finally:
                tx.close()
            assert i in got, (p, rx.stats())
        for i, p in enumerate((5003, 5004)):
            _, off, payload = got[i]
            assert off == i * 128
            np.testing.assert_array_equal(payload.view(np.uint8), payloads[p])
        before = rx.stats()["packets"]
        tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 6001, mtu_payload=1024)
        try:
            tx.send_chunk(Chunk(payload=payloads[6001], seq=9))
            time.sleep(0.3)
            drain()
        finally:
            tx.close()
        assert 9 not in got
        assert rx.stats()["packets"] == before
    finally:
        rx.stop()
        ring.close()


def test_xdp_spead64_roundtrip(fabric):
    """AF_XDP speaks real SPEAD-64-48: raw frames with SPEAD-64-48 payloads
    steered by the eBPF filter and reassembled bit-exact."""
    a, b = fabric
    ring = ChunkRing(16, 1 << 20, native=True)
    rx = _receiver(b, 5002, ring, 3520)
    tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 5002, mtu_payload=3520,
                           wire_format="spead64")
    try:
        pay = np.random.default_rng(2).integers(0, 256, 123456, dtype=np.uint8)
        got = {}
        _deliver(tx, Chunk(pay, seq=7, timestamp=42, channel_offset=9), got, _drainer(ring, got))
        assert 7 in got, rx.stats()
        ts, co, payload = got[7]
        assert (ts, co) == (42, 9)
        np.testing.assert_array_equal(np.asarray(payload), pay)
    finally:
        tx.close()
        rx.stop()
        ring.close()


def test_xdp_receiver_requires_native_ring_and_sane_ports():
    ring = ChunkRing(4, 1024, native=False)
    with pytest.raises(ValueError, match="native ChunkRing"):
        udp_xdp.XdpReceiver("lo", 5002, ring)
    native = ChunkRing(4, 1024, native=True)
    with pytest.raises(ValueError, match="ports"):
        udp_xdp.XdpReceiver("lo", list(range(17)), native)
    with pytest.raises(ValueError, match="wire_format"):
        udp_xdp.XdpSender("lo", "10.99.0.1", "10.99.0.2", 5002, wire_format="spead2")
    native.close()


def test_fail_detail_names_the_stage():
    """A create that fails reports the stage and errno (no such interface)."""
    ring = ChunkRing(4, 1024, native=True)
    try:
        with pytest.raises(OSError, match="stage=frame-size/ifindex"):
            udp_xdp.XdpReceiver("dcstxdp-none", 5002, ring)
        assert udp_xdp._fail_detail(udp_xdp.load_native()).startswith("stage=frame-size/ifindex")
    finally:
        ring.close()


def test_engine_node_fed_over_af_xdp_matches_its_engine(fabric):
    """A CPU EngineNode takes its ADC heaps off the veth through an
    ``XdpReceiver`` on ``attach_ingest``, reassembled straight into its
    native ring: each chunk's beams equal the node's engine step on that
    chunk, and no heap is evicted or dropped."""
    import asyncio

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

    a, b = fabric
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=4)
    out = {}
    node = EngineNode(cfg, n_spectra=8, fengine="xla", beam_quant_scale=0.25, device="cpu",
                      on_beams=lambda beams, seq: out.setdefault(seq, np.array(beams)))
    chunks = [np.random.default_rng(s).integers(-64, 64, node.chunk_shape, dtype=np.int8)
              for s in range(3)]
    try:
        rx = node.attach_ingest(udp_xdp.XdpReceiver(b, 5005, node.ring, mtu_payload=3584))
    except OSError as e:
        pytest.skip(f"AF_XDP unavailable: {e}")
    tx = udp_xdp.XdpSender(a, "10.99.0.1", "10.99.0.2", 5005, mtu_payload=3584)

    async def scenario():
        await node.start()
        for seq, adc in enumerate(chunks):
            chunk = Chunk(adc.reshape(-1).view(np.uint8), seq=seq)
            deadline = time.monotonic() + 30
            while seq not in out and time.monotonic() < deadline:
                if rx.stats()["heaps"] <= seq:
                    tx.send_chunk(chunk)  # delivery-gated resend
                await asyncio.sleep(0.25)
        return rx.stats()  # before node.stop() stops the receiver

    loop = asyncio.new_event_loop()
    try:
        st = loop.run_until_complete(asyncio.wait_for(scenario(), 240))
    finally:
        tx.close()
        loop.run_until_complete(node.stop())
        loop.close()
    assert sorted(out) == [0, 1, 2]
    assert st["heaps"] == 3 and st["ring_drops"] == st["evicted"] == 0
    zi, zf = np.zeros(cfg.n_ants, np.int32), np.zeros(cfg.n_ants, np.float32)
    for seq, adc in enumerate(chunks):
        np.testing.assert_array_equal(out[seq], node.fb.step(adc, zi, zf, zf).numpy())
