"""The port's host streaming layer vs the JAX package's.

Same inputs through both packages, exact comparison throughout (these are
byte codecs and counters: tolerance 0):

- SPEAD-lite and SPEAD-64-48 packets byte-identical to the JAX codecs
  (which use their native packetizer where it loads), with parse and
  reassembly round-trips, cross-fed between the packages;
- ring wrap, drop and consumed counts equal to the JAX ring with
  ``native=False`` over seeded random op sequences;
- ``DeviceFeed`` loss and malformed accounting equal to the JAX feed's on
  the same ring traffic (the port's feed on the CPU);
- rate reports, beam and visibility egress payloads equal;
- UDP loopback between the packages in both directions and both formats.

Every wait carries its own deadline and every receiver, feed and ring is
stopped in a ``finally``.
"""

import queue
import time

import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.golden.requant import requantise as j_requantise
from dpdk_dc_sand_tpu.stream import chunk as j_chunk
from dpdk_dc_sand_tpu.stream import feed as j_feed
from dpdk_dc_sand_tpu.stream import ring as j_ring
from dpdk_dc_sand_tpu.stream import spead as j_spead
from dpdk_dc_sand_tpu.stream import spead64 as j_spead64
from dpdk_dc_sand_tpu.stream import udp as j_udp
from dpdk_dc_sand_tpu_torch.stream import chunk, feed, ring, spead, spead64, udp


def _fields(header):
    return None if header is None else header.__dict__


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ----------------------------------------------------------------------
# Codecs
# ----------------------------------------------------------------------
SIZES = [0, 1, 4095, 4096, 4097, 3 * 4096 + 17]


@pytest.mark.parametrize("nbytes", SIZES)
@pytest.mark.parametrize("mtu", [4096, 1000])
def test_spead_lite_packets_are_byte_identical(nbytes, mtu):
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    kw = dict(heap_id=nbytes + 5, timestamp=123456789, channel_offset=1024, mtu_payload=mtu)
    got = spead.packetize(payload, **kw)
    assert got == j_spead.packetize(payload, **kw)
    for pkt in got:
        assert _fields(spead.parse_header(pkt)) == _fields(j_spead.parse_header(pkt))
    asm = spead.HeapAssembler(mtu_payload=mtu)
    out = [c for c in (asm.feed(p) for p in got[::-1]) if c is not None]
    assert len(out) == 1 and out[0].seq == nbytes + 5
    assert out[0].timestamp == 123456789 and out[0].channel_offset == 1024
    np.testing.assert_array_equal(out[0].payload, payload)


@pytest.mark.parametrize("nbytes", SIZES)
def test_spead64_packets_are_byte_identical(nbytes):
    payload = np.random.default_rng(nbytes + 1).integers(0, 256, nbytes, dtype=np.uint8)
    kw = dict(heap_cnt=(1 << 40) + nbytes, timestamp=(1 << 47) + 3, channel_offset=4096)
    got = spead64.packetize64(payload, **kw)
    assert got == j_spead64.packetize64(payload, **kw)
    assert spead64.stream_stop_packet() == j_spead64.stream_stop_packet()
    for pkt in got:
        assert _fields(spead64.parse_packet64(pkt)) == _fields(j_spead64.parse_packet64(pkt))
    # Reordered and duplicated packets: the same heaps out of both assemblers.
    order = np.random.default_rng(nbytes).permutation(len(got))
    outs = []
    for asm in (spead64.Heap64Assembler(), j_spead64.Heap64Assembler()):
        out = [c for c in (asm.feed(got[i]) for i in [*order, order[-1]]) if c is not None]
        assert out[0].seq == kw["heap_cnt"]
        np.testing.assert_array_equal(out[0].payload, payload)
        outs.append([(c.seq, c.timestamp, c.channel_offset, c.payload.tobytes()) for c in out])
    assert outs[0] == outs[1]


def test_parsers_reject_the_same_foreign_packets():
    good = spead.packetize(np.arange(10, dtype=np.uint8), heap_id=1)[0]
    for pkt in (b"", b"\x00" * 39, b"\xde\xad\xbe\xef" * 10, good[:-1], b"S\x04\x08\x05" + b"\0" * 4):
        assert _fields(spead.parse_header(pkt)) == _fields(j_spead.parse_header(pkt))
        assert (spead64.parse_packet64(pkt) is None) == (j_spead64.parse_packet64(pkt) is None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assembler_loss_accounting_matches(seed):
    """Heaps with dropped packets and shuffled arrival: the same completed
    seqs, heap-id gaps and evictions in both packages."""
    rng = np.random.default_rng(seed)
    packets = []
    for heap in range(20):
        pkts = spead.packetize(rng.integers(0, 256, 9000, dtype=np.uint8), heap_id=heap)
        if rng.random() < 0.3:
            pkts = pkts[:-1]  # one packet lost: the heap never completes
        packets += pkts
    packets += [b"garbage"] * 3
    order = np.argsort(np.arange(len(packets)) + rng.integers(0, 6, len(packets)), kind="stable")
    port, ref = spead.HeapAssembler(window=4), j_spead.HeapAssembler(window=4)
    got = [c.seq for c in (port.feed(packets[i]) for i in order) if c is not None]
    want = [c.seq for c in (ref.feed(packets[i]) for i in order) if c is not None]
    assert got == want
    assert port.stats.__dict__ == ref.stats.__dict__
    assert port.incomplete_dropped == ref.incomplete_dropped


def test_fill_and_check_pattern_match():
    for n, cid in [(1, 3), (4096, 7), (1000, 0)]:
        np.testing.assert_array_equal(spead.fill_pattern(n, cid, counter=9),
                                      j_spead.fill_pattern(n, cid, counter=9))
        words = spead.fill_pattern(n, cid)
        words[n // 2] ^= 1
        assert spead.check_pattern(words, cid) == j_spead.check_pattern(words, cid)


def test_stream_stats_observe_matches():
    port, ref = chunk.StreamStats(), j_chunk.StreamStats()
    for seq in [0, 1, 4, 3, 9, 10, 10, 2]:
        port.observe(seq, 100 + seq)
        ref.observe(seq, 100 + seq)
        assert port.__dict__ == ref.__dict__


# ----------------------------------------------------------------------
# Ring
# ----------------------------------------------------------------------
def _ring_ops(r, ops, slot_bytes):
    """Apply an op script; return what each op observed."""
    seen = []
    for op, seq, n in ops:
        if op == "put":
            seen.append(("put", r.put(np.full(n, seq % 256, np.uint8), seq)))
        elif op == "write":
            buf = r.acquire_write()
            if buf is None:
                r.count_drop()
                seen.append(("write", None))
            else:
                buf[:n] = seq % 256
                r.commit_write(n, seq)
                seen.append(("write", True))
        else:
            item = r.acquire_read()
            if item is None:
                seen.append(("read", None))
            else:
                view, s = item
                seen.append(("read", s, view.nbytes, bytes(view[:4])))
                r.release_read()
        seen.append(("state", len(r), r.stats()))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_counts_match_the_reference_ring(seed):
    rng = np.random.default_rng(seed)
    slot = 256
    ops = [
        (("put", "write", "read")[rng.integers(0, 3)], int(s), int(rng.integers(1, slot + 40)))
        for s in range(200)
    ]
    port = ring.ChunkRing(5, slot)
    ref = j_ring.ChunkRing(5, slot, native=False)
    assert _ring_ops(port, ops, slot) == _ring_ops(ref, ops, slot)


def test_ring_zero_copy_write_and_wrap():
    r = ring.ChunkRing(2, 64)
    for seq in range(5):  # wraps twice
        buf = r.acquire_write()
        buf[:8] = np.arange(seq, seq + 8, dtype=np.uint8)
        r.commit_write(8, seq)
        view, got = r.acquire_read()
        assert got == seq
        np.testing.assert_array_equal(view, np.arange(seq, seq + 8, dtype=np.uint8))
        r.release_read()
    assert r.stats() == (5, 5, 0)


def test_pinned_ring_needs_a_card():
    if torch.cuda.is_available():
        r = ring.ChunkRing(2, 64, pinned=True)
        assert r._pinned.is_pinned()
    else:
        with pytest.raises(RuntimeError):
            ring.ChunkRing(2, 64, pinned=True)


# ----------------------------------------------------------------------
# Feed
# ----------------------------------------------------------------------
def _feed_scenario(ring_cls, feed_cls, **feed_kw):
    """Chunks with gaps and a malformed one through a feed; its stats."""
    r = ring_cls(8, 512)
    f = feed_cls(r, reshape=lambda b: b.view(np.int8).reshape(-1, 64), **feed_kw).start()
    got = []
    try:
        for seq, n in [(0, 512), (1, 512), (4, 512), (5, 100), (6, 512), (9, 256)]:
            assert r.put(np.full(n, seq, np.uint8), seq)
        deadline = time.monotonic() + 10
        while len(got) < 5 and time.monotonic() < deadline:
            try:
                arr, seq = f.get(timeout=0.2)
            except queue.Empty:
                continue
            got.append((seq, tuple(arr.shape), int(np.asarray(arr).ravel()[0])))
        assert _wait(lambda: f.stats.malformed == 1)
        return got, dict(f.stats.__dict__)
    finally:
        f.stop()
        r.close()


def test_device_feed_accounting_matches_reference():
    got, stats = _feed_scenario(ring.ChunkRing, feed.DeviceFeed, device="cpu")
    want, want_stats = _feed_scenario(
        lambda n, b: j_ring.ChunkRing(n, b, native=False), j_feed.DeviceFeed
    )
    assert got == want == [(0, (8, 64), 0), (1, (8, 64), 1), (4, (8, 64), 4),
                           (6, (8, 64), 6), (9, (4, 64), 9)]
    assert stats == want_stats
    assert stats["lost"] == 5 and stats["malformed"] == 1


def test_device_feed_copies_out_of_the_slot_on_the_cpu():
    r = ring.ChunkRing(2, 64)
    f = feed.DeviceFeed(r, device="cpu").start()
    try:
        r.put(np.full(64, 3, np.uint8), 0)
        arr, _ = f.get(timeout=5)
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
        assert _wait(lambda: len(r) == 0)
        r.put(np.full(64, 4, np.uint8), 1)  # reuses a slot...
        r.put(np.full(64, 5, np.uint8), 2)
        assert int(arr[0]) == 3  # ...which the delivered tensor does not alias
        assert f.pinned_copies == 0 and not f.h2d_log
    finally:
        f.stop()


def test_device_feed_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert feed.DeviceFeed(ring.ChunkRing(2, 8)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            feed.DeviceFeed(ring.ChunkRing(2, 8))


def test_rate_reporter_lines_match():
    lines, jlines = [], []
    t = [0.0]
    port = feed.RateReporter(1.0, lines.append, clock=lambda: t[0])
    ref = j_feed.RateReporter(1.0, jlines.append, clock=lambda: t[0])
    for step, nbytes in enumerate([1000, 500, 70000, 3, 1 << 20]):
        t[0] = 0.7 * step
        port.account(nbytes)
        ref.account(nbytes)
    assert lines == jlines and len(lines) == 2


class _Sink:
    def __init__(self):
        self.sent = []

    def send_chunk(self, c):
        self.sent.append(c)


def test_requantise_matches_golden():
    rng = np.random.default_rng(5)
    x = rng.normal(scale=300, size=(3, 5, 4)).astype(np.float32)
    x[0, 0, :2] = [0.5, 1.5]  # round half to even
    np.testing.assert_array_equal(feed.requantise(x, 0.5), j_requantise(x, 0.5))
    z = x + 1j * x[::-1]
    np.testing.assert_array_equal(feed.requantise(z, 0.25), j_requantise(z, 0.25))


@pytest.mark.parametrize("scale", [0.5, None])
def test_beam_egress_payload_matches(scale):
    rng = np.random.default_rng(3)
    beams = rng.normal(scale=100, size=(2, 8, 4, 2, 2)).astype(np.float32)
    if scale is None:
        beams = j_requantise(beams, 0.25)
    port, ref = _Sink(), _Sink()
    feed.UdpBeamEgress(port, 4096, scale)(beams, seq=3)
    j_feed.UdpBeamEgress(ref, 4096, scale)(beams, seq=3)
    (p,), (r,) = port.sent, ref.sent
    assert (p.seq, p.timestamp, p.channel_offset) == (r.seq, r.timestamp, r.channel_offset)
    np.testing.assert_array_equal(p.payload, r.payload)
    if scale is None:
        with pytest.raises(TypeError):
            feed.UdpBeamEgress(_Sink(), 16, None)(beams.astype(np.float32), seq=4)


def test_vis_egress_payload_matches():
    rng = np.random.default_rng(4)
    vr, vi = (rng.normal(size=(8, 4, 4)).astype(np.float32) for _ in range(2))
    port, ref = _Sink(), _Sink()
    feed.UdpVisEgress(port, 512)(vr, vi, 6)
    j_feed.UdpVisEgress(ref, 512)(vr, vi, 6)
    assert (port.sent[0].seq, port.sent[0].timestamp) == (ref.sent[0].seq, ref.sent[0].timestamp)
    np.testing.assert_array_equal(port.sent[0].payload, ref.sent[0].payload)


# ----------------------------------------------------------------------
# UDP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("wire_format", ["lite", "spead64"])
@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax", "jax_to_port"])
def test_udp_loopback_between_the_packages(wire_format, direction):
    tx_mod = j_udp if direction == "jax_to_port" else udp
    rx_mod = j_udp if direction == "port_to_jax" else udp
    rx_ring = (j_ring.ChunkRing(8, 20000, native=False) if rx_mod is j_udp
               else ring.ChunkRing(8, 20000))
    rx = rx_mod.UdpReceiver(("127.0.0.1", 0), rx_ring).start()
    tx = tx_mod.UdpSender(("127.0.0.1", rx.port), wire_format=wire_format)
    try:
        rng = np.random.default_rng(11)
        sent = [rng.integers(0, 256, 9000 + 7 * s, dtype=np.uint8) for s in range(3)]
        for seq, payload in enumerate(sent):
            tx.send_chunk(chunk.Chunk(payload, seq=seq, timestamp=seq * 100,
                                      channel_offset=seq + 1))
        assert _wait(lambda: len(rx_ring) == 3), f"{len(rx_ring)} of 3 heaps arrived"
        for seq, payload in enumerate(sent):
            view, got_seq = rx_ring.acquire_read()
            c = rx_mod.UdpReceiver.unpack(view)
            assert got_seq == seq and c.timestamp == seq * 100 and c.channel_offset == seq + 1
            np.testing.assert_array_equal(c.payload, payload)
            rx_ring.release_read()
        assert tx.sent_packets == 3 * 3
    finally:
        tx.close()
        rx.stop()
        rx_ring.close()


def test_paced_sender_spreads_a_heap_over_its_rate():
    """``rate_gbps`` holds the average rate (the last burst of at most 1 ms
    leaves unpaced), and the heap arrives whole."""
    rx_ring = ring.ChunkRing(2, (1 << 20) + 64)
    rx = udp.UdpReceiver(("127.0.0.1", 0), rx_ring).start()
    tx = udp.UdpSender(("127.0.0.1", rx.port), rate_gbps=0.4)
    try:
        payload = np.random.default_rng(12).integers(0, 256, 1 << 20, dtype=np.uint8)
        t0 = time.perf_counter()
        tx.send_chunk(chunk.Chunk(payload, seq=0))
        assert time.perf_counter() - t0 >= tx.sent_bytes * 8 / 0.4e9 - 1e-3
        assert _wait(lambda: len(rx_ring) == 1)
        view, seq = rx_ring.acquire_read()
        np.testing.assert_array_equal(udp.UdpReceiver.unpack(view).payload, payload)
    finally:
        tx.close()
        rx.stop()


def test_streaming_demo_runs_on_the_cpu(capsys):
    """The port's transport demo (its waits carry their own deadlines)."""
    from dpdk_dc_sand_tpu_torch.examples import streaming_demo

    assert streaming_demo.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "received seqs: [0, 1, 2, 3, 4, 5, 6, 7, 9]" in out and "OK:" in out
