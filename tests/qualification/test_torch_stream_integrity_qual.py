"""Stream-integrity qualification on the port (features/stream_integrity.feature).

The scenarios of ``test_stream_integrity_qual.py`` on the port's
``stream.spead`` codecs (``packetize``, ``HeapAssembler``,
``fill_pattern`` / ``check_pattern``): bit-exact delivery of the
deterministic payload pattern, loss detection by eviction accounting, and
reorder tolerance. The packets are held byte for byte against the JAX
codec's on the same payload (tolerance 0).
"""

import numpy as np

from dpdk_dc_sand_tpu.stream import packetize as j_packetize
from dpdk_dc_sand_tpu.stream.spead import fill_pattern as j_fill_pattern
from dpdk_dc_sand_tpu_torch.stream import HeapAssembler, packetize
from dpdk_dc_sand_tpu_torch.stream.spead import check_pattern, fill_pattern


def test_pattern_survives_transport(report):
    report.step("Given", "a chunk filled with the deterministic payload pattern", n_words=4096)
    words = fill_pattern(4096, chunk_id=7, counter=3)
    np.testing.assert_array_equal(words, j_fill_pattern(4096, chunk_id=7, counter=3))
    report.step("When", "it is packetized and reassembled")
    packets = packetize(words, heap_id=7, mtu_payload=1024)
    assert [bytes(p) for p in packets] == [
        bytes(p) for p in j_packetize(words, heap_id=7, mtu_payload=1024)]
    asm = HeapAssembler(mtu_payload=1024)
    delivered = [c for c in (asm.feed(p) for p in packets) if c is not None]
    assert len(delivered) == 1
    got = delivered[0].payload.view(np.uint64)
    mismatches = check_pattern(got, chunk_id=7)
    report.step("Then", "the pattern checker reports zero mismatching words",
                mismatching_words=int(mismatches))
    report.detail_entry("payload_bytes", int(got.nbytes))
    assert mismatches == 0
    assert check_pattern(fill_pattern(4096, chunk_id=8), chunk_id=7) > 0


def test_loss_detected_and_accounted(report):
    report.step("Given", "a stream of heaps with one packet dropped in flight")
    asm = HeapAssembler(mtu_payload=1024, window=4)
    payload = np.arange(4096, dtype=np.uint64)
    # Heap 0 loses its second packet; heaps 1..6 complete.
    asm.feed(packetize(payload, heap_id=0, mtu_payload=1024)[0])
    report.step("When", "the stream is reassembled")
    for h in range(1, 7):
        for p in packetize(payload, heap_id=h, mtu_payload=1024):
            asm.feed(p)
    report.step("Then", "the incomplete heap is evicted and counted",
                incomplete_dropped=asm.incomplete_dropped)
    assert asm.incomplete_dropped == 1
    report.step("And", "the consumer's sequence accounting reports the gap",
                heaps_delivered=asm.stats.consumed)
    report.detail_entry("heaps_delivered", asm.stats.consumed)
    assert asm.stats.consumed == 6


def test_reorder_reassembles_exactly(report):
    report.step("Given", "a heap whose packets arrive in reverse order")
    rng = np.random.default_rng(2021)
    payload = rng.integers(0, 2**64, 2048, dtype=np.uint64)
    pkts = packetize(payload, heap_id=3, mtu_payload=1024)
    report.step("When", "the stream is reassembled")
    asm = HeapAssembler(mtu_payload=1024)
    delivered = [c for p in reversed(pkts) if (c := asm.feed(p))]
    assert len(delivered) == 1
    exact = bool(np.array_equal(delivered[0].payload.view(np.uint64), payload))
    report.step("Then", "the delivered payload is bit-identical", bit_exact=exact)
    assert exact
