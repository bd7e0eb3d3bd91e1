"""The port's packet latency/jitter tool (``stream/latency.py``) vs the JAX package's.

Every case of ``tests/test_latency.py`` on the port, and on the same
captures (made from a seed, in both wire formats, with garbage packets
mixed in) the port's pcap bytes, extracted timestamps, stats and CLI output
equal the JAX package's.
"""

import json

import numpy as np
import pytest

from dpdk_dc_sand_tpu.stream import latency as j_latency
from dpdk_dc_sand_tpu_torch.stream import latency
from dpdk_dc_sand_tpu_torch.stream.latency import extract_timestamps, latency_stats, plot_latency
from dpdk_dc_sand_tpu_torch.stream.spead import packetize
from dpdk_dc_sand_tpu_torch.stream.spead64 import packetize64, stream_stop_packet

ADC_RATE = 1712e6


def _capture(jitter_us, wire="lite", n=200, seed=7):
    """A capture: heaps at a steady ADC cadence plus a known jitter."""
    rng = np.random.default_rng(seed)
    captures = []
    samples_per_heap = 4096
    t0 = 100.0
    pack = packetize if wire == "lite" else (
        lambda p, heap_id, timestamp: packetize64(p, heap_cnt=heap_id, timestamp=timestamp))
    for i in range(n):
        adc_ts = i * samples_per_heap
        true_time = t0 + adc_ts / ADC_RATE
        jitter = rng.normal(scale=jitter_us * 1e-6)
        pkt = pack(np.zeros(64, np.uint8), heap_id=i, timestamp=adc_ts)[0]
        captures.append((true_time + jitter, pkt))
    return captures


def test_extract_skips_garbage():
    caps = _capture(1.0)
    caps.insert(5, (123.0, b"not a packet"))
    recs = extract_timestamps(caps)
    assert recs.shape == (200, 2)
    assert recs[0, 1] == 0
    assert recs[-1, 1] == 199 * 4096


def test_stats_recover_injected_jitter():
    stats = latency_stats(extract_timestamps(_capture(5.0)), ADC_RATE)
    assert stats["n"] == 200
    assert 3.0 < stats["jitter_std_us"] < 7.0  # within 40% of the injected 5 us
    assert stats["jitter_p2p_us"] >= stats["jitter_std_us"]


def test_zero_jitter_is_flat():
    assert latency_stats(extract_timestamps(_capture(0.0)), ADC_RATE)["jitter_p2p_us"] < 0.5


def test_empty_capture():
    assert latency_stats(np.zeros((0, 2)))["n"] == 0 == j_latency.latency_stats(np.zeros((0, 2)))["n"]


def test_plot_writes_file(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "jitter.png"
    plot_latency(extract_timestamps(_capture(2.0)), ADC_RATE, str(out))
    assert out.exists() and out.stat().st_size > 1000


@pytest.mark.parametrize("wire", ["lite", "spead64"])
@pytest.mark.parametrize("add_headers", [True, False])
def test_pcap_timestamps_and_stats_equal_the_jax_tool(tmp_path, wire, add_headers):
    caps = _capture(3.0, wire, n=64, seed=11)
    caps.insert(3, (101.0, b"garbage" * 9))
    caps.insert(9, (101.5, stream_stop_packet()))
    port, jax = tmp_path / "port.pcap", tmp_path / "jax.pcap"
    assert latency.write_pcap(str(port), caps, add_headers) == len(caps)
    assert j_latency.write_pcap(str(jax), caps, add_headers) == len(caps)
    assert port.read_bytes() == jax.read_bytes()
    got = list(latency.read_pcap(str(port), strip_headers=add_headers))
    assert got == list(j_latency.read_pcap(str(jax), strip_headers=add_headers))
    assert [p for _, p in got] == [p for _, p in caps]
    recs = extract_timestamps(got)
    np.testing.assert_array_equal(recs, j_latency.extract_timestamps(got))
    assert recs.shape == (64, 2)  # the garbage and the stream-control packet skipped
    assert latency_stats(recs, ADC_RATE) == j_latency.latency_stats(recs, ADC_RATE)
    assert [latency.packet_timestamp(p) for _, p in caps] == [
        j_latency.packet_timestamp(p) for _, p in caps]


def test_read_pcap_big_endian_microseconds_and_bad_magic(tmp_path):
    import struct

    path = tmp_path / "be.pcap"
    pkt = packetize(np.arange(16, dtype=np.uint8), heap_id=1, timestamp=4096)[0]
    with open(path, "wb") as f:
        f.write(struct.pack(">IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
        f.write(struct.pack(">IIII", 7, 250000, len(pkt), len(pkt)) + pkt)
    got = list(latency.read_pcap(str(path), strip_headers=False))
    assert got == list(j_latency.read_pcap(str(path), strip_headers=False)) == [(7.25, pkt)]
    (tmp_path / "bad.pcap").write_bytes(b"\0" * 24)
    with pytest.raises(ValueError, match="not a classic pcap"):
        list(latency.read_pcap(str(tmp_path / "bad.pcap")))


def test_cli_writes_the_same_npz_and_stats(tmp_path, capsys):
    cap = tmp_path / "cap.pcap"
    latency.write_pcap(str(cap), _capture(2.0, "spead64", n=32))
    outs = []
    for mod, name in ((latency, "port.npz"), (j_latency, "jax.npz")):
        assert mod._main([str(cap), str(tmp_path / name)]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["n"] == 32
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    for key in ("pkt_timestamps", "adc_timestamps"):
        np.testing.assert_array_equal(a[key], b[key])
