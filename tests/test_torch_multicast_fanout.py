"""Wire-level channel-slice fan-out over multicast on the port (counterpart of ``tests/test_multicast_fanout.py``).

The F stage fans channelised voltages out over per-slice multicast groups
and each B-engine subscribes to exactly the groups whose channels it owns,
steering with the absolute channel offset (ibverbs_rx.c:207-210;
coeff_generator.py:49-53). The reference's cases on the port's UDP
transport and ``BeamformPipeline`` on the CPU, on groups of their own
(``239.102.24.x``; the JAX tests use ``239.102.23.x``), each slice's beams
held against the JAX ``BeamformPipeline`` on the same slice with the
reference test's tolerance (rtol 1e-4 / atol 1e-2); and the port's fan-out
demo.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import BeamformPipeline as JBeamformPipeline
from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models import BeamformPipeline
from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, UdpReceiver, UdpSender

CFG = ArrayConfig(n_ants=4, n_channels=64, n_beams=2, n_batches=1)
GROUP_BASE = "239.102.24.{}"


@pytest.fixture(autouse=True)
def _multicast():
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        s.sendto(b"x", (GROUP_BASE.format(250), 9))
        s.close()
    except OSError as e:
        pytest.skip(f"multicast loopback unavailable: {e}")


def _slice_bytes():
    return (CFG.n_batches * CFG.n_ants * CFG.n_channels_per_stream
            * CFG.n_samples_per_channel * CFG.n_pols * 2)


def _slice_payload(samples, xeng_id):
    cps = CFG.n_channels_per_stream
    return np.ascontiguousarray(samples[:, :, xeng_id * cps : (xeng_id + 1) * cps])


def _fanout_sender(dests):
    """Each channel slice to its own multicast group (one heap a slice)."""
    rng = np.random.default_rng(2021)
    samples = rng.integers(-128, 127, size=(
        CFG.n_batches, CFG.n_ants, CFG.n_channels,
        CFG.n_samples_per_channel, CFG.n_pols, 2), dtype=np.int8)
    for xeng_id, dest in dests.items():
        tx = UdpSender(dest, mtu_payload=2048)
        tx.send_chunk(Chunk(_slice_payload(samples, xeng_id).view(np.uint8).ravel(),
                            seq=xeng_id, timestamp=12345,
                            channel_offset=CFG.channel_offset(xeng_id)))
        tx.close()
    return samples


def _drain(ring, n_chunks, timeout_s=8.0):
    got = []
    deadline = time.time() + timeout_s
    while len(got) < n_chunks and time.time() < deadline:
        item = ring.acquire_read()
        if item is None:
            time.sleep(0.01)
            continue
        view, seq = item
        c = UdpReceiver.unpack(view)
        got.append((seq, int(c.timestamp), int(c.channel_offset), np.array(c.payload)))
        ring.release_read()
    return got


def test_multigroup_join_single_socket():
    """One engine subscribing to several multicast streams on one socket
    receives every slice it owns (the ibverbs_rx.c:207-210 pattern)."""
    ring = ChunkRing(8, _slice_bytes() + 16)
    groups = [GROUP_BASE.format(10), GROUP_BASE.format(11)]
    rx = UdpReceiver(("", 0), ring, mtu_payload=2048, group=groups).start()
    try:
        assert rx.groups == groups
        samples = _fanout_sender({0: (groups[0], rx.port), 1: (groups[1], rx.port)})
        got = _drain(ring, 2)
        assert len(got) == 2, f"received {len(got)}/2 slices"
        by_offset = {off: pay for _, _, off, pay in got}
        cps = CFG.n_channels_per_stream
        assert set(by_offset) == {0, cps}
        for xeng_id in (0, 1):
            want = _slice_payload(samples, xeng_id).view(np.uint8).ravel()
            np.testing.assert_array_equal(by_offset[xeng_id * cps], want)
    finally:
        rx.stop()


def test_channel_slice_fanout_two_nodes():
    """Two subscriber nodes, each joined to its own group, each beamform only
    their slice with the right absolute-channel steering, as the JAX
    pipeline of the same xeng_id does."""
    nodes = {}
    for xeng_id in (0, 1):
        grp = GROUP_BASE.format(20 + xeng_id)
        ring = ChunkRing(8, _slice_bytes() + 16)
        # Bound to the group address itself: kernel-level stream isolation.
        rx = UdpReceiver((grp, 0), ring, mtu_payload=2048, group=grp).start()
        nodes[xeng_id] = (grp, ring, rx, BeamformPipeline(CFG, xeng_id=xeng_id, device="cpu"))
    try:
        samples = _fanout_sender({k: (nodes[k][0], nodes[k][2].port) for k in nodes})
        rng = np.random.default_rng(7)
        dv = np.zeros(CFG.delay_vals_shape, np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        jcfg = JArrayConfig(**dataclasses.asdict(CFG))
        for xeng_id, (grp, ring, rx, pipe) in nodes.items():
            got = _drain(ring, 1)
            assert len(got) == 1, f"node {xeng_id}: no heap"
            seq, ts, offset, payload = got[0]
            assert (seq, ts, offset) == (xeng_id, 12345, CFG.channel_offset(xeng_id))
            ingest = payload.view(np.int8).reshape(CFG.ingest_shape)
            got_beams = pipe(ingest, dv).numpy()
            local = _slice_payload(samples, xeng_id)
            np.testing.assert_array_equal(got_beams, pipe(local, dv).numpy())
            want = np.asarray(JBeamformPipeline(jcfg, xeng_id=xeng_id)(local, dv))
            np.testing.assert_allclose(got_beams, want, rtol=1e-4, atol=1e-2)
        ingest0 = _slice_payload(samples, 0)
        assert not np.array_equal(nodes[0][3](ingest0, dv).numpy(),
                                  nodes[1][3](ingest0, dv).numpy())
    finally:
        for _, _, rx, _ in nodes.values():
            rx.stop()


def test_fanout_demo_runs_on_the_cpu(capsys):
    from dpdk_dc_sand_tpu_torch.examples import channel_slice_fanout_demo as demo

    assert all(g.startswith("239.102.41.") for g in demo.GROUPS.values())
    out = demo.main(["--cpu"])
    cps = CFG.n_channels_per_stream
    assert sorted(off for _, off, _ in out["covered"]) == [0, cps]
    assert all(shape == CFG.beam_shape for _, _, shape in out["covered"])
    assert out["stats"]["n"] == 2 * -(-_slice_bytes() // 2048)
    text = capsys.readouterr().out
    assert "combined spectrum coverage: 2 slices" in text and "capture jitter stats" in text
