"""Channel-slice multicast fan-out demo, the wire-level xeng_id model (counterpart of ``examples/channel_slice_fanout_demo.py``).

The deployment topology the reference's transport prototypes exist for
(ibverbs_rx.c:207-210 "subscribe to multiple multicast streams";
coeff_generator.py:49-53 absolute-channel steering), run end to end on
one host over real multicast loopback:

  F-engine product (channelised voltages, synthesized)
    ── real SPEAD-64-48 over per-slice multicast groups ──▶
  N subscriber B-engine nodes, each joined ONLY to its groups,
    each beamforming its slice with xeng_id channel offsets (on the card,
    or the CPU with ``--cpu``)
    └─▶ combined spectrum coverage check + a pcap capture of the
        fan-out analysed for send jitter (packet_latency workflow)

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.channel_slice_fanout_demo [--cpu]``
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models import BeamformPipeline
from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, UdpReceiver, UdpSender
from dpdk_dc_sand_tpu_torch.stream.latency import (
    extract_timestamps,
    latency_stats,
    read_pcap,
    write_pcap,
)
from dpdk_dc_sand_tpu_torch.stream.spead64 import packetize64

CFG = ArrayConfig(n_ants=4, n_channels=64, n_beams=2, n_batches=1)
GROUPS = {0: "239.102.41.1", 1: "239.102.41.2"}
ADC_RATE = 1712e6


def main(argv=None) -> dict:
    """Run the demo; returns ``{"covered": [...], "stats": {...}}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="beamform on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    cps = CFG.n_channels_per_stream
    slice_bytes = (
        CFG.n_batches * CFG.n_ants * cps * CFG.n_samples_per_channel
        * CFG.n_pols * 2
    )

    # Subscriber nodes: each joins its own multicast group (bound to the
    # group address — kernel-level stream isolation) and owns one slice.
    nodes = {}
    for xeng_id, grp in GROUPS.items():
        ring = ChunkRing(8, slice_bytes + 16)
        rx = UdpReceiver((grp, 0), ring, mtu_payload=2048, group=grp).start()
        nodes[xeng_id] = (ring, rx, BeamformPipeline(CFG, xeng_id=xeng_id, device=device))

    try:
        # F-engine product: full band, fanned out per slice as REAL
        # SPEAD-64-48 heaps (spead2-interoperable), timestamped.
        rng = np.random.default_rng(2021)
        samples = rng.integers(-128, 127, size=(
            CFG.n_batches, CFG.n_ants, CFG.n_channels,
            CFG.n_samples_per_channel, CFG.n_pols, 2), dtype=np.int8)
        capture = []
        for xeng_id, grp in GROUPS.items():
            tx = UdpSender(
                (grp, nodes[xeng_id][1].port), mtu_payload=2048,
                wire_format="spead64",
            )
            payload = np.ascontiguousarray(
                samples[:, :, xeng_id * cps : (xeng_id + 1) * cps]
            )
            chunk = Chunk(
                payload.view(np.uint8).ravel(), seq=xeng_id,
                timestamp=4096 * xeng_id, channel_offset=CFG.channel_offset(xeng_id),
            )
            # Passive capture of the same heaps (the tcpdump analog).
            for pkt in packetize64(
                chunk.payload, heap_cnt=chunk.seq, timestamp=chunk.timestamp,
                channel_offset=chunk.channel_offset, mtu_payload=2048,
            ):
                capture.append((time.time(), pkt))
            tx.send_chunk(chunk)
            tx.close()

        # Each node ingests and beamforms ONLY its slice.
        dv = np.zeros(CFG.delay_vals_shape, np.float32)
        covered = []
        for xeng_id, (ring, rx, pipe) in nodes.items():
            got = None
            deadline = time.time() + 8.0
            while got is None and time.time() < deadline:
                item = ring.acquire_read()
                if item is None:
                    time.sleep(0.01)
                    continue
                view, _ = item
                got = UdpReceiver.unpack(view)
                got.payload = got.payload.copy()  # the view ends at release_read
                ring.release_read()
            if got is None:
                raise TimeoutError(f"node {xeng_id}: no heap")
            if got.channel_offset != CFG.channel_offset(xeng_id):
                raise AssertionError(f"node {xeng_id}: channel offset {got.channel_offset}")
            ingest = np.asarray(got.payload).view(np.int8).reshape(CFG.ingest_shape)
            beams = pipe(ingest, dv).cpu().numpy()
            covered.append((xeng_id, got.channel_offset, beams.shape))
            print(
                f"node {xeng_id}: channels [{got.channel_offset}, "
                f"{got.channel_offset + cps}) -> beams {beams.shape}"
            )
    finally:
        for _, rx, _ in nodes.values():
            rx.stop()
    if sorted(off for _, off, _ in covered) != [0, cps]:
        raise AssertionError(f"coverage {covered}")
    print(f"combined spectrum coverage: {len(covered)} slices x {cps} chan")

    # Offline capture analysis (packet_latency workflow) on the fan-out.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fanout_capture.pcap")
        write_pcap(path, capture)
        stats = latency_stats(extract_timestamps(read_pcap(path)), adc_sample_rate=ADC_RATE)
    print("capture jitter stats:", stats)
    return {"covered": covered, "stats": stats}


if __name__ == "__main__":
    main()
