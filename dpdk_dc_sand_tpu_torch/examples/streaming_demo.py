"""End-to-end transport demo (counterpart of ``examples/streaming_demo.py``).

Pattern chunks -> SPEAD-lite UDP -> receiver reassembly -> ChunkRing ->
DeviceFeed -> device tensors, with drop stats. Plus probes: a deliberately
lost packet and a corrupted datagram. On the card the ring is page-locked
and the feed copies each chunk on its own stream.

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.streaming_demo [--cpu]``
"""

from __future__ import annotations

import argparse
import queue
import time

import numpy as np

from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, UdpReceiver, UdpSender
from dpdk_dc_sand_tpu_torch.stream.feed import DeviceFeed, RateReporter
from dpdk_dc_sand_tpu_torch.stream.spead import check_pattern, fill_pattern, packetize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="feed the CPU instead of the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    ring = ChunkRing(32, 70000, pinned=device.type == "cuda")
    lines = []
    rx = UdpReceiver(("127.0.0.1", 0), ring).start()
    tx = UdpSender(("127.0.0.1", rx.port), reporter=RateReporter(0.1, lines.append))
    feed = DeviceFeed(ring, reshape=lambda b: b[16:], device=device).start()
    try:
        for seq in range(8):
            words = fill_pattern(4096, seq, counter=seq)
            tx.send_chunk(Chunk(words.view(np.uint8), seq=seq, timestamp=seq * 4096))
            time.sleep(0.01)

        # probe 1: drop one packet of heap 8 on purpose (simulate loss)
        pkts = packetize(fill_pattern(4096, 8).view(np.uint8), heap_id=8)
        for p in pkts[:-1]:
            tx.sock.sendto(p, tx.dest)
        # probe 2: corrupted garbage datagram
        tx.sock.sendto(b"\xde\xad\xbe\xef" * 10, tx.dest)
        # heap 9 complete again
        tx.send_chunk(Chunk(fill_pattern(4096, 9).view(np.uint8), seq=9))

        got, n_ok = [], 0
        deadline = time.monotonic() + 10
        while len(got) < 9 and time.monotonic() < deadline:
            try:
                arr, seq = feed.get(timeout=0.5)
            except queue.Empty:
                continue
            got.append(seq)
            if seq <= 7:
                words = arr.cpu().numpy().view(np.uint64)
                if check_pattern(words, seq):
                    raise AssertionError(f"pattern corrupt in chunk {seq}")
                n_ok += 1

        print("device:", device)
        print("received seqs:", got)
        print("pattern-verified chunks:", n_ok)
        print("assembler stats: lost heaps =", rx.assembler.stats.lost,
              "| consumer-side seq gaps (feed) =", feed.stats.lost)
        print("rate report sample:", lines[0] if lines else "(interval not hit)")
        if got != [0, 1, 2, 3, 4, 5, 6, 7, 9]:
            raise AssertionError(got)
        if feed.stats.lost != 1:  # heap 8 never completed -> gap seen at feed
            raise AssertionError(f"feed saw {feed.stats.lost} lost chunks, want 1")
    finally:
        tx.close()
        rx.stop()
        feed.stop()
        ring.close()
    print("OK: end-to-end UDP->ring->device chain with loss accounting")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
