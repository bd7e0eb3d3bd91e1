"""Full-instrument demo: digitiser → UDP → EngineNode → UDP beam egress.

Counterpart of ``examples/full_instrument_demo.py``: the complete
production vertical through the public API, on one host with tiny geometry:

  fake digitiser ──SPEAD-lite UDP──▶ EngineNode
      (ADC chunks)                   ├─ ring → DeviceFeed (copy stream)
                                     ├─ F+B step on the card
                                     ├─ KATCP-style control + sensors
                                     └─SPEAD-lite UDP─▶ beam consumer

Control-plane actions exercised live: ?delay-model (validated against the
node's delay budget), ?beam-delays with a nonzero phase rate (the beams
rotate as time advances via the 256-step extrapolation cadence),
?sensor-value for drop/rate accounting.

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.full_instrument_demo [--cpu]``
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.control import Client
from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing
from dpdk_dc_sand_tpu_torch.stream.udp import UdpReceiver, UdpSender


async def run(device=None) -> None:
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=4)
    node = EngineNode(cfg, n_spectra=8, margin=32, beam_quant_scale=0.25, device=device)
    beam_ring = ChunkRing(16, 1 << 20)
    beam_rx = adc_rx = tx = client = None
    await node.start()
    try:
        # Beam consumer: SPEAD-lite heaps of int8 beams into a ring.
        beam_rx = UdpReceiver(("127.0.0.1", 0), beam_ring).start()
        node.attach_udp_egress(("127.0.0.1", beam_rx.port))

        # Sample ingest over UDP (heap ids become chunk sequence numbers).
        adc_rx = node.attach_udp_ingest(("127.0.0.1", 0))
        tx = UdpSender(("127.0.0.1", adc_rx.port))

        # Control plane: steering with a phase rate, delays inside the budget.
        client = await Client("127.0.0.1", node.port).connect()
        dm = [2.0, 0.25, -np.pi * 0.25 / 2, 0.0] * cfg.n_ants
        await client.request("delay-model", *dm)
        beam_poly = []
        for _ in range(cfg.n_ants):
            beam_poly += [0.0, 0.0, 0.5, 0.8]  # phase 0.5 rad, rate 0.8 rad/s
        await client.request("beam-delays", 0, *beam_poly)

        # Digitiser: deterministic noise chunks at a steady cadence.
        rng = np.random.default_rng(7)
        for seq in range(12):
            adc = rng.integers(-64, 64, size=node.chunk_shape, dtype=np.int8)
            tx.send_chunk(Chunk(payload=adc.ravel().view(np.uint8), seq=seq,
                                timestamp=seq * node.fb.samples_in))
            await asyncio.sleep(0.05)

        # Drain beams and show them landing.
        got = 0
        deadline = time.monotonic() + 20
        while got < 8 and time.monotonic() < deadline:
            r = beam_ring.acquire_read()
            if r is None:
                await asyncio.sleep(0.02)
                continue
            view, seq = r
            beams = UdpReceiver.unpack(view)
            print(f"beam heap seq={seq} bytes={beams.payload.nbytes}")
            beam_ring.release_read()
            got += 1
        if got < 8:
            raise AssertionError("no beams reached the consumer")

        _, informs = await client.request("sensor-value", "chunks-processed")
        print("chunks-processed:", informs[0].args[4])
        _, informs = await client.request("sensor-value", "ingest-rate-gbps")
        print("ingest-rate-gbps:", informs[0].args[4])
        _, informs = await client.request("sensor-value", "device-status")
        if informs[0].args[4] != "ok":
            raise AssertionError(f"device-status {informs[0].args[4]}")
    finally:
        if client is not None:
            await client.close()
        if tx is not None:
            tx.close()
        await node.stop()
        if beam_rx is not None:
            beam_rx.stop()
        beam_ring.close()
    print(f"full instrument vertical on {node.device}: OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run the node on the CPU")
    args = ap.parse_args(argv)
    asyncio.run(run("cpu" if args.cpu else None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
