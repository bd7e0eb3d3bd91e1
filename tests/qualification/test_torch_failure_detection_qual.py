"""Failure-detection qualification on the port (features/failure_detection.feature).

The scenarios of ``test_failure_detection_qual.py`` on the port's
``EngineNode`` with ``device="cpu"``: a step failure degrades the
device-status sensor without killing the node, sequence gaps raise the
lost counter, and a malformed chunk is rejected with accounting instead of
crashing the ingest thread. Every wait has a deadline (30 s, as in the JAX
scenarios), never a wall-clock assertion.
"""

import asyncio
import time

import numpy as np

from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

CFG = ArrayConfig(n_ants=2, n_channels=128, n_beams=2, n_taps=4)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120.0))
    finally:
        loop.close()


def _node(**kw):
    return EngineNode(CFG, n_spectra=4, device="cpu", **kw)


def _make_chunk(node, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, node.chunk_shape, dtype=np.int8)


async def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.05)
    return False


def test_step_failure_degrades_not_kills(report):
    async def scenario():
        report.step("Given", "a running engine node")
        beams = []
        fail_once = {"armed": True}

        def on_beams(b, seq):
            if fail_once["armed"]:
                fail_once["armed"] = False
                raise RuntimeError("injected pipeline fault")
            beams.append(seq)

        node = _node(on_beams=on_beams)
        await node.start()
        try:
            report.step("When", "a malformed chunk makes a pipeline step raise")
            node.submit_chunk(_make_chunk(node), 0)
            ok = await _wait_for(lambda: node.s_status.value == "degraded")
            report.step("Then", "the node's device-status sensor reports degraded",
                        device_status=str(node.s_status.value))
            assert ok
            node.submit_chunk(_make_chunk(node, 1), 1)
            ok = await _wait_for(lambda: len(beams) >= 1)
            report.step("And", "subsequent valid chunks are still processed",
                        beams_after_fault=len(beams))
            assert ok
        finally:
            await node.stop()

    _run(scenario())


def test_sequence_gap_raises_lost_sensor(report):
    async def scenario():
        report.step("Given", "a running engine node")
        processed = []
        node = _node(on_beams=lambda b, s: processed.append(s))
        await node.start()
        try:
            report.step("When", "chunks arrive with a sequence gap")
            node.submit_chunk(_make_chunk(node), 0)
            node.submit_chunk(_make_chunk(node), 5)  # 4 chunks missing
            ok = await _wait_for(lambda: int(node.s_lost.value) >= 4)
            report.step("Then", "the input-lost sensor counts the missing chunks",
                        lost=int(node.s_lost.value))
            report.detail_entry("lost_chunks", int(node.s_lost.value))
            assert ok and int(node.s_lost.value) == 4
        finally:
            await node.stop()

    _run(scenario())


def test_malformed_chunk_contained(report):
    async def scenario():
        report.step("Given", "a running engine node")
        processed = []
        node = _node(on_beams=lambda b, s: processed.append(s))
        await node.start()
        try:
            report.step("When", "a wrong-sized chunk is submitted")
            node.ring.put(np.zeros(128, np.int8), 0)  # far too small to reshape
            node.submit_chunk(_make_chunk(node), 1)
            ok = await _wait_for(lambda: len(processed) >= 1)
            report.step("Then", "it is rejected with the malformed counter raised",
                        malformed=node.feed.stats.malformed)
            assert node.feed.stats.malformed == 1
            report.step("And", "the ingest thread keeps feeding subsequent valid chunks",
                        processed_after=len(processed))
            assert ok and processed == [1]
        finally:
            await node.stop()

    _run(scenario())
