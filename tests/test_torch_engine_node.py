"""The port's EngineNode vs the JAX package's, on the CPU (``device="cpu"``).

Mirrors ``tests/test_engine_node.py`` on the port: chunks become beams;
a delay-model update; rate rotation; capture stop; ring overrun; beam
weights; device-quantised output; visibility egress; UDP ingest → egress;
budget rejection. Where a scenario has an output, the same chunks and the
same control requests go through a JAX node and the port's beams are held
against its beams with the F+B slice's tolerance (``tests/test_torch_
fengine_model.py``): max |d| <= 2 + 1e-3 and |d| > 1e-3 on <= 5e-3 of
beams (a 1-code flip of an F plane moves a beam by at most its weight).
Each JAX node sets ``fengine`` explicitly so that both resolve the same F
form: ``"xla"`` (the composed chain) at 128 channels, ``"fused"`` (the
JAX kernel in interpret mode against the port's plain K1) at 512.

Every wait carries its own deadline and every node, receiver and ring is
stopped in a ``finally``.
"""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.engine_node import EngineNode as JEngineNode
from dpdk_dc_sand_tpu.models.fbengine import resolve_backends as j_resolve_backends
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.control import Client, FailReply
from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
from dpdk_dc_sand_tpu_torch.models.fbengine import resolve_backends
from dpdk_dc_sand_tpu_torch.models.fengine import composed_f
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import ingest_alignment
from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, UdpReceiver, UdpSender
from dpdk_dc_sand_tpu_torch.stream.feed import UdpBeamEgress, requantise

CFG = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=4)
JCFG = JArrayConfig(**dataclasses.asdict(CFG))
TIMEOUT = 60.0


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 4 * TIMEOUT))
    finally:
        loop.close()


async def wait_for(cond, timeout=TIMEOUT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


def make_chunk(seq, shape):
    rng = np.random.default_rng(seq)
    return rng.integers(-64, 64, size=shape, dtype=np.int8)


def port_node(cfg=CFG, **kw):
    kw.setdefault("fengine", "xla")
    kw.setdefault("n_spectra", 8)
    return EngineNode(cfg, device="cpu", **kw)


def jax_node(cfg=JCFG, **kw):
    kw.setdefault("fengine", "xla")
    kw.setdefault("n_spectra", 8)
    kw.setdefault("use_pallas", False)
    return JEngineNode(cfg, **kw)


async def drive(node, script, timeout=TIMEOUT):
    """Start ``node``, run ``script``, return its beams and sensors.

    Script steps: ``("chunk", seq, adc)`` submits a chunk, ``("req",
    name, *args)`` sends a control request, ``("wait", n)`` waits for n
    beams, ``("sleep", s)`` sleeps.

    A chunk is submitted once every chunk before it has been counted in
    ``chunks-processed``. The JAX node counts up from the sensor's value in
    its processing thread while the sensor is set later on the loop, so two
    of its steps that finish before the loop runs (under load) count once;
    the port's node counts in its own thread
    (``test_chunks_processed_counts_every_step_of_a_burst``).
    """
    out = []
    node.on_beams = lambda b, s: out.append((s, np.array(b)))
    await node.start()
    client = await Client("127.0.0.1", node.port).connect()
    submitted = 0
    try:
        for step in script:
            if step[0] == "chunk":
                ok = await wait_for(lambda: int(node.s_processed.value) >= submitted, timeout)
                assert ok, f"chunks-processed {node.s_processed.value} of {submitted} submitted"
                assert node.submit_chunk(step[2], step[1])
                submitted += 1
            elif step[0] == "req":
                await client.request(step[1], *step[2:])
            elif step[0] == "wait":
                ok = await wait_for(lambda: len(out) >= step[1], timeout)
                assert ok, f"only {len(out)} of {step[1]} beams"
            else:
                await asyncio.sleep(step[1])
        # The processing thread counts a chunk just after its on_beams call.
        ok = await wait_for(lambda: int(node.s_processed.value) >= len(out), timeout)
        assert ok, f"chunks-processed {node.s_processed.value} after {len(out)} beams"
        sensors = {}
        for name in ("chunks-processed", "chunks-lost", "device-status"):
            _, informs = await client.request("sensor-value", name)
            sensors[name] = informs[0].args[4]
        return out, sensors
    finally:
        await client.close()
        await node.stop()


def beams_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= 2.0 + 1e-3, d.max()
    assert (d > 1e-3).mean() <= 5e-3, (d > 1e-3).mean()


def both(script_of, port_kw=None, jax_kw=None):
    """The same script through a port node and a JAX node."""
    pn, jn = port_node(**(port_kw or {})), jax_node(**(jax_kw or {}))
    assert pn.chunk_shape == jn.chunk_shape
    got = run(drive(pn, script_of(pn)))
    want = run(drive(jn, script_of(jn)))
    return got, want


def test_chunks_become_beams_and_sensors_update():
    def script(node):
        return [("chunk", s, make_chunk(s, node.chunk_shape)) for s in (0, 1, 3)] + [("wait", 3)]

    (got, sensors), (want, jsensors) = both(script)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 3]
    assert got[0][1].shape == (2, 128, 8, 2, 2) and np.isfinite(got[0][1]).all()
    assert sensors == jsensors == {"chunks-processed": "3", "chunks-lost": "1",
                                   "device-status": "ok"}
    for (_, g), (_, w) in zip(got, want):
        beams_close(g, w)


def test_chunks_processed_counts_every_step_of_a_burst():
    """Four chunks stepped while the loop is held (no sensor set can land
    until the last step is done) count as four: the node counts in its
    processing thread and the sensors take absolute values."""
    async def scenario():
        node = port_node()
        done = threading.Event()
        out = []

        def on_beams(beams, seq):
            out.append(seq)
            if len(out) == 4:
                done.set()

        node.on_beams = on_beams
        await node.start()
        try:
            for s in (0, 1, 2, 4):
                assert node.submit_chunk(make_chunk(s, node.chunk_shape), s)
            assert done.wait(TIMEOUT)  # blocks the loop until every step has run
            assert await wait_for(lambda: int(node.s_processed.value) == 4)
            assert await wait_for(lambda: int(node.s_lost.value) == 1)
            await asyncio.sleep(0.1)
            assert (int(node.s_processed.value), int(node.s_lost.value)) == (4, 1)
            assert out == [0, 1, 2, 4]
        finally:
            await node.stop()

    run(scenario())


def test_delay_model_update_changes_output():
    vals = []
    for a in range(CFG.n_ants):
        vals += [0.0, 0.0, a * 0.7, 0.0]
    dm = []
    for a in range(CFG.n_ants):
        dm += [float(a + 1), 0.1 * a - 0.15, -0.2 * a, 0.0]

    def script(node):
        chunk = make_chunk(7, node.chunk_shape)
        return [("chunk", 0, chunk), ("wait", 1), ("req", "beam-delays", 1, *vals),
                ("chunk", 1, chunk), ("wait", 2), ("req", "delay-model", *dm),
                ("chunk", 2, chunk), ("wait", 3)]

    (got, _), (want, _) = both(script)
    b0, b1, b2 = (b for _, b in got)
    # beam 0 unchanged, beam 1 changed by the new steering phases
    np.testing.assert_allclose(b1[..., 0, :], b0[..., 0, :], rtol=1e-5, atol=1e-3)
    assert np.abs(b1[..., 1, :] - b0[..., 1, :]).max() > 1.0
    assert np.abs(b2 - b1).max() > 1.0  # the F-side delays moved the beams
    for (_, g), (_, w) in zip(got, want):
        beams_close(g, w)

    async def failures():
        node = port_node(n_spectra=8)
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            with pytest.raises(FailReply):
                await client.request("beam-delays", 99, *vals)
            with pytest.raises(FailReply):
                await client.request("delay-model", 1.0)
            with pytest.raises(FailReply):
                await client.request("beam-weights", 1.0)
        finally:
            await client.close()
            await node.stop()

    run(failures())


def test_delay_rate_rotates_beams_over_time():
    """A uniform phase_rate r on beam 1 rotates it by e^{i·r·Δt} a chunk on
    identical input (coefficients re-extrapolated every chunk); beam 0
    stays fixed — and the JAX node gives the same beams."""
    chunk_dur = 8 * CFG.fft_size * CFG.sample_period
    vals = [0.0, 0.0, 0.0, 0.5 / chunk_dur] * CFG.n_ants

    def script(node):
        chunk = make_chunk(11, node.chunk_shape)
        return [("req", "beam-delays", 1, *vals)] + [
            ("chunk", s, chunk) for s in range(4)] + [("wait", 4)]

    kw = dict(n_spectra=8, coeff_update_steps=1)
    (got, _), (want, _) = both(script, kw, kw)

    def beam_c(i, b):
        arr = got[i][1][..., b, :]
        return arr[..., 0] + 1j * arr[..., 1]

    np.testing.assert_allclose(beam_c(3, 0), beam_c(0, 0), rtol=1e-5, atol=1e-3)
    ref = beam_c(0, 1)
    strong = np.abs(ref) > np.percentile(np.abs(ref), 90)
    for k in (1, 2, 3):
        ratio = beam_c(k, 1)[strong] / ref[strong]
        assert np.abs(np.exp(1j * np.angle(ratio)) - np.exp(0.5j * k)).max() < 1e-2
        np.testing.assert_allclose(np.abs(ratio), 1.0, atol=1e-2)
    for (_, g), (_, w) in zip(got, want):
        beams_close(g, w)


def test_capture_stop_pauses_processing():
    async def scenario():
        beams_out = []
        node = port_node(n_spectra=8, on_beams=lambda b, s: beams_out.append(s))
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            await client.request("capture-stop")
            _, informs = await client.request("sensor-value", "device-status")
            assert informs[0].args[4] == "idle"
            node.submit_chunk(make_chunk(0, node.chunk_shape), 0)
            assert await wait_for(lambda: len(node.ring) == 0)
            await asyncio.sleep(0.3)
            assert beams_out == []
            await client.request("capture-start")
            node.submit_chunk(make_chunk(1, node.chunk_shape), 1)
            assert await wait_for(lambda: beams_out == [1])
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_ring_overrun_counts_drops():
    pn, jn = port_node(n_spectra=8, ring_slots=2), jax_node(n_spectra=8, ring_slots=2)
    data = make_chunk(0, pn.chunk_shape)
    for node in (pn, jn):  # not started: the ring fills with no consumer
        assert node.submit_chunk(data, 0)
        assert node.submit_chunk(data, 1)
        assert not node.submit_chunk(data, 2)  # full -> dropped
        assert not node.submit_chunk(np.zeros(10 ** 6, np.int8), 3)  # oversize
    assert pn.ring.stats() == jn.ring.stats() == (2, 0, 2)
    assert pn.ring.pinned is False  # pinned slots only for a node on the card
    jn.ring.close()


def test_beam_weights_scale_output():
    def script(node):
        chunk = make_chunk(5, node.chunk_shape)
        return [("chunk", 0, chunk), ("wait", 1), ("req", "beam-weights", *([0.5] * 4)),
                ("chunk", 1, chunk), ("wait", 2)]

    (got, _), (want, _) = both(script)
    np.testing.assert_allclose(got[1][1], 0.5 * got[0][1], rtol=1e-4, atol=1e-3)
    for (_, g), (_, w) in zip(got, want):
        beams_close(g, w)


def test_device_quantised_beam_output():
    """beam_quant_scale: the node emits int8 beams equal to the host
    requant of its f32 beams, within 1 code of the JAX node's."""

    def script(node):
        return [("chunk", 0, make_chunk(11, node.chunk_shape)), ("wait", 1)]

    (f32, _), _ = both(script)
    (i8, _), (ji8, _) = both(script, dict(beam_quant_scale=0.25), dict(beam_quant_scale=0.25))
    assert i8[0][1].dtype == np.int8
    np.testing.assert_array_equal(i8[0][1], requantise(f32[0][1], 0.25))
    d = np.abs(i8[0][1].astype(np.int32) - ji8[0][1].astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() <= 5e-3

    sent = []

    class FakeSender:
        def send_chunk(self, chunk):
            sent.append(chunk)

    egress = UdpBeamEgress(FakeSender(), samples_per_chunk=16, scale=None)
    egress(i8[0][1], seq=3)
    np.testing.assert_array_equal(sent[0].payload.view(np.int8), i8[0][1].ravel())


def test_visibility_egress_end_to_end():
    """ADC heaps in over UDP -> FXB node -> integrated visibility dumps out
    over UDP: each dump is exactly the sum of the grams of the window's F
    planes (int8 products, exact in f32 at this size)."""
    n_in = CFG.n_ants * CFG.n_pols
    vis_bytes = CFG.n_channels * n_in * n_in * 2 * 4

    async def scenario():
        beams_out = []
        node = port_node(n_spectra=8, emit_visibilities=True, vis_accum_steps=2,
                         on_beams=lambda b, s: beams_out.append(s))
        vis_ring = ChunkRing(8, vis_bytes + 64)
        vis_rx = tx = None
        try:
            rx = node.attach_udp_ingest()
            vis_rx = UdpReceiver(("127.0.0.1", 0), vis_ring).start()
            node.attach_udp_vis_egress(("127.0.0.1", vis_rx.port))
            await node.start()
            tx = UdpSender(("127.0.0.1", rx.port))
            chunks = [make_chunk(seq, node.chunk_shape) for seq in range(4)]
            for seq, adc in enumerate(chunks):
                tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq))
            dumps = []
            deadline = time.monotonic() + TIMEOUT
            while len(dumps) < 2 and time.monotonic() < deadline:
                item = vis_ring.acquire_read()
                if item is None:
                    await asyncio.sleep(0.02)
                    continue
                view, seq = item
                payload = UdpReceiver.unpack(view).payload
                vis = np.ascontiguousarray(payload).view("<f4").reshape(
                    CFG.n_channels, n_in, n_in, 2)
                dumps.append((seq, vis.copy()))
                vis_ring.release_read()
            assert [s for s, _ in dumps] == [0, 2]  # window first-seqs
            assert await wait_for(lambda: len(beams_out) == 4)
            zi = np.zeros(CFG.n_ants, np.int32)
            zf = np.zeros(CFG.n_ants, np.float32)
            for w, (_, vis) in enumerate(dumps):
                want_re = np.zeros((CFG.n_channels, n_in, n_in), np.int64)
                want_im = np.zeros_like(want_re)
                for adc in chunks[2 * w: 2 * w + 2]:
                    qr, qi = (q.numpy().astype(np.int64).reshape(n_in, 8, -1)
                              for q in node.fb._f(adc, zi, zf, zf))
                    g = lambda u, v: np.einsum("isc,jsc->cij", u, v)  # noqa: E731
                    want_re += g(qr, qr) + g(qi, qi)
                    want_im += g(qi, qr) - g(qr, qi)
                np.testing.assert_array_equal(vis[..., 0], want_re.astype(np.float32))
                np.testing.assert_array_equal(vis[..., 1], want_im.astype(np.float32))
        finally:
            if tx is not None:
                tx.close()
            if vis_rx is not None:
                vis_rx.stop()
            await node.stop()

    run(scenario())


@pytest.mark.parametrize("wire_format", ["lite", "spead64"])
def test_udp_ingest_to_udp_egress_end_to_end(wire_format):
    """ADC heaps in over UDP (either wire format) -> pipeline -> int8 beam
    heaps out over UDP, each the host requant of the engine's step on that
    chunk."""

    async def scenario():
        node = port_node(n_spectra=8)
        beam_ring = ChunkRing(8, 2 * 128 * 8 * 2 * 2 + 64)
        beam_rx = tx = None
        try:
            rx = node.attach_udp_ingest()
            beam_rx = UdpReceiver(("127.0.0.1", 0), beam_ring).start()
            node.attach_udp_egress(("127.0.0.1", beam_rx.port))
            await node.start()
            tx = UdpSender(("127.0.0.1", rx.port), wire_format=wire_format)
            chunks = [make_chunk(seq, node.chunk_shape) for seq in range(3)]
            for seq, adc in enumerate(chunks):
                tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq))
            got = []
            deadline = time.monotonic() + TIMEOUT
            while len(got) < 3 and time.monotonic() < deadline:
                item = beam_ring.acquire_read()
                if item is None:
                    await asyncio.sleep(0.02)
                    continue
                view, seq = item
                payload = UdpReceiver.unpack(view).payload
                got.append((seq, np.ascontiguousarray(payload).view(np.int8).reshape(
                    2, 128, 8, 2, 2).copy()))
                beam_ring.release_read()
            assert [s for s, _ in got] == [0, 1, 2]
            zi, zf = np.zeros(4, np.int32), np.zeros(4, np.float32)
            for (seq, beams), adc in zip(got, chunks):
                want = node.fb.step(adc, zi, zf, zf).numpy()
                np.testing.assert_array_equal(beams, requantise(want, 0.25))
        finally:
            if tx is not None:
                tx.close()
            if beam_rx is not None:
                beam_rx.stop()
            beam_ring.close()
            await node.stop()

    run(scenario())


def test_delay_model_rejects_out_of_budget_coarse():
    async def scenario():
        node = port_node(n_spectra=4, margin=32)
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            await client.request("delay-model", *([3.0, 0.0, 0.0, 0.0] * CFG.n_ants))
            await client.request("delay-model", *([32.0, 0.0, 0.0, 0.0] * CFG.n_ants))
            for bad in (500.0, 33.0, -1.0):
                with pytest.raises(FailReply, match="budget"):
                    await client.request("delay-model", *([bad, 0.0, 0.0, 0.0] * CFG.n_ants))
            with pytest.raises(FailReply):
                await client.request("delay-model", *(["x"] * 4 * CFG.n_ants))
        finally:
            await client.close()
            await node.stop()

    run(scenario())


FUSED_CFG = ArrayConfig(n_ants=4, n_channels=512, n_beams=2, n_taps=4)


def test_fused_node_rounds_the_chunk_to_the_ingest_alignment():
    """The port's F kernel takes the coarse delay as a window start, so the
    node adds no DMA slack: the budget is rounded up only to the ingest
    alignment, and the chunk is born wire-rowed."""
    node = port_node(FUSED_CFG, n_spectra=16, fengine="auto")
    assert node.fb.fengine == "fused"
    align = ingest_alignment(FUSED_CFG.fft_size)
    assert node.delay_budget == 64
    assert node.margin == 64 + (-(node.fb.samples_in + 64) % align)
    assert node.chunk_shape == (4, 2, (node.fb.samples_in + node.margin) // align, align)
    flat = port_node(FUSED_CFG, n_spectra=16, fengine="xla")
    assert flat.margin == 64 and flat.chunk_shape == (4, 2, flat.fb.samples_in + 64)


def test_fused_node_matches_the_reference_node():
    """The fused F forms (the port's plain K1, the JAX kernel in interpret
    mode): the two nodes' chunks differ in length (the JAX node adds its
    DMA slack), so each is built from the same leading samples_in + budget
    samples with a different tail, which no delay within the budget reads."""
    jcfg = JArrayConfig(**dataclasses.asdict(FUSED_CFG))
    pn = port_node(FUSED_CFG, n_spectra=16, fengine="fused", bstage="planar")
    jn = jax_node(jcfg, n_spectra=16, fengine="fused", bstage="planar", use_pallas=None,
                  engine_opts=dict(fengine_interpret=True))
    lead = pn.fb.samples_in + pn.delay_budget
    assert pn.chunk_shape != jn.chunk_shape and jn.delay_budget == pn.delay_budget
    rng = np.random.default_rng(9)
    base = rng.integers(-64, 64, size=(4, 2, lead), dtype=np.int8)
    dm = []
    for a in range(4):
        dm += [float(16 * a), 0.1 * a - 0.15, -0.1 * a, 0.0]
    dv = []
    for a in range(4):
        dv += [1e-9 * a, 0.0, 0.3 * a, 0.0]

    def script(node, tail):
        n = int(np.prod(node.chunk_shape[2:])) - lead
        adc = np.concatenate([base, np.full((4, 2, n), tail, np.int8)], axis=-1)
        return [("req", "delay-model", *dm), ("req", "beam-delays", 1, *dv),
                ("chunk", 0, adc.reshape(node.chunk_shape)), ("wait", 1)]

    got, _ = run(drive(pn, script(pn, 0)))
    want, _ = run(drive(jn, script(jn, 99)))
    beams_close(got[0][1], want[0][1])


def test_engine_opts_reach_the_engine():
    node = port_node(n_spectra=8, engine_opts=dict(precision="bf16", quant_scale=0.5))
    assert node.fb.precision == "bf16" and node.fb.quant_scale == 0.5
    with pytest.raises(TypeError):
        port_node(n_spectra=8, engine_opts=dict(fengine_s_blk=16))  # a Mosaic knob
    with pytest.raises(ValueError, match="split"):
        port_node(n_spectra=8, emit_visibilities=True, beam_layout="natural")


@pytest.mark.parametrize("n_channels", [64, 128, 256, 512, 1024])
def test_auto_backends_resolve_as_the_reference(n_channels):
    """The port's "auto" F form is the reference's (Pallas available):
    the composed chain below K1's direct-CT sizes, the fused kernel above."""
    cfg = ArrayConfig(n_ants=4, n_channels=n_channels, n_beams=2, n_taps=4)
    jcfg = JArrayConfig(**dataclasses.asdict(cfg))
    want = j_resolve_backends(jcfg, 8, "auto", "auto", "auto", interpret=True)
    assert resolve_backends(cfg, 8, "auto", "auto") == want[:2]


def test_a_failed_step_degrades_the_node_and_logs_it():
    """The node catches a failed step and stays up, as the reference does;
    ``device-status`` reads ``degraded`` and an error ``#log`` goes out."""

    def on_beams(beams, seq):
        if seq == 0:
            raise RuntimeError("egress down")
        seen.append(seq)

    seen = []

    async def scenario():
        node = port_node(n_spectra=8, on_beams=on_beams)
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        logs = []
        client.on_inform(lambda m: logs.append(m.args) if m.name == "log" else None)
        try:
            await client.request("log-level", "warn")
            for seq in (0, 1):
                node.submit_chunk(make_chunk(seq, node.chunk_shape), seq)
            assert await wait_for(lambda: seen == [1])
            _, informs = await client.request("sensor-value", "device-status")
            assert informs[0].args[3:5] == ["error", "degraded"]
            _, informs = await client.request("sensor-value", "chunks-processed")
            assert informs[0].args[4] == "1"
            assert await wait_for(lambda: any("egress down" in a[3] for a in logs))
            assert logs[0][0] == "error"
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_node_runs_on_the_card_by_default():
    import dpdk_dc_sand_tpu_torch as pkg

    assert pkg.EngineNode is EngineNode
    if torch.cuda.is_available():
        node = EngineNode(CFG, n_spectra=8)
        assert node.device.type == "cuda" and node.ring.pinned
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            EngineNode(CFG, n_spectra=8)


def test_composed_f_is_the_node_f_stage():
    """The xla node's F planes are the composed chain's (the X test's gram
    above is of these planes)."""
    node = port_node(n_spectra=8)
    adc = make_chunk(3, node.chunk_shape)
    zi, zf = np.zeros(4, np.int32), np.zeros(4, np.float32)
    qr, qi = node.fb._f(adc, zi, zf, zf)
    shape = (4, 2, 8, 128)
    wr, wi = torch.empty(shape, dtype=torch.int8), torch.empty(shape, dtype=torch.int8)
    composed_f(torch.from_numpy(adc), torch.from_numpy(zi), torch.from_numpy(zf),
               torch.from_numpy(zf), node.fb.window, wr, wi, quant_scale=node.fb.quant_scale)
    assert torch.equal(qr, wr) and torch.equal(qi, wi)


def test_full_instrument_demo_runs_on_the_cpu(capsys):
    """The port's full-instrument demo: UDP ingest, control, UDP beams."""
    from dpdk_dc_sand_tpu_torch.examples import full_instrument_demo

    assert full_instrument_demo.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("beam heap seq=") >= 8 and "full instrument vertical on cpu: OK" in out
