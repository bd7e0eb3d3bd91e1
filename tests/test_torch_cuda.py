"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and skip
where ``torch.cuda.is_available()`` is False. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

It covers the small geometries the flagship run in ``chip_smoke.py`` does
not (N1 = 8 and 16, other beam counts, odd input counts, ragged tiles, FIR
shapes off every tile boundary, the launch counters), K8 at ragged shapes,
K1's unquantised (f32) output, K1's FIR pass alone, K1, K7 and the
engines above fft 65536, and the probes' kernels (K1's and K7's stage
stops, P1's modes, P3's loop orders) at small and ragged shapes.
"""

import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.models import FBEngine, FEngine, FXBEngine
from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn, fengine_fused as ff, pfb_fir, xcorr
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window, pfb_fir as pfb_fir_samples

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _codes_close(got, ref):
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("fft", [1024, 2048, 4096, 16384, 65536])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rowed", [False, True], ids=["flat", "rowed"])
def test_k1_kernel_matches_plain(dev, fft, dft_dtype, rowed):
    taps, s, lead = 4, 8, (2, 2)
    rng = np.random.default_rng(fft)
    n2 = ff.ingest_alignment(fft)
    n_in = -(-((s + taps - 1) * fft + 500) // n2) * n2
    raw = rng.integers(-64, 64, (*lead, n_in), dtype=np.int8)
    cd = rng.integers(0, 600, lead).astype(np.int32)  # some clamp at the end
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    x = raw.reshape(*lead, -1, n2) if rowed else raw
    scale = 1 / 16 * (1024 / fft) ** 0.5
    kw = dict(n_channels=fft // 2, quant_scale=scale, dft_dtype=dft_dtype,
              coarse_delays=cd, n_spectra=s, rowed=rowed)
    before = ff.fengine_fused.launches
    got = ff.fengine_fused(torch.from_numpy(x).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert ff.fengine_fused.launches == before + 1
    ref = ff.fengine_fused(torch.from_numpy(x), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape
        _codes_close(g.cpu(), r)


@pytest.mark.parametrize("n_beams", [4, 8, 16, 32])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_k2_kernel_matches_plain(dev, n_beams, precision):
    a, p, s, c = 3, 2, 64, 256
    rng = np.random.default_rng(n_beams)
    qr = torch.from_numpy(rng.integers(-127, 128, (a, p, s, c), dtype=np.int8))
    qi = torch.from_numpy(rng.integers(-127, 128, (a, p, s, c), dtype=np.int8))
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, 2 * n_beams)).astype(np.float32))
    before = bstage.beamform_turned_fused.launches
    got = bstage.beamform_turned_fused(qr.to(dev), qi.to(dev), w.to(dev),
                                       precision=precision, layout="packed")
    assert bstage.beamform_turned_fused.launches == before + 1
    ref = bstage.beamform_turned_fused(qr, qi, w, precision=precision, layout="packed")
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-3)


def test_engine_on_the_card_matches_the_plain_engine(dev):
    cfg = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
    kw = dict(n_spectra=64, precision="bf16", beam_layout="natural")
    gpu = FBEngine(cfg, device=dev, **kw)
    cpu = FBEngine(cfg, device="cpu", **kw)
    adc, cd, fd, ph, dv = cpu.example_inputs(seed=3, margin=1024, rowed=True)
    got = gpu(adc, cd, fd, ph, dv)
    ref = cpu(adc, cd, fd, ph, dv)
    d = (got.cpu() - ref).abs()
    assert float(d.max()) <= 2.0 + 1e-3
    assert float((d > 1e-3).float().mean()) <= 5e-3


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("shape", [(4, 2, 128, 8, 128), (8, 2, 128, 64, 128), (3, 1, 5, 100),
                                   (5, 2, 7, 64), (2, 2, 9, 3, 40)])
def test_k8_kernel_matches_plain(dev, shape):
    """Gated 5-d planes, and ragged ones (rows A·P·S or C not a multiple of 4
    or of the 64 tile): bit for bit, and K4's half of the same plane."""
    rng = np.random.default_rng(sum(shape))
    q = _int8(rng, shape)
    before = corner_turn.corner_turn_plane_native.launches
    got = corner_turn.corner_turn_plane_native(q.to(dev))
    assert corner_turn.corner_turn_plane_native.launches == before + 1
    ref = corner_turn.corner_turn_plane_native_reference(q)
    assert got.is_cuda and torch.equal(got.cpu(), ref)
    a, p, s = shape[:3]
    q4 = q.reshape(a, p, s, -1).to(dev)
    k4 = corner_turn.corner_turn_planes(q4, torch.zeros_like(q4))
    assert torch.equal(k4[:, :a], got)


@pytest.mark.parametrize("a, p, s, c", [(3, 1, 128, 128), (5, 1, 1024, 256), (3, 2, 96, 100),
                                        (17, 1, 128, 256)])
def test_k4_kernel_matches_plain(dev, a, p, s, c):
    rng = np.random.default_rng(a * s + c)
    qr, qi = _int8(rng, (a, p, s, c)), _int8(rng, (a, p, s, c))
    before = corner_turn.corner_turn_planes.launches
    got = corner_turn.corner_turn_planes(qr.to(dev), qi.to(dev))
    xt = corner_turn.corner_turn_planes_x(qr.to(dev), qi.to(dev))
    assert corner_turn.corner_turn_planes.launches == before + 2
    ref = corner_turn.corner_turn_planes_reference(qr, qi)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(xt.cpu(), ref.view(c, 2 * a * p, s))


@pytest.mark.parametrize("a, p, s, c", [(3, 1, 128, 128), (5, 1, 1024, 256), (17, 1, 128, 256),
                                        (9, 2, 256, 128)])
def test_k3_kernel_matches_plain(dev, a, p, s, c):
    rng = np.random.default_rng(a * s + c + 1)
    qr, qi = _int8(rng, (a, p, s, c)), _int8(rng, (a, p, s, c))
    before = xcorr.correlate_planes_fused.launches
    got = xcorr.correlate_planes_fused(qr.to(dev), qi.to(dev))
    assert xcorr.correlate_planes_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_planes_fused_reference(qr, qi)):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("i, s, c", [(3, 128, 128), (5, 1024, 256), (17, 128, 24), (6, 8, 16)])
def test_k5b_kernel_matches_plain(dev, i, s, c):
    rng = np.random.default_rng(i * s + c + 2)
    x = _int8(rng, (c, 2 * i, s))
    before = xcorr.correlate_turned_fused.launches
    got = xcorr.correlate_turned_fused(x.to(dev), i)
    assert xcorr.correlate_turned_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_turned_fused_reference(x, i)):
        assert torch.equal(g.cpu(), r)


def test_fxb_engine_on_the_card_matches_the_plain_engine(dev):
    cfg = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
    kw = dict(n_spectra=128, precision="bf16")
    gpu = FXBEngine(cfg, device=dev, **kw)
    cpu = FXBEngine(cfg, device="cpu", **kw)
    adc, cd, fd, ph, dv = cpu.example_inputs(seed=3, margin=1024)
    before = (ff.fengine_fused.launches, corner_turn.corner_turn_planes.launches,
              xcorr.correlate_planes_fused.launches)
    gb, gr, gi = gpu(adc, cd, fd, ph, dv)
    after = (ff.fengine_fused.launches, corner_turn.corner_turn_planes.launches,
             xcorr.correlate_planes_fused.launches)
    assert all(x == y + 1 for x, y in zip(after, before))
    rb, rr, ri = cpu(adc, cd, fd, ph, dv)
    d = (gb.cpu() - rb).abs()
    assert float(d.max()) <= 2.0 + 1e-3
    assert float((d > 1e-3).float().mean()) <= 5e-3
    # Visibilities: exactly the gram of the card's own F planes.
    qr, qi = ff.fengine_fused(torch.as_tensor(adc, device=dev).reshape(4, 2, -1), gpu.window,
                              None, None, n_channels=cfg.n_channels, quant_scale=1 / 16,
                              coarse_delays=torch.as_tensor(cd, device=dev)[:, None].expand(4, 2),
                              n_spectra=128, rot_planes=gpu._fine_rot(fd, ph))
    for g, r in zip((gr, gi), xcorr.correlate_planes_fused_reference(qr.cpu(), qi.cpu())):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize(
    "b, taps, fft, s, dtype",
    [(3, 16, 1000, 13, "int8"), (2, 8, 96, 129, "float32"), (1, 4, 65536, 9, "int8"),
     (2, 1, 6, 5, "int8"), (3, 20, 384, 7, "float32"), (2, 16, 1024, 256, "float32"),
     (4, 3, 518, 140, "int8")],
)
def test_k6_kernel_is_bit_exact_against_plain(dev, b, taps, fft, s, dtype):
    """fft not a multiple of 128 (or of 4), S not a multiple of 8 or of the
    block's run, f32 frames, taps above the register ring: bit for bit."""
    rng = np.random.default_rng(b * fft + s + taps)
    shape = (b, s + taps - 1, fft)
    if dtype == "int8":
        frames = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))
    else:
        frames = torch.from_numpy(rng.normal(0, 50, shape).astype(np.float32))
    win = torch.from_numpy(rng.normal(0, 1, (taps, fft)).astype(np.float32))
    before = pfb_fir.pfb_fir_frames.launches
    got = pfb_fir.pfb_fir_frames(frames.to(dev), win.to(dev))
    assert pfb_fir.pfb_fir_frames.launches == before + 1
    assert torch.equal(got.cpu(), pfb_fir.pfb_fir_reference(frames, win))


def test_k6_kernel_takes_an_unaligned_stream(dev):
    """A stream that starts one sample into its buffer takes the scalar lane loads."""
    rng = np.random.default_rng(11)
    taps, fft, s = 8, 512, 20
    raw = torch.from_numpy(rng.integers(-128, 128, 1 + (s + taps - 1) * fft, dtype=np.int8))
    win = default_window(taps, fft)
    got = pfb_fir_samples(raw.to(dev)[1:], win.to(dev))
    assert torch.equal(got.cpu(), pfb_fir.pfb_fir_reference(raw[1:].reshape(-1, fft), win))


@pytest.mark.parametrize("fft, deint", [(1024, "matmul"), (2048, "bitcast"), (2048, "matmul"),
                                        (512, "auto"), (65536, "matmul")])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k7_kernel_matches_plain(dev, fft, deint, dft_dtype):
    taps, s, lead = 8, 6, (2, 2)
    rng = np.random.default_rng(fft + len(deint))
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16 * (1024 / fft) ** 0.5,
              dft_dtype=dft_dtype, deint=deint)
    before = ff.fengine_dit.launches
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert ff.fengine_dit.launches == before + 1
    ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape
        _codes_close(g.cpu(), r)


@pytest.mark.parametrize("quantise_output", [True, False])
def test_fengine_on_the_card_matches_the_cpu_engine(dev, quantise_output):
    """cuFFT and the CPU's FFT round differently: int8 within 1 code on
    <= 1e-3 of samples, f32 at rtol 1e-4 / atol 1e-2."""
    cfg = ArrayConfig(n_ants=3, n_channels=2048, n_taps=16)
    kw = dict(n_spectra=40, quant_scale=1 / 32, quantise_output=quantise_output)
    gpu = FEngine(cfg, device=dev, **kw)
    cpu = FEngine(cfg, device="cpu", **kw)
    adc, cd, fd, ph = cpu.example_inputs(seed=5, margin=700)
    before = (pfb_fir.pfb_fir_frames.launches, ff.fengine_fused.launches,
              ff.fengine_dit.launches)
    got = gpu(adc, cd, fd, ph)
    after = (pfb_fir.pfb_fir_frames.launches, ff.fengine_fused.launches,
             ff.fengine_dit.launches)
    assert after == (before[0] + 1, before[1], before[2])
    ref = cpu(adc, cd, fd, ph)
    assert got.is_cuda and got.shape == ref.shape and got.dtype == ref.dtype
    if quantise_output:
        _codes_close(got.cpu(), ref)
    else:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("engine", [FBEngine, FXBEngine])
def test_xla_engines_on_the_card_match_the_cpu_engines(dev, engine):
    cfg = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
    kw = dict(n_spectra=128, precision="bf16", fengine="xla")
    gpu = engine(cfg, device=dev, **kw)
    cpu = engine(cfg, device="cpu", **kw)
    adc, cd, fd, ph, dv = cpu.example_inputs(seed=3, margin=1024)
    before = pfb_fir.pfb_fir_frames.launches
    got = gpu(adc, cd, fd, ph, dv)
    assert pfb_fir.pfb_fir_frames.launches == before + 1
    ref = cpu(adc, cd, fd, ph, dv)
    gb, rb = (got[0], ref[0]) if engine is FXBEngine else (got, ref)
    d = (gb.cpu() - rb).abs()
    assert float(d.max()) <= 2.0 + 1e-3
    assert float((d > 1e-3).float().mean()) <= 5e-3


@pytest.mark.parametrize("fft, rowed", [(1024, False), (4096, True), (65536, False)])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k1_unquantised_kernel_matches_plain(dev, fft, rowed, dft_dtype):
    """quantise=False: the rotated f32 values. The f32 DFT within rtol 1e-4 /
    atol 1e-2 of the plain version. The bf16 DFT sums stage A in another
    order, which flips a few bf16 roundings: below 1 code unit everywhere,
    within that bound on all but 1e-2 of the samples (measured at fft
    65536: 0.063, 2.5e-3). The int8 output of the same kernel is the
    requant of its f32 output, bit for bit."""
    taps, s, lead = 4, 8, (2, 2)
    rng = np.random.default_rng(fft + 1)
    n2 = ff.ingest_alignment(fft)
    n_in = -(-((s + taps - 1) * fft + 500) // n2) * n2
    raw = rng.integers(-64, 64, (*lead, n_in), dtype=np.int8)
    cd = rng.integers(0, 400, lead).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    x = raw.reshape(*lead, -1, n2) if rowed else raw
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16 * (1024 / fft) ** 0.5,
              dft_dtype=dft_dtype, coarse_delays=cd, n_spectra=s, rowed=rowed)
    xd, win = torch.from_numpy(x).to(dev), default_window(taps, fft, dev)
    before = ff.fengine_fused.launches
    got = ff.fengine_fused(xd, win, fd, ph, quantise=False, **kw)
    q8 = ff.fengine_fused(xd, win, fd, ph, **kw)
    assert ff.fengine_fused.launches == before + 2
    ref = ff.fengine_fused(torch.from_numpy(x), default_window(taps, fft), fd, ph,
                           quantise=False, **kw)
    for g, r, q in zip(got, ref, q8):
        assert g.is_cuda and g.dtype == torch.float32 and g.shape == r.shape
        assert torch.equal(torch.round(g).clamp(-127, 127).to(torch.int8), q)
        d = (g.cpu() - r).abs()
        over = float((d > 1e-2 + 1e-4 * r.abs()).float().mean())
        if dft_dtype == "float32":
            assert over == 0, float(d.max())
        else:
            assert float(d.max()) < 1.0 and over <= 1e-2, (float(d.max()), over)


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 4097, (1 << 20) + 2])
def test_e1_kernel_is_bit_exact_against_plain(dev, n):
    from dpdk_dc_sand_tpu_torch.ops.vector_add import vector_add, vector_add_reference

    rng = np.random.default_rng(n)
    x, y = (torch.from_numpy(rng.normal(size=n).astype(np.float32)) for _ in range(2))
    before = vector_add.launches
    got = vector_add(x.to(dev), y.to(dev))
    assert vector_add.launches == before + 1
    assert torch.equal(got.cpu(), vector_add_reference(x, y))
    if n > 1:
        with pytest.raises(ValueError, match="aligned"):
            vector_add(x.to(dev)[1:], y.to(dev)[1:])
    assert vector_add(x.to(dev)[:0], y.to(dev)[:0]).numel() == 0
    assert vector_add.launches == before + 1  # an empty sum launches nothing


def test_device_feed_copies_pinned_slots_on_its_own_stream(dev):
    """The feed copies each slot from page-locked memory on its copy stream,
    releases the slot after the copy, and keeps its loss and malformed
    accounting; the delivered tensors hold the slot's bytes."""
    import queue as _queue
    import time

    from dpdk_dc_sand_tpu_torch.stream import ChunkRing, DeviceFeed

    ring = ChunkRing(3, 1 << 20, pinned=True)
    feed = DeviceFeed(ring, reshape=lambda b: b.view(np.int8).reshape(-1, 1024),
                      device=dev).start()
    try:
        sent = {}
        for seq in (0, 1, 3, 4, 6):
            data = np.random.default_rng(seq).integers(-128, 128, 1 << 20, dtype=np.int8)
            n = 1000 if seq == 4 else data.nbytes  # seq 4 is malformed
            deadline = time.monotonic() + 10
            while len(ring) == ring.n_slots and time.monotonic() < deadline:
                time.sleep(1e-3)
            assert ring.put(data[:n], seq)
            sent[seq] = data
        got = []
        for _ in range(4):
            try:
                arr, seq = feed.get(timeout=10)
            except _queue.Empty:
                break
            assert arr.is_cuda and arr.shape == (1024, 1024)
            got.append(seq)
            assert torch.equal(arr.cpu().view(-1), torch.from_numpy(sent[seq]))
        assert got == [0, 1, 3, 6]
        assert feed.stats.lost == 3 and feed.stats.malformed == 1
        assert feed.pinned_copies == 4 and len(feed.h2d_log) == 4
    finally:
        feed.stop()


def test_engine_node_on_the_card_matches_its_engine(dev):
    """A node on the card: chunks through the pinned ring and the feed give
    the beams of its engine's step on the same chunk, bit for bit."""
    import asyncio

    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

    cfg = ArrayConfig(n_ants=4, n_channels=512, n_beams=4, n_taps=4)
    out = []
    node = EngineNode(cfg, n_spectra=128, beam_quant_scale=0.25,
                      on_beams=lambda b, s: out.append((s, b.copy())))
    assert node.ring.pinned and node.fb.fengine == "fused"
    chunks = [np.random.default_rng(s).integers(-64, 64, node.chunk_shape, dtype=np.int8)
              for s in range(3)]

    async def scenario():
        await node.start()
        try:
            for seq, adc in enumerate(chunks):
                assert node.submit_chunk(adc, seq)
            for _ in range(600):
                if len(out) == 3:
                    break
                await asyncio.sleep(0.05)
        finally:
            await node.stop()

    asyncio.run(scenario())
    assert [s for s, _ in out] == [0, 1, 2]
    assert node.s_processed.value == 3 and node.s_status.value == "ok"
    z = np.zeros(cfg.n_ants, np.float32)
    for (_, beams), adc in zip(out, chunks):
        want = node.fb.step(torch.from_numpy(adc).to(dev), z.astype(np.int32), z, z)
        assert np.array_equal(beams, want.cpu().numpy())


@pytest.mark.parametrize("fft, taps, s, batch", [(1024, 4, 9, 3), (65536, 16, 130, 2),
                                                 (1 << 17, 20, 3, 2), (2048, 8, 300, 1)])
def test_k1_fir_pass_is_bit_exact_against_plain(dev, fft, taps, s, batch):
    """K1's FIR pass: flat streams and the rowed view's same bytes, coarse
    delays that clamp at both ends and unaligned starts (byte loads), runs
    longer than a block's, taps above the register ring: bit for bit."""
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    rng = np.random.default_rng(fft + taps)
    out_len = (s + taps - 1) * fft
    n_in = -(-(out_len + 1000) // 512) * 512
    raw = torch.from_numpy(rng.integers(-128, 128, (batch, n_in), dtype=np.int8))
    cd = torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int64))
    cd[0] = -7
    cd[-1] = n_in
    if batch > 2:
        cd[1] = 3  # an unaligned start that does not clamp
    starts = clamp_starts(cd, n_in, out_len)
    win = default_window(taps, fft)
    before = ff.k1_fir.launches
    for x in (raw, raw.reshape(batch, -1, 512).reshape(batch, -1)):
        got = ff.k1_fir(x.to(dev), starts.to(dev), win.to(dev), n_spectra=s)
        assert got.dtype == torch.bfloat16 and got.shape == (batch, s, fft)
        assert torch.equal(got.cpu(), ff.k1_fir_reference(x, starts, win, n_spectra=s))
    assert ff.k1_fir.launches == before + 2


@pytest.mark.parametrize("fft", [1 << 17, 1 << 18, 1 << 20])
@pytest.mark.parametrize("quantise", [True, False])
def test_k1_two_pass_kernel_above_65536_matches_plain(dev, fft, quantise):
    """bf16 K1 beyond the old cap (N1 x N2 = 512 x 256, 512 x 512, 1024 x
    1024): int8 within 1 code on <= 1e-3 of samples; f32 output below 1 code
    unit everywhere and within rtol 1e-4 / atol 1e-2 on all but 1e-2.

    A code flips where the kernel's and the plain version's f32 sums of
    stage A round a T value to different bf16 neighbours; the flipped share
    grows with the codes' magnitude and with N1, the length of those sums.
    The gain keeps the codes near 50 rms, the flagship's level
    (chip_smoke.py's QUANT_SCALE)."""
    taps, s, lead = 4, 3, (1, 2)
    rng = np.random.default_rng(fft + quantise)
    n2 = ff.ingest_alignment(fft)
    n_in = -(-((s + taps - 1) * fft + 500) // n2) * n2
    raw = rng.integers(-64, 64, (*lead, n_in), dtype=np.int8)
    cd = rng.integers(0, 500, lead).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=0.068 * (1024 / fft) ** 0.5,
              coarse_delays=cd, n_spectra=s, quantise=quantise)
    before = (ff.fengine_fused.launches, ff.k1_fir.launches, ff.k1_dft.launches)
    got = ff.fengine_fused(torch.from_numpy(raw).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert (ff.fengine_fused.launches, ff.k1_fir.launches, ff.k1_dft.launches) == tuple(
        b + 1 for b in before)
    ref = ff.fengine_fused(torch.from_numpy(raw), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape and g.dtype == r.dtype
        if quantise:
            _codes_close(g.cpu(), r)
        else:
            d = (g.cpu() - r).abs()
            over = float((d > 1e-2 + 1e-4 * r.abs()).float().mean())
            assert float(d.max()) < 1.0 and over <= 1e-2, (float(d.max()), over)


@pytest.mark.parametrize("fft", [1 << 17, 1 << 18])
def test_k1_f32_kernel_above_65536_matches_plain(dev, fft):
    """The SIMT body (f32 DFT operands) with its chunk shrunk to fit: within
    1 code on <= 1e-3 of samples."""
    taps, s, lead = 4, 2, (1, 2)
    rng = np.random.default_rng(fft + 3)
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16 * (1024 / fft) ** 0.5,
              dft_dtype="float32")
    before = (ff.fengine_fused.launches, ff.k1_dft.launches)
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert (ff.fengine_fused.launches, ff.k1_dft.launches) == (before[0] + 1, before[1])
    ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r)


def test_k7_kernel_at_fft_2_17_matches_plain(dev):
    """K7 (deint="matmul", 256 x 256 half-length streams) above the old cap."""
    fft, taps, s, lead = 1 << 17, 4, 2, (1, 2)
    rng = np.random.default_rng(7)
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16 * (1024 / fft) ** 0.5,
              deint="matmul")
    before = ff.fengine_dit.launches
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert ff.fengine_dit.launches == before + 1
    ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r)


@pytest.mark.parametrize("engine", [FBEngine, FXBEngine])
def test_auto_engines_at_fft_2_17_step_on_the_card_and_match_the_cpu_engine(dev, engine):
    """fengine="auto" at 65536 channels resolves to the fused F kernel, as
    the reference resolves it, and steps on the card: beams within the CPU
    engine's flip bound (FXB: visibilities exactly the gram of the card's
    own F planes)."""
    cfg = ArrayConfig(n_ants=2, n_channels=1 << 16, n_beams=4, n_taps=4)
    kw = dict(n_spectra=128, precision="bf16", quant_scale=1 / 64)
    gpu = engine(cfg, device=dev, **kw)
    cpu = engine(cfg, device="cpu", **kw)
    assert gpu.fengine == cpu.fengine == "fused"
    adc, cd, fd, ph, dv = cpu.example_inputs(seed=17, margin=1024, rowed=True)
    before = ff.fengine_fused.launches
    got = gpu(adc, cd, fd, ph, dv)
    assert ff.fengine_fused.launches == before + 1
    ref = cpu(adc, cd, fd, ph, dv)
    gb, rb = (got[0], ref[0]) if engine is FXBEngine else (got, ref)
    d = (gb.cpu().float() - rb.float()).abs()
    assert float(d.max()) <= 2.0 + 1e-3
    assert float((d > 1e-3).float().mean()) <= 5e-3
    if engine is FXBEngine:
        n_in = cfg.n_ants * cfg.n_pols
        qr, qi = ff.fengine_fused(
            torch.as_tensor(adc, device=dev).reshape(cfg.n_ants, cfg.n_pols, -1), gpu.window,
            None, None, n_channels=cfg.n_channels, quant_scale=1 / 64,
            coarse_delays=torch.as_tensor(cd, device=dev)[:, None].expand(cfg.n_ants, 2),
            n_spectra=128, rot_planes=gpu._fine_rot(fd, ph))
        for g, r in zip(got[1:], xcorr.correlate_planes_fused_reference(qr.cpu(), qi.cpu())):
            assert g.shape == (cfg.n_channels, n_in, n_in) and torch.equal(g.cpu(), r)


# --- The probes P1-P5 (dpdk_dc_sand_tpu_torch.benchmarks) -------------------


@pytest.mark.parametrize("stop", ["dma", "fir", "stagea", "stageb"])
@pytest.mark.parametrize("fft, s", [(16384, 20), (65536, 33)])
def test_k1_stops_match_plain(dev, stop, fft, s):
    """P5's and P4's kernels: K1's passes cut at a stage, with coarse delays
    (one start unaligned) and S off the 16-spectrum probe blocks: dma and fir
    bit for bit, the DFT stops within 1 code on <= 1e-3 of samples."""
    taps, b = 16, 3
    rng = np.random.default_rng(fft + s)
    x = rng.integers(-16, 16, (b, (s + taps) * fft + 40), dtype=np.int8)
    cd = np.array([0, 7, 40])
    fd = np.zeros(b, np.float32)
    win = default_window(taps, fft) / 8
    kw = dict(n_channels=fft // 2, quant_scale=1 / 64, coarse_delays=cd, n_spectra=s,
              _ablate=stop)
    before = ff.fengine_fused.ablate_launches
    got = ff.fengine_fused(torch.from_numpy(x).to(dev), win.to(dev), fd, fd, **kw)
    assert ff.fengine_fused.ablate_launches == before + 1
    ref = ff.fengine_fused(torch.from_numpy(x), win, fd, fd, **kw)
    for g, r in zip(got, ref):
        if stop in ("dma", "fir"):
            assert torch.equal(g.cpu(), r)
        else:
            _codes_close(g.cpu(), r)


@pytest.mark.parametrize("stop", ["dma", "conv", "fir", "deint", "stagea", "stageb"])
@pytest.mark.parametrize("n1, n2, s", [(128, 64, 20), (256, 128, 16), (16, 8, 33)])
def test_k7_stops_match_plain(dev, stop, n1, n2, s):
    """P2's kernel: K7 cut at a stage, bit for bit before the chunk loop and
    within 1 code on <= 1e-3 of samples after it."""
    taps, b, fft = 16, 2, 2 * n1 * n2
    rng = np.random.default_rng(n1 + s)
    frames = torch.from_numpy(rng.integers(-64, 64, (b, s + taps - 1, fft), dtype=np.int8))
    win = torch.from_numpy((rng.standard_normal((taps, fft)) / 64).astype(np.float32))
    before = ff.fengine_dit_ablate.launches
    got = ff.fengine_dit_ablate(frames.to(dev), win.to(dev), n1=n1, n2=n2, stop=stop)
    assert ff.fengine_dit_ablate.launches == before + 1
    for g, r in zip(got, ff.fengine_dit_ablate_reference(stop, frames, win, n1=n1, n2=n2)):
        if stop in ("stagea", "stageb"):
            _codes_close(g.cpu(), r)
        else:
            assert torch.equal(g.cpu(), r)


_P1_SHAPES = [(8, 2, 128, 512, 128, 128), (4, 1, 48, 96, 32, 48), (3, 2, 32, 64, 32, 16),
              (80, 2, 32, 256, 256, 32)]


@pytest.mark.parametrize("mode, a, p, s, c, c_blk, s_chunk", [
    (mode, *shape) for mode in ("copy", "i8", "i32", "i8m", "i8m2") for shape in _P1_SHAPES
    if mode != "i8m2" or shape[0] % 4 == 0])
def test_p1_modes_match_plain(dev, mode, a, p, s, c, c_blk, s_chunk):
    """P1's kernel in every mode, on tiles that are and are not powers of
    two, with odd antenna counts (i8m2 turns four antennas' words, so it
    takes A % 4 == 0 only): bit for bit."""
    from dpdk_dc_sand_tpu_torch.benchmarks import ct_kernel_probe as ctp

    rng = np.random.default_rng(a * s + c)
    qr, qi = _int8(rng, (a, p, s, c)), _int8(rng, (a, p, s, c))
    before = ctp.ct_probe.launches
    got = ctp.ct_probe(qr.to(dev), qi.to(dev), mode, c_blk, s_chunk)
    assert ctp.ct_probe.launches == before + 1
    assert torch.equal(got.cpu(), ctp.ct_probe_reference(qr, qi, mode))


@pytest.mark.parametrize("kind", ["persi", "tapouter", "tapo2d"])
@pytest.mark.parametrize("n1, n2, reps", [(256, 256, 40), (8, 8, 3), (5, 300, 2), (3, 7, 1)])
def test_p3_kernel_is_bit_exact_against_plain(dev, kind, n1, n2, reps):
    """P3's kernel in both loop orders, N2 off the 256-column block and a
    single pass: bit for bit, the serialising chain included."""
    from dpdk_dc_sand_tpu_torch.benchmarks import fir_probe as fp

    rng = np.random.default_rng(n1 * n2 + reps)
    x = torch.from_numpy(rng.normal(size=((fp.J + fp.TAPS - 1) * n1, n2)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(fp.TAPS * n1, n2)).astype(np.float32))
    x = x.to(torch.bfloat16)
    before = fp.fir_probe.launches
    got = fp.fir_probe(x.to(dev), w.to(dev), kind, reps=reps)
    assert fp.fir_probe.launches == before + 1
    assert torch.equal(got.cpu(), fp.fir_probe_reference(x, w, reps))
