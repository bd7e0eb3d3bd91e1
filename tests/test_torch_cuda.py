"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and skip
where ``torch.cuda.is_available()`` is False. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

It covers the small geometries the flagship run in ``chip_smoke.py`` does
not (N1 = 8 and 16, other beam counts, odd input counts, ragged tiles, FIR
shapes off every tile boundary, the launch counters), K3 over a grid of
input counts, S and C, at the int8 extremes and from a base aligned to 4
bytes only, with its C-side geometry and its stage stops, K5b over the same
input counts at every S its gate takes and at each plan its C side chooses,
at the extremes, from a 4-byte-aligned base, with its registers, spills,
refusals and stage stops, K8 at ragged shapes,
K2's body at every 2B its gate takes (2 to 128) and at narrow channel
counts (C = 8, 24, 48), over a grid of 2B, A, P·S and C in both layouts
and both weight types, at the int8 extremes, with f32 weights that only a
three-term split carries, with its C-side geometry, every instantiation's
spill bytes and its stage stops in both weight types,
K1's unquantised (f32) output, K1's FIR pass alone, K1, K7 and the
engines above fft 65536, K1's f32 form (its f32 FIR pass bit for bit, its
FFMA DFT pass at every plan, which split takes which route), K1 at N1 = 8
and on its three-pass route (each stage alone and whole, both forms, the
stage bodies' registers and spill bytes), K7 on each route (its DFT pass
alone at every chunk plan, both passes at fft 2048 to 2^17 and over several
plane groups, every N1 = 8 split from fft 64 to 2048 in both forms, the
three passes at 2048 x 2048 bf16 and 1024 x 1024 and 2048 x 1024 f32 and
each stage alone, its launch counters, its registers and spill bytes), and
K1's stage stops (``fengine_fused(_ablate=)``) on every route, both forms,
with the requant and without, and every stop body's spill bytes, K1 at a
channel offset, the probes' kernels (K1's and K7's stage stops, P2 on K7's
route, P1's modes, P3's loop orders) at small
and ragged shapes, a one-rank NCCL step of the sharded engine against
``FBEngine``, the tensor-core dynamic-range probe, the port's servlet
fronting two engine nodes on the card, the page-locked native ring (its
slot views pinned, a burst-UDP heap through it to the card) and the
``ctypes_callback`` example's native hot path.
"""

import numpy as np
import pytest
import torch

from chip_smoke import K1_COUNTERS, _route_passes, _stop_diff
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


def _codes_close(got, ref, max_frac=1e-3):
    """Within 1 int8 code on <= ``max_frac`` of samples: 1e-3, the bf16
    contract; 1e-4, the reference's f32 contract."""
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) <= max_frac


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


@pytest.mark.parametrize("n_beams", [1, 2, 4, 8, 16, 32, 64])
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


def _k2_check(dev, qr, qi, w, layout="packed"):
    """K2 on the card against its plain version (the wrapper on CPU
    tensors), rtol 1e-5 / atol 1e-3, the launch counter rising by one."""
    p = qr.shape[1]
    before = bstage.beamform_turned_fused.launches
    got = bstage.beamform_turned_fused(qr, qi, w, n_pols=p, layout=layout)
    assert bstage.beamform_turned_fused.launches == before + 1
    ref = bstage.beamform_turned_fused(qr.cpu(), qi.cpu(), w.cpu(), n_pols=p, layout=layout)
    if layout == "packed":
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.cpu(), r, rtol=1e-5, atol=1e-3)


#: (P·S, C) of the ring body's grid: one m tile and two channel blocks of 16;
#: three m tiles (2B <= 32) and six channel blocks; eight m tiles and 256
#: channel blocks (each persistent block walks several).
K2_SHAPES = [(64, 32), (192, 96), (512, 4096)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["packed", "split"])
@pytest.mark.parametrize("ps, c", K2_SHAPES)
@pytest.mark.parametrize("a", [1, 7, 80])
@pytest.mark.parametrize("nb2", [16, 32, 64])
def test_k2_ring_body_matches_plain(dev, nb2, a, ps, c, layout, dtype):
    """2A = 2, 14 (one partial K step) and 160; weights held whole or staged."""
    p = 2
    rng = np.random.default_rng(nb2 * 1000 + a * 10 + ps + c)
    qr, qi = (_int8(rng, (a, p, ps // p, c)).to(dev) for _ in range(2))
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, nb2)).astype(np.float32))
    _k2_check(dev, qr, qi, w.to(dev).to(dtype), layout)


#: (C, 2B) below 16 channels or off a multiple of 16, each 2B whose pack
#: (128 / 2B channels a packed row) divides C.
K2_NARROW = [(c, nb2) for c in (8, 24, 48) for nb2 in (2, 4, 8, 16, 32, 64, 128)
             if c % (128 // nb2) == 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c, nb2", K2_NARROW)
def test_k2_takes_narrow_channel_counts(dev, c, nb2, dtype):
    """C below 16 or not a multiple of it (the planes' byte-load copies and
    the masked last channel block); and planes from a base one byte on, off
    16-byte alignment (byte loads at C = 48 too)."""
    a, p, s = 5, 2, 64
    rng = np.random.default_rng(c * 1000 + nb2)
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, nb2)).astype(np.float32))
    w = w.to(dev).to(dtype)
    qr, qi = (_int8(rng, (a, p, s, c)).to(dev) for _ in range(2))
    _k2_check(dev, qr, qi, w)
    qr, qi = (_int8(rng, (a * p * s * c + 1,)).to(dev)[1:].view(a, p, s, c) for _ in range(2))
    _k2_check(dev, qr, qi, w)


def test_k2_f32_weights_need_all_three_terms(dev):
    """Weights 1 + 2^-9 + 2^-18 against 1 on alternate contraction rows, with
    samples +64 and -64 (every product exact in f32): each pair of rows
    cancels to 64 (2^-9 + 2^-18), so the partial sums stay small while a
    split that drops the third term (2^-18) errs by 2A/2 x 64 x 2^-18 =
    0.0195 at A = 80, far past atol 1e-3; K2 must be within it."""
    a, p, s, c, nb2 = 80, 2, 64, 32, 32
    w1 = 1 + 2.0 ** -9 + 2.0 ** -18
    k = torch.arange(2 * a) % 2
    w = torch.where(k == 0, torch.tensor(w1), torch.tensor(1.0)).float()
    w = w.view(1, 2 * a, 1).expand(c, 2 * a, nb2).contiguous().to(dev)
    x = torch.where(torch.arange(a) % 2 == 0, 64, -64).to(torch.int8)
    qr = x.view(a, 1, 1, 1).expand(a, p, s, c).contiguous().to(dev)
    qi = qr.clone()
    got = bstage.beamform_turned_fused(qr, qi, w, precision="f32", layout="packed")
    exact = 2 * (a // 2) * 64 * (2.0 ** -9 + 2.0 ** -18)
    two_terms = 2 * (a // 2) * 64 * 2.0 ** -9
    assert abs(exact - two_terms) > 0.01
    torch.testing.assert_close(got.cpu(), torch.full_like(got.cpu(), exact), rtol=1e-5,
                               atol=1e-3)
    _k2_check(dev, qr, qi, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("nb2", [16, 32, 64])
def test_k2_holds_the_int8_extremes(dev, nb2, dtype):
    """Every code -128 in qr and 127 in qi, and alternating extremes: the
    register turn's bf16 conversion is exact at both ends."""
    a, p, s, c = 9, 2, 128, 64
    rng = np.random.default_rng(nb2 + 5)
    w = torch.from_numpy(rng.uniform(-2, 2, (c, 2 * a, nb2)).astype(np.float32))
    w = w.to(dev).to(dtype)
    qr = torch.full((a, p, s, c), -128, dtype=torch.int8, device=dev)
    qi = torch.full((a, p, s, c), 127, dtype=torch.int8, device=dev)
    _k2_check(dev, qr, qi, w)
    idx = torch.arange(a * p * s * c, device=dev).view(a, p, s, c)
    qr = torch.where(idx % 2 == 0, 127, -128).to(torch.int8)
    qi = torch.where(idx % 3 == 0, -128, torch.where(idx % 3 == 1, 0, -1)).to(torch.int8)
    _k2_check(dev, qr, qi, w)


def test_k2_geometry_is_the_c_sides(dev):
    """The ring body's attributes come from the runtime, its geometry from
    the C side, which refuses a shape it cannot take before any launch."""
    from dpdk_dc_sand_tpu_torch import _build

    at = bstage.kernel_attributes(80, 2, 256, 16, 32768)
    assert at["regs"] > 0 and at["local_bytes"] == 0
    assert 1 <= at["blocks"] <= torch.cuda.get_device_properties(dev).multi_processor_count
    assert (at["channels"], at["m_rows"], at["k_rows"]) == (16, 64, 16)
    assert (at["resident"], at["item_cols"], at["wide"]) == (1, 32, 1)
    f32 = bstage.kernel_attributes(80, 2, 256, 16, 32768, precision="f32")
    assert (f32["resident"], f32["m_rows"], f32["local_bytes"]) == (0, 64, 0)
    assert f32["smem_bytes"] <= 232448
    for nb, cols, rows in ((1, 8, 64), (4, 8, 64), (8, 16, 64), (32, 64, 32), (64, 64, 32)):
        got = bstage.kernel_attributes(80, 2, 256, nb, 32768)
        assert got["local_bytes"] == 0 and got["smem_bytes"] <= 232448
        assert (got["item_cols"], got["m_rows"]) == (cols, rows)
    assert bstage.kernel_attributes(3, 2, 64, 16, 24)["wide"] == 0
    lib = _build.library()
    x = torch.zeros(2 * 96 * 64, dtype=torch.int8, device=dev)
    w = torch.zeros(64 * 2 * 32, dtype=torch.bfloat16, device=dev)
    out = torch.empty(64 * 96 * 32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for ps, c, nb2 in ((96, 64, 32), (64, 42, 32), (64, 64, 12), (64, 64, 256)):
        # P·S % 64, C % pack, 2B not dividing 128
        assert lib.bstage_fused_launch(x.data_ptr(), x.data_ptr(), w.data_ptr(), 1,
                                       out.data_ptr(), 1, ps, c, nb2, stream) != 0
    torch.cuda.synchronize()


def test_k2_bodies_do_not_spill(dev):
    """Every instantiation of the ring body (the columns an item computes:
    8, 16, 32, 64; bf16 and f32 weights) at 0 local bytes."""
    for nb in (1, 8, 16, 32):
        for precision in ("bf16", "f32"):
            at = bstage.kernel_attributes(80, 2, 256, nb, 32768, precision=precision)
            assert at["local_bytes"] == 0, (nb, precision, at)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("stop", sorted(bstage.K2_STOPS))
def test_k2_stops_write_what_they_keep(dev, stop, dtype):
    """A stop with the stores writes zeros over every output; one without
    writes nothing; neither counts as a K2 launch."""
    a, p, s, c = 17, 2, 128, 1024
    rng = np.random.default_rng(14)
    qr, qi = (_int8(rng, (a, p, s, c)).to(dev) for _ in range(2))
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, 32)).astype(np.float32))
    w = w.to(dev).to(dtype)
    out = torch.ones((c // 4, p * s, 128), device=dev)
    before = bstage.beamform_turned_fused.launches
    bstage.beamform_turned_fused_stop(qr, qi, w, out, stop)
    want = torch.zeros_like(out) if "store" in stop else torch.ones_like(out)
    assert torch.equal(out, want)
    assert bstage.beamform_turned_fused.launches == before
    with pytest.raises(RuntimeError, match="bstage_fused_stop"):  # the C side refuses S = 16
        bstage.beamform_turned_fused_stop(
            qr[:, :, :16].contiguous(), qi[:, :, :16].contiguous(), w,
            torch.ones((c // 4, p * 16, 128), device=dev), stop)


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


#: (A, P) for each input count of K3's grid: one input, a ragged tile, one
#: whole tile, a tile and one, two ragged tiles, the flagship's 160.
K3_INPUTS = {1: (1, 1), 3: (3, 1), 16: (8, 2), 17: (17, 1), 34: (17, 2), 160: (80, 2)}


def _k3_check(dev, qr, qi):
    before = xcorr.correlate_planes_fused.launches
    got = xcorr.correlate_planes_fused(qr.to(dev), qi.to(dev))
    assert xcorr.correlate_planes_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_planes_fused_reference(qr, qi)):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("c", [128, 384])
@pytest.mark.parametrize("s", [128, 256, 1024])
@pytest.mark.parametrize("i", sorted(K3_INPUTS))
def test_k3_ring_body_is_bit_exact(dev, i, s, c):
    a, p = K3_INPUTS[i]
    rng = np.random.default_rng(7 * i + s + c)
    _k3_check(dev, _int8(rng, (a, p, s, c)), _int8(rng, (a, p, s, c)))


def test_k3_persistent_blocks_walk_many_items(dev):
    """C = 4096 at I = 160: 7040 work items, dozens on each block."""
    rng = np.random.default_rng(11)
    _k3_check(dev, _int8(rng, (80, 2, 128, 4096)), _int8(rng, (80, 2, 128, 4096)))


def test_k3_takes_a_base_aligned_to_4_bytes_only(dev):
    a, p, s, c = 17, 2, 256, 128
    rng = np.random.default_rng(12)
    n = a * p * s * c
    raw = _int8(rng, (2, n + 16)).to(dev)
    qr, qi = raw[0, 4:4 + n].view(a, p, s, c), raw[1, 12:12 + n].view(a, p, s, c)
    assert qr.data_ptr() % 16 and qi.data_ptr() % 16
    before = xcorr.correlate_planes_fused.launches
    got = xcorr.correlate_planes_fused(qr, qi)
    assert xcorr.correlate_planes_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_planes_fused_reference(qr.cpu(), qi.cpu())):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("pattern", ["all_min", "alternating"])
def test_k3_holds_the_largest_sums(dev, pattern):
    """S = 1024 at the int8 extremes: V_re reaches 2^25 with every code -128."""
    a, p, s, c = 17, 2, 1024, 128
    if pattern == "all_min":
        qr = torch.full((a, p, s, c), -128, dtype=torch.int8)
        qi = qr.clone()
    else:
        idx = torch.arange(a * p * s * c).view(a, p, s, c)
        qr = torch.where(idx % 2 == 0, 127, -128).to(torch.int8)
        qi = torch.where(idx % 3 == 0, -128, torch.where(idx % 3 == 1, 127, -127)).to(torch.int8)
    _k3_check(dev, qr, qi)
    if pattern == "all_min":
        vre = xcorr.correlate_planes_fused(qr.to(dev), qi.to(dev))[0]
        assert float(vre.max()) == 2.0 ** 25


def test_k3_geometry_is_the_c_sides(dev):
    """The body's attributes come from the runtime; the C side refuses a
    shape it cannot take (S % 32, C % 32) before any launch."""
    from dpdk_dc_sand_tpu_torch import _build

    at = xcorr.kernel_attributes(160, 256, 32768)
    assert at["regs"] > 0 and at["local_bytes"] == 0
    assert 1 <= at["blocks"] <= torch.cuda.get_device_properties(dev).multi_processor_count * 2
    # A shape of fewer items than SMs: one block an item (3 tiles x 4 channel blocks).
    assert xcorr.kernel_attributes(17, 128, 128)["blocks"] == 12
    lib = _build.library()
    x = torch.zeros(4 * 48 * 128, dtype=torch.int8, device=dev)
    out = torch.empty(128 * 16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for s, c in ((48, 128), (128, 48)):
        err = lib.xcorr_fused_launch(x.data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(),
                                     4, s, c, stream)
        assert err != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("stop", sorted(xcorr.K3_STOPS))
def test_k3_stops_write_what_they_keep(dev, stop):
    """A stop with the stores writes zeros over every output; one without
    writes nothing; neither counts as a K3 launch."""
    a, p, s, c = 17, 2, 256, 4096
    rng = np.random.default_rng(13)
    qr, qi = (_int8(rng, (a, p, s, c)).to(dev) for _ in range(2))
    vre, vim = (torch.ones((c, a * p, a * p), device=dev) for _ in range(2))
    before = xcorr.correlate_planes_fused.launches
    xcorr.correlate_planes_fused_stop(qr, qi, vre, vim, stop)
    want = torch.zeros_like(vre) if "store" in stop else torch.ones_like(vre)
    assert torch.equal(vre, want) and torch.equal(vim, want)
    assert xcorr.correlate_planes_fused.launches == before
    with pytest.raises(RuntimeError, match="xcorr_fused_stop"):  # the C side refuses S = 48
        xcorr.correlate_planes_fused_stop(qr[:, :, :48].contiguous(), qi[:, :, :48].contiguous(),
                                          vre, vim, stop)


@pytest.mark.parametrize("i, s, c", [(3, 128, 128), (5, 1024, 256), (17, 128, 24), (6, 8, 16)])
def test_k5b_kernel_matches_plain(dev, i, s, c):
    rng = np.random.default_rng(i * s + c + 2)
    x = _int8(rng, (c, 2 * i, s))
    before = xcorr.correlate_turned_fused.launches
    got = xcorr.correlate_turned_fused(x.to(dev), i)
    assert xcorr.correlate_turned_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_turned_fused_reference(x, i)):
        assert torch.equal(g.cpu(), r)


def _k5b_check(dev, x, i):
    before = xcorr.correlate_turned_fused.launches
    got = xcorr.correlate_turned_fused(x.to(dev), i)
    assert xcorr.correlate_turned_fused.launches == before + 1
    for g, r in zip(got, xcorr.correlate_turned_fused_reference(x.cpu(), i)):
        assert torch.equal(g.cpu(), r)
    return got


#: K5b's grid: the input counts of K3's grid (one input, a ragged tile, one
#: tile, a tile and one, two ragged tiles, the flagship's 160), every S from
#: one 8-sample step to 1024, C cycling through 8, 24 and 264 (C % 8 == 0).
K5B_S = [8, 24, 128, 256, 512, 1024]


@pytest.mark.parametrize("s", K5B_S)
@pytest.mark.parametrize("i", sorted(K3_INPUTS))
def test_k5b_every_gated_shape_is_bit_exact(dev, i, s):
    c = (8, 24, 264)[(sorted(K3_INPUTS).index(i) + K5B_S.index(s)) % 3]
    rng = np.random.default_rng(5 * i + s + c)
    _k5b_check(dev, _int8(rng, (c, 2 * i, s)), i)


#: A shape of each plan the C side takes (csrc/xcorr.cu:k5b_plan) and
#: whether its rows arrive by TMA or by cp.async: two channels resident, one,
#: or rows streamed in stages (I = 500: tiles of 64 rows and pairs of 80
#: columns of a 500 x 500 V; S = 1000: a short last stage); TMA where
#: S % 16 == 0 and I <= 256; C = 1056 and 272 put several channels on a
#: block, so a slot's mbarrier and copies are reused.
K5B_PLAN_SHAPES = {(160, 256, 64): ("two_slots", True), (160, 512, 24): ("one_slot", True),
                   (160, 1024, 24): ("stream", False), (200, 256, 8): ("one_slot", True),
                   (500, 1024, 8): ("stream", False), (3, 1024, 8): ("two_slots", True),
                   (160, 24, 8): ("two_slots", False), (300, 128, 8): ("two_slots", False),
                   (160, 512, 1056): ("one_slot", True), (200, 264, 272): ("one_slot", False),
                   (160, 1000, 24): ("stream", False)}


@pytest.mark.parametrize("i, s, c", sorted(K5B_PLAN_SHAPES))
def test_k5b_every_plan_is_bit_exact_without_spills(dev, i, s, c):
    at = xcorr.turned_kernel_attributes(i, s, c)
    assert (at["plan"], at["tma"]) == K5B_PLAN_SHAPES[(i, s, c)]
    assert at["regs"] > 0 and at["local_bytes"] == 0
    assert at["smem_bytes"] > 0 and at["blocks"] >= 1
    rng = np.random.default_rng(i + s + c)
    _k5b_check(dev, _int8(rng, (c, 2 * i, s)), i)


def test_k5b_persistent_blocks_walk_many_channels(dev):
    """C = 4096 at I = 160, S = 256: dozens of channels on each block."""
    at = xcorr.turned_kernel_attributes(160, 256, 4096)
    assert at["blocks"] <= torch.cuda.get_device_properties(dev).multi_processor_count
    _k5b_check(dev, _int8(np.random.default_rng(14), (4096, 320, 256)), 160)


@pytest.mark.parametrize("pattern", ["all_min", "alternating"])
def test_k5b_holds_the_largest_sums(dev, pattern):
    """S = 1024 at the int8 extremes: V_re reaches 2^25 with every code -128."""
    i, s, c = 34, 1024, 24
    if pattern == "all_min":
        x = torch.full((c, 2 * i, s), -128, dtype=torch.int8)
    else:
        idx = torch.arange(c * 2 * i * s).view(c, 2 * i, s)
        x = torch.where(idx % 2 == 0, 127, -128).to(torch.int8)
        x[:, i:] = torch.where(idx[:, i:] % 3 == 0, -128,
                               torch.where(idx[:, i:] % 3 == 1, 127, -127)).to(torch.int8)
    vre, _ = _k5b_check(dev, x, i)
    if pattern == "all_min":
        assert float(vre.max()) == 2.0 ** 25


@pytest.mark.parametrize("i, s", [(17, 256), (160, 1024), (3, 24)])
def test_k5b_takes_a_base_aligned_to_4_bytes_only(dev, i, s):
    c = 24
    n = c * 2 * i * s
    raw = _int8(np.random.default_rng(15), (n + 16,)).to(dev)
    x = raw[4:4 + n].view(c, 2 * i, s)
    assert x.data_ptr() % 8
    _k5b_check(dev, x, i)


@pytest.mark.parametrize("i, s, c, off", [(4, 42, 8, 0), (4, 44, 8, 0), (4, 1032, 8, 0),
                                          (4, 128, 12, 0), (0, 128, 8, 0), (4, 128, 8, 2)])
def test_k5b_c_side_refuses_other_shapes(dev, i, s, c, off):
    """The C side refuses, before any launch, every shape outside the gate
    (S % 4, S % 8, S > 1024, C % 8, I < 1) and a base that is not 4-byte
    aligned; its attributes refuse the same shapes."""
    from dpdk_dc_sand_tpu_torch import _build

    lib = _build.library()
    x = torch.zeros(2 * 4 * 1032 * 8 + 16, dtype=torch.int8, device=dev)
    out = torch.zeros(8 * 16, device=dev)
    err = lib.xcorr_turned_launch(x.data_ptr() + off, out.data_ptr(), out.data_ptr(), i, s, c,
                                  torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0
    torch.cuda.synchronize()
    assert bool((out == 0).all())
    if not off:
        with pytest.raises(RuntimeError, match="xcorr_turned_attributes"):
            xcorr.turned_kernel_attributes(i, s, c)


@pytest.mark.parametrize("stop", sorted(xcorr.K5B_STOPS))
@pytest.mark.parametrize("i, s, c", [(17, 256, 264), (160, 1024, 24)])
def test_k5b_stops_write_what_they_keep(dev, stop, i, s, c):
    """A stop with the stores writes zeros over every output; one without
    writes nothing; neither counts as a K5b launch."""
    x = _int8(np.random.default_rng(16), (c, 2 * i, s)).to(dev)
    vre, vim = (torch.ones((c, i, i), device=dev) for _ in range(2))
    before = xcorr.correlate_turned_fused.launches
    xcorr.correlate_turned_fused_stop(x, i, vre, vim, stop)
    want = torch.zeros_like(vre) if "store" in stop else torch.ones_like(vre)
    assert torch.equal(vre, want) and torch.equal(vim, want)
    assert xcorr.correlate_turned_fused.launches == before
    with pytest.raises(RuntimeError, match="xcorr_turned_stop"):  # the C side refuses S = 44
        xcorr.correlate_turned_fused_stop(x[:, :, :44].contiguous(), i, vre, vim, stop)


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


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("fft", [1000, 1024, 4096, 65536])
@pytest.mark.parametrize("taps", [1, 4, 8, 16, 17, 40])
def test_k6_every_plan_is_bit_exact_against_plain(dev, dtype, fft, taps):
    """Every copy mode (async, scalar), register-ring depth and pass
    count the planner picks: S below and above one block's run, an aligned
    base, one a sample in (``x[1:]``) and one four samples in, a batch of 1
    and of 3."""
    import math

    rng = np.random.default_rng(fft + taps + len(dtype))
    win = torch.from_numpy(rng.normal(0, 1, (taps, fft)).astype(np.float32))
    copies = set()
    for s, off, b in [(5, 0, 3), (300, 0, 1), (300, 1, 3), (5, 1, 1), (300, 4, 1)]:
        n = b * (s + taps - 1) * fft
        if dtype == "int8":
            raw = torch.from_numpy(rng.integers(-128, 128, n + off, dtype=np.int8))
        else:
            raw = torch.from_numpy(rng.normal(0, 50, n + off).astype(np.float32))
        frames = raw.to(dev)[off:].view(b, s + taps - 1, fft)
        plan = pfb_fir._fir_plan(fft, taps, frames.element_size(),
                                 math.gcd(frames.data_ptr(), 16), n_spectra=s)
        copies.add(plan.copy)
        before = pfb_fir.pfb_fir_frames.launches
        got = pfb_fir.pfb_fir_frames(frames, win.to(dev))
        assert pfb_fir.pfb_fir_frames.launches == before + 1
        ref = pfb_fir.pfb_fir_reference(raw[off:].view(b, s + taps - 1, fft), win)
        assert torch.equal(got.cpu(), ref), (s, off, b, plan)
    assert copies == {"async", "scalar"}


def test_k6_kernel_attributes_show_no_spills(dev):
    """Each body's registers leave room for three blocks of 4 warps an SM,
    and none spills (``cudaFuncGetAttributes``)."""
    for depth in (4, 8, 16):
        for f32 in (False, True):
            for copy in pfb_fir.COPY_MODES:
                at = pfb_fir.kernel_attributes(depth, f32, copy)
                assert at["local_bytes"] == 0, (depth, f32, copy, at)
                assert at["regs"] * 128 * 3 <= 65536, (depth, f32, copy, at)


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


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 4097, 4099, (1 << 20) + 2, (1 << 22) + 3])
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


_FIR_TAPS = [1, 3, 4, 5, 8, 16, 17, 40]
_FIR_PLANES = {"bf16": (ff.k1_fir, "bfloat16"), "f32": (ff.k1_fir_f32, "float32")}


def _fir_streams(rng, fft, taps, s, pad=0):
    """18 int8 streams whose coarse delays give every start % 16 from 0 to 15
    (streams 1..16) and clamp at both ends (streams 0 and 17): ``x`` ``[18,
    n_in]`` (a view of rows ``pad`` bytes longer, so the stream stride is
    ``n_in + pad``) and the clamped starts."""
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    out_len = (s + taps - 1) * fft
    n_in = out_len + 64 + 7  # room for every start; an end off 4 bytes
    raw = torch.from_numpy(rng.integers(-128, 128, (18, n_in + pad), dtype=np.int8))
    cd = torch.arange(-1, 17, dtype=torch.int64) + 32 * torch.from_numpy(
        rng.integers(0, 2, 18))
    cd[0], cd[-1] = -9, n_in  # both clamp, as dynamic_slice would
    return raw[:, :n_in], clamp_starts(cd, n_in, out_len)


def _fir_check(dev, plane, x, starts, win, s):
    """The FIR pass of ``plane`` on ``x`` against its plain version on the
    card (the same rounded f32 products and sums), bit for bit; one launch."""
    fir, dt = _FIR_PLANES[plane]
    before = fir.launches
    got = fir(x.to(dev), starts.to(dev), win.to(dev), n_spectra=s)
    assert fir.launches == before + 1
    want = ff.k1_fir_reference(x.to(dev), starts.to(dev), win.to(dev), n_spectra=s,
                               dft_dtype=dt)
    assert got.dtype == want.dtype and got.shape == (x.shape[0], s, win.shape[1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("plane", list(_FIR_PLANES))
@pytest.mark.parametrize("fft", [1024, 65536])
@pytest.mark.parametrize("taps", _FIR_TAPS)
@pytest.mark.parametrize("s", [1, 5, 257])
def test_k1_fir_pass_at_every_start_phase_is_bit_exact(dev, plane, fft, taps, s):
    """K1's FIR pass in both plane types at every start % 16 in one batch
    (the two-word copies joined by the funnel shift), starts that clamp at
    both ends, S off the register ring's chunks (1, 5) and past a block's run
    (257: two runs), several streams a block (S = 1, 5), every body (the
    register rings of 4, 8 and 16 rows; the long body past 16 taps), on
    contiguous streams and on a view whose stream stride is odd (every
    stream another alignment): bit for bit."""
    rng = np.random.default_rng(fft + 31 * taps + s)
    win = torch.from_numpy(rng.standard_normal((taps, fft)).astype(np.float32))
    for pad in (0, 3):
        x, starts = _fir_streams(rng, fft, taps, s, pad)
        _fir_check(dev, plane, x, starts, win, s)


@pytest.mark.parametrize("plane", list(_FIR_PLANES))
@pytest.mark.parametrize("taps, s", [(16, 4), (17, 1), (4, 5)])
def test_k1_fir_pass_at_fft_2_22_is_bit_exact(dev, plane, taps, s):
    """The FIR pass at fft 2^22 (8192 lane blocks; the three-pass route's),
    every start % 16 and both clamps, S = 4 as at full width: bit for bit."""
    rng = np.random.default_rng(taps + s)
    win = torch.from_numpy(rng.standard_normal((taps, 1 << 22)).astype(np.float32))
    x, starts = _fir_streams(rng, 1 << 22, taps, s)
    _fir_check(dev, plane, x, starts, win, s)


@pytest.mark.parametrize("plane", list(_FIR_PLANES))
@pytest.mark.parametrize("fft, taps, s", [(2048, 16, 300), (65536, 16, 20), (1024, 40, 7)])
def test_k1_fir_pass_on_rowed_bytes_and_k7_frames_is_bit_exact(dev, plane, fft, taps, s):
    """The same bytes as flat streams and as the wire-rowed view (``[B,
    rows, 256]`` flattened), with unaligned starts; and K7's first pass, the
    frames ``[B, n_frames, fft]`` viewed ``[B, n_frames·fft]`` with every
    start 0: bit for bit, K7's frames also against K7's own f32 FIR."""
    rng = np.random.default_rng(fft + taps + s)
    win = torch.from_numpy(rng.standard_normal((taps, fft)).astype(np.float32))
    x, starts = _fir_streams(rng, fft, taps, s)
    n_in = -(-x.shape[1] // 256) * 256
    rowed = torch.zeros((18, n_in), dtype=torch.int8)
    rowed[:, :x.shape[1]] = x
    _fir_check(dev, plane, rowed.view(18, -1, 256).reshape(18, -1), starts, win, s)
    frames = torch.from_numpy(rng.integers(-128, 128, (5, s + taps - 1, fft), dtype=np.int8))
    zeros = torch.zeros(5, dtype=torch.int64)
    _fir_check(dev, plane, frames.view(5, -1), zeros, win, s)
    if plane == "f32":
        got = ff.k1_fir_f32(frames.view(5, -1).to(dev), zeros.to(dev), win.to(dev), n_spectra=s)
        assert torch.equal(got, ff._dit_fir(frames.to(dev), win.to(dev)))


def test_k1_fir_bodies_do_not_spill(dev):
    """Every body of K1's FIR pass (both planes, every register-ring depth,
    the short-run bodies and the long body, and each stop's: the
    reference's fir into either plane, P5's fir, P2's fir and deint, and the
    copies-only stops, the dma stop's in both output types): 0 local (spill)
    bytes; the ring bodies hold the
    64 KB ring at two blocks an SM or more, the short-run bodies their 24 KB
    ring at three or more."""
    bodies = ff.k1_fir_attributes()
    assert len(bodies) == 2 * 7 + 5 * 7 + 4
    for name, at in bodies.items():
        assert at["local_bytes"] == 0, (name, at)
        assert at["max_threads"] >= 128, (name, at)
        if name.endswith("s"):
            assert at["smem_bytes"] >= 24 * 1024 and at["blocks_per_sm"] >= 3, (name, at)
        elif not name.endswith("/long"):
            assert at["smem_bytes"] >= 64 * 1024 and at["blocks_per_sm"] >= 2, (name, at)


def test_k1_fir_launch_refuses_a_plan_that_does_not_fit(dev):
    """The C entry refuses a depth that does not hold the taps or is no
    body's, more streams a block than a block holds, an empty run, and the
    short-run body on the long body or past 4 spectra a run, before any
    launch."""
    from dpdk_dc_sand_tpu_torch import _build

    lib = _build.library()
    x = torch.zeros((2, 20 * 1024), dtype=torch.int8, device=dev)
    starts = torch.zeros(2, dtype=torch.int64, device=dev)
    win = torch.zeros((8, 1024), dtype=torch.float32, device=dev)
    plane = torch.empty((2, 4, 1024), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for plan in ((4, 4, 1, 0), (8, 4, 257, 0), (8, 0, 1, 0), (12, 4, 1, 0),
                 (0, 4, 1, 1), (8, 5, 1, 1), (8, 4, 1, 2)):
        err = lib.k1_fir_launch(x.data_ptr(), x.stride(0), starts.data_ptr(), win.data_ptr(),
                                plane.data_ptr(), 2, 4, 8, 1024, *plan, stream)
        assert err != 0, plan
    assert lib.k1_fir_launch(x.data_ptr(), x.stride(0), starts.data_ptr(), win.data_ptr(),
                             plane.data_ptr(), 2, 4, 8, 1024, *ff._fir_plan(2, 4, 8, 1024),
                             stream) == 0


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


def _stage_operands(fft, batch, s, taps, seed, dft_dtype):
    """A FIR plane of the operand type and rotation planes that keep the
    codes near 50 rms, on the CPU."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-64, 64, (batch, (s + taps - 1) * fft), dtype=np.int8))
    plane = ff.k1_fir_reference(x, torch.zeros(batch, dtype=torch.int64),
                                default_window(taps, fft), n_spectra=s, dft_dtype=dft_dtype)
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, batch).astype(np.float32))
    rc, rs = (r.reshape(batch, fft // 2) for r in ff.fine_rotation_planes(
        fd, -1.5 * fd, n_channels=fft // 2, quant_scale=0.068 * (1024 / fft) ** 0.5))
    return plane, rc, rs


def _stages_match_plain(dev, fft, dft_dtype):
    """The three-pass stages through their wrappers at a split their tiles
    cover but K1 gives the two-pass route: stage A then stage B against the
    plain stages, and stage B alone on the kernel's own T against the plain
    stage B on that T, each within the type's code contract."""
    n1, n2 = ff._split_ct(fft)
    f32 = dft_dtype == "float32"
    stage_a, stage_b = ((ff.k1_stage_a_f32, ff.k1_stage_b_f32) if f32 else
                        (ff.k1_stage_a, ff.k1_stage_b))
    plane, rc, rs = _stage_operands(fft, 2, 2, 4, fft + f32, dft_dtype)
    before = (stage_a.launches, stage_b.launches)
    tr, ti = stage_a(plane.to(dev), n1=n1, n2=n2)
    got = stage_b(tr, ti, rc.to(dev), rs.to(dev), n1=n1, n2=n2)
    assert (stage_a.launches, stage_b.launches) == (before[0] + 1, before[1] + 1)
    assert tr.shape == ti.shape == (2, 2, n1, n2) and tr.dtype == plane.dtype
    frac = 1e-4 if f32 else 1e-3
    ref = ff.k1_stage_b_reference(*ff.k1_stage_a_reference(plane, n1=n1, n2=n2,
                                                           dft_dtype=dft_dtype),
                                  rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r, frac)
    own = ff.k1_stage_b_reference(tr.cpu(), ti.cpu(), rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, r in zip(got, own):
        _codes_close(g.cpu(), r, frac)


@pytest.mark.parametrize("fft", [1 << 17, 1 << 18])
def test_k1_f32_kernel_above_65536_matches_plain(dev, fft):
    """The three-pass route's f32 stages (FFMA) through their own wrappers
    above the old cap (N1 x N2 = 512 x 256, 512 x 512), off the engines'
    route there: within 1 code on <= 1e-4 of samples, whole and stage B
    alone."""
    _stages_match_plain(dev, fft, "float32")


@pytest.mark.parametrize("fft", [1 << 17, 1 << 18])
def test_k1_bf16_stages_above_65536_match_plain(dev, fft):
    """The three-pass route's bf16 stages (tensor cores) through their own
    wrappers at 512 x 256 and 512 x 512: within 1 code on <= 1e-3 of
    samples, whole and stage B alone."""
    _stages_match_plain(dev, fft, "bfloat16")


@pytest.mark.parametrize("fft, taps, s, batch", [(2048, 4, 9, 3), (65536, 16, 130, 2),
                                                 (1 << 17, 20, 3, 2), (1 << 20, 4, 2, 2)])
def test_k1_fir_f32_pass_is_bit_exact_against_plain(dev, fft, taps, s, batch):
    """K1's FIR pass into the f32 plane: the exact f32 tap-order sums, bit for
    bit, over flat streams and the rowed view's bytes, starts that clamp at
    both ends and an unaligned one, runs longer than a block's and taps above
    the register ring."""
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    rng = np.random.default_rng(fft + taps + 1)
    out_len = (s + taps - 1) * fft
    n_in = -(-(out_len + 1000) // 512) * 512
    raw = torch.from_numpy(rng.integers(-128, 128, (batch, n_in), dtype=np.int8))
    cd = torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int64))
    cd[0] = -7
    cd[-1] = n_in
    if batch > 2:
        cd[1] = 3
    starts = clamp_starts(cd, n_in, out_len)
    win = default_window(taps, fft)
    want = ff.k1_fir_reference(raw, starts, win, n_spectra=s, dft_dtype="float32")
    before = (ff.k1_fir_f32.launches, ff.k1_fir.launches)
    for x in (raw, raw.reshape(batch, -1, 512).reshape(batch, -1)):
        got = ff.k1_fir_f32(x.to(dev), starts.to(dev), win.to(dev), n_spectra=s)
        assert got.dtype == torch.float32 and got.shape == (batch, s, fft)
        assert torch.equal(got.cpu(), want)
    assert (ff.k1_fir_f32.launches, ff.k1_fir.launches) == (before[0] + 2, before[1])


@pytest.mark.parametrize("fft", [2048, 65536, 1 << 17, 1 << 18, 1 << 20])
@pytest.mark.parametrize("quantise", [True, False])
def test_k1_f32_two_passes_match_plain(dev, fft, quantise):
    """K1 with f32 DFT operands (N1 x N2 = 16 x 128, 256 x 256, 512 x 256,
    512 x 512, 1024 x 1024: the KC = 16 and 8 plans of the FFMA DFT pass),
    one start unaligned and one clamped at the stream's end: one f32 FIR
    pass and one f32 DFT pass, no stage of the three-pass route. int8 within 1 code on <= 1e-3 of samples;
    the f32 output within rtol 1e-4 / atol 1e-2 on every sample, and the
    int8 output the requant of the f32 output bit for bit."""
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    taps, s, batch = 4, (5 if fft <= 65536 else 2), 2
    rng = np.random.default_rng(fft + 7 * quantise)
    out_len = (s + taps - 1) * fft
    n_in = out_len + 999
    x = torch.from_numpy(rng.integers(-64, 64, (batch, n_in), dtype=np.int8))
    starts = clamp_starts(torch.tensor([3, n_in]), n_in, out_len)
    assert starts.tolist() == [3, n_in - out_len]
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, batch).astype(np.float32))
    rc, rs = (r.reshape(batch, fft // 2) for r in ff._rotation_planes(
        fd, -1.5 * fd, fft // 2, 0.068 * (1024 / fft) ** 0.5, (fft // 2,)))
    win = default_window(taps, fft)
    n1, n2 = ff._split_ct(fft)
    kw = dict(n_spectra=s, n1=n1, n2=n2, dft_dtype="float32", quantise=quantise)
    counters = (ff.k1_fir_f32, ff.k1_dft_f32, ff.k1_stage_a_f32, ff.k1_stage_b_f32, ff.k1_fir,
                ff.k1_dft)
    before = [f.launches for f in counters]
    got = ff._launch(x.to(dev), starts.to(dev), win.to(dev), rc.to(dev), rs.to(dev), **kw)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0, 0, 0]
    ref = ff.fengine_fused_reference(x, starts, win, rc, rs, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape and g.dtype == r.dtype
        if quantise:
            _codes_close(g.cpu(), r)
        else:
            d = (g.cpu() - r).abs()
            assert bool((d <= 1e-2 + 1e-4 * r.abs()).all()), float(d.max())
    if not quantise:
        q8 = ff._launch(x.to(dev), starts.to(dev), win.to(dev), rc.to(dev), rs.to(dev),
                        **dict(kw, quantise=True))
        for g, q in zip(got, q8):
            assert torch.equal(torch.round(g).clamp(-127, 127).to(torch.int8), q)


@pytest.mark.parametrize("n1, n2, kc, sb", [(16, 128, 16, 4), (256, 256, 16, 2),
                                            (512, 256, 16, 2), (512, 512, 16, 1),
                                            (1024, 1024, 8, 1), (8, 128, 8, 8)])
def test_k1_f32_dft_pass_attributes_show_no_spills(dev, n1, n2, kc, sb):
    """The FFMA DFT pass's body at each plan spills nothing; KC and SB follow
    N2 (KC * SB * N2 = 8192), the plan fits the 232,448 bytes a block may
    use, and the split goes to the two f32 passes."""
    at = ff.k1_dft_f32_attributes(n1, n2)
    assert at["local_bytes"] == 0, at
    assert (at["kc"], at["sb"], at["threads"]) == (kc, sb, 256), at
    assert at["kc"] * at["sb"] * n2 == 8192 and at["ktb"] * n2 == 8192, at
    assert at["stages"] == 4 and at["smem_bytes"] <= 232448, at
    assert ff._k1_body(n1, n2, "float32") == "two_pass_f32"


@pytest.mark.parametrize("fft, body", [(1024, "two_pass_f32"), (65536, "two_pass_f32"),
                                       (1 << 22, "three_pass_f32")])
def test_k1_f32_body_follows_the_split(dev, fft, body):
    """N1 = 8 (fft 1024) and the flagship split (256 x 256) run the two f32
    passes; 2048 x 2048 (fft 2^22), where the f32 DFT pass has no plan, the
    three-pass route: the f32 FIR pass, then the FFMA stages A and B
    (decided before any launch, no fallback). Each is launched and held to
    plain within 1 code on <= 1e-4 of samples (plain on the card at 2^22)."""
    n1, n2 = ff._split_ct(fft)
    assert ff._k1_body(n1, n2, "float32") == body
    if fft > 65536:
        with pytest.raises(ValueError):
            ff.k1_dft_f32_attributes(n1, n2)
    taps, s, lead = 4, (2 if fft > 65536 else 3), (1, 2)
    rng = np.random.default_rng(fft + 1)
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16 * (1024 / fft) ** 0.5,
              dft_dtype="float32")
    counters = (ff.k1_fir_f32, ff.k1_dft_f32, ff.k1_stage_a_f32, ff.k1_stage_b_f32)
    before = [f.launches for f in counters]
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    three = int(body == "three_pass_f32")
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1 - three, three, three]
    if three:  # the plain version on the card: on the CPU fft 2^22 in f32 takes minutes
        rc, rs = (r.reshape(2, -1) for r in ff.fine_rotation_planes(
            torch.from_numpy(fd).to(dev), torch.from_numpy(ph).to(dev), n_channels=fft // 2,
            quant_scale=kw["quant_scale"]))
        ref = ff.fengine_fused_reference(
            torch.from_numpy(frames).to(dev).reshape(2, -1), torch.zeros(2, dtype=torch.int64,
                                                                         device=dev),
            default_window(taps, fft, dev), rc, rs, n_spectra=s, n1=n1, n2=n2,
            dft_dtype="float32")
        got = [g.reshape(2, s, -1) for g in got]
    else:
        ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r.cpu(), 1e-4)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantise", [True, False])
def test_k1_n1_8_two_passes_match_plain(dev, dft_dtype, quantise):
    """fft 1024 (N1 = 8) on its two passes in both forms: the bf16 DFT pass
    takes 16 spectra a unit (the last unit of each stream partial at S =
    37), the f32 pass 8. int8 within 1 code on <= 1e-3 of samples (bf16) or
    <= 1e-4 (f32); without the requant the f32 form within rtol 1e-4 / atol
    1e-2 everywhere and the bf16 form below 1 code unit everywhere and
    within that bound on all but 1e-2."""
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    fft, taps, s, batch = 1024, 16, 37, 3
    f32 = dft_dtype == "float32"
    rng = np.random.default_rng(8 + f32 + 2 * quantise)
    out_len = (s + taps - 1) * fft
    n_in = out_len + 999
    x = torch.from_numpy(rng.integers(-64, 64, (batch, n_in), dtype=np.int8))
    starts = clamp_starts(torch.tensor([3, 500, n_in]), n_in, out_len)
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, batch).astype(np.float32))
    rc, rs = (r.reshape(batch, fft // 2) for r in ff._rotation_planes(
        fd, -1.5 * fd, fft // 2, 1 / 16, (fft // 2,)))
    win = default_window(taps, fft)
    assert ff._split_ct(fft) == (8, 128)
    kw = dict(n_spectra=s, n1=8, n2=128, dft_dtype=dft_dtype, quantise=quantise)
    passes = (ff.k1_fir_f32, ff.k1_dft_f32) if f32 else (ff.k1_fir, ff.k1_dft)
    others = (ff.k1_stage_a, ff.k1_stage_b, ff.k1_stage_a_f32, ff.k1_stage_b_f32,
              *((ff.k1_fir, ff.k1_dft) if f32 else (ff.k1_fir_f32, ff.k1_dft_f32)))
    before = [f.launches for f in passes + others]
    got = ff._launch(x.to(dev), starts.to(dev), win.to(dev), rc.to(dev), rs.to(dev), **kw)
    assert [f.launches - b for f, b in zip(passes + others, before)] == [1, 1] + [0] * 6
    ref = ff.fengine_fused_reference(x, starts, win, rc, rs, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape == (batch, s, fft // 2) and g.dtype == r.dtype
        if quantise:
            _codes_close(g.cpu(), r, 1e-4 if f32 else 1e-3)
        else:
            d = (g.cpu() - r).abs()
            over = d > 1e-2 + 1e-4 * r.abs()
            if f32:
                assert not bool(over.any()), float(d.max())
            else:
                assert float(d.max()) < 1.0 and float(over.float().mean()) <= 1e-2


def test_k1_stage_bodies_show_no_spills_and_n1_8_has_a_plan(dev):
    """The three-pass stages in both forms at 2048 x 2048 spill nothing,
    each within the 232,448 bytes a block may use and resident on an SM.
    The bf16 DFT pass has its N1 = 8 plan (16 spectra of 8 rows, KC 128)
    within the same bytes and its 128-register cap; that body spills a few
    bytes at every plan, as it did before N1 = 8 had one (PERF.md)."""
    at = ff.k1_dft_attributes(8, 128)
    assert at["kc"] == 128 and at["regs"] <= 128 and at["smem_bytes"] <= 232448, at
    for dt in ("bfloat16", "float32"):
        for stage, at in ff.k1_stage_attributes(2048, 2048, dt).items():
            assert at["local_bytes"] == 0, (dt, stage, at)
            assert at["threads"] == 256 and at["smem_bytes"] <= 232448, (dt, stage, at)
            assert at["blocks_per_sm"] >= 1, (dt, stage, at)


def test_k1_f32_two_passes_span_plane_groups(dev, monkeypatch):
    """Five streams through a scratch of two f32 planes: three groups, each an
    f32 FIR pass and an f32 DFT pass; the two passes through their own
    wrappers on all five streams at once give the same bytes."""
    fft, s, taps, b = 4096, 5, 4, 5
    monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * s * fft * 4)
    rng = np.random.default_rng(9)
    n_in = (s + taps - 1) * fft + 64
    x = torch.from_numpy(rng.integers(-64, 64, (b, n_in), dtype=np.int8))
    starts = torch.from_numpy(rng.integers(0, 64, b).astype(np.int64))
    rc, rs = (torch.from_numpy(rng.uniform(-0.05, 0.05, (b, fft // 2)).astype(np.float32))
              for _ in range(2))
    win = default_window(taps, fft)
    n1, n2 = ff._split_ct(fft)
    kw = dict(n_spectra=s, n1=n1, n2=n2, dft_dtype="float32", quantise=True)
    args = [t.to(dev) for t in (x, starts, win, rc, rs)]
    before = (ff.k1_fir_f32.launches, ff.k1_dft_f32.launches)
    got = ff._launch(*args, **kw)
    assert (ff.k1_fir_f32.launches, ff.k1_dft_f32.launches) == (before[0] + 3, before[1] + 3)
    whole = ff.k1_dft_f32(ff.k1_fir_f32(*args[:3], n_spectra=s), *args[3:], n1=n1, n2=n2)
    ref = ff.fengine_fused_reference(x, starts, win, rc, rs, **kw)
    for g, m, r in zip(got, whole, ref):
        _codes_close(g.cpu(), r)
        assert torch.equal(g, m)


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


def _k7_streams(fft, batch, s, taps, seed):
    """Frames ``[batch, s + taps - 1, fft]``, the default window and rotation
    planes whose gain keeps the int8 codes near 50 rms (the flagship's level,
    chip_smoke.py's QUANT_SCALE), all on the CPU."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(-64, 64, (batch, s + taps - 1, fft), dtype=np.int8))
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, batch).astype(np.float32))
    rc, rs = (r.reshape(batch, fft // 2) for r in ff._rotation_planes(
        fd, -1.5 * fd, fft // 2, 0.068 * (1024 / fft) ** 0.5, (fft // 2,)))
    return frames, default_window(taps, fft), rc, rs


@pytest.mark.parametrize("n1, n2", [(16, 64), (32, 64), (64, 64), (16, 128), (256, 128),
                                    (256, 256), (512, 512), (1024, 1024)])
def test_k7_dft_pass_matches_plain(dev, n1, n2):
    """K7's DFT pass alone on K1's FIR plane, every chunk plan (KC 64, 32,
    16): within 1 code on <= 1e-3 of samples of ``dit_dft_reference``."""
    fft = 2 * n1 * n2
    b, s = 2, (3 if fft <= 1 << 17 else 1)
    frames, win, rc, rs = _k7_streams(fft, b, s, 4, seed=n1 + n2)
    plane = ff.k1_fir_reference(frames.reshape(b, -1), torch.zeros(b, dtype=torch.int64), win,
                                n_spectra=s)
    before = ff.dit_dft.launches
    got = ff.dit_dft(plane.to(dev), rc.to(dev), rs.to(dev), n1=n1, n2=n2)
    assert ff.dit_dft.launches == before + 1
    for g, r in zip(got, ff.dit_dft_reference(plane, rc, rs, n1=n1, n2=n2)):
        assert g.is_cuda and g.shape == r.shape and g.dtype == torch.int8
        _codes_close(g.cpu(), r)


@pytest.mark.parametrize("fft", [2048, 4096, 65536, 1 << 17])
def test_k7_two_pass_kernel_matches_plain(dev, fft):
    """bf16 K7 (deint="matmul": 16 x 64, 32 x 64, 256 x 128, 256 x 256)
    through K1's FIR pass and the DFT pass, at ~50 codes rms as
    test_k1_two_pass_kernel_above_65536_matches_plain: within 1 code on
    <= 1e-3 of samples; one K7 call, one FIR pass, one DFT pass."""
    taps, s, lead = 4, 3, (1, 2)
    rng = np.random.default_rng(fft + 11)
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=0.068 * (1024 / fft) ** 0.5, deint="matmul")
    before = (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches)
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches) == tuple(
        b + 1 for b in before)
    ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape
        _codes_close(g.cpu(), r)


def test_k7_two_pass_spans_plane_groups(dev, monkeypatch):
    """Five streams through a scratch of two planes: three groups, each a FIR
    pass and a DFT pass, the outputs those of the plain K7."""
    fft, s, taps, b = 4096, 5, 4, 5
    monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * s * fft * 2)
    frames, win, rc, rs = _k7_streams(fft, b, s, taps, seed=5)
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    before = (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches)
    got = ff.fengine_dit(frames.to(dev), win.to(dev), rc.to(dev), rs.to(dev), n1=n1, n2=n2)
    assert (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches) == (
        before[0] + 1, before[1] + 3, before[2] + 3)
    for g, r in zip(got, ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2)):
        _codes_close(g.cpu(), r)


_K7_N8 = [(64, "matmul"), (128, "matmul"), (256, "matmul"), (512, "auto"), (1024, "matmul"),
          (2048, "bitcast")]


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fft, deint", _K7_N8)
def test_k7_n1_8_splits_run_two_passes_and_match_plain(dev, fft, deint, dft_dtype):
    """Every N1 = 8 split (N2 from 4 to 128) runs its operand type's two
    passes: one K7 call, one FIR pass and one DFT pass (the N1 = 8 plan),
    no other pass; within 1 code on <= 1e-3 (bf16) or 1e-4 (f32) of samples
    of the plain version, at ~50 codes rms, over streams whose spectra do
    not fill the last unit."""
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    assert n1 == 8
    f32 = dft_dtype == "float32"
    frames, win, rc, rs = _k7_streams(fft, 3, 37, 4, seed=fft + f32)
    counters = (ff.fengine_dit, ff.k1_fir, ff.dit_dft, ff.k1_fir_f32, ff.dit_dft_f32,
                ff.dit_stage_a, ff.dit_stage_b, ff.dit_stage_a_f32, ff.dit_stage_b_f32)
    before = [c.launches for c in counters]
    got = ff.fengine_dit(frames.to(dev), win.to(dev), rc.to(dev), rs.to(dev), n1=n1, n2=n2,
                         dft_dtype=dft_dtype)
    want = [1, 0, 0, 0, 0, 0, 0, 0, 0]
    want[3 if f32 else 1] = want[4 if f32 else 2] = 1
    assert [c.launches - b for c, b in zip(counters, before)] == want
    ref = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r, max_frac=1e-4 if f32 else 1e-3)


@pytest.mark.parametrize("n2", [4, 8, 16, 32, 64, 128])
def test_k7_n1_8_plans_show_no_spills(dev, n2):
    """N1 = 8's DFT-pass plans: bf16 16 spectra a unit (128 T rows), 8 at N2
    = 128, within 128 registers; f32 KC = 8 with SB = 2048 / (8·H) spectra;
    both fit a block's 232,448 bytes and spill nothing."""
    at = ff.dit_dft_attributes(8, n2)
    assert at["local_bytes"] == 0 and at["regs"] <= 128, at
    assert (at["kc"], at["sb"]) == ((64, 8) if n2 == 128 else (128, 16)), at
    assert at["smem_bytes"] <= 232448, at
    a32 = ff.dit_dft_f32_attributes(8, n2)
    assert a32["local_bytes"] == 0, a32
    h = n2 // (1 if n2 < 8 else 2)
    assert (a32["kc"], a32["sb"], a32["threads"]) == (8, 2048 // (8 * h), 256), a32
    assert ff._dit_body(8, n2, "bfloat16") == "two_pass"
    assert ff._dit_body(8, n2, "float32") == "two_pass_f32"


@pytest.mark.parametrize("n1, n2, kc", [(16, 64, 16), (32, 64, 32), (256, 128, 64),
                                        (256, 256, 64), (512, 512, 32), (1024, 1024, 16)])
def test_k7_dft_pass_attributes_show_no_spills(dev, n1, n2, kc):
    """The DFT pass's body at each chunk plan keeps its 512 threads within
    128 registers and spills nothing; KC follows N2 (64 rows up to N2 = 256,
    32 at 512, 16 at 1024), the ring has 3 or 4 stages, the plan fits the
    232,448 bytes a block may use, and the wrapper routes the split to the
    two passes."""
    at = ff.dit_dft_attributes(n1, n2)
    assert at["local_bytes"] == 0, at
    assert at["regs"] <= 128, at
    assert at["kc"] == kc and at["stages"] in (3, 4) and at["smem_bytes"] <= 232448, at
    assert ff._dit_body(n1, n2, "bfloat16") == "two_pass"


def _k7_three_pass_case(dev, fft, dft_dtype, nb, s, seed):
    """K7 at fft on the three-pass route through ``fengine_dit``: one call,
    one FIR pass, one stage A and one stage B of the operand type, no other
    pass; within the form's code contract of the plain version on the card
    (~50 codes rms)."""
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    f32 = dft_dtype == "float32"
    sfx = "_f32" if f32 else ""
    assert ff._dit_body(n1, n2, dft_dtype) == "three_pass" + sfx
    frames, win, rc, rs = (t.to(dev) for t in _k7_streams(fft, nb, s, 2, seed=seed))
    counters = (ff.fengine_dit, ff.k1_fir, ff.dit_stage_a, ff.dit_stage_b, ff.k1_fir_f32,
                ff.dit_stage_a_f32, ff.dit_stage_b_f32, ff.dit_dft, ff.dit_dft_f32, ff.k1_stage_a)
    before = [c.launches for c in counters]
    got = ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    want = [1, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    for i in ((4, 5, 6) if f32 else (1, 2, 3)):
        want[i] = 1
    assert [c.launches - b for c, b in zip(counters, before)] == want
    ref = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape and g.dtype == torch.int8
        _codes_close(g, r, max_frac=1e-4 if f32 else 1e-3)


def test_k7_bf16_at_fft_2_23_runs_the_three_pass_route(dev):
    """At 2048 x 2048 (fft 2^23) a 16-row chunk's four bf16 T planes alone
    overflow shared memory: the DFT pass has no plan and the split runs the
    three passes, T through device memory."""
    with pytest.raises(ValueError, match="shared-memory plan"):
        ff.dit_dft_attributes(2048, 2048)
    _k7_three_pass_case(dev, 1 << 23, "bfloat16", 1, 2, seed=23)


@pytest.mark.parametrize("fft", [1 << 21, 1 << 22])
def test_k7_f32_at_n2_1024_runs_the_three_pass_route(dev, fft):
    """f32 at 1024 x 1024 (fft 2^21) and 2048 x 1024 (fft 2^22): the f32
    pass's stage-A tile cannot hold a spectrum's 2·N2 columns, so the split
    runs the three f32 passes (FFMA, exact f32)."""
    with pytest.raises(ValueError, match="shared-memory plan"):
        ff.dit_dft_f32_attributes(*ff._deint_mode(fft // 2, "matmul")[1:])
    _k7_three_pass_case(dev, fft, "float32", 2, 2, seed=fft)


@pytest.mark.parametrize("dft_dtype, fft", [("bfloat16", 1 << 23), ("float32", 1 << 21)])
def test_k7_three_pass_stages_alone_match_plain(dev, dft_dtype, fft):
    """Each three-pass stage alone: stage A (K1's kernel on the [N1, 2·N2]
    view) against ``dit_stage_a_reference`` on the card (f32 bit for bit at
    1024 x 1024; bf16 T within one bf16 rounding on <= 1e-3 of values, as
    K1's stage A), and stage B on the plain T against
    ``dit_stage_b_reference``, each once on its wrapper's counter."""
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    f32 = dft_dtype == "float32"
    frames, win, rc, rs = (t.to(dev) for t in _k7_streams(fft, 1, 2, 2, seed=fft + 1))
    fir = ff.k1_fir_f32 if f32 else ff.k1_fir
    plane = fir(frames.view(1, -1), torch.zeros(1, dtype=torch.int64, device=dev), win,
                n_spectra=2)
    stage_a, stage_b = ((ff.dit_stage_a_f32, ff.dit_stage_b_f32) if f32 else
                        (ff.dit_stage_a, ff.dit_stage_b))
    before = (stage_a.launches, stage_b.launches)
    tr, ti = stage_a(plane, n1=n1, n2=n2)
    wr, wi = ff.dit_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, w in zip((tr, ti), (wr, wi)):
        assert g.shape == w.shape == (1, 2, n1, 2 * n2) and g.dtype == w.dtype
        if f32:
            assert torch.equal(g, w)
        else:
            assert float((g != w).float().mean()) <= 1e-3
    got = stage_b(wr.contiguous(), wi.contiguous(), rc, rs, n1=n1, n2=n2)
    assert (stage_a.launches, stage_b.launches) == (before[0] + 1, before[1] + 1)
    for g, r in zip(got, ff.dit_stage_b_reference(wr, wi, rc, rs, n1=n1, n2=n2,
                                                  dft_dtype=dft_dtype)):
        _codes_close(g, r, max_frac=1e-4 if f32 else 1e-3)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k7_three_passes_span_plane_groups(dev, monkeypatch, dft_dtype):
    """Three streams through a scratch of one plane and its T: three groups,
    each a FIR pass, a stage A and a stage B, the outputs those of the
    plain K7 (f32 at 1024 x 1024; bf16 forced onto the three passes at 128 x
    128 by a stubbed plan query)."""
    f32 = dft_dtype == "float32"
    fft, s, b = (1 << 21, 1, 3) if f32 else (1 << 15, 4, 3)
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    if not f32:
        real = ff._has_plan
        monkeypatch.setattr(ff, "_has_plan",
                            lambda q, a1, a2: False if q == "dit_dft_attributes" else real(q, a1, a2))
        ff._dit_body.cache_clear()
    try:
        assert ff._dit_body(n1, n2, dft_dtype) == "three_pass" + ("_f32" if f32 else "")
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 3 * s * fft * (4 if f32 else 2))
        frames, win, rc, rs = (t.to(dev) for t in _k7_streams(fft, b, s, 2, seed=b + f32))
        stages = (ff.dit_stage_a_f32, ff.dit_stage_b_f32) if f32 else (ff.dit_stage_a,
                                                                       ff.dit_stage_b)
        before = [c.launches for c in (ff.fengine_dit, *stages)]
        got = ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
        assert [c.launches - x for c, x in zip((ff.fengine_dit, *stages), before)] == [1, 3, 3]
        for g, r in zip(got, ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2,
                                                      dft_dtype=dft_dtype)):
            _codes_close(g, r, max_frac=1e-4 if f32 else 1e-3)
    finally:
        ff._dit_body.cache_clear()


@pytest.mark.parametrize("n1, n2, dft_dtype", [(2048, 2048, "bfloat16"), (4096, 2048, "bfloat16"),
                                              (1024, 1024, "float32"), (2048, 1024, "float32"),
                                              (2048, 2048, "float32")])
def test_k7_three_pass_bodies_show_no_spills(dev, n1, n2, dft_dtype):
    """The three-pass stage bodies (K1's stage A at N1 x 2·N2, K7's stage B)
    spill nothing; bf16 stage B runs two blocks an SM within 128 registers."""
    at = ff.dit_stage_attributes(n1, n2, dft_dtype)
    for stage in "ab":
        assert at[stage]["local_bytes"] == 0, at
    assert (at["b"]["tile_rows"], at["b"]["tile_cols"]) == (64, 32), at
    if dft_dtype == "bfloat16":
        assert at["b"]["regs"] <= 128 and at["b"]["blocks_per_sm"] == 2, at


def test_k7_two_pass_takes_unaligned_rotation_planes(dev):
    """Rotation planes that start 4 bytes past an 8-byte boundary (the DFT
    pass reads them as float2) go through two-pass K7 as the plain version
    takes them."""
    fft, b, s = 2048, 2, 3
    frames, win, rc, rs = _k7_streams(fft, b, s, 4, seed=17)
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    odd = []
    for r in (rc, rs):
        buf = torch.empty(b * fft // 2 + 1, dtype=torch.float32, device=dev)
        view = buf.view(-1)[1:1 + b * fft // 2].view(b, fft // 2)
        view.copy_(r)
        assert view.data_ptr() % 8 == 4
        odd.append(view)
    before = ff.dit_dft.launches
    got = ff.fengine_dit(frames.to(dev), win.to(dev), *odd, n1=n1, n2=n2)
    assert ff.dit_dft.launches == before + 1
    for g, r in zip(got, ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2)):
        _codes_close(g.cpu(), r)


# --- K7's f32 form: K1's f32 FIR pass, then the FFMA DIT DFT pass -----------


def _codes_close_f32(got, ref):
    """The reference's f32 contract (tests/test_fengine_fused.py:84-99):
    within 1 code on <= 1e-4 of samples."""
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) <= 1e-4


@pytest.mark.parametrize("n1, n2", [(16, 64), (32, 64), (64, 64), (16, 128), (256, 128),
                                    (256, 256), (512, 512)])
def test_k7_f32_dft_pass_matches_plain(dev, n1, n2):
    """K7's f32 DFT pass alone on K1's f32 FIR plane, at every plan (KC 16
    with SB 4, 2, 1; KC 8): within the f32 contract of
    ``dit_dft_f32_reference`` on the same card, one launch, no spill."""
    fft = 2 * n1 * n2
    b, s = 2, (8 if fft <= 1 << 17 else 2)
    frames, win, rc, rs = _k7_streams(fft, b, s, 4, seed=n1 + 3 * n2)
    plane = ff.k1_fir_reference(frames.reshape(b, -1), torch.zeros(b, dtype=torch.int64), win,
                                n_spectra=s, dft_dtype="float32").to(dev)
    rc, rs = rc.to(dev), rs.to(dev)
    assert ff.dit_dft_f32_attributes(n1, n2)["local_bytes"] == 0
    before = ff.dit_dft_f32.launches
    got = ff.dit_dft_f32(plane, rc, rs, n1=n1, n2=n2)
    assert ff.dit_dft_f32.launches == before + 1
    for g, r in zip(got, ff.dit_dft_f32_reference(plane, rc, rs, n1=n1, n2=n2)):
        assert g.is_cuda and g.shape == r.shape and g.dtype == torch.int8
        _codes_close_f32(g, r)


@pytest.mark.parametrize("n1, n2, kc, sb", [(16, 64, 16, 4), (16, 128, 16, 2),
                                            (256, 128, 16, 2), (256, 256, 16, 1),
                                            (512, 512, 8, 1)])
def test_k7_f32_dft_pass_attributes_show_no_spills(dev, n1, n2, kc, sb):
    """The f32 DFT pass's body at each plan spills nothing; KC and SB follow
    N2 (KC * SB * 2 * N2 = 8192), the plan fits the 232,448 bytes a block may
    use, and the split goes to the two f32 passes."""
    at = ff.dit_dft_f32_attributes(n1, n2)
    assert at["local_bytes"] == 0, at
    assert (at["kc"], at["sb"], at["threads"], at["stages"]) == (kc, sb, 256, 4), at
    assert at["kc"] * at["sb"] * 2 * n2 == 8192 and at["ktb"] * n2 <= 8192, at
    assert at["smem_bytes"] <= 232448, at
    assert ff._dit_body(n1, n2, "float32") == "two_pass_f32"


@pytest.mark.parametrize("fft, deint", [(2048, "matmul"), (4096, "bitcast"), (65536, "matmul"),
                                        (65536, "bitcast"), (1 << 17, "matmul"),
                                        (1 << 19, "matmul")])
def test_k7_f32_two_passes_match_plain(dev, fft, deint):
    """f32 K7 (16 x 64, 16 x 128, 256 x 128, 256 x 256, 512 x 512) through
    K1's f32 FIR pass and the f32 DFT pass at ~50 codes rms: within the f32
    contract of the plain version on the same card; one K7 call, one pass of
    each, no other pass."""
    taps, s, lead = 4, (4 if fft <= 1 << 17 else 2), (1, 2)
    rng = np.random.default_rng(fft + len(deint))
    frames = torch.from_numpy(rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8))
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=0.068 * (1024 / fft) ** 0.5, deint=deint,
              dft_dtype="float32")
    counters = (ff.fengine_dit, ff.k1_fir_f32, ff.dit_dft_f32, ff.dit_stage_a_f32, ff.k1_fir,
                ff.dit_dft)
    before = [c.launches for c in counters]
    win = default_window(taps, fft, dev)
    got = ff.fengine_fused(frames.to(dev), win, fd, ph, **kw)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0]
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    rc, rs = (r.reshape(2, fft // 2) for r in ff._rotation_planes(
        torch.from_numpy(fd).to(dev), torch.from_numpy(ph).to(dev), fft // 2,
        kw["quant_scale"], (fft // 2,)))
    ref = ff.fengine_dit_reference(frames.to(dev).view(2, s + taps - 1, fft), win, rc, rs,
                                   n1=n1, n2=n2, dft_dtype="float32")
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape[-2:] == r.shape[-2:]
        _codes_close_f32(g.view(r.shape), r)


def test_k7_f32_two_passes_span_plane_groups(dev, monkeypatch):
    """Five streams through a scratch of two f32 planes: three groups, each an
    f32 FIR pass and an f32 DFT pass, within the f32 contract of plain K7;
    the same streams at N1 = 8 (fft 1024) through the same groups."""
    for fft, seed in ((4096, 41), (1024, 42)):
        s, taps, b = 5, 4, 5
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * s * fft * 4)
        frames, win, rc, rs = (t.to(dev) for t in _k7_streams(fft, b, s, taps, seed=seed))
        _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
        counters = (ff.fengine_dit, ff.k1_fir_f32, ff.dit_dft_f32)
        before = [c.launches for c in counters]
        got = ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype="float32")
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 3, 3]
        ref = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype="float32")
        for g, r in zip(got, ref):
            _codes_close_f32(g, r)


def test_k7_f32_two_pass_takes_unaligned_rotation_planes(dev):
    """Rotation planes that start 4 bytes past an 8-byte boundary (the f32
    DFT pass reads them as float2) go through f32 K7 as the plain version
    takes them."""
    fft, b, s = 2048, 2, 3
    frames, win, rc, rs = _k7_streams(fft, b, s, 4, seed=43)
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    odd = []
    for r in (rc, rs):
        buf = torch.empty(b * fft // 2 + 1, dtype=torch.float32, device=dev)
        view = buf[1:].view(b, fft // 2)
        view.copy_(r)
        assert view.data_ptr() % 8 == 4
        odd.append(view)
    before = ff.dit_dft_f32.launches
    got = ff.fengine_dit(frames.to(dev), win.to(dev), *odd, n1=n1, n2=n2, dft_dtype="float32")
    assert ff.dit_dft_f32.launches == before + 1
    ref = ff.fengine_dit_reference(frames.to(dev), win.to(dev), rc.to(dev), rs.to(dev), n1=n1,
                                   n2=n2, dft_dtype="float32")
    for g, r in zip(got, ref):
        _codes_close_f32(g, r)


@pytest.mark.parametrize("quantise", [True, False])
def test_k1_bf16_at_fft_2_22_runs_the_three_pass_route(dev, quantise):
    """bf16 K1 at 2048 x 2048 (fft 2^22), where the DFT pass has no plan,
    runs the three-pass route instead of raising: one FIR pass, one stage A
    and one stage B, no DFT pass; int8 within 1 code on <= 1e-3 of samples
    of the plain version on the CPU (the codes near 50 rms), the f32 output
    below 1 code unit everywhere and within rtol 1e-4 / atol 1e-2 on all but
    1e-2; the DFT pass alone refuses the split."""
    fft, taps, s, lead = 1 << 22, 2, 2, (1, 2)
    n1, n2 = ff._split_ct(fft)
    assert (n1, n2) == (2048, 2048)
    assert ff._k1_body(n1, n2, "bfloat16") == "three_pass"
    rng = np.random.default_rng(22 + quantise)
    frames = rng.integers(-64, 64, (*lead, s + taps - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, lead).astype(np.float32)
    ph = rng.uniform(-1, 1, lead).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=0.068 * (1024 / fft) ** 0.5, quantise=quantise)
    counters = (ff.k1_fir, ff.k1_stage_a, ff.k1_stage_b, ff.k1_dft, ff.fengine_fused)
    before = [c.launches for c in counters]
    got = ff.fengine_fused(torch.from_numpy(frames).to(dev), default_window(taps, fft, dev),
                           fd, ph, **kw)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 1]
    ref = ff.fengine_fused(torch.from_numpy(frames), default_window(taps, fft), fd, ph, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape and g.dtype == r.dtype
        if quantise:
            _codes_close(g.cpu(), r)
        else:
            d = (g.cpu() - r).abs()
            over = float((d > 1e-2 + 1e-4 * r.abs()).float().mean())
            assert float(d.max()) < 1.0 and over <= 1e-2, (float(d.max()), over)
    with pytest.raises(ValueError, match="shared-memory plan"):
        ff.k1_dft(torch.zeros((1, 1, fft), dtype=torch.bfloat16, device=dev),
                  torch.zeros((1, fft // 2), device=dev), torch.zeros((1, fft // 2), device=dev),
                  n1=n1, n2=n2)


@pytest.mark.parametrize("stop", sorted(ff.DIT_DFT_STOPS))
@pytest.mark.parametrize("n1, n2, s", [(64, 64, 5), (256, 128, 3), (256, 256, 2)])
def test_k7_dft_stops_match_plain(dev, stop, n1, n2, s):
    """The DFT pass cut at a stage (the 64-row chunk plan): stagea writes
    nothing; stageb each stream's re, truncated, within 1 code on <= 1e-3
    of samples, on a plane scaled by a power of two (exact in bf16) that
    keeps those values near 30 rms."""
    fft, b = 2 * n1 * n2, 2
    frames, win, _, _ = _k7_streams(fft, b, s, 4, seed=n1 + s)
    plane = ff.k1_fir_reference(frames.reshape(b, -1), torch.zeros(b, dtype=torch.int64), win,
                                n_spectra=s).to(torch.float32)
    shift = round(np.log2(30 / (float(plane.pow(2).mean().sqrt()) * (fft / 2) ** 0.5)))
    plane = (plane * 2.0 ** shift).to(torch.bfloat16)
    before = ff.dit_dft_stop.launches
    got = ff.dit_dft_stop(plane.to(dev), n1=n1, n2=n2, stop=stop)
    assert ff.dit_dft_stop.launches == before + 1
    for g, r in zip(got, ff.dit_dft_stop_reference(stop, plane, n1=n1, n2=n2)):
        if stop == "stagea":
            assert torch.equal(g.cpu(), r)
        else:
            _codes_close(g.cpu(), r)


def test_p2_full_is_k7_whole(dev):
    """P2's "full": K7 whole (bf16) on the route it runs, its FIR pass and
    DFT pass, within 1 code on <= 1e-3 of samples of plain K7."""
    n1, n2, s, taps, b = 128, 64, 16, 16, 2
    fft = 2 * n1 * n2
    frames, win, rc, rs = _k7_streams(fft, b, s, taps, seed=29)
    counters = (ff.fengine_dit_ablate, ff.fengine_dit, ff.k1_fir, ff.dit_dft)
    before = [c.launches for c in counters]
    got = ff.fengine_dit_ablate(frames.to(dev), win.to(dev), n1=n1, n2=n2, stop="full",
                                rot=(rc.to(dev), rs.to(dev)))
    assert [c.launches - x for c, x in zip(counters, before)] == [1, 1, 1, 1]
    for g, r in zip(got, ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2)):
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


def _k1_stop_case(dev, fft, stop, dft_dtype, quantise, s, taps, seed):
    """K1 cut at ``stop`` on the card and its plain stop on the CPU, 2
    streams with coarse delays (3 samples; 9 rows of N2 and 77 samples, so
    that the dma probe reads from the reference's DMA base, 8 rows in), the
    window scaled so the stop's values are about 16 codes rms; the call must
    count one stopped pass a group and run no pass its route's whole call
    does not."""
    n1, n2 = ff._split_ct(fft)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-64, 64, (2, (s + taps - 1) * fft + 64 * n2 + 77),
                                      dtype=np.int8))
    cd = torch.tensor([3, 9 * n2 + 77])
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, 2).astype(np.float32))
    win = default_window(taps, fft)
    rc, rs = (r.reshape(2, -1) for r in ff.fine_rotation_planes(
        fd, -fd, n_channels=fft // 2, quant_scale=1 / 64))
    kw = dict(n_spectra=s, n1=n1, n2=n2, dft_dtype=dft_dtype)
    if stop != "dma":  # the gain that puts the stop's values at about 16 codes rms
        r0 = ff.fengine_ablate_reference(stop, x, cd, win, rc, rs, quantise=False, **kw)
        win = win * (16 / max(float(t.pow(2).mean().sqrt()) for t in r0))
    counts = {k: getattr(ff, k).launches for k in K1_COUNTERS}
    before = ff.fengine_fused.ablate_launches
    got = ff.fengine_fused(x.to(dev), win.to(dev), fd.to(dev), -fd.to(dev),
                           n_channels=fft // 2, quant_scale=1 / 64, dft_dtype=dft_dtype,
                           coarse_delays=cd.to(dev), n_spectra=s, quantise=quantise,
                           _ablate=stop)
    torch.cuda.synchronize()
    assert ff.fengine_fused.ablate_launches == before + 1  # one group
    ran = {k for k in K1_COUNTERS if getattr(ff, k).launches != counts[k]}
    assert ran <= _route_passes(ff._k1_body(n1, n2, dft_dtype))
    ref = ff.fengine_ablate_reference(stop, x, cd, win, rc, rs, quantise=quantise, **kw)
    _stop_diff(f"fft {fft} {stop} {dft_dtype} q={quantise}", [g.cpu() for g in got], ref, stop,
               dft_dtype, quantise)  # chip_smoke.py's tolerance for each stop


@pytest.mark.parametrize("quantise", [True, False])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stop", ["fir", "stagea", "stageb"])
@pytest.mark.parametrize("fft, s, taps", [(16384, 20, 8), (1 << 18, 8, 16), (1 << 20, 4, 16),
                                          (1 << 22, 2, 4)])
def test_k1_stops_on_every_route_match_plain(dev, fft, s, taps, stop, dft_dtype, quantise):
    """K1's stage stops wherever the reference takes them at N1 = N2: the
    bf16 DFT pass's stop bodies at KC 64 (fft 16384, 2^18) and 32 (2^20),
    the f32 DFT pass's at KC 16 and 8, the three-pass route (2^22) in both
    forms; with the requant and without."""
    _k1_stop_case(dev, fft, stop, dft_dtype, quantise, s, taps,
                  seed=fft + len(stop) + len(dft_dtype) + quantise)


@pytest.mark.parametrize("quantise", [True, False])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fft", [1024, 2048, 4096, 8192])
def test_k1_dma_stop_at_n1_below_n2_matches_plain(dev, fft, dft_dtype, quantise):
    """The dma probe of the [rows, N2] frame view at N1 < N2 (8, 16, 32, 64 x
    128; 8 to 1 frames a probe), S = 32 (two probe blocks)."""
    _k1_stop_case(dev, fft, "dma", dft_dtype, quantise, 32, 4, seed=fft + quantise)


def test_k1_stop_bodies_do_not_spill(dev):
    """Every body K1's stops run: the FIR pass's (the reference's dma and
    fir into either plane, P5's fir, P2's), the DFT passes' and the
    three-pass route's at every N1 = N2 split, both forms, with the requant
    and without: 0 local (spill) bytes."""
    fir = {k: v for k, v in ff.k1_fir_attributes().items()
           if k.split("/")[0] not in ("bf16", "f32")}
    assert fir and not {k: v for k, v in fir.items() if v["local_bytes"]}
    for n in (128, 256, 512, 1024, 2048):
        for dt in ("bfloat16", "float32"):
            bodies = ff.k1_stop_attributes(n, n, dt)
            assert bodies and not {k: v for k, v in bodies.items() if v["local_bytes"]}, \
                (n, dt, bodies)


def test_k1_at_a_channel_offset_matches_plain(dev):
    """K1 with a channel-sharded engine's planes (channel_offset = 3 C of
    n_channels_total = 4 C) against its plain version: the kernel reads the
    planes as they are."""
    fft, s, taps = 16384, 16, 8
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.integers(-64, 64, (2, 2, (s + taps - 1) * fft), dtype=np.int8))
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 2)).astype(np.float32))
    kw = dict(n_channels=fft // 2, quant_scale=1 / 64, channel_offset=3 * fft // 2,
              n_channels_total=2 * fft)
    win = default_window(taps, fft)
    got = ff.fengine_fused(x.to(dev).reshape(2, 2, -1, fft), win.to(dev), fd.to(dev), -fd.to(dev),
                           **kw)
    ref = ff.fengine_fused(x.reshape(2, 2, -1, fft), win, fd, -fd, **kw)
    plain = ff.fengine_fused(x.reshape(2, 2, -1, fft), win, fd, -fd, n_channels=fft // 2,
                             quant_scale=1 / 64)
    for g, r, p in zip(got, ref, plain):
        _codes_close(g.cpu(), r)
        assert not torch.equal(r, p)


@pytest.mark.parametrize("stop", ["dma", "conv", "fir", "deint", "stagea", "stageb"])
@pytest.mark.parametrize("n1, n2, s", [(128, 64, 20), (256, 128, 16), (64, 32, 33)])
def test_k7_stops_match_plain(dev, stop, n1, n2, s):
    """P2's kernels: K7's route cut at a stage (K1's FIR pass for dma, conv,
    fir and deint; the FIR pass and the DFT pass cut at stage A or B), bit
    for bit up to deint and within 1 code on <= 1e-3 of samples after it;
    S off P2's 16-spectrum blocks (33)."""
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


@pytest.mark.parametrize("bstage_name", ["turned", "fused"])
def test_one_rank_nccl_sharded_step_equals_fbengine(dev, bstage_name, tmp_path):
    """A one-rank NCCL group: the sharded step (fused F; K4 + the product,
    or K2) equals ``FBEngine`` with the same backends on the tail-prepended
    stream, the same kernels on the same bytes."""
    import torch.distributed as dist

    from dpdk_dc_sand_tpu_torch.parallel import ShardedFBEngine, make_mesh

    cfg = ArrayConfig(n_ants=8, n_channels=1024, n_beams=16, n_taps=4)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(shape=(1, 1))
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        eng = ShardedFBEngine(cfg, mesh, n_spectra=128, fengine="fused", bstage=bstage_name)
        adc, fd, ph, dv = eng.example_inputs()
        k1 = ff.fengine_fused.launches
        got = eng(torch.from_numpy(adc).to(dev), fd, ph, dv)
        assert got.is_cuda and ff.fengine_fused.launches == k1 + 1
    finally:
        dist.destroy_process_group()
    halo = (cfg.n_taps - 1) * cfg.fft_size
    fb = FBEngine(cfg, n_spectra=128, fengine="fused", bstage=bstage_name, device=dev)
    want = fb(np.concatenate([adc[..., -halo:], adc], axis=-1), np.zeros(8, np.int32), fd, ph, dv)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,got", [("bfloat16", 0.9766845703125),
                                       ("float32", 0.9749999642372131)])
def test_dynamic_range_probe_on_the_tensor_cores(dev, dtype, got):
    """65000 x 1.5e-5 through one product with f32 output: bf16 rounds both
    inputs (65024 x bf16(1.5e-5)), f32 keeps them; the JAX package's numbers."""
    from dpdk_dc_sand_tpu_torch.characterize import matmul_roofline, mxu_dynamic_range

    r = mxu_dynamic_range(dtype=dtype)
    assert r["expected"] == 0.975 and r["got"] == got and r["survives"] == 1.0
    assert matmul_roofline(n=1024, dtype=dtype, iters=2)["tflops"] > 0


@pytest.mark.parametrize("n_channels", [128, 512], ids=["composed-f", "k1"])
def test_servlet_fronting_two_engine_nodes_on_the_card(dev, n_channels):
    """The port's servlet in front of two port engine nodes on the card
    (pinned slots, their own copy streams): a ``?delay-model`` and a
    ``?beam-weights`` fanned out through the servlet change each node's
    beams, which equal ``fb.step`` with the new state bit for bit; one past
    the budget fails on both nodes, degrades the servlet and changes nothing."""
    import asyncio
    import time

    from dpdk_dc_sand_tpu_torch.control import Client, CorrServlet, FailReply
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

    cfg = ArrayConfig(n_ants=2, n_channels=n_channels, n_beams=2, n_taps=4)

    async def until(cond, what):
        deadline = time.monotonic() + 60.0
        while not cond():
            assert time.monotonic() < deadline, f"timed out waiting for {what}"
            await asyncio.sleep(0.01)

    async def scenario():
        beams = [{}, {}]
        nodes = [EngineNode(cfg, n_spectra=8, beam_quant_scale=0.25, ring_slots=2, device=dev,
                            auth_secret="k",
                            on_beams=lambda b, s, i=i: beams[i].__setitem__(s, b))
                 for i in range(2)]
        servlet = client = None
        try:
            for node in nodes:
                await node.start()
            assert all(n.ring.pinned for n in nodes)
            servlet = CorrServlet("corr3", cfg.n_ants, request_timeout=60.0, auth_secret="k",
                                  engine_endpoints=[("127.0.0.1", n.port) for n in nodes])
            await servlet.start()
            client = await Client("127.0.0.1", servlet.port, auth_secret="k").connect()
            chunk = np.random.default_rng(5).integers(-64, 64, nodes[0].chunk_shape,
                                                      dtype=np.int8)
            adc = torch.from_numpy(chunk).to(dev)

            async def step(seq):
                for node in nodes:
                    assert node.submit_chunk(chunk, seq)
                await until(lambda: all(seq in b for b in beams), f"chunk {seq}")
                return [b[seq] for b in beams]

            before = await step(0)
            dm = np.array([[3, 0.25, -0.3, 0.0], [17, -0.4, 0.6, 0.0]])
            await client.request("delay-model", *dm.ravel())
            await client.request("beam-weights", 0.5, 1.25)
            after = await step(1)
            for node, b0, b1 in zip(nodes, before, after):
                want = node.fb.step(adc, node._coarse, node._frac, node._phase).cpu().numpy()
                np.testing.assert_array_equal(b1, want)
                assert not np.array_equal(b1, b0)
            bad = dm.copy()
            bad[0, 0] = nodes[0].delay_budget + 1
            with pytest.raises(FailReply, match="node0: .*node1: "):
                await client.request("delay-model", *bad.ravel())
            assert servlet.sensors["device-status"].value == "degraded"
            for b1, b2 in zip(after, await step(2)):
                np.testing.assert_array_equal(b2, b1)
        finally:
            if client is not None:
                await client.close()
            if servlet is not None:
                await servlet.stop()
            for node in nodes:
                await node.stop()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(scenario(), 300.0))
    finally:
        loop.close()


def test_pinned_native_ring_slots_are_page_locked(dev):
    """The native ring over the page-locked arena: every slot view it hands
    out, on either side, is page-locked memory (a slot that lost its pinning
    would only show as a slower, staged H2D)."""
    from dpdk_dc_sand_tpu_torch.stream import ChunkRing

    ring = ChunkRing(3, 1 << 20, pinned=True)
    try:
        assert ring.native and ring.pinned
        for seq in range(3):
            buf = ring.acquire_write()
            assert torch.from_numpy(buf).is_pinned()
            buf[:8] = seq
            ring.commit_write(1 << 19, seq)
        assert ring.acquire_write() is None
        for seq in range(3):
            view, got = ring.acquire_read()
            assert got == seq and view.nbytes == 1 << 19
            assert torch.from_numpy(view).is_pinned()
            ring.release_read()
    finally:
        ring.close()


@pytest.mark.parametrize("wire", ["lite", "spead64"])
def test_burst_udp_heap_reaches_the_card_through_the_pinned_native_ring(dev, wire):
    """A heap over loopback burst UDP, reassembled by the native receiver
    straight into the page-locked ring, copied to the card by DeviceFeed on
    its copy stream from the slot itself, byte for byte."""
    from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, DeviceFeed
    from dpdk_dc_sand_tpu_torch.stream.udp_native import BurstUdpReceiver, BurstUdpSender

    nbytes = 3 << 20
    ring = ChunkRing(4, nbytes + 16, pinned=True)
    rx = BurstUdpReceiver(("127.0.0.1", 0), ring, mode="burst")
    tx = BurstUdpSender(("127.0.0.1", rx.port), mode="burst", wire_format=wire)
    feed = DeviceFeed(ring, reshape=lambda b: b[16:], device=dev).start()
    try:
        data = np.random.default_rng(18).integers(0, 256, nbytes, dtype=np.uint8)
        tx.send_chunk(Chunk(data, seq=0, timestamp=7))
        arr, seq = feed.get(timeout=30)
        assert seq == 0 and arr.is_cuda and arr.dtype == torch.uint8
        assert torch.equal(arr.cpu(), torch.from_numpy(data))
        assert feed.pinned_copies == 1 and feed.stream is not None
        assert rx.stats()["heaps"] == 1 and rx.stats()["evicted"] == 0
    finally:
        feed.stop()
        tx.close()
        rx.stop()
        ring.close()


def test_ctypes_callback_native_hot_path_has_no_mismatch(dev):
    from dpdk_dc_sand_tpu_torch.examples import ctypes_callback

    assert ctypes_callback.native_hot_path() == 0
    assert ctypes_callback.python_callback_from_native() == [1, 2, 3, 4, 5, 7, 8, 9]
