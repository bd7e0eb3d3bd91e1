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
K2's tensor-core body over a grid of 2B, A, P·S and C in both layouts, at
the int8 extremes, with its C-side geometry and its stage stops,
K1's unquantised (f32) output, K1's FIR pass alone, K1, K7 and the
engines above fft 65536, K7's two-pass body (its DFT pass alone at every
chunk plan, both passes at fft 2048 to 2^17 and over several plane groups,
its launch counters, its registers and spill bytes), and the probes'
kernels (K1's and K7's stage stops, P1's modes, P3's loop orders) at small
and ragged shapes, a one-rank NCCL step of the sharded engine against
``FBEngine``, the tensor-core dynamic-range probe and the port's servlet
fronting two engine nodes on the card.
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


@pytest.mark.parametrize("layout", ["packed", "split"])
@pytest.mark.parametrize("ps, c", K2_SHAPES)
@pytest.mark.parametrize("a", [1, 7, 80])
@pytest.mark.parametrize("nb2", [16, 32, 64])
def test_k2_ring_body_matches_plain(dev, nb2, a, ps, c, layout):
    """2A = 2, 14 (one partial K step) and 160; weights held whole or staged."""
    p = 2
    rng = np.random.default_rng(nb2 * 1000 + a * 10 + ps + c)
    qr, qi = (_int8(rng, (a, p, ps // p, c)).to(dev) for _ in range(2))
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, nb2)).astype(np.float32))
    _k2_check(dev, qr, qi, w.to(dev).to(torch.bfloat16), layout)


@pytest.mark.parametrize("nb2", [16, 32, 64])
def test_k2_holds_the_int8_extremes(dev, nb2):
    """Every code -128 in qr and 127 in qi, and alternating extremes: the
    register turn's bf16 conversion is exact at both ends."""
    a, p, s, c = 9, 2, 128, 64
    rng = np.random.default_rng(nb2 + 5)
    w = torch.from_numpy(rng.uniform(-2, 2, (c, 2 * a, nb2)).astype(np.float32))
    w = w.to(dev).to(torch.bfloat16)
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
    for nb in (8, 32):
        got = bstage.kernel_attributes(80, 2, 256, nb, 32768)
        assert got["local_bytes"] == 0 and got["smem_bytes"] <= 232448
    lib = _build.library()
    x = torch.zeros(2 * 96 * 64, dtype=torch.int8, device=dev)
    w = torch.zeros(64 * 2 * 32, dtype=torch.bfloat16, device=dev)
    out = torch.empty(64 * 96 * 32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for ps, c in ((96, 64), (64, 40)):  # P·S % 64, C % 16
        assert lib.bstage_fused_launch(x.data_ptr(), x.data_ptr(), w.data_ptr(), 1,
                                       out.data_ptr(), 1, ps, c, 32, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("stop", sorted(bstage.K2_STOPS))
def test_k2_stops_write_what_they_keep(dev, stop):
    """A stop with the stores writes zeros over every output; one without
    writes nothing; neither counts as a K2 launch."""
    a, p, s, c = 17, 2, 128, 1024
    rng = np.random.default_rng(14)
    qr, qi = (_int8(rng, (a, p, s, c)).to(dev) for _ in range(2))
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * a, 32)).astype(np.float32))
    w = w.to(dev).to(torch.bfloat16)
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


@pytest.mark.parametrize("fft, deint, dft_dtype", [(2048, "bitcast", "bfloat16"),
                                                   (1024, "matmul", "bfloat16"),
                                                   (65536, "matmul", "float32")])
def test_k7_simt_shapes_launch_neither_pass(dev, fft, deint, dft_dtype):
    """N1 = 8 and f32 operands run the SIMT body: one K7 call, no FIR or DFT
    pass."""
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    frames, win, rc, rs = _k7_streams(fft, 2, 3, 4, seed=fft)
    before = (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches)
    got = ff.fengine_dit(frames.to(dev), win.to(dev), rc.to(dev), rs.to(dev), n1=n1, n2=n2,
                         dft_dtype=dft_dtype)
    assert (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches) == (
        before[0] + 1, before[1], before[2])
    ref = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, r in zip(got, ref):
        _codes_close(g.cpu(), r)


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


def test_k7_split_without_a_plan_takes_the_simt_body(dev):
    """At 2048 x 2048 (fft 2^23) a 16-row chunk's T planes alone overflow
    shared memory: the DFT pass has no plan and the split runs the SIMT body."""
    with pytest.raises(ValueError):
        ff.dit_dft_attributes(2048, 2048)
    assert ff._dit_body(2048, 2048, "bfloat16") == "simt"


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


def test_p2_full_is_the_simt_body_whole(dev):
    """P2's "full": K7's SIMT body whole (bf16), the stops' own kernel,
    within 1 code on <= 1e-3 of samples of plain K7."""
    n1, n2, s, taps, b = 128, 64, 16, 16, 2
    fft = 2 * n1 * n2
    frames, win, rc, rs = _k7_streams(fft, b, s, taps, seed=29)
    before = (ff.fengine_dit_ablate.launches, ff.fengine_dit.launches, ff.dit_dft.launches)
    got = ff.fengine_dit_ablate(frames.to(dev), win.to(dev), n1=n1, n2=n2, stop="full",
                                rot=(rc.to(dev), rs.to(dev)))
    assert (ff.fengine_dit_ablate.launches, ff.fengine_dit.launches, ff.dit_dft.launches) == (
        before[0] + 1, before[1], before[2])
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
