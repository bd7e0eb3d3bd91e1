"""The slice: the port's FEngine and the composed F path vs the JAX package.

The JAX ``FEngine(use_pallas=False)`` runs the same chain as the port's
``FEngine(device="cpu")``: coarse delay, the f32 FIR in tap order, a real
FFT, the fine-delay rotation, requant. The FFTs (pocketfft here, XLA's on
the JAX side) differ in f32 rounding, so the int8 output agrees within 1
code on <= 1e-3 of samples and the f32 output (``quantise_output=False``)
at rtol 1e-4 / atol 1e-2 (ROADMAP.md §3). ``FBEngine`` and ``FXBEngine``
with ``fengine="xla"`` are held against the JAX engines with the same F
stage, at the tolerances of ``tests/test_torch_{fbengine,fxbengine}.py``.
The qualification's CW tone (``tests/qualification/test_channelisation.py``)
runs on the port: the peak in its channel, leakage <= -62 dB.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FEngine as JFEngine
from dpdk_dc_sand_tpu.models import FXBEngine as JFXBEngine
from dpdk_dc_sand_tpu.models.fbengine import FBEngine as JFBEngine
from dpdk_dc_sand_tpu.models.fbengine import _f_stage as j_f_stage
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.convert import from_reference_state, load_window
from dpdk_dc_sand_tpu_torch.models import FBEngine, FEngine, FXBEngine
from dpdk_dc_sand_tpu_torch.models.fbengine import _f_stage
from dpdk_dc_sand_tpu_torch.models.fengine import composed_f
from dpdk_dc_sand_tpu_torch.ops import pfb_fir

LEAKAGE_SPEC_DB = -62.0


def _codes_close(got, ref, max_code=1, max_frac=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= max_code, d.max()
    assert (d != 0).mean() <= max_frac, (d != 0).mean()


def _pair(n_ants=3, n_channels=256, n_taps=8, n_spectra=16, **kw):
    cfg = ArrayConfig(n_ants=n_ants, n_channels=n_channels, n_taps=n_taps)
    port = FEngine(cfg, n_spectra=n_spectra, device="cpu", **kw)
    ref = JFEngine(JArrayConfig(**dataclasses.asdict(cfg)), n_spectra=n_spectra,
                   use_pallas=False, **kw)
    return port, ref


@pytest.mark.parametrize(
    "n_channels,n_taps,quant_scale", [(256, 8, 1 / 16), (512, 16, 1 / 32), (64, 4, 1 / 4)]
)
def test_fengine_int8_matches_reference(n_channels, n_taps, quant_scale):
    port, ref = _pair(n_channels=n_channels, n_taps=n_taps, quant_scale=quant_scale)
    adc, cd, fd, ph = port.example_inputs(seed=n_channels, margin=300)
    for g, r in zip((adc, cd, fd, ph), ref.example_inputs(seed=n_channels, margin=300)):
        np.testing.assert_array_equal(g, r)
    got = port(adc, cd, fd, ph)
    want = np.asarray(ref(jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph)))
    assert got.shape == want.shape == (3, 2, 16, n_channels, 2) and got.dtype == torch.int8
    _codes_close(got.numpy(), want)


def test_fengine_f32_output_matches_reference():
    port, ref = _pair(quant_scale=0.37, quantise_output=False)
    adc, cd, fd, ph = port.example_inputs(seed=4)
    got = port(adc, cd, fd, ph)
    want = np.asarray(ref(jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)


def test_fengine_takes_the_window_carried_from_the_reference():
    port, ref = _pair()
    assert not torch.equal(port.window, torch.zeros_like(port.window))
    scaled = np.asarray(ref.window) * np.float32(0.5)
    load_window(port, scaled)
    assert port.window.dtype == torch.float32
    np.testing.assert_array_equal(port.window.numpy(), scaled)
    with pytest.raises(ValueError, match="window shape"):
        load_window(port, scaled[:, :-1])
    adc, cd, fd, ph = port.example_inputs(seed=8)
    port_half = port(adc, cd, fd, ph)
    load_window(port, np.asarray(ref.window))
    full = port(adc, cd, fd, ph)
    # Halving the window halves every FIR output: the requantised codes follow.
    assert (port_half.abs() <= full.abs()).all()
    assert port_half.float().abs().mean() < 0.6 * full.float().abs().mean()


def test_composed_chain_takes_any_fir_and_no_launch_on_cpu():
    port, _ = _pair()
    adc, cd, fd, ph = port.example_inputs(seed=6)
    shape = (3, 2, 16, 256)
    outs = [torch.empty(shape, dtype=torch.int8) for _ in range(4)]
    args = (torch.from_numpy(adc), torch.from_numpy(cd), torch.from_numpy(fd),
            torch.from_numpy(ph), port.window)
    before = pfb_fir.pfb_fir_frames.launches
    composed_f(*args, *outs[:2], quant_scale=port.quant_scale)

    def plain(samples, window):
        return pfb_fir.pfb_fir_reference(samples.reshape(*samples.shape[:-1], -1, 512), window)

    composed_f(*args, *outs[2:], quant_scale=port.quant_scale, fir=plain)
    assert pfb_fir.pfb_fir_frames.launches == before
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    got = port(adc, cd, fd, ph)
    assert torch.equal(got[..., 0], outs[0]) and torch.equal(got[..., 1], outs[1])


def _tone(fe, channel, amp=100.0, dtype=np.float32):
    n = np.arange(fe.samples_in + 8)
    tone = amp * np.cos(2 * np.pi * channel * n / fe.cfg.fft_size)
    return np.broadcast_to(tone.astype(dtype), (fe.cfg.n_ants, fe.cfg.n_pols, n.size)).copy()


def _power(fe, adc):
    z = np.zeros(fe.cfg.n_ants, np.float32)
    out = fe(adc, np.zeros(fe.cfg.n_ants, np.int32), z, z).numpy()
    power = out[..., 0].astype(np.float64) ** 2 + out[..., 1].astype(np.float64) ** 2
    return power[0, 0, 4]


def test_cw_tone_leakage_meets_the_spec():
    """tests/qualification/test_channelisation.py:35-73 on the port: an ideal
    CW tone at the centre of channel 37 of 128, 16 taps, f32 output."""
    cfg = ArrayConfig(n_ants=1, n_channels=128, n_taps=16)
    fe = FEngine(cfg, n_spectra=8, quant_scale=1.0, quantise_output=False, device="cpu")
    k = 37
    power = _power(fe, _tone(fe, k))
    assert int(np.argmax(power)) == k
    rel_db = 10 * np.log10(power / power[k] + 1e-300)
    assert float(np.delete(rel_db, k).max()) <= LEAKAGE_SPEC_DB


def test_cw_tone_sweep_peaks_in_each_channel():
    cfg = ArrayConfig(n_ants=1, n_channels=128, n_taps=16)
    fe = FEngine(cfg, n_spectra=8, quant_scale=1.0, device="cpu")
    channels = [3, 17, 64, 100, 126]
    peaks = [int(np.argmax(_power(fe, _tone(fe, k, dtype=np.int8)))) for k in channels]
    assert peaks == channels


FB_CFG = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
FB_JCFG = JArrayConfig(**dataclasses.asdict(FB_CFG))


def test_fbengine_xla_matches_reference():
    """Beams within max |d| <= 2 + 1e-3 on <= 5e-3 (tests/test_torch_fbengine.py)."""
    s = 64
    ref = JFBEngine(FB_JCFG, n_spectra=s, precision="bf16", fengine="xla", bstage="fused",
                    beam_layout="natural", fengine_interpret=True)
    port = FBEngine(FB_CFG, n_spectra=s, precision="bf16", fengine="xla",
                    beam_layout="natural", device="cpu")
    assert (ref.fengine, ref.bstage, port.fengine, port.bstage) == ("xla", "fused") * 2
    adc, cd, fd, ph, dv = ref.example_inputs(seed=2, margin=512)
    ref.set_beam_delays(dv)
    want = np.asarray(ref.step(jnp.asarray(adc), cd, fd, ph))
    from_reference_state(port, np.asarray(ref.window), np.asarray(ref._coeff_blocks), None,
                         delay_vals=dv, frac_delays=fd, phases=ph)
    got = port.step(adc, cd, fd, ph)
    assert got.shape == want.shape
    d = np.abs(got.numpy().astype(np.float64) - want)
    assert d.max() <= 2.0 + 1e-3 and (d > 1e-3).mean() <= 5e-3
    # The F planes: the composed chain of each package.
    pr, pi = _f_stage(torch.from_numpy(adc), torch.from_numpy(cd), port.window, None,
                      cfg=FB_CFG, n_spectra=s, quant_scale=1 / 16, fengine="xla",
                      fine_delays=(torch.from_numpy(fd), torch.from_numpy(ph)))
    rr, ri = j_f_stage(jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
                       window=ref.window, cfg=FB_JCFG, n_spectra=s, quant_scale=1 / 16,
                       use_pallas=False, fengine="xla")
    _codes_close(pr.numpy(), rr)
    _codes_close(pi.numpy(), ri)


def test_fxbengine_xla_matches_reference():
    """FXB with the composed F: beams as FB, and each package's visibilities
    the exact gram of its own F planes, which agree within 1 code."""
    s = 128
    ref = JFXBEngine(FB_JCFG, n_spectra=s, precision="bf16", fengine="xla", bstage="turned",
                     fengine_interpret=True)
    port = FXBEngine(FB_CFG, n_spectra=s, precision="bf16", fengine="xla", device="cpu")
    assert (port.fengine, port.bstage) == ("xla", "turned") == (ref.fengine, ref.bstage)
    adc, cd, fd, ph, dv = ref.example_inputs(seed=3, margin=512)
    ref.set_beam_delays(dv)
    wb, wr, wi = (np.asarray(x) for x in ref.step(jnp.asarray(adc), cd, fd, ph))
    from_reference_state(port, np.asarray(ref.window), np.asarray(ref._coeffs), None,
                         delay_vals=dv, frac_delays=fd, phases=ph)
    gb, gr, gi = port.step(adc, cd, fd, ph)
    d = np.abs(gb.numpy().astype(np.float64) - wb)
    assert d.max() <= 2.0 + 1e-3 and (d > 1e-3).mean() <= 5e-3
    planes = port._f(adc, cd, fd, ph)
    rr, ri = j_f_stage(jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
                       window=ref.window, cfg=FB_JCFG, n_spectra=s, quant_scale=1 / 16,
                       use_pallas=False, fengine="xla")
    for g, r in zip(planes, (rr, ri)):
        _codes_close(g.numpy(), r)

    def gram(qr, qi):
        a, p, _, c = qr.shape
        x, y = (np.asarray(q).astype(np.int64).reshape(a * p, s, c) for q in (qr, qi))
        g = lambda u, v: np.einsum("isc,jsc->cij", u, v)  # noqa: E731
        return (g(x, x) + g(y, y)).astype(np.float32), (g(y, x) - g(x, y)).astype(np.float32)

    for got, want in zip((gr, gi), gram(*planes)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip((wr, wi), gram(rr, ri)):
        np.testing.assert_array_equal(got, want)
