"""Delay-tracking qualification on the port (features/delay_tracking.feature).

The scenarios of ``test_delay_tracking_qual.py`` with the same geometry,
signals and asserts, on the port's ``FEngine(quantise_output=False)``
with ``device="cpu"``, its ``delay_solution`` and
``ops.coeff_gen.steering_coeffs``. Each number the scenario yields is held
against the JAX scenario's on the same inputs: the phase error within
1e-4 rad, each coherence within 1e-5, the extrapolation error within 1e-5
(both sides are f32 channelisers and f32 steering planes; their FFTs and
cos/sin differ in the last bits).
"""

import dataclasses

import numpy as np
import torch

from dpdk_dc_sand_tpu import delay_solution as j_ds
from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FEngine as JFEngine
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_coeffs as j_steering_coeffs
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch import delay_solution as ds
from dpdk_dc_sand_tpu_torch.models import FEngine
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import steering_coeffs

DELAY_SAMPLES = 3.25
K = 40
PHASE_ATOL = 1e-4
COHERENCE_ATOL = 1e-5
EXTRAPOLATION_ATOL = 1e-5


def _engines():
    cfg = ArrayConfig(n_ants=2, n_channels=128, n_taps=8)
    port = FEngine(cfg, n_spectra=8, quant_scale=1.0, quantise_output=False, device="cpu")
    ref = JFEngine(JArrayConfig(**dataclasses.asdict(cfg)), n_spectra=8, quant_scale=1.0,
                   use_pallas=False, quantise_output=False)
    return port, ref


def _delayed_pair(fe):
    """Antenna 0 on time; antenna 1 sees the wavefront late."""
    fft = fe.cfg.fft_size
    n = np.arange(fe.samples_in + 64)
    adc = np.zeros((2, fe.cfg.n_pols, n.size), np.float32)
    adc[0, :, :] = 80 * np.cos(2 * np.pi * K * n / fft)
    adc[1, :, :] = 80 * np.cos(2 * np.pi * K * (n - DELAY_SAMPLES) / fft)
    return adc


def _tone_pair(out):
    out = np.asarray(out)
    z = out[..., 0] + 1j * out[..., 1]
    return z[0, 0, 4, K], z[1, 0, 4, K]


def _coherence(a0, a1):
    return float(abs(a0 + a1) / (abs(a0) + abs(a1)))


def test_delay_chain_realigns(report):
    report.step("Given", f"two antennas whose second element sees the sky "
                f"{DELAY_SAMPLES} samples late")
    fe, jfe = _engines()
    adc = _delayed_pair(fe)
    rate = fe.cfg.adc_sample_rate
    args = (np.array([0.0, DELAY_SAMPLES / rate]), np.zeros(2), np.zeros(2), np.zeros(2))
    coarse, frac, _ = ds.delay_solution(*args, t_s=0.0, adc_sample_rate=rate)
    jcoarse, jfrac, _ = j_ds.delay_solution(*args, t_s=0.0, adc_sample_rate=rate)
    np.testing.assert_array_equal(coarse, jcoarse)
    np.testing.assert_array_equal(frac, jfrac)
    report.step("When", "the F-engine corrects the coarse and fractional delay with "
                "fringe stopping", coarse_samples=[int(c) for c in coarse],
                frac_samples=[round(float(f), 3) for f in frac])
    ph = (-np.pi * frac / 2).astype(np.float32)
    a0, a1 = _tone_pair(fe(adc, coarse, frac.astype(np.float32), ph))
    j0, j1 = _tone_pair(jfe(adc, coarse, frac.astype(np.float32), ph))
    phase_err, jphase_err = float(np.angle(a1 / a0)), float(np.angle(j1 / j0))
    report.step("Then", "the two antennas' channelised voltages agree in phase at the "
                "tone channel", phase_error_rad=round(phase_err, 4),
                reference_phase_error_rad=round(jphase_err, 4))
    assert abs(phase_err) < 0.02
    assert abs(phase_err - jphase_err) <= PHASE_ATOL

    coherence, jcoherence = _coherence(a0, a1), _coherence(j0, j1)
    report.step("And", "the coherent beam sum recovers the aligned power",
                coherence=round(coherence, 5), reference_coherence=round(jcoherence, 5))
    report.detail_entry("coherence", round(coherence, 5))
    assert coherence > 0.999
    assert abs(coherence - jcoherence) <= COHERENCE_ATOL


def test_uncorrected_delay_decorrelates(report):
    report.step("Given", f"two antennas whose second element sees the sky "
                f"{DELAY_SAMPLES} samples late")
    fe, jfe = _engines()
    adc = _delayed_pair(fe)
    zi, zf = np.zeros(2, np.int32), np.zeros(2, np.float32)
    report.step("When", "the F-engine applies no delay correction")
    coherence = _coherence(*_tone_pair(fe(adc, zi, zf, zf)))
    jcoherence = _coherence(*_tone_pair(jfe(adc, zi, zf, zf)))
    # Expected phase error 2π·K·d/fft ≈ 3.19 rad → strong decorrelation.
    expected = abs(np.cos(np.pi * K * DELAY_SAMPLES / fe.cfg.fft_size))
    report.step("Then", "the beam power is measurably below the aligned power",
                coherence=round(coherence, 4), reference_coherence=round(jcoherence, 4),
                expected_from_geometry=round(float(expected), 4))
    assert coherence < 0.5
    assert abs(coherence - jcoherence) <= COHERENCE_ATOL


def test_delay_rate_extrapolation(report):
    report.step("Given", "a steering solution with a non-zero delay rate")
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2)
    rng = np.random.default_rng(5)
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 2e-9, (cfg.n_beams, cfg.n_ants))
    dv[..., 1] = rng.uniform(-1e-12, 1e-12, (cfg.n_beams, cfg.n_ants))
    dv[..., 2] = rng.uniform(-1, 1, (cfg.n_beams, cfg.n_ants))
    dv[..., 3] = rng.uniform(-0.01, 0.01, (cfg.n_beams, cfg.n_ants))

    t_s = 5.0
    report.step("When", f"the solution is extrapolated {t_s} seconds past its epoch")
    kw = dict(n_channels=cfg.n_channels, n_channels_per_stream=cfg.n_channels,
              sample_period=cfg.sample_period)
    # Fresh solution computed AT that instant (rates folded into values).
    dv2 = dv.copy()
    dv2[..., 0] += dv[..., 1] * t_s
    dv2[..., 2] += dv[..., 3] * t_s
    dv2[..., 1] = 0.0
    dv2[..., 3] = 0.0

    def plane_error(coeffs, as_input):
        cos_x, sin_x = coeffs(as_input(dv), t_s=t_s, **kw)
        cos_f, sin_f = coeffs(as_input(dv2), t_s=0.0, **kw)
        return max(float(np.abs(np.asarray(cos_x) - np.asarray(cos_f)).max()),
                   float(np.abs(np.asarray(sin_x) - np.asarray(sin_f)).max()))

    err = plane_error(steering_coeffs, torch.from_numpy)
    jerr = plane_error(j_steering_coeffs, lambda x: x)
    report.step("Then", "the extrapolated steering planes equal a solution computed at "
                "that instant", max_plane_error=err, reference_max_plane_error=jerr)
    report.detail_entry("max_plane_error", err)
    assert err < 1e-4
    assert abs(err - jerr) <= EXTRAPOLATION_ATOL
