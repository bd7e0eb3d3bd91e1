"""Beam-steering qualification on the port (features/beam_steering.feature).

The scenarios of ``test_beam_steering_qual.py`` with the same geometry,
signals and asserts, on the port's ``FBEngine`` with ``device="cpu"``: the
composed F chain and the planar B product, the backends the JAX engine
resolves with ``use_pallas=False``. Each number the scenario yields is held
against the JAX scenario's on the same inputs: the array gain and the
weighted power ratio within rtol 1e-4, the off-source beam's power within
1e-6 of the on-source power (both beams are sums of the same int8 F
codes; a code flipped by the two libraries' FFTs moves them by less) and
its dB figure within 0.1 dB (at this geometry both nulls are exact).
"""

import dataclasses

import numpy as np
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FBEngine as JFBEngine
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.models import FBEngine

K = 40
GAIN_RTOL = 1e-4
OFF_ATOL = 1e-6  # of the on-source power
OFF_DB_ATOL = 0.1


def _engines(**cfg_kw):
    cfg = ArrayConfig(**cfg_kw)
    port = FBEngine(cfg, n_spectra=8, quant_scale=1.0, fengine="xla", bstage="planar",
                    device="cpu")
    ref = JFBEngine(JArrayConfig(**dataclasses.asdict(cfg)), n_spectra=8, quant_scale=1.0,
                    use_pallas=False)
    assert (ref.fengine, ref.bstage) == (port.fengine, port.bstage)
    return port, ref


def _phased_array(fb, phases: np.ndarray) -> np.ndarray:
    """Each antenna sees the tone with its own arrival phase."""
    cfg = fb.cfg
    n = np.arange(fb.samples_in + 8)
    adc = np.zeros((cfg.n_ants, cfg.n_pols, n.size), np.float32)
    for a, phi in enumerate(phases):
        adc[a, :, :] = 80 * np.cos(2 * np.pi * K * n / cfg.fft_size + phi)
    return np.clip(np.round(adc), -127, 127).astype(np.int8)


def _beam_power(out, beam: int) -> float:
    out = np.asarray(out)
    power = out[..., 0].astype(np.float64) ** 2 + out[..., 1] ** 2
    return float(power[0, K, 4, beam])


def _zeros(n_ants):
    return np.zeros(n_ants, np.int32), np.zeros(n_ants, np.float32)


def _steered(fb, adc, dv):
    zi, zf = _zeros(fb.cfg.n_ants)
    out = fb(adc, zi, zf, zf, dv)
    return _beam_power(out, 0), _beam_power(out, 1)


def _single(fb, adc):
    zi, zf = _zeros(1)
    return _beam_power(fb(adc[:1], zi, zf, zf, np.zeros((1, 1, 4), np.float32)), 0)


def test_steered_beam_recovers_array_gain(report):
    torch.cos(torch.linspace(0, 1, 1 << 16))  # MKL's first vector cos (PERF.md §7)
    report.step("Given", "a 4-antenna array observing a tone with per-antenna phase gradients")
    fb, jfb = _engines(n_ants=4, n_channels=128, n_beams=2, n_taps=8)
    # Uniform phase gradient spanning a full turn: the boresight sum is an
    # exact null, so off-source rejection is limited only by quantisation.
    phases = np.arange(fb.cfg.n_ants) * (2 * np.pi / fb.cfg.n_ants)
    adc = _phased_array(fb, phases)
    dv = np.zeros((fb.cfg.n_beams, fb.cfg.n_ants, 4), np.float32)
    dv[0, :, 2] = -phases  # beam 0: conjugate-phase steering at the source
    report.step("When", "one beam is steered at the source and one beam away from it",
                steering_phases=[round(float(p), 3) for p in phases])
    p_on, p_off = _steered(fb, adc, dv)
    j_on, j_off = _steered(jfb, adc, dv)

    solo, jsolo = _engines(n_ants=1, n_channels=128, n_beams=1, n_taps=8)
    p_single = _single(solo, adc)
    gain, jgain = p_on / p_single, j_on / _single(jsolo, adc)
    report.step("Then", "the on-source beam recovers the coherent array gain",
                measured_gain=round(gain, 2), reference_gain=round(jgain, 2),
                ideal_gain=fb.cfg.n_ants**2)
    assert gain > 0.95 * fb.cfg.n_ants**2
    assert abs(gain - jgain) <= GAIN_RTOL * jgain

    ratio_db = 10 * np.log10(max(p_off, 1e-12 * p_on) / p_on)
    jratio_db = 10 * np.log10(max(j_off, 1e-12 * j_on) / j_on)
    report.step("And", "the off-source beam is at least 20 dB down",
                off_source_db=round(float(ratio_db), 2),
                reference_off_source_db=round(float(jratio_db), 2))
    report.detail_entry("off_source_rejection_db", round(float(ratio_db), 2))
    assert ratio_db < -20.0
    assert abs(p_off / p_on - j_off / j_on) <= OFF_ATOL
    assert abs(ratio_db - jratio_db) <= OFF_DB_ATOL


def test_antenna_weights_scale_the_beam(report):
    torch.cos(torch.linspace(0, 1, 1 << 16))
    report.step("Given", "a steered beam with one antenna weighted to zero")
    fb, jfb = _engines(n_ants=4, n_channels=128, n_beams=1, n_taps=8)
    adc = _phased_array(fb, np.zeros(fb.cfg.n_ants))
    zi, zf = _zeros(fb.cfg.n_ants)
    dv = np.zeros((fb.cfg.n_beams, fb.cfg.n_ants, 4), np.float32)
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    report.step("When", "the weighted beam is formed", weights=weights.tolist())
    ratios = []
    for eng in (fb, jfb):
        eng.set_beam_delays(dv)
        full = _beam_power(eng.step(adc, zi, zf, zf), 0)
        eng.set_beam_delays(dv, ant_weights=weights)
        ratios.append(_beam_power(eng.step(adc, zi, zf, zf), 0) / full)
    expect = ((fb.cfg.n_ants - 1) / fb.cfg.n_ants) ** 2
    report.step("Then", "the beam amplitude equals the (n_ants - 1) partial sum",
                power_ratio=round(ratios[0], 4), reference_power_ratio=round(ratios[1], 4),
                expected=round(expect, 4))
    assert abs(ratios[0] - expect) < 0.01
    assert abs(ratios[0] - ratios[1]) <= GAIN_RTOL * ratios[1]
