"""End-to-end physics demo through the golden models (counterpart of ``examples/signal_chain_demo.py``).

A delayed-array CW tone -> PFB -> fine-delay correction -> beamform,
through the port's numpy oracles (:mod:`..golden`), ``ArrayConfig`` and
``DelayModel``. The steered beam shows the n_ants^2 coherent power gain; a
phase-scrambled beam decorrelates. It runs on the host only (numpy).

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.signal_chain_demo``
"""

from __future__ import annotations

import argparse

import numpy as np

from dpdk_dc_sand_tpu_torch import ArrayConfig, DelayModel, golden

N_ANTS = 8


def run() -> tuple[float, float]:
    """The two ratios: steered-beam over single-antenna power, and
    scrambled-beam over steered-beam power (linear)."""
    cfg = ArrayConfig(n_ants=N_ANTS, n_channels=256, n_beams=2, n_taps=8)
    fft = cfg.fft_size
    k = 100  # tone channel
    n_spectra = 6
    rng = np.random.default_rng(2021)

    # Per-antenna geometric delays (fractions of a sample)
    frac_delays = rng.uniform(-0.4, 0.4, cfg.n_ants)
    n = np.arange((n_spectra + cfg.n_taps - 1) * fft)
    window = golden.pfb_window(cfg.n_taps, fft)
    spectra = np.stack([
        golden.pfb_channelise(np.cos(2 * np.pi * k * (n + d) / fft), window)
        for d in frac_delays
    ])  # [ant, spectra, chan]

    # F-engine fine-delay correction per antenna
    corrected = golden.apply_fine_delay(
        spectra, frac_delays, -np.pi * frac_delays / 2, cfg.n_channels)

    # B-engine: beam 0 steered with zero residual delay (already corrected),
    # beam 1 steered with a wrong phase -> decorrelates
    dm = DelayModel.zeros(cfg.n_beams, cfg.n_ants)
    dv = dm.to_delay_vals(cfg.n_channels)  # one engine owning the whole band here
    dv[:, 1, :, 2] = rng.uniform(-np.pi, np.pi, cfg.n_ants)  # scramble beam 1 phase
    w = golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)

    x = corrected.transpose(2, 1, 0)  # [chan, time, ant]
    beams = golden.beamform_complex(x, w)  # [chan, time, beam]
    p0 = np.abs(beams[k, 3, 0]) ** 2
    p1 = np.abs(beams[k, 3, 1]) ** 2
    single = np.abs(corrected[0, 3, k]) ** 2
    return float(p0 / single), float(p1 / p0)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    gain, scrambled = run()
    print(f"steered-beam power / single-antenna power: {gain:.2f} (expect ~{N_ANTS**2})")
    print(f"scrambled-beam power / steered-beam power: {10*np.log10(scrambled):.1f} dB "
          "(expect << 0)")
    assert gain > 0.95 * N_ANTS**2
    assert scrambled < 0.3
    print("OK: coherent gain and decorrelation behave as a real beamformer should")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
