"""Golden model of per-antenna delay correction (F-engine side) (counterpart of ``dpdk_dc_sand_tpu/golden/delay.py``).

The reference's delay compensation contract comes from ``delay_tracking/``
(envelope: max delay = 3 × longest_baseline/c,
delay_tracking_requirements_calculator.py:145-191) and is *applied* in two
stages, standard for F-engines:

- **coarse delay**: integer-sample shift of the ADC stream before the PFB;
- **fine delay**: residual sub-sample delay applied post-FFT as a per-channel
  phase ramp — the same rotation convention as the B-engine steering
  coefficients (coeff_generator.py:55-65), so F- and B-engine phases compose.
"""

from __future__ import annotations

import numpy as np


def coarse_delay(samples: np.ndarray, delay_samples: int) -> np.ndarray:
    """Integer-sample advance of a stream.

    A positive ``delay_samples`` means this antenna's wavefront arrives
    late; compensation selects samples ``delay_samples`` later. The input
    must carry enough trailing margin; output is shortened accordingly.
    ``[..., n]`` → ``[..., n − delay_samples]``.
    """
    if delay_samples < 0:
        raise ValueError("coarse delay must be non-negative after referencing")
    if delay_samples == 0:
        return samples
    return samples[..., delay_samples:]


def fine_delay_phase(
    frac_delay_samples: np.ndarray,
    phase_rad: np.ndarray,
    n_channels: int,
    channel_offset: int = 0,
    n_channels_per_stream: int | None = None,
) -> np.ndarray:
    """Per-channel fine-delay rotation angles.

    ``rot(k) = −π · d_frac · (k_abs − n_channels/2) / n_channels + phase``
    — the B-engine convention of coeff_generator.py:55-65 with
    ``delay_s = d_frac · T_s``. ``frac_delay_samples``/``phase_rad`` are
    ``[...]``-shaped (e.g. per antenna); returns ``[..., n_chan_stream]``.
    """
    if n_channels_per_stream is None:
        n_channels_per_stream = n_channels
    k = np.arange(n_channels_per_stream, dtype=np.float64) + channel_offset
    d = np.asarray(frac_delay_samples, np.float64)[..., None]
    p = np.asarray(phase_rad, np.float64)[..., None]
    return -np.pi * d * (k - n_channels / 2.0) / n_channels + p


def apply_fine_delay(
    spectra: np.ndarray,
    frac_delay_samples: np.ndarray,
    phase_rad: np.ndarray,
    n_channels: int,
    channel_offset: int = 0,
) -> np.ndarray:
    """Rotate channelised spectra by the fine-delay phase ramp.

    ``spectra``: ``[..., n_spectra, n_chan_stream]`` complex (per antenna in
    the leading axes); ``frac_delay_samples``/``phase_rad`` broadcast against
    the leading axes. Returns same shape, complex64.
    """
    rot = fine_delay_phase(
        frac_delay_samples,
        phase_rad,
        n_channels,
        channel_offset,
        spectra.shape[-1],
    )
    return (spectra * np.exp(1j * rot)[..., None, :]).astype(np.complex64)
