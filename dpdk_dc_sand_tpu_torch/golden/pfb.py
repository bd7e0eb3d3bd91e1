"""Golden model of the polyphase-filterbank (PFB) channeliser (counterpart of ``dpdk_dc_sand_tpu/golden/pfb.py``).

The reference's F-engine lived in ``katfgpu`` (merge_gpu_repositories/
do_merge.sh:4-10); dc_sand carries its transmit side
(``fgpu_send_prototype``) and its acceptance contract — peak in the channel
centre, out-of-channel response ≤ −62 dB
(bdd_experiment/test/features/channelisation.feature:5-9). This module
defines that channeliser: an ``n_taps``-tap windowed-sinc polyphase FIR
followed by a real-to-complex FFT of length ``2·n_channels``, keeping bins
``0..n_channels-1``.
"""

from __future__ import annotations

import numpy as np


def pfb_window(n_taps: int, fft_size: int, dtype=np.float32) -> np.ndarray:
    """Hann-windowed sinc prototype filter, shaped ``[n_taps, fft_size]``.

    The classic radio-astronomy PFB prototype: ``sinc(x/N)·hann`` over
    ``n_taps·N`` points, normalised to unit DC gain per polyphase branch so
    a constant input maps to a constant channel-0 response.
    """
    length = n_taps * fft_size
    n = np.arange(length, dtype=np.float64)
    x = (n - (length - 1) / 2.0) / fft_size
    proto = np.sinc(x) * np.hanning(length)
    # Unit-sum normalisation keeps output scale independent of n_taps.
    proto /= proto.sum() / fft_size
    return proto.reshape(n_taps, fft_size).astype(dtype)


def pfb_fir(samples: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Polyphase FIR: weighted sum of ``n_taps`` overlapping frames.

    Parameters
    ----------
    samples:
        ``[..., n_samples]`` real input; ``n_samples`` must equal
        ``(n_spectra + n_taps − 1) · fft_size``.
    window:
        ``[n_taps, fft_size]`` prototype from :func:`pfb_window`.

    Returns
    -------
    ``[..., n_spectra, fft_size]`` float32 — one FIR-combined frame per
    output spectrum (the overlap-save structure whose halo is exchanged
    between time shards in the distributed pipeline).
    """
    n_taps, fft_size = window.shape
    *lead, n = samples.shape
    if n % fft_size:
        raise ValueError(f"sample count {n} not a multiple of fft_size {fft_size}")
    n_frames = n // fft_size
    n_spectra = n_frames - n_taps + 1
    if n_spectra < 1:
        raise ValueError("need at least n_taps frames of input")
    frames = samples.reshape(*lead, n_frames, fft_size).astype(np.float32)
    out = np.zeros((*lead, n_spectra, fft_size), np.float32)
    for tap in range(n_taps):
        out += frames[..., tap : tap + n_spectra, :] * window[tap]
    return out


def pfb_channelise(samples: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Full PFB: FIR + real FFT, keeping ``fft_size // 2`` channels.

    Returns ``[..., n_spectra, n_channels]`` complex64.
    """
    fir = pfb_fir(samples, window)
    spectra = np.fft.rfft(fir, axis=-1)[..., : window.shape[1] // 2]
    return spectra.astype(np.complex64)
