"""Composed polyphase-filterbank channeliser (counterpart of ``dpdk_dc_sand_tpu/ops/pfb.py``).

A plain version only — FIR tap sum + ``torch.fft.rfft`` — used by the tests'
leakage and composed-path checks. The main path's channeliser is the fused
kernel in :mod:`.fengine_fused`.
"""

from __future__ import annotations

import numpy as np
import torch


def pfb_window(n_taps: int, fft_size: int) -> np.ndarray:
    """Hann-windowed sinc prototype ``[n_taps, fft_size]`` f32, as the reference builds it.

    ``sinc(x/N)·hann`` over ``n_taps·N`` points in float64, normalised to
    unit DC gain per polyphase branch, then rounded once to f32
    (``dpdk_dc_sand_tpu/golden/pfb.py:pfb_window``).
    """
    length = n_taps * fft_size
    n = np.arange(length, dtype=np.float64)
    x = (n - (length - 1) / 2.0) / fft_size
    proto = np.sinc(x) * np.hanning(length)
    proto /= proto.sum() / fft_size
    return proto.reshape(n_taps, fft_size).astype(np.float32)


def pfb_fir(samples: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Polyphase FIR: ``[..., n]`` real -> ``[..., n_spectra, fft_size]`` f32.

    ``n`` must be ``(n_spectra + n_taps - 1) * fft_size``; the first
    ``n_taps - 1`` frames are history.
    """
    n_taps, fft_size = window.shape
    n = samples.shape[-1]
    if n % fft_size:
        raise ValueError(f"sample count {n} not a multiple of fft_size {fft_size}")
    n_frames = n // fft_size
    n_spectra = n_frames - n_taps + 1
    if n_spectra < 1:
        raise ValueError("need at least n_taps frames of input")
    f = samples.reshape(*samples.shape[:-1], n_frames, fft_size).to(torch.float32)
    w = window.to(torch.float32)
    out = f[..., 0:n_spectra, :] * w[0]
    for tap in range(1, n_taps):
        out = out + f[..., tap : tap + n_spectra, :] * w[tap]
    return out


def pfb_channelise(
    samples: torch.Tensor, window: torch.Tensor, n_channels: int | None = None
) -> torch.Tensor:
    """Full PFB: ``[..., n]`` real -> ``[..., n_spectra, n_channels]`` complex64."""
    fir = pfb_fir(samples, window)
    if n_channels is None:
        n_channels = window.shape[1] // 2
    return torch.fft.rfft(fir, dim=-1)[..., :n_channels].to(torch.complex64)


def default_window(n_taps: int, fft_size: int, device=None) -> torch.Tensor:
    """The canonical Hann-sinc prototype ``[n_taps, fft_size]`` f32."""
    return torch.as_tensor(pfb_window(n_taps, fft_size), device=device)
