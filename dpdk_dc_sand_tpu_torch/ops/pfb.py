"""Composed polyphase-filterbank channeliser (counterpart of ``dpdk_dc_sand_tpu/ops/pfb.py``).

:func:`pfb_fir` launches the FIR kernel K6 (:mod:`.pfb_fir`) for a CUDA
tensor and runs its plain version for a CPU tensor; :func:`pfb_channelise`
is K6 followed by ``torch.fft.rfft`` (cuFFT on the card), as the reference
follows its FIR with XLA's real FFT. This is the composed F path of
``FEngine`` and of ``fengine="xla"`` in the FB and FXB engines.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch.golden.pfb import pfb_window  # re-export  # noqa: F401
from dpdk_dc_sand_tpu_torch.ops.pfb_fir import pfb_fir_frames


def pfb_fir(samples: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Polyphase FIR: ``[..., n]`` int8 or f32 -> ``[..., n_spectra, fft_size]`` f32.

    ``n`` must be ``(n_spectra + n_taps - 1) * fft_size``; the first
    ``n_taps - 1`` frames are history. K6 on CUDA, plain on CPU.
    """
    n_taps, fft_size = window.shape
    n = samples.shape[-1]
    if n % fft_size:
        raise ValueError(f"sample count {n} not a multiple of fft_size {fft_size}")
    n_frames = n // fft_size
    if n_frames - n_taps + 1 < 1:
        raise ValueError("need at least n_taps frames of input")
    if samples.dtype not in (torch.int8, torch.float32):
        samples = samples.to(torch.float32)
    frames = samples.reshape(*samples.shape[:-1], n_frames, fft_size)
    return pfb_fir_frames(frames, window)


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
