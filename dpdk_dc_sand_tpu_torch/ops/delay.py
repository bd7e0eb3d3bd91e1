"""Per-antenna delay correction (counterpart of ``dpdk_dc_sand_tpu/ops/delay.py``).

Coarse delay = per-antenna integer-sample window selection; fine delay =
the residual sub-sample delay applied after the FFT as a per-channel phase
rotation, band-centre referenced (the B-engine steering convention).
"""

from __future__ import annotations

import math

import torch


def clamp_starts(delays: torch.Tensor, n_samples: int, out_len: int) -> torch.Tensor:
    """Window starts clamped exactly as ``jax.lax.dynamic_slice`` clamps.

    ``start = min(max(delay, 0), n_samples - out_len)``: a window can never
    run past the end of the stream (the fused F kernel relies on this — it
    reads ``[start, start + out_len)`` with no bounds check).
    """
    if n_samples < out_len:
        raise ValueError(f"stream of {n_samples} samples < window {out_len}")
    return delays.to(torch.int64).clamp(0, n_samples - out_len)


def coarse_delay(
    stream: torch.Tensor, delay_samples: torch.Tensor, out_len: int
) -> torch.Tensor:
    """Select per-antenna windows offset by integer delays.

    ``stream`` is ``[n_ants, ..., n_samples]``, ``delay_samples`` ``[n_ants]``;
    returns ``[n_ants, ..., out_len]`` with antenna ``a`` advanced by its
    (clamped) delay.
    """
    starts = clamp_starts(
        torch.as_tensor(delay_samples), stream.shape[-1], out_len
    ).tolist()
    return torch.stack(
        [stream[a, ..., s : s + out_len] for a, s in enumerate(starts)]
    )


def apply_fine_delay(
    spectra_re: torch.Tensor,
    spectra_im: torch.Tensor,
    frac_delay_samples,
    phase_rad,
    *,
    n_channels: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate ``[..., S, C]`` (re, im) planes by the fine-delay phase ramp.

    ``rot(k) = -pi * d_frac * (k - n_channels/2) / n_channels + phase``;
    ``frac_delay_samples`` / ``phase_rad`` broadcast against the leading axes.
    """
    dev = spectra_re.device
    k = torch.arange(spectra_re.shape[-1], dtype=torch.float32, device=dev)
    d =torch.as_tensor(frac_delay_samples, dtype=torch.float32, device=dev)
    p = torch.as_tensor(phase_rad, dtype=torch.float32, device=dev)
    d, p = d[..., None, None], p[..., None, None]
    rot = -math.pi * d * (k - n_channels / 2.0) / n_channels + p
    c, s = torch.cos(rot), torch.sin(rot)
    re = spectra_re.to(torch.float32)
    im = spectra_im.to(torch.float32)
    return re * c - im * s, re * s + im * c
