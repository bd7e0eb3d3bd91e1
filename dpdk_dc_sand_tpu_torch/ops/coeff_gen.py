"""Steering-coefficient generation (counterpart of ``dpdk_dc_sand_tpu/ops/coeff_gen.py``).

Runs on the delay-update path (the 256-accumulation cadence), not per step:
a broadcast cos/sin over the rotation grid, plain tensor ops on the engine's
device. :func:`steering_key` is re-implemented here (the reference module
imports jax) with the identical digest, so both packages key their caches
the same way.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A contiguous host numpy view/copy of an array or tensor."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x))


def steering_key(delay_vals, ant_weights, t_s: float) -> tuple:
    """Content-digest cache key for steering-plane regeneration.

    Keyed on the *values* of the delay polynomials and antenna weights
    (never on ``id()``, which a freed array's successor can reuse).
    """
    dv = to_numpy(delay_vals)
    digest = hashlib.blake2b(dv.tobytes(), digest_size=16)
    if ant_weights is not None:
        digest.update(
            np.ascontiguousarray(to_numpy(ant_weights).astype(np.float32)).tobytes()
        )
    return (dv.shape, ant_weights is None, digest.hexdigest(), float(t_s))


def steering_coeffs(
    delay_vals: torch.Tensor,
    *,
    n_channels: int,
    n_channels_per_stream: int,
    sample_period: float = 1.0 / 1712e6,
    xeng_id: int = 0,
    t_s: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(channel, beam, ant) steering weight (cos, sin) planes.

    ``delay_vals`` is ``[chan_per_stream, beam, ant, 4]`` or ``[beam, ant,
    4]`` f32 (delay_s, delay_rate, phase_rad, phase_rate; the channel axis
    broadcasts, as in the reference); the polynomials are extrapolated to
    ``t_s``::

        rot(c) = -pi * delay(t) * (c_abs - n_channels/2) / (n_channels * T_s)
                 + phase(t)

    Returns ``(cos, sin)`` each ``[chan_per_stream, beam, ant]`` f32.
    """
    dv = delay_vals.to(torch.float32)
    t = torch.tensor(t_s, dtype=torch.float32, device=dv.device)
    delay = dv[..., 0] + dv[..., 1] * t
    phase = dv[..., 2] + dv[..., 3] * t
    chan = (
        torch.arange(n_channels_per_stream, dtype=torch.float32, device=dv.device)
        + n_channels_per_stream * xeng_id
    ).reshape(n_channels_per_stream, 1, 1)
    slope = -math.pi * delay / (n_channels * sample_period)
    rot = slope * (chan - n_channels / 2.0) + phase
    return torch.cos(rot), torch.sin(rot)


def steering_coeff_matrix(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``[..., beam, ant]`` (cos, sin) -> ``[..., 2A, 2B]`` 2x2 rotation blocks.

    Block ``[[c, s], [-s, c]]`` at ``(2a, 2b)``: samples interleaved as
    ``[re_0, im_0, re_1, ...]`` on the contraction axis give beams
    interleaved as ``[re_0, im_0, ...]``.
    """
    *lead, n_beams, n_ants = cos.shape
    m = torch.stack([torch.stack([cos, sin], -1), torch.stack([-sin, cos], -1)], -2)
    # [..., beam, ant, i, j] -> [..., ant, i, beam, j]
    m = m.movedim((-4, -3), (-2, -4))
    return m.reshape(*lead, 2 * n_ants, 2 * n_beams)


def generate_coeff_matrix(
    delay_vals: torch.Tensor,
    *,
    n_batches: int,
    n_pols: int,
    n_channels: int,
    n_channels_per_stream: int,
    sample_period: float = 1.0 / 1712e6,
    xeng_id: int = 0,
    t_s: float = 0.0,
) -> torch.Tensor:
    """The reference-layout ``[batch, pol, chan, 2A, 2B]`` f32 rotation blocks.

    Neither batch nor pol enters the math, so the blocks are one
    ``[chan, 2A, 2B]`` array broadcast (a view, not a copy) over both.
    """
    cos, sin = steering_coeffs(
        delay_vals,
        n_channels=n_channels,
        n_channels_per_stream=n_channels_per_stream,
        sample_period=sample_period,
        xeng_id=xeng_id,
        t_s=t_s,
    )
    m = steering_coeff_matrix(cos, sin)
    return m.expand(n_batches, n_pols, *m.shape)


def steering_coeff_blockcat(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``[..., beam, ant]`` (cos, sin) -> ``[..., 2A, 2B]`` block-concat weights.

    Quadrants ``[[c^T, s^T], [-s^T, c^T]]``: samples concatenated as
    ``[re_0..re_{A-1}, im_0..im_{A-1}]`` on the contraction axis give
    ``X @ W = [beam_re | beam_im]``.
    """
    ct = cos.transpose(-1, -2)  # [..., ant, beam]
    st = sin.transpose(-1, -2)
    top = torch.cat([ct, st], -1)  # [..., A, 2B]
    bot = torch.cat([-st, ct], -1)
    return torch.cat([top, bot], -2)  # [..., 2A, 2B]
