"""Golden model of steering-coefficient generation (counterpart of ``dpdk_dc_sand_tpu/golden/coeffs.py``).

Behavioural parity with ``beamformer/beamforming/coeff_generator.py:55-103``
and ``beamformer/unit_test/coeff_generator_cpu.py:143-186``: from CAM delay
polynomials, produce per-(channel, beam, antenna) complex steering weights,
optionally expanded to the 2×2 real rotation-block matrix layout that turns
complex beamforming into a single real matmul.

Rotation convention (coeff_generator.py:55-65)::

    rotation(c) = delay_s · c_abs · (−π) / (n_channels · T_s) + phase
                − delay_s · (n_channels/2) · (−π) / (n_channels · T_s)
                = (−π · delay_s / (n_channels · T_s)) · (c_abs − n_channels/2)
                + phase

    weight = cos(rotation) + i·sin(rotation) = exp(i · rotation)

Time extrapolation generalises the native grouped-timestamps kernel
(BeamformerKernels.cu:153-166): ``delay(t) = delay + delay_rate·t`` and
``phase(t) = phase + phase_rate·t``. (The reference CUDA contains an
apparent typo — ``fDelayRate_sps`` where ``fDelay_s`` is meant in the
channel-slope term, BeamformerKernels.cu:164 — we implement the intended
physics, which also matches the Python kernel at ``t = 0``.)

Note on delay-value indexing: the reference GPU kernel reads
``delay_vals[ant=flat//n_beams, beam=flat%n_beams]`` while writing output
element ``(beam=flat//n_ants, ant=flat%n_ants)`` (coeff_generator.py:40-47
vs :81-88), which cross-wires beams and antennas whenever delay values are
not uniform. Its own tests only use uniform delays so never see this. We
implement the straightforward mapping: the weight for (beam b, antenna a)
uses ``delay_vals[..., b, a]``.
"""

from __future__ import annotations

import numpy as np


def rotation_angle(
    delay_vals: np.ndarray,
    n_channels: int,
    n_channels_per_stream: int,
    sample_period: float,
    xeng_id: int = 0,
    t_s: float | np.ndarray = 0.0,
) -> np.ndarray:
    """Per-(channel, beam, ant) rotation angle in radians.

    Parameters
    ----------
    delay_vals:
        ``[chan_per_stream][beam][ant][4]`` f32: (delay_s, delay_rate_sps,
        phase_rad, phase_rate_radps) — layout of coeff_generator.py:164-169.
    t_s:
        Seconds past the polynomial epoch; scalar or array broadcastable
        against the leading axes (e.g. ``[time, 1, 1, 1]`` for per-timestamp
        coefficients as in BeamformerKernels.cu:149-166).
    """
    dv = np.asarray(delay_vals, np.float64)
    delay = dv[..., 0] + dv[..., 1] * np.asarray(t_s, np.float64)
    phase = dv[..., 2] + dv[..., 3] * np.asarray(t_s, np.float64)
    chan = np.arange(n_channels_per_stream) + n_channels_per_stream * xeng_id
    slope = -np.pi * delay / (n_channels * sample_period)
    # delay/phase trail with [..., chan, beam, ant]; align chan to axis -3.
    chan = chan.reshape(n_channels_per_stream, 1, 1)
    return slope * (chan - n_channels / 2.0) + phase


def steering_coeffs_complex(
    delay_vals: np.ndarray,
    n_channels: int,
    sample_period: float,
    xeng_id: int = 0,
    t_s: float | np.ndarray = 0.0,
) -> np.ndarray:
    """Complex steering weights ``[chan_per_stream][beam][ant]`` complex64."""
    dv = np.asarray(delay_vals)
    rot = rotation_angle(
        dv, n_channels, dv.shape[-4], sample_period, xeng_id, t_s
    )
    return np.exp(1j * rot).astype(np.complex64)


def complex_to_matrix(weights: np.ndarray) -> np.ndarray:
    """Expand complex weights to 2×2 real rotation blocks.

    ``[...][beam][ant]`` complex → ``[...][2·ant][2·beam]`` f32 with blocks
    ``[[cos, sin], [−sin, cos]]`` at ``(2a, 2b)`` exactly as written by
    coeff_generator.py:91-103, so that a real row-vector ``[re, im]`` times
    the block yields the complex product's (re, im).
    """
    c = weights.real.astype(np.float32)
    s = weights.imag.astype(np.float32)
    *lead, n_beams, n_ants = weights.shape
    out = np.empty(tuple(lead) + (2 * n_ants, 2 * n_beams), np.float32)
    out[..., 0::2, 0::2] = np.swapaxes(c, -1, -2)
    out[..., 0::2, 1::2] = np.swapaxes(s, -1, -2)
    out[..., 1::2, 0::2] = -np.swapaxes(s, -1, -2)
    out[..., 1::2, 1::2] = np.swapaxes(c, -1, -2)
    return out


def steering_coeffs_matrix(
    delay_vals: np.ndarray,
    n_batches: int,
    n_pols: int,
    n_channels: int,
    sample_period: float,
    xeng_id: int = 0,
) -> np.ndarray:
    """Full reference-layout coefficient matrix.

    ``[batch][pol][chan][2·ant][2·beam]`` f32 — the ``outCoeffs`` slot shape
    of coeff_generator.py:171-177 (identical across batch and pol, as in the
    reference where neither index enters the math).
    """
    w = steering_coeffs_complex(delay_vals, n_channels, sample_period, xeng_id)
    m = complex_to_matrix(w)
    return np.broadcast_to(m, (n_batches, n_pols) + m.shape).copy()
