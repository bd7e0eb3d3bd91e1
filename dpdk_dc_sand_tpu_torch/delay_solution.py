"""Delay-solution evaluation: CAM polynomials → per-chunk engine inputs (counterpart of ``dpdk_dc_sand_tpu/delay_solution.py``).

Bridges the delay-tracking physics (:mod:`dpdk_dc_sand_tpu_torch.delay_tracking`
sizes the envelope; CAM supplies first-order polynomials, the
``struct delay_vals`` contract of BeamformerParameters.h:53-66) to what the
F-engine consumes per chunk: an integer coarse delay, a fractional
sub-sample delay, and the fringe-stopping phase. Also the stream-
realignment helpers that implement the framework's "resume" semantics
(SURVEY.md §5.4: re-subscribe and realign on SPEAD timestamps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def evaluate_delay_polynomial(
    delay_s: np.ndarray,
    delay_rate: np.ndarray,
    t_s: float,
) -> np.ndarray:
    """Total delay in seconds at ``t_s`` past the polynomial epoch."""
    return np.asarray(delay_s, np.float64) + np.asarray(delay_rate, np.float64) * t_s


def split_delay(
    total_delay_s: np.ndarray, adc_sample_rate: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a wavefront delay into (coarse_samples int32, frac_samples f32).

    Sign convention (matches the ops): a wavefront arriving *late* by
    ``total`` samples is compensated by advancing the stream ``coarse =
    ceil(total)`` whole samples (``ops.coarse_delay`` selects later
    samples), which overshoots by ``frac = coarse − total ∈ [0, 1)``; the
    post-FFT fine delay (``ops.apply_fine_delay``) then delays by ``frac``
    — its positive direction — restoring exact alignment:
    ``coarse − frac == total``.
    """
    total_samples = np.asarray(total_delay_s, np.float64) * adc_sample_rate
    coarse = np.ceil(total_samples)
    frac = coarse - total_samples
    return coarse.astype(np.int32), frac.astype(np.float32)


def fringe_phase(
    total_delay_s: np.ndarray,
    sky_frequency_hz: float,
    phase_rad: np.ndarray = 0.0,
) -> np.ndarray:
    """Fringe-stopping phase for a delay at the observing frequency.

    Delaying the RF signal rotates the carrier by ``−2π·f_sky·delay``;
    baseband processing must counter-rotate. CAM folds this into the phase
    polynomial in production; this helper computes it for simulation and
    tests. For the baseband-only convention used by our ops (band centre =
    ``n_channels/2``), ``f_sky = adc_rate/4`` reproduces the ``−π·d/2``
    residual derived in the golden-model tests.
    """
    return np.asarray(
        -2.0 * np.pi * sky_frequency_hz * np.asarray(total_delay_s, np.float64)
        + phase_rad,
        np.float64,
    )


def delay_solution(
    delay_s: np.ndarray,
    delay_rate: np.ndarray,
    phase: np.ndarray,
    phase_rate: np.ndarray,
    t_s: float,
    adc_sample_rate: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full per-antenna solution at chunk time ``t_s``.

    Returns ``(coarse int32, frac f32, phase f32)`` ready for
    :class:`~dpdk_dc_sand_tpu_torch.models.FEngine` /
    :class:`~dpdk_dc_sand_tpu_torch.engine_node.EngineNode` inputs. The phase
    polynomial is assumed to carry fringe stopping (CAM convention).
    """
    total = evaluate_delay_polynomial(delay_s, delay_rate, t_s)
    coarse, frac = split_delay(total, adc_sample_rate)
    ph = np.asarray(phase, np.float64) + np.asarray(phase_rate, np.float64) * t_s
    return coarse, frac, ph.astype(np.float32)


# ----------------------------------------------------------------------
# Stream (re)alignment — the resume contract
# ----------------------------------------------------------------------
def chunk_of_timestamp(
    timestamp: int, samples_per_chunk: int, epoch: int = 0
) -> Tuple[int, int]:
    """Map an ADC timestamp to ``(chunk_seq, offset_in_chunk)``.

    After a drop or a restart, a consumer re-subscribes and realigns on
    the next heap's timestamp (SPEAD item 0x1600); this gives the chunk
    index to resume at and how far into it the timestamp lands.
    """
    rel = int(timestamp) - int(epoch)
    if rel < 0:
        raise ValueError("timestamp precedes the stream epoch")
    return rel // samples_per_chunk, rel % samples_per_chunk


def next_aligned_timestamp(
    timestamp: int, samples_per_chunk: int, epoch: int = 0
) -> int:
    """Smallest chunk-boundary timestamp ≥ ``timestamp`` (resume point)."""
    seq, off = chunk_of_timestamp(timestamp, samples_per_chunk, epoch)
    if off == 0:
        return int(timestamp)
    return epoch + (seq + 1) * samples_per_chunk
