"""Array configuration and delay-model types (counterpart of ``dpdk_dc_sand_tpu/config.py``).

The same frozen dataclasses, fields, defaults, validation and derived
geometry as the reference. They live in the port so that it runs where the
reference package is absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: MeerKAT L-band digitiser rate (Hz).
ADC_SAMPLE_RATE = 1712e6

#: Polarisations per antenna.
N_POLS = 2

#: Components of a complex sample (re, im).
COMPLEXITY = 2


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Frozen description of one correlator/beamformer configuration.

    ``n_channels`` is the total channel count out of the real FFT
    (``fft_size = 2·n_channels``); ``n_taps`` the PFB prototype's taps.
    """

    n_ants: int = 64
    n_channels: int = 1024
    n_beams: int = 16
    n_samples_per_channel: int = 256
    n_pols: int = N_POLS
    adc_sample_rate: float = ADC_SAMPLE_RATE
    sample_bitwidth: int = 8
    n_taps: int = 16
    n_batches: int = 1

    def __post_init__(self) -> None:
        if self.n_channels < 1 or self.n_channels & (self.n_channels - 1):
            raise ValueError(f"n_channels must be a power of two, got {self.n_channels}")
        if self.n_samples_per_channel % self.n_samples_per_block:
            raise ValueError(
                "n_samples_per_channel must be divisible by "
                f"{self.n_samples_per_block}"
            )

    @property
    def sample_period(self) -> float:
        """ADC sampling period in seconds."""
        return 1.0 / self.adc_sample_rate

    @property
    def complexity(self) -> int:
        return COMPLEXITY

    @property
    def n_samples_per_block(self) -> int:
        """Samples per time block: 128 bits / sample bitwidth."""
        return 128 // self.sample_bitwidth

    @property
    def n_blocks(self) -> int:
        """Time blocks per batch."""
        return self.n_samples_per_channel // self.n_samples_per_block

    @property
    def n_channels_per_stream(self) -> int:
        """Channels owned by one engine (``n_channels // n_ants // 4``)."""
        return self.n_channels // self.n_ants // 4

    @property
    def n_engines(self) -> int:
        """Engines needed to cover the whole band."""
        return self.n_channels // max(self.n_channels_per_stream, 1)

    @property
    def fft_size(self) -> int:
        """Real-FFT length producing ``n_channels`` channels."""
        return 2 * self.n_channels

    @property
    def window_size(self) -> int:
        """PFB prototype filter length in samples."""
        return self.n_taps * self.fft_size

    def channel_offset(self, xeng_id: int) -> int:
        """Absolute first channel owned by engine ``xeng_id``."""
        return self.n_channels_per_stream * xeng_id

    # The reference-layout arrays of one engine's channel slice.
    @property
    def ingest_shape(self) -> tuple[int, ...]:
        """``[batch][ant][chan_per_stream][time][pol][cplx]`` int8 ingest layout."""
        return (self.n_batches, self.n_ants, self.n_channels_per_stream,
                self.n_samples_per_channel, self.n_pols, self.complexity)

    @property
    def reordered_shape(self) -> tuple[int, ...]:
        """``[batch][pol][chan][block][t_in_block][ant][cplx]`` layout."""
        return (self.n_batches, self.n_pols, self.n_channels_per_stream, self.n_blocks,
                self.n_samples_per_block, self.n_ants, self.complexity)

    @property
    def delay_vals_shape(self) -> tuple[int, ...]:
        """``[chan_per_stream][beam][ant][4]`` f32 delay polynomials."""
        return (self.n_channels_per_stream, self.n_beams, self.n_ants, 4)

    @property
    def coeff_shape(self) -> tuple[int, ...]:
        """``[batch][pol][chan][2·ant][2·beam]`` f32 rotation blocks."""
        return (self.n_batches, self.n_pols, self.n_channels_per_stream,
                2 * self.n_ants, 2 * self.n_beams)

    @property
    def beam_shape(self) -> tuple[int, ...]:
        """``[batch][pol][chan][block][t_in_block][2·beam]`` f32 beams."""
        return (self.n_batches, self.n_pols, self.n_channels_per_stream, self.n_blocks,
                self.n_samples_per_block, 2 * self.n_beams)


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Per-(beam, antenna) first-order delay and phase polynomials.

    Arrays are ``[n_beams][n_ants]`` float32, stacked as the ``[..., 4]``
    ``delay_vals`` layout ``(delay_s, delay_rate_sps, phase_rad,
    phase_rate_radps)`` that :meth:`FBEngine.set_beam_delays` takes.
    """

    delay_s: np.ndarray
    delay_rate_sps: np.ndarray
    phase_rad: np.ndarray
    phase_rate_radps: np.ndarray

    @classmethod
    def zeros(cls, n_beams: int, n_ants: int) -> "DelayModel":
        z = np.zeros((n_beams, n_ants), np.float32)
        return cls(z, z.copy(), z.copy(), z.copy())

    @classmethod
    def from_delay_vals(cls, delay_vals: np.ndarray) -> "DelayModel":
        """Build from ``[beam][ant][4]`` (or ``[chan][beam][ant][4]``, channel 0)."""
        dv = np.asarray(delay_vals, np.float32)
        if dv.ndim == 4:
            dv = dv[0]
        return cls(dv[..., 0], dv[..., 1], dv[..., 2], dv[..., 3])

    def to_delay_vals(self, n_channels_per_stream: int) -> np.ndarray:
        """Expand to the ``[chan][beam][ant][4]`` f32 layout."""
        stacked = np.stack(
            [self.delay_s, self.delay_rate_sps, self.phase_rad, self.phase_rate_radps],
            axis=-1,
        ).astype(np.float32)
        return np.broadcast_to(stacked, (n_channels_per_stream,) + stacked.shape).copy()

    def at_time(self, t_s: float) -> "DelayModel":
        """Evaluate the polynomials ``t_s`` seconds past their epoch."""
        return DelayModel(
            (self.delay_s + self.delay_rate_sps * t_s).astype(np.float32),
            self.delay_rate_sps,
            (self.phase_rad + self.phase_rate_radps * t_s).astype(np.float32),
            self.phase_rate_radps,
        )
