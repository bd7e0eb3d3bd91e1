"""Standalone F-engine: coarse delay -> PFB -> fine delay -> requantise (counterpart of ``dpdk_dc_sand_tpu/models/fengine.py``).

The composed F path: the coarse delay selects each antenna's window, the
polyphase FIR runs as K6 (:func:`~dpdk_dc_sand_tpu_torch.ops.pfb.pfb_fir`)
on the card, ``torch.fft.rfft`` (cuFFT) channelises, and the fine-delay
rotation and the requantisation are plain PyTorch, as the reference leaves
them to XLA. :func:`composed_f` is also the ``fengine="xla"`` F stage of
the FB and FXB engines.

Memory: at the flagship (80 ant × 2 pol × 256 spectra × 65536) the FIR
output is 10.7 GB of f32 and its full rfft another 10.7 GB of complex64.
:func:`composed_f` keeps the FIR output, frees the coarse-delayed copy as
soon as the FIR has read it, and runs the rfft, the rotation and the
requant a few antennas at a time (about 1 GiB of FIR output per chunk),
writing each chunk straight into the caller's int8 planes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops.delay import apply_fine_delay, coarse_delay
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window, pfb_fir
from dpdk_dc_sand_tpu_torch.ops.requant import requantise

#: FIR-output bytes per rfft chunk (a whole number of antennas, at least one).
_CHUNK_BYTES = 1 << 30


def composed_f(
    adc: torch.Tensor,
    coarse_delays: torch.Tensor,
    frac_delays: torch.Tensor,
    phases: torch.Tensor,
    window: torch.Tensor,
    out_re: torch.Tensor,
    out_im: torch.Tensor,
    *,
    quant_scale: float,
    quantise: bool = True,
    fir=pfb_fir,
) -> None:
    """The composed F chain, written into ``out_re`` / ``out_im``.

    ``adc`` ``[A, P, n]`` int8 or f32 with delay margin; ``coarse_delays``,
    ``frac_delays``, ``phases`` ``[A]``; ``out_re`` / ``out_im``
    ``[A, P, S, C]`` (views are fine): int8 ``requantise(x, quant_scale)``,
    or f32 ``x · quant_scale`` when ``quantise=False``. ``fir`` is the FIR
    over ``[..., n]`` samples (K6 through :func:`pfb_fir`; a caller may pass
    the plain version to compare).
    """
    n_ants, _, n_spectra, n_channels = out_re.shape
    n_taps, fft = window.shape
    aligned = coarse_delay(adc, coarse_delays, (n_spectra + n_taps - 1) * fft)
    spectra_in = fir(aligned, window)  # [A, P, S, fft] f32
    del aligned
    step = max(1, _CHUNK_BYTES // (spectra_in[0].numel() * spectra_in.element_size()))
    for a0 in range(0, n_ants, step):
        a = slice(a0, a0 + step)
        spec = torch.fft.rfft(spectra_in[a], dim=-1)[..., :n_channels]
        re, im = apply_fine_delay(spec.real, spec.imag, frac_delays[a, None], phases[a, None],
                                  n_channels=n_channels)
        del spec
        for dst, v in ((out_re, re), (out_im, im)):
            dst[a] = requantise(v, quant_scale) if quantise else v * quant_scale


class FEngine(nn.Module):
    """Per-antenna channeliser front end on one device.

    Parameters
    ----------
    cfg:
        System configuration: ``cfg.n_channels`` channels from real
        ``2·n_channels``-point frames with a ``cfg.n_taps``-tap prototype.
    n_spectra:
        Output spectra (time samples per channel) per step.
    quant_scale:
        Requantisation gain applied before the int8 output stage.
    quantise_output:
        int8 output (the transport format), else f32 ``x · quant_scale``
        (for qualification measurements of the filter response).
    device:
        Where the window lives and the step runs; ``None`` is ``cuda``.

    The reference's ``use_pallas`` has no counterpart: on the card the FIR
    is always K6, on the CPU its plain version.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        quantise_output: bool = True,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.n_spectra = n_spectra
        self.quant_scale = quant_scale
        self.quantise_output = quantise_output
        self.device = resolve_device(device)
        self.register_buffer("window", default_window(cfg.n_taps, cfg.fft_size, self.device))

    @property
    def samples_in(self) -> int:
        """ADC samples consumed per antenna-pol per step (excl. delay margin)."""
        return (self.n_spectra + self.cfg.n_taps - 1) * self.cfg.fft_size

    def forward(self, adc, coarse_delays, frac_delays, phases) -> torch.Tensor:
        """One channelisation step.

        ``adc`` ``[A, P, n_in]`` int8 (or f32) with ``n_in >= samples_in +
        max(coarse_delays)``; ``coarse_delays`` ``[A]`` whole samples;
        ``frac_delays`` ``[A]`` fractional samples; ``phases`` ``[A]``
        fringe-stopping phase. Returns ``[A, P, S, C, 2]`` (re, im): int8,
        or f32 when ``quantise_output=False``.
        """
        cfg = self.cfg
        adc = torch.as_tensor(adc, device=self.device)
        out = torch.empty(
            (cfg.n_ants, cfg.n_pols, self.n_spectra, cfg.n_channels, 2),
            dtype=torch.int8 if self.quantise_output else torch.float32,
            device=self.device,
        )
        composed_f(
            adc.reshape(cfg.n_ants, cfg.n_pols, -1),
            torch.as_tensor(coarse_delays, device=self.device),
            torch.as_tensor(frac_delays, dtype=torch.float32, device=self.device),
            torch.as_tensor(phases, dtype=torch.float32, device=self.device),
            self.window, out[..., 0], out[..., 1],
            quant_scale=self.quant_scale, quantise=self.quantise_output,
        )
        return out

    def example_inputs(self, seed: int = 2021, margin: int = 64):
        """Random numpy inputs for one step — the same arrays as the reference."""
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        adc = rng.integers(
            -64, 64, size=(cfg.n_ants, cfg.n_pols, self.samples_in + margin), dtype=np.int8
        )
        cd = rng.integers(0, margin, size=cfg.n_ants).astype(np.int32)
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        return adc, cd, fd, ph
