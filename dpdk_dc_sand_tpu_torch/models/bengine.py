"""Reference-layout B-engine (counterpart of ``dpdk_dc_sand_tpu/models/bengine.py``).

One X-engine's channel slice in the reference's own layouts: reorder the
ingest samples (:func:`~dpdk_dc_sand_tpu_torch.ops.reorder.prebeamform_reorder`),
generate the rotation blocks
(:func:`~dpdk_dc_sand_tpu_torch.ops.coeff_gen.generate_coeff_matrix`) and
beamform (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_matrix`).
The reference leaves all three to XLA (no Pallas kernel), so all three are
plain tensor ops here. ``delay_vals`` is an input of every call, as in the
reference: a delay update is a new argument, not a rebuild.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_matrix
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import generate_coeff_matrix
from dpdk_dc_sand_tpu_torch.ops.reorder import prebeamform_reorder


class BeamformPipeline(nn.Module):
    """Reference-layout B-engine for one X-engine's channel slice.

    Parameters
    ----------
    cfg:
        System configuration (shapes, rates).
    xeng_id:
        Which channel slice this engine owns (absolute channel
        ``c + n_channels_per_stream · xeng_id`` in the steering phases).
    precision:
        ``"f32"`` or ``"bf16"`` (weights rounded to bf16, f32 sums).
    device:
        Where the call runs; ``None`` is ``cuda`` (and raises without one:
        pass ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        xeng_id: int = 0,
        precision: str = "f32",
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.xeng_id = xeng_id
        self.precision = precision
        self.device = resolve_device(device)

    def forward(self, samples, delay_vals) -> torch.Tensor:
        """One batch set.

        ``samples``: ``[batch][ant][chan][time][pol][cplx]`` int8 ingest
        layout; ``delay_vals``: ``[chan][beam][ant][4]`` f32 delay
        polynomials. Returns ``[batch][pol][chan][block][t_in_block][2·beam]``
        f32 beams (``cfg.beam_shape``).
        """
        cfg = self.cfg
        reordered = prebeamform_reorder(
            torch.as_tensor(samples, device=self.device), cfg.n_samples_per_block
        )
        coeffs = generate_coeff_matrix(
            torch.as_tensor(delay_vals, dtype=torch.float32, device=self.device),
            n_batches=cfg.n_batches,
            n_pols=cfg.n_pols,
            n_channels=cfg.n_channels,
            n_channels_per_stream=cfg.n_channels_per_stream,
            sample_period=cfg.sample_period,
            xeng_id=self.xeng_id,
        )
        return beamform_matrix(reordered, coeffs, self.precision)

    def example_inputs(self, seed: int = 2021):
        """Seeded numpy inputs for this configuration — the reference's arrays."""
        rng = np.random.default_rng(seed)
        samples = rng.integers(-128, 127, size=self.cfg.ingest_shape, dtype=np.int8)
        dv = np.zeros(self.cfg.delay_vals_shape, np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return samples, dv
