"""FXB engine: one F stage feeding both the beamformer and the correlator (counterpart of ``dpdk_dc_sand_tpu/models/fxbengine.py``).

The channelised, delay-corrected, requantised int8 planes are computed once
per step (K1, or with ``fengine="xla"`` the composed chain: K6 FIR, cuFFT
rfft, plain fine delay and requant) and consumed twice on the device: by
the B stage (``_b_stage``, any of the reference's B forms; at the flagship
the turned form, K4 + the folded f32 product, and ``"planar"`` where
neither K2's nor K4's gate takes the geometry) and by the X stage, whose
kernel the geometry picks exactly as the reference picks it
(:func:`_x_stage`): the turn + gram kernel K3, else the corner turn (K5a =
K4) and the turned gram K5b, else the plain grams. As in the reference,
FXB has no native F->B handoff.

The reference's Mosaic schedule knobs (``fengine_s_blk``, ``_vmem_mb``,
``_pipeline``, ``_tapouter``, ``_bfuse``, ``_skew``, ``_rolling``,
``_flat_out``, ``ct_batch_a``, ``use_pallas``, ``fengine_interpret``) have
no counterpart here.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models.fbengine import FBEngine, _b_stage
from dpdk_dc_sand_tpu_torch.ops.corner_turn import (
    corner_turn_planes_x,
    corner_turn_x_supported,
)
from dpdk_dc_sand_tpu_torch.ops.correlate import correlate_planes, correlate_turned
from dpdk_dc_sand_tpu_torch.ops.xcorr import (
    correlate_planes_fused,
    correlate_turned_fused,
    xcorr_fused_supported,
    xcorr_supported,
)


class FXBEngine(FBEngine):
    """Fused F + X + B signal chain on one device.

    Per step returns ``(beams, vis_re, vis_im)``:

    - beams ``[P, C, S, B, 2]`` f32 (int8 when ``beam_quant_scale`` is set);
    - visibilities ``[C, I, I]`` f32 each, the step's spectra integrated,
      ``I = n_ants · n_pols`` inputs ordered ``a·P + p`` (accumulate across
      steps with :class:`~dpdk_dc_sand_tpu_torch.models.xengine.VisibilityAccumulator`).

    ``fengine`` / ``bstage`` resolve as the reference's do
    (:func:`~dpdk_dc_sand_tpu_torch.models.fbengine.resolve_backends`, split
    beams): at the flagship the fused F kernel and the turned B stage;
    ``"planar"`` and ``"folded"`` pass through to the shared B stage.
    ``vis_precision`` (``"auto"`` = ``"int8"``) is the precision of the
    plain grams; the kernels are exact int8 whatever it is. ``device``:
    ``None`` is ``cuda``; pass ``device="cpu"`` for the CPU.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 32,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        fengine: str = "auto",
        bstage: str = "auto",
        beam_quant_scale: float | None = None,
        vis_precision: str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        if vis_precision not in ("auto", "int8", "f32", "bf16"):
            raise ValueError(f"unknown vis_precision {vis_precision!r}")
        super().__init__(
            cfg, n_spectra=n_spectra, quant_scale=quant_scale, precision=precision,
            fengine=fengine, bstage=bstage, beam_quant_scale=beam_quant_scale,
            beam_layout="split", device=device,
        )
        self.vis_precision = "int8" if vis_precision == "auto" else vis_precision

    def step(self, adc, coarse_delays, frac_delays, phases):
        """Hot-loop step using the cached steering blocks: ``(beams, vis_re, vis_im)``."""
        if self.coeff_blocks is None:
            raise RuntimeError("call set_beam_delays() first")
        qr, qi = self._f(adc, coarse_delays, frac_delays, phases)
        beams = _b_stage(
            qr, qi, self.coeff_blocks,
            cfg=self.cfg, precision=self.precision, bstage=self.bstage,
            beam_quant_scale=self.beam_quant_scale,
        )
        vis_re, vis_im = _x_stage(qr, qi, self.vis_precision)
        return beams, vis_re, vis_im


def _x_stage(
    qr: torch.Tensor, qi: torch.Tensor, vis_precision: str = "int8"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's X dispatch by geometry (``fxbengine.py:282-322``).

    K3 when ``xcorr_fused_supported``; else, when ``corner_turn_x_supported``,
    the turn (K5a) and then K5b when ``xcorr_supported``, or the plain
    turned grams; else the plain transpose and grams. A branch is chosen by
    shape only; a CUDA tensor in a kernel's branch launches it or raises.
    """
    a, p, s, c = qr.shape
    if corner_turn_x_supported(a, p, s, c):
        if xcorr_fused_supported(a, p, s, c):
            return correlate_planes_fused(qr, qi)
        xt = corner_turn_planes_x(qr, qi)
        if xcorr_supported(c, s):
            return correlate_turned_fused(xt, a * p)
        return correlate_turned(xt, a * p, vis_precision)
    cr = qr.permute(3, 2, 0, 1).reshape(c, s, a * p)
    ci = qi.permute(3, 2, 0, 1).reshape(c, s, a * p)
    return correlate_planes(cr, ci, vis_precision)
