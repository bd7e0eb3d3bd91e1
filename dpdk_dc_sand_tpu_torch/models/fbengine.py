"""Fused F+B pipeline — the flagship single-device model (counterpart of ``dpdk_dc_sand_tpu/models/fbengine.py``).

ADC streams -> coarse delay -> PFB channelise -> fine delay -> requantise
(K1, :func:`~dpdk_dc_sand_tpu_torch.ops.fengine_fused.fengine_fused`; or,
with ``fengine="xla"``, the composed chain of
:func:`~dpdk_dc_sand_tpu_torch.models.fengine.composed_f`: K6 FIR, cuFFT
rfft, plain fine delay and requant) -> corner turn + multi-beam beamform,
in one of the reference's B forms (``bstage``):

- ``"fused"``: one kernel (K2,
  :func:`~dpdk_dc_sand_tpu_torch.ops.bstage.beamform_turned_fused`);
- ``"turned"``: the corner-turn kernel (K4,
  :func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_planes`) then a
  folded f32 product
  (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_turned`); with
  ``fengine_native_handoff=True`` the native turn of each plane instead (K8,
  :func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_plane_native`)
  and the split product
  (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_turned_split`);
- ``"folded"``: an int8 turn copy and one folded product per channel
  (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_planes_folded`);
- ``"planar"``: four real products on (cos, sin) weights
  (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_planes`), for every
  geometry.

The steering weights and fine-rotation planes are regenerated only when the
delay solution's values change (the 256-accumulation cadence).

The reference's TPU schedule knobs (``fengine_s_blk``, ``_vmem_mb``,
``_pipeline``, ``_tapouter``, ``_bfuse``, ``_skew``, ``_rolling``,
``_flat_out``, ``ct_batch_a``) are Mosaic scheduling, not semantics, and
have no counterpart here.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.models.fengine import composed_f
from dpdk_dc_sand_tpu_torch.ops.beamform import (
    beamform_planes,
    beamform_planes_folded,
    beamform_turned,
    beamform_turned_split,
)
from dpdk_dc_sand_tpu_torch.ops.bstage import (
    beamform_turned_fused,
    bstage_fused_supported,
    reference_fused_gate,
)
from dpdk_dc_sand_tpu_torch.ops.corner_turn import (
    corner_turn_native_supported,
    corner_turn_plane_native,
    corner_turn_planes,
    corner_turn_supported,
)
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import (
    steering_coeff_blockcat,
    steering_coeffs,
    steering_key,
    to_numpy,
)
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import (
    _deint_mode,
    fengine_fused,
    fine_rotation_planes,
    ingest_alignment,
)
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window
from dpdk_dc_sand_tpu_torch.ops.requant import requantise

def resolve_backends(
    cfg: ArrayConfig,
    n_spectra: int,
    fengine: str = "auto",
    bstage: str = "auto",
    beam_layout: str = "split",
) -> tuple[str, str]:
    """Resolve ``"auto"`` backends by the reference's rule (``fbengine.py:73-93``).

    The hand-written kernels always run, so the reference's "Pallas
    available" condition is always true here: ``fengine`` resolves to
    ``"fused"`` (``"xla"``, the composed chain, only when asked for);
    ``bstage`` to ``"fused"`` for natural beams when the reference's K2
    gate takes the geometry, else ``"turned"`` when the corner turn's does,
    else ``"fused"`` when K2's does, else ``"planar"``.
    Explicit choices pass through unchanged.
    """
    if fengine == "auto":
        fengine = "fused"
    if bstage == "auto":
        fused_ok = reference_fused_gate(
            cfg.n_ants, cfg.n_pols, n_spectra, cfg.n_beams, cfg.n_channels
        )
        turned_ok = corner_turn_supported(cfg.n_ants, cfg.n_pols, n_spectra, cfg.n_channels)
        if beam_layout == "natural" and fused_ok:
            bstage = "fused"
        elif turned_ok:
            bstage = "turned"
        elif fused_ok:
            bstage = "fused"
        else:
            bstage = "planar"
    return fengine, bstage


def _check_bstage(cfg: ArrayConfig, n_spectra: int, bstage: str) -> None:
    """Raise for a geometry that an explicitly chosen kernel B form does not
    cover (``"planar"`` and ``"folded"`` take every geometry)."""
    if bstage == "fused":
        ok = bstage_fused_supported(
            cfg.n_ants, cfg.n_pols, n_spectra, cfg.n_beams, cfg.n_channels
        )
    elif bstage == "turned":
        ok = corner_turn_supported(cfg.n_ants, cfg.n_pols, n_spectra, cfg.n_channels)
    else:
        ok = True
    if not ok:
        raise NotImplementedError(
            f"the {bstage} B stage does not cover this geometry ({cfg}, "
            f"n_spectra={n_spectra}): the reference's gate refuses it; "
            'bstage="planar" or "folded" take every geometry'
        )


def _check_native_handoff(cfg: ArrayConfig, n_spectra: int, fengine: str, bstage: str) -> None:
    """The reference's gate of the native F->B handoff (``fbengine.py:236-255``)."""
    mode, n1, n2 = _deint_mode(cfg.n_channels)
    if not (
        fengine in ("fused", "fused_f32")
        and bstage == "turned"
        and mode == "ct"
        and corner_turn_native_supported(cfg.n_ants, cfg.n_pols, n_spectra, n2 // 2, n1)
    ):
        raise ValueError(
            "fengine_native_handoff needs the fused direct-CT F kernel with the "
            "turned B stage on a supported geometry"
        )


def _rot_key(frac_delays, phases) -> str:
    """Content digest of the fine-delay solution (the rotation-plane cache key)."""
    fdn = np.ascontiguousarray(to_numpy(frac_delays), np.float32)
    phn = np.ascontiguousarray(to_numpy(phases), np.float32)
    return hashlib.blake2b(fdn.tobytes() + phn.tobytes(), digest_size=16).hexdigest()


class FBEngine(nn.Module):
    """End-to-end F+B signal chain over the full band on one device.

    Parameters
    ----------
    cfg:
        System configuration; all ``cfg.n_channels`` channels are
        channelised and beamformed.
    n_spectra:
        Spectra per step (time samples per channel).
    quant_scale:
        F-engine output requantisation gain.
    precision:
        Beamform precision, ``"f32"`` or ``"bf16"`` (steering blocks are
        stored in this dtype).
    fengine:
        ``"auto"`` / ``"fused"`` (K1, bf16 DFT operands), ``"fused_f32"``
        (K1 with f32 DFT operands) or ``"xla"`` (the composed chain: K6
        FIR, cuFFT rfft, plain fine delay and requant).
    bstage:
        ``"fused"`` (K2), ``"turned"`` (K4 + the folded f32 product),
        ``"folded"`` or ``"planar"`` (plain products); ``"auto"`` resolves
        by :func:`resolve_backends`, the reference's rule.
    beam_quant_scale:
        When set, beams are requantised to int8 with this gain.
    beam_layout:
        ``"split"``: ``[P, C, S, B, 2]`` beams. ``"natural"`` (``bstage``
        ``"fused"`` or ``"turned"`` only): K2's packed ``[C/pack, P·S,
        pack·2B]`` wire format, or the turned product's ``[C, P·S, 2B]``; no
        epilogue.
    fengine_native_handoff:
        ``True``: each int8 F plane goes to the B stage as K1 wrote it,
        viewed ``[A, P, S, N2/2, N1]``, turned on its own (K8) and
        beamformed by the split product; it needs the fused direct-CT F and
        ``bstage="turned"`` on a geometry the reference's native gate takes
        (else ``ValueError``). ``"auto"`` resolves ``False``, as in the
        reference.
    device:
        Where the buffers live and the step runs; ``None`` is ``cuda`` (and
        raises without one: pass ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        fengine: str = "auto",
        bstage: str = "auto",
        beam_quant_scale: float | None = None,
        beam_layout: str = "split",
        fengine_native_handoff: bool | str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if fengine not in ("auto", "fused", "fused_f32", "xla"):
            raise ValueError(f"unknown fengine backend {fengine!r}")
        if bstage not in ("auto", "planar", "folded", "turned", "fused"):
            raise ValueError(f"unknown bstage backend {bstage!r}")
        if beam_layout not in ("split", "natural"):
            raise ValueError(f"unknown beam_layout {beam_layout!r}")
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        fengine, bstage = resolve_backends(cfg, n_spectra, fengine, bstage, beam_layout)
        if beam_layout == "natural" and bstage not in ("turned", "fused"):
            raise ValueError(
                'beam_layout="natural" requires bstage "turned" or "fused" '
                f"(resolved bstage={bstage!r} for this geometry/backend)"
            )
        _check_bstage(cfg, n_spectra, bstage)
        if fengine_native_handoff == "auto":
            fengine_native_handoff = False
        if fengine_native_handoff:
            _check_native_handoff(cfg, n_spectra, fengine, bstage)
        self.cfg = cfg
        self.n_spectra = n_spectra
        self.quant_scale = quant_scale
        self.precision = precision
        self.fengine = fengine
        self.bstage = bstage
        self.beam_quant_scale = beam_quant_scale
        self.beam_layout = beam_layout
        self.fengine_native_handoff = bool(fengine_native_handoff)
        self.device = resolve_device(device)
        self.register_buffer("window", default_window(cfg.n_taps, cfg.fft_size, self.device))
        #: Steering weights in the precision's dtype — block-concat
        #: [C, 2A, 2B], or for bstage="planar" the stacked (cos, sin)
        #: [2, C, B, A] — and fine-rotation planes [A, P, N2/2, N1] f32:
        #: content-keyed delay-update caches.
        self.register_buffer("coeff_blocks", None)
        self.register_buffer("rot_cos", None)
        self.register_buffer("rot_sin", None)
        self._coeff_key = None
        self._rot_key = None

    @property
    def samples_in(self) -> int:
        return (self.n_spectra + self.cfg.n_taps - 1) * self.cfg.fft_size

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def set_beam_delays(self, delay_vals, ant_weights=None, t_s: float = 0.0) -> None:
        """(Re)generate the steering blocks from ``[B, A, 4]`` delay polynomials.

        Regenerated only when the values of ``delay_vals`` / ``ant_weights``
        / ``t_s`` change (content digest, :func:`steering_key`).
        ``ant_weights``: optional ``[A]`` magnitude weights folded in;
        ``t_s``: seconds past the polynomial epoch (rates extrapolate).
        """
        key = steering_key(delay_vals, ant_weights, t_s)
        if self.coeff_blocks is None or key != self._coeff_key:
            w = (
                torch.ones(self.cfg.n_ants, dtype=torch.float32, device=self.device)
                if ant_weights is None
                else self._tensor(ant_weights, torch.float32)
            )
            self.coeff_blocks = _coeff_blocks(
                self._tensor(delay_vals), w, t_s, cfg=self.cfg,
                dtype=torch.bfloat16 if self.precision == "bf16" else torch.float32,
                folded=self.bstage != "planar",
            )
            self._coeff_key = key

    def _fine_rot(self, frac_delays, phases) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached fine-delay rotation planes, content-keyed like the blocks."""
        key = _rot_key(frac_delays, phases)
        if self.rot_cos is None or key != self._rot_key:
            cfg = self.cfg
            fd = self._tensor(frac_delays, torch.float32)[:, None]
            ph = self._tensor(phases, torch.float32)[:, None]
            self.rot_cos, self.rot_sin = fine_rotation_planes(
                fd.expand(cfg.n_ants, cfg.n_pols),
                ph.expand(cfg.n_ants, cfg.n_pols),
                n_channels=cfg.n_channels,
                quant_scale=self.quant_scale,
            )
            self._rot_key = key
        return self.rot_cos, self.rot_sin

    def _f(self, adc, coarse_delays, frac_delays, phases) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's F planes, int8 ``(qr, qi)`` ``[A, P, S, C]`` (viewed
        ``[A, P, S, N2/2, N1]`` with the native handoff)."""
        if self.fengine == "xla":
            rot, delays = None, (self._tensor(frac_delays, torch.float32),
                                 self._tensor(phases, torch.float32))
        else:
            rot, delays = self._fine_rot(frac_delays, phases), None
        return _f_stage(
            self._tensor(adc), self._tensor(coarse_delays), self.window, rot,
            cfg=self.cfg, n_spectra=self.n_spectra, quant_scale=self.quant_scale,
            fengine=self.fengine, fine_delays=delays,
            planes_native=self.fengine_native_handoff,
        )

    def step(self, adc, coarse_delays, frac_delays, phases) -> torch.Tensor:
        """Hot-loop step using the cached steering blocks."""
        if self.coeff_blocks is None:
            raise RuntimeError("call set_beam_delays() first")
        qr, qi = self._f(adc, coarse_delays, frac_delays, phases)
        return _b_stage(
            qr, qi, self.coeff_blocks,
            cfg=self.cfg, precision=self.precision, bstage=self.bstage,
            beam_quant_scale=self.beam_quant_scale, beam_layout=self.beam_layout,
        )

    def forward(self, adc, coarse_delays, frac_delays, phases, delay_vals):
        """One pipeline step (``set_beam_delays(delay_vals)`` then :meth:`step`).

        ``adc``: ``[A, P, n_in]`` or wire-rowed ``[A, P, rows, N2]`` int8 with
        delay margin; ``coarse_delays`` / ``frac_delays`` / ``phases``:
        ``[A]``; ``delay_vals``: ``[B, A, 4]`` f32 steering polynomials.
        Returns ``[P, C, S, B, 2]`` beams (``beam_layout="split"``) or, for
        ``"natural"``, K2's packed ``[C/pack, P·S, pack·2B]`` form
        (``bstage="fused"``) or the turned product's ``[C, P·S, 2B]``
        (``bstage="turned"``, with or without the native handoff), as in
        the reference.
        """
        self.set_beam_delays(delay_vals)
        return self.step(adc, coarse_delays, frac_delays, phases)

    def example_inputs(
        self, seed: int = 2021, margin: int = 64,
        delay_budget: int | None = None, rowed: bool = False,
    ):
        """Random numpy inputs for one step — the same arrays as the reference.

        ``margin`` is the total trailing headroom beyond ``samples_in``;
        ``delay_budget`` bounds the drawn coarse delays (default: the whole
        margin). ``rowed=True`` returns the ADC as ``[A, P, rows, N2]``,
        which needs ``samples_in + margin`` to be a multiple of
        :func:`~dpdk_dc_sand_tpu_torch.ops.fengine_fused.ingest_alignment`.
        """
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        adc = rng.integers(
            -64, 64, size=(cfg.n_ants, cfg.n_pols, self.samples_in + margin),
            dtype=np.int8,
        )
        if rowed:
            n2 = ingest_alignment(cfg.fft_size)
            if n2 is None or adc.shape[-1] % n2:
                raise ValueError(
                    "rowed example inputs need an N2-aligned stream "
                    "length (geometry must take the direct-CT kernel)"
                )
            adc = adc.reshape(cfg.n_ants, cfg.n_pols, -1, n2)
        if delay_budget is None:
            delay_budget = margin
        cd = rng.integers(0, delay_budget, size=cfg.n_ants).astype(np.int32)
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return adc, cd, fd, ph, dv


def _coeff_blocks(
    delay_vals: torch.Tensor,
    ant_weights: torch.Tensor,
    t_s: float = 0.0,
    *,
    cfg: ArrayConfig,
    dtype=torch.float32,
    folded: bool = True,
) -> torch.Tensor:
    """``[B, A, 4]`` delay polynomials -> steering weights in ``dtype``.

    ``folded=True``: ``[C, 2A, 2B]`` block-concat weights. ``folded=False``:
    the planar form's ``(cos, sin)`` ``[C, B, A]`` planes, stacked
    ``[2, C, B, A]`` (unpacking it gives the pair).
    """
    cos, sin = steering_coeffs(
        delay_vals,
        n_channels=cfg.n_channels,
        n_channels_per_stream=cfg.n_channels,
        sample_period=cfg.sample_period,
        xeng_id=0,
        t_s=t_s,
    )
    cos, sin = cos * ant_weights, sin * ant_weights
    if folded:
        return steering_coeff_blockcat(cos, sin).to(dtype)
    return torch.stack([cos, sin]).to(dtype)


def _f_stage(
    adc: torch.Tensor,
    coarse_delays: torch.Tensor,
    window: torch.Tensor,
    rot_planes: tuple[torch.Tensor, torch.Tensor] | None,
    *,
    cfg: ArrayConfig,
    n_spectra: int,
    quant_scale: float,
    fengine: str = "fused",
    fine_delays: tuple[torch.Tensor, torch.Tensor] | None = None,
    planes_native: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse delay + PFB + fine delay + requantise: int8 ``(qr, qi)`` ``[A, P, S, C]``.

    The ADC may be flat ``[A, P, n]`` or wire-rowed ``[A, P, rows, N2]``;
    both are views of the same bytes. ``fengine="xla"`` runs the composed
    chain on ``fine_delays`` = ``(frac_delays, phases)`` ``[A]``; the fused
    forms take the cached ``rot_planes``. ``planes_native=True`` (fused
    direct-CT form) returns K1's planes viewed as its native
    ``[A, P, S, N2/2, N1]`` layout (channel ``k = row·N1 + lane``): a view,
    so a plane that is not contiguous raises instead of being copied.
    """
    flat = adc.reshape(cfg.n_ants, cfg.n_pols, -1)
    if fengine == "xla":
        shape = (cfg.n_ants, cfg.n_pols, n_spectra, cfg.n_channels)
        qr, qi = (torch.empty(shape, dtype=torch.int8, device=adc.device) for _ in range(2))
        composed_f(flat, coarse_delays, *fine_delays, window, qr, qi, quant_scale=quant_scale)
        return qr, qi
    qr, qi = fengine_fused(
        flat,
        window,
        None,
        None,
        n_channels=cfg.n_channels,
        quant_scale=quant_scale,
        dft_dtype="float32" if fengine == "fused_f32" else "bfloat16",
        coarse_delays=coarse_delays.reshape(cfg.n_ants, 1).expand(
            cfg.n_ants, cfg.n_pols
        ),
        n_spectra=n_spectra,
        rot_planes=rot_planes,
    )
    if planes_native:
        _, n1, n2 = _deint_mode(cfg.n_channels)
        shape5 = (cfg.n_ants, cfg.n_pols, n_spectra, n2 // 2, n1)
        return qr.view(shape5), qi.view(shape5)
    return qr, qi


def _b_stage(
    qr: torch.Tensor,
    qi: torch.Tensor,
    coeff_blocks: torch.Tensor,
    *,
    cfg: ArrayConfig,
    precision: str,
    bstage: str = "fused",
    beam_quant_scale: float | None = None,
    beam_layout: str = "split",
) -> torch.Tensor:
    """Corner turn + multi-beam matmul (+ beam requant).

    ``coeff_blocks`` is ``[C, 2A, 2B]``, or for ``bstage="planar"`` the
    stacked ``(cos, sin)`` ``[2, C, B, A]``. 5-d native planes
    ``[A, P, S, rows, lanes]`` (``bstage="turned"``) take one native turn
    per plane (K8) and the split product.

    ``beam_layout="natural"`` (``"fused"`` or ``"turned"``): ``"fused"``
    gives K2's packed ``[C/pack, P·S, pack·2B]``, ``"turned"`` the
    product's ``[C, P·S, 2B]``; ``"split"``: ``[P, C, S, B, 2]``.
    """
    if beam_layout == "natural" and bstage not in ("turned", "fused"):
        raise ValueError('beam_layout="natural" requires bstage "turned" or "fused"')
    if bstage == "turned" and qr.ndim == 5:
        out = beamform_turned_split(
            corner_turn_plane_native(qr), corner_turn_plane_native(qi), coeff_blocks,
            n_pols=cfg.n_pols, precision=precision, layout=beam_layout,
        )
    elif bstage == "turned":
        out = beamform_turned(
            corner_turn_planes(qr, qi), coeff_blocks, n_pols=cfg.n_pols,
            precision=precision, layout=beam_layout,
        )
    elif bstage == "fused":
        out = beamform_turned_fused(
            qr, qi, coeff_blocks, n_pols=cfg.n_pols, precision=precision,
            layout="packed" if beam_layout == "natural" else "split",
        )
    elif bstage == "folded":
        out = beamform_planes_folded(qr, qi, coeff_blocks, precision)
    elif bstage == "planar":
        cos, sin = coeff_blocks
        # [A, P, S, C] -> [P, C, S, A] per plane (views; the product turns them).
        out = beamform_planes(qr.permute(1, 3, 2, 0), qi.permute(1, 3, 2, 0), cos, sin,
                              precision)
    else:
        raise ValueError(f"unknown bstage backend {bstage!r}")
    if beam_layout == "natural":
        return out if beam_quant_scale is None else requantise(out, beam_quant_scale)
    beam_re, beam_im = out
    if beam_quant_scale is not None:
        beam_re = requantise(beam_re, beam_quant_scale)
        beam_im = requantise(beam_im, beam_quant_scale)
    return torch.stack([beam_re, beam_im], dim=-1)
