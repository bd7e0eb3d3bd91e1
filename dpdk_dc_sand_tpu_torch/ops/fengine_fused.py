"""Fused F-engine: FIR + two-stage Cooley–Tukey rDFT + fine delay + int8 requant.

Counterpart of ``dpdk_dc_sand_tpu/ops/fengine_pallas.py`` (the direct-CT
form, ``_fengine_kernel_ct``). For a CUDA tensor :func:`fengine_fused`
launches the hand-written kernel ``csrc/fengine_ct.cu`` (K1); for a CPU
tensor it runs :func:`fengine_fused_reference`, the plain PyTorch version
with the same rounding points:

1. int8 -> f32 (exact), FIR in f32 in tap order
   (``acc = x0*w0; acc = acc + xt*wt``);
2. the FIR output viewed row-major as ``[N1, N2]`` (fft = N1·N2) and
   rounded to the DFT operand type (bf16, or f32 for ``dft_dtype="float32"``);
3. stage A ``[N1,N1] @ [N1,N2]`` (cos and -sin; real input) with f32
   accumulation, then the f32 twiddle ``exp(-2*pi*i*k1*n2/fft)``, rounded to
   the operand type;
4. half-output stage B against the row-stacked ``[cos; -sin]`` ``[N2, N2]``
   matrix, f32 accumulation, keeping ``k2 < N2/2``: bin ``k = k2·N1 + k1``;
5. the fine-delay rotation (requant gain folded into the planes),
   ``rint``, clip to ±127, int8 — or, with ``quantise=False`` (the
   channelisation qualification's output), the rotated f32 values.

Products of bf16 values are exact in f32, so the bf16 mode differs from the
reference only by the order of f32 additions.

With bf16 operands and N1 >= 16 (every engine launch) K1 runs as two passes
over groups of batches: :func:`k1_fir` (steps 1-2 into a bf16 plane
``[B, S, N1, N2]``, scratch of at most :data:`K1_SCRATCH_BYTES`) and
:func:`k1_dft` (steps 3-5); their plain versions :func:`k1_fir_reference`
and :func:`k1_dft_reference` compose to :func:`fengine_fused_reference`.
f32 operands and N1 = 8 take the kernel's single-pass SIMT body.

Where the direct-CT split does not exist, or the caller names
``deint="matmul"`` or ``"bitcast"``, :func:`fengine_fused` takes the
decimation-in-time form instead (the reference's ``_fengine_kernel``):
:func:`fengine_dit` launches ``csrc/fengine_dit.cu`` (K7) for a CUDA
tensor and runs :func:`fengine_dit_reference` for a CPU tensor. The
reference's two names move samples differently on the TPU but compute the
same values; here they differ only in the N1·N2 split :func:`_deint_mode`
gives them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

#: N1 (the row count of the frame view) must be a multiple of this.
_ROW_ALIGN = 8
#: Most bytes of bf16 FIR plane K1's two passes keep between them: batches
#: go through in groups whose planes fit (32 flagship streams: 1.07 GB).
K1_SCRATCH_BYTES = 1 << 30
#: What a launch function returns where no shared-memory plan fits the shape.
_NO_PLAN = -1


def _split_ct(fft_size: int) -> tuple[int, int] | None:
    """fft_size = N1 * N2 for the direct-CT form, or None if unviable.

    The same split as the reference (``fengine_pallas._split_ct``) so the
    wire-rowed ``[rows, N2]`` ingest layout is shared between the packages.
    """
    l = fft_size.bit_length() - 1
    n1 = 1 << ((l + 1) // 2)
    n2 = fft_size // n1
    if n2 < 128 and fft_size >= 8 * 128:
        n2 = 128
        n1 = fft_size // n2
    if n1 % _ROW_ALIGN or n2 < 128 or n2 % 2:
        return None
    return n1, n2


def _split_pow2(n: int) -> tuple[int, int]:
    """n = n1 * n2, powers of two, near-balanced with n2 >= 64
    (``fengine_pallas._split_pow2``)."""
    l = n.bit_length() - 1
    n1 = 1 << ((l + 1) // 2)
    n2 = n // n1
    if n2 < 64:
        n2 = min(64, n // 8)
        n1 = n // n2
    return n1, n2


def _deint_mode(n: int, deint: str = "auto") -> tuple[str, int, int]:
    """The kernel form and its N1·N2 split, as ``fengine_pallas._deint_mode``
    picks them (``n`` = fft_size / 2).

    ``"ct"``: the direct-CT form over the whole frame (K1), the default
    where its split exists. ``"matmul"`` and ``"bitcast"``: the DIT form
    (K7) over the half-length streams, with the reference's splits for
    each name (fft 2048: 16·64 and 8·128; fft 65536: 256·128 for both).
    """
    if deint not in ("auto", "ct", "matmul", "bitcast"):
        raise ValueError(f"unknown deint {deint!r}")
    if deint in ("auto", "ct"):
        ct = _split_ct(2 * n)
        if ct is not None:
            return ("ct", *ct)
        if deint == "ct":
            raise ValueError(f"fft_size {2 * n} unsupported by the ct kernel")
    if deint == "bitcast":
        n1b, n2b = _split_pow2(n)
        if n2b < 128 and n >= 8 * 128:
            n1b, n2b = n // 128, 128
        if n2b >= 128 and n1b % _ROW_ALIGN == 0:
            return "bitcast", n1b, n2b
    return ("matmul", *_split_pow2(n))


def ingest_alignment(fft_size: int) -> int | None:
    """Sample alignment (N2) a wire-rowed ADC stream must have, or None."""
    ct = _split_ct(fft_size)
    return ct[1] if ct is not None else None


class DftConstants(NamedTuple):
    d1c: torch.Tensor  # [N1, N1] cos(2*pi*k1*n1/N1)
    d1s: torch.Tensor  # [N1, N1] -sin
    d2: torch.Tensor  # [N2, N2] rows: cos then -sin of 2*pi*k2*n2/N2, k2 < N2/2
    twc: torch.Tensor  # [N1, N2] cos(2*pi*k1*n2/fft)
    tws: torch.Tensor  # [N1, N2] -sin


@functools.lru_cache(maxsize=16)
def dft_constants(n1: int, n2: int, device: str) -> DftConstants:
    """DFT and twiddle constants, built as the reference builds them.

    float64 numpy, then f32 (``fengine_pallas.py:1552-1572``); the bf16 DFT
    operands are rounded from these f32 values by the kernel / plain version.
    """
    fft = n1 * n2
    k1 = np.arange(n1)
    k2h = np.arange(n2 // 2)
    nn2 = np.arange(n2)
    a1 = 2 * np.pi * np.outer(k1, k1) / n1
    a2 = 2 * np.pi * np.outer(k2h, nn2) / n2
    atw = 2 * np.pi * np.outer(k1, nn2) / fft
    d2stack = np.concatenate([np.cos(a2), -np.sin(a2)], axis=0)
    consts = (np.cos(a1), -np.sin(a1), d2stack, np.cos(atw), -np.sin(atw))
    return DftConstants(
        *(torch.as_tensor(c.astype(np.float32), device=device) for c in consts)
    )


@functools.lru_cache(maxsize=16)
def _dft_bf16(n1: int, n2: int, device: str) -> tuple[torch.Tensor, ...]:
    """bf16 (round-to-nearest-even) copies of d1c, d1s, d2: the operands of
    K1's DFT pass."""
    k = dft_constants(n1, n2, device)
    return tuple(t.to(torch.bfloat16).contiguous() for t in (k.d1c, k.d1s, k.d2))


def fine_rotation_planes(
    frac_delay,
    phase,
    *,
    n_channels: int,
    quant_scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine-delay rotation planes ``(cos, sin) * quant_scale``.

    Shape ``[*lead, N2/2, N1]`` (channel ``k = row·N1 + lane``), f32, on the
    device of ``frac_delay``; ``rot(k) = -pi*fd*(k - C/2)/C + phase``.
    Computed on the delay-update path and cached by the engine.
    """
    ct = _split_ct(2 * n_channels)
    if ct is None or n_channels & (n_channels - 1):
        raise ValueError(
            f"fft_size {2 * n_channels}: fine_rotation_planes covers the "
            "direct-CT kernel form only"
        )
    n1, n2 = ct
    return _rotation_planes(frac_delay, phase, n_channels, quant_scale, (n2 // 2, n1))


def _rotation_planes(frac_delay, phase, n_channels, quant_scale, plane):
    """``(cos, sin)·quant_scale`` of the fine-delay ramp, ``[*lead, *plane]``
    (channel ``k`` row-major over ``plane``; ``fengine_pallas._rotation_planes``)."""
    fd = torch.as_tensor(frac_delay, dtype=torch.float32)
    ph = torch.as_tensor(phase, dtype=torch.float32, device=fd.device)
    lead = tuple(fd.shape)
    fd = fd.reshape(*lead, 1, 1)
    ph = ph.expand(lead).reshape(*lead, 1, 1)
    k = torch.arange(n_channels, dtype=torch.float32, device=fd.device).reshape(plane)
    rot = -math.pi * fd * (k - n_channels / 2.0) / n_channels + ph
    return torch.cos(rot) * quant_scale, torch.sin(rot) * quant_scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    # A bf16 matmul would round its OUTPUT to bf16 as well; round the
    # operand only, then compute in f32.
    return x.to(torch.bfloat16).to(torch.float32)


def k1_fir_reference(
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    *,
    n_spectra: int,
    dft_dtype: str = "bfloat16",
) -> torch.Tensor:
    """Plain version of K1's FIR pass: the FIR plane ``[B, n_spectra, fft]``.

    ``x`` ``[B, n_in]`` int8 streams, ``starts`` ``[B]`` window starts
    (already clamped), ``window`` ``[taps, fft]`` f32. The f32 tap-order sum,
    rounded to bf16 (a bf16 tensor) for ``dft_dtype="bfloat16"``; f32
    otherwise.
    """
    n_taps, fft = window.shape
    batch = x.shape[0]
    length = (n_spectra + n_taps - 1) * fft
    xs = torch.stack([x[b, s : s + length] for b, s in enumerate(starts.tolist())])
    frames = xs.reshape(batch, -1, fft).to(torch.float32)
    w = window.to(torch.float32)
    acc = frames[:, 0:n_spectra] * w[0]
    for tap in range(1, n_taps):
        acc = acc + frames[:, tap : tap + n_spectra] * w[tap]
    return acc.to(torch.bfloat16) if dft_dtype == "bfloat16" else acc


def _ct_stage_a(plane, k, n1, n2, rnd):
    """K1's stage A and twiddle: ``(tr, ti)`` ``[B, S, N1, N2]`` in f32,
    before the operand rounding."""
    batch, n_spectra, _ = plane.shape
    xm = plane.to(torch.float32).reshape(batch, n_spectra, n1, n2)
    ar = torch.matmul(rnd(k.d1c), xm)
    ai = torch.matmul(rnd(k.d1s), xm)
    return ar * k.twc - ai * k.tws, ar * k.tws + ai * k.twc


def _ct_stage_b(tr, ti, k, n2, rnd):
    """K1's half-output stage B of the rounded T planes: ``(re, im)``
    ``[B, S, C]``, bin ``k2·N1 + k1``."""
    batch, n_spectra, n1, _ = tr.shape
    d2 = rnd(k.d2)
    yr = torch.matmul(d2, tr.transpose(-1, -2))  # [B, S, N2, N1]
    yi = torch.matmul(d2, ti.transpose(-1, -2))
    h = n2 // 2
    c = h * n1
    re = (yr[..., :h, :] - yi[..., h:, :]).reshape(batch, n_spectra, c)
    im = (yi[..., :h, :] + yr[..., h:, :]).reshape(batch, n_spectra, c)
    return re, im


def k1_dft_reference(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1's DFT pass: the FIR plane ``[B, S, fft]`` (as
    :func:`k1_fir_reference` gives it) and ``rotc``/``rots`` ``[B, C]`` to
    int8 ``(qr, qi)`` ``[B, S, C]``, or the rotated f32 values with
    ``quantise=False``."""
    batch, n_spectra, fft = plane.shape
    c = fft // 2
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    k = dft_constants(n1, n2, str(plane.device))
    tr, ti = _ct_stage_a(plane, k, n1, n2, rnd)
    re, im = _ct_stage_b(rnd(tr), rnd(ti), k, n2, rnd)
    rc = rotc.reshape(batch, 1, c)
    rs = rots.reshape(batch, 1, c)
    outr = re * rc - im * rs
    outi = re * rs + im * rc
    if not quantise:
        return outr, outi

    def q(v):
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)

    return q(outr), q(outi)


def fengine_fused_reference(
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n_spectra: int,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, at K1's rounding points: the FIR pass's
    plain version, then the DFT pass's.

    ``x`` ``[B, n_in]`` int8 streams, ``starts`` ``[B]`` window starts
    (already clamped), ``window`` ``[taps, fft]`` f32, ``rotc``/``rots``
    ``[B, C]``. Returns int8 ``(qr, qi)`` ``[B, n_spectra, C]``, or with
    ``quantise=False`` the rotated f32 values before the requant.
    """
    plane = k1_fir_reference(x, starts, window, n_spectra=n_spectra, dft_dtype=dft_dtype)
    return k1_dft_reference(plane, rotc, rots, n1=n1, n2=n2, dft_dtype=dft_dtype,
                            quantise=quantise)


#: K1's stage stops (``fengine_fused(_ablate=...)``) as the kernel numbers them.
ABLATE_STOPS = {"dma": 1, "fir": 2, "stagea": 3, "stageb": 4}
#: Spectra one probe of a ``"dma"`` stop serves (the probes' ``s_blk``).
ABLATE_S_BLK = 16


def _trunc_s8(v: torch.Tensor) -> torch.Tensor:
    """int8 by truncation toward zero, saturated: XLA's f32 -> int8
    conversion in the probes, ``cvt.rzi.sat.s8.f32`` on the card."""
    return v.trunc().clamp(-128, 127).to(torch.int8)


def fengine_ablate_reference(
    stop: str | None,
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n_spectra: int,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 cut after a stage (the probe P5,
    ``benchmarks/ct_ablate.py:69-108``); arguments as
    :func:`fengine_fused_reference`, which ``stop=None`` is.

    Each stop writes int8 ``(outr, outi)`` ``[B, S, C]``, truncated
    (:func:`_trunc_s8`): ``"dma"`` the first C input samples of frame
    ``s - s % 16`` to both; ``"fir"`` the f32 FIR's first and second C
    samples; ``"stagea"`` T re and im (f32, before rounding) of rows
    ``k1 < N1/2`` at ``k1·N2 + n2``; ``"stageb"`` re and im before the
    rotation. With N1 == N2 these are P5's slices.
    """
    if stop is None:
        return fengine_fused_reference(x, starts, window, rotc, rots, n_spectra=n_spectra,
                                       n1=n1, n2=n2, dft_dtype=dft_dtype, quantise=quantise)
    if stop not in ABLATE_STOPS:
        raise ValueError(f"unknown _ablate stage {stop!r}")
    fft = window.shape[1]
    c = fft // 2
    if stop == "dma":
        f0 = torch.arange(n_spectra, device=x.device) // ABLATE_S_BLK * ABLATE_S_BLK
        probe = torch.stack([x[b, s : s + n_spectra * fft].reshape(n_spectra, fft)[f0, :c]
                             for b, s in enumerate(starts.tolist())])
        return probe, probe.clone()
    plane = k1_fir_reference(x, starts, window, n_spectra=n_spectra, dft_dtype="float32")
    if stop == "fir":
        return _trunc_s8(plane[..., :c]), _trunc_s8(plane[..., c:])
    rnd = _round_bf16
    k = dft_constants(n1, n2, str(x.device))
    tr, ti = _ct_stage_a(plane.to(torch.bfloat16), k, n1, n2, rnd)
    if stop == "stagea":
        return tuple(_trunc_s8(t[..., : n1 // 2, :].reshape(-1, n_spectra, c)) for t in (tr, ti))
    re, im = _ct_stage_b(rnd(tr), rnd(ti), k, n2, rnd)
    return _trunc_s8(re), _trunc_s8(im)


def _plane_group(batch: int, n_spectra: int, fft: int) -> int:
    """Batches a group of K1's two passes takes: as many bf16 planes as fit
    :data:`K1_SCRATCH_BYTES` (at least one)."""
    return max(1, min(batch, K1_SCRATCH_BYTES // (2 * n_spectra * fft)))


def _check(what: str, x: torch.Tensor, want) -> None:
    for name, t, dtype, shape in want:
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")


def _no_plan(what: str, n1: int, n2: int, detail: str) -> ValueError:
    return ValueError(
        f"{what}: no shared-memory plan for N1 x N2 = {n1} x {n2} within the "
        f"232,448 bytes a block may use ({detail}; see ROADMAP.md)"
    )


def _fir_pass(x, starts, window, plane) -> None:
    """K1's FIR pass into ``plane`` ``[B, S, fft]`` bf16 (CUDA tensors,
    checked by the caller)."""
    batch, n_spectra, fft = plane.shape
    lib = _build.library()
    err = lib.k1_fir_launch(
        x.data_ptr(), x.stride(0), starts.data_ptr(), window.data_ptr(), plane.data_ptr(),
        batch, n_spectra, window.shape[0], fft, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "k1_fir")
    k1_fir.launches += 1


def _dft_pass(plane, rotc, rots, outr, outi, *, n1, n2, quantise) -> None:
    """K1's DFT pass from ``plane`` into ``outr``/``outi`` (CUDA tensors,
    checked by the caller)."""
    batch, n_spectra, _ = plane.shape
    dev = plane.device
    k = dft_constants(n1, n2, str(dev))
    kbf = _dft_bf16(n1, n2, str(dev))
    lib = _build.library()
    err = lib.k1_dft_launch(
        plane.data_ptr(), *(t.data_ptr() for t in kbf), k.twc.data_ptr(), k.tws.data_ptr(),
        rotc.data_ptr(), rots.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n1, n2, int(quantise), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("k1_dft", n1, n2, "the T planes of a 16-row chunk and the tile ring")
    _build.check(lib, err, "k1_dft")
    k1_dft.launches += 1


def k1_fir(
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    *,
    n_spectra: int,
) -> torch.Tensor:
    """K1's FIR pass alone: the bf16 FIR plane ``[B, n_spectra, fft]`` (the
    kernel on CUDA, :func:`k1_fir_reference` on CPU). Arguments as the
    reference's; ``starts`` must be clamped so every read stays in ``x``."""
    if x.device.type == "cpu":
        return k1_fir_reference(x, starts, window, n_spectra=n_spectra)
    if x.device.type != "cuda":
        raise ValueError(f"k1_fir: unsupported device {x.device}")
    n_taps, fft = window.shape
    batch = x.shape[0]
    _check("k1_fir", x, (
        ("starts", starts, torch.int64, (batch,)),
        ("window", window, torch.float32, (n_taps, fft)),
    ))
    if x.dtype != torch.int8 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError("k1_fir: x must be [B, n_in] int8 with unit sample stride")
    if window.data_ptr() % 16:
        window = window.clone()  # the kernel reads the window as float4
    plane = torch.empty((batch, n_spectra, fft), dtype=torch.bfloat16, device=x.device)
    _fir_pass(x, starts, window, plane)
    return plane


def k1_dft(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's DFT pass alone, bf16 operands: ``plane`` ``[B, S, fft]`` bf16 to
    ``(qr, qi)`` ``[B, S, C]`` (the kernel on CUDA, :func:`k1_dft_reference`
    on CPU)."""
    if plane.device.type == "cpu":
        return k1_dft_reference(plane, rotc, rots, n1=n1, n2=n2, quantise=quantise)
    if plane.device.type != "cuda":
        raise ValueError(f"k1_dft: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != n1 * n2 or n1 < 16:
        raise ValueError(f"k1_dft: the pass takes N1 >= 16 and fft = N1*N2, got {n1}, {n2}, {fft}")
    _check("k1_dft", plane, (
        ("plane", plane, torch.bfloat16, None),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    ))
    out_dtype = torch.int8 if quantise else torch.float32
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=out_dtype, device=plane.device)
    outi = torch.empty_like(outr)
    _dft_pass(plane, rotc, rots, outr, outi, n1=n1, n2=n2, quantise=quantise)
    return outr, outi


#: Launches of K1's two passes since the last reset (the plain versions never
#: count); every two-pass K1 call adds one to each per group of batches.
k1_fir.launches = 0
k1_dft.launches = 0


def _stop_pass(x, starts, window, plane, outr, outi, *, n1, n2, stop) -> None:
    """One group of K1's passes cut at ``stop`` (CUDA tensors, checked by the
    caller): ``"dma"`` and ``"fir"`` are the FIR pass's stops (``"fir"``
    writes ``plane`` too); ``"stagea"`` and ``"stageb"`` run the FIR pass,
    then the DFT pass's stop."""
    lib = _build.library()
    batch, n_spectra, c = outr.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if stop in ("dma", "fir"):
        err = lib.k1_fir_stop_launch(
            x.data_ptr(), x.stride(0), starts.data_ptr(), window.data_ptr(),
            plane.data_ptr() if plane is not None else None, outr.data_ptr(), outi.data_ptr(),
            batch, n_spectra, window.shape[0], 2 * c, ABLATE_STOPS[stop], stream,
        )
        _build.check(lib, err, f"k1_fir stop {stop}")
    else:
        _fir_pass(x, starts, window, plane)
        k = dft_constants(n1, n2, str(x.device))
        kbf = _dft_bf16(n1, n2, str(x.device))
        err = lib.k1_dft_stop_launch(
            plane.data_ptr(), *(t.data_ptr() for t in kbf), k.twc.data_ptr(),
            k.tws.data_ptr(), outr.data_ptr(), outi.data_ptr(), batch, n_spectra, n1, n2,
            ABLATE_STOPS[stop], stream,
        )
        if err == _NO_PLAN:
            raise _no_plan("k1_dft stop", n1, n2, "the stops take the 64-row chunk plan only")
        _build.check(lib, err, f"k1_dft stop {stop}")
    fengine_fused.ablate_launches += 1


def _launch(
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n_spectra: int,
    n1: int,
    n2: int,
    dft_dtype: str,
    quantise: bool,
    ablate: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    n_taps, fft = window.shape
    batch = x.shape[0]
    _check("fengine_fused", x, (
        ("x", x, torch.int8, None),
        ("starts", starts, torch.int64, (batch,)),
        ("window", window, torch.float32, (n_taps, fft)),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    ))
    if window.data_ptr() % 16:
        window = window.clone()  # the kernel reads the window as float4
    dev = x.device
    out_dtype = torch.int8 if quantise else torch.float32
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=out_dtype, device=dev)
    outi = torch.empty_like(outr)
    if ablate is not None:
        # K1's two passes cut at a stage, over the same groups (the DMA stop
        # writes no plane).
        group = _plane_group(batch, n_spectra, fft)
        plane = None
        if ablate != "dma":
            plane = torch.empty((group, n_spectra, fft), dtype=torch.bfloat16, device=dev)
        for b0 in range(0, batch, group):
            b = slice(b0, min(batch, b0 + group))
            p = plane[: b.stop - b0] if plane is not None else None
            _stop_pass(x[b], starts[b], window, p, outr[b], outi[b], n1=n1, n2=n2, stop=ablate)
        return outr, outi
    if dft_dtype == "bfloat16" and n1 >= 16:
        # Two passes over groups of batches through one bf16 plane of scratch.
        group = _plane_group(batch, n_spectra, fft)
        plane = torch.empty((group, n_spectra, fft), dtype=torch.bfloat16, device=dev)
        for b0 in range(0, batch, group):
            b = slice(b0, min(batch, b0 + group))
            p = plane[: b.stop - b0]
            _fir_pass(x[b], starts[b], window, p)
            _dft_pass(p, rotc[b], rots[b], outr[b], outi[b], n1=n1, n2=n2, quantise=quantise)
    else:
        k = dft_constants(n1, n2, str(dev))
        lib = _build.library()
        err = lib.fengine_ct_launch(
            x.data_ptr(), x.stride(0), starts.data_ptr(),
            window.data_ptr(), k.d1c.data_ptr(), k.d1s.data_ptr(), k.d2.data_ptr(),
            k.twc.data_ptr(), k.tws.data_ptr(),
            rotc.data_ptr(), rots.data_ptr(),
            outr.data_ptr(), outi.data_ptr(),
            batch, n_spectra, n_taps, n1, n2, int(dft_dtype == "bfloat16"), int(quantise),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err == _NO_PLAN:
            raise _no_plan("fengine_fused", n1, n2, "the f32 T planes of a 2-row chunk")
        _build.check(lib, err, "fengine_ct")
    fengine_fused.launches += 1
    return outr, outi


class DitConstants(NamedTuple):
    d1c: torch.Tensor  # [N1, N1] cos(2*pi*k1*n1/N1)
    d1s: torch.Tensor  # [N1, N1] -sin
    d2c: torch.Tensor  # [N2, N2] cos(2*pi*k2*n2/N2)
    d2s: torch.Tensor  # [N2, N2] -sin
    twc: torch.Tensor  # [N1, N2] cos(2*pi*k1*n2/N), N = N1*N2
    tws: torch.Tensor  # [N1, N2] -sin
    untc: torch.Tensor  # [N2, N1] cos(pi*k/N), k = k2*N1 + k1
    unts: torch.Tensor  # [N2, N1] -sin


@functools.lru_cache(maxsize=16)
def dit_constants(n1: int, n2: int, device: str) -> DitConstants:
    """The DIT form's DFT, twiddle and combine constants, float64 numpy then
    f32, as the reference builds them (``fengine_pallas.py:1759-1778``)."""
    n = n1 * n2
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    a1 = 2 * np.pi * np.outer(k1, k1) / n1
    a2 = 2 * np.pi * np.outer(k2, k2) / n2
    atw = 2 * np.pi * np.outer(k1, k2) / n
    aun = np.pi * (k2[:, None] * n1 + k1[None, :]).astype(np.float64) / n
    consts = (np.cos(a1), -np.sin(a1), np.cos(a2), -np.sin(a2),
              np.cos(atw), -np.sin(atw), np.cos(aun), -np.sin(aun))
    return DitConstants(
        *(torch.as_tensor(c.astype(np.float32), device=device) for c in consts)
    )


def _dit_fir(frames, window):
    """K7's FIR, f32 in tap order: ``[B, S, fft]``."""
    n_taps = window.shape[0]
    n_spectra = frames.shape[1] - n_taps + 1
    f = frames.to(torch.float32)
    w = window.to(torch.float32)
    acc = f[:, 0:n_spectra] * w[0]
    for tap in range(1, n_taps):
        acc = acc + f[:, tap : tap + n_spectra] * w[tap]
    return acc


def _dit_stage_a(x, k, rnd):
    """K7's stage A and twiddle of one stream ``[B, S, N1, N2]``: the rounded
    ``(tr, ti)``."""
    ar = torch.matmul(rnd(k.d1c), x)
    ai = torch.matmul(rnd(k.d1s), x)
    return rnd(ar * k.twc - ai * k.tws), rnd(ar * k.tws + ai * k.twc)


def _dit_stage_b(tr, ti, k, rnd):
    """K7's stage B: ``(re, im)`` ``[B, S, N2, N1]``."""
    d2c, d2s = rnd(k.d2c), rnd(k.d2s)
    tr, ti = tr.transpose(-1, -2), ti.transpose(-1, -2)
    re = torch.matmul(d2c, tr) - torch.matmul(d2s, ti)
    im = torch.matmul(d2c, ti) + torch.matmul(d2s, tr)
    return re, im


def fengine_dit_reference(
    frames: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7, at K7's rounding points.

    ``frames`` ``[B, n_frames, fft]`` int8 aligned frames, ``window``
    ``[taps, fft]`` f32, ``rotc``/``rots`` ``[B, N]`` (``N = fft/2``, gain
    folded in). Returns int8 ``(qr, qi)`` ``[B, S, N]``.
    """
    n_taps, fft = window.shape
    batch, n_frames, _ = frames.shape
    n_spectra = n_frames - n_taps + 1
    n = fft // 2
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    acc = rnd(_dit_fir(frames, window))
    k = dit_constants(n1, n2, str(frames.device))

    def dft(x):  # [B, S, N1, N2] -> (re, im) [B, S, N2, N1], bin k = k2*N1 + k1
        return _dit_stage_b(*_dit_stage_a(x, k, rnd), k, rnd)

    er, ei = dft(acc[..., 0::2].reshape(batch, n_spectra, n1, n2))
    orr, oi = dft(acc[..., 1::2].reshape(batch, n_spectra, n1, n2))
    xr = (er + k.untc * orr - k.unts * oi).reshape(batch, n_spectra, n)
    xi = (ei + k.untc * oi + k.unts * orr).reshape(batch, n_spectra, n)
    rc = rotc.reshape(batch, 1, n)
    rs = rots.reshape(batch, 1, n)

    def q(v):
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)

    return q(xr * rc - xi * rs), q(xr * rs + xi * rc)


def _launch_dit(x, window, rotc, rots, *, n1, n2, dft_dtype):
    batch, n_frames, fft = x.shape
    n_taps = window.shape[0]
    want = (
        ("frames", x, torch.int8, None),
        ("window", window, torch.float32, (n_taps, fft)),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    )
    _check("fengine_dit", x, want)
    if x.data_ptr() % 2:
        x = x.clone()  # the kernel reads sample pairs as char2
    if window.data_ptr() % 16:
        window = window.clone()  # and window pairs as float2
    dev = x.device
    k = dit_constants(n1, n2, str(dev))
    n_spectra = n_frames - n_taps + 1
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.empty_like(outr)
    lib = _build.library()
    err = lib.fengine_dit_launch(
        x.data_ptr(), window.data_ptr(), *(t.data_ptr() for t in k),
        rotc.data_ptr(), rots.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_frames, n_taps, n1, n2, int(dft_dtype == "bfloat16"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("fengine_dit", n1, n2, "the four f32 T planes of a 2-row chunk")
    _build.check(lib, err, "fengine_dit")
    fengine_dit.launches += 1
    return outr, outi


def fengine_dit(
    frames: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The DIT F form (K7 on CUDA, plain on CPU); arguments as
    :func:`fengine_dit_reference`."""
    dev = frames.device
    kw = dict(n1=n1, n2=n2, dft_dtype=dft_dtype)
    if dev.type == "cuda":
        return _launch_dit(frames.contiguous(), window.contiguous(), rotc.contiguous(),
                           rots.contiguous(), **kw)
    if dev.type == "cpu":
        return fengine_dit_reference(frames, window, rotc, rots, **kw)
    raise ValueError(f"fengine_dit: unsupported device {dev}")


#: K7 launches since the last reset (the plain CPU version never counts).
fengine_dit.launches = 0

#: K7's stage stops (the probe P2) as the kernel numbers them; the probe's
#: ``"full"`` is K7 itself.
DIT_STOPS = {"dma": 1, "conv": 2, "fir": 3, "deint": 4, "stagea": 5, "stageb": 6}


def fengine_dit_ablate_reference(
    stop: str,
    frames: torch.Tensor,
    window: torch.Tensor,
    *,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (bf16 operands) cut after a stage, the probe P2
    (``benchmarks/fused_ablate.py:67-147``); arguments as
    :func:`fengine_dit_reference`. int8 ``(outr, outi)`` ``[B, S, N]``,
    truncated (:func:`_trunc_s8`):

    - ``"dma"``: 0 and frame ``f0 = s - s % 16``'s first sample;
      ``"conv"``: 0 and that sample plus frame ``f0 + 1``'s;
    - ``"fir"``: the f32 FIR's first and last N samples;
    - ``"deint"``: the bf16 FIR's even and odd samples;
    - ``"stagea"``: the even and odd streams' rounded T re, ``k1·N2 + n2``;
    - ``"stageb"``: their stage-B re, ``k2·N1 + k1``.

    ``"deint"`` and ``"stagea"`` are each spectrum's own values, where the
    probe's sinks slice across the spectra of its scratch.
    """
    if stop not in DIT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    n_taps, fft = window.shape
    batch, n_frames, _ = frames.shape
    n_spectra = n_frames - n_taps + 1
    n = fft // 2
    if stop in ("dma", "conv"):
        f0 = torch.arange(n_spectra, device=frames.device) // ABLATE_S_BLK * ABLATE_S_BLK
        probe = frames[:, f0, 0].to(torch.float32)
        if stop == "conv":
            probe = probe + frames[:, f0 + 1, 0].to(torch.float32)
        outi = _trunc_s8(probe)[..., None].expand(batch, n_spectra, n).contiguous()
        return torch.zeros_like(outi), outi
    acc = _dit_fir(frames, window)
    if stop == "fir":
        return _trunc_s8(acc[..., :n]), _trunc_s8(acc[..., n:])
    acc = _round_bf16(acc)
    if stop == "deint":
        return _trunc_s8(acc[..., 0::2]), _trunc_s8(acc[..., 1::2])
    k = dit_constants(n1, n2, str(frames.device))
    even, odd = (_dit_stage_a(acc[..., q::2].reshape(batch, n_spectra, n1, n2), k, _round_bf16)
                 for q in (0, 1))
    if stop == "stagea":
        return _trunc_s8(even[0].reshape(batch, n_spectra, n)), _trunc_s8(
            odd[0].reshape(batch, n_spectra, n))
    er, _ = _dit_stage_b(*even, k, _round_bf16)
    orr, _ = _dit_stage_b(*odd, k, _round_bf16)
    return _trunc_s8(er.reshape(batch, n_spectra, n)), _trunc_s8(orr.reshape(batch, n_spectra, n))


def fengine_dit_ablate(
    frames: torch.Tensor,
    window: torch.Tensor,
    *,
    n1: int,
    n2: int,
    stop: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (bf16 operands) cut after a stage: the kernel's stop on CUDA,
    :func:`fengine_dit_ablate_reference` on CPU. ``frames`` ``[B, n_frames,
    fft]`` int8, ``window`` ``[taps, fft]`` f32."""
    if stop not in DIT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    dev = frames.device
    if dev.type == "cpu":
        return fengine_dit_ablate_reference(stop, frames, window, n1=n1, n2=n2)
    if dev.type != "cuda":
        raise ValueError(f"fengine_dit_ablate: unsupported device {dev}")
    batch, n_frames, fft = frames.shape
    n_taps = window.shape[0]
    if fft != 2 * n1 * n2:
        raise ValueError(f"fengine_dit_ablate: fft {fft} != 2 * {n1} * {n2}")
    if stop == "conv" and n_taps < 2:
        raise ValueError("fengine_dit_ablate: the conv stop reads two frames (taps >= 2)")
    _check("fengine_dit_ablate", frames, (
        ("frames", frames, torch.int8, None),
        ("window", window, torch.float32, (n_taps, fft)),
    ))
    if frames.data_ptr() % 2:
        frames = frames.clone()  # sample pairs are read as char2
    if window.data_ptr() % 16:
        window = window.clone()
    k = dit_constants(n1, n2, str(dev))
    outr = torch.empty((batch, n_frames - n_taps + 1, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.empty_like(outr)
    lib = _build.library()
    err = lib.fengine_dit_stop_launch(
        frames.data_ptr(), window.data_ptr(), *(t.data_ptr() for t in k[:6]),
        outr.data_ptr(), outi.data_ptr(), batch, n_frames, n_taps, n1, n2, DIT_STOPS[stop],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("fengine_dit_ablate", n1, n2, "the four f32 T planes of a 2-row chunk")
    _build.check(lib, err, f"fengine_dit stop {stop}")
    fengine_dit_ablate.launches += 1
    return outr, outi


#: Launches of K7's stopped kernel since the last reset.
fengine_dit_ablate.launches = 0


def fengine_fused(
    frames: torch.Tensor,
    window: torch.Tensor,
    frac_delay,
    phase,
    *,
    n_channels: int,
    quant_scale: float,
    dft_dtype: str = "bfloat16",
    coarse_delays=None,
    n_spectra: int | None = None,
    rowed: bool = False,
    rot_planes: tuple[torch.Tensor, torch.Tensor] | None = None,
    deint: str = "auto",
    quantise: bool = True,
    _ablate: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FIR + rDFT + fine delay + int8 requant: K1 (direct CT) or K7 (DIT) on
    CUDA, their plain versions on CPU.

    ``frames`` is one of (leading dims ``lead``, e.g. ``[A, P]``):

    - ``[*lead, n_frames, fft_size]`` aligned frames (no coarse delays);
    - ``[*lead, n_in]`` raw streams with ``coarse_delays`` (``lead``-shaped)
      and ``n_spectra``;
    - ``rowed=True``: the wire-rowed ``[*lead, rows, N2]`` view of either.

    The coarse delay is a per-batch window start, clamped as
    ``jax.lax.dynamic_slice`` clamps it. ``rot_planes`` are cached
    :func:`fine_rotation_planes` (else computed from ``frac_delay`` /
    ``phase``). ``deint`` picks the form as the reference does
    (:func:`_deint_mode`); the DIT form takes aligned frames only, and its
    rotation planes from ``frac_delay`` / ``phase``. Returns int8
    ``(qr, qi)`` ``[*lead, n_spectra, n_channels]``; ``quantise=False``
    (direct-CT form only, as in the reference) returns the rotated f32
    values instead, the output the channelisation qualification measures.

    ``_ablate`` (the probes' diagnostic stops, ``"dma"``, ``"fir"``,
    ``"stagea"`` or ``"stageb"``) cuts K1 after that stage and returns what
    :func:`fengine_ablate_reference` describes; a ``"dma"`` probe serves
    :data:`ABLATE_S_BLK` spectra. The stops exist on K1's two-pass bf16
    body (N1 >= 16); all but ``"dma"`` need N1 == N2, as the reference's,
    and the DFT pass's stops its 64-row chunk plan (N1 = N2 <= 256).
    """
    if dft_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown dft_dtype {dft_dtype!r}")
    n_taps, fft_size = window.shape
    if n_channels != fft_size // 2:
        raise ValueError(f"n_channels {n_channels} != fft_size/2 {fft_size // 2}")
    if fft_size < 8 or fft_size & (fft_size - 1):
        raise ValueError(f"fft_size {fft_size} is not a power of two >= 8")
    if _ablate is not None and _ablate not in ABLATE_STOPS:
        raise ValueError(f"unknown _ablate stage {_ablate!r}")
    mode, n1, n2 = _deint_mode(fft_size // 2, deint)
    if mode == "ct" and _ablate is not None:
        if dft_dtype != "bfloat16" or n1 < 16 or not quantise:
            raise ValueError(
                "_ablate stage stops exist on K1's two-pass bf16 body only "
                f"(dft_dtype='bfloat16', N1 >= 16, quantise=True; got {dft_dtype!r}, "
                f"N1 = {n1}, quantise={quantise})"
            )
        if _ablate != "dma" and n1 != n2:
            raise ValueError(
                f"_ablate stage stops other than 'dma' need n1 == n2 (got {n1} x {n2})"
            )
    if mode != "ct":
        # The reference's gates for the DIT form (fengine_pallas.py:1265-1376).
        for flag, what in ((rowed, "rowed input"), (coarse_delays is not None,
                           "in-kernel coarse delay"), (rot_planes is not None,
                           "rot_planes (cached fine-rotation planes)"),
                           (not quantise, "quantise=False"),
                           (_ablate is not None, "_ablate stage stops")):
            if flag:
                raise ValueError(f"{what} needs the direct-CT form (deint={mode!r})")
        *lead, n_frames, f = frames.shape
        if f != fft_size:
            raise ValueError(f"frame length {f} != fft_size {fft_size}")
        if n_frames < n_taps:
            raise ValueError("need at least n_taps frames of input")
        dev = frames.device
        rotc, rots = _rotation_planes(
            torch.as_tensor(frac_delay, dtype=torch.float32, device=dev).expand(lead),
            phase, n_channels, quant_scale, (n_channels,),
        )
        batch = math.prod(lead)
        qr, qi = fengine_dit(
            frames.reshape(batch, n_frames, fft_size),
            window.to(device=dev, dtype=torch.float32),
            rotc.reshape(batch, n_channels), rots.reshape(batch, n_channels),
            n1=n1, n2=n2, dft_dtype=dft_dtype,
        )
        shape = (*lead, n_frames - n_taps + 1, n_channels)
        return qr.reshape(shape), qi.reshape(shape)
    if rowed:
        *lead, rows_in, n2f = frames.shape
        if n2f != n2:
            raise ValueError(f"rowed input minor dim must be N2={n2}, got {n2f}")
        n_in = rows_in * n2
        if coarse_delays is None:
            if rows_in % n1:
                raise ValueError("rowed input rows must be a multiple of N1")
            n_spectra = rows_in // n1 - n_taps + 1
    elif coarse_delays is None:
        *lead, n_frames, f = frames.shape
        if f != fft_size:
            raise ValueError(f"frame length {f} != fft_size {fft_size}")
        n_in = n_frames * fft_size
        n_spectra = n_frames - n_taps + 1
    else:
        *lead, n_in = frames.shape
    if n_spectra is None:
        raise ValueError("coarse_delays requires n_spectra")
    if n_spectra < 1:
        raise ValueError("need at least n_taps frames of input")
    batch = math.prod(lead)
    dev = frames.device
    x = frames.reshape(batch, n_in)
    out_len = (n_spectra + n_taps - 1) * fft_size
    if coarse_delays is None:
        starts = torch.zeros(batch, dtype=torch.int64, device=dev)
    else:
        cd = torch.as_tensor(coarse_delays, device=dev).expand(lead).reshape(batch)
        starts = clamp_starts(cd, n_in, out_len).contiguous()
    if rot_planes is None:
        rot_planes = fine_rotation_planes(
            torch.as_tensor(frac_delay, dtype=torch.float32, device=dev),
            phase,
            n_channels=n_channels,
            quant_scale=quant_scale,
        )
    rotc, rots = (
        torch.as_tensor(r, dtype=torch.float32, device=dev).reshape(batch, n_channels)
        for r in rot_planes
    )
    win = window.to(device=dev, dtype=torch.float32)
    kw = dict(n_spectra=n_spectra, n1=n1, n2=n2, dft_dtype=dft_dtype, quantise=quantise)
    if dev.type == "cuda":
        qr, qi = _launch(x, starts, win.contiguous(), rotc, rots, ablate=_ablate, **kw)
    elif dev.type == "cpu":
        qr, qi = fengine_ablate_reference(_ablate, x, starts, win, rotc, rots, **kw)
    else:
        raise ValueError(f"fengine_fused: unsupported device {dev}")
    shape = (*lead, n_spectra, n_channels)
    return qr.reshape(shape), qi.reshape(shape)


#: Kernel launches since the last reset (the plain CPU version never counts).
fengine_fused.launches = 0
#: Launches of K1's stopped passes (``_ablate``) since the last reset.
fengine_fused.ablate_launches = 0
