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

K1 runs as passes over groups of batches whose scratch fits
:data:`K1_SCRATCH_BYTES`, on the route :func:`_k1_body` asks the library for
before any launch. Its FIR pass (K7's first pass too) runs the body and
blocks :func:`_fir_plan` picks from the taps and S. Where the DFT pass's T planes fit shared memory (N2 <=
1024, N1 = 8 included) it is two passes: with bf16 operands (every default
engine launch) :func:`k1_fir` (steps 1-2 into a bf16 plane ``[B, S, N1,
N2]``) and :func:`k1_dft` (steps 3-5, tensor cores); with f32 operands
(``fengine="fused_f32"``) :func:`k1_fir_f32` (the f32 plane) and
:func:`k1_dft_f32` (register-blocked FFMA, exact f32). Their plain versions
:func:`k1_fir_reference` and :func:`k1_dft_reference` compose to
:func:`fengine_fused_reference`. Where they do not (N2 >= 2048, fft >=
2^22) it is three: the FIR pass, then stage A (:func:`k1_stage_a`,
:func:`k1_stage_a_f32`: steps 3 to the rounded T planes, into device
memory) and stage B (:func:`k1_stage_b`, :func:`k1_stage_b_f32`: steps 4-5),
whose plain versions :func:`k1_stage_a_reference` and
:func:`k1_stage_b_reference` compose to :func:`k1_dft_reference`. A split
no route takes raises; nothing falls back.

Where the direct-CT split does not exist, or the caller names
``deint="matmul"`` or ``"bitcast"``, :func:`fengine_fused` takes the
decimation-in-time form instead (the reference's ``_fengine_kernel``):
:func:`fengine_dit` launches ``csrc/fengine_dit.cu`` (K7) for a CUDA
tensor and runs :func:`fengine_dit_reference` for a CPU tensor. The
reference's two names move samples differently on the TPU but compute the
same values; here they differ only in the N1·N2 split :func:`_deint_mode`
gives them. :func:`_dit_body` picks K7's route up front, and K7 runs it
over groups of streams, K1's FIR pass first (:func:`k1_fir`, or
:func:`k1_fir_f32` for f32 operands). Where the DFT pass of the operand type
has a shared-memory plan (bf16 N2 <= 1024, f32 N2 <= 512, N1 = 8 included)
it is two passes: the FIR pass, then :func:`dit_dft` (tensor cores) or
:func:`dit_dft_f32` (register-blocked FFMA, exact f32). Where it has none
(bf16 N2 >= 2048, f32 N2 >= 1024) it is three: the FIR pass, stage A
(:func:`dit_stage_a`, :func:`dit_stage_a_f32`: K1's stage-A kernels on the
plane's ``[N1, 2·N2]`` view, T into device memory, in bf16 as each stream's
plane) and stage B (:func:`dit_stage_b`, :func:`dit_stage_b_f32`). The plain
versions (:func:`k1_fir_reference`, :func:`dit_dft_reference`,
:func:`dit_dft_f32_reference`; :func:`dit_stage_a_reference` and
:func:`dit_stage_b_reference`, which compose to those two) compose to
:func:`fengine_dit_reference`. A split no route takes raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

#: N1 (the row count of the frame view) must be a multiple of this.
_ROW_ALIGN = 8
#: Most bytes of scratch K1's passes keep between them: batches go through
#: in groups whose FIR planes (and, on the three-pass route, T planes) fit
#: (32 flagship streams in bf16, 16 in f32: 1.07 GB).
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


@functools.lru_cache(maxsize=16)
def _dft_f32t(n1: int, n2: int, device: str) -> torch.Tensor:
    """The f32 N2-point matrix transposed, ``[n2][k2]`` (cos columns, then
    -sin): the stage-B operand of K1's f32 DFT pass. The N1-point matrices
    are symmetric and go as they are."""
    return dft_constants(n1, n2, device).d2.t().contiguous()


def _has_plan(query: str, n1: int, n2: int) -> bool:
    """Whether the library's plan query ``query`` (a pass's ``*_attributes``)
    finds a plan for N1 x N2; a CUDA error raises."""
    lib = _build.library()
    err = getattr(lib, query)(n1, n2, (ctypes.c_int * 16)())
    if err == _NO_PLAN:
        return False
    _build.check(lib, err, query)
    return True


@functools.lru_cache(maxsize=64)
def _k1_body(n1: int, n2: int, dft_dtype: str) -> str:
    """K1's route for a split, decided before any launch: ``"two_pass"``
    (the FIR pass, then the tensor-core DFT pass) for bf16 operands and
    ``"two_pass_f32"`` (the f32 FIR pass, then the FFMA DFT pass) for f32
    operands, where that DFT pass has a shared-memory plan
    (``k1_dft_attributes`` / ``k1_dft_f32_attributes`` in
    ``csrc/fengine_ct.cu`` decide; N2 <= 1024); else ``"three_pass"`` /
    ``"three_pass_f32"`` (the FIR pass, stage A, stage B through T in device
    memory) where both stages' tiles cover the split
    (``k1_stage_{a,b}[_f32]_attributes``). A split no route takes raises
    ``ValueError``."""
    sfx = "" if dft_dtype == "bfloat16" else "_f32"
    if _has_plan(f"k1_dft{sfx}_attributes", n1, n2):
        return "two_pass" + sfx
    if all(_has_plan(f"k1_stage_{stage}{sfx}_attributes", n1, n2) for stage in "ab"):
        return "three_pass" + sfx
    raise ValueError(f"K1 has no route for the split N1 x N2 = {n1} x {n2} ({dft_dtype} "
                     "operands): neither the DFT pass's plan nor the three-pass tiles cover it")


@functools.lru_cache(maxsize=64)
def _dit_body(n1: int, n2: int, dft_dtype: str) -> str:
    """K7's route for a split, decided before any launch: ``"two_pass"``
    (K1's FIR pass, then the tensor-core DFT pass) for bf16 operands and
    ``"two_pass_f32"`` (K1's f32 FIR pass, then the FFMA DFT pass) for f32
    operands, where that DFT pass has a shared-memory plan
    (``dit_dft_attributes`` / ``dit_dft_f32_attributes`` in
    ``csrc/fengine_dit.cu`` decide; N1 = 8 included); else ``"three_pass"``
    / ``"three_pass_f32"`` (the FIR pass, K1's stage A on the ``[N1,
    2·N2]`` view, K7's stage B, through T in device memory) where both
    stages' tiles cover the split (``k1_stage_a[_f32]_attributes`` at N1 x
    2·N2, ``dit_stage_b[_f32]_attributes``). A split no route takes raises
    ``ValueError``."""
    sfx = "" if dft_dtype == "bfloat16" else "_f32"
    if _has_plan(f"dit_dft{sfx}_attributes", n1, n2):
        return "two_pass" + sfx
    if (_has_plan(f"k1_stage_a{sfx}_attributes", n1, 2 * n2)
            and _has_plan(f"dit_stage_b{sfx}_attributes", n1, n2)):
        return "three_pass" + sfx
    raise ValueError(f"K7 has no route for the split N1 x N2 = {n1} x {n2} ({dft_dtype} "
                     "operands): neither the DFT pass's plan nor the three-pass tiles cover it")


def fine_rotation_planes(
    frac_delay,
    phase,
    *,
    n_channels: int,
    quant_scale: float,
    channel_offset: int = 0,
    n_channels_total: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine-delay rotation planes ``(cos, sin) * quant_scale``.

    Shape ``[*lead, N2/2, N1]`` (channel ``k = row·N1 + lane``), f32, on the
    device of ``frac_delay``; ``rot(k) = -pi*fd*(k + channel_offset -
    Ct/2)/Ct + phase`` with ``Ct = n_channels_total`` (default
    ``n_channels``): a channel-sharded engine's absolute channels.
    Computed on the delay-update path and cached by the engine.
    """
    ct = _split_ct(2 * n_channels)
    if ct is None or n_channels & (n_channels - 1):
        raise ValueError(
            f"fft_size {2 * n_channels}: fine_rotation_planes covers the "
            "direct-CT kernel form only"
        )
    n1, n2 = ct
    return _rotation_planes(frac_delay, phase, n_channels, quant_scale, (n2 // 2, n1),
                            channel_offset=channel_offset, n_channels_total=n_channels_total)


def _rotation_planes(frac_delay, phase, n_channels, quant_scale, plane, *, channel_offset=0,
                     n_channels_total=None):
    """``(cos, sin)·quant_scale`` of the fine-delay ramp, ``[*lead, *plane]``
    (channel ``k`` row-major over ``plane``, at absolute channel ``k +
    channel_offset`` of ``n_channels_total``, default ``n_channels``;
    ``fengine_pallas._rotation_planes``)."""
    if n_channels_total is None:
        n_channels_total = n_channels
    fd = torch.as_tensor(frac_delay, dtype=torch.float32)
    ph = torch.as_tensor(phase, dtype=torch.float32, device=fd.device)
    lead = tuple(fd.shape)
    fd = fd.reshape(*lead, 1, 1)
    ph = ph.expand(lead).reshape(*lead, 1, 1)
    k = (torch.arange(n_channels, dtype=torch.float32, device=fd.device).reshape(plane)
         + channel_offset)
    rot = -math.pi * fd * (k - n_channels_total / 2.0) / n_channels_total + ph
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


def _rotate_requant(re, im, rotc, rots, quantise):
    """K1's epilogue: the fine-delay rotation of ``(re, im)`` ``[B, S, C]``
    by ``rotc``/``rots`` ``[B, C]``, then ``rint``, clip to ±127 and int8, or
    the rotated f32 values with ``quantise=False``."""
    batch, _, c = re.shape
    rc = rotc.reshape(batch, 1, c)
    rs = rots.reshape(batch, 1, c)
    outr = re * rc - im * rs
    outi = re * rs + im * rc
    if not quantise:
        return outr, outi

    def q(v):
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)

    return q(outr), q(outi)


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
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    k = dft_constants(n1, n2, str(plane.device))
    tr, ti = _ct_stage_a(plane, k, n1, n2, rnd)
    re, im = _ct_stage_b(rnd(tr), rnd(ti), k, n2, rnd)
    return _rotate_requant(re, im, rotc, rots, quantise)


def k1_stage_a_reference(
    plane: torch.Tensor, *, n1: int, n2: int, dft_dtype: str = "bfloat16"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the three-pass route's stage A: the FIR plane ``[B,
    S, fft]`` (as :func:`k1_fir_reference` gives it) to T re and im ``[B, S,
    N1, N2]``, stage A and the twiddle rounded to the operand type (bf16
    tensors, or f32): K1's ``rnd(T)``."""
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    tr, ti = _ct_stage_a(plane, dft_constants(n1, n2, str(plane.device)), n1, n2, rnd)
    if dft_dtype == "bfloat16":
        return tr.to(torch.bfloat16), ti.to(torch.bfloat16)
    return tr, ti


def k1_stage_b_reference(
    tr: torch.Tensor,
    ti: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the three-pass route's stage B: T re and im ``[B, S,
    N1, N2]`` (as :func:`k1_stage_a_reference` gives them) and
    ``rotc``/``rots`` ``[B, C]`` to int8 ``(qr, qi)`` ``[B, S, C]``, or the
    rotated f32 values with ``quantise=False``. Composed with that stage A
    it is :func:`k1_dft_reference`, bit for bit."""
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    k = dft_constants(n1, n2, str(tr.device))
    re, im = _ct_stage_b(tr.to(torch.float32), ti.to(torch.float32), k, n2, rnd)
    return _rotate_requant(re, im, rotc, rots, quantise)


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


#: K1's stage stops, ``fengine_fused(_ablate=...)``, by the reference's names
#: (``fengine_pallas.py:1397-1410``), and the numbers the kernels give them.
ABLATE_STOPS = {"dma": 1, "fir": 9, "stagea": 10, "stageb": 4}
#: The probe P5's stops (``benchmarks/ct_ablate.py``'s own trimmed kernel):
#: its ``"fir"`` and ``"stagea"`` write other values than the reference's
#: (the f32 FIR's two halves; T before its rounding). Bf16 operands,
#: quantised, on the two-pass route only, as the probe runs.
P5_STOPS = {"dma": 1, "fir": 2, "stagea": 3, "stageb": 4}
#: Spectra one probe of a ``"dma"`` stop serves (the probes' ``s_blk``).
ABLATE_S_BLK = 16


def _trunc_s8(v: torch.Tensor) -> torch.Tensor:
    """int8 by truncation toward zero, saturated: XLA's f32 -> int8
    conversion in the probes, ``cvt.rzi.sat.s8.f32`` on the card."""
    return v.trunc().clamp(-128, 127).to(torch.int8)


def _dma_frames(n1: int, n2: int) -> int:
    """Frames a ``"dma"`` probe spans from its block's first: the ``[N2/2,
    N1]`` probe of the ``[rows, N2]`` frame view reads rows ``< N2/2``,
    ``N2/(2·N1)`` frames where N1 < N2 (8 at fft 1024), else one."""
    return max(1, n2 // (2 * n1))


def _check_ablate(stop: str, n1: int, n2: int) -> None:
    """The reference's gate on its stops at the direct-CT split N1 x N2:
    ``"dma"`` where its ``[N2/2, N1]`` probe fits the ``[rows, N2]`` frame
    view (N1 <= N2), the others at N1 == N2; ``ValueError`` elsewhere."""
    if stop == "dma" and n1 > n2:
        raise ValueError(
            f"_ablate='dma' at N1 x N2 = {n1} x {n2}: the reference's probe [N2/2, N1] does "
            "not fit its [rows, N2] frame view where N1 > N2 (it raises there too)")
    if stop != "dma" and n1 != n2:
        raise ValueError(
            f"_ablate stage stops other than 'dma' need n1 == n2 (got {n1} x {n2})")


def _check_dma_frames(n_spectra: int, n_taps: int, n1: int, n2: int) -> None:
    """Refuse a ``"dma"`` stop whose last block's probe reads past the
    ``n_spectra + n_taps - 1`` frames of input (N1 < N2 with S % 16 != 0
    and few taps)."""
    last = (n_spectra - 1) // ABLATE_S_BLK * ABLATE_S_BLK
    need = last + _dma_frames(n1, n2)
    if need > n_spectra + n_taps - 1:
        raise ValueError(
            f"_ablate='dma' at N1 x N2 = {n1} x {n2}: the probe of the block at spectrum {last} "
            f"reads frames up to {need - 1}, past the {n_spectra + n_taps - 1} frames of input")


def _coarse_pad_rows(rows: int) -> int:
    """The reference's extra DMA rows for an in-kernel coarse delay
    (``fengine_pallas.py:457-461``)."""
    return ((rows + 9 + 31) // 32) * 32 - rows


def _dma_starts(starts: torch.Tensor, n_in: int, n_spectra: int, n_taps: int, n1: int,
                n2: int) -> torch.Tensor:
    """Where a ``"dma"`` probe reads each stream from: the reference's DMA
    base (``fengine_pallas.py:1497-1541``), the coarse delay's row rounded
    down to a multiple of 8 rows of N2 and clipped below the input's margin
    for blocks of :data:`ABLATE_S_BLK`; 0 without coarse delays. ``starts``
    are the clamped delays; where a delay runs past the input's end, both
    clips give the same row."""
    pad = max(_coarse_pad_rows((ABLATE_S_BLK + n_taps - 1) * n1),
              _coarse_pad_rows(ABLATE_S_BLK * n1))
    top = max(0, n_in // n2 - (n_spectra + n_taps - 1) * n1 - pad)
    return (starts // (8 * n2) * 8).clamp(max=top) * n2


def _dma_probe(x, starts, *, n_spectra, n1, n2, fft):
    """The ``"dma"`` probe ``[B, S, C]``: for spectrum ``s`` of block ``f0 =
    s - s % 16``, output ``r·N1 + l`` is row ``r < N2/2``, lane ``l < N1``
    of the ``[rows, N2]`` view of the stream from frame ``f0`` on, the
    stream read from ``starts`` (:func:`_dma_starts`)."""
    c = fft // 2
    f0 = torch.arange(n_spectra, device=x.device) // ABLATE_S_BLK * ABLATE_S_BLK
    span = _dma_frames(n1, n2) * fft
    out = torch.empty((x.shape[0], n_spectra, c), dtype=x.dtype, device=x.device)
    for b, s in enumerate(starts.tolist()):
        blocks = [x[b, s + f * fft : s + f * fft + span].reshape(-1, n2)[: n2 // 2, :n1]
                  for f in range(0, n_spectra, ABLATE_S_BLK)]
        out[b] = torch.stack(blocks).reshape(-1, c)[f0 // ABLATE_S_BLK]
    return out


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
    p5: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 cut after a stage, as the reference's
    ``fengine_fused(_ablate=stop)`` cuts it (``fengine_pallas.py:645-652,
    794-798, 905-914, 936-945``); arguments as :func:`fengine_fused_reference`,
    which ``stop=None`` is.

    Each stop writes ``(outr, outi)`` ``[B, S, C]``, int8 by truncation
    (:func:`_trunc_s8`), or with ``quantise=False`` the f32 values as they
    are: ``"dma"`` the probe of :func:`_dma_probe` (the input samples,
    from the reference's DMA base :func:`_dma_starts`) to both; ``"fir"`` the FIR rounded to the operand type, its first C samples
    (the ``[N2/2, N1]`` corner of the frame view at N1 == N2) to both;
    ``"stagea"`` T re and im rounded to the operand type, rows ``k1 <
    N1/2`` at ``k1·N2 + n2``; ``"stageb"`` re and im before the rotation.
    ``p5=True`` gives P5's stops (``benchmarks/ct_ablate.py:69-108``; bf16,
    quantised): its ``"fir"`` the f32 FIR's first and second C samples, its
    ``"stagea"`` T before the rounding.
    """
    if stop is None:
        return fengine_fused_reference(x, starts, window, rotc, rots, n_spectra=n_spectra,
                                       n1=n1, n2=n2, dft_dtype=dft_dtype, quantise=quantise)
    if stop not in ABLATE_STOPS:
        raise ValueError(f"unknown _ablate stage {stop!r}")
    fft = window.shape[1]
    c = fft // 2
    conv = _trunc_s8 if quantise else (lambda t: t.to(torch.float32))
    if stop == "dma":
        base = _dma_starts(starts, x.shape[1], n_spectra, window.shape[0], n1, n2)
        probe = conv(_dma_probe(x, base, n_spectra=n_spectra, n1=n1, n2=n2, fft=fft))
        return probe, probe.clone()
    plane = k1_fir_reference(x, starts, window, n_spectra=n_spectra, dft_dtype="float32")
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    if stop == "fir":
        if p5:
            return _trunc_s8(plane[..., :c]), _trunc_s8(plane[..., c:])
        probe = conv(rnd(plane[..., :c]))
        return probe, probe.clone()
    k = dft_constants(n1, n2, str(x.device))
    tr, ti = _ct_stage_a(rnd(plane), k, n1, n2, rnd)
    if stop == "stagea":
        return tuple(conv((t if p5 else rnd(t))[..., : n1 // 2, :].reshape(-1, n_spectra, c))
                     for t in (tr, ti))
    re, im = _ct_stage_b(rnd(tr), rnd(ti), k, n2, rnd)
    return conv(re), conv(im)


def _plane_group(batch: int, n_spectra: int, fft: int, elem_bytes: int = 2) -> int:
    """Batches a group of K1's passes takes: as many batches' scratch of
    ``elem_bytes`` a sample as fit :data:`K1_SCRATCH_BYTES` (at least one).
    The two-pass routes keep a FIR plane, 2 bytes a sample in bf16 and 4 in
    f32; the three-pass routes the plane and T re and im beside it, 3 times
    that."""
    return max(1, min(batch, K1_SCRATCH_BYTES // (elem_bytes * n_spectra * fft)))


def _route_group(body: str, batch: int, n_spectra: int, fft: int) -> int:
    """Batches a group of the K1 or K7 route ``body`` (:func:`_k1_body`,
    :func:`_dit_body`) takes: :func:`_plane_group` of the route's plane in
    its operand type, with T re and im beside it on the three-pass routes."""
    elem = 4 if body.endswith("_f32") else 2
    return _plane_group(batch, n_spectra, fft, (3 if body.startswith("three_pass") else 1) * elem)


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


#: The most spectra a block of K1's FIR pass takes: a run of one stream's
#: spectra, or the same run of several streams where S is smaller.
FIR_RUN = 256
#: The register-ring depths of the FIR pass's ring bodies; more taps than
#: the deepest take the long body (depth 0).
FIR_DEPTHS = (4, 8, 16)
#: The most spectra a run of the short-run body.
FIR_SHORT = 4


class FirPlan(NamedTuple):
    """How K1's FIR pass runs a shape: ``depth``, the register ring's rows
    (the smallest of :data:`FIR_DEPTHS` that holds the taps, or 0 for the
    long body, which reads every tap's row from global memory); a block takes
    ``run`` spectra of each of ``streams`` streams; ``short`` (1) takes the
    short-run body for runs of at most :data:`FIR_SHORT` spectra (each row
    added to every output it feeds, no register ring), 0 the ring body."""

    depth: int
    run: int
    streams: int
    short: int


def _fir_plan(batch: int, n_spectra: int, n_taps: int, fft: int) -> FirPlan:
    """Plan K1's FIR pass for ``batch`` streams of ``n_spectra`` spectra of
    ``n_taps`` taps at ``fft``: the body by taps (and by S: the short-run
    body where S <= :data:`FIR_SHORT` and the taps take a ring depth), a run
    of at most :data:`FIR_RUN` spectra, and where S is smaller than that as
    many streams a block as make up about :data:`FIR_RUN` spectra (each
    block reads its lanes of the window once for all of them: at fft 2^22
    and S = 4 the window is 268 MB). The kernel launches exactly this plan
    and refuses one that does not fit; raises ``ValueError`` where no plan
    exists."""
    if not (batch >= 1 and n_spectra >= 1 and n_taps >= 1 and fft >= 4 and fft % 4 == 0):
        raise ValueError(f"K1's FIR pass has no plan for {batch} streams x S={n_spectra} x "
                         f"{n_taps} taps at fft {fft} (fft % 4 == 0 and every count >= 1)")
    depth = next((d for d in FIR_DEPTHS if n_taps <= d), 0)
    return FirPlan(depth, min(n_spectra, FIR_RUN), min(batch, max(1, FIR_RUN // n_spectra)),
                   int(depth > 0 and n_spectra <= FIR_SHORT))


def fir_copy_words(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """How many 4-byte words the FIR pass copies a frame row and thread for
    each of ``x``'s streams (``x`` ``[B, n_in]`` int8, ``starts`` ``[B]``):
    1 where the stream's first sample (``x[b, starts[b]]``) lies on a 4-byte
    boundary, 2 where it does not (the word under the thread's 4 samples and
    the word after it, joined on read). A CPU int64 tensor ``[B]``; reads
    ``starts`` to the host."""
    first = (x.data_ptr() + torch.arange(x.shape[0], dtype=torch.int64) * x.stride(0)
             + starts.to("cpu", torch.int64))
    return 1 + (first % 4 != 0).to(torch.int64)


def _fir_pass(x, starts, window, plane) -> None:
    """K1's FIR pass into ``plane`` ``[B, S, fft]``, bf16 or f32 (CUDA
    tensors, checked by the caller), by :func:`_fir_plan`; counted on
    :func:`k1_fir` or :func:`k1_fir_f32`."""
    batch, n_spectra, fft = plane.shape
    f32 = plane.dtype == torch.float32
    plan = _fir_plan(batch, n_spectra, window.shape[0], fft)
    lib = _build.library()
    err = (lib.k1_fir_f32_launch if f32 else lib.k1_fir_launch)(
        x.data_ptr(), x.stride(0), starts.data_ptr(), window.data_ptr(), plane.data_ptr(),
        batch, n_spectra, window.shape[0], fft, *plan,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "k1_fir_f32" if f32 else "k1_fir")
    if f32:
        k1_fir_f32.launches += 1
    else:
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
        raise _no_plan("k1_dft", n1, n2, "the T planes of a chunk and the tile ring")
    _build.check(lib, err, "k1_dft")
    k1_dft.launches += 1


def _fir_plane(what, x, starts, window, n_spectra, dft_dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return k1_fir_reference(x, starts, window, n_spectra=n_spectra, dft_dtype=dft_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    n_taps, fft = window.shape
    batch = x.shape[0]
    _check(what, x, (
        ("starts", starts, torch.int64, (batch,)),
        ("window", window, torch.float32, (n_taps, fft)),
    ))
    if x.dtype != torch.int8 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{what}: x must be [B, n_in] int8 with unit sample stride")
    if window.data_ptr() % 16:
        window = window.clone()  # the kernel reads the window as float4
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    plane = torch.empty((batch, n_spectra, fft), dtype=dtype, device=x.device)
    _fir_pass(x, starts, window, plane)
    return plane


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
    return _fir_plane("k1_fir", x, starts, window, n_spectra, "bfloat16")


def k1_fir_f32(
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    *,
    n_spectra: int,
) -> torch.Tensor:
    """K1's FIR pass for f32 DFT operands: the f32 tap-order sums ``[B,
    n_spectra, fft]`` (the kernel on CUDA, :func:`k1_fir_reference` with
    ``dft_dtype="float32"`` on CPU); arguments as :func:`k1_fir`."""
    return _fir_plane("k1_fir_f32", x, starts, window, n_spectra, "float32")


#: The FIR pass's stops as ``k1_fir_stop_launch`` numbers them (and whether
#: their plane is f32), by the names :func:`k1_fir_attributes` gives their
#: bodies: the reference's ``dma`` and ``fir`` (``fir_f32`` into the f32
#: plane), P5's ``p5_fir``, P2's ``dit_*``; the copies-only ones (dma,
#: dit_dma, dit_conv) have one body whatever the depth.
FIR_STOP_BODIES = {"dma": (1, 0), "dma_f32": (1, 1), "fir": (9, 0), "fir_f32": (9, 1),
                   "p5_fir": (2, 0),
                   "dit_dma": (5, 0), "dit_conv": (6, 0), "dit_fir": (7, 0),
                   "dit_deint": (8, 0)}
_FIR_COPIES_ONLY = ("dma", "dma_f32", "dit_dma", "dit_conv")


def k1_fir_attributes() -> dict:
    """``cudaFuncGetAttributes`` of every body of K1's FIR pass: registers,
    local (spill) bytes, shared bytes a block (the ring's 64 KB, 24 KB on
    the short-run bodies, and the streams' starts; the long body only the
    starts), the most threads a
    block and blocks an SM, keyed ``"bf16/<body>"`` and ``"f32/<body>"``
    (body 4, 8, 16: the ring bodies; ``4s``, ``8s``, ``16s``: the short-run
    bodies; ``long``) and, for the stops, ``"<stop>/<body>"`` or ``"<stop>"``
    (the copies-only ones). Needs the card."""
    lib = _build.library()
    keys = ("regs", "local_bytes", "smem_bytes", "max_threads", "blocks_per_sm")
    out = {}

    def get(name, fn, *args):
        buf = (ctypes.c_int * 5)()
        _build.check(lib, fn(*args, buf), f"k1_fir_attributes {name}")
        out[name] = dict(zip(keys, buf))

    bodies = [(d, 0, str(d)) for d in FIR_DEPTHS] + [(d, 1, f"{d}s") for d in FIR_DEPTHS]
    for depth, short, name in bodies + [(0, 0, "long")]:
        for plane in ("bf16", "f32"):
            get(f"{plane}/{name}", lib.k1_fir_attributes, depth, short, int(plane == "f32"))
        for stop, (num, f32) in FIR_STOP_BODIES.items():
            if stop not in _FIR_COPIES_ONLY:
                get(f"{stop}/{name}", lib.k1_fir_stop_attributes, depth, short, num, f32)
    for stop in _FIR_COPIES_ONLY:
        get(stop, lib.k1_fir_stop_attributes, 0, 0, *FIR_STOP_BODIES[stop])
    return out


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
    if fft != n1 * n2 or n1 < 8:
        raise ValueError(f"k1_dft: the pass takes N1 >= 8 and fft = N1*N2, got {n1}, {n2}, {fft}")
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


def k1_dft_attributes(n1: int, n2: int) -> dict:
    """The card's view of K1's bf16 DFT-pass body at N1 x N2
    (``cudaFuncGetAttributes`` and the plan): registers and local (spill)
    bytes a thread (the wgmma body's are its launch's: its warpgroups
    rebalance them with ``setmaxnreg``), KC (128 at N1 = 8: 16 spectra of 8
    rows), the K-tile depth (stage B's at N1 = 8, a ring slot's on the wgmma
    body), ring stages, shared-memory bytes, blocks a cluster and the
    products a stage-A sum adds before it joins the f32 master sum."""
    out = (ctypes.c_int * 8)()
    lib = _build.library()
    err = lib.k1_dft_attributes(n1, n2, out)
    if err == _NO_PLAN:
        raise _no_plan("k1_dft", n1, n2, "the T planes of a chunk and the tile ring")
    _build.check(lib, err, "k1_dft_attributes")
    return dict(zip(("regs", "local_bytes", "kc", "ktb", "stages", "smem_bytes", "cluster",
                     "group_products"), out))


def _dft_f32_pass(plane, rotc, rots, outr, outi, *, n1, n2, quantise) -> None:
    """K1's f32 DFT pass from ``plane`` into ``outr``/``outi`` (CUDA tensors,
    checked by the caller, on a split :func:`_k1_body` gives
    ``"two_pass_f32"``)."""
    if plane.data_ptr() % 16:
        plane = plane.clone()  # the kernel copies plane rows in 16-byte pieces
    rotc, rots = (r.clone() if r.data_ptr() % 16 else r for r in (rotc, rots))  # float4 reads
    batch, n_spectra, _ = plane.shape
    dev = plane.device
    k = dft_constants(n1, n2, str(dev))
    lib = _build.library()
    d2t = _dft_f32t(n1, n2, str(dev))
    err = lib.k1_dft_f32_launch(
        plane.data_ptr(), k.d1c.data_ptr(), k.d1s.data_ptr(), d2t.data_ptr(), k.twc.data_ptr(),
        k.tws.data_ptr(), rotc.data_ptr(), rots.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n1, n2, int(quantise), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("k1_dft_f32", n1, n2, "the f32 T planes of an 8-row chunk and the ring")
    _build.check(lib, err, "k1_dft_f32")
    k1_dft_f32.launches += 1


def k1_dft_f32(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's DFT pass alone, f32 operands: ``plane`` ``[B, S, fft]`` f32 to
    ``(qr, qi)`` ``[B, S, C]`` (the kernel on CUDA, :func:`k1_dft_reference`
    with ``dft_dtype="float32"`` on CPU)."""
    if plane.device.type == "cpu":
        return k1_dft_reference(plane, rotc, rots, n1=n1, n2=n2, dft_dtype="float32",
                                quantise=quantise)
    if plane.device.type != "cuda":
        raise ValueError(f"k1_dft_f32: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != n1 * n2 or _k1_body(n1, n2, "float32") != "two_pass_f32":
        raise ValueError(f"k1_dft_f32: the pass takes fft = N1*N2 with a plan (N2 <= 1024), "
                         f"got {n1}, {n2}, {fft}")
    _check("k1_dft_f32", plane, (
        ("plane", plane, torch.float32, None),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    ))
    out_dtype = torch.int8 if quantise else torch.float32
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=out_dtype, device=plane.device)
    outi = torch.empty_like(outr)
    _dft_f32_pass(plane, rotc, rots, outr, outi, n1=n1, n2=n2, quantise=quantise)
    return outr, outi


def k1_dft_f32_attributes(n1: int, n2: int) -> dict:
    """The card's view of K1's f32 DFT-pass body at N1 x N2
    (``cudaFuncGetAttributes`` and the plan): registers and local (spill)
    bytes a thread, KC, SB (spectra a unit), the stage-B K-tile depth, ring
    stages, shared-memory bytes and threads a block."""
    out = (ctypes.c_int * 8)()
    lib = _build.library()
    err = lib.k1_dft_f32_attributes(n1, n2, out)
    if err == _NO_PLAN:
        raise _no_plan("k1_dft_f32", n1, n2, "the f32 T planes of an 8-row chunk and the ring")
    _build.check(lib, err, "k1_dft_f32_attributes")
    return dict(zip(("regs", "local_bytes", "kc", "sb", "ktb", "stages", "smem_bytes",
                     "threads"), out))


def k1_stop_attributes(n1: int, n2: int, dft_dtype: str = "bfloat16") -> dict:
    """The card's view of the stop bodies that K1's stagea and stageb stops
    run at N1 x N2 (N1 == N2) on the route :func:`_k1_body` gives the
    operand type, with the requant (``q``) and without (``f32``): registers
    and local (spill) bytes a thread, keyed ``"<stop>/<q|f32>"`` (the
    two-pass routes' DFT-pass stop bodies, with their KC) or
    ``"stageb/<q|f32>"`` and ``"gather/<q|f32>"`` (the three-pass route's
    stage B stop and T gather). The FIR pass's stop bodies are in
    :func:`k1_fir_attributes`. Needs the card."""
    lib = _build.library()
    body = _k1_body(n1, n2, dft_dtype)
    f32 = int(body.endswith("_f32"))
    out = {}
    for quant, tag in ((1, "q"), (0, "f32")):
        if body.startswith("three_pass"):
            buf = (ctypes.c_int * 4)()
            _build.check(lib, lib.k1_stage_stop_attributes(f32, quant, buf), "k1_stop_attributes")
            out[f"stageb/{tag}"] = dict(regs=buf[0], local_bytes=buf[1])
            out[f"gather/{tag}"] = dict(regs=buf[2], local_bytes=buf[3])
            continue
        query = lib.k1_dft_f32_stop_attributes if f32 else lib.k1_dft_stop_attributes
        for stop in ("stagea", "stageb"):
            buf = (ctypes.c_int * 3)()
            err = query(n1, n2, ABLATE_STOPS[stop], quant, buf)
            if err == _NO_PLAN:
                raise ValueError(f"no {stop} stop body takes N1 x N2 = {n1} x {n2}")
            _build.check(lib, err, "k1_stop_attributes")
            out[f"{stop}/{tag}"] = dict(regs=buf[0], local_bytes=buf[1], kc=buf[2])
    return out


def _stage_call(what, n1, n2, *args) -> None:
    """Calls the library's ``what`` with ``args``; where the three-pass tiles
    do not cover N1 x N2 it raises ``ValueError``, on a CUDA error
    ``RuntimeError``."""
    lib = _build.library()
    err = getattr(lib, what)(*args)
    if err == _NO_PLAN:
        raise ValueError(f"{what}: the three-pass tiles do not cover N1 x N2 = {n1} x {n2} "
                         "(powers of two, N1 >= 64, N2 >= 128)")
    _build.check(lib, err, what)


def _stage_a_pass(plane, tr, ti, *, n1, n2) -> None:
    """The three-pass route's stage A from ``plane`` ``[G, S, fft]`` into
    ``tr``/``ti`` (CUDA tensors of the operand type, 16-byte aligned, checked
    by the caller): ``[G, S, N1, N2]`` in bf16, transposed ``[G, S, N2, N1]``
    in f32; counted on :func:`k1_stage_a` or :func:`k1_stage_a_f32`."""
    f32 = plane.dtype == torch.float32
    dev = plane.device
    k = dft_constants(n1, n2, str(dev))
    d1c, d1s = (k.d1c, k.d1s) if f32 else _dft_bf16(n1, n2, str(dev))[:2]
    what = "k1_stage_a_f32" if f32 else "k1_stage_a"
    _stage_call(what + "_launch", n1, n2,
                plane.data_ptr(), d1c.data_ptr(), d1s.data_ptr(), k.twc.data_ptr(),
                k.tws.data_ptr(), tr.data_ptr(), ti.data_ptr(), plane.shape[0] * plane.shape[1],
                n1, n2, torch.cuda.current_stream(dev).cuda_stream)
    (k1_stage_a_f32 if f32 else k1_stage_a).launches += 1


def _stage_b_pass(tr, ti, rotc, rots, outr, outi, *, n1, n2, quantise) -> None:
    """The three-pass route's stage B from ``tr``/``ti`` (as
    :func:`_stage_a_pass` writes them) into ``outr``/``outi`` ``[G, S, C]``
    (CUDA tensors, 16-byte aligned, checked by the caller); counted on
    :func:`k1_stage_b` or :func:`k1_stage_b_f32`."""
    f32 = tr.dtype == torch.float32
    dev = tr.device
    d2 = _dft_f32t(n1, n2, str(dev)) if f32 else _dft_bf16(n1, n2, str(dev))[2]
    what = "k1_stage_b_f32" if f32 else "k1_stage_b"
    _stage_call(what + "_launch", n1, n2,
                tr.data_ptr(), ti.data_ptr(), d2.data_ptr(), rotc.data_ptr(), rots.data_ptr(),
                outr.data_ptr(), outi.data_ptr(), tr.shape[0], tr.shape[1], n1, n2,
                int(quantise), torch.cuda.current_stream(dev).cuda_stream)
    (k1_stage_b_f32 if f32 else k1_stage_b).launches += 1


def _t_layout(n1: int, n2: int, dtype: torch.dtype) -> tuple[int, int]:
    """A spectrum's T planes as the three-pass kernels keep them: ``(N1,
    N2)`` in bf16 (the MMAs read rows of k1), ``(N2, N1)`` in f32 (the FFMA
    stage B reads 4 k1 of an n2 at once)."""
    return (n1, n2) if dtype == torch.bfloat16 else (n2, n1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its base is not 16-byte aligned (the stages
    copy rows and read rotation values 16 bytes at a time)."""
    return t.clone() if t.data_ptr() % 16 else t


def _stage_a(what, plane, n1, n2, dft_dtype):
    if plane.device.type == "cpu":
        return k1_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)
    if plane.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != n1 * n2:
        raise ValueError(f"{what}: fft {fft} != N1*N2 = {n1}*{n2}")
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    _check(what, plane, (("plane", plane, dtype, None),))
    tr, ti = (torch.empty((batch, n_spectra, *_t_layout(n1, n2, dtype)), dtype=dtype,
                          device=plane.device) for _ in range(2))
    _stage_a_pass(_aligned(plane), tr, ti, n1=n1, n2=n2)
    if dtype == torch.float32:
        return tr.transpose(-1, -2), ti.transpose(-1, -2)  # views [B, S, N1, N2]
    return tr, ti


def _stage_b(what, tr, ti, rotc, rots, n1, n2, quantise, dft_dtype):
    if tr.device.type == "cpu":
        return k1_stage_b_reference(tr, ti, rotc, rots, n1=n1, n2=n2, dft_dtype=dft_dtype,
                                    quantise=quantise)
    if tr.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {tr.device}")
    batch, n_spectra = tr.shape[:2]
    c = n1 * n2 // 2
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    for name, t in (("tr", tr), ("ti", ti)):
        if tuple(t.shape) != (batch, n_spectra, n1, n2):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{(batch, n_spectra, n1, n2)}")
    if dtype == torch.float32:  # the kernel reads T transposed
        tr, ti = (t.transpose(-1, -2).contiguous() for t in (tr, ti))
    layout = (batch, n_spectra, *_t_layout(n1, n2, dtype))
    _check(what, tr, (
        ("tr", tr, dtype, layout),
        ("ti", ti, dtype, layout),
        ("rotc", rotc, torch.float32, (batch, c)),
        ("rots", rots, torch.float32, (batch, c)),
    ))
    out_dtype = torch.int8 if quantise else torch.float32
    outr = torch.empty((batch, n_spectra, c), dtype=out_dtype, device=tr.device)
    outi = torch.empty_like(outr)
    _stage_b_pass(*(_aligned(t) for t in (tr, ti, rotc, rots)), outr, outi, n1=n1, n2=n2,
                  quantise=quantise)
    return outr, outi


def k1_stage_a(plane: torch.Tensor, *, n1: int, n2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The three-pass route's stage A alone, bf16 operands: the bf16 FIR
    plane ``[B, S, fft]`` to bf16 T re and im ``[B, S, N1, N2]`` (the kernel
    on CUDA, :func:`k1_stage_a_reference` on CPU)."""
    return _stage_a("k1_stage_a", plane, n1, n2, "bfloat16")


def k1_stage_a_f32(plane: torch.Tensor, *, n1: int, n2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The three-pass route's stage A alone, f32 operands (FFMA, exact f32):
    the f32 plane to f32 T re and im ``[B, S, N1, N2]`` (the kernel on CUDA,
    views of its transposed T; :func:`k1_stage_a_reference` with
    ``dft_dtype="float32"`` on CPU)."""
    return _stage_a("k1_stage_a_f32", plane, n1, n2, "float32")


def k1_stage_b(
    tr: torch.Tensor, ti: torch.Tensor, rotc: torch.Tensor, rots: torch.Tensor, *, n1: int,
    n2: int, quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The three-pass route's stage B alone, bf16 operands: bf16 T re and im
    ``[B, S, N1, N2]`` and ``rotc``/``rots`` ``[B, C]`` to ``(qr, qi)`` ``[B,
    S, C]`` (the kernel on CUDA, :func:`k1_stage_b_reference` on CPU)."""
    return _stage_b("k1_stage_b", tr, ti, rotc, rots, n1, n2, quantise, "bfloat16")


def k1_stage_b_f32(
    tr: torch.Tensor, ti: torch.Tensor, rotc: torch.Tensor, rots: torch.Tensor, *, n1: int,
    n2: int, quantise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The three-pass route's stage B alone, f32 operands (FFMA): f32 T re
    and im to ``(qr, qi)`` (the kernel on CUDA, :func:`k1_stage_b_reference`
    with ``dft_dtype="float32"`` on CPU)."""
    return _stage_b("k1_stage_b_f32", tr, ti, rotc, rots, n1, n2, quantise, "float32")


#: The fields of a three-pass stage body's attributes, as the library's
#: ``k1_stage_*_attributes`` give them; the bf16 (wgmma) bodies add the
#: products a sum adds up before it joins its f32 master sum (the whole sum
#: where the wgmmas chain) and the bytes of a ring slot.
_STAGE_FIELDS = ("regs", "local_bytes", "threads", "smem_bytes", "tile_rows", "tile_cols",
                 "k_depth", "stages", "blocks_per_sm")
_WG_STAGE_FIELDS = _STAGE_FIELDS + ("group_products", "slot_bytes")


def _stage_attributes(query: str, n1: int, n2: int, bf16: bool) -> dict:
    """One stage body's attributes from the library's ``query`` at N1 x N2."""
    fields = _WG_STAGE_FIELDS if bf16 else _STAGE_FIELDS
    buf = (ctypes.c_int * len(fields))()
    _stage_call(query, n1, n2, n1, n2, buf)
    return dict(zip(fields, buf))


def k1_stage_attributes(n1: int, n2: int, dft_dtype: str = "bfloat16") -> dict:
    """The card's view of the three-pass route's two stage bodies at N1 x N2
    (``cudaFuncGetAttributes`` and the tiling): ``{"a": ..., "b": ...}``,
    each with registers and local (spill) bytes a thread, threads a block,
    shared-memory bytes, tile rows and columns, K depth a ring slot, ring
    slots and blocks an SM; the bf16 bodies (wgmma) also each sum's group
    depth in products and the bytes of a ring slot."""
    bf16 = dft_dtype == "bfloat16"
    sfx = "" if bf16 else "_f32"
    return {stage: _stage_attributes(f"k1_stage_{stage}{sfx}_attributes", n1, n2, bf16)
            for stage in "ab"}


#: Launches of K1's passes since the last reset (the plain versions never
#: count); every K1 call adds one to each pass of its route per group of
#: batches.
k1_fir.launches = 0
k1_dft.launches = 0
k1_fir_f32.launches = 0
k1_dft_f32.launches = 0
k1_stage_a.launches = 0
k1_stage_b.launches = 0
k1_stage_a_f32.launches = 0
k1_stage_b_f32.launches = 0


#: The kernels' numbers of the stops of K1's FIR pass (the others cut a
#: later pass).
_FIR_PASS_STOPS = (ABLATE_STOPS["dma"], P5_STOPS["fir"], ABLATE_STOPS["fir"])


def _stop_pass(x, starts, window, plane, outr, outi, *, n1, n2, stop, body, t=None) -> None:
    """One group of K1's passes on the route ``body`` (:func:`_k1_body`) cut
    at the kernels' stop number ``stop`` (:data:`ABLATE_STOPS`,
    :data:`P5_STOPS`; CUDA tensors, checked by the caller). The ``"dma"``
    and ``"fir"`` stops are the FIR pass's (``"fir"`` writes ``plane`` of
    the route's operand type too; ``"dma"`` none). ``"stagea"`` and
    ``"stageb"`` run the route's passes as its full call runs them up to the
    stop: on the two-pass routes the FIR pass, then the DFT pass's stop
    (``k1_dft_stop_launch``, ``k1_dft_f32_stop_launch``); on the three-pass
    routes the FIR pass and stage A into ``t`` = (T re, T im), then T's rows
    ``k1 < N1/2`` gathered (``k1_t_slice_launch``) or stage B without the
    rotation (``k1_stage_b_stop_launch``). ``outr``/``outi`` int8, or f32
    without the requant. Counted on ``fengine_fused.ablate_launches``, the
    passes it runs whole on their own counters."""
    lib = _build.library()
    batch, n_spectra, c = outr.shape
    fft, quant = 2 * c, int(outr.dtype == torch.int8)
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stop in _FIR_PASS_STOPS:
        err = lib.k1_fir_stop_launch(
            x.data_ptr(), x.stride(0), starts.data_ptr(), window.data_ptr(),
            plane.data_ptr() if plane is not None else None, outr.data_ptr(), outi.data_ptr(),
            batch, n_spectra, window.shape[0], fft, *_fir_plan(batch, n_spectra, window.shape[0],
                                                                 fft),
            stop, n2, int(plane is not None and plane.dtype == torch.float32), quant, stream,
        )
        _build.check(lib, err, f"k1_fir stop {stop}")
    else:
        _fir_pass(x, starts, window, plane)
        f32 = plane.dtype == torch.float32
        k = dft_constants(n1, n2, str(dev))
        if body.startswith("three_pass"):
            tr, ti = t
            _stage_a_pass(plane, tr, ti, n1=n1, n2=n2)
            if stop == ABLATE_STOPS["stagea"]:
                what = "k1_t_slice"
                err = lib.k1_t_slice_launch(tr.data_ptr(), ti.data_ptr(), outr.data_ptr(),
                                            outi.data_ptr(), batch * n_spectra, n1, n2, int(f32),
                                            quant, stream)
            else:
                what = "k1_stage_b_stop"
                d2 = _dft_f32t(n1, n2, str(dev)) if f32 else _dft_bf16(n1, n2, str(dev))[2]
                err = lib.k1_stage_b_stop_launch(tr.data_ptr(), ti.data_ptr(), d2.data_ptr(),
                                                 outr.data_ptr(), outi.data_ptr(), batch,
                                                 n_spectra, n1, n2, int(f32), quant, stream)
        elif f32:
            what = "k1_dft_f32_stop"
            err = lib.k1_dft_f32_stop_launch(
                plane.data_ptr(), k.d1c.data_ptr(), k.d1s.data_ptr(),
                _dft_f32t(n1, n2, str(dev)).data_ptr(), k.twc.data_ptr(), k.tws.data_ptr(),
                outr.data_ptr(), outi.data_ptr(), batch, n_spectra, n1, n2, stop, quant, stream)
        else:
            what = "k1_dft_stop"
            err = lib.k1_dft_stop_launch(
                plane.data_ptr(), *(m.data_ptr() for m in _dft_bf16(n1, n2, str(dev))),
                k.twc.data_ptr(), k.tws.data_ptr(), outr.data_ptr(), outi.data_ptr(), batch,
                n_spectra, n1, n2, stop, quant, stream)
        if err == _NO_PLAN:
            raise ValueError(f"{what}: no stop body takes N1 x N2 = {n1} x {n2} at stop {stop}")
        _build.check(lib, err, f"{what} {stop}")
    fengine_fused.ablate_launches += 1


def _launch_ablate(x, starts, window, outr, outi, *, n_spectra, n1, n2, dft_dtype, ablate,
                   p5=False):
    """K1's route for the split and operand type (:func:`_k1_body`, as the
    whole call takes it) cut at ``ablate``, over the groups of that route
    (:func:`_route_group`) through one scratch of its operand type; ``p5``:
    P5's stops (:data:`P5_STOPS`), on the bf16 two-pass route only."""
    body = _k1_body(n1, n2, dft_dtype)
    if p5 and body != "two_pass":
        raise ValueError(f"P5's stops run on K1's bf16 two-pass route only, not {body}")
    stop = (P5_STOPS if p5 else ABLATE_STOPS)[ablate]
    batch, fft = x.shape[0], window.shape[1]
    dtype = torch.float32 if body.endswith("_f32") else torch.bfloat16
    dev = x.device
    group = _route_group(body, batch, n_spectra, fft)
    plane = t = None
    if ablate == "dma":
        starts = _dma_starts(starts, x.shape[1], n_spectra, window.shape[0], n1, n2)
    else:
        plane = torch.empty((group, n_spectra, fft), dtype=dtype, device=dev)
    if ablate in ("stagea", "stageb") and body.startswith("three_pass"):
        t = tuple(torch.empty((group, n_spectra, *_t_layout(n1, n2, dtype)), dtype=dtype,
                              device=dev) for _ in range(2))
    for b0 in range(0, batch, group):
        b = slice(b0, min(batch, b0 + group))
        g = b.stop - b0
        _stop_pass(x[b], starts[b], window, None if plane is None else plane[:g], outr[b],
                   outi[b], n1=n1, n2=n2, stop=stop, body=body,
                   t=None if t is None else tuple(u[:g] for u in t))
    return outr, outi


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
    p5: bool = False,
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
        return _launch_ablate(x, starts, window, outr, outi, n_spectra=n_spectra, n1=n1, n2=n2,
                              dft_dtype=dft_dtype, ablate=ablate, p5=p5)
    body = _k1_body(n1, n2, dft_dtype)
    f32 = body.endswith("_f32")
    three = body.startswith("three_pass")
    dtype = torch.float32 if f32 else torch.bfloat16
    # The route's passes over groups of batches through one scratch: the FIR
    # plane, and on the three-pass route T re and im beside it.
    group = _route_group(body, batch, n_spectra, fft)
    plane = torch.empty((group, n_spectra, fft), dtype=dtype, device=dev)
    if three:
        tr, ti = (torch.empty((group, n_spectra, *_t_layout(n1, n2, dtype)), dtype=dtype,
                              device=dev) for _ in range(2))
    dft = _dft_f32_pass if f32 else _dft_pass
    for b0 in range(0, batch, group):
        b = slice(b0, min(batch, b0 + group))
        g = b.stop - b0
        _fir_pass(x[b], starts[b], window, plane[:g])
        if three:
            _stage_a_pass(plane[:g], tr[:g], ti[:g], n1=n1, n2=n2)
            _stage_b_pass(tr[:g], ti[:g], rotc[b], rots[b], outr[b], outi[b], n1=n1, n2=n2,
                          quantise=quantise)
        else:
            dft(plane[:g], rotc[b], rots[b], outr[b], outi[b], n1=n1, n2=n2, quantise=quantise)
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


def _dit_streams_a(acc, n1, n2, rnd):
    """K7's stage A of its rounded FIR ``acc`` ``[B, S, fft]`` (f32): the even
    and the odd stream's rounded ``(tr, ti)`` ``[B, S, N1, N2]``."""
    batch, n_spectra, _ = acc.shape
    k = dit_constants(n1, n2, str(acc.device))
    return tuple(_dit_stage_a(acc[..., q::2].reshape(batch, n_spectra, n1, n2), k, rnd)
                 for q in (0, 1))


def _dit_streams_b(even, odd, rotc, rots, n1, n2, rnd):
    """K7 after stage A: both streams' stage B from their rounded ``(tr,
    ti)``, the combine, the rotation and the requant."""
    batch, n_spectra = even[0].shape[:2]
    n = n1 * n2
    k = dit_constants(n1, n2, str(even[0].device))
    er, ei = _dit_stage_b(*even, k, rnd)  # [B, S, N2, N1], bin k = k2*N1 + k1
    orr, oi = _dit_stage_b(*odd, k, rnd)
    xr = (er + k.untc * orr - k.unts * oi).reshape(batch, n_spectra, n)
    xi = (ei + k.untc * oi + k.unts * orr).reshape(batch, n_spectra, n)
    rc = rotc.reshape(batch, 1, n)
    rs = rots.reshape(batch, 1, n)

    def q(v):
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)

    return q(xr * rc - xi * rs), q(xr * rs + xi * rc)


def _dit_dft(acc, rotc, rots, n1, n2, rnd):
    """K7 after its rounded FIR ``acc`` ``[B, S, fft]`` (f32): the even / odd
    split, both half-length DFTs, the combine, the rotation and the requant."""
    return _dit_streams_b(*_dit_streams_a(acc, n1, n2, rnd), rotc, rots, n1, n2, rnd)


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
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    return _dit_dft(rnd(_dit_fir(frames, window)), rotc, rots, n1, n2, rnd)


def dit_dft_reference(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's DFT pass (bf16 operands): the bf16 FIR plane
    ``[B, S, fft]`` (:func:`k1_fir_reference` of the frames viewed ``[B,
    n_frames·fft]`` with zero starts) and ``rotc``/``rots`` ``[B, N]`` to
    int8 ``(qr, qi)`` ``[B, S, N]``. Composed with that FIR it is
    :func:`fengine_dit_reference` with bf16 operands, bit for bit."""
    return _dit_dft(plane.to(torch.float32), rotc, rots, n1, n2, _round_bf16)


#: The least N2 the DFT pass's stage B takes (an MMA's depth): the N2-point
#: matrices of smaller N2 (N1 = 8, fft <= 256) go to it zero-padded.
_MIN_N2P = 16


@functools.lru_cache(maxsize=16)
def _dit_bf16(n1: int, n2: int, device: str) -> tuple[torch.Tensor, ...]:
    """bf16 (round-to-nearest-even) copies of d1c, d1s, d2c, d2s: the
    operands of K7's DFT pass, d2c and d2s zero-padded to ``[N2P, N2P]``
    (N2P = max(N2, 16); their extra rows and columns add exact zeros)."""
    k = dit_constants(n1, n2, device)
    pad = max(n2, _MIN_N2P) - n2
    d2 = (torch.nn.functional.pad(t, (0, pad, 0, pad)) for t in (k.d2c, k.d2s))
    return tuple(t.to(torch.bfloat16).contiguous() for t in (k.d1c, k.d1s, *d2))


def _dit_dft_pass(plane, rotc, rots, outr, outi, *, n1, n2) -> None:
    """K7's DFT pass from ``plane`` into ``outr``/``outi`` (CUDA tensors,
    checked by the caller)."""
    if plane.data_ptr() % 16:
        plane = plane.clone()  # the kernel copies plane rows in 16-byte pieces
    rotc, rots = (r.clone() if r.data_ptr() % 8 else r for r in (rotc, rots))  # read as float2
    batch, n_spectra, _ = plane.shape
    dev = plane.device
    k = dit_constants(n1, n2, str(dev))
    lib = _build.library()
    err = lib.dit_dft_launch(
        plane.data_ptr(), *(t.data_ptr() for t in _dit_bf16(n1, n2, str(dev))),
        k.twc.data_ptr(), k.tws.data_ptr(), k.untc.data_ptr(), k.unts.data_ptr(),
        rotc.data_ptr(), rots.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n1, n2, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("dit_dft", n1, n2, "the four bf16 T planes of a 16-row chunk and the ring")
    _build.check(lib, err, "dit_dft")
    dit_dft.launches += 1


def dit_dft(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's DFT pass alone, bf16 operands: ``plane`` ``[B, S, fft]`` bf16 to
    int8 ``(qr, qi)`` ``[B, S, N]`` (the kernel on CUDA,
    :func:`dit_dft_reference` on CPU)."""
    if plane.device.type == "cpu":
        return dit_dft_reference(plane, rotc, rots, n1=n1, n2=n2)
    if plane.device.type != "cuda":
        raise ValueError(f"dit_dft: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != 2 * n1 * n2 or _dit_body(n1, n2, "bfloat16") != "two_pass":
        raise ValueError(f"dit_dft: the pass takes fft = 2*N1*N2 with a two-pass plan "
                         f"(N2 <= 1024), got {n1}, {n2}, {fft}")
    _check("dit_dft", plane, (
        ("plane", plane, torch.bfloat16, None),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    ))
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=plane.device)
    outi = torch.empty_like(outr)
    _dit_dft_pass(plane, rotc, rots, outr, outi, n1=n1, n2=n2)
    return outr, outi


#: Launches of K7's DFT pass since the last reset (the plain version never
#: counts); a two-pass K7 call adds one per group of streams.
dit_dft.launches = 0


#: K7's DFT-pass stage stops as the kernel numbers them (:func:`dit_dft_stop`).
DIT_DFT_STOPS = {"stagea": 1, "stageb": 2}


def dit_dft_stop_reference(
    stop: str, plane: torch.Tensor, *, n1: int, n2: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's DFT pass cut at a stage: ``"stagea"`` writes
    nothing (zeros); ``"stageb"`` each stream's stage-B re, truncated
    (:func:`_trunc_s8`), at ``k2·N1 + k1``: even to ``outr``, odd to
    ``outi``."""
    if stop not in DIT_DFT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    batch, n_spectra, fft = plane.shape
    if stop == "stagea":
        zero = torch.zeros((batch, n_spectra, fft // 2), dtype=torch.int8, device=plane.device)
        return zero, zero.clone()
    k = dit_constants(n1, n2, str(plane.device))
    acc = plane.to(torch.float32)
    out = []
    for q in (0, 1):
        t = _dit_stage_a(acc[..., q::2].reshape(batch, n_spectra, n1, n2), k, _round_bf16)
        out.append(_trunc_s8(_dit_stage_b(*t, k, _round_bf16)[0].reshape(batch, n_spectra, -1)))
    return out[0], out[1]


def dit_dft_stop(
    plane: torch.Tensor, *, n1: int, n2: int, stop: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's DFT pass cut at a stage (:data:`DIT_DFT_STOPS`): the kernel's stop
    on CUDA, :func:`dit_dft_stop_reference` on CPU; outputs start as zeros.
    The kernel's stops take the 64-row chunk plan with chained stage-A sums
    only (64 <= N1 <= 256, N2 <= 256)."""
    if stop not in DIT_DFT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    if plane.device.type == "cpu":
        return dit_dft_stop_reference(stop, plane, n1=n1, n2=n2)
    if plane.device.type != "cuda":
        raise ValueError(f"dit_dft_stop: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != 2 * n1 * n2:
        raise ValueError(f"dit_dft_stop: fft {fft} != 2 * {n1} * {n2}")
    _check("dit_dft_stop", plane, (("plane", plane, torch.bfloat16, None),))
    if plane.data_ptr() % 16:
        plane = plane.clone()
    dev = plane.device
    outr = torch.zeros((batch, n_spectra, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.zeros_like(outr)
    k = dit_constants(n1, n2, str(dev))
    lib = _build.library()
    err = lib.dit_dft_stop_launch(
        plane.data_ptr(), *(t.data_ptr() for t in _dit_bf16(n1, n2, str(dev))),
        k.twc.data_ptr(), k.tws.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n1, n2, DIT_DFT_STOPS[stop], torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("dit_dft_stop", n1, n2, "the stops take the 64-row chunk plan only")
    _build.check(lib, err, f"dit_dft stop {stop}")
    dit_dft_stop.launches += 1
    return outr, outi


#: Launches of K7's stopped DFT pass since the last reset.
dit_dft_stop.launches = 0


def dit_dft_attributes(n1: int, n2: int) -> dict:
    """The card's view of K7's DFT-pass body at N1 x N2 (``cudaFuncGetAttributes``
    and the plan): registers a thread, local (spill) bytes a thread, KC (T
    rows a unit: at N1 = 8 those of 16 spectra, or 8 at N2 = 128), the
    stage-B K-tile depth, ring stages, shared-memory bytes and spectra a
    unit."""
    out = (ctypes.c_int * 7)()
    lib = _build.library()
    err = lib.dit_dft_attributes(n1, n2, out)
    if err == _NO_PLAN:
        raise _no_plan("dit_dft", n1, n2, "the four bf16 T planes of a 16-row chunk and the ring")
    _build.check(lib, err, "dit_dft_attributes")
    return dict(zip(("regs", "local_bytes", "kc", "ktb", "stages", "smem_bytes", "sb"), out))


def dit_dft_f32_reference(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's f32 DFT pass: the f32 FIR plane ``[B, S, fft]``
    (:func:`k1_fir_reference` with ``dft_dtype="float32"`` of the frames
    viewed ``[B, n_frames·fft]`` with zero starts) and ``rotc``/``rots``
    ``[B, N]`` to int8 ``(qr, qi)`` ``[B, S, N]``. Composed with that FIR it
    is :func:`fengine_dit_reference` with f32 operands, bit for bit."""
    return _dit_dft(plane, rotc, rots, n1, n2, lambda t: t)


@functools.lru_cache(maxsize=16)
def _dit_d2h(n1: int, n2: int, device: str) -> torch.Tensor:
    """The f32 N2-point matrix in NH halves of k2, each transposed: ``[NH,
    N2, 2·N2/NH]``, half ``h`` row ``n2`` the cos of the half's k2, then the
    -sin (the stage-B operand of K7's f32 DFT pass and of its f32 stage B;
    the matrices are symmetric). NH = 2, or 1 at N2 = 4, where a thread's 4
    k2 are all of them."""
    k = dit_constants(n1, n2, device)
    nh = 1 if n2 < 8 else 2
    h = n2 // nh
    return torch.stack([torch.cat([k.d2c[:, i * h:(i + 1) * h], k.d2s[:, i * h:(i + 1) * h]],
                                  dim=1) for i in range(nh)]).contiguous()


def _dit_dft_f32_pass(plane, rotc, rots, outr, outi, *, n1, n2) -> None:
    """K7's f32 DFT pass from ``plane`` into ``outr``/``outi`` (CUDA tensors,
    checked by the caller, on a split :func:`_dit_body` gives
    ``"two_pass_f32"``)."""
    if plane.data_ptr() % 16:
        plane = plane.clone()  # the kernel copies plane rows in 16-byte pieces
    rotc, rots = (r.clone() if r.data_ptr() % 8 else r for r in (rotc, rots))  # read as float2
    batch, n_spectra, _ = plane.shape
    dev = plane.device
    k = dit_constants(n1, n2, str(dev))
    lib = _build.library()
    err = lib.dit_dft_f32_launch(
        plane.data_ptr(), k.d1c.data_ptr(), k.d1s.data_ptr(), _dit_d2h(n1, n2, str(dev)).data_ptr(),
        k.twc.data_ptr(), k.tws.data_ptr(), k.untc.data_ptr(), k.unts.data_ptr(),
        rotc.data_ptr(), rots.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n1, n2, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == _NO_PLAN:
        raise _no_plan("dit_dft_f32", n1, n2, "an 8-row stage-A tile of 2·N2 f32 columns")
    _build.check(lib, err, "dit_dft_f32")
    dit_dft_f32.launches += 1


def dit_dft_f32(
    plane: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's DFT pass alone, f32 operands: ``plane`` ``[B, S, fft]`` f32 to
    int8 ``(qr, qi)`` ``[B, S, N]`` (the kernel on CUDA,
    :func:`dit_dft_f32_reference` on CPU)."""
    if plane.device.type == "cpu":
        return dit_dft_f32_reference(plane, rotc, rots, n1=n1, n2=n2)
    if plane.device.type != "cuda":
        raise ValueError(f"dit_dft_f32: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != 2 * n1 * n2 or _dit_body(n1, n2, "float32") != "two_pass_f32":
        raise ValueError(f"dit_dft_f32: the pass takes fft = 2*N1*N2 with a plan (N2 <= 512), "
                         f"got {n1}, {n2}, {fft}")
    _check("dit_dft_f32", plane, (
        ("plane", plane, torch.float32, None),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    ))
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=plane.device)
    outi = torch.empty_like(outr)
    _dit_dft_f32_pass(plane, rotc, rots, outr, outi, n1=n1, n2=n2)
    return outr, outi


#: Launches of K7's f32 DFT pass since the last reset (the plain version never
#: counts); a two-pass f32 K7 call adds one per group of streams.
dit_dft_f32.launches = 0


def dit_dft_f32_attributes(n1: int, n2: int) -> dict:
    """The card's view of K7's f32 DFT-pass body at N1 x N2
    (``cudaFuncGetAttributes`` and the plan): registers and local (spill)
    bytes a thread, KC, SB (spectra a unit), the stage-B K-tile depth, ring
    stages, shared-memory bytes and threads a block."""
    out = (ctypes.c_int * 8)()
    lib = _build.library()
    err = lib.dit_dft_f32_attributes(n1, n2, out)
    if err == _NO_PLAN:
        raise _no_plan("dit_dft_f32", n1, n2, "an 8-row stage-A tile of 2·N2 f32 columns")
    _build.check(lib, err, "dit_dft_f32_attributes")
    return dict(zip(("regs", "local_bytes", "kc", "sb", "ktb", "stages", "smem_bytes",
                     "threads"), out))


@functools.lru_cache(maxsize=16)
def _dit_tw2(n1: int, n2: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's f32 twiddles with each column doubled, ``[N1, 2·N2]``: columns
    2·n2 and 2·n2 + 1 both hold exp(-2πi·k1·n2/N), so K1's stage A on the
    plane's ``[N1, 2·N2]`` view applies one twiddle to both streams of an
    n2."""
    k = dit_constants(n1, n2, device)
    return tuple(t.repeat_interleave(2, dim=1).contiguous() for t in (k.twc, k.tws))


def dit_stage_a_reference(
    plane: torch.Tensor, *, n1: int, n2: int, dft_dtype: str = "bfloat16"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's three-pass stage A: the FIR plane ``[B, S,
    fft]`` (:func:`k1_fir_reference` of the frames viewed ``[B,
    n_frames·fft]`` with zero starts) to T re and im ``[B, S, N1, 2·N2]``,
    column ``2·n2 + q`` stream q's (q = 0 even, 1 odd): each stream's stage
    A and twiddle rounded to the operand type (bf16 tensors, or f32), as
    :func:`dit_dft_reference` rounds them."""
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    batch, n_spectra, _ = plane.shape
    even, odd = _dit_streams_a(plane.to(torch.float32), n1, n2, rnd)
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    return tuple(torch.stack([e, o], dim=-1).reshape(batch, n_spectra, n1, 2 * n2).to(dtype)
                 for e, o in zip(even, odd))


def dit_stage_b_reference(
    tr: torch.Tensor,
    ti: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n1: int,
    n2: int,
    dft_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's three-pass stage B: T re and im ``[B, S, N1,
    2·N2]`` (as :func:`dit_stage_a_reference` gives them) and
    ``rotc``/``rots`` ``[B, N]`` to int8 ``(qr, qi)`` ``[B, S, N]``: each
    stream's stage B, the combine, the rotation and the requant. Composed
    with that stage A it is :func:`dit_dft_reference` (bf16) or
    :func:`dit_dft_f32_reference` (f32), bit for bit."""
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    tr, ti = (t.to(torch.float32) for t in (tr, ti))
    even, odd = (tuple(t[..., q::2].contiguous() for t in (tr, ti)) for q in (0, 1))
    return _dit_streams_b(even, odd, rotc, rots, n1, n2, rnd)


def _dit_t_layout(n1: int, n2: int, dtype: torch.dtype) -> tuple[int, ...]:
    """A spectrum's T planes as K7's three-pass kernels keep them: ``(2, N1,
    N2)`` in bf16, each stream's plane (stage B reads T rows of k1 as wgmma's
    K-major operand); ``(2·N2, N1)`` in f32, row ``2·n2 + q`` (the FFMA stage
    B reads 4 k1 of an n2 at once)."""
    return (2, n1, n2) if dtype == torch.bfloat16 else (2 * n2, n1)


def _dit_planes(t: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """bf16 T ``[B, S, N1, 2·N2]`` (column ``2·n2 + q`` stream q's n2) as
    each stream's plane, ``[B, S, 2, N1, N2]`` (a copy)."""
    return t.reshape(*t.shape[:2], n1, n2, 2).permute(0, 1, 4, 2, 3).contiguous()


def _dit_interleaved(t: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """The stream planes ``[B, S, 2, N1, N2]`` back as ``[B, S, N1, 2·N2]``
    (a copy): :func:`_dit_planes` undone."""
    return t.permute(0, 1, 3, 4, 2).reshape(*t.shape[:2], n1, 2 * n2)


def _dit_stage_a_pass(plane, tr, ti, *, n1, n2) -> None:
    """K7's stage A from ``plane`` ``[G, S, fft]`` into ``tr``/``ti`` (CUDA
    tensors of the operand type laid out as :func:`_dit_t_layout` says,
    16-byte aligned, checked by the caller): K1's stage-A body on the ``[N1,
    2·N2]`` view with the column-doubled twiddles (:func:`_dit_tw2`), its
    bf16 form storing each stream's plane; counted on :func:`dit_stage_a` or
    :func:`dit_stage_a_f32`."""
    f32 = plane.dtype == torch.float32
    dev = str(plane.device)
    if f32:
        k = dit_constants(n1, n2, dev)
        d1c, d1s = k.d1c, k.d1s
    else:
        d1c, d1s = _dit_bf16(n1, n2, dev)[:2]
    twc, tws = _dit_tw2(n1, n2, dev)
    what = "k1_stage_a_f32_launch" if f32 else "dit_stage_a_launch"
    _stage_call(what, n1, 2 * n2, plane.data_ptr(), d1c.data_ptr(), d1s.data_ptr(),
                twc.data_ptr(), tws.data_ptr(), tr.data_ptr(), ti.data_ptr(),
                plane.shape[0] * plane.shape[1], n1, 2 * n2,
                torch.cuda.current_stream(plane.device).cuda_stream)
    (dit_stage_a_f32 if f32 else dit_stage_a).launches += 1


def _dit_stage_b_pass(tr, ti, rotc, rots, outr, outi, *, n1, n2) -> None:
    """K7's stage B from ``tr``/``ti`` (as :func:`_dit_stage_a_pass` writes
    them) into ``outr``/``outi`` ``[G, S, N]`` (CUDA tensors, T and the
    outputs 16-byte aligned, checked by the caller); counted on
    :func:`dit_stage_b` or :func:`dit_stage_b_f32`."""
    f32 = tr.dtype == torch.float32
    rotc, rots = (_aligned(r) for r in (rotc, rots))  # TMA boxes (bf16), float2 reads (f32)
    dev = str(tr.device)
    k = dit_constants(n1, n2, dev)
    d2 = (_dit_d2h(n1, n2, dev),) if f32 else _dit_bf16(n1, n2, dev)[2:]
    what = "dit_stage_b_f32_launch" if f32 else "dit_stage_b_launch"
    _stage_call(what, n1, n2, tr.data_ptr(), ti.data_ptr(), *(t.data_ptr() for t in d2),
                k.untc.data_ptr(), k.unts.data_ptr(), rotc.data_ptr(), rots.data_ptr(),
                outr.data_ptr(), outi.data_ptr(), tr.shape[0], tr.shape[1], n1, n2,
                torch.cuda.current_stream(tr.device).cuda_stream)
    (dit_stage_b_f32 if f32 else dit_stage_b).launches += 1


def _dit_stage_a_call(what, plane, n1, n2, dft_dtype):
    if plane.device.type == "cpu":
        return dit_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)
    if plane.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {plane.device}")
    batch, n_spectra, fft = plane.shape
    if fft != 2 * n1 * n2 or _dit_body(n1, n2, dft_dtype) != "three_pass" + (
            "" if dft_dtype == "bfloat16" else "_f32"):
        raise ValueError(f"{what}: the stage takes fft = 2*N1*N2 on the three-pass route, got "
                         f"{n1}, {n2}, {fft}")
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    _check(what, plane, (("plane", plane, dtype, None),))
    tr, ti = (torch.empty((batch, n_spectra, *_dit_t_layout(n1, n2, dtype)), dtype=dtype,
                          device=plane.device) for _ in range(2))
    _dit_stage_a_pass(_aligned(plane), tr, ti, n1=n1, n2=n2)
    if dtype == torch.float32:
        return tr.transpose(-1, -2), ti.transpose(-1, -2)  # views [B, S, N1, 2·N2]
    return _dit_interleaved(tr, n1, n2), _dit_interleaved(ti, n1, n2)


def _dit_stage_b_call(what, tr, ti, rotc, rots, n1, n2, dft_dtype):
    if tr.device.type == "cpu":
        return dit_stage_b_reference(tr, ti, rotc, rots, n1=n1, n2=n2, dft_dtype=dft_dtype)
    if tr.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {tr.device}")
    batch, n_spectra = tr.shape[:2]
    n = n1 * n2
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    for name, t in (("tr", tr), ("ti", ti)):
        if tuple(t.shape) != (batch, n_spectra, n1, 2 * n2):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{(batch, n_spectra, n1, 2 * n2)}")
    if dtype == torch.float32:  # the kernel reads T transposed
        tr, ti = (t.transpose(-1, -2).contiguous() for t in (tr, ti))
    else:  # and in bf16 as each stream's plane
        tr, ti = _dit_planes(tr, n1, n2), _dit_planes(ti, n1, n2)
    layout = (batch, n_spectra, *_dit_t_layout(n1, n2, dtype))
    _check(what, tr, (
        ("tr", tr, dtype, layout),
        ("ti", ti, dtype, layout),
        ("rotc", rotc, torch.float32, (batch, n)),
        ("rots", rots, torch.float32, (batch, n)),
    ))
    outr = torch.empty((batch, n_spectra, n), dtype=torch.int8, device=tr.device)
    outi = torch.empty_like(outr)
    _dit_stage_b_pass(_aligned(tr), _aligned(ti), rotc, rots, outr, outi, n1=n1, n2=n2)
    return outr, outi


def dit_stage_a(plane: torch.Tensor, *, n1: int, n2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's three-pass stage A alone, bf16 operands: the bf16 FIR plane
    ``[B, S, fft]`` to bf16 T re and im ``[B, S, N1, 2·N2]`` (K1's
    ``k1_stage_a_wg_kernel`` on the ``[N1, 2·N2]`` view on CUDA, its
    stream planes gathered to this layout; :func:`dit_stage_a_reference` on
    CPU)."""
    return _dit_stage_a_call("dit_stage_a", plane, n1, n2, "bfloat16")


def dit_stage_a_f32(plane: torch.Tensor, *, n1: int, n2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's three-pass stage A alone, f32 operands (FFMA, exact f32): the f32
    plane to f32 T re and im ``[B, S, N1, 2·N2]`` (``k1_stage_a_f32_kernel``
    on CUDA, views of its transposed T; :func:`dit_stage_a_reference` with
    ``dft_dtype="float32"`` on CPU)."""
    return _dit_stage_a_call("dit_stage_a_f32", plane, n1, n2, "float32")


def dit_stage_b(
    tr: torch.Tensor, ti: torch.Tensor, rotc: torch.Tensor, rots: torch.Tensor, *, n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's three-pass stage B alone, bf16 operands: bf16 T re and im ``[B,
    S, N1, 2·N2]`` and ``rotc``/``rots`` ``[B, N]`` to int8 ``(qr, qi)``
    ``[B, S, N]`` (the kernel on CUDA, on T gathered into each stream's
    plane; :func:`dit_stage_b_reference` on CPU)."""
    return _dit_stage_b_call("dit_stage_b", tr, ti, rotc, rots, n1, n2, "bfloat16")


def dit_stage_b_f32(
    tr: torch.Tensor, ti: torch.Tensor, rotc: torch.Tensor, rots: torch.Tensor, *, n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's three-pass stage B alone, f32 operands (FFMA): f32 T re and im to
    int8 ``(qr, qi)`` (the kernel on CUDA, :func:`dit_stage_b_reference` with
    ``dft_dtype="float32"`` on CPU)."""
    return _dit_stage_b_call("dit_stage_b_f32", tr, ti, rotc, rots, n1, n2, "float32")


def dit_stage_attributes(n1: int, n2: int, dft_dtype: str = "bfloat16") -> dict:
    """The card's view of K7's three-pass stage bodies at N1 x N2
    (``cudaFuncGetAttributes`` and the tiling): ``{"a": ..., "b": ...}``,
    stage A K1's body at N1 x 2·N2 (in bf16 its stream-plane store), stage B
    K7's (tile rows k2, columns k1), each with :func:`k1_stage_attributes`'
    fields: registers and local (spill) bytes a thread, threads a block,
    shared-memory bytes, tile rows and columns, K depth a ring slot, ring
    slots and blocks an SM; the bf16 (wgmma) bodies also each sum's group
    depth in products and the bytes of a ring slot."""
    bf16 = dft_dtype == "bfloat16"
    sfx = "" if bf16 else "_f32"
    a = "dit_stage_a_attributes" if bf16 else "k1_stage_a_f32_attributes"
    return {"a": _stage_attributes(a, n1, 2 * n2, bf16),
            "b": _stage_attributes(f"dit_stage_b{sfx}_attributes", n1, n2, bf16)}


#: Launches of K7's three-pass stages since the last reset (the plain
#: versions never count); a three-pass K7 call adds one to each per group
#: of streams.
dit_stage_a.launches = 0
dit_stage_b.launches = 0
dit_stage_a_f32.launches = 0
dit_stage_b_f32.launches = 0


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
    body = _dit_body(n1, n2, dft_dtype)
    if window.data_ptr() % 16:
        window = window.clone()  # the FIR pass reads the window as float4
    dev = x.device
    n_spectra = n_frames - n_taps + 1
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.empty_like(outr)
    # K1's FIR pass on the frames as streams starting at 0, then the DFT pass
    # (or stage A and stage B through T) over groups of streams through one
    # scratch: the plane (bf16, or f32 for f32 operands), and on the
    # three-pass route T re and im beside it.
    f32 = body.endswith("_f32")
    three = body.startswith("three_pass")
    dtype = torch.float32 if f32 else torch.bfloat16
    group = _route_group(body, batch, n_spectra, fft)
    plane = torch.empty((group, n_spectra, fft), dtype=dtype, device=dev)
    if three:
        tr, ti = (torch.empty((group, n_spectra, *_dit_t_layout(n1, n2, dtype)), dtype=dtype,
                              device=dev) for _ in range(2))
    flat = x.view(batch, n_frames * fft)
    starts = torch.zeros(batch, dtype=torch.int64, device=dev)
    dft = _dit_dft_f32_pass if f32 else _dit_dft_pass
    for b0 in range(0, batch, group):
        b = slice(b0, min(batch, b0 + group))
        g = b.stop - b0
        _fir_pass(flat[b], starts[b], window, plane[:g])
        if three:
            _dit_stage_a_pass(plane[:g], tr[:g], ti[:g], n1=n1, n2=n2)
            _dit_stage_b_pass(tr[:g], ti[:g], rotc[b], rots[b], outr[b], outi[b], n1=n1, n2=n2)
        else:
            dft(plane[:g], rotc[b], rots[b], outr[b], outi[b], n1=n1, n2=n2)
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


#: K7 calls on the card since the last reset, one a call whichever route ran
#: (the plain CPU version never counts); the passes count on :func:`k1_fir`
#: or :func:`k1_fir_f32`, then :func:`dit_dft` or :func:`dit_dft_f32` (two
#: passes), or :func:`dit_stage_a` and :func:`dit_stage_b` (three; their
#: ``_f32`` forms for f32 operands).
fengine_dit.launches = 0

#: The probe P2's stops of K7 (bf16 operands), ``"full"`` K7 whole. The
#: first four are cuts of K1's FIR pass (its STOP numbers), ``"stagea"``
#: and ``"stageb"`` the FIR pass then K7's DFT pass cut at a stage (its STOP
#: numbers).
DIT_STOPS = {"dma": 5, "conv": 6, "fir": 7, "deint": 8, "stagea": 3, "stageb": 2, "full": 0}
_DIT_FIR_STOPS = ("dma", "conv", "fir", "deint")


def fengine_dit_ablate_reference(
    stop: str,
    frames: torch.Tensor,
    window: torch.Tensor,
    *,
    n1: int,
    n2: int,
    rot: tuple[torch.Tensor, torch.Tensor] | None = None,
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
    - ``"stageb"``: their stage-B re, ``k2·N1 + k1``;
    - ``"full"``: :func:`fengine_dit_reference` with ``rot`` = ``(rotc,
      rots)``.

    ``"deint"`` and ``"stagea"`` are each spectrum's own values, where the
    probe's sinks slice across the spectra of its scratch.
    """
    if stop not in DIT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    if stop == "full":
        if rot is None:
            raise ValueError("the 'full' stop needs rot=(rotc, rots)")
        return fengine_dit_reference(frames, window, *rot, n1=n1, n2=n2)
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
    rot: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (bf16 operands) cut after a stage on the route it runs, or whole
    (``stop="full"``, rotated by ``rot`` = ``(rotc, rots)`` ``[B, N]``): the
    kernels on CUDA, :func:`fengine_dit_ablate_reference` on CPU. ``frames``
    ``[B, n_frames, fft]`` int8, ``window`` ``[taps, fft]`` f32. ``"dma"``,
    ``"conv"``, ``"fir"`` and ``"deint"`` are cuts of K1's FIR pass on the
    frames viewed ``[B, n_frames·fft]`` with zero starts; ``"stagea"`` and
    ``"stageb"`` that FIR pass (into bf16 planes, over K7's groups of
    streams), then K7's DFT pass cut after the stage (its 64-row chunk plan:
    64 <= N1 <= 256, N2 <= 256); ``"full"`` K7's route whole
    (:func:`fengine_dit`)."""
    if stop not in DIT_STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    if (stop == "full") != (rot is not None):
        raise ValueError("rot=(rotc, rots) goes with the 'full' stop and no other")
    dev = frames.device
    if dev.type == "cpu":
        return fengine_dit_ablate_reference(stop, frames, window, n1=n1, n2=n2, rot=rot)
    if dev.type != "cuda":
        raise ValueError(f"fengine_dit_ablate: unsupported device {dev}")
    batch, n_frames, fft = frames.shape
    n_taps = window.shape[0]
    if fft != 2 * n1 * n2:
        raise ValueError(f"fengine_dit_ablate: fft {fft} != 2 * {n1} * {n2}")
    if stop == "conv" and n_taps < 2:
        raise ValueError("fengine_dit_ablate: the conv stop reads two frames (taps >= 2)")
    return _launch_dit_ablate(frames.contiguous(), window.contiguous(), n1=n1, n2=n2, stop=stop,
                              rot=rot)


def _launch_dit_ablate(frames, window, *, n1, n2, stop, rot):
    """P2's stop on the card (arguments checked by :func:`fengine_dit_ablate`)."""
    if stop == "full":
        outs = _launch_dit(frames, window, *(r.contiguous() for r in rot), n1=n1, n2=n2,
                           dft_dtype="bfloat16")
        fengine_dit_ablate.launches += 1
        return outs
    batch, n_frames, fft = frames.shape
    n_taps = window.shape[0]
    dev = frames.device
    _check("fengine_dit_ablate", frames, (
        ("frames", frames, torch.int8, None),
        ("window", window, torch.float32, (n_taps, fft)),
    ))
    if window.data_ptr() % 16:
        window = window.clone()  # the FIR pass reads the window as float4
    n_spectra = n_frames - n_taps + 1
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.empty_like(outr)
    flat = frames.view(batch, n_frames * fft)
    starts = torch.zeros(batch, dtype=torch.int64, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stop in _DIT_FIR_STOPS:
        err = lib.k1_fir_stop_launch(
            flat.data_ptr(), flat.stride(0), starts.data_ptr(), window.data_ptr(), None,
            outr.data_ptr(), outi.data_ptr(), batch, n_spectra, n_taps, fft,
            *_fir_plan(batch, n_spectra, n_taps, fft), DIT_STOPS[stop], 0, 0, 1, stream,
        )
        _build.check(lib, err, f"k1_fir stop {stop} (P2)")
    else:
        group = _plane_group(batch, n_spectra, fft)
        plane = torch.empty((group, n_spectra, fft), dtype=torch.bfloat16, device=dev)
        k = dit_constants(n1, n2, str(dev))
        kbf = _dit_bf16(n1, n2, str(dev))
        for b0 in range(0, batch, group):
            b = slice(b0, min(batch, b0 + group))
            g = b.stop - b0
            _fir_pass(flat[b], starts[b], window, plane[:g])
            err = lib.dit_dft_stop_launch(
                plane.data_ptr(), *(t.data_ptr() for t in kbf), k.twc.data_ptr(),
                k.tws.data_ptr(), outr[b].data_ptr(), outi[b].data_ptr(), g, n_spectra, n1, n2,
                DIT_STOPS[stop], stream,
            )
            if err == _NO_PLAN:
                raise _no_plan("fengine_dit_ablate", n1, n2,
                               "the stops take the 64-row chunk plan only")
            _build.check(lib, err, f"dit_dft stop {stop} (P2)")
    fengine_dit_ablate.launches += 1
    return outr, outi


#: Calls of P2's stops on the card since the last reset, one a call (their
#: passes also count on :func:`k1_fir`, and ``"full"``'s on K7's own).
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
    channel_offset: int = 0,
    n_channels_total: int | None = None,
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
    ``channel_offset`` / ``n_channels_total`` place the engine's channels in
    a channel-sharded band (the reference's absolute-channel bookkeeping):
    the fine-delay ramp of channel ``k`` is taken at ``k + channel_offset``
    over ``n_channels_total`` (default ``n_channels``); cached
    ``rot_planes`` carry it already.

    ``_ablate`` (the diagnostic stops, ``"dma"``, ``"fir"``, ``"stagea"`` or
    ``"stageb"``) cuts K1 after that stage, on the route its whole call takes,
    in either operand type and with or without the requant, and returns what
    :func:`fengine_ablate_reference` describes; a ``"dma"`` probe serves
    :data:`ABLATE_S_BLK` spectra. As the reference's, ``"dma"`` needs N1 <=
    N2 and the others N1 == N2 (:func:`_check_ablate`). On the DIT form
    ``"dma"`` runs K7 whole, as the reference's does (its DIT kernel takes no
    stop), and the other stops raise, as the reference's gate raises.
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
        _check_ablate(_ablate, n1, n2)
    if mode != "ct":
        # The reference's gates for the DIT form (fengine_pallas.py:1265-1376).
        for flag, what in ((rowed, "rowed input"), (coarse_delays is not None,
                           "in-kernel coarse delay"), (rot_planes is not None,
                           "rot_planes (cached fine-rotation planes)"),
                           (not quantise, "quantise=False")):
            if flag:
                raise ValueError(f"{what} needs the direct-CT form (deint={mode!r})")
        if _ablate not in (None, "dma"):
            raise ValueError(
                f"_ablate stage {_ablate!r} needs the direct-CT form with n1 == n2 "
                f"(deint={mode!r}), as the reference's gate does")
        *lead, n_frames, f = frames.shape
        if f != fft_size:
            raise ValueError(f"frame length {f} != fft_size {fft_size}")
        if n_frames < n_taps:
            raise ValueError("need at least n_taps frames of input")
        dev = frames.device
        rotc, rots = _rotation_planes(
            torch.as_tensor(frac_delay, dtype=torch.float32, device=dev).expand(lead),
            phase, n_channels, quant_scale, (n_channels,), channel_offset=channel_offset,
            n_channels_total=n_channels_total,
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
    if _ablate == "dma":
        _check_dma_frames(n_spectra, n_taps, n1, n2)
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
            channel_offset=channel_offset,
            n_channels_total=n_channels_total,
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


def p5_ablate(
    stop: str,
    x: torch.Tensor,
    starts: torch.Tensor,
    window: torch.Tensor,
    rotc: torch.Tensor,
    rots: torch.Tensor,
    *,
    n_spectra: int,
    n1: int,
    n2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe P5's stops (:data:`P5_STOPS`, ``benchmarks/ct_ablate.py``):
    K1 cut at ``stop`` on streams ``x`` ``[B, n_in]`` int8 with clamped
    ``starts`` ``[B]`` and ``rotc``/``rots`` ``[B, C]``, bf16 operands,
    quantised, on the two-pass route; the stop kernels on CUDA,
    :func:`fengine_ablate_reference` on CPU."""
    if stop not in P5_STOPS:
        raise ValueError(f"unknown P5 stage {stop!r}")
    _check_ablate(stop, n1, n2)
    if window.shape[1] != n1 * n2:
        raise ValueError(f"p5_ablate: fft {window.shape[1]} != N1*N2 = {n1}*{n2}")
    kw = dict(n_spectra=n_spectra, n1=n1, n2=n2, dft_dtype="bfloat16", quantise=True)
    if x.device.type == "cpu":
        return fengine_ablate_reference(stop, x, starts, window, rotc, rots, p5=True, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"p5_ablate: unsupported device {x.device}")
    return _launch(x, starts, window.contiguous(), rotc, rots, ablate=stop, p5=True, **kw)


#: Kernel launches since the last reset (the plain CPU version never counts).
fengine_fused.launches = 0
#: Launches of K1's stopped passes (``_ablate``) since the last reset.
fengine_fused.ablate_launches = 0
