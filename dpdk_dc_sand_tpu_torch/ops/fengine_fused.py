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
   ``rint``, clip to ±127, int8.

Products of bf16 values are exact in f32, so the bf16 mode differs from the
reference only by the order of f32 additions.
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
#: Largest fft the kernel's shared-memory plan takes (a bf16 [N1, N2] plane
#: of 128 KB plus staging fits the 227 KB a block may use).
MAX_KERNEL_FFT = 65536


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


def _ct_split_or_raise(fft_size: int) -> tuple[int, int]:
    ct = _split_ct(fft_size)
    if ct is None or fft_size & (fft_size - 1):
        raise NotImplementedError(
            f"fft_size {fft_size} has no direct-CT split; the reference's DIT "
            "kernel (fengine_pallas._fengine_kernel, K7) that covers it is "
            "not ported yet (see ROADMAP.md)"
        )
    return ct


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
    """bf16 (round-to-nearest-even) copies of d1c, d1s, d2 for the kernel's
    tensor-core body."""
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
    n1, n2 = _ct_split_or_raise(2 * n_channels)
    fd = torch.as_tensor(frac_delay, dtype=torch.float32)
    ph = torch.as_tensor(phase, dtype=torch.float32, device=fd.device)
    lead = tuple(fd.shape)
    fd = fd.reshape(*lead, 1, 1)
    ph = ph.expand(lead).reshape(*lead, 1, 1)
    k = torch.arange(n_channels, dtype=torch.float32, device=fd.device).reshape(n2 // 2, n1)
    rot = -math.pi * fd * (k - n_channels / 2.0) / n_channels + ph
    return torch.cos(rot) * quant_scale, torch.sin(rot) * quant_scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    # A bf16 matmul would round its OUTPUT to bf16 as well; round the
    # operand only, then compute in f32.
    return x.to(torch.bfloat16).to(torch.float32)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, at K1's rounding points.

    ``x`` ``[B, n_in]`` int8 streams, ``starts`` ``[B]`` window starts
    (already clamped), ``window`` ``[taps, fft]`` f32, ``rotc``/``rots``
    ``[B, C]``. Returns int8 ``(qr, qi)`` ``[B, n_spectra, C]``.
    """
    n_taps, fft = window.shape
    batch = x.shape[0]
    c = fft // 2
    length = (n_spectra + n_taps - 1) * fft
    xs = torch.stack([x[b, s : s + length] for b, s in enumerate(starts.tolist())])
    frames = xs.reshape(batch, -1, fft).to(torch.float32)
    w = window.to(torch.float32)
    acc = frames[:, 0:n_spectra] * w[0]
    for tap in range(1, n_taps):
        acc = acc + frames[:, tap : tap + n_spectra] * w[tap]
    rnd = _round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    k = dft_constants(n1, n2, str(x.device))
    xm = rnd(acc).reshape(batch, n_spectra, n1, n2)
    ar = torch.matmul(rnd(k.d1c), xm)
    ai = torch.matmul(rnd(k.d1s), xm)
    tr = rnd(ar * k.twc - ai * k.tws)
    ti = rnd(ar * k.tws + ai * k.twc)
    d2 = rnd(k.d2)
    yr = torch.matmul(d2, tr.transpose(-1, -2))  # [B, S, N2, N1]
    yi = torch.matmul(d2, ti.transpose(-1, -2))
    h = n2 // 2
    re = (yr[..., :h, :] - yi[..., h:, :]).reshape(batch, n_spectra, c)
    im = (yi[..., :h, :] + yr[..., h:, :]).reshape(batch, n_spectra, c)
    rc = rotc.reshape(batch, 1, c)
    rs = rots.reshape(batch, 1, c)
    outr = re * rc - im * rs
    outi = re * rs + im * rc

    def q(v):
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)

    return q(outr), q(outi)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    n_taps, fft = window.shape
    if fft > MAX_KERNEL_FFT:
        raise NotImplementedError(
            f"fft_size {fft} > {MAX_KERNEL_FFT}: the K1 kernel's shared-memory "
            "plan does not cover it yet (see ROADMAP.md)"
        )
    batch = x.shape[0]
    want = (
        ("x", x, torch.int8, None),
        ("starts", starts, torch.int64, (batch,)),
        ("window", window, torch.float32, (n_taps, fft)),
        ("rotc", rotc, torch.float32, (batch, fft // 2)),
        ("rots", rots, torch.float32, (batch, fft // 2)),
    )
    for name, t, dtype, shape in want:
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fengine_fused: {name} must be contiguous {dtype} on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fengine_fused: {name} shape {tuple(t.shape)} != {shape}")
    if window.data_ptr() % 16:
        window = window.clone()  # the kernel reads the window as float4
    dev = x.device
    k = dft_constants(n1, n2, str(dev))
    kbf = _dft_bf16(n1, n2, str(dev))
    outr = torch.empty((batch, n_spectra, fft // 2), dtype=torch.int8, device=dev)
    outi = torch.empty_like(outr)
    lib = _build.library()
    err = lib.fengine_ct_launch(
        x.data_ptr(), x.stride(0), starts.data_ptr(),
        window.data_ptr(), k.d1c.data_ptr(), k.d1s.data_ptr(), k.d2.data_ptr(),
        k.twc.data_ptr(), k.tws.data_ptr(),
        rotc.data_ptr(), rots.data_ptr(),
        outr.data_ptr(), outi.data_ptr(),
        batch, n_spectra, n_taps, n1, n2, int(dft_dtype == "bfloat16"),
        *(t.data_ptr() for t in kbf),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "fengine_ct")
    fengine_fused.launches += 1
    return outr, outi


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """FIR + rDFT + fine delay + int8 requant (K1 on CUDA, plain on CPU).

    ``frames`` is one of (leading dims ``lead``, e.g. ``[A, P]``):

    - ``[*lead, n_frames, fft_size]`` aligned frames (no coarse delays);
    - ``[*lead, n_in]`` raw streams with ``coarse_delays`` (``lead``-shaped)
      and ``n_spectra``;
    - ``rowed=True``: the wire-rowed ``[*lead, rows, N2]`` view of either.

    The coarse delay is a per-batch window start, clamped as
    ``jax.lax.dynamic_slice`` clamps it. ``rot_planes`` are cached
    :func:`fine_rotation_planes` (else computed from ``frac_delay`` /
    ``phase``). Returns int8 ``(qr, qi)`` ``[*lead, n_spectra, n_channels]``.
    """
    if dft_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown dft_dtype {dft_dtype!r}")
    n_taps, fft_size = window.shape
    if n_channels != fft_size // 2:
        raise ValueError(f"n_channels {n_channels} != fft_size/2 {fft_size // 2}")
    n1, n2 = _ct_split_or_raise(fft_size)
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
    kw = dict(n_spectra=n_spectra, n1=n1, n2=n2, dft_dtype=dft_dtype)
    if dev.type == "cuda":
        qr, qi = _launch(x, starts, win.contiguous(), rotc, rots, **kw)
    elif dev.type == "cpu":
        qr, qi = fengine_fused_reference(x, starts, win, rotc, rots, **kw)
    else:
        raise ValueError(f"fengine_fused: unsupported device {dev}")
    shape = (*lead, n_spectra, n_channels)
    return qr.reshape(shape), qi.reshape(shape)


#: Kernel launches since the last reset (the plain CPU version never counts).
fengine_fused.launches = 0
