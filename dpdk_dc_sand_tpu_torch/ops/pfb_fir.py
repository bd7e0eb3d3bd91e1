"""Polyphase FIR over aligned frames (counterpart of ``dpdk_dc_sand_tpu/ops/pfb_pallas.py``).

For a CUDA tensor :func:`pfb_fir_frames` launches the hand-written kernel
``csrc/pfb_fir.cu`` (K6); for a CPU tensor it runs
:func:`pfb_fir_reference`, the plain PyTorch version. Both compute, in f32
and in tap order with every product and sum rounded on its own,

    out[b, s, f] = (((x[b, s, f]·w[0, f] + x[b, s+1, f]·w[1, f]) + ...)

for ``s < n_frames - n_taps + 1``, so the kernel equals its plain version
bit for bit. Frames are int8 or f32. The kernel takes every ``fft_size``,
``n_spectra`` and ``n_taps`` that its grid can cover: the reference's
``fir_supported`` gate only exists for Mosaic's tiling. :func:`_fir_plan`
picks how the frame rows reach the kernel's shared-memory ring
(``cp.async`` or element loads, by ``fft`` and the base's alignment) and
splits the taps into passes of at most 16, one launch each; the kernel
checks each pass, and a shape with no plan raises ``ValueError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from dpdk_dc_sand_tpu_torch import _build

_DTYPES = (torch.int8, torch.float32)


def pfb_fir_reference(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: ``[B, n_frames, F]`` -> ``[B, S, F]`` f32.

    One product and one sum per tap, each a separate rounded f32 op, in
    place on two ``[B, S, F]`` buffers (so the flagship's 10.7 GB output
    needs one more such buffer, not ``n_taps``).
    """
    n_taps = window.shape[0]
    n_spectra = frames.shape[-2] - n_taps + 1
    w = window.to(torch.float32)
    out = frames[..., 0:n_spectra, :].to(torch.float32, copy=True)
    out.mul_(w[0])
    tmp = torch.empty_like(out)
    for tap in range(1, n_taps):
        tmp.copy_(frames[..., tap : tap + n_spectra, :])
        out.add_(tmp.mul_(w[tap]))
    return out


#: The most taps a pass of K6 takes: its deepest register ring.
PASS_TAPS = 16
#: How each copy mode is numbered in ``pfb_fir_launch``.
COPY_MODES = ("async", "scalar")
_INT_MAX = 2**31 - 1


@dataclass(frozen=True)
class FirPlan:
    """How K6 runs one shape: the copy mode that fills its shared-memory
    ring, and its passes as ``(first tap, taps, register-ring depth)``, one
    launch each."""

    copy: str
    passes: tuple[tuple[int, int, int], ...]


def _fir_plan(fft: int, n_taps: int, elem_bytes: int, base_align: int, *,
              n_spectra: int = 1) -> FirPlan:
    """Plan K6 for ``[..., n_spectra + n_taps - 1, fft]`` frames of
    ``elem_bytes`` (1: int8, 4: f32) whose base is ``base_align``-byte
    aligned (a power of two; 16 or more counts as 16).

    The copy mode: ``"async"`` (each thread's 4 lanes of a row by one
    ``cp.async``: 4 bytes of int8, 16 of f32) where ``fft % 4 == 0`` and the
    base is aligned to 4 elements; ``"scalar"`` element loads otherwise.
    The passes: at most ``PASS_TAPS`` taps each, in order, a pass after the
    first adding its taps to the sum the one before stored, each through the
    smallest register ring (4, 8 or 16 rows) that holds its taps. The kernel
    launches exactly these passes and refuses one that does not fit its
    pointers. Raises ``ValueError`` where no plan exists.
    """
    if elem_bytes not in (1, 4):
        raise ValueError(f"K6 takes int8 or f32 frames, not {elem_bytes}-byte elements")
    if not (1 <= fft <= _INT_MAX and n_taps >= 1 and n_spectra >= 1):
        raise ValueError(f"K6 has no plan for fft {fft}, {n_taps} taps, {n_spectra} spectra")
    if n_spectra + n_taps - 1 > _INT_MAX:
        raise ValueError(f"K6 has no plan for {n_spectra + n_taps - 1} frames")
    copy = "async" if fft % 4 == 0 and min(16, base_align) >= 4 * elem_bytes else "scalar"
    passes = []
    for t0 in range(0, n_taps, PASS_TAPS):
        taps = min(PASS_TAPS, n_taps - t0)
        passes.append((t0, taps, next(d for d in (4, 8, 16) if taps <= d)))
    return FirPlan(copy, tuple(passes))


def _launch(frames: torch.Tensor, window: torch.Tensor, n_spectra: int) -> torch.Tensor:
    batch, n_frames, fft = frames.shape
    n_taps = window.shape[0]
    if window.dtype != torch.float32 or window.device != frames.device:
        raise ValueError(f"pfb_fir_frames: window must be float32 on {frames.device}")
    if not frames.is_contiguous() or not window.is_contiguous():
        raise ValueError("pfb_fir_frames: frames and window must be contiguous")
    if window.data_ptr() % 16:  # a view into a larger buffer: give it its own
        window = window.clone()
    plan = _fir_plan(fft, n_taps, frames.element_size(), math.gcd(frames.data_ptr(), 16),
                     n_spectra=n_spectra)
    out = torch.empty((batch, n_spectra, fft), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    for tap0, taps, depth in plan.passes:
        err = lib.pfb_fir_launch(
            frames.data_ptr(), window.data_ptr(), out.data_ptr(),
            batch, n_frames, fft, n_spectra, tap0, taps, depth,
            int(frames.dtype == torch.float32), COPY_MODES.index(plan.copy), stream,
        )
        _build.check(lib, err, "pfb_fir")
    pfb_fir_frames.launches += 1
    return out


def kernel_attributes(ring_depth: int, in_f32: bool, copy: str) -> dict:
    """``cudaFuncGetAttributes`` of K6's body for a pass of ``ring_depth``
    (4, 8 or 16) register-ring rows: registers, local (spill) bytes and the
    most threads a block. Needs the card."""
    import ctypes

    lib = _build.library()
    regs, local, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.pfb_fir_attributes(ring_depth, int(in_f32), COPY_MODES.index(copy),
                                 ctypes.byref(regs), ctypes.byref(local), ctypes.byref(threads))
    _build.check(lib, err, "pfb_fir_attributes")
    return dict(regs=regs.value, local_bytes=local.value, max_threads=threads.value)


def pfb_fir_frames(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Polyphase FIR (K6 on CUDA, plain on CPU).

    ``frames`` ``[..., n_frames, fft_size]`` int8 or f32, ``window``
    ``[n_taps, fft_size]``; returns ``[..., n_frames - n_taps + 1,
    fft_size]`` f32.
    """
    n_taps, fft = window.shape
    *lead, n_frames, f = frames.shape
    if f != fft:
        raise ValueError(f"frame length {f} != window length {fft}")
    if frames.dtype not in _DTYPES:
        raise ValueError(f"pfb_fir_frames: frames must be int8 or float32, got {frames.dtype}")
    n_spectra = n_frames - n_taps + 1
    if n_spectra < 1:
        raise ValueError("need at least n_taps frames of input")
    dev = frames.device
    x = frames.reshape(-1, n_frames, fft)
    if dev.type == "cuda":
        out = _launch(x.contiguous(), window.to(device=dev, dtype=torch.float32).contiguous(),
                      n_spectra)
    elif dev.type == "cpu":
        out = pfb_fir_reference(x, window)
    else:
        raise ValueError(f"pfb_fir_frames: unsupported device {dev}")
    return out.reshape(*lead, n_spectra, fft)


#: Kernel launches since the last reset (the plain CPU version never counts).
pfb_fir_frames.launches = 0
