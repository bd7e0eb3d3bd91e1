"""Polyphase FIR over aligned frames (counterpart of ``dpdk_dc_sand_tpu/ops/pfb_pallas.py``).

For a CUDA tensor :func:`pfb_fir_frames` launches the hand-written kernel
``csrc/pfb_fir.cu`` (K6); for a CPU tensor it runs
:func:`pfb_fir_reference`, the plain PyTorch version. Both compute, in f32
and in tap order with every product and sum rounded on its own,

    out[b, s, f] = (((x[b, s, f]·w[0, f] + x[b, s+1, f]·w[1, f]) + ...)

for ``s < n_frames - n_taps + 1``, so the kernel equals its plain version
bit for bit. Frames are int8 or f32. The kernel takes every ``fft_size``,
``n_spectra`` and ``n_taps``: the reference's ``fir_supported`` gate only
exists for Mosaic's tiling.
"""

from __future__ import annotations

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


def _launch(frames: torch.Tensor, window: torch.Tensor, n_spectra: int) -> torch.Tensor:
    batch, n_frames, fft = frames.shape
    n_taps = window.shape[0]
    if window.dtype != torch.float32 or window.device != frames.device:
        raise ValueError(f"pfb_fir_frames: window must be float32 on {frames.device}")
    if not frames.is_contiguous() or not window.is_contiguous():
        raise ValueError("pfb_fir_frames: frames and window must be contiguous")
    # float4 / char4 loads need 16-byte rows of window and output and
    # aligned bases; anything else takes the kernel's scalar lane loads.
    elem = frames.element_size()
    vec = fft % 4 == 0 and frames.data_ptr() % (4 * elem) == 0 and window.data_ptr() % 16 == 0
    out = torch.empty((batch, n_spectra, fft), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    err = lib.pfb_fir_launch(
        frames.data_ptr(), window.data_ptr(), out.data_ptr(),
        batch, n_frames, fft, n_taps, int(frames.dtype == torch.float32), int(vec),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(lib, err, "pfb_fir")
    pfb_fir_frames.launches += 1
    return out


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
