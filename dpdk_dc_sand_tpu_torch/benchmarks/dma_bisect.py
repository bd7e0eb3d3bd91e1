"""P4: the DMA stop of K1 from three input layouts (``benchmarks/dma_bisect.py``
of the JAX package, whose trimmed DMA-stop kernel reaches ``pl.pallas_call``
at its line 113).

The probe is P5's ``dma`` stop (:mod:`.ct_ablate`); here it is the same
kernel, K1's FIR pass cut at the DMA stage (``fengine_fused(_ablate="dma")``,
``csrc/fengine_ct.cu``), fed three ways:

- ``v0``    : frames made ``[batch, rows, N2]`` (the wire-rowed view);
- ``v4d``   : frames made ``[A, P, nf, FFT]``; the wrapper's reshape to
  ``[batch, rows·N2]`` is a view on the card (on the TPU it materialised a
  relayout, which this variant was written to find);
- ``vwrap`` : ``[batch, nf, FFT]`` frames through the production arguments
  (the PFB window, fine delays, quant 1/16), as the probe's wrapper call.

Run: python -m dpdk_dc_sand_tpu_torch.benchmarks.dma_bisect [S]
"""

from __future__ import annotations

import math
import sys

import torch

from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

A, P, FFT, TAPS = 80, 2, 65536, 16
N1 = N2 = 256
VARIANTS = ("v0", "v4d", "vwrap")


def make_variant(S: int, name: str, device=None, seed: int = 7):
    """``(call, frames)``: one call of the variant and the frames it reads."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_frames = S + TAPS - 1
    batch = A * P

    def randint(shape):
        return torch.randint(-64, 64, shape, dtype=torch.int8, device=dev, generator=gen)

    if name in ("v0", "v4d"):
        # v4d's [A, P, nf, FFT] frames reach the kernel through the wrapper's
        # reshape to [batch, nf*FFT]: a view of the same bytes on the card.
        fr = randint((batch, n_frames * N1, N2) if name == "v0" else (A, P, n_frames, FFT))
        win = torch.randn((TAPS, FFT), device=dev, generator=gen)
        rot = tuple(torch.randn((batch, N2 // 2, N1), device=dev, generator=gen) for _ in "cs")
        zero = torch.zeros(fr.shape[:-2], device=dev)
        return (lambda: ff.fengine_fused(fr, win, zero, zero, n_channels=FFT // 2,
                                         quant_scale=1.0, rowed=name == "v0", rot_planes=rot,
                                         _ablate="dma")), fr
    if name == "vwrap":
        fr = randint((batch, n_frames, FFT))
        win = default_window(TAPS, FFT, device=dev)
        fd = torch.rand(batch, device=dev, generator=gen) - 0.5
        ph = -math.pi * fd / 2
        return (lambda: ff.fengine_fused(fr, win, fd, ph, n_channels=FFT // 2,
                                         quant_scale=1 / 16.0, _ablate="dma")), fr
    raise ValueError(f"unknown variant {name}")


def reference(frames: torch.Tensor):
    """The plain DMA stop of any variant's frames (all streams)."""
    batch = math.prod(frames.shape[:-2]) if frames.shape[-1] == N2 else A * P
    x = frames.reshape(batch, -1)
    s = x.shape[1] // FFT - TAPS + 1
    zero = torch.zeros(batch, dtype=torch.int64, device=x.device)
    return ff.fengine_ablate_reference("dma", x, zero, torch.zeros((TAPS, FFT)), None, None,
                                       n_spectra=s, n1=N1, n2=N2)


def run(S: int, name: str, device=None):
    """Time one variant (printing the probe's line); returns ms per call."""
    call, fr = make_variant(S, name, device)
    per, warm = marginal_ms(call, fr)
    samples = A * P * S * FFT
    print(f"S={S} {name:6s}: {per:7.2f} ms ({samples / per / 1e6:6.2f} Gs/s)"
          f" [compile {warm / 1e3:.0f}s]", flush=True)
    return per


def main(argv):
    S = int(argv[0]) if argv else 128
    for name in (argv[1:] or VARIANTS):
        try:
            run(S, name)
        except Exception as e:
            print(f"{name}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
