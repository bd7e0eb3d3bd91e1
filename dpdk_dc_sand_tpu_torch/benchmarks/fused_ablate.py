"""P2: stage ablation of K7, the DIT F kernel, at fft 65536 (``benchmarks/
fused_ablate.py`` of the JAX package, whose trimmed copy of ``_fengine_kernel``
reaches ``pl.pallas_call`` at its line 198).

Each stop is K7 cut after a stage at compile time (``fengine_dit_ablate``,
``csrc/fengine_dit.cu``), timed by the chained marginal (:mod:`._chain`):

- ``dma``    : each block's input bytes loaded, a constant written;
- ``conv``   : + their int8 -> f32 conversion;
- ``fir``    : + the 16-tap FIR, once a sample;
- ``deint``  : + the bf16 rounding and the even / odd split;
- ``stagea`` : K7's chunk loop with stage A and the twiddle (its per-chunk
  FIR recomputation included);
- ``stageb`` : + stage B;
- ``full``   : + the DIT combine and requant: K7 itself, with rotation
  planes 1/16 and 0 (the probe's ``* (1 / 16)`` and no fine delay).

The probe's ``deint`` and ``stagea`` slice across the spectra of its
``[N1, s_blk·N2]`` scratch; a block of K7 holds one spectrum, so these two
stops write that spectrum's own ``[N1, N2]`` values, row-major, into its
``[N2, N1]``-shaped output, and are held against the port's plain version
only. The geometry is the probe's: N = 32768 = 256·128, 16 taps, int8 frames
and a standard-normal window made on the card from a seed.

Run: python -m dpdk_dc_sand_tpu_torch.benchmarks.fused_ablate [S]
"""

from __future__ import annotations

import sys

import torch

from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

A, P, TAPS, FFT = 80, 2, 16, 65536
N1, N2 = 256, 128
STOPS = ("dma", "conv", "fir", "deint", "stagea", "stageb", "full")


def make_inputs(S: int, device=None, seed: int = 0, batch: int = A * P) -> dict:
    """The probe's frames ``[batch, S + 15, FFT]`` and window."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fr = torch.randint(-64, 64, (batch, S + TAPS - 1, FFT), dtype=torch.int8, device=dev,
                       generator=gen)
    win = torch.randn((TAPS, FFT), device=dev, generator=gen)
    rc = torch.full((batch, FFT // 2), 1 / 16, device=dev)
    return dict(fr=fr, win=win, rot=(rc, torch.zeros_like(rc)))


def call(stop: str, inp: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the stop: int8 ``(outr, outi)`` ``[batch, S, 32768]``."""
    if stop == "full":
        return ff.fengine_dit(inp["fr"], inp["win"], *inp["rot"], n1=N1, n2=N2)
    return ff.fengine_dit_ablate(inp["fr"], inp["win"], n1=N1, n2=N2, stop=stop)


def reference(stop: str, inp: dict, streams: int | None = None):
    """The plain version of the stop on the first ``streams`` streams."""
    fr = inp["fr"][:streams]
    if stop == "full":
        rc, rs = (r[:streams] for r in inp["rot"])
        return ff.fengine_dit_reference(fr, inp["win"], rc, rs, n1=N1, n2=N2)
    return ff.fengine_dit_ablate_reference(stop, fr, inp["win"], n1=N1, n2=N2)


def run_variant(stop_after: str, S: int, s_blk: int, device=None, inp: dict | None = None,
                batch: int = A * P):
    """Time one stop (printing the probe's line); returns ms per call."""
    if s_blk != ff.ABLATE_S_BLK:
        raise ValueError(f"the stops serve blocks of {ff.ABLATE_S_BLK} spectra, not {s_blk}")
    if stop_after not in STOPS:
        raise ValueError(f"unknown stage {stop_after!r}")
    inp = make_inputs(S, device, batch=batch) if inp is None else inp
    per, warm = marginal_ms(lambda: call(stop_after, inp), inp["fr"])
    samples = inp["fr"].shape[0] * S * FFT
    print(f"S={S:3d} s_blk={s_blk:2d} {stop_after:7s}: {per:7.2f} ms "
          f"({samples / per / 1e6:6.2f} Gs/s) [compile {warm / 1e3:.0f}s]", flush=True)
    return per


def main(argv):
    S = int(argv[0]) if argv else 64
    stages = argv[1:] or STOPS
    for stop in stages:
        try:
            run_variant(stop, S, 16)
        except Exception as e:
            print(f"{stop}: FAILED {type(e).__name__}: {str(e)[:120]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
