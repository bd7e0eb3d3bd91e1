"""P2: stage ablation of K7, the DIT F kernel, at fft 65536 (``benchmarks/
fused_ablate.py`` of the JAX package, whose trimmed copy of ``_fengine_kernel``
reaches ``pl.pallas_call`` at its line 198).

Each stop cuts the route K7 runs at this geometry (N = 32768 = 256·128:
K1's FIR pass, then K7's tensor-core DFT pass, ``csrc/fengine_dit.cu``) at
compile time, through ``fengine_dit_ablate``; each is timed by the chained
marginal (:mod:`._chain`):

- ``dma``    : K1's FIR pass with its loads alone (each input byte once), a
  probe written (``csrc/fengine_ct.cu``, ``STOP_DIT_DMA``);
- ``conv``   : + their int8 -> f32 conversion (``STOP_DIT_CONV``);
- ``fir``    : the FIR pass whole, its f32 sums' halves written
  (``STOP_DIT_FIR``, no plane);
- ``deint``  : + the bf16 rounding and the even / odd split
  (``STOP_DIT_DEINT``);
- ``stagea`` : the FIR pass into its bf16 plane, then the DFT pass with
  stage A and the twiddle alone, each stream's rounded T re written
  (``DFT_STAGEA_T``);
- ``stageb`` : + stage B, each stream's re written (``DFT_STAGEB``);
- ``full``   : + the DIT combine and requant: K7's two passes whole, with
  rotation planes 1/16 and 0 (the probe's ``* (1 / 16)`` and no fine
  delay).

The probe's ``deint`` and ``stagea`` slice across the spectra of its
``[N1, s_blk·N2]`` scratch; K7 keeps each spectrum apart, so these two
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
    rot = inp["rot"] if stop == "full" else None
    return ff.fengine_dit_ablate(inp["fr"], inp["win"], n1=N1, n2=N2, stop=stop, rot=rot)


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
