"""P5: stage ablation of K1 at the flagship's streams (``benchmarks/ct_ablate.py``
of the JAX package, whose trimmed copy of ``_fengine_kernel_ct`` reaches
``pl.pallas_call`` at its line 147).

Each stop is K1 itself cut after a stage at compile time
(``p5_ablate``, ``csrc/fengine_ct.cu``), timed by the
chained marginal (:mod:`._chain`):

- ``dma``    : the FIR pass's loads, a probe written: the input-stream floor;
- ``fir``    : + the 16-tap FIR, its bf16 plane written (the f32 sums'
  halves to the outputs, as the probe writes them);
- ``stagea`` : + the DFT pass's stage A and twiddle (T before its rounding);
- ``stageb`` : + stage B;
- ``full``   : + the fine delay and requant: K1, with the rotation planes
  divided by 16 (the probe's ``/ 16.0``, an exact power of two).

The data is made on the card from a seed: int8 frames ``[A*P, (S + 15)*256,
256]`` (the wire-rowed view of fft 65536), a standard-normal window and
rotation planes, as the probe makes them. A stop's blocks are 16 spectra
(``ABLATE_S_BLK``), the probe's ``s_blk``.

Run: python -m dpdk_dc_sand_tpu_torch.benchmarks.ct_ablate [S [stage ...]]
"""

from __future__ import annotations

import sys

import torch

from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

A, P, FFT, TAPS = 80, 2, 65536, 16
N1 = N2 = 256
STOPS = ("dma", "fir", "stagea", "stageb", "full")


def make_inputs(S: int, device=None, seed: int = 7, batch: int | None = None) -> dict:
    """The probe's inputs for ``batch`` (default A*P) streams of S spectra."""
    dev = resolve_device(device)
    batch = A * P if batch is None else batch
    gen = torch.Generator(device=dev).manual_seed(seed)
    fr = torch.randint(-64, 64, (batch, (S + TAPS - 1) * N1, N2), dtype=torch.int8,
                       device=dev, generator=gen)
    wina = torch.randn((TAPS, FFT), device=dev, generator=gen)
    rotc = torch.randn((batch, N2 // 2, N1), device=dev, generator=gen)
    rots = torch.randn((batch, N2 // 2, N1), device=dev, generator=gen)
    return dict(fr=fr, wina=wina, rot=(rotc, rots), rot16=(rotc / 16, rots / 16))


def _operands(stop: str, inp: dict, streams: slice = slice(None)):
    """The streams ``[b, n_in]``, their zero starts, the rotation planes ``[b,
    C]`` of the stop and the spectra a stream."""
    fr = inp["fr"][streams]
    b = fr.shape[0]
    x = fr.reshape(b, -1)
    rot = inp["rot16"] if stop == "full" else inp["rot"]
    rc, rs = (r[streams].reshape(b, -1) for r in rot)
    starts = torch.zeros(b, dtype=torch.int64, device=x.device)
    return x, starts, rc, rs, fr.shape[1] // N1 - TAPS + 1


def call(stop: str, inp: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the stop: int8 ``(outr, outi)`` ``[batch, S, 32768]``. The
    stops are P5's (``ff.P5_STOPS``: its fir writes the f32 FIR's two
    halves, its stagea T before the rounding), ``"full"`` K1 itself."""
    if stop not in STOPS:
        raise ValueError(f"unknown stage {stop!r}")
    if stop == "full":
        zero = torch.zeros(inp["fr"].shape[0], device=inp["fr"].device)
        return ff.fengine_fused(inp["fr"], inp["wina"], zero, zero, n_channels=FFT // 2,
                                quant_scale=1.0, rowed=True, rot_planes=inp["rot16"])
    x, starts, rc, rs, s = _operands(stop, inp)
    return ff.p5_ablate(stop, x, starts, inp["wina"], rc, rs, n_spectra=s, n1=N1, n2=N2)


def reference(stop: str, inp: dict, streams: slice = slice(None)):
    """The plain version of the stop on the streams ``streams``."""
    x, starts, rc, rs, s = _operands(stop, inp, streams)
    return ff.fengine_ablate_reference(None if stop == "full" else stop, x, starts, inp["wina"],
                                       rc, rs, n_spectra=s, n1=N1, n2=N2, p5=True)


def run_variant(stop_after: str, S: int, s_blk: int, device=None, inp: dict | None = None):
    """Time one stop (printing the probe's line); returns ms per call."""
    if s_blk != ff.ABLATE_S_BLK:
        raise ValueError(f"the stops serve blocks of {ff.ABLATE_S_BLK} spectra, not {s_blk}")
    inp = make_inputs(S, device) if inp is None else inp
    per, warm = marginal_ms(lambda: call(stop_after, inp), inp["fr"])
    samples = inp["fr"].shape[0] * S * FFT
    print(f"S={S:3d} s_blk={s_blk:2d} {stop_after:7s}: {per:7.2f} ms "
          f"({samples / per / 1e6:6.2f} Gs/s) [compile {warm / 1e3:.0f}s]", flush=True)
    return per


def main(argv):
    S = int(argv[0]) if argv else 32
    stages = argv[1:] or STOPS
    for stop in stages:
        try:
            run_variant(stop, S, 16)
        except Exception as e:
            print(f"{stop}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
