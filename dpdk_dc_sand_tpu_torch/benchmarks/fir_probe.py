"""P3: the FIR loop-order probe (``benchmarks/fir_probe.py`` of the JAX package,
whose kernel reaches ``pl.pallas_call`` at its line 78).

``out[j·N1 + r, c] = Σ_t x[(j + t)·N1 + r, c] · w[t·N1 + r, c]`` over J = 8
spectra and 16 taps, x bf16 and w f32, REPS passes on data that stays on
chip, in two loop orders (``csrc/fir_probe.cu``):

- ``persi``:    for j: for t: acc += x[j+t]·w[t] (16 window loads an output);
- ``tapouter``: for t: acc[j] += x[j+t]·w[t] for all j (one window load a tap);
- ``tapo2d``:   the probe's pre-tiled 2-D window form, which takes the
  ``tapouter`` branch of its kernel, so here the ``tapouter`` kernel.

Both orders add in tap order, so they equal the plain version
(:func:`fir_probe_reference`) bit for bit, the probe's serialising term
included (pass q adds pass q-1's ``out[0, 0]``).

Run: python -m dpdk_dc_sand_tpu_torch.benchmarks.fir_probe
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
from dpdk_dc_sand_tpu_torch.models._device import resolve_device

N1, N2, TAPS, J, REPS = 256, 256, 16, 8, 40
KINDS = ("persi", "tapouter", "tapo2d")


def fir_probe_reference(x: torch.Tensor, w: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """Plain version: the FIR once in f32 in tap order, plus the serialising
    chain of ``reps - 1`` f32 adds of its ``[0, 0]`` (0 for one pass)."""
    n1 = w.shape[0] // TAPS
    xf = x.to(torch.float32).reshape(J + TAPS - 1, n1, -1)
    wf = w.reshape(TAPS, n1, -1)
    acc = xf[0:J] * wf[0]
    for t in range(1, TAPS):
        acc = acc + xf[t : t + J] * wf[t]
    acc = acc.reshape(J * n1, -1)
    prev = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(reps - 1):
        prev = acc[0, 0] + prev
    return acc + prev


def fir_probe(x: torch.Tensor, w: torch.Tensor, kind: str, reps: int = REPS) -> torch.Tensor:
    """The probe's kernel in loop order ``kind`` (CUDA) or the plain version
    (CPU): x ``[(J + 15)·N1, N2]`` bf16, w ``[16·N1, N2]`` f32 -> ``[J·N1, N2]``
    f32."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    n1, n2 = w.shape[0] // TAPS, w.shape[1]
    if x.shape != (n1 * (J + TAPS - 1), n2) or w.shape != (n1 * TAPS, n2):
        raise ValueError(f"fir_probe: x {tuple(x.shape)}, w {tuple(w.shape)} are not "
                         f"[(J + 15)·N1, N2] and [16·N1, N2]")
    if x.device.type == "cpu":
        return fir_probe_reference(x, w, reps)
    if x.device.type != "cuda":
        raise ValueError(f"fir_probe: unsupported device {x.device}")
    for name, t, dtype in (("x", x, torch.bfloat16), ("w", w, torch.float32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fir_probe: {name} must be contiguous {dtype} on {x.device}")
    out = torch.empty((J * n1, n2), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.fir_probe_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), n1, n2, reps,
                               int(kind != "persi"), 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fir_probe")
    fir_probe.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU version never counts).
fir_probe.launches = 0


def make(kind: str):
    """The probe's ``run(x, w)`` for one loop order."""
    return lambda x, w: fir_probe(x, w, kind)


def make_inputs(device=None, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's x and w, made on the device from a seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(((J + TAPS - 1) * N1, N2), device=dev, generator=gen).to(torch.bfloat16)
    w = torch.randn((TAPS * N1, N2), device=dev, generator=gen)
    return x, w


def run(kind: str, x: torch.Tensor, w: torch.Tensor) -> float:
    """Time one loop order (printing the probe's line); returns ms per call."""
    f = make(kind)
    per, warm = marginal_ms(lambda: f(x, w), x)
    flops = REPS * J * TAPS * N1 * N2
    print(f"{kind:9s}: {per:7.3f} ms  ({flops / per / 1e6:7.1f} GFMA/s) "
          f"[compile {warm / 1e3:.0f}s]", flush=True)
    return per


def main(device=None):
    x, w = make_inputs(device)
    for kind in ("persi", "tapouter"):
        run(kind, x, w)


if __name__ == "__main__":
    main()
