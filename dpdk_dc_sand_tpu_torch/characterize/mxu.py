"""Tensor-core numeric probe and matmul roofline (counterpart of ``dpdk_dc_sand_tpu/characterize/mxu.py``).

``tensor_core/tc_dynamic_range`` in the reference asks whether
65000 × 1.5e-5 survives fp16 tensor-core arithmetic. Asked of the card's
bf16 tensor cores with f32 accumulation: bf16 has f32's exponent range (no
overflow at 65000) but only an 8-bit significand, so the inputs round and
the product is off by about 2^-8 while f32 is exact.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from dpdk_dc_sand_tpu_torch.models._device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(dtype: str) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def _no_tf32():
    """Full-f32 products on the card, so a float32 probe measures f32."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 output and f32 accumulation, as the reference's
    ``preferred_element_type=jnp.float32``: on the card ``torch.mm`` with
    ``out_dtype`` (bf16 inputs) or in full f32; on the CPU the f32 product
    of the already rounded inputs, which is the same value."""
    if a.device.type != "cuda":
        return a.float() @ b.float()
    with _no_tf32():
        if a.dtype == torch.float32:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)


def mxu_dynamic_range(
    large: float = 65000.0, small: float = 1.5e-5, dtype: str = "bfloat16",
    device: Optional[str] = None,
) -> Dict[str, float]:
    """Probe value survival through one tensor-core product.

    A [16,16] matrix of ``large`` multiplied by a diagonal of ``small``
    should yield exactly ``large*small`` everywhere if the pipeline
    preserves both magnitudes (tc_dynamic_range.cu:6-20 structure). The
    output is f32. ``device`` ``None`` is the card.
    """
    dev = resolve_device(device)
    dt = _dtype(dtype)
    a = torch.full((16, 16), large, dtype=dt, device=dev)
    b = (torch.eye(16, device=dev) * small).to(dt)
    got = float(_product_f32(a, b)[0, 0])
    expected = large * small
    rel_err = abs(got - expected) / abs(expected)
    return {
        "expected": expected,
        "got": got,
        "rel_err": rel_err,
        # bf16 significand rounding bounds the error near 2^-8
        "survives": float(rel_err < 2 ** -7),
    }


def matmul_roofline(
    n: int = 4096, dtype: str = "bfloat16", iters: int = 8, device: Optional[str] = None,
) -> Dict[str, float]:
    """Achieved TFLOP/s of a dependent chain of ``iters`` [n, n] products.

    Chained (``x ← x@w`` in ``dtype``, f32 accumulation) so no product
    can start before the one ahead of it; the first run (cuBLAS's
    heuristics and workspace) is excluded. Timed with CUDA events on the
    card, with ``time.perf_counter`` on the CPU. ``"float32"`` runs with
    TF32 off.
    """
    dev = resolve_device(device)
    dt = _dtype(dtype)
    x0 = torch.full((n, n), 0.5, dtype=dt, device=dev)
    w = (torch.eye(n, device=dev) * 1.001).to(dt)

    def chain():
        x = x0
        for _ in range(iters):
            x = torch.mm(x, w)
        return x

    with _no_tf32() if dev.type == "cuda" else contextlib.nullcontext():
        float(chain()[0, 0])
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = chain()
            t1.record()
            t1.synchronize()
            dt_s = t0.elapsed_time(t1) / 1e3
        else:
            t = time.perf_counter()
            out = chain()
            dt_s = time.perf_counter() - t
    float(out[0, 0])
    flops = 2 * n**3 * iters
    return {"n": n, "iters": iters, "tflops": flops / dt_s / 1e12}


def main() -> None:
    dr = mxu_dynamic_range()
    print(
        f"dynamic range bf16: expected={dr['expected']:.4g} got={dr['got']:.4g} "
        f"rel_err={dr['rel_err']:.3g} survives={bool(dr['survives'])}"
    )
    rl = matmul_roofline()
    print(f"matmul roofline: {rl['tflops']:.1f} TFLOP/s @ n={rl['n']}")


if __name__ == "__main__":
    main()
