"""P1: the corner-turn kernel probe, int8 ``[A, P, S, C]`` -> ``[C, 2A, P·S]``
(``benchmarks/ct_kernel_probe.py`` of the JAX package, whose kernel reaches
``pl.pallas_call`` at its line 108).

Which tiling ``(c_blk, s_chunk)`` and which in-kernel turn win, on the card
(``ct_probe_launch`` in ``csrc/corner_turn.cu``; K4's kernel is untouched):

- ``copy`` : the same tiling, no turn: ``[2, A, P, S, C]``, the floor of
  the tiling;
- ``i8``   : a byte-wise shared tile, ``[C, 2A, P·S]``;
- ``i32``  : K4's 4x4 ``__byte_perm`` word turn, the same output;
- ``i8m``, ``i8m2`` : the minor-antenna output ``[C, P·S, 2A]``, byte-wise
  and word-wise (``A % 4 == 0``).

Every mode is a permute: the plain version (:func:`ct_probe_reference`) is
``permute`` + ``reshape``, and the kernel equals it bit for bit.

Run: python -m dpdk_dc_sand_tpu_torch.benchmarks.ct_kernel_probe [S] [mode:c_blk:s_chunk ...]
"""

from __future__ import annotations

import sys

import torch

from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
from dpdk_dc_sand_tpu_torch.models._device import resolve_device

A, P, C = 80, 2, 32768
MODES = {"copy": 0, "i8": 1, "i32": 2, "i8m": 3, "i8m2": 4}
SPECS = ("copy:128:128", "i8:128:128", "i32:64:128", "i8:256:64", "i8:64:256")


def ct_probe_reference(qr: torch.Tensor, qi: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of one mode's output."""
    a, p, s, c = qr.shape
    if mode == "copy":
        return torch.stack([qr, qi])
    want = torch.cat([q.permute(3, 1, 2, 0).reshape(c, p * s, a) for q in (qr, qi)], -1)
    if mode in ("i8m", "i8m2"):
        return want
    return want.permute(0, 2, 1).contiguous()


def ct_probe(qr: torch.Tensor, qi: torch.Tensor, mode: str, c_blk: int,
             s_chunk: int) -> torch.Tensor:
    """One mode of the probe (the kernel on CUDA, the plain version on CPU)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    a, p, s, c = qr.shape
    if c % c_blk or s % s_chunk or c_blk % 32 or s_chunk % 16 or (mode == "i8m2" and a % 4):
        raise ValueError(f"ct_probe {mode}:{c_blk}:{s_chunk} on [{a}, {p}, {s}, {c}]: needs "
                         "C % c_blk == 0, S % s_chunk == 0, c_blk % 32 == 0, s_chunk % 16 == 0"
                         " (and A % 4 == 0 for i8m2)")
    if qr.device.type == "cpu":
        return ct_probe_reference(qr, qi, mode)
    if qr.device.type != "cuda":
        raise ValueError(f"ct_probe: unsupported device {qr.device}")
    for t in (qr, qi):
        if t.dtype != torch.int8 or t.device != qr.device or not t.is_contiguous() \
                or t.data_ptr() % 4:
            raise ValueError(f"ct_probe: planes must be contiguous 4-byte aligned int8 on "
                             f"{qr.device}")
    shape = {"copy": (2, a, p, s, c), "i8m": (c, p * s, 2 * a),
             "i8m2": (c, p * s, 2 * a)}.get(mode, (c, 2 * a, p * s))
    out = torch.empty(shape, dtype=torch.int8, device=qr.device)
    lib = _build.library()
    err = lib.ct_probe_launch(qr.data_ptr(), qi.data_ptr(), out.data_ptr(), a, p, s, c,
                              MODES[mode], c_blk, s_chunk,
                              torch.cuda.current_stream(qr.device).cuda_stream)
    _build.check(lib, err, f"ct_probe {mode}")
    ct_probe.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU version never counts).
ct_probe.launches = 0


def make_ct(mode: str, c_blk: int, s_chunk: int, S: int):
    """The probe's ``ct(qr, qi)`` for one spec (S is the planes' own)."""
    return lambda qr, qi: ct_probe(qr, qi, mode, c_blk, s_chunk)


def make_inputs(S: int, device=None, seed: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's two planes ``[A, P, S, C]``, made on the device from a seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(-64, 64, (A, P, S, C), dtype=torch.int8, device=dev,
                               generator=gen) for _ in "ri")


def run_variant(spec: str, S: int, device=None, planes=None) -> tuple[float, bool]:
    """Check one spec against the plain version once and time it (printing
    the probe's line); returns ``(ms per call, ok)``."""
    mode, c_blk, s_chunk = spec.split(":")
    ct = make_ct(mode, int(c_blk), int(s_chunk), S)
    qr, qi = make_inputs(S, device) if planes is None else planes
    ok = torch.equal(ct(qr, qi), ct_probe_reference(qr, qi, mode))
    tag = "OK " if ok else "BAD"
    per, warm = marginal_ms(lambda: ct(qr, qi), qr)
    gb = 2 * qr.numel() * 2 / 1e9  # read + write, both planes
    print(f"S={S:3d} {spec:12s} [{tag}]: {per:7.2f} ms ({gb / per * 1e3:6.1f} GB/s eff) "
          f"[compile {warm / 1e3:.0f}s]", flush=True)
    return per, ok


def main(argv):
    S = int(argv[0]) if argv else 128
    for spec in argv[1:] or SPECS:
        try:
            run_variant(spec, S)
        except Exception as e:
            print(f"{spec}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
