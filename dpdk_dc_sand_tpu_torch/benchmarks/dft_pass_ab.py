"""K1's bf16 DFT passes on several trees in turn on one card, each tree in
a process of its own with its own ``ops/fengine_fused.py`` and kernels
(built in that tree at first use): the two-pass route's DFT pass's ms at
the flagship (:func:`dft_pass_ms`), the three-pass route's stage A and
stage B alone at fft 2^22 over 160 x S = 4 (:func:`stage_ms`), K7's
three-pass stage A and stage B alone at fft 2^23 over 160 x S = 2
(:func:`dit_stage_ms`), and the
flipped share against the plain version at the splits of
:data:`FLIP_FFTS` (:func:`flipped_share`: the two-pass route's longest
stage-A sums and the three-pass route's) and of K7 at :data:`DIT_FLIP_FFT`
(:func:`dit_flipped_share`). Give the trees in the order to time them, for
example a checkout of the parent commit and of the change as parent,
change, change, parent:

    python -m dpdk_dc_sand_tpu_torch.benchmarks.dft_pass_ab PARENT . . PARENT

Prints one line a tree: its path, the times and the flipped shares.
``chip_smoke.py`` takes :func:`flipped_share` and :func:`dit_flipped_share`
from here for its K1 and K7 phases.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

#: The seed of every input made here.
SEED = 2047

#: The flagship's split, the longest stage-A sums on the two-pass route (N1
#: = 1024 and 2048) and on the three-pass route (N1 = 2048 and 4096).
FLIP_FFTS = (1 << 16, 1 << 20, 1 << 21, 1 << 22, 1 << 23)
#: K7's first bf16 split on the three-pass route (its stage A K1's on the
#: [2048, 4096] view).
DIT_FLIP_FFT = 1 << 23
#: The three-pass route's stages alone at full width: fft, streams, S.
STAGE_CASE = (1 << 22, 160, 4)
#: K7's three-pass stages alone at full width: fft, streams, S.
DIT_STAGE_CASE = (1 << 23, 160, 2)


def dft_pass_ms(ff, fft: int = 65536, nb: int = 160, s: int = 256, iters: int = 2) -> float:
    """ms of ``ff.k1_dft`` (``ff`` a tree's ``ops/fengine_fused.py``) over
    ``nb`` streams x ``s`` spectra in one launch, by CUDA events, the mean of
    ``iters`` calls after one: a bf16 plane and rotation planes made on the
    card from :data:`SEED` (the codes near the flagship's level). The
    flagship's shape by default."""
    import torch

    dev = torch.device("cuda")
    n1, n2 = ff._split_ct(fft)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    plane = (torch.randn((nb, s, fft), device=dev, generator=gen) * 40).to(torch.bfloat16)
    ph = torch.rand((nb, fft // 2), device=dev, generator=gen) * (2 * math.pi)
    scale = 50 / (40 * fft ** 0.5)
    rc, rs = (torch.cos(ph) * scale).contiguous(), (torch.sin(ph) * scale).contiguous()
    ff.k1_dft(plane, rc, rs, n1=n1, n2=n2)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        ff.k1_dft(plane, rc, rs, n1=n1, n2=n2)
    t1.record()
    t1.synchronize()
    del plane, rc, rs
    torch.cuda.empty_cache()
    return t0.elapsed_time(t1) / iters


def stage_ms(ff, fft: int = STAGE_CASE[0], nb: int = STAGE_CASE[1],
             s: int = STAGE_CASE[2], iters: int = 2) -> tuple[float, float]:
    """ms of ``ff.k1_stage_a`` and of ``ff.k1_stage_b`` (``ff`` a tree's
    ``ops/fengine_fused.py``) over ``nb`` streams x ``s`` spectra in one
    launch each, by CUDA events, the mean of ``iters`` calls after one: a
    bf16 plane and rotation planes made on the card from :data:`SEED` (the
    codes near the flagship's level), stage B on stage A's T."""
    import torch

    dev = torch.device("cuda")
    n1, n2 = ff._split_ct(fft)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    plane = (torch.randn((nb, s, fft), device=dev, generator=gen) * 40).to(torch.bfloat16)
    ph = torch.rand((nb, fft // 2), device=dev, generator=gen) * (2 * math.pi)
    scale = 50 / (40 * fft ** 0.5)
    rc, rs = (torch.cos(ph) * scale).contiguous(), (torch.sin(ph) * scale).contiguous()
    del ph
    t = ff.k1_stage_a(plane, n1=n1, n2=n2)
    ff.k1_stage_b(*t, rc, rs, n1=n1, n2=n2)
    torch.cuda.synchronize()
    out = []
    for fn in (lambda: ff.k1_stage_a(plane, n1=n1, n2=n2),
               lambda: ff.k1_stage_b(*t, rc, rs, n1=n1, n2=n2)):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / iters)
    del plane, rc, rs, t
    torch.cuda.empty_cache()
    return out[0], out[1]


def dit_stage_ms(ff, fft: int = DIT_STAGE_CASE[0], nb: int = DIT_STAGE_CASE[1],
                 s: int = DIT_STAGE_CASE[2], iters: int = 2) -> tuple[float, float]:
    """ms of K7's bf16 three-pass stage A and stage B (``ff`` a tree's
    ``ops/fengine_fused.py``: its ``_dit_stage_a_pass`` and
    ``_dit_stage_b_pass``, on T in the tree's own layout) over ``nb``
    streams x ``s`` spectra in one launch each, by CUDA events, the mean of
    ``iters`` calls after one: a bf16 FIR plane and rotation planes made on
    the card from :data:`SEED` (the codes near the flagship's level), stage
    B on stage A's T."""
    import torch

    dev = torch.device("cuda")
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    c = fft // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    plane = torch.empty((nb, s, fft), dtype=torch.bfloat16, device=dev)
    for b in range(nb):  # a stream at a time: no f32 copy of the whole plane
        plane[b] = (torch.randn((s, fft), device=dev, generator=gen) * 40).to(torch.bfloat16)
    ph = torch.rand((nb, c), device=dev, generator=gen) * (2 * math.pi)
    scale = 50 / (40 * c ** 0.5)
    rc, rs = (torch.cos(ph) * scale).contiguous(), (torch.sin(ph) * scale).contiguous()
    del ph
    if hasattr(ff, "_dit_t_layout"):
        layout = ff._dit_t_layout(n1, n2, torch.bfloat16)
    else:  # a tree whose T keeps the [N1, 2·N2] view
        layout = ff._t_layout(n1, 2 * n2, torch.bfloat16)
    tr, ti = (torch.empty((nb, s, *layout), dtype=torch.bfloat16, device=dev) for _ in range(2))
    outr, outi = (torch.empty((nb, s, c), dtype=torch.int8, device=dev) for _ in range(2))
    out = []
    for fn in (lambda: ff._dit_stage_a_pass(plane, tr, ti, n1=n1, n2=n2),
               lambda: ff._dit_stage_b_pass(tr, ti, rc, rs, outr, outi, n1=n1, n2=n2)):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / iters)
    del plane, rc, rs, tr, ti, outr, outi
    torch.cuda.empty_cache()
    return out[0], out[1]


def _share(tag: str, got, ref) -> float:
    """The share of int8 codes where ``got`` differs from ``ref``, the
    larger of the two planes'; raises where a code differs by more than 1."""
    share = 0.0
    for g, r in zip(got, ref):
        d = (g.int() - r.int()).abs()
        if int(d.max()) > 1:
            raise AssertionError(f"{tag}: a code off by {int(d.max())}")
        share = max(share, float((d != 0).float().mean()))
    return share


def flipped_share(ff, fft: int, nb: int = 2, taps: int = 16) -> float:
    """The share of int8 codes where K1's bf16 DFT (``ff.k1_dft`` on the
    two-pass route, ``ff.k1_stage_b`` of ``ff.k1_stage_a`` on the three-pass
    route) differs from ``ff.k1_dft_reference`` run on the card, the larger
    of the two planes': ``nb`` streams of ``max(2, min(8, 2^19 / fft))``
    spectra through ``ff.k1_fir`` (int8 samples from :data:`SEED`, ``taps``
    taps), rotated and requantised at the flagship's code level (near 50
    rms). Raises where a code differs by more than 1."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    n1, n2 = ff._split_ct(fft)
    s = max(2, min(8, (1 << 19) // fft))
    gen = torch.Generator(device=dev).manual_seed(SEED + fft)
    x = torch.randint(-64, 64, (nb, (s + taps - 1) * fft), dtype=torch.int8, device=dev,
                      generator=gen)
    plane = ff.k1_fir(x, torch.zeros(nb, dtype=torch.int64, device=dev),
                      default_window(taps, fft, device=dev), n_spectra=s)
    fd = torch.rand(nb, device=dev, generator=gen) - 0.5
    rc, rs = (r.reshape(nb, -1) for r in ff.fine_rotation_planes(
        fd, -1.5 * fd, n_channels=fft // 2, quant_scale=(65536 / fft) ** 0.5 / 128))
    if ff._k1_body(n1, n2, "bfloat16") == "three_pass":
        got = ff.k1_stage_b(*ff.k1_stage_a(plane, n1=n1, n2=n2), rc, rs, n1=n1, n2=n2)
    else:
        got = ff.k1_dft(plane, rc, rs, n1=n1, n2=n2)
    return _share(f"k1 at fft {fft}", got, ff.k1_dft_reference(plane, rc, rs, n1=n1, n2=n2))


def dit_flipped_share(ff, fft: int = DIT_FLIP_FFT, nb: int = 1, s: int = 2,
                      taps: int = 16) -> float:
    """The share of int8 codes where bf16 K7 (``ff.fengine_dit``) differs
    from ``ff.fengine_dit_reference`` run on the card, the larger of the two
    planes': ``nb`` streams of ``s`` spectra of frames from :data:`SEED`,
    ``taps`` taps, rotated and requantised at the flagship's code level.
    Raises where a code differs by more than 1."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    c = fft // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + fft + 1)
    frames = torch.randint(-64, 64, (nb, s + taps - 1, fft), dtype=torch.int8, device=dev,
                           generator=gen)
    fd = torch.rand(nb, device=dev, generator=gen) - 0.5
    rc, rs = (r.reshape(nb, c) for r in ff._rotation_planes(
        fd, -1.5 * fd, c, (65536 / fft) ** 0.5 / 128, (c,)))
    win = default_window(taps, fft, device=dev)
    return _share(f"k7 at fft {fft}", ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2),
                  ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2))


def _one_tree() -> None:
    """This process's tree (first on ``sys.path``): its pass's ms and flipped
    shares, on one line."""
    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    a_ms, b_ms = stage_ms(ff)
    da_ms, db_ms = dit_stage_ms(ff)
    shares = ", ".join(f"fft {f} {flipped_share(ff, f):.3e}" for f in FLIP_FFTS)
    print(f"flagship DFT pass {dft_pass_ms(ff):.3f} ms; fft {STAGE_CASE[0]} x "
          f"{STAGE_CASE[1]} x S={STAGE_CASE[2]}: stage A {a_ms:.3f} ms, stage B {b_ms:.3f} ms; "
          f"K7 fft {DIT_STAGE_CASE[0]} x {DIT_STAGE_CASE[1]} x S={DIT_STAGE_CASE[2]}: stage A "
          f"{da_ms:.3f} ms, stage B {db_ms:.3f} ms; "
          f"flipped share {shares}; K7 fft {DIT_FLIP_FFT} {dit_flipped_share(ff):.3e}")


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__)
        return 2
    for tree in trees:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [tree] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one-tree"], cwd=tree,
                             env=env, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(f"{tree}: {res.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--one-tree"]:
        _one_tree()
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
