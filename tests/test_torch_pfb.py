"""The port's polyphase FIR (K6's plain version) and composed PFB vs the JAX package.

The JAX side runs ``fir_pallas`` (K6 on the TPU) in interpret mode, with
``pallas_call`` patched as ``tests/test_ops.py`` patches it, and the plain
``pfb_fir(use_pallas=False)``. Both packages add the taps in the same order
in f32, so they differ only where XLA contracts a product and a sum:
rtol 1e-5 / atol 1e-4, the tolerance of the reference's own FIR tests.
The rfft (pocketfft here, XLA's on the JAX side) adds f32 rounding:
rtol 1e-4 / atol 2e-3 on the channelised output.
"""

import math
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import pfb as jpfb
from dpdk_dc_sand_tpu.ops import pfb_pallas
from dpdk_dc_sand_tpu_torch.ops import pfb, pfb_fir

FIR_TOL = dict(rtol=1e-5, atol=1e-4)


def _frames(rng, dtype, shape):
    if dtype == "int8":
        return rng.integers(-128, 128, shape, dtype=np.int8)
    return rng.normal(0, 40, shape).astype(np.float32)


def _interp_fir(frames, window, n_spectra):
    real_call = pfb_pallas.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return real_call(*args, **kw)

    with mock.patch.object(pfb_pallas.pl, "pallas_call", interp_call):
        return np.asarray(pfb_pallas.fir_pallas(jnp.asarray(frames), jnp.asarray(window),
                                                n_spectra))


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("taps,fft,s", [(4, 256, 8), (8, 384, 16), (16, 128, 24)])
def test_plain_k6_matches_jax_fir_pallas(dtype, taps, fft, s):
    rng = np.random.default_rng(taps * fft + s)
    frames = _frames(rng, dtype, (2, 3, s + taps - 1, fft))
    window = pfb.pfb_window(taps, fft)
    want = _interp_fir(frames, window, s)
    got = pfb_fir.pfb_fir_reference(torch.from_numpy(frames), torch.from_numpy(window))
    assert got.shape == want.shape == (2, 3, s, fft) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FIR_TOL)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("taps,fft,s", [(1, 64, 5), (3, 100, 7), (16, 512, 3), (20, 36, 9)])
def test_plain_k6_matches_jax_plain_fir_at_any_shape(dtype, taps, fft, s):
    """fft not a multiple of 128, odd S and taps above 16: K6 has no shape gate."""
    rng = np.random.default_rng(taps + fft + s)
    x = _frames(rng, dtype, (3, (s + taps - 1) * fft))
    window = pfb.pfb_window(taps, fft)
    want = np.asarray(jpfb.pfb_fir(jnp.asarray(x), jnp.asarray(window), use_pallas=False))
    before = pfb_fir.pfb_fir_frames.launches
    got = pfb.pfb_fir(torch.from_numpy(x), torch.from_numpy(window))
    assert pfb_fir.pfb_fir_frames.launches == before  # the CPU never launches
    assert got.shape == want.shape == (3, s, fft)
    np.testing.assert_allclose(got.numpy(), want, **FIR_TOL)


def test_plain_k6_is_the_plain_fir_bit_for_bit_and_leaves_its_input():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(_frames(rng, "float32", (2, 20, 256)))
    keep = frames.clone()
    window = pfb.default_window(8, 256)
    got = pfb_fir.pfb_fir_frames(frames, window)
    f = frames.to(torch.float32)
    want = f[:, 0:13] * window[0]
    for tap in range(1, 8):
        want = want + f[:, tap : tap + 13] * window[tap]
    assert torch.equal(got, want)
    assert torch.equal(frames, keep)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("taps,fft", [(4, 512), (16, 256)])
def test_pfb_channelise_matches_jax(dtype, taps, fft):
    rng = np.random.default_rng(taps + fft + len(dtype))
    s = 6
    x = _frames(rng, dtype, (2, (s + taps - 1) * fft))
    win = pfb.default_window(taps, fft)
    got = pfb.pfb_channelise(torch.from_numpy(x), win)
    want = jpfb.pfb_channelise(jnp.asarray(x), jpfb.default_window(taps, fft), use_pallas=False)
    assert got.shape == (2, s, fft // 2) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-3)


def test_pfb_fir_input_checks():
    win = pfb.default_window(4, 64)
    with pytest.raises(ValueError, match="multiple of fft_size"):
        pfb.pfb_fir(torch.zeros(3 * 64 + 1, dtype=torch.int8), win)
    with pytest.raises(ValueError, match="n_taps frames"):
        pfb.pfb_fir(torch.zeros(3 * 64, dtype=torch.int8), win)
    with pytest.raises(ValueError, match="int8 or float32"):
        pfb_fir.pfb_fir_frames(torch.zeros((1, 4, 64), dtype=torch.int16), win)
    with pytest.raises(ValueError, match="unsupported device"):
        pfb_fir.pfb_fir_frames(torch.zeros((1, 4, 64), dtype=torch.int8, device="meta"),
                               win.to("meta"))


# K6's planner (``pfb_fir._fir_plan``): it runs here, without the card.
_PLAN_FFTS = [1000, 1024, 4096, 65536]
_PLAN_TAPS = [1, 4, 8, 16, 17, 40]


@pytest.mark.parametrize("fft", _PLAN_FFTS)
@pytest.mark.parametrize("taps", _PLAN_TAPS)
def test_k6_plan_passes_cover_the_taps_in_order_each_in_a_ring_that_holds_them(fft, taps):
    """The passes take the taps in order, at most 16 each, and each pass's
    register ring (4, 8 or 16 rows) is the smallest that holds its taps;
    the frame type and alignment change only the copy mode."""
    plans = {pfb_fir._fir_plan(fft, taps, elem, align, n_spectra=130)
             for elem in (1, 4) for align in (1, 2, 4, 8, 16, 256)}
    assert len({plan.passes for plan in plans}) == 1
    passes = pfb_fir._fir_plan(fft, taps, 1, 16).passes
    assert [t0 for t0, _, _ in passes] == list(range(0, taps, pfb_fir.PASS_TAPS))
    assert sum(n for _, n, _ in passes) == taps
    for _, n, depth in passes:
        assert 1 <= n <= pfb_fir.PASS_TAPS and depth in (4, 8, 16) and depth >= n
        assert depth == 4 or depth // 2 < n  # the smallest ring that holds them


@pytest.mark.parametrize(
    "fft, elem, align, copy",
    [(65536, 1, 16, "async"), (1024, 4, 16, "async"), (1000, 4, 16, "async"),
     (1000, 1, 16, "async"), (4100, 1, 4, "async"), (65536, 1, 4, "async"),
     (65536, 1, 8, "async"), (65536, 1, 1, "scalar"), (65536, 4, 4, "scalar"),
     (65536, 4, 8, "scalar"), (1002, 1, 16, "scalar"), (1002, 4, 16, "scalar"),
     (6, 1, 16, "scalar")],
)
def test_k6_plan_copy_mode_follows_row_bytes_and_alignment(fft, elem, align, copy):
    """async: fft % 4 == 0 on a base aligned to 4 elements (4 bytes of
    int8, 16 of f32); scalar: the rest."""
    assert pfb_fir._fir_plan(fft, 16, elem, align).copy == copy


@pytest.mark.parametrize(
    "args, kw",
    [((1024, 16, 2, 16), {}), ((1024, 0, 1, 16), {}), ((0, 16, 1, 16), {}),
     ((1 << 31, 16, 1, 16), {}), ((65536, 16, 1, 16), dict(n_spectra=1 << 31)),
     ((1024, 16, 1, 16), dict(n_spectra=0))],
)
def test_k6_plan_refuses_a_shape_with_no_plan(args, kw):
    with pytest.raises(ValueError):
        pfb_fir._fir_plan(*args, **kw)


def test_k6_wrapper_launches_each_pass_of_the_plan(monkeypatch):
    """The wrapper hands the kernel exactly the plan's passes, in order, with
    its copy mode, and counts one launch a call (the card is stubbed)."""
    calls = []

    class Lib:
        @staticmethod
        def pfb_fir_launch(*args):
            calls.append(args[3:12])
            return 0

    monkeypatch.setattr(pfb_fir._build, "library", lambda: Lib)
    monkeypatch.setattr(pfb_fir.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    frames = torch.zeros((3, 340, 1000), dtype=torch.int8)
    window = torch.zeros((40, 1000), dtype=torch.float32)
    before = pfb_fir.pfb_fir_frames.launches
    pfb_fir._launch(frames, window, 301)
    plan = pfb_fir._fir_plan(1000, 40, 1, math.gcd(frames.data_ptr(), 16), n_spectra=301)
    assert plan.passes == ((0, 16, 16), (16, 16, 16), (32, 8, 8))
    mode = pfb_fir.COPY_MODES.index(plan.copy)
    assert calls == [(3, 340, 1000, 301, t0, n, d, 0, mode) for t0, n, d in plan.passes]
    assert pfb_fir.pfb_fir_frames.launches == before + 1
