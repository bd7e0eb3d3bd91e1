"""The port's polyphase FIR (K6's plain version) and composed PFB vs the JAX package.

The JAX side runs ``fir_pallas`` (K6 on the TPU) in interpret mode, with
``pallas_call`` patched as ``tests/test_ops.py`` patches it, and the plain
``pfb_fir(use_pallas=False)``. Both packages add the taps in the same order
in f32, so they differ only where XLA contracts a product and a sum:
rtol 1e-5 / atol 1e-4, the tolerance of the reference's own FIR tests.
The rfft (pocketfft here, XLA's on the JAX side) adds f32 rounding:
rtol 1e-4 / atol 2e-3 on the channelised output.
"""

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
