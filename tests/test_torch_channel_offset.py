"""The absolute-channel fine delay of a channel-sharded engine on the port
against the JAX reference: ``channel_offset`` and ``n_channels_total`` in
``fengine_fused`` (K1's and K7's forms), ``fine_rotation_planes`` and
``apply_fine_delay`` (``channel_offset`` only).

Each holds the ramp ``rot(k) = -pi·fd·(k + channel_offset - Ct/2)/Ct + phase``
with ``Ct = n_channels_total`` (default the engine's own channels), here at an
offset of 3 engines' channels into a band of 4·C. Tolerances: the planes
equal within 4 f32 ulps of their scale (the same f32 ramp; the two cos and
sin implementations differ by ulps); K1's and K7's codes within 1 code on
<= 1e-3 of samples, ``tests/test_torch_fengine.py``'s contract; the rotated
f32 planes within rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import delay as jdelay
from dpdk_dc_sand_tpu.ops import fengine_pallas as jfp
from dpdk_dc_sand_tpu.ops.pfb import default_window as j_default_window
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.delay import apply_fine_delay
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

A, P, TAPS, S = 2, 2, 4, 8
SCALE = 1 / 16


@pytest.fixture(autouse=True)
def _warm_cos():
    # The first vector cos of a process on this CPU build can err by ~1e-4
    # on one thread's share (see the verify notes): warm it up first.
    torch.cos(torch.linspace(0, 100, 1 << 16))


def _delays(seed):
    rng = np.random.default_rng(seed)
    fd = rng.uniform(-0.5, 0.5, (A, P)).astype(np.float32)
    ph = rng.uniform(-1, 1, (A, P)).astype(np.float32)
    return rng, fd, ph


def _codes_close(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= 1e-3, (d != 0).mean()


@pytest.mark.parametrize("fft", [2048, 16384])
def test_fine_rotation_planes_at_an_offset_match_jax(fft):
    c = fft // 2
    _, fd, ph = _delays(fft)
    kw = dict(n_channels=c, quant_scale=SCALE, channel_offset=3 * c, n_channels_total=4 * c)
    want = jfp.fine_rotation_planes(jnp.asarray(fd), jnp.asarray(ph), **kw)
    got = ff.fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), **kw)
    plain = ff.fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), n_channels=c,
                                    quant_scale=SCALE)
    for g, w, p in zip(got, want, plain):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=4 * float(np.finfo(np.float32).eps) * SCALE)
        assert not torch.allclose(g, p, atol=1e-3)  # the offset moves the ramp


@pytest.mark.parametrize("deint", ["auto", "matmul"])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_fengine_fused_at_an_offset_matches_jax(deint, dft_dtype):
    """K1's form (fft 2048, 16 x 128) and K7's (deint="matmul")."""
    fft = 2048
    c = fft // 2
    rng, fd, ph = _delays(7 + len(deint) + len(dft_dtype))
    frames = rng.integers(-64, 64, (A, P, S + TAPS - 1, fft), dtype=np.int8)
    kw = dict(n_channels=c, quant_scale=SCALE, dft_dtype=dft_dtype, deint=deint,
              channel_offset=3 * c, n_channels_total=4 * c)
    want = jfp.fengine_fused(jnp.asarray(frames), j_default_window(TAPS, fft), jnp.asarray(fd),
                             jnp.asarray(ph), interpret=True, **kw)
    got = ff.fengine_fused(torch.from_numpy(frames), default_window(TAPS, fft), fd, ph, **kw)
    for g, w in zip(got, want):
        assert g.shape == (A, P, S, c)
        _codes_close(g.numpy(), np.asarray(w).reshape(g.shape))


def test_fengine_fused_offset_planes_equal_the_offset_call():
    """Cached planes made at an offset give what the call with the offset
    gives (K1 reads the planes as they are)."""
    fft = 2048
    c = fft // 2
    rng, fd, ph = _delays(11)
    frames = torch.from_numpy(rng.integers(-64, 64, (A, P, S + TAPS - 1, fft), dtype=np.int8))
    kw = dict(channel_offset=c, n_channels_total=2 * c)
    planes = ff.fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), n_channels=c,
                                     quant_scale=SCALE, **kw)
    win = default_window(TAPS, fft)
    a = ff.fengine_fused(frames, win, fd, ph, n_channels=c, quant_scale=SCALE, **kw)
    b = ff.fengine_fused(frames, win, None, None, n_channels=c, quant_scale=SCALE,
                         rot_planes=planes)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_apply_fine_delay_at_an_offset_matches_jax():
    rng, fd, ph = _delays(13)
    c = 512
    re, im = (rng.standard_normal((A, P, S, c)).astype(np.float32) * 40 for _ in "ri")
    want = jdelay.apply_fine_delay(jnp.asarray(re), jnp.asarray(im), jnp.asarray(fd),
                                   jnp.asarray(ph), n_channels=4 * c, channel_offset=2 * c)
    got = apply_fine_delay(torch.from_numpy(re), torch.from_numpy(im), fd, ph,
                           n_channels=4 * c, channel_offset=2 * c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
