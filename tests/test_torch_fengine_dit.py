"""The DIT form of the F kernel (K7's plain version) vs the JAX package.

The JAX side runs ``fengine_fused(deint="matmul" | "bitcast")`` in
interpret mode at the geometries the reference's own tests pin
(``tests/test_fengine_fused.py:52-100``): fft 1024 through the selection
product, fft 2048 through the int16 byte split. Both round at the same
points (f32 FIR in tap order, the DFT type's operands, f32 accumulation,
f32 twiddle, combine and rotation), so they differ only in the order of f32
additions: within 1 int8 code on <= 1e-3 of samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import fengine_pallas as jfp
from dpdk_dc_sand_tpu.ops.pfb import default_window as j_default_window
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

A, P, TAPS, S = 3, 2, 8, 16
SCALE = 1 / 16


def _codes_close(got, ref, max_code=1, max_frac=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= max_code, d.max()
    assert (d != 0).mean() <= max_frac, (d != 0).mean()


def _inputs(fft, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(-64, 64, (A, P, S + TAPS - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, (A, P)).astype(np.float32)
    ph = rng.uniform(-1, 1, (A, P)).astype(np.float32)
    return frames, fd, ph


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fft,deint", [(1024, "matmul"), (2048, "bitcast"), (2048, "matmul"),
                                       (512, "auto")])
def test_plain_k7_matches_jax_dit_kernel(fft, deint, dft_dtype):
    frames, fd, ph = _inputs(fft, seed=fft + len(deint + dft_dtype))
    kw = dict(n_channels=fft // 2, quant_scale=SCALE, dft_dtype=dft_dtype, deint=deint)
    jr, ji = jfp.fengine_fused(jnp.asarray(frames), j_default_window(TAPS, fft),
                               jnp.asarray(fd), jnp.asarray(ph), interpret=True, **kw)
    before = ff.fengine_dit.launches
    qr, qi = ff.fengine_fused(torch.from_numpy(frames), default_window(TAPS, fft), fd, ph, **kw)
    assert ff.fengine_dit.launches == before  # the CPU never launches
    assert qr.shape == (A, P, S, fft // 2) and qr.dtype == torch.int8
    _codes_close(qr.numpy(), jr)
    _codes_close(qi.numpy(), ji)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_both_names_compute_the_same_values(dft_dtype):
    """Where the two names share a split they give the same bytes. Where they
    do not (fft 2048: 16·64 and 8·128) the operands round at other places:
    within 1 code on <= 1e-3 of samples in f32, and on < 25% in bf16 (the
    bound of tests/test_fengine_fused.py:97-100 against the composed path)."""
    for fft in (1024, 2048):
        frames, fd, ph = _inputs(fft, seed=5)
        x, win = torch.from_numpy(frames), default_window(TAPS, fft)
        kw = dict(n_channels=fft // 2, quant_scale=SCALE, dft_dtype=dft_dtype)
        mm = ff.fengine_fused(x, win, fd, ph, deint="matmul", **kw)
        bc = ff.fengine_fused(x, win, fd, ph, deint="bitcast", **kw)
        same = ff._deint_mode(fft // 2, "matmul")[1:] == ff._deint_mode(fft // 2, "bitcast")[1:]
        assert same == (fft == 1024)
        for m, b in zip(mm, bc):
            if same:
                assert torch.equal(m, b)
            else:
                _codes_close(m.numpy(), b.numpy(),
                             max_frac=0.25 if dft_dtype == "bfloat16" else 1e-3)


@pytest.mark.parametrize("n", [64, 256, 512, 1024, 4096, 32768, 65536])
@pytest.mark.parametrize("deint", ["auto", "matmul", "bitcast"])
def test_deint_mode_follows_the_reference(n, deint):
    assert ff._deint_mode(n, deint) == jfp._deint_mode(n, deint)


def test_auto_takes_the_dit_form_where_the_ct_split_fails():
    assert ff._deint_mode(256) == jfp._deint_mode(256) == ("matmul", 8, 32)
    assert ff._deint_mode(32768) == ("ct", 256, 256)
    # fft 65536: both names split N = 32768 as 256·128.
    assert ff._deint_mode(32768, "matmul") == ("matmul", 256, 128)
    assert ff._deint_mode(32768, "bitcast") == ("bitcast", 256, 128)


def test_dit_gates_raise_as_the_reference_does():
    frames, fd, ph = _inputs(1024, seed=9)
    x, win = torch.from_numpy(frames), default_window(TAPS, 1024)
    kw = dict(n_channels=512, quant_scale=SCALE, deint="matmul")
    planes = ff.fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph),
                                     n_channels=512, quant_scale=SCALE)
    bad = [
        dict(coarse_delays=np.zeros((A, P), np.int32), n_spectra=S),
        dict(rowed=True),
        dict(rot_planes=planes),
        dict(quantise=False),
    ]
    for extra in bad:
        with pytest.raises(ValueError, match="direct-CT"):
            ff.fengine_fused(x, win, fd, ph, **kw, **extra)
    with pytest.raises(ValueError, match="unknown deint"):
        ff.fengine_fused(x, win, fd, ph, n_channels=512, quant_scale=SCALE, deint="fft")
    with pytest.raises(ValueError, match="direct-CT"):
        ff.fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), n_channels=256,
                                quant_scale=SCALE)


def test_plain_k7_reference_is_the_wrapper_on_cpu():
    frames, fd, ph = _inputs(1024, seed=13)
    _, n1, n2 = ff._deint_mode(512, "matmul")
    rc, rs = ff._rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), 512, SCALE, (512,))
    x = torch.from_numpy(frames).reshape(A * P, S + TAPS - 1, 1024)
    win = default_window(TAPS, 1024)
    want = ff.fengine_dit_reference(x, win, rc.reshape(A * P, 512), rs.reshape(A * P, 512),
                                    n1=n1, n2=n2)
    got = ff.fengine_fused(torch.from_numpy(frames), win, fd, ph, n_channels=512,
                           quant_scale=SCALE, deint="matmul")
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
