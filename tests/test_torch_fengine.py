"""The port's fused F stage (K1's plain version) vs the JAX fused kernel.

The JAX side runs ``fengine_fused`` in interpret mode with the flagship
schedule (``ct_batch_a=True, rolling=True``) and the coarse delay folded
into the kernel. Both round at the same points (int8 -> f32 FIR in tap
order, bf16 stage operands, f32 accumulation, f32 twiddle and rotation),
so they differ only in the order of f32 additions: within 1 int8 code on
<= 1e-3 of samples. Against the composed FFT path the bf16 operands cost
up to 1 code on < 25% of samples (tests/test_fengine_fused.py:97-100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import fengine_pallas as jfp
from dpdk_dc_sand_tpu.ops.pfb import default_window as j_default_window
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.delay import apply_fine_delay
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window, pfb_channelise
from dpdk_dc_sand_tpu_torch.ops.requant import requantise

A, P, TAPS, S = 2, 2, 8, 16
SCALE = 1 / 16


def _codes_close(got, ref, max_code=1, max_frac=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= max_code, d.max()
    assert (d != 0).mean() <= max_frac, (d != 0).mean()


def _coarse_inputs(fft, seed):
    rng = np.random.default_rng(seed)
    margin = jfp.coarse_margin_samples(fft, TAPS, S, True)
    max_d = 300
    n2 = ff.ingest_alignment(fft)
    n_in = (S + TAPS - 1) * fft + margin + max_d
    n_in = -(-n_in // n2) * n2
    raw = rng.integers(-64, 64, (A, P, n_in), dtype=np.int8)
    cd = rng.integers(0, max_d, (A, P)).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, (A, P)).astype(np.float32)
    ph = rng.uniform(-1, 1, (A, P)).astype(np.float32)
    return raw, cd, fd, ph, n2


@pytest.mark.parametrize(
    "fft,dft_dtype,rowed",
    [
        (1024, "bfloat16", False),
        (1024, "float32", True),
        (2048, "bfloat16", True),
        (2048, "float32", False),
        (4096, "bfloat16", False),
        (4096, "float32", True),
    ],
)
def test_plain_k1_matches_jax_kernel_with_coarse_delays(fft, dft_dtype, rowed):
    raw, cd, fd, ph, n2 = _coarse_inputs(fft, seed=fft + len(dft_dtype))
    x = raw.reshape(A, P, -1, n2) if rowed else raw
    jr, ji = jfp.fengine_fused(
        jnp.asarray(x), j_default_window(TAPS, fft), jnp.asarray(fd), jnp.asarray(ph),
        n_channels=fft // 2, quant_scale=SCALE, dft_dtype=dft_dtype, interpret=True,
        ct_batch_a=True, rolling=True, coarse_delays=jnp.asarray(cd), n_spectra=S,
        rowed=rowed,
    )
    qr, qi = ff.fengine_fused(
        torch.from_numpy(x), default_window(TAPS, fft), fd, ph,
        n_channels=fft // 2, quant_scale=SCALE, dft_dtype=dft_dtype,
        coarse_delays=torch.from_numpy(cd), n_spectra=S, rowed=rowed,
    )
    assert qr.shape == (A, P, S, fft // 2) and qr.dtype == torch.int8
    _codes_close(qr.numpy(), jr)
    _codes_close(qi.numpy(), ji)


def test_plain_k1_aligned_frames_with_cached_planes_match_jax():
    fft = 2048
    rng = np.random.default_rng(31)
    frames = rng.integers(-64, 64, (A, P, S + TAPS - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, (A, P)).astype(np.float32)
    ph = rng.uniform(-1, 1, (A, P)).astype(np.float32)
    jplanes = jfp.fine_rotation_planes(
        jnp.asarray(fd), jnp.asarray(ph), n_channels=fft // 2, quant_scale=SCALE
    )
    jr, ji = jfp.fengine_fused(
        jnp.asarray(frames), j_default_window(TAPS, fft), jnp.asarray(fd),
        jnp.asarray(ph), n_channels=fft // 2, quant_scale=SCALE, interpret=True,
        ct_batch_a=True, rot_planes=jplanes,
    )
    planes = tuple(torch.from_numpy(np.array(p)) for p in jplanes)
    qr, qi = ff.fengine_fused(
        torch.from_numpy(frames), default_window(TAPS, fft), None, None,
        n_channels=fft // 2, quant_scale=SCALE, rot_planes=planes,
    )
    _codes_close(qr.numpy(), jr)
    _codes_close(qi.numpy(), ji)


@pytest.mark.parametrize("fft", [1024, 2048, 4096, 8192, 16384, 32768, 65536, 1 << 18])
def test_ct_split_and_ingest_alignment_match_reference(fft):
    assert ff._split_ct(fft) == jfp._split_ct(fft)
    assert ff.ingest_alignment(fft) == jfp.ingest_alignment(fft)


def _composed(frames, fd, ph, fft):
    samples = torch.from_numpy(frames).reshape(A, P, -1)
    spec = pfb_channelise(samples, default_window(TAPS, fft))
    re, im = apply_fine_delay(spec.real, spec.imag, fd, ph, n_channels=fft // 2)
    return requantise(re, SCALE).numpy(), requantise(im, SCALE).numpy()


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_plain_k1_within_one_code_of_composed_path(dft_dtype):
    fft = 1024
    rng = np.random.default_rng(37)
    frames = rng.integers(-64, 64, (A, P, S + TAPS - 1, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, (A, P)).astype(np.float32)
    ph = rng.uniform(-1, 1, (A, P)).astype(np.float32)
    ref = _composed(frames, fd, ph, fft)
    got = ff.fengine_fused(
        torch.from_numpy(frames), default_window(TAPS, fft), fd, ph,
        n_channels=fft // 2, quant_scale=SCALE, dft_dtype=dft_dtype,
    )
    for g, r in zip(got, ref):
        _codes_close(g.numpy(), r, max_frac=0.25 if dft_dtype == "bfloat16" else 1e-3)


def test_plain_k1_tone_leakage_no_worse_than_composed_path():
    """A CW tone: the peak lands in its channel and the bf16 DFT adds no
    leakage over the composed path's own int8 floor."""
    fft, k0 = 1024, 100
    n = (S + TAPS - 1) * fft
    t = np.arange(n)
    tone = np.clip(np.round(100 * np.cos(2 * np.pi * k0 * t / fft)), -127, 127)
    frames = np.broadcast_to(tone.astype(np.int8), (1, 1, n)).reshape(1, 1, -1, fft)
    spec = pfb_channelise(torch.from_numpy(frames.reshape(1, 1, -1).copy()),
                          default_window(TAPS, fft))
    scale = 120.0 / float(spec.abs().max())

    def power_db(qr, qi):
        power = (qr.double() ** 2 + qi.double() ** 2).mean(dim=(0, 1, 2)).numpy()
        assert power.argmax() == k0
        others = np.delete(power, [k0 - 1, k0, k0 + 1])
        return 10 * np.log10(max(others.max(), 1e-300) / power[k0])

    ref_db = power_db(requantise(spec.real, scale), requantise(spec.imag, scale))
    zero = np.zeros((1, 1), np.float32)
    qr, qi = ff.fengine_fused(
        torch.from_numpy(frames.copy()), default_window(TAPS, fft), zero, zero,
        n_channels=fft // 2, quant_scale=scale,
    )
    got_db = power_db(qr, qi)
    assert got_db <= max(ref_db + 3.0, -45.0), (got_db, ref_db)


def test_fengine_fused_input_checks():
    win = default_window(TAPS, 1024)
    zero = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="n_channels"):
        ff.fengine_fused(torch.zeros((1, 1, 20, 1024), dtype=torch.int8), win, zero,
                         zero, n_channels=256, quant_scale=1.0)
    with pytest.raises(ValueError, match="N2=128"):
        ff.fengine_fused(torch.zeros((1, 1, 160, 64), dtype=torch.int8), win, zero,
                         zero, n_channels=512, quant_scale=1.0, rowed=True)
    with pytest.raises(ValueError, match="n_spectra"):
        ff.fengine_fused(torch.zeros((1, 1, 30000), dtype=torch.int8), win, zero,
                         zero, n_channels=512, quant_scale=1.0,
                         coarse_delays=np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="power of two"):
        ff.fengine_fused(torch.zeros((1, 1, 20, 768), dtype=torch.int8),
                         default_window(TAPS, 768), zero, zero, n_channels=384,
                         quant_scale=1.0)
    # quantise=False: the rotated f32 values of the direct-CT form; the DIT
    # form refuses it, as the reference's gate does.
    fr, fi = ff.fengine_fused(torch.zeros((1, 1, 20, 1024), dtype=torch.int8), win, zero,
                              zero, n_channels=512, quant_scale=1.0, quantise=False)
    assert fr.dtype == fi.dtype == torch.float32 and fr.shape == (1, 1, 13, 512)
    with pytest.raises(ValueError, match="quantise=False"):
        ff.fengine_fused(torch.zeros((1, 1, 20, 1024), dtype=torch.int8), win, zero,
                         zero, n_channels=512, quant_scale=1.0, quantise=False,
                         deint="matmul")
