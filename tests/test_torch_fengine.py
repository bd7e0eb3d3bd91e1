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


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_plain_k1_matches_jax_kernel_at_fft_2_17(dft_dtype):
    """Above the old 65536 cap (N1 x N2 = 512 x 256): one batch, two spectra,
    four taps, a coarse delay, as the JAX kernel computes them."""
    fft, taps, s = 1 << 17, 4, 2
    rng = np.random.default_rng(17)
    n2 = ff.ingest_alignment(fft)
    margin = jfp.coarse_margin_samples(fft, taps, s, True)
    n_in = -(-((s + taps - 1) * fft + margin + 300) // n2) * n2
    raw = rng.integers(-64, 64, (1, 1, n_in), dtype=np.int8)
    cd = np.array([[123]], np.int32)
    fd = np.array([[0.3]], np.float32)
    ph = np.array([[-0.2]], np.float32)
    scale = 1 / 16 * (1024 / fft) ** 0.5
    jr, ji = jfp.fengine_fused(
        jnp.asarray(raw), j_default_window(taps, fft), jnp.asarray(fd), jnp.asarray(ph),
        n_channels=fft // 2, quant_scale=scale, dft_dtype=dft_dtype, interpret=True,
        ct_batch_a=True, rolling=True, coarse_delays=jnp.asarray(cd), n_spectra=s,
    )
    qr, qi = ff.fengine_fused(
        torch.from_numpy(raw), default_window(taps, fft), fd, ph, n_channels=fft // 2,
        quant_scale=scale, dft_dtype=dft_dtype, coarse_delays=torch.from_numpy(cd),
        n_spectra=s,
    )
    assert qr.shape == (1, 1, s, fft // 2)
    _codes_close(qr.numpy(), jr)
    _codes_close(qi.numpy(), ji)


def _k1_reference_before_the_split(x, starts, window, rotc, rots, *, n_spectra, n1, n2,
                                   dft_dtype, quantise):
    """The plain K1 as one function, as it stood before its two passes had
    plain versions of their own."""
    n_taps, fft = window.shape
    batch = x.shape[0]
    c = fft // 2
    length = (n_spectra + n_taps - 1) * fft
    xs = torch.stack([x[b, s : s + length] for b, s in enumerate(starts.tolist())])
    frames = xs.reshape(batch, -1, fft).to(torch.float32)
    w = window.to(torch.float32)
    acc = frames[:, 0:n_spectra] * w[0]
    for tap in range(1, n_taps):
        acc = acc + frames[:, tap : tap + n_spectra] * w[tap]
    rnd = ff._round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)
    k = ff.dft_constants(n1, n2, str(x.device))
    xm = rnd(acc).reshape(batch, n_spectra, n1, n2)
    ar = torch.matmul(rnd(k.d1c), xm)
    ai = torch.matmul(rnd(k.d1s), xm)
    tr = rnd(ar * k.twc - ai * k.tws)
    ti = rnd(ar * k.tws + ai * k.twc)
    d2 = rnd(k.d2)
    yr = torch.matmul(d2, tr.transpose(-1, -2))
    yi = torch.matmul(d2, ti.transpose(-1, -2))
    h = n2 // 2
    re = (yr[..., :h, :] - yi[..., h:, :]).reshape(batch, n_spectra, c)
    im = (yi[..., :h, :] + yr[..., h:, :]).reshape(batch, n_spectra, c)
    outr = re * rotc.reshape(batch, 1, c) - im * rots.reshape(batch, 1, c)
    outi = re * rots.reshape(batch, 1, c) + im * rotc.reshape(batch, 1, c)
    if not quantise:
        return outr, outi
    return tuple(torch.round(v).clamp(-127.0, 127.0).to(torch.int8) for v in (outr, outi))


def _k1_operands(fft, taps, s, batch, seed):
    rng = np.random.default_rng(seed)
    n_in = (s + taps - 1) * fft + 777
    x = torch.from_numpy(rng.integers(-128, 128, (batch, n_in), dtype=np.int8))
    starts = torch.from_numpy(rng.integers(0, 778, batch).astype(np.int64))
    rc, rs = (torch.from_numpy(rng.normal(0, 0.05, (batch, fft // 2)).astype(np.float32))
              for _ in range(2))
    return x, starts, default_window(taps, fft), rc, rs


@pytest.mark.parametrize("fft", [1024, 4096, 65536])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantise", [True, False])
def test_k1_reference_is_its_two_passes_and_unchanged(fft, dft_dtype, quantise):
    """The plain K1 is its FIR pass's plain version then its DFT pass's, and
    gives the bytes the one-function version gave."""
    taps, s, batch = 4, 3, 2
    x, starts, win, rc, rs = _k1_operands(fft, taps, s, batch, fft + len(dft_dtype))
    n1, n2 = ff._split_ct(fft)
    kw = dict(n_spectra=s, n1=n1, n2=n2, dft_dtype=dft_dtype, quantise=quantise)
    got = ff.fengine_fused_reference(x, starts, win, rc, rs, **kw)
    plane = ff.k1_fir_reference(x, starts, win, n_spectra=s, dft_dtype=dft_dtype)
    assert plane.dtype == (torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32)
    assert plane.shape == (batch, s, fft)
    parts = ff.k1_dft_reference(plane, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype,
                                quantise=quantise)
    before = _k1_reference_before_the_split(x, starts, win, rc, rs, **kw)
    for g, p, b in zip(got, parts, before):
        assert g.dtype == (torch.int8 if quantise else torch.float32)
        assert torch.equal(g, p) and torch.equal(g, b)


@pytest.mark.parametrize("taps", [1, 4, 16, 20])
def test_k1_fir_reference_is_the_pfb_fir_of_each_window(taps):
    """The FIR pass's plain version is K6's plain FIR over each stream's own
    window of frames (unaligned starts), rounded to bf16 as the DFT operand."""
    from dpdk_dc_sand_tpu_torch.ops.pfb_fir import pfb_fir_reference

    fft, s, batch = 2048, 5, 3
    x, starts, win, _, _ = _k1_operands(fft, taps, s, batch, taps)
    f32 = ff.k1_fir_reference(x, starts, win, n_spectra=s, dft_dtype="float32")
    bf = ff.k1_fir_reference(x, starts, win, n_spectra=s)
    for b, st in enumerate(starts.tolist()):
        frames = x[b, st : st + (s + taps - 1) * fft].reshape(1, -1, fft)
        want = pfb_fir_reference(frames, win)[0]
        assert torch.equal(f32[b], want)
        assert torch.equal(bf[b], want.to(torch.bfloat16))


@pytest.mark.parametrize("batch, s, fft, want", [
    (160, 256, 65536, 32),  # the flagship: 32 streams' planes, 1.07 GB
    (5, 256, 65536, 5),
    (4, 8, 1 << 20, 4),
    (3, 4096, 1 << 20, 1),  # one plane is more than the scratch: one at a time
])
def test_k1_plane_group_bounds_the_scratch(batch, s, fft, want):
    group = ff._plane_group(batch, s, fft)
    assert group == want
    assert group == 1 or group * s * fft * 2 <= ff.K1_SCRATCH_BYTES


def test_k1_pass_wrappers_take_the_plain_versions_on_cpu():
    fft, taps, s = 4096, 4, 3
    x, starts, win, rc, rs = _k1_operands(fft, taps, s, 2, 5)
    n1, n2 = ff._split_ct(fft)
    launches = (ff.k1_fir.launches, ff.k1_dft.launches, ff.fengine_fused.launches)
    plane = ff.k1_fir(x, starts, win, n_spectra=s)
    assert torch.equal(plane, ff.k1_fir_reference(x, starts, win, n_spectra=s))
    for g, r in zip(ff.k1_dft(plane, rc, rs, n1=n1, n2=n2),
                    ff.k1_dft_reference(plane, rc, rs, n1=n1, n2=n2)):
        assert torch.equal(g, r)
    assert (ff.k1_fir.launches, ff.k1_dft.launches, ff.fengine_fused.launches) == launches
    with pytest.raises(ValueError, match="unsupported device"):
        ff.k1_fir(x.to("meta"), starts, win, n_spectra=s)


@pytest.mark.parametrize("n1, n2", [(8, 128), (16, 2048)])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("quantise", [True, False])
def test_k1_stage_references_compose_to_the_dft_reference(n1, n2, dft_dtype, quantise):
    """The three-pass route's plain stages, stage A (T rounded to the operand
    type) then stage B, are the DFT pass's plain version bit for bit, at N1 =
    8 and at a cheap N2 = 2048 split."""
    fft, taps, s, batch = n1 * n2, 4, 3, 2
    x, starts, win, rc, rs = _k1_operands(fft, taps, s, batch, n1 + n2 + quantise)
    plane = ff.k1_fir_reference(x, starts, win, n_spectra=s, dft_dtype=dft_dtype)
    tr, ti = ff.k1_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    assert tr.dtype == ti.dtype == dtype and tr.shape == ti.shape == (batch, s, n1, n2)
    got = ff.k1_stage_b_reference(tr, ti, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype,
                                  quantise=quantise)
    want = ff.k1_dft_reference(plane, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype,
                               quantise=quantise)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if quantise else torch.float32)
        assert g.shape == (batch, s, fft // 2)
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch, s, fft, dft_dtype, want", [
    (160, 4, 1 << 22, "bfloat16", 10),  # 80 ant x 2 pol, 2^24 samples a stream: 1.01 GB
    (160, 4, 1 << 22, "float32", 5),
    (2, 2, 1 << 22, "bfloat16", 2),
    (3, 64, 1 << 22, "float32", 1),  # one stream's scratch is more than the budget
])
def test_k1_three_pass_group_bounds_the_scratch(batch, s, fft, dft_dtype, want):
    """The three-pass route keeps the FIR plane and T re and im, three planes
    of the operand type, under K1_SCRATCH_BYTES; the two-pass grouping of
    the same streams is unchanged."""
    item = 2 if dft_dtype == "bfloat16" else 4
    group = ff._plane_group(batch, s, fft, 3 * item)
    assert group == want
    assert group == 1 or group * s * fft * 3 * item <= ff.K1_SCRATCH_BYTES
    assert ff._plane_group(batch, s, fft, item) == min(batch, max(1, ff.K1_SCRATCH_BYTES //
                                                                  (item * s * fft)))


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k1_stage_wrappers_take_the_plain_versions_on_cpu(dft_dtype):
    """``k1_stage_a`` / ``k1_stage_b`` (and their f32 twins) on CPU tensors
    are the plain stages, count no launch and refuse another device."""
    fft, taps, s = 4096, 4, 2
    x, starts, win, rc, rs = _k1_operands(fft, taps, s, 2, 31)
    n1, n2 = ff._split_ct(fft)
    f32 = dft_dtype == "float32"
    stage_a, stage_b = ((ff.k1_stage_a_f32, ff.k1_stage_b_f32) if f32 else
                        (ff.k1_stage_a, ff.k1_stage_b))
    launches = (stage_a.launches, stage_b.launches)
    plane = ff.k1_fir_reference(x, starts, win, n_spectra=s, dft_dtype=dft_dtype)
    tr, ti = stage_a(plane, n1=n1, n2=n2)
    for g, w in zip((tr, ti), ff.k1_stage_a_reference(plane, n1=n1, n2=n2,
                                                      dft_dtype=dft_dtype)):
        assert torch.equal(g, w)
    got = stage_b(tr, ti, rc, rs, n1=n1, n2=n2)
    want = ff.k1_stage_b_reference(tr, ti, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (stage_a.launches, stage_b.launches) == launches
    with pytest.raises(ValueError, match="unsupported device"):
        stage_a(plane.to("meta"), n1=n1, n2=n2)
    with pytest.raises(ValueError, match="unsupported device"):
        stage_b(tr.to("meta"), ti.to("meta"), rc, rs, n1=n1, n2=n2)
