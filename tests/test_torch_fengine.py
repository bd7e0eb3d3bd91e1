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


# K1's FIR-pass planner (``fengine_fused._fir_plan``), its copy mode by
# start alignment and the wrappers' launches: they run here, without the
# card (the library is stubbed).
@pytest.mark.parametrize("taps, depth", [(1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                                         (16, 16), (17, 0), (40, 0)])
def test_k1_fir_plan_picks_the_body_by_taps(taps, depth):
    """The smallest register ring (4, 8 or 16 rows) that holds the taps, or
    the long body (depth 0) past 16; the shape changes only the run and
    whether the ring's depth runs as the short-run body."""
    for batch, s, fft in ((160, 256, 65536), (10, 4, 1 << 22), (1, 1, 4), (18, 257, 1024)):
        assert ff._fir_plan(batch, s, taps, fft).depth == depth


@pytest.mark.parametrize("s, taps, short", [(1, 16, 1), (2, 16, 1), (4, 16, 1), (4, 3, 1),
                                            (5, 16, 0), (256, 16, 0), (4, 17, 0), (1, 40, 0)])
def test_k1_fir_plan_takes_the_short_run_body_up_to_4_spectra(s, taps, short):
    """Runs of at most 4 spectra (S = 4 at fft 2^22, S = 2 at 2^23) take the
    short-run body of the taps' ring depth; longer runs the ring body; more
    than 16 taps the long body whatever S."""
    plan = ff._fir_plan(10, s, taps, 1 << 22)
    assert plan.short == short and (plan.depth > 0 or not short)
    assert plan.run <= ff.FIR_SHORT or not short


@pytest.mark.parametrize("batch, s, run, streams", [
    (160, 256, 256, 1),  # the flagship: one run a stream, no halo read twice
    (160, 16384, 256, 1),  # fft 1024 at full width: 64 runs a stream
    (18, 257, 256, 1),  # two runs, the second of one spectrum
    (10, 4, 4, 10),  # fft 2^22 in bf16 groups: the group's streams in one block
    (5, 4, 4, 5),  # ... and in f32 groups
    (160, 4, 4, 64),
    (16, 2, 2, 16),  # K7 at fft 2^23
    (18, 5, 5, 18),
    (3, 100, 100, 2),
    (1, 1, 1, 1),
])
def test_k1_fir_plan_takes_runs_of_up_to_256_spectra_by_s(batch, s, run, streams):
    """A block takes a run of at most 256 spectra, and where S is smaller as
    many streams as make about 256 spectra (at most the batch); the blocks
    cover every (stream, spectrum) once."""
    plan = ff._fir_plan(batch, s, 16, 65536)
    assert (plan.run, plan.streams) == (run, streams)
    assert plan.run * plan.streams <= max(ff.FIR_RUN, plan.run)
    covered = [(b, sp) for b0 in range(0, batch, plan.streams) for s0 in range(0, s, plan.run)
               for b in range(b0, min(batch, b0 + plan.streams))
               for sp in range(s0, min(s, s0 + plan.run))]
    assert sorted(covered) == [(b, sp) for b in range(batch) for sp in range(s)]


@pytest.mark.parametrize("args", [(0, 4, 16, 1024), (2, 0, 16, 1024), (2, 4, 0, 1024),
                                  (2, 4, 16, 1022), (2, 4, 16, 0)])
def test_k1_fir_plan_refuses_a_shape_with_no_plan(args):
    with pytest.raises(ValueError, match="no plan"):
        ff._fir_plan(*args)


def test_k1_fir_copy_words_follow_each_streams_start_alignment():
    """One word a row where a stream's first sample is 4-byte aligned, two
    where it is not: starts 0..15 on an aligned base, an odd stream stride,
    a base one byte in; the flagship's coarse delays in [0, 8192) leave
    about 3/4 of the streams on two words."""
    raw = torch.zeros((16, 1027), dtype=torch.int8)
    assert raw.data_ptr() % 4 == 0
    flat = raw.view(-1)[: 16 * 1024].view(16, 1024)
    starts = torch.arange(16)
    assert ff.fir_copy_words(flat, starts).tolist() == [1, 2, 2, 2] * 4
    assert ff.fir_copy_words(raw[:, :1024], torch.zeros(16, dtype=torch.int64)).tolist() == [
        1 if (3 * b) % 4 == 0 else 2 for b in range(16)]
    assert ff.fir_copy_words(flat.view(-1)[1:1 + 15 * 1024].view(15, 1024),
                             starts[:15]).tolist() == [2 if (b + 1) % 4 else 1 for b in range(15)]
    rng = np.random.default_rng(2021)
    cd = torch.from_numpy(rng.integers(0, 8192, 160))
    two = int((ff.fir_copy_words(torch.zeros((160, 8192 + 64), dtype=torch.int8), cd) == 2).sum())
    assert 100 <= two <= 140


class _StubLib:
    """The kernel library's FIR entry points, recording their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("k1_fir"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def stub_lib(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(ff._build, "library", lambda: lib)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("dtype, entry, counter", [
    (torch.bfloat16, "k1_fir_launch", "k1_fir"), (torch.float32, "k1_fir_f32_launch", "k1_fir_f32")])
@pytest.mark.parametrize("taps, batch, s", [(16, 160, 256), (17, 10, 4), (5, 3, 300)])
def test_k1_fir_pass_launches_its_plan(stub_lib, dtype, entry, counter, taps, batch, s):
    """``_fir_pass`` hands the plane's entry point the shape and exactly
    :func:`_fir_plan`'s depth, run and streams, and counts one launch on the
    plane's counter."""
    fft = 1024
    x = torch.zeros((batch, (s + taps - 1) * fft + 8), dtype=torch.int8)
    starts = torch.zeros(batch, dtype=torch.int64)
    win = torch.zeros((taps, fft), dtype=torch.float32)
    plane = torch.empty((batch, s, fft), dtype=dtype)
    before = getattr(ff, counter).launches
    ff._fir_pass(x, starts, win, plane)
    assert getattr(ff, counter).launches == before + 1
    [(name, args)] = stub_lib.calls
    assert name == entry and args[1] == x.stride(0)
    assert args[5:13] == (batch, s, taps, fft, *ff._fir_plan(batch, s, taps, fft))


@pytest.mark.parametrize("stop, num", [("dma", 1), ("fir", 2)])
def test_k1_fir_stops_launch_the_plan(stub_lib, stop, num):
    """P5's FIR-pass stops take the same plan as the pass, then the stop."""
    fft, taps, s, batch = 1024, 16, 5, 3
    x = torch.zeros((batch, (s + taps) * fft), dtype=torch.int8)
    starts = torch.zeros(batch, dtype=torch.int64)
    win = torch.zeros((taps, fft), dtype=torch.float32)
    outr = torch.empty((batch, s, fft // 2), dtype=torch.int8)
    plane = torch.empty((batch, s, fft), dtype=torch.bfloat16)
    ff._stop_pass(x, starts, win, plane, outr, outr.clone(), n1=8, n2=128, stop=stop)
    [(name, args)] = stub_lib.calls
    assert name == "k1_fir_stop_launch"
    assert args[7:] == (batch, s, taps, fft, *ff._fir_plan(batch, s, taps, fft), num, 0)


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


@pytest.mark.parametrize("body, want", [
    ("two_pass", 32), ("two_pass_f32", 16), ("three_pass", 10), ("three_pass_f32", 5),
])
def test_route_group_sizes_each_routes_scratch(body, want):
    """The group of a K1 or K7 route (``_launch``, ``_launch_dit``): the FIR
    plane in the route's operand type, with T re and im beside it on the
    three-pass routes, at the flagship's streams (fft 65536, S = 256) and
    at fft 2^22, S = 4."""
    s, fft = (4, 1 << 22) if body.startswith("three") else (256, 65536)
    item = 4 if body.endswith("_f32") else 2
    group = ff._route_group(body, 160, s, fft)
    assert group == want
    assert group == ff._plane_group(160, s, fft, (3 if body.startswith("three") else 1) * item)


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
