"""The DIT form of the F kernel (K7's plain version) vs the JAX package.

The JAX side runs ``fengine_fused(deint="matmul" | "bitcast")`` in
interpret mode at the geometries the reference's own tests pin
(``tests/test_fengine_fused.py:52-100``): fft 1024 through the selection
product, fft 2048 through the int16 byte split. Both round at the same
points (f32 FIR in tap order, the DFT type's operands, f32 accumulation,
f32 twiddle, combine and rotation), so they differ only in the order of f32
additions: within 1 int8 code on <= 1e-3 of samples.
"""

import ctypes

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


# --- K7's two-pass body: K1's FIR pass, then the tensor-core DFT pass --------


def _frames(fft, batch, seed, s=S, taps=TAPS):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(-64, 64, (batch, s + taps - 1, fft), dtype=np.int8))
    rc, rs = (torch.from_numpy(rng.standard_normal((batch, fft // 2)).astype(np.float32)) / 16
              for _ in "cs")
    return frames, default_window(taps, fft), rc, rs


@pytest.mark.parametrize("fft", [2048, 4096])
def test_k1_fir_pass_on_zero_starts_is_the_dit_fir(fft):
    """K1's FIR pass of the frames viewed as streams starting at 0 is K7's
    f32 tap-order FIR rounded to bf16, bit for bit."""
    frames, win, _, _ = _frames(fft, 3, seed=fft)
    b, n_frames, _ = frames.shape
    plane = ff.k1_fir_reference(frames.reshape(b, n_frames * fft), torch.zeros(b, dtype=torch.int64),
                                win, n_spectra=n_frames - TAPS + 1)
    assert plane.dtype == torch.bfloat16 and plane.shape == (b, S, fft)
    assert torch.equal(plane.to(torch.float32), ff._round_bf16(ff._dit_fir(frames, win)))


@pytest.mark.parametrize("n1, n2", [(16, 64), (32, 64), (64, 64)])
def test_dit_dft_reference_after_k1_fir_is_the_plain_k7(n1, n2):
    """The two-pass body's plain versions compose to K7's, bit for bit."""
    fft = 2 * n1 * n2
    assert ff._deint_mode(fft // 2, "matmul") == ("matmul", n1, n2)
    frames, win, rc, rs = _frames(fft, 2, seed=n1)
    b, n_frames, _ = frames.shape
    plane = ff.k1_fir_reference(frames.reshape(b, -1), torch.zeros(b, dtype=torch.int64), win,
                                n_spectra=n_frames - TAPS + 1)
    got = ff.dit_dft_reference(plane, rc, rs, n1=n1, n2=n2)
    want = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and torch.equal(g, w)


@pytest.mark.parametrize("deint", ["matmul", "bitcast"])
def test_two_pass_plain_matches_jax_dit_kernel(deint):
    """k1_fir_reference then dit_dft_reference against the JAX DIT kernel
    (interpret mode) at fft 2048, through each name's split: within 1 code
    on <= 1e-3 of samples."""
    fft = 2048
    frames, fd, ph = _inputs(fft, seed=21 + len(deint))
    kw = dict(n_channels=fft // 2, quant_scale=SCALE, deint=deint)
    jr, ji = jfp.fengine_fused(jnp.asarray(frames), j_default_window(TAPS, fft),
                               jnp.asarray(fd), jnp.asarray(ph), interpret=True, **kw)
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    rc, rs = (r.reshape(A * P, fft // 2) for r in ff._rotation_planes(
        torch.from_numpy(fd), torch.from_numpy(ph), fft // 2, SCALE, (fft // 2,)))
    x = torch.from_numpy(frames).reshape(A * P, -1)
    plane = ff.k1_fir_reference(x, torch.zeros(A * P, dtype=torch.int64),
                                default_window(TAPS, fft), n_spectra=S)
    qr, qi = ff.dit_dft_reference(plane, rc, rs, n1=n1, n2=n2)
    _codes_close(qr.reshape(A, P, S, -1).numpy(), jr)
    _codes_close(qi.reshape(A, P, S, -1).numpy(), ji)


@pytest.fixture(autouse=True)
def _fresh_routing():
    """Each test decides K7's routing anew: some stub the library it asks."""
    ff._dit_body.cache_clear()
    yield
    ff._dit_body.cache_clear()


def _stub_plan(monkeypatch, dft, stages=ff._NO_PLAN):
    """Stubs the library's plan queries: the DFT passes' (bf16 and f32)
    answer ``dft``, the three-pass stages' (K1's stage A, K7's stage B)
    ``stages`` (0: a plan fits); returns the list of queries asked."""
    asked = []

    def query(name, answer):
        def ask(n1, n2, out):
            asked.append((name, n1, n2))
            return answer
        return staticmethod(ask)

    class Lib:
        dit_dft_attributes = query("dit_dft", dft)
        dit_dft_f32_attributes = query("dit_dft_f32", dft)
        k1_stage_a_attributes = query("k1_stage_a", stages)
        k1_stage_a_f32_attributes = query("k1_stage_a_f32", stages)
        dit_stage_b_attributes = query("dit_stage_b", stages)
        dit_stage_b_f32_attributes = query("dit_stage_b_f32", stages)

        @staticmethod
        def dcsand_error_string(err):
            return b"stubbed"

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    return asked


@pytest.mark.parametrize("fft, deint, dft_dtype, route", [
    (2048, "matmul", "bfloat16", "two_pass"),      # 16 x 64
    (4096, "matmul", "bfloat16", "two_pass"),      # 32 x 64
    (4096, "bitcast", "bfloat16", "two_pass"),     # 16 x 128
    (65536, "matmul", "bfloat16", "two_pass"),     # 256 x 128
    (1 << 17, "matmul", "bfloat16", "two_pass"),   # 256 x 256
    (1 << 21, "matmul", "bfloat16", "two_pass"),   # 1024 x 1024
    (1 << 22, "matmul", "bfloat16", "two_pass"),   # 2048 x 1024
    (1 << 23, "matmul", "bfloat16", "three_pass"),  # 2048 x 2048: T does not fit
    (1 << 24, "matmul", "bfloat16", "three_pass"),  # 4096 x 2048
    (2048, "bitcast", "bfloat16", "two_pass"),     # 8 x 128
    (1024, "matmul", "bfloat16", "two_pass"),      # 8 x 64
    (1024, "bitcast", "bfloat16", "two_pass"),     # 8 x 64 (falls back to "matmul")
    (512, "auto", "bfloat16", "two_pass"),         # 8 x 32
    (256, "matmul", "bfloat16", "two_pass"),       # 8 x 16
    (128, "matmul", "bfloat16", "two_pass"),       # 8 x 8
    (64, "matmul", "bfloat16", "two_pass"),        # 8 x 4
    (32, "matmul", "bfloat16", None),              # 8 x 2: no route
    (2048, "matmul", "float32", "two_pass_f32"),   # 16 x 64
    (65536, "matmul", "float32", "two_pass_f32"),  # 256 x 128
    (1 << 19, "matmul", "float32", "two_pass_f32"),  # 512 x 512
    (1 << 21, "matmul", "float32", "three_pass_f32"),  # 1024 x 1024: T does not fit
    (1 << 22, "matmul", "float32", "three_pass_f32"),  # 2048 x 1024
    (1 << 23, "matmul", "float32", "three_pass_f32"),  # 2048 x 2048
    (2048, "bitcast", "float32", "two_pass_f32"),  # 8 x 128
    (1024, "matmul", "float32", "two_pass_f32"),   # 8 x 64
    (256, "matmul", "float32", "two_pass_f32"),    # 8 x 16
    (128, "matmul", "float32", "two_pass_f32"),    # 8 x 8
    (64, "matmul", "float32", "two_pass_f32"),     # 8 x 4
    (32, "matmul", "float32", None),               # 8 x 2: no route
])
def test_dit_body_routes_each_split(monkeypatch, fft, deint, dft_dtype, route):
    """Every split asks whether the DFT pass of its operand type has a plan
    and takes that type's two passes where it does; else whether K1's stage
    A (at N1 x 2·N2) and K7's stage B cover it, and takes the three passes;
    else it raises (stubbed library, answering as the card does)."""
    two, three = route is not None and not route.startswith("three"), route is not None
    asked = _stub_plan(monkeypatch, 0 if two else ff._NO_PLAN, 0 if three else ff._NO_PLAN)
    mode, n1, n2 = ff._deint_mode(fft // 2, deint)
    assert mode in ("matmul", "bitcast") and n1 * n2 == fft // 2
    sfx = "" if dft_dtype == "bfloat16" else "_f32"
    want = [(f"dit_dft{sfx}", n1, n2)]
    if route is None:
        with pytest.raises(ValueError, match=f"no route for the split N1 x N2 = {n1} x {n2}"):
            ff._dit_body(n1, n2, dft_dtype)
        assert asked == want + [(f"k1_stage_a{sfx}", n1, 2 * n2)]
        return
    assert ff._dit_body(n1, n2, dft_dtype) == route
    if not two:
        want += [(f"k1_stage_a{sfx}", n1, 2 * n2), (f"dit_stage_b{sfx}", n1, n2)]
    assert asked == want
    assert ff._dit_body(n1, n2, dft_dtype) == route
    assert len(asked) == len(want)  # decided once a split


def test_dit_body_raises_on_a_failed_plan_query(monkeypatch):
    """A CUDA error from any plan query raises; only NO_PLAN sends a split on
    to the next route."""
    _stub_plan(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="dit_dft_attributes"):
        ff._dit_body(16, 64, "bfloat16")
    with pytest.raises(RuntimeError, match="dit_dft_f32_attributes"):
        ff._dit_body(16, 64, "float32")
    _stub_plan(monkeypatch, ff._NO_PLAN, 1)
    with pytest.raises(RuntimeError, match="k1_stage_a_attributes"):
        ff._dit_body(2048, 2048, "bfloat16")
    with pytest.raises(RuntimeError, match="k1_stage_a_f32_attributes"):
        ff._dit_body(1024, 1024, "float32")


@pytest.mark.parametrize("batch, scratch, groups", [(3, None, 1), (5, 2, 3), (4, 1, 4)])
def test_two_pass_launches_one_fir_and_one_dft_pass_per_group(monkeypatch, batch, scratch,
                                                              groups):
    """With the card stubbed, a two-pass K7 call runs K1's FIR pass and the
    DFT pass once per group of streams whose planes fit the scratch, in
    order, each on its own streams with zero starts, and counts one K7 call."""
    fft, taps, s = 2048, 4, 3
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    calls = []

    class Lib:
        @staticmethod
        def k1_fir_launch(x, stride, starts, win, plane, b, n_spectra, n_taps, f, *plan_stream):
            assert plan_stream[:-1] == ff._fir_plan(b, n_spectra, n_taps, f)
            calls.append(("fir", x, stride, starts, plane, b, n_spectra, n_taps, f))
            return 0

        @staticmethod
        def dit_dft_launch(plane, *args):
            b, n_spectra, a1, a2 = args[12:16]
            calls.append(("dft", plane, args[10], b, n_spectra, a1, a2))
            return 0

        @staticmethod
        def dit_dft_attributes(n1, n2, out):
            return 0

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    plane_bytes = s * fft * 2
    if scratch is not None:
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", scratch * plane_bytes)
    frames = torch.zeros((batch, s + taps - 1, fft), dtype=torch.int8)
    rc = torch.zeros((batch, fft // 2))
    before = (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches)
    outr, _ = ff._launch_dit(frames, default_window(taps, fft), rc, rc.clone(), n1=n1, n2=n2,
                             dft_dtype="bfloat16")
    assert (ff.fengine_dit.launches, ff.k1_fir.launches, ff.dit_dft.launches) == (
        before[0] + 1, before[1] + groups, before[2] + groups)
    assert [c[0] for c in calls] == ["fir", "dft"] * groups
    group = ff._plane_group(batch, s, fft)
    stream_bytes = (s + taps - 1) * fft
    for i in range(groups):
        fir, dft = calls[2 * i], calls[2 * i + 1]
        nb = min(group, batch - i * group)
        assert fir[1] == frames.data_ptr() + i * group * stream_bytes and fir[2] == stream_bytes
        assert fir[4] == dft[1] and fir[5:] == (nb, s, taps, fft)
        assert dft[2] == outr.data_ptr() + i * group * s * fft // 2
        assert dft[3:] == (nb, s, n1, n2)


def _stream0(monkeypatch):
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())


@pytest.mark.parametrize("fft, deint, dft_dtype", [(1024, "matmul", "bfloat16"),
                                                   (64, "matmul", "bfloat16"),
                                                   (2048, "bitcast", "float32"),
                                                   (128, "matmul", "float32")])
def test_n1_8_launches_one_fir_and_one_dft_pass_per_group(monkeypatch, fft, deint, dft_dtype):
    """N1 = 8 runs the two passes of its operand type: with the plan queries
    stubbed, five streams through a scratch of two planes take three groups,
    each K1's FIR pass then K7's DFT pass on the same plane, and one K7 call;
    no other pass runs."""
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    assert n1 == 8
    f32 = dft_dtype == "float32"
    sfx = "_f32" if f32 else ""
    calls = []

    class Lib:
        @staticmethod
        def _fir(x, stride, starts, win, plane, b, n_spectra, n_taps, f, *plan_stream):
            assert plan_stream[:-1] == ff._fir_plan(b, n_spectra, n_taps, f)
            calls.append(("fir", plane, b, n_spectra, n_taps, f))
            return 0

        @staticmethod
        def _dft(plane, *args):
            calls.append(("dft", plane, *args[-5:-1]))
            return 0

        @staticmethod
        def _plan(n1, n2, out):
            return 0

    for name, fn in ((f"k1_fir{sfx}_launch", Lib._fir), (f"dit_dft{sfx}_launch", Lib._dft),
                     (f"dit_dft{sfx}_attributes", Lib._plan)):
        setattr(Lib, name, fn)
    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    _stream0(monkeypatch)
    batch, s, taps = 5, 3, 4
    elem = 4 if f32 else 2
    monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * s * fft * elem)
    frames = torch.zeros((batch, s + taps - 1, fft), dtype=torch.int8)
    rc = torch.zeros((batch, fft // 2))
    counters = (ff.fengine_dit, ff.k1_fir, ff.dit_dft, ff.k1_fir_f32, ff.dit_dft_f32,
                ff.dit_stage_a, ff.dit_stage_b, ff.dit_stage_a_f32, ff.dit_stage_b_f32)
    before = [c.launches for c in counters]
    ff._launch_dit(frames, default_window(taps, fft), rc, rc.clone(), n1=n1, n2=n2,
                   dft_dtype=dft_dtype)
    groups = 3
    want = [1, 0, 0, 0, 0, 0, 0, 0, 0]
    want[3 if f32 else 1] = want[4 if f32 else 2] = groups
    assert [c.launches - b for c, b in zip(counters, before)] == want
    assert [c[0] for c in calls] == ["fir", "dft"] * groups
    for i in range(groups):
        fir, dft = calls[2 * i], calls[2 * i + 1]
        nb = min(2, batch - 2 * i)
        assert fir[1] == dft[1] and fir[2:] == (nb, s, taps, fft)
        assert dft[2:] == (nb, s, n1, n2)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch, scratch, groups", [(3, None, 1), (5, 2, 3)])
def test_three_pass_launches_fir_stage_a_and_stage_b_per_group(monkeypatch, dft_dtype, batch,
                                                               scratch, groups):
    """Where the DFT pass has no plan and the stages' tiles cover the split
    (stubbed), a K7 call runs, per group of streams whose plane and T re and
    im fit the scratch, K1's FIR pass, K1's stage-A kernel on the [N1, 2·N2]
    view (M = group x S spectra, the column-doubled twiddles) and K7's stage
    B on the T that stage A wrote; it counts one K7 call and one of each of
    its stages a group (K1's own stage counters stay)."""
    fft, taps, s = 2048, 4, 3
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    f32 = dft_dtype == "float32"
    sfx = "_f32" if f32 else ""
    calls = []

    class Lib:
        @staticmethod
        def _fir(x, stride, starts, win, plane, b, n_spectra, n_taps, f, *plan_stream):
            assert plan_stream[:-1] == ff._fir_plan(b, n_spectra, n_taps, f)
            calls.append(("fir", x, plane, b, n_spectra, n_taps, f))
            return 0

        @staticmethod
        def _stage_a(plane, d1c, d1s, twc, tws, tr, ti, m, a1, a2, stream):
            tw = (ctypes.c_float * (n1 * 2 * n2)).from_address(twc)
            calls.append(("a", plane, tr, ti, m, a1, a2, np.ctypeslib.as_array(tw).copy()))
            return 0

        @staticmethod
        def _stage_b(tr, ti, *args):
            calls.append(("b", tr, ti, args[-7], *args[-5:-1]))
            return 0

        @staticmethod
        def _plan(n1, n2, out):
            return 0

        @staticmethod
        def _no_plan(n1, n2, out):
            return ff._NO_PLAN

    for name, fn in ((f"k1_fir{sfx}_launch", Lib._fir), (f"k1_stage_a{sfx}_launch", Lib._stage_a),
                     (f"dit_stage_b{sfx}_launch", Lib._stage_b),
                     (f"dit_dft{sfx}_attributes", Lib._no_plan),
                     (f"k1_stage_a{sfx}_attributes", Lib._plan),
                     (f"dit_stage_b{sfx}_attributes", Lib._plan)):
        setattr(Lib, name, fn)
    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    _stream0(monkeypatch)
    elem = 4 if f32 else 2
    if scratch is not None:
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", scratch * 3 * s * fft * elem)
    frames = torch.zeros((batch, s + taps - 1, fft), dtype=torch.int8)
    rc = torch.zeros((batch, fft // 2))
    counters = (ff.fengine_dit, ff.k1_fir, ff.k1_fir_f32, ff.dit_stage_a, ff.dit_stage_b,
                ff.dit_stage_a_f32, ff.dit_stage_b_f32, ff.dit_dft, ff.dit_dft_f32, ff.k1_stage_a,
                ff.k1_stage_b)
    before = [c.launches for c in counters]
    outr, _ = ff._launch_dit(frames, default_window(taps, fft), rc, rc.clone(), n1=n1, n2=n2,
                             dft_dtype=dft_dtype)
    want = [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    for i in ((2, 5, 6) if f32 else (1, 3, 4)):
        want[i] = groups
    assert [c.launches - b for c, b in zip(counters, before)] == want
    assert [c[0] for c in calls] == ["fir", "a", "b"] * groups
    group = ff._plane_group(batch, s, fft, 3 * elem)
    assert group == (batch if scratch is None else scratch)
    stream_bytes = (s + taps - 1) * fft
    k = ff.dit_constants(n1, n2, "cpu")
    for i in range(groups):
        fir, sa, sb = calls[3 * i: 3 * i + 3]
        nb = min(group, batch - i * group)
        assert fir[1] == frames.data_ptr() + i * group * stream_bytes
        assert fir[2] == sa[1] and fir[3:] == (nb, s, taps, fft)
        assert sa[2:7] == (sb[1], sb[2], nb * s, n1, 2 * n2)
        np.testing.assert_array_equal(sa[7], k.twc.repeat_interleave(2, dim=1).numpy().ravel())
        assert sb[3] == outr.data_ptr() + i * group * s * fft // 2
        assert sb[4:] == (nb, s, n1, n2)


def test_n1_8_dft_pass_gets_zero_padded_n2_point_matrices():
    """Below N2 = 16 (fft <= 256 at N1 = 8) the DFT pass's bf16 N2-point
    matrices are the N2 x N2 ones zero-padded to 16 x 16; from 16 on they
    are the matrices themselves."""
    for n2 in (4, 8, 16, 64):
        k = ff.dit_constants(8, n2, "cpu")
        d1c, d1s, d2c, d2s = ff._dit_bf16(8, n2, "cpu")
        n2p = max(n2, 16)
        assert torch.equal(d1c, k.d1c.to(torch.bfloat16))
        assert torch.equal(d1s, k.d1s.to(torch.bfloat16))
        for got, want in ((d2c, k.d2c), (d2s, k.d2s)):
            assert got.shape == (n2p, n2p) and got.is_contiguous()
            assert torch.equal(got[:n2, :n2], want.to(torch.bfloat16))
            assert not got[n2:].any() and not got[:, n2:].any()


def test_dft_pass_gets_aligned_rotation_planes(monkeypatch):
    """Rotation planes 4 bytes past an 8-byte boundary reach the DFT pass
    (which reads them as float2) as aligned copies of the same values, from
    both the K7 call and the pass's own wrapper (stubbed card)."""
    fft, b, taps = 2048, 2, 4
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    n = fft // 2
    seen = []

    class Lib:
        @staticmethod
        def k1_fir_launch(*args):
            return 0

        @staticmethod
        def dit_dft_launch(plane, *args):
            for ptr in args[8:10]:
                vals = (ctypes.c_float * (b * n)).from_address(ptr)
                seen.append((ptr % 8, np.ctypeslib.as_array(vals).copy()))
            return 0

        @staticmethod
        def dit_dft_attributes(n1, n2, out):
            return 0

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(23)
    want = [torch.from_numpy(rng.standard_normal((b, n), dtype=np.float32)) for _ in range(2)]
    odd = []
    for w in want:
        view = torch.empty(b * n + 1)[1:].view(b, n)
        view.copy_(w)
        assert view.data_ptr() % 8 == 4
        odd.append(view)
    frames = torch.zeros((b, S + taps - 1, fft), dtype=torch.int8)
    ff._launch_dit(frames, default_window(taps, fft), *odd, n1=n1, n2=n2, dft_dtype="bfloat16")
    plane = torch.zeros((b, S, fft), dtype=torch.bfloat16)
    outr, outi = (torch.empty((b, S, n), dtype=torch.int8) for _ in range(2))
    ff._dit_dft_pass(plane, *odd, outr, outi, n1=n1, n2=n2)
    assert len(seen) == 4
    for i, (rem, vals) in enumerate(seen):
        assert rem == 0
        np.testing.assert_array_equal(vals, want[i % 2].numpy().ravel())


def test_dit_dft_on_cpu_is_its_plain_version():
    frames, win, rc, rs = _frames(2048, 2, seed=3)
    plane = ff.k1_fir(frames.reshape(2, -1), torch.zeros(2, dtype=torch.int64), win, n_spectra=S)
    before = ff.dit_dft.launches
    got = ff.dit_dft(plane, rc, rs, n1=16, n2=64)
    assert ff.dit_dft.launches == before
    for g, w in zip(got, ff.dit_dft_reference(plane, rc, rs, n1=16, n2=64)):
        assert torch.equal(g, w)


def test_dit_dft_stops_on_cpu_are_their_plain_versions():
    """stagea writes nothing; stageb is each stream's stage-B re, as P2's
    stageb stop on the same frames."""
    frames, win, _, _ = _frames(2048, 2, seed=7)
    plane = ff.k1_fir_reference(frames.reshape(2, -1), torch.zeros(2, dtype=torch.int64), win,
                                n_spectra=S)
    zr, zi = ff.dit_dft_stop(plane, n1=16, n2=64, stop="stagea")
    assert not zr.any() and not zi.any() and zr.shape == (2, S, 1024)
    got = ff.dit_dft_stop(plane, n1=16, n2=64, stop="stageb")
    for g, w in zip(got, ff.fengine_dit_ablate_reference("stageb", frames, win, n1=16, n2=64)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown stop"):
        ff.dit_dft_stop(plane, n1=16, n2=64, stop="full")


def test_fengine_dit_ablate_full_takes_rotation_planes_alone():
    """P2's "full" is K7 whole and needs ``rot``; no other stop takes it."""
    frames, win, rc, rs = _frames(2048, 2, seed=9)
    _, n1, n2 = ff._deint_mode(1024, "matmul")
    got = ff.fengine_dit_ablate(frames, win, n1=n1, n2=n2, stop="full", rot=(rc, rs))
    for g, w in zip(got, ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rot="):
        ff.fengine_dit_ablate(frames, win, n1=n1, n2=n2, stop="full")
    with pytest.raises(ValueError, match="rot="):
        ff.fengine_dit_ablate(frames, win, n1=n1, n2=n2, stop="fir", rot=(rc, rs))


# --- K7's f32 two-pass body: K1's f32 FIR pass, then the FFMA DFT pass -------


@pytest.mark.parametrize("fft", [2048, 4096])
def test_k1_fir_f32_pass_on_zero_starts_is_the_dit_fir(fft):
    """K1's f32 FIR pass of the frames viewed as streams starting at 0 is
    K7's f32 tap-order FIR bit for bit (no rounding point in f32)."""
    frames, win, _, _ = _frames(fft, 3, seed=fft + 1)
    b, n_frames, _ = frames.shape
    plane = ff.k1_fir_f32(frames.reshape(b, n_frames * fft), torch.zeros(b, dtype=torch.int64),
                          win, n_spectra=n_frames - TAPS + 1)
    assert plane.dtype == torch.float32 and plane.shape == (b, S, fft)
    assert torch.equal(plane, ff._dit_fir(frames, win))


@pytest.mark.parametrize("n1, n2, deint", [(16, 64, "matmul"), (32, 64, "matmul"),
                                           (64, 64, "matmul"), (16, 128, "bitcast")])
def test_dit_dft_f32_reference_after_k1_fir_f32_is_the_plain_k7(n1, n2, deint):
    """The f32 two-pass body's plain versions compose to K7's f32 plain
    version, bit for bit."""
    fft = 2 * n1 * n2
    assert ff._deint_mode(fft // 2, deint) == (deint, n1, n2)
    frames, win, rc, rs = _frames(fft, 2, seed=n1 + n2)
    b, n_frames, _ = frames.shape
    plane = ff.k1_fir_reference(frames.reshape(b, -1), torch.zeros(b, dtype=torch.int64), win,
                                n_spectra=n_frames - TAPS + 1, dft_dtype="float32")
    got = ff.dit_dft_f32_reference(plane, rc, rs, n1=n1, n2=n2)
    want = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype="float32")
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and torch.equal(g, w)


@pytest.mark.parametrize("deint", ["matmul", "bitcast"])
def test_f32_two_pass_plain_matches_jax_dit_kernel(deint):
    """k1_fir_reference (f32) then dit_dft_f32_reference against the JAX DIT
    kernel with f32 operands (interpret mode) at fft 4096, through each
    name's split (32 x 64, 16 x 128): within the reference's f32 contract,
    1 code on <= 1e-4 of samples."""
    fft = 4096
    frames, fd, ph = _inputs(fft, seed=31 + len(deint))
    kw = dict(n_channels=fft // 2, quant_scale=SCALE, deint=deint, dft_dtype="float32")
    jr, ji = jfp.fengine_fused(jnp.asarray(frames), j_default_window(TAPS, fft),
                               jnp.asarray(fd), jnp.asarray(ph), interpret=True, **kw)
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    assert n1 >= 16
    rc, rs = (r.reshape(A * P, fft // 2) for r in ff._rotation_planes(
        torch.from_numpy(fd), torch.from_numpy(ph), fft // 2, SCALE, (fft // 2,)))
    x = torch.from_numpy(frames).reshape(A * P, -1)
    plane = ff.k1_fir_reference(x, torch.zeros(A * P, dtype=torch.int64),
                                default_window(TAPS, fft), n_spectra=S, dft_dtype="float32")
    qr, qi = ff.dit_dft_f32_reference(plane, rc, rs, n1=n1, n2=n2)
    _codes_close(qr.reshape(A, P, S, -1).numpy(), jr, max_frac=1e-4)
    _codes_close(qi.reshape(A, P, S, -1).numpy(), ji, max_frac=1e-4)


@pytest.mark.parametrize("n1, n2, nh", [(16, 64, 2), (8, 8, 2), (8, 4, 1), (1024, 1024, 2)])
def test_dit_d2h_holds_each_half_of_k2_transposed(n1, n2, nh):
    """The f32 stage-B operand (the DFT pass's and the three-pass stage B's):
    half h, row n2 is the cos, then the -sin, of 2*pi*k2*n2/N2 for the
    half's k2; two halves, or one at N2 = 4."""
    k = ff.dit_constants(n1, n2, "cpu")
    d2h = ff._dit_d2h(n1, n2, "cpu")
    h = n2 // nh
    assert d2h.shape == (nh, n2, 2 * h) and d2h.is_contiguous()
    for half in range(nh):
        k2 = slice(half * h, (half + 1) * h)
        assert torch.equal(d2h[half, :, :h], k.d2c[k2, :].t())
        assert torch.equal(d2h[half, :, h:], k.d2s[k2, :].t())


@pytest.mark.parametrize("batch, scratch, groups", [(3, None, 1), (5, 2, 3)])
def test_f32_two_pass_launches_one_fir_and_one_dft_pass_per_group(monkeypatch, batch, scratch,
                                                                  groups):
    """With the card stubbed, an f32 K7 call with a plan runs K1's f32 FIR
    pass and the f32 DFT pass once per group of streams whose 4-byte planes
    fit the scratch, with zero starts, and counts one K7 call; the bf16
    passes and the three-pass stages do not run."""
    fft, taps, s = 2048, 4, 3
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    calls = []

    class Lib:
        @staticmethod
        def k1_fir_f32_launch(x, stride, starts, win, plane, b, n_spectra, n_taps, f,
                              *plan_stream):
            assert plan_stream[:-1] == ff._fir_plan(b, n_spectra, n_taps, f)
            calls.append(("fir", x, stride, plane, b, n_spectra, n_taps, f))
            return 0

        @staticmethod
        def dit_dft_f32_launch(plane, *args):
            calls.append(("dft", plane, args[9], *args[11:15]))
            return 0

        @staticmethod
        def dit_dft_f32_attributes(n1, n2, out):
            return 0

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    if scratch is not None:
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", scratch * s * fft * 4)
    frames = torch.zeros((batch, s + taps - 1, fft), dtype=torch.int8)
    rc = torch.zeros((batch, fft // 2))
    counters = (ff.fengine_dit, ff.k1_fir_f32, ff.dit_dft_f32, ff.k1_fir, ff.dit_dft,
                ff.dit_stage_a_f32, ff.dit_stage_b_f32)
    before = [c.launches for c in counters]
    outr, _ = ff._launch_dit(frames, default_window(taps, fft), rc, rc.clone(), n1=n1, n2=n2,
                             dft_dtype="float32")
    assert [c.launches - b for c, b in zip(counters, before)] == [1, groups, groups, 0, 0, 0, 0]
    assert [c[0] for c in calls] == ["fir", "dft"] * groups
    group = ff._plane_group(batch, s, fft, 4)
    assert group == (batch if scratch is None else scratch)
    stream_bytes = (s + taps - 1) * fft
    for i in range(groups):
        fir, dft = calls[2 * i], calls[2 * i + 1]
        nb = min(group, batch - i * group)
        assert fir[1] == frames.data_ptr() + i * group * stream_bytes and fir[2] == stream_bytes
        assert fir[3] == dft[1] and fir[4:] == (nb, s, taps, fft)
        assert dft[2] == outr.data_ptr() + i * group * s * fft // 2
        assert dft[3:] == (nb, s, n1, n2)


def test_f32_dft_pass_gets_aligned_operands(monkeypatch):
    """A plane 4 bytes past a 16-byte boundary and rotation planes 4 bytes
    past an 8-byte boundary reach the f32 DFT pass (which reads them as
    float4 and float2) as aligned copies of the same values (stubbed card)."""
    fft, b, s = 2048, 2, 3
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    n = fft // 2
    seen = []

    class Lib:
        @staticmethod
        def dit_dft_f32_launch(plane, *args):
            vals = (ctypes.c_float * (b * s * fft)).from_address(plane)
            seen.append((plane % 16, np.ctypeslib.as_array(vals).copy()))
            for ptr in args[7:9]:
                vals = (ctypes.c_float * (b * n)).from_address(ptr)
                seen.append((ptr % 8, np.ctypeslib.as_array(vals).copy()))
            return 0

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(29)
    want = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, fft), (b, n), (b, n))]
    odd = []
    for w in want:
        view = torch.empty(w.numel() + 1)[1:].view(w.shape)
        view.copy_(w)
        assert view.data_ptr() % 8 == 4
        odd.append(view)
    outr, outi = (torch.empty((b, s, n), dtype=torch.int8) for _ in range(2))
    ff._dit_dft_f32_pass(*odd, outr, outi, n1=n1, n2=n2)
    assert [rem for rem, _ in seen] == [0, 0, 0]
    for (_, vals), w in zip(seen, want):
        np.testing.assert_array_equal(vals, w.numpy().ravel())


def test_dit_dft_f32_and_the_stage_wrappers_on_cpu_are_their_plain_versions():
    """``dit_dft_f32`` and the three-pass stage wrappers on CPU tensors are
    the plain versions and count no launch; another device raises."""
    frames, win, rc, rs = _frames(2048, 2, seed=11)
    counters = (ff.dit_dft_f32, ff.dit_stage_a, ff.dit_stage_b, ff.dit_stage_a_f32,
                ff.dit_stage_b_f32, ff.fengine_dit)
    before = [c.launches for c in counters]
    for dt, fir, stage_a, stage_b in (("float32", ff.k1_fir_f32, ff.dit_stage_a_f32,
                                       ff.dit_stage_b_f32),
                                      ("bfloat16", ff.k1_fir, ff.dit_stage_a, ff.dit_stage_b)):
        plane = fir(frames.reshape(2, -1), torch.zeros(2, dtype=torch.int64), win, n_spectra=S)
        if dt == "float32":
            got = ff.dit_dft_f32(plane, rc, rs, n1=16, n2=64)
            for g, w in zip(got, ff.dit_dft_f32_reference(plane, rc, rs, n1=16, n2=64)):
                assert torch.equal(g, w)
        tr, ti = stage_a(plane, n1=16, n2=64)
        for g, w in zip((tr, ti), ff.dit_stage_a_reference(plane, n1=16, n2=64, dft_dtype=dt)):
            assert g.dtype == w.dtype and torch.equal(g, w)
        got = stage_b(tr, ti, rc, rs, n1=16, n2=64)
        for g, w in zip(got, ff.dit_stage_b_reference(tr, ti, rc, rs, n1=16, n2=64,
                                                      dft_dtype=dt)):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="unsupported device"):
            stage_a(plane.to("meta"), n1=16, n2=64)
        with pytest.raises(ValueError, match="unsupported device"):
            stage_b(tr.to("meta"), ti.to("meta"), rc, rs, n1=16, n2=64)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="unsupported device"):
        ff.dit_dft_f32(plane.to("meta").float(), rc, rs, n1=16, n2=64)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fft, deint", [(64, "matmul"), (128, "matmul"), (512, "auto"),
                                        (2048, "bitcast"), (2048, "matmul"), (8192, "matmul")])
def test_plain_stages_compose_to_the_dft_pass(fft, deint, dft_dtype):
    """The three-pass route's plain stages, composed, are the two-pass
    route's plain DFT pass bit for bit (and, after K1's FIR, plain K7), at
    N1 = 8 and above, in both operand types; T comes interleaved, [N1, 2·N2],
    column 2·n2 + q stream q's, in the operand type."""
    _, n1, n2 = ff._deint_mode(fft // 2, deint)
    frames, win, rc, rs = _frames(fft, 2, seed=fft + len(dft_dtype), s=3, taps=4)
    plane = ff.k1_fir_reference(frames.reshape(2, -1), torch.zeros(2, dtype=torch.int64), win,
                                n_spectra=3, dft_dtype=dft_dtype)
    tr, ti = ff.dit_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)
    dtype = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    assert tr.shape == ti.shape == (2, 3, n1, 2 * n2) and tr.dtype == ti.dtype == dtype
    got = ff.dit_stage_b_reference(tr, ti, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    dft = ff.dit_dft_reference if dft_dtype == "bfloat16" else ff.dit_dft_f32_reference
    want = dft(plane, rc, rs, n1=n1, n2=n2)
    full = ff.fengine_dit_reference(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dft_dtype)
    for g, w, f in zip(got, want, full):
        assert g.dtype == torch.int8 and torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n1, n2", [(8, 4), (8, 64), (16, 64), (64, 128)])
def test_k1_stage_a_with_doubled_twiddles_is_k7_stage_a(n1, n2, dft_dtype):
    """What the three-pass route reuses: K1's stage A (its plain version,
    ``_ct_stage_a``, at K1's rounding point) on the plane viewed [N1, 2·N2]
    with the twiddle table whose columns 2·n2 and 2·n2 + 1 both hold
    exp(-2πi·k1·n2/N) is each stream's ``_dit_stage_a``, the streams
    interleaved as ``dit_stage_a_reference`` gives them: the same products,
    twiddle and rounding per value. bf16 T bit for bit; f32 T within 16 ulp
    of the largest |T|, as the CPU BLAS may pick another kernel (another
    order of additions) for the product twice as wide."""
    fft = 2 * n1 * n2
    frames, win, _, _ = _frames(fft, 2, seed=n1 * n2, s=3, taps=4)
    plane = ff.k1_fir_reference(frames.reshape(2, -1), torch.zeros(2, dtype=torch.int64), win,
                                n_spectra=3, dft_dtype=dft_dtype)
    rnd = ff._round_bf16 if dft_dtype == "bfloat16" else (lambda t: t)

    def same(g, w):
        if dft_dtype == "bfloat16":
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=2.0 ** -20 * float(w.abs().max()))

    k = ff.dit_constants(n1, n2, "cpu")
    twc2, tws2 = ff._dit_tw2(n1, n2, "cpu")
    assert torch.equal(twc2[:, 0::2], k.twc) and torch.equal(twc2[:, 1::2], k.twc)
    assert torch.equal(tws2[:, 0::2], k.tws) and torch.equal(tws2[:, 1::2], k.tws)
    k1 = ff.DftConstants(k.d1c, k.d1s, None, twc2, tws2)
    got = [rnd(t) for t in ff._ct_stage_a(plane, k1, n1, 2 * n2, rnd)]
    acc = plane.to(torch.float32)
    for q in (0, 1):
        want = ff._dit_stage_a(acc[..., q::2].reshape(2, 3, n1, n2), k, rnd)
        for g, w in zip(got, want):
            same(g[..., q::2], w)
    for g, w in zip(got, ff.dit_stage_a_reference(plane, n1=n1, n2=n2, dft_dtype=dft_dtype)):
        same(g, w.to(torch.float32))


@pytest.mark.parametrize("stop", ["dma", "conv", "fir", "deint", "stagea", "stageb", "full"])
def test_p2_stops_run_on_k7s_route(monkeypatch, stop):
    """With the card stubbed, P2's first four stops are one cut of K1's FIR
    pass on the frames as zero-start streams (its STOP numbers 5-8, no
    plane); stagea and stageb the FIR pass into a bf16 plane, then K7's DFT
    pass cut at a stage (3: T re; 2: stage B's re) a group of streams; full
    K7's two passes. One P2 call each."""
    fft, taps, s, batch = 2048, 4, 3, 5
    _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
    calls = []

    class Lib:
        @staticmethod
        def k1_fir_stop_launch(x, stride, starts, win, plane, outr, outi, b, ns, nt, f, *rest):
            *plan, st, n2_view, plane_f32, quantise, _ = rest
            assert tuple(plan) == ff._fir_plan(b, ns, nt, f)
            assert (n2_view, plane_f32, quantise) == (0, 0, 1)  # P2's: no probe view, int8
            calls.append(("fir_stop", x, stride, plane, outr, b, ns, nt, f, st))
            return 0

        @staticmethod
        def k1_fir_launch(x, stride, starts, win, plane, b, ns, nt, f, *plan_stream):
            assert plan_stream[:-1] == ff._fir_plan(b, ns, nt, f)
            calls.append(("fir", x, plane, b, ns))
            return 0

        @staticmethod
        def dit_dft_stop_launch(plane, *args):
            calls.append(("dft_stop", plane, args[6], *args[8:13]))
            return 0

        @staticmethod
        def dit_dft_launch(plane, *args):
            calls.append(("dft", plane))
            return 0

        @staticmethod
        def dit_dft_attributes(n1, n2, out):
            return 0

    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    _stream0(monkeypatch)
    monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * s * fft * 2)  # 2 streams a group
    frames = torch.zeros((batch, s + taps - 1, fft), dtype=torch.int8)
    rot = (torch.zeros((batch, fft // 2)), torch.zeros((batch, fft // 2))) if stop == "full" else None
    before = ff.fengine_dit_ablate.launches
    outr, _ = ff._launch_dit_ablate(frames, default_window(taps, fft), n1=n1, n2=n2, stop=stop,
                                    rot=rot)
    assert ff.fengine_dit_ablate.launches == before + 1
    stream_bytes = (s + taps - 1) * fft
    if stop in ("dma", "conv", "fir", "deint"):
        assert calls == [("fir_stop", frames.data_ptr(), stream_bytes, None, outr.data_ptr(),
                          batch, s, taps, fft, ff.DIT_STOPS[stop])]
    elif stop == "full":
        assert [c[0] for c in calls] == ["fir", "dft"] * 3
    else:
        assert [c[0] for c in calls] == ["fir", "dft_stop"] * 3
        for i in range(3):
            fir, dft = calls[2 * i], calls[2 * i + 1]
            nb = min(2, batch - 2 * i)
            assert fir[1] == frames.data_ptr() + 2 * i * stream_bytes and fir[3:] == (nb, s)
            assert dft[1] == fir[2] and dft[2] == outr.data_ptr() + 2 * i * s * fft // 2
            assert dft[3:] == (nb, s, n1, n2, ff.DIT_STOPS[stop])
