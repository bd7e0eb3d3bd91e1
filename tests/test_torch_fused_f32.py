"""K1's f32 form (``fengine="fused_f32"``) on the CPU: the port's engines vs the JAX engines.

The JAX FB and FXB engines run ``fengine="fused_f32", fengine_interpret=True``
(the Pallas K1 in interpret mode, f32 DFT operands) at the sizes of
``tests/test_models.py:293`` (3 antennas, 1024 channels, 2 beams, 4 taps,
S = 8, f32 planar B stage). Their window, steering planes and fine-rotation
planes are carried into the port by :mod:`dpdk_dc_sand_tpu_torch.convert`,
so both packages feed K1 identical operands. Both sum the same f32 products
in their own order, so the F planes agree within 1 int8 code on <= 1e-3 of
samples (a code flips only where a value lies within an f32 ulp of a
rounding tie); a flipped code moves a beam by at most |w| <= 1 per antenna
term, hence max |d| <= 2 + 1e-3 with |d| > 1e-3 on <= 5e-3 of the beams, the
bound of ``tests/test_torch_fbengine.py``. The FXB engine's visibilities are
held as ``tests/test_torch_fxbengine.py`` holds them: each package's the
exact gram of its own F planes.

The CUDA side of the f32 form (the FIR pass's f32 plane, the FFMA DFT pass,
the three-pass route's FFMA stages) is held against the plain versions in
``tests/test_torch_cuda.py``; here its wrappers, its routing and its
scratch are checked on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FXBEngine as JFXBEngine
from dpdk_dc_sand_tpu.models.fbengine import FBEngine as JFBEngine
from dpdk_dc_sand_tpu.models.fbengine import _f_stage as j_f_stage
from dpdk_dc_sand_tpu.ops.fengine_pallas import fine_rotation_planes as j_fine_rotation_planes
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.convert import from_reference_state
from dpdk_dc_sand_tpu_torch.models import FBEngine, FXBEngine
from dpdk_dc_sand_tpu_torch.models.fbengine import _f_stage
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

CFG = ArrayConfig(n_ants=3, n_channels=1024, n_beams=2, n_taps=4)
JCFG = JArrayConfig(**dataclasses.asdict(CFG))
KW = dict(n_spectra=8, fengine="fused_f32", bstage="planar", precision="f32")
QUANT = 1.0 / 16.0  # the engines' default gain
MARGIN = 8192  # as test_models.py:293: the in-kernel coarse delay's padding and budget


def _codes_close(got, want):
    d = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    assert d.max() <= 1 and (d != 0).mean() <= 1e-3, (d.max(), (d != 0).mean())


def _beams_close(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 2.0 + 1e-3, d.max()
    assert (d > 1e-3).mean() <= 5e-3, (d > 1e-3).mean()


def _gram(qr, qi):
    """int64 gram of ``[A, P, S, C]`` planes -> (V_re, V_im) ``[C, I, I]`` f32."""
    a, p, s, c = qr.shape
    r, m = (np.asarray(q).astype(np.int64).reshape(a * p, s, c) for q in (qr, qi))
    g = lambda x, y: np.einsum("isc,jsc->cij", x, y)  # noqa: E731
    return (g(r, r) + g(m, m)).astype(np.float32), (g(m, r) - g(r, m)).astype(np.float32)


def _f_planes(port, ref, adc, cd, fd, ph):
    """The F planes each engine's step computed: the same F stage calls again."""
    port_planes = _f_stage(
        torch.as_tensor(adc), torch.as_tensor(cd), port.window, port._fine_rot(fd, ph),
        cfg=CFG, n_spectra=KW["n_spectra"], quant_scale=QUANT, fengine="fused_f32",
    )
    ref_planes = j_f_stage(
        jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
        window=ref.window, cfg=JCFG, n_spectra=KW["n_spectra"], quant_scale=QUANT,
        use_pallas=None, fengine="fused_f32", fengine_interpret=True,
        ct_batch_a=ref.ct_batch_a, fengine_rolling=ref.fengine_rolling,
    )
    return port_planes, ref_planes


@pytest.mark.parametrize("engine", ["fb-flat", "fb-rowed", "fxb-flat"])
def test_engine_fused_f32_matches_reference(engine):
    """One step of each engine with ``fengine="fused_f32"`` and a second after
    a delay update: F planes within 1 code on <= 1e-3, beams within the flip
    bound, FXB visibilities the exact gram of each package's own planes."""
    kind, layout = engine.split("-")
    rowed = layout == "rowed"
    if kind == "fb":
        ref = JFBEngine(JCFG, fengine_interpret=True, **KW)
        port = FBEngine(CFG, device="cpu", **KW)
    else:
        ref = JFXBEngine(JCFG, fengine_interpret=True, **KW)
        port = FXBEngine(CFG, device="cpu", **KW)
    assert port.fengine == ref.fengine == "fused_f32"
    assert port.bstage == ref.bstage == "planar"
    layout_kw = dict(rowed=True) if rowed else {}
    _, cd, fd, ph, dv = ref.example_inputs(margin=MARGIN, **layout_kw)
    cd = (cd % 1800).astype(np.int32)  # test_models.py:293's delays
    t_s = 0.0
    for step in range(2):
        if step == 1:  # delay update: new steering phases, fine delays, epoch
            dv = dv.copy()
            dv[..., 2] += 0.3
            fd = (0.5 * fd).astype(np.float32)
            ph = (-np.pi * fd / 2).astype(np.float32)
            t_s = 1e-3
        ref.set_beam_delays(dv, t_s=t_s)
        adc = ref.example_inputs(seed=10 + step, margin=MARGIN, **layout_kw)[0]
        want = ref.step(jnp.asarray(adc), cd, fd, ph)
        if kind == "fb":
            rot = [np.asarray(r) for r in ref._rot_planes]
            coeffs = [np.asarray(w) for w in ref._coeff_blocks]
        else:
            lead = (CFG.n_ants, CFG.n_pols)
            rot = [np.asarray(r) for r in j_fine_rotation_planes(
                jnp.broadcast_to(jnp.asarray(fd)[:, None], lead),
                jnp.broadcast_to(jnp.asarray(ph)[:, None], lead),
                n_channels=CFG.n_channels, quant_scale=QUANT,
            )]
            coeffs = [np.asarray(w) for w in ref._coeffs]
        from_reference_state(port, np.asarray(ref.window), coeffs, rot, delay_vals=dv,
                             frac_delays=fd, phases=ph, t_s=t_s)
        got = port.step(adc, cd, fd, ph)
        port_planes, ref_planes = _f_planes(port, ref, adc, cd, fd, ph)
        for g, w in zip(port_planes, ref_planes):
            assert g.shape == w.shape == (CFG.n_ants, CFG.n_pols, KW["n_spectra"],
                                          CFG.n_channels)
            _codes_close(g.numpy(), w)
        if kind == "fb":
            assert got.shape == want.shape
            _beams_close(got.numpy(), np.asarray(want))
        else:
            (gb, gr, gi), (wb, wr, wi) = got, want
            assert gb.shape == wb.shape
            _beams_close(gb.numpy(), np.asarray(wb))
            for gv, wv, gp, rp in zip((gr, gi), (wr, wi), _gram(*port_planes),
                                      _gram(*ref_planes)):
                np.testing.assert_array_equal(gv.numpy(), gp)
                np.testing.assert_array_equal(np.asarray(wv), rp)


@pytest.mark.parametrize("batch, s, fft, want", [
    (160, 256, 65536, 16),  # the flagship: 16 streams' f32 planes, 1.07 GB
    (5, 256, 65536, 5),
    (4, 8, 1 << 20, 4),
    (3, 2048, 1 << 20, 1),  # one f32 plane is more than the scratch: one at a time
])
def test_k1_f32_plane_group_bounds_the_scratch(batch, s, fft, want):
    """An f32 plane takes 4 bytes a sample: half the bf16 group fits."""
    group = ff._plane_group(batch, s, fft, torch.float32.itemsize)
    assert group == want
    assert group == 1 or group * s * fft * 4 <= ff.K1_SCRATCH_BYTES
    assert ff._plane_group(batch, s, fft) == ff._plane_group(batch, s, fft, 2)
    assert group <= ff._plane_group(batch, s, fft) <= max(1, 2 * group)


def _operands(fft, taps, s, batch, seed):
    rng = np.random.default_rng(seed)
    n_in = (s + taps - 1) * fft + 777
    x = torch.from_numpy(rng.integers(-64, 64, (batch, n_in), dtype=np.int8))
    starts = torch.from_numpy(rng.integers(0, 777, batch).astype(np.int64))
    rc, rs = (torch.from_numpy(rng.uniform(-0.1, 0.1, (batch, fft // 2)).astype(np.float32))
              for _ in range(2))
    return x, starts, default_window(taps, fft), rc, rs


_K1_COUNTERS = ("k1_fir", "k1_dft", "k1_fir_f32", "k1_dft_f32", "k1_stage_a", "k1_stage_b",
                "k1_stage_a_f32", "k1_stage_b_f32", "fengine_fused")


@pytest.mark.parametrize("quantise", [True, False])
def test_k1_f32_wrappers_take_the_plain_versions_on_cpu(quantise):
    """``k1_fir_f32``, ``k1_dft_f32`` and the three-pass stages
    ``k1_stage_a_f32`` then ``k1_stage_b_f32`` on CPU tensors are the plain
    versions (f32 DFT operands) and count no launch."""
    fft, taps, s = 4096, 4, 3
    x, starts, win, rc, rs = _operands(fft, taps, s, 2, 5 + quantise)
    n1, n2 = ff._split_ct(fft)
    counters = [getattr(ff, k) for k in _K1_COUNTERS]
    launches = [f.launches for f in counters]
    plane = ff.k1_fir_f32(x, starts, win, n_spectra=s)
    assert plane.dtype == torch.float32 and plane.shape == (2, s, fft)
    assert torch.equal(plane, ff.k1_fir_reference(x, starts, win, n_spectra=s,
                                                  dft_dtype="float32"))
    kw = dict(n1=n1, n2=n2, quantise=quantise)
    want = ff.fengine_fused_reference(x, starts, win, rc, rs, n_spectra=s, dft_dtype="float32",
                                      **kw)
    tr, ti = ff.k1_stage_a_f32(plane, n1=n1, n2=n2)
    assert tr.dtype == ti.dtype == torch.float32 and tr.shape == (2, s, n1, n2)
    for got in (ff.k1_dft_f32(plane, rc, rs, **kw), ff.k1_stage_b_f32(tr, ti, rc, rs, **kw)):
        for g, w in zip(got, want):
            assert g.dtype == (torch.int8 if quantise else torch.float32)
            assert torch.equal(g, w)
    assert [f.launches for f in counters] == launches
    with pytest.raises(ValueError, match="unsupported device"):
        ff.k1_fir_f32(x.to("meta"), starts, win, n_spectra=s)
    with pytest.raises(ValueError, match="unsupported device"):
        ff.k1_dft_f32(plane.to("meta"), rc, rs, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        ff.k1_stage_a_f32(plane.to("meta"), n1=n1, n2=n2)
    with pytest.raises(ValueError, match="unsupported device"):
        ff.k1_stage_b_f32(tr.to("meta"), ti.to("meta"), rc, rs, **kw)


@pytest.mark.parametrize("n1, n2, dft_dtype, body", [
    (8, 128, "float32", "two_pass_f32"),  # N1 = 8 (fft 1024): the two passes in both types
    (8, 128, "bfloat16", "two_pass"),
    (16, 128, "bfloat16", "two_pass"),
    (256, 256, "bfloat16", "two_pass"),
])
def test_k1_body_is_decided_without_the_library_where_it_can_be(monkeypatch, _fresh_k1_body, n1,
                                                                n2, dft_dtype, body):
    """Every split, N1 = 8 included, asks the library for its DFT pass's
    plan once (here a stub that has one; the real plans: card tests) and
    takes that type's two passes; the answer is cached."""
    asked = _stub_k1_plans(monkeypatch, 0)
    assert ff._k1_body(n1, n2, dft_dtype) == body
    assert ff._k1_body(n1, n2, dft_dtype) == body
    name = "k1_dft_attributes" if dft_dtype == "bfloat16" else "k1_dft_f32_attributes"
    assert asked == [(name, n1, n2)]


@pytest.fixture
def _fresh_k1_body():
    """Each routing test decides K1's body anew, and leaves no stubbed answer
    in the cache."""
    ff._k1_body.cache_clear()
    yield
    ff._k1_body.cache_clear()


def _stub_k1_plans(monkeypatch, answer, stages=0):
    """Stubs the library's K1 plan queries: the two DFT passes' with
    ``answer``, the three-pass stages' with ``stages`` (0: a plan fits);
    returns the list of (query, n1, n2) it is asked."""
    asked = []

    def query(name, result):
        def ask(n1, n2, out):
            asked.append((name, n1, n2))
            return result
        return staticmethod(ask)

    Lib = type("Lib", (), {
        **{name: query(name, answer) for name in ("k1_dft_attributes", "k1_dft_f32_attributes")},
        **{f"k1_stage_{st}{sfx}_attributes": query(f"k1_stage_{st}{sfx}_attributes", stages)
           for st in "ab" for sfx in ("", "_f32")},
        "dcsand_error_string": staticmethod(lambda err: b"stubbed"),
    })
    ff._k1_body.cache_clear()
    monkeypatch.setattr(ff._build, "library", lambda: Lib)
    return asked


@pytest.mark.parametrize("fits, body", [(True, "two_pass"), (False, "three_pass")])
def test_k1_bf16_at_fft_2_22_follows_the_dft_pass_plan(monkeypatch, _fresh_k1_body, fits, body):
    """bf16 K1 at 2048 x 2048 (fft 2^22) takes its two passes where the DFT
    pass reports a plan and the three-pass route where it reports none and
    both stages' tiles cover the split (stubbed library; on the card it has
    none), decided before any launch; a CUDA error from the query raises."""
    asked = _stub_k1_plans(monkeypatch, 0 if fits else ff._NO_PLAN)
    assert ff._split_ct(1 << 22) == (2048, 2048)
    assert ff._k1_body(2048, 2048, "bfloat16") == body
    stages = [] if fits else [("k1_stage_a_attributes", 2048, 2048),
                              ("k1_stage_b_attributes", 2048, 2048)]
    assert asked == [("k1_dft_attributes", 2048, 2048), *stages]
    _stub_k1_plans(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="k1_dft_attributes"):
        ff._k1_body(2048, 2048, "bfloat16")


def _stub_three_pass_launches(monkeypatch, scratch_streams=None, s=3, fft=4096):
    """The stubbed library of :func:`_stub_k1_plans` with the DFT passes
    reporting no plan, plus recording launch functions for the FIR pass and
    the two stages: returns the list of (name, args) they are called with.
    ``scratch_streams`` sets K1_SCRATCH_BYTES to that many streams of the
    bf16 three-pass scratch."""
    _stub_k1_plans(monkeypatch, ff._NO_PLAN)
    lib = ff._build.library()
    calls = []
    for name in ("k1_fir_launch", "k1_fir_f32_launch", "k1_stage_a_launch",
                 "k1_stage_a_f32_launch", "k1_stage_b_launch", "k1_stage_b_f32_launch"):
        setattr(lib, name, staticmethod(lambda *args, name=name: calls.append((name, args)) or 0))
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    if scratch_streams is not None:
        monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", scratch_streams * 3 * 2 * s * fft)
    return calls


def test_k1_bf16_split_without_a_plan_launches_the_simt_body(monkeypatch, _fresh_k1_body):
    """With the card stubbed and the bf16 DFT pass reporting no plan, a bf16
    K1 call takes the three-pass route: the FIR pass, stage A and stage B
    once each, in that order, on one group (the FIR plane, then T re and im
    ``[B, S, N1, N2]`` bf16 beside it), and the two-pass DFT pass never."""
    fft, taps, s = 4096, 4, 3
    x, starts, win, rc, rs = _operands(fft, taps, s, 2, 17)
    n1, n2 = ff._split_ct(fft)
    calls = _stub_three_pass_launches(monkeypatch)
    counters = [getattr(ff, k) for k in _K1_COUNTERS]
    before = [f.launches for f in counters]
    outr, outi = ff._launch(x, starts, win, rc, rs, n_spectra=s, n1=n1, n2=n2,
                            dft_dtype="bfloat16", quantise=True)
    ran = {k: f.launches - b for k, f, b in zip(_K1_COUNTERS, counters, before)}
    assert ran == dict(k1_fir=1, k1_dft=0, k1_fir_f32=0, k1_dft_f32=0, k1_stage_a=1,
                       k1_stage_b=1, k1_stage_a_f32=0, k1_stage_b_f32=0, fengine_fused=1)
    assert [c[0] for c in calls] == ["k1_fir_launch", "k1_stage_a_launch", "k1_stage_b_launch"]
    assert calls[1][1][-4:-1] == (2 * s, n1, n2)  # spectra, N1, N2
    assert calls[2][1][-6:-1] == (2, s, n1, n2, 1)  # batch, S, N1, N2, quantise
    assert outr.shape == outi.shape == (2, s, fft // 2)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k1_three_pass_launches_each_pass_once_a_group_in_order(monkeypatch, _fresh_k1_body,
                                                                dft_dtype):
    """Five streams through a scratch of two streams' three-pass scratch (the
    plane and T re, im: 3 planes of the operand type) make three groups in
    bf16 (two streams, two, one) and five in f32 (twice the bytes); each
    group launches the FIR pass, stage A, stage B in that order, on its own
    streams' outputs and rotation planes."""
    fft, taps, s, b = 4096, 4, 3, 5
    x, starts, win, rc, rs = _operands(fft, taps, s, b, 23)
    n1, n2 = ff._split_ct(fft)
    calls = _stub_three_pass_launches(monkeypatch, scratch_streams=2, s=s, fft=fft)
    f32 = dft_dtype == "float32"
    outr, outi = ff._launch(x, starts, win, rc, rs, n_spectra=s, n1=n1, n2=n2,
                            dft_dtype=dft_dtype, quantise=False)
    sfx = "_f32" if f32 else ""
    groups = [1] * 5 if f32 else [2, 2, 1]
    names = [c[0] for c in calls]
    assert names == [f"k1_{n}{sfx}_launch" for _ in groups for n in ("fir", "stage_a", "stage_b")]
    b0 = 0
    for g, (fir, a, bb) in zip(groups, zip(*[iter(calls)] * 3)):
        assert fir[1][5] == g and a[1][-4] == g * s and bb[1][7:9] == (g, s)
        assert bb[1][3] == rc[b0:].data_ptr() and bb[1][5] == outr[b0:].data_ptr()
        assert a[1][5] == bb[1][0] and a[1][6] == bb[1][1]  # stage B reads stage A's T
        b0 += g
    assert outr.dtype == torch.float32 and outr.shape == (b, s, fft // 2)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_k1_split_without_a_route_raises(monkeypatch, _fresh_k1_body, dft_dtype):
    """A split that neither the DFT pass's plan nor the three-pass tiles
    cover (stubbed library) raises ``ValueError`` naming the split, before
    any launch, and K1 refuses it: nothing falls back."""
    asked = _stub_k1_plans(monkeypatch, ff._NO_PLAN, stages=ff._NO_PLAN)
    with pytest.raises(ValueError, match="no route for the split N1 x N2 = 32 x 128"):
        ff._k1_body(32, 128, dft_dtype)
    sfx = "" if dft_dtype == "bfloat16" else "_f32"
    assert asked == [(f"k1_dft{sfx}_attributes", 32, 128), (f"k1_stage_a{sfx}_attributes", 32, 128)]
    fft, taps, s = 4096, 4, 3
    x, starts, win, rc, rs = _operands(fft, taps, s, 2, 29)
    before = ff.fengine_fused.launches
    with pytest.raises(ValueError, match="no route for the split"):
        ff._launch(x, starts, win, rc, rs, n_spectra=s, n1=32, n2=128, dft_dtype=dft_dtype,
                   quantise=True)
    assert ff.fengine_fused.launches == before
