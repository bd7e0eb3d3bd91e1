"""The slice: the port's FXBEngine, XEngine and VisibilityAccumulator vs the JAX ones.

The JAX FXB engine runs ``fengine="fused", bstage="turned",
precision="bf16"`` with its Pallas kernels in interpret mode. Its window
and steering blocks (``_coeffs``), and the fine-rotation planes it computes
inside its jit (taken from the JAX ``fine_rotation_planes``), are carried
into the port by :mod:`dpdk_dc_sand_tpu_torch.convert`, so both packages
feed their kernels identical operands. The F planes then agree within 1
int8 code on <= 1e-3 of samples. A flipped code moves a beam by up to
|w| <= 1 per term (max |d| <= 2 + 1e-3, |d| > 1e-3 on <= 5e-3 of beams) and
a visibility by up to 127 per flipped code. A visibility integrates 4·S
codes, so at S = 128 a few percent of them see a flip (2.7% at a flip rate
of 6e-5) and some see several (max |d| 378 > 2·127). Instead of the fixed
bound and fraction of ``tests/test_models.py``, the test requires both
packages' visibilities to be the exact gram of their own F planes and each
visibility to lie within its exact flip bound,
``Σ |Δx|·|x_port| + |x_ref|·|Δy|`` over its product terms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FXBEngine as JFXBEngine
from dpdk_dc_sand_tpu.models import VisibilityAccumulator as JVisibilityAccumulator
from dpdk_dc_sand_tpu.models import XEngine as JXEngine
from dpdk_dc_sand_tpu.models.fbengine import _f_stage as j_f_stage
from dpdk_dc_sand_tpu.models.fbengine import resolve_backends as j_resolve_backends
from dpdk_dc_sand_tpu.ops.correlate import correlate as j_correlate
from dpdk_dc_sand_tpu.ops.fengine_pallas import coarse_margin_samples
from dpdk_dc_sand_tpu.ops.fengine_pallas import fine_rotation_planes as j_fine_rotation_planes
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.convert import from_reference_state
from dpdk_dc_sand_tpu_torch.models import FBEngine, FXBEngine, VisibilityAccumulator, XEngine
from dpdk_dc_sand_tpu_torch.models.fbengine import _f_stage, resolve_backends
from dpdk_dc_sand_tpu_torch.ops.corner_turn import corner_turn_x_supported
from dpdk_dc_sand_tpu_torch.ops.xcorr import xcorr_fused_supported, xcorr_supported

CFG = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
JCFG = JArrayConfig(**dataclasses.asdict(CFG))
S = 128  # the smallest S that K3's gate takes
BUDGET = 256
QUANT = 1.0 / 16.0


def _margin():
    m = coarse_margin_samples(CFG.fft_size, CFG.n_taps, S, True) + BUDGET
    return -(-m // 128) * 128


def _close(got, want, bound, frac):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= bound + 1e-3, d.max()
    assert (d > 1e-3).mean() <= frac, (d > 1e-3).mean()


def _golden_vis(qr, qi):
    """int64 gram of ``[A, P, S, C]`` planes -> (V_re, V_im) ``[C, I, I]`` f32."""
    a, p, s, c = qr.shape
    r, m = (np.asarray(q).astype(np.int64).reshape(a * p, s, c) for q in (qr, qi))
    g = lambda x, y: np.einsum("isc,jsc->cij", x, y)  # noqa: E731
    return (g(r, r) + g(m, m)).astype(np.float32), (g(m, r) - g(r, m)).astype(np.float32)


def _vis_close(port_planes, ref_planes, got, want):
    """F planes within 1 code on <= 1e-3; each package's visibilities the exact
    gram of its planes; each visibility within its exact flip bound."""
    a, p, s, c = ref_planes[0].shape
    pr, pm, rr, rm = (
        np.abs(np.asarray(q).astype(np.int64)).reshape(a * p, s, c)
        for q in (*port_planes, *ref_planes)
    )
    dr, dm = (
        np.abs(np.asarray(g).astype(np.int64) - np.asarray(w).astype(np.int64)).reshape(a * p, s, c)
        for g, w in zip(port_planes, ref_planes)
    )
    for d in (dr, dm):
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3
    # |P_x P_y - R_x R_y| <= |dx| |P_y| + |R_x| |dy| for each product term.
    g = lambda x, y: np.einsum("isc,jsc->cij", x, y)  # noqa: E731
    bounds = (
        g(dr, pr) + g(rr, dr) + g(dm, pm) + g(rm, dm),
        g(dm, pr) + g(rm, dr) + g(dr, pm) + g(rr, dm),
    )
    for gv, wv, gold_p, gold_r, bound in zip(
        got, want, _golden_vis(*port_planes), _golden_vis(*ref_planes), bounds
    ):
        np.testing.assert_array_equal(gv.numpy(), gold_p)
        np.testing.assert_array_equal(np.asarray(wv), gold_r)
        d = np.abs(gv.numpy().astype(np.float64) - np.asarray(wv, np.float64))
        assert (d <= bound + 1e-3).all(), (d - bound).max()


def test_fxbengine_matches_reference_over_steps_and_a_delay_update():
    ref = JFXBEngine(JCFG, n_spectra=S, quant_scale=QUANT, precision="bf16", fengine="fused",
                     bstage="turned", fengine_interpret=True)
    port = FXBEngine(CFG, n_spectra=S, device="cpu", quant_scale=QUANT, precision="bf16")
    assert (port.fengine, port.bstage, port.vis_precision) == ("fused", "turned", "int8")
    margin = _margin()
    _, cd, fd, ph, dv = ref.example_inputs(seed=1, margin=margin, delay_budget=BUDGET)
    ref.set_beam_delays(dv)
    port.set_beam_delays(dv)
    t_s = 0.0
    for step in range(3):
        if step == 2:  # delay update: new steering phases, fine delays, epoch
            dv = dv.copy()
            dv[..., 2] += 0.3
            fd = (0.5 * fd).astype(np.float32)
            ph = (-np.pi * fd / 2).astype(np.float32)
            t_s = 1e-3
            ref.set_beam_delays(dv, t_s=t_s)
            port.set_beam_delays(dv, t_s=t_s)
        adc = ref.example_inputs(seed=10 + step, margin=margin)[0]
        wb, wr, wi = (np.asarray(x) for x in ref.step(jnp.asarray(adc), cd, fd, ph))
        lead = (CFG.n_ants, CFG.n_pols)
        rot = j_fine_rotation_planes(
            jnp.broadcast_to(jnp.asarray(fd)[:, None], lead),
            jnp.broadcast_to(jnp.asarray(ph)[:, None], lead),
            n_channels=CFG.n_channels, quant_scale=QUANT,
        )
        from_reference_state(
            port, np.asarray(ref.window), np.asarray(ref._coeffs), [np.asarray(r) for r in rot],
            delay_vals=dv, frac_delays=fd, phases=ph, t_s=t_s,
        )
        gb, gr, gi = port.step(adc, cd, fd, ph)
        i = CFG.n_ants * CFG.n_pols
        assert gb.shape == wb.shape == (CFG.n_pols, CFG.n_channels, S, CFG.n_beams, 2)
        assert gr.shape == gi.shape == (CFG.n_channels, i, i)
        _close(gb.numpy(), wb, 2.0, 5e-3)
        # The F planes each engine correlated: the same F stage calls again.
        port_planes = _f_stage(
            torch.as_tensor(adc), torch.as_tensor(cd), port.window, port._fine_rot(fd, ph),
            cfg=CFG, n_spectra=S, quant_scale=QUANT,
        )
        ref_planes = j_f_stage(
            jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
            window=ref.window, cfg=JCFG, n_spectra=S, quant_scale=QUANT, use_pallas=None,
            fengine="fused", fengine_interpret=True, ct_batch_a=True, fengine_rolling=True,
        )
        _vis_close(port_planes, ref_planes, (gr, gi), (wr, wi))


CFG64 = ArrayConfig(n_ants=4, n_channels=64, n_beams=16, n_taps=8)


def test_fxbengine_at_64_channels_takes_k5b_and_matches_reference():
    """fft 128: the engine resolves the composed F and the turned B, and its X
    stage is the turn (K5a) and the turned gram (K5b), as the reference's at
    any C < 128. The JAX engine runs the same resolved backends."""
    port = FXBEngine(CFG64, n_spectra=S, device="cpu", quant_scale=QUANT, precision="bf16")
    ref = JFXBEngine(JArrayConfig(**dataclasses.asdict(CFG64)), n_spectra=S, quant_scale=QUANT,
                     precision="bf16", fengine=port.fengine, bstage=port.bstage,
                     fengine_interpret=True)
    assert (port.fengine, port.bstage) == ("xla", "turned") == (ref.fengine, ref.bstage)
    a, p, c = CFG64.n_ants, CFG64.n_pols, CFG64.n_channels
    assert corner_turn_x_supported(a, p, S, c) and xcorr_supported(c, S)
    assert not xcorr_fused_supported(a, p, S, c)
    _, cd, fd, ph, dv = ref.example_inputs(seed=5, margin=512)
    ref.set_beam_delays(dv)
    from_reference_state(port, np.asarray(ref.window), np.asarray(ref._coeffs), None,
                         delay_vals=dv, frac_delays=fd, phases=ph)
    for step in range(2):
        adc = ref.example_inputs(seed=20 + step, margin=512)[0]
        wb, wr, wi = (np.asarray(x) for x in ref.step(jnp.asarray(adc), cd, fd, ph))
        gb, gr, gi = port.step(adc, cd, fd, ph)
        assert gr.shape == gi.shape == (64, 8, 8)
        _close(gb.numpy(), wb, 2.0, 5e-3)
        ref_planes = j_f_stage(
            jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
            window=ref.window, cfg=ref.cfg, n_spectra=S, quant_scale=QUANT, use_pallas=False,
            fengine="xla",
        )
        _vis_close(port._f(adc, cd, fd, ph), ref_planes, (gr, gi), (wr, wi))


@pytest.mark.parametrize(
    "kw", [dict(), dict(seed=7, margin=1024, delay_budget=100)], ids=["default", "budget"]
)
def test_example_inputs_match_reference(kw):
    port = FXBEngine(CFG, n_spectra=S, device="cpu")
    ref = JFXBEngine(JCFG, n_spectra=S, fengine="fused", bstage="turned", fengine_interpret=True)
    for g, r in zip(port.example_inputs(**kw), ref.example_inputs(**kw)):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize(
    "n_ants, n_channels, n_beams, n_spectra, layout",
    [(80, 32768, 16, 256, "split"), (80, 32768, 16, 256, "natural"), (4, 1024, 16, 64, "split"),
     (4, 1024, 12, 64, "natural"), (4, 512, 16, 24, "split"), (3, 512, 4, 32, "natural")],
)
def test_resolve_backends_follows_the_reference(n_ants, n_channels, n_beams, n_spectra, layout):
    cfg = ArrayConfig(n_ants=n_ants, n_channels=n_channels, n_beams=n_beams, n_taps=4)
    jcfg = JArrayConfig(**dataclasses.asdict(cfg))
    want = j_resolve_backends(jcfg, n_spectra, "auto", "auto", "auto", interpret=True,
                              beam_layout=layout)
    assert want[0] == "fused"
    assert resolve_backends(cfg, n_spectra, "auto", "auto", layout) == want[:2]


@pytest.mark.parametrize("layout", ["split", "natural"])
def test_fbengine_turned_bstage_matches_fused(layout):
    cfg = ArrayConfig(n_ants=4, n_channels=512, n_beams=16, n_taps=4)
    kw = dict(n_spectra=64, precision="bf16", beam_layout=layout)
    fused = FBEngine(cfg, bstage="fused", device="cpu", **kw)
    turned = FBEngine(cfg, bstage="turned", device="cpu", **kw)
    inputs = fused.example_inputs(seed=4, margin=1024)
    want = fused(*inputs)
    got = turned(*inputs)
    p, c, b = cfg.n_pols, cfg.n_channels, cfg.n_beams
    if layout == "natural":  # turned [C, P·S, 2B]; fused packs 4 channels per row
        assert got.shape == (c, p * 64, 2 * b)
        got = got.reshape(c // 4, 4, p * 64, 2 * b).permute(0, 2, 1, 3).reshape(want.shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_fxbengine_rejects_unported_backends():
    """``bstage="planar"`` runs through the shared B stage: its beams agree
    with the turned form's in f32 within rtol 1e-5 / atol 1e-4 (the same
    products summed in another order, tests/test_models.py:309-325) and the
    visibilities are the same. An unknown ``vis_precision`` raises."""
    planar = FXBEngine(CFG, n_spectra=S, device="cpu", bstage="planar")
    turned = FXBEngine(CFG, n_spectra=S, device="cpu")
    assert (planar.bstage, turned.bstage) == ("planar", "turned")
    inputs = planar.example_inputs(seed=6, margin=_margin())
    (pb, pr, pi), (tb, tr, ti) = planar(*inputs), turned(*inputs)
    np.testing.assert_allclose(pb.numpy(), tb.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pr.numpy(), tr.numpy())
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())
    with pytest.raises(ValueError, match="vis_precision"):
        FXBEngine(CFG, n_spectra=S, device="cpu", vis_precision="f16")


def _blocks(seed, shape):
    return np.random.default_rng(seed).integers(-64, 64, size=shape, dtype=np.int8)


def test_accumulator_dump_cadence_matches_reference():
    blocks = _blocks(2021, (7, 16, 4, 6, 2))
    port, ref = VisibilityAccumulator(n_accum=3), JVisibilityAccumulator(n_accum=3)
    dumps = []
    for seq, block in enumerate(blocks):
        got = port.add_samples(torch.from_numpy(block), seq=seq)
        want = ref.add_samples(jnp.asarray(block), seq=seq)
        assert (got is None) == (want is None)
        if got is not None:
            dumps.append(got)
            assert got[2] == want[2]
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [d[2] for d in dumps] == [0, 3]
    assert port.count == ref.count == 1
    assert dumps[0][0].data_ptr() != dumps[1][0].data_ptr()  # each dump owns its sums


def test_accumulator_precorrelated_path_matches_samples_path():
    blocks = _blocks(7, (4, 8, 4, 6, 2))
    a, b = VisibilityAccumulator(n_accum=4), VisibilityAccumulator(n_accum=4)
    ref = JVisibilityAccumulator(n_accum=4)
    for seq, block in enumerate(blocks):
        da = a.add_samples(block, seq=seq)
        db = b.add(*(torch.from_numpy(np.array(v)) for v in j_correlate(jnp.asarray(block))),
                   seq=seq)
        dr = ref.add(*j_correlate(jnp.asarray(block)), seq=seq)
    assert da is not None and db is not None and dr is not None
    for x, y, z in zip(da[:2], db[:2], dr[:2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(y.numpy(), np.asarray(z))
    assert da[2] == db[2] == dr[2] == 0


def test_accumulator_integrates_fxb_visibilities():
    cfg = ArrayConfig(n_ants=3, n_channels=512, n_beams=2, n_taps=4)
    fxb = FXBEngine(cfg, n_spectra=128, device="cpu")
    adc, cd, fd, ph, dv = fxb.example_inputs(margin=2048)
    acc = VisibilityAccumulator(n_accum=2)
    _, vre, vim = fxb(adc, cd, fd, ph, dv)
    assert acc.add(vre, vim, seq=10) is None
    _, vre2, vim2 = fxb(adc, cd, fd, ph, dv)
    vre_w, vim_w, first = acc.add(vre2, vim2, seq=11)
    assert first == 10
    np.testing.assert_array_equal(vre_w.numpy(), 2 * vre.numpy())
    np.testing.assert_array_equal(vim_w.numpy(), 2 * vim.numpy())


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_xengine_integrate_matches_reference(precision):
    cfg = ArrayConfig(n_ants=3, n_channels=64, n_beams=2, n_taps=4)
    port = XEngine(cfg, n_accum=4, precision=precision, device="cpu")
    ref = JXEngine(JArrayConfig(**dataclasses.asdict(cfg)), n_accum=4, precision=precision)
    samples = port.example_inputs(n_chan=8, t_block=16, seed=3)
    np.testing.assert_array_equal(samples, ref.example_inputs(n_chan=8, t_block=16, seed=3))
    for g, w in zip(port.integrate(samples), ref.integrate(jnp.asarray(samples))):
        assert g.shape == (8, 6, 6)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
