"""The slice: the port's FBEngine vs the JAX FBEngine on the flagship backends.

The JAX engine runs ``fengine="fused", bstage="fused",
beam_layout="natural", precision="bf16", ct_batch_a=True`` with its Pallas
kernels in interpret mode. Its window, steering blocks and fine-rotation
planes are carried into the port by :mod:`dpdk_dc_sand_tpu_torch.convert`,
so both packages feed their kernels identical operands. The F planes then
agree to within 1 int8 code on <= 1e-3 of samples; a code flip moves a
beam by up to |w| <= 1 per antenna term, hence max |d| <= 2 + 1e-3 with
|d| > 1e-3 on <= 5e-3 of the beams.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models.fbengine import FBEngine as JFBEngine
from dpdk_dc_sand_tpu.models.fbengine import _f_stage as j_f_stage
from dpdk_dc_sand_tpu.ops.fengine_pallas import coarse_margin_samples
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.convert import from_reference_state
from dpdk_dc_sand_tpu_torch.models import FBEngine
from dpdk_dc_sand_tpu_torch.models.fbengine import _f_stage
from dpdk_dc_sand_tpu_torch.ops.bstage import beamform_turned_fused_reference
from dpdk_dc_sand_tpu_torch.ops.requant import requantise

CFG = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
JCFG = JArrayConfig(**dataclasses.asdict(CFG))
S = 64
BUDGET = 256


def _margin():
    m = coarse_margin_samples(CFG.fft_size, CFG.n_taps, S, True) + BUDGET
    return -(-m // 128) * 128


def _beams_close(got, ref):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 2.0 + 1e-3, d.max()
    assert (d > 1e-3).mean() <= 5e-3, (d > 1e-3).mean()


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(seed=7, margin=1024, delay_budget=100, rowed=True)],
    ids=["flat", "rowed"],
)
def test_example_inputs_match_reference(kw):
    port = FBEngine(CFG, n_spectra=S, device="cpu")
    ref = JFBEngine(JCFG, n_spectra=S, fengine="fused", bstage="fused",
                    fengine_interpret=True)
    for g, r in zip(port.example_inputs(**kw), ref.example_inputs(**kw)):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_delay_update_state_matches_reference():
    """Steering blocks and rotation planes computed by each package agree
    to f32 cos/sin ulps (atol 1e-5); the window is the same array."""
    port = FBEngine(CFG, n_spectra=S, device="cpu", precision="f32")
    ref = JFBEngine(JCFG, n_spectra=S, precision="f32", fengine="fused",
                    bstage="fused", fengine_interpret=True)
    _, _, fd, ph, dv = ref.example_inputs(seed=3)
    w = np.linspace(0.5, 1.0, CFG.n_ants).astype(np.float32)
    port.set_beam_delays(dv, w, t_s=2e-3)
    ref.set_beam_delays(dv, w, t_s=2e-3)
    np.testing.assert_allclose(port.coeff_blocks.numpy(), np.asarray(ref._coeff_blocks),
                               rtol=0, atol=1e-5)
    for g, r in zip(port._fine_rot(fd, ph), ref._fine_rot(fd, ph)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.window.numpy(), np.asarray(ref.window))


def test_fbengine_matches_reference_over_steps_and_a_delay_update():
    ref = JFBEngine(JCFG, n_spectra=S, precision="bf16", fengine="fused",
                    bstage="fused", beam_layout="natural", ct_batch_a=True,
                    fengine_interpret=True)
    port = FBEngine(CFG, n_spectra=S, device="cpu", precision="bf16", beam_layout="natural")
    margin = _margin()
    _, cd, fd, ph, dv = ref.example_inputs(seed=1, margin=margin, delay_budget=BUDGET,
                                           rowed=True)
    port.set_beam_delays(dv)
    ref.set_beam_delays(dv)
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
        adc = ref.example_inputs(seed=10 + step, margin=margin, rowed=True)[0]
        want = np.asarray(ref.step(jnp.asarray(adc), cd, fd, ph))
        from_reference_state(
            port, np.asarray(ref.window), np.asarray(ref._coeff_blocks),
            [np.asarray(r) for r in ref._rot_planes],
            delay_vals=dv, frac_delays=fd, phases=ph, t_s=t_s,
        )
        got = port.step(adc, cd, fd, ph)
        assert got.shape == want.shape == (CFG.n_channels // 4, CFG.n_pols * S, 128)
        _beams_close(got.numpy(), want)


def test_split_layout_and_beam_requant_follow_natural():
    margin = _margin()
    nat = FBEngine(CFG, n_spectra=S, device="cpu", precision="bf16", beam_layout="natural")
    adc, cd, fd, ph, dv = nat.example_inputs(seed=5, margin=margin, rowed=True)
    packed = nat(adc, cd, fd, ph, dv)
    split = FBEngine(CFG, n_spectra=S, device="cpu", precision="bf16",
                     bstage="fused")(adc, cd, fd, ph, dv)
    p, c, b = CFG.n_pols, CFG.n_channels, CFG.n_beams
    assert split.shape == (p, c, S, b, 2)
    unpacked = packed.reshape(c // 4, p, S, 4, 2, b).permute(1, 0, 3, 2, 5, 4)
    np.testing.assert_array_equal(unpacked.reshape(p, c, S, b, 2).numpy(), split.numpy())
    q = FBEngine(CFG, n_spectra=S, device="cpu", precision="bf16", beam_layout="natural",
                 beam_quant_scale=1 / 64)(adc, cd, fd, ph, dv)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), requantise(packed, 1 / 64).numpy())


def test_rowed_and_flat_adc_give_the_same_beams():
    margin = _margin()
    fb = FBEngine(CFG, n_spectra=S, device="cpu", precision="bf16", beam_layout="natural")
    adc, cd, fd, ph, dv = fb.example_inputs(seed=9, margin=margin, rowed=True)
    fb.set_beam_delays(dv)
    rowed = fb.step(adc, cd, fd, ph)
    flat = fb.step(adc.reshape(CFG.n_ants, CFG.n_pols, -1), cd, fd, ph)
    np.testing.assert_array_equal(rowed.numpy(), flat.numpy())
    with pytest.raises(RuntimeError, match="set_beam_delays"):
        FBEngine(CFG, n_spectra=S, device="cpu").step(adc, cd, fd, ph)


def _f_planes_xla(port, ref, cfg, jcfg, adc, cd, fd, ph):
    """Each package's composed F planes for one step (``fengine="xla"``)."""
    port_planes = _f_stage(
        torch.as_tensor(adc), torch.as_tensor(cd), port.window, None, cfg=cfg,
        n_spectra=S, quant_scale=port.quant_scale, fengine="xla",
        fine_delays=(torch.as_tensor(fd), torch.as_tensor(ph)),
    )
    ref_planes = j_f_stage(
        jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
        window=ref.window, cfg=jcfg, n_spectra=S, quant_scale=port.quant_scale,
        use_pallas=None, fengine="xla",
    )
    return port_planes, [torch.from_numpy(np.array(q)) for q in ref_planes]


@pytest.mark.parametrize("n_beams, n_channels", [(1, 256), (2, 256), (64, 256), (4, 16)])
def test_natural_fused_b_at_every_reference_width(n_beams, n_channels):
    """One tied-array beam, two, 64, and 16 channels (an ArrayConfig takes
    powers of two only, so not 48) at 4 beams: geometries the
    reference's K2 takes. The port's ``FBEngine(beam_layout="natural")`` at
    the default f32 precision resolves K2 there and steps (the composed F
    on both sides), and its beams match the JAX engine's over a delay
    update within the per-beam flip bound: each beam within sum |w| over the
    F codes where the packages' planes differ, + 1e-3."""
    cfg = ArrayConfig(n_ants=4, n_channels=n_channels, n_beams=n_beams, n_taps=4)
    jcfg = JArrayConfig(**dataclasses.asdict(cfg))
    ref = JFBEngine(jcfg, n_spectra=S, fengine="xla", bstage="fused", beam_layout="natural",
                    fengine_interpret=True)
    port = FBEngine(cfg, n_spectra=S, fengine="xla", beam_layout="natural", device="cpu")
    assert (port.precision, port.bstage, ref.bstage) == ("f32", "fused", "fused")
    _, cd, fd, ph, dv = ref.example_inputs(seed=2, margin=BUDGET, delay_budget=BUDGET)
    t_s = 0.0
    for step in range(2):
        if step == 1:  # delay update: new steering phases, fine delays, epoch
            dv = dv.copy()
            dv[..., 2] += 0.3
            fd = (0.5 * fd).astype(np.float32)
            ph = (-np.pi * fd / 2).astype(np.float32)
            t_s = 1e-3
        ref.set_beam_delays(dv, t_s=t_s)
        adc = ref.example_inputs(seed=20 + step, margin=BUDGET)[0]
        want = torch.from_numpy(np.array(ref.step(jnp.asarray(adc), cd, fd, ph)))
        from_reference_state(port, np.asarray(ref.window), np.asarray(ref._coeff_blocks), None,
                             delay_vals=dv, frac_delays=fd, phases=ph, t_s=t_s)
        got = port.step(adc, cd, fd, ph)
        pack = 64 // n_beams
        assert got.shape == want.shape == (n_channels // pack, cfg.n_pols * S, 128)
        (pr, pi), (rr, ri) = _f_planes_xla(port, ref, cfg, jcfg, adc, cd, fd, ph)
        dr, di = ((g.to(torch.int16) - r.to(torch.int16)).abs().to(torch.int8)
                  for g, r in ((pr, rr), (pi, ri)))
        assert int(max(dr.max(), di.max())) <= 1
        bound = beamform_turned_fused_reference(dr, di, port.coeff_blocks.abs(), "f32")
        d = (got - want).abs()
        assert bool((d <= bound + 1e-3 + 1e-5 * want.abs()).all()), float((d - bound).max())
