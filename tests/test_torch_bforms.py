"""The B forms: the port's planar, folded and native-handoff B stages vs the JAX package.

- K8's plain version (``corner_turn_plane_native_reference``) is a permute
  of int8 bytes: bit-exact against the JAX kernel in interpret mode.
- The beamform products convert int8 samples exactly and take products of
  bf16 weights exactly in f32, so the two packages differ only in the
  order of f32 sums: rtol 1e-5 / atol 1e-4 in f32 (beams reach ~1e3 here;
  tests/test_models.py:251-263), rtol 1e-5 / atol 1e-3 in bf16 (the
  tolerance of tests/test_torch_bstage.py).
- The engines carry the JAX engine's window, steering weights and rotation
  planes across (:mod:`dpdk_dc_sand_tpu_torch.convert`); their F planes then
  agree within 1 int8 code on <= 1e-3 of samples, and a flipped code moves a
  beam by up to |w| <= 1 per term: max |d| <= 2 + 1e-3 with |d| > 1e-3 on
  <= 5e-3 of the beams (tests/test_torch_fbengine.py). On identical planes
  the B stages agree at the products' tolerance.
- The native handoff against the port's own flat turned path: rtol 1e-4 /
  atol 1e-3, the reference's own tolerance (tests/test_models.py:510-534;
  the split sum adds the re and im halves separately).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import FXBEngine as JFXBEngine
from dpdk_dc_sand_tpu.models.fbengine import FBEngine as JFBEngine
from dpdk_dc_sand_tpu.models.fbengine import _b_stage as j_b_stage
from dpdk_dc_sand_tpu.models.fbengine import _f_stage as j_f_stage
from dpdk_dc_sand_tpu.ops import corner_turn as jct
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_coeff_blockcat as j_blockcat
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_coeff_matrix as j_matrix
from dpdk_dc_sand_tpu.ops.fengine_pallas import coarse_margin_samples
from dpdk_dc_sand_tpu.ops.fengine_pallas import fine_rotation_planes as j_fine_rotation_planes
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.convert import from_reference_state
from dpdk_dc_sand_tpu_torch.models import FBEngine, FXBEngine
from dpdk_dc_sand_tpu_torch.models.fbengine import _b_stage, _f_stage
from dpdk_dc_sand_tpu_torch.ops import beamform as bf
from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct
from tests.test_torch_fxbengine import _vis_close

# The module (the package re-exports a function of the same name).
jbf = importlib.import_module("dpdk_dc_sand_tpu.ops.beamform")
TOL = {"f32": dict(rtol=1e-5, atol=1e-4), "bf16": dict(rtol=1e-5, atol=1e-3)}


def _beams_close(got, ref):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 2.0 + 1e-3, d.max()
    assert (d > 1e-3).mean() <= 5e-3, (d > 1e-3).mean()


def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def _cos_sin(rng, c, b, a):
    rot = rng.uniform(-np.pi, np.pi, (c, b, a))
    return np.cos(rot).astype(np.float32), np.sin(rot).astype(np.float32)


def _t(x, precision="f32"):
    """numpy / JAX array -> torch tensor (weights rounded to bf16 for "bf16")."""
    t = torch.from_numpy(np.array(x, np.float32) if np.asarray(x).dtype != np.int8
                         else np.array(x))
    return t.to(torch.bfloat16) if precision == "bf16" and t.is_floating_point() else t


# ---- K8: the native-handoff corner turn -------------------------------------


@pytest.mark.parametrize("a", [4, 8])
def test_plain_k8_matches_jax_kernel(a):
    p, s, rows, lanes = 2, 128, 8, 128
    q = np.random.default_rng(a).integers(-128, 128, (a, p, s, rows, lanes), dtype=np.int8)
    want = np.asarray(jct.corner_turn_plane_native(jnp.asarray(q), interpret=True))
    got = ct.corner_turn_plane_native(torch.from_numpy(q))
    assert got.shape == want.shape == (rows * lanes, a, p * s) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # The 4-d [A, P, S, C] plane is the same bytes: the same turn.
    flat = torch.from_numpy(q.reshape(a, p, s, rows * lanes))
    np.testing.assert_array_equal(ct.corner_turn_plane_native(flat).numpy(), want)
    # K8 of each plane is one half of K4's two-plane turn.
    k4 = ct.corner_turn_planes(flat, flat.flip(0).contiguous())
    np.testing.assert_array_equal(k4[:, :a].numpy(), want)


@pytest.mark.parametrize("a", [1, 4, 8, 12, 80])
@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("rows, lanes", [(8, 128), (128, 256), (12, 128), (8, 64)])
def test_native_gate_matches_the_reference(a, s, rows, lanes):
    want = jct.corner_turn_native_supported(a, 2, s, rows, lanes)
    assert ct.corner_turn_native_supported(a, 2, s, rows, lanes) == want


def test_k8_wrapper_checks():
    with pytest.raises(ValueError, match="rows, lanes"):
        ct.corner_turn_plane_native(torch.zeros((2, 2, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match="unsupported device"):
        ct.corner_turn_plane_native(torch.zeros((2, 2, 128, 8), dtype=torch.int8,
                                                device="meta"))


# ---- the beamform products --------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["split", "natural"])
def test_beamform_turned_split_matches_jax(precision, layout):
    rng = np.random.default_rng(3 + len(layout))
    c, a, p, s, nb = 256, 5, 2, 24, 4
    xr, xi = _int8(rng, (c, a, p * s)), _int8(rng, (c, a, p * s))
    blocks = j_blockcat(*(jnp.asarray(w) for w in _cos_sin(rng, c, nb, a)))
    want = jbf.beamform_turned_split(jnp.asarray(xr), jnp.asarray(xi), blocks, n_pols=p,
                                     precision=precision, layout=layout)
    got = bf.beamform_turned_split(torch.from_numpy(xr), torch.from_numpy(xi),
                                   _t(blocks, precision), n_pols=p, precision=precision,
                                   layout=layout)
    got, want = (got, want) if layout == "split" else ((got,), (want,))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_beamform_planes_and_beamform_match_jax(precision):
    rng = np.random.default_rng(5)
    p, c, s, a, nb = 2, 64, 16, 7, 3
    xr, xi = _int8(rng, (p, c, s, a)), _int8(rng, (p, c, s, a))
    cos, sin = _cos_sin(rng, c, nb, a)
    want = jbf.beamform_planes(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(cos),
                               jnp.asarray(sin), precision)
    got = bf.beamform_planes(torch.from_numpy(xr), torch.from_numpy(xi), _t(cos), _t(sin),
                             precision)
    samples = np.stack([xr, xi], -1)
    want2 = jbf.beamform(jnp.asarray(samples), jnp.asarray(cos), jnp.asarray(sin), precision)
    got2 = bf.beamform(torch.from_numpy(samples), _t(cos), _t(sin), precision)
    for g, w in zip((*got, *got2), (*want, *want2)):
        assert tuple(g.shape) == tuple(w.shape) == (p, c, s, nb)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_beamform_folded_matches_jax(precision):
    rng = np.random.default_rng(7)
    c, s, a, nb = 48, 16, 5, 4
    samples = _int8(rng, (3, c, s, a, 2))
    blocks = j_matrix(*(jnp.asarray(w) for w in _cos_sin(rng, c, nb, a)))
    want = np.asarray(jbf.beamform_folded(jnp.asarray(samples), blocks, precision))
    got = bf.beamform_folded(torch.from_numpy(samples), _t(blocks), precision)
    assert tuple(got.shape) == want.shape == (3, c, s, nb, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_beamform_planes_folded_matches_jax(precision):
    rng = np.random.default_rng(9)
    a, p, s, c, nb = 6, 2, 16, 96, 8
    qr, qi = _int8(rng, (a, p, s, c)), _int8(rng, (a, p, s, c))
    blocks = j_blockcat(*(jnp.asarray(w) for w in _cos_sin(rng, c, nb, a)))
    want = jbf.beamform_planes_folded(jnp.asarray(qr), jnp.asarray(qi), blocks, precision)
    got = bf.beamform_planes_folded(torch.from_numpy(qr), torch.from_numpy(qi),
                                    _t(blocks, precision), precision)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (p, c, s, nb)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[precision])


# ---- the engines ------------------------------------------------------------

#: The reference tests' planar / folded config (tests/test_models.py:251-263).
SMALL = ArrayConfig(n_ants=5, n_channels=64, n_beams=3, n_taps=4)
SMALL_J = JArrayConfig(**dataclasses.asdict(SMALL))


def _ref_weights(ref, bstage):
    w = ref._coeff_blocks
    return [np.asarray(x) for x in w] if bstage == "planar" else np.asarray(w)


@pytest.mark.parametrize("bstage", ["planar", "folded"])
def test_fbengine_planar_and_folded_match_reference(bstage):
    ref = JFBEngine(SMALL_J, n_spectra=8, precision="f32", fengine="xla", bstage=bstage)
    port = FBEngine(SMALL, n_spectra=8, precision="f32", fengine="xla", bstage=bstage,
                    device="cpu")
    assert (ref.bstage, port.bstage) == (bstage, bstage)
    adc, cd, fd, ph, dv = ref.example_inputs(seed=4)
    ref.set_beam_delays(dv)
    want = np.asarray(ref.step(jnp.asarray(adc), cd, fd, ph))
    from_reference_state(port, np.asarray(ref.window), _ref_weights(ref, bstage), None,
                         delay_vals=dv, frac_delays=fd, phases=ph)
    got = port.step(adc, cd, fd, ph)
    assert got.shape == want.shape == (2, SMALL.n_channels, 8, SMALL.n_beams, 2)
    _beams_close(got.numpy(), want)
    # On identical int8 planes the two B stages agree at the products' tolerance.
    qr, qi = port._f(adc, cd, fd, ph)
    w = port.coeff_blocks
    jw = tuple(jnp.asarray(x.numpy()) for x in w) if bstage == "planar" else jnp.asarray(w.numpy())
    jb = j_b_stage(jnp.asarray(qr.numpy()), jnp.asarray(qi.numpy()), jw, cfg=SMALL_J,
                   precision="f32", bstage=bstage)
    np.testing.assert_allclose(_b_stage(qr, qi, w, cfg=SMALL, precision="f32",
                                        bstage=bstage).numpy(), np.asarray(jb), **TOL["f32"])


@pytest.mark.parametrize("bstage", ["planar", "folded"])
def test_planar_state_carries_across_and_bf16_follows(bstage):
    """The planar form's weights are the (cos, sin) [C, B, A] planes in the
    precision's dtype, the others the [C, 2A, 2B] blocks, in both packages."""
    ref = JFBEngine(SMALL_J, n_spectra=8, precision="bf16", fengine="xla", bstage=bstage)
    port = FBEngine(SMALL, n_spectra=8, precision="bf16", fengine="xla", bstage=bstage,
                    device="cpu")
    _, _, _, _, dv = ref.example_inputs(seed=5)
    w = np.linspace(0.5, 1.0, SMALL.n_ants).astype(np.float32)
    ref.set_beam_delays(dv, w, t_s=1e-3)
    port.set_beam_delays(dv, w, t_s=1e-3)
    want = _ref_weights(ref, bstage)
    got = port.coeff_blocks
    assert got.dtype == torch.bfloat16
    if bstage == "planar":
        assert tuple(got.shape) == (2, SMALL.n_channels, SMALL.n_beams, SMALL.n_ants)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1e-2)  # bf16 of f32 cos/sin ulps apart
    from_reference_state(port, np.asarray(ref.window), want, None, delay_vals=dv,
                         frac_delays=np.zeros(SMALL.n_ants), phases=np.zeros(SMALL.n_ants),
                         ant_weights=w, t_s=1e-3)
    np.testing.assert_array_equal(port.coeff_blocks.float().numpy(),
                                  np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="coeff_blocks shape"):
        bad = np.zeros((SMALL.n_channels, 2, 2), np.float32)
        from_reference_state(port, np.asarray(ref.window), bad if bstage == "folded"
                             else [bad, bad], None, delay_vals=dv, frac_delays=[0.0],
                             phases=[0.0])


NATIVE = ArrayConfig(n_ants=4, n_channels=8192, n_beams=4, n_taps=4)
NATIVE_J = JArrayConfig(**dataclasses.asdict(NATIVE))


def test_native_handoff_matches_reference_and_the_flat_turned_path():
    """tests/test_models.py:510-534's config through both packages."""
    common = dict(n_spectra=128, precision="bf16", fengine="fused", bstage="turned",
                  beam_layout="natural")
    ref = JFBEngine(NATIVE_J, fengine_interpret=True, ct_batch_a=True, fengine_rolling=True,
                    fengine_native_handoff=True, **common)
    port = FBEngine(NATIVE, fengine_native_handoff=True, device="cpu", **common)
    flat = FBEngine(NATIVE, device="cpu", **common)
    assert port.fengine_native_handoff and not flat.fengine_native_handoff
    adc, cd, fd, ph, dv = ref.example_inputs(margin=4096, delay_budget=64)
    want = np.asarray(ref(*(jnp.asarray(x) for x in (adc, cd, fd, ph, dv))))
    from_reference_state(port, np.asarray(ref.window), np.asarray(ref._coeff_blocks),
                         [np.asarray(r) for r in ref._rot_planes], delay_vals=dv,
                         frac_delays=fd, phases=ph)
    got = port.step(adc, cd, fd, ph)
    assert got.shape == want.shape == (NATIVE.n_channels, 2 * 128, 2 * NATIVE.n_beams)
    _beams_close(got.numpy(), want)
    # The F planes reach the B stage as K1's native 5-d view, not a copy.
    qr, _ = port._f(adc, cd, fd, ph)
    assert qr.shape == (4, 2, 128, 64, 128) and qr._base is not None
    from_reference_state(flat, np.asarray(ref.window), np.asarray(ref._coeff_blocks),
                         [np.asarray(r) for r in ref._rot_planes], delay_vals=dv,
                         frac_delays=fd, phases=ph)
    np.testing.assert_allclose(got.numpy(), flat.step(adc, cd, fd, ph).numpy(),
                               rtol=1e-4, atol=1e-3)
    # Split beams: the same products, viewed [P, C, S, B, 2].
    split = FBEngine(NATIVE, fengine_native_handoff=True, device="cpu",
                     **{**common, "beam_layout": "split"})
    from_reference_state(split, np.asarray(ref.window), np.asarray(ref._coeff_blocks),
                         [np.asarray(r) for r in ref._rot_planes], delay_vals=dv,
                         frac_delays=fd, phases=ph)
    sb = split.step(adc, cd, fd, ph)
    nat = got.view(NATIVE.n_channels, 2, 128, 2, NATIVE.n_beams).permute(1, 0, 2, 4, 3)
    np.testing.assert_array_equal(sb.numpy(), nat.numpy())


@pytest.mark.parametrize(
    "kw, expect",
    [(dict(), "ok"), (dict(bstage="fused"), "ValueError"), (dict(fengine="xla"), "ValueError"),
     (dict(fengine="fused_f32"), "ok"), (dict(n_spectra=64), "ValueError"),
     (dict(n_ants=12), "ValueError"), (dict(n_ants=16), "ok"),
     (dict(n_channels=64), "ValueError"),
     (dict(bstage="planar", beam_layout="split"), "ValueError")],
    ids=["ok", "fused_b", "xla_f", "f32_f", "s64", "a12", "a16", "c64", "planar"],
)
def test_native_handoff_gate_raises_where_the_reference_does(kw, expect):
    kw = {"n_ants": 4, "n_channels": 8192, "n_spectra": 128, "fengine": "fused",
          "bstage": "turned", "beam_layout": "natural", **kw}
    cfg = ArrayConfig(n_ants=kw.pop("n_ants"), n_channels=kw.pop("n_channels"), n_beams=4,
                      n_taps=4)
    jcfg = JArrayConfig(**dataclasses.asdict(cfg))

    def outcome(make):
        try:
            make()
            return "ok"
        except ValueError:
            return "ValueError"

    want = outcome(lambda: JFBEngine(jcfg, fengine_interpret=True, fengine_native_handoff=True,
                                     **kw))
    got = outcome(lambda: FBEngine(cfg, fengine_native_handoff=True, device="cpu", **kw))
    assert got == want == expect


def test_natural_layout_refuses_planar_and_folded_as_the_reference():
    for bstage in ("planar", "folded"):
        with pytest.raises(ValueError, match="natural"):
            FBEngine(SMALL, n_spectra=8, bstage=bstage, beam_layout="natural", device="cpu")
        with pytest.raises(ValueError, match="natural"):
            JFBEngine(SMALL_J, n_spectra=8, bstage=bstage, beam_layout="natural")


FXB = ArrayConfig(n_ants=4, n_channels=1024, n_beams=16, n_taps=8)
FXB_J = JArrayConfig(**dataclasses.asdict(FXB))


def test_fxbengine_planar_at_s24_matches_reference():
    """S = 24 is outside K2's and K4's reference gates: both engines resolve
    "planar", and the X stage takes the plain grams."""
    s, quant, budget = 24, 1 / 16, 256
    margin = -(-(coarse_margin_samples(FXB.fft_size, FXB.n_taps, s, True) + budget) // 128) * 128
    ref = JFXBEngine(FXB_J, n_spectra=s, quant_scale=quant, precision="bf16", fengine="fused",
                     fengine_interpret=True)
    port = FXBEngine(FXB, n_spectra=s, quant_scale=quant, precision="bf16", device="cpu")
    assert (ref.bstage, port.bstage, port.fengine) == ("planar", "planar", "fused")
    adc, cd, fd, ph, dv = ref.example_inputs(seed=2, margin=margin, delay_budget=budget)
    ref.set_beam_delays(dv)
    wb, wr, wi = (np.asarray(x) for x in ref.step(jnp.asarray(adc), cd, fd, ph))
    lead = (FXB.n_ants, FXB.n_pols)
    rot = j_fine_rotation_planes(jnp.broadcast_to(jnp.asarray(fd)[:, None], lead),
                                 jnp.broadcast_to(jnp.asarray(ph)[:, None], lead),
                                 n_channels=FXB.n_channels, quant_scale=quant)
    from_reference_state(port, np.asarray(ref.window), [np.asarray(w) for w in ref._coeffs],
                         [np.asarray(r) for r in rot], delay_vals=dv, frac_delays=fd,
                         phases=ph)
    gb, gr, gi = port.step(adc, cd, fd, ph)
    assert gb.shape == wb.shape == (2, FXB.n_channels, s, FXB.n_beams, 2)
    _beams_close(gb.numpy(), wb)
    port_planes = _f_stage(torch.as_tensor(adc), torch.as_tensor(cd), port.window,
                           port._fine_rot(fd, ph), cfg=FXB, n_spectra=s, quant_scale=quant)
    ref_planes = j_f_stage(jnp.asarray(adc), jnp.asarray(cd), jnp.asarray(fd), jnp.asarray(ph),
                           window=ref.window, cfg=FXB_J, n_spectra=s, quant_scale=quant,
                           use_pallas=None, fengine="fused", fengine_interpret=True,
                           ct_batch_a=True, fengine_rolling=True)
    _vis_close(port_planes, ref_planes, (gr, gi), (wr, wi))
