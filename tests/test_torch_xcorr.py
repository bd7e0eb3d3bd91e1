"""The port's visibility grams (K3, K5b plain versions, ops.correlate) vs the JAX package.

Int8 grams are exact integers in both packages, so every int8 comparison
here is bit for bit. f32 and bf16 grams of int8-valued inputs are exact too
while partial sums stay below 2^24 (S <= 1024 at full-scale codes). The
JAX kernels run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import corner_turn as jct
from dpdk_dc_sand_tpu.ops import xcorr_pallas as jx
from dpdk_dc_sand_tpu.ops.correlate import correlate as j_correlate
from dpdk_dc_sand_tpu.ops.correlate import correlate_accumulate as j_correlate_accumulate
from dpdk_dc_sand_tpu.ops.correlate import correlate_planes as j_correlate_planes
from dpdk_dc_sand_tpu.ops.correlate import correlate_turned as j_correlate_turned
from dpdk_dc_sand_tpu_torch.models.fxbengine import _x_stage
from dpdk_dc_sand_tpu_torch.ops import correlate, xcorr


def _int8(seed, shape, lo=-128):
    return np.random.default_rng(seed).integers(lo, 128, shape, dtype=np.int8)


def _golden(y, i):
    """int64 golden model of the stacked gram: y [C, 2I, S] -> (V_re, V_im) f32."""
    r, im = y[:, :i].astype(np.int64), y[:, i:].astype(np.int64)
    g = lambda a, b: np.einsum("cis,cjs->cij", a, b)  # noqa: E731
    return (g(r, r) + g(im, im)).astype(np.float32), (g(im, r) - g(r, im)).astype(np.float32)


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_k3_plain_matches_jax_kernel_and_golden():
    a, p, s, c = 2, 2, 128, 128
    assert xcorr.xcorr_fused_supported(a, p, s, c)
    qr, qi = _int8(1, (a, p, s, c)), _int8(2, (a, p, s, c))
    got = xcorr.correlate_planes_fused(torch.from_numpy(qr), torch.from_numpy(qi))
    want = jx.correlate_planes_fused(jnp.asarray(qr), jnp.asarray(qi), interpret=True)
    _eq(got, want)
    y = np.concatenate([qr, qi]).reshape(2 * a * p, s, c).transpose(2, 0, 1)
    _eq(got, _golden(y, a * p))


def test_k5b_plain_matches_jax_kernel_and_golden():
    i, s, c = 6, 128, 16
    assert xcorr.xcorr_supported(c, s)
    xt = _int8(5, (c, 2 * i, s), lo=-127)
    got = xcorr.correlate_turned_fused(torch.from_numpy(xt), i)
    _eq(got, jx.correlate_turned_fused(jnp.asarray(xt), i, interpret=True))
    _eq(got, _golden(xt, i))


@pytest.mark.parametrize("a", [1, 5])
@pytest.mark.parametrize("s", [8, 64, 128, 1024, 1032, 2048])
@pytest.mark.parametrize("c", [8, 60, 128, 1000, 1024])
def test_gates_match_the_reference(a, s, c):
    assert xcorr.xcorr_supported(c, s) == jx.xcorr_supported(c, s)
    assert xcorr.xcorr_fused_supported(a, 2, s, c) == jx.xcorr_fused_supported(a, 2, s, c)


def test_wrappers_refuse_geometries_outside_their_gates():
    with pytest.raises(ValueError, match="xcorr_supported"):
        xcorr.correlate_turned_fused(torch.zeros((4, 6, 128), dtype=torch.int8), 3)
    q = torch.zeros((2, 2, 64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="xcorr_fused_supported"):
        xcorr.correlate_planes_fused(q, q)


@pytest.mark.parametrize("stop", sorted(xcorr.K3_STOPS) + ["full"])
def test_k3_stops_refuse_before_any_launch(stop):
    """K3's stage stops run on the card only, and take only their own names."""
    q = torch.zeros((2, 2, 128, 128), dtype=torch.int8)
    v = torch.zeros((128, 4, 4))
    match = "needs CUDA" if stop in xcorr.K3_STOPS else "unknown stop"
    with pytest.raises(ValueError, match=match):
        xcorr.correlate_planes_fused_stop(q, q, v, v, stop)


@pytest.mark.parametrize("case", sorted(xcorr.K5B_STOPS) + ["unknown", "outputs", "rows"])
def test_k5b_stops_refuse_before_any_launch(case):
    """K5b's stage stops run on the card only, take only their own names and
    refuse outputs or planes of the wrong shape, all before any launch."""
    i, s, c = 3, 128, 16
    xt = torch.zeros((c, 2 * i, s), dtype=torch.int8)
    v = torch.zeros((c, i, i))
    stop, match = case, "needs CUDA"
    if case == "unknown":
        stop, match = "full", "unknown stop"
    elif case == "outputs":
        stop, match, v = "copy", "outputs must be", torch.zeros((c, i, i + 1))
    elif case == "rows":
        stop, match, xt = "copy", r"want \[C, 2", xt[:, :-1]
    with pytest.raises(ValueError, match=match):
        xcorr.correlate_turned_fused_stop(xt, i, v, v, stop)


@pytest.mark.parametrize("precision", ["int8", "f32", "bf16"])
def test_correlate_planes_matches_reference(precision):
    c, t, i = 8, 64, 6
    xr, xi = _int8(11, (c, t, i)), _int8(12, (c, t, i))
    got = correlate.correlate_planes(torch.from_numpy(xr), torch.from_numpy(xi), precision)
    _eq(got, j_correlate_planes(jnp.asarray(xr), jnp.asarray(xi), precision))


@pytest.mark.parametrize("precision", ["int8", "f32", "bf16"])
def test_correlate_turned_matches_reference(precision):
    c, i, s = 8, 5, 128
    xt = _int8(13, (c, 2 * i, s))
    got = correlate.correlate_turned(torch.from_numpy(xt), i, precision)
    _eq(got, j_correlate_turned(jnp.asarray(xt), i, precision))


@pytest.mark.parametrize("fn", ["planes", "turned"])
def test_int8_grams_past_the_f32_exact_bound(fn):
    """S = 2048 at full-scale codes: grams exceed 2^24, so the order of the
    int8 conversion and the sum matters; the port mirrors each function's."""
    c, i, s = 4, 3, 2048
    x = np.full((c, 2 * i, s), 127, np.int8)
    x[:, :, ::3] = -127
    x[:, i:, 1::5] = 125
    if fn == "turned":
        got = correlate.correlate_turned(torch.from_numpy(x), i, "int8")
        want = j_correlate_turned(jnp.asarray(x), i, "int8")
    else:
        xr, xi = x[:, :i].transpose(0, 2, 1), x[:, i:].transpose(0, 2, 1)
        got = correlate.correlate_planes(torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy()), "int8")
        want = j_correlate_planes(jnp.asarray(xr), jnp.asarray(xi), "int8")
    assert float(np.abs(np.asarray(want[0])).max()) > 2**24
    _eq(got, want)


@pytest.mark.parametrize("precision", ["int8", "f32"])
def test_correlate_and_accumulate_match_reference(precision):
    samples = _int8(17, (8, 16, 6, 2), lo=-64)
    got = correlate.correlate(torch.from_numpy(samples), precision)
    _eq(got, j_correlate(jnp.asarray(samples), precision))
    acc = [torch.full((8, 6, 6), 3.0), torch.full((8, 6, 6), -2.0)]
    out = correlate.correlate_accumulate(torch.from_numpy(samples), *acc, precision=precision)
    assert out[0] is acc[0] and out[1] is acc[1]  # updated in place
    want = j_correlate_accumulate(
        jnp.asarray(samples), jnp.full((8, 6, 6), 3.0), jnp.full((8, 6, 6), -2.0), precision
    )
    _eq(out, want)


def _jax_x_stage(qr, qi, branch):
    """The JAX ops the reference FXB X stage runs on each branch."""
    a, p, s, c = qr.shape
    jr, ji = jnp.asarray(qr), jnp.asarray(qi)
    if branch == "k3":
        return jx.correlate_planes_fused(jr, ji, interpret=True)
    if branch == "plain":
        cr = jnp.transpose(jr, (3, 2, 0, 1)).reshape(c, s, a * p)
        ci = jnp.transpose(ji, (3, 2, 0, 1)).reshape(c, s, a * p)
        return j_correlate_planes(cr, ci, "int8")
    xt = jct.corner_turn_planes_x(jr, ji, interpret=True)
    if branch == "k5":
        return jx.correlate_turned_fused(xt, a * p, interpret=True)
    return j_correlate_turned(xt, a * p, "int8")


@pytest.mark.parametrize(
    "branch, s, c",
    [("k3", 128, 128), ("k5", 128, 64), ("turn_then_plain", 128, 60), ("plain", 64, 128)],
)
def test_fxb_x_stage_dispatch_matches_reference(branch, s, c):
    a, p = 2, 2
    gates = (jct.corner_turn_x_supported(a, p, s, c), jx.xcorr_fused_supported(a, p, s, c),
             jx.xcorr_supported(c, s))
    assert gates == {"k3": (True, True, True), "k5": (True, False, True),
                     "turn_then_plain": (True, False, False),
                     "plain": (False, False, True)}[branch]
    qr, qi = _int8(21, (a, p, s, c), lo=-127), _int8(22, (a, p, s, c), lo=-127)
    got = _x_stage(torch.from_numpy(qr), torch.from_numpy(qi), "int8")
    _eq(got, _jax_x_stage(qr, qi, branch))
