"""The port's corner turn (K4 = K5a, plain version) vs the JAX Pallas turns.

Both are permutes of int8 bytes, so the comparison is exact. The JAX
kernels run in interpret mode, as the JAX package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import corner_turn as jct
from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct


def _planes(seed, a, p, s, c):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-128, 128, (a, p, s, c), dtype=np.int8) for _ in range(2))


def _port(fn, qr, qi):
    return fn(torch.from_numpy(qr), torch.from_numpy(qi)).numpy()


@pytest.mark.parametrize(
    "a, p, s, c",
    [(3, 2, 128, 256), (2, 2, 64, 128)],
    ids=["split_form_S128", "full_form_S64"],
)
def test_k4_matches_jax_corner_turn_planes(a, p, s, c):
    qr, qi = _planes(a * s, a, p, s, c)
    want = np.asarray(jct.corner_turn_planes(jnp.asarray(qr), jnp.asarray(qi), interpret=True))
    got = _port(ct.corner_turn_planes, qr, qi)
    assert got.shape == want.shape == (c, 2 * a, p * s) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_k5a_matches_jax_corner_turn_planes_x():
    a, p, s, c = 3, 2, 128, 128
    qr, qi = _planes(5, a, p, s, c)
    want = np.asarray(jct.corner_turn_planes_x(jnp.asarray(qr), jnp.asarray(qi), interpret=True))
    got = _port(ct.corner_turn_planes_x, qr, qi)
    assert got.shape == want.shape == (c, 2 * a * p, s)
    np.testing.assert_array_equal(got, want)


def test_k4_and_k5a_write_the_same_bytes():
    """``[C, 2A, P·S]`` at row reim·A + a, lane p·S + s and ``[C, 2AP, S]`` at
    row reim·AP + a·P + p, lane s are the same offset; K5a is a view of K4."""
    a, p, s, c = 3, 2, 128, 128
    qr, qi = _planes(7, a, p, s, c)
    b_layout = np.asarray(jct.corner_turn_planes(jnp.asarray(qr), jnp.asarray(qi), interpret=True))
    x_layout = np.asarray(jct.corner_turn_planes_x(jnp.asarray(qr), jnp.asarray(qi), interpret=True))
    np.testing.assert_array_equal(b_layout.ravel(), x_layout.ravel())
    tr, ti = torch.from_numpy(qr), torch.from_numpy(qi)
    xt = ct.corner_turn_planes_x(tr, ti)
    assert xt.is_contiguous() and xt._base is not None  # a view, not a copy
    np.testing.assert_array_equal(xt.reshape(c, 2 * a, p * s).numpy(), b_layout)
    # Spot-check the documented index maps.
    reim, aa, pp, ss, cc = 1, 2, 1, 77, 5
    assert xt[cc, reim * a * p + aa * p + pp, ss] == (qi if reim else qr)[aa, pp, ss, cc]


@pytest.mark.parametrize("a", [1, 3, 80])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("s", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("c", [64, 100, 128, 192, 32768])
def test_gates_match_the_reference(a, p, s, c):
    assert ct.corner_turn_supported(a, p, s, c) == jct.corner_turn_supported(a, p, s, c)
    assert ct.corner_turn_x_supported(a, p, s, c) == jct.corner_turn_x_supported(a, p, s, c)


def test_native_planes_raise_naming_roadmap():
    """5-d native planes go one at a time to ``corner_turn_plane_native``
    (K8): the two-plane turn refuses them, as the reference's does."""
    q = torch.zeros((2, 2, 128, 8, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="corner_turn_plane_native"):
        ct.corner_turn_planes(q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros((2, 2, 128, 128), dtype=torch.int8, device="meta")
        ct.corner_turn_planes(m, m)
