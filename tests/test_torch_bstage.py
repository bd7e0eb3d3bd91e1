"""The port's fused B stage (K2's plain version) vs the JAX fused B kernel.

Same int8 planes and steering blocks into both; int8 samples convert
exactly and products with bf16 weights are exact in f32, so the two differ
only in f32 summation order: rtol 1e-5, atol 1e-3 (beams reach ~1e4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops.bstage_pallas import beamform_turned_fused as j_bstage
from dpdk_dc_sand_tpu.ops.coeff_gen import steering_coeff_blockcat as j_blockcat
from dpdk_dc_sand_tpu_torch.ops import bstage

A, P, S, C, NB = 4, 2, 64, 512, 16


def _inputs(seed, precision, a=A, nb=NB, c=C):
    rng = np.random.default_rng(seed)
    qr = rng.integers(-127, 128, (a, P, S, c), dtype=np.int8)
    qi = rng.integers(-127, 128, (a, P, S, c), dtype=np.int8)
    rot = rng.uniform(-np.pi, np.pi, (c, nb, a))
    cos, sin = np.cos(rot).astype(np.float32), np.sin(rot).astype(np.float32)
    blocks = j_blockcat(jnp.asarray(cos), jnp.asarray(sin))
    if precision == "bf16":
        blocks = blocks.astype(jnp.bfloat16)
    return qr, qi, blocks


def _torch_blocks(blocks):
    t = torch.from_numpy(np.array(blocks, np.float32))
    return t.to(torch.bfloat16) if blocks.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("nb", [NB, 1, 2, 64])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["packed", "split"])
def test_plain_k2_matches_jax_kernel(precision, layout, nb):
    """At 2B = 32 (C = 512) and at 2B = 2, 4 and 128 (C = 128), every width
    the reference's gate adds to the port's old one."""
    c = C if nb == NB else 128
    qr, qi, blocks = _inputs(3 + len(layout) + nb, precision, nb=nb, c=c)
    ref = j_bstage(jnp.asarray(qr), jnp.asarray(qi), blocks, n_pols=P,
                   precision=precision, interpret=True, layout=layout)
    got = bstage.beamform_turned_fused(
        torch.from_numpy(qr), torch.from_numpy(qi), _torch_blocks(blocks),
        n_pols=P, precision=precision, layout=layout,
    )
    if layout == "packed":
        got, ref = (got,), (ref,)
        assert got[0].shape == (c // (64 // nb), P * S, 128)
    else:
        assert got[0].shape == (P, c, S, nb)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-3)


def test_split_layout_is_the_packed_layout_unpacked():
    qr, qi, blocks = _inputs(11, "bf16")
    args = (torch.from_numpy(qr), torch.from_numpy(qi), _torch_blocks(blocks))
    packed = bstage.beamform_turned_fused(*args, layout="packed")
    re, im = bstage.beamform_turned_fused(*args, layout="split")
    # packed[c // 4, p*S + s, (c % 4)*32 + j]: j < 16 real beams, j >= 16 imag.
    c, p, s, b = 37, 1, 5, 9
    row = packed[c // 4, p * S + s, (c % 4) * 2 * NB:]
    assert float(row[b]) == float(re[p, c, s, b])
    assert float(row[NB + b]) == float(im[p, c, s, b])
    full = torch.stack([re, im], -2)  # [P, C, S, 2, B]
    np.testing.assert_array_equal(
        full.permute(1, 0, 2, 3, 4).reshape(C // 4, 4, P * S, 2 * NB)
        .permute(0, 2, 1, 3).reshape(C // 4, P * S, 128).numpy(),
        packed.numpy(),
    )


def test_bstage_fused_supported_gate():
    assert bstage.bstage_fused_supported(80, 2, 256, 16, 32768)
    assert bstage.bstage_fused_supported(3, 2, 32, 4, 64)
    assert not bstage.bstage_fused_supported(4, 2, 16, 16, 512)  # P·S % 64
    assert not bstage.bstage_fused_supported(4, 2, 64, 12, 512)  # 2B
    assert bstage.bstage_fused_supported(4, 2, 64, 16, 48)  # C % pack (4), as the reference
    assert not bstage.bstage_fused_supported(4, 2, 64, 16, 42)  # C % pack
    assert not bstage.bstage_fused_supported(4, 2, 64, 128, 512)  # 2B > 128


@pytest.mark.parametrize("n_beams", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("n_ants", [1, 3, 80])
def test_reference_gate_implies_the_ports(n_ants, n_beams):
    """Every geometry the reference's K2 takes, K2 takes: S in {64, 128,
    256}, C in {8 .. 32768} (the reference admits C < 128 at C % pack)."""
    admitted = 0
    for s in (64, 128, 256):
        for c in (8, 16, 24, 48, 64, 128, 256, 32768):
            if bstage.reference_fused_gate(n_ants, P, s, n_beams, c):
                admitted += 1
                assert bstage.bstage_fused_supported(n_ants, P, s, n_beams, c), (s, c)
    assert admitted


def test_beamform_turned_fused_input_checks():
    qr, qi, blocks = _inputs(13, "f32")
    t = (torch.from_numpy(qr), torch.from_numpy(qi))
    with pytest.raises(ValueError, match="layout"):
        bstage.beamform_turned_fused(*t, _torch_blocks(blocks), layout="natural")
    with pytest.raises(ValueError, match="blocks"):
        bstage.beamform_turned_fused(*t, _torch_blocks(blocks)[:, :4])
    with pytest.raises(ValueError, match="n_pols"):
        bstage.beamform_turned_fused(*t, _torch_blocks(blocks), n_pols=1)


@pytest.mark.parametrize("stop", sorted(bstage.K2_STOPS) + ["full"])
def test_k2_stops_refuse_before_any_launch(stop):
    """K2's stage stops run on the card only, and take only their own names."""
    qr, qi, blocks = _inputs(17, "bf16")
    out = torch.zeros((C // 4, P * S, 128))
    match = "needs CUDA" if stop in bstage.K2_STOPS else "unknown stop"
    with pytest.raises(ValueError, match=match):
        bstage.beamform_turned_fused_stop(torch.from_numpy(qr), torch.from_numpy(qi),
                                          _torch_blocks(blocks), out, stop)
