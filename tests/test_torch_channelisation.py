"""Channelisation qualification of K1's unquantised output on the port.

The reference's production qualification
(``tests/qualification/test_channelisation_production.py``) channelises a
TPDF-dithered int8 CW tone in channel 100 through its fused F kernel with
``quantise=False`` (``chan_common.fused_power``) and requires the peak in
channel 100, the worst leakage <= -62 dB (BASELINE.md:15) and bf16 DFT
operands within 6 dB of f32. Here the port's plain K1 takes the same tone:

- against the JAX kernel (interpret mode) its rotated f32 planes agree
  within rtol 1e-4 / atol 1e-2, the reference's unquantised-output
  contract (tests/test_fengine_fused.py:499-505): both round at the same
  points and differ in the order of f32 sums. That contract was set on
  +-64 noise. The tone's spectrum peaks at 6.1e4, and the CT stages carry
  that amplitude through f32 sums until the last stage cancels it off the
  peak, so every output also carries a rounding floor of a few f32 ulps of
  the peak (3.9e-3 each): the tone's atol is the larger of 1e-2 and 4 ulps
  of the peak. On the contract's own noise input it is 1e-2.
- its own leakage meets the spec.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpdk_dc_sand_tpu.golden.pfb import pfb_window as j_pfb_window
from dpdk_dc_sand_tpu.ops.fengine_pallas import fengine_fused as j_fengine_fused
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window
from tests.qualification.chan_common import (
    C,
    FFT,
    K,
    LEAKAGE_SPEC_DB,
    TAPS,
    make_tone,
    worst_leakage_db,
)


def _port_planes(dft_dtype, frames=None):
    frames = make_tone() if frames is None else frames
    zero = np.zeros((1, 1), np.float32)
    return fengine_fused(torch.from_numpy(frames), default_window(TAPS, FFT), zero, zero,
                         n_channels=C, quant_scale=1.0, dft_dtype=dft_dtype, quantise=False)


def _power(fr, fi):
    power = np.asarray(fr, np.float64) ** 2 + np.asarray(fi, np.float64) ** 2
    return power[0, 0].mean(axis=0)


def test_chip_smoke_makes_the_qualification_tone():
    """chip_smoke.py re-makes the tone without importing tests/: the same bytes."""
    np.testing.assert_array_equal(chip_smoke.qualification_tone(), make_tone())


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("signal", ["tone", "noise"])
def test_plain_k1_unquantised_matches_jax_kernel(dft_dtype, signal):
    frames = make_tone()
    if signal == "noise":  # the contract's own input (tests/test_fengine_fused.py:486-489)
        frames = np.random.default_rng(7).integers(-64, 64, frames.shape, dtype=np.int8)
    zero = jnp.zeros((1, 1), jnp.float32)
    jr, ji = j_fengine_fused(
        jnp.asarray(frames), jnp.asarray(np.asarray(j_pfb_window(TAPS, FFT))), zero, zero,
        n_channels=C, quant_scale=1.0, dft_dtype=dft_dtype, quantise=False, interpret=True,
    )
    fr, fi = _port_planes(dft_dtype, frames)
    assert fr.dtype == torch.float32 and tuple(fr.shape) == tuple(jr.shape)
    peak = float(np.abs(np.concatenate([np.asarray(jr), np.asarray(ji)])).max())
    atol = max(1e-2, 4 * float(np.spacing(np.float32(peak)))) if signal == "tone" else 1e-2
    for g, w in zip((fr, fi), (jr, ji)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_port_tone_meets_the_leakage_spec(dft_dtype):
    power = _power(*_port_planes(dft_dtype))
    assert int(np.argmax(power)) == K
    assert worst_leakage_db(power) <= LEAKAGE_SPEC_DB


def test_bf16_within_6_db_of_f32():
    worst_bf16 = worst_leakage_db(_power(*_port_planes("bfloat16")))
    worst_f32 = worst_leakage_db(_power(*_port_planes("float32")))
    assert worst_bf16 <= worst_f32 + 6.0
    assert worst_bf16 <= LEAKAGE_SPEC_DB
