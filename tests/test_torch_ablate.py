"""K1's stage stops (``fengine_fused(_ablate=...)``) on the port against the
JAX reference's.

The JAX side runs ``fengine_fused(_ablate=stop, interpret=True,
ct_pipeline=2, ct_batch_a=True, s_blk=16)``, the chunked schedule its stops
need; the port's CPU path runs its plain stop (:func:`fengine_ablate_reference`),
which every stop kernel is held to on the card. Inputs come from a numpy
seed: int8 frames and a standard-normal window scaled per stop, as the P5
test scales it (and by sqrt(65536/fft) above P5's fft 65536), so that each
stop's values stay in int8 range.

Tolerances:

- ``dma``: bit for bit (both copy the same input bytes).
- ``fir``, int8: within 1 code on <= 1e-6 of samples. XLA's f32 FIR on the
  CPU rounds about a third of its sums differently from the tap-order sum
  K1 computes (1 f32 ulp); where that flips a bf16 rounding across an
  integer the truncated code moves: 1 sample of 2^21 (4.8e-7) at 2^18 with
  the window at P5's scale unscaled for size, none at these inputs.
- ``stagea``, ``stageb``, int8: within 1 code on <= 1e-3 of samples, K1's
  contract (f32 sums in another order, bf16 operands rounded at the same
  points).
- Unquantised (the f32 values): rtol 1e-5, atol 1e-3. Both sides sum in f32
  in different orders and nothing else differs, so with f32 operands every
  sample holds it. With bf16
  operands a flipped bf16 rounding of the plane or of T moves a value by one
  bf16 ulp, and a flipped T element moves every stage-B output of its k1
  column: those samples may pass the bound, each within one bf16 ulp of the
  stop's largest value (2^-8 max|ref|), on at most ``_BF16_FLIPS`` of
  samples (measured at 2^18, the worse size: fir 2.4e-6, stagea 1.8e-4,
  stageb 5.1e-2; f32 operands' largest |d| 6.9e-5 at values up to 68).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.ops import fengine_pallas as jfp
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

TAPS, S = 4, 16
#: The window's scale at each stop (tests/test_torch_probes.py's _P5_SCALE).
SCALE = {"dma": 1 / 64, "fir": 1 / 64, "stagea": 1 / 256, "stageb": 1 / 1024}
#: The share of unquantised bf16-operand samples past rtol 1e-5 / atol 1e-3
#: (the module docstring).
_BF16_FLIPS = {"fir": 1e-5, "stagea": 1e-3, "stageb": 0.1}


def _inputs(fft, stop, seed, s=S, taps=TAPS):
    """int8 frames and the stop's window, scaled as at P5's fft 65536 (the
    DFT's values grow as sqrt(fft))."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(-64, 64, (1, 1, s + taps - 1, fft), dtype=np.int8)
    gain = SCALE[stop] * min(1.0, (65536 / fft) ** 0.5)
    win = (rng.standard_normal((taps, fft)) * gain).astype(np.float32)
    fd = rng.uniform(-0.5, 0.5, (1, 1)).astype(np.float32)
    ph = rng.uniform(-1, 1, (1, 1)).astype(np.float32)
    return frames, win, fd, ph


def run_both(fft, stop, dft_dtype, quantise, seed, s=S, taps=TAPS):
    """The JAX reference's stop and the port's on the same numpy inputs."""
    frames, win, fd, ph = _inputs(fft, stop, seed, s, taps)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16, dft_dtype=dft_dtype, quantise=quantise,
              _ablate=stop)
    want = jfp.fengine_fused(jnp.asarray(frames), jnp.asarray(win), jnp.asarray(fd),
                             jnp.asarray(ph), interpret=True, ct_pipeline=2, ct_batch_a=True,
                             s_blk=16, **kw)
    got = ff.fengine_fused(torch.from_numpy(frames), torch.from_numpy(win), fd, ph, **kw)
    out_dtype = torch.int8 if quantise else torch.float32
    assert all(g.dtype == out_dtype and g.shape == (1, 1, s, fft // 2) for g in got)
    return [g.numpy() for g in got], [np.asarray(w).reshape(1, 1, s, -1) for w in want]


def assert_stop_close(stop, dft_dtype, quantise, got, want):
    """The module docstring's tolerance for ``stop``."""
    for g, w in zip(got, want):
        if quantise:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            max_frac = {"dma": 0.0, "fir": 1e-6}.get(stop, 1e-3)
            assert d.max() <= (0 if stop == "dma" else 1), d.max()
            assert (d != 0).mean() <= max_frac, (d != 0).mean()
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        d = np.abs(g - w)
        out = d > 1e-3 + 1e-5 * np.abs(w)
        if dft_dtype == "float32" or stop == "dma":
            assert not out.any(), (d.max(), out.mean())
        else:
            assert out.mean() <= _BF16_FLIPS[stop], out.mean()
            assert d.max() <= 2.0 ** -8 * np.abs(w).max(), (d.max(), np.abs(w).max())


@pytest.mark.parametrize("fft", [1024, 2048, 16384])
def test_dma_stop_matches_the_reference(fft):
    """The probe is rows < N2/2, lanes < N1 of the [rows, N2] frame view,
    which is the first C samples only at N1 == N2 (fft 16384): at fft 2048
    (16 x 128) the port wrote those on 97.9% of the wrong outputs, and at
    fft 1024 (8 x 128) the probe spans 8 frames."""
    got, want = run_both(fft, "dma", "bfloat16", True, seed=fft)
    assert_stop_close("dma", "bfloat16", True, got, want)


@pytest.mark.parametrize("fft", [1024, 2048, 16384])
def test_dma_stop_reads_from_the_references_row_at_coarse_delays(fft):
    """With coarse delays the reference's probe reads from its DMA base: the
    delay's row rounded down to a multiple of 8 rows of N2, clipped below
    the input's margin. Delays of 0, a few samples, 17 rows and 1 sample
    (base 16 rows) and one past the clip, on raw streams with 104 rows of
    margin."""
    n1, n2 = ff._split_ct(fft)
    rng = np.random.default_rng(fft + 1)
    n_in = ((S + TAPS - 1) * n1 + 104) * n2
    x = rng.integers(-128, 128, (2, 2, n_in), dtype=np.int8)
    cd = np.array([[0, 5], [17 * n2 + 1, 100 * n2 + 3]], dtype=np.int32)
    win = np.ones((TAPS, fft), np.float32)
    z = np.zeros((2, 2), np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1.0, n_spectra=S, _ablate="dma")
    want = jfp.fengine_fused(jnp.asarray(x), jnp.asarray(win), jnp.asarray(z), jnp.asarray(z),
                             coarse_delays=jnp.asarray(cd), interpret=True, ct_pipeline=2,
                             ct_batch_a=True, s_blk=16, **kw)
    got = ff.fengine_fused(torch.from_numpy(x), torch.from_numpy(win), z, z,
                           coarse_delays=torch.from_numpy(cd), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(g.shape))
    # The base is not the start: the probe of a stream 17 rows in reads from row 16.
    span = max(1, n2 // (2 * n1)) * fft

    def probe(start):
        return x[1, 0, start:start + span].reshape(-1, n2)[: n2 // 2, :n1].ravel()

    np.testing.assert_array_equal(got[0][1, 0, 0].numpy(), probe(16 * n2))
    assert not np.array_equal(got[0][1, 0, 0].numpy(), probe(17 * n2 + 1))


@pytest.mark.parametrize("quantise", [True, False])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stop", ["fir", "stagea", "stageb"])
@pytest.mark.parametrize("fft", [16384, 1 << 18])
def test_stop_matches_the_reference(fft, stop, dft_dtype, quantise):
    seed = fft + len(stop) + 2 * len(dft_dtype) + quantise
    got, want = run_both(fft, stop, dft_dtype, quantise, seed)
    assert_stop_close(stop, dft_dtype, quantise, got, want)


def test_dma_stop_refuses_a_probe_past_the_input():
    """At N1 < N2 a block's probe spans N2/(2 N1) frames (8 at fft 1024):
    where S % 16 != 0 leaves the last block's probe past the input (S = 20,
    2 taps: frames 16..23 of 21), the stop raises rather than read past."""
    frames = torch.zeros((1, 1, 21, 1024), dtype=torch.int8)
    z = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="past the 21 frames"):
        ff.fengine_fused(frames, torch.ones((2, 1024)), z, z, n_channels=512, quant_scale=1.0,
                         _ablate="dma")
    got = ff.fengine_fused(frames[:, :, :17], torch.ones((2, 1024)), z, z, n_channels=512,
                           quant_scale=1.0, _ablate="dma")  # S = 16: one whole block
    assert got[0].shape == (1, 1, 16, 512)
