"""The reference-layout B-engine: the port's BeamformPipeline and its ops vs the JAX package.

The reorder is a permute (bit-exact). The rotation blocks are cos/sin of
the same f32 phases in both packages: within 1e-6. The pipeline's beams
sum 2A products of int8 samples and f32 weights in another order than
XLA's: rtol 1e-4 / atol 1e-2, the reference test's own tolerance
(tests/test_models.py:28-42).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.parameters as parameters
from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.models import BeamformPipeline as JBeamformPipeline
from dpdk_dc_sand_tpu.ops.coeff_gen import generate_coeff_matrix as j_generate_coeff_matrix
from dpdk_dc_sand_tpu.ops.reorder import prebeamform_reorder as j_reorder
from dpdk_dc_sand_tpu.ops.reorder import prebeamform_reorder_inverse as j_reorder_inverse
from dpdk_dc_sand_tpu_torch import ArrayConfig, BeamformPipeline
from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_matrix
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import generate_coeff_matrix
from dpdk_dc_sand_tpu_torch.ops.reorder import prebeamform_reorder, prebeamform_reorder_inverse

SHAPES = ("complexity", "n_blocks", "n_engines", "window_size", "ingest_shape",
          "reordered_shape", "delay_vals_shape", "coeff_shape", "beam_shape")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(n_ants=80, n_channels=32768, n_beams=16, n_taps=16),
     dict(n_ants=19, n_channels=4096, n_beams=4, n_batches=3, n_samples_per_channel=128),
     dict(n_ants=5, n_channels=256, sample_bitwidth=4)],
    ids=["default", "flagship", "batched", "4bit"],
)
def test_derived_shapes_match_the_reference(kw):
    port, ref = ArrayConfig(**kw), JArrayConfig(**kw)
    for name in SHAPES:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("block", [16, 8])
def test_reorder_and_inverse_bit_exact(block):
    cfg = ArrayConfig(n_ants=5, n_channels=256, n_batches=2, n_samples_per_channel=64)
    x = np.random.default_rng(block).integers(-128, 128, cfg.ingest_shape, dtype=np.int8)
    want = np.asarray(j_reorder(jnp.asarray(x), block))
    got = prebeamform_reorder(torch.from_numpy(x), block)
    assert tuple(got.shape) == want.shape
    if block == 16:
        assert tuple(got.shape) == cfg.reordered_shape
    np.testing.assert_array_equal(got.numpy(), want)
    back = prebeamform_reorder_inverse(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_reorder_inverse(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="block size"):
        prebeamform_reorder(torch.from_numpy(x), 7)


@pytest.mark.parametrize("xeng_id,t_s", [(0, 0.0), (2, 1.5e-3)])
def test_generate_coeff_matrix_matches_reference(xeng_id, t_s):
    cfg = ArrayConfig(n_ants=6, n_channels=1024, n_beams=4, n_batches=2)
    rng = np.random.default_rng(31 + xeng_id)
    dv = np.zeros(cfg.delay_vals_shape, np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 1] = rng.uniform(-1e-11, 1e-11, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    dv[..., 3] = rng.uniform(-1e-2, 1e-2, dv.shape[:-1])
    kw = dict(n_batches=cfg.n_batches, n_pols=cfg.n_pols, n_channels=cfg.n_channels,
              n_channels_per_stream=cfg.n_channels_per_stream,
              sample_period=cfg.sample_period, xeng_id=xeng_id, t_s=t_s)
    want = np.asarray(j_generate_coeff_matrix(jnp.asarray(dv), **kw))
    got = generate_coeff_matrix(torch.from_numpy(dv), **kw)
    assert tuple(got.shape) == want.shape == cfg.coeff_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.combinations(
    "n_ants, n_channels, n_beams, n_batches",
    parameters.array_size,
    parameters.num_channels,
    parameters.num_beams,
    parameters.num_batches,
)
def test_beamform_pipeline_matches_reference(n_ants, n_channels, n_beams, n_batches):
    cfg = ArrayConfig(n_ants=n_ants, n_channels=n_channels, n_beams=n_beams,
                      n_batches=n_batches)
    ref = JBeamformPipeline(JArrayConfig(**dataclasses.asdict(cfg)), xeng_id=1)
    pipe = BeamformPipeline(cfg, xeng_id=1, device="cpu")
    samples, dv = pipe.example_inputs()
    for g, r in zip((samples, dv), ref.example_inputs()):
        np.testing.assert_array_equal(g, r)
    got = pipe(samples, dv)
    assert tuple(got.shape) == cfg.beam_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(samples, dv)), rtol=1e-4, atol=1e-2)


def test_beamform_pipeline_bf16_rounds_only_the_weights():
    """bf16: the f32 product of the int8 samples and the bf16-rounded blocks
    (exact products, f32 sums in the same order: rtol 1e-5 / atol 1e-3)."""
    cfg = ArrayConfig(n_ants=8, n_channels=1024, n_beams=16)
    pipe = BeamformPipeline(cfg, precision="bf16", device="cpu")
    samples, dv = pipe.example_inputs(seed=4)
    coeffs = generate_coeff_matrix(
        torch.from_numpy(dv), n_batches=cfg.n_batches, n_pols=cfg.n_pols,
        n_channels=cfg.n_channels, n_channels_per_stream=cfg.n_channels_per_stream,
        sample_period=cfg.sample_period)
    want = beamform_matrix(prebeamform_reorder(torch.from_numpy(samples)),
                           coeffs.to(torch.bfloat16).float(), "f32")
    got = pipe(samples, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-3)
    assert not torch.equal(got, BeamformPipeline(cfg, device="cpu")(samples, dv))


def test_beamform_pipeline_defaults_to_the_card(monkeypatch):
    cfg = ArrayConfig(n_ants=4, n_channels=256, n_beams=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BeamformPipeline(cfg)
    assert BeamformPipeline(cfg, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="precision"):
        BeamformPipeline(cfg, precision="f16", device="cpu")
