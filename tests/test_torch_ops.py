"""The PyTorch port's leaf ops vs the JAX reference, plus the port's guards.

Inputs come from numpy generators and go through both packages; requant,
coarse delay and the steering block layout are bit-exact, the cos/sin
planes agree to f32 ulps (atol 1e-5).
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.config import DelayModel as JDelayModel
from dpdk_dc_sand_tpu.golden import pfb as golden_pfb
from dpdk_dc_sand_tpu.ops import coeff_gen as jcoeff
from dpdk_dc_sand_tpu.ops import delay as jdelay
from dpdk_dc_sand_tpu.ops import pfb as jpfb
from dpdk_dc_sand_tpu.ops.fengine_pallas import (
    fine_rotation_planes as j_fine_rotation_planes,
)
from dpdk_dc_sand_tpu.ops.requant import requantise as j_requantise
from dpdk_dc_sand_tpu_torch import ArrayConfig, DelayModel, _build
from dpdk_dc_sand_tpu_torch.models import FBEngine
from dpdk_dc_sand_tpu_torch.ops import coeff_gen, delay, pfb
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import fengine_fused, fine_rotation_planes
from dpdk_dc_sand_tpu_torch.ops.requant import requantise


@pytest.mark.parametrize("scale", [1.0, 1 / 16, 0.37])
def test_requantise_bit_exact(scale):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 900, (4, 257)).astype(np.float32)
    x[0, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -127.5]  # ties, clips
    got = requantise(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_requantise(jnp.asarray(x), scale)))


def test_coarse_delay_bit_exact_with_dynamic_slice_clamp():
    rng = np.random.default_rng(5)
    stream = rng.integers(-128, 128, (4, 2, 700), dtype=np.int8)
    out_len = 512
    # The last two delays run past the stream: dynamic_slice clamps them.
    d = np.array([0, 37, 188, 400], np.int32)
    got = delay.coarse_delay(torch.from_numpy(stream), torch.from_numpy(d), out_len)
    ref = jdelay.coarse_delay(jnp.asarray(stream), jnp.asarray(d), out_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    starts = delay.clamp_starts(torch.tensor([-5, 10, 999]), 700, out_len)
    assert starts.tolist() == [0, 10, 188]


def test_apply_fine_delay_matches_reference():
    rng = np.random.default_rng(9)
    re = rng.normal(0, 50, (3, 2, 4, 256)).astype(np.float32)
    im = rng.normal(0, 50, (3, 2, 4, 256)).astype(np.float32)
    fd = rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32)
    ph = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    got = delay.apply_fine_delay(
        torch.from_numpy(re), torch.from_numpy(im), fd, ph, n_channels=256
    )
    ref = jdelay.apply_fine_delay(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fd), jnp.asarray(ph), n_channels=256
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("xeng_id,t_s", [(0, 0.0), (1, 2.5e-3), (3, -1.0)])
def test_steering_coeffs_match_reference(xeng_id, t_s):
    rng = np.random.default_rng(11 + xeng_id)
    c, b, a = 64, 4, 6
    dv = np.zeros((b, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, (b, a))
    dv[..., 1] = rng.uniform(-1e-11, 1e-11, (b, a))
    dv[..., 2] = rng.uniform(-np.pi, np.pi, (b, a))
    dv[..., 3] = rng.uniform(-1e-2, 1e-2, (b, a))
    kw = dict(n_channels=4 * c, n_channels_per_stream=c, xeng_id=xeng_id, t_s=t_s)
    got = coeff_gen.steering_coeffs(torch.from_numpy(dv), **kw)
    ref = jcoeff.steering_coeffs(jnp.broadcast_to(jnp.asarray(dv), (c, b, a, 4)), **kw)
    for g, r in zip(got, ref):
        assert g.shape == (c, b, a)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_steering_blockcat_bit_exact():
    rng = np.random.default_rng(13)
    cos = rng.uniform(-1, 1, (8, 4, 6)).astype(np.float32)
    sin = rng.uniform(-1, 1, (8, 4, 6)).astype(np.float32)
    got = coeff_gen.steering_coeff_blockcat(torch.from_numpy(cos), torch.from_numpy(sin))
    ref = jcoeff.steering_coeff_blockcat(jnp.asarray(cos), jnp.asarray(sin))
    assert got.shape == (8, 12, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_steering_key_matches_reference():
    rng = np.random.default_rng(17)
    dv = rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)
    w = rng.uniform(0, 1, 6).astype(np.float32)
    for aw, t in ((None, 0.0), (w, 1.5)):
        assert coeff_gen.steering_key(dv, aw, t) == jcoeff.steering_key(dv, aw, t)
        assert coeff_gen.steering_key(torch.from_numpy(dv), aw, t) == jcoeff.steering_key(
            dv, aw, t
        )
    dv2 = dv.copy()
    dv2[0, 0, 0] += 1e-3
    assert coeff_gen.steering_key(dv2, None, 0.0) != coeff_gen.steering_key(dv, None, 0.0)


@pytest.mark.parametrize("n_channels", [512, 1024, 2048])
def test_fine_rotation_planes_match_reference(n_channels):
    rng = np.random.default_rng(19)
    fd = rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32)
    ph = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    kw = dict(n_channels=n_channels, quant_scale=1 / 16)
    got = fine_rotation_planes(torch.from_numpy(fd), torch.from_numpy(ph), **kw)
    ref = j_fine_rotation_planes(jnp.asarray(fd), jnp.asarray(ph), **kw)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_pfb_channelise_matches_reference():
    rng = np.random.default_rng(23)
    taps, fft, s = 4, 512, 6
    x = rng.integers(-64, 64, (2, (s + taps - 1) * fft), dtype=np.int8)
    win = pfb.default_window(taps, fft)
    got = pfb.pfb_channelise(torch.from_numpy(x), win)
    ref = jpfb.pfb_channelise(jnp.asarray(x), jpfb.default_window(taps, fft), use_pallas=False)
    assert got.shape == (2, s, fft // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("taps,fft", [(4, 512), (8, 2048), (16, 1024)])
def test_pfb_window_bit_exact(taps, fft):
    np.testing.assert_array_equal(pfb.pfb_window(taps, fft), golden_pfb.pfb_window(taps, fft))
    assert pfb.default_window(taps, fft).dtype == torch.float32


def test_config_matches_reference():
    kw = dict(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
    port, ref = ArrayConfig(**kw), JArrayConfig(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for name in ("sample_period", "n_samples_per_block", "n_channels_per_stream", "fft_size"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.channel_offset(3) == ref.channel_offset(3)
    for bad in (dict(n_channels=1000), dict(n_samples_per_channel=24)):
        with pytest.raises(ValueError):
            ArrayConfig(**bad)
        with pytest.raises(ValueError):
            JArrayConfig(**bad)
    dv = np.random.default_rng(29).uniform(-1, 1, (4, 6, 4)).astype(np.float32)
    pm, rm = DelayModel.from_delay_vals(dv), JDelayModel.from_delay_vals(dv)
    np.testing.assert_array_equal(pm.to_delay_vals(3), rm.to_delay_vals(3))
    np.testing.assert_array_equal(
        pm.at_time(2.5).to_delay_vals(1), rm.at_time(2.5).to_delay_vals(1)
    )


def test_port_never_imports_jax_or_the_reference():
    # Every module of the package, found by walking it, so that a new one
    # cannot escape the guard.
    code = (
        "import importlib, pkgutil, sys; import dpdk_dc_sand_tpu_torch as pkg; "
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
        "[importlib.import_module(n) for n in names]; "
        "want = {'engine_node', 'stream.feed', 'control.protocol', 'utils.timing', "
        "'examples.full_instrument_demo', 'ops.vector_add', 'models.fbengine', 'convert', "
        "'parallel.fbengine_sharded', 'parallel.mesh', 'parallel.ingest', 'parallel.launch', "
        "'parallel.__main__', 'characterize.mxu', 'characterize.__main__', 'golden.coeffs', "
        "'delay_solution', 'delay_tracking', 'control.servlet', 'control.fake_node', "
        "'control.launch', 'examples.signal_chain_demo'}; "
        "missing = {'dpdk_dc_sand_tpu_torch.' + w for w in want} - set(names); "
        "assert not missing, missing; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dpdk_dc_sand_tpu')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_build_without_nvcc_raises_naming_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize(
    "kw",
    [dict(bstage="planar"), dict(bstage="folded"),
     dict(bstage="turned", n_spectra=24), dict(n_spectra=24)],
    ids=["planar", "folded", "turned", "geometry"],
)
def test_fbengine_rejects_unported_backends(kw):
    """Every B form runs, and at S = 24 (outside K2's and K4's reference
    gates) ``"auto"`` resolves ``"planar"``; an explicit ``"turned"`` there
    raises. Each form agrees with the turned form (S = 64) or the folded
    one (S = 24) in f32 within rtol 1e-5 / atol 1e-4: the same products
    summed in another order (tests/test_models.py:251-263)."""
    cfg = ArrayConfig(n_ants=4, n_channels=512, n_beams=16, n_taps=4)
    kw = {"n_spectra": 64, "precision": "f32", **kw}
    if kw.get("bstage") == "turned":
        with pytest.raises(NotImplementedError, match="geometry"):
            FBEngine(cfg, device="cpu", **kw)
        return
    fb = FBEngine(cfg, device="cpu", **kw)
    assert fb.bstage == kw.get("bstage", "planar")
    ref = FBEngine(cfg, device="cpu", **{
        **kw, "bstage": "turned" if kw["n_spectra"] == 64 else "folded"})
    inputs = fb.example_inputs(seed=4, margin=1024)
    got, want = fb(*inputs), ref(*inputs)
    assert got.shape == (cfg.n_pols, cfg.n_channels, kw["n_spectra"], cfg.n_beams, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ["FEngine", "FBEngine", "FXBEngine", "XEngine"])
def test_engines_default_to_the_card_and_name_the_cpu_opt_in(engine, monkeypatch):
    """No ``device`` means ``cuda``: without a card the engine raises and
    names ``device="cpu"``; it never builds its buffers on the CPU unasked."""
    from dpdk_dc_sand_tpu_torch import models

    cls = getattr(models, engine)
    cfg = ArrayConfig(n_ants=4, n_channels=512, n_beams=16, n_taps=4)
    kw = {} if engine == "XEngine" else {"n_spectra": 128}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(cfg, **kw)
    assert cls(cfg, device="cpu", **kw).device == torch.device("cpu")


def test_wrapper_refuses_devices_without_a_kernel():
    frames = torch.zeros((1, 1, 4, 1024), dtype=torch.int8, device="meta")
    win = torch.zeros((4, 1024), device="meta")
    zero = torch.zeros((1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        fengine_fused(frames, win, zero, zero, n_channels=512, quant_scale=1.0,
                      rot_planes=(torch.zeros(1, 1, 64, 8), torch.zeros(1, 1, 64, 8)))
