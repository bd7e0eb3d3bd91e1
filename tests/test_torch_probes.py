"""The port's probes (P1-P5) against the JAX package's probe scripts.

Each JAX probe in ``benchmarks/`` builds a ``pallas_call`` for the TPU; here
it runs in interpret mode, unchanged: the scripts are loaded by file path
and ``jax.experimental.pallas.pallas_call`` is wrapped so that it drops the
TPU's ``compiler_params`` and interprets. Where a script builds its kernel
inside a timing run (``ct_ablate.run_variant``), a recorder captures the
kernel and its arguments and the test issues the call itself; where the
kernel's arguments are locals (``fused_ablate.run_variant``), the test
builds the call from ``build_kernel`` with ``run_variant``'s specs. Module
globals (antennas, channels, slab sizes, passes) are shrunk so each case
takes a few seconds.

Each probe's plain version in the port, with the same inputs made by numpy,
is held to its JAX probe: P1 exact; P3 within rtol 1e-6 (the same f32 tap
order); P4 exact; P5 and P2 exact at the stops before the DFT and within 1
int8 code on <= 1e-3 of the samples after it, as K1 (bf16 DFT operands, f32
sums in another order).
"""

import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dpdk_dc_sand_tpu_torch.benchmarks import (
    _chain,
    ct_ablate,
    ct_kernel_probe,
    dma_bisect,
    fir_probe,
    fused_ablate,
)
from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

ROOT = pathlib.Path(__file__).resolve().parents[1]
_REAL_PALLAS_CALL = pl.pallas_call


def _load(name):
    """A JAX probe script, loaded by file path (``benchmarks/`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpreted(kernel, *args, compiler_params=None, **kwargs):
    return _REAL_PALLAS_CALL(kernel, *args, interpret=True, **kwargs)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", _interpreted)


def _codes_close(got, ref, exact):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    if exact:
        assert d.max() == 0, (d.max(), (d != 0).mean())
    else:
        assert d.max() <= 1, d.max()
        assert (d != 0).mean() <= 1e-3, (d != 0).mean()


@pytest.mark.parametrize("mode", ["copy", "i8", "i32", "i8m", "i8m2"])
def test_p1_plain_matches_the_jax_probe(mode, interpret, monkeypatch):
    jp = _load("ct_kernel_probe")
    a, s, c = 4, 32, 64
    monkeypatch.setattr(jp, "A", a)
    monkeypatch.setattr(jp, "C", c)
    rng = np.random.default_rng(5)
    qr, qi = (rng.integers(-128, 128, (a, jp.P, s, c), dtype=np.int8) for _ in "ri")
    want = np.asarray(jp.make_ct(mode, 32, 16, s)(jnp.asarray(qr), jnp.asarray(qi)))
    before = ct_kernel_probe.ct_probe.launches
    got = ct_kernel_probe.make_ct(mode, 32, 16, s)(torch.from_numpy(qr), torch.from_numpy(qi))
    assert ct_kernel_probe.ct_probe.launches == before  # the CPU never launches
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["persi", "tapouter"])
def test_p3_plain_matches_the_jax_probe(kind, interpret, monkeypatch):
    jp = _load("fir_probe")
    n1 = n2 = 8
    for name, v in (("N1", n1), ("N2", n2), ("REPS", 3)):
        monkeypatch.setattr(jp, name, v)
    rng = np.random.default_rng(0)
    x = rng.normal(size=((jp.J + jp.TAPS - 1) * n1, n2)).astype(np.float32)
    w = rng.normal(size=(jp.TAPS * n1, n2)).astype(np.float32)
    want = np.asarray(jp.make(kind)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)))
    got = fir_probe.fir_probe(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                              kind, reps=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_p4_v0_plain_matches_the_jax_probe(interpret, monkeypatch):
    jp = _load("dma_bisect")
    monkeypatch.setattr(jp, "A", 1)
    monkeypatch.setattr(jp, "P", 1)
    s = 32
    fr = np.random.default_rng(7).integers(-64, 64, (1, (s + 15) * 256, 256), dtype=np.int8)
    want = jp.trimmed_call(s, 16)(jnp.asarray(fr))
    zero = torch.zeros(1)
    rot = (torch.zeros((1, 128, 256)),) * 2
    got = ff.fengine_fused(torch.from_numpy(fr), torch.zeros((16, 65536)), zero, zero,
                           n_channels=32768, quant_scale=1.0, rowed=True, rot_planes=rot,
                           _ablate="dma")
    plain = dma_bisect.reference(torch.from_numpy(fr))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), np.asarray(w))
        np.testing.assert_array_equal(p.numpy().reshape(w.shape), np.asarray(w))


class _Captured(Exception):
    pass


#: The window's scale at each stop of P5, so that the stop's values stay in
#: int8 range (a few codes at the FIR, tens at stage B): a 1-code flip
#: through another f32 order is about as likely as the values are large.
_P5_SCALE = {"dma": 1 / 64, "fir": 1 / 64, "stagea": 1 / 256, "stageb": 1 / 1024,
             "full": 1 / 256}


def _p5_inputs(s, scale):
    """The probe's operands at A = P = 1: int8 frames, a standard-normal
    window times ``scale``, the port's DFT constants and standard-normal
    rotation planes."""
    rng = np.random.default_rng(11)
    fr = rng.integers(-64, 64, (1, (s + 15) * 256, 256), dtype=np.int8)
    wina = (rng.standard_normal((16 * 256, 256)) * scale).astype(np.float32)
    k = ff.dft_constants(256, 256, "cpu")
    consts = [t.numpy() for t in (k.d1c, k.d1s, k.d2[:128], k.d2[128:], k.twc, k.tws)]
    rot = [rng.standard_normal((1, 128, 256)).astype(np.float32) for _ in "cs"]
    return fr, wina, consts, rot


@pytest.mark.parametrize("stop", ct_ablate.STOPS)
def test_p5_plain_matches_the_jax_probe(stop, monkeypatch):
    jp = _load("ct_ablate")
    monkeypatch.setattr(jp, "A", 1)
    monkeypatch.setattr(jp, "P", 1)
    seen = {}

    def record(kernel, **kwargs):
        seen.update(kernel=kernel, kwargs=kwargs)
        raise _Captured

    monkeypatch.setattr(pl, "pallas_call", record)
    s = 16
    with pytest.raises(_Captured):
        jp.run_variant(stop, s, 16)
    kwargs = {k: v for k, v in seen["kwargs"].items() if k != "compiler_params"}
    fr, wina, consts, rot = _p5_inputs(s, _P5_SCALE[stop])
    want = _REAL_PALLAS_CALL(seen["kernel"], interpret=True, **kwargs)(
        jnp.asarray(fr), jnp.asarray(wina), *map(jnp.asarray, consts), *map(jnp.asarray, rot))
    rc, rs = (torch.from_numpy(r) for r in rot)
    inp = dict(fr=torch.from_numpy(fr), wina=torch.from_numpy(wina).reshape(16, 65536),
               rot=(rc, rs), rot16=(rc / 16, rs / 16))
    got = ct_ablate.call(stop, inp)
    for g, w in zip(got, want):
        _codes_close(g.numpy(), np.asarray(w).reshape(g.shape), stop in ("dma", "fir"))


@pytest.mark.parametrize("stop", ["dma", "conv", "fir", "stageb", "full"])
def test_p2_plain_matches_the_jax_probe(stop, interpret):
    jp = _load("fused_ablate")
    from jax.experimental.pallas import tpu as pltpu

    # run_variant's specs at batch 1, on a narrower geometry of the same
    # shape (n1 = 2*n2, so the probe's slices are the first and last N
    # samples; 2*n2 >= 128 for its DMA probe's tile): fft 16384, 16 taps,
    # one block of s_blk = 16 spectra.
    n1, n2, taps, s_blk = 128, 64, 16, 16
    s, n = 16, n1 * n2
    rows = (s_blk + taps - 1) * n1
    rng = np.random.default_rng(3)
    fr = rng.integers(-64, 64, (1, (s + taps - 1) * n1, 2 * n2), dtype=np.int8)
    win = (rng.standard_normal((taps * n1, 2 * n2)) / 64).astype(np.float32)
    k = ff.dit_constants(n1, n2, "cpu")
    sel = np.zeros((2 * n2, 2 * n2), np.float32)
    sel[2 * np.arange(n2), np.arange(n2)] = 1.0
    sel[2 * np.arange(n2) + 1, n2 + np.arange(n2)] = 1.0
    consts = [t.numpy() for t in (k.d1c, k.d1s, k.d2c, k.d2s)]
    consts += [np.tile(k.twc.numpy(), (1, s_blk)), np.tile(k.tws.numpy(), (1, s_blk)),
               k.untc.numpy(), k.unts.numpy(), sel]
    vmem = pltpu.VMEM
    out_spec = pl.BlockSpec((1, s_blk, n2, n1), lambda b, i: (b, i, 0, 0), memory_space=vmem)
    call = pl.pallas_call(
        functools.partial(jp.build_kernel(stop), s_blk=s_blk, n_taps=taps, n1=n1, n2=n2),
        grid=(1, s // s_blk),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(win.shape, lambda b, i: (0, 0), memory_space=vmem),
                  *[pl.BlockSpec(c.shape, lambda b, i: (0, 0), memory_space=vmem)
                    for c in consts]],
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((1, s, n2, n1), jnp.int8),) * 2,
        scratch_shapes=[pltpu.VMEM((2, rows, 2 * n2), jnp.int8),
                        pltpu.VMEM((n1, s_blk * n2), jnp.bfloat16),
                        pltpu.VMEM((n1, s_blk * n2), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2,))],
    )
    want = call(jnp.asarray(fr), jnp.asarray(win), *map(jnp.asarray, consts))
    frames = torch.from_numpy(fr).reshape(1, s + taps - 1, 2 * n)
    rc = torch.full((1, n), 1 / 16)
    rot = (rc, torch.zeros_like(rc)) if stop == "full" else None
    got = ff.fengine_dit_ablate(frames, torch.from_numpy(win).reshape(taps, 2 * n), n1=n1, n2=n2,
                                stop=stop, rot=rot)
    for g, w in zip(got, want):
        _codes_close(g.numpy(), np.asarray(w).reshape(g.shape), stop in ("dma", "conv", "fir"))


def test_fused_ablate_module_runs_every_stop_on_the_cpu():
    """The port's P2 module end to end at batch 1, S = 16: each stop is its
    plain version, whose deint and stagea stops hold each spectrum's own
    values (the even / odd bf16 FIR samples; the rounded T re planes)."""
    inp = fused_ablate.make_inputs(16, "cpu", batch=1)
    for stop in fused_ablate.STOPS:
        got = fused_ablate.call(stop, inp)
        assert all(g.shape == (1, 16, 32768) and g.dtype == torch.int8 for g in got)
        for g, w in zip(got, fused_ablate.reference(stop, inp)):
            assert torch.equal(g, w)
    fir = ff._round_bf16(ff._dit_fir(inp["fr"], inp["win"]))
    deint = fused_ablate.call("deint", inp)
    assert torch.equal(deint[0], ff._trunc_s8(fir[..., 0::2]))
    assert torch.equal(deint[1], ff._trunc_s8(fir[..., 1::2]))


def test_ablate_reference_without_a_stop_is_k1_reference():
    rng = np.random.default_rng(2)
    fft, s, taps = 4096, 8, 4
    n1, n2 = ff._split_ct(fft)
    x = torch.from_numpy(rng.integers(-64, 64, (2, (s + taps) * fft), dtype=np.int8))
    starts = torch.tensor([0, 77])
    win = default_window(taps, fft)
    rc, rs = (torch.from_numpy(rng.standard_normal((2, fft // 2)).astype(np.float32)) / 16
              for _ in "cs")
    kw = dict(n_spectra=s, n1=n1, n2=n2)
    for g, w in zip(ff.fengine_ablate_reference(None, x, starts, win, rc, rs, **kw),
                    ff.fengine_fused_reference(x, starts, win, rc, rs, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stop", ["dma", "fir", "stagea", "stageb"])
def test_fengine_fused_ablate_on_cpu_runs_the_plain_stop(stop):
    """On CPU tensors ``_ablate`` runs the plain stop and launches nothing;
    at fft 16384 (N1 = N2 = 128) with coarse delays, one unaligned."""
    rng = np.random.default_rng(4)
    fft, s, taps = 16384, 20, 4
    n1, n2 = ff._split_ct(fft)
    x = rng.integers(-64, 64, (2, (s + taps) * fft), dtype=np.int8)
    cd = np.array([0, 33])
    fd = np.zeros(2, np.float32)
    win = default_window(taps, fft)
    before = (ff.fengine_fused.launches, ff.fengine_fused.ablate_launches)
    got = ff.fengine_fused(torch.from_numpy(x), win, fd, fd, n_channels=fft // 2,
                           quant_scale=1 / 16, coarse_delays=cd, n_spectra=s, _ablate=stop)
    assert (ff.fengine_fused.launches, ff.fengine_fused.ablate_launches) == before
    rc, rs = (r.reshape(2, -1) for r in ff.fine_rotation_planes(
        torch.from_numpy(fd), torch.from_numpy(fd), n_channels=fft // 2, quant_scale=1 / 16))
    want = ff.fengine_ablate_reference(stop, torch.from_numpy(x), torch.from_numpy(cd), win,
                                       rc, rs, n_spectra=s, n1=n1, n2=n2)
    for g, w in zip(got, want):
        assert g.shape == (2, s, fft // 2) and torch.equal(g, w)
    if stop == "dma":  # spectra 16..19 of stream 1 carry frame 16's first C samples
        # from the reference's DMA base: row 0, as a delay of 33 samples is
        # under 8 rows of N2.
        start = 16 * fft
        for sp in (16, 19):
            assert torch.equal(got[0][1, sp], torch.from_numpy(x[1, start : start + fft // 2]))


def test_fengine_fused_ablate_raises_where_the_reference_does():
    """The port refuses the stops the reference refuses (an unknown stop; a
    DFT-stage stop at N1 != N2; ``"dma"`` at N1 > N2, whose ``[N2/2, N1]``
    probe does not fit the ``[rows, N2]`` frame view) and the DIT form's,
    and the DIT form's stops other than ``"dma"``; it takes the calls the
    reference takes: f32 operands, N1 = 8 and ``quantise=False``."""
    fft, taps = 16384, 4
    frames = torch.zeros((1, 1, 10, fft), dtype=torch.int8)
    win = default_window(taps, fft)
    z = np.zeros((1, 1), np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1.0)
    with pytest.raises(ValueError, match="unknown _ablate stage 'fft'"):
        ff.fengine_fused(frames, win, z, z, _ablate="fft", **kw)
    for stop in ("fir", "stagea", "stageb"):
        with pytest.raises(ValueError, match="needs the direct-CT form"):
            ff.fengine_fused(frames, win, z, z, deint="matmul", _ablate=stop, **kw)
    wide = torch.zeros((1, 1, 10, 2048), dtype=torch.int8)  # 16 x 128
    with pytest.raises(ValueError, match="n1 == n2"):
        ff.fengine_fused(wide, default_window(taps, 2048), z, z, n_channels=1024,
                         quant_scale=1.0, _ablate="fir")
    tall = torch.zeros((1, 1, 10, 32768), dtype=torch.int8)  # 256 x 128
    with pytest.raises(ValueError, match="does not fit"):
        ff.fengine_fused(tall, default_window(taps, 32768), z, z, n_channels=16384,
                         quant_scale=1.0, _ablate="dma")
    # Taken, as the reference takes them: f32 operands, N1 = 8, no requant.
    small = torch.zeros((1, 1, 10, 1024), dtype=torch.int8)  # N1 = 8
    for got, dtype in (
        (ff.fengine_fused(frames, win, z, z, dft_dtype="float32", _ablate="dma", **kw),
         torch.int8),
        (ff.fengine_fused(small, default_window(taps, 1024), z, z, n_channels=512,
                          quant_scale=1.0, _ablate="dma"), torch.int8),
        (ff.fengine_fused(frames, win, z, z, quantise=False, _ablate="stageb", **kw),
         torch.float32),
    ):
        assert all(g.dtype == dtype and g.shape[-2] == 7 for g in got)


@pytest.mark.parametrize("deint", ["matmul", "bitcast"])
def test_fengine_fused_dit_dma_stop_is_the_reference_stopped_call(deint):
    """On the DIT form the reference's ``_ablate="dma"`` gate lets the call
    through and its DIT kernel, which takes no stop, runs whole. At fft 2048,
    on the same seed-made inputs: the JAX stopped call (``interpret=True``)
    is the JAX whole call and the port's stopped call the port's whole call,
    bit for bit on the int8 outputs; port and JAX agree as K7's plain version
    and the JAX DIT kernel do, within 1 code on <= 1e-3 of samples (their f32
    sums run in another order)."""
    from dpdk_dc_sand_tpu.ops import fengine_pallas as jfp
    from dpdk_dc_sand_tpu.ops.pfb import default_window as j_default_window

    fft, taps = 2048, 4
    rng = np.random.default_rng(2048)
    frames = rng.integers(-64, 64, (1, 1, 10, fft), dtype=np.int8)
    fd = rng.uniform(-0.5, 0.5, (1, 1)).astype(np.float32)
    ph = rng.uniform(-1, 1, (1, 1)).astype(np.float32)
    kw = dict(n_channels=fft // 2, quant_scale=1 / 16, deint=deint)
    jargs = (jnp.asarray(frames), j_default_window(taps, fft), jnp.asarray(fd), jnp.asarray(ph))
    want = jfp.fengine_fused(*jargs, interpret=True, _ablate="dma", **kw)
    j_whole = jfp.fengine_fused(*jargs, interpret=True, **kw)
    targs = (torch.from_numpy(frames), default_window(taps, fft), fd, ph)
    got = ff.fengine_fused(*targs, _ablate="dma", **kw)
    whole = ff.fengine_fused(*targs, **kw)
    for g, w, jw, h in zip(got, want, j_whole, whole):
        assert g.shape == (1, 1, 7, fft // 2) and g.dtype == torch.int8
        assert np.array_equal(np.asarray(w), np.asarray(jw))
        assert torch.equal(g, h)
        d = np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3


def test_chain_marginal_times_a_chained_call_on_the_cpu(monkeypatch):
    """Two and six fed calls: the marginal is per call, the feed adds zero.

    The clock ``_chain`` reads is a stub that each call advances by 2 ms, so
    the marginal is exact whatever else the machine is running."""
    x = torch.arange(8, dtype=torch.float32)
    calls = []
    clock = [0.0]

    def call():
        calls.append(x.clone())
        clock[0] += 0.002
        return x * 2

    monkeypatch.setattr(_chain, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    per, warm = _chain.marginal_ms(call, x)
    assert len(calls) == 2 + 2 * (2 + 6)
    assert per == pytest.approx(2.0, abs=1e-9) and warm > 0
    assert torch.equal(x, torch.arange(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        _chain.marginal_ms(call, torch.zeros((4, 4))[:, 0])
