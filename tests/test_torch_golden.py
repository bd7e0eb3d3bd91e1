"""The port's numpy oracles and delay models vs the JAX package's originals.

Each case runs one function of ``golden``, ``delay_solution`` or
``delay_tracking`` on the inputs of ``tests/test_golden_models.py``,
``tests/test_delay_tracking.py`` and ``tests/test_delay_solution.py``,
once through the port's copy and once through the JAX package's original,
and holds the two bit-exact (tolerance 0: ``assert_array_equal`` with the
same dtype, ``==`` on scalars, the same exception type). The two reference
bugs ``golden/coeffs.py`` declines to copy are held as behaviour on both
sides, ``delay_tracking.main`` must print the same lines on the same csv,
and the signal-chain demo runs on the CPU.
"""

import contextlib
import io
import runpy
import types
from pathlib import Path

import numpy as np
import pytest

import dpdk_dc_sand_tpu.config as j_config
import dpdk_dc_sand_tpu.delay_solution as j_ds
import dpdk_dc_sand_tpu.delay_tracking as j_dt
import dpdk_dc_sand_tpu.golden as j_golden
import dpdk_dc_sand_tpu.golden.coeffs as j_coeffs
import dpdk_dc_sand_tpu_torch.config as p_config
import dpdk_dc_sand_tpu_torch.delay_solution as p_ds
import dpdk_dc_sand_tpu_torch.delay_tracking as p_dt
import dpdk_dc_sand_tpu_torch.golden as p_golden
from dpdk_dc_sand_tpu_torch.examples import signal_chain_demo
from dpdk_dc_sand_tpu_torch.golden import coeffs as p_coeffs

ROOT = Path(__file__).resolve().parents[1]
REF = types.SimpleNamespace(golden=j_golden, coeffs=j_coeffs, dt=j_dt, ds=j_ds, cfg=j_config)
PORT = types.SimpleNamespace(golden=p_golden, coeffs=p_coeffs, dt=p_dt, ds=p_ds, cfg=p_config)
ANTS_CSV = "name,lon,lat\nm000,21.44,-30.71\nm001,21.45,-30.71\ne154,21.60,-30.90\n"


def _rng():
    return np.random.default_rng(2021)


def _delay_vals(m, delay_s=0.0, phase=0.0):
    cfg = m.cfg.ArrayConfig(n_ants=4, n_channels=256, n_beams=4)
    dv = np.zeros(cfg.delay_vals_shape, np.float32)
    dv[..., 0] = delay_s
    dv[..., 2] = phase
    return cfg, dv


def _steer(m, delay_s, phase, **kw):
    cfg, dv = _delay_vals(m, delay_s, phase)
    return m.golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period, **kw)


def _extrapolated(m):
    cfg, dv = _delay_vals(m, 1e-9, 0.1)
    dv[..., 1] = 1e-12
    dv[..., 3] = 0.05
    return m.golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period, t_s=2.0)


def _beamform_real(m):
    cfg = m.cfg.ArrayConfig(n_ants=5, n_channels=256, n_beams=3, n_batches=2)
    rng = _rng()
    samples = rng.integers(-100, 100, size=cfg.ingest_shape, dtype=np.int8)
    dv = rng.normal(size=(cfg.n_channels_per_stream, 3, 5, 4)).astype(np.float32) * np.array(
        [1e-9, 0, 1, 0], np.float32)
    w = m.golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)
    mat = m.golden.complex_to_matrix(w)
    coeffs = np.broadcast_to(mat, (cfg.n_batches, cfg.n_pols) + mat.shape).copy()
    return m.golden.beamform(m.golden.reorder(samples), coeffs), w


def _tone(k, n_spectra, taps=16, n_channels=128, d=0.0):
    n = np.arange((n_spectra + taps - 1) * 2 * n_channels)
    return 100.0 * np.cos(2 * np.pi * k * (n + d) / (2 * n_channels))


def _fine_delay_case(m):
    window = m.golden.pfb_window(16, 256)
    s_shift = m.golden.pfb_channelise(_tone(32, 8, d=0.5), window)
    return m.golden.apply_fine_delay(s_shift, np.array(0.5), np.array(0.0), 128)


def _complex(shape):
    rng = _rng()
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _csv(tmp_path, text=ANTS_CSV):
    path = tmp_path / "ants.csv"
    path.write_text(text)
    return str(path)


def _baselines(m, tmp_path):
    coords = m.dt.get_coordinates_from_csv(_csv(tmp_path))
    baselines = m.dt.calculate_baselines(coords)
    return coords, baselines, m.dt.find_longest_baseline(baselines)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__
    return None


CASES = {
    # golden/reorder
    "reorder": lambda m, t: m.golden.reorder(
        _rng().integers(0, 255, size=(2, 3, 4, 32, 2, 2), dtype=np.uint8)),
    "reorder_inverse": lambda m, t: m.golden.reorder_inverse(m.golden.reorder(
        _rng().integers(0, 255, size=(1, 5, 7, 64, 2, 2), dtype=np.uint8))),
    "reorder_bad_time_axis": lambda m, t: _raises(
        lambda: m.golden.reorder(np.zeros((1, 1, 1, 17, 2, 2), np.uint8))),
    # golden/coeffs
    "steering_pure_phase": lambda m, t: _steer(m, 0.0, 0.7),
    "steering_xeng_2": lambda m, t: _steer(m, 3.2e-9, 0.5, xeng_id=2),
    "rotation_angle": lambda m, t: m.coeffs.rotation_angle(
        _delay_vals(m, 3.2e-9, 0.5)[1], 256, 16, 1 / 1712e6, 2, np.arange(3.0)[:, None, None, None]),
    "complex_to_matrix": lambda m, t: m.golden.complex_to_matrix(_steer(m, 1e-9, 0.3)),
    "steering_coeffs_matrix": lambda m, t: m.golden.steering_coeffs_matrix(
        _delay_vals(m, 2e-9, -0.4)[1], 2, 2, 256, 1 / 1712e6),
    "steering_extrapolated": lambda m, t: _extrapolated(m),
    # golden/beamform
    "beamform_real_layout": lambda m, t: _beamform_real(m),
    "beamform_complex": lambda m, t: m.golden.beamform_complex(
        _complex((1, 4, 8)), np.ones((1, 1, 8), np.complex64) / 8),
    # golden/pfb
    "pfb_window": lambda m, t: [m.golden.pfb_window(taps, fft) for taps, fft in
                                ((16, 256), (4, 64), (8, 1024), (3, 10))],
    "pfb_window_f64": lambda m, t: m.golden.pfb_window(4, 64, dtype=np.float64),
    "pfb_fir": lambda m, t: m.golden.pfb_fir(
        _rng().normal(size=(2, 10 * 64)), m.golden.pfb_window(4, 64)),
    "pfb_fir_too_short": lambda m, t: _raises(
        lambda: m.golden.pfb_fir(np.zeros(2 * 64), m.golden.pfb_window(4, 64))),
    "pfb_channelise_tones": lambda m, t: [
        m.golden.pfb_channelise(_tone(k, 8), m.golden.pfb_window(16, 256)) for k in (3, 37, 100)],
    "pfb_channelise_noise": lambda m, t: m.golden.pfb_channelise(
        _rng().normal(size=(2, 19 * 256)), m.golden.pfb_window(16, 256)),
    # golden/delay
    "coarse_delay": lambda m, t: [m.golden.coarse_delay(np.arange(100.0), d) for d in (0, 7)],
    "coarse_delay_negative": lambda m, t: _raises(
        lambda: m.golden.coarse_delay(np.arange(10.0), -1)),
    "fine_delay_phase": lambda m, t: m.golden.fine_delay_phase(
        np.array([0.1, -0.3, 0.45]), np.array([0.0, 0.2, -1.0]), 128, 16, 32),
    "apply_fine_delay": lambda m, t: _fine_delay_case(m),
    "apply_fine_delay_zero": lambda m, t: m.golden.apply_fine_delay(
        _complex((3, 4, 16)), np.zeros(3), np.zeros(3), 16),
    # golden/requant
    "requantise_real": lambda m, t: m.golden.requantise(
        np.array([0.4, 0.6, -200.0, 200.0, 126.49, 0.5, 1.5, -2.5]), 1.0),
    "requantise_complex": lambda m, t: m.golden.requantise(
        np.array([1.0 + 2.0j, -3.0 - 4.0j, 0.05 + 0.15j]), 10.0),
    # golden/correlate
    "correlate": lambda m, t: m.golden.correlate(_complex((3, 16, 6))),
    "correlate_planar": lambda m, t: m.golden.correlate_planar(
        *_rng().integers(-128, 128, size=(2, 3, 16, 6), dtype=np.int8)),
    # delay_tracking
    "geodetic_to_ecef": lambda m, t: [m.dt.geodetic_to_ecef(*p) for p in
                                      ((0.0, 0.0), (90.0, 0.0), (-30.7, 21.4, 1038.0))],
    "chord_distance_km": lambda m, t: [m.dt.chord_distance_km(a, b) for a, b in
                                       (((-30.0, 21.0), (-31.0, 21.0)),
                                        ((-30.7, 21.4), (-30.7, 21.4)))],
    "delay_from_elevation": lambda m, t: [
        m.dt.calculate_delay_from_source_elevation(10_000.0, e) for e in (0.0, 15.0, 90.0)],
    "delay_from_elevation_91": lambda m, t: _raises(
        lambda: m.dt.calculate_delay_from_source_elevation(10_000.0, 91.0)),
    "delay_rate_of_change": lambda m, t: [
        m.dt.calculate_delay_rate_of_change(17e3, e, 90 / 21600, k)
        for e, k in ((15.0, "min"), (90.0, "max"))],
    "requirements": lambda m, t: m.dt.calculate_delay_tracking_requirements(10.0),
    "csv_baselines": lambda m, t: _baselines(m, t),
    "csv_lat_first_no_labels": lambda m, t: m.dt.get_coordinates_from_csv(
        _csv(t, "m000;-30.71;21.44\nm001;-30.83;21.58\n"), delimiter=";", col_labels=False,
        latitude_first=True),
    "max_coarse_delay_samples": lambda m, t: m.dt.max_coarse_delay_samples(17.0, 1712e6),
    "speed_of_light": lambda m, t: m.dt.SPEED_OF_LIGHT,
    # delay_solution
    "evaluate_delay_polynomial": lambda m, t: m.ds.evaluate_delay_polynomial(
        np.array([1e-6, 0.0]), np.array([1e-9, -2e-12]), 2.5),
    "split_delay": lambda m, t: m.ds.split_delay(
        np.array([0.0, 1.23456789e-6, 3.1e-9, 170.2 / 1712e6]), 1712e6),
    "delay_solution": lambda m, t: [m.ds.delay_solution(
        np.array([1e-6]), np.array([1e-9]), np.array([0.1]), np.array([0.05]),
        t_s=ts, adc_sample_rate=1712e6) for ts in (0.0, 2.0)],
    "delay_solution_fengine_case": lambda m, t: m.ds.delay_solution(
        np.array([0.0, 5.3 / 1712e6]), np.zeros(2), np.zeros(2), np.zeros(2),
        t_s=0.0, adc_sample_rate=1712e6),
    "fringe_phase": lambda m, t: m.ds.fringe_phase(np.array([1e-9, 2e-9]), 856e6, 0.25),
    "chunk_of_timestamp": lambda m, t: [m.ds.chunk_of_timestamp(ts, 4096, ep) for ts, ep in
                                        ((0, 0), (10000, 0), (10000, 4096))],
    "next_aligned_timestamp": lambda m, t: [m.ds.next_aligned_timestamp(ts, 4096) for ts in
                                            (10000, 8192, 1)],
    "chunk_before_epoch": lambda m, t: _raises(
        lambda: m.ds.chunk_of_timestamp(5, 4096, epoch=4096)),
}


def _same(got, ref):
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    elif isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            _same(got[k], ref[k])
    else:
        assert type(got) is type(ref) and got == ref, (got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_equals_the_original_bit_for_bit(case, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = CASES[case](REF, tmp_path / "ref")
    _same(CASES[case](PORT, tmp_path / "port"), ref)


@pytest.mark.parametrize("m", [REF, PORT], ids=["reference", "port"])
def test_declined_reference_bugs_behave_as_documented(m):
    """``golden/coeffs.py:20-31``: both copies implement the intended physics.

    The typo ``fDelayRate_sps`` for ``fDelay_s`` is not copied: the channel
    slope at ``t`` uses ``delay + rate·t``, so extrapolating equals a solution
    with the rates folded in. The cross-wired index is not copied: weight
    (beam b, antenna a) uses ``delay_vals[..., b, a]`` even when the delays
    are not uniform.
    """
    cfg, dv = _delay_vals(m, 1e-9, 0.1)
    dv[..., 1], dv[..., 3] = 1e-12, 0.05
    folded = dv.copy()
    folded[..., 0] += 1e-12 * 2.0
    folded[..., 2] += 0.05 * 2.0
    folded[..., 1] = folded[..., 3] = 0.0
    args = (cfg.n_channels, cfg.sample_period)
    np.testing.assert_allclose(m.golden.steering_coeffs_complex(dv, *args, t_s=2.0),
                               m.golden.steering_coeffs_complex(folded, *args),
                               rtol=1e-5, atol=1e-6)
    # Non-uniform delays: each (b, a) weight depends on its own entry only.
    dv = np.zeros(cfg.delay_vals_shape, np.float32)
    grid = (np.arange(4)[:, None] * 4 + np.arange(4)[None, :]).astype(np.float32)
    dv[..., 0] = grid * 1e-10
    w = m.golden.steering_coeffs_complex(dv, *args)
    for b, a in ((0, 3), (3, 0), (1, 2)):
        one = np.zeros_like(dv)
        one[..., 0] = dv[0, b, a, 0]
        np.testing.assert_array_equal(w[:, b, a],
                                      m.golden.steering_coeffs_complex(one, *args)[:, 0, 0])


@pytest.mark.parametrize("argv", [[], ["-l"], ["-n"], ["-d", ";"]],
                         ids=["default", "lat-first", "no-labels", "delimiter"])
def test_delay_tracking_main_prints_the_same_lines(argv, tmp_path):
    text = ANTS_CSV.replace(",", ";") if "-d" in argv else ANTS_CSV
    if "-n" in argv:
        text = text.split("\n", 1)[1]
    path = _csv(tmp_path, text)
    outs = []
    for main in (j_dt.main, p_dt.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([path, *argv])
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert "Maximum Delay Compensation" in outs[1]


def test_signal_chain_demo_runs_on_the_cpu_and_prints_the_reference_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert signal_chain_demo.main([]) == 0
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "signal_chain_demo.py"), run_name="__main__")
    assert buf.getvalue() == ref.getvalue()
    gain, scrambled = signal_chain_demo.run()
    assert gain > 0.95 * 64 and scrambled < 0.3


def test_port_modules_are_the_one_home_of_window_and_requant():
    from dpdk_dc_sand_tpu_torch.ops import pfb
    from dpdk_dc_sand_tpu_torch.stream import feed

    assert pfb.pfb_window is p_golden.pfb_window
    assert feed.requantise is p_golden.requantise
    assert p_coeffs.rotation_angle.__module__ == "dpdk_dc_sand_tpu_torch.golden.coeffs"
