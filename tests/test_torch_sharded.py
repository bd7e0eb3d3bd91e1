"""The sharded F+B(+X) engine of the port vs the JAX package's, on the CPU.

The JAX ``ShardedFBEngine`` runs on the test process's 8-device CPU platform
(``conftest.py``); the port's runs as spawned gloo ranks
(``parallel.launch.run_ranks``), each stepping its own shard. Each grid
(1, 2), (2, 1) and (2, 2) is launched once, by a module-scoped fixture
that steps every configuration in :func:`_specs` and returns every rank's
outputs; the (2, 2) launch first runs the rank body of
``dryrun_multichip(4, device_type="cpu")`` on its four ranks. The cases
below compare those outputs, at the tolerances of
``tests/test_sharded.py``: beams of the composed F + planar B against the
JAX engine at rtol 1e-4 / atol 1e-3, F planes within one int8 code on at
most 1e-3 of them, visibilities exactly; ``ici_chunks`` and the rowed
ingest bit for bit against their own monolithic and flat forms; the port's
fused F with turned and fused B (their plain versions, on the CPU) against
the port's single-device ``FBEngine`` on the tail-prepended stream.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from dpdk_dc_sand_tpu.config import ArrayConfig as JArrayConfig
from dpdk_dc_sand_tpu.parallel import ShardedFBEngine as JShardedFBEngine
from dpdk_dc_sand_tpu.parallel import factor_devices as j_factor_devices
from dpdk_dc_sand_tpu.parallel import make_mesh as j_make_mesh
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.models import FBEngine
from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_turned
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import steering_coeff_blockcat
from dpdk_dc_sand_tpu_torch.ops.corner_turn import corner_turn_planes
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import fengine_fused, fine_rotation_planes
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window
from dpdk_dc_sand_tpu_torch.parallel import (
    ShardedFBEngine,
    factor_devices,
    initialize_distributed,
    make_mesh,
    scatter_local,
    shard_indices,
)
from dpdk_dc_sand_tpu_torch.parallel import ingest, launch
from dpdk_dc_sand_tpu_torch.parallel.fbengine_sharded import resolve_sharded

#: tests/test_sharded.py's array; the fused-F array (the direct-CT split
#: needs 512 channels or more).
SMALL = dict(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
FUSED = dict(n_ants=8, n_channels=512, n_beams=4, n_taps=4)
XLA = dict(n_spectra=16, fengine="xla", bstage="planar")


def _cfg(fields):
    return ArrayConfig(**fields)


def _jcfg(fields):
    return JArrayConfig(**dataclasses.asdict(_cfg(fields)))


def _jax_mesh(grid):
    return j_make_mesh(grid[0] * grid[1], shape=grid)


def _steering_case(cfg_fields, seed=2021):
    """tests/test_sharded.py:285-320: delay and phase rates, weights, t_s."""
    eng = JShardedFBEngine(_jcfg(cfg_fields), _jax_mesh((1, 1)), n_spectra=16)
    dv = eng.example_inputs(seed)[3].copy()
    rng = np.random.default_rng(7)
    dv[..., 1] = rng.uniform(-1e-11, 1e-11, dv.shape[:-1])
    dv[..., 3] = rng.uniform(-0.1, 0.1, dv.shape[:-1])
    weights = rng.uniform(0.5, 1.5, cfg_fields["n_ants"]).astype(np.float32)
    return dv, weights, 1.25


def _reference_state(grid, cfg_fields, n_spectra):
    """The JAX sharded engine's window and global (cos, sin) planes."""
    eng = JShardedFBEngine(_jcfg(cfg_fields), _jax_mesh(grid), n_spectra=n_spectra,
                           fengine="xla", bstage="planar")
    eng.set_beam_delays(eng.example_inputs()[3])
    return np.asarray(eng.window), *(np.asarray(c) for c in eng._coeffs)


def _specs(grid):
    dv, weights, t_s = _steering_case(SMALL)
    fused = dict(n_spectra=64, fengine="fused")
    specs = [
        dict(name="xla", cfg=SMALL, engine=XLA),
        dict(name="planes", cfg=SMALL, engine=dict(n_spectra=16, fengine="xla", emit_planes=True)),
        dict(name="vis", cfg=SMALL, engine=dict(XLA, emit_visibilities=True)),
        dict(name="scatter", cfg=SMALL, engine=dict(XLA, scatter_beams=True)),
        dict(name="steer", cfg=SMALL, engine=XLA, delay_vals=dv, ant_weights=weights, t_s=t_s),
        dict(name="state", cfg=SMALL, engine=XLA, state=_reference_state(grid, SMALL, 16)),
        # K3's route (its plain version here): S and C_loc multiples of 128.
        dict(name="vis_k3", cfg=FUSED, engine=dict(n_spectra=128, fengine="xla",
                                                    bstage="planar", emit_visibilities=True)),
        dict(name="planes_k3", cfg=FUSED, engine=dict(n_spectra=128, fengine="xla",
                                                       emit_planes=True)),
        dict(name="flat", cfg=FUSED, engine=dict(n_spectra=16, fengine="fused")),
        dict(name="rowed", cfg=FUSED, engine=dict(n_spectra=16, fengine="fused"), rowed=True),
        dict(name="fused_turned", cfg=FUSED, engine=dict(fused, bstage="turned")),
        dict(name="fused_fused", cfg=FUSED, engine=dict(fused, bstage="fused")),
        dict(name="state_turned", cfg=FUSED, engine=dict(fused, bstage="turned"),
             state=_reference_state(grid, FUSED, 64)),
    ]
    for bstage in ("planar", "turned"):
        for k in (1, 2, 4):
            specs.append(dict(name=f"chunks{k}_{bstage}", cfg=SMALL,
                              engine=dict(XLA, bstage=bstage, ici_chunks=k)))
    return specs


def _jax_outputs(grid, specs):
    """The JAX engine's global outputs for the specs it has a counterpart of."""
    mesh = _jax_mesh(grid)
    out = {}
    for spec in specs:
        if spec["name"] not in ("xla", "planes", "vis", "scatter", "steer"):
            continue
        eng = JShardedFBEngine(_jcfg(spec["cfg"]), mesh, **spec["engine"])
        adc, fd, ph, dv = eng.example_inputs()
        res = eng(adc, fd, ph, spec.get("delay_vals", dv), ant_weights=spec.get("ant_weights"),
                  t_s=spec.get("t_s", 0.0))
        out[spec["name"]] = (tuple(np.asarray(r) for r in res) if isinstance(res, tuple)
                             else np.asarray(res))
    return out


def _launch(grid):
    specs = _specs(grid)
    jax_out = _jax_outputs(grid, specs)
    n = grid[0] * grid[1]
    ranks = launch.run_ranks(launch.step_specs, n, device_type="cpu",
                             args=(grid, "cpu", specs, grid == (2, 2)))
    return dict(grid=grid, ranks=ranks, jax=jax_out, specs={s["name"]: s for s in specs})


@pytest.fixture(scope="module")
def run_1x2():
    return _launch((1, 2))


@pytest.fixture(scope="module")
def run_2x1():
    return _launch((2, 1))


@pytest.fixture(scope="module")
def run_2x2():
    """The (2, 2) launch runs ``dryrun_multichip(4, device_type="cpu")``'s
    rank body before its specs."""
    return _launch((2, 2))


@pytest.fixture(params=["run_1x2", "run_2x1", "run_2x2"], ids=["1x2", "2x1", "2x2"])
def grid_run(request):
    return request.getfixturevalue(request.param)


def _global(run, name, placements, item=None):
    """The global array from every rank's local ``name`` output; replicas
    (ranks along an axis the placement does not name) must agree."""
    grid = run["grid"]
    axes = {"ant": 0, "time": 1}
    out = mask = None
    for rank in run["ranks"]:
        local = rank["specs"][name]["out"]
        local = local if item is None else local[item]
        if out is None:
            shape = [n * (grid[axes[p]] if p else 1)
                     for n, p in zip(local.shape, list(placements) + [None] * local.ndim)]
            out = np.zeros(shape, local.dtype)
            mask = np.zeros(shape, bool)
        idx = tuple(slice(rank["coordinate"][axes[p]] * n, (rank["coordinate"][axes[p]] + 1) * n)
                    if p else slice(None)
                    for n, p in zip(local.shape, list(placements) + [None] * local.ndim))
        if mask[idx].any():
            np.testing.assert_array_equal(out[idx], local)
        out[idx], mask[idx] = local, True
    assert mask.all()
    return out


BEAMS = (None, "time")
PLANES = ("ant", None, None, "time")
VIS = ("time",)


def _tail_prepended(spec):
    cfg = _cfg(spec["cfg"])
    eng = JShardedFBEngine(_jcfg(spec["cfg"]), _jax_mesh((1, 1)),
                           n_spectra=spec["engine"]["n_spectra"])
    adc, fd, ph, dv = eng.example_inputs(spec.get("seed", 2021))
    halo = (cfg.n_taps - 1) * cfg.fft_size
    return np.concatenate([adc[..., -halo:], adc], axis=-1), fd, ph, dv


# -- in-process: the rules that need no ranks --------------------------------


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_is_the_reference_rule(n):
    assert factor_devices(n) == j_factor_devices(n)


_BAD = [
    (dict(SMALL, n_ants=7), dict(n_spectra=16), "n_ants"),
    (dict(SMALL, n_taps=16), dict(n_spectra=16), "thinner"),
    (dict(SMALL, n_beams=3), dict(n_spectra=16, scatter_beams=True), "scatter_beams"),
    (SMALL, dict(n_spectra=32, ici_chunks=3), "ici_chunks"),
    (SMALL, dict(n_spectra=32, ici_chunks=2, emit_visibilities=True), "ici_chunks"),
    (SMALL, dict(n_spectra=18), "divide the time axis"),
    (SMALL, dict(n_spectra=16, emit_planes=True, scatter_beams=True), "emit_planes"),
    (SMALL, dict(n_spectra=16, fengine="pallas"), "fengine"),
    (SMALL, dict(n_spectra=16, bstage="folded"), "bstage"),
]


@pytest.mark.parametrize("cfg,kw,match", _BAD, ids=[f"{i}-{m}" for i, (_, _, m) in enumerate(_BAD)])
def test_bad_configurations_raise_as_the_reference(cfg, kw, match):
    """tests/test_sharded.py:85-97, 201-210, 365-375 on a (2, 4) mesh."""
    with pytest.raises(ValueError, match=match):
        JShardedFBEngine(_jcfg(cfg), _jax_mesh((2, 4)), **kw)
    with pytest.raises(ValueError, match=match):
        resolve_sharded(_cfg(cfg), (2, 4), kw.pop("n_spectra"), **kw)


_AUTO = [
    (SMALL, (2, 4), dict(n_spectra=32), 8),
    (SMALL, (2, 4), dict(n_spectra=12), 1),
    (SMALL, (2, 4), dict(n_spectra=32, emit_visibilities=True), 1),
    (SMALL, (1, 1), dict(n_spectra=32), 1),
    (dict(SMALL, n_channels=1024), (2, 2), dict(n_spectra=128, bstage="turned"), 2),
]


@pytest.mark.parametrize("cfg,grid,kw,k", _AUTO, ids=[str(i) for i in range(len(_AUTO))])
def test_ici_chunks_auto_resolves_as_the_reference(cfg, grid, kw, k):
    """tests/test_sharded.py:347-363 and 434-453: the largest of {8, 4, 2}
    dividing the per-rank spectra whose chunk the B form's gate takes; 1 on
    one rank and in the emit modes. Both packages get the B form the JAX
    engine resolves."""
    ref = JShardedFBEngine(_jcfg(cfg), _jax_mesh(grid), fengine="xla",
                           fengine_interpret=True, **kw)
    kw = dict(kw, bstage=ref.bstage)
    plan = resolve_sharded(_cfg(cfg), grid, kw.pop("n_spectra"), fengine="xla", **kw)
    assert plan.ici_chunks == ref.ici_chunks == k


@pytest.fixture(scope="module")
def solo_mesh(tmp_path_factory):
    """A one-rank gloo group in this process and its (1, 1) mesh."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(shape=(1, 1), device_type="cpu")
    store = tmp_path_factory.mktemp("solo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    # MKL's vector cos (torch.cos on the CPU, 2048 elements a thread) can
    # return one thread's share of the process's first call with errors up
    # to 1.5e-4, and an engine caches its steering weights from it. One call
    # over every thread's share takes that first call.
    torch.cos(torch.linspace(-14.0, 14.0, 2048 * torch.get_num_threads()))
    try:
        yield make_mesh(shape=(1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_a_one_rank_group_steps_the_engine(solo_mesh):
    """Fused F and turned B on a (1, 1) mesh (on gloo the T = 1 halo is the
    rank's own tail) equal the single-device engine on the tail-prepended
    stream, at the sharded engine's bound (rtol 1e-4 / atol 1e-3,
    ``__graft_entry__.py:155``)."""
    spec = dict(cfg=FUSED, engine=dict(n_spectra=64, fengine="fused", bstage="turned"))
    eng = ShardedFBEngine(_cfg(FUSED), solo_mesh, **spec["engine"])
    assert (eng.fengine, eng.bstage, eng.ici_chunks, eng.device.type) == (
        "fused", "turned", 1, "cpu")
    adc, fd, ph, dv = eng.example_inputs()
    got = eng(scatter_local(adc, solo_mesh, ingest.ADC), fd, ph, dv)
    adc_ext, *_ = _tail_prepended(spec)
    fb = FBEngine(_cfg(FUSED), n_spectra=64, fengine="fused", bstage="turned", device="cpu")
    want = fb(adc_ext, np.zeros(8, np.int32), fd, ph, dv)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def _at_offset(t, off):
    """A copy of ``t`` whose storage starts ``off`` elements into a fresh
    allocation."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("path", ["turned_product", "k1_plain"])
def test_plain_paths_ignore_the_operands_alignment(path):
    """The one-rank step's plain paths at this process's default threads:
    the turned product (K4's and the product's plain versions) and K1's
    plain version give the same bits on copies of the same operands at 16
    storage offsets. Alignment does not move the step's result."""
    rng = np.random.default_rng(3)
    a, p, s, c, b, fft, taps = 8, 2, 64, 512, 4, 1024, 4
    if path == "turned_product":
        q = [torch.from_numpy(rng.integers(-127, 128, (a, p, s, c), dtype=np.int8))
             for _ in range(2)]
        cs = [torch.from_numpy(rng.uniform(-1, 1, (c, b, a)).astype(np.float32)) for _ in range(2)]
        blocks = steering_coeff_blockcat(*cs).contiguous()
        x_t = corner_turn_planes(*q)

        def run(off):
            return torch.stack(beamform_turned(_at_offset(x_t, off), _at_offset(blocks, off),
                                               n_pols=p, precision="f32"), -1)
    else:
        adc = torch.from_numpy(rng.integers(-64, 64, (a, p, (s + taps - 1) * fft), dtype=np.int8))
        fd = torch.from_numpy(rng.uniform(-0.5, 0.5, (a, 1)).astype(np.float32)).expand(a, p)
        rot = fine_rotation_planes(fd, -np.pi * fd / 2, n_channels=c, quant_scale=1 / 16)
        win = default_window(taps, fft, "cpu")

        def run(off):
            frames = _at_offset(adc, off).reshape(a, p, -1, fft)
            return torch.stack(fengine_fused(frames, win, None, None, n_channels=c,
                                             quant_scale=1 / 16, rot_planes=rot,
                                             quantise=False))
    base = run(0)
    for off in range(1, 16):
        assert torch.equal(run(off), base), off


def test_example_inputs_are_the_reference_arrays(solo_mesh):
    for rowed in (False, True):
        port = ShardedFBEngine(_cfg(FUSED), solo_mesh, n_spectra=16, fengine="fused")
        ref = JShardedFBEngine(_jcfg(FUSED), _jax_mesh((1, 1)), n_spectra=16,
                               fengine="fused", fengine_interpret=True)
        for g, r in zip(port.example_inputs(5, rowed=rowed), ref.example_inputs(5, rowed=rowed)):
            np.testing.assert_array_equal(g, r)


def test_one_rank_mesh_layout_and_its_whole_shard(solo_mesh):
    assert tuple(solo_mesh.mesh_dim_names) == ("ant", "time")
    assert tuple(solo_mesh.get_coordinate()) == (0, 0)
    data = np.arange(4 * 2 * 16, dtype=np.int8).reshape(4, 2, 16)
    assert shard_indices(solo_mesh, data.shape, ingest.ADC) == (slice(None),) * 3
    local = scatter_local(data, solo_mesh, ingest.ADC)
    assert local.device.type == "cpu" and local.is_contiguous()
    np.testing.assert_array_equal(local.numpy(), data)


def test_the_engine_stays_on_its_mesh_and_refuses_a_wrong_shard(solo_mesh):
    with pytest.raises(ValueError, match="mesh"):
        ShardedFBEngine(_cfg(SMALL), solo_mesh, n_spectra=16, device="cuda")
    assert ShardedFBEngine(_cfg(SMALL), solo_mesh, n_spectra=16, device="cpu").device.type == "cpu"
    eng = ShardedFBEngine(_cfg(SMALL), solo_mesh, **XLA)
    adc, fd, ph, dv = eng.example_inputs()
    with pytest.raises(ValueError, match="shard"):
        eng(adc[:, :, :-8], fd, ph, dv)
    with pytest.raises(ValueError, match="rowed"):
        eng(adc.reshape(8, 2, -1, 256), fd, ph, dv)


def test_no_card_means_no_engine_and_no_group(monkeypatch):
    """Without a card, ``device_type=None`` raises naming the CPU opt-in;
    without torchrun's environment ``initialize_distributed`` is a no-op."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        launch.run_ranks(launch.step_specs, 2, args=((1, 2), None, ()))
    for key in ingest._RANK_ENV:
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False


# -- multi-rank: one launch a grid -------------------------------------------


def test_ranks_are_laid_out_row_major(grid_run):
    t = grid_run["grid"][1]
    assert [r["coordinate"] for r in grid_run["ranks"]] == [
        (i // t, i % t) for i in range(len(grid_run["ranks"]))]


def test_shard_indices_are_the_reference_map(grid_run):
    """Each rank's slices equal ``addressable_devices_indices_map`` for the
    device at its coordinate of the JAX mesh of the same shape."""
    mesh = _jax_mesh(grid_run["grid"])
    cfg = _cfg(FUSED)
    shapes = dict(
        adc=((8, 2, 16 * cfg.fft_size), ingest.ADC),
        rowed_adc=((8, 2, 16 * cfg.fft_size // 128, 128), ingest.ADC_ROWED),
        ant=((8,), ingest.ANT),
        steering=((512, 4, 8), ingest.STEERING),
    )
    for rank in grid_run["ranks"]:
        dev = mesh.devices[rank["coordinate"]]
        took = rank["specs"]["flat"]["indices"]
        took_rowed = rank["specs"]["rowed"]["indices"]
        for what, (shape, spec) in shapes.items():
            want = NamedSharding(mesh, P(*spec)).addressable_devices_indices_map(shape)[dev]
            got = took_rowed["adc"] if what == "rowed_adc" else took[what]
            assert got == want, (what, rank["coordinate"])


def test_beams_match_the_reference(grid_run):
    got = _global(grid_run, "xla", BEAMS)
    assert got.shape == (2, 128, 16, 4, 2)
    np.testing.assert_allclose(got, grid_run["jax"]["xla"], rtol=1e-4, atol=1e-3)
    # ici_chunks "auto": 8, the largest of {8, 4, 2} dividing the 16 or 8
    # spectra of a time block, as the reference resolves it.
    assert grid_run["ranks"][0]["specs"]["xla"]["plan"] == ("xla", "planar", 8, False)


def test_f_planes_within_one_code_of_the_reference(grid_run):
    for item in range(2):
        got = _global(grid_run, "planes", PLANES, item).astype(np.int32)
        want = grid_run["jax"]["planes"][item].astype(np.int32)
        assert got.shape == want.shape == (8, 2, 16, 128)
        d = np.abs(got - want)
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3


def test_visibilities_equal_the_reference(grid_run):
    jb, jre, jim = grid_run["jax"]["vis"]
    np.testing.assert_allclose(_global(grid_run, "vis", BEAMS, 0), jb, rtol=1e-4, atol=1e-3)
    for item, want in ((1, jre), (2, jim)):
        got = _global(grid_run, "vis", VIS, item)
        assert got.shape == (128, 16, 16)
        np.testing.assert_array_equal(got, want)


def test_visibilities_through_k3_are_the_gram_of_the_planes(grid_run):
    """Where K3's gate holds (S = 128, C_loc % 128 == 0; its plain version
    here) the visibilities are the exact gram of the gathered F planes."""
    qr, qi = (_global(grid_run, "planes_k3", PLANES, i).astype(np.int64) for i in range(2))
    x = (qr + 1j * qi).transpose(3, 2, 0, 1).reshape(512, 128, 16)  # [C, S, I]
    gram = np.einsum("csi,csj->cij", x, x.conj())
    np.testing.assert_array_equal(_global(grid_run, "vis_k3", VIS, 1), gram.real)
    np.testing.assert_array_equal(_global(grid_run, "vis_k3", VIS, 2), gram.imag)


def test_scatter_beams_is_its_slice_of_the_psum(grid_run):
    got = _global(grid_run, "scatter", (None, "time", None, "ant"))
    np.testing.assert_allclose(got, _global(grid_run, "xla", BEAMS), rtol=1e-5, atol=1e-4)
    local = grid_run["ranks"][0]["specs"]["scatter"]["out"]
    assert local.shape == (2, 128 // grid_run["grid"][1], 16, 4 // grid_run["grid"][0], 2)


def test_steering_extrapolation_and_weights_match_the_reference(grid_run):
    got = _global(grid_run, "steer", BEAMS)
    assert np.abs(got - _global(grid_run, "xla", BEAMS)).max() > 1e-2
    np.testing.assert_allclose(got, grid_run["jax"]["steer"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bstage,k", [("planar", 2), ("planar", 4), ("turned", 2),
                                      ("turned", 4)])
def test_ici_chunks_equal_the_monolithic_step(grid_run, bstage, k):
    """Chunks keep every beam's products and its antenna sum: the turned
    form (the corner turn, then one product a channel) equals the
    monolithic step bit for bit. The planar form's plain products go to the
    CPU's BLAS, whose kernels (and with them the f32 sum order and the use
    of fused multiply-adds) change with the number of rows a call gets: a
    chunk's beam then differs from the monolithic one by f32 rounding of
    its antenna sums, up to 8 products of |x| <= 127 and |w| <= 1, so
    there the chunks agree within rtol 1e-5 / atol 1e-4."""
    assert grid_run["ranks"][0]["specs"][f"chunks{k}_{bstage}"]["plan"][2] == k
    got = _global(grid_run, f"chunks{k}_{bstage}", BEAMS)
    want = _global(grid_run, f"chunks1_{bstage}", BEAMS)
    if bstage == "turned":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_rowed_ingest_equals_the_flat_stream(grid_run):
    assert grid_run["ranks"][0]["specs"]["rowed"]["plan"][3] is True
    np.testing.assert_array_equal(_global(grid_run, "rowed", BEAMS),
                                  _global(grid_run, "flat", BEAMS))


@pytest.mark.parametrize("bstage", ["turned", "fused"])
def test_fused_f_and_kernel_b_equal_the_single_device_engine(grid_run, bstage):
    spec = grid_run["specs"][f"fused_{bstage}"]
    assert grid_run["ranks"][0]["specs"][spec["name"]]["plan"][:2] == ("fused", bstage)
    adc_ext, fd, ph, dv = _tail_prepended(spec)
    fb = FBEngine(_cfg(FUSED), n_spectra=64, fengine="fused", bstage=bstage, device="cpu")
    want = fb(adc_ext, np.zeros(8, np.int32), fd, ph, dv).numpy()
    np.testing.assert_allclose(_global(grid_run, spec["name"], BEAMS), want, rtol=1e-4, atol=1e-3)


def test_local_weights_are_the_block_concat_of_the_local_slice(grid_run):
    """The folded weights of a rank are rows ``[re ants | im ants]`` of its
    antennas picked out of the global block-concat (not a plain slice)."""
    grid = grid_run["grid"]
    spec = grid_run["specs"]["fused_turned"]
    cfg = _cfg(FUSED)
    dv = _tail_prepended(spec)[3]
    fb = FBEngine(cfg, n_spectra=64, fengine="fused", bstage="turned", device="cpu")
    fb.set_beam_delays(dv)
    full = fb.coeff_blocks.numpy()  # [C, 2A, 2B]
    a_loc, c_loc = cfg.n_ants // grid[0], cfg.n_channels // grid[1]
    for rank in grid_run["ranks"]:
        a, t = rank["coordinate"]
        rows = np.r_[a * a_loc:(a + 1) * a_loc, cfg.n_ants + a * a_loc:cfg.n_ants + (a + 1) * a_loc]
        want = full[t * c_loc:(t + 1) * c_loc][:, rows]
        np.testing.assert_array_equal(rank["specs"]["fused_turned"]["coeff_blocks"], want)


@pytest.mark.parametrize("name,ref", [("state", "xla"), ("state_turned", "fused_turned")])
def test_loaded_reference_state_gives_the_beams_of_set_beam_delays(grid_run, name, ref):
    """The reference's planes and the port's own differ in cos/sin ulps, so
    the beams agree at the beam tolerance, rtol 1e-4 / atol 1e-3."""
    got = _global(grid_run, name, BEAMS)
    np.testing.assert_allclose(got, _global(grid_run, ref, BEAMS), rtol=1e-4, atol=1e-3)
    if name == "state":
        np.testing.assert_allclose(got, grid_run["jax"]["xla"], rtol=1e-4, atol=1e-3)


def test_dryrun_multichip_on_four_cpu_ranks(run_2x2):
    """``dryrun_multichip(4, device_type="cpu")``'s rank body (in the (2, 2)
    launch): fused F, turned B, ``ici_chunks`` auto above 1, beams held to
    ``FBEngine``."""
    reports = run_2x2["ranks"]
    assert [r["backend"] for r in reports] == ["gloo"] * 4
    assert {r["plan"] for r in reports} == {("fused", "turned", 2, True)}
    assert reports[0]["shape"] == (2, 2) and reports[0]["max_abs_err"] is not None
