"""Start ranks and certify the sharded engine (counterpart of ``__graft_entry__.dryrun_multichip``).

:func:`run_ranks` spawns one process a rank (``torch.multiprocessing``,
the ``spawn`` method), joins them in a process group through a ``file://``
store in a fresh temporary directory (no port to race for), runs a function
of this package on each and returns what each returned. A rank that raises
makes :func:`run_ranks` raise; the others are stopped.

:func:`dryrun_multichip` runs the distributed step on ``n`` ranks at the
reference's dry-run geometry and holds the gathered beams to the port's
single-device ``FBEngine``. ``python -m dpdk_dc_sand_tpu_torch.parallel
--nproc N [--device cpu]`` runs it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.parallel import ingest
from dpdk_dc_sand_tpu_torch.parallel.fbengine_sharded import ShardedFBEngine
from dpdk_dc_sand_tpu_torch.parallel.mesh import make_mesh, resolve_device_type

#: How long a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 300


def _rank_main(rank: int, world: int, device_type: str, tmp: str, fn: Callable, args: tuple):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        # One intra-op thread a CPU rank: the ranks share the host's cores,
        # and each would otherwise start a thread for every core.
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    try:
        out = fn(*args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *, device_type: Optional[str] = None,
              args: Sequence = ()) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks; return each rank's result.

    ``fn`` is a module-level function (children import it by name, so
    they import this package and nothing else of the caller). Each rank
    holds ``cuda:rank`` with NCCL, or (``device_type="cpu"``) runs on the
    CPU with gloo. Results must pickle (numpy, not CUDA tensors).
    """
    device_type = resolve_device_type(device_type)
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; "
                           f"{torch.cuda.device_count()} visible")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        mp.spawn(_rank_main, args=(world, device_type, tmp, fn, tuple(args)), nprocs=world,
                 join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _numpy(out):
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    return tuple(_numpy(o) for o in out)


def step_spec(mesh, spec: dict) -> dict:
    """Build one engine on ``mesh``, step it once on this rank's shard of
    its ``example_inputs``, and return what the rank saw and produced.

    ``spec``: ``cfg`` (ArrayConfig fields), ``engine`` (keyword arguments),
    and optionally ``seed``, ``rowed``, ``delay_vals``, ``t_s``, ``ant_weights`` and
    ``state`` (``(window, cos, sin)`` carried from the reference through
    :func:`~dpdk_dc_sand_tpu_torch.convert.load_sharded_state`). The result
    holds the outputs as numpy, the resolved backends, the steering weights,
    and the index slices of the inputs this rank took.
    """
    from dpdk_dc_sand_tpu_torch.convert import load_sharded_state

    cfg = ArrayConfig(**spec["cfg"])
    eng = ShardedFBEngine(cfg, mesh, **spec.get("engine", {}))
    rowed = spec.get("rowed", False)
    adc, fd, ph, dv = eng.example_inputs(spec.get("seed", 2021), rowed=rowed)
    adc_place = ingest.ADC_ROWED if rowed else ingest.ADC
    if spec.get("delay_vals") is not None:
        dv = spec["delay_vals"]
    weights, t_s = spec.get("ant_weights"), spec.get("t_s", 0.0)
    if spec.get("state") is not None:
        window, cos, sin = spec["state"]
        load_sharded_state(eng, window, cos, sin, delay_vals=dv, ant_weights=weights, t_s=t_s)
    out = eng(ingest.scatter_local(adc, mesh, adc_place), ingest.scatter_local(fd, mesh, ingest.ANT),
              ingest.scatter_local(ph, mesh, ingest.ANT), dv, ant_weights=weights, t_s=t_s)
    return dict(
        out=_numpy(out),
        plan=(eng.fengine, eng.bstage, eng.ici_chunks, eng.rowed_ingest),
        coeff_blocks=None if eng.coeff_blocks is None else _numpy(eng.coeff_blocks.float()),
        indices=dict(adc=ingest.shard_indices(mesh, adc.shape, adc_place),
                     ant=ingest.shard_indices(mesh, fd.shape, ingest.ANT),
                     steering=ingest.shard_indices(mesh, (cfg.n_channels, cfg.n_beams,
                                                          cfg.n_ants), ingest.STEERING)),
    )


def step_specs(shape, device_type: str, specs: Sequence[dict], dryrun: bool = False) -> dict:
    """Test hook, so that one launch steps many configurations: on one
    rank, with ``dryrun`` first :func:`dryrun_multichip`'s rank body on as
    many ranks as ``shape`` holds, then make the ``shape`` mesh and
    :func:`step_spec` each spec."""
    out = _dryrun_rank(int(np.prod(shape)), device_type) if dryrun else {}
    mesh = make_mesh(shape=shape, device_type=device_type)
    out.update(coordinate=tuple(mesh.get_coordinate()),
               specs={s["name"]: step_spec(mesh, s) for s in specs})
    return out


def dryrun_shape(n: int) -> tuple[int, int]:
    """The reference dry run's grid: time a power of two (channel counts
    are), both axes >= 2 where possible (``__graft_entry__.py:80-91``)."""
    odd, pow2 = n, 1
    while odd % 2 == 0:
        odd //= 2
        pow2 *= 2
    return (odd * 2, pow2 // 2) if pow2 >= 2 else (odd, 1)


def dryrun_config(n: int) -> tuple[ArrayConfig, int]:
    """The dry run's array and spectra (``__graft_entry__.py:93-109``): 1024
    channels, 4 beams, 4 taps, and S = 128 so that ``ici_chunks="auto"``
    engages (the chunked turn needs 64-spectra chunks here)."""
    ant_size, time_size = dryrun_shape(n)
    cfg = ArrayConfig(n_ants=max(ant_size * 2, 4), n_channels=1024, n_beams=4, n_taps=4)
    return cfg, max(128, max(4, cfg.n_taps - 1) * max(time_size, 1))


def _dryrun_rank(n: int, device_type: str) -> dict:
    from dpdk_dc_sand_tpu_torch.models import FBEngine

    shape = dryrun_shape(n)
    mesh = make_mesh(shape=shape, device_type=device_type)
    cfg, n_spectra = dryrun_config(n)
    eng = ShardedFBEngine(cfg, mesh, n_spectra=n_spectra, fengine="fused", bstage="turned")
    if (eng.fengine, eng.bstage) != ("fused", "turned"):
        raise AssertionError(f"dry run resolved {eng.fengine}/{eng.bstage}")
    if n > 1 and eng.ici_chunks <= 1:
        raise AssertionError(f"ici_chunks auto resolved {eng.ici_chunks} on {n} ranks")
    adc, fd, ph, dv = eng.example_inputs()
    beams = eng(ingest.scatter_local(adc, mesh, ingest.ADC),
                ingest.scatter_local(fd, mesh, ingest.ANT),
                ingest.scatter_local(ph, mesh, ingest.ANT), dv)
    if tuple(beams.shape) != (cfg.n_pols, eng.c_loc, n_spectra, cfg.n_beams, 2):
        raise AssertionError(f"beams shape {tuple(beams.shape)}")
    if not bool(torch.isfinite(beams).all()):
        raise AssertionError("non-finite beams")
    # Gather the channel slices over "time": [T, P, C_loc, S, B, 2].
    gathered = beams.new_empty((eng.time_size * beams.shape[0], *beams.shape[1:]))
    dist.all_gather_into_tensor(gathered, beams.contiguous(), group=eng.time_group)
    got = gathered.view(eng.time_size, *beams.shape).permute(1, 0, 2, 3, 4, 5).reshape(cfg.n_pols, cfg.n_channels, n_spectra,
                                                     cfg.n_beams, 2)
    max_abs_err = None
    if dist.get_rank() == 0:
        # The same circular-halo convention on one device: the global
        # stream's tail prepended as FIR history, no coarse delay, the same
        # kernels on the same bytes.
        adc_ext = np.concatenate([adc[..., -eng.halo_len:], adc], axis=-1)
        fb = FBEngine(cfg, n_spectra=n_spectra, fengine="fused", bstage="turned",
                      device=eng.device)
        want = fb(adc_ext, np.zeros(cfg.n_ants, np.int32), fd, ph, dv)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        max_abs_err = float((got - want).abs().max())
    return dict(shape=shape, plan=(eng.fengine, eng.bstage, eng.ici_chunks, eng.rowed_ingest),
                max_abs_err=max_abs_err, backend=dist.get_backend())


def dryrun_multichip(n: int, device_type: Optional[str] = None) -> list:
    """Run the full distributed step on ``n`` ranks at tiny shapes and hold
    it to the single-device engine.

    The mesh is :func:`dryrun_shape` ``(n)``; the engine takes fused F,
    turned B and ``ici_chunks="auto"``, which must resolve above 1 when
    ``n > 1``. Every rank's beams are gathered over "time", and rank 0
    asserts that they equal ``FBEngine`` on the tail-prepended stream at
    rtol 1e-4 / atol 1e-3 (``__graft_entry__.py:127-155``). Returns each
    rank's report; a failed check on any rank raises.
    """
    return run_ranks(_dryrun_rank, n, device_type=device_type, args=(n, device_type))
