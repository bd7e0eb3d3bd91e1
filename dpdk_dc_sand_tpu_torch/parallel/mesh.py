"""Mesh construction (counterpart of ``dpdk_dc_sand_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices of one
controller. The port is SPMD: one process per rank, each holding one card
(NCCL) or one CPU process (gloo), and a ``DeviceMesh`` over the ranks of the
process group that :func:`~.ingest.initialize_distributed` or
:func:`~.launch.run_ranks` started. Ranks are laid out row-major, as the
reference's ``np.asarray(devices).reshape(shape)``: rank ``r`` sits at ant
index ``r // T`` and time index ``r % T`` of an ``(A, T)`` mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def factor_devices(n: int) -> Tuple[int, int]:
    """Factor ``n`` devices into the most square (ant, time) grid.

    Prefers a balanced 2D split so both the antenna-reduction axis and the
    time/channel axis get parallelism; falls back to 1×n (the reference's
    rule, bit for bit).
    """
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def resolve_device_type(device_type: Optional[str]) -> str:
    """``None`` means ``"cuda"``, which raises without a card rather than
    running on the CPU unasked; ``"cpu"`` must be named."""
    if device_type is None:
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded engine runs on the cards by default; "
            'pass device_type="cpu" to run its ranks on the CPU'
        )
    return device_type


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(
    axis_names: Sequence[str] = ("ant", "time"),
    shape: Optional[Tuple[int, int]] = None,
    device_type: Optional[str] = None,
):
    """Build a 2D ``DeviceMesh`` over the ranks of the process group.

    Axes: ``"ant"`` — antenna sharding (beamform reduction by
    ``all_reduce``); ``"time"`` — time-block sharding before the corner
    turn, which ``all_to_all_single`` converts into channel sharding (the
    xeng_id split) for the B stage. Every rank of the group is on the mesh
    (the reference's ``n_devices`` is the world size here). ``shape``
    defaults to :func:`factor_devices` of the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start the ranks with "
            "parallel.launch.run_ranks or torchrun + initialize_distributed()"
        )
    n = dist.get_world_size()
    if shape is None:
        shape = factor_devices(n)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks on axes {tuple(axis_names)}")
    return init_device_mesh(resolve_device_type(device_type), shape,
                            mesh_dim_names=tuple(axis_names))
