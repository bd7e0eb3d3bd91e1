"""Distributed ingest: each rank takes its own shard (counterpart of ``dpdk_dc_sand_tpu/parallel/ingest.py``).

The reference's engines each subscribe to the multicast groups carrying
their own channel slice (ibverbs_rx.c:207-210). In the JAX package one
controller stitches per-device pieces into a global array; here every rank
is its own process, so a rank asks :func:`shard_indices` which slice of a
global array it owns, fetches only that (``provider(index)``), and steps
the engine on the local tensor. No rank ever holds the whole array.

Placements are the reference's ``PartitionSpec``s written as tuples: one
entry per array dimension, a mesh axis name or ``None`` (unsharded), and
missing trailing entries unsharded. The engine's inputs take:

- :data:`ADC` ``("ant", None, "time")``, or :data:`ADC_ROWED`
  ``("ant", None, "time", None)`` for the wire-rowed stream;
- :data:`ANT` ``("ant",)`` for fractional delays and phases;
- :data:`STEERING` ``("time", None, "ant")`` for the ``[C, B, A]``
  steering planes (``fbengine_sharded.py:314-336`` in the reference).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dpdk_dc_sand_tpu_torch.parallel.mesh import mesh_device, resolve_device_type

ADC = ("ant", None, "time")
ADC_ROWED = ("ant", None, "time", None)
ANT = ("ant",)
STEERING = ("time", None, "ant")

#: torchrun's environment; any of them set means "launched as a rank".
_RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device_type: Optional[str] = None) -> bool:
    """Join the process group when launched as one rank (torchrun's
    environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). Returns True when distributed mode is active, False
    when none of them is set (a single process: nothing to join).

    On a card (``device_type`` ``None`` or ``"cuda"``) the rank takes
    ``cuda:LOCAL_RANK`` and NCCL; with ``"cpu"``, gloo.
    """
    if not any(k in os.environ for k in _RANK_ENV):
        return False
    if dist.is_initialized():
        return True
    device_type = resolve_device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://")
    return True


def shard_indices(mesh, global_shape: Sequence[int], placements: Sequence) -> Tuple[slice, ...]:
    """This rank's index slices of a ``global_shape`` array placed on ``mesh``.

    The same tuple as the reference's ``addressable_devices_indices_map``
    entry for the device at this rank's mesh coordinate: ``slice(None)`` on
    dimensions unsharded or placed on an axis of size 1, the rank's even
    block on the others.
    """
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if len(placements) > len(global_shape):
        raise ValueError(f"placements {tuple(placements)} exceed the rank of {tuple(global_shape)}")
    index = []
    for dim, n in enumerate(global_shape):
        axis = placements[dim] if dim < len(placements) else None
        k = None if axis is None else names.index(axis)
        size = 1 if k is None else mesh.shape[k]
        if size == 1:
            index.append(slice(None))
            continue
        if n % size:
            raise ValueError(f"dimension {dim} ({n}) does not divide the {axis!r} axis ({size})")
        step = n // size
        index.append(slice(coord[k] * step, (coord[k] + 1) * step))
    return tuple(index)


def assemble_global(
    provider: Callable[[Tuple[slice, ...]], np.ndarray],
    mesh,
    global_shape: Sequence[int],
    placements: Sequence,
) -> torch.Tensor:
    """This rank's shard of a ``global_shape`` array, on this rank's device.

    ``provider(index)`` returns the host data of the shard (e.g. a view into
    a ring-buffer chunk for this rank's channel/time slice); it is called
    once, with :func:`shard_indices`.
    """
    local = np.array(provider(shard_indices(mesh, global_shape, placements)), order="C")
    return torch.from_numpy(local).to(mesh_device(mesh))


def scatter_local(local, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's shard of an array already in this host's memory (the
    single-host feed): :func:`assemble_global` over slices of it."""
    arr = local.cpu().numpy() if torch.is_tensor(local) else np.asarray(local)
    return assemble_global(lambda idx: arr[idx], mesh, arr.shape, placements)

