"""Pre-beamform reorder (counterpart of ``dpdk_dc_sand_tpu/ops/reorder.py``).

The reference leaves this corner turn to XLA (a reshape and a transpose,
no Pallas kernel), so here it is a plain permute: the result is a view,
which its consumer (:func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_matrix`)
copies once when it flattens the antenna axis.
"""

from __future__ import annotations

import torch


def prebeamform_reorder(samples: torch.Tensor, n_samples_per_block: int = 16) -> torch.Tensor:
    """``[b][ant][chan][time][pol][x]`` -> ``[b][pol][chan][blk][tb][ant][x]`` (any dtype)."""
    b, a, c, t, p, x = samples.shape
    if t % n_samples_per_block:
        raise ValueError(f"time axis {t} not divisible by block size {n_samples_per_block}")
    v = samples.reshape(b, a, c, t // n_samples_per_block, n_samples_per_block, p, x)
    return v.permute(0, 5, 2, 3, 4, 1, 6)


def prebeamform_reorder_inverse(reordered: torch.Tensor) -> torch.Tensor:
    """Invert :func:`prebeamform_reorder` back to the ingest layout."""
    b, p, c, blocks, tb, a, x = reordered.shape
    return reordered.permute(0, 5, 2, 3, 4, 1, 6).reshape(b, a, c, blocks * tb, p, x)
