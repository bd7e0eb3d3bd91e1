"""Golden model of the pre-beamform corner-turn reorder (counterpart of ``dpdk_dc_sand_tpu/golden/reorder.py``).

Behavioural parity with ``beamformer/beamforming/reorder.py:40-43`` — the
reference golden model performs the corner turn as a reshape + transpose;
this does the same (numpy, any dtype).
"""

from __future__ import annotations

import numpy as np


def reorder(samples: np.ndarray, n_samples_per_block: int = 16) -> np.ndarray:
    """Corner-turn ingest-layout samples into beamform layout.

    ``[batch][ant][chan][time][pol][cplx]``
    → ``[batch][pol][chan][block][t_in_block][ant][cplx]``

    with ``time = block · n_samples_per_block + t_in_block``
    (prebeamform_reorder.py:144-151).
    """
    b, a, c, t, p, x = samples.shape
    if t % n_samples_per_block:
        raise ValueError(
            f"time axis {t} not divisible by block size {n_samples_per_block}"
        )
    blocks = t // n_samples_per_block
    v = samples.reshape(b, a, c, blocks, n_samples_per_block, p, x)
    # [b, a, c, blk, tb, p, x] -> [b, p, c, blk, tb, a, x]
    return np.ascontiguousarray(v.transpose(0, 5, 2, 3, 4, 1, 6))


def reorder_inverse(reordered: np.ndarray) -> np.ndarray:
    """Invert :func:`reorder` back to ingest layout."""
    b, p, c, blocks, tb, a, x = reordered.shape
    v = reordered.transpose(0, 5, 2, 3, 4, 1, 6)
    return np.ascontiguousarray(v.reshape(b, a, c, blocks * tb, p, x))
