"""Golden model of 8-bit requantisation (F-engine output stage) (counterpart of ``dpdk_dc_sand_tpu/golden/requant.py``).

The reference system transports 8-bit complex samples between F- and
B-engines (prebeamform_reorder.py:55, "Each input element is a complex
8-bit integer sample", prebeamform_reorder.py:153). This models the
float→int8 conversion the F-engine applies before transmit.
"""

from __future__ import annotations

import numpy as np


def requantise(x: np.ndarray, scale: float) -> np.ndarray:
    """Scale, round-half-even, saturate to int8 ``[−127, 127]``.

    Complex input is split to interleaved (re, im) int8 pairs on a trailing
    axis; real input maps elementwise.
    """
    if np.iscomplexobj(x):
        planar = np.stack([x.real, x.imag], axis=-1)
        return requantise(planar, scale)
    v = np.rint(np.asarray(x, np.float64) * scale)
    return np.clip(v, -127, 127).astype(np.int8)
