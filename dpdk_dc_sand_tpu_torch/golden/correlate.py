"""Golden model of X-engine cross-correlation (visibilities) (counterpart of ``dpdk_dc_sand_tpu/golden/correlate.py``).

The reference sandbox feeds the ``katxgpu`` X-engine (its repo is merged
by merge_gpu_repositories/do_merge.sh:4-10 and its ASTRON tensor-core
correlation kernel is cited at matrix_multiply.py:74-76). Contract: per
channel, accumulate the full visibility matrix over an accumulation
interval::

    V[c, i, j] = Σ_t x[c, t, i] · conj(x[c, t, j])

for all antenna-pol input pairs i, j.
"""

from __future__ import annotations

import numpy as np


def correlate(x: np.ndarray) -> np.ndarray:
    """``x``: ``[chan, time, n_inputs]`` complex → ``[chan, n_inputs,
    n_inputs]`` complex64 visibilities (x · conj(x) summed over time)."""
    v = np.einsum("cti,ctj->cij", x, np.conj(x))
    return v.astype(np.complex64)


def correlate_planar(xr: np.ndarray, xi: np.ndarray):
    """Planar form: returns (V_re, V_im) float32.

    ``V = Σ (xr+i·xi)(yr−i·yi) = (xr·yr + xi·yi) + i(xi·yr − xr·yi)``.
    """
    xr = xr.astype(np.float32)
    xi = xi.astype(np.float32)
    vre = np.einsum("cti,ctj->cij", xr, xr) + np.einsum("cti,ctj->cij", xi, xi)
    vim = np.einsum("cti,ctj->cij", xi, xr) - np.einsum("cti,ctj->cij", xr, xi)
    return vre.astype(np.float32), vim.astype(np.float32)
