"""Golden model of multi-beam coherent beamforming (counterpart of ``dpdk_dc_sand_tpu/golden/beamform.py``).

Behavioural parity with ``beamformer/unit_test/complex_mult_cpu.py:68-102``
and the GPU kernel ``beamformer/beamforming/complex_mult_kernel.py:89-100``:
per (batch, pol, channel, sample), the complex antenna vector is contracted
with the steering-weight matrix. With the antenna complexity folded into the
contraction axis (complex_mult_kernel.py:126-134) this is a real matmul
``[samples, 2·ants] @ [2·ants, 2·beams]``.
"""

from __future__ import annotations

import numpy as np


def beamform(reordered: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Real-matmul beamform in the reference layouts.

    Parameters
    ----------
    reordered:
        ``[batch][pol][chan][block][t_in_block][ant][cplx]`` integer samples
        (the corner-turn output).
    coeffs:
        ``[batch][pol][chan][2·ant][2·beam]`` f32 rotation-block matrix.

    Returns
    -------
    ``[batch][pol][chan][block][t_in_block][2·beam]`` f32 beams.
    """
    b, p, c, blocks, tb, a, x = reordered.shape
    data = reordered.reshape(b, p, c, blocks * tb, a * x).astype(np.float32)
    out = np.einsum("bpcta,bpcaw->bpctw", data, coeffs.astype(np.float32))
    return out.reshape(b, p, c, blocks, tb, coeffs.shape[-1]).astype(np.float32)


def beamform_complex(samples: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Complex-domain beamform: ``beam[..., t, b] = Σ_a x[..., t, a]·w[b, a]``.

    ``samples``: ``[..., chan, time, ant]`` complex; ``weights``:
    ``[chan, beam, ant]`` complex. Returns ``[..., chan, time, beam]``
    complex64. This is the canonical (layout-free) definition that the real
    matmul above must agree with.
    """
    out = np.einsum("...cta,cba->...ctb", samples, weights)
    return out.astype(np.complex64)
