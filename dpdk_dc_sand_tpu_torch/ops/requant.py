"""8-bit requantisation (counterpart of ``dpdk_dc_sand_tpu/ops/requant.py``).

Scale, round half to even (``torch.round``, the same as ``jnp.rint``),
saturate to ``[-127, 127]``, int8.
"""

from __future__ import annotations

import torch


def requantise(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale, round-half-even, saturate to int8 ``[-127, 127]``."""
    v = torch.round(x.to(torch.float32) * scale)
    return v.clamp(-127.0, 127.0).to(torch.int8)
