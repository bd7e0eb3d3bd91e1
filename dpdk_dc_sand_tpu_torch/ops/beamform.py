"""Beamform of corner-turned samples, plain PyTorch (counterpart of ``dpdk_dc_sand_tpu/ops/beamform.py:beamform_turned``).

In the reference this is an XLA ``dot_general`` outside any Pallas kernel,
so it stays a ``torch.bmm`` here. The reference accumulates in f32
(``preferred_element_type=f32``); a bf16 ``bmm`` would round its output to
bf16, so both operands are converted to f32 first — exact for int8 samples
and for bf16 weights — and the product runs in f32 with TF32 off.
"""

from __future__ import annotations

import torch

#: Channels per product (an f32 copy of the flagship x_t is 10.7 GB).
_CHANNEL_CHUNK = 2048


def _f32_bmm(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    if x.device.type != "cuda":
        torch.bmm(x, w, out=out)
        return
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.bmm(x, w, out=out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def beamform_turned(
    x_t: torch.Tensor,
    blocks: torch.Tensor,
    n_pols: int = 2,
    precision: str = "bf16",
    layout: str = "split",
):
    """Beamform corner-turned int8 samples with one folded dot per channel.

    ``x_t``: ``[C, 2A, P·S]`` int8 from
    :func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_planes`
    (rows ``reim·A + a``, lanes ``p·S + s``). ``blocks``: ``[C, 2A, 2B]``
    block-concat steering weights, taken in the precision's dtype.

    ``layout="natural"``: the dot's own ``[C, P·S, 2B]`` f32 output
    (columns ``[re beams | im beams]``). ``"split"``: ``(beam_re,
    beam_im)`` each ``[P, C, S, B]`` f32.
    """
    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    if layout not in ("natural", "split"):
        raise ValueError(f"unknown layout {layout!r}")
    c, k2, m = x_t.shape
    if tuple(blocks.shape[:2]) != (c, k2):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match x_t {tuple(x_t.shape)}")
    nb2 = blocks.shape[-1]
    w = blocks.to(torch.bfloat16 if precision == "bf16" else torch.float32)
    out = torch.empty((c, m, nb2), dtype=torch.float32, device=x_t.device)
    for c0 in range(0, c, _CHANNEL_CHUNK):
        c1 = min(c, c0 + _CHANNEL_CHUNK)
        xs = x_t[c0:c1].transpose(1, 2).to(torch.float32)  # [cb, P·S, 2A]
        _f32_bmm(xs, w[c0:c1].to(torch.float32), out[c0:c1])
    if layout == "natural":
        return out
    nb = nb2 // 2
    out = out.view(c, n_pols, m // n_pols, nb2)
    return out[..., :nb].permute(1, 0, 2, 3), out[..., nb:].permute(1, 0, 2, 3)
