"""Multi-beam beamform products, plain PyTorch (counterpart of ``dpdk_dc_sand_tpu/ops/beamform.py``).

In the reference every form here is an XLA ``dot_general`` outside any
Pallas kernel, so each stays a batched ``torch`` product. The reference
accumulates in f32 (``preferred_element_type=f32``); a bf16 product would
round its output to bf16, so both operands are converted to f32 first —
exact for int8 samples and for bf16 weights, whose products are exact in
f32 — and the product runs in f32 with TF32 off. ``precision="bf16"``
rounds the weights (and any floating-point samples) to bf16 on the way.

The forms, by operand layout:

- :func:`beamform_matrix`: the reference layouts (reordered samples,
  ``[2A, 2B]`` rotation blocks), the B-engine of
  :class:`~dpdk_dc_sand_tpu_torch.models.bengine.BeamformPipeline`;
- :func:`beamform_planes` / :func:`beamform`: (re, im) planes and (cos, sin)
  weights, four real products (``bstage="planar"``);
- :func:`beamform_folded` / :func:`beamform_planes_folded`: one folded
  product per channel (``bstage="folded"``);
- :func:`beamform_turned` / :func:`beamform_turned_split`: corner-turned
  int8 operands (``bstage="turned"``, and the native F->B handoff).

Products walk the channel axis in chunks, which bounds the f32 operand
copies (an f32 copy of the flagship's turned planes is 10.7 GB).
"""

from __future__ import annotations

import contextlib

import torch

#: Channels per product.
_CHANNEL_CHUNK = 2048


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """f32 products in full f32 on the card (TF32 off), restored after."""
    if device.type != "cuda":
        yield
        return
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.bfloat16 if precision == "bf16" else torch.float32


def _operand(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the precision's dtype (a no-op for int8), held in f32."""
    if x.is_floating_point() and x.dtype != dt:
        x = x.to(dt)
    return x.to(torch.float32)


def _chunks(c: int):
    for c0 in range(0, c, _CHANNEL_CHUNK):
        yield slice(c0, min(c, c0 + _CHANNEL_CHUNK))


def _folded_product(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``[C, M, K] @ [C, K, N]`` -> f32 ``[C, M, N]``, chunked over C."""
    c, m, _ = x.shape
    out = torch.empty((c, m, w.shape[-1]), dtype=torch.float32, device=x.device)
    with _full_f32(x.device):
        for cs in _chunks(c):
            torch.bmm(_operand(x[cs], dt), _operand(w[cs], dt), out=out[cs])
    return out


def _check_layout(layout: str) -> None:
    if layout not in ("natural", "split"):
        raise ValueError(f"unknown layout {layout!r}")


def _split(out: torch.Tensor, n_pols: int, layout: str):
    """``[C, P·S, 2B]`` -> itself (``"natural"``) or ``(beam_re, beam_im)``
    each ``[P, C, S, B]`` (``"split"``; views)."""
    if layout == "natural":
        return out
    c, m, nb2 = out.shape
    nb = nb2 // 2
    out = out.view(c, n_pols, m // n_pols, nb2)
    return out[..., :nb].permute(1, 0, 2, 3), out[..., nb:].permute(1, 0, 2, 3)


def beamform_matrix(
    reordered: torch.Tensor, coeffs: torch.Tensor, precision: str = "f32"
) -> torch.Tensor:
    """Beamform in the reference layouts.

    ``reordered``: ``[batch][pol][chan][block][t_in_block][ant][cplx]``
    int8 (:func:`~dpdk_dc_sand_tpu_torch.ops.reorder.prebeamform_reorder`).
    ``coeffs``: ``[batch][pol][chan][2·ant][2·beam]`` rotation blocks
    (:func:`~dpdk_dc_sand_tpu_torch.ops.coeff_gen.generate_coeff_matrix`).
    Returns ``[batch][pol][chan][block][t_in_block][2·beam]`` f32 beams.
    """
    dt = _dtype(precision)
    b, p, c, blocks, tb, a, x = reordered.shape
    data = _operand(reordered.reshape(b, p, c, blocks * tb, a * x), dt)
    with _full_f32(reordered.device):
        out = torch.matmul(data, _operand(coeffs, dt))
    return out.reshape(b, p, c, blocks, tb, coeffs.shape[-1])


def beamform_planes(
    xr: torch.Tensor,
    xi: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar beamform: ``(xr + i·xi)·(cos + i·sin)`` summed over antennas.

    ``xr``, ``xi``: ``[..., chan, time, ant]`` (int8 ideal; any strides).
    ``cos``, ``sin``: ``[chan, beam, ant]``. Four real products per channel
    chunk, then ``rr - ii`` and ``ri + ir`` in f32, as the reference.
    Returns ``(beam_re, beam_im)`` each ``[..., chan, time, beam]`` f32.
    """
    dt = _dtype(precision)
    *lead, c, t, a = xr.shape
    wc = cos.transpose(-1, -2)  # [chan, ant, beam]
    ws = sin.transpose(-1, -2)
    nb = wc.shape[-1]
    re = torch.empty((*lead, c, t, nb), dtype=torch.float32, device=xr.device)
    im = torch.empty_like(re)
    with _full_f32(xr.device):
        for cs in _chunks(c):
            cb = cs.stop - cs.start
            x_r, x_i = (_operand(v[..., cs, :, :].movedim(-3, 0).reshape(cb, -1, a), dt)
                        for v in (xr, xi))
            w_c, w_s = _operand(wc[cs], dt), _operand(ws[cs], dt)
            rr, ii = torch.bmm(x_r, w_c), torch.bmm(x_i, w_s)
            ri, ir = torch.bmm(x_r, w_s), torch.bmm(x_i, w_c)
            re[..., cs, :, :] = (rr - ii).view(cb, *lead, t, nb).movedim(0, -3)
            im[..., cs, :, :] = (ri + ir).view(cb, *lead, t, nb).movedim(0, -3)
    return re, im


def beamform(
    samples: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, precision: str = "f32"
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`beamform_planes` on ``[..., chan, time, ant, 2]`` (re, im) samples."""
    return beamform_planes(samples[..., 0], samples[..., 1], cos, sin, precision)


def beamform_folded(
    samples: torch.Tensor, coeff_blocks: torch.Tensor, precision: str = "f32"
) -> torch.Tensor:
    """One folded product per channel.

    ``samples``: ``[..., chan, time, ant, 2]`` (re, im) interleaved;
    ``coeff_blocks``: ``[chan, 2A, 2B]`` rotation blocks
    (:func:`~dpdk_dc_sand_tpu_torch.ops.coeff_gen.steering_coeff_matrix`).
    Returns ``[..., chan, time, beam, 2]`` f32 beams.
    """
    dt = _dtype(precision)
    *lead, c, t, a, two = samples.shape
    x = samples.reshape(*lead, c, t, a * two).movedim(-3, 0).reshape(c, -1, a * two)
    out = _folded_product(x, coeff_blocks, dt)  # [C, lead·T, 2B]
    out = out.view(c, *lead, t, -1).movedim(0, -3)
    return out.reshape(*lead, c, t, out.shape[-1] // 2, 2)


def beamform_planes_folded(
    qr: torch.Tensor, qi: torch.Tensor, blocks: torch.Tensor, precision: str = "bf16"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beamform int8 F planes with one folded product per channel.

    ``qr``, ``qi``: ``[A, P, S, C]``; ``blocks``: ``[C, 2A, 2B]`` block-concat
    weights (:func:`~dpdk_dc_sand_tpu_torch.ops.coeff_gen.steering_coeff_blockcat`).
    The corner turn is materialised as one int8 ``[C, P·S, 2A]`` copy
    (columns ``[re ants | im ants]``), as the reference does. Returns
    ``(beam_re, beam_im)`` each ``[P, C, S, B]`` f32.
    """
    a, p, s, c = qr.shape
    x = torch.empty((c, p * s, 2 * a), dtype=qr.dtype, device=qr.device)
    xv = x.view(c, p, s, 2 * a)
    xv[..., :a].copy_(qr.permute(3, 1, 2, 0))
    xv[..., a:].copy_(qi.permute(3, 1, 2, 0))
    return _split(_folded_product(x, blocks, _dtype(precision)), p, "split")


def beamform_turned(
    x_t: torch.Tensor,
    blocks: torch.Tensor,
    n_pols: int = 2,
    precision: str = "bf16",
    layout: str = "split",
):
    """Beamform corner-turned int8 samples with one folded product per channel.

    ``x_t``: ``[C, 2A, P·S]`` int8 from
    :func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_planes`
    (rows ``reim·A + a``, lanes ``p·S + s``). ``blocks``: ``[C, 2A, 2B]``
    block-concat steering weights, taken in the precision's dtype.

    ``layout="natural"``: the product's own ``[C, P·S, 2B]`` f32 output
    (columns ``[re beams | im beams]``). ``"split"``: ``(beam_re,
    beam_im)`` each ``[P, C, S, B]`` f32.
    """
    dt = _dtype(precision)
    _check_layout(layout)
    c, k2, _ = x_t.shape
    if tuple(blocks.shape[:2]) != (c, k2):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match x_t {tuple(x_t.shape)}")
    return _split(_folded_product(x_t.transpose(1, 2), blocks, dt), n_pols, layout)


def beamform_turned_split(
    xr_t: torch.Tensor,
    xi_t: torch.Tensor,
    blocks: torch.Tensor,
    n_pols: int = 2,
    precision: str = "bf16",
    layout: str = "split",
):
    """:func:`beamform_turned` over per-plane turned operands.

    ``xr_t``, ``xi_t``: ``[C, A, P·S]`` int8, one per plane
    (:func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_plane_native`,
    K8). The folded contraction splits into its re and im halves,
    ``xr_t·W[:, :A] + xi_t·W[:, A:]`` in f32: the same products as the one
    ``[C, 2A, ·]`` product with one more add per output. Layouts as
    :func:`beamform_turned`.
    """
    dt = _dtype(precision)
    _check_layout(layout)
    c, a, m = xr_t.shape
    if xi_t.shape != xr_t.shape or tuple(blocks.shape[:2]) != (c, 2 * a):
        raise ValueError(f"planes {tuple(xr_t.shape)}/{tuple(xi_t.shape)} and blocks "
                         f"{tuple(blocks.shape)} do not match")
    out = torch.empty((c, m, blocks.shape[-1]), dtype=torch.float32, device=xr_t.device)
    with _full_f32(xr_t.device):
        for cs in _chunks(c):
            w = _operand(blocks[cs], dt)
            torch.bmm(_operand(xr_t[cs].transpose(1, 2), dt), w[:, :a], out=out[cs])
            out[cs].baddbmm_(_operand(xi_t[cs].transpose(1, 2), dt), w[:, a:])
    return _split(out, n_pols, layout)
