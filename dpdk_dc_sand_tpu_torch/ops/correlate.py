"""X-engine cross-correlation, plain PyTorch (counterpart of ``dpdk_dc_sand_tpu/ops/correlate.py``).

The reference's grams are XLA ``dot_general``s outside any Pallas kernel;
here they are ``torch.bmm``, at the reference's rounding points:

- ``precision="int8"``: exact integer grams. :func:`correlate_planes` adds
  its two grams exactly (the reference's int32) and converts once;
  :func:`correlate_turned` converts each gram to f32 and then adds, as the
  reference does. The grams run in f64, exact for any realistic length
  (the f32 gram is exact only while partial sums stay below 2²⁴, i.e. up
  to 1024 samples), so the two orders give the reference's results also
  past that bound;
- ``"f32"``: f32 operands and f32 grams (keep TF32 off on a GPU);
- ``"bf16"``: operands rounded to bf16, products and sums in f32.

Channels go in chunks, which bounds the temporaries at large geometries.
"""

from __future__ import annotations

import torch

#: Channels per gram step.
_CHANNEL_CHUNK = 1024


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        return x.to(torch.int8).to(torch.float64)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "f32":
        return x.to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _grams(pairs, precision: str, contract: int):
    """Batched grams ``Σ a_i b_j`` over axis ``contract`` (1: [C, T, I]; 2: [C, I, T])."""
    out = []
    for a, b in pairs:
        a, b = _operand(a, precision), _operand(b, precision)
        if contract == 1:
            out.append(torch.bmm(a.transpose(1, 2), b))
        else:
            out.append(torch.bmm(a, b.transpose(1, 2)))
    return out


def _chunked(fn, c: int, i: int, device):
    vre = torch.empty((c, i, i), dtype=torch.float32, device=device)
    vim = torch.empty_like(vre)
    for c0 in range(0, c, _CHANNEL_CHUNK):
        c1 = min(c, c0 + _CHANNEL_CHUNK)
        vre[c0:c1], vim[c0:c1] = fn(slice(c0, c1))
    return vre, vim


def correlate_planes(
    xr: torch.Tensor, xi: torch.Tensor, precision: str = "f32"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibilities from separate (re, im) planes ``[chan, time, n_inputs]``.

    Returns ``(V_re, V_im)`` ``[chan, I, I]`` f32 with
    ``V[c, i, j] = Σ_t x_i·conj(x_j)``.
    """
    c, _, i = xr.shape

    def block(sl):
        r, im = xr[sl], xi[sl]
        rr, ii, ir, ri = _grams(((r, r), (im, im), (im, r), (r, im)), precision, 1)
        # int8: f64 sums of exact integers are the reference's int32 sums.
        return (rr + ii).to(torch.float32), (ir - ri).to(torch.float32)

    return _chunked(block, c, i, xr.device)


def correlate(samples: torch.Tensor, precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """Visibilities of one ``[chan, time, n_inputs, 2]`` (re, im) block."""
    return correlate_planes(samples[..., 0], samples[..., 1], precision)


def correlate_accumulate(
    samples: torch.Tensor,
    acc_re: torch.Tensor,
    acc_im: torch.Tensor,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Add one block's visibilities to the running sums IN PLACE and return them.

    The reference returns new arrays and asks the caller to donate the old
    ones; here ``acc_re``/``acc_im`` are updated with ``add_``.
    """
    vre, vim = correlate(samples, precision)
    return acc_re.add_(vre), acc_im.add_(vim)


def correlate_turned(
    xt: torch.Tensor, n_inputs: int, precision: str = "int8"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibilities from the turned ``[C, 2I, S]`` planes: four row-sliced grams.

    ``V_re = G[:I, :I] + G[I:, I:]``, ``V_im = G[I:, :I] − G[:I, I:]``; in
    int8 each gram is converted to f32 before the sum, as the reference's
    are.
    """
    c = xt.shape[0]
    i = n_inputs

    def block(sl):
        r, im = xt[sl, :i], xt[sl, i:]
        grams = _grams(((r, r), (im, im), (im, r), (r, im)), precision, 2)
        rr, ii, ir, ri = (g.to(torch.float32) for g in grams)
        return rr + ii, ir - ri

    return _chunked(block, c, i, xt.device)
