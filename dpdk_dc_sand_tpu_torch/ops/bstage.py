"""Fused B stage: corner turn + multi-beam dot (counterpart of ``dpdk_dc_sand_tpu/ops/bstage_pallas.py``).

For CUDA tensors :func:`beamform_turned_fused` launches the hand-written
kernel ``csrc/bstage_fused.cu`` (K2); for CPU tensors it runs
:func:`beamform_turned_fused_reference`, the plain PyTorch version. Both
convert int8 samples exactly, take the weights in the precision's dtype
(bf16 or f32) and accumulate in f32. K2 has one body, on the tensor cores,
for both weight types (f32 weights as three exact bf16 terms) and every
geometry its gate :func:`bstage_fused_supported` admits, which holds every
geometry the reference's gate admits.

:func:`beamform_turned_fused_stop` launches K2's body cut to some of its
stages (the ring's copies, the MMAs, the stores), which splits its time on
the card; :func:`kernel_attributes` reports that body's registers, spill
bytes and geometry.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch import _build

#: Output row width: ``pack`` adjacent channels' ``[re beams | im beams]``.
_LANES = 128
#: Beam-column widths (2B) K2 takes: every width that divides the 128 lanes
#: of a packed row (the reference's gate, ``bstage_pallas.py:58``).
_NB2_KERNEL = (2, 4, 8, 16, 32, 64, 128)
#: Channels per step of the plain version (bounds its f32 ``[chunk, P·S, 2A]``
#: operand).
_PLAIN_CHANNEL_CHUNK = 4096


def bstage_fused_supported(
    n_ants: int, n_pols: int, n_spectra: int, n_beams: int, n_channels: int
) -> bool:
    """Geometry gate of K2: 2B dividing 128, whole packed rows (``C % pack
    == 0``, the last 16-channel block masked), and ``P·S`` a multiple of the
    64-row m tile (32 rows at 2B >= 64). It admits every geometry
    :func:`reference_fused_gate` admits (whose ``P·S % 128`` and
    ``C % min(128, C) == 0`` are stricter) and more."""
    nb2 = 2 * n_beams
    return (
        n_ants >= 1
        and nb2 in _NB2_KERNEL
        and n_channels >= 1
        and n_channels % (_LANES // nb2) == 0
        and (n_pols * n_spectra) % 64 == 0
    )


def reference_fused_gate(
    n_ants: int, n_pols: int, n_spectra: int, n_beams: int, n_channels: int
) -> bool:
    """The reference's K2 gate (``bstage_pallas.py:48-66``, its VMEM plan).

    The engines' ``"auto"`` backend resolution follows it, so that they
    pick the B form the reference picks; whether this kernel covers the
    geometry is :func:`bstage_fused_supported`.
    """
    ps = n_pols * n_spectra
    nb2 = 2 * n_beams
    if ps % 128 or _LANES % nb2:
        return False
    pack = _LANES // nb2
    c_blk = min(128, n_channels)
    if n_channels % c_blk or c_blk % pack:
        return False
    vmem = (
        2 * 2 * n_ants * ps * c_blk
        + 2 * (c_blk // pack) * ps * _LANES * 4
        + 2 * c_blk * n_ants * ps
        + c_blk * 2 * n_ants * nb2 * 2
    )
    return vmem < 48 << 20


def _weights(blocks: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    return blocks.to(torch.bfloat16 if precision == "bf16" else torch.float32)


def beamform_turned_fused_reference(
    qr: torch.Tensor, qi: torch.Tensor, blocks: torch.Tensor, precision: str = "bf16"
) -> torch.Tensor:
    """Plain PyTorch version of K2: packed ``[C/pack, P·S, pack·2B]`` f32."""
    a, p, s, c = qr.shape
    nb2 = blocks.shape[-1]
    pack = _LANES // nb2
    ps = p * s
    x = torch.cat([qr, qi], 0).reshape(2 * a, ps, c)
    w = _weights(blocks, precision).to(torch.float32)
    out = torch.empty((c, ps, nb2), dtype=torch.float32, device=qr.device)
    for c0 in range(0, c, _PLAIN_CHANNEL_CHUNK):
        c1 = min(c, c0 + _PLAIN_CHANNEL_CHUNK)
        xt = x[:, :, c0:c1].permute(2, 1, 0).to(torch.float32)  # [cb, PS, 2A]
        out[c0:c1] = torch.bmm(xt, w[c0:c1])
    return (
        out.reshape(c // pack, pack, ps, nb2)
        .permute(0, 2, 1, 3)
        .reshape(c // pack, ps, pack * nb2)
    )


def _check_kernel_inputs(what, qr, qi, w, nb2):
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"{what}: planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    a, p, s, c = qr.shape
    for name, t in (("qr", qr), ("qi", qi), ("blocks", w)):
        if t.device != qr.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {qr.device}")
    if qr.dtype != torch.int8 or qi.dtype != torch.int8:
        raise ValueError(f"{what}: planes must be int8")
    if tuple(w.shape) != (c, 2 * a, nb2) or w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: blocks {tuple(w.shape)} {w.dtype}")


def _launch(qr, qi, w, nb2):
    _check_kernel_inputs("beamform_turned_fused", qr, qi, w, nb2)
    a, p, s, c = qr.shape
    if not bstage_fused_supported(a, p, s, nb2 // 2, c):
        raise NotImplementedError(
            f"K2 does not cover A={a} P={p} S={s} 2B={nb2} C={c} "
            "(bstage_fused_supported)"
        )
    if w.data_ptr() % 16:  # the weight rows' 16-byte copies need an aligned base
        w = w.clone()
    out = torch.empty(
        (c // (_LANES // nb2), p * s, _LANES), dtype=torch.float32, device=qr.device
    )
    lib = _build.library()
    err = lib.bstage_fused_launch(
        qr.data_ptr(), qi.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
        out.data_ptr(), a, p * s, c, nb2,
        torch.cuda.current_stream(qr.device).cuda_stream,
    )
    _build.check(lib, err, "bstage_fused")
    beamform_turned_fused.launches += 1
    return out


def beamform_turned_fused(
    qr: torch.Tensor,
    qi: torch.Tensor,
    blocks: torch.Tensor,
    n_pols: int = 2,
    precision: str = "bf16",
    layout: str = "split",
):
    """Corner turn + beamform (K2 on CUDA, plain on CPU).

    ``qr``, ``qi``: ``[A, P, S, C]`` int8 F-engine planes. ``blocks``:
    ``[C, 2A, 2B]`` block-concat steering weights
    (:func:`~dpdk_dc_sand_tpu_torch.ops.coeff_gen.steering_coeff_blockcat`).

    ``layout="packed"``: the ``[C/pack, P·S, pack·2B]`` f32 wire format
    (pack = 128/2B; lanes hold ``pack`` adjacent channels' ``[re | im]``
    beam groups). ``layout="split"``: ``(beam_re, beam_im)`` each
    ``[P, C, S, B]`` f32.
    """
    a, p, s, c = qr.shape
    if qi.shape != qr.shape or p != n_pols:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}, n_pols={n_pols}")
    if layout not in ("packed", "split"):
        raise ValueError(f"unknown layout {layout!r}")
    nb2 = blocks.shape[-1]
    if _LANES % nb2 or tuple(blocks.shape) != (c, 2 * a, nb2):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match planes")
    if qr.device.type == "cuda":
        packed = _launch(qr, qi, _weights(blocks, precision).contiguous(), nb2)
    elif qr.device.type == "cpu":
        packed = beamform_turned_fused_reference(qr, qi, blocks, precision)
    else:
        raise ValueError(f"beamform_turned_fused: unsupported device {qr.device}")
    if layout == "packed":
        return packed
    nb = nb2 // 2
    pack = _LANES // nb2
    x = packed.reshape(c // pack, p, s, pack, 2, nb)
    x = x.permute(1, 0, 3, 2, 4, 5).reshape(p, c, s, 2, nb)
    return x[..., 0, :], x[..., 1, :]


def kernel_attributes(
    n_ants: int, n_pols: int, n_spectra: int, n_beams: int, n_channels: int,
    precision: str = "bf16",
) -> dict:
    """K2's body for a shape and weight precision as the runtime reports it:
    registers and local (spill) bytes (``cudaFuncGetAttributes``), the
    blocks of its persistent grid (the occupancy API), and the C side's
    geometry: channels and m rows a work item, contraction rows a K step,
    whether the weights are held whole in shared memory, the shared memory a
    block, the columns a work item computes (2B, 8 below 2B = 8, 64 at 2B =
    128) and whether 16-byte-aligned planes of this C take the wide copies.
    Needs the card."""
    import ctypes

    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    lib = _build.library()
    info = (ctypes.c_int * 10)()
    err = lib.bstage_fused_attributes(n_ants, n_pols * n_spectra, n_channels, 2 * n_beams,
                                      int(precision == "bf16"), ctypes.addressof(info))
    _build.check(lib, err, "bstage_fused_attributes")
    keys = ("regs", "local_bytes", "blocks", "channels", "m_rows", "k_rows", "resident",
            "smem_bytes", "item_cols", "wide")
    return dict(zip(keys, info))


#: K2's stage stops: the stages of its body each keeps
#: (``csrc/bstage_fused.cu``, ``K2_COPY`` 1, ``K2_MMA`` 2, ``K2_STORE`` 4).
K2_STOPS = {"copy": 1, "mma": 2, "store": 4, "copy_mma": 3, "mma_store": 6}


def beamform_turned_fused_stop(qr: torch.Tensor, qi: torch.Tensor, blocks: torch.Tensor,
                               out: torch.Tensor, stop: str) -> None:
    """Launch K2's body cut to some of its stages, to split its time (CUDA
    only; ``blocks`` bf16 or f32, the weight type of the form it cuts).

    Writes into ``out`` (the packed ``[C/pack, P·S, 128]`` f32) what the
    stop leaves: the stops with ``store`` write zeros everywhere, the others
    nothing. Does not count as a K2 launch.
    """
    what = "beamform_turned_fused_stop"
    if stop not in K2_STOPS:
        raise ValueError(f"{what}: unknown stop {stop!r}")
    if qr.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, not {qr.device}")
    nb2 = blocks.shape[-1]
    _check_kernel_inputs(what, qr, qi, blocks, nb2)
    a, p, s, c = qr.shape
    want = (c // (_LANES // nb2), p * s, _LANES)
    if tuple(out.shape) != want or out.dtype != torch.float32 or out.device != qr.device \
            or not out.is_contiguous():
        raise ValueError(f"{what}: out must be {want} f32 on {qr.device}")
    lib = _build.library()
    err = lib.bstage_fused_stop_launch(
        qr.data_ptr(), qi.data_ptr(), blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
        out.data_ptr(), a, p * s, c, nb2, K2_STOPS[stop],
        torch.cuda.current_stream(qr.device).cuda_stream,
    )
    _build.check(lib, err, "bstage_fused_stop")


#: Kernel launches since the last reset (the plain CPU version never counts).
beamform_turned_fused.launches = 0
