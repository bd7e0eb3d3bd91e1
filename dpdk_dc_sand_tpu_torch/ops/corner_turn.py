"""Corner turns of the int8 F planes (counterpart of ``dpdk_dc_sand_tpu/ops/corner_turn.py``).

Both wrappers launch the hand-written kernel ``csrc/corner_turn.cu`` for
CUDA tensors and run their plain PyTorch versions only for CPU tensors:

- :func:`corner_turn_planes` (K4): the two planes ``[A, P, S, C]`` ->
  ``[C, 2A, P·S]``. The reference's X-layout turn (K5a) writes the same
  bytes, so :func:`corner_turn_planes_x` is a view of K4's output.
- :func:`corner_turn_plane_native` (K8): one plane of the native F->B
  handoff, ``[A, P, S, rows, lanes]`` (or ``[A, P, S, C]``) ->
  ``[C, A, P·S]``: the same kernel launched on one plane.

All are bit-exact permutes. The gates :func:`corner_turn_supported`,
:func:`corner_turn_x_supported` and :func:`corner_turn_native_supported`
are the reference's, so the engines branch exactly as the reference does;
the CUDA kernel itself takes any geometry.
"""

from __future__ import annotations

import math

import torch

from dpdk_dc_sand_tpu_torch import _build

#: The reference kernel's channel block, spectra chunk and VMEM cap: the
#: gates below keep its geometry rules.
_C_BLK = 128
_S_CHUNK = 128
_VMEM_CAP = 14 * 1024 * 1024
#: Plane rows per channel block of the reference's native turn.
_NATIVE_ROWS = 8


def corner_turn_supported(n_ants: int, n_pols: int, n_spectra: int, n_channels: int) -> bool:
    """The reference's geometry gate of the B-layout turn (K4)."""
    if n_channels % _C_BLK and n_channels >= _C_BLK:
        return False
    if n_spectra % _S_CHUNK == 0:
        return True
    if (n_pols * n_spectra) % 128:
        return False
    c_blk = min(_C_BLK, n_channels)
    per_step = (
        2 * 2 * n_ants * n_pols * n_spectra * c_blk
        + 2 * c_blk * 2 * n_ants * n_pols * n_spectra
    )
    return per_step <= _VMEM_CAP


def corner_turn_x_supported(n_ants: int, n_pols: int, n_spectra: int, n_channels: int) -> bool:
    """The reference's geometry gate of the X-layout turn (K5a)."""
    if n_channels % _C_BLK and n_channels >= _C_BLK:
        return False
    return n_spectra % _S_CHUNK == 0


def corner_turn_native_supported(
    n_ants: int, n_pols: int, n_spectra: int, out_rows: int, out_lanes: int
) -> bool:
    """The reference's geometry gate of the native-handoff turn (K8)."""
    return (
        out_lanes % 128 == 0
        and n_spectra % _S_CHUNK == 0
        and out_rows % _NATIVE_ROWS == 0
        and (n_ants % 8 == 0 or n_ants < 8)
    )


def corner_turn_planes_reference(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: ``[C, 2A, P·S]`` int8."""
    a, p, s, c = qr.shape
    t = torch.cat([qr, qi]).reshape(2, a * p * s, c).permute(2, 0, 1)
    return t.contiguous().view(c, 2 * a, p * s)


def corner_turn_plane_native_reference(q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: ``[C, A, P·S]`` int8."""
    a, p, s = q.shape[:3]
    c = math.prod(q.shape[3:])
    return q.reshape(a, p, s, c).permute(3, 0, 1, 2).reshape(c, a, p * s).contiguous()


def _launch(planes: tuple[torch.Tensor, ...], rows: int, n_ch: int, what: str) -> torch.Tensor:
    """Turn each ``[rows, n_ch]`` plane into ``out[c, z·rows + r]`` on the card."""
    first = planes[0]
    for t in planes:
        if t.dtype != torch.int8 or t.device != first.device or not t.is_contiguous():
            raise ValueError(f"{what}: planes must be contiguous int8 on {first.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{what}: planes must be 4-byte aligned")
    out = torch.empty((n_ch, len(planes) * rows), dtype=torch.int8, device=first.device)
    lib = _build.library()
    err = lib.corner_turn_launch(
        first.data_ptr(), planes[-1].data_ptr(), out.data_ptr(), rows, n_ch, len(planes),
        torch.cuda.current_stream(first.device).cuda_stream,
    )
    _build.check(lib, err, what)
    return out


def corner_turn_planes(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Turn int8 F-engine planes into the beamform operand layout (K4 on CUDA).

    ``qr``, ``qi``: ``[A, P, S, C]`` int8. Returns ``[C, 2A, P·S]`` int8 with
    rows ``k = reim·A + a`` and lanes ``m = p·S + s`` — the operand of
    :func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_turned`. The native
    5-d planes take :func:`corner_turn_plane_native`, one per plane.
    """
    if qr.ndim == 5:
        raise ValueError(
            "5-d native planes: use corner_turn_plane_native per plane + "
            "beamform_turned_split"
        )
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    a, p, s, c = qr.shape
    if qr.device.type == "cuda":
        out = _launch((qr, qi), a * p * s, c, "corner_turn_planes")
        corner_turn_planes.launches += 1
        return out.view(c, 2 * a, p * s)
    if qr.device.type == "cpu":
        return corner_turn_planes_reference(qr, qi)
    raise ValueError(f"corner_turn_planes: unsupported device {qr.device}")


def corner_turn_planes_x(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Turn int8 planes into the correlator operand layout (K5a = K4).

    Returns ``[C, 2·A·P, S]`` int8 with rows ``k = reim·A·P + a·P + p``:
    the same bytes as :func:`corner_turn_planes`, viewed per input.
    """
    a, p, s, c = qr.shape
    return corner_turn_planes(qr, qi).view(c, 2 * a * p, s)


def corner_turn_plane_native(q: torch.Tensor) -> torch.Tensor:
    """Turn ONE native F plane into the split beamform operand (K8 on CUDA).

    ``q``: ``[A, P, S, rows, lanes]`` int8 (channel ``k = row·lanes + lane``,
    row-major: a view of K1's ``[A, P, S, C]`` output) or ``[A, P, S, C]``.
    Returns ``[C, A, P·S]`` int8, ``out[c, a, p·S + s] = q[a, p, s, c]`` —
    one operand of
    :func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_turned_split`.
    """
    if q.ndim not in (4, 5):
        raise ValueError(f"plane {tuple(q.shape)}: want [A, P, S, rows, lanes] or [A, P, S, C]")
    a, p, s = q.shape[:3]
    c = math.prod(q.shape[3:])
    if q.device.type == "cuda":
        out = _launch((q,), a * p * s, c, "corner_turn_plane_native")
        corner_turn_plane_native.launches += 1
        return out.view(c, a, p * s)
    if q.device.type == "cpu":
        return corner_turn_plane_native_reference(q)
    raise ValueError(f"corner_turn_plane_native: unsupported device {q.device}")


#: Kernel launches since the last reset (the plain CPU versions never count).
corner_turn_planes.launches = 0
corner_turn_plane_native.launches = 0
