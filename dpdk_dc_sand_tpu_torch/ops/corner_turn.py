"""Corner turn: int8 ``[A, P, S, C]`` planes -> ``[C, 2A, P·S]`` (counterpart of ``dpdk_dc_sand_tpu/ops/corner_turn.py``).

For CUDA tensors :func:`corner_turn_planes` launches the hand-written kernel
``csrc/corner_turn.cu`` (K4); for CPU tensors it runs
:func:`corner_turn_planes_reference`, the plain PyTorch version. The
reference's X-layout turn (K5a) writes the same bytes, so
:func:`corner_turn_planes_x` is a view of K4's output. Both are bit-exact
permutes.

The gates :func:`corner_turn_supported` and :func:`corner_turn_x_supported`
are the reference's, so the engines branch exactly as the reference does;
the CUDA kernel itself takes any geometry.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch import _build

#: The reference kernel's channel block, spectra chunk and VMEM cap: the
#: gates below keep its geometry rules.
_C_BLK = 128
_S_CHUNK = 128
_VMEM_CAP = 14 * 1024 * 1024


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


def corner_turn_planes_reference(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: ``[C, 2A, P·S]`` int8."""
    a, p, s, c = qr.shape
    t = torch.cat([qr, qi]).reshape(2, a * p * s, c).permute(2, 0, 1)
    return t.contiguous().view(c, 2 * a, p * s)


def _launch(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    a, p, s, c = qr.shape
    for name, t in (("qr", qr), ("qi", qi)):
        if t.dtype != torch.int8 or t.device != qr.device or not t.is_contiguous():
            raise ValueError(f"corner_turn_planes: {name} must be contiguous int8 on {qr.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"corner_turn_planes: {name} must be 4-byte aligned")
    out = torch.empty((c, 2 * a, p * s), dtype=torch.int8, device=qr.device)
    lib = _build.library()
    err = lib.corner_turn_launch(
        qr.data_ptr(), qi.data_ptr(), out.data_ptr(), a * p * s, c,
        torch.cuda.current_stream(qr.device).cuda_stream,
    )
    _build.check(lib, err, "corner_turn")
    corner_turn_planes.launches += 1
    return out


def corner_turn_planes(qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Turn int8 F-engine planes into the beamform operand layout (K4 on CUDA).

    ``qr``, ``qi``: ``[A, P, S, C]`` int8. Returns ``[C, 2A, P·S]`` int8 with
    rows ``k = reim·A + a`` and lanes ``m = p·S + s`` — the operand of
    :func:`~dpdk_dc_sand_tpu_torch.ops.beamform.beamform_turned`.
    """
    if qr.ndim == 5:
        raise NotImplementedError(
            "5-d native F planes need the per-plane native turn "
            "(corner_turn_plane_native, K8), which is not ported yet "
            "(see ROADMAP.md)"
        )
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    if qr.device.type == "cuda":
        return _launch(qr, qi)
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


#: Kernel launches since the last reset (the plain CPU version never counts).
corner_turn_planes.launches = 0
