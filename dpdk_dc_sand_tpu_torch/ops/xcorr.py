"""Visibility grams on the int8 tensor cores (counterpart of ``dpdk_dc_sand_tpu/ops/xcorr_pallas.py``).

Two kernels in ``csrc/xcorr.cu``:

- :func:`correlate_planes_fused` (K3) reads the F planes ``[A, P, S, C]``
  directly, turns them on chip and writes ``(V_re, V_im)``; no turned
  intermediate reaches device memory;
- :func:`correlate_turned_fused` (K5b) reads the turned ``[C, 2I, S]``
  layout of :func:`~dpdk_dc_sand_tpu_torch.ops.corner_turn.corner_turn_planes_x`.

:func:`correlate_planes_fused_stop` and :func:`correlate_turned_fused_stop`
launch K3 and K5b cut to some of their stages (the copies, the MMAs, the
stores), which splits their time on the card; :func:`kernel_attributes` and
:func:`turned_kernel_attributes` read their bodies' registers and spills.

With ``Y = [re rows; im rows]`` of a channel's ``I = A·P`` inputs and
``G = Y·Yᵀ``: ``V_re = G₁₁ + G₂₂`` and ``V_im = G₂₁ − G₁₂``, ``[C, I, I]``
f32. The kernels accumulate exact s32 sums; the plain versions
(:func:`correlate_planes_fused_reference`,
:func:`correlate_turned_fused_reference`) take a stacked f32 gram, exact
because every partial sum is an integer below 2²⁴ for ``S <= 1024`` (the
gates keep that bound). The two are equal bit for bit. The reference's
``int8_mxu`` flag has no counterpart: the kernel always computes the exact
int8 gram.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch import _build

#: The reference's channel block of K5b and turn block of K3 (gate rules).
_C_BLK = 8
_CT_BLK = 128
#: Exactness bound: f32 sums of 14-bit products stay exact up to 2^24 / 2^14.
_S_EXACT_MAX = 1024
#: Channels per step of the plain versions (bounds the f32 operand and the
#: [chunk, 2I, 2I] stacked gram).
_PLAIN_CHANNEL_CHUNK = 1024


def xcorr_supported(n_channels: int, n_spectra: int) -> bool:
    """The reference's gate of the turned visibility kernel (K5b)."""
    return n_channels % _C_BLK == 0 and n_spectra % 8 == 0 and n_spectra <= _S_EXACT_MAX


def xcorr_fused_supported(n_ants: int, n_pols: int, n_spectra: int, n_channels: int) -> bool:
    """The reference's gate of the turn + gram kernel (K3)."""
    return (
        n_channels % _CT_BLK == 0
        and n_spectra % 128 == 0
        and n_spectra <= _S_EXACT_MAX
    )


def _stacked_gram(y: torch.Tensor, n_inputs: int, vre: torch.Tensor, vim: torch.Tensor) -> None:
    """``y`` ``[cb, 2I, S]`` int8 -> V_re, V_im written into ``[cb, I, I]`` f32."""
    i = n_inputs
    yf = y.to(torch.float32)
    g = torch.bmm(yf, yf.transpose(1, 2))
    torch.add(g[:, :i, :i], g[:, i:, i:], out=vre)
    torch.sub(g[:, i:, :i], g[:, :i, i:], out=vim)


def correlate_turned_fused_reference(
    xt: torch.Tensor, n_inputs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5b: stacked f32 grams, chunked over channels."""
    c = xt.shape[0]
    vre = torch.empty((c, n_inputs, n_inputs), dtype=torch.float32, device=xt.device)
    vim = torch.empty_like(vre)
    for c0 in range(0, c, _PLAIN_CHANNEL_CHUNK):
        c1 = min(c, c0 + _PLAIN_CHANNEL_CHUNK)
        _stacked_gram(xt[c0:c1], n_inputs, vre[c0:c1], vim[c0:c1])
    return vre, vim


def correlate_planes_fused_reference(
    qr: torch.Tensor, qi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: the turn, then the stacked gram, per channel chunk."""
    a, p, s, c = qr.shape
    i = a * p
    vre = torch.empty((c, i, i), dtype=torch.float32, device=qr.device)
    vim = torch.empty_like(vre)
    planes = (qr.reshape(i, s, c), qi.reshape(i, s, c))
    for c0 in range(0, c, _PLAIN_CHANNEL_CHUNK):
        c1 = min(c, c0 + _PLAIN_CHANNEL_CHUNK)
        y = torch.cat([t[:, :, c0:c1] for t in planes]).permute(2, 0, 1)  # [cb, 2I, S]
        _stacked_gram(y, i, vre[c0:c1], vim[c0:c1])
    return vre, vim


def _outputs(c: int, i: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    vre = torch.empty((c, i, i), dtype=torch.float32, device=device)
    return vre, torch.empty_like(vre)


def _check(name: str, ts, device) -> None:
    for t in ts:
        if t.dtype != torch.int8 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous int8 on {device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: inputs must be 4-byte aligned")


def correlate_turned_fused(xt: torch.Tensor, n_inputs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibilities from the turned ``[C, 2I, S]`` int8 planes (K5b on CUDA).

    Returns ``(V_re, V_im)`` ``[C, I, I]`` f32, exact for int8 inputs.
    """
    c, two_i, s = xt.shape
    if two_i != 2 * n_inputs:
        raise ValueError(f"xt rows {two_i} != 2·n_inputs {2 * n_inputs}")
    if not xcorr_supported(c, s):
        raise ValueError(f"correlate_turned_fused: C={c}, S={s} outside xcorr_supported")
    if xt.device.type == "cpu":
        return correlate_turned_fused_reference(xt, n_inputs)
    if xt.device.type != "cuda":
        raise ValueError(f"correlate_turned_fused: unsupported device {xt.device}")
    _check("correlate_turned_fused", (xt,), xt.device)
    vre, vim = _outputs(c, n_inputs, xt.device)
    lib = _build.library()
    err = lib.xcorr_turned_launch(
        xt.data_ptr(), vre.data_ptr(), vim.data_ptr(), n_inputs, s, c,
        torch.cuda.current_stream(xt.device).cuda_stream,
    )
    _build.check(lib, err, "xcorr_turned")
    correlate_turned_fused.launches += 1
    return vre, vim


def correlate_planes_fused(qr: torch.Tensor, qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibilities straight from the F planes: on-chip turn + gram (K3 on CUDA).

    ``qr``, ``qi``: ``[A, P, S, C]`` int8. Returns ``(V_re, V_im)``
    ``[C, I, I]`` f32 with ``I = A·P`` inputs ordered ``a·P + p``.
    """
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    a, p, s, c = qr.shape
    if not xcorr_fused_supported(a, p, s, c):
        raise ValueError(f"correlate_planes_fused: {tuple(qr.shape)} outside xcorr_fused_supported")
    if qr.device.type == "cpu":
        return correlate_planes_fused_reference(qr, qi)
    if qr.device.type != "cuda":
        raise ValueError(f"correlate_planes_fused: unsupported device {qr.device}")
    _check("correlate_planes_fused", (qr, qi), qr.device)
    vre, vim = _outputs(c, a * p, qr.device)
    lib = _build.library()
    err = lib.xcorr_fused_launch(
        qr.data_ptr(), qi.data_ptr(), vre.data_ptr(), vim.data_ptr(), a * p, s, c,
        torch.cuda.current_stream(qr.device).cuda_stream,
    )
    _build.check(lib, err, "xcorr_fused")
    correlate_planes_fused.launches += 1
    return vre, vim


def kernel_attributes(n_inputs: int, n_spectra: int, n_channels: int) -> dict:
    """K3's body as the runtime reports it: registers and local (spill) bytes
    (``cudaFuncGetAttributes``), and the blocks of its persistent grid for a
    shape (the occupancy API). Needs the card."""
    import ctypes

    lib = _build.library()
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.xcorr_fused_attributes(n_inputs, n_spectra, n_channels, ctypes.byref(regs),
                                     ctypes.byref(local), ctypes.byref(blocks))
    _build.check(lib, err, "xcorr_fused_attributes")
    return dict(regs=regs.value, local_bytes=local.value, blocks=blocks.value)


#: K3's and K5b's stage stops: the stages of the body each keeps
#: (``csrc/xcorr.cu``: ``K3_COPY`` / ``K5B_COPY`` 1, ``_MMA`` 2, ``_STORE`` 4).
K3_STOPS = K5B_STOPS = {"copy": 1, "mma": 2, "store": 4, "copy_mma": 3, "mma_store": 6}

#: K5b's plans (``csrc/xcorr.cu:k5b_plan``): a channel's rows resident in
#: shared memory, two channels at once or one; or streamed in stages.
K5B_PLANS = {1: "two_slots", 2: "one_slot", 3: "stream"}


def correlate_planes_fused_stop(qr: torch.Tensor, qi: torch.Tensor, vre: torch.Tensor,
                                vim: torch.Tensor, stop: str) -> None:
    """Launch K3 cut to some of its stages, to split its time (CUDA only).

    Writes into ``vre``, ``vim`` ``[C, I, I]`` f32 what the stop leaves: the
    stops with ``store`` write zeros everywhere, the others nothing. Does not
    count as a K3 launch.
    """
    if stop not in K3_STOPS:
        raise ValueError(f"correlate_planes_fused_stop: unknown stop {stop!r}")
    if qr.ndim != 4 or qi.shape != qr.shape:
        raise ValueError(f"planes {tuple(qr.shape)}/{tuple(qi.shape)}: want two [A, P, S, C]")
    a, p, s, c = qr.shape
    if qr.device.type != "cuda":
        raise ValueError(f"correlate_planes_fused_stop: needs CUDA tensors, not {qr.device}")
    _check("correlate_planes_fused_stop", (qr, qi), qr.device)
    want = (c, a * p, a * p)
    for v in (vre, vim):
        if v.shape != want or v.dtype != torch.float32 or v.device != qr.device \
                or not v.is_contiguous():
            raise ValueError(f"correlate_planes_fused_stop: outputs must be {want} f32 on {qr.device}")
    lib = _build.library()
    err = lib.xcorr_fused_stop_launch(
        qr.data_ptr(), qi.data_ptr(), vre.data_ptr(), vim.data_ptr(), a * p, s, c,
        K3_STOPS[stop], torch.cuda.current_stream(qr.device).cuda_stream,
    )
    _build.check(lib, err, "xcorr_fused_stop")


def turned_kernel_attributes(n_inputs: int, n_spectra: int, n_channels: int) -> dict:
    """K5b's body as the runtime reports it (registers and local (spill)
    bytes by ``cudaFuncGetAttributes``, the blocks of its persistent grid by
    the occupancy API) and the plan the C side takes for a shape: ``plan``
    (:data:`K5B_PLANS`), ``stage_samples``, ``items_per_channel``,
    ``smem_bytes`` and ``tma`` (a channel's rows arrive by TMA from a
    16-byte aligned base). Needs the card."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 8)()
    err = lib.xcorr_turned_attributes(n_inputs, n_spectra, n_channels, out)
    _build.check(lib, err, "xcorr_turned_attributes")
    regs, local, blocks, plan, kc, items, smem, tma = out
    return dict(regs=regs, local_bytes=local, blocks=blocks, plan=K5B_PLANS[plan],
                stage_samples=kc, items_per_channel=items, smem_bytes=smem, tma=bool(tma))


def correlate_turned_fused_stop(xt: torch.Tensor, n_inputs: int, vre: torch.Tensor,
                                vim: torch.Tensor, stop: str) -> None:
    """Launch K5b cut to some of its stages, to split its time (CUDA only).

    Writes into ``vre``, ``vim`` ``[C, I, I]`` f32 what the stop leaves: the
    stops with ``store`` write zeros everywhere, the others nothing. Does not
    count as a K5b launch.
    """
    if stop not in K5B_STOPS:
        raise ValueError(f"correlate_turned_fused_stop: unknown stop {stop!r}")
    if xt.ndim != 3 or xt.shape[1] != 2 * n_inputs:
        raise ValueError(f"xt {tuple(xt.shape)}: want [C, 2·{n_inputs}, S]")
    c, _, s = xt.shape
    want = (c, n_inputs, n_inputs)
    for v in (vre, vim):
        if v.shape != want or v.dtype != torch.float32 or v.device != xt.device \
                or not v.is_contiguous():
            raise ValueError(f"correlate_turned_fused_stop: outputs must be {want} f32 on {xt.device}")
    if xt.device.type != "cuda":
        raise ValueError(f"correlate_turned_fused_stop: needs CUDA tensors, not {xt.device}")
    _check("correlate_turned_fused_stop", (xt,), xt.device)
    lib = _build.library()
    err = lib.xcorr_turned_stop_launch(
        xt.data_ptr(), vre.data_ptr(), vim.data_ptr(), n_inputs, s, c, K5B_STOPS[stop],
        torch.cuda.current_stream(xt.device).cuda_stream,
    )
    _build.check(lib, err, "xcorr_turned_stop")


#: Kernel launches since the last reset (the plain CPU versions never count).
correlate_turned_fused.launches = 0
correlate_planes_fused.launches = 0
