"""Distributed F+B(+X) step over an ``("ant", "time")`` mesh (counterpart of ``dpdk_dc_sand_tpu/parallel/fbengine_sharded.py``).

The reference runs one ``shard_map`` body on every device of a mesh. The
port is SPMD: every rank builds the same :class:`ShardedFBEngine` on a
``DeviceMesh`` (:func:`~.mesh.make_mesh`), steps it on its own shard of the
inputs (:mod:`.ingest` says which) and returns its own shard of the output.
The reference's three XLA collectives become ``torch.distributed`` calls on
the mesh axes' groups:

1. **Overlap-save halo** (the reference's ``lax.ppermute`` over
   ``"time"``): each rank sends the last ``(n_taps−1)·fft_size`` samples of
   its time block to time index ``t+1 mod T`` and receives its halo from
   ``t−1 mod T`` in one ``batch_isend_irecv``. The exchange is circular:
   time index 0's halo is the last block's tail. At ``T = 1`` the rank
   sends to itself: NCCL takes that, gloo refuses it (its pair to itself is
   never connected), so on gloo at ``T = 1``, and only there, the halo is
   the rank's own tail, the same bytes the self send would deliver.
2. **Distributed corner turn** (``lax.all_to_all`` over ``"time"``): one
   ``all_to_all_single`` on the time group swaps spectra sharding for
   channel sharding, so each rank ends with all spectra of its channel
   slice, as a multicast subscription gave an X-engine in the reference.
3. **Antenna reduction** (``lax.psum`` / ``psum_scatter`` over ``"ant"``):
   ``all_reduce`` on the ant group, or ``reduce_scatter_tensor`` over the
   beam axis with ``scatter_beams``.

With ``emit_visibilities`` the X stage gathers each channel slice's planes
over ``"ant"`` (``all_gather_into_tensor``) and correlates them locally.

Coarse delay is an ingest concern (the host feed aligns whole-sample
offsets before sharding, as the NIC/chunking layer did in the reference);
fine delay and fringe phase are applied in-shard.

Kernels on the path: K1 (``fengine="fused"``) or K6 (the composed F,
``"xla"``); K4 then the folded product (``bstage="turned"``) or K2
(``"fused"``); K3 for the visibilities where its gate holds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models.fbengine import _b_stage, _coeff_blocks, _rot_key
from dpdk_dc_sand_tpu_torch.models.fengine import composed_f
from dpdk_dc_sand_tpu_torch.ops.bstage import bstage_fused_supported, reference_fused_gate
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import steering_coeff_blockcat, steering_key
from dpdk_dc_sand_tpu_torch.ops.corner_turn import corner_turn_supported
from dpdk_dc_sand_tpu_torch.ops.correlate import correlate_planes
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import (
    _split_ct,
    fengine_fused,
    fine_rotation_planes,
    ingest_alignment,
)
from dpdk_dc_sand_tpu_torch.ops.pfb import default_window
from dpdk_dc_sand_tpu_torch.ops.xcorr import correlate_planes_fused, xcorr_fused_supported
from dpdk_dc_sand_tpu_torch.parallel.mesh import mesh_device


class ShardedPlan(NamedTuple):
    """What ``"auto"`` resolved to for one engine."""

    fengine: str
    bstage: str
    ici_chunks: int
    rowed_ingest: bool


def _fused_b_ok(a_loc, n_pols, n_spectra, n_beams, c_loc) -> bool:
    """K2 at a per-shard geometry: the reference's gate (which ``"auto"``
    follows) and the kernel's own."""
    return (reference_fused_gate(a_loc, n_pols, n_spectra, n_beams, c_loc)
            and bstage_fused_supported(a_loc, n_pols, n_spectra, n_beams, c_loc))


def resolve_sharded(
    cfg: ArrayConfig,
    mesh_shape: tuple[int, int],
    n_spectra: int,
    *,
    fengine: str = "auto",
    bstage: str = "auto",
    ici_chunks: int | str = "auto",
    rowed_ingest: bool | str = "auto",
    emit_planes: bool = False,
    emit_visibilities: bool = False,
    scatter_beams: bool = False,
) -> ShardedPlan:
    """Resolve ``"auto"`` and check a configuration on an ``(ant, time)``
    mesh of ``mesh_shape``, by the reference's order and with its
    ``ValueError``s (``fbengine_sharded.py:89-151, 209-273``).

    Backends resolve against the PER-SHARD geometry: each rank channelises
    the full band of its time slice (F), then after the turn beamforms all
    spectra of its channel slice (B). F is ``"fused"`` where the port's
    fused F takes the fft, else ``"xla"``; B is ``"turned"`` where the
    corner turn's gate holds, else ``"fused"`` where K2's does, else
    ``"planar"``. The reference's "Pallas available" condition always holds:
    the hand-written kernels always run. ``ici_chunks="auto"`` is the largest
    k of {8, 4, 2} that divides the per-rank spectra and whose chunk (S/k
    spectra after the turn) still passes the B form's gate, on meshes of
    more than one rank and outside the emit modes; else 1.
    """
    if fengine not in ("auto", "xla", "fused", "fused_f32"):
        raise ValueError(f"unknown fengine backend {fengine!r}")
    if bstage not in ("auto", "planar", "turned", "fused"):
        raise ValueError(f"unknown bstage backend {bstage!r}")
    ant_size, time_size = mesh_shape
    a_loc = cfg.n_ants // max(ant_size, 1)
    c_loc = cfg.n_channels // max(time_size, 1)
    if fengine == "auto":
        fengine = "fused" if _split_ct(cfg.fft_size) is not None else "xla"
    if bstage == "auto":
        if corner_turn_supported(a_loc, cfg.n_pols, n_spectra, c_loc):
            bstage = "turned"
        elif _fused_b_ok(a_loc, cfg.n_pols, n_spectra, cfg.n_beams, c_loc):
            bstage = "fused"
        else:
            bstage = "planar"
    if rowed_ingest == "auto":
        rowed_ingest = fengine != "xla" and ingest_alignment(cfg.fft_size) is not None
    if cfg.n_ants % ant_size:
        raise ValueError("n_ants must divide the ant mesh axis")
    if cfg.n_channels % time_size or n_spectra % time_size:
        raise ValueError("n_channels and n_spectra must divide the time axis")
    if n_spectra // time_size < cfg.n_taps - 1:
        raise ValueError("time shards thinner than the FIR halo")
    if scatter_beams and cfg.n_beams % ant_size:
        raise ValueError("scatter_beams needs n_beams divisible by the ant axis")
    if emit_planes and (emit_visibilities or scatter_beams):
        raise ValueError("emit_planes excludes the B/X stages")
    per_dev = n_spectra // time_size
    if ici_chunks == "auto":
        ici_chunks = 1
        if ant_size * time_size > 1 and not (emit_planes or emit_visibilities):
            for k in (8, 4, 2):
                if per_dev % k:
                    continue
                s_chunk = n_spectra // k
                if bstage == "turned" and not corner_turn_supported(
                    a_loc, cfg.n_pols, s_chunk, c_loc
                ):
                    continue
                if bstage == "fused" and not _fused_b_ok(
                    a_loc, cfg.n_pols, s_chunk, cfg.n_beams, c_loc
                ):
                    continue
                ici_chunks = k
                break
    ici_chunks = int(ici_chunks)
    if ici_chunks < 1:
        raise ValueError("ici_chunks must be >= 1")
    if ici_chunks > 1 and per_dev % ici_chunks:
        raise ValueError(f"ici_chunks must divide the per-device spectra count ({per_dev})")
    if ici_chunks > 1 and (emit_planes or emit_visibilities):
        raise ValueError("ici_chunks interleaving applies to the F→B step only")
    if bstage == "fused" and not emit_planes:
        for s in {n_spectra, n_spectra // ici_chunks}:
            if not bstage_fused_supported(a_loc, cfg.n_pols, s, cfg.n_beams, c_loc):
                raise NotImplementedError(
                    f"K2 does not cover the per-shard B stage A={a_loc} P={cfg.n_pols} "
                    f"S={s} B={cfg.n_beams} C={c_loc} (bstage_fused_supported)"
                )
    return ShardedPlan(fengine, bstage, ici_chunks, bool(rowed_ingest))


class ShardedFBEngine(nn.Module):
    """F+B pipeline sharded over a 2D ``("ant", "time")`` mesh, one rank a shard.

    Parameters
    ----------
    cfg:
        System configuration. ``cfg.n_ants`` must divide by the "ant" axis
        size; ``cfg.n_channels`` and ``n_spectra`` by the "time" axis size;
        ``n_spectra // time_size ≥ cfg.n_taps − 1`` so one neighbour's halo
        suffices.
    mesh:
        ``DeviceMesh`` from :func:`~dpdk_dc_sand_tpu_torch.parallel.make_mesh`.
    fengine, bstage:
        ``"fused"`` / ``"fused_f32"`` (K1) or ``"xla"`` (the composed F:
        K6, rfft, plain fine delay and requant); ``"turned"`` (K4 + the
        folded product), ``"fused"`` (K2) or ``"planar"``; ``"auto"`` by
        :func:`resolve_sharded`.
    ici_chunks:
        Spectra sub-blocks whose corner turns and antenna reductions are
        issued asynchronously around the other chunks' B stages. Each beam
        keeps its products and its antenna sum, so the result is that of 1,
        bit for bit through K2 and through K4 + the product (the planar
        form's plain product may round a chunk's sums differently on a CPU
        BLAS). ``"auto"`` by :func:`resolve_sharded`.
    rowed_ingest:
        Accept the wire-rowed ``[A_loc, P, rows, N2]`` ADC (fused F only).
    device:
        ``None``: this rank's device on the mesh (its card, or the CPU for a
        CPU mesh). Any other device than that raises.

    The reference's TPU schedule knobs (``use_pallas``,
    ``fengine_interpret``, ``ct_batch_a``, ``fengine_rolling``,
    ``fengine_pipeline``, ``fengine_s_blk``, ``fengine_vmem_mb``,
    ``fengine_tapouter``, ``fengine_bfuse``, ``fengine_skew``,
    ``fengine_flat_out``) are Mosaic scheduling, not semantics, and have no
    counterpart here, as in the port's ``FBEngine``.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        mesh,
        n_spectra: int = 256,
        quant_scale: float = 1.0 / 16.0,
        precision: str = "f32",
        emit_visibilities: bool = False,
        scatter_beams: bool = False,
        fengine: str = "auto",
        bstage: str = "auto",
        emit_planes: bool = False,
        ici_chunks: int | str = "auto",
        rowed_ingest: bool | str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.ant_size, self.time_size = sizes["ant"], sizes["time"]
        plan = resolve_sharded(
            cfg, (self.ant_size, self.time_size), n_spectra, fengine=fengine, bstage=bstage,
            ici_chunks=ici_chunks, rowed_ingest=rowed_ingest, emit_planes=emit_planes,
            emit_visibilities=emit_visibilities, scatter_beams=scatter_beams,
        )
        self.fengine, self.bstage, self.ici_chunks, self.rowed_ingest = plan
        own = mesh_device(mesh)
        want = own if device is None else torch.device(device)
        if want != own and not (want.type == own.type == "cuda" and want.index is None):
            raise ValueError(f"device {device} is not this rank's device {own} on the mesh")
        self.device = own
        self.cfg = cfg
        self.mesh = mesh
        self.n_spectra = n_spectra
        self.quant_scale = quant_scale
        self.precision = precision
        self.emit_visibilities = emit_visibilities
        self.emit_planes = emit_planes
        self.scatter_beams = scatter_beams
        self.halo_len = (cfg.n_taps - 1) * cfg.fft_size
        self.ant_group = mesh.get_group("ant")
        self.time_group = mesh.get_group("time")
        ant_i, time_i = mesh.get_coordinate()
        self.a_loc = cfg.n_ants // self.ant_size
        self.c_loc = cfg.n_channels // self.time_size
        #: This rank's antennas and channels (the STEERING placement's slices).
        self.ants = slice(ant_i * self.a_loc, (ant_i + 1) * self.a_loc)
        self.chans = slice(time_i * self.c_loc, (time_i + 1) * self.c_loc)
        #: Global ranks of the time neighbours the halo goes to and comes from.
        self.halo_to = dist.get_global_rank(self.time_group, (time_i + 1) % self.time_size)
        self.halo_from = dist.get_global_rank(self.time_group, (time_i - 1) % self.time_size)
        self.register_buffer("window", default_window(cfg.n_taps, cfg.fft_size, self.device))
        #: This rank's steering weights in the precision's dtype — block-concat
        #: [C_loc, 2A_loc, 2B], or for bstage="planar" the stacked (cos, sin)
        #: [2, C_loc, B, A_loc] — and fine-rotation planes [A_loc, P, N2/2, N1]:
        #: content-keyed delay-update caches.
        self.register_buffer("coeff_blocks", None)
        self.register_buffer("rot_cos", None)
        self.register_buffer("rot_sin", None)
        self._coeff_key = None
        self._rot_key = None

    @property
    def samples_in(self) -> int:
        """Global ADC samples per step (history arrives via the halo)."""
        return self.n_spectra * self.cfg.fft_size

    # -- delay-update path ---------------------------------------------------

    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    def _load_planes(self, pair: torch.Tensor, key) -> None:
        """Keep this rank's block of global ``(cos, sin)`` ``[2, C, B, A]``."""
        local = pair[:, self.chans, :, self.ants].to(self._dtype())
        # The block-concat of the local slice, never a slice of the global
        # block-concat: its quadrants' rows are ``[re ants | im ants]``.
        if self.bstage == "planar":
            self.coeff_blocks = local.contiguous()
        else:
            self.coeff_blocks = steering_coeff_blockcat(local[0], local[1]).contiguous()
        self._coeff_key = key

    def set_beam_delays(self, delay_vals, ant_weights=None, t_s: float = 0.0) -> None:
        """(Re)generate this rank's steering weights from the global
        ``[B, A, 4]`` delay polynomials, with ``ant_weights`` ``[A]`` folded
        in and the rates extrapolated to ``t_s`` (the port's ``FBEngine``
        contract). Regenerated only when the values change."""
        key = steering_key(delay_vals, ant_weights, t_s)
        if self.coeff_blocks is not None and key == self._coeff_key:
            return
        cfg = self.cfg
        w = (torch.ones(cfg.n_ants, dtype=torch.float32, device=self.device)
             if ant_weights is None
             else torch.as_tensor(ant_weights, dtype=torch.float32, device=self.device))
        pair = _coeff_blocks(torch.as_tensor(delay_vals, device=self.device), w, t_s, cfg=cfg,
                             folded=False)
        self._load_planes(pair, key)

    def _fine_rot(self, frac_l, phase_l) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached rotation planes of this rank's antennas, content-keyed."""
        key = _rot_key(frac_l, phase_l)
        if self.rot_cos is None or key != self._rot_key:
            lead = (self.a_loc, self.cfg.n_pols)
            self.rot_cos, self.rot_sin = fine_rotation_planes(
                frac_l[:, None].expand(lead), phase_l[:, None].expand(lead),
                n_channels=self.cfg.n_channels, quant_scale=self.quant_scale,
            )
            self._rot_key = key
        return self.rot_cos, self.rot_sin

    # -- the step ------------------------------------------------------------

    def _halo(self, adc: torch.Tensor) -> torch.Tensor:
        """Prepend the previous time block's tail (circular over "time")."""
        if adc.ndim == 4:
            # Wire-rowed [A_loc, P, rows, N2]: the halo is whole rows (the
            # halo is a multiple of N2 for every ct geometry; a truncation
            # here would corrupt the overlap-save halo).
            if self.halo_len % adc.shape[-1]:
                raise ValueError(f"halo {self.halo_len} is not whole rows of {adc.shape[-1]}")
            tail, axis = adc[..., -(self.halo_len // adc.shape[-1]):, :], -2
        else:
            tail, axis = adc[..., -self.halo_len:], -1
        if self.time_size == 1 and dist.get_backend(self.time_group) == "gloo":
            halo = tail  # the self send's bytes; gloo refuses a send to self
        else:
            tail = tail.contiguous()
            halo = torch.empty_like(tail)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, tail, self.halo_to, group=self.time_group),
                dist.P2POp(dist.irecv, halo, self.halo_from, group=self.time_group),
            ])
            for req in reqs:
                req.wait()
        return torch.cat([halo, adc], dim=axis)

    def _f(self, ext: torch.Tensor, frac_l, phase_l) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's int8 ``(qr, qi)`` ``[A_loc, P, S_loc, C]``: the full
        band of its time slice, no channel offset and no coarse delay."""
        cfg = self.cfg
        s_loc = self.n_spectra // self.time_size
        if self.fengine == "xla":
            flat = ext.reshape(self.a_loc, cfg.n_pols, -1)
            shape = (self.a_loc, cfg.n_pols, s_loc, cfg.n_channels)
            qr, qi = (torch.empty(shape, dtype=torch.int8, device=self.device) for _ in range(2))
            zero = torch.zeros(self.a_loc, dtype=torch.int64, device=self.device)
            composed_f(flat, zero, frac_l, phase_l, self.window, qr, qi,
                       quant_scale=self.quant_scale)
            return qr, qi
        rowed = ext.ndim == 4
        frames = ext if rowed else ext.reshape(self.a_loc, cfg.n_pols, -1, cfg.fft_size)
        return fengine_fused(
            frames, self.window, None, None, n_channels=cfg.n_channels,
            quant_scale=self.quant_scale,
            dft_dtype="float32" if self.fengine == "fused_f32" else "bfloat16",
            rowed=rowed, rot_planes=self._fine_rot(frac_l, phase_l),
        )

    def _turn_start(self, qr: torch.Tensor, qi: torch.Tensor):
        """Issue the corner turn of both planes: channel blocks to the time
        ranks that own them. Returns ``(work, received)``.

        Correctness-first copies: the channel axis moves to the front
        (``[T, 2, A_loc, P, S, C_loc]``, contiguous) for the exchange, and
        :meth:`_turn_finish` copies the spectra back into order.
        """
        t = self.time_size
        a, p, s, c = qr.shape
        send = torch.empty((t, 2, a, p, s, self.c_loc), dtype=qr.dtype, device=qr.device)
        for j, q in enumerate((qr, qi)):
            send[:, j].copy_(q.reshape(a, p, s, t, self.c_loc).permute(3, 0, 1, 2, 4))
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.time_group, async_op=True)
        return work, recv

    def _turn_finish(self, turn) -> tuple[torch.Tensor, torch.Tensor]:
        """Wait for a turn; ``(ar, ai)`` ``[A_loc, P, T·S, C_loc]``, spectra
        time-rank-major as the reference's tiled ``all_to_all`` concatenates."""
        work, recv = turn
        work.wait()
        t, _, a, p, s, c = recv.shape
        return tuple(recv[:, j].permute(1, 2, 0, 3, 4).reshape(a, p, t * s, c).contiguous()
                     for j in range(2))

    def _b_stage(self, ar: torch.Tensor, ai: torch.Tensor) -> torch.Tensor:
        """Partial beams of the local antennas, ``[P, C_loc, S, B, 2]`` f32:
        ``FBEngine``'s B stage on this rank's planes and weights."""
        return _b_stage(ar, ai, self.coeff_blocks, cfg=self.cfg, precision=self.precision,
                        bstage=self.bstage)

    def _reduce_start(self, beams: torch.Tensor):
        """Issue the antenna sum: ``all_reduce``, or ``reduce_scatter_tensor``
        over the beam axis (moved to the front). Returns ``(work, out)``."""
        if not self.scatter_beams:
            return dist.all_reduce(beams, group=self.ant_group, async_op=True), beams
        by_beam = beams.movedim(3, 0).contiguous()
        out = by_beam.new_empty((by_beam.shape[0] // self.ant_size, *by_beam.shape[1:]))
        work = dist.reduce_scatter_tensor(out, by_beam, group=self.ant_group, async_op=True)
        return work, out

    def _reduce_finish(self, red) -> torch.Tensor:
        work, out = red
        work.wait()
        return out.movedim(0, 3) if self.scatter_beams else out

    def _chunked_fb(self, qr: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
        """The F→B step in ``ici_chunks`` spectra sub-blocks: chunk j+1's
        turn is issued before chunk j's B stage, each chunk's reduction is
        issued as it is ready, and all are waited on before the order
        restore. Chunking keeps channel ownership and every beam's products,
        so the result is the monolithic step's (see ``ici_chunks``)."""
        k = self.ici_chunks
        per = qr.shape[2] // k
        chunk = [slice(j * per, (j + 1) * per) for j in range(k)]
        turns = [self._turn_start(qr[:, :, chunk[0]], qi[:, :, chunk[0]])]
        reds = []
        for j in range(k):
            if j + 1 < k:
                turns.append(self._turn_start(qr[:, :, chunk[j + 1]], qi[:, :, chunk[j + 1]]))
            reds.append(self._reduce_start(self._b_stage(*self._turn_finish(turns[j]))))
        parts = [self._reduce_finish(r) for r in reds]
        # Chunk j's spectra are time-rank-major [(t, i')]; the monolithic
        # order is (t, j, i'). One stacked reshape restores it.
        p, c, _, b, two = parts[0].shape
        stacked = torch.stack([x.reshape(p, c, self.time_size, per, b, two) for x in parts],
                              dim=3)  # [P, C_loc, T, k, per, B, 2]
        return stacked.reshape(p, c, self.time_size * k * per, b, two)

    def step(self, adc, frac_delays, phases):
        """One step on this rank's shard with the cached steering weights.

        ``adc``: this rank's ``[A_loc, P, S_loc·fft]`` int8 block
        (:data:`~.ingest.ADC`) or its wire-rowed ``[A_loc, P, rows, N2]``
        view (:data:`~.ingest.ADC_ROWED`); ``frac_delays``, ``phases``: this
        rank's ``[A_loc]`` (:data:`~.ingest.ANT`). Returns this rank's
        ``[P, C_loc, S, B, 2]`` f32 beams (``B/ant`` beams with
        ``scatter_beams``); with ``emit_visibilities`` also ``(V_re, V_im)``
        ``[C_loc, I, I]``; with ``emit_planes`` only the int8 ``(re, im)``
        planes ``[A_loc, P, S, C_loc]``.
        """
        if self.coeff_blocks is None and not self.emit_planes:
            raise RuntimeError("call set_beam_delays() first")
        cfg = self.cfg
        adc = torch.as_tensor(adc, device=self.device)
        frac_l = torch.as_tensor(frac_delays, dtype=torch.float32, device=self.device)
        phase_l = torch.as_tensor(phases, dtype=torch.float32, device=self.device)
        n_loc = self.samples_in // self.time_size
        if adc.ndim == 4:
            if not self.rowed_ingest:
                raise ValueError("wire-rowed adc needs a fused direct-CT geometry "
                                 "(rowed_ingest resolved off for this engine)")
            want = (self.a_loc, cfg.n_pols, n_loc // adc.shape[-1], ingest_alignment(cfg.fft_size))
        else:
            want = (self.a_loc, cfg.n_pols, n_loc)
        if tuple(adc.shape) != want or tuple(frac_l.shape) != (self.a_loc,) or \
                tuple(phase_l.shape) != (self.a_loc,):
            raise ValueError(f"this rank's shard: adc {tuple(adc.shape)} (want {want}), "
                             f"frac/phase {tuple(frac_l.shape)}/{tuple(phase_l.shape)} "
                             f"(want ({self.a_loc},))")
        qr, qi = self._f(self._halo(adc), frac_l, phase_l)
        if self.ici_chunks > 1:
            return self._chunked_fb(qr, qi)
        ar, ai = self._turn_finish(self._turn_start(qr, qi))
        del qr, qi
        if self.emit_planes:
            return ar, ai
        beams = self._reduce_finish(self._reduce_start(self._b_stage(ar, ai)))
        if not self.emit_visibilities:
            return beams
        return (beams, *self._x_stage(ar, ai))

    def _x_stage(self, ar: torch.Tensor, ai: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Visibilities of this rank's channels over all antennas: gather
        the planes over "ant" (the all-pairs traffic), then K3 where its gate
        holds, else the reference's other route, the plain grams of the
        turned planes."""
        def gather(q):
            out = q.new_empty((self.ant_size * q.shape[0], *q.shape[1:]))
            dist.all_gather_into_tensor(out, q, group=self.ant_group)
            return out

        gr, gi = gather(ar), gather(ai)
        a, p, s, c = gr.shape
        if xcorr_fused_supported(a, p, s, c):
            return correlate_planes_fused(gr, gi)
        cr = gr.permute(3, 2, 0, 1).reshape(c, s, a * p)
        ci = gi.permute(3, 2, 0, 1).reshape(c, s, a * p)
        return correlate_planes(cr, ci, self.precision)

    def forward(self, adc, frac_delays, phases, delay_vals, ant_weights=None, t_s: float = 0.0):
        """``set_beam_delays(delay_vals, ant_weights, t_s)`` then :meth:`step`.

        ``delay_vals`` ``[B, A, 4]`` and ``ant_weights`` ``[A]`` are the
        whole array's (every rank receives the delay solution); the other
        inputs are this rank's shard, as :meth:`step` says.
        """
        if not self.emit_planes:
            self.set_beam_delays(delay_vals, ant_weights=ant_weights, t_s=t_s)
        return self.step(adc, frac_delays, phases)

    def example_inputs(self, seed: int = 2021, rowed: bool = False):
        """The reference's global numpy inputs ``(adc, frac, phase,
        delay_vals)``, drawn identically (``fbengine_sharded.py:422-445``);
        :func:`~.ingest.scatter_local` takes a rank's shard of each."""
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        adc = rng.integers(-64, 64, size=(cfg.n_ants, cfg.n_pols, self.samples_in),
                           dtype=np.int8)
        if rowed:
            n2 = ingest_alignment(cfg.fft_size)
            if n2 is None or not self.rowed_ingest:
                raise ValueError("rowed example inputs need the fused direct-CT geometry "
                                 "(rowed_ingest resolved off for this engine)")
            adc = adc.reshape(cfg.n_ants, cfg.n_pols, -1, n2)
        fd = rng.uniform(-0.5, 0.5, cfg.n_ants).astype(np.float32)
        ph = (-np.pi * fd / 2).astype(np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
        dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
        return adc, fd, ph, dv
