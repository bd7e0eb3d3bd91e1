"""EngineNode: a complete DSP node — ingest, compute, egress, control (counterpart of ``dpdk_dc_sand_tpu/engine_node.py``).

A per-host engine that consumes sequence-numbered sample chunks (the SPEAD
ingest contract), runs the F+B step on the card, emits beam chunks, and
fronts it all with a KATCP-style control server whose sensors expose rates
and drop counters — the reference's ``device-status`` health model
(fake_node.py:29-30) with the transport loops' rate reporting
(dpdk_recv.cpp:246-253) turned into sensors.

Data path:  producer → ChunkRing → DeviceFeed → FBEngine step → on_beams
Control:    ?delay-model / ?beam-delays / ?beam-weights / ?capture-start / ?capture-stop
Sensors:    device-status, chunks-processed, chunks-lost, ingest-rate-gbps

The ring is the native one wherever the host library builds, its slots
page-locked on the card, so the native receivers reassemble heaps straight
into the memory that the feed copies to the card on its own stream, and
the processing thread runs the step on a compute stream of its own; ``on_beams`` receives a host ndarray (a
blocking copy back of each step's beams).
"""

from __future__ import annotations

import asyncio
import contextlib
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.control.protocol import DeviceServer, FailReply
from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, Status
from dpdk_dc_sand_tpu_torch.models import FBEngine, FXBEngine, VisibilityAccumulator
from dpdk_dc_sand_tpu_torch.models._device import indexed
from dpdk_dc_sand_tpu_torch.ops.fengine_fused import ingest_alignment
from dpdk_dc_sand_tpu_torch.stream.feed import DeviceFeed
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing


class EngineNode(DeviceServer):
    """One engine host: control server + streaming F+B pipeline.

    Parameters
    ----------
    cfg:
        System configuration for the on-node pipeline.
    n_spectra:
        Spectra per chunk/step.
    margin:
        Coarse-delay history samples carried per chunk (the delay budget,
        ``delay_budget``). When the fused F kernel runs, the chunk length
        ``samples_in + margin`` is rounded up to the kernel's ingest
        alignment, so chunks are born in its wire-rowed ``[A, P, rows, N2]``
        layout; ``self.margin`` is the rounded headroom. The port's F kernel
        takes the coarse delay as a per-batch window start and needs no
        further slack.
    on_beams:
        ``callback(beams_ndarray, seq)`` for egress (UDP sender, file,
        …). Called from the processing thread.
    engine_opts:
        Extra keyword arguments forwarded verbatim to the underlying
        ``FBEngine``/``FXBEngine`` (``precision``, ``quant_scale``,
        ``fengine_native_handoff``, …); an unknown key raises ``TypeError``.
        The reference's Mosaic knobs have no counterpart here.
    device:
        ``None`` is ``cuda`` (and raises without a card: pass
        ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_spectra: int = 32,
        margin: int = 64,
        host: str = "127.0.0.1",
        port: int = 0,
        ring_slots: int = 8,
        on_beams: Optional[Callable[[np.ndarray, int], None]] = None,
        fengine: str = "auto",
        beam_quant_scale: float | None = None,
        bstage: str = "auto",
        beam_layout: str = "split",
        auth_secret: str | None = None,
        coeff_update_steps: int = 256,
        emit_visibilities: bool = False,
        vis_accum_steps: int = 16,
        on_visibilities: Optional[
            Callable[[np.ndarray, np.ndarray, int], None]
        ] = None,
        engine_opts: Optional[dict] = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__(host, port, auth_secret=auth_secret)
        self.cfg = cfg
        self.on_beams = on_beams or (lambda beams, seq: None)
        #: When set, the device requantises beams to int8 before they
        #: leave device memory (the 8-bit SPEAD beam transport format,
        #: test_parameters.py:22-25) — 4x less egress bandwidth and no
        #: host-side requantise pass.
        self.beam_quant_scale = beam_quant_scale
        self.emit_visibilities = emit_visibilities
        self.on_visibilities = on_visibilities or (lambda vr, vi, seq: None)
        if emit_visibilities:
            # Full instrument: the F stage fans out to B and X; per-step
            # visibilities integrate on the device over vis_accum_steps
            # windows (the accumulation cadence).
            if beam_layout != "split":
                # FXBEngine only emits the split [P, C, S, B, 2] beams;
                # silently ignoring the option would ship a different
                # payload layout than the caller declared to consumers.
                raise ValueError(
                    "emit_visibilities=True only supports "
                    f'beam_layout="split" (got {beam_layout!r})'
                )
            self.fb = FXBEngine(
                cfg,
                n_spectra=n_spectra,
                fengine=fengine,
                bstage=bstage,
                beam_quant_scale=beam_quant_scale,
                device=device,
                **(engine_opts or {}),
            )
            self._vis_accum = VisibilityAccumulator(vis_accum_steps)
        else:
            self.fb = FBEngine(
                cfg,
                n_spectra=n_spectra,
                fengine=fengine,
                beam_quant_scale=beam_quant_scale,
                bstage=bstage,
                beam_layout=beam_layout,
                device=device,
                **(engine_opts or {}),
            )
            self._vis_accum = None
        self.device = indexed(self.fb.device)
        #: The user's coarse-delay budget: ?delay-model coarse values are
        #: validated against it (a delay beyond the budget would be
        #: silently clamped by the kernel's window start otherwise).
        self.delay_budget = margin
        align = ingest_alignment(cfg.fft_size)
        if self.fb.fengine != "xla" and align:
            # Round the chunk up to the F kernel's ingest alignment, so the
            # chunk bytes are the kernel's wire-rowed view as they land.
            margin += -(self.fb.samples_in + margin) % align
        #: Total per-chunk headroom: delay_budget + the alignment pad.
        self.margin = margin
        self.chunk_shape = (cfg.n_ants, cfg.n_pols, self.fb.samples_in + margin)
        if self.fb.fengine != "xla" and align and self.chunk_shape[-1] % align == 0:
            self.chunk_shape = (
                cfg.n_ants,
                cfg.n_pols,
                self.chunk_shape[-1] // align,
                align,
            )
        chunk_bytes = int(np.prod(self.chunk_shape))
        # +16 headroom for the UDP receiver's timestamp/channel metadata
        # prefix (UdpReceiver._deliver) when ingest is attached over UDP.
        # The native ring (where the host library builds), its slots
        # page-locked on the card, so the feed copies them directly.
        self.ring = ChunkRing(
            ring_slots, chunk_bytes + 16, pinned=self.device.type == "cuda"
        )
        self.feed = DeviceFeed(
            self.ring,
            reshape=lambda b: b.view(np.int8).reshape(self.chunk_shape),
            device=self.device,
        )
        #: The processing thread's compute stream (on the card).
        self.stream: Optional[torch.cuda.Stream] = None

        # Delay state (updated by CAM requests, read by the pipeline).
        self._delay_lock = threading.Lock()
        self._coarse = np.zeros(cfg.n_ants, np.int32)
        self._frac = np.zeros(cfg.n_ants, np.float32)
        self._phase = np.zeros(cfg.n_ants, np.float32)
        self._delay_vals = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        self._weights_scale = np.ones(cfg.n_ants, np.float32)
        self._steer_version = 0  # bumped by beam-delays / beam-weights
        self._applied_version = -1
        #: Steering planes are re-extrapolated from the delay/phase rates
        #: every this many chunks — ACCUMULATIONS_BEFORE_NEW_COEFFS
        #: (BeamformerParameters.h:17; grouped-timestamps extrapolation,
        #: BeamformerKernels.cu:153-166). The polynomial epoch is the
        #: first chunk processed after a ?beam-delays update.
        self.coeff_update_steps = coeff_update_steps
        self._epoch_seq: Optional[int] = None
        self._coeff_seq: Optional[int] = None

        self._capturing = threading.Event()
        self._capturing.set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._bytes_window = 0
        self._t_window = time.monotonic()
        # The processing thread's own counts. The sensors take them as
        # absolute values: a sensor set from this thread lands later, on the
        # loop, so counting up from the sensor's value would lose a chunk
        # whenever two steps finish before the loop runs the first set.
        self._n_processed = 0
        self._n_lost = 0

        self.s_status = self.add_sensor(
            Sensor("device-status", "engine health", "", "discrete", "ok",
                   Status.NOMINAL)
        )
        self.s_processed = self.add_sensor(
            Sensor("chunks-processed", "pipeline steps completed", "", "integer", 0)
        )
        self.s_lost = self.add_sensor(
            Sensor("chunks-lost", "input sequence gaps", "", "integer", 0)
        )
        self.s_rate = self.add_sensor(
            Sensor("ingest-rate-gbps", "input data rate", "Gbps", "float", 0.0)
        )

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        await super().start()
        self._loop = asyncio.get_event_loop()
        self.feed.start()
        self._thread = threading.Thread(target=self._process_loop, daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if getattr(self, "_udp_rx", None) is not None:
            self._udp_rx.stop()
        if getattr(self, "_udp_tx", None) is not None:
            self._udp_tx.close()
        if getattr(self, "_udp_vis_tx", None) is not None:
            self._udp_vis_tx.close()
        self.feed.stop()
        self.ring.close()
        await super().stop()

    def _set_sensor(self, sensor: Sensor, value, status=Status.NOMINAL) -> None:
        """Thread-safe sensor update (push informs go via the loop)."""
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(sensor.set, value, status)
        else:
            sensor.set(value, status)

    def _log(self, level: str, message: str) -> None:
        """Thread-safe #log inform from the processing thread."""
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(
                self.log_inform, level, message, "engine"
            )
        else:
            self.log_inform(level, message, "engine")

    # ------------------------------------------------------------------
    # Data plane
    # ------------------------------------------------------------------
    def attach_udp_ingest(self, bind=("127.0.0.1", 0), group=None):
        """Receive ADC chunks as SPEAD heaps over UDP into the ring.

        Returns the :class:`~dpdk_dc_sand_tpu_torch.stream.udp.UdpReceiver`
        (its ``.port`` is the bound port). Heap payloads must be the
        node's chunk_shape int8 bytes; heap ids become chunk sequence
        numbers. The receiver's ring-slot metadata prefix is stripped by
        the feed reshape, so ingest wiring replaces the default reshape.
        """
        from dpdk_dc_sand_tpu_torch.stream.udp import UdpReceiver

        return self.attach_ingest(UdpReceiver(bind, self.ring, group=group).start())

    def attach_ingest(self, rx):
        """Take ``rx``, a receiver already writing heaps into ``self.ring``,
        as the node's ingest: a native
        :class:`~dpdk_dc_sand_tpu_torch.stream.udp_native.BurstUdpReceiver`
        or :class:`~dpdk_dc_sand_tpu_torch.stream.udp_xdp.XdpReceiver`
        reassembles each heap straight into the native ring (page-locked on
        the card). Heaps as for :meth:`attach_udp_ingest`; returns ``rx``,
        which the node stops with itself."""
        payload_bytes = int(np.prod(self.chunk_shape))
        self.feed.reshape = (
            lambda b: b[16 : 16 + payload_bytes]
            .view(np.int8)
            .reshape(self.chunk_shape)
        )
        self._udp_rx = rx
        return rx

    def attach_udp_egress(
        self,
        dest,
        scale: float | None = 0.25,
        wire_format: str = "lite",
        rate_gbps: float | None = None,
    ):
        """Transmit beams as int8 SPEAD heaps over UDP.

        Returns the sender; replaces ``on_beams``. When the node was built
        with ``beam_quant_scale`` the device already emits int8 beams and
        ``scale`` is ignored (payload ships as-is).
        ``wire_format="spead64"`` ships real SPEAD-64-48 packets for
        spead2 consumers (stream/spead64.py). ``rate_gbps`` paces the
        sender (:class:`~dpdk_dc_sand_tpu_torch.stream.udp.UdpSender`).
        """
        from dpdk_dc_sand_tpu_torch.stream.feed import UdpBeamEgress
        from dpdk_dc_sand_tpu_torch.stream.udp import UdpSender

        self._udp_tx = UdpSender(dest, wire_format=wire_format, rate_gbps=rate_gbps)
        samples_per_chunk = self.fb.n_spectra * self.cfg.fft_size
        if self.beam_quant_scale is not None:
            scale = None
        self.on_beams = UdpBeamEgress(self._udp_tx, samples_per_chunk, scale)
        return self._udp_tx

    def attach_udp_vis_egress(
        self, dest, wire_format: str = "lite", rate_gbps: float | None = None
    ):
        """Transmit integrated visibility dumps as SPEAD UDP heaps.

        Requires ``emit_visibilities=True``; replaces
        ``on_visibilities``. Returns the sender (paced to ``rate_gbps``).
        """
        from dpdk_dc_sand_tpu_torch.stream.feed import UdpVisEgress
        from dpdk_dc_sand_tpu_torch.stream.udp import UdpSender

        if self._vis_accum is None:
            raise RuntimeError("node was built without emit_visibilities")
        self._udp_vis_tx = UdpSender(dest, wire_format=wire_format, rate_gbps=rate_gbps)
        samples_per_chunk = self.fb.n_spectra * self.cfg.fft_size
        self.on_visibilities = UdpVisEgress(self._udp_vis_tx, samples_per_chunk)
        return self._udp_vis_tx

    def submit_chunk(self, adc: np.ndarray, seq: int) -> bool:
        """Producer entry: enqueue one ADC chunk (drop-counted when full)."""
        return self.ring.put(adc, seq)

    def _process_loop(self) -> None:
        ctx = contextlib.nullcontext()
        if self.device.type == "cuda":
            # Current device and stream are per thread: set both here.
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(self.device)
            ctx = torch.cuda.stream(self.stream)
        with ctx:
            while not self._stop.is_set():
                self._check_feed()
                try:
                    arr, seq = self.feed.get(timeout=0.1)
                except queue.Empty:
                    continue
                if not self._capturing.is_set():
                    continue
                if self._step(arr, seq):
                    self._account(seq)

    def _check_feed(self) -> None:
        """Surface a failed copy to the device as a degraded node."""
        err, self.feed.error = self.feed.error, None
        if err is not None:
            self._set_sensor(self.s_status, "degraded", Status.ERROR)
            self._log("error", f"device feed failed: {err!r}")

    def _step(self, arr, seq: int) -> bool:
        """One pipeline step on one chunk; False (node degraded) on failure."""
        with self._delay_lock:
            cd = self._coarse.copy()
            fd = self._frac.copy()
            ph = self._phase.copy()
            dv = self._delay_vals.copy()
            weights = self._weights_scale.copy()
            version = self._steer_version
        try:
            updated = version != self._applied_version
            if updated or self._epoch_seq is None:
                # New polynomials (or first chunk): epoch = now.
                self._epoch_seq = seq
            due = (
                self._coeff_seq is None
                or seq - self._coeff_seq >= self.coeff_update_steps
            )
            if updated or due:
                # Extrapolate the steering solution to this chunk's
                # timestamp via the delay/phase rates — regenerated
                # at the coefficient-reuse cadence, not per chunk.
                t_s = (
                    (seq - self._epoch_seq)
                    * self.fb.n_spectra
                    * self.cfg.fft_size
                    * self.cfg.sample_period
                )
                self.fb.set_beam_delays(dv, ant_weights=weights, t_s=t_s)
                self._applied_version = version
                self._coeff_seq = seq
            out = self.fb.step(arr, cd, fd, ph)
            if self._vis_accum is not None:
                beams, vre, vim = out
                dump = self._vis_accum.add(vre, vim, seq)
                if dump is not None:
                    dre, dim, first_seq = dump
                    self.on_visibilities(
                        dre.cpu().numpy(), dim.cpu().numpy(), first_seq
                    )
            else:
                beams = out
            self.on_beams(beams.cpu().numpy(), seq)
        except Exception as e:  # noqa: BLE001 - node must stay up
            self._set_sensor(self.s_status, "degraded", Status.ERROR)
            self._log("error", f"pipeline step failed: {e!r}")
            return False
        return True

    def _account(self, seq: int) -> None:
        """Sensors after a completed step: processed, lost, ingest rate."""
        self._n_processed += 1
        self._set_sensor(self.s_processed, self._n_processed)
        lost = self.feed.stats.lost
        if lost != self._n_lost:
            self._n_lost = lost
            self._set_sensor(self.s_lost, lost, Status.WARN)
            self._log("warn", f"input sequence gap: {lost} chunks lost")
        self._bytes_window += int(np.prod(self.chunk_shape))
        now = time.monotonic()
        dt = now - self._t_window
        if dt >= 1.0:
            self._set_sensor(
                self.s_rate, round(self._bytes_window * 8 / dt / 1e9, 4)
            )
            self._bytes_window = 0
            self._t_window = now

    # ------------------------------------------------------------------
    # Control plane
    # ------------------------------------------------------------------
    async def request_delay_model(self, conn, *args):
        """Set per-antenna delay polynomials.

        ``4·n_ants`` values: (delay_samples, frac_delay_samples, phase_rad,
        phase_rate) per antenna — the F-engine-side delay solution.
        """
        if len(args) != 4 * self.cfg.n_ants:
            raise FailReply(
                f"expected {4 * self.cfg.n_ants} values, got {len(args)}"
            )
        try:
            vals = np.asarray([float(a) for a in args], np.float64).reshape(
                self.cfg.n_ants, 4
            )
        except ValueError as e:
            raise FailReply(str(e)) from None
        if np.any(vals[:, 0] < 0) or np.any(vals[:, 0] > self.delay_budget):
            raise FailReply(
                f"coarse delay outside the node's budget "
                f"[0, {self.delay_budget}] samples"
            )
        with self._delay_lock:
            self._coarse = vals[:, 0].astype(np.int32)
            self._frac = vals[:, 1].astype(np.float32)
            self._phase = vals[:, 2].astype(np.float32)
        return ()

    async def request_beam_delays(self, conn, beam: str, *args):
        """Set one beam's steering polynomials: ``beam, 4·n_ants`` values
        (delay_s, delay_rate, phase, phase_rate per antenna — the CAM
        ``struct delay_vals`` contract)."""
        b = int(beam)
        if not 0 <= b < self.cfg.n_beams:
            raise FailReply(f"beam {b} out of range")
        if len(args) != 4 * self.cfg.n_ants:
            raise FailReply(f"expected {4 * self.cfg.n_ants} values")
        vals = np.asarray([float(a) for a in args], np.float32).reshape(
            self.cfg.n_ants, 4
        )
        with self._delay_lock:
            self._delay_vals[b] = vals
            self._steer_version += 1
        return ()

    async def request_beam_weights(self, conn, *weights):
        """Per-antenna weight magnitudes (servlet fan-out target)."""
        if len(weights) != self.cfg.n_ants:
            raise FailReply(
                f"expected {self.cfg.n_ants} weights, got {len(weights)}"
            )
        with self._delay_lock:
            self._weights_scale = np.asarray(
                [float(w) for w in weights], np.float32
            )
            self._steer_version += 1
        return ()

    async def request_capture_start(self, conn):
        self._capturing.set()
        self._set_sensor(self.s_status, "ok", Status.NOMINAL)
        return ()

    async def request_capture_stop(self, conn):
        self._capturing.clear()
        self._set_sensor(self.s_status, "idle", Status.NOMINAL)
        return ()
