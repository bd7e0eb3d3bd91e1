"""Async device feed, rate reporting and UDP egress (counterpart of ``dpdk_dc_sand_tpu/stream/feed.py``).

Replaces the reference's NIC→GPU ingest path with host→card: a producer
fills a :class:`ChunkRing`, a feeder thread moves committed chunks onto the
card keeping a small prefetch queue, and the pipeline consumes device
tensors — double-buffered like the reference's chunk reuse gating
(dpdk_send.cpp:248-267) and spead2 frame futures
(fgpu_send_prototype.py:101-109). Rates are reported every interval as the
transport loops do (dpdk_recv.cpp:246-253).

On the card the copy goes straight from the ring slot (page-locked when
the ring was built with ``pinned=True``) with ``non_blocking=True`` on the
feed's own CUDA stream, so it overlaps the compute stream's work. The slot
is released only once that copy's event has completed: released earlier,
the producer would overwrite bytes still in flight.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch.golden.requant import requantise
from dpdk_dc_sand_tpu_torch.models._device import indexed, resolve_device
from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk, StreamStats
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing

logger = logging.getLogger(__name__)


class RateReporter:
    """Per-interval packet/byte rate reporting (dpdk_recv.cpp:199-253)."""

    def __init__(
        self,
        interval_s: float = 1.0,
        sink: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.interval_s = interval_s
        self.sink = sink or (lambda line: print(line, flush=True))
        self.clock = clock
        self._t0 = clock()
        self._chunks = 0
        self._bytes = 0

    def account(self, nbytes: int) -> None:
        self._chunks += 1
        self._bytes += nbytes
        now = self.clock()
        dt = now - self._t0
        if dt >= self.interval_s:
            self.sink(
                f"rate: {self._chunks / dt:.1f} chunks/s, "
                f"{self._bytes * 8 / dt / 1e9:.3f} Gbps"
            )
            self._t0 = now
            self._chunks = 0
            self._bytes = 0


class DeviceFeed:
    """Ring → device prefetcher with sequence-gap loss accounting.

    Parameters
    ----------
    ring:
        Source ring (producer side owned by the caller).
    reshape:
        Optional callable turning a raw uint8 payload view into the typed
        array to put on the device (e.g.
        ``lambda b: b.view(np.int8).reshape(shape)``). The view is only
        borrowed: on the card it is copied from in place, on the CPU copied
        out of the slot.
    depth:
        Device-side prefetch depth (2 = classic double buffering).
    device:
        ``None`` is ``cuda`` (and raises without a card: pass
        ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        ring: ChunkRing,
        reshape: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        depth: int = 2,
        reporter: Optional[RateReporter] = None,
        device: torch.device | str | None = None,
    ) -> None:
        self.ring = ring
        self.reshape = reshape or (lambda b: b)
        self.depth = depth
        self.reporter = reporter
        self.device = indexed(resolve_device(device))
        self.stats = StreamStats()
        #: ``(bytes, ms)`` of the recent copies to the card, each timed with
        #: CUDA events on the feed's copy stream.
        self.h2d_log: collections.deque = collections.deque(maxlen=256)
        #: Copies to the card made straight from page-locked slots.
        self.pinned_copies = 0
        #: The last failure of a copy to the device (the feed keeps running).
        self.error: Optional[BaseException] = None
        #: The feed thread's copy stream (on the card, once started).
        self.stream: Optional[torch.cuda.Stream] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeviceFeed":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _to_card(self, host: np.ndarray, stream):
        """Copy one slot's bytes to the card on ``stream``; returns when the
        copy is complete, so the caller may release the slot."""
        src = torch.from_numpy(host)  # the slot itself: no host copy
        if src.is_pinned():
            self.pinned_copies += 1
        t0 = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True, blocking=True)
        with torch.cuda.stream(stream):
            t0.record(stream)
            arr = src.to(self.device, non_blocking=True)
            done.record(stream)
        done.synchronize()
        self.h2d_log.append((host.nbytes, t0.elapsed_time(done)))
        return arr, done

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # current device is per thread
            self.stream = torch.cuda.Stream(self.device)
        stream = self.stream
        while not self._stop.is_set():
            item = self.ring.acquire_read()
            if item is None:
                time.sleep(50e-6)  # idle wait (epoll analog, dpdk_recv.cpp:230-244)
                continue
            view, seq = item
            try:
                host = self.reshape(view)
            except Exception:  # noqa: BLE001 - malformed chunk must not
                # kill the feed thread: a wrong-sized or corrupt chunk is
                # a data-plane fault to ACCOUNT (the drop-counter
                # discipline, ibverbs_rx.c:303-319), not a crash. The
                # slot is released and the stream continues.
                self.stats.malformed += 1
                self.ring.release_read()
                continue
            done = None
            try:
                if stream is not None:
                    arr, done = self._to_card(host, stream)
                else:
                    arr = torch.from_numpy(np.array(host))  # copy out of the slot
            except Exception as e:  # noqa: BLE001 - the feed must stay up
                logger.exception("device feed: copy of chunk %d failed", seq)
                self.error = e
                self.ring.release_read()
                continue
            self.ring.release_read()
            self.stats.observe(seq, host.nbytes)
            if self.reporter is not None:
                self.reporter.account(host.nbytes)
            while not self._stop.is_set():
                try:
                    self._q.put((arr, done, seq), timeout=0.05)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: Optional[float] = None):
        """Next ``(device_tensor, seq)``; blocks up to ``timeout``.

        On the card the calling thread's current stream waits on the copy
        and the tensor is recorded on that stream, so its memory is not
        reused while the consumer's work still reads it.
        """
        arr, done, seq = self._q.get(timeout=timeout)
        if done is not None:
            consumer = torch.cuda.current_stream(arr.device)
            consumer.wait_event(done)
            arr.record_stream(consumer)
        return arr, seq

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class UdpBeamEgress:
    """Beam-output egress: requantise-and-packetize onto a UDP sender.

    The F/B-engine transmit side of the reference (beam output send, L4;
    fgpu_send_prototype.py's double-buffered heap pattern): plug an
    instance into :class:`~dpdk_dc_sand_tpu_torch.engine_node.EngineNode` as
    ``on_beams``. Beams are scaled to int8 transport format and shipped
    as one SPEAD-lite heap per step with the step's ADC timestamp.
    """

    def __init__(
        self, sender, samples_per_chunk: int, scale: float | None = 0.25
    ):
        self.sender = sender
        self.samples_per_chunk = samples_per_chunk
        #: Host-side requantisation gain; ``None`` means the beams arrive
        #: already int8 (device-side ``FBEngine(beam_quant_scale=…)``) and
        #: ship as-is — no extra host pass over the payload.
        self.scale = scale

    def __call__(self, beams: np.ndarray, seq: int) -> None:
        if self.scale is None:
            if beams.dtype != np.int8:
                raise TypeError(
                    "scale=None expects device-quantised int8 beams, got "
                    f"{beams.dtype}"
                )
            payload = beams.ravel()
        else:
            payload = requantise(beams, self.scale).ravel()
        self.sender.send_chunk(
            Chunk(
                payload.view(np.uint8),
                seq=seq,
                timestamp=seq * self.samples_per_chunk,
            )
        )


class UdpVisEgress:
    """Visibility-dump egress: integrated f32 visibilities onto UDP.

    The X-engine transmit side: plug into
    :class:`~dpdk_dc_sand_tpu_torch.engine_node.EngineNode` as
    ``on_visibilities``. Each integrated window ships as one SPEAD-lite
    heap — payload ``[C, I, I, 2]`` float32 (re, im stacked trailing),
    heap id = the window's first chunk sequence number, timestamp = that
    chunk's first ADC sample (the SPEAD 0x1600 convention).
    """

    def __init__(self, sender, samples_per_chunk: int):
        self.sender = sender
        self.samples_per_chunk = samples_per_chunk

    def __call__(
        self, vis_re: np.ndarray, vis_im: np.ndarray, first_seq: int
    ) -> None:
        payload = np.ascontiguousarray(
            np.stack([vis_re, vis_im], axis=-1), dtype="<f4"
        ).ravel()
        self.sender.send_chunk(
            Chunk(
                payload.view(np.uint8),
                seq=first_seq,
                timestamp=first_seq * self.samples_per_chunk,
            )
        )
