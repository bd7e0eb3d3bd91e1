"""Chunk metadata and stream statistics.

A Chunk is the unit of transfer between pipeline stages — the analog of a
spead2 heap / DPDK extmem chunk: payload + (sequence, ADC timestamp,
channel offset) metadata (fgpu_send_prototype.py:25-42: immediate items
for timestamp and frequency; dpdk_send.cpp:62-117: chunked payloads).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Chunk:
    """One unit of streamed data."""

    payload: np.ndarray
    seq: int
    timestamp: int = 0  # ADC sample count (SPEAD item 0x1600 analog)
    channel_offset: int = 0  # first channel carried (frequency item analog)


@dataclasses.dataclass
class StreamStats:
    """Loss/throughput accounting (ibverbs_rx.c:303-319 model)."""

    produced: int = 0
    consumed: int = 0
    dropped: int = 0  # overruns at the producer (ring full)
    lost: int = 0  # sequence gaps observed at the consumer
    malformed: int = 0  # chunks rejected at ingest (bad size/content)
    bytes: int = 0
    last_seq: int = -1

    def observe(self, seq: int, nbytes: int) -> None:
        """Consumer-side: account one received chunk."""
        if self.last_seq >= 0 and seq > self.last_seq + 1:
            self.lost += seq - self.last_seq - 1
        if seq > self.last_seq:
            self.last_seq = seq
        self.consumed += 1
        self.bytes += nbytes
