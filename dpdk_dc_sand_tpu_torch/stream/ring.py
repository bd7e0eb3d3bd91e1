"""Preallocated zero-copy chunk ring buffer (counterpart of ``dpdk_dc_sand_tpu/stream/ring.py``).

The reference's pure-Python path, with the same drop and consumed
accounting: the producer acquires a slot, fills it in place, commits with a
sequence number; a full ring either back-pressures or drops-and-counts
(dpdk_send.cpp:258-272); the consumer reads in order and releases slots for
reuse (the extbuf free-callback analog). The reference's native C++ ring
is host code and waits (ROADMAP.md).

``pinned=True`` puts all slots in one page-locked host buffer
(``torch.empty(..., pin_memory=True)``, viewed as numpy), so a
:class:`~dpdk_dc_sand_tpu_torch.stream.feed.DeviceFeed` can copy a slot to
the card asynchronously, with no staging copy. Pinning needs a CUDA
device: without one it raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np


class ChunkRing:
    """Single-producer single-consumer ring of fixed-size byte slots."""

    def __init__(self, n_slots: int, slot_bytes: int, pinned: bool = False):
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self.pinned = pinned
        if pinned:
            import torch

            # The tensor owns the page-locked memory; the arena is its view.
            self._pinned = torch.empty(
                (n_slots, slot_bytes), dtype=torch.uint8, pin_memory=True
            )
            self._arena = self._pinned.numpy()
        else:
            self._arena = np.zeros((n_slots, slot_bytes), np.uint8)
        self._meta = [(0, 0)] * n_slots
        self._head = 0
        self._tail = 0
        self._lock = threading.Lock()
        self._drops = 0
        self._produced = 0
        self._consumed = 0

    # ------------------------------------------------------------------
    # Producer side
    # ------------------------------------------------------------------
    def acquire_write(self) -> Optional[np.ndarray]:
        """Writable uint8 view of the next slot, or None if full."""
        with self._lock:
            if self._head - self._tail >= self.n_slots:
                return None
            return self._arena[self._head % self.n_slots]

    def commit_write(self, nbytes: int, seq: int) -> None:
        with self._lock:
            self._meta[self._head % self.n_slots] = (nbytes, seq)
            self._head += 1
            self._produced += 1

    def put(self, data: np.ndarray, seq: int) -> bool:
        """Copy ``data`` into the ring; False (and a counted drop) if full."""
        buf = self.acquire_write()
        flat = np.ascontiguousarray(data).view(np.uint8).ravel()
        if buf is None or flat.nbytes > self.slot_bytes:
            self.count_drop()
            return False
        buf[: flat.nbytes] = flat
        self.commit_write(flat.nbytes, seq)
        return True

    def count_drop(self) -> None:
        with self._lock:
            self._drops += 1

    # ------------------------------------------------------------------
    # Consumer side
    # ------------------------------------------------------------------
    def acquire_read(self) -> Optional[Tuple[np.ndarray, int]]:
        """(readable view, seq) of the oldest chunk, or None if empty.

        The view is valid until :meth:`release_read`.
        """
        with self._lock:
            if self._tail == self._head:
                return None
            idx = self._tail % self.n_slots
            nbytes, seq = self._meta[idx]
            return self._arena[idx][:nbytes], seq

    def release_read(self) -> None:
        with self._lock:
            self._tail += 1
            self._consumed += 1

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return self._head - self._tail

    def stats(self) -> Tuple[int, int, int]:
        """(produced, consumed, dropped)."""
        with self._lock:
            return self._produced, self._consumed, self._drops

    def close(self) -> None:
        """Kept for the reference's interface: the arena is freed with the ring."""
