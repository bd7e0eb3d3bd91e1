"""Preallocated zero-copy chunk ring buffer (counterpart of ``dpdk_dc_sand_tpu/stream/ring.py``).

Python wrapper over the native SPSC ring (the port's
``native/ringbuffer.cpp``), with a pure-Python path. Semantics mirror the
reference's chunk pool: the producer acquires a slot, fills it in place,
commits with a sequence number; a full ring either back-pressures or
drops-and-counts (dpdk_send.cpp:258-272); the consumer reads in order and
releases slots for reuse (the extbuf free-callback analog).

``native=None`` takes the native ring wherever the host library loads
(:func:`~dpdk_dc_sand_tpu_torch.native.load_native`), ``True`` requires it
and ``False`` keeps the Python path. Either way the slots live in an arena
that the Python ring owns, and the native ring runs over it
(``rb_create_external``), so a slot view stays valid memory for as long as
the view lives.

``pinned=True`` makes that arena one page-locked host buffer
(``torch.empty(..., pin_memory=True)``, viewed as numpy), so a
:class:`~dpdk_dc_sand_tpu_torch.stream.feed.DeviceFeed` can copy a slot to
the card asynchronously, with no staging copy, and the native receivers
(:mod:`~dpdk_dc_sand_tpu_torch.stream.udp_native`,
:mod:`~dpdk_dc_sand_tpu_torch.stream.udp_xdp`) reassemble heaps straight
into it. Pinning needs a CUDA device: without one it raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native


class ChunkRing:
    """Single-producer single-consumer ring of fixed-size byte slots."""

    def __init__(
        self,
        n_slots: int,
        slot_bytes: int,
        native: bool | None = None,
        pinned: bool = False,
    ):
        self._lib = load_native() if native in (None, True) else None
        if native is True and self._lib is None:
            raise RuntimeError("native ring requested but no g++ to build the host library")
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
        if self._lib is not None:
            self._base = self._arena.ctypes.data
            self._ring = ctypes.c_void_p(
                self._lib.rb_create_external(n_slots, slot_bytes, self._base)
            )
            if not self._ring:
                raise MemoryError("rb_create_external failed")
            return
        self._meta = [(0, 0)] * n_slots
        self._head = 0
        self._tail = 0
        self._lock = threading.Lock()
        self._drops = 0
        self._produced = 0
        self._consumed = 0

    @property
    def native(self) -> bool:
        """Whether the ring's indices and counters are the native ring's."""
        return self._lib is not None

    def _h(self) -> ctypes.c_void_p:
        """The native ring's handle; raises once :meth:`close` freed it."""
        if not self._ring:
            raise ValueError("the ring is closed")
        return self._ring

    def _slot(self, ptr) -> np.ndarray:
        """The arena row at the native ring's slot pointer ``ptr``."""
        return self._arena[(ctypes.addressof(ptr.contents) - self._base) // self.slot_bytes]

    # ------------------------------------------------------------------
    # Producer side
    # ------------------------------------------------------------------
    def acquire_write(self) -> Optional[np.ndarray]:
        """Writable uint8 view of the next slot, or None if full."""
        if self._lib is not None:
            ptr = self._lib.rb_acquire_write(self._h())
            return self._slot(ptr) if ptr else None
        with self._lock:
            if self._head - self._tail >= self.n_slots:
                return None
            return self._arena[self._head % self.n_slots]

    def commit_write(self, nbytes: int, seq: int) -> None:
        if self._lib is not None:
            self._lib.rb_commit_write(self._h(), nbytes, seq)
            return
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
        if self._lib is not None:
            self._lib.rb_count_drop(self._h())
            return
        with self._lock:
            self._drops += 1

    # ------------------------------------------------------------------
    # Consumer side
    # ------------------------------------------------------------------
    def acquire_read(self) -> Optional[Tuple[np.ndarray, int]]:
        """(readable view, seq) of the oldest chunk, or None if empty.

        The view is valid until :meth:`release_read`: the producer may then
        overwrite the slot.
        """
        if self._lib is not None:
            n = ctypes.c_uint64()
            s = ctypes.c_uint64()
            ptr = self._lib.rb_acquire_read(self._h(), ctypes.byref(n), ctypes.byref(s))
            if not ptr:
                return None
            return self._slot(ptr)[: n.value], s.value
        with self._lock:
            if self._tail == self._head:
                return None
            idx = self._tail % self.n_slots
            nbytes, seq = self._meta[idx]
            return self._arena[idx][:nbytes], seq

    def release_read(self) -> None:
        if self._lib is not None:
            self._lib.rb_count_consumed(self._h())
            self._lib.rb_release_read(self._h())
            return
        with self._lock:
            self._tail += 1
            self._consumed += 1

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_size(self._h()))
        with self._lock:
            return self._head - self._tail

    def stats(self) -> Tuple[int, int, int]:
        """(produced, consumed, dropped)."""
        if self._lib is not None:
            p, c, d = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
            self._lib.rb_stats(self._h(), ctypes.byref(p), ctypes.byref(c), ctypes.byref(d))
            return p.value, c.value, d.value
        with self._lock:
            return self._produced, self._consumed, self._drops

    def close(self) -> None:
        """Free the native ring (the arena is freed with the Python ring).

        Stop every receiver that writes into the ring first."""
        if self._lib is not None and self._ring:
            self._lib.rb_destroy(self._ring)
            self._ring = ctypes.c_void_p()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
