"""Host RAM bandwidth sweep (counterpart of ``dpdk_dc_sand_tpu/characterize/membw.py``).

Parity with the reference's memRateTest (``utilities/pcie_bandwidth_tests/
memRateTest.{hpp,cpp}`` + ``main.cpp:193-246``): N threads each scanning a
private buffer, swept over a thread range, CSV-style rows out. The scan
loops live in the host library (``membw_scan``, the port's
``native/membw.cpp``) so the compiler can't elide them — the role the
reference's hand-written AVX asm plays (memRateTest_asm.h:37-113). Where
there is no g++, the scan is numpy's: its fill and sum release the
interpreter lock, so the N threads scan at once.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, List, Tuple

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native


def _numpy_scan(bytes_per_thread: int, seconds: float, mode: int) -> tuple[int, float]:
    """Write (mode 0) or read (mode 1) a private buffer for ``seconds``:
    ``(bytes moved, elapsed s)``."""
    buf = np.ones(bytes_per_thread // 8, np.uint64)
    total = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if mode == 0:
            buf[:] = 1
        else:
            _ = buf.sum()
        total += buf.nbytes
    return total, time.perf_counter() - t0


def _numpy_rate(n_threads: int, bytes_per_thread: int, seconds: float, mode: int) -> float:
    """Aggregate bytes/s of ``n_threads`` threads each running
    :func:`_numpy_scan` (mode 0 write, 1 read)."""
    results = [None] * n_threads

    def work(i):
        results[i] = _numpy_scan(bytes_per_thread, seconds, mode)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(b for b, _ in results) / max(s for _, s in results)


def mem_rate(
    n_threads: int,
    bytes_per_thread: int = 256 * 1024 * 1024,
    seconds: float = 0.5,
    mode: str = "write",
) -> float:
    """Aggregate bandwidth of ``n_threads`` scanning threads, bytes/s: the
    host library's ``membw_scan`` where it loads, else numpy threads."""
    if mode not in ("write", "read"):
        raise ValueError(f"unknown mode {mode!r}")
    m = 0 if mode == "write" else 1
    lib = load_native()
    if lib is None:
        return _numpy_rate(n_threads, bytes_per_thread, seconds, m)
    rate = lib.membw_scan(n_threads, bytes_per_thread, seconds, m)
    if rate <= 0:
        raise ValueError(
            f"membw_scan({n_threads}, {bytes_per_thread}, {seconds}, {m}) failed: "
            "needs >= 4096 bytes a thread and the memory to allocate them"
        )
    return rate


def mem_rate_sweep(
    thread_range: Iterable[int] = (1, 2, 4),
    bytes_per_thread: int = 128 * 1024 * 1024,
    seconds: float = 0.3,
) -> List[Tuple[int, float, float]]:
    """Sweep threads → ``[(threads, write_GBps, read_GBps), …]``."""
    rows = []
    for t in thread_range:
        w = mem_rate(t, bytes_per_thread, seconds, "write") / 1e9
        r = mem_rate(t, bytes_per_thread, seconds, "read") / 1e9
        rows.append((t, w, r))
    return rows


def main() -> None:
    print("threads,write_GBps,read_GBps")
    for t, w, r in mem_rate_sweep():
        print(f"{t},{w:.2f},{r:.2f}")


if __name__ == "__main__":
    main()
