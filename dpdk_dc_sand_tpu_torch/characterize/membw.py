"""Host RAM bandwidth sweep (counterpart of ``dpdk_dc_sand_tpu/characterize/membw.py``).

Parity with the reference's memRateTest (``utilities/pcie_bandwidth_tests/
memRateTest.{hpp,cpp}`` + ``main.cpp:193-246``): N threads each scanning a
private buffer, swept over a thread range, CSV-style rows out. The scan is
the JAX package's numpy scan; numpy's fill and sum release the interpreter
lock, so the N threads scan at once. The native scan comes with the host
library (ROADMAP §1).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, List, Tuple

import numpy as np


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


def mem_rate(
    n_threads: int,
    bytes_per_thread: int = 256 * 1024 * 1024,
    seconds: float = 0.5,
    mode: str = "write",
) -> float:
    """Aggregate bandwidth of ``n_threads`` scanning threads, bytes/s."""
    if mode not in ("write", "read"):
        raise ValueError(f"unknown mode {mode!r}")
    m = 0 if mode == "write" else 1
    results = [None] * n_threads

    def work(i):
        results[i] = _numpy_scan(bytes_per_thread, seconds, m)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(b for b, _ in results) / max(s for _, s in results)


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
