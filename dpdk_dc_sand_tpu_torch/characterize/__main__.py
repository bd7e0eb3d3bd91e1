"""Characterisation CLI (counterpart of ``dpdk_dc_sand_tpu/characterize/__main__.py``).

Sweeps host-RAM threads and host↔device transfer directions, optionally
concurrently (the reference runs the RAM sweep and per-GPU PCIe tests in
parallel OpenMP sections to measure bus contention, main.cpp:193-226),
printing CSV rows.

Usage::

    python -m dpdk_dc_sand_tpu_torch.characterize -s -d -m 1 -M 2 -t 0.3 [-c] [--device cpu]
"""

from __future__ import annotations

import argparse
import threading

from dpdk_dc_sand_tpu_torch.characterize.membw import mem_rate
from dpdk_dc_sand_tpu_torch.characterize.transfer import TransferRateTest


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-s", action="store_true", help="test host→device (h2d)")
    p.add_argument("-d", action="store_true", help="test device→host (d2h)")
    p.add_argument("-b", action="store_true", help="test bidirectional")
    p.add_argument("-m", type=int, default=1, help="min RAM threads")
    p.add_argument("-M", type=int, default=2, help="max RAM threads")
    p.add_argument("-t", type=float, default=0.3, help="seconds per point")
    p.add_argument(
        "-c",
        action="store_true",
        help="run RAM scan concurrently with transfers (contention test)",
    )
    p.add_argument("--frame-mb", type=float, default=5.0, help="transfer frame size (MiB)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the card (default) or the CPU")
    args = p.parse_args(argv)

    directions = [
        d for d, on in (("h2d", args.s), ("d2h", args.d), ("both", args.b)) if on
    ] or ["h2d"]
    tests = [TransferRateTest(frame_bytes=int(args.frame_mb * 1024 * 1024), direction=d,
                              device=args.device) for d in directions]

    print("threads,mem_write_GBps,mem_read_GBps," + ",".join(f"{d}_Gbps" for d in directions))
    for threads in range(args.m, args.M + 1):
        ram = {}

        def ram_work():
            ram["w"] = mem_rate(threads, seconds=args.t, mode="write") / 1e9
            ram["r"] = mem_rate(threads, seconds=args.t, mode="read") / 1e9

        if args.c:
            t = threading.Thread(target=ram_work)
            t.start()
            rates = [test.transfer_for_length_of_time(args.t) for test in tests]
            t.join()
        else:
            ram_work()
            rates = [test.transfer_for_length_of_time(args.t) for test in tests]
        row = [str(threads), f"{ram['w']:.2f}", f"{ram['r']:.2f}"] + [f"{r:.2f}" for r in rates]
        print(",".join(row))


if __name__ == "__main__":
    main()
