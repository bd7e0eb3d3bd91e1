"""Dry run of the sharded engine on N ranks.

Usage::

    python -m dpdk_dc_sand_tpu_torch.parallel --nproc N            # N cards, NCCL
    python -m dpdk_dc_sand_tpu_torch.parallel --nproc N --device cpu  # N CPU ranks, gloo

Prints each rank's mesh, resolved backends and (rank 0) the largest
difference against the single-device ``FBEngine``; exits non-zero if any
rank fails.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, required=True, help="ranks (one card each on CUDA)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from dpdk_dc_sand_tpu_torch.parallel.launch import dryrun_multichip

    for rank, rep in enumerate(dryrun_multichip(args.nproc, device_type=args.device)):
        err = "" if rep["max_abs_err"] is None else f" max|d| vs FBEngine {rep['max_abs_err']:.3e}"
        print(f"rank {rank}: {rep['backend']} mesh {rep['shape']} plan {rep['plan']}{err}")
    print(f"dryrun_multichip({args.nproc}) ok")


if __name__ == "__main__":
    main()
