"""Teaching example: vector add as a hand-written CUDA kernel (E1).

Counterpart of ``examples/vector_add_pallas.py``: allocate big vectors, add
on the card, verify on the host, report stage timings with the
:class:`~dpdk_dc_sand_tpu_torch.utils.timing.PipelineTest` harness. The
kernel is ``csrc/vector_add.cu`` behind
:func:`~dpdk_dc_sand_tpu_torch.ops.vector_add.vector_add`; with ``--cpu``
the harness runs the plain version on the CPU.

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.vector_add [n_elements] [--cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from dpdk_dc_sand_tpu_torch.ops.vector_add import vector_add
from dpdk_dc_sand_tpu_torch.utils import PipelineTest


class VectorAddTest(PipelineTest):
    """``x + y`` over ``n`` f32 elements; passes when the sum is bit-exact."""

    name = "vector-add"

    def __init__(self, n: int = 1 << 22, device=None) -> None:
        super().__init__(device)
        self.n = n

    def simulate_input(self):
        rng = np.random.default_rng(2021)
        return {
            "x": rng.normal(size=self.n).astype(np.float32),
            "y": rng.normal(size=self.n).astype(np.float32),
        }

    def run_kernel(self, device):
        return {"sum": vector_add(device["x"], device["y"])}

    def verify_output(self, host_in, host_out):
        return bool(np.array_equal(host_out["sum"], host_in["x"] + host_in["y"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1 << 22, help="elements")
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args(argv)
    times = VectorAddTest(args.n, device="cpu" if args.cpu else None).run_test(iters=3)
    print(times.report())
    return 0 if times.passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
