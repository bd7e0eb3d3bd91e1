"""Stage-timed benchmark harness (counterpart of ``dpdk_dc_sand_tpu/utils/timing.py``).

The reference's C++ ``UnitTest`` template method runs simulate_input →
(event-timed) transfer_HtoD → run_kernel → transfer_DtoH → verify_output
and reports per-stage times, names the limiting bus, and computes the
kernel/PCIe utilisation ratio (common/UnitTest.cpp:28-112). Subclass
:class:`PipelineTest`, implement the same five hooks, and ``run_test()``
produces a :class:`StageTimes` report.

Timing: on the card the h2d, kernel and d2h stages are timed with CUDA
events on the current stream, each after one warm-up call of the stage, so
build and first-launch costs are excluded; on the CPU with
``time.perf_counter``. ``iters > 1`` averages the kernel stage over that
many calls. simulate_input and verify_output are host work and always
take ``perf_counter``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch.models._device import resolve_device


@dataclasses.dataclass
class StageTimes:
    """Per-stage times in ms + verdict (UnitTest.cpp:77-112 report)."""

    simulate_ms: float
    h2d_ms: float
    kernel_ms: float
    d2h_ms: float
    verify_ms: float
    passed: Optional[bool]

    @property
    def limiting_stage(self) -> str:
        stages = {
            "h2d": self.h2d_ms,
            "kernel": self.kernel_ms,
            "d2h": self.d2h_ms,
        }
        return max(stages, key=stages.get)

    @property
    def kernel_transfer_ratio(self) -> float:
        """>1 means compute-bound; <1 means the host link dominates."""
        transfer = max(self.h2d_ms + self.d2h_ms, 1e-9)
        return self.kernel_ms / transfer

    def report(self) -> str:
        lines = [
            f"simulate_input : {self.simulate_ms:10.3f} ms",
            f"transfer_h2d   : {self.h2d_ms:10.3f} ms",
            f"run_kernel     : {self.kernel_ms:10.3f} ms",
            f"transfer_d2h   : {self.d2h_ms:10.3f} ms",
            f"verify_output  : {self.verify_ms:10.3f} ms",
            f"limiting stage : {self.limiting_stage}",
            f"kernel/transfer: {self.kernel_transfer_ratio:.2f}",
            f"result         : "
            + {True: "PASS", False: "FAIL", None: "NOT-RUN"}[self.passed],
        ]
        return "\n".join(lines)


class PipelineTest:
    """Template-method benchmark: override the five hooks.

    - :meth:`simulate_input` → host arrays (dict)
    - :meth:`transfer_h2d` → device tensors (dict)
    - :meth:`run_kernel` → device outputs (dict)
    - :meth:`transfer_d2h` → host outputs (dict)
    - :meth:`verify_output` → bool

    ``device``: ``None`` is ``cuda`` (and raises without a card: pass
    ``device="cpu"`` for the CPU).
    """

    name = "pipeline-test"

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)

    def simulate_input(self) -> Dict:
        raise NotImplementedError

    def transfer_h2d(self, host: Dict) -> Dict:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in host.items()
        }

    def run_kernel(self, device: Dict) -> Dict:
        raise NotImplementedError

    def transfer_d2h(self, outputs: Dict) -> Dict:
        return {k: v.cpu().numpy() for k, v in outputs.items()}

    def verify_output(self, host_in: Dict, host_out: Dict) -> Optional[bool]:
        return None

    # ------------------------------------------------------------------
    def _timed(self, fn: Callable[[], object], iters: int = 1):
        """(result of the last call, mean ms a call): CUDA events on the card,
        ``perf_counter`` on the CPU."""
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                out = fn()
            t1.record()
            t1.synchronize()
            return out, t0.elapsed_time(t1) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / iters

    def run_test(self, iters: int = 1, verify: bool = True) -> StageTimes:
        t0 = time.perf_counter()
        host_in = self.simulate_input()
        t_sim = (time.perf_counter() - t0) * 1e3

        self.transfer_h2d(host_in)  # warm-up
        device, t_h2d = self._timed(lambda: self.transfer_h2d(host_in))

        self.run_kernel(device)  # warm-up: the build and first launch
        out, t_kernel = self._timed(lambda: self.run_kernel(device), iters)

        self.transfer_d2h(out)  # warm-up
        host_out, t_d2h = self._timed(lambda: self.transfer_d2h(out))

        t0 = time.perf_counter()
        passed = self.verify_output(host_in, host_out) if verify else None
        t_verify = (time.perf_counter() - t0) * 1e3

        return StageTimes(
            simulate_ms=t_sim,
            h2d_ms=t_h2d,
            kernel_ms=t_kernel,
            d2h_ms=t_d2h,
            verify_ms=t_verify,
            passed=passed,
        )
