"""Host↔device transfer rate test (counterpart of ``dpdk_dc_sand_tpu/characterize/transfer.py``).

Parity with the reference's ``pcieRateTest.hpp:16-61`` /
``cudaPcieRateTest``: a ring of frames, ``transfer(n_frames)`` and
``transfer_for_length_of_time(s)`` returning Gbps, directions h2d / d2h /
both. The host frames are numpy arrays in pageable memory, as in the JAX
package (which has no page-locked option either): the rate is the one a
pageable host buffer gets. ``"both"`` runs the H2D copies, then the D2H
copies, in series on the current stream, as the JAX package does, not on
the reference's two streams (cudaPcieRateTest.cpp:63-123): a pageable copy
holds the host thread until it is staged, so two streams would not overlap
them either. The window closes on a synchronise.
"""

from __future__ import annotations

import time
from typing import Literal, Optional

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch.models._device import resolve_device

Direction = Literal["h2d", "d2h", "both"]


class TransferRateTest:
    """Measure host↔device throughput with a ring of frames.

    Parameters mirror the reference defaults: 100 frames × 5 MiB
    (main.cpp:11-13). ``device`` ``None`` is the card; ``"cpu"`` measures
    host copies (for the tests).
    """

    def __init__(
        self,
        frame_bytes: int = 5 * 1024 * 1024,
        n_frames: int = 100,
        direction: Direction = "h2d",
        device: Optional[str] = None,
    ) -> None:
        if direction not in ("h2d", "d2h", "both"):
            raise ValueError(f"unknown direction {direction!r}")
        self.frame_bytes = frame_bytes
        self.n_frames = n_frames
        self.direction = direction
        self.device = resolve_device(device)
        ring = min(n_frames, 4)
        self._host_frames = [
            np.random.default_rng(i).integers(0, 255, frame_bytes, dtype=np.uint8)
            for i in range(ring)
        ]
        self._host_out = [np.empty(frame_bytes, np.uint8) for _ in range(ring)]
        self._device_frames = [torch.empty(frame_bytes, dtype=torch.uint8, device=self.device)
                               for _ in range(ring)]
        self._device_src = torch.from_numpy(self._host_frames[0]).to(self.device)

    def _h2d(self, n: int) -> None:
        for i in range(n):
            k = i % len(self._host_frames)
            self._device_frames[k].copy_(torch.from_numpy(self._host_frames[k]),
                                         non_blocking=True)

    def _d2h(self, n: int) -> None:
        for i in range(n):
            k = i % len(self._host_out)
            torch.from_numpy(self._host_out[k]).copy_(self._device_src)

    def transfer(self, n_frames: int) -> float:
        """Move ``n_frames`` each way the direction names (H2D first);
        return Gbps."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        moved = 0
        for name, run in (("h2d", self._h2d), ("d2h", self._d2h)):
            if self.direction in (name, "both"):
                run(n_frames)
                moved += n_frames * self.frame_bytes
        if cuda:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return moved * 8 / dt / 1e9

    def transfer_for_length_of_time(self, seconds: float) -> float:
        """Repeat batches until ``seconds`` elapse; return mean Gbps."""
        batch = max(1, self.n_frames // 10)
        rates = []
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            rates.append(self.transfer(batch))
        return float(np.mean(rates)) if rates else 0.0
