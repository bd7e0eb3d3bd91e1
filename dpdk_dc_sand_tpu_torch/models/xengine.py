"""X-engine: visibility integration over accumulation windows (counterpart of ``dpdk_dc_sand_tpu/models/xengine.py``).

The running sums live on the device of the visibilities they integrate and
are updated in place with ``add_``; nothing goes to the host between dumps.
"""

from __future__ import annotations

import numpy as np
import torch

from dpdk_dc_sand_tpu_torch.config import ArrayConfig
from dpdk_dc_sand_tpu_torch.models._device import resolve_device
from dpdk_dc_sand_tpu_torch.ops.correlate import correlate_accumulate


class XEngine:
    """Visibility accumulator for one engine's channel slice.

    ``n_accum`` time blocks are integrated per output dump (the
    reference's 256-accumulation cadence); inputs = ``n_ants · n_pols``.
    The samples are moved onto ``device`` (``None`` is ``cuda``; pass
    ``device="cpu"`` for the CPU) and integrated there.
    """

    def __init__(
        self,
        cfg: ArrayConfig,
        n_accum: int = 256,
        precision: str = "f32",
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.n_accum = n_accum
        self.n_inputs = cfg.n_ants * cfg.n_pols
        self.precision = precision
        self.device = resolve_device(device)

    def integrate(self, samples) -> tuple[torch.Tensor, torch.Tensor]:
        """Integrate one window ``[n_accum, chan, time_per_block, n_inputs, 2]``.

        Returns ``(V_re, V_im)`` ``[chan, n_inputs, n_inputs]`` f32, the
        blocks' visibilities summed in block order.
        """
        samples = torch.as_tensor(samples, device=self.device)
        _, n_chan, _, n_inputs, _ = samples.shape
        acc = tuple(
            torch.zeros((n_chan, n_inputs, n_inputs), dtype=torch.float32, device=samples.device)
            for _ in range(2)
        )
        for block in samples:
            correlate_accumulate(block, *acc, precision=self.precision)
        return acc

    def example_inputs(self, n_chan: int = 16, t_block: int = 16, seed: int = 2021):
        rng = np.random.default_rng(seed)
        return rng.integers(
            -64, 64, size=(self.n_accum, n_chan, t_block, self.n_inputs, 2), dtype=np.int8
        )


class VisibilityAccumulator:
    """Cross-step visibility integration with device-resident state.

    Feed one step's voltages (:meth:`add_samples`) or visibilities
    (:meth:`add`) at a time; every ``n_accum`` steps it returns the
    integrated dump and starts a new window.
    """

    def __init__(self, n_accum: int, precision: str = "f32"):
        self.n_accum = n_accum
        self.precision = precision
        self._acc: tuple[torch.Tensor, torch.Tensor] | None = None
        self._count = 0
        self._first_seq: int | None = None

    @property
    def count(self) -> int:
        """Steps integrated into the current window."""
        return self._count

    def _start(self, shape, device, seq) -> None:
        if self._acc is None:
            self._acc = tuple(
                torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(2)
            )
        if self._count == 0:
            self._first_seq = seq

    def _finish(self):
        self._count += 1
        if self._count < self.n_accum:
            return None
        dump = (*self._acc, self._first_seq)
        self._acc = None  # the next window gets fresh sums; the dump keeps these
        self._count = 0
        return dump

    def add(self, vis_re, vis_im, seq: int | None = None):
        """Fold one step's visibilities in; return a dump when complete.

        Returns ``None`` mid-window, else ``(V_re, V_im, first_seq)`` with
        the window's integrated f32 visibilities and the sequence number of
        its first step (``None`` when seqs were never supplied).
        """
        vis_re, vis_im = torch.as_tensor(vis_re), torch.as_tensor(vis_im)
        self._start(vis_re.shape, vis_re.device, seq)
        self._acc[0].add_(vis_re)
        self._acc[1].add_(vis_im)
        return self._finish()

    def add_samples(self, samples, seq: int | None = None):
        """Correlate one step's ``[chan, time, n_inputs, 2]`` voltages and fold them in."""
        samples = torch.as_tensor(samples)
        n_chan, _, n_inputs, _ = samples.shape
        self._start((n_chan, n_inputs, n_inputs), samples.device, seq)
        correlate_accumulate(samples, *self._acc, precision=self.precision)
        return self._finish()

