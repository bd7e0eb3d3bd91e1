"""Profiler hooks (counterpart of ``dpdk_dc_sand_tpu/utils/profiling.py``).

:func:`trace` wraps ``torch.profiler`` (the CPU, and the card's kernels and
copies where there is one) and writes a chrome trace; :func:`annotate`
labels a host region for ``torch.profiler`` and, on the card, for NVTX.
A profiler that refuses to start degrades to no trace: the pipeline must
keep working without profiling (the stage-timed harness in
:mod:`~dpdk_dc_sand_tpu_torch.utils.timing` is the always-available
fallback).
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str = "dcsand-trace") -> Iterator[Optional[str]]:
    """Profile the enclosed block; write ``<log_dir>/trace.json`` (chrome format).

    Yields the trace file's path, or None when the profiler refused.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except RuntimeError as e:  # profiling is best-effort
        logger.warning("profiler trace unavailable: %s", e)
        yield None
        return
    path = os.path.join(log_dir, "trace.json")
    try:
        yield path
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed host region in profiler traces (and NVTX on the card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
