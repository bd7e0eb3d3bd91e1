"""The chained 2-vs-6 marginal time of one call (the method of ``bench.py:91-147``
and ``benchmarks/ct_ablate.py:170-198`` in the JAX package).

Two and then six back-to-back calls run on one stream; each call feeds a
one-element data dependence into the next (its first output element, times
zero, added to the first element of its input, as the reference adds a
vanishing probe of the outputs), so no call can start before the one ahead
of it. After a warm-up of two calls, each count runs twice and keeps its
minimum; ``(t6 - t2) / 4`` is the time of one call with the fixed costs of a
run (the launch queue filling, the final synchronise) taken out.

On the card the runs are timed with CUDA events; on CPU tensors with
``time.perf_counter``, so that the tests can run it.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _feed(out, into: torch.Tensor) -> None:
    first = out[0] if isinstance(out, (tuple, list)) else out
    into.view(-1)[:1].add_((first.reshape(-1)[:1] * 0).to(into.dtype))


def _run_ms(call: Callable[[], object], into: torch.Tensor, n: int) -> float:
    if into.device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            _feed(call(), into)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)
    t = time.perf_counter()
    for _ in range(n):
        _feed(call(), into)
    return (time.perf_counter() - t) * 1e3


def marginal_ms(call: Callable[[], object], into: torch.Tensor) -> tuple[float, float]:
    """``(per_call_ms, warm_up_ms)``: the marginal time of ``call()`` and the
    time of the warm-up's two calls (which build the kernels at first use).

    ``into`` is the contiguous input tensor ``call`` reads, which each call's
    first output element feeds.
    """
    if not into.is_contiguous():
        raise ValueError("marginal_ms: the fed input must be contiguous")
    warm = _run_ms(call, into, 2)
    t2 = t6 = float("inf")
    for _ in range(2):
        t2 = min(t2, _run_ms(call, into, 2))
        t6 = min(t6, _run_ms(call, into, 6))
    return max((t6 - t2) / 4, 1e-6), warm
