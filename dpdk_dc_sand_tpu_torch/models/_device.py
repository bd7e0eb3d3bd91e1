"""Where an engine runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means ``cuda``; without a CUDA device that raises, naming
    ``device="cpu"``, rather than building the engine on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engines run on the card by default; pass "
            'device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def indexed(device: torch.device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card. A
    worker thread's current device is its own, so a thread that launches
    work sets it from this."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
