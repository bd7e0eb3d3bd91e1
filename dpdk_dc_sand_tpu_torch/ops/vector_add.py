"""The teaching vector add (counterpart of ``examples/vector_add_pallas.py:vector_add``).

For CUDA tensors :func:`vector_add` launches the hand-written kernel
``csrc/vector_add.cu`` (E1); for CPU tensors it runs
:func:`vector_add_reference`, the plain ``x + y``. One f32 add is exactly
rounded, so the kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import torch

from dpdk_dc_sand_tpu_torch import _build


def vector_add_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of E1: ``x + y`` element by element."""
    return x + y


def vector_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for two f32 tensors of one shape (E1 on CUDA)."""
    if x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(
            f"vector_add: want two f32 tensors of one shape, got {tuple(x.shape)} "
            f"{x.dtype} and {tuple(y.shape)} {y.dtype}"
        )
    if x.device != y.device:
        raise ValueError(f"vector_add: operands on {x.device} and {y.device}")
    if x.device.type == "cuda":
        if not (x.is_contiguous() and y.is_contiguous()):
            raise ValueError("vector_add: operands must be contiguous")
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out  # nothing to launch
        if any(t.data_ptr() % 16 for t in (x, y, out)):
            raise ValueError("vector_add: operands must be 16-byte aligned")
        lib = _build.library()
        err = lib.vector_add_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(lib, err, "vector_add")
        vector_add.launches += 1
        return out
    if x.device.type == "cpu":
        return vector_add_reference(x, y)
    raise ValueError(f"vector_add: unsupported device {x.device}")


#: Kernel launches since the last reset (the plain CPU version never counts).
vector_add.launches = 0
