"""dpdk_dc_sand_tpu_torch — the F+B and F+X+B signal chains on PyTorch + CUDA (Hopper).

A port of :mod:`dpdk_dc_sand_tpu` (the JAX/Pallas reference, which stays
beside it unchanged) to PyTorch on one NVIDIA H100. The layout mirrors the
reference so each counterpart is easy to find:

- :mod:`.ops`: plain tensor ops (requant, delay, steering coefficients,
  reorder, correlate, the beamform forms) and the kernel wrappers —
  :mod:`.ops.pfb_fir` (K6:
  polyphase FIR, under the composed PFB of :mod:`.ops.pfb`),
  :mod:`.ops.fengine_fused` (K1: FIR + two-stage Cooley–Tukey rDFT + fine
  delay + int8 requant; K7: its decimation-in-time form), :mod:`.ops.bstage` (K2: corner turn + multi-beam
  dot), :mod:`.ops.corner_turn` (K4 = K5a: int8 corner turn; K8: the
  native handoff's turn of one plane) and
  :mod:`.ops.xcorr` (K3, K5b: int8 visibility grams).
- :mod:`.csrc`: the hand-written CUDA C++ kernels for ``sm_90a``, built
  with ``nvcc`` at first use by :mod:`._build` and bound with ctypes.
- :mod:`.models`: :class:`~.models.fengine.FEngine`, the standalone
  F-engine (composed: K6, cuFFT, fine delay, requant);
  :class:`~.models.fbengine.FBEngine`, the flagship F+B step (every B
  form of the reference); :class:`~.models.fxbengine.FXBEngine`, F feeding both B and X;
  :class:`~.models.bengine.BeamformPipeline`, the reference-layout B-engine;
  :class:`~.models.xengine.XEngine` and
  :class:`~.models.xengine.VisibilityAccumulator`.
- :mod:`.config`: :class:`ArrayConfig` and :class:`DelayModel`.
- :mod:`.convert`: loads the reference engine's state into the port.

The package imports ``torch`` and numpy, never ``jax`` and nothing of the
reference package, so it runs on a machine that has neither.
"""

__version__ = "0.1.0"

from dpdk_dc_sand_tpu_torch.config import ArrayConfig, DelayModel  # noqa: F401


def __getattr__(name):
    # The engines, without importing torch-heavy modules at package import.
    if name in ("BeamformPipeline", "FEngine", "FBEngine", "FXBEngine", "XEngine",
                "VisibilityAccumulator"):
        from dpdk_dc_sand_tpu_torch import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
