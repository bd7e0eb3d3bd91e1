"""Tensor ops and kernel wrappers of the port (mirrors ``dpdk_dc_sand_tpu/ops``).

Each kernel wrapper (:func:`.fengine_fused.fengine_fused`,
:func:`.bstage.beamform_turned_fused`) launches its CUDA kernel for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.
"""
