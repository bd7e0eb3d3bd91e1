"""Tensor ops and kernel wrappers of the port (mirrors ``dpdk_dc_sand_tpu/ops``).

Each kernel wrapper (:func:`.pfb_fir.pfb_fir_frames` K6,
:func:`.fengine_fused.fengine_fused` K1, :func:`.fengine_fused.fengine_dit` K7,
:func:`.bstage.beamform_turned_fused` K2,
:func:`.corner_turn.corner_turn_planes` K4 = K5a,
:func:`.corner_turn.corner_turn_plane_native` K8,
:func:`.xcorr.correlate_planes_fused` K3,
:func:`.xcorr.correlate_turned_fused` K5b) launches its CUDA kernel for
CUDA tensors and runs its plain PyTorch version only for CPU tensors.
:mod:`.correlate` and :mod:`.beamform` are plain products and
:mod:`.reorder` a plain permute, as in the reference.
"""
