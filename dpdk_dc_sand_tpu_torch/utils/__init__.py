"""Shared utilities: the stage-timed benchmarking harness and profiler hooks."""

from dpdk_dc_sand_tpu_torch.utils.timing import PipelineTest, StageTimes  # noqa: F401
from dpdk_dc_sand_tpu_torch.utils.profiling import annotate, trace  # noqa: F401
