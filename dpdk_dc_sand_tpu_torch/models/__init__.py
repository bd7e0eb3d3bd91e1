"""Signal-chain models of the port (mirrors ``dpdk_dc_sand_tpu/models``)."""

from dpdk_dc_sand_tpu_torch.models.bengine import BeamformPipeline  # noqa: F401
from dpdk_dc_sand_tpu_torch.models.fbengine import FBEngine  # noqa: F401
from dpdk_dc_sand_tpu_torch.models.fengine import FEngine  # noqa: F401
from dpdk_dc_sand_tpu_torch.models.fxbengine import FXBEngine  # noqa: F401
from dpdk_dc_sand_tpu_torch.models.xengine import (  # noqa: F401
    VisibilityAccumulator,
    XEngine,
)
