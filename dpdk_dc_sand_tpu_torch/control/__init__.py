"""Control & monitoring plane (counterpart of ``dpdk_dc_sand_tpu/control``).

A KATCP-style request/sensor protocol: ``?request``/``!reply``/``#inform``
lines with KATCP argument escaping, typed sensors with status, a
DeviceServer base with handler dispatch and sensor sampling, and a Client
with request futures and sensor watching. The reference's aggregating
servlet, fake node and launcher wait (ROADMAP.md).
"""

from dpdk_dc_sand_tpu_torch.control.protocol import (  # noqa: F401
    Client,
    DeviceServer,
    FailReply,
    Message,
)
from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, SensorSet, Status  # noqa: F401
