"""Control & monitoring plane (counterpart of ``dpdk_dc_sand_tpu/control``).

A KATCP-style request/sensor protocol: ``?request``/``!reply``/``#inform``
lines with KATCP argument escaping, typed sensors with status, a
DeviceServer base with handler dispatch and sensor sampling, and a Client
with request futures and sensor watching; the aggregating servlet
(:class:`CorrServlet`, one control front for a fleet of engine nodes,
mirroring their sensors as ``nodeN.*``), the fake-node test double
(:class:`FakeNode`) and the servlet's launcher (``python -m
dpdk_dc_sand_tpu_torch.control.launch``).
"""

from dpdk_dc_sand_tpu_torch.control.protocol import (  # noqa: F401
    Client,
    DeviceServer,
    FailReply,
    Message,
)
from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, SensorSet, Status  # noqa: F401
from dpdk_dc_sand_tpu_torch.control.servlet import CorrServlet  # noqa: F401
from dpdk_dc_sand_tpu_torch.control.fake_node import FakeNode  # noqa: F401
