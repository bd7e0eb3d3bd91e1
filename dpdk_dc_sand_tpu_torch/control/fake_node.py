"""Fake engine node — the multi-node test double (counterpart of ``dpdk_dc_sand_tpu/control/fake_node.py``).

Behavioural parity with ``ngkcs/testing/fake_node.py``: a DeviceServer
with a ``?beam-weights`` handler that records the call and a mutable
``device-status`` sensor, letting servlet tests drive the real TCP path
against N in-process nodes (test_corr3_servlet.py:14-50 pattern).
"""

from __future__ import annotations

from typing import List, Optional

from dpdk_dc_sand_tpu_torch.control.protocol import DeviceServer, FailReply
from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, Status


class FakeNode(DeviceServer):
    """Fault-injection knobs: ``fail`` always FailReplies, ``fail_times``
    FailReplies the first N requests then recovers (retry testing), and
    ``hang_s`` delays every reply (timeout testing)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        fail: bool = False,
        fail_times: int = 0,
        hang_s: float = 0.0,
    ):
        super().__init__(host, port)
        self.fail = fail
        self.fail_times = fail_times
        self.hang_s = hang_s
        self.beam_weights_set = False
        self.last_weights: Optional[List[float]] = None
        self.last_delay_model: Optional[List[float]] = None
        self.device_status = self.add_sensor(
            Sensor(
                "device-status",
                "engine health",
                "",
                "discrete",
                initial="ok",
                status=Status.NOMINAL,
            )
        )
        self.add_sensor(
            Sensor("ingest-rate", "input data rate", "Gbps", "float", 0.0)
        )

    async def _inject(self) -> None:
        if self.hang_s:
            import asyncio

            await asyncio.sleep(self.hang_s)
        if self.fail:
            raise FailReply("injected failure")
        if self.fail_times > 0:
            self.fail_times -= 1
            raise FailReply("injected transient failure")

    async def request_beam_weights(self, conn, *weights):
        await self._inject()
        self.last_weights = [float(w) for w in weights]
        self.beam_weights_set = True
        return ()

    async def request_delay_model(self, conn, *args):
        await self._inject()
        self.last_delay_model = [float(a) for a in args]
        return ()
