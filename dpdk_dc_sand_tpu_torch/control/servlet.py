"""Aggregating correlator servlet — the Corr3Servlet analog (counterpart of ``dpdk_dc_sand_tpu/control/servlet.py``).

Behavioural parity with ``ngkcs/ngkcs/corr3_servlet.py``: one control
server fronts N engine nodes; requests like ``?beam-weights`` are
validated locally then fanned out to every node (corr3_servlet.py:140-153);
every downstream sensor is mirrored upward renamed ``nodeN.<name>`` with
batched ``#interface-changed`` notifications (corr3_servlet.py:14-64).
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Sequence, Tuple

from dpdk_dc_sand_tpu_torch.control.protocol import (
    Client,
    DeviceServer,
    FailReply,
    Message,
)
from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, Status

logger = logging.getLogger(__name__)


class SensorMirror:
    """Watch one node's sensors and republish them with a prefix.

    The aiokatcp ``SensorWatcher`` analog (corr3_servlet.py:14-64):
    subscribes to every downstream sensor with auto sampling, registers a
    renamed copy on the servlet, keeps value/status/timestamp in sync, and
    batches add/remove bursts into a single ``#interface-changed`` inform.
    """

    def __init__(self, servlet: "CorrServlet", client: Client, prefix: str):
        self.servlet = servlet
        self.client = client
        self.prefix = prefix
        client.on_inform(self._on_inform)

    async def sync(self) -> None:
        """Initial sensor sync: list, register, subscribe."""
        _, informs = await self.client.request("sensor-list")
        added = 0
        for inform in informs:
            if inform.name != "sensor-list":
                continue
            name, desc, units, stype = (inform.args + ["", "", "", "string"])[:4]
            self.servlet.add_sensor(
                Sensor(f"{self.prefix}.{name}", desc, units, stype or "string")
            )
            added += 1
            await self.client.request("sensor-sampling", name, "auto")
        if added:
            self.servlet.mass_inform("interface-changed", "sensor-list")

    def _on_inform(self, msg: Message) -> None:
        if msg.name != "sensor-status" or len(msg.args) < 5:
            return
        ts, _count, name, status, value = msg.args[:5]
        full = f"{self.prefix}.{name}"
        if full in self.servlet.sensors:
            self.servlet.sensors[full].set(
                value, Status(status), timestamp=float(ts)
            )


class CorrServlet(DeviceServer):
    """Control front for a fleet of engine nodes.

    Parameters
    ----------
    name:
        Instrument name.
    n_antennas:
        Array size, used to validate ``?beam-weights``
        (corr3_servlet.py:142-143).
    engine_endpoints:
        ``[(host, port), …]`` of the engine nodes to front.
    request_timeout:
        Per-node fan-out deadline in seconds (a hung engine must not
        wedge the whole instrument's control path).
    request_retries:
        Transparent re-sends per node after a timeout or failure before
        the fan-out reports the node as failed.
    """

    def __init__(
        self,
        name: str,
        n_antennas: int,
        host: str = "127.0.0.1",
        port: int = 0,
        engine_endpoints: Sequence[Tuple[str, int]] = (),
        request_timeout: float = 5.0,
        request_retries: int = 1,
        auth_secret: "str | None" = None,
    ) -> None:
        # One shared secret covers both faces: the servlet's own server
        # challenges CAM clients, and the servlet authenticates to the
        # engine nodes it fronts (which run with the same secret).
        super().__init__(host, port, auth_secret=auth_secret)
        self._auth = auth_secret
        self.name = name
        self.n_antennas = n_antennas
        self.request_timeout = request_timeout
        self.request_retries = request_retries
        self.engine_endpoints = list(engine_endpoints)
        self.engine_clients: List[Client] = []
        self.mirrors: List[SensorMirror] = []
        self.add_sensor(
            Sensor(
                "device-status",
                "overall servlet health",
                "",
                "discrete",
                initial="ok",
                status=Status.NOMINAL,
            )
        )

    async def start(self) -> None:
        await super().start()
        for i, (host, port) in enumerate(self.engine_endpoints):
            client = await Client(host, port, auth_secret=self._auth).connect()
            self.engine_clients.append(client)
            mirror = SensorMirror(self, client, prefix=f"node{i}")
            self.mirrors.append(mirror)
            await mirror.sync()

    async def stop(self) -> None:
        for c in self.engine_clients:
            await c.close()
        await super().stop()

    # ------------------------------------------------------------------
    async def _fanout(self, name: str, *args) -> None:
        """Send a request to every node with per-node timeout + retry.

        The reference fan-out is a bare ``asyncio.gather`` whose first
        node error aborts the request with no deadline
        (corr3_servlet.py:146-148); production control paths need a hung
        engine bounded by ``request_timeout`` and transient failures
        retried. Any node still failing is reported in one ``FailReply``
        (all healthy nodes keep the update — the partial-application
        state is visible through the mirrored sensors) and the servlet's
        ``device-status`` sensor degrades.
        """

        async def one(i: int, client: Client) -> str | None:
            last = "unreachable"
            for _ in range(self.request_retries + 1):
                try:
                    await asyncio.wait_for(
                        client.request(name, *args), self.request_timeout
                    )
                    return None
                except asyncio.TimeoutError:
                    last = "timeout"
                except Exception as e:  # FailReply / connection errors
                    last = str(e) or type(e).__name__
            logger.warning("node%d %s failed: %s", i, name, last)
            return f"node{i}: {last}"

        failures = [
            f
            for f in await asyncio.gather(
                *(one(i, c) for i, c in enumerate(self.engine_clients))
            )
            if f is not None
        ]
        status = self.sensors["device-status"]
        if failures:
            status.set("degraded", Status.WARN)
            raise FailReply(f"{name} failed on {', '.join(failures)}")
        status.set("ok", Status.NOMINAL)

    async def request_beam_weights(self, conn, *weights):
        """Set per-antenna beam weights on every engine node.

        Validated against ``n_antennas`` then fanned out
        (corr3_servlet.py:140-153).
        """
        if len(weights) != self.n_antennas:
            raise FailReply(
                f"expected {self.n_antennas} weights, got {len(weights)}"
            )
        try:
            [float(w) for w in weights]
        except ValueError as e:
            raise FailReply(f"non-numeric weight: {e}") from None
        await self._fanout("beam-weights", *weights)
        return ()

    async def request_delay_model(self, conn, *args):
        """Fan a delay-polynomial update out to every engine node.

        The CAM-side entry point for ``struct delay_vals`` updates
        (BeamformerParameters.h:53-66).
        """
        if len(args) % 4:
            raise FailReply("delay model must be groups of 4 values per antenna")
        await self._fanout("delay-model", *args)
        return ()
