"""Control-plane qualification on the port (features/control_plane.feature).

The scenarios of ``test_control_plane_qual.py`` over the real TCP path on
the port's ``CorrServlet``, ``FakeNode`` and ``Client``: fan-out, sensor
mirroring with renaming, and failure propagation. Every wait has a deadline
(30 s), never a wall-clock assertion.
"""

import asyncio
import time

import pytest

from dpdk_dc_sand_tpu_torch.control import Client, CorrServlet, FailReply, FakeNode, Status

N_ANTS = 4
TIMEOUT = 30.0


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 4 * TIMEOUT))
    finally:
        loop.close()


async def _until(cond):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(0.01)
    return True


async def _fleet(n_nodes=3, fail_one=False):
    nodes = [FakeNode(fail=(fail_one and i == 1)) for i in range(n_nodes)]
    for n in nodes:
        await n.start()
    servlet = CorrServlet("corr3", n_antennas=N_ANTS,
                          engine_endpoints=[("127.0.0.1", n.port) for n in nodes])
    await servlet.start()
    client = await Client("127.0.0.1", servlet.port).connect()
    return nodes, servlet, client


async def _teardown(nodes, servlet, client):
    await client.close()
    await servlet.stop()
    for n in nodes:
        await n.stop()


def test_beam_weights_reach_fleet(report):
    async def scenario():
        report.step("Given", "a servlet fronting three engine nodes")
        nodes, servlet, client = await _fleet()
        try:
            weights = [1.5] * N_ANTS
            report.step("When", "the operator sets beam weights", weights=weights)
            await client.request("beam-weights", *weights)
            received = [n.last_weights for n in nodes]
            report.step("Then", "every node receives the same weights",
                        nodes_updated=sum(bool(n.beam_weights_set) for n in nodes))
            report.detail_entry("per_node_weights", received)
            assert all(w == weights for w in received)
        finally:
            await _teardown(nodes, servlet, client)

    _run(scenario())


def test_sensor_mirroring(report):
    async def scenario():
        report.step("Given", "a servlet fronting three engine nodes")
        nodes, servlet, client = await _fleet()
        try:
            report.step("When", "a node's device-status sensor changes")
            nodes[1].device_status.set("degraded", Status.WARN)
            mirrored = servlet.sensors["node1.device-status"]
            ok = await _until(lambda: mirrored.value == "degraded")
            report.step("Then", "the servlet republishes it as nodeN.device-status",
                        mirrored_value=str(mirrored.value),
                        mirrored_status=str(mirrored.status))
            report.detail_entry("mirrored_names", sorted(
                sn.name for sn in servlet.sensors if sn.name.startswith("node1.")))
            assert ok and mirrored.value == "degraded"
        finally:
            await _teardown(nodes, servlet, client)

    _run(scenario())


def test_node_failure_surfaces(report):
    async def scenario():
        report.step("Given", "a servlet fronting three engine nodes with one failing")
        nodes, servlet, client = await _fleet(fail_one=True)
        try:
            report.step("When", "the operator sets beam weights")
            with pytest.raises(FailReply) as exc:
                await client.request("beam-weights", *([1.0] * N_ANTS))
            report.step("Then", "the request fails with the node's error",
                        error=str(exc.value)[:120])
            assert "node1" in str(exc.value)
        finally:
            await _teardown(nodes, servlet, client)

    _run(scenario())
