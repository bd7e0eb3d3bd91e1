"""The port's control plane (KATCP-style codec, server, client, sensors) vs
the JAX package's.

The codec is held byte for byte (tolerance 0: ``Message.encode`` of the
same message gives the same bytes, ``decode`` the same fields, ``escape``
the same strings). Server/client round-trips run over real TCP on
localhost, port client against port server and across the packages in
both directions. Every request carries the client's own timeout and every
server and client is closed in a ``finally``.
"""

import asyncio

import numpy as np
import pytest

from dpdk_dc_sand_tpu.control import protocol as j_protocol
from dpdk_dc_sand_tpu.control import sensors as j_sensors
from dpdk_dc_sand_tpu_torch import __version__
from dpdk_dc_sand_tpu_torch.control import (
    Client,
    DeviceServer,
    FailReply,
    Message,
    Sensor,
    SensorSet,
    Status,
)
from dpdk_dc_sand_tpu_torch.control.protocol import escape, unescape

STRINGS = ["plain", "with space", "new\nline", "tabs\t", "", "back\\slash", "cr\rnul\0",
           "mixed \\_ \t\n end", "ünïcode ok"]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 60))
    finally:
        loop.close()


@pytest.mark.parametrize("s", STRINGS)
def test_escape_matches_reference(s):
    assert escape(s) == j_protocol.escape(s)
    assert unescape(escape(s)) == s == j_protocol.unescape(escape(s))


@pytest.mark.parametrize(
    "mtype, name, args, mid",
    [("?", "beam-weights", ["1.0", "two words"], 7), ("!", "delay-model", ["ok"], None),
     ("#", "sensor-status", ["1.5", "1", "temp", "warn", "21.0"], 3),
     ("?", "help", [], None), ("!", "boom", ["fail", "bad\nthing", ""], 12)],
)
def test_message_bytes_match_reference(mtype, name, args, mid):
    port = Message(mtype, name, *args, mid=mid)
    ref = j_protocol.Message(mtype, name, *args, mid=mid)
    assert port.encode() == ref.encode()
    back, jback = Message.decode(port.encode()), j_protocol.Message.decode(ref.encode())
    assert (back.mtype, back.name, back.args, back.mid) == (
        jback.mtype, jback.name, jback.args, jback.mid) == (mtype, name, args, mid)


@pytest.mark.parametrize("line", [b"not a message\n", b"\n", b"?9bad\n", b"!ok[x]\n"])
def test_garbage_decodes_as_in_reference(line):
    assert (Message.decode(line) is None) == (j_protocol.Message.decode(line) is None)


def test_sensors_match_reference():
    for stype, value in [("integer", 3), ("float", 2.5), ("boolean", True), ("string", "x y"),
                         ("discrete", "ok")]:
        port = Sensor("s", "desc", "u", stype, value, Status.WARN)
        ref = j_sensors.Sensor("s", "desc", "u", stype, value, j_sensors.Status.WARN)
        assert port.format_value() == ref.format_value()
        assert port.status.value == ref.status.value
        seen = []
        port.observe(seen.append)
        port.set(value, Status.ERROR, timestamp=5.0)
        assert seen == [port] and port.timestamp == 5.0
    with pytest.raises(ValueError):
        Sensor("bad", stype="complex")
    events = []
    ss = SensorSet()
    ss.on_change(lambda what, s: events.append((what, s.name)))
    ss.add(Sensor("a"))
    assert "a" in ss and len(ss) == 1 and ss["a"].name == "a"
    ss.remove("a")
    assert events == [("added", "a"), ("removed", "a")]
    assert [s.value for s in Status] == [s.value for s in j_sensors.Status]


class EchoServer(DeviceServer):
    async def request_echo(self, conn, *args):
        """Echo the arguments."""
        return args

    async def request_boom(self, conn):
        raise FailReply("kaboom")


class JEchoServer(j_protocol.DeviceServer):
    async def request_echo(self, conn, *args):
        return args


def test_server_client_round_trip():
    async def scenario():
        srv = EchoServer()
        temp = srv.add_sensor(Sensor("temp", "temperature", "degC", "float", 20.5))
        await srv.start()
        client = await Client("127.0.0.1", srv.port).connect()
        try:
            args, _ = await client.request("echo", "a", "b c", "")
            assert args == ["a", "b c", ""]
            with pytest.raises(FailReply, match="kaboom"):
                await client.request("boom")
            with pytest.raises(FailReply):
                await client.request("nonexistent")
            await client.request("watchdog")
            args, informs = await client.request("sensor-list")
            assert args == ["1"] and informs[0].args[:2] == ["temp", "temperature"]
            _, informs = await client.request("sensor-value", "temp")
            assert informs[0].args[2:5] == ["temp", "unknown", "20.5"]
            pushed = []
            client.on_inform(pushed.append)
            await client.request("sensor-sampling", "temp", "auto")
            temp.set(21.0, Status.WARN)
            for _ in range(100):
                if any(m.args[2:5] == ["temp", "warn", "21.0"] for m in pushed):
                    break
                await asyncio.sleep(0.02)
            assert any(m.args[2:5] == ["temp", "warn", "21.0"] for m in pushed)
            assert (await client.request("log-level", "error"))[0] == ["error"]
            srv.log_inform("warn", "hidden")
            srv.log_inform("error", "shown", "engine")
            for _ in range(100):
                if any(m.name == "log" for m in pushed):
                    break
                await asyncio.sleep(0.02)
            logs = [m.args for m in pushed if m.name == "log"]
            assert [(a[0], a[2], a[3]) for a in logs] == [("error", "engine", "shown")]
            _, informs = await client.request("help", "echo")
            assert informs[0].args == ["echo", "Echo the arguments."]
            _, informs = await client.request("version-list")
            assert informs[0].args == ["dpdk-dc-sand-tpu-torch", __version__]
        finally:
            await client.close()
            await srv.stop()

    run(scenario())


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_round_trip_across_the_packages(direction):
    async def scenario():
        srv = JEchoServer() if direction == "port_client_jax_server" else EchoServer()
        client_cls = Client if direction == "port_client_jax_server" else j_protocol.Client
        await srv.start()
        client = await client_cls("127.0.0.1", srv.port).connect()
        try:
            words = [" ".join(STRINGS[:3]), "x", str(np.float32(0.1))]
            args, _ = await client.request("echo", *words)
            assert args == words
            _, informs = await client.request("help")
            assert "echo" in [m.args[0] for m in informs]
        finally:
            await client.close()
            await srv.stop()

    run(scenario())


def test_auth_challenge_gates_requests():
    async def scenario():
        server = DeviceServer(port=0, auth_secret="s3cret")
        await server.start()
        bare = Client("127.0.0.1", server.port)
        try:
            good = await Client("127.0.0.1", server.port, auth_secret="s3cret").connect()
            await good.request("watchdog")
            await good.close()
            await bare.connect()
            with pytest.raises(FailReply, match="unauthorized"):
                await bare.request("watchdog")
            with pytest.raises(FailReply, match="bad credentials"):
                await bare.request("auth", "0" * 64)
            with pytest.raises(FailReply):
                await Client("127.0.0.1", server.port, auth_secret="wrong").connect()
        finally:
            await bare.close()
            await server.stop()

    run(scenario())
