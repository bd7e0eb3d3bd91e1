"""The port's aggregating servlet and fake node vs the JAX package's.

Ports the servlet cases of ``tests/test_control.py`` to the port's classes
(fan-out, validation, failure propagation, the delay-model fan-out,
transient retry, a hung node's timeout and degrade, sensor mirroring,
``#interface-changed`` and the shared secret on both faces), holds the wire
across the packages (the port's ``CorrServlet`` fronting JAX ``FakeNode``s
and the JAX ``CorrServlet`` fronting port ``FakeNode``s give the replies and
mirrored sensors of the JAX servlet fronting JAX nodes, exactly), and
drives the port's servlet in front of two port ``EngineNode``s on the CPU:
beams after a fanned-out update equal ``fb.step`` with that state, bit for
bit.

Every wait has its own deadline (30 s), never a wall-clock assertion, and
every server and client is closed in a ``finally``.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.control import CorrServlet as JCorrServlet
from dpdk_dc_sand_tpu.control import FakeNode as JFakeNode
from dpdk_dc_sand_tpu_torch import ArrayConfig
from dpdk_dc_sand_tpu_torch.control import (
    Client,
    CorrServlet,
    FailReply,
    FakeNode,
    Status,
)
from dpdk_dc_sand_tpu_torch.control import launch
from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

N_ANTS = 4
TIMEOUT = 30.0


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 4 * TIMEOUT))
    finally:
        loop.close()


async def until(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


class Fleet:
    """``n`` fake nodes (``node_kw(i)`` each) behind one servlet, and a client."""

    def __init__(self, n=3, node_kw=lambda i: {}, servlet_cls=CorrServlet,
                 node_cls=FakeNode, secret=None, **servlet_kw):
        self.nodes = [node_cls(**node_kw(i)) for i in range(n)]
        self.servlet_cls, self.secret, self.servlet_kw = servlet_cls, secret, servlet_kw
        self.servlet = self.client = None

    async def __aenter__(self):
        for node in self.nodes:
            await node.start()
        self.servlet = self.servlet_cls(
            "corr3", n_antennas=N_ANTS, auth_secret=self.secret,
            engine_endpoints=[("127.0.0.1", n.port) for n in self.nodes], **self.servlet_kw)
        await self.servlet.start()
        self.client = await Client("127.0.0.1", self.servlet.port,
                                   auth_secret=self.secret).connect()
        return self

    async def __aexit__(self, *exc):
        if self.client is not None:
            await self.client.close()
        if self.servlet is not None:
            await self.servlet.stop()
        for node in self.nodes:
            await node.stop()


def fake_kw(secret):
    return lambda i: {} if secret is None else {"auth_secret": secret}


class SecretFakeNode(FakeNode):
    """A port fake node that takes the shared secret (the reference's FakeNode
    has no such argument; its DeviceServer base does)."""

    def __init__(self, auth_secret=None, **kw):
        super().__init__(**kw)
        self._auth_secret = auth_secret


def test_beam_weights_fan_out():
    async def scenario():
        async with Fleet() as f:
            await f.client.request("beam-weights", *([1.5] * N_ANTS))
            assert all(n.beam_weights_set for n in f.nodes)
            assert f.nodes[0].last_weights == [1.5] * N_ANTS
            assert f.servlet.sensors["device-status"].value == "ok"

    run(scenario())


def test_beam_weights_are_validated_before_the_fan_out():
    async def scenario():
        async with Fleet() as f:
            with pytest.raises(FailReply, match="expected 4 weights"):
                await f.client.request("beam-weights", 1.0, 2.0)
            with pytest.raises(FailReply, match="non-numeric"):
                await f.client.request("beam-weights", "a", "b", "c", "d")
            assert not any(n.beam_weights_set for n in f.nodes)

    run(scenario())


def test_node_failure_propagates_and_degrades():
    async def scenario():
        async with Fleet(node_kw=lambda i: {"fail": i == 1}) as f:
            with pytest.raises(FailReply, match="node1: injected failure"):
                await f.client.request("beam-weights", *([1.0] * N_ANTS))
            # The healthy nodes keep the update; the servlet says so.
            assert f.nodes[0].beam_weights_set and f.nodes[2].beam_weights_set
            status = f.servlet.sensors["device-status"]
            assert (status.value, status.status) == ("degraded", Status.WARN)

    run(scenario())


def test_delay_model_fans_out_in_groups_of_four():
    async def scenario():
        async with Fleet() as f:
            vals = [1e-9, 0.0, 0.5, 0.0] * N_ANTS
            await f.client.request("delay-model", *vals)
            assert all(n.last_delay_model == pytest.approx(vals) for n in f.nodes)
            with pytest.raises(FailReply, match="groups of 4"):
                await f.client.request("delay-model", 1.0, 2.0, 3.0)

    run(scenario())


def test_transient_node_failure_is_retried():
    async def scenario():
        async with Fleet(node_kw=lambda i: {"fail_times": 1 if i == 1 else 0},
                         request_retries=1) as f:
            await f.client.request("beam-weights", *([2.0] * N_ANTS))
            assert all(n.beam_weights_set for n in f.nodes)
            assert f.nodes[1].fail_times == 0
            assert f.servlet.sensors["device-status"].value == "ok"

    run(scenario())


def test_hung_node_times_out_degrades_and_recovers():
    async def scenario():
        async with Fleet(node_kw=lambda i: {"hang_s": 0.5 if i == 1 else 0.0},
                         request_timeout=0.1, request_retries=0) as f:
            with pytest.raises(FailReply, match="node1: timeout"):
                await f.client.request("beam-weights", *([3.0] * N_ANTS))
            assert f.nodes[0].beam_weights_set and f.nodes[2].beam_weights_set
            assert not f.nodes[1].beam_weights_set
            assert f.servlet.sensors["device-status"].value == "degraded"
            f.nodes[1].hang_s = 0.0
            # The hung handler finishes its sleep and applies its request.
            await until(lambda: f.nodes[1].beam_weights_set, "the hung handler to drain")
            await f.client.request("beam-weights", *([4.0] * N_ANTS))
            assert f.servlet.sensors["device-status"].value == "ok"
            assert f.nodes[1].last_weights == [4.0] * N_ANTS

    run(scenario())


def test_sensors_are_mirrored_with_status_and_timestamp():
    async def scenario():
        async with Fleet() as f:
            assert "node0.device-status" in f.servlet.sensors
            assert "node2.ingest-rate" in f.servlet.sensors
            f.nodes[1].device_status.set("degraded", Status.WARN)
            mirrored = f.servlet.sensors["node1.device-status"]
            await until(lambda: mirrored.value == "degraded", "the mirrored sensor")
            assert mirrored.status == Status.WARN
            assert mirrored.timestamp == pytest.approx(
                f.nodes[1].device_status.timestamp, abs=1e-3)
            t1 = mirrored.timestamp
            f.nodes[1].device_status.set("ok", Status.NOMINAL)
            await until(lambda: mirrored.value == "ok", "the second update")
            assert mirrored.timestamp >= t1
            _, informs = await f.client.request("sensor-value", "node1.device-status")
            assert informs[0].args[2:5] == ["node1.device-status", "nominal", "ok"]

    run(scenario())


def test_interface_changed_reaches_connected_clients():
    async def scenario():
        async with Fleet(n=1) as f:
            seen = []
            f.client.on_inform(seen.append)
            f.servlet.mass_inform("interface-changed", "sensor-list")
            await until(lambda: any(m.name == "interface-changed" for m in seen),
                        "#interface-changed")

    run(scenario())


def test_shared_secret_covers_both_faces():
    """The servlet challenges its clients with the secret and answers its
    nodes' challenges with the same secret."""

    async def scenario():
        async with Fleet(node_cls=SecretFakeNode, node_kw=fake_kw("s3cret"),
                         secret="s3cret") as f:
            await f.client.request("beam-weights", *([1.25] * N_ANTS))
            assert all(n.last_weights == [1.25] * N_ANTS for n in f.nodes)
            bare = await Client("127.0.0.1", f.servlet.port).connect()
            try:
                with pytest.raises(FailReply, match="unauthorized"):
                    await bare.request("beam-weights", *([1.0] * N_ANTS))
            finally:
                await bare.close()
            with pytest.raises(FailReply):
                await Client("127.0.0.1", f.servlet.port, auth_secret="wrong").connect()
        # A servlet without the nodes' secret cannot front them.
        nodes = [SecretFakeNode(auth_secret="s3cret")]
        await nodes[0].start()
        servlet = CorrServlet("corr3", N_ANTS, engine_endpoints=[("127.0.0.1", nodes[0].port)])
        try:
            with pytest.raises(FailReply):
                await servlet.start()
        finally:
            await servlet.stop()
            await nodes[0].stop()

    run(scenario())


async def _transcript(servlet_cls, node_cls):
    """What a CAM client sees from a servlet fronting three nodes, node 1
    failing its first request: replies, failures, mirrored sensors."""
    out = []
    async with Fleet(servlet_cls=servlet_cls, node_cls=node_cls, request_retries=0,
                     node_kw=lambda i: {"fail_times": 1 if i == 1 else 0}) as f:
        for req in (("beam-weights", *([1.5] * N_ANTS)), ("beam-weights", 1.0),
                    ("beam-weights", "a", "b", "c", "d"), ("delay-model", 1.0, 2.0),
                    ("beam-weights", *([2.5] * N_ANTS)),
                    ("delay-model", *([1e-9, 0.0, 0.5, 0.0] * N_ANTS))):
            try:
                args, informs = await f.client.request(*req)
                out.append(("ok", args, [m.args for m in informs]))
            except FailReply as e:
                out.append(("fail", str(e)))
        out.append([(n.last_weights, n.last_delay_model) for n in f.nodes])
        f.nodes[2].device_status.set("degraded", Status.WARN)
        mirrored = f.servlet.sensors["node2.device-status"]
        await until(lambda: mirrored.value == "degraded", "the mirrored sensor")
        _, informs = await f.client.request("sensor-list")
        out.append(sorted(m.args for m in informs))
        for name in ("device-status", "node0.device-status", "node2.device-status",
                     "node1.ingest-rate"):
            _, informs = await f.client.request("sensor-value", name)
            out.append(informs[0].args[2:])  # name, status, value (no timestamp)
    return out


@pytest.mark.parametrize(
    "servlet_cls, node_cls",
    [(CorrServlet, JFakeNode), (JCorrServlet, FakeNode), (CorrServlet, FakeNode)],
    ids=["port-servlet-jax-nodes", "jax-servlet-port-nodes", "port-servlet-port-nodes"],
)
def test_wire_parity_across_the_packages(servlet_cls, node_cls):
    want = run(_transcript(JCorrServlet, JFakeNode))
    got = run(_transcript(servlet_cls, node_cls))
    assert got == want
    assert want[0][0] == "fail" and "node1" in want[0][1]  # the transient failure
    assert want[4][0] == "ok"


def test_launcher_parses_endpoints_and_its_help():
    assert launch.parse_endpoint("10.0.0.2:7147") == ("10.0.0.2", 7147)
    assert launch.parse_endpoint(":7147") == ("127.0.0.1", 7147)
    with pytest.raises(SystemExit) as exc:
        launch.main(["--help"])
    assert exc.value.code == 0


# ----------------------------------------------------------------------
# The port's servlet in front of two port engine nodes, on the CPU
# ----------------------------------------------------------------------
CFG = ArrayConfig(n_ants=2, n_channels=128, n_beams=2, n_taps=4)


def test_servlet_fronting_two_engine_nodes_on_the_cpu():
    torch.cos(torch.linspace(0, 1, 1 << 16))  # MKL's first vector cos (PERF.md §7)

    async def scenario():
        beams = [{}, {}]
        nodes = [EngineNode(CFG, n_spectra=8, beam_quant_scale=0.25, device="cpu",
                            on_beams=lambda b, s, i=i: beams[i].__setitem__(s, b))
                 for i in range(2)]
        servlet = client = None
        try:
            for node in nodes:
                await node.start()
            servlet = CorrServlet("corr3", CFG.n_ants, request_timeout=TIMEOUT,
                                  engine_endpoints=[("127.0.0.1", n.port) for n in nodes])
            await servlet.start()
            client = await Client("127.0.0.1", servlet.port).connect()
            chunk = np.random.default_rng(5).integers(-64, 64, nodes[0].chunk_shape,
                                                      dtype=np.int8)

            async def step(seq):
                for node in nodes:
                    assert node.submit_chunk(chunk, seq)
                await until(lambda: all(seq in b for b in beams), f"chunk {seq}'s beams")
                return [b[seq] for b in beams]

            def fb_step(node):
                return node.fb.step(torch.from_numpy(chunk).view(node.chunk_shape),
                                    node._coarse, node._frac, node._phase).numpy()

            before = await step(0)
            dm = np.array([[3, 0.25, -0.3, 0.0], [17, -0.4, 0.6, 0.0]])
            weights = [0.5, 1.25]
            await client.request("delay-model", *dm.ravel())
            await client.request("beam-weights", *weights)
            after = await step(1)
            for node, b0, b1 in zip(nodes, before, after):
                np.testing.assert_array_equal(node._coarse, dm[:, 0].astype(np.int32))
                np.testing.assert_array_equal(node._weights_scale, np.float32(weights))
                np.testing.assert_array_equal(b1, fb_step(node))
                assert b1.dtype == np.int8 and not np.array_equal(b1, b0)
            # A coarse delay past the budget fails on both nodes and changes nothing.
            bad = dm.copy()
            bad[1, 0] = nodes[0].delay_budget + 1
            with pytest.raises(FailReply, match="node0: .*budget.*node1: .*budget"):
                await client.request("delay-model", *bad.ravel())
            status = servlet.sensors["device-status"]
            assert (status.value, status.status) == ("degraded", Status.WARN)
            for node, b in zip(nodes, await step(2)):
                np.testing.assert_array_equal(b, fb_step(node))
                np.testing.assert_array_equal(b, after[nodes.index(node)])
            # The mirrored node sensors equal each node's own.
            for i, node in enumerate(nodes):
                for name in ("chunks-processed", "chunks-lost", "device-status"):
                    own = node.sensors[name]
                    mirrored = servlet.sensors[f"node{i}.{name}"]
                    await until(lambda: mirrored.format_value() == own.format_value(),
                                f"node{i}.{name}")
                    _, informs = await client.request("sensor-value", f"node{i}.{name}")
                    assert informs[0].args[3:5] == [own.status.value, own.format_value()]
                assert node.sensors["chunks-processed"].value == 3
        finally:
            if client is not None:
                await client.close()
            if servlet is not None:
                await servlet.stop()
            for node in nodes:
                await node.stop()

    run(scenario())
