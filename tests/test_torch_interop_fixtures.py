"""The port's wire codecs vs the frozen bytes of ``tests/fixtures/interop_golden.json``.

``tests/test_interop_fixtures.py`` holds the JAX package's SPEAD-64-48 and
KATCP codecs to these bytes; this file holds the port's to the same bytes,
with no JAX in the loop (tolerance 0): every ``spead64`` case's packets, the
stream-stop packet, the frozen packets through the port's receive path, and
each frozen KATCP line decoded and encoded again.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from dpdk_dc_sand_tpu_torch.control.protocol import Message
from dpdk_dc_sand_tpu_torch.stream.spead64 import (
    Heap64Assembler,
    packetize64,
    parse_packet64,
    stream_stop_packet,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "interop_golden.json")
with open(FIXTURE) as _f:
    GOLDEN = json.load(_f)
CASES = {case["name"]: case for case in GOLDEN["spead64"]}


def _payload(size: int) -> np.ndarray:
    return (np.arange(size, dtype=np.int64) % 251).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spead64_packets_equal_the_frozen_bytes(name):
    case = CASES[name]
    pkts = packetize64(_payload(case["payload_size"]), case["heap_cnt"],
                       timestamp=case["timestamp"], channel_offset=case["channel_offset"],
                       mtu_payload=case["mtu_payload"])
    assert [p.hex() for p in pkts] == case["packets_hex"]


def test_spead64_stop_packet_equals_the_frozen_bytes():
    assert stream_stop_packet().hex() == GOLDEN["stop_packet_hex"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_frozen_packets_reassemble_on_the_port(name):
    case = CASES[name]
    asm = Heap64Assembler()
    done = None
    for hx in case["packets_hex"]:
        raw = bytes.fromhex(hx)
        pkt = parse_packet64(raw)
        assert pkt is not None
        assert (pkt.heap_cnt, pkt.timestamp, pkt.channel_offset) == (
            case["heap_cnt"], case["timestamp"], case["channel_offset"])
        done = asm.feed(raw) or done
    assert done is not None
    np.testing.assert_array_equal(np.frombuffer(done.payload, np.uint8),
                                  _payload(case["payload_size"]))


@pytest.mark.parametrize("index", range(len(GOLDEN["katcp_lines_hex"])))
def test_katcp_lines_equal_the_frozen_bytes(index):
    raw = bytes.fromhex(GOLDEN["katcp_lines_hex"][index])
    msg = Message.decode(raw)
    assert msg is not None
    assert msg.encode() == raw
    again = Message(msg.mtype, msg.name, *msg.args, mid=msg.mid)
    assert again.encode() == raw


def test_katcp_escapes_of_the_frozen_args():
    msg = Message.decode(bytes.fromhex(GOLDEN["katcp_lines_hex"][3]))
    assert msg.args == ["with space\nand\tctl\\chars\x00\x1b"]
