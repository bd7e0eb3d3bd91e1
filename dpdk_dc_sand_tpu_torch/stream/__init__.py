"""Host streaming layer (counterpart of ``dpdk_dc_sand_tpu/stream``).

The reference moves sample/beam streams as UDP-multicast SPEAD heaps over
kernel-bypass NICs. Within a GPU host the data plane is host memory → the
card, but the *contract* carries over unchanged:

- chunked, sequence-numbered payloads with timestamps and channel offsets
  (:mod:`~dpdk_dc_sand_tpu_torch.stream.spead`,
  :mod:`~dpdk_dc_sand_tpu_torch.stream.spead64`),
- preallocated zero-copy ring buffers, optionally page-locked, with
  explicit completion/reuse signalling and drop accounting
  (:mod:`~dpdk_dc_sand_tpu_torch.stream.ring`),
- a double-buffered device feed on its own copy stream, egress and
  per-second rate reporting (:mod:`~dpdk_dc_sand_tpu_torch.stream.feed`),
- a real UDP transport for host↔host streams
  (:mod:`~dpdk_dc_sand_tpu_torch.stream.udp`).
"""

from dpdk_dc_sand_tpu_torch.stream.chunk import Chunk, StreamStats  # noqa: F401
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing  # noqa: F401
from dpdk_dc_sand_tpu_torch.stream.spead import (  # noqa: F401
    HEADER_BYTES,
    HeapAssembler,
    packetize,
    parse_header,
)
from dpdk_dc_sand_tpu_torch.stream.spead64 import (  # noqa: F401
    Heap64Assembler,
    packetize64,
    parse_packet64,
    stream_stop_packet,
)
from dpdk_dc_sand_tpu_torch.stream.feed import DeviceFeed, RateReporter  # noqa: F401
from dpdk_dc_sand_tpu_torch.stream.udp import UdpReceiver, UdpSender  # noqa: F401
