"""Packet latency / jitter analysis, the ``packet_latency`` analog (counterpart of ``dpdk_dc_sand_tpu/stream/latency.py``).

The reference extracts ADC timestamps (SPEAD item 0x1600) from captured
packets and compares them against NIC capture times to characterise send
jitter (packet_latency/extract_timestamps.py:17-35, plot_latency.py:20-27:
``pkt_time − adc_time/1712e6``). Same contract here: feed
(capture_time, packet_bytes) records — from a live tap or a pcap file
(:func:`read_pcap`) — get jitter stats and an optional plot. Both wire
formats parse: real SPEAD-64-48 (spead2 captures, MeerKAT) and
SPEAD-lite.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from dpdk_dc_sand_tpu_torch.stream.spead import parse_header
from dpdk_dc_sand_tpu_torch.stream.spead64 import parse_packet64


def packet_timestamp(pkt: bytes) -> Optional[int]:
    """The ADC timestamp of one SPEAD packet, either wire format."""
    h64 = parse_packet64(pkt)
    if h64 is not None:
        return None if h64.stream_ctrl is not None else h64.timestamp
    hdr = parse_header(pkt)
    return None if hdr is None else hdr.timestamp


def extract_timestamps(
    packets: Iterable[Tuple[float, bytes]],
) -> np.ndarray:
    """``[(capture_time_s, adc_timestamp), …]`` float64 array [n, 2].

    Non-protocol packets are skipped (the pcap filter analog).
    """
    rows: List[Tuple[float, int]] = []
    for t, pkt in packets:
        ts = packet_timestamp(pkt)
        if ts is None:
            continue
        rows.append((t, ts))
    return np.asarray(rows, np.float64).reshape(-1, 2)


# ----------------------------------------------------------------------
# Classic-pcap capture files (extract_timestamps.py reads these via the
# pcap module; we parse the format directly — no capture library in the
# image). Link-layer Ethernet/IPv4/UDP framing is stripped to yield the
# SPEAD payload, exactly the reference's ``pkt[42:]`` decap.
# ----------------------------------------------------------------------
_PCAP_US_LE, _PCAP_US_BE = 0xA1B2C3D4, 0xD4C3B2A1
_PCAP_NS_LE, _PCAP_NS_BE = 0xA1B23C4D, 0x4D3CB2A1
_ETH_IP_UDP = 42  # Eth(14) + IPv4(20, no options) + UDP(8)


def read_pcap(
    path: str, strip_headers: bool = True
) -> Iterator[Tuple[float, bytes]]:
    """Yield ``(capture_time_s, payload_bytes)`` from a classic pcap file.

    Handles both byte orders and both microsecond and nanosecond
    timestamp flavours. ``strip_headers`` removes the 42-byte
    Eth/IPv4/UDP framing (extract_timestamps.py:21); pass False for
    captures of raw SPEAD datagrams.
    """
    with open(path, "rb") as f:
        ghdr = f.read(24)
        if len(ghdr) < 24:
            return
        (magic,) = struct.unpack("<I", ghdr[:4])
        if magic in (_PCAP_US_LE, _PCAP_NS_LE):
            endian = "<"
        elif magic in (_PCAP_US_BE, _PCAP_NS_BE):
            endian = ">"
            (magic,) = struct.unpack(">I", ghdr[:4])
        else:
            raise ValueError(f"not a classic pcap file: magic {magic:#x}")
        frac_scale = 1e-9 if magic == _PCAP_NS_LE else 1e-6
        rec = struct.Struct(endian + "IIII")
        while True:
            rh = f.read(16)
            if len(rh) < 16:
                return
            ts_sec, ts_frac, incl_len, _orig = rec.unpack(rh)
            data = f.read(incl_len)
            if len(data) < incl_len:
                return
            if strip_headers:
                if len(data) <= _ETH_IP_UDP:
                    continue
                data = data[_ETH_IP_UDP:]
            yield (ts_sec + ts_frac * frac_scale, data)


def write_pcap(
    path: str,
    packets: Iterable[Tuple[float, bytes]],
    add_headers: bool = True,
) -> int:
    """Write ``(time_s, spead_payload)`` records as a classic pcap file.

    The capture-synthesis counterpart of :func:`read_pcap` (the
    reference verifies transport offline against tcpdump/mcdump files,
    dpdk_send_recv/verify.py:20-33); ``add_headers`` frames each payload
    in a minimal Eth/IPv4/UDP envelope so standard tools parse the file.
    Returns the packet count.
    """
    n = 0
    with open(path, "wb") as f:
        # Nanosecond flavour, little-endian, LINKTYPE_ETHERNET(1).
        f.write(struct.pack("<IHHiIII", _PCAP_NS_LE, 2, 4, 0, 0, 65535, 1))
        for t, payload in packets:
            if add_headers:
                udp_len = 8 + len(payload)
                ip_len = 20 + udp_len
                eth = b"\xff" * 6 + b"\x02" * 6 + b"\x08\x00"
                ip = struct.pack(
                    ">BBHHHBBH4s4s",
                    0x45, 0, ip_len, 0, 0x4000, 64, 17, 0,
                    b"\x7f\x00\x00\x01", b"\x7f\x00\x00\x01",
                )
                udp = struct.pack(">HHHH", 8888, 8888, udp_len, 0)
                frame = eth + ip + udp + payload
            else:
                frame = payload
            sec = int(t)
            nsec = int(round((t - sec) * 1e9))
            f.write(struct.pack("<IIII", sec, nsec, len(frame), len(frame)))
            f.write(frame)
            n += 1
    return n


def latency_stats(
    records: np.ndarray, adc_sample_rate: float = 1712e6
) -> dict:
    """Jitter of ``capture_time − adc_time/rate``, mean-detrended.

    The absolute offset between the capture clock and the ADC epoch is
    arbitrary; jitter (spread around the mean) is the metric
    (plot_latency.py:20-27).
    """
    if len(records) == 0:
        return {"n": 0}
    lat = records[:, 0] - records[:, 1] / adc_sample_rate
    lat = lat - lat.mean()
    return {
        "n": int(len(lat)),
        "jitter_std_us": float(lat.std() * 1e6),
        "jitter_p2p_us": float((lat.max() - lat.min()) * 1e6),
        "jitter_min_us": float(lat.min() * 1e6),
        "jitter_max_us": float(lat.max() * 1e6),
    }


def plot_latency(
    records: np.ndarray,
    adc_sample_rate: float = 1712e6,
    path: Optional[str] = None,
):
    """Scatter of per-packet latency vs packet index (plot_latency.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lat = records[:, 0] - records[:, 1] / adc_sample_rate
    lat = (lat - lat.mean()) * 1e6
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(lat, ".", markersize=2)
    ax.set_xlabel("packet")
    ax.set_ylabel("latency jitter (µs)")
    ax.set_title("SPEAD packet send jitter")
    if path is not None:
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return fig


def _main(argv=None) -> int:
    """CLI: extract (capture_time, adc_timestamp) from a pcap and report
    jitter — the packet_latency/extract_timestamps.py + plot_latency.py
    workflow in one command. Writes an .npz compatible with the
    reference tool's output (pkt_timestamps / adc_timestamps arrays).
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="SPEAD packet latency/jitter from a pcap capture"
    )
    ap.add_argument("input", help="classic pcap file")
    ap.add_argument("output", nargs="?", help="optional .npz output")
    ap.add_argument("--plot", help="optional jitter plot (png)")
    ap.add_argument(
        "--adc-rate", type=float, default=1712e6, help="ADC sample rate"
    )
    ap.add_argument(
        "--raw", action="store_true",
        help="capture has no Eth/IP/UDP framing",
    )
    args = ap.parse_args(argv)
    records = extract_timestamps(
        read_pcap(args.input, strip_headers=not args.raw)
    )
    if args.output:
        np.savez(
            args.output,
            pkt_timestamps=records[:, 0],
            adc_timestamps=records[:, 1],
        )
    if args.plot:
        plot_latency(records, args.adc_rate, path=args.plot)
    print(json.dumps(latency_stats(records, args.adc_rate)))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
