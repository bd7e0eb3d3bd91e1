"""Servlet launcher — ``scripts/start_corr3_servlet.py`` analog (counterpart of ``dpdk_dc_sand_tpu/control/launch.py``).

Run with ``python -m dpdk_dc_sand_tpu_torch.control.launch --antennas 4 --port
7404 --engine host:port --engine host:port``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def parse_endpoint(text: str):
    host, _, port = text.rpartition(":")
    return host or "127.0.0.1", int(port)


async def amain(args) -> None:
    from dpdk_dc_sand_tpu_torch.control import CorrServlet

    servlet = CorrServlet(
        args.name,
        n_antennas=args.antennas,
        host=args.host,
        port=args.port,
        engine_endpoints=[parse_endpoint(e) for e in args.engine],
    )
    await servlet.start()
    logging.info("servlet %s listening on %s:%d", args.name, args.host, servlet.port)
    try:
        await asyncio.Event().wait()
    finally:
        await servlet.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", default="corr3")
    parser.add_argument("--antennas", type=int, default=4)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7404)
    parser.add_argument(
        "--engine", action="append", default=[], help="host:port, repeatable"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
