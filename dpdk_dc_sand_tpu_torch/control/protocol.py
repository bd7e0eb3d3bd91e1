"""KATCP-style wire protocol (counterpart of ``dpdk_dc_sand_tpu/control/protocol.py``).

Wire format (KATCP subset, aiokatcp-compatible framing):
``?name[mid] arg…\\n`` requests, ``!name[mid] ok|fail …`` replies,
``#name …`` informs; arguments escaped per KATCP (``\\_`` space, ``\\n``
newline, ``\\e`` escape, ``\\0`` null, ``\\t`` tab, ``\\r`` CR, ``\\@``
empty). Servers dispatch ``?foo-bar`` to ``request_foo_bar`` coroutines;
sensors are exposed via ``?sensor-list``/``?sensor-value`` and pushed as
``#sensor-status`` informs under ``?sensor-sampling <name> auto`` — the
mechanism SensorMirror consumes (corr3_servlet.py:14-64).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import logging
import re
import secrets
import time
from typing import Dict, List, Optional, Tuple

from dpdk_dc_sand_tpu_torch.control.sensors import Sensor, SensorSet, Status

logger = logging.getLogger(__name__)

_ESCAPES = {
    " ": r"\_",
    "\n": r"\n",
    "\r": r"\r",
    "\t": r"\t",
    "\0": r"\0",
    "\\": r"\e"[0] + "e",
}
_UNESCAPES = {"_": " ", "n": "\n", "r": "\r", "t": "\t", "0": "\0", "e": "\\",
              "@": ""}


def escape(arg: str) -> str:
    if arg == "":
        return r"\@"
    out = []
    for ch in arg:
        if ch == "\\":
            out.append(r"\e")
        elif ch in _ESCAPES:
            out.append(_ESCAPES[ch])
        else:
            out.append(ch)
    return "".join(out)


def unescape(arg: str) -> str:
    out = []
    i = 0
    while i < len(arg):
        ch = arg[i]
        if ch == "\\" and i + 1 < len(arg):
            out.append(_UNESCAPES.get(arg[i + 1], arg[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_NAME_RE = re.compile(r"^([?!#])([a-zA-Z][a-zA-Z0-9-]*)(?:\[(\d+)\])?$")


class Message:
    """One protocol line: type ∈ {request '?', reply '!', inform '#'}."""

    REQUEST, REPLY, INFORM = "?", "!", "#"

    def __init__(self, mtype: str, name: str, *args: str, mid: Optional[int] = None):
        self.mtype = mtype
        self.name = name
        self.args = [str(a) for a in args]
        self.mid = mid

    def encode(self) -> bytes:
        mid = f"[{self.mid}]" if self.mid is not None else ""
        parts = [f"{self.mtype}{self.name}{mid}"] + [escape(a) for a in self.args]
        return (" ".join(parts) + "\n").encode()

    @classmethod
    def decode(cls, line: bytes) -> Optional["Message"]:
        text = line.decode(errors="replace").strip()
        if not text:
            return None
        fields = text.split(" ")
        m = _NAME_RE.match(fields[0])
        if not m:
            return None
        mtype, name, mid = m.group(1), m.group(2), m.group(3)
        args = [unescape(f) for f in fields[1:] if f]
        return cls(mtype, name, *args, mid=int(mid) if mid else None)


class FailReply(Exception):
    """Raise inside a request handler to send ``!name fail <msg>``.

    The servlet uses this for validation errors exactly as the reference
    (corr3_servlet.py:142-143).
    """


class _ClientConn:
    def __init__(self, reader, writer, server: "DeviceServer"):
        self.reader = reader
        self.writer = writer
        self.server = server
        self.sampling: set = set()  # sensor names with auto sampling
        self.req_mid: Optional[int] = None  # mid of the request in flight
        self.authed: bool = True  # flipped off when the server has a secret
        self.nonce: str = ""


class DeviceServer:
    """Asyncio control server with request dispatch and sensors.

    Subclass and define ``async def request_<name>(self, conn, *args)``
    returning a tuple of reply arguments (or None). Hyphens in request
    names map to underscores in method names.
    """

    #: KATCP log priorities, lowest to highest.
    LOG_LEVELS = ("all", "trace", "debug", "info", "warn", "error", "fatal", "off")

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        auth_secret: Optional[str] = None,
    ) -> None:
        self._host = host
        self._port = port
        self.sensors = SensorSet()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: List[_ClientConn] = []
        self._log_level = "warn"
        #: Optional shared-secret authentication (an extension — KATCP
        #: itself has none): each connection is challenged with a nonce
        #: and must present ``?auth HMAC-SHA256(secret, nonce)`` before
        #: any other request is served.
        self._auth_secret = auth_secret

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port
        )
        self._port = self._server.sockets[0].getsockname()[1]

    @property
    def port(self) -> int:
        return self._port

    async def stop(self) -> None:
        # Close live connections BEFORE wait_closed(): since py3.12
        # wait_closed blocks until every connection handler returns, so a
        # client that never disconnects (e.g. one that failed auth and
        # gave up) would wedge shutdown.
        for c in list(self._conns):
            c.writer.close()
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------------
    def add_sensor(self, sensor: Sensor) -> Sensor:
        self.sensors.add(sensor)
        sensor.observe(self._sensor_changed)
        return sensor

    def remove_sensor(self, name: str) -> None:
        self.sensors.remove(name)

    def _sensor_changed(self, sensor: Sensor) -> None:
        for conn in list(self._conns):
            if sensor.name in conn.sampling:
                self._send(conn, self._status_inform(sensor))

    @staticmethod
    def _status_inform(sensor: Sensor) -> Message:
        return Message(
            Message.INFORM,
            "sensor-status",
            f"{sensor.timestamp:.6f}",
            "1",
            sensor.name,
            sensor.status.value,
            sensor.format_value(),
        )

    def mass_inform(self, name: str, *args: str) -> None:
        """Broadcast an inform to every connected client
        (aiokatcp mass_inform, used for interface-changed batching)."""
        msg = Message(Message.INFORM, name, *args)
        for conn in list(self._conns):
            self._send(conn, msg)

    # ------------------------------------------------------------------
    def _send(self, conn: _ClientConn, msg: Message) -> None:
        try:
            conn.writer.write(msg.encode())
        except (ConnectionError, RuntimeError):
            pass

    async def _handle_conn(self, reader, writer) -> None:
        conn = _ClientConn(reader, writer, self)
        if self._auth_secret is not None:
            conn.authed = False
            conn.nonce = secrets.token_hex(16)
            self._send(conn, Message(Message.INFORM, "auth-challenge", conn.nonce))
        self._conns.append(conn)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                msg = Message.decode(line)
                if msg is None or msg.mtype != Message.REQUEST:
                    continue
                await self._dispatch(conn, msg)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            if conn in self._conns:
                self._conns.remove(conn)
            writer.close()

    async def _dispatch(self, conn: _ClientConn, msg: Message) -> None:
        if not conn.authed and msg.name != "auth":
            self._send(
                conn,
                Message(
                    Message.REPLY, msg.name, "fail", "unauthorized", mid=msg.mid
                ),
            )
            return
        handler = getattr(self, "request_" + msg.name.replace("-", "_"), None)
        if handler is None:
            self._send(
                conn,
                Message(
                    Message.REPLY,
                    msg.name,
                    "invalid",
                    f"unknown request {msg.name}",
                    mid=msg.mid,
                ),
            )
            return
        conn.req_mid = msg.mid
        try:
            result = await handler(conn, *msg.args)
        except FailReply as e:
            self._send(
                conn, Message(Message.REPLY, msg.name, "fail", str(e), mid=msg.mid)
            )
            return
        except Exception as e:  # noqa: BLE001 - protocol boundary
            logger.exception("handler %s failed", msg.name)
            self._send(
                conn, Message(Message.REPLY, msg.name, "fail", repr(e), mid=msg.mid)
            )
            return
        finally_mid = msg.mid
        conn.req_mid = None
        args = tuple(str(a) for a in (result or ()))
        self._send(
            conn, Message(Message.REPLY, msg.name, "ok", *args, mid=finally_mid)
        )

    def log_inform(self, level: str, message: str, name: str = "root") -> None:
        """Broadcast a ``#log`` inform to clients at or above the set level.

        The KATCP device-log channel (aiokatcp forwards Python logging the
        same way): ``#log <level> <timestamp> <name> <message>``. Engines
        call this for operational events (drops, delay updates); the
        threshold is controlled per server by ``?log-level``.
        """
        levels = self.LOG_LEVELS
        if self._log_level == "off" or levels.index(level) < levels.index(
            self._log_level
        ):
            return
        msg = Message(
            Message.INFORM, "log", level, f"{time.time():.6f}", name, message
        )
        for conn in list(self._conns):
            self._send(conn, msg)

    # ------------------------------------------------------------------
    # Built-in requests
    # ------------------------------------------------------------------
    async def request_auth(self, conn, digest: str = ""):
        """Authenticate with ``HMAC-SHA256(secret, nonce)`` (hex).

        The nonce arrived in the connection's ``#auth-challenge`` inform.
        Constant-time comparison; a failed attempt keeps the connection
        open but unauthenticated (rate limiting is the deployment's job).
        """
        if self._auth_secret is None:
            return ()
        want = hmac.new(
            self._auth_secret.encode(), conn.nonce.encode(), hashlib.sha256
        ).hexdigest()
        if not hmac.compare_digest(want, digest):
            raise FailReply("bad credentials")
        conn.authed = True
        return ()

    async def request_watchdog(self, conn):
        """Liveness ping."""
        return ()

    async def request_log_level(self, conn, level: str = ""):
        """Query or set the minimum priority forwarded as #log informs."""
        if level:
            if level not in self.LOG_LEVELS:
                raise FailReply(f"unknown log level {level}")
            self._log_level = level
        return (self._log_level,)

    async def request_help(self, conn, name: str = ""):
        """List requests (or one request's doc) as informs."""
        handlers = sorted(
            m[len("request_"):].replace("_", "-")
            for m in dir(self)
            if m.startswith("request_") and callable(getattr(self, m))
        )
        if name:
            if name not in handlers:
                raise FailReply(f"unknown request {name}")
            handlers = [name]
        for h in handlers:
            doc = (
                getattr(self, "request_" + h.replace("-", "_")).__doc__
                or ""
            ).strip().splitlines()
            self._send(
                conn,
                Message(
                    Message.INFORM,
                    "help",
                    h,
                    doc[0] if doc else "",
                    mid=conn.req_mid,
                ),
            )
        return (str(len(handlers)),)

    async def request_version_list(self, conn):
        """Report component versions as informs."""
        from dpdk_dc_sand_tpu_torch import __version__

        versions = [
            ("dpdk-dc-sand-tpu-torch", __version__),
            ("katcp-protocol", "5.0-subset"),
        ]
        for name, ver in versions:
            self._send(
                conn,
                Message(Message.INFORM, "version-list", name, ver,
                        mid=conn.req_mid),
            )
        return (str(len(versions)),)

    async def request_sensor_list(self, conn, *names):
        """List sensors as informs, reply with the count."""
        sensors = [s for s in self.sensors if not names or s.name in names]
        for s in sensors:
            self._send(
                conn,
                Message(
                    Message.INFORM,
                    "sensor-list",
                    s.name,
                    s.description,
                    s.units,
                    s.stype,
                    mid=conn.req_mid,
                ),
            )
        return (str(len(sensors)),)

    async def request_sensor_value(self, conn, *names):
        sensors = [s for s in self.sensors if not names or s.name in names]
        if names and not sensors:
            raise FailReply(f"unknown sensor {names[0]}")
        for s in sensors:
            inform = self._status_inform(s)
            inform.mid = conn.req_mid
            self._send(conn, inform)
        return (str(len(sensors)),)

    async def request_sensor_sampling(self, conn, name: str = "", strategy: str = ""):
        if name not in self.sensors:
            raise FailReply(f"unknown sensor {name}")
        if strategy in ("auto", "event"):
            conn.sampling.add(name)
            self._send(conn, self._status_inform(self.sensors[name]))
        elif strategy == "none":
            conn.sampling.discard(name)
        elif strategy:
            raise FailReply(f"unsupported strategy {strategy}")
        return (name, strategy or "none")


class Client:
    """Asyncio control client with request futures and inform callbacks."""

    def __init__(
        self, host: str, port: int, auth_secret: Optional[str] = None
    ) -> None:
        self.host = host
        self.port = port
        self._reader = None
        self._writer = None
        self._mid = 0
        self._pending: Dict[int, Tuple[asyncio.Future, List[Message]]] = {}
        self._inform_handlers: List = []
        self._task: Optional[asyncio.Task] = None
        self._auth_secret = auth_secret
        self._challenge: Optional[asyncio.Future] = None

    async def connect(self, timeout: float = 5.0) -> "Client":
        if self._auth_secret is not None:
            self._challenge = asyncio.get_event_loop().create_future()
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), timeout
        )
        self._task = asyncio.ensure_future(self._run())
        if self._auth_secret is not None:
            # Answer the server's nonce challenge before anything else.
            nonce = await asyncio.wait_for(self._challenge, timeout)
            digest = hmac.new(
                self._auth_secret.encode(), nonce.encode(), hashlib.sha256
            ).hexdigest()
            await self.request("auth", digest, timeout=timeout)
        return self

    def on_inform(self, callback) -> None:
        """Register ``callback(Message)`` for unsolicited informs."""
        self._inform_handlers.append(callback)

    async def _run(self) -> None:
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                msg = Message.decode(line)
                if msg is None:
                    continue
                if msg.mtype == Message.REPLY and msg.mid in self._pending:
                    fut, informs = self._pending.pop(msg.mid)
                    if not fut.done():
                        fut.set_result((msg, informs))
                elif msg.mtype == Message.INFORM:
                    if (
                        msg.name == "auth-challenge"
                        and self._challenge is not None
                        and not self._challenge.done()
                    ):
                        self._challenge.set_result(msg.args[0] if msg.args else "")
                        continue
                    # mid-tagged informs belong to their pending request;
                    # everything else is unsolicited and goes to handlers.
                    if msg.mid is not None and msg.mid in self._pending:
                        self._pending[msg.mid][1].append(msg)
                    else:
                        for cb in list(self._inform_handlers):
                            cb(msg)
        except (ConnectionError, asyncio.CancelledError):
            pass
        # fail anything still pending
        for fut, _ in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("connection closed"))
        self._pending.clear()

    async def request(self, name: str, *args, timeout: float = 5.0):
        """Send ``?name args`` and await ``(reply_args, informs)``.

        Raises :class:`FailReply` if the server replied ``fail``.
        """
        self._mid += 1
        mid = self._mid
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[mid] = (fut, [])
        self._writer.write(
            Message(Message.REQUEST, name, *[str(a) for a in args], mid=mid).encode()
        )
        reply, informs = await asyncio.wait_for(fut, timeout)
        if not reply.args or reply.args[0] != "ok":
            raise FailReply(
                " ".join(reply.args[1:]) if len(reply.args) > 1 else "request failed"
            )
        return reply.args[1:], informs

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            self._writer.close()
