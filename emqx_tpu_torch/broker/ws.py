"""MQTT-over-WebSocket listener (RFC 6455, subprotocol "mqtt").

Parity: emqx_ws_connection.erl + the cowboy websocket listener
(emqx_listeners.erl:132-138). The WS layer is a transparent byte transport:
binary frames carry MQTT wire data into the same Connection/Channel stack
as TCP (the reference likewise reuses emqx_channel under cowboy callbacks).

Hand-rolled RFC 6455 server side: HTTP upgrade handshake (Sec-WebSocket-
Accept), masked client frame decoding with fragmentation, ping/pong, close.

The port's copy of ``emqx_tpu/broker/ws.py``. The payloads still reach the
port's ``Connection`` through the reference's inner pipe, so a read of
many PUBLISHes decodes as a columnar burst as it does over TCP. Two
differences: a masked payload is unmasked with one integer XOR instead of
a byte loop (the same bytes), and the writer adapter exposes the TCP
transport (``transport``), which the connection's congestion check and
its hard abort read. ``open_ws_connection`` is the client side of the
same framing (a reader/writer pair for ``Client(conn_factory=...)``).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import os
import struct
from typing import Optional

from emqx_tpu_torch.broker.connection import Connection
from emqx_tpu_torch.broker.supervise import guard_task
from emqx_tpu_torch.utils.tls import make_server_context

log = logging.getLogger("emqx_tpu_torch.ws")

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = \
    0x0, 0x1, 0x2, 0x8, 0x9, 0xA


def accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def _unmask(payload: bytes, mask: bytes) -> bytes:
    """XOR `payload` with the repeating 4-byte `mask` (RFC 6455 5.3)."""
    n = len(payload)
    if not n:
        return payload
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "little")
            ^ int.from_bytes(key, "little")).to_bytes(n, "little")


DEFAULT_MAX_FRAME = 16 << 20


async def read_frame(reader: asyncio.StreamReader,
                     max_size: int = DEFAULT_MAX_FRAME
                     ) -> Optional[tuple[int, bool, bytes]]:
    """-> (opcode, fin, payload); None on EOF or oversized frame (the
    claimed 64-bit length is attacker-controlled — never buffer it blind)."""
    try:
        b0, b1 = await reader.readexactly(2)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    try:
        if n == 126:
            (n,) = struct.unpack(">H", await reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", await reader.readexactly(8))
        if n > max_size:
            return None
        mask = await reader.readexactly(4) if masked else b""
        payload = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    if masked:
        payload = _unmask(payload, mask)
    return opcode, fin, payload


class _WsWriter:
    """Writer adapter: Connection writes MQTT bytes; we wrap them into WS
    binary frames on the underlying TCP writer."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._w = writer

    @property
    def transport(self):
        return self._w.transport

    def write(self, data: bytes) -> None:
        self._w.write(encode_frame(OP_BIN, data))

    async def drain(self) -> None:
        await self._w.drain()

    def is_closing(self) -> bool:
        return self._w.is_closing()

    def close(self) -> None:
        if not self._w.is_closing():
            try:
                self._w.write(encode_frame(OP_CLOSE, b"\x03\xe8"))
            except (ConnectionError, OSError):
                pass
        self._w.close()

    async def wait_closed(self) -> None:
        try:
            await self._w.wait_closed()
        except (ConnectionError, OSError):
            pass

    def get_extra_info(self, name, default=None):
        return self._w.get_extra_info(name, default)


class WsListener:
    """Parity: the ws/wss listener entry of emqx_listeners (wss = the same
    RFC6455 server over a TLS transport, emqx_listeners.erl:132-138)."""

    protocol = "mqtt:ws"

    def __init__(self, node, *, bind: str = "0.0.0.0", port: int = 8083,
                 path: str = "/mqtt", zone: Optional[str] = None,
                 max_connections: int = 1024000,
                 ssl_opts: Optional[dict] = None):
        self.node = node
        self.bind = bind
        self.port = port
        self.path = path
        self.zone = zone
        self.ssl_opts = ssl_opts
        if ssl_opts:
            self.protocol = "mqtt:wss"
        self.max_connections = max_connections
        self.current_conns = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        ssl_ctx = make_server_context(self.ssl_opts) \
            if self.ssl_opts else None
        self._server = await asyncio.start_server(self._on_client,
                                                  self.bind, self.port,
                                                  ssl=ssl_ctx)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        if self.current_conns >= self.max_connections:
            writer.close()       # same cap behavior as the TCP listener
            return
        task = asyncio.current_task()
        self._conns.add(task)
        self.current_conns += 1
        try:
            if not await self._handshake(reader, writer):
                writer.close()
                return
            await self._run_ws(reader, writer)
        except (ConnectionError, OSError):
            pass
        finally:
            self.current_conns -= 1
            self._conns.discard(task)
            writer.close()

    async def _handshake(self, reader, writer) -> bool:
        try:
            request = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), 10)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                asyncio.LimitOverrunError):
            return False
        lines = request.decode("latin1").split("\r\n")
        try:
            _method, path, _ver = lines[0].split()
        except ValueError:
            return False
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            if k:
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        protos = [p.strip() for p in
                  headers.get("sec-websocket-protocol", "").split(",")
                  if p.strip()]
        if (path.split("?")[0] != self.path or key is None
                or headers.get("upgrade", "").lower() != "websocket"):
            writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                         b"content-length: 0\r\n\r\n")
            await writer.drain()
            return False
        resp = ["HTTP/1.1 101 Switching Protocols",
                "upgrade: websocket", "connection: Upgrade",
                f"sec-websocket-accept: {accept_key(key)}"]
        # the MQTT-over-WS subprotocol must be echoed ([MQTT-6.0.0-3])
        if "mqtt" in [p.lower() for p in protos]:
            resp.append("sec-websocket-protocol: mqtt")
        writer.write(("\r\n".join(resp) + "\r\n\r\n").encode())
        await writer.drain()
        return True

    async def _run_ws(self, reader, writer) -> None:
        # inner pipe: WS binary payloads -> Connection's StreamReader
        pipe = asyncio.StreamReader()
        ws_writer = _WsWriter(writer)
        conn = Connection(self.node, pipe, ws_writer, zone=self.zone)
        conn_task = guard_task(asyncio.ensure_future(conn.run()),
                               "ws-conn", self.node.metrics)
        fragments: list[bytes] = []
        frag_op = OP_BIN
        try:
            while not conn_task.done():
                frame = await read_frame(reader)
                if frame is None:
                    break
                opcode, fin, payload = frame
                if opcode == OP_PING:
                    writer.write(encode_frame(OP_PONG, payload))
                    continue
                if opcode == OP_CLOSE:
                    break
                if opcode in (OP_BIN, OP_TEXT, OP_CONT):
                    if opcode != OP_CONT and not fin:
                        fragments, frag_op = [payload], opcode
                        continue
                    if opcode == OP_CONT:
                        fragments.append(payload)
                        if sum(len(f) for f in fragments) \
                                > DEFAULT_MAX_FRAME:
                            break    # unbounded fragment stream
                        if not fin:
                            continue
                        payload = b"".join(fragments)
                        opcode = frag_op
                        fragments = []
                    if opcode == OP_BIN:
                        pipe.feed_data(payload)
        finally:
            pipe.feed_eof()
            try:
                await asyncio.wait_for(conn_task, 5)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                conn_task.cancel()


class _WsClientWriter:
    """Client-side writer: each write is one masked binary frame."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._w = writer
        self.transport = writer.transport
        self.pump: Optional[asyncio.Task] = None   # the reader's pump

    def write(self, data: bytes, opcode: int = OP_BIN) -> None:
        mask = os.urandom(4)
        n = len(data)
        if n < 126:
            head = bytes([0x80 | opcode, 0x80 | n])
        elif n < 65536:
            head = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n)
        else:
            head = bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n)
        self._w.write(head + mask + _unmask(data, mask))

    async def drain(self) -> None:
        await self._w.drain()

    def is_closing(self) -> bool:
        return self._w.is_closing()

    def close(self) -> None:
        self._w.close()

    async def wait_closed(self) -> None:
        await self._w.wait_closed()

    def get_extra_info(self, name, default=None):
        return self._w.get_extra_info(name, default)


async def open_ws_connection(host: str, port: int, *, path: str = "/mqtt",
                             ssl=None, timeout: float = 10.0):
    """Open an MQTT-over-WebSocket client connection (``ws``, or ``wss``
    with an ``ssl.SSLContext``): the upgrade handshake with subprotocol
    ``mqtt``, then a (reader, writer) pair carrying MQTT bytes — the
    reader fed from the server's binary frames by a pump task, the writer
    sending masked binary frames. For ``Client(conn_factory=...)``."""
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET {path} HTTP/1.1\r\nhost: {host}:{port}\r\n"
                  "upgrade: websocket\r\nconnection: Upgrade\r\n"
                  f"sec-websocket-key: {key}\r\n"
                  "sec-websocket-version: 13\r\n"
                  "sec-websocket-protocol: mqtt\r\n\r\n").encode())
    await writer.drain()
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
    status = head.split(b"\r\n", 1)[0]
    if b" 101 " not in status + b" " \
            or accept_key(key).encode() not in head:
        writer.close()
        raise ConnectionError(f"websocket upgrade refused: {status!r}")
    pipe = asyncio.StreamReader()
    out = _WsClientWriter(writer)

    async def pump():
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None or frame[0] == OP_CLOSE:
                    break
                if frame[0] == OP_PING:
                    out.write(frame[2], OP_PONG)
                elif frame[0] in (OP_BIN, OP_CONT):
                    pipe.feed_data(frame[2])
        finally:
            pipe.feed_eof()

    out.pump = asyncio.ensure_future(pump())
    return pipe, out
