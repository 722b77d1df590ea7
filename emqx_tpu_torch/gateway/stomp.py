"""STOMP 1.0/1.1/1.2 gateway.

Parity: apps/emqx_gateway/src/stomp — frame codec (emqx_stomp_frame.erl),
protocol FSM (emqx_stomp_channel.erl): CONNECT/STOMP auth + CONNECTED,
SEND -> publish (with transactions via BEGIN/COMMIT/ABORT), SUBSCRIBE with
per-subscription ids -> MESSAGE deliveries, receipts, heart-beats,
ERROR + close on protocol violations.

Destination = MQTT topic (the reference maps 1:1 and allows MQTT wildcard
destinations on subscribe).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Optional

from emqx_tpu_torch.gateway.ctx import GatewayCtx

MAX_FRAME = 1 << 20


class StompError(Exception):
    pass


class Frame:
    def __init__(self, command: str, headers: Optional[dict] = None,
                 body: bytes = b""):
        self.command = command
        self.headers = dict(headers or {})
        self.body = body

    def encode(self) -> bytes:
        out = [self.command.encode()]
        for k, v in self.headers.items():
            out.append(f"{_esc(k)}:{_esc(str(v))}".encode())
        if self.body and "content-length" not in self.headers:
            out.append(f"content-length:{len(self.body)}".encode())
        return b"\n".join(out) + b"\n\n" + self.body + b"\x00"


def _esc(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace(":", "\\c").replace("\r", "\\r"))


def _unesc(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append({"n": "\n", "c": ":", "\\": "\\", "r": "\r"}
                       .get(v[i + 1], v[i + 1]))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


class FrameParser:
    """Incremental parser over a byte buffer (emqx_stomp_frame streaming)."""

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes) -> list[Frame]:
        self.buf += data
        if len(self.buf) > MAX_FRAME:
            raise StompError("frame too large")
        out = []
        while True:
            f = self._try_parse()
            if f is None:
                return out
            if f is not False:     # False = heart-beat newline
                out.append(f)

    def _try_parse(self):
        # leading EOLs between frames are heart-beats
        while self.buf[:1] in (b"\n", b"\r"):
            self.buf = self.buf[1:]
        if not self.buf:
            return None
        # take whichever header terminator appears FIRST: a CRLF frame whose
        # body contains "\n\n" must not be cut at the body (STOMP 1.2 EOLs)
        idx_lf = self.buf.find(b"\n\n")
        idx_crlf = self.buf.find(b"\r\n\r\n")
        if idx_crlf >= 0 and (idx_lf < 0 or idx_crlf <= idx_lf - 1):
            head_end, sep = idx_crlf, 4
        elif idx_lf >= 0:
            head_end, sep = idx_lf, 2
        else:
            return None
        head = self.buf[:head_end].decode("utf-8", "replace")
        lines = head.replace("\r\n", "\n").split("\n")
        command = lines[0].strip()
        headers: dict[str, str] = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            k = _unesc(k)
            if k and k not in headers:      # first wins (spec)
                headers[k] = _unesc(v)
        body_start = head_end + sep
        if "content-length" in headers:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise StompError("bad content-length")
            if len(self.buf) < body_start + n + 1:
                return None
            body = self.buf[body_start:body_start + n]
            if self.buf[body_start + n:body_start + n + 1] != b"\x00":
                raise StompError("missing frame NUL")
            self.buf = self.buf[body_start + n + 1:]
        else:
            nul = self.buf.find(b"\x00", body_start)
            if nul < 0:
                return None
            body = self.buf[body_start:nul]
            self.buf = self.buf[nul + 1:]
        return Frame(command, headers, body)


class StompChannel:
    """One client connection (emqx_stomp_channel.erl)."""

    def __init__(self, gw: "StompGateway", reader, writer):
        self.gw = gw
        self.ctx = gw.ctx
        self.reader, self.writer = reader, writer
        self.parser = FrameParser()
        self.connected = False
        self.clientid = ""
        self.clientinfo: dict = {}
        self.sid: Optional[int] = None
        # stomp sub id -> (topic, ack_mode); topic -> sub id
        self.subs: dict[str, tuple[str, str]] = {}
        self.topic_to_sub: dict[str, str] = {}
        self.transactions: dict[str, list[Frame]] = {}
        self.heartbeat = (0, 0)
        self._last_recv = time.monotonic()

    # ---- broker subscriber protocol ----
    def deliver(self, topic_filter: str, msg) -> bool:
        subid = self.topic_to_sub.get(topic_filter, "0")
        self._send(Frame("MESSAGE", {
            "subscription": subid,
            "message-id": uuid.uuid4().hex[:16],
            "destination": msg.topic,
            "content-type": "text/plain",
        }, msg.payload))
        return True

    def _send(self, frame: Frame) -> None:
        try:
            self.writer.write(frame.encode())
        except (ConnectionError, OSError):
            pass

    def _error(self, message: str, detail: str = "",
               receipt: Optional[str] = None) -> None:
        h = {"message": message}
        if receipt:
            h["receipt-id"] = receipt
        self._send(Frame("ERROR", h, detail.encode()))

    def _receipt(self, frame: Frame) -> None:
        rid = frame.headers.get("receipt")
        if rid:
            self._send(Frame("RECEIPT", {"receipt-id": rid}))

    async def run(self) -> None:
        try:
            while True:
                data = await self.reader.read(4096)
                if not data:
                    break
                self._last_recv = time.monotonic()
                for frame in self.parser.feed(data):
                    await self.handle(frame)
                await self.writer.drain()
        except (StompError, ConnectionError,
                asyncio.IncompleteReadError) as e:
            if isinstance(e, StompError):
                self._error("protocol error", str(e))
        finally:
            self.terminate()

    def terminate(self) -> None:
        if self.sid is not None:
            self.ctx.unregister_subscriber(self.sid)
            self.sid = None
        if self.connected:
            self.ctx.unregister_channel(self.clientid, self)
            self.connected = False
            self.gw.node.hooks.run("client.disconnected",
                                   (self.clientinfo, "closed"))
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass

    async def handle(self, frame: Frame) -> None:
        cmd = frame.command
        if not self.connected and cmd not in ("CONNECT", "STOMP"):
            self._error("not connected", f"got {cmd} before CONNECT")
            return
        handler = {
            "CONNECT": self._on_connect, "STOMP": self._on_connect,
            "SEND": self._on_send, "SUBSCRIBE": self._on_subscribe,
            "UNSUBSCRIBE": self._on_unsubscribe,
            "BEGIN": self._on_begin, "COMMIT": self._on_commit,
            "ABORT": self._on_abort, "ACK": self._on_ack,
            "NACK": self._on_ack, "DISCONNECT": self._on_disconnect,
        }.get(cmd)
        if handler is None:
            self._error("unknown command", cmd)
            return
        await handler(frame)

    async def _on_connect(self, frame: Frame) -> None:
        if self.connected:
            self._error("already connected", "")
            return
        h = frame.headers
        login = h.get("login", "")
        self.clientid = h.get("client-id") or f"stomp-{uuid.uuid4().hex[:12]}"
        self.clientinfo = {"clientid": f"stomp:{self.clientid}",
                           "username": login, "proto_name": "STOMP",
                           "protocol": "stomp",
                           "peername": self.writer.get_extra_info("peername")}
        if not await self.ctx.authenticate(self.clientinfo,
                                           h.get("passcode")):
            self._error("login failed", "authentication refused")
            self.terminate()
            return
        cx, _, cy = h.get("heart-beat", "0,0").partition(",")
        try:
            self.heartbeat = (int(cx or 0), int(cy or 0))
        except ValueError:
            self._error("bad heart-beat", h.get("heart-beat", ""))
            return
        self.connected = True
        self.sid = self.ctx.register_subscriber(self, self.clientid)
        self.ctx.register_channel(self.clientid, self,
                                  {"username": login, "proto": "stomp"})
        self.gw.node.hooks.run("client.connected",
                               (self.clientinfo, {"proto_name": "STOMP"}))
        self._send(Frame("CONNECTED", {
            "version": _negotiate(h.get("accept-version", "1.0")),
            "heart-beat": f"{self.heartbeat[1]},{self.heartbeat[0]}",
            "server": "emqx-tpu-stomp",
            "session": self.clientid,
        }))

    async def _on_send(self, frame: Frame) -> None:
        dest = frame.headers.get("destination")
        if not dest:
            self._error("missing destination", "")
            return
        tx = frame.headers.get("transaction")
        if tx is not None:
            if tx not in self.transactions:
                self._error("transaction not begun", tx)
                return
            self.transactions[tx].append(frame)
            self._receipt(frame)
            return
        await self._do_send(frame)
        self._receipt(frame)

    async def _do_send(self, frame: Frame) -> None:
        dest = frame.headers["destination"]
        if not await self.ctx.authorize(self.clientinfo, "publish", dest):
            self._error("not authorized", dest)
            return
        qos = int(frame.headers.get("qos", 0))
        self.ctx.publish(self.clientid, dest, frame.body, qos=qos)
        self.ctx.metrics_inc("messages.received")

    async def _on_subscribe(self, frame: Frame) -> None:
        dest = frame.headers.get("destination")
        subid = frame.headers.get("id", "0")
        if not dest:
            self._error("missing destination", "")
            return
        if not await self.ctx.authorize(self.clientinfo, "subscribe", dest):
            self._error("not authorized", dest)
            return
        ack = frame.headers.get("ack", "auto")
        self.subs[subid] = (dest, ack)
        self.topic_to_sub[dest] = subid
        self.ctx.subscribe(self.sid, dest, {"qos": 1})
        self._receipt(frame)

    async def _on_unsubscribe(self, frame: Frame) -> None:
        subid = frame.headers.get("id")
        ent = self.subs.pop(subid, None)
        if ent:
            self.topic_to_sub.pop(ent[0], None)
            self.ctx.unsubscribe(self.sid, ent[0])
        self._receipt(frame)

    async def _on_begin(self, frame: Frame) -> None:
        tx = frame.headers.get("transaction")
        if tx in self.transactions:
            self._error("transaction already begun", tx or "")
            return
        self.transactions[tx] = []
        self._receipt(frame)

    async def _on_commit(self, frame: Frame) -> None:
        tx = frame.headers.get("transaction")
        frames = self.transactions.pop(tx, None)
        if frames is None:
            self._error("transaction not begun", tx or "")
            return
        for f in frames:
            await self._do_send(f)
        self._receipt(frame)

    async def _on_abort(self, frame: Frame) -> None:
        tx = frame.headers.get("transaction")
        if self.transactions.pop(tx, None) is None:
            self._error("transaction not begun", tx or "")
            return
        self._receipt(frame)

    async def _on_ack(self, frame: Frame) -> None:
        self._receipt(frame)   # client-mode acks are accepted (no redelivery)

    async def _on_disconnect(self, frame: Frame) -> None:
        self._receipt(frame)
        await self.writer.drain()
        self.terminate()


def _negotiate(accept: str) -> str:
    versions = {v.strip() for v in accept.split(",")}
    for v in ("1.2", "1.1", "1.0"):
        if v in versions:
            return v
    return "1.0"


class StompGateway:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        self.conf = conf or {}
        self.ctx = GatewayCtx(node, "stomp")
        self.bind = self.conf.get("bind", "127.0.0.1")
        self.port = self.conf.get("port", 61613)
        self._server: Optional[asyncio.AbstractServer] = None
        self._channels: set[StompChannel] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._accept, self.bind,
                                                  self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer) -> None:
        ch = StompChannel(self, reader, writer)
        self._channels.add(ch)
        try:
            await ch.run()
        finally:
            self._channels.discard(ch)

    async def stop(self) -> None:
        for ch in list(self._channels):
            ch.terminate()
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass

    def info(self) -> dict:
        return {"listener": f"tcp:{self.bind}:{self.port}",
                "current_connections": len(self._channels)}
