"""CoAP gateway (RFC 7252 over UDP) with MQTT pub/sub semantics.

Parity: apps/emqx_gateway/src/coap — message codec
(emqx_coap_message.erl/emqx_coap_frame), transport manager, and the MQTT
resource (emqx_coap_mqtt_handler): PUT/POST `/mqtt/{topic}?c=<clientid>`
publishes the payload; GET with Observe:0 subscribes (notifications arrive
as NON 2.05 responses carrying an incrementing Observe sequence on the same
token); Observe:1 (or DELETE) unsubscribes.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Optional
from urllib.parse import parse_qsl, unquote

from emqx_tpu_torch.gateway.ctx import GatewayCtx

# types
CON, NON, ACK, RST = 0, 1, 2, 3
# option numbers
OPT_OBSERVE = 6
OPT_LOCATION_PATH = 8
OPT_URI_PATH = 11
OPT_CONTENT_FORMAT = 12
OPT_MAX_AGE = 14
OPT_URI_QUERY = 15


def code(cls: int, detail: int) -> int:
    return (cls << 5) | detail


GET, POST, PUT, DELETE = 1, 2, 3, 4
CREATED = code(2, 1)
DELETED = code(2, 2)
VALID = code(2, 3)
CHANGED = code(2, 4)
CONTENT = code(2, 5)
BAD_REQUEST = code(4, 0)
UNAUTHORIZED = code(4, 1)
NOT_FOUND = code(4, 4)
METHOD_NOT_ALLOWED = code(4, 5)


@dataclass
class CoapMessage:
    type: int = CON
    code: int = 0
    message_id: int = 0
    token: bytes = b""
    options: list = field(default_factory=list)   # [(number, bytes)]
    payload: bytes = b""

    def opt(self, number: int) -> Optional[bytes]:
        for n, v in self.options:
            if n == number:
                return v
        return None

    def opts(self, number: int) -> list[bytes]:
        return [v for n, v in self.options if n == number]

    @property
    def uri_path(self) -> list[str]:
        return [v.decode("utf-8", "replace")
                for v in self.opts(OPT_URI_PATH)]

    @property
    def uri_query(self) -> dict:
        out = {}
        for v in self.opts(OPT_URI_QUERY):
            k, _, val = v.decode("utf-8", "replace").partition("=")
            out[k] = unquote(val)
        return out


def _ext_len(x: int) -> tuple[int, bytes]:
    if x < 13:
        return x, b""
    if x < 269:
        return 13, bytes([x - 13])
    return 14, struct.pack(">H", x - 269)


def encode(m: CoapMessage) -> bytes:
    out = bytearray()
    out.append(0x40 | (m.type << 4) | len(m.token))
    out.append(m.code)
    out += struct.pack(">H", m.message_id)
    out += m.token
    last = 0
    # stable sort by option number ONLY: repeated options (Uri-Path
    # segments) must keep their relative order (RFC 7252 §3.1)
    for num, val in sorted(m.options, key=lambda kv: kv[0]):
        dnib, dext = _ext_len(num - last)
        lnib, lext = _ext_len(len(val))
        out.append((dnib << 4) | lnib)
        out += dext + lext + val
        last = num
    if m.payload:
        out.append(0xFF)
        out += m.payload
    return bytes(out)


class CoapError(Exception):
    pass


def decode(data: bytes) -> CoapMessage:
    try:
        return _decode(data)
    except (struct.error, IndexError) as e:
        # truncated datagrams surface as CoapError (silent drop upstream)
        raise CoapError(f"truncated message: {e}") from e


def _decode(data: bytes) -> CoapMessage:
    if len(data) < 4 or (data[0] >> 6) != 1:
        raise CoapError("bad version/short header")
    tkl = data[0] & 0x0F
    if tkl > 8:
        raise CoapError("bad TKL")
    m = CoapMessage(type=(data[0] >> 4) & 3, code=data[1],
                    message_id=struct.unpack(">H", data[2:4])[0],
                    token=data[4:4 + tkl])
    i = 4 + tkl
    last = 0
    while i < len(data):
        if data[i] == 0xFF:
            m.payload = data[i + 1:]
            if not m.payload:
                raise CoapError("payload marker with empty payload")
            break
        dnib, lnib = data[i] >> 4, data[i] & 0x0F
        i += 1

        def ext(nib):
            nonlocal i
            if nib == 13:
                v = data[i] + 13
                i += 1
                return v
            if nib == 14:
                v = struct.unpack(">H", data[i:i + 2])[0] + 269
                i += 2
                return v
            if nib == 15:
                raise CoapError("reserved option nibble")
            return nib
        delta = ext(dnib)
        length = ext(lnib)
        last += delta
        m.options.append((last, data[i:i + length]))
        i += length
    return m


class _Observer:
    def __init__(self, gw, addr, token, clientid, topic):
        self.gw = gw
        self.addr = addr
        self.token = token
        self.clientid = clientid
        self.topic = topic
        self.seq = 1
        self.sid: Optional[int] = None

    def deliver(self, topic_filter: str, msg) -> bool:
        self.seq += 1
        self.gw._send(self.addr, CoapMessage(
            type=NON, code=CONTENT, message_id=self.gw._next_mid(),
            token=self.token,
            options=[(OPT_OBSERVE, _obs_bytes(self.seq))],
            payload=msg.payload))
        return True


def _obs_bytes(seq: int) -> bytes:
    if seq < 256:
        return bytes([seq])
    if seq < 65536:
        return struct.pack(">H", seq)
    return struct.pack(">I", seq)[1:]


class CoapGateway(asyncio.DatagramProtocol):
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        self.conf = conf or {}
        self.ctx = GatewayCtx(node, "coap")
        self.bind = self.conf.get("bind", "127.0.0.1")
        self.port = self.conf.get("port", 5683)
        self.transport = None
        self._mid = 0
        # (addr, token) -> _Observer ; and (addr, topic) for dedup
        self.observers: dict[tuple, _Observer] = {}

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.bind, self.port))
        if self.port == 0:
            self.port = self.transport.get_extra_info("sockname")[1]

    async def stop(self) -> None:
        for ob in list(self.observers.values()):
            if ob.sid is not None:
                self.ctx.unregister_subscriber(ob.sid)
        self.observers.clear()
        if self.transport:
            self.transport.close()

    def info(self) -> dict:
        return {"listener": f"udp:{self.bind}:{self.port}",
                "observers": len(self.observers)}

    def _next_mid(self) -> int:
        self._mid = (self._mid + 1) & 0xFFFF
        return self._mid

    def _send(self, addr, msg: CoapMessage) -> None:
        if self.transport:
            self.transport.sendto(encode(msg), addr)

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = decode(data)
        except CoapError:
            return
        if msg.type in (ACK, RST):
            if msg.type == RST:
                self._cancel_all(addr)
            return
        from emqx_tpu_torch.broker.supervise import spawn
        spawn(self._handle(addr, msg), "coap-handle")

    def _reply(self, addr, req: CoapMessage, rcode: int,
               options: Optional[list] = None,
               payload: bytes = b"") -> None:
        self._send(addr, CoapMessage(
            type=ACK if req.type == CON else NON, code=rcode,
            message_id=req.message_id, token=req.token,
            options=options or [], payload=payload))

    async def _handle(self, addr, req: CoapMessage) -> None:
        path = req.uri_path
        if len(path) < 2 or path[0] != "mqtt":
            self._reply(addr, req, NOT_FOUND)
            return
        topic = "/".join(path[1:])
        q = req.uri_query
        clientid = q.get("c") or f"coap-{addr[0]}-{addr[1]}"
        clientinfo = {"clientid": f"coap:{clientid}",
                      "username": q.get("u"), "protocol": "coap",
                      "peername": addr}
        if not await self.ctx.authenticate(clientinfo, q.get("p")):
            self._reply(addr, req, UNAUTHORIZED)
            return
        if req.code in (PUT, POST):
            if not await self.ctx.authorize(clientinfo, "publish", topic):
                self._reply(addr, req, UNAUTHORIZED)
                return
            qos = int(q.get("qos", 0))
            retain = q.get("retain") in ("1", "true")
            self.ctx.publish(clientid, topic, req.payload, qos=qos,
                             retain=retain)
            self._reply(addr, req, CHANGED)
        elif req.code == GET:
            obs = req.opt(OPT_OBSERVE)
            if obs is None:
                self._reply(addr, req, METHOD_NOT_ALLOWED)
                return
            obs_val = int.from_bytes(obs, "big") if obs else 0
            key = (addr, bytes(req.token))
            if obs_val == 0:
                if not await self.ctx.authorize(clientinfo, "subscribe",
                                                topic):
                    self._reply(addr, req, UNAUTHORIZED)
                    return
                prev = self.observers.pop(key, None)
                if prev is not None and prev.sid is not None:
                    # retransmitted observe: the old registration must go
                    self.ctx.unregister_subscriber(prev.sid)
                ob = _Observer(self, addr, bytes(req.token), clientid,
                               topic)
                ob.sid = self.ctx.register_subscriber(ob, clientid)
                self.ctx.subscribe(ob.sid, topic,
                                   {"qos": int(q.get("qos", 0))})
                self.observers[key] = ob
                self._reply(addr, req, CONTENT,
                            options=[(OPT_OBSERVE, _obs_bytes(1))])
            else:   # observe deregister
                ob = self.observers.pop(key, None)
                if ob is not None and ob.sid is not None:
                    self.ctx.unregister_subscriber(ob.sid)
                self._reply(addr, req, CONTENT)
        elif req.code == DELETE:
            self._cancel_all(addr, topic)
            self._reply(addr, req, DELETED)
        else:
            self._reply(addr, req, METHOD_NOT_ALLOWED)

    def _cancel_all(self, addr, topic: Optional[str] = None) -> None:
        for key, ob in list(self.observers.items()):
            if key[0] == addr and (topic is None or ob.topic == topic):
                if ob.sid is not None:
                    self.ctx.unregister_subscriber(ob.sid)
                del self.observers[key]
