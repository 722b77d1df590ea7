"""MQTT-SN 1.2 gateway (UDP).

Parity: apps/emqx_gateway/src/mqttsn — message codec (emqx_sn_frame.erl),
gateway FSM (emqx_sn_gateway.erl): CONNECT/CONNACK, topic REGISTER/REGACK
with per-client alias registry, PUBLISH with normal/predefined/short topic
ids and QoS 0/1/2 plus QoS -1 (publish without connection), SUBSCRIBE with
wildcard names (topic id assigned on first matching REGISTER-less deliver),
sleeping clients (DISCONNECT with duration buffers messages, PINGREQ
drains), SEARCHGW/GWINFO and periodic ADVERTISE.
"""

from __future__ import annotations

import asyncio
import struct
import time
import uuid
from typing import Optional

from emqx_tpu_torch.gateway.ctx import GatewayCtx
from emqx_tpu_torch.utils import topic as T

# message types (MQTT-SN spec 5.2.1)
ADVERTISE = 0x00
SEARCHGW = 0x01
GWINFO = 0x02
CONNECT = 0x04
CONNACK = 0x05
WILLTOPICREQ = 0x06
WILLTOPIC = 0x07
WILLMSGREQ = 0x08
WILLMSG = 0x09
REGISTER = 0x0A
REGACK = 0x0B
PUBLISH = 0x0C
PUBACK = 0x0D
PUBCOMP = 0x0E
PUBREC = 0x0F
PUBREL = 0x10
SUBSCRIBE = 0x12
SUBACK = 0x13
UNSUBSCRIBE = 0x14
UNSUBACK = 0x15
PINGREQ = 0x16
PINGRESP = 0x17
DISCONNECT = 0x18

# flags
FLAG_DUP = 0x80
FLAG_QOS = 0x60
FLAG_RETAIN = 0x10
FLAG_WILL = 0x08
FLAG_CLEAN = 0x04
FLAG_TOPIC_TYPE = 0x03
TOPIC_NORMAL = 0
TOPIC_PREDEF = 1
TOPIC_SHORT = 2

RC_ACCEPTED = 0
RC_CONGESTION = 1
RC_INVALID_TOPIC_ID = 2
RC_NOT_SUPPORTED = 3


def qos_of(flags: int) -> int:
    q = (flags & FLAG_QOS) >> 5
    return -1 if q == 3 else q


def encode(msg_type: int, body: bytes) -> bytes:
    n = len(body) + 2
    if n + 2 > 255:
        return b"\x01" + struct.pack(">HB", n + 2, msg_type) + body
    return struct.pack(">BB", n, msg_type) + body


def decode(dgram: bytes) -> tuple[int, bytes]:
    if dgram[0] == 0x01:
        (_n,) = struct.unpack(">H", dgram[1:3])
        return dgram[3], dgram[4:]
    return dgram[1], dgram[2:]


class SnClient:
    """Per-peer state (the reference's per-socket emqx_sn_gateway FSM)."""

    def __init__(self, gw: "MqttSnGateway", addr):
        self.gw = gw
        self.addr = addr
        self.clientid = ""
        self.clientinfo: dict = {}
        self.state = "idle"            # idle|connected|asleep
        self.sid: Optional[int] = None
        # alias registries (both directions)
        self.topic_by_id: dict[int, str] = {}
        self.id_by_topic: dict[str, int] = {}
        self._next_topic_id = 1
        self._next_msg_id = 1
        self.buffered: list = []       # msgs while asleep
        self.awaiting_rel: dict[int, object] = {}   # QoS2 in (msgid -> msg)
        self.last_seen = time.monotonic()
        self.keepalive = 0
        self.will = None               # (topic, payload, qos, retain)

    def alloc_topic_id(self, topic: str) -> int:
        if topic in self.id_by_topic:
            return self.id_by_topic[topic]
        tid = self._next_topic_id
        self._next_topic_id += 1
        self.id_by_topic[topic] = tid
        self.topic_by_id[tid] = topic
        return tid

    def next_msg_id(self) -> int:
        mid = self._next_msg_id
        self._next_msg_id = 1 if mid >= 0xFFFF else mid + 1
        return mid

    # ---- broker subscriber protocol ----
    def deliver(self, topic_filter: str, msg) -> bool:
        if self.state == "asleep":
            self.buffered.append(msg)
            return True
        self._send_publish(msg)
        return True

    def _send_publish(self, msg) -> None:
        topic = msg.topic
        if len(topic) == 2 and not T.wildcard(topic):
            flags_tt, tid_bytes = TOPIC_SHORT, topic.encode()
        elif topic in self.gw.predefined_ids:
            flags_tt = TOPIC_PREDEF
            tid_bytes = struct.pack(">H", self.gw.predefined_ids[topic])
        else:
            tid = self.id_by_topic.get(topic)
            if tid is None:
                tid = self.alloc_topic_id(topic)
                # REGISTER the alias before first use (spec 6.10)
                self.gw.send(self.addr, REGISTER, struct.pack(
                    ">HH", tid, self.next_msg_id()) + topic.encode())
            flags_tt, tid_bytes = TOPIC_NORMAL, struct.pack(">H", tid)
        qos = min(msg.qos, 1)          # QoS2 out simplified to 1 (dev->gw acks)
        flags = (qos << 5) | flags_tt | (FLAG_RETAIN if msg.retain else 0)
        mid = self.next_msg_id() if qos else 0
        self.gw.send(self.addr, PUBLISH,
                     bytes([flags]) + tid_bytes +
                     struct.pack(">H", mid) + msg.payload)


class MqttSnGateway(asyncio.DatagramProtocol):
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        self.conf = conf or {}
        self.ctx = GatewayCtx(node, "mqttsn")
        self.bind = self.conf.get("bind", "127.0.0.1")
        self.port = self.conf.get("port", 1884)
        self.gw_id = self.conf.get("gateway_id", 1)
        # predefined topics: {topic_id: topic_name} from config
        self.predefined: dict[int, str] = {
            int(k): v for k, v in
            (self.conf.get("predefined") or {}).items()}
        self.predefined_ids = {v: k for k, v in self.predefined.items()}
        self.clients: dict[tuple, SnClient] = {}
        self.by_clientid: dict[str, SnClient] = {}
        self.transport = None

    # ---- lifecycle ----
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.bind, self.port))
        if self.port == 0:
            self.port = self.transport.get_extra_info("sockname")[1]
        self._sweeper = loop.create_task(self._sweep_loop())

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            self.sweep()

    def sweep(self) -> None:
        """Keepalive expiry: a silent connected client loses its session
        and its will fires — the abnormal-loss case wills exist for."""
        now = time.monotonic()
        for c in list(self.by_clientid.values()):
            if (c.state == "connected" and c.keepalive
                    and now - c.last_seen > c.keepalive * 1.5):
                self._publish_will(c)
                self._drop(c)

    async def stop(self) -> None:
        if getattr(self, "_sweeper", None):
            self._sweeper.cancel()
        for c in list(self.clients.values()):
            self._drop(c)
        if self.transport:
            self.transport.close()

    def info(self) -> dict:
        return {"listener": f"udp:{self.bind}:{self.port}",
                "current_connections": len(self.by_clientid)}

    def send(self, addr, msg_type: int, body: bytes = b"") -> None:
        if self.transport:
            self.transport.sendto(encode(msg_type, body), addr)

    # ---- datagram entry ----
    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg_type, body = decode(data)
        except (IndexError, struct.error):
            return
        from emqx_tpu_torch.broker.supervise import spawn
        spawn(self._handle(addr, msg_type, body), "mqttsn-handle")

    async def _handle(self, addr, msg_type: int, body: bytes) -> None:
        client = self.clients.get(addr)
        if client is not None:
            client.last_seen = time.monotonic()
        try:
            if msg_type == SEARCHGW:
                self.send(addr, GWINFO, bytes([self.gw_id]))
            elif msg_type == CONNECT:
                await self._on_connect(addr, body)
            elif msg_type == PUBLISH:
                await self._on_publish(addr, client, body)
            elif msg_type == REGISTER:
                self._on_register(addr, client, body)
            elif msg_type == REGACK:
                pass
            elif msg_type == SUBSCRIBE:
                await self._on_subscribe(addr, client, body)
            elif msg_type == UNSUBSCRIBE:
                self._on_unsubscribe(addr, client, body)
            elif msg_type == PINGREQ:
                self._on_pingreq(addr, client, body)
            elif msg_type == DISCONNECT:
                self._on_disconnect(addr, client, body)
            elif msg_type == PUBACK:
                pass
            elif msg_type == PUBREL and client:
                (mid,) = struct.unpack(">H", body[:2])
                msg = client.awaiting_rel.pop(mid, None)
                if msg is not None:
                    self.ctx.publish_msg(msg)
                self.send(addr, PUBCOMP, struct.pack(">H", mid))
            elif msg_type == WILLTOPIC and client:
                self._on_willtopic(addr, client, body)
            elif msg_type == WILLMSG and client:
                self._on_willmsg(addr, client, body)
        except (IndexError, struct.error):
            pass   # malformed datagram: dropped like the reference's parser

    # ---- handlers ----
    async def _on_connect(self, addr, body: bytes) -> None:
        flags, _proto, duration = body[0], body[1], \
            struct.unpack(">H", body[2:4])[0]
        clientid = body[4:].decode("utf-8", "replace") \
            or f"sn-{uuid.uuid4().hex[:10]}"
        client = SnClient(self, addr)
        client.clientid = clientid
        client.keepalive = duration
        client.clientinfo = {"clientid": f"mqttsn:{clientid}",
                             "username": None, "protocol": "mqtt-sn",
                             "peername": addr}
        if not await self.ctx.authenticate(client.clientinfo):
            self.send(addr, CONNACK, bytes([RC_NOT_SUPPORTED]))
            return
        old = self.by_clientid.get(clientid) or self.clients.get(addr)
        if old is not None:
            # duplicate/retransmitted CONNECT (same or new address): the old
            # registration must go or its sid double-delivers
            self._drop(old)
        self.clients[addr] = client
        self.by_clientid[clientid] = client
        client.state = "connected"
        client.sid = self.ctx.register_subscriber(client, clientid)
        self.ctx.register_channel(clientid, client, {"proto": "mqtt-sn"})
        if flags & FLAG_WILL:
            # 3-step will setup (spec 6.3): ask for topic then message
            self.send(addr, WILLTOPICREQ)
        else:
            self.send(addr, CONNACK, bytes([RC_ACCEPTED]))
        self.node.hooks.run("client.connected",
                            (client.clientinfo, {"proto_name": "MQTT-SN"}))

    def _on_willtopic(self, addr, client: SnClient, body: bytes) -> None:
        flags = body[0] if body else 0
        client.will = {"topic": body[1:].decode("utf-8", "replace"),
                       "qos": max(0, qos_of(flags)),
                       "retain": bool(flags & FLAG_RETAIN)}
        self.send(addr, WILLMSGREQ)

    def _on_willmsg(self, addr, client: SnClient, body: bytes) -> None:
        if isinstance(client.will, dict):
            client.will["payload"] = body
        self.send(addr, CONNACK, bytes([RC_ACCEPTED]))

    def _resolve_topic(self, client: Optional[SnClient], tt: int,
                       tid_bytes: bytes) -> Optional[str]:
        if tt == TOPIC_SHORT:
            return tid_bytes.decode("utf-8", "replace")
        (tid,) = struct.unpack(">H", tid_bytes)
        if tt == TOPIC_PREDEF:
            return self.predefined.get(tid)
        if client is None:
            return None
        return client.topic_by_id.get(tid)

    async def _on_publish(self, addr, client: Optional[SnClient],
                          body: bytes) -> None:
        flags = body[0]
        tt = flags & FLAG_TOPIC_TYPE
        tid_bytes, (mid,) = body[1:3], struct.unpack(">H", body[3:5])
        payload = body[5:]
        qos = qos_of(flags)
        if qos == -1:
            # QoS -1: publish with no connection, predefined/short ids only
            topic = self._resolve_topic(None, tt, tid_bytes)
            if topic:
                self.ctx.publish("sn-anonymous", topic, payload, qos=0)
            return
        if client is None or client.state == "idle":
            return
        topic = self._resolve_topic(client, tt, tid_bytes)
        if topic is None:
            self.send(addr, PUBACK,
                      tid_bytes + struct.pack(">H", mid) +
                      bytes([RC_INVALID_TOPIC_ID]))
            return
        if not await self.ctx.authorize(client.clientinfo, "publish",
                                        topic):
            self.send(addr, PUBACK, tid_bytes + struct.pack(">H", mid) +
                      bytes([RC_NOT_SUPPORTED]))
            return
        retain = bool(flags & FLAG_RETAIN)
        if qos == 2:
            from emqx_tpu_torch.broker.message import make
            client.awaiting_rel[mid] = make(
                f"mqttsn:{client.clientid}", 2, topic, payload,
                flags={"retain": retain})
            self.send(addr, PUBREC, struct.pack(">H", mid))
            return
        self.ctx.publish(client.clientid, topic, payload, qos=qos,
                         retain=retain)
        if qos == 1:
            self.send(addr, PUBACK, tid_bytes + struct.pack(">H", mid) +
                      bytes([RC_ACCEPTED]))

    def _on_register(self, addr, client: Optional[SnClient],
                     body: bytes) -> None:
        if client is None:
            return
        _tid, mid = struct.unpack(">HH", body[:4])
        topic = body[4:].decode("utf-8", "replace")
        tid = client.alloc_topic_id(topic)
        self.send(addr, REGACK,
                  struct.pack(">HH", tid, mid) + bytes([RC_ACCEPTED]))

    async def _on_subscribe(self, addr, client: Optional[SnClient],
                            body: bytes) -> None:
        if client is None:
            return
        flags = body[0]
        (mid,) = struct.unpack(">H", body[1:3])
        tt = flags & FLAG_TOPIC_TYPE
        qos = max(0, qos_of(flags))
        tid = 0
        if tt == TOPIC_NORMAL:
            topic = body[3:].decode("utf-8", "replace")
            if not T.wildcard(topic):
                tid = client.alloc_topic_id(topic)
        else:
            topic = self._resolve_topic(client, tt, body[3:5])
            if tt == TOPIC_PREDEF:
                tid = struct.unpack(">H", body[3:5])[0]
        if topic is None or not await self.ctx.authorize(
                client.clientinfo, "subscribe", topic):
            self.send(addr, SUBACK, bytes([flags]) +
                      struct.pack(">HH", 0, mid) +
                      bytes([RC_INVALID_TOPIC_ID]))
            return
        self.ctx.subscribe(client.sid, topic, {"qos": qos})
        self.send(addr, SUBACK, bytes([qos << 5]) +
                  struct.pack(">HH", tid, mid) + bytes([RC_ACCEPTED]))

    def _on_unsubscribe(self, addr, client: Optional[SnClient],
                        body: bytes) -> None:
        if client is None:
            return
        flags = body[0]
        (mid,) = struct.unpack(">H", body[1:3])
        tt = flags & FLAG_TOPIC_TYPE
        topic = body[3:].decode("utf-8", "replace") if tt == TOPIC_NORMAL \
            else self._resolve_topic(client, tt, body[3:5])
        if topic:
            self.ctx.unsubscribe(client.sid, topic)
        self.send(addr, UNSUBACK, struct.pack(">H", mid))

    def _on_pingreq(self, addr, client: Optional[SnClient],
                    body: bytes) -> None:
        if body:   # sleeping client wakes to collect buffered messages
            cid = body.decode("utf-8", "replace")
            client = self.by_clientid.get(cid)
            if client is not None:
                client.addr = addr
                self.clients[addr] = client
                buffered, client.buffered = client.buffered, []
                for m in buffered:
                    client._send_publish(m)
        self.send(addr, PINGRESP)

    def _on_disconnect(self, addr, client: Optional[SnClient],
                       body: bytes) -> None:
        if client is None:
            self.send(addr, DISCONNECT)
            return
        if len(body) >= 2:
            # sleep with duration: keep session + subscriptions, buffer
            client.state = "asleep"
            self.send(addr, DISCONNECT)
            return
        # clean disconnect: the will is NOT published (wills fire only on
        # abnormal loss — keepalive expiry in sweep())
        self._drop(client)
        self.send(addr, DISCONNECT)

    def _publish_will(self, client: SnClient) -> None:
        w = client.will
        if isinstance(w, dict) and "payload" in w and w.get("topic"):
            self.ctx.publish(client.clientid, w["topic"], w["payload"],
                             qos=w.get("qos", 0),
                             retain=w.get("retain", False))

    def _drop(self, client: SnClient) -> None:
        if client.sid is not None:
            self.ctx.unregister_subscriber(client.sid)
            client.sid = None
        self.ctx.unregister_channel(client.clientid, client)
        self.clients.pop(client.addr, None)
        if self.by_clientid.get(client.clientid) is client:
            del self.by_clientid[client.clientid]
        if client.state != "idle":
            client.state = "idle"
            self.node.hooks.run("client.disconnected",
                                (client.clientinfo, "disconnect"))
