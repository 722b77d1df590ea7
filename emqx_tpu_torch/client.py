"""Asyncio MQTT client (v3.1.1 / v5).

Role: the reference bundles the `emqtt` client for conformance suites and
the MQTT data bridge (emqx_bridge_worker.erl); this is the equivalent —
a small, complete client over the same wire codec, used by tests and by
the egress MQTT bridge.

The port's copy of ``emqx_tpu/client.py``, over TCP, TLS (``ssl``) or a
transport of the caller's (``conn_factory``, e.g. WebSocket through
``broker.ws.open_ws_connection``), with the SCRAM enhanced-authentication
exchange (``enable_scram``, ``reauthenticate``).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import FrameParser, serialize
from emqx_tpu_torch.utils.scram import ScramClient
from emqx_tpu_torch.utils.tls import make_client_context


class MqttError(Exception):
    pass


class Client:
    def __init__(self, host: str = "127.0.0.1", port: int = 1883, *,
                 clientid: str = "", username: Optional[str] = None,
                 password: Optional[bytes] = None, clean_start: bool = True,
                 keepalive: int = 0, proto_ver: int = C.MQTT_V4,
                 properties: Optional[dict] = None,
                 will: Optional[P.Will] = None, ssl=None,
                 conn_factory=None):
        # conn_factory: async () -> (reader, writer) for non-TCP
        # transports (WebSocket; the reference's emqtt takes a quic
        # option the same way)
        self._conn_factory = conn_factory
        self.host, self.port = host, port
        # ssl: an ssl.SSLContext, or a dict of emqx-style client tls opts
        if isinstance(ssl, dict):
            ssl = make_client_context(ssl)
        self.ssl = ssl
        self.clientid = clientid
        self.username, self.password = username, password
        self.clean_start = clean_start
        self.keepalive = keepalive
        self.proto_ver = proto_ver
        self.conn_props = properties
        self.will = will

        self.messages: asyncio.Queue[P.Publish] = asyncio.Queue()
        self.connack: Optional[P.Connack] = None
        self.disconnect_pkt: Optional[P.Disconnect] = None
        self._reader = None
        self._writer = None
        self._parser = FrameParser(version=proto_ver)
        self._rx_task: Optional[asyncio.Task] = None
        self._next_pid = 0
        self._acks: dict[int, asyncio.Future] = {}
        self._suback: dict[int, asyncio.Future] = {}
        self.closed = asyncio.Event()
        self.auto_ack = True
        # qos-0 pipelining backpressure (see publish_start): flood loops
        # must `await drain()` at least every `qos0_drain_every`
        # publish_start(qos=0) calls or the transport buffer grows
        # unboundedly (asyncio never blocks a bare write())
        self.qos0_drain_every = 64
        self._q0_undrained = 0
        self._scram = None
        self._scram_mech = ""
        self.scram_server_ok: Optional[bool] = None
        self._reauth_fut: Optional[asyncio.Future] = None

    def enable_scram(self, username: str, password: str,
                     algorithm: str = "sha256") -> None:
        """MQTT5 enhanced authentication: carry SCRAM client-first in
        CONNECT and answer the broker's AUTH challenge."""
        self._scram = ScramClient(username, password, algorithm)
        self._scram_mech = "SCRAM-SHA-" + \
            ("1" if algorithm == "sha1" else algorithm[3:])
        self.conn_props = dict(self.conn_props or {})
        self.conn_props["authentication_method"] = self._scram_mech
        self.conn_props["authentication_data"] = self._scram.first().encode()

    async def reauthenticate(self, username: str, password: str,
                             algorithm: str = "sha256",
                             timeout: float = 5.0) -> bool:
        """AUTH rc=0x19 re-authentication exchange; True on success."""
        self._scram = ScramClient(username, password, algorithm)
        self._scram_mech = "SCRAM-SHA-" + \
            ("1" if algorithm == "sha1" else algorithm[3:])
        self._reauth_fut = asyncio.get_event_loop().create_future()
        self._send(P.Auth(
            reason_code=C.RC_RE_AUTHENTICATE,
            properties={"authentication_method": self._scram_mech,
                        "authentication_data":
                            self._scram.first().encode()}))
        return await asyncio.wait_for(self._reauth_fut, timeout)

    def _alloc(self) -> int:
        self._next_pid = (self._next_pid % C.MAX_PACKET_ID) + 1
        return self._next_pid

    async def connect(self, timeout: float = 5.0) -> P.Connack:
        if self._conn_factory is not None:
            self._reader, self._writer = await self._conn_factory()
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port, ssl=self.ssl)
        pkt = P.Connect(
            proto_name=C.PROTOCOL_NAMES[self.proto_ver],
            proto_ver=self.proto_ver, clean_start=self.clean_start,
            keepalive=self.keepalive, clientid=self.clientid,
            username=self.username, password=self.password,
            will=self.will, properties=self.conn_props)
        self._send(pkt)
        self._rx_task = asyncio.ensure_future(self._rx_loop())
        fut = asyncio.get_event_loop().create_future()
        self._connack_fut = fut
        self.connack = await asyncio.wait_for(fut, timeout)
        if self.connack.reason_code != 0:
            raise MqttError(f"connack rc={self.connack.reason_code}")
        return self.connack

    def _send(self, pkt: P.Packet) -> None:
        if self._writer is None or self._writer.is_closing():
            raise MqttError("not connected")
        self._writer.write(serialize(pkt, self.proto_ver))

    async def _rx_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(65536)
                if not data:
                    break
                for i, pkt in enumerate(self._parser.feed(data)):
                    self._handle(pkt)
                    if i % 64 == 63:
                        # a 64KB read can carry hundreds of deliveries;
                        # yield so co-located tasks (broker in-process
                        # tests/benches) are not starved for the burst
                        await asyncio.sleep(0)
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            self.closed.set()
            for fut in list(self._acks.values()) + list(self._suback.values()):
                if not fut.done():
                    fut.set_exception(MqttError("connection closed"))
            if getattr(self, "_connack_fut", None) and \
                    not self._connack_fut.done():
                self._connack_fut.set_exception(MqttError("closed"))

    def _handle(self, pkt: P.Packet) -> None:
        if isinstance(pkt, P.Connack):
            if self._scram is not None and pkt.reason_code == 0:
                data = (pkt.properties or {}).get("authentication_data")
                self.scram_server_ok = bool(data) and \
                    self._scram.verify_server(bytes(data).decode())
            if not self._connack_fut.done():
                self._connack_fut.set_result(pkt)
        elif isinstance(pkt, P.Auth):
            props = pkt.properties or {}
            if pkt.reason_code == C.RC_CONTINUE_AUTHENTICATION and \
                    self._scram is not None:
                data = bytes(props.get("authentication_data", b""))
                final = self._scram.final(data.decode())
                self._send(P.Auth(
                    reason_code=C.RC_CONTINUE_AUTHENTICATION,
                    properties={"authentication_method": self._scram_mech,
                                "authentication_data": final.encode()}))
            elif pkt.reason_code == 0 and self._reauth_fut is not None:
                data = props.get("authentication_data")
                ok = bool(data) and \
                    self._scram.verify_server(bytes(data).decode())
                if not self._reauth_fut.done():
                    self._reauth_fut.set_result(ok)
                self._reauth_fut = None
        elif isinstance(pkt, P.Publish):
            if pkt.qos == 1 and self.auto_ack:
                self._send(P.Puback(packet_id=pkt.packet_id))
            elif pkt.qos == 2 and self.auto_ack:
                self._send(P.Pubrec(packet_id=pkt.packet_id))
            self.messages.put_nowait(pkt)
        elif isinstance(pkt, (P.Puback, P.Pubcomp)):
            fut = self._acks.pop(pkt.packet_id, None)
            if fut and not fut.done():
                fut.set_result(pkt)
        elif isinstance(pkt, P.Pubrec):
            self._send(P.Pubrel(packet_id=pkt.packet_id))
        elif isinstance(pkt, P.Pubrel):
            if self.auto_ack:
                self._send(P.Pubcomp(packet_id=pkt.packet_id))
        elif isinstance(pkt, (P.Suback, P.Unsuback)):
            fut = self._suback.pop(pkt.packet_id, None)
            if fut and not fut.done():
                fut.set_result(pkt)
        elif isinstance(pkt, P.Pingresp):
            pass
        elif isinstance(pkt, P.Disconnect):
            self.disconnect_pkt = pkt

    async def subscribe(self, topic_filter, qos: int = 0,
                        opts: Optional[dict] = None,
                        properties: Optional[dict] = None,
                        timeout: float = 5.0) -> P.Suback:
        if isinstance(topic_filter, list):
            filters = topic_filter
        else:
            o = dict(opts or {})
            filters = [(topic_filter, P.SubOpts(
                qos=qos, nl=o.get("nl", 0), rap=o.get("rap", 0),
                rh=o.get("rh", 0)))]
        pid = self._alloc()
        fut = asyncio.get_event_loop().create_future()
        self._suback[pid] = fut
        self._send(P.Subscribe(packet_id=pid, filters=filters,
                               properties=properties or {}))
        return await asyncio.wait_for(fut, timeout)

    async def unsubscribe(self, topic_filter,
                          timeout: float = 5.0) -> P.Unsuback:
        filters = topic_filter if isinstance(topic_filter, list) \
            else [topic_filter]
        pid = self._alloc()
        fut = asyncio.get_event_loop().create_future()
        self._suback[pid] = fut
        self._send(P.Unsubscribe(packet_id=pid, filters=filters))
        return await asyncio.wait_for(fut, timeout)

    def publish_start(self, topic: str, payload: bytes = b"", qos: int = 0,
                      retain: bool = False,
                      properties: Optional[dict] = None):
        """Send a PUBLISH without awaiting its ack: for qos>0 returns the
        ack future (await it later — pipelined publishing keeps a flood's
        connections full instead of stalling a round trip per message).

        PIPELINE CONTRACT (qos 0): the return is None and the bytes only
        sit in the transport write buffer — asyncio's write() never
        blocks, so a tight flood loop grows that buffer without bound.
        Callers pipelining qos-0 publishes MUST apply backpressure by
        awaiting `drain()` periodically; `needs_drain` flips True every
        `qos0_drain_every` un-drained qos-0 publishes as the cue:

            cl.publish_start(t, p)            # fire-and-forget
            if cl.needs_drain:
                await cl.drain()              # bounded transport buffer

        qos>0 floods get the same bound for free by awaiting their ack
        futures in windows (the broker acks only what it has read)."""
        if qos == 0:
            self._send(P.Publish(topic=topic, payload=payload, qos=0,
                                 retain=retain, properties=properties))
            self._q0_undrained += 1
            return None
        pid = self._alloc()
        fut = asyncio.get_event_loop().create_future()
        self._acks[pid] = fut
        self._send(P.Publish(topic=topic, payload=payload, qos=qos,
                             retain=retain, packet_id=pid,
                             properties=properties))
        return fut

    @property
    def needs_drain(self) -> bool:
        """True once `qos0_drain_every` qos-0 publishes went un-drained —
        the publish_start pipeline contract's backpressure cue."""
        return self._q0_undrained >= self.qos0_drain_every

    async def drain(self) -> None:
        """Flush the transport write buffer (asyncio flow control): the
        qos-0 pipeline contract's backpressure point. Stalls only while
        the buffer is over the transport's high-water mark."""
        self._q0_undrained = 0
        if self._writer is not None:
            await self._writer.drain()

    async def publish(self, topic: str, payload: bytes = b"", qos: int = 0,
                      retain: bool = False,
                      properties: Optional[dict] = None,
                      timeout: float = 5.0) -> Optional[P.Packet]:
        fut = self.publish_start(topic, payload, qos, retain, properties)
        if fut is None:
            await self.drain()
            return None
        return await asyncio.wait_for(fut, timeout)

    async def recv(self, timeout: float = 5.0) -> P.Publish:
        return await asyncio.wait_for(self.messages.get(), timeout)

    async def ping(self) -> None:
        self._send(P.Pingreq())

    async def disconnect(self, reason_code: int = 0,
                         properties: Optional[dict] = None) -> None:
        try:
            self._send(P.Disconnect(reason_code=reason_code,
                                    properties=properties))
            await self._writer.drain()
        except (MqttError, ConnectionResetError):
            pass
        await self.close()

    async def close(self) -> None:
        if self._rx_task:
            self._rx_task.cancel()
        if self._writer and not self._writer.is_closing():
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001 — best-effort close: the
                pass           # peer may already have reset the socket
        self.closed.set()
