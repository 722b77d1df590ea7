"""MQTT protocol state machine, transport-agnostic.

Parity: emqx_channel.erl — CONNECT pipeline (check → enrich → authenticate →
open session, :285-533), PUBLISH pipeline (quota → alias → authz → caps,
:539-628), SUBSCRIBE with per-filter authz (:427-460,660-691), QoS0/1/2
semantics, will message, keepalive accounting, takeover pendings (:746-790),
and MQTT5 extras (topic alias, assigned clientid, session expiry).

The channel is owned by one connection task; `handle_in(pkt)` returns and
the channel pushes outbound packets through the `send` callback. Broker
deliveries arrive via `deliver()` from the same event loop.

The port's copy of ``emqx_tpu/broker/channel.py``, on the per-packet
ingress path and on the columnar one (``handle_publish_burst``, the
reference's burst hand-off). One change on the per-packet path: a QoS 1/2
PUBLISH does not hold the read loop until it is routed — every PUBLISH of
one socket read enters the batcher, and the acknowledgements follow in
receive order (``flush_acks``), as the burst hand-off acks them; awaiting
each QoS 1 PUBLISH in turn kept a publisher to one message in the batcher
per QoS 1 PUBLISH and the batches too small for the device. The MQTT5
enhanced-authentication exchange (a CONNECT naming an
``authentication_method``, AUTH 0x18 to continue, AUTH 0x19 to
re-authenticate) runs through the authenticators the authn chain
registers in ``node.enhanced_authn`` (``apps/authn_db.ScramAuthenticator``);
a method none serves is refused with 0x8C. A TLS listener's client
certificate (``conninfo["peercert"]``) names the username or clientid under
the zone's ``peer_cert_as_username`` / ``peer_cert_as_clientid``. On a node
without a batcher (``device_route: false``) a burst's rows take the host
per-message path in row order, as ``publish_async`` would. The overload governor's admission gate is ported: while it
pauses connects, a CONNECT is answered with reason 0x97.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Optional

from emqx_tpu_torch.broker.message import (Message, guid_batch, make,
                                           now_ms)
from emqx_tpu_torch.broker.mqueue import MQueueOpts
from emqx_tpu_torch.broker.session import Session, SessionConf, SessionError
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.utils import topic as T
from emqx_tpu_torch.utils.logger import set_metadata_clientid
from emqx_tpu_torch.utils.tls import cert_field


class ParkedSubscriber:
    """Deliver target for a detached persistent session: enqueue only
    (the reference's disconnected-state channel, emqx_channel handle_deliver
    while conn_state=disconnected)."""

    def __init__(self, session, node):
        self.session = session
        self.node = node

    def deliver(self, topic_filter: str, msg) -> bool:
        if msg.is_expired():
            self.node.metrics.inc("delivery.dropped")
            self.node.metrics.inc("delivery.dropped.expired")
            return True
        self.session.enqueue([(msg, msg.headers.get("subopts", {}))])
        return True

    def deliver_batch(self, items: list) -> int:
        """Coalesced same-session run (the delivery lanes): one mqueue
        append pass for the whole run. All-or-none accept."""
        pairs = []
        for _f, msg in items:
            if msg.is_expired():
                self.node.metrics.inc("delivery.dropped")
                self.node.metrics.inc("delivery.dropped.expired")
                continue
            pairs.append((msg, msg.headers.get("subopts", {})))
        if pairs:
            self.session.enqueue(pairs)
        return len(items)


CONN_IDLE = "idle"
CONN_CONNECTING = "connecting"
CONN_CONNECTED = "connected"
CONN_TAKING_OVER = "taking_over"
CONN_DISCONNECTED = "disconnected"

_ASSIGNED_SEQ = iter(range(1, 1 << 62))


class ProtocolError(Exception):
    def __init__(self, rc: int, detail: str = ""):
        self.rc = rc
        super().__init__(f"protocol error rc=0x{rc:02x} {detail}")


def session_conf_from(mqtt: dict, expiry_interval: int) -> SessionConf:
    return SessionConf(
        max_subscriptions=mqtt.get("max_subscriptions", 0),
        upgrade_qos=mqtt.get("upgrade_qos", False),
        retry_interval=mqtt.get("retry_interval", 30),
        max_awaiting_rel=mqtt.get("max_awaiting_rel", 100),
        await_rel_timeout=mqtt.get("await_rel_timeout", 300),
        session_expiry_interval=expiry_interval,
        max_inflight=mqtt.get("max_inflight", 32),
        mqueue=MQueueOpts(
            max_len=mqtt.get("max_mqueue_len", 1000),
            store_qos0=mqtt.get("mqueue_store_qos0", True),
            priorities=mqtt.get("mqueue_priorities", {}),
            default_priority=mqtt.get("mqueue_default_priority", "lowest")))


class Channel:
    def __init__(self, node, conninfo: dict,
                 send: Callable[[list[P.Packet]], None],
                 close: Callable[[str], None]):
        self.node = node
        self.conninfo = conninfo        # peername, sockname, ws?, zone
        self.send = send
        self.close = close
        self.conn_state = CONN_IDLE
        self.zone = conninfo.get("zone")
        self.mqtt = node.config.mqtt(self.zone)
        from emqx_tpu_torch.broker.limiter import QuotaLimiter
        self.quota = QuotaLimiter(
            (node.config.get_zone(self.zone, "rate_limit") or {})
            .get("quota_messages_routing") or None)

        self.proto_ver = C.MQTT_V4
        self.clientinfo: dict = {}
        self.clientid: str = ""
        self.session: Optional[Session] = None
        self.sid: Optional[int] = None  # broker subscriber id
        self.keepalive: int = 0
        self.will_msg: Optional[Message] = None
        self.alias_in: dict[int, str] = {}   # v5 inbound topic aliases
        self.alias_out: dict[str, int] = {}  # v5 outbound: topic -> alias
        self.alias_out_max = 0               # client's Topic-Alias-Maximum
        self.connected_at: int = 0
        self.disconnect_reason: Optional[str] = None
        self._aborted = False     # server-initiated DISCONNECT sent; no
                                  # further packets may go out (MQTT-3.14)
        self._pendings: list[Message] = []   # deliveries during takeover
        self.mountpoint: Optional[str] = None
        # QoS 1/2 acks owed, in receive order: (count future, packet
        # class, packet id), (None, packet, None) for a ready one, or
        # (None, None, (rc, detail)) for a DISCONNECT queued behind them
        self._acks: deque = deque()
        self._enh: Optional[dict] = None     # enhanced-auth exchange state
        self._enh_connack_props: Optional[dict] = None

    # ================= inbound dispatch =================
    async def handle_in(self, pkt: P.Packet) -> None:
        m = self.node.metrics
        name = type(pkt).__name__.lower()
        if isinstance(pkt, P.Connect):
            m.inc_recv("connect")
            await self._handle_connect(pkt)
        elif isinstance(pkt, P.Auth) and self._enh is not None:
            # mid-exchange AUTH is legal while still CONNECTING
            m.inc_recv("auth")
            await self._handle_auth(pkt)
        elif self.conn_state != CONN_CONNECTED:
            raise ProtocolError(C.RC_PROTOCOL_ERROR,
                                f"{name} before CONNECT")
        elif isinstance(pkt, P.Publish):
            m.inc_recv("publish")
            await self._handle_publish(pkt)
        elif isinstance(pkt, P.Puback):
            m.inc_recv("puback")
            self._handle_puback(pkt)
        elif isinstance(pkt, P.Pubrec):
            m.inc_recv("pubrec")
            self._handle_pubrec(pkt)
        elif isinstance(pkt, P.Pubrel):
            m.inc_recv("pubrel")
            self._handle_pubrel(pkt)
        elif isinstance(pkt, P.Pubcomp):
            m.inc_recv("pubcomp")
            self._handle_pubcomp(pkt)
        elif isinstance(pkt, P.Subscribe):
            m.inc_recv("subscribe")
            await self._handle_subscribe(pkt)
        elif isinstance(pkt, P.Unsubscribe):
            m.inc_recv("unsubscribe")
            self._handle_unsubscribe(pkt)
        elif isinstance(pkt, P.Pingreq):
            m.inc_recv("pingreq")
            self._send([P.Pingresp()])
        elif isinstance(pkt, P.Disconnect):
            m.inc_recv("disconnect")
            self._handle_disconnect(pkt)
        elif isinstance(pkt, P.Auth):
            m.inc_recv("auth")
            await self._handle_auth(pkt)
        else:
            raise ProtocolError(C.RC_PROTOCOL_ERROR, f"unexpected {name}")

    def _send(self, pkts: list[P.Packet]) -> None:
        if self._aborted:
            return
        for p in pkts:
            self.node.metrics.inc_sent(type(p).__name__.lower())
        self.send(pkts)

    # ================= CONNECT =================
    async def _handle_connect(self, pkt: P.Connect) -> None:
        if self.conn_state != CONN_IDLE:
            raise ProtocolError(C.RC_PROTOCOL_ERROR, "duplicate CONNECT")
        self.conn_state = CONN_CONNECTING
        self.proto_ver = pkt.proto_ver
        self.node.metrics.inc("client.connect")
        self.node.hooks.run("client.connect", (self._conninfo_map(pkt),))

        # --- check: protocol version / clientid (emqx_channel check_connect)
        if pkt.proto_ver not in (C.MQTT_V3, C.MQTT_V4, C.MQTT_V5):
            return self._connack_error(C.RC_UNSUPPORTED_PROTOCOL_VERSION)

        # --- overload admission gate (the governor's pause_connects
        #     action): at grade overload and above a new CONNECT is
        #     refused with the v5 reason 0x97 (quota exceeded; the
        #     serializer downgrades it for v3/v4 clients). Existing
        #     sessions are untouched; recovery re-admits.
        gov = getattr(self.node, "overload_governor", None)
        if gov is not None and gov.connects_paused:
            gov.count_connect_rejected()
            return self._connack_error(C.RC_QUOTA_EXCEEDED)
        clientid = pkt.clientid
        if not clientid:
            if pkt.proto_ver < C.MQTT_V5 and not pkt.clean_start:
                return self._connack_error(C.RC_CLIENT_IDENTIFIER_NOT_VALID)
            clientid = f"emqx_tpu_{next(_ASSIGNED_SEQ)}_{now_ms()}"
            self._assigned_clientid = clientid
        else:
            self._assigned_clientid = None
        if len(clientid) > self.mqtt.get("max_clientid_len", 65535):
            return self._connack_error(C.RC_CLIENT_IDENTIFIER_NOT_VALID)

        props = pkt.properties or {}
        if pkt.proto_ver == C.MQTT_V5:
            expiry = props.get("session_expiry_interval", 0)
        else:
            expiry = (self.mqtt.get("session_expiry_interval", 7200)
                      if not pkt.clean_start else 0)

        if self.mqtt.get("use_username_as_clientid") and pkt.username:
            clientid = pkt.username
        # TLS peer-cert enrichment (emqx_channel peer_cert_as_username/
        # clientid zone opts; cert fields via utils.tls.cert_field)
        username = pkt.username
        peercert = self.conninfo.get("peercert")
        if peercert:
            src = self.mqtt.get("peer_cert_as_username")
            if src:
                username = cert_field(peercert, src) or username
            src = self.mqtt.get("peer_cert_as_clientid")
            if src:
                clientid = cert_field(peercert, src) or clientid
        self.clientid = clientid
        self.clientinfo = {
            "clientid": clientid, "username": username,
            "peername": self.conninfo.get("peername"),
            "sockname": self.conninfo.get("sockname"),
            "proto_ver": pkt.proto_ver, "proto_name": pkt.proto_name,
            "clean_start": pkt.clean_start, "keepalive": pkt.keepalive,
            "zone": self.zone, "mountpoint": None,
            "is_bridge": getattr(pkt, "is_bridge", False),
            "connected_at": now_ms(),
            "conn_props": props,
        }

        # --- will capability caps (emqx_mqtt_caps check via emqx_channel
        #     check_connect: a will above the zone's QoS/retain caps refuses
        #     the CONNECT outright — MQTT-3.2.2-12 / MQTT-3.2.2-13)
        if pkt.will is not None:
            if pkt.will.qos > self.mqtt.get("max_qos_allowed", 2):
                return self._connack_error(C.RC_QOS_NOT_SUPPORTED)
            if pkt.will.retain and not self.mqtt.get("retain_available",
                                                     True):
                return self._connack_error(C.RC_RETAIN_NOT_SUPPORTED)

        # --- banned check (emqx_banned:check in emqx_channel:authenticate)
        banned = getattr(self.node, "banned", None)
        if banned is not None and banned.check(self.clientinfo):
            return self._connack_error(C.RC_BANNED)

        # --- enhanced authentication (MQTT5 AUTH exchange, emqx_channel
        #     enhanced_auth/authenticate: the authentication_method CONNECT
        #     property switches to a SASL-style challenge flow)
        auth_method = (props.get("authentication_method")
                       if pkt.proto_ver == C.MQTT_V5 else None)
        if auth_method is not None:
            enh = getattr(self.node, "enhanced_authn", {}).get(auth_method)
            if enh is None:
                return self._connack_error(C.RC_BAD_AUTHENTICATION_METHOD)
            data = props.get("authentication_data", b"")
            try:
                challenge, st = enh.begin_enhanced_auth(data)
            except Exception:  # noqa: BLE001 (ScramError and malformed)
                self.node.metrics.inc("packets.connack.auth_error")
                return self._connack_error(C.RC_NOT_AUTHORIZED)
            self._enh = {"method": auth_method, "auth": enh, "state": st,
                         "pkt": pkt, "expiry": expiry, "reauth": False}
            self._send([P.Auth(
                reason_code=C.RC_CONTINUE_AUTHENTICATION,
                properties={"authentication_method": auth_method,
                            "authentication_data": challenge})])
            return

        # --- authenticate (hooks chain; default allow)
        self.node.metrics.inc("client.authenticate")
        auth_result = await self.node.hooks.run_fold_async(
            "client.authenticate", (self.clientinfo,),
            {"ok": True, "password": pkt.password})
        if not (isinstance(auth_result, dict) and auth_result.get("ok")):
            self.node.metrics.inc("packets.connack.auth_error")
            rc = (auth_result or {}).get("rc", C.RC_NOT_AUTHORIZED) \
                if isinstance(auth_result, dict) else C.RC_NOT_AUTHORIZED
            return self._connack_error(rc)
        if isinstance(auth_result, dict):
            self.clientinfo.update(
                {k: v for k, v in auth_result.items()
                 if k in ("is_superuser", "mountpoint", "username", "acl")})
        self.mountpoint = self.clientinfo.get("mountpoint")
        if self.mountpoint:
            self.mountpoint = T.feed_var(
                "%c", self.clientid,
                T.feed_var("%u", self.clientinfo.get("username") or "",
                           self.mountpoint))
            self.clientinfo["mountpoint"] = self.mountpoint

        await self._continue_connect(pkt, expiry)

    async def _continue_connect(self, pkt: P.Connect, expiry: int) -> None:
        """CONNECT pipeline after authentication succeeded (the reference's
        process_connect half of emqx_channel handle_in CONNECT)."""
        clientid = self.clientid
        props = pkt.properties or {}
        set_metadata_clientid(clientid)
        # --- will message
        if pkt.will is not None:
            self.will_msg = make(
                clientid, pkt.will.qos, self._mount(pkt.will.topic),
                pkt.will.payload, flags={"retain": pkt.will.retain},
                headers={"username": pkt.username,
                         "properties": pkt.will.properties or {}})

        # --- keepalive (server may override, v5 server_keep_alive)
        server_ka = self.mqtt.get("server_keepalive", 0)
        self.keepalive = server_ka or pkt.keepalive

        # --- open session (clean-start discard / takeover)
        conf = session_conf_from(self.mqtt, expiry)
        if pkt.proto_ver == C.MQTT_V5:
            # MQTT-3.3.4-9: never exceed the client's Receive Maximum
            rm = props.get("receive_maximum")
            if rm:
                conf.max_inflight = min(conf.max_inflight, int(rm))
        session, present = await self.node.cm.open_session(
            pkt.clean_start, clientid, conf, self)
        session.inflight.max_size = conf.max_inflight
        session.on_dropped = self._delivery_dropped
        self.session = session
        if present:
            self.node.metrics.inc("session.resumed")
            self.node.hooks.run("session.resumed",
                                (self.clientinfo, session))
        else:
            self.node.metrics.inc("session.created")
            self.node.hooks.run("session.created",
                                (self.clientinfo, session))

        # --- register + connack
        self.node.cm.register_channel(clientid, self, self.info())
        parked_sid = getattr(session, "parked_sid", None)
        if parked_sid is not None:
            # re-attach to the parked session's live broker subscriptions
            self.sid = parked_sid
            session.parked_sid = None
            self.node.broker.swap_subscriber(self.sid, self)
        else:
            self.sid = self.node.broker.register(self, clientid)
            # resumed (takenover) sessions re-install routes under new sid
            for f, opts in list(session.subscriptions.items()):
                self.node.broker.subscribe(
                    self.sid, f,
                    {k: v for k, v in opts.items() if k != "share"})
        self.conn_state = CONN_CONNECTED
        self.connected_at = now_ms()
        self.node.metrics.inc("client.connected")
        self.node.hooks.run("client.connected", (self.clientinfo, self.info()))

        # --- outbound topic aliasing (emqx_channel packing_alias): the
        #     client's Topic-Alias-Maximum caps how many aliases WE may
        #     assign on deliveries to it
        self.alias_out_max = int(props.get("topic_alias_maximum", 0)) \
            if pkt.proto_ver == C.MQTT_V5 else 0

        ack_props = None
        if pkt.proto_ver == C.MQTT_V5:
            ack_props = {
                "session_expiry_interval": expiry,
                # the broker's own inbound window (zone max_inflight), NOT
                # the client-RM-capped outbound window
                "receive_maximum": self.mqtt.get("max_inflight", 32),
                "retain_available": int(self.mqtt.get("retain_available", True)),
                "maximum_packet_size": self.mqtt.get("max_packet_size"),
                "topic_alias_maximum": self.mqtt.get("max_topic_alias", 65535),
                "wildcard_subscription_available":
                    int(self.mqtt.get("wildcard_subscription", True)),
                "subscription_identifier_available": 1,
                "shared_subscription_available":
                    int(self.mqtt.get("shared_subscription", True)),
            }
            # MQTT-3.2.2-9: Maximum-QoS is only sent when the broker caps
            # below 2 (absence means the full range is supported)
            if self.mqtt.get("max_qos_allowed", 2) < 2:
                ack_props["maximum_qos"] = self.mqtt["max_qos_allowed"]
            if server_ka:
                ack_props["server_keep_alive"] = server_ka
            if self._assigned_clientid:
                ack_props["assigned_client_identifier"] = clientid
            if self._enh_connack_props:
                ack_props.update(self._enh_connack_props)
                self._enh_connack_props = None
        self.node.metrics.inc("client.connack")
        self.node.hooks.run("client.connack",
                            (self.clientinfo, C.RC_SUCCESS))
        self._send([P.Connack(session_present=present,
                              reason_code=C.RC_SUCCESS,
                              properties=ack_props)])
        # replay resumed session state
        if present:
            self._send_replay(session.replay())

    # ================= AUTH (MQTT5 enhanced authentication) =============
    async def _handle_auth(self, pkt: P.Auth) -> None:
        """Continue/complete a SASL exchange (emqx_channel handle_in AUTH:
        RC 0x18 continue, 0x19 re-authenticate from a connected client)."""
        props = pkt.properties or {}
        method = props.get("authentication_method")
        if pkt.reason_code == C.RC_RE_AUTHENTICATE and \
                self.conn_state == CONN_CONNECTED and self._enh is None:
            enh = getattr(self.node, "enhanced_authn", {}).get(method)
            if enh is None:
                return self._disconnect_now(C.RC_BAD_AUTHENTICATION_METHOD)
            try:
                challenge, st = enh.begin_enhanced_auth(
                    props.get("authentication_data", b""))
            except Exception:  # noqa: BLE001
                return self._disconnect_now(C.RC_NOT_AUTHORIZED)
            self._enh = {"method": method, "auth": enh, "state": st,
                         "pkt": None, "expiry": 0, "reauth": True}
            return self._send([P.Auth(
                reason_code=C.RC_CONTINUE_AUTHENTICATION,
                properties={"authentication_method": method,
                            "authentication_data": challenge})])
        if self._enh is None or \
                pkt.reason_code != C.RC_CONTINUE_AUTHENTICATION:
            raise ProtocolError(C.RC_PROTOCOL_ERROR, "unexpected AUTH")
        if method is not None and method != self._enh["method"]:
            raise ProtocolError(C.RC_BAD_AUTHENTICATION_METHOD,
                                "AUTH method changed mid-exchange")
        enh, st = self._enh["auth"], self._enh["state"]
        try:
            server_final, extra = enh.continue_enhanced_auth(
                props.get("authentication_data", b""), st)
        except Exception:  # noqa: BLE001 (ScramError: bad proof)
            self.node.metrics.inc("client.auth.failure")
            reauth = self._enh["reauth"]
            self._enh = None
            if reauth:
                return self._disconnect_now(C.RC_NOT_AUTHORIZED)
            return self._connack_error(C.RC_NOT_AUTHORIZED)
        self.node.metrics.inc("client.auth.success")
        state = self._enh
        self._enh = None
        auth_props = {"authentication_method": state["method"],
                      "authentication_data": server_final}
        if state["reauth"]:
            return self._send([P.Auth(reason_code=C.RC_SUCCESS,
                                      properties=auth_props)])
        self.clientinfo.update(
            {k: v for k, v in extra.items()
             if k in ("is_superuser", "username", "acl")})
        self._enh_connack_props = auth_props
        await self._continue_connect(state["pkt"], state["expiry"])


    def _connack_error(self, rc: int) -> None:
        self.node.metrics.inc("packets.connack.error")
        self.node.hooks.run("client.connack", (self.clientinfo, rc))
        # always the v5 code here; the serializer downgrades for v3 clients
        self._send([P.Connack(session_present=False, reason_code=rc)])
        self.close(f"connack_error_0x{rc:02x}")

    # ================= PUBLISH =================
    def _mount(self, topic: str) -> str:
        return T.prepend(self.mountpoint, topic)

    def _unmount(self, topic: str) -> str:
        if self.mountpoint and topic.startswith(self.mountpoint):
            return topic[len(self.mountpoint):]
        return topic

    async def _handle_publish(self, pkt: P.Publish) -> None:
        topic = pkt.topic
        # v5 topic alias resolution (emqx_channel packet_to_message)
        props = pkt.properties or {}
        alias = props.pop("topic_alias", None) if props else None
        # the publisher's alias is connection-scoped: it must never leak
        # into the routed message (a subscriber's alias space is its own —
        # the reference strips it in packet_to_message the same way)
        if self.proto_ver == C.MQTT_V5 and alias is not None:
            if not (0 < alias <= self.mqtt.get("max_topic_alias", 65535)):
                return self._disconnect_now(C.RC_TOPIC_ALIAS_INVALID)
            if topic:
                self.alias_in[alias] = topic
            else:
                topic = self.alias_in.get(alias)
                if topic is None:
                    return self._disconnect_now(C.RC_PROTOCOL_ERROR,
                                                "unknown topic alias")
        try:
            valid = bool(topic) and T.validate(topic, "name")
        except T.TopicError:
            valid = False       # wildcard/too-long/bad-level topic NAME
        if not valid:
            return self._puberr(pkt, C.RC_TOPIC_NAME_INVALID)
        if self.proto_ver == C.MQTT_V5 and props.get("response_topic") \
                and T.wildcard(props["response_topic"]):
            # MQTT-3.3.2-14: a Response Topic must not contain wildcards
            return self._disconnect_now(C.RC_PROTOCOL_ERROR,
                                        "wildcard response topic")
        if pkt.qos > self.mqtt.get("max_qos_allowed", 2):
            # MQTT-3.2.2-11: publishing above the broker's Maximum QoS is
            # a DISCONNECT-worthy offence, not a per-packet nack
            return self._disconnect_now(C.RC_QOS_NOT_SUPPORTED)
        if pkt.retain and not self.mqtt.get("retain_available", True):
            return self._puberr(pkt, C.RC_RETAIN_NOT_SUPPORTED)

        # quota (emqx_channel process_publish pipeline: check_quota first)
        if not self.quota.check_publish():
            self.node.metrics.inc("packets.publish.quota_exceeded")
            return self._puberr(pkt, C.RC_QUOTA_EXCEEDED)

        # authz (emqx_channel check_pub_authz)
        if not await self._authorize("publish", topic):
            self.node.metrics.inc("packets.publish.auth_error")
            if self._aborted:       # deny_action=disconnect: no PUBACK after
                return              # the DISCONNECT went out
            return self._puberr(pkt, C.RC_NOT_AUTHORIZED)

        msg = make(self.clientid, pkt.qos, self._mount(topic), pkt.payload,
                   flags={"retain": pkt.retain, "dup": pkt.dup},
                   headers={"username": self.clientinfo.get("username"),
                            "peername": self.conninfo.get("peername"),
                            "properties": props,
                            "proto_ver": self.proto_ver})
        if pkt.ingress_ns:
            # the frame-decode clock rides the message (read by no layer
            # of the port yet)
            msg.ingress_ns = pkt.ingress_ns
        self.node.metrics.inc_msg_recv(pkt.qos)

        if pkt.qos == C.QOS_0:
            if not self.node.publish_nowait(msg):
                await self.node.publish_async(msg)
        elif pkt.qos == C.QOS_1:
            self._acks.append((self.node.publish_future(msg), P.Puback,
                               pkt.packet_id))
        else:
            # QoS2: publish immediately, track the packet id in awaiting_rel
            # purely for duplicate suppression until PUBREL — the reference's
            # method (emqx_session:publish/3); avoids buffering payloads
            try:
                self.session.publish_qos2(pkt.packet_id)
            except SessionError as e:
                self.node.metrics.inc("packets.publish.dropped")
                self._ack_now(P.Pubrec(packet_id=pkt.packet_id,
                                       reason_code=e.rc))
                return
            self._acks.append((self.node.publish_future(msg), P.Pubrec,
                               pkt.packet_id))

    async def handle_publish_burst(self, burst) -> None:
        """Columnar-ingress PUBLISH hand-off: one call per
        PublishBurst replaces burst-many handle_in(Publish) calls.

        Every row runs the same check pipeline as _handle_publish —
        alias resolution, topic validation, response-topic/max-qos/
        retain caps, quota, authz, QoS dispatch — but the per-row work
        is amortized: topic-validation and authz verdicts are memoized
        per unique topic WITHIN the burst (the reference's
        emqx_authz_cache caches authz per connection the same way), the
        packet/message counters are incremented once per burst, and all
        surviving rows enter the batcher through ONE submit_burst call
        (QoS0 rows without per-message futures). Acks — and any
        deferred per-row error ack or DISCONNECT — go out strictly in
        row order after submission, once each QoS>=1 row's delivery
        count resolves through the batcher's normal journal/settle
        machinery. Per-publisher delivery order is the batcher FIFO =
        row order, so order and counts are bit-identical to the
        per-packet path (the A/B twin test pins this)."""
        if self.conn_state != CONN_CONNECTED:
            raise ProtocolError(C.RC_PROTOCOL_ERROR,
                                "publish before CONNECT")
        if self._acks:
            # acks owed to earlier per-packet PUBLISHes of this read go
            # out before the burst's own
            await self.flush_acks()
        node = self.node
        m = node.metrics
        n = len(burst.topics)
        m.inc("packets.received", n)
        m.inc("packets.publish.received", n)
        v5 = self.proto_ver == C.MQTT_V5
        max_alias = self.mqtt.get("max_topic_alias", 65535)
        max_qos = self.mqtt.get("max_qos_allowed", 2)
        retain_ok = self.mqtt.get("retain_available", True)
        mount = self.mountpoint
        base_headers = {"username": self.clientinfo.get("username"),
                        "peername": self.conninfo.get("peername"),
                        "proto_ver": self.proto_ver}
        valid_memo: dict = {}
        auth_memo: dict = {}
        rows: list = []        # (Message, needs_count) for submit_burst
        seq: list = []         # ordered ack/disconnect plan
        qos_counts = [0, 0, 0]
        # one locked GUID pass + one clock read for the whole burst
        # (rows that fail a check burn an id — ids only need to be
        # unique and monotone, which a batch reservation preserves)
        ids = guid_batch(n)
        ts_ms = now_ms()
        clientid = self.clientid
        for j in range(n):
            if j and not j % 64:
                # the handle_in loop's pacing: a read can carry hundreds
                # of frames; yield so other tasks are not stalled
                await asyncio.sleep(0)
            topic = burst.topics[j]
            qos = burst.qos[j]
            props = burst.props[j]
            pid = burst.pids[j]
            retain = burst.retain[j]
            alias = props.pop("topic_alias", None) if props else None
            if v5 and alias is not None:
                if not (0 < alias <= max_alias):
                    seq.append(("disc", C.RC_TOPIC_ALIAS_INVALID, ""))
                    continue
                if topic:
                    self.alias_in[alias] = topic
                else:
                    topic = self.alias_in.get(alias)
                    if topic is None:
                        seq.append(("disc", C.RC_PROTOCOL_ERROR,
                                    "unknown topic alias"))
                        continue
            valid = valid_memo.get(topic)
            if valid is None:
                try:
                    valid = bool(topic) and T.validate(topic, "name")
                except T.TopicError:
                    valid = False
                valid_memo[topic] = valid
            if not valid:
                self._burst_puberr(seq, qos, pid, C.RC_TOPIC_NAME_INVALID)
                continue
            if v5 and props.get("response_topic") \
                    and T.wildcard(props["response_topic"]):
                seq.append(("disc", C.RC_PROTOCOL_ERROR,
                            "wildcard response topic"))
                continue
            if qos > max_qos:
                seq.append(("disc", C.RC_QOS_NOT_SUPPORTED, ""))
                continue
            if retain and not retain_ok:
                self._burst_puberr(seq, qos, pid,
                                   C.RC_RETAIN_NOT_SUPPORTED)
                continue
            if not self.quota.check_publish():
                m.inc("packets.publish.quota_exceeded")
                self._burst_puberr(seq, qos, pid, C.RC_QUOTA_EXCEEDED)
                continue
            ok = auth_memo.get(topic)
            if ok is None:
                ok = await self._authorize("publish", topic)
                auth_memo[topic] = ok
            if not ok:
                m.inc("packets.publish.auth_error")
                if not self._aborted:
                    self._burst_puberr(seq, qos, pid,
                                       C.RC_NOT_AUTHORIZED)
                continue
            if qos == C.QOS_2:
                try:
                    self.session.publish_qos2(pid)
                except SessionError as e:
                    m.inc("packets.publish.dropped")
                    seq.append(("err", P.Pubrec(packet_id=pid,
                                                reason_code=e.rc)))
                    continue
            # direct construction: the dataclass __init__/__post_init__
            # machinery is ~half the per-row cost at this point, and
            # every field is explicit here (ids/ts pre-reserved above)
            msg = Message.__new__(Message)
            msg.__dict__ = {
                "topic": T.prepend(mount, topic) if mount else topic,
                "payload": burst.payloads[j], "qos": qos,
                "from_": clientid,
                "flags": {"retain": retain, "dup": burst.dup[j]},
                "headers": dict(base_headers, properties=props),
                "id": ids[j], "ts": ts_ms, "extra": {},
                # the burst's one frame-decode clock read, attributed
                # per row (as the per-packet path carries
                # pkt.ingress_ns)
                "ingress_ns": burst.ingress_ns,
            }
            qos_counts[qos] += 1
            rows.append((msg, qos > 0))
            if qos:
                seq.append(("ack", qos, pid, len(rows) - 1))
        for q in (0, 1, 2):
            if qos_counts[q]:
                m.inc("messages.received", qos_counts[q])
                m.inc(f"messages.qos{q}.received", qos_counts[q])
        futs: dict = {}
        if rows:
            pb = node.publish_batcher
            if pb is not None:
                futs = pb.submit_burst(rows)
            else:
                # no batcher (the host-only node): the host per-message
                # path, awaited in row order (what publish_async does)
                loop = asyncio.get_running_loop()
                for k, (msg, need) in enumerate(rows):
                    cnt = await node.broker.publish_async(msg)
                    if need:
                        f = loop.create_future()
                        f.set_result(cnt)
                        futs[k] = f
        # flush: acks/errors/disconnects strictly in row order (wire
        # order is the order of _send calls — awaits between them do
        # not reorder the transport buffer)
        for item in seq:
            tag = item[0]
            if tag == "disc":
                self._disconnect_now(item[1], item[2])
            elif tag == "err":
                self._send([item[1]])
            else:
                _tag, qos, pid, ridx = item
                cnt = await futs[ridx]
                rc = C.RC_SUCCESS if (cnt or not v5) \
                    else C.RC_NO_MATCHING_SUBSCRIBERS
                cls = P.Puback if qos == C.QOS_1 else P.Pubrec
                self._send([cls(packet_id=pid, reason_code=rc)])
        # backpressure stragglers (QoS0 rows the batcher bounded): a
        # full queue stalls this read loop, like a refused enqueue()
        # falling back to an awaited submit() does on the packet path
        for fut in futs.values():
            await fut

    def _burst_puberr(self, seq: list, qos: int, pid, rc: int) -> None:
        """_puberr over a columnar row: same metrics and packets, but
        the outbound ack (when one exists) is DEFERRED into the burst's
        ordered ack plan so error acks cannot overtake the success acks
        of earlier rows awaiting their delivery counts."""
        self.node.metrics.inc("packets.publish.error")
        if qos == C.QOS_0:
            if self.proto_ver == C.MQTT_V5 and rc in (
                    C.RC_TOPIC_NAME_INVALID,):
                seq.append(("disc", rc, ""))
            return
        if self.proto_ver < C.MQTT_V5 and rc == C.RC_NOT_AUTHORIZED:
            # v3: no way to signal; drop silently (emqx behavior)
            return
        cls = P.Puback if qos == C.QOS_1 else P.Pubrec
        code = rc if self.proto_ver == C.MQTT_V5 else C.RC_SUCCESS
        seq.append(("err", cls(packet_id=pid, reason_code=code)))

    def _ack_now(self, pkt: P.Packet) -> None:
        """An acknowledgement that needs no delivery count: sent now, or
        behind the queued ones, so acks keep receive order."""
        if self._acks:
            self._acks.append((None, pkt, None))
        else:
            self._send([pkt])

    async def flush_acks(self) -> None:
        """Send the queued QoS 1/2 acknowledgements in receive order, each
        once its PUBLISH's delivery count resolves (the connection calls
        this after one socket read's PUBLISHes and before any other
        packet, so the batcher sees the whole read at once — as the
        reference's burst hand-off acks, channel.py:718-738)."""
        while self._acks:
            fut, cls, pid = self._acks.popleft()
            if fut is None:
                if cls is None:
                    self._disconnect(*pid)
                else:
                    self._send([cls])
                continue
            n = await fut
            rc = C.RC_SUCCESS if n or self.proto_ver < C.MQTT_V5 \
                else C.RC_NO_MATCHING_SUBSCRIBERS
            self._send([cls(packet_id=pid, reason_code=rc)])

    def _puberr(self, pkt: P.Publish, rc: int) -> None:
        self.node.metrics.inc("packets.publish.error")
        if pkt.qos == C.QOS_0:
            if self.proto_ver == C.MQTT_V5 and rc in (
                    C.RC_TOPIC_NAME_INVALID,):
                self._disconnect_now(rc)
            return
        cls = P.Puback if pkt.qos == C.QOS_1 else P.Pubrec
        code = rc if self.proto_ver == C.MQTT_V5 else C.RC_SUCCESS
        if self.proto_ver < C.MQTT_V5 and rc == C.RC_NOT_AUTHORIZED:
            # v3: no way to signal; drop silently (emqx behavior)
            return
        self._ack_now(cls(packet_id=pkt.packet_id, reason_code=code))

    async def _authorize(self, action: str, topic: str) -> bool:
        if self.clientinfo.get("is_superuser"):
            return True
        self.node.metrics.inc("client.authorize")
        res = await self.node.hooks.run_fold_async(
            "client.authorize", (self.clientinfo, action, topic), "allow")
        allowed = res != "deny"
        self.node.metrics.inc(
            "authorization.allow" if allowed else "authorization.deny")
        if not allowed and self.node.config.get(
                "authz", "deny_action") == "disconnect":
            self._disconnect_now(C.RC_NOT_AUTHORIZED)
        return allowed

    # ================= acks =================
    def _handle_puback(self, pkt: P.Puback) -> None:
        try:
            msg = self.session.puback(pkt.packet_id)
            self.node.metrics.inc("messages.acked")
            self.node.hooks.run("message.acked", (self.clientinfo, msg))
            self._send_dequeued(self.session.dequeue())
        except SessionError:
            self.node.metrics.inc("packets.puback.missed")

    def _handle_pubrec(self, pkt: P.Pubrec) -> None:
        try:
            if pkt.reason_code >= 0x80:
                self.session.inflight.delete(pkt.packet_id)
                return
            self.session.pubrec(pkt.packet_id)
            self._send([P.Pubrel(packet_id=pkt.packet_id)])
        except SessionError as e:
            self.node.metrics.inc("packets.pubrec.missed")
            if e.rc == C.RC_PACKET_IDENTIFIER_NOT_FOUND:
                self._send([P.Pubrel(packet_id=pkt.packet_id,
                                     reason_code=C.RC_PACKET_IDENTIFIER_NOT_FOUND)])

    def _handle_pubrel(self, pkt: P.Pubrel) -> None:
        try:
            self.session.pubrel(pkt.packet_id)
            self._send([P.Pubcomp(packet_id=pkt.packet_id)])
        except SessionError:
            self.node.metrics.inc("packets.pubrel.missed")
            self._send([P.Pubcomp(packet_id=pkt.packet_id,
                                  reason_code=C.RC_PACKET_IDENTIFIER_NOT_FOUND)])

    def _handle_pubcomp(self, pkt: P.Pubcomp) -> None:
        try:
            msg = self.session.pubcomp(pkt.packet_id)
            self.node.metrics.inc("messages.acked")
            self.node.hooks.run("message.acked", (self.clientinfo, msg))
            self._send_dequeued(self.session.dequeue())
        except SessionError:
            self.node.metrics.inc("packets.pubcomp.missed")

    # ================= SUBSCRIBE / UNSUBSCRIBE =================
    async def _handle_subscribe(self, pkt: P.Subscribe) -> None:
        import dataclasses
        raw = [(tf, dataclasses.asdict(o) if dataclasses.is_dataclass(o)
                else dict(o)) for tf, o in pkt.filters]
        filters = self.node.hooks.run_fold(
            "client.subscribe", (self.clientinfo, pkt.properties or {}), raw)
        self.node.metrics.inc("client.subscribe")
        codes = []
        sub_props = pkt.properties or {}
        subid = sub_props.get("subscription_identifier")
        for tf, opts in filters:
            if self._aborted:     # deny_action=disconnect mid-SUBSCRIBE
                return
            code = await self._do_subscribe(tf, dict(opts), subid)
            codes.append(code)
        self._send([P.Suback(packet_id=pkt.packet_id, reason_codes=codes)])

    async def _do_subscribe(self, tf: str, opts: dict, subid) -> int:
        try:
            real, popts = T.parse(tf, opts)
            T.validate(real, "filter")   # raises TopicError when invalid
        except T.TopicError:
            return C.RC_TOPIC_FILTER_INVALID
        if T.levels(real) > self.mqtt.get("max_topic_levels", 128):
            return C.RC_TOPIC_FILTER_INVALID
        if T.wildcard(real) and not self.mqtt.get("wildcard_subscription", True):
            return C.RC_WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED
        if popts.get("share"):
            if not self.mqtt.get("shared_subscription", True):
                return C.RC_SHARED_SUBSCRIPTIONS_NOT_SUPPORTED
            if popts.get("nl"):
                return C.RC_PROTOCOL_ERROR  # v5: no-local on shared is error
        if not await self._authorize("subscribe", real):
            self.node.metrics.inc("packets.subscribe.auth_error")
            return C.RC_NOT_AUTHORIZED
        # NOT capped by max_qos_allowed: the reference grants the requested
        # QoS even under a lower broker cap (emqx_mqtt_protocol_v5_SUITE
        # t_connack_max_qos_allowed, MQTT-3.2.2-10) — the cap applies to
        # inbound PUBLISH packets, not to subscription grants
        qos = int(popts.get("qos", 0))
        popts["qos"] = qos
        if subid is not None:
            popts["subid"] = subid
        # mountpoint applies to the real filter, share prefix kept outside
        mounted_real = self._mount(real)
        group = popts.get("share")
        full = f"$share/{group}/{mounted_real}" if group else mounted_real
        is_new = full not in self.session.subscriptions
        try:
            self.session.subscribe(full, popts)
        except SessionError as e:
            return e.rc
        self.node.broker.subscribe(self.sid, full,
                                   {k: v for k, v in popts.items()
                                    if k != "share"})
        # is_new feeds the retainer's Retain-Handling decision (rh=1 sends
        # retained msgs only on a NEW subscription, MQTT5 [MQTT-3.3.1-10])
        self.node.hooks.run("session.subscribed",
                            (self.clientinfo, mounted_real,
                             dict(popts, is_new=is_new)))
        return qos  # granted QoS doubles as v5 success code 0..2

    def _handle_unsubscribe(self, pkt: P.Unsubscribe) -> None:
        self.node.metrics.inc("client.unsubscribe")
        filters = self.node.hooks.run_fold(
            "client.unsubscribe", (self.clientinfo, pkt.properties or {}),
            list(pkt.filters))
        codes = [self._do_unsubscribe(tf) for tf in filters]
        self._send([P.Unsuback(packet_id=pkt.packet_id, reason_codes=codes)])

    def _do_unsubscribe(self, tf: str) -> int:
        try:
            real, popts = T.parse(tf)
        except T.TopicError:
            return C.RC_TOPIC_FILTER_INVALID
        mounted_real = self._mount(real)
        group = popts.get("share")
        full = (f"$share/{group}/{mounted_real}" if group
                else mounted_real)
        self.node.broker.unsubscribe(self.sid, full)
        try:
            self.session.unsubscribe(full)
        except SessionError:
            return C.RC_NO_SUBSCRIPTION_EXISTED
        self.node.hooks.run("session.unsubscribed",
                            (self.clientinfo, mounted_real))
        return C.RC_SUCCESS

    # ---- management-initiated subscribe/unsubscribe (emqx_mgmt:subscribe
    # sends the request into the client's channel process) ----
    async def mgmt_subscribe(self, topic_filter: str, qos: int = 0) -> int:
        return await self._do_subscribe(topic_filter, {"qos": qos}, None)

    def mgmt_unsubscribe(self, topic_filter: str) -> bool:
        return self._do_unsubscribe(topic_filter) == C.RC_SUCCESS

    # ================= DISCONNECT =================
    def _handle_disconnect(self, pkt: P.Disconnect) -> None:
        props = pkt.properties or {}
        if self.proto_ver == C.MQTT_V5 and self.session is not None:
            new_exp = props.get("session_expiry_interval")
            if new_exp is not None:
                if (self.session.conf.session_expiry_interval == 0
                        and new_exp > 0):
                    return self._disconnect_now(C.RC_PROTOCOL_ERROR)
                self.session.conf.session_expiry_interval = new_exp
        if pkt.reason_code == C.RC_SUCCESS:
            self.will_msg = None        # normal disconnect drops the will
        self.disconnect_reason = "normal"
        self.close("disconnect")

    def _disconnect_now(self, rc: int, detail: str = "") -> None:
        if self._acks:
            # acks owed to earlier PUBLISHes of this read go out first, as
            # the reference's per-packet path sent each before reading the
            # next packet; the DISCONNECT follows them (flush_acks)
            self._acks.append((None, None, (rc, detail)))
            return
        self._disconnect(rc, detail)

    def _disconnect(self, rc: int, detail: str = "") -> None:
        if self._aborted:
            return
        if self.proto_ver == C.MQTT_V5:
            self._send([P.Disconnect(reason_code=rc)])
        self._aborted = True
        self.disconnect_reason = f"protocol_0x{rc:02x}"
        self.close(detail or f"disconnect_0x{rc:02x}")

    def _delivery_dropped(self, msg: Message, reason: str) -> None:
        """Session mqueue eviction (delivery.dropped hook,
        emqx_session dropping path)."""
        self.node.metrics.inc("delivery.dropped")
        self.node.metrics.inc(f"delivery.dropped.{reason}")
        self.node.hooks.run("delivery.dropped",
                            (self.clientinfo, msg, reason))

    # ================= delivery (broker → client) =================
    def deliver(self, topic_filter: str, msg: Message) -> bool:
        """Subscriber callback (the `{deliver,...}` message analog)."""
        if self.conn_state == CONN_TAKING_OVER:
            self._pendings.append(msg)
            return True
        if self.session is None:
            return False
        subopts = msg.headers.get("subopts", {})
        if (self.mqtt.get("ignore_loop_deliver")
                and msg.from_ == self.clientid):
            self.node.metrics.inc("delivery.dropped")
            self.node.metrics.inc("delivery.dropped.no_local")
            return True
        if msg.is_expired():
            self.node.metrics.inc("delivery.dropped")
            self.node.metrics.inc("delivery.dropped.expired")
            return True
        if self.conn_state != CONN_CONNECTED:
            self.session.enqueue([(msg, subopts)])
            return True
        out = self.session.deliver([(msg, subopts)])
        self._send_deliveries(out)
        return True

    def deliver_batch(self, items: list) -> int:
        """Coalesced delivery (the delivery lanes): a same-session run of
        routed messages accepted by ONE session.deliver pass and flushed
        in ONE socket write, instead of a per-message accept + drain. All
        or none (the lane attributes per-message counts uniformly):
        returns len(items) when the session accepted the run, 0 when
        there is no session."""
        if self.conn_state == CONN_TAKING_OVER:
            self._pendings.extend(m for _f, m in items)
            return len(items)
        if self.session is None:
            return 0
        metrics = self.node.metrics
        ignore_loop = self.mqtt.get("ignore_loop_deliver")
        pairs = []
        for _f, msg in items:
            if ignore_loop and msg.from_ == self.clientid:
                metrics.inc("delivery.dropped")
                metrics.inc("delivery.dropped.no_local")
                continue
            if msg.is_expired():
                metrics.inc("delivery.dropped")
                metrics.inc("delivery.dropped.expired")
                continue
            pairs.append((msg, msg.headers.get("subopts", {})))
        if pairs:
            if self.conn_state != CONN_CONNECTED:
                self.session.enqueue(pairs)
            else:
                self._send_deliveries(self.session.deliver(pairs))
        return len(items)

    def _send_deliveries(self, out: list) -> None:
        pkts = []
        for pid, m in out:
            m.update_expiry()
            pkts.append(self._to_publish(pid, m))
            self.node.metrics.inc_msg_sent(m.qos)
        if pkts:
            self._send(pkts)

    def _to_publish(self, pid: Optional[int], m: Message) -> P.Publish:
        props = dict(m.headers.get("properties") or {}) \
            if self.proto_ver == C.MQTT_V5 else None
        topic = self._unmount(m.topic)
        # outbound topic aliasing (emqx_channel packing_alias): within the
        # client's advertised Topic-Alias-Maximum, the first delivery of a
        # topic carries topic+alias, repeats carry the alias alone; topics
        # beyond the alias budget go un-aliased
        if self.alias_out_max and topic:
            alias = self.alias_out.get(topic)
            if alias is not None:
                props["topic_alias"] = alias
                topic = ""
            elif len(self.alias_out) < self.alias_out_max:
                alias = len(self.alias_out) + 1
                self.alias_out[topic] = alias
                props["topic_alias"] = alias
        return P.Publish(topic=topic, payload=m.payload,
                         qos=m.qos, retain=m.retain, dup=m.dup,
                         packet_id=pid or 0, properties=props)

    def _send_dequeued(self, items: list[tuple[int, Message]]) -> None:
        """Send mqueue refill: pid 0 entries are QoS0 (no ack expected)."""
        self._send_deliveries([(pid or None, m) for pid, m in items])

    def _send_replay(self, items: list) -> None:
        pkts = []
        for pid, phase, msg in items:
            if phase == "publish":
                pkts.append(self._to_publish(pid, msg))
                self.node.metrics.inc_msg_sent(msg.qos)
            else:
                pkts.append(P.Pubrel(packet_id=pid))
        if pkts:
            self._send(pkts)

    # ================= timers =================
    def retry_deliveries(self) -> None:
        if self.session and self.conn_state == CONN_CONNECTED:
            items = self.session.retry()
            for _pid, phase, m in items:
                if phase == "publish":
                    m.set_flag("dup", True)
            self._send_replay(items)
            self.session.expire_awaiting_rel()

    # ================= takeover / kick / terminate =================
    async def takeover_begin(self) -> Optional[Session]:
        if self.session is None:
            return None
        self.conn_state = CONN_TAKING_OVER
        return self.session.takeover()

    async def takeover_end(self) -> list:
        pendings = self._pendings
        self._pendings = []
        sess = self.session
        self.session = None     # ownership moved
        if self.proto_ver == C.MQTT_V5:
            # MQTT-3.1.4-3: tell the displaced connection why it's going
            # (the reference's ?RC_SESSION_TAKEN_OVER disconnect on kick,
            # asserted by emqx_mqtt_protocol_v5_SUITE t_connect_clean_start)
            self._send([P.Disconnect(
                reason_code=C.RC_SESSION_TAKEN_OVER)])
        self.node.metrics.inc("session.takenover")
        self.node.hooks.run("session.takenover", (self.clientinfo, sess))
        if self.sid is not None:
            self.node.broker.subscriber_down(self.sid)
            self.sid = None
        self.close("takenover")
        return pendings

    async def kick(self, reason: str) -> None:
        if self.proto_ver == C.MQTT_V5:
            rc = (C.RC_SESSION_TAKEN_OVER if reason == "discarded"
                  else C.RC_ADMINISTRATIVE_ACTION)
            self._send([P.Disconnect(reason_code=rc)])
        self.will_msg = None if reason == "discarded" else self.will_msg
        if reason == "discarded" and self.session is not None:
            self.node.metrics.inc("session.discarded")
            self.node.hooks.run("session.discarded",
                                (self.clientinfo, self.session))
            self.session = None
        self.close(reason)

    def terminate(self, reason: str) -> None:
        """Connection closed (emqx_channel:terminate) — publish will,
        park or drop the session, clean broker state."""
        sess = self.session
        park = (sess is not None and self.conn_state == CONN_CONNECTED
                and sess.conf.session_expiry_interval > 0
                and reason != "discarded")
        if self.sid is not None:
            if park:
                # keep routes alive: detached session keeps enqueueing
                sess.parked_sid = self.sid
                self.node.broker.swap_subscriber(
                    self.sid, ParkedSubscriber(sess, self.node))
                # don't pin this Channel via the bound-method callback:
                # rebind drop accounting to node-scoped state
                node, ci = self.node, {"clientid": self.clientid}
                def _parked_drop(m, r, node=node, ci=ci):
                    node.metrics.inc("delivery.dropped")
                    node.metrics.inc(f"delivery.dropped.{r}")
                    node.hooks.run("delivery.dropped", (ci, m, r))
                sess.on_dropped = _parked_drop
            else:
                self.node.broker.subscriber_down(self.sid)
            self.sid = None
        if self.conn_state in (CONN_CONNECTED, CONN_DISCONNECTED):
            self.node.cm.unregister_channel(self.clientid, self)
        if self.will_msg is not None and reason not in ("takenover",):
            # scheduled so exhook's async message.publish hooks still apply
            self.node.broker.publish_soon(self.will_msg)
            self.will_msg = None
        if sess is not None and self.conn_state == CONN_CONNECTED:
            if park:
                self.node.cm.park_session(self.clientid, sess)
            else:
                self.node.metrics.inc("session.terminated")
                self.node.hooks.run("session.terminated",
                                    (self.clientinfo, reason, sess))
        if self.conn_state == CONN_CONNECTED:
            self.node.metrics.inc("client.disconnected")
            self.node.hooks.run("client.disconnected",
                                (self.clientinfo, reason))
        self.conn_state = CONN_DISCONNECTED
        self.session = None

    # ================= info =================
    def _conninfo_map(self, pkt: P.Connect) -> dict:
        return {"clientid": pkt.clientid, "username": pkt.username,
                "proto_ver": pkt.proto_ver, "keepalive": pkt.keepalive,
                "clean_start": pkt.clean_start,
                "peername": self.conninfo.get("peername")}

    def info(self) -> dict:
        d = {
            "clientid": self.clientid,
            "username": self.clientinfo.get("username"),
            "peername": self.conninfo.get("peername"),
            "proto_ver": self.proto_ver,
            "keepalive": self.keepalive,
            "clean_start": self.clientinfo.get("clean_start", True),
            "conn_state": self.conn_state,
            "connected_at": self.connected_at,
            "zone": self.zone,
            "mountpoint": self.mountpoint,
        }
        if self.session is not None:
            d["session"] = self.session.info()
        return d
