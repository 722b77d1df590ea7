"""Port vs JAX reference: the protocol gateways.

Each scenario runs the reference's ``emqx_tpu/gateway/`` classes and the
port's ``emqx_tpu_torch/gateway/`` copies on the same inputs over real
sockets, and compares what reaches the wire: every byte a STOMP
connection reads, every MQTT-SN, CoAP and LwM2M datagram a client gets,
the ExProto line client's bytes, and the messages the core delivers to an
in-process subscriber. The random ids (STOMP's ``message-id`` and
generated client ids, MQTT-SN's and ExProto's) come from a counting
``uuid`` in both packages; a CoAP client's generated clientid carries its
ephemeral port and is compared with the port masked. Inputs follow the
reference's ``tests/test_gateway.py`` (29 tests), ``tests/test_mqttsn_cases.py``
(12) and ``tests/test_exproto.py`` (1). The last scenario floods a
device-pinned CPU node of the port whose STOMP, MQTT-SN and CoAP
subscribers the delivery lanes serve, against the same node with the
lanes off.
"""

import asyncio
import json
import re
import struct
import types
import uuid
from concurrent import futures

import grpc
import pytest
import torch

import emqx_tpu.gateway.coap as jcoap
import emqx_tpu.gateway.exproto as jexproto
import emqx_tpu.gateway.lwm2m as jlwm2m
import emqx_tpu.gateway.lwm2m_objects as jobjects
import emqx_tpu.gateway.mqttsn as jsn
import emqx_tpu.gateway.stomp as jstomp
import emqx_tpu_torch.gateway.coap as tcoap
import emqx_tpu_torch.gateway.exproto as texproto
import emqx_tpu_torch.gateway.lwm2m as tlwm2m
import emqx_tpu_torch.gateway.lwm2m_objects as tobjects
import emqx_tpu_torch.gateway.mqttsn as tsn
import emqx_tpu_torch.gateway.stomp as tstomp
from emqx_tpu.broker import message as jmessage
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker import message as tmessage
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.gateway.protos import exproto_pb2 as xpb

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 30

REF = types.SimpleNamespace(
    name="ref", stomp=jstomp, sn=jsn, coap=jcoap, lwm2m=jlwm2m,
    objects=jobjects, exproto=jexproto, make=jmessage.make, Node=JNode,
    node=lambda conf=None: JNode(conf or {}, use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", stomp=tstomp, sn=tsn, coap=tcoap, lwm2m=tlwm2m,
    objects=tobjects, exproto=texproto, make=tmessage.make, Node=TNode,
    node=lambda conf=None: TNode(conf or {}, device="cpu", name=NAME))
PKGS = (REF, PORT)


def both(script):
    """The script's result under the reference and under the port."""
    return [script(pkg) for pkg in PKGS]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


class SeqUuid:
    """Stands in for a module's ``uuid``: ``uuid4()`` counts up from 1."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)


@pytest.fixture(autouse=True)
def counted_ids(monkeypatch):
    """Each gateway module of each package draws its random ids from its
    own counter, fresh for every test."""
    for pkg in PKGS:
        for mod in (pkg.stomp, pkg.sn, pkg.exproto):
            monkeypatch.setattr(mod, "uuid", SeqUuid())


def masked(x):
    """A CoAP client's generated clientid with its ephemeral port out."""
    if isinstance(x, str):
        return re.sub(r"coap-127\.0\.0\.1-\d+", "coap-<peer>", x)
    if isinstance(x, (list, tuple)):
        return type(x)(masked(v) for v in x)
    return x


class Capture:
    """An in-process core subscriber: what the broker delivers to it."""

    def __init__(self):
        self.msgs = []

    def deliver(self, f, m):
        self.msgs.append(masked((f, m.topic, m.payload, m.qos, m.from_,
                                 bool(m.get_flag("retain")))))
        return True


def capture(node, filt) -> Capture:
    cap = Capture()
    node.broker.subscribe(node.broker.register(cap, "c"), filt)
    return cap


def gw_twin(make_gw, go):
    """``go(pkg, node, gw)`` under each package against a started gateway
    (``make_gw(pkg, node)``); asserts the results equal and returns the
    reference's."""
    def script(pkg):
        node = pkg.node()
        gw = make_gw(pkg, node)

        async def main():
            await gw.start()
            try:
                return await go(pkg, node, gw)
            finally:
                await gw.stop()
        return run(main())
    want, got = both(script)
    assert got == want
    return want


# ---------------------------------------------------------------------
# STOMP
# ---------------------------------------------------------------------
def test_stomp_frame_roundtrip_alike():
    def script(pkg):
        f = pkg.stomp.Frame("SEND", {"destination": "/t", "a:b": "x\ny"},
                            b"hello")
        [g] = pkg.stomp.FrameParser().feed(f.encode())
        return f.encode(), g.command, g.headers, g.body
    want, got = both(script)
    assert got == want
    assert want[3] == b"hello" and want[2]["a:b"] == "x\ny"


def test_stomp_partial_feed_and_multiple_alike():
    def script(pkg):
        S = pkg.stomp
        data = (S.Frame("CONNECT", {"login": "u"}).encode() + b"\n"
                + S.Frame("SEND", {"destination": "d"}, b"B").encode()
                + b"\r\n" + b"SEND\r\ndestination:e\r\n\r\nx\n\ny\x00")
        out = []
        for step in (1, 7, len(data)):
            p, got = S.FrameParser(), []
            for i in range(0, len(data), step):
                got += p.feed(data[i:i + step])
            out.append([(g.command, g.headers, g.body) for g in got])
        return out
    want, got = both(script)
    assert got == want
    assert [c for c, _h, _b in want[1]] == ["CONNECT", "SEND", "SEND"]
    assert want[0] == want[1] == want[2]


def test_stomp_content_length_binary_body_alike():
    def script(pkg):
        S = pkg.stomp
        f = S.Frame("SEND", {"destination": "d", "content-length": "3"},
                    b"\x00\x01\x02")
        [g] = S.FrameParser().feed(f.encode())
        errs = []
        for bad in (b"SEND\ncontent-length:x\n\nabc\x00",
                    b"SEND\ncontent-length:2\n\nabc\x00"):
            try:
                S.FrameParser().feed(bad)
            except S.StompError as e:
                errs.append(str(e))
        return g.body, errs
    want, got = both(script)
    assert got == want
    assert want == (b"\x00\x01\x02", ["bad content-length",
                                      "missing frame NUL"])


class StompClient:
    """A STOMP connection that keeps every byte it reads (``raw``) and
    parses them with its package's codec."""

    def __init__(self, pkg, port):
        self.S = pkg.stomp
        self.port = port
        self.parser = self.S.FrameParser()
        self.frames = asyncio.Queue()
        self.raw = bytearray()

    async def open(self):
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)
        self._rx = asyncio.ensure_future(self._rx_loop())

    async def connect(self, headers=None):
        await self.open()
        await self.send(self.S.Frame("CONNECT", headers or {
            "accept-version": "1.2", "login": "guest"}))
        f = await self.recv()
        assert f.command == "CONNECTED", f.command
        return f

    async def _rx_loop(self):
        while True:
            data = await self.reader.read(4096)
            if not data:
                return
            self.raw += data
            for f in self.parser.feed(data):
                self.frames.put_nowait(f)

    async def send(self, frame):
        self.writer.write(frame.encode())
        await self.writer.drain()

    async def recv(self, timeout=5):
        return await asyncio.wait_for(self.frames.get(), timeout)

    def close(self):
        self._rx.cancel()
        self.writer.close()


def stomp_gw(pkg, node):
    return pkg.stomp.StompGateway(node, {"port": 0})


def test_stomp_connect_send_subscribe_alike():
    async def go(pkg, node, gw):
        S = pkg.stomp
        a, b = StompClient(pkg, gw.port), StompClient(pkg, gw.port)
        await a.connect()
        await b.connect({"accept-version": "1.0,1.1", "login": "g",
                         "client-id": "bee", "heart-beat": "0,500"})
        await b.send(S.Frame("SUBSCRIBE", {"id": "s1", "destination": "st/+",
                                           "receipt": "r1"}))
        await b.recv()
        await a.send(S.Frame("SEND", {"destination": "st/x"}, b"hi"))
        await b.recv()
        node.broker.publish(pkg.make("mq", 0, "st/y", b"from-mqtt"))
        await b.recv()
        cap = capture(node, "st/#")
        await a.send(S.Frame("SEND", {"destination": "st/z"}, b"out"))
        await asyncio.sleep(0.1)
        a.close()
        b.close()
        return bytes(a.raw), bytes(b.raw), cap.msgs
    a_raw, b_raw, msgs = gw_twin(stomp_gw, go)
    assert b"CONNECTED\nversion:1.1\nheart-beat:500,0" in b_raw
    assert b"MESSAGE\nsubscription:s1\n" in b_raw and b"from-mqtt" in b_raw
    assert [m[2] for m in msgs] == [b"out"]


def test_stomp_transactions_alike():
    async def go(pkg, node, gw):
        S = pkg.stomp
        a = StompClient(pkg, gw.port)
        await a.connect()
        cap = capture(node, "tx/#")
        await a.send(S.Frame("BEGIN", {"transaction": "t1"}))
        for d, body in (("tx/1", b"a"), ("tx/2", b"b")):
            await a.send(S.Frame("SEND", {"destination": d,
                                          "transaction": "t1"}, body))
        await asyncio.sleep(0.1)
        held = list(cap.msgs)
        await a.send(S.Frame("COMMIT", {"transaction": "t1",
                                        "receipt": "rc"}))
        await a.recv()
        await asyncio.sleep(0.1)
        committed = list(cap.msgs)
        await a.send(S.Frame("BEGIN", {"transaction": "t2"}))
        await a.send(S.Frame("SEND", {"destination": "tx/3",
                                      "transaction": "t2"}, b"c"))
        await a.send(S.Frame("ABORT", {"transaction": "t2",
                                       "receipt": "ra"}))
        await a.recv()
        for bad in ("COMMIT", "ABORT"):
            await a.send(S.Frame(bad, {"transaction": "nope"}))
            await a.recv()
        await a.send(S.Frame("SEND", {"destination": "tx/4",
                                      "transaction": "nope"}))
        await a.recv()
        await asyncio.sleep(0.1)
        a.close()
        return held, committed, list(cap.msgs), bytes(a.raw)
    held, committed, after, raw = gw_twin(stomp_gw, go)
    assert held == [] and sorted(m[2] for m in committed) == [b"a", b"b"]
    assert after == committed
    assert raw.count(b"ERROR\nmessage:transaction not begun") == 3


def test_stomp_error_before_connect_alike():
    async def go(pkg, node, gw):
        S = pkg.stomp
        c = StompClient(pkg, gw.port)
        await c.open()
        await c.send(S.Frame("SEND", {"destination": "x"}, b""))
        await c.recv()
        await c.connect()
        await c.send(S.Frame("CONNECT", {}))
        await c.send(S.Frame("BOGUS", {}))
        await c.send(S.Frame("SEND", {}))
        for _ in range(3):
            await c.recv()
        c.close()
        return bytes(c.raw)
    raw = gw_twin(stomp_gw, go)
    assert raw.startswith(b"ERROR\nmessage:not connected")
    assert b"message:already connected" in raw
    assert b"message:unknown command" in raw
    assert b"message:missing destination" in raw


def test_stomp_unsubscribe_stops_delivery_alike():
    async def go(pkg, node, gw):
        S = pkg.stomp
        a = StompClient(pkg, gw.port)
        await a.connect()
        await a.send(S.Frame("SUBSCRIBE", {"id": "1", "destination": "u/t"}))
        await asyncio.sleep(0.05)
        node.broker.publish(pkg.make("m", 0, "u/t", b"1"))
        await a.recv()
        await a.send(S.Frame("UNSUBSCRIBE", {"id": "1", "receipt": "r"}))
        await a.recv()
        node.broker.publish(pkg.make("m", 0, "u/t", b"2"))
        try:
            await a.recv(timeout=0.3)
            late = True
        except asyncio.TimeoutError:
            late = False
        await a.send(S.Frame("DISCONNECT", {"receipt": "bye"}))
        await asyncio.sleep(0.1)
        a.close()
        return late, bytes(a.raw), gw.info()["current_connections"]
    late, raw, conns = gw_twin(stomp_gw, go)
    assert late is False and raw.endswith(b"RECEIPT\nreceipt-id:bye\n\n\x00")
    assert conns == 0


# ---------------------------------------------------------------------
# MQTT-SN
# ---------------------------------------------------------------------
class SnClient(asyncio.DatagramProtocol):
    """A raw MQTT-SN UDP client that keeps every datagram it gets."""

    def __init__(self, pkg):
        self.SN = pkg.sn
        self.inbox = asyncio.Queue()
        self.raw = []

    def datagram_received(self, data, addr):
        self.raw.append(data)
        self.inbox.put_nowait(self.SN.decode(data))

    @classmethod
    async def create(cls, pkg, port):
        loop = asyncio.get_running_loop()
        proto = cls(pkg)
        transport, _ = await loop.create_datagram_endpoint(
            lambda: proto, remote_addr=("127.0.0.1", port))
        proto.transport = transport
        return proto

    def send(self, msg_type, body=b""):
        self.transport.sendto(self.SN.encode(msg_type, body))

    async def recv(self, timeout=5):
        return await asyncio.wait_for(self.inbox.get(), timeout)

    async def connect(self, clientid=b"dev1", flags=0, duration=60):
        self.send(self.SN.CONNECT, bytes([flags, 1]) +
                  struct.pack(">H", duration) + clientid)
        t, body = await self.recv()
        assert t == self.SN.CONNACK and body[0] == 0, (t, body)

    async def subscribe_name(self, name: bytes, qos=1, mid=2):
        self.send(self.SN.SUBSCRIBE, bytes([qos << 5]) +
                  struct.pack(">H", mid) + name)
        t, body = await self.recv()
        assert t == self.SN.SUBACK and body[-1] == 0, (t, body)
        return struct.unpack(">H", body[1:3])[0]

    async def subscribe_predef(self, tid: int, qos=1, mid=2):
        self.send(self.SN.SUBSCRIBE, bytes([(qos << 5) | 0x01]) +
                  struct.pack(">H", mid) + struct.pack(">H", tid))
        t, body = await self.recv()
        assert t == self.SN.SUBACK and body[-1] == 0, (t, body)

    def publish(self, tt: int, tid: bytes, payload: bytes, qos=0, mid=0):
        q = 3 if qos == -1 else qos
        self.send(self.SN.PUBLISH, bytes([(q << 5) | tt]) + tid +
                  struct.pack(">H", mid) + payload)

    async def register(self, name: bytes, mid=1) -> int:
        self.send(self.SN.REGISTER, struct.pack(">HH", 0, mid) + name)
        t, body = await self.recv()
        assert t == self.SN.REGACK and body[4] == 0, (t, body)
        return struct.unpack(">H", body[:2])[0]

    async def expect_publish(self, timeout=5):
        """The next PUBLISH, REGACK-ing a gateway REGISTER before it."""
        while True:
            t, body = await self.recv(timeout)
            if t == self.SN.REGISTER:
                tid, mid = struct.unpack(">HH", body[:4])
                self.send(self.SN.REGACK,
                          struct.pack(">HH", tid, mid) + b"\x00")
                continue
            if t == self.SN.PUBLISH:
                if (body[0] >> 5) & 3 == 1:
                    self.send(self.SN.PUBACK, body[1:3] + body[3:5] +
                              b"\x00")
                return body[5:], body[0]

    def close(self):
        self.transport.close()


def sn_gw(predefined):
    def make(pkg, node):
        return pkg.sn.MqttSnGateway(node, {"port": 0,
                                           "predefined": predefined})
    return make


SHORT, PREDEF, NORMAL = 2, 1, 0


async def _sn_searchgw(pkg, node, gw):
    c = await SnClient.create(pkg, gw.port)
    c.send(pkg.sn.SEARCHGW, b"\x01")
    await c.recv()
    c.send(pkg.sn.CONNECT, b"\x00")             # malformed: dropped
    c.send(pkg.sn.PINGREQ)
    await c.recv()
    c.close()
    return c.raw


async def _sn_register_publish_qos1(pkg, node, gw):
    SN = pkg.sn
    cap = capture(node, "sn/#")
    c = await SnClient.create(pkg, gw.port)
    await c.connect()
    tid = await c.register(b"sn/data")
    c.publish(NORMAL, struct.pack(">H", tid), b"val", qos=1, mid=7)
    await c.recv()
    c.publish(NORMAL, struct.pack(">H", 99), b"x", qos=1, mid=8)
    await c.recv()
    c.send(SN.UNSUBSCRIBE, b"\x00" + struct.pack(">H", 3) + b"sn/data")
    await c.recv()
    await asyncio.sleep(0.05)
    c.close()
    return c.raw, cap.msgs


async def _sn_wildcard_registers_alias(pkg, node, gw):
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"sub1")
    c.send(pkg.sn.SUBSCRIBE, bytes([0x20]) + struct.pack(">H", 2) +
           b"room/+/temp")
    await c.recv()
    for k, q in ((7, 1), (8, 0), (7, 2)):
        node.broker.publish(pkg.make("m", q, f"room/{k}/temp", b"%d" % k))
    for _ in range(5):
        await c.recv()
    c.close()
    return c.raw


async def _sn_qos_minus1_predefined(pkg, node, gw):
    cap = capture(node, "pre/defined")
    c = await SnClient.create(pkg, gw.port)
    c.publish(PREDEF, struct.pack(">H", 10), b"fire-and-forget", qos=-1)
    c.publish(PREDEF, struct.pack(">H", 11), b"unknown id", qos=-1)
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _sn_sleep_buffer(pkg, node, gw):
    SN = pkg.sn
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"sleepy")
    c.send(SN.SUBSCRIBE, bytes([0]) + struct.pack(">H", 3) + b"zzz/t")
    await c.recv()
    c.send(SN.DISCONNECT, struct.pack(">H", 30))
    await c.recv()
    node.broker.publish(pkg.make("m", 0, "zzz/t", b"while-asleep"))
    await asyncio.sleep(0.1)
    empty = c.inbox.empty()
    c.send(SN.PINGREQ, b"sleepy")
    for _ in range(2):
        await c.recv()
    c.close()
    return empty, c.raw


async def _sn_qos2_publish(pkg, node, gw):
    SN = pkg.sn
    cap = capture(node, "q2/t")
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"q2dev")
    tid = await c.register(b"q2/t")
    c.publish(NORMAL, struct.pack(">H", tid), b"exactly-once", qos=2,
              mid=9)
    await c.recv()
    held = list(cap.msgs)
    c.send(SN.PUBREL, struct.pack(">H", 9))
    await c.recv()
    await asyncio.sleep(0.05)
    c.close()
    return held, c.raw, cap.msgs


async def _sn_will_flow(pkg, node, gw):
    SN = pkg.sn
    cap = capture(node, "will/t")
    c = await SnClient.create(pkg, gw.port)
    for keepalive, will in ((60, b"gone"), (1, b"died")):
        c.send(SN.CONNECT, bytes([SN.FLAG_WILL, 1]) +
               struct.pack(">H", keepalive) + b"willdev")
        await c.recv()
        c.send(SN.WILLTOPIC, bytes([0x20 | SN.FLAG_RETAIN]) + b"will/t")
        await c.recv()
        c.send(SN.WILLMSG, will)
        await c.recv()
        if keepalive == 60:
            c.send(SN.DISCONNECT)
            await c.recv()
            await asyncio.sleep(0.05)
            clean = list(cap.msgs)
    gw.by_clientid["willdev"].last_seen -= 10
    gw.sweep()
    await asyncio.sleep(0.05)
    c.close()
    return clean, c.raw, cap.msgs, sorted(gw.by_clientid)


SN_GATEWAY = {f.__name__[4:]: f for f in (
    _sn_searchgw, _sn_register_publish_qos1, _sn_wildcard_registers_alias,
    _sn_qos_minus1_predefined, _sn_sleep_buffer, _sn_qos2_publish,
    _sn_will_flow)}


@pytest.mark.parametrize("case", sorted(SN_GATEWAY))
def test_mqttsn_gateway_alike(case):
    """The reference's seven TestMqttSn cases: every datagram the clients
    get and every message the core delivers, equal."""
    want = gw_twin(sn_gw({10: "pre/defined"}), SN_GATEWAY[case])
    if case == "will_flow":
        clean, _raw, msgs, left = want
        assert clean == [] and [m[2] for m in msgs] == [b"died"]
        assert msgs[0][5] is True and left == []
    if case == "register_publish_qos1":
        raw, msgs = want
        assert [m[1:4] for m in msgs] == [("sn/data", b"val", 1)]
        assert raw[-2][-1] == jsn.RC_INVALID_TOPIC_ID


async def _case1_qos0pub(pkg, node, gw):
    cap = capture(node, "tt")
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"testclientid_case1pub")
    c.publish(SHORT, b"tt", b"short-topic qos0")
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _pubsub(pkg, gw, sub_id, subscribe, pub_id, publish):
    sub = await SnClient.create(pkg, gw.port)
    await sub.connect(sub_id)
    await subscribe(sub)
    pub = await SnClient.create(pkg, gw.port)
    if pub_id is not None:
        await pub.connect(pub_id)
    await publish(pub)
    got = await sub.expect_publish()
    sub.close()
    pub.close()
    return got, sub.raw, pub.raw


async def _case1_qos0sub(pkg, node, gw):
    async def publish(p):
        p.publish(SHORT, b"tt", b"case1 payload")
    return await _pubsub(pkg, gw, b"testclientid_case1",
                         lambda s: s.subscribe_name(b"tt", qos=1),
                         b"testclientid_case1pub", publish)


async def _case2_qos0pub(pkg, node, gw):
    cap = capture(node, "predef/topic1")
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"testclientid_case2pub")
    c.publish(PREDEF, struct.pack(">H", 1), b"predefined qos0")
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _case2_qos0sub(pkg, node, gw):
    async def publish(p):
        p.publish(PREDEF, struct.pack(">H", 1), b"case2 payload")
    return await _pubsub(pkg, gw, b"testclientid_case2",
                         lambda s: s.subscribe_predef(1, qos=1),
                         b"testclientid_case2pub", publish)


async def _case3_qos0pub(pkg, node, gw):
    cap = capture(node, "predef_topic1")
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"testclientid_case3pub")
    tid = await c.register(b"predef_topic1")
    c.publish(NORMAL, struct.pack(">H", tid), b"registered qos0")
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _case3_qos0sub(pkg, node, gw):
    async def publish(p):
        tid = await p.register(b"predef_topic1")
        p.publish(NORMAL, struct.pack(">H", tid), b"case3 payload")
    return await _pubsub(pkg, gw, b"testclientid_case3",
                         lambda s: s.subscribe_name(b"predef_topic1", qos=1),
                         b"testclientid_case3pub", publish)


async def _case4_qos3pub(pkg, node, gw):
    cap = capture(node, "predef/topic1")
    c = await SnClient.create(pkg, gw.port)
    c.publish(PREDEF, struct.pack(">H", 1), b"qos -1 predefined", qos=-1)
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _case4_qos3sub(pkg, node, gw):
    async def publish(p):
        p.publish(PREDEF, struct.pack(">H", 1), b"case4 payload", qos=-1)
    return await _pubsub(pkg, gw, b"testclientid_case4",
                         lambda s: s.subscribe_predef(1, qos=1), None,
                         publish)


async def _case5_qos3pub(pkg, node, gw):
    cap = capture(node, "tt")
    c = await SnClient.create(pkg, gw.port)
    c.publish(SHORT, b"tt", b"qos -1 short", qos=-1)
    await asyncio.sleep(0.1)
    c.close()
    return c.raw, cap.msgs


async def _case5_qos3sub(pkg, node, gw):
    async def publish(p):
        p.publish(SHORT, b"tt", b"case5 payload", qos=-1)
    return await _pubsub(pkg, gw, b"testclientid_case5",
                         lambda s: s.subscribe_name(b"tt", qos=0), None,
                         publish)


async def _case6_sleep(pkg, node, gw):
    SN = pkg.sn
    c = await SnClient.create(pkg, gw.port)
    await c.connect(b"testclientid_case1")
    await c.subscribe_name(b"tt", qos=1)
    c.send(SN.DISCONNECT, struct.pack(">H", 5))
    await c.recv()
    node.broker.publish(pkg.make("m", 1, "tt", b"while asleep"))
    await asyncio.sleep(0.2)
    empty = c.inbox.empty()
    c.send(SN.PINGREQ, b"testclientid_case1")
    got = await c.expect_publish()
    await c.recv()
    c.close()
    return empty, got, c.raw


async def _case7_double_connect(pkg, node, gw):
    c1 = await SnClient.create(pkg, gw.port)
    await c1.connect(b"testclientid_case7")
    c2 = await SnClient.create(pkg, gw.port)
    await c2.connect(b"testclientid_case7_new")
    c3 = await SnClient.create(pkg, gw.port)
    await c3.connect(b"testclientid_case7")
    await c3.subscribe_name(b"tt", qos=1, mid=9)
    pub = await SnClient.create(pkg, gw.port)
    await pub.connect(b"pub7")
    pub.publish(SHORT, b"tt", b"after reconnect")
    got = await c3.expect_publish()
    for c in (c1, c2, c3, pub):
        c.close()
    return got, c1.raw, c3.raw, sorted(gw.by_clientid)


SN_CASES = {f.__name__[1:]: f for f in (
    _case1_qos0pub, _case1_qos0sub, _case2_qos0pub, _case2_qos0sub,
    _case3_qos0pub, _case3_qos0sub, _case4_qos3pub, _case4_qos3sub,
    _case5_qos3pub, _case5_qos3sub, _case6_sleep, _case7_double_connect)}
SN_PAYLOADS = {
    "case1_qos0pub": b"short-topic qos0", "case1_qos0sub": b"case1 payload",
    "case2_qos0pub": b"predefined qos0", "case2_qos0sub": b"case2 payload",
    "case3_qos0pub": b"registered qos0", "case3_qos0sub": b"case3 payload",
    "case4_qos3pub": b"qos -1 predefined", "case4_qos3sub": b"case4 payload",
    "case5_qos3pub": b"qos -1 short", "case5_qos3sub": b"case5 payload",
    "case6_sleep": b"while asleep", "case7_double_connect":
    b"after reconnect"}


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_mqttsn_c_client_case_alike(case):
    """The reference's C client case matrix (case1..case7): the same
    datagrams at every client and the same core deliveries."""
    want = gw_twin(sn_gw({1: "predef/topic1"}), SN_CASES[case])
    payload = SN_PAYLOADS[case]
    if case.endswith("pub"):
        raw, msgs = want
        assert [m[2] for m in msgs] == [payload]
    elif case == "case6_sleep":
        assert want[0] is True and want[1][0] == payload
    else:
        assert want[0][0] == payload


# ---------------------------------------------------------------------
# CoAP
# ---------------------------------------------------------------------
class CoapClient(asyncio.DatagramProtocol):
    def __init__(self, pkg):
        self.CO = pkg.coap
        self.inbox = asyncio.Queue()
        self.raw = []

    def datagram_received(self, data, addr):
        self.raw.append(data)
        self.inbox.put_nowait(self.CO.decode(data))

    @classmethod
    async def create(cls, pkg, port):
        loop = asyncio.get_running_loop()
        proto = cls(pkg)
        transport, _ = await loop.create_datagram_endpoint(
            lambda: proto, remote_addr=("127.0.0.1", port))
        proto.transport = transport
        return proto

    def send(self, msg):
        self.transport.sendto(self.CO.encode(msg))

    async def recv(self, timeout=5):
        return await asyncio.wait_for(self.inbox.get(), timeout)

    def close(self):
        self.transport.close()


def mqtt_req(CO, code, topic, mid, token=b"\x01", observe=None,
             payload=b"", query=(), type_=None):
    opts = [(CO.OPT_URI_PATH, b"mqtt")]
    opts += [(CO.OPT_URI_PATH, seg.encode()) for seg in topic.split("/")]
    opts += [(CO.OPT_URI_QUERY, q.encode()) for q in query]
    if observe is not None:
        opts.append((CO.OPT_OBSERVE, b"" if observe == 0 else b"\x01"))
    return CO.CoapMessage(type=CO.CON if type_ is None else type_,
                          code=code, message_id=mid, token=token,
                          options=opts, payload=payload)


def test_coap_codec_roundtrip_with_ext_options_alike():
    def script(pkg):
        CO = pkg.coap
        m = CO.CoapMessage(type=CO.CON, code=CO.PUT, message_id=0x1234,
                           token=b"\xAA\xBB",
                           options=[(CO.OPT_URI_PATH, b"mqtt"),
                                    (CO.OPT_URI_QUERY, b"c=dev"),
                                    (2048, b"x" * 300),
                                    (CO.OPT_URI_PATH, b"a"),
                                    (20, b"y" * 14)],
                           payload=b"data")
        wire = CO.encode(m)
        d = CO.decode(wire)
        return wire, d.options, d.payload, d.uri_path, d.uri_query
    want, got = both(script)
    assert got == want
    assert want[3] == ["mqtt", "a"] and want[4] == {"c": "dev"}


def test_coap_bad_messages_rejected_alike():
    def script(pkg):
        out = []
        for data in (b"\x00\x01\x00\x01", b"\x49\x01\x00\x01",
                     b"\x40\x01\x00\x01\xff", b"\x41\x01\x00\x01",
                     b"\x40\x01\x00\x01\xf0"):
            try:
                m = pkg.coap.decode(data)
                out.append((m.type, m.code, m.message_id, m.token,
                            m.options, m.payload))
            except pkg.coap.CoapError as e:
                out.append(str(e))
        return out
    want, got = both(script)
    assert got == want
    assert want[0] == "bad version/short header"


def coap_gw(pkg, node):
    return pkg.coap.CoapGateway(node, {"port": 0})


def test_coap_put_publishes_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        cap = capture(node, "co/#")
        c = await CoapClient.create(pkg, gw.port)
        c.send(mqtt_req(CO, CO.PUT, "co/data", 1, query=("c=dev1",),
                        payload=b"21C"))
        await c.recv()
        c.send(mqtt_req(CO, CO.POST, "co/r", 2, payload=b"anon",
                        query=("qos=1", "retain=true"), type_=CO.NON))
        await c.recv()
        c.send(mqtt_req(CO, CO.GET, "co/data", 3))
        await c.recv()
        await asyncio.sleep(0.05)
        c.close()
        return c.raw, cap.msgs
    raw, msgs = gw_twin(coap_gw, go)
    assert [m[1:5] for m in msgs] == [
        ("co/data", b"21C", 0, "coap:dev1"),
        ("co/r", b"anon", 1, "coap:coap-<peer>")]
    assert msgs[1][5] is True


def test_coap_observe_subscription_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        c = await CoapClient.create(pkg, gw.port)
        c.send(mqtt_req(CO, CO.GET, "co/obs", 2, token=b"\x42", observe=0,
                        query=("c=watcher",)))
        await c.recv()
        for k in range(3):
            node.broker.publish(pkg.make("m", 0, "co/obs", b"notif-%d" % k))
            await c.recv()
        c.send(mqtt_req(CO, CO.GET, "co/obs", 3, token=b"\x42", observe=1,
                        query=("c=watcher",)))
        await c.recv()
        node.broker.publish(pkg.make("m", 0, "co/obs", b"late"))
        try:
            await c.recv(timeout=0.3)
            late = True
        except asyncio.TimeoutError:
            late = False
        c.send(mqtt_req(CO, CO.GET, "co/+", 4, token=b"\x43", observe=0))
        await c.recv()
        c.send(mqtt_req(CO, CO.DELETE, "co/+", 5))
        await c.recv()
        obs = gw.info()["observers"]
        c.close()
        return c.raw, late, obs
    raw, late, obs = gw_twin(coap_gw, go)
    assert late is False and obs == 0 and len(raw) == 7


def test_coap_not_found_outside_mqtt_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        c = await CoapClient.create(pkg, gw.port)
        c.send(CO.CoapMessage(type=CO.CON, code=CO.GET, message_id=9,
                              token=b"\x01",
                              options=[(CO.OPT_URI_PATH, b"other")]))
        await c.recv()
        c.send(CO.CoapMessage(type=CO.CON, code=CO.GET, message_id=10,
                              token=b"\x02",
                              options=[(CO.OPT_URI_PATH, b"mqtt")]))
        await c.recv()
        c.close()
        return c.raw
    raw = gw_twin(coap_gw, go)
    assert jcoap.decode(raw[0]).code == jcoap.NOT_FOUND


# ---------------------------------------------------------------------
# LwM2M
# ---------------------------------------------------------------------
TLV_NESTED = [{"kind": "obj_inst", "id": 0, "value": [
    {"kind": "resource", "id": 0, "value": b"Open Mobile"},
    {"kind": "resource", "id": 1, "value": "LWM2M-1"},
    {"kind": "resource", "id": 9, "value": 85},
    {"kind": "multi_res", "id": 6, "value": [
        {"kind": "res_inst", "id": 0, "value": b"\x01"},
        {"kind": "res_inst", "id": 1, "value": b"\x05"}]}]}]


def test_tlv_roundtrip_nested_alike():
    def script(pkg):
        wire = pkg.lwm2m.tlv_encode(TLV_NESTED)
        return wire, pkg.lwm2m.tlv_decode(wire)
    want, got = both(script)
    assert got == want
    assert want[1][0]["value"][3]["value"][1]["value"] == b"\x05"


def test_tlv_long_value_and_wide_id_alike():
    def script(pkg):
        out = []
        for n in (7, 8, 255, 700, 70000):
            wire = pkg.lwm2m.tlv_encode([{"kind": "resource", "id": 300,
                                          "value": b"z" * n}])
            out.append((wire[:6], pkg.lwm2m.tlv_decode(wire)[0]["id"],
                        len(pkg.lwm2m.tlv_decode(wire)[0]["value"])))
        return out
    want, got = both(script)
    assert got == want
    assert [x[2] for x in want] == [7, 8, 255, 700, 70000]


def lwm2m_gw(pkg, node):
    return pkg.lwm2m.Lwm2mGateway(node, {"port": 0})


def rd_register(CO, ep, mid=1):
    return CO.CoapMessage(
        type=CO.CON, code=CO.POST, message_id=mid, token=b"\x07",
        options=[(CO.OPT_URI_PATH, b"rd"),
                 (CO.OPT_URI_QUERY, f"ep={ep}".encode()),
                 (CO.OPT_URI_QUERY, b"lt=120"),
                 (CO.OPT_URI_QUERY, b"lwm2m=1.0")],
        payload=b"</1/0>,</3/0>")


def test_lwm2m_register_update_deregister_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        cap = capture(node, "lwm2m/+/up/#")
        dev = await CoapClient.create(pkg, gw.port)
        dev.send(rd_register(CO, "ep-1"))
        r = await dev.recv()
        loc = [v.decode() for v in r.opts(CO.OPT_LOCATION_PATH)]
        for code, mid, opts in (
                (CO.PUT, 2, [(CO.OPT_URI_QUERY, b"lt=300")]),
                (CO.POST, 3, []), (CO.PUT, 4, None)):
            base = [(CO.OPT_URI_PATH, b"rd"),
                    (CO.OPT_URI_PATH, (loc[1] if opts is not None
                                       else "nowhere").encode())]
            dev.send(CO.CoapMessage(type=CO.CON, code=code, message_id=mid,
                                    token=b"\x08", options=base
                                    + (opts or [])))
            await dev.recv()
        lifetime = gw.sessions["ep-1"].lifetime
        dev.send(CO.CoapMessage(
            type=CO.CON, code=CO.DELETE, message_id=5, token=b"\x09",
            options=[(CO.OPT_URI_PATH, b"rd"),
                     (CO.OPT_URI_PATH, loc[1].encode())]))
        await dev.recv()
        await asyncio.sleep(0.05)
        dev.close()
        return dev.raw, [(m[1], json.loads(m[2])) for m in cap.msgs], \
            lifetime, sorted(gw.sessions)
    raw, msgs, lifetime, left = gw_twin(lwm2m_gw, go)
    assert lifetime == 300 and left == []
    assert [m[1]["msgType"] for m in msgs] == ["register", "update",
                                               "update", "deregister"]
    assert msgs[0][1]["data"]["objectList"] == ["/1/0", "/3/0"]


def test_lwm2m_downlink_read_roundtrip_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        cap = capture(node, "lwm2m/ep-2/up/resp")
        dev = await CoapClient.create(pkg, gw.port)
        dev.send(rd_register(CO, "ep-2"))
        await dev.recv()
        await asyncio.sleep(0.05)
        cap.msgs.clear()
        cmds = [{"reqID": 42, "msgType": "read",
                 "data": {"path": "/3/0/0"}},
                {"reqID": 43, "msgType": "read",
                 "data": {"path": "/Device/0/Battery Level"}},
                {"reqID": 44, "msgType": "discover",
                 "data": {"path": "/3/0"}},
                {"reqID": 45, "msgType": "read",
                 "data": {"path": "/Nothing/0/x"}},
                {"reqID": 46, "msgType": "bogus", "data": {"path": "/3"}}]
        answers = [(11542, jlwm2m.tlv_encode([{"kind": "resource", "id": 0,
                                               "value": b"ACME Corp"}])),
                   (0, b"77"), (40, b"</3/0/0>,</3/0/9>")]
        for cmd in cmds:
            node.broker.publish(pkg.make("ctl", 0, "lwm2m/ep-2/dn/cmd",
                                         json.dumps(cmd).encode()))
        for cf, payload in answers:
            req = await dev.recv()
            dev.send(CO.CoapMessage(
                type=CO.ACK, code=CO.CONTENT, message_id=req.message_id,
                token=req.token,
                options=[(CO.OPT_CONTENT_FORMAT, struct.pack(">H", cf))],
                payload=payload))
        node.broker.publish(pkg.make("ctl", 0, "lwm2m/ep-2/dn/cmd",
                                     b"not json"))
        await asyncio.sleep(0.1)
        dev.close()
        return dev.raw, [json.loads(m[2]) for m in cap.msgs]
    raw, resps = gw_twin(lwm2m_gw, go)
    by_id = {r["reqID"]: r for r in resps}
    assert by_id[42]["data"]["content"][0]["value"] == "ACME Corp"
    assert by_id[43]["data"]["reqPathName"] == "Device/0/Battery Level"
    assert by_id[45]["data"]["code"] == "4.04"
    assert by_id[46]["data"]["code"] == "4.00"


def test_lwm2m_downlink_write_execute_observe_alike():
    async def go(pkg, node, gw):
        CO = pkg.coap
        cap = capture(node, "lwm2m/ep-3/up/#")
        dev = await CoapClient.create(pkg, gw.port)
        dev.send(rd_register(CO, "ep-3"))
        await dev.recv()
        await asyncio.sleep(0.05)
        cmds = [{"reqID": 1, "msgType": "write",
                 "data": {"path": "/3/0/15", "value": "UTC+2"}},
                {"reqID": 2, "msgType": "execute",
                 "data": {"path": "/3/0/4", "args": "0"}},
                {"reqID": 3, "msgType": "write", "data": {
                    "path": "/3/0", "value": [{"kind": "resource", "id": 14,
                                               "value": "+02"}]}},
                {"reqID": 4, "msgType": "observe",
                 "data": {"path": "/3/0/9"}},
                {"reqID": 5, "msgType": "cancel-observe",
                 "data": {"path": "/3/0/9"}}]
        reqs = []
        for cmd in cmds:
            node.broker.publish(pkg.make("ctl", 0, "lwm2m/ep-3/dn/cmd",
                                         json.dumps(cmd).encode()))
            req = await dev.recv()
            reqs.append(req)
            dev.send(CO.CoapMessage(type=CO.ACK, code=CO.CHANGED,
                                    message_id=req.message_id,
                                    token=req.token))
        # a notification on the observed token
        dev.send(CO.CoapMessage(type=CO.NON, code=CO.CONTENT, message_id=77,
                                token=reqs[3].token,
                                options=[(CO.OPT_OBSERVE, b"\x02")],
                                payload=b"60"))
        await asyncio.sleep(0.1)
        dev.close()
        return dev.raw, [(m[1], json.loads(m[2])) for m in cap.msgs]
    raw, msgs = gw_twin(lwm2m_gw, go)
    # register, five answered commands, then the notification: the
    # observe command stays pending, so it goes out as its response
    assert [m[1]["msgType"] for m in msgs] == [
        "register", "write", "execute", "write", "observe",
        "cancel-observe", "observe"]
    assert jcoap.decode(raw[1]).code == jcoap.PUT


@pytest.mark.parametrize("case", ["resources", "paths", "values", "xml"])
def test_lwm2m_object_registry_alike(case, tmp_path):
    """The reference's four ObjectRegistry tests: the core objects'
    resources, name path resolution, typed value decoding and a custom
    DDF XML object, equal in both packages."""
    xml = """<?xml version="1.0" encoding="utf-8"?>
<LWM2M>
  <Object ObjectType="MODefinition">
    <Name>Temperature</Name>
    <ObjectID>3303</ObjectID>
    <MultipleInstances>Multiple</MultipleInstances>
    <Resources>
      <Item ID="5700"><Name>Sensor Value</Name>
        <Operations>R</Operations><Type>Float</Type>
        <MultipleInstances>Single</MultipleInstances>
        <Mandatory>Mandatory</Mandatory></Item>
      <Item ID="5701"><Name>Sensor Units</Name>
        <Operations>R</Operations><Type>String</Type>
        <MultipleInstances>Single</MultipleInstances>
        <Mandatory>Optional</Mandatory></Item>
    </Resources>
  </Object>
</LWM2M>"""
    (tmp_path / "3303.xml").write_text(xml)

    def attempt(fn):
        try:
            return fn()
        except KeyError as e:
            return ("KeyError", str(e))

    def script(pkg):
        reg = pkg.objects.ObjectRegistry.core()
        if case == "resources":
            return [(o, reg.object(o).name, sorted(
                (r.rid, r.name, r.type, r.operations)
                for r in reg.object(o).resources.values()))
                for o in (0, 1, 3, 5)], \
                reg.object(3).resource_by_name("Battery Level").rid
        if case == "paths":
            return [attempt(lambda p=p: reg.resolve_path(p)) for p in (
                "/Device/0/Manufacturer", "/3/0/0", "/LWM2M Server/1/Lifetime",
                "/NoSuchObject/0/x", "/Device/0/NoSuchResource", "/3",
                "/Device")], [reg.path_name(p) for p in (
                    "/3/0/9", "/3", "/1/0/1", "/999/0/1")]
        if case == "values":
            return [reg.decode_value(3, 9, b"\x55"),
                    reg.decode_value(3, 0, b"Acme"),
                    reg.decode_value(3, 9, "42"),
                    reg.decode_value(3, 13, b"\x00\x00\x01\x00")]
        obj = reg.load_xml(str(tmp_path / "3303.xml"))
        return (obj.oid, obj.multiple,
                reg.resolve_path("/Temperature/0/Sensor Value"),
                reg.resource(3303, 5700).type,
                reg.load_xml_dir(str(tmp_path)))
    want, got = both(script)
    assert got == want
    if case == "paths":
        assert want[0][:3] == ["/3/0/0", "/3/0/0", "/1/1/1"]
    if case == "values":
        assert want[:3] == [0x55, "Acme", 42]
    if case == "xml":
        assert want == (3303, True, "/3303/0/5700", "Float", 1)


def test_boot_gateways_from_config_alike(tmp_path):
    """``Node.start_gateways`` boots the file's enabled blocks, a STOMP
    client talks to the booted gateway, and ``stop_listeners`` stops
    them, in both packages."""
    conf = tmp_path / "emqx.conf"
    conf.write_text("""
    listeners { t { type = tcp, bind = "127.0.0.1", port = 0 } }
    broker { device_route = false }
    gateway {
      stomp  { bind = "127.0.0.1", port = 0 }
      mqttsn { bind = "127.0.0.1", port = 0, enable = false }
      coap   { bind = "127.0.0.1", port = 0 }
    }
    """)

    def script(pkg):
        kw = {"device": "cpu"} if pkg is PORT else {}
        node = pkg.Node.from_config_file(str(conf), name=NAME, **kw)

        async def go():
            await node.start_listeners()
            started = await node.start_gateways()
            reg = node.gateway_registry
            out = [[type(g).__name__ for g in started],
                   reg.lookup("stomp") is started[0],
                   reg.lookup("mqttsn") is None,
                   [{k: v for k, v in d.items() if k != "listener"}
                    for d in reg.list()]]
            try:
                await reg.load("stomp", {})
            except ValueError as e:
                out.append(str(e))
            c = StompClient(pkg, started[0].port)
            await c.connect()
            await c.send(pkg.stomp.Frame("SUBSCRIBE", {
                "id": "s1", "destination": "cfg/t", "receipt": "r1"}))
            await c.recv()
            node.broker.publish(pkg.make("mq", 0, "cfg/t", b"cfg-boot"))
            await c.recv()
            await node.stop_listeners()
            await asyncio.sleep(0.1)
            c.close()
            out += [bytes(c.raw), reg.list(), reg.lookup("stomp"),
                    await reg.unload("stomp")]
            return out
        return run(go())
    want, got = both(script)
    assert got == want
    assert want[0] == ["StompGateway", "CoapGateway"]
    assert want[4] == "gateway stomp already loaded"
    assert want[6:] == [[], None, False]


# ---------------------------------------------------------------------
# ExProto
# ---------------------------------------------------------------------
XPKG = "/emqx.exproto.v1"


class LineProtocolHandler:
    """The external program: a CONNECT / SUB / PUB line protocol over
    exproto (the reference's ``tests/test_exproto.py`` handler)."""

    def __init__(self):
        self.adapter = None

    def _call(self, method, req, req_cls):
        call = self.adapter.unary_unary(
            f"{XPKG}.ConnectionAdapter/{method}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=xpb.CodeResponse.FromString)
        return call(req, timeout=5)

    def on_received_bytes(self, request_iterator, _ctx):
        for req in request_iterator:
            for line in req.bytes.decode().splitlines():
                self._handle_line(req.conn, line.strip())
        return xpb.EmptySuccess()

    def _handle_line(self, conn, line):
        if line.startswith("CONNECT "):
            cid = line.split(" ", 1)[1]
            r = self._call("Authenticate", xpb.AuthenticateRequest(
                conn=conn, clientinfo=xpb.ClientInfo(
                    proto_name="line", proto_ver="1", clientid=cid)),
                xpb.AuthenticateRequest)
            out = b"CONNACK\n" if r.code == 0 else b"REFUSED\n"
            self._call("Send", xpb.SendBytesRequest(conn=conn, bytes=out),
                       xpb.SendBytesRequest)
        elif line.startswith("SUB "):
            self._call("Subscribe", xpb.SubscribeRequest(
                conn=conn, topic=line.split(" ", 1)[1], qos=1),
                xpb.SubscribeRequest)
            self._call("Send", xpb.SendBytesRequest(
                conn=conn, bytes=b"SUBACK\n"), xpb.SendBytesRequest)
        elif line.startswith("PUB "):
            _, topic, payload = line.split(" ", 2)
            self._call("Publish", xpb.PublishRequest(
                conn=conn, topic=topic, qos=0, payload=payload.encode()),
                xpb.PublishRequest)

    def on_received_messages(self, request_iterator, _ctx):
        for req in request_iterator:
            for m in req.messages:
                self._call("Send", xpb.SendBytesRequest(
                    conn=req.conn, bytes=f"MSG {m.topic} "
                    f"{m.payload.decode()}\n".encode()),
                    xpb.SendBytesRequest)
        return xpb.EmptySuccess()

    @staticmethod
    def drain(request_iterator, _ctx):
        for _ in request_iterator:
            pass
        return xpb.EmptySuccess()

    def make_server(self):
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))

        def stream(fn, req_cls):
            return grpc.stream_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=xpb.EmptySuccess.SerializeToString)

        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "emqx.exproto.v1.ConnectionHandler", {
                    "OnSocketCreated": stream(self.drain,
                                              xpb.SocketCreatedRequest),
                    "OnSocketClosed": stream(self.drain,
                                             xpb.SocketClosedRequest),
                    "OnReceivedBytes": stream(self.on_received_bytes,
                                              xpb.ReceivedBytesRequest),
                    "OnTimerTimeout": stream(self.drain,
                                             xpb.TimerTimeoutRequest),
                    "OnReceivedMessages": stream(
                        self.on_received_messages,
                        xpb.ReceivedMessagesRequest),
                }),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        return server, port


def test_exproto_end_to_end_alike():
    """A line client over the exproto gateway: the same bytes back, the
    same core deliveries (from ``exproto:<clientid>``), the same CM
    entry, in both packages."""
    def script(pkg):
        handler = LineProtocolHandler()
        hserver, hport = handler.make_server()
        node = pkg.node()
        gw = pkg.exproto.ExprotoGateway(node, {
            "port": 0, "adapter_port": 0,
            "handler_address": f"127.0.0.1:{hport}"})

        async def go():
            await gw.start()
            handler.adapter = grpc.insecure_channel(
                f"127.0.0.1:{gw.adapter_port}")
            cap = capture(node, "ex/#")
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           gw.port)
            lines = []
            for send, expect in ((b"CONNECT dev42\n", True),
                                 (b"SUB ex/down\n", True),
                                 (b"PUB ex/up hello-from-line\n", False)):
                writer.write(send)
                await writer.drain()
                if expect:
                    lines.append(await asyncio.wait_for(reader.readline(),
                                                        10))
            for _ in range(100):
                await asyncio.sleep(0.05)
                if cap.msgs:
                    break
            node.broker.publish(pkg.make("mq", 0, "ex/down", b"to-device"))
            lines.append(await asyncio.wait_for(reader.readline(), 10))
            registered = node.cm.lookup_channel("exproto:dev42") is not None
            writer.close()
            await asyncio.sleep(0.2)
            await gw.stop()
            handler.adapter.close()
            return lines, cap.msgs, registered
        try:
            return run(go())
        finally:
            hserver.stop(grace=0.2)
    want, got = both(script)
    assert got == want
    lines, msgs, registered = want
    assert lines == [b"CONNACK\n", b"SUBACK\n", b"MSG ex/down to-device\n"]
    assert [m[2:5] for m in msgs] == [(b"hello-from-line", 0,
                                       "exproto:dev42"),
                                      (b"to-device", 0, "mq")]
    assert registered


# ---------------------------------------------------------------------
# the delivery lanes serve gateway subscribers
# ---------------------------------------------------------------------
LANE_MSGS = 400


def test_lanes_deliver_to_gateway_subscribers_as_inline():
    """An MQTT flood through a device-pinned CPU node of the port, with
    STOMP, MQTT-SN and CoAP subscribers on wildcard filters: the delivery
    lanes hand every row to the gateways' ``deliver`` (``DeliveryView``s),
    and each client reads the same bytes as on the same node with the
    lanes off (``deliver_lanes: 0``)."""
    def script(lanes: int):
        for mod in (tstomp, tsn):
            mod.uuid = SeqUuid()
        node = TNode({"broker": {"max_publish_batch": 64,
                                 "deliver_lanes": lanes}}, device="cpu",
                     name=NAME)
        st = tstomp.StompGateway(node, {"port": 0})
        sn = tsn.MqttSnGateway(node, {"port": 0})
        co = tcoap.CoapGateway(node, {"port": 0})

        async def go():
            for gw in (st, sn, co):
                await gw.start()
            a = StompClient(PORT, st.port)
            await a.connect()
            await a.send(tstomp.Frame("SUBSCRIBE", {
                "id": "1", "destination": "fl/+/even/#", "receipt": "r"}))
            await a.recv()
            s = await SnClient.create(PORT, sn.port)
            await s.connect(b"snsub")
            await s.subscribe_name(b"fl/3/#", qos=0)
            c = await CoapClient.create(PORT, co.port)
            c.send(mqtt_req(tcoap, tcoap.GET, "fl/+/odd/+", 1, token=b"\x05",
                            observe=0, query=("c=obs",)))
            await c.recv()
            eng = node.device_engine
            eng.rebuild()
            eng._warm_compile((eng._built, eng._tables, eng._cursors))
            node.publish_batcher._device_worth_it = lambda: True
            m = node.metrics
            rows0 = m.val("pipeline.deliver.rows")
            futs = [asyncio.ensure_future(node.publish_async(tmessage.make(
                f"p{k % 4}", k % 2, f"fl/{k % 8}/{('even', 'odd')[k % 2]}"
                f"/{k}", b"m%d" % k))) for k in range(LANE_MSGS)]
            counts = await asyncio.wait_for(asyncio.gather(*futs),
                                            TIMEOUT_S)
            want = {"stomp": LANE_MSGS // 2,
                    "sn": len([k for k in range(LANE_MSGS) if k % 8 == 3]),
                    "coap": LANE_MSGS // 2}
            for _ in range(400):
                n_st = a.raw.count(b"MESSAGE\n")
                n_sn = sum(1 for d in s.raw if d[1] == tsn.PUBLISH)
                if (n_st, n_sn, len(c.raw) - 1) == tuple(want.values()):
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.1)
            out = {"stomp": bytes(a.raw), "sn": list(s.raw),
                   "coap": list(c.raw), "counts": counts,
                   "device_batches": m.val("routing.device.batches"),
                   "lane_rows": m.val("pipeline.deliver.rows") - rows0,
                   "host": m.val("routing.host.messages"), "want": want}
            a.close()
            s.close()
            c.close()
            for gw in (st, sn, co):
                await gw.stop()
            await node.publish_batcher.stop()
            node.publish_batcher.close()
            return out
        return run(go())
    on, off = script(4), script(0)
    assert on["device_batches"] >= 1 and off["device_batches"] >= 1
    assert on["host"] == off["host"] == 0
    assert on["lane_rows"] > 0 and off["lane_rows"] == 0
    for key in ("stomp", "sn", "coap", "counts"):
        assert on[key] == off[key], key
    want = on["want"]
    assert on["stomp"].count(b"MESSAGE\n") == want["stomp"]
    assert sum(1 for d in on["sn"] if d[1] == tsn.PUBLISH) == want["sn"]
    assert len(on["coap"]) - 1 == want["coap"]
    # per connection, the publish order of each publisher
    bodies = re.findall(rb"destination:fl/\d/even/(\d+)", on["stomp"])
    assert [int(b) for b in bodies] == sorted(int(b) for b in bodies)
