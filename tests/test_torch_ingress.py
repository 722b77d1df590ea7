"""Port vs JAX reference: the columnar PUBLISH ingress.

The same seeded inputs go through the reference (``emqx_tpu``) and the
port (``emqx_tpu_torch``), and every comparison is exact: the knobs, the
parser's ``feed_columnar`` items and errors on mixed, chunked and mutated
v3.1.1 and v5 streams, the port's host library against its own
pure-Python mirrors and against the reference's library, the topic encode
with and without the intern table's native mirror, the engine's burst
memo, ``submit_burst``, the channel's burst hand-off (its packets and
counters, error rows included), and a live-TCP twin on ``device="cpu"``
(columnar on vs off on the port, the port vs the reference with it on).
The reference's environment knobs are unset: only config decides.
"""

import asyncio
import json
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke as cs
from emqx_tpu import native as JN
from emqx_tpu.broker import connection as JConn
from emqx_tpu.broker.channel import Channel as JChannel
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.client import Client as JClient
from emqx_tpu.mqtt import frame as JF
from emqx_tpu.mqtt import packet as JP
from emqx_tpu.ops import intern as JI
from emqx_tpu.ops import match as JM
from emqx_tpu_torch import native as TN
from emqx_tpu_torch.broker import connection as TConn
from emqx_tpu_torch.broker import device_engine as TDE
from emqx_tpu_torch.broker.channel import Channel as TChannel
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client as TClient
from emqx_tpu_torch.mqtt import frame as TF
from emqx_tpu_torch.mqtt import packet as TP
from emqx_tpu_torch.ops import intern as TI
from emqx_tpu_torch.ops import match as TM
from emqx_tpu_torch.utils.topic import tokens
from tests.test_torch_codec import SPECS, V4, V5, as_data, build
from tests.test_torch_engine import JAX_BROKER

torch.set_num_threads(1)

SEED = 20261017
TIMEOUT_S = 120
L = 16                      # the engine's max_levels


@pytest.fixture(autouse=True)
def _config_only(monkeypatch):
    """The reference's env knobs are not ported: only config decides."""
    for k in ("EMQX_TPU_COLUMNAR_INGRESS", "EMQX_TPU_INGRESS_LANES"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, True, False, 0, 1])
def test_columnar_knob_equals_reference(value):
    assert TConn.resolve_columnar_ingress(value) \
        is JConn.resolve_columnar_ingress(value)


@pytest.mark.parametrize("value", [None, 1, 2, 6, "3"])
def test_lanes_knob_equals_reference(value):
    assert TConn.resolve_ingress_lanes(value) \
        == JConn.resolve_ingress_lanes(value)


@pytest.mark.parametrize("value", ["two", 0, -1])
def test_lanes_knob_malformed_raises_as_reference(value):
    for resolve in (TConn.resolve_ingress_lanes,
                    JConn.resolve_ingress_lanes):
        with pytest.raises(ValueError):
            resolve(value)


@pytest.mark.parametrize("broker", [
    {}, {"columnar_ingress": True}, {"ingress_lanes": 3},
    {"columnar_ingress": False, "ingress_lanes": 4},
    {"columnar_ingress": True, "ingress_lanes": 1}])
def test_node_resolves_as_reference(broker):
    """Columnar on and lanes min(4, cpus) by default; off forces one
    lane."""
    t = TNode({"broker": broker}, device="cpu")
    t.publish_batcher.close()
    j = JNode({"broker": broker}, use_device=False)
    assert (t.columnar_ingress, t.ingress_lanes) \
        == (j.columnar_ingress, j.ingress_lanes)


# ---------------------------------------------------------------------
# streams: SPECS packets between runs of seeded PUBLISHes
# ---------------------------------------------------------------------
def _publish_fields(rng, ver) -> dict:
    qos = int(rng.integers(3))
    props = {}
    if ver == V5 and rng.random() < 0.3:
        props = {"message_expiry_interval": int(rng.integers(1000)),
                 "user_property": [("k", "v" * int(rng.integers(5)))]}
    level = ("é" if rng.random() < 0.1 else "") + str(rng.integers(30))
    return dict(topic=f"t/{level}/x",
                payload=bytes(rng.integers(0, 256, int(rng.integers(200)),
                                           dtype=np.uint8)),
                qos=qos, retain=bool(rng.integers(2)),
                dup=bool(qos and rng.integers(2)),
                packet_id=int(rng.integers(1, 65535)) if qos else None,
                properties=props)


def _stream_specs(rng, ver, n: int) -> list:
    others = [(name, f) for name, f, v in SPECS
              if (v == ver or v == V4 and ver == V5) and name != "Connect"]
    out = []
    for _ in range(n):
        if rng.random() < 0.75:
            out.append(("Publish", _publish_fields(rng, ver)))
        else:
            out.append(others[int(rng.integers(len(others)))])
    return out


def _serialize(specs, ver) -> bytes:
    tb = b"".join(TF.serialize(build(TP, n, f), ver) for n, f in specs)
    assert tb == b"".join(JF.serialize(build(JP, n, f), ver)
                          for n, f in specs)
    return tb


def _mutate(rng, stream: bytes) -> bytes:
    b = bytearray(stream)
    kind = int(rng.integers(7))
    if kind == 0:      # truncated mid-frame
        return bytes(b[:int(rng.integers(len(b)))])
    if kind == 1:      # flipped bits
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        return bytes(b)
    if kind == 2:      # an unterminated varint
        return bytes(b) + bytes([0x30, 0x80, 0x80, 0x80, 0x80, 0x01])
    if kind == 3:      # a qos 3 PUBLISH
        return bytes([0x36, 0x04, 0x00, 0x01, 0x61, 0x70]) + bytes(b)
    if kind == 4:      # packet id 0 on a qos 1 PUBLISH
        return bytes([0x32, 0x05, 0x00, 0x01, 0x61, 0x00, 0x00]) + bytes(b)
    if kind == 5:      # a topic that is not UTF-8
        return bytes([0x30, 0x04, 0x00, 0x02, 0xC3, 0x28]) + bytes(b)
    return bytes([0x30, 0x02, 0x00, 0x63]) + bytes(b)   # topic past body


def _chunkings(rng, stream: bytes) -> list:
    out = [[stream]]
    chunks, pos = [], 0
    while pos < len(stream):
        step = int(rng.choice([1, 7, 100, 1500, 5000, 9000]))
        chunks.append(stream[pos:pos + step])
        pos += step
    out.append(chunks)
    return out


def _norm(items) -> list:
    out = []
    for it in items:
        if type(it).__name__ == "PublishBurst":
            out.append(("burst", list(it.topics),
                        [bytes(p) for p in it.payloads], list(it.qos),
                        list(it.retain), list(it.dup), list(it.pids),
                        list(it.props)))
        else:
            out.append(as_data(it))
    return out


def _flatten(items) -> list:
    """Columnar items as the per-packet path's Packet data."""
    out = []
    for it in items:
        if type(it).__name__ == "PublishBurst":
            for j in range(len(it)):
                out.append(as_data(TP.Publish(
                    topic=it.topics[j], payload=it.payloads[j],
                    qos=it.qos[j], retain=it.retain[j], dup=it.dup[j],
                    packet_id=it.pids[j], properties=it.props[j])))
        else:
            out.append(as_data(it))
    return out


def _drive(frame, ver, chunks, columnar=True, norm=_norm):
    p = frame.FrameParser(version=ver)
    out, err = [], None
    for c in chunks:
        try:
            items = p.feed_columnar(c) if columnar else p.feed(c)
        except frame.FrameError as e:
            err = e.code
            break
        out.extend(norm(items))
    return out, err, (p.pending_bytes if err is None else -1)


@pytest.mark.parametrize("ver", [V4, V5])
@pytest.mark.parametrize("kind", ["whole", "chunked", "mutated"])
def test_feed_columnar_equals_reference(ver, kind):
    """Every PublishBurst column and every fallback Packet, in order, and
    every FrameError code equal the reference's; flattened, the items
    equal the port's own per-packet parse."""
    rng = np.random.default_rng([SEED, ver, len(kind)])
    bursts = 0
    for k in range(12):
        stream = _serialize(_stream_specs(rng, ver,
                                          int(rng.integers(60, 400))), ver)
        if kind == "mutated":
            stream = _mutate(rng, stream)
        for chunks in _chunkings(rng, stream)[:1 if kind == "whole" else 2]:
            t = _drive(TF, ver, chunks)
            assert t == _drive(JF, ver, chunks), (kind, k)
            flat = _drive(TF, ver, chunks, norm=_flatten)
            assert flat == _drive(TF, ver, chunks, columnar=False,
                                  norm=lambda it: [as_data(p)
                                                   for p in it]), (kind, k)
            bursts += sum(1 for x in t[0] if x[0] == "burst")
    assert bursts > 0


def test_feed_columnar_small_reads_and_pre_connect_stay_per_packet():
    small = TF.serialize(TP.Publish(topic="a", payload=b"b"), V4)
    items = TF.FrameParser(version=V4).feed_columnar(small)
    assert len(items) == 1 and type(items[0]) is TP.Publish
    conn = TF.serialize(TP.Connect(proto_name="MQTT", proto_ver=V4,
                                   clientid="c"), V4)
    blob = conn + b"".join(TF.serialize(TP.Publish(
        topic=f"t/{i}", payload=b"x" * 100), V4) for i in range(200))
    t, j = TF.FrameParser(), JF.FrameParser()
    ti, ji = t.feed_columnar(blob), j.feed_columnar(blob)
    assert _norm(ti) == _norm(ji)
    assert type(ti[0]) is TP.Connect
    assert sum(type(x) is TP.Publish for x in ti) == 200
    assert all(x.ingress_ns > 0 for x in ti if type(x) is TP.Publish)


# ---------------------------------------------------------------------
# the host library against its mirrors and the reference's library
# ---------------------------------------------------------------------
def test_native_library_is_active():
    assert TN.available()
    assert TN.library_path().exists()


@pytest.mark.parametrize("ver", [V4, V5])
def test_native_decode_equals_mirror_and_reference(ver):
    rng = np.random.default_rng([SEED, 7, ver])
    decoded = 0
    for k in range(40):
        stream = _serialize(_stream_specs(rng, ver, 60), ver)
        if k % 3:
            stream = _mutate(rng, stream)
        for max_size in (0, 256):
            res = []
            for scan in (
                    lambda: TN.frame_scan_np(stream, 4096, max_size),
                    lambda: JN.frame_scan_np(stream, 4096, max_size),
                    lambda: TN._frame_scan_py(stream, 4096, max_size)):
                try:
                    res.append(scan())
                except (TN.FrameScanError, JN.FrameScanError) as e:
                    res.append(str(e))
            if isinstance(res[0], str):
                assert res[1] == res[2] == res[0]
                continue
            (off, lens, cons), (joff, jlens, jcons), (frames, pcons) = res
            assert off.tolist() == joff.tolist() == [f[0] for f in frames]
            assert lens.tolist() == jlens.tolist() == [f[1] for f in frames]
            assert cons == jcons == pcons
            assert TN.frame_scan(stream, 4096, max_size) == (frames, pcons)
            t = TN.publish_decode_columnar(stream, off, lens, ver == V5)
            j = JN.publish_decode_columnar(stream, off, lens, ver == V5)
            m = {c: np.zeros_like(v) for c, v in t.items()}
            TN._publish_decode_columnar_py(stream, off, lens, ver == V5, m)
            for c in TN.DECODE_COLUMNS:
                assert t[c].dtype == j[c].dtype == m[c].dtype
                assert (t[c] == j[c]).all() and (t[c] == m[c]).all(), (k, c)
            decoded += int(t["kind"].sum())
    assert decoded > 100


def _intern_pair(words):
    t, j = TI.InternTable(), JI.InternTable()
    for w in words:
        assert t.intern(w) == j.intern(w)
    return t, j


def _topics(rng, pool, n: int) -> list:
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 21))           # some past L levels
        ws = [pool[int(rng.integers(len(pool)))] if rng.random() < 0.8
              else f"u{int(rng.integers(1000))}" for _ in range(depth)]
        if rng.random() < 0.1:
            ws[0] = "$SYS"
        if rng.random() < 0.1:
            ws[int(rng.integers(depth))] = ""
        out.append("/".join(ws))
    return out


def _eq(a, b):
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.shape == y.shape and (np.asarray(x) == np.asarray(y)).all()


def test_topic_encode_native_equals_python_and_reference():
    """encode_topics_str through the mirror (one native call), through
    the Python per-word path (mirror retired), and the reference's."""
    rng = np.random.default_rng([SEED, 11])
    pool = [f"w{i}" for i in range(200)] + ["+", "#", "é"]
    t, j = _intern_pair(pool[:150])
    topics = _topics(rng, pool, 500)
    native = TM.encode_topics_str(t, topics, L)
    assert type(t.mirror_handle()) is int
    py = TM.encode_topics(t, [tokens(x) for x in topics], L)
    _eq(native, py)
    _eq(native, JM.encode_topics_str(j, topics, L))
    # words interned after the mirror attached reach it (gap-free)
    for w in pool[150:]:
        assert t.intern(w) == j.intern(w)
    _eq(TM.encode_topics_str(t, topics, L), JM.encode_topics_str(j, topics,
                                                                  L))
    off, _ = _intern_pair(pool)
    off._mirror = False                     # retired: the Python path
    _eq(TM.encode_topics_str(off, topics, L), TM.encode_topics_str(t, topics,
                                                                    L))


def test_intern_mirror_attach_under_concurrent_interns():
    """A background thread interns filter words while the loop thread
    attaches the mirror and encodes: no word is lost to the mirror."""
    rng = np.random.default_rng([SEED, 13])
    words = [f"c{i}" for i in range(4000)]
    table = TI.InternTable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=lambda: [table.intern(w)
                                              for w in words])
        th.start()
        while th.is_alive():
            TM.encode_topics_str(table, ["c1/c2/c3"], L)
        th.join(30)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert type(table.mirror_handle()) is int
    topics = _topics(rng, words, 400)
    _eq(TM.encode_topics_str(table, topics, L),
        TM.encode_topics(table, [tokens(x) for x in topics], L))


# ---------------------------------------------------------------------
# the engine's burst memo and the batcher's burst hand-off
# ---------------------------------------------------------------------
class Sink:
    def __init__(self):
        self.got = []

    def deliver(self, f, m):
        self.got.append((f, m.topic))
        return True


def test_preencode_memo_intern_length_guard(monkeypatch):
    """The window encodes through the burst memo while the intern table's
    length holds; a word interned in between drops it, and the encode
    equals a fresh one either way."""
    node = TNode({"broker": {"deliver_lanes": 0}}, device="cpu")
    node.publish_batcher.close()
    eng = node.device_engine
    sid = node.broker.register(Sink(), "c0")
    node.broker.subscribe(sid, "pe/+/b", {"qos": 0})
    eng.rebuild()
    topics = ["pe/a/b", "pe/c", "pe/new/b", "pe/a/b"]
    fresh = lambda: TM.encode_topics(eng.intern, [tokens(x) for x in topics],
                                     eng.max_levels)
    eng.preencode_burst(topics)
    assert eng._burst_enc is not None and len(eng._burst_enc[0]) == 3
    memo = eng._encode_publish_batch(topics)
    _eq(memo, fresh())
    calls = []
    real = TDE.encode_topics_str
    monkeypatch.setattr(TDE, "encode_topics_str",
                        lambda *a: calls.append(a) or real(*a))
    msgs = [tmake("p", 0, x, b"") for x in topics]
    counts = eng.route_batch(msgs)
    assert calls == []              # the window gathered from the memo
    node.broker.subscribe(sid, "pe/new/+", {"qos": 0})   # interns "new"
    stale = eng._encode_publish_batch(topics)
    _eq(stale, fresh())
    assert (stale[0] != memo[0]).any()     # "new" was UNKNOWN in the memo
    assert len(calls) == 1
    assert counts == [1, 0, 1, 1]


def _burst_rows(make):
    return [(make("p", i % 2, f"sb/{i}", b"%d" % i), i % 2 == 1)
            for i in range(12)]


async def _submit(node, make, max_pending: int):
    bt = node.publish_batcher
    bt.max_pending = max_pending
    futs = bt.submit_burst(_burst_rows(make))
    queued = [m.topic for m, _f in bt._queue]
    counts = {i: await asyncio.wait_for(f, TIMEOUT_S)
              for i, f in futs.items()}
    await bt.stop()
    return sorted(futs), queued, counts


@pytest.mark.parametrize("max_pending", [8, 1000])
def test_submit_burst_order_futures_backpressure(max_pending):
    """QoS 0 rows get no futures, QoS 1 rows do, and the last row gets
    one when max_pending is crossed; the queue keeps row order."""
    t = TNode({"broker": {"deliver_lanes": 0}}, device="cpu")
    got = asyncio.run(_submit(t, tmake, max_pending))
    t.publish_batcher.close()
    j = JNode({"broker": JAX_BROKER}, use_device=True)
    assert got == asyncio.run(_submit(j, jmake, max_pending))
    keys, queued, counts = got
    assert queued == [f"sb/{i}" for i in range(12)]
    assert set(keys) >= {i for i in range(12) if i % 2}
    assert (11 in keys) and (max_pending < 12 or len(keys) == 6)
    assert set(counts.values()) == {0}


# ---------------------------------------------------------------------
# the channel's burst hand-off against the reference channel
# ---------------------------------------------------------------------
class Wire:
    def __init__(self):
        self.pkts, self.closed = [], []

    def send(self, pkts):
        self.pkts.extend(pkts)

    def close(self, reason):
        self.closed.append(reason)


COUNTERS = (
    "packets.received", "packets.publish.received", "packets.publish.error",
    "packets.publish.quota_exceeded", "packets.publish.dropped",
    "packets.publish.auth_error", "messages.received",
    "messages.qos0.received", "messages.qos1.received",
    "messages.qos2.received", "messages.publish", "client.authorize")


def _burst_specs(case: str, ver: int) -> list:
    """Seeded PUBLISH rows with the case's error rows among them."""
    rng = np.random.default_rng([SEED, len(case), ver])
    rows = []
    top_qos = 2 if case == "maxqos" else 3    # one QoS 2 row, at 150
    for i in range(240):
        qos = int(rng.integers(top_qos))
        rows.append(dict(topic=f"t/{int(rng.integers(8))}",
                         payload=b"%06d" % i + b"x" * 40, qos=qos,
                         retain=bool(rng.random() < 0.1),
                         packet_id=i + 1 if qos else None))
    for i in (20, 21, 130):              # wildcards in a topic NAME
        rows[i].update(topic="t/+/bad", qos=1, packet_id=1000 + i)
    if case != "maxqos":
        rows[40].update(qos=2, packet_id=4040)
        rows[41].update(qos=2, packet_id=4040)      # packet id in use
    if ver == V5:
        rows[60].update(topic="al/one", properties={"topic_alias": 3})
        rows[61].update(topic="", properties={"topic_alias": 3})
        rows[200].update(topic="", properties={"topic_alias": 9})  # unknown
    rows[230].update(topic="t/#", qos=0)   # v5: DISCONNECT 0x90
    if case == "maxqos":
        rows[150].update(qos=2, packet_id=5000)
    return [("Publish", r) for r in rows]


CASES = {
    "plain": {},
    "retain": {"mqtt": {"retain_available": False}},
    "quota": {"rate_limit": {"quota_messages_routing": 50}},
    "maxqos": {"mqtt": {"max_qos_allowed": 1}},
}


async def _channel_burst(pkg, node, ver, blob, columnar=True):
    conninfo = {"peername": ("127.0.0.1", 5000), "zone": None,
                "sockname": ("127.0.0.1", 1883)}
    Channel = JChannel if pkg is JP else TChannel
    frame = JF if pkg is JP else TF
    sub_w, pub_w = Wire(), Wire()
    sub = Channel(node, conninfo, sub_w.send, sub_w.close)
    await sub.handle_in(pkg.Connect(proto_ver=ver, clientid="sub"))
    await sub.handle_in(pkg.Subscribe(packet_id=1, filters=[
        ("t/#", pkg.SubOpts(qos=1)), ("al/#", pkg.SubOpts(qos=0))]))
    pub = Channel(node, conninfo, pub_w.send, pub_w.close)
    await pub.handle_in(pkg.Connect(proto_ver=ver, clientid="pub"))
    m = node.metrics
    before = {k: m.val(k) for k in COUNTERS}
    if columnar:
        items = frame.FrameParser(version=ver).feed_columnar(blob)
        assert [type(it).__name__ for it in items] == ["PublishBurst"]
        await pub.handle_publish_burst(items[0])
    else:
        # the per-packet path, as each package's connection drives it
        for it in frame.FrameParser(version=ver).feed(blob):
            await pub.handle_in(it)
        if pkg is TP:
            await pub.flush_acks()
    stable, last = 0, -1
    while stable < 20:                     # deliveries still in flight
        await asyncio.sleep(0.01)
        n = len(sub_w.pkts)
        stable, last = (stable + 1, n) if n == last else (0, n)
    if getattr(node, "publish_batcher", None) is not None:
        await node.publish_batcher.stop()
    return ([as_data(p) for p in pub_w.pkts], pub_w.closed,
            [as_data(p) for p in sub_w.pkts[2:]],
            {k: m.val(k) - v for k, v in before.items()})


class _ScriptedClock:
    """One clock for both packages' token buckets: it stands still, so a
    bucket refills the same (not at all) in both runs, however long each
    takes to route its rows."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def monotonic(self) -> float:
        return self.t


@pytest.mark.parametrize("ver", [V4, V5])
@pytest.mark.parametrize("case", list(CASES))
def test_handle_publish_burst_equals_reference(case, ver, monkeypatch):
    """The acks, error acks and DISCONNECTs on the publisher's wire, in
    row order, the subscriber's deliveries and the counters equal the
    reference channel's. Both limiters read one scripted clock: each run
    read its own wall clock before, and the quota case's buckets refilled
    by different amounts when one run was slower (under xdist)."""
    from emqx_tpu.broker import limiter as JL
    from emqx_tpu_torch.broker import limiter as TL
    clock = _ScriptedClock()
    monkeypatch.setattr(JL, "time", clock)
    monkeypatch.setattr(TL, "time", clock)
    blob = _serialize(_burst_specs(case, ver), ver)
    conf = dict(CASES[case])
    t = TNode(dict(conf, broker={"deliver_lanes": 0}), device="cpu")
    got = asyncio.run(asyncio.wait_for(_channel_burst(TP, t, ver, blob),
                                       TIMEOUT_S))
    t.publish_batcher.close()
    j = JNode(dict(conf), use_device=False)
    want = asyncio.run(asyncio.wait_for(_channel_burst(JP, j, ver, blob),
                                        TIMEOUT_S))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[3]["packets.publish.received"] == 240
    assert len(got[0]) > 50


@pytest.mark.parametrize("ver", [V4, V5])
@pytest.mark.parametrize("case", ["plain", "retain", "maxqos"])
def test_per_packet_path_equals_reference(case, ver):
    """Columnar off: the same rows one handle_in each. The port queues a
    read's acks (flush_acks); a DISCONNECT among them goes out after the
    acks owed before it, as the reference's per-packet channel sends
    them. (The quota case is left out: the reference awaits each QoS 1
    row's routing, so its quota bucket refills on another clock.)"""
    blob = _serialize(_burst_specs(case, ver), ver)
    conf = dict(CASES[case])
    t = TNode(dict(conf, broker={"deliver_lanes": 0}), device="cpu")
    got = asyncio.run(asyncio.wait_for(
        _channel_burst(TP, t, ver, blob, columnar=False), TIMEOUT_S))
    t.publish_batcher.close()
    j = JNode(dict(conf), use_device=False)
    want = asyncio.run(asyncio.wait_for(
        _channel_burst(JP, j, ver, blob, columnar=False), TIMEOUT_S))
    assert got == want
    assert len(got[0]) > 50


# ---------------------------------------------------------------------
# live TCP twin
# ---------------------------------------------------------------------
N_BULK, N_Q1 = 1500, 30


async def _serve(node, listener_cls, client_cls, pkg, frame) -> dict:
    lst = listener_cls(node, bind="127.0.0.1", port=0)
    await lst.start()
    sub = client_cls(port=lst.port, clientid="sub")
    await sub.connect()
    await sub.subscribe("t/#", qos=1)
    pub = client_cls(port=lst.port, clientid="pub")
    await pub.connect()
    # one large write: the columnar node takes the burst path
    pub._writer.write(b"".join(frame.serialize(pkg.Publish(
        topic=f"t/{i % 8}", payload=b"%06d" % i), V4)
        for i in range(N_BULK)))
    await pub._writer.drain()
    acks = [await pub.publish(f"t/q1/{i % 4}", b"%06d" % i, qos=1)
            for i in range(N_Q1)]
    got = []
    while len(got) < N_BULK + N_Q1:
        m = await asyncio.wait_for(sub.messages.get(), 30)
        got.append((m.topic, bytes(m.payload)))
    snap = node.pipeline_telemetry.snapshot()
    res = {"got": got, "acks": [as_data(a) for a in acks],
           "recv": node.metrics.val("packets.publish.received"),
           "ingress": snap.get("ingress"),
           "lane_servers": len(lst._lane_servers),
           "lane_accepted": sum(v for k, v in node.metrics.all().items()
                                if k.startswith("pipeline.ingress.lane"))}
    await pub.close()
    await sub.close()
    await lst.stop()
    if node.publish_batcher is not None:
        await node.publish_batcher.stop()
    return res


def _port(columnar: bool, lanes: int) -> dict:
    node = TNode({"broker": {"columnar_ingress": columnar,
                             "ingress_lanes": lanes}}, device="cpu")
    try:
        return asyncio.run(asyncio.wait_for(
            _serve(node, TConn.Listener, TClient, TP, TF), TIMEOUT_S))
    finally:
        node.publish_batcher.close()


@pytest.fixture(scope="module")
def twins() -> dict:
    j = JNode({"broker": {"columnar_ingress": True, "ingress_lanes": 1}},
              use_device=False)
    return {"on": _port(True, 2), "off": _port(False, 2),
            "ref": asyncio.run(asyncio.wait_for(
                _serve(j, JConn.Listener, JClient, JP, JF), TIMEOUT_S))}


def test_live_twin_on_equals_off(twins):
    on, off = twins["on"], twins["off"]
    assert on["got"] == off["got"]            # deliveries and their order
    assert on["acks"] == off["acks"]
    assert on["recv"] == off["recv"] == N_BULK + N_Q1
    seqs = [p for t, p in on["got"] if not t.startswith("t/q1")]
    assert seqs == sorted(seqs)               # per-publisher order


def test_live_twin_port_equals_reference(twins):
    on, ref = twins["on"], twins["ref"]
    assert on["got"] == ref["got"]
    assert on["acks"] == ref["acks"]
    assert on["recv"] == ref["recv"]
    assert ref["ingress"]["rows"] >= N_BULK


def test_live_twin_ingress_section_and_lanes(twins):
    on, off = twins["on"], twins["off"]
    assert on["ingress"]["rows"] >= N_BULK and on["ingress"]["bursts"] >= 1
    assert on["ingress"]["fallback_frames"] >= N_Q1
    assert off["ingress"] is None
    assert on["lane_servers"] == 2 and on["lane_accepted"] == 2
    assert off["lane_servers"] == 0 and off["lane_accepted"] == 0


def test_chip_smoke_ingress_on_cpu():
    """chip_smoke.py's phase 11 rehearsed on the CPU at a reduced size
    (8 connections x 60 publishes, each configuration in this process):
    on and off deliver the same messages in order, the columnar run takes
    the burst path on the native library, the per-packet run has no
    ingress section."""
    on = cs.ingress_one("cpu", 8, True, n_msgs=60)
    off = cs.ingress_one("cpu", 8, False, n_msgs=60)
    cs.check_ingress_pair(on, off)
    assert on["delivered"] == off["delivered"] == 8 * len(range(0, 60, 16))
    assert on["native"] is True


def test_device_sample_seeds_then_pools_small_windows():
    """The chooser's device estimate: the median of the first three
    windows seeds it (one stalled first window does not), then each
    sample spans at least max_batch messages — small windows pool until
    they do, and the pooled sample is their cost per message."""
    from types import SimpleNamespace

    from emqx_tpu_torch.broker.batcher import PublishBatcher
    from emqx_tpu_torch.broker.metrics import Metrics
    b = PublishBatcher(SimpleNamespace(metrics=Metrics()), None,
                       max_batch=1024)
    for us in (88, 31, 29):                  # a stalled first window
        assert b._dev_msg_s is None and b._device_worth_it()
        b._device_sample(1024 * us * 1e-6, 1024)
    assert b._dev_msg_s == pytest.approx(31e-6)
    for _ in range(5):                       # 335 messages at 95 us each
        b._device_sample(67 * 95e-6, 67)
    assert b._dev_msg_s == pytest.approx(31e-6)
    assert len(b.cost_samples["device"]) == 3
    b._device_sample(1024 * 30e-6, 1024)     # the pool reaches 1,359
    pooled = (5 * 67 * 95e-6 + 1024 * 30e-6) / (5 * 67 + 1024)
    assert b.cost_samples["device"][-1] == pytest.approx(pooled)
    assert b._dev_msg_s == pytest.approx(0.8 * 31e-6 + 0.2 * pooled)
    assert b._dev_pending == (0.0, 0)
    b.close()
