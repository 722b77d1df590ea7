"""Port vs JAX reference: the feature apps ``start_apps`` boots.

The same inputs go through the reference's ``emqx_tpu/apps`` and the
port's ``emqx_tpu_torch/apps`` and must give equal outputs: the retained
store's topic index under seeded random topics and filters, the retainer
(store, clear, limits, expiry, ``$SYS`` exclusion, both storages, a disc
journal written by one package and read by the other, retain handling
over TCP), delayed publish under a scripted clock, the rewrite rules,
topic metrics, event messages, flapping bans, the overload governor's
``defer_retained`` parking and drain, the boot from a config file (the
rule engine, the access-control chains and their database arms
included, exhook against an in-process provider, and the gateway
section), and a flood
through booted nodes with the apps on, with the delivery lanes and with
the inline loop. Inputs are the reference's ``tests/test_apps_modules.py``
and the app cases of ``tests/test_persistence_apps.py``.
"""

import asyncio
import json
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from emqx_tpu.apps import boot as jboot
from emqx_tpu.apps import delayed as jdelayed
from emqx_tpu.apps import event_message as jevent
from emqx_tpu.apps import retainer as jretainer
from emqx_tpu.apps import rewrite as jrewrite
from emqx_tpu.apps import topic_metrics as jtm
from emqx_tpu.broker import banned as jbanned
from emqx_tpu.broker import message as jmessage
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.apps import boot as tboot
from emqx_tpu_torch.apps import delayed as tdelayed
from emqx_tpu_torch.apps import event_message as tevent
from emqx_tpu_torch.apps import retainer as tretainer
from emqx_tpu_torch.apps import rewrite as trewrite
from emqx_tpu_torch.apps import topic_metrics as ttm
from emqx_tpu_torch.broker import banned as tbanned
from emqx_tpu_torch.broker import message as tmessage
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import serialize
from emqx_tpu_torch.utils import topic as T

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 60


def host_conf(conf=None) -> dict:
    out = {"broker": {"device_route": False}}
    for k, v in (conf or {}).items():
        out[k] = dict(out.get(k, {}), **v) if isinstance(v, dict) else v
    return out


REF = types.SimpleNamespace(
    name="ref", ret=jretainer, delayed=jdelayed, rewrite=jrewrite, tm=jtm,
    event=jevent, banned=jbanned, msg=jmessage, boot=jboot,
    Listener=JListener,
    node=lambda conf=None: JNode(host_conf(conf), use_device=False,
                                 name=NAME))
PORT = types.SimpleNamespace(
    name="port", ret=tretainer, delayed=tdelayed, rewrite=trewrite, tm=ttm,
    event=tevent, banned=tbanned, msg=tmessage, boot=tboot,
    Listener=TListener,
    node=lambda conf=None: TNode(host_conf(conf), device="cpu", name=NAME))
PKGS = (REF, PORT)


def both(script):
    """The script's result under the reference and under the port."""
    return [script(pkg) for pkg in PKGS]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


class Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg))
        return True


def rows(sink) -> list:
    return [(f, m.topic, m.payload, m.qos, bool(m.retain))
            for f, m in sink.got]


def retained(pkg, topic, payload=b"x", **kw):
    return pkg.msg.make("p", 0, topic, payload, flags={"retain": True},
                        **kw)


# ---------------------------------------------------------------------
# TopicIndex
# ---------------------------------------------------------------------
WORDS = ("a", "b", "c", "dev", "", "x1", "$SYS", "$q", "t")


def random_topics(r, n: int) -> list:
    out = []
    for _ in range(n):
        depth = int(r.randint(1, 6))
        out.append("/".join(WORDS[int(r.randint(0, len(WORDS)))]
                            for _ in range(depth)))
    return sorted(set(out))


def random_filters(r, n: int) -> list:
    out = ["#", "+", "+/+", "$SYS/#", "a/#", "+/#"]
    for _ in range(n):
        depth = int(r.randint(1, 6))
        ws = []
        for k in range(depth):
            x = r.rand()
            if x < 0.25:
                ws.append("+")
            elif x < 0.35 and k == depth - 1:
                ws.append("#")
            else:
                ws.append(WORDS[int(r.randint(0, len(WORDS)))])
        out.append("/".join(ws))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topic_index_random_equals_reference(seed):
    """A few thousand seeded topics (``$`` roots and empty levels among
    them) and a few hundred filters: every filter's match set equals the
    reference's and the brute-force oracle's, before and after deleting
    a random half."""
    r = np.random.RandomState(seed)
    topics = random_topics(r, 3000)
    filters = random_filters(r, 300)
    ix = [jretainer.TopicIndex(), tretainer.TopicIndex()]
    for t in topics:
        assert ix[0].insert(t) == ix[1].insert(t) is True
    gone = [t for t in topics if r.rand() < 0.5]
    for rnd in range(2):
        live = [t for t in topics if rnd == 0 or t not in set(gone)]
        assert len(ix[0]) == len(ix[1]) == len(live)
        for f in filters:
            want = sorted(ix[0].match(f))
            assert sorted(ix[1].match(f)) == want, f
            assert want == sorted(t for t in live if T.match(t, f)), f
        if rnd == 0:
            for t in gone:
                assert ix[0].delete(t) == ix[1].delete(t) is True
    assert ix[0].delete(gone[0]) == ix[1].delete(gone[0]) is False


INDEX_CASES = {
    "insert_match_delete": (
        ("a/b/c", "a/b/d", "a/x", "b", "$SYS/uptime", "a/b/c"),
        ("a/b/+", "a/#", "#", "$SYS/#", "$SYS/uptime"), ("a/b/c",)),
    "dollar_root": (("$SYS/x", "n/x"), ("#", "+/x", "$SYS/+"), ()),
    "hash_parent": (("sport", "sport/tennis"), ("sport/#", "sport/+"),
                    ("sport",)),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_topic_index_cases_equal_reference(case):
    inserts, filters, deletes = INDEX_CASES[case]

    def script(pkg):
        ix = pkg.ret.TopicIndex()
        out = [ix.insert(t) for t in inserts]
        out.append([sorted(ix.match(f)) for f in filters])
        out += [ix.delete(t) for t in deletes + deletes]
        out.append([sorted(ix.match(f)) for f in filters])
        return out, len(ix)
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# Retainer
# ---------------------------------------------------------------------
def _store_clear(pkg):
    node = pkg.node()
    ret = node.register_app(pkg.ret.Retainer(node).load())
    out = []
    for payload in (b"v1", b"v2", b""):
        node.broker.publish(retained(pkg, "a/b", payload))
        m = ret.lookup("a/b")
        out.append((ret.retained_count(), m and m.payload))
    return out


def _non_retained_and_sys(pkg):
    node = pkg.node()
    ret = pkg.ret.Retainer(node).load()
    node.broker.publish(pkg.msg.make("p", 0, "a/b", b"v"))
    node.broker.publish(retained(pkg, "$SYS/x", b"v"))
    return ret.retained_count()


def _wildcard(pkg):
    node = pkg.node()
    ret = pkg.ret.Retainer(node).load()
    for t in ("a/1", "a/2", "b/1", "$SYS/1"):
        ret._insert(retained(pkg, t))
    return [sorted(m.topic for m in ret.match(f))
            for f in ("a/+", "#", "+/1", "$SYS/#")]


def _max_retained(pkg):
    node = pkg.node({"retainer": {"max_retained_messages": 2}})
    ret = pkg.ret.Retainer(node).load()
    for t in ("a", "b", "c"):
        node.broker.publish(retained(pkg, t))
    node.broker.publish(retained(pkg, "a", b"y"))
    return (ret.retained_count(), ret.lookup("a").payload,
            node.metrics.val("messages.retained.dropped"))


def _max_payload(pkg):
    node = pkg.node({"retainer": {"max_payload_size": 3}})
    ret = pkg.ret.Retainer(node).load()
    node.broker.publish(retained(pkg, "a", b"xxxx"))
    node.broker.publish(retained(pkg, "b", b"xxx"))
    return ret.retained_count(), \
        node.metrics.val("messages.retained.dropped")


def _expiry(pkg):
    node = pkg.node({"retainer": {"msg_expiry_interval": 50}})
    ret = pkg.ret.Retainer(node).load()
    old = retained(pkg, "a", headers={
        "properties": {"message_expiry_interval": 100}})
    old.ts = pkg.msg.now_ms() - 200_000     # already expired
    ret._insert(old)
    default = retained(pkg, "b")
    default.ts = pkg.msg.now_ms() - 60_000  # past the 50 s default
    ret._insert(default)
    ret._insert(retained(pkg, "c"))         # live
    out = [ret.lookup("a") is None, ret.retained_count()]
    ret.tick()                              # the expiry scan
    out += [ret.retained_count(), [m.topic for m in ret.match("#")]]
    return out


def _clean(pkg):
    node = pkg.node()
    ret = pkg.ret.Retainer(node).load()
    for t in ("a/1", "a/2", "b/1"):
        node.broker.publish(retained(pkg, t))
    return ret.clean("a/#"), ret.retained_count(), ret.clean(), \
        ret.retained_count()


def _stats(pkg):
    node = pkg.node()
    ret = node.register_app(pkg.ret.Retainer(node).load())
    for t in ("s/1", "s/2"):
        node.broker.publish(retained(pkg, t))
    s = node.stats.sample()
    ret.unload()
    node.broker.publish(retained(pkg, "s/3"))
    return s["retained.count"], s["retained.max"], ret.retained_count()


RETAINER_CASES = {f.__name__[1:]: f for f in (
    _store_clear, _non_retained_and_sys, _wildcard, _max_retained,
    _max_payload, _expiry, _clean, _stats)}


@pytest.mark.parametrize("case", sorted(RETAINER_CASES))
def test_retainer_equals_reference(case):
    want, got = both(RETAINER_CASES[case])
    assert got == want


def _wire(m) -> tuple:
    return (m.topic, m.payload, m.qos, m.from_, dict(m.flags),
            dict(m.headers), m.id, m.ts)


def _journal_msgs(pkg) -> list:
    ms = []
    for k, payload in enumerate((b"v1", b"\x00\xffbin", "é".encode(),
                                 b"v4")):
        m = retained(pkg, f"d/{k}", payload, headers={
            "properties": {"message_expiry_interval": 600,
                           "user_property": [["k", "v"]]}})
        m.id = 1000 + k
        m.ts = 1_700_000_000_000 + k
        ms.append(m)
    return ms


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_disc_journal_read_by_the_other_package(tmp_path, writer):
    """A retained journal written by one package's DiscStorage (sets, a
    delete, bytes that are not UTF-8, v5 properties) replays in the
    other's, message for message."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    st = w.ret.DiscStorage(str(tmp_path))
    for m in _journal_msgs(w):
        st.insert(m.topic, m, m.ts + 600_000)
    st.delete("d/1")
    want = sorted((t, _wire(m), e) for t, m, e in st.items())
    st.close()
    st2 = r.ret.DiscStorage(str(tmp_path))
    got = sorted((t, _wire(m), e) for t, m, e in st2.items())
    assert got == want and len(got) == 3
    assert sorted(st2.match_topics("d/+")) == ["d/0", "d/2", "d/3"]
    st2.close()


def test_disc_journal_compaction_and_restart_equal_reference(tmp_path):
    def script(pkg):
        d = str(tmp_path / pkg.name)
        node = pkg.node()
        ret = pkg.ret.Retainer(node, conf={"storage": {"type": "disc",
                                                       "dir": d}})
        ret.on_message_publish(retained(pkg, "d/one", b"v1"))
        ret.on_message_publish(retained(pkg, "d/two", b"v2"))
        ret.delete("d/two")
        ret.storage.close()
        ret2 = pkg.ret.Retainer(node, storage=pkg.ret.DiscStorage(d))
        out = [[(m.topic, m.payload) for m in ret2.match("d/#")]]
        for k in range(300):            # churn far past the live count
            ret2.storage.insert("t/x", retained(pkg, "t/x", b"%d" % k),
                                None)
        out.append(ret2.storage._journal_lines)
        ret2.storage.close()
        st = pkg.ret.DiscStorage(d)
        out.append(st.get("t/x")[0].payload)
        out.append(len(st))
        st.clear()
        out.append(len(pkg.ret.DiscStorage(d)))
        st.close()
        return out
    want, got = both(script)
    assert got == want
    assert got[1] <= 64 + 1


def test_storage_config_equals_reference():
    def script(pkg):
        out = [type(pkg.ret.make_storage(c)).__name__
               for c in (None, "ram", {"type": "ram"})]
        ram = pkg.ret.RamStorage()
        out.append(pkg.ret.make_storage(ram) is ram)
        with pytest.raises(ValueError):
            pkg.ret.make_storage({"type": "martian"})
        return out
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# Retain handling over TCP
# ---------------------------------------------------------------------
async def _rh_script(pkg, rh: int, share: bool) -> list:
    node = pkg.node()
    node.register_app(pkg.ret.Retainer(node).load())
    lst = pkg.Listener(node, bind="127.0.0.1", port=0)
    await lst.start()
    clients = []
    try:
        pub = Client(port=lst.port, clientid="pub")
        await pub.connect()
        clients.append(pub)
        for k in range(3):
            await pub.publish(f"r/{k}", b"v%d" % k, qos=1, retain=True)
        sub = Client(port=lst.port, clientid="sub", proto_ver=C.MQTT_V5)
        await sub.connect()
        clients.append(sub)
        f = "$share/g/r/+" if share else "r/+"
        out = []
        for _round in range(2):         # the second SUBSCRIBE is not new
            await sub.subscribe(f, qos=1, opts={"rh": rh})
            got = []
            while True:
                try:
                    m = await sub.recv(timeout=0.3)
                except asyncio.TimeoutError:
                    break
                got.append((m.topic, m.payload, m.retain))
            out.append(sorted(got))
        return out
    finally:
        for cl in clients:
            await cl.disconnect()
        await lst.stop()


@pytest.mark.parametrize("rh,share", [(0, False), (1, False), (2, False),
                                      (0, True)])
def test_retain_handling_over_tcp_equals_reference(rh, share):
    """Retain Handling 0 replays on every SUBSCRIBE, 1 only on a new one,
    2 never; a shared subscription never; each replay carries the retain
    flag."""
    want, got = (run(_rh_script(pkg, rh, share)) for pkg in PKGS)
    assert got == want
    n = 0 if share or rh == 2 else 3
    assert [len(x) for x in got] == [n, n if rh == 0 else 0]
    assert all(flag for x in got for _t, _p, flag in x)


# ---------------------------------------------------------------------
# Delayed publish
# ---------------------------------------------------------------------
def _delayed_node(pkg, conf=None):
    node = pkg.node(conf)
    d = node.register_app(pkg.delayed.DelayedPublish(node).load())
    sink = Sink()
    node.broker.subscribe(node.broker.register(sink, "s"), "#")
    return node, d, sink


def _intercept_fire(pkg):
    node, d, sink = _delayed_node(pkg)
    msg = pkg.msg.make("p", 1, "$delayed/5/a/b", b"x")
    n = node.broker.publish(msg)
    out = [n, rows(sink), d.count(), d.tick(msg.ts + 4999)]
    out += [d.tick(msg.ts + 5000), rows(sink),
            node.metrics.val("messages.delayed")]
    return out


def _malformed(pkg):
    node, d, sink = _delayed_node(pkg)
    n = [node.broker.publish(pkg.msg.make("p", 0, bad, b"x"))
         for bad in ("$delayed/x/a", "$delayed/5", "$delayed//a",
                     "$delayed/-1/a", "$delayed/99999999999/a")]
    return n, d.count(), node.metrics.val("messages.delayed.dropped"), \
        rows(sink)


def _max_delayed(pkg):
    node, d, _sink = _delayed_node(pkg, {"delayed": {
        "max_delayed_messages": 1}})
    for t in ("a", "b"):
        node.broker.publish(pkg.msg.make("p", 0, f"$delayed/5/{t}", b"x"))
    return d.count(), node.metrics.val("messages.delayed.dropped")


def _list_delete(pkg):
    node, d, sink = _delayed_node(pkg)
    now = pkg.msg.now_ms()
    for secs, t in ((5, "a"), (9, "b"), (7, "c")):
        m = pkg.msg.make("p", 0, f"$delayed/{secs}/{t}", b"x")
        m.ts = now
        node.broker.publish(m)
    items = [(i["topic"], i["publish_at"] - now, i["qos"], i["from"])
             for i in d.list()]
    seqs = [i["seq"] for i in d.list()]
    out = [items, d.delete(seqs[0]), d.delete(seqs[0]), d.delete(10 ** 6),
           d.count(), [(m.topic, fire - now) for fire, _s, m in d.pending()]]
    out += [d.tick(now + 10_000), [t for _f, t, *_ in rows(sink)]]
    return out


def _fire_order(pkg):
    node, d, sink = _delayed_node(pkg)
    now = pkg.msg.now_ms()
    for secs, t in ((9, "late"), (1, "early"), (5, "mid"), (1, "early2")):
        m = pkg.msg.make("p", 0, f"$delayed/{secs}/{t}", t.encode())
        m.ts = now
        node.broker.publish(m)
    fired = [d.tick(now + ms) for ms in (999, 1000, 5000, 9000)]
    return fired, [(t, p) for _f, t, p, _q, _r in rows(sink)]


def _restore(pkg):
    node, d, sink = _delayed_node(pkg)
    now = pkg.msg.now_ms()
    d.restore(pkg.msg.make("p", 0, "back", b"r"), now + 100)
    return d.count(), d.tick(now + 100), rows(sink)


DELAYED_CASES = {f.__name__[1:]: f for f in (
    _intercept_fire, _malformed, _max_delayed, _list_delete, _fire_order,
    _restore)}


@pytest.mark.parametrize("case", sorted(DELAYED_CASES))
def test_delayed_equals_reference(case):
    """``$delayed/<secs>/<topic>`` under a scripted clock (``tick(now)``):
    intercepted at priority 500, fired in time order through the host
    path, malformed wrappers and the cap dropped and counted."""
    want, got = both(DELAYED_CASES[case])
    assert got == want


# ---------------------------------------------------------------------
# Rewrite
# ---------------------------------------------------------------------
RULES = [
    {"action": "publish", "source": "x/#", "re": r"^x/y/(\d+)$",
     "dest": "z/y/$1"},
    {"action": "all", "source": "a", "re": "^a$", "dest": "b"},
    {"action": "all", "source": "b", "re": "^b$", "dest": "c"},
    {"action": "subscribe", "source": "old/#", "re": r"^old/(.+)$",
     "dest": "new/$1"},
    {"action": "publish", "source": "m/+/+", "re": r"^m/(\w+)/(\w+)$",
     "dest": "m2/$2/$1/$3"},
]


def _rewrite_publish(pkg):
    node = pkg.node({"rewrite": RULES})
    pkg.rewrite.TopicRewrite(node).load()
    sink = Sink()
    node.broker.subscribe(node.broker.register(sink, "s"), "#")
    for t in ("x/y/1", "x/y/abc", "a", "m/p/q", "old/t", "$SYS/a"):
        node.broker.publish(pkg.msg.make("p", 0, t, b""))
    return [t for _f, t, *_ in rows(sink)]


def _rewrite_subscribe(pkg):
    node = pkg.node({"rewrite": RULES})
    rw = pkg.rewrite.TopicRewrite(node).load()
    sub = node.hooks.run_fold(
        "client.subscribe", ({}, {}),
        [("$share/g/old/t", {"qos": 1}), ("$queue/old/q", {"qos": 0}),
         ("old/t", {"qos": 0}), ("a", {"qos": 0}), ("x/y/1", {"qos": 0}),
         ("bad/#/x", {"qos": 0})])
    unsub = node.hooks.run_fold("client.unsubscribe", ({}, {}),
                                ["$share/g/old/t", "old/u", "a"])
    return sub, unsub, [rw._rewrite("a", a) for a in ("publish",
                                                      "subscribe")]


def _rewrite_bad_action(pkg):
    with pytest.raises(ValueError):
        pkg.rewrite.RewriteRule("both", "a", "^a$", "b")
    return True


REWRITE_CASES = {f.__name__[1:]: f for f in (
    _rewrite_publish, _rewrite_subscribe, _rewrite_bad_action)}


@pytest.mark.parametrize("case", sorted(REWRITE_CASES))
def test_rewrite_equals_reference(case):
    want, got = both(REWRITE_CASES[case])
    assert got == want


# ---------------------------------------------------------------------
# Topic metrics
# ---------------------------------------------------------------------
def _tm_counts(pkg):
    node = pkg.node()
    tm = pkg.tm.TopicMetrics(node, ["t/#", "t/1"]).load()
    sink = Sink()
    sid = node.broker.register(sink, "s")
    node.broker.subscribe(sid, "t/1")
    for qos, t in ((1, "t/1"), (0, "other"), (2, "t/1"), (0, "t/2")):
        node.broker.publish(pkg.msg.make("p", qos, t, b""))
    return tm.metrics(), tm.metrics("t/1"), tm.topics()


def _tm_registry(pkg):
    node = pkg.node({"topic_metrics": ["c/#"]})
    tm = pkg.tm.TopicMetrics(node).load()
    out = [tm.topics(), tm.register("a"), tm.register("a")]
    node.broker.publish(pkg.msg.make("p", 0, "a", b""))
    tm.tick()
    out += [tm.rate("a", "messages.in") > 0, tm.rate("zz", "messages.in"),
            tm.val("a", "messages.in"), tm.deregister("a"),
            tm.deregister("a")]
    for k in range(pkg.tm.MAX_TOPICS - 1):
        tm.register(f"q/{k}")
    with pytest.raises(ValueError, match="quota_exceeded"):
        tm.register("one/more")
    tm.unload()
    node.broker.publish(pkg.msg.make("p", 0, "c/1", b""))
    return out + [tm.val("c/#", "messages.in")]


TM_CASES = {f.__name__[1:]: f for f in (_tm_counts, _tm_registry)}


@pytest.mark.parametrize("case", sorted(TM_CASES))
def test_topic_metrics_equal_reference(case):
    want, got = both(TM_CASES[case])
    assert got == want


# ---------------------------------------------------------------------
# Event messages
# ---------------------------------------------------------------------
VOLATILE = ("ts", "disconnected_at", "publish_received_at", "id")


def _event_bodies(sink) -> list:
    out = []
    for _f, m in sink.got:
        body = json.loads(m.payload)
        out.append((m.topic, {k: v for k, v in body.items()
                              if k not in VOLATILE}))
    return out


def _fire_events(pkg, node):
    msg = pkg.msg.make("c1", 1, "t/1", b"pl")
    node.hooks.run("client.connected",
                   ({"clientid": "c1", "username": "u", "keepalive": 30,
                     "proto_ver": 5, "clean_start": True,
                     "connected_at": 7}, {}))
    node.hooks.run("client.disconnected", ({"clientid": "c1",
                                            "username": "u"}, "normal"))
    node.hooks.run("session.subscribed",
                   ({"clientid": "c1"}, "t/1", {"qos": 1, "is_new": True}))
    node.hooks.run("session.subscribed",
                   ({"clientid": "c1"}, "$event/x", {"qos": 1}))
    node.hooks.run("session.unsubscribed", ({"clientid": "c1"}, "t/1"))
    node.hooks.run("message.delivered", ("c2", msg))
    node.hooks.run("message.acked", ({"clientid": "c2"}, msg))
    node.hooks.run("message.acked", ("c3", msg))
    node.broker.publish(pkg.msg.make("p", 0, "nobody/home", b""))


@pytest.mark.parametrize("event", list(jevent.EVENTS) + ["none"])
def test_event_message_equals_reference(event):
    """Each event alone (and none: every event off, the default): the
    ``$event/...`` messages and their JSON bodies, clocks aside."""
    def script(pkg):
        conf = {} if event == "none" else {"event_message": {event: True}}
        node = pkg.node(conf)
        pkg.event.EventMessage(node).load()
        sink = Sink()
        node.broker.subscribe(node.broker.register(sink, "w"), "$event/#")
        _fire_events(pkg, node)
        return _event_bodies(sink)
    want, got = both(script)
    assert got == want
    assert bool(got) == (event != "none")


# ---------------------------------------------------------------------
# Flapping detection
# ---------------------------------------------------------------------
def test_flapping_bans_equal_reference(monkeypatch):
    """max_count disconnects inside the window ban the clientid for
    ban_time; disconnects spread past the window do not; tick forgets a
    quiet clientid. The clock is scripted in both packages."""
    clock = {"t": 1000.0}
    for mod in (jbanned, tbanned):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock["t"])

    def script(pkg):
        clock["t"] = 1000.0
        node = pkg.node({"flapping_detect": {
            "enable": True, "max_count": 3, "window_time": 10,
            "ban_time": 5}})
        fd = pkg.banned.FlappingDetect(node).load()
        out = []
        for cid, gaps in (("slow", (6, 6, 6, 6)), ("fast", (1, 1, 1)),
                          ("", (0, 0, 0))):
            for g in gaps:
                clock["t"] += g
                node.hooks.run("client.disconnected",
                               ({"clientid": cid}, "normal"))
        out.append(sorted((b.kind, b.value, b.by, b.reason,
                           round(b.until - b.at, 3))
                          for b in node.banned.all()))
        out.append(sorted(fd._hits))
        clock["t"] += 100
        fd.tick()
        out.append(sorted(fd._hits))
        out.append(node.metrics.val("client.flapping.banned"))
        off = pkg.banned.FlappingDetect(pkg.node()).load()
        out.append(off.node.hooks.lookup("client.disconnected") == [])
        return out
    want, got = both(script)
    assert got == want
    assert [b[1] for b in got[0]] == ["fast"]


# ---------------------------------------------------------------------
# defer_retained: the governor's parking lot
# ---------------------------------------------------------------------
def _force_grade(gov, grade):
    """Walk the governor to `grade` and hold it (tests/test_torch_overload
    .py's helper): a queue-fill reading and one poll per climb."""
    vals = {0: 0.0, 1: 0.55, 2: 0.80, 3: 0.95}
    gov.sample_signals = lambda: {"queue_fill": vals[grade]}
    gov.up_sustain = gov.down_sustain = 1
    for _ in range(4):
        gov.poll()
        if gov.grade == grade:
            break
    assert gov.grade == grade


def test_defer_retained_parks_and_drains_equal_reference():
    """While the governor has defer_retained armed (grade overload), a
    new subscriber's replay is parked and counted, the oldest beyond the
    cap dropped and counted; the first sweep after the readings recover
    replays what is parked, in order."""
    def script(pkg):
        node = pkg.node()
        ret = node.register_app(pkg.ret.Retainer(node).load())
        ret._DEFER_CAP = 2
        for t in ("r/a", "r/b", "q/a"):
            node.broker.publish(retained(pkg, t, t.encode()))
        chans = {}

        class Chan:
            def __init__(self, cid):
                self.cid = cid

            def deliver(self, f, m):
                chans.setdefault(self.cid, []).append(
                    (f, m.topic, m.payload, bool(m.retain),
                     m.headers.get("subopts")))
                return True
        node.cm.lookup_channel = lambda cid: Chan(cid)
        gov = node.overload_governor
        _force_grade(gov, 2)
        out = [gov.retained_deferred]
        for cid, f in (("c1", "r/+"), ("c2", "q/#"), ("c3", "#")):
            node.hooks.run("session.subscribed",
                           ({"clientid": cid}, f, {"qos": 1, "rh": 0}))
        out += [dict(chans), len(ret._deferred),
                node.metrics.val("pipeline.overload.retained_deferred"),
                node.metrics.val("messages.retained.dropped")]
        node.sweep()                      # still overloaded: nothing
        out.append(dict(chans))
        _force_grade(gov, 0)
        gov.poll = lambda *a: None        # the sweep's own poll: no-op
        node.sweep()
        out += [gov.retained_deferred, len(ret._deferred),
                {c: sorted(v) for c, v in chans.items()}]
        return out
    want, got = both(script)
    assert got == want
    assert got[2] == 2 and got[3] == 3 and got[4] == 1
    assert sorted(got[-1]) == ["c2", "c3"]


# ---------------------------------------------------------------------
# start_apps and start_gateways
# ---------------------------------------------------------------------
APP_CONFS = {
    "defaults": {},
    "off": {"retainer": {"enable": False}, "delayed": {"enable": False}},
    "all": {"rewrite": RULES[:1], "topic_metrics": ["t/#"],
            "event_message": {"client_connected": True},
            "flapping_detect": {"enable": True}},
}


@pytest.mark.parametrize("conf", sorted(APP_CONFS))
def test_start_apps_equal_reference(conf):
    """The apps start_apps boots, in order, and the hooks each holds."""
    def script(pkg):
        node = pkg.node(APP_CONFS[conf])
        apps = run(node.start_apps())
        hooks = {h: len(node.hooks.lookup(h)) for h in (
            "message.publish", "session.subscribed", "client.subscribe",
            "message.delivered", "client.connected",
            "client.disconnected")}
        return [type(a).__name__ for a in apps], hooks, \
            [type(a).__name__ for a in node._apps]
    want, got = both(script)
    assert got == want


BOOTS = {
    "rule_engine_rules": {"rule_engine": {"rules": [
        {"id": "r1", "sql": 'SELECT * FROM "t/#"', "actions": []},
        {"id": "r2", "sql": 'SELECT * FROM "$events/client_connected"',
         "actions": [], "enable": False}]}},
    "rule_engine_enable": {"rule_engine": {"enable": True}},
    "authn_enable": {"authn": {"enable": True}},
    "authz_sources": {"authz": {"sources": [{"type": "client_acl"}]}},
    "authz_deny": {"authz": {"no_match": "deny"}},
}


@pytest.mark.parametrize("case", sorted(BOOTS))
def test_start_apps_boots_access_control_and_rules(case):
    """Each block that boots the rule engine, the authn chain or the authz
    chain boots the same apps, in the same order, holding the same hooks,
    in both packages."""
    def script(pkg):
        node = pkg.node(BOOTS[case])
        apps = run(node.start_apps())
        hooks = {h: [cb.tag for cb in node.hooks.lookup(h)] for h in (
            "message.publish", "client.connected", "client.disconnected",
            "client.authenticate", "client.authorize")}
        eng = getattr(node, "rule_engine", None)
        return ([type(a).__name__ for a in apps], hooks,
                [type(a).__name__ for a in node._apps],
                sorted(getattr(node, "enhanced_authn", {})),
                eng and [(r.id, r.enabled) for r in eng.list_rules()])
    want, got = both(script)
    assert got == want


REFUSED = {
    "exhook_servers": {"exhook": {"servers": [
        {"name": "s1", "url": "http://127.0.0.1:{port}",
         "failed_action": "ignore"}]}},
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_start_apps_refuses_what_the_port_lacks(case):
    """The block the port refused before it had exhook (``exhook.servers``)
    now boots alike: against an in-process HookProvider each package
    handshakes before the apps after it, registers the wanted hooks and
    starts the same apps; the provider then sees the same calls."""
    from tests.test_torch_ext import Provider

    def script(pkg):
        prov = Provider([("message.publish", ["b/#"]),
                         ("client.connected", [])])
        server, port = prov.make_server()
        try:
            ex = json.loads(json.dumps(REFUSED[case]).replace(
                "{port}", str(port)))
            conf = dict(ex, rule_engine={"enable": True},
                        retainer={"enable": True})
            node = pkg.node(conf)

            async def go():
                apps = await node.start_apps()
                hooks = {h: [cb.tag for cb in node.hooks.lookup(h)]
                         for h in ("message.publish", "client.connected")}
                await node.broker.publish_async(pkg.msg.make(
                    "p", 0, "b/1", b"x"))
                servers = [dict(x, url=x["url"].replace(str(port), "<p>"))
                           for x in node.exhook.list_servers()]
                await node.exhook.unload()
                return ([type(a).__name__ for a in apps], hooks, servers,
                        node.exhook, prov.names())
            return run(go())
        finally:
            server.stop(grace=0.1)
    want, got = both(script)
    assert got == want
    assert want[0] == ["Retainer", "DelayedPublish", "RuleEngine", "Exhook"]
    assert "exhook:s1" in want[1]["message.publish"]
    assert want[4] == ["loaded", "publish", "unloaded"]


DB_ARMS = {
    **{f"authn_{b}": ("authn", b) for b in (
        "ldap", "mysql", "postgresql", "mongodb", "redis")},
    **{f"authz_{t}": ("authz", t) for t in (
        "mysql", "postgresql", "redis", "mongodb")},
}


def _db_arm_conf(block: str, kind: str, port: int) -> dict:
    arm = {"server": f"127.0.0.1:{port}", "host": "127.0.0.1",
           "port": port, "query": "SELECT 1"}
    if block == "authn":
        return {"authn": {"enable": True, "chain": [
            {"mechanism": "password_based", "backend": "built_in_database"},
            dict(arm, mechanism="password_based", backend=kind)]}}
    return {"authz": {"sources": [{"type": "client_acl"},
                                  dict(arm, type=kind)]}}


@pytest.mark.parametrize("case", sorted(DB_ARMS))
def test_start_apps_boots_the_db_arms_alike(case):
    """Each database arm of authn and authz boots in both packages
    against a fake server of its kind (``tests/test_torch_fake_db.py``;
    none for ``mongodb``): the same apps, the same hooks, the same
    authenticator or source classes and the same resources on
    ``node.resources``, or for ``mongodb`` the same ``ValueError`` after
    the same apps. ``stop_listeners`` removes every resource and the
    server sees every connection closed."""
    from tests import test_torch_fake_db as fakes
    block, kind = DB_ARMS[case]
    make = {"ldap": fakes.FakeLdap, "mysql": fakes.FakeMysql,
            "postgresql": lambda: fakes.FakePgsql(auth="trust"),
            "redis": fakes.FakeRedis, "mongodb": fakes.FakeMongo}[kind]

    async def go(pkg):
        srv = await make().start()
        conf = dict(_db_arm_conf(block, kind, srv.port),
                    rule_engine={"enable": True}, retainer={"enable": True})
        node = pkg.node(conf)
        try:
            apps = await node.start_apps()
            booted = [type(a).__name__ for a in apps]
        except ValueError as e:
            booted = ("ValueError", str(e))
        hooks = {h: [cb.tag for cb in node.hooks.lookup(h)] for h in (
            "message.publish", "client.authenticate", "client.authorize")}
        arms = [[type(x).__name__ for x in
                 getattr(a, "authenticators", getattr(a, "sources", []))]
                for a in node._apps]
        mgr = getattr(node, "resources", None)
        res = mgr and mgr.list()
        await node.stop_listeners()
        left = mgr and dict(mgr.instances)
        await fakes._closed(srv)
        await srv.stop()
        return (booted, [type(a).__name__ for a in node._apps], hooks, arms,
                res, left, srv.opened == srv.closed)
    want, got = both(lambda pkg: run(go(pkg)))
    assert got == want
    if kind == "mongodb":
        assert got[0] == ("ValueError", "unknown resource type mongodb")
    else:
        assert got[0][-1] == ("AuthnChain" if block == "authn" else "Authz")
    assert not got[5] and got[6]


def test_shipped_file_boots_apps_and_no_gateway(tmp_path):
    """etc/emqx.conf (authn off, authz no_match allow) refuses nothing:
    both packages boot the retainer and delayed publish from it, and
    start no gateway; an enabled gateway block boots the same gateway in
    both, a disabled one none, and ``stop_listeners`` stops it."""
    import shutil
    path = tmp_path / "emqx.conf"
    shutil.copy(cs.BOOT_CONF, path)
    (tmp_path / "emqx_override.conf").write_text(
        "broker.device_route = false\nlog.enable = false\n")
    out = []
    for n in (JNode.from_config_file(str(path), name=NAME),
              TNode.from_config_file(str(path), device="cpu", name=NAME)):
        out.append(([type(a).__name__ for a in run(n.start_apps())],
                    run(n.start_gateways())))
    assert out[0] == out[1] == (["Retainer", "DelayedPublish"], [])

    def script(pkg):
        async def go():
            res = []
            for conf in ({"gateway": {"stomp": {"bind": "127.0.0.1",
                                                "port": 0}}},
                         {"gateway": {"stomp": {"enable": False}}}):
                node = pkg.node(conf)
                gws = await node.start_gateways()
                listed = [{k: v for k, v in d.items() if k != "listener"}
                          for d in node.gateway_registry.list()]
                await node.stop_listeners()
                res.append(([type(g).__name__ for g in gws], listed,
                             node.gateway_registry.list()))
            return res
        return run(go())
    want, got = both(script)
    assert got == want
    assert want == [(["StompGateway"], [{"name": "stomp",
                                         "status": "running",
                                         "current_connections": 0}], []),
                    ([], [], [])]


# ---------------------------------------------------------------------
# Columnar bursts: the retainer keeps owned payloads
# ---------------------------------------------------------------------
def test_retained_burst_payloads_survive_later_reads():
    """Retained PUBLISHes that arrive as one columnar burst are stored
    from the burst's rows; more bursts on the same connection reuse its
    read buffer. A late subscriber then gets every retained payload as
    it was sent."""
    async def go(pkg):
        node = pkg.node()
        node.register_app(pkg.ret.Retainer(node).load())
        lst = pkg.Listener(node, bind="127.0.0.1", port=0)
        await lst.start()
        try:
            reader, writer = await cs._connect_raw(lst.port, "burst")
            sent = {}
            for rnd in range(3):
                blob = []
                for k in range(64):
                    t = f"keep/{rnd}/{k}" if k % 4 == 0 else f"flow/{k}"
                    p = b"%d-%d-" % (rnd, k) + bytes([rnd * 64 + k]) * 100
                    if k % 4 == 0:
                        sent[t] = p
                    blob.append(serialize(P.Publish(
                        topic=t, payload=p, retain=k % 4 == 0), 4))
                writer.write(b"".join(blob))
                await writer.drain()
            for _ in range(200):
                if node.stats.sample().get("retained.count") == len(sent):
                    break
                await asyncio.sleep(0.02)
            sub = Client(port=lst.port, clientid="late")
            await sub.connect()
            await sub.subscribe("keep/#", qos=0)
            got = {}
            for _ in range(len(sent)):
                m = await sub.recv(timeout=10)
                got[m.topic] = m.payload
            await sub.disconnect()
            writer.close()
            return got, sent, node.metrics.val("messages.retained")
        finally:
            await lst.stop()
    for pkg in PKGS:
        got, sent, n = run(go(pkg))
        assert got == sent and n == len(sent) == 48, pkg.name


# ---------------------------------------------------------------------
# A flood through booted nodes with the apps on
# ---------------------------------------------------------------------
FLOOD_CONF = """
listeners.tcp_default { type = tcp, bind = "127.0.0.1", port = 0 }
broker { device_route = true, deliver_lanes = %d }
log.enable = false
retainer { enable = true }
delayed { enable = true }
rewrite = [ { action = publish, source = "rw/src/#",
              re = "^rw/src/(.+)$", dest = "rw/dst/$1" } ]
topic_metrics = [ "fl/+/x" ]
"""
FLOOD_PUBS, FLOOD_MSGS = 3, 120


def flood_topic(p: int, k: int) -> str:
    if k % 10 == 9:
        return f"rw/src/{p}/{k % 3}"
    if k % 15 == 14:
        return f"$delayed/1/fl/d/{p}"
    if k % 8 == 0:
        return f"fl/{p}/x"      # retained: one topic per publisher
    return f"fl/{(p + k) % 6}/x"


def real_topic(t: str) -> str:
    """Where a flood topic lands: unwrapped from ``$delayed/1/``, or
    rewritten from ``rw/src/`` to ``rw/dst/``."""
    if t.startswith("$delayed/1/"):
        return t[len("$delayed/1/"):]
    if t.startswith("rw/src/"):
        return "rw/dst/" + t[len("rw/src/"):]
    return t


async def apps_flood(node, hold_device: bool) -> dict:
    """Subscribers (one with retain-as-published) over TCP, then each
    publisher's QoS 0/1 stream with retained, rewritten and delayed
    topics; deliveries per (subscriber, publisher, QoS) in arrival order,
    the
    retainer's count, topic metrics, the delayed fires and a late
    subscriber's retained replay."""
    await node.start_listeners()
    apps = await node.start_apps()
    port = node.listeners[0].port
    clients = []
    try:
        subs = {}
        for cid, f, opts in (("all", "fl/#", {}), ("rap", "fl/#",
                                                   {"rap": 1}),
                             ("rw", "rw/#", {}), ("one", "fl/2/x", {})):
            cl = Client(port=port, clientid=cid, proto_ver=C.MQTT_V5)
            await cl.connect()
            await cl.subscribe(f, qos=1, opts=opts)
            subs[cid] = cl
            clients.append(cl)
        if hold_device:
            # the port's engine built and its class warm before the
            # flood, and the chooser held on it (on the CPU the host
            # path would win); the reference routes as it chooses
            eng = node.device_engine
            eng.rebuild()
            eng._warm_compile((eng._built, eng._tables, eng._cursors))
            node.publish_batcher._device_worth_it = lambda: True
        pubs = []
        for p in range(FLOOD_PUBS):
            cl = Client(port=port, clientid=f"pub{p}")
            await cl.connect()
            pubs.append(cl)
            clients.append(cl)

        async def flood(p, cl):
            acks = []
            for k in range(FLOOD_MSGS):
                fut = cl.publish_start(flood_topic(p, k), b"%d/%d" % (p, k),
                                       qos=1 if k % 4 == 0 else 0,
                                       retain=k % 8 == 0)
                if fut is not None:
                    acks.append(fut)
                if k % 16 == 15:
                    await cl.drain()
                    await asyncio.sleep(0)
            await asyncio.gather(*acks)
        await asyncio.gather(*[flood(p, cl) for p, cl in enumerate(pubs)])
        delayed = next(a for a in apps if type(a).__name__ ==
                       "DelayedPublish")
        pending = delayed.count()
        fired = delayed.tick(_now_ms(node)() + 5000)
        got = {cid: {} for cid in subs}
        for cid, cl in subs.items():
            while True:
                try:
                    m = await cl.recv(timeout=1.0)
                except asyncio.TimeoutError:
                    break
                p, _k = m.payload.split(b"/")
                # publish order holds per publisher and QoS (a QoS 1
                # delivery waiting for the inflight window may let a
                # later QoS 0 one pass); the delayed fires, a timer's,
                # apart from the live stream
                key = (int(p), m.qos, m.topic.startswith("fl/d/"))
                got[cid].setdefault(key, []).append(
                    (m.topic, m.payload, m.qos, bool(m.retain)))
        tm = next(a for a in apps if type(a).__name__ == "TopicMetrics")
        late = Client(port=port, clientid="late", proto_ver=C.MQTT_V5)
        await late.connect()
        clients.append(late)
        await late.subscribe("#", qos=0)
        replay = []
        while True:
            try:
                m = await late.recv(timeout=0.5)
            except asyncio.TimeoutError:
                break
            replay.append((m.topic, m.payload, bool(m.retain)))
        m = node.metrics
        return {"got": got, "pending": pending, "fired": fired,
                "retained": node.stats.sample()["retained.count"],
                "tm": tm.metrics(), "replay": sorted(replay),
                "device_routed": m.val("messages.routed.device"),
                "lane_rows": m.val("pipeline.deliver.rows")}
    finally:
        for cl in clients:
            await cl.disconnect()
        await node.stop_listeners()
        if node.publish_batcher is not None:
            await node.publish_batcher.stop()
            node.publish_batcher.close()


def _now_ms(node):
    return tmessage.now_ms if isinstance(node, TNode) else jmessage.now_ms


@pytest.mark.parametrize("lanes", [2, 0], ids=["lanes", "inline"])
def test_apps_flood_equals_reference(tmp_path, lanes):
    """Both packages boot one file with the retainer, delayed publish, a
    rewrite rule and topic metrics on, device route on (the port's chooser
    held on its engine): the same flood gives equal deliveries per
    subscriber and publisher in order, retain flags only where Retain As
    Published asks, equal retained counts, topic metrics and delayed
    fires, and the same replay to a late subscriber."""
    path = tmp_path / "emqx.conf"
    path.write_text(FLOOD_CONF % lanes)
    ref = JNode.from_config_file(str(path), name=NAME)
    port = TNode.from_config_file(str(path), device="cpu", name=NAME)
    want = run(apps_flood(ref, False))
    got = run(apps_flood(port, True))
    assert got["device_routed"] > 0
    assert (got["lane_rows"] > 0) == bool(lanes)
    for k in ("got", "pending", "fired", "retained", "tm", "replay"):
        assert got[k] == want[k], k
    n_retained = len({real_topic(flood_topic(p, k))
                      for p in range(FLOOD_PUBS)
                      for k in range(0, FLOOD_MSGS, 8)})
    assert got["retained"] == n_retained and got["fired"] == got["pending"]
    flags = {cid: {r for rows_ in g.values() for *_x, r in rows_}
             for cid, g in got["got"].items()}
    assert flags["rap"] == {True, False} and flags["all"] == {False}
    assert all(t.startswith("rw/dst/") for rows_ in got["got"]["rw"].values()
               for t, *_ in rows_)


# ---------------------------------------------------------------------
# $SYS and the tracer
# ---------------------------------------------------------------------
def test_sys_broker_equals_reference():
    """SysBroker: the heartbeat topics, stats/* and metrics/* and one
    pipeline/* payload per section of the telemetry snapshot, alarms to
    $SYS; compared by topic and by payload shape (values are this
    process's)."""
    from emqx_tpu.apps.sys import SysBroker as JSys
    from emqx_tpu_torch.apps.sys import SysBroker as TSys

    def script(pkg):
        node = pkg.node()
        sysb = (JSys if pkg is REF else TSys)(node).load()
        sink = Sink()
        node.broker.subscribe(node.broker.register(sink, "w"), "$SYS/#")
        sysb.publish_heartbeat()
        sysb.publish_stats_metrics()
        node.alarms.activate("a1", {"k": 1}, "m")
        node.alarms.deactivate("a1")
        sysb.tick()                      # both intervals passed: again
        out = {}
        for _f, m in sink.got:
            t = m.topic.split(f"$SYS/brokers/{NAME}/")[-1]
            try:
                body = json.loads(m.payload)
                shape = sorted(body) if isinstance(body, dict) else \
                    type(body).__name__
            except ValueError:
                shape = "text"
            out.setdefault(t, []).append(shape)
        info = sysb.info()
        sysb.unload()
        return out, sorted(info), node.hooks.lookup("alarm.activated")
    want, got = both(script)
    assert got == want
    pipeline = {t for t in got[0] if t.startswith("pipeline/")}
    assert {"pipeline/latency", "pipeline/overload", "pipeline/compiles",
            "pipeline/decisions"} <= pipeline
    assert got[0]["alarms/activate"] and got[0]["alarms/deactivate"]


def test_tracer_equals_reference(tmp_path, caplog):
    """Tracer: clientid, topic and slow_batch traces to file, and the
    WARNING lines of batch.slow, latency.breach, overload.shed and
    pipeline.pin_stale; the SLO_BREACH line carries the flight
    recorder's causal chain of the breaching message's window."""
    import logging

    from emqx_tpu.apps.tracer import Tracer as JTracer
    from emqx_tpu_torch.apps.tracer import Tracer as TTracer

    def script(pkg):
        conf = {"broker": {"device_route": True}}
        node = JNode(conf, name=NAME) if pkg is REF else \
            TNode(conf, device="cpu", name=NAME)
        tr = (JTracer if pkg is REF else TTracer)(node).load()
        d = tmp_path / pkg.name
        d.mkdir()
        out = [tr.start_trace("clientid", "c1", str(d / "c")),
               tr.start_trace("clientid", "c1", str(d / "c")),
               tr.start_trace("topic", "t/#", str(d / "t")),
               tr.start_trace("slow_batch", "", str(d / "s"))]
        with pytest.raises(ValueError):
            tr.start_trace("martian", "x", str(d / "x"))
        rec = node.flight_recorder
        tid = rec.new_trace()
        rec.record(tid, "dispatch", 1.0, 1.002, track="engine")
        rec.record(tid, "materialize", 1.002, 1.005, track="engine")
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            node.hooks.run_fold("message.publish", (),
                                pkg.msg.make("c1", 1, "t/1", b"pl"))
            node.hooks.run("client.connected",
                           ({"clientid": "c1", "username": "u",
                             "peername": "p"}, {}))
            node.hooks.run("session.subscribed",
                           ({"clientid": "c2"}, "t/x", {"qos": 1}))
            node.hooks.run("client.disconnected", ({"clientid": "c1"},
                                                    "normal"))
            node.hooks.run("batch.slow", ({"n": 4, "span_s": 0.5},))
            node.hooks.run("latency.breach", ({"trace_id": tid,
                                               "ms": 9.0},))
            node.hooks.run("overload.shed", ({"action": "shed_qos0",
                                              "armed": True,
                                              "grade": "critical"},))
            node.hooks.run("pipeline.pin_stale", ({"age": 70},))
        # trace ids are per-process counters
        lines = [re.sub(r"trace_id=\d+", "trace_id=<id>", r.getMessage())
                 for r in caplog.records if r.name.endswith(".tracer")]
        out.append(tr.lookup_traces() and
                   sorted((r["type"], r["value"]) for r in
                          tr.lookup_traces()))
        out += [tr.stop_trace("clientid", "c1"),
                tr.stop_trace("clientid", "c1")]
        tr.unload()
        files = {}
        for f in ("c", "t", "s"):
            files[f] = [ln.split(" ", 2)[2] for ln in
                        (d / f).read_text().splitlines()]
        if node.publish_batcher is not None:
            node.publish_batcher.close()
        return out, lines, files
    want, got = both(script)
    assert got == want
    assert any(ln.startswith("SLO_BREACH") and "chain=dispatch:2.0ms,"
               "materialize:3.0ms" in ln for ln in got[1])
    assert [ln.split()[0] for ln in got[1]] == [
        "SLOW_BATCH", "SLO_BREACH", "OVERLOAD_SHED", "STALE_PIN"]


def test_chip_smoke_apps_on_cpu():
    """chip_smoke.py's phase 16 rehearsed on the CPU at a reduced size
    (1,000 filters, 4 subscriber and 4 publisher connections, a
    400-message flood, 2,000 retained messages, the chooser pinned to
    the device engine): the apps boot from the shipped file, the flood
    with retained messages is delivered once and in order, the replay,
    the parked replay's drain and every operator check pass."""
    r = cs.apps_drive(torch.device("cpu"), n_filters=1000, n_sub=4, n_pub=4,
                      total=400, retained=2000, pin_device=True)
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    assert r["apps"] == ["Retainer", "DelayedPublish", "TopicRewrite",
                         "TopicMetrics", "FlappingDetect"]
    assert a["flood"]["delivered"] == 400 and a["flood"]["lane_rows"] > 0
    assert a["retained"] == a["retained_sent"] > 0
    for f in cs.APPS_TM_FILTERS:
        assert a["topic_metrics"][f]["messages.in"] == \
            a["topic_metrics_sent"][f] > 0
    assert b["replayed"] == 2000 and b["one_group"] == 32 and b["rh2"] == 0
    assert b["stored"]["grade_max"] in ("normal", "elevated", "overload",
                                        "critical")
    assert (c["parked"], c["deferred"], c["drained"]) == (0, 1, 32)
    assert set(d["pipeline"].values()) == {200}
    assert d["flapping"][-2:] == [0x8A, 0]


def test_chip_smoke_warm_stress_on_cpu():
    """chip_smoke.py's ``--warm-stress`` rehearsed on the CPU at phase
    16's reduced size: 16b's 2,000 retained PUBLISHes are all stored
    while the engine's class warms loop beside them, and neither a warm
    nor the engine fails."""
    r = cs.apps_drive(torch.device("cpu"), n_filters=1000, n_sub=4, n_pub=4,
                      total=400, retained=2000, pin_device=True,
                      warm_stress=True)
    w = r["warm_stress"]
    assert "b" not in r and "d" not in r
    assert w["warms"] > 0 and w["classes"]
    assert w["stream"]["retained_count"] >= 2000


# ---------------------------------------------------------------------
# The retained sweep: no scan while no entry carries an expiry
# ---------------------------------------------------------------------
def _sweep_script(pkg, monkeypatch, storage, seed):
    """Random retains (no expiry, or 1-5 s), overwrites that give a stored
    topic an expiry or take it away, deletes, and a sweep every 0.7 s of a
    scripted clock: the topics each sweep cleans, in order."""
    clock = [1_000_000]
    monkeypatch.setattr(pkg.ret, "now_ms", lambda: clock[0])
    node = pkg.node()
    ret = pkg.ret.Retainer(node, storage=pkg.ret.make_storage(storage)) \
        .load()
    cleaned: list = []
    delete = ret.delete

    def logged(topic):
        cleaned.append(topic)
        return delete(topic)
    ret.delete = logged
    r = np.random.RandomState(seed)
    ticks = []
    for step in range(40):
        for _ in range(20):
            exp = (None, 1, 2, 5)[r.randint(0, 4)]
            props = {"properties": {"message_expiry_interval": exp}} \
                if exp else {}
            m = retained(pkg, f"s/{r.randint(0, 60)}", b"%d" % step,
                         headers=props)
            m.ts = clock[0]
            ret._insert(m)
        if step % 7 == 3:
            ret.delete(f"s/{r.randint(0, 60)}")
        clock[0] += 700
        n0 = len(cleaned)
        ret.tick()
        ticks.append(cleaned[n0:])
    left = sorted(t for t, _m, _e in ret.storage.items())
    ret.storage.close()
    return ticks, left


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["ram", "disc"])
def test_retained_sweep_cleans_what_the_reference_cleans(
        monkeypatch, tmp_path, kind, seed):
    out = []
    for pkg in PKGS:
        storage = "ram" if kind == "ram" else {
            "type": "disc", "dir": str(tmp_path / pkg.name)}
        out.append(_sweep_script(pkg, monkeypatch, storage, seed))
    assert out[1] == out[0]
    assert any(out[0][0])                 # the script does expire entries
    if kind == "disc":
        # the journals' delete records, in order
        dels = [[json.loads(x)["topic"] for x in
                 (tmp_path / p.name / "retained.jsonl").read_text()
                 .splitlines() if '"op": "del"' in x] for p in PKGS]
        assert dels[1] == dels[0]


def test_retained_sweep_reads_no_entry_that_never_expires():
    """With 100,000 stored messages and no expiry among them, a sweep
    neither walks the store nor allocates per entry."""
    import tracemalloc
    node = PORT.node()
    ret = tretainer.Retainer(node).load()
    msg = retained(PORT, "c5r/0/k0")
    for i in range(100_000):
        ret.storage.insert(f"c5r/{i % 64}/k{i}", msg, None)

    def walked():
        raise AssertionError("the sweep walked every entry")
    ret.storage.items = walked
    tracemalloc.start()
    try:
        ret.tick()
        _cur, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 64 << 10, peak
    assert ret.retained_count() == 100_000
    # one expiring entry: the sweep scans the store, and cleans it when due
    del ret.storage.items
    old = retained(PORT, "c5r/x", headers={
        "properties": {"message_expiry_interval": 1}})
    old.ts = tmessage.now_ms() - 5_000
    ret._insert(old)
    ret.tick()
    assert ret.retained_count() == 100_000
    assert ret.storage.get("c5r/x") is None
