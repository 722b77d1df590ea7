"""Port vs JAX reference: the rule engine.

The same inputs go through the reference's ``emqx_tpu/rules`` and the
port's ``emqx_tpu_torch/rules`` and must give equal outputs: the parsed
AST of every statement of the reference's ``tests/test_rule_engine.py``
(and of the ones that must fail, with the same error), ``apply_sql`` of
each over seeded events, every ``funcs`` builtin on seeded arguments with
``time.time_ns`` patched, the event columns of every hookpoint with the
clock patched, the ``RuleEngine`` on twin CPU nodes (equal rule metrics
and equal republished messages), and a booted node of each package over
live TCP with two rules in force. Rule ids are fixed and clocks patched
where the reference draws from ``uuid`` and ``time``.
"""

import asyncio
import json
import math
import types

import numpy as np
import pytest
import torch

from emqx_tpu.broker import message as jmessage
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.rules import actions as jactions
from emqx_tpu.rules import events as jevents
from emqx_tpu.rules import funcs as jfuncs
from emqx_tpu.rules import maps as jmaps
from emqx_tpu.rules import metrics as jmetrics
from emqx_tpu.rules import registry as jregistry
from emqx_tpu.rules import runtime as jruntime
from emqx_tpu.rules import sqlparser as jsql
from emqx_tpu_torch.broker import message as tmessage
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.rules import actions as tactions
from emqx_tpu_torch.rules import events as tevents
from emqx_tpu_torch.rules import funcs as tfuncs
from emqx_tpu_torch.rules import maps as tmaps
from emqx_tpu_torch.rules import metrics as tmetrics
from emqx_tpu_torch.rules import registry as tregistry
from emqx_tpu_torch.rules import runtime as truntime
from emqx_tpu_torch.rules import sqlparser as tsql

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 60
NOW_NS = 1_700_000_000_123_456_789

REF = types.SimpleNamespace(
    name="ref", sql=jsql, runtime=jruntime, funcs=jfuncs, maps=jmaps,
    events=jevents, metrics=jmetrics, registry=jregistry, actions=jactions,
    msg=jmessage, Listener=JListener,
    node=lambda conf=None: JNode(dict({"broker": {"device_route": False}},
                                      **(conf or {})),
                                 use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", sql=tsql, runtime=truntime, funcs=tfuncs, maps=tmaps,
    events=tevents, metrics=tmetrics, registry=tregistry, actions=tactions,
    msg=tmessage, Listener=TListener,
    node=lambda conf=None: TNode(dict({"broker": {"device_route": False}},
                                      **(conf or {})),
                                 device="cpu", name=NAME))
PKGS = (REF, PORT)


def both(script):
    """The script's result under the reference and under the port."""
    return [script(pkg) for pkg in PKGS]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def outcome(fn, *a):
    """fn's result, or its error as (type name, message)."""
    try:
        return fn(*a)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))


@pytest.fixture()
def clocks(monkeypatch):
    """Every clock the rule engine reads, fixed: time.time_ns (funcs),
    time.time (events, registry), time.monotonic (metrics), uuid (rule
    ids) in both packages."""
    import uuid
    for pkg in PKGS:
        monkeypatch.setattr(pkg.funcs.time, "time_ns", lambda: NOW_NS)
        monkeypatch.setattr(pkg.events.time, "time",
                            lambda: NOW_NS / 1e9)
        monkeypatch.setattr(pkg.registry.time, "time",
                            lambda: NOW_NS / 1e9)
        monkeypatch.setattr(pkg.metrics.time, "monotonic", lambda: 100.0)
        monkeypatch.setattr(pkg.registry.uuid, "uuid4",
                            lambda: uuid.UUID(int=0xabcdef12 << 96))


# ---------------------------------------------------------------------
# SQL: parse and apply
# ---------------------------------------------------------------------
SQLS = [
    'SELECT * FROM "t/#"',
    'SELECT a FROM "t/1", "t/2" WHERE a > 1',
    'FOREACH payload.sensors AS s DO s.id as id INCASE s.ok = true FROM "t"',
    "SELECT CASE WHEN qos = 0 THEN 'low' ELSE 'high' END as level FROM \"t\"",
    'SELECT payload.x as x, payload.y.z[2] as z2 FROM "t/#"',
    'SELECT payload.x as x, x + 10 as y FROM "t/#" WHERE y > 10',
    'SELECT payload.x as x FROM "t/#" WHERE x > 99',
    'SELECT qos as meta.qos FROM "t/#"',
    "SELECT 3 + 4 * 2 as a, 7 div 2 as b, 7 mod 2 as c, -qos as d FROM \"t\"",
    "SELECT 1 as one FROM \"t\" WHERE clientid = 'c1'",
    "SELECT 1 as one FROM \"t\" WHERE topic =~ '^t/'",
    "SELECT 1 as one FROM \"t\" WHERE clientid = 'other'",
    "SELECT 1 as x FROM \"t\" WHERE qos = 1 and "
    "(clientid = 'c1' or clientid = 'c2')",
    "SELECT 1 as x FROM \"t\" WHERE not (qos = 1)",
    'FOREACH payload.sensors FROM "t"',
    'FOREACH payload.sensors AS s DO s.id as id, s.temp as temp '
    'INCASE s.temp > 10 FROM "t"',
    'FOREACH payload.missing FROM "t"',
    'SELECT payload.temp as t, topic FROM "sensors/#" WHERE t > 30',
    'SELECT clientid, username, proto_ver FROM "$events/client_connected"',
    'SELECT reason, topic FROM "$events/message_dropped"',
    'FOREACH payload.readings AS r DO r.v as v INCASE r.v > 0 '
    'FROM "batch/#"',
    'SELECT payload.x as x FROM "t/#" WHERE x = 1',
    'SELECT qos() as q, topic() as t, clientid() as c, username() as u, '
    'clientip() as ip, msgid() as m, flags() as fl, flag("retain") as r, '
    'flag("dup") as d FROM "t/#"',
    'SELECT clientid, topic, qos FROM "device/#" WHERE qos = 1',
    'SELECT clientid FROM "$events/client_connected"',
    "SELECT lower(upper(clientid)) as c, concat(topic, '!') as t, "
    "payload.x * 2.5 as x2, payload.x / 4 as q, payload.x <> 3 as ne, "
    "payload.x != 2 as ne2, payload.x >= 1 as ge, payload.x <= 1 as le, "
    "payload.x < 5 as lt, qos = 1 or qos = 2 as hi FROM \"t/#\"",
    "SELECT nth(2, payload.list) as n, payload.list[1] as first, "
    "json_encode(payload) as j, null as nothing, true as yes, "
    "false as no FROM \"#\"",
    'SELECT * FROM "t/#" WHERE payload.x = 1 and payload.y.z[1] = 10',
    "SELECT CASE WHEN payload.x > 5 THEN 'big' WHEN payload.x > 0 "
    "THEN 'small' END as size FROM \"t/#\"",
    'SELECT "quoted \\" string" as s FROM "t"',
    'SELECT unknown_fn(1) as u FROM "t"',
    'SELECT payload.x + payload.missing as s FROM "t/#"',
    # errors
    'SELECT FROM "t"', "UPDATE x", "SELECT a FROM t", "SELECT a FROM",
    'SELECT a FROM "t" WHERE', "SELECT a,, b FROM \"t\"",
    'SELECT a FROM "t" trailing', "SELECT ` FROM \"t\"",
    'FOREACH FROM "t"', "SELECT CASE WHEN 1 THEN 2 FROM \"t\"", ""]


@pytest.mark.parametrize("i", range(len(SQLS)))
def test_parse_sql_equal_reference(i):
    """The AST (or the SqlError) of each statement is equal in both."""
    want, got = both(lambda pkg: outcome(pkg.sql.parse_sql, SQLS[i]))
    assert got == want


def seeded_events(seed: int, n: int = 8) -> list:
    """Message-shaped event maps drawn from a seed: topic, qos, clientid,
    username, flags and a JSON payload with numbers, nested maps, arrays
    of sensor readings and strings."""
    r = np.random.RandomState(seed)
    out = []
    for k in range(n):
        payload = {
            "x": int(r.randint(-3, 10)), "temp": float(r.randint(0, 50)),
            "y": {"z": [int(v) for v in r.randint(0, 30, 3)]},
            "list": [int(v) for v in r.randint(0, 9, int(r.randint(0, 4)))],
            "sensors": [{"id": j, "temp": int(r.randint(0, 40)),
                         "ok": bool(r.randint(0, 2))}
                        for j in range(int(r.randint(0, 4)))],
            "readings": [{"v": int(r.randint(-2, 3))} for _ in range(3)]}
        ev = {"topic": ["t/1", "t/2", "sensors/a", "device/d1/x/n2/t",
                        "batch/1", "other"][int(r.randint(0, 6))],
              "qos": int(r.randint(0, 3)),
              "clientid": ["c1", "c2", "cid9"][int(r.randint(0, 3))],
              "username": ["u1", None][int(r.randint(0, 2))],
              "peerhost": "10.0.0.7", "id": f"MSG{k}",
              "flags": {"retain": bool(r.randint(0, 2)), "dup": False},
              "proto_ver": 5, "reason": "no_subscribers",
              "timestamp": 1_700_000_000_000 + k,
              "payload": json.dumps(payload) if k % 5 else
              "not json {"}
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_sql_equal_reference(seed):
    """apply_sql of every statement that parses, over seeded events: equal
    outputs (or the same error) in both."""
    events = seeded_events(seed)

    def script(pkg):
        out = []
        for sql in SQLS:
            ast = outcome(pkg.sql.parse_sql, sql)
            if isinstance(ast, tuple) and ast[0] == "error":
                continue
            for ev in events:
                out.append(outcome(pkg.runtime.apply_sql, ast, dict(ev)))
        return out
    want, got = both(script)
    assert got == want


def test_apply_rule_and_maps_equal_reference():
    """apply_rule (the package's entry point) and the maps helpers."""
    ev = seeded_events(9, 1)[0]

    def script(pkg):
        from importlib import import_module
        rules = import_module(pkg.sql.__name__.rsplit(".", 1)[0])
        out = [outcome(rules.apply_rule, 'SELECT payload.x as x FROM "t/#"',
                       dict(ev)) if hasattr(rules, "apply_rule") else None]
        for path in ("a.b", "a[1].c", "payload.y.z[2]", "x.y[0]", ""):
            p = outcome(pkg.maps.parse_path, path)
            out.append(p)
            if not (isinstance(p, tuple) and p[0] == "error"):
                out.append(outcome(pkg.maps.nested_get,
                                   {"a": {"b": 1}, "payload": ev["payload"]},
                                   p))
                out.append(outcome(pkg.maps.nested_put, {}, p, 5))
        return out
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# funcs
# ---------------------------------------------------------------------
def arg_pool(seed: int) -> list:
    """Argument values of every kind the SQL produces, drawn from a seed."""
    r = np.random.RandomState(seed)
    ints = [int(v) for v in r.randint(-5, 40, 4)]
    return ints + [0, 1, 2, 2.5, -0.75, float(r.rand()) + 0.1, True,
                   False, None, "", "abc", "Hello World", "a/b/c", "/",
                   "  pad ", "42", "3.5", "true", "dead", "second",
                   "millisecond", "leading", "trailing", "+08:00", "Z",
                   "2023-11-14T22:13:20+00:00", '{"a": {"b": 7}}',
                   "~s-~s", r"\d+", "a.b", b"\xde\xad", b"xy", b"\xff\xff",
                   [1, 2, 3], [], ["a/b", {"topic": "c/+", "qos": 1}],
                   {"a": {"b": 7}}, {"k": [1, 2]}]


def _calls(pool, r):
    """A seeded sample of argument lists: every arity from 0 to 4, several
    draws each."""
    out = []
    for arity in range(5):
        for _ in range(6):
            out.append([pool[int(i)] for i in r.randint(0, len(pool),
                                                         arity)])
    return out


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def test_funcs_tables_equal_reference():
    """The same builtin names and column accessors in both."""
    assert sorted(tfuncs.FUNCS) == sorted(jfuncs.FUNCS)
    assert tfuncs.COLUMN_FUNCS == jfuncs.COLUMN_FUNCS


@pytest.mark.parametrize("name", sorted(jfuncs.FUNCS))
def test_funcs_builtin_equal_reference(name, clocks):
    """Each builtin on seeded arguments of every arity: the same result or
    the same error in both, with time.time_ns patched (the kv table
    starts empty and sees the same calls)."""
    seed = sum(map(ord, name))
    for pkg in PKGS:
        pkg.funcs._KV.clear()

    def script(pkg):
        r = np.random.RandomState(seed)
        pool = arg_pool(seed)
        out = []
        for args in _calls(pool, r):
            out.append(_norm(outcome(pkg.funcs.call, name, list(args))))
        out.append(dict(pkg.funcs._KV))
        return out
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# event columns
# ---------------------------------------------------------------------
def _msg(pkg, k: int = 0):
    m = pkg.msg.Message(topic=f"t/{k}", payload=b'{"x": 1}' if k % 2
                        else b"\xff\xfe", qos=k % 3, from_=f"c{k}",
                        flags={"retain": bool(k % 2)},
                        headers={"username": "u1", "peerhost": "10.0.0.7",
                                 "properties": {"user_property": [("a",
                                                                   "b")]}},
                        id=(1 << 100) + k, ts=1_700_000_000_000 + k)
    return m


EVENT_CASES = {
    "publish": lambda pkg: pkg.events.columns_publish(_msg(pkg, 1)),
    "publish_binary": lambda pkg: pkg.events.columns_publish(_msg(pkg, 2)),
    "connected": lambda pkg: pkg.events.columns_connected(
        {"clientid": "c1", "username": "u1", "mountpoint": None,
         "peername": ("10.0.0.1", 5555)},
        {"sockname": ("127.0.0.1", 1883), "proto_ver": 5, "keepalive": 60,
         "clean_start": False, "receive_maximum": 32,
         "expiry_interval": 7, "conn_props": {"a": 1},
         "connected_at": 123}),
    "connected_bare": lambda pkg: pkg.events.columns_connected({}, {}),
    "disconnected": lambda pkg: pkg.events.columns_disconnected(
        {"clientid": "c1", "username": "u1", "peername": "10.0.0.1:5",
         "sockname": None}, "normal"),
    "subscribed": lambda pkg: pkg.events.columns_sub_unsub(
        "session.subscribed", {"clientid": "c1", "peerhost": "h"}, "a/#",
        {"qos": 1}),
    "unsubscribed": lambda pkg: pkg.events.columns_sub_unsub(
        "session.unsubscribed", {"clientid": "c1"}, "a/#"),
    "delivered_str": lambda pkg: pkg.events.columns_delivered(
        "c9", _msg(pkg, 3)),
    "delivered_map": lambda pkg: pkg.events.columns_delivered(
        {"clientid": "c9"}, _msg(pkg, 3)),
    "acked": lambda pkg: pkg.events.columns_acked({"clientid": "c9"},
                                                  _msg(pkg, 4)),
    "dropped": lambda pkg: pkg.events.columns_dropped(_msg(pkg, 5),
                                                      "no_subscribers"),
    "event_names": lambda pkg: [pkg.events.event_name(t) for t in (
        "$events/client_connected", "$events/message_acked", "a/b",
        "$events/unknown", "$events/session_subscribed/x")],
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_event_columns_equal_reference(case, clocks):
    """Each hookpoint's column map, with the clock patched, is equal in
    both (the same keys, values and event name)."""
    want, got = both(EVENT_CASES[case])
    assert got == want


def test_rule_metrics_equal_reference(monkeypatch):
    """Counters and the speed gauge under one scripted clock."""
    clock = [0.0]
    for pkg in PKGS:
        monkeypatch.setattr(pkg.metrics.time, "monotonic", lambda: clock[0])

    def script(pkg):
        m = pkg.metrics.RuleMetrics()
        out = []
        for t, n in ((0.5, 3), (1.0, 0), (2.5, 10), (2.5, 1), (4.0, 7)):
            clock[0] = t
            m.inc("sql.matched", n)
            m.inc("actions.success")
            m.tick()
            out.append(m.to_map())
        return out, m.val("sql.passed"), m.speed_last5m
    clock[0] = 0.0
    want = script(REF)
    clock[0] = 0.0
    got = script(PORT)
    assert got == want


# ---------------------------------------------------------------------
# RuleEngine on twin CPU nodes
# ---------------------------------------------------------------------
class Cap:
    def __init__(self):
        self.msgs = []

    def deliver(self, f, m):
        self.msgs.append(m)
        return True


def _wire(msgs) -> list:
    return [(m.topic, m.payload, m.qos, m.from_,
             m.get_header("republish_by"),
             bool(m.get_header("__republished"))) for m in msgs]


def _engine(pkg):
    node = pkg.node()
    eng = pkg.registry.RuleEngine(node).load()
    cap = Cap()
    node.broker.subscribe(node.broker.register(cap, "cap"), "#")
    return node, eng, cap


def _republish(pkg):
    node, eng, cap = _engine(pkg)
    eng.create_rule(
        'SELECT payload.temp as t, topic FROM "sensors/#" WHERE t > 30',
        [{"name": "republish",
          "params": {"target_topic": "alerts/${topic}",
                     "payload_tmpl": '{"hot":${t}}', "target_qos": 1}}],
        rule_id="r1")
    for temp in (35, 5, 31, 99):
        node.broker.publish(pkg.msg.make(
            "c1", 0, "sensors/a", json.dumps({"temp": temp}).encode()))
    return node, eng, cap


def _loop(pkg):
    node, eng, cap = _engine(pkg)
    eng.create_rule('SELECT * FROM "loop/#"', [
        {"name": "republish", "params": {"target_topic": "loop/again",
                                         "target_qos": -1}}],
        rule_id="r-loop")
    node.broker.publish(pkg.msg.make("c1", 1, "loop/start", b"x"))
    return node, eng, cap


def _gate(pkg):
    node, eng, cap = _engine(pkg)
    eng.create_rule('SELECT * FROM "only/+/this"',
                    [{"name": "do_nothing", "params": {}}], rule_id="g")
    for t in ("other/topic", "only/x/this", "only/x/that", "$SYS/x"):
        node.broker.publish(pkg.msg.make("c", 0, t, b""))
    return node, eng, cap


def _events(pkg):
    node, eng, cap = _engine(pkg)
    for k, ev in enumerate(("client_connected", "client_disconnected",
                            "session_subscribed", "session_unsubscribed",
                            "message_delivered", "message_acked",
                            "message_dropped")):
        eng.create_rule(f'SELECT * FROM "$events/{ev}"', [
            {"name": "republish",
             "params": {"target_topic": f"ev/{ev}/${{clientid}}",
                        "payload_tmpl": "${event}|${topic}|${reason}"}}],
            rule_id=f"e{k}")
    h = node.hooks
    h.run("client.connected", ({"clientid": "dev9", "username": "u"},
                               {"proto_ver": 5, "keepalive": 60}))
    h.run("client.disconnected", ({"clientid": "dev9"}, "normal"))
    h.run("session.subscribed", ({"clientid": "dev9"}, "a/#", {"qos": 1}))
    h.run("session.unsubscribed", ({"clientid": "dev9"}, "a/#"))
    m = pkg.msg.make("c", 1, "a/b", b"p")
    h.run("message.delivered", ("dev9", m))
    h.run("message.acked", ({"clientid": "dev9"}, m))
    node.broker.publish(pkg.msg.make("c", 0, "no/subs/here", b""))
    return node, eng, cap


def _disable_delete(pkg):
    node, eng, cap = _engine(pkg)
    r = eng.create_rule('SELECT * FROM "d/#"',
                        [{"name": "do_nothing", "params": {}}],
                        rule_id="dd")
    eng.enable_rule(r.id, False)
    node.broker.publish(pkg.msg.make("c", 0, "d/x", b""))
    eng.enable_rule(r.id, True)
    node.broker.publish(pkg.msg.make("c", 0, "d/x", b""))
    eng.delete_rule(r.id)
    node.broker.publish(pkg.msg.make("c", 0, "d/x", b""))
    return node, eng, cap, r


def _foreach(pkg):
    node, eng, cap = _engine(pkg)
    eng.create_rule(
        'FOREACH payload.readings AS r DO r.v as v INCASE r.v > 0 '
        'FROM "batch/#"',
        [{"name": "republish", "params": {"target_topic": "out/${v}",
                                          "payload_tmpl": "${v}"}},
         {"name": "inspect", "params": {}}], rule_id="fe")
    node.broker.publish(pkg.msg.make("c", 0, "batch/1", json.dumps(
        {"readings": [{"v": 1}, {"v": -2}, {"v": 3}]}).encode()))
    return node, eng, cap


def _errors(pkg):
    node, eng, cap = _engine(pkg)
    eng.create_rule('SELECT unknown_fn(1) as u FROM "e/#"',
                    [{"name": "do_nothing"}], rule_id="bad-sql")
    eng.create_rule('SELECT * FROM "e/#"',
                    [{"name": "data_to_kafka", "params": {}},
                     {"name": "do_nothing"}], rule_id="bad-action")
    eng.create_rule('SELECT * FROM "e/#"', [], rule_id="no-action")
    out = [outcome(eng.create_rule, 'SELECT * FROM "e/#"', [],
                   "bad-action"),
           outcome(eng.create_rule, "SELECT FROM", [], "x")]
    node.broker.publish(pkg.msg.make("c", 0, "e/1", b"{}"))
    eng._errors = out
    return node, eng, cap


def _sql_test(pkg):
    node, eng, cap = _engine(pkg)
    eng._errors = [
        outcome(eng.test_sql, 'SELECT payload.x as x FROM "t/#" WHERE x = 1',
                {"topic": "t/1", "payload": '{"x": 1}'}),
        outcome(eng.test_sql, "SELECT event FROM \"t\"", {}),
        outcome(eng.test_sql, "SELECT", {})]
    return node, eng, cap


def _default_id(pkg):
    node, eng, cap = _engine(pkg)
    r = eng.create_rule('SELECT * FROM "i/#"', [])
    eng._errors = [r.id]
    return node, eng, cap


ENGINE_CASES = {f.__name__[1:]: f for f in (
    _republish, _loop, _gate, _events, _disable_delete, _foreach, _errors,
    _sql_test, _default_id)}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_rule_engine_equal_reference(case, clocks):
    """Each scripted drive of the RuleEngine on a CPU node: equal rules
    (their maps, metrics included), equal republished messages (topic,
    payload, QoS, sender, republish_by), equal hooks held."""
    def script(pkg):
        node, eng, cap, *extra = ENGINE_CASES[case](pkg)
        rules = [r.to_map() for r in eng.list_rules()]
        rules += [r.to_map() for r in extra]
        hooks = {h: [cb.tag for cb in node.hooks.lookup(h)]
                 for h in sorted(eng._hooked)}
        out = (rules, _wire(cap.msgs), hooks, getattr(eng, "_errors", None),
               node.rule_engine is eng)
        eng.unload()
        return out + (getattr(node, "rule_engine", None),
                      sorted(eng._hooked))
    want, got = both(script)
    assert got == want


# ---------------------------------------------------------------------
# Booted nodes over live TCP
# ---------------------------------------------------------------------
RULES_CONF = {
    "broker": {"device_route": True},
    "rule_engine": {"rules": [
        {"id": "r_q1",
         "sql": 'SELECT clientid, topic, qos FROM "device/#" WHERE qos = 1',
         "actions": [{"name": "republish", "params": {
             "target_topic": "rules/q1/${clientid}", "target_qos": 1}}]},
        {"id": "r_conn", "sql": 'SELECT clientid FROM '
                                '"$events/client_connected"',
         "actions": [{"name": "republish", "params": {
             "target_topic": "rules/conn/${clientid}"}}]},
        {"id": "r_off", "enable": False, "description": "off",
         "sql": 'SELECT * FROM "#"', "actions": []}]},
}
PUBS, MSGS = 3, 40


async def _rules_over_tcp(pkg):
    node = pkg.node(RULES_CONF) if pkg is PORT else JNode(
        RULES_CONF, use_device=True, name=NAME)
    apps = await node.start_apps()
    lst = pkg.Listener(node, bind="127.0.0.1", port=0)
    await lst.start()
    clients = []
    try:
        sub = Client(port=lst.port, clientid="rsub", proto_ver=C.MQTT_V5)
        await sub.connect()
        await sub.subscribe("rules/#", qos=1)
        dev = Client(port=lst.port, clientid="dsub", proto_ver=C.MQTT_V5)
        await dev.connect()
        await dev.subscribe("device/#", qos=1)
        clients += [sub, dev]
        pubs = []
        for p in range(PUBS):
            cl = Client(port=lst.port, clientid=f"rp{p}",
                        proto_ver=C.MQTT_V5)
            await cl.connect()
            pubs.append(cl)
            clients.append(cl)

        async def flood(p, cl):
            acks = []
            for k in range(MSGS):
                fut = cl.publish_start(f"device/d{p}/n{k % 5}", b"%d" % k,
                                       qos=1 if k % 4 == 0 else 0)
                if fut is not None:
                    acks.append(fut)
                if k % 8 == 7:
                    await cl.drain()
            await asyncio.gather(*acks)
        await asyncio.gather(*[flood(p, cl) for p, cl in enumerate(pubs)])
        want_rules = PUBS * len(range(0, MSGS, 4)) + 1 + PUBS
        got = []
        for _ in range(want_rules):
            m = await sub.recv(timeout=10)
            got.append((m.topic, m.payload, m.qos))
        dev_n = 0
        while True:
            try:
                await dev.recv(timeout=0.5)
                dev_n += 1
            except asyncio.TimeoutError:
                break
        eng = node.rule_engine
        return {"apps": [type(a).__name__ for a in apps],
                "rules": {r.id: (r.enabled, r.metrics.counters)
                          for r in eng.list_rules()},
                "republished": sorted(got), "device": dev_n,
                "late": sub.messages.qsize()}
    finally:
        for cl in clients:
            await cl.disconnect()
        await lst.stop()
        if node.publish_batcher is not None:
            await node.publish_batcher.stop()
            node.publish_batcher.close()


def test_rules_over_tcp_equal_reference():
    """Booted nodes (the batcher's message.publish fold runs r_q1) with the
    rules from the config: equal rule metrics, equal republished messages
    (every QoS 1 message once under rules/q1/<clientid>, one
    rules/conn/<clientid> for each CONNECT after the subscriber's own) and
    equal deliveries."""
    want = run(_rules_over_tcp(REF))
    got = run(_rules_over_tcp(PORT))
    assert got == want
    q1 = PUBS * len(range(0, MSGS, 4))
    assert want["rules"]["r_q1"][1] == {"sql.matched": PUBS * MSGS,
                                        "sql.passed": q1,
                                        "sql.failed": PUBS * MSGS - q1,
                                        "sql.failed.no_result":
                                            PUBS * MSGS - q1,
                                        "actions.success": q1}
    assert want["device"] == PUBS * MSGS and want["late"] == 0
