"""Port vs JAX reference: the management API, the CLI and the dashboard.

Both packages' ``make_api`` serve over HTTP on port 0 beside a live
listener, and the same requests (the inputs of the reference's
``tests/test_mgmt.py`` and the dashboard cases of
``tests/test_persistence_apps.py``) must get equal status codes and
bodies, per-process values aside (uptime, datetime, load, tokens, ports,
connection clocks). The ``/rules`` endpoints and the CLI's ``rules``
command answer alike without a rule engine and with one loaded. The five ``/pipeline`` endpoints, ``start_dashboard`` from
a config file and the CLI (``trace device`` on the port's CPU engine
among its commands) are covered too.
"""

import asyncio
import base64
import json
import re

import pytest
import torch

from emqx_tpu.apps.dashboard import DashboardAdmin as JAdmin
from emqx_tpu.apps.dashboard import register_api as jregister
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.cluster import ClusterNode as JClusterNode
from emqx_tpu.mgmt import Cli as JCli
from emqx_tpu.mgmt import make_api as jmake_api
from emqx_tpu.mgmt.apps import AppAuth as JAppAuth
from emqx_tpu.mgmt.httpd import HttpServer as JHttpServer
from emqx_tpu.rules import registry as jregistry
from emqx_tpu_torch.apps.dashboard import DashboardAdmin as TAdmin
from emqx_tpu_torch.apps.dashboard import register_api as tregister
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.cluster import ClusterNode as TClusterNode
from emqx_tpu_torch.mgmt import Cli as TCli
from emqx_tpu_torch.mgmt import make_api as tmake_api
from emqx_tpu_torch.mgmt import cli as tcli
from emqx_tpu_torch.mgmt.apps import AppAuth as TAppAuth
from emqx_tpu_torch.mgmt.httpd import HttpServer as THttpServer
from emqx_tpu_torch.rules import registry as tregistry

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 60
# values that differ per process or per run: clocks, load, credentials,
# ephemeral ports
VOLATILE = {"uptime", "datetime", "load1", "load5", "load15", "token",
            "secret", "created_at", "connected_at", "peername",
            "sockname", "at", "until", "activate_at", "deactivate_at",
            "timestamp", "ts"}


def norm(x):
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    return x


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


async def http(port, method, path, body=None, auth=None, bearer=None,
               raw=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    hdrs = [f"{method} {path} HTTP/1.1", "host: x",
            f"content-length: {len(data)}", "connection: close"]
    if auth:
        tok = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode()
        hdrs.append(f"authorization: Basic {tok}")
    if bearer:
        hdrs.append(f"authorization: Bearer {bearer}")
    writer.write(raw if raw is not None
                 else ("\r\n".join(hdrs) + "\r\n\r\n").encode() + data)
    await writer.drain()
    out = await reader.read(-1)
    writer.close()
    head, _, payload = out.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if b"application/json" not in head:
        return status, payload
    return status, json.loads(payload) if payload else None


REF = dict(name="ref", Listener=JListener, make_api=jmake_api, Cli=JCli,
           AppAuth=JAppAuth, Admin=JAdmin, register=jregister,
           HttpServer=JHttpServer, rules=jregistry,
           node=lambda: JNode(use_device=False, name=NAME))
PORT = dict(name="port", Listener=TListener, make_api=tmake_api, Cli=TCli,
            AppAuth=TAppAuth, Admin=TAdmin, register=tregister,
            HttpServer=THttpServer, rules=tregistry,
            node=lambda: TNode({"broker": {"device_route": False}},
                               device="cpu", name=NAME))
PKGS = (REF, PORT)


async def _stack(pkg, script):
    """A live host node with its listener, the REST API and the CLI."""
    node = pkg["node"]()
    lst = pkg["Listener"](node, bind="127.0.0.1", port=0)
    node.listeners.append(lst)
    api = pkg["make_api"](node, port=0)
    await lst.start()
    await api.start()
    try:
        return await script(node, lst, api, pkg["Cli"](node))
    finally:
        await api.stop()
        await lst.stop()


def both(script):
    """The script's normalized result on the reference's stack and on the
    port's."""
    return [norm(run(_stack(pkg, script))) for pkg in PKGS]


# ---------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------
async def _status_nodes_brokers(node, lst, api, cli):
    out = []
    for path in ("/status", "/api/v5/status", "/api/v5/nodes",
                 f"/api/v5/nodes/{NAME}", "/api/v5/nodes/nope",
                 "/api/v5/brokers", "/api/v5/cluster", "/api/v5/nothing"):
        out.append(await http(api.port, "GET", path))
    return out


async def _clients_lifecycle(node, lst, api, cli):
    c = Client(port=lst.port, clientid="api-c1", username="u1")
    await c.connect()
    await c.subscribe("t/1", qos=1)
    out = [await http(api.port, "GET", "/api/v5/clients"),
           await http(api.port, "GET", "/api/v5/clients?username=u1"),
           await http(api.port, "GET", "/api/v5/clients?username=zz"),
           await http(api.port, "GET", "/api/v5/clients/api-c1"),
           await http(api.port, "GET",
                      "/api/v5/clients/api-c1/subscriptions"),
           await http(api.port, "DELETE", "/api/v5/clients/api-c1")]
    await asyncio.sleep(0.1)
    out += [await http(api.port, "GET", "/api/v5/clients/api-c1"),
            await http(api.port, "DELETE", "/api/v5/clients/api-c1")]
    return out


async def _subscriptions_routes(node, lst, api, cli):
    c = Client(port=lst.port, clientid="api-c2")
    await c.connect()
    await c.subscribe("r/+/x", qos=2)
    await c.subscribe("$share/g/s/#", qos=1)
    out = [await http(api.port, "GET", "/api/v5/subscriptions"),
           await http(api.port, "GET",
                      "/api/v5/subscriptions?clientid=api-c2"),
           await http(api.port, "GET", "/api/v5/routes"),
           await http(api.port, "GET", "/api/v5/topics"),
           await http(api.port, "GET", "/api/v5/routes/r%2F%2B%2Fx"),
           await http(api.port, "GET", "/api/v5/topics/nope")]
    await c.disconnect()
    return out


async def _publish_api(node, lst, api, cli):
    c = Client(port=lst.port, clientid="api-c3")
    await c.connect()
    await c.subscribe("api/pub", qos=1)
    out = [await http(api.port, "POST", "/api/v5/mqtt/publish",
                      {"topic": "api/pub", "payload": "hi", "qos": 1}),
           await http(api.port, "POST", "/api/v5/publish", {
               "topic": "api/pub", "encoding": "base64",
               "payload": base64.b64encode(b"\x00\x01").decode()}),
           await http(api.port, "POST", "/api/v5/mqtt/publish_batch", [
               {"topic": "api/pub", "payload": "b1"},
               {"topic": "api/none", "payload": "b2", "retain": True}])]
    got = []
    for _ in range(3):
        m = await c.recv(timeout=5)
        got.append((m.topic, m.payload, m.qos))
    await c.disconnect()
    return out, got


async def _mqtt_subscribe_api(node, lst, api, cli):
    c = Client(port=lst.port, clientid="api-c4")
    await c.connect()
    out = [await http(api.port, "POST", "/api/v5/mqtt/subscribe",
                      {"clientid": "api-c4", "topic": "mgmt/sub",
                       "qos": 1}),
           await http(api.port, "POST", "/api/v5/mqtt/publish",
                      {"topic": "mgmt/sub", "payload": "x"})]
    m = await c.recv(timeout=5)
    out += [m.topic,
            await http(api.port, "POST", "/api/v5/mqtt/unsubscribe",
                       {"clientid": "api-c4", "topic": "mgmt/sub"}),
            await http(api.port, "POST", "/api/v5/mqtt/unsubscribe",
                       {"clientid": "ghost", "topic": "mgmt/sub"}),
            await http(api.port, "POST", "/api/v5/mqtt/subscribe",
                       {"clientid": "api-c4", "topic": "a/#/b"}),
            await http(api.port, "POST", "/api/v5/mqtt/subscribe",
                       {"clientid": "ghost", "topic": "ok/t"})]
    await c.disconnect()
    return out


async def _banned_api(node, lst, api, cli):
    return [await http(api.port, "POST", "/api/v5/banned",
                       {"as": "clientid", "who": "evil", "seconds": 60}),
            await http(api.port, "GET", "/api/v5/banned"),
            await http(api.port, "DELETE", "/api/v5/banned/clientid/evil"),
            await http(api.port, "DELETE", "/api/v5/banned/clientid/evil"),
            await http(api.port, "POST", "/api/v5/banned",
                       {"as": "nonsense", "who": "x"}),
            await http(api.port, "POST", "/api/v5/banned",
                       {"as": "clientid"})]


async def _rules_without_engine(node, lst, api, cli):
    rule = {"id": "r1", "sql": 'SELECT * FROM "t/#"',
            "actions": [{"name": "do_nothing", "params": {}}]}
    return [await http(api.port, "GET", "/api/v5/rules"),
            await http(api.port, "POST", "/api/v5/rules", rule),
            await http(api.port, "GET", "/api/v5/rules/r1"),
            await http(api.port, "PUT", "/api/v5/rules/r1",
                       {"enabled": False}),
            await http(api.port, "DELETE", "/api/v5/rules/r1"),
            await http(api.port, "POST", "/api/v5/rule_test",
                       {"sql": "SELECT 1", "context": {}})]


async def _metrics_stats_listeners_alarms(node, lst, api, cli):
    node.alarms.activate("test_alarm", {"k": 1}, "a test alarm")
    node.alarms.activate("gone_alarm", {}, "cleared")
    node.alarms.deactivate("gone_alarm")
    out = []
    for path in ("/api/v5/metrics?aggregate=true", "/api/v5/metrics",
                 "/api/v5/stats", "/api/v5/stats?aggregate=true",
                 "/api/v5/listeners", "/api/v5/alarms",
                 "/api/v5/alarms?activated=true",
                 "/api/v5/alarms?activated=false"):
        st, body = await http(api.port, "GET", path)
        if path == "/api/v5/listeners":
            body = [{k: v for k, v in x.items() if k != "bind"}
                    for x in body]
        out.append((st, body))
    out.append(await http(api.port, "DELETE", "/api/v5/alarms/deactivated"))
    return out


async def _pagination(node, lst, api, cli):
    for i in range(5):
        node.broker.subscribe(node.broker.register(object(), f"pg{i}"),
                              f"pg/{i}")
    return [await http(api.port, "GET", f"/api/v5/routes?{q}")
            for q in ("_page=2&_limit=2", "_page=3&_limit=2", "_limit=0",
                      "_page=x")]


async def _hardening(node, lst, api, cli):
    out = [await http(api.port, "POST", "/api/v5/mqtt/publish",
                      {"payload": "x"}),
           await http(api.port, "POST", "/api/v5/mqtt/publish",
                      {"topic": "bad/+", "payload": "x"}),
           await http(api.port, "POST", "/api/v5/banned", None,
                      raw=b"POST /api/v5/banned HTTP/1.1\r\nhost: x\r\n"
                          b"content-length: 5\r\nconnection: close\r\n\r\n"
                          b"{nope")]
    st, _ = await http(api.port, "GET", "/status",
                       raw=b"GET /status HTTP/1.1\r\nhost: x\r\n"
                           b"content-length: abc\r\n\r\n")
    return out + [st]


REST_CASES = {f.__name__[1:]: f for f in (
    _status_nodes_brokers, _clients_lifecycle, _subscriptions_routes,
    _publish_api, _mqtt_subscribe_api, _banned_api, _rules_without_engine,
    _metrics_stats_listeners_alarms, _pagination, _hardening)}


@pytest.mark.parametrize("case", sorted(REST_CASES))
def test_rest_api_equals_reference(case):
    want, got = both(REST_CASES[case])
    assert got == want


def test_rules_answer_without_an_engine():
    """The port's rule endpoints: 404 "rule engine not loaded", the two
    that read their body first a 400, as the reference's without an
    engine."""
    got = norm(run(_stack(PORT, _rules_without_engine)))
    assert [st for st, _b in got] == [404, 400, 404, 404, 404, 400]
    assert all(b["message"] == "rule engine not loaded" for _st, b in got)


async def _rules_with_engine(node, lst, api, cli):
    """The rule endpoints and the CLI with an engine loaded: create (with
    and without an id, a duplicate, bad SQL), list, get, update (validated
    before the rule is replaced), rule_test, a rule firing on a PUBLISH
    over TCP, delete."""
    port = api.port
    rule = {"id": "r1", "sql": 'SELECT clientid, topic FROM "t/#" '
                               'WHERE topic = \'t/1\'',
            "actions": [{"name": "republish", "params": {
                "target_topic": "re/${clientid}"}}], "description": "d"}
    out = [await http(port, "GET", "/api/v5/rules"),
           await http(port, "POST", "/api/v5/rules", rule),
           await http(port, "POST", "/api/v5/rules", rule),
           await http(port, "POST", "/api/v5/rules",
                      {"sql": 'SELECT * FROM "n/#"', "actions": []}),
           await http(port, "POST", "/api/v5/rules", {"sql": "SELECT"}),
           await http(port, "POST", "/api/v5/rules", {"actions": []}),
           await http(port, "GET", "/api/v5/rules"),
           await http(port, "GET", "/api/v5/rules/r1"),
           await http(port, "GET", "/api/v5/rules/nope"),
           await http(port, "PUT", "/api/v5/rules/r1", {"sql": "SELECT x"}),
           await http(port, "PUT", "/api/v5/rules/r1",
                      {"actions": [{"params": {}}]}),
           await http(port, "PUT", "/api/v5/rules/r1", {"actions": "x"}),
           await http(port, "GET", "/api/v5/rules/r1"),
           await http(port, "PUT", "/api/v5/rules/nope", {"enabled": True}),
           await http(port, "POST", "/api/v5/rule_test",
                      {"sql": 'SELECT payload.x as x FROM "t/#"',
                       "context": {"payload": '{"x": 3}'}}),
           await http(port, "POST", "/api/v5/rule_test", {"sql": "nope"})]
    sub = Client(port=lst.port, clientid="re-sub")
    await sub.connect()
    await sub.subscribe("re/#", qos=0)
    pub = Client(port=lst.port, clientid="re-pub")
    await pub.connect()
    for t in ("t/1", "t/2", "t/1"):
        await pub.publish(t, b"x", qos=1)
    got = [(await sub.recv(timeout=5)).topic for _ in range(2)]
    out.append(got)
    out.append(await http(port, "GET", "/api/v5/rules/r1"))
    out.append(await http(port, "PUT", "/api/v5/rules/r1",
                          {"sql": 'SELECT clientid FROM "t/#"',
                           "description": "all", "enabled": False}))
    await pub.publish("t/3", b"x", qos=1)
    out.append(await http(port, "GET", "/api/v5/rules/r1"))
    out.append(await http(port, "PUT", "/api/v5/rules/r1", {"enabled": True}))
    await pub.publish("t/4", b"x", qos=1)
    out.append((await sub.recv(timeout=5)).topic)
    for args in (["rules", "list"], ["rules", "show", "r1"],
                 ["rules", "show", "nope"], ["rules", "delete", "nope"],
                 ["rules", "bogus"]):
        out.append(await cli.run(args))
    out += [await http(port, "DELETE", "/api/v5/rules/r1"),
            await http(port, "DELETE", "/api/v5/rules/r1"),
            await cli.run(["rules", "delete", "rule:abcdef12"]),
            await http(port, "GET", "/api/v5/rules")]
    await sub.disconnect()
    await pub.disconnect()
    return out


def test_rules_answer_with_an_engine_equal_reference(monkeypatch):
    """With a RuleEngine loaded on each stack (the rule id uuid and the
    clocks fixed), every rule endpoint and CLI command answers alike,
    and a rule made over the API fires on the next PUBLISH."""
    import uuid
    for pkg in PKGS:
        monkeypatch.setattr(pkg["rules"].uuid, "uuid4",
                            lambda: uuid.UUID(int=0xabcdef12 << 96))
        monkeypatch.setattr(pkg["rules"].time, "time", lambda: 1.7e9)

    def engine_stack(pkg):
        async def script(node, lst, api, cli):
            pkg["rules"].RuleEngine(node).load()
            return await _rules_with_engine(node, lst, api, cli)
        return norm(run(_stack(pkg, script)))
    want, got = [engine_stack(pkg) for pkg in PKGS]
    assert got == want
    assert want[1][0] == 201 and want[-1] == (200, [])
    assert want[16] == ["re/re-pub", "re/re-pub"]


def test_basic_auth_and_app_crud_equal_reference():
    """API credentials (AppAuth): basic auth on every route but the
    status, and the /apps CRUD over HTTP."""
    async def go(pkg):
        node = pkg["node"]()
        auth = pkg["AppAuth"]()
        secret = auth.add_app("app1", "test app", secret="s3cret")
        api = pkg["make_api"](node, app_auth=auth, port=0)
        await api.start()
        try:
            out = [await http(api.port, "GET", "/api/v5/nodes"),
                   await http(api.port, "GET", "/api/v5/nodes",
                              auth=("app1", "wrong")),
                   await http(api.port, "GET", "/api/v5/nodes",
                              auth=("app1", secret)),
                   await http(api.port, "GET", "/api/v5/nodes",
                              bearer="nope"),
                   await http(api.port, "GET", "/status")]
            a = ("app1", secret)
            out += [await http(api.port, "POST", "/api/v5/apps",
                               {"app_id": "app2", "secret": "s2"}, auth=a),
                    await http(api.port, "POST", "/api/v5/apps",
                               {"app_id": "app2"}, auth=a),
                    await http(api.port, "GET", "/api/v5/apps", auth=a),
                    await http(api.port, "GET", "/api/v5/nodes",
                               auth=("app2", "s2")),
                    await http(api.port, "DELETE", "/api/v5/apps/app2",
                               auth=a),
                    await http(api.port, "DELETE", "/api/v5/apps/app2",
                               auth=a)]
            return out
        finally:
            await api.stop()
    want, got = (norm(run(go(pkg))) for pkg in PKGS)
    assert got == want
    assert [st for st, _b in got[:5]] == [401, 401, 200, 401, 200]


def test_app_auth_equals_reference():
    def script(pkg):
        auth = pkg["AppAuth"]()
        s = auth.add_app("a", "A", desc="d")
        out = [auth.is_authorized("a", s), auth.is_authorized("a", "nope"),
               auth.update_app("a", False), auth.is_authorized("a", s),
               norm(auth.lookup_app("a")), auth.update_app("zz", True),
               norm(auth.list_apps())]
        with pytest.raises(ValueError):
            auth.add_app("a", "again")
        auth.add_app("x", "X", secret="k", expired=1)
        out += [auth.is_authorized("x", "k"), auth.del_app("a"),
                auth.del_app("a"), auth.lookup_app("a")]
        return out
    want, got = (script(pkg) for pkg in PKGS)
    assert got == want


# ---------------------------------------------------------------------
# The pipeline endpoints
# ---------------------------------------------------------------------
PIPELINE = ("stats", "trace", "memory", "latency", "overload")


@pytest.fixture(scope="module")
def device_stacks():
    """A reference device node and a port cpu node, a few windows routed
    through each engine, both APIs serving; the endpoints' answers."""
    async def go(node):
        from emqx_tpu.broker.message import make as jmake
        from emqx_tpu_torch.broker.message import make as tmake
        make = tmake if isinstance(node, TNode) else jmake
        api = (tmake_api if isinstance(node, TNode) else jmake_api)(
            node, port=0)
        await api.start()
        try:
            sid = node.broker.register(type("S", (), {
                "deliver": lambda self, f, m: True})(), "c0")
            node.broker.subscribe(sid, "p/+", {"qos": 0})
            eng = node.device_engine
            if isinstance(node, TNode):
                # the class warm and the chooser held on the engine (on
                # the CPU the host path would win)
                eng.rebuild()
                eng._warm_compile((eng._built, eng._tables, eng._cursors))
                node.publish_batcher._device_worth_it = lambda: True
            for k in range(4):
                await asyncio.gather(*[node.publish_async(
                    make("p", 0, f"p/{j}", b"")) for j in range(16)])
            out = {}
            for name in PIPELINE:
                out[name] = await http(api.port, "GET",
                                       f"/api/v5/pipeline/{name}")
            out["perfetto"] = await http(
                api.port, "GET", "/api/v5/pipeline/trace?format=perfetto")
            return out
        finally:
            await api.stop()
            if node.publish_batcher is not None:
                node.publish_batcher.close()
    return (run(go(JNode(name=NAME))),
            run(go(TNode(device="cpu", name=NAME))))


@pytest.mark.parametrize("name", PIPELINE + ("perfetto",))
def test_pipeline_endpoint_equals_reference(device_stacks, name):
    """Each /api/v5/pipeline endpoint answers 200 on both device nodes
    with the same top-level sections (the port's snapshot holds no
    program-cost section: the card's programs are CUDA graphs, not
    compiled XLA programs; the allocator cross-check is the card's)."""
    (jst, jbody), (tst, tbody) = (s[name] for s in device_stacks)
    assert tst == jst == 200
    want = set(jbody) - {"device", "accounted_fraction"}
    if name == "stats":
        # sections that appear with their layer's traffic: the port's
        # windows ran on its engine (readback), the reference's chooser
        # may have kept them on the host
        want -= {"program_costs"}
        assert want <= set(tbody) <= want | {"readback"}
    else:
        assert set(tbody) == want, name
    if name == "memory":
        # the allocator cross-check is the card's (no CPU reading)
        assert tbody.get("accounted_fraction") is None
    if name == "trace":
        assert tbody["ring"]["windows"] > 0
    if name == "perfetto":
        assert tbody["traceEvents"]


def test_pipeline_endpoints_404_with_the_layers_off():
    """With the recorder, the ledger, the observatory and the governor
    off, their endpoints answer 404 on both packages."""
    conf = {"broker": {"trace": False, "hbm_ledger": False,
                       "latency_observatory": False, "overload": False}}

    async def go(node, make_api):
        api = make_api(node, port=0)
        await api.start()
        try:
            return [(await http(api.port, "GET",
                                f"/api/v5/pipeline/{n}"))[0]
                    for n in PIPELINE]
        finally:
            await api.stop()
            if node.publish_batcher is not None:
                node.publish_batcher.close()
    want = run(go(JNode(conf, name=NAME), jmake_api))
    got = run(go(TNode(conf, device="cpu", name=NAME), tmake_api))
    assert got == want == [200, 404, 404, 404, 404]


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------
async def _cli_status_broker(node, lst, api, cli):
    out = [await cli.run(["status"]), await cli.run([]),
           await cli.run(["help"])]
    for args in (["broker"], ["broker", "stats"], ["broker", "metrics"]):
        text = await cli.run(args)
        out.append(sorted(line.split(":")[0].strip()
                          for line in text.splitlines()))
    return out


async def _cli_clients_routes_subs(node, lst, api, cli):
    c = Client(port=lst.port, clientid="cli-c1")
    await c.connect()
    await c.subscribe("cli/t", qos=0)
    out = []
    for args in (["clients", "list"], ["clients", "show", "nope"],
                 ["subscriptions", "show", "cli-c1"], ["routes", "list"],
                 ["routes", "show", "cli/t"], ["topics", "show", "x"],
                 ["subscriptions", "add", "cli-c1", "cli/added", "1"],
                 ["subscriptions", "add", "ghost", "cli/added", "1"],
                 ["subscriptions", "list"],
                 ["subscriptions", "del", "cli-c1", "cli/added"],
                 ["listeners"], ["clients", "kick", "cli-c1"],
                 ["clients", "kick", "cli-c1"]):
        text = await cli.run(args)
        if args == ["listeners"]:
            text = text.split(" on ")[0]
        out.append(text)
    return out


async def _cli_banned_rules_usage(node, lst, api, cli):
    out = []
    for args in (["banned", "add", "clientid", "bad", "60"],
                 ["banned", "del", "clientid", "nope"],
                 ["rules", "list"], ["nonsense"], ["clients", "bogus-sub"],
                 ["subscriptions", "add", "c", "t", "abc"],
                 ["banned", "add", "clientid", "x", "zz"],
                 ["cluster", "status"], ["cluster"], ["plugins", "list"],
                 ["mgmt", "list"]):
        out.append(await cli.run(args))
    text = await cli.run(["banned", "list"])
    out.append(text.split(" until ")[0])
    return out


async def _cli_trace(node, lst, api, cli):
    import tempfile
    path = tempfile.mktemp(suffix=".log")
    out = [await cli.run(["trace", "start", "client", "tr-c1", path]),
           await cli.run(["trace", "start", "client", "tr-c1", path]),
           (await cli.run(["trace", "list"])).replace(path, "<path>"),
           await cli.run(["trace", "start", "topic", "tr/#", path + "2"])]
    c = Client(port=lst.port, clientid="tr-c1")
    await c.connect()
    await c.publish("tr/t", b"x", qos=0)
    await c.disconnect()
    await asyncio.sleep(0.1)
    out += [await cli.run(["trace", "stop", "client", "tr-c1"]),
            await cli.run(["trace", "stop", "client", "tr-c1"]),
            await cli.run(["trace", "stop", "topic", "tr/#"]),
            await cli.run(["trace", "bogus"]),
            await cli.run(["trace", "device", "start", "/tmp/x"])]
    lines = []
    for p in (path, path + "2"):
        with open(p) as f:
            lines.append([line.split(" ", 2)[2].split(" payload=")[0]
                          .split(" peer=")[0]
                          for line in f.read().splitlines()])
    return out, lines


async def _cli_plugins(node, lst, api, cli):
    """``plugins list`` before a ``Plugins`` app, with a loaded plugin and
    a disabled one, and after the loaded one's unload (which runs its
    ``unload``)."""
    import importlib
    import sys
    import types
    pkg = type(node).__module__.split(".")[0]
    plugins_mod = importlib.import_module(f"{pkg}.apps.plugins")
    calls = []
    mod = types.ModuleType("cli_fake_plugin")

    def load(_node, conf):
        calls.append(("load", conf))
        return types.SimpleNamespace(
            unload=lambda: calls.append(("unload",)))
    mod.load = load
    sys.modules["cli_fake_plugin"] = mod
    try:
        out = [await cli.run(["plugins", "list"])]
        plugins = plugins_mod.Plugins(node, {"load": [
            {"name": "p1", "module": "cli_fake_plugin", "config": {"a": 1}},
            {"name": "p2", "module": "cli_fake_plugin", "enabled": False}]})
        out += [plugins.load_all(), await cli.run(["plugins", "list"]),
                plugins.unload("p1"), await cli.run(["plugins", "list"]),
                calls]
    finally:
        del sys.modules["cli_fake_plugin"]
    return out


CLI_CASES = {f.__name__[1:]: f for f in (
    _cli_status_broker, _cli_clients_routes_subs, _cli_banned_rules_usage,
    _cli_trace, _cli_plugins)}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_reference(case):
    want, got = both(CLI_CASES[case])
    assert got == want
    if case == "cli_plugins":
        assert want == ["(none)", 1, "Plugin(p1, enabled=True)\n"
                        "Plugin(p2, enabled=False)", True,
                        "Plugin(p1, enabled=False)\n"
                        "Plugin(p2, enabled=False)",
                        [("load", {"a": 1}), ("unload",)]]


def test_cli_device_trace_on_the_ports_engine(tmp_path):
    """``trace device start|stop`` drives the port engine's
    torch.profiler capture (here on a CPU engine; on the card the same
    calls trace the card): the Chrome trace lands in the directory."""
    node = TNode(device="cpu", name=NAME)
    cli = TCli(node)

    async def go():
        out = [await cli.run(["trace", "device", "start", str(tmp_path)]),
               await cli.run(["trace", "device", "start", str(tmp_path)])]
        from emqx_tpu_torch.broker.message import make
        sid = node.broker.register(type("S", (), {
            "deliver": lambda self, f, m: True})(), "c0")
        node.broker.subscribe(sid, "d/+", {"qos": 0})
        node.device_engine.route_batch([make("p", 0, "d/1", b"")])
        out.append(await cli.run(["trace", "device", "stop"]))
        return out
    out = run(go())
    node.publish_batcher.close()
    assert out == ["device trace started",
                   "a device trace is already running",
                   "device trace stopped"]
    assert (tmp_path / "route_steps.json").exists()


def test_cli_main_builds_a_host_only_node(capsys):
    out = run(tcli.main(["status"], device="cpu"))
    assert out.startswith(f"Node emqx_tpu_torch@127.0.0.1 is started")
    assert "is running" in capsys.readouterr().out


# ---------------------------------------------------------------------
# Dashboard
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def admins():
    """One DashboardAdmin per package (pbkdf2, 10,000 rounds a user)."""
    return {pkg["name"]: pkg["Admin"](pkg["node"]()) for pkg in PKGS}


def test_dashboard_admin_equals_reference(admins):
    def script(pkg):
        admin = admins[pkg["name"]]
        out = [admin.check("admin", "public"), admin.check("admin", "x"),
               admin.check("nobody", "x")]
        admin.add_user("ops", "secret1", "ops user")
        out.append(admin.check("ops", "secret1"))
        with pytest.raises(ValueError):
            admin.add_user("ops", "x")
        out += [admin.change_password("ops", "bad", "secret2"),
                admin.change_password("ops", "secret1", "secret2"),
                admin.check("ops", "secret2"), admin.users(),
                admin.remove_user("ops")]
        with pytest.raises(ValueError):
            admin.remove_user("admin")     # the last admin is kept
        tok = admin.sign_token("admin", "public")
        out += [admin.sign_token("admin", "bad"), admin.verify_token(tok),
                admin.auth_check("__bearer__", tok),
                admin.auth_check("admin", "public"),
                admin.destroy_token(tok), admin.destroy_token(tok),
                admin.verify_token(tok)]
        return out
    want, got = (script(pkg) for pkg in PKGS)
    assert got == want


def test_dashboard_http_equals_reference(admins):
    """register_api on an HttpServer: the UI page (the same asset, byte
    for byte) and login unauthenticated, the token flow, the users
    endpoints and the overview."""
    async def go(pkg):
        admin = admins[pkg["name"]]
        node = admin.node
        srv = pkg["HttpServer"]("127.0.0.1", 0,
                                auth_check=admin.auth_check,
                                auth_exempt=("/api/v5/login",))
        pkg["register"](srv, node, admin)
        await srv.start()
        try:
            out = [await http(srv.port, "GET", "/"),
                   await http(srv.port, "GET", "/dashboard/"),
                   await http(srv.port, "GET", "/api/v5/overview"),
                   await http(srv.port, "POST", "/api/v5/login",
                              {"username": "admin", "password": "no"})]
            st, body = await http(srv.port, "POST", "/api/v5/login",
                                  {"username": "admin",
                                   "password": "public"})
            tok = body["token"]
            out.append((st, body))
            st, ov = await http(srv.port, "GET", "/api/v5/overview",
                                bearer=tok)
            out.append((st, sorted(ov), ov["node"], ov["retained"]))
            out += [await http(srv.port, "GET", "/api/v5/users",
                               bearer=tok),
                    await http(srv.port, "POST", "/api/v5/users",
                               {"username": "u2", "password": "p2"},
                               bearer=tok),
                    await http(srv.port, "POST", "/api/v5/users",
                               {"username": "u2", "password": "p2"},
                               bearer=tok),
                    await http(srv.port, "PUT",
                               "/api/v5/users/u2/change_pwd",
                               {"old_pwd": "bad", "new_pwd": "x"},
                               bearer=tok),
                    await http(srv.port, "DELETE", "/api/v5/users/u2",
                               bearer=tok),
                    await http(srv.port, "DELETE", "/api/v5/users/u2",
                               bearer=tok),
                    await http(srv.port, "POST", "/api/v5/logout",
                               bearer=tok),
                    await http(srv.port, "GET", "/api/v5/overview",
                               bearer=tok)]
            return out
        finally:
            await srv.stop()
    want, got = (norm(run(go(pkg))) for pkg in PKGS)
    assert got == want
    assert got[0][0] == 200 and b"emqx-tpu dashboard" in got[0][1]


def test_start_dashboard_from_config_equals_reference(tmp_path):
    """Node.start_dashboard boots the dashboard listener from the file:
    the web UI, the token login and the /api/v5 surface behind the
    admin's auth; stop_listeners stops it too."""
    conf = tmp_path / "emqx.conf"
    conf.write_text("""
    listeners { t { type = tcp, bind = "127.0.0.1", port = 0 } }
    broker.device_route = false
    dashboard { listeners { http { bind = "127.0.0.1", port = 0 } } }
    """)
    off = tmp_path / "off.conf"
    off.write_text("dashboard.enable = false\nbroker.device_route = false\n")

    async def go(node):
        await node.start_listeners()
        srv = await node.start_dashboard()
        try:
            st, body = await http(srv.port, "POST", "/api/v5/login",
                                  {"username": "admin",
                                   "password": "public"})
            out = [(await http(srv.port, "GET", "/"))[0],
                   (await http(srv.port, "GET", "/api/v5/overview"))[0],
                   st]
            for path in ("/api/v5/overview", "/api/v5/clients?_limit=5",
                         "/api/v5/subscriptions?_limit=5",
                         "/api/v5/stats", "/api/v5/pipeline/stats",
                         "/api/v5/pipeline/overload"):
                out.append((await http(srv.port, "GET", path,
                                       bearer=body["token"]))[0])
            out.append((await http(srv.port, "GET", "/api/v5/nodes",
                                   auth=("admin", "public")))[0])
            return out
        finally:
            await node.stop_listeners()
            out_srv = node.dashboard_server
            assert out_srv is None
    want = run(go(JNode.from_config_file(str(conf), name=NAME)))
    got = run(go(TNode.from_config_file(str(conf), device="cpu",
                                        name=NAME)))
    assert got == want == [200, 401, 200] + [200] * 7
    for node in (JNode.from_config_file(str(off), name=NAME),
                 TNode.from_config_file(str(off), device="cpu",
                                        name=NAME)):
        assert run(node.start_dashboard()) is None


# ---------------------------------------------------------------------
# A cluster: the fan-out, /cluster and the CLI's cluster commands
# ---------------------------------------------------------------------
CLUSTER_PATHS = ("/api/v5/cluster", "/api/v5/nodes", "/api/v5/brokers",
                 "/api/v5/clients", "/api/v5/subscriptions",
                 "/api/v5/routes", "/api/v5/metrics",
                 "/api/v5/metrics?aggregate=true", "/api/v5/stats",
                 "/api/v5/nodes/n1@127.0.0.1",
                 "/api/v5/clients/remote-c")


def _strip_ports(x):
    """Cluster answers without the ephemeral rpc ports."""
    if isinstance(x, dict):
        return {k: _strip_ports(v) for k, v in x.items()
                if k not in ("address", "addr")}
    if isinstance(x, (list, tuple)):
        return [_strip_ports(v) for v in x]
    return x


def _counters(x):
    """Counter maps cut to the keys both packages have: the port's device
    engine adds its pipeline gauges."""
    if isinstance(x, dict):
        return {k: _counters(v) for k, v in x.items()
                if not k.startswith("pipeline.")}
    if isinstance(x, (list, tuple)):
        return [_counters(v) for v in x]
    return x


async def _cluster_stack(Node, Cluster, make_api, Cli, conf):
    nodes, clusters = [], []
    for i in range(2):
        node = Node(f"n{i}@127.0.0.1")
        cn = Cluster(node, port=0, heartbeat_s=0.05)
        await cn.start()
        nodes.append(node)
        clusters.append(cn)
    await clusters[1].join(*clusters[0].address)
    api = make_api(nodes[0], cluster=clusters[0], port=0)
    from_api1 = make_api(nodes[1], cluster=clusters[1], port=0)
    await api.start()
    await from_api1.start()
    try:
        nodes[1].cm.register_channel("remote-c", object(),
                                     {"username": "ru"})
        b1 = nodes[1].broker
        b1.subscribe(b1.register(type("S", (), {
            "deliver": lambda self, f, m: True})(), "remote-c"),
            "fan/+", {"qos": 1})
        for cn in clusters:
            await cn.flush()
        await asyncio.sleep(0.15)
        out = [_counters(_strip_ports(await http(api.port, "GET", p)))
               for p in CLUSTER_PATHS]
        cli = Cli(nodes[0], cluster=clusters[0])
        out.append(await cli.run(["cluster", "status"]))
        out.append(await cli.run(["cluster"]))
        joined = await cli.run(["cluster", "join",
                                "%s:%d" % clusters[1].address])
        out.append(re.sub(r"\d{4,5}\]", "PORT]", joined))
        out.append(await Cli(nodes[1], cluster=clusters[1]).run(
            ["cluster", "leave"]))
        await asyncio.sleep(0.1)
        out.append(await cli.run(["cluster", "status"]))
        out.append(await cli.run(["cluster", "force-leave", "ghost@x"]))
        out.append(await cli.run(["cluster", "status"]))
        out.append(await Cli(nodes[1]).run(["cluster", "status"]))
        return out
    finally:
        await api.stop()
        await from_api1.stop()
        for cn in clusters:
            await cn.stop()


def test_cluster_fanout_and_cli_equal_reference():
    """Two clustered nodes each: the REST fan-out (nodes, brokers,
    clients, subscriptions, counters), /cluster and the routes from the
    replicated table, then the CLI's cluster status, force-leave, join
    and leave, equal on both packages."""
    want = run(_cluster_stack(
        lambda n: JNode(use_device=False, name=n), JClusterNode,
        jmake_api, JCli, None))
    got = run(_cluster_stack(
        lambda n: TNode(device="cpu", name=n), TClusterNode, tmake_api,
        TCli, None))
    assert norm(got) == norm(want)
    assert want[0][1]["routes"] == 1 and want[-1] == \
        "node is not running in cluster mode"
    assert any(c["clientid"] == "remote-c" and c["node"] == "n1@127.0.0.1"
               for c in want[3][1]["data"])


def test_start_dashboard_passes_the_cluster():
    """``Node.start_dashboard`` hands ``broker.cluster`` to the API: its
    /cluster answers the cluster view."""
    async def go():
        node = TNode({"dashboard": {"listeners": {"http": {"port": 0}}}},
                     device="cpu", name=NAME)
        cn = TClusterNode(node, port=0, heartbeat_s=0.05)
        await cn.start()
        srv = await node.start_dashboard()
        try:
            st, tok = await http(srv.port, "POST", "/api/v5/login",
                                 {"username": "admin",
                                  "password": "public"})
            return await http(srv.port, "GET", "/api/v5/cluster",
                              bearer=tok["token"])
        finally:
            await node.stop_listeners()
            await cn.stop()
    st, body = run(go())
    assert st == 200 and body["node"] == NAME
    assert body["members"][NAME]["status"] == "running"
