"""Port vs JAX reference: exhook, the exporters, telemetry, plugins, PSK
and the wire codec.

The same inputs go through the reference's ``emqx_tpu/apps/exhook.py``,
``apps/prometheus.py``, ``apps/statsd.py``, ``apps/telemetry.py``,
``apps/plugins.py``, ``utils/psk.py`` and ``utils/wirecodec.py`` and
through the port's copies, and what reaches the wire must be equal: the
gRPC requests an in-process HookProvider decodes (timestamps, uptime and
time-based message ids aside), the hook chain's answers, the Prometheus
text (the two ``emqx_vm_*`` lines, read from the process's own rusage,
by name and type only), the StatsD datagrams, the telemetry report, the
plugin calls and listings, the PSK store. Inputs follow the reference's
``tests/test_exhook.py``, ``TestPrometheus`` and ``TestStatsd`` of
``tests/test_ws_exporters.py``, the exporter tests of
``tests/test_observability.py``, ``TestPlugins`` and ``TestTelemetry`` of
``tests/test_persistence_apps.py`` and ``TestPsk`` of ``tests/test_tls.py``.
"""

import asyncio
import json
import re
import socket
import sys
import types
import uuid
from concurrent import futures

import grpc
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from emqx_tpu.apps import exhook as jexhook
from emqx_tpu.apps import plugins as jplugins
from emqx_tpu.apps import prometheus as jprom
from emqx_tpu.apps import statsd as jstatsd
from emqx_tpu.apps import telemetry as jtele
from emqx_tpu.broker import message as jmessage
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.mgmt import httpd as jhttpd
from emqx_tpu.rules import RuleEngine as JRuleEngine
from emqx_tpu.utils import psk as jpsk
from emqx_tpu.utils import tls as jtls
from emqx_tpu.utils import wirecodec as jwire
from emqx_tpu_torch.apps import exhook as texhook
from emqx_tpu_torch.apps import plugins as tplugins
from emqx_tpu_torch.apps import prometheus as tprom
from emqx_tpu_torch.apps import statsd as tstatsd
from emqx_tpu_torch.apps import telemetry as ttele
from emqx_tpu_torch.apps.protos import exhook_pb2 as pb
from emqx_tpu_torch.broker import message as tmessage
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.mgmt import httpd as thttpd
from emqx_tpu_torch.rules import RuleEngine as TRuleEngine
from emqx_tpu_torch.utils import psk as tpsk
from emqx_tpu_torch.utils import tls as ttls
from emqx_tpu_torch.utils import wirecodec as twire
from tests.test_observability import _parse_exposition

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 30

REF = types.SimpleNamespace(
    name="ref", exhook=jexhook, plugins=jplugins, prom=jprom,
    statsd=jstatsd, tele=jtele, make=jmessage.make, psk=jpsk, tls=jtls,
    wire=jwire, HttpServer=jhttpd.HttpServer, RuleEngine=JRuleEngine,
    node=lambda conf=None: JNode(conf or {}, use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", exhook=texhook, plugins=tplugins, prom=tprom,
    statsd=tstatsd, tele=ttele, make=tmessage.make, psk=tpsk, tls=ttls,
    wire=twire, HttpServer=thttpd.HttpServer, RuleEngine=TRuleEngine,
    # the host-only node: its counters, gauges and histograms are the
    # reference's use_device=False node's, name for name
    node=lambda conf=None: TNode(
        dict(conf or {}, broker={"device_route": False}), device="cpu",
        name=NAME))
PKGS = (REF, PORT)


def both(script):
    """The script's result under the reference and under the port."""
    return [script(pkg) for pkg in PKGS]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


class SeqUuid:
    """Stands in for a module's ``uuid``: ``uuid4()`` counts up from 1, so
    both packages draw the same ids."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)


# ---------------------------------------------------------------------
# exhook: one in-process gRPC HookProvider per package run
# ---------------------------------------------------------------------
class Provider:
    """External HookProvider: records every call, scripts the valued
    responses (the reference's ``tests/test_exhook.py`` provider)."""

    def __init__(self, hooks):
        self.hooks = hooks                  # [(name, topics)]
        self.calls = []
        self.auth_result = True
        self.authz_result = True
        self.publish_mutate = None          # fn(Message pb) -> Message pb

    def make_server(self):
        def unary(name, req_cls, resp_fn):
            def handler(request, _ctx):
                self.calls.append((name, request))
                return resp_fn(request)
            return grpc.unary_unary_rpc_method_handler(
                handler, request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString())

        def empty(_req):
            return pb.EmptySuccess()

        def loaded(_req):
            return pb.LoadedResponse(hooks=[
                pb.HookSpec(name=n, topics=t) for n, t in self.hooks])

        def valued(attr):
            def answer(_req):
                return pb.ValuedResponse(
                    type=pb.ValuedResponse.STOP_AND_RETURN,
                    bool_result=getattr(self, attr))
            return answer

        def on_publish(req):
            if self.publish_mutate is None:
                return pb.ValuedResponse(type=pb.ValuedResponse.IGNORE)
            return pb.ValuedResponse(
                type=pb.ValuedResponse.CONTINUE,
                message=self.publish_mutate(req.message))

        methods = {
            "OnProviderLoaded": unary("loaded", pb.ProviderLoadedRequest,
                                      loaded),
            "OnProviderUnloaded": unary("unloaded",
                                        pb.ProviderUnloadedRequest, empty),
            "OnClientAuthenticate": unary(
                "authenticate", pb.ClientAuthenticateRequest,
                valued("auth_result")),
            "OnClientAuthorize": unary("authorize",
                                       pb.ClientAuthorizeRequest,
                                       valued("authz_result")),
            "OnMessagePublish": unary("publish", pb.MessagePublishRequest,
                                      on_publish),
            "OnClientConnected": unary("connected",
                                       pb.ClientConnectedRequest, empty),
            "OnClientDisconnected": unary(
                "disconnected", pb.ClientDisconnectedRequest, empty),
            "OnSessionSubscribed": unary(
                "subscribed", pb.SessionSubscribedRequest, empty),
            "OnMessageDropped": unary("dropped", pb.MessageDroppedRequest,
                                      empty),
        }
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "emqx.exhook.v1.HookProvider", methods),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        return server, port

    def names(self):
        return [c[0] for c in list(self.calls)]


# fields that carry a clock: the broker's uptime and datetime, a
# message's timestamp
PB_VOLATILE = {"uptime", "datetime", "timestamp"}


def decoded(req) -> dict:
    """A request as the provider decoded it, clocks dropped and the
    time-based message id checked for form and masked."""
    def strip(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in PB_VOLATILE:
                    continue
                if k == "id":
                    assert re.fullmatch(r"[0-9A-Za-z]+", v), v
                    v = "<base62 id>"
                out[k] = strip(v)
            return out
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(MessageToDict(req, preserving_proto_field_name=True))


def with_provider(hooks, go, setup=None):
    """Run ``go(pkg, node, prov, port)`` under each package against a
    fresh provider; each result with the provider's decoded calls."""
    def script(pkg):
        prov = Provider(hooks)
        if setup:
            setup(prov)
        server, port = prov.make_server()
        try:
            node = pkg.node()
            res = run(go(pkg, node, prov, port))
        finally:
            server.stop(grace=0.1)
        return res, [(n, decoded(r)) for n, r in prov.calls]
    return both(script)


def test_exhook_handshake_registers_wanted_hooks_alike():
    """OnProviderLoaded carries the same broker info; the same wanted
    hookpoints are registered; unload sends OnProviderUnloaded and takes
    the hooks off, in both packages."""
    async def go(pkg, node, prov, port):
        ex = pkg.exhook.Exhook(node, {"servers": []})
        await ex.load()
        await ex.add_server("p1", f"127.0.0.1:{port}")
        servers = [dict(s, url=s["url"].replace(str(port), "<port>"))
                   for s in ex.list_servers()]
        out = [prov.names(), sorted(ex.servers["p1"].hooks_wanted),
               bool(node.hooks.lookup("message.publish")),
               bool(node.hooks.lookup("message.acked")), servers]
        await ex.unload()
        return out + [prov.names(), bool(node.hooks.lookup(
            "message.publish")), getattr(node, "exhook", None)]
    want, got = with_provider(
        [("message.publish", []), ("client.connected", [])], go)
    assert got == want
    assert want[0][0] == ["loaded"] and want[0][2] and not want[0][3]
    assert want[1][0][1]["broker"]["version"] == "0.1.0"


def test_exhook_message_publish_mutation_and_topic_filter_alike():
    """A CONTINUE answer's payload replaces the message's on the filtered
    topic; a miss is not sent to the provider and routes as is."""
    class Cap:
        def __init__(self):
            self.msgs = []

        def deliver(self, f, m):
            self.msgs.append((m.topic, m.payload, m.qos))
            return True

    async def go(pkg, node, prov, port):
        ex = await pkg.exhook.Exhook(node, {"servers": []}).load()
        await ex.add_server("p1", f"127.0.0.1:{port}")
        cap = Cap()
        node.broker.subscribe(node.broker.register(cap, "c"), "#")
        await node.broker.publish_async(pkg.make("pub", 0, "only/x",
                                                 b"data"))
        await node.broker.publish_async(pkg.make("pub", 0, "other/x",
                                                 b"data"))
        await ex.unload()
        return cap.msgs

    def setup(prov):
        prov.publish_mutate = lambda m: pb.Message(
            topic=m.topic, qos=m.qos, payload=m.payload + b"-mutated")
    want, got = with_provider([("message.publish", ["only/#"])], go, setup)
    assert got == want
    assert want[0] == [("only/x", b"data-mutated", 0),
                       ("other/x", b"data", 0)]
    assert [n for n, _ in want[1]].count("publish") == 1


def test_exhook_authenticate_and_authorize_valued_alike():
    """STOP_AND_RETURN answers decide authenticate and authorize the same
    way, and the authorize request carries the action type."""
    async def go(pkg, node, prov, port):
        ex = await pkg.exhook.Exhook(node, {"servers": []}).load()
        await ex.add_server("p1", f"127.0.0.1:{port}")
        ci = {"clientid": "c1", "username": "u"}
        out = [await node.hooks.run_fold_async(
            "client.authenticate", (ci,), {"ok": True})]
        prov.auth_result = False
        out.append(await node.hooks.run_fold_async(
            "client.authenticate", (ci,), {"ok": True}))
        out.append(await node.hooks.run_fold_async(
            "client.authorize", (ci, "publish", "t/1"), "allow"))
        prov.authz_result = False
        out.append(await node.hooks.run_fold_async(
            "client.authorize", (ci, "subscribe", "t/1"), "allow"))
        await ex.unload()
        return out
    want, got = with_provider([("client.authenticate", []),
                               ("client.authorize", [])], go)
    assert got == want
    assert [r.get("ok", r) if isinstance(r, dict) else r
            for r in want[0]] == [True, False, "allow", "deny"]
    authz = [r for n, r in want[1] if n == "authorize"]
    assert authz[-1]["type"] == "SUBSCRIBE"


def test_exhook_failed_action_deny_vs_ignore_alike():
    """A server that cannot be reached: ``deny`` stops the chain with a
    refusal, ``ignore`` leaves it, in both packages."""
    def script(pkg):
        async def go():
            srv = pkg.exhook.ExhookServer(pkg.node(), "dead", "127.0.0.1:1",
                                          timeout=0.3, failed_action="deny")
            srv.hooks_wanted = {"client.authenticate": [],
                                "client.authorize": []}
            out = []
            for hp, args in (("client.authenticate",
                              ({"clientid": "x"}, {"ok": True})),
                             ("client.authorize",
                              ({"clientid": "x"}, "publish", "t", "allow"))):
                h = srv._make_handler(hp)
                srv.failed_action = "deny"
                out.append(await h(*args))
                srv.failed_action = "ignore"
                out.append(await h(*args))
            srv.channel.close()
            return out
        return run(go())
    want, got = both(script)
    assert got == want == [("stop", {"ok": False}), None, ("stop", "deny"),
                           None]


def test_exhook_nonvalued_events_forwarded_alike():
    """client.connected, session.subscribed and message.dropped reach the
    provider as the same decoded requests."""
    async def go(pkg, node, prov, port):
        ex = await pkg.exhook.Exhook(node, {"servers": []}).load()
        await ex.add_server("p1", f"127.0.0.1:{port}")
        node.hooks.run("client.connected",
                       ({"clientid": "c9"}, {"proto_ver": 5}))
        node.hooks.run("session.subscribed",
                       ({"clientid": "c9"}, "a/b", {"qos": 1}))
        node.broker.publish(pkg.make("p", 0, "nobody/home", b""))
        for _ in range(100):
            await asyncio.sleep(0.05)
            if len({n for n in prov.names()} & {
                    "connected", "subscribed", "dropped"}) == 3:
                break
        await ex.unload()
        return sorted(n for n in prov.names())

    def script_sorted(res):
        out, calls = res
        return out, sorted(calls, key=lambda c: json.dumps(c,
                                                           sort_keys=True))
    want, got = map(script_sorted, with_provider(
        [("client.connected", []), ("session.subscribed", []),
         ("message.dropped", [])], go))
    assert got == want
    assert want[0] == ["connected", "dropped", "loaded", "subscribed",
                       "unloaded"]
    conn = next(r for n, r in want[1] if n == "connected")
    assert conn["clientinfo"]["clientid"] == "c9"


def test_exhook_requests_build_alike_for_every_hookpoint():
    """``_build_request`` turns the same hook arguments into the same
    request for each of the 19 hookpoints of ``HOOK_METHODS``, and
    ``_apply_valued`` reads the same answers the same way."""
    def script(pkg):
        node = pkg.node()
        srv = pkg.exhook.ExhookServer(node, "s", "127.0.0.1:1")
        msg = pkg.make("pub", 1, "a/b", b"pay")
        ci = {"clientid": "c", "username": "u", "peername": ("1.2.3.4", 5),
              "proto_name": "MQTT", "proto_ver": 5, "keepalive": 30}
        args = {
            "client.connect": (ci, {}), "client.connack": (ci, 0),
            "client.connected": (ci, {}),
            "client.disconnected": (ci, "normal"),
            "client.authenticate": (ci, {"ok": True}),
            "client.authorize": (ci, "subscribe", "a/#", "allow"),
            "client.subscribe": (ci, {}, [("a/#", {"qos": 1}), "b/c"]),
            "client.unsubscribe": (ci, {}, ["a/#"]),
            "session.created": (ci, {}),
            "session.subscribed": (ci, "a/#", {"qos": 2}),
            "session.unsubscribed": (ci, "a/#"),
            "session.resumed": (ci, {}), "session.discarded": (ci, {}),
            "session.takenover": (ci, {}),
            "session.terminated": (ci, "kicked"),
            "message.publish": (msg,), "message.delivered": (ci, msg),
            "message.dropped": (msg, "no_subscribers"),
            "message.acked": (ci, msg)}
        assert sorted(args) == sorted(pkg.exhook.HOOK_METHODS)
        out = {}
        for hp, a in args.items():
            _m, cls, _v = pkg.exhook.HOOK_METHODS[hp]
            out[hp] = decoded(srv._build_request(hp, cls, a))
        answers = []
        for rtype in (pb.ValuedResponse.CONTINUE,
                      pb.ValuedResponse.STOP_AND_RETURN,
                      pb.ValuedResponse.IGNORE):
            for hp, a, resp in (
                    ("client.authenticate", args["client.authenticate"],
                     pb.ValuedResponse(type=rtype, bool_result=False)),
                    ("client.authorize", args["client.authorize"],
                     pb.ValuedResponse(type=rtype, bool_result=True)),
                    ("message.publish", (msg,), pb.ValuedResponse(
                        type=rtype, message=pb.Message(
                            topic="x/y", qos=0, payload=b"new")))):
                r = srv._apply_valued(hp, resp, a)
                if r is not None and hasattr(r[1], "payload"):
                    r = (r[0], r[1].topic, r[1].payload, r[1].qos)
                answers.append(r)
        deny = srv._deny_value("message.publish", (msg,))
        srv.channel.close()
        return out, answers, deny[0], deny[1].get_header("allow_publish")
    want, got = both(script)
    assert got == want
    assert want[0]["client.subscribe"]["topic_filters"] == [
        {"name": "a/#"}, {"name": "b/c"}]


# ---------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------
VM_LINES = ("emqx_vm_used_memory_kb", "emqx_vm_cpu_time_seconds")


def masked(text: str) -> list:
    """The exposition's lines with the two process-rusage samples kept by
    name only (their HELP and TYPE lines stay whole)."""
    out = []
    for line in text.split("\n"):
        if line.startswith(VM_LINES):
            name, _, value = line.partition(" ")
            float(value)
            line = f"{name} <rusage>"
        out.append(line)
    return out


def test_prometheus_collect_text_format_alike():
    def script(pkg):
        node = pkg.node()
        node.metrics.inc("messages.publish", 7)
        node.stats.setstat("connections.count", 3, "connections.max")
        return masked(pkg.prom.collect(node))
    want, got = both(script)
    assert got == want
    assert "# TYPE emqx_messages_publish counter" in want
    assert "emqx_messages_publish 7" in want
    assert "emqx_connections_max 3" in want
    assert "emqx_vm_used_memory_kb <rusage>" in want


def test_prometheus_rule_metrics_labels_alike():
    def script(pkg):
        node = pkg.node()
        eng = pkg.RuleEngine(node).load()
        eng.create_rule('SELECT * FROM "m/#"',
                        [{"name": "do_nothing", "params": {}}],
                        rule_id="rule-x")
        node.broker.publish(pkg.make("p", 0, "m/1", b""))
        return masked(pkg.prom.collect(node))
    want, got = both(script)
    assert got == want
    assert 'emqx_rule_sql_matched{rule="rule_x"} 1' in want


def test_prometheus_scrape_endpoint_alike():
    """GET /metrics and /api/v5/prometheus/stats answer 200 with the same
    exposition from each package's HTTP server."""
    def script(pkg):
        node = pkg.node()
        node.metrics.inc("messages.received", 4)
        srv = pkg.HttpServer("127.0.0.1", 0)
        pkg.prom.register_api(srv, node)

        async def go():
            await srv.start()
            out = []
            for path in ("/metrics", "/api/v5/prometheus/stats"):
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", srv.port)
                writer.write(f"GET {path} HTTP/1.1\r\nhost: x\r\n"
                             f"connection: close\r\n\r\n".encode())
                await writer.drain()
                raw = await reader.read(-1)
                writer.close()
                head, _, body = raw.partition(b"\r\n\r\n")
                out.append((head.split(b"\r\n")[0],
                            masked(body.decode())))
            await srv.stop()
            return out
        return run(go())
    want, got = both(script)
    assert got == want
    assert want[0][0].split()[1] == b"200"
    assert "emqx_messages_received 4" in want[0][1]


def test_prometheus_valid_exposition_with_traffic_alike():
    """The pipeline stage histogram renders the same cumulative buckets,
    sum and count; the occupancy histogram its family."""
    def script(pkg):
        node = pkg.node()
        node.metrics.inc("messages.publish", 3)
        tele = node.pipeline_telemetry
        for v in (1e-5, 2e-4, 0.003, 0.04):
            tele.observe_stage("dispatch", v)
        tele.record_occupancy("b64", 0.25)
        text = pkg.prom.collect(node)
        return masked(text), _parse_exposition(text)[
            "emqx_pipeline_stage_dispatch_seconds"]
    want, got = both(script)
    assert got[0] == want[0]
    fam = want[1]
    assert fam["type"] == "histogram"
    counts = [v for n, _l, v in fam["samples"] if n.endswith("_count")]
    infs = [v for n, lb, v in fam["samples"] if lb == '{le="+Inf"}']
    assert counts == infs == ["4"]


def test_prometheus_rule_families_one_type_and_escaped_labels_alike():
    def script(pkg):
        node = pkg.node()
        eng = pkg.RuleEngine(node).load()
        for rid in ('r"quote\\slash', "plain"):
            eng.create_rule('SELECT * FROM "m/#"',
                            [{"name": "do_nothing", "params": {}}],
                            rule_id=rid)
        node.broker.publish(pkg.make("p", 0, "m/1", b""))
        text = pkg.prom.collect(node)
        return masked(text), _parse_exposition(text)[
            "emqx_rule_sql_matched"]["samples"]
    want, got = both(script)
    assert got == want
    assert len(want[1]) == 2 and '\\"' in "\n".join(want[0])


def test_prometheus_push_loop_alike():
    """PrometheusApp pushes the exposition to the push gateway's
    ``/metrics/job/<job>/instance/<node>`` through utils/http."""
    def script(pkg):
        node = pkg.node()
        got = []
        srv = pkg.HttpServer("127.0.0.1", 0)

        async def sink(req):
            got.append((req.path, masked(req.body.decode())))
            return 200, {}
        srv.route("POST", "/metrics/job/:job/instance/:inst", sink)

        async def go():
            await srv.start()
            app = pkg.prom.PrometheusApp(node, {
                "push_gateway_server": f"http://127.0.0.1:{srv.port}",
                "interval": 0.05, "job_name": "j1"}).load()
            for _ in range(200):
                if got:
                    break
                await asyncio.sleep(0.02)
            app.unload()
            await srv.stop()
            return got[0], app.collect_text() == pkg.prom.collect(node), \
                getattr(node, "prometheus", None)
        return run(go())
    want, got = both(script)
    assert got == want
    assert want[0][0] == f"/metrics/job/j1/instance/{NAME}"


# ---------------------------------------------------------------------
# StatsD
# ---------------------------------------------------------------------
def _recv_all(sock) -> list:
    out = []
    while True:
        try:
            out.append(sock.recv(65536).decode())
        except BlockingIOError:
            return out


def _statsd(script):
    """``script(pkg, node, app, sock, flush)`` under each package: a
    StatsD app pointed at a bound UDP socket; ``flush()`` returns the
    datagrams received since the last read."""
    def one(pkg):
        node = pkg.node()

        async def go():
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("127.0.0.1", 0))
            sock.setblocking(False)
            app = pkg.statsd.StatsdApp(node, {
                "host": "127.0.0.1", "port": sock.getsockname()[1],
                "interval": 3600})
            app.load()

            async def recv():
                await asyncio.sleep(0.1)
                return _recv_all(sock)
            try:
                return await script(pkg, node, app, recv)
            finally:
                app.unload()
                sock.close()
        return run(go())
    return both(one)


def test_statsd_counter_deltas_and_gauges_alike():
    async def script(pkg, node, app, recv):
        node.metrics.inc("messages.publish", 5)
        app.flush()
        first = await recv()
        node.metrics.inc("messages.publish", 2)
        app.flush()
        return first, await recv()
    want, got = _statsd(script)
    assert got == want
    assert "emqx.messages.publish:5|c" in "".join(want[0])
    assert "|g" in "".join(want[0])
    assert "emqx.messages.publish:2|c" in "".join(want[1])


def test_statsd_histogram_ms_timers_alike():
    async def script(pkg, node, app, recv):
        h = node.metrics.hist("pipeline.stage.dispatch.seconds")
        h.observe(0.002)
        h.observe(0.004)
        app.flush()
        first = await recv()
        app.flush()
        return first, await recv()
    want, got = _statsd(script)
    assert got == want
    assert "emqx.pipeline.stage.dispatch.seconds:3.000|ms|@0.5" in \
        "".join(want[0])
    assert "|ms" not in "".join(want[1])


def test_statsd_unload_flushes_final_interval_alike():
    async def script(pkg, node, app, recv):
        node.metrics.inc("messages.publish", 9)
        app.unload()
        return await recv(), app._sock
    want, got = _statsd(script)
    assert got == want
    assert "emqx.messages.publish:9|c" in "".join(want[0])
    assert want[1] is None


def test_statsd_batches_and_interval_loop_alike():
    """Lines are packed into datagrams of at most ``batch_bytes``, and the
    interval loop flushes on its own."""
    def one(pkg):
        node = pkg.node()

        async def go():
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("127.0.0.1", 0))
            sock.setblocking(False)
            app = pkg.statsd.StatsdApp(node, {
                "host": "127.0.0.1", "port": sock.getsockname()[1],
                "interval": 0.05, "batch_bytes": 200, "prefix": "p"})
            app.load()
            for k in range(20):
                node.metrics.inc(f"custom.c{k:02d}", k + 1)
            got = []
            for _ in range(200):
                await asyncio.sleep(0.02)
                got += _recv_all(sock)
                if any("p.custom.c19:20|c" in d for d in got):
                    break
            app.unload()
            sock.close()
            return [d for d in got if "custom" in d], \
                max(len(d) for d in got)
        return run(go())
    want, got = both(one)
    assert got == want
    assert want[1] <= 200 and len(want[0]) > 1


# ---------------------------------------------------------------------
# telemetry and plugins
# ---------------------------------------------------------------------
def test_telemetry_report_shape_and_disabled_by_default_alike(monkeypatch):
    def script(pkg):
        monkeypatch.setattr(pkg.tele, "uuid", SeqUuid())
        node = pkg.node()
        pkg.plugins.Plugins(node, {"load": []})
        tel = pkg.tele.Telemetry(node)
        return tel.enabled, tel.get_telemetry()
    want, got = both(script)
    assert got == want
    assert want[0] is False
    assert want[1]["uuid"] == str(uuid.UUID(int=1))
    assert want[1]["license"]["edition"] == "opensource"
    assert want[1]["num_clients"] == 0


def test_telemetry_report_posts_to_endpoint_alike(monkeypatch):
    """report_once and the enabled loop POST the same JSON body."""
    def script(pkg):
        monkeypatch.setattr(pkg.tele, "uuid", SeqUuid())
        node = pkg.node()
        received = []
        srv = pkg.HttpServer("127.0.0.1", 0)

        async def sink(req):
            received.append(json.loads(req.body))
            return 200, {}
        srv.route("POST", "/telemetry", sink)

        async def go():
            await srv.start()
            url = f"http://127.0.0.1:{srv.port}/telemetry"
            tel = pkg.tele.Telemetry(node, {"enable": True, "url": url,
                                            "interval": 3600})
            ok = await tel.report_once()
            tel.load()
            for _ in range(200):
                if len(received) >= 2:
                    break
                await asyncio.sleep(0.02)
            tel.unload()
            await srv.stop()
            return ok, received, getattr(node, "telemetry", None)
        return run(go())
    want, got = both(script)
    assert got == want
    assert want[0] is True and len(want[1]) == 2
    assert want[1][0]["uuid"] == str(uuid.UUID(int=1))


def _fake_plugin(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    calls = []

    def load(node, conf):
        calls.append(("load", conf))

        class Inst:
            def unload(self):
                calls.append(("unload",))
        return Inst()
    mod.load = load
    mod._calls = calls
    return mod


@pytest.mark.parametrize("case", ["cycle", "bad", "disabled", "twice"])
def test_plugins_alike(case, monkeypatch):
    """The reference's three plugin cases, plus a second load of a loaded
    plugin and a module without ``load``: the same calls, answers,
    listings and errors in both packages."""
    def script(pkg):
        for name in ("fake_plugin_a", "fake_plugin_b"):
            monkeypatch.setitem(sys.modules, name, _fake_plugin(name))
        monkeypatch.setitem(sys.modules, "fake_plugin_noload",
                            types.ModuleType("fake_plugin_noload"))
        node = pkg.node()
        decl = {"cycle": [{"name": "a", "module": "fake_plugin_a",
                           "config": {"k": 1}}],
                "bad": [{"name": "bad", "module": "no_such_module_xyz"}],
                "disabled": [{"name": "b", "module": "fake_plugin_b",
                              "enabled": False}],
                "twice": [{"name": "a", "module": "fake_plugin_a"},
                          {"name": "n", "module": "fake_plugin_noload"}]}
        plugins = pkg.plugins.Plugins(node, {"load": decl[case]})
        out = [plugins.load_all(), plugins.list(), node.plugins is plugins]
        if case in ("cycle", "twice"):
            try:
                plugins.load("a", "fake_plugin_a")
            except ValueError as e:
                out.append(str(e))
            out += [plugins.is_loaded("a"), plugins.unload("a"),
                    plugins.is_loaded("a"), plugins.unload("a"),
                    sys.modules["fake_plugin_a"]._calls]
        plugins.load("b2", "fake_plugin_b", {"x": 2})
        out.append(plugins.list())
        plugins.unload_all()
        out += [plugins.list(), sys.modules["fake_plugin_b"]._calls]
        return out
    want, got = both(script)
    assert got == want
    if case == "cycle":
        assert want[0] == 1 and want[1][0]["enabled"] is True
        assert want[8] == [("load", {"k": 1}), ("unload",)]
    if case == "bad":
        assert want[0] == 0


# ---------------------------------------------------------------------
# PSK and the wire codec
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return ttls.generate_self_signed(str(tmp_path_factory.mktemp("certs")),
                                     cn="localhost")


def test_psk_store_file_and_lookup_alike(tmp_path):
    f = tmp_path / "psk.txt"
    f.write_text("# comment\nclient1:AABBCC\nclient2:00112233\n\n"
                 "noseparator\nclient3 ; 0A0B\n")

    def script(pkg):
        store = pkg.psk.PskStore()
        out = [store.load_file(str(f)), store.lookup("client1"),
               store.lookup("client2"), store.lookup("nope"), store.all()]
        store.insert("id9", "ff00")
        out += [store.lookup("id9"), store.delete("client1"),
                store.delete("client1"), store.all()]
        other = pkg.psk.PskStore()
        out += [other.load_file(str(f), separator=";"), other.all()]
        return out
    want, got = both(script)
    assert got == want
    assert want[:5] == [2, bytes.fromhex("AABBCC"),
                        bytes.fromhex("00112233"), None,
                        ["client1", "client2"]]


def test_psk_attach_gated_by_runtime_alike(certs):
    """On Python 3.12 neither ssl module has PSK callbacks: attach
    reports unsupported in both."""
    def script(pkg):
        store = pkg.psk.PskStore()
        store.insert("id1", "AA")
        ctx = pkg.tls.make_server_context({"certfile": certs["certfile"],
                                           "keyfile": certs["keyfile"]})
        return store.supported(), store.attach(ctx)
    want, got = both(script)
    assert got == want
    assert want[0] == want[1]


def test_wirecodec_round_trip_alike():
    """enc / dec / enc_default give the same JSON and the same values back
    in both packages, bytes and sets nested in dicts and lists."""
    obj = {"a": b"\x00\xffbin", "b": [1, b"x", {"c": {3, 1, 2}}],
           "d": (b"t", "s"), "e": {"$b": "not-b64-alone", "k": 1},
           "f": bytearray(b"ba"), "g": None}

    def script(pkg):
        text = json.dumps(pkg.wire.enc(obj), sort_keys=True)
        back = pkg.wire.dec(json.loads(text))
        shallow = json.dumps({"x": b"ab", "y": {2, 1}},
                             default=pkg.wire.enc_default, sort_keys=True)
        try:
            json.dumps({"z": object()}, default=pkg.wire.enc_default)
            err = None
        except TypeError as e:
            err = type(e).__name__
        return text, back, shallow, err
    want, got = both(script)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1] == want[1]
    back = want[1]
    assert back["a"] == b"\x00\xffbin" and back["b"][2]["c"] == {1, 2, 3}
    assert back["d"] == [b"t", "s"] and back["f"] == b"ba"
    assert want[3] == "TypeError"
