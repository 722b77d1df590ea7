"""Port vs JAX reference: the default node booted from its config file.

The repo's ``etc/emqx.conf`` with a runtime-override file beside it that
moves every listener to 127.0.0.1 port 0 and adds TLS ones boots the
reference's ``Node.from_config_file`` and the port's (``device="cpu"``);
``start_listeners`` serves tcp, ssl, ws and wss. The same client script
(the port's ``Client`` over TCP, TLS and WebSocket) must get equal
CONNACKs and equal deliveries from both. Then the layers the default node
builds beside the listeners: the banned table under a scripted clock, the
OS monitor under scripted readings, each connection's congestion alarm
over a scripted transport, and the logger's handler count. Last, the
host-only node (``device_route: false``) against the reference's on
``chip_smoke.py``'s phase 8 flood at a small size.
"""

import asyncio
import logging
import os
import shutil
import ssl
import time
import types

import pytest
import torch

import chip_smoke as cs
from emqx_tpu.broker import banned as jbanned
from emqx_tpu.broker import congestion as jcongestion
from emqx_tpu.broker import monitor as jmonitor
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.utils import logger as jlogger
from emqx_tpu.utils import tls as jtls
from emqx_tpu_torch.broker import banned as tbanned
from emqx_tpu_torch.broker import congestion as tcongestion
from emqx_tpu_torch.broker import monitor as tmonitor
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.broker.ws import open_ws_connection
from emqx_tpu_torch.client import Client, MqttError
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.utils import logger as tlogger
from emqx_tpu_torch.utils import tls as ttls

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
TRANSPORTS = ("tcp", "ssl", "ws", "wss")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return ttls.generate_self_signed(str(tmp_path_factory.mktemp("certs")),
                                     cn="localhost", client_cn="client-7")


@pytest.fixture(autouse=True)
def _logging_restored():
    """``etc/emqx.conf`` turns the logger on: each package's boot installs
    one handler on its namespace (propagation off). Put both namespaces
    back afterwards, so later tests in this process see the logging they
    started with."""
    saved = []
    for name in ("emqx_tpu", "emqx_tpu_torch"):
        lg = logging.getLogger(name)
        saved.append((lg, list(lg.handlers), lg.level, lg.propagate))
    flags = (jlogger._configured, tlogger._configured)
    yield
    for lg, handlers, level, propagate in saved:
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate
    jlogger._configured, tlogger._configured = flags


def override_text(certs, extra: str = "") -> str:
    ssl_block = (f'ssl {{ certfile = "{certs["certfile"]}", '
                 f'keyfile = "{certs["keyfile"]}", '
                 f'cacertfile = "{certs["cacertfile"]}", '
                 f'verify = verify_none }}')
    peer = (f'ssl {{ certfile = "{certs["certfile"]}", '
            f'keyfile = "{certs["keyfile"]}", '
            f'cacertfile = "{certs["cacertfile"]}", '
            f'verify = verify_peer, fail_if_no_peer_cert = true }}')
    return f"""
listeners {{
  tcp_default {{ bind = "127.0.0.1", port = 0 }}
  ws_default {{ bind = "127.0.0.1", port = 0 }}
  ssl_default {{ type = ssl, bind = "127.0.0.1", port = 0
                 {ssl_block} }}
  wss_default {{ type = wss, bind = "127.0.0.1", port = 0, path = "/mqtt"
                 {ssl_block} }}
  ssl_certz {{ type = ssl, bind = "127.0.0.1", port = 0, zone = certz
               {peer} }}
}}
zones.certz.mqtt.peer_cert_as_username = cn
{extra}
"""


def boot_file(tmp_path, certs, extra: str = "") -> str:
    """etc/emqx.conf copied, its emqx_override.conf written beside it."""
    path = tmp_path / "emqx.conf"
    shutil.copy(os.path.join(REPO, "etc", "emqx.conf"), path)
    (tmp_path / "emqx_override.conf").write_text(override_text(certs,
                                                               extra))
    return str(path)


def boot(path: str, ref: bool, **conf):
    if ref:
        return JNode.from_config_file(path, **conf)
    return TNode.from_config_file(path, device="cpu", **conf)


def connector(node, transport: str, certs, **kw):
    """A port Client for one of the node's listeners."""
    lsts = node.listeners
    if transport in ("tcp", "ssl"):
        lst = next(x for x in lsts if getattr(x, "name", "") ==
                   f"{transport}:{transport}_default")
        if transport == "ssl":
            kw.setdefault("ssl", {"cacertfile": certs["cacertfile"]})
        return Client(port=lst.port, **kw)
    proto = "mqtt:ws" if transport == "ws" else "mqtt:wss"
    lst = next(x for x in lsts if getattr(x, "protocol", "") == proto)
    ctx = ttls.make_client_context({"cacertfile": certs["cacertfile"]}) \
        if transport == "wss" else None
    return Client(conn_factory=lambda: open_ws_connection(
        "127.0.0.1", lst.port, path="/mqtt", ssl=ctx), **kw)


async def stop(node) -> None:
    await node.stop_listeners()
    if node.publish_batcher is not None:
        await node.publish_batcher.stop()
        node.publish_batcher.close()


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


async def client_script(node, certs) -> dict:
    """One subscriber and one publisher per transport (v5 and v4): every
    subscriber takes boot/#, every publisher sends 6 messages (QoS 0 and
    1 alternating); each subscriber's deliveries by publisher in arrival
    order, and every CONNACK."""
    await node.start_listeners()
    clients, acks = [], {}
    try:
        subs = {}
        for k, tr in enumerate(TRANSPORTS):
            cl = connector(node, tr, certs, clientid=f"s-{tr}",
                           proto_ver=C.MQTT_V5 if k % 2 else C.MQTT_V4)
            ack = await cl.connect()
            acks[cl.clientid] = (ack.reason_code, ack.session_present,
                                 sorted((ack.properties or {}).items()))
            clients.append(cl)
            await cl.subscribe("boot/#", qos=1)
            subs[tr] = cl
        for k, tr in enumerate(TRANSPORTS):
            cl = connector(node, tr, certs, clientid=f"p-{tr}",
                           proto_ver=C.MQTT_V4 if k % 2 else C.MQTT_V5)
            ack = await cl.connect()
            acks[cl.clientid] = (ack.reason_code, ack.session_present,
                                 sorted((ack.properties or {}).items()))
            clients.append(cl)
            for j in range(6):
                await cl.publish(f"boot/{tr}/{j}", f"{tr}{j}".encode(),
                                 qos=j % 2)
        got = {}
        for tr, cl in subs.items():
            rows: dict = {}
            for _ in range(6 * len(TRANSPORTS)):
                m = await cl.recv(timeout=20)
                rows.setdefault(m.topic.split("/")[1], []).append(
                    (m.topic, m.payload, m.qos))
            got[tr] = rows
        return {"acks": acks, "got": got,
                "connected": node.metrics.val("client.connected")}
    finally:
        for cl in clients:
            await cl.disconnect()
        await stop(node)


def test_boot_from_the_shipped_config_equals_reference(tmp_path, certs):
    """etc/emqx.conf (device_route on) boots both nodes; tcp, ssl, ws and
    wss serve; the same script gets equal CONNACKs and deliveries."""
    path = boot_file(tmp_path, certs)
    want = run(client_script(boot(path, True), certs))
    got = run(client_script(boot(path, False), certs))
    assert got == want
    assert got["connected"] == 2 * len(TRANSPORTS)
    for rows in got["got"].values():
        assert sorted(rows) == sorted(TRANSPORTS)
        assert all(len(r) == 6 for r in rows.values())


def test_listener_set_from_the_file(tmp_path, certs):
    """The same listener set (names, kinds, TLS or not) in both nodes; the
    TLS listeners keep one accept loop."""
    path = boot_file(tmp_path, certs)

    async def go(node):
        await node.start_listeners()
        try:
            return sorted(
                (getattr(x, "name", None) or x.protocol,
                 type(x).__name__, bool(x.ssl_opts),
                 len(getattr(x, "_lane_servers", [])) <= 1
                 if x.ssl_opts else None)
                for x in node.listeners)
        finally:
            await stop(node)
    want = run(go(boot(path, True)))
    assert run(go(boot(path, False))) == want
    assert len(want) == 5


def test_config_and_schema_equal_reference(tmp_path, certs):
    """Config.load_file of the booted file: every section the port reads
    equals the reference's, after coercion."""
    from emqx_tpu.broker.config import Config as JConfig
    from emqx_tpu_torch.broker.config import Config as TConfig
    path = boot_file(tmp_path, certs)
    j, t = JConfig.load_file(path), TConfig.load_file(path)
    for sec in ("mqtt", "listeners", "zones", "log", "sysmon",
                "conn_congestion", "force_shutdown", "alarm",
                "rate_limit", "authz", "authn", "retainer", "delayed",
                "rewrite", "topic_metrics", "event_message",
                "flapping_detect", "rule_engine", "cluster", "rpc"):
        assert t.get(sec) == j.get(sec), sec
    for key in ("sys_msg_interval", "sys_heartbeat_interval",
                "shared_subscription_strategy", "device_route",
                "batch_window_us"):
        assert t.get("broker", key) == j.get("broker", key), key
    assert t.get("mqtt", "idle_timeout") == 15
    assert t.get("broker", "sys_msg_interval") == 60


def test_config_defaults_equal_reference():
    """The port's DEFAULTS tree is the reference's: every root section
    (the feature apps' and the layers' still to port among them) and
    every broker key, so an empty Config's to_dict is equal."""
    from emqx_tpu.broker.config import Config as JConfig
    from emqx_tpu_torch.broker.config import Config as TConfig
    assert TConfig().to_dict() == JConfig().to_dict()
    assert TConfig().get("retainer") == {
        "enable": True, "max_retained_messages": 0,
        "max_payload_size": 1048576, "msg_expiry_interval": 0,
        "msg_clear_interval": 0}


def test_config_file_and_update_equal_reference(tmp_path, certs):
    """Config.load_file of phase 15's boot file (etc/emqx.conf with
    chip_smoke's override beside it) gives equal trees; a runtime update
    of a feature app's key gives the same tree and persists the same
    override file."""
    import shutil

    from emqx_tpu.broker.config import Config as JConfig
    from emqx_tpu_torch.broker.config import Config as TConfig
    out = []
    for cls, sub in ((JConfig, "j"), (TConfig, "t")):
        d = tmp_path / sub
        d.mkdir()
        shutil.copy(cs.BOOT_CONF, d / "emqx.conf")
        (d / "emqx_override.conf").write_text(cs.boot_override(certs))
        conf = cls.load_file(str(d / "emqx.conf"))
        before = conf.to_dict()
        conf.update(("retainer", "max_retained_messages"), 10)
        conf.update(("delayed", "enable"), False)
        again = cls.load_file(str(d / "emqx.conf"))
        out.append((before, conf.to_dict(), again.to_dict(),
                    (d / "emqx_override.conf").read_text()))
    assert out[1] == out[0]
    assert out[1][1]["retainer"]["max_retained_messages"] == 10
    assert out[1][2] == out[1][1]


def test_tls_rejections_and_peer_cert(tmp_path, certs):
    """A plain client on the TLS port fails; the verify_peer listener
    refuses a client without a certificate and names a certified one by
    its CN (peer_cert_as_username) — in both packages."""
    path = boot_file(tmp_path, certs)

    async def go(node):
        await node.start_listeners()
        try:
            ssl_port = next(x.port for x in node.listeners
                            if getattr(x, "name", "") == "ssl:ssl_default")
            certz = next(x.port for x in node.listeners
                         if getattr(x, "name", "") == "ssl:ssl_certz")
            with pytest.raises(Exception):
                await asyncio.wait_for(
                    Client(port=ssl_port, clientid="plain").connect(
                        timeout=3), 5)
            with pytest.raises(Exception):
                await asyncio.wait_for(Client(
                    port=certz, clientid="nocert",
                    ssl={"cacertfile": certs["cacertfile"]}).connect(
                        timeout=3), 5)
            ok = Client(port=certz, clientid="certclient", ssl={
                "cacertfile": certs["cacertfile"],
                "certfile": certs["client_certfile"],
                "keyfile": certs["client_keyfile"]})
            ack = await ok.connect()
            user = node.cm.lookup_channel("certclient").clientinfo[
                "username"]
            await ok.disconnect()
            return ack.reason_code, user
        finally:
            await stop(node)
    want = run(go(boot(path, True)))
    assert run(go(boot(path, False))) == want == (0, "client-7")


def test_tls_contexts_equal_reference(certs):
    """make_server_context / make_client_context give the same versions
    and verify modes; the TLS 1.2 minimum holds by default."""
    for opts in ({}, {"versions": ["tlsv1.2", "tlsv1.3"]},
                 {"versions": ["tlsv1.3"]},
                 {"verify": "verify_peer",
                  "cacertfile": certs["cacertfile"]},
                 {"verify": "verify_peer", "fail_if_no_peer_cert": True,
                  "cacertfile": certs["cacertfile"]}):
        o = dict(opts, certfile=certs["certfile"],
                 keyfile=certs["keyfile"])
        j, t = jtls.make_server_context(o), ttls.make_server_context(o)
        assert (t.minimum_version, t.maximum_version, t.verify_mode) == \
            (j.minimum_version, j.maximum_version, j.verify_mode)
    assert ttls.make_server_context(
        {"certfile": certs["certfile"], "keyfile": certs["keyfile"]}
    ).minimum_version == ssl.TLSVersion.TLSv1_2
    for opts in ({}, {"cacertfile": certs["cacertfile"]}):
        j, t = jtls.make_client_context(opts), ttls.make_client_context(
            opts)
        assert (t.minimum_version, t.verify_mode, t.check_hostname) == \
            (j.minimum_version, j.verify_mode, j.check_hostname)
    info = {"raw": {"subject": ((("commonName", "x"),),
                                (("organizationName", "o"),))},
            "commonName": "x"}
    for src in ("cn", "dn", "other"):
        assert ttls.cert_field(info, src) == jtls.cert_field(info, src)


@pytest.mark.parametrize("ltype", ["ssl", "wss", "quic"])
def test_listener_without_its_block_raises(tmp_path, ltype):
    """A TLS listener without an ssl block raises in both packages (never
    a plaintext downgrade); a quic listener without its certificate and
    key raises the reference's message."""
    path = tmp_path / "emqx.conf"
    path.write_text(f"listeners.bad {{ type = {ltype}, port = 0 }}\n")

    async def go(node):
        try:
            with pytest.raises(ValueError) as e:
                await node.start_listeners()
            return str(e.value)
        finally:
            await stop(node)
    got = run(go(TNode.from_config_file(str(path), device="cpu")))
    assert got == run(go(JNode.from_config_file(str(path),
                                                use_device=False)))


class _Clock:
    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t


def test_banned_client_refused_then_admitted(tmp_path, certs, monkeypatch):
    """A banned clientid gets CONNACK 0x8A (v5) over every transport, and
    connects once the ban has expired and sweep ran (a scripted clock)."""
    clock = _Clock(1000.0)
    monkeypatch.setattr(jbanned, "time", clock)
    monkeypatch.setattr(tbanned, "time", clock)
    path = boot_file(tmp_path, certs)

    async def go(node):
        clock.t = 1000.0
        await node.start_listeners()
        try:
            node.banned.create("clientid", "bad", reason="t",
                               duration=30)
            out = []
            for tr in TRANSPORTS:
                cl = connector(node, tr, certs, clientid="bad",
                               proto_ver=C.MQTT_V5)
                with pytest.raises(MqttError):
                    await cl.connect()
                out.append(cl.connack.reason_code)
                await cl.close()
            out.append(len(node.banned.all()))
            clock.t += 31
            node.sweep()
            out.append(len(node.banned.all()))
            for tr in TRANSPORTS:
                cl = connector(node, tr, certs, clientid="bad",
                               proto_ver=C.MQTT_V5)
                ack = await cl.connect()
                out.append(ack.reason_code)
                await cl.disconnect()
            return out
        finally:
            await stop(node)
    want = run(go(boot(path, True)))
    got = run(go(boot(path, False)))
    assert got == want == [C.RC_BANNED] * 4 + [1, 0] + [0] * 4


def test_banned_table_equals_reference(monkeypatch):
    """Create, look up, check, delete and expire: the same answers."""
    clock = _Clock(50.0)
    monkeypatch.setattr(jbanned, "time", clock)
    monkeypatch.setattr(tbanned, "time", clock)
    out = []
    for mod in (jbanned, tbanned):
        clock.t = 50.0
        b = mod.Banned()
        rows = []
        b.create("clientid", "c1", duration=10)
        b.create("username", "u1")
        b.create("peerhost", "10.0.0.1", duration=5)
        with pytest.raises(ValueError):
            b.create("nope", "x")
        for info in ({"clientid": "c1"}, {"username": "u1"},
                     {"clientid": "c2", "peername": ("10.0.0.1", 7)},
                     {"clientid": "c3"}):
            rows.append(b.check(info))
        clock.t = 56.0
        rows.append(b.expire())
        rows.append(sorted((e.kind, e.value) for e in b.all()))
        clock.t = 61.0
        b.tick()
        rows.append(sorted((e.kind, e.value) for e in b.all()))
        rows.append((b.delete("username", "u1"),
                     b.delete("username", "u1")))
        out.append(rows)
    assert out[0] == out[1]


READINGS = [  # (used, total), proc rss, cpu load
    ((10, 100), 1, 0.1), ((80, 100), 1, 0.9), ((80, 100), 9, 0.7),
    ((20, 100), 9, 0.5), ((20, 100), 2, 0.95), ((0, 0), 2, 0.1)]


def test_os_mon_alarms_equal_reference(tmp_path, certs, monkeypatch):
    """OsMon on the booted node under scripted readings raises and clears
    the same alarms as the reference's."""
    path = boot_file(tmp_path, certs)
    feed = {}
    for mod in (jmonitor, tmonitor):
        monkeypatch.setattr(mod, "sys_memory", lambda: feed["mem"])
        monkeypatch.setattr(mod, "proc_memory", lambda: feed["rss"])
        monkeypatch.setattr(mod, "cpu_load", lambda: feed["cpu"])
    out = []
    for node in (boot(path, True), boot(path, False)):
        rows = []
        for mem, rss, cpu in READINGS:
            feed.update(mem=mem, rss=rss, cpu=cpu)
            node.sweep()
            rows.append(sorted(
                (a["name"], a.get("details", {}).get("usage"))
                for a in node.alarms.get_alarms("activated")))
        rows.append(sorted(node.os_mon.info()))
        rows.append((node.os_mon.sysmem_high, node.os_mon.procmem_high))
        out.append(rows)
    assert out[0] == out[1]
    assert any(out[1][:-2])


def test_congestion_alarm_equals_reference(tmp_path, certs, monkeypatch):
    """Each package's Congestion over a scripted transport: the same
    conn_congestion/<clientid>/<user> alarm raised, held while the send
    buffer stays non-empty, cleared after the sustain, and the same
    connection.congested counts; a connection built by the node carries
    one from its zone's conn_congestion."""
    clock = _Clock(0.0)
    monkeypatch.setattr(jcongestion, "time", clock)
    monkeypatch.setattr(tcongestion, "time", clock)
    path = boot_file(tmp_path, certs, "conn_congestion { enable_alarm = "
                     "true, min_alarm_sustain_duration = 2s }")
    pend = [0, 5, 5, 0, 0, 7, 0, 0, 0, 0]
    out = []
    for ref in (True, False):
        node = boot(path, ref)
        mod = jcongestion if ref else tcongestion
        buf = {"n": 0}
        transport = types.SimpleNamespace(
            get_write_buffer_size=lambda: buf["n"])
        chan = types.SimpleNamespace(
            clientid="c9", clientinfo={"username": "u9"},
            conninfo={"peername": ("127.0.0.1", 5)}, conn_state="connected")
        cc = node.config.get("conn_congestion")
        cong = mod.Congestion(
            node, chan, types.SimpleNamespace(transport=transport),
            enable_alarm=cc["enable_alarm"],
            min_alarm_sustain_duration=cc["min_alarm_sustain_duration"])
        rows = []
        for k, n in enumerate(pend):
            clock.t = float(k)
            buf["n"] = n
            cong.check()
            rows.append(([a["name"] for a in
                          node.alarms.get_alarms("activated")],
                         node.metrics.val("connection.congested")))
        cong.check()
        cong.cancel()
        rows.append([a["name"] for a in
                     node.alarms.get_alarms("activated")])
        out.append(rows)
    assert out[0] == out[1]
    assert out[1][1][0] == ["conn_congestion/c9/u9"]


def test_ws_connection_keeps_its_timer_with_congestion_on():
    """A departure on purpose: with ``conn_congestion.enable_alarm`` on,
    the reference's WebSocket writer has no ``transport``, so its first
    congestion check kills the connection's timer task (keepalive and
    retries with it); the port's writer exposes the TCP transport and
    the timer lives."""
    from emqx_tpu.broker.ws import WsListener as JWs
    from emqx_tpu_torch.broker.ws import WsListener as TWs
    conf = {"conn_congestion": {"enable_alarm": True}}

    async def go(node, cls, done):
        lst = cls(node, bind="127.0.0.1", port=0)
        await lst.start()
        cl = Client(conn_factory=lambda: open_ws_connection(
            "127.0.0.1", lst.port), clientid="w")
        try:
            await cl.connect()
            # a bounded wait for the first congestion check (1 s timer),
            # not a fixed sleep that a loaded host can outrun
            t_end = time.monotonic() + 10.0
            while not done(node) and time.monotonic() < t_end:
                await asyncio.sleep(0.05)
            return node.metrics.val("supervise.task_errors")
        finally:
            await cl.disconnect()
            await lst.stop()

    def ref_done(node):         # the reference's timer task died
        return node.metrics.val("supervise.task_errors") >= 1

    checks = []
    orig = tcongestion.Congestion.check

    def counted(self, *a, **kw):
        checks.append(1)
        return orig(self, *a, **kw)

    def port_done(node):        # the port's timer ran a congestion check
        return len(checks) >= 1
    assert run(go(JNode(conf, use_device=False), JWs, ref_done)) == 1
    tcongestion.Congestion.check = counted
    try:
        assert run(go(TNode(dict(conf, broker={"device_route": False}),
                            device="cpu"), TWs, port_done)) == 0
    finally:
        tcongestion.Congestion.check = orig
    assert checks


def test_logger_handler_count_fixed(tmp_path, certs):
    """setup_from_config runs once per process in each package: booting
    several nodes with the log on installs one handler on each namespace,
    not one per node, and never on the root logger."""
    path = boot_file(tmp_path, certs)
    jlogger._configured = tlogger._configured = False
    counts = []
    root = len(logging.getLogger().handlers)
    for name in ("emqx_tpu", "emqx_tpu_torch"):
        lg = logging.getLogger(name)
        lg.handlers[:] = []
    for _ in range(3):
        boot(path, True)
        boot(path, False)
        counts.append((len(logging.getLogger("emqx_tpu").handlers),
                       len(logging.getLogger("emqx_tpu_torch").handlers)))
    assert counts == [(1, 1)] * 3
    assert len(logging.getLogger().handlers) == root
    lg = logging.getLogger("emqx_tpu_torch")
    assert lg.level == logging.INFO and lg.propagate is False
    assert type(lg.handlers[0].formatter).__name__ == "TextFormatter"


# ---- the host-only node (device_route: false) ---------------------------

HOST_FILTERS, HOST_SUB, HOST_PUB, HOST_MSGS = 2000, 4, 2, 600


async def host_flood(node) -> dict:
    await node.start_listeners()
    port = node.listeners[0].port
    clients = []
    try:
        subs, ids, nums, _n, _e = await cs._subscribe_population(
            port, HOST_FILTERS, HOST_SUB)
        clients += subs
        for c in range(HOST_PUB):
            cl = Client(port=port, clientid=f"epub{c}")
            await cl.connect()
            clients.append(cl)
        f = await cs._flood(node, subs, clients[HOST_SUB:], ids, nums,
                            HOST_MSGS, cs.SEED)
        f["nums"] = nums
        f["metrics"] = {k: v for k, v in node.metrics.all().items()
                        if k.startswith(("routing.", "messages."))}
        return f
    finally:
        for cl in clients:
            await cl.disconnect()
        await stop(node)


def test_host_only_node_equals_reference(tmp_path):
    """device_route: false in the file: neither node builds an engine or
    a batcher; the port builds no recorder, supervisor, ledger or lanes
    (the observatory and governor stay, as in the reference). A flood
    over TCP delivers every message once, in publisher order, with equal
    plain-subscription deliveries and equal routing.* / messages.*
    counters."""
    path = tmp_path / "emqx.conf"
    path.write_text('listeners.tcp_default { type = tcp, bind = '
                    '"127.0.0.1", port = 0 }\n'
                    'broker.device_route = false\n')
    nodes = [JNode.from_config_file(str(path)),
             TNode.from_config_file(str(path), device="cpu")]
    for n in nodes:
        assert n.device_engine is None and n.publish_batcher is None
        assert (n.flight_recorder, n.supervisor, n.hbm_ledger,
                n.deliver_lanes) == (None, None, None, None)
        assert n.latency_observatory is not None \
            and n.overload_governor is not None
    assert nodes[1].router.device is None
    want, got = (run(host_flood(n)) for n in nodes)
    for f in (want, got):
        assert f["delivered"] == f["sent"] == HOST_MSGS
        assert f["device_routed"] == 0 and f["batches"] == 0
    assert got["metrics"] == want["metrics"]

    def plain(f):
        return [sorted((p, s) for p, s, i, n, _q in rows
                       if not cs.e2e_shared(i, n, f["nums"]))
                for rows in f["got"]]
    assert plain(got) == plain(want)


def test_chip_smoke_boot_on_cpu():
    """chip_smoke.py's phase 15 rehearsed on the CPU at a reduced size
    (1,000 filters, 4 subscriber connections, two of them on QUIC,
    400-message floods, the chooser pinned to the device engine, 6
    messages through 15e's dropper): the booted node serves over TCP,
    TLS, WebSocket and QUIC, 15b's ban, monitor and congestion checks
    pass, the dense node delivers as the CSR one (the mesh twins too),
    the host-only node routes with nothing on the device path, and 15e's
    refusals, Retry, lossy delivery, idle reaping and listener stop
    pass."""
    r = cs.boot_drive(torch.device("cpu"), n_filters=1000, n_sub=4,
                      total=400, dense_total=400, mesh_total=256,
                      host_total=400, pin_device=True, lossy_msgs=6)
    a = r["a"]["flood"]
    assert a["delivered"] == 400 and set(a["by_group"]) == {
        "tcp", "ssl", "ws", "quic"}
    quic = r["a"]["quic"]
    assert sorted(quic) == ["apub8", "apub9", "esub0", "esub1"]
    assert all(q["received"] and q["sent"] for sides in quic.values()
               for q in sides.values())
    assert r["b"]["congestion"]["congested"] >= 1
    c = r["c"]
    assert c["dense"]["readback"]["pipeline.readback.windows.compact"] == 0
    assert c["csr"]["delivered"] == c["dense"]["delivered"] == 400
    assert c["mesh"]["dense"]["delivered"] == c["mesh"]["csr"]["delivered"]
    assert r["d"]["device_routed"] == 0 and r["d"]["delivered"] == 400
    e = r["e"]
    assert all(e["refused"].values()) and e["retry"]["saw_retry"]
    assert e["lossy"]["duplicates"] == 0 and e["idle_reason"]
    assert e["stopped"]["socket_closed"] and e["stopped"]["connections"]
