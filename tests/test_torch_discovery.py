"""Port vs JAX reference: cluster discovery and autocluster.

The same inputs of the reference's ``tests/test_discovery.py`` go to both
packages' strategies (manual, static, dns through a stub resolver, etcd
and k8s against a local fake HTTP server, mcast): equal seeds, and the
fake servers see equal requests. ``from_config`` builds equal strategies
from the ``cluster`` block; autocluster joins port nodes (and a port node
to a reference seed) into one cluster. Loopback multicast is checked
live where the host routes it; the probe and reply bytes are compared
either way.
"""

import asyncio
import base64
import json

import pytest

from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.cluster import discovery as jd
from emqx_tpu.cluster.cluster import ClusterNode as JClusterNode
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.cluster import discovery as td
from emqx_tpu_torch.cluster.cluster import ClusterNode as TClusterNode

MODS = (jd, td)


def run(coro, timeout=20):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


async def _http_json_server(payload, capture: list):
    """payload: a dict for every request, or (req_line, body) -> dict."""
    async def handler(reader, writer):
        try:
            req = await reader.readuntil(b"\r\n\r\n")
            head = req.decode()
            clen = 0
            for line in head.split("\r\n"):
                if line.lower().startswith("content-length:"):
                    clen = int(line.split(":")[1])
            body = await reader.readexactly(clen) if clen else b""
            headers = sorted(h.lower() for h in head.split("\r\n")[1:]
                             if h and not h.lower().startswith("host:"))
            line = head.split("\r\n")[0]
            capture.append((line, body, headers))
            doc = payload(line, body) if callable(payload) else payload
            out = json.dumps(doc).encode()
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: "
                         b"application/json\r\ncontent-length: "
                         + str(len(out)).encode() + b"\r\n\r\n" + out)
            await writer.drain()
        finally:
            writer.close()
    return await asyncio.start_server(handler, "127.0.0.1", 0)


def both(make_strategy):
    """discover() of each package's strategy: (seeds, requests) pairs."""
    out = []
    for mod in MODS:
        out.append(run(make_strategy(mod)))
    return out


@pytest.mark.parametrize("case", ["manual", "static", "dns"])
def test_local_strategies_equal_reference(case):
    async def go(mod):
        if case == "manual":
            d = mod.ManualDiscovery()
        elif case == "static":
            d = mod.StaticDiscovery(["10.0.0.1:4370", ("10.0.0.2", 4371),
                                     "[::1]:4372"])
        else:
            d = mod.DnsDiscovery(
                "emqx.cluster.local", 4370,
                resolver=lambda name: ["10.1.1.1", "10.1.1.2"])
        return d.strategy, await d.discover()
    ref, port = both(go)
    assert port == ref


def test_static_bad_seed_raises_alike():
    for mod in MODS:
        with pytest.raises(ValueError, match="host:port"):
            mod.StaticDiscovery(["no-port"])


@pytest.mark.parametrize("doc", [
    {"kvs": [{"key": "aaa", "value": base64.b64encode(
        b"127.0.0.1:4444").decode()},
             {"key": "bbb", "value": base64.b64encode(b"bad").decode()}]},
    {},
])
def test_etcd_equals_reference(doc):
    async def go(mod):
        cap = []
        srv = await _http_json_server(doc, cap)
        port = srv.sockets[0].getsockname()[1]
        try:
            d = mod.EtcdDiscovery(f"http://127.0.0.1:{port}",
                                  prefix="emqxcl", cluster_name="c1")
            return await d.discover(), cap
        finally:
            srv.close()
    ref, port = both(go)
    assert port == ref
    assert ref[1][0][0].startswith("POST /v3/kv/range")


def test_k8s_equals_reference():
    doc = {"subsets": [{
        "addresses": [{"ip": "10.2.0.5"}, {"ip": "10.2.0.6"}],
        "ports": [{"name": "ekka", "port": 4370}]},
        {"addresses": [{"ip": "10.2.0.7"}], "ports": [{"name": "x",
                                                        "port": 1}]}]}

    async def go(mod):
        cap = []
        srv = await _http_json_server(doc, cap)
        port = srv.sockets[0].getsockname()[1]
        try:
            d = mod.K8sDiscovery(f"http://127.0.0.1:{port}", "emqx",
                                 namespace="iot", token="tok123")
            return await d.discover(), cap
        finally:
            srv.close()
    ref, port = both(go)
    assert port == ref
    assert "/api/v1/namespaces/iot/endpoints/emqx" in ref[1][0][0]


def test_unreachable_http_discovers_nothing_alike():
    async def go(mod):
        srv = await asyncio.start_server(lambda r, w: w.close(),
                                         "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        srv.close()
        await srv.wait_closed()
        e = mod.EtcdDiscovery(f"http://127.0.0.1:{port}", timeout=1)
        k = mod.K8sDiscovery(f"http://127.0.0.1:{port}", "s", timeout=1)
        return await e.discover(), await k.discover()
    ref, port = both(go)
    assert port == ref == ([], [])


CONFIGS = [
    {"discovery": "manual"},
    {},
    {"discovery": "static", "nodes": ["a:1", "b:2"]},
    {"discovery": "static", "seeds": [["c", 3]]},
    {"discovery": "dns", "dns": {"name": "x", "port": 1}},
    {"discovery": "dns", "name": "y"},
    {"discovery": "etcd"},
    {"discovery": "etcd", "name": "c2",
     "etcd": {"server": "http://e:2379/", "prefix": "p"}},
    {"discovery": "k8s"},
    {"discovery": "k8s", "k8s": {"apiserver": "http://k", "namespace":
                                 "n", "service_name": "s", "port": 9,
                                 "token": "t"}},
    {"discovery": "mcast", "name": "c1",
     "mcast": {"addr": "239.192.0.5", "ports": [45373, 45374], "ttl": 2,
               "loop": False, "iface": "127.0.0.1"}},
]


def _fields(d) -> dict:
    return {k: v for k, v in vars(d).items()
            if k not in ("_resolver", "_responders")}


@pytest.mark.parametrize("k", range(len(CONFIGS)))
def test_from_config_equals_reference(k):
    ref = jd.from_config(CONFIGS[k])
    port = td.from_config(CONFIGS[k])
    assert type(port).__name__ == type(ref).__name__
    assert port.strategy == ref.strategy
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("conf", [{"discovery": "carrier-pigeon"},
                                  {"discovery": "mcast",
                                   "mcast": {"ports": []}}])
def test_from_config_refuses_alike(conf):
    for mod in MODS:
        with pytest.raises(ValueError):
            mod.from_config(conf)


def test_mcast_wire_bytes_equal_reference():
    ref = jd.McastDiscovery(cluster_name="mc1")
    port = td.McastDiscovery(cluster_name="mc1")
    assert port._probe() == ref._probe()
    assert port._reply_prefix() == ref._reply_prefix()


def test_dns_autocluster_three_port_nodes():
    async def go():
        clusters = []
        for i in range(3):
            n = TNode(device="cpu", name=f"d{i}@127.0.0.1")
            cn = TClusterNode(n, port=0, heartbeat_s=0.05)
            await cn.start()
            clusters.append(cn)
        addrs = [cn.address for cn in clusters]
        try:
            for cn in clusters:
                await td.autocluster(cn, td.StaticDiscovery(addrs))
            await asyncio.sleep(0.3)
            for cn in clusters:
                assert len(cn.membership.running_nodes()) == 3
        finally:
            for cn in clusters:
                await cn.stop()
    run(go())


def test_etcd_autocluster_registers_alike():
    """Both packages publish the local node under a TTL lease before
    discovering: the same key, the same value, the same lease."""
    async def go(mod, Node, Cluster, kw):
        kv: dict = {}

        def etcd(line, body):
            req = json.loads(body) if body else {}
            if "/v3/lease/grant" in line:
                return {"ID": "777"}
            if "/v3/kv/put" in line:
                kv[base64.b64decode(req["key"]).decode()] = \
                    (req["value"], req.get("lease"))
                return {}
            if "/v3/kv/range" in line:
                return {"kvs": [{"key": k, "value": v[0]}
                                for k, v in kv.items()]}
            return {}
        cap = []
        srv = await _http_json_server(etcd, cap)
        eport = srv.sockets[0].getsockname()[1]
        n = Node({"cluster": {"discovery": "etcd", "name": "c9",
                              "etcd": {"server":
                                       f"http://127.0.0.1:{eport}"}}},
                 name="e0@127.0.0.1", **kw)
        cn = Cluster(n, port=0, heartbeat_s=0.05)
        await cn.start()
        try:
            joined = await mod.autocluster(cn)
            host, port = cn.address
            assert {k: (base64.b64decode(v).decode(), lease)
                    for k, (v, lease) in kv.items()} == \
                {"emqxcl/c9/nodes/e0@127.0.0.1": (f"{host}:{port}", "777")}
            assert cn._discovery_task is not None
        finally:
            await cn.stop()
            srv.close()
        assert cn._discovery_task is None
        return joined, [c[0] for c in cap]
    ref = run(go(jd, JNode, JClusterNode, {"use_device": False}))
    port = run(go(td, TNode, TClusterNode, {"device": "cpu"}))
    assert port == ref


def test_port_node_autoclusters_to_a_reference_seed():
    """A port node's config-driven static autocluster joins a reference
    seed: the two packages form one cluster."""
    async def go():
        seed = JClusterNode(JNode(use_device=False, name="s0@127.0.0.1"),
                            port=0, heartbeat_s=0.05)
        await seed.start()
        host, port = seed.address
        n1 = TNode({"cluster": {"discovery": "static",
                                "nodes": [f"{host}:{port}"]}},
                   device="cpu", name="s1@127.0.0.1")
        cn1 = TClusterNode(n1, port=0, heartbeat_s=0.05)
        await cn1.start()
        try:
            assert await td.autocluster(cn1) == 1
            await asyncio.sleep(0.2)
            assert seed.membership.running_nodes() == \
                cn1.membership.running_nodes() == \
                ["s0@127.0.0.1", "s1@127.0.0.1"]
        finally:
            await cn1.stop()
            await seed.stop()
    run(go())


def _can_mcast() -> bool:
    async def go():
        d = td.McastDiscovery(port=45380, cluster_name="probe-check",
                              wait_s=0.05)
        try:
            await d.start_responder("127.0.0.1", 1)
        except OSError:
            return False
        d.stop_responder()
        return True
    return run(go())


def test_mcast_probe_finds_responders_of_both_packages():
    if not _can_mcast():
        pytest.skip("no multicast-capable interface")

    async def go():
        r1 = jd.McastDiscovery(port=45381, cluster_name="mc1", wait_s=0.3)
        r2 = td.McastDiscovery(port=45381, cluster_name="mc1", wait_s=0.3)
        other = td.McastDiscovery(port=45381, cluster_name="OTHER",
                                  wait_s=0.3)
        await r1.start_responder("10.0.0.1", 4370)
        await r2.start_responder("10.0.0.2", 4371)
        await other.start_responder("10.9.9.9", 9999)
        try:
            seeds = await td.McastDiscovery(port=45381, cluster_name="mc1",
                                            wait_s=0.5).discover()
        finally:
            for r in (r1, r2, other):
                r.stop_responder()
        assert ("10.0.0.1", 4370) in seeds and ("10.0.0.2", 4371) in seeds
        assert ("10.9.9.9", 9999) not in seeds
    run(go())
