"""Port vs JAX reference: the cluster layer.

Each scenario of the reference's ``tests/test_cluster.py`` runs twice:
on a cluster of reference nodes (``Node(use_device=False)``) and on a
cluster of port nodes (``Node(device="cpu")``, the device engine built).
Every run must pass the reference's own assertions, and the two runs
must give equal observations: the deliveries of every capture in order,
each node's replicated tables (routes, shared members, registry), its
registry lookups and its ``info()`` with the ports left out. The shared
strategies are the deterministic ones (round robin, sticky, hash of the
clientid).

Beside the twins: the device-shared case on the device engines of both
packages (remote members captured as device sids of ``1 << 30`` and up
and picked on the device; no remote sid reaches a local delivery), the
cluster gates of the vectorized consume, the frame codec byte for byte,
and a mixed cluster of one reference node and one port node that
replicates, forwards, picks across the two and takes sessions over in
both directions.
"""

import asyncio
import random
import time

import pytest

from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.broker.session import Session as JSession
from emqx_tpu.broker.session import SessionConf as JSessionConf
from emqx_tpu.cluster import ClusterNode as JClusterNode
from emqx_tpu.cluster import cluster as jcluster
from emqx_tpu.cluster import rpc as jrpc
from emqx_tpu.mgmt import Mgmt as JMgmt
from emqx_tpu_torch.broker import device_engine as tde
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.broker.session import Session as TSession
from emqx_tpu_torch.broker.session import SessionConf as TSessionConf
from emqx_tpu_torch.cluster import ClusterNode as TClusterNode
from emqx_tpu_torch.cluster import cluster as tcluster
from emqx_tpu_torch.cluster import rpc as trpc
from emqx_tpu_torch.mgmt import Mgmt as TMgmt

HB = 0.05            # heartbeats of the reference's own cluster tests


class Pkg:
    """One package's cluster surface, so a scenario runs on either."""

    def __init__(self, which: str):
        self.which = which
        if which == "ref":
            self.ClusterNode, self.rpc = JClusterNode, jrpc
            self.make, self.Mgmt = jmake, JMgmt
            self.Session, self.SessionConf = JSession, JSessionConf
        else:
            self.ClusterNode, self.rpc = TClusterNode, trpc
            self.make, self.Mgmt = tmake, TMgmt
            self.Session, self.SessionConf = TSession, TSessionConf

    def node(self, name: str, strategy: str = "round_robin"):
        conf = {"broker": {"shared_subscription_strategy": strategy}}
        if self.which == "ref":
            return JNode(conf, use_device=False, name=name)
        return TNode(conf, device="cpu", name=name)


class Capture:
    def __init__(self):
        self.msgs = []

    def deliver(self, topic_filter, msg):
        self.msgs.append((topic_filter, msg))
        return True

    def seen(self):
        """Deliveries per topic in arrival order: forwards ride one rpc
        channel per topic, so order holds per topic, not across topics."""
        out: dict = {}
        for f, m in self.msgs:
            out.setdefault(m.topic, []).append((f, m.payload, m.qos))
        return sorted(out.items())


def twin(monkeypatch, scenario, strategy, limit=60):
    """The scenario on a reference cluster, then on a port cluster. Each
    cluster module draws its picks (sticky's first, the failover order)
    from its own generator, seeded alike, so the draws do not depend on
    the rpc plane's random channel picks."""
    out = []
    for which, mod in (("ref", jcluster), ("port", tcluster)):
        monkeypatch.setattr(mod, "random", random.Random(7))
        out.append(run(scenario(Pkg(which), strategy), limit))
    return out


def run(coro, limit=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, limit))
    finally:
        loop.close()


async def make_cluster(P: Pkg, n=2, strategy="round_robin", hb=HB):
    nodes, clusters = [], []
    for i in range(n):
        node = P.node(f"n{i}@127.0.0.1", strategy)
        cn = P.ClusterNode(node, port=0, heartbeat_s=hb)
        await cn.start()
        nodes.append(node)
        clusters.append(cn)
    for cn in clusters[1:]:
        await cn.join(*clusters[0].address)
    return nodes, clusters


async def teardown(clusters):
    for cn in clusters:
        try:
            await cn.stop()
        except Exception:
            pass


async def settle(clusters, t=0.15):
    for cn in clusters:
        await cn.flush()
    await asyncio.sleep(t)


async def wait_for(pred, limit=4.0, step=0.05):
    t0 = time.monotonic()
    while time.monotonic() - t0 < limit:
        if pred():
            return True
        await asyncio.sleep(step)
    return pred()


def tables(cn) -> dict:
    """A node's replicated tables: key -> origin -> values."""
    return {name: {repr(k): {o: sorted(map(repr, v))
                             for o, v in sorted(per.items())}
                   for k, per in sorted(t.rows.items(), key=repr)}
            for name, t in sorted(cn.store.tables.items())}


def info(cn) -> dict:
    i = dict(cn.info())
    i.pop("address")
    i["members"] = {n: m["status"] for n, m in i["members"].items()}
    return i


def state(clusters) -> dict:
    return {cn.rpc.node: {"tables": tables(cn), "info": info(cn)}
            for cn in clusters}


# ---- scenarios: each returns its observation --------------------------

async def sc_route_replication_and_forwarding(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        b0, b1 = nodes[0].broker, nodes[1].broker
        cap = Capture()
        sid = b0.register(cap, "c-sub")
        b0.subscribe(sid, "sensors/+/temp")
        b0.subscribe(sid, "exact/topic")
        await settle(clusters)
        assert "sensors/+/temp" in b1.router.topics()
        assert "exact/topic" in b1.router.topics()
        n = b1.publish(P.make("pub", 1, "sensors/9/temp", b"21.5"))
        assert n == 1
        await settle(clusters)
        assert [m.payload for _, m in cap.msgs] == [b"21.5"]
        mid = state(clusters)
        b0.unsubscribe(sid, "sensors/+/temp")
        await settle(clusters)
        assert "sensors/+/temp" not in b1.router.topics()
        assert b1.publish(P.make("pub", 0, "sensors/9/temp", b"x")) == 0
        return {"cap": cap.seen(), "mid": mid, "end": state(clusters),
                "topics": [n.broker.router.topics() for n in nodes],
                "forward": [n.metrics.val("messages.forward")
                            for n in nodes]}
    finally:
        await teardown(clusters)


async def sc_local_and_remote_both_deliver(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        b0, b1 = nodes[0].broker, nodes[1].broker
        c0, c1 = Capture(), Capture()
        b0.subscribe(b0.register(c0, "s0"), "t/#")
        b1.subscribe(b1.register(c1, "s1"), "t/#")
        await settle(clusters)
        for i in range(8):
            b1.publish(P.make("pub", i % 2, f"t/x{i % 3}", b"hello%d" % i))
        await settle(clusters)
        assert len(c0.msgs) == 8 and len(c1.msgs) == 8
        return {"c0": c0.seen(), "c1": c1.seen(), "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_shared_cluster_wide(P, strategy):
    nodes, clusters = await make_cluster(P, strategy=strategy)
    try:
        b0, b1 = nodes[0].broker, nodes[1].broker
        c0, c1, c2 = Capture(), Capture(), Capture()
        b0.subscribe(b0.register(c0, "m0"), "$share/g/jobs/+")
        b1.subscribe(b1.register(c1, "m1"), "$share/g/jobs/+")
        b1.subscribe(b1.register(c2, "m2"), "$share/g/jobs/+")
        await settle(clusters)
        N = 12
        for i in range(N):
            src = (b0, b1)[i % 3 == 2]
            src.publish(P.make(f"pub{i % 4}", 0, f"jobs/r{i}", b"%d" % i))
        await settle(clusters)
        assert len(c0.msgs) + len(c1.msgs) + len(c2.msgs) == N
        return {"c": [c.seen() for c in (c0, c1, c2)],
                "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_nodedown_purges_remote_routes(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        b0, b1 = nodes[0].broker, nodes[1].broker
        b1.subscribe(b1.register(Capture(), "away"), "gone/+")
        b1.subscribe(b1.register(Capture(), "away2"), "$share/g/gone/x")
        await settle(clusters)
        assert "gone/+" in b0.router.topics()
        before = state(clusters[:1])
        await clusters[1].stop()
        assert await wait_for(
            lambda: not clusters[0].membership.is_running("n1@127.0.0.1"))
        assert await wait_for(lambda: "gone/+" not in b0.router.topics())
        assert "gone/x" not in b0.router.topics()
        return {"before": before, "after": state(clusters[:1]),
                "topics": b0.router.topics()}
    finally:
        await teardown(clusters)


async def sc_cross_node_session_takeover(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        cm0, cm1 = nodes[0].cm, nodes[1].cm
        s = P.Session("dev-1", P.SessionConf(session_expiry_interval=300))
        s.subscribe("a/+", {"qos": 1})
        s.enqueue([(P.make("x", 1, "a/b", b"queued"), {"qos": 1})])
        cm0.park_session("dev-1", s)
        await settle(clusters)
        reg = [cn.registry_lookup("dev-1") for cn in clusters]
        sess, present = await cm1.open_session(
            False, "dev-1", P.SessionConf(), new_channel=object())
        assert present
        assert sess.subscriptions == {"a/+": {"qos": 1}}
        assert [m.payload for m in sess.mqueue.to_list()] == [b"queued"]
        assert cm0.parked_count() == 0
        await settle(clusters)
        return {"reg": reg, "subs": sess.subscriptions,
                "queued": [(m.topic, m.payload, m.qos)
                           for m in sess.mqueue.to_list()],
                "after": [cn.registry_lookup("dev-1") for cn in clusters],
                "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_clean_start_discards_remote_session(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        cm0, cm1 = nodes[0].cm, nodes[1].cm
        s = P.Session("dev-2", P.SessionConf(session_expiry_interval=300))
        cm0.park_session("dev-2", s)
        await settle(clusters)
        sess, present = await cm1.open_session(
            True, "dev-2", P.SessionConf(), new_channel=object())
        assert not present
        await settle(clusters)
        assert cm0.parked_count() == 0
        return {"state": state(clusters),
                "reg": [cn.registry_lookup("dev-2") for cn in clusters]}
    finally:
        await teardown(clusters)


async def sc_kick_session_global(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        kicked = []

        class Chan:
            async def kick(self, reason):
                kicked.append(reason)

            async def takeover_begin(self):
                return None

            async def takeover_end(self):
                return []

        nodes[0].cm.register_channel("k-1", Chan())
        await settle(clusters)
        assert await clusters[1].kick_session_global("k-1")
        assert kicked == ["kicked"]
        assert not await clusters[1].kick_session_global("nobody")
        await settle(clusters)
        return {"kicked": kicked, "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_three_node_gossip_join(P, strategy):
    nodes, clusters = await make_cluster(P, 3)
    try:
        await asyncio.sleep(0.2)
        for cn in clusters:
            assert len(cn.membership.running_nodes()) == 3
        b2 = nodes[2].broker
        b2.subscribe(b2.register(Capture(), "x"), "tri/+/route")
        await settle(clusters)
        assert "tri/+/route" in nodes[0].broker.router.topics()
        assert "tri/+/route" in nodes[1].broker.router.topics()
        return {"state": state(clusters),
                "running": [cn.membership.running_nodes()
                            for cn in clusters]}
    finally:
        await teardown(clusters)


async def sc_lock_mutual_exclusion(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        order = []

        async def critical(cn, tag):
            async with cn.lock("same-client"):
                order.append(f"{tag}-in")
                await asyncio.sleep(0.05)
                order.append(f"{tag}-out")

        await asyncio.gather(critical(clusters[0], "a"),
                             critical(clusters[1], "b"))
        assert order[0][0] == order[1][0] and order[2][0] == order[3][0]
        return {"pairs": sorted([order[0][0], order[2][0]]),
                "targets": [cn._lock_targets() for cn in clusters]}
    finally:
        await teardown(clusters)


async def sc_qos2_pubrel_session_survives_takeover(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        cm0, cm1 = nodes[0].cm, nodes[1].cm
        s = P.Session("q2", P.SessionConf(session_expiry_interval=300))
        s.enqueue([(P.make("x", 2, "a/b", b"m1"), {"qos": 2})])
        [(pid, _m)] = s.dequeue()
        s.pubrec(pid)
        cm0.park_session("q2", s)
        await settle(clusters)
        sess, present = await cm1.open_session(
            False, "q2", P.SessionConf(), new_channel=object())
        assert present
        entry = sess.inflight.lookup(pid)
        assert entry[0] == "pubrel" and entry[1].payload == b"m1"
        return {"pid": pid, "phase": entry[0], "payload": entry[1].payload}
    finally:
        await teardown(clusters)


async def sc_lock_lease_expires(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        cn = clusters[0]
        cn.LOCK_LEASE_S = 0.1
        guard = cn.lock("crashy")
        await guard.__aenter__()
        held = list(guard.held)
        await asyncio.sleep(0.15)
        async with cn.lock("crashy") as g2:
            again = list(g2.held)
        return {"held": held, "again": again}
    finally:
        await teardown(clusters)


async def sc_anti_entropy_heals_lost_casts(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        c0, c1 = clusters
        c0.store._seq += 1
        c0.store.table("route")._apply("add", "lost/+", "sub", c0.rpc.node)
        nodes[0].broker.subscribe(
            nodes[0].broker.register(Capture(), "x"), "after/+")
        await settle(clusters)
        assert "after/+" not in nodes[1].broker.router.topics()
        assert await wait_for(
            lambda: "after/+" in nodes[1].broker.router.topics())
        assert "lost/+" in c1.store.table("route").keys()
        return {"state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_partition_heals_on_mutual_down(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        c0, c1 = clusters
        n1 = c1.rpc.node
        events = []
        c0.membership.monitor(lambda e, n: events.append((e, n)))
        c0.membership.members[n1]["status"] = "down"
        c1.membership.members[c0.rpc.node]["status"] = "down"
        assert await wait_for(
            lambda: c0.membership.is_running(n1)
            and c1.membership.is_running(c0.rpc.node))
        return {"events": events[:1], "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_lock_contention_fails_closed(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        cn0, cn1 = clusters
        g0 = cn0.lock("cid-x")
        await g0.__aenter__()
        t0 = asyncio.get_running_loop().time()
        task = asyncio.ensure_future(cn1.lock("cid-x").__aenter__())
        await asyncio.sleep(0.2)
        assert not task.done(), "contended lock must not be granted"
        await g0.__aexit__(None, None, None)
        guard = await task
        assert asyncio.get_running_loop().time() - t0 >= 0.2
        held = list(guard.held)
        await guard.__aexit__(None, None, None)
        return {"held": held}
    finally:
        await teardown(clusters)


async def sc_kick_discard_retire_registry(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        class Chan:
            async def kick(self, reason):
                pass

        nodes[0].cm.register_channel("gone-1", Chan())
        await settle(clusters)
        first = clusters[1].registry_lookup("gone-1")
        assert first == ["n0@127.0.0.1"]
        await nodes[0].cm.kick_session("gone-1")
        await settle(clusters)
        assert clusters[1].registry_lookup("gone-1") == []
        return {"first": first, "state": state(clusters)}
    finally:
        await teardown(clusters)


async def sc_heartbeat_view_merge_heals_asymmetry(P, strategy):
    nodes, clusters = await make_cluster(P, 3)
    try:
        victim = clusters[2].rpc.node
        clusters[0].membership.members.pop(victim, None)
        assert await wait_for(
            lambda: victim in clusters[0].membership.members)
        await asyncio.sleep(0.1)
        return {"running": [cn.membership.running_nodes()
                            for cn in clusters]}
    finally:
        await teardown(clusters)


async def sc_rejoin_new_address_reachable(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        await clusters[1].stop()
        await asyncio.sleep(0.3)
        node1b = P.node("n1@127.0.0.1")
        cn1b = P.ClusterNode(node1b, port=0, heartbeat_s=HB)
        await cn1b.start()
        assert cn1b.address != clusters[1].address
        await cn1b.join(*clusters[0].address)
        clusters.append(cn1b)
        await settle(clusters, 0.3)
        cap = Capture()
        node1b.broker.subscribe(node1b.broker.register(cap, "c1"),
                                "rejoin/t")
        await settle(clusters, 0.3)
        await nodes[0].broker.publish_async(
            P.make("pub", 0, "rejoin/t", b"hi"))
        assert await wait_for(lambda: cap.msgs, 1.0)
        return {"cap": cap.seen(),
                "state": state([clusters[0], cn1b])}
    finally:
        await teardown(clusters)


async def sc_fast_rejoin_before_nodedown(P, strategy):
    nodes, clusters = await make_cluster(P)
    for cn in clusters:
        cn.membership.heartbeat_s = 5.0
    try:
        await settle(clusters, 0.1)
        await clusters[1].stop()
        node1b = P.node("n1@127.0.0.1")
        cn1b = P.ClusterNode(node1b, port=0, heartbeat_s=5.0)
        await cn1b.start()
        await cn1b.join(*clusters[0].address)
        clusters.append(cn1b)
        await settle(clusters, 0.1)
        assert clusters[0].membership.is_running("n1@127.0.0.1")
        cap = Capture()
        node1b.broker.subscribe(node1b.broker.register(cap, "c1"),
                                "fastrejoin/t")
        await settle(clusters, 0.2)
        assert "fastrejoin/t" in nodes[0].broker.router.topics()
        await nodes[0].broker.publish_async(
            P.make("pub", 0, "fastrejoin/t", b"hi"))
        assert await wait_for(lambda: cap.msgs, 1.0)
        return {"cap": cap.seen()}
    finally:
        await teardown(clusters)


async def sc_fast_rejoin_purges_ghost_routes(P, strategy):
    nodes, clusters = await make_cluster(P)
    for cn in clusters:
        cn.membership.heartbeat_s = 5.0
    try:
        nodes[1].broker.subscribe(
            nodes[1].broker.register(Capture(), "g"), "ghost/t")
        await settle(clusters, 0.2)
        assert "ghost/t" in nodes[0].broker.router.topics()
        await clusters[1].stop()
        node1b = P.node("n1@127.0.0.1")
        cn1b = P.ClusterNode(node1b, port=0, heartbeat_s=5.0)
        await cn1b.start()
        await cn1b.join(*clusters[0].address)
        clusters.append(cn1b)
        assert await wait_for(
            lambda: "ghost/t" not in nodes[0].broker.router.topics(), 2.0)
        return {"state": tables(clusters[0])}
    finally:
        await teardown(clusters)


async def sc_mgmt_cluster_fanout(P, strategy):
    nodes, clusters = await make_cluster(P)
    try:
        m0 = P.Mgmt(nodes[0], clusters[0])
        P.Mgmt(nodes[1], clusters[1])
        nodes[1].cm.register_channel("remote-c", object(),
                                     {"username": "ru"})
        b1 = nodes[1].broker
        b1.subscribe(b1.register(Capture(), "remote-c"), "fan/+")
        await settle(clusters)
        infos = await m0.list_nodes()
        assert {i["node"] for i in infos} == {"n0@127.0.0.1",
                                             "n1@127.0.0.1"}
        clients = await m0.list_clients()
        assert any(c["clientid"] == "remote-c"
                   and c["node"] == "n1@127.0.0.1" for c in clients)
        subs = await m0.list_subscriptions()
        routes = m0.list_routes()
        assert any(r["topic"] == "fan/+"
                   and r["node"] == ["n1@127.0.0.1"] for r in routes)
        per_node = await m0.metrics()
        agg = await m0.stats(aggregate=True)
        return {"nodes": sorted(i["node"] for i in infos),
                "clients": sorted((c["clientid"], c["node"])
                                  for c in clients),
                "subs": sorted((s["topic"], s["node"]) for s in subs),
                "routes": routes,
                "metric_nodes": sorted(m["node"] for m in per_node),
                # the port's device engine adds its pipeline gauges
                "agg": {k: v for k, v in agg.items()
                        if not k.startswith("pipeline.")}}
    finally:
        await teardown(clusters)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_route_replication_and_forwarding, sc_local_and_remote_both_deliver,
    sc_nodedown_purges_remote_routes, sc_cross_node_session_takeover,
    sc_clean_start_discards_remote_session, sc_kick_session_global,
    sc_three_node_gossip_join, sc_lock_mutual_exclusion,
    sc_qos2_pubrel_session_survives_takeover, sc_lock_lease_expires,
    sc_anti_entropy_heals_lost_casts, sc_partition_heals_on_mutual_down,
    sc_lock_contention_fails_closed, sc_kick_discard_retire_registry,
    sc_heartbeat_view_merge_heals_asymmetry,
    sc_rejoin_new_address_reachable, sc_fast_rejoin_before_nodedown,
    sc_fast_rejoin_purges_ghost_routes, sc_mgmt_cluster_fanout)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(monkeypatch, name):
    ref, port = twin(monkeypatch, SCENARIOS[name], "round_robin")
    assert port == ref


@pytest.mark.parametrize("strategy", ["round_robin", "sticky",
                                      "hash_clientid"])
def test_shared_cluster_wide_equals_reference(monkeypatch, strategy):
    ref, port = twin(monkeypatch, sc_shared_cluster_wide, strategy)
    assert port == ref


# ---- rpc: the frame codec and the failure bounds ----------------------

FRAMES = [
    {"t": "hello", "node": "a@x", "cookie": "emqxsecretcookie"},
    {"t": "call", "id": 7, "fn": "broker.dispatch_fwd",
     "args": ["a/b", ["a/+"], {"payload": b"\x00\xffbin", "qos": 1}]},
    {"t": "reply", "id": 7, "ok": True, "val": {"s": {3, 1, 2}}},
    {"t": "cast", "fn": "store.op_batch",
     "args": [[["route", "x/#", "sub", 1]], (1, 2), b""]},
]


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_frame_bytes_equal_reference(k):
    msg = FRAMES[k]
    data = trpc.encode_frame(msg)
    assert data == jrpc.encode_frame(msg)

    async def read(mod, b):
        r = asyncio.StreamReader()
        r.feed_data(b)
        r.feed_eof()
        return await mod.read_frame(r)

    assert run(read(trpc, data)) == run(read(jrpc, data))


def test_rpc_call_cast_roundtrip():
    async def go():
        a = trpc.RpcNode("a@x", port=0)
        b = trpc.RpcNode("b@x", port=0)
        got = []

        async def echo(x):
            return {"echo": x}

        async def note(x):
            got.append(x)

        b.register("echo", echo)
        b.register("note", note)
        await a.start()
        await b.start()
        a.add_peer("b@x", *b.address)
        try:
            assert (await a.call("b@x", "echo", [b"bytes\x00"]))["echo"] \
                == b"bytes\x00"
            await a.cast("b@x", "note", [42], key="t/1")
            await asyncio.sleep(0.05)
            assert got == [42]
            with pytest.raises(trpc.RpcError):
                await a.call("b@x", "missing_fn", [])
            res = await a.multicall(["b@x"], "echo", [1])
            assert res["b@x"]["echo"] == 1
        finally:
            await a.stop()
            await b.stop()
    run(go())


def test_cast_to_frozen_peer_is_bounded():
    async def go():
        async def _serve(reader, writer):
            await trpc.read_frame(reader)
            writer.write(trpc.encode_frame({"t": "hello_ok",
                                            "node": "frozen"}))
            await writer.drain()
            while True:
                await asyncio.sleep(3600)

        server = await asyncio.start_server(_serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        ch = trpc._Channel("127.0.0.1", port, "me@x", "emqxsecretcookie")
        old = trpc.CONNECT_TIMEOUT
        trpc.CONNECT_TIMEOUT = 1.0
        try:
            t0 = time.time()
            with pytest.raises(trpc.RpcError):
                for _ in range(200):
                    await ch.cast("noop", ["x" * (1 << 20)])
            assert time.time() - t0 < 30
            assert not ch.alive
        finally:
            trpc.CONNECT_TIMEOUT = old
            await ch.close()
            server.close()
    run(go())


def test_rpc_half_open_channel_fails_fast():
    async def go():
        a = trpc.RpcNode("a@x", port=0)
        b = trpc.RpcNode("b@x", port=0)

        async def echo(x):
            return {"echo": x}

        b.register("echo", echo)
        await a.start()
        await b.start()
        try:
            a.add_peer("b@x", *b.address)
            assert (await a.call("b@x", "echo", [1], key="k"))["echo"] == 1
            await b.stop()
            await asyncio.sleep(0.1)
            t0 = time.time()
            with pytest.raises(trpc.RpcError):
                await a.call("b@x", "echo", [2], key="k", timeout=30)
            assert time.time() - t0 < 2
        finally:
            await a.stop()
            await b.stop()
    run(go())


# ---- the device engines under a cluster -------------------------------

async def sc_device_shared(P, strategy):
    """The reference's device-shared case: a locally homed group picks on
    the device; a remote member joins (host pick until the rebuild); after
    the rebuild the mixed group picks on the device, remote members
    forwarded."""
    nodes, clusters = [], []
    for i in range(2):
        conf = {"broker": {"shared_subscription_strategy": strategy}}
        if P.which == "ref":
            node = JNode(conf, use_device=(i == 0), name=f"d{i}@127.0.0.1")
        else:
            if i:
                conf["broker"]["device_route"] = False
            node = TNode(conf, device="cpu", name=f"d{i}@127.0.0.1")
        cn = P.ClusterNode(node, port=0, heartbeat_s=HB)
        await cn.start()
        nodes.append(node)
        clusters.append(cn)
    await clusters[1].join(*clusters[0].address)
    obs = {}
    try:
        b0, b1 = nodes[0].broker, nodes[1].broker
        eng = nodes[0].device_engine
        assert eng is not None and eng.device_shared_active()
        local_sids = set()
        if P.which == "port":
            deliver = b0._deliver

            def guarded(sid, *a, **kw):
                assert 0 <= sid < tde._REMOTE_SID_BASE, sid
                local_sids.add(sid)
                return deliver(sid, *a, **kw)
            b0._deliver = guarded
        la, lb = Capture(), Capture()
        b0.subscribe(b0.register(la, "la"), "$share/loc/work/+")
        b0.subscribe(b0.register(lb, "lb"), "$share/loc/work/+")
        await settle(clusters)
        counts = eng.route_batch([P.make("p", 0, f"work/{i}", b"x")
                                  for i in range(8)])
        assert counts == [1] * 8
        assert len(la.msgs) + len(lb.msgs) == 8
        assert nodes[0].metrics.val("messages.routed.device") >= 8
        rc = Capture()
        b1.subscribe(b1.register(rc, "rc"), "$share/loc/work/+")
        await settle(clusters)
        origins = {o for o, _s in clusters[0]._members(b0, "work/+",
                                                        "loc")}
        assert origins == {"d0@127.0.0.1", "d1@127.0.0.1"}
        obs["host"] = eng.route_batch([P.make(f"q{i}", 0, f"work/x{i}",
                                              b"y") for i in range(9)])
        await settle(clusters)
        eng.rebuild()
        assert not eng.dirty_slots
        remote = list(eng._built.remote_members)
        assert remote == [("d1@127.0.0.1", 0)]
        obs["dev"] = eng.route_batch([P.make(f"q{i}", 0, f"work/z{i}",
                                             b"w") for i in range(9)])
        await settle(clusters)
        assert obs["dev"] == [1] * 9
        assert sum(len(c.msgs) for c in (la, lb, rc)) == 8 + 9 + 9
        if strategy != "sticky":     # sticky keeps its first member
            assert len(rc.msgs) >= 1
            assert nodes[0].metrics.val(
                "messages.routed.device.remote_shared") >= 1
        obs.update(remote=remote, c=[c.seen() for c in (la, lb, rc)],
                   remote_shared=nodes[0].metrics.val(
                       "messages.routed.device.remote_shared"))
        if P.which == "port":
            assert local_sids and max(local_sids) < tde._REMOTE_SID_BASE
        return obs
    finally:
        await teardown(clusters)


@pytest.mark.parametrize("strategy", ["round_robin", "sticky",
                                      "hash_clientid"])
def test_device_shared_under_cluster_equals_reference(monkeypatch,
                                                     strategy):
    ref, port = twin(monkeypatch, sc_device_shared, strategy, 120)
    assert port == ref


def test_remote_members_are_device_sids_on_the_member_table():
    """The built snapshot's member table holds the remote member as the
    device sid 1 << 30 (its remote_members index 0); the vectorized
    consume gates are closed under a cluster."""
    async def go():
        nodes, clusters = await make_cluster(Pkg("port"))
        try:
            b0, b1 = nodes[0].broker, nodes[1].broker
            b0.subscribe(b0.register(Capture(), "l"), "$share/g/m/+")
            b1.subscribe(b1.register(Capture(), "r"), "$share/g/m/+")
            await settle(clusters)
            eng = nodes[0].device_engine
            eng.rebuild()
            cap = tde.capture_shared(b0, "m/+")
            members, _cursor = cap["g"]
            assert members[1] == (("n1@127.0.0.1", 0), None)
            assert eng._built.remote_members == [("n1@127.0.0.1", 0)]
            rows = eng._tables.subs.shared_row.tolist()
            assert tde._REMOTE_SID_BASE in rows
            assert 0 in rows
            assert eng._consume_batch_fast([1, 2], None, None, None, None,
                                           None, None, True, None) \
                == [None, None]
            assert eng._consume_batch_fast_csr(
                [1], None, None, None, None, None, True, None) == [None]
        finally:
            await teardown(clusters)
    run(go())


def test_remote_leave_refreshes_an_incremental_capture():
    """A remote shared_leave reaches the engine's `_touched` set: the next
    incremental capture drops the departed remote member."""
    async def go():
        nodes, clusters = await make_cluster(Pkg("port"))
        try:
            b0, b1 = nodes[0].broker, nodes[1].broker
            b0.subscribe(b0.register(Capture(), "l"), "$share/g/m/+")
            sid = b1.register(Capture(), "r")
            b1.subscribe(sid, "$share/g/m/+")
            await settle(clusters)
            eng = nodes[0].device_engine
            eng.rebuild()
            assert eng._built.remote_members == [("n1@127.0.0.1", 0)]
            eng._touched.clear()
            b1.unsubscribe(sid, "$share/g/m/+")
            await settle(clusters)
            assert "m/+" in eng._touched
            cap = eng._capture_state_incremental()
            members, _c = cap[3]["m/+"]["g"]
            assert [m for m, _o in members] == [0]
        finally:
            await teardown(clusters)
    run(go())


# ---- one reference node and one port node in one cluster --------------

def test_mixed_cluster_replicates_forwards_and_takes_over():
    async def go():
        jn = JNode({}, use_device=False, name="ref@127.0.0.1")
        tn = TNode({}, device="cpu", name="port@127.0.0.1")
        jc = JClusterNode(jn, port=0, heartbeat_s=HB)
        tc = TClusterNode(tn, port=0, heartbeat_s=HB)
        await jc.start()
        await tc.start()
        clusters = [jc, tc]
        await tc.join(*jc.address)
        try:
            jb, tb = jn.broker, tn.broker
            jcap, tcap = Capture(), Capture()
            jb.subscribe(jb.register(jcap, "jsub"), "mix/ref/#")
            tb.subscribe(tb.register(tcap, "tsub"), "mix/port/+")
            js, ts = Capture(), Capture()
            jb.subscribe(jb.register(js, "jsh"), "$share/g/mix/sh")
            tb.subscribe(tb.register(ts, "tsh"), "$share/g/mix/sh")
            await settle(clusters)
            assert "mix/port/+" in jb.router.topics()
            assert "mix/ref/#" in tb.router.topics()
            assert tables(jc) == tables(tc)
            # forward both ways
            jb.publish(jmake("a", 1, "mix/port/1", b"r2p"))
            tb.publish(tmake("b", 1, "mix/ref/x/y", b"p2r"))
            for i in range(6):
                (jb, tb)[i % 2].publish(
                    (jmake, tmake)[i % 2]("c", 0, "mix/sh", b"%d" % i))
            await settle(clusters)
            assert tcap.seen() == [("mix/port/1", [("mix/port/+", b"r2p", 1)])]
            assert jcap.seen() == [("mix/ref/x/y",
                                    [("mix/ref/#", b"p2r", 1)])]
            assert len(js.msgs) + len(ts.msgs) == 6
            assert js.msgs and ts.msgs
            # session takeover, reference -> port and port -> reference
            s = JSession("mx-1", JSessionConf(session_expiry_interval=300))
            s.subscribe("mix/+", {"qos": 1})
            s.enqueue([(jmake("x", 1, "mix/q", b"queued"), {"qos": 1})])
            jn.cm.park_session("mx-1", s)
            s2 = TSession("mx-2", TSessionConf(session_expiry_interval=300))
            s2.subscribe("mix/2", {"qos": 2})
            tn.cm.park_session("mx-2", s2)
            await settle(clusters)
            sess, present = await tn.cm.open_session(
                False, "mx-1", TSessionConf(), new_channel=object())
            assert present and sess.subscriptions == {"mix/+": {"qos": 1}}
            assert [m.payload for m in sess.mqueue.to_list()] == [b"queued"]
            assert jn.cm.parked_count() == 0
            sess2, present2 = await jn.cm.open_session(
                False, "mx-2", JSessionConf(), new_channel=object())
            assert present2 and sess2.subscriptions == {"mix/2": {"qos": 2}}
            assert tn.cm.parked_count() == 0
            assert info(jc)["members"] == info(tc)["members"]
        finally:
            await teardown(clusters)
    run(go())
