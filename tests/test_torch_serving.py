"""Port vs JAX reference: the mesh serving under Node.

The reference's ``ShardedRouteServer`` runs on the conftest's 8 virtual
CPU devices (``Node({"broker": {"multichip": ...}})``); the port's runs
on ``device="cpu"`` with the same shards (dp=2 x route=4), the same
seeded subscriptions and the same publishes. Required, as the twins of
``tests/test_multichip_serving.py`` and ``tests/test_exchange.py``
(:108-339): equal per-message counts, every session's deliveries in the
same order, the same host cursors after round robin, and the same
exchange/gather decisions (exchange windows and gathers by reason).
Each scenario runs the same operations on both nodes; nothing
per-process (snapshot ids, generations) is compared. The mesh fault
(``tests/test_supervise.py:360``) is driven with a counted injector,
not with timing.
"""

import asyncio

import pytest
import torch

import jax
from emqx_tpu.broker import supervise as JS
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.client import Client as JClient
from emqx_tpu_torch.broker import supervise as TS
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client as TClient
from emqx_tpu_torch.parallel.serving import ShardedRouteServer

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

MC = {"multichip": {"enable": True, "devices": 8, "dp": 2,
                    "max_batch": 16}, "device_min_batch": 1}

EXCHANGE_KEYS = ("pipeline.exchange.windows", "pipeline.exchange.overflow",
                 "pipeline.exchange.cold_class")


class Rec:
    """One subscriber session: its delivery sequence."""

    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg.topic, bytes(msg.payload)))
        return True


def run(coro, timeout=180):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


class Twin:
    """The reference's multichip node and the port's, driven alike."""

    def __init__(self, extra=None, *, lanes: int = 0, mc=None):
        broker = dict(MC, deliver_lanes=lanes, **(extra or {}))
        if mc is not None:
            broker["multichip"] = dict(MC["multichip"], **mc)
        self.j = JNode({"broker": broker})
        self.t = TNode({"broker": broker}, device="cpu")
        self.recs = ({}, {})
        self.sids = ({}, {})

    @property
    def nodes(self):
        return (self.j, self.t)

    @property
    def engines(self):
        return (self.j.device_engine, self.t.device_engine)

    def sub(self, client: str, f: str, opts=None) -> None:
        for node, recs, sids in zip(self.nodes, self.recs, self.sids):
            if client not in recs:
                recs[client] = Rec()
                sids[client] = node.broker.register(recs[client], client)
            node.broker.subscribe(sids[client], f,
                                  dict(opts) if opts else None)

    def unsub(self, client: str, f: str) -> None:
        for node, sids in zip(self.nodes, self.sids):
            node.broker.unsubscribe(sids[client], f)

    def both(self, fn):
        """fn(engine, make) on each node; the two results must agree."""
        out = [fn(e, mk) for e, mk in zip(self.engines, (jmake, tmake))]
        assert out[0] == out[1], out
        return out[1]

    def route(self, topics, payload=b"x", wait=True):
        out = self.both(lambda e, mk: e.route_batch(
            [mk("p", 0, t, payload + b"%d" % i)
             for i, t in enumerate(topics)], wait=wait))
        self.settle()
        return out

    def settle(self) -> None:
        """Wait for the background class warms a window asked for, so the
        next window finds the same classes warm on both nodes."""
        for e in self.engines:
            t = e._warm_thread
            if t is not None:
                t.join()

    def got(self) -> dict:
        out = [{c: list(r.got) for c, r in recs.items()}
               for recs in self.recs]
        assert out[0] == out[1]
        return out[1]

    def clear(self) -> None:
        for recs in self.recs:
            for r in recs.values():
                r.got.clear()

    def decisions(self, keys=EXCHANGE_KEYS) -> dict:
        out = []
        for n in self.nodes:
            m = n.metrics
            d = {k: m.val(k) for k in keys}
            d.update({k: v for k, v in m.all().items()
                      if k.startswith("pipeline.exchange.fallback.") and v})
            out.append(d)
        assert out[0] == out[1], out
        return out[1]

    def cursors(self) -> dict:
        out = [{(f, g): grp.cursor for f, gs in n.broker.shared.items()
                for g, grp in gs.items()} for n in self.nodes]
        assert out[0] == out[1]
        return out[1]


# ---- tests/test_multichip_serving.py ------------------------------------

def test_boot_selects_sharded_server():
    tw = Twin()
    je, te = tw.engines
    assert isinstance(te, ShardedRouteServer)
    assert (te.n_dp, te.n_route) == (je.n_dp, je.n_route) == (2, 4)
    assert tw.t.publish_batcher.max_batch == \
        tw.j.publish_batcher.max_batch == 16
    assert te.max_batch == je.max_batch
    assert te.device_exchange and te.subscription_covering


ORACLE_FILTERS = (["ora/exact/%d" % i for i in range(8)]
                  + ["ora/+/w%d" % i for i in range(4)]
                  + ["ora/#", "+/deep/+/x"])
ORACLE_TOPICS = (["ora/exact/%d" % i for i in range(8)]
                 + ["ora/1/w2", "ora/zzz/w3", "q/deep/r/x", "nomatch/t"])


def _oracle_twin(**kw) -> Twin:
    tw = Twin(**kw)
    for i, f in enumerate(ORACLE_FILTERS):
        tw.sub(f"c{i}", f)
    for e in tw.engines:
        e.rebuild()
    return tw


def test_route_batch_matches_host_oracle():
    tw = _oracle_twin()
    counts = tw.route(ORACLE_TOPICS)
    assert counts == [len(tw.t.broker.router.match(t))
                      for t in ORACLE_TOPICS]
    tw.got()
    assert tw.both(lambda e, mk: e.stats()["filters"]) == \
        len(ORACLE_FILTERS)
    assert tw.both(lambda e, mk: e.stats()["caps"])
    tw.decisions()


def test_churn_updates_single_shard_and_serves():
    tw = _oracle_twin()
    tw.sub("churn-c", "churn/+/t")
    assert tw.both(lambda e, mk: sorted(e.dirty_shards))
    assert tw.route(["churn/9/t"]) == [1]
    assert tw.both(lambda e, mk: sorted(e.dirty_shards)) == []
    tw.unsub("churn-c", "churn/+/t")
    assert tw.route(["churn/9/t"]) == [0]
    assert tw.got()["churn-c"] == [("churn/+/t", "churn/9/t", b"x0")]
    tw.decisions()


@pytest.mark.parametrize("strategy", ["round_robin", "hash_topic",
                                      "sticky"])
def test_shared_group_picks_on_mesh(strategy):
    tw = Twin({"shared_subscription_strategy": strategy})
    tw.sub("sha", "$share/g/mesh/work")
    tw.sub("shb", "$share/g/mesh/work")
    assert tw.route(["mesh/work"] * 8) == [1] * 8
    got = tw.got()
    assert len(got["sha"]) + len(got["shb"]) == 8
    if strategy == "round_robin":
        assert len(got["sha"]) == len(got["shb"]) == 4
    tw.cursors()


def test_round_robin_cursor_survives_shard_churn():
    tw = Twin()
    tw.sub("cs-a", "$share/cg/curs/t")
    tw.sub("cs-b", "$share/cg/curs/t")
    assert tw.route(["curs/t"]) == [1]
    s = tw.t.device_engine.shard_of("curs/t")
    assert s == tw.j.device_engine.shard_of("curs/t")
    i = 0
    while tw.t.device_engine.shard_of(f"cfill/{i}") != s:
        i += 1
    tw.sub("cs-fill", f"cfill/{i}")
    assert tw.both(lambda e, mk: s in e.dirty_shards)
    assert tw.route(["curs/t"]) == [1]
    got = tw.got()
    assert len(got["cs-a"]) == len(got["cs-b"]) == 1
    tw.cursors()


def test_serves_over_real_sockets_via_batcher():
    """CONNECT/SUBSCRIBE/PUBLISH over TCP with the mesh serving: cold
    classes route on the host while the mesh warms, then a second flood
    takes the mesh. Both nodes deliver the same sequence."""
    def drive(node, listener_cls, client_cls):
        lst = listener_cls(node, bind="127.0.0.1", port=0)

        async def go():
            await lst.start()
            sub = client_cls(port=lst.port, clientid="mc-sub")
            await sub.connect()
            await sub.subscribe("mc/+/t", qos=1)
            pub = client_cls(port=lst.port, clientid="mc-pub")
            await pub.connect()
            got = []
            for i in range(60):
                await pub.publish(f"mc/{i}/t", b"m%d" % i, qos=1)
            while len(got) < 60:
                got.append((await sub.recv(timeout=10)).payload)
            eng = node.device_engine
            for _ in range(400):
                if eng.batch_class_warm(2):
                    break
                await asyncio.sleep(0.05)
            for i in range(40):
                await pub.publish(f"mc/w{i}/t", b"w%d" % i, qos=1)
            while len(got) < 100:
                got.append((await sub.recv(timeout=10)).payload)
            await sub.disconnect()
            await pub.disconnect()
            await lst.stop()
            return got

        got = run(go(), 120)
        node.publish_batcher.close()
        return got

    tw = Twin()
    want = [b"m%d" % i for i in range(60)] + [b"w%d" % i for i in range(40)]
    assert drive(tw.j, JListener, JClient) == want
    assert drive(tw.t, TListener, TClient) == want
    assert tw.t.metrics.val("messages.routed.device") > 0, \
        tw.t.device_engine.stats()


def test_pinned_handle_survives_shard_update():
    tw = Twin()
    tw.sub("race-a", "race/+")
    tw.route([])

    def stages(e, mk):
        h = e.prepare([mk("p", 0, "race/1", b"x")])
        assert h is not None
        return h

    hs = [stages(e, mk) for e, mk in zip(tw.engines, (jmake, tmake))]
    tw.sub("race-b", "race2/+")
    assert tw.both(lambda e, mk: e.poll_rebuild())
    counts = []
    for e, h in zip(tw.engines, hs):
        e.dispatch(h)
        e.materialize(h)
        counts.append(e.finish(h))
    assert counts[0] == counts[1] == [1]
    assert tw.got()["race-a"] == [("race/+", "race/1", b"x")]


DEEP = "/".join(["l%d" % i for i in range(20)])        # > level_cap


def test_too_deep_filter_host_fallback():
    tw = Twin()
    tw.sub("ok", "ora/+")
    tw.sub("deep-c", DEEP)
    assert tw.route([DEEP, "ora/x"]) == [1, 1]
    assert tw.got()["deep-c"] == [(DEEP, DEEP, b"x0")]
    tw.decisions()


def test_deep_filter_shared_group_delivers():
    tw = Twin()
    deep = "/".join(["s%d" % i for i in range(20)])
    tw.sub("dsg-a", f"$share/dg/{deep}")
    tw.sub("dsg-b", f"$share/dg/{deep}")
    assert tw.route([deep] * 6) == [1] * 6
    got = tw.got()
    assert len(got["dsg-a"]) + len(got["dsg-b"]) == 6
    tw.cursors()


def test_group_subscribed_mid_flight_gets_delivery():
    tw = Twin()
    tw.sub("mf-a", "mid/flight/t")
    assert tw.route(["mid/flight/t"]) == [1]
    hs = [e.prepare([mk("p", 0, "mid/flight/t", b"1")])
          for e, mk in zip(tw.engines, (jmake, tmake))]
    assert all(h is not None for h in hs)
    tw.sub("mf-late", "$share/lg/mid/flight/t")
    counts = []
    for e, h in zip(tw.engines, hs):
        e.dispatch(h)
        e.materialize(h)
        counts.append(e.finish(h))
    assert counts[0] == counts[1] == [2]
    assert tw.route(["mid/flight/t"]) == [2]
    assert len(tw.got()["mf-late"]) == 2


def test_capacity_growth_triggers_full_rebuild():
    tw = _oracle_twin()
    before = tw.both(lambda e, mk: dict(e._caps))
    for i in range(64):
        tw.sub("grow%d" % i, "grow/all")
    assert tw.route(["grow/all"]) == [64]
    got = tw.got()
    assert sum(len(got["grow%d" % i]) for i in range(64)) == 64
    after = tw.both(lambda e, mk: dict(e._caps))
    assert after["subs"] > before["subs"]
    assert tw.t.metrics.val("routing.mesh.full_rebuilds") >= 1


def test_host_serving_during_background_rebuild_is_counted():
    """Inside a running loop a shard outgrowing its class starts the
    chunked capture and the build thread: windows route on the host
    until the swap (None from prepare_window), and each such message is
    counted."""
    tw = Twin()
    tw.sub("a", "bg/+")
    eng = tw.t.device_engine
    eng.rebuild()
    for i in range(40):
        tw.sub("bg%d" % i, "bg/all")

    async def go():
        h = eng.prepare([tmake("p", 0, "bg/all", b"x")])
        assert h is None
        while eng._rebuilding():
            await asyncio.sleep(0.01)
        h = eng.prepare([tmake("p", 0, "bg/all", b"y")])
        assert h is not None
        eng.dispatch(h)
        eng.materialize(h)
        return eng.finish(h)

    assert run(go()) == [41]
    assert tw.t.metrics.val("routing.mesh.rebuild_host") == 1


# ---- tests/test_exchange.py :108-339 ------------------------------------

_SPEC = ([("multi", "ab/+", 0), ("multi", "ab/x", 0),
          ("multi", "ab/#", 0), ("multi", "+/x", 0)]
         + [(f"fan{i}", "hot/+", 0) for i in range(6)]
         + [(f"solo{i}", f"solo/t{i}", 0) for i in range(6)])

_TOPICS = (["ab/x", "hot/1", "solo/t3", "ab/y", "nomatch/z", "hot/2"]
           + [f"solo/t{i}" for i in range(6)] + ["ab/x", "q/x"])


def _exchange_twin(devices=8, dp=2, spec=_SPEC, **kw) -> Twin:
    tw = Twin(mc={"devices": devices, "dp": dp}, **kw)
    for client, f, q in spec:
        tw.sub(client, f, {"qos": q})
    for e in tw.engines:
        e.rebuild()
    return tw


@pytest.mark.parametrize("devices,dp", [(2, 1), (4, 2), (8, 2)])
def test_exchange_clean_traffic(devices, dp):
    tw = _exchange_twin(devices, dp)
    assert tw.both(lambda e, mk: e.warm_exchange(len(_TOPICS)))
    for _ in range(3):
        tw.route(_TOPICS)
        if tw.t.metrics.val("pipeline.exchange.windows"):
            break
        tw.both(lambda e, mk: e.warm_exchange(len(_TOPICS)))
    tw.clear()
    before = tw.t.metrics.val("pipeline.exchange.windows")
    tw.route(_TOPICS)
    tw.route(list(reversed(_TOPICS)))
    assert tw.t.metrics.val("pipeline.exchange.windows") >= before + 2
    tw.decisions()
    got = tw.got()
    # exchange off: the host gather delivers the same sequences
    off = Twin({"device_exchange": 0},
               mc={"devices": devices, "dp": dp}).t
    recs = {}
    for client, f, q in _SPEC:
        if client not in recs:
            recs[client] = (Rec(), off.broker.register(Rec(), client))
            recs[client] = (recs[client][0], off.broker.register(
                recs[client][0], client))
        off.broker.subscribe(recs[client][1], f, {"qos": q})
    off.device_engine.rebuild()
    for tps in (_TOPICS, list(reversed(_TOPICS))):
        off.device_engine.route_batch(
            [tmake("p", 0, t, b"x%d" % i) for i, t in enumerate(tps)],
            wait=True)
    assert {c: r.got for c, (r, _s) in recs.items()} == got
    assert off.metrics.val("pipeline.exchange.windows") == 0
    assert off.device_engine.aux is None


def test_exchange_shared_groups_fall_back_identically():
    spec = _SPEC + [(f"sh{i}", "$share/g/ab/+", 0) for i in range(3)]
    tw = _exchange_twin(spec=spec)
    tw.both(lambda e, mk: e.warm_exchange(len(_TOPICS)))
    tw.route(_TOPICS)
    assert tw.decisions()["pipeline.exchange.fallback.unclean"] >= 1
    tw.got()
    tw.cursors()


READBACK_KEYS = ("pipeline.readback.windows.dense",
                 "pipeline.readback.windows.compact",
                 "pipeline.readback.bytes.compact",
                 "routing.device.cold_compact_class")


@pytest.mark.parametrize("exchange", [True, False])
def test_dense_readback_equals_reference(exchange):
    """``compact_readback: false`` on both mesh servers (exchange on or
    off; shared groups make the windows gather): every gathered window
    reads its dense planes back, no CSR payload class is chosen, wanted
    or warmed, and the deliveries, cursors, exchange decisions and
    readback counts equal the reference's; the deliveries also equal the
    CSR twin's on the same traffic."""
    spec = _SPEC + [(f"sh{i}", "$share/g/ab/+", 0) for i in range(3)]
    out = []
    for compact in (False, True):
        tw = _exchange_twin(spec=spec, extra={
            "compact_readback": compact, "device_exchange": exchange})
        for _ in range(3):
            tw.route(_TOPICS)
            tw.route(list(reversed(_TOPICS)))
        tw.cursors()
        tw.decisions()
        out.append(tw.got())
        if compact:
            assert tw.decisions(READBACK_KEYS[:2])[
                "pipeline.readback.windows.compact"] > 0
            continue
        reads = tw.decisions(READBACK_KEYS)
        assert reads["pipeline.readback.windows.dense"] > 0
        assert reads["pipeline.readback.windows.compact"] == 0
        assert reads["routing.device.cold_compact_class"] == 0
        te = tw.t.device_engine
        assert te.compact_readback is False and te._choose_pcap(16) is None
        assert te._compact_warm == set() and te._wanted_pcap == set()
        assert te.stats()["compact_readback"] is False
    assert out[0] == out[1]


def test_exchange_dirty_shards_at_consume_fall_back_identically():
    tw = _exchange_twin()
    tw.both(lambda e, mk: (e.warm_exchange(4),
                           e.warm_exchange(len(_TOPICS))))
    tw.route(_TOPICS[:4])
    assert tw.t.metrics.val("pipeline.exchange.windows") >= 1
    hs = []
    for e, mk in zip(tw.engines, (jmake, tmake)):
        h = e.prepare([mk("p", 0, t, b"late") for t in _TOPICS])
        e.dispatch(h)
        e.materialize(h)
        hs.append(h)
    tw.sub("late", "ab/+")
    counts = [e.finish(h) for e, h in zip(tw.engines, hs)]
    assert counts[0] == counts[1]
    assert tw.decisions()["pipeline.exchange.fallback.late"] >= 1
    assert tw.both(lambda e, mk: e.poll_rebuild())
    tw.got()


def test_exchange_churn_mid_stream_identical():
    tw = _exchange_twin()
    tw.both(lambda e, mk: e.warm_exchange(len(_TOPICS)))
    for rnd in range(3):
        tw.route(_TOPICS)
        tw.sub(f"ch{rnd}", f"solo/t{rnd}")
    tw.route(_TOPICS)
    tw.got()
    tw.decisions()


def test_exchange_segment_overflow_falls_back_identically():
    tw = _exchange_twin(spec=[(f"big{i}", "hot/+", 0) for i in range(80)])
    tw.both(lambda e, mk: e.warm_exchange(4))
    assert tw.both(lambda e, mk: e._choose_ecap(e._batch_class(4))) == 16
    tw.route(["hot/a"] * 4)
    d = tw.decisions()
    assert d["pipeline.exchange.overflow"] >= 1
    assert d["pipeline.exchange.windows"] == 0
    assert tw.both(lambda e, mk: e._choose_ecap(e._batch_class(4))) > 16
    tw.got()


def test_exchange_lanes_preserve_per_session_order():
    """Through the batcher with two delivery lanes: the plan chunks keep
    every session's sequence."""
    tw = _exchange_twin(lanes=2, extra={"batch_window_us": 1000})
    for e in tw.engines:
        e._warm_one(2)
        e._warm_one(4)
        e.warm_exchange(2)
        e.warm_exchange(4)

    def drive(node, mk):
        # the window path is the device's on both (a host-routed window
        # delivers message-major, a device window shard-major)
        node.publish_batcher._device_worth_it = lambda *a: True

        async def go():
            for w in range(4):
                await asyncio.gather(*[
                    node.publish_async(mk("p", 1, t, b"w%d" % w))
                    for t in ("ab/x", "hot/1", "solo/t0", "ab/y")])
            if node.deliver_lanes is not None:
                await node.deliver_lanes.drain()
        run(go())
        node.publish_batcher.close()

    for node, mk in zip(tw.nodes, (jmake, tmake)):
        drive(node, mk)
    assert tw.t.metrics.val("pipeline.exchange.windows") >= 1
    assert tw.t.metrics.val("pipeline.deliver.rows") >= 1
    got = tw.got()
    assert got["multi"]


def test_exchange_dead_ring_degrades_to_host_gather():
    tw = _exchange_twin(extra={"supervise": True, "supervise_threshold": 3})
    tw.both(lambda e, mk: e.warm_exchange(len(_TOPICS)))
    baseline = tw.route(_TOPICS)

    def dead_ring(*a, **k):
        raise RuntimeError("ring down")

    for e in tw.engines:
        E = e._choose_ecap(e._batch_class(len(_TOPICS)))
        e._exch_steps[E] = dead_ring
    for _ in range(3):
        assert tw.route(_TOPICS) == baseline
    d = tw.decisions(("supervise.faults.mesh_exchange",))
    assert d["pipeline.exchange.fallback.error"] >= 3
    assert d["supervise.faults.mesh_exchange"] >= 3
    assert tw.both(lambda e, mk: e.sup.breakers["mesh_exchange"].state) \
        == "open"
    tw.got()


def test_exchange_dead_ring_raises_on_the_card():
    """The port's departure on the card (emulated): a real exchange error
    is not replayed on the host — it raises and fails the server."""
    tw = _exchange_twin(extra={"supervise": True})
    eng = tw.t.device_engine
    eng.warm_exchange(len(_TOPICS))
    eng.fail_on_device_error = True

    def dead_ring(*a, **k):
        raise RuntimeError("ring down")

    eng._exch_steps[eng._choose_ecap(eng._batch_class(len(_TOPICS)))] = \
        dead_ring
    with pytest.raises(RuntimeError, match="ring down"):
        eng.route_batch([tmake("p", 0, t, b"") for t in _TOPICS],
                        wait=True)
    assert eng.failed is not None
    with pytest.raises(RuntimeError, match="failed"):
        eng.route_batch([tmake("p", 0, "ab/x", b"")], wait=True)


# ---- the mesh fault (tests/test_supervise.py:360), counted -----------------

def test_mesh_exchange_fault_replays_and_recovers():
    """One injected mesh_exchange fault in a flood through the batcher:
    the window replays on the host, the breaker trips and re-closes, and
    both nodes settle every message once, with the same sequences."""
    conf = {"multichip": {"enable": True, "devices": 2, "max_batch": 64},
            "deliver_lanes": 0, "device_min_batch": 4,
            "batch_window_us": 2000, "supervise": True,
            "supervise_threshold": 1, "device_fanout_cap": 16,
            "device_slot_cap": 4}
    out = []
    for node, S, mk in ((JNode({"broker": conf}), JS, jmake),
                        (TNode({"broker": conf}, device="cpu"), TS, tmake)):
        sup = node.supervisor
        for br in sup.breakers.values():
            br.base_cooldown_s = br.cooldown_s = 0.05
        srv = node.device_engine
        b = node.broker
        recs = [Rec() for _ in range(4)]
        for i, r in enumerate(recs):
            b.subscribe(b.register(r, f"c{i}"), f"t/{i}/+", {"qos": 1})
        srv.route_batch([mk("p", 0, f"t/{i}/w", b"") for i in range(4)] * 2,
                        wait=True)
        for Bp in (8, 16, 32, 64):
            srv._warm_one(Bp)
        assert srv.batch_class_warm(8)
        node.publish_batcher._device_worth_it = lambda *a: True
        sup.injector = S.FaultInjector(S.parse_faults(
            "mesh_exchange:exception:count=1"))

        async def go(node=node, sup=sup, mk=mk):
            outs = []
            for w in range(40):
                outs.extend(await asyncio.gather(*[
                    node.publish_async(mk("p", 1, f"t/{i}/x",
                                          b"m%d%d" % (w, i)))
                    for i in range(4) for _ in range(2)]))
                if sup.injector.faults[0].fired and \
                        sup.breakers["mesh_exchange"].state == "closed" \
                        and w >= 3:
                    break
                await asyncio.sleep(0.06)
            return outs

        outs = run(go())
        node.publish_batcher.close()
        m = node.metrics
        assert all(c == 1 for c in outs)
        assert m.val("supervise.faults.mesh_exchange") == 1
        assert m.val("supervise.replays") >= 1
        assert sup.breakers["mesh_exchange"].state == "closed"
        assert m.val("messages.dropped") == 0
        out.append({i: [g[2] for g in r.got if g[1].endswith("/x")]
                    for i, r in enumerate(recs)})
    # the same messages, in publish order, per session (the reference
    # may stop its flood a window earlier or later: compare the prefix)
    for i in range(4):
        n = min(len(out[0][i]), len(out[1][i]))
        assert n >= 8 and out[0][i][:n] == out[1][i][:n]


def test_chip_smoke_mesh_node_on_cpu():
    """chip_smoke.py's phase 14 rehearsed on the CPU at a reduced size:
    14a (tools/sharded_bench.py's drive: 2,000 filters, 4 pipelined
    batches of 16, 2 churn rounds, the slots class outgrown with host
    serving during the background build), 14b and 14c (phase 8's
    population at 1,000 filters over TCP through a multichip node, a
    counted mesh_exchange fault mid-flood), the real failure that raises,
    and the single-chip engine's incremental capture (64 churned filters:
    equal to the full capture, the next window exact)."""
    import chip_smoke as cs
    dev = torch.device("cpu")
    a = cs.mesh_sharded_drive(dev, n_filters=2000, batch=16, batches=4,
                              churn_rounds=2)
    assert a["flood"]["msgs"] == 64 and a["window_err"] == 0
    assert a["flood"]["exchange_windows"] == 4
    assert a["churn"]["shard_updates"] >= 2
    ov = a["overflow"]
    assert ov["slots_cap"][1] > ov["slots_cap"][0]
    assert ov["host_served_during_rebuild"] >= 1
    r = cs.mesh_node_drive(dev, n_filters=1000, n_sub=4, n_pub=2,
                           total=400, fault_msgs=400, fault_after=1)
    f = r["flood"]
    assert f["delivered"] == f["sent"] == 400 and f["device_share"] >= 0.9
    assert r["max_batch"] == 256 and r["window_err"] == 0
    assert r["fault"]["faults"] == 1 and r["fault"]["replays"] >= 1
    assert r["fault"]["rung"] == 0
    assert r["exchange_section"]["rounds"] > 0
    assert set(r["ledger"]["by_category"]) >= {"mesh_tables",
                                                "mesh_cursors",
                                                "exchange_aux"}
    fatal = cs.mesh_fatal_check(dev)
    assert fatal["first"] == "mesh kernel broke"
    c = cs.capture_drive(dev, n_filters=1000, n_sub=4, churn=64)
    assert c["equal"] and c["window_err"] == 0 and c["touched"] >= 64
