"""Port vs JAX reference: the session-affine delivery lanes.

``emqx_tpu_torch/broker/deliver.py`` against ``emqx_tpu/broker/deliver.py``
on the CPU, at small sizes:

- ``DeliveryView``: every header and flag operation, ``copy`` and
  ``to_map`` give what the reference's view gives on the same message;
- ``DeliveryPlan``: the same seeded (midx, sid, opt, fid) arrays give the
  same sorted rows and the same per-lane slices;
- whole windows through ``prepare_window`` / ``dispatch`` /
  ``materialize`` / ``finish_sub`` on the reference's engine with 4 lanes,
  the port's with 4 lanes, the port's inline (``deliver_lanes: 0``) and
  the reference's inline: the same per-session delivered sequences and
  per-message counts, with shared groups, nacking sinks, rich subopts, the
  fan-out and slot overflows, covering on and churn between windows. The
  lanes run either after each sub-batch's consume, or once a window's
  sub-batches are all consumed (the batcher's settle ring can consume the
  next sub-batch before the lanes ran). In the second drive under
  round robin the reference's lanes depart from its own inline loop: its
  consume writes a sub-batch's device picks back into the host groups'
  cursors when it builds the plan, so the host picks of an earlier
  sub-batch's slow closures (host fallbacks, dirty slots) read cursors
  advanced by later sub-batches. The port writes them back in plan order,
  behind the barrier, and keeps the inline sequence;
- ``deliver_batch``: a same-session run is one call, and the channel's
  coalesced delivery sends what per-message delivery sends;
- backpressure: a blocked lane stalls ``admit`` and drops nothing;
- the batcher resolves publishers' futures only once the lanes finish.
"""

import asyncio
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from emqx_tpu.broker import deliver as JD
from emqx_tpu.broker import message as JM
from emqx_tpu.broker.metrics import Metrics as JMetrics
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker import deliver as TD
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker.metrics import Metrics as TMetrics
from emqx_tpu_torch.broker.node import Node as TNode
from tests.test_torch_engine import (JAX_BROKER, LAYERS, N_SESSIONS, RICH,
                                     NackSink, Sink, _mid_churn,
                                     shapes_population, shapes_topics)

torch.set_num_threads(1)

TIMEOUT_S = 120
NOW_MS = 1_800_000_000_000


def _pair(**kw):
    """The same message in both packages (id and ts pinned)."""
    kw.setdefault("headers", {"username": "u", "properties": {
        "message_expiry_interval": 30, "user_property": [("k", "v")]}})
    kw.setdefault("flags", {"retain": True})
    args = dict(topic="a/b", payload=b"xyz", qos=1, from_="pub",
                id=0x1234567890ABCDEF, ts=NOW_MS - 5_000, extra={"e": 1})
    return (JM.Message(**args, flags=dict(kw["flags"]),
                       headers=dict(kw["headers"])),
            TM.Message(**args, flags=dict(kw["flags"]),
                       headers=dict(kw["headers"])))


def _view_ops(v, op: str) -> list:
    """One scenario of reads and writes on a view; returns everything it
    observed, the view's copy and map, as plain values."""
    seen = []
    h = v.headers
    if op == "read":
        seen += [v.get_header("subopts"), v.get_header("username"),
                 v.get_header("nope", 7), h.get("subopts"), h["username"],
                 "subopts" in h, "nope" in h, len(h), sorted(h.keys()),
                 dict(h.items()), h == h.copy(), v.retain, v.dup, v.is_sys,
                 v.expiry_interval(), v.is_expired(), v.get_flag("retain")]
    elif op == "header_write":
        v.set_header("x", 1)
        h["y"] = 2
        seen += [v.headers.pop("username"), v.headers.setdefault("z", 3),
                 dict(v.headers.items())]
        v.headers.update(w=4)
        del v.headers["x"]
        seen.append(dict(v.headers))
    elif op == "view_headers_write":
        # writes through the read-through mapping materialize first
        h.update(a=1)
        h.setdefault("b", 2)
        seen += [h.pop("username", None), dict(v.headers)]
        v.headers.clear()
        seen.append(dict(v.headers))
    elif op == "flags":
        v.set_flag("dup")
        v.set_flag("retain", False)
        seen += [v.dup, v.retain, dict(v.flags), v.get_flag("sys")]
    elif op == "expiry":
        v.update_expiry()
        seen += [v.get_header("properties"), v.is_expired()]
    elif op == "sys":
        seen += [v.is_sys, v.get_flag("sys", True)]
    m = v.copy()
    seen += [type(m).__name__, m.topic, m.payload, m.qos, m.from_,
             m.flags, m.headers, m.id, m.ts, m.extra, v.to_map(), repr(v)]
    return seen


@pytest.mark.parametrize("op", ["read", "header_write",
                                "view_headers_write", "flags", "expiry",
                                "sys"])
def test_delivery_view_matches_reference(op, monkeypatch):
    monkeypatch.setattr(JM, "now_ms", lambda: NOW_MS)
    monkeypatch.setattr(TD, "now_ms", lambda: NOW_MS)
    jm, tm = _pair()
    if op == "sys":
        jm.topic = tm.topic = "$SYS/brokers"
    opts = TD.OPT_TABLE[0x2D]
    assert opts == JD.OPT_TABLE[0x2D]
    jv, tv = JD.DeliveryView(jm, opts), TD.DeliveryView(tm, opts)
    assert _view_ops(tv, op) == _view_ops(jv, op)
    # copy-on-write: the routed message and the shared table are intact
    for m in (jm, tm):
        assert m.headers == _pair()[0].headers and m.flags == {"retain": True}
    assert TD.OPT_TABLE[0x2D] == JD.OPT_TABLE[0x2D] == {
        "qos": 1, "nl": 1, "rap": 1, "rh": 2}


def _plan_arrays(seed: int, n_msgs: int = 40, n_rows: int = 600):
    r = np.random.RandomState(seed)
    midx = np.sort(r.randint(0, n_msgs, n_rows))
    sid = r.randint(0, 97, n_rows)
    opt = r.randint(0, 64, n_rows)
    fid = r.randint(0, 50, n_rows)
    return n_msgs, midx, sid, opt, fid


def _pool(mod, metrics, n_lanes, broker=None):
    broker = broker or SimpleNamespace(_subscribers={}, _sub_meta={})
    return mod.DeliveryLanePool(broker, metrics, n_lanes=n_lanes, depth=4)


@pytest.mark.parametrize("n_lanes", [1, 2, 4, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_delivery_plan_slices_match_reference(n_lanes, seed):
    """The same rows, in two chunks, bucket into the same sorted rows and
    the same per-lane slices (and barrier items for the slow closures)."""
    n_msgs, midx, sid, opt, fid = _plan_arrays(seed)
    filters = [f"f/{i}" for i in range(50)]
    cut = len(midx) // 3

    async def go(mod, metrics):
        pool = _pool(mod, metrics, n_lanes)
        pool.pause()
        plan = pool.new_plan([SimpleNamespace(is_sys=False)] * n_msgs)
        for lo, hi in ((0, cut), (cut, len(midx))):
            plan.add_rows(midx[lo:hi], sid[lo:hi], opt[lo:hi], fid[lo:hi],
                          filters)
        plan.add_slow(3, lambda: 0)
        pool.submit(plan)
        queued = [[(it[0],) + tuple(it[2:]) for it in q._queue]
                  for q in pool._queues]
        out = (plan.s_midx, plan.s_sid, plan.s_opt, plan.s_fid, queued,
               pool.state(), metrics.val("pipeline.deliver.rows"))
        pool.resume()
        await asyncio.wait_for(pool.drain(), TIMEOUT_S)
        return out

    want = asyncio.run(go(JD, JMetrics()))
    got = asyncio.run(go(TD, TMetrics()))
    assert got == want
    s_sid = np.asarray(got[1])
    assert (np.diff(s_sid % n_lanes) >= 0).all()


class LaneTwin:
    """Four nodes with the same sessions and subscriptions: the
    reference's with 4 delivery lanes, the port's with 4, the port's
    inline (0 lanes) and the reference's inline. ``drive`` is "sub" (the
    lanes run after each sub-batch's consume) or "window" (after all of a
    window's); ``ref_lanes`` whether the reference's lanes are held to the
    others (not in the one case where they depart, see the docstring)."""

    def __init__(self, strategy, layers, population, drive="window"):
        self.rng = random.Random(11)
        self.rich = layers in RICH
        self.drive = drive
        self.ref_lanes = not (strategy == "round_robin"
                              and drive == "window")
        conf = dict(LAYERS[layers], shared_subscription_strategy=strategy)
        self.nodes = [
            JNode({"broker": dict(JAX_BROKER, **conf, deliver_lanes=4)},
                  use_device=True),
            TNode({"broker": dict(conf, deliver_lanes=4)}, device="cpu"),
            TNode({"broker": dict(conf, deliver_lanes=0)}, device="cpu"),
            JNode({"broker": dict(JAX_BROKER, **conf)}, use_device=True)]
        assert self.nodes[0].deliver_lanes is not None
        assert self.nodes[1].deliver_lanes.n_lanes == 4
        assert self.nodes[2].deliver_lanes is None
        assert self.nodes[3].deliver_lanes is None
        sink = NackSink if self.rich else Sink
        self.sinks = [[sink() for _ in range(N_SESSIONS)]
                      for _ in self.nodes]
        for node, sinks in zip(self.nodes, self.sinks):
            for i, s in enumerate(sinks):
                assert node.broker.register(s, f"c{i}") == i
        for k, f in enumerate(population):
            n = self.rng.randrange(1, 12 if self.rich else 4)
            for sid in self.rng.sample(range(N_SESSIONS), n):
                opts = {"qos": (k + sid) % 3}
                if self.rich and (k + sid) % 4 == 0:
                    opts.update(nl=1, rap=1, rh=(k % 3))
                if self.rich and (k + sid) % 7 == 0:
                    opts["subid"] = 1 + k % 5
                for node in self.nodes:
                    node.broker.subscribe(sid, f, dict(opts))
        self.plans = 0
        self.ref_departed = False   # the reference's lanes left inline

    async def window(self, n_batches, topics, gate_cold=True, mid=None,
                     n=30):
        lives = [[JM.make(f"p{self.rng.randrange(5)}", 0, t, b"%d" % k)
                  for k, t in enumerate(topics(self.rng, n))]
                 for _ in range(n_batches)]
        seed = self.rng.randrange(1 << 30)
        counts = []
        for node in self.nodes:
            eng = node.device_engine
            random.seed(seed)
            h = eng.prepare_window(lives, gate_cold=gate_cold)
            assert h is not None
            eng.dispatch(h)
            if mid is not None:
                mid(node)
            eng.materialize(h)
            pool = node.deliver_lanes
            got = []
            for k in range(n_batches):
                got.append(eng.finish_sub(h, k))
                if pool is not None and self.drive == "sub":
                    await asyncio.wait_for(pool.drain(), TIMEOUT_S)
            plans = [g.plan for g in got if getattr(g, "plan", None)]
            if pool is not None:
                assert plans, "the lanes took no plan"
                await asyncio.wait_for(pool.drain(), TIMEOUT_S)
                assert all(p.done for p in plans)
                self.plans += len(plans) * (node is self.nodes[1])
            else:
                assert not plans
            counts.append([list(g) for g in got])
            assert eng._outstanding == 0
        assert counts[1] == counts[2] == counts[3]
        if self.ref_lanes:
            assert counts[0] == counts[1]
        self.check()

    def check(self):
        got = [[s.got for s in sinks] for sinks in self.sinks]
        assert got[1] == got[2], "the port's lanes vs its inline loop"
        assert got[2] == got[3], "the port's inline loop vs the reference's"
        if self.ref_lanes:
            assert got[0] == got[1], "the reference's lanes vs the port's"
        self.ref_departed |= got[0] != got[1]

    def churn(self):
        """Dirty filters and slots, a new group on a built filter and
        post-snapshot filters (overlay rows or cover appends)."""
        b = self.nodes[1].broker
        plain = sorted(b.subs)
        shared = sorted((f, g) for f, gs in b.shared.items() for g in gs)
        sid9 = next(iter(b.subs[plain[9]]))
        f, g = shared[1]
        for node in self.nodes:
            nb = node.broker
            nb.subscribe(3, plain[5], {"qos": 1})
            nb.unsubscribe(sid9, plain[9])
            nb.subscribe(7, f"$share/{g}/{f}", {"qos": 0})
            nb.subscribe(8, f"$share/new/{plain[12]}", {"qos": 1})
            nb.subscribe(9, "zz/+/late", {"qos": 2})
            nb.subscribe(10, "dev/d2/+/n5/late/#", {"qos": 1})


@pytest.mark.parametrize("drive", ["sub", "window"])
@pytest.mark.parametrize("layers", ["full", "rich"])
@pytest.mark.parametrize("strategy", ["round_robin", "random", "hash_topic",
                                      "hash_clientid", "sticky"])
def test_lanes_deliver_as_reference_and_inline(layers, strategy, drive):
    """Fixed windows through the four engines: every session's delivered
    sequence (filter, topic, message, subopts, and for nacking sinks the
    verdict) and every message's count are equal, before and after churn,
    with churn while a window is in flight, and after a rebuild."""
    twin = LaneTwin(strategy, layers, shapes_population(random.Random(3)),
                    drive)

    async def go():
        for k in range(3):
            await twin.window(1 + 3 * k, shapes_topics, gate_cold=bool(k % 2))
        twin.churn()

        def late(rng, n):
            return shapes_topics(rng, n - 3) + [
                "zz/a/late", "dev/d2/x/n5/late/t", f"s/{rng.randrange(60)}/t"]
        for k in range(2):
            await twin.window(2, late, gate_cold=bool(k))
        await twin.window(3, late, gate_cold=False, mid=_mid_churn)
        await twin.window(4, late)
        for node in twin.nodes:
            node.device_engine.rebuild()
        await twin.window(2, late, gate_cold=False)

    asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    m = twin.nodes[1].metrics
    assert twin.plans > 0 and m.val("pipeline.deliver.rows") > 0
    assert m.val("pipeline.deliver.plans") == twin.plans
    assert twin.nodes[1].device_engine.stats()["cover"]["covered"] > 0
    if layers in RICH:
        assert m.val("routing.device.host_fallback") > 0
    for name in ("rows", "plans", "deliveries", "drains"):
        key = f"pipeline.deliver.{name}"
        assert m.val(key) == twin.nodes[0].metrics.val(key), key
    # the reference's departure shows in exactly the case it is allowed
    assert twin.ref_departed == (not twin.ref_lanes)


class BatchSink(Sink):
    """A subscriber with the coalesced entry: records each call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def deliver_batch(self, items):
        self.calls.append(len(items))
        for f, m in items:
            self.deliver(f, m)
        return len(items)


@pytest.mark.parametrize("mod,metrics", [(JD, JMetrics), (TD, TMetrics)])
def test_deliver_batch_coalesces_runs(mod, metrics):
    """A session's run within a lane slice is ONE deliver_batch call; a
    subscriber without it gets one deliver per row; counts land per
    message. The reference's pool does the same."""
    batch, plain = BatchSink(), Sink()
    broker = SimpleNamespace(_subscribers={0: batch, 1: plain},
                             _sub_meta={0: "a", 1: "b"})
    m = metrics()

    async def go():
        pool = _pool(mod, m, 2, broker)
        msgs = [JM.make("p", 0, f"t/{i}", b"") for i in range(5)]
        plan = pool.new_plan(msgs)
        # session 0: 5 rows (one run), session 1: 3 rows
        plan.add_rows([0, 1, 2, 3, 4, 0, 1, 2], [0, 0, 0, 0, 0, 1, 1, 1],
                      [1] * 8, [0] * 8, ["t/+"])
        plan.register_fast(range(5))
        pool.submit(plan)
        await asyncio.wait_for(pool.drain(), TIMEOUT_S)
        return plan

    plan = asyncio.run(go())
    assert batch.calls == [5] and len(batch.got) == 5 and len(plan.msgs) == 5
    assert [g[1] for g in plain.got] == ["t/0", "t/1", "t/2"]
    assert list(plan.counts) == [2, 2, 2, 1, 1]
    assert m.val("pipeline.deliver.drains") == 1 + 3
    assert m.val("pipeline.deliver.deliveries") == 8
    assert m.val("messages.delivered") == 8


def _channel(mod_channel, node, clientid="c1"):
    sent = []
    ch = mod_channel.Channel(node, {}, lambda pkts: sent.extend(pkts),
                             lambda reason: None)
    ch.clientid = clientid
    ch.session = mod_channel.Session(clientid)
    ch.conn_state = mod_channel.CONN_CONNECTED
    return ch, sent


@pytest.mark.parametrize("parked", [False, True])
def test_channel_deliver_batch_equals_per_message(parked):
    """Channel.deliver_batch (and ParkedSubscriber's) sends, or queues,
    what per-message deliver() does, with one socket write for the run,
    and the reference's channel sends the same packets."""
    from emqx_tpu.broker import channel as JC
    from emqx_tpu_torch.broker import channel as TC
    out = {}
    for name, mod_c, mod_d, Node, kw in (
            ("ref", JC, JD, JNode, {"use_device": False}),
            ("port", TC, TD, TNode, {"device": "cpu"})):
        rows = []
        for how in ("batch", "single"):
            node = Node(**kw)
            ch, sent = _channel(mod_c, node)
            target = mod_c.ParkedSubscriber(ch.session, node) if parked \
                else ch
            msgs = [mod_d.DeliveryView(
                JM.make("p", q, f"t/{q}", b"%d" % q),
                mod_d.OPT_TABLE[q]) for q in (0, 1, 2, 1)]
            items = [("t/+", v) for v in msgs]
            if how == "batch":
                assert target.deliver_batch(items) == len(items)
            else:
                assert all(target.deliver(f, v) for f, v in items)
            queued = [(m.topic, m.qos, m.payload)
                      for m in ch.session.mqueue.to_list()]
            rows.append(([(type(p).__name__, p.topic, p.qos, p.packet_id,
                           p.payload) for p in sent], queued,
                         ch.session.deliver_count))
        assert rows[0] == rows[1]
        out[name] = rows[0]
    assert out["ref"] == out["port"]
    sent, queued, _n = out["port"]
    assert (len(queued), len(sent)) == ((4, 0) if parked else (0, 4))


def test_blocked_lane_stalls_admit_without_dropping():
    """With the lanes paused (a blocked lane), admit() blocks once more
    than `depth` plans are outstanding; nothing is dropped, and resuming
    delivers every row and releases admit."""
    sink = Sink()
    broker = SimpleNamespace(_subscribers={5: sink}, _sub_meta={5: "s"})
    m = TMetrics()

    async def go():
        pool = TD.DeliveryLanePool(broker, m, n_lanes=2, depth=2)
        pool.ensure_loop()
        pool.pause()
        plans = []
        for k in range(5):
            msgs = [TM.make("p", 0, f"t/{k}", b"")]
            plan = pool.new_plan(msgs)
            plan.add_rows([0], [5], [0], [0], ["t/+"])
            plan.register_fast([0])
            pool.submit(plan)
            plans.append(plan)
        admit = asyncio.ensure_future(pool.admit())
        await asyncio.sleep(0.2)
        stalled = not admit.done() and not any(p.done for p in plans)
        waits = m.val("pipeline.deliver.backpressure_waits")
        depth = pool.state()["lane_depth"]
        pool.resume()
        await asyncio.wait_for(admit, TIMEOUT_S)
        await asyncio.wait_for(pool.drain(), TIMEOUT_S)
        return stalled, waits, depth, plans

    stalled, waits, depth, plans = asyncio.run(go())
    assert stalled and waits == 1 and depth >= 1
    assert [g[1] for g in sink.got] == [f"t/{k}" for k in range(5)]
    assert all(p.done and list(p.counts) == [1] for p in plans)
    assert m.val("messages.delivered") == 5


def test_batcher_futures_resolve_after_lane_completion():
    """Publishes routed by the device engine with the lanes paused: no
    publisher future resolves until the lanes run, then every count is
    the host route's, delivered once."""

    async def go():
        node = TNode({"broker": {"max_publish_batch": 64}}, device="cpu")
        eng = node.device_engine
        node.publish_batcher._device_worth_it = lambda: True
        sinks = [Sink() for _ in range(4)]
        for i, s in enumerate(sinks):
            node.broker.register(s, f"c{i}")
        for i in range(40):
            node.broker.subscribe(i % 4, f"t/{i}/+", {"qos": 0})
            node.broker.subscribe((i + 1) % 4, f"t/{i}/#", {"qos": 1})
        eng.rebuild()
        eng._warm_compile((eng._built, eng._tables, eng._cursors))
        pool = node.deliver_lanes
        pool.ensure_loop()
        pool.pause()
        futs = [asyncio.ensure_future(node.publish_async(
            TM.make("p", 0, f"t/{k % 45}/x", b"%d" % k)))
            for k in range(200)]
        for _ in range(200):
            await asyncio.sleep(0.01)
            if pool.state()["live_plans"]:
                break
        await asyncio.sleep(0.1)
        early = sum(f.done() for f in futs)
        live = pool.state()["live_plans"]
        pool.resume()
        got = await asyncio.wait_for(asyncio.gather(*futs), TIMEOUT_S)
        await node.publish_batcher.stop()
        node.publish_batcher.close()
        return node, early, live, got, sinks

    node, early, live, got, sinks = asyncio.run(
        asyncio.wait_for(go(), TIMEOUT_S))
    assert live > 0 and early == 0
    assert got == [2 if k % 45 < 40 else 0 for k in range(200)]
    assert sum(len(s.got) for s in sinks) == sum(got)
    m = node.metrics
    assert m.val("pipeline.deliver.rows") > 0
    assert m.val("routing.device.batches") >= 1
    assert m.val("routing.host.messages") == 0
