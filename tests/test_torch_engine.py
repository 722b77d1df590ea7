"""Port vs JAX reference: DeviceRouteEngine's window protocol.

Twin engines — a JAX ``Node(config, use_device=True)`` with the layers the
port does not have switched off (no supervision, ledger, tracing, latency
observatory or overload governor, inline delivery, per-packet ingress, CSR
readback on) and each routing-layer configuration (``LAYERS``: all off;
dedup + match cache; dedup + cache + delta overlay; and the reference's
full default, dedup + cache + overlay + subscription covering — each given
to both nodes explicitly; and that default again with both nodes
supervised, as each package's default node is), and the port's
``Node(device="cpu")`` with the same layers — get the same sessions and
the same ~500 subscriptions (plain and ``$share``) through
``broker.subscribe``, then the same message windows
through ``prepare_window`` / ``dispatch`` / ``materialize`` /
``finish_sub``. The ``rich`` cases run the full default with sinks that
nack every fifth delivery, subopts carrying ``nl``/``rap``/``rh`` and
subscription ids, and ``device_fanout_cap`` 8 / ``device_slot_cap`` 2 with
up to 11 subscribers a filter, so that the fan-out and slot overflows send
messages to the host path. Required exactly equal, under each of the five shared
strategies and on both backends (shape-hash, and the trie forced by more
distinct shapes than ``shape_cap``):

- every session's delivery list (filter, topic, message, subopts), shared
  picks included;
- the device cursors and the host groups' cursors after every window;
- the per-message delivery counts;

through subscribe/unsubscribe churn that dirties filters and slots, a
group added to a built filter, filters added past the snapshot (the host
delta ``HostTrie`` route, or the overlay), churn while windows are in
flight, and an explicit ``rebuild()``; with the layers on, the overlay's
rows, the cached windows, the cold gates and the cache's accounting are
equal too, and with covering the cover state and its counters (the
append path included: post-snapshot filters a built root covers). At dispatch
depth 2 the port splits each window of several batches into two windows
and dispatches both before it reads either back (two in flight, as the
batcher's settle ring runs them); windows alternate between the dense and
the CSR readback.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker.node import Node as TNode
from tests.test_trie_match import rand_filter, rand_topic

torch.set_num_threads(1)

STRATEGIES = ("round_robin", "random", "hash_topic", "hash_clientid",
              "sticky")
N_SESSIONS = 40

# the reference's routing layers, each configuration given to both nodes:
# all off (the path of the first broker slice), dedup + match cache,
# dedup + cache + delta overlay, and the reference's full default (with
# subscription covering); "rich" is the full default with nacking sinks,
# rich subopts and small fan-out/slot caps (RICH)
LAYERS = {
    "off": {"topic_dedup": False, "match_cache_size": 0,
            "delta_overlay": False, "subscription_covering": False},
    "cache": {"topic_dedup": True, "match_cache_size": 8192,
              "delta_overlay": False, "subscription_covering": False},
    "overlay": {"topic_dedup": True, "match_cache_size": 8192,
                "delta_overlay": True, "subscription_covering": False},
    "full": {"topic_dedup": True, "match_cache_size": 8192,
             "delta_overlay": True, "subscription_covering": True},
}
LAYERS["rich"] = dict(LAYERS["full"], device_fanout_cap=8,
                      device_slot_cap=2)
RICH = ("rich",)
# the reference's full default with its supervision on too: the JAX node
# at its default against the port's default (supervised)
LAYERS["supervised"] = dict(LAYERS["full"], supervise=True)
# the reference's full default with the dense readback (compact_readback
# off: every window reads its dense planes back)
LAYERS["dense"] = dict(LAYERS["full"], compact_readback=False)

# the reference path: every layer the port lacks off
JAX_BROKER = {
    "topic_dedup": False, "match_cache_size": 0, "delta_overlay": False,
    "subscription_covering": False, "supervise": False,
    "hbm_ledger": False, "trace": False, "latency_observatory": False,
    "overload": False, "deliver_lanes": 0, "columnar_ingress": False,
    "compact_readback": True, "dispatch_depth": 1,
}


class Sink:
    """A session stand-in: records every delivery in arrival order."""

    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        so = msg.headers.get("subopts") or {}
        self.got.append((topic_filter, msg.topic, msg.payload,
                         tuple(sorted(so.items()))))
        return True


class NackSink(Sink):
    """A session stand-in that refuses every fifth delivery offered."""

    def deliver(self, topic_filter, msg):
        super().deliver(topic_filter, msg)
        ok = len(self.got) % 5 != 0
        self.got[-1] += (ok,)
        return ok


def shapes_population(rng):
    """~500 filters over a handful of shapes (the shape-hash backend)."""
    subs = []
    for i in range(12):
        for n in range(12):
            subs.append(f"dev/d{i}/+/n{n}/#")
            if (i + n) % 3 == 0:
                subs.append(f"$share/g{(i * n) % 3}/dev/d{i}/+/n{n}/#")
    for i in range(60):
        subs.append(f"s/{i}/t")
        subs.append(f"s/{i}/+")
        if i % 4 == 0:
            subs.append(f"$share/q/s/{i}/t")
    subs += ["s/#", "$share/all/s/+/t", "$SYS/#", "#"]
    return subs


def trie_population(rng):
    """~500 filters over more shapes than shape_cap (the trie backend)."""
    fs = sorted({rand_filter(rng) for _ in range(420)})
    subs = list(fs)
    subs += [f"$share/g{k % 3}/{f}" for k, f in enumerate(fs) if k % 5 == 0]
    return subs


def shapes_topics(rng, n):
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.6:
            out.append(f"dev/d{rng.randrange(14)}/x/n{rng.randrange(14)}"
                       + "/t" * rng.randrange(3))
        elif r < 0.9:
            out.append(f"s/{rng.randrange(64)}/t")
        else:
            out.append(rng.choice(["$SYS/x", "none", "a/" * 20 + "deep"]))
    return out


class Twin:
    def __init__(self, strategy, depth, population, topics, layers="off"):
        self.rng = random.Random(11)
        self.topics = topics
        self.depth = depth
        self.rich = layers in RICH
        self.split = False      # the port has split a window in two
        self.j = JNode({"broker": dict(
            JAX_BROKER, **LAYERS[layers],
            shared_subscription_strategy=strategy)}, use_device=True)
        self.t = TNode({"broker": dict(
            LAYERS[layers], shared_subscription_strategy=strategy,
            dispatch_depth=depth)}, device="cpu")
        sink = NackSink if self.rich else Sink
        self.sinks = ([sink() for _ in range(N_SESSIONS)],
                      [sink() for _ in range(N_SESSIONS)])
        for node, sinks in zip((self.j, self.t), self.sinks):
            for i, s in enumerate(sinks):
                assert node.broker.register(s, f"c{i}") == i
        for k, f in enumerate(population):
            # each filter to 1-3 sessions (1-11 rich: past the fan-out
            # and slot caps); shared groups get 2-3 members (up to 11)
            n = self.rng.randrange(1, 12 if self.rich else 4)
            for sid in self.rng.sample(range(N_SESSIONS), n):
                self.subscribe(sid, f, self.opts(k, sid))

    def opts(self, k, sid):
        opts = {"qos": (k + sid) % 3}
        if self.rich:
            if (k + sid) % 4 == 0:
                opts.update(nl=1, rap=1, rh=(k % 3))
            if (k + sid) % 7 == 0:
                opts["subid"] = 1 + k % 5
        return opts

    def subscribe(self, sid, f, opts):
        for node in (self.j, self.t):
            node.broker.subscribe(sid, f, dict(opts))

    def unsubscribe(self, sid, f):
        for node in (self.j, self.t):
            node.broker.unsubscribe(sid, f)

    def window(self, n_batches, gate_cold=True, mid=None, n=30):
        """One window of n_batches through both engines; the same Message
        objects go to both (the random strategy hashes their ids).
        ``mid(node)`` runs on each node between its dispatches and their
        readback: churn while the windows are in flight."""
        lives = [[jmake(f"p{self.rng.randrange(5)}", 0, t, b"%d" % k)
                  for k, t in enumerate(self.topics(self.rng, n))]
                 for _ in range(n_batches)]
        seed = self.rng.randrange(1 << 30)
        counts = []
        for node in (self.j, self.t):
            eng = node.device_engine
            random.seed(seed)      # the host pick path's random draws
            parts = [lives]
            if node is self.t and self.depth > 1 and len(lives) > 1:
                parts = [lives[:len(lives) // 2], lives[len(lives) // 2:]]
                self.split = True
            hs = []
            for part in parts:
                h = eng.prepare_window(part, gate_cold=gate_cold)
                assert h is not None
                eng.dispatch(h)
                hs.append(h)
            if mid is not None:
                mid(node)
            got = []
            for h, part in zip(hs, parts):
                eng.materialize(h)
                got += [eng.finish_sub(h, k) for k in range(len(part))]
            counts.append(got)
        assert counts[0] == counts[1]
        self.check()
        return counts[1]

    def check(self):
        jg, tg = ([s.got for s in sinks] for sinks in self.sinks)
        assert jg == tg
        je, te = self.j.device_engine, self.t.device_engine
        assert np.array_equal(np.asarray(je._cursors),
                              te._cursors.cpu().numpy())
        for f, groups in self.j.broker.shared.items():
            tgroups = self.t.broker.shared[f]
            for g, grp in groups.items():
                assert (grp.cursor, grp.sticky) == \
                    (tgroups[g].cursor, tgroups[g].sticky)
        assert te._outstanding == 0 and je._outstanding == 0

    def churn(self):
        """Dirty filters and slots, a new group on a built filter, a
        post-snapshot filter, then windows against the stale snapshot."""
        je, te = self.j.device_engine, self.t.device_engine
        plain = sorted(f for f in self.t.broker.subs)
        shared = sorted((f, g) for f, gs in self.t.broker.shared.items()
                        for g in gs)
        self.subscribe(3, plain[5], self.opts(5, 3))        # dirty filter
        sid = next(iter(self.t.broker.subs[plain[9]]))
        self.unsubscribe(sid, plain[9])                     # dirty filter
        f, g = shared[1]
        self.subscribe(7, f"$share/{g}/{f}", {"qos": 0})    # dirty slot
        self.subscribe(8, f"$share/new/{plain[12]}", {"qos": 1})  # new group
        self.subscribe(9, "zz/+/late", self.opts(2, 9))  # delta filter
        self.subscribe(10, f"$share/dz/{plain[20]}", {"qos": 0})
        assert te.dirty_filters == je.dirty_filters
        assert te.dirty_slots == je.dirty_slots
        assert te.new_slots_by_filter == je.new_slots_by_filter
        assert set(te._delta_filter.values()) == set(je._delta_filter.values())

    def check_layers(self):
        """The layers ran alike on both engines: the same overlay rows and
        class, cover state and append counters and, where both ran the
        same windows (depth 1), the same cached windows, cold gates,
        covered windows and cache accounting."""
        je, te = self.j.device_engine, self.t.device_engine
        jo, to = je._overlay, te._overlay
        assert (jo is None) == (to is None)
        if jo is not None:
            assert (jo.row_of, jo.seg_of, jo.hostfan, jo.cap, jo.n) == \
                (to.row_of, to.seg_of, to.hostfan, to.cap, to.n)
        js, ts = je.stats(), te.stats()
        assert (js["backend"], js["subscription_covering"], js["cover"]) \
            == (ts["backend"], ts["subscription_covering"], ts["cover"])
        assert te._cover_churn == je._cover_churn
        for key in ("routing.cover.appends", "routing.cover.append_rejects"):
            assert self.t.metrics.val(key) == self.j.metrics.val(key), key
        if self.depth > 1:
            return      # the port split its windows: other counts
        for name in ("cached_windows", "cold_cached_class",
                     "cold_delta_class", "host_delta", "delta_applies",
                     "host_fallback"):
            key = f"routing.device.{name}"
            assert self.t.metrics.val(key) == self.j.metrics.val(key), key
        for key in ("pipeline.cover.windows",
                    "pipeline.cover.filters_skipped"):
            if not self.split:      # a split window counts twice
                assert self.t.metrics.val(key) == self.j.metrics.val(key), \
                    key
        jc, tc = je._match_cache, te._match_cache
        assert (jc is None) == (tc is None)
        if jc is not None:
            js, ts = jc.stats(), tc.stats()
            for k in ("size", "hits", "misses", "delta_version",
                      "delta_invalidated"):
                assert js[k] == ts[k], k


def _mid_churn(node):
    """A subscribe to a new filter and an unsubscribe while a window is in
    flight (the same on both nodes)."""
    b = node.broker
    b.subscribe(11, "s/7/+/late", {"qos": 1})
    b.subscribe(12, "dev/d3/x/n4/#", {"qos": 0})
    b.unsubscribe(12, "dev/d3/x/n4/#")


def _twin_shapes(layers, strategy, depth):
    twin = Twin(strategy, depth, shapes_population(random.Random(3)),
                shapes_topics, layers)
    for k in range(3):
        twin.window(1 + 3 * k, gate_cold=bool(k % 2))
    assert twin.t.device_engine._built.backend == "shapes"
    assert twin.j.device_engine._built.backend == "shapes"
    twin.churn()
    twin.topics = lambda rng, n: shapes_topics(rng, n - 2) + [
        "zz/a/late", f"s/{rng.randrange(60)}/t"]
    for k in range(2):
        twin.window(2, gate_cold=bool(k))
    if layers != "off":
        twin.window(3, gate_cold=False, mid=_mid_churn)
        twin.window(4, gate_cold=False)
        twin.window(4)
    twin.check_layers()
    for node in (twin.j, twin.t):
        node.device_engine.rebuild()
    for k in range(2):
        twin.window(1 + k, gate_cold=bool(k))
    assert twin.t.device_engine.stats()["delta_filters"] == 0
    assert twin.t.metrics.val("messages.routed.device") > 0
    twin.check_layers()
    return twin


def _twin_trie(layers, strategy):
    twin = Twin(strategy, 1, trie_population(random.Random(5)),
                lambda rng, n: [rand_topic(rng) for _ in range(n)], layers)
    twin.window(1, gate_cold=False)
    # covering may match the roots on the shape tables (they fit the
    # shape cap where the full set does not), as the reference does
    covering = LAYERS[layers]["subscription_covering"]
    want = twin.j.device_engine._built.backend if covering else "trie"
    assert twin.t.device_engine._built.backend == want
    assert twin.j.device_engine._built.backend == "trie" or covering
    twin.window(1)
    twin.window(2)           # a multi-batch trie window: sequential steps
    twin.depth = 2
    twin.window(4)           # two such windows in flight on the port
    twin.churn()
    twin.window(1, gate_cold=False)
    if layers != "off":
        twin.depth = 1
        topics = twin.topics
        # duplicate-heavy batches of 150: the miss class (64) falls below
        # the batch class (256), so the dedup plan engages on the trie
        hot = [rand_topic(twin.rng) for _ in range(12)] + ["zz/q/late"]
        twin.topics = lambda rng, n: [rng.choice(hot) for _ in range(n)]
        twin.window(1, gate_cold=False, mid=_mid_churn, n=150)
        twin.window(1, gate_cold=False, n=150)
        twin.window(1, n=150)
        twin.topics = topics
        twin.window(1, gate_cold=False)
        assert twin.t.metrics.val("routing.device.cached_windows") > 0
    twin.check_layers()
    for node in (twin.j, twin.t):
        node.device_engine.rebuild()
    twin.window(1)
    twin.check_layers()
    return twin


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_twin_shapes(strategy, depth):
    """Every routing layer off."""
    _twin_shapes("off", strategy, depth)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_twin_trie(strategy):
    """Every routing layer off."""
    _twin_trie("off", strategy)


@pytest.mark.parametrize("layers", ["cache", "overlay", "full", "rich"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_twin_shapes_layers(layers, strategy, depth):
    """Dedup + match cache, with the delta overlay too, and the
    reference's full default with covering (also with nacking sinks,
    rich subopts and overflowing caps): the same deliveries, picks,
    cursors, counts and layer accounting, with churn between and during
    windows."""
    twin = _twin_shapes(layers, strategy, depth)
    m = twin.t.metrics
    assert m.val("routing.device.cached_windows") > 0
    if layers == "overlay":
        assert m.val("routing.device.delta_applies") > 0
    if layers in ("full",) + RICH:
        assert twin.t.device_engine.stats()["cover"]["covered"] > 0
        assert m.val("routing.cover.appends") > 0
        assert m.val("pipeline.cover.windows") > 0
    if layers in RICH and depth == 1:
        assert m.val("routing.device.host_fallback") > 0


@pytest.mark.parametrize("layers", ["cache", "overlay", "full", "rich"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_twin_trie_layers(layers, strategy):
    twin = _twin_trie(layers, strategy)
    if layers == "overlay":
        assert twin.t.metrics.val("routing.device.delta_applies") > 0
    if layers in ("full",) + RICH:
        assert twin.t.device_engine.stats()["cover"] is not None


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backend", ["shapes", "trie"])
def test_engine_twin_supervised(backend, strategy):
    """Both nodes supervised, as each package's default node is, fault-free:
    the same deliveries, picks, cursors and counts as every case above,
    with the supervisor's gates read on every window and nothing noted."""
    twin = _twin_shapes("supervised", strategy, 1) if backend == "shapes" \
        else _twin_trie("supervised", strategy)
    for node in (twin.j, twin.t):
        sup = node.supervisor
        assert sup is not None and node.device_engine.sup is sup
        assert sup.rung() == 0 and sup.journal_depth() == 0
        for k in ("faults", "replays", "stalls", "trips"):
            assert node.metrics.val(f"supervise.{k}") == 0, k
    assert twin.t.metrics.val("routing.device.cached_windows") > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backend", ["shapes", "trie"])
def test_engine_twin_dense(backend, strategy):
    """``compact_readback: false`` on both engines (the reference's A/B
    baseline): the same deliveries, picks, cursors and counts as every
    case above; every window reads back dense — the same windows and
    bytes as the reference's where the port split none — and no payload
    class is chosen, warmed or left cold."""
    twin = _twin_shapes("dense", strategy, 1) if backend == "shapes" \
        else _twin_trie("dense", strategy)
    te = twin.t.device_engine
    assert te.compact_readback is False \
        and twin.j.device_engine.compact_readback is False
    assert te._choose_payload_cap(64) is None
    assert all(c[-1] is None for c in te._wanted)
    assert not any(str(k[-1]).startswith("c") for k in te._warm_classes)
    keys = ["pipeline.readback.windows.compact",
            "pipeline.readback.bytes.compact",
            "routing.device.cold_compact_class",
            "routing.device.compact_overflow"]
    if not twin.split:      # a split window reads back twice
        keys += ["pipeline.readback.windows.dense",
                 "pipeline.readback.bytes.dense"]
    for key in keys:
        assert twin.t.metrics.val(key) == twin.j.metrics.val(key), key
    assert twin.t.metrics.val("pipeline.readback.windows.dense") > 0
    assert twin.t.metrics.val("pipeline.readback.windows.compact") == 0
    assert twin.t.metrics.val("routing.device.cold_compact_class") == 0
    assert te.stats()["compact_readback"] is False


def test_route_batch_counts_match_host_path():
    """route_batch (the sync composition) delivers exactly what the host
    per-message path delivers, message for message."""
    rng = random.Random(1)
    pop = shapes_population(rng)
    dev, host = (Twin("round_robin", 1, pop, shapes_topics)
                 for _ in range(2))
    msgs = [jmake("p", 0, t, b"") for t in shapes_topics(rng, 200)]
    got = dev.t.device_engine.route_batch(msgs)
    want = [host.t.broker._route(m, host.t.router.match(m.topic))
            for m in msgs]
    assert got == want
    assert dev.t.metrics.val("routing.device.batches") == 1
