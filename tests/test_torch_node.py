"""Port vs JAX reference: the broker serving over real sockets.

Both Nodes — the JAX package's ``Node(config, use_device=True)`` on the
path this slice ports, and the port's ``Node(device="cpu")`` at dispatch
depth 1 and 2 — serve over TCP on 127.0.0.1 at a small size of
``chip_smoke.py``'s phase 8 population (~2,000 filters
``device/d{i}/+/n{n}/#``, half of them in 2-member ``$share`` groups, 4
subscriber and 2 publisher connections, every 4th publish at QoS 1).
Required: every message delivered exactly once to a connection holding
its filter, per-publisher order at every subscriber, and equal delivered
multisets for the plain subscriptions. ``test_chip_smoke_e2e_on_cpu``
rehearses phase 8 itself at a reduced size.
"""

import asyncio
import os
import time

import pytest
import torch

import chip_smoke as cs
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.node import Node as TNode
from tests.test_torch_engine import JAX_BROKER

torch.set_num_threads(1)

N_FILTERS, N_SUB, N_PUB, N_MSGS = 2000, 4, 2, 500
TIMEOUT_S = 120


async def serve(node, listener_cls) -> dict:
    """Subscribe the population and flood it through one node."""
    lst = listener_cls(node, bind="127.0.0.1", port=0)
    await lst.start()
    clients = []
    try:
        subs, ids, nums, _n, _e = await cs._subscribe_population(
            lst.port, N_FILTERS, N_SUB)
        clients += subs
        from emqx_tpu_torch.client import Client
        for c in range(N_PUB):
            cl = Client(port=lst.port, clientid=f"epub{c}")
            await cl.connect()
            clients.append(cl)
        f = await cs._flood(node, subs, clients[N_SUB:], ids, nums, N_MSGS,
                            cs.SEED)
        f["nums"] = nums
        return f
    finally:
        for cl in clients:
            await cl.disconnect()
        await lst.stop()
        await node.publish_batcher.stop()
        node.publish_batcher.close()


def run(node, listener_cls) -> dict:
    return asyncio.run(asyncio.wait_for(serve(node, listener_cls),
                                        TIMEOUT_S))


def plain_multisets(f) -> list:
    """Per subscriber connection: the sorted (publisher, seq) pairs it
    received for plain (non-shared) filters."""
    return [sorted((p, s) for p, s, i, n, _q in rows
                   if not cs.e2e_shared(i, n, f["nums"]))
            for rows in f["got"]]


@pytest.fixture(scope="module")
def jax_flood():
    node = JNode({"broker": JAX_BROKER}, use_device=True)
    return run(node, JListener)


@pytest.mark.parametrize("depth", [1, 2])
def test_live_tcp_twin(jax_flood, depth):
    f = run(TNode({"broker": {"dispatch_depth": depth}}, device="cpu"),
            TListener)
    # _flood raises on a lost, duplicated, misrouted or reordered delivery
    assert f["delivered"] == f["sent"] == N_MSGS
    assert jax_flood["delivered"] == N_MSGS
    assert plain_multisets(f) == plain_multisets(jax_flood)
    assert any(plain_multisets(f))


def test_chip_smoke_e2e_on_cpu():
    """chip_smoke.py's phase 8 rehearsed on the CPU at a reduced size:
    the TCP population, the bench warm-up, floods at dispatch depth 2 and
    1 with the delivery lanes on and at depth 2 with them off, on the
    same node, and the engine window held against the plain path. On the
    CPU the host path wins the adaptive chooser, so the rehearsal pins it
    to the device to drive the device path; the kernel launch counts stay
    0 here. The lanes floods hand their deliveries to the lanes, the
    inline one does not, and the ledger accounts the engine's tables. The
    traced floods' device windows carry their spans in the flight
    recorder and the observatory's samples equal the flood's stamped
    PUBLISHes by QoS (e2e_drive raises otherwise); the untraced flood
    records nothing."""
    r = cs.e2e_drive(torch.device("cpu"), n_filters=1000, n_sub=4,
                     n_pub=2, total=400, window=(2, 64), pin_device=True)
    assert r["backend"] == "shapes" and r["window_err"] == 0
    assert set(r["floods"]) == {"d2", "d1", "d2-inline", "d2-untraced"}
    for label, f in r["floods"].items():
        assert f["traced"] == (label != "d2-untraced")
        if f["traced"]:
            assert f["trace"]["device_windows"] > 0
            assert f["trace"]["overlap"] is not None
            assert sum(v["count"] for v in f["latency"]["routed"].values()) \
                == 400
        else:
            assert f["trace"] is None and f["latency"] is None
    assert r["columnar_ingress"] is True
    for f in r["floods"].values():
        assert f["delivered"] == f["sent"] == 400
        assert f["ingress"]["received"] == 400
        assert f["batches"] >= 1
        assert f["launches"]["shape_match"] == 0
        assert (f["lane_rows"] > 0) == f["lanes_on"]
        assert (f["lane_items"] > 0) == f["lanes_on"]
        stages = f["telemetry"]["stages"]
        assert stages["deliver"]["count"] >= f["batches"]
    assert r["ledger"]["by_category"]["snapshot_tables"] > 0
    assert r["ledger"]["accounted_fraction"] is None     # no card here


def test_chip_smoke_trace_cost_on_cpu():
    """chip_smoke.py's ``--trace-cost`` rehearsed on the CPU at a reduced
    size, one round: the four layer settings, each flood at depth 2 with
    the lanes on one node and e2e_drive's checks passing; the recorder
    records only in the "on" and "quiet" floods, the observatory samples
    every PUBLISH in all but "off", and nothing breaches the "quiet"
    flood's raised objective (e2e_drive raises otherwise)."""
    runs = cs.trace_cost_runs(2)
    assert [r[3] for r in runs] == ["on", "off", "quiet", "obs",
                                    "off", "quiet", "obs", "on"]
    by = cs.trace_cost(torch.device("cpu"), rounds=1, n_filters=1000,
                       n_sub=4, n_pub=2, total=400, window=(2, 64),
                       pin_device=True)
    assert set(by) == set(cs.TRACE_LAYERS)
    for layers, row in by.items():
        assert row["labels"] == [f"d2-{layers}-1"]
        assert row["per_sec"][0] > 0
        assert set(row["stage_us"][0]) >= {"readback", "consume"}
        assert (row["spans"][0] > 0) == (layers in ("on", "quiet"))


def test_chip_smoke_overload_on_cpu(monkeypatch):
    """chip_smoke.py's phase 12 rehearsed on the CPU at a reduced size (8
    connections, 8,000 PUBLISHes each, a warm pass of 300 each): the
    governed twin's warm pass sets the paced rate (twice its sustained
    msgs/s), the ungoverned twin floods at the same rate; both deliver
    every accepted QoS 1 PUBLISH in publisher order, only the governed
    one sheds (QoS 0 only) and it recovers to normal with nothing
    armed (check_overload_pair raises otherwise); each twin's two windows
    of the flood's topics equal the plain path. Whether this host's
    flood drives its own signals to critical depends on its timing, so
    the rehearsal adds a queue fill of 0.95 to the governor's readings
    for the first 1.5 s of polls; the card's run reads the real ones."""
    from emqx_tpu_torch.broker.overload import OverloadGovernor
    real = OverloadGovernor.sample_signals

    def forced(self):
        sig = real(self)
        t0 = self.__dict__.setdefault("_forced_t0", time.monotonic())
        if time.monotonic() - t0 < 1.5:
            sig["queue_fill"] = max(sig.get("queue_fill", 0.0), 0.95)
        return sig

    monkeypatch.setattr(OverloadGovernor, "sample_signals", forced)
    kw = dict(conns=8, n_msgs=8000, warm_msgs=300, flood_s=6)
    on = cs.overload_one("cpu", True, None, **kw)
    off = cs.overload_one("cpu", False, on["rate"], **kw)
    cs.check_overload_pair(on, off, cuda=False)
    assert on["rate"] == off["rate"] > on["warm_msgs_per_s"]
    assert "critical" in [g for _t, g in on["timeline"]]
    # an offender disconnect leaves the rest of a flooder's rows unsent
    assert on["qos0_delivered"] + on["qos0_shed"] <= on["qos0_sent"]
    if not on["disconnects"]:
        assert on["qos0_delivered"] + on["qos0_shed"] == on["qos0_sent"]
    assert off["qos0_delivered"] == off["qos0_sent"]
    assert off["timeline"] == [] and off["overload"] is None
    for r in (on, off):
        assert r["hold_err"] == 0
        assert r["windows"]["device"] > 0


def _flaky_drive(depth: int, fatal: bool):
    """600 publishes through the batcher with the engine's dispatch on the
    loop (``dispatch_on_loop``, as on the card) and its second dispatch
    raising. ``fatal`` is the engine's ``fail_on_device_error`` (the
    card's setting). Returns the node, each publish's count or error, and
    the counts the host route gives."""
    from emqx_tpu_torch.broker.message import make

    class Sink:
        def deliver(self, f, m):
            return True

    async def go():
        node = TNode({"broker": {"dispatch_depth": depth,
                                 "max_publish_batch": 64}}, device="cpu")
        eng = node.device_engine
        eng.dispatch_on_loop = True
        eng.fail_on_device_error = fatal
        node.publish_batcher._device_worth_it = lambda: True
        sids = [node.broker.register(Sink(), f"c{i}") for i in range(4)]
        for i in range(40):
            node.broker.subscribe(sids[i % 4], f"t/{i}/+", {"qos": 0})
            node.broker.subscribe(sids[(i + 1) % 4], f"$share/g/t/{i}/#",
                                  {"qos": 1})
        eng.rebuild()
        eng._warm_compile((eng._built, eng._tables, eng._cursors))
        topics = [f"t/{k % 45}/x" for k in range(600)]
        want = [2 if k % 45 < 40 else 0 for k in range(600)]
        calls = [0]
        real = eng.dispatch

        def flaky(h):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected")
            real(h)

        eng.dispatch = flaky
        got = await asyncio.gather(*[node.publish_async(make("p", 0, t, b""))
                                     for t in topics],
                                   return_exceptions=True)
        await node.publish_batcher.stop()
        node.publish_batcher.close()
        return node, got, want

    return asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatch_on_the_loop(depth):
    """The batcher path the card takes, driven on the CPU: every count
    equals the host route's, and a dispatch that raises fails its
    window's publishers with the error — the window is not routed on the
    host."""
    node, got, want = _flaky_drive(depth, fatal=True)
    failed = [k for k, g in enumerate(got) if isinstance(g, Exception)]
    assert failed
    assert all(str(got[k]) == "injected" for k in failed)
    assert [g for k, g in enumerate(got) if k not in failed] \
        == [w for k, w in enumerate(want) if k not in failed]
    assert node.metrics.val("routing.device.batches") >= 1
    assert node.metrics.val("routing.device.dispatch_failed") == 1
    assert node.metrics.val("routing.host.messages") == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatch_failure_on_cpu_routes_on_host(depth):
    """On the CPU the reference's behaviour stands: a window whose
    dispatch raised is routed on the host, and every count is right."""
    node, got, want = _flaky_drive(depth, fatal=False)
    assert got == want
    assert node.metrics.val("routing.device.dispatch_failed") == 1
    assert node.metrics.val("routing.host.messages") >= 1


@pytest.mark.parametrize("fatal", [True, False])
def test_warm_failure(fatal):
    """A background class warm that raises: on the card (``fatal``) the
    engine keeps the error and every later publish raises it; on the CPU
    the classes stay cold and the batch is routed on the host."""
    from emqx_tpu_torch.broker.message import make

    class Sink:
        def deliver(self, f, m):
            return True

    async def go():
        node = TNode(device="cpu")
        eng = node.device_engine
        eng.fail_on_device_error = fatal
        sid = node.broker.register(Sink(), "c0")
        node.broker.subscribe(sid, "t/+", {"qos": 0})
        eng.rebuild()

        def boom(*_a):
            raise RuntimeError("warm")

        eng._warm_dispatch = boom
        eng._kick_class_warm()
        await eng._fuse_warm_task
        got = await asyncio.gather(
            *[node.publish_async(make("p", 0, "t/x", b""))
              for _ in range(8)], return_exceptions=True)
        await node.publish_batcher.stop()
        node.publish_batcher.close()
        return eng, got

    eng, got = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    if fatal:
        assert str(eng.failed) == "warm"
        assert all(isinstance(g, RuntimeError) for g in got)
    else:
        assert eng.failed is None and got == [1] * 8


def test_chooser_decisions_equal_the_reference():
    """The device/host chooser decides as the reference's does, with the
    bypass margin: the port keeps the device's estimate per message where
    the reference keeps it per batch, and over the same states — the
    reference's batch estimate taken at the batch size it decides for,
    and divided by the margin — both take the same decision and move the
    same probe counters, fusion width and bypass count."""
    from types import SimpleNamespace

    import numpy as np

    from emqx_tpu.broker.batcher import PublishBatcher as JBatcher
    from emqx_tpu.broker.metrics import Metrics as JMetrics
    from emqx_tpu_torch.broker.batcher import _BYPASS_MARGIN
    from emqx_tpu_torch.broker.batcher import PublishBatcher as TBatcher
    from emqx_tpu_torch.broker.metrics import Metrics as TMetrics

    j = JBatcher(SimpleNamespace(metrics=JMetrics()), None)
    t = TBatcher(SimpleNamespace(metrics=TMetrics()), None)
    rng = np.random.RandomState(cs.SEED)
    decisions = set()
    dev = None
    for step in range(3000):
        n = int(rng.randint(4, 1025))
        if step >= 2 and rng.rand() < 0.3:
            # new estimates: the device's around the host's, either side
            # of the margin
            host = float(rng.uniform(10e-6, 60e-6))
            dev = host * float(rng.uniform(0.5, 2 * _BYPASS_MARGIN))
            t._dev_msg_s = dev
            t._host_msg_s = j._host_msg_s = host
        if dev is not None:
            j._dev_batch_s = dev / _BYPASS_MARGIN * n
        t._fuse_cwnd = j._fuse_cwnd = int(rng.randint(1, 9))
        want = j._device_worth_it(n)
        assert t._device_worth_it() == want, step
        decisions.add(want)
        # the producer's counter updates after the decision
        for b in (j, t):
            if want:
                b._since_host_probe += 1
                b._since_probe = 0
            else:
                b._since_probe += 1
        if step == 0:
            dev = t._dev_msg_s = 30e-6
        for name in ("_since_probe", "_since_host_probe", "_fuse_cwnd"):
            assert getattr(t, name) == getattr(j, name), (step, name)
        assert t.node.metrics.val("routing.device.bypassed") \
            == j.node.metrics.val("routing.device.bypassed")
    assert decisions == {True, False}
    assert t.node.metrics.val("routing.device.bypassed") > 0
    t.close()
    j.close()


def test_chooser_twin_on_the_same_window_costs():
    """Both batchers fed the same device windows' costs and the same host
    estimate, then asked for the next window's decision: the reference
    through its own per-window sample (the window's cost, divided by the
    bypass margin as above), the port through ``_device_sample``.

    Full windows (max_batch messages each, costs either side of the
    margin, spikes included): both decide alike at every step and move
    the same probe counters and bypass count. A full window is one sample
    on both, and the port's seed (the median of its first three windows)
    equals the reference's first sample when the three agree.

    Burst tails (ROADMAP, "departs from the reference on purpose"): full
    windows at ~30 us a message alternate with windows of 67 messages at
    90 us, as the columnar ingress's bursts make them. Both keep every
    full window on the device. The reference's batch estimate, taken at
    the size it decides for, sends every tail to the host; the port pools
    each tail with the next window and keeps it on the device."""
    from types import SimpleNamespace

    import numpy as np

    from emqx_tpu.broker.batcher import PublishBatcher as JBatcher
    from emqx_tpu.broker.batcher import _ewma as jewma
    from emqx_tpu.broker.metrics import Metrics as JMetrics
    from emqx_tpu_torch.broker.batcher import _BYPASS_MARGIN
    from emqx_tpu_torch.broker.batcher import PublishBatcher as TBatcher
    from emqx_tpu_torch.broker.metrics import Metrics as TMetrics

    N, host = 1024, 30e-6

    def pair(probe_host: bool):
        j = JBatcher(SimpleNamespace(metrics=JMetrics()), None, max_batch=N)
        t = TBatcher(SimpleNamespace(metrics=TMetrics()), None, max_batch=N)
        j._host_msg_s = t._host_msg_s = host
        if not probe_host:
            j.host_probe_every = t.host_probe_every = 1 << 30
        return j, t

    def decide(j, t, n):
        got = j._device_worth_it(n), t._device_worth_it()
        for b, d in zip((j, t), got):     # the producer's counters
            if d:
                b._since_host_probe += 1
                b._since_probe = 0
            else:
                b._since_probe += 1
        return got

    def feed(j, t, n, cost):
        j._dev_batch_s, j._dev_spike = jewma(
            j._dev_batch_s, cost / _BYPASS_MARGIN, j._dev_spike)
        t._device_sample(cost, n)

    def bypassed(b):
        return b.node.metrics.val("routing.device.bypassed")

    rng = np.random.RandomState(cs.SEED)
    j, t = pair(probe_host=True)
    decisions = set()
    for step in range(2000):
        want, got = decide(j, t, N)
        assert got == want, step
        decisions.add(want)
        for name in ("_since_probe", "_since_host_probe"):
            assert getattr(t, name) == getattr(j, name), (step, name)
        per = host if step < 3 else host * float(
            rng.uniform(0.5, 2 * _BYPASS_MARGIN))
        if rng.rand() < 0.02:
            per *= 4                              # a spike
        feed(j, t, N, per * N)
    assert decisions == {True, False} and bypassed(t) == bypassed(j) > 0
    j.close()
    t.close()

    j, t = pair(probe_host=False)
    for _ in range(3):
        assert decide(j, t, N) == (True, True)
        feed(j, t, N, host * N)
    for _ in range(50):
        assert decide(j, t, N) == (True, True)
        feed(j, t, N, host * N * float(rng.uniform(0.9, 1.1)))
        assert decide(j, t, 67) == (False, True)
        feed(j, t, 67, 67 * 3 * host)
    assert bypassed(j) == 50 and bypassed(t) == 0
    assert t._dev_msg_s <= _BYPASS_MARGIN * host
    j.close()
    t.close()


def test_layer_defaults_are_the_references():
    """The port's Node serves with the reference's routing layers by
    default (dedup on, match cache 8192, delta overlay on, subscription
    covering on), as the JAX Node does, and turns each off by the same
    key."""
    t = TNode(device="cpu").device_engine
    j = JNode(use_device=True).device_engine
    assert (t.dedup, t._match_cache.capacity, t.delta_overlay,
            t.subscription_covering) == \
        (j.dedup, j._match_cache.capacity, j.delta_overlay,
         j.subscription_covering) == (True, 8192, True, True)
    off = TNode({"broker": {"topic_dedup": False, "match_cache_size": 0,
                            "delta_overlay": False}},
                device="cpu").device_engine
    assert (off.dedup, off._match_cache, off.delta_overlay) == \
        (False, None, False)
    only_dedup = TNode({"broker": {"match_cache_size": 0}},
                       device="cpu").device_engine
    assert only_dedup.dedup and only_dedup._match_cache is None


@pytest.mark.parametrize("key,value", [
    ("subscription_covering", True), ("supervise", True),
    ("hbm_ledger", True), ("trace", True), ("latency_observatory", True),
    ("overload", True), ("deliver_lanes", 4), ("columnar_ingress", True),
    ("compact_readback", False), ("device_route", False),
    ("multichip", {"enable": True, "devices": 8, "dp": 2})])
def test_unsupported_layer_raises(key, value):
    """A config that asks for a layer the port lacks is refused, not
    served without it; the same key set off is accepted. Subscription
    covering, supervision, the HBM ledger, the delivery lanes, columnar
    ingress, the flight recorder, the latency observatory and the
    overload governor, ported since, are accepted either way and reach
    the node: the supervisor reaches the batcher, the engine, the lanes,
    the governor (its journal_depth signal) and the telemetry (the
    supervise section), and off it is None everywhere. The mesh
    (``multichip``) builds the port's ShardedRouteServer behind a batcher
    of the reference's max_batch 256 (the twin of
    ``tests/test_multichip_serving.py:49``). The dense readback
    (``compact_readback: false``) is accepted and reaches either engine,
    whose payload chooser then reads back dense, as the reference's; the
    host-only node (``device_route: false``) is accepted and builds no
    engine and no batcher (its PUBLISH takes the host path), as the
    reference's."""
    if key == "supervise":
        for node in (TNode({"broker": {key: value}}, device="cpu"),
                     TNode(device="cpu")):
            sup = node.supervisor
            assert sup is not None
            assert node.publish_batcher.sup is sup
            assert node.device_engine.sup is sup
            assert node.deliver_lanes.sup is sup
            assert node.overload_governor.sample_signals()[
                "journal_depth"] == 0
            assert node.pipeline_telemetry.snapshot()["supervise"][
                "state"] == sup.state()
            assert sup.recorder is node.flight_recorder
        off = TNode({"broker": {key: not value}}, device="cpu")
        assert off.supervisor is None
        assert (off.publish_batcher.sup, off.device_engine.sup,
                off.deliver_lanes.sup) == (None, None, None)
        assert "journal_depth" not in \
            off.overload_governor.sample_signals()
        assert "supervise" not in off.pipeline_telemetry.snapshot()
        return
    if key == "subscription_covering":
        for v in (value, not value):
            eng = TNode({"broker": {key: v}}, device="cpu").device_engine
            assert eng.subscription_covering is v
        return
    if key == "hbm_ledger":
        on = TNode({"broker": {key: value}}, device="cpu")
        assert on.hbm_ledger is not None \
            and on.device_engine.ledger is on.hbm_ledger
        assert TNode({"broker": {key: not value}},
                     device="cpu").hbm_ledger is None
        return
    if key in ("trace", "latency_observatory", "overload"):
        attr = {"trace": "flight_recorder",
                "latency_observatory": "latency_observatory",
                "overload": "overload_governor"}[key]
        on = TNode({"broker": {key: value}}, device="cpu")
        assert getattr(on, attr) is not None \
            and getattr(TNode(device="cpu"), attr) is not None
        assert getattr(TNode({"broker": {key: not value}}, device="cpu"),
                       attr) is None
        return
    if key == "deliver_lanes":
        assert TNode({"broker": {key: value}},
                     device="cpu").deliver_lanes.n_lanes == value
        assert TNode({"broker": {key: 0}}, device="cpu").deliver_lanes \
            is None
        return
    if key == "multichip":
        from emqx_tpu_torch.parallel.serving import ShardedRouteServer
        node = TNode({"broker": {key: value}}, device="cpu")
        ref = JNode({"broker": {key: value}})
        eng = node.device_engine
        assert isinstance(eng, ShardedRouteServer)
        assert (eng.n_dp, eng.n_route) == (ref.device_engine.n_dp,
                                           ref.device_engine.n_route)
        assert node.publish_batcher.engine is eng
        assert node.publish_batcher.max_batch == \
            ref.publish_batcher.max_batch == 256
        assert eng.sup is node.supervisor \
            and eng.ledger is node.hbm_ledger
        dense = TNode({"broker": {key: value, "compact_readback": False}},
                      device="cpu").device_engine
        jdense = JNode({"broker": {key: value,
                                   "compact_readback": False}})
        assert dense.compact_readback is False \
            and jdense.device_engine.compact_readback is False
        assert dense._choose_pcap(64) is None \
            and jdense.device_engine._choose_pcap(64) is None
        assert eng.compact_readback is True
        assert not isinstance(TNode({"broker": {key: {"enable": False}}},
                                    device="cpu").device_engine,
                              ShardedRouteServer)
        return
    if key == "columnar_ingress":
        on = TNode({"broker": {key: value}}, device="cpu")
        assert on.columnar_ingress is True \
            and on.ingress_lanes == min(4, os.cpu_count() or 1)
        off = TNode({"broker": {key: not value, "ingress_lanes": 4}},
                    device="cpu")
        assert (off.columnar_ingress, off.ingress_lanes) == (False, 1)
        assert TNode(device="cpu").columnar_ingress is True
        return
    if key == "compact_readback":
        node = TNode({"broker": {key: value}}, device="cpu")
        ref = JNode({"broker": {key: value}}, use_device=True)
        for eng in (node.device_engine, ref.device_engine):
            assert eng.compact_readback is False
            eng.rebuild()
            assert eng._choose_payload_cap(64) is None
        assert TNode({"broker": {key: not value}}, device="cpu") \
            .device_engine.compact_readback is True
        assert TNode(device="cpu").device_engine.compact_readback is True
        return
    assert key == "device_route"
    node = TNode({"broker": {key: value}}, device="cpu")
    ref = JNode({"broker": {key: value}})
    for n in (node, ref):
        assert n.device_engine is None and n.publish_batcher is None
        assert n.router.use_device is False
        assert n.publish_nowait(None) is False
    assert (node.flight_recorder, node.supervisor, node.hbm_ledger,
            node.deliver_lanes) == (None, None, None, None)
    on = TNode({"broker": {key: not value}}, device="cpu")
    assert on.device_engine is not None and on.router.use_device
    TNode({"broker": JAX_BROKER}, device="cpu")


def test_chip_smoke_layers_on_cpu(monkeypatch):
    """chip_smoke.py's phase 9 rehearsed on the CPU at a reduced size
    (1,000 filters, 4 sessions, 4 windows of 8 sub-batches of 128 and 6
    churn batches per pass): node A at the reference's defaults, B with
    the layers off, and the host path agree on every count, every
    session's deliveries and the device cursors; A serves the skew as
    cached windows and the churn through the overlay (no host delta),
    and a cached and an overlay window equal the plain path."""
    monkeypatch.setattr(cs, "L_WINDOWS", 4)
    monkeypatch.setattr(cs, "L_B", 128)
    monkeypatch.setattr(cs, "C_BATCHES", 6)
    monkeypatch.setattr(cs, "L_WARM_WINDOWS", 6)
    r = cs.layers_drive(torch.device("cpu"), n_filters=1000, n_sub=4)
    sk, ch = r["skew"], r["churn"]
    assert sk["A"]["layers"]["cached_windows"] == 4
    assert sk["B"]["layers"]["cached_windows"] == 0
    assert sk["A"]["layers"]["hit_rate"] > 0
    assert ch["A"]["layers"]["host_delta"] == 0
    assert ch["B"]["layers"]["host_delta"] > 0
    assert ch["overlay_class"] == 128
    assert ch["hold_err"] == ch["hold_skew_err"] == 0


def test_chip_smoke_cover_on_cpu(monkeypatch):
    """chip_smoke.py's phase 10 rehearsed on the CPU with shrunk constants
    (cover-heavy populations of 600 and 1,500 filters, 3 batches of 128
    topics, one timed pass): node A (covering on) against B (off) — A
    builds cover state and B none, every covered window equals the plain
    path, A, B and the host path deliver identically on a route_batch,
    and a covered SUBSCRIBE lands as an append that the next window
    delivers as the off twin does."""
    monkeypatch.setattr(cs, "COVER_B", 128)
    monkeypatch.setattr(cs, "COVER_BATCHES", 3)
    monkeypatch.setattr(cs, "COVER_PASSES", 1)
    r = cs.cover_drive(torch.device("cpu"), cells=(600, 1500))
    for n, c in r.items():
        assert c["A"]["cover"]["covered"] > 0 and c["B"]["cover"] is None
        assert c["hold_err"] == 0 and c["delivered"] > 0
        assert c["stats_A"]["cover"]["appends"] == 1
        assert c["A"]["launches"] == {"shape_match": 0, "prefix_sum": 0,
                                      "ring_rotate": 0}
        assert c["A"]["topic_matches_per_s"] > 0
