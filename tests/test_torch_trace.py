"""Port vs JAX reference: the window-causal flight recorder.

The same inputs go through the reference (``emqx_tpu.broker.trace``, its
Node on the JAX CPU backend) and the port (``emqx_tpu_torch``, on
``device="cpu"``):

- the knobs, config only (the reference's environment knobs are unset);
- one record/event sequence made from a seed gives equal ring state,
  spans, ``dropped``, ``to_chrome`` and ``snapshot_section`` (the clock is
  a shared fake, so the timestamps agree too);
- ``analyze_spans`` and ``analyze_chrome`` are equal on the same spans;
- twin Nodes given one PUBLISH stream over TCP (columnar bursts, the
  chooser held on the device) record the same span names, tracks and
  parent structure per window, with trace ids renumbered by order of first
  appearance (ids are per-process counters);
- with ``trace`` off there is no recorder anywhere, and deliveries equal
  those with it on;
- a torch.profiler capture (``start_device_trace``) names each dispatch
  ``route_step#<trace id>`` of a trace the recorder holds;
- the reference's deterministic 3% overhead guard.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import trace as JT
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker import trace as TT
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import FrameParser, serialize

torch.set_num_threads(1)

SEED = 20261017
TIMEOUT_S = 120
ENV_KNOBS = ("EMQX_TPU_TRACE", "EMQX_TPU_TRACE_SAMPLE", "EMQX_TPU_LATENCY",
             "EMQX_TPU_SLO_ROUTE_P99_MS", "EMQX_TPU_OVERLOAD")

# the twin drive: 4 subscriber connections on t/{i}/+, one raw publisher
# writing BURSTS pre-serialized bursts of BURST_N PUBLISHes (every 4th at
# QoS 1) of PAYLOAD bytes: each burst is one read of > 4,096 bytes, so it
# decodes as one columnar PublishBurst and forms one window
N_SUB, BURSTS, BURST_N, PAYLOAD = 4, 6, 16, 300
TWIN_CONF = {"device_fanout_cap": 16, "device_slot_cap": 4,
             "device_min_batch": 4, "batch_window_us": 20000,
             "deliver_lanes": 2, "ingress_lanes": 1, "trace_sample": 1,
             "slo_route_p99_ms": 60000}


@pytest.fixture(autouse=True)
def _config_only(monkeypatch):
    """The reference's env knobs are not ported: only config decides."""
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, True, False, 0, 1, "x"])
def test_trace_knob_equals_reference(value):
    assert TT.resolve_trace(value) is JT.resolve_trace(value)


@pytest.mark.parametrize("value", [None, 0, 1, 17, "5"])
def test_trace_sample_knob_equals_reference(value):
    assert TT.resolve_trace_sample(value) == JT.resolve_trace_sample(value)


@pytest.mark.parametrize("value", [-1, "two"])
def test_trace_sample_malformed_raises_as_reference(value):
    for resolve in (TT.resolve_trace_sample, JT.resolve_trace_sample):
        with pytest.raises(ValueError):
            resolve(value)


# ---------------------------------------------------------------------
# the recorder, one seeded sequence through both
# ---------------------------------------------------------------------
class FakeClock:
    """A perf_counter both recorders read: steps of a seeded size."""

    def __init__(self, rng):
        self.rng = rng
        self.t = 100.0

    def __call__(self) -> float:
        self.t += float(self.rng.integers(1, 2000)) * 1e-6
        return self.t


NAMES = ("enqueue", "batch_form", "dispatch", "dispatch_cached",
         "materialize", "deliver", "host_route", "lane0", "lane1",
         "window", "message", "lane_admit", "settle")
TRACKS = ("batcher", "dispatch", "materialize", "consume", "lane0",
          "lane1", "window", "messages", "host")


def _sequence(rec, rng, clock, n_ops: int) -> list:
    """Drive `rec` with a seeded op sequence; returns what each op
    returned (ids and sampling decisions)."""
    out = []
    traces = [0]
    spans = [0]
    for _ in range(n_ops):
        op = int(rng.integers(10))
        if op == 0:
            tid = rec.new_trace()
            traces.append(tid)
            out.append(("trace", tid))
        elif op == 1:
            out.append(("event", rec.event(
                traces[int(rng.integers(len(traces)))],
                str(rng.choice(["replay", "fused", "slo_breach"])),
                parent=spans[int(rng.integers(len(spans)))],
                meta={"k": int(rng.integers(5))} if rng.random() < 0.5
                else None)))
        elif op == 2:
            out.append(("sample", rec.sample_hit()))
        else:
            t0 = clock()
            t1 = t0 + float(rng.integers(0, 3000)) * 1e-6
            sid = rec.record(
                traces[int(rng.integers(len(traces)))],
                str(rng.choice(NAMES)), t0, t1,
                track=str(rng.choice(TRACKS)),
                parent=spans[int(rng.integers(len(spans)))],
                meta={"batch": int(rng.integers(64))}
                if rng.random() < 0.3 else None)
            spans.append(sid)
            out.append(("span", sid))
    return out


def _fields(sp) -> tuple:
    return (sp.trace_id, sp.span_id, sp.parent_id, sp.name, sp.track,
            sp.t0, sp.t1, sp.meta, sp.slot, sp.dur)


def _twin_recorders(monkeypatch, cap, sample, seed):
    from emqx_tpu.broker.metrics import Metrics as JMetrics
    from emqx_tpu_torch.broker.metrics import Metrics as TMetrics
    out = []
    for mod, metrics in ((JT, JMetrics()), (TT, TMetrics())):
        rng = np.random.default_rng(seed)
        clock = FakeClock(np.random.default_rng(seed + 1))
        monkeypatch.setattr(time, "perf_counter", clock)
        rec = mod.FlightRecorder(metrics, cap=cap, sample=sample)
        rec.epoch_wall = 1.7e9
        ops = _sequence(rec, rng, clock, 400)
        out.append((rec, metrics, ops))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("cap,sample", [(16, 0), (64, 1), (4096, 3),
                                        (100, 256)])
def test_recorder_sequence_equals_reference(monkeypatch, cap, sample):
    (jr, jm, jops), (tr, tm, tops) = _twin_recorders(monkeypatch, cap,
                                                     sample, SEED + cap)
    assert tops == jops
    assert tr.state() == jr.state()
    assert (tr.recorded(), tr.dropped()) == (jr.recorded(), jr.dropped())
    assert [_fields(s) for s in tr.spans()] == \
        [_fields(s) for s in jr.spans()]
    assert tr.to_chrome() == jr.to_chrome()
    assert tr.snapshot_section() == jr.snapshot_section()
    for k in ("trace.spans", "trace.windows", "trace.dropped"):
        assert tm.val(k) == jm.val(k), k
    if cap < 400:
        assert tr.dropped() > 0


def test_dump_equals_reference(monkeypatch, tmp_path):
    (jr, _jm, _), (tr, _tm, _) = _twin_recorders(monkeypatch, 64, 1, SEED)
    import json
    docs = []
    for rec, name in ((jr, "j.json"), (tr, "t.json")):
        path = rec.dump(str(tmp_path / name))
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------
# the analyzers on the same spans
# ---------------------------------------------------------------------
def _random_spans(mod, rng, n_windows: int) -> list:
    """Windows of pipeline spans with overlaps and gaps: enqueue,
    batch_form, dispatch or dispatch_cached, materialize, deliver,
    sometimes lane items, host_route, window and message roll-ups, and
    node-scope events."""
    spans = []
    sid = [0]

    def add(tid, name, track, t0, t1, parent=0):
        sid[0] += 1
        spans.append(mod.Span(tid, sid[0], parent, name, track, t0, t1,
                              None, sid[0]))
        return sid[0]

    t = 0.0
    for w in range(1, n_windows + 1):
        t += float(rng.uniform(0, 0.002))
        w0 = t
        root = add(w, "enqueue", "batcher", t, t + rng.uniform(0, 1e-3))
        t += rng.uniform(0, 1e-3)
        add(w, "batch_form", "batcher", t, t + rng.uniform(0, 5e-4), root)
        t += rng.uniform(0, 1e-3)
        if rng.random() < 0.7:
            d = "dispatch" if rng.random() < 0.6 else "dispatch_cached"
            d0 = t
            d1 = d0 + rng.uniform(1e-4, 2e-3)
            add(w, d, "dispatch", d0, d1)
            # the next window's dispatch may overlap this materialize
            m0 = d1 + rng.uniform(0, 5e-4)
            m1 = m0 + rng.uniform(1e-4, 3e-3)
            add(w, "materialize", "materialize", m0, m1)
            c0 = m1 + rng.uniform(0, 1e-3)
            add(w, "deliver", "consume", c0, c0 + rng.uniform(0, 1e-3))
            t = d1 + rng.uniform(0, 1e-3)
            end = c0 + 1e-3
            for lane in range(int(rng.integers(0, 3))):
                l0 = c0 + rng.uniform(0, 2e-3)
                l1 = l0 + rng.uniform(1e-5, 1e-3)
                add(w, f"lane{lane}", f"lane{lane}", l0, l1)
                end = max(end, l1 + rng.uniform(0, 1e-3))
        else:
            h0 = t
            h1 = h0 + rng.uniform(1e-4, 2e-3)
            add(w, "host_route", "host", h0, h1, root)
            end = h1 + rng.uniform(0, 1e-3)
            t = h1
        add(w, "window", "window", w0, end)
        if rng.random() < 0.5:
            add(w, "message", "messages", w0 + 1e-5, end, root)
        if rng.random() < 0.2:
            add(0, "rung_change", "events", t, t)
    return spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyzers_equal_reference(seed):
    jspans = _random_spans(JT, np.random.default_rng(seed), 40)
    tspans = _random_spans(TT, np.random.default_rng(seed), 40)
    for top, per in ((3, 8), (5, 1000)):
        j = JT.analyze_spans(jspans, top=top, per_window=per)
        assert TT.analyze_spans(tspans, top=top, per_window=per) == j
    assert j["windows"] > 0 and "overlap" in j
    assert set(j["bubbles"]) >= {"host_stall_s", "device_stall_s",
                                 "lane_backpressure_s"}
    # the Chrome round trip: each package's analyzer over each package's
    # dump of the same spans
    jrec = JT.FlightRecorder(cap=4096, sample=0)
    trec = TT.FlightRecorder(cap=4096, sample=0)
    trec.epoch_perf = jrec.epoch_perf = 0.0
    trec.epoch_wall = jrec.epoch_wall = 1.7e9
    jdoc, tdoc = jrec.to_chrome(jspans), trec.to_chrome(tspans)
    assert tdoc == jdoc
    assert TT.analyze_chrome(tdoc) == JT.analyze_chrome(jdoc)
    assert TT.analyze_chrome(tdoc, per_window=3) \
        == JT.analyze_chrome(jdoc, per_window=3)


# ---------------------------------------------------------------------
# twin nodes over TCP
# ---------------------------------------------------------------------
def _burst_blob(burst: int, n: int, payload: int) -> tuple:
    """One burst, pre-serialized: n PUBLISHes to t/{k % N_SUB}/x, every
    4th at QoS 1; the payload starts with (burst, seq). Returns (bytes,
    the QoS 1 count)."""
    pad = b"x" * max(0, payload - 16)
    out, q1 = [], 0
    for k in range(n):
        qos = 1 if k % 4 == 3 else 0
        q1 += qos
        out.append(serialize(P.Publish(
            topic=f"t/{k % N_SUB}/x", payload=b"%08d%08d" % (burst, k) + pad,
            qos=qos, packet_id=(burst * n + k) % 65535 + 1 if qos else None),
            4))
    return b"".join(out), q1


async def _connect_raw(port: int, clientid: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(serialize(P.Connect(proto_name="MQTT", proto_ver=4,
                                     clientid=clientid), 4))
    await writer.drain()
    parser = FrameParser(version=4)
    while True:
        data = await reader.read(64)
        if not data:
            raise AssertionError("connection closed before CONNACK")
        if parser.feed(data):
            return reader, writer, parser


async def _warm(node, jax: bool, n: int) -> None:
    """The (1, b{n}) window class warm before the measured bursts (the
    batcher routes host-side until it is), and the chooser held on the
    device (on the CPU the host path wins it)."""
    eng = node.device_engine
    make = jmake if jax else tmake
    eng.route_batch([make("w", 0, f"t/{i % N_SUB}/w", b"")
                     for i in range(n)])
    deadline = time.monotonic() + 90
    while not eng.batch_class_warm(n) and time.monotonic() < deadline:
        eng._kick_class_warm()
        await asyncio.sleep(0.05)
    assert eng.batch_class_warm(n), "the window class never warmed"
    node.publish_batcher._device_worth_it = \
        (lambda n: True) if jax else (lambda: True)


async def _serve(node, listener_cls, jax: bool, bursts: int = BURSTS,
                 n: int = BURST_N, payload: int = PAYLOAD) -> dict:
    lst = listener_cls(node, bind="127.0.0.1", port=0)
    await lst.start()
    subs = []
    writer = None
    try:
        for i in range(N_SUB):
            cl = Client(port=lst.port, clientid=f"sub{i}")
            await cl.connect()
            await cl.subscribe(f"t/{i}/+", qos=0)
            subs.append(cl)
        await _warm(node, jax, n)
        reader, writer, parser = await _connect_raw(lst.port, "pub")
        got = [[] for _ in range(N_SUB)]
        acks = 0
        want_acks = 0
        for b in range(bursts):
            blob, q1 = _burst_blob(b, n, payload)
            want_acks += q1
            writer.write(blob)
            await writer.drain()
            while acks < want_acks:
                data = await asyncio.wait_for(reader.read(4096), 30)
                assert data, "the publisher was disconnected"
                acks += sum(isinstance(p, P.Puback)
                            for p in parser.feed(data))
            for i, cl in enumerate(subs):
                while len(got[i]) < (b + 1) * n // N_SUB:
                    m = await asyncio.wait_for(cl.messages.get(), 30)
                    got[i].append(bytes(m.payload[:16]))
        pool = node.deliver_lanes
        if pool is not None and pool.busy():
            await pool.drain()
        return {"got": got, "acks": acks}
    finally:
        if writer is not None:
            writer.close()
        for cl in subs:
            await cl.disconnect()
        await lst.stop()
        await node.publish_batcher.stop()
        node.publish_batcher.close()


def twin_run(jax: bool, **over) -> tuple:
    """One node of the reference or the port through the twin drive;
    returns (node, the drive's result)."""
    conf = dict(TWIN_CONF, **over)
    node = JNode({"broker": conf}, use_device=True) if jax else \
        TNode({"broker": conf}, device="cpu")
    r = asyncio.run(asyncio.wait_for(
        _serve(node, JListener if jax else TListener, jax), TIMEOUT_S))
    return node, r


def window_structure(rec) -> list:
    """Per window trace (renumbered by first appearance), the sorted
    (name, track, parent span's name) of its spans."""
    spans = rec.spans()
    names = {s.span_id: s.name for s in spans}
    order: dict = {}
    per: dict = {}
    for s in spans:
        if s.trace_id <= 0:
            continue
        k = order.setdefault(s.trace_id, len(order))
        per.setdefault(k, []).append(
            (s.name, s.track, names.get(s.parent_id) if s.parent_id
             else None))
    return [sorted(per[k]) for k in sorted(per)]


@pytest.fixture(scope="module")
def tcp_twins():
    return {"jax": twin_run(True), "torch": twin_run(False),
            "torch_off": twin_run(False, trace=False)}


def test_tcp_twin_span_structure_equals_reference(tcp_twins):
    jn, jr = tcp_twins["jax"]
    tn, tr = tcp_twins["torch"]
    assert tr["got"] == jr["got"]
    js, ts = window_structure(jn.flight_recorder), \
        window_structure(tn.flight_recorder)
    assert len(ts) == BURSTS
    assert ts == js
    for w in ts:
        names = [n for n, _t, _p in w]
        for want in ("enqueue", "batch_form", "dispatch", "materialize",
                     "deliver", "window"):
            assert want in names, (want, names)
        assert names.count("message") == BURST_N      # trace_sample 1
        assert any(n.startswith("lane") for n in names)
    assert tn.metrics.val("trace.windows") == jn.metrics.val(
        "trace.windows") == BURSTS
    assert tn.publish_batcher.last_trace > 0


def test_trace_off_no_recorder_and_same_deliveries(tcp_twins):
    tn, tr = tcp_twins["torch"]
    off, ro = tcp_twins["torch_off"]
    assert ro["got"] == tr["got"]
    assert off.flight_recorder is None
    assert off.publish_batcher.rec is None
    assert off.device_engine.rec is None
    assert off.pipeline_telemetry.recorder is None
    assert off.hbm_ledger.recorder is None
    assert off.latency_observatory.recorder is None
    assert off.overload_governor.recorder is None
    assert off.metrics.val("trace.spans") == 0
    assert "trace" not in off.pipeline_telemetry.snapshot()
    assert off.pipeline_telemetry.snapshot(full=True)["trace"] == {}
    sec = tn.pipeline_telemetry.snapshot()["trace"]
    assert sec["ring"]["recorded"] > 0 and sec["windows"] == BURSTS


class _Sink:
    def deliver(self, topic_filter, msg):
        return True


def test_device_trace_names_recorder_traces():
    """A torch.profiler capture around dispatches names each one
    ``route_step#<trace id>``, every id a trace the recorder holds; the
    capture's Chrome file is written where asked. The dispatch runs on
    the loop, as on the card (the profiler records the ranges of the
    thread that started it)."""
    import tempfile
    node = TNode({"broker": dict(TWIN_CONF)}, device="cpu")
    eng = node.device_engine
    eng.dispatch_on_loop = True

    async def go():
        for i in range(N_SUB):
            node.broker.subscribe(node.broker.register(_Sink(), f"c{i}"),
                                  f"t/{i}/+", {"qos": 0})
        await _warm(node, False, 8)
        with tempfile.TemporaryDirectory() as d:
            assert eng.start_device_trace(d)
            assert not eng.start_device_trace(d)
            for w in range(3):
                await asyncio.gather(*[node.publish_async(tmake(
                    "p", 1, f"t/{i % N_SUB}/x", b"%d" % w))
                    for i in range(8)])
            prof = eng.stop_device_trace()
            assert os.path.exists(os.path.join(d, "route_steps.json"))
        assert eng.stop_device_trace() is None
        await node.publish_batcher.stop()
        node.publish_batcher.close()
        return prof

    prof = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    steps = {int(e.name.split("#", 1)[1]) for e in prof.events()
             if e.name.startswith("route_step#")}
    held = {s.trace_id for s in node.flight_recorder.spans()
            if s.name in ("dispatch", "dispatch_cached")}
    assert steps and steps <= held


# ---------------------------------------------------------------------
# the tracing-overhead guard (reference tests/test_trace.py:654-690)
# ---------------------------------------------------------------------
def test_span_recording_under_3pct_of_window(tcp_twins):
    """Deterministic, not a wall-clock race: the per-record cost of the
    recorder primitive, times the spans an average window records (from
    the live ring), against 3% of the mean window span."""
    node, _r = tcp_twins["torch"]
    rec = node.flight_recorder
    probe = type(rec)(cap=4096, sample=rec.sample)
    tid = probe.new_trace()
    n = 4000
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _i in range(n):
            probe.record(tid, "x", 0.0, 1.0, track="p", meta={"k": 1})
        best = min(best, (time.perf_counter() - t0) / n)
    wins = rec.analyze(per_window=10**6)["last_windows"]
    assert wins
    mean_span = sum(w["span_s"] for w in wins) / len(wins)
    spans = [s for s in rec.spans() if s.trace_id > 0]
    per_window = len(spans) / max(1, len({s.trace_id for s in spans}))
    overhead = per_window * best
    assert overhead < 0.03 * mean_span, (
        f"tracing records {per_window:.1f} spans/window at "
        f"{best * 1e6:.2f}us each = {overhead * 1e3:.3f}ms, vs window "
        f"span {mean_span * 1e3:.1f}ms — over the 3% budget")


def test_stale_pin_event_equals_reference():
    """The ledger's stale-pin sentinel lands a ``stale_pin`` event on the
    pinned handle's window trace, as the reference's does."""
    from emqx_tpu.broker.hbm_ledger import HbmLedger as JLedger
    from emqx_tpu_torch.broker.hbm_ledger import HbmLedger as TLedger
    out = []
    for mod, Ledger in ((JT, JLedger), (TT, TLedger)):
        rec = mod.FlightRecorder(cap=64, sample=0)

        class H:
            trace = 42
        h = H()
        led = Ledger(pin_warn_windows=2, recorder=rec)
        led.pin(1, h)
        for _ in range(4):
            led.note_window()
        out.append([(s.trace_id, s.name, s.track, s.meta)
                    for s in rec.spans()])
    assert out[1] == out[0] == [(42, "stale_pin", "memory",
                                 {"age_windows": 3, "warn_windows": 2})]
