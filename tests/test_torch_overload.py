"""Port vs JAX reference: the overload governor and its hooks.

The same inputs go through the reference (``emqx_tpu``; its Node on the
JAX CPU backend) and the port (``emqx_tpu_torch``, ``device="cpu"``):

- the knob (config only: the reference's environment knobs are unset);
- one seeded sequence of ``sample_signals`` readings gives the same grade
  timeline, arm and unwind order (the ``overload.shed`` hook calls), shed
  flags, the sampling clamp on the recorder and the observatory and the
  batcher's dispatch depth (each restored on unwind), counters, alarms and
  flight-recorder events;
- ``_shed_qos0`` at all three admit paths (submit, enqueue, submit_burst)
  drops QoS 0 only, never QoS 1/2, and keeps order;
- the CONNACK bytes a CONNECT gets while connects are paused, on v3.1.1
  and v5;
- the top-offender disconnect picks the same connections by limiter debt
  and volume;
- the governor-off twin delivers identically and has no governor;
- ``Node.sweep`` polls the governor, and ``start_timers`` ticks it;
- the port's ``broker/alarm.py`` against the original.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import alarm as JA
from emqx_tpu.broker import overload as JO
from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.hooks import Hooks as JHooks
from emqx_tpu.broker.limiter import ConnectionLimiter as JLimiter
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker import alarm as TA
from emqx_tpu_torch.broker import overload as TO
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.hooks import Hooks as THooks
from emqx_tpu_torch.broker.limiter import ConnectionLimiter as TLimiter
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import FrameParser, serialize
from tests.test_torch_trace import ENV_KNOBS

torch.set_num_threads(1)

SEED = 20261017
TIMEOUT_S = 120
CONF = {"device_fanout_cap": 16, "device_slot_cap": 4,
        "device_min_batch": 4, "batch_window_us": 1000, "deliver_lanes": 2}


@pytest.fixture(autouse=True)
def _config_only(monkeypatch):
    """The reference's env knobs are not ported: only config decides."""
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _jnode(**over):
    return JNode({"broker": dict(CONF, **over)}, use_device=True)


def _tnode(**over):
    return TNode({"broker": dict(CONF, **over)}, device="cpu")


def _both(**over):
    """(reference node, port node, their make)."""
    return ((_jnode(**over), jmake), (_tnode(**over), tmake))


def _force_grade(gov, grade, signal="queue_fill"):
    """Walk the governor to `grade` and hold it: a signal override and
    one poll per climb (reference tests/test_overload.py:84-97)."""
    vals = {0: 0.0, 1: 0.55, 2: 0.80, 3: 0.95}
    gov.sample_signals = lambda: {signal: vals[grade]}
    gov.up_sustain = 1
    gov.down_sustain = 1
    for _ in range(4):
        gov.poll()
        if gov.grade == grade:
            break
    assert gov.grade == grade, (gov.grade, gov.last_signals)


# ---------------------------------------------------------------------
# knob
# ---------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, True, False, 0, 1])
def test_overload_knob_equals_reference(value):
    assert TO.resolve_overload(value) is JO.resolve_overload(value)


def test_tables_equal_reference():
    assert (TO.GRADES, TO.ACTIONS, TO.GRADE_ACTIONS, TO.THRESHOLDS,
            TO.CLAMP_FACTOR) == (JO.GRADES, JO.ACTIONS, JO.GRADE_ACTIONS,
                                 JO.THRESHOLDS, JO.CLAMP_FACTOR)


# ---------------------------------------------------------------------
# one seeded signal sequence through both governors
# ---------------------------------------------------------------------
def _signal_sequence(seed: int, n: int) -> list:
    """Segments of 2-14 polls, each aiming at one grade through a random
    mix of the governor's signals (queue fill, burn, HBM, lag, lanes)."""
    rng = np.random.default_rng(seed)
    levels = {"queue_fill": (0.2, 0.55, 0.8, 0.95),
              "burn_page": (0.0, 0.0, 20.0, 60.0),
              "hbm_fill": (0.1, 0.85, 0.92, 0.97),
              "loop_lag_s": (0.0, 0.1, 0.5, 2.0),
              "backpressure_delta": (0, 3, 60, 60),
              "lane_fill": (0.2, 1.0, 1.0, 1.0)}
    out = []
    while len(out) < n:
        grade = int(rng.integers(4))
        names = list(rng.choice(list(levels), size=int(rng.integers(1, 4)),
                                replace=False))
        for _ in range(int(rng.integers(2, 15))):
            sig = {}
            for k in names:
                g = grade if rng.random() < 0.85 else int(rng.integers(4))
                sig[str(k)] = levels[str(k)][g]
            if rng.random() < 0.3:
                sig["burn_1m"] = float(rng.uniform(0, 3))
            out.append(sig)
    return out[:n]


def _run_sequence(node, seq: list) -> dict:
    gov = node.overload_governor
    rec, obs, b = node.flight_recorder, node.latency_observatory, \
        node.publish_batcher
    shed, alarms_seen = [], []
    node.hooks.add("overload.shed", lambda info: shed.append(dict(info)))
    for hp in ("alarm.activated", "alarm.deactivated"):
        node.hooks.add(hp, lambda a, hp=hp: alarms_seen.append(
            (hp, a["name"], a["details"])))
    gov.up_sustain, gov.down_sustain = 2, 3
    gov.poll_interval_s = 0.05
    it = iter(seq)
    gov.sample_signals = lambda: dict(next(it))
    timeline = []
    now = 1000.0
    for _ in seq:
        now += 0.05
        gov.poll(now=now)
        timeline.append((gov.grade, tuple(gov._armed), gov.shed_qos0,
                         gov.connects_paused, gov.retained_deferred,
                         rec.sample, obs.clamp, b.dispatch_depth,
                         gov._down_mult, gov._above, gov._below,
                         dict(gov.last_signals)))
    counters = {k: v for k, v in node.metrics.all().items()
                if k.startswith("pipeline.overload.")}
    alarms = [(a["name"], a["details"], a["deactivate_at"] is None)
              for a in node.alarms.get_alarms()]
    events = [(s.name, s.track, s.meta) for s in rec.spans()
              if s.track == "overload"]
    st = gov.state()
    st.pop("since_s")
    return {"timeline": timeline, "shed": shed, "alarm_hooks": alarms_seen,
            "counters": counters, "alarms": alarms, "events": events,
            "state": st, "saved": dict(gov._saved)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_signal_sequence_equals_reference(seed):
    seq = _signal_sequence(SEED + seed, 160)
    (jn, _), (tn, _) = _both()
    j = _run_sequence(jn, seq)
    t = _run_sequence(tn, seq)
    for k in j:
        assert t[k] == j[k], k
    grades = {g for g, *_ in t["timeline"]}
    assert grades >= {0, 1}
    assert t["counters"].get("pipeline.overload.grade_changes", 0) > 2
    tn.publish_batcher.close()
    jn.publish_batcher.close()


def test_full_ladder_arms_and_unwinds_as_reference():
    """Critical arms every action; recovery restores the recorder's
    sampling, the observatory's clamp and the batcher's depth."""
    out = []
    for node, _make in _both():
        gov = node.overload_governor
        rec, obs, b = node.flight_recorder, node.latency_observatory, \
            node.publish_batcher
        before = (rec.sample, obs.clamp, b.dispatch_depth)
        _force_grade(gov, 3)
        armed = (list(gov._armed), rec.sample, obs.clamp, b.dispatch_depth,
                 gov.shed_qos0, gov.connects_paused, gov.retained_deferred,
                 node.alarms.is_active("overload"))
        _force_grade(gov, 0)
        after = (rec.sample, obs.clamp, b.dispatch_depth, gov._saved,
                 gov._armed, node.alarms.is_active("overload"))
        out.append((before, armed, after))
        b.close()
    assert out[1] == out[0]
    before, armed, after = out[1]
    assert armed[0] == list(TO.ACTIONS)
    assert armed[1:4] == (256 * TO.CLAMP_FACTOR, TO.CLAMP_FACTOR, 1)
    assert after == (*before, {}, [], False)


# ---------------------------------------------------------------------
# _shed_qos0 at the three admit paths
# ---------------------------------------------------------------------
class _Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((msg.topic, bytes(msg.payload), msg.qos))
        return True


def _messages(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = [(int(rng.integers(3)), f"t/{int(rng.integers(4))}/x", b"m%d" % k)
           for k in range(n)]
    return out + [(1, "t/0/x", b"last")]      # a QoS 1 closes the drive


async def _admit(node, make, path: str, msgs: list) -> list:
    """Drive `msgs` through one admit path; returns what each admit gave
    back (counts, or True for an accepted fire-and-forget)."""
    pb = node.publish_batcher
    if path == "submit":
        return list(await asyncio.gather(*[
            node.publish_async(make("p", q, t, pl)) for q, t, pl in msgs]))
    if path == "enqueue":
        out, futs = [], []
        for q, t, pl in msgs:
            m = make("p", q, t, pl)
            if q == 0:
                out.append(node.publish_nowait(m))
            else:
                futs.append(asyncio.ensure_future(node.publish_async(m)))
                out.append(None)
                await asyncio.sleep(0)
        counts = await asyncio.gather(*futs)
        it = iter(counts)
        return [next(it) if o is None else o for o in out]
    futs = pb.submit_burst([(make("p", q, t, pl), q > 0)
                            for q, t, pl in msgs])
    counts = await asyncio.gather(*futs.values())
    return sorted(zip(futs, counts))


@pytest.mark.parametrize("path", ["submit", "enqueue", "burst"])
@pytest.mark.parametrize("grade", [3, 0])
def test_shed_qos0_admit_paths_equal_reference(path, grade):
    msgs = _messages(SEED, 60)
    out = []
    for node, make in _both():
        gov = node.overload_governor
        sinks = []
        for i in range(4):
            s = _Sink()
            node.broker.subscribe(node.broker.register(s, f"c{i}"),
                                  f"t/{i}/+", {"qos": 2})
            sinks.append(s)
        _force_grade(gov, 3)
        if grade == 0:
            _force_grade(gov, 0)

        async def go():
            r = await _admit(node, make, path, msgs)
            pool = node.deliver_lanes
            if pool is not None and pool.busy():
                await pool.drain()
            await node.publish_batcher.stop()
            return r

        r = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
        node.publish_batcher.close()
        out.append((r, [s.got for s in sinks],
                    node.metrics.val("pipeline.overload.qos0_shed")))
    assert out[1] == out[0]
    _r, got, shed = out[1]
    q0 = sum(1 for q, _t, _p in msgs if q == 0)
    kept = [(t, pl) for q, t, pl in msgs if q > 0 or grade == 0]
    assert shed == (q0 if grade == 3 else 0)
    # nothing shed but QoS 0, and the survivors in admit order per topic
    for i, rows in enumerate(got):
        assert [(t, pl) for t, pl, _q in rows] == \
            [(t, pl) for t, pl in kept if t == f"t/{i}/x"]


# ---------------------------------------------------------------------
# the connection's hooks over TCP
# ---------------------------------------------------------------------
async def _raw_connect(port: int, clientid: str, proto_ver: int):
    """CONNECT over a raw socket; returns (reader, writer, the bytes of
    the first reply)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(serialize(P.Connect(proto_name="MQTT", proto_ver=proto_ver,
                                     clientid=clientid), proto_ver))
    await writer.drain()
    data = await asyncio.wait_for(reader.read(512), 10)
    return reader, writer, data


@pytest.mark.parametrize("proto_ver", [4, 5])
def test_paused_connack_bytes_equal_reference(proto_ver):
    out = []
    for (node, _make), lst_cls in zip(_both(ingress_lanes=1),
                                      (JListener, TListener)):
        gov = node.overload_governor

        async def go():
            lst = lst_cls(node, bind="127.0.0.1", port=0)
            await lst.start()
            try:
                _force_grade(gov, 2)        # pause_connects arms
                _r, w, refused = await _raw_connect(lst.port, "no1",
                                                    proto_ver)
                w.close()
                _force_grade(gov, 0)        # recovery re-admits
                _r, w, ok = await _raw_connect(lst.port, "ok1", proto_ver)
                w.close()
                return refused, ok
            finally:
                await lst.stop()
                await node.publish_batcher.stop()

        refused, ok = asyncio.run(asyncio.wait_for(go(), 60))
        node.publish_batcher.close()
        out.append((refused, FrameParser(version=proto_ver).feed(ok)[0]
                    .reason_code,
                    node.metrics.val("pipeline.overload.connects_rejected")))
    assert out[1] == out[0]
    refused, ok_rc, rejected = out[1]
    ack = FrameParser(version=proto_ver).feed(refused)[0]
    assert isinstance(ack, P.Connack)
    assert (ok_rc, rejected) == (C.RC_SUCCESS, 1)
    if proto_ver == 5:
        assert ack.reason_code == C.RC_QUOTA_EXCEEDED


def test_paused_lane_refuses_at_accept_as_reference():
    out = []
    for node, _make in _both():
        lst = (JListener if isinstance(node, JNode) else TListener)(
            node, bind="127.0.0.1", port=0)
        _force_grade(node.overload_governor, 2)
        closed = []

        class W:
            def close(self):
                closed.append(True)

        asyncio.run(lst._lane_handler(2)(None, W()))
        out.append((closed, node.metrics.val(
            "pipeline.overload.accepts_paused")))
        node.publish_batcher.close()
    assert out[1] == out[0] == ([True], 1)


def test_offender_disconnect_equals_reference():
    """Limiter debt outranks volume, volume under the floor never ranks;
    each critical poll disconnects the top offender with DISCONNECT 0x97
    (v5)."""
    out = []
    for (node, _make), lst_cls, limiter in zip(
            _both(), (JListener, TListener), (JLimiter, TLimiter)):
        gov = node.overload_governor
        shed = []
        node.hooks.add("overload.shed", lambda info: shed.append(info))

        async def go():
            lst = lst_cls(node, bind="127.0.0.1", port=0)
            await lst.start()
            try:
                conns = {}
                for cid in ("quiet", "flood", "debtor"):
                    conns[cid] = await _raw_connect(lst.port, cid, 5)
                await asyncio.sleep(0.05)
                by_id = {c.channel.clientid: c for c in gov._conns}
                by_id["quiet"].shed_rows = 10.0
                # halved each poll: still over the floor at the 4th
                by_id["flood"].shed_rows = 50000.0
                by_id["debtor"].limiter = limiter(10.0, None)
                by_id["debtor"].limiter.msgs.take(500)
                scores = {k: c.shed_score() > 0 for k, c in by_id.items()}
                gov.sample_signals = lambda: {"queue_fill": 0.95}
                gov.up_sustain = 1
                for _ in range(6):
                    gov.poll()
                await asyncio.sleep(0.1)
                got = {}
                for cid, (r, w, _ack) in conns.items():
                    try:
                        got[cid] = await asyncio.wait_for(r.read(512), 2)
                    except asyncio.TimeoutError:
                        got[cid] = None
                    w.close()
                return scores, got
            finally:
                await lst.stop()
                await node.publish_batcher.stop()

        scores, got = asyncio.run(asyncio.wait_for(go(), 60))
        node.publish_batcher.close()
        out.append((scores, got,
                    [i["clientid"] for i in shed
                     if i["action"] == "disconnect_offender"],
                    node.metrics.val("pipeline.overload.disconnects")))
    assert out[1] == out[0]
    scores, got, order, n = out[1]
    assert scores == {"quiet": False, "flood": True, "debtor": True}
    assert order == ["debtor", "flood"] and n == 2
    assert got["quiet"] is None
    for cid in order:
        pkts = FrameParser(version=5).feed(got[cid])
        assert isinstance(pkts[0], P.Disconnect) \
            and pkts[0].reason_code == C.RC_QUOTA_EXCEEDED


# ---------------------------------------------------------------------
# the off twin, sweep and the timers
# ---------------------------------------------------------------------
def test_overload_off_twin_delivers_identically():
    out = []
    for over in ({"overload": False}, {}):
        node = _tnode(**over)
        sinks = []
        for i in range(4):
            s = _Sink()
            node.broker.subscribe(node.broker.register(s, f"c{i}"),
                                  f"t/{i}/+", {"qos": 1})
            sinks.append(s)

        async def go():
            r = await _admit(node, tmake, "submit", _messages(SEED, 40))
            await node.publish_batcher.stop()
            return r

        counts = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
        node.publish_batcher.close()
        out.append((node, counts, [s.got for s in sinks]))
    (off, c_off, g_off), (on, c_on, g_on) = out
    assert (c_off, g_off) == (c_on, g_on)
    assert off.overload_governor is None and off.publish_batcher.gov is None
    assert on.overload_governor is not None
    snap_off = off.pipeline_telemetry.snapshot(full=True)
    assert "overload" not in snap_off
    assert set(snap_off) == set(on.pipeline_telemetry.snapshot(full=True)) \
        - {"overload"}
    assert not [k for k in off.metrics.all()
                if k.startswith("pipeline.overload.")]


def test_sweep_polls_the_governor_as_reference():
    out = []
    for node, _make in _both():
        gov = node.overload_governor
        gov.sample_signals = lambda: {"queue_fill": 0.95}
        gov.up_sustain = 1
        trail = []
        for _ in range(4):
            node.sweep()
            trail.append(gov.grade)
        out.append((trail, gov._polls))
        node.publish_batcher.close()
    assert out[1] == out[0] == ([1, 2, 3, 3], 4)


def test_start_timers_ticks_the_governor():
    node = _tnode()
    gov = node.overload_governor

    async def go():
        node.start_timers(0.01)
        node.start_timers(0.5)          # a second start is a no-op
        await asyncio.sleep(0.2)
        node.stop_timers()
        polls = gov._polls
        await asyncio.sleep(0.05)
        return polls

    polls = asyncio.run(go())
    node.publish_batcher.close()
    assert polls >= 3 and gov._polls == polls
    assert gov.poll_interval_s == 0.01
    assert node.pipeline_telemetry.snapshot()["overload"]["state"][
        "grade"] == "normal"


# ---------------------------------------------------------------------
# alarm.py, the port's copy
# ---------------------------------------------------------------------
def _alarm_drive(A, Hooks, monkeypatch, seed: int) -> list:
    clock = [1.7e9]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    hooks = Hooks()
    seen = []
    for hp in ("alarm.activated", "alarm.deactivated"):
        hooks.add(hp, lambda a, hp=hp: seen.append((hp, a)))
    mgr = A.AlarmManager(hooks, size_limit=5, validity_period=30.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(300):
        clock[0] += float(rng.uniform(0, 4))
        name = f"a{int(rng.integers(6))}"
        op = int(rng.integers(7))
        if op == 0:
            out.append(mgr.activate(name, {"v": int(rng.integers(9))},
                                    "msg" if rng.random() < 0.5 else ""))
        elif op == 1:
            out.append(mgr.deactivate(name))
        elif op == 2:
            mgr.ensure(name, bool(rng.integers(2)), {"e": 1})
        elif op == 3:
            out.append(mgr.is_active(name))
        elif op == 4:
            out.append(mgr.get_alarms(str(rng.choice(
                ["all", "activated", "deactivated"]))))
        elif op == 5:
            mgr.tick()
        elif rng.random() < 0.1:
            out.append(mgr.delete_all_deactivated())
    monkeypatch.undo()
    return _strip(out + [seen])


def _strip(x):
    """Drop ``activate_at``: the Alarm dataclass's default factory is the
    wall clock bound at import, out of reach of the fake clock."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "activate_at"}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_alarm_copy_equals_reference(monkeypatch, seed):
    j = _alarm_drive(JA, JHooks, monkeypatch, seed)
    t = _alarm_drive(TA, THooks, monkeypatch, seed)
    assert t == j
    assert any(x is True for x in j) and j[-1]
