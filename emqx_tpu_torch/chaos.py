"""Deterministic chaos drive for the pipeline's supervision layer.

The port's copy of ``tools/chaos_bench.py``'s world, schedule, drive and
oracle, and of its overload cells. It drives the real serving path
(``Node`` → ``PublishBatcher`` → ``DeviceRouteEngine`` → delivery lanes)
through a deterministic publish schedule while one armed fault clause
fails one stage, and grades the run against the fault-free twin:

- **zero lost QoS>=1 deliveries** — every publish's settled delivery
  count equals the twin's (the window-journal replay re-routes a dying
  window through the host rung, it never drops it);
- **per-session order identical** — each subscriber's delivered
  (filter, topic, payload) sequence equals the twin's (sessions subscribe
  one filter each, so the order oracle is path-independent);
- **degradation within one window** — the stage breaker opens on the
  faulted window (threshold 1 here) and the ladder steps down;
- **recovery** — the half-open probe re-closes the breaker once the
  armed clauses are spent; the journal and the HBM ledger's pins drain
  to 0.

``tests/test_torch_chaos.py`` holds each (point, kind) cell against the
JAX package's ``tools/chaos_bench.run_case`` on the CPU; ``chip_smoke.py``
phase 13 runs the matrix on the card. Two departures from the reference's
drive: the batcher's chooser is held on the device (``pin_device``), so a
clause always meets a device window and not a host probe, and after the
drive the run waits for a stage thread a watchdog left behind (a hang
clause's sleep) to leave its window, so the pins it holds are released.

Every entry point takes ``device`` as ``Node`` does: None serves on the
card (and raises without one); pass ``device="cpu"`` for a CPU node.
"""

from __future__ import annotations

import asyncio
import time

from emqx_tpu_torch.broker.message import make
from emqx_tpu_torch.broker.node import Node
from emqx_tpu_torch.broker.supervise import (FAULT_POINTS, FaultInjector,
                                             parse_faults)

N_FILTERS = 8
BATCH = 80          # > 64: the dedup/cache plan analysis engages, so the
                    # cache_insert point is traversed (Bp = 256)
WINDOWS = 8

# stages whose consumer-side await is watchdog-bounded: a hang there MUST
# trip the breaker (stall detection); at every other point a bounded hang
# completes inline — slow, but nothing failed and nothing was lost
WATCHDOGGED = ("dispatch", "materialize", "mesh_exchange")

# the single-node matrix: mesh_exchange is traversed by the mesh server
# only (run_case(..., mesh=True) builds a multichip node for it); the
# overload points are traversed by the governor's poll and ride the
# overload cells below
MATRIX_POINTS = tuple(
    p for p in FAULT_POINTS
    if p not in ("mesh_exchange", "signal_spike", "stuck_grade"))

# the chaos tuning: a fast breaker cycle and a tight watchdog so hang
# clauses resolve in test time (hang_s > the floor: the stall detector
# trips); mult 0 makes the deadline the floor
COOLDOWN_S = 0.05
WATCHDOG_FLOOR_S = 0.1


class Rec:
    """Recording sink: per-session delivery log for the order oracle."""

    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg.topic, bytes(msg.payload)))
        return True


# the mesh node of the mesh_exchange cells: dp=2 x route=4 shards, and a
# window class that holds a scheduled window
MESH = {"enable": True, "devices": 8, "dp": 2, "max_batch": 128}


def build_node(*, lanes: int = 2, supervise: bool = True,
               threshold: int = 1, device=None, mesh: bool = False) -> Node:
    broker = {
        "device_fanout_cap": 16, "device_slot_cap": 4,
        "deliver_lanes": lanes, "device_min_batch": 4,
        "batch_window_us": 2000, "supervise": supervise,
        "supervise_threshold": threshold}
    if mesh:
        broker["multichip"] = MESH
    return Node({"broker": broker}, device=device)


def tune(sup, *, cooldown_s: float = COOLDOWN_S,
         floor_s: float = WATCHDOG_FLOOR_S, mult: float = 0.0) -> None:
    """The chaos tuning on a live supervisor: every breaker's cooldown,
    the watchdog floor and its p99 multiplier."""
    for br in sup.breakers.values():
        br.base_cooldown_s = br.cooldown_s = cooldown_s
    sup.wd_floor_s = floor_s
    sup.wd_mult = mult


def build_world(node: Node, *, with_delta: bool = False) -> dict:
    """N_FILTERS filters × 2 subscribers (one QoS 1). Each session
    subscribes exactly ONE filter, so its delivered sequence is the
    publish-order subsequence of its topic — identical across the
    device, lanes and host paths by construction."""
    b = node.broker
    sinks = {}
    for i in range(N_FILTERS):
        for q in (0, 1):
            s = Rec()
            sid = b.register(s, f"c{i}-{q}")
            sinks[sid] = s
            b.subscribe(sid, f"t/{i}/+", {"qos": q})
    if with_delta:
        s = Rec()
        sid = b.register(s, "cd")
        sinks[sid] = s
        # subscribed after the build by the drive (a delta filter)
        sinks["delta_sid"] = sid
    return sinks


def schedule(windows: int = WINDOWS, batch: int = BATCH) -> list:
    """Deterministic topic schedule: round-robin over the filters with a
    unique payload per message."""
    wins = []
    seq = 0
    for _w in range(windows):
        msgs = []
        for i in range(batch):
            msgs.append((f"t/{(seq + i) % N_FILTERS}/x",
                         b"m%06d" % (seq + i)))
        seq += batch
        wins.append(msgs)
    return wins


async def _warm(node: Node) -> None:
    """Build and warm the standard window classes off the serving path, so
    the batcher's warm gate admits device dispatches (the clauses must
    hit the DEVICE path, not a cold-class host detour)."""
    eng = node.device_engine
    eng.rebuild()
    if hasattr(eng, "warm_exchange"):
        # the mesh: every batch class, and the exchange classes of a
        # scheduled window and of a settle tick
        Bp = eng.n_dp
        while Bp <= eng.max_batch:
            eng._warm_one(Bp)
            Bp *= 2
        eng.warm_exchange(BATCH)
        eng.warm_exchange(N_FILTERS)
        return
    eng._kick_class_warm()
    if eng._fuse_warm_task is not None:
        await eng._fuse_warm_task


async def _drive(node: Node, wins, *, delta_sub=None,
                 settle_s: float = 6.0) -> list:
    """Publish the schedule through the real batcher; after the last
    window keep publishing one-message-a-filter ticks until every armed
    fault has fired and every breaker re-closed (or `settle_s` elapses)."""
    counts = []
    delta_live = False
    for w, msgs in enumerate(wins):
        if delta_sub is not None and w == 2:
            # churn mid-schedule: a post-snapshot (delta) filter makes
            # the overlay stale, so the overlay_apply point is traversed
            # on the next prepare; its topic gets traffic
            sid, filt = delta_sub
            node.broker.subscribe(sid, filt, {"qos": 1})
            delta_live = True
        if delta_live:
            msgs = msgs + [("d/x", b"d%03d" % w)]
        counts.append(await asyncio.gather(*[
            node.publish_async(make("pub", 1, t, p)) for t, p in msgs]))
        await asyncio.sleep(0.02)
    sup = node.supervisor
    deadline = time.monotonic() + settle_s
    while sup is not None and time.monotonic() < deadline:
        spent = all(f.fired >= f.count for f in sup.injector.faults)
        closed = all(b.state == "closed" for b in sup.breakers.values())
        if spent and closed:
            break
        # tick: publishes drive poll_rebuild → sup.poll() → probes
        counts.append(await asyncio.gather(*[
            node.publish_async(make("pub", 1, f"t/{i}/x", b"tick"))
            for i in range(N_FILTERS)]))
        await asyncio.sleep(0.05)
    pool = node.deliver_lanes
    if pool is not None:
        await pool.drain()
    return counts


async def _released(node: Node, timeout_s: float) -> None:
    """Wait for every dispatched window to release its handle: a stage
    thread a watchdog left behind releases its window when it leaves."""
    eng = node.device_engine
    deadline = time.monotonic() + timeout_s
    while eng._outstanding > 0 and time.monotonic() < deadline:
        await asyncio.sleep(0.01)


def run_case(point: str, kind: str, *, lanes: int = 2,
             hang_s: float = 0.5, count: int = 1, device=None,
             pin_device: bool = True, mesh: bool = False) -> dict:
    """One faulted run: returns the settled counts, per-session order and
    the supervision counters for the oracle. ``mesh`` serves through the
    multichip node (the mesh_exchange point's)."""
    node = build_node(lanes=lanes, threshold=1, device=device, mesh=mesh)
    sup = node.supervisor
    tune(sup)
    if pin_device:
        node.publish_batcher._device_worth_it = lambda: True
    delta = point == "overlay_apply"
    sinks = build_world(node, with_delta=delta)
    delta_sid = sinks.pop("delta_sid", None)
    wins = schedule()

    async def go():
        if point != "snapshot_swap":
            # snapshot_swap must fault the FIRST build; every other point
            # warms first so the fault hits a serving device path
            await _warm(node)
        spec = f"{point}:{kind}:count={count}"
        if kind == "hang":
            spec += f":hang_s={hang_s}"
        sup.injector = FaultInjector(parse_faults(spec))
        counts = await _drive(
            node, wins,
            delta_sub=(delta_sid, "d/+") if delta_sid is not None
            else None)
        await _released(node, hang_s + 2.0)
        await node.publish_batcher.stop()
        return counts

    counts = _run(go())
    node.publish_batcher.close()
    m = node.metrics
    led = node.hbm_ledger
    return {
        "counts": [list(c) for c in counts],
        "order": {sid: list(s.got) for sid, s in sinks.items()},
        "faults": m.val(f"supervise.faults.{point}"),
        "trips": m.val("supervise.trips"),
        "replays": m.val("supervise.replays"),
        "stalls": m.val("supervise.stalls"),
        "probes": m.val("supervise.probes"),
        "rung_changes": m.val("supervise.rung_changes"),
        "rung": sup.rung(),
        "breakers": {s: b.state for s, b in sup.breakers.items()},
        "journal_depth": sup.journal_depth(),
        "ledger_pins": led.pin_state()["outstanding"]
        if led is not None else 0,
        "fired": sum(f.fired for f in sup.injector.faults),
        "dropped": m.val("messages.dropped"),
        "device_batches": m.val("routing.device.batches"),
        # windows dispatched without a captured graph (on the card; the
        # rung-1 plain windows must find theirs captured)
        "eager_windows": m.val("routing.device.eager_windows"),
        "probe_launches": dict(node.device_engine.probe_launches),
        "exchange_windows": m.val("pipeline.exchange.windows"),
    }


def run_twin(*, lanes: int = 2, delta: bool = False, device=None,
             pin_device: bool = True, mesh: bool = False) -> dict:
    """The fault-free twin: same node shape, same schedule, no armed
    clauses — the oracle both the counts and the order compare to."""
    node = build_node(lanes=lanes, threshold=1, device=device, mesh=mesh)
    if pin_device:
        node.publish_batcher._device_worth_it = lambda: True
    sinks = build_world(node, with_delta=delta)
    delta_sid = sinks.pop("delta_sid", None)
    wins = schedule()

    async def go():
        await _warm(node)
        counts = await _drive(
            node, wins, settle_s=0.0,
            delta_sub=(delta_sid, "d/+") if delta_sid is not None
            else None)
        await node.publish_batcher.stop()
        return counts

    counts = _run(go())
    node.publish_batcher.close()
    return {
        "counts": [list(c) for c in counts],
        "order": {sid: list(s.got) for sid, s in sinks.items()},
        "device_batches": node.metrics.val("routing.device.batches"),
        "exchange_windows": node.metrics.val("pipeline.exchange.windows"),
    }


def raise_once(eng, name: str, exc: BaseException) -> None:
    """Make the engine's own stage `name` (``_dispatch_inner``,
    ``_materialize``) raise `exc` on its next call, once."""
    real = getattr(eng, name)
    calls = [0]

    def flaky(*a):
        calls[0] += 1
        if calls[0] == 1:
            raise exc
        return real(*a)

    setattr(eng, name, flaky)


def stall_once(eng, name: str, seconds: float) -> None:
    """Make the engine's own stage `name` sleep `seconds` on its next
    call, once, before it runs: a real stall, no injector clause."""
    real = getattr(eng, name)
    calls = [0]

    def slow(*a):
        calls[0] += 1
        if calls[0] == 1:
            time.sleep(seconds)
        return real(*a)

    setattr(eng, name, slow)


def fatal_drive(arm, *, device=None, windows: int = 3) -> tuple:
    """The chaos world on a node that takes the card's rules: device
    errors fatal (``fail_on_device_error``) and the dispatch on the loop
    (both already so on a ``cuda`` node). ``arm(eng, sup)`` arms one
    failure after the warm-up, before the first of `windows` schedule
    windows. Returns the node and each window's counts or errors."""
    node = build_node(threshold=1, device=device)
    sup, eng = node.supervisor, node.device_engine
    tune(sup)
    eng.fail_on_device_error = True
    eng.dispatch_on_loop = True
    node.publish_batcher._device_worth_it = lambda: True
    build_world(node)

    async def go():
        await _warm(node)
        arm(eng, sup)
        out = []
        for msgs in schedule(windows):
            out.append(await asyncio.gather(
                *[node.publish_async(make("pub", 1, t, p))
                  for t, p in msgs], return_exceptions=True))
            await asyncio.sleep(3 * COOLDOWN_S)    # past the cooldown
        await node.deliver_lanes.drain()
        await _released(node, 2.0)
        await node.publish_batcher.stop()
        return out

    out = _run(go())
    node.publish_batcher.close()
    return node, out


def _run(coro, timeout_s: float = 120.0):
    """One drive on a loop of its own; the node's background tasks still
    pending at its end (a class warm) are cancelled with the loop."""
    return asyncio.run(asyncio.wait_for(coro, timeout_s))


def scheduled(case: dict, twin: dict) -> tuple:
    """A run's settled counts on the scheduled windows and each session's
    deliveries over the twin's length (a faulted run's settle ticks
    append deliveries after them): what two runs of one cell, on two
    devices or two packages, must agree on."""
    return (case["counts"][:WINDOWS],
            {sid: case["order"][sid][:len(seq)]
             for sid, seq in twin["order"].items()})


def grade(case: dict, twin: dict, point: str = "dispatch",
          kind: str = "exception") -> list:
    """The chaos oracle. Returns a list of violation strings (empty =
    green). Counts compare only over the twin's windows (the faulted
    run's extra settle ticks are all-delivered by the journal contract:
    every settled count must be the subscriber fan-out, 2)."""
    bad = []
    expect_trip = kind != "hang" or point in WATCHDOGGED
    # zero lost QoS>=1 deliveries on the scheduled windows
    for w, twin_counts in enumerate(twin["counts"][:WINDOWS]):
        if case["counts"][w] != twin_counts:
            bad.append(f"window {w}: counts diverged "
                       f"{case['counts'][w][:8]}... != "
                       f"{twin_counts[:8]}...")
    for w, counts in enumerate(case["counts"]):
        if any(c == 0 for c in counts):
            bad.append(f"window {w}: lost deliveries (count=0)")
    # per-session order: the twin's sequence must be a PREFIX of the
    # faulted run's (the settle ticks append extra deliveries)
    for sid, seq in twin["order"].items():
        got = case["order"].get(sid, [])
        if got[:len(seq)] != seq:
            bad.append(f"sid {sid}: order diverged")
    if case["fired"] == 0:
        bad.append("no armed fault ever fired (harness bug)")
    if expect_trip and case["trips"] < 1:
        bad.append("breaker never opened")
    if kind == "hang" and point in WATCHDOGGED and case["stalls"] < 1:
        bad.append("hang at a watchdogged stage never counted a stall")
    if kind in ("exception", "resource", "corrupt") \
            and point in ("dispatch", "materialize") and case["replays"] < 1:
        bad.append("a raising fault at a device stage never replayed")
    if any(s != "closed" for s in case["breakers"].values()):
        bad.append(f"breaker(s) stuck open: {case['breakers']}")
    if case.get("rung", 0) != 0:
        bad.append(f"ladder not back at rung 0: {case['rung']}")
    if case["journal_depth"] != 0:
        bad.append(f"window journal leaked {case['journal_depth']}")
    if case.get("ledger_pins", 0) != 0:
        bad.append(f"HBM ledger holds {case['ledger_pins']} pins")
    if case["dropped"] != 0:
        bad.append(f"{case['dropped']} messages dropped")
    return bad


# ---- overload cells ------------------------------------------------------
# The governor's chaos surface: signal_spike drives a deterministic grade
# climb → shed arming → recovery; stuck_grade freezes the ladder until the
# clause is spent → the overload_stuck alarm. Pure poll-driven (no event
# loop, no traffic).

OVERLOAD_POINTS = ("signal_spike", "stuck_grade")


def _overload_node(device=None) -> Node:
    node = build_node(lanes=0, threshold=1, device=device)
    gov = node.overload_governor
    assert gov is not None, "overload governor unexpectedly off"
    # tight hysteresis so the cells converge in a handful of polls
    gov.up_sustain = 1
    gov.down_sustain = 2
    return node


def run_overload_case(point: str, *, count: int = 6, polls: int = 40,
                      device=None) -> dict:
    """Drive `polls` governor ticks with a `point:corrupt:count=N` clause
    armed; record the grade trajectory, armed-action history, alarm
    states and the unwind proof."""
    node = _overload_node(device)
    gov = node.overload_governor
    sup = node.supervisor
    sup.injector = FaultInjector(parse_faults(
        f"{point}:corrupt:count={count}"))
    rec = node.flight_recorder
    sample0 = rec.sample if rec is not None else None
    depth0 = node.publish_batcher.dispatch_depth
    grades, actions_hist = [], []
    alarm_seen = stuck_alarm_seen = False
    if point == "stuck_grade":
        # the stuck cell needs a PENDING transition to block: force a
        # high raw grade from the signals themselves while it fires
        gov.sample_signals = lambda: {"queue_fill": 0.95}
    for _i in range(polls):
        gov.poll()
        grades.append(gov.grade)
        actions_hist.append(list(gov._armed))
        if node.alarms.is_active("overload"):
            alarm_seen = True
        if node.alarms.is_active("overload_stuck"):
            stuck_alarm_seen = True
        if point == "stuck_grade" \
                and all(f.fired >= f.count for f in sup.injector.faults):
            # clause spent: let the signals recover so the (now
            # unblocked) ladder can step down
            gov.sample_signals = lambda: {"queue_fill": 0.0}
    m = node.metrics
    node.publish_batcher.close()
    return {
        "grades": grades,
        "max_grade": max(grades),
        "final_grade": gov.grade,
        "actions_hist": actions_hist,
        "final_actions": list(gov._armed),
        "alarm_seen": alarm_seen,
        "alarm_active": node.alarms.is_active("overload"),
        "stuck_alarm_seen": stuck_alarm_seen,
        "stuck_alarm_active": node.alarms.is_active("overload_stuck"),
        "stuck_polls": m.val("pipeline.overload.stuck_polls"),
        "sheds": m.val("pipeline.overload.sheds"),
        "grade_changes": m.val("pipeline.overload.grade_changes"),
        "fired": sum(f.fired for f in sup.injector.faults),
        "sample_restored": rec is None or rec.sample == sample0,
        "depth_restored":
            node.publish_batcher.dispatch_depth == depth0,
        "flags_clear": not (gov.shed_qos0 or gov.connects_paused
                            or gov.retained_deferred),
    }


def grade_overload(case: dict, point: str) -> list:
    """The overload-cell oracle: violations (empty = green)."""
    bad = []
    if case["fired"] == 0:
        bad.append("no armed overload clause ever fired (harness bug)")
    if point == "signal_spike":
        if case["max_grade"] < 3:
            bad.append(f"spike never reached critical "
                       f"(max grade {case['max_grade']})")
        if case["sheds"] < 1:
            bad.append("no shed action ever armed")
        if not case["alarm_seen"]:
            bad.append("overload alarm never raised")
        if case["final_grade"] != 0:
            bad.append(f"never recovered to normal "
                       f"(final grade {case['final_grade']})")
        if case["final_actions"]:
            bad.append(f"actions not unwound: {case['final_actions']}")
        if case["alarm_active"]:
            bad.append("overload alarm stuck active after recovery")
        if not (case["sample_restored"] and case["depth_restored"]
                and case["flags_clear"]):
            bad.append("shed side-effects not restored on recovery")
        # the grade path is a ladder, never a jump
        for a, b in zip(case["grades"], case["grades"][1:]):
            if abs(a - b) > 1:
                bad.append(f"grade jumped {a}->{b}")
                break
    elif point == "stuck_grade":
        if not case["stuck_alarm_seen"]:
            bad.append("overload_stuck alarm never raised")
        if case["stuck_polls"] < 3:
            bad.append(f"stuck polls never accumulated "
                       f"({case['stuck_polls']})")
        if case["final_grade"] != 0:
            bad.append(f"ladder never recovered once unstuck "
                       f"(final grade {case['final_grade']})")
        if case["stuck_alarm_active"]:
            bad.append("overload_stuck alarm never cleared")
    return bad
