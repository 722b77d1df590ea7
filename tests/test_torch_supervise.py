"""Port vs JAX reference: fault-domain supervision's own machinery.

The port's ``emqx_tpu_torch/broker/supervise.py`` against the JAX
package's ``emqx_tpu/broker/supervise.py`` on the CPU, exactly: the fault
spec grammar (clause states and the errors of malformed specs), the
injector's firing windows, the circuit breaker's state sequences under a
scripted clock, the ladder's rung and every gate over all open/closed
combinations of the breakers, the watchdog deadline over the same stage
observations, ``guard_task`` and ``spawn``, the telemetry's ``supervise``
section after the same run, and both overload chaos cells'
trajectories (``tools/chaos_bench.run_overload_case``). Plus the port's
own rule, ``supervise.contained``: what the ladder contains where device
errors are fatal (the card) and where they are not (the CPU), and which
watchdog expiries the injector caused (``injected_stall``).
"""

import asyncio
import itertools
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import supervise as JS
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.broker.telemetry import PipelineTelemetry as JTele
from emqx_tpu_torch import chaos as TC
from emqx_tpu_torch.broker import supervise as TS
from emqx_tpu_torch.broker.metrics import Metrics
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.broker.telemetry import PipelineTelemetry as TTele

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import chaos_bench as CB                                    # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

SPECS = [
    None, "", "dispatch:exception",
    "dispatch:exception,materialize:hang:after=2:count=3:hang_s=0.25, "
    "lane_deliver:resource",
    "cache_insert:corrupt:count=0", " , overlay_apply:hang:hang_s=1e-3 ,",
    "snapshot_swap:resource:after=7", "signal_spike:corrupt:count=6",
    "stuck_grade:exception:after=1:count=2", "mesh_exchange:hang",
    # malformed: every one must raise the same ValueError on both
    "dispatch", "nosuchpoint:exception", "dispatch:nosuchkind",
    "dispatch:exception:after", "dispatch:exception:welp=1",
    "dispatch:exception:count=x", "dispatch:exception:hang_s=fast",
    ":exception", "dispatch:",
]


def _parsed(mod, spec):
    try:
        return [(f.point, f.kind, f.after, f.count, f.hang_s, f.hits,
                 f.fired) for f in mod.parse_faults(spec)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_equals_reference(spec):
    assert _parsed(TS, spec) == _parsed(JS, spec)


def _fire_log(mod, spec, points, corrupt_ok):
    inj = mod.FaultInjector(mod.parse_faults(spec))
    out = []
    for p, ok in zip(points, corrupt_ok):
        try:
            out.append(inj.fire(p, corrupt_ok=ok))
        except mod.InjectedResourceExhausted as e:
            out.append(("resource", str(e)))
        except mod.InjectedFault as e:
            out.append(("fault", str(e)))
    return out, inj.state()


def test_injector_fires_as_reference():
    """The same traversals through the same clauses fire alike: the after
    and count windows, the corrupt decay, the resource message, the
    per-clause hit and fire counts."""
    rng = random.Random(3)
    pts = ("dispatch", "materialize", "cache_insert", "lane_deliver")
    kinds = ("exception", "resource", "corrupt")
    for _ in range(40):
        spec = ",".join(
            f"{rng.choice(pts)}:{rng.choice(kinds)}:after={rng.randrange(4)}"
            f":count={rng.randrange(4)}" for _ in range(rng.randrange(1, 4)))
        points = [rng.choice(pts) for _ in range(30)]
        ok = [rng.random() < 0.5 for _ in points]
        assert _fire_log(TS, spec, points, ok) == \
            _fire_log(JS, spec, points, ok), spec
    t = TS.FaultInjector(TS.parse_faults("dispatch:exception:count=1"))
    assert t.armed_at("dispatch") and not t.armed_at("materialize")
    with pytest.raises(TS.InjectedFault):
        t.fire("dispatch")
    assert not t.armed_at("dispatch") and t.armed()


def _breaker_trace(mod, ops, threshold, cooldown, cap):
    now = [0.0]
    br = mod.CircuitBreaker("dispatch", threshold=threshold,
                            cooldown_s=cooldown, max_cooldown_s=cap,
                            clock=lambda: now[0])
    out = []
    for op, arg in ops:
        if op == "tick":
            now[0] += arg
            r = None
        else:
            r = getattr(br, op)()
        out.append((op, r, br.allow(), br.snapshot(), br.opened_at))
    return out


def test_circuit_breaker_equals_reference():
    """Random scripted op sequences under a scripted clock: the same
    return values, allow() answers and snapshots (state, consecutive
    fails, trips, the doubling cooldown up to its cap) at every step."""
    rng = random.Random(11)
    ops_all = ("record_fault", "record_ok", "probe_due", "begin_probe",
               "probe_ok", "probe_fail")
    for trial in range(60):
        ops = []
        for _ in range(80):
            if rng.random() < 0.3:
                ops.append(("tick", rng.choice((0.01, 0.3, 1.0, 5.0))))
            else:
                ops.append((rng.choice(ops_all), None))
        args = (rng.randrange(0, 5), rng.choice((0.05, 1.0)),
                rng.choice((2.0, 30.0)))
        assert _breaker_trace(TS, ops, *args) == \
            _breaker_trace(JS, ops, *args), trial


def test_rung_and_gates_equal_reference():
    """All 2^9 open/closed combinations of the nine breakers: the same
    rung and the same five gates."""
    tsup = TS.PipelineSupervisor(TNode(device="cpu").metrics)
    jsup = JS.PipelineSupervisor(JNode(use_device=False).metrics)
    assert tuple(tsup.breakers) == tuple(jsup.breakers) == TS.FAULT_POINTS
    seen = set()
    for bits in itertools.product(("closed", "open", "half_open"),
                                  repeat=len(TS.FAULT_POINTS)):
        if "half_open" in bits and bits.count("half_open") > 1:
            continue
        for p, st in zip(TS.FAULT_POINTS, bits):
            tsup.breakers[p].state = st
            jsup.breakers[p].state = st
        got = (tsup.rung(), tsup.allow_device(), tsup.reuse_enabled(),
               tsup.lanes_enabled(), tsup.rebuild_enabled(),
               tsup.mesh_enabled())
        assert got == (jsup.rung(), jsup.allow_device(),
                       jsup.reuse_enabled(), jsup.lanes_enabled(),
                       jsup.rebuild_enabled(), jsup.mesh_enabled()), bits
        seen.add(got[0])
    assert seen == {TS.RUNG_FULL, TS.RUNG_DEVICE_PLAIN, TS.RUNG_HOST}


def test_deadline_equals_reference():
    """The same stage observations (dispatch, cached dispatch,
    materialize, the lanes' per-lane histograms) give the same deadline
    for every stage, at the default tuning and at others."""
    rng = np.random.RandomState(5)
    ttele, jtele = TTele(), JTele()
    tsup = TS.PipelineSupervisor(ttele.metrics, telemetry=ttele)
    jsup = JS.PipelineSupervisor(jtele.metrics, telemetry=jtele)
    stages = ("dispatch", "materialize", "lane_deliver", "snapshot_swap")
    for step in range(6):
        for name, scale in (("dispatch", 1e-3), ("dispatch_cached", 0.5),
                            ("materialize", 2e-2),
                            (f"deliver_lane{step % 3}", 0.3)):
            for v in rng.exponential(scale, 50):
                ttele.observe_stage(name, float(v))
                jtele.observe_stage(name, float(v))
        for floor, cap, mult in ((10.0, 120.0, 8.0), (0.1, 120.0, 0.0),
                                 (0.01, 1.5, 8.0), (0.0, 0.5, 100.0)):
            for s in (tsup, jsup):
                s.wd_floor_s, s.wd_cap_s, s.wd_mult = floor, cap, mult
            for st in stages:
                assert tsup.deadline(st) == jsup.deadline(st), (st, floor)
    # the reference's defaults are the port's keyword defaults
    d = TS.PipelineSupervisor(ttele.metrics)
    j = JS.PipelineSupervisor(jtele.metrics)
    assert (d.wd_floor_s, d.wd_cap_s, d.wd_mult) == \
        (j.wd_floor_s, j.wd_cap_s, j.wd_mult) == (10.0, 120.0, 8.0)
    assert {b.base_cooldown_s for b in d.breakers.values()} == \
        {b.base_cooldown_s for b in j.breakers.values()} == {1.0}
    assert {b.threshold for b in d.breakers.values()} == \
        {b.threshold for b in j.breakers.values()} == {3}


def _guard_drive(mod, metrics):
    """guard_task on a dying, a cancelled and a finishing task, and spawn
    with and without a loop: what each reports."""
    seen = []

    async def go():
        async def boom():
            raise RuntimeError("lane died")

        async def ok():
            return 1

        async def forever():
            await asyncio.sleep(60)

        loop = asyncio.get_running_loop()
        t1 = mod.guard_task(loop.create_task(boom()), "t1", metrics,
                            on_error=lambda e: seen.append(str(e)))
        t2 = mod.guard_task(loop.create_task(ok()), "t2", metrics)
        t3 = mod.guard_task(loop.create_task(forever()), "t3", metrics)
        t4 = mod.spawn(boom(), "spawned", metrics)
        await asyncio.sleep(0.02)
        t3.cancel()
        await asyncio.sleep(0.02)
        return (t1.done(), t2.result(), t3.cancelled(), t4 is not None,
                t4.done(), t4 in mod._spawned)

    before = mod.task_error_count()
    loop = asyncio.new_event_loop()
    try:
        got = loop.run_until_complete(go())
    finally:
        loop.close()

    async def never():
        raise AssertionError("must not run")

    coro = never()
    return (got, seen, mod.task_error_count() - before,
            metrics.val("supervise.task_errors"),
            mod.spawn(coro, "no-loop"), coro.cr_frame is None)


def test_guard_task_and_spawn_equal_reference():
    from emqx_tpu.broker.metrics import Metrics as JMetrics
    from emqx_tpu_torch.broker.metrics import Metrics as TMetrics
    t = _guard_drive(TS, TMetrics())
    assert t == _guard_drive(JS, JMetrics())
    assert t[2] == t[3] == 2 and t[1] == ["lane died"]


def _supervise_run(node, sup_mod):
    """One scripted run on a node's supervisor: an armed injector fired
    at a few points, faults, stalls, a restart, replays, a trip, an
    inline probe (no loop: it runs synchronously) that closes the
    breaker, two journal windows one of which settles."""
    sup = node.supervisor
    for br in sup.breakers.values():
        br.base_cooldown_s = br.cooldown_s = 0.0
    sup.injector = sup_mod.FaultInjector(sup_mod.parse_faults(
        "dispatch:exception:count=1,materialize:corrupt:after=1"))
    for p, ok in (("dispatch", False), ("materialize", True),
                  ("materialize", True), ("cache_insert", False)):
        try:
            sup.fire(p, corrupt_ok=ok)
        except sup_mod.InjectedFault:
            pass
    sup.note_fault("dispatch")
    sup.note_fault("cache_insert")
    sup.note_stall("materialize")
    sup.note_stall("materialize")
    sup.note_stall("materialize")     # the third opens the breaker
    sup.note_restart("lane_worker")
    sup.note_replay()
    sup.note_replay()
    sup.note_ok("dispatch")
    w1 = sup.journal_admit([("m", None)])
    sup.journal_admit([("m", None), ("n", None)])
    sup.journal_settle(w1)
    sup.poll()          # the materialize probe: inline, succeeds
    return node.pipeline_telemetry.snapshot()["supervise"]


def test_telemetry_section_equals_reference():
    """The ``supervise`` section of the port's node equals the JAX
    node's after the same run: the counters, faults by point, stalls by
    stage and the live state (rung, every breaker, journal depth, the
    armed clauses, the watchdog)."""
    t = _supervise_run(TNode(device="cpu"), TS)
    j = _supervise_run(JNode({"broker": {"device_fanout_cap": 16,
                                         "device_slot_cap": 4}},
                             use_device=True), JS)
    assert t == j
    assert t["faults_by_point"] == {"dispatch": 1, "cache_insert": 1,
                                    "materialize": 3}
    assert t["stalls_by_stage"] == {"materialize": 3}
    assert t["state"]["journal_depth"] == 1 and t["probes"] == 1
    assert t["state"]["rung"] == 0
    off = TNode({"broker": {"supervise": False}}, device="cpu")
    assert "supervise" not in off.pipeline_telemetry.snapshot()


@pytest.mark.parametrize("point", TC.OVERLOAD_POINTS)
def test_overload_cell_equals_reference(point):
    """``signal_spike`` and ``stuck_grade`` through the governor's poll:
    the port's trajectory (grades, armed actions, alarms, unwind) equals
    ``tools/chaos_bench.run_overload_case``'s, and both pass its
    oracle."""
    t = TC.run_overload_case(point, device="cpu")
    j = CB.run_overload_case(point)
    assert t == j
    assert TC.grade_overload(t, point) == [] == CB.grade_overload(j, point)


def test_contained_rule():
    """``supervise.contained``: on the CPU every exception is contained
    (the reference's contract); where device errors are fatal (the card)
    only what the injector caused is: an injected fault (its out of
    memory included), or any failure the caller knows the injector
    caused (``injected``: a stall while a hang clause sleeps, the consume
    of a corrupt readback). A real stall or out of memory is not."""
    errs = [TS.InjectedFault("x"), TS.InjectedResourceExhausted("x"),
            TimeoutError(), asyncio.TimeoutError(),
            torch.cuda.OutOfMemoryError("x"), RuntimeError("x"),
            AssertionError("x"), IndexError("x"), ValueError("x")]
    want = [True] * 2 + [False] * 7
    assert [TS.contained(e, False) for e in errs] == [True] * len(errs)
    assert [TS.contained(e, True) for e in errs] == want
    assert all(TS.contained(e, True, injected=True) for e in errs)


@pytest.mark.parametrize("point,stage", [
    ("dispatch", "dispatch"), ("materialize", "materialize"),
    ("cache_insert", "materialize")])
def test_injected_stall(point, stage):
    """A watchdog expiry is the injector's only while a hang clause
    sleeps at a point its stage traverses: before the clause fires and
    after its sleep ends it is not, and a hang elsewhere does not
    count."""
    sup = TS.PipelineSupervisor(Metrics())
    sup.injector = TS.FaultInjector(TS.parse_faults(
        f"{point}:hang:hang_s=0.3"))
    other = "materialize" if stage == "dispatch" else "dispatch"
    assert not sup.injected_stall(stage)
    t = threading.Thread(target=sup.fire, args=(point,))
    t.start()
    deadline = time.monotonic() + 2.0
    while not sup.injected_stall(stage) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sup.injected_stall(stage)
    assert not sup.injected_stall(other)
    t.join()
    assert not sup.injected_stall(stage)


def test_chip_smoke_supervise_on_cpu(monkeypatch):
    """chip_smoke.py's phase 8 supervision rounds and phase 13b rehearsed
    on the CPU at a reduced size (1,000 filters, 12,000 PUBLISHes a flood
    in batches of 16 — while the breaker is open the host path takes
    every batch, and the flood must outlast that — the chooser pinned to
    the device, the clauses armed earlier, a 0.5 s hang): the supervised
    flood leaves every supervise counter at 0, the unsupervised one runs
    with the supervisor detached everywhere, and the chaos flood delivers
    every message once and in order while the hang stalls, the faulted
    windows replay, three dispatch faults trip the breaker, the probe
    brings the ladder back to rung 0 and the first window after that
    equals the plain path (e2e_drive raises otherwise)."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "CHAOS_AFTER", (2, 5))
    monkeypatch.setattr(cs, "CHAOS_HANG_S", 0.5)
    monkeypatch.setattr(cs, "HOOK_ITERS", 200)
    runs = cs.E2E_RUNS[:1] + cs.E2E_SUPERVISE_RUNS[:1]
    r = cs.e2e_drive(torch.device("cpu"), n_filters=1000, n_sub=4,
                     n_pub=2, total=12000, window=(2, 64), runs=runs,
                     pin_device=True, chaos=True,
                     node_conf={"max_publish_batch": 16})
    fl = r["floods"]
    assert [fl[run[0]]["supervised"] for run in runs] == [True, False]
    for f in fl.values():
        assert f["supervise"] == dict.fromkeys(cs.SUPERVISE_ZERO, 0)
        assert f["delivered"] == f["sent"] == 12000
    assert r["supervise"] == dict.fromkeys(cs.SUPERVISE_ZERO, 0)
    assert r["supervise_section"]["state"]["rung"] == 0
    cost = r["supervise_cost_us"]
    assert set(cost) == {"journal", "poll", "note_ok", "deadline",
                         "allow_device", "watchdog_awaits", "total"}
    assert cost["total"] > 0
    c = r["chaos"]
    assert c["flood"]["delivered"] == c["flood"]["sent"] == 12000
    assert c["supervise"]["trips"] >= 1 and c["supervise"]["stalls"] >= 1
    assert c["supervise"]["replays"] >= 4
    assert c["held_err"] == 0 and c["batches_after_recovery"] > 0
    assert c["trip_to_rung0_s"] > 0
    assert c["journal_depth"] == c["ledger_pins"] == 0


def test_chip_smoke_chaos_on_cpu():
    """chip_smoke.py's phase 13a and 13d rehearsed on the CPU: the matrix
    with the CPU node in the card's place (every cell green, equal to the
    CPU node's), and the fatal departure on the card's rules: the real
    error, out of memory and stall raise, the injected fault replays."""
    import chip_smoke as cs
    m = cs.chaos_matrix(torch.device("cpu"))
    assert len(m["cells"]) == 24
    assert all(c["trips"] >= 1 for k, c in m["cells"].items()
               if not k.endswith(":hang"))
    f = cs.chaos_fatal(torch.device("cpu"))
    assert f["real_error"]["replays"] == 0
    assert f["injected"]["replays"] == 1
    assert f["oom"]["first_window"] == ["OutOfMemoryError"]
    assert f["stall"]["first_window"] == ["TimeoutError"]
    assert f["oom"]["replays"] == f["stall"]["replays"] == 0
