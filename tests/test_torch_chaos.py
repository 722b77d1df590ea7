"""Port vs JAX reference: the chaos matrix of the supervision layer.

Each (point, kind) cell of ``emqx_tpu_torch.chaos`` — every pipeline
injection point (``dispatch``, ``materialize``, ``cache_insert``,
``overlay_apply``, ``lane_deliver``, ``snapshot_swap``) × every fault
kind (``exception``, ``resource``, ``hang``, ``corrupt``) — runs on the
port's CPU node and on the JAX node (``tools/chaos_bench.run_case``)
under the same schedule and tuning (threshold 1, cooldown 0.05 s,
watchdog floor 0.1 s, multiplier 0). Required: equal per-session
delivery sequences and settled counts on the scheduled windows, equal to
both packages' fault-free twins; the reference's oracle on both; and on
the port: the stall and replay conditions, a trip within the faulted
window, the ladder back at rung 0 with every breaker closed, the window
journal and the HBM ledger's pins at 0 (``chaos.grade``).

Then the departure the port takes on the card, driven here with
``fail_on_device_error`` set: what the injector caused (an injected
fault, an injected out of memory, a corrupt readback, a stall while an
injected hang sleeps) replays on the host; a plain ``RuntimeError``, a
real ``torch.cuda.OutOfMemoryError`` or a real stall in the engine's
dispatch or readback raises to the window's publishers and sets
``engine.failed``.
"""

import os
import sys

import pytest
import torch

from emqx_tpu_torch import chaos as TC
from emqx_tpu_torch.broker.supervise import (FAULT_KINDS, FaultInjector,
                                             InjectedFault,
                                             InjectedResourceExhausted,
                                             parse_faults)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import chaos_bench as CB                                    # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module")
def twins():
    """Both packages' fault-free twins, plain and with the delta filter;
    they must deliver alike."""
    out = {}
    for delta in (False, True):
        t = TC.run_twin(delta=delta, device="cpu")
        j = CB.run_twin(delta=delta)
        assert t["counts"] == j["counts"]
        assert t["order"] == j["order"]
        assert t["device_batches"] > 0
        out[delta] = (t, j)
    return out


@pytest.mark.parametrize("kind", FAULT_KINDS)
@pytest.mark.parametrize("point", TC.MATRIX_POINTS)
def test_chaos_cell_equals_reference(point, kind, twins):
    t_twin, j_twin = twins[point == "overlay_apply"]
    t = TC.run_case(point, kind, device="cpu")
    j = CB.run_case(point, kind)
    assert TC.grade(t, t_twin, point, kind) == []
    assert CB.grade(j, j_twin, point, kind) == []
    assert TC.scheduled(t, t_twin) == TC.scheduled(j, j_twin) \
        == TC.scheduled(t_twin, t_twin)
    # the reference's own matrix test adds these to its oracle
    if kind == "hang" and point in TC.WATCHDOGGED:
        assert j["stalls"] >= 1
    if kind != "hang" and point in ("dispatch", "materialize"):
        assert j["replays"] >= 1


@pytest.fixture(scope="module")
def mesh_twin():
    """The fault-free run of the mesh node (multichip, dp=2 x route=4)."""
    t = TC.run_twin(device="cpu", mesh=True)
    assert t["device_batches"] > 0 and t["exchange_windows"] > 0
    return t


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_mesh_exchange_cell(kind, twins, mesh_twin):
    """The mesh_exchange point on the mesh node: each kind, counted by the
    injector (one firing), replays its window on the host or stalls and
    replays (hang), the breaker trips and re-closes, the ladder ends at
    rung 0, and every session's deliveries equal the fault-free mesh
    run's, which equal the single-chip node's."""
    case = TC.run_case("mesh_exchange", kind, device="cpu", mesh=True)
    assert TC.grade(case, mesh_twin, "mesh_exchange", kind) == []
    assert case["replays"] >= 1 and case["fired"] == 1
    t_twin, _j = twins[False]
    assert TC.scheduled(case, mesh_twin) == TC.scheduled(mesh_twin, t_twin) \
        == TC.scheduled(t_twin, t_twin)
    if kind == "hang":
        assert case["stalls"] >= 1


@pytest.mark.parametrize("fault", [
    "dispatch:exception", "materialize:resource", "materialize:corrupt",
    "dispatch:hang", "oom"])
def test_contained_faults_replay_on_the_card(fault):
    """Where device errors are fatal, the faults the ladder contains —
    those the injector caused — replay their window on the host: every
    message delivered (2 each), nothing raised, the engine not failed,
    the breaker back closed. ``oom`` is the injector's out of memory
    raised from inside the engine's own dispatch."""
    def arm(eng, sup):
        if fault == "oom":
            TC.raise_once(eng, "_dispatch_inner",
                          InjectedResourceExhausted("dispatch"))
        else:
            spec = fault + (":hang_s=0.3" if fault.endswith("hang") else "")
            sup.injector = FaultInjector(parse_faults(spec))

    node, out = TC.fatal_drive(arm, device="cpu")
    assert all(c == 2 for w in out for c in w), out
    m = node.metrics
    assert m.val("supervise.replays") >= 1
    assert node.device_engine.failed is None
    assert node.supervisor.journal_depth() == 0
    if fault == "dispatch:hang":
        assert m.val("supervise.stalls.dispatch") >= 1


@pytest.mark.parametrize("stage", ["_dispatch_inner", "_materialize"])
def test_real_error_raises_on_the_card(stage):
    """Where device errors are fatal, a plain ``RuntimeError`` raised by
    the engine's own dispatch or readback is not replayed: the window's
    publishers get it, ``engine.failed`` holds it and every later window
    raises; nothing is counted as a supervised fault or replay. On the
    CPU the same error replays."""
    node, out = TC.fatal_drive(lambda eng, sup: TC.raise_once(
        eng, stage, RuntimeError("kernel broke")), device="cpu")
    first = out[0]
    assert all(isinstance(c, RuntimeError) for c in first)
    assert "kernel broke" in {str(c) for c in first}
    assert str(node.device_engine.failed) == "kernel broke"
    assert all(isinstance(c, RuntimeError) for w in out[1:] for c in w)
    m = node.metrics
    assert m.val("supervise.replays") == 0
    assert m.val("supervise.faults") == 0
    assert m.val("routing.host.messages") == 0

    # the same error on the CPU's rules is contained and replayed
    def cpu_rules(eng, sup):
        eng.fail_on_device_error = False
        TC.raise_once(eng, stage, RuntimeError("kernel broke"))

    node, out = TC.fatal_drive(cpu_rules, device="cpu", windows=1)
    assert all(c == 2 for w in out for c in w)
    assert node.metrics.val("supervise.replays") == 1
    assert node.device_engine.failed is None


@pytest.mark.parametrize("fault", ["oom", "stall"])
def test_real_oom_and_stall_raise_on_the_card(fault):
    """Where device errors are fatal, a real out of memory in the
    engine's dispatch and a real stall of its readback past the watchdog
    (no hang clause armed) are not replayed: the window's publishers get
    them and ``engine.failed`` holds them. The stalled thread still
    releases the window's pins when it leaves, and the journal drains.
    On the CPU's rules the same stall replays."""
    def arm(eng, sup):
        if fault == "oom":
            TC.raise_once(eng, "_dispatch_inner",
                          torch.cuda.OutOfMemoryError("real oom"))
        else:
            TC.stall_once(eng, "_materialize", 3 * TC.WATCHDOG_FLOOR_S)

    want = torch.cuda.OutOfMemoryError if fault == "oom" else TimeoutError
    node, out = TC.fatal_drive(arm, device="cpu")
    assert all(isinstance(c, want) for c in out[0]), out[0]
    assert isinstance(node.device_engine.failed, want)
    assert all(isinstance(c, RuntimeError) for w in out[1:] for c in w)
    m = node.metrics
    assert m.val("supervise.replays") == 0
    assert m.val("supervise.faults") == 0
    assert node.supervisor.journal_depth() == 0
    assert node.hbm_ledger.pin_state()["outstanding"] == 0

    if fault == "stall":
        def cpu_rules(eng, sup):
            eng.fail_on_device_error = False
            arm(eng, sup)

        node, out = TC.fatal_drive(cpu_rules, device="cpu", windows=1)
        assert all(c == 2 for w in out for c in w)
        assert node.metrics.val("supervise.stalls.materialize") == 1
        assert node.device_engine.failed is None


def test_injected_fault_is_the_contained_class():
    """An InjectedFault raised where the RuntimeError above was replays
    even on the card: the class, not the place, decides."""
    node, out = TC.fatal_drive(
        lambda eng, sup: TC.raise_once(eng, "_dispatch_inner",
                                       InjectedFault("injected")),
        device="cpu")
    assert all(c == 2 for w in out for c in w)
    assert node.device_engine.failed is None
    assert node.metrics.val("supervise.replays") == 1
