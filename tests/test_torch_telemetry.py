"""Port vs JAX reference: pipeline telemetry, and the HBM ledger.

After the same fixed windows through both engines (``Twin`` of
``tests/test_torch_engine.py``: the same sessions, subscriptions, churn
and windows through ``prepare_window`` / ``dispatch`` / ``materialize`` /
``finish_sub``), the port's telemetry snapshot equals the reference's in
its ``decisions``, ``dedup``, ``match_cache`` and ``readback`` window
counts and in every stage's count (timings are not compared), for each
routing-layer configuration on both backends.

The ledger (``emqx_tpu_torch/broker/hbm_ledger.py``) on CPU tensors: hold
and release, alias dedup by storage, the true peak, the stale-pin
sentinel firing once, a snapshot swap returning the bytes to baseline,
overlay versions released on compaction, live bytes reconciling with the
engine's tensors, and the hygiene check that every persistent device
tensor of the engine is held. The graph-class registry and the capture
accounting (the port's compile accounting) are held on a stand-in graph:
there are no CUDA graphs on the CPU.
"""

import gc
import random

import pytest
import torch

from emqx_tpu_torch.broker.hbm_ledger import HbmLedger, storage_key
from emqx_tpu_torch.broker.metrics import Metrics
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.broker.telemetry import PipelineTelemetry
from tests.test_torch_engine import (Twin, _mid_churn, shapes_population,
                                     shapes_topics, trie_population)
from tests.test_trie_match import rand_topic

torch.set_num_threads(1)


def _compare(twin) -> None:
    j = twin.j.pipeline_telemetry.snapshot(full=True)
    t = twin.t.pipeline_telemetry.snapshot(full=True)
    assert t["schema"] == j["schema"]
    for sec in ("decisions", "dedup", "match_cache"):
        assert t[sec] == j[sec], sec
    for k in ("windows_dense", "windows_compact"):
        assert t["readback"].get(k) == j["readback"].get(k), k
    assert {k: v["count"] for k, v in t["stages"].items()} == \
        {k: v["count"] for k, v in j["stages"].items()}
    assert {k: v["count"] for k, v in t["occupancy"].items()} == \
        {k: v["count"] for k, v in j["occupancy"].items()}


@pytest.mark.parametrize("layers", ["off", "cache", "overlay", "full",
                                    "rich"])
def test_snapshot_counts_equal_reference_shapes(layers):
    twin = Twin("round_robin", 1, shapes_population(random.Random(3)),
                shapes_topics, layers)
    for k in range(3):
        twin.window(1 + 3 * k, gate_cold=bool(k % 2))
    twin.churn()
    twin.topics = lambda rng, n: shapes_topics(rng, n - 2) + [
        "zz/a/late", f"s/{rng.randrange(60)}/t"]
    twin.window(2, gate_cold=True)
    twin.window(3, gate_cold=False, mid=_mid_churn)
    twin.window(4)
    _compare(twin)
    t = twin.t.pipeline_telemetry.snapshot()
    assert t["stages"]["deliver"]["count"] == 1 + 4 + 7 + 2 + 3 + 4
    if layers != "off":
        assert t["readback"]["windows_compact"] > 0


@pytest.mark.parametrize("layers", ["off", "cache", "full"])
def test_snapshot_counts_equal_reference_trie(layers):
    twin = Twin("round_robin", 1, trie_population(random.Random(5)),
                lambda rng, n: [rand_topic(rng) for _ in range(n)], layers)
    twin.window(1, gate_cold=False)
    twin.window(1)
    twin.churn()
    hot = [rand_topic(twin.rng) for _ in range(12)]
    twin.topics = lambda rng, n: [rng.choice(hot) for _ in range(n)]
    twin.window(1, gate_cold=False, n=150)
    twin.window(1, n=150)
    _compare(twin)


def _t(n: int, dtype=torch.int32):
    return torch.arange(n, dtype=dtype)


def test_ledger_hold_and_release():
    m = Metrics()
    led = HbmLedger(m)
    a, b = _t(100), _t(50, torch.int64)
    tree = {"x": (a, [b, None]), "y": 3}
    assert led.hold("snapshot_tables", tree, owner="s1") is tree
    assert led.live_bytes("snapshot_tables") == 400 + 400
    assert led.owner_bytes("snapshot_tables", "s1") == 800
    assert led.live_leaves() == 2
    assert m.val("pipeline.memory.holds") == 2
    del tree, a
    gc.collect()
    assert led.live_bytes() == 400 and led.live_leaves() == 1
    del b
    gc.collect()
    assert led.live_bytes() == 0 and led.live_leaves() == 0
    sec = led.section()
    row = sec["categories"]["snapshot_tables"]
    assert (row["holds"], row["releases"], row["peak_bytes"]) == (1, 2, 800)
    assert "owners" not in row and "device" not in sec
    assert m.val("pipeline.memory.releases") == 2
    assert m.val("pipeline.memory.release_bytes") == \
        m.val("pipeline.memory.hold_bytes") == 800


def test_ledger_alias_dedup_by_storage():
    """Views of one storage count once, under the first category, and
    release only when the last held view dies; holding one tensor twice
    is one hold."""
    led = HbmLedger()
    base = _t(256)
    v1, v2 = base[10:20], base.view(16, 16)
    led.hold("pipeline_buffers", (base, v1), owner="W1xB64")
    led.hold("snapshot_cursors", v2)
    led.hold("pipeline_buffers", base)
    assert led.live_bytes() == 1024 and led.live_leaves() == 1
    assert led.live_bytes("snapshot_cursors") == 0
    assert storage_key(v2) == storage_key(base)
    del base, v1
    gc.collect()
    assert led.live_bytes() == 1024     # v2 still holds the storage
    del v2
    gc.collect()
    assert led.live_bytes() == 0


def test_ledger_true_peak():
    """The global peak is the largest sum that existed at once, not the
    sum of the categories' peaks."""
    led = HbmLedger()
    a = _t(1000)
    led.hold("snapshot_tables", a)
    del a
    gc.collect()
    b = _t(600)
    led.hold("delta_overlay", b)
    sec = led.section()
    assert sec["peak_bytes"] == 4000
    assert sec["categories"]["snapshot_tables"]["peak_bytes"] == 4000
    assert sec["categories"]["delta_overlay"]["peak_bytes"] == 2400
    assert sec["live_bytes"] == 2400


def test_ledger_pin_sentinel_fires_once():
    from emqx_tpu_torch.broker.hooks import Hooks
    hooks = Hooks()
    fired = []
    hooks.add("pipeline.pin_stale", lambda info: fired.append(info))
    m = Metrics()
    led = HbmLedger(m, pin_warn_windows=3, hooks=hooks)
    led.pin(1)
    led.pin(2)
    for _ in range(2):
        led.note_window()
    led.unpin(2)
    for _ in range(10):
        led.note_window()
    assert led.pin_warnings == 1 and m.val("pipeline.memory.pin_warnings") \
        == 1
    assert fired == [{"age_windows": 4, "warn_windows": 3, "trace": 0}]
    st = led.pin_state()
    assert (st["outstanding"], st["max_age_windows"]) == (1, 12)
    led.unpin(1)
    assert led.pin_state()["outstanding"] == 0
    with pytest.raises(ValueError):
        HbmLedger(pin_warn_windows=0)


def _engine_tensors(eng) -> list:
    """Every device tensor of the engine's persistent state."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(eng._tables)
    walk(eng._cursors)
    if eng._overlay is not None:
        walk(eng._overlay.dev)
    b = eng._built
    if b is not None and b.cover is not None:
        walk(b.cover.dev_app)
    for gr in eng._graphs.values():
        walk((gr.inputs, gr.cursors, gr.delta, gr.planes))
    return out


def _unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        seen[storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("layers", ["overlay", "full"])
def test_ledger_tracks_the_engine(layers):
    """The engine's persistent tensors are all held (the hygiene check),
    live bytes reconcile with them, overlay versions release on the
    compaction, and a swap to an equal snapshot returns the bytes to
    baseline."""
    twin = Twin("round_robin", 1, shapes_population(random.Random(3)),
                shapes_topics, layers)
    node, eng = twin.t, twin.t.device_engine
    led = node.hbm_ledger
    assert led is not None and eng.ledger is led
    twin.window(1, gate_cold=False)
    gc.collect()
    base = led.live_bytes("snapshot_tables")
    assert base > 0
    if layers == "full":
        assert led.live_bytes("cover_csr") > 0
    twin.churn()
    twin.topics = lambda rng, n: shapes_topics(rng, n - 1) + ["zz/a/late"]
    twin.window(2, gate_cold=False)
    twin.window(1, gate_cold=False, mid=_mid_churn)
    gc.collect()
    held = _engine_tensors(eng)
    assert all(led.holds_tensor(t) for t in held)
    assert led.live_bytes() == _unique_bytes(held)
    del held
    cats = led.section()["categories"]
    if layers == "overlay":
        # one owner per overlay version
        assert led.live_bytes("delta_overlay") > 0
        assert all(k.startswith("v") for k in cats["delta_overlay"]["owners"])
    else:
        # the churn's filters a root covers are appends: one version each
        assert any("a" in k for k in cats["cover_csr"]["owners"])
    assert led.pin_state()["outstanding"] == 0
    eng.rebuild()
    gc.collect()
    assert led.live_bytes("delta_overlay") == 0
    assert led.live_bytes() == _unique_bytes(_engine_tensors(eng))
    # unsubscribe what churn added: the rebuilt snapshot equals the first
    for sid, f in ((9, "zz/+/late"), (11, "s/7/+/late")):
        for n in (twin.j, twin.t):
            n.broker.unsubscribe(sid, f)
    eng.rebuild()
    gc.collect()
    sec = led.section()
    assert set(sec["categories"]["snapshot_tables"]["owners"]) == \
        {f"s{eng._built.sid}"}
    assert abs(led.live_bytes("snapshot_tables") - base) <= base // 4
    assert led.live_bytes() == _unique_bytes(_engine_tensors(eng))


def test_graph_registry_and_capture_accounting():
    """A capture (on a stand-in graph: no CUDA graphs on the CPU) lands in
    the engine's counts, the graph-class registry, the ledger's
    pipeline_buffers under the class label and the telemetry's compiles;
    replays count per class."""
    from emqx_tpu_torch.broker.device_engine import _Graph
    node = TNode(device="cpu")
    eng = node.device_engine
    cls = (8, 1024, 256, None, 8192)
    label = eng._class_label(cls)
    assert label == "W8xB1024mB256c8192"
    assert eng._class_label((1, 64, None, 16, None)) == "W1xB64d16"
    ins, cur, planes = [_t(64), _t(32)], _t(4), (_t(128), None)
    gr = _Graph(None, ins, cur, None, planes, [], label)
    eng._graphs[("k",)] = gr
    eng._note_capture(gr, 0.25)
    eng._graph_rows[label]["replays"] += 3
    snap = node.pipeline_telemetry.snapshot()
    assert snap["compiles"] == {"count": 1, "total_s": 0.25,
                                "by_shape": {label: {"count": 1,
                                                     "total_s": 0.25}}}
    assert snap["jit_cache"] == {"graph_classes": 1}
    row = snap["program_costs"]["route_window"][label]
    assert row == {"captures": 1, "capture_s": 0.25, "replays": 3,
                   "static_bytes": (64 + 32 + 4 + 128) * 4}
    assert eng.captures == 1 and node.metrics.val("pipeline.jit.compiles") \
        == 1
    mem = snap["memory"]["categories"]["pipeline_buffers"]
    assert mem["owners"] == {label: (64 + 32 + 4 + 128) * 4}


def test_node_layers_and_snapshot_sections():
    """The default Node builds telemetry, the ledger and min(4, cpus)
    lanes, each with its stats function; a snapshot carries their
    sections; the off switches build none; slow batches fire their
    hook."""
    import os
    node = TNode(device="cpu")
    assert node.deliver_lanes.n_lanes == min(4, os.cpu_count() or 1)
    assert node.pipeline_telemetry.ledger is node.hbm_ledger
    gauges = node.stats.sample()
    for k in ("pipeline.memory.live_bytes", "pipeline.deliver.lane_depth"):
        assert k in gauges
    snap = node.pipeline_telemetry.snapshot(full=True)
    for sec in ("rebuild", "deliver", "match_cache", "dedup", "readback",
                "memory"):
        assert sec in snap
    assert snap["deliver"]["state"]["lanes"] == node.deliver_lanes.n_lanes
    off = TNode({"broker": {"hbm_ledger": False, "deliver_lanes": 0,
                            "slow_batch_threshold_ms": 0}}, device="cpu")
    assert off.hbm_ledger is None and off.deliver_lanes is None
    assert "memory" not in off.pipeline_telemetry.snapshot()
    assert off.pipeline_telemetry.slow_batch_s is None
    fired = []
    node.hooks.add("batch.slow", lambda meta: fired.append(meta))
    t = node.pipeline_telemetry
    t.record_total(0.3, batch=5, path="device")
    t.record_total(0.1, batch=5, path="device")
    assert [f["batch"] for f in fired] == [5]
    assert node.metrics.val("pipeline.slow_batches") == 1
    assert PipelineTelemetry().snapshot()["stages"] == {}
