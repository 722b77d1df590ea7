"""The route window's profiler ranges (``device.span``).

Under a CPU profiler one ``RouteEngine.route_encoded`` call opens each
of its eight ranges once: ``route.window`` around seven stage ranges that
do not overlap and hold every operation of the window but views, with
``route.wait`` inside ``route.readback``. With no profiler running the
window enters no ``record_function`` at all, and the profiler changes
neither the readback nor the cursors. The node's deduplicated window
(``route_window_cached``) opens the same four window stages.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from emqx_tpu_torch.engine import RouteEngine
from emqx_tpu_torch.models import router_engine as RE
from emqx_tpu_torch.ops.match import encode_topics_str

torch.set_num_threads(1)

STAGES = ("route.upload", "route.match", "route.expand", "route.picks",
          "route.compact", "route.readback")
RANGES = ("route.window",) + STAGES + ("route.wait",)
# reshapes of a contiguous plane are views: no launch, no copy
VIEWS = {"aten::reshape", "aten::view", "aten::_reshape_alias"}
W, B = 2, 8

SUBS = {
    "a/+/c": [(1, 0), (2, 1)],
    "a/#": [(3, 0)],
    "$share/g/a/b/#": [(4, 0), (5, 1), (6, 2)],
    "$share/h/+/+/c": [(7, 1), (8, 0)],
    "x/y": [(9, 0)],
}
TOPICS = ["a/b/c", "a/b/d", "x/y", "a/q/c", "a/b", "b/b/c", "x/y/z",
          "a/b/c/d"]


def engine(payload_cap=4096):
    return RouteEngine.from_subscriptions(
        SUBS, device="cpu", batch=B, window=W, max_levels=8,
        payload_cap=payload_cap)


def window(eng, shift=0):
    topics = (TOPICS[shift:] + TOPICS[:shift]) * (W * B // len(TOPICS))
    enc, lens, dol, _too_long = encode_topics_str(eng.intern, topics,
                                                  eng.max_levels)
    return (enc.reshape(W, B, -1), lens.reshape(W, B), dol.reshape(W, B),
            np.zeros((W, B), np.int32))


def traced(fn, tmp_path):
    """``fn()`` under a CPU profiler: its result and the Chrome trace's
    user annotations and operations as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rb = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def spans(cat):
        return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == cat and "dur" in e]

    return rb, spans("user_annotation"), spans("cpu_op")


@pytest.mark.parametrize("payload_cap", [4096, 2],
                         ids=["csr", "dense_fallback"])
def test_each_range_once_nested_and_covering(tmp_path, payload_cap):
    eng = engine(payload_cap)
    rb, ann, ops = traced(lambda: eng.route_encoded(*window(eng)), tmp_path)
    assert (rb.dense is not None) == (payload_cap == 2)
    ours = [a for a in ann if a[0].startswith("route.")]
    assert sorted(n for n, _a, _b in ours) == sorted(RANGES)
    at = {n: (a, b) for n, a, b in ours}
    w0, w1 = at["route.window"]
    assert sorted(STAGES, key=lambda n: at[n]) == list(STAGES)
    stages = [at[n] for n in STAGES]
    for a, b in stages:
        assert w0 <= a <= b <= w1
    for (_a0, b0), (a1, _b1) in zip(stages, stages[1:]):
        assert b0 <= a1
    r0, r1 = at["route.readback"]
    assert r0 <= at["route.wait"][0] <= at["route.wait"][1] <= r1
    inside = [o for o in ops if w0 <= o[1] and o[2] <= w1]
    assert inside
    loose = {n for n, a, b in inside
             if not any(s0 <= a and b <= s1 for s0, s1 in stages)}
    assert loose <= VIEWS


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        entered.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    eng = engine()
    eng.route_encoded(*window(eng))
    eng.route_encoded(*window(eng, 3))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        eng.route_encoded(*window(eng))
    assert sorted(entered) == sorted(RANGES)


def test_readback_and_cursors_equal_with_and_without_a_profiler():
    off, on = engine(), engine()
    for shift in (0, 3, 5):
        rb_off = off.route_encoded(*window(off, shift))
        with profile(activities=[ProfilerActivity.CPU]):
            rb_on = on.route_encoded(*window(on, shift))
        for field in ("offsets", "counts3", "payload", "row_overflow",
                      "overflow"):
            np.testing.assert_array_equal(getattr(rb_off, field),
                                          getattr(rb_on, field))
        assert rb_off.dense is None and rb_on.dense is None
        assert torch.equal(off.cursors, on.cursors)
    assert int(off.cursors.sum()) > 0


def test_cached_window_opens_the_window_stages(tmp_path):
    """Every lane a miss: ``route_window_cached`` gives ``route_window``'s
    result, and its match (with the merge and gather), expand, picks and
    compact ranges each open once, in order, holding every operation but
    views."""
    eng = engine()
    topics, lens, dol, mh = (torch.as_tensor(x) for x in window(eng))
    kw = dict(fanout_cap=eng.fanout_cap, slot_cap=eng.slot_cap,
              payload_cap=eng.payload_cap)
    plain = RE.route_window(eng.tables, eng.cursors, topics, lens, dol, mh,
                            eng.strategy, **kw)
    n, width = plain.res.matches.shape[0] * B, plain.res.matches.shape[-1]
    lanes = torch.arange(n, dtype=torch.int32)
    args = (eng.tables, eng.cursors, topics.reshape(n, -1), lens.reshape(n),
            dol.reshape(n), torch.full((n, width), -1, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool), lanes, lanes.reshape(W, B),
            mh, eng.strategy)
    got, ann, ops = traced(lambda: RE.route_window_cached(*args, **kw),
                           tmp_path)
    for name in ("matches", "new_cursors", "occur", "shared_rows", "rows"):
        assert torch.equal(getattr(got.res, name), getattr(plain.res, name))
    for name in ("offsets", "payload"):
        assert torch.equal(getattr(got.compact, name),
                           getattr(plain.compact, name))
    order = ("route.match", "route.expand", "route.picks", "route.compact")
    ours = sorted((a, b, name) for name, a, b in ann
                  if name.startswith("route."))
    assert tuple(name for _a, _b, name in ours) == order
    for (_a0, b0, _n0), (a1, _b1, _n1) in zip(ours, ours[1:]):
        assert b0 <= a1
    loose = {name for name, a, b in ops
             if not any(s0 <= a and b <= s1 for s0, s1, _n in ours)}
    assert loose <= VIEWS
