"""Each per-layer metric's reader on a synthetic traced slice, and the
trace reduction it stands on."""

import json
import os

import pytest

from benchmark import roofline
from benchmark.common import SLICE, Trace
from benchmark.run import load_module

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "t_" + name.replace(".", "_"))


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def slice_trace():
    """A 1,000 us slice: two kernel-1 launches of 10 us, three kernel-2
    launches of 2 us, a 100 us and a 50 us DtoH copy, a 200 us HtoD copy;
    one kernel past the slice's end is cut off."""
    return Trace([
        ev("user_annotation", SLICE, 0, 1000),
        ev("user_annotation", "bench.route_encoded", 0, 500),
        ev("cpu_op", "aten::copy_", 0, 200),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0, 200),
        ev("kernel", "shape_match_kernel(int const*)", 300, 10),
        ev("kernel", "ps_short(int const*, int*)", 310, 2),
        ev("kernel", "ps_long(int const*, int*)", 312, 2),
        ev("kernel", "ps_copy(int const*, int*)", 400, 2),
        ev("kernel", "void at::native::foo<int>()", 402, 8),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 410, 100),
        ev("kernel", "shape_match_kernel(int const*)", 700, 10),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 750, 50),
        ev("kernel", "late_kernel", 1000, 10),
    ])


def test_trace_reduction():
    tr = slice_trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(384e-6)
    assert tr.n_kernels() == 6
    assert tr.kernels("shape_match") == pytest.approx([10e-6, 10e-6])
    assert tr.copies("DtoH") == pytest.approx([100e-6, 50e-6])
    gaps = tr.idle_gaps()
    assert sum(b - a for a, b in gaps) == pytest.approx(616)
    labels = dict(tr.gap_labels(step_us=1.0))
    assert sum(labels.values()) == pytest.approx(616e-6)
    assert labels["bench.route_encoded"] == pytest.approx(186e-6)
    assert labels["no host range"] == pytest.approx(430e-6)
    top = tr.top_device_ops()
    assert top[0] == ["Memcpy HtoD (Pageable -> Device)",
                      pytest.approx(200e-6)]


def engine_rec():
    return {"trace": slice_trace(), "windows": 2, "W": 8, "B": 1024,
            "max_levels": 8, "shape_levels": [4], "compatible": 1,
            "launch_shapes": {(8, 1024): 2, (16384,): 1},
            "window_p99_ms": 31.5}


def test_engine_readers():
    rec = engine_rec()
    least = roofline.shape_match_s(8 * 1024, 8, [4], 1)
    assert reader("shape_match_roofline").read(rec) == pytest.approx(
        100 * least / 10e-6)
    ps = 2 * roofline.prefix_sum_s((8, 1024)) + roofline.prefix_sum_s(
        (16384,))
    assert reader("prefix_sum_roofline").read(rec) == pytest.approx(
        100 * ps / 6e-6)
    assert reader("launches_per_window").read(rec) == 3
    assert reader("d2h_ms_per_window").read(rec) == pytest.approx(0.075)
    assert reader("device_idle_share.engine").read(rec) == pytest.approx(
        61.6)
    assert reader("window_p99_ms").read(rec) == 31.5
    assert reader("window_p99_ms").read({"window_p99_ms": None}) is None


def test_readers_find_nothing_without_a_trace():
    empty = {"trace": Trace([ev("user_annotation", SLICE, 0, 100)]),
             "windows": 2, "launch_shapes": {}}
    for name in ("shape_match_roofline", "prefix_sum_roofline",
                 "launches_per_window", "d2h_ms_per_window",
                 "device_idle_share.engine"):
        assert reader(name).read(empty) is None
        assert reader(name).read({"trace": None}) is None


def test_least_times():
    # bytes bound: 8,192 topics of 8 words, one 96-byte row each
    n = 8192
    want = (n * (8 * 4 + 5) + n * 96 + n * 4 + n * 4) / 3.35e12
    assert roofline.shape_match_s(n, 8, [4], 1) == pytest.approx(want)
    assert roofline.prefix_sum_s((8, 131072)) == pytest.approx(
        2 * 4 * 8 * 131072 / 3.35e12)


def test_every_listed_metric_has_a_reader():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert hasattr(reader(m["name"]), "read"), m["name"]

