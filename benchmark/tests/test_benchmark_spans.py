"""The readers of the route window's stage ranges
(``host_ms_per_window.*``) on a synthetic traced slice: each sums its
range's durations inside the slice over the windows, the readback its
self time, and each reads nothing where the program opened no range."""

import os

import pytest

from benchmark.common import SLICE, Trace
from benchmark.run import load_module

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# stage -> its range's total us in the slice below (2 windows)
STAGES = {"upload": 30, "match": 100, "expand": 210, "picks": 420,
          "compact": 160, "wait": 90}


def reader(stage):
    name = "host_ms_per_window." + stage
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "t_" + name.replace(".", "_"))


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def window(t):
    """One window's ranges from ``t`` (us): each stage half of its total
    in STAGES, the readback 125 us around its wait, and operations and a
    kernel of the same names, which no reader counts."""
    out = [ev("user_annotation", "route.window", t, 1000)]
    for stage in ("upload", "match", "expand", "picks", "compact"):
        d = STAGES[stage] / 2
        out += [ev("user_annotation", "route." + stage, t, d),
                ev("cpu_op", "route." + stage, t, d)]
        t += d
    out += [ev("user_annotation", "route.readback", t, 125),
            ev("user_annotation", "route.wait", t + 10, STAGES["wait"] / 2),
            ev("kernel", "route.wait", t + 10, 40)]
    return out


def slice_trace(with_ranges=True):
    """A 2,000 us slice of two windows, and a window before it and one
    after it whose ranges no reader counts."""
    events = [ev("user_annotation", SLICE, 0, 2000),
              ev("kernel", "shape_match_kernel(int const*)", 10, 10)]
    if with_ranges:
        events += window(-1200) + window(0) + window(1000) + window(2000)
    return Trace(events)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_reader(stage):
    rec = {"trace": slice_trace(), "windows": 2}
    assert reader(stage).read(rec) == pytest.approx(STAGES[stage] / 1e3 / 2)


def test_readback_reader_takes_self_time():
    rec = {"trace": slice_trace(), "windows": 2}
    assert reader("readback").read(rec) == pytest.approx(
        (2 * 125 - STAGES["wait"]) / 1e3 / 2)


@pytest.mark.parametrize("stage", sorted(STAGES) + ["readback"])
def test_reader_without_its_range(stage):
    assert reader(stage).read({"trace": slice_trace(False),
                               "windows": 2}) is None
    assert reader(stage).read({"trace": None, "windows": 2}) is None
    assert reader(stage).read({"trace": slice_trace(), "windows": 0}) is None
