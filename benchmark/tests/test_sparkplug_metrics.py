"""The readback readers (``readback_roofline``, ``d2h_bytes_per_topic``)
on synthetic traced slices: each reads the program's ``d2h_bytes``
counter over the slice, and each reads nothing, without an error, from
a record that lacks the counter (the grid driver's) or a slice that
copied nothing from the device."""

import os

import pytest

from benchmark import host_link
from benchmark.common import SLICE, Trace
from benchmark.run import load_module

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "t_" + name.replace(".", "_"))


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def slice_trace(copies=True):
    """A 1,000 us slice with a 300 us and a 100 us DtoH copy (and an HtoD
    copy no reader counts)."""
    events = [ev("user_annotation", SLICE, 0, 1000),
              ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 0, 50),
              ev("kernel", "shape_match_kernel(int const*)", 60, 10)]
    if copies:
        events += [
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 100, 300),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 500, 100)]
    return Trace(events)


def rec(**kw):
    return dict({"trace": slice_trace(), "windows": 2, "W": 8, "B": 1024,
                 "d2h_bytes": 12_800_000, "csr_entries": 1_000_000}, **kw)


def test_readback_roofline():
    # 12.8 MB at 64 GB/s is 200 us of the slice's 400 us of DtoH
    assert host_link.readback_s(12_800_000) == pytest.approx(200e-6)
    assert reader("readback_roofline").read(rec()) == pytest.approx(50.0)


def test_d2h_bytes_per_topic():
    assert reader("d2h_bytes_per_topic").read(rec()) == pytest.approx(
        12_800_000 / (2 * 8 * 1024))


@pytest.mark.parametrize("name", ["readback_roofline",
                                  "d2h_bytes_per_topic"])
def test_reader_without_the_counter_or_a_copy(name):
    r = reader(name)
    grid = rec()
    del grid["d2h_bytes"], grid["csr_entries"]
    assert r.read(grid) is None
    assert r.read(rec(d2h_bytes=None)) is None
    assert r.read(rec(trace=None)) is None
    assert r.read(rec(trace=slice_trace(copies=False))) is None
