"""What every driver shares: the traced slice and its reduction, the
device line, the check list and the result line.

A traced run profiles a steady slice of its window with
``torch.profiler`` (CPU and CUDA), inside a ``bench.slice`` range, and
reads the Chrome trace back: device intervals (kernels, copies, sets),
the host ranges open at each idle gap, and kernel records by name. The
reduction needs nothing of the program.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import sys
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
FORBIDDEN = ("jax", "jaxlib", "flax", "emqx_tpu")
SLICE = "bench.slice"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's (``emqx_tpu_torch`` is neither)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Trace:
    """A profiled slice: ``events`` a Chrome trace's complete events."""

    def __init__(self, events: list):
        sl = [e for e in events if e.get("name") == SLICE
              and e.get("cat") == "user_annotation"]
        if sl:
            self.t0 = float(sl[0]["ts"])
            self.t1 = self.t0 + float(sl[0]["dur"])
        else:
            ts = [float(e["ts"]) for e in events if "dur" in e]
            self.t0 = min(ts, default=0.0)
            self.t1 = max((float(e["ts"]) + float(e["dur"]) for e in events
                           if "dur" in e), default=0.0)
        self.device = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"],
              e["name"]) for e in events
             if e.get("cat") in DEVICE_CATS and "dur" in e
             and self.t0 <= float(e["ts"]) < self.t1))
        self.host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"],
              e["name"]) for e in events
             if e.get("cat") in HOST_CATS and "dur" in e
             and e.get("name") != SLICE))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        out = []
        for a, b, _c, _n in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(start, end) in trace microseconds of every idle stretch."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def kernels(self, pattern: str) -> list:
        """Durations in seconds of the kernels whose name matches."""
        rx = re.compile(pattern)
        return [(b - a) / 1e6 for a, b, c, n in self.device
                if c == "kernel" and rx.search(n)]

    def copies(self, kind: str) -> list:
        """Durations in seconds of the copies whose name holds ``kind``
        (``DtoH``, ``HtoD``)."""
        return [(b - a) / 1e6 for a, b, c, n in self.device
                if c == "gpu_memcpy" and kind in n]

    def n_kernels(self) -> int:
        return sum(1 for *_x, c, _n in self.device if c == "kernel")

    def top_device_ops(self, k: int = 10) -> list:
        by: dict = {}
        for a, b, _c, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n[:120], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def gap_labels(self, k: int = 10, step_us: float = 200.0) -> list:
        """Idle seconds by what the host was doing meanwhile: each gap is
        sampled every ``step_us`` and each sample goes to the innermost
        range then open (a benchmark or program range around the
        innermost operation); summed by label."""
        samples = []                  # (time, weight in seconds)
        for g0, g1 in self.idle_gaps():
            n = max(1, int((g1 - g0) // step_us))
            w = (g1 - g0) / n / 1e6
            samples.extend((g0 + (j + 0.5) * (g1 - g0) / n, w)
                           for j in range(n))
        active: list = []             # (end, -start, name, cat)
        hi = 0
        by: dict = {}
        host = self.host
        for t, w in samples:
            while hi < len(host) and host[hi][0] <= t:
                a, b, c, n = host[hi]
                heapq.heappush(active, (b, -a, n, c))
                hi += 1
            while active and active[0][0] <= t:
                heapq.heappop(active)
            label = _label(active)
            by[label] = by.get(label, 0.0) + w
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

def _label(active: list) -> str:
    if not active:
        return "no host range"
    spans = sorted(active, key=lambda x: x[1])    # innermost first
    ann = next((n for _b, _a, n, c in spans if c == "user_annotation"),
               None)
    op = next((n for _b, _a, n, c in spans if c == "cpu_op"), None)
    parts = [p for p in (ann, op) if p]
    return " > ".join(parts)[:120]


@contextmanager
def profiled(enabled: bool, out: dict, cuda: bool = True):
    """Profile the body under a ``bench.slice`` range; on exit
    ``out["trace"]`` holds its Trace (None when not ``enabled``)."""
    if not enabled:
        out["trace"] = None
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            yield
        if cuda:
            torch.cuda.synchronize()
    out["trace"] = trace_of(prof)


def trace_of(prof) -> Trace:
    """A finished ``torch.profiler`` profile as a Trace (through its
    Chrome export, a temporary file under ``TMPDIR``)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Trace(events)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


class Checks:
    """The numbers compared, each with its limit (exact checks: 0)."""

    def __init__(self):
        self.items: list = []

    def add(self, name: str, value, limit) -> None:
        self.items.append((name, value, limit))

    @property
    def ok(self) -> bool:
        return all(v is not None and v <= lim for _n, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def lines(self) -> list:
        return [f"check {n}: {v} (limit {lim})" for n, v, lim in self.items]

