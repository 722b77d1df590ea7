"""Window-causal flight recorder for the device route pipeline.

The port's copy of ``emqx_tpu/broker/trace.py``. The stage histograms of
the pipeline telemetry aggregate away what a gap diagnosis needs:
CAUSALITY (which admit fed which dispatch fed which delivery) and
OVERLAP (how much dispatch(W+1) hides materialize(W), and where the
bubbles sit). This module is the causal layer under the histograms:

- **Window traces**: every publish window gets a trace id minted at
  batcher admit (`FlightRecorder.new_trace`) and carried through the
  pipeline — enqueue and batch_form, dispatch, materialize, the consume
  (deliver), the delivery lanes (the plan carries its window's trace),
  down to settle. A window the supervisor replays on the host KEEPS its
  trace id: the replay is a child event of the window root and the host
  route parents to it. The supervisor's breaker trips, rung changes and
  lane-worker restarts land as node-scope events (trace id 0). Under an
  active device trace
  (``DeviceRouteEngine.start_device_trace``) each dispatch, a CUDA graph
  replay included, runs inside ``torch.profiler.record_function(
  "route_step#<trace id>")``, so the card's timeline joins the host one
  on the trace id. The id lives on the host only: it never enters a
  captured graph's arguments.
- **Sampled per-message spans** ride the window trace: one in
  ``broker.trace_sample`` messages records its own enqueue→settle span
  with its topic, so tail latency decomposes per message, not just per
  batch.
- **The flight recorder**: spans land in a lock-free bounded ring (one
  ``itertools.count`` bump and one list-slot store per span under the
  GIL). The ring keeps the last ``cap`` spans, dumpable after the fact
  (``FlightRecorder.dump(path)``, a Chrome trace-event document).
- **The overlap/bubble analyzer** (`analyze_spans`): per-window stage
  occupancy, the dispatch↔materialize overlap fraction, and gap
  attribution — every uncovered interval inside a window is billed to
  ``host_stall`` (waiting on the loop / the consumer), ``device_stall``
  (waiting on the card or the readback) or ``lane_backpressure``
  (waiting on the delivery lanes).

Knobs (config only; the reference's environment knobs are not ported):
``broker.trace`` (on), ``broker.trace_sample`` (256; 0 disables message
spans), ``broker.trace_ring`` (span capacity, 4096).

Exported as the Chrome trace-event JSON above, the ``trace`` section of
`PipelineTelemetry.snapshot()` and the ``trace.spans`` /
``trace.windows`` / ``trace.dropped`` counters of the node's Metrics.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import defaultdict
from typing import Optional

SCHEMA = "emqx_tpu.trace/v1"

# trace id 0 is the node scope: events that belong to no single window
# (breaker trips, rung changes, lane-worker restarts)
NODE_TRACE = 0

# gap attribution: an uncovered interval inside a window is billed by
# the span that ENDS the gap — what the window was waiting FOR
_GAP_ATTR = {
    "dispatch": "host_stall",        # formed, waiting for the dispatch
    "dispatch_cached": "host_stall",  # thread / a pipeline slot
    "batch_form": "host_stall",
    "host_route": "host_stall",
    "deliver": "host_stall",         # readback done, consumer busy
    "materialize": "device_stall",   # dispatched, device/readback pending
    "replay": "host_stall",
    "settle": "host_stall",
}
_LANE_ATTR = "lane_backpressure"
BUBBLE_CLASSES = ("host_stall", "device_stall", "lane_backpressure")


def resolve_trace(configured=None) -> bool:
    """``broker.trace``, default on. Off builds no recorder anywhere: the
    window and message spans, the telemetry's ``trace`` section and the
    ``trace.*`` counters are absent and deliveries are unchanged."""
    return True if configured is None else bool(configured)


def resolve_trace_sample(configured=None) -> int:
    """``broker.trace_sample``: one in N messages records its own
    enqueue→settle span, default 256. 0 disables message spans (window
    spans stay on); a negative value is a deployment error."""
    n = 256 if configured is None else int(configured)
    if n < 0:
        raise ValueError(f"trace_sample must be >= 0, got {n}")
    return n


class Span:
    """One recorded span: a (trace, name, track, [t0, t1]) interval in
    the shared perf_counter time base. ``t0 == t1`` is an instant event
    (replay, rung_change, lane_restart). ``parent_id`` links causal
    children (a replay's host_route is a child of the replay span,
    which is a child of the window root)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "track",
                 "t0", "t1", "meta", "slot")

    def __init__(self, trace_id, span_id, parent_id, name, track,
                 t0, t1, meta, slot=0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t0 = t0
        self.t1 = t1
        self.meta = meta
        self.slot = slot    # ring write cursor at record time

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)


class FlightRecorder:
    """Lock-free bounded span ring + the export/analysis surfaces.

    Thread-safety: ``record`` runs on the event loop AND the dispatch/
    read executor threads concurrently. Each writer claims a unique
    monotonic slot via ``itertools.count().__next__`` (atomic under the
    GIL) and stores into its own ring index — no lock, no torn reads
    (readers snapshot the buffer list and sort by span id). The
    recorded/dropped accounting is derived from the slot numbers in
    the ring at read time, so writers share no mutable counter.
    """

    def __init__(self, metrics=None, *, cap: int = 4096,
                 sample: Optional[int] = None):
        self.cap = max(16, int(cap))
        self.metrics = metrics
        self.sample = resolve_trace_sample(sample) \
            if not isinstance(sample, int) else max(0, sample)
        self._buf: list = [None] * self.cap
        self._slot = itertools.count()       # unique write cursor
        self._ids = itertools.count(1)       # trace + span ids
        self._msg_tick = itertools.count()   # message-sampling clock
        self.windows = 0                     # traces minted (approximate)
        # one shared time base for every span: ts in exports are
        # relative to epoch_perf; epoch_wall anchors them to wall clock
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()

    # ---- recording (hot path) -------------------------------------------
    def new_trace(self) -> int:
        """Mint one window trace id (batcher admit)."""
        self.windows += 1
        if self.metrics is not None:
            self.metrics.inc("trace.windows")
        return next(self._ids)

    def record(self, trace_id: int, name: str, t0: float, t1: float, *,
               track: str = "pipeline", parent: int = 0,
               meta: Optional[dict] = None) -> int:
        """Record one span; returns its span id (for child linking)."""
        sid = next(self._ids)
        slot = next(self._slot)
        i = slot % self.cap
        if self.metrics is not None:
            self.metrics.inc("trace.spans")
            if self._buf[i] is not None:
                self.metrics.inc("trace.dropped")
        self._buf[i] = Span(trace_id, sid, parent, name, track,
                            t0, t1, meta, slot)
        return sid

    def event(self, trace_id: int, name: str, *,
              track: str = "events", parent: int = 0,
              meta: Optional[dict] = None) -> int:
        """Record one instant event (replay, rung change, restart)."""
        now = time.perf_counter()
        return self.record(trace_id, name, now, now, track=track,
                           parent=parent, meta=meta)

    def sample_hit(self) -> bool:
        """One global sampling decision per message: True one-in-
        ``sample`` calls (0 = never)."""
        if self.sample <= 0:
            return False
        return next(self._msg_tick) % self.sample == 0

    # ---- reading --------------------------------------------------------
    def spans(self) -> list[Span]:
        """Snapshot the ring, oldest first (span ids are monotone)."""
        return sorted((s for s in list(self._buf) if s is not None),
                      key=lambda s: s.span_id)

    def recorded(self) -> int:
        """Total spans ever recorded — derived from the highest write
        cursor present in the ring at read time, so concurrent writers
        need no shared read-modify-write on the hot path (a plain
        counter store races: a preempted writer's stale store would
        regress it). Exact once writers are quiescent; a consistent
        lower bound mid-flight (overwrites only raise slot numbers)."""
        return max((s.slot for s in list(self._buf) if s is not None),
                   default=-1) + 1

    def dropped(self) -> int:
        return max(0, self.recorded() - self.cap)

    def state(self) -> dict:
        return {"cap": self.cap, "recorded": self.recorded(),
                "dropped": self.dropped(), "sample": self.sample,
                "windows": self.windows}

    # ---- Chrome trace-event / Perfetto export ---------------------------
    def to_chrome(self, spans: Optional[list[Span]] = None) -> dict:
        """The ring as a Chrome trace-event document (Perfetto /
        chrome://tracing loadable): one process ``emqx_tpu pipeline``,
        one thread track per span track (batcher / dispatch /
        materialize / consume / lane{i} / messages / events), complete
        (``X``) events for real spans and instant (``i``) events for
        the zero-duration ones, args carrying the causal ids so
        `analyze_chrome` round-trips. The card's timeline joins on the
        ``trace_id`` arg: under a device trace the engine runs every
        dispatch inside ``record_function("route_step#<trace id>")``,
        so a torch.profiler capture of the same run names its device
        steps by the same ids."""
        if spans is None:
            spans = self.spans()
        pid = 1
        tids: dict[str, int] = {}
        events: list[dict] = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "emqx_tpu pipeline"}}]

        def tid_of(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids) + 1
                events.append({"ph": "M", "pid": pid, "tid": t,
                               "name": "thread_name",
                               "args": {"name": track}})
            return t

        for sp in spans:
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
            if sp.parent_id:
                args["parent_id"] = sp.parent_id
            if sp.meta:
                args.update(sp.meta)
            ev = {"name": sp.name, "cat": "pipeline", "pid": pid,
                  "tid": tid_of(sp.track),
                  "ts": round((sp.t0 - self.epoch_perf) * 1e6, 3),
                  "args": args}
            if sp.t1 > sp.t0:
                ev["ph"] = "X"
                ev["dur"] = round((sp.t1 - sp.t0) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA,
                              "epoch_wall": self.epoch_wall,
                              "dropped": self.dropped()}}

    def dump(self, path: str) -> str:
        """Write the Perfetto-loadable dump (post-mortem surface)."""
        doc = self.to_chrome()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    # ---- analysis -------------------------------------------------------
    def analyze(self, *, top: int = 3, per_window: int = 8) -> dict:
        return analyze_spans(self.spans(), top=top,
                             per_window=per_window)

    def snapshot_section(self) -> dict:
        """The ``trace`` section of `PipelineTelemetry.snapshot()`:
        ring state + the aggregate overlap/bubble analysis (per-window
        rows capped so $SYS payloads stay bounded)."""
        out = {"schema": SCHEMA, "ring": self.state()}
        a = self.analyze(per_window=4)
        for k in ("windows", "overlap", "stage_occupancy", "bubbles",
                  "last_windows"):
            if k in a:
                out[k] = a[k]
        return out


# ---- the overlap/bubble analyzer (pure functions, reusable offline) ----

def _union_and_gaps(intervals: list[tuple], w0: float, w1: float):
    """Merge [t0, t1, name] intervals clipped to [w0, w1]; return
    (covered_seconds, gaps) where each gap is (g0, g1, next_name) —
    the name of the span that ENDS the gap (what was being waited on).
    The trailing gap (after the last span) carries next_name=None."""
    ivs = sorted((max(w0, a), min(w1, b), n)
                 for a, b, n in intervals if b > a)
    covered = 0.0
    gaps = []
    cur = w0
    for a, b, n in ivs:
        if a > cur:
            gaps.append((cur, a, n))
        if b > cur:
            covered += b - max(cur, a)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1, None))
    return covered, gaps


def _attr_of(next_name: Optional[str], has_lanes: bool) -> str:
    if next_name is None:
        # trailing gap: the window sat settled-pending — on the lanes
        # when the trace shows lane work, else on the host consumer
        return _LANE_ATTR if has_lanes else "host_stall"
    if next_name.startswith("lane"):
        return _LANE_ATTR
    return _GAP_ATTR.get(next_name, "host_stall")


def analyze_spans(spans: list, *, top: int = 3,
                  per_window: int = 8) -> dict:
    """Per-window occupancy + bubbles and the global dispatch↔
    materialize overlap, from any span list (the live ring, or one
    reconstructed from a Perfetto dump by `analyze_chrome`).

    Returns::

        {"windows": N,
         "overlap": {"dispatch_materialize": 0.42,
                     "materialize_s": ..., "overlapped_s": ...},
         "stage_occupancy": {stage: {"total_s":, "mean_frac":}},
         "bubbles": {"host_stall_s":, "device_stall_s":,
                     "lane_backpressure_s":, "total_s":,
                     "top": [[label, seconds], ...]},
         "last_windows": [{"trace_id":, "span_s":, "stages": {...},
                           "bubbles": [[attr, s], ...]}, ...]}
    """
    by_trace: dict[int, list] = defaultdict(list)
    dispatches: list[tuple] = []
    materializes: list[tuple] = []
    for sp in spans:
        if sp.trace_id > NODE_TRACE:
            by_trace[sp.trace_id].append(sp)
        if sp.name in ("dispatch", "dispatch_cached") and sp.t1 > sp.t0:
            dispatches.append((sp.t0, sp.t1, sp.trace_id))
        elif sp.name == "materialize" and sp.t1 > sp.t0:
            materializes.append((sp.t0, sp.t1, sp.trace_id))

    # dispatch↔materialize overlap: how much of each window's readback
    # was hidden under ANOTHER window's dispatch (what the batcher's
    # dispatch_depth >= 2 settle ring buys). Fraction of total
    # materialize seconds covered by a different trace's dispatch.
    dispatches.sort()
    materializes.sort()
    mat_s = 0.0
    hidden_s = 0.0
    lo = 0
    for m0, m1, mtid in materializes:
        mat_s += m1 - m0
        # both lists are time-sorted: a dispatch ending at or before
        # this m0 can never cover this or any LATER materialize, so
        # the scan start only moves forward — amortized O(D+M) where
        # a full rescan per materialize is O(D*M) (analyze runs inside
        # snapshot() on the event loop, on every $SYS tick)
        while lo < len(dispatches) and dispatches[lo][1] <= m0:
            lo += 1
        cover: list[tuple] = []
        for j in range(lo, len(dispatches)):
            d0, d1, dtid = dispatches[j]
            if d0 >= m1:
                break
            if dtid == mtid or d1 <= m0:
                continue
            cover.append((max(d0, m0), min(d1, m1), ""))
        covered, _g = _union_and_gaps(cover, m0, m1)
        hidden_s += covered
    overlap = {}
    if materializes:
        overlap = {
            "dispatch_materialize": round(hidden_s / mat_s, 4)
            if mat_s else 0.0,
            "materialize_s": round(mat_s, 6),
            "overlapped_s": round(hidden_s, 6),
        }

    stage_tot: dict[str, float] = defaultdict(float)
    stage_frac: dict[str, list] = defaultdict(list)
    bubble_tot: dict[str, float] = dict.fromkeys(BUBBLE_CLASSES, 0.0)
    win_rows = []
    for tid in sorted(by_trace):
        sps = by_trace[tid]
        # the window interval: admit (first span start) → settle (last
        # span end); instant events bound it too (a replay marks time)
        w0 = min(s.t0 for s in sps)
        w1 = max(s.t1 for s in sps)
        span_s = w1 - w0
        if span_s <= 0:
            continue
        has_lanes = any(s.track.startswith("lane")
                        or s.name in ("lane_admit", "lane_drain")
                        for s in sps)
        stages: dict[str, float] = defaultdict(float)
        ivs = []
        for s in sps:
            if s.t1 <= s.t0 or s.name in ("window", "message"):
                continue    # events and roll-up spans don't cover work
            stages[s.name] += s.dur
            ivs.append((s.t0, s.t1, s.name))
        for name, d in stages.items():
            stage_tot[name] += d
            stage_frac[name].append(d / span_s)
        _covered, gaps = _union_and_gaps(ivs, w0, w1)
        attrs: dict[str, float] = defaultdict(float)
        for g0, g1, nxt in gaps:
            attrs[_attr_of(nxt, has_lanes)] += g1 - g0
        for k, v in attrs.items():
            bubble_tot[k] = bubble_tot.get(k, 0.0) + v
        win_rows.append({
            "trace_id": tid,
            "span_s": round(span_s, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "bubbles": [[k, round(v, 6)] for k, v in
                        sorted(attrs.items(), key=lambda kv: -kv[1])
                        ][:top],
        })

    out: dict = {"windows": len(win_rows)}
    if overlap:
        out["overlap"] = overlap
    if stage_tot:
        out["stage_occupancy"] = {
            k: {"total_s": round(v, 6),
                "mean_frac": round(sum(stage_frac[k])
                                   / len(stage_frac[k]), 4)}
            for k, v in stage_tot.items()}
    bub_total = sum(bubble_tot.values())
    if win_rows:
        out["bubbles"] = {
            **{f"{k}_s": round(v, 6) for k, v in bubble_tot.items()},
            "total_s": round(bub_total, 6),
            "top": [[k, round(v, 6)] for k, v in
                    sorted(bubble_tot.items(), key=lambda kv: -kv[1])
                    if v > 0][:top],
        }
        out["last_windows"] = win_rows[-per_window:]
    return out


def analyze_chrome(doc: dict, *, top: int = 3,
                   per_window: int = 0) -> dict:
    """Rebuild spans from a Chrome trace-event dump (`to_chrome` /
    `FlightRecorder.dump`) and run the same analyzer — the offline
    entry. per_window=0 keeps every window row (an offline report
    wants them all)."""
    spans = []
    # tid -> track from the thread_name metadata events: the analyzer's
    # lane attribution keys on span.track (has_lanes), so the offline
    # path must reconstruct it or lane_backpressure silently degrades
    # to host_stall on the very dump the post-mortem reads
    tracks: dict[tuple, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[(ev.get("pid"), ev.get("tid"))] = \
                (ev.get("args") or {}).get("name", "")
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        if "trace_id" not in args:
            continue
        t0 = float(ev.get("ts", 0)) / 1e6
        t1 = t0 + float(ev.get("dur", 0)) / 1e6
        meta = {k: v for k, v in args.items()
                if k not in ("trace_id", "span_id", "parent_id")}
        spans.append(Span(int(args["trace_id"]),
                          int(args.get("span_id", 0)),
                          int(args.get("parent_id", 0)),
                          ev.get("name", ""),
                          tracks.get((ev.get("pid"), ev.get("tid")),
                                     ""), t0, t1,
                          meta or None))
    spans.sort(key=lambda s: (s.t0, s.span_id))
    n_windows = len({s.trace_id for s in spans if s.trace_id > 0})
    return analyze_spans(spans, top=top,
                         per_window=per_window or max(1, n_windows))
