"""Device-path pipeline telemetry: stage spans, occupancy, graph captures.

The port's copy of ``emqx_tpu/broker/telemetry.py``. ``PipelineTelemetry``
owns log2-bucket histograms (``broker.metrics.Histogram``) for every
pipeline stage —

    enqueue      oldest-message wait in the submit queue before its batch
                 forms (broker/batcher._produce)
    batch_form   message.publish hook fold + live-filter per batch
    dispatch     the route window's launches (a CUDA graph replay, or the
                 eager window) on the engine stream
    dispatch_cached  the same span for a deduplicated / match-cache-backed
                 dispatch
    materialize  device->host readback
    deliver      the consume of one sub-batch; with the delivery lanes on
                 this is the PLAN construction span, and the delivery walk
                 lands in the per-lane deliver_lane{i} histograms
    deliver_lane{i}  one delivery-lane item (slice or barrier) on lane i
    host_route   host-path match + route span for host-routed batches
    host_match   per-message host trie match latency (sampled 1-in-32)
    total        oldest-enqueue -> batch completion

— plus batch-occupancy histograms per window class, the routing
decisions, and the reuse, readback, rebuild, delivery, columnar-ingress
and memory sections. Everything lands in the node's Metrics registry.

Compile accounting becomes CUDA-graph capture accounting: the port has
no JIT, and what stands in its place is the capture of a window class as
a CUDA graph (``DeviceRouteEngine._capture``), off the serving path. The
engine reports each capture (``note_capture``) under its class label, so
the snapshot's ``compiles`` section counts captures and their seconds by
class. ``jit_cache`` becomes the number of graph classes the engine holds
now, and the reference's jit-program cost registry becomes a graph-class
registry (``program_costs``, from the engine's ``graph_registry``): one
row per captured class with its captures, capture seconds, replays and
the static-buffer bytes the HBM ledger holds for it.

Route-window ranges. ``emqx_tpu_torch.device.span(name)`` opens a
``torch.profiler`` range (``record_function``) only while a profiler
records on the calling thread, and is a no-op otherwise: with no
profiler running it enters no ``record_function`` and records nothing.
``RouteEngine.route_encoded`` (``engine.py``) and
``models/router_engine.route_window`` open these ranges for each window,
on the same clock as the CUDA kernels and copies of the same trace, so a
profiler capture splits the window's host time by stage and names the
stage open at each idle gap of the card:

    route.window    the whole of one ``route_encoded`` call; the seven
                    stage ranges below partition it
    route.upload    the host arrays' uploads to the device
    route.match     kernel 1 (``csrc/shape_match.cu``) and its cover
                    expansion
    route.expand    normal fan-out and shared-slot expansion, once over
                    the W x B lanes
    route.picks     the member picks of the W steps in one pass: one sort
                    and one rank scan over the window, the cursors
                    threaded along the steps by a scan
    route.compact   the CSR compaction (kernel 2's offsets, hole closing,
                    payload scatter)
    route.readback  the cursor hand-off and every copy into host memory,
                    the dense fallback included
    route.wait      inside route.readback, first: the host blocked until
                    the window's device work is done

``route_window`` and ``route_window_cached`` (the node's deduplicated
windows; there ``route.match`` also holds the merge of the cached rows
and their gather to window width) run inside the node's dispatch too, so
their match, expand, picks and compact ranges nest under the node's
``route_step#<trace id>`` range there. The delta overlay of the
``route_window_delta*`` programs and their compactions open no range and
fall to ``route_step#``; a CUDA graph replay runs none of them (the
window is one replay), nor does a window run on another thread than the
one that started the profiler. To see them: ``trace device start`` /
``trace device stop`` on a node (``mgmt/cli.py``), or any
``torch.profiler.profile`` around ``RouteEngine`` calls, read from its
Chrome export (``user_annotation`` events).

The flight recorder (``recorder``), the latency observatory
(``observatory``) and the overload governor (``overload_state_fn``) add
their ``trace``, ``latency`` and ``overload`` sections where the node
builds them; the ``latency`` and ``overload`` sections exist only then,
even at ``full=True``. The ``supervise`` section carries the
supervisor's counters (faults by point, stalls by stage) and, where the
node builds a supervisor (``supervise_state_fn``), its live breaker,
rung and journal state. The ``exchange`` section counts the mesh
server's exchange windows against its gathers by reason, the ring's
rounds and bytes, and the bytes landed on the host; with exchange
traffic it also lists the process's exchange steps
(``parallel/sharded.exchange_step_stats``: segment class and calls).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

from emqx_tpu_torch.broker.metrics import Metrics

SCHEMA = "emqx_tpu.pipeline/v1"

STAGES = ("enqueue", "batch_form", "dispatch", "dispatch_cached",
          "materialize", "deliver", "host_route", "host_match", "total")

# stage histograms: 1µs floor, quarter-octave ladder (112 buckets cover
# 1µs..~2e2s; a plain octave ladder cannot tell 1.1 ms from 2 ms)
_STAGE_LO, _STAGE_BUCKETS, _STAGE_SUBSTEPS = 1e-6, 112, 4
# occupancy histograms: fill fraction 1/256 .. 1.0 in 9 log2 buckets
_OCC_LO, _OCC_BUCKETS = 1.0 / 256, 9

class PipelineTelemetry:
    """Per-node pipeline telemetry registry. Node wires one up as
    `node.pipeline_telemetry`. The hot-path entry points are plain
    histogram observes."""

    def __init__(self, metrics: Optional[Metrics] = None, *,
                 hooks=None, slow_batch_s: Optional[float] = None):
        self.metrics = metrics if metrics is not None else Metrics()
        self.hooks = hooks
        # live gauge providers, set by their owners: the engine's rebuild
        # gauges and graph registry, the delivery lanes' gauges
        self.rebuild_state_fn = None
        self.graphs_fn = None
        self.deliver_state_fn = None
        # the supervisor's live gauges (broker.supervise): the
        # `supervise` section's state
        self.supervise_state_fn = None
        # the HBM ledger (set by the node when broker.hbm_ledger is on):
        # snapshot() derives the `memory` section from it
        self.ledger = None
        # the flight recorder (broker.trace): the `trace` section — ring
        # state and the overlap/bubble analysis
        self.recorder = None
        # the overload governor's live gauges (broker.overload): the
        # `overload` section's state
        self.overload_state_fn = None
        # the latency observatory (broker.latency_observatory): the
        # `latency` section
        self.observatory = None
        # slow-batch watch: a total span beyond this fires the
        # `batch.slow` hook and counts pipeline.slow_batches. None
        # disables.
        self.slow_batch_s = slow_batch_s
        self.started_at = time.time()
        self._compiles_lock = threading.Lock()
        self.compiles = 0            # graph captures
        self.compile_s = 0.0         # their seconds
        self.compiles_by_shape: dict[str, dict] = {}
        for s in STAGES:
            self._stage_hist(s)

    # ---- stage spans -----------------------------------------------------
    def _stage_hist(self, stage: str):
        return self.metrics.hist(f"pipeline.stage.{stage}.seconds",
                                 lo=_STAGE_LO, n_buckets=_STAGE_BUCKETS,
                                 substeps=_STAGE_SUBSTEPS)

    def observe_stage(self, stage: str, seconds: float) -> None:
        self._stage_hist(stage).observe(seconds)

    @contextlib.contextmanager
    def stage(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_stage(stage, time.perf_counter() - t0)

    def record_total(self, seconds: float, **meta) -> None:
        """The end-of-batch span: feeds the `total` histogram and the
        slow-batch watch (threshold -> batch.slow hook + counter)."""
        self.observe_stage("total", seconds)
        if self.slow_batch_s is not None and seconds > self.slow_batch_s:
            self.metrics.inc("pipeline.slow_batches")
            if self.hooks is not None:
                self.hooks.run("batch.slow",
                               (dict(meta, duration_ms=round(
                                   seconds * 1000, 3)),))

    # ---- rebuild stages ---------------------------------------------------
    REBUILD_STAGES = ("capture", "build", "warm", "swap", "delta_apply")

    def observe_rebuild(self, stage: str, seconds: float) -> None:
        self.metrics.hist(f"pipeline.rebuild.{stage}.seconds",
                          lo=_STAGE_LO, n_buckets=_STAGE_BUCKETS,
                          substeps=_STAGE_SUBSTEPS).observe(seconds)

    # ---- occupancy -------------------------------------------------------
    # ---- columnar ingress ------------------------------------------------
    def record_ingress_burst(self, rows: int) -> None:
        """One columnar-decoded PublishBurst of `rows` PUBLISH frames:
        the burst-size histogram (pipeline.ingress.burst). Its companion
        counters (pipeline.ingress.bursts / rows / fallback_frames / bytes
        and pipeline.ingress.lane{i}.accepted) are counted by the
        connection's read loop and the listener."""
        self.metrics.hist("pipeline.ingress.burst", lo=1.0, n_buckets=16,
                          unit="rows").observe(rows)

    def record_occupancy(self, cls: str, fill: float) -> None:
        """Fill fraction of one dispatched batch within its padded class
        (`b{Bp}` for single batches, `w{Wp}` for the fused-window width,
        `host` for host-routed batches vs max_batch)."""
        self.metrics.hist(f"pipeline.occupancy.{cls}",
                          lo=_OCC_LO, n_buckets=_OCC_BUCKETS,
                          unit="ratio").observe(fill)

    # ---- dedup (the device-path reuse layer) -----------------------------
    def record_dedup(self, lanes: int, unique: int) -> None:
        """One dispatch window's unique-topic compaction: `lanes` real
        message lanes collapsed onto `unique` distinct encoded topics."""
        self.metrics.inc("routing.dedup.lanes", lanes)
        self.metrics.inc("routing.dedup.unique", unique)
        if lanes:
            self.metrics.hist("pipeline.dedup.ratio",
                              lo=_OCC_LO, n_buckets=_OCC_BUCKETS,
                              unit="ratio").observe(1.0 - unique / lanes)

    # ---- routing decisions ----------------------------------------------
    def record_decision(self, path: str, n: int = 1) -> None:
        """Formed batches' routing outcome (`device`, `device_cached`,
        `device_compact`, `device_delta` or `host`)."""
        self.metrics.inc(f"pipeline.batches.{path}", n)

    # ---- graph capture accounting ----------------------------------------
    def note_capture(self, label: str, seconds: float) -> None:
        """One window class captured as a CUDA graph (the port's compile
        event), attributed to its class label."""
        with self._compiles_lock:
            row = self.compiles_by_shape.setdefault(
                label, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += seconds
            self.compiles += 1
            self.compile_s += seconds
        self.metrics.inc("pipeline.jit.compiles")
        self.metrics.hist("pipeline.jit.compile.seconds",
                          lo=_STAGE_LO, n_buckets=_STAGE_BUCKETS,
                          substeps=_STAGE_SUBSTEPS).observe(seconds)

    # ---- snapshot (the shared schema) -----------------------------------
    def _vals(self, prefix: str, keys) -> dict:
        out = {}
        for k in keys:
            v = self.metrics.val(f"{prefix}{k}")
            if v:
                out[k] = v
        return out

    def _family(self, prefix: str) -> dict:
        return {k.rsplit(".", 1)[1]: v
                for k, v in self.metrics.all().items()
                if k.startswith(prefix)}

    def overload_section(self) -> dict:
        """The ``overload`` section: the shed/reject counters and the
        governor's live state."""
        overload = self._vals("pipeline.overload.", (
            "sheds", "grade_changes", "qos0_shed", "connects_rejected",
            "accepts_paused", "disconnects", "retained_deferred",
            "stuck_polls", "rebreaches"))
        by_action = self._family("pipeline.overload.actions.")
        if by_action:
            overload["actions_armed_counts"] = by_action
        if self.overload_state_fn is not None:
            overload["state"] = self.overload_state_fn()
        return overload

    def snapshot(self, full: bool = False) -> dict:
        """The one pipeline-telemetry JSON schema. ``full=True`` emits
        every section, empty when its layer has no traffic (``latency``
        and ``overload`` only where their layer exists)."""
        stages = {}
        occupancy = {}
        prefix_s, prefix_o = "pipeline.stage.", "pipeline.occupancy."
        for name, h in self.metrics.histograms().items():
            if name.startswith(prefix_s):
                if not h.count:
                    continue
                snap = h.snapshot()
                stages[name[len(prefix_s):].removesuffix(".seconds")] = {
                    "count": snap["count"],
                    "sum_ms": round(snap["sum"] * 1000, 3),
                    "mean_ms": round(snap["mean"] * 1000, 4),
                    "p50_ms": round(snap["p50"] * 1000, 4),
                    "p95_ms": round(snap["p95"] * 1000, 4),
                    "p99_ms": round(snap["p99"] * 1000, 4),
                }
            elif name.startswith(prefix_o) and h.count:
                snap = h.snapshot()
                occupancy[name[len(prefix_o):]] = {
                    "count": snap["count"],
                    "mean_fill": round(snap["mean"], 4),
                    "p50_fill": round(min(1.0, snap["p50"]), 4),
                }
        with self._compiles_lock:
            by_shape = {k: {"count": v["count"],
                            "total_s": round(v["total_s"], 4)}
                        for k, v in self.compiles_by_shape.items()}
            compiles = {"count": self.compiles,
                        "total_s": round(self.compile_s, 4),
                        "by_shape": by_shape}
        decisions = self._family("pipeline.batches.")
        # fault-domain supervision: fault/trip/replay/stall counters and
        # the supervisor's live breaker/rung/journal state
        supervise = self._vals("supervise.", (
            "faults", "trips", "probes", "probe_failures", "replays",
            "stalls", "restarts", "task_errors", "rung_changes"))
        by_point = self._family("supervise.faults.")
        if by_point:
            supervise["faults_by_point"] = by_point
        by_stall = self._family("supervise.stalls.")
        if by_stall:
            supervise["stalls_by_stage"] = by_stall
        if self.supervise_state_fn is not None:
            supervise["state"] = self.supervise_state_fn()
        for extra in ("routing.device.bypassed", "routing.device.cold_class",
                      "routing.device.cold_cached_class",
                      "routing.device.cold_compact_class",
                      "routing.device.cached_windows",
                      "routing.device.compact_overflow",
                      "routing.device.host_fallback",
                      "routing.device.dispatch_failed",
                      "pipeline.slow_batches"):
            v = self.metrics.val(extra)
            if v:
                decisions[extra] = v
        # device-match reuse layers: cross-batch cache + in-window dedup
        cache = self._vals("match_cache.", (
            "hits", "misses", "inserts", "evictions", "invalidations",
            "invalidated_rows"))
        lookups = cache.get("hits", 0) + cache.get("misses", 0)
        if lookups:
            cache["hit_rate"] = round(cache.get("hits", 0) / lookups, 4)
        dedup = {}
        lanes = self.metrics.val("routing.dedup.lanes")
        if lanes:
            uniq = self.metrics.val("routing.dedup.unique")
            dedup = {"lanes": lanes, "unique": uniq,
                     "ratio": round(1.0 - uniq / lanes, 4)}
        # device→host readback accounting: transferred bytes per path
        readback = {k.replace(".", "_"): v for k, v in self._vals(
            "pipeline.readback.", ("bytes.dense", "bytes.compact",
                                   "windows.dense",
                                   "windows.compact")).items()}
        cw, dw = readback.get("windows_compact"), \
            readback.get("windows_dense")
        if cw:
            readback["bytes_per_window_compact"] = round(
                readback.get("bytes_compact", 0) / cw)
        if dw:
            readback["bytes_per_window_dense"] = round(
                readback.get("bytes_dense", 0) / dw)
        if cw and dw and readback["bytes_per_window_compact"]:
            readback["reduction"] = round(
                readback["bytes_per_window_dense"]
                / readback["bytes_per_window_compact"], 2)
        # the mesh's device-to-device exchange: windows served from the
        # exchanged per-dest plans against the gathers by reason, ring
        # rounds, interconnect and host-landed bytes. Absent without
        # exchange traffic
        exchange = self._vals("pipeline.exchange.", (
            "windows", "rounds", "bytes_exchanged", "host_landed_bytes",
            "overflow", "cold_class", "probe_bytes"))
        fb = self._family("pipeline.exchange.fallback.")
        if fb:
            exchange["fallbacks"] = fb
        if exchange.get("windows"):
            exchange["host_landed_per_window"] = round(
                exchange.get("host_landed_bytes", 0) / exchange["windows"])
        if exchange:
            import sys
            sh = sys.modules.get("emqx_tpu_torch.parallel.sharded")
            if sh is not None:
                exchange["steps"] = sh.exchange_step_stats()
        # rebuild machinery: stage spans, counts, compaction reasons and
        # the engine's live gauges
        rebuild = {}
        rb_stages = {}
        prefix_r = "pipeline.rebuild."
        for name, h in self.metrics.histograms().items():
            if name.startswith(prefix_r) and h.count:
                snap = h.snapshot()
                rb_stages[name[len(prefix_r):]
                          .removesuffix(".seconds")] = {
                    "count": snap["count"],
                    "mean_ms": round(snap["mean"] * 1000, 4),
                    "p95_ms": round(snap["p95"] * 1000, 4),
                }
        if rb_stages:
            rebuild["stages"] = rb_stages
        for k in ("routing.device.rebuilds",
                  "routing.device.compactions",
                  "routing.device.rebuild_failed",
                  "routing.device.delta_applies",
                  "routing.device.host_delta",
                  "routing.device.cold_delta_class",
                  "routing.device.delta_compact_overflow",
                  "match_cache.delta_invalidated"):
            v = self.metrics.val(k)
            if v:
                rebuild[k.rsplit(".", 1)[1]] = v
        reasons = self._family("routing.device.compaction.")
        if reasons:
            rebuild["compaction_reasons"] = reasons
        if self.rebuild_state_fn is not None:
            rebuild["state"] = self.rebuild_state_fn()
        # delivery-lane egress stage: coalesce/backpressure counters and
        # the pool's live gauges. `coalesce_ratio` is the fraction of
        # per-row session drains the coalescing removed
        deliver = self._vals("pipeline.deliver.", (
            "rows", "plans", "deliveries", "drains", "backpressure_waits",
            "deliver_errors", "slow_errors"))
        if deliver.get("deliveries"):
            deliver["coalesce_ratio"] = round(
                1.0 - deliver.get("drains", 0) / deliver["deliveries"], 4)
        if self.deliver_state_fn is not None:
            deliver["state"] = self.deliver_state_fn()
        # columnar ingress: burst, row and fallback counters, the
        # burst-size histogram and the accepts per acceptor lane. Derived
        # from traffic alone: with columnar_ingress off nothing counts,
        # and the section is absent
        ingress = self._vals("pipeline.ingress.", (
            "bursts", "rows", "fallback_frames", "bytes"))
        rows_c = ingress.get("rows", 0)
        fb = ingress.get("fallback_frames", 0)
        if rows_c or fb:
            ingress["columnar_ratio"] = round(rows_c / (rows_c + fb), 4)
        bh = self.metrics.histograms().get("pipeline.ingress.burst")
        if bh is not None and bh.count:
            snap = bh.snapshot()
            ingress["burst_rows"] = {
                "count": snap["count"], "mean": round(snap["mean"], 2),
                "p50": round(snap["p50"], 2), "p95": round(snap["p95"], 2)}
        lanes_acc = {k.split(".")[2]: v
                     for k, v in self.metrics.all().items()
                     if k.startswith("pipeline.ingress.lane") and v}
        if lanes_acc:
            ingress["lanes"] = lanes_acc
        memory = self.ledger.section() if self.ledger is not None else {}
        trace = self.recorder.snapshot_section() \
            if self.recorder is not None else {}
        out = {
            "schema": SCHEMA,
            "stages": stages,
            "occupancy": occupancy,
            "compiles": compiles,
            "decisions": decisions,
        }
        for name, sec in (("supervise", supervise), ("rebuild", rebuild),
                          ("deliver", deliver),
                          ("match_cache", cache), ("dedup", dedup),
                          ("readback", readback), ("exchange", exchange),
                          ("trace", trace),
                          ("ingress", ingress), ("memory", memory)):
            if sec or full:
                out[name] = sec
        if self.overload_state_fn is not None:
            out["overload"] = self.overload_section()
        if self.observatory is not None:
            latency = self.observatory.section()
            if latency or full:
                out["latency"] = latency
        if self.graphs_fn is not None:
            reg = self.graphs_fn()
            out["jit_cache"] = {"graph_classes": reg["graph_classes"]}
            if reg["rows"] or full:
                out["program_costs"] = {"route_window": reg["rows"]}
        return out
