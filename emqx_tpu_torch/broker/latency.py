"""End-to-end message latency SLO observatory.

The port's copy of ``emqx_tpu/broker/latency.py``: the latency a
*message* experiences from socket read to delivery write, decomposed by
path — the number the **p99 < 2ms PUBLISH→route** criterion is judged
against. It measures per message and starts the clock at frame decode.

Mechanics:

- **Ingress stamp**: ``mqtt.frame.FrameParser`` stamps
  ``perf_counter_ns`` at frame decode — one clock read per read burst
  (the columnar path stores it on the ``PublishBurst``, so every row of
  a burst carries the burst's one stamp; the per-packet path on each
  ``Publish``) — and the channel carries it onto ``Message.ingress_ns``.
- **Two legs**: ``ingress→routed`` (frame decode → route result in
  hand; the SLO objective's leg) and ``ingress→delivered`` (frame decode
  → every delivery written, i.e. the window's delivery plan settled).
  Both are recorded per message at batch settle, keyed by
  ``(qos, path)`` where path ∈ {device, device_cached, host,
  host_fallback, replay} (``replay``: a supervised journal replay).
- **Fine histograms**: the quarter-octave log2 ladder from 1µs
  (``metrics.Histogram(substeps=4)``), so a 2ms objective resolves to
  ~19% instead of a factor of 2.
- **SLO engine**: a configurable objective, rolling error-budget burn
  rates (1m/5m/30m; burn 1.0 = spending the 1% p99 budget exactly at
  the sustainable rate), and **breach exemplars**: a message over the
  objective records a bounded exemplar carrying its window's flight-
  recorder trace id, lands a ``slo_breach`` instant event on that
  trace, and fires a throttled ``latency.breach`` hook.

Knobs (config only; the reference's environment knobs are not ported):
``broker.latency_observatory`` (on) and ``broker.slo_route_p99_ms``
(2.0).

Exported as the ``latency`` section of `PipelineTelemetry.snapshot()`
and the ``pipeline.latency.*`` histogram families of the node's Metrics.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

SCHEMA = "emqx_tpu.latency/v1"

# the per-message path attribution (batcher settle decides):
#   device         routed by a fused device window (plain/compact/delta)
#   device_cached  device window with the dedup/match-cache plan attached
#   host           host-routed by decision (probe, bypass, min-batch,
#                  trickle, or a node with no batcher at all)
#   host_fallback  a prepared device window that fell back to the host
#                  path WITHOUT a supervision replay (prepare_window
#                  declined mid-rebuild, fused follower of a dead lead,
#                  unsupervised dispatch failure)
#   replay         a journaled window re-routed through the host rung by
#                  the supervisor (breaker trip, watchdog stall, injected
#                  fault)
PATHS = ("device", "device_cached", "host", "host_fallback", "replay")
LEGS = ("routed", "delivered")

# latency histograms: 1µs floor, quarter-octave (substeps=4) ladder,
# 112 buckets -> ~1µs..220s. The plain 28-bucket octave ladder cannot
# resolve a 2ms objective (neighbouring bounds 1.024/2.048ms).
_LAT_LO, _LAT_BUCKETS, _LAT_SUBSTEPS = 1e-6, 112, 4

# SLO burn accounting: breach/total counts in 10s slots, ring bounded
# to the widest burn window (30m)
_SLOT_S = 10.0
_BURN_WINDOWS = (("1m", 6), ("5m", 30), ("30m", 180))
# the error budget at a p99 objective: 1% of messages may exceed it
_P99_BUDGET = 0.01

_EXEMPLAR_CAP = 16
_HOOK_MIN_INTERVAL_S = 1.0


def resolve_latency_observatory(configured=None) -> bool:
    """``broker.latency_observatory``, default on. Off builds no
    observatory anywhere: no ``latency`` snapshot section, and delivery
    counts and per-publisher order are unchanged. The frame-decode
    ingress stamp itself is not gated: messages always carry
    ``ingress_ns`` (one clock read per read burst), so the stamp path
    cannot drift untested between the two; the knob gates what reads
    the stamp."""
    return True if configured is None else bool(configured)


def resolve_slo_route_p99_ms(configured=None) -> float:
    """``broker.slo_route_p99_ms``, default 2.0 (the **p99 < 2ms
    PUBLISH→route** criterion). Must be a positive number; anything else
    is a deployment error worth failing loudly on."""
    if configured is None:
        return 2.0
    try:
        val = float(configured)
    except (TypeError, ValueError):
        raise ValueError(
            f"slo_route_p99_ms={configured!r} is not a number")
    if val <= 0:
        raise ValueError(f"slo_route_p99_ms must be > 0, got {val}")
    return val


class LatencyObservatory:
    """Per-node end-to-end latency recorder + SLO engine.

    Hot-path contract: ``record_routed`` / ``record_delivered`` run on
    the event loop only (batcher settle, host publish path) — one
    histogram observe plus, on the routed leg, one slot-counter bump;
    no locks, no allocation beyond the first observation of a new
    ``(leg, qos, path)`` series. Everything else (burn rates, the
    section document) is read-side."""

    def __init__(self, metrics, *, hooks=None, recorder=None,
                 objective_ms: Optional[float] = None):
        self.metrics = metrics
        self.hooks = hooks
        # the flight recorder: breach exemplars land a
        # `slo_breach` instant event on the slow message's window trace
        # so the causal chain is one trace-id lookup away. None (trace
        # knob off) degrades to exemplars without trace linkage.
        self.recorder = recorder
        self.objective_ms = resolve_slo_route_p99_ms(objective_ms)
        self._objective_s = self.objective_ms / 1000.0
        self._hist: dict = {}      # (leg, qos, path) -> Histogram
        self._slots: deque = deque(maxlen=_BURN_WINDOWS[-1][1])
        self.samples = 0           # routed-leg observations
        self.breaches = 0
        self.exemplars: deque = deque(maxlen=_EXEMPLAR_CAP)
        self.hook_fires = 0
        self.hook_throttled = 0
        self._last_hook = 0.0
        # overload sampling clamp: >1 records 1-in-clamp
        # messages. Set/restored ONLY by the overload governor's
        # clamp_sampling shed action; burn rates stay unbiased under
        # the clamp because they are breach FRACTIONS (uniform
        # sampling preserves a ratio).
        self.clamp = 1
        self._clamp_tick = 0
        self._clamp_tick_d = 0
        self.clamped = 0

    # ---- recording (event loop) -----------------------------------------
    def _h(self, leg: str, qos: int, path: str):
        key = (leg, qos, path)
        h = self._hist.get(key)
        if h is None:
            # written as two explicit literals (not one f-string over
            # `leg`) so the doc-drift gate can resolve the documented
            # family templates against the source
            name = f"pipeline.latency.routed.q{qos}.{path}" \
                if leg == "routed" else \
                f"pipeline.latency.delivered.q{qos}.{path}"
            h = self.metrics.hist(name, lo=_LAT_LO,
                                  n_buckets=_LAT_BUCKETS,
                                  substeps=_LAT_SUBSTEPS)
            self._hist[key] = h
        return h

    def record_routed(self, msg, path: str, seconds: float,
                      trace: int = 0) -> None:
        """One message's ingress→routed latency (the SLO leg)."""
        if self.clamp > 1:
            self._clamp_tick += 1
            if self._clamp_tick % self.clamp:
                self.clamped += 1
                return
        self._h("routed", min(msg.qos, 2), path).observe(seconds)
        self.samples += 1
        sid = int(time.monotonic() / _SLOT_S)
        slots = self._slots
        if not slots or slots[-1][0] != sid:
            slots.append([sid, 0, 0])
        cur = slots[-1]
        cur[1] += 1
        if seconds > self._objective_s:
            cur[2] += 1
            self.breaches += 1
            self.metrics.inc("pipeline.latency.breaches")
            self._exemplar(msg, path, seconds, trace)

    def record_delivered(self, msg, path: str, seconds: float) -> None:
        """One message's ingress→delivered latency (route + the
        delivery-lane walk / inline delivery, settled)."""
        if self.clamp > 1:
            # the delivered leg keeps its OWN 1-in-N phase: deliveries
            # settle asynchronously (lane done-callbacks), so reusing
            # the routed tick would sample in window-sized clumps
            # decided by whichever routed call last moved it
            self._clamp_tick_d += 1
            if self._clamp_tick_d % self.clamp:
                return
        self._h("delivered", min(msg.qos, 2), path).observe(seconds)

    def _exemplar(self, msg, path: str, seconds: float,
                  trace: int) -> None:
        """Breach exemplar: the exact slow message, linked to its
        window's flight-recorder trace, with the hook throttled so a
        degraded pipeline (where EVERY message breaches) logs one
        causal chain per second instead of one per message."""
        ex = {"topic": msg.topic, "qos": msg.qos, "path": path,
              "latency_ms": round(seconds * 1000, 3),
              "trace_id": trace, "ts": round(time.time(), 3)}
        self.exemplars.append(ex)
        rec = self.recorder
        if rec is not None and trace:
            rec.event(trace, "slo_breach", track="latency",
                      meta={"latency_ms": ex["latency_ms"],
                            "path": path})
        hooks = self.hooks
        if hooks is not None:
            now = time.monotonic()
            if now - self._last_hook >= _HOOK_MIN_INTERVAL_S:
                self._last_hook = now
                self.hook_fires += 1
                hooks.run("latency.breach", (ex,))
            else:
                self.hook_throttled += 1

    def reset(self) -> None:
        """Zero every recorded distribution, slot and exemplar (the
        registry histogram objects are kept and zeroed in place, so
        exporters and cached references stay valid). Bench tooling
        only: an overload drive resets at the ramp→steady-state
        boundary so the graded p99 measures the governed steady state,
        not the untimed ramp."""
        for h in self._hist.values():
            h.counts = [0] * len(h.counts)
            h.count = 0
            h.sum = 0.0
        self._slots.clear()
        self.samples = 0
        self.breaches = 0
        self.exemplars.clear()
        # clamp/hook bookkeeping resets with the distributions: the
        # post-reset section's clamp.skipped must describe the
        # post-reset distribution, not the discarded ramp
        self._clamp_tick = 0
        self._clamp_tick_d = 0
        self.clamped = 0
        self.hook_fires = 0
        self.hook_throttled = 0

    # ---- read side -------------------------------------------------------
    def burn_rates(self) -> dict:
        """Rolling error-budget burn per window: (breach fraction) /
        (allowed fraction). 1.0 = breaching exactly 1% of messages —
        the budget a p99 objective grants; >1 over-burning (alert
        thresholds: the classic multi-window pairs, e.g. 1m>14 AND
        5m>14 for a page, 30m>1 for a ticket)."""
        slots = list(self._slots)
        now_sid = int(time.monotonic() / _SLOT_S)
        out = {}
        for label, n in _BURN_WINDOWS:
            tot = br = 0
            for sid, t, b in slots:
                if sid > now_sid - n:
                    tot += t
                    br += b
            out[label] = round((br / tot) / _P99_BUDGET, 3) if tot \
                else 0.0
        return out

    def _merged_percentile(self, leg: str, p: float):
        """Percentile across every (qos, path) series of one leg: the
        histograms share one bucket ladder, so summed counts walk the
        same bounds (the aggregate p99 the SLO verdict grades)."""
        hs = [h for (lg, _q, _pa), h in self._hist.items()
              if lg == leg and h.count]
        if not hs:
            return None
        bounds = hs[0].bounds
        counts = [0] * (len(bounds) + 1)
        total = 0
        for h in hs:
            total += h.count
            for i, c in enumerate(h.counts):
                counts[i] += c
        want = p * total
        acc = 0
        for b, c in zip(bounds, counts):
            acc += c
            if acc >= want:
                return b
        return 2 * bounds[-1]

    def section(self) -> dict:
        """The ``latency`` snapshot section (telemetry.snapshot())."""
        routed: dict = {}
        delivered: dict = {}
        for (leg, qos, path), h in sorted(self._hist.items()):
            if not h.count:
                continue
            row = {
                "count": h.count,
                "p50_ms": round(h.percentile(0.50) * 1000, 4),
                "p99_ms": round(h.percentile(0.99) * 1000, 4),
                "p999_ms": round(h.percentile(0.999) * 1000, 4),
            }
            (routed if leg == "routed" else
             delivered)[f"q{qos}.{path}"] = row
        p99 = self._merged_percentile("routed", 0.99)
        slo = {
            "objective_p99_ms": self.objective_ms,
            "samples": self.samples,
            "breaches": self.breaches,
            "burn": self.burn_rates(),
        }
        if p99 is None:
            slo["verdict"] = "no_data"
        else:
            slo["routed_p99_ms"] = round(p99 * 1000, 4)
            slo["verdict"] = "met" if p99 * 1000 <= self.objective_ms \
                else "breached"
        dp99 = self._merged_percentile("delivered", 0.99)
        if dp99 is not None:
            slo["delivered_p99_ms"] = round(dp99 * 1000, 4)
        out = {
            "schema": SCHEMA,
            "objective_p99_ms": self.objective_ms,
            "routed": routed,
            "delivered": delivered,
            "slo": slo,
        }
        if self.clamp > 1 or self.clamped:
            out["clamp"] = {"factor": self.clamp,
                            "skipped": self.clamped}
        if self.exemplars:
            out["exemplars"] = list(self.exemplars)
        if self.hook_fires or self.hook_throttled:
            out["breach_hook"] = {"fired": self.hook_fires,
                                  "throttled": self.hook_throttled}
        return out
