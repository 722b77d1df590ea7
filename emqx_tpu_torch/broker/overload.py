"""Adaptive overload protection: the graded load-shed ladder.

The port's copy of ``emqx_tpu/broker/overload.py``. The supervisor
handles *faults* (a stage dying); this module handles *overload* —
every stage healthy, demand > capacity — closing the loop on pressure
signals the node already measures: the batcher's submit-queue and
pipeline-queue fill, the delivery lanes' plan fill and backpressure
waits, the latency observatory's SLO burn, the HBM ledger's live bytes
against the card's memory, and an event-loop-lag probe (housekeeping
cadence drift).

**The grade ladder** — polled on the node housekeeping tick
(``Node.sweep``)::

    normal → elevated → overload → critical

with hysteresis on BOTH edges (``up_sustain`` consecutive above-grade
polls to climb one grade, ``down_sustain`` consecutive healthy polls to
step down one). Each grade arms an ORDERED set of shedding actions,
cheapest first; recovery unwinds them in reverse::

    grade      armed actions (cumulative, in arm order)
    elevated   clamp_sampling      trace per-message sampling 1-in-N
                                   × CLAMP_FACTOR; latency observatory
                                   records 1-in-CLAMP_FACTOR (burn is a
                                   breach FRACTION, so uniform sampling
                                   keeps the burn signal unbiased)
    overload   shrink_dispatch     batcher dispatch_depth → 1 (the
                                   batcher reads it live: the next
                                   window admits at depth 1)
               defer_retained      retained replays to new subscribers
                                   parked (apps/retainer.py), replayed
                                   on the first sweep after recovery
               pause_connects      extra acceptor lanes stop accepting;
                                   new CONNECTs answered with the v5
                                   reason 0x97 (quota exceeded)
    critical   shed_qos0           QoS0 PUBLISHes dropped at batcher
                                   admit — QoS1/2 are NEVER shed
               disconnect_offenders  force_shutdown parity: each poll
                                   disconnects the top-offender
                                   connection(s) by limiter debt
                                   (ingress-volume fallback when no
                                   rate limit is configured)

Every arm/unwind is counted (``pipeline.overload.*``), fires the
``overload.shed`` hook, raises/updates the ``overload`` alarm
(``broker/alarm.py``), and lands an ``overload_shed`` instant event on
the flight recorder (on the most recent window's trace).

The supervisor's fault-injection points ``signal_spike`` and
``stuck_grade`` are traversed on every poll (``_fire``), and its window
journal's depth is the ``journal_depth`` signal.

Knob (config only): ``broker.overload`` (on). Off builds no governor
anywhere: no ``overload`` telemetry section, and delivery counts and
order are unchanged.
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Optional

import torch

log = logging.getLogger("emqx_tpu_torch.overload")

# the grade ladder
GRADE_NORMAL = 0
GRADE_ELEVATED = 1
GRADE_OVERLOAD = 2
GRADE_CRITICAL = 3
GRADES = ("normal", "elevated", "overload", "critical")

# the ordered shed actions (cheapest first — the arm order; unwind runs
# in reverse) and the cumulative set each grade arms
ACTIONS = ("clamp_sampling", "shrink_dispatch", "defer_retained",
           "pause_connects", "shed_qos0", "disconnect_offenders")
GRADE_ACTIONS = {
    GRADE_NORMAL: ACTIONS[:0],
    GRADE_ELEVATED: ACTIONS[:1],
    GRADE_OVERLOAD: ACTIONS[:4],
    GRADE_CRITICAL: ACTIONS[:6],
}

# trace / latency sampling clamp under elevated+ (documented shed:
# per-message observability thins out 16x, window spans stay exact)
CLAMP_FACTOR = 16

# signal → grade-vote thresholds: each signal votes the HIGHEST tier
# whose threshold it meets; the raw grade is the max vote. Tuples are
# (elevated, overload, critical); None = the signal never votes that
# tier. The reference's thresholds, unchanged.
THRESHOLDS = {
    # batcher submit-queue fill (len(_queue) / max_pending): the
    # primary demand>capacity signal — backpressure engages at 1.0
    "queue_fill": (0.50, 0.75, 0.90),
    # batcher pipeline-queue fill (_inflight.qsize / pipeline_depth)
    "inflight_fill": (1.0, None, None),
    # supervisor window-journal depth (admitted, unsettled windows)
    "journal_depth": (16, 64, 256),
    # delivery-lane plan fill (live_plans / depth_limit)
    "lane_fill": (1.0, None, None),
    # lane backpressure waits SINCE THE LAST POLL
    "backpressure_delta": (1, 50, None),
    # SLO error-budget burn: the classic multi-window pairs —
    # 1m alone warns; 1m AND 5m page-level (>=14) is overload; a 1m
    # burn of >=50 with the 5m window confirming is critical
    "burn_1m": (1.0, None, None),
    "burn_page": (None, 14.0, 50.0),     # min(burn_1m, burn_5m)
    # HBM pressure: ledger live_bytes / the card's total memory
    "hbm_fill": (0.80, 0.90, 0.95),
    # event-loop lag: housekeeping cadence drift beyond the interval
    "loop_lag_s": (0.05, 0.25, 1.0),
}

# offender scores decay by half each poll so a connection that went
# quiet stops being a shed candidate within a few ticks
_SCORE_DECAY = 0.5


def device_total_memory(device) -> Optional[int]:
    """The card's memory in bytes, the ``hbm_fill`` denominator (the
    reference divides by the device's ``bytes_limit``, which the torch
    allocator does not report): ``total_memory`` of a ``cuda`` device,
    None on the CPU — where, as in the reference on the CPU, there is no
    ``hbm_fill`` signal."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def resolve_overload(configured=None) -> bool:
    """``broker.overload``, default on. Off builds no governor anywhere:
    no ``overload`` telemetry section, and delivery counts and
    per-publisher order are unchanged."""
    return True if configured is None else bool(configured)


class OverloadGovernor:
    """Per-node overload state machine + the shed-action ladder.

    Hot-path contract: the serving paths read only plain bool
    attributes (``shed_qos0``, ``connects_paused``,
    ``retained_deferred``) — one attribute read per check, no locks, no
    calls. All state transitions happen in ``poll()`` on the
    housekeeping tick (event loop), so there is no cross-thread
    read-modify-write anywhere in this class."""

    def __init__(self, node, metrics, *, hooks=None, recorder=None,
                 up_sustain: int = 2, down_sustain: int = 5,
                 clamp_factor: int = CLAMP_FACTOR,
                 disconnects_per_poll: int = 1,
                 thresholds: Optional[dict] = None):
        self.node = node
        self.metrics = metrics
        self.hooks = hooks
        self.recorder = recorder
        self.up_sustain = max(1, int(up_sustain))
        self.down_sustain = max(1, int(down_sustain))
        self.clamp_factor = max(2, int(clamp_factor))
        self.disconnects_per_poll = max(1, int(disconnects_per_poll))
        self.thresholds = dict(THRESHOLDS)
        if thresholds:
            self.thresholds.update(thresholds)
        self.grade = GRADE_NORMAL
        self.grade_changes = 0
        self.grade_since = time.monotonic()
        # hot-path shed flags (plain attribute reads on serving paths)
        self.shed_qos0 = False
        self.connects_paused = False
        self.retained_deferred = False
        self._armed: list[str] = []      # in arm order
        self._saved: dict = {}           # action -> pre-shed state
        self._above = 0                  # consecutive raw>grade polls
        self._below = 0                  # consecutive raw<grade polls
        # re-breach backoff: a climb right after a step-down means the
        # easing itself re-admitted the overload (the raw signals read
        # healthy exactly BECAUSE the shed was working) — each such
        # re-breach doubles the sustained-healthy multiplier the next
        # step-down requires, up to 64x; a full recovery to normal
        # resets it. The oscillation damper of the ladder.
        self._down_mult = 1
        self._polls = 0
        self._last_down_poll: Optional[int] = None
        self.last_signals: dict = {}
        self.loop_lag_s = 0.0
        self.poll_interval_s: Optional[float] = None
        self._last_poll: Optional[float] = None
        self._last_backpressure = 0
        self._last_obs_samples = 0
        self._hbm_limit: Optional[int] = None
        self._hbm_limit_probed = False
        self.stuck_polls = 0
        self._stuck_alarmed = False
        # live-connection registry for the top-offender shed: weak so
        # the governor can never keep a dead connection's buffers alive
        self._conns: "weakref.WeakSet" = weakref.WeakSet()

    # ---- connection registry (force_shutdown parity) --------------------
    def register_conn(self, conn) -> None:
        self._conns.add(conn)

    # ---- fault injection (the supervisor grammar's overload points) ------
    def _fire(self, point: str) -> bool:
        """Traverse an overload injection point (``signal_spike``,
        ``stuck_grade``) through the supervisor's injector. ANY fired
        clause is the condition (the recommended kind is ``corrupt`` — it
        fires without raising; exception/resource clauses are caught and
        count the same; a hang clause blocks the tick like a real loop
        stall would, then counts)."""
        sup = getattr(self.node, "supervisor", None)
        if sup is None or not sup.injector.armed():
            return False
        try:
            return sup.fire(point, corrupt_ok=True) is not None
        except Exception:  # noqa: BLE001 — raising kinds: same signal
            return True

    # ---- signal sampling -------------------------------------------------
    def sample_signals(self) -> dict:
        """One poll's raw signal readings — every input already exists
        in the pipeline; this only reads, never computes. Tests
        monkeypatch this to drive the ladder deterministically."""
        node = self.node
        s: dict = {}
        b = getattr(node, "publish_batcher", None)
        if b is not None:
            s["queue_fill"] = round(
                len(b._queue) / max(1, b.max_pending), 4)
            q = b._inflight
            if q is not None:
                s["inflight_fill"] = round(
                    q.qsize() / max(1, b.pipeline_depth), 4)
        sup = getattr(node, "supervisor", None)
        if sup is not None:
            s["journal_depth"] = sup.journal_depth()
        pool = getattr(node, "deliver_lanes", None)
        if pool is not None:
            st = pool.state()
            s["lane_fill"] = round(
                st["live_plans"] / max(1, st["depth_limit"]), 4)
            waits = self.metrics.val("pipeline.deliver.backpressure_waits")
            s["backpressure_delta"] = waits - self._last_backpressure
            self._last_backpressure = waits
        obs = getattr(node, "latency_observatory", None)
        if obs is not None:
            ns = obs.samples
            if ns > self._last_obs_samples:
                # burn contributes only while traffic is LIVE: the
                # windows look back 1m/5m, so a flood that already
                # drained would otherwise hold the ladder up for a
                # full window with the broker idle — burn measures the
                # current spend rate, and an idle broker spends nothing
                burn = obs.burn_rates()
                s["burn_1m"] = burn.get("1m", 0.0)
                s["burn_page"] = min(burn.get("1m", 0.0),
                                     burn.get("5m", 0.0))
            self._last_obs_samples = ns
        led = getattr(node, "hbm_ledger", None)
        if led is not None:
            if not self._hbm_limit_probed:
                self._hbm_limit_probed = True
                self._hbm_limit = device_total_memory(led.device)
            if self._hbm_limit:
                s["hbm_fill"] = round(
                    led.live_bytes() / self._hbm_limit, 4)
        s["loop_lag_s"] = round(self.loop_lag_s, 4)
        return s

    def _grade_of(self, signals: dict) -> int:
        raw = GRADE_NORMAL
        for name, val in signals.items():
            t = self.thresholds.get(name)
            if t is None or val is None:
                continue
            for tier in (GRADE_CRITICAL, GRADE_OVERLOAD, GRADE_ELEVATED):
                bound = t[tier - 1]
                if bound is not None and val >= bound:
                    raw = max(raw, tier)
                    break
        return raw

    # ---- the poll (housekeeping tick) ------------------------------------
    def poll(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        # event-loop-lag probe: cadence drift of this very tick. The
        # housekeeping sleep targets poll_interval_s; anything beyond
        # it is time the loop spent wedged in callbacks.
        if self._last_poll is not None and self.poll_interval_s:
            self.loop_lag_s = max(
                0.0, (now - self._last_poll) - self.poll_interval_s)
        self._last_poll = now
        spike = self._fire("signal_spike")
        stuck = self._fire("stuck_grade")
        signals = self.sample_signals()
        raw = GRADE_CRITICAL if spike else self._grade_of(signals)
        self.last_signals = dict(signals, raw=raw)
        if spike:
            self.last_signals["signal_spike"] = True
        self._polls += 1
        if raw > self.grade:
            self._below = 0
            self._above += 1
            if self._above >= self.up_sustain:
                self._above = 0
                rebreach = self._last_down_poll is not None \
                    and self._polls - self._last_down_poll \
                    <= self.up_sustain + 2
                # backoff bookkeeping only when the climb actually
                # happens — a stuck_grade-blocked transition must not
                # double the multiplier for an easing that never was
                if self._transition(self.grade + 1, stuck) and rebreach:
                    # re-breach right after easing: back the next
                    # step-down off (doubling, capped) — see
                    # _down_mult above
                    self._down_mult = min(self._down_mult * 2, 64)
                    self.metrics.inc("pipeline.overload.rebreaches")
        elif raw < self.grade:
            self._above = 0
            self._below += 1
            if self._below >= self.down_sustain * self._down_mult:
                self._below = 0
                if self._transition(self.grade - 1, stuck):
                    self._last_down_poll = self._polls
                    if self.grade == GRADE_NORMAL:
                        self._down_mult = 1
                        self._last_down_poll = None
        else:
            self._above = self._below = 0
            if self._stuck_alarmed and not stuck:
                self._clear_stuck()
        if self.grade >= GRADE_CRITICAL \
                and "disconnect_offenders" in self._armed:
            self._shed_offenders()
        self._decay_scores()

    def _transition(self, new_grade: int, stuck: bool) -> bool:
        """Apply a due grade change; returns True when the grade
        actually moved (False = blocked by a stuck_grade clause) so
        the caller's backoff bookkeeping tracks only real easings."""
        if stuck:
            # the stuck_grade injection (or a future real wedge hook):
            # a transition was DUE but blocked — count it, and after
            # the ladder stays frozen for a sustained interval raise
            # the overload_stuck alarm (the chaos cell's oracle)
            self.stuck_polls += 1
            self.metrics.inc("pipeline.overload.stuck_polls")
            if self.stuck_polls >= 3 and not self._stuck_alarmed:
                self._stuck_alarmed = True
                alarms = getattr(self.node, "alarms", None)
                if alarms is not None:
                    alarms.activate(
                        "overload_stuck",
                        {"grade": GRADES[self.grade],
                         "stuck_polls": self.stuck_polls},
                        "overload governor grade transitions blocked")
            return False
        old = self.grade
        self.grade = new_grade
        self.grade_since = time.monotonic()
        self.grade_changes += 1
        self.metrics.inc("pipeline.overload.grade_changes")
        self._apply_actions()
        self._update_alarm()
        if self.recorder is not None:
            self.recorder.event(
                self._trace(), "overload_grade", track="overload",
                meta={"from": GRADES[old], "to": GRADES[new_grade],
                      "signals": dict(self.last_signals)})
        lvl = logging.WARNING if new_grade > old else logging.INFO
        log.log(lvl, "overload grade %s -> %s (signals %s; armed %s)",
                GRADES[old], GRADES[new_grade], self.last_signals,
                self._armed)
        return True

    def _clear_stuck(self) -> None:
        self.stuck_polls = 0
        self._stuck_alarmed = False
        alarms = getattr(self.node, "alarms", None)
        if alarms is not None:
            alarms.deactivate("overload_stuck")

    def _trace(self) -> int:
        """The most recent window's trace id (minted at batcher admit)
        — shed events land on the window timeline they interleave
        with; 0 (node scope) when no window is in flight."""
        b = getattr(self.node, "publish_batcher", None)
        return getattr(b, "last_trace", 0) if b is not None else 0

    # ---- the action ladder ----------------------------------------------
    def _apply_actions(self) -> None:
        want = GRADE_ACTIONS[self.grade]
        for a in ACTIONS:                    # arm cheapest-first
            if a in want and a not in self._armed:
                self._arm(a)
        for a in reversed(ACTIONS):          # unwind in reverse order
            if a in self._armed and a not in want:
                self._unarm(a)

    def _arm(self, action: str) -> None:
        node = self.node
        if action == "clamp_sampling":
            rec = getattr(node, "flight_recorder", None)
            if rec is not None and rec.sample > 0:
                self._saved["trace_sample"] = rec.sample
                rec.sample = rec.sample * self.clamp_factor
            obs = getattr(node, "latency_observatory", None)
            if obs is not None:
                self._saved["latency_clamp"] = obs.clamp
                obs.clamp = self.clamp_factor
        elif action == "shrink_dispatch":
            b = getattr(node, "publish_batcher", None)
            if b is not None:
                self._saved["dispatch_depth"] = b.dispatch_depth
                b.dispatch_depth = 1
        elif action == "defer_retained":
            self.retained_deferred = True
        elif action == "pause_connects":
            self.connects_paused = True
        elif action == "shed_qos0":
            self.shed_qos0 = True
        # disconnect_offenders: armed flag only — the disconnects
        # themselves run once per poll while critical (rate-bounded)
        self._armed.append(action)
        self._note_shed(action, armed=True)

    def _unarm(self, action: str) -> None:
        node = self.node
        if action == "clamp_sampling":
            rec = getattr(node, "flight_recorder", None)
            saved = self._saved.pop("trace_sample", None)
            if rec is not None and saved is not None:
                rec.sample = saved
            obs = getattr(node, "latency_observatory", None)
            saved = self._saved.pop("latency_clamp", None)
            if obs is not None and saved is not None:
                obs.clamp = saved
        elif action == "shrink_dispatch":
            b = getattr(node, "publish_batcher", None)
            saved = self._saved.pop("dispatch_depth", None)
            if b is not None and saved is not None:
                b.dispatch_depth = saved
        elif action == "defer_retained":
            self.retained_deferred = False
        elif action == "pause_connects":
            self.connects_paused = False
        elif action == "shed_qos0":
            self.shed_qos0 = False
        self._armed.remove(action)
        self._note_shed(action, armed=False)

    def _note_shed(self, action: str, armed: bool) -> None:
        m = self.metrics
        if armed:
            m.inc("pipeline.overload.sheds")
            m.inc(f"pipeline.overload.actions.{action}")
        info = {"action": action, "armed": armed,
                "grade": GRADES[self.grade]}
        if self.hooks is not None:
            self.hooks.run("overload.shed", (info,))
        if self.recorder is not None:
            self.recorder.event(self._trace(), "overload_shed",
                                track="overload", meta=info)

    def _update_alarm(self) -> None:
        """The ``overload`` $SYS alarm rides alarm.py: active above
        normal (details refreshed per grade change — deactivate +
        activate, so the history records every grade the flood
        visited), cleared on recovery."""
        alarms = getattr(self.node, "alarms", None)
        if alarms is None:
            return
        alarms.deactivate("overload")
        if self.grade > GRADE_NORMAL:
            alarms.activate(
                "overload",
                {"grade": GRADES[self.grade],
                 "actions": list(self._armed),
                 "signals": dict(self.last_signals)},
                f"broker overloaded: grade {GRADES[self.grade]}")

    # ---- hot-path accounting (called by the shedding sites) -------------
    def count_qos0_shed(self, n: int = 1) -> None:
        self.metrics.inc("pipeline.overload.qos0_shed", n)

    def count_connect_rejected(self) -> None:
        self.metrics.inc("pipeline.overload.connects_rejected")

    def count_accept_paused(self) -> None:
        self.metrics.inc("pipeline.overload.accepts_paused")

    def count_retained_deferred(self, n: int = 1) -> None:
        self.metrics.inc("pipeline.overload.retained_deferred", n)

    # ---- top-offender disconnect (force_shutdown parity) ----------------
    def _shed_offenders(self) -> None:
        scored = []
        for conn in list(self._conns):
            score = conn.shed_score()
            if score > 0:
                scored.append((score, id(conn), conn))
        if not scored:
            return
        scored.sort(reverse=True)
        for score, _cid, conn in scored[:self.disconnects_per_poll]:
            self.metrics.inc("pipeline.overload.disconnects")
            info = {"action": "disconnect_offender", "armed": True,
                    "grade": GRADES[self.grade],
                    "clientid": conn.channel.clientid,
                    "debt": round(score, 3)}
            if self.hooks is not None:
                self.hooks.run("overload.shed", (info,))
            log.warning("overload: disconnecting top offender %r "
                        "(debt %.3f)", conn.channel.clientid, score)
            conn.overload_disconnect()
            self._conns.discard(conn)

    def _decay_scores(self) -> None:
        for conn in list(self._conns):
            conn.shed_rows *= _SCORE_DECAY

    # ---- telemetry -------------------------------------------------------
    def state(self) -> dict:
        """Live gauges for the ``overload`` telemetry section (the
        counters ride the shared Metrics registry)."""
        return {
            "grade": GRADES[self.grade],
            "grade_num": self.grade,
            "since_s": round(time.monotonic() - self.grade_since, 1),
            "actions": list(self._armed),
            "signals": dict(self.last_signals),
            "hysteresis": {"above": self._above, "below": self._below,
                           "up_sustain": self.up_sustain,
                           "down_sustain": self.down_sustain,
                           "down_mult": self._down_mult},
            "loop_lag_ms": round(self.loop_lag_s * 1000, 2),
            "conns_tracked": len(self._conns),
            "stuck_polls": self.stuck_polls,
        }
