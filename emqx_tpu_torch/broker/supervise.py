"""Fault-domain supervision for the device route pipeline.

The port's copy of ``emqx_tpu/broker/supervise.py``. Every pipeline stage
(batcher → dispatch → materialize → delta-overlay rebuild → delivery
lanes) plugs into this supervision tree:

- **Deterministic fault injection** (`FaultInjector`): named injection
  points at every stage boundary — ``dispatch``, ``materialize``,
  ``cache_insert``, ``overlay_apply``, ``lane_deliver``,
  ``snapshot_swap``, ``mesh_exchange`` — and the overload governor's
  ``signal_spike`` and ``stuck_grade``. A drive arms clauses by swapping
  the supervisor's injector: ``node.supervisor.injector =
  FaultInjector(parse_faults(spec))``. Spec grammar, comma-separated
  clauses::

      point:kind[:after=N][:count=M][:hang_s=S]

  ``kind`` ∈ {``exception``, ``resource`` (an OOM-like failure),
  ``hang`` (sleeps ``hang_s``, default 30 — at the watchdogged stages
  (dispatch/materialize/mesh_exchange) the consumer's deadline trips
  first; at the loop-side points a bounded hang blocks the loop for
  ``hang_s``), ``corrupt`` (shape-corrupts the stage's output where
  meaningful — materialize readbacks; elsewhere it decays to
  ``exception``)}. ``after=N`` skips the first N traversals of the point,
  ``count=M`` fires at most M times (so probes eventually succeed and the
  ladder steps back up); ``count`` defaults to 1, ``after`` to 0.

- **Circuit breakers + the degradation ladder** (`CircuitBreaker`,
  `PipelineSupervisor`): each fault domain gets a breaker (closed → open
  after ``threshold`` consecutive faults → half-open probe *off the
  serving path*, on an executor thread against engine-registered probe
  functions). Open breakers step the pipeline down the ladder per
  window::

      rung 0  device + cache + delta + compact   (everything on)
      rung 1  device-plain                        (cache_insert /
              overlay_apply domain open)
      rung 2  host-trie                           (dispatch /
              materialize domain open)

  and probe success steps back up. The ``lane_deliver`` breaker gates
  the delivery lanes (open → inline delivery), ``snapshot_swap`` gates
  background rebuild attempts, ``mesh_exchange`` gates the sharded mesh
  (``parallel/serving.ShardedRouteServer``: open, its windows route on
  the host; its injection point rides the mesh's dispatch, which the
  ``dispatch`` stage's watchdog covers). Knob: ``broker.supervise`` (on); off builds no supervisor
  anywhere and restores the unsupervised unwind exactly.

- **Window-journal replay** (`journal_admit`/`journal_settle`): every
  window entering the pipeline is journaled at admit and settled when
  its counts resolve. A stage death mid-window re-routes the journaled
  window through the host rung instead of failing its publishers.

- **Watchdogs**: the batcher bounds its dispatch/materialize awaits with
  ``deadline(stage)`` — ``clamp(mult·p99, floor, cap)`` off the stage
  histograms — and trips the stage's breaker instead of wedging; lane
  drains likewise detect stalls and restart dead lane workers.

**What the ladder contains on the card** (`contained`): where device
errors are fatal (``DeviceRouteEngine.fail_on_device_error``, the card),
only what the injector caused is contained and replayed — an injected
fault (``InjectedFault``, the ``resource`` kind's
``InjectedResourceExhausted`` included), a watchdog expiry while an
injected hang sleeps in that stage (``injected_stall``) and the consume
failure of a readback the injector corrupted. Any other exception (a
launch or illegal-address error, a real ``torch.cuda.OutOfMemoryError``,
a real stall, a kernel that fails to build, an assertion in the engine)
keeps the engine's fail-fast: it raises to the window's publishers and
sets ``DeviceRouteEngine.failed``. A host replay must not hide a broken
or wedged kernel. On the CPU every exception is contained, as in the
reference.

Counters land in the node's Metrics (``supervise.faults[.point]``,
``supervise.trips``, ``supervise.probes``, ``supervise.replays``,
``supervise.stalls[.stage]``, ``supervise.restarts``,
``supervise.task_errors``, ``supervise.rung_changes``);
``PipelineTelemetry.snapshot()['supervise']`` is the derived section
with the live breaker/rung/journal state.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Callable, Optional


log = logging.getLogger("emqx.supervise")

# the named stage boundaries (one fault domain each). The two overload
# points are traversed by the OverloadGovernor's poll, not a pipeline
# stage: a fired `signal_spike` clause forces the raw grade to critical
# for that poll, a fired `stuck_grade` clause blocks grade transitions.
# Their breakers exist but never open; the ladder gates ignore them.
FAULT_POINTS = ("dispatch", "materialize", "cache_insert",
                "overlay_apply", "lane_deliver", "snapshot_swap",
                "mesh_exchange", "signal_spike", "stuck_grade")
FAULT_KINDS = ("exception", "resource", "hang", "corrupt")

# ladder rungs (PipelineSupervisor.rung())
RUNG_FULL = 0          # device + cache + delta + compact
RUNG_DEVICE_PLAIN = 1  # device, reuse layers off
RUNG_HOST = 2          # host trie


def resolve_supervise(configured=None) -> bool:
    """``broker.supervise``, default on. Off builds no supervisor: no
    injector, no breakers, no watchdogs, no journal."""
    if configured is None:
        return True
    return bool(configured)


def resolve_breaker_threshold(configured=None) -> int:
    """``broker.supervise_threshold``: consecutive faults before a stage
    breaker opens, default 3."""
    if configured is None:
        return 3
    return int(configured)


class InjectedFault(RuntimeError):
    """A deterministic injected stage failure (kind=exception)."""


class InjectedResourceExhausted(InjectedFault):
    """OOM-like injected failure; the message carries the status string
    error classifiers look for."""

    def __init__(self, point: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected at {point} "
            f"(out of memory simulation)")


def contained(exc: BaseException, on_card: bool, *,
              injected: bool = False) -> bool:
    """Whether the ladder contains `exc` — notes it as a fault and replays
    its window on the host — or the failure raises to the publishers.

    On the CPU (``on_card`` False) every exception is contained, the
    reference's contract. On the card only what the injector caused is:
    an ``InjectedFault`` (the ``resource`` kind's included), or a failure
    the caller knows the injector caused (``injected``: a watchdog expiry
    while an injected hang sleeps in the stage, the consume failure of a
    readback the injector corrupted). Anything else — a launch or
    illegal-address error, a real out of memory or stall, a kernel that
    fails to build, an assertion inside the engine — is not: a host
    replay would hide a broken or wedged kernel."""
    if not on_card or injected:
        return True
    return isinstance(exc, InjectedFault)


# the injection points each watchdogged stage traverses on its thread: a
# stall of the stage is the injector's while a hang clause sleeps at one
# of them (the match cache's insert runs inside the readback, the mesh's
# exchange point inside its dispatch)
STAGE_POINTS = {"dispatch": ("dispatch", "mesh_exchange"),
                "materialize": ("materialize", "cache_insert")}


class _Fault:
    """One armed fault clause: fires on traversals (after, after+count]
    of its injection point."""

    __slots__ = ("point", "kind", "after", "count", "hang_s", "hits",
                 "fired")

    def __init__(self, point: str, kind: str, after: int = 0,
                 count: int = 1, hang_s: float = 30.0):
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(know {FAULT_POINTS})")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(know {FAULT_KINDS})")
        self.point = point
        self.kind = kind
        self.after = int(after)
        self.count = int(count)
        self.hang_s = float(hang_s)
        self.hits = 0     # traversals of the point seen by this clause
        self.fired = 0    # times this clause actually fired


def parse_faults(spec: Optional[str]) -> list[_Fault]:
    """Parse a fault spec: comma-separated
    ``point:kind[:after=N][:count=M][:hang_s=S]`` clauses. Raises
    ValueError on malformed input — a typo'd chaos spec silently doing
    nothing would defeat deterministic injection."""
    out: list[_Fault] = []
    if not spec:
        return out
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r}: want point:kind[:k=v...]")
        kw: dict = {}
        for p in parts[2:]:
            if "=" not in p:
                raise ValueError(
                    f"fault clause {clause!r}: option {p!r} is not k=v")
            k, v = p.split("=", 1)
            if k not in ("after", "count", "hang_s"):
                raise ValueError(
                    f"fault clause {clause!r}: unknown option {k!r}")
            kw[k] = float(v) if k == "hang_s" else int(v)
        out.append(_Fault(parts[0], parts[1], **kw))
    return out


class FaultInjector:
    """Deterministic injection-point registry. ``fire(point)`` is the
    stage-boundary check: raises (exception/resource), sleeps (hang) or
    returns ``"corrupt"`` for the caller to corrupt its own output.
    Thread-safe — dispatch/materialize traverse their points on executor
    threads."""

    def __init__(self, faults: Optional[list[_Fault]] = None):
        self.faults = list(faults or ())
        self._lock = threading.Lock()
        # hang clauses sleeping now, by point
        self._hanging: dict[str, int] = {}

    def armed(self) -> bool:
        return bool(self.faults)

    def armed_at(self, point: str) -> bool:
        """True while a clause at `point` can still fire."""
        with self._lock:
            return any(f.point == point and f.fired < f.count
                       for f in self.faults)

    def fire(self, point: str, corrupt_ok: bool = False) -> Optional[str]:
        """Traverse an injection point. Returns None (no fault due) or
        "corrupt" (only where the caller can corrupt its own output —
        ``corrupt_ok``; elsewhere a corrupt clause decays to
        ``exception``); raises InjectedFault/InjectedResourceExhausted
        or sleeps for the hang kind."""
        action = None
        with self._lock:
            for f in self.faults:
                if f.point != point:
                    continue
                f.hits += 1
                if f.hits > f.after and f.fired < f.count:
                    f.fired += 1
                    action = f
                    break
        if action is None:
            return None
        if action.kind == "hang":
            # the hang IS the injected fault: a clause emulating a wedged
            # stage blocks exactly where the real wedge would
            with self._lock:
                self._hanging[point] = self._hanging.get(point, 0) + 1
            try:
                time.sleep(action.hang_s)
            finally:
                with self._lock:
                    self._hanging[point] -= 1
            return None
        if action.kind == "resource":
            raise InjectedResourceExhausted(point)
        if action.kind == "corrupt" and corrupt_ok:
            return "corrupt"
        raise InjectedFault(f"injected fault at {point}")

    def hanging(self, points) -> bool:
        """True while a hang clause sleeps at one of `points`."""
        with self._lock:
            return any(self._hanging.get(p) for p in points)

    def state(self) -> list[dict]:
        with self._lock:
            return [{"point": f.point, "kind": f.kind, "after": f.after,
                     "count": f.count, "hits": f.hits, "fired": f.fired}
                    for f in self.faults]


class CircuitBreaker:
    """Per-stage breaker: closed → open after ``threshold`` consecutive
    faults → (cooldown) → half-open, where exactly one off-path probe
    decides close vs re-open with doubled cooldown. ``allow()`` answers
    the serving path's question — half-open still answers False, because
    the probe runs off the serving path."""

    __slots__ = ("stage", "threshold", "base_cooldown_s", "max_cooldown_s",
                 "state", "fails", "opened_at", "cooldown_s", "trips",
                 "_clock", "_lock")

    def __init__(self, stage: str, *, threshold: int = 3,
                 cooldown_s: float = 1.0, max_cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.stage = stage
        self.threshold = max(1, int(threshold))
        self.base_cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.state = "closed"
        self.fails = 0          # consecutive faults while closed
        self.opened_at = 0.0
        self.cooldown_s = cooldown_s
        self.trips = 0          # closed→open transitions
        self._clock = clock
        # note_fault/note_ok run on executor threads concurrently with
        # poll/probes on the loop: the read-modify-writes below must not
        # lose increments. allow() stays lock-free (one attribute read;
        # the gates re-check every window).
        self._lock = threading.Lock()

    def allow(self) -> bool:
        return self.state == "closed"

    def record_ok(self) -> None:
        """A successful serving-path traversal (only meaningful while
        closed)."""
        with self._lock:
            if self.state == "closed":
                self.fails = 0

    def record_fault(self) -> bool:
        """One serving-path fault. Returns True when this fault OPENED
        the breaker."""
        with self._lock:
            if self.state != "closed":
                return False
            self.fails += 1
            if self.fails >= self.threshold:
                self.state = "open"
                self.opened_at = self._clock()
                self.cooldown_s = self.base_cooldown_s
                self.trips += 1
                return True
            return False

    def probe_due(self) -> bool:
        with self._lock:
            return self.state == "open" \
                and self._clock() >= self.opened_at + self.cooldown_s

    def begin_probe(self) -> None:
        with self._lock:
            self.state = "half_open"

    def probe_ok(self) -> None:
        with self._lock:
            self.state = "closed"
            self.fails = 0
            self.cooldown_s = self.base_cooldown_s

    def probe_fail(self) -> None:
        with self._lock:
            self.state = "open"
            self.opened_at = self._clock()
            self.cooldown_s = min(2 * self.cooldown_s,
                                  self.max_cooldown_s)

    def snapshot(self) -> dict:
        return {"state": self.state, "fails": self.fails,
                "trips": self.trips,
                "cooldown_s": round(self.cooldown_s, 3)}


# process-wide count of guarded-task deaths, for contexts without a
# Metrics registry (and for tests asserting the guard fired at all)
_task_errors = 0
_task_errors_lock = threading.Lock()


def task_error_count() -> int:
    return _task_errors


def guard_task(task: "asyncio.Task", name: str, metrics=None,
               on_error: Optional[Callable[[BaseException], None]] = None
               ) -> "asyncio.Task":
    """Attach the one done-callback every pipeline task must carry: a
    non-cancelled exception is logged and counted
    (``supervise.task_errors``) instead of vanishing into the loop's
    never-retrieved-exception limbo. ``on_error`` lets owners add
    recovery (e.g. restart a worker)."""
    def _done(t: "asyncio.Task") -> None:
        if t.cancelled():
            return
        exc = t.exception()     # marks the exception as retrieved
        if exc is None:
            return
        global _task_errors
        with _task_errors_lock:
            _task_errors += 1
        if metrics is not None:
            try:
                metrics.inc("supervise.task_errors")
            except Exception:  # noqa: BLE001 — accounting must not mask
                pass           # the original failure being logged below
        log.error("task %r died: %s: %s", name, type(exc).__name__, exc,
                  exc_info=exc)
        if on_error is not None:
            try:
                on_error(exc)
            except Exception:  # noqa: BLE001
                log.exception("task %r on_error recovery failed", name)

    task.add_done_callback(_done)
    return task


# strong refs for guarded fire-and-forget tasks: the loop keeps only
# weak refs, so an unheld in-flight task can be collected mid-run
_spawned: set = set()


def spawn(coro, name: str, metrics=None) -> Optional["asyncio.Task"]:
    """Fire-and-forget a coroutine UNDER the task guard: strong ref until
    done + logged/counted death. Returns None (coroutine closed) when no
    loop is running."""
    try:
        task = asyncio.get_running_loop().create_task(coro)
    except RuntimeError:
        coro.close()
        return None
    _spawned.add(task)
    task.add_done_callback(_spawned.discard)
    return guard_task(task, name, metrics)


class _JournalEntry:
    """One admitted window's manifest: a REFERENCE to the batcher's live
    (message, future) batch list. The replay itself re-routes the
    batcher's own entry — this record is the accounting view: depth
    gauges, leak detection, and the debug surfaces (`topics`/`futs`) for
    a wedged window."""

    __slots__ = ("batch", "t0")

    def __init__(self, batch):
        self.batch = batch          # [(Message, Optional[Future])]
        self.t0 = time.monotonic()

    @property
    def topics(self):
        return tuple(m.topic for m, _f in self.batch)

    @property
    def futs(self):
        return tuple(f for _m, f in self.batch if f is not None)


class PipelineSupervisor:
    """The per-node supervision tree for the device route pipeline.

    Owns one breaker per fault domain, the fault injector, the window
    journal, and the watchdog deadlines. Components register probe
    functions (run on an executor thread, off the serving path) and
    consult the gates:

        allow_device()   rung < 2  — the batcher's device/host choice
        reuse_enabled()  rung == 0 — dedup/cache/delta/compact layers
        lanes_enabled()  the delivery-lane pool may take plans
        rebuild_enabled() background rebuilds may be attempted
        mesh_enabled()   the sharded mesh path may serve

    ``poll()`` runs on the batch cadence: it launches due half-open
    probes in the background. All gates are plain attribute/dict reads —
    no locks on the serving path.
    """

    def __init__(self, metrics, *, telemetry=None,
                 injector: Optional[FaultInjector] = None,
                 threshold: Optional[int] = None,
                 cooldown_s: float = 1.0,
                 watchdog_floor_s: float = 10.0,
                 watchdog_cap_s: float = 120.0,
                 watchdog_mult: float = 8.0):
        self.metrics = metrics
        self.telemetry = telemetry
        self.injector = injector if injector is not None else \
            FaultInjector()
        threshold = resolve_breaker_threshold(threshold)
        self.breakers: dict[str, CircuitBreaker] = {
            p: CircuitBreaker(p, threshold=threshold,
                              cooldown_s=cooldown_s)
            for p in FAULT_POINTS}
        # watchdog deadline shape: clamp(mult * p99, floor, cap). The
        # floor absorbs cold histograms and scheduling jitter; the cap
        # bounds how long a wedged stage can hold a pipeline slot
        self.wd_floor_s = watchdog_floor_s
        self.wd_cap_s = watchdog_cap_s
        self.wd_mult = watchdog_mult
        # the flight recorder (set by the node when tracing is on): trips,
        # rung changes and restarts land as node-scope events
        self.recorder = None
        self._probe_fns: dict[str, Callable[[], None]] = {}
        self._probe_tasks: dict[str, "asyncio.Task"] = {}
        self._journal: dict[int, _JournalEntry] = {}
        self._journal_ids = iter(range(1, 1 << 62)).__next__
        self._journal_lock = threading.Lock()

    # ---- fault injection (stage boundaries call these) -------------------
    def fire(self, point: str, corrupt_ok: bool = False) -> Optional[str]:
        """Traverse an injection point (no-op unless a clause armed it).
        Raises/sleeps/returns "corrupt" per the armed clause."""
        if not self.injector.armed():
            return None
        return self.injector.fire(point, corrupt_ok=corrupt_ok)

    # ---- fault accounting + breakers ------------------------------------
    def note_fault(self, point: str, exc: Optional[BaseException] = None
                   ) -> None:
        """One serving-path fault in a domain: count it, advance the
        breaker, and log the rung change when the breaker opens."""
        m = self.metrics
        m.inc("supervise.faults")
        m.inc(f"supervise.faults.{point}")
        br = self.breakers.get(point)
        if br is None:
            return
        before = self.rung()
        if br.record_fault():
            m.inc("supervise.trips")
            rung_moved = self.rung() != before
            if rung_moved:
                m.inc("supervise.rung_changes")
            if self.recorder is not None:
                # orthogonal-gate breakers (lane_deliver, snapshot_swap)
                # trip without moving the rung: those record as "trip"
                self.recorder.event(
                    0, "rung_change" if rung_moved else "trip",
                    meta={"point": point, "rung": self.rung(),
                          "trip": True})
            log.warning(
                "breaker %s OPEN after %d consecutive fault(s)%s — "
                "pipeline now at rung %d", point, br.threshold,
                f" ({type(exc).__name__}: {exc})" if exc else "",
                self.rung())

    def note_ok(self, point: str) -> None:
        br = self.breakers.get(point)
        if br is not None:
            br.record_ok()

    def note_stall(self, stage: str) -> None:
        """A watchdog deadline expired waiting on `stage`: count the stall
        and advance the stage's breaker."""
        self.metrics.inc("supervise.stalls")
        self.metrics.inc(f"supervise.stalls.{stage}")
        self.note_fault(stage)

    def injected_stall(self, stage: str) -> bool:
        """Whether a watchdog expiry at `stage` is the injector's doing:
        a hang clause sleeps at a point the stage traverses."""
        return self.injector.hanging(STAGE_POINTS.get(stage, (stage,)))

    def note_restart(self, what: str) -> None:
        self.metrics.inc("supervise.restarts")
        self.metrics.inc(f"supervise.restarts.{what}")
        if self.recorder is not None:
            self.recorder.event(0, "restart", meta={"what": what})

    def note_replay(self) -> None:
        self.metrics.inc("supervise.replays")

    # ---- the degradation ladder -----------------------------------------
    def rung(self) -> int:
        b = self.breakers
        if not (b["dispatch"].allow() and b["materialize"].allow()):
            return RUNG_HOST
        if not (b["cache_insert"].allow() and b["overlay_apply"].allow()):
            return RUNG_DEVICE_PLAIN
        return RUNG_FULL

    def allow_device(self) -> bool:
        return self.rung() < RUNG_HOST

    def reuse_enabled(self) -> bool:
        return self.rung() == RUNG_FULL

    def lanes_enabled(self) -> bool:
        return self.breakers["lane_deliver"].allow()

    def rebuild_enabled(self) -> bool:
        return self.breakers["snapshot_swap"].allow()

    def mesh_enabled(self) -> bool:
        return self.breakers["mesh_exchange"].allow()

    # ---- half-open probes (off the serving path) ------------------------
    def register_probe(self, stage: str, fn: Callable[[], None]) -> None:
        """A stage's health probe: a sync callable run on an executor
        thread when the stage's breaker is due for half-open; raising
        means still broken. Every probe ALSO re-traverses the stage's
        injection point, so a spent clause lets the probe succeed and the
        ladder step back up."""
        self._probe_fns[stage] = fn

    def poll(self) -> None:
        """Batch-cadence tick: launch due probes in the background. Cheap
        when nothing is open (one dict scan of closed breakers)."""
        for stage, br in self.breakers.items():
            t = self._probe_tasks.get(stage)
            if br.state == "half_open":
                dead = t is None or t.done()
                if not dead:
                    # a probe stranded on a torn-down loop never reaches
                    # done(): treat any probe not on the CURRENT loop as
                    # dead (several loops may run against one node)
                    try:
                        dead = t.get_loop() is not \
                            asyncio.get_running_loop()
                    except RuntimeError:
                        dead = False    # sync caller: can't judge
                if dead:
                    # the probe died without a verdict: re-open so the
                    # cooldown→probe cycle re-arms (a half-open breaker
                    # with no live probe would stay degraded forever)
                    self._probe_tasks.pop(stage, None)
                    br.probe_fail()
                    self.metrics.inc("supervise.probe_failures")
                continue
            if not br.probe_due():
                continue
            if t is not None and not t.done():
                continue
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                # no loop (sync callers): probe inline — still off the
                # serving path in that no live window rides it
                br.begin_probe()
                self._run_probe_sync(stage, br)
                continue
            br.begin_probe()
            self._probe_tasks[stage] = guard_task(
                loop.create_task(self._probe_async(stage, br)),
                f"supervise-probe-{stage}", self.metrics)

    def _run_probe_sync(self, stage: str, br: CircuitBreaker) -> None:
        self.metrics.inc("supervise.probes")
        before = self.rung()
        try:
            self.fire(stage)
            fn = self._probe_fns.get(stage)
            if fn is not None:
                fn()
        except Exception as e:  # noqa: BLE001 — probe verdict, not a bug
            br.probe_fail()
            self.metrics.inc("supervise.probe_failures")
            log.info("probe %s failed (%s): breaker stays open "
                     "(cooldown %.1fs)", stage, type(e).__name__,
                     br.cooldown_s)
            return
        br.probe_ok()
        if self.rung() != before:
            self.metrics.inc("supervise.rung_changes")
            if self.recorder is not None:
                self.recorder.event(
                    0, "rung_change",
                    meta={"point": stage, "rung": self.rung(),
                          "trip": False})
        log.info("probe %s ok: breaker closed — pipeline back at rung %d",
                 stage, self.rung())

    async def _probe_async(self, stage: str, br: CircuitBreaker) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._run_probe_sync, stage, br)

    # ---- watchdog deadlines ---------------------------------------------
    def deadline(self, stage: str) -> float:
        """Stall deadline for one stage await: clamp(mult * p99, floor,
        cap) off the stage histogram. The lane domain's time lands in the
        per-lane ``deliver_lane{i}`` histograms, so its deadline tracks
        the SLOWEST lane's p99; a dispatch's tracks the plain and the
        cached dispatch."""
        p99 = 0.0
        if self.telemetry is not None:
            hists = self.telemetry.metrics.histograms()
            if stage == "lane_deliver":
                names = [n for n in hists
                         if n.startswith("pipeline.stage.deliver_lane")]
            elif stage == "dispatch":
                names = ["pipeline.stage.dispatch.seconds",
                         "pipeline.stage.dispatch_cached.seconds"]
            else:
                names = [f"pipeline.stage.{stage}.seconds"]
            for n in names:
                h = hists.get(n)
                if h is not None and h.count:
                    p99 = max(p99, h.percentile(0.99))
        return min(self.wd_cap_s, max(self.wd_floor_s,
                                      self.wd_mult * p99))

    # ---- window journal (admit → settle / replay) -----------------------
    def journal_admit(self, batch) -> int:
        """Journal one window at pipeline admit: a reference to its
        (message, publisher-future) batch. Depth is the live in-flight
        gauge, and an entry still present after its futures settled is a
        leak. Returns the window id to settle with."""
        wid = self._journal_ids()
        entry = _JournalEntry(batch)
        with self._journal_lock:
            self._journal[wid] = entry
        return wid

    def journal_settle(self, wid: Optional[int]) -> None:
        if wid is None:
            return
        with self._journal_lock:
            self._journal.pop(wid, None)

    def journal_depth(self) -> int:
        return len(self._journal)

    # ---- telemetry ------------------------------------------------------
    def state(self) -> dict:
        """Live gauges for the telemetry snapshot's `supervise` section
        (counters ride the Metrics registry)."""
        return {
            "rung": self.rung(),
            "breakers": {s: b.snapshot()
                         for s, b in self.breakers.items()},
            "journal_depth": self.journal_depth(),
            "faults_armed": self.injector.state(),
            "watchdog": {"floor_s": self.wd_floor_s,
                         "cap_s": self.wd_cap_s,
                         "mult": self.wd_mult},
        }
