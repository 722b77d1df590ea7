"""Session-affine delivery lanes: the broker's egress stage.

The port's copy of ``emqx_tpu/broker/deliver.py``. The device engine's
consume (``DeviceRouteEngine.finish_sub``) gathers one sub-batch's clean
deliveries as ``(row_msg, sid, opt, fid)`` arrays; with the lanes on it
stops there and hands them to a ``DeliveryPlan`` instead of walking them
row by row into ``Broker._deliver``:

- **DeliveryPlan**: the plan buckets the rows by ``sid % n_lanes`` with
  ONE stable argsort (secondary key ``sid``, so a session's rows are
  contiguous and keep their order) and hands each lane a contiguous
  slice. A session always hashes to the same lane, so per-session FIFO
  holds by construction. Messages the fast path cannot prove clean
  (shared groups, rich subopts, overlay matches, dirty filters, host
  fallbacks) ride the same plan as ordered closures behind an all-lanes
  barrier: every lane finishes its slices first and one worker runs the
  closures in batch order — the inline loop's interleaving (fast rows,
  then slow messages, per window).
- **DeliveryLanePool**: ``broker.deliver_lanes`` asyncio lane workers
  (default ``min(4, cpus)``; 0 is the inline loop) consuming per-lane
  queues. The batcher's consume submits the plan and moves on;
  ``admit()`` bounds the outstanding plans (backpressure up to the
  publishers) and ``drain()`` holds a host-routed batch behind the lane
  work in flight, so a session's stream is never reordered.
- **DeliveryView**: the copy-on-write delivered message. It shares the
  routed message's payload, topic and headers and overlays ``subopts``;
  the first write materializes private dicts, and ``copy()`` gives a
  real, independent ``Message`` (what ``Session._enrich`` does first).
  ``messages.delivered`` and the ``message.delivered`` hook are counted
  per lane slice, and a same-session run of a slice is one
  ``deliver_batch()`` call (one session accept and one socket write)
  where the subscriber has it.

Ordering contract: for every session, the delivered sequence with
``deliver_lanes=N`` is the inline sequence (``deliver_lanes=0``).

In the port the lane workers share the event loop with the dispatch
(which runs on the loop on the card), so the lanes move delivery off
the consume stage and batch its bookkeeping; they add no parallelism.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Callable, Optional

import numpy as np

from emqx_tpu_torch.broker.message import Message, base62_encode, now_ms
from emqx_tpu_torch.broker.supervise import guard_task

log = logging.getLogger("emqx.deliver")

# a fast-path message whose deliveries were handed to the lanes: the
# consume loop must not treat it as "needs the slow path" (None) nor as a
# settled count (int) — the plan's finalize writes the real count
DEFERRED = object()


def _unpack_opts(b: int) -> dict:
    return {"qos": b & 0x3, "nl": (b >> 2) & 1, "rap": (b >> 3) & 1,
            "rh": (b >> 4) & 0x3}


# The packed subopts word is 6 bits (qos:2 | nl:1 | rap:1 | rh:2), so
# there are exactly 64 distinct unpacked dicts — precompute them all
# once instead of re-unpacking per delivery. CONTRACT: these dicts are
# FROZEN — every consumer treats delivered subopts as read-only
# (Session._enrich only reads; a path that extends them builds a new
# dict, e.g. dict(opts, share=g)).
OPT_TABLE = tuple(_unpack_opts(b) for b in range(64))


def resolve_deliver_lanes(configured=None) -> int:
    """``broker.deliver_lanes``, default ``min(4, cpus)``; 0 disables the
    lanes (the inline delivery loop). A negative count is a deployment
    error worth failing loudly on."""
    if configured is None:
        return min(4, os.cpu_count() or 1)
    val = int(configured)
    if val < 0:
        raise ValueError(f"deliver_lanes must be >= 0, got {val}")
    return val


class _ViewHeaders:
    """Read-through headers mapping of a DeliveryView: the base message's
    headers with `subopts` overlaid, no dict built. Writing through it
    materializes the view's private headers dict first (copy-on-write)."""

    __slots__ = ("_v",)

    def __init__(self, view: "DeliveryView"):
        self._v = view

    def get(self, key, default=None):
        h = self._v._headers
        if h is not None:
            return h.get(key, default)
        if key == "subopts":
            return self._v._subopts
        return self._v._base_headers.get(key, default)

    def __getitem__(self, key):
        h = self._v._headers
        if h is not None:
            return h[key]
        if key == "subopts":
            return self._v._subopts
        return self._v._base_headers[key]

    def __contains__(self, key):
        h = self._v._headers
        if h is not None:
            return key in h
        return key == "subopts" or key in self._v._base_headers

    def __setitem__(self, key, val):
        self._v._materialize_headers()[key] = val

    def pop(self, key, *a):
        return self._v._materialize_headers().pop(key, *a)

    def setdefault(self, key, default=None):
        return self._v._materialize_headers().setdefault(key, default)

    def update(self, *a, **kw):
        self._v._materialize_headers().update(*a, **kw)

    def __delitem__(self, key):
        del self._v._materialize_headers()[key]

    def popitem(self):
        return self._v._materialize_headers().popitem()

    def clear(self):
        self._v._materialize_headers().clear()

    def _as_dict(self) -> dict:
        h = self._v._headers
        if h is not None:
            return dict(h)
        d = dict(self._v._base_headers)
        d["subopts"] = self._v._subopts
        return d

    def items(self):
        return self._as_dict().items()

    def keys(self):
        return self._as_dict().keys()

    def values(self):
        return self._as_dict().values()

    def copy(self) -> dict:
        return self._as_dict()

    def __iter__(self):
        return iter(self._as_dict())

    def __len__(self):
        return len(self._as_dict())

    def __eq__(self, other):
        if isinstance(other, _ViewHeaders):
            other = other._as_dict()
        return self._as_dict() == other

    def __repr__(self):
        return repr(self._as_dict())


class DeliveryView:
    """Copy-on-write per-delivery message: shares the routed message's
    payload/topic/flags/headers and overlays `subopts` — the lane path's
    replacement for `msg.copy()` + `headers["subopts"] = subopts`.
    Message-API compatible: reads delegate, the first write materializes
    a private dict, `copy()` returns a real independent Message.

    Copy-on-write boundary: mutations through the Message API (set_flag /
    set_header / headers[...] / update_expiry) are isolated; the `flags`
    and `extra` dicts read through to the BASE message until a set_flag
    materializes — a consumer that mutates `msg.flags`/`msg.extra` by
    direct dict access would write the routed message every subscriber
    shares. Delivered messages are read-only by the Subscriber protocol
    (pubsub.py): `copy()` first to mutate beyond the API."""

    __slots__ = ("topic", "payload", "qos", "from_", "id", "ts", "extra",
                 "_base_flags", "_base_headers", "_subopts", "_flags",
                 "_headers")

    def __init__(self, msg, subopts: dict):
        self.topic = msg.topic
        self.payload = msg.payload
        self.qos = msg.qos
        self.from_ = msg.from_
        self.id = msg.id
        self.ts = msg.ts
        self.extra = msg.extra
        self._base_flags = msg.flags
        self._base_headers = msg.headers
        self._subopts = subopts
        self._flags = None
        self._headers = None

    # -- copy-on-write materialization --
    def _materialize_headers(self) -> dict:
        if self._headers is None:
            h = dict(self._base_headers)
            h["subopts"] = self._subopts
            self._headers = h
        return self._headers

    def _materialize_flags(self) -> dict:
        if self._flags is None:
            self._flags = dict(self._base_flags)
        return self._flags

    @property
    def headers(self):
        if self._headers is not None:
            return self._headers
        return _ViewHeaders(self)

    @property
    def flags(self):
        return self._flags if self._flags is not None else self._base_flags

    # -- Message API parity (broker/message.Message) --
    def get_flag(self, name: str, default: bool = False) -> bool:
        return bool(self.flags.get(name, default))

    def set_flag(self, name: str, val: bool = True) -> "DeliveryView":
        self._materialize_flags()[name] = val
        return self

    @property
    def retain(self) -> bool:
        return self.get_flag("retain")

    @property
    def dup(self) -> bool:
        return self.get_flag("dup")

    @property
    def is_sys(self) -> bool:
        return self.get_flag("sys") or self.topic.startswith("$SYS/")

    def get_header(self, name: str, default=None):
        if self._headers is not None:
            return self._headers.get(name, default)
        if name == "subopts":
            return self._subopts
        return self._base_headers.get(name, default)

    def set_header(self, name: str, val) -> "DeliveryView":
        self._materialize_headers()[name] = val
        return self

    def expiry_interval(self) -> Optional[int]:
        props = self.get_header("properties") or {}
        return props.get("message_expiry_interval")

    def is_expired(self) -> bool:
        exp = self.expiry_interval()
        if exp is None:
            return False
        return now_ms() > self.ts + exp * 1000

    def update_expiry(self) -> "DeliveryView":
        exp = self.expiry_interval()
        if exp is not None:
            remaining = max(1, exp - (now_ms() - self.ts) // 1000)
            props = dict(self.get_header("properties") or {})
            props["message_expiry_interval"] = int(remaining)
            self.set_header("properties", props)
        return self

    def copy(self) -> Message:
        if self._headers is not None:
            headers = dict(self._headers)
        else:
            headers = dict(self._base_headers)
            headers["subopts"] = self._subopts
        return Message(topic=self.topic, payload=self.payload,
                       qos=self.qos, from_=self.from_,
                       flags=dict(self.flags), headers=headers,
                       id=self.id, ts=self.ts, extra=dict(self.extra))

    def to_map(self) -> dict:
        return {
            "id": base62_encode(self.id), "topic": self.topic,
            "qos": self.qos, "from": self.from_,
            "payload": self.payload, "flags": dict(self.flags),
            "timestamp": self.ts, "retain": self.retain,
        }

    def to_wire(self) -> dict:
        return self.copy().to_wire()

    def __repr__(self):
        return (f"DeliveryView(topic={self.topic!r}, qos={self.qos}, "
                f"from_={self.from_!r})")


class DeliveryPlan:
    """One consumed sub-batch's delivery work: fast rows destined for the
    lanes plus slow-path closures behind the barrier. `counts[i]`
    accumulates message i's successful deliveries; `target` (the
    LaneCounts the engine returned to the batcher) is back-filled at
    finalize, and done-callbacks fire last (publisher futures, handle
    release). `lane_s` sums the seconds lane workers spent delivering it
    (their yields to the loop excluded). `trace` is its window's
    flight-recorder trace id, set by the engine: lane work records
    against it."""

    __slots__ = ("pool", "msgs", "counts", "fast_idx", "slow_items",
                 "filters", "_chunks", "routed_device", "pending",
                 "done", "target", "_cbs", "s_midx", "s_sid", "s_opt",
                 "s_fid", "_barrier_left", "_barrier_evt", "lane_s",
                 "trace", "_own_filters")

    def __init__(self, pool: "DeliveryLanePool", msgs: list):
        self.pool = pool
        self.msgs = msgs
        self.counts = np.zeros(len(msgs), np.int64)
        self.fast_idx: list[int] = []
        # (message index, fn) — fn() — or (indices, fn) — fn(i) for each
        self.slow_items: list[tuple] = []
        self.filters = None         # fid -> topic-filter string
        self._own_filters = False   # `filters` is this plan's own list
        self._chunks: list[tuple] = []
        self.routed_device = False
        self.pending = 0            # outstanding lane parts
        self.done = False
        self.target = None          # LaneCounts to back-fill
        self._cbs: list[Callable[[], None]] = []
        self.s_midx = self.s_sid = self.s_opt = self.s_fid = None
        self._barrier_left = 0
        self._barrier_evt: Optional[asyncio.Event] = None
        self.lane_s = 0.0
        self.trace = 0

    # -- building (engine consume stage, event loop) --
    def register_fast(self, indices) -> None:
        """Mark message indices whose deliveries the lanes own (their
        no-subscriber drop bookkeeping moves to finalize)."""
        self.fast_idx.extend(int(i) for i in indices)

    def add_rows(self, midx, sid, opt, fid, filters) -> None:
        """One vectorized chunk of fast deliveries: parallel arrays of
        (message index, session id, packed opts, filter id) plus the
        fid -> filter-string table they index (the pinned snapshot's
        `fid_filter`)."""
        if self.filters is None:
            self.filters = filters
        elif self.filters is not filters:
            # one snapshot per plan; remap should another table appear
            base = len(self.filters)
            self.filters = list(self.filters) + list(filters)
            self._own_filters = True
            fid = np.asarray(fid) + base
        self._chunks.append((np.asarray(midx, np.int64),
                             np.asarray(sid, np.int64),
                             np.asarray(opt, np.int64),
                             np.asarray(fid, np.int64)))

    def add_rows_py(self, msg_idx: int, rows: list) -> None:
        """Python-built fast rows of one message (the mesh consume's
        per-message collection): `rows` is [(sid, packed_opt,
        filter_string)], indexed through a filter table of the plan's
        own."""
        if not rows:
            return
        if not self._own_filters:
            self.filters = list(self.filters or ())
            self._own_filters = True
        base = len(self.filters)
        n = len(rows)
        self.filters.extend(r[2] for r in rows)
        self._chunks.append((
            np.full(n, msg_idx, np.int64),
            np.fromiter((r[0] for r in rows), np.int64, n),
            np.fromiter((r[1] for r in rows), np.int64, n),
            np.arange(base, base + n, dtype=np.int64)))

    def add_slow(self, msg_idx: Optional[int],
                 fn: Callable[[], int]) -> None:
        """A message the fast path cannot prove clean: `fn` runs the
        ordering-safe inline consume for it (behind the barrier) and
        returns its delivery count. ``msg_idx`` None is an ordered step
        of the consume that delivers nothing (the engine's host cursor
        write-back), whose result is not a count."""
        self.slow_items.append((msg_idx, fn))

    def add_slow_many(self, indices: list,
                      fn: Callable[[int], int]) -> None:
        """Slow messages `indices` (in batch order) consumed by one
        function, ``fn(i)`` -> message i's count: no object per message
        lives until the barrier (a closure each would be collector work
        for every window that waits for the lanes)."""
        if indices:
            self.slow_items.append((list(indices), fn))

    def slow_steps(self):
        """The slow work in order: (message index or None, fn, args)."""
        for idx, fn in self.slow_items:
            if isinstance(idx, list):
                for i in idx:
                    yield i, fn, (i,)
            else:
                yield idx, fn, ()

    def add_done_callback(self, cb: Callable[[], None]) -> None:
        if self.done:
            cb()
        else:
            self._cbs.append(cb)

    # -- completion (lane workers, event loop) --
    def _finish_part(self) -> None:
        self.pending -= 1
        if self.pending <= 0 and not self.done:
            self._finalize()

    def _finalize(self) -> None:
        self.done = True
        pool = self.pool
        if self.target is not None:
            counts = self.counts
            for i in range(len(self.msgs)):
                self.target[i] = int(counts[i])
        # no-subscriber bookkeeping for lane-owned messages (the slow
        # closures did their own inside the inline consume)
        metrics = pool.metrics
        hooks = pool.hooks
        for i in self.fast_idx:
            if self.counts[i] == 0 and not self.msgs[i].is_sys:
                metrics.inc("messages.dropped")
                metrics.inc("messages.dropped.no_subscribers")
                if hooks is not None:
                    hooks.run("message.dropped",
                              (self.msgs[i], "no_subscribers"))
        for cb in self._cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one waiter must not
                log.exception("delivery-plan callback failed")  # stall
        self._cbs = []
        pool._plan_done(self)


class LaneCounts(list):
    """finish_sub's return value when the lanes own the deliveries: a
    plain list of per-message counts (placeholders until the plan
    completes) carrying the plan, so the batcher can defer publisher
    futures with `plan.add_done_callback`."""

    plan: DeliveryPlan


_PARK = ("park",)


class DeliveryLanePool:
    """N session-affine delivery lanes on the event loop.

    Why asyncio tasks and not threads: every subscriber callback
    (channel -> session -> asyncio transport write) is loop-affine, so
    thread workers would need a lock per session; loop tasks keep the
    single-writer discipline for free. The lanes amortize per-row Python:
    one view object instead of a Message copy, coalesced same-session
    drains, and per-slice (not per-row) metric/hook bookkeeping.

    ``supervisor`` is the node's supervisor (None with ``supervise``
    off): its ``lane_deliver`` breaker gates the lanes (open → inline
    delivery, once the in-flight lane work drained), a drain or admit
    wait is bounded by its watchdog deadline with dead lane workers
    restarted (``note_restart``), and a slice or chunk that raises is
    noted as a fault and retried once.
    """

    def __init__(self, broker, metrics, *, hooks=None, telemetry=None,
                 n_lanes: int = 4, depth: int = 8, supervisor=None):
        self.broker = broker
        self.metrics = metrics
        self.hooks = hooks
        self.telemetry = telemetry
        self.sup = supervisor
        self.n_lanes = n_lanes
        # max outstanding PLANS (consumed sub-batches) before admit()
        # blocks the batcher's consumer — the backpressure bound
        self.depth = max(1, depth)
        self._loop = None
        self._queues: list[asyncio.Queue] = []
        self._workers: list[Optional[asyncio.Task]] = []
        self._wake: Optional[asyncio.Event] = None
        self._gate: Optional[asyncio.Event] = None
        self._paused = False
        self._live_plans = 0
        self._plans: list[DeliveryPlan] = []     # in-flight, FIFO
        self._lane_items: list[int] = [0] * n_lanes  # real work per lane
        # same-sid coalescing yields one drain per run; big slices are
        # chunked so one huge fan-out cannot monopolize the loop between
        # yields (the reference's sweep: 2048 rows a chunk, ~1-2 ms of
        # delivery a burst; finer chunks thrashed, coarser ones stalled)
        self._chunk = 2048

    # ---- lifecycle ------------------------------------------------------
    def active(self) -> bool:
        if self.n_lanes <= 0:
            return False
        if self.sup is None or self.sup.lanes_enabled():
            return True
        # lane_deliver breaker open: stop taking NEW plans only once the
        # in-flight lane work has drained — an inline fallback now could
        # deliver a session's newer message while its older rows are
        # still queued on a lane
        return self.busy()

    def ensure_loop(self) -> bool:
        """(Re)start the workers on the CURRENT running loop. Tests run
        several event loops against one Node; workers from a dead loop are
        discarded and fresh queues built — plans never span loops."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        if loop is not self._loop:
            orphans = [p for p in self._plans if not p.done]
            self._plans = []
            self._loop = loop
            self._queues = [asyncio.Queue() for _ in range(self.n_lanes)]
            self._workers = [None] * self.n_lanes
            self._wake = asyncio.Event()
            self._gate = asyncio.Event()
            if not self._paused:
                self._gate.set()
            self._lane_items = [0] * self.n_lanes
            # plans stranded by a torn-down loop must still finalize:
            # their callbacks release pinned snapshot handles — leaking
            # one would block every future swap on this engine
            self._live_plans = len(orphans)
            for p in orphans:
                p.pending = 0
                p._finalize()
        for i in range(self.n_lanes):
            w = self._workers[i]
            if w is None or w.done():
                self._workers[i] = guard_task(
                    loop.create_task(self._worker(i)),
                    f"deliver-lane{i}", self.metrics)
        return True

    def pause(self) -> None:
        """Quiesce the lanes (tests, shutdown drains): queued plans stay
        queued; resume() releases them."""
        self._paused = True
        if self._gate is not None:
            self._gate.clear()

    def resume(self) -> None:
        self._paused = False
        if self._gate is not None:
            self._gate.set()

    # ---- plan intake (engine consume stage) -----------------------------
    def new_plan(self, msgs: list) -> Optional[DeliveryPlan]:
        if not self.active() or not self.ensure_loop():
            return None
        return DeliveryPlan(self, msgs)

    def submit(self, plan: DeliveryPlan) -> None:
        """Bucket the plan's fast rows into session-affine lane slices
        (one stable argsort: primary sid % n_lanes, secondary sid — so a
        session's rows stay in arrival order AND contiguous for the
        coalesced drain) and enqueue; slow closures ride behind an
        all-lanes barrier. Returns immediately."""
        # workers may have parked since new_plan() — the barrier needs
        # every lane live, so re-arm them before enqueuing anything
        self.ensure_loop()
        parts = 0
        slices = []
        if plan._chunks:
            if len(plan._chunks) == 1:
                midx, sid, opt, fid = plan._chunks[0]
            else:
                midx = np.concatenate([c[0] for c in plan._chunks])
                sid = np.concatenate([c[1] for c in plan._chunks])
                opt = np.concatenate([c[2] for c in plan._chunks])
                fid = np.concatenate([c[3] for c in plan._chunks])
            plan._chunks = []
            lane = sid % self.n_lanes
            # stable single-key argsort: lane-major, sid-minor, original
            # order within a sid (sids are < 2^31 — the broker's counter)
            order = np.argsort((lane << np.int64(31)) | sid, kind="stable")
            # plain lists for the delivery walk: per-row numpy scalar
            # indexing costs ~3x a list index in the hot loop
            plan.s_midx = midx[order].tolist()
            plan.s_sid = sid[order].tolist()
            plan.s_opt = opt[order].tolist()
            plan.s_fid = fid[order].tolist()
            lanes_sorted = lane[order]
            bounds = np.searchsorted(lanes_sorted,
                                     np.arange(self.n_lanes + 1))
            for ln in range(self.n_lanes):
                lo, hi = int(bounds[ln]), int(bounds[ln + 1])
                if lo == hi:
                    continue
                parts += 1
                slices.append((ln, lo, hi))
            self.metrics.inc("pipeline.deliver.rows", len(order))
        if plan.slow_items:
            parts += 1
            plan._barrier_left = self.n_lanes
            plan._barrier_evt = asyncio.Event()
        # all fallible work is done: go live, then enqueue (put_nowait on
        # unbounded queues cannot raise — a half-enqueued plan would
        # wedge drain()/admit() forever)
        plan.pending = parts
        self._live_plans += 1
        for ln, lo, hi in slices:
            self._lane_items[ln] += 1
            self._queues[ln].put_nowait(("slice", plan, lo, hi))
        if plan.slow_items:
            # the barrier holds EVERY lane: the slow closures run with all
            # prior fast deliveries done and nothing overtaking
            for ln, q in enumerate(self._queues):
                self._lane_items[ln] += 1
                q.put_nowait(("barrier", plan))
        self.metrics.inc("pipeline.deliver.plans")
        if parts == 0:
            plan._finalize()
        else:
            self._plans.append(plan)

    def _plan_done(self, plan: DeliveryPlan) -> None:
        try:
            self._plans.remove(plan)
        except ValueError:
            pass    # zero-part plans finalize before tracking
        self._live_plans -= 1
        if self._wake is not None:
            self._wake.set()
        if self._live_plans == 0:
            # park the workers: idle tasks pending at loop teardown would
            # otherwise warn "task was destroyed"
            for q in self._queues:
                q.put_nowait(_PARK)

    # ---- flow control (batcher consume stage) ---------------------------
    async def admit(self) -> None:
        """Backpressure: block while more than `depth` plans are
        outstanding. Called by the batcher after enqueuing a plan — the
        stall propagates to its `_inflight` queue and from there to
        submit()/enqueue(), instead of dropping or buffering unboundedly."""
        if self._wake is None or self._live_plans <= self.depth:
            return
        self.metrics.inc("pipeline.deliver.backpressure_waits")
        while self._live_plans > self.depth:
            self._wake.clear()
            await self._wait_wake()

    async def drain(self) -> None:
        """Wait for every outstanding plan to finish delivering. Host-
        routed batches call this before delivering inline, so a host
        batch never overtakes lane-queued deliveries for a session."""
        if self._wake is None:
            return
        if self._loop is not asyncio.get_running_loop():
            # drain on a NEW loop: rebind first — ensure_loop finalizes
            # plans stranded on the dead loop, so this returns instead of
            # waiting on a wake event nobody can set
            self.ensure_loop()
        while self._live_plans > 0:
            self._wake.clear()
            await self._wait_wake()

    async def _wait_wake(self) -> None:
        """One wait on lane progress; with a supervisor, bounded by its
        lane_deliver deadline, restarting dead lane workers on expiry."""
        sup = self.sup
        if sup is None:
            await self._wake.wait()
            return
        try:
            await asyncio.wait_for(self._wake.wait(),
                                   sup.deadline("lane_deliver"))
        except asyncio.TimeoutError:
            sup.note_stall("lane_deliver")
            if self._revive_workers():
                sup.note_restart("lane_worker")

    def _revive_workers(self) -> int:
        """Restart dead lane workers on the current loop. Queues are
        untouched — a restarted worker picks up exactly where the dead
        one stopped, in order."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return 0
        if loop is not self._loop:
            return 0
        revived = 0
        for i, w in enumerate(self._workers):
            if w is None or w.done():
                self._workers[i] = guard_task(
                    loop.create_task(self._worker(i)),
                    f"deliver-lane{i}", self.metrics)
                revived += 1
        return revived

    def busy(self) -> bool:
        return self._live_plans > 0

    def queued_items(self) -> int:
        return sum(self._lane_items)

    def lane_depth(self) -> int:
        """Deepest lane (pending work items) right now — the exported
        gauge (park sentinels are housekeeping, not work: excluded)."""
        return max(self._lane_items, default=0)

    # ---- telemetry ------------------------------------------------------
    def state(self) -> dict:
        return {
            "lanes": self.n_lanes,
            "depth_limit": self.depth,
            "live_plans": self._live_plans,
            "queued_items": self.queued_items(),
            "lane_depth": self.lane_depth(),
            "paused": self._paused,
        }

    def stats_fun(self, stats) -> None:
        """Registered on Node.stats: the point-in-time lane gauges."""
        stats.setstat("pipeline.deliver.lane_depth", self.lane_depth())
        stats.setstat("pipeline.deliver.live_plans", self._live_plans)

    # ---- lane workers ---------------------------------------------------
    async def _worker(self, lane: int) -> None:
        q = self._queues[lane]
        tele = self.telemetry
        while True:
            item = await q.get()
            if item[0] == "park":
                if self._live_plans == 0 and q.empty():
                    return
                continue
            t0 = time.perf_counter()
            spent = 0.0
            worked = True
            try:
                if not self._gate.is_set():
                    try:
                        await self._gate.wait()
                    except asyncio.CancelledError:
                        # dying while HOLDING a popped item: surrender it
                        # or its plan's part leaks and every future drain
                        # wedges on work nobody owns
                        self._surrender(item)
                        raise
                if item[0] == "slice":
                    _k, plan, lo, hi = item
                    try:
                        try:
                            if self.sup is not None:
                                self.sup.fire("lane_deliver")
                            spent = await self._run_slice(plan, lane, lo,
                                                          hi)
                            if self.sup is not None:
                                self.sup.note_ok("lane_deliver")
                        except Exception as e:  # noqa: BLE001
                            if self.sup is None:
                                raise
                            # the slice failed before any delivery (the
                            # per-chunk faults are contained inside
                            # _run_slice), so a whole-slice retry cannot
                            # duplicate
                            self.sup.note_fault("lane_deliver", e)
                            try:
                                spent = await self._run_slice(plan, lane,
                                                              lo, hi)
                            except Exception:  # noqa: BLE001
                                log.exception(
                                    "lane %d slice %d..%d lost after "
                                    "retry", lane, lo, hi)
                                self.metrics.inc(
                                    "pipeline.deliver.deliver_errors")
                    finally:
                        plan.lane_s += spent
                        plan._finish_part()
                else:  # barrier
                    _k, plan = item
                    plan._barrier_left -= 1
                    if plan._barrier_left == 0:
                        try:
                            spent = await self._run_slow(plan)
                        finally:
                            plan.lane_s += spent
                            plan._barrier_evt.set()
                            plan._finish_part()
                    else:
                        # waiting out another lane's slow tail is not THIS
                        # lane's work: recording it would mask real
                        # per-lane hashing skew in deliver_lane{i}
                        worked = False
                        await plan._barrier_evt.wait()
            finally:
                # gauge accounting must survive cancellation anywhere in
                # the item's processing, or lane_depth overreports forever
                self._lane_items[lane] -= 1
            if tele is not None and worked:
                # the lane's own delivery time: unlike the reference's
                # span, the other tasks the loop ran at the chunks' yields
                # are not counted
                tele.observe_stage(f"deliver_lane{lane}", spent)
                rec = getattr(tele, "recorder", None)
                if rec is not None:
                    # the item's wall span, on its plan's window trace
                    # (item[1] is the plan for a slice and a barrier)
                    tr = item[1].trace
                    if tr:
                        rec.record(tr, f"lane{lane}", t0,
                                   time.perf_counter(), track=f"lane{lane}")

    def _surrender(self, item) -> None:
        """Account a popped-but-unprocessed queue item when its worker
        dies: the plan part is finished so drains can complete. A
        surrendered slice loses its deliveries (counted as
        deliver_errors); a surrendered barrier passes this lane through,
        and the LAST lane's surrender runs the slow closures
        synchronously so their deliveries survive."""
        if item[0] == "slice":
            self.metrics.inc("pipeline.deliver.deliver_errors")
            item[1]._finish_part()
        elif item[0] == "barrier":
            plan = item[1]
            plan._barrier_left -= 1
            if plan._barrier_left == 0:
                for idx, fn, args in plan.slow_steps():
                    try:
                        n = fn(*args)
                        if idx is not None:
                            plan.counts[idx] = n
                    except Exception:  # noqa: BLE001 — death path
                        self.metrics.inc("pipeline.deliver.slow_errors")
                if plan._barrier_evt is not None:
                    plan._barrier_evt.set()
                plan._finish_part()

    async def _run_slice(self, plan: DeliveryPlan, lane: int,
                         lo: int, hi: int) -> float:
        """Deliver one lane's slice, coalescing same-session runs, with a
        cooperative yield between chunks so a huge fan-out cannot
        monopolize the loop (later plans queue behind this one per lane,
        so order holds). With a supervisor a raising chunk is retried
        once, and only that chunk. Returns the seconds spent delivering
        (the yields excluded)."""
        sids = plan.s_sid
        sup = self.sup
        pos = lo
        spent = 0.0
        while pos < hi:
            t0 = time.perf_counter()
            nxt = min(hi, pos + self._chunk)
            # never split a same-session run across chunks: the coalesced
            # drain and its all-or-none accept are per run
            while nxt < hi and sids[nxt] == sids[nxt - 1]:
                nxt += 1
            if sup is None:
                self._deliver_rows(plan, pos, nxt)
            else:
                try:
                    self._deliver_rows(plan, pos, nxt)
                except Exception as e:  # noqa: BLE001 — contained
                    sup.note_fault("lane_deliver", e)
                    try:
                        self._deliver_rows(plan, pos, nxt)
                    except Exception:  # noqa: BLE001
                        log.exception("lane %d chunk %d..%d lost after "
                                      "retry", lane, pos, nxt)
                        self.metrics.inc("pipeline.deliver.deliver_errors")
            pos = nxt
            spent += time.perf_counter() - t0
            if pos < hi:
                await asyncio.sleep(0)
        return spent

    def _deliver_rows(self, plan: DeliveryPlan, lo: int, hi: int) -> None:
        broker = self.broker
        registry = broker._subscribers
        meta = broker._sub_meta
        hooks = self.hooks
        delivered_cbs = hooks.lookup("message.delivered") \
            if hooks is not None else ()
        msgs = plan.msgs
        filters = plan.filters
        sids, opts = plan.s_sid, plan.s_opt
        fids, midx = plan.s_fid, plan.s_midx
        delivered = 0
        drains = 0
        # one DeliveryView per (message, packed subopts), shared across
        # the fan-out — safe by the copy-on-write contract (every mutation
        # path on the view materializes private state)
        vcache: dict[int, DeliveryView] = {}
        delivered_midx: list[int] = []
        i = lo
        while i < hi:
            sid = sids[i]
            j = i + 1
            while j < hi and sids[j] == sid:
                j += 1
            sub = registry.get(sid)
            if sub is None:
                i = j
                continue
            items = []
            for k in range(i, j):
                vk = (midx[k] << 6) | (opts[k] & 0x3F)
                view = vcache.get(vk)
                if view is None:
                    view = vcache[vk] = DeliveryView(
                        msgs[midx[k]], OPT_TABLE[opts[k] & 0x3F])
                items.append((filters[fids[k]], view))
            batch_fn = getattr(sub, "deliver_batch", None) \
                if j - i > 1 else None
            # a raising subscriber/hook here is contained to ITS
            # deliveries (logged + counted) instead of failing the whole
            # batch's publish futures, as in the reference
            if batch_fn is not None:
                # coalesced drain: one session accept + one socket write
                # for the whole run (all-or-none by contract)
                try:
                    got = batch_fn(items)
                except Exception:  # noqa: BLE001 — one bad subscriber
                    log.exception("deliver_batch failed sid=%s", sid)
                    self.metrics.inc("pipeline.deliver.deliver_errors")
                    got = 0
                drains += 1
                if got:
                    delivered_midx.extend(midx[i:j])
                    delivered += len(items)
                    if delivered_cbs:
                        for _f, v in items:
                            hooks.run("message.delivered",
                                      (meta.get(sid), v))
            else:
                drains += j - i
                for k, (f, view) in zip(range(i, j), items):
                    try:
                        ok = sub.deliver(f, view)
                    except Exception:  # noqa: BLE001
                        log.exception("deliver failed sid=%s", sid)
                        self.metrics.inc("pipeline.deliver.deliver_errors")
                        ok = False
                    if ok:
                        delivered_midx.append(midx[k])
                        delivered += 1
                        if delivered_cbs:
                            hooks.run("message.delivered",
                                      (meta.get(sid), view))
            i = j
        if delivered_midx:
            np.add.at(plan.counts, delivered_midx, 1)
        # per-slice (not per-row) bookkeeping: the batching win the
        # coalesce.ratio histogram quantifies
        metrics = self.metrics
        if delivered:
            metrics.inc("messages.delivered", delivered)
            if plan.routed_device:
                metrics.inc("messages.routed.device", delivered)
        n_rows = hi - lo
        metrics.inc("pipeline.deliver.deliveries", n_rows)
        metrics.inc("pipeline.deliver.drains", drains)
        if n_rows:
            metrics.hist("pipeline.deliver.coalesce.ratio",
                         lo=1.0 / 256, n_buckets=9,
                         unit="ratio").observe(1.0 - drains / n_rows)

    async def _run_slow(self, plan: DeliveryPlan) -> float:
        """The ordering-safe serialized tail: slow-path messages in batch
        order, all lanes held at the barrier. Returns the seconds spent
        (the yields excluded)."""
        spent = 0.0
        t0 = time.perf_counter()
        for n, (idx, fn, args) in enumerate(plan.slow_steps()):
            try:
                got = fn(*args)
                if idx is not None:
                    plan.counts[idx] = got
            except Exception:  # noqa: BLE001 — a failing hook/deliver
                log.exception("slow-path consume failed")  # != lost lane
                self.metrics.inc("pipeline.deliver.slow_errors")
            if n % 64 == 63:
                spent += time.perf_counter() - t0
                await asyncio.sleep(0)
                t0 = time.perf_counter()
        return spent + time.perf_counter() - t0
