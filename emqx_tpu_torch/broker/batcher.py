"""Publish micro-batcher: the cross-connection batching window + pipeline.

The reference amortizes per-packet costs with `{active, N}` socket reads
inside ONE connection (emqx_connection.erl:111,454-464 — SURVEY.md P10);
the device design needs batching ACROSS connections so the fused device
route step sees a real batch. This is that window: channels submit
PUBLISHes here and await their delivery counts; a producer task
accumulates messages for at most `window_us` (or until `max_batch`), runs
the `message.publish` hook fold per message (concurrently), then routes
the batch.

The port's copy of ``emqx_tpu/broker/batcher.py``, whole on the path it
serves: the adaptive device/host chooser, window fusion with slow start,
the depth-1 synchronous consumer and the depth-N settle ring, FIFO settle
order, the pipeline telemetry (stage spans, occupancy, decisions) and the
delivery lanes' hand-off (a host batch drains the lanes first; a device
batch's futures resolve when its delivery plan completes; ``admit``
carries the lanes' backpressure up to the publishers), the columnar
ingress's burst hand-off (``submit_burst``), the flight recorder's window
traces (minted at admit, with the ``enqueue`` root span, sampled
per-message spans, ``batch_form``, ``host_route``, ``window`` and the
lane waits), the latency observatory's ``record_routed`` /
``record_delivered`` at settle, the overload governor's QoS 0 shed at
every admit path (``_shed_qos0``), and the supervision hooks: the window
journal (admit → settle), the supervisor's probe tick (inside the
engine's ``poll_rebuild``) and the ladder's host bypass
(``routing.device.supervised_bypass``), the watchdog-bounded stage
awaits (``_await_stage``) and the journaled window's host replay
(``_note_replay_span``: the ``replay`` latency series).

- **Supervised** (``node.supervisor``): a dispatch, readback or consume
  that fails is noted against its fault domain and its window replays
  through the host path at its settle turn, FIFO held. Where device
  errors are fatal (the card) only the faults ``supervise.contained``
  names replay, those the injector caused; any other exception or stall
  raises to the window's publishers and fails the engine. While a
  ``dispatch`` clause is armed the dispatch runs on the dispatch thread
  even where the engine dispatches on the loop, so the watchdog can see
  a hang.

- **Non-blocking**: device dispatch and device→host readback run on
  executor threads (DeviceRouteEngine.dispatch/materialize); the event
  loop only does the cheap encode (prepare) and the consume (finish),
  which with the delivery lanes builds a plan the lanes deliver.
- **Pipelined**: up to `pipeline_depth` dispatched batches are in flight;
  a consumer task completes them strictly in FIFO order, so per-publisher
  ordering holds even when device- and host-routed batches interleave
  (host batches ride the same in-order queue and are routed at consume
  time, never early).
- **Adaptive with live probes both ways**: the device/host choice compares
  measured EWMA costs. The host cost is refreshed by an ACTIVE probe every
  `host_probe_every` device batches; the device cost is re-probed every
  `_PROBE_EVERY` bypassed batches so a transiently slow device is not
  written off forever. Two changes from the reference. The device keeps
  a batch while its cost per message is at most ``_BYPASS_MARGIN`` times
  the host's (the reference: at most the host's). And each sample is
  what the batch itself cost to serve, per message. A device sample is
  the host work of the window's prepare, dispatch and consume plus the
  card's time for it (``_Handle.cost_s``); a host sample is the route
  walk without the time other tasks ran at its yields. The reference
  sampled the device as completion-to-completion time under load and the
  host across its yields, which in a busy event loop also count every
  other task the loop ran in between — ingest, socket writes, in-process
  clients — and the first slow sample sent a whole flood to the host.
  With the delivery lanes, a device window's sample is taken when its
  plans complete and includes the lanes' delivery seconds: both paths'
  samples count the delivery. The device's estimate is seeded by the
  median of its first three windows (not by the first alone), and after
  that a device sample spans at least ``max_batch`` messages: small
  windows are pooled with the next ones (``_device_sample``), so a run of
  small windows, whose fixed cost weighs 2-3x per message, moves the
  estimate by the messages it routed, not by its count of windows.
- **Double-buffered window pipeline**: at ``dispatch_depth >= 2`` the
  consumer becomes a bounded in-flight settle ring. Each dispatched
  window's remaining stages (await dispatch → launch + await materialize)
  run in their OWN task the moment the window is admitted from the FIFO
  queue, up to ``dispatch_depth`` windows concurrently — so dispatch(W+1)
  runs while materialize(W) is still copying back. Settle order stays
  STRICTLY FIFO (the ring head is always completed first). ``=1`` is the
  synchronous consumer.

Ordering: submissions are FIFO; batches complete in arrival order; within a
batch messages are consumed in order — MQTT's per-publisher-per-topic
ordering is preserved end to end.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.supervise import contained, guard_task

# re-probe the device path after this many consecutive host-routed
# batches, so a transiently slow device (cold warm-up, a stall) is not
# written off forever
_PROBE_EVERY = 64

# the device keeps the batches while its cost per message is at most this
# factor of the host's. A bypass keeps the device out for up to
# _PROBE_EVERY batches while a wrong device choice costs one window, and
# the estimates it compares move more than this margin leaves room for:
# on one H100's host the device's per-window samples spread 1.54-1.56x
# from p10 to p90 within a flood, and the host's cost moved 1.34x between
# two of its samples, one flood apart (PERF.md, Findings). A device
# at more than 1.5x the host's cost is still bypassed.
_BYPASS_MARGIN = 1.5

# device windows whose median seeds the device estimate (_device_sample)
_DEV_SEED = 3


def resolve_dispatch_depth(configured=None) -> int:
    """``broker.dispatch_depth``, default 2. ``=1`` is the synchronous
    consumer loop. Must be a positive integer; anything else is a
    deployment error worth failing loudly on."""
    if configured is None:
        return 2
    try:
        val = int(configured)
    except (TypeError, ValueError):
        raise ValueError(f"dispatch_depth={configured!r} is not an integer")
    if val < 1:
        raise ValueError(f"dispatch_depth must be >= 1, got {val}")
    return val


class PublishBatcher:
    def __init__(self, node, engine, *, window_us: int = 200,
                 max_batch: int = 1024, device_min_batch: int = 4,
                 max_pending: Optional[int] = None,
                 pipeline_depth: int = 8, host_probe_every: int = 32,
                 window_fuse: int = 8,
                 dispatch_depth: Optional[int] = None):
        self.node = node
        self.engine = engine
        self.window_s = window_us / 1e6
        self.max_batch = max_batch
        self.device_min_batch = device_min_batch
        self.pipeline_depth = pipeline_depth
        # how many dispatched windows may run their remaining stages
        # (dispatch-await + materialize) concurrently ahead of their FIFO
        # settle turn. 1 = the synchronous consumer.
        self.dispatch_depth = resolve_dispatch_depth(dispatch_depth)
        self.host_probe_every = host_probe_every
        # under sustained load, up to this many consecutive batches fuse
        # into ONE device dispatch (route_window) — the per-dispatch cost
        # is paid once per window
        self.window_fuse = max(1, min(window_fuse, 8))
        # fusion slow-start (congestion-control shaped): the width grows
        # x2 per successfully completed window and resets to 1 whenever
        # the chooser bypasses — early windows stay small so a slow
        # device is discovered after ~1 batch of regret, not 8
        self._fuse_cwnd = 1
        # fire-and-forget backpressure bound: beyond this, enqueue() refuses
        # and the caller must await submit() (stalling its read loop)
        self.max_pending = max_pending or 8 * max_batch
        self._queue: deque = deque()
        self._task: Optional[asyncio.Task] = None
        self._consumer: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Queue] = None
        # one dispatch thread keeps device dispatches ordered (the engine
        # threads cursors batch-to-batch); readbacks overlap on their own
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="route-dispatch")
        self._read_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="route-read")
        # adaptive device/host choice: EWMAs of measured cost — measure,
        # don't assume (SURVEY §7 hard-part 2's adaptive micro-batching).
        self._dev_msg_s: Optional[float] = None      # per device message
        self._host_msg_s: Optional[float] = None     # per host message
        self._dev_spike = 0       # consecutive-outlier streaks (_ewma)
        self._host_spike = 0
        # device windows not sampled yet: (seconds, messages). A device
        # sample spans at least max_batch messages (_device_sample); the
        # first _DEV_SEED windows' samples seed the estimate (their median)
        self._dev_pending = (0.0, 0)
        self._dev_seed: list = []
        # the chooser's last samples (seconds per message), per path
        self.cost_samples = {"device": deque(maxlen=4096),
                             "host": deque(maxlen=4096)}
        # each device window's own (messages, seconds), before pooling
        self.window_costs: deque = deque(maxlen=4096)
        # PUBLISH→route latency reservoir: oldest-enqueue → batch
        # completion, which upper-bounds every message in the batch.
        # _q_times parallels _queue.
        self._q_times: deque = deque()
        self.route_lat: deque = deque(maxlen=8192)
        self._since_probe = 0         # host batches since last device try
        self._since_host_probe = 0    # device batches since last host probe
        self._consuming = False       # consumer mid-entry (fast-path gate)
        # pipeline telemetry (stage spans / occupancy / decisions)
        self.tele = getattr(node, "pipeline_telemetry", None)
        # fault-domain supervision: the consumer's watchdog deadlines, the
        # window journal and the device/host ladder gate. None
        # (broker.supervise off) is the unsupervised unwind.
        self.sup = getattr(node, "supervisor", None)
        # the flight recorder: every window's trace id is minted HERE at
        # admit and rides the entry through dispatch/materialize/lanes to
        # settle. None (broker.trace off) records nothing.
        self.rec = getattr(node, "flight_recorder", None)
        # the latency observatory: per-message ingress→routed /
        # ingress→delivered recording at settle, keyed by the window's
        # (qos, path). None (broker.latency_observatory off) records
        # nothing.
        self.obs = getattr(node, "latency_observatory", None)
        # the overload governor: at grade critical its shed_qos0 action
        # drops QoS 0 PUBLISHes HERE, at admit — QoS 1/2 are never shed.
        # One attribute read per message when armed; none when None.
        self.gov = getattr(node, "overload_governor", None)
        # the most recent window's trace id (0 before any window): the
        # governor's shed events land on it
        self.last_trace = 0

    # ---- producer side --------------------------------------------------
    def _shed_qos0(self, msg: Message) -> bool:
        """True when the overload governor's shed_qos0 action is armed AND
        this message is QoS 0 — the message is dropped at admit (counted;
        the publisher owes no ack, so nothing hangs). QoS 1/2 never pass
        this gate."""
        gov = self.gov
        if gov is not None and gov.shed_qos0 and msg.qos == 0:
            gov.count_qos0_shed()
            return True
        return False

    def submit_future(self, msg: Message) -> asyncio.Future:
        """Queue one PUBLISH; the future resolves to its delivery count
        (0 at once for a shed QoS 0 message)."""
        fut = asyncio.get_running_loop().create_future()
        if self._shed_qos0(msg):
            fut.set_result(0)
            return fut
        self._queue.append((msg, fut))
        self._q_times.append(time.perf_counter())
        self._kick()
        return fut

    async def submit(self, msg: Message) -> int:
        """Queue one PUBLISH and await its delivery count."""
        return await self.submit_future(msg)

    def enqueue(self, msg: Message) -> bool:
        """Fire-and-forget submit (QoS0: the publisher owes no ack, so one
        connection can pipeline publishes into a single batch window).
        Returns False when the queue is over the backpressure bound — the
        caller must fall back to awaiting submit()."""
        if self._shed_qos0(msg):
            return True      # accepted-and-shed: no fallback submit
        if len(self._queue) >= self.max_pending:
            return False
        self._queue.append((msg, None))
        self._q_times.append(time.perf_counter())
        self._kick()
        return True

    def submit_burst(self, rows: list) -> dict:
        """Columnar-ingress hand-off: append a whole read burst's messages
        to the batch queue in one pass. `rows` is [(Message, needs_count)]
        in publisher frame order; the queue is FIFO, so per-publisher
        order holds by construction.

        QoS 0 rows (needs_count False) ride without futures, as
        enqueue(); QoS 1/2 rows get futures that resolve through the
        normal settle. One timestamp covers the burst, one _kick wakes
        the producer, and the burst's topics are encoded in one native
        pass (engine.preencode_burst) that the window's encode reuses.

        Returns {row_index: future} for every row the caller must await:
        all QoS 1/2 rows, plus the burst's LAST row when the queue crossed
        max_pending — awaiting it stalls the read loop, the backpressure
        a refused enqueue() exerts. While the overload governor sheds,
        QoS 0 rows never enter the queue; QoS 1/2 rows always do, and the
        surviving rows keep their order."""
        loop = asyncio.get_running_loop()
        futs: dict = {}
        q = self._queue
        qt = self._q_times
        now = time.perf_counter()
        over = len(q) + len(rows) > self.max_pending
        last = len(rows) - 1
        for i, (msg, need) in enumerate(rows):
            if not need and self._shed_qos0(msg):
                continue
            fut = None
            if need or (over and i == last):
                fut = loop.create_future()
                futs[i] = fut
            q.append((msg, fut))
            qt.append(now)
        if rows and self.engine is not None:
            self.engine.preencode_burst([m.topic for m, _n in rows])
        self._kick()
        return futs

    def _kick(self) -> None:
        if self._inflight is None:
            self._inflight = asyncio.Queue(maxsize=self.pipeline_depth)
        if self._task is None or self._task.done():
            self._task = guard_task(
                asyncio.get_running_loop().create_task(self._produce()),
                "batcher-produce", self.node.metrics)
        if self._consumer is None or self._consumer.done():
            self._consumer = guard_task(
                asyncio.get_running_loop().create_task(self._consume()),
                "batcher-consume", self.node.metrics)

    async def stop(self) -> None:
        for t in (self._task, self._consumer):
            if t is not None and not t.done():
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        # fail anything still queued/in flight so publishers unblock
        err = RuntimeError("publish batcher stopped")
        while self._queue:
            _m, fut = self._queue.popleft()
            if fut is not None and not fut.done():
                fut.set_exception(err)
        self._q_times.clear()
        if self._inflight is not None:
            while not self._inflight.empty():
                entry = self._inflight.get_nowait()
                if entry.get("eof"):
                    continue
                for _m, fut in entry["batch"]:
                    if fut is not None and not fut.done():
                        fut.set_exception(err)
                if entry.get("handle") is not None:
                    self.engine.abandon(entry["handle"])
                if self.sup is not None:
                    self.sup.journal_settle(entry.get("wid"))
        self._task = None
        self._consumer = None

    def close(self) -> None:
        self._dispatch_pool.shutdown(wait=False)
        self._read_pool.shutdown(wait=False)

    # ---- producer: form batches, choose path, dispatch ------------------
    async def _produce(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            while self._queue:
                # adaptive window: the first message opened it; give
                # concurrent connections one short beat to pile on unless
                # already full
                if len(self._queue) < self.max_batch and self.window_s > 0:
                    await asyncio.sleep(self.window_s)

                def form_entry(cap=None):
                    limit = min(self.max_batch, cap) if cap else \
                        self.max_batch
                    batch = []
                    rec = self.rec
                    sampled = None
                    t_enq = self._q_times[0] if self._q_times else \
                        time.perf_counter()
                    while self._queue and len(batch) < limit:
                        batch.append(self._queue.popleft())
                        tq = self._q_times.popleft()
                        if rec is not None and rec.sample_hit():
                            # sampled per-message span: this message
                            # records its own enqueue→settle interval on
                            # the window trace
                            if sampled is None:
                                sampled = []
                            sampled.append((len(batch) - 1, tq))
                    now = time.perf_counter()
                    if self.tele is not None:
                        # oldest-message queue wait before its batch formed
                        self.tele.observe_stage("enqueue", now - t_enq)
                    entry = {"batch": batch, "handle": None, "sub": 0,
                             "dispatch_fut": None, "live": None,
                             "live_idx": None, "t_enq": t_enq}
                    if rec is not None:
                        # the window's trace id, minted at admit; the
                        # enqueue span is the root every later span
                        # parents to
                        tid = rec.new_trace()
                        entry["trace"] = tid
                        self.last_trace = tid
                        entry["root_span"] = rec.record(
                            tid, "enqueue", t_enq, now, track="batcher",
                            meta={"batch": len(batch)})
                        if sampled:
                            entry["trace_msgs"] = sampled
                    if self.sup is not None:
                        # the window journal: the window's (message,
                        # future) batch, by reference, from admit until
                        # its counts resolve; a stage death mid-window
                        # replays exactly this manifest on the host
                        entry["wid"] = self.sup.journal_admit(batch)
                    return entry

                group = [form_entry()]
                try:
                    await self._fold_hooks(group[0])
                    if self.engine is not None:
                        # churn check rides the batch cadence: a threshold
                        # crossing kicks the background double-buffered
                        # rebuild even when batches are too small for the
                        # device path; the supervisor's probe tick rides
                        # the same call
                        self.engine.poll_rebuild()
                    live0 = group[0]["live"]
                    # the device/host DECISION runs on the first batch
                    # alone, BEFORE any fusion — a host probe (or bypass)
                    # then costs one batch at host speed, never a whole
                    # fused window
                    dispatched = False
                    use_device = (bool(live0) and self.engine is not None
                                  and len(live0) >= self.device_min_batch)
                    if use_device and self.sup is not None \
                            and not self.sup.allow_device():
                        # ladder rung 2: the dispatch or materialize
                        # breaker is open — this window routes through the
                        # host trie until the off-path probe closes it
                        self.node.metrics.inc(
                            "routing.device.supervised_bypass")
                        use_device = False
                    if use_device \
                            and not self.engine.batch_class_warm(
                                len(live0)):
                        # the class has not been warmed for the current
                        # snapshot: route host-side and let the background
                        # warm bring the device online
                        self.engine._kick_class_warm()
                        self.node.metrics.inc("routing.device.cold_class")
                        use_device = False
                    use_device = use_device \
                        and self._device_worth_it()
                    if use_device:
                        # window fusion: sustained backlog folds further
                        # batches into the SAME device dispatch — capped
                        # at the largest warmed window class and the
                        # slow-start width. A FIRST batch beyond the
                        # largest standard class dispatches alone.
                        b_std = self.engine._STD_CLASSES[-1][1]
                        fuse_cap = 1 if len(live0) > b_std else \
                            min(self.window_fuse,
                                self.engine.max_fuse(),
                                self._fuse_cwnd)
                        while (len(group) < fuse_cap
                               and len(self._queue)
                               >= self.device_min_batch):
                            # later sub-batches must stay inside the
                            # window class too
                            e2 = form_entry(cap=b_std)
                            await self._fold_hooks(e2)
                            group.append(e2)
                    lives = [e["live"] for e in group if e["live"]]
                    if use_device and lives:
                        handle = self.engine.prepare_window(lives)
                        if handle is None:
                            # the device path was CHOSEN but declined
                            # (mid-rebuild): these entries route host-side
                            # as the host_fallback latency series
                            for e in group:
                                e["fallback"] = True
                        if handle is not None:
                            dispatched = True
                            k = 0
                            first_live = None
                            for e in group:
                                if not e["live"]:
                                    continue
                                e["handle"] = handle
                                e["sub"] = k
                                if first_live is None:
                                    first_live = e
                                k += 1
                            # probe cadence counts SUB-BATCHES, so
                            # fusion does not stretch the host-refresh
                            # interval 8x
                            self._since_host_probe += len(lives)
                            self._since_probe = 0   # device just tried
                            if self.rec is not None:
                                self._trace_window(group, first_live,
                                                   handle)
                            first_live["dispatch_fut"] = \
                                self._dispatch(loop, handle)
                    if not dispatched:
                        self._since_probe += 1
                    if self.tele is not None:
                        self._record_decision(group, lives, dispatched)
                except asyncio.CancelledError:
                    for e in group:
                        self._fail_entry(
                            e, RuntimeError("publish batcher stopped"))
                    raise
                except Exception as e:
                    for en in group:
                        en["error"] = e
                if len(group) == 1 and group[0]["handle"] is None \
                        and self._inflight.empty() and not self._consuming:
                    # trickle fast path: nothing in flight ahead of us, so
                    # the host route runs inline — no pipeline hop
                    try:
                        await self._complete_host(group[0])
                    except asyncio.CancelledError:
                        # cancellable mid-completion (chunked yields), and
                        # this entry is in neither the queue nor the
                        # pipeline — fail it or its publishers strand
                        self._fail_entry(
                            group[0],
                            RuntimeError("publish batcher stopped"))
                        raise
                    continue
                for gi, entry in enumerate(group):
                    try:
                        # FIFO hand-off; blocks when pipeline_depth
                        # batches are in flight (backpressure up to
                        # enqueue()/submit())
                        await self._inflight.put(entry)
                    except asyncio.CancelledError:
                        # stop() cancelled us mid-put: these entries are
                        # in neither the queue nor the pipeline — fail
                        # them here or their publishers hang and the
                        # handle leaks
                        for e in group[gi:]:
                            self._fail_entry(
                                e, RuntimeError("publish batcher stopped"))
                        raise
            # queue drained: park the consumer too, then re-check — a
            # publish that landed while we were suspended on this put would
            # otherwise sit unprocessed (_kick sees a live task and won't
            # restart us)
            await self._inflight.put({"eof": True})
            if not self._queue:
                return

    def _dispatch(self, loop, handle) -> asyncio.Future:
        """Start one window's dispatch: on the dispatch thread, or — for
        an engine whose dispatch only enqueues work on the card
        (``dispatch_on_loop``) — right here on the loop. Such a dispatch
        is Python launch work that holds the GIL throughout; on a thread
        it would wait for the busy loop at every GIL hand-off. While the
        supervisor's injector holds a ``dispatch`` clause the dispatch
        takes the thread all the same: a hang clause on the loop would
        block the loop, and the watchdog would find the dispatch done."""
        sup = self.sup
        if not getattr(self.engine, "dispatch_on_loop", False) or (
                sup is not None and sup.injector.armed()
                and sup.injector.armed_at("dispatch")):
            return loop.run_in_executor(self._dispatch_pool,
                                        self.engine.dispatch, handle)
        fut = loop.create_future()
        try:
            self.engine.dispatch(handle)
        except Exception as e:  # noqa: BLE001 — settles as a failed stage
            fut.set_exception(e)
        else:
            fut.set_result(None)
        return fut

    def _trace_window(self, group: list, first_live: dict, handle) -> None:
        """The fused dispatch records under the LEAD entry's trace; each
        sub-batch's own trace rides ``handle.sub_traces``, so its deliver
        and lane spans land on its own window, and fused followers link
        to the lead with a ``fused`` event. Host-side only: the id never
        enters the dispatch's inputs (a CUDA graph replays fixed
        addresses)."""
        handle.trace = first_live.get("trace", 0)
        handle.sub_traces = [e.get("trace", 0) for e in group if e["live"]]
        for e in group:
            if e["live"] and e is not first_live and "trace" in e:
                self.rec.event(e["trace"], "fused", track="batcher",
                               parent=e.get("root_span", 0),
                               meta={"lead": handle.trace})

    def _record_decision(self, group: list, lives: list,
                         dispatched: bool) -> None:
        """The routing decision of a formed group: which device program
        took its window (overlay first, then the dedup plan, then the CSR
        readback), or host for every batch of a group that fell back."""
        if dispatched:
            h = next(e["handle"] for e in group
                     if e["handle"] is not None)
            path = "device_delta" if h.delta is not None else \
                "device_cached" if h.plan is not None else \
                "device_compact" if h.pcap is not None else "device"
            self.tele.record_decision(path, len(lives))
            return
        self.tele.record_decision("host", len(group))
        for e in group:
            self.tele.record_occupancy("host",
                                       len(e["batch"]) / self.max_batch)

    def _fail_entry(self, entry: dict, err: Exception) -> None:
        for _m, fut in entry["batch"]:
            if fut is not None and not fut.done():
                fut.set_exception(err)
        if entry.get("handle") is not None:
            self.engine.abandon(entry["handle"])
            entry["handle"] = None
        if self.sup is not None:
            # failed is not lost silently: the futures above carry the
            # error to their publishers
            self.sup.journal_settle(entry.get("wid"))

    async def _fold_hooks(self, entry: dict) -> None:
        """message.publish hook fold, concurrently across the batch."""
        t0 = time.perf_counter()
        broker = self.node.broker
        batch = entry["batch"]
        if not broker.hooks.lookup("message.publish"):
            # empty hook chain: a fold would return every message
            # unchanged — skip the per-message coroutine fan-out, but
            # keep one scheduling point (background warms and readbacks
            # rely on the producer yielding between windows)
            await asyncio.sleep(0)
            folded = [m for m, _f in batch]
        else:
            folded = await asyncio.gather(*[
                broker.hooks.run_fold_async("message.publish", (), m)
                for m, _f in batch])
        live_idx: list[int] = []
        live: list[Message] = []
        for i, m in enumerate(folded):
            if m is None or m.get_header("allow_publish") is False:
                continue
            broker.metrics.inc("messages.publish")
            live_idx.append(i)
            live.append(m)
        entry["live"] = live
        entry["live_idx"] = live_idx
        if self.tele is not None:
            self.tele.observe_stage("batch_form", time.perf_counter() - t0)
        if self.rec is not None and "trace" in entry:
            self.rec.record(entry["trace"], "batch_form", t0,
                            time.perf_counter(), track="batcher",
                            parent=entry.get("root_span", 0))

    # ---- consumer: complete batches strictly in order --------------------
    async def _complete_host(self, entry: dict, routed=None) -> None:
        """Route an entry host-side (or publish a device result) and
        resolve its futures. Raises nothing. Yields every 64 routed
        messages — a 1024-message host fallback otherwise stalls the
        whole event loop for tens of ms. Safe against reordering: the
        trickle caller runs in the producer task (nothing can enqueue
        behind it while it awaits) and the consumer is strictly
        sequential; a host batch first drains the delivery lanes, so it
        never overtakes a session's lane-queued device deliveries. A
        device result whose deliveries the lanes own (a LaneCounts)
        resolves its futures when its plan completes."""
        batch = entry["batch"]
        counts = [0] * len(batch)
        tele = self.tele
        rec = self.rec
        obs = self.obs
        tid = entry.get("trace") if rec is not None else None
        path = "host" if routed is None else "device"
        # the latency series key: the five-way split of where the window
        # was routed (the coarse `path` above keeps its two values)
        if routed is not None:
            lpath = "device_cached" \
                if getattr(entry.get("handle"), "plan", None) is not None \
                else "device"
        elif entry.get("replayed"):
            lpath = "replay"
        elif entry.get("fallback") or entry.get("handle") is not None:
            lpath = "host_fallback"
        else:
            lpath = "host"
        try:
            if "error" in entry:
                raise entry["error"]
            live, live_idx = entry["live"], entry["live_idx"]
            if routed is None and live:
                pool = getattr(self.node, "deliver_lanes", None)
                if pool is not None and pool.busy():
                    t_d = time.perf_counter()
                    await pool.drain()
                    if tid is not None:
                        # a real wait on the lanes: the lane-backpressure
                        # bubble, named
                        rec.record(tid, "lane_drain", t_d,
                                   time.perf_counter(), track="batcher",
                                   parent=entry.get("root_span", 0))
                span = 0.0
                t0 = t_route = time.perf_counter()
                routed = []
                broker = self.node.broker
                for j, m in enumerate(live):
                    if tele is not None and j % 32 == 0:
                        # sampled host match split (1-in-32)
                        tm = time.perf_counter()
                        mt = broker.router.match(m.topic)
                        tele.observe_stage("host_match",
                                           time.perf_counter() - tm)
                    else:
                        mt = broker.router.match(m.topic)
                    routed.append(broker._route(m, mt))
                    if j % 64 == 63:
                        span += time.perf_counter() - t0
                        await asyncio.sleep(0)
                        t0 = time.perf_counter()
                span += time.perf_counter() - t0
                if tele is not None:
                    tele.observe_stage("host_route", span)
                if tid is not None:
                    # the walk's wall span, its yields included
                    rec.record(tid, "host_route", t_route,
                               time.perf_counter(), track="host",
                               parent=entry.get("replay_span")
                               or entry.get("root_span", 0))
                self.node.metrics.inc("routing.host.route_us",
                                      int(span * 1e6))
                self.node.metrics.inc("routing.host.messages", len(live))
                sample = span / len(live)
                self.cost_samples["host"].append(sample)
                self._host_msg_s, self._host_spike = _ewma(
                    self._host_msg_s, sample, self._host_spike)
            if obs is not None and live:
                # ingress→routed: the route result of every live message
                # is in hand (a device window's came in precomputed).
                # Only socket-ingress messages carry a stamp
                t_ns = time.perf_counter_ns()
                tr = entry.get("trace", 0)
                for m in live:
                    ing = m.ingress_ns
                    if ing:
                        obs.record_routed(m, lpath, (t_ns - ing) / 1e9,
                                          trace=tr)

            def settle() -> None:
                if live:
                    for j, i in enumerate(live_idx):
                        counts[i] = routed[j]
                for i, (_m, fut) in enumerate(batch):
                    if fut is not None and not fut.done():
                        fut.set_result(counts[i])
                if self.sup is not None:
                    self.sup.journal_settle(entry.get("wid"))
                if obs is not None and live:
                    # ingress→delivered: settle runs when the deliveries
                    # are written — inline for host batches, from the
                    # delivery plan's done-callback when the lanes own
                    # the walk
                    t_ns = time.perf_counter_ns()
                    for m in live:
                        ing = m.ingress_ns
                        if ing:
                            obs.record_delivered(m, lpath,
                                                 (t_ns - ing) / 1e9)
                # PUBLISH→route latency sample: oldest enqueue →
                # completion (the device path funnels through here with
                # `routed` precomputed)
                t_enq = entry.get("t_enq")
                if t_enq is not None:
                    total = time.perf_counter() - t_enq
                    self.route_lat.append(total)
                    if tele is not None:
                        tele.record_total(total, batch=len(batch),
                                          path=path)
                if tid is not None:
                    now = time.perf_counter()
                    # the window roll-up span (admit → settle) and the
                    # sampled per-message enqueue→settle spans
                    rec.record(tid, "window", t_enq or now, now,
                               track="window",
                               meta={"path": path, "batch": len(batch)})
                    for i, tq in entry.get("trace_msgs", ()):
                        m = batch[i][0]
                        rec.record(tid, "message", tq, now,
                                   track="messages",
                                   parent=entry.get("root_span", 0),
                                   meta={"topic": m.topic, "qos": m.qos})

            plan = getattr(routed, "plan", None)
            if plan is not None and not plan.done:
                plan.add_done_callback(settle)
            else:
                settle()
        except Exception as e:  # route failure must not hang publishers
            for _m, fut in batch:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            if self.sup is not None:
                self.sup.journal_settle(entry.get("wid"))

    async def _consume(self) -> None:
        if self.dispatch_depth > 1:
            # the bounded in-flight settle ring — stages run ahead per
            # window, settle stays FIFO
            await self._consume_pipelined()
            return
        loop = asyncio.get_running_loop()
        while True:
            entry = await self._inflight.get()
            if entry.get("eof"):
                if self._park_ok():
                    return
                continue
            self._consuming = True
            try:
                routed = None
                if entry.get("handle") is not None and "error" not in entry:
                    routed = await self._complete_device(entry, loop)
                await self._complete_host(entry, routed)
            except asyncio.CancelledError:
                self._fail_entry(entry,
                                 RuntimeError("publish batcher stopped"))
                raise
            except Exception as e:
                # a failing deliver callback / hook must neither hang the
                # batch's publishers nor kill the consumer task
                self._fail_entry(entry, e)
            finally:
                self._consuming = False

    def _park_ok(self) -> bool:
        """True when the consumer may park (queue drained, producer
        done) — the synchronous loop's eof exit condition, shared by the
        pipelined ring."""
        return self._inflight.empty() and not self._queue \
            and (self._task is None or self._task.done())

    async def _stages(self, entry: dict, loop) -> bool:
        """Await one dispatched window's dispatch, then launch + await its
        materialize. Returns False when the window falls back to the host
        path at its settle turn (the handle abandoned).

        Unsupervised, a failure abandons the handle and, where the engine
        says device errors are fatal (on the card), raises to the
        window's publishers; otherwise the window falls back. Supervised,
        each await is bounded by the stage's watchdog deadline and a
        failure is noted against the stage's fault domain and replayed
        (``_await_stage``)."""
        handle = entry["handle"]
        if self.sup is not None:
            if not await self._await_stage(entry["dispatch_fut"],
                                           "dispatch", handle, entry):
                return False
            mat = loop.run_in_executor(self._read_pool,
                                       self.engine.materialize, handle)
            return await self._await_stage(mat, "materialize", handle,
                                           entry)
        try:
            await entry["dispatch_fut"]
            await loop.run_in_executor(
                self._read_pool, self.engine.materialize, handle)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.node.metrics.inc("routing.device.dispatch_failed")
            if self.engine.fail_on_device_error:
                self.engine.abandon(handle, error=e)
                raise
            self.engine.abandon(handle)
            self._note_replay_span(entry, "device", type(e).__name__)
            return False
        return True

    async def _await_stage(self, fut, stage: str, handle,
                           entry: dict) -> bool:
        """Await one stage under the supervisor's watchdog deadline
        (``deadline(stage)``, from the stage histogram's p99). Returns
        True on success, False when the window replays on the host (the
        handle abandoned, the fault or stall noted, the replay counted).
        A failure the ladder does not contain on the card
        (``supervise.contained``) — a real error, or a stall while no
        injected hang sleeps in the stage — raises to the publishers
        instead and fails the engine.

        On a stall the stage's thread may still be inside the stage: the
        handle stops serving at once (its other sub-batches replay too),
        but its release — the snapshot pin, the HBM ledger's pin — waits
        until the thread leaves, so nothing the thread still reads is
        handed to a later window."""
        sup = self.sup
        deadline = sup.deadline(stage)
        try:
            await asyncio.wait_for(asyncio.shield(fut), deadline)
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError:
            err = TimeoutError(f"{stage} stalled past its watchdog "
                               f"deadline ({deadline:.3f} s)")
            # on the card a real stall (no injected hang sleeps in the
            # stage) means the kernel or the link is wedged, and the
            # context with it
            fatal = not contained(err, self.engine.fail_on_device_error,
                                  injected=sup.injected_stall(stage))
            self.engine.abandon(handle, error=err if fatal else None,
                                defer=True)

            def left(f) -> None:
                if not f.cancelled():
                    f.exception()       # retrieved: the window moved on
                self.engine.abandon(handle)

            fut.add_done_callback(left)
            self.node.metrics.inc("routing.device.dispatch_failed")
            if fatal:
                self.engine._fail(err)
                raise err
            sup.note_stall(stage)
            sup.note_replay()
            self._note_replay_span(entry, stage, "stall")
            return False
        except Exception as e:
            self.node.metrics.inc("routing.device.dispatch_failed")
            if not contained(e, self.engine.fail_on_device_error):
                self.engine.abandon(handle, error=e)
                raise
            self.engine.abandon(handle)
            sup.note_fault(stage, e)
            sup.note_replay()
            self._note_replay_span(entry, stage, type(e).__name__)
            return False
        return True

    def _note_replay_span(self, entry: dict, stage: str, kind: str) -> None:
        """A dispatched window that falls back to the host path: a
        supervised journal replay lands in the ``replay`` latency series,
        an unsupervised fallback in ``host_fallback``. Either way it KEEPS
        its trace id, with a ``replay`` event under the window root that
        the host_route after it parents to."""
        entry["replayed" if self.sup is not None else "fallback"] = True
        if self.rec is not None and "trace" in entry:
            entry["replay_span"] = self.rec.event(
                entry["trace"], "replay", track="batcher",
                parent=entry.get("root_span", 0),
                meta={"stage": stage, "kind": kind})

    async def _consume_pipelined(self) -> None:
        """Depth-N in-flight settle ring.

        Admission: entries pop from the FIFO queue into the ring; a
        DISPATCHING entry (it owns a window's dispatch_fut) starts its
        stage task immediately, and admission pauses once
        ``dispatch_depth`` such windows are in flight (host batches and
        fused-window followers admit freely — they pin no extra device
        buffers). Settle: strictly the ring head, so completion order —
        and therefore per-publisher delivery order — is identical to the
        synchronous loop; only WHEN dispatch/materialize run moves. A
        stage task that failed already abandoned its handle; its window
        routes through the host path at its own settle turn, FIFO
        preserved."""
        loop = asyncio.get_running_loop()
        ring: deque = deque()
        eof_seen = False
        try:
            while True:
                while not eof_seen:
                    if ring:
                        # count LIVE stage tasks only: a window whose
                        # stages finished but which still waits its
                        # FIFO settle turn no longer occupies a
                        # pipeline slot — counting it would serialize
                        # admission behind the settle loop and collapse
                        # the effective depth to ~1 under load
                        in_flight = sum(
                            1 for e in ring
                            if e.get("stage_task") is not None
                            and not e["stage_task"].done())
                        if in_flight >= self.dispatch_depth:
                            break
                        try:
                            entry = self._inflight.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                    else:
                        entry = await self._inflight.get()
                    if entry.get("eof"):
                        if ring:
                            # drain the ring first, then re-check the
                            # park condition (the producer already
                            # exited after this eof)
                            eof_seen = True
                            break
                        if self._park_ok():
                            return
                        continue
                    if entry.get("handle") is not None \
                            and entry.get("dispatch_fut") is not None \
                            and "error" not in entry:
                        entry["stage_task"] = guard_task(
                            loop.create_task(self._stages(entry, loop)),
                            "batcher-window-stages", self.node.metrics)
                    ring.append(entry)
                    # the trickle fast path must not overtake ring
                    # entries: anything in the ring means "mid-consume"
                    self._consuming = True
                if not ring:
                    continue
                entry = ring.popleft()
                try:
                    routed = None
                    if entry.get("handle") is not None \
                            and "error" not in entry:
                        routed = await self._complete_device(entry, loop)
                    await self._complete_host(entry, routed)
                except asyncio.CancelledError:
                    self._fail_entry(
                        entry, RuntimeError("publish batcher stopped"))
                    raise
                except Exception as e:
                    self._fail_entry(entry, e)
                finally:
                    self._consuming = bool(ring)
                if eof_seen and not ring:
                    eof_seen = False
                    if self._park_ok():
                        return
        except asyncio.CancelledError:
            err = RuntimeError("publish batcher stopped")
            for e in ring:
                st = e.get("stage_task")
                if st is not None and not st.done():
                    st.cancel()
                self._fail_entry(e, err)
            self._consuming = False
            raise

    async def _complete_device(self, entry: dict, loop) -> Optional[list]:
        """Await dispatch + readback off-loop, consume on-loop. Returns the
        per-live-message counts, or None to fall back to the host path.
        Window entries after the first reuse the already-materialized
        handle (FIFO adjacency guarantees the dispatching entry ran)."""
        handle = entry["handle"]
        sub = entry.get("sub", 0)
        n_subs = len(handle.subs)
        st = entry.get("stage_task")
        if st is not None:
            # pipelined mode: the window's dispatch/materialize ran in its
            # own in-flight stage task — settle just collects the verdict
            # (or its error)
            if not await st:
                return None
        elif entry["dispatch_fut"] is not None:
            if not await self._stages(entry, loop):
                return None
        if handle.built is None or handle.np_res is None \
                or handle.abandoned:
            # the window's dispatching entry failed/abandoned earlier
            if handle.error is not None:
                raise handle.error
            return None
        sup = self.sup
        try:
            counts = self.engine.finish_sub(handle, sub)
        except Exception as e:
            if sup is None or not contained(
                    e, self.engine.fail_on_device_error,
                    injected=handle.corrupt):
                raise
            # consume died mid-window (a corrupt readback): abandon the
            # pinned snapshot and replay the journaled window on the host
            # — it re-routes every message, so QoS>=1 loses nothing and
            # per-session order holds (the host completion drains the
            # lanes first)
            self.engine.abandon(handle)
            sup.note_fault("materialize", e)
            sup.note_replay()
            self.node.metrics.inc("routing.device.dispatch_failed")
            self._note_replay_span(entry, "consume", type(e).__name__)
            return None
        pool = getattr(self.node, "deliver_lanes", None)
        if pool is not None and pool.active():
            # backpressure: too many plans queued in the delivery lanes
            # stalls THIS consumer, which fills _inflight, which blocks
            # the producer's put, which bounces submit()/enqueue() — a
            # blocked lane stalls publishers instead of buffering (or
            # dropping) deliveries
            t_a = time.perf_counter()
            await pool.admit()
            if self.rec is not None and "trace" in entry \
                    and time.perf_counter() - t_a > 5e-4:
                # only a REAL wait is a lane-backpressure bubble worth a
                # span; the no-wait fast path stays unrecorded
                self.rec.record(entry["trace"], "lane_admit", t_a,
                                time.perf_counter(), track="batcher",
                                parent=entry.get("root_span", 0))
        if sub == n_subs - 1:
            if sup is not None:
                # one healthy window resets the stage breakers'
                # consecutive-fault counters
                sup.note_ok("dispatch")
                sup.note_ok("materialize")
            # the cost is counted per WINDOW, over all of its messages —
            # sampling per entry would count the near-instant later subs
            # of a window as whole batches and drag the EWMA to ~zero (the
            # chooser then never bypasses a slow device). It is the
            # window's own cost (see the module docstring): taken when
            # the handle releases, after the lanes delivered its plans.
            def sample() -> None:
                self._device_sample(handle.cost_s, handle.n_msgs)

            if handle.built is not None:    # the lanes hold the handle
                handle.on_release = sample
            else:
                sample()
            # slow-start growth: this window completed, widen the next
            self._fuse_cwnd = min(8, max(2, 2 * n_subs))
        return counts

    def _device_sample(self, cost_s: float, n_msgs: int) -> None:
        """Feed one device window's cost to the chooser.

        The estimate is seeded by the median of the first _DEV_SEED
        windows' costs per message (until then the chooser keeps the
        device, as with no estimate): the first serving dispatch after a
        warm-up can stall for tens of milliseconds (PERF.md, Findings;
        its cause is not known), and alone it would set the estimate
        before the outlier guard of _ewma has a baseline.

        After that, windows are pooled until they span max_batch
        messages, and the pool's cost per message is one sample. A
        window's fixed cost weighs on each of its messages in inverse
        proportion to its size: with the columnar ingress's bursts, full
        windows alternate with windows of a few dozen messages that cost
        two to three times as much per message, and sampled one each
        they pushed the estimate past the bypass margin for a whole flood
        (the device is re-tried only after _PROBE_EVERY host batches,
        and a flood of bursts has fewer). Pooled, each sample is the
        cost of the messages routed."""
        n_msgs = max(1, n_msgs)
        self.window_costs.append((n_msgs, cost_s))
        if self._dev_msg_s is None:
            s = cost_s / n_msgs
            self.cost_samples["device"].append(s)
            self._dev_seed.append(s)
            if len(self._dev_seed) >= _DEV_SEED:
                self._dev_msg_s = sorted(self._dev_seed)[len(
                    self._dev_seed) // 2]
                self._dev_seed = []
            return
        cost, n = self._dev_pending
        cost, n = cost + cost_s, n + n_msgs
        if n < self.max_batch:
            self._dev_pending = (cost, n)
            return
        self._dev_pending = (0.0, 0)
        s = cost / n
        self.cost_samples["device"].append(s)
        self._dev_msg_s, self._dev_spike = _ewma(
            self._dev_msg_s, s, self._dev_spike)

    def lat_percentiles(self) -> Optional[dict]:
        """PUBLISH→route latency percentiles (ms) over the reservoir."""
        if not self.route_lat:
            return None
        s = sorted(self.route_lat)
        return {
            "p50_ms": round(s[len(s) // 2] * 1000, 3),
            "p99_ms": round(
                s[min(len(s) - 1, int(len(s) * 0.99))] * 1000, 3),
            "samples": len(s),
        }

    def _device_worth_it(self) -> bool:
        """Measured-cost routing choice with active probes BOTH ways: the
        device is re-tried every _PROBE_EVERY host batches, and the host is
        re-sampled every host_probe_every device batches (otherwise the host
        estimate starves under steady device load and the bypass can never
        engage). The decision runs on the FIRST batch of a prospective
        window before any fusion. The reference set the device's cost per
        batch against n host messages; both estimates here are per
        message (each message's consume dominates a window's cost), with
        the margin above."""
        if self._dev_msg_s is None:
            return True      # optimistic: measure the device first
        if self._host_msg_s is None \
                or self._since_host_probe >= self.host_probe_every:
            # active host probe: route this one host-side to seed/refresh
            # the estimate (costs one batch at host speed). Counters reset
            # at DECISION time — resetting at consume time would turn one
            # scheduled probe into a pipeline_depth-long probe burst.
            self._since_host_probe = 0
            return False
        if self._since_probe >= _PROBE_EVERY:
            self._since_probe = 0
            return True
        if self._dev_msg_s <= _BYPASS_MARGIN * self._host_msg_s:
            return True
        self.node.metrics.inc("routing.device.bypassed")
        self._fuse_cwnd = 1      # re-enter fusion carefully next time
        return False


def _ewma(cur: Optional[float], sample: float, streak: int = 0,
          alpha: float = 0.2) -> tuple[Optional[float], int]:
    """Cost estimate: pessimize fast — but not on ONE bad sample. A first
    sample >3x the estimate is DISCARDED (estimate unchanged) and arms the
    outlier streak; a second consecutive >3x sample — still measured
    against the same un-drifted baseline — is a sustained slowdown and is
    adopted outright. A lone spike (GC pause) can no longer rewrite a
    path's cost and misroute traffic for up to _PROBE_EVERY batches; a real
    3x+ slowdown is adopted on its second window. A wrongly-pessimized
    estimate still self-corrects: the active probes re-measure both paths
    on a bounded cadence.
    Returns (estimate, outlier_streak)."""
    if cur is None:
        return sample, 0
    if sample > 3 * cur:
        if streak >= 1:
            return sample, streak + 1
        return cur, 1
    return (1 - alpha) * cur + alpha * sample, 0
