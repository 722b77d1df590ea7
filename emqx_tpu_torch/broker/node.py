"""Broker node: the composition root of the port's serving path.

A slim counterpart of ``emqx_tpu/broker/node.py`` (:43-48, :77-190,
:237-276, :403-440, :449-460): hooks, metrics, stats, the pipeline
telemetry (always), the flight recorder, fault-domain supervision, the
HBM ledger, the latency observatory, the overload governor, the
session-affine delivery lanes and the columnar PUBLISH ingress (each on
by default), router, broker, connection manager, alarms, the device
route engine and the publish batcher, wired as the reference wires them
for a single-chip node, and the housekeeping tick (``sweep``,
``start_timers``) the governor polls on. Under ``broker.multichip`` with
``enable`` true the node serves through the dp×route mesh instead
(``parallel/serving.ShardedRouteServer``, reference :206-236) behind a
batcher of the mesh's ``max_batch``: sub-keys ``devices`` (8 shards),
``dp`` (1) and ``max_batch`` (256), all on the node's device, with
``device_exchange`` (on) read under ``broker.``. The layers the
reference also builds here (apps, gateways and the management API) are
not part of the port.

Config keys read under ``broker.``, with the reference's names and
defaults: ``batch_window_us`` (200), ``max_publish_batch`` (1024),
``device_min_batch`` (4), ``device_fanout_cap`` (128),
``device_slot_cap`` (16), ``shared_subscription_strategy``
("round_robin"), ``shared_dispatch_ack_enabled`` (false),
``dispatch_depth`` (2), ``rebuild_threshold`` (256), and the routing
layers ``topic_dedup`` (on), ``match_cache_size`` (8192),
``delta_overlay`` (on) and ``subscription_covering`` (on), passed to the
engine as the reference's ``Node`` passes them (:221-257);
``slow_batch_threshold_ms`` (250; 0 or null: no slow-batch watch),
``hbm_ledger`` (on) with ``pin_warn_windows`` (64), and
``deliver_lanes`` (``min(4, cpus)``; 0: inline delivery) with
``deliver_lane_depth`` (8), the columnar PUBLISH ingress
``columnar_ingress`` (on) with ``ingress_lanes`` (``min(4, cpus)``; 1 when
columnar ingress is off), the flight recorder ``trace`` (on) with
``trace_ring`` (4096) and ``trace_sample`` (256), supervision
``supervise`` (on) with ``supervise_threshold`` (3; the supervisor's
other tunables are ``PipelineSupervisor`` keyword arguments with the
reference's defaults), the latency observatory
``latency_observatory`` (on) with ``slo_route_p99_ms`` (2.0), and the
overload governor ``overload`` (on; polled by ``sweep``, so only once
``start_timers`` runs the housekeeping tick or a caller sweeps); and
under ``alarm.``, ``size_limit`` (1000) and ``validity_period`` (86400).
``compact_readback: false`` (the port's CSR readback is always on, on
either engine) and ``device_route: false`` (the host-only node is not
ported) raise ``ValueError`` rather than serving without them.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from emqx_tpu_torch.broker.alarm import AlarmManager
from emqx_tpu_torch.broker.batcher import (PublishBatcher,
                                           resolve_dispatch_depth)
from emqx_tpu_torch.broker.cm import ConnectionManager
from emqx_tpu_torch.broker.config import Config
from emqx_tpu_torch.broker.connection import (resolve_columnar_ingress,
                                              resolve_ingress_lanes)
from emqx_tpu_torch.broker.deliver import (DeliveryLanePool,
                                           resolve_deliver_lanes)
from emqx_tpu_torch.broker.device_engine import (DeviceRouteEngine,
                                                 resolve_rebuild_threshold)
from emqx_tpu_torch.broker.hbm_ledger import HbmLedger, resolve_hbm_ledger
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.latency import (LatencyObservatory,
                                           resolve_latency_observatory)
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.metrics import Metrics, Stats
from emqx_tpu_torch.broker.overload import OverloadGovernor, resolve_overload
from emqx_tpu_torch.broker.pubsub import Broker
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.supervise import (PipelineSupervisor,
                                             guard_task, resolve_supervise)
from emqx_tpu_torch.broker.telemetry import PipelineTelemetry
from emqx_tpu_torch.broker.trace import FlightRecorder, resolve_trace
from emqx_tpu_torch.device import resolve_device


def check_layers(perf: dict) -> None:
    """Raise ValueError when the ``broker`` config asks for a path the
    port does not implement: the dense readback (``compact_readback:
    false``, on the single-chip engine or the mesh) and the host-only
    node (``device_route: false``)."""
    for key in ("compact_readback", "device_route"):
        if perf.get(key) is not None and not perf.get(key):
            raise ValueError(f"emqx_tpu_torch does not implement broker "
                             f"{key}=false; leave it on")


class Node:
    """``device=None`` serves on ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain PyTorch path on the host."""

    def __init__(self, config: Optional[dict] = None, *, device=None,
                 name: str = "emqx_tpu_torch@127.0.0.1"):
        self.name = name
        self.config = config if hasattr(config, "get_zone") \
            else Config(config)
        self.device = resolve_device(device)
        self.hooks = Hooks()
        self.metrics = Metrics()
        self.stats = Stats()
        perf = self.config.get("broker") or {}
        check_layers(perf)
        slow_ms = perf.get("slow_batch_threshold_ms", 250)
        self.pipeline_telemetry = PipelineTelemetry(
            self.metrics, hooks=self.hooks,
            slow_batch_s=(slow_ms / 1000.0) if slow_ms else None)
        # the window-causal flight recorder: trace ids minted at batcher
        # admit ride the pipeline (dispatch/materialize/lanes/settle) into
        # a bounded span ring. Off: no recorder anywhere
        self.flight_recorder = None
        if resolve_trace(perf.get("trace")):
            self.flight_recorder = FlightRecorder(
                self.metrics, cap=perf.get("trace_ring", 4096),
                sample=perf.get("trace_sample"))
            self.pipeline_telemetry.recorder = self.flight_recorder
        # fault-domain supervision: fault injection points, per-stage
        # circuit breakers driving the degradation ladder (device + cache
        # + delta → device-plain → host trie), the window journal and the
        # stage watchdogs; its trips, rung changes and restarts land in
        # the flight recorder as node-scope events. Off: no supervisor
        # anywhere (the engine, batcher, lanes and governor read None)
        self.supervisor = None
        if resolve_supervise(perf.get("supervise")):
            self.supervisor = PipelineSupervisor(
                self.metrics, telemetry=self.pipeline_telemetry,
                threshold=perf.get("supervise_threshold"))
            self.pipeline_telemetry.supervise_state_fn = \
                self.supervisor.state
            self.supervisor.recorder = self.flight_recorder
        # per-category accounting of the engine's persistent device
        # allocations and the stale-pin sentinel
        self.hbm_ledger = None
        if resolve_hbm_ledger(perf.get("hbm_ledger")):
            self.hbm_ledger = HbmLedger(
                self.metrics, device=self.device,
                pin_warn_windows=perf.get("pin_warn_windows"),
                hooks=self.hooks, recorder=self.flight_recorder)
            self.pipeline_telemetry.ledger = self.hbm_ledger
            self.stats.register_stats_fun(self.hbm_ledger.stats_fun)
        # the end-to-end latency observatory: per-message ingress→routed
        # and ingress→delivered percentiles by (qos, path), the SLO burn
        # and breach exemplars, from the frame-decode stamp. Off: no
        # observatory anywhere (the stamp itself stays on)
        self.latency_observatory = None
        if resolve_latency_observatory(perf.get("latency_observatory")):
            self.latency_observatory = LatencyObservatory(
                self.metrics, hooks=self.hooks,
                recorder=self.flight_recorder,
                objective_ms=perf.get("slo_route_p99_ms"))
            self.pipeline_telemetry.observatory = self.latency_observatory
        # the overload governor: the graded load-shed ladder, polled on
        # the housekeeping tick (sweep). Off: no governor anywhere
        self.overload_governor = None
        if resolve_overload(perf.get("overload")):
            self.overload_governor = OverloadGovernor(
                self, self.metrics, hooks=self.hooks,
                recorder=self.flight_recorder)
            self.pipeline_telemetry.overload_state_fn = \
                self.overload_governor.state
        rebuild_threshold = resolve_rebuild_threshold(
            perf.get("rebuild_threshold"))
        dispatch_depth = resolve_dispatch_depth(perf.get("dispatch_depth"))
        # columnar PUBLISH ingress, one resolution for the whole layer:
        # the codec's burst decode, the channel's and the batcher's burst
        # hand-off and the acceptor lanes read these two attributes. Off
        # restores the per-packet ingress path and forces one lane
        self.columnar_ingress = resolve_columnar_ingress(
            perf.get("columnar_ingress"))
        self.ingress_lanes = resolve_ingress_lanes(
            perf.get("ingress_lanes")) if self.columnar_ingress else 1
        self.router = Router(
            use_device=True, device=self.device,
            rebuild_threshold=rebuild_threshold,
            device_min_batch=perf.get("device_min_batch", 4))
        self.broker = Broker(
            router=self.router, hooks=self.hooks, metrics=self.metrics,
            shared_strategy=perf.get("shared_subscription_strategy",
                                     "round_robin"),
            shared_dispatch_ack=perf.get("shared_dispatch_ack_enabled",
                                         False))
        self.broker.latency_obs = self.latency_observatory
        # the session-affine egress stage the engine's consume hands
        # delivery plans to; 0 lanes is the inline delivery loop
        self.deliver_lanes = None
        n_lanes = resolve_deliver_lanes(perf.get("deliver_lanes"))
        if n_lanes > 0:
            self.deliver_lanes = DeliveryLanePool(
                self.broker, self.metrics, hooks=self.hooks,
                telemetry=self.pipeline_telemetry, n_lanes=n_lanes,
                depth=perf.get("deliver_lane_depth", 8),
                supervisor=self.supervisor)
            self.pipeline_telemetry.deliver_state_fn = \
                self.deliver_lanes.state
            self.stats.register_stats_fun(self.deliver_lanes.stats_fun)
        mc = perf.get("multichip") or {}
        if mc.get("enable"):
            # the dp×route mesh serves instead of the single-chip
            # engine, behind the same batcher protocol
            from emqx_tpu_torch.parallel.serving import ShardedRouteServer
            self.device_engine = ShardedRouteServer(
                self, n_devices=mc.get("devices"), dp=mc.get("dp"),
                device=self.device,
                fanout_cap=perf.get("device_fanout_cap", 128),
                slot_cap=perf.get("device_slot_cap", 16),
                max_batch=mc.get("max_batch", 256),
                delta_overlay=perf.get("delta_overlay"),
                dispatch_depth=dispatch_depth,
                device_exchange=perf.get("device_exchange"),
                subscription_covering=perf.get("subscription_covering"))
            max_batch = mc.get("max_batch", 256)
        else:
            self.device_engine = DeviceRouteEngine(
                self, device=self.device,
                rebuild_threshold=rebuild_threshold,
                fanout_cap=perf.get("device_fanout_cap", 128),
                slot_cap=perf.get("device_slot_cap", 16),
                match_cache_size=perf.get("match_cache_size"),
                dedup=perf.get("topic_dedup"),
                delta_overlay=perf.get("delta_overlay"),
                subscription_covering=perf.get("subscription_covering"))
            max_batch = perf.get("max_publish_batch", 1024)
        self.publish_batcher = PublishBatcher(
            self, self.device_engine,
            window_us=perf.get("batch_window_us", 200),
            max_batch=max_batch,
            device_min_batch=perf.get("device_min_batch", 4),
            dispatch_depth=dispatch_depth)
        self.cm = ConnectionManager()
        self.cm.broker = self.broker
        aconf = self.config.get("alarm") or {}
        self.alarms = AlarmManager(
            self.hooks, size_limit=aconf.get("size_limit", 1000),
            validity_period=aconf.get("validity_period", 86400))
        self.stats.register_stats_fun(self.broker.stats_fun)
        self.stats.register_stats_fun(self.cm.stats_fun)
        self._timer_task: Optional[asyncio.Task] = None

    # ---- periodic housekeeping (node.py:403-440) ----
    def sweep(self) -> None:
        """One housekeeping pass: session expiry, alarm history, the
        overload governor's poll, the stats sample. Callable directly
        (the tests and a CPU drive poll the governor this way)."""
        self.cm.sweep_expired_sessions()
        self.alarms.tick()
        if self.overload_governor is not None:
            self.overload_governor.poll()
        self.stats.sample()

    async def _housekeeping(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.sweep()

    def start_timers(self, interval: float = 1.0) -> None:
        """Run ``sweep`` every `interval` seconds on the running loop. The
        governor learns the interval: its loop-lag probe measures the
        tick's drift against it."""
        if self._timer_task is None:
            if self.overload_governor is not None:
                self.overload_governor.poll_interval_s = interval
            self._timer_task = guard_task(
                asyncio.ensure_future(self._housekeeping(interval)),
                "node-housekeeping", self.metrics)

    def stop_timers(self) -> None:
        if self._timer_task is not None:
            self._timer_task.cancel()
            self._timer_task = None

    # ---- the PUBLISH entries the channel calls (node.py:449-460) ----
    async def publish_async(self, msg: Message) -> int:
        """The channel PUBLISH entry: batched through the device route
        pipeline."""
        return await self.publish_batcher.submit(msg)

    def publish_future(self, msg: Message) -> asyncio.Future:
        """Queue a PUBLISH into the batch window without awaiting it; the
        future resolves to its delivery count (the channel's QoS 1/2
        path, which acks in receive order once counts resolve)."""
        return self.publish_batcher.submit_future(msg)

    def publish_nowait(self, msg: Message) -> bool:
        """Fire-and-forget PUBLISH (QoS0 path): pipelines into the batch
        window without serializing the caller's read loop. Returns False
        when the backpressure bound is hit — the caller must `await
        publish_async` instead, which both preserves per-publisher
        ordering and stalls an overloading read loop."""
        return self.publish_batcher.enqueue(msg)
