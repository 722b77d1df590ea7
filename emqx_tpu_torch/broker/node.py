"""Broker node: the composition root of the port's serving path.

A counterpart of ``emqx_tpu/broker/node.py`` (:26-330, :386-464): the
logger (``log``), hooks, metrics, stats, the pipeline telemetry (always),
the flight recorder, fault-domain supervision, the HBM ledger, the latency
observatory, the overload governor, the session-affine delivery lanes and
the columnar PUBLISH ingress (each on by default), router, broker,
connection manager, the banned table, alarms, the OS monitor
(``sysmon.os``), the device route engine and the publish batcher, wired
as the reference wires them for a single-chip node, and the housekeeping
tick (``sweep``, ``start_timers``). Under ``broker.multichip`` with
``enable`` true the node serves through the dp×route mesh instead
(``parallel/serving.ShardedRouteServer``, reference :206-236) behind a
batcher of the mesh's ``max_batch``: sub-keys ``devices`` (8 shards),
``dp`` (1) and ``max_batch`` (256), all on the node's device, with
``device_exchange`` (on) read under ``broker.``. With ``device_route:
false`` the node is the reference's host-only node: no engine and no
batcher, no recorder, supervisor, HBM ledger or delivery lanes (the
observatory and the governor stay), and every PUBLISH routes on the
host trie through ``broker.publish_async``; it still resolves its device
but allocates nothing there.

``Node.from_config_file(path)`` boots from an ``etc/emqx.conf``-style
HOCON file (``Config.load_file``, with the ``emqx_override.conf`` beside
it on top) and ``start_listeners`` starts every listener under ``listeners``:
``tcp`` and ``ssl`` (``broker/connection.Listener``), ``ws`` and ``wss``
(``broker/ws.WsListener``) and ``quic`` (``quic.QuicListener``); a TLS
type needs its ``ssl`` block, ``quic`` its ``ssl.certfile`` and
``ssl.keyfile``.
``start_apps`` boots the feature apps the file declares
(``apps/boot.start_apps``: the retainer and delayed publish, on by
default, rewrite, topic metrics, event messages and flapping detection)
and ``start_dashboard`` the ``/api/v5`` REST surface with the web UI
(``dashboard.listeners.http``); ``sweep`` ticks every registered app
after the governor's poll. ``start_gateways`` boots each enabled block
of the ``gateway`` section (``gateway/registry.GatewayRegistry``: stomp,
mqttsn, coap, lwm2m, and exproto where ``grpc`` imports) and
``stop_listeners`` stops them with the listeners.

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
``start_timers`` runs the housekeeping tick or a caller sweeps), the
readback ``compact_readback`` (on; off reads every window's dense planes
back, on either engine) and ``device_route`` (on); under ``alarm.``,
``size_limit`` (1000) and ``validity_period`` (86400).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from emqx_tpu_torch.broker.alarm import AlarmManager
from emqx_tpu_torch.broker.banned import Banned
from emqx_tpu_torch.broker.batcher import (PublishBatcher,
                                           resolve_dispatch_depth)
from emqx_tpu_torch.broker.cm import ConnectionManager
from emqx_tpu_torch.broker.config import Config
from emqx_tpu_torch.broker.connection import (Listener,
                                              resolve_columnar_ingress,
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
from emqx_tpu_torch.broker.monitor import OsMon
from emqx_tpu_torch.broker.overload import OverloadGovernor, resolve_overload
from emqx_tpu_torch.broker.pubsub import Broker
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.supervise import (PipelineSupervisor,
                                             guard_task, resolve_supervise)
from emqx_tpu_torch.broker.telemetry import PipelineTelemetry
from emqx_tpu_torch.broker.trace import FlightRecorder, resolve_trace
from emqx_tpu_torch.broker.ws import WsListener
from emqx_tpu_torch.device import resolve_device
from emqx_tpu_torch.utils.logger import setup_from_config


class Node:
    """``device=None`` serves on ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain PyTorch path on the host."""

    def __init__(self, config: Optional[dict] = None, *, device=None,
                 name: str = "emqx_tpu_torch@127.0.0.1"):
        self.name = name
        self.config = config if hasattr(config, "get_zone") \
            else Config(config)
        setup_from_config(self.config.get("log") or {})
        self.device = resolve_device(device)
        self.hooks = Hooks()
        self.metrics = Metrics()
        self.stats = Stats()
        perf = self.config.get("broker") or {}
        use_device = bool(perf.get("device_route", True))
        mc = perf.get("multichip") or {}
        # the layers of the device pipeline; the host-only node builds
        # none of them
        device_path = use_device or bool(mc.get("enable"))
        slow_ms = perf.get("slow_batch_threshold_ms", 250)
        self.pipeline_telemetry = PipelineTelemetry(
            self.metrics, hooks=self.hooks,
            slow_batch_s=(slow_ms / 1000.0) if slow_ms else None)
        # the window-causal flight recorder: trace ids minted at batcher
        # admit ride the pipeline (dispatch/materialize/lanes/settle) into
        # a bounded span ring. Off: no recorder anywhere
        self.flight_recorder = None
        if resolve_trace(perf.get("trace")) and device_path:
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
        if resolve_supervise(perf.get("supervise")) and device_path:
            self.supervisor = PipelineSupervisor(
                self.metrics, telemetry=self.pipeline_telemetry,
                threshold=perf.get("supervise_threshold"))
            self.pipeline_telemetry.supervise_state_fn = \
                self.supervisor.state
            self.supervisor.recorder = self.flight_recorder
        # per-category accounting of the engine's persistent device
        # allocations and the stale-pin sentinel
        self.hbm_ledger = None
        if resolve_hbm_ledger(perf.get("hbm_ledger")) and device_path:
            self.hbm_ledger = HbmLedger(
                self.metrics, device=self.device,
                pin_warn_windows=perf.get("pin_warn_windows"),
                hooks=self.hooks, recorder=self.flight_recorder)
            self.pipeline_telemetry.ledger = self.hbm_ledger
            self.stats.register_stats_fun(self.hbm_ledger.stats_fun)
        # the end-to-end latency observatory: per-message ingress→routed
        # and ingress→delivered percentiles by (qos, path), the SLO burn
        # and breach exemplars, from the frame-decode stamp. Off: no
        # observatory anywhere (the stamp itself stays on). Not gated on
        # the device path: the host-only node measures the same legs
        self.latency_observatory = None
        if resolve_latency_observatory(perf.get("latency_observatory")):
            self.latency_observatory = LatencyObservatory(
                self.metrics, hooks=self.hooks,
                recorder=self.flight_recorder,
                objective_ms=perf.get("slo_route_p99_ms"))
            self.pipeline_telemetry.observatory = self.latency_observatory
        # the overload governor: the graded load-shed ladder, polled on
        # the housekeeping tick (sweep). Off: no governor anywhere. Not
        # gated on the device path: a host-only node overloads the same
        # way
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
            use_device=use_device, device=self.device,
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
        if n_lanes > 0 and device_path:
            self.deliver_lanes = DeliveryLanePool(
                self.broker, self.metrics, hooks=self.hooks,
                telemetry=self.pipeline_telemetry, n_lanes=n_lanes,
                depth=perf.get("deliver_lane_depth", 8),
                supervisor=self.supervisor)
            self.pipeline_telemetry.deliver_state_fn = \
                self.deliver_lanes.state
            self.stats.register_stats_fun(self.deliver_lanes.stats_fun)
        self.device_engine = None
        self.publish_batcher = None
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
                compact_readback=perf.get("compact_readback"),
                delta_overlay=perf.get("delta_overlay"),
                dispatch_depth=dispatch_depth,
                device_exchange=perf.get("device_exchange"),
                subscription_covering=perf.get("subscription_covering"))
            max_batch = mc.get("max_batch", 256)
        elif use_device:
            self.device_engine = DeviceRouteEngine(
                self, device=self.device,
                rebuild_threshold=rebuild_threshold,
                fanout_cap=perf.get("device_fanout_cap", 128),
                slot_cap=perf.get("device_slot_cap", 16),
                match_cache_size=perf.get("match_cache_size"),
                dedup=perf.get("topic_dedup"),
                compact_readback=perf.get("compact_readback"),
                delta_overlay=perf.get("delta_overlay"),
                subscription_covering=perf.get("subscription_covering"))
            max_batch = perf.get("max_publish_batch", 1024)
        if self.device_engine is not None:
            self.publish_batcher = PublishBatcher(
                self, self.device_engine,
                window_us=perf.get("batch_window_us", 200),
                max_batch=max_batch,
                device_min_batch=perf.get("device_min_batch", 4),
                dispatch_depth=dispatch_depth)
        self.cm = ConnectionManager()
        self.cm.broker = self.broker
        self.banned = Banned()
        aconf = self.config.get("alarm") or {}
        self.alarms = AlarmManager(
            self.hooks, size_limit=aconf.get("size_limit", 1000),
            validity_period=aconf.get("validity_period", 86400))
        self.os_mon = OsMon(self.alarms,
                            self.config.get("sysmon", "os") or {})
        self.stats.register_stats_fun(self.broker.stats_fun)
        self.stats.register_stats_fun(self.cm.stats_fun)
        self.listeners: list = []
        self._timer_task: Optional[asyncio.Task] = None
        self._apps: list = []
        self.dashboard_server = None

    # ---- config-file boot (emqx_machine_app load_config_files +
    #      emqx_listeners:start; node.py:283-330) ----
    @classmethod
    def from_config_file(cls, path: str, **kw) -> "Node":
        """Boot from a HOCON file with the runtime overrides persisted
        beside it (``emqx_override.conf``) on top."""
        return cls(Config.load_file(path), **kw)

    async def start_listeners(self) -> list:
        """Start every listener configured under `listeners`
        (emqx_listeners.erl:91,126-138: tcp/ssl esockd, ws/wss cowboy)."""
        for name, lc in (self.config.get("listeners") or {}).items():
            if not lc.get("enabled", True):
                continue
            ltype = lc.get("type", "tcp")
            ssl_opts = lc.get("ssl") \
                if ltype in ("ssl", "wss") or "ssl" in lc else None
            if ltype in ("ssl", "wss") and not ssl_opts:
                # never silently downgrade a TLS listener to plaintext
                raise ValueError(
                    f"listener {name!r} is type {ltype} but has no ssl "
                    f"block")
            common = dict(bind=lc.get("bind", "0.0.0.0"),
                          port=int(lc.get("port", 0)),
                          zone=lc.get("zone"),
                          max_connections=int(
                              lc.get("max_connections", 1024000)),
                          ssl_opts=ssl_opts)
            if ltype in ("ws", "wss"):
                lst = WsListener(self, path=lc.get("path", "/mqtt"),
                                 **common)
            elif ltype in ("tcp", "ssl"):
                lst = Listener(self, name=f"{ltype}:{name}", **common)
            elif ltype == "quic":
                from emqx_tpu_torch.quic import QuicListener
                ssl_opts = lc.get("ssl") or {}
                if not ssl_opts.get("certfile") or \
                        not ssl_opts.get("keyfile"):
                    raise ValueError(
                        f"quic listener {name!r} needs ssl.certfile and "
                        f"ssl.keyfile")
                common.pop("ssl_opts", None)
                lst = QuicListener(self, certfile=ssl_opts["certfile"],
                                   keyfile=ssl_opts["keyfile"], **common)
            else:
                raise ValueError(f"unknown listener type {ltype!r}")
            await lst.start()
            self.listeners.append(lst)
        return self.listeners

    async def start_dashboard(self):
        """Boot the management REST API and the web dashboard from the
        ``dashboard`` section (the reference's emqx_dashboard http
        listener, default port 18083). Opt-in: nothing without the
        section, and ``dashboard.enable = false`` turns it off. The
        ``/api/v5`` surface and the single-file UI share one server;
        everything but the UI page and ``/api/v5/login`` sits behind the
        admin's token or basic auth."""
        dc = self.config.get("dashboard") or {}
        if not dc or dc.get("enable") is False:
            return None
        from emqx_tpu_torch.apps.dashboard import DashboardAdmin, register_api
        from emqx_tpu_torch.mgmt import Mgmt, make_api
        lc = (dc.get("listeners") or {}).get("http") or {}
        admin = DashboardAdmin(self)
        cluster = getattr(self.broker, "cluster", None)
        mgmt = Mgmt(self, cluster)
        srv = make_api(self, mgmt, cluster=cluster,
                       host=str(lc.get("bind", "127.0.0.1")),
                       port=int(lc.get("port", 18083)))
        srv.auth_check = admin.auth_check
        register_api(srv, self, admin, mgmt)
        await srv.start()
        self.dashboard_server = srv
        return srv

    async def start_apps(self) -> list:
        """Boot every feature app the config declares (see
        ``apps/boot.py``)."""
        from emqx_tpu_torch.apps.boot import start_apps
        return await start_apps(self)

    async def start_gateways(self) -> list:
        """Boot protocol gateways from the ``gateway`` config section
        (emqx_gateway.erl loads gateway.stomp/mqttsn/coap/lwm2m/exproto
        blocks the same way). Each block: enable (default true) + the
        gateway's own options (bind/port/...)."""
        from emqx_tpu_torch.gateway.registry import GatewayRegistry
        reg = getattr(self, "gateway_registry", None)
        if reg is None:
            reg = GatewayRegistry.with_builtins(self)
        started = []
        for name, conf in (self.config.get("gateway") or {}).items():
            if not isinstance(conf, dict) or conf.get("enable") is False:
                continue
            started.append(await reg.load(name, conf))
        return started

    async def stop_gateways(self) -> None:
        reg = getattr(self, "gateway_registry", None)
        if reg is not None:
            for name in list(reg._instances):
                await reg.unload(name)

    async def stop_listeners(self) -> None:
        for lst in self.listeners:
            await lst.stop()
        self.listeners.clear()
        await self.stop_gateways()
        if self.dashboard_server is not None:
            await self.dashboard_server.stop()
            self.dashboard_server = None
        # resources created by the config boot (DB-backed authn/authz):
        # close their pools + health loop or their sockets outlive the node
        mgr = getattr(self, "resources", None)
        if mgr is not None:
            mgr.stop_health_checks()
            for rid in list(mgr.instances):
                await mgr.remove(rid)

    # ---- periodic housekeeping (node.py:403-440) ----
    def sweep(self) -> None:
        """One housekeeping pass: session expiry, ban expiry, alarm
        history, the OS watermarks, the overload governor's poll, the
        stats sample, then every app's tick (after the poll: the
        retainer's drain of deferred replays sees the flags of a
        recovery on the same pass). Callable directly (the tests and a
        CPU drive poll the governor this way)."""
        self.cm.sweep_expired_sessions()
        self.banned.tick()
        self.alarms.tick()
        self.os_mon.tick()
        if self.overload_governor is not None:
            self.overload_governor.poll()
        self.stats.sample()
        for app in self._apps:
            tick = getattr(app, "tick", None)
            if tick is not None:
                tick()

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
        pipeline when there is one, else the host per-message path."""
        if self.publish_batcher is not None:
            return await self.publish_batcher.submit(msg)
        return await self.broker.publish_async(msg)

    def publish_future(self, msg: Message) -> asyncio.Future:
        """Queue a PUBLISH into the batch window without awaiting it; the
        future resolves to its delivery count (the channel's QoS 1/2
        path, which acks in receive order once counts resolve). Without a
        batcher the host path starts at once (an eager task): it routes
        before the caller's next PUBLISH unless a message.publish hook
        suspends."""
        if self.publish_batcher is not None:
            return self.publish_batcher.submit_future(msg)
        return asyncio.Task(self.broker.publish_async(msg),
                            loop=asyncio.get_running_loop(),
                            eager_start=True)

    def publish_nowait(self, msg: Message) -> bool:
        """Fire-and-forget PUBLISH (QoS0 path): pipelines into the batch
        window without serializing the caller's read loop. Returns False
        when not accepted (no batcher, or the backpressure bound is hit)
        — the caller must `await publish_async` instead, which both
        preserves per-publisher ordering and stalls an overloading read
        loop."""
        if self.publish_batcher is not None:
            return self.publish_batcher.enqueue(msg)
        return False

    # ---- feature apps (node.py:478-488) ----
    def register_app(self, app: Any) -> Any:
        """Attach a feature app (retainer, delayed, ...); ``sweep`` ticks
        it."""
        self._apps.append(app)
        return app

    def get_app(self, cls) -> Optional[Any]:
        for a in self._apps:
            if isinstance(a, cls):
                return a
        return None
