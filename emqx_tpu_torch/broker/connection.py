"""Per-client connection task + config-driven listeners.

Parity: emqx_connection.erl (per-client recvloop with {active,N}-style
read batching :318-345,404-516, keepalive + idle timeout, force-shutdown
policy) and emqx_listeners.erl (listener lifecycle :126-138). One asyncio
task per socket replaces the reference's per-connection BEAM process; the
read loop drains whatever bytes are available and feeds the streaming frame
parser, so a burst of packets is handled as one batch (the P10 batching
window).

The port's copy of ``emqx_tpu/broker/connection.py``, with the columnar
PUBLISH ingress (``broker.columnar_ingress``, on by default): a read's
PUBLISH runs decode as ``PublishBurst`` rows (``FrameParser.feed_columnar``)
and enter the channel's burst hand-off, everything else stays per packet,
in order; and the SO_REUSEPORT acceptor lanes (``broker.ingress_lanes``).
Off, the read loop is the per-packet path: ``parser.feed``, one
``handle_in`` per packet and one accept loop. The overload governor's
hooks: each connection registers with it (``register_conn``) and ranks
for its top-offender disconnect by limiter debt or, without a rate
limit, by its recent PUBLISH rows (``shed_score``), and the extra
acceptor lanes stop accepting while it pauses connects. A TLS listener
(``ssl_opts``, the listener's emqx-style ``ssl`` block through
``utils/tls.make_server_context``) keeps one accept loop, as the
reference's does, and hands the client certificate to the channel
(``peercert``); each connection checks its ``conn_congestion`` alarm
(``broker/congestion.py``) on its timer tick.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import time
from typing import Optional

from emqx_tpu_torch.broker.channel import Channel, ProtocolError
from emqx_tpu_torch.broker.congestion import Congestion
from emqx_tpu_torch.broker.limiter import (ConnectionLimiter,
                                           ForceShutdownPolicy, TokenBucket)
from emqx_tpu_torch.broker.supervise import guard_task
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import (FrameError, FrameParser,
                                       PublishBurst, serialize)
from emqx_tpu_torch.utils.logger import set_metadata_peername
from emqx_tpu_torch.utils.tls import make_server_context, peer_cert_info

log = logging.getLogger("emqx_tpu_torch.connection")

READ_CHUNK = 65536


def resolve_columnar_ingress(configured=None) -> bool:
    """``broker.columnar_ingress``, default on. Off restores the
    per-packet ingress path exactly: parser.feed, one handle_in per
    packet, one accept loop, no ``ingress`` telemetry section."""
    return True if configured is None else bool(configured)


def resolve_ingress_lanes(configured=None) -> int:
    """``broker.ingress_lanes``: SO_REUSEPORT acceptor lanes per TCP
    listener, default min(4, cpus). 1 is the single accept loop. Must be
    a positive integer; anything else is a deployment error worth failing
    loudly on."""
    if configured is None:
        return min(4, os.cpu_count() or 1)
    try:
        val = int(configured)
    except (TypeError, ValueError):
        raise ValueError(f"ingress_lanes={configured!r} is not an integer")
    if val < 1:
        raise ValueError(f"ingress_lanes must be >= 1, got {val}")
    return val


class Connection:
    def __init__(self, node, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, zone: Optional[str] = None):
        self.node = node
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername") or ("?", 0)
        sock = writer.get_extra_info("sockname") or ("?", 0)
        peercert = peer_cert_info(writer)
        self.parser = FrameParser(
            max_size=node.config.mqtt(zone).get("max_packet_size"),
            strict=node.config.mqtt(zone).get("strict_mode", False))
        # columnar ingress, resolved once per node: off, this read loop
        # is the per-packet path (parser.feed + handle_in, no ingress
        # counters)
        self._columnar = bool(getattr(node, "columnar_ingress", False))
        self.channel = Channel(
            node, {"peername": peer, "sockname": sock, "zone": zone,
                   "peercert": peercert},
            send=self._send_packets, close=self._request_close)
        self.last_rx = time.monotonic()
        self._out: list[bytes] = []   # packets written this loop turn
        self._closing: Optional[str] = None
        self._timer_task: Optional[asyncio.Task] = None
        rl = node.config.get_zone(zone, "rate_limit") or {}
        self.limiter = ConnectionLimiter(
            rl.get("conn_messages_in") or None,
            rl.get("conn_bytes_in") or None)
        fs = node.config.get_zone(zone, "force_shutdown") or {}
        self.force_shutdown = ForceShutdownPolicy(
            fs.get("max_mqueue_len", 0), fs.get("max_awaiting_rel", 0))
        cc = node.config.get_zone(zone, "conn_congestion") or {}
        self.congestion = Congestion(
            node, self.channel, writer,
            enable_alarm=cc.get("enable_alarm", False),
            min_alarm_sustain_duration=cc.get(
                "min_alarm_sustain_duration", 60))
        # the overload governor: registered (weakly) so its critical-grade
        # top-offender shed can rank live connections by limiter debt;
        # shed_rows is the ingress-volume fallback score when no rate
        # limit is configured (decayed by the governor)
        self.shed_rows = 0.0
        gov = getattr(node, "overload_governor", None)
        if gov is not None:
            gov.register_conn(self)

    # ---- outbound ----
    def _send_packets(self, pkts: list[P.Packet]) -> None:
        """Serialize now, write once per event-loop turn: a window's
        deliveries to one connection leave in one socket write, in
        order, instead of one write (and one send) each."""
        if self.writer.is_closing():
            return
        data = b"".join(serialize(p, self.channel.proto_ver) for p in pkts)
        self.node.metrics.inc("bytes.sent", len(data))
        if not self._out:
            asyncio.get_running_loop().call_soon(self._flush)
        self._out.append(data)

    def _flush(self) -> None:
        if self._out:
            data = b"".join(self._out)
            self._out.clear()
            if not self.writer.is_closing():
                self.writer.write(data)

    def _request_close(self, reason: str) -> None:
        if self._closing is None:
            self._closing = reason
            if not self.writer.is_closing():
                self._flush()
                self.writer.close()

    # overload top-offender volume floor: without a configured rate
    # limit, a connection qualifies for the critical-grade disconnect only
    # when its DECAYED recent row count reads as a genuine flood — a
    # subscriber's ack stream or a moderate publisher must never rank
    _SHED_VOLUME_FLOOR = 1000.0

    # ---- overload shed (force_shutdown parity) ----
    def shed_score(self) -> float:
        """How much this connection over-drives ingress: limiter debt
        (seconds-to-repay) when a rate limit is configured — the primary
        ranking, offset so ANY debt outranks plain volume — else the
        decayed recent-rows count, floored so only a genuine flooder
        qualifies. 0.0 = not a shed candidate."""
        debt = self.limiter.debt()
        if debt > 0:
            return 1e6 + debt
        if self.shed_rows >= self._SHED_VOLUME_FLOOR:
            return self.shed_rows
        return 0.0

    def overload_disconnect(self) -> None:
        """The governor's critical-grade disconnect: v5 clients get a
        DISCONNECT with reason 0x97 (quota exceeded), everyone gets the
        close — the force_shutdown lifecycle, so the session parks or
        terminates per its expiry config."""
        self.node.metrics.inc("connection.force_shutdown")
        if self.channel.proto_ver == C.MQTT_V5 \
                and self.channel.conn_state == "connected":
            self._send_packets([P.Disconnect(
                reason_code=C.RC_QUOTA_EXCEEDED)])
        self._request_close("overload_shed")

    # ---- main loop (emqx_connection:recvloop) ----
    async def run(self) -> None:
        peer = self.channel.conninfo.get("peername")
        if peer:
            set_metadata_peername(f"{peer[0]}:{peer[1]}")
        self._timer_task = guard_task(
            asyncio.ensure_future(self._timers()), "conn-timers",
            self.node.metrics)
        reason = "closed"
        try:
            idle_timeout = self.node.config.mqtt(
                self.channel.zone).get("idle_timeout", 15)
            while self._closing is None:
                timeout = (idle_timeout
                           if self.channel.conn_state == "idle" else None)
                try:
                    data = await asyncio.wait_for(
                        self.reader.read(READ_CHUNK), timeout)
                except asyncio.TimeoutError:
                    reason = "idle_timeout"
                    break
                if not data:
                    reason = "closed"
                    break
                self.last_rx = time.monotonic()
                m = self.node.metrics
                m.inc("bytes.received", len(data))
                columnar = self._columnar
                try:
                    if columnar:
                        # PUBLISH runs decode as PublishBurst items;
                        # everything else (and small reads) stays
                        # per-packet, in order
                        items = self.parser.feed_columnar(data)
                    else:
                        items = self.parser.feed(data)
                except FrameError as e:
                    reason = f"frame_error:{e.code}"
                    self._frame_error_out(e)
                    break
                n_rows = n_pub = 0
                for it in items:
                    if type(it) is PublishBurst:
                        n_rows += len(it)
                        n_pub += len(it)
                    else:
                        n_rows += 1
                        n_pub += type(it) is P.Publish
                if columnar and items:
                    m.inc("pipeline.ingress.bytes", len(data))
                n_done = 0
                for item in items:
                    try:
                        if type(item) is PublishBurst:
                            m.inc("pipeline.ingress.bursts")
                            m.inc("pipeline.ingress.rows", len(item))
                            self.node.pipeline_telemetry \
                                .record_ingress_burst(len(item))
                            await self.channel.handle_publish_burst(item)
                            n_done += len(item)
                            continue
                        if columnar:
                            m.inc("pipeline.ingress.fallback_frames")
                        if type(item) is not P.Publish:
                            # acks owed for earlier PUBLISHes go first
                            await self.channel.flush_acks()
                        await self.channel.handle_in(item)
                    except ProtocolError as e:
                        reason = f"protocol_error:0x{e.rc:02x}"
                        self._protocol_error_out(e)
                        break
                    n_done += 1
                    if n_done % 64 == 0:
                        # one read can carry hundreds of frames; without
                        # a scheduling point the whole burst handles
                        # back-to-back and stalls every other task for
                        # tens of ms (handle_in's awaits don't yield
                        # unless they actually block)
                        await asyncio.sleep(0)
                if items:
                    # the offender score counts PUBLISH rows only: a
                    # subscriber's PUBACK stream (or SUBSCRIBE/PING
                    # chatter) must never rank it for the overload
                    # disconnect
                    self.shed_rows += n_pub
                    await self.channel.flush_acks()
                    await self._drain()
                    # ingress rate limit: a depleted bucket pauses reading
                    # (the {active,N}-off backpressure, emqx_connection
                    # ensure_rate_limit)
                    pause = self.limiter.check(n_rows, len(data))
                    if pause > 0:
                        self.node.metrics.inc("connection.rate_limited")
                        await asyncio.sleep(pause)
            reason = self._closing or reason
        except (ConnectionResetError, BrokenPipeError):
            reason = "closed"
        except asyncio.CancelledError:
            reason = "shutdown"
        except Exception:
            log.exception("connection crashed")
            reason = "internal_error"
        finally:
            if self._timer_task:
                self._timer_task.cancel()
            self.congestion.cancel()
            self.channel.terminate(self._closing or reason)
            self._flush()
            try:
                # graceful close first (flushes the DISCONNECT we may have
                # just written); a stuck peer that can never drain falls
                # into the timeout and gets hard-aborted
                if not self.writer.is_closing():
                    self.writer.close()
                await asyncio.wait_for(self.writer.wait_closed(), 5)
            except (asyncio.CancelledError, KeyboardInterrupt, SystemExit):
                try:
                    self.writer.transport.abort()
                except Exception:  # noqa: BLE001 — transport already gone
                    pass
                raise               # preserve the cancellation contract
            except Exception:       # TimeoutError, reset mid-flush, ...
                try:
                    self.writer.transport.abort()
                except Exception:  # noqa: BLE001 — transport already gone
                    pass

    def _frame_error_out(self, e: FrameError) -> None:
        if self.channel.proto_ver == C.MQTT_V5 and \
                self.channel.conn_state == "connected":
            self._send_packets([P.Disconnect(
                reason_code=C.RC_MALFORMED_PACKET)])

    def _protocol_error_out(self, e: ProtocolError) -> None:
        if self.channel.proto_ver == C.MQTT_V5 and \
                self.channel.conn_state == "connected":
            self._send_packets([P.Disconnect(reason_code=e.rc)])
        self._request_close(f"protocol_error_0x{e.rc:02x}")

    async def _drain(self) -> None:
        self._flush()
        try:
            await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            self._request_close("closed")

    # ---- keepalive + retry timers (emqx_channel timer table) ----
    async def _timers(self) -> None:
        backoff = self.node.config.mqtt(
            self.channel.zone).get("keepalive_backoff", 0.75)
        retry_iv = self.node.config.mqtt(
            self.channel.zone).get("retry_interval", 30)
        last_retry = time.monotonic()
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            self.congestion.check()
            ka = self.channel.keepalive
            if (ka and self.channel.conn_state == "connected"
                    and now - self.last_rx > ka * 2 * backoff):
                if self.channel.proto_ver == C.MQTT_V5:
                    self._send_packets([P.Disconnect(
                        reason_code=C.RC_KEEP_ALIVE_TIMEOUT)])
                self._request_close("keepalive_timeout")
                return
            if retry_iv and now - last_retry >= retry_iv:
                last_retry = now
                self.channel.retry_deliveries()
            why = self.force_shutdown.violated(self.channel.session)
            if why is not None:
                self.node.metrics.inc("connection.force_shutdown")
                self._request_close(f"force_shutdown:{why}")
                return


class Listener:
    """One TCP/TLS listener (emqx_listeners:start_listener/3; ssl opts per
    emqx_listeners.erl:126-129 + emqx_schema ssl block via utils.tls);
    with columnar ingress on, a plain TCP one takes ``node.ingress_lanes``
    SO_REUSEPORT sockets on one port."""

    def __init__(self, node, *, bind: str = "0.0.0.0", port: int = 1883,
                 zone: Optional[str] = None, max_connections: int = 1024000,
                 name: str = "tcp:default", ssl_opts: Optional[dict] = None):
        self.node = node
        self.bind = bind
        self.port = port
        self.zone = zone
        self.name = name
        self.ssl_opts = ssl_opts
        if ssl_opts and name == "tcp:default":
            self.name = "ssl:default"
        self.max_connections = max_connections
        self._server: Optional[asyncio.AbstractServer] = None
        self._lane_servers: list[asyncio.AbstractServer] = []
        self.lane_conns: list[int] = []    # live conns per accept lane
        self._conns: set[asyncio.Task] = set()
        self.current_conns = 0
        rate = (node.config.get_zone(zone, "rate_limit") or {}) \
            .get("max_conn_rate", 0)
        self._accept_bucket = TokenBucket(rate) if rate else None

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        if self.current_conns >= self.max_connections:
            writer.close()
            return
        if self._accept_bucket is not None \
                and self._accept_bucket.consume() > 0:
            # accept-rate limit: drop the connection (esockd max_conn_rate)
            self.node.metrics.inc("connection.accept_limited")
            writer.close()
            return
        self.current_conns += 1
        conn = Connection(self.node, reader, writer, self.zone)
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await conn.run()
        finally:
            self.current_conns -= 1
            self._conns.discard(task)

    def _ingress_lanes(self) -> int:
        """Acceptor lanes for this listener: N SO_REUSEPORT listening
        sockets on one port, each with its own accept loop, so the kernel
        spreads incoming connections. Only for plain IPv4 TCP with columnar
        ingress on; TLS and an IPv6 bind keep the single accept loop. All
        lanes run on one event loop: they spread accepts, they do not
        parallelize them."""
        if not getattr(self.node, "columnar_ingress", False):
            return 1
        if self.ssl_opts or ":" in self.bind \
                or not hasattr(socket, "SO_REUSEPORT"):
            return 1
        return getattr(self.node, "ingress_lanes", 1)

    async def start(self) -> None:
        ssl_ctx = make_server_context(self.ssl_opts) \
            if self.ssl_opts else None
        lanes = self._ingress_lanes()
        if lanes > 1:
            port = self.port
            self.lane_conns = [0] * lanes
            for i in range(lanes):
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEADDR, 1)
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
                    sock.bind((self.bind, port))
                except OSError:
                    sock.close()
                    if i == 0:
                        raise
                    break   # a partial lane set still serves
                if port == 0:   # ephemeral port: later lanes join it
                    port = sock.getsockname()[1]
                srv = await asyncio.start_server(
                    self._lane_handler(i), sock=sock)
                self._lane_servers.append(srv)
            self.port = port
            self._server = self._lane_servers[0]
            log.info("listener %s started on %s:%d (%d ingress lanes)",
                     self.name, self.bind, self.port,
                     len(self._lane_servers))
            return
        self._server = await asyncio.start_server(
            self._on_client, self.bind, self.port, ssl=ssl_ctx)
        if self.port == 0:   # ephemeral port for tests
            self.port = self._server.sockets[0].getsockname()[1]
        log.info("listener %s started on %s:%d", self.name, self.bind,
                 self.port)

    def _lane_handler(self, lane: int):
        async def _on_lane_client(reader, writer):
            gov = getattr(self.node, "overload_governor", None)
            if lane > 0 and gov is not None and gov.connects_paused:
                # the governor's pause_connects: the extra acceptor lanes
                # stop taking connections; lane 0 keeps accepting so the
                # CONNECT still gets its v5 0x97 CONNACK (the channel's
                # half of this action)
                gov.count_accept_paused()
                writer.close()
                return
            self.node.metrics.inc(f"pipeline.ingress.lane{lane}.accepted")
            self.lane_conns[lane] += 1
            try:
                await self._on_client(reader, writer)
            finally:
                self.lane_conns[lane] -= 1
        return _on_lane_client

    async def stop(self) -> None:
        # stop accepting first so no connection slips in during the cancel
        # window; then cancel handlers (py3.12 wait_closed blocks until
        # every handler coroutine finishes, so cancel before waiting)
        servers = self._lane_servers or \
            ([self._server] if self._server else [])
        for srv in servers:
            srv.close()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        for srv in servers:
            try:
                await asyncio.wait_for(srv.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass
        self._lane_servers = []
