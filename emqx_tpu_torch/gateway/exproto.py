"""exproto gateway: any external program implements a protocol over gRPC.

Parity: apps/emqx_gateway/src/exproto — the broker hosts a TCP/UDP listener
plus the `ConnectionAdapter` gRPC service (Send/Close/Authenticate/
StartTimer/Publish/Subscribe/Unsubscribe), and streams socket/message events
to the external `ConnectionHandler` service
(protos/exproto.proto:23-60). Messages are wire-compatible with the
reference's proto (emqx.exproto.v1 package).

grpc_tools isn't in this image, so service bindings are built directly on
grpc generic handlers + multi-callables over the protoc-generated messages.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Optional

import grpc

from emqx_tpu_torch.gateway.ctx import GatewayCtx
from emqx_tpu_torch.gateway.protos import exproto_pb2 as pb

log = logging.getLogger("emqx_tpu_torch.gateway.exproto")

_PKG = "/emqx.exproto.v1"

SUCCESS = 0
CONN_NOT_ALIVE = 2
PARAMS_MISSED = 3
PERMISSION_DENY = 5


class ExprotoConn:
    """One accepted socket; `conn` id is the handle the external program
    uses in every adapter call."""

    def __init__(self, gw: "ExprotoGateway", reader, writer):
        self.gw = gw
        self.conn = uuid.uuid4().hex
        self.reader, self.writer = reader, writer
        self.clientid = ""
        self.clientinfo: dict = {}
        self.authenticated = False
        self.sid: Optional[int] = None
        self.keepalive_timer: Optional[asyncio.TimerHandle] = None
        self.closed = False

    def deliver(self, topic_filter: str, msg) -> bool:
        self.gw.handler.received_messages(self.conn, [msg])
        return True

    async def run(self) -> None:
        peer = self.writer.get_extra_info("peername") or ("0.0.0.0", 0)
        sock = self.writer.get_extra_info("sockname") or ("0.0.0.0", 0)
        self.gw.handler.socket_created(self.conn, peer, sock)
        try:
            while True:
                data = await self.reader.read(4096)
                if not data:
                    break
                self.gw.handler.received_bytes(self.conn, data)
        except (ConnectionError, OSError):
            pass
        finally:
            self.close("closed")

    def close(self, reason: str) -> None:
        if self.closed:
            return
        self.closed = True
        if self.sid is not None:
            self.gw.ctx.unregister_subscriber(self.sid)
            self.sid = None
        if self.clientid:
            self.gw.ctx.unregister_channel(self.clientid, self)
        self.gw.conns.pop(self.conn, None)
        self.gw.handler.socket_closed(self.conn, reason)
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass


class _HandlerClient:
    """Streaming client to the external ConnectionHandler service. Each
    hookpoint is one long-lived client-stream (the reference keeps one
    stream per hookpoint per gRPC channel, emqx_exproto_gcli)."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address)
        self._queues: dict[str, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: list = []

    def start(self, loop) -> None:
        self._loop = loop
        for name, req_cls in [
                ("OnSocketCreated", pb.SocketCreatedRequest),
                ("OnSocketClosed", pb.SocketClosedRequest),
                ("OnReceivedBytes", pb.ReceivedBytesRequest),
                ("OnTimerTimeout", pb.TimerTimeoutRequest),
                ("OnReceivedMessages", pb.ReceivedMessagesRequest)]:
            q: asyncio.Queue = asyncio.Queue()
            self._queues[name] = q
            self._tasks.append(loop.create_task(
                self._pump(name, req_cls, q)))

    async def _pump(self, name: str, req_cls, q: asyncio.Queue) -> None:
        call = self.channel.stream_unary(
            f"{_PKG}.ConnectionHandler/{name}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=pb.EmptySuccess.FromString)
        loop = asyncio.get_running_loop()

        def gen():
            while True:
                fut = asyncio.run_coroutine_threadsafe(q.get(), loop)
                item = fut.result()
                if item is None:
                    return
                yield item

        try:
            await loop.run_in_executor(None, call, gen())
        except grpc.RpcError as e:
            log.warning("handler stream %s ended: %s", name, e)

    def _put(self, name: str, msg) -> None:
        q = self._queues.get(name)
        if q is not None:
            q.put_nowait(msg)

    def socket_created(self, conn: str, peer, sock) -> None:
        self._put("OnSocketCreated", pb.SocketCreatedRequest(
            conn=conn, conninfo=pb.ConnInfo(
                socktype=pb.TCP,
                peername=pb.Address(host=str(peer[0]), port=int(peer[1])),
                sockname=pb.Address(host=str(sock[0]),
                                    port=int(sock[1])))))

    def socket_closed(self, conn: str, reason: str) -> None:
        self._put("OnSocketClosed",
                  pb.SocketClosedRequest(conn=conn, reason=reason))

    def received_bytes(self, conn: str, data: bytes) -> None:
        self._put("OnReceivedBytes",
                  pb.ReceivedBytesRequest(conn=conn, bytes=data))

    def timer_timeout(self, conn: str) -> None:
        self._put("OnTimerTimeout",
                  pb.TimerTimeoutRequest(conn=conn, type=pb.KEEPALIVE))

    def received_messages(self, conn: str, msgs: list) -> None:
        self._put("OnReceivedMessages", pb.ReceivedMessagesRequest(
            conn=conn, messages=[pb.Message(
                id=str(m.id), qos=m.qos, topic=m.topic,
                payload=m.payload, timestamp=m.ts,
                **{"from": m.from_}) for m in msgs]))

    def stop(self) -> None:
        for q in self._queues.values():
            q.put_nowait(None)
        for t in self._tasks:
            t.cancel()
        self.channel.close()


class ExprotoGateway:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        self.conf = conf or {}
        self.ctx = GatewayCtx(node, "exproto")
        self.bind = self.conf.get("bind", "127.0.0.1")
        self.port = self.conf.get("port", 7993)
        self.adapter_port = self.conf.get("adapter_port", 9100)
        self.handler_address = self.conf.get("handler_address",
                                             "127.0.0.1:9001")
        self.conns: dict[str, ExprotoConn] = {}
        self.handler = _HandlerClient(self.handler_address)
        self._server: Optional[asyncio.AbstractServer] = None
        self._grpc_server = None
        self._loop = None

    # ---- lifecycle ----
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.handler.start(self._loop)
        self._grpc_server = grpc.server(
            __import__("concurrent.futures", fromlist=["x"])
            .ThreadPoolExecutor(max_workers=4))
        self._grpc_server.add_generic_rpc_handlers(
            (self._adapter_handler(),))
        self.adapter_port = self._grpc_server.add_insecure_port(
            f"{self.bind}:{self.adapter_port}")
        self._grpc_server.start()
        self._server = await asyncio.start_server(self._accept, self.bind,
                                                  self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer) -> None:
        conn = ExprotoConn(self, reader, writer)
        self.conns[conn.conn] = conn
        await conn.run()

    async def stop(self) -> None:
        for c in list(self.conns.values()):
            c.close("shutdown")
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass
        if self._grpc_server:
            self._grpc_server.stop(grace=0.2)
        self.handler.stop()

    def info(self) -> dict:
        return {"listener": f"tcp:{self.bind}:{self.port}",
                "adapter": f"grpc:{self.bind}:{self.adapter_port}",
                "current_connections": len(self.conns)}

    # ---- ConnectionAdapter service (threadpool grpc -> loop calls) ----
    def _adapter_handler(self):
        gw = self

        def unary(fn, req_cls):
            def handler(request, _context):
                fut = asyncio.run_coroutine_threadsafe(
                    fn(request), gw._loop)
                try:
                    return fut.result(timeout=10)
                except Exception as e:  # noqa: BLE001
                    log.exception("adapter call failed")
                    return pb.CodeResponse(code=pb.UNKNOWN,
                                           message=str(e))
            return grpc.unary_unary_rpc_method_handler(
                handler, request_deserializer=req_cls.FromString,
                response_serializer=pb.CodeResponse.SerializeToString)

        handlers = {
            "Send": unary(self._h_send, pb.SendBytesRequest),
            "Close": unary(self._h_close, pb.CloseSocketRequest),
            "Authenticate": unary(self._h_auth, pb.AuthenticateRequest),
            "StartTimer": unary(self._h_timer, pb.TimerRequest),
            "Publish": unary(self._h_publish, pb.PublishRequest),
            "Subscribe": unary(self._h_subscribe, pb.SubscribeRequest),
            "Unsubscribe": unary(self._h_unsubscribe,
                                 pb.UnsubscribeRequest),
        }
        return grpc.method_handlers_generic_handler(
            "emqx.exproto.v1.ConnectionAdapter", handlers)

    def _conn(self, conn_id: str) -> Optional[ExprotoConn]:
        return self.conns.get(conn_id)

    async def _h_send(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        c.writer.write(req.bytes)
        await c.writer.drain()
        return pb.CodeResponse(code=SUCCESS)

    async def _h_close(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        c.close("closed_by_handler")
        return pb.CodeResponse(code=SUCCESS)

    async def _h_auth(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        ci = req.clientinfo
        if not ci.clientid:
            return pb.CodeResponse(code=PARAMS_MISSED,
                                   message="clientid required")
        c.clientinfo = {"clientid": f"exproto:{ci.clientid}",
                        "username": ci.username or None,
                        "protocol": ci.proto_name or "exproto",
                        "peername": c.writer.get_extra_info("peername")}
        if not await self.ctx.authenticate(c.clientinfo, req.password):
            return pb.CodeResponse(code=PERMISSION_DENY)
        c.clientid = ci.clientid
        c.authenticated = True
        c.sid = self.ctx.register_subscriber(c, c.clientid)
        self.ctx.register_channel(c.clientid, c,
                                  {"proto": ci.proto_name})
        self.node.hooks.run("client.connected",
                            (c.clientinfo,
                             {"proto_name": ci.proto_name}))
        return pb.CodeResponse(code=SUCCESS)

    async def _h_timer(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        if c.keepalive_timer:
            c.keepalive_timer.cancel()
        if req.interval > 0:
            c.keepalive_timer = self._loop.call_later(
                req.interval, self.handler.timer_timeout, c.conn)
        return pb.CodeResponse(code=SUCCESS)

    async def _h_publish(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None or not c.authenticated:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        if not await self.ctx.authorize(c.clientinfo, "publish",
                                        req.topic):
            return pb.CodeResponse(code=PERMISSION_DENY)
        self.ctx.publish(c.clientid, req.topic, req.payload,
                         qos=min(req.qos, 2))
        return pb.CodeResponse(code=SUCCESS)

    async def _h_subscribe(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None or not c.authenticated:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        if not await self.ctx.authorize(c.clientinfo, "subscribe",
                                        req.topic):
            return pb.CodeResponse(code=PERMISSION_DENY)
        self.ctx.subscribe(c.sid, req.topic, {"qos": min(req.qos, 2)})
        return pb.CodeResponse(code=SUCCESS)

    async def _h_unsubscribe(self, req) -> pb.CodeResponse:
        c = self._conn(req.conn)
        if c is None or not c.authenticated:
            return pb.CodeResponse(code=CONN_NOT_ALIVE)
        self.ctx.unsubscribe(c.sid, req.topic)
        return pb.CodeResponse(code=SUCCESS)
