"""exhook: forward broker hookpoints to external gRPC HookProvider servers.

Parity: apps/emqx_exhook — emqx_exhook_server.erl (per-server gRPC channel,
OnProviderLoaded handshake announcing which hooks the provider wants,
request timeout + failed_action policy deny|ignore) and emqx_exhook_handler
(the 20 hookpoint bridges). ValuedResponse semantics: CONTINUE threads the
returned value to the next hook, IGNORE keeps the current one,
STOP_AND_RETURN halts the chain with the returned value — exactly the
run_fold contract of the hooks registry.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Optional

import grpc

from emqx_tpu_torch.apps.protos import exhook_pb2 as pb
from emqx_tpu_torch.broker.message import Message, base62_encode
from emqx_tpu_torch.version import __version__

log = logging.getLogger("emqx_tpu_torch.exhook")

_PKG = "/emqx.exhook.v1.HookProvider"

# hookpoint -> (rpc method, request class, valued?)
HOOK_METHODS = {
    "client.connect": ("OnClientConnect", pb.ClientConnectRequest, False),
    "client.connack": ("OnClientConnack", pb.ClientConnackRequest, False),
    "client.connected": ("OnClientConnected",
                         pb.ClientConnectedRequest, False),
    "client.disconnected": ("OnClientDisconnected",
                            pb.ClientDisconnectedRequest, False),
    "client.authenticate": ("OnClientAuthenticate",
                            pb.ClientAuthenticateRequest, True),
    "client.authorize": ("OnClientAuthorize",
                         pb.ClientAuthorizeRequest, True),
    "client.subscribe": ("OnClientSubscribe",
                         pb.ClientSubscribeRequest, False),
    "client.unsubscribe": ("OnClientUnsubscribe",
                           pb.ClientUnsubscribeRequest, False),
    "session.created": ("OnSessionCreated", pb.SessionCreatedRequest,
                        False),
    "session.subscribed": ("OnSessionSubscribed",
                           pb.SessionSubscribedRequest, False),
    "session.unsubscribed": ("OnSessionUnsubscribed",
                             pb.SessionUnsubscribedRequest, False),
    "session.resumed": ("OnSessionResumed", pb.SessionResumedRequest,
                        False),
    "session.discarded": ("OnSessionDiscarded",
                          pb.SessionDiscardedRequest, False),
    "session.takenover": ("OnSessionTakeovered",
                          pb.SessionTakeoveredRequest, False),
    "session.terminated": ("OnSessionTerminated",
                           pb.SessionTerminatedRequest, False),
    "message.publish": ("OnMessagePublish", pb.MessagePublishRequest,
                        True),
    "message.delivered": ("OnMessageDelivered",
                          pb.MessageDeliveredRequest, False),
    "message.dropped": ("OnMessageDropped", pb.MessageDroppedRequest,
                        False),
    "message.acked": ("OnMessageAcked", pb.MessageAckedRequest, False),
}


def _clientinfo(ci: Any, node: str) -> pb.ClientInfo:
    if isinstance(ci, str):
        ci = {"clientid": ci}
    ci = ci or {}
    peer = ci.get("peername")
    return pb.ClientInfo(
        node=node, clientid=ci.get("clientid") or "",
        username=ci.get("username") or "",
        peerhost=str(peer[0]) if isinstance(peer, tuple) else "",
        protocol=str(ci.get("protocol") or ci.get("proto_name") or "mqtt"),
        mountpoint=ci.get("mountpoint") or "",
        is_superuser=bool(ci.get("is_superuser")))


def _message(m: Message, node: str) -> pb.Message:
    return pb.Message(node=node, id=base62_encode(m.id), qos=m.qos,
                      topic=m.topic, payload=m.payload, timestamp=m.ts,
                      **{"from": m.from_})


class ExhookServer:
    """One configured gRPC provider (emqx_exhook_server.erl)."""

    def __init__(self, node, name: str, url: str, *,
                 timeout: float = 5.0, failed_action: str = "deny",
                 pool_size: int = 8):
        self.node = node
        self.name = name
        self.url = url.replace("http://", "").replace("grpc://", "")
        self.timeout = timeout
        self.failed_action = failed_action   # deny | ignore
        self.channel = grpc.insecure_channel(self.url)
        self.hooks_wanted: dict[str, list[str]] = {}
        self._registered: list[str] = []

    def _call_blocking(self, method: str, req, resp_cls):
        call = self.channel.unary_unary(
            f"{_PKG}/{method}",
            request_serializer=type(req).SerializeToString,
            response_deserializer=resp_cls.FromString)
        return call(req, timeout=self.timeout)

    async def _call(self, method: str, req, resp_cls):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self._call_blocking, method, req, resp_cls)

    # ---- lifecycle ----
    async def load(self) -> None:
        broker = pb.BrokerInfo(
            version=__version__, sysdescr="EMQX-TPU broker",
            uptime=int(time.time()),
            datetime=time.strftime("%Y-%m-%d %H:%M:%S"))
        resp = await self._call("OnProviderLoaded",
                                pb.ProviderLoadedRequest(broker=broker),
                                pb.LoadedResponse)
        self.hooks_wanted = {h.name: list(h.topics) for h in resp.hooks}
        for hookpoint in self.hooks_wanted:
            if hookpoint not in HOOK_METHODS:
                continue
            handler = self._make_handler(hookpoint)
            self.node.hooks.add(hookpoint, handler,
                                tag=f"exhook:{self.name}", priority=99)
            self._registered.append(hookpoint)

    async def unload(self) -> None:
        for hookpoint in self._registered:
            self.node.hooks.delete(hookpoint, f"exhook:{self.name}")
        self._registered = []
        try:
            await self._call("OnProviderUnloaded",
                             pb.ProviderUnloadedRequest(),
                             pb.EmptySuccess)
        except grpc.RpcError:
            pass
        self.channel.close()

    # ---- hook bridging ----
    def _make_handler(self, hookpoint: str):
        method, req_cls, valued = HOOK_METHODS[hookpoint]
        server = self

        if valued:
            # valued hooks run under awaited folds: authenticate/authorize
            # via the channel's run_fold_async, message.publish via
            # Broker.publish_async (sync Broker.publish skips them)
            async def ahandler(*args):
                req = server._build_request(hookpoint, req_cls, args)
                if req is None:
                    return None
                try:
                    resp = await server._call(method, req,
                                              pb.ValuedResponse)
                except grpc.RpcError as e:
                    log.warning("exhook %s %s failed: %s", server.name,
                                method, e)
                    if server.failed_action == "deny":
                        return server._deny_value(hookpoint, args)
                    return None
                return server._apply_valued(hookpoint, resp, args)
            return ahandler

        # non-valued hooks never block the hot path: fire-and-forget
        async def notify(args):
            req = server._build_request(hookpoint, req_cls, args)
            if req is None:
                return
            try:
                await server._call(method, req, pb.EmptySuccess)
            except grpc.RpcError as e:
                log.debug("exhook %s %s failed: %s", server.name,
                          method, e)

        def fire(*args):
            try:
                asyncio.get_running_loop()
                from emqx_tpu_torch.broker.supervise import spawn
                spawn(notify(args), "exhook-notify")
            except RuntimeError:
                # no loop (sync test context): deliver inline, blocking
                try:
                    req = server._build_request(hookpoint, req_cls, args)
                    if req is not None:
                        server._call_blocking(method, req, pb.EmptySuccess)
                except grpc.RpcError:
                    pass
            return None
        return fire

    def _build_request(self, hookpoint: str, req_cls, args: tuple):
        n = self.node.name
        topics = self.hooks_wanted.get(hookpoint) or []
        try:
            if hookpoint == "client.authenticate":
                (ci, acc) = args
                return pb.ClientAuthenticateRequest(
                    clientinfo=_clientinfo(ci, n),
                    result=bool((acc or {}).get("ok", True)))
            if hookpoint == "client.authorize":
                (ci, action, topic, acc) = args
                return pb.ClientAuthorizeRequest(
                    clientinfo=_clientinfo(ci, n),
                    type=0 if action == "publish" else 1, topic=topic,
                    result=acc != "deny")
            if hookpoint == "message.publish":
                (msg,) = args
                if topics and not any(
                        _topic_match(msg.topic, t) for t in topics):
                    return None
                return pb.MessagePublishRequest(message=_message(msg, n))
            if hookpoint in ("message.delivered", "message.acked"):
                (ci, msg) = args
                return req_cls(clientinfo=_clientinfo(ci, n),
                               message=_message(msg, n))
            if hookpoint == "message.dropped":
                (msg, reason) = args
                return pb.MessageDroppedRequest(
                    message=_message(msg, n), reason=str(reason))
            if hookpoint == "client.connect":
                (conninfo,) = args[:1]
                return pb.ClientConnectRequest(
                    conninfo=_conninfo(conninfo, n))
            if hookpoint == "client.connack":
                (ci, rc) = args[:2]
                return pb.ClientConnackRequest(
                    conninfo=_conninfo(ci, n), result_code=str(rc))
            if hookpoint == "client.disconnected":
                (ci, reason) = args[:2]
                return pb.ClientDisconnectedRequest(
                    clientinfo=_clientinfo(ci, n), reason=str(reason))
            if hookpoint == "session.subscribed":
                (ci, topic, subopts) = args[:3]
                return pb.SessionSubscribedRequest(
                    clientinfo=_clientinfo(ci, n), topic=topic,
                    subopts=pb.SubOpts(qos=(subopts or {}).get("qos", 0)))
            if hookpoint == "session.unsubscribed":
                (ci, topic) = args[:2]
                return pb.SessionUnsubscribedRequest(
                    clientinfo=_clientinfo(ci, n), topic=topic)
            if hookpoint == "session.terminated":
                (ci, reason) = args[:2]
                return pb.SessionTerminatedRequest(
                    clientinfo=_clientinfo(ci, n), reason=str(reason))
            if hookpoint in ("client.subscribe", "client.unsubscribe"):
                (ci, _props, acc) = args
                filters = [pb.TopicFilter(name=f if isinstance(f, str)
                                          else f[0])
                           for f in (acc or [])]
                return req_cls(clientinfo=_clientinfo(ci, n),
                               topic_filters=filters)
            # remaining session.* events carry just the clientinfo
            return req_cls(clientinfo=_clientinfo(args[0], n))
        except Exception:  # noqa: BLE001 — malformed args never break hooks
            log.exception("exhook request build failed for %s", hookpoint)
            return None

    def _apply_valued(self, hookpoint: str, resp, args: tuple):
        rtype = resp.type
        which = resp.WhichOneof("value")
        if rtype == pb.ValuedResponse.IGNORE or which is None:
            return None
        stop = rtype == pb.ValuedResponse.STOP_AND_RETURN
        if hookpoint == "client.authenticate":
            acc = dict(args[-1] or {})
            acc["ok"] = bool(resp.bool_result)
            return ("stop", acc) if stop else ("ok", acc)
        if hookpoint == "client.authorize":
            val = "allow" if resp.bool_result else "deny"
            return ("stop", val) if stop else ("ok", val)
        if hookpoint == "message.publish" and which == "message":
            msg: Message = args[0]
            new = msg.copy()
            new.topic = resp.message.topic or new.topic
            new.payload = bytes(resp.message.payload)
            new.qos = resp.message.qos
            return ("stop", new) if stop else ("ok", new)
        return None

    def _deny_value(self, hookpoint: str, args: tuple):
        if hookpoint == "client.authenticate":
            return ("stop", dict(args[-1] or {}, ok=False))
        if hookpoint == "client.authorize":
            return ("stop", "deny")
        if hookpoint == "message.publish":
            msg: Message = args[0]
            return ("stop", msg.copy().set_header("allow_publish", False))
        return None


def _conninfo(ci: dict, node: str) -> pb.ConnInfo:
    ci = ci or {}
    peer = ci.get("peername")
    return pb.ConnInfo(
        node=node, clientid=ci.get("clientid") or "",
        username=ci.get("username") or "",
        peerhost=str(peer[0]) if isinstance(peer, tuple) else "",
        proto_name=str(ci.get("proto_name") or "MQTT"),
        proto_ver=str(ci.get("proto_ver") or ""),
        keepalive=int(ci.get("keepalive") or 0))


def _topic_match(topic: str, pattern: str) -> bool:
    from emqx_tpu_torch.utils import topic as T
    return T.match(topic, pattern)


class Exhook:
    """The exhook app: manages configured servers (emqx_exhook.erl)."""

    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        conf = conf or (node.config.get("exhook") or {})
        self.server_confs = conf.get("servers", [])
        self.servers: dict[str, ExhookServer] = {}

    async def load(self) -> "Exhook":
        for sc in self.server_confs:
            await self.add_server(sc["name"], sc["url"],
                                  timeout=sc.get("timeout", 5.0),
                                  failed_action=sc.get("failed_action",
                                                       "deny"))
        self.node.exhook = self
        return self

    async def add_server(self, name: str, url: str, **kw) -> ExhookServer:
        if name in self.servers:
            raise ValueError(f"exhook server {name} exists")
        server = ExhookServer(self.node, name, url, **kw)
        await server.load()
        self.servers[name] = server
        return server

    async def remove_server(self, name: str) -> bool:
        server = self.servers.pop(name, None)
        if server is None:
            return False
        await server.unload()
        return True

    async def unload(self) -> None:
        for name in list(self.servers):
            await self.remove_server(name)
        if getattr(self.node, "exhook", None) is self:
            self.node.exhook = None

    def list_servers(self) -> list[dict]:
        return [{"name": s.name, "url": s.url,
                 "hooks": sorted(s.hooks_wanted)}
                for s in self.servers.values()]
