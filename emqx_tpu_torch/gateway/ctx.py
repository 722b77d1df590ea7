"""Gateway context: the insulation layer between a gateway and the core.

Parity: emqx_gateway_ctx.erl — authenticate, open_session (per-gateway CM
namespace `<gw>:<clientid>`), publish/subscribe into the core broker,
metrics. Gateway channels never touch broker internals directly; everything
goes through this object (so the core can evolve independently of the 5
protocol implementations).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from emqx_tpu_torch.broker.message import Message, make
from emqx_tpu_torch.broker.session import Session, SessionConf


class GatewayCtx:
    def __init__(self, node, gwname: str):
        self.node = node
        self.gwname = gwname

    def _cid(self, clientid: str) -> str:
        return f"{self.gwname}:{clientid}"

    # ---- authn (delegates to the core chain like emqx_gateway_ctx:authenticate)
    async def authenticate(self, clientinfo: dict,
                           password: Optional[str] = None) -> bool:
        if self.node.banned.check(clientinfo):
            return False
        self.node.metrics.inc("client.authenticate")
        if isinstance(password, str):
            password = password.encode()   # authn chain expects wire bytes
        res = await self.node.hooks.run_fold_async(
            "client.authenticate", (clientinfo,),
            {"ok": True, "password": password})
        return isinstance(res, dict) and bool(res.get("ok"))

    async def authorize(self, clientinfo: dict, action: str,
                        topic: str) -> bool:
        res = await self.node.hooks.run_fold_async(
            "client.authorize", (clientinfo, action, topic), "allow")
        return res != "deny"

    # ---- session / registry ----
    async def open_session(self, clean_start: bool, clientid: str,
                           channel: Any,
                           conf: Optional[SessionConf] = None
                           ) -> tuple[Session, bool]:
        sess, present = await self.node.cm.open_session(
            clean_start, self._cid(clientid), conf or SessionConf(),
            channel)
        return sess, present

    def register_channel(self, clientid: str, channel: Any,
                         info: Optional[dict] = None) -> None:
        self.node.cm.register_channel(self._cid(clientid), channel,
                                      dict(info or {},
                                           gateway=self.gwname))

    def unregister_channel(self, clientid: str,
                           channel: Any = None) -> None:
        self.node.cm.unregister_channel(self._cid(clientid), channel)

    def lookup_channel(self, clientid: str) -> Optional[Any]:
        return self.node.cm.lookup_channel(self._cid(clientid))

    # ---- pubsub ----
    def register_subscriber(self, subscriber, clientid: str) -> int:
        return self.node.broker.register(subscriber, self._cid(clientid))

    def unregister_subscriber(self, sid: int) -> None:
        self.node.broker.subscriber_down(sid)

    def subscribe(self, sid: int, topic_filter: str,
                  subopts: Optional[dict] = None) -> None:
        self.node.broker.subscribe(sid, topic_filter, subopts or {"qos": 0})

    def unsubscribe(self, sid: int, topic_filter: str) -> bool:
        return self.node.broker.unsubscribe(sid, topic_filter)

    def publish(self, clientid: str, topic: str, payload: bytes,
                qos: int = 0, retain: bool = False,
                headers: Optional[dict] = None) -> int:
        msg = make(self._cid(clientid), qos, topic, payload,
                   flags={"retain": retain}, headers=headers or {})
        # scheduled (not inline): async extension hooks must see gateway
        # publishes too; gateway callers don't consume the delivery count
        self.node.broker.publish_soon(msg)
        return 1

    def publish_msg(self, msg: Message) -> int:
        self.node.broker.publish_soon(msg)
        return 1

    def metrics_inc(self, name: str, n: int = 1) -> None:
        self.node.metrics.inc(f"gateway.{self.gwname}.{name}", n)
