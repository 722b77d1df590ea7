"""Client/session lifecycle events republished as `$event/...` messages.

Parity: apps/emqx_modules/src/emqx_event_message.erl — hook callbacks build
JSON payloads and publish them to `$event/client_connected`,
`$event/client_disconnected`, `$event/session_subscribed`,
`$event/session_unsubscribed`, `$event/message_delivered`,
`$event/message_acked`, `$event/message_dropped`, each individually
config-gated. The port's copy of ``emqx_tpu/apps/event_message.py``.
"""

from __future__ import annotations

import json
from typing import Optional

from emqx_tpu_torch.broker.message import Message, base62_encode, make, now_ms

EVENTS = ("client_connected", "client_disconnected", "session_subscribed",
          "session_unsubscribed", "message_delivered", "message_acked",
          "message_dropped")


def _payload(d: dict) -> bytes:
    return json.dumps(d, default=repr).encode()


class EventMessage:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("event_message") or {})
        c.update(conf or {})
        self.enabled = {e for e in EVENTS if c.get(e, False)}

    def load(self) -> "EventMessage":
        h = self.node.hooks
        if "client_connected" in self.enabled:
            h.add("client.connected", self.on_client_connected, tag="event_msg")
        if "client_disconnected" in self.enabled:
            h.add("client.disconnected", self.on_client_disconnected,
                  tag="event_msg")
        if "session_subscribed" in self.enabled:
            h.add("session.subscribed", self.on_session_subscribed,
                  tag="event_msg")
        if "session_unsubscribed" in self.enabled:
            h.add("session.unsubscribed", self.on_session_unsubscribed,
                  tag="event_msg")
        if "message_delivered" in self.enabled:
            h.add("message.delivered", self.on_message_delivered,
                  tag="event_msg")
        if "message_acked" in self.enabled:
            h.add("message.acked", self.on_message_acked, tag="event_msg")
        if "message_dropped" in self.enabled:
            h.add("message.dropped", self.on_message_dropped, tag="event_msg")
        return self

    def unload(self) -> None:
        for h in ("client.connected", "client.disconnected",
                  "session.subscribed", "session.unsubscribed",
                  "message.delivered", "message.acked", "message.dropped"):
            self.node.hooks.delete(h, "event_msg")

    def _publish(self, event: str, payload: dict) -> None:
        msg = make("", 0, f"$event/{event}", _payload(payload),
                   flags={"sys": True})
        self.node.broker.publish(msg)

    @staticmethod
    def _skip(topic: str) -> bool:
        return topic.startswith("$event/") or topic.startswith("$SYS/")

    # ---- hooks ----
    def on_client_connected(self, clientinfo: dict, conninfo: dict):
        self._publish("client_connected", {
            "clientid": clientinfo.get("clientid"),
            "username": clientinfo.get("username"),
            "keepalive": clientinfo.get("keepalive"),
            "proto_ver": clientinfo.get("proto_ver"),
            "clean_start": clientinfo.get("clean_start"),
            "connected_at": clientinfo.get("connected_at"),
            "ts": now_ms()})

    def on_client_disconnected(self, clientinfo: dict, reason):
        self._publish("client_disconnected", {
            "clientid": clientinfo.get("clientid"),
            "username": clientinfo.get("username"),
            "reason": str(reason), "disconnected_at": now_ms(),
            "ts": now_ms()})

    def on_session_subscribed(self, clientinfo: dict, topic: str,
                              subopts: dict):
        if self._skip(topic):
            return
        self._publish("session_subscribed", {
            "clientid": clientinfo.get("clientid"),
            "username": clientinfo.get("username"),
            "topic": topic, "subopts": {k: v for k, v in subopts.items()
                                        if k != "is_new"},
            "ts": now_ms()})

    def on_session_unsubscribed(self, clientinfo: dict, topic: str):
        if self._skip(topic):
            return
        self._publish("session_unsubscribed", {
            "clientid": clientinfo.get("clientid"),
            "username": clientinfo.get("username"),
            "topic": topic, "ts": now_ms()})

    def on_message_delivered(self, clientid, msg: Message):
        if self._skip(msg.topic):
            return
        self._publish("message_delivered", self._msg_map(msg,
                                                         clientid=clientid))

    def on_message_acked(self, clientinfo, msg: Message):
        if self._skip(msg.topic):
            return
        cid = clientinfo.get("clientid") if isinstance(clientinfo, dict) \
            else clientinfo
        self._publish("message_acked", self._msg_map(msg, clientid=cid))

    def on_message_dropped(self, msg: Optional[Message], reason=None):
        if msg is None or self._skip(msg.topic):
            return
        self._publish("message_dropped",
                      self._msg_map(msg, reason=str(reason)))

    @staticmethod
    def _msg_map(msg: Message, **extra) -> dict:
        d = {"id": base62_encode(msg.id), "from": msg.from_,
             "topic": msg.topic, "qos": msg.qos, "retain": msg.retain,
             "payload": msg.payload.decode("utf-8", "replace"),
             "publish_received_at": msg.ts, "ts": now_ms()}
        d.update(extra)
        return d
