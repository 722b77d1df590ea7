"""Event column construction from broker hookpoints.

Parity: emqx_rule_events.erl — each hookpoint builds a flat column map
(eventmsg_publish :139-153, eventmsg_connected :155-188, etc.), FROM topics
`$events/<name>` map to hookpoints (event_name/1 :561-569), and any other
FROM topic is a filter over 'message.publish'. with_basic_columns adds
event/timestamp/node.

The port's copy of ``emqx_tpu/rules/events.py``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from emqx_tpu_torch.broker.message import Message, base62_encode

EVENT_TOPICS = {
    "$events/client_connected": "client.connected",
    "$events/client_disconnected": "client.disconnected",
    "$events/session_subscribed": "session.subscribed",
    "$events/session_unsubscribed": "session.unsubscribed",
    "$events/message_delivered": "message.delivered",
    "$events/message_acked": "message.acked",
    "$events/message_dropped": "message.dropped",
}


def event_name(topic: str) -> str:
    """FROM-topic -> hookpoint; non-$events topics select message.publish
    (emqx_rule_events:event_name/1)."""
    for prefix, name in EVENT_TOPICS.items():
        if topic.startswith(prefix):
            return name
    return "message.publish"


def _basic(event: str, columns: dict) -> dict:
    columns["event"] = event.replace(".", "_")
    columns["timestamp"] = int(time.time() * 1000)
    columns.setdefault("node", "emqx@127.0.0.1")
    return columns


def _payload_col(p: bytes) -> Any:
    try:
        return p.decode("utf-8")
    except UnicodeDecodeError:
        return p


def columns_publish(msg: Message) -> dict:
    """eventmsg_publish columns (emqx_rule_events.erl:139-153)."""
    return _basic("message.publish", {
        "id": base62_encode(msg.id),
        "clientid": msg.from_,
        "username": msg.get_header("username"),
        "payload": _payload_col(msg.payload),
        "peerhost": msg.get_header("peerhost"),
        "topic": msg.topic,
        "qos": msg.qos,
        "flags": dict(msg.flags),
        "pub_props": dict(msg.get_header("properties") or {}),
        "publish_received_at": msg.ts,
    })


def columns_connected(clientinfo: dict, conninfo: dict) -> dict:
    return _basic("client.connected", {
        "clientid": clientinfo.get("clientid"),
        "username": clientinfo.get("username"),
        "mountpoint": clientinfo.get("mountpoint"),
        "peername": _ntoa(conninfo.get("peername")
                          or clientinfo.get("peername")),
        "sockname": _ntoa(conninfo.get("sockname")),
        "proto_name": conninfo.get("proto_name", "MQTT"),
        "proto_ver": conninfo.get("proto_ver"),
        "keepalive": conninfo.get("keepalive"),
        "clean_start": conninfo.get("clean_start", True),
        "receive_maximum": conninfo.get("receive_maximum"),
        "expiry_interval": conninfo.get("expiry_interval", 0),
        "is_bridge": clientinfo.get("is_bridge", False),
        "conn_props": dict(conninfo.get("conn_props") or {}),
        "connected_at": conninfo.get("connected_at"),
    })


def columns_disconnected(clientinfo: dict, reason: Any) -> dict:
    return _basic("client.disconnected", {
        "reason": str(reason),
        "clientid": clientinfo.get("clientid"),
        "username": clientinfo.get("username"),
        "peername": _ntoa(clientinfo.get("peername")),
        "sockname": _ntoa(clientinfo.get("sockname")),
        "disconn_props": {},
        "disconnected_at": int(time.time() * 1000),
    })


def columns_sub_unsub(event: str, clientinfo: dict, topic: str,
                      subopts: Optional[dict] = None) -> dict:
    prop_key = ("sub_props" if event == "session.subscribed"
                else "unsub_props")
    return _basic(event, {
        "clientid": clientinfo.get("clientid"),
        "username": clientinfo.get("username"),
        "peerhost": clientinfo.get("peerhost"),
        prop_key: {},
        "topic": topic,
        "qos": (subopts or {}).get("qos", 0),
    })


def columns_delivered(clientid: Any, msg: Message) -> dict:
    cols = columns_publish(msg)
    cols.update({
        "event": "message_delivered",
        "from_clientid": msg.from_,
        "from_username": msg.get_header("username"),
        "clientid": clientid if isinstance(clientid, str)
        else (clientid or {}).get("clientid") if isinstance(clientid, dict)
        else clientid,
    })
    return cols


def columns_acked(clientinfo: Any, msg: Message) -> dict:
    cols = columns_delivered(clientinfo, msg)
    cols["event"] = "message_acked"
    cols["puback_props"] = {}
    return cols


def columns_dropped(msg: Message, reason: str) -> dict:
    cols = columns_publish(msg)
    cols["event"] = "message_dropped"
    cols["reason"] = reason
    return cols


def _ntoa(addr: Any) -> Optional[str]:
    if addr is None:
        return None
    if isinstance(addr, tuple):
        return f"{addr[0]}:{addr[1]}"
    return str(addr)
