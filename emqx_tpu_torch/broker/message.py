"""Canonical broker message + GUID generation.

Parity: reference `#message` record (apps/emqx/include/emqx.hrl:55-73),
`emqx_message.erl` constructors/flag ops, and `emqx_guid.erl` (timestamp +
node + sequence GUIDs, base62-renderable). The port's copy of
``emqx_tpu/broker/message.py``, with the REST map (``to_map``) and the
wire form (``to_wire`` / ``from_wire``) the retainer's disc journal
writes.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from emqx_tpu_torch.mqtt import constants as C

_BASE62 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def base62_encode(n: int) -> str:
    """Parity: emqx_base62:encode/1."""
    if n == 0:
        return "0"
    out = []
    while n:
        n, r = divmod(n, 62)
        out.append(_BASE62[r])
    return "".join(reversed(out))


def base62_decode(s: str) -> int:
    n = 0
    for ch in s:
        n = n * 62 + _BASE62.index(ch)
    return n


class GuidGen:
    """128-bit GUIDs: 64b microsecond timestamp | 48b node id | 16b sequence.

    Parity: emqx_guid.erl (ts+node+seq scheme); monotone within a node so
    message ids sort by arrival, which the device batching relies on for
    per-publisher ordering (SURVEY.md §7 hard part 5).
    """

    def __init__(self, node_id: Optional[int] = None):
        self._node = (node_id if node_id is not None else
                      (os.getpid() << 16) ^ (threading.get_ident() & 0xFFFF)
                      ) & 0xFFFFFFFFFFFF
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            ts = time.time_ns() // 1000
            seq = next(self._seq) & 0xFFFF
        return (ts << 64) | (self._node << 16) | seq

    def next_batch(self, n: int) -> list:
        """Reserve n GUIDs in ONE locked pass, the columnar burst
        path's allocation (a lock and a clock read per message was the
        largest per-row cost). Same layout and monotonicity as n next()
        calls within one microsecond tick."""
        with self._lock:
            base = (time.time_ns() // 1000 << 64) | (self._node << 16)
            seq = self._seq
            return [base | (next(seq) & 0xFFFF) for _ in range(n)]


_GUID = GuidGen()


def now_ms() -> int:
    return time.time_ns() // 1_000_000


@dataclass
class Message:
    """Parity: #message{} — id, qos, from, flags, headers, topic, payload, ts
    (include/emqx.hrl:55-73)."""

    topic: str
    payload: bytes = b""
    qos: int = C.QOS_0
    from_: str = ""                       # publisher clientid ('from' field)
    flags: dict = field(default_factory=dict)     # retain / dup / sys
    headers: dict = field(default_factory=dict)   # username, peerhost, props,
                                                  # allow_publish, re-dispatch
    id: int = 0
    ts: int = 0                            # ms epoch
    extra: dict = field(default_factory=dict)

    # ingress stamp: perf_counter_ns at frame decode, carried from the
    # Publish packet or the PublishBurst by the channel. A plain class
    # attribute, not a dataclass field: every message answers 0 at no
    # per-instance cost, and __init__, equality and repr are untouched;
    # only socket-ingress messages carry a real stamp.
    ingress_ns = 0

    def __post_init__(self):
        if not self.id:
            self.id = _GUID.next()
        if not self.ts:
            self.ts = now_ms()

    # -- flag ops (emqx_message:get_flag/set_flag/clean_dup) --
    def get_flag(self, name: str, default: bool = False) -> bool:
        return bool(self.flags.get(name, default))

    def set_flag(self, name: str, val: bool = True) -> "Message":
        self.flags[name] = val
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

    def get_header(self, name: str, default: Any = None) -> Any:
        return self.headers.get(name, default)

    def set_header(self, name: str, val: Any) -> "Message":
        self.headers[name] = val
        return self

    # -- expiry (emqx_message:is_expired/1 via v5 Message-Expiry-Interval) --
    def expiry_interval(self) -> Optional[int]:
        props = self.headers.get("properties") or {}
        return props.get("message_expiry_interval")

    def is_expired(self) -> bool:
        exp = self.expiry_interval()
        if exp is None:
            return False
        return now_ms() > self.ts + exp * 1000

    def update_expiry(self) -> "Message":
        """Shrink remaining expiry before delivery (emqx_message:update_expiry)."""
        exp = self.expiry_interval()
        if exp is not None:
            remaining = max(1, exp - (now_ms() - self.ts) // 1000)
            props = dict(self.headers.get("properties") or {})
            props["message_expiry_interval"] = int(remaining)
            self.headers["properties"] = props
        return self

    def copy(self) -> "Message":
        return Message(topic=self.topic, payload=self.payload, qos=self.qos,
                       from_=self.from_, flags=dict(self.flags),
                       headers=dict(self.headers), id=self.id, ts=self.ts,
                       extra=dict(self.extra))

    def to_map(self) -> dict:
        """For the REST API and the event columns."""
        return {
            "id": base62_encode(self.id), "topic": self.topic,
            "qos": self.qos, "from": self.from_,
            "payload": self.payload, "flags": dict(self.flags),
            "timestamp": self.ts, "retain": self.retain,
        }

    def to_wire(self) -> dict:
        """Full-fidelity encoding (the retainer's disc journal; the
        reference forwards it between nodes). Header values that do not
        serialize (live objects planted by local hooks) are dropped."""
        def safe(v):
            return isinstance(v, (str, int, float, bool, bytes, type(None))) \
                or (isinstance(v, (list, tuple)) and all(safe(x) for x in v)) \
                or (isinstance(v, dict)
                    and all(isinstance(k, str) and safe(x)
                            for k, x in v.items()))
        return {"topic": self.topic, "payload": self.payload,
                "qos": self.qos, "from": self.from_,
                "flags": dict(self.flags),
                "headers": {k: v for k, v in self.headers.items()
                            if safe(v)},
                "msgid": self.id, "ts": self.ts}

    @staticmethod
    def from_wire(d: dict) -> "Message":
        return Message(topic=d["topic"], payload=d["payload"], qos=d["qos"],
                       from_=d["from"], flags=dict(d["flags"]),
                       headers=dict(d["headers"]), id=d["msgid"], ts=d["ts"])


def make(from_: str, qos: int, topic: str, payload: bytes,
         flags: Optional[dict] = None, headers: Optional[dict] = None) -> Message:
    """Parity: emqx_message:make/4."""
    return Message(topic=topic, payload=payload, qos=qos, from_=from_,
                   flags=dict(flags or {}), headers=dict(headers or {}))


def guid_batch(n: int) -> list:
    """n GUIDs from the process generator in one locked pass (the
    columnar ingress burst allocation)."""
    return _GUID.next_batch(n)
