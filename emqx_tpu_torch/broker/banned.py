"""Banned-client table + flapping detection.

Parity: apps/emqx/src/emqx_banned.erl (mnesia table keyed by
{clientid|username|peerhost, Value} with until-timestamp, checked during
CONNECT) and emqx_flapping.erl (connect/disconnect churn within a window
→ auto-ban, emqx_flapping.erl:69-72).

The port's copy of ``emqx_tpu/broker/banned.py``. The node builds a
``Banned`` table and expires it on every ``sweep``; ``FlappingDetect``
comes whole but nothing loads it yet (the reference's app boot does).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

WHO_KINDS = ("clientid", "username", "peerhost")


@dataclass
class BanEntry:
    kind: str
    value: str
    by: str = "admin"
    reason: str = ""
    at: float = field(default_factory=time.time)
    until: Optional[float] = None        # epoch seconds; None = forever

    def expired(self, now: Optional[float] = None) -> bool:
        return self.until is not None and (now or time.time()) >= self.until


class Banned:
    def __init__(self):
        self._t: dict[tuple[str, str], BanEntry] = {}

    def create(self, kind: str, value: str, *, by: str = "admin",
               reason: str = "", duration: Optional[float] = None) -> BanEntry:
        if kind not in WHO_KINDS:
            raise ValueError(f"bad ban kind {kind!r}")
        e = BanEntry(kind, value, by=by, reason=reason,
                     until=None if duration is None
                     else time.time() + duration)
        self._t[(kind, value)] = e
        return e

    def delete(self, kind: str, value: str) -> bool:
        return self._t.pop((kind, value), None) is not None

    def look_up(self, kind: str, value: str) -> Optional[BanEntry]:
        e = self._t.get((kind, value))
        if e is not None and e.expired():
            del self._t[(kind, value)]
            return None
        return e

    def check(self, clientinfo: dict) -> bool:
        """True if the connecting client is banned (emqx_banned:check/1)."""
        peer = clientinfo.get("peername")
        probes = (("clientid", clientinfo.get("clientid")),
                  ("username", clientinfo.get("username")),
                  ("peerhost", peer[0] if peer else None))
        return any(v is not None and self.look_up(k, str(v)) is not None
                   for k, v in probes)

    def all(self) -> list[BanEntry]:
        self.expire()
        return list(self._t.values())

    def expire(self) -> int:
        now = time.time()
        stale = [k for k, e in self._t.items() if e.expired(now)]
        for k in stale:
            del self._t[k]
        return len(stale)

    def tick(self) -> None:
        self.expire()


class FlappingDetect:
    """client.connected/disconnected hook pair counting churn per client.

    Parity: emqx_flapping.erl — a client exceeding `max_count`
    disconnects within `window_time` seconds is banned for `ban_time`.
    """

    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("flapping_detect") or {})
        c.update(conf or {})
        self.enable = c.get("enable", False)
        self.max_count = int(c.get("max_count", 15))
        self.window = float(c.get("window_time", 60))
        self.ban_time = float(c.get("ban_time", 300))
        self._hits: dict[str, list[float]] = {}

    def load(self) -> "FlappingDetect":
        if self.enable:
            self.node.hooks.add("client.disconnected",
                                self.on_client_disconnected, tag="flapping")
        return self

    def unload(self) -> None:
        self.node.hooks.delete("client.disconnected", "flapping")

    def on_client_disconnected(self, clientinfo: dict, reason) -> None:
        cid = clientinfo.get("clientid")
        if not cid:
            return
        now = time.monotonic()
        hits = self._hits.setdefault(cid, [])
        hits.append(now)
        cutoff = now - self.window
        while hits and hits[0] < cutoff:
            hits.pop(0)
        if len(hits) >= self.max_count:
            del self._hits[cid]
            self.node.banned.create(
                "clientid", cid, by="flapping_detect",
                reason=f"flapping: {self.max_count} disconnects in "
                       f"{self.window}s", duration=self.ban_time)
            self.node.metrics.inc("client.flapping.banned")

    def tick(self) -> None:
        """Housekeeping: drop clientids whose newest disconnect left the
        window — otherwise one timestamp list leaks per clientid ever
        disconnected."""
        cutoff = time.monotonic() - self.window
        stale = [cid for cid, hits in self._hits.items()
                 if not hits or hits[-1] < cutoff]
        for cid in stale:
            del self._hits[cid]
