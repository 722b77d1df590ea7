"""Connection/session manager: clientid → channel registry + session lifecycle.

Parity: emqx_cm.erl — register/unregister channel, open_session with
clean-start discard or takeover-resume (emqx_cm.erl:208-298), per-clientid
locking (emqx_cm_locker), kick/discard. The reference's 2-phase
`{takeover,'begin'/'end'}` call to the old connection becomes two async
callbacks on the old channel object.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional, Protocol

from emqx_tpu_torch.broker.session import Session, SessionConf


class ChannelLike(Protocol):
    async def takeover_begin(self) -> Optional[Session]: ...
    async def takeover_end(self) -> list: ...
    async def kick(self, reason: str) -> None: ...


class ConnectionManager:
    def __init__(self):
        self._channels: dict[str, Any] = {}     # clientid -> channel
        self._info: dict[str, dict] = {}        # clientid -> conn info map
        self._locks: dict[str, asyncio.Lock] = {}
        # detached persistent sessions (expiry > 0, connection gone)
        self._detached: dict[str, Session] = {}
        self._parked_at: dict[str, float] = {}
        self.broker = None      # wired by Node for parked-session cleanup
        self.cluster = None     # wired by ClusterNode (registry + takeover)
        self.max_count = 0

    # ---- registry (emqx_cm:register_channel/3 :124-131) ----
    def register_channel(self, clientid: str, channel: Any,
                         info: Optional[dict] = None) -> None:
        self._channels[clientid] = channel
        self._info[clientid] = info or {}
        self.max_count = max(self.max_count, len(self._channels))
        if self.cluster:
            self.cluster.registry_register(clientid)

    def unregister_channel(self, clientid: str, channel: Any = None) -> None:
        if channel is None or self._channels.get(clientid) is channel:
            self._channels.pop(clientid, None)
            self._info.pop(clientid, None)
            if self.cluster:
                self.cluster.registry_unregister(clientid)

    def lookup_channel(self, clientid: str) -> Optional[Any]:
        return self._channels.get(clientid)

    def set_channel_info(self, clientid: str, info: dict) -> None:
        if clientid in self._channels:
            self._info[clientid] = info

    def get_channel_info(self, clientid: str) -> Optional[dict]:
        return self._info.get(clientid)

    def all_channels(self) -> list[tuple[str, Any]]:
        return list(self._channels.items())

    def count(self) -> int:
        return len(self._channels)

    def _lock(self, clientid: str) -> asyncio.Lock:
        return self._locks.setdefault(clientid, asyncio.Lock())

    # ---- session lifecycle (emqx_cm:open_session/3 :208-240) ----
    async def open_session(self, clean_start: bool, clientid: str,
                           conf: SessionConf,
                           new_channel: Any) -> tuple[Session, bool]:
        """Returns (session, session_present). Serialized per clientid
        (the emqx_cm_locker analog)."""
        lock = (self.cluster.lock(clientid) if self.cluster
                else self._lock(clientid))
        async with lock:
            if clean_start:
                await self.discard_session(clientid)
                if self.cluster:
                    await self.cluster.discard_remote(clientid)
                return Session(clientid, conf), False
            # try takeover from a live channel first
            old = self._channels.get(clientid)
            if old is not None and old is not new_channel:
                session = await old.takeover_begin()
                if session is not None:
                    pendings = await old.takeover_end()
                    self.unregister_channel(clientid, old)
                    session.conf = conf
                    # pendings are raw routed messages buffered during the
                    # takeover window — run them through the session's
                    # subopts enrichment (QoS cap, nl, rap) like any other
                    # delivery (emqx_channel.erl:754-759)
                    session.enqueue([(m, m.headers.get("subopts", {}))
                                     for m in pendings])
                    return session, True
            detached = self._detached.pop(clientid, None)
            self._parked_at.pop(clientid, None)
            if detached is not None:
                detached.conf = conf
                return detached, True
            if self.cluster:
                # the client may live on another node (emqx_cm:268-298
                # rpc takeover via the cm registry)
                wire = await self.cluster.takeover_remote(clientid)
                if wire is not None:
                    session = Session.from_wire(wire, conf)
                    return session, True
            return Session(clientid, conf), False

    async def discard_session(self, clientid: str) -> None:
        """Kick any existing channel and drop its session
        (emqx_cm:discard_session). Goes through unregister_channel so the
        cluster registry entry is retired with the channel."""
        old = self._channels.get(clientid)
        self.unregister_channel(clientid)
        self.drop_parked(clientid)
        if old is not None:
            try:
                await old.kick("discarded")
            except Exception:  # noqa: BLE001 — the old channel may be
                pass           # half-dead already; the takeover wins

    async def kick_session(self, clientid: str) -> bool:
        """Administrative kick (emqx_cm:kick_session)."""
        old = self._channels.get(clientid)
        if old is None:
            return False
        self.unregister_channel(clientid)
        try:
            await old.kick("kicked")
        except Exception:  # noqa: BLE001 — a dying channel must not
            pass           # fail the administrative kick
        return True

    # ---- persistent-session parking ----
    def park_session(self, clientid: str, session: Session) -> None:
        """Hold a session whose connection closed with expiry > 0; its
        broker subscriptions stay live (sid re-pointed by the channel) so
        offline messages keep enqueueing. The clientid stays in the cluster
        registry so a reconnect on another node can find and take it over
        (emqx_cm_registry keeps entries for disconnected persistent
        sessions too)."""
        import time
        self._detached[clientid] = session
        self._parked_at[clientid] = time.monotonic()
        if self.cluster:
            self.cluster.registry_register(clientid)

    def drop_parked(self, clientid: str) -> None:
        sess = self._detached.pop(clientid, None)
        self._parked_at.pop(clientid, None)
        if sess is not None:
            if self.broker is not None:
                sid = getattr(sess, "parked_sid", None)
                if sid is not None:
                    self.broker.subscriber_down(sid)
            if self.cluster:
                self.cluster.registry_unregister(clientid)

    def sweep_expired_sessions(self) -> int:
        """Expire parked sessions past their session_expiry_interval
        (the reference's session-expiry timer)."""
        import time
        now = time.monotonic()
        gone = [cid for cid, sess in self._detached.items()
                if now - self._parked_at.get(cid, now)
                > sess.conf.session_expiry_interval]
        for cid in gone:
            self.drop_parked(cid)
        return len(gone)

    def parked_count(self) -> int:
        return len(self._detached)

    def stats_fun(self, stats) -> None:
        stats.setstat("connections.count", len(self._channels),
                      "connections.max")
        stats.setstat("sessions.count",
                      len(self._channels) + len(self._detached),
                      "sessions.max")
