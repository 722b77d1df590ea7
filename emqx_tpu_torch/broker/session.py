"""Per-client MQTT session state.

Parity: emqx_session.erl — subscriptions map, inflight window (QoS1/2 out),
mqueue (pending), packet-id allocation, QoS2 `awaiting_rel` (incoming),
retry, expiry, and takeover/resume/replay (emqx_session.erl:82-122).

The session is a plain object owned by its connection task (the reference
keeps it inside the connection process and moves it wholesale on takeover);
all methods are synchronous and non-blocking.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from emqx_tpu_torch.broker.inflight import Inflight
from emqx_tpu_torch.broker.message import Message, now_ms
from emqx_tpu_torch.broker.mqueue import MQueue, MQueueOpts
from emqx_tpu_torch.mqtt import constants as C


class SessionError(Exception):
    def __init__(self, rc: int, detail: str = ""):
        self.rc = rc
        super().__init__(f"session error rc=0x{rc:02x} {detail}")


@dataclass
class SessionConf:
    max_subscriptions: int = 0            # 0 = unlimited
    upgrade_qos: bool = False
    retry_interval: float = 30.0          # s; 0 disables retry
    max_awaiting_rel: int = 100
    await_rel_timeout: float = 300.0      # s
    session_expiry_interval: int = 0      # s (v5) / 0 clean
    max_inflight: int = 32
    mqueue: MQueueOpts = field(default_factory=MQueueOpts)


class Session:
    """Outbound phases: ('publish', msg) awaiting PUBACK/PUBREC,
    ('pubrel', ts) awaiting PUBCOMP."""

    def __init__(self, clientid: str, conf: Optional[SessionConf] = None):
        self.clientid = clientid
        self.conf = conf or SessionConf()
        self.subscriptions: dict[str, dict] = {}   # filter -> subopts
        self.inflight = Inflight(self.conf.max_inflight)
        self.mqueue = MQueue(self.conf.mqueue)
        self.awaiting_rel: dict[int, int] = {}     # incoming QoS2 pid -> ts ms
        self.next_pkt_id = 1
        self.created_at = now_ms()
        # counters (emqx_session:info/1)
        self.deliver_count = 0
        self.enqueue_count = 0
        # wired by the owning channel: callable(msg, reason) invoked when
        # the mqueue evicts a message (the reference's delivery.dropped
        # hook + delivery.dropped.queue_full metric)
        self.on_dropped: Optional[Callable[[Message, str], None]] = None

    def _mq_insert(self, m: Message) -> None:
        dropped = self.mqueue.insert(m)
        if dropped is not None and self.on_dropped is not None:
            self.on_dropped(dropped, "queue_full")

    # ---- packet id allocation (emqx_session:next_pkt_id) ----
    def alloc_packet_id(self) -> int:
        for _ in range(C.MAX_PACKET_ID):
            pid = self.next_pkt_id
            self.next_pkt_id = 1 if pid >= C.MAX_PACKET_ID else pid + 1
            if not self.inflight.contain(pid):
                return pid
        raise SessionError(C.RC_QUOTA_EXCEEDED, "no free packet id")

    # ---- subscriptions ----
    def subscribe(self, topic_filter: str, subopts: dict) -> None:
        if (self.conf.max_subscriptions and
                topic_filter not in self.subscriptions and
                len(self.subscriptions) >= self.conf.max_subscriptions):
            raise SessionError(C.RC_QUOTA_EXCEEDED, "max_subscriptions")
        self.subscriptions[topic_filter] = subopts

    def unsubscribe(self, topic_filter: str) -> dict:
        try:
            return self.subscriptions.pop(topic_filter)
        except KeyError:
            raise SessionError(C.RC_NO_SUBSCRIPTION_EXISTED, topic_filter)

    # ---- incoming QoS2 (publisher side) ----
    def publish_qos2(self, packet_id: int) -> None:
        """Track an incoming QoS2 PUBLISH until PUBREL
        (emqx_session:publish/3 awaiting_rel)."""
        if packet_id in self.awaiting_rel:
            raise SessionError(C.RC_PACKET_IDENTIFIER_IN_USE)
        if (self.conf.max_awaiting_rel and
                len(self.awaiting_rel) >= self.conf.max_awaiting_rel):
            raise SessionError(C.RC_RECEIVE_MAXIMUM_EXCEEDED,
                               "max_awaiting_rel")
        self.awaiting_rel[packet_id] = now_ms()

    def pubrel(self, packet_id: int) -> None:
        if self.awaiting_rel.pop(packet_id, None) is None:
            raise SessionError(C.RC_PACKET_IDENTIFIER_NOT_FOUND)

    def expire_awaiting_rel(self) -> int:
        """Drop timed-out QoS2 ids (emqx_session:expire/2)."""
        deadline = now_ms() - int(self.conf.await_rel_timeout * 1000)
        stale = [p for p, ts in self.awaiting_rel.items() if ts < deadline]
        for p in stale:
            del self.awaiting_rel[p]
        return len(stale)

    # ---- outbound delivery (emqx_session:deliver/2) ----
    def deliver(self, msgs: list[tuple[Message, dict]]
                ) -> list[tuple[Optional[int], Message]]:
        """Accept routed messages; returns [(packet_id|None, msg)] to send
        now. QoS0 → (None, msg); QoS1/2 → allocated id + inflight; window
        full → mqueue. A routed message may be a Message copy or a
        ``broker.deliver.DeliveryView`` (the delivery lanes): _enrich
        only reads it and keeps a real ``copy()``."""
        out = []
        for msg, subopts in msgs:
            m = self._enrich(msg, subopts)
            if m is None:
                continue
            if m.qos == C.QOS_0:
                self.deliver_count += 1
                out.append((None, m))
            elif self.inflight.is_full():
                self.enqueue_count += 1
                self._mq_insert(m)
            else:
                pid = self.alloc_packet_id()
                self.inflight.insert(pid, ("publish", m))
                self.deliver_count += 1
                out.append((pid, m))
        return out

    def _enrich(self, msg: Message, subopts: dict) -> Optional[Message]:
        """Apply subopts to the delivered copy (emqx_session:enrich_*):
        QoS cap or upgrade, nl (no-local), rap (retain-as-published),
        subscription identifier. `msg` (a Message or a DeliveryView) is
        only read; what is stored and sent is its ``copy()``, a real
        Message."""
        if subopts.get("nl") and msg.from_ == self.clientid:
            return None
        m = msg.copy()
        sub_qos = int(subopts.get("qos", 0))
        if self.conf.upgrade_qos:
            m.qos = max(m.qos, sub_qos)
        else:
            m.qos = min(m.qos, sub_qos)
        if not subopts.get("rap") and not m.get_flag("retained"):
            m.flags["retain"] = False
        sid = subopts.get("subid")
        if sid is not None:
            props = dict(m.headers.get("properties") or {})
            props["subscription_identifier"] = sid
            m.headers["properties"] = props
        return m

    def enqueue(self, msgs: list[tuple[Message, dict]]) -> None:
        """Buffer while disconnected (persistent session)."""
        for msg, subopts in msgs:
            m = self._enrich(msg, subopts)
            if m is not None:
                self.enqueue_count += 1
                self._mq_insert(m)

    # ---- acks (emqx_session:puback/pubrec/pubcomp) ----
    def puback(self, packet_id: int) -> Message:
        val = self.inflight.lookup(packet_id)
        if not val or val[0] != "publish":
            raise SessionError(C.RC_PACKET_IDENTIFIER_NOT_FOUND)
        self.inflight.delete(packet_id)
        return val[1]

    def pubrec(self, packet_id: int) -> Message:
        val = self.inflight.lookup(packet_id)
        if not val:
            raise SessionError(C.RC_PACKET_IDENTIFIER_NOT_FOUND)
        if val[0] == "pubrel":
            raise SessionError(C.RC_PACKET_IDENTIFIER_IN_USE)
        self.inflight.update(packet_id, ("pubrel", val[1]))
        return val[1]

    def pubcomp(self, packet_id: int) -> Message:
        val = self.inflight.lookup(packet_id)
        if not val or val[0] != "pubrel":
            raise SessionError(C.RC_PACKET_IDENTIFIER_NOT_FOUND)
        self.inflight.delete(packet_id)
        return val[1]

    def dequeue(self) -> list[tuple[int, Message]]:
        """Refill the inflight window from the mqueue after an ack
        (emqx_session:dequeue/1)."""
        out = []
        while not self.inflight.is_full():
            m = self.mqueue.out()
            if m is None:
                break
            if m.is_expired():
                continue
            if m.qos == C.QOS_0:
                out.append((0, m))
                continue
            pid = self.alloc_packet_id()
            self.inflight.insert(pid, ("publish", m))
            self.deliver_count += 1
            out.append((pid, m))
        return out

    # ---- retry (emqx_session:retry/1) ----
    def retry(self) -> list[tuple[int, str, Message]]:
        """Returns [(pid, phase, msg)] needing resend (dup PUBLISH or PUBREL)."""
        if not self.conf.retry_interval:
            return []
        now = time.monotonic()
        out = []
        for pid, entry in self.inflight.items():
            if now - entry.ts >= self.conf.retry_interval:
                phase, msg = entry.value
                if phase == "publish" and msg.is_expired():
                    self.inflight.delete(pid)
                    continue
                entry.ts = now
                out.append((pid, phase, msg))
        return out

    # ---- takeover / resume / replay (emqx_session.erl:82-85) ----
    def takeover(self) -> "Session":
        """The old connection hands the session object over wholesale."""
        return self

    def rebalance_inflight(self) -> None:
        """After the window shrinks on resume (client sent a smaller
        Receive Maximum), move the newest publish-phase entries back to the
        front of the mqueue so replay never exceeds the client's RM
        (MQTT-3.3.4-9). PUBREL-phase entries don't count toward RM."""
        if not self.inflight.max_size:
            return
        pubs = [(pid, e) for pid, e in self.inflight.items()
                if e.value[0] == "publish"]
        over = len(pubs) - self.inflight.max_size
        if over <= 0:
            return
        for pid, entry in reversed(pubs[-over:]):
            self.inflight.delete(pid)
            self.mqueue.insert_front(entry.value[1])

    def replay(self) -> list[tuple[int, str, Message]]:
        """On resume: re-send all inflight (dup) then drain mqueue
        (emqx_session:replay/1)."""
        self.rebalance_inflight()
        out = []
        for pid, entry in self.inflight.items():
            phase, msg = entry.value
            if phase == "publish":
                msg.set_flag("dup", True)
            entry.ts = time.monotonic()
            out.append((pid, phase, msg))
        for pid, m in self.dequeue():
            out.append((pid, "publish", m))
        return out

    def clear_expired(self) -> int:
        return self.mqueue.filter(lambda m: not m.is_expired())

    # ---- cross-node takeover serialization (the reference moves the live
    # session term over disterl, emqx_cm.erl:268-298; we move a wire map
    # over the rpc plane) ----
    def to_wire(self) -> dict:
        return {
            "clientid": self.clientid,
            "subscriptions": dict(self.subscriptions),
            "awaiting_rel": dict(self.awaiting_rel),
            "next_pkt_id": self.next_pkt_id,
            "created_at": self.created_at,
            "expiry_interval": self.conf.session_expiry_interval,
            # both phases hold the Message (pubrec keeps it for PUBCOMP)
            "inflight": [[pid, e.value[0], e.value[1].to_wire()]
                         for pid, e in self.inflight.items()],
            "mqueue": [m.to_wire() for m in self.mqueue.to_list()],
        }

    @staticmethod
    def from_wire(d: dict, conf: Optional[SessionConf] = None) -> "Session":
        s = Session(d["clientid"], conf)
        s.conf.session_expiry_interval = d.get(
            "expiry_interval", s.conf.session_expiry_interval)
        s.subscriptions = {str(k): dict(v)
                           for k, v in d["subscriptions"].items()}
        s.awaiting_rel = {int(k): int(v)
                          for k, v in d["awaiting_rel"].items()}
        s.next_pkt_id = d["next_pkt_id"]
        s.created_at = d["created_at"]
        for pid, phase, val in d["inflight"]:
            s.inflight.insert(int(pid), (phase, Message.from_wire(val)))
        for m in d["mqueue"]:
            s.mqueue.insert(Message.from_wire(m))
        return s

    def info(self) -> dict:
        return {
            "clientid": self.clientid,
            "subscriptions_cnt": len(self.subscriptions),
            "inflight_cnt": len(self.inflight),
            "inflight_max": self.inflight.max_size,
            "mqueue_len": len(self.mqueue),
            "mqueue_max": self.mqueue.max_len(),
            "mqueue_dropped": self.mqueue.dropped,
            "awaiting_rel_cnt": len(self.awaiting_rel),
            "awaiting_rel_max": self.conf.max_awaiting_rel,
            "next_pkt_id": self.next_pkt_id,
            "created_at": self.created_at,
        }
