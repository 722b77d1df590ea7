"""Bounded pending-message queue with per-topic priorities.

Parity: emqx_mqueue.erl — drop-oldest-on-full priority queue holding
messages awaiting delivery while the inflight window is closed; optional
per-topic priorities and a store_qos0 toggle (emqx_mqueue.erl:44,75-88).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.broker.message import Message

DEFAULT_PRIORITY = 0


@dataclass
class MQueueOpts:
    max_len: int = 1000                 # 0 = unlimited
    store_qos0: bool = True
    priorities: dict = field(default_factory=dict)  # topic -> int (higher first)
    default_priority: str = "lowest"    # 'lowest' | 'highest' for unlisted topics


class MQueue:
    """Priority buckets of FIFO deques; drop-oldest across lowest priority."""

    def __init__(self, opts: Optional[MQueueOpts] = None):
        self.opts = opts or MQueueOpts()
        self._qs: dict[int, deque] = {}   # priority -> deque[Message]
        self._len = 0
        self.dropped = 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def max_len(self) -> int:
        return self.opts.max_len

    def _priority(self, topic: str) -> int:
        if topic in self.opts.priorities:
            return self.opts.priorities[topic]
        if not self.opts.priorities:
            return DEFAULT_PRIORITY
        if self.opts.default_priority == "highest":
            return max(self.opts.priorities.values()) + 1
        return min(self.opts.priorities.values()) - 1

    def insert(self, msg: Message) -> Optional[Message]:
        """Enqueue; returns the dropped message if the queue was full
        (parity: emqx_mqueue:in/2 returning {Dropped, Q})."""
        if msg.qos == 0 and not self.opts.store_qos0:
            self.dropped += 1
            return msg
        prio = self._priority(msg.topic)
        q = self._qs.setdefault(prio, deque())
        dropped = None
        if self.opts.max_len and self._len >= self.opts.max_len:
            dropped = self._drop_oldest()
        q.append(msg)
        self._len += 1
        return dropped

    def insert_front(self, msg: Message) -> None:
        """Put a message at the head of its priority bucket (used when
        shrinking the inflight window on resume — these were already
        inflight, so they precede everything queued later). Never drops."""
        prio = self._priority(msg.topic)
        self._qs.setdefault(prio, deque()).appendleft(msg)
        self._len += 1

    def _drop_oldest(self) -> Optional[Message]:
        for prio in sorted(self._qs):
            q = self._qs[prio]
            if q:
                self._len -= 1
                self.dropped += 1
                return q.popleft()
        return None

    def out(self) -> Optional[Message]:
        """Dequeue highest-priority oldest message (emqx_mqueue:out/1)."""
        for prio in sorted(self._qs, reverse=True):
            q = self._qs[prio]
            if q:
                self._len -= 1
                return q.popleft()
        return None

    def to_list(self) -> list[Message]:
        out = []
        for prio in sorted(self._qs, reverse=True):
            out.extend(self._qs[prio])
        return out

    def filter(self, pred) -> int:
        """Drop messages failing pred; returns count dropped (expiry sweep)."""
        removed = 0
        for q in self._qs.values():
            keep = [m for m in q if pred(m)]
            removed += len(q) - len(keep)
            q.clear()
            q.extend(keep)
        self._len -= removed
        self.dropped += removed
        return removed

    def stats(self) -> dict:
        return {"len": self._len, "max_len": self.opts.max_len,
                "dropped": self.dropped}
