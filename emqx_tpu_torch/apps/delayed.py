"""Delayed publish: `$delayed/<Seconds>/<RealTopic>` interception.

Parity: apps/emqx_modules/src/emqx_delayed.erl — a `message.publish` hook
intercepts `$delayed/...` topics, stops the chain with `allow_publish=false`
(so the broker does not route the wrapper), stores the message keyed by its
fire time (the reference's mnesia ordered_set + timer), and republishes the
unwrapped message when due. `tick()` is the timer callback; `start()` runs
it on the node's event loop. The port's copy of
``emqx_tpu/apps/delayed.py``: a due message fires through
``node.broker.publish``, the host path, as the reference's does.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from typing import Optional

from emqx_tpu_torch.broker.message import Message, now_ms

PREFIX = "$delayed/"
MAX_DELAYED_INTERVAL = 4294967          # s (reference ?MAX_INTERVAL)


class DelayedPublish:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("delayed") or {})
        c.update(conf or {})
        self.enable = c.get("enable", True)
        self.max_delayed = int(c.get("max_delayed_messages", 0))
        self._heap: list[tuple[int, int, Message]] = []  # (fire_ms, seq, msg)
        self._cancelled: set[int] = set()                # seq ids deleted
        self._seq = itertools.count()
        self._task: Optional[asyncio.Task] = None

    # ---- app lifecycle ----
    def load(self) -> "DelayedPublish":
        # high priority: runs before retainer/rule hooks so the wrapper
        # topic never reaches them
        self.node.hooks.add("message.publish", self.on_message_publish,
                            priority=500, tag="delayed")
        return self

    def unload(self) -> None:
        self.node.hooks.delete("message.publish", "delayed")
        if self._task:
            self._task.cancel()

    # ---- hook ----
    def on_message_publish(self, msg: Message):
        if not self.enable or not msg.topic.startswith(PREFIX):
            return ("ok", msg)
        rest = msg.topic[len(PREFIX):]
        secs_s, sep, real = rest.partition("/")
        try:
            secs = int(secs_s)
        except ValueError:
            secs = -1
        if not sep or not real or secs < 0 or secs > MAX_DELAYED_INTERVAL:
            # malformed wrapper: drop (reference logs + drops)
            self.node.metrics.inc("messages.delayed.dropped")
            return ("stop", msg.set_header("allow_publish", False))
        if self.max_delayed and self.count() >= self.max_delayed:
            self.node.metrics.inc("messages.delayed.dropped")
            return ("stop", msg.set_header("allow_publish", False))
        inner = msg.copy()
        inner.topic = real
        inner.headers.pop("allow_publish", None)
        heapq.heappush(self._heap,
                       (msg.ts + secs * 1000, next(self._seq), inner))
        self.node.metrics.inc("messages.delayed")
        return ("stop", msg.set_header("allow_publish", False))

    # ---- timer ----
    def tick(self, now: Optional[int] = None) -> int:
        """Publish every message whose fire time has passed; returns count."""
        now = now if now is not None else now_ms()
        n = 0
        while self._heap and self._heap[0][0] <= now:
            _, seq, msg = heapq.heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self.node.broker.publish(msg)
            n += 1
        return n

    async def _run(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.tick()

    def start(self, interval: float = 0.25) -> None:
        self._task = asyncio.ensure_future(self._run(interval))

    # ---- checkpoint/resume (broker.persistence) ----
    def pending(self) -> list[tuple[int, int, Message]]:
        """Live (fire_ms, seq, msg) entries, cancelled ones excluded."""
        return [(fire, seq, m) for fire, seq, m in sorted(self._heap)
                if seq not in self._cancelled]

    def restore(self, msg: Message, fire_at_ms: int) -> None:
        heapq.heappush(self._heap, (fire_at_ms, next(self._seq), msg))

    # ---- mgmt API (emqx_delayed:list/delete) ----
    def list(self) -> list[dict]:
        return [{"seq": seq, "publish_at": fire, "topic": m.topic,
                 "qos": m.qos, "from": m.from_}
                for fire, seq, m in sorted(self._heap)
                if seq not in self._cancelled]

    def delete(self, seq: int) -> bool:
        live = {s for _, s, _ in self._heap}
        if seq in live and seq not in self._cancelled:
            self._cancelled.add(seq)
            return True
        return False

    def count(self) -> int:
        return len(self._heap) - len(self._cancelled)
