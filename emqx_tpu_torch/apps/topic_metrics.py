"""Per-topic message counters and rates.

Parity: apps/emqx_modules/src/emqx_topic_metrics.erl — operator registers
topic filters; hooks count messages.in/out/dropped and per-QoS variants for
matching topics; `tick()` computes rolling rates the way the reference's
speed timer does. The port's copy of ``emqx_tpu/apps/topic_metrics.py``.
"""

from __future__ import annotations

import time
from typing import Optional

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.utils import topic as T

METRICS = ("messages.in", "messages.out", "messages.dropped",
           "messages.qos0.in", "messages.qos1.in", "messages.qos2.in",
           "messages.qos0.out", "messages.qos1.out", "messages.qos2.out")
MAX_TOPICS = 512                         # reference ?MAX_TOPICS


class TopicMetrics:
    def __init__(self, node, topics: Optional[list[str]] = None):
        self.node = node
        self._m: dict[str, dict[str, int]] = {}
        self._rates: dict[str, dict[str, float]] = {}
        self._last: dict[str, dict[str, int]] = {}
        self._last_ts = time.monotonic()
        for t in (topics if topics is not None
                  else node.config.get("topic_metrics") or []):
            self.register(t)

    def load(self) -> "TopicMetrics":
        self.node.hooks.add("message.publish", self.on_message_publish,
                            priority=-100, tag="topic_metrics")
        self.node.hooks.add("message.delivered", self.on_message_delivered,
                            tag="topic_metrics")
        self.node.hooks.add("message.dropped", self.on_message_dropped,
                            tag="topic_metrics")
        return self

    def unload(self) -> None:
        for h in ("message.publish", "message.delivered", "message.dropped"):
            self.node.hooks.delete(h, "topic_metrics")

    # ---- registry ----
    def register(self, topic: str) -> bool:
        if topic in self._m:
            return False
        if len(self._m) >= MAX_TOPICS:
            raise ValueError("quota_exceeded")
        self._m[topic] = {k: 0 for k in METRICS}
        self._last[topic] = {k: 0 for k in METRICS}
        self._rates[topic] = {k: 0.0 for k in METRICS}
        return True

    def deregister(self, topic: str) -> bool:
        ok = self._m.pop(topic, None) is not None
        self._last.pop(topic, None)
        self._rates.pop(topic, None)
        return ok

    def topics(self) -> list[str]:
        return list(self._m)

    def _inc(self, topic: str, metric: str, qos_metric: Optional[str] = None):
        for filt, counters in self._m.items():
            if T.match(topic, filt):
                counters[metric] += 1
                if qos_metric:
                    counters[qos_metric] += 1

    # ---- hooks ----
    def on_message_publish(self, msg: Message):
        self._inc(msg.topic, "messages.in", f"messages.qos{msg.qos}.in")
        return ("ok", msg)

    def on_message_delivered(self, clientid, msg: Message):
        self._inc(msg.topic, "messages.out", f"messages.qos{msg.qos}.out")

    def on_message_dropped(self, msg: Optional[Message], reason=None):
        if msg is not None:
            self._inc(msg.topic, "messages.dropped")

    # ---- rates ----
    def tick(self) -> None:
        now = time.monotonic()
        dt = max(now - self._last_ts, 1e-9)
        for t, counters in self._m.items():
            for k, v in counters.items():
                self._rates[t][k] = (v - self._last[t][k]) / dt
                self._last[t][k] = v
        self._last_ts = now

    def val(self, topic: str, metric: str) -> int:
        return self._m.get(topic, {}).get(metric, 0)

    def rate(self, topic: str, metric: str) -> float:
        return self._rates.get(topic, {}).get(metric, 0.0)

    def metrics(self, topic: Optional[str] = None) -> dict:
        if topic is not None:
            return dict(self._m.get(topic, {}))
        return {t: dict(c) for t, c in self._m.items()}
