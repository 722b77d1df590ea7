"""Per-rule metrics: matched / passed / failed counters + rolling speed.

Parity: emqx_rule_metrics.erl — per-rule counters (sql.matched, sql.passed,
sql.failed, sql.failed.exception, sql.failed.no_result, actions.success,
actions.error) and a speed gauge (current / max / last5m) computed by a
periodic tick over the matched counter.

The port's copy of ``emqx_tpu/rules/metrics.py``.
"""

from __future__ import annotations

import time


class RuleMetrics:
    TICK_S = 1.0

    def __init__(self):
        self.counters: dict[str, int] = {}
        self._last_matched = 0
        self._last_tick = time.monotonic()
        self.speed = 0.0
        self.speed_max = 0.0
        self._window: list[float] = []   # last-5m samples

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def val(self, name: str) -> int:
        return self.counters.get(name, 0)

    def tick(self) -> None:
        now = time.monotonic()
        dt = now - self._last_tick
        if dt <= 0:
            return
        matched = self.val("sql.matched")
        self.speed = (matched - self._last_matched) / dt
        self.speed_max = max(self.speed_max, self.speed)
        self._window.append(self.speed)
        if len(self._window) > 300:
            self._window.pop(0)
        self._last_matched = matched
        self._last_tick = now

    @property
    def speed_last5m(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0

    def to_map(self) -> dict:
        return {**self.counters,
                "speed": {"current": round(self.speed, 2),
                          "max": round(self.speed_max, 2),
                          "last5m": round(self.speed_last5m, 2)}}
