"""StatsD exporter.

Parity: apps/emqx_statsd — periodic UDP push of broker metrics (counters
as deltas `|c`) and stats (gauges `|g`) to a StatsD daemon. Pipeline
latency histograms ride as `|ms` timers: each flush sends the interval's
mean latency with a StatsD sample rate of 1/new_observations, so the
daemon reconstructs both magnitude and volume without one packet per
observation; ratio histograms (batch occupancy) flush as interval-mean
gauges. The final interval flushes on `unload()` — a stopping node no
longer silently drops its last deltas.
"""

from __future__ import annotations

import asyncio
import logging
import socket
from typing import Optional

log = logging.getLogger("emqx_tpu_torch.statsd")


class StatsdApp:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("statsd") or {})
        c.update(conf or {})
        self.host = c.get("host", "127.0.0.1")
        self.port = c.get("port", 8125)
        self.prefix = c.get("prefix", "emqx")
        self.interval = c.get("interval", 10.0)
        self.batch_bytes = c.get("batch_bytes", 1400)
        self._last: dict[str, int] = {}
        self._last_hist: dict[str, tuple[int, float]] = {}
        self._task: Optional[asyncio.Task] = None
        self._sock: Optional[socket.socket] = None

    def load(self) -> "StatsdApp":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self.node.statsd = self
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    def unload(self) -> None:
        if self._task:
            self._task.cancel()
        if self._sock:
            try:
                # final flush: the deltas accumulated since the last
                # interval tick must not vanish when the node stops
                self.flush()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("statsd final flush failed: %s", e)
            self._sock.close()
            self._sock = None
        if getattr(self.node, "statsd", None) is self:
            self.node.statsd = None

    def render(self) -> list[str]:
        """Metric lines for one flush: counter deltas + stat gauges."""
        lines = []
        for name, val in sorted(self.node.metrics.all().items()):
            delta = val - self._last.get(name, 0)
            self._last[name] = val
            if delta:
                lines.append(f"{self.prefix}.{name}:{delta}|c")
        for name, val in sorted(self.node.stats.sample().items()):
            lines.append(f"{self.prefix}.{name}:{val}|g")
        # histograms: latency-unit ones (pipeline stage spans) as |ms
        # timers — one sampled line per flush carrying the interval mean
        # with rate=1/new_count, so aggregate latency AND volume survive
        # the UDP budget (StatsD's documented sampling semantics);
        # ratio-unit ones (batch occupancy) as interval-mean gauges
        for name, h in sorted(self.node.metrics.histograms().items()):
            lc, ls = self._last_hist.get(name, (0, 0.0))
            dc, ds = h.count - lc, h.sum - ls
            self._last_hist[name] = (h.count, h.sum)
            if dc <= 0:
                continue
            if h.unit == "seconds":
                # clamp: >2M observations per interval would render as
                # the invalid zero rate |@0.000000
                rate = f"|@{max(1.0 / dc, 1e-6):.6f}" if dc > 1 else ""
                lines.append(
                    f"{self.prefix}.{name}:{ds / dc * 1000.0:.3f}|ms"
                    f"{rate}")
            else:
                lines.append(f"{self.prefix}.{name}:{ds / dc:.4f}|g")
        return lines

    def flush(self) -> int:
        """Send one batch now; returns datagrams sent."""
        if self._sock is None:
            return 0
        sent = 0
        batch: list[str] = []
        size = 0
        for line in self.render():
            if size + len(line) + 1 > self.batch_bytes and batch:
                self._send("\n".join(batch))
                sent += 1
                batch, size = [], 0
            batch.append(line)
            size += len(line) + 1
        if batch:
            self._send("\n".join(batch))
            sent += 1
        return sent

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode(), (self.host, self.port))
        except OSError as e:
            log.debug("statsd send failed: %s", e)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.flush()
