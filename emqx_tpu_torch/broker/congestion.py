"""Per-connection TCP send-queue congestion alarms.

Parity: apps/emqx/src/emqx_congestion.erl — alarm
`conn_congestion/<clientid>/<username>` is activated when the socket has
pending unsent bytes (send_pend > 0; here the asyncio transport write
buffer), re-armed on every congested observation, and deactivated only
after `min_alarm_sustain_duration` with no congestion (the WontClearIn
hysteresis so a flapping socket doesn't spam alarm churn).

The port's copy of ``emqx_tpu/broker/congestion.py``: each connection
builds one from its zone's ``conn_congestion`` and checks it on its
one-second timer tick.
"""

from __future__ import annotations

import time
from typing import Optional


class Congestion:
    REASON = "conn_congestion"

    def __init__(self, node, channel, writer, *,
                 enable_alarm: bool = False,
                 min_alarm_sustain_duration: float = 60.0):
        self.node = node
        self.channel = channel
        self.writer = writer
        self.enable = enable_alarm
        self.sustain = min_alarm_sustain_duration
        self._sent_at: Optional[float] = None    # last congested ts

    def _alarm_name(self) -> str:
        user = self.channel.clientinfo.get("username") or "unknown_user"
        return f"{self.REASON}/{self.channel.clientid}/{user}"

    def _details(self) -> dict:
        t = self.writer.transport
        return {"clientid": self.channel.clientid,
                "username": self.channel.clientinfo.get("username"),
                "peername": str(self.channel.conninfo.get("peername")),
                "conn_state": self.channel.conn_state,
                "send_pend": t.get_write_buffer_size()
                if t is not None else 0}

    def _congested(self) -> bool:
        t = self.writer.transport
        return t is not None and t.get_write_buffer_size() > 0

    def check(self) -> None:
        """One observation (called from the connection timer loop)."""
        if not self.enable:
            return
        if self._congested():
            self._sent_at = time.monotonic()
            # key on the global alarm table, not this object: another
            # connection's terminate sweep may have cleared our name
            if not self.node.alarms.is_active(self._alarm_name()):
                self.node.metrics.inc("connection.congested")
                self.node.alarms.activate(self._alarm_name(),
                                          self._details())
        elif self._sent_at is not None and \
                time.monotonic() - self._sent_at >= self.sustain:
            self.cancel()

    def cancel(self) -> None:
        """Deactivate if raised (also the connection-terminate sweep,
        emqx_congestion:cancel_alarms)."""
        if self._sent_at is not None:
            self._sent_at = None
            self.node.alarms.deactivate(self._alarm_name())
