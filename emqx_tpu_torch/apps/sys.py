"""$SYS broker: periodic heartbeat/stats/metrics publishes + alarm topics.

Parity: apps/emqx/src/emqx_sys.erl — `$SYS/brokers` node list,
`$SYS/brokers/<node>/{version,uptime,datetime,sysdescr}` heartbeats
(emqx_sys.erl:56-67,83-91), `$SYS/brokers/<node>/stats/<name>` and
`.../metrics/<name>` interval publishes; alarm transitions republished on
`$SYS/brokers/<node>/alarms/{activate,deactivate}` (emqx_alarm handler).
The port's copy of ``emqx_tpu/apps/sys.py``; ``start_apps`` does not
boot it, as in the reference.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from emqx_tpu_torch.broker.message import make
from emqx_tpu_torch.version import __version__


class SysBroker:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("broker") or {})
        c.update(conf or {})
        self.heartbeat_interval = float(c.get("sys_heartbeat_interval", 30))
        self.msg_interval = float(c.get("sys_msg_interval", 60))
        self.started_at = time.monotonic()
        self._last_heartbeat = 0.0
        self._last_msg = 0.0

    def load(self) -> "SysBroker":
        self.node.hooks.add("alarm.activated", self.on_alarm_activated,
                            tag="sys")
        self.node.hooks.add("alarm.deactivated", self.on_alarm_deactivated,
                            tag="sys")
        return self

    def unload(self) -> None:
        self.node.hooks.delete("alarm.activated", "sys")
        self.node.hooks.delete("alarm.deactivated", "sys")

    # ---- publishing ----
    def _pub(self, suffix: str, payload: bytes) -> None:
        self.node.broker.publish(make(
            "", 0, f"$SYS/brokers/{self.node.name}/{suffix}", payload,
            flags={"sys": True}))

    def uptime(self) -> float:
        return time.monotonic() - self.started_at

    def publish_heartbeat(self) -> None:
        self.node.broker.publish(make(
            "", 0, "$SYS/brokers", self.node.name.encode(),
            flags={"sys": True}))
        self._pub("version", __version__.encode())
        self._pub("uptime", str(int(self.uptime())).encode())
        self._pub("datetime",
                  time.strftime("%Y-%m-%d %H:%M:%S").encode())
        self._pub("sysdescr", b"emqx_tpu broker")

    def publish_stats_metrics(self) -> None:
        for name, val in self.node.stats.sample().items():
            self._pub(f"stats/{name}", str(val).encode())
        for name, val in self.node.metrics.all().items():
            self._pub(f"metrics/{name}", str(val).encode())
        self.publish_pipeline()

    def publish_pipeline(self) -> None:
        """$SYS/brokers/<node>/pipeline/# — the device-path telemetry
        snapshot, piecewise: one JSON payload per stage
        (`pipeline/stages/<stage>`), per occupancy class
        (`pipeline/occupancy/<class>`), plus `pipeline/compiles`,
        `pipeline/decisions` and — when the relevant layer has traffic —
        `pipeline/match_cache` / `pipeline/dedup` / `pipeline/readback`
        (dense-vs-compact device→host transfer bytes) /
        `pipeline/rebuild` / `pipeline/deliver` (delivery-lane egress
        stage) / `pipeline/supervise` (fault-domain
        supervision: breaker states, ladder rung) /
        `pipeline/trace` (window-causal flight recorder: ring state +
        dispatch↔materialize overlap + bubble attribution) /
        `pipeline/ingress` (columnar PUBLISH ingress: burst sizes,
        columnar-vs-fallback frames, per-acceptor-lane accepts) /
        `pipeline/memory` (HBM ledger: per-category device bytes, pin
        ages, the allocator cross-check) /
        `pipeline/program_costs` (jit-program cost registry: compile
        wall per class, where the snapshot has it) /
        `pipeline/latency` (end-to-end latency SLO observatory:
        per-(qos, path) ingress→routed / ingress→delivered
        percentiles, SLO burn rates, breach exemplars) /
        `pipeline/overload` (adaptive overload governor: grade, armed
        shed actions, signal readings, shed counters). A section the
        port's snapshot does not hold is not published."""
        tele = getattr(self.node, "pipeline_telemetry", None)
        if tele is None:
            return
        snap = tele.snapshot()
        for stage, row in snap["stages"].items():
            self._pub(f"pipeline/stages/{stage}",
                      json.dumps(row).encode())
        for cls, row in snap["occupancy"].items():
            self._pub(f"pipeline/occupancy/{cls}",
                      json.dumps(row).encode())
        self._pub("pipeline/compiles",
                  json.dumps(snap["compiles"]).encode())
        self._pub("pipeline/decisions",
                  json.dumps(snap["decisions"]).encode())
        for section in ("match_cache", "dedup", "readback", "rebuild",
                        "deliver", "supervise", "trace", "ingress",
                        "memory", "program_costs", "latency",
                        "overload"):
            if section in snap:
                self._pub(f"pipeline/{section}",
                          json.dumps(snap[section]).encode())

    # ---- alarms → $SYS ----
    def on_alarm_activated(self, alarm: dict) -> None:
        self._pub("alarms/activate", json.dumps(alarm).encode())

    def on_alarm_deactivated(self, alarm: dict) -> None:
        self._pub("alarms/deactivate", json.dumps(alarm).encode())

    # ---- timer (Node.sweep) ----
    def tick(self) -> None:
        now = time.monotonic()
        if now - self._last_heartbeat >= self.heartbeat_interval:
            self._last_heartbeat = now
            self.publish_heartbeat()
        if now - self._last_msg >= self.msg_interval:
            self._last_msg = now
            self.publish_stats_metrics()

    def info(self) -> dict:
        """emqx_mgmt broker info surface."""
        return {"node": self.node.name, "version": __version__,
                "uptime": int(self.uptime()),
                "datetime": time.strftime("%Y-%m-%d %H:%M:%S"),
                "sysdescr": "emqx_tpu broker"}
