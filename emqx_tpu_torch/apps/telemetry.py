"""Telemetry reporter.

Parity: apps/emqx_modules/src/emqx_telemetry.erl — periodic anonymized
usage report (uuid, version, license/edition, os info, nodes/active
plugins/metrics totals) posted to a collection endpoint; opt-in gated and
disabled by default, with the report inspectable locally (`get_telemetry`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import platform
import uuid
from typing import Optional

from emqx_tpu_torch.version import __version__

log = logging.getLogger("emqx_tpu_torch.telemetry")

DEFAULT_INTERVAL_S = 7 * 24 * 3600


class Telemetry:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("telemetry") or {})
        c.update(conf or {})
        self.enabled = bool(c.get("enable", False))
        self.url = c.get("url")
        self.interval = c.get("interval", DEFAULT_INTERVAL_S)
        self.uuid = c.get("uuid") or str(uuid.uuid4())
        self._task: Optional[asyncio.Task] = None

    def load(self) -> "Telemetry":
        self.node.telemetry = self
        if self.enabled and self.url:
            self._task = asyncio.get_running_loop().create_task(
                self._loop())
        return self

    def unload(self) -> None:
        if self._task:
            self._task.cancel()
        if getattr(self.node, "telemetry", None) is self:
            self.node.telemetry = None

    def get_telemetry(self) -> dict:
        """The report body (emqx_telemetry:get_telemetry/0)."""
        node = self.node
        active_plugins = []
        plugins = getattr(node, "plugins", None)
        if plugins is not None:
            active_plugins = [p["name"] for p in plugins.list()
                              if p["enabled"]]
        m = node.metrics
        return {
            "emqx_version": __version__,
            "license": {"edition": "opensource"},
            "uuid": self.uuid,
            "os_name": platform.system(),
            "os_version": platform.release(),
            "otp_version": platform.python_version(),
            "nodes_uuid": [],
            "active_plugins": active_plugins,
            "num_clients": node.cm.count(),
            "messages_received": m.val("messages.received"),
            "messages_sent": m.val("messages.sent"),
        }

    async def report_once(self) -> bool:
        if not self.url:
            return False
        from emqx_tpu_torch.utils.http import request
        try:
            resp = await request(
                "POST", self.url,
                headers={"content-type": "application/json"},
                body=json.dumps(self.get_telemetry()).encode(),
                timeout=10)
            return resp.status < 300
        except Exception as e:  # noqa: BLE001
            log.debug("telemetry report failed: %s", e)
            return False

    async def _loop(self) -> None:
        while True:
            await self.report_once()
            await asyncio.sleep(self.interval)
