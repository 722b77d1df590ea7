"""Resource instance manager.

Parity: emqx_resource_instance.erl — create/remove instances by resource
type, periodic health checks flipping connected/disconnected status,
restart of unhealthy instances; plus the rule-engine action surface the
data-bridge app exposes (actions `data_to_<type>` resolving to an instance,
emqx_rule_actions data_to_* via resources).

The port's copy of ``emqx_tpu/resources/resource.py``: ``HttpResource``
over the port's ``utils/http.py``, ``MqttResource`` over the port's
``client.py``. ``Node.stop_listeners`` stops the health loop and
removes every instance.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Callable, Optional

log = logging.getLogger("emqx_tpu_torch.resources")


class Resource:
    """Behaviour: subclasses implement start/stop/health_check/query."""

    TYPE = "abstract"

    def __init__(self, rid: str, conf: dict):
        self.id = rid
        self.conf = conf
        self.status = "stopped"       # stopped|connected|disconnected
        self.last_error: Optional[str] = None

    async def start(self) -> None: ...

    async def stop(self) -> None: ...

    async def health_check(self) -> bool:
        return True

    async def query(self, request: Any) -> Any:
        raise NotImplementedError

    def info(self) -> dict:
        return {"id": self.id, "type": self.TYPE, "status": self.status,
                "last_error": self.last_error}


class HttpResource(Resource):
    """HTTP webhook connector (emqx_connector_http over ehttpc)."""

    TYPE = "http"

    async def start(self) -> None:
        self.status = "connected" if await self.health_check() \
            else "disconnected"

    async def health_check(self) -> bool:
        from emqx_tpu_torch.utils.http import request
        try:
            url = self.conf.get("health_url") or self.conf["url"]
            resp = await request("GET", url, timeout=3)
            ok = resp.status < 500
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            ok = False
        return ok

    async def query(self, request_body: Any) -> Any:
        from emqx_tpu_torch.utils.http import request
        body = request_body if isinstance(request_body, (bytes, str)) \
            else json.dumps(request_body)
        if isinstance(body, str):
            body = body.encode()
        return await request(
            self.conf.get("method", "POST"), self.conf["url"],
            headers=dict(self.conf.get("headers")
                         or {"content-type": "application/json"}),
            body=body, timeout=self.conf.get("timeout", 5))


class MqttResource(Resource):
    """Remote MQTT connection (emqx_connector_mqtt via emqtt)."""

    TYPE = "mqtt"

    def __init__(self, rid: str, conf: dict):
        super().__init__(rid, conf)
        self.client = None

    async def start(self) -> None:
        from emqx_tpu_torch.client import Client
        self.client = Client(
            host=self.conf.get("host", "127.0.0.1"),
            port=self.conf.get("port", 1883),
            clientid=self.conf.get("clientid", f"resource-{self.id}"),
            username=self.conf.get("username"),
            password=self.conf.get("password"))
        try:
            await self.client.connect()
            self.status = "connected"
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            self.status = "disconnected"

    async def stop(self) -> None:
        if self.client is not None and self.status == "connected":
            try:
                await self.client.disconnect()
            except Exception:  # noqa: BLE001
                pass
        self.status = "stopped"

    async def health_check(self) -> bool:
        if self.client is None or self.status != "connected":
            return False
        try:
            await self.client.ping()
            return True
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            return False

    async def query(self, request: Any) -> Any:
        """request: {"topic":..., "payload":..., "qos":...}"""
        await self.client.publish(request["topic"],
                                  request.get("payload", b""),
                                  qos=request.get("qos", 0),
                                  retain=request.get("retain", False))
        return True


class ResourceManager:
    RESOURCE_TYPES: dict[str, Callable[..., Resource]] = {
        "http": HttpResource,
        "mqtt": MqttResource,
    }

    def __init__(self, node, health_interval: float = 15.0):
        self.node = node
        self.health_interval = health_interval
        self.instances: dict[str, Resource] = {}
        self._health_task: Optional[asyncio.Task] = None
        node.resources = self

    @classmethod
    def register_type(cls, name: str,
                      factory: Callable[..., Resource]) -> None:
        cls.RESOURCE_TYPES[name] = factory

    async def create(self, rid: str, rtype: str, conf: dict) -> Resource:
        if rid in self.instances:
            raise ValueError(f"resource {rid} exists")
        factory = self.RESOURCE_TYPES.get(rtype)
        if factory is None:
            raise ValueError(f"unknown resource type {rtype}")
        res = factory(rid, conf)
        await res.start()
        self.instances[rid] = res
        return res

    async def remove(self, rid: str) -> bool:
        res = self.instances.pop(rid, None)
        if res is None:
            return False
        await res.stop()
        return True

    def get(self, rid: str) -> Optional[Resource]:
        return self.instances.get(rid)

    def list(self) -> list[dict]:
        return [r.info() for r in self.instances.values()]

    # ---- health loop (emqx_resource_instance periodic health_check) ----
    def start_health_checks(self) -> None:
        if self._health_task is None:
            self._health_task = asyncio.get_running_loop().create_task(
                self._health_loop())

    def stop_health_checks(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.health_interval)
            for res in list(self.instances.values()):
                await self._check_one(res)

    async def _check_one(self, res: Resource) -> None:
        healthy = await res.health_check()
        if healthy:
            res.status = "connected"
            return
        if res.status == "connected":
            res.status = "disconnected"
            log.warning("resource %s became unhealthy: %s", res.id,
                        res.last_error)
        # restart attempt (auto_retry_interval behavior)
        try:
            await res.stop()
            await res.start()
        except Exception as e:  # noqa: BLE001
            res.last_error = str(e)

    # ---- rule-engine action surface (emqx_rule_actions data_to_*) ----
    def has_action(self, name: str) -> bool:
        return name.startswith("data_to_") and \
            name[len("data_to_"):] in self.instances

    def run_action(self, name: str, params: dict, columns: dict,
                   envs: dict) -> Any:
        from emqx_tpu_torch.rules.actions import render_template
        rid = name[len("data_to_"):]
        res = self.instances.get(rid)
        if res is None:
            raise ValueError(f"no resource instance {rid}")
        if res.TYPE == "mqtt":
            req = {"topic": render_template(
                       params.get("target_topic", "${topic}"), columns),
                   "payload": render_template(
                       params.get("payload_tmpl", "${payload}"),
                       columns).encode(),
                   "qos": int(params.get("qos", 0))}
        else:
            tmpl = params.get("payload_tmpl")
            req = render_template(tmpl, columns) if tmpl \
                else json.dumps(columns, default=str)
        task = asyncio.ensure_future(res.query(req))
        task.add_done_callback(_log_query_error)
        return True


def _log_query_error(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        log.warning("resource query failed: %s", task.exception())
