"""Gateway registry: load/unload/list gateway instances.

Parity: emqx_gateway_registry.erl + emqx_gateway.erl — named gateway types
register a loader; instances are started with a config and tracked for the
mgmt surface (`GET /gateway`, `gateway` CLI).
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class GatewayRegistry:
    def __init__(self, node):
        self.node = node
        self._types: dict[str, Callable] = {}
        self._instances: dict[str, Any] = {}
        node.gateway_registry = self

    def register_type(self, name: str, loader: Callable) -> None:
        """loader(node, conf) -> gateway instance with async start/stop."""
        self._types[name] = loader

    async def load(self, name: str, conf: Optional[dict] = None) -> Any:
        if name in self._instances:
            raise ValueError(f"gateway {name} already loaded")
        loader = self._types.get(name)
        if loader is None:
            raise ValueError(f"unknown gateway type {name}")
        gw = loader(self.node, conf or {})
        await gw.start()
        self._instances[name] = gw
        return gw

    async def unload(self, name: str) -> bool:
        gw = self._instances.pop(name, None)
        if gw is None:
            return False
        await gw.stop()
        return True

    def lookup(self, name: str) -> Optional[Any]:
        return self._instances.get(name)

    def list(self) -> list[dict]:
        return [{"name": n, "status": "running",
                 **(gw.info() if hasattr(gw, "info") else {})}
                for n, gw in sorted(self._instances.items())]

    @staticmethod
    def with_builtins(node) -> "GatewayRegistry":
        reg = GatewayRegistry(node)
        from emqx_tpu_torch.gateway.coap import CoapGateway
        from emqx_tpu_torch.gateway.lwm2m import Lwm2mGateway
        from emqx_tpu_torch.gateway.mqttsn import MqttSnGateway
        from emqx_tpu_torch.gateway.stomp import StompGateway
        reg.register_type("stomp", lambda n, c: StompGateway(n, c))
        reg.register_type("mqttsn", lambda n, c: MqttSnGateway(n, c))
        reg.register_type("coap", lambda n, c: CoapGateway(n, c))
        reg.register_type("lwm2m", lambda n, c: Lwm2mGateway(n, c))
        try:
            from emqx_tpu_torch.gateway.exproto import ExprotoGateway
            reg.register_type("exproto", lambda n, c: ExprotoGateway(n, c))
        except ImportError:
            pass   # grpc not available in this image profile
        return reg
