"""Gateways: non-MQTT protocol front-ends over the core pubsub engine.

Parity: apps/emqx_gateway — the behaviours (bhvrs/emqx_gateway_channel.erl,
emqx_gateway_frame.erl, emqx_gateway_conn.erl), the insulation context
(emqx_gateway_ctx.erl) brokering authn + pubsub into the core, the registry
(emqx_gateway_registry.erl), and the gateways themselves: STOMP (src/stomp),
MQTT-SN (src/mqttsn), CoAP (src/coap), LwM2M (src/lwm2m), exproto
(src/exproto, gRPC).
"""

from emqx_tpu_torch.gateway.ctx import GatewayCtx
from emqx_tpu_torch.gateway.registry import GatewayRegistry

__all__ = ["GatewayCtx", "GatewayRegistry"]
