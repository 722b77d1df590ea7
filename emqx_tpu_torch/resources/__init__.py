"""Resources: generic external-service instances + connectors + bridges.

Parity: apps/emqx_resource (instance lifecycle: create/health-check/
restart, emqx_resource_instance.erl), apps/emqx_connector (http/mqtt
connectors over pools), apps/emqx_data_bridge (named bridges as resources),
apps/emqx_bridge_mqtt (bridge worker FSM with replayq buffering).

The port's copy of ``emqx_tpu/resources``.
"""

from emqx_tpu_torch.resources.bridge_mqtt import MqttBridgeWorker
from emqx_tpu_torch.resources.resource import ResourceManager

__all__ = ["ResourceManager", "MqttBridgeWorker"]
