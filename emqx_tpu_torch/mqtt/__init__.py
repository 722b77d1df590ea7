"""MQTT wire protocol: packet model, v3.1/v3.1.1/v5 codec, properties.

Parity targets in the reference: emqx_frame.erl (streaming parse/serialize),
emqx_packet.erl (packet helpers), emqx_mqtt_props.erl (v5 property tables),
emqx_reason_codes.erl (reason codes).

The port's own copy of ``emqx_tpu/mqtt``: the pure-Python parse and
serialize path only (no native burst decode, no columnar PUBLISH bursts,
no ingress clock stamps).
"""

from emqx_tpu_torch.mqtt.constants import *  # noqa: F401,F403
from emqx_tpu_torch.mqtt.packet import *  # noqa: F401,F403
from emqx_tpu_torch.mqtt.frame import FrameParser, serialize, FrameError  # noqa: F401
