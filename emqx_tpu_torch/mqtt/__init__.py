"""MQTT wire protocol: packet model, v3.1/v3.1.1/v5 codec, properties.

Parity targets in the reference: emqx_frame.erl (streaming parse/serialize),
emqx_packet.erl (packet helpers), emqx_mqtt_props.erl (v5 property tables),
emqx_reason_codes.erl (reason codes).

The port's own copy of ``emqx_tpu/mqtt``: the per-packet parse and
serialize path, and the columnar ingress path (``FrameParser.feed_columnar``:
the native burst scan and decode of ``emqx_tpu_torch/native.py`` into
``PublishBurst`` rows), with the ingress clock stamps.
"""

from emqx_tpu_torch.mqtt.constants import *  # noqa: F401,F403
from emqx_tpu_torch.mqtt.packet import *  # noqa: F401,F403
from emqx_tpu_torch.mqtt.frame import (FrameError, FrameParser,  # noqa: F401
                                       PublishBurst, serialize)
