"""MQTT packet model: one dataclass per control packet type.

Properties are plain dicts keyed by snake_case names from
`emqx_tpu_torch.mqtt.constants.PROPERTIES`; `user_property` holds a list of
(key, value) string pairs; `subscription_identifier` may repeat and holds a
list of ints in parsed packets.

Parity: reference emqx_packet.erl / include/emqx_mqtt.hrl record shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.mqtt import constants as C

__all__ = [
    "Packet", "Connect", "Connack", "Publish", "Puback", "Pubrec", "Pubrel",
    "Pubcomp", "Subscribe", "Suback", "Unsubscribe", "Unsuback", "Pingreq",
    "Pingresp", "Disconnect", "Auth", "SubOpts", "Will",
]


@dataclass
class SubOpts:
    """Per-filter subscription options (v5; v3 uses qos only).

    rh: retain handling 0|1|2, rap: retain-as-published, nl: no-local.
    """
    qos: int = 0
    nl: int = 0
    rap: int = 0
    rh: int = 0

    def to_byte(self) -> int:
        return (self.qos & 0x3) | (self.nl << 2) | (self.rap << 3) | ((self.rh & 0x3) << 4)

    @classmethod
    def from_byte(cls, b: int) -> "SubOpts":
        return cls(qos=b & 0x3, nl=(b >> 2) & 1, rap=(b >> 3) & 1, rh=(b >> 4) & 0x3)


@dataclass
class Will:
    topic: str = ""
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    properties: dict = field(default_factory=dict)


class Packet:
    """Base class; `type` is the MQTT control packet type number."""
    type: int = C.RESERVED

    @property
    def type_name(self) -> str:
        return C.PACKET_TYPE_NAMES.get(self.type, f"UNKNOWN({self.type})")


@dataclass
class Connect(Packet):
    proto_name: str = "MQTT"
    proto_ver: int = C.MQTT_V4
    clean_start: bool = True
    keepalive: int = 0
    clientid: str = ""
    will: Optional[Will] = None
    username: Optional[str] = None
    password: Optional[bytes] = None
    properties: dict = field(default_factory=dict)
    type = C.CONNECT


@dataclass
class Connack(Packet):
    session_present: bool = False
    reason_code: int = C.RC_SUCCESS
    properties: dict = field(default_factory=dict)
    type = C.CONNACK


@dataclass
class Publish(Packet):
    topic: str = ""
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None
    properties: dict = field(default_factory=dict)
    type = C.PUBLISH
    # ingress stamp: perf_counter_ns at frame decode, set by FrameParser
    # on inbound PUBLISHes. A plain class attribute, not a dataclass
    # field: every packet answers 0 at no per-instance cost, and equality
    # and repr are untouched.
    ingress_ns = 0


@dataclass
class _PubAckBase(Packet):
    packet_id: int = 0
    reason_code: int = C.RC_SUCCESS
    properties: dict = field(default_factory=dict)


@dataclass
class Puback(_PubAckBase):
    type = C.PUBACK


@dataclass
class Pubrec(_PubAckBase):
    type = C.PUBREC


@dataclass
class Pubrel(_PubAckBase):
    type = C.PUBREL


@dataclass
class Pubcomp(_PubAckBase):
    type = C.PUBCOMP


@dataclass
class Subscribe(Packet):
    packet_id: int = 0
    # list of (topic_filter, SubOpts)
    filters: list = field(default_factory=list)
    properties: dict = field(default_factory=dict)
    type = C.SUBSCRIBE


@dataclass
class Suback(Packet):
    packet_id: int = 0
    reason_codes: list = field(default_factory=list)
    properties: dict = field(default_factory=dict)
    type = C.SUBACK


@dataclass
class Unsubscribe(Packet):
    packet_id: int = 0
    filters: list = field(default_factory=list)
    properties: dict = field(default_factory=dict)
    type = C.UNSUBSCRIBE


@dataclass
class Unsuback(Packet):
    packet_id: int = 0
    reason_codes: list = field(default_factory=list)
    properties: dict = field(default_factory=dict)
    type = C.UNSUBACK


@dataclass
class Pingreq(Packet):
    type = C.PINGREQ


@dataclass
class Pingresp(Packet):
    type = C.PINGRESP


@dataclass
class Disconnect(Packet):
    reason_code: int = C.RC_NORMAL_DISCONNECTION
    properties: dict = field(default_factory=dict)
    type = C.DISCONNECT


@dataclass
class Auth(Packet):
    reason_code: int = C.RC_SUCCESS
    properties: dict = field(default_factory=dict)
    type = C.AUTH
