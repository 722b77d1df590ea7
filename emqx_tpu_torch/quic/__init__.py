"""QUIC v1 transport (RFC 9000/9001) with a built-in TLS 1.3 handshake.

Parity: the reference's quicer/msquic listener stack
(apps/emqx/src/emqx_quic_connection.erl, emqx_quic_stream.erl — thin
adapters over the msquic C library). No QUIC library exists in this
environment, so the transport is implemented directly over asyncio UDP +
the `cryptography` primitives: tls13.py (handshake engine), packet.py
(varints, header/packet protection), frames.py (frame codec),
connection.py (server endpoint feeding the broker Channel per stream),
client.py (test/bridge client). Scope: v1, TLS_AES_128_GCM_SHA256,
x25519, loss-free paths (immediate ACKs, no congestion controller) —
the deployment target is MQTT-over-QUIC on low-loss links; recovery is
layered in connection.py where datagram loss matters.

The port's copy of ``emqx_tpu/quic/__init__.py``: the same constants
and behaviour, with its imports pointed at ``emqx_tpu_torch``.
"""

from emqx_tpu_torch.quic.client import QuicClientConnection   # noqa: F401
from emqx_tpu_torch.quic.connection import QuicListener       # noqa: F401

