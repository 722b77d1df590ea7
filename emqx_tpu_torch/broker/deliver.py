"""Delivery constants the device engine's consume path reads.

The port's copy of ``OPT_TABLE`` from ``emqx_tpu/broker/deliver.py``
(:73-87). The session-affine delivery lanes (``DeliveryLanePool``, its
plans, ``DEFERRED`` and ``LaneCounts``) are not part of the port: delivery
is inline (``broker.deliver_lanes = 0``).
"""

from __future__ import annotations


def _unpack_opts(b: int) -> dict:
    return {"qos": b & 0x3, "nl": (b >> 2) & 1, "rap": (b >> 3) & 1,
            "rh": (b >> 4) & 0x3}


# The packed subopts word is 6 bits (qos:2 | nl:1 | rap:1 | rh:2), so
# there are exactly 64 distinct unpacked dicts — precompute them all
# once instead of re-unpacking per delivery. CONTRACT: these dicts are
# FROZEN — consumers copy before planting one into a delivered message.
OPT_TABLE = tuple(_unpack_opts(b) for b in range(64))
