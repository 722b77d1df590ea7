"""The JSON codec of the durable state: bytes as ``{"$b": base64}``.

The port's copy of the codec in ``emqx_tpu/broker/persistence.py``
(:32-60), which the retainer's disc journal (``apps/retainer.DiscStorage``)
writes and reads; a journal written by either package reads in the
other. The rest of that module (the snapshot and write-ahead log of
retained, delayed and route state, ``Persistence``) is ROADMAP.md Queue A
item 20(c).
"""

from __future__ import annotations

import base64


def _enc(o):
    if isinstance(o, (bytes, bytearray)):
        return {"$b": base64.b64encode(bytes(o)).decode()}
    raise TypeError(repr(o))


def _dec(v):
    if isinstance(v, dict) and "$b" in v:
        return base64.b64decode(v["$b"])
    return v


def _dec_deep(o):
    if isinstance(o, dict):
        if "$b" in o and len(o) == 1:
            return _dec(o)
        return {k: _dec_deep(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_dec_deep(v) for v in o]
    return o
