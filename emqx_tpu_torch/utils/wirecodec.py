"""Shared JSON-safe wire encoding for binary-bearing structures.

One convention used by the cluster rpc plane, the bridge replay queue and
the persistence snapshots/WAL: bytes become {"$b": base64}, sets become
{"$set": [...]}. Changing the convention here changes it everywhere.
"""

from __future__ import annotations

import base64
from typing import Any


def enc(obj: Any) -> Any:
    """Deep-encode for json.dumps."""
    if isinstance(obj, (bytes, bytearray)):
        return {"$b": base64.b64encode(bytes(obj)).decode()}
    if isinstance(obj, dict):
        return {k: enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [enc(v) for v in obj]
    if isinstance(obj, set):
        return {"$set": [enc(v) for v in sorted(obj, key=repr)]}
    return obj


def dec(obj: Any) -> Any:
    """Deep-decode json.loads output."""
    if isinstance(obj, dict):
        if "$b" in obj and len(obj) == 1:
            return base64.b64decode(obj["$b"])
        if "$set" in obj and len(obj) == 1:
            return set(dec(v) for v in obj["$set"])
        return {k: dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [dec(v) for v in obj]
    return obj


def enc_default(o: Any) -> Any:
    """json.dumps(default=...) shim for shallow callers."""
    if isinstance(o, (bytes, bytearray)):
        return {"$b": base64.b64encode(bytes(o)).decode()}
    if isinstance(o, set):
        return sorted(o, key=repr)
    raise TypeError(repr(o))
