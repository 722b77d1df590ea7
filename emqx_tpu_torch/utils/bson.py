"""Minimal BSON encode/decode for the MongoDB connector.

Parity note: the reference reaches MongoDB through the mongodb Erlang
client (apps/emqx_connector/src/emqx_connector_mongo.erl); the port
depends on no Python MongoDB client, so the wire format is implemented
directly. Covers the types MQTT authn/authz documents use: document,
array, utf8 string, int32/int64, double, bool, null, binary, ObjectId
(passed through as 12 raw bytes), UTC datetime (as int ms).

The port's copy of ``emqx_tpu/utils/bson.py``.
"""

from __future__ import annotations

import struct
from typing import Any

_E_DOUBLE = 0x01
_E_STRING = 0x02
_E_DOC = 0x03
_E_ARRAY = 0x04
_E_BINARY = 0x05
_E_OBJECTID = 0x07
_E_BOOL = 0x08
_E_DATETIME = 0x09
_E_NULL = 0x0A
_E_INT32 = 0x10
_E_INT64 = 0x12


class ObjectId:
    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId must be 12 bytes")
        self.raw = raw

    def __eq__(self, other):
        return isinstance(other, ObjectId) and other.raw == self.raw

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self):
        return f"ObjectId({self.raw.hex()})"


def _encode_value(key: str, val: Any) -> bytes:
    kb = key.encode() + b"\x00"
    if isinstance(val, bool):
        return bytes([_E_BOOL]) + kb + (b"\x01" if val else b"\x00")
    if isinstance(val, int):
        if -(1 << 31) <= val < (1 << 31):
            return bytes([_E_INT32]) + kb + struct.pack("<i", val)
        return bytes([_E_INT64]) + kb + struct.pack("<q", val)
    if isinstance(val, float):
        return bytes([_E_DOUBLE]) + kb + struct.pack("<d", val)
    if isinstance(val, str):
        sb = val.encode()
        return bytes([_E_STRING]) + kb + \
            struct.pack("<i", len(sb) + 1) + sb + b"\x00"
    if val is None:
        return bytes([_E_NULL]) + kb
    if isinstance(val, (bytes, bytearray)):
        return bytes([_E_BINARY]) + kb + \
            struct.pack("<i", len(val)) + b"\x00" + bytes(val)
    if isinstance(val, ObjectId):
        return bytes([_E_OBJECTID]) + kb + val.raw
    if isinstance(val, dict):
        return bytes([_E_DOC]) + kb + encode(val)
    if isinstance(val, (list, tuple)):
        doc = {str(i): v for i, v in enumerate(val)}
        return bytes([_E_ARRAY]) + kb + encode(doc)
    raise TypeError(f"cannot BSON-encode {type(val).__name__}")


def encode(doc: dict) -> bytes:
    body = b"".join(_encode_value(str(k), v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _decode_value(etype: int, data: bytes, pos: int) -> tuple[Any, int]:
    if etype == _E_DOUBLE:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if etype == _E_STRING:
        n = struct.unpack_from("<i", data, pos)[0]
        s = data[pos + 4:pos + 4 + n - 1].decode()
        return s, pos + 4 + n
    if etype in (_E_DOC, _E_ARRAY):
        n = struct.unpack_from("<i", data, pos)[0]
        sub, _ = _decode_doc(data[pos:pos + n])
        if etype == _E_ARRAY:
            return [sub[str(i)] for i in range(len(sub))], pos + n
        return sub, pos + n
    if etype == _E_BINARY:
        n = struct.unpack_from("<i", data, pos)[0]
        return bytes(data[pos + 5:pos + 5 + n]), pos + 5 + n
    if etype == _E_OBJECTID:
        return ObjectId(bytes(data[pos:pos + 12])), pos + 12
    if etype == _E_BOOL:
        return data[pos] != 0, pos + 1
    if etype == _E_DATETIME:
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    if etype == _E_NULL:
        return None, pos
    if etype == _E_INT32:
        return struct.unpack_from("<i", data, pos)[0], pos + 4
    if etype == _E_INT64:
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    raise ValueError(f"unsupported BSON element type 0x{etype:02x}")


def _decode_doc(data: bytes) -> tuple[dict, int]:
    total = struct.unpack_from("<i", data, 0)[0]
    pos = 4
    out: dict = {}
    while pos < total - 1:
        etype = data[pos]
        pos += 1
        end = data.index(b"\x00", pos)
        key = data[pos:end].decode()
        pos = end + 1
        out[key], pos = _decode_value(etype, data, pos)
    return out, total


def decode(data: bytes) -> dict:
    doc, _ = _decode_doc(data)
    return doc
