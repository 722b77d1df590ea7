"""LDAP v3 connector: minimal BER codec + asyncio client.

Parity: apps/emqx_connector/src/emqx_connector_ldap.erl (eldap). Covers
what broker integrations use: simple bind, equality/present search with
AND conjunctions, unbind — RFC 4511 over BER with definite lengths.

The port's copy of ``emqx_tpu/connectors/ldap.py``.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Union

# application tags
AP_BIND_REQ, AP_BIND_RESP = 0, 1
AP_UNBIND = 2
AP_SEARCH_REQ, AP_SEARCH_ENTRY, AP_SEARCH_DONE = 3, 4, 5

SCOPE_BASE, SCOPE_ONE, SCOPE_SUB = 0, 1, 2


class LdapError(Exception):
    def __init__(self, code: int, message: str = ""):
        self.code = code
        super().__init__(f"ldap error {code}: {message}")


# ---------------------------------------------------------------------------
# BER (definite length)
# ---------------------------------------------------------------------------

def _len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def tlv(tag: int, body: bytes) -> bytes:
    return bytes([tag]) + _len(len(body)) + body


def ber_int(v: int, tag: int = 0x02) -> bytes:
    if v == 0:
        return tlv(tag, b"\x00")
    out = v.to_bytes((v.bit_length() // 8) + 1, "big")
    return tlv(tag, out)


def ber_str(s: Union[str, bytes], tag: int = 0x04) -> bytes:
    return tlv(tag, s if isinstance(s, bytes) else s.encode())


def ber_bool(v: bool) -> bytes:
    return tlv(0x01, b"\xff" if v else b"\x00")


def ber_seq(*parts: bytes) -> bytes:
    return tlv(0x30, b"".join(parts))


def read_tlv(data: bytes, pos: int) -> tuple[int, bytes, int]:
    """-> (tag, body, next_pos)."""
    tag = data[pos]
    ln = data[pos + 1]
    pos += 2
    if ln & 0x80:
        n = ln & 0x7F
        ln = int.from_bytes(data[pos:pos + n], "big")
        pos += n
    return tag, data[pos:pos + ln], pos + ln


def read_int(body: bytes) -> int:
    return int.from_bytes(body, "big", signed=True)


# filter constructors (the subset authn/authz templates produce)
def f_eq(attr: str, value: str) -> bytes:
    return tlv(0xA3, ber_str(attr) + ber_str(value))


def f_present(attr: str) -> bytes:
    return ber_str(attr, tag=0x87)


def f_and(*filters: bytes) -> bytes:
    return tlv(0xA0, b"".join(filters))


class LdapClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 389,
                 bind_dn: str = "", bind_password: str = "", ssl=None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.bind_dn = bind_dn
        self.bind_password = bind_password
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None
        self._mid = 0

    async def connect(self) -> None:
        self._r, self._w = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=self.ssl),
            self.connect_timeout)
        try:
            await self.bind(self.bind_dn, self.bind_password)
        except BaseException:
            # a failed bind must not leak the socket (pool retries would
            # pile up half-open server sessions)
            self._w.close()
            self._r = self._w = None
            raise

    async def close(self) -> None:
        if self._w is not None:
            try:
                self._mid += 1
                self._w.write(ber_seq(ber_int(self._mid),
                                      tlv(0x42, b"")))       # unbind
                await self._w.drain()
            except Exception:  # noqa: BLE001
                pass
            self._w.close()
            try:
                await self._w.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._r = self._w = None

    async def _read_message(self) -> tuple[int, int, bytes]:
        """-> (message_id, op_tag, op_body)."""
        head = await self._r.readexactly(2)
        ln = head[1]
        extra = b""
        if ln & 0x80:
            extra = await self._r.readexactly(ln & 0x7F)
            ln = int.from_bytes(extra, "big")
        body = await self._r.readexactly(ln)
        _tag, mid_body, pos = read_tlv(body, 0)
        op_tag, op_body, _ = read_tlv(body, pos)
        return read_int(mid_body), op_tag, op_body

    @staticmethod
    def _result(op_body: bytes) -> tuple[int, str]:
        _t, code, pos = read_tlv(op_body, 0)
        _t, _dn, pos = read_tlv(op_body, pos)
        _t, diag, _ = read_tlv(op_body, pos)
        return read_int(code), diag.decode("utf-8", "replace")

    async def bind(self, dn: str, password: str) -> None:
        self._mid += 1
        op = tlv(0x60, ber_int(3) + ber_str(dn)
                 + ber_str(password, tag=0x80))
        self._w.write(ber_seq(ber_int(self._mid), op))
        await self._w.drain()
        _mid, tag, body = await self._read_message()
        if tag != 0x61:
            raise LdapError(-1, f"unexpected response tag {tag:#x}")
        code, diag = self._result(body)
        if code != 0:
            raise LdapError(code, diag or "bind failed")

    async def ping(self) -> bool:
        # RootDSE base search is the conventional liveness probe
        await self.search("", SCOPE_BASE, f_present("objectClass"),
                          attributes=["objectClass"], size_limit=1)
        return True

    async def search(self, base_dn: str, scope: int, filt: bytes,
                     attributes: Optional[list[str]] = None,
                     size_limit: int = 0) -> list[dict]:
        """-> [{"dn": ..., "<attr>": [values...]}]."""
        if self._w is None:
            raise ConnectionError("ldap client not connected")
        self._mid += 1
        attrs = ber_seq(*[ber_str(a) for a in (attributes or [])])
        op = tlv(0x63, ber_str(base_dn) + ber_int(scope, tag=0x0A)
                 + ber_int(0, tag=0x0A) + ber_int(size_limit) + ber_int(0)
                 + ber_bool(False) + filt + attrs)
        self._w.write(ber_seq(ber_int(self._mid), op))
        await self._w.drain()
        out: list[dict] = []
        while True:
            _mid, tag, body = await self._read_message()
            if tag == 0x64:                              # SearchResultEntry
                _t, dn, pos = read_tlv(body, 0)
                entry: dict = {"dn": dn.decode("utf-8", "replace")}
                _t, attrs_body, _ = read_tlv(body, pos)
                apos = 0
                while apos < len(attrs_body):
                    _t, attr_seq, apos = read_tlv(attrs_body, apos)
                    _t, name, vpos = read_tlv(attr_seq, 0)
                    _t, vals_set, _ = read_tlv(attr_seq, vpos)
                    vals, spos = [], 0
                    while spos < len(vals_set):
                        _t, v, spos = read_tlv(vals_set, spos)
                        vals.append(v.decode("utf-8", "replace"))
                    entry[name.decode()] = vals
                out.append(entry)
            elif tag == 0x65:                            # SearchResultDone
                code, diag = self._result(body)
                if code not in (0, 4):                   # 4 = sizeLimit
                    raise LdapError(code, diag)
                return out
            else:
                raise LdapError(-1, f"unexpected response tag {tag:#x}")
