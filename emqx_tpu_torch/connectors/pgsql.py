"""PostgreSQL connector: frontend/backend protocol v3 over asyncio.

Parity: apps/emqx_connector/src/emqx_connector_pgsql.erl (epgsql).
Implements startup, auth (trust / cleartext / md5 / SCRAM-SHA-256 SASL),
and the simple-query cycle. Parameterized queries use `$1..$n`
placeholders substituted client-side with literal escaping — same
observable behavior as epgsql's equery for the broker's SELECT-by-key
authn/authz queries.

The port's copy of ``emqx_tpu/connectors/pgsql.py``, over the port's
``utils/scram.py``.
"""

from __future__ import annotations

import asyncio
import hashlib
import re
import struct
from typing import Any, Optional

from emqx_tpu_torch.utils.scram import ScramClient


class PgsqlError(Exception):
    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(fields.get("M", "postgres error")
                         + f" (code {fields.get('C', '?')})")


def escape(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, (int, float)):
        return str(value)
    if isinstance(value, (bytes, bytearray)):
        return "'\\x" + bytes(value).hex() + "'"
    s = str(value).replace("'", "''")
    if "\\" in s:
        return "E'" + s.replace("\\", "\\\\") + "'"
    return f"'{s}'"


_PARAM_RE = re.compile(r"\$(\d+)")


def bind_params(query: str, params: list) -> str:
    # single-pass substitution: a parameter VALUE containing "$1" must
    # never be re-substituted (injection via client-controlled strings)
    def _sub(m: re.Match) -> str:
        idx = int(m.group(1))
        if not 1 <= idx <= len(params):
            raise ValueError(f"query references ${idx} but only "
                             f"{len(params)} params given")
        return escape(params[idx - 1])

    return _PARAM_RE.sub(_sub, query)


class PgsqlClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5432,
                 username: str = "postgres", password: str = "",
                 database: str = "postgres", ssl=None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.database = database
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self.parameters: dict[str, str] = {}
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None

    # ---- message framing: type byte + int32 length (incl. itself) ----
    async def _read_msg(self) -> tuple[bytes, bytes]:
        head = await self._r.readexactly(5)
        mtype = head[:1]
        n = struct.unpack(">i", head[1:])[0]
        return mtype, await self._r.readexactly(n - 4)

    def _write_msg(self, mtype: bytes, payload: bytes) -> None:
        self._w.write(mtype + struct.pack(">i", len(payload) + 4) + payload)

    @staticmethod
    def _err_fields(body: bytes) -> dict:
        fields: dict[str, str] = {}
        pos = 0
        while pos < len(body) and body[pos] != 0:
            code = chr(body[pos])
            end = body.index(b"\x00", pos + 1)
            fields[code] = body[pos + 1:end].decode("utf-8", "replace")
            pos = end + 1
        return fields

    async def connect(self) -> None:
        self._r, self._w = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=self.ssl),
            self.connect_timeout)
        params = (b"user\x00" + self.username.encode() + b"\x00"
                  b"database\x00" + self.database.encode() + b"\x00\x00")
        payload = struct.pack(">i", 196608) + params      # protocol 3.0
        self._w.write(struct.pack(">i", len(payload) + 4) + payload)
        await self._w.drain()
        scram: Optional[ScramClient] = None
        while True:
            mtype, body = await self._read_msg()
            if mtype == b"E":
                raise PgsqlError(self._err_fields(body))
            if mtype == b"R":
                kind = struct.unpack(">i", body[:4])[0]
                if kind == 0:                              # AuthenticationOk
                    continue
                if kind == 3:                              # cleartext
                    self._write_msg(b"p", self.password.encode() + b"\x00")
                elif kind == 5:                            # md5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        self.password.encode()
                        + self.username.encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._write_msg(b"p", b"md5" + outer.encode() + b"\x00")
                elif kind == 10:                           # SASL mechanisms
                    mechs = body[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PgsqlError(
                            {"M": "no supported SASL mechanism"})
                    scram = ScramClient(self.username, self.password,
                                        "sha256")
                    first = scram.first().encode()
                    self._write_msg(
                        b"p", b"SCRAM-SHA-256\x00"
                        + struct.pack(">i", len(first)) + first)
                elif kind == 11:                           # SASL continue
                    final = scram.final(body[4:].decode()).encode()
                    self._write_msg(b"p", final)
                elif kind == 12:                           # SASL final
                    if not scram.verify_server(body[4:].decode()):
                        raise PgsqlError(
                            {"M": "server SCRAM signature invalid"})
                else:
                    raise PgsqlError(
                        {"M": f"unsupported auth request {kind}"})
                await self._w.drain()
            elif mtype == b"S":
                k, v = body.split(b"\x00")[:2]
                self.parameters[k.decode()] = v.decode("utf-8", "replace")
            elif mtype == b"K":                            # BackendKeyData
                continue
            elif mtype == b"Z":                            # ReadyForQuery
                return
            # NoticeResponse ('N') and anything else: skip

    async def close(self) -> None:
        if self._w is not None:
            try:
                self._write_msg(b"X", b"")                 # Terminate
                await self._w.drain()
            except Exception:  # noqa: BLE001
                pass
            self._w.close()
            try:
                await self._w.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._r = self._w = None

    async def ping(self) -> bool:
        cols, rows = await self.query("SELECT 1")
        return bool(rows)

    async def query(self, sql: str, params: Optional[list] = None
                    ) -> tuple[list[str], list[list]]:
        """Simple-query cycle -> (column_names, rows); text values."""
        if self._w is None:
            raise ConnectionError("pgsql client not connected")
        if params:
            sql = bind_params(sql, params)
        self._write_msg(b"Q", sql.encode() + b"\x00")
        await self._w.drain()
        columns: list[str] = []
        rows: list[list] = []
        error: Optional[PgsqlError] = None
        while True:
            mtype, body = await self._read_msg()
            if mtype == b"T":                              # RowDescription
                nf = struct.unpack(">h", body[:2])[0]
                pos = 2
                columns = []
                for _ in range(nf):
                    end = body.index(b"\x00", pos)
                    columns.append(body[pos:end].decode())
                    pos = end + 1 + 18       # table oid..format code
            elif mtype == b"D":                            # DataRow
                nf = struct.unpack(">h", body[:2])[0]
                pos = 2
                row: list = []
                for _ in range(nf):
                    n = struct.unpack_from(">i", body, pos)[0]
                    pos += 4
                    if n == -1:
                        row.append(None)
                    else:
                        row.append(body[pos:pos + n]
                                   .decode("utf-8", "replace"))
                        pos += n
                rows.append(row)
            elif mtype == b"E":
                error = PgsqlError(self._err_fields(body))
            elif mtype == b"Z":                            # ReadyForQuery
                if error is not None:
                    raise error
                return columns, rows
            # CommandComplete ('C'), EmptyQueryResponse ('I'), notices: skip
