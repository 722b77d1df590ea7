"""MongoDB connector: OP_MSG wire protocol over asyncio.

Parity: apps/emqx_connector/src/emqx_connector_mongo.erl (mongodb client,
single/rs/sharded topologies). Single-server mode: every database command
(ping, find, insert, saslStart/saslContinue) is one OP_MSG (opcode 2013)
round-trip carrying a kind-0 BSON section; auth is SCRAM-SHA-256 (or
SHA-1) over saslStart/saslContinue like the reference's client.

The port's copy of ``emqx_tpu/connectors/mongo.py``, over the port's
``utils/bson.py`` and ``utils/scram.py``.
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import struct
from typing import Optional

from emqx_tpu_torch.utils import bson
from emqx_tpu_torch.utils.scram import ScramClient

OP_MSG = 2013


class MongoError(Exception):
    def __init__(self, doc: dict):
        self.doc = doc
        super().__init__(doc.get("errmsg", "mongodb error")
                         + f" (code {doc.get('code', '?')})")


class MongoClient:
    _req_ids = itertools.count(1)

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 username: Optional[str] = None, password: str = "",
                 database: str = "mqtt", auth_source: str = "admin",
                 auth_algo: str = "sha256", ssl=None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.database = database
        self.auth_source = auth_source
        self.auth_algo = auth_algo
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        self._r, self._w = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=self.ssl),
            self.connect_timeout)
        if self.username:
            try:
                await self._sasl_auth()
            except BaseException:
                self._w.close()  # auth failure must not leak the socket
                self._r = self._w = None
                raise

    async def _sasl_auth(self) -> None:
        mech = ("SCRAM-SHA-256" if self.auth_algo == "sha256"
                else "SCRAM-SHA-1")
        scram = ScramClient(self.username, self.password, self.auth_algo)
        first = await self.command({
            "saslStart": 1, "mechanism": mech,
            "payload": scram.first().encode(),
            "options": {"skipEmptyExchange": True}}, db=self.auth_source)
        final = scram.final(bytes(first["payload"]).decode())
        done = await self.command({
            "saslContinue": 1,
            "conversationId": first.get("conversationId", 1),
            "payload": final.encode()}, db=self.auth_source)
        if not scram.verify_server(bytes(done["payload"]).decode()):
            raise MongoError({"errmsg": "server SCRAM signature invalid"})
        while not done.get("done", True):
            done = await self.command({
                "saslContinue": 1,
                "conversationId": first.get("conversationId", 1),
                "payload": b""}, db=self.auth_source)

    async def close(self) -> None:
        if self._w is not None:
            self._w.close()
            try:
                await self._w.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._r = self._w = None

    async def ping(self) -> bool:
        await self.command({"ping": 1})     # raises MongoError on ok:0
        return True

    async def command(self, doc: dict, db: Optional[str] = None) -> dict:
        """One OP_MSG command -> response doc; raises MongoError on ok:0."""
        if self._w is None:
            raise ConnectionError("mongo client not connected")
        body = dict(doc)
        body["$db"] = db or self.database
        payload = struct.pack("<i", 0) + b"\x00" + bson.encode(body)
        req_id = next(self._req_ids)
        header = struct.pack("<iiii", len(payload) + 16, req_id, 0, OP_MSG)
        self._w.write(header + payload)
        await self._w.drain()
        head = await self._r.readexactly(16)
        total, _rid, _resp_to, opcode = struct.unpack("<iiii", head)
        data = await self._r.readexactly(total - 16)
        if opcode != OP_MSG:
            raise MongoError({"errmsg": f"unexpected opcode {opcode}"})
        # flags(4) + section kind(1) + BSON doc
        reply = bson.decode(data[5:])
        if reply.get("ok") != 1 and reply.get("ok") != 1.0:
            raise MongoError(reply)
        return reply

    # ---- convenience surface used by authn/authz/rule actions ----
    async def find(self, collection: str, filter_doc: dict,
                   limit: int = 0) -> list[dict]:
        cmd = {"find": collection, "filter": filter_doc}
        if limit:
            cmd["limit"] = limit
        reply = await self.command(cmd)
        cursor = reply.get("cursor", {})
        out = list(cursor.get("firstBatch", []))
        # drain the cursor: firstBatch caps at the server default (~101
        # docs); results past it need getMore until cursor id 0
        cid = cursor.get("id", 0)
        while cid:
            reply = await self.command({"getMore": cid,
                                        "collection": collection})
            cursor = reply.get("cursor", {})
            out.extend(cursor.get("nextBatch", []))
            cid = cursor.get("id", 0)
            if limit and len(out) >= limit:
                if cid:
                    try:
                        await self.command({"killCursors": collection,
                                            "cursors": [cid]})
                    except MongoError:
                        pass
                return out[:limit]
        return out

    async def find_one(self, collection: str,
                       filter_doc: dict) -> Optional[dict]:
        rows = await self.find(collection, filter_doc, limit=1)
        return rows[0] if rows else None

    async def insert(self, collection: str, docs: list[dict]) -> int:
        reply = await self.command({"insert": collection,
                                    "documents": docs})
        return int(reply.get("n", 0))
