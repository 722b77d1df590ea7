"""In-process fake database servers speaking just enough wire protocol,
importing only ``emqx_tpu_torch``.

A copy of ``tests/fake_db.py``'s five servers (``FakeRedis``,
``FakeMysql``, ``FakePgsql``, ``FakeMongo``, ``FakeLdap``) over the port's
BSON, SCRAM and BER codecs, so ``chip_smoke.py`` can serve its database
arms where JAX is absent. Each server also counts the connections it
accepted (``opened``), those whose session ended (``closed``) and the
bytes each connection sent (``received``).
``tests/test_torch_db.py`` holds these servers' replies byte for byte
against ``tests/fake_db.py``'s; the tests here drive the port's clients
against each server.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from typing import Callable, Optional

from emqx_tpu_torch.connectors.ldap import (ber_int, ber_seq, ber_str,
                                            read_int, read_tlv, tlv)
from emqx_tpu_torch.utils import bson
from emqx_tpu_torch.utils.scram import ScramServer, make_credentials


class _Recorder:
    """The session's reader: keeps every byte the session consumed."""

    def __init__(self, reader, buf: bytearray):
        self._r = reader
        self.buf = buf

    async def readexactly(self, n: int) -> bytes:
        data = await self._r.readexactly(n)
        self.buf += data
        return data

    async def readuntil(self, sep: bytes = b"\n") -> bytes:
        data = await self._r.readuntil(sep)
        self.buf += data
        return data


class _FakeServer:
    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.port = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self.opened = 0               # connections accepted
        self.closed = 0               # connections whose session ended
        self.received: list = []      # the bytes each connection sent

    async def start(self) -> "_FakeServer":
        self._server = await asyncio.start_server(
            self._on_client, self.host, 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            for w in list(self._writers):
                w.close()
            try:
                # py3.12 wait_closed blocks until every handler returns
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass

    async def _on_client(self, reader, writer):
        self._writers.add(writer)
        self.opened += 1
        buf = bytearray()
        self.received.append(buf)
        try:
            await self.session(_Recorder(reader, buf), writer)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            self._writers.discard(writer)
            self.closed += 1
            writer.close()

    async def session(self, reader, writer):  # pragma: no cover
        raise NotImplementedError


class FakeRedis(_FakeServer):
    """RESP2 server: AUTH/SELECT/PING + hash commands over a dict store."""

    def __init__(self, password: Optional[str] = None,
                 role: str = "master",
                 masters: Optional[dict] = None):
        super().__init__()
        self.password = password
        self.role = role              # ROLE reply (master/replica)
        # sentinel mode: master_name -> (host, port) for
        # SENTINEL get-master-addr-by-name
        self.masters = masters
        self.hashes: dict[str, dict[str, str]] = {}
        self.kv: dict[str, str] = {}
        self.commands: list[list[bytes]] = []
        # cluster mode: list of (start, end, host, port) for CLUSTER SLOTS
        self.cluster_slots: Optional[list] = None
        # key -> ("MOVED"|"ASK", slot, host, port): forced redirects
        self.redirects: dict[str, tuple] = {}
        # keys mid-migration on THIS node: served only after ASKING
        self.ask_required: set[str] = set()

    async def _read_cmd(self, reader) -> Optional[list[bytes]]:
        line = (await reader.readuntil(b"\r\n"))[:-2]
        if not line.startswith(b"*"):
            return None
        n = int(line[1:])
        args = []
        for _ in range(n):
            head = (await reader.readuntil(b"\r\n"))[:-2]
            size = int(head[1:])
            data = await reader.readexactly(size + 2)
            args.append(data[:-2])
        return args

    @staticmethod
    def _bulk(v: Optional[str]) -> bytes:
        if v is None:
            return b"$-1\r\n"
        b = v.encode() if isinstance(v, str) else v
        return b"$%d\r\n%s\r\n" % (len(b), b)

    async def session(self, reader, writer):
        authed = self.password is None
        while True:
            args = await self._read_cmd(reader)
            if args is None:
                return
            self.commands.append(args)
            cmd = args[0].upper()
            if cmd == b"AUTH":
                if args[-1].decode() == (self.password or ""):
                    authed = True
                    writer.write(b"+OK\r\n")
                else:
                    writer.write(b"-ERR invalid password\r\n")
            elif not authed:
                writer.write(b"-NOAUTH Authentication required.\r\n")
            elif cmd == b"SELECT":
                writer.write(b"+OK\r\n")
            elif cmd == b"PING":
                writer.write(b"+PONG\r\n")
            elif cmd == b"ROLE":
                writer.write(b"*3\r\n" + self._bulk(self.role)
                             + b":0\r\n*0\r\n")
            elif cmd == b"SENTINEL":
                name = args[2].decode() if len(args) > 2 else ""
                m = (self.masters or {}).get(name)
                if m is None:
                    writer.write(b"*-1\r\n")
                else:
                    writer.write(b"*2\r\n" + self._bulk(str(m[0]))
                                 + self._bulk(str(m[1])))
            elif cmd in (b"HGETALL", b"HMGET") \
                    and self._redirect(args, writer):
                pass
            elif cmd == b"HGETALL":
                h = self.hashes.get(args[1].decode(), {})
                out = [b"*%d\r\n" % (len(h) * 2)]
                for k, v in h.items():
                    out.append(self._bulk(k))
                    out.append(self._bulk(v))
                writer.write(b"".join(out))
            elif cmd == b"HMGET":
                h = self.hashes.get(args[1].decode(), {})
                fields = [a.decode() for a in args[2:]]
                out = [b"*%d\r\n" % len(fields)]
                for f in fields:
                    out.append(self._bulk(h.get(f)))
                writer.write(b"".join(out))
            elif cmd == b"CLUSTER" and len(args) > 1 \
                    and args[1].upper() == b"SLOTS":
                entries = self.cluster_slots or []
                out = [b"*%d\r\n" % len(entries)]
                for start, end, host, port in entries:
                    out.append(b"*3\r\n:%d\r\n:%d\r\n" % (start, end))
                    out.append(b"*3\r\n" + self._bulk(host)
                               + b":%d\r\n" % port + self._bulk("nodeid"))
                writer.write(b"".join(out))
            elif cmd == b"ASKING":
                self._asking = True
                writer.write(b"+OK\r\n")
            elif cmd in (b"GET", b"SET") and self._redirect(args, writer):
                pass
            elif cmd == b"GET":
                writer.write(self._bulk(self.kv.get(args[1].decode())))
            elif cmd == b"SET":
                self.kv[args[1].decode()] = args[2].decode()
                writer.write(b"+OK\r\n")
            else:
                writer.write(b"-ERR unknown command\r\n")
            await writer.drain()

    def _redirect(self, args, writer) -> bool:
        """Write a forced MOVED/ASK redirect for this key (cluster tests);
        a key mid-import here is served only under a one-shot ASKING."""
        key = args[1].decode()
        if key in self.ask_required:
            if getattr(self, "_asking", False):
                self._asking = False
                return False
            writer.write(b"-TRYAGAIN key is being imported (no ASKING)\r\n")
            return True
        r = self.redirects.get(key)
        if r is None:
            return False
        kind, slot, host, port = r
        writer.write(b"-%s %d %s:%d\r\n" % (kind.encode(), slot,
                                            host.encode(), port))
        return True


def _mysql_scramble(password: bytes, nonce: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _sha2_scramble(password: bytes, nonce: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha256(password).digest()
    h2 = hashlib.sha256(hashlib.sha256(h1).digest() + nonce).digest()
    return bytes(a ^ b for a, b in zip(h1, h2))


class FakeMysql(_FakeServer):
    """Protocol-v10 server: native or caching_sha2 handshake (fast path
    when `sha2_cached`, else full auth via RSA public-key exchange),
    COM_QUERY text resultsets, and COM_STMT_PREPARE/EXECUTE binary
    resultsets, routed to `handler(sql) -> (columns, rows) | None`
    (None -> OK packet). Prepared executions are recorded in
    `self.prepared` as (sql, params) so tests can assert parameters never
    entered the SQL text."""

    def __init__(self, username: str = "root", password: str = "",
                 handler: Optional[Callable] = None,
                 plugin: str = "mysql_native_password",
                 sha2_cached: bool = False):
        super().__init__()
        self.username = username
        self.password = password
        self.handler = handler or (lambda sql: ([], []))
        self.plugin = plugin
        self.sha2_cached = sha2_cached
        self.queries: list[str] = []
        self.prepared: list[tuple] = []
        self._rsa_key = None

    @staticmethod
    def _lenenc_str(b: bytes) -> bytes:
        return bytes([len(b)]) + b

    def _rsa(self):
        if self._rsa_key is None:
            from cryptography.hazmat.primitives.asymmetric import rsa
            self._rsa_key = rsa.generate_private_key(
                public_exponent=65537, key_size=2048)
        return self._rsa_key

    async def session(self, reader, writer):
        seq = 0

        def send(payload: bytes) -> None:
            nonlocal seq
            writer.write(len(payload).to_bytes(3, "little")
                         + bytes([seq & 0xFF]) + payload)
            seq += 1

        async def recv() -> bytes:
            nonlocal seq
            head = await reader.readexactly(4)
            seq = head[3] + 1
            return await reader.readexactly(
                int.from_bytes(head[:3], "little"))

        nonce = b"abcdefgh12345678mnop"       # 20 bytes
        greet = (b"\x0a" + b"8.0.0-fake\x00"
                 + struct.pack("<I", 1)                       # thread id
                 + nonce[:8] + b"\x00"
                 + struct.pack("<H", 0xFFFF)                  # caps lo
                 + b"\x21" + struct.pack("<H", 2)             # charset,status
                 + struct.pack("<H", 0x000F)                  # caps hi
                 + bytes([21]) + b"\x00" * 10
                 + nonce[8:] + b"\x00"
                 + self.plugin.encode() + b"\x00")
        send(greet)
        await writer.drain()
        resp = await recv()
        # parse: caps(4) maxpkt(4) charset(1) 23 zeros, user\0, authlen+auth
        pos = 32
        end = resp.index(b"\x00", pos)
        user = resp[pos:end].decode()
        pos = end + 1
        alen = resp[pos]
        auth = resp[pos + 1:pos + 1 + alen]

        def deny():
            send(b"\xff" + struct.pack("<H", 1045) + b"#28000"
                 + b"Access denied")

        pw = self.password.encode()
        if user != self.username:
            deny()
            await writer.drain()
            return
        if self.plugin == "caching_sha2_password":
            if auth != _sha2_scramble(pw, nonce):
                deny()
                await writer.drain()
                return
            if self.sha2_cached:
                send(b"\x01\x03")                 # fast auth success
            else:
                send(b"\x01\x04")                 # full authentication
                await writer.drain()
                req = await recv()
                if req == b"\x02":                # public key request
                    from cryptography.hazmat.primitives import (
                        hashes, serialization)
                    from cryptography.hazmat.primitives.asymmetric import (
                        padding)
                    pem = self._rsa().public_key().public_bytes(
                        serialization.Encoding.PEM,
                        serialization.PublicFormat.SubjectPublicKeyInfo)
                    send(b"\x01" + pem)
                    await writer.drain()
                    enc = await recv()
                    xored = self._rsa().decrypt(enc, padding.OAEP(
                        mgf=padding.MGF1(hashes.SHA1()),
                        algorithm=hashes.SHA1(), label=None))
                    got = bytes(b ^ nonce[i % len(nonce)]
                                for i, b in enumerate(xored))
                    if got != pw + b"\x00":
                        deny()
                        await writer.drain()
                        return
                else:                             # cleartext (TLS channel)
                    if req.rstrip(b"\x00") != pw:
                        deny()
                        await writer.drain()
                        return
        else:
            if auth != _mysql_scramble(pw, nonce):
                deny()
                await writer.drain()
                return
        send(b"\x00\x00\x00\x02\x00\x00\x00")                 # OK
        await writer.drain()

        stmts: dict[int, tuple[str, int]] = {}
        next_stmt = [1]
        while True:
            seq = 0
            pkt = await recv()
            com = pkt[:1]
            if com == b"\x01":                                # COM_QUIT
                return
            if com == b"\x0e":                                # COM_PING
                send(b"\x00\x00\x00\x02\x00\x00\x00")
                await writer.drain()
                continue
            if com == b"\x16":                                # STMT_PREPARE
                sql = pkt[1:].decode()
                sid = next_stmt[0]
                next_stmt[0] += 1
                nparams = sql.count("?")
                stmts[sid] = (sql, nparams)
                send(b"\x00" + struct.pack("<IHHBH", sid, 0, nparams, 0, 0))
                for _ in range(nparams):
                    send(self._coldef(b"?"))
                if nparams:
                    send(b"\xfe\x00\x00\x02\x00")
                await writer.drain()
                continue
            if com == b"\x19":                                # STMT_CLOSE
                stmts.pop(struct.unpack_from("<I", pkt, 1)[0], None)
                continue
            if com == b"\x17":                                # STMT_EXECUTE
                sid = struct.unpack_from("<I", pkt, 1)[0]
                sql, nparams = stmts[sid]
                params = self._parse_exec_params(pkt, nparams)
                self.prepared.append((sql, params))
                result = self.handler(sql, params) \
                    if self.handler.__code__.co_argcount > 1 \
                    else self.handler(sql)
                if result is None:
                    send(b"\x00\x00\x00\x02\x00\x00\x00")
                    await writer.drain()
                    continue
                columns, rows = result
                send(bytes([len(columns)]))
                for name in columns:
                    send(self._coldef(name.encode()))
                send(b"\xfe\x00\x00\x02\x00")
                nbm = (len(columns) + 9) // 8
                for row in rows:
                    bitmap = bytearray(nbm)
                    vals = b""
                    for i, v in enumerate(row):
                        if v is None:
                            bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
                        else:
                            vb = str(v).encode()
                            vals += self._lenenc_str(vb) if len(vb) < 251 \
                                else b"\xfc" + struct.pack("<H", len(vb)) \
                                + vb
                    send(b"\x00" + bytes(bitmap) + vals)
                send(b"\xfe\x00\x00\x02\x00")
                await writer.drain()
                continue
            if com != b"\x03":
                send(b"\xff" + struct.pack("<H", 1047)
                     + b"#08S01" + b"unknown command")
                await writer.drain()
                continue
            sql = pkt[1:].decode()
            self.queries.append(sql)
            result = self.handler(sql)
            if result is None:
                send(b"\x00\x00\x00\x02\x00\x00\x00")
                await writer.drain()
                continue
            columns, rows = result
            send(bytes([len(columns)]))
            for name in columns:
                send(self._coldef(name.encode()))
            send(b"\xfe\x00\x00\x02\x00")                     # EOF
            for row in rows:
                out = b""
                for v in row:
                    if v is None:
                        out += b"\xfb"
                    else:
                        vb = str(v).encode()
                        out += self._lenenc_str(vb) if len(vb) < 251 \
                            else b"\xfc" + struct.pack("<H", len(vb)) + vb
                send(out)
            send(b"\xfe\x00\x00\x02\x00")                     # EOF
            await writer.drain()

    def _coldef(self, name: bytes) -> bytes:
        return (self._lenenc_str(b"def") + self._lenenc_str(b"db")
                + self._lenenc_str(b"t") + self._lenenc_str(b"t")
                + self._lenenc_str(name) + self._lenenc_str(name)
                + b"\x0c" + struct.pack("<H", 0x21)
                + struct.pack("<I", 255) + b"\xfd"
                + struct.pack("<H", 0) + b"\x00" + b"\x00\x00")

    @staticmethod
    def _parse_exec_params(pkt: bytes, nparams: int) -> list:
        """Decode COM_STMT_EXECUTE parameter values (subset of types the
        client sends: NULL/LONGLONG/DOUBLE/VAR_STRING)."""
        pos = 1 + 4 + 1 + 4
        nbm = (nparams + 7) // 8
        bitmap = pkt[pos:pos + nbm]
        pos += nbm
        if nparams == 0 or pkt[pos] != 1:
            return []
        pos += 1
        types = []
        for _ in range(nparams):
            types.append(struct.unpack_from("<H", pkt, pos)[0])
            pos += 2
        out = []
        for i, t in enumerate(types):
            if bitmap[i // 8] & (1 << (i % 8)):
                out.append(None)
                continue
            if t == 0x08:
                out.append(struct.unpack_from("<q", pkt, pos)[0])
                pos += 8
            elif t == 0x05:
                out.append(struct.unpack_from("<d", pkt, pos)[0])
                pos += 8
            else:
                first = pkt[pos]
                if first < 0xFB:
                    n, pos = first, pos + 1
                elif first == 0xFC:
                    n = struct.unpack_from("<H", pkt, pos + 1)[0]
                    pos += 3
                else:
                    n = int.from_bytes(pkt[pos + 1:pos + 4], "little")
                    pos += 4
                out.append(pkt[pos:pos + n].decode())
                pos += n
        return out


class FakePgsql(_FakeServer):
    """Protocol-v3 server: configurable auth (trust/cleartext/md5/scram) +
    simple Query routed to `handler(sql) -> (columns, rows)`."""

    def __init__(self, username: str = "postgres", password: str = "",
                 auth: str = "scram", handler: Optional[Callable] = None):
        super().__init__()
        self.username = username
        self.password = password
        self.auth = auth
        self.handler = handler or (lambda sql: ([], []))
        self.queries: list[str] = []

    async def session(self, reader, writer):
        head = await reader.readexactly(4)
        n = struct.unpack(">i", head)[0]
        body = await reader.readexactly(n - 4)
        proto = struct.unpack(">i", body[:4])[0]
        assert proto == 196608, f"unexpected protocol {proto}"

        def send(mtype: bytes, payload: bytes) -> None:
            writer.write(mtype + struct.pack(">i", len(payload) + 4)
                         + payload)

        async def recv() -> tuple[bytes, bytes]:
            h = await reader.readexactly(5)
            ln = struct.unpack(">i", h[1:])[0]
            return h[:1], await reader.readexactly(ln - 4)

        ok = False
        if self.auth == "trust":
            ok = True
        elif self.auth == "cleartext":
            send(b"R", struct.pack(">i", 3))
            await writer.drain()
            _, b = await recv()
            ok = b.rstrip(b"\x00").decode() == self.password
        elif self.auth == "md5":
            salt = b"SALT"
            send(b"R", struct.pack(">i", 5) + salt)
            await writer.drain()
            _, b = await recv()
            inner = hashlib.md5(self.password.encode()
                                + self.username.encode()).hexdigest()
            want = "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
            ok = b.rstrip(b"\x00").decode() == want
        else:                                                # scram
            send(b"R", struct.pack(">i", 10) + b"SCRAM-SHA-256\x00\x00")
            await writer.drain()
            _, b = await recv()
            end = b.index(b"\x00")
            assert b[:end] == b"SCRAM-SHA-256"
            flen = struct.unpack(">i", b[end + 1:end + 5])[0]
            client_first = b[end + 5:end + 5 + flen].decode()
            cred = make_credentials(self.password, "sha256")
            srv = ScramServer(lambda u: cred, "sha256")
            try:
                sf = srv.challenge(client_first)
                send(b"R", struct.pack(">i", 11) + sf.encode())
                await writer.drain()
                _, b = await recv()
                final = srv.finish(b.decode())
                send(b"R", struct.pack(">i", 12) + final.encode())
                ok = True
            except Exception:  # noqa: BLE001
                ok = False
        if not ok:
            send(b"E", b"SFATAL\x00C28P01\x00"
                 b"Mpassword authentication failed\x00\x00")
            await writer.drain()
            return
        send(b"R", struct.pack(">i", 0))                     # AuthOk
        send(b"S", b"server_version\x0014.0-fake\x00")
        send(b"K", struct.pack(">ii", 1, 2))
        send(b"Z", b"I")
        await writer.drain()

        while True:
            mtype, body = await recv()
            if mtype == b"X":
                return
            if mtype != b"Q":
                continue
            sql = body.rstrip(b"\x00").decode()
            self.queries.append(sql)
            try:
                columns, rows = self.handler(sql)
            except Exception as e:  # noqa: BLE001
                send(b"E", b"SERROR\x00C42601\x00M"
                     + str(e).encode() + b"\x00\x00")
                send(b"Z", b"I")
                await writer.drain()
                continue
            if columns:
                desc = struct.pack(">h", len(columns))
                for c in columns:
                    desc += (c.encode() + b"\x00"
                             + struct.pack(">ihihih", 0, 0, 25, -1, -1, 0))
                send(b"T", desc)
            for row in rows:
                out = struct.pack(">h", len(row))
                for v in row:
                    if v is None:
                        out += struct.pack(">i", -1)
                    else:
                        vb = str(v).encode()
                        out += struct.pack(">i", len(vb)) + vb
                send(b"D", out)
            send(b"C", b"SELECT %d\x00" % len(rows))
            send(b"Z", b"I")
            await writer.drain()


class FakeMongo(_FakeServer):
    """OP_MSG server: ping/find/insert over an in-memory collection map +
    SCRAM saslStart/saslContinue when credentials are configured."""

    def __init__(self, username: Optional[str] = None,
                 password: str = "", algo: str = "sha256"):
        super().__init__()
        self.username = username
        self.password = password
        self.algo = algo
        self.collections: dict[str, list[dict]] = {}
        self.commands: list[dict] = []

    async def session(self, reader, writer):
        authed = self.username is None
        scram: Optional[ScramServer] = None
        while True:
            head = await reader.readexactly(16)
            total, req_id, _, opcode = struct.unpack("<iiii", head)
            data = await reader.readexactly(total - 16)
            assert opcode == 2013
            doc = bson.decode(data[5:])
            self.commands.append(doc)
            reply = self._dispatch(doc, authed)
            if "___scram" in reply:
                phase = reply.pop("___scram")
                try:
                    if phase == "start":
                        cred = make_credentials(self.password, self.algo)
                        cred_for = {self.username: cred}
                        scram = ScramServer(cred_for.get, self.algo)
                        challenge = scram.challenge(
                            bytes(doc["payload"]).decode())
                        reply.update({"ok": 1.0, "conversationId": 1,
                                      "done": False,
                                      "payload": challenge.encode()})
                    else:
                        final = scram.finish(bytes(doc["payload"]).decode())
                        authed = True
                        reply.update({"ok": 1.0, "conversationId": 1,
                                      "done": True,
                                      "payload": final.encode()})
                except Exception:  # noqa: BLE001
                    reply.update({"ok": 0.0, "code": 18,
                                  "errmsg": "Authentication failed."})
            body = bson.encode(reply)
            payload = struct.pack("<i", 0) + b"\x00" + body
            writer.write(struct.pack("<iiii", len(payload) + 16,
                                     1000 + req_id, req_id, 2013) + payload)
            await writer.drain()

    def _dispatch(self, doc: dict, authed: bool) -> dict:
        if "saslStart" in doc:
            return {"___scram": "start"}
        if "saslContinue" in doc:
            return {"___scram": "continue"}
        if not authed:
            return {"ok": 0.0, "code": 13,
                    "errmsg": "command requires authentication"}
        if "ping" in doc:
            return {"ok": 1.0}
        if "find" in doc:
            coll = self.collections.get(doc["find"], [])
            filt = doc.get("filter", {})
            rows = [d for d in coll
                    if all(d.get(k) == v for k, v in filt.items())]
            limit = doc.get("limit", 0)
            if limit:
                rows = rows[:limit]
            return {"ok": 1.0, "cursor": {
                "id": 0, "ns": f"db.{doc['find']}", "firstBatch": rows}}
        if "insert" in doc:
            self.collections.setdefault(doc["insert"], []).extend(
                doc.get("documents", []))
            return {"ok": 1.0, "n": len(doc.get("documents", []))}
        return {"ok": 0.0, "code": 59, "errmsg": "no such command"}


class FakeLdap(_FakeServer):
    """RFC 4511 subset: simple bind against a DN->password map, search
    over a flat entry list with equality/present/AND filters."""

    def __init__(self, binds: Optional[dict] = None,
                 entries: Optional[list] = None):
        super().__init__()
        self.binds = binds if binds is not None else {"": ""}
        self.entries = entries or []    # [{"dn": ..., attr: [vals]}]

    async def session(self, reader, writer):
        bound = False
        while True:
            head = await reader.readexactly(2)
            ln = head[1]
            if ln & 0x80:
                ext = await reader.readexactly(ln & 0x7F)
                ln = int.from_bytes(ext, "big")
            body = await reader.readexactly(ln)
            _t, mid_b, pos = read_tlv(body, 0)
            mid = read_int(mid_b)
            op_tag, op, _ = read_tlv(body, pos)

            def send(tag, rbody):
                writer.write(ber_seq(ber_int(mid), tlv(tag, rbody)))

            if op_tag == 0x60:                               # bind
                _t, _ver, p = read_tlv(op, 0)
                _t, dn, p = read_tlv(op, p)
                _t, pw, _ = read_tlv(op, p)
                dn_s = dn.decode()
                ok = dn_s in self.binds and \
                    self.binds[dn_s] == pw.decode()
                bound = ok
                code = 0 if ok else 49                      # invalidCreds
                send(0x61, ber_int(code, tag=0x0A) + ber_str("")
                     + ber_str("" if ok else "invalid credentials"))
            elif op_tag == 0x42:                             # unbind
                return
            elif op_tag == 0x63:                             # search
                if not bound:
                    send(0x65, ber_int(50, tag=0x0A) + ber_str("")
                         + ber_str("not bound"))
                else:
                    _t, base, p = read_tlv(op, 0)
                    for _ in range(5):                       # skip to filter
                        _t, _x, p = read_tlv(op, p)
                    ftag, fbody, p = read_tlv(op, p)
                    for e in self.entries:
                        if self._match(ftag, fbody, e):
                            attrs = b"".join(
                                ber_seq(ber_str(k), tlv(0x31, b"".join(
                                    ber_str(v) for v in vs)))
                                for k, vs in e.items() if k != "dn")
                            send(0x64, ber_str(e["dn"]) + ber_seq(attrs))
                    send(0x65, ber_int(0, tag=0x0A) + ber_str("")
                         + ber_str(""))
            await writer.drain()

    def _match(self, ftag, fbody, entry) -> bool:
        if ftag == 0x87:                                     # present
            return fbody.decode() in entry
        if ftag == 0xA3:                                     # equality
            _t, attr, p = read_tlv(fbody, 0)
            _t, val, _ = read_tlv(fbody, p)
            return val.decode() in entry.get(attr.decode(), [])
        if ftag == 0xA0:                                     # AND
            pos = 0
            while pos < len(fbody):
                t, b, pos = read_tlv(fbody, pos)
                if not self._match(t, b, entry):
                    return False
            return True
        return False


# ---------------------------------------------------------------------
# The servers under the port's clients
# ---------------------------------------------------------------------
def _run(coro, timeout: float = 30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _closed(srv, limit: float = 5.0) -> bool:
    """Wait until every connection the server accepted has ended."""
    loop = asyncio.get_running_loop()
    t_end = loop.time() + limit
    while srv.closed < srv.opened and loop.time() < t_end:
        await asyncio.sleep(0.01)
    return srv.closed == srv.opened


def test_redis_serves_and_counts_connections():
    from emqx_tpu_torch.connectors import RedisClient, RedisError

    async def go():
        srv = await FakeRedis(password="pw").start()
        srv.hashes["mqtt_acl:u"] = {"t/#": "publish"}
        c = RedisClient(port=srv.port, password="pw")
        await c.connect()
        assert await c.cmd(["HGETALL", "mqtt_acl:u"]) == [b"t/#",
                                                          b"publish"]
        await c.close()
        bad = RedisClient(port=srv.port, password="no")
        try:
            await bad.connect()
            raise AssertionError("a wrong password connected")
        except RedisError:
            pass
        assert await _closed(srv) and srv.opened == 2
        assert srv.commands[0] == [b"AUTH", b"pw"]
        await srv.stop()
    _run(go())


def test_mysql_and_pgsql_serve_queries():
    from emqx_tpu_torch.connectors import MysqlClient, PgsqlClient

    async def go():
        ms = await FakeMysql(username="u", password="p", handler=lambda sql,
                             params=None: (["a"], [[params[0]]])).start()
        ps = await FakePgsql(username="u", password="p", auth="md5",
                             handler=lambda sql: (["a"], [["1"]])).start()
        m = MysqlClient(port=ms.port, username="u", password="p")
        await m.connect()
        assert await m.query("SELECT a WHERE x = ?", ["v"]) == (["a"],
                                                                [["v"]])
        await m.close()
        p = PgsqlClient(port=ps.port, username="u", password="p")
        await p.connect()
        assert await p.query("SELECT a WHERE x = $1", ["v"]) == (["a"],
                                                                 [["1"]])
        await p.close()
        assert ms.prepared == [("SELECT a WHERE x = ?", ["v"])]
        assert ps.queries == ["SELECT a WHERE x = 'v'"]
        assert await _closed(ms) and await _closed(ps)
        await ms.stop()
        await ps.stop()
    _run(go())


def test_mongo_and_ldap_serve_lookups():
    from emqx_tpu_torch.connectors import LdapClient, MongoClient
    from emqx_tpu_torch.connectors.ldap import SCOPE_SUB, f_eq

    async def go():
        mg = await FakeMongo(username="m", password="pw").start()
        mg.collections["mqtt_user"] = [{"username": "a", "v": 1}]
        c = MongoClient(port=mg.port, username="m", password="pw")
        await c.connect()
        assert (await c.find_one("mqtt_user", {"username": "a"}))["v"] == 1
        await c.close()
        ld = await FakeLdap(entries=[{"dn": "uid=a,dc=x",
                                      "uid": ["a"]}]).start()
        lc = LdapClient(port=ld.port)
        await lc.connect()
        rows = await lc.search("dc=x", SCOPE_SUB, f_eq("uid", "a"))
        assert rows == [{"dn": "uid=a,dc=x", "uid": ["a"]}]
        await lc.close()
        assert await _closed(mg) and await _closed(ld)
        await mg.stop()
        await ld.stop()
    _run(go())
