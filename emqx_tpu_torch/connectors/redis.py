"""Redis connector: RESP2 protocol over asyncio.

Parity: apps/emqx_connector/src/emqx_connector_redis.erl (eredis/ecpool —
single/sentinel/cluster modes; round-2 VERDICT missing #6). `RedisClient`
is the single-server client; `SentinelRedisClient` resolves the current
master through a list of sentinels (SENTINEL get-master-addr-by-name),
verifies the target's role, and re-resolves on reconnect —
eredis_sentinel's behavior. `ClusterRedisClient` routes by CRC16 hash
slot over a CLUSTER SLOTS topology with MOVED/ASK redirect handling —
eredis_cluster's behavior.

The port's copy of ``emqx_tpu/connectors/redis.py``.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Union

Arg = Union[str, bytes, int, float]


class RedisError(Exception):
    pass


class RedisClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: Optional[str] = None,
                 username: Optional[str] = None,
                 database: int = 0, ssl=None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.password = password
        self.username = username
        self.database = database
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        self._r, self._w = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=self.ssl),
            self.connect_timeout)
        try:
            if self.password:
                if self.username:
                    await self.cmd(["AUTH", self.username, self.password])
                else:
                    await self.cmd(["AUTH", self.password])
            if self.database:
                await self.cmd(["SELECT", str(self.database)])
        except BaseException:
            self._w.close()         # auth failure must not leak the socket
            self._r = self._w = None
            raise

    async def close(self) -> None:
        if self._w is not None:
            self._w.close()
            try:
                await self._w.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._r = self._w = None

    async def ping(self) -> bool:
        return await self.cmd(["PING"]) == b"PONG"

    # ---- RESP codec ----
    @staticmethod
    def _encode(args: list[Arg]) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    async def _read_reply(self):
        line = (await self._r.readuntil(b"\r\n"))[:-2]
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await self._r.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [await self._read_reply() for _ in range(n)]
        raise RedisError(f"bad RESP type byte {kind!r}")

    async def cmd(self, args: list[Arg]):
        """One command -> decoded reply (bytes / int / list / None)."""
        if self._w is None:
            raise ConnectionError("redis client not connected")
        self._w.write(self._encode(args))
        await self._w.drain()
        return await self._read_reply()


class SentinelRedisClient(RedisClient):
    """Redis via sentinel: each (re)connect asks the sentinels for the
    master of `master_name`, connects there, and verifies ROLE == master
    (eredis_sentinel's guard against stale sentinel answers during a
    failover). Pool reconnects (ConnPool) therefore follow the failover
    automatically: the next connect() re-resolves.

    sentinels: list of (host, port) pairs, tried in order.
    """

    def __init__(self, sentinels: list, master_name: str = "mymaster",
                 password: Optional[str] = None,
                 username: Optional[str] = None,
                 sentinel_password: Optional[str] = None,
                 database: int = 0, ssl=None,
                 connect_timeout: float = 5.0):
        super().__init__(host="", port=0, password=password,
                         username=username, database=database, ssl=ssl,
                         connect_timeout=connect_timeout)
        self.sentinels = list(sentinels)
        self.master_name = master_name
        self.sentinel_password = sentinel_password

    async def _resolve_master(self) -> tuple[str, int]:
        last: Optional[Exception] = None
        for host, port in self.sentinels:
            s = RedisClient(host=host, port=port,
                            password=self.sentinel_password,
                            ssl=self.ssl,
                            connect_timeout=self.connect_timeout)
            try:
                await s.connect()
                reply = await s.cmd(["SENTINEL", "get-master-addr-by-name",
                                     self.master_name])
                if reply and len(reply) == 2:
                    return reply[0].decode(), int(reply[1])
                last = RedisError(
                    f"sentinel {host}:{port} has no master "
                    f"{self.master_name!r}")
            except (OSError, RedisError, asyncio.TimeoutError) as e:
                last = e
            finally:
                await s.close()
        raise RedisError(f"no sentinel could resolve master "
                         f"{self.master_name!r}: {last}")

    async def connect(self) -> None:
        self.host, self.port = await self._resolve_master()
        await super().connect()
        role = await self.cmd(["ROLE"])
        if not (role and role[0] == b"master"):
            await self.close()
            raise RedisError(
                f"{self.host}:{self.port} is not master (failover in "
                f"progress?) — will re-resolve on next connect")


# ---- cluster mode (eredis_cluster parity) -------------------------------

# CRC16-CCITT (XMODEM) table, the hash-slot function Redis specifies
_CRC16_TAB = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x1021) if _c & 0x8000 else (_c << 1)
    _CRC16_TAB.append(_c & 0xFFFF)


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16_TAB[((c >> 8) ^ b) & 0xFF]
    return c


def key_slot(key: Union[str, bytes]) -> int:
    """Hash slot of a key: CRC16 % 16384, honoring {hash tags} — only the
    substring between the first '{' and the next '}' hashes when that
    substring is non-empty (the Redis cluster spec's tag rule)."""
    k = key.encode() if isinstance(key, str) else key
    lo = k.find(b"{")
    if lo >= 0:
        hi = k.find(b"}", lo + 1)
        if hi > lo + 1:
            k = k[lo + 1:hi]
    return crc16(k) % 16384


# commands without a key argument route to any node
_KEYLESS = {b"PING", b"INFO", b"CLUSTER", b"COMMAND", b"AUTH", b"SELECT"}


class ClusterRedisClient:
    """Redis cluster client: one connection per master node, commands
    routed by the slot of their first key. MOVED replies refresh the
    topology and retry; ASK replies follow the redirect once with an
    ASKING prefix (slot migration in progress). Bounded redirects, so a
    flapping cluster errors instead of looping.
    """

    MAX_REDIRECTS = 5

    def __init__(self, startup_nodes: list, password: Optional[str] = None,
                 username: Optional[str] = None, ssl=None,
                 connect_timeout: float = 5.0):
        self.startup_nodes = [(h, int(p)) for h, p in startup_nodes]
        self.password = password
        self.username = username
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self._conns: dict[tuple, RedisClient] = {}
        # sorted (start, end, (host, port)) ranges from CLUSTER SLOTS
        self._ranges: list[tuple] = []

    def _new_client(self, host: str, port: int) -> RedisClient:
        return RedisClient(host=host, port=port, password=self.password,
                           username=self.username, ssl=self.ssl,
                           connect_timeout=self.connect_timeout)

    async def _conn(self, addr: tuple) -> RedisClient:
        c = self._conns.get(addr)
        if c is None or c._w is None:
            c = self._new_client(*addr)
            await c.connect()
            self._conns[addr] = c
        return c

    async def _drop_conn(self, addr: tuple) -> None:
        c = self._conns.pop(addr, None)
        if c is not None:
            await c.close()

    async def refresh_topology(self) -> None:
        """CLUSTER SLOTS from the first reachable node (connected nodes
        first, then startup nodes)."""
        last: Optional[Exception] = None
        seeds = list(self._conns) + [a for a in self.startup_nodes
                                     if a not in self._conns]
        for addr in seeds:
            try:
                c = await self._conn(addr)
                # connect_timeout only bounds the TCP handshake: a
                # half-open seed must not hang the probe forever
                slots = await asyncio.wait_for(
                    c.cmd(["CLUSTER", "SLOTS"]), self.connect_timeout)
                ranges = []
                for entry in slots or []:
                    start, end, master = entry[0], entry[1], entry[2]
                    host = master[0].decode() if isinstance(master[0], bytes) \
                        else str(master[0])
                    ranges.append((int(start), int(end),
                                   (host, int(master[1]))))
                if not ranges:
                    raise RedisError(f"{addr} returned empty CLUSTER SLOTS")
                ranges.sort()
                self._ranges = ranges
                return
            except (OSError, RedisError, asyncio.TimeoutError,
                    ConnectionError, asyncio.IncompleteReadError) as e:
                last = e
                await self._drop_conn(addr)
        raise RedisError(f"no cluster node reachable for topology: {last}")

    async def connect(self) -> None:
        await self.refresh_topology()

    async def close(self) -> None:
        for addr in list(self._conns):
            await self._drop_conn(addr)

    def _addr_for_slot(self, slot: int) -> tuple:
        for start, end, addr in self._ranges:
            if start <= slot <= end:
                return addr
        raise RedisError(f"no node serves slot {slot} (topology stale)")

    @staticmethod
    def _command_key(args: list) -> Optional[bytes]:
        if not args:
            return None
        cmd = args[0]
        cmd = cmd.upper() if isinstance(cmd, bytes) else str(cmd).upper()
        if (cmd if isinstance(cmd, bytes) else cmd.encode()) in _KEYLESS \
                or len(args) < 2:
            return None
        k = args[1]
        return k if isinstance(k, bytes) else str(k).encode()

    async def ping(self) -> bool:
        if not self._ranges:
            await self.refresh_topology()
        c = await self._conn(self._ranges[0][2])
        return await c.cmd(["PING"]) == b"PONG"

    async def cmd(self, args: list, key: Optional[Union[str, bytes]] = None):
        """One command, routed by `key` (default: the first key argument).
        Follows MOVED (with topology refresh) and ASK redirects."""
        if not self._ranges:
            await self.refresh_topology()
        k = (key.encode() if isinstance(key, str) else key) \
            if key is not None else self._command_key(args)
        try:
            addr = self._addr_for_slot(key_slot(k)) if k is not None \
                else self._ranges[0][2]
        except RedisError:
            # slot gap (map captured mid-reshard): refresh once before
            # giving up, else the slot fails until an unrelated refresh
            await self.refresh_topology()
            addr = self._addr_for_slot(key_slot(k)) if k is not None \
                else self._ranges[0][2]
        asking = False
        last: Optional[Exception] = None
        for _ in range(self.MAX_REDIRECTS + 1):
            try:
                c = await self._conn(addr)
                if asking:
                    await c.cmd(["ASKING"])
                    asking = False
                return await c.cmd(args)
            except RedisError as e:
                msg = str(e)
                if msg.startswith("MOVED ") or msg.startswith("ASK "):
                    kind, _slot, hp = msg.split(" ", 2)
                    host, _, port = hp.rpartition(":")
                    addr = (host, int(port))
                    if kind == "MOVED":
                        # ownership changed: refetch the full map (a MOVED
                        # storm during resharding collapses to one refresh)
                        try:
                            await self.refresh_topology()
                        except RedisError:
                            pass     # still follow the explicit redirect
                    else:
                        asking = True
                    last = e
                    continue
                raise
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError) as e:
                # node died: drop the conn, refresh, re-route by slot
                await self._drop_conn(addr)
                await self.refresh_topology()
                addr = self._addr_for_slot(key_slot(k)) if k is not None \
                    else self._ranges[0][2]
                last = e
        raise RedisError(f"too many cluster redirects: {last}")
