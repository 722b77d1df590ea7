"""Database resources: pooled connector instances on the Resource behaviour.

Parity: apps/emqx_connector/src/emqx_connector_{redis,mysql,pgsql,mongo}.erl
— each `on_start`s an ecpool of client connections, answers `on_query`
({cmd,...} / {sql,...} / {find,...}) and `on_health_check`. Here the pool
is connectors.pool.ConnPool over the asyncio wire clients; the query verbs
keep the reference's shapes so authn/authz/rule-actions code is
backend-agnostic.

The port's copy of ``emqx_tpu/resources/db.py``.
"""

from __future__ import annotations

from typing import Any, Optional

from emqx_tpu_torch.connectors import (ConnPool, LdapClient, MongoClient,
                                 MysqlClient, PgsqlClient, RedisClient)
from emqx_tpu_torch.resources.resource import Resource, ResourceManager


class _PooledDbResource(Resource):
    """Shared lifecycle: start pool eagerly (status from first connect),
    health-check = client ping on a pooled connection."""

    def _make_client(self):
        raise NotImplementedError

    def __init__(self, rid: str, conf: dict):
        super().__init__(rid, conf)
        self.pool = ConnPool(self._make_client,
                             size=int(conf.get("pool_size", 4)))

    async def start(self) -> None:
        try:
            await self.pool.start()
            self.status = "connected"
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            self.status = "disconnected"

    async def stop(self) -> None:
        await self.pool.stop()
        self.status = "stopped"

    async def health_check(self) -> bool:
        try:
            if not self.pool._started:
                await self.pool.start()
            return bool(await self.pool.run(lambda c: c.ping(), timeout=5))
        except Exception as e:  # noqa: BLE001
            self.last_error = str(e)
            return False


class RedisResource(_PooledDbResource):
    TYPE = "redis"

    def _make_client(self) -> RedisClient:
        c = self.conf
        if c.get("redis_type") == "cluster" or c.get("cluster_nodes"):
            # emqx_connector_redis.erl cluster mode: servers seed the
            # slot-routed cluster client (eredis_cluster).  Seeds come from
            # cluster_nodes, else the reference-style `servers` list, else
            # host/port — an empty seed list is a config error, caught here
            # rather than as a cryptic connect failure later.
            from emqx_tpu_torch.connectors.redis import ClusterRedisClient

            def parse_seeds(raw):
                # accepts a list of (host, port) pairs or "host:port"
                # strings, or the reference-style single comma-separated
                # "h1:6379,h2:6379" string
                if isinstance(raw, str):
                    raw = [s for s in raw.split(",") if s.strip()]
                out = []
                for s in raw or []:
                    if isinstance(s, str):
                        # accepted forms: 'host', 'host:port',
                        # '[v6]' / '[v6]:port', and bare 'v6' (which is
                        # ambiguous with host:port, so any string with
                        # 2+ colons outside brackets is taken as a
                        # port-less IPv6 host)
                        t = s.strip()
                        if t.startswith("["):
                            host, _, port = t.rpartition(":")
                            if host.endswith("]"):
                                host = host[1:-1]
                            else:           # '[v6]' without a port
                                host, port = t.strip("[]"), ""
                        elif t.count(":") > 1:
                            host, port = t, ""
                        else:
                            host, sep, port = t.rpartition(":")
                            if not sep:
                                host, port = t, ""
                        out.append((host, int(port or 6379)))
                    else:
                        out.append((s[0], int(s[1])))
                return out

            seeds = parse_seeds(c.get("cluster_nodes")) \
                or parse_seeds(c.get("servers"))
            if not seeds and c.get("host"):
                seeds.append((c["host"], int(c.get("port", 6379))))
            if not seeds:
                raise ValueError(
                    "redis cluster resource needs seed nodes: set "
                    "cluster_nodes, servers, or host/port")
            return ClusterRedisClient(
                startup_nodes=seeds,
                username=c.get("username"), password=c.get("password"),
                ssl=c.get("ssl"))
        if c.get("redis_type") == "sentinel" or c.get("sentinels"):
            # emqx_connector_redis.erl sentinel mode: servers are the
            # sentinels, `sentinel` names the master set
            from emqx_tpu_torch.connectors.redis import SentinelRedisClient
            return SentinelRedisClient(
                sentinels=[tuple(s) for s in c.get("sentinels", [])],
                master_name=c.get("sentinel", "mymaster"),
                username=c.get("username"), password=c.get("password"),
                sentinel_password=c.get("sentinel_password"),
                database=int(c.get("database", 0)), ssl=c.get("ssl"))
        return RedisClient(
            host=c.get("host", "127.0.0.1"), port=c.get("port", 6379),
            username=c.get("username"), password=c.get("password"),
            database=int(c.get("database", 0)), ssl=c.get("ssl"))

    async def query(self, request: Any) -> Any:
        """request: list command ["HGETALL", key] (the {cmd, CMD} verb)."""
        return await self.pool.run(lambda c: c.cmd(list(request)),
                                   timeout=self.conf.get("timeout", 5))


class MysqlResource(_PooledDbResource):
    TYPE = "mysql"

    def _make_client(self) -> MysqlClient:
        c = self.conf
        return MysqlClient(
            host=c.get("host", "127.0.0.1"), port=c.get("port", 3306),
            username=c.get("username", "root"),
            password=c.get("password", ""),
            database=c.get("database"), ssl=c.get("ssl"))

    async def query(self, request: Any) -> Any:
        """request: ("sql", query, params) or plain SQL string
        -> (columns, rows)."""
        sql, params = _sql_request(request)
        return await self.pool.run(lambda c: c.query(sql, params),
                                   timeout=self.conf.get("timeout", 5))


class PgsqlResource(_PooledDbResource):
    TYPE = "pgsql"

    def _make_client(self) -> PgsqlClient:
        c = self.conf
        return PgsqlClient(
            host=c.get("host", "127.0.0.1"), port=c.get("port", 5432),
            username=c.get("username", "postgres"),
            password=c.get("password", ""),
            database=c.get("database", "postgres"), ssl=c.get("ssl"))

    async def query(self, request: Any) -> Any:
        sql, params = _sql_request(request)
        return await self.pool.run(lambda c: c.query(sql, params),
                                   timeout=self.conf.get("timeout", 5))


class MongoResource(_PooledDbResource):
    TYPE = "mongo"

    def _make_client(self) -> MongoClient:
        c = self.conf
        return MongoClient(
            host=c.get("host", "127.0.0.1"), port=c.get("port", 27017),
            username=c.get("username"), password=c.get("password", ""),
            database=c.get("database", "mqtt"),
            auth_source=c.get("auth_source", "admin"),
            auth_algo=c.get("auth_algo", "sha256"), ssl=c.get("ssl"))

    async def query(self, request: Any) -> Any:
        """request: ("find", collection, filter) -> list of docs,
        ("insert", collection, docs) -> count, or a raw command dict."""
        timeout = self.conf.get("timeout", 5)
        if isinstance(request, dict):
            return await self.pool.run(lambda c: c.command(request),
                                       timeout=timeout)
        verb = request[0]
        if verb == "find":
            return await self.pool.run(
                lambda c: c.find(request[1], request[2]), timeout=timeout)
        if verb == "insert":
            return await self.pool.run(
                lambda c: c.insert(request[1], list(request[2])),
                timeout=timeout)
        raise ValueError(f"unknown mongo verb {verb!r}")


class LdapResource(_PooledDbResource):
    TYPE = "ldap"

    def _make_client(self) -> LdapClient:
        c = self.conf
        return LdapClient(
            host=c.get("host", "127.0.0.1"), port=c.get("port", 389),
            bind_dn=c.get("bind_dn", ""),
            bind_password=c.get("bind_password", ""), ssl=c.get("ssl"))

    async def query(self, request: Any) -> Any:
        """request: ("search", base_dn, scope, filter_bytes, [attrs])."""
        if not (isinstance(request, (tuple, list)) and request
                and request[0] == "search"):
            raise ValueError(f"bad ldap request {request!r}")
        _, base, scope, filt, *rest = request
        attrs = rest[0] if rest else None
        return await self.pool.run(
            lambda c: c.search(base, scope, filt, attributes=attrs),
            timeout=self.conf.get("timeout", 5))


def _sql_request(request: Any) -> tuple[str, Optional[list]]:
    if isinstance(request, str):
        return request, None
    if isinstance(request, (tuple, list)) and request and \
            request[0] == "sql":
        return request[1], list(request[2]) if len(request) > 2 else None
    raise ValueError(f"bad sql request {request!r}")


for _cls in (RedisResource, MysqlResource, PgsqlResource, MongoResource,
             LdapResource):
    ResourceManager.register_type(_cls.TYPE, _cls)
