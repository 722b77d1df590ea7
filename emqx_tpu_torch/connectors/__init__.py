"""Database connectors: asyncio wire-protocol clients.

Parity: apps/emqx_connector — the reference wraps Erlang client libraries
(eredis/mysql-otp/epgsql/mongodb/eldap) in ecpool worker pools; the port
depends on no Python database client, so each connector speaks its
database's wire protocol directly over asyncio streams, pooled by
`pool.ConnPool`.

The port's copy of ``emqx_tpu/connectors``: the same wire bytes, so a
fake server answers either package's clients alike.
"""

from emqx_tpu_torch.connectors.ldap import LdapClient, LdapError
from emqx_tpu_torch.connectors.mongo import MongoClient, MongoError
from emqx_tpu_torch.connectors.mysql import MysqlClient, MysqlError
from emqx_tpu_torch.connectors.pgsql import PgsqlClient, PgsqlError
from emqx_tpu_torch.connectors.pool import ConnPool
from emqx_tpu_torch.connectors.redis import (RedisClient, RedisError,
                                             SentinelRedisClient)

__all__ = ["ConnPool", "LdapClient", "LdapError", "MongoClient",
           "MongoError", "MysqlClient", "MysqlError", "PgsqlClient",
           "PgsqlError", "RedisClient", "RedisError", "SentinelRedisClient"]
