"""Database-backed authorization (ACL) sources.

Parity: apps/emqx_authz/src/emqx_authz_{mysql,pgsql,redis,mongo}.erl —
each source queries rule rows for the requesting client and folds them
through the same rule matcher as the file source; `nomatch` on empty
results or query errors so evaluation falls through to the next source.

Row shapes (the reference's):
- SQL:   columns (permission, action, topic) per row, params %u/%c/%a
- Redis: a flat [topic, action, topic, action, ...] reply (HGETALL) with
         permission implied allow
- Mongo: documents {topics: [...], permission, action}

The port's copy of ``emqx_tpu/apps/authz_db.py``.
"""

from __future__ import annotations

import re
from typing import Optional

from emqx_tpu_torch.apps.authz import ALLOW, DENY, NOMATCH, Rule

_SQL_VAR_RE = re.compile(r"'(%[uca])'")


def _sql_params(query: str, clientinfo: dict) -> Optional[tuple[str, list]]:
    """Replace quoted '%u'/'%c'/'%a' markers with ? params, one param per
    occurrence in order (emqx_authz_mysql replvar over the param list)."""
    params: list = []
    for m in _SQL_VAR_RE.finditer(query):
        v = m.group(1)
        if v == "%u":
            val = clientinfo.get("username")
        elif v == "%c":
            val = clientinfo.get("clientid")
        else:
            peer = clientinfo.get("peername")
            val = str(peer[0]) if peer else None
        if val is None:
            return None
        params.append(val)
    return _SQL_VAR_RE.sub("?", query), params


def _match_row(clientinfo: dict, action: str, topic: str,
               permission: str, row_action: str, topics: list) -> str:
    try:
        rule = Rule(permission or ALLOW, "all", row_action or "all", topics)
    except ValueError:
        return NOMATCH
    return rule.check(clientinfo, action, topic)


class _SqlSource:
    style = "mysql"

    def __init__(self, resource, query: str, timeout: float = 5.0):
        self.resource = resource
        self.query = query
        self.timeout = timeout

    async def authorize_async(self, clientinfo: dict, action: str,
                              topic: str) -> str:
        prepared = _sql_params(self.query, clientinfo)
        if prepared is None:
            return NOMATCH
        sql, params = prepared
        if self.style == "pgsql":
            for i in range(len(params)):
                sql = sql.replace("?", f"${i + 1}", 1)
        try:
            columns, rows = await self.resource.query(("sql", sql, params))
        except Exception:  # noqa: BLE001
            return NOMATCH
        for row in rows:
            r = dict(zip(columns, row))
            v = _match_row(clientinfo, action, topic,
                           str(r.get("permission") or ALLOW),
                           str(r.get("action") or "all"),
                           [str(r.get("topic") or "#")])
            if v != NOMATCH:
                return v
        return NOMATCH


class MysqlSource(_SqlSource):
    name = "mysql"
    style = "mysql"


class PgsqlSource(_SqlSource):
    name = "pgsql"
    style = "pgsql"


class RedisSource:
    """cmd like "HGETALL mqtt_acl:%u"; reply pairs topic -> action
    (emqx_authz_redis do_authorize: rows are [TopicFilter, Action | ...],
    permission allow)."""

    name = "redis"

    def __init__(self, resource, cmd: str, timeout: float = 5.0):
        self.resource = resource
        self.cmd = cmd
        self.timeout = timeout

    async def authorize_async(self, clientinfo: dict, action: str,
                              topic: str) -> str:
        peer = clientinfo.get("peername")
        # split FIRST, substitute per token: a username containing spaces
        # must not change the command arity (argument injection)
        args = [t.replace("%u", clientinfo.get("username") or "")
                 .replace("%c", clientinfo.get("clientid") or "")
                 .replace("%a", str(peer[0]) if peer else "")
                for t in self.cmd.split(" ")]
        try:
            reply = await self.resource.query(args)
        except Exception:  # noqa: BLE001
            return NOMATCH
        if not reply:
            return NOMATCH
        flat = [x.decode("utf-8", "replace") if isinstance(x, bytes)
                else str(x) for x in reply]
        for filt, act in zip(flat[0::2], flat[1::2]):
            v = _match_row(clientinfo, action, topic, ALLOW, act, [filt])
            if v != NOMATCH:
                return v
        return NOMATCH


class MongoSource:
    """Documents {topics, permission, action} selected per client
    (emqx_authz_mongo.erl)."""

    name = "mongo"

    def __init__(self, resource, collection: str = "mqtt_acl",
                 selector: Optional[dict] = None, timeout: float = 5.0):
        self.resource = resource
        self.collection = collection
        self.selector = selector or {"username": "%u"}
        self.timeout = timeout

    async def authorize_async(self, clientinfo: dict, action: str,
                              topic: str) -> str:
        peer = clientinfo.get("peername")
        sel = {}
        for k, v in self.selector.items():
            if isinstance(v, str):
                v = (v.replace("%u", clientinfo.get("username") or "")
                      .replace("%c", clientinfo.get("clientid") or "")
                      .replace("%a", str(peer[0]) if peer else ""))
            sel[k] = v
        try:
            docs = await self.resource.query(("find", self.collection, sel))
        except Exception:  # noqa: BLE001
            return NOMATCH
        for doc in docs:
            topics = doc.get("topics") or [doc.get("topic") or "#"]
            v = _match_row(clientinfo, action, topic,
                           str(doc.get("permission") or ALLOW),
                           str(doc.get("action") or "all"), list(topics))
            if v != NOMATCH:
                return v
        return NOMATCH


__all__ = ["MysqlSource", "PgsqlSource", "RedisSource", "MongoSource",
           "ALLOW", "DENY", "NOMATCH"]
