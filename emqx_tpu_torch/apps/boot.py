"""Config-driven feature-app boot: the application-startup analog.

Parity: the reference's release boots every configured app at node start
(emqx_machine_boot.erl: emqx_retainer, emqx_delayed, emqx_modules,
emqx_authn/authz chains from their config blocks, emqx_rule_engine,
emqx_exhook). Here the same blocks in `etc/emqx.conf` drive
`Node.start_apps()`; each app remains independently usable as a library.
The port's copy of ``emqx_tpu/apps/boot.py``.

Config surface (all optional; nothing configured = nothing booted):

  retainer { enable = true, storage { type = ram|disc, dir = ... } }
  delayed  { enable = true }
  rewrite = [ { action = publish, source = "x/#", re = "...", dest = "y/#" } ]
  rule_engine { rules = [ { id = r1, sql = "SELECT ...", actions = [...] } ] }
  exhook   { servers = [ { name = s1, url = "http://..." } ] }
  event_message { client_connected = true, ... }
  topic_metrics = [ "t/#" ]
  flapping_detect { enable = true, max_count = 15, ... }
  authn {
    enable = true
    chain = [
      { mechanism = password_based, backend = built_in_database,
        user_id_type = username }
      { mechanism = jwt, secret = "..." }
      { mechanism = scram, algorithm = sha256 }
      { mechanism = password_based, backend = http, url = "..." }
      { mechanism = password_based, backend = mysql,
        server = "127.0.0.1:3306", database = mqtt, query = "SELECT ..." }
    ]
  }
  authz {
    no_match = allow | deny
    sources = [
      { type = file, rules = [ { permit=allow, who=all, action=all } ] }
      { type = client_acl }
      { type = http, url = "..." }
      { type = mysql, server = ..., query = "SELECT ..." }
    ]
  }

A database arm (an authn ``backend`` of mysql, postgresql, mongodb or
redis; an authz ``type`` of mysql, postgresql, redis or mongodb) creates
its resource on ``node.resources`` (``resources/db.py``) as the reference
does, defects included: a ``mongodb`` arm asks for the resource type
``mongodb``, which nothing registers, so its boot raises; a ``redis``
authn backend builds the PostgreSQL authenticator over the Redis
resource, whose queries then fail and answer ``ignore``. An unreachable
server leaves its resource ``disconnected`` and boots all the same.
An ``exhook`` block with ``servers`` loads ``apps/exhook.Exhook``, which
handshakes with every server before the node serves; that module needs
``grpc`` and is imported only when the block asks for it.
"""

from __future__ import annotations

import os
from typing import Any

from emqx_tpu_torch.apps.authn import (AuthnChain, BuiltinDB,
                                       HTTPAuthenticator, JWTAuthenticator)
from emqx_tpu_torch.apps.authn_db import (LdapAuthenticator,
                                          MongoAuthenticator,
                                          MysqlAuthenticator,
                                          PgsqlAuthenticator,
                                          ScramAuthenticator)
from emqx_tpu_torch.apps.authz import (Authz, ClientAclSource, FileSource,
                                       HTTPSource)
from emqx_tpu_torch.apps.authz_db import (MongoSource, MysqlSource,
                                          PgsqlSource, RedisSource)
from emqx_tpu_torch.apps.delayed import DelayedPublish
from emqx_tpu_torch.apps.event_message import EventMessage
from emqx_tpu_torch.apps.retainer import Retainer
from emqx_tpu_torch.apps.rewrite import TopicRewrite
from emqx_tpu_torch.apps.topic_metrics import TopicMetrics
from emqx_tpu_torch.broker.banned import FlappingDetect
from emqx_tpu_torch.resources import db as _db  # noqa: F401 — DB types
from emqx_tpu_torch.resources.resource import ResourceManager
from emqx_tpu_torch.rules import RuleEngine
from emqx_tpu_torch.utils.hocon import loads


async def _db_resource(node, rid: str, rtype: str, conf: dict):
    """DB-backed authn/authz arms share the typed resource pool."""
    mgr = getattr(node, "resources", None)
    if mgr is None:
        mgr = ResourceManager(node)   # registers itself as node.resources
    return await mgr.create(rid, rtype, conf)


async def _build_authenticator(node, i: int, a: dict) -> Any:
    mech = a.get("mechanism", "password_based")
    if mech == "jwt":
        return JWTAuthenticator(
            secret=a["secret"], algorithm=a.get("algorithm", "HS256"),
            verify_claims=a.get("verify_claims"),
            acl_claim_name=a.get("acl_claim_name", "acl"))
    if mech == "scram":
        return ScramAuthenticator(
            algorithm=a.get("algorithm", "sha256"),
            iteration_count=int(a.get("iteration_count", 4096)))
    if mech != "password_based":
        raise ValueError(f"authn authenticator #{i}: "
                         f"unknown mechanism {mech!r}")
    backend = a.get("backend", "built_in_database")
    if backend == "built_in_database":
        return BuiltinDB(
            user_id_type=a.get("user_id_type", "username"),
            algorithm=a.get("algorithm", "sha256"),
            salt_position=a.get("salt_position", "prefix"))
    if backend == "http":
        return HTTPAuthenticator(
            url=a["url"], method=a.get("method", "post"),
            body=a.get("body"), headers=a.get("headers"),
            timeout=float(a.get("timeout", 5)))
    if backend == "ldap":
        host, _, port = str(a.get("server", "127.0.0.1:389")).partition(":")
        return LdapAuthenticator(
            host=host, port=int(port or 389),
            base_dn=a.get("base_dn", ""),
            filter_tmpl=a.get("filter", "(uid=${mqtt-username})"),
            bind_dn=a.get("bind_dn"),
            bind_password=a.get("bind_password", ""))
    if backend in ("mysql", "postgresql", "mongodb", "redis"):
        rtype = {"postgresql": "pgsql"}.get(backend, backend)
        res = await _db_resource(node, f"authn_{i}_{backend}", rtype,
                                 dict(a))
        if backend == "mongodb":
            return MongoAuthenticator(
                res, collection=a.get("collection", "mqtt_user"),
                selector=a.get("selector"),
                algorithm=a.get("algorithm", "sha256"),
                salt_position=a.get("salt_position", "prefix"))
        cls = (MysqlAuthenticator if backend == "mysql"
               else PgsqlAuthenticator)
        return cls(res, query=a["query"],
                   algorithm=a.get("algorithm", "sha256"),
                   salt_position=a.get("salt_position", "prefix"))
    raise ValueError(f"authn authenticator #{i}: unknown backend "
                     f"{backend!r}")


async def _build_authz_source(node, i: int, s: dict) -> Any:
    stype = s.get("type", "file")
    if stype == "file":
        rules = s.get("rules")
        if rules is None and s.get("path"):
            with open(s["path"]) as f:
                rules = (loads(f.read(),
                               basedir=os.path.dirname(s["path"]) or ".")
                         or {}).get("rules") or []
        return FileSource(rules or [])
    if stype == "client_acl":
        return ClientAclSource()
    if stype == "http":
        return HTTPSource(url=s["url"], method=s.get("method", "post"),
                          body=s.get("body"), headers=s.get("headers"),
                          timeout=float(s.get("timeout", 5)))
    if stype in ("mysql", "postgresql", "redis", "mongodb"):
        rtype = {"postgresql": "pgsql"}.get(stype, stype)
        res = await _db_resource(node, f"authz_{i}_{stype}", rtype, dict(s))
        if stype == "redis":
            return RedisSource(res, cmd=s.get("cmd", "HGETALL mqtt_acl:%u"))
        if stype == "mongodb":
            return MongoSource(res,
                               collection=s.get("collection", "mqtt_acl"),
                               selector=s.get("selector"))
        cls = MysqlSource if stype == "mysql" else PgsqlSource
        return cls(res, query=s["query"])
    raise ValueError(f"authz source #{i}: unknown type {stype!r}")


async def start_apps(node) -> list:
    """Boot every feature app the node's config declares; returns the
    started instances (also registered on the node)."""
    cfg = node.config
    started: list = []

    if (cfg.get("retainer") or {}).get("enable", False):
        started.append(node.register_app(Retainer(node).load()))

    if (cfg.get("delayed") or {}).get("enable", False):
        started.append(node.register_app(DelayedPublish(node).load()))

    if cfg.get("rewrite"):       # schema: an ARRAY of rewrite rules
        started.append(node.register_app(TopicRewrite(node).load()))

    re_conf = cfg.get("rule_engine") or {}
    if re_conf.get("rules") or re_conf.get("enable"):
        eng = RuleEngine(node).load()
        for r in re_conf.get("rules") or []:
            eng.create_rule(r["sql"], list(r.get("actions") or []),
                            rule_id=r.get("id"),
                            enabled=r.get("enable", True),
                            description=r.get("description", ""))
        started.append(node.register_app(eng))

    em = cfg.get("event_message") or {}
    if any(em.values()):
        started.append(node.register_app(EventMessage(node).load()))

    tm = cfg.get("topic_metrics") or []
    if tm:
        started.append(node.register_app(TopicMetrics(node, tm).load()))

    if (cfg.get("flapping_detect") or {}).get("enable", False):
        started.append(node.register_app(FlappingDetect(node).load()))

    ac = cfg.get("authn") or {}
    if ac.get("enable", False):
        auths = [await _build_authenticator(node, i, a)
                 for i, a in enumerate(ac.get("chain") or [])]
        started.append(node.register_app(
            AuthnChain(node, auths, enable=True).load()))

    az = cfg.get("authz") or {}
    if az.get("sources") or az.get("no_match") == "deny":
        sources = [await _build_authz_source(node, i, s)
                   for i, s in enumerate(az.get("sources") or [])]
        started.append(node.register_app(
            Authz(node, sources,
                  no_match=az.get("no_match", "allow"),
                  cache_enable=az.get("cache", {}).get(
                      "enable", True)).load()))

    ex = cfg.get("exhook") or {}
    if ex.get("servers"):
        # grpc is imported with the block that needs it, never at the
        # top: a host without grpc still boots every other app
        from emqx_tpu_torch.apps.exhook import Exhook
        exh = Exhook(node)
        await exh.load()
        started.append(node.register_app(exh))

    return started
