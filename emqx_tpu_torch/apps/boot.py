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
    ]
  }
  authz {
    no_match = allow | deny
    sources = [
      { type = file, rules = [ { permit=allow, who=all, action=all } ] }
      { type = client_acl }
      { type = http, url = "..." }
    ]
  }

The database arms (an authn ``backend`` of ldap, mysql, postgresql,
mongodb or redis; an authz ``type`` of mysql, postgresql, redis or
mongodb) and exhook (``exhook.servers``) are ROADMAP.md Queue A item
20(d): a file that asks for one raises ``ValueError`` naming it before
anything boots, so a node never starts without a layer its file asks for.
"""

from __future__ import annotations

import os
from typing import Any

from emqx_tpu_torch.apps.authn import (AuthnChain, BuiltinDB,
                                       HTTPAuthenticator, JWTAuthenticator)
from emqx_tpu_torch.apps.authn_db import ScramAuthenticator
from emqx_tpu_torch.apps.authz import (Authz, ClientAclSource, FileSource,
                                       HTTPSource)
from emqx_tpu_torch.apps.delayed import DelayedPublish
from emqx_tpu_torch.apps.event_message import EventMessage
from emqx_tpu_torch.apps.retainer import Retainer
from emqx_tpu_torch.apps.rewrite import TopicRewrite
from emqx_tpu_torch.apps.topic_metrics import TopicMetrics
from emqx_tpu_torch.broker.banned import FlappingDetect
from emqx_tpu_torch.rules import RuleEngine
from emqx_tpu_torch.utils.hocon import loads

AUTHN_DB_BACKENDS = ("ldap", "mysql", "postgresql", "mongodb", "redis")
AUTHZ_DB_TYPES = ("mysql", "postgresql", "redis", "mongodb")


def _not_ported(block: str, what: str) -> ValueError:
    return ValueError(
        f"{block}: {what} is not part of emqx_tpu_torch yet (ROADMAP.md "
        f"Queue A item 20(d))")


def _refuse_missing_layers(cfg) -> None:
    """Raise for a block that asks for a layer the port does not have,
    under exactly the triggers that boot it in the reference."""
    ac = cfg.get("authn") or {}
    if ac.get("enable", False):
        for i, a in enumerate(ac.get("chain") or []):
            backend = a.get("backend", "built_in_database")
            if a.get("mechanism", "password_based") == "password_based" \
                    and backend in AUTHN_DB_BACKENDS:
                raise _not_ported(f"authn authenticator #{i}",
                                  f"the {backend} backend")
    az = cfg.get("authz") or {}
    if az.get("sources") or az.get("no_match") == "deny":
        for i, s in enumerate(az.get("sources") or []):
            if s.get("type", "file") in AUTHZ_DB_TYPES:
                raise _not_ported(f"authz source #{i}",
                                  f"the {s['type']} source")
    if (cfg.get("exhook") or {}).get("servers"):
        raise _not_ported("exhook", "exhook")


def _build_authenticator(i: int, a: dict) -> Any:
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
    raise ValueError(f"authn authenticator #{i}: unknown backend "
                     f"{backend!r}")


def _build_authz_source(i: int, s: dict) -> Any:
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
    raise ValueError(f"authz source #{i}: unknown type {stype!r}")


async def start_apps(node) -> list:
    """Boot every feature app the node's config declares; returns the
    started instances (also registered on the node)."""
    cfg = node.config
    _refuse_missing_layers(cfg)
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
        auths = [_build_authenticator(i, a)
                 for i, a in enumerate(ac.get("chain") or [])]
        started.append(node.register_app(
            AuthnChain(node, auths, enable=True).load()))

    az = cfg.get("authz") or {}
    if az.get("sources") or az.get("no_match") == "deny":
        sources = [_build_authz_source(i, s)
                   for i, s in enumerate(az.get("sources") or [])]
        started.append(node.register_app(
            Authz(node, sources,
                  no_match=az.get("no_match", "allow"),
                  cache_enable=az.get("cache", {}).get(
                      "enable", True)).load()))

    return started
