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
  event_message { client_connected = true, ... }
  topic_metrics = [ "t/#" ]
  flapping_detect { enable = true, max_count = 15, ... }

The rule engine, the authn and authz chains and exhook are ROADMAP.md
Queue A item 20(d). A block that would boot one of them in the reference
(the same triggers: ``rule_engine`` with ``rules`` or ``enable``,
``authn`` with ``enable``, ``authz`` with ``sources`` or ``no_match =
deny``, ``exhook`` with ``servers``) raises ``ValueError`` naming it: a
node never starts without a layer its file asks for.
"""

from __future__ import annotations

from emqx_tpu_torch.apps.delayed import DelayedPublish
from emqx_tpu_torch.apps.event_message import EventMessage
from emqx_tpu_torch.apps.retainer import Retainer
from emqx_tpu_torch.apps.rewrite import TopicRewrite
from emqx_tpu_torch.apps.topic_metrics import TopicMetrics
from emqx_tpu_torch.broker.banned import FlappingDetect


def _not_ported(block: str, what: str) -> ValueError:
    return ValueError(
        f"{block}: {what} is not part of emqx_tpu_torch yet (ROADMAP.md "
        f"Queue A item 20(d))")


def _refuse_missing_layers(cfg) -> None:
    """Raise for a block that asks for a layer the port does not have,
    under exactly the triggers that boot it in the reference."""
    re_conf = cfg.get("rule_engine") or {}
    if re_conf.get("rules") or re_conf.get("enable"):
        raise _not_ported("rule_engine", "the rule engine")
    if (cfg.get("authn") or {}).get("enable", False):
        raise _not_ported("authn", "the authentication chain")
    az = cfg.get("authz") or {}
    if az.get("sources") or az.get("no_match") == "deny":
        raise _not_ported("authz", "the authorization chain")
    if (cfg.get("exhook") or {}).get("servers"):
        raise _not_ported("exhook", "exhook")


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

    em = cfg.get("event_message") or {}
    if any(em.values()):
        started.append(node.register_app(EventMessage(node).load()))

    tm = cfg.get("topic_metrics") or []
    if tm:
        started.append(node.register_app(TopicMetrics(node, tm).load()))

    if (cfg.get("flapping_detect") or {}).get("enable", False):
        started.append(node.register_app(FlappingDetect(node).load()))

    return started
